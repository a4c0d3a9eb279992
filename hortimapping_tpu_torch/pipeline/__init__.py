"""End-to-end pipelines of the port: `wild` (BUP20 completion from posed
frames and submap meshes). Each module has a `python -m` entry."""
