"""End-to-end pipelines of the port: `wild` (BUP20 completion from posed
frames and submap meshes), `challenge` (the ECCV shape-completion challenge
from RGB-D frames) and `lab` (the IGG lab evaluation, single- and
multi-frame). Each module has a `python -m` entry."""
