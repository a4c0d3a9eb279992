"""The program's spans of host meshing in a traced run: each `mesh.host`
(`MeshExtractor.meshes_from_grids`) of the window beside its
`mesh.readback`, the grids' copy to the host, for the readers of
`mesh.readback_ms_per_fruit` and `mesh.iso_ms_per_fruit`."""

from __future__ import annotations

from typing import List, Optional

from lib.program_trace import children, in_window


def host_meshing(ctx) -> Optional[List[tuple]]:
    """(mesh.host, its mesh.readback) for every `mesh.host` span that starts
    in the window; None where the program records no `mesh.readback` at all
    (one older than the span). Raises where the program records it and a
    `mesh.host` of the window has none."""
    hosts = in_window(ctx, "mesh.host")
    if hosts is None:
        return None
    reads = children(ctx, "mesh.readback")
    if not reads:
        return None
    if any(h.sid not in reads for h in hosts):
        raise RuntimeError("a 'mesh.host' span without its 'mesh.readback'")
    return [(h, reads[h.sid]) for h in hosts]


def per_fruit_ms(rows: List[tuple], seconds_ns) -> Optional[float]:
    """The sum of `seconds_ns(host, readback)` over the rows, in ms a fruit
    meshed (the `fruits` of each `mesh.host`)."""
    fruits = sum(h.attrs["fruits"] for h, _ in rows)
    if not fruits:
        return None
    return sum(seconds_ns(h, rb) for h, rb in rows) / fruits / 1e6
