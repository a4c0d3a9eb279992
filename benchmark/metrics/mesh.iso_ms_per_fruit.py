"""Host iso-surfacing alone: each `mesh.host` span of the window less its
`mesh.readback`, over the fruits meshed, in ms (program span). None where
the program records no `mesh.readback`."""

from lib.mesh_trace import host_meshing, per_fruit_ms


def read(ctx):
    rows = host_meshing(ctx)
    return per_fruit_ms(rows, lambda h, rb: (h.t1 - h.t0) - (rb.t1 - rb.t0)) if rows else None
