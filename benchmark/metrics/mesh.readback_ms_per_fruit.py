"""The grids' copy to the host, the wait for their decode included: the
window's `mesh.readback` spans (inside `mesh.host`) over the fruits meshed,
in ms (program span). None where the program records no `mesh.readback`."""

from lib.mesh_trace import host_meshing, per_fruit_ms


def read(ctx):
    rows = host_meshing(ctx)
    return per_fruit_ms(rows, lambda h, rb: rb.t1 - rb.t0) if rows else None
