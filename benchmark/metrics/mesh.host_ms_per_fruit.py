"""Host iso-surfacing (`MeshExtractor.meshes_from_grids`, native marching
tetrahedra) per fruit meshed, from its span."""

from lib.spans import total


def read(ctx):
    n = sum(len(b.keys) for b in ctx.rec.batches)
    t = total(ctx, "mesh_host")
    return 1e3 * t / n if n and t else None
