"""Host iso-surfacing of a whole batch in one native call on a pool of
threads (`native.iso_surface_batch` under `MeshExtractor.meshes_from_grids`):
f16 grids widened in C++, the fruits spread over the process's CPUs, the
vertices scaled in C++. Held bit for bit to `MeshExtractor._grid_to_mesh`,
which meshes one fruit at a time and scales in numpy, fed the grid widened
by numpy. Analytic ellipsoid grids; no decoder.
"""

import gc
import os

import numpy as np
import pytest
import torch

from hortimapping_tpu_torch import native
from hortimapping_tpu_torch.models.decoder import DecoderSpec
from hortimapping_tpu_torch.ops.mesher import MeshExtractor
from hortimapping_tpu_torch.utils import trace

RADIUS = 0.04
CPUS = len(os.sched_getaffinity(0))


def _ellipsoids(d, n, seed, axes=(0.35, 0.8)):
    """n (d, d, d) f32 grids: the distance-like field of an ellipsoid with
    axes drawn from `axes` (cube radii) and a centre within 0.1 of the
    cube's, in metres on a cube of radius RADIUS (zero set inside)."""
    rng = np.random.default_rng(seed)
    lin = np.linspace(-1.0, 1.0, d, dtype=np.float32)
    x, y, z = np.meshgrid(lin, lin, lin, indexing="ij")
    out = np.empty((n, d, d, d), np.float32)
    for i in range(n):
        a = rng.uniform(*axes, 3).astype(np.float32)
        c = rng.uniform(-0.1, 0.1, 3).astype(np.float32)
        r = np.sqrt(((x - c[0]) / a[0]) ** 2 + ((y - c[1]) / a[1]) ** 2 + ((z - c[2]) / a[2]) ** 2)
        out[i] = (r - 1.0) * a.min() * RADIUS
    return out


_GRIDS = {}


def _grids(d, n, dtype):
    """The seeded grids of (d, n), in f32 or f16; made once a module."""
    if (d, n) not in _GRIDS:
        _GRIDS[d, n] = _ellipsoids(d, n, seed=1000 * d + n)
    return _GRIDS[d, n].astype(dtype)


def _mesher(d, method):
    return MeshExtractor(None, DecoderSpec(), voxels_dim=d, cube_radius=RADIUS, method=method,
                         device="cpu")


def _oracle(m, grid):
    """Today's one-fruit path: numpy widens, the native call meshes, numpy
    scales."""
    return m._grid_to_mesh(grid.astype(np.float32))


def _same(got, want):
    assert got.vertices.dtype == want.vertices.dtype == np.float32
    assert got.faces.dtype == want.faces.dtype == np.int32
    assert got.vertices.shape == want.vertices.shape and got.faces.shape == want.faces.shape
    assert got.vertices.tobytes() == want.vertices.tobytes()
    assert got.faces.tobytes() == want.faces.tobytes()


@pytest.mark.parametrize("n", [1, 3, 32])
@pytest.mark.parametrize("dtype", [np.float16, np.float32], ids=["f16", "f32"])
@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("method", ["mt", "mc"])
def test_batch_equals_one_fruit_path(method, d, dtype, n):
    """Every fruit of the batch is `_grid_to_mesh`'s mesh: the same
    vertices, faces and order, bit for bit."""
    m = _mesher(d, method)
    grids = _grids(d, n, dtype)
    got = m.meshes_from_grids(torch.from_numpy(grids.reshape(n, -1)))
    assert len(got) == n
    for g, grid in zip(got, grids):
        assert g.faces.shape[0] > 0
        _same(g, _oracle(m, grid))


@pytest.mark.parametrize("dtype", [np.float16, np.float32], ids=["f16", "f32"])
@pytest.mark.parametrize("method", ["mt", "mc"])
def test_empty_and_border_grids(method, dtype):
    """A batch with grids that cross nowhere (all outside, all inside) and a
    surface cut by the grid's border meshes as the one-fruit path does:
    empty meshes where nothing crosses, vertices on the border where the
    surface leaves the cube."""
    d = 40
    m = _mesher(d, method)
    normal = _grids(d, 3, np.float32)
    wide = _ellipsoids(d, 1, seed=7, axes=(1.1, 1.3))[0]
    grids = np.stack([np.full((d, d, d), 0.01, np.float32), normal[0],
                      np.full((d, d, d), -0.01, np.float32), wide, normal[1]]).astype(dtype)
    got = m.meshes_from_grids(torch.from_numpy(grids))
    assert len(got) == 5
    for g, grid in zip(got, grids):
        _same(g, _oracle(m, grid))
    for k in (0, 2):
        assert got[k].vertices.shape == (0, 3) and got[k].faces.shape == (0, 3)
    assert (got[3].vertices == np.float32(-RADIUS)).any()
    assert np.abs(got[1].vertices).max() < RADIUS
    assert m.meshes_from_grids(torch.zeros(0, d**3, dtype=torch.float16)) == []


@pytest.mark.parametrize("threads", [CPUS, 32], ids=["cpus", "32"])
@pytest.mark.parametrize("method", ["mt", "mc"])
def test_output_same_at_any_thread_count(method, threads):
    """One thread and `threads` threads (the process's CPUs, or more
    threads than CPUs) give the same bytes, fruit by fruit."""
    d, n = 40, 32
    grids = _grids(d, n, np.float16)
    one, used1 = native.iso_surface_batch(grids, 0.0, 2.0 / (d - 1), 1.0, RADIUS, method, 1)
    many, used = native.iso_surface_batch(grids, 0.0, 2.0 / (d - 1), 1.0, RADIUS, method, threads)
    assert used1 == 1 and used == min(threads, n)
    for (v1, f1), (v, f) in zip(one, many):
        assert v1.tobytes() == v.tobytes() and f1.tobytes() == f.tobytes()


@pytest.mark.parametrize("method", ["mt", "mc"])
def test_every_half_widens_exactly(method):
    """All 65536 f16 bit patterns, shuffled over 16 grids of 16^3, mesh as
    the same grids widened by numpy: the C++ widening is exact for every
    f16 number, and infinities and NaNs mesh as numpy's do."""
    halves = np.random.default_rng(5).permutation(np.arange(65536, dtype=np.uint16))
    grids = halves.view(np.float16).reshape(16, 16, 16, 16)
    got, _ = native.iso_surface_batch(grids, 0.0, 0.125, 1.0, RADIUS, method, CPUS)
    want, _ = native.iso_surface_batch(grids.astype(np.float32), 0.0, 0.125, 1.0, RADIUS, method,
                                       CPUS)
    assert sum(v.shape[0] for v, _ in got) > 65536
    for (v, f), (wv, wf) in zip(got, want):
        assert v.tobytes() == wv.tobytes() and f.tobytes() == wf.tobytes()


@pytest.mark.parametrize("cpus", [1, 4, 8])
@pytest.mark.parametrize("n", [1, 3, 32])
def test_mesh_host_span_reports_the_pool(monkeypatch, n, cpus):
    """Under a trace, `mesh.host`'s `threads` is the pool's real size: one
    thread a fruit up to the CPUs the process may use, and no pool for one
    fruit."""
    monkeypatch.setattr(os, "sched_getaffinity", lambda pid: set(range(cpus)))
    d = 16
    m = _mesher(d, "mt")
    grids = torch.from_numpy(_ellipsoids(d, n, seed=n).astype(np.float16).reshape(n, -1))
    trace.force(True)
    try:
        before = len(trace.spans())
        meshes = m.meshes_from_grids(grids)
        spans = trace.spans()[before:]
    finally:
        trace.force(None)
    (host,) = [s for s in spans if s.name == "mesh.host"]
    assert host.attrs == {"fruits": n, "threads": min(n, cpus)}
    assert len(meshes) == n


def test_arrays_own_their_native_memory(monkeypatch):
    """A batch's arrays lie in native memory that stays valid while any
    array made from any of them lives, and is freed, once a batch, when
    none is left."""
    lib = native.load()
    freed = []
    free = lib.horti_iso_batch_free
    monkeypatch.setattr(lib, "horti_iso_batch_free", lambda p: (freed.append(p), free(p)))
    d = 40
    grids = _grids(d, 3, np.float16)
    pairs, _ = native.iso_surface_batch(grids, 0.0, 2.0 / (d - 1), 1.0, RADIUS, "mt", 3)
    want = [(v.copy(), f.copy()) for v, f in pairs]
    faces = pairs[1][1][5:]
    verts = pairs[2][0].T
    del pairs
    gc.collect()
    assert freed == []
    native.iso_surface_batch(grids, 0.0, 2.0 / (d - 1), 1.0, RADIUS, "mt", 3)
    gc.collect()
    assert len(freed) == 1
    assert np.array_equal(faces, want[1][1][5:]) and np.array_equal(verts, want[2][0].T)
    del faces
    gc.collect()
    assert len(freed) == 1
    del verts
    gc.collect()
    assert len(freed) == 2
