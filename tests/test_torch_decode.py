"""PyTorch port vs the JAX package: the forward kernels' plain versions (B3
`mlp_sdf`, B4 `mlp_sdf_shared_latent`), the mesher on both decode routes
with both iso-surfacers, and retrieval scoring, on identical numpy inputs
on the CPU.

The JAX side runs its Pallas kernels in interpret mode (as its own tests
run them on the CPU) or its XLA route; the port's wrappers take their plain
versions, since the tensors lie on the CPU. Tolerances:
* f32: the two packages differ only in summation order, ~1e-7 relative;
* bf16: both round every matmul operand to bf16 and accumulate in f32, but
  in another order, so an activation now and then rounds one bf16 ulp the
  other way; held by the median and by a maximum below the bf16-vs-f32
  gap, as the card holds the CUDA kernels;
* f16 grids: the mesher ships f16, so two f32 grids agree within 2 f16 ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hortimapping_tpu import native as jnative
from hortimapping_tpu.data.mesh import TriangleMesh as JMesh
from hortimapping_tpu.models.decoder import DecoderSpec as JSpec
from hortimapping_tpu.ops import pallas_mlp
from hortimapping_tpu.ops.mesher import MeshExtractor as JMesher
from hortimapping_tpu.optim.warmstart import _score_codes as jscore
from hortimapping_tpu_torch.data.mesh import TriangleMesh as TMesh
from hortimapping_tpu_torch.models.decoder import DecoderSpec as TSpec
from hortimapping_tpu_torch.models.workspace import params_from_jax
from hortimapping_tpu_torch.ops import mlp_kernels
from hortimapping_tpu_torch.ops.mesher import MeshExtractor as TMesher
from hortimapping_tpu_torch.optim.warmstart import _score_codes as tscore
from torch_port_common import load_npz_params, random_decoder_np, widen_decoder_np

torch.set_num_threads(1)

SPECS = {
    "latent_in": dict(code_length=8, dims=(128,) * 4, latent_in=(2,), clamping_distance=0.1),
    "no_skip": dict(code_length=8, dims=(128,) * 3, latent_in=(), clamping_distance=0.1),
}
CUBE_RADIUS = 0.08
F16_EPS = float(np.finfo(np.float16).eps)


def _random(name, seed):
    params_np = random_decoder_np(TSpec(**SPECS[name]), seed)
    return (jax.tree_util.tree_map(jnp.asarray, params_np), JSpec(**SPECS[name]),
            params_from_jax(params_np, "cpu"), TSpec(**SPECS[name]))


def _bf16_close(got, want, med=1e-6, worst=2e-3):
    """bf16 held by the median (rows with no flipped rounding agree to f32
    level) and a maximum 3x below the bf16-vs-f32 gap of these decoders
    (~7e-3), so a run in f32 would not pass."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.median(d) <= med and d.max() <= worst, (np.median(d), d.max())


@pytest.fixture(scope="module")
def small():
    """The trained 64-wide synthetic_small_8 decoder, zero-padded to the
    128-wide hidden layers the kernels take (the same function)."""
    params_np, fields, table, _ = load_npz_params("synthetic_small_8")
    params_np, fields = widen_decoder_np(params_np, fields, 128)
    return dict(jp=jax.tree_util.tree_map(jnp.asarray, params_np), jspec=JSpec(**fields),
                tp=params_from_jax(params_np, "cpu"), tspec=TSpec(**fields), table=table)


# ---------------------------------------------------------------- B3

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("name", list(SPECS))
def test_mlp_sdf_matches_pallas(name, dtype):
    jp, jspec, tp, tspec = _random(name, 3)
    bf16 = dtype == "bf16"
    x = (np.random.default_rng(0).normal(size=(1000, tspec.in_dim)) * 0.3).astype(np.float32)
    want = pallas_mlp.mlp_sdf(pallas_mlp.pack_params(jp, jspec, jnp.bfloat16 if bf16 else jnp.float32),
                              pallas_mlp.packed_spec(jspec), jnp.asarray(x), bf16=bf16, tile=256)
    pk = mlp_kernels.pack_params(tp, tspec, torch.bfloat16 if bf16 else torch.float32)
    got = mlp_kernels.mlp_sdf_plain(pk, torch.as_tensor(x))
    # 1000 rows: not a multiple of the Pallas tile (256) nor of a CUDA chunk (32/64)
    assert got.shape == (1000,)
    if bf16:
        _bf16_close(got.numpy(), want)
        f32 = mlp_kernels.mlp_sdf_plain(mlp_kernels.pack_params(tp, tspec), torch.as_tensor(x))
        assert float((got - f32).abs().max()) > 2e-3   # the modes differ: bf16 is bf16
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)
    # the wrapper takes the plain version for a CPU tensor
    np.testing.assert_array_equal(mlp_kernels.mlp_sdf(pk, torch.as_tensor(x)).numpy(), got.numpy())


def test_kernel_decoder_matches_pallas_decoder():
    jp, jspec, tp, tspec = _random("latent_in", 4)
    x = (np.random.default_rng(1).normal(size=(3, 7, tspec.in_dim)) * 0.3).astype(np.float32)
    jd = pallas_mlp.PallasDecoder(jp, jspec)
    td = mlp_kernels.KernelDecoder(tp, tspec)
    assert td.bf16 and td.packed.bf16 and not td.packed_f32.bf16
    _bf16_close(td.sdf(torch.as_tensor(x)).numpy(), jd.sdf(jnp.asarray(x)))
    s_t, g_t = td.sdf_and_input_grad(torch.as_tensor(x))
    s_j, g_j = jd.sdf_and_input_grad(jnp.asarray(x))
    assert g_t.shape == (3, 7, tspec.in_dim)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=2e-6, rtol=0)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=2e-5, rtol=0)


# ---------------------------------------------------------------- B4

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_shared_latent_matches_pallas(dtype):
    jp, jspec, tp, tspec = _random("latent_in", 3)
    bf16 = dtype == "bf16"
    lat = (np.random.default_rng(4).normal(size=(2, tspec.code_length)) * 0.2).astype(np.float32)
    pts = (np.random.default_rng(5).normal(size=(777, 3)) * 0.3).astype(np.float32)
    packed = pallas_mlp.pack_params(jp, jspec, jnp.bfloat16 if bf16 else jnp.float32)
    want = np.stack([np.asarray(pallas_mlp.mlp_sdf_shared_latent(
        packed, pallas_mlp.packed_spec(jspec), jnp.asarray(l), jnp.asarray(pts), bf16=bf16))
        for l in lat])
    pk = mlp_kernels.pack_params(tp, tspec, torch.bfloat16 if bf16 else torch.float32)
    got = mlp_kernels.mlp_sdf_shared_latent_plain(pk, torch.as_tensor(lat), torch.as_tensor(pts))
    assert got.shape == (2, 777)
    if bf16:
        _bf16_close(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)
    wrapped = mlp_kernels.mlp_sdf_shared_latent(pk, torch.as_tensor(lat), torch.as_tensor(pts))
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())


# ---------------------------------------------------------------- mesher

# (port constructor options, JAX constructor options)
ROUTES = {
    "kernel_bf16": (dict(use_kernel=True, bf16=True), dict(use_pallas=True)),
    "kernel_f32": (dict(use_kernel=True, bf16=False), dict()),
    "plain_default": (dict(), dict()),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_mesher_grid_matches_jax(small, route):
    t_kw, j_kw = ROUTES[route]
    d = 14
    tm = TMesher(small["tp"], small["tspec"], voxels_dim=d, cube_radius=CUBE_RADIUS,
                 device="cpu", **t_kw)
    jm = JMesher(small["jp"], small["jspec"], voxels_dim=d, cube_radius=CUBE_RADIUS, **j_kw)
    assert (tm.packed is not None) == (route != "plain_default")
    lat = small["table"][:3]
    got = tm.decode_grids(torch.as_tensor(lat))
    want = np.asarray(jm.decode_grids_async(jnp.asarray(lat)))
    assert got.dtype == torch.float16 and got.shape == (3, d ** 3)
    g, w = got.float().numpy(), want.astype(np.float32)
    if route == "kernel_bf16":
        _bf16_close(g, w)
    else:
        np.testing.assert_allclose(g, w, atol=2 * F16_EPS, rtol=2e-3)
    # one code at a time gives the same grid
    np.testing.assert_array_equal(tm.decode_sdf_grid(torch.as_tensor(lat[1])),
                                  g[1].reshape(d, d, d).astype(np.float16))


def _sphere_grids(d, radii):
    ax = np.linspace(-1.0, 1.0, d, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    r = np.sqrt(x * x + y * y + z * z)
    return np.stack([(r - rad).reshape(-1) for rad in radii]).astype(np.float16)


@pytest.mark.parametrize("method", ["mt", "mc"])
def test_meshes_match_jax_native(small, method):
    """The same grids give the same meshes through either package's
    iso-surfacer, at 64^3 with 5 fruits (the threaded host meshing)."""
    d = 64
    grids = _sphere_grids(d, [0.5, 0.55, 0.6, 0.65, 0.7])
    tm = TMesher(small["tp"], small["tspec"], voxels_dim=d, cube_radius=CUBE_RADIUS,
                 method=method, device="cpu")
    iso = jnative.marching_cubes if method == "mc" else jnative.marching_tetrahedra
    meshes = tm.meshes_from_grids(torch.as_tensor(grids))
    assert len(meshes) == 5
    for mesh, grid in zip(meshes, grids):
        v, f = iso(grid.reshape(d, d, d).astype(np.float32), 0.0, 2.0 / (d - 1))
        np.testing.assert_array_equal(mesh.faces, f)
        np.testing.assert_array_equal(mesh.vertices, ((v - 1.0) * CUBE_RADIUS).astype(np.float32))
        assert mesh.faces.shape[0] > 1000
    with pytest.raises(ValueError):
        TMesher(small["tp"], small["tspec"], voxels_dim=8, method="dc", device="cpu")


def test_complete_mesh_batch_poses_and_colors(small):
    d = 12
    tm = TMesher(small["tp"], small["tspec"], voxels_dim=d, cube_radius=CUBE_RADIUS,
                 use_kernel=True, bf16=False, device="cpu")
    lat = torch.as_tensor(small["table"][:2])
    T = np.eye(4, dtype=np.float32)[None].repeat(2, 0)
    T[:, :3, 3] = [[0.1, -0.2, 0.3], [0.0, 0.05, -0.1]]
    colors = [[1.0, 0.0, 0.0], [0.2, 0.4, 0.6]]
    got = tm.complete_mesh_batch(lat, T, colors)
    plain = tm.meshes_from_grids(tm.decode_grids(lat))
    for g, m, t, c in zip(got, plain, T, colors):
        want = JMesh(m.vertices, m.faces).paint_uniform_color(c).transform(t)
        np.testing.assert_array_equal(g.vertices, want.vertices)
        np.testing.assert_array_equal(g.faces, want.faces)
        np.testing.assert_array_equal(g.vertex_colors, want.vertex_colors)
    one = tm.complete_mesh(lat[1], T[1], colors[1])
    np.testing.assert_array_equal(one.vertices, got[1].vertices)
    assert isinstance(one, TMesh) and one.vertex_colors.shape == (one.vertices.shape[0], 3)


# ---------------------------------------------------------------- retrieval scoring

@pytest.mark.parametrize("route", ["kernel", "plain"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_score_codes_retrieve_the_same_code(small, bf16, route):
    """Both routes of the port's scoring (a KernelDecoder's forward, here its
    plain version, and the plain decoder forward) vs the JAX package's."""
    rng = np.random.default_rng(6)
    G, P = 3, 48
    dirs = rng.normal(size=(G, P, 3))
    pts = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True) * 0.05).astype(np.float32)
    valid = np.ones((G, P), bool)
    valid[1, 40:] = False
    table = small["table"]
    # block_elems below N * P: the port's code blocks and the JAX lax.map blocks
    kw = dict(bf16=bf16, block_elems=4096)
    dec = (mlp_kernels.KernelDecoder(small["tp"], small["tspec"], bf16=bf16)
           if route == "kernel" else None)
    got = tscore(small["tp"], small["tspec"], torch.as_tensor(table), torch.as_tensor(pts),
                 torch.as_tensor(valid), decoder=dec, **kw).numpy()
    want = np.stack([np.asarray(jscore(small["jp"], small["jspec"], jnp.asarray(table),
                                       jnp.asarray(pts[g]), jnp.asarray(valid[g]), **kw))
                     for g in range(G)])
    assert got.shape == (G, table.shape[0])
    np.testing.assert_array_equal(got.argmin(1), want.argmin(1))
    # a score is a mean of clamped |sdf|: bf16 flips average out
    np.testing.assert_allclose(got, want, atol=2e-4 if bf16 else 1e-6, rtol=0)
