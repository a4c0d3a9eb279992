"""PyTorch port vs the JAX package: config, normal equations, the whole bench
path (retrieval warm start -> coarse-to-fine LM -> meshing) and the metric,
on identical numpy inputs on the CPU.

The JAX package runs its CPU route (dense render path, XLA decoder); the port
runs its kernel route with the plain versions (fused render term in f32,
explicit fwd+input-grad chain). The decoder is the trained 64-wide
`synthetic_small_8`, zero-padded to the 128-wide hidden layers the kernels
take (the same function exactly).
"""

import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hortimapping_tpu import config as jconfig
from hortimapping_tpu import native as jnative
from hortimapping_tpu.metrics.chamfer import _nn_min_dists
from hortimapping_tpu.models.decoder import DecoderSpec as JSpec
from hortimapping_tpu.ops.mesher import MeshExtractor as JMesher
from hortimapping_tpu.ops.mesher import create_voxel_grid as jgrid
from hortimapping_tpu.optim.lm import normal_equations as jne
from hortimapping_tpu.optim.warmstart import retrieval_init_batched as jinit
from hortimapping_tpu.optim.warmstart import retrieval_joint_opt as jsolve
from hortimapping_tpu.tools.synthetic import SyntheticCategory as JCat
from hortimapping_tpu.tools.synthetic import make_scene as jscene
from hortimapping_tpu_torch import config as tconfig
from hortimapping_tpu_torch import native as tnative
from hortimapping_tpu_torch.metrics.chamfer import chamfer_distance, nn_distances
from hortimapping_tpu_torch.models.decoder import DecoderSpec as TSpec
from hortimapping_tpu_torch.models.workspace import params_from_jax
from hortimapping_tpu_torch.ops.mesher import MeshExtractor as TMesher
from hortimapping_tpu_torch.ops.mesher import create_voxel_grid as tgrid
from hortimapping_tpu_torch.optim.lm import normal_equations as tne
from hortimapping_tpu_torch.optim.state import stack_observations
from hortimapping_tpu_torch.optim.warmstart import retrieval_init_batched as tinit
from hortimapping_tpu_torch.optim.warmstart import retrieval_joint_opt as tsolve
from hortimapping_tpu_torch.tools.synthetic import SyntheticCategory as TCat
from hortimapping_tpu_torch.tools.synthetic import make_scene as tscene
from torch_port_common import load_npz_params, widen_decoder_np

torch.set_num_threads(1)

CONFIGS = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "..", "configs", "*.yaml")))
CUBE_RADIUS = 0.08


# ---------------------------------------------------------------- config

@pytest.mark.parametrize("path", CONFIGS, ids=[os.path.basename(p) for p in CONFIGS])
def test_config_parse_matches_jax(path):
    raw = jconfig.load_config(path)
    want = dataclasses.asdict(jconfig.JointOptConfig.from_dict(raw))
    got = dataclasses.asdict(tconfig.JointOptConfig.from_dict(tconfig.load_config(path)))
    assert got == want


def test_unported_options_raise():
    with pytest.raises(NotImplementedError):
        tconfig.JointOptConfig(init_mode="other").check_ported()
    # the JAX package's compacted render route is not ported: refused by
    # name, explicit and auto budgets alike
    for kw in (dict(jac_cap=64), dict(fwd_cap=128), dict(jac_cap=0, fwd_cap=0, fwd_bf16=True)):
        with pytest.raises(NotImplementedError, match=next(iter(kw))):
            tconfig.JointOptConfig(**kw).check_ported()
    tconfig.JointOptConfig(init_mode="retrieval", trust_region=True, pose_polish_iters=2,
                           multi_start=3, rescue_starts=4).check_ported()


# ---------------------------------------------------------------- bench batch

def _cfg_kwargs(**over):
    # the bench schedule (bench.py bench_cfg) at a CPU-test size; the fused
    # term in f32 so both packages solve the same f32 problem
    kw = dict(scale_on=True, n_fg_pix=32, n_bg_pix=32, n_frame=4, n_sample_on_ray=16,
              recon_n_pts=300, max_iter=50, coarse_to_fine=True, fine_max_iter=2,
              coarse_frame_stride=2, coarse_ray_frac=0.5, coarse_sample_frac=0.5,
              coarse_pts_frac=0.5, coarse_max_iter=8, fine_ray_frac=0.75,
              fine_sample_frac=0.75, fine_pts_frac=0.75, fused_bf16=False)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def small():
    params_np, fields, table, base_radius = load_npz_params("synthetic_small_8")
    params_np, fields = widen_decoder_np(params_np, fields, 128)
    return dict(
        jp=jax.tree_util.tree_map(jnp.asarray, params_np),
        tp=params_from_jax(params_np, "cpu"),
        jspec=JSpec(**fields), tspec=TSpec(**fields), table=table, base_radius=base_radius,
    )


def _batch(small, seed, n=2):
    cfg = tconfig.JointOptConfig(**_cfg_kwargs())
    rng = np.random.default_rng(seed)
    obs_list, T_list, gts = [], [], []
    for b in range(n):
        code = (rng.normal(size=small["tspec"].code_length) * 0.3).astype(np.float32)
        T_wo = np.eye(4, dtype=np.float32)
        T_wo[:3, 3] = rng.normal(size=3) * 0.1
        args = (code, T_wo, cfg.n_frame, cfg.n_fg_pix, cfg.n_bg_pix, cfg.recon_n_pts)
        o_t, gt = tscene(TCat(spec=small["tspec"], base_radius=small["base_radius"]), *args, seed=b)
        o_j, _ = jscene(JCat(spec=small["jspec"], base_radius=small["base_radius"]), *args, seed=b)
        for a_t, a_j in zip(o_t, o_j):
            np.testing.assert_array_equal(a_t, a_j)  # the scene generator is a copy
        obs_list.append(o_t)
        T_list.append(np.linalg.inv(T_wo).astype(np.float32))
        gts.append(gt)
    jobs = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *obs_list)
    return jobs, stack_observations(obs_list, "cpu"), np.stack(T_list), gts


RETRIEVAL = dict(n_score_pts=64, n_scales=3, scale_min=0.9, scale_max=1.1, score_bf16=False)


def test_retrieval_picks_the_same_code_and_scale(small):
    jobs, tobs, T0, _ = _batch(small, 42)
    kw = dict(top_k=8, n_score_pts=64, n_scales=3, scale_min=0.9, scale_max=1.1)
    want = jinit(small["jp"], small["jspec"], jnp.asarray(small["table"]), jobs.points_w,
                 jobs.point_valid, T_init=jnp.asarray(T0), **kw)
    got = tinit(small["tp"], small["tspec"], torch.as_tensor(small["table"]), tobs.points_w,
                tobs.point_valid, T_init=torch.as_tensor(T0), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))   # same code
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))   # same scale
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))   # same top-K


def test_normal_equations_match_jax(small):
    jobs, tobs, T0, _ = _batch(small, 42)
    cfg_kw = _cfg_kwargs(coarse_to_fine=False)
    jc, tc = jconfig.JointOptConfig(**cfg_kw), tconfig.JointOptConfig(**cfg_kw)
    rng = np.random.default_rng(0)
    lat = (rng.normal(size=(2, 8)) * 0.1).astype(np.float32)
    i = np.array([0, 7], np.int32)  # lane 1 past robust_iter: Huber weights on
    H, b, failed = tne(small["tp"], small["tspec"], tc, tobs, torch.as_tensor(lat),
                       torch.as_tensor(T0), torch.as_tensor(i), CUBE_RADIUS)
    for k in range(2):
        o = jax.tree_util.tree_map(lambda a: a[k], jobs)
        Hj, bj, fj = jne(small["jp"], small["jspec"], jc, o, jnp.asarray(lat[k]),
                         jnp.asarray(T0[k]), jnp.int32(i[k]), CUBE_RADIUS)
        assert bool(failed[k]) == bool(fj)
        # f32 sums over ~10^3 rays and points in another order
        np.testing.assert_allclose(H[k].numpy(), np.asarray(Hj), atol=2e-5 * float(np.abs(Hj).max()), rtol=0)
        np.testing.assert_allclose(b[k].numpy(), np.asarray(bj), atol=2e-5 * float(np.abs(bj).max()), rtol=0)


# Two bench-path solves. The LM is only piecewise smooth (a sample crossing
# the |sdf| band edge switches its ray in or out), so f32 rounding can send
# two correct solvers down different paths; on these scenes neither package
# comes near such an edge, and the port stays within 2e-4 of JAX after the
# full schedule (measured ~4e-5 and ~5e-7). "linear_occ" also converges
# lane 0 early through the convergence tests.
SOLVES = {"linear_occ": (dict(log_sdf_occ=False), 42), "log_occ": ({}, 7)}


@pytest.mark.parametrize("case", list(SOLVES))
def test_bench_path_matches_jax(small, case):
    over, seed = SOLVES[case]
    kw = _cfg_kwargs(**over)
    jobs, tobs, T0, gts = _batch(small, seed)
    want = jsolve(small["jp"], small["jspec"], jconfig.JointOptConfig(**kw),
                  jnp.asarray(small["table"]), jobs, jnp.asarray(T0), CUBE_RADIUS, **RETRIEVAL)
    got = tsolve(small["tp"], small["tspec"], tconfig.JointOptConfig(**kw),
                 torch.as_tensor(small["table"]), tobs, torch.as_tensor(T0), CUBE_RADIUS,
                 device="cpu", **RETRIEVAL)
    np.testing.assert_array_equal(got.iter_count.numpy(), np.asarray(want.iter_count))
    np.testing.assert_array_equal(got.failed.numpy(), np.asarray(want.failed))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(want.converged))
    np.testing.assert_allclose(got.latent.numpy(), np.asarray(want.latent), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.T_ow.numpy(), np.asarray(want.T_ow), atol=2e-4, rtol=0)

    # meshing: the f16 grids agree within f16 rounding, and the same grid
    # gives the same mesh through either package's native binding
    tm = TMesher(small["tp"], small["tspec"], voxels_dim=16, cube_radius=CUBE_RADIUS, device="cpu")
    jm = JMesher(small["jp"], small["jspec"], voxels_dim=16, cube_radius=CUBE_RADIUS)
    g_t = tm.decode_grids(got.latent)
    g_j = np.asarray(jm.decode_grids_async(jnp.asarray(got.latent.numpy())))
    np.testing.assert_allclose(g_t.float().numpy(), g_j.astype(np.float32),
                               atol=2 * float(np.finfo(np.float16).eps), rtol=2e-3)
    meshes = tm.meshes_from_grids(torch.as_tensor(np.array(g_j)))
    for mesh, grid in zip(meshes, g_j.reshape(-1, 16, 16, 16)):
        v, f = jnative.marching_tetrahedra(grid.astype(np.float32), 0.0, 2.0 / 15)
        np.testing.assert_array_equal(mesh.faces, f)
        np.testing.assert_array_equal(mesh.vertices, ((v - 1.0) * CUBE_RADIUS).astype(np.float32))
        assert mesh.faces.shape[0] > 100
    # the solved shape is close to the GT surface (a loose sanity bound on a
    # 16^3 grid: the test asserts the pipeline, the card measures quality)
    T_wo = np.linalg.inv(got.T_ow.numpy())
    gen = torch.Generator().manual_seed(0)
    for mesh, gt, T in zip(meshes, gts, T_wo):
        pts = mesh.transform(T).sample_points_on_device(4000, gen)
        assert chamfer_distance(torch.as_tensor(gt), pts) < 0.01


def test_voxel_grid_and_native_match_jax():
    np.testing.assert_array_equal(tgrid(7), jgrid(7))
    rng = np.random.default_rng(3)
    a = rng.normal(size=(300, 3)).astype(np.float32)
    b = rng.normal(size=(200, 3)).astype(np.float32)
    # the JAX package builds with -march=native (FMA), the port without: 1 ulp
    np.testing.assert_allclose(tnative.nn_distances(a, b), jnative.nn_distances(a, b), rtol=1e-6, atol=0)


def test_nn_distances_match_jax():
    rng = np.random.default_rng(4)
    # world-frame clouds far from the origin: the recenter-and-recompute fix
    a = (rng.normal(size=(500, 3)) * 0.03 + 0.6).astype(np.float32)
    b = (rng.normal(size=(700, 3)) * 0.03 + 0.6).astype(np.float32)
    got = nn_distances(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    want = np.asarray(_nn_min_dists(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
    exact = np.sqrt(((a[:, None] - b[None]) ** 2).sum(-1)).min(1)
    np.testing.assert_allclose(got, exact, atol=1e-6, rtol=1e-5)
    assert chamfer_distance(torch.as_tensor(b), torch.zeros(0, 3)) == 0.0
