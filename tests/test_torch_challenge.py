"""The port's challenge slice against the JAX package on the CPU: the
challenge generator, `ShapeCompletionDataset`, the DeepSDF baseline
(`shape_opt_deepsdf(_batched)`), the `pose_known=True` solve and
`run_challenge` on the JAX challenge test's fixture
(`tests/test_pipeline_challenge.py`: synthetic_small_8, 2 fruits, 4 frames,
written once by the JAX generator).

Tolerances.
* Generator: file lists, intrinsics, poses and GT clouds equal; masks equal
  on >= 99.9 % of pixels; depth within 1e-5 m where both frames hit the
  scene (the port marches in torch, the JAX package in numpy).
* Dataset items: everything but the depth equal; depth and the fused cloud
  within the depth filter's 4 float32 ulps (`tests/test_torch_rgbd.py`).
* Solvers: iteration counts and flags equal, latents and poses within 2e-4
  (`tests/test_torch_solver.py`); a lane the DeepSDF baseline freezes keeps
  its latent bit for bit.
* `run_challenge`: fruit lists, failed flags and per-fruit iteration counts
  equal; the written meshes within half a voxel in mean symmetric
  nearest-neighbour distance; per-fruit Chamfer within 0.05 mm and P/R/F1 at
  5 mm within 0.5 points; latents and poses within 2e-4.
  The fixed-lambda mean-init schedule of these fixtures (12 or 10
  unconverged iterations) carries some lanes across render-band edges
  (`tests/test_torch_solver.py` docstring): on the challenge fixture JAX's
  own second step moves by ~1e-5 when its iterate moves by the ~1e-7 by
  which the two packages' first iterates differ, and ~50x more each further
  iteration; on the lab single-frame fixture JAX's compiled loop and the
  same iteration dispatched op by op end 0.1 apart in one lane's latent,
  while a one-ulp change of JAX's start moves neither. So that schedule is
  also run under two probes of JAX's pipeline: JAX's solve continued from
  the port's first iterate (which must agree with JAX's own first iterate
  within 1e-6), and JAX's LM iteration dispatched op by op instead of
  compiled into one loop. A lane that no probe moves by more than 2e-4 is
  held to JAX's own run; a lane a probe moves further is held, at the same
  bounds (2e-4, 0.05 mm), to the one of JAX's runs nearest to the port's,
  and P/R/F1 then to the larger of 0.5 points and the largest gap between
  two of JAX's runs. (Measured: each such lane lies within 5e-7 of one of
  JAX's runs.)
"""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import hortimapping_tpu.optim.warmstart as jws
from hortimapping_tpu.data.challenge import ShapeCompletionDataset as JDataset
from hortimapping_tpu.data.challenge import load_K as jload_K
from hortimapping_tpu.optim import lm as jlm
from hortimapping_tpu.optim.state import OptResult as JResult
from hortimapping_tpu.optim.state import init_state as jinit_state
from hortimapping_tpu.pipeline import challenge as jchallenge
from hortimapping_tpu.tools import make_demo_data as jgen
from hortimapping_tpu_torch import config as tconfig
from hortimapping_tpu_torch.data import imageio
from hortimapping_tpu_torch.data.challenge import ShapeCompletionDataset, load_K, read_mask
from hortimapping_tpu_torch.data.ply import read_mesh, read_point_cloud
from hortimapping_tpu_torch.models.decoder import DecoderSpec as TSpec
from hortimapping_tpu_torch.models.workspace import params_from_jax
from hortimapping_tpu_torch.optim import lm as tlm
from hortimapping_tpu_torch.optim.state import FruitObservations
from hortimapping_tpu_torch.pipeline import challenge as tchallenge
from hortimapping_tpu_torch.tools import make_demo_data as tgen
from test_pipeline_challenge import ASSET_DIR, _cfg
from test_torch_solver import CUBE_RADIUS, _assert_same, _batch, _cfgs, _t, small  # noqa: F401

ULPS = 4
QUIET = lambda *a: None  # noqa: E731

pytestmark = pytest.mark.skipif(not os.path.isdir(ASSET_DIR), reason="synthetic assets not built")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("challenge_torch")
    jdir, tdir = str(root / "jax"), str(root / "torch")
    jgen.make_challenge_dataset(jdir, ASSET_DIR, split="val", n_fruits=2, n_frames=4)
    tgen.make_challenge_dataset(tdir, ASSET_DIR, split="val", n_fruits=2, n_frames=4,
                                device="cpu")
    return root, jdir, tdir


# ---------------------------------------------------------------- data

def test_generator_matches_jax(datasets):
    _, jdir, tdir = datasets
    fruits = sorted(os.listdir(os.path.join(jdir, "val")))
    assert fruits == sorted(os.listdir(os.path.join(tdir, "val"))) == ["fruit_00", "fruit_01"]
    for fid in fruits:
        ja, ta = os.path.join(jdir, "val", fid), os.path.join(tdir, "val", fid)
        for sub in ("input/masks", "input/poses", "input/color", "input/depth"):
            assert sorted(os.listdir(os.path.join(ja, sub))) == sorted(
                os.listdir(os.path.join(ta, sub))), sub
        with open(os.path.join(ja, "input", "intrinsic.json")) as fa, \
                open(os.path.join(ta, "input", "intrinsic.json")) as fb:
            assert fa.read() == fb.read()
        np.testing.assert_array_equal(
            read_point_cloud(os.path.join(ja, "gt", "pcd", "fruit.ply")).points,
            read_point_cloud(os.path.join(ta, "gt", "pcd", "fruit.ply")).points)
        for fn in sorted(os.listdir(os.path.join(ja, "input", "masks"))):
            stem = fn[:-4]
            with open(os.path.join(ja, "input", "poses", stem + ".txt")) as fa, \
                    open(os.path.join(ta, "input", "poses", stem + ".txt")) as fb:
                assert fa.read() == fb.read()
            ma = read_mask(os.path.join(ja, "input", "masks", fn))
            mb = read_mask(os.path.join(ta, "input", "masks", fn))
            assert set(np.unique(ma)) == {0, 1} and (ma == mb).mean() >= 0.999
            da = np.load(os.path.join(ja, "input", "depth", stem + ".npy"))
            db = np.load(os.path.join(ta, "input", "depth", stem + ".npy"))
            both = (da > 0) & (db > 0)
            assert both.mean() > 0.5 and np.abs(da[both] - db[both]).max() <= 1e-5
            ca = imageio.imread(os.path.join(ja, "input", "color", fn))
            cb = imageio.imread(os.path.join(ta, "input", "color", fn))
            assert (ca == cb).all(-1).mean() >= 0.999


def test_cameras_march_together_as_alone():
    """The challenge and lab generators march all frames of a fruit in one
    pass; each frame comes out bit-equal to its march alone."""
    K = tgen.intrinsics(24, 18)
    fruits = [(np.eye(4), np.array([0.05, 0.04, 0.06]))]
    poses = [tgen.look_at(np.array([0.3 * np.sin(a), 0.05, -0.3]), np.zeros(3))
             for a in (0.0, 0.7, -1.1)]
    together = tgen.render_frames(poses, K, 24, 18, fruits, 0.5, device="cpu")
    for T, (d, i, c) in zip(poses, together):
        d1, i1, c1 = tgen.render_frame(T, K, 24, 18, fruits, 0.5, device="cpu")
        np.testing.assert_array_equal(d, d1)
        np.testing.assert_array_equal(i, i1)
        np.testing.assert_array_equal(c, c1)
        assert (i == 2).any() and (i == 1).any()


def test_dataset_items_match_jax(datasets, tmp_path):
    _, jdir, _ = datasets
    got, want = ShapeCompletionDataset(jdir, "val"), JDataset(jdir, "val")
    assert len(got) == len(want) == 2 and list(got.fruit_list) == list(want.fruit_list)
    np.testing.assert_array_equal(load_K(os.path.join(jdir, "val", "fruit_00", "input",
                                                      "intrinsic.json")),
                                  jload_K(os.path.join(jdir, "val", "fruit_00", "input",
                                                       "intrinsic.json")))
    for i in range(2):
        a, b = got[i], want[i]
        assert a["fid"] == b["fid"] and sorted(a) == sorted(b)
        np.testing.assert_array_equal(a["groundtruth_pcd"].points, b["groundtruth_pcd"].points)
        np.testing.assert_array_equal(a["rgbd_intrinsic"], b["rgbd_intrinsic"])
        assert list(a["rgbd_frames"]) == list(b["rgbd_frames"])
        for k, fa in a["rgbd_frames"].items():
            fb = b["rgbd_frames"][k]
            for name in ("rgb", "mask", "pose"):
                np.testing.assert_array_equal(fa[name], fb[name])
                assert fa[name].dtype == fb[name].dtype
            assert fa["fname"] == fb["fname"]
            assert np.all(np.abs(fa["depth"] - fb["depth"])
                          <= ULPS * np.spacing(np.abs(fb["depth"])))
        pa, pb = a["rgbd_pcd"], b["rgbd_pcd"]
        assert len(pa) == len(pb) > 500
        np.testing.assert_allclose(pa.points, pb.points, rtol=0, atol=ULPS * 1.2e-7)
        np.testing.assert_array_equal(pa.colors, pb.colors)
    # the test split has no GT
    shutil.copytree(os.path.join(jdir, "val"), str(tmp_path / "test"))
    assert "groundtruth_pcd" not in ShapeCompletionDataset(str(tmp_path), "test")[0]


def test_colour_masks_are_refused(datasets, tmp_path):
    _, jdir, _ = datasets
    src = os.path.join(jdir, "val", "fruit_00", "input", "masks", "00000.png")
    bad = str(tmp_path / "mask.png")
    m = read_mask(src)
    imageio.imwrite(bad, np.stack([m] * 3, -1))
    with pytest.raises(ValueError, match="mask.png"):
        read_mask(bad)


# ---------------------------------------------------------------- solvers

def _object_points(jobs, T0):
    """Surface points in the object frame of the pose inits (JAX and port)."""
    pw = np.asarray(jobs.points_w)
    po = (pw @ np.transpose(T0[:, :3, :3], (0, 2, 1)) + T0[:, None, :3, 3]).astype(np.float32)
    return po, np.array(jobs.point_valid)


DEEPSDF = dict(w_recon=1.0, w_codereg=1e-3, robust_iter=3, max_iter=12, epsilon_g=1e-5,
               epsilon_c=2e-2)


@pytest.mark.parametrize("lm_eye,eps", [(False, (1e-4, 5e-2)), (True, (1e-5, 2e-2))])
def test_deepsdf_baseline_matches_jax(small, lm_eye, eps):
    """Both damping forms, with tests that stop some lanes before others."""
    jc, tc = _cfgs(lm_eye=lm_eye, **dict(DEEPSDF, epsilon_g=eps[0], epsilon_c=eps[1]))
    jobs, _, T0, lat0 = _batch(small, 5, 4)
    po, pv = _object_points(jobs, T0)
    pv[2, 150:] = False                       # a lane with padded points
    want_lat, want_it = jlm.shape_opt_deepsdf_batched(small["jp"], small["jspec"], jc,
                                                      jnp.asarray(po), jnp.asarray(pv),
                                                      jnp.asarray(lat0))
    got_lat, got_it = tlm.shape_opt_deepsdf_batched(small["tp"], small["tspec"], tc, *_t(po, pv, lat0),
                                                    device="cpu")
    np.testing.assert_array_equal(got_it.numpy(), np.asarray(want_it))
    assert len(set(got_it.tolist())) > 1     # lanes finish at different iterations
    np.testing.assert_allclose(got_lat.numpy(), np.asarray(want_lat), atol=2e-4, rtol=0)
    # a lane that finished keeps its latent bit for bit: the run cut at that
    # lane's own iteration count leaves it where the full run does
    first = int(got_it.min())
    cut, _ = tlm.shape_opt_deepsdf_batched(small["tp"], small["tspec"],
                                           dataclasses.replace(tc, max_iter=first),
                                           *_t(po, pv, lat0), device="cpu")
    done = got_it == first
    assert torch.equal(cut[done], got_lat[done])
    # the unbatched function is the batched one at B = 1, and JAX's
    one_lat, one_it = tlm.shape_opt_deepsdf(small["tp"], small["tspec"], tc,
                                            *_t(po[1], pv[1], lat0[1]), device="cpu")
    b1_lat, b1_it = tlm.shape_opt_deepsdf_batched(small["tp"], small["tspec"], tc,
                                                  *_t(po[1:2], pv[1:2], lat0[1:2]), device="cpu")
    assert torch.equal(one_lat, b1_lat[0]) and int(one_it) == int(b1_it[0]) == int(got_it[1])
    j_lat, j_it = jlm.shape_opt_deepsdf(small["jp"], small["jspec"], jc, jnp.asarray(po[1]),
                                       jnp.asarray(pv[1]), jnp.asarray(lat0[1]))
    assert int(j_it) == int(one_it)
    np.testing.assert_allclose(one_lat.numpy(), np.asarray(j_lat), atol=2e-4, rtol=0)


def test_deepsdf_baseline_runs_the_sdf_term_through_the_kernel_wrapper(small, monkeypatch):
    """With a kernel-supported decoder the SDF term goes through B1's wrapper
    (its plain version on the CPU) with the finished lanes masked out."""
    from hortimapping_tpu_torch.ops import mlp_kernels

    seen = []
    orig = mlp_kernels.mlp_sdf_and_input_grad

    def spy(pk, x, lane_active=None):
        seen.append(None if lane_active is None else lane_active.clone())
        return orig(pk, x, lane_active)

    monkeypatch.setattr(mlp_kernels, "mlp_sdf_and_input_grad", spy)
    _, tc = _cfgs(**DEEPSDF)
    jobs, _, T0, lat0 = _batch(small, 5, 4)
    po, pv = _object_points(jobs, T0)
    _, it = tlm.shape_opt_deepsdf_batched(small["tp"], small["tspec"], tc, *_t(po, pv, lat0),
                                          device="cpu")
    assert len(seen) == int(it.max()) and all(m is not None for m in seen)
    assert bool(seen[0].all()) and int(seen[-1].sum()) == int((it == it.max()).sum())


@pytest.mark.parametrize("trust_region", [False, True])
def test_pose_known_solve_matches_jax(small, trust_region):
    """`pose_known=True`: rotation and translation frozen, scale and code
    free; the step zeroes the six rigid components before the update."""
    jc, tc = _cfgs(trust_region=trust_region, lm_lambda_0=0.1 if trust_region else 0.5,
                   max_iter=6)
    jobs, tobs, T0, lat0 = _batch(small, 2, 4)
    want = jlm.shape_pose_joint_opt_batched(small["jp"], small["jspec"], jc, jobs,
                                            jnp.asarray(lat0), jnp.asarray(T0), CUBE_RADIUS,
                                            pose_known=True)
    got = tlm.shape_pose_joint_opt_batched(small["tp"], small["tspec"], tc, tobs, *_t(lat0, T0),
                                           CUBE_RADIUS, pose_known=True, device="cpu")
    _assert_same(got, want)
    # the rigid part of the pose never moves: T_ow = s * T0's rotation, T0's
    # translation scaled
    s = torch.linalg.det(got.T_ow[:, :3, :3]) ** (1.0 / 3.0)
    np.testing.assert_allclose((got.T_ow[:, :3, :3] / s[:, None, None]).numpy(), T0[:, :3, :3],
                               atol=1e-5, rtol=0)
    assert float((s - 1).abs().max()) > 1e-4   # the scale did move


# ---------------------------------------------------------------- pipeline

def _check_schedule(jcfg):
    assert (jcfg.init_mode == "mean" and not jcfg.trust_region and not jcfg.coarse_to_fine
            and jcfg.pose_polish_iters == 0), "the probes model the fixed-lambda mean-init solve"


def jax_from_port_first_iterate(cfg_dict, params, spec, jcfg, table, obs, lat0, T0, radius,
                                pose_known):
    """JAX's solve continued from the port's first iterate, which must agree
    with JAX's own first iterate within 1e-6."""
    _check_schedule(jcfg)
    tcfg = dataclasses.replace(tconfig.JointOptConfig.from_dict(cfg_dict), max_iter=1)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    tspec = TSpec(code_length=spec.code_length, dims=tuple(spec.dims),
                  latent_in=tuple(spec.latent_in), clamping_distance=spec.clamping_distance)
    tobs = FruitObservations(*(torch.as_tensor(np.array(a)) for a in obs))
    first_t = tlm.shape_pose_joint_opt_batched(tparams, tspec, tcfg, tobs, *_t(lat0, T0), radius,
                                               pose_known, device="cpu")
    first_j = jlm.shape_pose_joint_opt_batched(params, spec, dataclasses.replace(jcfg, max_iter=1),
                                               obs, lat0, T0, radius, pose_known)
    np.testing.assert_allclose(first_t.latent.numpy(), np.asarray(first_j.latent), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(first_t.T_ow.numpy(), np.asarray(first_j.T_ow), atol=1e-6, rtol=0)
    assert not bool(first_t.failed.any())
    return jlm._continue_joint_opt_batched(params, spec, jcfg, obs,
                                           jnp.asarray(first_t.latent.numpy()),
                                           jnp.asarray(first_t.T_ow.numpy()), radius,
                                           pose_known, 1)


def jax_op_by_op(cfg_dict, params, spec, jcfg, table, obs, lat0, T0, radius, pose_known):
    """JAX's own solve with its LM iteration dispatched op by op instead of
    compiled into one loop: the same arithmetic, rounded as XLA's unfused
    operations round it."""
    _check_schedule(jcfg)
    step = jax.vmap(lambda o, st: jlm.lm_iteration(params, spec, jcfg, o, st, radius, pose_known))
    st = jax.vmap(jinit_state)(lat0, T0)
    while bool(jnp.any(~(st.done | st.failed))):
        st = jax.vmap(jlm._freeze_if_done)(st, step(obs, st))
    return JResult(st.latent, st.T_ow, st.iter_count, st.failed, st.converged)


def jax_one_ulp_up(cfg_dict, params, spec, jcfg, table, obs, lat0, T0, radius, pose_known):
    """JAX's own solve with its start latent (the retrieved one, where the
    schedule retrieves) moved one ulp up."""
    assert jcfg.multi_start <= 1 and jcfg.rescue_starts == 0
    if jcfg.init_mode == "retrieval":
        lat0, T0, _, _ = jws.retrieval_init_batched(
            params, spec, table, obs.points_w, obs.point_valid, top_k=jcfg.retrieval_top_k,
            n_score_pts=jcfg.retrieval_score_pts, n_scales=jcfg.retrieval_n_scales,
            scale_min=jcfg.retrieval_scale_min, scale_max=jcfg.retrieval_scale_max, T_init=T0,
            score_bf16=jcfg.retrieval_score_bf16, prior_w=jcfg.retrieval_prior_w)
    return jlm.solve_in_chunks(params, spec, jcfg, obs, jnp.nextafter(lat0, jnp.inf), T0, radius,
                               pose_known=pose_known)


PROBES = (jax_from_port_first_iterate, jax_op_by_op)


def run_jax_pipeline(run, cfg, monkeypatch, module, probe=None, **kw):
    """The JAX pipeline `run(cfg, **kw)` with its solve captured per lane
    ((latent, T_ow, iter_count, failed) numpy); with `probe` (one of
    PROBES), its solve replaced by that probe's. Its DeepSDF baseline is
    captured too."""
    seen = {}
    solve = jws.warmstart_solve
    baseline = module.shape_opt_deepsdf_batched

    def capture(params, spec, opt_cfg, table, obs, lat0, T0, radius, pose_known=False, **k):
        if probe is None:
            res = solve(params, spec, opt_cfg, table, obs, lat0, T0, radius,
                        pose_known=pose_known, **k)
        else:
            res = probe(cfg, params, spec, opt_cfg, table, obs, lat0, T0, radius, pose_known)
        seen["lanes"] = tuple(np.asarray(a) for a in (res.latent, res.T_ow, res.iter_count,
                                                       res.failed))
        return res

    def capture_baseline(params, spec, opt_cfg, pts, valid, lat0):
        lat, it = baseline(params, spec, opt_cfg, pts, valid, lat0)
        seen["lanes"] = (np.asarray(lat), None, np.asarray(it), np.zeros(lat.shape[0], bool))
        return lat, it

    with monkeypatch.context() as m:
        m.setattr(jws, "warmstart_solve", capture)
        m.setattr(module, "shape_opt_deepsdf_batched", capture_baseline)
        summary = run(cfg, log=QUIET, **kw)
    return summary, seen["lanes"]


def jax_movement(run, cfg, monkeypatch, module, probes=PROBES, **kw):
    """(summary, lanes) of the JAX pipeline's run under each probe."""
    return [run_jax_pipeline(run, cfg, monkeypatch, module, probe=p, **kw) for p in probes]


def run_port_pipeline(run, cfg, monkeypatch, module, **kw):
    seen = {}
    solve, baseline = module.warmstart_solve, module.shape_opt_deepsdf_batched

    def capture(*a, **k):
        res = solve(*a, **k)
        seen["lanes"] = tuple(t.numpy() for t in (res.latent, res.T_ow, res.iter_count,
                                                   res.failed))
        return res

    def capture_baseline(*a, **k):
        lat, it = baseline(*a, **k)
        seen["lanes"] = (lat.numpy(), None, it.numpy(), np.zeros(lat.shape[0], bool))
        return lat, it

    with monkeypatch.context() as m:
        m.setattr(module, "warmstart_solve", capture)
        m.setattr(module, "shape_opt_deepsdf_batched", capture_baseline)
        summary = run(cfg, log=QUIET, device="cpu", **kw)
    return summary, seen["lanes"]


def mesh_gap(path_a, path_b):
    """Mean symmetric nearest-neighbour distance of two meshes' surfaces."""
    pa = read_mesh(path_a).sample_points_uniformly(20000).points
    pb = read_mesh(path_b).sample_points_uniformly(20000).points
    return 0.5 * (cKDTree(pb).query(pa)[0].mean() + cKDTree(pa).query(pb)[0].mean())


def lane_distance(a, b):
    """Per lane, the largest latent or pose entry difference of two runs."""
    d = np.abs(a[0] - b[0]).max(1)
    if a[1] is not None:
        d = np.maximum(d, np.abs(a[1] - b[1]).max((1, 2)))
    return d


PRF = ("F-score[%]", "Precision[%]", "Recall[%]")


def hold_to_jax(got, want, got_lanes, want_lanes, moved=()):
    """The summary and per-lane bounds of the module docstring; `moved`:
    (summary, lanes) of JAX's probe runs. A lane that no probe moves by
    more than 2e-4 is held to JAX's own run. A lane that a probe moves
    further is held, at the same bounds, to the one of JAX's runs (its own
    or a probe's) that lies nearest to the port's in latent and pose; the
    summary's P/R/F1 then to the larger of 0.5 and the largest gap between
    two of JAX's runs. Returns the index of the run each lane was held to
    (0: JAX's own)."""
    np.testing.assert_array_equal(got_lanes[2], want_lanes[2])
    np.testing.assert_array_equal(got_lanes[3], want_lanes[3])
    n = len(want_lanes[2])
    runs = [(want, want_lanes), *moved]
    wide = np.zeros(n, bool)
    for _, m_lanes in moved:
        wide |= lane_distance(m_lanes, want_lanes) > 2e-4
    dist = np.stack([lane_distance(got_lanes, lanes) for _, lanes in runs])
    pick = np.where(wide, dist.argmin(0), 0)
    for b in range(n):
        s, lanes = runs[pick[b]]
        np.testing.assert_allclose(got_lanes[0][b], lanes[0][b], atol=2e-4, rtol=0)
        if lanes[1] is not None:
            np.testing.assert_allclose(got_lanes[1][b], lanes[1][b], atol=2e-4, rtol=0)
        assert abs(got["cd_per_fruit_mm"][b] - s["cd_per_fruit_mm"][b]) <= 0.05, (
            b, pick[b], got["cd_per_fruit_mm"], s["cd_per_fruit_mm"])
    f_tol = 0.5
    if wide.any():
        f_tol = max([f_tol] + [abs(s_a[k] - s_b[k]) for i, (s_a, _) in enumerate(runs)
                               for s_b, _ in runs[i + 1:] for k in PRF])
    for k in PRF:
        assert abs(got[k] - want[k]) <= f_tol, (k, got[k], want[k], f_tol)
    assert got["threshold[mm]"] == want["threshold[mm]"]
    assert sorted(got) == sorted(want)
    return pick


CASES = {
    "mean": {},
    "deepsdf": {"baseline_name": "DeepSDF"},
    "retrieval": {"opt.tpu": {"init_mode": "retrieval", "retrieval_top_k": 3,
                              "retrieval_score_pts": 64}},
    "retrieval_ms2": {"opt.tpu": {"init_mode": "retrieval", "retrieval_top_k": 3,
                                  "retrieval_score_pts": 64, "multi_start": 2}},
}


def _case_cfg(data_dir, case, run_name):
    cfg = _cfg(data_dir)
    cfg["run_name"] = run_name
    for k, v in CASES[case].items():
        if k == "opt.tpu":
            cfg["opt"]["tpu"] = dict(v)
        else:
            cfg[k] = v
    return cfg


@pytest.mark.parametrize("case", list(CASES))
def test_run_challenge_matches_jax(datasets, case, monkeypatch):
    _, jdir, _ = datasets
    want, want_lanes = run_jax_pipeline(jchallenge.run_challenge, _case_cfg(jdir, case, f"j_{case}"),
                                        monkeypatch, jchallenge)
    got, got_lanes = run_port_pipeline(tchallenge.run_challenge,
                                       _case_cfg(jdir, case, f"t_{case}"), monkeypatch, tchallenge)
    assert got["fruits"] == want["fruits"] == 2
    assert got["failed"] == want["failed"] == 0
    assert got["iteration"] == want["iteration"]
    moved = ()
    if case == "mean":
        moved = jax_movement(jchallenge.run_challenge, _case_cfg(jdir, case, f"p_{case}"),
                             monkeypatch, jchallenge)
    hold_to_jax(got, want, got_lanes, want_lanes, moved)
    out_j = os.path.join(jdir, "results", f"j_{case}", "val")
    out_t = os.path.join(jdir, "results", f"t_{case}", "val")
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) == ["fruit_00.ply",
                                                                      "fruit_01.ply"]
    voxel = 2 * 0.08 / (int(2 * 0.08 * 1e3 / 6.0) - 1)
    for fn in os.listdir(out_j):
        gap = mesh_gap(os.path.join(out_j, fn), os.path.join(out_t, fn))
        assert gap <= 0.5 * voxel, (fn, gap, voxel)


def test_cli_runs_on_the_cpu_when_asked(datasets, tmp_path):
    import subprocess
    import sys

    import yaml

    _, jdir, _ = datasets
    cfg_path = str(tmp_path / "challenge.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(_case_cfg(jdir, "deepsdf", "cli"), f)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "hortimapping_tpu_torch.pipeline.challenge",
                          "-c", cfg_path, "--device", "cpu"], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "calculated over 2 fruits"
    assert sorted(os.listdir(os.path.join(jdir, "results", "cli", "val"))) == [
        "fruit_00.ply", "fruit_01.ply"]
    with open(os.path.join(jdir, "val", "fruit_00", "input", "intrinsic.json")) as f:
        assert len(json.load(f)["intrinsic_matrix"]) == 9
