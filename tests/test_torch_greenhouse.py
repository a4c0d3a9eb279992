"""The port's greenhouse (CKA) slice against the JAX package on the CPU: the
greenhouse generator, `prepare_greenhouse_instances` in its three modes,
`run_greenhouse_eval` multi-frame, single-frame and under the DeepSDF
baseline, the pose metric, the result dirs and the CLI, on the JAX
greenhouse test's fixture (`tests/test_pipeline_greenhouse.py`:
synthetic_small_8, 2 fruits, 6 frames of 160x120, written once by each
package's generator; both pipelines read the JAX package's set).

Tolerances.
* Generator: file lists, intrinsics, info files, every `.npz` and the PLYs
  equal; submap-id and colour images equal on >= 99.9 % of pixels; depth
  (stored in mm) within 1e-5 m where both frames hit (the bounds of
  `tests/test_torch_lab.py`'s generator test: the port marches in torch,
  the JAX package in numpy).
* Prepared instances: equal bit for bit (labels, render data, observation
  buffers, surface points, pose inits, GT poses and GT points).
* Pipelines: the bounds of `tests/test_torch_challenge.py` (iteration
  counts and flags equal, latents and poses within 2e-4, per-instance
  Chamfer within 0.05 mm, P/R/F1 at 5 mm within 0.5 points, the written
  meshes within half a voxel), where a lane that a probe of JAX's own solve
  moves by more than 2e-4 is held to the nearest of JAX's runs, as there.
  This fixture's schedule is chaotic on some lanes, so its probe is
  `jax_steps_along_port`: every iteration of the port's solve is held to
  JAX's iteration from the same state within 1e-5.
  The pose metric follows from the 2e-4 pose bound: a T_ow entry off by
  2e-4 moves the de-scaled T_wo's translation (0.6 m from the origin) by
  at most ~0.5 mm and its z-axis by ~0.02 deg, so each lane's translation
  error is held within 0.5 mm and its z-axis angle within 0.05 deg of the
  run it is held to, and their means (the summary) within the same bounds.
* The pose metric alone (`pose_errors`), on the same f32 poses: equal to
  JAX's numpy arithmetic bit for bit.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hortimapping_tpu.config import JointOptConfig as JCfg
from hortimapping_tpu.data.preprocess import get_deg_between_vectors as jdeg
from hortimapping_tpu.pipeline import greenhouse as jgh
from hortimapping_tpu.tools import make_demo_data as jgen
from hortimapping_tpu.utils.misc import set_random_seed as jseed
from hortimapping_tpu_torch.config import JointOptConfig as TCfg
from hortimapping_tpu_torch.data import imageio
from hortimapping_tpu_torch.data.mesh import PointCloud
from hortimapping_tpu_torch.data.ply import read_mesh, read_point_cloud, write_point_cloud
from hortimapping_tpu_torch.pipeline import greenhouse as tgh
from hortimapping_tpu_torch.tools import make_demo_data as tgen
from hortimapping_tpu_torch.utils.misc import set_random_seed as tseed
from test_pipeline_greenhouse import ASSET_DIR, _cfg
from test_torch_challenge import (
    _check_schedule,
    hold_to_jax,
    jax_movement,
    mesh_gap,
    run_jax_pipeline,
    run_port_pipeline,
)
from hortimapping_tpu.optim import lm as jlm
from hortimapping_tpu.optim.state import OptResult as JResult
from hortimapping_tpu.optim.state import OptState as JState
from hortimapping_tpu_torch import config as tconfig
from hortimapping_tpu_torch.models.decoder import DecoderSpec as TSpec
from hortimapping_tpu_torch.models.workspace import params_from_jax
from hortimapping_tpu_torch.optim import lm as tlm
from hortimapping_tpu_torch.optim.state import FruitObservations
from hortimapping_tpu_torch.optim.state import init_state as tinit_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRUITS = ("fruit_00", "fruit_01")
POSE_TOL = dict(trans_mm=0.5, rot_deg=0.05)

pytestmark = pytest.mark.skipif(not os.path.isdir(ASSET_DIR), reason="synthetic assets not built")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("greenhouse_torch")
    jdir, tdir = str(root / "jax"), str(root / "torch")
    jgen.make_greenhouse_dataset(jdir, ASSET_DIR, n_fruits=2, n_frames=6)
    tgen.make_greenhouse_dataset(tdir, ASSET_DIR, n_fruits=2, n_frames=6, device="cpu")
    return root, jdir, tdir


def jax_steps_along_port(cfg_dict, params, spec, jcfg, table, obs, lat0, T0, radius,
                         pose_known):
    """A probe: JAX's iteration (compiled alone) applied to every iterate of
    the port's solve, which starts from the port's own mean of the table
    (the two packages' means differ by an ulp in some entries). From each
    port iterate, JAX's next iterate must agree with the port's next one
    within 1e-5 in latent and pose (one iteration's f32 sums in another
    order; measured <= 2.5e-6), with equal iteration counts and flags. The
    run's result is JAX's last step. This fixture's schedule (10
    unconverged fixed-lambda iterations) is chaotic: a one-ulp change of
    JAX's start moves its own single-frame result by up to 3.5e-2, JAX's
    compiled loop and its stepped one end 8e-2 apart on one lane, and the
    ~1e-6 by which the packages' iterations differ grows to 1e-3 - 8e-2 on
    some lanes, in multi- and single-frame mode alike. Such a lane is held
    to this run: every step of the port is JAX's."""
    _check_schedule(jcfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    tspec = TSpec(code_length=spec.code_length, dims=tuple(spec.dims),
                  latent_in=tuple(spec.latent_in), clamping_distance=spec.clamping_distance)
    tcfg = tconfig.JointOptConfig.from_dict(cfg_dict)
    tobs = FruitObservations(*(torch.as_tensor(np.array(a)) for a in obs))
    step = jax.jit(jax.vmap(lambda o, st: jlm.lm_iteration(params, spec, jcfg, o, st, radius,
                                                           pose_known)))
    ts = tinit_state(torch.as_tensor(np.array(table)).mean(0).expand(lat0.shape[0], -1),
                     torch.as_tensor(np.array(T0)))
    while bool((~(ts.done | ts.failed)).any()):
        cur = JState(*(jnp.asarray(a.numpy()) for a in ts))
        js = jax.vmap(jlm._freeze_if_done)(cur, step(obs, cur))
        ts = tlm._freeze_if_done(ts, tlm.lm_iteration(tparams, tspec, tcfg, tobs, ts, radius,
                                                       pose_known))
        for f in ("i", "iter_count", "done", "failed", "converged"):
            np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)))
        np.testing.assert_allclose(ts.latent.numpy(), np.asarray(js.latent), atol=1e-5, rtol=0)
        np.testing.assert_allclose(ts.T_ow.numpy(), np.asarray(js.T_ow), atol=1e-5, rtol=0)
    return JResult(js.latent, js.T_ow, js.iter_count, js.failed, js.converged)


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, fn), root)
                  for dp, _, fns in os.walk(root) for fn in fns)


def test_generator_matches_jax(datasets):
    _, jdir, tdir = datasets
    files = _files(jdir)
    assert files == _files(tdir)
    # intrinsics, 3 pose files, 6 frames x 3 images, 3 submaps, 2 info files, 4 a fruit
    assert len(files) == 1 + 3 + 6 * 3 + 3 + 2 + 2 * 4
    for rel in files:
        a, b = os.path.join(jdir, rel), os.path.join(tdir, rel)
        if rel.endswith(".json"):
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), rel
        elif rel.endswith(".npz"):
            with np.load(a) as za, np.load(b) as zb:
                np.testing.assert_array_equal(za["arr_0"], zb["arr_0"], err_msg=rel)
        elif rel.endswith(".ply"):
            if "submaps" in rel:
                ma, mb = read_mesh(a), read_mesh(b)
                np.testing.assert_array_equal(ma.vertices, mb.vertices, err_msg=rel)
                np.testing.assert_array_equal(ma.faces, mb.faces, err_msg=rel)
            else:
                np.testing.assert_array_equal(read_point_cloud(a).points,
                                              read_point_cloud(b).points, err_msg=rel)
        elif rel.endswith(".png"):
            ia, ib = imageio.imread(a), imageio.imread(b)
            assert ia.shape == ib.shape and ia.dtype == ib.dtype == np.uint8, rel
            same = (ia == ib).all(-1) if ia.ndim == 3 else ia == ib
            assert same.mean() >= 0.999, rel
            if "submap_ids" in rel:
                assert set(np.unique(ia)) <= {0, 2, 3} and (ia > 0).any(), rel
        else:
            assert rel.endswith(".npy"), rel
            da, db = np.load(a), np.load(b)
            both = (da > 0) & (db > 0)
            assert both.mean() > 0.5 and np.abs(da[both] - db[both]).max() <= 1e-5 * 1000.0


def _write_reconstructions(data_dir):
    """The `use_homa: false` input, which the generator does not write: per
    fruit a photogrammetry-like cloud in the metashape frame (the GT laser
    cloud's half towards the cameras, thinned, plus a stray cluster outside
    the crop box)."""
    rng = np.random.default_rng(3)
    for fid in FRUITS:
        fdir = os.path.join(data_dir, "fruits_measured", fid)
        with np.load(os.path.join(fdir, "tf", "tf.npz")) as z:
            T_mg = z["arr_0"]
        pts_g = read_point_cloud(os.path.join(fdir, "laser", "fruit_clean.ply")).points
        pts_g = pts_g[pts_g[:, 2] < 0.01]
        stray = rng.normal(size=(200, 3)) * 0.005 + np.array([0.2, 0.0, 0.0])
        pts = np.concatenate([pts_g, stray]) @ T_mg[:3, :3].T + T_mg[:3, 3]
        write_point_cloud(os.path.join(fdir, "reconstruction.ply"),
                          PointCloud(pts.astype(np.float32)))


MODES = {"multi": (True, True), "multi_recon": (True, False), "single": (False, True)}


@pytest.mark.parametrize("mode", list(MODES))
def test_prepared_instances_match_jax(datasets, mode):
    """Every prepared instance is the JAX package's bit for bit, the host
    draws (the local generator's and numpy's global one) in its order."""
    root, jdir, _ = datasets
    multi, homa = MODES[mode]
    if not homa:
        data = str(root / "recon")
        if not os.path.isdir(data):
            shutil.copytree(jdir, data)
            _write_reconstructions(data)
    else:
        data = jdir
    cfg = dict(_cfg(data), use_homa=homa, run_name=f"prep_{mode}")
    jseed(42)
    want = jgh.prepare_greenhouse_instances(cfg, JCfg.from_dict(cfg), multi)
    tseed(42)
    got = tgh.prepare_greenhouse_instances(cfg, TCfg.from_dict(cfg), multi)
    assert [p["label"] for p in got] == [p["label"] for p in want]
    assert len(got) == (2 if multi else 8)
    for a, b in zip(got, want):
        for k in ("points_w", "T_ow0", "T_wg", "gt_points_w"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a["gt_count"] == b["gt_count"] and a["result_dir"] == b["result_dir"]
        assert a["rd"]["frame_id"] == b["rd"]["frame_id"] and a["rd"]["count"] == b["rd"]["count"]
        for k in ("rays_fg", "rays_bg", "depth_fg", "depth_bg", "pix_fg", "pix_bg", "T_wc"):
            for x, y in zip(a["rd"][k], b["rd"][k]):
                np.testing.assert_array_equal(x, y, err_msg=k)
        for x, y in zip(a["obs"], b["obs"]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_pose_errors_match_jax():
    """The port's pose metric is the JAX pipeline's numpy arithmetic on the
    same f32 poses: translation error and z-axis angle bit for bit."""
    rng = np.random.default_rng(0)
    for _ in range(20):
        q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        q *= np.sign(np.linalg.det(q))
        T_wo = np.eye(4)
        T_wo[:3, :3] = q * rng.uniform(0.5, 1.5)
        T_wo[:3, 3] = rng.normal(size=3) * 0.3
        T_ow = np.linalg.inv(T_wo).astype(np.float32)
        T_wg = np.eye(4)
        T_wg[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        T_wg[:3, 3] = T_wo[:3, 3] + rng.normal(size=3) * 0.01
        # the JAX pipeline's lines (hortimapping_tpu/pipeline/greenhouse.py)
        T_j = np.linalg.inv(T_ow)
        s = np.linalg.det(T_j[:3, :3]) ** (1.0 / 3.0)
        T_j = T_j.copy()
        T_j[:3, :3] /= s
        tran_j = np.linalg.norm(T_wg[:3, 3] - T_j[:3, 3]) * 1e3
        rot_j = jdeg(T_j[:3, 2], T_wg[:3, 2])
        tran, rot, T_d = tgh.pose_errors(T_ow, T_wg)
        assert tran == tran_j and rot == rot_j
        np.testing.assert_array_equal(T_d, T_j)


CASES = {"multi": (True, "none"), "single": (False, "none"), "deepsdf": (True, "DeepSDF")}


@pytest.mark.parametrize("case", list(CASES))
def test_run_greenhouse_eval_matches_jax(datasets, monkeypatch, case):
    _, jdir, _ = datasets
    multi, baseline = CASES[case]
    cfg_j = dict(_cfg(jdir), baseline_name=baseline, run_name=f"j_{case}")
    cfg_t = dict(cfg_j, run_name=f"t_{case}")
    want, want_lanes = run_jax_pipeline(jgh.run_greenhouse_eval, cfg_j, monkeypatch, jgh,
                                        multi_frame=multi)
    got, got_lanes = run_port_pipeline(tgh.run_greenhouse_eval, cfg_t, monkeypatch, tgh,
                                       multi_frame=multi)
    assert got["frames"] == want["frames"] == (2 if multi else 8)
    assert got["iteration"] == want["iteration"]
    moved = ()
    if baseline == "none":
        moved = jax_movement(jgh.run_greenhouse_eval, dict(cfg_j, run_name=f"p_{case}"),
                             monkeypatch, jgh, probes=(jax_steps_along_port,),
                             multi_frame=multi)
    pick = hold_to_jax(got, want, got_lanes, want_lanes, moved)
    # the pose metric of each lane against the run it is held to
    runs = [want, *(s for s, _ in moved)]
    for b, k in enumerate(pick):
        s = runs[k]
        assert abs(got["tran_err_per_fruit_mm"][b] - s["tran_err_per_fruit_mm"][b]) <= \
            POSE_TOL["trans_mm"], (b, k, got["tran_err_per_fruit_mm"], s["tran_err_per_fruit_mm"])
        assert abs(got["rot_err_per_fruit_deg"][b] - s["rot_err_per_fruit_deg"][b]) <= \
            POSE_TOL["rot_deg"], (b, k, got["rot_err_per_fruit_deg"], s["rot_err_per_fruit_deg"])
    if not pick.any():
        assert abs(got["Error_trans[mm]"] - want["Error_trans[mm]"]) <= POSE_TOL["trans_mm"]
        assert abs(got["Error_rot[deg]"] - want["Error_rot[deg]"]) <= POSE_TOL["rot_deg"]
    # the four files of each fruit's result dir; the completed mesh within
    # half a voxel of the one of the run its lane is held to (single-frame:
    # the fruit's last sampled frame, the last of its lanes)
    voxel = 2 * 0.075 / (int(2 * 0.075 * 1e3 / 6.0) - 1)
    names = [f"result_{n}_{case}" for n in ("j", "p")]
    for f, fid in enumerate(FRUITS):
        lane = (f + 1) * len(pick) // len(FRUITS) - 1
        base = os.path.join(jdir, "fruits_measured", fid)
        out_j, out_t = os.path.join(base, names[pick[lane]]), os.path.join(base, f"result_t_{case}")
        assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j)) == [
            "complete_mesh.ply", "estimated_pose.ply", "gt_pcd.ply", "gt_pose.ply"]
        np.testing.assert_array_equal(read_point_cloud(os.path.join(out_t, "gt_pcd.ply")).points,
                                      read_point_cloud(os.path.join(out_j, "gt_pcd.ply")).points)
        np.testing.assert_allclose(read_mesh(os.path.join(out_t, "gt_pose.ply")).vertices,
                                   read_mesh(os.path.join(out_j, "gt_pose.ply")).vertices,
                                   rtol=0, atol=1e-7)
        gap = mesh_gap(os.path.join(out_j, "complete_mesh.ply"),
                       os.path.join(out_t, "complete_mesh.ply"))
        assert gap <= 0.5 * voxel, (fid, gap, voxel)


def test_cli_needs_a_mode_and_runs_on_the_cpu(datasets, tmp_path):
    import yaml

    _, jdir, _ = datasets
    cfg_path = str(tmp_path / "greenhouse.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(dict(_cfg(jdir), baseline_name="DeepSDF", run_name="cli"), f)
    cmd = [sys.executable, "-m", "hortimapping_tpu_torch.pipeline.greenhouse", "-c", cfg_path]
    out = subprocess.run(cmd + ["--single", "--device", "cpu"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "calculated over 8 frames"
    assert os.path.isfile(os.path.join(jdir, "fruits_measured", "fruit_00", "result_cli",
                                       "estimated_pose.ply"))
    out = subprocess.run(cmd + ["--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and "--multi" in out.stderr
