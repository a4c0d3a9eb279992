"""The port's lab slice against the JAX package on the CPU: the lab
generator, `run_lab_eval` multi- and single-frame on the JAX lab test's
fixture (`tests/test_pipeline_lab.py`: synthetic_small_8, 2 fruits, 5
frames, written once by the JAX generator), its DeepSDF baseline, and the
berry decoder (`assets/synthetic_berry_32`, `configs/lab_berry.yaml`'s
80^3 grid), which no other port test loads.

Tolerances. Generator: split, intrinsics, poses, crop boxes and GT clouds
equal; masks equal on >= 99.9 % of pixels; depth (stored in mm) within
1e-5 m where both frames hit; the integrated maps (fused from the depth)
of equal size and within 1e-5 m. Pipelines: the bounds of
`tests/test_torch_challenge.py` (instance lists, iteration counts equal,
meshes within half a voxel, per-instance Chamfer within 0.05 mm, P/R/F1 at
5 mm within 0.5 points, latents and poses within 2e-4), where a lane that
a probe of JAX's own solve moves by more than 2e-4 is held to the nearest
of JAX's runs, as there. Berry: SDF within 1e-5 and its input
gradient within 1e-4 of its largest entry (f32 sums of 512 products in
another order); the f16 80^3 grid within one f16 ulp of JAX's.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from hortimapping_tpu.models.decoder import decoder_sdf_and_input_grad as jsdf_grad
from hortimapping_tpu.models.workspace import config_decoder as jconfig_decoder
from hortimapping_tpu.models.workspace import load_latent_vectors as jload_latents
from hortimapping_tpu.ops.mesher import MeshExtractor as JMesher
from hortimapping_tpu.pipeline import lab as jlab
from hortimapping_tpu.tools import make_demo_data as jgen
from hortimapping_tpu_torch.data.challenge import read_mask
from hortimapping_tpu_torch.data.ply import read_point_cloud
from hortimapping_tpu_torch.models.decoder import decoder_sdf_and_input_grad
from hortimapping_tpu_torch.models.workspace import config_decoder, load_latent_vectors
from hortimapping_tpu_torch.ops import mlp_kernels
from hortimapping_tpu_torch.ops.mesher import MeshExtractor
from hortimapping_tpu_torch.pipeline import lab as tlab
from hortimapping_tpu_torch.tools import make_demo_data as tgen
from test_pipeline_lab import ASSET_DIR, _cfg
from test_torch_challenge import (
    hold_to_jax,
    jax_movement,
    jax_one_ulp_up,
    run_jax_pipeline,
    run_port_pipeline,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BERRY = os.path.join(ROOT, "assets", "synthetic_berry_32")
with open(os.path.join(ROOT, "configs", "lab_pepper_tpu.yaml")) as _f:
    TPU_BLOCK = yaml.safe_load(_f)["opt"]["tpu"]

pytestmark = pytest.mark.skipif(not os.path.isdir(ASSET_DIR), reason="synthetic assets not built")


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("lab_torch")
    jdir, tdir = str(root / "jax"), str(root / "torch")
    jgen.make_lab_dataset(jdir, ASSET_DIR, n_fruits=2, n_frames=5)
    tgen.make_lab_dataset(tdir, ASSET_DIR, n_fruits=2, n_frames=5, device="cpu")
    return root, jdir, tdir


def test_generator_matches_jax(datasets):
    _, jdir, tdir = datasets
    for fn in ("split.json",):
        with open(os.path.join(jdir, fn)) as fa, open(os.path.join(tdir, fn)) as fb:
            assert json.load(fa) == json.load(fb) == {"train": [], "test": ["fruit_00",
                                                                             "fruit_01"]}
    for fid in ("fruit_00", "fruit_01"):
        ja, ta = os.path.join(jdir, fid), os.path.join(tdir, fid)
        with open(os.path.join(ja, "realsense", "intrinsic.json")) as fa, \
                open(os.path.join(ta, "realsense", "intrinsic.json")) as fb:
            assert fa.read() == fb.read()
        for fn in ("tf_allposes.npz", "bounding_box.npz"):
            with np.load(os.path.join(ja, "tf", fn)) as a, np.load(os.path.join(ta, "tf", fn)) as b:
                np.testing.assert_array_equal(a["arr_0"], b["arr_0"])
        np.testing.assert_array_equal(read_point_cloud(os.path.join(ja, "laser", "fruit.ply")).points,
                                      read_point_cloud(os.path.join(ta, "laser", "fruit.ply")).points)
        frames = sorted(os.listdir(os.path.join(ja, "realsense", "masks")))
        assert frames == sorted(os.listdir(os.path.join(ta, "realsense", "masks"))) == [
            f"{i:05d}.png" for i in range(1, 6)]
        for fn in frames:
            ma = read_mask(os.path.join(ja, "realsense", "masks", fn))
            mb = read_mask(os.path.join(ta, "realsense", "masks", fn))
            assert set(np.unique(ma)) == {0, 255} and (ma == mb).mean() >= 0.999
            da = np.load(os.path.join(ja, "realsense", "depth", fn.replace("png", "npy")))
            db = np.load(os.path.join(ta, "realsense", "depth", fn.replace("png", "npy")))
            both = (da > 0) & (db > 0)
            assert np.abs(da[both] - db[both]).max() <= 1e-5 * 1000.0
        pa = read_point_cloud(os.path.join(ja, "realsense", "scene", "integrated.ply")).points
        pb = read_point_cloud(os.path.join(ta, "realsense", "scene", "integrated.ply")).points
        assert pa.shape == pb.shape and pa.shape[0] > 1000
        np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-5)


@pytest.mark.parametrize("multi_frame,baseline", [(True, "none"), (False, "none"),
                                                  (True, "DeepSDF")])
def test_run_lab_eval_matches_jax(datasets, monkeypatch, multi_frame, baseline):
    _, jdir, _ = datasets
    cfg = _cfg(jdir)
    cfg["baseline_name"] = baseline
    want, want_lanes = run_jax_pipeline(jlab.run_lab_eval, cfg, monkeypatch, jlab,
                                        multi_frame=multi_frame)
    got, got_lanes = run_port_pipeline(tlab.run_lab_eval, cfg, monkeypatch, tlab,
                                       multi_frame=multi_frame)
    assert got["frames"] == want["frames"] >= 2
    assert got["iteration"] == want["iteration"]
    moved = ()
    if baseline == "none":
        moved = jax_movement(jlab.run_lab_eval, cfg, monkeypatch, jlab, multi_frame=multi_frame)
    hold_to_jax(got, want, got_lanes, want_lanes, moved)


@pytest.mark.parametrize("multi_frame", [True, False])
def test_run_lab_eval_on_the_tpu_block_matches_jax(datasets, monkeypatch, multi_frame):
    """`configs/lab_pepper_tpu.yaml`'s opt.tpu block (retrieval warm start
    at unit scale). Multi-frame is held to the flat bounds. Single-frame
    runs its 10 iterations unconverged, and one lane crosses a render-band
    edge at iteration 8 (the port agrees with JAX within 3e-6 up to
    there): JAX alone moves that lane by ~5e-3 when its start latent moves
    one ulp, so single-frame is held with that probe."""
    _, jdir, _ = datasets
    cfg = _cfg(jdir)
    cfg["opt"]["tpu"] = dict(TPU_BLOCK)
    want, want_lanes = run_jax_pipeline(jlab.run_lab_eval, cfg, monkeypatch, jlab,
                                        multi_frame=multi_frame)
    got, got_lanes = run_port_pipeline(tlab.run_lab_eval, cfg, monkeypatch, tlab,
                                       multi_frame=multi_frame)
    assert got["frames"] == want["frames"] >= 2
    assert got["iteration"] == want["iteration"]
    moved = ()
    if not multi_frame:
        moved = jax_movement(jlab.run_lab_eval, cfg, monkeypatch, jlab, probes=(jax_one_ulp_up,),
                             multi_frame=multi_frame)
    pick = hold_to_jax(got, want, got_lanes, want_lanes, moved)
    assert multi_frame or np.count_nonzero(pick) <= 1


def test_prepared_instances_match_jax(datasets):
    """The prepared instances (labels, pose inits, GT, observation buffers)
    are the JAX package's bit for bit, in both modes."""
    from hortimapping_tpu.config import JointOptConfig as JCfg
    from hortimapping_tpu.utils.misc import set_random_seed as jseed
    from hortimapping_tpu_torch.config import JointOptConfig as TCfg
    from hortimapping_tpu_torch.utils.misc import set_random_seed as tseed

    _, jdir, _ = datasets
    cfg = _cfg(jdir)
    for multi in (True, False):
        jseed(42)
        want = jlab.prepare_lab_instances(cfg, JCfg.from_dict(cfg), multi)
        tseed(42)
        got = tlab.prepare_lab_instances(cfg, TCfg.from_dict(cfg), multi)
        assert [p["label"] for p in got] == [p["label"] for p in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a["center"], b["center"])
            np.testing.assert_array_equal(tlab.lab_T_ow0(a["center"]), jlab.lab_T_ow0(b["center"]))
            np.testing.assert_array_equal(a["gt_points"], b["gt_points"])
            assert a["gt_count"] == b["gt_count"]
            for x, y in zip(a["obs"], b["obs"]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_cli_needs_a_mode_and_runs_on_the_cpu(datasets, tmp_path):
    import subprocess
    import sys

    import yaml

    _, jdir, _ = datasets
    cfg_path = str(tmp_path / "lab.yaml")
    cfg = _cfg(jdir)
    cfg["baseline_name"] = "DeepSDF"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    cmd = [sys.executable, "-m", "hortimapping_tpu_torch.pipeline.lab", "-c", cfg_path]
    out = subprocess.run(cmd + ["--single_frame", "--device", "cpu"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1].startswith("calculated over ")
    out = subprocess.run(cmd + ["--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and "--multi_frame" in out.stderr


# ---------------------------------------------------------------- berry

@pytest.fixture(scope="module")
def berry():
    jp, jspec = jconfig_decoder(BERRY, "latest")
    params, spec = config_decoder(BERRY, device="cpu")
    return jp, jspec, params, spec, load_latent_vectors(BERRY, device="cpu"), jload_latents(BERRY, "latest")


def test_berry_decoder_loads_and_matches_jax(berry):
    jp, jspec, params, spec, table, jtable = berry
    assert spec.code_length == 32 and spec.dims == (512,) * 8 and spec.latent_in == (4,)
    assert spec.clamping_distance == jspec.clamping_distance == 0.05
    assert mlp_kernels.supported(spec)
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable))
    rng = np.random.default_rng(0)
    codes = table.numpy()[rng.integers(0, table.shape[0], 256)]
    x = np.concatenate([codes, rng.normal(size=(256, 3)).astype(np.float32) * 0.03], 1)
    s_j, g_j = jsdf_grad(jp, jspec, jnp.asarray(x))
    s_t, g_t = decoder_sdf_and_input_grad(params, spec, torch.as_tensor(x))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5, rtol=0)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(g_t.numpy(), g_j, atol=1e-4 * np.abs(g_j).max(), rtol=0)
    # B1's plain version (what the card's kernel is held to) on the same rows
    pk = mlp_kernels.pack_params(params, spec, torch.float32)
    s_k, g_k = mlp_kernels.mlp_sdf_and_input_grad(pk, torch.as_tensor(x))
    np.testing.assert_allclose(s_k.numpy(), np.asarray(s_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(g_k.numpy(), g_j, atol=1e-4 * np.abs(g_j).max(), rtol=0)


def test_berry_80_grid_matches_jax(berry):
    """`configs/lab_berry.yaml`: radius 0.04 m at 1 mm, an 80^3 grid."""
    jp, jspec, params, spec, table, jtable = berry
    from hortimapping_tpu_torch.config import load_config

    vis = load_config(os.path.join(ROOT, "configs", "lab_berry.yaml"))["vis"]
    d = int(2 * vis["object_radius_max_m"] * 1e3 / vis["mc_res_mm"])
    assert d == 80
    mesher = MeshExtractor(params, spec, d, vis["object_radius_max_m"], device="cpu")
    jmesher = JMesher(jp, jspec, d, vis["object_radius_max_m"])
    got = mesher.decode_sdf_grid(table.mean(0))
    want = jmesher.decode_sdf_grid(jnp.mean(jtable, 0))
    assert got.shape == want.shape == (80, 80, 80) and got.dtype == want.dtype == np.float16
    assert 0.01 < float((want < 0).mean()) < 0.5
    diff = np.abs(got.astype(np.float32) - want.astype(np.float32))
    assert np.all(diff <= np.spacing(np.abs(want)).astype(np.float32)), diff.max()
    mesh = mesher._grid_to_mesh(got)
    jmesh = jmesher._grid_to_mesh(want)
    assert abs(len(mesh.vertices) - len(jmesh.vertices)) <= 0.001 * len(jmesh.vertices)

