"""The yardstick's frozen copies against the code they were copied from, the
seeded draws, and how a cell is found."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT
from lib import chamfer, scenes, work
from lib.harness import Cell, forbidden_modules, load_module


@pytest.mark.parametrize("seed", [0, 7, 1234567])
def test_scene_generator_matches_the_programs(seed):
    from hortimapping_tpu_torch.models.decoder import DecoderSpec
    from hortimapping_tpu_torch.tools.synthetic import SyntheticCategory, make_scene

    cat = SyntheticCategory(spec=DecoderSpec(), base_radius=0.06, proj_scale=0.2)
    proj = scenes.projection(32, 0.2)
    assert np.array_equal(proj, cat.projection())
    rng = np.random.default_rng(seed)
    code = (rng.normal(size=32) * 0.3).astype(np.float32)
    T_wo = np.eye(4, dtype=np.float32)
    T_wo[:3, 3] = rng.normal(size=3) * 0.1
    want, gt_w = make_scene(cat, code, T_wo, n_frames=4, n_fg=50, n_bg=50, n_points=300, seed=seed)
    got, gt_g = scenes.make_scene(proj, 0.06, code, T_wo, 4, 50, 50, 300, seed=seed)
    assert got._fields == want._fields
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(gt_g, gt_w)


def test_a_seed_gives_the_same_draws_twice():
    sc = {"code_sigma": 0.3, "center_sigma_m": 0.1}
    a, b = scenes.scene_draws(sc, 32, 5, 2**31 + 5), scenes.scene_draws(sc, 32, 5, 2**31 + 5)
    assert all(np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1]) and x[2] == y[2]
               for x, y in zip(a, b))
    assert not np.array_equal(a[0][0], scenes.scene_draws(sc, 32, 5, 2**31 + 6)[0][0])
    pool = [scenes.Scene(None, None, np.eye(4)) for _ in range(8)]
    r1 = scenes.make_requests(pool, 20, 0.003, 3000000019, stream=1)
    r2 = scenes.make_requests(pool, 20, 0.003, 3000000019, stream=1)
    assert [(r.key, r.scene) for r in r1] == [(r.key, r.scene) for r in r2]
    assert all(np.array_equal(x.T_ow0, y.T_ow0) for x, y in zip(r1, r2))
    assert len({r.T_ow0.tobytes() for r in r1}) == 20          # no two requests alike
    drv = load_module(os.path.join(BENCH, "traffic", "serve_open.py"), "t_serve_open")
    a = drv.arrivals(7, 3000000019, 50.0, 100)
    assert np.array_equal(a, drv.arrivals(7, 3000000019, 50.0, 100))
    b = drv.arrivals(7, 3000000020, 50.0, 100)
    assert not np.array_equal(a, b)
    # every seed: the same set of gaps, in its own order
    assert np.allclose(np.sort(np.diff(a, prepend=0.0)), np.sort(np.diff(b, prepend=0.0)))
    drv = load_module(os.path.join(BENCH, "traffic", "batch_closed.py"), "t_batch_closed")
    k1 = drv.batch_requests(pool, 4, 1, 3000000019, 0.003)
    assert [(r.key, r.scene) for r in k1] == [(r.key, r.scene) for r in
                                              drv.batch_requests(pool, 4, 1, 3000000019, 0.003)]
    # every seed runs the pool's same fixed batches
    for seed in (3000000019, 3000000020):
        got = {frozenset(r.scene for r in drv.batch_requests(pool, 4, k, seed, 0.003))
               for k in range(2)}
        assert got == {frozenset(range(4)), frozenset(range(4, 8))}


def test_pool_is_the_same_in_worker_processes():
    sc = {"base_radius": 0.06, "proj_scale": 0.2, "code_sigma": 0.3, "center_sigma_m": 0.1,
          "n_frames": 2, "n_fg": 20, "n_bg": 20, "n_points": 50}
    one = scenes.build_pool(sc, 32, 4, 99, workers=1)
    two = scenes.build_pool(sc, 32, 4, 99, workers=2)
    for a, b in zip(one, two):
        assert all(np.array_equal(x, y) for x, y in zip(a.obs, b.obs)) and np.array_equal(a.gt, b.gt)


@pytest.mark.parametrize("bf16", [False, True])
def test_chain_arithmetic_matches_chip_smoke(bf16):
    sys.path.insert(0, ROOT)
    import chip_smoke
    from hortimapping_tpu_torch.models.decoder import DecoderSpec, init_decoder_params
    from hortimapping_tpu_torch.ops.mlp_kernels import pack_params

    spec = DecoderSpec()
    params = init_decoder_params(spec, torch.Generator().manual_seed(0), device="cpu")
    pk = pack_params(params, spec, torch.bfloat16 if bf16 else torch.float32)
    sizes = work.decoder_sizes({"dims": [512] * 8, "code_length": 32})
    assert work.chain_macs(*sizes) == chip_smoke.chain_macs(pk)
    assert work.weight_bytes(*sizes, "bf16" if bf16 else "f32") == chip_smoke.weight_bytes(pk)
    assert work.bound(1e9, 3e12, work.PEAK_FLOPS["bf16"]) == chip_smoke.bound(1e9, 3e12, 989e12)


def test_chamfer_on_hand_made_clouds():
    gt = torch.tensor([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    pred = torch.tensor([[0.0, 0.0, 0.5]])
    want = ((0.5 + np.sqrt(1.25)) / 2 + 0.5) / 2
    assert chamfer.chamfer_distance(gt, pred) == pytest.approx(want, rel=1e-6)
    assert chamfer.chamfer_distance(gt, pred[:0]) == 0.0
    from hortimapping_tpu_torch.metrics.chamfer import chamfer_distance

    g = torch.Generator().manual_seed(3)
    a, b = torch.rand(500, 3, generator=g) + 0.6, torch.rand(300, 3, generator=g) + 0.6
    assert chamfer.chamfer_distance(a, b) == chamfer_distance(a, b)


def test_surface_sampler_matches_the_programs():
    from hortimapping_tpu_torch.data.mesh import TriangleMesh

    v = np.array([[0, 0, 0], [1, 0, 0], [1, 2, 0], [0, 2, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    got = chamfer.sample_surface(v, f, 1000, torch.Generator().manual_seed(1), "cpu")
    want = TriangleMesh(v, f).sample_points_on_device(1000, torch.Generator().manual_seed(1), "cpu")
    assert torch.equal(got, want)
    assert float(got[:, 2].abs().max()) == 0.0 and float(got[:, 1].max()) <= 2.0


def test_jax_is_told_apart_by_its_whole_top_level_name():
    fake = ("hortimapping_tpu_torchlike", "jaxy", "flaxen")
    for name in fake:
        sys.modules[name] = type(sys)(name)
    try:
        assert not set(fake) & set(forbidden_modules())
        sys.modules["hortimapping_tpu.ops"] = type(sys)("hortimapping_tpu.ops")
        assert "hortimapping_tpu" in forbidden_modules()
    finally:
        for name in fake + ("hortimapping_tpu.ops",):
            sys.modules.pop(name, None)
    # what a run imports, in a process of its own, loads no JAX module
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from lib import harness, check, control, program, record, reference, scenes, trace, work\n"
            "from hortimapping_tpu_torch import serve\n"
            "from hortimapping_tpu_torch.optim import lm, warmstart\n"
            "from hortimapping_tpu_torch.ops import mesher, render_kernel\n"
            "from hortimapping_tpu_torch.models import workspace\n"
            "print(harness.forbidden_modules())" % (BENCH, ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out


def test_a_new_cell_is_one_file(tmp_path):
    """A cell that reuses a driver is one JSON file (and its entry in
    BENCHMARK.json): found by name, no code edited."""
    bench = tmp_path / "benchmark"
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(os.path.join(BENCH, d), bench / d)
    (bench / "workloads").mkdir()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        doc = json.load(f)
    name = "sweetpepper_bup20.trial"
    doc["workloads"].append({"name": name, "config": "sweetpepper_bup20", "traffic": "trial",
                             "chips": 1, "why": "a trial"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    (bench / "workloads" / (name + ".json")).write_text(json.dumps(
        {"config": "sweetpepper_bup20", "driver": "serve_closed",
         "params": {"in_flight": 8, "max_fruits_per_s": 10, "pool": 4, "pose_offset_sigma_m": 0.003},
         "check": {}}))
    cell = Cell(str(tmp_path), name, bench_dir=str(bench))
    assert cell.config["name"] == "sweetpepper_bup20"
    assert callable(cell.driver.window) and cell.driver.__file__.endswith("serve_closed.py")
    assert [m["name"] for m in cell.metrics(False)] == ["setup_s", "cd_mm"]
    with pytest.raises(KeyError):
        Cell(str(tmp_path), "no.such_cell", bench_dir=str(bench))
