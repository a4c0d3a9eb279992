"""The strawberry cell (`strawberry_lab.batch32`) on the CPU: a sound run is
correct, and the control and a timed path broken underneath are not; the
readers of host meshing read nothing from a program that records no
`mesh.readback`. Each run is the whole cell at a size a test run holds: 4
frames of 64 + 64 rays at the berry's 15 samples, 96 surface points, 264
codes, 4 LM iterations, a 16^3 grid, batches of 4, in f32 throughout (so
the control computes in bf16)."""

import os
import time

import pytest
import torch

from conftest import BENCH, ROOT
from lib.harness import load_module, run_cell
from test_bench_check import F32, batch_answer_altered, lowered, state_unchanged
from test_bench_program_trace import ctx_of

CELL = "strawberry_lab.batch32"
TINY = {"config": {"solver": {"n_frame": 4, "n_fg_pix": 64, "n_bg_pix": 64, "recon_n_pts": 96,
                              "retrieval_score_pts": 16, "max_iter": 4, "fused_bf16": False,
                              "retrieval_score_bf16": False},
                   "latent_table": {"codes": 264}, "precision": F32,
                   "meshing": {"voxels": 16, "grid_bf16": False}},
        "workload": {"params": {"pool": 8, "batch": 4}, "pool_workers": 1,
                     "check": {"cd_samples": 2000, "steps": 64, "residual_steps": 8,
                               "final_steps": 8, "meshes": 4, "retrieval_fruits": 4,
                               "grid_batches": 2}}}


def run(before=None, seconds=2.0, seed=3000000011):
    res, _, _ = run_cell(ROOT, CELL, seed, seconds, False, require_cuda=False, overrides=TINY,
                         before=before)
    return res


def test_a_sound_berry_run_is_correct():
    res = run()
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0


def test_the_berry_control_is_not_correct():
    res = run(lowered)
    failing = [k for k, v in res["check"].items() if not v["value"] <= v["limit"]]
    assert failing and not res["correct"], res["check"]


@pytest.mark.parametrize("before", [
    pytest.param(state_unchanged(slice(None)), id="state_unchanged"),
    pytest.param(state_unchanged(slice(3, 4)), id="one_lane"),
    pytest.param(batch_answer_altered, id="batch_answer_altered"),
])
def test_a_broken_berry_path_is_not_correct(before):
    res = run(before)
    assert not res["correct"], res["check"]


def reader(name):
    return load_module(os.path.join(BENCH, "metrics", name + ".py"),
                       "t_metric_" + name.replace(".", "_")).read


def _meshed(monkeypatch, record_readback: bool):
    """The spans of two `meshes_from_grids` calls of a mesher at 64^3 (3
    and 6 fruits, the second threaded) with tracing on, from a program that
    records `mesh.readback` or not, and the window around them."""
    from hortimapping_tpu_torch.models.decoder import DecoderSpec, init_decoder_params
    from hortimapping_tpu_torch.ops import mesher
    from hortimapping_tpu_torch.utils import trace

    if not record_readback:
        span = trace.span
        monkeypatch.setattr(mesher.trace, "span", lambda name, *a, **k:
                            trace._NOOP if name == "mesh.readback" else span(name, *a, **k))
    spec = DecoderSpec(code_length=8, dims=(32,) * 4, latent_in=(2,), clamping_distance=0.05)
    params = init_decoder_params(spec, torch.Generator().manual_seed(1), device="cpu")
    m = mesher.MeshExtractor(params, spec, voxels_dim=64, cube_radius=0.04, device="cpu")
    g = torch.Generator().manual_seed(2)
    trace.force(True)
    try:
        t0 = time.perf_counter()
        for n in (3, 6):
            m.meshes_from_grids(m.decode_grids(0.3 * torch.randn(n, 8, generator=g)))
        t1 = time.perf_counter()
        spans = trace.spans()
    finally:
        trace.force(None)
    return spans, (t0, t1)


KEYS = [f"f{i}" for i in range(9)]


def test_host_meshing_readers(monkeypatch):
    spans, window = _meshed(monkeypatch, True)
    ctx = ctx_of(spans, keys=KEYS, window=window)
    hosts = [s for s in spans if s.name == "mesh.host"]
    reads = {s.parent: s for s in spans if s.name == "mesh.readback"}
    cpus = len(os.sched_getaffinity(0))
    assert [h.attrs["threads"] for h in hosts] == [min(3, cpus), min(6, cpus)]
    rb = sum(reads[h.sid].t1 - reads[h.sid].t0 for h in hosts) / 9 / 1e6
    iso = sum(h.t1 - h.t0 for h in hosts) / 9 / 1e6 - rb
    assert reader("mesh.readback_ms_per_fruit")(ctx) == pytest.approx(rb)
    assert reader("mesh.iso_ms_per_fruit")(ctx) == pytest.approx(iso)
    assert rb > 0 and iso > 0
    # the program records the span, and a window's `mesh.host` lacks it
    lost = ctx_of([s for s in spans if s.sid != reads[hosts[0].sid].sid], keys=KEYS,
                  window=window)
    for name in ("mesh.readback_ms_per_fruit", "mesh.iso_ms_per_fruit"):
        with pytest.raises(RuntimeError):
            reader(name)(lost)


def test_host_meshing_readers_read_nothing_without_the_readback_span(monkeypatch):
    spans, window = _meshed(monkeypatch, False)
    assert [s.name for s in spans].count("mesh.host") == 2
    assert "mesh.readback" not in [s.name for s in spans]
    for name in ("mesh.readback_ms_per_fruit", "mesh.iso_ms_per_fruit"):
        assert reader(name)(ctx_of(spans, keys=KEYS, window=window)) is None
