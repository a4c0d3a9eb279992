"""The port's spans and counters (`hortimapping_tpu_torch/utils/trace.py`)
on the CPU: nothing recorded while tracing is off, spans nested per thread
while a profiler session is on, on the profiler's clock, and the LM loop's
and the server's spans where the work happens, with results bit-equal on
and off. The render term's device counters are checked on the card.

The decoder and scenes are those of `tests/test_serve.py`
(`synthetic_small_8`, 2 frames x 64 rays x 16 samples, 64 points), made
with the port alone.
"""

import dataclasses
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from hortimapping_tpu_torch.config import JointOptConfig
from hortimapping_tpu_torch.models.workspace import config_decoder
from hortimapping_tpu_torch.ops.mesher import MeshExtractor
from hortimapping_tpu_torch.optim import lm
from hortimapping_tpu_torch.optim.state import FruitObservations, stack_observations
from hortimapping_tpu_torch.serve import CompletionRequest, CompletionServer
from hortimapping_tpu_torch.tools.synthetic import SyntheticCategory, make_scene
from hortimapping_tpu_torch.utils import trace
from torch_port_common import ASSETS

ASSET_DIR = os.path.join(ASSETS, "synthetic_small_8")
pytestmark = pytest.mark.skipif(not os.path.isdir(ASSET_DIR), reason="synthetic assets not built")

torch.set_num_threads(1)

CFG = JointOptConfig(n_fg_pix=32, n_bg_pix=32, n_frame=2, n_sample_on_ray=16, recon_n_pts=64,
                     max_iter=3, lm_lambda_0=0.5)
C2F = dataclasses.replace(CFG, coarse_to_fine=True, max_iter=6, coarse_max_iter=4,
                          fine_max_iter=3, coarse_frame_stride=2, robust_iter=2)
RADIUS = 0.1


@pytest.fixture(autouse=True)
def follow_the_profiler():
    """Every test leaves tracing to follow the profiler again."""
    yield
    trace.force(None)


@pytest.fixture(scope="module")
def decoder():
    return config_decoder(ASSET_DIR, device="cpu")


def _requests(spec, n, seed=0):
    cat = SyntheticCategory(spec=spec)
    rng = np.random.default_rng(seed)
    reqs = []
    for b in range(n):
        code = rng.normal(size=spec.code_length).astype(np.float32) * 0.3
        T_wo = np.eye(4, dtype=np.float32)
        T_wo[:3, 3] = rng.normal(size=3) * 0.05
        obs, _ = make_scene(cat, code, T_wo, n_frames=CFG.n_frame, n_fg=CFG.n_fg_pix,
                            n_bg=CFG.n_bg_pix, n_points=CFG.recon_n_pts, seed=seed + b)
        reqs.append(CompletionRequest(
            fruit_id=f"fruit_{seed}_{b:02d}", obs=FruitObservations(*obs),
            latent0=np.zeros(spec.code_length, np.float32),
            T_ow0=np.linalg.inv(T_wo).astype(np.float32)))
    return reqs


def _batch(reqs):
    obs = stack_observations([r.obs for r in reqs], "cpu")
    return (obs, torch.as_tensor(np.stack([r.latent0 for r in reqs])),
            torch.as_tensor(np.stack([r.T_ow0 for r in reqs])))


def _c2f(decoder, reqs):
    return lm.coarse_to_fine_joint_opt(*decoder, C2F, *_batch(reqs), RADIUS, device="cpu")


def _named(name):
    return [s for s in trace.spans() if s.name == name]


def test_off_records_nothing(decoder):
    """Tracing off: the shared no-op span, no span, no device counter, and
    the LM loop and the server run as without the module."""
    trace.force(True)
    trace.force(False)
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b", x=1)
    reqs = _requests(decoder[1], 3)
    _c2f(decoder, reqs)
    with CompletionServer(*decoder, CFG, cube_radius=RADIUS, max_batch=4, device="cpu") as srv:
        [f.result(timeout=300) for f in [srv.submit(r) for r in reqs]]
    trace.add("render.band_rows", torch.tensor(7))
    trace.record("serve.queue", 0, 1)
    assert trace.spans() == [] and trace.counters() == {}


def test_spans_nest_per_thread():
    """Under a profiler session: each span's parent is the span open on its
    own thread, and a child takes its parent's group."""
    assert not trace.enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.enabled()
        other = threading.Event()
        seen = threading.Event()

        def worker():
            with trace.span("t.outer", group=2):
                seen.set()
                other.wait(10)
                with trace.span("t.inner", k="v") as sp:
                    sp.set(n=3)

        with trace.span("m.outer", group=1):
            th = threading.Thread(target=worker)
            th.start()
            seen.wait(10)
            with trace.span("m.inner"):
                other.set()
                th.join(10)
                assert not th.is_alive()
            trace.record("m.timed", 5, 6, fruit="f")
    assert not trace.enabled()
    by = {s.name: s for s in trace.spans()}
    assert set(by) == {"t.outer", "t.inner", "m.outer", "m.inner", "m.timed"}
    assert by["m.outer"].parent is None and by["t.outer"].parent is None
    assert by["m.inner"].parent == by["m.outer"].sid and by["m.inner"].group == 1
    assert by["m.timed"].parent == by["m.outer"].sid and by["m.timed"].attrs == {"fruit": "f"}
    assert by["t.inner"].parent == by["t.outer"].sid and by["t.inner"].group == 2
    assert by["t.inner"].attrs == {"k": "v", "n": 3}
    assert by["t.inner"].thread == by["t.outer"].thread != by["m.inner"].thread
    for s in by.values():
        assert s.t0 <= s.t1
    assert by["m.outer"].t0 <= by["m.inner"].t0 <= by["m.inner"].t1 <= by["m.outer"].t1


def test_counts_and_spans_from_many_threads():
    """The host counters and the ring under threads switching often: no
    count lost, every span kept once with its own id and its own thread's
    parent."""
    ns = {"n": 0}
    threads_n, each = 16, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    trace.force(True)
    try:
        def work():
            for _ in range(each):
                with trace.span("outer"):
                    trace.count(ns, "n")
                    with trace.span("inner"):
                        trace.count(ns, "n", 2)

        ths = [threading.Thread(target=work) for _ in range(threads_n)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(60)
        assert not any(t.is_alive() for t in ths)
    finally:
        sys.setswitchinterval(old)
    assert ns["n"] == 3 * threads_n * each
    got = trace.spans()
    assert len(got) == 2 * threads_n * each == len({s.sid for s in got})
    outer = {s.sid: s for s in got if s.name == "outer"}
    for s in got:
        if s.name == "inner":
            assert outer[s.parent].thread == s.thread
            assert outer[s.parent].t0 <= s.t0 <= s.t1 <= outer[s.parent].t1


def test_spans_lie_on_the_profilers_clock():
    """A `record_function` range inside a program span lies inside it on
    the profiler's clock, within 0.1 ms."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("clock"):
            time.sleep(0.002)
            with record_function("probe"):
                time.sleep(0.002)
            time.sleep(0.002)
    (s,) = _named("clock")
    off = trace.clock_offset_ns()
    probe = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe"]
    assert len(probe) == 1
    assert s.t0 + off - 100_000 <= probe[0].start_ns() <= probe[0].end_ns() <= s.t1 + off + 100_000


def test_lm_spans_of_a_coarse_to_fine_solve(decoder, monkeypatch):
    """A coarse-to-fine batched solve: one `lm.solve` a phase, as many
    `lm.iteration` spans in each as its slowest lane's iterations, each
    with the lanes neither done nor failed on entry and one `lm.readback`,
    and lanes bit-equal with tracing on and off. The last lane sees no
    valid ray, so it fails at its first iteration in each phase."""
    reqs = _requests(decoder[1], 4, seed=7)
    blind = reqs[3].obs._replace(ray_valid=np.zeros_like(reqs[3].obs.ray_valid))
    reqs[3] = dataclasses.replace(reqs[3], obs=blind)
    trace.force(False)
    off = _c2f(decoder, reqs)
    entering = []
    orig = lm.lm_iteration

    def counted(params, spec, cfg, obs, state, *a, **k):
        entering.append(int((~(state.done | state.failed)).sum()))
        return orig(params, spec, cfg, obs, state, *a, **k)

    monkeypatch.setattr(lm, "lm_iteration", counted)
    trace.force(True)
    on = _c2f(decoder, reqs)
    for a, b in zip(off, on):
        assert torch.equal(a, b)

    solves = _named("lm.solve")
    assert [s.attrs["phase"] for s in solves] == ["coarse", "fine"]
    assert all(s.attrs["width"] == 4 for s in solves)
    coarse_obs, coarse_cfg = lm.subsample_observations(_batch(reqs)[0], C2F)
    trace.force(False)
    monkeypatch.setattr(lm, "lm_iteration", orig)
    coarse = lm.shape_pose_joint_opt_batched(*decoder, coarse_cfg, coarse_obs, *_batch(reqs)[1:],
                                             RADIUS, device="cpu")
    want = {"coarse": int(coarse.iter_count.max()),
            "fine": int((off.iter_count - coarse.iter_count).max())}
    iters = _named("lm.iteration")
    reads = _named("lm.readback")
    for s in solves:
        mine = [it for it in iters if it.parent == s.sid]
        assert len(mine) == want[s.attrs["phase"]] > 0
        for it in mine:
            assert s.t0 <= it.t0 <= it.t1 <= s.t1
            (rb,) = [r for r in reads if r.parent == it.sid]
            assert it.t0 <= rb.t0 <= rb.t1 == max(r.t1 for r in reads if r.parent == it.sid)
            assert rb.t1 <= it.t1
        # the loop's first read, before any iteration
        assert len([r for r in reads if r.parent == s.sid]) == 1
    assert [it.attrs["active"] for it in iters] == entering
    assert entering == [4, 3, 3, 3, 4, 3, 3]


def test_server_spans(decoder):
    """A CPU server with meshing: one `serve.queue` a request from its
    submit to no later than its batch's `serve.batch` start, and one
    `serve.solve` and one `mesh.host` in each `serve.batch`."""
    reqs = _requests(decoder[1], 5, seed=3)
    mesher = MeshExtractor(*decoder, voxels_dim=24, cube_radius=RADIUS, device="cpu")
    trace.force(True)
    stamps = {}
    with CompletionServer(*decoder, CFG, cube_radius=RADIUS, max_batch=4, mesher=mesher,
                          device="cpu") as srv:
        futs = []
        for r in reqs:
            t0 = time.perf_counter_ns()
            futs.append(srv.submit(r))
            stamps[r.fruit_id] = (t0, time.perf_counter_ns())
        results = [f.result(timeout=300) for f in futs]
    assert all(not r.failed for r in results)
    batches = {s.attrs["batch"]: s for s in _named("serve.batch")}
    assert sum(s.attrs["lanes"] for s in batches.values()) == 5
    queue = _named("serve.queue")
    assert sorted(q.attrs["fruit"] for q in queue) == sorted(stamps)
    for q in queue:
        lo, hi = stamps[q.attrs["fruit"]]
        assert lo - 1000 <= q.t0 <= hi + 1000
        b = batches[q.attrs["batch"]]
        assert q.group == q.attrs["batch"] == b.group and q.t1 <= b.t0
    for seq, b in batches.items():
        assert b.attrs["width"] == srv._batch_width(b.attrs["lanes"])
        for name in ("serve.solve", "mesh.host"):
            (child,) = [s for s in _named(name) if s.parent == b.sid]
            assert b.t0 <= child.t0 <= child.t1 <= b.t1 and child.group == seq
        solve = [s for s in _named("serve.solve") if s.parent == b.sid][0]
        assert any(s.parent == solve.sid for s in _named("lm.solve"))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernel)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_band_rows_count_the_band_on_the_card(cuda):
    """`render.band_rows` is the sum of the band's packed total over the
    fused render calls made while tracing is on, `render.fwd_rows` the sum
    of the forward's (the in-radius samples of valid rays of active lanes)
    and `render.rows` the sum of the active lanes' samples; nothing while
    off."""
    from hortimapping_tpu_torch.models.decoder import DecoderSpec
    from hortimapping_tpu_torch.models.workspace import params_from_jax
    from hortimapping_tpu_torch.ops import render_kernel
    from torch_port_common import load_npz_params, widen_decoder_np

    params_np, fields, _, _ = load_npz_params("synthetic_small_8")
    params_np, fields = widen_decoder_np(params_np, fields, 128)
    params, spec = params_from_jax(params_np, cuda), DecoderSpec(**fields)
    fused = dataclasses.replace(CFG, fused_render=True, fused_bf16=True)
    assert fused.fused_resolved(spec)
    obs, lat0, T0 = _batch(_requests(spec, 4, seed=11))
    totals = {"render.band_rows": [], "render.fwd_rows": [], "render.rows": []}
    fwd, band = render_kernel.render_forward, render_kernel.render_band

    def spy_fwd(*args, **kw):
        rl = fwd(*args, **kw)
        lanes = args[8] if len(args) > 8 else kw.get("lane_active")
        n_act = rl.B if lanes is None else int(lanes.sum())
        totals["render.fwd_rows"].append(int(rl.fwd_offsets[-1]))
        totals["render.rows"].append(n_act * rl.F * rl.R * rl.M)
        return rl

    def spy_band(pk, latent, rl, offsets, pose_dim):
        totals["render.band_rows"].append(int(offsets[-1]))
        return band(pk, latent, rl, offsets, pose_dim)

    render_kernel.render_forward, render_kernel.render_band = spy_fwd, spy_band
    try:
        trace.force(False)
        before = trace.counters()   # an earlier session's, if any
        lm.shape_pose_joint_opt_batched(params, spec, fused, obs, lat0, T0, RADIUS, device=cuda)
        assert all(totals.values()) and trace.counters() == before
        for v in totals.values():
            v.clear()
        trace.force(True)
        lm.shape_pose_joint_opt_batched(params, spec, fused, obs, lat0, T0, RADIUS, device=cuda)
        assert all(totals.values())
        assert trace.counters() == {k: sum(v) for k, v in totals.items()}
        assert 0 < sum(totals["render.fwd_rows"]) < sum(totals["render.rows"])
    finally:
        render_kernel.render_forward, render_kernel.render_band = fwd, band
