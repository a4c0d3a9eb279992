"""The readers of the program's own spans and counters
(`lib/program_trace.py` and the metrics over it) on hand-made spans: what
each reads, what it leaves out, the raise where a span it needs is missing,
and nothing at all from a program that records none."""

import os
import sys
from types import SimpleNamespace

import pytest

from conftest import BENCH
from lib import program_trace, work
from lib.harness import load_module

MS = 1_000_000   # ns


def reader(name):
    return load_module(os.path.join(BENCH, "metrics", name + ".py"),
                       "t_metric_" + name.replace(".", "_")).read


def span(name, t0_ms, t1_ms, sid, parent=None, **attrs):
    from hortimapping_tpu_torch.utils.trace import Span

    return Span(name, int(t0_ms * MS), int(t1_ms * MS), sid, parent, None, 1, attrs)


def ctx_of(spans, counters=None, keys=("a",), by_name=None, window=(1.0, 2.0)):
    """A traced run's context: a window from 1 s to 2 s (perf_counter) that
    completed the fruits `keys`, and what the program recorded."""
    ctx = SimpleNamespace(
        summary=SimpleNamespace(window_s=1.0, by_name=by_name or {}),
        window=SimpleNamespace(t0=window[0], t_end=window[1],
                               done=[SimpleNamespace(key=k) for k in keys]),
        config={"decoder": {"dims": [512] * 8, "code_length": 32},
                "precision": {"render": "bf16"}},
        program=SimpleNamespace(cfg=SimpleNamespace(pose_dim=7)))
    ctx.program_trace = (spans, counters or {})
    return ctx


def test_queue_wait_p95_over_the_windows_requests():
    keys = [f"f{i}" for i in range(20)]
    spans = [span("serve.queue", 1000, 1000 + i + 1, i + 1, fruit=k) for i, k in enumerate(keys)]
    spans.append(span("serve.queue", 1000, 1500, 99, fruit="not_in_window"))
    assert reader("serve.queue_wait_ms.p95")(ctx_of(spans, keys=keys)) == pytest.approx(19.0)
    with pytest.raises(RuntimeError):
        reader("serve.queue_wait_ms.p95")(ctx_of(spans[-1:], keys=keys))
    assert reader("serve.queue_wait_ms.p95")(ctx_of([], keys=())) is None


def test_host_ms_per_batch_is_the_batch_less_its_solve():
    spans = [span("serve.batch", 1100, 1200, 1), span("serve.solve", 1110, 1170, 2, parent=1),
             span("serve.batch", 1300, 1350, 3), span("serve.solve", 1300, 1340, 4, parent=3),
             # starts after the window: left out
             span("serve.batch", 2001, 2100, 5), span("serve.solve", 2001, 2050, 6, parent=5)]
    assert reader("serve.host_ms_per_batch")(ctx_of(spans)) == pytest.approx((40 + 10) / 2)
    with pytest.raises(RuntimeError):
        reader("serve.host_ms_per_batch")(ctx_of(spans[:1]))
    with pytest.raises(RuntimeError):
        reader("serve.host_ms_per_batch")(ctx_of(spans[4:]))


def _lm_spans():
    return [
        span("lm.solve", 1100, 1200, 1, phase="coarse", width=4),
        span("lm.readback", 1100, 1101, 2, parent=1),
        span("lm.iteration", 1101, 1111, 3, parent=1, active=4),
        span("lm.readback", 1105, 1111, 4, parent=3),
        span("lm.iteration", 1111, 1131, 5, parent=1, active=3),
        span("lm.readback", 1121, 1131, 6, parent=5),
        span("lm.solve", 1300, 1400, 7, phase="rescue", width=8),
        span("lm.iteration", 1300, 1390, 8, parent=7, active=8),
        span("lm.readback", 1300, 1390, 9, parent=8),
    ]


def test_lm_readers_over_iterations_outside_the_rescue():
    ctx = ctx_of(_lm_spans())
    assert reader("lm.enqueue_ms_per_iter")(ctx) == pytest.approx((4 + 10) / 2)
    assert reader("lm.readback_ms_per_iter")(ctx) == pytest.approx((6 + 10) / 2)
    assert reader("lm.active_lane_share")(ctx) == pytest.approx(100.0 * 7 / 8)
    for name in ("lm.enqueue_ms_per_iter", "lm.readback_ms_per_iter", "lm.active_lane_share"):
        # an iteration without its flag read, and a window with the rescue's only
        with pytest.raises(RuntimeError):
            reader(name)(ctx_of([s for s in _lm_spans() if s.sid != 4]))
        with pytest.raises(RuntimeError):
            reader(name)(ctx_of(_lm_spans()[6:]))
        assert reader(name)(ctx_of([], keys=())) == None  # noqa: E711 - an empty window


def test_band_roofline_from_the_counted_rows():
    t = 0.25
    by_name = {"void render_band_kernel<__nv_bfloat16>(BandArgs, StreamWeights<__nv_bfloat16>)": t,
               "void render_forward_kernel<__nv_bfloat16>(Args)": 9.0}
    rows = 3_000_000
    fwd, bwd = work.chain_macs(512, 7, 35)
    ms, by = work.bound(rows * (32 + 2 * 39 * 4), 2.0 * (fwd + bwd) * rows, 989e12)
    assert by == "operations"
    ctx = ctx_of([], {"render.band_rows": rows}, by_name=by_name)
    assert reader("render.b2_band_roofline")(ctx) == pytest.approx(100.0 * ms / 1e3 / t)
    with pytest.raises(RuntimeError):
        reader("render.b2_band_roofline")(ctx_of([], {}, by_name=by_name))
    assert reader("render.b2_band_roofline")(ctx_of([], {"render.band_rows": rows})) is None


def test_a_program_that_records_nothing_reads_nothing(monkeypatch):
    """An older program (no tracing module) or a run with no profiler
    session: every reader of the program's spans returns None."""
    names = ("serve.queue_wait_ms.p95", "serve.host_ms_per_batch", "lm.enqueue_ms_per_iter",
             "lm.readback_ms_per_iter", "lm.active_lane_share", "render.b2_band_roofline")
    by_name = {"void render_band_kernel<float>(BandArgs, StreamWeights<float>)": 1.0}
    import hortimapping_tpu_torch.utils as utils

    monkeypatch.setitem(sys.modules, "hortimapping_tpu_torch.utils.trace", None)
    monkeypatch.delattr(utils, "trace", raising=False)
    for name in names:
        ctx = ctx_of([], by_name=by_name)
        del ctx.program_trace
        assert reader(name)(ctx) is None
    untraced = ctx_of([], by_name=by_name)
    del untraced.program_trace
    untraced.summary.window_s = 0.0
    assert program_trace.collected(untraced) is None
