"""Open loop into `CompletionServer.submit`: independent fruits from mapping
robots, arriving as a Poisson process at `rate_per_s`. Each request is due
at its arrival time whether or not earlier ones have finished, and its
latency runs from when it was due to when its result, mesh included, is
resolved. The window's requests are those due within `--seconds`; the run
waits for every one of them (up to a minute past the close).

Set-up warms the server at every batch width (`CompletionServer.warmup`)
and then serves `warm_s` seconds of the same traffic from another stream,
so the window starts on a server that has already met the mix of batch
sizes it will serve.

Parameters: rate_per_s, warm_s, pool, pose_offset_sigma_m.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from lib.harness import Done, Window, done_from_result
from lib.scenes import make_requests


def arrivals(gap_seed: int, seed: int, rate_per_s: float, n: int) -> np.ndarray:
    """The due times (s from the window's start) of n Poisson arrivals: the
    exponential gaps are drawn from `gap_seed`, the same set for every run,
    and `seed` puts them in its own order."""
    gaps = np.random.default_rng([gap_seed, 0xA7717E]).exponential(1.0 / rate_per_s, size=n)
    return np.cumsum(np.random.default_rng([seed, 0xA7717E]).permutation(gaps))


def prepare(ctx):
    p = ctx.params
    n = int(p["rate_per_s"] * ctx.seconds * 1.5) + 64
    ctx.due = arrivals(p["pool_seed"], ctx.seed, p["rate_per_s"], n)
    ctx.reqs = make_requests(ctx.pool, n, p["pose_offset_sigma_m"], ctx.seed, stream=1)
    warm = make_requests(ctx.pool, 1, p["pose_offset_sigma_m"], ctx.seed, stream=2)
    ctx.server = ctx.program.server(ctx.config["serving"])
    ctx.server.start()
    ctx.server.warmup(ctx.program.requests(ctx.pool, warm)[0])
    n_warm = int(p["rate_per_s"] * p["warm_s"] * 1.5) + 16
    warm = make_requests(ctx.pool, n_warm, p["pose_offset_sigma_m"], ctx.seed, stream=3)
    due = arrivals(p["pool_seed"] + 1, ctx.seed, p["rate_per_s"], n_warm)
    _, futs, _ = _submit_at(ctx.server, [d for d in due if d < p["warm_s"]],
                            ctx.program.requests(ctx.pool, warm))
    for f in futs:
        f.result(timeout=600)


def _submit_at(srv, due, reqs, on_done=None):
    """Submit each request at its due time (s from now): (t0, futures,
    lateness of each submit)."""
    futs, late = [], []
    t0 = time.perf_counter()
    for d, r in zip(due, reqs):
        wait = t0 + d - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        late.append(time.perf_counter() - (t0 + d))
        f = srv.submit(r)
        if on_done is not None:
            f.add_done_callback(on_done(r.fruit_id))
        futs.append(f)
    return t0, futs, late


def window(ctx) -> Window:
    due = [d for d in ctx.due if d < ctx.seconds]
    reqs = ctx.reqs[:len(due)]
    t_done = {}
    lock = threading.Lock()

    def stamp(key):
        def cb(_fut):
            with lock:
                t_done[key] = time.perf_counter()
        return cb

    t0, futs, late = _submit_at(ctx.server, due, ctx.program.requests(ctx.pool, reqs), stamp)
    t_close = time.perf_counter()
    out, failed = [], 0
    for d, r, f in zip(due, reqs, futs):
        try:
            res = f.result(timeout=max(1.0, t_close + 60.0 - time.perf_counter()))
        except Exception:   # noqa: BLE001 - a request that never resolves or raises
            failed += 1
            out.append(Done(r.key, r.scene, r.T_ow0, t0 + d, float("inf"), failed=True))
            continue
        while r.key not in t_done:     # the callback runs just after the waiters wake
            time.sleep(0.0001)
        out.append(done_from_result(r, res, t0 + d, t_done[r.key]))
        failed += int(res.failed)
    t_end = max([o.t_done for o in out if np.isfinite(o.t_done)], default=t_close)
    lat = [(o.t_done - o.t_due) * 1e3 for o in out]
    half = len(lat) // 2
    return Window(t0=t0, t_end=t_end, done=out, attempted=len(due), failed=failed,
                  notes={"generator_late_p95_ms": float(np.percentile(late, 95) * 1e3) if late else 0.0,
                         "generator_late_max_ms": float(max(late) * 1e3) if late else 0.0,
                         # a backlog that grows over the window shows as a later half
                         # waiting longer than the first
                         "latency_p95_ms_first_half": float(np.percentile(lat[:half], 95)) if half else 0.0,
                         "latency_p95_ms_second_half": float(np.percentile(lat[half:], 95)) if half else 0.0})


def close(ctx):
    ctx.server.stop()
