"""Closed loop into `CompletionServer.submit`: `in_flight` requests
outstanding at all times, each completion submitting the next, so every
batch is full and batches run back to back (above the knee, where
throughput is judged and the packer's wait is bypassed). The window starts
at the first submit and ends at the end of the batch that crosses
`--seconds`; the fruits of that batch and all before it are counted.

Parameters: in_flight, pool, pose_offset_sigma_m.
"""

from __future__ import annotations

import threading
import time


from lib.harness import Done, Window, done_from_result
from lib.scenes import make_requests


def prepare(ctx):
    p = ctx.params
    ctx.server = ctx.program.server(ctx.config["serving"])
    ctx.server.start()
    warm = make_requests(ctx.pool, 2 * ctx.config["serving"]["max_batch"], p["pose_offset_sigma_m"],
                         ctx.seed, stream=2)
    for f in [ctx.server.submit(r) for r in ctx.program.requests(ctx.pool, warm)]:
        f.result(timeout=600)


def window(ctx) -> Window:
    p = ctx.params
    srv = ctx.server
    n_max = int(p["max_fruits_per_s"] * ctx.seconds * 2) + 4 * p["in_flight"]
    reqs = make_requests(ctx.pool, n_max, p["pose_offset_sigma_m"], ctx.seed, stream=1)
    prog = ctx.program.requests(ctx.pool, reqs)
    lock = threading.Lock()
    state = {"next": 0, "stop": False}
    t_done, futs, order = {}, {}, []
    all_done = threading.Event()
    t0 = time.perf_counter()

    def submit_next():
        with lock:
            if state["stop"] or state["next"] >= n_max:
                if not state["stop"] and state["next"] >= n_max:
                    state["stop"] = True
                return
            k = state["next"]
            state["next"] += 1
        f = srv.submit(prog[k])
        futs[k] = f
        f.add_done_callback(lambda _f, k=k: on_done(k))

    def on_done(k):
        now = time.perf_counter()
        with lock:
            t_done[k] = now
            order.append(k)
            if now - t0 >= ctx.seconds:
                state["stop"] = True
            outstanding = state["next"] - len(t_done)
        if outstanding == 0 and state["stop"]:
            all_done.set()
        submit_next()

    for _ in range(p["in_flight"]):
        submit_next()
    if not all_done.wait(timeout=ctx.seconds + 120.0):
        raise RuntimeError("closed loop: requests still outstanding two minutes past the window")
    # the server resolves a batch's results one after another, each with the
    # batch's size: walk them in the order they completed, a batch at a
    # time, to the batch holding the first result completed after the
    # window's end; its last result closes the window
    t_end, j = None, 0
    while t_end is None and j < len(order):
        try:
            n = max(1, futs[order[j]].result(timeout=0).batch_size)
        except Exception:   # noqa: BLE001 - a request that raised: counted below
            n = 1
        batch = order[j:j + n]
        if t_done[batch[-1]] - t0 >= ctx.seconds:
            t_end = t_done[batch[-1]]
        j += n
    out, failed = [], 0
    for k, f in sorted(futs.items()):
        if t_done[k] > t_end:
            continue
        r = reqs[k]
        try:
            res = f.result(timeout=0)
        except Exception:   # noqa: BLE001 - a request that raised
            failed += 1
            out.append(Done(r.key, r.scene, r.T_ow0, t0, float("inf"), failed=True))
            continue
        failed += int(res.failed)
        out.append(done_from_result(r, res, t0, t_done[k]))
    return Window(t0=t0, t_end=t_end, done=out, attempted=len(out), failed=failed, notes={})


def close(ctx):
    ctx.server.stop()
