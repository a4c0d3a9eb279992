"""The traced window: torch.profiler's device activity over the window,
reduced in memory to what the readers need; nothing is written.

Device busy time is the union of the device's kernel, copy and set
intervals inside the window, so overlapping streams are not counted twice;
the idle share is 1 - busy / window. The profiler's timestamps are wall
clock; the benchmark's spans (host `perf_counter`) are placed on them by the
offset between the two clocks read at the window's start, so an idle gap
is named by the span open on the host when it began.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

# the kernels of the program, by the name of the TPU kernel each replaces
KERNEL_LABELS = (
    ("render_forward_kernel", "B2"), ("render_band_kernel", "B2"), ("render_sum_kernel", "B2"),
    ("mlp_fwd_grad_kernel", "B1"), ("mlp_fwd_kernel", "B3"), ("mlp_shared_latent_kernel", "B4"),
)


def kernel_label(name: str) -> str:
    base = name.split("<")[0].split("(")[0].replace("void ", "").strip()
    for k, lab in KERNEL_LABELS:
        if base == k:
            return lab
    return "other"


class Summary:
    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.by_name: Dict[str, float] = defaultdict(float)
        self.by_label: Dict[str, float] = defaultdict(float)
        self.gaps: List[Tuple[str, float]] = []
        self._prof = None
        self._win_ns = (0, 0)
        self._offset_ns = 0


@contextlib.contextmanager
def traced(on: bool, cuda: bool):
    """Profile the device over the block when `on`; yields a Summary that
    `reduce` fills once the block has ended."""
    summ = Summary()
    if not (on and cuda):
        yield summ
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA], record_shapes=False, with_stack=False,
                 profile_memory=False) as prof:
        t0 = time.perf_counter_ns()
        summ._offset_ns = time.time_ns() - t0
        yield summ
        torch.cuda.synchronize()
        t1 = time.perf_counter_ns()
    summ.window_s = (t1 - t0) / 1e9
    summ._prof = prof
    summ._win_ns = (t0 + summ._offset_ns, t1 + summ._offset_ns)


def reduce(summ: Summary, spans) -> None:
    """Busy time, time by kernel and the longest idle gaps of the window;
    `spans`: the recorder's (name, t0, t1, batch) in host seconds."""
    if summ._prof is None:
        return
    from torch.autograd import DeviceType

    lo, hi = summ._win_ns
    dev = []
    for e in summ._prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        s, t = e.start_ns(), e.end_ns()
        if t > lo and s < hi:
            dev.append((max(s, lo), min(t, hi), e.name()))
    summ._prof = None
    dev.sort()
    for s, t, n in dev:
        summ.by_name[n] += (t - s) / 1e9
        summ.by_label[kernel_label(n)] += (t - s) / 1e9
    busy, gaps = 0, []
    cur_s = cur_t = None
    for s, t, _ in dev:
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
            gaps.append((lo if cur_t is None else cur_t, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy += cur_t - cur_s
        gaps.append((cur_t, hi))
    else:
        gaps.append((lo, hi))
    summ.busy_s = busy / 1e9
    off = summ._offset_ns
    host = sorted((int(t0 * 1e9) + off, int(t1 * 1e9) + off, n) for n, t0, t1, _ in spans)
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    summ.gaps = [(_open_span(host, g0), (g1 - g0) / 1e9) for g0, g1 in longest if g1 > g0]


def _open_span(spans, t) -> str:
    """The innermost benchmark span open on the host at time t, else the
    span that ended last before it."""
    best: Optional[tuple] = None
    last: Optional[tuple] = None
    for s, e, n in spans:
        if s > t:
            break
        if e >= t and (best is None or s >= best[0]):
            best = (s, e, n)
        elif e < t and (last is None or e > last[1]):
            last = (s, e, n)
    if best:
        return best[2]
    return "after " + last[2] if last else "before any span"


def breakdown(summ: Summary) -> dict:
    ops = sorted(summ.by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[f"{kernel_label(n)} {n.split('(')[0][:80]}", s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in summ.gaps]}
