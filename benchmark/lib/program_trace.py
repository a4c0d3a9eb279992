"""The program's own spans and counters of a traced run
(`hortimapping_tpu_torch/utils/trace.py`, on while the run's profiler
session is), for the readers of the metrics they feed. With
`lib/program.py`, `traffic/` and the recorder's wrappers, the
only module of the benchmark that touches the program.

Span times are the program's `time.perf_counter_ns`, the clock of the
window's bounds. A program that records no spans (one without the tracing
module, or a run without a profiler session) gives nothing, and the readers
return None. A traced window that completed fruits but lacks a span or
counter a reader needs fails the run, as `lib/spans.total` does: the
program stopped recording where the metric reads it.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def collected(ctx) -> Optional[tuple]:
    """(spans, device counters) of the run's profiler session, read once a
    run; None where the program records none."""
    if not hasattr(ctx, "program_trace"):
        ctx.program_trace = None
        if ctx.summary.window_s > 0:
            try:
                from hortimapping_tpu_torch.utils import trace
            except ImportError:
                pass
            else:
                ctx.program_trace = (trace.spans(), trace.counters())
    return ctx.program_trace


def _missing(ctx, what: str) -> RuntimeError:
    return RuntimeError(f"no {what} in a traced window of {len(ctx.window.done)} fruits: the "
                        "program no longer records where the metric reads it")


def in_window(ctx, name: str) -> Optional[List]:
    """The spans `name` that start inside the window (the batch that closes
    a window ends after its last result resolved); None where
    the program records none. Raises where the window completed fruits and
    has no such span."""
    got = collected(ctx)
    if got is None:
        return None
    lo, hi = ctx.window.t0 * 1e9, ctx.window.t_end * 1e9
    out = [s for s in got[0] if s.name == name and lo <= s.t0 <= hi]
    if not out and ctx.window.done:
        raise _missing(ctx, f"{name!r} span")
    return out


def children(ctx, name: str) -> Dict[int, object]:
    """The session's spans `name` by their parent's id."""
    return {s.parent: s for s in collected(ctx)[0] if s.name == name}


def lm_iterations(ctx) -> Optional[List[tuple]]:
    """(iteration, its flag read, its loop) for every `lm.iteration` of the
    window whose loop is not the rescue's; None where the program records
    none."""
    its = in_window(ctx, "lm.iteration")
    if its is None:
        return None
    solves = {s.sid: s for s in collected(ctx)[0] if s.name == "lm.solve"}
    reads = children(ctx, "lm.readback")
    rows = []
    for it in its:
        loop = solves.get(it.parent)
        if loop is None or reads.get(it.sid) is None:
            raise _missing(ctx, "loop or flag read of an 'lm.iteration'")
        if loop.attrs["phase"] != "rescue":
            rows.append((it, reads[it.sid], loop))
    if not rows and ctx.window.done:
        raise _missing(ctx, "LM iteration outside the rescue")
    return rows


def counter(ctx, name: str) -> Optional[int]:
    """Device counter `name` over the session (0 where nothing added to
    it); None where the program records none."""
    got = collected(ctx)
    return None if got is None else got[1].get(name, 0)


def kernel_seconds(ctx, kernel: str) -> float:
    """Traced device time of the kernel named `kernel` (any template
    instance)."""
    def base(n):
        return n.split("<")[0].split("(")[0].replace("void ", "").strip()

    return sum(t for n, t in ctx.summary.by_name.items() if base(n) == kernel)
