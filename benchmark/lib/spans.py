"""Sums over the benchmark's own spans of a traced run (`lib/record.py`)."""

from __future__ import annotations

from collections import defaultdict
from typing import List, Tuple


def total(ctx, name: str) -> float:
    """Seconds in the spans `name`. Raises where the window completed fruits
    and no such span was recorded: the program no longer calls what the
    recorder wraps."""
    spans = [t1 - t0 for n, t0, t1, _ in ctx.rec.spans if n == name]
    if not spans and ctx.window.done:
        raise RuntimeError(f"no {name!r} span in a window of {len(ctx.window.done)} fruits: "
                           "the recorder's wrappers no longer see the program's calls")
    return sum(spans)


def lm_loop_per_batch(ctx) -> List[Tuple[float, int]]:
    """(seconds, LM iterations) of each batch's main solve: its `solve` span
    less the `retrieval` and `rescue` spans inside it, and the iterations of
    its main solve."""
    total(ctx, "solve")
    per = defaultdict(float)
    seen = set()
    for name, t0, t1, b in ctx.rec.spans:
        if name == "solve":
            per[b] += t1 - t0
            seen.add(b)
        elif name in ("retrieval", "rescue"):
            per[b] -= t1 - t0
    return [(per[b], ctx.rec.batches[b].n_iters) for b in sorted(seen) if b >= 0]
