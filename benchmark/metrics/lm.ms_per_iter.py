"""Host time of the solve span less its retrieval and rescue spans, over
the LM iterations of the main solve, summed over the window's batches
(traced run: each span closed by a synchronize)."""

from lib.spans import lm_loop_per_batch


def read(ctx):
    rows = lm_loop_per_batch(ctx)
    iters = sum(n for _, n in rows)
    return 1e3 * sum(t for t, _ in rows) / iters if iters else None
