"""95th percentile (nearest rank) over the window's batches of each batch's
LM loop time per iteration (`lm.ms_per_iter`, batch by batch)."""

import math

from lib.spans import lm_loop_per_batch


def read(ctx):
    per = sorted(1e3 * t / n for t, n in lm_loop_per_batch(ctx) if n)
    return per[math.ceil(0.95 * len(per)) - 1] if per else None
