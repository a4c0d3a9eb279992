"""Host time of an LM iteration outside its flag read: each `lm.iteration`
span less its `lm.readback`, mean over the window's iterations of every
phase but the rescue, in ms (program span)."""

from lib.program_trace import lm_iterations


def read(ctx):
    rows = lm_iterations(ctx)
    if not rows:
        return None
    return sum((it.t1 - it.t0) - (rb.t1 - rb.t0) for it, rb, _ in rows) / len(rows) / 1e6
