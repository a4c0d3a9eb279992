"""The host's wait for the device at an LM iteration's flag read: the
`lm.readback` span of each of the window's iterations of every phase but
the rescue, mean, in ms (program span)."""

from lib.program_trace import lm_iterations


def read(ctx):
    rows = lm_iterations(ctx)
    if not rows:
        return None
    return sum(rb.t1 - rb.t0 for _, rb, _ in rows) / len(rows) / 1e6
