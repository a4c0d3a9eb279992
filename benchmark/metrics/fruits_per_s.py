"""Fruits completed (solved and meshed, not failed) over the whole window,
which ends at the end of the batch that crossed `--seconds`."""


def read(ctx):
    w = ctx.window
    span = w.t_end - w.t0
    return sum(not d.failed for d in w.done) / span if span > 0 else None
