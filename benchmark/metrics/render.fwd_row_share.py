"""Share of the render term's samples that B2's forward runs the decoder
on: the program's device counters `render.fwd_rows` (the in-radius samples
of valid rays of active lanes, packed for the chain) over `render.rows`
(every sample of the active lanes), summed over the fused render calls of
the traced session, in percent. None where `render.rows` reads 0 or
nothing: a program that counts neither."""

from lib.program_trace import counter


def read(ctx):
    rows = counter(ctx, "render.rows")
    if not rows:
        return None
    return 100.0 * (counter(ctx, "render.fwd_rows") or 0) / rows
