"""Lanes an LM iteration steps that are neither done nor failed on entry,
over its loop's width, summed over the window's iterations of every phase
but the rescue, in percent (the `active` and `width` counts the program
records on its spans)."""

from lib.program_trace import lm_iterations


def read(ctx):
    rows = lm_iterations(ctx)
    if not rows:
        return None
    return 100.0 * sum(it.attrs["active"] for it, _, _ in rows) / sum(
        loop.attrs["width"] for _, _, loop in rows)
