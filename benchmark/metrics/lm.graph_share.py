"""LM iterations whose own code replayed as CUDA graphs: the share of the
window's `lm.iteration` spans of every phase but the rescue that carry
`graph` 1, in percent (program span). None where no span carries the
attribute: a program that records it not."""

from lib.program_trace import lm_iterations


def read(ctx):
    rows = lm_iterations(ctx)
    if not rows:
        return None
    flags = [it.attrs.get("graph") for it, _, _ in rows]
    if all(f is None for f in flags):
        return None
    return 100.0 * sum(f == 1 for f in flags) / len(flags)
