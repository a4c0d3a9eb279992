"""The whole step's share of the chip's peak: the operations of every
decoder evaluation the window asked for (B1-B4's work, each at the peak of
the precision the configuration states for it) over the traced window, in
percent. A kernel taken off the path leaves its roofline silent; this
share still counts its work."""

from lib.work import PEAK_FLOPS, counted

FAMILIES = ("render", "sdf", "retrieval", "grid")


def read(ctx):
    s = ctx.summary
    if s.window_s <= 0:
        return None
    ideal = 0.0
    for kind in FAMILIES:
        prec = ctx.config["precision"][kind]
        w = counted(ctx, kind)
        if w:
            ideal += w["flops"] / PEAK_FLOPS[prec]
    return 100.0 * ideal / s.window_s if ideal else None
