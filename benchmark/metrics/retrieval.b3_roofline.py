"""Share of B3's roofline: the least time the chip needs for the work the
window asked of it (`lib/work.counted(ctx, "retrieval")`, at the configuration's
precision for it) over the device time of its kernels in the trace, in
percent."""

from lib.work import counted


def read(ctx):
    w = counted(ctx, "retrieval")
    t = ctx.summary.by_label.get("B3", 0.0)
    return 100.0 * w["bound_s"] / t if w and t > 0 else None
