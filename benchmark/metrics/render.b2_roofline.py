"""Share of B2's roofline: the least time the chip needs for the work the
window asked of it (`lib/work.counted(ctx, "render")`, at the configuration's
precision for it) over the device time of its kernels in the trace, in
percent."""

from lib.work import counted


def read(ctx):
    w = counted(ctx, "render")
    t = ctx.summary.by_label.get("B2", 0.0)
    return 100.0 * w["bound_s"] / t if w and t > 0 else None
