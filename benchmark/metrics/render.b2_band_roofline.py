"""Share of the roofline of B2's band backward (`render_band_kernel`): the
least time the chip needs for the band rows the program counted on the
card (`render.band_rows`, every fused render call of the traced session),
each row a forward of the decoder chain again and its input-grad backward
(`lib/work.chain_macs`) at the configuration's render precision, reading
its band record and writing its depth and mask Jacobian rows, over the
traced time of that kernel alone, in percent."""

from lib import work
from lib.program_trace import counter, kernel_seconds

REC_BYTES = 8 * 4        # a band record (csrc/fused_render.cu kRec floats)


def read(ctx):
    t = kernel_seconds(ctx, "render_band_kernel")
    rows = counter(ctx, "render.band_rows")
    if t <= 0 or rows is None:
        return None
    if rows <= 0:
        raise RuntimeError("the band kernel ran and the program counted no band row")
    D, n_mid, in_dim = work.decoder_sizes(ctx.config["decoder"])
    fwd, bwd = work.chain_macs(D, n_mid, in_dim)
    J = ctx.program.cfg.pose_dim + ctx.config["decoder"]["code_length"]
    ms, _ = work.bound(float(rows) * (REC_BYTES + 2 * J * 4), 2.0 * (fwd + bwd) * float(rows),
                       work.PEAK_FLOPS[ctx.config["precision"]["render"]])
    return 100.0 * ms / 1e3 / t
