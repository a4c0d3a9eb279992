"""The yardstick of the per-layer readers: peaks of the chip, the decoder
chain's operations and bytes, and the work each kernel family was asked for
in a traced run, counted from the inputs and the program's own statement of
which lanes are active, never from launches.

`chain_macs`, `weight_bytes` and `bound` are frozen copies of
`chip_smoke.chain_macs`, `chip_smoke.weight_bytes` and `chip_smoke.bound`,
taking the decoder's sizes instead of a packed decoder: the forward chain
reads in_dim -> D, then n_mid D x D layers (the latent_in layer's input is
D wide again), then D -> 1.
"""

from __future__ import annotations

from typing import Dict, Optional

H100_HBM_BYTES_S = 3.35e12          # HBM3, H100 SXM data sheet
PEAK_FLOPS = {                      # dense, H100 SXM data sheet, 700 W
    "f32": 67e12,                   # outside the tensor cores
    "bf16": 989e12,
    "fp8": 1979e12,
}
EL_BYTES = {"f32": 4, "bf16": 2, "fp8": 1}


def chain_macs(D: int, n_mid: int, in_dim: int):
    """Multiply-adds a row of the decoder forward and of its input-grad
    backward."""
    fwd = in_dim * D + n_mid * D * D + D
    bwd = D + n_mid * D * D + D * in_dim
    return fwd, bwd


def weight_bytes(D: int, n_mid: int, in_dim: int, prec: str) -> int:
    fwd, _ = chain_macs(D, n_mid, in_dim)
    return fwd * EL_BYTES[prec] + (D * (n_mid + 1) + 1) * 4


def bound(nbytes: float, flops: float, peak: float):
    """(bound ms, what bounds it) for the given bytes and operations."""
    t_bytes, t_ops = nbytes / H100_HBM_BYTES_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def decoder_sizes(dec_cfg: dict):
    dims = dec_cfg["dims"]
    return dims[0], len(dims) - 1, dec_cfg["code_length"] + 3


def family_work(kind: str, rec_work: list, dec_cfg: dict, prec: str) -> Optional[Dict[str, float]]:
    """Operations and bytes the traced window asked of one kernel family:
    `render` (B2: the forward over every sample of the valid rays of valid
    frames of the active lanes; the band backward is not counted, since the
    program does not expose the band), `sdf` (B1: forward and input-grad
    backward over the valid surface points of the active lanes), `retrieval`
    (B3: every code over every valid scoring point), `grid` (B4: every real
    fruit's code over the grid). None where the window asked for none."""
    if not rec_work:
        return None
    D, n_mid, in_dim = decoder_sizes(dec_cfg)
    fwd, bwd = chain_macs(D, n_mid, in_dim)
    w_bytes = weight_bytes(D, n_mid, in_dim, prec)
    flops = nbytes = 0.0
    for item in rec_work:
        if kind == "render":
            rays, M = item
            rows = float(rays) * M
            flops += 2.0 * fwd * rows
            nbytes += rows * 12 + float(rays) * 4 * 4 + w_bytes
        elif kind == "sdf":
            rows = float(item)
            flops += 2.0 * (fwd + bwd) * rows
            nbytes += rows * (2 * in_dim + 1) * 4 + w_bytes
        elif kind == "retrieval":
            codes, points = item
            rows = float(codes) * float(points)
            flops += 2.0 * fwd * rows
            nbytes += float(points) * 12 + codes * in_dim * 4 + w_bytes
        elif kind == "grid":
            codes, points = item
            rows = float(codes) * points
            flops += 2.0 * fwd * rows
            nbytes += points * 12 + rows * 4 + w_bytes
        else:
            raise ValueError(kind)
    ms, by = bound(nbytes, flops, PEAK_FLOPS[prec])
    return {"flops": flops, "bytes": nbytes, "bound_s": ms / 1e3, "bound_by": by}


def counted(ctx, kind: str) -> Optional[Dict[str, float]]:
    """`family_work` of one family in a traced run, at the configuration's
    precision for it. Raises where the window completed fruits whose solve
    or meshing needs the family and none of its work was counted: the
    program no longer calls what the recorder wraps, and a silent family
    would move the yardstick. (A kernel taken off the path is another
    matter: its work is still counted and its roofline reads nothing.)"""
    w = family_work(kind, ctx.rec.work[kind], ctx.config["decoder"], ctx.config["precision"][kind])
    needed = kind != "retrieval" or ctx.config["solver"]["init_mode"] == "retrieval"
    if w is None and needed and ctx.window.done:
        raise RuntimeError(f"no {kind} work was counted in a window of {len(ctx.window.done)} "
                           "fruits: the recorder's wrappers no longer see the program's calls")
    return w
