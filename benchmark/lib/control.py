"""The control of the check: the plain reference put in the place of the
program's four kernels and of its normal equations' algebra, each computed
one precision below the one the configuration states (f32 -> bf16,
bf16 -> fp8). Its answers must come out not correct; the readings it gives
set the upper end of each limit. Never used by a benchmark run: by
`control.py` on the chip and by the tests on the CPU.

The algebra is lowered where each solver assembles its normal equations:
the fixed-lambda iteration through `lm.normal_equations` (damped H and b),
the trust region's, which calls `lm._assemble_normal_equations` itself,
there (undamped H and b; it damps them by each lane's lambda).
"""

from __future__ import annotations

import torch

from lib import reference as R

LOWER = {"f32": "bf16", "bf16": "fp8"}


def lowered(precision: dict) -> dict:
    return {k: LOWER[v] for k, v in precision.items()}


def install(dec: R.Decoder, precision: dict, trust_region: bool = False):
    """Patch the kernels' entry points for the rest of the process; returns
    the undo list. `precision`: the lowered precision of each part;
    `trust_region`: the configuration's solver."""
    from hortimapping_tpu_torch.ops import mlp_kernels, render_kernel
    from hortimapping_tpu_torch.optim import lm

    p = precision
    undo = []

    def patch(owner, name, fn):
        undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, fn)

    def fwd_grad(pk, inputs, lane_active=None):
        lead = inputs.shape[:-1]
        s, g = dec.forward_grad(inputs.reshape(-1, inputs.shape[-1]).float(), p["sdf"])
        s, g = s.reshape(lead), g.reshape(lead + (inputs.shape[-1],))
        if lane_active is not None:
            act = lane_active.reshape((-1,) + (1,) * (len(lead) - 1))
            s = torch.where(act, s, torch.zeros_like(s))
            g = torch.where(act[..., None], g, torch.zeros_like(g))
        return s, g

    def fwd(pk, inputs):
        return dec.forward_blocks(inputs.reshape(-1, inputs.shape[-1]).float(),
                                  p["retrieval"]).reshape(inputs.shape[:-1])

    def shared(pk, latents, pts):
        B, N = latents.shape[0], pts.shape[0]
        x = torch.cat([latents[:, None, :].expand(B, N, latents.shape[1]),
                       pts[None].expand(B, N, 3)], dim=-1)
        return dec.forward_blocks(x.reshape(-1, x.shape[-1]).float(), p["grid"]).reshape(B, N)

    def render(pk, latent, pts, depth_obs, is_fg, ray_valid, depths, bbx_radius, lane_active=None,
               **kw):
        rr = R.render_rays(dec, latent, pts, depth_obs, is_fg, ray_valid, depths, bbx_radius, kw,
                           p["render"])
        res = torch.stack([rr.res_d, rr.res_m, rr.ray_ok.float(), rr.count], dim=-1)
        jd, jm = rr.jac_d, rr.jac_m
        if lane_active is not None:
            act = lane_active.reshape(-1, 1, 1, 1)
            jd, jm = torch.where(act, jd, 0.0), torch.where(act, jm, 0.0)
            res = torch.where(act, res, 0.0)
        return jd, jm, res

    orig_ne = lm.normal_equations

    def normal_equations(*a, **k):
        H, b, failed = orig_ne(*a, **k)
        return R._round(H, p["algebra"]), R._round(b, p["algebra"]), failed

    patch(mlp_kernels, "mlp_sdf_and_input_grad", fwd_grad)
    patch(mlp_kernels, "mlp_sdf", fwd)
    patch(mlp_kernels, "mlp_sdf_shared_latent", shared)
    patch(render_kernel, "fused_render", render)
    patch(lm, "normal_equations", normal_equations)
    if trust_region:
        orig_asm = lm._assemble_normal_equations

        def assemble(*a, **k):
            H, b, failed, cost = orig_asm(*a, **k)
            return R._round(H, p["algebra"]), R._round(b, p["algebra"]), failed, cost

        patch(lm, "_assemble_normal_equations", assemble)
    return undo


def uninstall(undo) -> None:
    for owner, name, fn in reversed(undo):
        setattr(owner, name, fn)
