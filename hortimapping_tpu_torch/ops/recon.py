"""SDF reconstruction residuals on the observed surface points (counterpart
of `hortimapping_tpu/ops/recon.py`), batched over fruits.

Given the decoder packed in f32, the decoder forward + input gradient goes
through `ops/mlp_kernels.mlp_sdf_and_input_grad` (the fwd+input-grad kernel
on the card); otherwise through autograd in `models/decoder.py`. Lanes that
`lane_active` marks frozen come out zero (the kernel skips them), as the
render term's do.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from hortimapping_tpu_torch.models.decoder import DecoderSpec, Params, decoder_sdf_and_input_grad
from hortimapping_tpu_torch.ops import mlp_kernels


class SdfResiduals(NamedTuple):
    res: torch.Tensor        # [B, N]
    jac: torch.Tensor        # [B, N, pose_dim + C] (pose block first)
    point_ok: torch.Tensor   # [B, N] bool


def sdf_residuals(
    params: Params,
    spec: DecoderSpec,
    latent: torch.Tensor,       # [B, C]
    pts_obj: torch.Tensor,      # [B, N, 3] surface points in object frame
    point_valid: torch.Tensor,  # [B, N] bool
    scale_on: bool,
    packed: Optional[mlp_kernels.PackedDecoder] = None,  # f32 packing for the kernel
    lane_active: Optional[torch.Tensor] = None,  # [B] bool; False zeroes the lane
) -> SdfResiduals:
    B, N, _ = pts_obj.shape
    C = spec.code_length
    inputs = torch.cat([latent[:, None, :].expand(B, N, C), pts_obj], dim=-1)
    if packed is not None:
        sdf, g = mlp_kernels.mlp_sdf_and_input_grad(packed, inputs, lane_active)
    else:
        sdf, g = decoder_sdf_and_input_grad(params, spec, inputs)
        if lane_active is not None:
            act = lane_active.reshape(B, 1)
            sdf = torch.where(act, sdf, torch.zeros_like(sdf))
            g = torch.where(act[..., None], g, torch.zeros_like(g))
    g_code, g_xyz = g[..., :C], g[..., C:]
    cols = [g_xyz, torch.linalg.cross(pts_obj, g_xyz, dim=-1)]
    if scale_on:
        cols.append((g_xyz * pts_obj).sum(-1, keepdim=True))
    okf = point_valid.to(torch.float32)
    jac = torch.cat(cols + [g_code], dim=-1) * okf[..., None]
    return SdfResiduals(sdf * okf, jac, point_valid)
