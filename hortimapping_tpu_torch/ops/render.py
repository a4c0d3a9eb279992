"""Occlusion-aware depth/mask render residuals, batched over fruits and
frames.

Counterpart of `hortimapping_tpu/ops/render.py`, in two routes: the fused
route through `ops/render_kernel.fused_render` with its frame-level
`min_valid_sample` epilogue, and the dense masked [R, M] route (the
reference render loss as fixed-shape masked math), the fused kernel's plain
version and the route of a decoder the kernel does not take. Every array
carries leading [B, F] axes (the JAX package vmaps a per-frame function
over both).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from hortimapping_tpu_torch.models.decoder import (
    DecoderSpec,
    Params,
    decoder_sdf_and_input_grad,
)
from hortimapping_tpu_torch.ops import mlp_kernels, render_kernel
from hortimapping_tpu_torch.ops.lie import (
    points_to_pose_jacobian_se3,
    points_to_pose_jacobian_sim3,
)
from hortimapping_tpu_torch.ops.sdf import (
    logistic_sigma,
    sdf_to_occupancy,
    sdf_to_occupancy_log,
)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    scale_on: bool = False          # Sim(3) (7-dof) vs SE(3) (6-dof) pose Jacobians
    log_occ_on: bool = False        # logistic vs linear sdf->occ conversion
    occ_cutoff: float = 0.01        # occupancy cutoff threshold [m]
    occlusion_on: bool = True       # drop potentially-occluded bg rays
    occlusion_th: float = 0.03      # [m]
    min_valid_sample: int = 100     # frame invalid below this many in-radius samples
    min_grad_th: float = 1e-6       # de/do cutoff
    use_pallas: bool = False        # dense route: decoder through the fwd+input-grad kernel (B1)
    fused: bool = False             # the fused render kernel
    fused_bf16: bool = True         # storage type inside the fused kernel

    @property
    def pose_dim(self) -> int:
        return 7 if self.scale_on else 6


def takes_fused(cfg: RenderConfig, spec: DecoderSpec) -> bool:
    """The fused route: asked for, a kernel-supported decoder, and the
    [pose | code] Jacobian within 128 columns (the JAX package's condition:
    its kernel packs that row into 128 lanes)."""
    return cfg.fused and mlp_kernels.supported(spec) and cfg.pose_dim + spec.code_length <= 128


class RenderResiduals(NamedTuple):
    """Per-ray outputs, [B, F, R]-shaped (Jacobians [B, F, R, pose_dim + C])."""

    res_d: torch.Tensor
    jac_d: torch.Tensor
    res_m: torch.Tensor
    jac_m: torch.Tensor
    ray_ok: torch.Tensor
    frame_ok: torch.Tensor  # [B, F]


def sample_points(rays: torch.Tensor, sampled_depths: torch.Tensor, T_oc: torch.Tensor) -> torch.Tensor:
    """Object-frame ray samples [B, F, R, M, 3] from cam-frame rays [B, F, R, 3],
    depths [B, F, M] and camera -> object poses [B, F, 4, 4]."""
    pts_cam = rays[..., :, None, :] * sampled_depths[..., None, :, None]
    A = T_oc[..., :3, :3]
    return (pts_cam @ A.transpose(-1, -2)[:, :, None]) + T_oc[..., None, None, :3, 3]


def render_residuals(
    params: Params,
    spec: DecoderSpec,
    latent: torch.Tensor,          # [B, C]
    rays: torch.Tensor,            # [B, F, R, 3] cam-frame ray directions, fg rows first
    is_fg: torch.Tensor,           # [R] bool
    ray_valid: torch.Tensor,       # [B, F, R] bool
    depth_obs: torch.Tensor,       # [B, F, R]
    T_oc: torch.Tensor,            # [B, F, 4, 4] camera -> object
    sampled_depths: torch.Tensor,  # [B, F, M]
    bbx_radius: torch.Tensor,      # [B, F]
    cfg: RenderConfig,
    lane_active: Optional[torch.Tensor] = None,  # [B] bool, False = frozen lane
    packed: Optional[mlp_kernels.PackedDecoder] = None,
) -> RenderResiduals:
    """`packed`: the decoder packed for the route taken (bf16 or f32 per
    `cfg.fused_bf16` on the fused route, f32 on the dense one), packed here
    when needed and not given."""
    M = sampled_depths.shape[-1]
    f32 = torch.float32
    pts_obj = sample_points(rays, sampled_depths, T_oc)                       # [B, F, R, M, 3]

    if takes_fused(cfg, spec) and M >= 2:
        if packed is None:
            packed = mlp_kernels.pack_params(
                params, spec, torch.bfloat16 if cfg.fused_bf16 else f32)
        return _render_residuals_fused(
            packed, latent, pts_obj, is_fg, ray_valid, depth_obs, sampled_depths,
            bbx_radius, cfg, lane_active,
        )

    C = spec.code_length
    valid = (torch.linalg.norm(pts_obj, dim=-1) < bbx_radius[..., None, None]) & ray_valid[..., None]
    frame_ok = valid.sum((-2, -1)) >= cfg.min_valid_sample                     # [B, F]

    pallas_on = cfg.use_pallas and mlp_kernels.supported(spec)
    if pallas_on and packed is None:
        packed = mlp_kernels.pack_params(params, spec, f32)
    inputs = _rows(latent, pts_obj)
    if pallas_on:
        sdf, dsdf_din = mlp_kernels.mlp_sdf_and_input_grad(packed, inputs)
    else:
        sdf, dsdf_din = decoder_sdf_and_input_grad(params, spec, inputs)

    if cfg.log_occ_on:
        sigma = logistic_sigma(cfg.occ_cutoff)
        occ_all = sdf_to_occupancy_log(sdf, sigma)
    else:
        occ_all = sdf_to_occupancy(sdf, cfg.occ_cutoff)
    occ = torch.where(valid, occ_all, torch.zeros_like(occ_all))
    with_grad = valid & (sdf > -cfg.occ_cutoff) & (sdf < cfg.occ_cutoff)

    d_min, d_max = sampled_depths[..., 0], sampled_depths[..., -1]
    delta_d = (d_max - d_min) / (M - 1)                                        # [B, F]
    d_term_bg = d_max + delta_d

    one_minus = 1.0 - occ
    acc_trans = torch.cumprod(one_minus, dim=-1)
    acc_aug = torch.cat([torch.ones_like(acc_trans[..., :1]), acc_trans[..., :-1]], dim=-1)
    term_prob = occ * acc_aug
    term_end = acc_trans[..., -1]
    occ_ray = term_prob.sum(-1)
    d_u = (sampled_depths[:, :, None, :] * term_prob).sum(-1) + d_term_bg[..., None] * term_end

    denom = torch.where(one_minus <= 0.0, torch.ones_like(one_minus), one_minus)
    suffix = torch.flip(torch.cumsum(torch.flip(acc_trans, [-1]), dim=-1), [-1])
    de_do = suffix * delta_d[..., None, None] / denom
    dm_do = term_end[..., None] / denom
    sample_mask = with_grad & (de_do > cfg.min_grad_th)
    if cfg.log_occ_on:
        do_ds = -occ * (1.0 - occ) / sigma
    else:
        do_ds = torch.full_like(occ, -1.0 / (2.0 * cfg.occ_cutoff))
    de_ds = de_do * do_ds
    dm_ds = dm_do * do_ds

    if cfg.occlusion_on:
        occluded = (~is_fg) & (depth_obs < d_u - cfg.occlusion_th) & (depth_obs > 0.0)
        sample_mask = sample_mask & ~occluded[..., None]

    ray_ok = sample_mask.any(-1) & frame_ok[..., None]
    target = torch.where(is_fg, depth_obs, d_term_bg[..., None])
    zero = torch.zeros_like(d_u)
    res_d = torch.where(ray_ok, target - d_u, zero)
    res_m = torch.where(ray_ok, occ_ray - is_fg.to(f32), zero)

    ds_dcode = dsdf_din[..., :C]
    ds_dx = dsdf_din[..., C:]
    if cfg.scale_on:
        dx_dT = points_to_pose_jacobian_sim3(pts_obj)
    else:
        dx_dT = points_to_pose_jacobian_se3(pts_obj)
    ds_dT = torch.einsum("...k,...kp->...p", ds_dx, dx_dT)                    # [B, F, R, M, P]
    w = sample_mask.to(f32)
    jac_d = torch.cat([torch.einsum("...m,...mp->...p", w * de_ds, ds_dT),
                       torch.einsum("...m,...mc->...c", w * de_ds, ds_dcode)], dim=-1)
    jac_m = torch.cat([torch.einsum("...m,...mp->...p", w * dm_ds, ds_dT),
                       torch.einsum("...m,...mc->...c", w * dm_ds, ds_dcode)], dim=-1)
    okf = ray_ok.to(f32)[..., None]
    return RenderResiduals(res_d, jac_d * okf, res_m, jac_m * okf, ray_ok, frame_ok)


def _rows(latent: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Decoder rows [code | xyz] of points pts [B, ..., 3] under each lane's
    code of latent [B, C]."""
    lat = latent.reshape((latent.shape[0],) + (1,) * (pts.dim() - 2) + latent.shape[1:])
    return torch.cat([lat.expand(pts.shape[:-1] + latent.shape[1:]), pts], dim=-1)


def _render_residuals_fused(
    packed: mlp_kernels.PackedDecoder,
    latent: torch.Tensor,
    pts_obj: torch.Tensor,
    is_fg: torch.Tensor,
    ray_valid: torch.Tensor,
    depth_obs: torch.Tensor,
    sampled_depths: torch.Tensor,
    bbx_radius: torch.Tensor,
    cfg: RenderConfig,
    lane_active: Optional[torch.Tensor] = None,
) -> RenderResiduals:
    """Fused route + the frame-level epilogue: the `min_valid_sample` gate
    needs every ray of a frame, so it stays here."""
    jd, jm, res = render_kernel.fused_render(
        packed, latent, pts_obj, depth_obs, is_fg, ray_valid, sampled_depths, bbx_radius,
        lane_active,
        pose_dim=cfg.pose_dim, scale_on=cfg.scale_on, log_occ_on=cfg.log_occ_on,
        occ_cutoff=cfg.occ_cutoff, occlusion_on=cfg.occlusion_on,
        occlusion_th=cfg.occlusion_th, min_grad_th=cfg.min_grad_th,
    )
    frame_ok = res[..., 3].sum(-1) >= cfg.min_valid_sample                   # [B, F]
    gate = frame_ok.to(torch.float32)
    res_d = res[..., 0] * gate[..., None]
    res_m = res[..., 1] * gate[..., None]
    ray_ok = (res[..., 2] > 0.5) & frame_ok[..., None]
    return RenderResiduals(res_d, jd * gate[..., None, None], res_m, jm * gate[..., None, None],
                           ray_ok, frame_ok)
