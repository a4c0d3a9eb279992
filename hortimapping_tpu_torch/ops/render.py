"""Occlusion-aware depth/mask render residuals, batched over fruits and
frames.

Counterpart of `hortimapping_tpu/ops/render.py`: the dense masked [R, M]
path (the reference render loss as fixed-shape masked math), its compacted
two-pass form (`jac_cap` / `fwd_cap`) and the fused route through
`ops/render_kernel.fused_render` with its frame-level `min_valid_sample`
epilogue. Every array carries leading [B, F] axes (the JAX package vmaps a
per-frame function over both).

The compacted form keeps the first K flagged samples of each (lane, frame)
in index order: a sample's rank is `cumsum(mask) - 1`, the k-th kept sample
is found by a binary search of that cumsum, and results return to their
(r, m) slots by a gather at the rank. No sort, no scatter, no atomic, so
the route is deterministic; overflow drops the highest-index samples, as
JAX's `jnp.nonzero(size=K)` does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from hortimapping_tpu_torch.models.decoder import (
    DecoderSpec,
    Params,
    decoder_apply,
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
    jac_cap: int = 0                # dense route: 0 = dense Jacobians; > 0 = band budget a frame
    fwd_cap: int = 0                # with jac_cap: 0 = dense forward; > 0 = in-radius budget a frame
    fwd_bf16: bool = False          # with jac_cap: the forward pass in bf16
    use_pallas: bool = False        # dense route: decoder through the kernels (B1; B3 compacted)
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
    packed_fwd: Optional[mlp_kernels.PackedDecoder] = None,
    stats: Optional[dict] = None,
) -> RenderResiduals:
    """`packed`: the decoder packed for the route taken (bf16 or f32 per
    `cfg.fused_bf16` on the fused route, f32 on the dense one); `packed_fwd`:
    the compacted route's forward pack (bf16 or f32 per `cfg.fwd_bf16`).
    Each is packed here when needed and not given. With `stats` (a dict),
    the compacted route records per-(lane, frame) tensors: the band's size
    (`band`) and the samples it dropped (`band_overflow`), and with `fwd_cap`
    the in-radius samples (`in_radius`) and those left undecoded
    (`fwd_overflow`)."""
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
    B, F, R = ray_valid.shape
    N = R * M
    valid = (torch.linalg.norm(pts_obj, dim=-1) < bbx_radius[..., None, None]) & ray_valid[..., None]
    frame_ok = valid.sum((-2, -1)) >= cfg.min_valid_sample                     # [B, F]

    pallas_on = cfg.use_pallas and mlp_kernels.supported(spec)
    if pallas_on and packed is None:
        packed = mlp_kernels.pack_params(params, spec, f32)
    if cfg.jac_cap > 0:
        # pass 1, forward only: the dense grid, or its first K1 in-radius
        # samples (an undecoded sample reads sdf 1.0: outside the band and
        # the occupancy, as the out-of-radius ones are masked anyway)
        fwd_dtype = torch.bfloat16 if cfg.fwd_bf16 else f32
        if pallas_on and packed_fwd is None:
            packed_fwd = (packed if not cfg.fwd_bf16
                          else mlp_kernels.pack_params(params, spec, fwd_dtype))

        def forward(pts):
            rows = _rows(latent, pts)
            if pallas_on:
                return mlp_kernels.mlp_sdf(packed_fwd, rows)
            return decoder_apply(params, spec, rows, fwd_dtype)[..., 0]

        if cfg.fwd_cap > 0:
            flat_valid = valid.reshape(B, F, N)
            sel1, keep1, rank1 = first_k(flat_valid, min(cfg.fwd_cap, N))
            sdf1 = forward(_take_rows(pts_obj.reshape(B, F, N, 3), sel1))        # [B, F, K1]
            sdf = torch.where(keep1, torch.take_along_dim(sdf1, rank1, dim=-1), 1.0).reshape(B, F, R, M)
            if stats is not None:
                stats["in_radius"] = flat_valid.sum(-1)
                stats["fwd_overflow"] = (flat_valid & ~keep1).sum(-1)
        else:
            sdf = forward(pts_obj)
        dsdf_din = None   # pass 2 below, on the band samples alone
    else:
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

    w = sample_mask
    if cfg.jac_cap > 0:
        # pass 2: d sdf / d[code, xyz] (B1, f32) on the first K band samples
        # of each (lane, frame), gathered back to their (r, m) slots; the
        # dropped ones (overflow) carry no Jacobian, as in JAX
        flat_band = sample_mask.reshape(B, F, N)
        sel, keep, rank = first_k(flat_band, min(cfg.jac_cap, N))
        rows = _rows(latent, _take_rows(pts_obj.reshape(B, F, N, 3), sel))       # [B, F, K, C+3]
        if pallas_on:
            _, g_sel = mlp_kernels.mlp_sdf_and_input_grad(packed, rows)
        else:
            _, g_sel = decoder_sdf_and_input_grad(params, spec, rows)
        dsdf_din = torch.where(keep[..., None], torch.take_along_dim(g_sel, rank[..., None], dim=2),
                               0.0).reshape(B, F, R, M, C + 3)
        w = keep.reshape(B, F, R, M)
        if stats is not None:
            stats["band"] = flat_band.sum(-1)
            stats["band_overflow"] = (flat_band & ~keep).sum(-1)

    ds_dcode = dsdf_din[..., :C]
    ds_dx = dsdf_din[..., C:]
    if cfg.scale_on:
        dx_dT = points_to_pose_jacobian_sim3(pts_obj)
    else:
        dx_dT = points_to_pose_jacobian_se3(pts_obj)
    ds_dT = torch.einsum("...k,...kp->...p", ds_dx, dx_dT)                    # [B, F, R, M, P]
    w = w.to(f32)
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


def first_k(mask: torch.Tensor, K: int):
    """The first K True entries of each row of mask [..., N], in index
    order: (sel [..., K] their indices, N past the last one; keep [..., N]
    the entries kept; rank [..., N] each kept entry's slot in sel, clamped
    to [0, K) elsewhere). The k-th kept entry is where the cumsum of the
    mask first reaches k + 1."""
    cum = torch.cumsum(mask, dim=-1)
    rank = cum - 1
    keep = mask & (rank < K)
    targets = torch.arange(1, K + 1, device=mask.device).expand(mask.shape[:-1] + (K,))
    sel = torch.searchsorted(cum, targets.contiguous())
    return sel, keep, rank.clamp(0, K - 1)


def _take_rows(pts: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """pts [..., N, 3] at sel [..., K] (an index N reads the last point,
    whose result is never kept)."""
    return torch.take_along_dim(pts, sel.clamp(max=pts.shape[-2] - 1)[..., None], dim=-2)


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
