"""Batched Levenberg-Marquardt joint shape + pose optimization.

Counterpart of `hortimapping_tpu/optim/lm.py` for the fixed-lambda solver
and the two-resolution schedule. The JAX `vmap` over fruits is the leading
[B] axis of every tensor; its `lax.while_loop` with frozen lanes is a Python
loop that steps every lane until all are done or failed (one host sync per
iteration, for that test). Frozen lanes keep their state bit for bit.

The render term runs through the fused render kernel and the SDF term
through the fwd+input-grad kernel wherever the decoder is kernel-supported;
the device of the tensors decides between kernel (CUDA) and plain version
(CPU).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from hortimapping_tpu_torch.config import JointOptConfig
from hortimapping_tpu_torch.device import resolve_device
from hortimapping_tpu_torch.models.decoder import DecoderSpec, Params
from hortimapping_tpu_torch.ops import mlp_kernels
from hortimapping_tpu_torch.ops.lie import exp_se3, exp_sim3_ref, rotation_matrix_to_angle
from hortimapping_tpu_torch.ops.recon import sdf_residuals
from hortimapping_tpu_torch.ops.render import RenderConfig, render_residuals
from hortimapping_tpu_torch.ops.robust import huber_weights
from hortimapping_tpu_torch.optim.state import FruitObservations, OptResult, OptState, init_state


@dataclasses.dataclass(frozen=True)
class Packs:
    """Decoder weights packed once per solve: for the render route (bf16 or
    f32 per `fused_bf16`) and for the SDF term (f32)."""

    render: Optional[mlp_kernels.PackedDecoder]
    sdf: Optional[mlp_kernels.PackedDecoder]


def make_packs(params: Params, spec: DecoderSpec, cfg: JointOptConfig) -> Packs:
    if not mlp_kernels.supported(spec):
        return Packs(None, None)
    f32 = mlp_kernels.pack_params(params, spec, torch.float32)
    sdf = f32 if cfg.pallas_resolved(spec) else None
    if cfg.fused_resolved(spec) and cfg.fused_bf16:
        return Packs(mlp_kernels.pack_params(params, spec, torch.bfloat16), sdf)
    return Packs(f32, sdf)


def _render_config(cfg: JointOptConfig, spec: DecoderSpec) -> RenderConfig:
    return RenderConfig(
        scale_on=cfg.scale_on,
        log_occ_on=cfg.log_sdf_occ,
        occ_cutoff=cfg.occ_cutoff_m,
        occlusion_on=cfg.occlusion_on,
        use_pallas=cfg.pallas_resolved(spec),
        fused=cfg.fused_resolved(spec),
        fused_bf16=cfg.fused_bf16,
    )


def _robust_w2(res: torch.Tensor, th: float, active: torch.Tensor) -> torch.Tensor:
    """Huber w^2 where `active` (broadcast over res), else 1."""
    w = huber_weights(res, th)
    return torch.where(active, w * w, torch.ones_like(w))


def _term_normal_eq(jac, res, w2, count, weight: float):
    """Per lane: H = weight * sum(w2 J^T J)/count, b = -weight * sum(w2 J^T r)/count.
    jac [B, ..., D], res/w2 [B, ...], count [B]."""
    B, D = jac.shape[0], jac.shape[-1]
    count_safe = torch.clamp(count, min=1.0)[:, None]
    flat_j = jac.reshape(B, -1, D)
    flat_jw = (jac * w2[..., None]).reshape(B, -1, D)
    H = weight * (flat_jw.transpose(1, 2) @ flat_j) / count_safe[..., None]
    b = -weight * (flat_jw.transpose(1, 2) @ res.reshape(B, -1, 1))[..., 0] / count_safe
    return H, b


def _linspace(lo: torch.Tensor, hi: torch.Tensor, num: int) -> torch.Tensor:
    """`jnp.linspace(lo, hi, num)` along a new last axis, in its op order:
    lo * (1 - k/(num-1)) + hi * k/(num-1) for k < num-1, then hi exactly."""
    if num == 1:
        return lo[..., None]
    step = torch.arange(num - 1, dtype=lo.dtype, device=lo.device) / (num - 1)
    body = lo[..., None] * (1 - step) + hi[..., None] * step
    return torch.cat([body, hi[..., None]], dim=-1)


def render_geometry(cfg: JointOptConfig, obs: FruitObservations, T_ow: torch.Tensor,
                    cube_radius: float):
    """Per frame: camera -> object pose T_oc [B, F, 4, 4], the ray-marching
    depths [B, F, M] around the object centre and the object's bounding
    radius [B, F]."""
    cur_scale = torch.linalg.det(T_ow[:, :3, :3]) ** (-1.0 / 3.0)             # [B]
    # the exact inverse of the drifted T_oc (not the closed-form Sim(3)
    # transpose): LM updates drift T_ow off the manifold and the reference
    # inverts the drifted matrix exactly
    T_oc = T_ow[:, None] @ obs.T_wc
    T_co = torch.linalg.inv(T_oc)
    depth_range = (cube_radius * cur_scale)[:, None].expand(T_co.shape[:2])
    d_lo = T_co[..., 2, 3] - 1.0 * depth_range
    d_hi = T_co[..., 2, 3] + 0.8 * depth_range
    return T_oc, _linspace(d_lo, d_hi, cfg.n_sample_on_ray), depth_range


def _assemble_normal_equations(
    params: Params,
    spec: DecoderSpec,
    cfg: JointOptConfig,
    obs: FruitObservations,
    latent: torch.Tensor,       # [B, C]
    T_ow: torch.Tensor,         # [B, 4, 4]
    i: torch.Tensor,            # [B] int
    cube_radius: float,
    lane_active: Optional[torch.Tensor] = None,
    packs: Optional[Packs] = None,
):
    """Undamped (H [B, D, D], b [B, D]), `failed` [B] and the objective [B]."""
    if packs is None:
        packs = make_packs(params, spec, cfg)
    pose_dim = cfg.pose_dim
    B, C = latent.shape
    D = pose_dim + C
    f32 = torch.float32
    dev = latent.device

    # ---------------- I. render term over all frames ----------------
    rcfg = _render_config(cfg, spec)
    is_fg = torch.arange(cfg.n_rays, device=dev) < cfg.n_fg_pix
    T_oc, depths, depth_range = render_geometry(cfg, obs, T_ow, cube_radius)
    rr = render_residuals(
        params, spec, latent, obs.rays, is_fg, obs.ray_valid & obs.frame_valid[..., None],
        obs.depth_obs, T_oc, depths, depth_range, rcfg, lane_active, packs.render,
    )

    obs_count = rr.ray_ok.sum((1, 2)).to(f32)                                  # [B]
    failed = obs_count == 0.0

    robust_active = i >= cfg.robust_iter
    w2_d = _robust_w2(rr.res_d, cfg.render_robust_th_m, robust_active[:, None, None])
    H_d, b_d = _term_normal_eq(rr.jac_d, rr.res_d, w2_d, obs_count, cfg.w_depth)
    H_m, b_m = _term_normal_eq(rr.jac_m, rr.res_m, torch.ones_like(rr.res_m), obs_count, cfg.w_mask)

    # ---------------- II. sdf reconstruction term ----------------
    pts_o = obs.points_w @ T_ow[:, :3, :3].transpose(1, 2) + T_ow[:, None, :3, 3]
    rec = sdf_residuals(params, spec, latent, pts_o, obs.point_valid, cfg.scale_on, packs.sdf)
    recon_count = obs.point_valid.sum(-1).to(f32)
    w2_r = _robust_w2(rec.res, cfg.recon_robust_th_m, robust_active[:, None])
    H_r, b_r = _term_normal_eq(rec.jac, rec.res, w2_r, recon_count, cfg.w_recon)

    # ---------------- III. code regularizer ----------------
    code_mask = (torch.arange(D, device=dev) >= pose_dim).to(f32)
    H_c = torch.diag(cfg.w_codereg * code_mask)
    b_c = torch.cat([torch.zeros(B, pose_dim, dtype=f32, device=dev), -cfg.w_codereg * latent], 1)

    H = H_d + H_m + H_r + H_c
    if cfg.scale_on:
        H[:, pose_dim - 1, pose_dim - 1] += cfg.s_damp
    if cfg.yaw_damp > 0.0:
        H[:, 4, 4] += cfg.yaw_damp
    if cfg.rot_damp > 0.0:
        idx = torch.arange(3, 6, device=dev)
        H[:, idx, idx] += cfg.rot_damp
    b = b_d + b_m + b_r + b_c

    count_safe = torch.clamp(obs_count, min=1.0)
    rcount_safe = torch.clamp(recon_count, min=1.0)
    cost = (
        cfg.w_depth * (w2_d * rr.res_d * rr.res_d).sum((1, 2)) / count_safe
        + cfg.w_mask * (rr.res_m * rr.res_m).sum((1, 2)) / count_safe
        + cfg.w_recon * (w2_r * rec.res * rec.res).sum(1) / rcount_safe
        + cfg.w_codereg * (latent * latent).sum(1)
    )
    return H, b, failed, cost


def apply_lm_damping(H: torch.Tensor, cfg: JointOptConfig, lam: Optional[float] = None) -> torch.Tensor:
    """lambda * diag(H) added to H, or lambda * max(diag(H)) * I with `lm_eye`."""
    if not cfg.lm_on:
        return H
    lam = cfg.lm_lambda_0 if lam is None else lam
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    if cfg.lm_eye:
        eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
        return H + lam * diag.max(-1).values[:, None, None] * eye
    return H + lam * torch.diag_embed(diag)


def normal_equations(params, spec, cfg, obs, latent, T_ow, i, cube_radius,
                     lane_active=None, packs=None):
    """Damped normal equations (H, b) and `failed`, per lane."""
    H, b, failed, _ = _assemble_normal_equations(
        params, spec, cfg, obs, latent, T_ow, i, cube_radius, lane_active, packs)
    return apply_lm_damping(H, cfg), b, failed


def lm_iteration(params, spec, cfg, obs, state: OptState, cube_radius: float,
                 pose_known: bool, packs: Optional[Packs] = None) -> OptState:
    """One LM iteration for every lane (frozen lanes are restored by
    `_freeze_if_done`)."""
    pose_dim = cfg.pose_dim
    i = state.i
    latent, T_ow = state.latent, state.T_ow
    lane_active = ~(state.done | state.failed)

    H, b, failed = normal_equations(params, spec, cfg, obs, latent, T_ow, i, cube_radius,
                                    lane_active, packs)
    # solve_ex: a singular H (a lane with nothing observed) gives inf/nan
    # like jnp.linalg.solve instead of raising; such lanes are `failed`
    delta = torch.linalg.solve_ex(H, b[..., None])[0][..., 0]
    if pose_known:
        delta = delta.clone()
        delta[:, :6] = 0.0
    delta_p = delta[:, :pose_dim]
    delta_c = delta[:, pose_dim:]
    delta_T = exp_sim3_ref(delta_p) if cfg.scale_on else exp_se3(delta_p)
    T_new = delta_T @ T_ow
    latent_new = latent + delta_c

    scale_new = torch.linalg.det(T_new[:, :3, :3]) ** (-1.0 / 3.0)
    delta_scale = torch.linalg.det(delta_T[:, :3, :3]) ** (1.0 / 3.0)
    delta_tran = torch.linalg.norm(delta_T[:, :3, 3], dim=-1) * scale_new
    delta_rot = rotation_matrix_to_angle(delta_T[:, :3, :3] * scale_new[:, None, None]) * 180.0 / math.pi

    past_warmup = i > 1
    conv_g = (b.abs().max(-1).values < cfg.epsilon_g) & past_warmup
    conv_c = ((delta_c / (latent_new + 1e-12)).abs().max(-1).values < cfg.epsilon_c) & past_warmup
    # the reference compares delta_scale (a ratio ~= 1) with epsilon_s, so
    # this pose test never fires; kept literally for iteration-count parity
    conv_p = ((delta_tran < cfg.epsilon_t) & (delta_rot < cfg.epsilon_r)
              & (delta_scale < cfg.epsilon_s) & past_warmup)
    if pose_known:
        conv_p = torch.zeros_like(conv_p)
    conv = conv_g | conv_c | conv_p
    done = conv | (i >= cfg.max_iter - 1)

    # a failed iteration (no valid rays) leaves the estimate untouched and
    # ends the lane
    keep = failed
    return OptState(
        latent=torch.where(keep[:, None], latent, latent_new),
        T_ow=torch.where(keep[:, None, None], T_ow, T_new),
        i=torch.where(keep, i, i + 1),
        iter_count=torch.where(keep, state.iter_count, i + 1),
        done=done | keep,
        failed=keep,
        converged=torch.where(keep, state.converged, conv),
    )


def _freeze_if_done(old: OptState, new: OptState) -> OptState:
    """Lanes already done or failed keep their state bit for bit."""
    frozen = old.done | old.failed
    out = []
    for o, n in zip(old, new):
        f = frozen.reshape(frozen.shape + (1,) * (o.dim() - 1))
        out.append(torch.where(f, o, n))
    return OptState(*out)


def _solve_batched(params, spec, cfg, obs, s0: OptState, cube_radius, pose_known, packs):
    s = s0
    while bool((~(s.done | s.failed)).any()):
        new = lm_iteration(params, spec, cfg, obs, s, cube_radius, pose_known, packs)
        s = _freeze_if_done(s, new)
    return OptResult(s.latent, s.T_ow, s.iter_count, s.failed, s.converged)


def shape_pose_joint_opt_batched(
    params: Params,
    spec: DecoderSpec,
    cfg: JointOptConfig,
    obs: FruitObservations,   # leading fruit axis on every field
    latent0: torch.Tensor,    # [B, C]
    T_ow0: torch.Tensor,      # [B, 4, 4]
    cube_radius: float,
    pose_known: bool = False,
    device: str | torch.device = "cuda",
    packs: Optional[Packs] = None,
) -> OptResult:
    """All fruits of a submap in one batched LM solve; converged lanes
    freeze and the loop ends when the slowest lane finishes."""
    dev = resolve_device(device)
    cfg.check_ported()
    obs = FruitObservations(*(t.to(dev) for t in obs))
    latent0, T_ow0 = latent0.to(dev), T_ow0.to(dev)
    if packs is None:
        packs = make_packs(params, spec, cfg)
    return _solve_batched(params, spec, cfg, obs, init_state(latent0, T_ow0), cube_radius,
                          pose_known, packs)


def _subsample(obs: FruitObservations, cfg: JointOptConfig, stride: int, ray_frac: float,
               sample_frac: float, pts_frac: float) -> Tuple[FruitObservations, JointOptConfig]:
    """Every `stride`-th frame, the first fraction of the fg and bg ray
    blocks, the first fraction of the surface points, and a shape-consistent
    config."""
    n_fg = int(cfg.n_fg_pix * ray_frac)
    n_bg = int(cfg.n_bg_pix * ray_frac)
    n_pts = int(cfg.recon_n_pts * pts_frac)
    M = max(int(cfg.n_sample_on_ray * sample_frac), 2)
    F = (cfg.n_frame + stride - 1) // stride
    fg0 = cfg.n_fg_pix

    def rays_of(a):
        return torch.cat([a[:, ::stride, :n_fg], a[:, ::stride, fg0:fg0 + n_bg]], dim=2)

    sub_obs = FruitObservations(
        T_wc=obs.T_wc[:, ::stride],
        rays=rays_of(obs.rays),
        ray_valid=rays_of(obs.ray_valid),
        depth_obs=rays_of(obs.depth_obs),
        frame_valid=obs.frame_valid[:, ::stride],
        points_w=obs.points_w[:, :n_pts],
        point_valid=obs.point_valid[:, :n_pts],
    )
    sub_cfg = dataclasses.replace(
        cfg, n_fg_pix=n_fg, n_bg_pix=n_bg, n_frame=F, n_sample_on_ray=M,
        recon_n_pts=n_pts, coarse_to_fine=False,
    )
    return sub_obs, sub_cfg


def subsample_observations(obs: FruitObservations, cfg: JointOptConfig):
    """The coarse phase's observation buffers and config."""
    sub_obs, sub_cfg = _subsample(obs, cfg, cfg.coarse_frame_stride, cfg.coarse_ray_frac,
                                  cfg.coarse_sample_frac, cfg.coarse_pts_frac)
    coarse_cfg = dataclasses.replace(
        sub_cfg,
        max_iter=cfg.coarse_max_iter or cfg.max_iter,
        s_damp=cfg.coarse_s_damp or cfg.s_damp,
    )
    return sub_obs, coarse_cfg


def coarse_to_fine_joint_opt(
    params: Params,
    spec: DecoderSpec,
    cfg: JointOptConfig,
    obs: FruitObservations,
    latent0: torch.Tensor,
    T_ow0: torch.Tensor,
    cube_radius: float,
    pose_known: bool = False,
    device: str | torch.device = "cuda",
    packs: Optional[Packs] = None,
) -> OptResult:
    """Two-resolution batched solve: phase A on the subsampled problem,
    phase B (optionally subsampled too) from its result with the Huber
    kernel on from its first iteration. `iter_count` bills both phases."""
    dev = resolve_device(device)
    cfg.check_ported()
    obs = FruitObservations(*(t.to(dev) for t in obs))
    latent0, T_ow0 = latent0.to(dev), T_ow0.to(dev)
    if packs is None:
        packs = make_packs(params, spec, cfg)
    coarse_obs, coarse_cfg = subsample_observations(obs, cfg)
    r_a = _solve_batched(params, spec, coarse_cfg, coarse_obs, init_state(latent0, T_ow0),
                         cube_radius, pose_known, packs)
    fine_obs, fine_cfg = obs, cfg
    if (cfg.fine_frame_stride > 1 or cfg.fine_ray_frac < 1.0
            or cfg.fine_sample_frac < 1.0 or cfg.fine_pts_frac < 1.0):
        fine_obs, fine_cfg = _subsample(obs, cfg, cfg.fine_frame_stride, cfg.fine_ray_frac,
                                        cfg.fine_sample_frac, cfg.fine_pts_frac)
    fine_cfg = dataclasses.replace(
        fine_cfg, max_iter=cfg.fine_max_iter or cfg.max_iter, coarse_to_fine=False,
        robust_iter=0,
    )
    # failed coarse lanes restart the fine phase from the original init
    ff = r_a.failed.to(torch.float32)[:, None]
    lat1 = (1.0 - ff) * r_a.latent + ff * latent0
    T1 = (1.0 - ff[..., None]) * r_a.T_ow + ff[..., None] * T_ow0
    r_b = _solve_batched(params, spec, fine_cfg, fine_obs, init_state(lat1, T1),
                         cube_radius, pose_known, packs)
    return r_b._replace(iter_count=r_a.iter_count + r_b.iter_count)


def pack_result(res: OptResult) -> torch.Tensor:
    """[B, C+19]: latent | T_ow(16) | iters | failed | converged."""
    B = res.latent.shape[0]
    f32 = torch.float32
    return torch.cat(
        [
            res.latent.to(f32),
            res.T_ow.reshape(B, 16).to(f32),
            res.iter_count.to(f32)[:, None],
            res.failed.to(f32)[:, None],
            res.converged.to(f32)[:, None],
        ],
        dim=1,
    )
