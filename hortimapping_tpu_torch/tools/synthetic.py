"""Synthetic fruit world (counterpart of `hortimapping_tpu/tools/synthetic.py`):
the analytic ellipsoid category the synthetic decoders are trained on, the
trainer that fits a decoder to it, and the scene generator the bench batch
is built from. Radii = base_radius * exp(P @ code) for a fixed random
projection P, so code 0 is a sphere of `base_radius` and codes within +-1
deform it by ~+-20 %.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from hortimapping_tpu_torch.device import resolve_device
from hortimapping_tpu_torch.models.decoder import (
    DecoderSpec,
    Params,
    decoder_apply,
    init_decoder_params,
)
from hortimapping_tpu_torch.optim.state import FruitObservations


@dataclasses.dataclass(frozen=True)
class SyntheticCategory:
    spec: DecoderSpec
    base_radius: float = 0.05
    proj_scale: float = 0.2

    def projection(self) -> np.ndarray:
        rng = np.random.default_rng(1234)
        P = rng.normal(size=(3, self.spec.code_length)) / np.sqrt(self.spec.code_length)
        return (P * self.proj_scale).astype(np.float32)


def ellipsoid_radii(code: torch.Tensor, proj: torch.Tensor, base_radius: float) -> torch.Tensor:
    """Radii (..., 3) of the ellipsoid of each code (..., C)."""
    return base_radius * torch.exp((proj @ code[..., None])[..., 0])


def ellipsoid_sdf(x: torch.Tensor, radii: torch.Tensor) -> torch.Tensor:
    """Approximate ellipsoid SDF k0 (k0 - 1) / k1 of points x (..., 3) under
    radii broadcast against them; exact on spheres, a small relative error
    at mild aspect ratios (a training target)."""
    k0 = torch.linalg.norm(x / radii, dim=-1)
    k1 = torch.linalg.norm(x / (radii * radii), dim=-1)
    k1 = torch.where(k1 == 0.0, torch.ones_like(k1), k1)
    return torch.where(k0 == 0.0, -radii.amin(dim=-1), k0 * (k0 - 1.0) / k1)


def _draw_synthetic_step(generator: torch.Generator, batch: int, code_length: int,
                         extent: float, device: torch.device):
    """One step's draws, in the JAX trainer's order: codes ~ N(0, 0.5^2)
    (batch, C), points uniform in the box of half-width `extent` (batch, 3),
    unnormalised surface directions (batch, 3) and relative radial noise ~
    N(0, 0.01^2) (batch, 1)."""
    codes = torch.randn(batch, code_length, generator=generator, device=device) * 0.5
    x_uni = torch.rand(batch, 3, generator=generator, device=device) * (2.0 * extent) - extent
    dirs = torch.randn(batch, 3, generator=generator, device=device)
    noise = torch.randn(batch, 1, generator=generator, device=device) * 0.01
    return codes, x_uni, dirs, noise


def synthetic_batch(generator: torch.Generator, cat: SyntheticCategory, proj: torch.Tensor,
                    batch: int, sample_extent: float = 2.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch drawn as the trainer draws it, on `proj`'s device: inputs
    (batch, C + 3) = code | xyz and their clamped analytic SDF (batch,).
    Even rows are uniform within `sample_extent * base_radius` of the
    origin, odd rows near the surface."""
    dev = proj.device
    codes, x_uni, dirs, noise = _draw_synthetic_step(
        generator, batch, cat.spec.code_length, sample_extent * cat.base_radius, dev)
    radii = ellipsoid_radii(codes, proj, cat.base_radius)
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    even = (torch.arange(batch, device=dev) % 2 == 0)[:, None]
    x = torch.where(even, x_uni, dirs * radii * (1.0 + noise))
    clamp = cat.spec.clamping_distance
    return torch.cat([codes, x], dim=-1), ellipsoid_sdf(x, radii).clamp(-clamp, clamp)


def warmup_cosine_lr(step: int, peak: float, warmup: int, total: int, end: float) -> float:
    """optax's `warmup_cosine_decay_schedule(0, peak, warmup, total, end)` at
    `step`: linear from 0 over `warmup` steps, then a cosine from `peak` to
    `end` over the remaining `total - warmup`."""
    if step < warmup:
        return (0.0 - peak) * (1.0 - step / warmup) + peak
    alpha = end / peak
    t = min(step - warmup, total - warmup)
    return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / (total - warmup))) + alpha)


def train_synthetic_decoder(
    cat: SyntheticCategory,
    seed: int = 0,
    steps: int = 1500,
    batch: int = 4096,
    lr: float = 1e-3,
    sample_extent: float = 2.5,
    device: str | torch.device = "cuda",
) -> Tuple[Params, np.ndarray]:
    """Fit the decoder to the analytic ellipsoid family: mean squared error
    against the clamped SDF of `synthetic_batch`es, gradients clipped to
    global norm 1 (optax's formula: g / ||g|| above 1, no epsilon), Adam
    under a warmup-cosine lr whose first step is 0 (it fills the moments and
    moves nothing). Returns (params, projection)."""
    dev = resolve_device(device)
    spec = cat.spec
    proj_np = cat.projection()
    proj = torch.as_tensor(proj_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_decoder_params(spec, gen, dev)
    leaves = [p[k].requires_grad_(True) for p in params.values() for k in ("w", "b")]
    opt = torch.optim.Adam(leaves, lr=0.0)
    warmup = min(200, steps // 10)

    for s in range(steps):
        inputs, target = synthetic_batch(gen, cat, proj, batch, sample_extent)
        pred = decoder_apply(params, spec, inputs)[..., 0]
        loss = torch.mean((pred - target) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        grads = [p.grad for p in leaves]
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        denom = torch.where(g_norm < 1.0, torch.ones_like(g_norm), g_norm)
        for g in grads:
            g.div_(denom)
        opt.param_groups[0]["lr"] = warmup_cosine_lr(s, lr, warmup, steps, lr * 1e-2)
        opt.step()
    return {k: {kk: v.detach() for kk, v in p.items()} for k, p in params.items()}, proj_np


def _ellipsoid_sdf_np(x: np.ndarray, radii: np.ndarray) -> np.ndarray:
    """Approximate ellipsoid SDF k0 (k0 - 1) / k1 (exact on spheres)."""
    k0 = np.linalg.norm(x / radii, axis=-1)
    k1 = np.linalg.norm(x / (radii * radii), axis=-1)
    k1 = np.where(k1 == 0.0, 1.0, k1)
    return np.where(k0 == 0.0, -np.min(radii), k0 * (k0 - 1.0) / k1)


def sphere_trace(
    origin: np.ndarray,       # (3,) world
    dirs: np.ndarray,         # (N, 3) unit, world
    T_ow: np.ndarray,         # (4, 4) world -> object (Sim(3), scale s)
    radii: np.ndarray,        # (3,)
    t0: float = 0.05,
    iters: int = 64,
) -> Tuple[np.ndarray, np.ndarray]:
    """March rays against the analytic ellipsoid: (t_hit, hit_mask)."""
    R, t = T_ow[:3, :3], T_ow[:3, 3]
    s = np.linalg.det(R) ** (1.0 / 3.0)
    tt = np.full(dirs.shape[0], t0)
    for _ in range(iters):
        x_o = (origin + tt[:, None] * dirs) @ R.T + t
        tt = tt + _ellipsoid_sdf_np(x_o, radii) / s
    x_o = (origin + tt[:, None] * dirs) @ R.T + t
    d_final = np.abs(_ellipsoid_sdf_np(x_o, radii))
    hit = (d_final < 1e-4 * max(1.0, 1.0 / s)) & (tt > 0) & (tt < 10.0)
    return tt, hit


def make_scene(
    cat: SyntheticCategory,
    code_gt: np.ndarray,
    T_wo_gt: np.ndarray,          # (4, 4) object -> world (Sim(3))
    n_frames: int,
    n_fg: int,
    n_bg: int,
    n_points: int,
    seed: int = 0,
    cam_distance: float = 0.35,
    bg_depth: float = 1.5,
    partial_view: bool = True,
) -> Tuple[FruitObservations, np.ndarray]:
    """Observations of one synthetic fruit (numpy fields, no batch axis;
    `optim/state.stack_observations` batches them) and the full GT surface
    (4096 world points) for metrics. Cameras orbit the object at
    `cam_distance` looking at its centre; fg rays hit the analytic surface,
    bg rays miss and see `bg_depth`; surface points cover the (optionally
    half-) visible surface."""
    rng = np.random.default_rng(seed)
    proj = cat.projection()
    radii = cat.base_radius * np.exp(proj @ np.asarray(code_gt))
    T_ow_gt = np.linalg.inv(T_wo_gt)
    center_w = T_wo_gt[:3, 3]
    R_total = n_fg + n_bg

    T_wc, rays_all, ray_valid, depth_obs, frame_valid = [], [], [], [], []
    for f in range(n_frames):
        ang = 2 * np.pi * f / max(n_frames, 1) + 0.3
        cam_pos = center_w + cam_distance * np.array(
            [np.cos(ang), 0.25 * np.sin(2 * ang), np.sin(ang)]
        )
        zc = center_w - cam_pos
        zc = zc / np.linalg.norm(zc)
        up = np.array([0.0, 1.0, 0.0])
        xc = np.cross(up, zc)
        xc = xc / np.linalg.norm(xc)
        yc = np.cross(zc, xc)
        T = np.eye(4)
        T[:3, 0], T[:3, 1], T[:3, 2], T[:3, 3] = xc, yc, zc, cam_pos

        dirs_o = rng.normal(size=(n_fg * 3, 3))
        dirs_o /= np.linalg.norm(dirs_o, axis=-1, keepdims=True)
        surf_w = (dirs_o * radii) @ T_wo_gt[:3, :3].T + T_wo_gt[:3, 3]
        d_w = surf_w - cam_pos
        d_w /= np.linalg.norm(d_w, axis=-1, keepdims=True)
        t_hit, hit = sphere_trace(cam_pos, d_w, T_ow_gt, radii)
        d_w, t_hit = d_w[hit][:n_fg], t_hit[hit][:n_fg]
        n_fg_actual = d_w.shape[0]

        off = rng.normal(size=(n_bg * 4, 3)) * 0.35
        d_bg = (center_w - cam_pos)[None, :] / cam_distance + off
        d_bg /= np.linalg.norm(d_bg, axis=-1, keepdims=True)
        _, hit_bg = sphere_trace(cam_pos, d_bg, T_ow_gt, radii)
        d_bg = d_bg[~hit_bg][:n_bg]
        n_bg_actual = d_bg.shape[0]

        R_cw = T[:3, :3].T
        rays_f = np.zeros((R_total, 3), np.float32)
        valid_f = np.zeros(R_total, bool)
        depth_f = np.zeros(R_total, np.float32)
        if n_fg_actual:
            rc = d_w @ R_cw.T
            zs = rc[:, 2:3]
            rays_f[:n_fg_actual] = rc / zs
            depth_f[:n_fg_actual] = t_hit * zs[:, 0]
            valid_f[:n_fg_actual] = True
        if n_bg_actual:
            rb = d_bg @ R_cw.T
            zs = rb[:, 2:3]
            rays_f[n_fg:n_fg + n_bg_actual] = rb / zs
            depth_f[n_fg:n_fg + n_bg_actual] = bg_depth
            valid_f[n_fg:n_fg + n_bg_actual] = True

        T_wc.append(T.astype(np.float32))
        rays_all.append(rays_f)
        ray_valid.append(valid_f)
        depth_obs.append(depth_f)
        frame_valid.append(True)

    dirs_o = rng.normal(size=(n_points * 2, 3))
    dirs_o /= np.linalg.norm(dirs_o, axis=-1, keepdims=True)
    dirs_o = dirs_o[dirs_o[:, 2] < 0.3][:n_points] if partial_view else dirs_o[:n_points]
    n_actual = dirs_o.shape[0]
    pts_w = (dirs_o * radii) @ T_wo_gt[:3, :3].T + T_wo_gt[:3, 3]
    points_w = np.zeros((n_points, 3), np.float32)
    points_w[:n_actual] = pts_w
    point_valid = np.arange(n_points) < n_actual

    dirs_full = np.random.default_rng(seed + 1).normal(size=(4096, 3))
    dirs_full /= np.linalg.norm(dirs_full, axis=-1, keepdims=True)
    full_w = (dirs_full * radii) @ T_wo_gt[:3, :3].T + T_wo_gt[:3, 3]

    obs = FruitObservations(
        T_wc=np.stack(T_wc).astype(np.float32),
        rays=np.stack(rays_all),
        ray_valid=np.stack(ray_valid),
        depth_obs=np.stack(depth_obs),
        frame_valid=np.asarray(frame_valid),
        points_w=points_w,
        point_valid=point_valid,
    )
    return obs, full_w.astype(np.float32)
