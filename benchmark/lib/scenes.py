"""Synthetic peppers: the scene generator and the seeded pools and requests
the traffic draws from.

`projection`, `sphere_trace` and `make_scene` are a frozen copy of
`hortimapping_tpu_torch/tools/synthetic.py` (`SyntheticCategory.projection`,
`_ellipsoid_sdf_np`, `sphere_trace`, `make_scene`): analytic ellipsoids whose
radii are base_radius * exp(P @ code), observed by cameras orbiting each
fruit. The copy is pure numpy and imports nothing of the program, so a later
change to the program cannot move the inputs. `tests/test_bench_scenes.py`
holds it to the program's generator bit for bit.
"""

from __future__ import annotations

from concurrent.futures import ProcessPoolExecutor
import multiprocessing
from typing import List, NamedTuple, Tuple

import numpy as np


class Observations(NamedTuple):
    """One fruit's observation buffers (field order of the program's
    `optim/state.FruitObservations`), numpy, no batch axis."""

    T_wc: np.ndarray          # [F, 4, 4]
    rays: np.ndarray          # [F, R, 3]
    ray_valid: np.ndarray     # [F, R] bool
    depth_obs: np.ndarray     # [F, R]
    frame_valid: np.ndarray   # [F] bool
    points_w: np.ndarray      # [P, 3]
    point_valid: np.ndarray   # [P] bool


def projection(code_length: int, proj_scale: float) -> np.ndarray:
    rng = np.random.default_rng(1234)
    P = rng.normal(size=(3, code_length)) / np.sqrt(code_length)
    return (P * proj_scale).astype(np.float32)


def _ellipsoid_sdf_np(x: np.ndarray, radii: np.ndarray) -> np.ndarray:
    k0 = np.linalg.norm(x / radii, axis=-1)
    k1 = np.linalg.norm(x / (radii * radii), axis=-1)
    k1 = np.where(k1 == 0.0, 1.0, k1)
    return np.where(k0 == 0.0, -np.min(radii), k0 * (k0 - 1.0) / k1)


def sphere_trace(origin, dirs, T_ow, radii, t0: float = 0.05, iters: int = 64):
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


def make_scene(proj, base_radius, code_gt, T_wo_gt, n_frames, n_fg, n_bg, n_points, seed=0,
               cam_distance=0.35, bg_depth=1.5, partial_view=True) -> Tuple[Observations, np.ndarray]:
    """Observations of one fruit and its full GT surface (4096 world points)."""
    rng = np.random.default_rng(seed)
    radii = base_radius * np.exp(proj @ np.asarray(code_gt))
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

    obs = Observations(
        T_wc=np.stack(T_wc).astype(np.float32),
        rays=np.stack(rays_all),
        ray_valid=np.stack(ray_valid),
        depth_obs=np.stack(depth_obs),
        frame_valid=np.asarray(frame_valid),
        points_w=points_w,
        point_valid=point_valid,
    )
    return obs, full_w.astype(np.float32)


class Scene(NamedTuple):
    obs: Observations
    gt: np.ndarray            # [4096, 3] world GT surface points
    T_wo: np.ndarray          # [4, 4] f64 object -> world


def scene_draws(scene_cfg: dict, code_length: int, n: int, seed: int):
    """The seeded draws of a pool of n fruits: (code [C], T_wo [4, 4], scene
    seed) each. Codes ~ N(0, code_sigma^2), centres ~ N(0, center_sigma_m^2)
    per axis, each scene's noise from its own seed."""
    rng = np.random.default_rng([seed, 0x5CE7E])
    out = []
    for _ in range(n):
        code = (rng.normal(size=code_length) * scene_cfg["code_sigma"]).astype(np.float32)
        T_wo = np.eye(4, dtype=np.float32)
        T_wo[:3, 3] = rng.normal(size=3) * scene_cfg["center_sigma_m"]
        out.append((code, T_wo, int(rng.integers(0, 2**31 - 1))))
    return out


def _one_scene(args):
    proj, sc, code, T_wo, s = args
    obs, gt = make_scene(proj, sc["base_radius"], code, T_wo, n_frames=sc["n_frames"],
                         n_fg=sc["n_fg"], n_bg=sc["n_bg"], n_points=sc["n_points"], seed=s)
    return Scene(obs, gt, T_wo.astype(np.float64))


def build_pool(scene_cfg: dict, code_length: int, n: int, seed: int, workers: int = 1) -> List[Scene]:
    """n scenes from `seed`, made in `workers` spawned processes (the draws
    are made here first, so the pool does not depend on the workers)."""
    proj = projection(code_length, scene_cfg["proj_scale"])
    jobs = [(proj, scene_cfg, c, T, s) for c, T, s in scene_draws(scene_cfg, code_length, n, seed)]
    if workers <= 1:
        return [_one_scene(j) for j in jobs]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as ex:
        return list(ex.map(_one_scene, jobs, chunksize=max(1, n // (4 * workers))))


class Request(NamedTuple):
    """One fruit to complete: a pool scene under a pose init offset by a
    few millimetres, so no two requests are the same input."""

    key: str
    scene: int                 # index into the pool
    T_ow0: np.ndarray          # [4, 4] f32 pose init (world -> object)


def make_requests(pool: List[Scene], n: int, offset_sigma_m: float, seed: int,
                  stream: int) -> List[Request]:
    """n requests over the pool from `seed`: scenes in seeded permutations of
    the pool, one after another, each with its centre offset by
    N(0, offset_sigma_m^2) per axis before the pose init is inverted."""
    rng = np.random.default_rng([seed, 0x0FF5E7, stream])
    order: List[int] = []
    while len(order) < n:
        order.extend(rng.permutation(len(pool)).tolist())
    offs = rng.normal(size=(n, 3)) * offset_sigma_m
    out = []
    for k in range(n):
        T = pool[order[k]].T_wo.copy()
        T[:3, 3] += offs[k]
        out.append(Request(f"r{stream}_{k:06d}", order[k], np.linalg.inv(T).astype(np.float32)))
    return out
