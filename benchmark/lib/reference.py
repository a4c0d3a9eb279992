"""The plain reference: what the timed path computes, written out in plain
PyTorch from the method's equations, with its own decoder loaded from the
raw checkpoint. It imports nothing of the program and takes nothing the
program made: weights, packed streams, subsampled observations and pose
geometry are worked out again here.

Pieces, each in the precision it is given (`f32`, `bf16` or `fp8`: a lower
one rounds every matmul operand to that type and accumulates in f32, which
is how the control puts a cheaper arithmetic in the program's place):
  * the DeepSDF decoder (latent_in skip, tanh output) and its input gradient;
  * retrieval scores: mean |clamped sdf| of every code over a point set,
    and the grid of candidate scales;
  * the LM's views of a fruit (coarse and fine subsamples) and its normal
    equations: the occlusion-aware depth/mask render term over the dense
    [rays x samples] grid, the SDF term on the surface points, the code
    prior, the damping (the fixed lambda, or one a lane); the step, its
    Sim(3) update (`exp_sim3_ref`, the
    original method's own update with its quirk, copied from
    `hortimapping_tpu_torch/ops/lie.py`);
  * the distance of mesh vertices to the decoder's zero level set.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

def _round(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f32":
        return x
    if prec == "bf16":
        return x.to(torch.bfloat16).float()
    if prec == "fp8":
        return x.to(torch.float8_e4m3fn).float()
    raise ValueError(f"unknown precision {prec!r}")


def pin_f32() -> None:
    """f32 means f32: no TF32 in any matmul the reference runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Decoder:
    """The DeepSDF decoder of a checkpoint: concat(code, xyz) through
    len(dims) ReLU layers and a tanh output, the input concatenated again
    before each `latent_in` layer (weights stored [in, out], weight norm
    already folded in the raw file)."""

    def __init__(self, ckpt_path: str, dims, latent_in, clamping_distance: float, device):
        with np.load(ckpt_path) as z:
            n = len(dims) + 1
            self.w = [torch.as_tensor(z[f"lin{l}.w"], dtype=torch.float32).to(device) for l in range(n)]
            self.b = [torch.as_tensor(z[f"lin{l}.b"], dtype=torch.float32).to(device) for l in range(n)]
        self.latent_in = tuple(latent_in)
        self.clamp = float(clamping_distance)

    def forward(self, x: torch.Tensor, prec: str = "f32") -> torch.Tensor:
        """x [N, C+3] -> tanh sdf [N]."""
        h = x
        last = len(self.w) - 1
        for l, (w, b) in enumerate(zip(self.w, self.b)):
            if l in self.latent_in:
                h = torch.cat([h, x], dim=-1)
            h = _round(h, prec) @ _round(w, prec) + b
            if l < last:
                h = torch.relu(h)
        return torch.tanh(h)[:, 0]

    def forward_grad(self, x: torch.Tensor, prec: str = "f32", block: int = 1 << 17):
        """(sdf [N], d sdf / d x [N, C+3]), in blocks of rows."""
        sdf, grad = [], []
        for lo in range(0, x.shape[0], block):
            with torch.enable_grad():
                xi = x[lo:lo + block].detach().requires_grad_(True)
                s = self.forward(xi, prec)
                (g,) = torch.autograd.grad(s.sum(), xi)
            sdf.append(s.detach())
            grad.append(g)
        if not sdf:
            return x.new_zeros(0), x.new_zeros(0, x.shape[1])
        return torch.cat(sdf), torch.cat(grad)

    def forward_blocks(self, x: torch.Tensor, prec: str = "f32", block: int = 1 << 18):
        with torch.no_grad():
            return torch.cat([self.forward(x[lo:lo + block], prec)
                              for lo in range(0, x.shape[0], block)]) if x.shape[0] else x.new_zeros(0)


def load_decoder(root: str, dec_cfg: dict, device) -> Decoder:
    return Decoder(os.path.join(root, dec_cfg["asset"], "native", "latest.npz"), dec_cfg["dims"],
                   dec_cfg["latent_in"], dec_cfg["clamping_distance"], device)


def scale_grid(scale_min: float, scale_max: float, n_scales: int) -> torch.Tensor:
    """The candidate scales of retrieval: n_scales evenly from scale_min to
    scale_max (f32, [S])."""
    return torch.linspace(scale_min, scale_max, n_scales, dtype=torch.float64).float()


def score_codes(dec: Decoder, codes: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor,
                prec: str = "f32", block_rows: int = 1 << 20) -> torch.Tensor:
    """Mean |sdf| clamped at the clamping distance of every code [N, C]
    over each point set pts [G, P, 3] (valid [G, P]): [G, N]."""
    N, C = codes.shape
    G, P, _ = pts.shape
    count = valid.sum(-1).clamp(min=1).float()
    nb = max(1, block_rows // (G * P))
    out = []
    for lo in range(0, N, nb):
        blk = codes[lo:lo + nb]
        x = torch.cat([blk[None, :, None, :].expand(G, blk.shape[0], P, C),
                       pts[:, None].expand(G, blk.shape[0], P, 3)], dim=-1).reshape(-1, C + 3)
        s = dec.forward_blocks(x, prec).reshape(G, blk.shape[0], P)
        err = s.abs().clamp(max=dec.clamp)
        out.append((err * valid[:, None, :]).sum(-1) / count[:, None])
    return torch.cat(out, dim=1)


# ---------------------------------------------------------------- the LM's views

class View(NamedTuple):
    """One LM phase's observations of a batch of lanes (torch, leading [B])
    and the settings of that phase."""

    T_wc: torch.Tensor
    rays: torch.Tensor
    ray_valid: torch.Tensor
    depth_obs: torch.Tensor
    frame_valid: torch.Tensor
    points_w: torch.Tensor
    point_valid: torch.Tensor
    cfg: dict


def _subsample(obs: List[torch.Tensor], cfg: dict, stride: int, ray_frac: float, sample_frac: float,
               pts_frac: float):
    T_wc, rays, ray_valid, depth_obs, frame_valid, points_w, point_valid = obs
    n_fg = int(cfg["n_fg_pix"] * ray_frac)
    n_bg = int(cfg["n_bg_pix"] * ray_frac)
    n_pts = int(cfg["recon_n_pts"] * pts_frac)
    M = max(int(cfg["n_sample_on_ray"] * sample_frac), 2)
    F = (cfg["n_frame"] + stride - 1) // stride
    fg0 = cfg["n_fg_pix"]

    def rays_of(a):
        return torch.cat([a[:, ::stride, :n_fg], a[:, ::stride, fg0:fg0 + n_bg]], dim=2)

    sub = [T_wc[:, ::stride], rays_of(rays), rays_of(ray_valid), rays_of(depth_obs),
           frame_valid[:, ::stride], points_w[:, :n_pts], point_valid[:, :n_pts]]
    sub_cfg = dict(cfg, n_fg_pix=n_fg, n_bg_pix=n_bg, n_frame=F, n_sample_on_ray=M,
                   recon_n_pts=n_pts, coarse_to_fine=False)
    return sub, sub_cfg


def views(obs: List[torch.Tensor], cfg: dict) -> List[View]:
    """The phases the configured solve runs, in order: the coarse and the
    fine view of a coarse-to-fine solve, or the one full view."""
    if not cfg["coarse_to_fine"]:
        return [View(*obs, cfg)]
    c_obs, c_cfg = _subsample(obs, cfg, cfg["coarse_frame_stride"], cfg["coarse_ray_frac"],
                              cfg["coarse_sample_frac"], cfg["coarse_pts_frac"])
    c_cfg = dict(c_cfg, max_iter=cfg["coarse_max_iter"] or cfg["max_iter"],
                 s_damp=cfg["coarse_s_damp"] or cfg["s_damp"])
    f_obs, f_cfg = obs, cfg
    if (cfg["fine_frame_stride"] > 1 or cfg["fine_ray_frac"] < 1.0 or cfg["fine_sample_frac"] < 1.0
            or cfg["fine_pts_frac"] < 1.0):
        f_obs, f_cfg = _subsample(obs, cfg, cfg["fine_frame_stride"], cfg["fine_ray_frac"],
                                  cfg["fine_sample_frac"], cfg["fine_pts_frac"])
    f_cfg = dict(f_cfg, max_iter=cfg["fine_max_iter"] or cfg["max_iter"], coarse_to_fine=False,
                 robust_iter=0)
    return [View(*c_obs, c_cfg), View(*f_obs, f_cfg)]


def view_shape(v: View) -> Tuple[int, int, int, int]:
    """(frames, rays, samples a ray, surface points) of a view."""
    return (v.rays.shape[1], v.rays.shape[2], v.cfg["n_sample_on_ray"], v.points_w.shape[1])


# ---------------------------------------------------------------- normal equations

def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1), torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def _huber_w(x: torch.Tensor, b: float) -> torch.Tensor:
    """w(|r|) = sqrt(rho(|r|)) / |r| of the Huber rho, w(0) = 0."""
    x = x.abs()
    rho = torch.where(x <= b, x * x, 2.0 * b * x - b * b)
    return torch.sqrt(rho.clamp(min=0.0)) / torch.where(x == 0.0, torch.ones_like(x), x)


def _linspace(lo: torch.Tensor, hi: torch.Tensor, num: int) -> torch.Tensor:
    step = torch.arange(num - 1, dtype=lo.dtype, device=lo.device) / (num - 1)
    return torch.cat([lo[..., None] * (1 - step) + hi[..., None] * step, hi[..., None]], dim=-1)


class Rays(NamedTuple):
    res_d: torch.Tensor      # [B, F, R]
    res_m: torch.Tensor
    ray_ok: torch.Tensor     # before the frame gate
    count: torch.Tensor      # in-radius samples of each ray
    jac_d: torch.Tensor      # [B, F, R, D]
    jac_m: torch.Tensor


def render_rays(dec: Decoder, latent, pts, depth_obs, is_fg, ray_valid, depths, bbx, kw: dict,
                prec: str) -> Rays:
    """The occlusion-aware depth and mask residuals of every ray and their
    [pose | code] Jacobians, over the dense [rays x samples] grid: object-
    frame samples pts [B, F, R, M, 3] at depths [B, F, M], the bounding
    radius bbx [B, F]. `kw`: pose_dim, log_occ_on, occ_cutoff, occlusion_on,
    occlusion_th, min_grad_th."""
    B, F, R, M, _ = pts.shape
    C = latent.shape[-1]
    f32 = torch.float32
    occ_cut = kw["occ_cutoff"]
    sigma = occ_cut / 3.0 * 0.55
    x = torch.cat([latent[:, None, None, None, :].expand(B, F, R, M, C), pts], dim=-1)
    sdf, g = dec.forward_grad(x.reshape(-1, C + 3), prec)
    sdf = sdf.reshape(B, F, R, M)
    g = g.reshape(B, F, R, M, C + 3)
    valid = (torch.linalg.norm(pts, dim=-1) < bbx[..., None, None]) & ray_valid[..., None]
    if kw["log_occ_on"]:
        occ_all = torch.sigmoid(-sdf / sigma)
    else:
        occ_all = 0.5 - sdf.clamp(-occ_cut, occ_cut) / (2.0 * occ_cut)
    occ = torch.where(valid, occ_all, torch.zeros_like(occ_all))
    with_grad = valid & (sdf > -occ_cut) & (sdf < occ_cut)
    d_min, d_max = depths[..., 0], depths[..., -1]
    delta_d = (d_max - d_min) / (M - 1)
    d_bg = d_max + delta_d
    one_minus = 1.0 - occ
    acc = torch.cumprod(one_minus, dim=-1)
    acc_aug = torch.cat([torch.ones_like(acc[..., :1]), acc[..., :-1]], dim=-1)
    term_prob = occ * acc_aug
    term_end = acc[..., -1]
    occ_ray = term_prob.sum(-1)
    d_u = (depths[:, :, None, :] * term_prob).sum(-1) + d_bg[..., None] * term_end
    denom = torch.where(one_minus <= 0.0, torch.ones_like(one_minus), one_minus)
    suffix = torch.flip(torch.cumsum(torch.flip(acc, [-1]), dim=-1), [-1])
    de_do = suffix * delta_d[..., None, None] / denom
    dm_do = term_end[..., None] / denom
    mask = with_grad & (de_do > kw["min_grad_th"])
    do_ds = (-occ * (1.0 - occ) / sigma if kw["log_occ_on"]
             else torch.full_like(occ, -1.0 / (2.0 * occ_cut)))
    if kw["occlusion_on"]:
        occluded = (~is_fg) & (depth_obs < d_u - kw["occlusion_th"]) & (depth_obs > 0.0)
        mask = mask & ~occluded[..., None]
    ray_ok = mask.any(-1)
    target = torch.where(is_fg, depth_obs, d_bg[..., None])
    zero = torch.zeros_like(d_u)
    res_d = torch.where(ray_ok, target - d_u, zero)
    res_m = torch.where(ray_ok, occ_ray - is_fg.to(f32), zero)
    gx = g[..., C:]
    cols = [gx, torch.linalg.cross(pts, gx, dim=-1)]
    if kw["pose_dim"] == 7:
        cols.append((gx * pts).sum(-1, keepdim=True))
    J = torch.cat(cols + [g[..., :C]], dim=-1)                   # [B, F, R, M, D]
    wf = mask.to(f32)
    okf = ray_ok.to(f32)[..., None]
    jac_d = (J * (wf * de_do * do_ds)[..., None]).sum(-2) * okf
    jac_m = (J * (wf * dm_do * do_ds)[..., None]).sum(-2) * okf
    return Rays(res_d, res_m, ray_ok, valid.sum(-1).to(f32), jac_d, jac_m)


class Terms(NamedTuple):
    H: torch.Tensor          # [B, D, D] damped
    b: torch.Tensor          # [B, D]
    failed: torch.Tensor     # [B]
    res_d: torch.Tensor      # [B, F, R]
    res_m: torch.Tensor      # [B, F, R]
    ray_ok: torch.Tensor     # [B, F, R]
    sdf_res: torch.Tensor    # [B, P]


def normal_equations(dec: Decoder, v: View, latent: torch.Tensor, T_ow: torch.Tensor,
                     i: torch.Tensor, cube_radius: float, prec: Dict[str, str],
                     lam: Optional[torch.Tensor] = None) -> Terms:
    """The damped LM normal equations of lanes (latent [B, C], T_ow [B, 4, 4],
    iteration i [B]) on view v. `prec` gives the precision of the render
    term's decoder (`render`), of the SDF term's (`sdf`) and of the normal
    equations' algebra (`algebra`). `lam` [B], where given, is each lane's
    damping lambda (the trust region's) in place of the fixed `lm_lambda_0`,
    in the same form; `i` decides the robust weights."""
    cfg = v.cfg
    B, C = latent.shape
    pd = 7 if cfg["scale_on"] else 6
    D = pd + C
    dev = latent.device
    f32 = torch.float32
    occ_cut = cfg["occ_cutoff_m"]

    # render geometry: per frame camera -> object, ray-marching depths around
    # the object's centre, the bounding radius at the current scale
    scale = torch.linalg.det(T_ow[:, :3, :3]) ** (-1.0 / 3.0)
    T_oc = T_ow[:, None] @ v.T_wc
    T_co = torch.linalg.inv(T_oc)
    rng = (cube_radius * scale)[:, None].expand(T_co.shape[:2])
    depths = _linspace(T_co[..., 2, 3] - rng, T_co[..., 2, 3] + 0.8 * rng, cfg["n_sample_on_ray"])
    R = v.rays.shape[2]
    pts_cam = v.rays[..., :, None, :] * depths[..., None, :, None]
    pts = pts_cam @ T_oc[..., :3, :3].transpose(-1, -2)[:, :, None] + T_oc[..., None, None, :3, 3]
    is_fg = torch.arange(R, device=dev) < cfg["n_fg_pix"]
    ray_valid = v.ray_valid & v.frame_valid[..., None]

    rr = render_rays(dec, latent, pts, v.depth_obs, is_fg, ray_valid, depths, rng,
                     dict(pose_dim=pd, log_occ_on=cfg["log_sdf_occ"], occ_cutoff=occ_cut,
                          occlusion_on=cfg["occlusion_on"], occlusion_th=0.03, min_grad_th=1e-6),
                     prec["render"])
    frame_ok = rr.count.sum(-1) >= 100                           # min_valid_sample
    gate = frame_ok.to(f32)[..., None]
    res_d, res_m = rr.res_d * gate, rr.res_m * gate
    ray_ok = rr.ray_ok & frame_ok[..., None]
    jac_d, jac_m = rr.jac_d * gate[..., None], rr.jac_m * gate[..., None]

    # SDF term on the surface points, in the object frame
    pts_o = v.points_w @ T_ow[:, :3, :3].transpose(1, 2) + T_ow[:, None, :3, 3]
    P = pts_o.shape[1]
    xs = torch.cat([latent[:, None, :].expand(B, P, C), pts_o], dim=-1)
    s_r, g_r = dec.forward_grad(xs.reshape(-1, C + 3), prec["sdf"])
    s_r, g_r = s_r.reshape(B, P), g_r.reshape(B, P, C + 3)
    gx_r = g_r[..., C:]
    cols_r = [gx_r, torch.linalg.cross(pts_o, gx_r, dim=-1)]
    if pd == 7:
        cols_r.append((gx_r * pts_o).sum(-1, keepdim=True))
    okp = v.point_valid.to(f32)
    J_r = torch.cat(cols_r + [g_r[..., :C]], dim=-1) * okp[..., None]
    r_r = s_r * okp

    alg = prec["algebra"]
    obs_count = ray_ok.sum((1, 2)).to(f32)
    failed = obs_count == 0.0
    robust = (i >= cfg["robust_iter"])

    def term(jac, res, w2, count, weight):
        cs = count.clamp(min=1.0)[:, None]
        jf = _round(jac.reshape(B, -1, D), alg)
        jw = _round((jac * w2[..., None]).reshape(B, -1, D), alg)
        H = weight * (jw.transpose(1, 2) @ jf) / cs[..., None]
        bb = -weight * (jw.transpose(1, 2) @ _round(res.reshape(B, -1, 1), alg))[..., 0] / cs
        return H, bb

    w_d = _huber_w(res_d, cfg["render_robust_th_m"])
    w2_d = torch.where(robust[:, None, None], w_d * w_d, torch.ones_like(w_d))
    H_d, b_d = term(jac_d, res_d, w2_d, obs_count, cfg["w_depth"])
    H_m, b_m = term(jac_m, res_m, torch.ones_like(res_m), obs_count, cfg["w_mask"])
    r_count = v.point_valid.sum(-1).to(f32)
    w_r = _huber_w(r_r, cfg["recon_robust_th_m"])
    w2_r = torch.where(robust[:, None], w_r * w_r, torch.ones_like(w_r))
    H_r, b_r = term(J_r, r_r, w2_r, r_count, cfg["w_recon"])
    code_mask = (torch.arange(D, device=dev) >= pd).to(f32)
    H = H_d + H_m + H_r + torch.diag(cfg["w_codereg"] * code_mask)
    b = b_d + b_m + b_r + torch.cat([torch.zeros(B, pd, device=dev), -cfg["w_codereg"] * latent], 1)
    if cfg["scale_on"]:
        H[:, pd - 1, pd - 1] += cfg["s_damp"]
    if cfg["yaw_damp"] > 0.0:
        H[:, 4, 4] += cfg["yaw_damp"]
    if cfg["rot_damp"] > 0.0:
        idx = torch.arange(3, 6, device=dev)
        H[:, idx, idx] += cfg["rot_damp"]
    if cfg["lm_on"]:
        diag = torch.diagonal(H, dim1=-2, dim2=-1)
        lam = cfg["lm_lambda_0"] if lam is None else lam[:, None, None]
        if cfg["lm_eye"]:
            H = H + lam * diag.max(-1).values[:, None, None] * torch.eye(D, device=dev)
        else:
            H = H + lam * torch.diag_embed(diag)
    return Terms(_round(H, alg), _round(b, alg), failed, res_d, res_m, ray_ok, r_r)


def exp_sim3_ref(x: torch.Tensor) -> torch.Tensor:
    """The original method's Sim(3) update from a tangent (v[3], w[3], s),
    quirk included: within the theta > eps branch the c*I term of the
    translation Jacobian is zeroed for every s <= 1e-8."""
    eps = 1e-8
    v, w, s = x[..., :3], x[..., 3:6], x[..., 6]
    theta = torch.linalg.norm(w, dim=-1)
    small = theta <= eps
    one, zero = torch.ones_like(theta), torch.zeros_like(theta)
    th = torch.where(small, one, theta)
    t2 = th * th
    e_s, sin_t, cos_t = torch.exp(s), torch.sin(theta), torch.cos(theta)
    W = skew(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    A = torch.where(small, zero, sin_t / th)
    Bc = torch.where(small, zero, (1.0 - cos_t) / t2)
    Rm = eye + A[..., None, None] * W + Bc[..., None, None] * W2
    s_safe = torch.where(s == 0.0, torch.ones_like(s), s)
    c_div = (e_s - 1.0) / s_safe
    c_small = torch.where(s == 0.0, torch.ones_like(s), c_div)
    c_big = torch.where(s <= eps, torch.zeros_like(s), c_div)
    den = s * s + t2
    a, bb = e_s * sin_t, e_s * cos_t
    k1 = (a * s + (1.0 - bb) * theta) / den
    k2 = c_big - ((bb - 1.0) * s + a * theta) / den
    j_big = (c_big[..., None, None] * eye + (k1 / th)[..., None, None] * W
             + (k2 / t2)[..., None, None] * W2)
    j = torch.where(small[..., None, None], c_small[..., None, None] * eye, j_big)
    t = (j @ v[..., None])[..., 0]
    T = torch.zeros(x.shape[:-1] + (4, 4), dtype=x.dtype, device=x.device)
    T[..., :3, :3] = e_s[..., None, None] * Rm
    T[..., :3, 3] = t
    T[..., 3, 3] = 1.0
    return T


def exp_se3(x: torch.Tensor) -> torch.Tensor:
    """se(3) -> SE(3) through the matrix exponential of the twist."""
    Xi = torch.zeros(x.shape[:-1] + (4, 4), dtype=x.dtype, device=x.device)
    Xi[..., :3, :3] = skew(x[..., 3:6])
    Xi[..., :3, 3] = x[..., :3]
    return torch.linalg.matrix_exp(Xi)


def lm_step(dec: Decoder, v: View, latent: torch.Tensor, T_ow: torch.Tensor, i: torch.Tensor,
            cube_radius: float, prec: Dict[str, str], lam: Optional[torch.Tensor] = None):
    """One LM iteration of the lanes: (latent', T_ow', Terms), damped by the
    fixed `lm_lambda_0` or by each lane's `lam` [B]. A lane with no valid ray
    keeps its state."""
    t = normal_equations(dec, v, latent, T_ow, i, cube_radius, prec, lam)
    delta = torch.linalg.solve_ex(t.H, t.b[..., None])[0][..., 0]
    pd = 7 if v.cfg["scale_on"] else 6
    dT = exp_sim3_ref(delta[:, :pd]) if v.cfg["scale_on"] else exp_se3(delta[:, :pd])
    keep = t.failed
    return (torch.where(keep[:, None], latent, latent + delta[:, pd:]),
            torch.where(keep[:, None, None], T_ow, dT @ T_ow), t)


def surface_distance(dec: Decoder, latent: torch.Tensor, T_ow: torch.Tensor,
                     verts_w: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """Distance of world-frame vertices [V, 3] of one fruit's mesh to the
    zero level set of its code under its pose: |sdf| / |d sdf / d x| in the
    object frame, |sdf| over the gradient's norm (a first-order distance)."""
    x_o = verts_w @ T_ow[:3, :3].T + T_ow[:3, 3]
    x = torch.cat([latent[None].expand(x_o.shape[0], -1), x_o], dim=-1)
    s, g = dec.forward_grad(x, prec)
    return s.abs() / torch.linalg.norm(g[:, -3:], dim=-1).clamp_min(1e-6)


def voxel_points(voxels: int, cube_radius: float, device) -> torch.Tensor:
    """The meshing grid: [-1, 1]^3 on the integer lattice scaled by the cube
    radius, (D^3, 3), row i at x = i // D^2, y = (i // D) % D, z = i % D."""
    i = torch.arange(voxels ** 3, device=device)
    xyz = torch.stack([i // (voxels * voxels), (i // voxels) % voxels, i % voxels], -1).float()
    return (xyz * (2.0 / (voxels - 1)) - 1.0) * cube_radius


def grid_sdf(dec: Decoder, latent: torch.Tensor, pts: torch.Tensor, prec: str = "f32") -> torch.Tensor:
    """SDF of one code over grid points pts [N, 3]."""
    return dec.forward_blocks(torch.cat([latent[None].expand(pts.shape[0], -1), pts], -1), prec)


def is_finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x).all())

