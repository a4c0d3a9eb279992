"""Batched Levenberg-Marquardt joint shape + pose optimization.

Counterpart of `hortimapping_tpu/optim/lm.py`: the fixed-lambda solver, the
adaptive trust-region solver (`trust_region`), the two-resolution schedule,
the code-frozen pose polish, the staged solve, the chunked solve, the
code-only DeepSDF baseline (`shape_opt_deepsdf(_batched)`), the single-fruit
solvers (`shape_pose_joint_opt(_traced)`) and the serving solve
(`joint_opt`, `joint_opt_packed`). The JAX
`vmap` over fruits is the leading [B] axis of every tensor; its
`lax.while_loop` with frozen lanes is a Python loop that steps every lane
until all are done or failed (one host sync per iteration, for that test:
`parallel/sharding.host_read`, where a shard of the fruit mesh hands the
host to the other shards while it waits; `_loop`, with its spans while
tracing is on, `utils/trace.py`).
Frozen lanes keep their state bit for bit.

The render term runs through the fused render kernel and the SDF term
through the fwd+input-grad kernel wherever the decoder is kernel-supported;
the device of the tensors decides between kernel (CUDA) and plain version
(CPU). On the card the damped normal equations are solved by the kernel of
`ops/linalg.py`, which never synchronizes, and `lm_iteration` replays the
code around its two decoder terms as CUDA graphs (`optim/graphs.py`): the
render geometry before the render term, the render term's normal
equations and the point transform between the terms, and the SDF term's
normal equations, the damping, the solve, the step and the convergence
tests after them. `render_residuals` and `sdf_residuals` stay eager calls,
once an iteration.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from collections import OrderedDict
from typing import NamedTuple, Optional, Tuple

import torch

from hortimapping_tpu_torch.config import JointOptConfig
from hortimapping_tpu_torch.device import resolve_device
from hortimapping_tpu_torch.models.decoder import DecoderSpec, Params
from hortimapping_tpu_torch.ops import linalg, mlp_kernels
from hortimapping_tpu_torch.ops.lie import exp_se3, exp_sim3_ref, rotation_matrix_to_angle
from hortimapping_tpu_torch.ops.recon import sdf_residuals
from hortimapping_tpu_torch.ops.render import RenderConfig, render_residuals, takes_fused
from hortimapping_tpu_torch.ops.robust import huber_weights
from hortimapping_tpu_torch.optim.graphs import IterationGraphs
from hortimapping_tpu_torch.optim.state import FruitObservations, OptResult, OptState, init_state
from hortimapping_tpu_torch.parallel.sharding import host_read, on_shard_thread, pad_to_multiple
from hortimapping_tpu_torch.utils import trace

CUDA_GRAPHS = True   # on the card, replay the iteration's own code as CUDA graphs
# keys of `lm_iteration` kept (graphs, or seen once), least recent dropped:
# a served shape bucket has a coarse and a fine key for each of the packer's
# 6 widths, and one more for each layout its warm-up did not see
MAX_GRAPHED = 32
graph_captures = 0   # keys captured, three graphs each (`utils/trace.count`)
_graphed: "OrderedDict[tuple, Optional[IterationGraphs]]" = OrderedDict()
_graphed_lock = threading.Lock()


@dataclasses.dataclass(frozen=True)
class Packs:
    """Decoder weights packed once per solve: for the render route (bf16 or
    f32 per `fused_bf16` on the fused route, f32 on the dense one), for the
    SDF term (f32), and where the solve retrieves codes for retrieval
    scoring (per `retrieval_score_bf16`)."""

    render: Optional[mlp_kernels.PackedDecoder]
    sdf: Optional[mlp_kernels.PackedDecoder]
    score: Optional[mlp_kernels.KernelDecoder] = None


def make_packs(params: Params, spec: DecoderSpec, cfg: JointOptConfig,
               score: bool = False) -> Packs:
    if not mlp_kernels.supported(spec):
        return Packs(None, None)
    f32 = mlp_kernels.pack_params(params, spec, torch.float32)
    sdf = f32 if cfg.pallas_resolved(spec) else None
    scorer = (mlp_kernels.KernelDecoder(params, spec, bf16=cfg.retrieval_score_bf16)
              if score else None)
    if takes_fused(_render_config(cfg, spec), spec) and cfg.fused_bf16:
        return Packs(mlp_kernels.pack_params(params, spec, torch.bfloat16), sdf, scorer)
    return Packs(f32, sdf, scorer)


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
    return _geometry(cfg, obs.T_wc, T_ow, cube_radius)


def _geometry(cfg: JointOptConfig, T_wc: torch.Tensor, T_ow: torch.Tensor, cube_radius: float):
    cur_scale = linalg.det(T_ow[:, :3, :3]) ** (-1.0 / 3.0)                    # [B]
    # the exact inverse of the drifted T_oc (not the closed-form Sim(3)
    # transpose): LM updates drift T_ow off the manifold and the reference
    # inverts the drifted matrix exactly
    T_oc = T_ow[:, None] @ T_wc
    T_co = linalg.inv(T_oc)
    depth_range = (cube_radius * cur_scale)[:, None].expand(T_co.shape[:2])
    d_lo = T_co[..., 2, 3] - 1.0 * depth_range
    d_hi = T_co[..., 2, 3] + 0.8 * depth_range
    return T_oc, _linspace(d_lo, d_hi, cfg.n_sample_on_ray), depth_range


def _render_inputs(cfg: JointOptConfig, cube_radius: float, T_wc, ray_valid, frame_valid, T_ow):
    """What the render term takes from the state: the fg flags of the rays
    [R], the valid rays of valid frames [B, F, R] and `render_geometry`."""
    is_fg = torch.arange(cfg.n_rays, device=T_ow.device) < cfg.n_fg_pix
    return (is_fg, ray_valid & frame_valid[..., None],
            *_geometry(cfg, T_wc, T_ow, cube_radius))


def _render_normal_eq(cfg: JointOptConfig, res_d, jac_d, res_m, jac_m, ray_ok, i, points_w, T_ow):
    """The render term's normal equations (depth + mask), `failed` (no valid
    ray) and the surface points in the object frame, for the SDF term;
    then the ray count and depth weights the objective reads."""
    obs_count = ray_ok.sum((1, 2)).to(torch.float32)                           # [B]
    failed = obs_count == 0.0
    robust_active = i >= cfg.robust_iter
    w2_d = _robust_w2(res_d, cfg.render_robust_th_m, robust_active[:, None, None])
    H_d, b_d = _term_normal_eq(jac_d, res_d, w2_d, obs_count, cfg.w_depth)
    H_m, b_m = _term_normal_eq(jac_m, res_m, torch.ones_like(res_m), obs_count, cfg.w_mask)
    pts_o = points_w @ T_ow[:, :3, :3].transpose(1, 2) + T_ow[:, None, :3, 3]
    return failed, H_d + H_m, b_d + b_m, pts_o, obs_count, w2_d


def _sdf_normal_eq(cfg: JointOptConfig, H, b, res, jac, point_valid, i, latent):
    """Undamped (H, b): the render term's plus the SDF term's, the code
    regularizer and the configured pose dampings; then the point count and
    SDF weights the objective reads."""
    pose_dim = cfg.pose_dim
    B, C = latent.shape
    D = pose_dim + C
    f32 = torch.float32
    dev = latent.device
    recon_count = point_valid.sum(-1).to(f32)
    robust_active = i >= cfg.robust_iter
    w2_r = _robust_w2(res, cfg.recon_robust_th_m, robust_active[:, None])
    H_r, b_r = _term_normal_eq(jac, res, w2_r, recon_count, cfg.w_recon)

    # ---------------- III. code regularizer ----------------
    code_mask = (torch.arange(D, device=dev) >= pose_dim).to(f32)
    H_c = torch.diag(cfg.w_codereg * code_mask)
    b_c = torch.cat([torch.zeros(B, pose_dim, dtype=f32, device=dev), -cfg.w_codereg * latent], 1)

    H = H + H_r + H_c
    if cfg.scale_on:
        H[:, pose_dim - 1, pose_dim - 1] += cfg.s_damp
    if cfg.yaw_damp > 0.0:
        H[:, 4, 4] += cfg.yaw_damp
    if cfg.rot_damp > 0.0:
        idx = torch.arange(3, 6, device=dev)
        H[:, idx, idx] += cfg.rot_damp
    return H, b + b_r + b_c, recon_count, w2_r


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

    # ---------------- I. render term over all frames ----------------
    is_fg, ray_mask, T_oc, depths, depth_range = _render_inputs(
        cfg, cube_radius, obs.T_wc, obs.ray_valid, obs.frame_valid, T_ow)
    rr = render_residuals(
        params, spec, latent, obs.rays, is_fg, ray_mask, obs.depth_obs, T_oc, depths,
        depth_range, _render_config(cfg, spec), lane_active, packs.render,
    )
    failed, H, b, pts_o, obs_count, w2_d = _render_normal_eq(
        cfg, rr.res_d, rr.jac_d, rr.res_m, rr.jac_m, rr.ray_ok, i, obs.points_w, T_ow)

    # ---------------- II. sdf reconstruction term ----------------
    rec = sdf_residuals(params, spec, latent, pts_o, obs.point_valid, cfg.scale_on, packs.sdf,
                        lane_active)
    H, b, recon_count, w2_r = _sdf_normal_eq(cfg, H, b, rec.res, rec.jac, obs.point_valid, i,
                                             latent)

    count_safe = torch.clamp(obs_count, min=1.0)
    rcount_safe = torch.clamp(recon_count, min=1.0)
    cost = (
        cfg.w_depth * (w2_d * rr.res_d * rr.res_d).sum((1, 2)) / count_safe
        + cfg.w_mask * (rr.res_m * rr.res_m).sum((1, 2)) / count_safe
        + cfg.w_recon * (w2_r * rec.res * rec.res).sum(1) / rcount_safe
        + cfg.w_codereg * (latent * latent).sum(1)
    )
    return H, b, failed, cost


def apply_lm_damping(H: torch.Tensor, cfg: JointOptConfig,
                     lam: Optional[float | torch.Tensor] = None) -> torch.Tensor:
    """lambda * diag(H) added to H, or lambda * max(diag(H)) * I with `lm_eye`.
    `lam` defaults to the fixed lambda_0; the trust-region solver passes one
    per lane ([B])."""
    if not cfg.lm_on:
        return H
    lam = cfg.lm_lambda_0 if lam is None else lam
    if isinstance(lam, torch.Tensor):
        lam = lam[:, None, None]
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


# `lm_iteration`'s hook: another function in this one's place assembles the
# iteration's (H, b) (see there)
_NORMAL_EQUATIONS = normal_equations


def _convergence(cfg: JointOptConfig, i, b, delta_T, delta_c, latent_new, T_new,
                 pose_known: bool, code_known: bool):
    """The gradient, code and pose convergence tests of an LM step [B]."""
    scale_new = linalg.det(T_new[:, :3, :3]) ** (-1.0 / 3.0)
    delta_scale = linalg.det(delta_T[:, :3, :3]) ** (1.0 / 3.0)
    delta_tran = torch.linalg.norm(delta_T[:, :3, 3], dim=-1) * scale_new
    delta_rot = rotation_matrix_to_angle(delta_T[:, :3, :3] * scale_new[:, None, None]) * 180.0 / math.pi

    past_warmup = i > 1
    conv_g = (b.abs().max(-1).values < cfg.epsilon_g) & past_warmup
    conv_c = ((delta_c / (latent_new + 1e-12)).abs().max(-1).values < cfg.epsilon_c) & past_warmup
    if code_known:
        # with the code frozen delta_c == 0 passes this test trivially; the
        # polish runs on the pose tests and its iteration budget only
        conv_c = torch.zeros_like(conv_c)
    # the reference compares delta_scale (a ratio ~= 1) with epsilon_s, so
    # this pose test never fires; kept literally for iteration-count parity
    conv_p = ((delta_tran < cfg.epsilon_t) & (delta_rot < cfg.epsilon_r)
              & (delta_scale < cfg.epsilon_s) & past_warmup)
    if pose_known:
        conv_p = torch.zeros_like(conv_p)
    return conv_g, conv_c, conv_p


def _manifold_step(cfg: JointOptConfig, delta: torch.Tensor, latent: torch.Tensor,
                   T_ow: torch.Tensor):
    """(delta_T, delta_c, latent_new, T_new) of the step delta [B, D]."""
    pose_dim = cfg.pose_dim
    delta_p = delta[:, :pose_dim]
    delta_c = delta[:, pose_dim:]
    delta_T = exp_sim3_ref(delta_p) if cfg.scale_on else exp_se3(delta_p)
    return delta_T, delta_c, latent + delta_c, delta_T @ T_ow


def _lm_step(cfg: JointOptConfig, H, b, failed, latent, T_ow, i, iter_count, converged,
             pose_known: bool, code_known: bool) -> OptState:
    """The new state of every lane from the damped normal equations (H, b)
    at (latent, T_ow): the solve, the step on the manifold, the convergence
    tests."""
    pose_dim = cfg.pose_dim
    # a singular H (a lane with nothing observed) gives inf/nan like
    # jnp.linalg.solve instead of raising; such lanes are `failed`
    delta = linalg.solve(H, b)
    if pose_known or code_known:
        delta = delta.clone()
    if pose_known:
        delta[:, :6] = 0.0
    if code_known:
        delta[:, pose_dim:] = 0.0
    delta_T, delta_c, latent_new, T_new = _manifold_step(cfg, delta, latent, T_ow)
    conv_g, conv_c, conv_p = _convergence(cfg, i, b, delta_T, delta_c, latent_new, T_new,
                                          pose_known, code_known)
    conv = conv_g | conv_c | conv_p
    done = conv | (i >= cfg.max_iter - 1)

    # a failed iteration (no valid rays) leaves the estimate untouched and
    # ends the lane
    keep = failed
    return OptState(
        latent=torch.where(keep[:, None], latent, latent_new),
        T_ow=torch.where(keep[:, None, None], T_ow, T_new),
        i=torch.where(keep, i, i + 1),
        iter_count=torch.where(keep, iter_count, i + 1),
        done=done | keep,
        failed=keep,
        converged=torch.where(keep, converged, conv),
    )


def lm_iteration(params, spec, cfg, obs, state: OptState, cube_radius: float,
                 pose_known: bool, packs: Optional[Packs] = None,
                 code_known: bool = False) -> OptState:
    """One LM iteration for every lane (frozen lanes are restored by
    `_freeze_if_done`). `code_known` zeroes the code block of the step, so
    only the pose moves (the pose polish).

    The iteration is `render_residuals` and `sdf_residuals`, each called
    once, and three segments of its own code around them: `pre` (the render
    geometry), `mid` (the render term's normal equations, the point
    transform) and `post` (the SDF term's normal equations, the damping,
    the solve, the step, the convergence tests). On the card the segments
    replay as CUDA graphs where `_iteration_graphs` has them, and the state
    returned is then a copy of the graph's output; elsewhere they run as
    plain calls. While tracing, the span `lm.iteration` gets `graph` 1 where
    they replayed, else 0.

    The one hook: a function put in place of this module's
    `normal_equations` (the benchmark's control lowers the precision of its
    algebra there) assembles (H, b) for the iteration, which then runs
    eagerly."""
    if normal_equations is not _NORMAL_EQUATIONS:
        trace.tag("lm.iteration", graph=0)
        H, b, failed = normal_equations(params, spec, cfg, obs, state.latent, state.T_ow, state.i,
                                        cube_radius, ~(state.done | state.failed), packs)
        return _lm_step(cfg, H, b, failed, state.latent, state.T_ow, state.i, state.iter_count,
                        state.converged, pose_known, code_known)
    if packs is None:
        packs = make_packs(params, spec, cfg)
    latent, T_ow, i = state.latent, state.T_ow, state.i

    def pre(T_wc, ray_valid, frame_valid, T_ow, done, failed):
        return (*_render_inputs(cfg, cube_radius, T_wc, ray_valid, frame_valid, T_ow),
                ~(done | failed))

    def mid(*t):
        return _render_normal_eq(cfg, *t)[:4]

    def post(H, b, failed, res, jac, point_valid, latent, T_ow, i, iter_count, converged):
        H, b, _, _ = _sdf_normal_eq(cfg, H, b, res, jac, point_valid, i, latent)
        return _lm_step(cfg, apply_lm_damping(H, cfg), b, failed, latent, T_ow, i, iter_count,
                        converged, pose_known, code_known)

    graphs = _iteration_graphs(cfg, obs, state, cube_radius, pose_known, code_known)
    trace.tag("lm.iteration", graph=int(graphs is not None))
    run = graphs.run if graphs is not None else (lambda _name, fn, *a: fn(*a))
    try:
        is_fg, ray_mask, T_oc, depths, depth_range, lane_active = run(
            "pre", pre, obs.T_wc, obs.ray_valid, obs.frame_valid, T_ow, state.done, state.failed)
        rr = render_residuals(
            params, spec, latent, obs.rays, is_fg, ray_mask, obs.depth_obs, T_oc, depths,
            depth_range, _render_config(cfg, spec), lane_active, packs.render,
        )
        failed, H, b, pts_o = run("mid", mid, rr.res_d, rr.jac_d, rr.res_m, rr.jac_m, rr.ray_ok,
                                  i, obs.points_w, T_ow)
        rec = sdf_residuals(params, spec, latent, pts_o, obs.point_valid, cfg.scale_on,
                            packs.sdf, lane_active)
        new = run("post", post, H, b, failed, rec.res, rec.jac, obs.point_valid, latent, T_ow, i,
                  state.iter_count, state.converged)
    finally:
        if graphs is not None:
            graphs.release()
    # a later replay overwrites the graph's outputs: hand out copies
    return OptState(*(t.clone() for t in new)) if graphs is not None else new


def _iteration_graphs(cfg, obs, state: OptState, cube_radius: float, pose_known: bool,
                      code_known: bool) -> Optional[IterationGraphs]:
    """The graphs of this iteration's key, held for the caller, or None
    where the iteration runs eagerly: off the card, `CUDA_GRAPHS` off, a
    shard thread of the fruit mesh (whose threads take host turns), inside
    a capture of the caller's, the first call of a key, or another thread
    using the key's graphs. A key's first iteration is its warm-up: it runs
    eagerly, so the lazy set-up of the libraries and kernels it calls
    happens outside a capture; the second captures. The key is all that
    the captured code fixes: the config, the radius, the flags, every
    input's shape, strides and type, the device and the stream."""
    dev = state.latent.device
    if (not CUDA_GRAPHS or dev.type != "cuda" or on_shard_thread()
            or torch.cuda.is_current_stream_capturing()):
        return None
    key = (cfg, float(cube_radius), bool(pose_known), bool(code_known), dev,
           torch.cuda.current_stream(dev).cuda_stream,
           tuple((t.shape, t.stride(), t.dtype) for t in (*obs, *state)))
    with _graphed_lock:
        if key not in _graphed:
            _graphed[key] = None
            _drop_oldest(dev)
            return None
        _graphed.move_to_end(key)
        graphs = _graphed[key]
        if graphs is None:
            graphs = _graphed[key] = IterationGraphs(dev)
            trace.count(globals(), "graph_captures")
    return graphs if graphs.acquire() else None


def _drop_oldest(dev: torch.device) -> None:
    """Keys beyond MAX_GRAPHED, least recently used first (under
    `_graphed_lock`); graphs in use by another thread stay. Work of a dropped
    graph may still be queued, so the device finishes it first."""
    for key in list(_graphed):
        if len(_graphed) <= MAX_GRAPHED:
            return
        graphs = _graphed[key]
        if graphs is None:
            del _graphed[key]
        elif graphs.acquire():
            torch.cuda.synchronize(dev)
            del _graphed[key]
            graphs.release()


def _where_lanes(mask: torch.Tensor, a, b):
    """Per lane: a where `mask` [B], else b, through nested NamedTuples of
    tensors with a leading lane axis."""
    if isinstance(a, tuple):
        return type(a)(*(_where_lanes(mask, x, y) for x, y in zip(a, b)))
    return torch.where(mask.reshape(mask.shape + (1,) * (a.dim() - 1)), a, b)


def _freeze_if_done(old: OptState, new: OptState) -> OptState:
    """Lanes already done or failed keep their state bit for bit."""
    return _where_lanes(old.done | old.failed, old, new)


class TrState(NamedTuple):
    """Carry of the adaptive trust-region solver (`trust_region`): the
    fixed-lambda carry plus, per lane, the damping lambda and the last
    ACCEPTED linearization point (its state, undamped normal equations and
    objective). A rejected step re-solves from the stored (H, b) with a
    larger lambda, without a new assembly."""

    base: OptState
    lam: torch.Tensor          # [B] current damping
    cost: torch.Tensor         # [B] objective at the last accepted state
    acc_latent: torch.Tensor   # [B, C] last accepted latent
    acc_T_ow: torch.Tensor     # [B, 4, 4] last accepted pose
    H_acc: torch.Tensor        # [B, D, D] undamped H at the accepted state
    b_acc: torch.Tensor        # [B, D]
    nu: torch.Tensor           # [B] Nielsen rejection growth factor
    pred: torch.Tensor         # [B] predicted reduction of the in-flight step
    flat: torch.Tensor         # [B] int32 consecutive flat accepted steps


def init_tr_state(latent: torch.Tensor, T_ow: torch.Tensor, cfg: JointOptConfig,
                  i0: int = 0) -> TrState:
    B, C = latent.shape
    D = cfg.pose_dim + C
    f32, dev = torch.float32, latent.device
    return TrState(
        base=init_state(latent, T_ow, i0),
        lam=torch.full((B,), cfg.lm_lambda_0, dtype=f32, device=dev),
        cost=torch.full((B,), math.inf, dtype=f32, device=dev),   # the first assembly accepts
        acc_latent=latent,
        acc_T_ow=T_ow,
        H_acc=torch.zeros(B, D, D, dtype=f32, device=dev),
        b_acc=torch.zeros(B, D, dtype=f32, device=dev),
        nu=torch.full((B,), 2.0, dtype=f32, device=dev),
        pred=torch.ones(B, dtype=f32, device=dev),
        flat=torch.zeros(B, dtype=torch.int32, device=dev),
    )


def lm_iteration_tr(params, spec, cfg, obs, ts: TrState, cube_radius: float,
                    pose_known: bool, packs: Optional[Packs] = None) -> TrState:
    """One adaptive-damping LM iteration for every lane: the residuals,
    Jacobians, weights and convergence tests of `lm_iteration`, with each
    lane's lambda adapted by deferred step acceptance and Nielsen's
    gain-ratio rule. The assembly at iteration k prices the step taken at
    k-1 against its predicted reduction: a good step shrinks lambda by
    max(1/3, 1 - (2 rho - 1)^3); a bad one rolls back to the stored accepted
    state and retries from its (H, b) with lambda * nu (nu doubling on
    consecutive rejections)."""
    s = ts.base
    i = s.i
    lane_active = ~(s.done | s.failed)
    H, b, failed, cost = _assemble_normal_equations(
        params, spec, cfg, obs, s.latent, s.T_ow, i, cube_radius, lane_active, packs)

    # at i == robust_iter the new cost carries Huber weights and the stored
    # one does not: accept the step (unless non-finite) but adapt no damping
    crossed = (i == cfg.robust_iter) if cfg.robust_iter > 0 else torch.zeros_like(failed)
    accept = (cost <= ts.cost) | (crossed & torch.isfinite(cost))
    # where, not a blend: a NaN trial state must roll back cleanly
    H_use = torch.where(accept[:, None, None], H, ts.H_acc)
    b_use = torch.where(accept[:, None], b, ts.b_acc)
    lat_use = torch.where(accept[:, None], s.latent, ts.acc_latent)
    T_use = torch.where(accept[:, None, None], s.T_ow, ts.acc_T_ow)
    cost_use = torch.where(accept, cost, ts.cost)
    # Nielsen gain ratio: actual vs predicted reduction of the priced step
    rho = (ts.cost - cost) / torch.clamp(ts.pred, min=1e-30)
    rho = torch.where(torch.isfinite(rho), rho, torch.ones_like(rho))   # i=0: inf improvement
    shrink = torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam = torch.where(accept, torch.clamp(ts.lam * shrink, min=cfg.tr_lambda_min),
                      torch.clamp(ts.lam * ts.nu, max=cfg.tr_lambda_max))
    nu = torch.where(accept, torch.full_like(ts.nu, 2.0), torch.clamp(ts.nu * 2.0, max=128.0))
    lam = torch.where(crossed & accept, ts.lam, lam)
    nu = torch.where(crossed & accept, ts.nu, nu)

    Hd = apply_lm_damping(H_use, cfg, lam)
    delta = linalg.solve(Hd, b_use)
    if pose_known:
        # zero the pose step before pricing it: pred must value the step taken
        delta = delta.clone()
        delta[:, :6] = 0.0
    # predicted reduction L(0) - L(delta) = delta^T (b + lambda D delta)
    pred = torch.clamp((delta * (b_use + ((Hd - H_use) @ delta[..., None])[..., 0])).sum(-1),
                       min=1e-30)
    delta_T, delta_c, latent_new, T_new = _manifold_step(cfg, delta, lat_use, T_use)
    conv_g, conv_c, conv_p = _convergence(cfg, i, b_use, delta_T, delta_c, latent_new, T_new,
                                          pose_known, False)
    # objective-driven stop: two consecutive accepted steps whose
    # improvement flattened (never the inf sentinel, never the robust
    # boundary's reweighting)
    is_flat = (accept & torch.isfinite(ts.cost) & ~crossed
               & ((ts.cost - cost) <= cfg.tr_cost_rtol * ts.cost))
    flat = torch.where(is_flat, ts.flat + 1, torch.where(accept, torch.zeros_like(ts.flat), ts.flat))
    conv_f = (flat >= 2) & (i > 1)
    conv = (conv_g | conv_c | conv_p | conv_f) & accept
    done = conv | (i >= cfg.max_iter - 1)

    new_ts = TrState(
        OptState(latent=latent_new, T_ow=T_new, i=i + 1, iter_count=i + 1, done=done,
                 failed=torch.zeros_like(failed), converged=conv),
        lam, cost_use, lat_use, T_use, H_use, b_use, nu, pred, flat,
    )
    # failed lanes keep the last ACCEPTED estimate and terminate
    fail_ts = ts._replace(base=s._replace(latent=ts.acc_latent, T_ow=ts.acc_T_ow,
                                          done=torch.ones_like(failed),
                                          failed=torch.ones_like(failed)))
    return _where_lanes(failed, fail_ts, new_ts)


def _freeze_if_done_tr(old: TrState, new: TrState) -> TrState:
    return _where_lanes(old.base.done | old.base.failed, old, new)


def _tr_result(final: TrState) -> OptResult:
    """Each lane's reported state: the final trial step where the lane left
    through a convergence test, else the last accepted state (a max-iter or
    failed lane's trial was never shown to improve the objective)."""
    take = final.base.converged
    return OptResult(
        torch.where(take[:, None], final.base.latent, final.acc_latent),
        torch.where(take[:, None, None], final.base.T_ow, final.acc_T_ow),
        final.base.iter_count, final.base.failed, final.base.converged,
    )


def _loop(step, state, ended, phase: str):
    """Steps `state` until every lane has ended (`ended(state)`: done or
    failed, [B]), reading one flag back to the host an iteration. While
    tracing is on, the loop is span `lm.solve` (`phase`, or `rescue` inside
    the rescue; its width), each iteration span `lm.iteration` (the lanes
    active on entry) up to the return of its flag read, span `lm.readback`;
    the read then brings the count of active lanes, which the loop tests
    for non-zero, in place of `any`."""
    if not trace.enabled():
        while host_read((~ended(state)).any()):
            state = step(state)
        return state
    phase = "rescue" if trace.inside("lm.rescue") else phase
    live = ~ended(state)
    with trace.span("lm.solve", phase=phase, width=live.shape[0]):
        with trace.span("lm.readback"):
            active = host_read(live.sum())
        while active:
            with trace.span("lm.iteration", active=active):
                state = step(state)
                with trace.span("lm.readback"):
                    active = host_read((~ended(state)).sum())
    return state


def _solve_batched(params, spec, cfg, obs, s0: OptState, cube_radius, pose_known, packs,
                   code_known: bool = False, phase: str = "main"):
    def step(s):
        new = lm_iteration(params, spec, cfg, obs, s, cube_radius, pose_known, packs, code_known)
        return _freeze_if_done(s, new)

    s = _loop(step, s0, lambda s: s.done | s.failed, phase)
    return OptResult(s.latent, s.T_ow, s.iter_count, s.failed, s.converged)


def _solve_tr(params, spec, cfg, obs, latent0, T_ow0, cube_radius, pose_known, packs,
              phase: str = "main"):
    def step(ts):
        return _freeze_if_done_tr(ts, lm_iteration_tr(params, spec, cfg, obs, ts, cube_radius,
                                                      pose_known, packs))

    ts = _loop(step, init_tr_state(latent0, T_ow0, cfg),
               lambda ts: ts.base.done | ts.base.failed, phase)
    return _tr_result(ts)


def _solve(params, spec, cfg, obs, latent0, T_ow0, cube_radius, pose_known, packs,
           phase: str = "main") -> OptResult:
    """The configured single-phase solver: trust region or fixed lambda;
    `phase` names its loop's span."""
    if cfg.trust_region:
        return _solve_tr(params, spec, cfg, obs, latent0, T_ow0, cube_radius, pose_known, packs,
                         phase)
    return _solve_batched(params, spec, cfg, obs, init_state(latent0, T_ow0), cube_radius,
                          pose_known, packs, phase=phase)


def _prepare(device, cfg: JointOptConfig, obs: FruitObservations, *tensors: torch.Tensor):
    """Entry-point set-up: the device (CUDA unless asked for the CPU), the
    port check of the config, and the batch moved onto the device."""
    dev = resolve_device(device)
    cfg.check_ported()
    return (dev, FruitObservations(*(t.to(dev) for t in obs)), *(t.to(dev) for t in tensors))


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
    freeze and the loop ends when the slowest lane finishes. With
    `cfg.trust_region` each lane carries its own adaptive lambda."""
    _, obs, latent0, T_ow0 = _prepare(device, cfg, obs, latent0, T_ow0)
    if packs is None:
        packs = make_packs(params, spec, cfg)
    return _solve(params, spec, cfg, obs, latent0, T_ow0, cube_radius, pose_known, packs)


def pose_polish_batched(
    params: Params,
    spec: DecoderSpec,
    cfg: JointOptConfig,
    obs: FruitObservations,
    res: OptResult,
    cube_radius: float,
    device: str | torch.device = "cuda",
    packs: Optional[Packs] = None,
) -> OptResult:
    """Code-frozen pose polish: up to `cfg.pose_polish_iters` more LM
    iterations from the joint solution with the code block of every step
    zeroed. Lanes that failed the main solve do not polish; `iter_count`
    bills main + polish iterations; `failed` and `converged` stay the main
    solve's verdict."""
    _, obs, *fields = _prepare(device, cfg, obs, *res)
    res = OptResult(*fields)
    if packs is None:
        packs = make_packs(params, spec, cfg)
    polish_cfg = dataclasses.replace(cfg, max_iter=cfg.pose_polish_iters)
    s0 = init_state(res.latent, res.T_ow)._replace(done=res.failed, failed=res.failed)
    final = _solve_batched(params, spec, polish_cfg, obs, s0, cube_radius, False, packs,
                           code_known=True, phase="polish")
    return OptResult(res.latent, final.T_ow, res.iter_count + final.iter_count, res.failed,
                     res.converged)


def maybe_pose_polish(params, spec, cfg, obs, res, cube_radius, pose_known=False,
                      device: str | torch.device = "cuda", packs: Optional[Packs] = None):
    """The configured pose polish (`pose_polish_iters` > 0); a no-op under
    `pose_known`, where there is no pose to polish."""
    if cfg.pose_polish_iters > 0 and not pose_known:
        return pose_polish_batched(params, spec, cfg, obs, res, cube_radius, device, packs)
    return res


def _configured_solve(params, spec, cfg, obs, latent0, T_ow0, cube_radius, pose_known, device,
                      packs) -> OptResult:
    """The configured solver: coarse-to-fine or single phase by
    `cfg.coarse_to_fine`, then the configured pose polish."""
    solver = coarse_to_fine_joint_opt if cfg.coarse_to_fine else shape_pose_joint_opt_batched
    res = solver(params, spec, cfg, obs, latent0, T_ow0, cube_radius, pose_known, device, packs)
    return maybe_pose_polish(params, spec, cfg, obs, res, cube_radius, pose_known, device, packs)


def _continue_joint_opt_batched(params, spec, cfg, obs, latent0, T_ow0, cube_radius,
                                pose_known, start_iter: int, packs) -> OptResult:
    """Fixed-lambda batched solve starting from iteration `start_iter`
    (the staged solver's second stage)."""
    return _solve_batched(params, spec, cfg, obs, init_state(latent0, T_ow0, start_iter),
                          cube_radius, pose_known, packs)


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
    _, obs, latent0, T_ow0 = _prepare(device, cfg, obs, latent0, T_ow0)
    if packs is None:
        packs = make_packs(params, spec, cfg)
    coarse_obs, coarse_cfg = subsample_observations(obs, cfg)
    r_a = _solve(params, spec, coarse_cfg, coarse_obs, latent0, T_ow0, cube_radius, pose_known,
                 packs, "coarse")
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
    r_b = _solve(params, spec, fine_cfg, fine_obs, lat1, T1, cube_radius, pose_known, packs,
                 "fine")
    return r_b._replace(iter_count=r_a.iter_count + r_b.iter_count)


def staged_joint_opt(
    params: Params,
    spec: DecoderSpec,
    cfg: JointOptConfig,
    obs: FruitObservations,
    latent0: torch.Tensor,
    T_ow0: torch.Tensor,
    cube_radius: float,
    pose_known: bool = False,
    stage1_iters: Optional[int] = None,
    device: str | torch.device = "cuda",
    packs: Optional[Packs] = None,
) -> OptResult:
    """Two-stage batched solve: every lane runs `stage1_iters` iterations,
    then only the lanes that neither converged nor failed continue (gathered
    on the device; only the per-lane flags reach the host). Per-lane math is
    that of the single-stage solver."""
    _, obs, latent0, T_ow0 = _prepare(device, cfg, obs, latent0, T_ow0)
    if packs is None:
        packs = make_packs(params, spec, cfg)
    B = latent0.shape[0]
    m1 = stage1_iters if stage1_iters is not None else max(cfg.max_iter // 2, 1)
    if m1 >= cfg.max_iter or B <= 1:
        return _solve(params, spec, cfg, obs, latent0, T_ow0, cube_radius, pose_known, packs)
    r1 = _solve(params, spec, dataclasses.replace(cfg, max_iter=m1), obs, latent0, T_ow0,
                cube_radius, pose_known, packs)
    idx = torch.nonzero(~(r1.converged | r1.failed)).reshape(-1)
    if idx.numel() == 0:
        return r1
    obs2 = FruitObservations(*(a[idx] for a in obs))
    r2 = _continue_joint_opt_batched(params, spec, cfg, obs2, r1.latent[idx], r1.T_ow[idx],
                                     cube_radius, pose_known, m1, packs)

    def merge(a1, a2):
        out = a1.clone()
        out[idx] = a2
        return out

    return OptResult(*(merge(a1, a2) for a1, a2 in zip(r1, r2)))


def solve_in_chunks(
    params: Params,
    spec: DecoderSpec,
    cfg: JointOptConfig,
    obs: FruitObservations,
    latent0: torch.Tensor,
    T_ow0: torch.Tensor,
    cube_radius: float,
    pose_known: bool = False,
    max_batch: Optional[int] = None,
    device: str | torch.device = "cuda",
    packs: Optional[Packs] = None,
) -> OptResult:
    """The configured solver (coarse-to-fine or single phase, then the pose
    polish) in chunks of at most `max_batch` fruits: 64 with the fused
    render kernel (no dense activations), 16 on the dense render path. The
    last chunk is padded to `max_batch` with invalid lanes that fail at
    their first iteration, the lane semantics of the JAX package's padded
    chunk."""
    _, obs, latent0, T_ow0 = _prepare(device, cfg, obs, latent0, T_ow0)
    if packs is None:
        packs = make_packs(params, spec, cfg)
    if max_batch is None:
        max_batch = 64 if cfg.fused_resolved(spec) else 16

    def solver(o, lat, T):
        return _configured_solve(params, spec, cfg, o, lat, T, cube_radius, pose_known,
                                 lat.device, packs)

    B = latent0.shape[0]
    if B <= max_batch:
        return solver(obs, latent0, T_ow0)
    outs = []
    for lo in range(0, B, max_batch):
        hi = min(lo + max_batch, B)
        obs_c = FruitObservations(*(a[lo:hi] for a in obs))
        lat_c, T_c = latent0[lo:hi], T_ow0[lo:hi]
        if hi - lo < max_batch:
            obs_c, lat_c, T_c, _ = pad_to_multiple(obs_c, lat_c, T_c, max_batch)
        outs.append(OptResult(*(a[: hi - lo] for a in solver(obs_c, lat_c, T_c))))
    return OptResult(*(torch.cat(xs) for xs in zip(*outs)))


def shape_opt_deepsdf_batched(
    params: Params,
    spec: DecoderSpec,
    cfg: JointOptConfig,
    points_o: torch.Tensor,     # [B, P, 3] surface points already in the object frame
    point_valid: torch.Tensor,  # [B, P] bool
    latent0: torch.Tensor,      # [B, C]
    device: str | torch.device = "cuda",
    packs: Optional[Packs] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSDF baseline: a code-only LM over the SDF term with the pose
    frozen, every fruit a lane. Per iteration i: the SDF residuals and their
    code Jacobian (through the fwd+input-grad kernel where the decoder is
    kernel-supported, finished lanes skipped), Huber weights from
    `robust_iter` on, the code prior, the configured damping, one C x C
    solve. A lane finishes when its gradient or code step falls under its
    epsilon (from i = 2 on) or at `max_iter`; its `iters` stops at i + 1 in
    that step and its latent is kept bit for bit from then on. Returns
    (latents [B, C], iteration counts [B] int32)."""
    dev = resolve_device(device)
    points_o, point_valid, latent = (t.to(dev) for t in (points_o, point_valid, latent0))
    if packs is None:
        packs = make_packs(params, spec, cfg)
    B, C = latent.shape
    f32 = torch.float32
    count = point_valid.sum(-1).to(f32)
    eye = torch.eye(C, dtype=f32, device=dev)
    iters = torch.zeros(B, dtype=torch.int32, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    i = 0
    while not bool(done.all()):
        rec = sdf_residuals(params, spec, latent, points_o, point_valid, False, packs.sdf, ~done)
        w2 = _robust_w2(rec.res, cfg.recon_robust_th_m,
                        torch.tensor(i >= cfg.robust_iter, device=dev))
        H, b = _term_normal_eq(rec.jac[..., 6:], rec.res, w2, count, cfg.w_recon)
        H = H + cfg.w_codereg * eye
        b = b - cfg.w_codereg * latent
        H = apply_lm_damping(H, cfg)
        delta_c = linalg.solve(H, b)
        lat_new = latent + delta_c
        conv = (((b.abs().max(-1).values < cfg.epsilon_g)
                 | ((delta_c / (lat_new + 1e-12)).abs().max(-1).values < cfg.epsilon_c))
                & (i > 1))
        latent = torch.where(done[:, None], latent, lat_new)
        iters = torch.where(done, iters, torch.full_like(iters, i + 1))
        done = done | conv | (i >= cfg.max_iter - 1)
        i += 1
    return latent, iters


def shape_opt_deepsdf(
    params: Params,
    spec: DecoderSpec,
    cfg: JointOptConfig,
    points_o: torch.Tensor,     # [P, 3]
    point_valid: torch.Tensor,  # [P] bool
    latent0: torch.Tensor,      # [C]
    device: str | torch.device = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DeepSDF baseline for one fruit: `shape_opt_deepsdf_batched` at
    B = 1. Returns (latent [C], iteration count)."""
    dev = resolve_device(device)
    lat, iters = shape_opt_deepsdf_batched(params, spec, cfg, points_o[None], point_valid[None],
                                           latent0[None], dev)
    return lat[0], iters[0]


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


def _one_lane(obs: FruitObservations, latent0, T_ow0):
    """A single fruit's observations, latent and pose (numpy or tensors) as
    a batch of one, floating fields in f32 as the JAX package takes them."""
    def lane(a):
        t = torch.as_tensor(a)
        return (t.float() if t.is_floating_point() else t)[None]

    return FruitObservations(*(lane(a) for a in obs)), lane(latent0), lane(T_ow0)


def shape_pose_joint_opt(
    params: Params,
    spec: DecoderSpec,
    cfg: JointOptConfig,
    obs: FruitObservations,   # one fruit: no leading axis
    latent0,                  # [C]
    T_ow0,                    # [4, 4]
    cube_radius: float,
    pose_known: bool = False,
    device: str | torch.device = "cuda",
) -> OptResult:
    """One fruit: the batched solver on a batch of one, its fields without
    the leading axis. In a wider batch a lane's arithmetic is the same up
    to the summation order of PyTorch's batched reductions (ulps, which a
    lane on a render-band edge can carry further)."""
    dev = resolve_device(device)
    res = shape_pose_joint_opt_batched(params, spec, cfg, *_one_lane(obs, latent0, T_ow0),
                                       cube_radius, pose_known, dev)
    return OptResult(*(a[0] for a in res))


def shape_pose_joint_opt_traced(
    params: Params,
    spec: DecoderSpec,
    cfg: JointOptConfig,
    obs: FruitObservations,   # one fruit: no leading axis
    latent0,                  # [C]
    T_ow0,                    # [4, 4]
    cube_radius: float,
    pose_known: bool = False,
    device: str | torch.device = "cuda",
) -> Tuple[OptResult, Tuple[torch.Tensor, torch.Tensor]]:
    """`shape_pose_joint_opt` (fixed lambda) that also returns the state
    after each of exactly `cfg.max_iter` iterations: (latents [max_iter, C],
    poses [max_iter, 4, 4]). Once the lane is done or failed, its entries
    repeat the frozen state, as the JAX package's fixed-length scan does.
    The loop never reads a value back to the host; the trajectory stays on
    the device, one stacked tensor per field for the caller to copy once."""
    dev = resolve_device(device)
    _, obs_b, lat_b, T_b = _prepare(dev, cfg, *_one_lane(obs, latent0, T_ow0))
    packs = make_packs(params, spec, cfg)
    s = init_state(lat_b, T_b)
    latents, poses = [], []
    for _ in range(cfg.max_iter):
        s = _freeze_if_done(s, lm_iteration(params, spec, cfg, obs_b, s, cube_radius, pose_known,
                                             packs))
        latents.append(s.latent[0])
        poses.append(s.T_ow[0])
    res = OptResult(s.latent[0], s.T_ow[0], s.iter_count[0], s.failed[0], s.converged[0])
    return res, (torch.stack(latents), torch.stack(poses))


def joint_opt(
    params: Params,
    spec: DecoderSpec,
    cfg: JointOptConfig,
    obs: FruitObservations,   # leading fruit axis
    latent0: torch.Tensor,    # [B, C]
    T_ow0: torch.Tensor,      # [B, 4, 4]
    cube_radius: float,
    pose_known: bool = False,
    latent_table: Optional[torch.Tensor] = None,
    device: str | torch.device = "cuda",
    packs: Optional[Packs] = None,
) -> OptResult:
    """The single-start solve of serving and of each shard of the fruit mesh
    (`parallel/sharding.shard_joint_opt`): the retrieval warm start where
    `cfg.init_mode` is "retrieval" and a `latent_table` is given, then the
    configured solver (coarse-to-fine or single phase), then the configured
    pose polish. `packs` lets a caller that solves many batches pack the
    weights once (with the scoring decoder where it retrieves)."""
    dev, obs, latent0, T_ow0 = _prepare(device, cfg, obs, latent0, T_ow0)
    retrieve = cfg.init_mode == "retrieval" and latent_table is not None
    if packs is None:
        packs = make_packs(params, spec, cfg, score=retrieve)
    if retrieve:
        from hortimapping_tpu_torch.optim.warmstart import maybe_retrieval_init

        latent0, T_ow0 = maybe_retrieval_init(params, spec, cfg, latent_table, obs, latent0,
                                              T_ow0, dev, packs)
    return _configured_solve(params, spec, cfg, obs, latent0, T_ow0, cube_radius, pose_known,
                             dev, packs)


def joint_opt_packed(
    params: Params,
    spec: DecoderSpec,
    cfg: JointOptConfig,
    obs: FruitObservations,   # leading fruit axis
    latent0: torch.Tensor,    # [B, C]
    T_ow0: torch.Tensor,      # [B, 4, 4]
    cube_radius: float,
    pose_known: bool = False,
    latent_table: Optional[torch.Tensor] = None,
    device: str | torch.device = "cuda",
    packs: Optional[Packs] = None,
) -> Tuple[OptResult, torch.Tensor]:
    """The serving solve, returning (result, `pack_result(result)`): `joint_opt`
    with its result packed into one device buffer, so a batch's solve
    crosses to the host in one copy."""
    res = joint_opt(params, spec, cfg, obs, latent0, T_ow0, cube_radius, pose_known,
                    latent_table, device, packs)
    return res, pack_result(res)
