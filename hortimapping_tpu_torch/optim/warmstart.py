"""Latent warm starts: retrieval init, multi-start selection and the
selective rescue (counterpart of `hortimapping_tpu/optim/warmstart.py`).

Every trained code is scored against the observed partial cloud (mean
|clamped sdf| over a point subsample, at each candidate pose scale) and the
best (code, scale) pair seeds the solve. Scoring is a decoder forward
through the forward kernel B3 (`ops/mlp_kernels.mlp_sdf`, the semantics of
the JAX package's `PallasDecoder.sdf`), bf16 or f32 as configured. The
fruit axis is scored in `score_chunk`-wide blocks and large code tables in
`block_elems / P`-code blocks, which bounds the input each launch reads.

`multi_start_joint_opt` solves from the top-K retrieved starts in one
widened batch and keeps, per fruit, the lowest final LM objective.
`selective_rescue` re-solves only the hard lanes of a batch (unconverged, or
a robust outlier of the objective) that way, and replaces a lane only where
the rescue's objective is strictly lower. `warmstart_solve` is the one call
site of the pipelines: retrieval, multi-start or the chunked solve, then the
rescue, as the config says.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from hortimapping_tpu_torch.config import JointOptConfig
from hortimapping_tpu_torch.models.decoder import DecoderSpec, Params, decoder_apply
from hortimapping_tpu_torch.ops import mlp_kernels
from hortimapping_tpu_torch.optim import lm
from hortimapping_tpu_torch.optim.state import FruitObservations, OptResult
from hortimapping_tpu_torch.utils import trace

# Per-lane evidence of the most recent `selective_rescue` of a
# `warmstart_solve` (cleared at every call): which lanes were re-solved, the
# objectives before and after, which were accepted. A diagnostics payload,
# kept beside the unchanged return signature as in the JAX package.
LAST_RESCUE_INFO: dict = {}


def _score_codes(
    params: Params,
    spec: DecoderSpec,
    codes: torch.Tensor,    # [N, C]
    points: torch.Tensor,   # [G, P, 3] object-frame points, G = fruits x scales
    valid: torch.Tensor,    # [G, P] bool
    bf16: bool = False,
    block_elems: int = 1 << 15,
    decoder: Optional[mlp_kernels.KernelDecoder] = None,
) -> torch.Tensor:
    """Mean |clamped sdf| of each code over each point set: [G, N]. Scores
    through the forward kernel of `decoder` (packed in the storage type
    `bf16` picks) where one is given, else through the plain decoder
    forward in that type."""
    N, C = codes.shape
    G, P, _ = points.shape
    dtype = torch.bfloat16 if bf16 else torch.float32
    count = torch.clamp(valid.sum(-1), min=1).to(torch.float32)               # [G]

    def score_block(blk):                                                    # [Nb, C] -> [G, Nb]
        nb = blk.shape[0]
        inp = torch.cat(
            [blk[None, :, None, :].expand(G, nb, P, C), points[:, None].expand(G, nb, P, 3)],
            dim=-1,
        ).reshape(-1, C + 3)
        if decoder is not None:
            sdf = decoder.sdf(inp).reshape(G, nb, P)
        else:
            sdf = decoder_apply(params, spec, inp, dtype).reshape(G, nb, P)
        # clamp: far-off codes saturate at the clamping distance instead of
        # dominating the mean through tanh tails
        err = torch.clamp(sdf.abs(), max=spec.clamping_distance)
        return (err * valid[:, None, :]).sum(-1) / count[:, None]

    if N * P <= block_elems:
        return score_block(codes)
    nb_sz = max(1, block_elems // P)
    return torch.cat([score_block(codes[i:i + nb_sz]) for i in range(0, N, nb_sz)], dim=1)


def _linspace1(lo: float, hi: float, num: int, device) -> torch.Tensor:
    """`jnp.linspace(lo, hi, num)` in f32, in its op order."""
    if num == 1:
        return torch.tensor([lo], dtype=torch.float32, device=device)
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / (num - 1)
    lo_t = torch.tensor(lo, dtype=torch.float32, device=device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=device)
    return torch.cat([lo_t * (1 - step) + hi_t * step, hi_t[None]])


def retrieval_init_batched(
    params: Params,
    spec: DecoderSpec,
    latent_table: torch.Tensor,   # [N, C]
    points_w: torch.Tensor,       # [B, P, 3] observed cloud, world frame
    point_valid: torch.Tensor,    # [B, P] bool
    top_k: int = 8,
    n_score_pts: int = 256,
    n_scales: int = 5,
    scale_min: float = 0.85,
    scale_max: float = 1.2,
    T_init: Optional[torch.Tensor] = None,   # [B, 4, 4]; None = identity
    score_bf16: bool = False,
    prior_w: float = 0.0,
    score_chunk: int = 16,
    decoder: Optional[mlp_kernels.KernelDecoder] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best (code, scale) start per fruit: (latent0 [B, C], T_ow0 [B, 4, 4],
    top_codes [B, K, C], top_T [B, K, 4, 4]). The retrieved scale composes
    onto T_init as diag(s, s, s, 1) @ T_init. Scores through `decoder`
    (packed here per `score_bf16` when not given and the spec is
    kernel-supported)."""
    N, C = latent_table.shape
    B = points_w.shape[0]
    dev = points_w.device
    f32 = torch.float32
    scales = _linspace1(scale_min, scale_max, n_scales, dev)                 # [S]
    S = scales.shape[0]
    if T_init is None:
        T_init = torch.eye(4, dtype=f32, device=dev).expand(B, 4, 4)
    pts = points_w @ T_init[:, :3, :3].transpose(1, 2) + T_init[:, None, :3, 3]
    sub = pts[:, :n_score_pts]
    sub_v = point_valid[:, :n_score_pts]
    P = sub.shape[1]

    if decoder is None and mlp_kernels.supported(spec):
        decoder = mlp_kernels.KernelDecoder(params, spec, bf16=score_bf16)
    scores = []
    for lo in range(0, B, score_chunk):
        blk = sub[lo:lo + score_chunk]                                        # [b, P, 3]
        nb = blk.shape[0]
        cand_pts = (scales[None, :, None, None] * blk[:, None]).reshape(nb * S, P, 3)
        cand_v = sub_v[lo:lo + score_chunk, None].expand(nb, S, P).reshape(nb * S, P)
        scores.append(_score_codes(params, spec, latent_table, cand_pts, cand_v,
                                   bf16=score_bf16, decoder=decoder).reshape(nb, S, N))
    s = torch.cat(scores)                                                    # [B, S, N]
    if prior_w > 0.0:
        mean_code = latent_table.mean(0)
        dist = torch.linalg.norm(latent_table - mean_code[None], dim=1) / (C ** 0.5)
        s = s + prior_w * dist[None, None, :]
    per_code = s.min(1).values                                               # [B, N]
    top_idx = torch.topk(-per_code, top_k, dim=1).indices                    # [B, K]
    s_top = torch.gather(s, 2, top_idx[:, None, :].expand(B, S, top_k))      # [B, S, K]
    flat = torch.argmin(s_top.reshape(B, -1), dim=1)
    si, ki = flat // top_k, flat % top_k
    cand = latent_table[top_idx]                                             # [B, K, C]
    best_scale_per_k = scales[torch.argmin(s_top, dim=1)]                    # [B, K]

    def scale_T(sig, T):                                                     # sig [...] T [..., 4, 4]
        d = torch.stack([sig, sig, sig, torch.ones_like(sig)], dim=-1)
        return d[..., :, None] * T

    ar = torch.arange(B, device=dev)
    return (
        cand[ar, ki],
        scale_T(scales[si], T_init),
        cand,
        scale_T(best_scale_per_k, T_init[:, None]),
    )


def maybe_retrieval_init(
    params: Params,
    spec: DecoderSpec,
    opt_cfg: JointOptConfig,
    latent_table: torch.Tensor,   # [N, C]
    obs: FruitObservations,       # leading fruit axis
    latent0: torch.Tensor,        # [B, C] fallback (table-mean) init
    T_ow0: torch.Tensor,          # [B, 4, 4] pose init
    device: str | torch.device = "cuda",
    packs: Optional[lm.Packs] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """With `init_mode: retrieval` the retrieved (code, scale) start per
    fruit; otherwise the inputs unchanged. `packs.score`, where given, is
    the scoring decoder."""
    _, obs, latent0, T_ow0, latent_table = lm._prepare(device, opt_cfg, obs, latent0, T_ow0,
                                                         latent_table)
    if opt_cfg.init_mode != "retrieval":
        return latent0, T_ow0
    lat, T, _, _ = _retrieve(params, spec, opt_cfg, latent_table, obs, T_ow0, packs=packs)
    return lat, T


def _retrieve(params, spec, cfg: JointOptConfig, latent_table, obs, T_init,
              top_k: Optional[int] = None, packs: Optional[lm.Packs] = None):
    return retrieval_init_batched(
        params, spec, latent_table, obs.points_w, obs.point_valid,
        top_k=cfg.retrieval_top_k if top_k is None else top_k,
        n_score_pts=cfg.retrieval_score_pts, n_scales=cfg.retrieval_n_scales,
        scale_min=cfg.retrieval_scale_min, scale_max=cfg.retrieval_scale_max,
        T_init=T_init, score_bf16=cfg.retrieval_score_bf16, prior_w=cfg.retrieval_prior_w,
        decoder=None if packs is None else packs.score,
    )


def warmstart_solve(
    params: Params,
    spec: DecoderSpec,
    opt_cfg: JointOptConfig,
    latent_table: torch.Tensor,   # [N, C]
    obs: FruitObservations,       # leading fruit axis
    latent0: torch.Tensor,        # [B, C] fallback (table-mean) init
    T_ow0: torch.Tensor,          # [B, 4, 4] pose init
    cube_radius: float,
    pose_known: bool = False,
    device: str | torch.device = "cuda",
) -> OptResult:
    """Init dispatch + solve for the batched pipelines: the retrieval warm
    start (`init_mode: retrieval`), the multi-start over the top-K
    retrieved codes (`multi_start > 1`) or the configured chunked solve
    (coarse-to-fine or single phase, trust region or fixed lambda, pose
    polish), then the selective rescue (`rescue_starts > 0`)."""
    global LAST_RESCUE_INFO
    dev, obs, latent0, T_ow0, latent_table = lm._prepare(device, opt_cfg, obs, latent0, T_ow0,
                                                         latent_table)
    packs = lm.make_packs(params, spec, opt_cfg, score=opt_cfg.init_mode == "retrieval")
    top_codes = top_T = None
    T_orig = T_ow0  # the rescue re-retrieves from these, not the scale-composed ones
    if opt_cfg.init_mode == "retrieval":
        latent0, T_ow0, top_codes, top_T = _retrieve(params, spec, opt_cfg, latent_table, obs,
                                                     T_ow0, packs=packs)
    if top_codes is not None and opt_cfg.multi_start > 1:
        K = min(opt_cfg.multi_start, opt_cfg.retrieval_top_k)
        return multi_start_joint_opt(params, spec, opt_cfg, obs, top_codes[:, :K], top_T[:, :K],
                                     cube_radius, pose_known, dev, packs)
    LAST_RESCUE_INFO = {}
    res = lm.solve_in_chunks(params, spec, opt_cfg, obs, latent0, T_ow0, cube_radius, pose_known,
                             device=dev, packs=packs)
    if opt_cfg.rescue_starts > 0 and opt_cfg.init_mode == "retrieval":
        # while tracing is on: span `lm.rescue`, whose LM loops take phase `rescue`
        with trace.span("lm.rescue"):
            res, LAST_RESCUE_INFO = selective_rescue(params, spec, opt_cfg, obs, res,
                                                     latent_table, T_orig, cube_radius,
                                                     pose_known, dev, packs)
    return res


def retrieval_joint_opt(
    params: Params,
    spec: DecoderSpec,
    cfg: JointOptConfig,
    latent_table: torch.Tensor,
    obs: FruitObservations,   # leading fruit axis
    T_init: torch.Tensor,     # [B, 4, 4]
    cube_radius: float,
    pose_known: bool = False,
    top_k: int = 8,
    n_score_pts: int = 256,
    n_scales: int = 5,
    scale_min: float = 0.85,
    scale_max: float = 1.2,
    score_bf16: bool = False,
    device: str | torch.device = "cuda",
) -> OptResult:
    """Retrieval warm start, then the configured solver (two-resolution or
    single-phase) and the configured pose polish."""
    dev, obs, T_init, latent_table = lm._prepare(device, cfg, obs, T_init, latent_table)
    packs = lm.make_packs(params, spec, cfg)
    lat_r, T_r, _, _ = retrieval_init_batched(
        params, spec, latent_table, obs.points_w, obs.point_valid,
        top_k=top_k, n_score_pts=n_score_pts, n_scales=n_scales,
        scale_min=scale_min, scale_max=scale_max, T_init=T_init,
        score_bf16=score_bf16, prior_w=cfg.retrieval_prior_w,
    )
    return lm._configured_solve(params, spec, cfg, obs, lat_r, T_r, cube_radius, pose_known, dev,
                                packs)


def objective_value_batched(
    params: Params,
    spec: DecoderSpec,
    cfg: JointOptConfig,
    obs: FruitObservations,   # leading fruit axis
    latent: torch.Tensor,     # [B, C]
    T_ow: torch.Tensor,       # [B, 4, 4]
    cube_radius: float,
    device: str | torch.device = "cuda",
    packs: Optional[lm.Packs] = None,
) -> torch.Tensor:
    """The LM objective at (latent, T_ow) per fruit [B], with the Huber
    weighting on (past the ramp-in): the selection metric of the
    multi-start and the rescue. Failed lanes (no valid rays) score +inf."""
    _, obs, latent, T_ow = lm._prepare(device, cfg, obs, latent, T_ow)
    if packs is None:
        packs = lm.make_packs(params, spec, cfg)
    i = torch.full((latent.shape[0],), 2 ** 20, dtype=torch.int32, device=latent.device)
    _, _, failed, cost = lm._assemble_normal_equations(params, spec, cfg, obs, latent, T_ow, i,
                                                       cube_radius, None, packs)
    return torch.where(failed, torch.full_like(cost, torch.inf), cost)


def selective_rescue(
    params: Params,
    spec: DecoderSpec,
    cfg: JointOptConfig,
    obs: FruitObservations,      # leading fruit axis [B, ...]
    res: OptResult,              # the normal solve's result
    latent_table: torch.Tensor,  # [N, C]
    T_init: torch.Tensor,        # [B, 4, 4] the pose inits before retrieval
    cube_radius: float,
    pose_known: bool = False,
    device: str | torch.device = "cuda",
    packs: Optional[lm.Packs] = None,
) -> Tuple[OptResult, dict]:
    """Re-solve only the hard lanes as a K-start batch; keep the better.

    A lane is hard if it ran out of budget (`converged` False) or its final
    LM objective is a robust outlier of the batch (log cost > median +
    `rescue_cost_z` * 1.4826 MAD). Each hard lane re-solves from its
    top-`rescue_starts` retrieved candidates (`multi_start_joint_opt`), and
    the rescue replaces the original result only where its objective is
    strictly lower. Returns (result, info), info holding per-lane evidence:
    the lanes re-solved, the objectives before and after, the accepted."""
    dev, obs, T_init, latent_table, *fields = lm._prepare(device, cfg, obs, T_init, latent_table,
                                                          *res)
    res = OptResult(*fields)
    if packs is None:
        packs = lm.make_packs(params, spec, cfg, score=True)
    B = res.latent.shape[0]
    costs = objective_value_batched(params, spec, cfg, obs, res.latent, res.T_ow, cube_radius,
                                    dev, packs).cpu().numpy()
    failed = res.failed.cpu().numpy()
    converged = res.converged.cpu().numpy()

    finite = np.isfinite(costs) & ~failed
    logc = np.log(np.maximum(costs, 1e-30), where=finite, out=np.zeros_like(costs))
    med = np.median(logc[finite]) if finite.any() else 0.0
    mad = np.median(np.abs(logc[finite] - med)) if finite.any() else 0.0
    outlier = finite & (logc > med + cfg.rescue_cost_z * 1.4826 * mad)
    hard = ~failed & (~converged | outlier)
    idx = np.nonzero(hard)[0]
    info = {
        "n_total": int(B), "n_rescued": int(len(idx)),
        "lanes": idx.tolist(),
        "unconverged": np.nonzero(~failed & ~converged)[0].tolist(),
        "outliers": np.nonzero(outlier)[0].tolist(),
        "cost_before": costs[idx].tolist(),
    }
    if len(idx) == 0:
        return res, info

    # the rescue batch is padded to a power of two (repeating its last lane),
    # as in the JAX package, where it bounds the compiled shapes
    n_pad = 1 << (len(idx) - 1).bit_length()
    take = torch.as_tensor(np.concatenate([idx, np.full(n_pad - len(idx), idx[-1], idx.dtype)]),
                           device=dev)
    obs_r = FruitObservations(*(a[take] for a in obs))
    _, _, top_codes, top_T = _retrieve(params, spec, cfg, latent_table, obs_r, T_init[take],
                                       top_k=max(2, cfg.rescue_starts), packs=packs)
    res_r = multi_start_joint_opt(params, spec, cfg, obs_r, top_codes, top_T, cube_radius,
                                  pose_known, dev, packs)
    cost_r = objective_value_batched(params, spec, cfg, obs_r, res_r.latent, res_r.T_ow,
                                     cube_radius, dev, packs).cpu().numpy()

    n = len(idx)
    accept = (cost_r[:n] < costs[idx]) & ~res_r.failed[:n].cpu().numpy()
    info["cost_after"] = cost_r[:n].tolist()
    info["accepted"] = np.nonzero(accept)[0].tolist()
    if not accept.any():
        return res, info
    sel = torch.as_tensor(idx[accept], device=dev)
    src = torch.as_tensor(np.nonzero(accept)[0], device=dev)

    def scatter(a, b):
        out = a.clone()
        out[sel] = b[src]
        return out

    return OptResult(*(scatter(a, b) for a, b in zip(res, res_r))), info


def multi_start_joint_opt(
    params: Params,
    spec: DecoderSpec,
    cfg: JointOptConfig,
    obs: FruitObservations,       # leading fruit axis [B, ...]
    starts_latent: torch.Tensor,  # [B, K, C]
    starts_T: torch.Tensor,       # [B, K, 4, 4]
    cube_radius: float,
    pose_known: bool = False,
    device: str | torch.device = "cuda",
    packs: Optional[lm.Packs] = None,
) -> OptResult:
    """Solve from K starts per fruit in one widened [B*K] batch (fruit-major:
    lanes b*K .. b*K+K-1 share fruit b's buffers) and keep, per fruit, the
    result with the lowest final LM objective."""
    dev, obs, starts_latent, starts_T = lm._prepare(device, cfg, obs, starts_latent, starts_T)
    if packs is None:
        packs = lm.make_packs(params, spec, cfg)
    B, K, C = starts_latent.shape
    obs_rep = FruitObservations(*(a.repeat_interleave(K, dim=0) for a in obs))
    res = lm.solve_in_chunks(params, spec, cfg, obs_rep, starts_latent.reshape(B * K, C),
                             starts_T.reshape(B * K, 4, 4), cube_radius, pose_known,
                             device=dev, packs=packs)
    costs = objective_value_batched(params, spec, cfg, obs_rep, res.latent, res.T_ow,
                                    cube_radius, dev, packs)
    costs = torch.where(res.failed, torch.full_like(costs, torch.inf), costs).reshape(B, K)
    pick = costs.argmin(1) + torch.arange(B, device=dev) * K
    return OptResult(*(a[pick] for a in res))
