"""Retrieval warm start (counterpart of `hortimapping_tpu/optim/warmstart.py`
for `_score_codes`, `retrieval_init_batched` and `retrieval_joint_opt`).

Every trained code is scored against the observed partial cloud (mean
|clamped sdf| over a point subsample, at each candidate pose scale) and the
best (code, scale) pair seeds the solve. Scoring is a plain decoder forward:
the JAX package leaves it to XLA, so here it is `torch.matmul` (bf16 on the
card when asked). The fruit axis is scored in `score_chunk`-wide blocks and
large code tables in `block_elems / P`-code blocks, which bounds the
activation memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hortimapping_tpu_torch.config import JointOptConfig
from hortimapping_tpu_torch.device import resolve_device
from hortimapping_tpu_torch.models.decoder import DecoderSpec, Params, decoder_apply
from hortimapping_tpu_torch.optim.state import FruitObservations, OptResult


def _score_codes(
    params: Params,
    spec: DecoderSpec,
    codes: torch.Tensor,    # [N, C]
    points: torch.Tensor,   # [G, P, 3] object-frame points, G = fruits x scales
    valid: torch.Tensor,    # [G, P] bool
    bf16: bool = False,
    block_elems: int = 1 << 15,
) -> torch.Tensor:
    """Mean |clamped sdf| of each code over each point set: [G, N]."""
    N, C = codes.shape
    G, P, _ = points.shape
    dtype = torch.bfloat16 if bf16 else torch.float32
    count = torch.clamp(valid.sum(-1), min=1).to(torch.float32)               # [G]

    def score_block(blk):                                                    # [Nb, C] -> [G, Nb]
        nb = blk.shape[0]
        inp = torch.cat(
            [blk[None, :, None, :].expand(G, nb, P, C), points[:, None].expand(G, nb, P, 3)],
            dim=-1,
        )
        sdf = decoder_apply(params, spec, inp.reshape(-1, C + 3), dtype).reshape(G, nb, P)
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
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best (code, scale) start per fruit: (latent0 [B, C], T_ow0 [B, 4, 4],
    top_codes [B, K, C], top_T [B, K, 4, 4]). The retrieved scale composes
    onto T_init as diag(s, s, s, 1) @ T_init."""
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

    scores = []
    for lo in range(0, B, score_chunk):
        blk = sub[lo:lo + score_chunk]                                        # [b, P, 3]
        nb = blk.shape[0]
        cand_pts = (scales[None, :, None, None] * blk[:, None]).reshape(nb * S, P, 3)
        cand_v = sub_v[lo:lo + score_chunk, None].expand(nb, S, P).reshape(nb * S, P)
        scores.append(_score_codes(params, spec, latent_table, cand_pts, cand_v,
                                   bf16=score_bf16).reshape(nb, S, N))
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
    single-phase)."""
    from hortimapping_tpu_torch.optim.lm import (
        coarse_to_fine_joint_opt,
        shape_pose_joint_opt_batched,
    )

    dev = resolve_device(device)
    cfg.check_ported()
    obs = FruitObservations(*(t.to(dev) for t in obs))
    lat_r, T_r, _, _ = retrieval_init_batched(
        params, spec, latent_table.to(dev), obs.points_w, obs.point_valid,
        top_k=top_k, n_score_pts=n_score_pts, n_scales=n_scales,
        scale_min=scale_min, scale_max=scale_max, T_init=T_init.to(dev),
        score_bf16=score_bf16, prior_w=cfg.retrieval_prior_w,
    )
    solver = coarse_to_fine_joint_opt if cfg.coarse_to_fine else shape_pose_joint_opt_batched
    return solver(params, spec, cfg, obs, lat_r, T_r, cube_radius, pose_known, device=dev)
