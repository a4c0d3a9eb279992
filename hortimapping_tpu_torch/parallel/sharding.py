"""Fruit-batch padding (counterpart of `pad_to_multiple` in
`hortimapping_tpu/parallel/sharding.py`; the fruit-parallel mesh itself is
not ported)."""

from __future__ import annotations

from typing import Tuple

import torch

from hortimapping_tpu_torch.optim.state import FruitObservations


def pad_to_multiple(
    obs: FruitObservations,
    latent0: torch.Tensor,
    T_ow0: torch.Tensor,
    multiple: int,
) -> Tuple[FruitObservations, torch.Tensor, torch.Tensor, int]:
    """Pad the fruit batch (leading axis) to a multiple of `multiple`.

    Padded lanes carry `frame_valid=False` / `point_valid=False` /
    `ray_valid=False`, so the solver marks them failed on their first
    iteration; their other buffers repeat the last real lane, so their math
    stays well-conditioned, their code is zero and their pose the identity.
    Returns (obs, latent0, T_ow0, original batch size).
    """
    B = latent0.shape[0]
    rem = (-B) % multiple
    if rem == 0:
        return obs, latent0, T_ow0, B

    def pad(x: torch.Tensor, invalidate: bool) -> torch.Tensor:
        if invalidate or x.dtype == torch.bool:
            block = torch.zeros((rem,) + x.shape[1:], dtype=x.dtype, device=x.device)
        else:
            block = x[-1:].expand((rem,) + x.shape[1:])
        return torch.cat([x, block])

    obs_p = FruitObservations(
        T_wc=pad(obs.T_wc, False),
        rays=pad(obs.rays, False),
        ray_valid=pad(obs.ray_valid, True),
        depth_obs=pad(obs.depth_obs, False),
        frame_valid=pad(obs.frame_valid, True),
        points_w=pad(obs.points_w, False),
        point_valid=pad(obs.point_valid, True),
    )
    eye = torch.eye(4, dtype=T_ow0.dtype, device=T_ow0.device).expand(rem, 4, 4)
    return (
        obs_p,
        torch.cat([latent0, torch.zeros((rem,) + latent0.shape[1:], dtype=latent0.dtype,
                                        device=latent0.device)]),
        torch.cat([T_ow0, eye]),
        B,
    )
