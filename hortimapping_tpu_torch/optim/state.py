"""Containers of the batched LM solve (counterpart of
`hortimapping_tpu/optim/state.py`). Every field carries a leading fruit axis
[B]; `jax.vmap` over fruits becomes that axis written out."""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from hortimapping_tpu_torch.device import resolve_device


class FruitObservations(NamedTuple):
    """Observation buffers. Rays are laid out foreground-first: rows
    [0, n_fg) are fg, rows [n_fg, R) bg."""

    T_wc: torch.Tensor          # [B, F, 4, 4] camera-to-world poses
    rays: torch.Tensor          # [B, F, R, 3] cam-frame ray directions
    ray_valid: torch.Tensor     # [B, F, R] bool padding mask
    depth_obs: torch.Tensor     # [B, F, R] observed depths (0 = none)
    frame_valid: torch.Tensor   # [B, F] bool
    points_w: torch.Tensor      # [B, P, 3] measured surface points, world
    point_valid: torch.Tensor   # [B, P] bool


def stack_observations(obs_list: Sequence, device: str | torch.device = "cuda") -> FruitObservations:
    """Stack per-fruit numpy observations (e.g. from `tools/synthetic.
    make_scene`) into one batch on `device`, in one upload per field."""
    dev = resolve_device(device)
    return FruitObservations(*(upload(np.stack([np.asarray(getattr(o, f)) for o in obs_list]), dev)
                               for f in FruitObservations._fields))


def upload(arr, dev: torch.device) -> torch.Tensor:
    """One host array onto `dev`: a bool mask as it is, anything numeric in
    f32."""
    arr = np.asarray(arr)
    return torch.as_tensor(arr if arr.dtype == np.bool_ else arr.astype(np.float32)).to(dev)


class OptState(NamedTuple):
    """LM loop carry, one entry per fruit."""

    latent: torch.Tensor        # [B, C]
    T_ow: torch.Tensor          # [B, 4, 4] world -> object (Sim(3))
    i: torch.Tensor             # [B] int32 next iteration index
    iter_count: torch.Tensor    # [B] int32 completed iterations
    done: torch.Tensor          # [B] bool converged | max-iter | failed
    failed: torch.Tensor        # [B] bool no valid observations
    converged: torch.Tensor     # [B] bool a convergence test fired


class OptResult(NamedTuple):
    latent: torch.Tensor
    T_ow: torch.Tensor
    iter_count: torch.Tensor
    failed: torch.Tensor
    converged: torch.Tensor


def init_state(latent: torch.Tensor, T_ow: torch.Tensor, i0: int = 0) -> OptState:
    B = latent.shape[0]
    dev = latent.device
    return OptState(
        latent=latent,
        T_ow=T_ow,
        i=torch.full((B,), i0, dtype=torch.int32, device=dev),
        iter_count=torch.full((B,), i0, dtype=torch.int32, device=dev),
        done=torch.zeros(B, dtype=torch.bool, device=dev),
        failed=torch.zeros(B, dtype=torch.bool, device=dev),
        converged=torch.zeros(B, dtype=torch.bool, device=dev),
    )
