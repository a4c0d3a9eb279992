"""Huber robust kernel (counterpart of `hortimapping_tpu/ops/robust.py`)."""

from __future__ import annotations

from typing import Tuple

import torch


def huber_weights(res_norm: torch.Tensor, b: float) -> torch.Tensor:
    """w(|r|) = sqrt(rho(|r|))/|r|, w = 1 inside the window. Keeps the
    reference's w(0) = 0 (the division is guarded while rho(0) = 0)."""
    x = torch.abs(res_norm)
    rho = torch.where(x <= b, x * x, 2.0 * b * x - b * b)
    x_safe = torch.where(x == 0.0, torch.ones_like(x), x)
    return torch.sqrt(torch.clamp(rho, min=0.0)) / x_safe


def robust_residuals(res: torch.Tensor, b: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w * r, w^2); w^2 reweights J^T J and J^T r in the normal equations."""
    w = huber_weights(res, b)
    return w * res, w * w
