"""SDF <-> occupancy conversions (counterpart of `hortimapping_tpu/ops/sdf.py`)."""

from __future__ import annotations

import torch

# ratio between a Gaussian fit's sigma and the logistic slope
LOGISTIC_GAUSSIAN_RATIO = 0.55


def sdf_to_occupancy(sdf: torch.Tensor, th: float = 0.01) -> torch.Tensor:
    """Linear ramp: occ = 0.5 - clamp(sdf, -th, th) / (2 th)."""
    return 0.5 - torch.clamp(sdf, -th, th) / (2.0 * th)


def sdf_to_occupancy_log(sdf: torch.Tensor, sigma: float = 0.01) -> torch.Tensor:
    """Logistic: occ = sigmoid(-sdf / sigma)."""
    return torch.sigmoid(-sdf / sigma)


def logistic_sigma(occ_cutoff: float) -> float:
    return occ_cutoff / 3.0 * LOGISTIC_GAUSSIAN_RATIO
