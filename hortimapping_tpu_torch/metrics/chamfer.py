"""Chamfer-L1 distance (counterpart of `hortimapping_tpu/metrics/chamfer.py`).

Nearest neighbours by tiled brute force in PyTorch on whatever device the
points are on. The |a|^2 + |b|^2 - 2 a.b expansion is used only to pick
each neighbour, after recentring both clouds on b's centroid; the distance
itself is then recomputed as ||a_i - b_j*||, which cannot cancel (the fix
that keeps world-frame fruits at ~0.6 m from reading sub-mm noise).
"""

from __future__ import annotations

import torch

TILE = 4096


def nn_distances(a: torch.Tensor, b: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """min_j ||a_i - b_j|| for every row of a (f32, on a's device)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    c = b.mean(0)
    a = a - c
    b = b - c
    b_sq = (b * b).sum(1)
    out = []
    for lo in range(0, a.shape[0], tile):
        at = a[lo:lo + tile]
        d2 = (at * at).sum(1)[:, None] + b_sq[None, :] - 2.0 * (at @ b.T)
        j = torch.argmin(d2, dim=1)
        diff = at - b[j]
        out.append((diff * diff).sum(1))
    return torch.sqrt(torch.cat(out)) if out else a.new_zeros(0)


def chamfer_distance(gt: torch.Tensor, pred: torch.Tensor) -> float:
    """Symmetric mean NN distance (mean(d_gt->pred) + mean(d_pred->gt)) / 2;
    an empty prediction scores 0, as in the reference metric."""
    if pred.shape[0] == 0:
        return 0.0
    d_pt_2_gt = nn_distances(pred, gt)
    d_gt_2_pt = nn_distances(gt, pred)
    return float((d_gt_2_pt.mean() + d_pt_2_gt.mean()) / 2)
