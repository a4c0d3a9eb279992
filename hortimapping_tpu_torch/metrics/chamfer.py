"""Chamfer-L1 distance (counterpart of `hortimapping_tpu/metrics/chamfer.py`).

Nearest-neighbour distances have two engines, picked by the pair count as
in the JAX package:
* `nn_distances`: tiled brute force in PyTorch on whatever device the points
  are on. The |a|^2 + |b|^2 - 2 a.b expansion is used only to pick each
  neighbour, after recentring both clouds on b's centroid; the distance
  itself is then recomputed as ||a_i - b_j*||, which cannot cancel (the fix
  that keeps world-frame fruits at ~0.6 m from reading sub-mm noise).
* `nn_distances_kdtree`: scipy's cKDTree on the host, all cores; the
  reference metric's 1 M-point mesh comparison is ~10^12 pairs.
`nn_distances_np` takes host arrays and picks the engine;
`ChamferDistance.update/compute/reset` keep the reference's aggregate:
per instance (mean(d_gt->pt) + mean(d_pt->gt)) / 2, an empty prediction
scores 0, `compute` is the mean over instances.
"""

from __future__ import annotations

import numpy as np
import torch

from hortimapping_tpu_torch.device import resolve_device
from hortimapping_tpu_torch.metrics.metric import Metrics3D

TILE = 4096
TILE_ELEMS = 1 << 26        # a tile's distance matrix stays under 256 MB of f32
# above this many pairs the host KD-tree takes over from the brute force:
# on the CPU at the JAX package's CPU crossover (so both packages pick the
# same engine there); on the card at the crossover measured on an H100
# against 8 host cores (the brute force wins at 1e9 pairs, the tree at 1e10;
# PERF.md)
BRUTE_FORCE_MAX_PAIRS = {"cpu": int(1e8), "cuda": int(3e9)}


def nn_distances(a: torch.Tensor, b: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """min_j ||a_i - b_j|| for every row of a (f32, on a's device)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    c = b.mean(0)
    a = a - c
    b = b - c
    b_sq = (b * b).sum(1)
    tile = max(1, min(tile, TILE_ELEMS // max(b.shape[0], 1)))
    out = []
    for lo in range(0, a.shape[0], tile):
        at = a[lo:lo + tile]
        d2 = (at * at).sum(1)[:, None] + b_sq[None, :] - 2.0 * (at @ b.T)
        j = torch.argmin(d2, dim=1)
        diff = at - b[j]
        out.append((diff * diff).sum(1))
    return torch.sqrt(torch.cat(out)) if out else a.new_zeros(0)


def nn_distances_kdtree(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact NN distances via scipy's cKDTree (all host cores)."""
    from scipy.spatial import cKDTree

    tree = cKDTree(np.asarray(b, np.float64))
    d, _ = tree.query(np.asarray(a, np.float64), k=1, workers=-1)
    return np.asarray(d, np.float32)


def nn_distances_np(a: np.ndarray, b: np.ndarray, device: torch.device) -> np.ndarray:
    """For each point of host array `a`, the distance to the nearest point
    of `b` (f32): brute force on `device` up to `BRUTE_FORCE_MAX_PAIRS` of
    its type, the host KD-tree above."""
    if a.shape[0] * b.shape[0] <= BRUTE_FORCE_MAX_PAIRS[device.type]:
        ta = torch.as_tensor(np.asarray(a, np.float32)).to(device)
        tb = torch.as_tensor(np.asarray(b, np.float32)).to(device)
        return nn_distances(ta, tb).cpu().numpy()
    return nn_distances_kdtree(a, b)


def chamfer_distance(gt: torch.Tensor, pred: torch.Tensor) -> float:
    """Symmetric mean NN distance (mean(d_gt->pred) + mean(d_pred->gt)) / 2;
    an empty prediction scores 0, as in the reference metric."""
    if pred.shape[0] == 0:
        return 0.0
    d_pt_2_gt = nn_distances(pred, gt)
    d_gt_2_pt = nn_distances(gt, pred)
    return float((d_gt_2_pt.mean() + d_pt_2_gt.mean()) / 2)


class ChamferDistance(Metrics3D):
    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cd_array = []

    def update(self, gt, pt) -> None:
        if self.prediction_is_empty(pt):
            self.cd_array.append(0)
            return
        gt_pts = self.convert_to_points(gt)
        pt_pts = self.convert_to_points(pt)
        d_pt_2_gt = nn_distances_np(pt_pts, gt_pts, self.device)
        d_gt_2_pt = nn_distances_np(gt_pts, pt_pts, self.device)
        self.cd_array.append((np.mean(d_gt_2_pt) + np.mean(d_pt_2_gt)) / 2)

    def reset(self) -> None:
        self.cd_array = []

    def compute(self) -> float:
        return sum(self.cd_array) / len(self.cd_array)
