"""Chamfer-L1 of a completed mesh against its GT surface: a frozen copy of
`hortimapping_tpu_torch/metrics/chamfer.py` (`nn_distances`,
`chamfer_distance`) and of the area-weighted surface sampler
`hortimapping_tpu_torch/data/mesh.py` (`TriangleMesh.sample_points_on_device`,
Open3D's `sample_points_uniformly` semantics), as `chip_smoke.mean_cd_mm`
uses them: 100k samples a mesh from a generator seeded 1 on the device."""

from __future__ import annotations

import numpy as np
import torch

TILE = 4096
TILE_ELEMS = 1 << 26
SAMPLES = 100_000


def nn_distances(a: torch.Tensor, b: torch.Tensor, tile: int = TILE) -> torch.Tensor:
    """min_j ||a_i - b_j|| for every row of a: the neighbour picked by the
    expanded square distance after recentring on b's centroid, the distance
    then recomputed exactly."""
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


def chamfer_distance(gt: torch.Tensor, pred: torch.Tensor) -> float:
    """(mean(d_gt->pred) + mean(d_pred->gt)) / 2; an empty prediction scores 0."""
    if pred.shape[0] == 0:
        return 0.0
    return float((nn_distances(gt, pred).mean() + nn_distances(pred, gt).mean()) / 2)


def sample_surface(vertices: np.ndarray, faces: np.ndarray, n: int, generator: torch.Generator,
                   device) -> torch.Tensor:
    """n area-weighted uniform samples of a triangle mesh, (n, 3) f32."""
    if faces.shape[0] == 0:
        return torch.zeros(0, 3, dtype=torch.float32, device=device)
    v = torch.as_tensor(np.asarray(vertices, np.float32)).to(device)
    f = torch.as_tensor(np.asarray(faces, np.int64)).to(device)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    areas = 0.5 * torch.linalg.norm(torch.linalg.cross(b - a, c - a, dim=-1), dim=-1)
    if float(areas.sum()) <= 0:
        return torch.zeros(0, 3, dtype=torch.float32, device=device)
    tri = torch.multinomial(areas, n, replacement=True, generator=generator)
    u = torch.rand(n, generator=generator, device=device)
    w = torch.rand(n, generator=generator, device=device)
    flip = u + w > 1.0
    u = torch.where(flip, 1.0 - u, u)
    w = torch.where(flip, 1.0 - w, w)
    A, B_, C_ = a[tri], b[tri], c[tri]
    return A + u[:, None] * (B_ - A) + w[:, None] * (C_ - A)


def mean_cd_mm(meshes, gts, device, samples: int = SAMPLES) -> float:
    """Mean Chamfer-L1 (mm) of world-frame meshes ((vertices, faces) pairs)
    against their GT surface points."""
    g = torch.Generator(device=device).manual_seed(1)
    return float(np.mean([chamfer_distance(torch.as_tensor(gt).to(device),
                                           sample_surface(v, f, samples, g, device))
                          for (v, f), gt in zip(meshes, gts)])) * 1e3
