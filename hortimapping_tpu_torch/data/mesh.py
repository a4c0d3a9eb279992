"""Host point-cloud and triangle-mesh containers (counterpart of
`hortimapping_tpu/data/mesh.py`): plain numpy arrays with the operations the
pipelines need (uniform area sampling, AABB, crop, transform, voxel
downsample). `TriangleMesh.sample_points_uniformly` draws from numpy exactly
as the JAX package does; `sample_points_on_device` draws on a torch device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class PointCloud:
    points: np.ndarray                       # (N, 3) float
    colors: Optional[np.ndarray] = None      # (N, 3) float in [0, 1]

    def __len__(self) -> int:
        return self.points.shape[0]

    def select(self, idx) -> "PointCloud":
        return PointCloud(self.points[idx], self.colors[idx] if self.colors is not None else None)

    def aabb(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.points.min(0), self.points.max(0)

    def crop(self, box_min, box_max) -> "PointCloud":
        m = np.all((self.points >= np.asarray(box_min)) & (self.points <= np.asarray(box_max)),
                   axis=1)
        return self.select(m)

    def transform(self, T: np.ndarray) -> "PointCloud":
        return PointCloud(self.points @ T[:3, :3].T + T[:3, 3], self.colors)

    def voxel_down_sample(self, voxel_size: float) -> "PointCloud":
        """The mean point (and colour) of each occupied voxel, voxels in
        lexicographic order of their integer keys (Open3D
        `voxel_down_sample` semantics)."""
        keys = np.floor(self.points / voxel_size).astype(np.int64)
        _, inv, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
        inv = inv.reshape(-1)

        def mean(x):
            acc = np.zeros((counts.shape[0], 3), np.float64)
            np.add.at(acc, inv, x)
            return (acc / counts[:, None]).astype(x.dtype)

        return PointCloud(mean(self.points),
                          mean(self.colors) if self.colors is not None else None)

    def __add__(self, other: "PointCloud") -> "PointCloud":
        colors = None
        if self.colors is not None and other.colors is not None:
            colors = np.concatenate([self.colors, other.colors], 0)
        return PointCloud(np.concatenate([self.points, other.points], 0), colors)


@dataclasses.dataclass
class TriangleMesh:
    vertices: np.ndarray                     # (V, 3) float
    faces: np.ndarray                        # (F, 3) int
    vertex_colors: Optional[np.ndarray] = None

    def paint_uniform_color(self, color) -> "TriangleMesh":
        c = np.tile(np.asarray(color, np.float64)[None, :], (self.vertices.shape[0], 1))
        return TriangleMesh(self.vertices, self.faces, c)

    def transform(self, T: np.ndarray) -> "TriangleMesh":
        v = self.vertices @ T[:3, :3].T + T[:3, 3]
        return TriangleMesh(v, self.faces, self.vertex_colors)

    def triangle_areas(self) -> np.ndarray:
        v = self.vertices
        a, b, c = v[self.faces[:, 0]], v[self.faces[:, 1]], v[self.faces[:, 2]]
        return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)

    def surface_area(self) -> float:
        return float(self.triangle_areas().sum())

    def vertex_normals(self) -> np.ndarray:
        """Unit area-weighted vertex normals (0 where a vertex has none)."""
        v, f = self.vertices, self.faces
        fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
        vn = np.zeros_like(v)
        for k in range(3):
            np.add.at(vn, f[:, k], fn)
        norm = np.linalg.norm(vn, axis=1, keepdims=True)
        return vn / np.where(norm == 0, 1.0, norm)

    def sample_points_uniformly(self, n: int, seed: int = 0) -> PointCloud:
        """Area-weighted uniform surface samples drawn from numpy's
        `default_rng(seed)`, with vertex colours interpolated (Open3D
        `sample_points_uniformly` semantics; the JAX package's draws, bit for
        bit)."""
        areas = self.triangle_areas()
        total = areas.sum()
        if total <= 0 or self.faces.shape[0] == 0:
            return PointCloud(np.zeros((0, 3), self.vertices.dtype))
        rng = np.random.default_rng(seed)
        tri = rng.choice(self.faces.shape[0], size=n, p=areas / total)
        u = rng.random(n)
        v_ = rng.random(n)
        flip = u + v_ > 1.0
        u[flip], v_[flip] = 1.0 - u[flip], 1.0 - v_[flip]
        f = self.faces[tri]
        a, b, c = self.vertices[f[:, 0]], self.vertices[f[:, 1]], self.vertices[f[:, 2]]
        pts = a + u[:, None] * (b - a) + v_[:, None] * (c - a)
        colors = None
        if self.vertex_colors is not None:
            ca, cb, cc = (self.vertex_colors[f[:, 0]], self.vertex_colors[f[:, 1]],
                          self.vertex_colors[f[:, 2]])
            colors = ca + u[:, None] * (cb - ca) + v_[:, None] * (cc - ca)
        return PointCloud(pts.astype(np.float32), colors)

    def sample_points_on_device(self, n: int, generator: torch.Generator,
                                device: str | torch.device = "cpu") -> torch.Tensor:
        """Area-weighted uniform surface samples, (n, 3) f32 on `device`
        (Open3D `sample_points_uniformly` semantics), drawn on the device
        from `generator` (which must live on that device)."""
        if self.faces.shape[0] == 0:
            return torch.zeros(0, 3, dtype=torch.float32, device=device)
        v = torch.as_tensor(np.asarray(self.vertices, np.float32)).to(device)
        f = torch.as_tensor(np.asarray(self.faces, np.int64)).to(device)
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
