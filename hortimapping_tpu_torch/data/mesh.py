"""Host triangle mesh container (counterpart of `TriangleMesh` in
`hortimapping_tpu/data/mesh.py`)."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


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

    def sample_points_uniformly(self, n: int, generator: torch.Generator,
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
