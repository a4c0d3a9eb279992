"""Mesh extraction: batched SDF grid decode on the device + host marching
tetrahedra (counterpart of `hortimapping_tpu/ops/mesher.py`).

The grid decode is a plain decoder forward in f32 (the JAX package leaves it
to XLA too), chunked over fruits to a 6 GiB activation budget, and shipped
to the host as f16: iso-surfacing needs only the zero crossing.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from hortimapping_tpu_torch import native
from hortimapping_tpu_torch.data.mesh import TriangleMesh
from hortimapping_tpu_torch.device import resolve_device
from hortimapping_tpu_torch.models.decoder import DecoderSpec, Params, decoder_apply

ACTIVATION_BUDGET = 6 * 1024**3


def create_voxel_grid(vol_dim: int) -> np.ndarray:
    """[-1, 1]^3 grid on the integer lattice, (D^3, 3); row i -> x = i // D^2,
    y = (i // D) % D, z = i % D."""
    idx = np.arange(vol_dim**3)
    voxel_size = 2.0 / (vol_dim - 1)
    x = (idx // (vol_dim * vol_dim)) % vol_dim
    y = (idx // vol_dim) % vol_dim
    z = idx % vol_dim
    pts = np.stack([x, y, z], axis=-1).astype(np.float32)
    return pts * voxel_size - 1.0


class MeshExtractor:
    """Decode latent codes to watertight meshes (verts in the object frame,
    cube-radius scaled)."""

    def __init__(self, params: Params, spec: DecoderSpec, voxels_dim: int = 64,
                 cube_radius: float = 1.0, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.params = params
        self.spec = spec
        self.voxels_dim = voxels_dim
        self.cube_radius = cube_radius
        self.voxel_points = torch.as_tensor(create_voxel_grid(voxels_dim)).to(self.device) * cube_radius
        width = max(spec.dims) if spec.dims else 512
        self.decode_chunk = max(1, ACTIVATION_BUDGET // (voxels_dim**3 * width * 4))

    def decode_grids(self, latents: torch.Tensor) -> torch.Tensor:
        """[B, C] codes -> [B, D^3] f16 SDF grids on the device, decoded
        `decode_chunk` fruits at a time."""
        latents = latents.to(self.device)
        out = []
        n = self.voxel_points.shape[0]
        for lo in range(0, latents.shape[0], self.decode_chunk):
            lat = latents[lo:lo + self.decode_chunk]
            b, C = lat.shape
            inp = torch.cat([lat[:, None, :].expand(b, n, C),
                             self.voxel_points.expand(b, n, 3)], dim=-1)
            out.append(decoder_apply(self.params, self.spec, inp)[..., 0].to(torch.float16))
        return torch.cat(out)

    def meshes_from_grids(self, grids: torch.Tensor) -> List[TriangleMesh]:
        d = self.voxels_dim
        host = grids.detach().cpu().numpy().reshape(-1, d, d, d)
        return [self._grid_to_mesh(g) for g in host]

    def extract_batch(self, latents: torch.Tensor) -> List[TriangleMesh]:
        return self.meshes_from_grids(self.decode_grids(latents))

    def _grid_to_mesh(self, grid: np.ndarray) -> TriangleMesh:
        voxel_size = 2.0 / (self.voxels_dim - 1)
        verts, faces = native.marching_tetrahedra(grid, iso=0.0, spacing=voxel_size)
        verts = (verts - 1.0) * self.cube_radius
        return TriangleMesh(verts.astype(np.float32), faces.astype(np.int32))
