"""Mesh extraction: batched SDF grid decode on the device + host iso-surfacing
(counterpart of `hortimapping_tpu/ops/mesher.py`).

The grid decode has two routes, as the JAX package's `use_pallas`:
* the kernel route (`use_kernel`, the default on the card for a
  kernel-supported decoder): the shared-latent kernel B4, one launch for all
  codes of a chunk, each block building its [code | xyz] rows on chip, in
  bf16 (the JAX kernel route's storage type) or f32;
* the plain route (`use_kernel=False`, and the default on the CPU): a plain
  f32 decoder forward, as the JAX package's default XLA route.
Both decode `decode_chunk` fruits at a time (a 6 GiB activation budget of
the plain route) and ship the grid to the host as f16: iso-surfacing needs
only the zero crossing. For serving, `pack_solve_with_grids` puts a batch's
packed solve result and its f16 grids into one device buffer, so both cross
to the host in one copy.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from hortimapping_tpu_torch import native
from hortimapping_tpu_torch.data.mesh import TriangleMesh
from hortimapping_tpu_torch.device import resolve_device
from hortimapping_tpu_torch.models.decoder import DecoderSpec, Params, decoder_apply
from hortimapping_tpu_torch.ops import mlp_kernels
from hortimapping_tpu_torch.utils import trace

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
    cube-radius scaled). `method`: "mt" (marching tetrahedra) or "mc"
    (marching cubes, the reference's cell structure)."""

    def __init__(self, params: Params, spec: DecoderSpec, voxels_dim: int = 64,
                 cube_radius: float = 1.0, use_kernel: Optional[bool] = None,
                 bf16: bool = True, method: str = "mt",
                 device: str | torch.device = "cuda"):
        if method not in ("mt", "mc"):
            raise ValueError(f"unknown iso-surface method {method!r}")
        self.device = resolve_device(device)
        self.params = params
        self.spec = spec
        self.voxels_dim = voxels_dim
        self.cube_radius = cube_radius
        self.method = method
        self.voxel_points = torch.as_tensor(create_voxel_grid(voxels_dim)).to(self.device) * cube_radius
        if use_kernel is None:
            use_kernel = self.device.type == "cuda"
        self.packed = None
        if use_kernel and mlp_kernels.supported(spec):
            self.packed = mlp_kernels.pack_params(params, spec,
                                                  torch.bfloat16 if bf16 else torch.float32)
        width = max(spec.dims) if spec.dims else 512
        self.decode_chunk = max(1, ACTIVATION_BUDGET // (voxels_dim**3 * width * 4))

    def _decode(self, lat: torch.Tensor) -> torch.Tensor:
        """[b, C] -> [b, D^3] f32 SDF on the device."""
        if self.packed is not None:
            return mlp_kernels.mlp_sdf_shared_latent(self.packed, lat, self.voxel_points)
        b, C = lat.shape
        n = self.voxel_points.shape[0]
        inp = torch.cat([lat[:, None, :].expand(b, n, C), self.voxel_points.expand(b, n, 3)], dim=-1)
        return decoder_apply(self.params, self.spec, inp)[..., 0]

    def decode_grids(self, latents: torch.Tensor) -> torch.Tensor:
        """[B, C] codes -> [B, D^3] f16 SDF grids on the device, decoded
        `decode_chunk` fruits at a time (span `mesh.decode` while tracing is
        on: its enqueue, with the codes, the grid's points and the chunks)."""
        latents = latents.to(self.device)
        n = latents.shape[0]
        with trace.span("mesh.decode", codes=n, points=self.voxel_points.shape[0],
                        chunks=-(-n // self.decode_chunk)):
            return torch.cat([self._decode(latents[lo:lo + self.decode_chunk]).to(torch.float16)
                              for lo in range(0, n, self.decode_chunk)])

    def decode_sdf_grid(self, latent: torch.Tensor) -> np.ndarray:
        """(D, D, D) SDF values of one code, on the host."""
        d = self.voxels_dim
        return self.decode_grids(latent.reshape(1, -1))[0].cpu().numpy().reshape(d, d, d)

    def extract_mesh_from_code(self, latent: torch.Tensor) -> TriangleMesh:
        return self.extract_batch(latent.reshape(1, -1))[0]

    def decode_grids_async(self, latents: torch.Tensor) -> torch.Tensor:
        """`decode_grids` under the JAX package's name for the serving path,
        kept only for that name: on the card every decode is only queued,
        and nothing waits for it until its grids are read."""
        return self.decode_grids(latents)

    def pack_solve_with_grids(self, res) -> torch.Tensor:
        """[B, 2 * (C + 19) + D^3] int16 device buffer: the bits of the
        solver's packed result (`optim/lm.pack_result`, f32, bit exact) and
        then of the f16 SDF grids of its codes, so that a served batch's
        solve and meshing results cross to the host in one copy. Read it
        back with `unpack_solve_with_grids`."""
        from hortimapping_tpu_torch.optim.lm import pack_result

        head = pack_result(res).contiguous().view(torch.int16)
        grids = self.decode_grids_async(res.latent).view(torch.int16)
        return torch.cat([head, grids], dim=1)

    def unpack_solve_with_grids(self, host_u16: np.ndarray):
        """Inverse of `pack_solve_with_grids` on the buffer copied to the
        host (int16 or uint16: the same bits): (packed f32 [B, C + 19] as
        `pack_result` lays it out, f16 grids [B, D, D, D])."""
        n_head = 2 * (self.spec.code_length + 19)
        d = self.voxels_dim
        head = np.ascontiguousarray(host_u16[:, :n_head]).view(np.float32)
        grids = np.ascontiguousarray(host_u16[:, n_head:]).view(np.float16)
        return head, grids.reshape(-1, d, d, d)

    def meshes_from_grids(self, grids: torch.Tensor) -> List[TriangleMesh]:
        """Host iso-surfacing of grids from `decode_grids`: the whole batch
        in one native call on min(fruits, the process's CPUs) threads, the
        f16 grids widened there (span `mesh.host` while tracing is on, with
        the threads that meshed; inside it span `mesh.readback`, the grids'
        copy to the host). The meshes are `_grid_to_mesh`'s, bit for bit."""
        d = self.voxels_dim
        n = grids.shape[0]
        with trace.span("mesh.host", fruits=n) as sp:
            with trace.span("mesh.readback"):
                host = grids.detach().cpu().numpy().reshape(-1, d, d, d)
            pairs, threads = native.iso_surface_batch(
                host, 0.0, 2.0 / (d - 1), 1.0, self.cube_radius, self.method,
                min(n, len(os.sched_getaffinity(0))))
            sp.set(threads=threads)
        return [TriangleMesh(v, f) for v, f in pairs]

    def extract_batch(self, latents: torch.Tensor) -> List[TriangleMesh]:
        return self.meshes_from_grids(self.decode_grids(latents))

    def complete_mesh(self, latent: torch.Tensor, transform: np.ndarray,
                      color: Optional[Sequence[float]] = None) -> TriangleMesh:
        """Extract, color, pose: verts in the frame `transform` maps the
        object frame to."""
        mesh = self.extract_mesh_from_code(latent)
        if color is not None:
            mesh = mesh.paint_uniform_color(color)
        return mesh.transform(np.asarray(transform))

    def complete_mesh_batch(self, latents: torch.Tensor, transforms: Sequence[np.ndarray],
                            colors: Optional[Sequence[Sequence[float]]] = None) -> List[TriangleMesh]:
        out = []
        for i, mesh in enumerate(self.extract_batch(latents)):
            if colors is not None:
                mesh = mesh.paint_uniform_color(colors[i])
            out.append(mesh.transform(np.asarray(transforms[i])))
        return out

    def _grid_to_mesh(self, grid: np.ndarray) -> TriangleMesh:
        """One (D, D, D) host grid's mesh, scaled in numpy: the tests'
        oracle for `meshes_from_grids`."""
        voxel_size = 2.0 / (self.voxels_dim - 1)
        iso_surface = native.marching_cubes if self.method == "mc" else native.marching_tetrahedra
        verts, faces = iso_surface(grid, iso=0.0, spacing=voxel_size)
        verts = (verts - 1.0) * self.cube_radius
        return TriangleMesh(verts.astype(np.float32), faces.astype(np.int32))
