"""The system under test: the PyTorch/CUDA port, set up from a
configuration file. This is the only module of the benchmark, with the
traffic drivers and the recorder's wrappers, that touches the program."""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch


class Program:
    """Decoder, latent table, solver configuration and mesher of one
    configuration, on `dev`. The table is the benchmark's: the asset's codes
    and as many more as the configuration's table holds, drawn on the device
    from `table_seed` with the asset codes' own mean and spread in each
    dimension."""

    def __init__(self, root: str, config: dict, table_seed: int, dev: torch.device):
        from hortimapping_tpu_torch import native
        from hortimapping_tpu_torch.config import JointOptConfig
        from hortimapping_tpu_torch.models.workspace import config_decoder
        from hortimapping_tpu_torch.ops.mesher import MeshExtractor

        self.dev = dev
        if dev.type == "cuda":
            from hortimapping_tpu_torch.ops import cuda_build

            cuda_build.build_all()
        native.load()
        asset = os.path.join(root, config["decoder"]["asset"])
        self.params, self.spec = config_decoder(asset, device=dev)
        self.table = make_table(os.path.join(asset, "native", "latest.npz"),
                                config["latent_table"]["codes"], table_seed, dev)
        self.cfg = JointOptConfig(**config["solver"])
        m = config["meshing"]
        self.cube_radius = float(m["cube_radius_m"])
        self.mesher = MeshExtractor(self.params, self.spec, voxels_dim=m["voxels"],
                                    cube_radius=self.cube_radius, bf16=m["grid_bf16"], device=dev)

    def requests(self, pool, reqs) -> List:
        """The program's request objects for benchmark requests."""
        from hortimapping_tpu_torch.optim.state import FruitObservations
        from hortimapping_tpu_torch.serve import CompletionRequest

        lat0 = self.table.mean(0).cpu().numpy()
        return [CompletionRequest(r.key, FruitObservations(*pool[r.scene].obs), lat0, r.T_ow0)
                for r in reqs]

    def server(self, serving: dict):
        from hortimapping_tpu_torch.serve import CompletionServer

        return CompletionServer(self.params, self.spec, self.cfg, self.cube_radius,
                                max_batch=serving["max_batch"], max_wait_s=serving["max_wait_s"],
                                mesher=self.mesher, use_mesh=False, latent_table=self.table,
                                device=self.dev)

    def solve_batch(self, pool, reqs):
        """One greenhouse batch in memory: stacked and uploaded, solved by
        `warmstart_solve`, meshed by `complete_mesh_batch` in the world
        frame. Returns (result, meshes)."""
        from hortimapping_tpu_torch.optim import warmstart
        from hortimapping_tpu_torch.optim.state import FruitObservations, upload

        obs = FruitObservations(*(upload(np.stack([getattr(pool[r.scene].obs, f) for r in reqs]),
                                         self.dev) for f in FruitObservations._fields))
        T0 = upload(np.stack([r.T_ow0 for r in reqs]), self.dev)
        lat0 = self.table.mean(0, keepdim=True).expand(len(reqs), -1).contiguous()
        res = warmstart.warmstart_solve(self.params, self.spec, self.cfg, self.table, obs, lat0, T0,
                                        self.cube_radius, device=self.dev)
        T_wo = np.linalg.inv(res.T_ow.double().cpu().numpy())
        meshes = self.mesher.complete_mesh_batch(res.latent, T_wo)
        return res, meshes


def make_table(ckpt: str, n_codes: int, seed: int, dev: torch.device) -> torch.Tensor:
    with np.load(ckpt) as z:
        codes = torch.as_tensor(z["latent_codes"], dtype=torch.float32).to(dev)
    extra = n_codes - codes.shape[0]
    if extra <= 0:
        return codes[:n_codes].contiguous()
    g = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))
    draw = torch.randn(extra, codes.shape[1], generator=g, device=dev)
    return torch.cat([codes, codes.mean(0) + codes.std(0) * draw]).contiguous()
