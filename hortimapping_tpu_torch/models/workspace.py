"""Checkpoint workspace: DeepSDF experiment directories into port weights.

Counterpart of `hortimapping_tpu/models/workspace.py` for the native `.npz`
format (folded weights stored [in, out], plus the spec and the latent
table). The torch `.pth` load with the weight-norm fold is still to port
(`ROADMAP.md`). Nothing here writes into the experiment directory.

Directory convention:
    <experiment_dir>/specs.json
    <experiment_dir>/native/<checkpoint>.npz
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from hortimapping_tpu_torch.device import resolve_device
from hortimapping_tpu_torch.models.decoder import DecoderSpec, Params

NATIVE_SUBDIR = "native"
SPECS_FILENAME = "specs.json"


def load_specs(experiment_directory: str) -> Dict:
    path = os.path.join(experiment_directory, SPECS_FILENAME)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"missing {SPECS_FILENAME} in {experiment_directory}")
    with open(path) as f:
        return json.load(f)


def params_from_jax(params_np: Mapping, device: str | torch.device = "cuda") -> Params:
    """Port weights from the JAX package's parameter dict.

    Accepts the nested form `{"lin{l}": {"w": [in, out], "b": [out]}}` (numpy
    or anything `np.asarray` takes) or the flat `.npz` form `{"lin{l}.w": ...,
    "lin{l}.b": ...}`. Both packages keep weights [in, out], so this is a
    copy into f32 tensors on `device`."""
    dev = resolve_device(device)
    out: Params = {}
    l = 0
    while True:
        name = f"lin{l}"
        if name in params_np:
            w, b = params_np[name]["w"], params_np[name]["b"]
        elif f"{name}.w" in params_np:
            w, b = params_np[f"{name}.w"], params_np[f"{name}.b"]
        else:
            break
        out[name] = {
            "w": torch.as_tensor(np.asarray(w, np.float32)).to(dev),
            "b": torch.as_tensor(np.asarray(b, np.float32)).to(dev),
        }
        l += 1
    if not out:
        raise KeyError("no decoder layers found in the parameter dict")
    return out


def load_native_checkpoint(path: str, device: str | torch.device = "cuda") -> Tuple[Params, DecoderSpec]:
    with np.load(path) as z:
        spec = DecoderSpec(
            code_length=int(z["spec.code_length"]),
            dims=tuple(int(d) for d in z["spec.dims"]),
            latent_in=tuple(int(i) for i in z["spec.latent_in"]),
            clamping_distance=float(z["spec.clamping_distance"]),
        )
        params = params_from_jax({k: z[k] for k in z.files if k.startswith("lin")}, device)
    return params, spec


def config_decoder(
    experiment_directory: str, checkpoint: str = "latest", device: str | torch.device = "cuda"
) -> Tuple[Params, DecoderSpec]:
    """Load a decoder from an experiment directory's native checkpoint."""
    load_specs(experiment_directory)  # the directory must be an experiment dir
    npz_path = os.path.join(experiment_directory, NATIVE_SUBDIR, checkpoint + ".npz")
    if not os.path.isfile(npz_path):
        raise FileNotFoundError(
            f"no native checkpoint '{checkpoint}' in {experiment_directory} "
            "(the torch .pth load is not ported yet)"
        )
    return load_native_checkpoint(npz_path, device)


def load_latent_vectors(
    experiment_directory: str, checkpoint: str = "latest", device: str | torch.device = "cuda"
) -> torch.Tensor:
    """The trained latent-code table as an (N, C) f32 tensor."""
    dev = resolve_device(device)
    npz_path = os.path.join(experiment_directory, NATIVE_SUBDIR, checkpoint + ".npz")
    if os.path.isfile(npz_path):
        with np.load(npz_path) as z:
            if "latent_codes" in z:
                return torch.as_tensor(np.asarray(z["latent_codes"], np.float32)).to(dev)
    raise FileNotFoundError(
        f"no latent codes for checkpoint '{checkpoint}' in {experiment_directory}"
    )
