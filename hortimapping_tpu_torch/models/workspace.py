"""Checkpoint workspace: DeepSDF experiment directories into port weights.

Counterpart of `hortimapping_tpu/models/workspace.py`. A torch DeepSDF
checkpoint (`ModelParameters/<ckpt>.pth`, weight norm folded at load time)
or the native `.npz` (folded weights stored [in, out], the spec and the
latent table) becomes `{"lin{l}": {"w", "b"}}` f32 tensors. The `.npz` keys
are the JAX package's, so each package loads what the other writes. The
JAX package's Orbax save/load is JAX-only and is not ported.

Directory convention (the reference's):
    <experiment_dir>/specs.json
    <experiment_dir>/ModelParameters/<checkpoint>.pth   (torch)
    <experiment_dir>/LatentCodes/<checkpoint>.pth       (torch)
    <experiment_dir>/native/<checkpoint>.npz            (preferred)
"""

from __future__ import annotations

import json
import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from hortimapping_tpu_torch.device import resolve_device
from hortimapping_tpu_torch.models.decoder import DecoderSpec, Params

MODEL_PARAMS_SUBDIR = "ModelParameters"
LATENT_CODES_SUBDIR = "LatentCodes"
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
    copy into f32 tensors on `device` (never a view of the input, which
    training updates in place)."""
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
            "w": torch.tensor(np.asarray(w, np.float32), device=dev),
            "b": torch.tensor(np.asarray(b, np.float32), device=dev),
        }
        l += 1
    if not out:
        raise KeyError("no decoder layers found in the parameter dict")
    return out


def _strip_prefix(state_dict: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop a DataParallel 'module.' prefix if present."""
    if any(k.startswith("module.") for k in state_dict):
        return {k[len("module."):]: v for k, v in state_dict.items() if k.startswith("module.")}
    return dict(state_dict)


def _fold_weight_norm(v: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Fold torch weight norm: W = g * v / ||v||, norms over each output row
    (torch Linear weights are [out, in], weight_g [out, 1]). In numpy f32, as
    the JAX package folds, so both packages load the same weights."""
    norm = np.linalg.norm(v.reshape(v.shape[0], -1), axis=1, keepdims=True)
    return (g.reshape(-1, 1) / norm) * v


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy().astype(np.float32)
    return np.asarray(v, dtype=np.float32)


def convert_torch_checkpoint(pth_path: str, spec: DecoderSpec,
                             device: str | torch.device = "cuda") -> Params:
    """A torch DeepSDF `ModelParameters/*.pth` as folded port weights.

    Handles weight-normed (`lin{i}.weight_v` / `weight_g`), plain
    (`lin{i}.weight`) and parametrize-style
    (`lin{i}.parametrizations.weight.original0/1`) layers, each with or
    without a DataParallel `module.` prefix; weights are transposed to [in,
    out]."""
    dev = resolve_device(device)
    blob = torch.load(pth_path, map_location="cpu", weights_only=False)
    state = blob["model_state_dict"] if "model_state_dict" in blob else blob
    state = _strip_prefix({k: _to_numpy(v) for k, v in state.items()})

    params = {}
    for l in range(spec.num_linear):
        name = f"lin{l}"
        if f"{name}.weight_v" in state:
            w = _fold_weight_norm(state[f"{name}.weight_v"], state[f"{name}.weight_g"])
        elif f"{name}.weight" in state:
            w = state[f"{name}.weight"]
        elif f"{name}.parametrizations.weight.original1" in state:
            w = _fold_weight_norm(
                state[f"{name}.parametrizations.weight.original1"],
                state[f"{name}.parametrizations.weight.original0"],
            )
        else:
            raise KeyError(f"no weights found for layer {name} in {pth_path}")
        params[name] = {"w": w.T, "b": state[f"{name}.bias"]}
    return params_from_jax(params, dev)


def load_latent_vectors(
    experiment_directory: str, checkpoint: str = "latest", device: str | torch.device = "cuda"
) -> torch.Tensor:
    """The trained latent-code table as an (N, C) f32 tensor: from the native
    `.npz` if it holds one, else from `LatentCodes/<checkpoint>.pth` as a raw
    tensor or an `nn.Embedding` state dict."""
    dev = resolve_device(device)
    npz_path = os.path.join(experiment_directory, NATIVE_SUBDIR, checkpoint + ".npz")
    if os.path.isfile(npz_path):
        with np.load(npz_path) as z:
            if "latent_codes" in z:
                return torch.as_tensor(np.asarray(z["latent_codes"], np.float32)).to(dev)

    pth_path = os.path.join(experiment_directory, LATENT_CODES_SUBDIR, checkpoint + ".pth")
    if not os.path.isfile(pth_path):
        raise FileNotFoundError(
            f"no latent codes for checkpoint '{checkpoint}' in {experiment_directory}"
        )
    codes = torch.load(pth_path, map_location="cpu", weights_only=False)["latent_codes"]
    if isinstance(codes, dict):  # nn.Embedding state dict
        codes = codes["weight"]
    return torch.as_tensor(_to_numpy(codes)).to(dev)


def save_native_checkpoint(
    experiment_directory: str,
    checkpoint: str,
    params: Params,
    spec: DecoderSpec,
    latent_codes: Optional[np.ndarray | torch.Tensor] = None,
) -> str:
    """Write the native `.npz` checkpoint (folded weights + spec + codes)
    under the JAX package's keys."""
    out_dir = os.path.join(experiment_directory, NATIVE_SUBDIR)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, checkpoint + ".npz")
    arrays = {}
    for name, p in params.items():
        arrays[f"{name}.w"] = _to_numpy(p["w"])
        arrays[f"{name}.b"] = _to_numpy(p["b"])
    arrays["spec.code_length"] = np.int32(spec.code_length)
    arrays["spec.dims"] = np.asarray(spec.dims, np.int32)
    arrays["spec.latent_in"] = np.asarray(spec.latent_in, np.int32)
    arrays["spec.clamping_distance"] = np.float64(spec.clamping_distance)
    if latent_codes is not None:
        arrays["latent_codes"] = _to_numpy(latent_codes)
    np.savez(path, **arrays)
    return path


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
    """Load a decoder from an experiment directory.

    Prefers the native `.npz`; otherwise converts the torch checkpoint and
    caches the native form beside it for later runs (in a read-only
    directory the conversion stays in memory)."""
    dev = resolve_device(device)
    spec = DecoderSpec.from_specs_json(load_specs(experiment_directory))
    npz_path = os.path.join(experiment_directory, NATIVE_SUBDIR, checkpoint + ".npz")
    if os.path.isfile(npz_path):
        return load_native_checkpoint(npz_path, dev)

    pth_path = os.path.join(experiment_directory, MODEL_PARAMS_SUBDIR, checkpoint + ".pth")
    if not os.path.isfile(pth_path):
        raise FileNotFoundError(
            f"no checkpoint '{checkpoint}' (native or torch) in {experiment_directory}"
        )
    params = convert_torch_checkpoint(pth_path, spec, dev)
    try:
        save_native_checkpoint(experiment_directory, checkpoint, params, spec)
    except OSError:
        pass  # read-only experiment dir: the conversion stays in memory
    return params, spec
