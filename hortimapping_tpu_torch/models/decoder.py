"""DeepSDF decoder as plain functions over a weight dictionary.

Counterpart of `hortimapping_tpu/models/decoder.py`: an MLP over
concat(latent[C], xyz[3]) emitting tanh(SDF), with the input re-concatenated
at the `latent_in` layers. Weights are `{"lin{l}": {"w": [in, out], "b":
[out]}}` tensors (weight norm folded at load time), the layout the JAX
package stores, so `models/workspace.params_from_jax` is a plain copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch

from hortimapping_tpu_torch.device import resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class DecoderSpec:
    """Static architecture description (the `NetworkSpecs` of `specs.json`)."""

    code_length: int = 32
    dims: Tuple[int, ...] = (512,) * 8
    latent_in: Tuple[int, ...] = (4,)
    clamping_distance: float = 0.1

    @property
    def in_dim(self) -> int:
        return self.code_length + 3

    @property
    def num_linear(self) -> int:
        return len(self.dims) + 1

    def layer_dims(self) -> Sequence[Tuple[int, int]]:
        """(fan_in, fan_out) of every linear layer; a layer feeding a
        `latent_in` layer is `in_dim` narrower so the concat restores the
        nominal width."""
        full = (self.in_dim,) + tuple(self.dims) + (1,)
        out = []
        for l in range(self.num_linear):
            fan_out = full[l + 1]
            if (l + 1) in self.latent_in:
                fan_out = full[l + 1] - self.in_dim
            out.append((full[l], fan_out))
        return out

    @classmethod
    def from_specs_json(cls, specs: Dict[str, Any]) -> "DecoderSpec":
        ns = specs["NetworkSpecs"]
        return cls(
            code_length=int(specs["CodeLength"]),
            dims=tuple(int(d) for d in ns["dims"]),
            latent_in=tuple(int(i) for i in ns.get("latent_in", ())),
            clamping_distance=float(specs.get("ClampingDistance", 0.1)),
        )


def init_decoder_params(
    spec: DecoderSpec, generator: torch.Generator, device: str | torch.device = "cuda"
) -> Params:
    """He init, as the JAX package's: normal weights times sqrt(2 / fan_in),
    stored [in, out], zero biases, f32, drawn from `generator` (which lives
    on `device`) layer by layer."""
    dev = resolve_device(device)
    params: Params = {}
    for l, (fan_in, fan_out) in enumerate(spec.layer_dims()):
        w = torch.randn(fan_in, fan_out, generator=generator, device=dev)
        params[f"lin{l}"] = {"w": w * (2.0 / fan_in) ** 0.5,
                             "b": torch.zeros(fan_out, device=dev)}
    return params


def _matmul(x: torch.Tensor, w: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """x @ w with f32 output. bf16 means bf16 operands: on the card a native
    bf16 matmul (the JAX package leaves these to XLA as well), on the CPU the
    operands are rounded to bf16 and multiplied in f32, which is the same
    product with f32 accumulation."""
    if compute_dtype == torch.float32:
        return x @ w
    if x.is_cuda:
        return (x.to(compute_dtype) @ w.to(compute_dtype)).float()
    return x.to(compute_dtype).float() @ w.to(compute_dtype).float()


def decoder_apply(
    params: Params,
    spec: DecoderSpec,
    inputs: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """inputs (..., C+3) -> (..., 1) tanh(SDF)."""
    x = inputs
    last = spec.num_linear - 1
    for l in range(spec.num_linear):
        if l in spec.latent_in:
            x = torch.cat([x, inputs], dim=-1)
        p = params[f"lin{l}"]
        x = _matmul(x, p["w"], compute_dtype) + p["b"]
        if l < last:
            x = torch.relu(x)
    return torch.tanh(x)


def decoder_sdf(
    params: Params,
    spec: DecoderSpec,
    latent: torch.Tensor,
    xyz: torch.Tensor,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """latent (C,), xyz (..., 3) -> SDF (...)."""
    lat = latent.expand(xyz.shape[:-1] + latent.shape)
    inp = torch.cat([lat, xyz], dim=-1)
    return decoder_apply(params, spec, inp, compute_dtype)[..., 0]


def decoder_sdf_and_input_grad(
    params: Params, spec: DecoderSpec, inputs: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SDF and d sdf / d [code, xyz] for every row in one reverse sweep
    (each output depends on its own row only, so a ones cotangent gives the
    per-row gradients exactly). inputs (..., C+3) -> (sdf (...), grad
    (..., C+3))."""
    with torch.enable_grad():
        x = inputs.detach().requires_grad_(True)
        sdf = decoder_apply(params, spec, x)[..., 0]
        (grad,) = torch.autograd.grad(sdf.sum(), x)
    return sdf.detach(), grad


def decoder_sdf_grad_at(
    params: Params, spec: DecoderSpec, latent: torch.Tensor, xyz: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sdf, d sdf / d code, d sdf / d xyz) at points xyz under one code:
    latent (C,), xyz (..., 3) -> (...), (..., C), (..., 3)."""
    lat = latent.expand(xyz.shape[:-1] + latent.shape)
    sdf, g = decoder_sdf_and_input_grad(params, spec, torch.cat([lat, xyz], dim=-1))
    return sdf, g[..., : spec.code_length], g[..., spec.code_length:]


def count_params(params: Params) -> int:
    return sum(p["w"].numel() + p["b"].numel() for p in params.values())
