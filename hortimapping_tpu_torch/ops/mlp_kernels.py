"""Decoder forward + input gradient: the CUDA kernel, its plain version and
the weight packing both share.

Counterpart of `hortimapping_tpu/ops/pallas_mlp.py` (`supported`,
`pack_params`, `mlp_sdf_and_input_grad`). The kernel is
`csrc/mlp_fwd_grad.cu` over the chain in `csrc/decoder_chain.cuh`. A CUDA
tensor goes to the kernel and nowhere else; only a CPU tensor takes the
plain version, `mlp_sdf_and_input_grad_plain`, which writes out the same
forward and reverse chain (not autograd) with the same roundings.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from hortimapping_tpu_torch.models.decoder import DecoderSpec, Params
from hortimapping_tpu_torch.ops import cuda_build

MAX_WIDTH = 512      # widest hidden layer the kernels take (decoder_chain.cuh kMaxWidth)
PLAIN_ROWS = 1 << 16  # rows per pass of the plain chain (bounds its activations)

# weight tensors of a PackedDecoder, in the order the C entries take them
WEIGHT_NAMES = ("w0", "w0t", "w0tk", "wm", "wmt", "wl", "b0", "bm")

# launches of the CUDA kernel since the count was last set to 0
launches = 0


def supported(spec: DecoderSpec) -> bool:
    """Architectures the kernels take: uniform hidden width, a multiple of
    128 up to 512, and at most one latent_in layer."""
    return (
        len(set(spec.dims)) == 1
        and len(spec.latent_in) <= 1
        and spec.dims[0] % 128 == 0
        and 128 <= spec.dims[0] <= MAX_WIDTH
        and spec.in_dim <= 128
        and (not spec.latent_in or 1 <= spec.latent_in[0] <= spec.num_linear - 1)
    )


class PackedDecoder(NamedTuple):
    """Weights laid out for the kernels. Matmul weights are in the storage
    dtype (bf16 or f32); biases stay f32. The output columns of the layer
    feeding `latent_in` are zero-padded to the full width D, so the skip's
    concat becomes a write into them."""

    w0: torch.Tensor    # [in_dim, D]
    w0t: torch.Tensor   # [D, in_dim rounded up to 4], zero-padded (f32 backward)
    w0tk: torch.Tensor  # [D, in_dim rounded up to 16], zero-padded (tensor-core forward)
    wm: torch.Tensor    # [n_mid, D, D] ([in, out])
    wmt: torch.Tensor   # [n_mid, D, D] ([out, in])
    wl: torch.Tensor    # [D]
    b0: torch.Tensor    # [D]
    bm: torch.Tensor    # [n_mid, D]
    bl: float
    D: int
    n_mid: int
    li: int             # latent_in layer, 0 = none
    in_dim: int

    @property
    def bf16(self) -> bool:
        return self.w0.dtype == torch.bfloat16

    def weight_ptrs(self) -> Tuple[int, ...]:
        """Device pointers of the weight tensors, in the C entries' order."""
        return tuple(getattr(self, n).data_ptr() for n in WEIGHT_NAMES)


def pack_params(params: Params, spec: DecoderSpec, dtype: torch.dtype = torch.float32) -> PackedDecoder:
    if not supported(spec):
        raise ValueError(f"architecture not kernel-supported: {spec}")
    D, n_lin, in_dim = spec.dims[0], spec.num_linear, spec.in_dim
    dev = params["lin0"]["w"].device
    f32 = torch.float32

    def pad_w(w, rows):
        out = torch.zeros(rows, D, dtype=f32, device=dev)
        out[: w.shape[0], : w.shape[1]] = w
        return out

    def pad_b(b):
        out = torch.zeros(D, dtype=f32, device=dev)
        out[: b.shape[0]] = b
        return out

    w0 = pad_w(params["lin0"]["w"], in_dim).to(dtype)
    mids = range(1, n_lin - 1)
    wm = (torch.stack([pad_w(params[f"lin{l}"]["w"], D) for l in mids]) if len(mids)
          else torch.zeros(0, D, D, dtype=f32, device=dev)).to(dtype)
    bm = (torch.stack([pad_b(params[f"lin{l}"]["b"]) for l in mids]) if len(mids)
          else torch.zeros(0, D, dtype=f32, device=dev))
    head = params[f"lin{n_lin - 1}"]
    w0tk = torch.zeros(D, -(-in_dim // 16) * 16, dtype=dtype, device=dev)
    w0tk[:, :in_dim] = w0.t()
    w0t = torch.zeros(D, -(-in_dim // 4) * 4, dtype=dtype, device=dev)
    w0t[:, :in_dim] = w0.t()
    return PackedDecoder(
        w0=w0.contiguous(),
        w0t=w0t,
        w0tk=w0tk,
        wm=wm.contiguous(),
        wmt=wm.transpose(1, 2).contiguous(),
        wl=head["w"][:, 0].to(dtype).contiguous(),
        b0=pad_b(params["lin0"]["b"]),
        bm=bm.contiguous(),
        bl=float(head["b"][0]),
        D=D,
        n_mid=n_lin - 2,
        li=spec.latent_in[0] if spec.latent_in else 0,
        in_dim=in_dim,
    )


def _round(v: torch.Tensor, bf16: bool) -> torch.Tensor:
    return v.to(torch.bfloat16).float() if bf16 else v


def _chain_plain(pk: PackedDecoder, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward and input-gradient chain on rows x [N, in_dim] in plain
    PyTorch: the kernel's arithmetic in matmul form (bf16 storage = operands
    rounded to bf16, products accumulated in f32)."""
    bf16, D, li, k = pk.bf16, pk.D, pk.li, pk.in_dim
    w = lambda t: t.float()
    xr = _round(x, bf16)

    def skip(h):
        return torch.cat([h[:, : D - k], xr], dim=1)

    h = torch.relu(xr @ w(pk.w0) + pk.b0)
    masks = [h > 0]
    h = _round(h, bf16)
    for j in range(pk.n_mid):
        if j + 1 == li:
            h = skip(h)
        h = torch.relu(h @ w(pk.wm[j]) + pk.bm[j])
        masks.append(h > 0)
        h = _round(h, bf16)
    if pk.n_mid + 1 == li:
        h = skip(h)
    y = torch.tanh(h @ w(pk.wl) + pk.bl)

    g = _round(1.0 - y * y, bf16)[:, None] * w(pk.wl)[None, :]
    gx = torch.zeros_like(x)
    if pk.n_mid + 1 == li:
        gx = gx + _round(g[:, D - k:], bf16)
    for j in range(pk.n_mid - 1, -1, -1):
        g = _round(g * masks[j + 1], bf16) @ w(pk.wmt[j])
        if j + 1 == li:
            gx = gx + _round(g[:, D - k:], bf16)
    g = _round(g * masks[0], bf16)
    return y, gx + g @ w(pk.w0t[:, :k])


def chain_plain(pk: PackedDecoder, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_chain_plain` in passes of PLAIN_ROWS rows. x [N, in_dim] f32 ->
    (sdf [N], grad [N, in_dim])."""
    if x.shape[0] <= PLAIN_ROWS:
        return _chain_plain(pk, x)
    outs = [_chain_plain(pk, x[i:i + PLAIN_ROWS]) for i in range(0, x.shape[0], PLAIN_ROWS)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _check_packed(pk: PackedDecoder, x: torch.Tensor) -> None:
    for name in WEIGHT_NAMES:
        t = getattr(pk, name)
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"packed weight {name} must be contiguous on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"inputs must be float32, got {x.dtype}")


_argtypes_set = False


def _lib() -> ctypes.CDLL:
    global _argtypes_set
    lib = cuda_build.load("mlp_fwd_grad")
    if not _argtypes_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.horti_mlp_fwd_grad.restype = i
        lib.horti_mlp_fwd_grad.argtypes = [
            p, i, i, i, i, i, i,          # x, n_rows, in_dim, D, n_mid, li, bf16
            p, p, p, p, p, p, p, p,       # w0, w0t, w0tk, wm, wmt, wl, b0, bm
            ctypes.c_float, p, p, p,      # bl, sdf, grad, stream
        ]
        _argtypes_set = True
    return lib


def _fwd_grad_cuda(pk: PackedDecoder, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    global launches
    _check_packed(pk, x)
    n = x.shape[0]
    sdf = torch.empty(n, dtype=torch.float32, device=x.device)
    grad = torch.empty(n, pk.in_dim, dtype=torch.float32, device=x.device)
    rc = _lib().horti_mlp_fwd_grad(
        x.data_ptr(), n, pk.in_dim, pk.D, pk.n_mid, pk.li, int(pk.bf16),
        *pk.weight_ptrs(), pk.bl, sdf.data_ptr(), grad.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_build.check(rc, "horti_mlp_fwd_grad")
    launches += 1
    return sdf, grad


def _flatten(pk: PackedDecoder, inputs: torch.Tensor):
    if inputs.shape[-1] != pk.in_dim:
        raise ValueError(f"inputs last dim {inputs.shape[-1]} != {pk.in_dim}")
    lead = inputs.shape[:-1]
    return inputs.reshape(-1, pk.in_dim).float().contiguous(), lead


def mlp_sdf_and_input_grad(pk: PackedDecoder, inputs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., C+3) -> (sdf (...), d sdf / d input (..., C+3)). CUDA tensors go
    to the kernel; CPU tensors to the plain version."""
    x, lead = _flatten(pk, inputs)
    sdf, grad = _fwd_grad_cuda(pk, x) if x.is_cuda else chain_plain(pk, x)
    return sdf.reshape(lead), grad.reshape(lead + (pk.in_dim,))


def mlp_sdf_and_input_grad_plain(pk: PackedDecoder, inputs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the same function, on any device (the
    CPU path, and the oracle the card compares the kernel with)."""
    x, lead = _flatten(pk, inputs)
    sdf, grad = chain_plain(pk, x)
    return sdf.reshape(lead), grad.reshape(lead + (pk.in_dim,))
