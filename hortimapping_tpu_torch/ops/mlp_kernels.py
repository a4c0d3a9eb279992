"""The decoder kernels: forward + input gradient (B1), forward alone (B3)
and forward of points sharing one code (B4), their plain versions and the
weight packing they share.

Counterpart of `hortimapping_tpu/ops/pallas_mlp.py` (`supported`,
`pack_params`, `mlp_sdf_and_input_grad`, `mlp_sdf`,
`mlp_sdf_shared_latent`, `PallasDecoder`). The kernels are
`csrc/mlp_fwd_grad.cu`, `csrc/mlp_fwd.cu` and `csrc/mlp_shared_latent.cu`,
all over the Hopper chain of `csrc/stream_chain.cuh`, which the render
kernels share; each reads the weight streams `pack_params` lays out. A CUDA
tensor goes to the kernel and nowhere else; only a CPU tensor takes the
plain version (`*_plain`), which writes out the same forward and reverse
chain (not autograd) with the same roundings.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, NamedTuple, Optional, Tuple

import torch

from hortimapping_tpu_torch.models.decoder import DecoderSpec, Params
from hortimapping_tpu_torch.ops import cuda_build
from hortimapping_tpu_torch.utils import trace

MAX_WIDTH = 512      # widest hidden layer the kernels take (stream_chain.cuh kMaxWidth)
PLAIN_ROWS = 1 << 16  # rows per pass of the plain chain (bounds its activations)
MAX_CHUNKS = 1 << 30  # 64-row chunks one shared-latent launch takes (int chunk indices)

CLUSTER = 2          # blocks of a cluster sharing each weight fetch (stream_chain.cuh kCluster)
STAGE_K_BF16 = 32    # k rows of a stage of the weight streams (stream_chain.cuh StreamCfg::kK)
STAGE_K_F32 = 8

# weight tensors of a PackedDecoder, in the order the C entries take them
STREAM_NAMES = ("fwd_stream", "bwd_stream", "wl", "b0", "bm")

# launches of each CUDA kernel since its count was last set to 0: B1
# (fwd+input grad), B3 (forward), B4 (shared-latent forward)
# (`utils/trace.count`)
launches = 0
launches_fwd = 0
launches_shared_latent = 0
_lock = threading.Lock()   # the C entries' argument types, bound once


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
    fwd_stream: torch.Tensor  # [*] forward weight stream (`stream_layers`), as k-stages
    bwd_stream: torch.Tensor  # [*] backward weight stream

    @property
    def bf16(self) -> bool:
        return self.w0.dtype == torch.bfloat16

    def stream_ptrs(self) -> Tuple[int, ...]:
        """Device pointers of the weight streams, head and biases."""
        return tuple(getattr(self, n).data_ptr() for n in STREAM_NAMES)


def stream_dims(in_dim: int, bf16: bool) -> Tuple[int, int]:
    """(K of layer 0 in the forward stream, N of layer 0 in the backward
    stream), zero-padded as stream_chain.cuh `stream_k0` / `stream_n0`."""
    kK = STAGE_K_BF16 if bf16 else STAGE_K_F32
    return -(-in_dim // kK) * kK, (128 if bf16 else -(-in_dim // 4) * 4)


def stream_layers(D: int, n_mid: int, in_dim: int, bf16: bool):
    """(K, N) of each matrix W (out = in @ W) of the forward and of the
    backward stream, in the order a chunk consumes them."""
    k0, n0 = stream_dims(in_dim, bf16)
    return [(k0, D)] + [(D, D)] * n_mid, [(D, D)] * n_mid + [(D, n0)]


def _stages(W: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """W [K, N] as the stages the kernel's ring receives, flat. f32: rows
    of W in order (a stage is STAGE_K_F32 rows). bf16 (wgmma's B operand, K-major, no
    swizzle): per 32-row stage, two k16 steps, each [N/8 groups][2 k-chunks]
    of 8 x 8 core matrices (8 n, 8 consecutive k each)."""
    W = W.to(dtype)
    if dtype != torch.bfloat16:
        return W.reshape(-1)
    K, N = W.shape
    return (W.t().reshape(N // 8, 8, K // 32, 2, 2, 8)
            .permute(2, 3, 0, 4, 1, 5).reshape(-1))


def _unstage(flat: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """The inverse of `_stages`: W [K, N]."""
    if flat.dtype != torch.bfloat16:
        return flat.reshape(K, N)
    return flat.reshape(K // 32, 2, N // 8, 2, 8, 8).permute(2, 4, 0, 1, 3, 5).reshape(N, K).t()


def unpack_streams(pk: "PackedDecoder"):
    """The matrices W [K, N] of the forward and of the backward stream,
    read back from the packed stages (the tests hold them against w0, wm
    and wmt)."""
    out = []
    for flat, layers in zip((pk.fwd_stream, pk.bwd_stream),
                            stream_layers(pk.D, pk.n_mid, pk.in_dim, pk.bf16)):
        mats, at = [], 0
        for K, N in layers:
            mats.append(_unstage(flat[at:at + K * N], K, N))
            at += K * N
        assert at == flat.numel()
        out.append(mats)
    return tuple(out)


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
    # the weight streams of the kernels (stream_layers): forward layer 0 with
    # its K padded, layers 1..n_mid as [in, out]; backward layers n_mid..1
    # as [out, in], layer 0 as [D, in] with its N padded
    k0, n0 = stream_dims(in_dim, dtype == torch.bfloat16)
    w0_k = torch.zeros(k0, D, dtype=dtype, device=dev)
    w0_k[:in_dim] = w0
    w0_n = torch.zeros(D, n0, dtype=dtype, device=dev)
    w0_n[:, :in_dim] = w0.t()
    fwd_stream = torch.cat([_stages(w0_k, dtype)] + [_stages(w, dtype) for w in wm])
    bwd_stream = torch.cat([_stages(wm[j].t(), dtype) for j in reversed(range(len(wm)))]
                           + [_stages(w0_n, dtype)])
    return PackedDecoder(
        w0=w0.contiguous(),
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
        fwd_stream=fwd_stream.contiguous(),
        bwd_stream=bwd_stream.contiguous(),
    )


def _round(v: torch.Tensor, bf16: bool) -> torch.Tensor:
    return v.to(torch.bfloat16).float() if bf16 else v


def _forward_plain(pk: PackedDecoder, x: torch.Tensor,
                   masks: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
    """Forward chain on rows x [N, in_dim] in plain PyTorch: the kernels'
    arithmetic in matmul form (bf16 storage = operands rounded to bf16,
    products accumulated in f32). Appends each layer's ReLU signs to
    `masks` if given. Returns the tanh sdf [N]."""
    bf16, D, li, k = pk.bf16, pk.D, pk.li, pk.in_dim
    w = lambda t: t.float()
    xr = _round(x, bf16)

    def skip(h):
        return torch.cat([h[:, : D - k], xr], dim=1)

    h = torch.relu(xr @ w(pk.w0) + pk.b0)
    if masks is not None:
        masks.append(h > 0)
    h = _round(h, bf16)
    for j in range(pk.n_mid):
        if j + 1 == li:
            h = skip(h)
        h = torch.relu(h @ w(pk.wm[j]) + pk.bm[j])
        if masks is not None:
            masks.append(h > 0)
        h = _round(h, bf16)
    if pk.n_mid + 1 == li:
        h = skip(h)
    return torch.tanh(h @ w(pk.wl) + pk.bl)


def _chain_plain(pk: PackedDecoder, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward and input-gradient chain on rows x [N, in_dim] in plain
    PyTorch, with the roundings of `_forward_plain`."""
    bf16, D, li, k = pk.bf16, pk.D, pk.li, pk.in_dim
    w = lambda t: t.float()
    masks: List[torch.Tensor] = []
    y = _forward_plain(pk, x, masks)

    g = _round(1.0 - y * y, bf16)[:, None] * w(pk.wl)[None, :]
    gx = torch.zeros_like(x)
    if pk.n_mid + 1 == li:
        gx = gx + _round(g[:, D - k:], bf16)
    for j in range(pk.n_mid - 1, -1, -1):
        g = _round(g * masks[j + 1], bf16) @ w(pk.wmt[j])
        if j + 1 == li:
            gx = gx + _round(g[:, D - k:], bf16)
    g = _round(g * masks[0], bf16)
    return y, gx + g @ w(pk.w0).t()


def chain_plain(pk: PackedDecoder, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """`_chain_plain` in passes of PLAIN_ROWS rows. x [N, in_dim] f32 ->
    (sdf [N], grad [N, in_dim])."""
    if x.shape[0] <= PLAIN_ROWS:
        return _chain_plain(pk, x)
    outs = [_chain_plain(pk, x[i:i + PLAIN_ROWS]) for i in range(0, x.shape[0], PLAIN_ROWS)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def forward_plain(pk: PackedDecoder, x: torch.Tensor) -> torch.Tensor:
    """`_forward_plain` in passes of PLAIN_ROWS rows. x [N, in_dim] f32 ->
    sdf [N]."""
    if x.shape[0] <= PLAIN_ROWS:
        return _forward_plain(pk, x)
    return torch.cat([_forward_plain(pk, x[i:i + PLAIN_ROWS])
                      for i in range(0, x.shape[0], PLAIN_ROWS)])


def shared_latent_plain(pk: PackedDecoder, latents: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Plain forward of every point under every code: latents [B, C],
    pts [N, 3] -> sdf [B, N], one code at a time."""
    N, C = pts.shape[0], latents.shape[1]
    return torch.stack([forward_plain(pk, torch.cat([lat.expand(N, C), pts], dim=1))
                        for lat in latents])


def _check_packed(pk: PackedDecoder, x: torch.Tensor) -> None:
    for name in STREAM_NAMES:
        t = getattr(pk, name)
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"packed weight {name} must be contiguous on {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"inputs must be float32, got {x.dtype}")


_P, _I = ctypes.c_void_p, ctypes.c_int
_STREAMS = [_P] * len(STREAM_NAMES) + [ctypes.c_float]   # fwd, bwd, wl, b0, bm, bl
# C entry and argument types of each kernel library
_ENTRIES = {
    # x, rows_per_lane, n_lanes, active, in_dim, D, n_mid, li, bf16, streams, sdf, grad, stream
    "mlp_fwd_grad": ("horti_mlp_fwd_grad",
                     [_P, _I, _I, _P, _I, _I, _I, _I, _I, *_STREAMS, _P, _P, _P]),
    # x, n_rows, in_dim, D, n_mid, li, bf16, streams, sdf, stream
    "mlp_fwd": ("horti_mlp_fwd", [_P, _I, _I, _I, _I, _I, _I, *_STREAMS, _P, _P]),
    # latents, n_codes, pts, n_pts, in_dim, D, n_mid, li, bf16, streams, out, stream
    "mlp_shared_latent": ("horti_mlp_shared_latent",
                          [_P, _I, _P, _I, _I, _I, _I, _I, _I, *_STREAMS, _P, _P]),
}
_bound: set = set()


def _entry(name: str):
    """The C entry of kernel library `name` (built at first use), with its
    argument types declared."""
    fn_name, argtypes = _ENTRIES[name]
    fn = getattr(cuda_build.load(name), fn_name)
    with _lock:
        if name not in _bound:
            fn.restype, fn.argtypes = ctypes.c_int, argtypes
            _bound.add(name)
    return fn


def wave_and_smem(name: str, pk: PackedDecoder) -> Tuple[int, int]:
    """(clusters the card holds at once, dynamic shared memory of a block in
    bytes) of kernel library `name` ("mlp_fwd_grad", "mlp_fwd" or
    "mlp_shared_latent") for pk's decoder and storage type, from the
    library's occupancy query."""
    lib = cuda_build.load(name)
    clusters, smem = getattr(lib, f"horti_{name}_clusters"), getattr(lib, f"horti_{name}_smem")
    clusters.restype, smem.restype = ctypes.c_int, ctypes.c_long
    clusters.argtypes = smem.argtypes = [_I] * 4
    args = (pk.D, pk.n_mid, pk.in_dim, int(pk.bf16))
    n = clusters(*args)
    cuda_build.check(max(-n, 0), f"horti_{name}_clusters")
    return n, smem(*args)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(entry, t: torch.Tensor, *args) -> int:
    """Call a kernel's C entry with the CUDA runtime's current device set to
    `t`'s device (the launch goes to the current device, whatever stream it
    is given) and `t`'s current stream as its last argument."""
    with torch.cuda.device(t.device):
        return entry(*args, _stream(t))


def _fwd_grad_cuda(pk: PackedDecoder, x: torch.Tensor,
                   active: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """B1 on rows x [N, in_dim]: `active` None, or [B] f32 with N = B x rows
    a lane (a block of a frozen lane writes zeros)."""
    _check_packed(pk, x)
    n = x.shape[0]
    lanes = 1 if active is None else active.shape[0]
    if active is not None and active.device != x.device:
        raise ValueError("lane_active must lie on the inputs' device")
    sdf = torch.empty(n, dtype=torch.float32, device=x.device)
    grad = torch.empty(n, pk.in_dim, dtype=torch.float32, device=x.device)
    rc = launch(
        _entry("mlp_fwd_grad"), x,
        x.data_ptr(), n // lanes, lanes, None if active is None else active.data_ptr(),
        pk.in_dim, pk.D, pk.n_mid, pk.li, int(pk.bf16), *pk.stream_ptrs(), pk.bl,
        sdf.data_ptr(), grad.data_ptr(),
    )
    cuda_build.check(rc, "horti_mlp_fwd_grad")
    trace.count(globals(), "launches")
    return sdf, grad


def _fwd_grad_plain(pk: PackedDecoder, x: torch.Tensor,
                    active: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of `_fwd_grad_cuda`: the chain on every row, then
    zeros on the rows of frozen lanes."""
    sdf, grad = chain_plain(pk, x)
    if active is None:
        return sdf, grad
    keep = (active > 0.5).repeat_interleave(x.shape[0] // active.shape[0])
    return (torch.where(keep, sdf, torch.zeros_like(sdf)),
            torch.where(keep[:, None], grad, torch.zeros_like(grad)))


def _fwd_cuda(pk: PackedDecoder, x: torch.Tensor) -> torch.Tensor:
    """B3 on rows x [N, in_dim]."""
    _check_packed(pk, x)
    n = x.shape[0]
    sdf = torch.empty(n, dtype=torch.float32, device=x.device)
    rc = launch(
        _entry("mlp_fwd"), x,
        x.data_ptr(), n, pk.in_dim, pk.D, pk.n_mid, pk.li, int(pk.bf16),
        *pk.stream_ptrs(), pk.bl, sdf.data_ptr(),
    )
    cuda_build.check(rc, "horti_mlp_fwd")
    trace.count(globals(), "launches_fwd")
    return sdf


def _shared_latent_cuda(pk: PackedDecoder, latents: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """B4: every point of pts [N, 3] under every code of latents [B, C], in
    B x ceil(N / 64) chunks that never span two codes."""
    B, N = latents.shape[0], pts.shape[0]
    if B * -(-N // 64) > MAX_CHUNKS:
        raise ValueError(f"at most {MAX_CHUNKS} chunks of 64 points a launch, got {B} codes x {N}")
    _check_packed(pk, pts)
    if latents.device != pts.device:
        raise ValueError("latents and pts must lie on one device")
    out = torch.empty(B, N, dtype=torch.float32, device=pts.device)
    rc = launch(
        _entry("mlp_shared_latent"), pts,
        latents.data_ptr(), B, pts.data_ptr(), N, pk.in_dim, pk.D, pk.n_mid, pk.li,
        int(pk.bf16), *pk.stream_ptrs(), pk.bl, out.data_ptr(),
    )
    cuda_build.check(rc, "horti_mlp_shared_latent")
    trace.count(globals(), "launches_shared_latent")
    return out


def _flatten(pk: PackedDecoder, inputs: torch.Tensor):
    if inputs.shape[-1] != pk.in_dim:
        raise ValueError(f"inputs last dim {inputs.shape[-1]} != {pk.in_dim}")
    lead = inputs.shape[:-1]
    return inputs.reshape(-1, pk.in_dim).float().contiguous(), lead


def _lane_mask(lane_active: Optional[torch.Tensor], lead) -> Optional[torch.Tensor]:
    if lane_active is None:
        return None
    if len(lead) < 1 or lane_active.numel() != lead[0]:
        raise ValueError(f"lane_active of {lane_active.numel()} lanes for inputs {tuple(lead)}")
    return lane_active.reshape(-1).to(torch.float32).contiguous()


def mlp_sdf_and_input_grad(pk: PackedDecoder, inputs: torch.Tensor,
                           lane_active: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., C+3) -> (sdf (...), d sdf / d input (..., C+3)). With
    `lane_active` [B] (bool) the inputs are [B, ..., C+3] and the rows of a
    frozen lane (False) come out zero, the kernel skipping them. CUDA tensors
    go to the kernel; CPU tensors to the plain version."""
    x, lead = _flatten(pk, inputs)
    active = _lane_mask(lane_active, lead)
    sdf, grad = (_fwd_grad_cuda if x.is_cuda else _fwd_grad_plain)(pk, x, active)
    return sdf.reshape(lead), grad.reshape(lead + (pk.in_dim,))


def mlp_sdf_and_input_grad_plain(pk: PackedDecoder, inputs: torch.Tensor,
                                 lane_active: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the same function, on any device (the
    CPU path, and the oracle the card compares the kernel with)."""
    x, lead = _flatten(pk, inputs)
    sdf, grad = _fwd_grad_plain(pk, x, _lane_mask(lane_active, lead))
    return sdf.reshape(lead), grad.reshape(lead + (pk.in_dim,))


def mlp_sdf(pk: PackedDecoder, inputs: torch.Tensor) -> torch.Tensor:
    """(..., C+3) -> tanh sdf (...). CUDA tensors go to the forward kernel
    (B3); CPU tensors to the plain version."""
    x, lead = _flatten(pk, inputs)
    sdf = _fwd_cuda(pk, x) if x.is_cuda else forward_plain(pk, x)
    return sdf.reshape(lead)


def mlp_sdf_plain(pk: PackedDecoder, inputs: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of `mlp_sdf`, on any device."""
    x, lead = _flatten(pk, inputs)
    return forward_plain(pk, x).reshape(lead)


def _shared_inputs(pk: PackedDecoder, latents: torch.Tensor, pts: torch.Tensor):
    if latents.dim() != 2 or latents.shape[1] + 3 != pk.in_dim:
        raise ValueError(f"latents must be [B, {pk.in_dim - 3}], got {tuple(latents.shape)}")
    if pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"pts must be [N, 3], got {tuple(pts.shape)}")
    return latents.float().contiguous(), pts.float().contiguous()


def mlp_sdf_shared_latent(pk: PackedDecoder, latents: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """latents [B, C], pts [N, 3] -> tanh sdf [B, N] of every point under
    every code. CUDA tensors go to the shared-latent kernel (B4), one launch
    for all B codes; CPU tensors to the plain version."""
    latents, pts = _shared_inputs(pk, latents, pts)
    if pts.is_cuda:
        return _shared_latent_cuda(pk, latents, pts)
    return shared_latent_plain(pk, latents, pts)


def mlp_sdf_shared_latent_plain(pk: PackedDecoder, latents: torch.Tensor,
                                pts: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of `mlp_sdf_shared_latent`, on any device."""
    return shared_latent_plain(pk, *_shared_inputs(pk, latents, pts))


class KernelDecoder:
    """Packed weights for the kernels (counterpart of `PallasDecoder`):
    `sdf` through the forward kernel in the storage type `bf16` picks,
    `sdf_and_input_grad` through the fwd+input-grad kernel in f32 (its f32
    weights are packed on its first call when `sdf` stores bf16)."""

    def __init__(self, params: Params, spec: DecoderSpec, bf16: bool = True):
        if not supported(spec):
            raise ValueError(f"architecture not kernel-supported: {spec}")
        self.spec = spec
        self.bf16 = bf16
        self._params = params
        self.packed = pack_params(params, spec, torch.bfloat16 if bf16 else torch.float32)
        self._packed_f32 = None if bf16 else self.packed

    @property
    def packed_f32(self) -> PackedDecoder:
        if self._packed_f32 is None:
            self._packed_f32 = pack_params(self._params, self.spec, torch.float32)
        return self._packed_f32

    def sdf(self, inputs: torch.Tensor) -> torch.Tensor:
        return mlp_sdf(self.packed, inputs)

    def sdf_and_input_grad(self, inputs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return mlp_sdf_and_input_grad(self.packed_f32, inputs)
