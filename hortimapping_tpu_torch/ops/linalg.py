"""The LM loop's small linear algebra, free of host synchronization on the
card: the solve of the damped normal equations, the 3x3 determinant and
the inverse of a 4x4 affine matrix.

On a CUDA tensor `torch.linalg.solve_ex` factors through a batched LU that
synchronizes the device (at B = 32 it calls cudaDeviceSynchronize), and
`torch.linalg.inv` / `det` check or factor through the same LU, so none of
them can run inside a captured CUDA graph. There `solve` launches the
kernel `csrc/lm_solve.cu` (D <= MAX_SOLVE_DIM) and `det` / `inv` take the
closed forms `det3` / `inv4`. CPU tensors keep `torch.linalg`, the plain
versions the CPU tests hold against the JAX package.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from hortimapping_tpu_torch.ops import cuda_build, mlp_kernels
from hortimapping_tpu_torch.utils import trace

MAX_SOLVE_DIM = 64   # widest system the kernel takes (lm_solve.cu kMaxDim)

# launches of the solve kernel since the count was last set to 0, counted
# per launch on the device: a captured graph adds its own at each replay
# (`utils/trace.count`)
launches = 0
_local = threading.local()   # `captured`: launches recorded into a graph being captured
_lock = threading.Lock()
_entry_fn = None


def det3(A: torch.Tensor) -> torch.Tensor:
    """det of A [..., 3, 3]: row 0 dotted with row 1 x row 2."""
    return (A[..., 0, :] * torch.linalg.cross(A[..., 1, :], A[..., 2, :], dim=-1)).sum(-1)


def inv4(T: torch.Tensor) -> torch.Tensor:
    """The exact inverse of affine T [..., 4, 4] (last row 0 0 0 1):
    A^-1 = adj(A) / det(A) of its 3x3 block A, whose columns are the cross
    products of A's rows, then -A^-1 t."""
    A, t = T[..., :3, :3], T[..., :3, 3]
    # rows c(r1, r2), c(r2, r0), c(r0, r1): adj(A) transposed
    adj_t = torch.linalg.cross(torch.roll(A, -1, dims=-2), torch.roll(A, -2, dims=-2), dim=-1)
    det = (A[..., 0, :] * adj_t[..., 0, :]).sum(-1)
    A_inv = adj_t.transpose(-1, -2) / det[..., None, None]
    out = torch.zeros_like(T)
    out[..., :3, :3] = A_inv
    out[..., :3, 3] = -(A_inv @ t[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def det(A: torch.Tensor) -> torch.Tensor:
    """det of A [..., 3, 3]: `det3` on the card, `torch.linalg.det` on the
    CPU."""
    return det3(A) if A.is_cuda else torch.linalg.det(A)


def inv(T: torch.Tensor) -> torch.Tensor:
    """The inverse of affine T [..., 4, 4]: `inv4` on the card,
    `torch.linalg.inv` on the CPU."""
    return inv4(T) if T.is_cuda else torch.linalg.inv(T)


def solve(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x [B, D] of H x = b per lane, H [B, D, D] and b [B, D] f32. CUDA
    tensors launch the kernel (D <= MAX_SOLVE_DIM, every decoder of the
    repo; a wider system is refused); CPU tensors take
    `torch.linalg.solve_ex`. A singular H gives inf/nan in its lane on both,
    never an error."""
    if H.is_cuda:
        return _solve_cuda(H, b)
    return torch.linalg.solve_ex(H, b[..., None])[0][..., 0]


def _entry():
    global _entry_fn
    if _entry_fn is None:
        fn = cuda_build.load("lm_solve").horti_lm_solve
        with _lock:
            p = ctypes.c_void_p
            fn.restype = ctypes.c_int
            fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, p]   # H, b, x, lanes, D, stream
            _entry_fn = fn
    return _entry_fn


def _solve_cuda(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    B, D = b.shape
    if H.shape != (B, D, D) or H.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"H [B, D, D] and b [B, D] in f32, got {tuple(H.shape)} {H.dtype}, "
                         f"{tuple(b.shape)} {b.dtype}")
    if b.device != H.device:
        raise ValueError("H and b must lie on one device")
    if D > MAX_SOLVE_DIM:
        raise ValueError(f"the solve kernel takes D <= {MAX_SOLVE_DIM}, got {D}")
    H, b = H.contiguous(), b.contiguous()
    x = torch.empty_like(b)
    rc = mlp_kernels.launch(_entry(), H, H.data_ptr(), b.data_ptr(), x.data_ptr(), B, D)
    cuda_build.check(rc, "horti_lm_solve")
    if torch.cuda.is_current_stream_capturing():
        _local.captured = getattr(_local, "captured", 0) + 1
    else:
        trace.count(globals(), "launches")
    return x


def captured_launches(reset: bool = False) -> int:
    """Launches this thread recorded into graphs under capture since the
    last reset: what each replay of such a graph launches."""
    n = getattr(_local, "captured", 0)
    if reset:
        _local.captured = 0
    return n
