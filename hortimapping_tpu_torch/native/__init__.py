"""ctypes binding of the host C++ code (`src/horti_native.cpp`, from the JAX
package's source): marching tetrahedra and marching cubes over a batch of
grids on a pool of threads, DBSCAN and brute-force NN distances.

The library is built with g++ at first use into the port's own build
directory (`hortimapping_tpu_torch/_build/`), never next to the source. A
failed build raises; there is no numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import weakref
from typing import List, Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src", "horti_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libhorti_native-{digest}.so")


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not os.path.isfile(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            proc = subprocess.run(
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", _SRC, "-o", tmp],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on horti_native.cpp:\n{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        fp = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        c_int, c_float = ctypes.c_int, ctypes.c_float
        vpp = ctypes.POINTER(ctypes.c_void_p)
        lib.horti_iso_surface_batch.restype = ctypes.c_void_p
        lib.horti_iso_surface_batch.argtypes = [
            ctypes.c_void_p, c_int, ctypes.c_int64, c_int, c_int, c_int, c_float, c_float,
            c_float, c_float, c_int, c_int, i64p, i64p, vpp, vpp, ctypes.POINTER(c_int),
        ]
        lib.horti_iso_batch_free.restype = None
        lib.horti_iso_batch_free.argtypes = [ctypes.c_void_p]
        lib.horti_dbscan.restype = ctypes.c_int
        lib.horti_dbscan.argtypes = [fp, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int32)]
        lib.horti_nn_distances.restype = None
        lib.horti_nn_distances.argtypes = [fp, ctypes.c_int64, fp, ctypes.c_int64, fp]
        _lib = lib
        return lib


_METHODS = {"mt": 0, "mc": 1}


class _Batch:
    """A batch's output in native memory, freed once no array made from it
    is left."""
    __slots__ = ("__weakref__",)


def _view(addr: int, count: int, ctype, owner: _Batch) -> np.ndarray:
    """(count, 3) array over native memory, keeping `owner` alive."""
    if not count:
        return np.zeros((0, 3), np.dtype(ctype))
    buf = (ctype * (3 * count)).from_address(addr)
    buf.owner = owner
    return np.frombuffer(buf, np.dtype(ctype)).reshape(count, 3)


def iso_surface_batch(grids: np.ndarray, iso: float = 0.0, spacing: float = 1.0,
                      offset: float = 0.0, scale: float = 1.0, method: str = "mt",
                      n_threads: int = 1) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], int]:
    """Iso-surfaces of n (nx, ny, nz) fields, (n, nx, ny, nz) f16 (widened
    exactly in C++) or any float type (as f32), in one native call that
    holds no GIL: ([(verts (V, 3) f32, faces (F, 3) int32) per grid], the
    threads that meshed). Vertices are (index * spacing - offset) * scale in
    f32 arithmetic; faces index their own grid's vertices. The fruits go to
    min(n_threads, n) threads, and the output is the same at any count.
    `method`: "mt" (marching tetrahedra) or "mc" (marching cubes). The
    arrays lie, uncopied, in the memory the native code meshed into, which
    is freed with the batch's last array."""
    grids = np.asarray(grids)
    if grids.dtype != np.float16:
        grids = grids.astype(np.float32, copy=False)
    grids = np.ascontiguousarray(grids)
    if grids.ndim != 4:
        raise ValueError(f"grids must be (n, nx, ny, nz), got shape {grids.shape}")
    n, nx, ny, nz = grids.shape
    lib = load()
    vaddr, faddr = (ctypes.c_void_p * n)(), (ctypes.c_void_p * n)()
    nv, nf = np.zeros(n, np.int64), np.zeros(n, np.int64)
    used = ctypes.c_int(0)
    i64p = ctypes.POINTER(ctypes.c_int64)
    batch = lib.horti_iso_surface_batch(
        grids.ctypes.data_as(ctypes.c_void_p), int(grids.dtype == np.float16), n, nx, ny, nz,
        iso, spacing, offset, scale, _METHODS[method], n_threads, nv.ctypes.data_as(i64p),
        nf.ctypes.data_as(i64p), vaddr, faddr, ctypes.byref(used))
    if not batch:
        raise MemoryError("iso-surface allocation failed")
    owner = _Batch()
    weakref.finalize(owner, lib.horti_iso_batch_free, batch)
    return [(_view(vaddr[i], int(nv[i]), ctypes.c_float, owner),
             _view(faddr[i], int(nf[i]), ctypes.c_int32, owner)) for i in range(n)], used.value


def marching_tetrahedra(grid: np.ndarray, iso: float = 0.0,
                        spacing: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Iso-surface of a (nx, ny, nz) field: (verts (V, 3) f32 in
    index * spacing coordinates, faces (F, 3) int32), watertight (consistent
    6-tet cube decomposition, welded vertices)."""
    return iso_surface_batch(np.asarray(grid)[None], iso, spacing, method="mt")[0][0]


def marching_cubes(grid: np.ndarray, iso: float = 0.0,
                   spacing: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Classic cube-cell marching cubes, in the layout of
    `marching_tetrahedra`: the same welded crossing-edge vertices, about half
    the triangles, outward winding (normals toward +SDF)."""
    return iso_surface_batch(np.asarray(grid)[None], iso, spacing, method="mc")[0][0]


def dbscan(points: np.ndarray, eps: float, min_points: int) -> np.ndarray:
    """DBSCAN labels of (N, 3) points, -1 for noise (Open3D `cluster_dbscan`
    semantics: a core point has >= min_points neighbours within eps,
    itself included)."""
    points = np.ascontiguousarray(points, np.float32)
    labels = np.empty(points.shape[0], np.int32)
    load().horti_dbscan(points.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), points.shape[0],
                        eps, min_points, labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels


def nn_distances(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """For each point of `a`, the distance to the nearest point of `b`
    (host brute force)."""
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    out = np.empty(a.shape[0], np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    load().horti_nn_distances(a.ctypes.data_as(fp), a.shape[0], b.ctypes.data_as(fp),
                              b.shape[0], out.ctypes.data_as(fp))
    return out
