"""ctypes binding of the host C++ code (`src/horti_native.cpp`, a copy of
the JAX package's source): marching tetrahedra, marching cubes, DBSCAN and
brute-force NN distances.

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
from typing import Optional, Tuple

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
                ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on horti_native.cpp:\n{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        fp = ctypes.POINTER(ctypes.c_float)
        for fn in (lib.horti_marching_tetrahedra, lib.horti_marching_cubes):
            fn.restype = ctypes.c_int
            fn.argtypes = [
                fp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.POINTER(fp), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)), ctypes.POINTER(ctypes.c_int64),
            ]
        lib.horti_free.argtypes = [ctypes.c_void_p]
        lib.horti_dbscan.restype = ctypes.c_int
        lib.horti_dbscan.argtypes = [fp, ctypes.c_int64, ctypes.c_float, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int32)]
        lib.horti_nn_distances.restype = None
        lib.horti_nn_distances.argtypes = [fp, ctypes.c_int64, fp, ctypes.c_int64, fp]
        _lib = lib
        return lib


def _iso_surface(entry: str, grid: np.ndarray, iso: float,
                 spacing: float) -> Tuple[np.ndarray, np.ndarray]:
    grid = np.ascontiguousarray(grid, np.float32)
    lib = load()
    nx, ny, nz = grid.shape
    pv = ctypes.POINTER(ctypes.c_float)()
    pf = ctypes.POINTER(ctypes.c_int32)()
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    rc = getattr(lib, entry)(
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nx, ny, nz,
        ctypes.c_float(iso), ctypes.c_float(spacing),
        ctypes.byref(pv), ctypes.byref(nv), ctypes.byref(pf), ctypes.byref(nf),
    )
    if rc != 0:
        raise MemoryError("iso-surface allocation failed")
    try:
        verts = (np.ctypeslib.as_array(pv, shape=(nv.value, 3)).copy() if nv.value
                 else np.zeros((0, 3), np.float32))
        faces = (np.ctypeslib.as_array(pf, shape=(nf.value, 3)).copy() if nf.value
                 else np.zeros((0, 3), np.int32))
    finally:
        lib.horti_free(pv)
        lib.horti_free(pf)
    return verts, faces


def marching_tetrahedra(grid: np.ndarray, iso: float = 0.0,
                        spacing: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Iso-surface of a (nx, ny, nz) field: (verts (V, 3) f32 in
    index * spacing coordinates, faces (F, 3) int32), watertight (consistent
    6-tet cube decomposition, welded vertices)."""
    return _iso_surface("horti_marching_tetrahedra", grid, iso, spacing)


def marching_cubes(grid: np.ndarray, iso: float = 0.0,
                   spacing: float = 1.0) -> Tuple[np.ndarray, np.ndarray]:
    """Classic cube-cell marching cubes, in the layout of
    `marching_tetrahedra`: the same welded crossing-edge vertices, about half
    the triangles, outward winding (normals toward +SDF)."""
    return _iso_surface("horti_marching_cubes", grid, iso, spacing)


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
