"""Build and load the port's CUDA kernels (nvcc into shared libraries with a
plain C interface, loaded with ctypes).

Each `csrc/*.cu` becomes `_build/lib<name>-<hash>.so` at first use, where the
hash covers the source and the shared headers, so an edited kernel rebuilds
and an unchanged one loads at once. `build_all` starts one `nvcc` per source
at the same time. A failed build raises with the compiler's output; there is
no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
KERNELS = ("mlp_fwd_grad", "fused_render", "mlp_fwd", "mlp_shared_latent", "lm_solve")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def _start_build(name: str) -> Optional[subprocess.Popen]:
    out = _lib_path(name)
    if os.path.isfile(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.horti_out, proc.horti_tmp = out, tmp
    return proc


def _finish_build(name: str, proc: subprocess.Popen) -> None:
    log, _ = proc.communicate()
    with open(os.path.join(BUILD_DIR, f"{name}.log"), "w") as f:
        f.write(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(proc.horti_tmp, proc.horti_out)


def build_all(names: Iterable[str] = KERNELS) -> None:
    """Build every kernel library that is not built yet, all nvcc processes
    at once."""
    names = list(names)
    with _lock:
        procs = {n: _start_build(n) for n in names}
        try:
            for n, p in procs.items():
                if p is not None:
                    _finish_build(n, p)
        finally:
            for p in procs.values():
                if p is not None and p.poll() is None:
                    p.kill()


def build_log(name: str) -> str:
    path = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.isfile(path):
        return ""
    with open(path) as f:
        return f.read()


def ptxas_summary(log: str):
    """One line per kernel of an nvcc -Xptxas -v log: registers, static
    shared memory and spills."""
    out, name, frame = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(_Z(\d+)(\w+))'", line)
        if m:
            base = m.group(3)[:int(m.group(2))]
            rest = m.group(3)[int(m.group(2)):]
            name = base + ("<bf16>" if "bfloat16" in rest else "<f32>" if rest.startswith("If") else "")
            frame = ""
        elif "stack frame" in line:
            frame = line.strip()
        elif "Used" in line and "registers" in line:
            out.append(f"{name}: {line.split(':', 1)[1].strip()} | {frame}")
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(_lib_path(name))
        return _libs[name]


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
