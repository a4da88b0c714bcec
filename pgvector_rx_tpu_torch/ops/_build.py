"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources compile at first use with ``nvcc`` into a shared library with
a plain C interface under ``pgvector_rx_tpu_torch/_build/`` (named by the
sources' hash, so an edited source never loads a stale library), and are
bound with ``ctypes``. Nothing here runs at import time: the CPU tests
import every module on machines with no CUDA toolkit.

A failed build raises with nvcc's stderr; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_SOURCES = (_PKG / "csrc" / "bruteforce.cu",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # base, a, q, n, d, b, k, splits, rows_per_split, part_d, part_i,
    # out_d, out_i, stream
    "pgv_k1_surrogate_topk": [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _P, _P, _P, _P, _P],
    # base, a, q, n, d, b, k, tn, splits, tiles_per_split, bins,
    # out_d, out_i, stream
    "pgv_k2_binned_topk": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P],
    # base, a, q, n, d, b, tn, nc, out, stream
    "pgv_k3_tilemin": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = Path(home or "/usr/local/cuda") / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    h = hashlib.sha1()
    for src in _SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpgv_kernels-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the kernels if this source hash has no library yet."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
        )
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
