"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources compile at first use with ``nvcc``, one object per ``.cu``
file, all started together, and link into a shared library with a plain C
interface under ``pgvector_rx_tpu_torch/_build/`` (named by the sources'
hash, so an edited source never loads a stale library), bound with
``ctypes``. Nothing here runs at import time: the CPU tests
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
_CSRC = _PKG / "csrc"
_SOURCES = tuple(_CSRC / f for f in ("k1_topk.cu", "k1_select.cu",
                                     "k2_binned.cu",
                                     "k3_tilemin.cu", "k4_beam.cu",
                                     "k7_coarse.cu",
                                     "k8_beam_ground.cu", "k9_bits.cu",
                                     "k9_bits_tc.cu", "k10_sparse.cu"))
_HEADERS = (_CSRC / "sweep_common.cuh",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
#: the compile steps, one nvcc each, all started together: every source,
#: and k4_beam.cu four times, its bf16 ranking's kernels (PGV_K4_PART=1),
#: the other block walks' modes (PGV_K4_PART=2) and the word walk's modes
#: (PGV_K4_PART=3) apart from the rest (its longest step at ~190 s in one
#: piece)
_UNITS = tuple((src, ()) for src in _SOURCES if src.name != "k4_beam.cu") + \
    tuple((_CSRC / "k4_beam.cu", (f"-DPGV_K4_PART={p}",)) for p in range(4))

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # base, dtype, a, q, q_big, q_small, n, d, b, k, kl, splits,
    # rows_per_split, part_d, part_i, sel_d, sel_i, out_d, out_i, stream
    "pgv_k1_surrogate_topk": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _P, _P, _P, _P, _P, _P, _P],
    # base, dtype, a, q, n, d, b, k, qg, rows_per_block, per, keys, hist,
    # state, cand, sel, order, out_d, out_i, stream
    "pgv_k1_select_topk": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                           _P, _P, _P, _P, _I, _P, _P, _P],
    # base, dtype, a, q, n, d, b, k, tn, bins_per_block, splits,
    # tiles_per_split, bins, out_d, out_i, stream
    "pgv_k2_binned_topk": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P],
    # base, a, q, n, d, b, tn, nc, splits, tiles_per_split, out, stream
    "pgv_k3_tilemin": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # base, n, d, out, stream
    "pgv_k3_x2max": [_P, _I, _I, _P, _P],
    # values, values2, dtype, stride, d, qd, nbrs, L, trav, cap, metric, q,
    # seed_ids, seed_d, b, S, W, max_steps, beam_d, beam_key, steps,
    # scored, upper_slot, upper, ustride, m, entry, entry_level, land,
    # E, vis, vwords, exact, exact_stride, stream
    "pgv_k4_beam_walk": [_P, _P, _I, _L, _I, _I, _P, _I, _P, _I, _I, _P, _P,
                         _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _L, _I,
                         _I, _I, _P, _I, _P, _I, _P, _L, _P],
    # values, dtype, stride, d, nbrs, L, trav, excl, excl_stride, allowed,
    # words, cap, metric, q, seed_ids, seed_d, b, S, W, ef, SP, max_steps,
    # mark, report, spill_d, spill_ids, E, exact, exact_stride, stream
    "pgv_k5_beam_scan": [_P, _I, _L, _I, _P, _I, _P, _P, _L, _P, _I, _I, _I,
                         _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                         _I, _P, _L, _P],
    # rows, a, ids, trav, q, n, d, b, s, l2, splits, rows_per_split, part,
    # out_slot, out_id, stream
    "pgv_k7_coarse_topk": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _P, _P, _P, _P],
    # rows, a, ids, trav, q, n, d, s, l2, lanes, blocks, part, ticket,
    # out_slot, out_id, stream
    "pgv_k7_coarse_one": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                          _P, _P, _P],
    # rows, stride, d, nbrs, lm0, alive, cap, q, bd, bkey, b, W, E, steps,
    # metric, merge, out_d, out_ids, stream
    "pgv_k8_beam_ground": [_P, _L, _I, _P, _I, _P, _I, _P, _P, _P, _I, _I,
                           _I, _I, _I, _I, _P, _P, _P],
    # words, pop, live, q, lo, n, w, b, k, metric, qb, splits,
    # rows_per_split, part, out, stream
    "pgv_k9_bits_topk": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P],
    # words, live, q, lo, n, w, b, k, metric, splits, rows_per_split, part,
    # shared, out, stream
    "pgv_k9_bits_tc_topk": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                            _P, _P, _P],
    # w, k, resident (out) -> shared memory bytes
    "pgv_k9_tc_smem": [_I, _I, _P],
    # ci, total, uni, u, blocks, out, stream
    "pgv_k10_compact": [_P, _L, _P, _I, _I, _P, _P],
    # ci, cv, live, qd, qsq, qabs, lo, n, p, b, k, dim, ldq, metric, approx,
    # warps, rc, splits, rows_per_split, part, out, stream
    "pgv_k10_dense_topk": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
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
    for src in (*_SOURCES, *_HEADERS):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr([(src.name, defs) for src, defs in _UNITS]).encode())
    return BUILD_DIR / f"libpgv_kernels-{h.hexdigest()[:12]}.so"


def _run_all(cmds) -> None:
    """Run the commands side by side; raise with the first failure's
    stderr."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, p, (_, err) in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err}")


def build() -> Path:
    """Compile the kernels if this source hash has no library yet: one
    ``nvcc`` per source, all started together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.{i}.o"
            for i, (src, _) in enumerate(_UNITS)]
    nvcc = _nvcc()
    _run_all([[nvcc, *NVCC_FLAGS, *defs, "-c", "-o", str(o), str(src)]
              for (src, defs), o in zip(_UNITS, objs)])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               *map(str, objs)]])
    for o in objs:
        o.unlink()
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
