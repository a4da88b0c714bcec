"""Native (C++) host graph engine of the port: loader, ctypes bindings,
and the native builds into a torch index.

The port's own copy of ``pgvector_rx_tpu/native/__init__.py`` without its
JAX export: ``csrc/hnswcore.cpp`` (a copy of ``native/hnswcore.cpp``)
compiles with ``g++`` at first use into ``pgvector_rx_tpu_torch/_build/``
(named by the source's hash), and is exposed as :class:`NativeGraph`.
The engine implements the same algorithms as :mod:`.graph.host`.

``available()`` returns False when the library does not build (or
``PGV_DISABLE_NATIVE=1``), and ``method="auto"`` then takes the Python
engine; ``NativeGraph`` raises with the compiler's stderr.
``native_bulk_build_serving`` builds on the host and puts the flat
serving arrays on the index's device as a torch ``DeviceGraph``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

from .constants import hnsw_get_layer_m
from .graph.device import DeviceGraph, _serve_dtype_for, _serve_value_arrays
from .graph.device_build import _prepare_dense_bulk

_METRIC_CODE = {
    "l2": 0,
    "ip": 1,
    "cosine": 2,
    "l1": 3,
    "hamming": 4,
    "jaccard": 5,
}

_SP_PAD = np.int32(2**31 - 1)

_lib = None
_tried = False
#: why the library is unavailable (the compiler's stderr), once tried
_error = ""

_PKG = Path(__file__).resolve().parent
_SOURCE = _PKG / "csrc" / "hnswcore.cpp"


def _lib_path() -> Path:
    digest = hashlib.sha1(_SOURCE.read_bytes()).hexdigest()[:12]
    return _PKG / "_build" / f"_hnswcore-{digest}.so"


def _compile() -> Path | None:
    global _error
    out = _lib_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-ffast-math",
        "-fno-finite-math-only",
        "-shared",
        "-fPIC",
        "-std=c++17",
        str(_SOURCE),
        "-o",
        str(tmp),
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as exc:
        _error = f"{' '.join(cmd)}: {exc}"
        return None
    if res.returncode != 0:
        _error = f"{' '.join(cmd)} failed ({res.returncode}):\n{res.stderr}"
        return None
    os.replace(tmp, out)
    return out


def _load():
    global _lib, _tried, _error
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("PGV_DISABLE_NATIVE"):
        _error = "PGV_DISABLE_NATIVE is set"
        return None
    path = _compile()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as exc:
        _error = str(exc)
        return None

    c_i32, c_i64, c_f32 = ctypes.c_int32, ctypes.c_int64, ctypes.c_float
    c_u32 = ctypes.c_uint32
    p = ctypes.POINTER
    lib.hnsw_create.restype = ctypes.c_void_p
    lib.hnsw_create.argtypes = [ctypes.c_int] * 4
    lib.hnsw_create_bit.restype = ctypes.c_void_p
    lib.hnsw_create_bit.argtypes = [ctypes.c_int] * 4
    lib.hnsw_create_sparse.restype = ctypes.c_void_p
    lib.hnsw_create_sparse.argtypes = [ctypes.c_int] * 4
    lib.hnsw_insert_bit.restype = c_i32
    lib.hnsw_insert_bit.argtypes = [ctypes.c_void_p, p(c_u32), ctypes.c_int, c_i64]
    lib.hnsw_insert_sparse.restype = c_i32
    lib.hnsw_insert_sparse.argtypes = [
        ctypes.c_void_p,
        p(c_i32),
        p(c_f32),
        ctypes.c_int,
        c_i64,
    ]
    lib.hnsw_bulk_insert_bit.restype = c_i32
    lib.hnsw_bulk_insert_bit.argtypes = [
        ctypes.c_void_p,
        p(c_u32),
        p(ctypes.c_int),
        p(c_i64),
        ctypes.c_int,
    ]
    lib.hnsw_bulk_insert_sparse.restype = c_i32
    lib.hnsw_bulk_insert_sparse.argtypes = [
        ctypes.c_void_p,
        p(c_i32),
        p(c_f32),
        p(ctypes.c_int),
        p(c_i64),
        ctypes.c_int,
    ]
    lib.hnsw_search_bit.restype = c_i32
    lib.hnsw_search_bit.argtypes = [
        ctypes.c_void_p,
        p(c_u32),
        ctypes.c_int,
        p(c_i32),
        p(c_f32),
    ]
    lib.hnsw_search_sparse.restype = c_i32
    lib.hnsw_search_sparse.argtypes = [
        ctypes.c_void_p,
        p(c_i32),
        p(c_f32),
        ctypes.c_int,
        p(c_i32),
        p(c_f32),
    ]
    lib.hnsw_destroy.argtypes = [ctypes.c_void_p]
    lib.hnsw_insert.restype = c_i32
    lib.hnsw_insert.argtypes = [ctypes.c_void_p, p(c_f32), ctypes.c_int, c_i64]
    lib.hnsw_bulk_insert.restype = c_i32
    lib.hnsw_bulk_insert.argtypes = [
        ctypes.c_void_p,
        p(c_f32),
        p(ctypes.c_int),
        p(c_i64),
        ctypes.c_int,
    ]
    lib.hnsw_n_elements.restype = c_i32
    lib.hnsw_n_elements.argtypes = [ctypes.c_void_p]
    lib.hnsw_entry.restype = c_i32
    lib.hnsw_entry.argtypes = [ctypes.c_void_p]
    lib.hnsw_element_level.restype = c_i32
    lib.hnsw_element_level.argtypes = [ctypes.c_void_p, c_i32]
    lib.hnsw_element_tids.restype = c_i32
    lib.hnsw_element_tids.argtypes = [ctypes.c_void_p, c_i32, p(c_i64), ctypes.c_int]
    lib.hnsw_element_neighbors.restype = c_i32
    lib.hnsw_element_neighbors.argtypes = [
        ctypes.c_void_p,
        c_i32,
        ctypes.c_int,
        p(c_i32),
        p(c_f32),
        ctypes.c_int,
    ]
    lib.hnsw_search.restype = c_i32
    lib.hnsw_search.argtypes = [ctypes.c_void_p, p(c_f32), ctypes.c_int, p(c_i32), p(c_f32)]
    lib.hnsw_search_batch.argtypes = [
        ctypes.c_void_p,
        p(c_f32),
        ctypes.c_int,
        ctypes.c_int,
        p(c_i32),
        p(c_f32),
    ]
    lib.hnsw_load.argtypes = [
        ctypes.c_void_p,
        p(c_f32),
        p(c_u32),
        p(c_i32),
        p(c_i32),
        p(ctypes.c_uint8),
        p(c_i64),
        p(c_i32),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.hnsw_load_neighbors.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        p(c_i32),
        c_i32,
        p(c_i32),
        p(c_f32),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.hnsw_set_entry.argtypes = [ctypes.c_void_p, c_i32]
    lib.hnsw_vacuum.restype = c_i32
    lib.hnsw_vacuum.argtypes = [ctypes.c_void_p, p(c_i32), ctypes.c_int, p(c_i32)]
    lib.hnsw_graph_stats.argtypes = [ctypes.c_void_p, p(c_i64)]
    lib.hnsw_export_flat.argtypes = [
        ctypes.c_void_p,
        c_i32,
        c_i32,
        c_i32,
        p(c_i32),  # nb0
        p(c_i32),  # upper
        p(c_i32),  # upper_slot
        p(c_i32),  # levels
        p(ctypes.c_uint8),  # trav
        p(c_i32),  # emit_tid
        p(c_i32),  # tid_count
        p(c_i64),  # tid_flat
        p(c_i64),  # tid_off
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class NativeGraph:
    """A native HNSW arena over dense f32, packed-bit (u32 words), or
    padded-CSR sparse rows."""

    def __init__(self, dim: int, m: int, ef_construction: int, metric: str,
                 kind: str = "dense"):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native engine unavailable: {_error}")
        self._lib = lib
        self.kind = kind
        self.dim = dim  # dense: floats; bit: u32 words; sparse: budget
        mc = _METRIC_CODE[metric]
        if kind == "dense":
            self._h = lib.hnsw_create(dim, m, ef_construction, mc)
        elif kind == "bit":
            self._h = lib.hnsw_create_bit(dim, m, ef_construction, mc)
        elif kind == "sparse":
            self._h = lib.hnsw_create_sparse(dim, m, ef_construction, mc)
        else:
            raise ValueError(kind)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.hnsw_destroy(self._h)
            self._h = None

    def bulk_insert(self, vecs: np.ndarray, levels: np.ndarray, tids: np.ndarray) -> int:
        levels = np.ascontiguousarray(levels, dtype=np.int32)
        tids = np.ascontiguousarray(tids, dtype=np.int64)
        lp = levels.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
        tp = tids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        if self.kind == "bit":
            rows = np.ascontiguousarray(vecs, dtype=np.uint32)
            return self._lib.hnsw_bulk_insert_bit(
                self._h,
                rows.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                lp, tp, len(rows),
            )
        if self.kind == "sparse":
            idx_rows, val_rows = vecs  # ([n, P] int32, [n, P] f32)
            idx_rows = np.ascontiguousarray(idx_rows, dtype=np.int32)
            val_rows = np.ascontiguousarray(val_rows, dtype=np.float32)
            return self._lib.hnsw_bulk_insert_sparse(
                self._h,
                idx_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                val_rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                lp, tp, len(idx_rows),
            )
        rows = np.ascontiguousarray(vecs, dtype=np.float32)
        return self._lib.hnsw_bulk_insert(
            self._h,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            lp, tp, len(rows),
        )

    def _bit_row(self, vec) -> np.ndarray:
        """Normalize a bit row to [dim] u32 words (packed uint8 bytes
        are word-packed, u32 inputs validated)."""
        v = np.asarray(vec)
        row = _bit_words(v) if v.dtype == np.uint8 else np.ascontiguousarray(
            v, dtype=np.uint32
        )
        if row.shape != (self.dim,):
            raise ValueError(f"expected {self.dim} words, got {row.shape}")
        return row

    def _sparse_row(self, vec):
        """Pad a (indices, values) pair to the engine budget."""
        qi, qv = vec
        qi = np.asarray(qi, dtype=np.int32)
        qv = np.asarray(qv, dtype=np.float32)
        if len(qi) > self.dim:
            raise ValueError(
                f"sparse row has {len(qi)} non-zeros, budget is {self.dim}"
            )
        pi = np.full(self.dim, _SP_PAD, dtype=np.int32)
        pv = np.zeros(self.dim, dtype=np.float32)
        pi[: len(qi)] = qi
        pv[: len(qv)] = qv
        return pi, pv

    def insert(self, vec, level: int, tid: int) -> int:
        if self.kind == "bit":
            row = self._bit_row(vec)
            return self._lib.hnsw_insert_bit(
                self._h,
                row.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                level, tid,
            )
        if self.kind == "sparse":
            qi, qv = self._sparse_row(vec)
            return self._lib.hnsw_insert_sparse(
                self._h,
                qi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                qv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                level, tid,
            )
        vec = np.ascontiguousarray(vec, dtype=np.float32)
        return self._lib.hnsw_insert(
            self._h, vec.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), level, tid
        )

    @property
    def n_elements(self) -> int:
        return self._lib.hnsw_n_elements(self._h)

    @property
    def entry(self) -> int:
        return self._lib.hnsw_entry(self._h)

    def element(self, idx: int):
        """(level, tids, neighbors_per_layer[(d, id), ...])."""
        level = self._lib.hnsw_element_level(self._h, idx)
        tid_buf = np.zeros(16, dtype=np.int64)
        nt = self._lib.hnsw_element_tids(
            self._h, idx, tid_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), 16
        )
        tids = tid_buf[: min(nt, 16)].tolist()
        layers = []
        cap = 256
        id_buf = np.zeros(cap, dtype=np.int32)
        d_buf = np.zeros(cap, dtype=np.float32)
        for lc in range(level + 1):
            nn = self._lib.hnsw_element_neighbors(
                self._h,
                idx,
                lc,
                id_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                d_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                cap,
            )
            layers.append(
                [(float(d_buf[i]), int(id_buf[i])) for i in range(min(nn, cap))]
            )
        return level, tids, layers

    def export_flat(self, lm0: int, m: int):
        """Whole-graph serving export in ONE native call: the
        DeviceGraph array layout (graph/device.py from_index) without
        per-element Python objects — the native path past the >2M
        host-graph materialization cliff. Returns a dict of numpy
        arrays + scalars (n, lmax, entry)."""
        stats = np.zeros(4, dtype=np.int64)
        self._lib.hnsw_graph_stats(
            self._h, stats.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        )
        n, n_up, max_level, total_tids = (int(x) for x in stats)
        lmax = max(1, max_level)
        nb0 = np.full((n + 1, lm0), -1, dtype=np.int32)
        upper = np.full((max(n_up, 1), lmax * m), -1, dtype=np.int32)
        upper_slot = np.full(n + 1, -1, dtype=np.int32)
        levels = np.full(n + 1, -1, dtype=np.int32)
        trav = np.zeros(n + 1, dtype=np.uint8)
        emit_tid = np.full(n + 1, -1, dtype=np.int32)
        tid_count = np.zeros(n + 1, dtype=np.int32)
        tid_flat = np.zeros(max(total_tids, 1), dtype=np.int64)
        tid_off = np.zeros(n + 1, dtype=np.int64)
        self._lib.hnsw_export_flat(
            self._h,
            lm0,
            lmax,
            m,
            _ptr(nb0, ctypes.c_int32),
            _ptr(upper, ctypes.c_int32),
            _ptr(upper_slot, ctypes.c_int32),
            _ptr(levels, ctypes.c_int32),
            _ptr(trav, ctypes.c_uint8),
            _ptr(emit_tid, ctypes.c_int32),
            _ptr(tid_count, ctypes.c_int32),
            _ptr(tid_flat, ctypes.c_int64),
            _ptr(tid_off, ctypes.c_int64),
        )
        return dict(
            n=n,
            lmax=lmax,
            entry=self.entry,
            neighbors0=nb0,
            upper_neighbors=upper,
            upper_slot=upper_slot,
            levels=levels,
            traversable=trav.astype(bool),
            emit_tid=emit_tid,
            tid_count=tid_count,
            tid_flat=tid_flat[:total_tids],
            tid_off=tid_off,
        )

    def search(self, query, ef: int):
        ids = np.full(ef, -1, dtype=np.int32)
        dists = np.full(ef, np.inf, dtype=np.float32)
        ip = ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        dp = dists.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        if self.kind == "bit":
            q = self._bit_row(query)
            n = self._lib.hnsw_search_bit(
                self._h,
                q.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                ef, ip, dp,
            )
        elif self.kind == "sparse":
            qi, qv = self._sparse_row(query)
            n = self._lib.hnsw_search_sparse(
                self._h,
                qi.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                qv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ef, ip, dp,
            )
        else:
            q = np.ascontiguousarray(query, dtype=np.float32)
            n = self._lib.hnsw_search(
                self._h,
                q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ef, ip, dp,
            )
        return dists[:n], ids[:n]

    def search_batch(self, queries: np.ndarray, ef: int):
        queries = np.ascontiguousarray(queries, dtype=np.float32)
        B = len(queries)
        ids = np.full((B, ef), -1, dtype=np.int32)
        dists = np.full((B, ef), np.inf, dtype=np.float32)
        self._lib.hnsw_search_batch(
            self._h,
            queries.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            B,
            ef,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            dists.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return dists, ids


def _bit_words(packed: np.ndarray) -> np.ndarray:
    """Packed uint8 bytes -> u32 words (zero-padded to a word multiple)."""
    pad = (-len(packed)) % 4
    if pad:
        packed = np.concatenate([packed, np.zeros(pad, np.uint8)])
    return packed.view(np.uint32)


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def native_vacuum(index, deleted) -> list[int]:
    """Vacuum graph repair (ambulkdelete pass 2) via the native engine.

    Reconstructs the arena from the index (bulk load, no re-insertion),
    runs hnsw_vacuum (repair-with-skip + mark + stale-ref cleanup with
    vacuum.py's exact pass order), writes the repaired neighbor lists
    and the new entry back into the Python index, and returns the list
    of repaired element ids. The caller still runs the Python mark pass
    (store zeroing, version bumps, free slots).
    """
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native engine unavailable: {_error}")
    n = len(index.elements)
    m = index.params.m
    if n == 0:
        return []

    # --- value rows
    null_f32 = ctypes.POINTER(ctypes.c_float)()
    null_u32 = ctypes.POINTER(ctypes.c_uint32)()
    null_i32 = ctypes.POINTER(ctypes.c_int32)()
    if index.kind == "dense":
        rows = np.ascontiguousarray(index.store.rows[:n], dtype=np.float32)
        ng = NativeGraph(index.dim, m, index.params.ef_construction, index.metric)
        row_args = (_ptr(rows, ctypes.c_float), null_u32, null_i32)
    elif index.kind == "bit":
        packed = np.ascontiguousarray(index.store.rows[:n])
        pad = (-packed.shape[1]) % 4
        if pad:
            packed = np.concatenate(
                [packed, np.zeros((n, pad), np.uint8)], axis=1
            )
        words = np.ascontiguousarray(packed).view(np.uint32)
        ng = NativeGraph(
            words.shape[1], m, index.params.ef_construction, index.metric,
            kind="bit",
        )
        row_args = (null_f32, _ptr(words, ctypes.c_uint32), null_i32)
    else:
        sp_i = np.ascontiguousarray(index.store.indices[:n], dtype=np.int32)
        sp_v = np.ascontiguousarray(index.store.values[:n], dtype=np.float32)
        ng = NativeGraph(
            sp_i.shape[1], m, index.params.ef_construction, index.metric,
            kind="sparse",
        )
        row_args = (_ptr(sp_v, ctypes.c_float), null_u32, _ptr(sp_i, ctypes.c_int32))

    # --- element metadata
    levels = np.fromiter(
        (e.level for e in index.elements), dtype=np.int32, count=n
    )
    dels_flag = np.fromiter(
        (e.deleted for e in index.elements), dtype=np.uint8, count=n
    )
    TS = 10
    tids = np.zeros((n, TS), dtype=np.int64)
    tid_counts = np.zeros(n, dtype=np.int32)
    for i, ts in enumerate(index.heap_tids[:n]):
        k = min(len(ts), TS)
        tid_counts[i] = k
        tids[i, :k] = ts[:k]
    lib.hnsw_load(
        ng._h, *row_args, _ptr(levels, ctypes.c_int32),
        _ptr(dels_flag, ctypes.c_uint8), _ptr(tids, ctypes.c_int64),
        _ptr(tid_counts, ctypes.c_int32), TS, n,
    )

    # --- adjacency per layer (layer 0 dense slab; upper layers compacted)
    lmax = max((e.level for e in index.elements), default=0)
    for lc in range(lmax + 1):
        width = hnsw_get_layer_m(m, lc)
        if lc == 0:
            el_ids = range(n)
            n_rows = n
            map_arg = ctypes.POINTER(ctypes.c_int32)()
        else:
            el_ids = [i for i, e in enumerate(index.elements) if e.level >= lc]
            n_rows = len(el_ids)
            if n_rows == 0:
                continue
            map_arr = np.asarray(el_ids, dtype=np.int32)
            map_arg = _ptr(map_arr, ctypes.c_int32)
        ids = np.full((n_rows, width), -1, dtype=np.int32)
        ds = np.zeros((n_rows, width), dtype=np.float32)
        for r, ei in enumerate(el_ids):
            nb = index.elements[ei].neighbors
            row = nb[lc] if lc < len(nb) else []
            for j, (d, nid) in enumerate(row[:width]):
                ids[r, j] = nid
                ds[r, j] = d
        lib.hnsw_load_neighbors(
            ng._h, lc, map_arg, 0, _ptr(ids, ctypes.c_int32),
            _ptr(ds, ctypes.c_float), n_rows, width,
        )
    lib.hnsw_set_entry(ng._h, index.entry if index.entry is not None else -1)

    # --- run vacuum, read back repaired lists + entry
    dels = np.asarray(sorted(deleted), dtype=np.int32)
    repaired_buf = np.zeros(n, dtype=np.int32)
    cnt = lib.hnsw_vacuum(
        ng._h, _ptr(dels, ctypes.c_int32), len(dels),
        _ptr(repaired_buf, ctypes.c_int32),
    )
    repaired = repaired_buf[:cnt].tolist()
    for ei in repaired:
        _, _, layers = ng.element(ei)
        index.elements[ei].neighbors = layers
    entry = lib.hnsw_entry(ng._h)
    index.entry = entry if entry >= 0 else None
    return repaired


def native_bulk_build(index, data, ids) -> None:
    """Build via the native engine, then populate the host index
    structures (used by HnswIndex.build(method='native')).

    Supports all kinds: dense f32, bit (packed rows re-packed to u32
    words for popcount distances), and sparse (rows padded to the max
    nnz of the batch, INT32_MAX index padding)."""
    from .graph.host import GraphElement

    prepared, kept_tids = [], []
    for value, tid in zip(data, ids):
        p = index.prepare_value(value)
        if p is None:
            continue
        prepared.append(p)
        kept_tids.append(int(tid))
    if not prepared:
        return
    levels = index.random_levels(len(prepared))
    tids = np.array(kept_tids, dtype=np.int64)

    if index.kind == "bit":
        rows = np.stack([_bit_words(np.asarray(p, np.uint8)) for p in prepared])
        ng = NativeGraph(
            rows.shape[1], index.params.m, index.params.ef_construction,
            index.metric, kind="bit",
        )
        ng.bulk_insert(rows, levels, tids)
    elif index.kind == "sparse":
        budget = max(max((len(p[0]) for p in prepared), default=1), 1)
        n_rows = len(prepared)
        idx_rows = np.full((n_rows, budget), _SP_PAD, dtype=np.int32)
        val_rows = np.zeros((n_rows, budget), dtype=np.float32)
        for r, (pi, pv) in enumerate(prepared):
            idx_rows[r, : len(pi)] = pi
            val_rows[r, : len(pv)] = pv
        ng = NativeGraph(
            budget, index.params.m, index.params.ef_construction,
            index.metric, kind="sparse",
        )
        ng.bulk_insert((idx_rows, val_rows), levels, tids)
    else:
        rows = np.stack([np.asarray(p, dtype=np.float32) for p in prepared])
        ng = NativeGraph(
            index.dim, index.params.m, index.params.ef_construction,
            index.metric,
        )
        ng.bulk_insert(rows, levels, tids)

    store_dtype = index.dtype or np.float32
    n = ng.n_elements
    # map native slots -> values: slots are assigned in insert order but
    # duplicates are folded, so reconstruct per-element values from tids
    tid_to_row = {t: i for i, t in enumerate(kept_tids)}
    for idx in range(n):
        level, etids, layers = ng.element(idx)
        e = GraphElement(level=level)
        e.neighbors = layers
        index.elements.append(e)
        index.heap_tids.append(etids)
        p = prepared[tid_to_row[etids[0]]]
        if index.kind == "dense":
            index.store.append(np.asarray(p, np.float32).astype(store_dtype))
        else:
            index.store.append(p)
    entry = ng.entry
    index.entry = entry if entry >= 0 else None
    index._invalidate_device()


def native_bulk_build_serving(index, data, ids) -> None:
    """Native C++ build -> serving-only index on ``index.device``: the
    graph goes from the C++ arena to flat tensors in one export call, with
    no per-element Python objects (dense and bit kinds)."""
    from .ops import bits

    if index.kind == "sparse":
        raise ValueError(
            "serving-only native build supports dense and bit kinds"
        )
    m = index.params.m
    store_dtype = index.dtype or np.float32
    if index.kind == "bit":
        rows = bits.prepare_rows(data, index.dim)  # packed bytes
        kept = np.asarray(list(ids), dtype=np.int64)[: len(rows)]
        if len(rows) == 0:
            return
        # the native engine's words reinterpret the bytes in place
        # (``_bit_words`` of every row at once)
        nat = np.ascontiguousarray(
            np.pad(rows, ((0, 0), (0, (-rows.shape[1]) % 4)))).view(np.uint32)
        ng = NativeGraph(nat.shape[1], m, index.params.ef_construction,
                         index.metric, kind="bit")
    else:
        rows, kept = _prepare_dense_bulk(index, data, ids)
        if index.dtype is not None and index.dtype != np.float32:
            # score the f16-STORED value (reload-equivalence)
            rows = rows.astype(index.dtype).astype(np.float32)
        if len(rows) == 0:
            return
        nat = rows
        ng = NativeGraph(index.dim, m, index.params.ef_construction,
                         index.metric)
    ng.bulk_insert(nat, index.random_levels(len(rows)), kept)

    flat = ng.export_flat(hnsw_get_layer_m(m, 0), m)
    n_el = flat["n"]
    tid_off = flat["tid_off"]
    tid_flat = flat["tid_flat"]
    # slot -> first heap tid (int64-exact) -> input row, vectorized
    first_tid = tid_flat[tid_off[:n_el]]
    order = np.argsort(kept, kind="stable")
    row_idx = order[np.searchsorted(kept[order], first_tid)]
    index.store.bulk_load(rows[row_idx] if index.kind == "bit"
                          else rows[row_idx].astype(store_dtype))

    # heap TID lists (multi-TID duplicate emission, <= 10 per element)
    counts = flat["tid_count"][:n_el]
    flat_list = tid_flat.tolist()
    offs = tid_off.tolist()
    index.heap_tids = [
        flat_list[offs[i] : offs[i] + int(counts[i])] for i in range(n_el)
    ]

    device = index.device
    if index.kind == "bit":
        # the device engines read the ops/bits.pack_bits layout (MSB-first
        # in each 32-bit word), not the native engine's byte-reinterpret
        # words: repack from the byte rows
        words = np.zeros((n_el + 1, -(-index.dim // 32)), dtype=np.uint32)
        words[:n_el] = bits.bytes_to_words(rows[row_idx], index.dim)
        value_arrays = dict(words=words)
    else:
        vals = np.zeros((n_el + 1, index.dim), dtype=np.float32)
        vals[:n_el] = rows[row_idx]
        value_arrays = _serve_value_arrays(
            torch.from_numpy(vals).to(device), _serve_dtype_for(index)
        )
    entry = ng.entry
    index.entry = entry if entry >= 0 else None
    index.serving_only = True
    index._device = DeviceGraph.from_numpy(
        {**flat, **value_arrays}, kind=index.kind, metric=index.metric,
        cap=n_el, m=m, entry=entry,
        entry_level=int(flat["levels"][entry]) if entry >= 0 else -1,
        device=device,
    )
