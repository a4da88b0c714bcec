"""HnswIndex of the PyTorch port: the index access layer.

The port's own copy of ``pgvector_rx_tpu/index/hnsw.py``'s host semantics
(validation, levels, duplicate handling, entry promotion, slot reuse,
sequential insert, delete and vacuum; reference ``src/index/build.rs`` and
``insert.rs``), with the device seams on torch: the index lives on a torch
``device``, ``build`` routes the batched device build and the
serving-only native build into a torch ``DeviceGraph``, and
``device_graph`` / ``search`` / ``scan`` / ``insert_bulk`` use the port's
engines, and ``save`` / ``load`` / ``enable_log`` its copy of the
checkpoint format (``index/storage.py``).

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
on a host with no CUDA device; pass ``device="cpu"`` to run on the CPU.
"""

from __future__ import annotations

import math
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from .. import constants as C
from ..config import IndexParams, SearchParams
from ..graph import host
from ..graph.host import GraphElement
from ..types.sparsevec import SparseVec
from ..utils.rwlock import UpdateLock
from . import stores

DENSE_METRICS = ("l2", "ip", "cosine", "l1")
BIT_METRICS = ("hamming", "jaccard")
SPARSE_METRICS = DENSE_METRICS

_ROADMAP_OFF_PATH = "ROADMAP queue 1, item 13b"


def resolve_device(device) -> torch.device:
    """``None`` -> the card (``"cuda"``); raises when no CUDA device is
    visible rather than falling through to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the port runs on the card by "
                'default; pass device="cpu" to run on the CPU'
            )
        device = "cuda"
    return torch.device(device)


class HnswIndex:
    """An HNSW index over one of the four vector types, whose device graph
    and engines are torch, on ``device`` ("cuda", "cuda:1", "cpu", ...;
    None = "cuda").

    Use :meth:`build` (bulk) or the constructor + :meth:`insert`.
    """

    def __init__(
        self,
        dim: int,
        metric: str = "l2",
        kind: str = "dense",
        params: IndexParams | None = None,
        dtype=np.float32,
        seed: int = 0,
        _skip_dim_check: bool = False,
        device=None,
    ):
        self.device = resolve_device(device)
        params = params or IndexParams()
        params.validate_for_build()
        if kind == "dense":
            if metric not in DENSE_METRICS:
                raise ValueError(f"unknown metric {metric!r} for dense index")
            max_dim = (
                C.HNSW_MAX_DIM_HALFVEC
                if np.dtype(dtype) == np.float16
                else C.HNSW_MAX_DIM
            )
            self.store = stores.DenseStore(dim, metric, dtype)
        elif kind == "bit":
            if metric not in BIT_METRICS:
                raise ValueError(f"unknown metric {metric!r} for bit index")
            max_dim = C.HNSW_MAX_DIM_BIT
            self.store = stores.BitStore(dim, metric)
        elif kind == "sparse":
            if metric not in SPARSE_METRICS:
                raise ValueError(f"unknown metric {metric!r} for sparse index")
            max_dim = C.SPARSEVEC_MAX_DIM
            self.store = stores.SparseStore(dim, metric)
        else:
            raise ValueError("type not supported for hnsw index")
        if dim < 1:
            raise ValueError("column does not have dimensions")
        if dim > max_dim and not _skip_dim_check:
            raise ValueError(
                f"column cannot have more than {max_dim} dimensions for hnsw index"
            )

        self.kind = kind
        self.metric = metric
        self.dim = int(dim)
        self.params = params
        self.dtype = np.dtype(dtype) if kind == "dense" else None
        self.max_level = C.hnsw_get_max_level(params.m)
        self.ml = C.hnsw_get_ml(params.m)

        self.elements: list[GraphElement] = []
        self.heap_tids: list[list[int]] = []
        self.entry: Optional[int] = None
        self.free_slots: list[int] = []
        self.seed = seed
        self.serving_only = False  # set by light device builds
        self._rng = np.random.default_rng(seed)
        self._device = None  # device graph cache (graph/device.py)
        self._log = None  # append log (storage.py attaches)
        self.stats = {"scans": 0, "inserts": 0, "duplicates": 0, "resumes": 0}
        # last batch-search ScanStats (EXPLAIN ANALYZE analog): host
        # searches fill it
        self.last_scan_stats = None
        # UPDATE_LOCK analog (insert.rs:1291-1313): inserts hold it
        # SHARED around the expensive Algorithm-1 neighbor search (many
        # writers search in parallel, like the reference's backends);
        # entry-promoting inserts, vacuum/delete, bulk ops, and
        # checkpoint hold it EXCLUSIVE. The mutate lock is the per-page
        # buffer-lock analog: concurrent shared inserts serialize only
        # their connect/alloc steps through it. Readers run lock-free
        # and optimistically, exactly like the reference's lock-free
        # neighbor reads — element versions catch recycled slots, and
        # list mutations are GIL-atomic (append / wholesale
        # replacement), so a concurrent scan sees either the old or the
        # new neighbor list, never a torn one. Contract tested by the
        # t/016 analog + parallel-search overlap test
        # (tests/test_concurrency.py).
        self._update_lock = UpdateLock()
        self._mutate_lock = threading.RLock()
        self._auto_tid = -1  # high-water mark for auto-assigned tids

    # -- basics --------------------------------------------------------------

    @property
    def count(self) -> int:
        """Live (non-deleted) element slots."""
        if self.serving_only and not self.elements:
            # serving-only builds keep no host GraphElements; the store
            # count is the live-row count (no host mutation path exists).
            # _serving_dead: rows already deleted in a host-graph
            # checkpoint loaded with serving=True
            # (storage._load_host_as_serving)
            return self.store.count - getattr(self, "_serving_dead", 0)
        return sum(
            1 for e in self.elements if not e.deleted and e.level >= 0
        )

    @property
    def num_tuples(self) -> int:
        return sum(len(t) for t in self.heap_tids)

    def _invalidate_device(self) -> None:
        self._device = None

    def _dist_many(self, query, ids):
        # build-path queries are element indices (graph/host passes
        # new_idx as the opaque query); scan-path queries are raw values
        if isinstance(query, (int, np.integer)):
            return self.store.pair_many(int(query), ids)
        return self.store.dist_many(query, ids)

    @property
    def _pair_many(self):
        pm = self.__dict__.get("_pair_many_fn")
        if pm is None:
            store = self.store

            def pair_many(idx, ids):
                return store.pair_many(idx, ids)

            # batched all-pairs hook used by select_neighbors
            pair_many.pair_matrix = store.pair_matrix
            self.__dict__["_pair_many_fn"] = pm = pair_many
        return pm

    def random_level(self) -> int:
        """floor(-ln(U)*mL) capped. Parity: build.rs:373-377."""
        u = self._rng.random()
        u = u if u > 0.0 else 1e-300
        level = int(math.floor(-math.log(u) * self.ml))
        return min(level, self.max_level)

    def random_levels(self, n: int) -> "np.ndarray":
        """Vectorized ``random_level`` — consumes the identical RNG
        stream (numpy Generator.random(n) == n sequential draws), so
        seeded builds are bit-identical to the per-row loop while
        skipping ~1s of Python per million rows."""
        import numpy as np

        u = self._rng.random(n)
        u = np.where(u > 0.0, u, 1e-300)
        levels = np.floor(-np.log(u) * self.ml).astype(np.int32)
        return np.minimum(levels, np.int32(self.max_level))

    # -- value preparation ---------------------------------------------------

    def prepare_value(self, value):
        """Validate/canonicalize one input value.

        Returns the canonical stored form, or None if the row must be
        skipped (cosine zero-norm, build.rs:426-438). Raises on
        dimension/nnz violations.
        """
        if self.kind == "dense":
            row = np.asarray(value, dtype=np.float32)
            if row.shape != (self.dim,):
                raise ValueError(
                    f"expected {self.dim} dimensions, not {row.shape[-1]}"
                )
            if self.metric == "cosine":
                n = math.sqrt(float(np.sum(row.astype(np.float64) ** 2)))
                if n == 0.0:
                    return None
                row = (row.astype(np.float64) / n).astype(np.float32)
            return row.astype(self.dtype)
        if self.kind == "bit":
            v = np.asarray(value)
            if v.dtype == np.uint8 and v.shape == (self.store.nbytes,):
                return v
            if v.shape != (self.dim,):
                raise ValueError(f"expected {self.dim} dimensions, not {v.shape[-1]}")
            return np.packbits(v.astype(np.uint8))
        # sparse
        if isinstance(value, SparseVec):
            idx, val = value.indices, value.values
            if value.dim != self.dim:
                raise ValueError(f"expected {self.dim} dimensions, not {value.dim}")
        else:
            idx, val = value
            idx = np.asarray(idx, dtype=np.int32)
            val = np.asarray(val, dtype=np.float32)
        if len(idx) > C.HNSW_MAX_NNZ:
            raise ValueError(
                f"sparsevec cannot have more than {C.HNSW_MAX_NNZ} "
                "non-zero elements for hnsw index"
            )
        if self.metric == "cosine":
            n = math.sqrt(float(np.sum(val.astype(np.float64) ** 2)))
            if n == 0.0:
                return None
            val64 = val.astype(np.float64) / n
            val = val64.astype(np.float32)
            keep = val != 0.0
            idx, val = idx[keep], val[keep]
        return (idx, val)

    # -- element slot management --------------------------------------------

    def _alloc_slot(self, level: int, value) -> int:
        """Place a new element, reusing a vacuumed slot when available
        (insert.rs:104-185); reused slots inherit their bumped version
        (insert.rs:283-287)."""
        if self.free_slots:
            idx = self.free_slots.pop()
            old_version = self.elements[idx].version
            self.elements[idx] = GraphElement(level=level, version=old_version)
            self.store.overwrite(idx, value)
            self.heap_tids[idx] = []
            return idx
        idx = self.store.append(value)
        self.elements.append(GraphElement(level=level))
        self.heap_tids.append([])
        assert len(self.elements) == self.store.count == len(self.heap_tids)
        return idx

    def _rollback_slot(self, idx: int) -> None:
        if idx == len(self.elements) - 1 and idx == self.store.count - 1:
            self.elements.pop()
            self.heap_tids.pop()
            self.store.pop()
        else:
            # reused slot: return it to the free list
            self.elements[idx].deleted = True
            self.elements[idx].neighbors = [[]]
            self.store.zero(idx)
            self.heap_tids[idx] = []
            self.free_slots.append(idx)

    # -- insert (build_callback / aminsert shared core) ----------------------

    def _try_duplicate(self, new_idx: int, tid: int) -> bool:
        """Absorb tid into a byte-equal zero-distance layer-0 neighbor.

        Parity: build.rs:474-510 / insert.rs:1136-1214. Neighbors are
        distance-ordered; stop at the first non-zero distance.
        """
        for d, n_idx in self.elements[new_idx].neighbors[0]:
            if d != 0.0:
                break
            if (
                self.store.value_bytes(n_idx) == self.store.value_bytes(new_idx)
                and not self.elements[n_idx].deleted
                and len(self.heap_tids[n_idx]) > 0  # being-deleted guard (insert.rs:1160)
                and len(self.heap_tids[n_idx]) < C.HNSW_HEAPTIDS
            ):
                self.heap_tids[n_idx].append(tid)
                self.stats["duplicates"] += 1
                return True
        return False

    def _insert_prepared(
        self,
        prepared,
        tid: int,
        entry_mode: int,
        level: Optional[int] = None,
    ) -> Optional[int]:
        """Insert one canonical value. Returns element idx or None if the
        TID was absorbed as a duplicate.

        Caller holds the UPDATE_LOCK (shared or exclusive). The
        expensive Algorithm-1 search runs OUTSIDE the mutate lock so
        concurrent shared inserts search in parallel — the reference's
        shared-UPDATE_LOCK scaling (insert.rs:1291-1313); alloc and the
        connect step take the mutate lock (buffer-lock analog)."""
        with self._mutate_lock:
            if level is None:
                level = self.random_level()
            new_idx = self._alloc_slot(level, prepared)
            if self.entry is None:
                self.heap_tids[new_idx] = [tid]
                self.entry = new_idx
                return new_idx
            entry_idx = self.entry

        host.find_element_neighbors(
            self.elements,
            new_idx,
            entry_idx,
            self.params.ef_construction,
            self.params.m,
            self._dist_many,
            self._pair_many,
        )
        with self._mutate_lock:
            if self._try_duplicate(new_idx, tid):
                self._rollback_slot(new_idx)
                return None
            host.update_neighbor_connections(
                self.elements, new_idx, self.params.m, self._pair_many
            )
            self.heap_tids[new_idx] = [tid]
            if entry_mode == C.HNSW_UPDATE_ENTRY_ALWAYS or (
                self.elements[new_idx].level > self.elements[entry_idx].level
            ):
                self.entry = new_idx
        return new_idx

    def insert(self, value, tid: Optional[int] = None) -> Optional[int]:
        """Insert one value (aminsert analog, insert.rs:1227-1480).

        Returns the element idx, or None if skipped (cosine zero norm) or
        absorbed as a duplicate.
        """
        if self.serving_only:
            raise RuntimeError(
                "serving-only index (built with host_graph=False) does not "
                "support insert; rebuild with host_graph=True"
            )
        prepared = self.prepare_value(value)
        if prepared is None:
            return None
        with self._mutate_lock:
            # numpy Generator is not thread-safe; draw under the lock
            level = self.random_level()
            entry = self.entry
        # Lock-mode choice, insert.rs:1291-1313: shared unless this
        # insert will (likely) update the entry point — empty graph or
        # level above the entry's. Entry levels only grow, so a
        # shared-mode insert can never trip the promotion check later.
        promote = entry is None or level > self.elements[entry].level
        lock = (
            self._update_lock.exclusive()
            if promote
            else self._update_lock.shared()
        )
        with lock:
            with self._mutate_lock:
                if tid is None:
                    # num_tuples alone races: in-flight shared inserts
                    # only publish their tid at connect time
                    tid = max(self.num_tuples, self._auto_tid + 1)
                    self._auto_tid = tid
                self._invalidate_device()
                self.stats["inserts"] += 1
            out = self._insert_prepared(
                prepared, tid, C.HNSW_UPDATE_ENTRY_GREATER, level=level
            )
            if self._log is not None:
                with self._mutate_lock:
                    self._log.record_insert(value, tid)
            return out

    def insert_bulk(self, values, tids: Optional[Sequence[int]] = None) -> int:
        """Batched device insert (dense): aminsert semantics at bulk-build
        throughput, frozen-snapshot batches over the existing graph
        (graph/device_build.bulk_insert). Works on serving-only indexes
        too (swaps the device graph). ``values``: an [n, dim] array or a
        tensor on the index's device. Returns elements added (folded
        duplicate TIDs excluded)."""
        from ..graph import device_build

        with self._update_lock.exclusive():
            if tids is None:
                base = self.num_tuples
                tids = range(base, base + len(values))
            return device_build.bulk_insert(self, values, tids)

    def add_batch(self, values, tids: Optional[Sequence[int]] = None) -> None:
        """Sequential host bulk-load (ambuild's heap-scan loop,
        build.rs:400-535)."""
        with self._update_lock.exclusive():
            self._invalidate_device()
            n = len(values)
            if tids is None:
                base = self.num_tuples
                tids = range(base, base + n)
            for value, tid in zip(values, tids):
                prepared = self.prepare_value(value)
                if prepared is None:
                    continue
                self._insert_prepared(
                    prepared, int(tid), C.HNSW_UPDATE_ENTRY_GREATER
                )

    # -- build ---------------------------------------------------------------

    @classmethod
    def build(
        cls,
        data,
        metric: str = "l2",
        params: IndexParams | None = None,
        ids: Optional[Sequence[int]] = None,
        dtype=np.float32,
        seed: int = 0,
        method: str = "auto",
        host_graph: bool = True,
        consume_input: bool = False,
        device=None,
    ) -> "HnswIndex":
        """Build an index (ambuild analog) on ``device`` (None = "cuda").

        ``data``: an [N, D] array, [N, nbits] 0/1 array for hamming /
        jaccard, a sequence of SparseVec / (indices, values), or a torch
        tensor already on ``device`` (device-resident dense input; it
        takes the device build).
        ``method``: "device" (the batched device build, dense and bit
        kinds), "native" (C++ engine), "host" (sequential reference path)
        or "auto" (the device build for dense corpora of 20,000 rows or
        more and for bit corpora of 20,000 rows or more whose unpacked f32
        build rows fit 6 GiB, else native when it builds, else host; the
        sparse kind always builds on the host).
        ``host_graph=False`` with "device" or "native": serving-only index
        whose graph goes straight to a torch DeviceGraph on ``device``.
        """
        if consume_input:
            raise NotImplementedError(
                "consume_input is not ported to torch yet "
                f"({_ROADMAP_OFF_PATH})"
            )
        tensor_in = isinstance(data, torch.Tensor)
        kind = (
            "bit" if metric in BIT_METRICS
            else "dense" if tensor_in
            else "sparse" if _is_sparse_data(data) else "dense"
        )
        n = int(data.shape[0]) if tensor_in else len(data)
        if kind == "sparse":
            dims = {v.dim if isinstance(v, SparseVec) else None for v in data}
            dims.discard(None)
            if len(dims) > 1:
                raise ValueError("different sparsevec dimensions in build input")
            dim = dims.pop() if dims else max(int(np.max(v[0])) + 1
                                              for v in data)
        else:
            dim = (int(data.shape[1]) if tensor_in
                   else np.asarray(data).shape[1])
        if tensor_in:
            if kind != "dense":
                raise ValueError(
                    "device-resident build input is supported for dense "
                    "metrics only"
                )
            if method not in ("device", "auto"):
                raise ValueError(
                    "device-resident build input requires method='device'"
                )
            method = "device"
        if method == "auto":
            if kind == "dense" and n >= 20000:
                method = "device"
            elif kind == "bit" and n >= 20000 and n * dim * 4 <= (6 << 30):
                # hamming is squared l2 over {0,1} rows (and jaccard derives
                # from it), so the bit build rides the device builder on
                # unpacked f32 rows
                method = "device"
            else:
                from .. import native

                method = "native" if native.available() else "host"
        if method == "device" and kind == "sparse":
            # the JAX package has no sparse device build either (its
            # bulk_build stacks the prepared pairs as dense rows and fails)
            raise ValueError(
                "the sparse kind builds on the host: method='native' or "
                "'host' (or 'auto'); its device_graph() then serves on the "
                "card"
            )
        if method == "native" and not host_graph and kind == "sparse":
            raise ValueError(
                "serving-only native build supports dense and bit kinds"
            )
        idx = cls(dim, metric=metric, kind=kind, params=params, dtype=dtype,
                  seed=seed, device=device)
        ids = ids if ids is not None else range(n)
        if method == "device":
            from ..graph import device_build

            device_build.bulk_build(idx, data, ids, host_graph=host_graph)
        elif method == "native":
            from .. import native

            if host_graph:
                native.native_bulk_build(idx, data, list(ids))
            else:
                native.native_bulk_build_serving(idx, np.asarray(data), ids)
        elif method == "host":
            idx.add_batch(data, ids)
        else:
            raise ValueError(f"unknown build method {method!r}")
        return idx

    # -- search --------------------------------------------------------------

    def search(self, queries, k: int, params: SearchParams | None = None,
               method: str = "auto", filter_mask=None):
        """k-NN search -> (distances [B,k], heap ids [B,k]), operator-domain
        distances (l2 = true euclidean), padded with inf / -1. ``method``:
        "host", "device" (beam), "exact", "approx" or "auto".
        ``filter_mask``: optional bool array over element ids."""
        from . import scan

        return scan.search(
            self, queries, k, params or SearchParams(), method=method,
            filter_mask=filter_mask,
        )

    def scan(self, query, params: SearchParams | None = None,
             method: str = "auto", filter_mask=None):
        """Begin a resumable scan (ambeginscan/amgettuple analog).

        method="host": the reference-semantics graph scan (HnswScan).
        method="device": the streaming exact scan (DeviceScan: exactly
        ordered, recall 1.0; dense only; no ``filter_mask``).
        method="beam": the resumable device beam scan (DeviceBeamScan:
        spilled-candidate resume, the scan.rs:538-577 analog; dense only).
        "auto" picks host when the host graph exists; on a serving-only
        index DeviceScan up to the exact cutover, DeviceBeamScan above.
        """
        from ..graph.device import EXACT_ENGINE_MAX_ROWS
        from .scan import DeviceBeamScan, DeviceScan, HnswScan

        params = params or SearchParams()
        if method == "beam":
            return DeviceBeamScan(self, query, params,
                                  filter_mask=filter_mask)
        use_device = method == "device" or (
            method == "auto" and self.serving_only
        )
        if use_device:
            if self.kind != "dense":
                raise ValueError("device scan supports dense indexes only")
            if method == "auto" and self.store.count > EXACT_ENGINE_MAX_ROWS:
                # past the exact sweep's economics the beam scan is the
                # only iterative device engine
                return DeviceBeamScan(self, query, params,
                                      filter_mask=filter_mask)
            if filter_mask is not None:
                raise ValueError(
                    "DeviceScan does not take filter_mask; filter its "
                    "exactly-ordered stream caller-side, use "
                    "search(filter_mask=...), or scan(method='beam')"
                )
            return DeviceScan(self, query, params)
        return HnswScan(self, query, params, filter_mask=filter_mask)

    # -- delete / vacuum (delegates to vacuum.py) ----------------------------

    def delete(self, tids) -> int:
        if self.serving_only:
            raise RuntimeError(
                "serving-only index (built with host_graph=False) does not "
                "support delete; rebuild with host_graph=True"
            )
        from . import vacuum

        with self._update_lock.exclusive():
            return vacuum.delete_tids(self, tids)

    def vacuum(self) -> dict:
        from . import vacuum

        with self._update_lock.exclusive():
            return vacuum.run_vacuum(self)

    # -- persistence ---------------------------------------------------------

    def save(self, path) -> None:
        """Write a checkpoint (the JAX package's format) into ``path``."""
        from . import storage

        with self._update_lock.exclusive():  # checkpoint a quiescent graph
            storage.save(self, path)

    @classmethod
    def load(cls, path, serving: bool = False, device=None) -> "HnswIndex":
        """Reload a checkpoint onto ``device`` (None: the card).
        ``serving=True`` converts a host-graph checkpoint into a
        serving-only index with vectorized numpy (see storage.load)."""
        from . import storage

        return storage.load(path, serving=serving, device=device)

    def enable_log(self, path) -> None:
        """Attach an append-only insert log (WAL analog)."""
        from . import storage

        self._log = storage.AppendLog(path, self)

    # -- device --------------------------------------------------------------

    def device_graph(self):
        """Flat-tensor device graph on ``self.device`` (built lazily,
        cached)."""
        if self._device is None:
            from ..graph.device import DeviceGraph

            self._device = DeviceGraph.from_index(self)
        return self._device

    def __repr__(self) -> str:
        return (
            f"HnswIndex(kind={self.kind}, metric={self.metric}, dim={self.dim}, "
            f"m={self.params.m}, ef_construction={self.params.ef_construction}, "
            f"elements={len(self.elements)}, tuples={self.num_tuples})"
        )



def _is_sparse_data(data) -> bool:
    if isinstance(data, np.ndarray):
        return False
    if len(data) == 0:
        return False
    first = data[0]
    return isinstance(first, SparseVec) or (
        isinstance(first, tuple) and len(first) == 2
    )
