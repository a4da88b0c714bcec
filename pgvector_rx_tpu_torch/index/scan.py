"""Index scans of the PyTorch port: batch k-NN search.

The host half is the port's own copy of ``pgvector_rx_tpu/index/scan.py``
(parity source: reference ``src/index/scan.rs``):
- :func:`get_scan_items` <-> scan.rs:458-530 (Algorithm 5: greedy descent
  ef=1 through upper layers, then ground search with ef_search)
- :func:`resume_scan_items` <-> scan.rs:538-577 (re-enter ground layer
  with up to ef_search discarded candidates, shared visited set)
- :class:`HnswScan` <-> HnswScanState + amgettuple (scan.rs:584-875).

:func:`search` routes batches to the torch device engines
(``graph/device.py``) or walks :class:`HnswScan` per query.
"""

from __future__ import annotations

import heapq
from typing import Optional

import numpy as np
import torch

from ..config import SearchParams
from ..constants import (
    HNSW_ITERATIVE_SCAN_OFF,
    HNSW_ITERATIVE_SCAN_STRICT,
)
from ..graph import host
from ..utils.stats import ScanStats


def get_scan_items(
    index,
    query,
    ef_search: int,
    visited: Optional[set] = None,
    discarded: Optional[list] = None,
    dist_many=None,
):
    """Algorithm 5. Returns candidates sorted nearest first."""
    if index.entry is None:
        return []
    entry_idx = index.entry
    if index.elements[entry_idx].deleted:
        return []
    dist_many = dist_many or index._dist_many

    ep = [(float(dist_many(query, [entry_idx])[0]), entry_idx)]
    ep_level = index.elements[entry_idx].level

    for lc in range(ep_level, 0, -1):
        w = host.search_layer(index.elements, ep, 1, lc, query, dist_many)
        if not w:
            return []
        ep = [w[0]]

    return host.search_layer(
        index.elements,
        ep,
        ef_search,
        0,
        query,
        dist_many,
        visited=visited,
        discarded=discarded,
    )


def resume_scan_items(
    index, query, ef_search: int, visited: set, discarded: list,
    dist_many=None,
):
    """Re-enter the ground layer from discarded candidates.

    Parity: scan.rs:538-577 — batch of up to ef_search entry points,
    entries NOT re-added to visited (already there).
    """
    if not discarded:
        return []
    ep = []
    for _ in range(ef_search):
        if not discarded:
            break
        ep.append(heapq.heappop(discarded))
    return host.search_layer(
        index.elements,
        ep,
        ef_search,
        0,
        query,
        dist_many or index._dist_many,
        visited=visited,
        discarded=discarded,
        add_entry_to_visited=False,
    )


class HnswScan:
    """A resumable scan over one query (amgettuple analog).

    Yields (heap_tid, operator_distance) pairs via :meth:`next` (l2
    order distances are converted from squared form at emission, so
    every scan engine emits the same distance domain), or None when
    exhausted. The visited set and discarded heap persist across
    resume re-entries — the reference's checkpoint/resume object
    (SURVEY.md §5 "Checkpoint / resume").
    """

    def __init__(self, index, query, params: SearchParams, filter_mask=None):
        self.index = index
        self.params = params
        # optional element-id filter (attribute-filtering analog,
        # tests/t/043,044): masked elements still count toward
        # max_scan_tuples — the reference's AM emits them and the
        # executor discards them, so the tuple budget is AM-side
        self.filter_mask = (
            None if filter_mask is None else np.asarray(filter_mask, bool)
        )
        self.query = index.prepare_value(query)
        if self.query is None and index.kind in ("dense", "sparse"):
            # cosine zero-norm query: reference normalize leaves zeros;
            # distances become 1 - 0 = 1 for all rows. Keep zeros.
            if index.kind == "dense":
                self.query = np.zeros(index.dim, dtype=np.float32)
            else:
                self.query = (
                    np.zeros(0, dtype=np.int32),
                    np.zeros(0, dtype=np.float32),
                )
        self.first = True
        self.results: list = []  # nearest LAST (pop from end)
        self.visited: set = set()
        self.discarded: list = []  # heapq min-heap
        self.tuples = 0
        self.previous_distance = -np.inf
        self._current: Optional[tuple] = None  # (distance, [remaining tids])
        # Elements already emitted. The reference can re-emit an element
        # across resume batches (evicted candidates are pushed to the
        # discarded heap both at eviction and again as leftover
        # candidates, scan.rs:420-437); we dedupe — a strict improvement
        # that keeps iterative scans exactly-once.
        self._emitted: set = set()
        # EXPLAIN ANALYZE analog (scan.rs:718-729, SURVEY §5): distances
        # computed, nodes visited, tuples out, resume re-entries
        self.scan_stats = ScanStats()
        _dm = index._dist_many

        def _counting_dist(q, ids):
            self.scan_stats.distances_computed += len(ids)
            return _dm(q, ids)

        self._dist_many = _counting_dist
        self.iterative = params.iterative_scan != HNSW_ITERATIVE_SCAN_OFF
        # iterative-scan memory budget (scan_mem_multiplier * work_mem):
        # estimated bytes of persistent scan state; checked before each
        # resume (see SearchParams docstring)
        self._mem_budget = params.scan_mem_multiplier * params.work_mem_bytes
        index.stats["scans"] += 1

    def _state_bytes(self) -> float:
        # CPython set entry ~60B, heap tuple entry ~80B — coarse but
        # monotone, which is all the cap needs
        return 60.0 * len(self.visited) + 80.0 * len(self.discarded)

    def _run_first(self) -> None:
        ef = self.params.ef_search
        if self.iterative:
            items = get_scan_items(
                self.index, self.query, ef, self.visited, self.discarded,
                dist_many=self._dist_many,
            )
        else:
            items = get_scan_items(
                self.index, self.query, ef, self.visited,
                dist_many=self._dist_many,
            )
        self.scan_stats.nodes_visited = len(self.visited)
        # store nearest last
        self.results = list(reversed(items))
        self.first = False

    def next(self) -> Optional[tuple]:
        """Next (heap_tid, operator_distance) or None."""
        if self.first:
            self._run_first()

        sqrt_out = self.index.metric == "l2"
        strict = self.params.iterative_scan == HNSW_ITERATIVE_SCAN_STRICT
        while True:
            if self._current is not None:
                dist, tids = self._current
                if tids:
                    tid = tids.pop()
                    if strict:
                        if dist < self.previous_distance:
                            continue
                        self.previous_distance = dist
                    self.scan_stats.tuples_returned += 1
                    if sqrt_out:
                        return tid, float(np.sqrt(max(dist, 0.0)))
                    return tid, dist
                self._current = None

            if not self.results:
                if not self.iterative:
                    return None
                if (
                    self.tuples >= self.params.max_scan_tuples
                    or self._state_bytes() > self._mem_budget
                ):
                    # Tuple or memory budget exhausted: drain discarded
                    # one at a time (scan.rs:828-841)
                    if not self.discarded:
                        return None
                    self.results.append(heapq.heappop(self.discarded))
                else:
                    self.index.stats["resumes"] += 1
                    self.scan_stats.resumes += 1
                    items = resume_scan_items(
                        self.index,
                        self.query,
                        self.params.ef_search,
                        self.visited,
                        self.discarded,
                        dist_many=self._dist_many,
                    )
                    self.scan_stats.nodes_visited = len(self.visited)
                    self.results = list(reversed(items))
                if not self.results:
                    return None

            dist, idx = self.results.pop()
            if idx in self._emitted:
                continue
            self._emitted.add(idx)
            tids = self.index.heap_tids[idx]
            if not tids:
                continue
            self.tuples += 1
            if self.filter_mask is not None and not (
                idx < len(self.filter_mask) and self.filter_mask[idx]
            ):
                continue  # executor-filtered tuple (budget already spent)
            # copy (reversed so .pop() yields slot order like the
            # reference's pop-from-end of the loaded array)
            self._current = (dist, list(reversed(tids)))

    def take(self, k: int) -> list[tuple]:
        out = []
        while len(out) < k:
            item = self.next()
            if item is None:
                break
            out.append(item)
        return out


def search(index, queries, k: int, params: SearchParams, method: str = "auto",
           filter_mask=None):
    """Batch k-NN. Returns (distances [B,k] operator-domain, ids [B,k]).

    method="host" walks the reference scan path per query;
    method="device" runs the batched beam over the device graph;
    "exact" / "approx" the exact FP32 / binned bf16 sweeps (dense only);
    "auto" uses the device for dense batches >= 32 queries or serving-only
    indexes, and lets the device layer choose exact vs beam.

    ``filter_mask``: optional bool array over element ids. Device
    exact/approx engines pre-filter inside the sweep; the host path
    filters at emission under the iterative-scan budget.
    """
    if isinstance(queries, torch.Tensor):
        # staged query batch: passed through untouched
        single = queries.ndim == 1
        qlist = queries[None] if single else queries
    else:
        single = _is_single_query(index, queries)
        qlist = [queries] if single else list(queries)

    engine = {
        "device": "beam",
        "exact": "exact",
        "approx": "approx",
        "auto": "auto",
    }.get(method)
    use_device = method in ("device", "exact", "approx") or (
        method == "auto"
        and (
            (index.kind == "dense" and (len(qlist) >= 32 or index.serving_only))
            or (index.kind != "dense" and index.serving_only)
        )
    )
    if use_device:
        from ..graph import device as device_mod

        dists, ids = device_mod.search(
            index, qlist, k, params, engine=engine, filter_mask=filter_mask
        )
        # order-distance -> operator-distance (l2: sqrt; others same)
        if index.metric == "l2":
            dists = np.where(
                np.isfinite(dists), np.sqrt(np.maximum(dists, 0.0)), dists
            )
    else:
        if isinstance(queries, torch.Tensor):
            qlist = list(qlist.cpu().numpy())
        B = len(qlist)
        dists = np.full((B, k), np.inf, dtype=np.float64)
        ids = np.full((B, k), -1, dtype=np.int64)
        agg = ScanStats()
        for b, q in enumerate(qlist):
            scan = HnswScan(index, q, params, filter_mask=filter_mask)
            # HnswScan already emits operator-domain distances
            for j, (tid, d) in enumerate(scan.take(k)):
                dists[b, j] = d
                ids[b, j] = tid
            agg.merge(scan.scan_stats)
        index.last_scan_stats = agg
    if single:
        return dists[0], ids[0]
    return dists, ids


def _is_single_query(index, queries) -> bool:
    if index.kind == "sparse":
        from ..types.sparsevec import SparseVec

        return isinstance(queries, (SparseVec, tuple))
    arr = np.asarray(queries)
    return arr.ndim == 1
