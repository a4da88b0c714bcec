"""Index scans of the PyTorch port: batch k-NN search.

The host half is the port's own copy of ``pgvector_rx_tpu/index/scan.py``
(parity source: reference ``src/index/scan.rs``):
- :func:`get_scan_items` <-> scan.rs:458-530 (Algorithm 5: greedy descent
  ef=1 through upper layers, then ground search with ef_search)
- :func:`resume_scan_items` <-> scan.rs:538-577 (re-enter ground layer
  with up to ef_search discarded candidates, shared visited set)
- :class:`HnswScan` <-> HnswScanState + amgettuple (scan.rs:584-875).

The device scans are the torch counterparts of the JAX package's:
- :class:`DeviceScan`: geometrically growing exact blocks through the
  exact engine (kernel K1 on the card), exactly ordered;
- :class:`DeviceBeamScan`: the resumable beam scan, one walk per segment
  under an exclusion mask with a spill buffer (kernel K5 on the card).

:func:`search` routes batches to the torch device engines
(``graph/device.py``) or walks :class:`HnswScan` per query.
"""

from __future__ import annotations

import heapq
import os
from typing import Optional

import numpy as np
import torch

from ..config import SearchParams
from ..constants import (
    HNSW_ITERATIVE_SCAN_OFF,
    HNSW_ITERATIVE_SCAN_STRICT,
)
from ..graph import host
from ..ops import beam
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


class DeviceScan:
    """Iterative scan that streams results in exactly ordered, geometrically
    growing exact top-k blocks.

    The structural analog of the reference's resumable iterative scan
    (visited set + discarded heap re-entering the graph, scan.rs:538-577)
    re-designed for a brute-force sweep: each resume re-runs the exact
    sweep at 4x the previous k and emits the new tail. Results arrive in
    true distance order, so strict_order and relaxed_order coincide and
    the filtered-recall contracts (tests/t/043,044) hold at recall 1.0;
    max_scan_tuples caps the stream exactly like the reference.

    For corpora past the exact sweep's economics, DeviceBeamScan is the
    iterative device engine.
    """

    def __init__(self, index, query, params: SearchParams):
        self.index = index
        self.params = params
        self.query = query
        self._block = max(params.ef_search, 16)
        self._emitted = 0  # tuples emitted
        self._buf: list = []  # the block's pending (tid, dist), nearest first
        self._head = 0  # the next of them
        self._buf_pos = 0
        self._exhausted = False
        self.scan_stats = ScanStats()
        index.stats["scans"] += 1

    def _fetch(self) -> None:
        # the tuple count as one reduction over the device graph's TID
        # counts (built from the same lists), not a host sum over every
        # element's TID list (~40 ms at 1M rows)
        total = max(int(self.index.device_graph().tid_count.sum()), 1)
        # each exact block re-sweeps every stored row
        self.scan_stats.distances_computed += self.index.store.count
        k = min(self._block, total)
        q = self.query
        q = (q.float().reshape(1, -1) if isinstance(q, torch.Tensor)
             else np.atleast_2d(np.asarray(q, dtype=np.float32)))
        dists, ids = self.index.search(q, k, self.params, method="exact")
        keep = (ids[0] >= 0) & np.isfinite(dists[0])
        pairs = list(zip(ids[0][keep].tolist(), dists[0][keep].tolist()))
        self._buf, self._head = pairs[self._buf_pos :], 0
        self._buf_pos += len(self._buf)
        if k >= total:  # the sweep covered everything there is
            self._exhausted = True
        self._block *= 4

    def _pending(self) -> int:
        """Tuples the stream may still hand out now, fetching the next
        block when the current one is spent (0: the stream is done)."""
        if self._emitted >= self.params.max_scan_tuples:
            return 0
        while self._head >= len(self._buf):
            if self._exhausted:
                return 0
            if self._buf_pos > 0:  # re-entries only (first block isn't one)
                self.scan_stats.resumes += 1
            self.index.stats["resumes"] += 1
            self._fetch()
        return min(len(self._buf) - self._head,
                   self.params.max_scan_tuples - self._emitted)

    def next(self):
        """Next (heap_tid, operator_distance) or None."""
        out = self.take(1)
        return out[0] if out else None

    def take(self, k: int) -> list[tuple]:
        """The next ``k`` tuples (fewer at the stream's end), taken from
        the pending block in bulk."""
        out = []
        while len(out) < k:
            n = min(k - len(out), self._pending())
            if n == 0:
                break
            out.extend(self._buf[self._head : self._head + n])
            self._head += n
            self._emitted += n
            self.scan_stats.tuples_returned += n
        return out


class DeviceBeamScan:
    """Resumable device beam scan: the iterative scan for corpora past the
    exact sweep's economics (> 4M rows, where beam is the only engine).

    Structural port of the reference's spilled-candidate resume
    (scan.rs:538-577) to the device beam: each segment runs the beam walk
    (graph/device._beam_scan_segment) which CAPTURES its evicted
    candidates (the discarded-heap analog) in a spill buffer; emitted
    elements go into a device exclusion mask (the shared visited set's
    role), updated in place; the next segment re-enters the ground layer
    seeded by the spill. Per-resume traffic is O(ef) ids/distances, never
    a corpus re-sweep.

    Ordering: segments are internally sorted; across segments order can
    regress exactly like the reference's relaxed_order; strict_order
    suppresses out-of-order emissions (scan.rs:801-806).

    Windowed strict order (default on; ``PGV_STRICT_BUFFER=0`` restores
    the reference's drop-on-regression semantics): under strict_order,
    emissions are held in a sorted buffer and the global minimum is
    released only once the buffer holds more than L segments' worth of
    results (L = PGV_STRICT_BUFFER, default 4), a sliding reorder window.
    The order regressions are later segments discovering items below
    what was emitted while exploring the spill; they are overwhelmingly
    near-term, so an L-segment window reorders them instead of dropping
    them. The emitted stream stays nondecreasing; regressions deeper than
    L segments are still dropped. The first result waits ~L+1 segments.

    The internal beam is ``PGV_BEAM_SCAN_WIDTH_MULT`` (default 4) times
    ef wide, the device analog of Algorithm 2's unbounded to-expand heap.

    ``filter_mask`` (element-id bool mask): masked elements consume tuple
    budget and are dropped at emission, the reference's executor-filter
    semantics (tests/t/043,044).
    """

    def __init__(self, index, query, params: SearchParams, filter_mask=None):
        from ..graph import device as dm

        if index.kind != "dense":
            raise ValueError("DeviceBeamScan supports dense indexes only")
        self.index = index
        self.params = params
        self.filter_mask = (
            None if filter_mask is None else np.asarray(filter_mask, bool)
        )
        self._dm = dm
        self.g = index.device_graph()
        q = query.reshape(1, -1) if isinstance(query, torch.Tensor) else (
            np.atleast_2d(np.asarray(query, dtype=np.float32)))
        self.q = dm.prepare_queries(index, q, self.g.device)[0]
        ef = max(params.ef_search, 1)
        self._ef = ef
        # internal beam wider than the emitted ef: keeps boundary
        # candidates explorable within the segment so later segments
        # rarely discover nearer items than ones already emitted
        self._width = max(
            ef * int(os.environ.get("PGV_BEAM_SCAN_WIDTH_MULT", 4)), ef
        )
        self._spill_w = max(2 * ef, 64) + (self._width - ef)
        self._max_steps = 4 * self._width + 32
        self._expand = dm._beam_expand()
        self._excluded = torch.zeros(self.g.traversable.shape[0],
                                     dtype=torch.bool, device=self.g.device)
        # the kernel's staged bitmap of the rows the scan may walk, where
        # K5's rule stages one (the card; the exclusion mask stays the truth)
        self._allowed = beam.staged_bitmap(
            self.g.values, self.g.neighbors0, self.g.traversable,
            self._excluded[None], self._spill_w, self._width, ef,
            self._spill_w, self._expand, dm._rank_is_approx(self.g))
        # first-segment seeds, padded to the spill width
        if self.g.entry < 0:
            self._seeds = None
            self._exhausted = True
        else:
            upper = dm._coarse_upper(self.g)
            if upper is not None:
                s_ids, s_d = dm._coarse_seed_one(
                    self.g, self.q, upper[0], upper[1], n_seeds=min(8, ef)
                )
            else:
                s_ids, s_d = dm._descent_seed_one(
                    self.g, self.q, self.g.entry_level
                )
            pad = self._spill_w - s_ids.shape[0]
            self._seeds = (
                torch.nn.functional.pad(s_ids.to(torch.int32), (0, pad),
                                        value=-1),
                torch.nn.functional.pad(s_d.float(), (0, pad),
                                        value=float("inf")),
            )
            self._exhausted = False
        self._buf: list = []  # pending (dist, element id), nearest first
        self._current: Optional[tuple] = None  # (dist, [remaining tids])
        self._spill_host: Optional[list] = None  # drain-mode buffer
        # strict-order holdback heap of (dist, id): the sliding window
        self._hold: list = []
        self._strict_window = max(
            int(os.environ.get("PGV_STRICT_BUFFER", "4")), 0
        )
        self._pending = None  # launched-but-unread segment
        self._first = True
        self.tuples = 0
        self.previous_distance = -np.inf
        self.scan_stats = ScanStats()
        index.stats["scans"] += 1

    def _segment_dispatch(self) -> None:
        """Launch one beam segment without reading its results back (CUDA
        launches are asynchronous): the scan state (seeds, exclusion mask)
        advances at once as device tensors."""
        # everything in the returned beam will be emitted: the segment
        # excludes it from future segments (on the device)
        report, sp_d, sp_ids = self._dm._beam_scan_step(
            self.g, self.q, self._seeds[0], self._seeds[1], self._excluded,
            self._allowed, self._ef, self._spill_w, self._max_steps,
            self._width, self._expand,
        )
        self._seeds = (sp_ids, sp_d)
        self._pending = report

    def prefetch(self) -> None:
        """Launch the next segment if one would be needed, without waiting
        for its results."""
        if (
            self._pending is None
            and not self._exhausted
            and not self._buf
            and self._seeds is not None
        ):
            self._first = False
            self._segment_dispatch()

    def _segment(self) -> None:
        """Run one beam segment; refill the host buffer."""
        if self._pending is None:
            self._segment_dispatch()
        report = self._pending.cpu().numpy()  # the segment's one copy
        self._pending = None
        ef = self._ef
        d_host = report[:ef].view(np.float32).astype(np.float64)
        i_host = report[ef : 2 * ef].astype(np.int64)
        n_steps = int(report[2 * ef])
        self.scan_stats.beam_steps += n_steps
        self.scan_stats.distances_computed += (
            n_steps * self._expand * self.g.neighbors0.shape[1]
        )
        keep = (i_host >= 0) & np.isfinite(d_host)
        self._buf = list(zip(d_host[keep], i_host[keep]))
        if not self._buf and report[2 * ef + 2] == 0:
            # the segment found nothing new and the spill, the only fuel
            # left, is empty: the scan is exhausted
            self._exhausted = True

    def _drain_one(self) -> None:
        """Budget exhausted: emit spilled candidates one at a time without
        further graph work (scan.rs:828-841 analog)."""
        if self._spill_host is None:
            sp_ids = self._seeds[0].cpu().numpy()
            sp_d = self._seeds[1].cpu().numpy().astype(np.float64)
            keep = (sp_ids >= 0) & np.isfinite(sp_d)
            self._spill_host = list(zip(sp_d[keep], sp_ids[keep]))
        if self._spill_host:
            self._buf = [self._spill_host.pop(0)]
        else:
            self._exhausted = True

    def next(self) -> Optional[tuple]:
        """Next (heap_tid, operator_distance) or None."""
        sqrt_out = self.index.metric == "l2"
        strict = self.params.iterative_scan == HNSW_ITERATIVE_SCAN_STRICT
        iterative = self.params.iterative_scan != HNSW_ITERATIVE_SCAN_OFF
        buffered = strict and self._strict_window > 0
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

            if buffered and self._buf:
                for d_, i_ in self._buf:
                    heapq.heappush(self._hold, (float(d_), int(i_)))
                self._buf = []

            ready = None
            if buffered:
                # sliding reorder window: emit the global minimum only once
                # the hold exceeds L segments' worth of results (0 in drain
                # mode: a sorted merge with the spill). A launched but
                # unread segment is read first: its arrivals belong in the
                # comparison.
                cap = (
                    0
                    if self._spill_host is not None
                    else self._strict_window * self._ef
                )
                if self._hold and self._pending is None and (
                    self._exhausted or len(self._hold) > cap
                ):
                    ready = heapq.heappop(self._hold)
            elif self._buf:
                ready = self._buf.pop(0)

            if ready is None:
                if self._exhausted:
                    if buffered and self._hold:  # exhaustion flush
                        ready = heapq.heappop(self._hold)
                    else:
                        return None
                elif self._pending is not None:
                    self._segment()  # read a prefetched segment
                    continue
                elif self._first and self._seeds is not None:
                    self._first = False
                    self._segment()  # first segment
                    continue
                elif not iterative:
                    if buffered and self._hold:
                        # no further graph work will come: flush in order
                        ready = heapq.heappop(self._hold)
                    else:
                        return None
                elif self.tuples >= self.params.max_scan_tuples:
                    self._drain_one()
                    continue
                else:
                    self.index.stats["resumes"] += 1
                    self.scan_stats.resumes += 1
                    self._segment()
                    continue

            dist, idx = ready
            idx = int(idx)
            tids = self.index.heap_tids[idx]
            if not tids:
                continue
            self.tuples += 1
            if self.filter_mask is not None and not (
                idx < len(self.filter_mask) and self.filter_mask[idx]
            ):
                continue  # executor-filtered tuple (budget already spent)
            self._current = (float(dist), list(reversed(tids)))

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
    "exact" / "approx" the exact FP32 / binned bf16 sweeps (the bit kind:
    the bit sweep K9 for both, over packed query words);
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
