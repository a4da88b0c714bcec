"""Sharded HNSW of the PyTorch port: node-partitioned sub-graphs, one per
device, in one process.

The port of ``pgvector_rx_tpu/parallel/sharded.py``. Vectors are
partitioned round-robin across shards; each shard owns an independent
HNSW sub-graph built over its partition, on its own torch device. A query
searches every shard's sub-graph (each shard's kernels launch on its own
device, asynchronously; that shards on separate cards then run
concurrently is unverified until a four-card run measures it), then each
shard's top-ef (or top-k) is copied to the first device and one
stable sort there merges them: the JAX package's one ``all_gather`` and
local merge, with no cross-shard traffic during graph traversal.

Where the JAX class runs one program over a mesh (``shard_map``), this one
is a single process over a list of devices, so every method keeps its
meaning: ``insert`` routes and ``insert_bulk`` water-fills in the caller's
process, and ``ShardedScan`` merges the shard streams there. Each shard
walks its own graph, unpadded: there is no stacking of the shards into
common-capacity arrays. A device may repeat in the list (four shards on one
card), which a JAX mesh does not allow.

Mutations: inserts route to the smallest shard (water-filled for bulk);
deletes broadcast (each shard drops its own TIDs). Each shard reuses the
single-index build, insert, delete and checkpoint machinery, and a sharded
checkpoint is the JAX package's (``shard_{i:05d}/`` + ``sharded.json``).
"""

from __future__ import annotations

import heapq
import json
import os
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import SearchParams
from ..graph import device as device_mod
from ..graph.device_build import _resolve_device
from ..index.hnsw import HnswIndex
from ..ops.distances import normalize_rows
from ..utils.stats import ScanStats

_INF = float("inf")


def _shard_devices(devices, n_shards: int) -> list:
    """One torch device per shard: ``devices`` as given (its length must be
    ``n_shards``) or, for None, the visible cards in turn
    (``visible[s % len(visible)]``), raising where no CUDA device is
    visible, as ``index/hnsw.resolve_device(None)`` does."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the port runs on the card by "
                "default; pass devices=[...] (e.g. ['cpu'] * n_shards) to "
                "run on the CPU"
            )
        visible = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        return [visible[s % len(visible)] for s in range(n_shards)]
    devices = [_resolve_device(d) for d in devices]
    if len(devices) != n_shards:
        raise ValueError(f"{len(devices)} devices but {n_shards} shards")
    return devices


def _water_fill(sizes, n: int):
    """Rows of an n-row batch per shard so the shards' tuple counts level
    (the JAX package's rule, step for step): the water level T with
    sum(max(0, T - size)) = n, then the remainder of the flooring taken
    back from the largest shards first."""
    sizes = np.asarray(sizes, dtype=np.int64)
    lo, hi = int(sizes.min()), int(sizes.max() + n)
    while lo < hi:
        mid = (lo + hi) // 2
        if np.maximum(0, mid - sizes).sum() < n:
            lo = mid + 1
        else:
            hi = mid
    alloc = np.minimum(np.maximum(0, lo - sizes), n)
    extra = int(alloc.sum() - n)
    for s in np.argsort(-sizes):
        if extra <= 0:
            break
        take = min(extra, int(alloc[s]))
        alloc[s] -= take
        extra -= take
    return alloc


def _tid_ok(tids, fmask):
    """Heap tids kept by a filter mask indexed by global heap tid; tids
    outside the mask's range are excluded."""
    n = fmask.shape[0]
    if n == 0:
        return torch.zeros_like(tids, dtype=torch.bool)
    inb = (tids >= 0) & (tids < n)
    return inb & fmask[tids.clamp(0, n - 1).long()]


def _shard_topk(g, q, k: int, ef: int, engine: str, fmask):
    """One shard's candidates for queries ``q`` [B, D] on the shard's
    device -> (order distances, heap tids int64), (inf, -1) padded, nearest
    first: the exact top-k (``_exact_search_batch``: K1 or the l1 sweep,
    pre-filtered by ``fmask`` through each row's tid; the winners rescored
    in f32 by ``_rescore_true``) or the beam's top-ef
    (``beam_search_arrays``: K4, post-filtered)."""
    B = q.shape[0]
    if g.entry < 0:  # an empty shard
        w = k if engine == "exact" else ef
        return (torch.full((B, w), _INF, device=q.device),
                torch.full((B, w), -1, dtype=torch.int64, device=q.device))
    if engine == "exact":
        row_mask = None if fmask is None else _tid_ok(g.emit_tid, fmask)
        d, ids = device_mod._exact_search_batch(g, q, k, row_mask=row_mask)
        # the k winners' distances from direct differences: the sweep's
        # a - 2 q.x + |q|^2 cancels to ~1e-6 at a self-match, where the
        # JAX package's q2 + x2 - 2 q.x (one expression) reads 0
        d, ids = device_mod._rescore_true(g, q, d, ids)
    else:
        d, ids = device_mod.beam_search_arrays(
            g.values, g.neighbors0, g.upper_neighbors, g.upper_slot,
            g.traversable, g.entry, g.entry_level, q, metric=g.metric,
            ef=ef, m=g.m, max_steps=4 * ef + 32)
    tids = torch.where(ids >= 0, g.emit_tid[ids.clamp(min=0).long()].long(),
                       -1)
    if fmask is not None and engine != "exact":
        tids = torch.where(_tid_ok(tids, fmask), tids, -1)
    return torch.where(tids >= 0, d, _INF), tids


def _merge(parts, k: int, device):
    """The shards' (distances [B, w], tids [B, w]) copied to ``device``,
    concatenated shard-major and stably sorted by distance alone (the JAX
    package's ``lax.sort(num_keys=1)`` after its ``all_gather``): the
    first k."""
    d = torch.cat([p[0].to(device) for p in parts], dim=1)
    t = torch.cat([p[1].to(device) for p in parts], dim=1)
    d, order = torch.sort(d, dim=1, stable=True)
    return d[:, :k], torch.gather(t, 1, order[:, :k])


class ShardedHnswIndex:
    """A dense-metric HNSW index sharded across a list of torch devices
    (one per shard; None: the visible cards in turn)."""

    def __init__(self, shards: Sequence[HnswIndex], devices=None):
        if not shards:
            raise ValueError("need at least one shard")
        self.shards = list(shards)
        self.metric = self.shards[0].metric
        self.dim = self.shards[0].dim
        self.params = self.shards[0].params
        self.devices = _shard_devices(devices, len(self.shards))
        for s, (shard, dev) in enumerate(zip(self.shards, self.devices)):
            if _resolve_device(shard.device) != dev:
                raise ValueError(
                    f"shard {s} is on {shard.device}, its listed device is "
                    f"{dev}: build or load it there"
                )

    # -- construction --------------------------------------------------------

    @classmethod
    def build(
        cls,
        data,
        n_shards: int,
        metric: str = "l2",
        params=None,
        ids: Optional[Sequence[int]] = None,
        devices=None,
        method: str = "auto",
        seed: int = 0,
        host_graph: bool = True,
        dtype=None,
        checkpoint_dir=None,
    ) -> "ShardedHnswIndex":
        """Round-robin partition + per-shard build, shard ``s`` built by
        ``HnswIndex.build(..., seed=seed + s, device=devices[s])``.

        ``checkpoint_dir``: each completed shard is saved to
        ``{dir}/shard_{i:05d}`` the moment it finishes, and a rerun of the
        same build resumes by loading completed shards instead of
        rebuilding them.

        ``host_graph=False`` builds serving-only shards. ``dtype``: the
        stores' dtype (None: f32). ``data`` may be:

        - a host numpy array: shards slice it with strided views
          (``data[s::n_shards]``, zero copy);
        - a ``torch.Tensor``: each shard's strided slice is taken where the
          tensor lives and moved to the shard's device, never through host
          numpy (the device build);
        - a callable ``(shard, n_shards) -> rows``: each shard's partition
          is produced right before that shard builds and freed after, so
          no process holds the full corpus.

        ``ids`` may likewise be a callable ``(shard, n_shards) -> tids``
        when ``data`` is callable; otherwise callable-input shards default
        to sequential TID blocks in shard order.
        """
        devices = _shard_devices(devices, n_shards)
        dtype = np.float32 if dtype is None else dtype
        streamed = callable(data)
        if not streamed:
            n = int(data.shape[0]) if hasattr(data, "shape") else len(data)
            if ids is not None and not callable(ids):
                ids = np.asarray(ids)
        ckpt = None
        if checkpoint_dir is not None:
            ckpt = Path(checkpoint_dir)
            ckpt.mkdir(parents=True, exist_ok=True)
        shards = []
        offset = 0  # sequential TID blocks for streamed input
        for s in range(n_shards):
            dev = devices[s]
            done = None if ckpt is None else ckpt / f"shard_{s:05d}"
            if done is not None and (done / "meta.json").exists():
                t0 = time.time()
                shards.append(HnswIndex.load(done, device=dev))
                print(
                    f"[sharded.build] shard {s}/{n_shards}: resumed from "
                    f"checkpoint ({time.time() - t0:.1f}s, "
                    f"{shards[-1].num_tuples} tuples)",
                    file=sys.stderr, flush=True,
                )
                if streamed and ids is None:
                    # sequential TID blocks can't be reconstructed for a
                    # skipped partition (duplicate folding caps TID lists,
                    # so num_tuples is not the partition size)
                    raise ValueError(
                        "checkpoint resume with streamed data needs "
                        "callable ids (sequential TID blocks cannot span a "
                        "skipped shard)"
                    )
                continue
            if streamed:
                part = data(s, n_shards)
                if callable(ids):
                    part_ids = np.asarray(ids(s, n_shards))
                elif ids is not None:
                    part_ids = ids[s::n_shards]
                else:
                    cnt = len(part)
                    part_ids = np.arange(offset, offset + cnt)
                    offset += cnt
            else:
                part = data[s::n_shards]
                part_ids = (ids[s::n_shards] if ids is not None
                            else np.arange(s, n, n_shards))
            if isinstance(part, torch.Tensor):
                part = part.to(dev)  # no copy where it already lives there
            t0 = time.time()
            shards.append(HnswIndex.build(
                part, metric=metric, params=params, ids=part_ids,
                method=method, seed=seed + s, host_graph=host_graph,
                dtype=dtype, device=dev,
            ))
            del part  # streamed partitions free before the next shard
            dt = time.time() - t0
            print(
                f"[sharded.build] shard {s}/{n_shards}: built "
                f"{shards[-1].num_tuples} tuples in {dt:.1f}s "
                f"({shards[-1].num_tuples / max(dt, 1e-9):.0f}/s)",
                file=sys.stderr, flush=True,
            )
            if done is not None:
                shards[-1].save(done)
        if ckpt is not None:
            _write_manifest(ckpt, n_shards)
        return cls(shards, devices=devices)

    def insert(self, value, tid: Optional[int] = None):
        """Route to the shard with the fewest tuples."""
        target = min(range(len(self.shards)),
                     key=lambda s: self.shards[s].num_tuples)
        return self.shards[target].insert(value, tid)

    def insert_bulk(self, values, tids=None) -> int:
        """Batched insert across shards: water-fill the batch so the
        shards' tuple counts level (``_water_fill``), then each shard's
        batched device insert (``HnswIndex.insert_bulk``) of its
        consecutive block. Dense only. ``values``: an [n, dim] array, or a
        tensor (each block moved to its shard's device). Returns elements
        added across shards (folded duplicate TIDs excluded)."""
        if not isinstance(values, torch.Tensor):
            values = np.asarray(values, dtype=np.float32)
        n = len(values)
        if n == 0:
            return 0
        if tids is None:
            base = self.num_tuples
            tids = range(base, base + n)
        tids = np.fromiter((int(t) for t in tids), dtype=np.int64, count=n)
        alloc = _water_fill([s.num_tuples for s in self.shards], n)
        added = 0
        pos = 0
        for s, cnt in enumerate(alloc):
            cnt = int(cnt)
            if cnt == 0:
                continue
            block = values[pos : pos + cnt]
            if isinstance(block, torch.Tensor):
                block = block.to(self.devices[s])
            added += self.shards[s].insert_bulk(
                block, tids=tids[pos : pos + cnt].tolist())
            pos += cnt
        return added

    def delete(self, tids) -> int:
        return sum(s.delete(tids) for s in self.shards)

    # -- persistence ---------------------------------------------------------

    def save(self, path) -> None:
        """Checkpoint: one single-index checkpoint per shard
        (``shard_{i:05d}``) + the ``sharded.json`` manifest, the JAX
        package's layout."""
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        for i, s in enumerate(self.shards):
            s.save(path / f"shard_{i:05d}")
        _write_manifest(path, len(self.shards))

    @classmethod
    def load(cls, path, devices=None) -> "ShardedHnswIndex":
        """Reload a sharded checkpoint (this package's or the JAX
        package's), shard ``i`` onto ``devices[i]``."""
        path = Path(path)
        meta = json.loads((path / "sharded.json").read_text())
        n_shards = int(meta["n_shards"])
        devices = _shard_devices(devices, n_shards)
        shards = [HnswIndex.load(path / f"shard_{i:05d}", device=devices[i])
                  for i in range(n_shards)]
        return cls(shards, devices=devices)

    @property
    def num_tuples(self) -> int:
        return sum(s.num_tuples for s in self.shards)

    # -- iterative scan -------------------------------------------------------

    def scan(self, query, params: SearchParams | None = None):
        """Sharded resumable scan: each shard's own exactly-ordered stream
        (DeviceScan when serving-only, HnswScan otherwise) merged by a
        k-way heap into one globally ordered stream; ``max_scan_tuples``
        caps the merged stream."""
        return ShardedScan(self, query, params or SearchParams())

    # -- search --------------------------------------------------------------

    def search(self, queries, k: int, params: SearchParams | None = None,
               engine: str = "auto", filter_mask=None):
        """Per-shard local search, then the merge on the first device.

        ``engine``: "exact" sweeps each shard's live rows (recall 1.0),
        "beam" walks each shard's sub-graph, "auto" picks exact while the
        largest shard's capacity (the JAX graph's padded figure) is within
        ``EXACT_ENGINE_MAX_ROWS``.

        ``filter_mask``: optional bool array indexed by GLOBAL heap tid;
        tids past its end are excluded. The exact engine pre-filters inside
        each shard's sweep; the beam post-filters its ef-wide result.

        Returns (operator distances [B, k] f64, heap ids [B, k] int64),
        1-D for one 1-D query."""
        params = params or SearchParams()
        if engine not in ("auto", "exact", "beam"):
            raise ValueError(f"unknown engine {engine!r}")
        if isinstance(queries, torch.Tensor):
            single = queries.ndim == 1
            q = (queries[None] if single else queries).float()
        else:
            single = np.asarray(queries).ndim == 1
            q = torch.from_numpy(np.ascontiguousarray(
                np.atleast_2d(np.asarray(queries, dtype=np.float32))))
        if self.metric == "cosine":
            q = normalize_rows(q)
        graphs = [s.device_graph() for s in self.shards]
        if graphs[0].kind != "dense":
            raise ValueError("sharded search supports dense metrics only")
        if engine == "auto":
            engine = ("exact" if max(g.capacity for g in graphs)
                      <= device_mod.EXACT_ENGINE_MAX_ROWS else "beam")
        ef = max(params.ef_search, k)
        fmask = None
        if filter_mask is not None:
            fmask = (filter_mask.bool() if isinstance(filter_mask,
                                                      torch.Tensor)
                     else torch.from_numpy(np.asarray(filter_mask,
                                                      dtype=bool)))
        parts = []
        for g in graphs:
            fm = None if fmask is None else fmask.to(g.device)
            parts.append(_shard_topk(g, q.to(g.device), k, ef, engine, fm))
        d, tids = _merge(parts, k, self.devices[0])
        d = d.cpu().numpy().astype(np.float64)
        tids = tids.cpu().numpy().astype(np.int64)
        if self.metric == "l2":
            d = np.where(np.isfinite(d), np.sqrt(np.maximum(d, 0.0)), d)
        if single:
            return d[0], tids[0]
        return d, tids


def _write_manifest(path: Path, n_shards: int) -> None:
    """``sharded.json`` through a temporary file and ``os.replace``."""
    tmp = path / "sharded.json.tmp"
    tmp.write_text(json.dumps({"sharded": True, "n_shards": n_shards}))
    os.replace(tmp, path / "sharded.json")


class ShardedScan:
    """K-way merge of per-shard resumable scans into one globally ordered
    stream (the iterative-scan analog for the sharded index)."""

    def __init__(self, index: ShardedHnswIndex, query, params: SearchParams):
        self.params = params
        self._emitted = 0
        self._scans = [s.scan(query, params) for s in index.shards]
        # launch every shard's first segment before reading any: shards on
        # separate cards then work concurrently
        for sc in self._scans:
            prefetch = getattr(sc, "prefetch", None)
            if prefetch is not None:
                prefetch()
        self._heap: list = []
        for i, sc in enumerate(self._scans):
            item = sc.next()
            if item is not None:
                tid, d = item
                # every scan engine emits operator-domain distances, so
                # the heap merge is domain-consistent
                heapq.heappush(self._heap, (d, tid, i))

    def next(self):
        """Next (heap_tid, distance) in global distance order, or None."""
        if self._emitted >= self.params.max_scan_tuples or not self._heap:
            return None
        d, tid, i = heapq.heappop(self._heap)
        nxt = self._scans[i].next()
        if nxt is not None:
            heapq.heappush(self._heap, (nxt[1], nxt[0], i))
        self._emitted += 1
        return tid, d

    def take(self, k: int) -> list[tuple]:
        out = []
        while len(out) < k:
            item = self.next()
            if item is None:
                break
            out.append(item)
        return out

    @property
    def scan_stats(self) -> ScanStats:
        """Merged per-shard ScanStats (EXPLAIN ANALYZE analog)."""
        agg = ScanStats()
        for sc in self._scans:
            st = getattr(sc, "scan_stats", None)
            if st is not None:
                agg.merge(st)
        return agg


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """A sharded step over ``n_devices`` shards (None: the visible cards in
    turn): the device build of each shard's partition, four inserts routed
    across shards, and a batched search with its merge, which must find a
    corpus row as its own nearest neighbour. The port's counterpart of
    ``__graft_entry__.dryrun_multichip``, with the device build."""
    devices = _shard_devices(devices, n_devices)
    rng = np.random.default_rng(7)
    data = rng.standard_normal((64 * n_devices, 16)).astype(np.float32)
    idx = ShardedHnswIndex.build(data, n_shards=n_devices, metric="l2",
                                 devices=devices, method="device")
    for j in range(4):
        idx.insert(rng.standard_normal(16).astype(np.float32), 10_000 + j)
    queries = rng.standard_normal((8, 16)).astype(np.float32)
    dists, tids = idx.search(queries, 10, SearchParams(ef_search=32))
    if dists.shape != (8, 10) or tids.shape != (8, 10):
        raise RuntimeError(f"sharded search shapes {dists.shape}, "
                           f"{tids.shape}")
    if not (tids[:, 0] >= 0).all():
        raise RuntimeError("a sharded search found no neighbour")
    d0, t0 = idx.search(data[5], 1)
    if t0[0] != 5:
        raise RuntimeError(f"row 5's nearest neighbour is {t0[0]} ({d0[0]})")
