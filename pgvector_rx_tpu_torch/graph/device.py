"""Device (PyTorch) HNSW graph: flat tensors + batched serving engines.

The serving half of ``pgvector_rx_tpu/graph/device.py``, in PyTorch. The
graph is the same flat-array layout (``DeviceGraph``) on an explicit
device, and the engines are the same algorithms:

- **exact**: the fused FP32 sweep (kernel K1 on CUDA, its plain version
  on the CPU);
- **approx**: the binned bf16 sweep (kernel K2 on CUDA, its plain binned
  version on the CPU) followed by an exact f32 rescore of the k winners
  (``_rescore_true``);
- l1, which has no matmul identity, takes the l1 sweep for both
  (``l1_sweep_topk``: torch ops on every device; approx over the bf16
  copy of the rows, then the rescore, selecting exactly where the JAX
  package takes ``approx_min_k``);
- the bit kind (hamming / jaccard over packed words, ``DeviceGraph.words``)
  takes the bit sweep for both (``_exact_search_bits``: kernel K9 on CUDA,
  ``ops/bits.bits_topk``), exact where the JAX package's approx engine
  selects with ``approx_min_k``;
- the sparse kind (padded CSR, ``DeviceGraph.sp_indices`` /
  ``sp_values``) takes the sparse sweep for both (``_exact_search_sparse``:
  kernel K10 on CUDA, ``ops/sparse.sparse_topk``): the JAX package's
  dense-query gather wherever its dense queries fit, at every dimension
  (JAX multiplies densified corpus chunks at dim <= 1024 P), a lookup in
  the query's sorted indices elsewhere; approx rounds the dot's values to
  bf16 where the JAX package takes its bf16 product, selects exactly, and
  rescores in f32;
- **beam**: the best-first walk over layer 0 (``_ground_beam_seeds``:
  kernel K4 on CUDA, one launch per query batch; its plain batched loop on
  the CPU), seeded by a bf16 sweep over the level >= 1 rows
  (``_search_batch_coarse``) or by the greedy upper-layer descent
  (``_search_batch``: the bit and sparse kinds, whose queries are packed
  words or (indices, values) pairs, and dense graphs without coarse
  seeding; on CUDA the descent runs inside K4's launch).

The resumable beam scan (``index/scan.py`` ``DeviceBeamScan``) runs one
walk per segment under an exclusion mask with a spill buffer
(``_beam_scan_step``: kernel K5 on CUDA, which also finishes the segment
and marks its emitted rows), seeded by ``_coarse_seed_one`` or
``_descent_seed_one``.

The beam's variants run as modes of K4 and K5, with the JAX package's
semantics and switches: ``PGV_BEAM_EXPAND`` (E nearest unexpanded members
a step; every walk but the sparse kind's), ``PGV_BEAM_VISITED_MAX`` (a
per-query visited bitmap in place of the in-beam dedup, for graphs whose
capacity + 1 is at most it; K4 only, as the segment has none) and
``PGV_BEAM_BF16`` (bf16 ranking, the beam re-scored in f32; f32 stores
but l1).

Stores that are not f32 (a halfvec index's f16 array, ``PGV_SERVE_DTYPE``
bf16 / f16) sweep in chunks of ``_EXACT_SWEEP_CHUNK`` rows, as the JAX
package does; K1 and K2 read each chunk's stored rows themselves, so no
copy of a chunk is made on the card (the plain versions cast).

``beam_search_arrays`` is the beam each shard of ``parallel/sharded.py``
runs (the descent from the shard's own entry, then the walk, in one K4
launch, without the switches above). ``PGV_SCAN_STATS`` makes ``search``
record the JAX package's counters in ``index.last_scan_stats``
(``_record_scan_stats``).

JAX's ``vmap`` over queries becomes an explicit batch dimension.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import hnsw_get_layer_m

from ..ops import beam, bits, bruteforce, sparse

#: the exact sweep's penalty on excluded rows (ops/bruteforce._NEG_BIG)
_PENALTY = bruteforce._NEG_BIG

# Above this many rows the exact sweep's FLOPs lose to the beam (engine
# "auto"); same cutover as the JAX package.
EXACT_ENGINE_MAX_ROWS = 4_000_000
#: the sparse kind's cutover (the JAX package's: its merge-join sweeps cost
#: O(N P log P) per query batch)
SPARSE_EXACT_MAX_ROWS = 200_000
#: dim <= factor * P selects the JAX package's bf16 densified-corpus
#: product for sparse approx serving (``_SPARSE_MATMUL_FACTOR``); here it
#: decides where approx rounds the dot's values to bf16
SPARSE_MATMUL_FACTOR = 1024

_INF = float("inf")


def _serve_dtype_for(index):
    """Serving value-array dtype (``PGV_SERVE_DTYPE``: auto | bf16 | f16 |
    f32). "auto" keeps f32 rows plus a bf16 sweep copy, and one f16 array
    for halfvec indexes."""
    mode = os.environ.get("PGV_SERVE_DTYPE", "auto")
    if mode == "bf16":
        return torch.bfloat16
    if mode == "f16":
        return torch.float16
    if mode == "f32":
        return torch.float32
    if index.kind == "dense" and index.dtype == np.float16:
        return torch.float16
    return torch.float32


def _serve_value_arrays(v32, serve_dtype):
    """(values, x2, values_bf16) under the dtype policy. ``v32`` is the
    padded [cap+1, D] f32 row tensor; compact dtypes store one tensor and
    derive x2 from the stored (rounded) values."""
    if serve_dtype == torch.float32:
        return dict(
            values=v32,
            x2=(v32 * v32).sum(dim=1),
            values_bf16=v32.to(torch.bfloat16),
        )
    v = v32.to(serve_dtype)
    vf = v.float()
    return dict(values=v, x2=(vf * vf).sum(dim=1), values_bf16=None)


def _tensor(arr, device):
    """Tensor or numpy(-convertible) array -> tensor on ``device``. bf16
    numpy arrays (ml_dtypes) go through f32, which holds them exactly."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)
    if not a.flags.writeable:  # e.g. a view of an immutable JAX buffer
        a = a.copy()
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


_GRAPH_FIELDS = (
    "neighbors0", "upper_neighbors", "upper_slot", "levels", "traversable",
    "emit_tid", "tid_count",
)
_VALUE_FIELDS = ("values", "x2", "values_bf16", "words", "sp_indices",
                 "sp_values")


@dataclass
class DeviceGraph:
    """Flat-tensor mirror of a dense, bit or sparse host index, on one
    device."""

    kind: str
    metric: str
    cap: int  # number of element slots (tensors padded to cap+1)
    m: int
    entry: int  # -1 if empty
    entry_level: int
    neighbors0: torch.Tensor  # [cap+1, 2M] int32
    upper_neighbors: torch.Tensor  # [U, LMAX*M] int32 (layer-major flat)
    upper_slot: torch.Tensor  # [cap+1] int32
    levels: torch.Tensor  # [cap+1] int32
    traversable: torch.Tensor  # [cap+1] bool
    emit_tid: torch.Tensor  # [cap+1] int32
    tid_count: torch.Tensor  # [cap+1] int32
    values: torch.Tensor | None = None  # [cap+1, D] serve dtype
    # per-row ||x||^2 (the bit kind: the row's popcount) and a bf16 copy,
    # so sweeps don't recompute per call
    x2: torch.Tensor | None = None
    values_bf16: torch.Tensor | None = None
    # the bit kind's rows: [cap+1, ceil(dim/32)] int32 words with the bits
    # of ops/bits.pack_bits's uint32 words
    words: torch.Tensor | None = None
    # the sparse kind's padded-CSR rows: [cap+1, P] int32 indices (sorted,
    # ops/sparse.PAD_INDEX pads) and [cap+1, P] f32 values
    sp_indices: torch.Tensor | None = None
    sp_values: torch.Tensor | None = None
    # The capacity the JAX package's graph would report as its ``cap``:
    # a device-built or grown graph there keeps its padded array capacity
    # (``device_build.cap_pad_for(n) - 1``), here only the figure, not the
    # padded tensors. ``search``'s engine choice and the filter-mask length
    # check read it. None = ``cap``.
    capacity: int | None = None

    def __post_init__(self):
        if self.capacity is None:
            self.capacity = self.cap

    @property
    def device(self) -> torch.device:
        return self.neighbors0.device

    @property
    def rows(self):
        """The rows the distances read: ``words`` (bit), the pair
        (``sp_indices``, ``sp_values``) (sparse) or ``values``."""
        if self.kind == "sparse":
            return self.sp_indices, self.sp_values
        return self.words if self.kind == "bit" else self.values

    @classmethod
    def from_numpy(cls, arrays: dict, *, kind: str, metric: str, cap: int,
                   m: int, entry: int, entry_level: int, device):
        """Build from arrays named like the fields: numpy arrays (e.g.
        ``np.asarray`` of a JAX ``DeviceGraph``'s fields, uint32 words
        included) or tensors. Missing value fields stay None, but for the
        bit kind's popcounts (``x2``), counted here."""
        if kind not in ("dense", "bit", "sparse"):
            raise ValueError(f"unknown DeviceGraph kind {kind!r}")
        tensors = {
            f: (bits.as_words(arrays[f], device) if f == "words"
                else _tensor(arrays[f], device))
            for f in _GRAPH_FIELDS + _VALUE_FIELDS
            if arrays.get(f) is not None
        }
        tensors["traversable"] = tensors["traversable"].bool()
        if kind == "bit" and "x2" not in tensors:
            tensors["x2"] = bits.row_popcount(tensors["words"])
        return cls(kind=kind, metric=metric, cap=int(cap), m=int(m),
                   entry=int(entry), entry_level=int(entry_level), **tensors)

    @classmethod
    def from_index(cls, index, device=None) -> "DeviceGraph":
        """Flatten a host-graph index (``index.elements``) onto ``device``
        (default: the index's own)."""
        device = index.device if device is None else device
        n = len(index.elements)
        m = index.params.m
        lm0 = hnsw_get_layer_m(m, 0)

        neighbors0 = np.full((n + 1, lm0), -1, dtype=np.int32)
        levels = np.full(n + 1, -1, dtype=np.int32)
        traversable = np.zeros(n + 1, dtype=bool)
        emit_tid = np.full(n + 1, -1, dtype=np.int32)
        tid_count = np.zeros(n + 1, dtype=np.int32)
        upper_rows = []
        upper_slot = np.full(n + 1, -1, dtype=np.int32)
        lmax = max(max((e.level for e in index.elements), default=0), 1)

        for i, e in enumerate(index.elements):
            levels[i] = e.level
            traversable[i] = not e.deleted
            tids = index.heap_tids[i]
            tid_count[i] = len(tids)
            if tids:
                emit_tid[i] = tids[0]
            if e.deleted:
                continue
            l0 = e.neighbors[0] if e.neighbors else []
            for j, (_, nid) in enumerate(l0[:lm0]):
                neighbors0[i, j] = nid
            if e.level >= 1:
                upper_slot[i] = len(upper_rows)
                row = np.full(lmax * m, -1, dtype=np.int32)
                for lc in range(1, e.level + 1):
                    for j, (_, nid) in enumerate(e.neighbors[lc][:m]):
                        row[(lc - 1) * m + j] = nid
                upper_rows.append(row)
        upper_neighbors = (
            np.stack(upper_rows)
            if upper_rows
            else np.full((1, lmax * m), -1, dtype=np.int32)
        )
        if index.kind == "bit":
            words = np.zeros((n + 1, -(-index.dim // 32)), dtype=np.uint32)
            words[:n] = bits.bytes_to_words(index.store.rows[:n], index.dim)
            value_arrays = dict(words=words)
        elif index.kind == "sparse":
            budget = index.store.budget
            si = np.full((n + 1, budget), sparse.PAD_INDEX, dtype=np.int32)
            sv = np.zeros((n + 1, budget), dtype=np.float32)
            si[:n] = index.store.indices[:n]
            sv[:n] = index.store.values[:n]
            value_arrays = dict(sp_indices=si, sp_values=sv)
        else:
            vals = np.zeros((n + 1, index.dim), dtype=np.float32)
            vals[:n] = index.store.rows[:n].astype(np.float32)
            value_arrays = _serve_value_arrays(
                _tensor(vals, device), _serve_dtype_for(index)
            )
        return cls.from_numpy(
            dict(neighbors0=neighbors0, upper_neighbors=upper_neighbors,
                 upper_slot=upper_slot, levels=levels,
                 traversable=traversable, emit_tid=emit_tid,
                 tid_count=tid_count, **value_arrays),
            kind=index.kind, metric=index.metric, cap=n, m=m,
            entry=index.entry if index.entry is not None else -1,
            entry_level=(
                index.elements[index.entry].level
                if index.entry is not None else -1
            ),
            device=device,
        )


# ---------------------------------------------------------------------------
# Distances from a batch of queries to gathered graph rows
# ---------------------------------------------------------------------------


def _dist_ids(g: DeviceGraph, q, ids):
    """Order-distances [B, W] from queries ``q`` [B, D] (the bit kind:
    packed words [B, W]; the sparse kind: the (indices, values) pair) to
    rows ``ids`` [B, W] (ids clamped into range, callers mask)."""
    return beam.row_dists(g.rows, g.metric, q, ids)


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

#: the beam walk's bf16 ranking (``PGV_BEAM_BF16``, read at import as in
#: the JAX package): new candidates ranked over the bf16 copy of the rows,
#: the surviving beam re-scored in f32 (``ops/beam.rank_dists``). Default
#: off.
_BEAM_BF16 = os.environ.get("PGV_BEAM_BF16", "0") != "0"

#: graphs of at most this capacity + 1 walk with a per-query visited
#: bitmap in place of the in-beam dedup (``PGV_BEAM_VISITED_MAX``, read at
#: import as in the JAX package); default 0: always the in-beam dedup.
_VISITED_MAX_ROWS = int(os.environ.get("PGV_BEAM_VISITED_MAX", 0))


def _beam_expand() -> int:
    """``PGV_BEAM_EXPAND``, read at every call as in the JAX package: the
    E nearest unexpanded members a step expands (default 1). E < 1 is
    refused (JAX refuses E < 0 and runs E = 0 as a walk that never
    expands)."""
    expand = int(os.environ.get("PGV_BEAM_EXPAND", 1))
    if expand < 1:
        raise ValueError(f"PGV_BEAM_EXPAND must be >= 1 (got {expand})")
    return expand


def _rank_is_approx(g: DeviceGraph) -> bool:
    """bf16 ranking applies: f32 stores with their bf16 copy, not l1."""
    return (_BEAM_BF16 and g.kind == "dense" and g.values_bf16 is not None
            and g.metric != "l1")


def _walk_modes(g: DeviceGraph) -> dict:
    """The beam walk's visited and ranking modes for ``g``: the bitmap
    where the capacity (the JAX package's padded ``cap``) + 1 is at most
    ``_VISITED_MAX_ROWS``, the bf16 rows where ``_rank_is_approx``."""
    return dict(visited=g.capacity + 1 <= _VISITED_MAX_ROWS,
                rank=g.values_bf16 if _rank_is_approx(g) else None)


def _ground_beam_seeds(g: DeviceGraph, q, seed_ids, seed_d, ef: int,
                       max_steps: int, expand: int = 1):
    """Best-first beam of width ef at layer 0 for a batch of queries
    (``ops/beam.beam_walk``: kernel K4 on CUDA tensors, the plain loop on
    CPU tensors). ``seed_ids`` [B, S] (-1 = unused, S <= ef) and their
    distances seed the beam; ``expand`` nearest unexpanded members a step,
    and the graph's visited and ranking modes (``_walk_modes``). Returns
    (dists [B, ef], ids [B, ef]) nearest first, and steps [B]."""
    return beam.beam_walk(g.rows, g.neighbors0, g.traversable, g.metric, q,
                          seed_ids, seed_d, ef, max_steps, expand=expand,
                          **_walk_modes(g))


def _descent_seeds(g: DeviceGraph, queries, entry_level: int):
    """Greedy upper-layer descent from the entry point for every query
    (scan.rs:492-510 analog; torch ops, ``ops/beam.descent_plain``: a host
    check per move; bf16-ranked where ``_rank_is_approx``) -> (seed ids
    [B, 1], seed distances [B, 1]): Algorithm 5's layer-0 entry."""
    cur, cur_d = beam.descent_plain(g.rows, g.traversable, g.upper_slot,
                                    g.upper_neighbors, g.m, g.metric,
                                    queries, g.entry, entry_level,
                                    rank=_walk_modes(g)["rank"])
    return cur[:, None], cur_d[:, None]


def _search_batch(g: DeviceGraph, queries, ef: int, entry_level: int,
                  max_steps: int, expand: int = 1):
    """Full Algorithm-5 search: greedy descent through the upper layers
    from the entry point, then the ground beam from where it lands
    (``ops/beam.descent_walk``: on CUDA tensors one launch of kernel K4
    does both; on CPU tensors ``_descent_seeds`` then the plain walk).
    Returns (dists [B, ef], ids [B, ef], steps [B])."""
    return beam.descent_walk(g.rows, g.neighbors0, g.traversable,
                             g.upper_slot, g.upper_neighbors, g.m, g.entry,
                             entry_level, g.metric, queries, ef,
                             max_steps, expand=expand,
                             **_walk_modes(g))[:3]


def upper_row_arrays(g: DeviceGraph):
    """(ids [U] int64, rows [U, D], a [U] f32, U) of the level >= 1
    elements, computed once per DeviceGraph and cached on it (coarse
    seeding). The rows are bf16 (an f16 store rounds once here, as the
    JAX package's cast does at every sweep), the f32 ones of l1 as the JAX
    package keeps them (its l1 sweep reads them in f32). ``a`` is K7's
    row term: the f32 sum of the bf16 row's squares for l2, 0 for ip /
    cosine (None for l1)."""
    cache = getattr(g, "_upper_cache", None)
    if cache is not None:
        return cache
    slot = g.upper_slot[: g.cap]
    ids = torch.nonzero(slot >= 0).flatten()
    src = g.values_bf16 if g.values_bf16 is not None else g.values
    rows, a = src[ids], None
    if g.metric != "l1":
        rows = rows.to(torch.bfloat16)
        rf = rows.float()
        a = ((rf * rf).sum(dim=1) if g.metric == "l2"
             else torch.zeros_like(rf[:, 0]))
    g._upper_cache = (ids, rows, a, int(ids.numel()))
    return g._upper_cache


def _coarse_upper(g: DeviceGraph):
    """(upper_ids, upper_rows) when coarse seeding applies, else None."""
    if g.kind != "dense" or os.environ.get("PGV_BEAM_SEED") == "descent":
        return None
    ids, rows, _, count = upper_row_arrays(g)
    # too few upper elements for the sweep to beat plain descent
    if count < 8:
        return None
    return ids, rows


def _coarse_seeds(g: DeviceGraph, queries, upper_ids, upper_rows,
                  n_seeds: int):
    """The n_seeds nearest upper elements of each query by one bf16 sweep
    over the level >= 1 rows -> (seed ids [B, n] (-1 = none), exact f32
    seed distances [B, n] (inf = none)): the bf16 scores only rank.
    ``upper_ids`` / ``upper_rows`` are ``upper_row_arrays(g)``'s, whose
    row term goes with them. l2 / ip / cosine:
    ``ops/bruteforce.coarse_topk`` (kernel K7 on CUDA tensors, its plain
    version on CPU tensors). l1 has no matmul identity: the [B, U] l1
    sweep of the f32 queries and rows (``torch.cdist``), the mask and
    ``torch.topk``."""
    if g.metric != "l1":
        _, seed_ids = bruteforce.coarse_topk(
            upper_rows, upper_row_arrays(g)[2], upper_ids, g.traversable,
            queries, n_seeds, g.metric == "l2")
    else:
        scores = torch.cdist(queries.float(), upper_rows.float(), p=1)
        valid = g.traversable[upper_ids]
        scores = torch.where(valid[None, :], scores, _INF)
        seed_sc, slots = torch.topk(scores, n_seeds, dim=1, largest=False,
                                    sorted=True)
        seed_ids = torch.where(torch.isfinite(seed_sc), upper_ids[slots], -1)
    seed_d = torch.where(seed_ids >= 0, _dist_ids(g, queries, seed_ids), _INF)
    return seed_ids, seed_d


def _search_batch_coarse(g: DeviceGraph, queries, upper_ids, upper_rows,
                         ef: int, max_steps: int, expand: int = 1,
                         n_seeds: int = 8):
    """Coarse-seeded beam: one bf16 sweep over the level >= 1 rows picks
    the n_seeds nearest upper elements, whose exact f32 distances seed the
    ground beam (in place of the greedy upper-layer descent)."""
    S = min(n_seeds, upper_rows.shape[0], ef)  # seeds must fit the beam
    seed_ids, seed_d = _coarse_seeds(g, queries, upper_ids, upper_rows, S)
    return _ground_beam_seeds(g, queries, seed_ids, seed_d, ef, max_steps,
                              expand)


# ---------------------------------------------------------------------------
# Resumable beam scan (iterative-scan analog for beam-scale corpora)
# ---------------------------------------------------------------------------


def _beam_scan_segment(g: DeviceGraph, q, seed_ids, seed_d, excluded,
                       ef: int, spill: int, max_steps: int,
                       width: int | None = None, expand: int = 1):
    """One iterative-scan segment for one prepared query ``q`` [D]: the
    beam walk at internal width ``width`` (>= ef, default ef) from the
    seeds [S] (-1 = unused) under the exclusion mask ``excluded`` [cap+1]
    (already-emitted elements), capturing evicted candidates in a spill
    buffer (``ops/beam.beam_scan_segment``: kernel K5 on CUDA tensors, the
    plain loop on CPU tensors; the reference's discarded heap and shared
    visited set, scan.rs:311-346, :538-577), ``expand`` nearest unexpanded
    members a step, ranked in bf16 where ``_rank_is_approx``.

    Returns (beam_d [ef], beam_ids [ef], spill_d [spill], spill_ids
    [spill], steps []): the beam nearest first; the spill nearest first,
    deduplicated by id, without the emitted beam's ids, with the
    width - ef leftover of the beam merged in."""
    out = beam.beam_scan_segment(
        g.values, g.neighbors0, g.traversable, excluded[None], g.metric,
        q[None], seed_ids[None], seed_d[None], ef,
        ef if width is None else width, spill, max_steps, expand=expand,
        rank=_walk_modes(g)["rank"])
    return tuple(t[0] for t in out)


def _beam_scan_step(g: DeviceGraph, q, seed_ids, seed_d, excluded, allowed,
                    ef: int, spill: int, max_steps: int, width: int,
                    expand: int = 1):
    """``_beam_scan_segment`` as ``DeviceBeamScan`` runs it: the emitted
    ids set in ``excluded`` [cap+1] (and cleared in the staged bitmap
    ``allowed``, ``ops/beam.allowed_bits``, or None) in place, and the
    outputs as (report [2 ef + 3] int32, spill_d [spill], spill_ids
    [spill] int32): one device-to-host copy of the report gives the host
    what it reads (``ops/beam.scan_segment``)."""
    report, sp_d, sp_ids = beam.scan_segment(
        g.values, g.neighbors0, g.traversable, excluded[None], g.metric,
        q[None], seed_ids[None], seed_d[None], ef, width, spill, max_steps,
        allowed=allowed, mark=True, expand=expand,
        rank=_walk_modes(g)["rank"])
    return report[0], sp_d[0], sp_ids[0]


def _mark_excluded(excluded, ids):
    """Mark emitted element ids in the exclusion mask [cap+1], IN PLACE
    (the JAX package returns a new mask); invalid (-1) ids land on the pad
    row ``cap``, which is never admitted anyway. Returns ``excluded``."""
    beam.mark_excluded(excluded[None], ids[None])
    return excluded


def _coarse_seed_one(g: DeviceGraph, q, upper_ids, upper_rows, n_seeds: int):
    """Top-n_seeds level >= 1 elements for one query [D] -> (ids [n], exact
    f32 distances [n]): the beam scan's first-segment entry points, the
    beam engine's coarse seeding."""
    n = min(n_seeds, upper_rows.shape[0])
    seed_ids, seed_d = _coarse_seeds(g, q[None], upper_ids, upper_rows, n)
    return seed_ids[0], seed_d[0]


def _descent_seed_one(g: DeviceGraph, q, entry_level: int):
    """Greedy upper-layer descent for one query [D] -> the single layer-0
    entry (ids [1], distances [1]), for graphs without a usable upper
    set."""
    seed_ids, seed_d = _descent_seeds(g, q[None], entry_level)
    return seed_ids[0], seed_d[0]


# ---------------------------------------------------------------------------
# Exact / approx sweeps (dense)
# ---------------------------------------------------------------------------


def _true_dists(g: DeviceGraph, queries, s):
    """Recover true distances from order scores on [B, k] columns."""
    if g.metric == "l2":
        q2 = (queries * queries).sum(dim=1, keepdim=True)
        return torch.clamp(s + q2, min=0.0)
    if g.metric == "cosine":
        # keep the inf dead-row sentinel (clip would map it to 2.0)
        return torch.where(torch.isfinite(s), 1.0 - (-s).clamp(-1.0, 1.0), s)
    return s  # ip: -dots IS the distance; l1: sums pass through


def _rescore_true(g: DeviceGraph, queries, s, ids):
    """Exact f32 distances for the final [B, k] columns of the approx
    sweep, re-sorted; bf16 order scores must not leak into returned
    distance values. Dead/empty slots (non-finite ``s``) stay inf."""
    rows = g.values[ids.clamp(0, g.cap).long()].float()  # [B, k, D]
    qb = queries[:, None, :]
    if g.metric == "l2":
        diff = rows - qb
        d = (diff * diff).sum(dim=-1)
    elif g.metric == "l1":
        d = (rows - qb).abs().sum(dim=-1)
    else:
        dots = (rows * qb).sum(dim=-1)
        d = -dots if g.metric == "ip" else 1.0 - dots.clamp(-1.0, 1.0)
    d = torch.where(torch.isfinite(s), d, _INF)
    d, order = torch.sort(d, dim=1, stable=True)
    return d, torch.gather(ids, 1, order)


#: corpus rows per block of the l1 sweep (bounds its [B, rows] scores)
_L1_CHUNK = 1 << 16


def l1_sweep_topk(vals, a, queries, k: int):
    """Exact top-k of the l1 order score ``|q - x|_1 + a`` (``a``: 0 on
    live rows, inf on the rest) over the rows of ``vals`` -> (scores
    [B, k] f32, row ids [B, k] int64) in (score, lower row first) order,
    ``lax.top_k``'s; rows at inf and the tail past the rows come back as
    (inf, -1). f32 sums of direct differences (``torch.cdist(p=1)``: no
    [B, rows, D] temporary) per block of ``_L1_CHUNK`` rows, merged into a
    running top-k of (score, row) keys. Torch ops on every device: the
    kernel to hand-write is queued (ROADMAP queue 2, K11)."""
    q = queries.float()
    best = torch.empty((q.shape[0], 0), dtype=torch.int64, device=q.device)
    for s in range(0, vals.shape[0], _L1_CHUNK):
        x = vals[s : s + _L1_CHUNK].float()
        sc = torch.cdist(q, x, p=1) + a[None, s : s + _L1_CHUNK]
        rows = torch.arange(s, s + x.shape[0], device=q.device)
        keys = torch.cat([best, bruteforce._order_keys(
            sc, rows[None, :].expand(q.shape[0], -1))], dim=1)
        best = torch.topk(keys, min(k, keys.shape[1]), dim=1, largest=False,
                          sorted=True).values
    if best.shape[1] < k:  # fewer rows than k
        best = torch.nn.functional.pad(best, (0, k - best.shape[1]), value=-1)
    return bruteforce._from_order_keys(best)


def _live_rows(g: DeviceGraph, row_mask):
    live = g.traversable & (g.tid_count > 0)
    return live if row_mask is None else live & row_mask


def _exact_search_batch(g: DeviceGraph, queries, k: int, approx: bool = False,
                        row_mask=None):
    """Exact (or approximate) top-k over the index's live rows ->
    (dists [B, k], element ids [B, k]) nearest first, -1 / inf padded.

    The sweep is ``ops/bruteforce``'s: K1 (exact FP32) or K2 (binned
    bf16) followed by the f32 rescore. Those wrappers alone choose the
    kernel (CUDA tensors) or its plain version (CPU tensors). l1 has no
    matmul identity and takes ``l1_sweep_topk`` (over the bf16 copy of the
    rows, then the f32 rescore, for approx)."""
    live = _live_rows(g, row_mask)
    if g.metric == "l1":
        a = torch.where(live, 0.0, _INF)
        vals = g.values
        if approx and g.values_bf16 is not None:
            vals = g.values_bf16
        d, ids = l1_sweep_topk(vals, a, queries, k)
        if approx:
            d, ids = _rescore_true(g, queries, d, ids)
        return d, torch.where(torch.isfinite(d), ids, -1)
    x2 = g.x2 if g.x2 is not None else (g.values.float() ** 2).sum(dim=1)
    pen = torch.where(live, 0.0, _PENALTY)
    a = ((x2 + pen) if g.metric == "l2" else pen).contiguous()
    if approx:
        vals = g.values_bf16 if g.values_bf16 is not None else g.values

        def sweep(v, a_c):  # the metric's distances from the bf16 scores
            return bruteforce.binned_sweep_topk(
                v.contiguous(), a_c, queries, k, g.metric)
    else:
        vals = g.values

        def sweep(v, a_c):  # K1's scores a - 2 q.x
            return bruteforce._surrogate_topk(
                v.contiguous(), a_c, queries.contiguous(), k)
    if g.values.dtype == torch.float32:
        s, ids = sweep(vals, a)
    else:
        s, ids = _chunked_sweep(sweep, vals, a, queries.shape[0], k)
    if approx:
        d, ids = _rescore_true(g, queries, s, ids)
    else:
        # K1 scores a - 2 q.x: halve for the ip/cosine order a - q.x
        d = _true_dists(g, queries, s if g.metric == "l2" else s * 0.5)
    return d, torch.where(torch.isfinite(d), ids.long(), -1)


#: corpus rows per chunk of the sweeps over stores that are not f32 (the
#: JAX package's ``_EXACT_SWEEP_CHUNK``, which casts each chunk for its
#: kernel; the port's kernels read the stored rows)
_EXACT_SWEEP_CHUNK = 1 << 18


def _sweep_chunk_rows(rows: int, b: int) -> int:
    """The JAX package's chunk rule: ``_EXACT_SWEEP_CHUNK`` rows, halved
    (not below 8,192) while the [b, chunk] f32 score block exceeds its
    budget, 256 MB past 4M rows and 1 GB below."""
    ch = _EXACT_SWEEP_CHUNK
    budget = (256 << 20) if rows > (4 << 20) else (1 << 30)
    while b * ch * 4 > budget and ch > 8192:
        ch //= 2
    return ch


def _chunked_sweep(sweep, vals, a, b: int, k: int):
    """``sweep(rows, a)`` -> (scores [b, k], row ids [b, k], (inf, -1)
    empty) over chunks of ``_sweep_chunk_rows`` rows of ``vals``, merged
    into one top-k in (score, lower row first) order
    (``ops/bruteforce._order_keys``)."""
    n = vals.shape[0]
    ch = _sweep_chunk_rows(n, b)
    best = None
    for s in range(0, n, ch):
        sd, si = sweep(vals[s : s + ch], a[s : s + ch])
        si = si.long()
        # an empty slot sorts after every row (its key's row is 2^31 - 1)
        keys = bruteforce._order_keys(
            torch.where(si >= 0, sd, _INF),
            torch.where(si >= 0, si + s, (1 << 31) - 1))
        if best is not None:
            keys = torch.cat([best, keys], dim=1)
        best = torch.topk(keys, min(k, keys.shape[1]), dim=1, largest=False,
                          sorted=True).values
    return bruteforce._from_order_keys(best)


def _exact_search_bits(g: DeviceGraph, queries, k: int, approx: bool = False,
                       row_mask=None):
    """Exact top-k over the live packed-bit rows (hamming / jaccard) for
    packed-word queries [B, W] -> (dists [B, k], element ids [B, k]) in
    (distance, id) order, -1 / inf padded: the bit sweep (``ops/bits.
    bits_topk``, kernel K9 on CUDA). ``approx`` selects exactly too, where
    the JAX package takes ``approx_min_k`` over the same exact distances."""
    del approx
    d, ids = bits.bits_topk(g.words, g.x2, _live_rows(g, row_mask),
                            queries, k, g.metric)
    return d, torch.where(torch.isfinite(d), ids, -1)


def _exact_search_sparse(g: DeviceGraph, q_indices, q_values, k: int,
                         dim: int = 0, row_mask=None, approx: bool = False):
    """Exact (or approximate) top-k over the live padded-CSR rows for
    padded-CSR queries [B, P] -> (dists [B, k], element ids [B, k]) in
    (distance, id) order, -1 / inf padded: the sparse sweep
    (``ops/sparse.sparse_topk``, kernel K10 on CUDA; its form by
    ``ops/sparse._k10_form(dim, B)``).

    ``approx`` where the JAX package takes its bf16 densified-corpus
    product (l2 / ip / cosine, ``dim <= SPARSE_MATMUL_FACTOR * P`` and the
    dense queries affordable): the dot over bf16-rounded values, an exact
    selection where JAX takes ``approx_min_k``, then the k winners rescored
    in f32 (bf16 scores must not leak into returned distances); elsewhere
    approx is the exact sweep, as in JAX."""
    b, p = q_indices.shape
    bf16 = (approx and g.metric != "l1" and sparse.dense_q_fits(dim, b)
            and dim <= SPARSE_MATMUL_FACTOR * p)
    d, ids = sparse.sparse_topk(g.sp_indices, g.sp_values,
                                _live_rows(g, row_mask), q_indices, q_values,
                                k, g.metric, approx=bf16, dim=dim)
    if bf16:
        exact = sparse.gathered(g.metric, g.sp_indices, g.sp_values, ids,
                                q_indices, q_values)
        d, order = torch.sort(torch.where(torch.isfinite(d), exact, _INF),
                              dim=1, stable=True)
        ids = torch.gather(ids, 1, order)
    return d, torch.where(torch.isfinite(d), ids, -1)


def _stage_queries(g: DeviceGraph, queries):
    """Staged queries on the graph's device: f32 rows, or for the bit kind
    packed words ([B, W] uint32 / int32, ``ops/bits.pack_bits``)."""
    if g.kind == "bit":
        return bits.as_words(queries, g.device).contiguous()
    return torch.as_tensor(queries).to(g.device, torch.float32)


# ---------------------------------------------------------------------------
# Bulk serving
# ---------------------------------------------------------------------------


def _serve_chunk(g: DeviceGraph, qc, k: int, engine: str, ef: int,
                 max_steps: int, upper, row_mask, expand: int = 1):
    """Top-k of one query chunk through one engine (the body of the JAX
    package's single-dispatch ``_serve_sweep``)."""
    if engine != "beam":
        sweep = _exact_search_bits if g.kind == "bit" else _exact_search_batch
        return sweep(g, qc, k, approx=engine == "approx", row_mask=row_mask)
    if upper is not None:
        d, ids, _ = _search_batch_coarse(g, qc, upper[0], upper[1], ef,
                                         max_steps, expand)
    else:
        d, ids, _ = _search_batch(g, qc, ef, g.entry_level, max_steps,
                                  expand)
    if row_mask is not None:
        # post-filter the ef-wide beam (the traversal stays unfiltered,
        # like the reference's executor filter)
        keep = row_mask[ids.clamp(min=0)] & (ids >= 0)
        d = torch.where(keep, d, _INF)
        d, order = torch.sort(d, dim=1, stable=True)
        ids = torch.gather(ids, 1, order)
        ids = torch.where(torch.isfinite(d), ids, -1)
    return d[:, :k], ids[:, :k]


def serve_topk(index, queries_dev, k: int, engine: str = "approx",
               chunk: int = 1024, ef: int = 40, filter_mask=None):
    """Bulk top-k over staged queries -> (dists [B,k] np, element ids [B,k]
    np), in chunks of ``chunk`` queries. Dense metrics take [B, dim] rows;
    hamming / jaccard take packed-word queries ([B, ceil(dim/32)] uint32 or
    int32, as ``ops/bits.pack_bits`` makes them).

    The serving fast path: ``search()`` stays the semantically complete
    per-call API (duplicate TID expansion, operator distances).
    ``filter_mask``: optional bool array over element ids; exact/approx
    pre-filter inside the sweep, beam post-filters its ef-wide result.
    """
    if engine not in ("exact", "approx", "beam"):
        raise ValueError(f"unknown engine {engine!r}")
    if index.kind == "sparse":
        raise ValueError("serve_topk takes one query matrix; the sparse "
                         "kind serves through search(), as in the JAX "
                         "package")
    g = index.device_graph()
    row_mask = _stage_filter_mask(g, filter_mask)
    queries = _stage_queries(g, queries_dev)
    ef_eff = max(ef, k)
    upper, expand = None, 1
    if engine == "beam":
        upper, expand = _coarse_upper(g), _beam_expand()
    out_d, out_i = [], []
    for s in range(0, queries.shape[0], chunk):
        d, ids = _serve_chunk(g, queries[s : s + chunk], k, engine, ef_eff,
                              4 * ef_eff + 32, upper, row_mask, expand)
        out_d.append(d)
        out_i.append(ids)
    if not out_d:
        return np.zeros((0, k), np.float32), np.zeros((0, k), np.int64)
    return (torch.cat(out_d).cpu().numpy(), torch.cat(out_i).cpu().numpy())


def _stage_filter_mask(g: DeviceGraph, filter_mask):
    """A user element-id filter mask as a [cap+1] bool tensor on the
    graph's device (sentinel row False). Accepts None or a numpy / torch
    bool array of length <= the graph's capacity (unlisted tail ids are
    excluded; ids past ``cap`` hold no element, so they are dropped)."""
    if filter_mask is None:
        return None
    cap1 = g.traversable.shape[0]
    m = torch.as_tensor(np.asarray(filter_mask, dtype=bool)
                        if not isinstance(filter_mask, torch.Tensor)
                        else filter_mask).to(g.device, torch.bool)
    if m.shape[0] > g.capacity:
        raise ValueError(
            f"filter_mask length {m.shape[0]} exceeds index capacity "
            f"{g.capacity}"
        )
    out = torch.zeros(cap1, dtype=torch.bool, device=g.device)
    n = min(m.shape[0], cap1 - 1)
    out[:n] = m[:n]
    return out


# ---------------------------------------------------------------------------
# Array-level search (each shard of parallel/sharded.py walks its own graph
# from its own entry)
# ---------------------------------------------------------------------------


def beam_search_arrays(values, neighbors0, upper_neighbors, upper_slot,
                       traversable, entry: int, entry_level: int, queries, *,
                       metric: str, ef: int, m: int, max_steps: int):
    """Dense-metric batched search of one shard's graph from its own entry
    (the JAX package's ``beam_search_arrays``,
    ``pgvector_rx_tpu/graph/device.py:1876``): the greedy descent from
    ``entry`` (level ``entry_level``) through ``upper_neighbors`` [U,
    LMAX * m], then the best-first walk at layer 0 (``ops/beam.
    descent_walk``: one launch of kernel K4 on CUDA tensors, the plain
    descent and walk on CPU tensors).

    The algorithm of ``_search_batch``, without its switches: one member
    expanded a step, the in-beam dedup and f32 ranking whatever
    ``PGV_BEAM_*`` holds, as the JAX function reads none of them. Returns
    (dists [B, ef], element ids [B, ef]) in (distance, id) order, (inf,
    -1) padded."""
    d, ids, _, _, _ = beam.descent_walk(
        values, neighbors0, traversable, upper_slot, upper_neighbors, m,
        entry, entry_level, metric, queries, ef, max_steps)
    return d, ids


def _record_scan_stats(index, g: DeviceGraph, B: int, steps, expand: int):
    """Set ``index.last_scan_stats`` (the EXPLAIN ANALYZE / pgstat-counters
    analog, scan.rs:718-729) where ``PGV_SCAN_STATS`` (read per call) is
    set and not "0", with the JAX package's definitions
    (``pgvector_rx_tpu/graph/device.py:1693``): a sweep (``steps`` None)
    scores every row, ``B`` times the capacity the JAX graph reports; a
    walk of ``expand`` members a step counts its steps, ``expand`` nodes a
    step and ``expand`` full layer-0 lists of rows a step. Only then is
    the step sum read from the device."""
    if os.environ.get("PGV_SCAN_STATS", "0") == "0":
        return
    from ..utils.stats import ScanStats

    st = ScanStats()
    if steps is None:
        st.distances_computed = st.nodes_visited = B * g.capacity
    else:
        total = int(steps.sum())
        st.beam_steps = total
        st.nodes_visited = total * expand
        st.distances_computed = total * expand * g.neighbors0.shape[1]
    index.last_scan_stats = st


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def prepare_query_matrix(index, q: np.ndarray, device):
    """Vectorized dense-query canonicalization. Cosine: rows are
    L2-normalized; zero rows stay zero (vector.rs:688-711)."""
    q = np.asarray(q, dtype=np.float32)
    if index.metric == "cosine":
        n = np.linalg.norm(q, axis=1, keepdims=True)
        q = np.where(n > 0, q / np.where(n > 0, n, 1.0), 0.0).astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(q)).to(device)


def prepare_queries(index, qlist, device):
    """Canonicalize queries: dense ones to a [B, dim] f32 tensor, bit ones
    to packed int32 words [B, ceil(dim/32)], sparse ones to the padded-CSR
    pair (indices [B, P] int32, values [B, P] f32) at the store's budget P
    (a query whose canonical form is skipped, a zero cosine query, stays all
    pads), on ``device``."""
    if index.kind == "bit":
        if isinstance(qlist, torch.Tensor):
            qlist = qlist.cpu().numpy()
        packed = bits.prepare_rows(qlist, index.dim)
        return bits.as_words(bits.bytes_to_words(packed, index.dim), device)
    if index.kind == "sparse":
        prepped = [index.prepare_value(q) for q in qlist]
        budget = index.store.budget
        qi = np.full((len(prepped), budget), sparse.PAD_INDEX, dtype=np.int32)
        qv = np.zeros((len(prepped), budget), dtype=np.float32)
        for r, p in enumerate(prepped):
            if p is not None:
                qi[r, : len(p[0])] = p[0]
                qv[r, : len(p[1])] = p[1]
        return (torch.from_numpy(qi).to(device),
                torch.from_numpy(qv).to(device))
    if isinstance(qlist, torch.Tensor):
        q = qlist.to(device, torch.float32)
        if index.metric == "cosine":
            n = torch.linalg.norm(q, dim=1, keepdim=True)
            q = torch.where(n > 0, q / torch.where(n > 0, n, 1.0), 0.0)
        return q
    arr = np.asarray(qlist, dtype=np.float32)
    if arr.ndim == 2 and arr.shape[1] == index.dim:
        return prepare_query_matrix(index, arr, device)
    rows = [
        (p if p is not None else np.zeros(index.dim, np.float32)).astype(
            np.float32
        )
        for p in (index.prepare_value(q) for q in qlist)
    ]
    return torch.from_numpy(np.stack(rows)).to(device)


def search(index, qlist, k: int, params, engine: str = "auto",
           filter_mask=None):
    """Batched device k-NN -> (order-dists [B,k] f64, heap ids [B,k]).

    engine: "beam" walks the HNSW graph, "exact" runs the exact sweep
    (K1, K9 for the bit kind, K10 for the sparse kind), "approx" the bf16
    binned sweep + rescore (the bit kind: K9; the sparse kind: K10 over
    bf16 values + rescore), "auto" picks exact up to EXACT_ENGINE_MAX_ROWS
    (the sparse kind: SPARSE_EXACT_MAX_ROWS) and beam otherwise.
    ``filter_mask``: optional bool array over element ids; exact/approx
    pre-filter inside the sweep, the beam post-filters emissions.
    """
    g = index.device_graph()
    row_mask = _stage_filter_mask(g, filter_mask)
    B = len(qlist)
    if g.entry < 0 or B == 0:
        return (
            np.full((B, k), np.inf, dtype=np.float64),
            np.full((B, k), -1, dtype=np.int64),
        )
    queries = prepare_queries(index, qlist, g.device)
    ef = max(params.ef_search, 1)
    max_steps = 4 * ef + 32
    if engine == "auto":
        limit = (SPARSE_EXACT_MAX_ROWS if g.kind == "sparse"
                 else EXACT_ENGINE_MAX_ROWS)
        engine = "exact" if g.capacity <= limit else "beam"
    steps, expand = None, 1  # the walk's steps [B] (ScanStats)
    if engine in ("exact", "approx") and g.kind == "sparse":
        beam_d, beam_ids = _exact_search_sparse(
            g, queries[0], queries[1], max(k, 1), dim=index.dim,
            row_mask=row_mask, approx=engine == "approx")
    elif engine in ("exact", "approx"):
        sweep = _exact_search_bits if g.kind == "bit" else _exact_search_batch
        beam_d, beam_ids = sweep(g, queries, max(k, 1),
                                 approx=engine == "approx", row_mask=row_mask)
    elif g.kind == "sparse":
        # the sparse walk takes no expansion (the JAX package's
        # _search_one_sparse passes none)
        beam_d, beam_ids, steps = _search_batch(g, queries, ef,
                                                g.entry_level, max_steps)
    else:
        upper, expand = _coarse_upper(g), _beam_expand()
        if upper is not None:
            beam_d, beam_ids, steps = _search_batch_coarse(
                g, queries, upper[0], upper[1], ef, max_steps, expand
            )
        else:
            beam_d, beam_ids, steps = _search_batch(
                g, queries, ef, g.entry_level, max_steps, expand
            )
    _record_scan_stats(index, g, B, steps, expand)
    # the candidates' TID counts and first TIDs, gathered on the device:
    # copying the whole [cap + 1] arrays took ~2 ms a call at 1M rows
    safe_dev = beam_ids.long().clamp(min=0)
    cnts = torch.where(beam_ids >= 0, g.tid_count[safe_dev], 1).cpu().numpy()
    emit = g.emit_tid[safe_dev].cpu().numpy()
    beam_d = beam_d.cpu().numpy().astype(np.float64)
    beam_ids = beam_ids.cpu().numpy()

    if row_mask is not None and engine not in ("exact", "approx"):
        # beam emissions post-filtered by the element mask (the
        # executor-filter analog); exact engines already pre-filtered
        host_mask = row_mask.cpu().numpy()
        keep = (beam_ids >= 0) & host_mask[np.maximum(beam_ids, 0)]
        beam_d = np.where(keep, beam_d, np.inf)
        beam_ids = np.where(keep, beam_ids, -1)
        order = np.argsort(beam_d, axis=1, kind="stable")
        beam_d, beam_ids, cnts, emit = (np.take_along_axis(t, order, axis=1)
                                        for t in (beam_d, beam_ids, cnts,
                                                  emit))

    # fast path: no duplicates / vacuumed slots among the candidates
    W = beam_ids.shape[1]
    if W >= k and (cnts[:, :k] == 1).all() and (beam_ids[:, :k] >= 0).all():
        out_d = beam_d[:, :k].copy()
        out_ids = emit[:, :k].astype(np.int64)
        out_d[~np.isfinite(out_d)] = np.inf
        out_ids[~np.isfinite(beam_d[:, :k])] = -1
        return out_d, out_ids

    out_d = np.full((B, k), np.inf, dtype=np.float64)
    out_ids = np.full((B, k), -1, dtype=np.int64)
    for b in range(B):
        j = 0
        for d, eid, cnt, tid in zip(beam_d[b], beam_ids[b], cnts[b],
                                    emit[b]):
            if j >= k or eid < 0 or not np.isfinite(d):
                break
            if cnt == 0:
                continue
            if cnt == 1:
                out_d[b, j] = d
                out_ids[b, j] = tid
                j += 1
            else:
                # duplicate element: emit its heap TIDs in slot order
                for tid in reversed(index.heap_tids[int(eid)]):
                    if j >= k:
                        break
                    out_d[b, j] = d
                    out_ids[b, j] = tid
                    j += 1
    return out_d, out_ids
