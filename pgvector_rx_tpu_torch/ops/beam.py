"""The layer-0 best-first beam walk: kernels K4 (the beam engine) and K5
(one segment of the resumable beam scan), hand-written in CUDA for Hopper
(``csrc/k4_beam.cu``, one launch runs a whole walk; K5's launch also
finishes the segment), with their plain-torch versions beside them.

They replace the JAX package's XLA while-loops ``_ground_beam_seeds`` (K4,
``pgvector_rx_tpu/graph/device.py:446``) and ``_beam_scan_segment`` (K5,
``:574``). The default walk expands one member a step, dedups by id in the
beam (the expanded copy wins) and ranks in f32; the JAX package's variants
are modes of the same kernels and plain versions: ``expand`` E (the E
nearest unexpanded members a step, a repeat among their E L neighbours
masked; K4 and K5, E L <= ``MAX_NEW`` on the card), ``visited`` (a
per-query bitmap of every id seen masks neighbours in place of the in-beam
dedup; K4 only) and ``rank`` (new candidates ranked over the bf16 rows by
``rank_dists``, the beam re-scored in f32 at the end; K4 and K5, f32 rows
with their bf16 copy, l2 / ip / cosine). Rows are
f32 / f16 / bf16 values (l2, ip, cosine, l1); for the bit kind, packed
int32 words (hamming, jaccard: the walk's packed-word mode); for the sparse
kind, padded-CSR rows given as the pair (indices [cap+1, P] int32, values
[cap+1, P] f32) with queries as the pair (indices [B, P], values [B, P])
(l2, ip, cosine, l1: the sparse-row mode, ``_search_one_sparse``'s walk).
The word and sparse modes serve only, as the JAX package's beam scan is
dense-only.

- :func:`beam_walk` (K4): ``B`` queries with ``S`` seeds each, a beam of
  width ``ef`` -> (dists [B, ef], ids [B, ef], steps [B]), sorted by
  (distance, id).
- :func:`descent_walk` (K4 with the greedy upper-layer descent in its
  launch: the JAX package's ``_search_batch`` / ``_search_one_sparse``,
  ``:767`` / ``:1861``): each query descends from the entry, then walks
  from where it lands; plain version :func:`descent_plain` then the plain
  walk. Packed words of up to 32 words at ef <= 64 walk with one warp per
  query (the beam in registers), everything else one block per query.
- :func:`scan_segment` (K5): the same walk under an exclusion mask, with
  an internal width ``width`` >= ef, seeds past the width sent to a spill
  buffer and the evicted candidates merged into it, and the segment's
  finish: -> (report [B, 2 ef + 3] int32: the emitted top-ef's distance
  bits and ids, the steps, the rows scored, the spill entries kept; spill
  dists [B, spill]; spill ids [B, spill] int32); the spill is
  deduplicated by id and holds no id of the emitted beam. With
  ``mark=True`` the emitted ids are set in the exclusion mask (and
  cleared in the kernel's staged bitmap ``allowed``). The host reads the
  report with one copy. :func:`beam_scan_segment` returns the same as
  (beam dists, beam ids, spill dists, spill ids, steps).

K5 walks under its rule for the flags (``k5_bitmap_fits``, applied by
``staged_bitmap``): a query's rows that may be walked (``traversable &
~excluded``) are staged as a bitmap in shared memory where (cap + 1) bits
fit beside the segment's state, else read from the global flags.

The wrappers take the plain version only for tensors on the CPU; for a
CUDA tensor they launch the kernel or raise. ``bruteforce.LAUNCHES`` counts
the launches under ``k4_beam`` (``k4_beam_sparse`` for sparse rows) and
``k5_beam_scan``.

Beam keys pack ``id * 2 + (1 - expanded)``; an invalid slot is -2, so
``cap`` must stay below 2^30. The walk's total order is (distance, key):
the kernel and the plain version walk alike except where two distances
are equal in float (the kernel also sorts the seeds before the first
step, where the plain version, like JAX, takes them in the given order,
and keeps only the first copy of a repeated seed). The raw walk also
counts the rows it scored per query, the bytes of its bound.
"""

from __future__ import annotations

import torch

from . import bits, sparse
from .bruteforce import LAUNCHES, _check_cuda

_INF = float("inf")
_METRIC_CODES = {"l2": 0, "ip": 1, "cosine": 2, "l1": 3, "hamming": 4,
                 "jaccard": 5}
#: row types: f32, f16, bf16 values; 3 = packed int32 words (bit metrics);
#: 4 = padded-CSR rows (the pair of indices and values)
_DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2,
                torch.int32: 3}
_SPARSE_ROWS = 4

#: the most new entries a step of the walk kernels takes (E * L;
#: k4_beam.cu's kMaxNew)
MAX_NEW = 256

#: steps between host checks for "any query still active" in the plain
#: walk (frozen queries are masked, so extra steps change nothing)
_SYNC_EVERY = 4


def _queries(q, metric: str):
    """The walk's query operand, contiguous: packed int32 words for the bit
    metrics, the (int32 indices, f32 values) pair for sparse rows, f32 rows
    otherwise."""
    if isinstance(q, tuple):
        return q[0].to(torch.int32).contiguous(), q[1].float().contiguous()
    return (q if metric in bits.BIT_METRICS else q.float()).contiguous()


def row_dists(values, metric: str, q, ids):
    """Order distances [B, W] from queries ``q`` [B, D] to rows ``ids``
    [B, W] of ``values`` [cap+1, D] (ids clamped into range; callers mask).
    f32 sums over the stored values; for hamming / jaccard, ``values`` and
    ``q`` are packed int32 words and the distances popcounts; for sparse
    rows both are (indices, values) pairs (``ops/sparse.gathered``)."""
    if isinstance(values, tuple):
        return sparse.gathered(metric, values[0], values[1], ids, q[0], q[1])
    if metric in bits.BIT_METRICS:
        return bits.gathered(metric, values, ids, q)
    cand = values[ids.clamp(0, values.shape[0] - 1).long()].float()
    qb = q[:, None, :].float()
    if metric == "l2":
        diff = cand - qb
        return (diff * diff).sum(dim=-1)
    if metric == "l1":
        return (cand - qb).abs().sum(dim=-1)
    dots = (cand * qb).sum(dim=-1)
    if metric == "ip":
        return -dots
    if metric == "cosine":
        return 1.0 - dots.clamp(-1.0, 1.0)
    raise ValueError(f"bad metric {metric}")


def rank_dists(values_bf16, metric: str, q, ids):
    """The bf16 ranking distances [B, W] of the beam's new candidates
    (``PGV_BEAM_BF16``: the JAX package's ``_dist_ids_rank``,
    ``pgvector_rx_tpu/graph/device.py:226``): the bf16 rows ``values_bf16``
    [cap+1, D] against the query rounded to bf16. The terms are JAX's f32
    ones: l2 the f32 square ``t * t`` of the difference rounded to bf16
    (``t = bf16(x - q)``), ip and cosine the product rounded to bf16 (l1
    never ranks in bf16). Each has at most 16 significant bits, so the sum
    is taken exactly (in f64, exact while the terms' bits span less than
    53) and rounded once to f32: the kernels' sums in any lane and tree
    order give the same f32 (JAX's f32 sum may differ from it by an ulp,
    which reorders near ties)."""
    cand = values_bf16[ids.clamp(0, values_bf16.shape[0] - 1).long()].float()
    qb = q[:, None, :].to(torch.bfloat16).float()
    if metric == "l2":
        t = (cand - qb).to(torch.bfloat16).float()
        return (t * t).double().sum(dim=-1).float()
    dots = (cand * qb).to(torch.bfloat16).double().sum(dim=-1).float()
    if metric == "ip":
        return -dots
    if metric == "cosine":
        return 1.0 - dots.clamp(-1.0, 1.0)
    raise ValueError(f"bf16 ranking takes l2, ip or cosine (got {metric!r})")


def first_copies(ids):
    """[B, n] bool: True at each id's first occurrence in its row (the JAX
    package's batch dedup of an E-way expansion, a stable argsort)."""
    order = torch.argsort(ids, dim=1, stable=True)
    srt = torch.gather(ids, 1, order)
    first = torch.ones_like(ids, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    return torch.empty_like(first).scatter_(1, order, first)


def check_expand(expand: int, width: int, L: int, card: bool) -> None:
    """The E-way expansion's limits: 1 <= E <= the beam's width (the JAX
    package's ``lax.top_k`` refuses more), and on the card E * L <= 256
    new entries a step (``MAX_NEW``, the kernels' sort and merge)."""
    if not 1 <= expand <= width:
        raise ValueError(f"PGV_BEAM_EXPAND must be in [1, {width}] (the "
                         f"beam's width; got {expand})")
    if card and expand * L > MAX_NEW:
        raise ValueError(f"the walk kernels take E * L <= {MAX_NEW} new "
                         f"entries a step (got E = {expand}, L = {L})")


def lexsort2(primary, secondary):
    """Permutation sorting rows by (primary, secondary) ascending, ties in
    input order (``lax.sort`` with ``num_keys=2``)."""
    o2 = torch.argsort(secondary, dim=1, stable=True)
    o1 = torch.argsort(torch.gather(primary, 1, o2), dim=1, stable=True)
    return torch.gather(o2, 1, o1)


def _walk_plain(values, neighbors0, traversable, excluded, metric, q,
                seed_ids, seed_d, width: int, spill: int, max_steps: int,
                scan: bool, expand: int = 1, visited: bool = False,
                rank=None):
    """Plain version of the kernel: a batched per-step loop whose finished
    queries are frozen by masks. Returns the raw state (beam dists, keys
    [B, width]; spill dists, keys [B, spill]; steps [B]; scored [B], the
    rows read: live, not excluded, not visited neighbours of the expanded
    members).

    The JAX package's variants: ``expand`` E pops the E nearest unexpanded
    members a step and drops repeats within the step's E * L neighbours
    (first copy kept); ``visited`` keeps a per-query bitmap of every id
    seen (seeds included) that masks neighbours in place of the in-beam
    dedup (serving only); ``rank`` (bf16 rows [cap+1, D]) ranks new
    candidates by ``rank_dists`` and re-scores the surviving beam in f32
    at the end (the spill keeps its ranking distances)."""
    B, S = seed_ids.shape
    dev = seed_ids.device
    cap = traversable.shape[0] - 1
    W, E = width, expand
    beam_d = torch.full((B, W), _INF, device=dev)
    beam_key = torch.full((B, W), -2, dtype=torch.int64, device=dev)
    sp_d = torch.full((B, spill), _INF, device=dev)
    sp_key = torch.full((B, spill), -2, dtype=torch.int64, device=dev)
    ids64 = seed_ids.long()
    if scan:
        # the nearest min(S, W) admitted seeds enter the beam; the overflow
        # goes straight to the spill (still-unexplored candidates)
        safe = ids64.clamp(0, cap)
        ok = ((ids64 >= 0) & traversable[safe]
              & ~torch.gather(excluded, 1, safe))
        d0 = torch.where(ok, seed_d.float(), _INF)
        k0 = torch.where(ok, ids64 * 2 + 1, -2)
        perm = lexsort2(d0, k0)
        d0, k0 = torch.gather(d0, 1, perm), torch.gather(k0, 1, perm)
        nb = min(S, W)
        beam_d[:, :nb], beam_key[:, :nb] = d0[:, :nb], k0[:, :nb]
        ov = min(S - nb, spill)
        if ov > 0:
            sp_d[:, :ov], sp_key[:, :ov] = d0[:, nb:nb + ov], k0[:, nb:nb + ov]
    else:
        ok = ids64 >= 0
        beam_d[:, :S] = torch.where(ok, seed_d.float(), _INF)
        beam_key[:, :S] = torch.where(ok, ids64 * 2 + 1, -2)
    seen = None
    if visited:
        seen = torch.zeros((B, cap + 1), dtype=torch.bool, device=dev)
        seen.scatter_(1, torch.where(ok, ids64, cap), ok)
    steps = torch.zeros(B, dtype=torch.int32, device=dev)
    scored = torch.zeros(B, dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)

    def unexpanded():
        return torch.where(beam_key & 1 == 1, beam_d, _INF)

    it = 0
    while True:
        unexp = unexpanded()
        best = unexp.min(dim=1).values
        furthest = beam_d.max(dim=1).values  # inf while not full
        active = (best <= furthest) & torch.isfinite(best) & (steps < max_steps)
        if it % _SYNC_EVERY == 0 and not bool(active.any()):
            break
        it += 1
        if E == 1:
            pos = torch.argmin(unexp, dim=1)[:, None]
        else:  # lax.top_k(-unexp, E): lower slot first at equal distance
            pos = torch.argsort(unexp, dim=1, stable=True)[:, :E]
        sel_valid = torch.isfinite(torch.gather(unexp, 1, pos)) & active[:, None]
        key_pos = torch.gather(beam_key, 1, pos)
        u = torch.where(sel_valid, key_pos >> 1, -1)
        new_key = beam_key.scatter(1, pos, torch.where(sel_valid,
                                                       key_pos & ~1, key_pos))

        nbrs = neighbors0[u.clamp(min=0)].long()  # [B, E, L]
        nbrs = torch.where(sel_valid[:, :, None], nbrs, -1).reshape(B, -1)
        safe = nbrs.clamp(0, cap)
        mask = (nbrs >= 0) & traversable[safe]
        if scan:
            mask = mask & ~torch.gather(excluded, 1, safe)
        if seen is not None:
            mask = mask & ~torch.gather(seen, 1, safe)
            seen.scatter_(1, torch.where(nbrs >= 0, nbrs, cap), True)
        if E > 1:
            mask = mask & first_copies(nbrs)
        scored = scored + mask.sum(dim=1, dtype=torch.int32)
        dist = (rank_dists(rank, metric, q, nbrs) if rank is not None
                else row_dists(values, metric, q, nbrs))
        d_new = torch.where(mask, dist, _INF)
        key_new = torch.where(mask, nbrs * 2 + 1, -2)

        all_d = torch.cat([beam_d, d_new], dim=1)
        all_key = torch.cat([new_key, key_new], dim=1)
        if seen is None:
            # in-beam dedup by id, expanded copy first (key order IS the
            # dedup order): later copies keep their key at an infinite
            # distance
            all_key, order = torch.sort(all_key, dim=1, stable=True)
            all_d = torch.gather(all_d, 1, order)
            dup = torch.zeros_like(all_key, dtype=torch.bool)
            dup[:, 1:] = (all_key[:, 1:] >> 1) == (all_key[:, :-1] >> 1)
            all_d = torch.where(dup | (all_key < 0), _INF, all_d)
        perm = lexsort2(all_d, all_key)
        head = perm[:, :W]
        nd, nk = torch.gather(all_d, 1, head), torch.gather(all_key, 1, head)
        if scan:
            # the evicted tail merges into the spill (the discarded heap's
            # role), which keeps its `spill` nearest
            tail = perm[:, W:]
            m_d = torch.cat([sp_d, torch.gather(all_d, 1, tail)], dim=1)
            m_k = torch.cat([sp_key, torch.gather(all_key, 1, tail)], dim=1)
            p2 = lexsort2(m_d, m_k)[:, :spill]
            sp_d = torch.where(active[:, None], torch.gather(m_d, 1, p2), sp_d)
            sp_key = torch.where(active[:, None], torch.gather(m_k, 1, p2),
                                 sp_key)
        beam_d = torch.where(active[:, None], nd, beam_d)
        beam_key = torch.where(active[:, None], nk, beam_key)
        steps = steps + active.to(torch.int32)
    if rank is not None:
        # the surviving beam's exact f32 distances (the bf16 ones only
        # steered the walk)
        ids = torch.where(beam_key >= 0, beam_key >> 1, -1)
        beam_d = torch.where(ids >= 0, row_dists(values, metric, q, ids),
                             _INF)
    return beam_d, beam_key, sp_d, sp_key, steps, scored


def _walk_cuda(values, neighbors0, traversable, excluded, metric, q,
               seed_ids, seed_d, width: int, spill: int, max_steps: int,
               scan: bool, expand: int = 1, visited: bool = False,
               rank=None):
    """The kernel: one launch for the whole walk of every query. It takes
    ``_walk_plain``'s arguments but serves only (no exclusion mask, no
    spill: a scan segment is K5, ``scan_segment``); the spill it returns
    is empty."""
    if scan or excluded is not None or spill:
        raise ValueError("the walk kernel serves only; a scan segment is "
                         "K5 (scan_segment)")
    return _launch_walk(values, neighbors0, traversable, metric, q, seed_ids,
                        seed_d, width, max_steps, expand=expand,
                        visited=visited, rank=rank)[0]


def visited_words(cap: int) -> int:
    """32-bit words of a query's visited bitmap over rows 0 .. cap."""
    return -(-(cap + 1) // 32)


#: (device, stream) -> the zeroed int32 words the visited walks of that
#: stream borrow (the largest call's B * visited_words(cap)); a launch
#: leaves them zero, so no call clears its bitmaps, and two streams never
#: share one
_VISITED_SCRATCH: dict = {}


def visited_scratch(dev, words: int):
    """``words`` zeroed int32 words of ``dev``'s current stream's visited
    scratch, grown (a fresh zeroed buffer) when a call needs more."""
    stream = torch.cuda.current_stream(dev)
    key = (stream.device, stream.cuda_stream)
    buf = _VISITED_SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(words, dtype=torch.int32, device=dev)
        _VISITED_SCRATCH[key] = buf
    return buf


def _launch_walk(values, neighbors0, traversable, metric, q, seed_ids,
                 seed_d, width: int, max_steps: int, descent=None,
                 expand: int = 1, visited: bool = False, rank=None):
    """One launch of K4: the raw walk state (beam dists, keys [B, width];
    an empty spill; steps [B]; rows scored [B]) and, with ``descent`` =
    (upper_slot, upper_neighbors, m, entry, entry_level), the greedy
    descent in the launch seeding each query's walk (``seed_ids`` [B, 1]
    and ``seed_d`` are then not read) and its landing [B, 4] int32 (id,
    the distance's f32 bits, rows scored, moves); else None. ``expand``,
    ``visited`` and ``rank`` (the bf16 rows; ``values`` are then the f32
    rows the beam is re-scored from) are ``_walk_plain``'s; ``visited``
    borrows [B, visited_words(cap)] words of the stream's zeroed scratch
    (``visited_scratch``), which the launch leaves zero."""
    from . import _build

    is_sparse = isinstance(values, tuple)
    values2 = None
    if is_sparse:
        values, values2 = values
        if values.dtype != torch.int32 or values2.dtype != torch.float32:
            raise ValueError("sparse rows are (int32 indices, f32 values)")
        if values2.shape != values.shape or values2.stride() != \
                values.stride() or values2.device != values.device:
            raise ValueError("sparse row indices and values must match in "
                             "shape, strides and device")
    dev = values.device
    if not values.is_cuda or values.dim() != 2 or values.stride(1) != 1:
        raise ValueError("values must be a CUDA [rows, D] tensor whose rows "
                         "are contiguous")
    if values.dtype not in _DTYPE_CODES:
        raise ValueError(f"values must be f32, f16 or bf16, or int32 words "
                         f"(got {values.dtype})")
    words = metric in bits.BIT_METRICS
    if words != (values.dtype == torch.int32 and not is_sparse):
        raise ValueError(f"metric {metric!r} does not take {values.dtype} "
                         "rows (the bit metrics walk int32 words)")
    exact = None
    if rank is not None:
        if (values.dtype != torch.float32 or rank.dtype != torch.bfloat16
                or metric not in ("l2", "ip", "cosine") or not rank.is_cuda
                or rank.device != dev or rank.dim() != 2
                or rank.stride(1) != 1 or rank.shape[1] != values.shape[1]
                or rank.shape[0] < values.shape[0]):
            raise ValueError("bf16 ranking takes f32 rows, their bf16 copy "
                             "on the same card and l2, ip or cosine")
        exact, values = values, rank
    if is_sparse:
        qi, qv = q
        _check_cuda("query indices", qi, torch.int32, 2, dev)
        _check_cuda("query values", qv, torch.float32, 2, dev)
        if qv.shape != qi.shape:
            raise ValueError("query indices and values differ in shape")
        # the kernel's query row: P indices, then the bits of P values
        q = torch.cat([qi, qv.view(torch.int32)], dim=1)
    _check_cuda("neighbors0", neighbors0, torch.int32, 2, dev)
    _check_cuda("traversable", traversable, torch.bool, 1, dev)
    _check_cuda("queries", q,
                torch.int32 if words or is_sparse else torch.float32, 2, dev)
    _check_cuda("seed_ids", seed_ids, torch.int32, 2, dev)
    _check_cuda("seed_d", seed_d, torch.float32, 2, dev)
    cap = traversable.shape[0] - 1
    B, S = seed_ids.shape
    d = values.shape[1]
    qd = 2 * d if is_sparse else d
    L = neighbors0.shape[1]
    if (neighbors0.shape[0] != cap + 1 or values.shape[0] < cap + 1
            or q.shape != (B, qd) or seed_d.shape != (B, S)):
        raise ValueError(
            f"shape mismatch: values {tuple(values.shape)}, neighbors0 "
            f"{tuple(neighbors0.shape)}, traversable {cap + 1}, queries "
            f"{tuple(q.shape)}, seeds {tuple(seed_ids.shape)}")
    if cap >= 1 << 30:
        raise ValueError("packed beam keys need cap < 2^30 rows")
    if metric not in _METRIC_CODES:
        raise ValueError(f"bad metric {metric}")
    if S > width:
        raise ValueError(f"{S} seeds do not fit a beam of width {width}")
    check_expand(expand, width, L, card=True)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    beam_d = torch.empty((B, width), **f32)
    beam_key = torch.empty((B, width), **i32)
    steps = torch.empty((B,), **i32)
    scored = torch.empty((B,), **i32)
    vwords = visited_words(cap) if visited else 0
    land = None
    upper = (None, None, 0, 0, -1, 0)
    if descent is not None:
        upper_slot, upper_nb, m, entry, entry_level = descent
        _check_cuda("upper_slot", upper_slot, torch.int32, 1, dev)
        _check_cuda("upper_neighbors", upper_nb, torch.int32, 2, dev)
        if (S != 1 or upper_slot.shape[0] != cap + 1 or not 1 <= m <= L
                or upper_nb.shape[1] < max(entry_level, 0) * m
                or entry > cap):
            raise ValueError(
                f"the descent takes one seed per query, upper_slot of "
                f"{cap + 1} rows, 1 <= m <= {L} and {entry_level} layers of "
                f"m ids (got {S} seeds, {upper_slot.shape[0]} rows, m = {m}, "
                f"upper rows of {upper_nb.shape[1]}, entry {entry})")
        land = torch.empty((B, 4), **i32)
        upper = (upper_slot.data_ptr(), upper_nb.data_ptr(),
                 upper_nb.stride(0), m, entry, entry_level)
    if B:
        with torch.cuda.device(dev):
            seen = visited_scratch(dev, B * vwords) if visited else None
            rc = _build.lib().pgv_k4_beam_walk(
                values.data_ptr(),
                values2.data_ptr() if is_sparse else None,
                _SPARSE_ROWS if is_sparse else _DTYPE_CODES[values.dtype],
                values.stride(0), d, qd, neighbors0.data_ptr(), L,
                traversable.data_ptr(), cap, _METRIC_CODES[metric],
                q.data_ptr(), seed_ids.data_ptr(), seed_d.data_ptr(), B, S,
                width, max_steps, beam_d.data_ptr(), beam_key.data_ptr(),
                steps.data_ptr(), scored.data_ptr(), *upper,
                land.data_ptr() if land is not None else None, expand,
                seen.data_ptr() if visited else None, vwords,
                exact.data_ptr() if exact is not None else None,
                exact.stride(0) if exact is not None else 0,
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(rc, "pgv_k4_beam_walk")
        LAUNCHES["k4_beam_sparse" if is_sparse else "k4_beam"] += 1
    sp_d = torch.empty((B, 0), **f32)
    return (beam_d, beam_key.long(), sp_d, sp_d.long(), steps, scored), land


def _walk(values, neighbors0, *args, **kw):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    return (_walk_cuda if neighbors0.is_cuda else _walk_plain)(
        values, neighbors0, *args, **kw)


def beam_walk(values, neighbors0, traversable, metric: str, q, seed_ids,
              seed_d, ef: int, max_steps: int, expand: int = 1,
              visited: bool = False, rank=None):
    """K4: best-first beam of width ``ef`` at layer 0 for a batch of
    queries ``q`` [B, D] (bit metrics: packed int32 words, over the words
    ``values``; sparse rows: ``values`` and ``q`` are (indices, values)
    pairs). ``seed_ids`` [B, S] (S <= ef, -1 = unused) and
    their exact distances ``seed_d`` seed the beam. Each step expands the
    nearest unexpanded member (the ``expand`` nearest), scores its live
    neighbours, dedups by id and keeps the ef nearest; a query stops when
    its nearest unexpanded candidate is farther than its furthest member
    (graph/mod.rs:186-192), or after ``max_steps``. ``visited``: a
    per-query bitmap of the ids seen replaces the in-beam dedup; ``rank``:
    the bf16 rows that rank new candidates (``rank_dists``), the beam
    re-scored from ``values`` at the end.

    Returns (dists [B, ef], ids [B, ef] int64, steps [B] int32), sorted by
    (distance, id)."""
    check_expand(expand, ef, neighbors0.shape[1], neighbors0.is_cuda)
    raw = _walk(values, neighbors0, traversable, None, metric,
                _queries(q, metric),
                seed_ids.to(torch.int32).contiguous(),
                seed_d.float().contiguous(), width=ef, spill=0,
                max_steps=max_steps, scan=False, expand=expand,
                visited=visited, rank=rank)
    return _serve_finish(*raw)


def descent_plain(values, traversable, upper_slot, upper_neighbors,
                  m: int, metric: str, q, entry: int, entry_level: int,
                  rank=None):
    """Plain version of the descent in K4's launch, the JAX package's
    ``_greedy_descent`` (``pgvector_rx_tpu/graph/device.py:386``) from the
    entry for every query: at each layer ``entry_level .. 1``, score the
    current node's ``m`` neighbours at that layer where valid (``nbr >= 0``,
    an upper slot, ``traversable``), move to the first of their minimum
    while it is strictly nearer (a host check per move). With ``rank``
    (bf16 rows) the neighbours are scored by ``rank_dists``, the entry
    exactly, as JAX's descent ranks. Returns (landing ids [B] int64, their
    distances [B] f32)."""
    lead = q[0] if isinstance(q, tuple) else q
    B, dev = lead.shape[0], lead.device
    cap = traversable.shape[0] - 1
    rows = torch.arange(B, device=dev)
    cur = torch.full((B,), entry, dtype=torch.int64, device=dev)
    cur_d = row_dists(values, metric, q, cur[:, None])[:, 0]
    for layer in range(entry_level, 0, -1):
        off = (layer - 1) * m
        moved = torch.ones_like(cur, dtype=torch.bool)
        while bool(moved.any()):
            slot = upper_slot[cur.long()]
            nbrs = upper_neighbors[slot.clamp(min=0).long(), off : off + m]
            valid = ((nbrs >= 0) & (slot >= 0)[:, None]
                     & traversable[nbrs.clamp(0, cap).long()])
            dist = (rank_dists(rank, metric, q, nbrs) if rank is not None
                    else row_dists(values, metric, q, nbrs))
            d = torch.where(valid, dist, _INF)
            best = torch.argmin(d, dim=1)  # the first minimal slot
            best_d = d[rows, best]
            moved = moved & (best_d < cur_d)
            cur = torch.where(moved, nbrs[rows, best].long(), cur)
            cur_d = torch.where(moved, best_d, cur_d)
    return cur, cur_d


def descent_walk(values, neighbors0, traversable, upper_slot,
                 upper_neighbors, m: int, entry: int, entry_level: int,
                 metric: str, q, ef: int, max_steps: int, expand: int = 1,
                 visited: bool = False, rank=None):
    """K4 with the greedy upper-layer descent in its launch: the JAX
    package's ``_search_batch`` (``pgvector_rx_tpu/graph/device.py:767``)
    and ``_search_one_sparse`` (``:1861``), the descent from ``entry``
    (level ``entry_level``) through ``upper_neighbors`` [U, LMAX * m]
    (``upper_slot`` [cap + 1]: a node's row, -1 none) then the walk of
    :func:`beam_walk` from where each query lands (``expand``, ``visited``
    and ``rank`` as there; ``rank`` also ranks the descent). Every row
    mode (dense rows, packed words, sparse rows). CUDA tensors: one launch;
    CPU tensors: ``descent_plain`` then the plain walk.

    Returns (dists [B, ef], ids [B, ef] int64, steps [B] int32, landing
    ids [B] int64, landing distances [B] f32)."""
    q = _queries(q, metric)
    lead = q[0] if isinstance(q, tuple) else q
    B, dev = lead.shape[0], lead.device
    check_expand(expand, ef, neighbors0.shape[1], neighbors0.is_cuda)
    if neighbors0.is_cuda:
        seeds = torch.full((B, 1), -1, dtype=torch.int32, device=dev)
        raw, land = _launch_walk(
            values, neighbors0, traversable, metric, q, seeds,
            torch.zeros((B, 1), dtype=torch.float32, device=dev), ef,
            max_steps, (upper_slot, upper_neighbors, m, entry, entry_level),
            expand=expand, visited=visited, rank=rank)
        land_ids = land[:, 0].long()
        land_d = land[:, 1].contiguous().view(torch.float32)
    else:
        land_ids, land_d = descent_plain(values, traversable, upper_slot,
                                         upper_neighbors, m, metric, q,
                                         entry, entry_level, rank=rank)
        raw = _walk_plain(values, neighbors0, traversable, None, metric, q,
                          land_ids[:, None].to(torch.int32),
                          land_d[:, None].float(), width=ef, spill=0,
                          max_steps=max_steps, scan=False, expand=expand,
                          visited=visited, rank=rank)
    return (*_serve_finish(*raw), land_ids, land_d)


def _serve_finish(beam_d, beam_key, sp_d, sp_key, steps, scored=None):
    """K4's outputs from the walk's raw state: ids, sorted by (d, id)
    (the rows scored are not among them)."""
    ids = torch.where(beam_key >= 0, beam_key >> 1, -1)
    perm = lexsort2(beam_d, ids)
    return torch.gather(beam_d, 1, perm), torch.gather(ids, 1, perm), steps


#: a K5 block's shared memory limit (k4_beam.cu's kMaxSmem)
_K5_MAX_SMEM = 232448


def _k5_words(cap: int) -> int:
    """32-bit words of a query's allowed-row bitmap over rows 0 .. cap, a
    multiple of 4 (16-byte copies)."""
    return -(-(cap + 1) // 128) * 4


def _k5_smem(words: int, d: int, L: int, S: int, W: int, ef: int,
             SP: int, expand: int = 1, rank: bool = False) -> int:
    """A K5 block's shared memory in bytes (mirrors k4_beam.cu's
    scan_smem_bytes): the bitmap, the query (and its bf16 rounding when
    ranking in bf16), two beams, the spill's pool (a power of two >= 2 SP,
    SP + E L and 64), the E L new entries (raw and kept), two id sets (the
    beam's, the seeds' / finish's with its first indices) of 2^bits slots,
    the seeds' / finish's buffer (also the re-scored beam's sort when
    ranking in bf16) and, for E > 1, the E members a step expands, the
    beam's first E unexpanded members, the step's E L compacted rows and
    their 64-bit rank keys; the pool is SP + 4 E L wide at E > 1."""
    def pow2(n):
        return 1 << max(n - 1, 0).bit_length()

    nl = expand * L
    mm = SP + W - ef
    bits = 6
    while (1 << bits) < 2 * max(W + nl, S, mm):
        bits += 1
    buf = max(pow2(S), SP + 2 * (W - ef), pow2(W) if rank else 0)
    pool = pow2(max(64, 2 * SP, SP + (4 if expand > 1 else 1) * nl))
    dpad = -(-d // 4) * 4
    return 4 * (words + dpad * (2 if rank else 1) + 4 * W + 2 * pool
                + 4 * nl + 3 * (1 << bits) + 2 * buf
                + (2 * expand + nl + 2 * (nl + 2) if expand > 1 else 0))


def k5_bitmap_fits(cap: int, d: int, L: int, S: int, W: int, ef: int,
                   SP: int, expand: int = 1, rank: bool = False) -> bool:
    """K5's rule for the flags: a query's (cap + 1)-bit bitmap of the rows
    it may walk is staged in shared memory when it fits there beside the
    segment's state (about 1.6M rows at the scan's defaults); above that
    the kernel reads the global flags."""
    return _k5_smem(_k5_words(cap), d, L, S, W, ef, SP, expand,
                    rank) <= _K5_MAX_SMEM


def allowed_bits(traversable, excluded):
    """The bitmap K5 stages: bit v of query b's words (int32 [B, words], the
    bits of uint32 words) set where row v is traversable and not
    excluded."""
    ok = traversable[None, :] & ~excluded
    b, n = ok.shape
    words = _k5_words(n - 1)
    ok = torch.nn.functional.pad(ok, (0, words * 32 - n))
    shift = torch.arange(32, dtype=torch.int64, device=ok.device)
    w = (ok.view(b, words, 32).long() << shift).sum(-1)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def staged_bitmap(values, neighbors0, traversable, excluded, S: int, W: int,
                  ef: int, SP: int, expand: int = 1, rank: bool = False):
    """The bitmap K5 stages for the queries of ``excluded`` [B, cap + 1]
    (``allowed_bits``) where its rule stages one: dense rows on the card
    and ``k5_bitmap_fits``; else None (the kernel reads the flags, and the
    plain version never takes a bitmap)."""
    if not (neighbors0.is_cuda and torch.is_tensor(values)
            and k5_bitmap_fits(traversable.shape[0] - 1, values.shape[1],
                               neighbors0.shape[1], S, W, ef, SP, expand,
                               rank)):
        return None
    return allowed_bits(traversable, excluded)


def mark_excluded(excluded, ids):
    """Set the emitted ids [B, k] in the exclusion masks [B, cap + 1], IN
    PLACE; invalid (-1) ids land on the pad row ``cap``, which is never
    walked. Returns ``excluded``."""
    pad = excluded.shape[1] - 1
    return excluded.scatter_(1, torch.where(ids >= 0, ids, pad).long(), True)


def _scan_plain(values, neighbors0, traversable, excluded, metric, q,
                seed_ids, seed_d, ef: int, width: int, spill: int,
                max_steps: int, mark: bool, expand: int = 1, rank=None):
    """Plain version of K5: the plain walk, ``_scan_finish``, the marks,
    and the report."""
    raw = _walk_plain(values, neighbors0, traversable, excluded, metric, q,
                      seed_ids, seed_d, width=width, spill=spill,
                      max_steps=max_steps, scan=True, expand=expand,
                      rank=rank)
    beam_d, beam_ids, sp_d, sp_ids, steps = _scan_finish(*raw, ef=ef,
                                                         spill=spill)
    if mark:
        mark_excluded(excluded, beam_ids)
    # an id at an infinite distance is no emission (the kernel keeps only
    # finite entries; such an id is also in the beam at a finite one)
    beam_ids = torch.where(torch.isfinite(beam_d), beam_ids, -1)
    report = torch.cat([beam_d.view(torch.int32), beam_ids.to(torch.int32),
                        steps[:, None], raw[5][:, None],
                        (sp_ids >= 0).sum(1, dtype=torch.int32)[:, None]],
                       dim=1)
    return report, sp_d, sp_ids.to(torch.int32)


def _scan_cuda(values, neighbors0, traversable, excluded, allowed, metric,
               q, seed_ids, seed_d, ef: int, width: int, spill: int,
               max_steps: int, mark: bool, expand: int = 1, rank=None):
    """K5: one launch walks every query's segment and finishes it."""
    from . import _build

    if isinstance(values, tuple) or values.dtype not in (
            torch.float32, torch.float16, torch.bfloat16):
        raise ValueError("the scan mode walks dense rows only (f32, f16 or "
                         "bf16)")
    dev = values.device
    if not values.is_cuda or values.dim() != 2 or values.stride(1) != 1:
        raise ValueError("values must be a CUDA [rows, D] tensor whose rows "
                         "are contiguous")
    if metric not in ("l2", "ip", "cosine", "l1"):
        raise ValueError(f"the scan takes l2, ip, cosine or l1 (got "
                         f"{metric!r})")
    exact = None
    if rank is not None:
        if (values.dtype != torch.float32 or rank.dtype != torch.bfloat16
                or metric == "l1" or not rank.is_cuda or rank.device != dev
                or rank.dim() != 2 or rank.stride(1) != 1
                or rank.shape[1] != values.shape[1]
                or rank.shape[0] < values.shape[0]):
            raise ValueError("bf16 ranking takes f32 rows, their bf16 copy "
                             "on the same card and l2, ip or cosine")
        exact, values = values, rank
    _check_cuda("neighbors0", neighbors0, torch.int32, 2, dev)
    _check_cuda("traversable", traversable, torch.bool, 1, dev)
    _check_cuda("excluded", excluded, torch.bool, 2, dev)
    _check_cuda("queries", q, torch.float32, 2, dev)
    _check_cuda("seed_ids", seed_ids, torch.int32, 2, dev)
    _check_cuda("seed_d", seed_d, torch.float32, 2, dev)
    cap = traversable.shape[0] - 1
    B, S = seed_ids.shape
    d = values.shape[1]
    L = neighbors0.shape[1]
    if (neighbors0.shape[0] != cap + 1 or values.shape[0] < cap + 1
            or q.shape != (B, d) or seed_d.shape != (B, S)
            or excluded.shape != (B, cap + 1)):
        raise ValueError(
            f"shape mismatch: values {tuple(values.shape)}, neighbors0 "
            f"{tuple(neighbors0.shape)}, traversable {cap + 1}, queries "
            f"{tuple(q.shape)}, seeds {tuple(seed_ids.shape)}, excluded "
            f"{tuple(excluded.shape)}")
    if cap >= 1 << 30:
        raise ValueError("packed beam keys need cap < 2^30 rows")
    check_expand(expand, width, L, card=True)
    words = 0
    if allowed is not None:
        words = _k5_words(cap)
        _check_cuda("allowed", allowed, torch.int32, 2, dev)
        if allowed.shape != (B, words):
            raise ValueError(f"allowed must be [{B}, {words}] (got "
                             f"{tuple(allowed.shape)})")
    if _k5_smem(words, d, L, S, width, ef, spill, expand,
                rank is not None) > _K5_MAX_SMEM:
        raise ValueError("the scan segment's state does not fit a block")
    report = torch.empty((B, 2 * ef + 3), dtype=torch.int32, device=dev)
    sp_d = torch.empty((B, spill), dtype=torch.float32, device=dev)
    sp_ids = torch.empty((B, spill), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().pgv_k5_beam_scan(
            values.data_ptr(), _DTYPE_CODES[values.dtype], values.stride(0),
            d, neighbors0.data_ptr(), L, traversable.data_ptr(),
            excluded.data_ptr(), excluded.stride(0),
            allowed.data_ptr() if allowed is not None else None, words, cap,
            _METRIC_CODES[metric], q.data_ptr(), seed_ids.data_ptr(),
            seed_d.data_ptr(), B, S, width, ef, spill, max_steps, int(mark),
            report.data_ptr(), sp_d.data_ptr(), sp_ids.data_ptr(), expand,
            exact.data_ptr() if exact is not None else None,
            exact.stride(0) if exact is not None else 0,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "pgv_k5_beam_scan")
    LAUNCHES["k5_beam_scan"] += 1
    return report, sp_d, sp_ids


def scan_segment(values, neighbors0, traversable, excluded, metric: str, q,
                 seed_ids, seed_d, ef: int, width: int, spill: int,
                 max_steps: int, allowed=None, mark: bool = False,
                 expand: int = 1, rank=None):
    """K5: one iterative-scan segment for a batch of queries ``q`` [B, D]:
    the beam walk at internal width ``width`` (>= ef) from seeds
    ``seed_ids`` [B, S] (-1 = unused) under ``excluded`` [B, cap+1]
    (already-emitted rows), capturing the evicted candidates in a spill
    buffer of width ``spill``, then the segment's finish. ``expand`` E
    pops the E nearest unexpanded members a step (the evicted tail is then
    E L entries); ``rank`` (the bf16 rows) ranks new candidates in bf16
    and re-scores the beam in f32 before the finish (the spill keeps its
    ranking distances).

    Returns (report [B, 2 ef + 3] int32: the emitted beam's distances as
    f32 bits [:ef] and ids [ef:2ef] (-1 at an infinite distance), sorted by
    (distance, id), then steps,
    rows scored and the spill's entries kept; spill dists [B, spill]; spill
    ids [B, spill] int32): the spill sorted likewise, deduplicated by id
    (nearest copy), without the ids of the emitted beam and with the
    width - ef leftover of the beam merged in (still fuel for the next
    segment); empty slots are (inf, -1). ``mark``: set the emitted ids in
    ``excluded`` (in place). ``allowed`` [B, words] (CUDA only,
    ``allowed_bits``): the staged bitmap the kernel reads instead of the
    flags, kept equal to ``traversable & ~excluded`` under ``mark``;
    ``None`` reads the flags."""
    W = max(width, ef)
    check_expand(expand, W, neighbors0.shape[1], neighbors0.is_cuda)
    seed_ids = seed_ids.to(torch.int32).contiguous()
    seed_d = seed_d.float().contiguous()
    q = _queries(q, metric)
    if neighbors0.is_cuda:
        return _scan_cuda(values, neighbors0, traversable, excluded,
                          allowed, metric, q, seed_ids, seed_d, ef, W, spill,
                          max_steps, mark, expand, rank)
    if allowed is not None:
        raise ValueError("the staged bitmap is the kernel's (CUDA only)")
    return _scan_plain(values, neighbors0, traversable, excluded, metric, q,
                       seed_ids, seed_d, ef, W, spill, max_steps, mark,
                       expand, rank)


def beam_scan_segment(values, neighbors0, traversable, excluded, metric: str,
                      q, seed_ids, seed_d, ef: int, width: int, spill: int,
                      max_steps: int, expand: int = 1, rank=None):
    """K5 (``scan_segment``) with its report unpacked: (beam dists [B, ef],
    beam ids [B, ef], spill dists [B, spill], spill ids [B, spill], steps
    [B]). The bitmap is staged by ``staged_bitmap``'s rule; nothing is
    marked."""
    allowed = staged_bitmap(values, neighbors0, traversable, excluded,
                            seed_ids.shape[1], max(width, ef), ef, spill,
                            expand, rank is not None)
    report, sp_d, sp_ids = scan_segment(
        values, neighbors0, traversable, excluded, metric, q, seed_ids,
        seed_d, ef, width, spill, max_steps, allowed, expand=expand,
        rank=rank)
    return (report[:, :ef].view(torch.float32), report[:, ef:2 * ef], sp_d,
            sp_ids, report[:, 2 * ef])


def _scan_finish(beam_d, beam_key, sp_d, sp_key, steps, scored=None, *,
                 ef: int, spill: int):
    """The segment's outputs from the walk's raw state (tpu:graph/
    device.py:684-720): the emitted top-ef, and the spill with the beam's
    leftover merged in and deduplicated (the rows scored are not among
    them)."""
    ids_w = torch.where(beam_key >= 0, beam_key >> 1, -1)
    perm = lexsort2(beam_d, ids_w)
    beam_d, ids_w = torch.gather(beam_d, 1, perm), torch.gather(ids_w, 1, perm)
    beam_ids = ids_w[:, :ef]
    if beam_d.shape[1] > ef:
        left = ids_w[:, ef:]
        sp_d = torch.cat([sp_d, beam_d[:, ef:]], dim=1)
        sp_key = torch.cat([sp_key, torch.where(left >= 0, left * 2 + 1, -2)],
                           dim=1)
    sp_ids = torch.where(sp_key >= 0, sp_key >> 1, -1)
    perm = lexsort2(sp_ids, sp_d)
    o_ids, o_d = torch.gather(sp_ids, 1, perm), torch.gather(sp_d, 1, perm)
    dup = torch.zeros_like(o_ids, dtype=torch.bool)
    dup[:, 1:] = o_ids[:, 1:] == o_ids[:, :-1]
    in_beam = ((o_ids[:, :, None] == beam_ids[:, None, :])
               & (beam_ids >= 0)[:, None, :]).any(dim=2)
    o_d = torch.where(dup | in_beam | (o_ids < 0), _INF, o_d)
    perm = lexsort2(o_d, o_ids)[:, :spill]
    sp_d, sp_ids = torch.gather(o_d, 1, perm), torch.gather(o_ids, 1, perm)
    sp_ids = torch.where(torch.isfinite(sp_d), sp_ids, -1)
    return beam_d[:, :ef], beam_ids, sp_d, sp_ids, steps

