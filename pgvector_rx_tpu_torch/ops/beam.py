"""The layer-0 best-first beam walk: kernels K4 (the beam engine) and K5
(one segment of the resumable beam scan), hand-written in CUDA for Hopper
(``csrc/k4_beam.cu``, one launch runs a whole walk), with their plain-torch
versions beside them.

They replace the JAX package's XLA while-loops ``_ground_beam_seeds`` (K4,
``pgvector_rx_tpu/graph/device.py:446``) and ``_beam_scan_segment`` (K5,
``:574``), at the defaults the port supports: one expansion per step,
in-beam dedup by id (the expanded copy wins) and f32 ranking. Rows are
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
- :func:`beam_scan_segment` (K5): the same walk under an exclusion mask,
  with an internal width ``width`` >= ef, seeds past the width sent to a
  spill buffer and the evicted candidates merged into it -> (beam dists
  [B, ef], beam ids [B, ef], spill dists [B, spill], spill ids [B, spill],
  steps [B]); the spill is deduplicated by id and holds no id of the
  emitted beam.

Both wrappers take the plain version only for tensors on the CPU; for a
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


def lexsort2(primary, secondary):
    """Permutation sorting rows by (primary, secondary) ascending, ties in
    input order (``lax.sort`` with ``num_keys=2``)."""
    o2 = torch.argsort(secondary, dim=1, stable=True)
    o1 = torch.argsort(torch.gather(primary, 1, o2), dim=1, stable=True)
    return torch.gather(o2, 1, o1)


def _walk_plain(values, neighbors0, traversable, excluded, metric, q,
                seed_ids, seed_d, width: int, spill: int, max_steps: int,
                scan: bool):
    """Plain version of the kernel: a batched per-step loop whose finished
    queries are frozen by masks. Returns the raw state (beam dists, keys
    [B, width]; spill dists, keys [B, spill]; steps [B]; scored [B], the
    rows read: live, not excluded neighbours of the expanded members)."""
    B, S = seed_ids.shape
    dev = seed_ids.device
    cap = traversable.shape[0] - 1
    W = width
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
        pos = torch.argmin(unexp, dim=1)
        sel_valid = torch.isfinite(unexp[rows, pos]) & active
        key_pos = beam_key[rows, pos]
        u = torch.where(sel_valid, key_pos >> 1, -1)
        new_key = beam_key.clone()
        new_key[rows, pos] = torch.where(sel_valid, key_pos & ~1, key_pos)

        nbrs = neighbors0[u.clamp(min=0)].long()  # [B, L]
        nbrs = torch.where(sel_valid[:, None], nbrs, -1)
        safe = nbrs.clamp(0, cap)
        mask = (nbrs >= 0) & traversable[safe]
        if scan:
            mask = mask & ~torch.gather(excluded, 1, safe)
        scored = scored + mask.sum(dim=1, dtype=torch.int32)
        d_new = torch.where(mask, row_dists(values, metric, q, nbrs), _INF)
        key_new = torch.where(mask, nbrs * 2 + 1, -2)

        all_d = torch.cat([beam_d, d_new], dim=1)
        all_key = torch.cat([new_key, key_new], dim=1)
        # in-beam dedup by id, expanded copy first (key order IS the dedup
        # order): later copies keep their key at an infinite distance
        o_key, order = torch.sort(all_key, dim=1, stable=True)
        o_d = torch.gather(all_d, 1, order)
        dup = torch.zeros_like(o_key, dtype=torch.bool)
        dup[:, 1:] = (o_key[:, 1:] >> 1) == (o_key[:, :-1] >> 1)
        o_d = torch.where(dup | (o_key < 0), _INF, o_d)
        perm = lexsort2(o_d, o_key)
        head = perm[:, :W]
        nd, nk = torch.gather(o_d, 1, head), torch.gather(o_key, 1, head)
        if scan:
            # the evicted tail merges into the spill (the discarded heap's
            # role), which keeps its `spill` nearest
            tail = perm[:, W:]
            m_d = torch.cat([sp_d, torch.gather(o_d, 1, tail)], dim=1)
            m_k = torch.cat([sp_key, torch.gather(o_key, 1, tail)], dim=1)
            p2 = lexsort2(m_d, m_k)[:, :spill]
            sp_d = torch.where(active[:, None], torch.gather(m_d, 1, p2), sp_d)
            sp_key = torch.where(active[:, None], torch.gather(m_k, 1, p2),
                                 sp_key)
        beam_d = torch.where(active[:, None], nd, beam_d)
        beam_key = torch.where(active[:, None], nk, beam_key)
        steps = steps + active.to(torch.int32)
    return beam_d, beam_key, sp_d, sp_key, steps, scored


def _walk_cuda(values, neighbors0, traversable, excluded, metric, q,
               seed_ids, seed_d, width: int, spill: int, max_steps: int,
               scan: bool):
    """The kernel: one launch for the whole walk of every query."""
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
    if (words or is_sparse) and scan:
        raise ValueError("the scan mode walks dense rows only")
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
    if scan:
        _check_cuda("excluded", excluded, torch.bool, 2, dev)
        if excluded.shape != (B, cap + 1):
            raise ValueError(f"excluded must be [{B}, {cap + 1}] (got "
                             f"{tuple(excluded.shape)})")
    elif S > width:
        raise ValueError(f"{S} seeds do not fit a beam of width {width}")
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    beam_d = torch.empty((B, width), **f32)
    beam_key = torch.empty((B, width), **i32)
    sp_d = torch.empty((B, spill), **f32)
    sp_key = torch.empty((B, spill), **i32)
    steps = torch.empty((B,), **i32)
    scored = torch.empty((B,), **i32)
    if B:
        with torch.cuda.device(dev):
            rc = _build.lib().pgv_k4_beam_walk(
                values.data_ptr(),
                values2.data_ptr() if is_sparse else None,
                _SPARSE_ROWS if is_sparse else _DTYPE_CODES[values.dtype],
                values.stride(0), d, qd, neighbors0.data_ptr(), L,
                traversable.data_ptr(),
                excluded.data_ptr() if scan else None,
                cap + 1 if scan else 0, cap, _METRIC_CODES[metric],
                q.data_ptr(), seed_ids.data_ptr(), seed_d.data_ptr(), B, S,
                width, spill, max_steps, int(scan), beam_d.data_ptr(),
                beam_key.data_ptr(), sp_d.data_ptr(), sp_key.data_ptr(),
                steps.data_ptr(), scored.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(rc, "pgv_k4_beam_walk")
        LAUNCHES["k5_beam_scan" if scan else
                 "k4_beam_sparse" if is_sparse else "k4_beam"] += 1
    return beam_d, beam_key.long(), sp_d, sp_key.long(), steps, scored


def _walk(values, neighbors0, *args, **kw):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    return (_walk_cuda if neighbors0.is_cuda else _walk_plain)(
        values, neighbors0, *args, **kw)


def beam_walk(values, neighbors0, traversable, metric: str, q, seed_ids,
              seed_d, ef: int, max_steps: int):
    """K4: best-first beam of width ``ef`` at layer 0 for a batch of
    queries ``q`` [B, D] (bit metrics: packed int32 words, over the words
    ``values``; sparse rows: ``values`` and ``q`` are (indices, values)
    pairs). ``seed_ids`` [B, S] (S <= ef, -1 = unused) and
    their exact distances ``seed_d`` seed the beam. Each step expands the
    nearest unexpanded member, scores its live neighbours, dedups by id
    and keeps the ef nearest; a query stops when its nearest unexpanded
    candidate is farther than its furthest member (graph/mod.rs:186-192),
    or after ``max_steps``.

    Returns (dists [B, ef], ids [B, ef] int64, steps [B] int32), sorted by
    (distance, id)."""
    raw = _walk(values, neighbors0, traversable, None, metric,
                _queries(q, metric),
                seed_ids.to(torch.int32).contiguous(),
                seed_d.float().contiguous(), width=ef, spill=0,
                max_steps=max_steps, scan=False)
    return _serve_finish(*raw)


def _serve_finish(beam_d, beam_key, sp_d, sp_key, steps, scored=None):
    """K4's outputs from the walk's raw state: ids, sorted by (d, id)
    (the rows scored are not among them)."""
    ids = torch.where(beam_key >= 0, beam_key >> 1, -1)
    perm = lexsort2(beam_d, ids)
    return torch.gather(beam_d, 1, perm), torch.gather(ids, 1, perm), steps


def beam_scan_segment(values, neighbors0, traversable, excluded, metric: str,
                      q, seed_ids, seed_d, ef: int, width: int, spill: int,
                      max_steps: int):
    """K5: one iterative-scan segment for a batch of queries: the beam walk
    at internal width ``width`` (>= ef) from seeds ``seed_ids`` [B, S]
    under ``excluded`` [B, cap+1] (already-emitted rows), capturing the
    evicted candidates in a spill buffer of width ``spill``.

    Returns (beam dists [B, ef], beam ids [B, ef], spill dists [B, spill],
    spill ids [B, spill], steps [B]): the beam sorted by (distance, id);
    the spill sorted likewise, deduplicated by id (nearest copy), without
    the ids of the emitted beam, and with the width - ef leftover of the
    beam merged in (still fuel for the next segment); empty slots are
    (inf, -1)."""
    W = max(width, ef)
    raw = _walk(values, neighbors0, traversable, excluded, metric,
                _queries(q, metric),
                seed_ids.to(torch.int32).contiguous(),
                seed_d.float().contiguous(), width=W, spill=spill,
                max_steps=max_steps, scan=True)
    return _scan_finish(*raw, ef=ef, spill=spill)


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

