"""Sparse distances of the PyTorch port over padded-CSR rows, and the
sparse sweep K10.

The counterpart of ``pgvector_rx_tpu/ops/sparse.py``. Each sparse row is
padded to a fixed non-zero budget ``P`` (HNSW caps nnz at 1,000,
hnsw_constants.rs:7): ``indices [N, P] int32`` sorted ascending and padded
with ``PAD_INDEX`` (int32 max, so rows stay sorted), ``values [N, P] f32``
padded with 0. Every metric reduces to terms over the matched pairs (a row
entry whose index the query holds too):

- dot    = sum over matches of qv * xv
- l2     = max(|q|^2 + |x|^2 - 2 dot, 0)
- ip     = -dot
- cosine = 1 - clip(dot / sqrt(|q|^2 |x|^2), -1, 1), similarity 0 when a
  norm is 0
- l1     = sum|q| + sum|x| + sum over matches of (|qv - xv| - |qv| - |xv|)

The plain functions find each row entry's matched query value in one of
two ways: a gather from the queries scattered dense (``pairwise_dense_q``,
when the dimension is known and the dense queries fit) or a binary search
in the query's sorted indices (``pairwise``, ``gathered``: any dimension).
Both chunk the rows so that no ``[B, N, P]`` temporary is made.

**K10** (``sparse_topk``): the exact top-k of those distances over the live
rows, in (distance, row) order with the two zeros tied, ``lax.top_k``'s
order. It replaces the XLA program ``_exact_search_sparse``
(``pgvector_rx_tpu/graph/device.py:1313``), which has no Pallas ancestor
and picks one of three formulations by the dimension. The kernel
(``csrc/k10_sparse.cu``) has two forms, chosen by shapes alone
(``_k10_form``): where the JAX package's dense queries fit
(``dense_q_fits``, its ``dense_q_ok``) the dense-query form, a gather from
the queries densified once per call as ``[dim + 1, B]`` (query-minor) with
a fused top-k; elsewhere (dim unknown or too large) the lookup form, the
same gather in a compacted space: per chunk of queries the sorted union U
of their indices (``compact_union``), every stored index mapped to its
place in U by a kernel of its own (``compact_rows``; U where U lacks it),
a block of rows at a time, and the dense-query kernel over the mapped rows
at dim = |U|. Its plain version is ``_sparse_topk_plain``, which takes the
dense-query gather where the kernel does and elsewhere a binary search of
each row entry in the query's sorted indices (the same matched values in
the same order, so the same keys). ``approx=True`` rounds the values of the dot to bf16
(f32 sums, the norms from the f32 values), as the JAX package's bf16
densified-corpus product does. The wrappers take the plain version only
for tensors on the CPU; for a CUDA tensor they launch the kernel or
raise. ``bruteforce.LAUNCHES`` counts the sweep's launches of the
dense-query form under ``k10_sparse``, of the lookup form under
``k10_sparse_lookup``, and the mapping's under ``k10_compact``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .bruteforce import (LAUNCHES, _block_target, _check_cuda,
                         _from_order_keys, _order_keys)

PAD_INDEX = np.int32(2**31 - 1)

SPARSE_METRICS = ("l2", "ip", "cosine", "l1")

#: above this dimension the dense query matrix of ``pairwise_dense_q`` is
#: too large and the plain sweep searches the sorted indices instead (the
#: JAX package's ``DENSE_Q_MAX_DIM``)
DENSE_Q_MAX_DIM = 1 << 20

#: elements of a [B, rows, P] gather per block (~256 MB of f32)
_CHUNK_ELEMS = 1 << 26

_INF = float("inf")


def pad_rows(rows, budget: int, device=None):
    """Pack a list of SparseVec (or (indices, values) pairs) into padded
    CSR tensors on ``device`` (None: the card) -> (indices [n, budget]
    int32, values [n, budget] f32)."""
    from ..index.hnsw import resolve_device

    n = len(rows)
    indices = np.full((n, budget), PAD_INDEX, dtype=np.int32)
    values = np.zeros((n, budget), dtype=np.float32)
    for i, r in enumerate(rows):
        idx, val = (r.indices, r.values) if hasattr(r, "indices") else r
        k = len(idx)
        if k > budget:
            raise ValueError(
                f"sparsevec cannot have more than {budget} non-zero elements "
                "for hnsw index"
            )
        indices[i, :k] = idx
        values[i, :k] = val
    dev = resolve_device(device)
    return torch.from_numpy(indices).to(dev), torch.from_numpy(values).to(dev)


def densify_queries(query_indices, query_values, dim: int,
                    dtype=torch.float32):
    """Scatter padded-CSR rows [B, P] into a dense [B, dim + P] matrix.
    Columns dim .. dim + P - 1 are dummy slots that stay 0: the p-th pad of
    a row lands (a zero) in column dim + p, so every column a gather clips
    to ``dim`` reads 0."""
    b, p = query_indices.shape
    valid = query_indices != PAD_INDEX
    cols = torch.where(
        valid, query_indices.clamp(0, dim - 1),
        dim + torch.arange(p, dtype=query_indices.dtype,
                           device=query_indices.device)[None, :])
    vals = torch.where(valid, query_values, 0.0).to(dtype)
    out = torch.zeros((b, dim + p), dtype=dtype, device=query_values.device)
    return out.scatter_(1, cols.long(), vals)


def _query_norms(query_values):
    """(|q|^2 [B], sum|q| [B]) of padded rows (pads hold 0)."""
    qv = query_values.float()
    return (qv * qv).sum(-1), qv.abs().sum(-1)


def _distances(metric: str, g, xv, q_sq, q_abs, xdot=None):
    """Distances from matched query values ``g`` [..., P] (0 where the
    query lacks a row entry's index) and the rows' values ``xv`` [..., P]
    (pads 0); ``q_sq`` / ``q_abs`` broadcast against the leading dims.
    ``xdot``: the row values the dot takes (default ``xv``; the approx
    sweep's bf16-rounded ones)."""
    dot = (g * (xv if xdot is None else xdot)).sum(-1)
    c_sq = (xv * xv).sum(-1)
    if metric == "l2":
        return torch.clamp(q_sq + c_sq - 2.0 * dot, min=0.0)
    if metric == "ip":
        return -dot
    if metric == "cosine":
        denom = torch.sqrt(q_sq * c_sq)
        sim = torch.where(denom > 0.0,
                          dot / torch.where(denom > 0.0, denom, 1.0), 0.0)
        return 1.0 - sim.clamp(-1.0, 1.0)
    if metric == "l1":
        corr = ((g - xv).abs() - g.abs() - xv.abs()).sum(-1)
        return q_abs + xv.abs().sum(-1) + corr
    raise ValueError(f"unknown sparse metric: {metric}")


def _match_sorted(query_indices, query_values, row_indices):
    """Matched query values for row entries: ``row_indices`` [B, M] (each
    query's own entries) are searched in the sorted ``query_indices``
    [B, P]; pads on either side match nothing -> [B, M] f32."""
    p = query_indices.shape[1]
    pos = torch.searchsorted(query_indices, row_indices)
    pos_c = pos.clamp(max=p - 1)
    found = ((pos < p) & (torch.gather(query_indices, 1, pos_c) == row_indices)
             & (row_indices != PAD_INDEX))
    return torch.where(found, torch.gather(query_values, 1, pos_c), 0.0)


def _row_chunk(b: int, p: int) -> int:
    return max(1, _CHUNK_ELEMS // max(b * p, 1))


def _block_scores(metric, ci, cv, qi, qv, q_sq, q_abs, qd=None, dim=0,
                  approx=False):
    """[B, rows] distances of one block of rows ``ci`` / ``cv``: each row
    entry's matched query value by the gather from the dense queries ``qd``
    [B, dim + P] when they are given, else by the sorted search in ``qi`` /
    ``qv``. ``approx``: bf16-rounded row values in the dot (the caller
    rounds the query values)."""
    xv = torch.where(ci != PAD_INDEX, cv.float(), 0.0)
    if qd is not None:
        g = qd[:, ci.clamp(0, dim).long()]  # [B, rows, P]
    else:
        flat = ci.reshape(1, -1).expand(qi.shape[0], -1).contiguous()
        g = _match_sorted(qi, qv, flat).reshape(qi.shape[0], *ci.shape)
    return _distances(metric, g, xv[None], q_sq[:, None], q_abs[:, None],
                      _bf16(xv)[None] if approx else None)


def pairwise_dense_q(metric: str, dim: int, base_indices, base_values,
                     query_indices, query_values):
    """[B, N] sparse distances by the gather from the queries scattered
    dense (the JAX package's ``pairwise_dense_q``), in blocks of rows."""
    qd = densify_queries(query_indices, query_values, dim)
    q_sq, q_abs = _query_norms(query_values)
    ch = _row_chunk(query_indices.shape[0], base_indices.shape[1])
    return torch.cat([
        _block_scores(metric, base_indices[s : s + ch],
                      base_values[s : s + ch], None, None, q_sq, q_abs, qd,
                      dim)
        for s in range(0, base_indices.shape[0], ch)], dim=1)


def pairwise(metric: str, base_indices, base_values, query_indices,
             query_values):
    """[B, N] sparse distances at any dimension: each row entry is found
    by a binary search in the query's sorted indices, in blocks of rows."""
    q_sq, q_abs = _query_norms(query_values)
    qv = query_values.float()
    ch = _row_chunk(query_indices.shape[0], base_indices.shape[1])
    return torch.cat([
        _block_scores(metric, base_indices[s : s + ch],
                      base_values[s : s + ch], query_indices, qv, q_sq, q_abs)
        for s in range(0, base_indices.shape[0], ch)], dim=1)


def gathered(metric: str, base_indices, base_values, ids, query_indices,
             query_values):
    """Distances [B, K] from each query to its own rows ``ids`` [B, K]
    (ids clamped into range; callers mask): the sparse beam's row
    distances."""
    safe = ids.clamp(0, base_indices.shape[0] - 1).long()
    ci = base_indices[safe]  # [B, K, P]
    cv = base_values[safe]
    b, kk, p = ci.shape
    q_sq, q_abs = _query_norms(query_values)
    g = _match_sorted(query_indices, query_values.float(),
                      ci.reshape(b, kk * p)).reshape(b, kk, p)
    xv = torch.where(ci != PAD_INDEX, cv, 0.0)
    return _distances(metric, g, xv, q_sq[:, None], q_abs[:, None])


def _bf16(x):
    return x.to(torch.bfloat16).float()


def dense_q_fits(dim: int, b: int) -> bool:
    """Whether the [B, dim + 1] dense queries are affordable (the JAX
    package's ``dense_q_ok``)."""
    return 0 < dim <= DENSE_Q_MAX_DIM and b * (dim + 1) * 4 <= (1 << 30)


# ---------------------------------------------------------------------------
# K10: the sparse sweep
# ---------------------------------------------------------------------------

#: shared memory a block of the kernel may hold (mirrors k10_sparse.cu)
_K10_SMEM = 200 * 1024


def compact_union(qi):
    """The lookup form's compacted space for queries ``qi`` [B, P]: (the
    sorted union of their indices [U] int32, the queries' indices as places
    in it [B, P] int32, pads kept)."""
    valid = qi != PAD_INDEX
    uni, inv = torch.unique(qi[valid], sorted=True, return_inverse=True)
    pos = torch.full_like(qi, int(PAD_INDEX))
    pos[valid] = inv.to(torch.int32)
    return uni.to(torch.int32).contiguous(), pos


def _compact_rows_plain(ci, uni):
    """Plain version of the mapping: each stored index of ``ci`` [N, P] as
    its place in the sorted union ``uni`` [U], U where ``uni`` lacks it,
    ``PAD_INDEX`` kept -> [N, P] int32."""
    u = uni.shape[0]
    if u == 0:
        return torch.where(ci == PAD_INDEX, ci, 0)
    pos = torch.searchsorted(uni, ci)
    found = (pos < u) & (uni[pos.clamp(max=u - 1)] == ci)
    return torch.where(ci == PAD_INDEX, ci,
                       torch.where(found, pos, u).to(torch.int32))


def compact_rows(ci, uni, out=None):
    """The lookup form's mapping (a kernel of K10): every stored index of
    ``ci`` [N, P] as its place in the sorted union ``uni`` [U] (U where
    ``uni`` lacks it, pads kept) -> [N, P] int32 (into ``out`` on the
    card). CPU tensors take ``_compact_rows_plain``; CUDA tensors the
    kernel (one search per stored entry)."""
    if not ci.is_cuda:
        return _compact_rows_plain(ci, uni)
    from . import _build

    _check_cuda("indices", ci, torch.int32, 2)
    _check_cuda("union", uni, torch.int32, 1, ci.device)
    if out is None:
        out = torch.empty_like(ci)
    elif out.shape != ci.shape or out.dtype != torch.int32 or (
            not out.is_contiguous() or out.device != ci.device):
        raise ValueError("out must be a contiguous int32 tensor like ci")
    total = ci.numel()
    blocks = max(1, min(-(-total // 256), 4 * _block_target(ci.device)))
    with torch.cuda.device(ci.device):
        rc = _build.lib().pgv_k10_compact(
            ci.data_ptr(), total, uni.data_ptr() if uni.numel() else None,
            uni.shape[0], blocks, out.data_ptr(),
            torch.cuda.current_stream(ci.device).cuda_stream)
    _build.check(rc, "pgv_k10_compact")
    LAUNCHES["k10_compact"] += 1
    return out


def _sparse_topk_plain(ci, cv, live, qi, qv, k: int, metric: str,
                       approx: bool = False, dim: int = 0):
    """Plain version of K10: per block of rows, the distances by the
    dense-query gather or the sorted search, as ``_k10_form`` picks, dead
    rows at +inf, and a top-k over the (distance, row) keys merged into a
    running top-k. ``approx``: bf16-rounded values in the dot, the norms
    from the f32 values. Returns (d [B, k] f32, rows [B, k] int64)."""
    n, p = ci.shape
    b = qi.shape[0]
    q_sq, q_abs = _query_norms(qv)
    qvd = _bf16(qv.float()) if approx else qv.float()
    qd = (densify_queries(qi, qvd, dim) if _k10_form(dim, b) == "dense"
          else None)
    ch = _row_chunk(b, p)
    best = torch.empty((b, 0), dtype=torch.int64, device=qi.device)
    for s in range(0, n, ch):
        d = _block_scores(metric, ci[s : s + ch], cv[s : s + ch], qi, qvd,
                          q_sq, q_abs, qd, dim, approx)
        d = torch.where(live[None, s : s + ch], d, _INF)
        rows = torch.arange(s, s + d.shape[1], device=qi.device)
        keys = torch.cat([best, _order_keys(d, rows.expand(b, -1))], 1)
        best = torch.topk(keys, min(k, keys.shape[1]), dim=1, largest=False,
                          sorted=True).values
    if best.shape[1] < k:  # fewer rows than k
        best = torch.nn.functional.pad(best, (0, k - best.shape[1]), value=-1)
    return _from_order_keys(best)


def _k10_form(dim: int, b: int) -> str:
    """K10's formulation for ``b`` queries over ``dim`` dimensions (0:
    unknown): "dense" where the dense queries fit (``dense_q_fits``, the
    JAX package's ``dense_q_ok``), else "lookup"."""
    return "dense" if dense_q_fits(dim, b) else "lookup"


#: the dense-query form's warps per block (a block's tile is 32 warps
#: queries, one per thread)
_K10D_WARPS = 4
#: bytes of shared memory for the staged rows (both buffers)
_K10D_STAGE_BYTES = 4096
#: bytes of the splits' partial lists ([B, splits, k] keys)
_K10D_PART_BYTES = 64 << 20


def _k10_dense_plan(n: int, b: int, p: int, k: int, sms: int,
                    warps: int = _K10D_WARPS,
                    stage_bytes: int = _K10D_STAGE_BYTES):
    """The dense-query form's launch: (warps, ldq, rc, splits,
    rows_per_split). ``ldq``: the dense queries' row length, ``b`` rounded
    up to the largest tile (so every k's tile divides it); ``rc``: rows
    staged per chunk; shared memory (each thread's list and two staged
    chunks, mirrors the kernel) within the block's limit, by fewer warps,
    then fewer rows per chunk. At most 8 blocks per SM along the rows,
    fewer where the splits' partial lists would pass ``_K10D_PART_BYTES``;
    every split is non-empty."""
    ldq = -(-b // (32 * warps)) * (32 * warps)
    rc = max(1, min(32, stage_bytes // (16 * p)))

    def smem():
        return 8 * k * warps * 32 + 16 * rc * p

    while smem() > _K10_SMEM:
        if warps > 1:
            warps //= 2
        elif rc > 1:
            rc //= 2
        else:
            raise ValueError(f"a budget of {p} non-zeros at k = {k} does "
                             "not fit the dense sparse sweep")
    splits = max(1, min(-(-n // rc), 8 * sms,
                        _K10D_PART_BYTES // (b * k * 8)))
    rows = -(-n // splits)
    return warps, ldq, rc, -(-n // rows), rows


def densify_queries_t(query_indices, query_values, dim: int, ldq: int,
                      dtype=torch.float32):
    """The dense-query form's operand: padded-CSR queries [B, P] scattered
    into [dim + 1, ldq], query-minor (column b is query b; an index past the
    dimension clamps to dim - 1, as ``densify_queries``); row ``dim``, which
    pads read, and the columns past B stay 0."""
    b, p = query_indices.shape
    valid = query_indices != PAD_INDEX
    rows = torch.where(valid, query_indices.clamp(0, dim - 1), dim).long()
    cols = torch.arange(b, device=query_indices.device)[:, None].expand(b, p)
    out = torch.zeros((dim + 1, ldq), dtype=dtype, device=query_values.device)
    return out.index_put_((rows, cols),
                          torch.where(valid, query_values, 0.0).to(dtype))


def _dense_round_cuda(ci, cv, live, qd, q_sq, q_abs, b: int, k: int,
                      metric: str, approx: bool, dim: int, plan, lo,
                      form: str = "k10_sparse"):
    """One launch of the dense-query kernel and its merge pass: the k
    smallest keys per query at or after ``lo`` [B] (None: from the start),
    in the kernel's unsigned key order; counted under ``form`` (the lookup
    form passes its mapped rows, its compacted queries and dim = |U|)."""
    from . import _build

    n, p = ci.shape
    warps, ldq, rc, splits, rows = plan
    dev = ci.device
    part = torch.empty((b, splits, k), dtype=torch.int64, device=dev)
    out = torch.empty((b, k), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc_ = _build.lib().pgv_k10_dense_topk(
            ci.data_ptr(), cv.data_ptr(), live.data_ptr(), qd.data_ptr(),
            q_sq.data_ptr(), q_abs.data_ptr(),
            lo.data_ptr() if lo is not None else None, n, p, b, k, dim, ldq,
            SPARSE_METRICS.index(metric), int(approx), warps, rc, splits,
            rows, part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc_, "pgv_k10_dense_topk")
    LAUNCHES[form] += 1
    return out


def _lookup_chunk(p: int) -> int:
    """The lookup form's queries per chunk: the most whose compacted dense
    queries [U + 1, ldq] stay within 1 GiB (the JAX package's bound on
    dense queries) for any union (U <= chunk P); a multiple of the dense
    tile where that allows."""
    tile = 32 * _K10D_WARPS

    def fits(c):
        return -(-c // tile) * tile * (c * p + 1) * 4 <= 1 << 30

    c = max(1, math.isqrt((1 << 30) // (4 * p)))
    if c >= tile:
        c -= c % tile
    while c > 1 and not fits(c):
        c -= tile if c > tile else 1
    return c


#: bytes of the lookup form's mapped rows (the stored indices as places in
#: a query chunk's union), which it maps and sweeps a block at a time
_LOOKUP_MAP_BYTES = 256 << 20


def _lookup_rows(p: int) -> int:
    """The lookup form's rows per block: the most whose mapped indices stay
    within ``_LOOKUP_MAP_BYTES``."""
    return max(1, _LOOKUP_MAP_BYTES // (4 * p))


def _merge_kernel_keys(parts, k: int):
    """The k smallest of the kernel's unsigned keys in ``parts`` (each
    [B, *], -1 empty) -> [B, k], ascending, empty last."""
    keys = torch.cat(parts, dim=1)
    top, big = torch.iinfo(torch.int64).min, torch.iinfo(torch.int64).max
    signed = torch.where(keys == -1, big, keys ^ top)
    best = torch.topk(signed, k, dim=1, largest=False, sorted=True).values
    return torch.where(best == big, -1, best ^ top)


def _lookup_topk_cuda(ci, cv, live, qi, qv, k: int, metric: str,
                      approx: bool, sms: int):
    """The lookup form on the card, per chunk of queries (``_lookup_chunk``):
    their union (``compact_union``) and the compacted dense queries; then
    per block of rows (``_lookup_rows``) the rows mapped into the union
    (``compact_rows``, into one reused buffer) and the dense-query kernel
    at dim = |U| in rounds; the blocks' keys merged. -> keys [B, k], the
    kernel's unsigned order."""
    from .bits import _in_rounds

    n, p = ci.shape
    b = qi.shape[0]
    chunk, rows = _lookup_chunk(p), min(n, _lookup_rows(p))
    mapped = torch.empty((rows, p), dtype=torch.int32, device=ci.device)
    q_sq, q_abs = (t.contiguous() for t in _query_norms(qv))
    parts = []
    for s in range(0, b, chunk):
        qc = slice(s, min(b, s + chunk))
        bc = qc.stop - s
        uni, qpos = compact_union(qi[qc])
        u = uni.shape[0]
        qd = densify_queries_t(qpos, qv[qc], u,
                               _k10_dense_plan(n, bc, p, 1, sms)[1],
                               torch.bfloat16 if approx else torch.float32)
        blocks = []
        for r0 in range(0, n, rows):
            r1 = min(n, r0 + rows)
            mc = compact_rows(ci[r0:r1], uni, out=mapped[: r1 - r0])

            def one_round(kr, lo, mc=mc, r0=r0, r1=r1, qd=qd, u=u, bc=bc,
                          qc=qc):
                return _dense_round_cuda(
                    mc, cv[r0:r1], live[r0:r1], qd, q_sq[qc], q_abs[qc], bc,
                    kr, metric, approx, u,
                    _k10_dense_plan(r1 - r0, bc, p, kr, sms), lo,
                    "k10_sparse_lookup")
            keys = _in_rounds(one_round, k)
            blocks.append(torch.where(keys == -1, keys, keys + r0))
        parts.append(blocks[0] if len(blocks) == 1
                     else _merge_kernel_keys(blocks, k))
    return torch.cat(parts)


def _sparse_topk_cuda(ci, cv, live, qi, qv, k: int, metric: str,
                      approx: bool = False, dim: int = 0):
    """K10 on the card in the form ``_k10_form`` picks, in rounds of at
    most 64 (each admits only the keys after the previous round's last;
    the queries are densified once for all rounds). The kernel's keys are
    unsigned, ``float_key(d) << 32 | row``; they become ``_order_keys``'
    signed keys by flipping the top bit."""
    from .bits import _in_rounds

    _check_cuda("indices", ci, torch.int32, 2)
    dev = ci.device
    _check_cuda("values", cv, torch.float32, 2, dev)
    _check_cuda("live", live, torch.bool, 1, dev)
    _check_cuda("query indices", qi, torch.int32, 2, dev)
    _check_cuda("query values", qv, torch.float32, 2, dev)
    n, p = ci.shape
    b = qi.shape[0]
    if (cv.shape != ci.shape or live.shape[0] != n or qi.shape[1] != p
            or qv.shape != qi.shape):
        raise ValueError(f"shape mismatch: indices {tuple(ci.shape)}, values "
                         f"{tuple(cv.shape)}, live {tuple(live.shape)}, "
                         f"queries {tuple(qi.shape)} / {tuple(qv.shape)}")
    if n == 0 or b == 0 or p == 0 or k < 1:
        raise ValueError("empty rows, queries or k")
    if n >= 1 << 31 or b > 65535 * 8:
        raise ValueError(f"at most 2^31 - 1 rows and {65535 * 8} queries per "
                         f"call (got {n}, {b})")
    sms = _block_target(dev) // 2
    if _k10_form(dim, b) == "lookup":
        keys = _lookup_topk_cuda(ci, cv, live, qi, qv, k, metric, approx, sms)
    else:
        qd = densify_queries_t(qi, qv, dim,
                               _k10_dense_plan(n, b, p, 1, sms)[1],
                               torch.bfloat16 if approx else torch.float32)
        q_sq, q_abs = (t.contiguous() for t in _query_norms(qv))

        def one_round(kr, lo):
            return _dense_round_cuda(ci, cv, live, qd, q_sq, q_abs, b, kr,
                                     metric, approx, dim,
                                     _k10_dense_plan(n, b, p, kr, sms), lo)
        keys = _in_rounds(one_round, k)
    signed = torch.where(keys == -1, keys, keys ^ torch.iinfo(torch.int64).min)
    return _from_order_keys(signed)


def sparse_topk(ci, cv, live, qi, qv, k: int, metric: str,
                approx: bool = False, dim: int = 0):
    """K10: exact top-k over the padded-CSR rows ``ci`` / ``cv`` [N, P]
    whose ``live`` [N] flag is set, for padded-CSR queries ``qi`` / ``qv``
    [B, P] -> (distances [B, k] f32, rows [B, k] int64) in (distance, row)
    order, -0.0 tied with +0.0, (inf, -1) past the live rows.
    ``approx``: the dot over bf16-rounded values (l2, ip, cosine). ``dim``
    (0: unknown) and B pick the formulation (``_k10_form``) of the kernel
    and of the plain version alike. CPU tensors take the plain version,
    CUDA tensors the kernel (in rounds of 64 past k = 64)."""
    if metric not in SPARSE_METRICS:
        raise ValueError(f"unknown sparse metric: {metric}")
    if approx and metric == "l1":
        raise ValueError("the approx sparse sweep takes l2, ip or cosine")
    if ci.is_cuda:
        return _sparse_topk_cuda(ci, cv, live, qi, qv, k, metric, approx,
                                 dim)
    return _sparse_topk_plain(ci, cv, live, qi, qv, k, metric, approx, dim)
