"""Packed-bit distances of the PyTorch port: hamming and jaccard over
32-bit words, and the bit sweep K9.

The counterpart of ``pgvector_rx_tpu/ops/bits.py``. Bit vectors are packed
MSB-first into 32-bit words, each word the big-endian value of 4 bytes,
zero-padded (``pack_bits``: the JAX package's layout, so the two packages'
words compare array to array). Torch has no unsigned 32-bit arithmetic to
speak of on the CPU, so the port holds the words as ``int32`` tensors with
the same bits (``as_words``), and its plain popcount is a SWAR sum whose
every right shift is masked (``>>`` on a negative ``int32`` is
arithmetic).

**K9** (``bits_topk``): the exact top-k of hamming ``popcount(q ^ x)`` or
jaccard ``ab == 0 ? 1 : 1 - ab / union`` (``ab = popcount(q & x)``,
``union = popq + popx - ab``, f32) over the live rows, in (distance, row)
order. It replaces the XLA program ``_exact_search_bits``
(``pgvector_rx_tpu/graph/device.py:1155``), which has no Pallas ancestor,
in its two forms, chosen as the JAX package chooses them (``_k9_form``:
``mxu = B >= 32``):

- at 32 queries or more, the int8 tensor-core form (``csrc/k9_bits_tc.cu``:
  ``ab`` as the u8 product of the unpacked {0,1} rows, hamming ``popq +
  popx - 2 ab``; JAX's unpack + matmul branch), plain version
  ``_bits_topk_plain_mm``; launches under ``LAUNCHES["k9_bits_tc"]``;
- below 32, the popcount form (``csrc/k9_bits.cu``: XOR / AND and
  population counts on the words), plain version ``_bits_topk_plain``;
  launches under ``LAUNCHES["k9_bits"]``.

Both give the same integers and the same keys. The wrapper takes the plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from .bruteforce import (LAUNCHES, _block_target, _check_cuda,
                         _from_order_keys, _order_keys)

BIT_METRICS = ("hamming", "jaccard")

_INF = float("inf")


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """Pack a [N, nbits] 0/1 array into [N, ceil(nbits/32)] uint32 words."""
    b = np.asarray(bits, dtype=np.uint8)
    if b.ndim == 1:
        b = b[None, :]
    nbits = b.shape[1]
    pad = (-nbits) % 32
    if pad:
        b = np.pad(b, ((0, 0), (0, pad)))
    by = np.packbits(b, axis=1)  # MSB-first bytes
    return by.reshape(b.shape[0], -1, 4).view(">u4").astype(np.uint32).reshape(
        b.shape[0], -1
    )


def unpack_bits(words: np.ndarray, nbits: int) -> np.ndarray:
    w = np.asarray(words, dtype=np.uint32)
    by = w.astype(">u4").view(np.uint8).reshape(w.shape[0], -1)
    bits = np.unpackbits(by, axis=1)
    return bits[:, :nbits]


def bytes_to_words(rows: np.ndarray, nbits: int) -> np.ndarray:
    """Packed byte rows [N, ceil(nbits/8)] (the bit store's layout) ->
    [N, ceil(nbits/32)] uint32 words, bits past ``nbits`` cleared (the JAX
    package's ``pack_bits(unpackbits(rows)[:, :nbits])``)."""
    return pack_bits(np.unpackbits(np.asarray(rows, np.uint8),
                                   axis=1)[:, :nbits])


def prepare_rows(values, dim: int) -> np.ndarray:
    """Bit values -> packed byte rows [N, ceil(dim/8)] uint8, in one
    vectorised pass equal row by row to ``HnswIndex.prepare_value``: a
    uint8 row of ``ceil(dim/8)`` bytes is taken as packed already, a row of
    ``dim`` values is packed MSB-first (any non-zero value is a set bit),
    any other width raises."""
    nbytes = (dim + 7) // 8
    arr = np.asarray(values)
    if arr.ndim != 2:  # ragged input: one row at a time
        return np.stack([prepare_rows(np.asarray(v)[None], dim)[0]
                         for v in values]) if len(values) else \
            np.zeros((0, nbytes), np.uint8)
    if arr.dtype == np.uint8 and arr.shape[1] == nbytes:
        return np.ascontiguousarray(arr)
    if arr.shape[1] != dim:
        raise ValueError(f"expected {dim} dimensions, not {arr.shape[1]}")
    return np.packbits(arr.astype(np.uint8), axis=1)


def as_words(x, device=None) -> torch.Tensor:
    """Packed words (numpy uint32 / int32, or a torch int32 / uint32
    tensor) -> an int32 tensor with the same bits, on ``device`` (default:
    where it is)."""
    if isinstance(x, torch.Tensor):
        t = x.view(torch.int32) if x.dtype == torch.uint32 else x
        if t.dtype != torch.int32:
            raise ValueError(f"packed words must be 32-bit (got {x.dtype})")
    else:
        a = np.ascontiguousarray(x)
        if a.dtype not in (np.uint32, np.int32):
            raise ValueError(f"packed words must be 32-bit (got {a.dtype})")
        t = torch.from_numpy(a.view(np.int32).copy())
    return t if device is None else t.to(device)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of an int32 tensor (SWAR; each right shift
    masked, so negative words count right) -> int32."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F  # bytes <= 8, sign bit clear
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def row_popcount(words: torch.Tensor) -> torch.Tensor:
    """[N, W] int32 words -> [N] f32 popcounts (exact: < 2^24)."""
    return popcount(words).sum(dim=-1, dtype=torch.int32).float()


def _from_counts(metric: str, x_or_and, qpop, xpop):
    """Distances from the popcount of q ^ x (hamming) or q & x (jaccard,
    with the popcounts of q and x) -> f32, the JAX package's formula."""
    c = x_or_and.float()
    if metric == "hamming":
        return c
    if metric == "jaccard":
        union = qpop + xpop - c
        return torch.where(c == 0.0, 1.0,
                           1.0 - c / torch.where(union > 0, union, 1.0))
    raise ValueError(f"unknown bit metric: {metric}")


def _counts(metric: str, q, x):
    op = torch.bitwise_xor if metric == "hamming" else torch.bitwise_and
    return popcount(op(q, x)).sum(dim=-1, dtype=torch.int32)


def pairwise(metric: str, base, queries):
    """base [N, W] int32 words, queries [B, W] -> [B, N] f32 distances."""
    c = _counts(metric, queries[:, None, :], base[None, :, :])
    return _from_counts(metric, c, row_popcount(queries)[:, None],
                        row_popcount(base)[None, :])


def gathered(metric: str, words, ids, queries, base_pop=None):
    """Distances [B, K] from each query [B, W] to its own rows ``ids``
    [B, K] of ``words`` (ids clamped into range; callers mask);
    ``base_pop`` [N]: the rows' popcounts (jaccard), else counted here."""
    safe = ids.clamp(0, words.shape[0] - 1).long()
    cand = words[safe]  # [B, K, W]
    c = _counts(metric, queries[:, None, :], cand)
    xpop = base_pop[safe] if base_pop is not None else row_popcount(cand)
    return _from_counts(metric, c, row_popcount(queries)[:, None], xpop)


def unpack_words_bf16(words) -> torch.Tensor:
    """[N, W] int32 words -> [N, W*32] bf16 {0,1}, MSB-first within each
    word (the ``pack_bits`` order)."""
    shifts = torch.arange(31, -1, -1, device=words.device, dtype=torch.int32)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# K9: the bit sweep
# ---------------------------------------------------------------------------

#: the kernel's list length per query and round (k > 64 runs in rounds)
_K9_MAX_K = 64
#: word elements of the plain sweep's [B, rows, W] temporaries per block
_PLAIN_ELEMS = 1 << 25
#: rows per block of the kernel's grid split (one per lane of a warp)
_K9_ROWS = 32
#: a block's shared memory limit and the blocks its registers allow on an
#: SM (k9_bits_tc.cu's tcMaxSmem, tcBlocksPerSm)
_K9_TC_MAX_SMEM, _K9_TC_PER_SM = 232448, 3
#: the tensor-core form: from this many queries (JAX's ``mxu = B >= 32``);
#: queries and rows per block (wgmma's m64 and n128)
_K9_TC_MIN_B = 32
_K9_TC_QTILE, _K9_TC_ROWS = 64, 128


def _bits_topk_plain(words, pop, live, queries, k: int, metric: str):
    """Plain version of K9: chunked popcounts of the int32 words, dead rows
    at +inf, and a top-k over the (distance, row) keys per block merged
    into a running top-k. Returns (d [B, k] f32, rows [B, k] int64)."""
    n, w = words.shape
    b = queries.shape[0]
    qpop = row_popcount(queries)[:, None]
    ch = max(1, _PLAIN_ELEMS // max(b * w, 1))
    best = torch.empty((b, 0), dtype=torch.int64, device=queries.device)
    for s in range(0, n, ch):
        x = words[s : s + ch]
        xpop = (pop[s : s + ch] if pop is not None
                else row_popcount(x))[None, :]
        d = _from_counts(metric, _counts(metric, queries[:, None, :],
                                         x[None, :, :]), qpop, xpop)
        d = torch.where(live[None, s : s + ch], d, _INF)
        rows = torch.arange(s, s + x.shape[0], device=words.device)
        keys = torch.cat([best, _order_keys(d, rows.expand(b, -1))], 1)
        best = torch.topk(keys, min(k, keys.shape[1]), dim=1, largest=False,
                          sorted=True).values
    if best.shape[1] < k:  # fewer rows than k
        best = torch.nn.functional.pad(best, (0, k - best.shape[1]), value=-1)
    return _from_order_keys(best)


def _bits_topk_plain_mm(words, pop, live, queries, k: int, metric: str):
    """Plain version of K9's tensor-core form, JAX's MXU branch step for
    step: each block of rows unpacked to {0,1} (``unpack_words_bf16``), one
    f32 product with the unpacked queries (``ab = popcount(q & x)``, exact:
    0/1 products, sums below 2^24), the rows' popcounts recounted per
    block as JAX does (``pop`` is not read), hamming ``(popx + pen) - 2 ab``
    restored by ``popq``, jaccard the same formula as the popcount form;
    dead rows at +inf; a top-k over the (distance, row) keys per block
    merged into a running top-k. Returns (d [B, k] f32, rows [B, k]
    int64), key for key ``_bits_topk_plain``'s."""
    del pop
    n, w = words.shape
    b = queries.shape[0]
    qpop = row_popcount(queries)[:, None]
    qf = unpack_words_bf16(queries).float()
    ch = max(1, _PLAIN_ELEMS // max(b, 32 * w))
    best = torch.empty((b, 0), dtype=torch.int64, device=queries.device)
    for s in range(0, n, ch):
        x = words[s : s + ch]
        bb = row_popcount(x)[None, :]
        ab = qf @ unpack_words_bf16(x).float().T  # [B, rows]
        lv = live[None, s : s + ch]
        if metric == "hamming":
            d = (bb + torch.where(lv, 0.0, _INF)) - 2.0 * ab + qpop
        else:
            d = torch.where(lv, _from_counts(metric, ab, qpop, bb), _INF)
        rows = torch.arange(s, s + x.shape[0], device=words.device)
        keys = torch.cat([best, _order_keys(d, rows.expand(b, -1))], 1)
        best = torch.topk(keys, min(k, keys.shape[1]), dim=1, largest=False,
                          sorted=True).values
    if best.shape[1] < k:  # fewer rows than k
        best = torch.nn.functional.pad(best, (0, k - best.shape[1]), value=-1)
    return _from_order_keys(best)


def _k9_form(b: int) -> str:
    """K9's form for a batch of ``b`` queries, the JAX package's rule
    (``mxu = B >= 32``, ``pgvector_rx_tpu/graph/device.py:1214``): the
    int8 tensor-core form (``"k9_bits_tc"``) at 32 or more, the popcount
    form (``"k9_bits"``) below."""
    return "k9_bits_tc" if b >= _K9_TC_MIN_B else "k9_bits"


def _k9_qtile(w: int, kl: int) -> int:
    """Queries per block: the most of 64, 32, 16, 8 whose words, popcounts
    and lists fit the block's shared memory (mirrors the kernel's check)."""
    wp = -(-w // 4) * 4
    for qb in (64, 32, 16, 8):
        if qb * (wp * 4 + 4 + kl * 8) <= 200 * 1024:
            return qb
    raise ValueError(f"{w} words per row do not fit the bit sweep")


def _k9_plan(n: int, b: int, qb: int, target: int):
    """K9's grid: (query tiles, splits, rows per split), at most ``target``
    blocks where the query tiles allow; every split covers rows
    [s * rows, min(n, (s + 1) * rows)), all non-empty; rows is a multiple
    of 32 (a warp's rows per step)."""
    qtiles = -(-b // qb)
    chunks = -(-n // _K9_ROWS)
    splits = max(1, min(chunks, 65535, target // qtiles))
    rows = -(-chunks // splits) * _K9_ROWS
    return qtiles, -(-n // rows), rows


def _bits_round_cuda(words, pop, live, queries, k: int, metric: str, lo):
    """One launch of the kernel and its merge pass: the k smallest keys
    per query at or after ``lo`` [B] int64 (None: from the start)."""
    from . import _build

    n, w = words.shape
    b = queries.shape[0]
    qb = _k9_qtile(w, k)
    _, splits, rows = _k9_plan(n, b, qb, 2 * _block_target(words.device))
    dev = words.device
    part = torch.empty((b, splits, k), dtype=torch.int64, device=dev)
    out = torch.empty((b, k), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().pgv_k9_bits_topk(
            words.data_ptr(), pop.data_ptr() if pop is not None else None,
            live.data_ptr(), queries.data_ptr(),
            lo.data_ptr() if lo is not None else None, n, w, b, k,
            BIT_METRICS.index(metric), qb, splits, rows, part.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "pgv_k9_bits_topk")
    LAUNCHES["k9_bits"] += 1
    return out


def _k9_tc_plan(n: int, b: int, blocks: int):
    """The tensor-core form's grid: (query tiles, splits, rows per split)
    for at most ``blocks`` blocks where the query tiles allow; every split
    covers rows [s * rows, min(n, (s + 1) * rows)), all non-empty; rows is
    a multiple of 128 (a chunk)."""
    qtiles = -(-b // _K9_TC_QTILE)
    chunks = -(-n // _K9_TC_ROWS)
    splits = max(1, min(chunks, 65535, blocks // qtiles))
    rows = -(-chunks // splits) * _K9_TC_ROWS
    return qtiles, -(-n // rows), rows


def _bits_round_tc(words, live, queries, k: int, metric: str, lo):
    """One launch of the tensor-core form and its merge pass: the k
    smallest keys per query at or after ``lo`` [B] int64 (None: from the
    start)."""
    import ctypes

    from . import _build

    n, w = words.shape
    b = queries.shape[0]
    lib = _build.lib()
    resident = ctypes.c_int()
    smem = lib.pgv_k9_tc_smem(w, k, ctypes.byref(resident))
    if smem > _K9_TC_MAX_SMEM:
        raise ValueError(f"{w} words per row at k = {k} do not fit the "
                         "tensor-core bit sweep's block")
    per_sm = max(1, min(_K9_TC_MAX_SMEM // smem, _K9_TC_PER_SM))
    _, splits, rows = _k9_tc_plan(
        n, b, per_sm * torch.cuda.get_device_properties(
            words.device).multi_processor_count)
    dev = words.device
    part = torch.empty((b, splits, k), dtype=torch.int64, device=dev)
    shared = torch.full((b,), -1, dtype=torch.int64, device=dev)
    out = torch.empty((b, k), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = lib.pgv_k9_bits_tc_topk(
            words.data_ptr(), live.data_ptr(), queries.data_ptr(),
            lo.data_ptr() if lo is not None else None, n, w, b, k,
            BIT_METRICS.index(metric), splits, rows, part.data_ptr(),
            shared.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "pgv_k9_bits_tc_topk")
    LAUNCHES["k9_bits_tc"] += 1
    return out


def _bits_topk_cuda(words, pop, live, queries, k: int, metric: str,
                    form: str | None = None):
    """K9 on the card in the form ``_k9_form`` picks (``form``: that one
    instead, to compare the two at one batch size), in rounds of at most
    64: each round admits only the keys after the previous round's last,
    which is exact because the (distance, row) order is total. The
    tensor-core form counts each row's popcount from its words and reads
    no ``pop``."""
    _check_cuda("words", words, torch.int32, 2)
    _check_cuda("live", live, torch.bool, 1, words.device)
    _check_cuda("queries", queries, torch.int32, 2, words.device)
    n, w = words.shape
    b = queries.shape[0]
    if metric == "jaccard":
        if pop is None:
            raise ValueError("jaccard needs the rows' popcounts (pop)")
        _check_cuda("pop", pop, torch.float32, 1, words.device)
        if pop.shape[0] != n:
            raise ValueError(f"pop has {pop.shape[0]} rows, words {n}")
    if live.shape[0] != n or queries.shape[1] != w:
        raise ValueError(f"shape mismatch: words {tuple(words.shape)}, live "
                         f"{tuple(live.shape)}, queries "
                         f"{tuple(queries.shape)}")
    if n == 0 or b == 0 or w == 0 or k < 1:
        raise ValueError("empty words, queries or k")
    if n >= 1 << 31 or b > 65535 * 8:
        raise ValueError(f"at most 2^31 - 1 rows and {65535 * 8} queries per "
                         f"call (got {n}, {b})")
    if (form or _k9_form(b)) == "k9_bits_tc":
        def one_round(kr, lo):
            return _bits_round_tc(words, live, queries, kr, metric, lo)
    else:
        pop = pop if metric == "jaccard" else None

        def one_round(kr, lo):
            return _bits_round_cuda(words, pop, live, queries, kr, metric,
                                    lo)
    return _from_order_keys(_in_rounds(one_round, k))


def _in_rounds(one_round, k: int):
    """The k smallest keys per query from rounds of at most 64:
    ``one_round(kr, lo)`` returns the kr smallest keys at or after ``lo``
    [B] (None: from the start), empty keys (-1) past the rows; each round
    starts after the previous round's last key. The keys are compared as
    the kernel compares them (K10's as unsigned), so only -1 is empty."""
    parts, lo = [], None
    for s in range(0, k, _K9_MAX_K):
        keys = one_round(min(_K9_MAX_K, k - s), lo)
        parts.append(keys)
        last = keys[:, -1]
        # an exhausted query (empty key) admits nothing more
        lo = torch.where(last == -1, last, last + 1).contiguous()
    return torch.cat(parts, dim=1)


def bits_topk(words, pop, live, queries, k: int, metric: str):
    """K9: exact top-k over the rows of ``words`` [N, W] (int32 words) whose
    ``live`` [N] flag is set -> (distances [B, k] f32, rows [B, k] int64)
    in (distance, row) order, (inf, -1) past the live rows. ``queries``
    [B, W] int32 words; ``pop`` [N] f32: the rows' popcounts (jaccard's
    popcount form; None for hamming). CPU tensors take the plain version
    of the form ``_k9_form`` picks, CUDA tensors that form's kernel (in
    rounds of 64 past k = 64)."""
    if metric not in BIT_METRICS:
        raise ValueError(f"unknown bit metric: {metric}")
    if words.is_cuda:
        return _bits_topk_cuda(words, pop, live, queries, k, metric)
    plain = (_bits_topk_plain_mm if _k9_form(queries.shape[0]) ==
             "k9_bits_tc" else _bits_topk_plain)
    return plain(words, pop, live, queries, k, metric)
