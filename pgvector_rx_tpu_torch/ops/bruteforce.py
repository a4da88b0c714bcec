"""Fused brute-force k-NN sweeps: the counterpart of
``pgvector_rx_tpu/ops/pallas_bruteforce.py``.

Three kernels, hand-written in CUDA for Hopper (``csrc/k1_topk.cu`` and
``csrc/k1_select.cu``, ``csrc/k2_binned.cu``, ``csrc/k3_tilemin.cu``):

- **K1** (``_surrogate_topk``; ``l2_topk`` / ``ip_topk`` /
  ``cosine_topk``): exact FP32 top-k of the surrogate score
  ``a - 2 q.x`` without a [B, N] score matrix in device memory. Replaces
  the Pallas ``_topk_kernel``, in two forms. The tensor-core form
  (``csrc/k1_topk.cu``, many queries, k <= 60): three tf32 ``wgmma``
  products per FP32 product select k + 4 candidates per query, rescored
  exactly in FP32. The select form (``csrc/k1_select.cu``, few queries or
  any k): every row's FP32 score in the rescoring's order, written as a
  64-bit order key, and a radix select of the k smallest keys in one
  sweep of the rows. Both read f16 and bf16 rows as stored, so a compact
  store's chunk needs no f32 copy.
- **K2** (``binned_sweep_topk``): bf16 sweep keeping a running per-bin
  minimum (bin = row mod ``tn``), then a top-k over the bins. Replaces the
  Pallas ``_binned_kernel``. It reads f16 rows too, rounding each value to
  bf16 as the cast would.
- **K3** (``tilemin_sweep_topk``): bf16 sweep emitting one packed int32
  per (query, ``tn``-row tile) -- the tile's min score bits with the low
  10 bits replaced by the winning column -- then a top-k over the tiles.
  Replaces the Pallas ``_tilemin_kernel``. Its shift's corpus term, the
  largest squared row norm, comes from a one-pass reduction kernel over
  the bf16 rows (``_row_sq_max``, launch count ``k3_x2max``).
- **K7** (``coarse_topk``, ``csrc/k7_coarse.cu``): the beam engine's
  coarse seed sweep, the S best upper rows of each query by a bf16 score
  with the non-traversable rows masked, without a [B, U] score matrix:
  bf16 ``wgmma`` tiles for a batch, a GEMV form in one launch for one
  query (launches ``k7_coarse_one``).
  It has no Pallas ancestor: it replaces the XLA program of the JAX
  package's ``_search_batch_coarse``.

Every wrapper has its plain-torch version beside it (``*_plain``). A
wrapper takes the plain version only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises. ``LAUNCHES`` counts kernel
launches per kernel name.

``a`` is the per-row term, penalty included: ``||x||^2`` for l2 and 0 for
ip/cosine, plus ``_NEG_BIG`` (3e38) on rows that must never be returned.
Scores at or above ``_NEG_BIG / 2`` come back as id -1 / distance inf.
"""

from __future__ import annotations

import functools

import torch

_NEG_BIG = float(3.0e38)

#: kernel name -> launches of that kernel by its wrapper in this process
#: (the beam walk's modes, ``ops/beam.py``, the bit sweep, ``ops/bits.py``,
#: the sparse sweep, ``ops/sparse.py``, and the build's beam ground,
#: ``graph/device_build.py``, count here too)
LAUNCHES = {"k1_topk": 0, "k1_select": 0, "k2_binned": 0, "k3_tilemin": 0,
            "k3_x2max": 0, "k4_beam": 0, "k4_beam_sparse": 0,
            "k5_beam_scan": 0,
            "k9_bits": 0, "k9_bits_tc": 0, "k10_sparse": 0,
            "k10_sparse_lookup": 0, "k10_compact": 0, "k7_coarse": 0,
            "k7_coarse_one": 0, "k8_beam_ground": 0}

_MAX_K = 64


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _block_target(dev: torch.device) -> int:
    """Blocks a K1 / K2 / K3 grid aims for: one wave, two resident blocks
    per SM of the card it runs on. More splits would only cost: each
    split's blocks refill their top-k lists (K1), write their bins (K2) or
    reload their query tile (K3) again. K1's 2-byte mode and K2's
    streamed form fill an SM with one block: they aim for ``_sm_count``."""
    return 2 * _sm_count(dev)


#: queries per block of K1 / K2 / K3, and K2's bins (corpus rows) per block
_K1_QTILE, _K2_QTILE, _K2_BINS, _K3_QTILE = 64, 128, 64, 128
#: K1's 2-byte mode: queries per block and rows per chunk
_K1C_QTILE, _K1C_CHUNK = 128, 256
#: K2's streamed form (f16 rows, bf16 rows past ``_K2_RESIDENT_MAX_D``):
#: bins per block
_K2S_BINS = 128
#: the most tiles a block of K2's streamed form covers (k2_binned.cu's
#: ksMaxTiles)
_K2S_MAX_TILES = 0xFFFF
#: the widest bf16 rows whose 128-query tile K2 keeps in shared memory
#: (``csrc/k2_binned.cu``: k2_smem_bytes(units) <= k2MaxSmem)
_K2_RESIDENT_MAX_D = 768
#: list places K1 keeps beyond k for its exact rescoring
_K1_SPARE = 4
#: the row dtypes K1 reads, by the code its C entry takes (K2: 1 and 2)
_ROW_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def _k1_plan(n: int, b: int, target: int, qtile: int = _K1_QTILE,
             chunk: int = 64):
    """K1's grid: (query tiles, splits, rows per split), at most ``target``
    blocks where the query tiles allow. Every split covers rows
    [s * rows, min(n, (s + 1) * rows)), all non-empty; rows is a multiple
    of ``chunk`` (the kernel's). ``qtile`` and ``chunk`` are 64 for f32
    rows, 128 and 256 for 2-byte rows."""
    qtiles = -(-b // qtile)
    chunks = -(-n // chunk)
    splits = max(1, min(chunks, 65535, target // qtiles))
    rows = -(-chunks // splits) * chunk
    return qtiles, -(-n // rows), rows


def _k2_plan(n: int, b: int, tn: int, target: int, bins: int = _K2_BINS):
    """K2's grid: (query tiles, bin groups, splits, tiles per split), at
    most ``target`` blocks where the query tiles and bin groups allow.
    Split s covers tiles [s * tps, min(ntiles, (s + 1) * tps)) of tn rows,
    all non-empty; bin group g covers bins [bins g, bins (g + 1)):
    ``bins`` is 64 in the resident form, 128 in the streamed one."""
    qtiles = -(-b // _K2_QTILE)
    groups = tn // bins
    ntiles = -(-n // tn)
    splits = max(1, min(ntiles, 65535, target // (qtiles * groups)))
    # a block of the streamed form keeps its cells' tiles in 16 bits
    splits = max(splits, -(-ntiles // _K2S_MAX_TILES))
    tps = -(-ntiles // splits)
    return qtiles, groups, -(-ntiles // tps), tps


def _k3_plan(n: int, b: int, tn: int, target: int):
    """K3's grid: (query tiles, splits, tiles per split), at most ``target``
    blocks where the query tiles allow. Split s covers the whole tiles
    [s * tps, min(ntiles, (s + 1) * tps)) of tn rows, all non-empty, so no
    tile spans two blocks."""
    qtiles = -(-b // _K3_QTILE)
    ntiles = -(-n // tn)
    splits = max(1, min(ntiles, 65535, target // qtiles))
    tps = -(-ntiles // splits)
    return qtiles, -(-ntiles // tps), tps


def _tf32_round(x):
    """Round f32 to the nearest tf32 (ties away from zero), kept as f32
    with the low 13 mantissa bits zero: the kernel's ``cvt.rna.tf32``."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_split(x):
    """(big, small) tf32 halves of f32 ``x``: big = tf32(x), small =
    tf32(x - big); big + small holds x to ~2^-22 of it."""
    big = _tf32_round(x)
    return big, _tf32_round(x - big)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _order_keys(d, rows):
    """(distance, row) pairs -> one int64 key each, ordered as the pairs:
    a signed 32-bit image of the distance above the row's 32 bits (rows
    below 2^31). The image keeps a non-negative distance's f32 bits and
    flips the 31 low bits of a negative one, so it orders as the floats do,
    negative distances (the sparse kind's ``ip``) first; ``+ 0.0`` turns a
    -0.0 into +0.0 first, so the two zeros tie. A top-k over the keys is
    the top-k in (distance, lower row first) order, ``lax.top_k``'s,
    whatever order the rows came in. No key of a row equals -1, the empty
    key."""
    bits = (d + 0.0).view(torch.int32)
    bits = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (bits.long() << 32) | rows


def _from_order_keys(keys):
    """Keys -> (distances f32, rows int64); the empty key (-1) and +inf
    distances come back as (inf, -1)."""
    hi = (keys >> 32).to(torch.int32)
    d = torch.where(hi < 0, hi ^ 0x7FFFFFFF, hi).view(torch.float32)
    bad = (keys == -1) | torch.isinf(d)
    return (torch.where(bad, float("inf"), d),
            torch.where(bad, -1, keys & 0xFFFFFFFF))


def _invalid_to_sentinel(sd, si):
    """Excluded / empty slots -> (inf, -1)."""
    bad = (si < 0) | (sd >= _NEG_BIG * 0.5)
    return (
        torch.where(bad, torch.full_like(sd, float("inf")), sd),
        torch.where(bad, torch.full_like(si, -1), si),
    )


# ---------------------------------------------------------------------------
# K1: exact fused top-k
# ---------------------------------------------------------------------------

#: corpus rows per block of the plain sweep (bounds its [B, rows] scores)
_PLAIN_CHUNK = 1 << 18


def _surrogate_topk_plain(base, a, queries, k: int):
    """Plain version of K1: chunked FP32 matmul + top-k merge.
    Returns (scores [B,k], ids [B,k] int32), ascending."""
    n = base.shape[0]
    q = queries.float()
    parts_s, parts_i = [], []
    for s in range(0, n, _PLAIN_CHUNK):
        x = base[s : s + _PLAIN_CHUNK].float()
        sc = a[s : s + _PLAIN_CHUNK].float()[None, :] - 2.0 * (q @ x.T)
        kk = min(k, x.shape[0])
        v, i = torch.topk(sc, kk, dim=1, largest=False, sorted=True)
        parts_s.append(v)
        parts_i.append(i + s)
    sd = torch.cat(parts_s, dim=1)
    si = torch.cat(parts_i, dim=1)
    if len(parts_s) > 1:  # merge the blocks' lists, even when k >= n
        sd, pos = torch.topk(sd, min(k, sd.shape[1]), dim=1, largest=False,
                             sorted=True)
        si = torch.gather(si, 1, pos)
    si = si.to(torch.int32)
    if sd.shape[1] < k:  # fewer rows than k
        pad = k - sd.shape[1]
        sd = torch.cat([sd, sd.new_full((sd.shape[0], pad), float("inf"))], 1)
        si = torch.cat([si, si.new_full((si.shape[0], pad), -1)], 1)
    return sd, si


def _check_cuda(name, t, dtype, ndim, device=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, base on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims (got {t.dim()})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _surrogate_topk_cuda(base, a, queries, k: int):
    from . import _build

    if base.dtype not in _ROW_CODE:
        raise ValueError("base must be float32, float16 or bfloat16 (got "
                         f"{base.dtype})")
    _check_cuda("base", base, base.dtype, 2)
    _check_cuda("a", a, torch.float32, 1, base.device)
    _check_cuda("queries", queries, torch.float32, 2, base.device)
    n, d = base.shape
    b = queries.shape[0]
    if a.shape[0] != n or queries.shape[1] != d:
        raise ValueError(f"shape mismatch: base {tuple(base.shape)}, "
                         f"a {tuple(a.shape)}, queries {tuple(queries.shape)}")
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"k must be in [1, {_MAX_K}] (got {k})")
    if n == 0 or b == 0 or d == 0:
        raise ValueError("empty base, queries or feature dimension")
    dev = base.device
    if base.dtype == torch.float32:
        _, splits, rows_per_split = _k1_plan(n, b, _block_target(dev))
    else:  # the 2-byte mode: one block an SM
        _, splits, rows_per_split = _k1_plan(n, b, _sm_count(dev),
                                             _K1C_QTILE, _K1C_CHUNK)
    q_big, q_small = _tf32_split(queries)
    kl = min(_MAX_K, k + _K1_SPARE)
    part_d = torch.empty((b, splits, kl), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, splits, kl), dtype=torch.int32, device=dev)
    sel_d = torch.empty((b, kl), dtype=torch.float32, device=dev)
    sel_i = torch.empty((b, kl), dtype=torch.int32, device=dev)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # the C entry launches on the current one
        rc = _build.lib().pgv_k1_surrogate_topk(
            base.data_ptr(), _ROW_CODE[base.dtype], a.data_ptr(),
            queries.data_ptr(),
            q_big.data_ptr(), q_small.data_ptr(), n, d, b, k, kl, splits,
            rows_per_split, part_d.data_ptr(), part_i.data_ptr(),
            sel_d.data_ptr(), sel_i.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "pgv_k1_surrogate_topk")
    LAUNCHES["k1_topk"] += 1
    return out_d, out_i


#: the largest k the tensor-core form answers with all its spare places:
#: its lists hold min(64, k + 4)
_K1_TC_MAX_K = _MAX_K - _K1_SPARE
#: the most queries the select form takes at k <= ``_K1_TC_MAX_K``, by
#: the rows' dtype: ((from k, queries), ...), the first whose k is
#: reached. At more queries the tensor-core form is faster. Measured on
#: an H100 (probes/k1_select.py, PERF.md): over 1M x 128-d f32 rows the
#: select form wins up to 32 queries at k = 10 (0.86 against 1.13 ms) and
#: loses at 64 (1.81 / 1.05); at k = 40 and 60 it wins up to 128 (3.50 /
#: 4.22, 3.45 / 5.13) and loses at 256. Over 262,144 x 1,024-d f16 rows it
#: wins up to 32 at k = 10 and up to 64 at k = 40 and 60. Between the
#: measured k the smaller limit holds.
_K1S_MAX_B = {torch.float32: ((40, 128), (0, 32)),
              torch.float16: ((40, 64), (0, 32)),
              torch.bfloat16: ((40, 64), (0, 32))}
#: the select form's key budget: a call holds [queries, n] 64-bit keys of
#: at most this many bytes (one query's at least), so a batch runs in
#: chunks of queries, each one sweep of the rows. Each chunk costs ~0.26
#: ms more: 1,024 queries x k = 100 over 1M rows took 61.4 / 33.0 / 29.0
#: / 27.1 ms at 64 / 128 / 256 / 512 MiB (probes/k1_select.py, PERF.md)
_K1S_BUDGET = 256 << 20
#: csrc/k1_select.cu's count bins, the most keys its last bin may hold
#: (ksCap) and the largest k it orders itself (ksSortCap; past it the
#: selected keys are sorted here)
_K1S_BINS, _K1S_CAP, _K1S_SORT_CAP = 2048, 4096, 16384
#: the select form's rows per tile (k1_select.cu's ksRows)
_K1S_ROWS = 256
#: flips an unsigned order key (the kernel's) into ``_order_keys``' signed
#: one
_SIGN_BIT = -(1 << 63)


def _k1s_max_b(k: int, dtype: torch.dtype) -> int:
    """The most queries the select form takes at this k (<= 60) over rows
    of this dtype (``_K1S_MAX_B``; another dtype as f32: the wrapper it
    reaches refuses it)."""
    for k0, b in _K1S_MAX_B.get(dtype, _K1S_MAX_B[torch.float32]):
        if k >= k0:
            return b
    raise AssertionError("every k reaches the last entry")


def _k1s_plan(n: int, b: int, budget: int | None = None):
    """The select form's query chunks [(q0, q1), ...]: consecutive, every
    query in one, each chunk's [q1 - q0, n] int64 keys within ``budget``
    (``_K1S_BUDGET`` when None; a chunk of one query where one query's
    keys exceed it) and at most 65,535 queries (the passes' grid)."""
    budget = _K1S_BUDGET if budget is None else budget
    per = max(1, min(65535, budget // (8 * n)))
    return [(s, min(b, s + per)) for s in range(0, b, per)]


#: the select form's pass blocks per sweep block: the passes stream the
#: keys from memory at many queries, and need about 16 resident blocks an
#: SM (two waves) to keep enough loads in flight
_K1S_PASS_SPREAD = 8


def _k1s_grid(n: int, b: int, target: int):
    """The select form's grid for b queries over n rows: (queries per
    sweep block, rows per sweep block, keys per pass block). About
    ``target`` sweep blocks and ``_K1S_PASS_SPREAD * target`` pass blocks
    (at least 4,096 keys each) in all."""
    qg = 1 if b == 1 else (4 if b <= 4 else 16)
    splits = max(1, target // -(-b // qg))
    rows = -(-n // splits)
    rows = -(-rows // _K1S_ROWS) * _K1S_ROWS
    blocks = max(1, min(-(-n // 4096), _K1S_PASS_SPREAD * target // b))
    per = -(-n // blocks)
    per = -(-per // _K1S_ROWS) * _K1S_ROWS
    return qg, rows, per


def _select_topk_cuda(base, a, queries, k: int):
    """K1's select form on the card: (scores [B, k] f32, rows [B, k] i32)
    ascending, ties to the lower row, (inf, -1) past the rows."""
    from . import _build

    if base.dtype not in _ROW_CODE:
        raise ValueError("base must be float32, float16 or bfloat16 (got "
                         f"{base.dtype})")
    _check_cuda("base", base, base.dtype, 2)
    _check_cuda("a", a, torch.float32, 1, base.device)
    _check_cuda("queries", queries, torch.float32, 2, base.device)
    n, d = base.shape
    b = queries.shape[0]
    if a.shape[0] != n or queries.shape[1] != d:
        raise ValueError(f"shape mismatch: base {tuple(base.shape)}, "
                         f"a {tuple(a.shape)}, queries {tuple(queries.shape)}")
    if k < 1:
        raise ValueError(f"k must be positive (got {k})")
    if n == 0 or b == 0 or d == 0:
        raise ValueError("empty base, queries or feature dimension")
    if n >= 2**31:
        raise ValueError(f"at most 2^31 - 1 rows (got {n})")
    dev = base.device
    k_eff = min(k, n)
    order = k_eff <= _K1S_SORT_CAP
    chunks = _k1s_plan(n, b)
    bc = chunks[0][1]
    keys = torch.empty((bc, n), dtype=torch.int64, device=dev)
    hist = torch.empty((bc, _K1S_BINS), dtype=torch.int32, device=dev)
    state = torch.empty((bc, 8), dtype=torch.int64, device=dev)
    cand = torch.empty((bc, _K1S_CAP), dtype=torch.int64, device=dev)
    sel = torch.empty((bc, k), dtype=torch.int64, device=dev)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    lib = _build.lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c0, c1 in chunks:
        qg, rows, per = _k1s_grid(n, c1 - c0, _block_target(dev))
        with torch.cuda.device(dev):  # the C entry launches on the current one
            rc = lib.pgv_k1_select_topk(
                base.data_ptr(), _ROW_CODE[base.dtype], a.data_ptr(),
                queries[c0].data_ptr(), n, d, c1 - c0, k, qg, rows, per,
                keys.data_ptr(), hist.data_ptr(), state.data_ptr(),
                cand.data_ptr(), sel.data_ptr(), int(order),
                out_d[c0].data_ptr(), out_i[c0].data_ptr(), stream)
        _build.check(rc, "pgv_k1_select_topk")
        LAUNCHES["k1_select"] += 1
        if not order:  # the selected keys, ordered here
            sk = torch.sort(sel[: c1 - c0, :k_eff] ^ _SIGN_BIT, dim=1).values
            sd, si = _from_order_keys(sk)
            out_d[c0:c1, :k_eff] = sd
            out_i[c0:c1, :k_eff] = si.to(torch.int32)
            out_d[c0:c1, k_eff:] = float("inf")
            out_i[c0:c1, k_eff:] = -1
    return out_d, out_i


def _surrogate_topk(base, a, queries, k: int):
    """Exact top-k of ``a - 2 q.x`` -> (scores [B,k] f32, ids [B,k] i32),
    ascending; excluded/empty slots are (inf, -1). ``base`` is f32, f16 or
    bf16 (K1 reads 2-byte rows as stored; the plain version widens them),
    ``queries`` f32. CPU tensors take the plain version; CUDA tensors K1's
    select form past k = 60 or at few queries (``_k1s_max_b``), else its
    tensor-core form."""
    if not base.is_cuda:
        sd, si = _surrogate_topk_plain(base, a, queries, k)
    elif (k > _K1_TC_MAX_K
          or queries.shape[0] <= _k1s_max_b(k, base.dtype)):
        sd, si = _select_topk_cuda(base, a, queries, k)
    else:
        sd, si = _surrogate_topk_cuda(base, a, queries, k)
    return _invalid_to_sentinel(sd, si)


def _row_term(base, use_x2: bool):
    if use_x2:
        xf = base.float()
        return (xf * xf).sum(dim=1)
    return torch.zeros(base.shape[0], dtype=torch.float32, device=base.device)


def l2_topk(base, queries, k: int):
    """Exact k nearest (squared l2) -> (dists [B,k], ids [B,k]), sorted."""
    sd, si = _surrogate_topk(base, _row_term(base, True), queries, k)
    qf = queries.float()
    q2 = (qf * qf).sum(dim=1, keepdim=True)
    d = torch.where(si >= 0, torch.clamp(sd + q2, min=0.0),
                    torch.full_like(sd, float("inf")))
    return d, si


def ip_topk(base, queries, k: int):
    """Exact k largest inner products -> IP order distances (-dot) + ids."""
    sd, si = _surrogate_topk(base, _row_term(base, False), queries, k)
    return torch.where(si >= 0, sd * 0.5, sd), si


def cosine_topk(base_normed, queries_normed, k: int):
    """Exact k nearest by cosine distance over PRE-NORMALIZED rows."""
    sd, si = _surrogate_topk(
        base_normed, _row_term(base_normed, False), queries_normed, k
    )
    d = 1.0 + torch.clamp(sd * 0.5, -1.0, 1.0)
    return torch.where(si >= 0, d, sd), si


# ---------------------------------------------------------------------------
# K2: binned bf16 sweep
# ---------------------------------------------------------------------------


def _binned_plain(base, a, queries, k: int, tn: int):
    """Plain version of K2: per-bin minimum over [B, N/tn, tn] of the
    bf16-operand, f32-accumulated scores, then top-k over the tn bins.
    Returns (scores [B,k] f32, ids [B,k] i32), ascending."""
    n = base.shape[0]
    b = queries.shape[0]
    pn = (-n) % tn
    # bf16-rounded operands, f32 products and sums (bf16 x bf16 is exact
    # in f32): the K2 kernel's arithmetic up to summation order
    q = queries.float().to(torch.bfloat16).float()
    x = base.to(torch.bfloat16).float()
    av = a.float()
    if pn:
        x = torch.cat([x, x.new_zeros((pn, x.shape[1]))])
        av = torch.cat([av, av.new_full((pn,), _NEG_BIG)])
    s = av[None, :] - 2.0 * (q @ x.T)  # [B, Np]
    mn, tile = s.view(b, -1, tn).min(dim=1)  # [B, tn] per-bin minima
    col = torch.arange(tn, device=s.device)
    ids = tile * tn + col[None, :]
    kk = min(k, tn)
    sd, slot = torch.topk(mn, kk, dim=1, largest=False, sorted=True)
    si = torch.gather(ids, 1, slot).to(torch.int32)
    si = torch.where(si < n, si, torch.full_like(si, -1))
    if kk < k:
        sd = torch.cat([sd, sd.new_full((b, k - kk), float("inf"))], 1)
        si = torch.cat([si, si.new_full((b, k - kk), -1)], 1)
    return sd, si


def _k2_bins_per_block(d: int, dtype) -> int:
    """K2's form for rows of width ``d``: its resident form (64 bins a
    block) for bf16 rows up to ``_K2_RESIDENT_MAX_D``, else the streamed
    one (128)."""
    if dtype == torch.bfloat16 and d <= _K2_RESIDENT_MAX_D:
        return _K2_BINS
    return _K2S_BINS


def _binned_cuda(base, a, queries, k: int, tn: int):
    from . import _build

    if base.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError("base must be bfloat16 or float16 (got "
                         f"{base.dtype})")
    _check_cuda("base", base, base.dtype, 2)
    _check_cuda("a", a, torch.float32, 1, base.device)
    _check_cuda("queries", queries, torch.bfloat16, 2, base.device)
    n, d = base.shape
    b = queries.shape[0]
    if a.shape[0] != n or queries.shape[1] != d:
        raise ValueError(f"shape mismatch: base {tuple(base.shape)}, "
                         f"a {tuple(a.shape)}, queries {tuple(queries.shape)}")
    if not 1 <= k <= min(_MAX_K, tn):
        raise ValueError(f"k must be in [1, {min(_MAX_K, tn)}] (got {k})")
    if tn <= 0 or tn % 128:
        raise ValueError(f"tn must be a positive multiple of 128 (got {tn})")
    if n == 0 or b == 0 or d == 0:
        raise ValueError("empty base, queries or feature dimension")
    if b > _K2_QTILE * 65535 or n + tn > 2**31:
        raise ValueError(f"at most {_K2_QTILE * 65535} queries and 2^31 - "
                         f"tn rows per call (got {b}, {n})")
    dev = base.device
    bins_per_block = _k2_bins_per_block(d, base.dtype)
    target = (_block_target(dev) if bins_per_block == _K2_BINS
              else _sm_count(dev))
    _, _, splits, tiles_per_split = _k2_plan(n, b, tn, target, bins_per_block)
    if a.data_ptr() % 16:  # the resident form copies `a` 16 bytes at a time
        a = a.clone()
    bins = torch.empty((b, tn), dtype=torch.int64, device=dev)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().pgv_k2_binned_topk(
            base.data_ptr(), _ROW_CODE[base.dtype], a.data_ptr(),
            queries.data_ptr(), n, d, b, k, tn, bins_per_block, splits,
            tiles_per_split, bins.data_ptr(), out_d.data_ptr(),
            out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "pgv_k2_binned_topk")
    LAUNCHES["k2_binned"] += 1
    return out_d, out_i


def binned_sweep_topk(base_bf16, a, queries, k: int, metric: str,
                      tn: int = 1024):
    """Fused bf16 sweep + binned top-k -> (distances [B,k], ids [B,k]).

    ``base_bf16`` is bf16, or f16 that K2 rounds to bf16 as it reads it
    (the plain version casts). Scores are bf16 operands with f32
    accumulation; selection keeps the
    best row per bin (bin = row mod tn), so two true top-k rows in one bin
    keep only the nearer (expected recall loss ~ (k-1)/(2 tn)). Rows with
    ``a >= _NEG_BIG`` come back as -1 / inf. Distances are restored per
    metric from the bf16 scores: callers that return them rescore in f32.
    """
    if base_bf16.is_cuda:
        q_bf = queries.float().to(torch.bfloat16).contiguous()
        sd, si = _binned_cuda(base_bf16, a, q_bf, k, tn)
    else:
        sd, si = _binned_plain(base_bf16, a, queries, k, tn)
    return _restore_metric(*_invalid_to_sentinel(sd, si), queries, metric)


def _restore_metric(sd, si, queries, metric: str):
    """Surrogate scores ``a - 2 q.x`` -> metric distances (sweeps over
    pre-normalized rows for cosine); empty slots stay (inf, -1)."""
    if metric == "l2":
        qf = queries.float()
        true_d = torch.clamp(sd + (qf * qf).sum(dim=1, keepdim=True), min=0.0)
    elif metric == "ip":
        true_d = sd * 0.5
    elif metric == "cosine":  # over pre-normalized rows
        true_d = 1.0 + torch.clamp(sd * 0.5, -1.0, 1.0)
    else:
        raise ValueError(f"bf16 sweeps support l2/ip/cosine, not {metric!r}")
    return torch.where(si >= 0, true_d, sd), si


# ---------------------------------------------------------------------------
# K3: packed tile-min bf16 sweep
# ---------------------------------------------------------------------------

#: low bits of a packed score that carry the column (so tn <= 1024)
_ID_BITS = 10
_ID_MASK = (1 << _ID_BITS) - 1


def _check_tn(tn: int) -> None:
    if tn <= 0 or tn % 128 or tn > 1 << _ID_BITS:
        raise ValueError(
            f"tn must be a multiple of 128 and at most {1 << _ID_BITS} (the "
            f"packed id field has {_ID_BITS} bits), got {tn}"
        )


def _row_sq_max_plain(base_bf16):
    """Plain version of ``k3_x2max_kernel``: max over rows of the f32 sum
    of squares -> 0-d f32 tensor."""
    xf = base_bf16.float()
    return (xf * xf).sum(dim=1).max()


def _row_sq_max_cuda(base_bf16):
    from . import _build

    _check_cuda("base", base_bf16, torch.bfloat16, 2)
    n, d = base_bf16.shape
    if n == 0 or d == 0:
        raise ValueError("empty base or feature dimension")
    dev = base_bf16.device
    out = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().pgv_k3_x2max(
            base_bf16.data_ptr(), n, d, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "pgv_k3_x2max")
    LAUNCHES["k3_x2max"] += 1
    return out


def _row_sq_max(base_bf16):
    """max_r ||x_r||^2 (f32 sums) -> 0-d f32 tensor, in one pass over the
    bf16 rows with no f32 copy of them on the card. CPU tensors take the
    plain version, CUDA tensors the kernel."""
    if base_bf16.is_cuda:
        return _row_sq_max_cuda(base_bf16)
    return _row_sq_max_plain(base_bf16)


def _tilemin_prepare(base_bf16, a, queries, x2max=None):
    """Operands of the tile-min sweep, as the TPU wrapper forms them:
    bf16 queries pre-scaled by 2, the row term shifted so every live
    score is positive (|2 q.x| <= q2 + x2), excluded rows (a >= 1.5e38)
    kept unshifted. ``x2max`` is the corpus's largest squared row norm
    (``_row_sq_max`` when None). Returns (q2x bf16 [B, D], av f32 [N],
    shift f32 [])."""
    qf = queries.float()
    if x2max is None:
        x2max = _row_sq_max(base_bf16)
    shift = x2max + (qf * qf).sum(dim=1).max() + 1.0
    af = a.float()
    av = torch.where(af >= _NEG_BIG * 0.5, af, af + shift)
    return (2.0 * qf).to(torch.bfloat16).contiguous(), av.contiguous(), shift


def _tilemin_packed_plain(base_bf16, av, q2x, tn: int):
    """Plain version of K3's sweep: [B, ceil(N/tn)] int32, each the min
    over a tile of (f32 score bits with the low 10 bits cleared) | col."""
    n = base_bf16.shape[0]
    pn = (-n) % tn
    x = base_bf16.float()
    if pn:
        x = torch.cat([x, x.new_zeros((pn, x.shape[1]))])
        av = torch.cat([av, av.new_full((pn,), _NEG_BIG)])
    s = av[None, :] - q2x.float() @ x.T  # [B, Np], > 0 on live rows
    col = torch.arange(s.shape[1], device=s.device, dtype=torch.int32) % tn
    packed = (s.view(torch.int32) & ~_ID_MASK) | col[None, :]
    return packed.view(s.shape[0], -1, tn).amin(dim=2)


def _tilemin_packed_cuda(base_bf16, av, q2x, tn: int):
    from . import _build

    _check_cuda("base", base_bf16, torch.bfloat16, 2)
    _check_cuda("a", av, torch.float32, 1, base_bf16.device)
    _check_cuda("queries", q2x, torch.bfloat16, 2, base_bf16.device)
    n, d = base_bf16.shape
    b = q2x.shape[0]
    if av.shape[0] != n or q2x.shape[1] != d:
        raise ValueError(f"shape mismatch: base {tuple(base_bf16.shape)}, "
                         f"a {tuple(av.shape)}, queries {tuple(q2x.shape)}")
    if n == 0 or b == 0 or d == 0:
        raise ValueError("empty base, queries or feature dimension")
    _check_tn(tn)
    # the grid's x dimension counts query tiles (at most 2^31 - 1 blocks),
    # so the int query count bounds it; rows are int too
    if b > 2**31 - _K3_QTILE or n + tn > 2**31:
        raise ValueError(f"at most 2^31 - {_K3_QTILE} queries and 2^31 - "
                         f"tn rows per call (got {b}, {n})")
    _, splits, tiles_per_split = _k3_plan(n, b, tn,
                                          _block_target(base_bf16.device))
    nc = -(-n // tn)
    dev = base_bf16.device
    out = torch.empty((b, nc), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().pgv_k3_tilemin(
            base_bf16.data_ptr(), av.data_ptr(), q2x.data_ptr(), n, d, b, tn,
            nc, splits, tiles_per_split, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(rc, "pgv_k3_tilemin")
    LAUNCHES["k3_tilemin"] += 1
    return out


def _tilemin_unpack(packed, shift, n: int, k: int, tn: int):
    """Top-k over the packed tile minima -> (scores [B,k] f32 with the
    shift taken back off, ids [B,k] i32), ascending; pad columns and
    excluded rows come back as (inf, -1)."""
    b, nc = packed.shape
    kk = min(k, nc)
    v, slot = torch.topk(packed, kk, dim=1, largest=False, sorted=True)
    sd = (v & ~_ID_MASK).view(torch.float32) - shift
    si = slot.to(torch.int32) * tn + (v & _ID_MASK)
    sd, si = _invalid_to_sentinel(sd, torch.where(si < n, si, -1))
    if kk < k:
        sd = torch.cat([sd, sd.new_full((b, k - kk), float("inf"))], 1)
        si = torch.cat([si, si.new_full((b, k - kk), -1)], 1)
    return sd, si


def _tilemin_plain(base_bf16, a, queries, k: int, tn: int):
    """Plain version of K3 end to end -> (scores [B,k], ids [B,k])."""
    _check_tn(tn)
    q2x, av, shift = _tilemin_prepare(base_bf16, a, queries,
                                      _row_sq_max_plain(base_bf16))
    packed = _tilemin_packed_plain(base_bf16, av, q2x, tn)
    return _tilemin_unpack(packed, shift, base_bf16.shape[0], k, tn)


def _tilemin_cuda(base_bf16, a, queries, k: int, tn: int):
    """K3 end to end on the card -> (scores [B,k], ids [B,k])."""
    _check_tn(tn)
    q2x, av, shift = _tilemin_prepare(base_bf16, a, queries)
    packed = _tilemin_packed_cuda(base_bf16, av, q2x, tn)
    return _tilemin_unpack(packed, shift, base_bf16.shape[0], k, tn)


def tilemin_sweep_topk(base_bf16, a, queries, k: int, metric: str,
                       tn: int = 1024):
    """Fused bf16 sweep + per-tile packed min -> (distances [B,k], ids).

    One winner per ``tn``-row corpus tile (selection loss ~ (k-1) /
    (2 N/tn), the binned regime with bins = tiles); the packing keeps ~13
    mantissa bits of each score, so callers that return distances rescore
    the k winners in f32. Rows with ``a >= _NEG_BIG`` come back as -1 /
    inf. ``tn`` is at most 1024: the column lives in 10 bits (the TPU
    wrapper also takes 2048 and then loses the column's top bit)."""
    if base_bf16.is_cuda:
        sd, si = _tilemin_cuda(base_bf16, a, queries, k, tn)
    else:
        sd, si = _tilemin_plain(base_bf16, a, queries, k, tn)
    return _restore_metric(sd, si, queries, metric)


# ---------------------------------------------------------------------------
# K7: the coarse seed sweep
# ---------------------------------------------------------------------------

#: K7's queries per block and upper rows per chunk (one block an SM)
_K7_QTILE = _K7_CHUNK = 128
#: the most seeds K7 keeps a query (csrc/k7_coarse.cu's k7MaxSeeds; every
#: caller asks for 8 or fewer)
_K7_MAX_SEEDS = 8


def _coarse_plain(rows, a, upper_ids, traversable, queries, s: int,
                  l2: bool):
    """Plain version of K7: the [B, U] f32 scores ``a - 2 q.x`` (l2) or
    ``a - q.x`` of bf16-rounded operands, the rows whose element is not
    traversable at +inf, ``torch.topk``. Returns (slots, element ids)
    [B, s] int64, -1 past the finite scores."""
    q = queries.to(torch.bfloat16).float()
    dots = q @ rows.to(torch.bfloat16).float().T
    scores = a[None, :] - (2.0 * dots if l2 else dots)
    scores = torch.where(traversable[upper_ids][None, :], scores,
                         float("inf"))
    sc, slots = torch.topk(scores, s, dim=1, largest=False, sorted=True)
    fin = torch.isfinite(sc)
    return (torch.where(fin, slots, -1),
            torch.where(fin, upper_ids[slots], -1))


#: K7's one-query form: rows of a lane group in flight (k7_coarse.cu's
#: k7gRows), warps a block; its scratch, kept per device and stream (the
#: blocks' lists and the ticket, which the last block resets to 0)
_K7G_ROWS, _K7G_WARPS = 4, 8
_K7G_SCRATCH: dict = {}


def _k7_one_grid(n: int, d: int, target: int):
    """K7's one-query grid: (lanes a row, blocks). A row's 16-byte chunks
    over a power of two of lanes (at most 32); blocks enough for the rows,
    at most ``target`` (the caller's: three an SM, as many 256-thread
    blocks as its ~72 registers a thread let an SM hold, so one wave)."""
    lanes = 1
    while lanes < 32 and lanes * 8 < d:
        lanes *= 2
    rows_per_block = _K7G_WARPS * (32 // lanes) * _K7G_ROWS
    return lanes, max(1, min(target, -(-n // rows_per_block)))


def _coarse_one_cuda(rows, a, upper_ids, traversable, query, s: int,
                     l2: bool):
    """K7's one-query form (one launch): (slots, element ids) [1, s]."""
    from . import _build

    dev = rows.device
    n, d = rows.shape
    lanes, blocks = _k7_one_grid(n, d, 3 * _sm_count(dev))
    # the raw handle of the current stream (torch.cuda.current_stream
    # builds a Stream object a call)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    key = (dev.index, stream)
    part, ticket = _K7G_SCRATCH.get(key, (None, None))
    if part is None or part.numel() < blocks * s:
        part = torch.empty(blocks * _K7_MAX_SEEDS, dtype=torch.int64,
                           device=dev)
        ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        _K7G_SCRATCH[key] = (part, ticket)
    out = torch.empty((2, 1, s), dtype=torch.int64, device=dev)
    q = query if query.dtype == torch.float32 else query.float()
    rc = _build.lib().pgv_k7_coarse_one(
        rows.data_ptr(), a.data_ptr(), upper_ids.data_ptr(),
        traversable.data_ptr(), q.contiguous().data_ptr(), n, d, s,
        int(l2), lanes, blocks, part.data_ptr(), ticket.data_ptr(),
        out.data_ptr(), out[1].data_ptr(), stream)
    _build.check(rc, "pgv_k7_coarse_one")
    LAUNCHES["k7_coarse_one"] += 1
    return out.unbind(0)


def _coarse_cuda(rows, a, upper_ids, traversable, queries, s: int,
                 l2: bool):
    from . import _build

    _check_cuda("rows", rows, torch.bfloat16, 2)
    dev = rows.device
    _check_cuda("a", a, torch.float32, 1, dev)
    _check_cuda("upper_ids", upper_ids, torch.int64, 1, dev)
    _check_cuda("traversable", traversable, torch.bool, 1, dev)
    n, d = rows.shape
    if queries.device != dev or queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError(f"queries {tuple(queries.shape)} on "
                         f"{queries.device} do not fit rows {(n, d)} on {dev}")
    if a.shape[0] != n or upper_ids.shape[0] != n:
        raise ValueError(f"shape mismatch: rows {(n, d)}, a "
                         f"{tuple(a.shape)}, upper_ids {tuple(upper_ids.shape)}")
    if not 1 <= s <= _K7_MAX_SEEDS:
        raise ValueError(f"K7 keeps 1 to {_K7_MAX_SEEDS} seeds a query in "
                         f"registers (got {s})")
    if rows.data_ptr() % 16:
        raise ValueError("rows must start on a 16-byte boundary")
    b = queries.shape[0]
    if n == 0 or b == 0 or d == 0:
        raise ValueError("empty rows, queries or feature dimension")
    if b == 1:
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):  # the C entry launches on it
                return _coarse_one_cuda(rows, a, upper_ids, traversable,
                                        queries, s, l2)
        return _coarse_one_cuda(rows, a, upper_ids, traversable, queries, s,
                                l2)
    qb = queries.to(torch.bfloat16).contiguous()
    _, splits, rows_per_split = _k1_plan(n, b, _sm_count(dev), _K7_QTILE,
                                         _K7_CHUNK)
    part = torch.empty((b, splits, 2, s), dtype=torch.int64, device=dev)
    out_slot = torch.empty((b, s), dtype=torch.int64, device=dev)
    out_id = torch.empty((b, s), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):  # the C entry launches on the current one
        rc = _build.lib().pgv_k7_coarse_topk(
            rows.data_ptr(), a.data_ptr(), upper_ids.data_ptr(),
            traversable.data_ptr(), qb.data_ptr(), n, d, b, s, int(l2),
            splits, rows_per_split, part.data_ptr(), out_slot.data_ptr(),
            out_id.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "pgv_k7_coarse_topk")
    LAUNCHES["k7_coarse"] += 1
    return out_slot, out_id


def coarse_topk(rows, a, upper_ids, traversable, queries, s: int, l2: bool):
    """The ``s`` upper rows of smallest ranking score per query -> (slots,
    element ids) [B, s] int64, -1 past the finite scores, nearest first.

    ``rows`` [U, D] are the upper rows (bf16 on the card), ``a`` [U] their
    f32 row term (the sum of the bf16 row's squares for l2, else 0),
    ``upper_ids`` [U] their element ids and ``traversable`` [cap + 1] the
    graph's mask; the score is ``a - 2 q.x`` (``l2``) or ``a - q.x`` of
    bf16-rounded operands with f32 sums, +inf on rows whose element is not
    traversable. CPU tensors take the plain version, CUDA tensors kernel K7
    (ties go to the lower slot; the kernel's sums run in another order than
    the plain GEMM's, so exact ties of the bf16 scores may order
    differently)."""
    if not rows.is_cuda:
        return _coarse_plain(rows, a, upper_ids, traversable, queries, s, l2)
    return _coarse_cuda(rows, a, upper_ids, traversable, queries, s, l2)
