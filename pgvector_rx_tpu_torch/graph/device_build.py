"""Batched device bulk build of the PyTorch port: HNSW construction as
tensor ops on one device.

The counterpart of ``pgvector_rx_tpu/graph/device_build.py``, for the
dense kind (l2 / ip / cosine / l1) and the bit kind (hamming / jaccard).
Construction runs in batches against a
frozen graph snapshot; batch sizes double from 1 up to ``batch_max``:

1. **Score and select** (``_score_select_step``). Ground-layer
   candidates come from an exact sweep over the committed prefix while
   fewer than ``_DESCENT_MIN_WIDTH`` rows are committed (the "ramp"), and
   after that from one of two grounds, chosen as the JAX package chooses
   (``ground="auto"``: "ivf" for l2 / ip / cosine below 512 dimensions,
   "beam" otherwise). "ivf": the members of the 16 nearest committed
   upper-layer cells plus the layer-0 neighbours of the 16 nearest
   members (``_ivf_ground_candidates``). "beam": an ef_construction-wide
   best-first walk over the as-built layer 0 from the 16 nearest
   committed upper rows and the entry, 16 fixed steps of 4 expansions,
   merged by two sorts or by ranks (``_beam_ground_candidates``: the walk
   is kernel K8, ``csrc/k8_beam_ground.cu``, on CUDA tensors, one launch a
   batch, and its plain version ``_beam_ground_plain`` on CPU tensors). Upper
   layers score the compact table of level >= 1 rows (and one sub-table
   per layer >= 2). Every layer selects with the fixpoint-parallel
   Algorithm 4 (``_select_neighbors_parallel``), RobustPrune's alpha
   included.
2. **Commit** (``_commit_all_step``): duplicate folding (<= 10 heap TIDs
   per element), forward edges, the member-table append, entry promotion,
   then the back edges of both layer kinds, grouped by target with stable
   sorts and re-selected per target.

The JAX names are kept so a reader can find each counterpart. What
differs, in PyTorch idiom:

- Plain functions on tensors on an explicit ``device``; the build state
  (``BuildArrays``) is updated in place. ``run_all`` is a Python loop over
  the batch schedule; no batch makes a host sync (all per-batch decisions
  come from the host-side ``start``).
- Adjacency is stored as separate id (int32) and pruning-distance
  (bfloat16, as the JAX package stores them) tensors, so there is no
  packed int32 layout. Ids stay int32 in the tables and widen at gathers.
- Selections take an exact ``torch.topk`` where the JAX build takes
  ``lax.approx_min_k`` (upper tables of 16,384 rows or more).
- ``vmap`` over queries becomes a batch dimension: the beam ground's walk
  is [B, efc] tensors stepped a fixed number of times.
- l1 scores go through ``torch.cdist(p=1)`` (direct differences, f32
  sums, no [B, rows, D] temporary) where the JAX package materialises the
  differences and leaves their fusion to XLA.
- The finished ``DeviceGraph`` has ``cap`` = the number of built rows and
  the JAX graph's padded capacity only as its ``capacity`` figure; row
  ``cap`` is the sentinel.

The bit kind builds on unpacked {0,1} f32 rows: hamming is squared l2
over them (builder metric "l2"), and jaccard derives from the same
identity (builder metric "jacbits", ``_l2_to_jaccard``); every score,
Algorithm 4's pruning and the duplicate fold are exact there, and the
serving graph's words are packed on the device (``_pack_words_device``).
Bit corpora always take the beam ground (``_bit_ground_pin``). The bits
are prepared in one vectorised pass (``ops/bits.prepare_rows``) where the
JAX package calls ``prepare_value`` row by row.

``bulk_insert`` (``HnswIndex.insert_bulk``) inserts into an existing index
with the same builder: the graph is transplanted into fresh build tensors
(``_seed_builder_from_graph``, edge distances recomputed exactly on the
device) and the new rows run as doubling batches on top of it.

The JAX package's ``PGV_BUILD_*`` environment variables are read once
per build into a ``BuildSettings`` (``BuildSettings.from_env``): those
that change the graph as JAX reads them, the upload-streaming ones
accepted and ignored (the port has no streamed upload), and the rest
refused with ``NotImplementedError`` naming their ROADMAP entry.
``bulk_build(consume_input=True)`` releases the caller's corpus tensor
once the build holds its own copy.

Instrumentation, as in the JAX package: ``PGV_BUILD_TIMING`` prints the
builder's init steps, the build's phases and each batch's time to stderr;
``PGV_BUILD_DEBUG`` prints each batch's candidate search and its commit's
three parts (forward lists, layer-0 back edges, upper back edges); a list
bound to ``GROUP_STATS`` collects one ``(width, rows, seconds)`` tuple per
batch. Each synchronises the build's device, and only when asked; none
changes the graph.
"""

from __future__ import annotations

import dataclasses
import math
import os
import sys
import time
import warnings
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..constants import HNSW_HEAPTIDS, hnsw_get_layer_m
from ..ops import bits, bruteforce
from ..ops.beam import row_dists

#: cap at/above which the back-edge commit honours 2 same-target adds per
#: commit instead of 4 (see DeviceBuilder._be_k)
_BE_K2_MIN_CAP = 1 << 19

#: committed-prefix width at which ground candidates switch from the exact
#: ramp sweep to the IVF member table, unless PGV_BUILD_DESCENT_MIN is set
#: (tests patch this module constant)
_DESCENT_MIN_WIDTH = 65536

#: the beam ground's upper-row seeds
_BEAM_SEEDS = 16

#: rows per block of the l1 sweep (bounds its [B, rows] scores)
_L1_CHUNK = 8192

_INF = float("inf")

#: PGV_BUILD_* names the JAX package reads only to schedule its streamed
#: host-to-device upload, which the port does not have: accepted, no-ops
_BUILD_ENV_NOOP = ("PGV_BUILD_STREAM", "PGV_BUILD_STREAM_MIN",
                   "PGV_BUILD_STREAM_CHUNK")

_NOT_TO_PORT = "ROADMAP queue 1, 'Not to port'"

#: PGV_BUILD_* names the port refuses: name -> (the values the JAX package
#: acts on, the ROADMAP entry that says why they are not ported)
_BUILD_ENV_REFUSED = {
    "PGV_BUILD_ABLATE": (lambda v: any(v.split(",")), _NOT_TO_PORT),
    "PGV_BUILD_UPPER_STRATIFY": (lambda v: int(v) != 0, _NOT_TO_PORT),
    "PGV_BUILD_IP_AUG": (lambda v: v != "0", _NOT_TO_PORT),
    "PGV_BUILD_RAMP": (lambda v: v == "buckets", _NOT_TO_PORT),
    "PGV_BUILD_CAP_FLOOR": (lambda v: int(v) != 0, _NOT_TO_PORT),
    "PGV_BUILD_UPPER_FLOOR": (lambda v: int(v) != 0, _NOT_TO_PORT),
    "PGV_BUILD_SUB_FLOORS": (lambda v: any(x.strip() for x in v.split(",")),
                             _NOT_TO_PORT),
}

#: when bound to a list, ``DeviceBuilder.run_all`` appends one (width,
#: rows, seconds) tuple per batch (the width the JAX package's
#: ``_width_for`` gives it), synchronising the device after each batch so
#: the times are real (the JAX package appends one per dispatched group
#: of batches)
GROUP_STATS: list | None = None


@dataclass(frozen=True)
class BuildSettings:
    """The JAX package's build knobs that change the graph, with its
    defaults (``PGV_BUILD_<NAME>`` for each field, upper-cased).

    ``alpha`` / ``alpha_upper``: RobustPrune's alpha at layer 0 / the upper
    layers. ``ivf_cap``: members kept per upper cell; ``ivf_probes``: cells
    probed per query; ``ivf_hop``: member candidates whose layer-0
    neighbours are scored, every ``ivf_hop_stride``-th of them. ``be_k``:
    same-target back-edge adds per commit (0: the size rule). ``batch``:
    the batch width (0: the build's and the insert's own rules).
    ``seed_cq``: queries per chunk of the merged upper sweep (0: JAX's
    rule). ``beam_steps`` (0: 16), ``beam_expand``, ``beam_dedup`` and
    ``beam_merge`` ("sort" or "rank"): the beam ground's walk. ``ground``:
    "auto", "ivf" or "beam". ``timing`` / ``debug``: the stderr lines of
    the module docstring (they change no graph)."""

    descent_min: int = 65536
    alpha: float = 1.0
    alpha_upper: float = 1.0
    ivf_cap: int = 64
    ivf_probes: int = 16
    ivf_hop: int = 16
    ivf_hop_stride: int = 1
    be_k: int = 0
    batch: int = 0
    seed_cq: int = 0
    beam_steps: int = 0
    beam_expand: int = 4
    beam_dedup: bool = True
    beam_merge: str = "sort"
    ground: str = "auto"
    timing: bool = False
    debug: bool = False

    @classmethod
    def from_env(cls, env=None) -> "BuildSettings":
        """The settings as the JAX package reads ``env`` (default
        ``os.environ``); an unset or empty variable keeps the default,
        ``PGV_BUILD_DESCENT_MIN``'s being ``_DESCENT_MIN_WIDTH``. Read per
        build: the JAX package reads ``DESCENT_MIN`` at import and most
        others when it traces, so toggling one there needs a fresh process
        or ``jax.clear_caches()``; here the next build sees it."""
        env = os.environ if env is None else env
        for var, (acts, entry) in _BUILD_ENV_REFUSED.items():
            val = env.get(var, "")
            if val and acts(val):
                raise NotImplementedError(
                    f"{var}={val} is not ported to the torch device build "
                    f"({entry})")
        kw = {}
        for f in dataclasses.fields(cls):
            val = env.get("PGV_BUILD_" + f.name.upper(), "")
            if val == "":
                continue
            kind = type(f.default)
            kw[f.name] = val != "0" if kind is bool else kind(val)
        kw.setdefault("descent_min", _DESCENT_MIN_WIDTH)
        out = cls(**kw)
        for name, low in (("batch", 0), ("ivf_cap", 1), ("ivf_probes", 1),
                          ("ivf_hop", 0), ("beam_expand", 0)):
            if getattr(out, name) < low:
                raise ValueError(f"PGV_BUILD_{name.upper()} must be >= {low}")
        return out


def _beam_merge_checked(merge: str, dedup: bool) -> str:
    """The beam ground's merge, refused as the JAX package refuses it."""
    if merge not in ("sort", "rank"):
        raise ValueError(f"PGV_BUILD_BEAM_MERGE={merge!r}: must be 'sort' "
                         "or 'rank'")
    if merge == "rank" and not dedup:
        # the ranks are a permutation only under the per-step dedup
        raise ValueError("PGV_BUILD_BEAM_DEDUP=0 is incompatible with "
                         "PGV_BUILD_BEAM_MERGE=rank (rank always dedups)")
    return merge


# ---------------------------------------------------------------------------
# schedule and capacity helpers
# ---------------------------------------------------------------------------


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 1).bit_length()


def cap_pad_for(n: int) -> int:
    """Padded array capacity for an n-row corpus (1/8-octave buckets, as
    the JAX builder pads; the last padded row is the scatter dump row)."""
    granule = max(4096, _next_pow2(n + 1) // 8)
    return -(-(n + 1) // granule) * granule


def batch_schedule(n: int, batch_max: int):
    """Doubling schedule: 1, 1, 2, 4, ... capped at batch_max."""
    out = []
    pos = 1  # element 0 seeds the graph
    size = 1
    while pos < n:
        take = min(size, batch_max, n - pos)
        out.append((pos, take))
        pos += take
        size = min(size * 2, batch_max)
    return out


def batch_max_for(n: int) -> int:
    """Batch width rule of the JAX bulk build: ~sqrt(n/16), 64..1024."""
    return min(1024, max(64, (1 << max(n // 16, 1).bit_length()) >> 1))


def _tids_array(ids) -> np.ndarray:
    """Id sequence -> int64 array (range -> arange, no Python ints)."""
    if isinstance(ids, range):
        return np.arange(ids.start, ids.stop, ids.step, dtype=np.int64)
    return np.asarray(list(ids) if not hasattr(ids, "__len__") else ids,
                      dtype=np.int64)


def _prepare_dense_bulk(index, data, ids):
    """Vectorized dense prepare: shape check once, cosine normalize with
    zero-norm rows skipped (build.rs:426-438), non-finite rows refused.
    Returns (rows [n, dim] f32, tids [n] int64)."""
    arr = np.asarray(data, dtype=np.float32)
    if arr.ndim != 2 or arr.shape[1] != index.dim:
        raise ValueError(f"expected {index.dim} dimensions")
    tids = _tids_array(ids)
    if index.metric == "cosine":
        norms = np.sqrt(
            np.sum(arr.astype(np.float64) ** 2, axis=1, keepdims=True)
        )
        keep = norms[:, 0] > 0.0
        arr = (arr[keep].astype(np.float64) / norms[keep]).astype(np.float32)
        tids = tids[keep]
    if not np.isfinite(arr).all():
        raise ValueError("NaN or infinity not allowed in vector")
    return arr, tids


def _prepare_dense_device(index, data: torch.Tensor, ids):
    """The same prepare for a corpus tensor, on its own device: one sync
    for the finite check and, for cosine, one download of the keep mask.
    Cosine divides in f32 here (the numpy prepare divides in f64), so the
    two may differ in the last ulp of normalized values. Halfvec indexes
    round through float16. Returns (rows [n, dim] f32, tids [n] int64)."""
    if data.dim() != 2 or data.shape[1] != index.dim:
        raise ValueError(f"expected {index.dim} dimensions")
    tids = _tids_array(ids)
    v = data.float()
    if not bool(torch.isfinite(v).all()):
        raise ValueError("NaN or infinity not allowed in vector")
    if index.metric == "cosine":
        norm2 = (v * v).sum(dim=1)
        keep = (norm2 > 0.0).cpu().numpy()
        if not keep.all():
            v = v[torch.from_numpy(keep).to(v.device)]
            tids = tids[keep]
        v = v / torch.sqrt((v * v).sum(dim=1, keepdim=True))
    if index.dtype is not None and index.dtype == np.float16:
        v = v.to(torch.float16).float()
    return v.contiguous(), tids


# ---------------------------------------------------------------------------
# build state
# ---------------------------------------------------------------------------


class BuildData(NamedTuple):
    """Per-build tensors that no batch changes."""

    vectors: torch.Tensor  # [cap+1, D] f32
    vectors_bf16: torch.Tensor  # [cap+1, D] bf16 (pair/pruning math)
    x2: torch.Tensor  # [cap+1] f32, ||x||^2 per row
    levels: torch.Tensor  # [cap+1] int32 (-1 on pad rows)
    upper_slot: torch.Tensor  # [cap+1] int32 (-1: no upper layers)
    # compact table of the level >= 1 rows, in shuffled slot order
    upper_vectors: torch.Tensor  # [U+1, D] f32
    upper_bf16: torch.Tensor  # [U+1, D] bf16 (order-score sweep copy)
    upper_x2: torch.Tensor  # [U+1] f32
    upper_ids: torch.Tensor  # [U+1] int32 element id per slot (pad = cap)
    # per-layer sub-tables for layers >= 2: (ids [P_l], vecs, x2)
    upper_sub: tuple = ()


@dataclass
class BuildArrays:
    """The graph as it is built (updated in place batch by batch)."""

    nb0_ids: torch.Tensor  # [cap+1, 2m] int32 layer-0 neighbours (-1 pad)
    nb0_d: torch.Tensor  # [cap+1, 2m] bf16 pruning distances (+inf pad)
    # upper layers flat, layer-major: column (layer-1)*m + j
    up_ids: torch.Tensor  # [U+1, LMAX*m] int32
    up_d: torch.Tensor  # [U+1, LMAX*m] bf16
    alive: torch.Tensor  # [cap+1] bool: committed, not duplicate-folded
    tid_counts: torch.Tensor  # [cap+1] int32 heap TIDs per element
    absorb: torch.Tensor  # [cap+1] int32 duplicate-fold target (-1 none)
    entry: torch.Tensor  # [] int64 (-1 empty)
    entry_level: torch.Tensor  # [] int32
    members: torch.Tensor  # [U+1, IVF_CAP] int32 cell members (-1 pad)
    member_counts: torch.Tensor  # [U+1] int32


# ---------------------------------------------------------------------------
# distances and selection
# ---------------------------------------------------------------------------


def _l2_to_jaccard(h, sq_a, sq_b):
    """{0,1}-row squared l2 -> jaccard distance (builder metric
    "jacbits"). For binary rows a, b: h = |a XOR b| = l2^2(a, b), popcounts
    aa = ||a||^2, bb = ||b||^2, so jaccard = 2h / (aa + bb + h); two zero
    rows (denominator 0) are 1.0, the reference's ab == 0 rule. Every term
    is a small integer in f32."""
    denom = sq_a + sq_b + h
    return torch.where(denom > 0.0,
                       2.0 * h / torch.where(denom > 0.0, denom, 1.0), 1.0)


def _pair_matrix(metric: str, rows):
    """All-pairs order distances among rows [..., C, D] -> [..., C, C],
    f32 products and sums of the (bf16) rows; l2 (and "jacbits" from it)
    through the matmul identity ||a-b||^2 = ||a||^2 + ||b||^2 - 2ab; l1
    (f32 rows) from direct differences, reduced without a [..., C, C, D]
    temporary."""
    r = rows.float()
    if metric == "l1":
        return torch.cdist(r, r, p=1)
    dots = r @ r.transpose(-1, -2)
    if metric in ("l2", "jacbits"):
        sq = (r * r).sum(dim=-1)
        h = torch.clamp(sq[..., :, None] + sq[..., None, :] - 2.0 * dots,
                        min=0.0)
        if metric == "jacbits":
            return _l2_to_jaccard(h, sq[..., :, None], sq[..., None, :])
        return h
    if metric == "ip":
        return -dots
    if metric == "cosine":
        return 1.0 - torch.clamp(dots, -1.0, 1.0)
    raise ValueError(metric)


def _select_neighbors_parallel(cand_d, cand_ids, pair, lm: int,
                               alpha_eff: float = 1.0):
    """Parallel relative-neighbourhood selection (Algorithm 4 as a
    fixpoint, graph/mod.rs:269-308): candidate i is kept iff it is closer
    to the query than to every closer KEPT candidate, by a factor
    ``alpha_eff`` (Vamana's RobustPrune: i goes only when a kept j has
    ``alpha_eff * d(j, i) <= d(q, i)``; ``alpha_eff`` is in the order
    distance's domain, alpha squared for squared l2). Each round
    recomputes every decision against the current keep set; log2(C) + 2
    rounds reach the sequential chain's fixpoint (on the CPU, where the
    test costs no device sync, they stop at the first round that changes
    nothing: every later one gives the same set). Kept candidates come
    first in distance order, then the nearest discarded ones back-fill.

    cand_d / cand_ids [B, C] sorted nearest first (+inf / -1 pads), pair
    [B, C, C]. Returns (d, ids) [B, min(lm, C)]."""
    B, C = cand_d.shape
    dev = cand_d.device
    pos = torch.arange(C, device=dev)
    earlier = pos[:, None] < pos[None, :]  # [j, i]: j before i
    pair_e = torch.where(earlier[None], pair, _INF)
    valid = torch.isfinite(cand_d)
    thresh = cand_d / alpha_eff
    keep = valid
    for _ in range(max(2, int(math.ceil(math.log2(max(C, 2)))) + 2)):
        min_kept = torch.where(keep[:, :, None], pair_e, _INF).amin(dim=1)
        nxt = (min_kept > thresh) & valid
        if not nxt.is_cuda and torch.equal(nxt, keep):
            break
        keep = nxt
    keep = keep & (torch.cumsum(keep.to(torch.int32), dim=1) <= lm)
    priority = torch.where(keep, 0, torch.where(valid, 1, 2))
    order = torch.argsort(priority * C + pos[None, :], dim=1)[:, :lm]
    out_d = torch.gather(cand_d, 1, order)
    out_ids = torch.gather(cand_ids, 1, order)
    fin = torch.isfinite(out_d)
    return torch.where(fin, out_d, _INF), torch.where(fin, out_ids, -1)


def _lexsort(*keys):
    """Permutation sorting by keys[0], then keys[1], ..., ties kept in
    input order (``lax.sort`` with ``num_keys=len(keys)``)."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else key[perm]
        o = torch.argsort(k, stable=True)
        perm = o if perm is None else perm[o]
    return perm


def _group_rank(sorted_keys):
    """(head, rank in group) of each row of a sorted key vector."""
    n = sorted_keys.shape[0]
    head = torch.ones(n, dtype=torch.bool, device=sorted_keys.device)
    head[1:] = sorted_keys[1:] != sorted_keys[:-1]
    pos = torch.arange(n, device=sorted_keys.device)
    base = torch.cummax(torch.where(head, pos, 0), dim=0).values
    return head, pos - base


def _window(s_key, s_src, s_d, K: int, same_extra=None):
    """The K requests starting at each row that share its key: (add_ids
    [R, K] (-1 pad), add_d [R, K] (+inf pad))."""
    R = s_key.shape[0]
    dev = s_key.device
    win = torch.clamp(torch.arange(R, device=dev)[:, None]
                      + torch.arange(K, device=dev)[None, :], max=R - 1)
    same = s_key[win] == s_key[:, None]
    if same_extra is not None:
        same = same & (same_extra[win] == same_extra[:, None])
    return (torch.where(same, s_src[win], -1),
            torch.where(same, s_d[win], _INF))


def _dedup_by_key(keys, d):
    """Packed beam keys [B, K] and their distances sorted by key (stable,
    so the expanded copy ``id * 2`` of an id comes first), every later
    copy of an id and every empty key (< 0) at +inf."""
    o_key, o = torch.sort(keys, dim=1, stable=True)
    o_d = torch.gather(d, 1, o)
    dup = torch.zeros_like(o_key, dtype=torch.bool)
    dup[:, 1:] = (o_key[:, 1:] >> 1) == (o_key[:, :-1] >> 1)
    return o_key, torch.where(dup | (o_key < 0), _INF, o_d)


def _rank_merge(bd, bkey, d_new, key_new):
    """One step of the beam ground's rank merge (the JAX package's
    ``merge == "rank"`` body, vmapped there, batched here): the sorted
    beam (bd, bkey) [B, W] takes the step's new entries (d_new, key_new)
    [B, N] by ranks from pairwise comparisons, with no sort.

    A new entry whose id is in the beam (either copy) or earlier in the
    step goes to +inf. Beam entries keep their order and precede new ones
    at equal distances; new entries order by (distance, index). That order
    is strict, so the ranks below W are a permutation and a scatter into
    W + 1 slots (slot W takes the overflow) rebuilds the sorted beam."""
    B, W = bd.shape
    N = d_new.shape[1]
    dev = bd.device
    ids_new, ids_beam = key_new >> 1, bkey >> 1
    idx = torch.arange(N, device=dev)
    before = idx[None, :] < idx[:, None]  # [e, e2]: e2 comes before e
    dup_beam = ((ids_new[:, :, None] == ids_beam[:, None, :])
                & (bkey >= 0)[:, None, :]).any(dim=2)
    dup_new = ((ids_new[:, :, None] == ids_new[:, None, :])
               & (key_new >= 0)[:, None, :] & before).any(dim=2)
    d_new = torch.where(dup_beam | dup_new, _INF, d_new)
    # new before beam [B, N, W]; distances are never NaN, so the beam
    # entries at or before a new one are the rest of the row
    new_first = d_new[:, :, None] < bd[:, None, :]
    rank_beam = torch.arange(W, device=dev) + new_first.sum(dim=1)
    lt_new = ((d_new[:, None, :] < d_new[:, :, None])
              | ((d_new[:, None, :] == d_new[:, :, None]) & before))
    rank_new = W - new_first.sum(dim=2) + lt_new.sum(dim=2)
    pos_b, pos_n = rank_beam.clamp(max=W), rank_new.clamp(max=W)
    sd = torch.full((B, W + 1), _INF, device=dev)
    sd = sd.scatter(1, pos_b, bd).scatter(1, pos_n, d_new)
    sk = torch.full((B, W + 1), -2, dtype=bkey.dtype, device=dev)
    sk = sk.scatter(1, pos_b, bkey).scatter(1, pos_n, key_new)
    return sd[:, :W], sk[:, :W]


def _point_row_dists(metric: str, q_rows, rows):
    """True f32 distances q_rows [B, D] -> rows [B, K, D] (direct
    differences, no matmul-identity cancellation)."""
    if metric in ("l2", "jacbits"):
        dlt = rows - q_rows[:, None, :]
        h = (dlt * dlt).sum(dim=-1)
        if metric == "jacbits":  # {0,1} rows: popcount == sum
            return _l2_to_jaccard(h, q_rows.sum(dim=1, keepdim=True),
                                  rows.sum(dim=-1))
        return h
    if metric == "l1":
        return (rows - q_rows[:, None, :]).abs().sum(dim=-1)
    dots = torch.bmm(rows, q_rows[:, :, None])[:, :, 0]
    if metric == "ip":
        return -dots
    return 1.0 - torch.clamp(dots, -1.0, 1.0)


def _beam_ground_plain(rows_bf16, nb0_ids, alive, cap: int, metric: str,
                       q_rows, bd, bkey, steps: int, expand: int,
                       dedup: bool, merge: str, scored=None):
    """Plain version of K8: the beam ground's walk as torch ops, from the
    seeded beam (bd [B, W] f32, bkey [B, W] int64 packed keys ``id * 2 +
    (1 - expanded)``, -2 empty; sorted for the rank merge). Each of
    ``steps`` steps marks the ``expand`` best unexpanded entries expanded,
    scores their layer-0 neighbours' bf16 rows in f32 and merges them
    (``DeviceBuilder._beam_ground_candidates`` names the merges). Returns
    (cand_d, cand_ids) [B, W], -1 where the distance is infinite. A list
    ``scored`` takes each step's count of scored rows (the live
    neighbours, the rows K8 reads: its bound's bytes)."""
    B, W = bd.shape
    for _ in range(steps):
        unexp = torch.where((bkey >= 0) & (bkey & 1 == 1), bd, _INF)
        # the best unexpanded entries, lower slots first on ties
        # (lax.top_k's order)
        pos = torch.argsort(unexp, dim=1, stable=True)[:, :expand]
        sel_ok = torch.isfinite(torch.gather(unexp, 1, pos))
        k_pos = torch.gather(bkey, 1, pos)
        bkey = bkey.scatter(1, pos, torch.where(sel_ok, k_pos & ~1, k_pos))
        u = torch.where(sel_ok, k_pos >> 1, -1)
        nbrs = nb0_ids[u.clamp(0, cap)].long()  # [B, E, lm0]
        nbrs = torch.where((u >= 0)[:, :, None], nbrs, -1).reshape(B, -1)
        safe = nbrs.clamp(0, cap)
        ok = (nbrs >= 0) & alive[safe]
        if scored is not None:
            scored.append(ok.sum())
        d_new = torch.where(ok, _point_row_dists(
            metric, q_rows, rows_bf16[safe].float()), _INF)
        key_new = torch.where(ok, nbrs * 2 + 1, -2)
        if merge == "rank":
            bd, bkey = _rank_merge(bd, bkey, d_new, key_new)
            continue
        all_key = torch.cat([bkey, key_new], 1)
        all_d = torch.cat([bd, d_new], 1)
        if dedup:
            all_key, all_d = _dedup_by_key(all_key, all_d)
        sd, o = torch.sort(all_d, dim=1, stable=True)
        bd = sd[:, :W]
        bkey = torch.gather(all_key, 1, o[:, :W])
    if not dedup:
        # one dedup after the walk: a repeated id must not reach
        # Algorithm 4 (its zero-distance copy would take a slot)
        bkey, bd = _dedup_by_key(bkey, bd)
        bd, o = torch.sort(bd, dim=1, stable=True)
        bkey = torch.gather(bkey, 1, o)
    bids = torch.where(torch.isfinite(bd) & (bkey >= 0), bkey >> 1, -1)
    return bd, bids


#: K8's metric codes (csrc/k8_beam_ground.cu)
_K8_METRIC = {"l2": 0, "ip": 1, "cosine": 2, "l1": 3, "jacbits": 4}
#: a block's dynamic shared memory on an H100 (K8's limit)
_K8_MAX_SMEM = 232448


def _k8_smem_bytes(w: int, e: int, lm0: int) -> int:
    """K8's shared memory: the beam, the merge's w + e * lm0 entries (f32
    distances and int32 keys), the selected places and one word
    (``k8_smem_bytes`` in the source). The query stays in global memory."""
    return 4 * (2 * w + 2 * (w + e * lm0) + max(e, 1) + 1)


def _beam_ground_cuda(rows_bf16, nb0_ids, alive, cap: int, metric: str,
                      q_rows, bd, bkey, steps: int, expand: int,
                      dedup: bool, merge: str):
    """``_beam_ground_plain`` as one launch of kernel K8 on CUDA tensors
    (the same arguments and outputs). Refuses what its shared memory
    cannot hold (``_K8_MAX_SMEM``: the beam and the step's W + E * 2m
    entries)."""
    from ..ops import _build

    dev = q_rows.device
    chk = bruteforce._check_cuda
    chk("rows_bf16", rows_bf16, torch.bfloat16, 2, dev)
    chk("nb0_ids", nb0_ids, torch.int32, 2, dev)
    chk("alive", alive, torch.bool, 1, dev)
    chk("bd", bd, torch.float32, 2, dev)
    B, W = bd.shape
    d, lm0 = rows_bf16.shape[1], nb0_ids.shape[1]
    if q_rows.shape != (B, d) or bkey.shape != (B, W):
        raise ValueError(f"shape mismatch: q_rows {tuple(q_rows.shape)}, "
                         f"bd {(B, W)}, bkey {tuple(bkey.shape)}, d {d}")
    if min(nb0_ids.shape[0], alive.shape[0], rows_bf16.shape[0]) <= cap:
        raise ValueError(f"tables shorter than cap + 1 = {cap + 1} rows")
    if cap >= 1 << 30:
        raise ValueError(f"K8 packs ids below 2^30 (cap {cap})")
    if not 0 <= expand <= W:
        raise ValueError(f"expand {expand} outside [0, W = {W}]")
    smem = _k8_smem_bytes(W, expand, lm0)
    if smem > _K8_MAX_SMEM:
        raise ValueError(
            f"K8 holds the beam and W + E * 2m entries in shared memory: "
            f"{smem} bytes at W = {W}, E = {expand}, 2m = {lm0} exceed a "
            f"block's {_K8_MAX_SMEM}")
    code = {"sort": 0 if dedup else 1, "rank": 2}[merge]
    q = q_rows.float().contiguous()
    keys = bkey.to(torch.int32).contiguous()
    out_d = torch.empty((B, W), dtype=torch.float32, device=dev)
    out_ids = torch.empty((B, W), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):  # the C entry launches on the current one
        rc = _build.lib().pgv_k8_beam_ground(
            rows_bf16.data_ptr(), rows_bf16.stride(0), d, nb0_ids.data_ptr(),
            lm0, alive.data_ptr(), cap, q.data_ptr(), bd.data_ptr(),
            keys.data_ptr(), B, W, expand, steps, _K8_METRIC[metric], code,
            out_d.data_ptr(), out_ids.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "pgv_k8_beam_ground")
    bruteforce.LAUNCHES["k8_beam_ground"] += 1
    return out_d, out_ids


# ---------------------------------------------------------------------------
# the builder
# ---------------------------------------------------------------------------


def _sync(device) -> None:
    """Wait for the work queued on ``device`` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Clock:
    """Seconds on the build's device for its instrumentation. ``lap()``
    waits for the work queued on ``device`` and returns the seconds since
    the last lap. When ``on``, ``mark(name)`` prints ``fmt`` with that lap
    (``PGV_BUILD_TIMING``'s init and phase lines) and ``tick(name)`` keeps
    it in ``laps`` (``PGV_BUILD_DEBUG``'s split of a batch); off, neither
    waits."""

    def __init__(self, device, on: bool = True, fmt: str = ""):
        self.device, self.on, self.fmt = device, on, fmt
        self.laps: dict = {}
        self.t = time.time()

    def lap(self) -> float:
        _sync(self.device)
        t = time.time()
        dt, self.t = t - self.t, t
        return dt

    def mark(self, name: str) -> None:
        if self.on:
            print(self.fmt.format(name=name, s=self.lap()), file=sys.stderr,
                  flush=True)

    def tick(self, name: str) -> None:
        if self.on:
            self.laps[name] = self.lap()


class DeviceBuilder:
    """Owns the build tensors and the per-batch steps (dense l2 / ip /
    cosine / l1, and "jacbits" over unpacked bit rows; the IVF or the
    beam-descent ground past the ramp)."""

    def __init__(self, metric: str, vectors: torch.Tensor, levels, m: int,
                 ef_construction: int, batch_max: int = 1024,
                 ground: str | None = None,
                 settings: BuildSettings | None = None):
        if metric not in ("l2", "ip", "cosine", "l1", "jacbits"):
            raise ValueError(f"the device build has no metric {metric!r}")
        s = settings if settings is not None else BuildSettings.from_env()
        dev = vectors.device
        clock = _Clock(dev, s.timing, "[build]   init.{name} {s:.2f}s")
        self.device = dev
        self.metric = metric
        self.m = m
        self.efc = ef_construction
        self.n = n = vectors.shape[0]
        d = vectors.shape[1]
        # the ground past the ramp, as the JAX package picks it: the IVF
        # member table for the matmul metrics below 512 dimensions, the
        # beam descent at 512 or more (where cell-local candidates miss
        # the recall bar) and for l1 at any width
        if ground is None:
            ground = s.ground
        if ground == "auto":
            ground = ("ivf" if metric in ("l2", "ip", "cosine") and d < 512
                      else "beam")
        if ground not in ("ivf", "beam"):
            raise ValueError(f"unknown build ground {ground!r}")
        self.ivf = ground == "ivf"
        self.batch_max = batch_max
        self.lm0 = hnsw_get_layer_m(m, 0)
        self.descent_min = s.descent_min
        self.settings = s
        # RobustPrune's alpha in the order distance's domain: squared for
        # squared l2; none for ip, whose order distance is signed
        self.alpha_eff, self.alpha_upper = (
            a * a if metric == "l2" else 1.0 if metric == "ip" else a
            for a in (s.alpha, s.alpha_upper))
        if not self.ivf:
            _beam_merge_checked(s.beam_merge, s.beam_dedup)
        self._members_ready = False

        cap_pad = cap_pad_for(n)
        self.cap = cap_pad - 1  # dump row (scatter sink / gather pad)
        # levels above ln(cap)/ln(m) + 3 are clamped (build.rs:373-377)
        self.lmax = max(
            int(math.log(_next_pow2(cap_pad)) / math.log(max(m, 2))) + 3, 1
        )
        levels = np.minimum(np.asarray(levels, dtype=np.int32), self.lmax)

        vec = torch.zeros((cap_pad, d), dtype=torch.float32, device=dev)
        vec[:n] = vectors
        self.vectors = vec
        clock.mark("pad")
        ups = np.nonzero(levels >= 1)[0]
        n_upper = len(ups)
        upper_pad = _next_pow2(n_upper + 1)
        self.upper_dump = upper_pad - 1  # dump slot for upper scatters
        # upper slots in a fixed-seed shuffled order, as the JAX builder
        # assigns them (same numpy draws, so both packages agree)
        perm = np.random.default_rng(0xA953).permutation(
            max(n_upper, 1)
        )[:n_upper].astype(np.int64)
        lv_pad = np.full(cap_pad, -1, dtype=np.int32)
        lv_pad[:n] = levels
        upper_slot = np.full(cap_pad, -1, dtype=np.int32)
        upper_slot[ups] = perm
        up_ids = np.full(upper_pad, self.cap, dtype=np.int32)
        up_ids[perm] = ups
        # queries per chunk of the merged upper sweep (JAX's rule; the
        # port's top-k is exact, so the chunking bounds the [CQ, U]
        # scores and changes no result)
        cq = s.seed_cq or (256 if batch_max % 256 == 0
                           and upper_pad > (1 << 17) else batch_max)
        if not (0 < cq <= batch_max and batch_max % cq == 0):
            if s.seed_cq:
                warnings.warn(f"PGV_BUILD_SEED_CQ={cq} is not a positive "
                              f"divisor of batch width {batch_max}; using "
                              f"{batch_max}", stacklevel=2)
            cq = batch_max
        self.seed_cq = cq
        ups_t = torch.from_numpy(ups).to(dev)
        up_vecs = torch.zeros((upper_pad, d), dtype=torch.float32, device=dev)
        up_vecs[torch.from_numpy(perm).to(dev)] = vec[ups_t]

        # per-layer sub-tables for layers >= 2, each with its own shuffle
        upper_sub = []
        up_levels = levels[ups]
        for lc in range(2, self.lmax + 1):
            sel = np.nonzero(up_levels >= lc)[0]  # indices into ups
            pad_l = max(128, _next_pow2(len(sel) + 1))
            perm_l = np.random.default_rng(0xA953 + lc).permutation(
                max(len(sel), 1)
            )[: len(sel)]
            ids_l = np.full(pad_l, self.cap, dtype=np.int32)
            slots_l = np.full(pad_l, self.upper_dump, dtype=np.int64)
            if len(sel):
                ids_l[perm_l] = ups[sel]
                slots_l[perm_l] = perm[sel]
            v_l = up_vecs[torch.from_numpy(slots_l).to(dev)]
            upper_sub.append(
                (torch.from_numpy(ids_l).to(dev), v_l, (v_l * v_l).sum(dim=1))
            )
        clock.mark("upper-tables")
        self.data = BuildData(
            vectors=vec,
            vectors_bf16=vec.to(torch.bfloat16),
            x2=(vec * vec).sum(dim=1),
            levels=torch.from_numpy(lv_pad).to(dev),
            upper_slot=torch.from_numpy(upper_slot).to(dev),
            upper_vectors=up_vecs,
            upper_bf16=up_vecs.to(torch.bfloat16),
            upper_x2=(up_vecs * up_vecs).sum(dim=1),
            upper_ids=torch.from_numpy(up_ids).to(dev),
            upper_sub=tuple(upper_sub),
        )
        clock.mark("build-data")
        i32 = dict(dtype=torch.int32, device=dev)
        bf = dict(dtype=torch.bfloat16, device=dev)
        self.arrays = BuildArrays(
            nb0_ids=torch.full((cap_pad, self.lm0), -1, **i32),
            nb0_d=torch.full((cap_pad, self.lm0), _INF, **bf),
            up_ids=torch.full((upper_pad, self.lmax * m), -1, **i32),
            up_d=torch.full((upper_pad, self.lmax * m), _INF, **bf),
            alive=torch.zeros(cap_pad, dtype=torch.bool, device=dev),
            tid_counts=torch.zeros(cap_pad, **i32),
            absorb=torch.full((cap_pad,), -1, **i32),
            entry=torch.tensor(-1, dtype=torch.int64, device=dev),
            entry_level=torch.tensor(-1, **i32),
            members=torch.full((upper_pad, s.ivf_cap), -1, **i32),
            member_counts=torch.zeros(upper_pad, **i32),
        )
        clock.mark("arrays")

    # -- scoring -------------------------------------------------------------

    def _score_all(self, q_rows, vectors, x2):
        """Order distances [B, rows] from f32 queries to f32 rows (l1: the
        sweep in blocks of ``_L1_CHUNK`` rows)."""
        if self.metric == "l1":
            return torch.cat([
                torch.cdist(q_rows, vectors[s : s + _L1_CHUNK], p=1)
                for s in range(0, vectors.shape[0], _L1_CHUNK)
            ], dim=1)
        dots = q_rows @ vectors.T
        if self.metric in ("l2", "jacbits"):
            q2 = (q_rows * q_rows).sum(dim=1, keepdim=True)
            h = torch.clamp(q2 + x2[None, :] - 2.0 * dots, min=0.0)
            if self.metric == "jacbits":
                return _l2_to_jaccard(h, q2, x2[None, :])
            return h
        if self.metric == "ip":
            return -dots
        return 1.0 - torch.clamp(dots, -1.0, 1.0)

    def _upper_order_scores(self, data: BuildData, q_chunk, a_col):
        """[Bq, width_u] ORDER scores over the upper table: bf16 operands
        with f32 sums, dead columns folded into the per-column term
        ``a_col`` (l2: x2 + pen, others: pen), per-query constants left
        out. Monotone in the true distance per query; callers rescore the
        selected columns exactly. l1: the f32 sweep plus ``a_col``."""
        if self.metric == "l1":
            return self._score_all(q_chunk, data.upper_vectors,
                                   data.upper_x2) + a_col[None, :]
        q = q_chunk.to(torch.bfloat16).float()
        dots = q @ data.upper_bf16.float().T
        if self.metric == "l2":
            return a_col[None, :] - 2.0 * dots
        if self.metric == "jacbits":
            # the transform needs the true h per column, so the penalty
            # comes after it (inf / inf would be NaN); bf16 dots of {0,1}
            # rows are exact
            q2 = (q_chunk * q_chunk).sum(dim=1, keepdim=True)
            h = torch.clamp(q2 + data.upper_x2[None, :] - 2.0 * dots, min=0.0)
            return (_l2_to_jaccard(h, q2, data.upper_x2[None, :])
                    + a_col[None, :])
        return a_col[None, :] - dots

    def _dist_point_rows(self, q_rows, rows):
        """True f32 distances q_rows [B, D] -> rows [B, K, D]
        (``_point_row_dists``)."""
        return _point_row_dists(self.metric, q_rows, rows)

    def _pair_rows(self, data: BuildData, ids):
        """Rows for Algorithm 4's pair distances: bf16 for the matmul
        metrics, f32 for l1 (as the JAX package reads them)."""
        rows = data.vectors if self.metric == "l1" else data.vectors_bf16
        return rows[ids.clamp(0, self.cap).long()]

    def _candidates_to_selection(self, data: BuildData, cand_d, cand_idx,
                                 alpha_eff: float | None = None):
        """Algorithm 4 over sorted candidates (``alpha_eff``: layer 0's
        unless given); pads to lm0 columns."""
        cand_idx = torch.where(torch.isfinite(cand_d), cand_idx, -1)
        rows = self._pair_rows(data, cand_idx)
        pair = _pair_matrix(self.metric, rows)
        bad = cand_idx < 0
        pair = torch.where(bad[:, None, :] | bad[:, :, None], _INF, pair)
        sd, sids = _select_neighbors_parallel(
            cand_d, cand_idx, pair, self.lm0,
            self.alpha_eff if alpha_eff is None else alpha_eff)
        pad = self.lm0 - sd.shape[1]
        if pad > 0:  # tiny corpus: fewer candidates than lm0
            sd = torch.nn.functional.pad(sd, (0, pad), value=_INF)
            sids = torch.nn.functional.pad(sids, (0, pad), value=-1)
        return sd, sids

    def _batch_ids(self, start: int, size: int):
        """(mask [B], element ids [B] int64: the dump row past ``size``)."""
        iota_b = torch.arange(self.batch_max, device=self.device)
        mask = iota_b < size
        return mask, torch.where(mask, start + iota_b, self.cap)

    def _score_select_step(self, data: BuildData, arrays: BuildArrays,
                           start: int, size: int, width: int):
        """Candidate generation + Algorithm 4 selection for every layer of
        the batch [start, start + size).

        ``width`` != 0: the exact ramp over the first ``width`` rows.
        ``width`` == 0: the IVF arm; one merged scan of the upper table
        gives the probe cells and the layer-1 pool. Upper layers always
        select from the upper table (layer 1) or the layer's sub-table.

        Returns (sel_d, sel_ids [B, LMAX+1, lm0] (layer 0 = ground; upper
        layers hold m slots), assign [B]: the nearest committed upper cell
        for the member table, ``upper_dump`` outside the IVF arm)."""
        alive = arrays.alive
        B = self.batch_max
        batch_mask, new_ids = self._batch_ids(start, size)
        count = start
        q_rows = data.vectors[new_ids]  # [B, D]
        my_level = data.levels[new_ids]  # [B]

        width_u = data.upper_vectors.shape[0]
        u_ids = data.upper_ids
        u_colmask = (u_ids < count) & alive[u_ids.long()]
        kku = min(self.efc, width_u)
        pool = kku

        # the batch rows with upper layers (P(level >= 1) = 1/m), compacted
        # into a 4x-margin budget: upper selection runs on RU2 rows, not B
        RU2 = min(B, max(B * 4 // max(self.m, 1), 32))
        has_up = (my_level >= 1) & batch_mask
        order_u = torch.argsort((~has_up).to(torch.int8), stable=True)[:RU2]
        u_pen = torch.where(u_colmask, 0.0, _INF)
        a_col = data.upper_x2 + u_pen if self.metric == "l2" else u_pen

        if width != 0:
            # exact ramp over the committed prefix
            kk = min(self.efc, width)
            col_valid = (torch.arange(width, device=self.device) < count) & \
                alive[:width]
            scores = self._score_all(q_rows, data.vectors[:width],
                                     data.x2[:width])
            scores = torch.where(col_valid[None, :], scores, _INF)
            cand_d, cand_idx = torch.topk(scores, kk, dim=1, largest=False,
                                          sorted=True)
            assign = torch.full((B,), self.upper_dump, dtype=torch.int64,
                                device=self.device)
        else:
            # merged upper scan: the IVF probe cells or the beam's seeds
            # (first SP columns) and the layer-1 pool (first `pool`
            # columns) from one pass; the S seeds plus the entry fit the
            # efc-wide beam
            S = min(_BEAM_SEEDS, width_u - 1, max(self.efc - 1, 1))
            SP = min(max(S, self.settings.ivf_probes) if self.ivf else S,
                     width_u)
            KK = min(max(SP, pool), width_u)
            cq = self.seed_cq
            parts = [torch.topk(
                self._upper_order_scores(data, q_rows[c : c + cq], a_col),
                KK, dim=1, largest=False, sorted=True,
            ) for c in range(0, B, cq)]
            ord_all = torch.cat([p[0] for p in parts])
            slots_all = torch.cat([p[1] for p in parts])
            # exact f32 rescore + re-sort: selection needs true distances
            d_exact = self._dist_point_rows(q_rows,
                                            data.upper_vectors[slots_all])
            d_exact = torch.where(torch.isfinite(ord_all), d_exact, _INF)
            d_all, o = torch.sort(d_exact, dim=1, stable=True)
            slots_all = torch.gather(slots_all, 1, o)
            seed_sc = d_all[:, :SP]
            seed_slots = slots_all[:, :SP]
            if self.ivf:
                cand_d, cand_idx = self._ivf_ground_candidates(
                    data, arrays, q_rows, seed_sc, seed_slots
                )
            else:
                fin = torch.isfinite(seed_sc[:, :S])
                cand_d, cand_idx = self._beam_ground_candidates(
                    data, arrays, q_rows, torch.where(fin, seed_sc[:, :S], _INF),
                    torch.where(fin, u_ids[seed_slots[:, :S]].long(), -1),
                )
            assign = torch.where(torch.isfinite(seed_sc[:, 0]),
                                 seed_slots[:, 0], self.upper_dump)
        sel0_d, sel0_ids = self._candidates_to_selection(data, cand_d,
                                                         cand_idx)

        cvalid = has_up[order_u]
        q_up = q_rows[order_u]
        if width != 0:
            # ramp arm: the layer-1 pool has its own order-score pass over
            # the upper table (compacted rows only), then the exact rescore
            o_p1, slot_p1 = torch.topk(
                self._upper_order_scores(data, q_up, a_col), pool, dim=1,
                largest=False, sorted=True,
            )
            r_d = self._dist_point_rows(q_up, data.upper_vectors[slot_p1])
            r_d = torch.where(torch.isfinite(o_p1), r_d, _INF)
            d_p1, o = torch.sort(r_d, dim=1, stable=True)
            slot_p1 = torch.gather(slot_p1, 1, o)
        else:
            d_p1 = d_all[order_u][:, :pool]
            slot_p1 = slots_all[order_u][:, :pool]

        # layer 1 selects from the whole upper table, layers >= 2 from
        # their own narrow sub-tables
        sel_layers = [self._candidates_to_selection(
            data, d_p1, u_ids[slot_p1].long(), self.alpha_upper)]
        for lc in range(2, self.lmax + 1):
            ids_l, v_l, x2_l = data.upper_sub[lc - 2]
            s_l = self._score_all(q_up, v_l, x2_l)
            colmask_l = (ids_l < count) & alive[ids_l.long()]
            s_l = torch.where(colmask_l[None, :] & cvalid[:, None], s_l, _INF)
            d_pl, slot_pl = torch.topk(s_l, min(kku, ids_l.shape[0]), dim=1,
                                       largest=False, sorted=True)
            sel_layers.append(self._candidates_to_selection(
                data, d_pl, ids_l[slot_pl].long(), self.alpha_upper))

        selu_d_c = torch.stack([d for d, _ in sel_layers], dim=1)
        selu_ids_c = torch.stack([i for _, i in sel_layers], dim=1)
        # scatter the compacted upper selections back to their batch rows
        scat = torch.where(cvalid, order_u, B)
        selu_d = torch.full((B + 1, self.lmax, self.lm0), _INF,
                            device=self.device)
        selu_d[scat] = selu_d_c
        selu_ids = torch.full((B + 1, self.lmax, self.lm0), -1,
                              dtype=torch.int64, device=self.device)
        selu_ids[scat] = selu_ids_c
        sel_d = torch.cat([sel0_d[:, None], selu_d[:B]], dim=1)
        sel_ids = torch.cat([sel0_ids.long()[:, None], selu_ids[:B]], dim=1)

        # mask layers above each element's level; upper layers keep m slots
        layer_iota = torch.arange(self.lmax + 1, device=self.device)
        slot_iota = torch.arange(self.lm0, device=self.device)
        act = batch_mask[:, None, None] & (
            my_level[:, None, None] >= layer_iota[None, :, None]
        )
        width_ok = (layer_iota[None, :, None] == 0) | (
            slot_iota[None, None, :] < self.m
        )
        keep = act & width_ok
        return (torch.where(keep, sel_d, _INF), torch.where(keep, sel_ids, -1),
                assign)

    def _beam_ground_candidates(self, data: BuildData, arrays: BuildArrays,
                                q_rows, seed_d, seed_ids, steps=None,
                                expand=None, dedup=None, merge=None):
        """Ground candidates by batched beam descent: the reference's
        layer-0 ef_construction search (graph/mod.rs:355-427) as
        fixed-trip tensor ops over the as-built adjacency.

        Each query keeps an efc-wide beam of packed keys ``id * 2 + (1 -
        expanded)`` (-2: empty), seeded with the upper rows ``seed_ids``
        [B, S] (-1 = none) at ``seed_d`` and the entry. Each of ``steps``
        steps marks the ``expand`` best unexpanded entries expanded and
        scores their layer-0 neighbours (bf16 rows, f32 sums); the merge
        (the builder's settings unless given) is then
        - "sort" with ``dedup``: two stable sorts, by key, so the expanded
          copy of an id comes first and its repeats go to inf, then by
          distance;
        - "sort" without ``dedup``: one stable sort by distance (an id may
          sit in the beam twice), and one key dedup after the last step;
        - "rank" (``_rank_merge``): the beam kept sorted, the new entries
          ranked into it by pairwise comparisons.
        ``vmap`` over queries becomes the batch dimension. The seeds are
        set up in torch ops (``_beam_ground_seeds``); the walk is kernel K8
        on CUDA tensors (``_beam_ground_cuda``, one launch) and
        ``_beam_ground_plain`` on CPU tensors.

        Returns (cand_d, cand_ids) [B, efc] sorted nearest first."""
        st = self.settings
        steps = (st.beam_steps or 16) if steps is None else steps
        expand = st.beam_expand if expand is None else expand
        dedup = st.beam_dedup if dedup is None else dedup
        merge = _beam_merge_checked(st.beam_merge if merge is None else merge,
                                    dedup)
        if expand > self.efc:
            raise ValueError(f"PGV_BUILD_BEAM_EXPAND={expand} exceeds the "
                             f"beam's width {self.efc}")
        bd, bkey = self._beam_ground_seeds(data, arrays, q_rows, seed_d,
                                           seed_ids, merge)
        walk = _beam_ground_cuda if q_rows.is_cuda else _beam_ground_plain
        return walk(data.vectors_bf16, arrays.nb0_ids, arrays.alive, self.cap,
                    self.metric, q_rows, bd, bkey, steps, expand, dedup,
                    merge)

    def _beam_ground_seeds(self, data: BuildData, arrays: BuildArrays,
                           q_rows, seed_d, seed_ids, merge: str):
        """The beam ground's seeded beam (bd [B, efc] f32, bkey [B, efc]
        int64): the seeds at ``seed_d``, then the entry at its f32
        distance, the rest empty; for the rank merge sorted, without a
        second copy of an entry that is also a seed."""
        B, S = seed_ids.shape
        W = self.efc
        cap = self.cap
        dev = self.device
        entry = arrays.entry.clamp(0, cap)
        e_d = self._dist_point_rows(
            q_rows, data.vectors[entry].expand(B, 1, -1))[:, 0]
        bkey = torch.full((B, W), -2, dtype=torch.int64, device=dev)
        bd = torch.full((B, W), _INF, device=dev)
        seeds = torch.cat([seed_ids, arrays.entry.expand(B, 1)], dim=1)
        bkey[:, : S + 1] = torch.where(seeds >= 0, seeds * 2 + 1, -2)
        bd[:, :S] = seed_d
        bd[:, S] = e_d
        if merge == "rank":
            # the beam starts sorted, without a second copy of an entry
            # that is also a seed
            ent_dup = (seed_ids == arrays.entry).any(dim=1)
            bd[:, S] = torch.where(ent_dup, _INF, e_d)
            bkey[:, S] = torch.where(ent_dup, -2, bkey[:, S])
            bd, o = torch.sort(bd, dim=1, stable=True)
            bkey = torch.gather(bkey, 1, o)
        return bd, bkey

    def _ivf_ground_candidates(self, data: BuildData, arrays: BuildArrays,
                               q_rows, seed_sc, seed_slots):
        """Ground candidates from the member table: the members of the
        ``ivf_probes`` nearest committed upper cells, scored exactly (bf16
        rows, f32 sums), plus the layer-0 neighbours of ``ivf_hop`` member
        candidates (the nearest, or every ``ivf_hop_stride``-th where that
        many fit), deduplicated by a sort on id.

        Returns (cand_d, cand_ids) [B, efc] sorted nearest first."""
        st = self.settings
        B = q_rows.shape[0]
        P = min(st.ivf_probes, seed_slots.shape[1])
        cap = self.cap
        n_slots = arrays.members.shape[0]

        def score_ids(ids):
            safe = ids.clamp(0, cap).long()
            rows = data.vectors_bf16[safe].float()  # [B, W, D]
            if self.metric == "l1":
                d = (rows - q_rows[:, None, :]).abs().sum(dim=-1)
                return torch.where(ids >= 0, d, _INF)
            qb = q_rows.to(torch.bfloat16).float()
            dots = torch.bmm(rows, qb[:, :, None])[:, :, 0]
            if self.metric == "l2":
                q2 = (q_rows * q_rows).sum(dim=1, keepdim=True)
                d = torch.clamp(q2 + data.x2[safe] - 2.0 * dots, min=0.0)
            elif self.metric == "ip":
                d = -dots
            else:
                d = 1.0 - torch.clamp(dots, -1.0, 1.0)
            return torch.where(ids >= 0, d, _INF)

        mem = arrays.members[seed_slots[:, :P].clamp(0, n_slots - 1)]
        mem = torch.where(torch.isfinite(seed_sc[:, :P])[:, :, None], mem, -1)
        mem = mem.reshape(B, -1)  # [B, P * ivf_cap]
        d = score_ids(mem)
        kk = min(self.efc, d.shape[1])
        cd, pos = torch.topk(d, kk, dim=1, largest=False, sorted=True)
        cids = torch.gather(mem, 1, pos)
        hop = min(st.ivf_hop, kk)
        if hop:
            # one hop: layer-0 neighbours of member candidates bridge the
            # cells the probe set missed; a stride spreads the sources over
            # the ranking, so their lists overlap less
            stride = max(1, st.ivf_hop_stride)
            src = cids[:, : hop * stride : stride] if hop * stride <= kk \
                else cids[:, :hop]
            nb = arrays.nb0_ids[src.clamp(0, cap).long()]
            hids = torch.where((src >= 0)[:, :, None], nb, -1).reshape(B, -1)
            all_d = torch.cat([cd, score_ids(hids)], dim=1)
            all_i = torch.cat([cids, hids], dim=1)
            si, o = torch.sort(all_i, dim=1, stable=True)
            sd = torch.gather(all_d, 1, o)
            dup = torch.zeros_like(si, dtype=torch.bool)
            dup[:, 1:] = si[:, 1:] == si[:, :-1]
            sd = torch.where(dup | (si < 0), _INF, sd)
            sd, o = torch.sort(sd, dim=1, stable=True)
            si = torch.gather(si, 1, o)
            cd, cids = sd[:, :kk], si[:, :kk]
            cids = torch.where(torch.isfinite(cd), cids, -1)
        return cd, cids.long()

    # -- commit ----------------------------------------------------------------

    def _fwd_commit_step(self, data: BuildData, arrays: BuildArrays,
                         start: int, size: int, sel_d, sel_ids, assign):
        """Duplicate folding + forward edges + member append + entry
        promotion, on the device (no host round trip).

        An element whose selected layer-0 neighbour holds an equal value
        (and, for ip, whose row is zero: ip's distance is 0 only there; for
        jaccard, whose row is not zero: two zero rows are 1.0 apart) folds
        its TID into that neighbour, up to 10 TIDs per element
        (build.rs:474-510); folds into one target within a batch are
        ranked by a sort so the cap holds."""
        dump = self.cap
        B = self.batch_max
        dev = self.device
        mask, new_ids = self._batch_ids(start, size)

        q_rows = data.vectors[new_ids]
        cand = sel_ids[:, 0, :]
        zero = cand >= 0
        if self.metric == "ip":
            zero = zero & (data.x2[new_ids] == 0.0)[:, None]
        elif self.metric == "jacbits":
            zero = zero & (data.x2[new_ids] > 0.0)[:, None]
        cand_c = cand.clamp(0, dump)
        eq = (data.vectors[cand_c] == q_rows[:, None, :]).all(dim=-1) & zero
        ok = eq & (arrays.tid_counts[cand_c] >= 1) & mask[:, None]
        has = ok.any(dim=1)
        first = ok.to(torch.int8).argmax(dim=1)
        target = torch.where(has, torch.gather(cand, 1, first[:, None])[:, 0],
                             -1)

        big = 2 ** 31 - 1
        s_t, s_b = torch.sort(torch.where(has, target, big), stable=True)
        _, rank = _group_rank(s_t)
        room = HNSW_HEAPTIDS - arrays.tid_counts[s_t.clamp(0, dump)]
        fold = torch.zeros(B, dtype=torch.bool, device=dev)
        fold[s_b] = (s_t != big) & (rank < room)
        alive = mask & ~fold

        ones = torch.ones(B, dtype=torch.int32, device=dev)
        arrays.tid_counts.index_add_(0, torch.where(fold, target, dump), ones)
        arrays.tid_counts[torch.where(alive, new_ids, dump)] = 1
        arrays.tid_counts[dump] = 0
        arrays.absorb[torch.where(fold, new_ids, dump)] = target.to(
            torch.int32)
        arrays.absorb[dump] = -1

        fwd_target = torch.where(alive, new_ids, dump)
        arrays.nb0_ids[fwd_target] = sel_ids[:, 0, :].to(torch.int32)
        arrays.nb0_d[fwd_target] = sel_d[:, 0, :].to(torch.bfloat16)
        arrays.alive[fwd_target] = True
        arrays.alive[dump] = False

        if assign is not None:
            # append each kept row to its nearest cell; rows past a cell's
            # cap keep their edges but stop being candidates later
            cap_m = self.settings.ivf_cap
            n_slots = arrays.members.shape[0]
            a = torch.where(alive, assign, self.upper_dump)
            s_a, o = torch.sort(a, stable=True)
            s_id = new_ids[o]
            _, rank_m = _group_rank(s_a)
            slot_c = s_a.clamp(0, n_slots - 1)
            slot_pos = arrays.member_counts[slot_c] + rank_m
            keep_m = (s_a < self.upper_dump) & (slot_pos < cap_m)
            flat = torch.where(
                keep_m, slot_c * cap_m + slot_pos.clamp(0, cap_m - 1),
                n_slots * cap_m - 1,  # dump: the dump slot's last cell
            )
            arrays.members.view(-1)[flat] = torch.where(keep_m, s_id,
                                                        -1).to(torch.int32)
            arrays.member_counts.index_add_(
                0, torch.where(keep_m, s_a, n_slots - 1),
                keep_m.to(torch.int32),
            )

        # entry promotion: the first alive element reaching the batch max
        lv = torch.where(alive, data.levels[new_ids], -1)
        batch_max = lv.max()
        promote = batch_max > arrays.entry_level
        first_e = (lv == batch_max).to(torch.int8).argmax()
        arrays.entry = torch.where(promote, new_ids[first_e], arrays.entry)
        arrays.entry_level = torch.where(promote, batch_max,
                                         arrays.entry_level)

    def _be_k(self, lm: int) -> int:
        """Same-target back-edge adds honoured per commit: ``be_k`` where
        it is set, else 2 at large caps (collisions per target are rare
        there) and 4 below."""
        k = self.settings.be_k
        if k <= 0:
            k = 2 if self.cap >= _BE_K2_MIN_CAP else 4
        return min(lm, k)

    def _resolve_backedges(self, data: BuildData, old_ids, old_d, add_ids,
                           add_d, lm: int, alpha_eff: float):
        """Algorithm 4 re-selection of a target's list with its adds
        (graph/mod.rs:442-489, batch-deterministic), for every request row
        (callers keep the first row of each target group). old_ids / old_d
        [R, lm]: the target's current list; add_ids / add_d [R, K]: the
        window of same-target adds; ``alpha_eff``: the layer's
        RobustPrune alpha. Returns (ids, d) [R, lm]."""
        cand_ids = torch.cat([old_ids.long(), add_ids.long()], dim=1)
        cand_d = torch.cat([old_d.float(), add_d], dim=1)
        cand_d = torch.where(cand_ids < 0, _INF, cand_d)
        cand_d, o = torch.sort(cand_d, dim=1, stable=True)
        cand_ids = torch.gather(cand_ids, 1, o)
        pair = _pair_matrix(self.metric, self._pair_rows(data, cand_ids))
        bad = cand_ids < 0
        pair = torch.where(bad[:, None, :] | bad[:, :, None], _INF, pair)
        nd, nids = _select_neighbors_parallel(cand_d, cand_ids, pair, lm,
                                              alpha_eff)
        return nids, nd

    def _backedge0_step(self, data: BuildData, arrays: BuildArrays,
                        start: int, size: int, sel_d, sel_ids):
        """Ground-layer back edges: every selected neighbour of a new
        element gets the element offered to its own list."""
        B = self.batch_max
        lm = self.lm0
        dump = self.cap
        mask, new_ids = self._batch_ids(start, size)
        alive = arrays.alive[new_ids] & mask
        tgt = sel_ids[:, 0, :].reshape(-1)
        dst = sel_d[:, 0, :].reshape(-1)
        src = new_ids[:, None].expand(B, lm).reshape(-1)
        valid = (tgt >= 0) & alive[:, None].expand(B, lm).reshape(-1)
        tgt = torch.where(valid, tgt, dump)
        dst = torch.where(valid, dst, _INF)
        order = _lexsort(tgt, dst)
        s_tgt, s_d, s_src = tgt[order], dst[order], src[order]
        add_ids, add_d = _window(s_tgt, s_src, s_d, self._be_k(lm))
        nids, nd = self._resolve_backedges(
            data, arrays.nb0_ids[s_tgt], arrays.nb0_d[s_tgt], add_ids, add_d,
            lm, self.alpha_eff,
        )
        head, _ = _group_rank(s_tgt)
        row = torch.where(head & (s_tgt != dump), s_tgt, dump)
        arrays.nb0_ids[row] = nids.to(torch.int32)
        arrays.nb0_d[row] = nd.to(torch.bfloat16)

    def _backedge_upper_compact(self, data: BuildData, arrays: BuildArrays,
                                start: int, size: int, sel_d, sel_ids):
        """Upper-layer back edges over a compacted request list (only
        ~B/m batch elements have upper layers): valid requests first in a
        2B-row budget, grouped by (target, layer) with a stable 3-key
        sort, re-selected per group and written into the target's slot
        row at that layer's columns; then the batch's own forward upper
        rows."""
        B = self.batch_max
        m = self.m
        L = self.lmax
        dump = self.cap
        dump_slot = self.upper_dump
        dev = self.device
        mask, new_ids = self._batch_ids(start, size)
        alive = arrays.alive[new_ids] & mask

        lay_ids = sel_ids[:, 1:, :m]  # [B, L, m]
        lay_d = sel_d[:, 1:, :m]
        flat_t = lay_ids.reshape(-1)
        flat_d = lay_d.reshape(-1)
        flat_src = new_ids[:, None, None].expand(B, L, m).reshape(-1)
        flat_layer = (torch.arange(L, device=dev) + 1)[None, :, None].expand(
            B, L, m).reshape(-1)
        flat_valid = (flat_t >= 0) & alive[:, None, None].expand(
            B, L, m).reshape(-1)

        RU = 2 * B
        order = torch.argsort((~flat_valid).to(torch.int8), stable=True)[:RU]
        ok = flat_valid[order]
        u_tgt = torch.where(ok, flat_t[order], dump)
        u_dst = torch.where(ok, flat_d[order], _INF)
        u_src = torch.where(ok, flat_src[order], -1)
        u_layer = torch.where(ok, flat_layer[order], L + 7)
        perm = _lexsort(u_tgt, u_layer, u_dst)
        s_tgt, s_layer = u_tgt[perm], u_layer[perm]
        s_d, s_src = u_dst[perm], u_src[perm]
        add_ids, add_d = _window(s_tgt, s_src, s_d, self._be_k(m),
                                 same_extra=s_layer)

        slot = data.upper_slot[s_tgt].long()
        slot_c = slot.clamp(0, dump_slot)
        lidx = (s_layer - 1).clamp(0, L - 1)
        cols = lidx[:, None] * m + torch.arange(m, device=dev)[None, :]
        old_ids = arrays.up_ids[slot_c[:, None], cols]
        old_d = arrays.up_d[slot_c[:, None], cols]
        nids, nd = self._resolve_backedges(data, old_ids, old_d, add_ids,
                                           add_d, m, self.alpha_upper)
        head, _ = _group_rank(s_tgt * (L + 8) + s_layer)
        row = torch.where(head & (s_tgt != dump) & (slot >= 0), slot_c,
                          dump_slot)
        arrays.up_ids[row[:, None], cols] = nids.to(torch.int32)
        arrays.up_d[row[:, None], cols] = nd.to(torch.bfloat16)

        # forward upper rows of the new elements (slots disjoint from the
        # back-edge targets, which are all committed before this batch)
        slot_new = data.upper_slot[new_ids].long()
        srow = torch.where(alive & (slot_new >= 0), slot_new, dump_slot)
        arrays.up_ids[srow] = lay_ids.reshape(B, -1).to(torch.int32)
        arrays.up_d[srow] = lay_d.reshape(B, -1).to(torch.bfloat16)

    def _commit_all_step(self, data: BuildData, arrays: BuildArrays,
                         start: int, size: int, sel_d, sel_ids, assign,
                         tick=None):
        """The commit's three parts; ``tick(name)``, when given, is called
        after each (``PGV_BUILD_DEBUG``'s split)."""
        tick = tick or (lambda name: None)
        self._fwd_commit_step(data, arrays, start, size, sel_d, sel_ids,
                              assign)
        tick("fwd")
        self._backedge0_step(data, arrays, start, size, sel_d, sel_ids)
        tick("be0")
        self._backedge_upper_compact(data, arrays, start, size, sel_d,
                                     sel_ids)
        tick("beu")

    def _init_members_step(self, data: BuildData, arrays: BuildArrays,
                           count: int):
        """One-time IVF member table at the ramp -> IVF transition: every
        committed row goes to its nearest committed upper cell (exact f32
        sweep in 1,024-row chunks), grouped by cell with a sort."""
        cap_m = self.settings.ivf_cap
        n_slots = arrays.members.shape[0]
        u_ids = data.upper_ids
        u_colmask = (u_ids < count) & arrays.alive[u_ids.long()]
        parts = []
        for s in range(0, count, 1024):
            ids_c = torch.arange(s, min(s + 1024, count), device=self.device)
            sc = self._score_all(data.vectors[ids_c], data.upper_vectors,
                                 data.upper_x2)
            mn, slot = torch.where(u_colmask[None, :], sc, _INF).min(dim=1)
            row_ok = arrays.alive[ids_c] & torch.isfinite(mn)
            parts.append(torch.where(row_ok, slot, self.upper_dump))
        s_a, s_id = torch.sort(torch.cat(parts), stable=True)
        _, rank = _group_rank(s_a)
        keep = (s_a < self.upper_dump) & (rank < cap_m)
        flat = torch.where(keep, s_a * cap_m + rank.clamp(max=cap_m - 1),
                           n_slots * cap_m - 1)
        members = torch.full((n_slots * cap_m,), -1, dtype=torch.int32,
                             device=self.device)
        members[flat] = torch.where(keep, s_id, -1).to(torch.int32)
        counts = torch.zeros(n_slots, dtype=torch.int32, device=self.device)
        counts.index_add_(0, torch.where(keep, s_a, n_slots - 1),
                          keep.to(torch.int32))
        arrays.members = members.view(n_slots, cap_m)
        arrays.member_counts = counts

    def _ensure_members(self, start: int) -> None:
        if not self._members_ready:
            self._members_ready = True
            self._init_members_step(self.data, self.arrays, start)

    # -- driver ----------------------------------------------------------------

    def seed_first(self, first_id: int) -> None:
        a = self.arrays
        a.alive[first_id] = True
        a.tid_counts[first_id] = 1
        a.entry = torch.tensor(first_id, dtype=torch.int64,
                               device=self.device)
        a.entry_level = self.data.levels[first_id].clone()

    def _width_for(self, start: int) -> int:
        """Scored-prefix width of the batch at ``start``: the whole
        capacity when it fits under the ramp, else the ramp width until
        the ramp ends and 0 (the IVF arm) after it."""
        cap1 = self.cap + 1
        if cap1 <= self.descent_min:
            return cap1
        return 0 if start + 1 > self.descent_min else self.descent_min

    def _group_width(self, start: int) -> int:
        """The width the JAX package's ``_width_for`` gives the batch at
        ``start``: this builder's, but -1 (its merged-regime program) for
        the beam ground past a ramp narrower than the capacity."""
        if not self.ivf and self.cap + 1 > self.descent_min:
            return -1
        return self._width_for(start)

    def run_batch(self, start: int, size: int, tick=None) -> None:
        """Insert elements [start, start + size); ``tick(name)``, when
        given, is called after the candidate search and after each of the
        commit's three parts."""
        width = self._width_for(start)
        members = width == 0 and self.ivf
        if members:
            self._ensure_members(start)
        sel_d, sel_ids, assign = self._score_select_step(
            self.data, self.arrays, start, size, width
        )
        if tick is not None:
            tick("search")
        self._commit_all_step(self.data, self.arrays, start, size, sel_d,
                              sel_ids, assign if members else None, tick)

    def run_all(self, schedule) -> None:
        """Run the batch schedule. With ``timing`` print, and with
        ``GROUP_STATS`` bound collect, each batch's width, rows and
        seconds; with ``debug`` print its candidate search's time and its
        commit's split (forward lists, layer-0 back edges, upper back
        edges)."""
        s, stats = self.settings, GROUP_STATS
        if not (s.timing or s.debug or stats is not None):
            for start, size in schedule:
                self.run_batch(start, size)
            return
        clock = _Clock(self.device, s.debug)
        clock.lap()  # start from an idle device
        for start, size in schedule:
            clock.laps.clear()
            self.run_batch(start, size, clock.tick)
            dt = clock.lap() + sum(clock.laps.values())
            if s.debug:
                lp = clock.laps
                commit = lp["fwd"] + lp["be0"] + lp["beu"]
                print(f"[build] batch@{start} n={size} "
                      f"w={self._width_for(start)} search "
                      f"{lp['search']:.3f}s\n[build] batch@{start} commit "
                      f"{commit:.3f}s (fwd {lp['fwd']:.3f} be0 "
                      f"{lp['be0']:.3f} beu {lp['beu']:.3f})",
                      file=sys.stderr, flush=True)
            width = self._group_width(start)
            if stats is not None:
                stats.append((width, size, dt))
            if s.timing:
                print(f"[build] batch@{start} w={width} elems={size} "
                      f"{dt:.3f}s ({size / max(dt, 1e-9):.0f}/s)",
                      file=sys.stderr, flush=True)

    def host_adjacency(self):
        """(nb0_ids [cap+1, lm0], nb0_d f32, up_ids [U+1, LMAX*m], up_d
        f32) as numpy arrays."""
        a = self.arrays
        return (a.nb0_ids.cpu().numpy(), a.nb0_d.float().cpu().numpy(),
                a.up_ids.cpu().numpy(), a.up_d.float().cpu().numpy())


# ---------------------------------------------------------------------------
# entry point and finalize
# ---------------------------------------------------------------------------


class _HostRows:
    """A device tensor that numpy reads by copying it to the host: backs a
    serving-only store without a download until the host needs rows."""

    def __init__(self, t: torch.Tensor):
        self.t = t
        self.shape = tuple(t.shape)

    def __array__(self, dtype=None, copy=None):
        a = self.t.detach().cpu().numpy()
        return a if dtype is None else a.astype(dtype)


def _resolve_device(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _bit_ground_pin():
    """The ground of a bit corpus: always the beam descent (integer hamming
    distances tie heavily, and the IVF member and hop pools collapse under
    ties). Another ``PGV_BUILD_GROUND`` is ignored, and says so once."""
    env = os.environ.get("PGV_BUILD_GROUND")
    if env not in (None, "", "auto", "beam"):
        warnings.warn(
            f"PGV_BUILD_GROUND={env} ignored for bit corpora: the build "
            "pins ground=beam (integer hamming ties collapse the ivf "
            "member/hop pools)",
            stacklevel=3,
        )
    return "beam"


def _pack_words_device(vectors, w: int):
    """[n1, D] f32 {0,1} rows -> [n1, w] int32 words with the bits of
    ``ops/bits.pack_bits``'s uint32 words (MSB-first), on the rows' device:
    a bit build never moves its rows to the host for the serving graph."""
    n1, d = vectors.shape
    shifts = 31 - torch.arange(32, device=vectors.device, dtype=torch.int64)
    out = torch.empty((n1, w), dtype=torch.int32, device=vectors.device)
    for i in range(w):  # one word at a time bounds the int64 temporary
        b = (vectors[:, 32 * i : 32 * i + 32] > 0.5).to(torch.int64)
        word = (b << shifts[: b.shape[1]]).sum(dim=1)
        out[:, i] = torch.where(word >= 1 << 31, word - (1 << 32),
                                word).to(torch.int32)
    return out


def _check_consumable(data, host_graph: bool) -> None:
    """``consume_input``'s rule: a corpus tensor on the index's device and a
    serving-only build (the JAX package's), whose whole storage the build
    can release: not one ``torch.from_numpy`` made (numpy owns it), nor a
    view of a larger tensor (releasing it would take the rest along)."""
    if host_graph or not isinstance(data, torch.Tensor):
        raise ValueError("consume_input requires a device-resident corpus "
                         "and host_graph=False")
    st = data.untyped_storage()
    if (not st.resizable() or data.storage_offset() != 0
            or st.nbytes() != data.numel() * data.element_size()):
        raise ValueError("consume_input needs a tensor that owns its whole "
                         "storage (not a view of a larger tensor, nor one "
                         "torch.from_numpy made)")


def _release(data: torch.Tensor) -> None:
    """Free the caller's corpus storage (``consume_input``): every tensor on
    it is unusable afterwards, and ``data`` itself becomes an empty tensor."""
    data.untyped_storage().resize_(0)
    data.set_()


def bulk_build(index, data, ids, host_graph: bool = True,
               consume_input: bool = False) -> None:
    """``HnswIndex.build(method="device")`` of the port, dense and bit
    kinds.

    ``data``: a numpy-convertible [N, dim] array (uploaded to
    ``index.device``) or, for the dense kind, a tensor already on
    ``index.device`` (another device raises ``ValueError``: the corpus is
    never moved silently). Prepares values (cosine normalize / zero-norm
    skip; bits packed, then unpacked to {0,1} f32 build rows), draws levels
    with the index RNG, runs the batched build, folds the duplicate TIDs,
    then either populates the host graph (``host_graph=True``: host search,
    insert and delete work) or hands the index a ``DeviceGraph`` straight
    from the build tensors (serving-only).

    ``consume_input=True`` (a corpus tensor and ``host_graph=False`` only,
    ``_check_consumable``): the build takes ownership of ``data`` and
    releases its storage as soon as it holds its own copy (after prepare,
    where prepare made one, as cosine does; else once the padded build
    buffer exists), so the build's peak holds one corpus copy less. The
    caller's tensor, and any other on its storage, is unusable afterwards;
    the store is backed by the builder's buffer, as without the option."""
    from .host import GraphElement

    if consume_input:
        _check_consumable(data, host_graph)
    settings = BuildSettings.from_env()
    phase = _Clock(_resolve_device(index.device), settings.timing,
                   "[build] phase {name} {s:.2f}s")
    if index.kind not in ("dense", "bit"):
        raise ValueError(
            f"the {index.kind} kind has no device build (as in the JAX "
            "package): build it with method='native' or 'host'"
        )
    if len(index.elements) or index.store.count:
        raise ValueError("device bulk build requires an empty index")
    device = _resolve_device(index.device)
    host_rows = None
    packed = None  # the bit kind's [n, ceil(dim/8)] byte rows
    metric, ground = index.metric, None
    if index.kind == "bit":
        if isinstance(data, torch.Tensor):
            raise ValueError("device-resident build input is supported for "
                             "dense metrics only")
        packed = bits.prepare_rows(data, index.dim)
        kept_tids = _tids_array(ids)[: len(packed)]
        vectors = torch.from_numpy(np.unpackbits(packed, axis=1)[
            :, : index.dim].astype(np.float32)).to(device)
        metric = "l2" if index.metric == "hamming" else "jacbits"
        ground = _bit_ground_pin()
    elif isinstance(data, torch.Tensor):
        if _resolve_device(data.device) != device:
            raise ValueError(
                f"build input is on {data.device}, the index on {device}: "
                "move it first (the build never moves a corpus silently)"
            )
        vectors, kept_tids = _prepare_dense_device(index, data, ids)
        if consume_input and (vectors.untyped_storage().data_ptr()
                              != data.untyped_storage().data_ptr()):
            _release(data)  # prepare made a transformed copy
    else:
        host_rows, kept_tids = _prepare_dense_bulk(index, data, ids)
        if index.dtype is not None and index.dtype != np.float32:
            # score the halfvec-STORED value (reload-equivalence)
            host_rows = host_rows.astype(index.dtype).astype(np.float32)
        vectors = torch.from_numpy(host_rows).to(device)
    n = vectors.shape[0]
    if n == 0:
        if consume_input:
            _release(data)
        return
    phase.mark("prep")
    levels = index.random_levels(n)
    phase.mark("levels")
    builder = DeviceBuilder(metric, vectors, levels, index.params.m,
                            index.params.ef_construction,
                            batch_max=settings.batch or batch_max_for(n),
                            ground=ground, settings=settings)
    del vectors
    if consume_input:
        _release(data)  # the builder holds its padded copy
    phase.mark("builder-init")
    builder.seed_first(0)
    builder.run_all(batch_schedule(n, builder.batch_max))
    phase.mark("run_all")

    # one download of the fold decisions, applied in insertion order
    heap_tids = [[t] for t in kept_tids.tolist()]
    absorb = builder.arrays.absorb[:n].cpu().numpy()
    for e in np.nonzero(absorb >= 0)[0]:
        heap_tids[int(absorb[e])].extend(heap_tids[e])
        heap_tids[e] = []
    entry = int(builder.arrays.entry)
    index.entry = entry if entry >= 0 else None
    store_dtype = index.dtype or np.float32
    phase.mark("absorb")

    if not host_graph:
        if packed is not None:
            index.store.bulk_load(packed)
        elif host_rows is not None:
            index.store.bulk_load(host_rows.astype(store_dtype))
        else:
            index.store.bulk_load_device(_HostRows(builder.vectors), count=n)
        index.heap_tids = heap_tids
        index.serving_only = True
        phase.mark("finalize.store")
        index._device = _device_graph_from_builder(index, builder, kept_tids)
        # the graph holds what serving needs; drop the build-only state
        builder.arrays = builder.data = builder.vectors = None
        phase.mark("finalize.device-graph")
        return

    if host_rows is None and packed is None:
        host_rows = builder.vectors[:n].cpu().numpy()
    nb0_ids, nb0_d, up_ids, up_d = builder.host_adjacency()
    upper_nbrs = up_ids.reshape(up_ids.shape[0], builder.lmax, builder.m)
    upper_dist = up_d.reshape(up_d.shape[0], builder.lmax, builder.m)
    upper_slot = builder.data.upper_slot[:n].cpu().numpy()
    levels = np.minimum(levels, builder.lmax)
    for i in range(n):
        e = GraphElement(level=int(levels[i]))
        e.neighbors[0] = [(float(dd), int(v))
                          for dd, v in zip(nb0_d[i], nb0_ids[i]) if v >= 0]
        for lc in range(1, int(levels[i]) + 1):
            s = upper_slot[i]
            e.neighbors[lc] = [
                (float(dd), int(v))
                for dd, v in zip(upper_dist[s, lc - 1], upper_nbrs[s, lc - 1])
                if v >= 0
            ]
        index.elements.append(e)
    phase.mark("finalize.host-graph")
    index.store.bulk_load(packed if packed is not None
                          else host_rows.astype(store_dtype))
    index.heap_tids = heap_tids
    index._invalidate_device()
    phase.mark("finalize.store")


def _emit_tables_device(absorb, counts, first_tids, cap1: int):
    """emit_tid [cap1]: an element emits its first TID unless it was
    absorbed into a duplicate or never got a TID."""
    col = torch.full((cap1,), -1, dtype=torch.int32, device=absorb.device)
    col[: len(first_tids)] = torch.from_numpy(
        np.asarray(first_tids, dtype=np.int32)).to(absorb.device)
    return torch.where((absorb < 0) & (counts > 0), col, -1)


def _device_graph_from_builder(index, builder: DeviceBuilder, first_tids):
    """The serving ``DeviceGraph`` straight from the build tensors, cut to
    the n built rows plus the sentinel row n (the build's padding past n
    holds no element). Its ``capacity`` is the padded one the JAX package's
    graph reports as ``cap``."""
    from .device import DeviceGraph, _serve_dtype_for, _serve_value_arrays

    n = builder.n
    a = builder.arrays
    d = builder.data
    nb0 = a.nb0_ids[: n + 1].clone()
    nb0[n] = -1  # row n may be the build's dump row
    up = a.up_ids.clone()
    up[builder.upper_dump] = -1
    if index.kind == "bit":
        # the builder worked on unpacked {0,1} f32 rows; the serving graph
        # wants packed words, packed on the device
        words = _pack_words_device(builder.vectors[: n + 1],
                                   -(-index.dim // 32))
        words[n] = 0  # row n may be the build's dump row
        values = dict(words=words, x2=bits.row_popcount(words))
    else:
        values = _serve_value_arrays(builder.vectors[: n + 1],
                                     _serve_dtype_for(index))
    return DeviceGraph(
        kind=index.kind,
        metric=index.metric,
        cap=n,
        m=index.params.m,
        entry=int(a.entry),
        entry_level=int(a.entry_level),
        neighbors0=nb0,
        upper_neighbors=up,
        upper_slot=d.upper_slot[: n + 1],
        levels=d.levels[: n + 1],
        traversable=a.alive[: n + 1],
        emit_tid=_emit_tables_device(a.absorb[: n + 1], a.tid_counts[: n + 1],
                                     first_tids, n + 1),
        tid_count=a.tid_counts[: n + 1],
        **values,
        capacity=builder.cap,
    )


# ---------------------------------------------------------------------------
# batched insert into an existing index
# ---------------------------------------------------------------------------

#: rows per chunk of ``_edge_distances`` (bounds its [CH, W, D] gather)
_EDGE_CHUNK = 8192


def _edge_distances(metric: str, vectors, src_ids, nbr_ids):
    """Exact f32 order distances d(src, nbr) of adjacency rows: src_ids
    [R], nbr_ids [R, W] (-1 pads -> inf), in chunks of ``_EDGE_CHUNK``
    rows. The builder needs the current neighbour distances of a
    transplanted graph for back-edge re-selection; recomputing them on the
    device is exact and needs no host lists."""
    cap = vectors.shape[0] - 1
    out = []
    for s in range(0, src_ids.shape[0], _EDGE_CHUNK):
        src = src_ids[s : s + _EDGE_CHUNK].clamp(0, cap).long()
        nb = nbr_ids[s : s + _EDGE_CHUNK]
        d = row_dists(vectors, metric, vectors[src], nb)
        out.append(torch.where(nb >= 0, d, _INF))
    return torch.cat(out)


def _seed_builder_from_graph(builder: DeviceBuilder, g, n0: int) -> None:
    """Transplant an existing DeviceGraph (n0 committed elements) into a
    fresh builder's tensors so batches can insert on top of it: layer-0
    and upper adjacency (the upper rows moved from the graph's slots to
    the builder's shuffled ones) with their pruning distances recomputed
    exactly (stored bf16, as the build stores them), live flags, TID
    counts and the entry."""
    dev = builder.device
    a = builder.arrays
    lm0, m = builder.lm0, builder.m
    cap1 = builder.cap + 1
    a.nb0_ids[:n0] = g.neighbors0[:n0, :lm0].to(dev, torch.int32)
    src = torch.arange(cap1, device=dev)
    a.nb0_d.copy_(_edge_distances(builder.metric, builder.data.vectors, src,
                                  a.nb0_ids).to(torch.bfloat16))

    old_slot = g.upper_slot[:n0].to(dev).long()
    lc_common = min(g.upper_neighbors.shape[1] // max(g.m, 1), builder.lmax)
    eids = torch.nonzero(old_slot >= 0).flatten()
    if eids.numel():
        new_slot = builder.data.upper_slot[eids].long()
        a.up_ids[new_slot, : lc_common * m] = g.upper_neighbors.to(dev)[
            old_slot[eids], : lc_common * m].to(torch.int32)
    a.up_d.copy_(_edge_distances(builder.metric, builder.data.vectors,
                                 builder.data.upper_ids, a.up_ids).to(
                                     torch.bfloat16))

    a.alive[:n0] = g.traversable[:n0].to(dev)
    a.tid_counts[:n0] = g.tid_count[:n0].to(dev, torch.int32)
    a.absorb.fill_(-1)
    a.entry = torch.tensor(g.entry, dtype=torch.int64, device=dev)
    a.entry_level = torch.tensor(g.entry_level, dtype=torch.int32,
                                 device=dev)


def bulk_insert(index, data, ids) -> int:
    """Batched device insert into an EXISTING dense index: aminsert at
    bulk-build throughput (``HnswIndex.insert_bulk``).

    The reference serializes inserts under UPDATE_LOCK (insert.rs:
    1281-1313); here frozen-snapshot batches run with the bulk build's
    machinery: the existing graph is transplanted into builder tensors,
    new rows append to fresh slots, and each batch runs candidate search,
    Algorithm-4 selection and the back edges on the device. Duplicate
    folding works across old and new elements (10-TID cap); entry
    promotion follows UPDATE_ENTRY_GREATER. Vacuumed free slots are NOT
    reused (new slots append; the sequential ``insert()`` keeps slot
    reuse). ``data``: an [n, dim] array, or a tensor on the index's device
    (then the insert moves no corpus row to the host).

    Returns the number of elements inserted (excluding folded TIDs)."""
    from .host import GraphElement

    settings = BuildSettings.from_env()
    if index.kind != "dense":
        raise ValueError("bulk_insert supports dense indexes only")
    device = _resolve_device(index.device)
    dev_in = isinstance(data, torch.Tensor)
    if dev_in:
        if _resolve_device(data.device) != device:
            raise ValueError(
                f"insert input is on {data.device}, the index on {device}: "
                "move it first (the insert never moves rows silently)"
            )
        arr, kept_tids = _prepare_dense_device(index, data, ids)
        new_rows = arr
    else:
        arr, kept_tids = _prepare_dense_bulk(index, data, ids)
        if index.dtype is not None and index.dtype != np.float32:
            arr = arr.astype(index.dtype).astype(np.float32)
        new_rows = torch.from_numpy(arr).to(device)
    n_new = int(arr.shape[0])
    if n_new == 0:
        return 0
    n0 = len(index.elements) if not index.serving_only else index.store.count
    if n0 == 0 or index.entry is None:
        bulk_build(index, arr, kept_tids, host_graph=not index.serving_only)
        return n_new

    g = index.device_graph()
    if g.cap != n0:
        raise RuntimeError(f"device graph cap {g.cap} != {n0} index rows")
    if dev_in:
        # old rows come from the device graph itself: the whole insert
        # stays on the device
        old_rows = g.values[:n0].float()
    else:
        old_rows = torch.from_numpy(
            np.asarray(index.store.rows[:n0], dtype=np.float32)).to(device)
    vectors = torch.cat([old_rows, new_rows])
    del old_rows, new_rows
    old_levels = (
        np.fromiter((e.level for e in index.elements), np.int32, n0)
        if not index.serving_only
        else g.levels[:n0].cpu().numpy()
    )
    levels = np.concatenate([old_levels.astype(np.int32),
                             index.random_levels(n_new)])

    # batches pad to batch_max rows: PGV_BUILD_BATCH where it is set, else
    # no wider than the largest batch of the doubling schedule below (the
    # JAX package pads to 1024)
    builder = DeviceBuilder(
        index.metric, vectors, levels, index.params.m,
        index.params.ef_construction,
        batch_max=settings.batch or min(1024, _next_pow2(max(n_new, 64))),
        settings=settings)
    del vectors  # the builder holds its own padded copy
    _seed_builder_from_graph(builder, g, n0)
    levels_cl = builder.data.levels[: n0 + n_new].cpu().numpy()  # clamped

    # Doubling sub-batches (64, 128, ... 1024): a large insert set can be
    # mutually nearest (a new cluster); frozen-snapshot batches do not see
    # each other, so later sub-batches must supply the intra-set edges
    # earlier rows need to be reachable (the sequential aminsert chain
    # gives this for free; doubling bounds the blind fraction).
    sched = []
    pos, size = n0, 64
    while pos < n0 + n_new:
        take = min(size, builder.batch_max, n0 + n_new - pos)
        sched.append((pos, take))
        pos += take
        size = min(size * 2, builder.batch_max)
    builder.run_all(sched)

    # --- fold duplicate TIDs (old or new targets), in insertion order
    absorb = builder.arrays.absorb[: n0 + n_new].cpu().numpy()
    new_tids: list[list[int]] = [[t] for t in kept_tids.tolist()]

    def tids_of(e):
        return new_tids[e - n0] if e >= n0 else index.heap_tids[e]

    for e in np.nonzero(absorb[n0:] >= 0)[0] + n0:
        tids_of(int(absorb[e])).extend(new_tids[e - n0])
        new_tids[e - n0] = []
    entry = int(builder.arrays.entry)
    index.entry = entry if entry >= 0 else None
    index.stats["inserts"] += n_new
    added = sum(1 for t in new_tids if t)
    store_dtype = index.dtype or np.float32

    if index.serving_only:
        if dev_in and index.store._device_rows is not None:
            # a device-backed store stays device-backed: adopt the grown
            # corpus (the graph's own rows), still with no download
            index.store.reset_device(_HostRows(builder.vectors[: n0 + n_new]))
        else:
            arr_host = arr.cpu().numpy() if dev_in else arr
            for row in arr_host:
                index.store.append(row.astype(store_dtype))
        index.heap_tids.extend(new_tids)
        first = [t[0] if t else -1 for t in index.heap_tids]
        index._device = _device_graph_from_builder(index, builder, first)
        return added

    # --- host-graph update: append new elements; rewrite only the rows
    # whose adjacency changed (back-edge targets)
    arr_host = arr.cpu().numpy() if dev_in else arr
    nb0_new, nb0d_new, up_new, upd_new = builder.host_adjacency()
    upper_slot = builder.data.upper_slot.cpu().numpy()
    old_nb0 = g.neighbors0[:n0, : builder.lm0].cpu().numpy()
    changed = set(np.nonzero((nb0_new[:n0] != old_nb0).any(axis=1))[0]
                  .tolist())
    old_slot = g.upper_slot[:n0].cpu().numpy()
    old_up = g.upper_neighbors.cpu().numpy()
    lc = min(old_up.shape[1] // max(g.m, 1), builder.lmax) * builder.m
    eids = np.nonzero(old_slot >= 0)[0]
    diff = (up_new[upper_slot[eids], :lc] != old_up[old_slot[eids], :lc])
    changed.update(eids[diff.any(axis=1)].tolist())

    def lists_from_arrays(eid):
        lev = int(levels_cl[eid])
        e = GraphElement(level=lev)
        e.neighbors[0] = [(float(d), int(v))
                          for d, v in zip(nb0d_new[eid], nb0_new[eid])
                          if v >= 0]
        s = upper_slot[eid]
        for lc_ in range(1, lev + 1):
            cols = slice((lc_ - 1) * builder.m, lc_ * builder.m)
            e.neighbors[lc_] = [(float(d), int(v))
                                for d, v in zip(upd_new[s, cols],
                                                up_new[s, cols])
                                if v >= 0]
        return e

    for i in range(n_new):
        index.store.append(arr_host[i].astype(store_dtype))
        index.elements.append(lists_from_arrays(n0 + i))
        index.heap_tids.append(new_tids[i])
    for eid in changed:
        if index.elements[eid].deleted:
            continue
        repl = lists_from_arrays(eid)
        repl.version = index.elements[eid].version
        index.elements[eid] = repl
    index._invalidate_device()
    if index._log is not None:
        with index._log.batch():  # group commit: one fsync per bulk
            for row, tid in zip(arr_host, kept_tids.tolist()):
                index._log.record_insert(row, tid)
    return added
