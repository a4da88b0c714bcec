"""K10's lookup form (``ops/sparse.py``: the queries' union, the stored
indices mapped into it, the dense-query gather at dim = |U|) against the
JAX package's searchsorted merge (``_exact_search_sparse`` where its dense
queries do not fit: dim unknown or past 2^20, ``pairwise``).

- ``_exact_search_sparse`` at dim 0 (unknown) and at dim 10^9 (the same
  rows with their indices spread up to ~10^9 by an injective increasing
  map) gives JAX's ids but for ties and distances within rtol 1e-5 of the
  metric's scale, in l2, ip, cosine and l1, at k = 10 and k = 100, exact
  and approx (JAX's approx takes bf16 only in its product regime, so both
  sweep exactly here); the spread rows give the dim-0 rows' ids and
  distances exactly.
- The plain sweep's two formulations agree key for key: the lookup form
  (dim 0) and the dense-query form (dim known) add the same products in
  the same order, exact and approx.
- The mapping (``compact_rows``' plain version) equals numpy's
  searchsorted rule, pads kept, absent indices at U, an empty union.
- The query chunk keeps the compacted dense queries within 1 GiB.
Card-only (``cuda``): the mapping kernel equals its plain version with a
union past its 8,192-value sample and a small one, and rejects a union
short of one value; the lookup form
equals its plain version, in one chunk and in many, in one block of rows
and in many, at dim 0 and 10^9, and rejects bf16-rounded values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvector_rx_tpu.graph import device as jdev
from pgvector_rx_tpu.ops import sparse as jsparse
from pgvector_rx_tpu_torch.graph import device as tdev
from pgvector_rx_tpu_torch.ops import bruteforce as tbf
from pgvector_rx_tpu_torch.ops import sparse as tsparse

from test_torch_sparse import _equal_but_ties, _graphs, _rows, _scale, _t

torch.set_num_threads(1)

METRICS = ("l2", "ip", "cosine", "l1")
_INT_MAX = 2**31 - 1
_DIM, _N = 200, 400
BIG = 10**9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _spread(dim, seed=0):
    """An injective increasing map of [0, dim) into [0, 10^9), reaching
    past 10^9 - 10^7."""
    rng = np.random.default_rng(seed)
    out = np.sort(rng.choice(BIG - 1, size=dim - 1, replace=False))
    return np.append(out, BIG - 1).astype(np.int32)


def _mapped(rows, table):
    return [(table[i], v) for i, v in rows]


def _case(metric, seed=21):
    rng = np.random.default_rng(seed)
    rows = _rows(rng, _N, _DIM, 8, empty_every=97)
    queries = _rows(rng, 12, _DIM, 8)
    queries[3] = rows[10]  # a row of the corpus: its own nearest
    queries[5] = (np.zeros(0, np.int32), np.zeros(0, np.float32))  # empty
    return rows, queries


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("approx", [False, True])
def test_lookup_domain_equals_jax(metric, k, approx):
    rows, queries = _case(metric)
    table = _spread(_DIM)
    got = {}
    for dim, rws, qs in ((0, rows, queries),
                         (BIG, _mapped(rows, table), _mapped(queries, table))):
        jg, tg, sv, _ = _graphs(metric, _DIM, rws, 6)
        qi, qv = jsparse.pad_rows(qs, 8)
        jd, ji = jdev._exact_search_sparse(jg, jnp.asarray(qi),
                                           jnp.asarray(qv), k, dim=dim,
                                           approx=approx)
        td, ti = tdev._exact_search_sparse(tg, _t(qi), _t(qv), k, dim=dim,
                                           approx=approx)
        assert tsparse._k10_form(dim, len(qs)) == "lookup"
        _equal_but_ties(ti.numpy(), td.numpy(), np.asarray(ji),
                        np.asarray(jd), 1e-5 * _scale(metric, qv, sv))
        got[dim] = (td, ti)
    # the spread rows are the same rows: the same keys exactly
    assert torch.equal(got[0][1], got[BIG][1])
    assert torch.equal(got[0][0], got[BIG][0])


@pytest.mark.parametrize("metric,approx", [("l2", False), ("ip", False),
                                           ("cosine", False), ("l1", False),
                                           ("l2", True), ("cosine", True)])
def test_lookup_form_equals_the_dense_form_key_for_key(metric, approx):
    """Both plain formulations read a matched query value or 0 for every
    stored entry and sum in entry order: the same keys, ties included."""
    rows, queries = _case(metric, seed=22)
    _, tg, _, _ = _graphs(metric, _DIM, rows, 7)
    qi, qv = (_t(a) for a in jsparse.pad_rows(queries, 8))
    live = tdev._live_rows(tg, None)
    args = (tg.sp_indices, tg.sp_values, live, qi, qv, 70, metric, approx)
    dd, di = tsparse._sparse_topk_plain(*args, dim=_DIM)
    ld, li = tsparse._sparse_topk_plain(*args, dim=0)
    assert torch.equal(di, li) and torch.equal(dd, ld)
    # and the wrapper on CPU tensors is that plain version
    wd, wi = tsparse.sparse_topk(*args, dim=0)
    assert torch.equal(wi, li) and torch.equal(wd, ld)


def test_compact_rows_plain_follows_searchsorted():
    rng = np.random.default_rng(4)
    ci = np.sort(rng.choice(BIG, size=(50, 6)), axis=1).astype(np.int32)
    ci[::7, 3:] = _INT_MAX  # pads
    qi = np.full((3, 6), _INT_MAX, np.int32)
    qi[0, :4] = np.sort(ci[1, :4])  # indices the rows hold
    qi[1, :2] = [0, BIG - 1]  # the two ends of the domain
    qi[2, :3] = np.unique(ci[20:23, 0])[:3]
    uni, pos = tsparse.compact_union(_t(qi))
    want_u = np.unique(qi[qi != _INT_MAX])
    np.testing.assert_array_equal(uni.numpy(), want_u)
    np.testing.assert_array_equal(
        pos.numpy(), np.where(qi == _INT_MAX, _INT_MAX,
                              np.searchsorted(want_u, qi)))
    got = tsparse.compact_rows(_t(ci), uni).numpy()
    p = np.searchsorted(want_u, ci)
    hit = (p < len(want_u)) & (want_u[np.minimum(p, len(want_u) - 1)] == ci)
    np.testing.assert_array_equal(
        got, np.where(ci == _INT_MAX, _INT_MAX, np.where(hit, p, len(want_u))))
    assert hit.sum() >= 6 and (~hit & (ci != _INT_MAX)).sum() > 100
    # queries with no entry: an empty union, every entry at U = 0
    e_uni, e_pos = tsparse.compact_union(_t(np.full((2, 6), _INT_MAX,
                                                    np.int32)))
    assert e_uni.shape == (0,) and (e_pos == _INT_MAX).all()
    np.testing.assert_array_equal(
        tsparse.compact_rows(_t(ci), e_uni).numpy(),
        np.where(ci == _INT_MAX, _INT_MAX, 0))


@pytest.mark.parametrize("p", [1, 8, 64, 1000, 16000])
def test_lookup_chunk_keeps_the_dense_queries_within_1_gib(p):
    tile = 32 * tsparse._K10D_WARPS
    c = tsparse._lookup_chunk(p)
    ldq = -(-c // tile) * tile
    assert ldq * (c * p + 1) * 4 <= 1 << 30
    assert c >= 128  # every budget a sparse index takes keeps a full tile
    c2 = c + tile
    assert -(-c2 // tile) * tile * (c2 * p + 1) * 4 > 1 << 30


@pytest.mark.parametrize("p", [1, 64, 1000])
def test_lookup_rows_keep_the_mapped_block_bounded(p):
    r = tsparse._lookup_rows(p)
    assert r * p * 4 <= tsparse._LOOKUP_MAP_BYTES < (r + 1) * p * 4


def test_merge_kernel_keys_is_the_unsigned_top_k():
    """The blocks' keys merge as a top-k in the kernel's unsigned order
    (keys with the top bit set after those without), the empty key last."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 2**64, (5, 30), dtype=np.uint64)
    keys[1, 4:] = 2**64 - 1  # empty (-1 as int64)
    keys[2, :] = 2**64 - 1
    keys[3, :7] = keys[3, 7]  # a repeated key
    parts = [torch.from_numpy(np.ascontiguousarray(a).view(np.int64))
             for a in np.split(keys, 3, axis=1)]
    got = tsparse._merge_kernel_keys(parts, 12).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, np.sort(keys, axis=1)[:, :12])


# ---------------------------------------------------------------------------
# Card-only: the mapping kernel and the lookup form against plain
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("u", [37, 20_000])
def test_k10_compact_equals_plain_on_the_card(u, cuda):
    rng = np.random.default_rng(u)
    uni = np.sort(rng.choice(BIG, size=u, replace=False)).astype(np.int32)
    ci = np.where(rng.random((3000, 64)) < 0.5,
                  uni[rng.integers(0, u, (3000, 64))],
                  rng.integers(0, BIG, (3000, 64))).astype(np.int32)
    ci = np.sort(ci, axis=1)
    ci[::5, 40:] = _INT_MAX
    ci_t, uni_t = (torch.from_numpy(a).to(cuda) for a in (ci, uni))
    before = tbf.LAUNCHES["k10_compact"]
    got = tsparse.compact_rows(ci_t, uni_t)
    assert tbf.LAUNCHES["k10_compact"] == before + 1
    want = tsparse._compact_rows_plain(ci_t, uni_t)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # control: a union short of one value the rows hold maps differently
    hit = np.unique(ci[np.isin(ci, uni)])
    short = torch.from_numpy(uni[uni != hit[len(hit) // 2]]).to(cuda)
    assert not torch.equal(tsparse.compact_rows(ci_t, short), want)


@pytest.mark.cuda
@pytest.mark.parametrize("metric,approx", [("l2", False), ("ip", False),
                                           ("cosine", False), ("l1", False),
                                           ("l2", True)])
@pytest.mark.parametrize("k", [10, 100])
def test_k10_lookup_equals_plain_on_the_card(metric, approx, k, cuda,
                                             monkeypatch):
    """The lookup form in one chunk, at dim 0 and at dim 10^9 on the same
    rows spread (equal keys), and in chunks of 32 queries (equal keys);
    held to its plain version but for ties; a control sweep over
    bf16-rounded values is rejected."""
    rng = np.random.default_rng(31)
    dim = 5000
    rows = _rows(rng, 3000, dim, 64, empty_every=211)
    queries = _rows(rng, 70, dim, 64)
    table = _spread(dim, 1)
    ci, cv = tsparse.pad_rows(rows, 64, cuda)
    qi, qv = tsparse.pad_rows(queries, 64, cuda)
    bci, _ = tsparse.pad_rows(_mapped(rows, table), 64, cuda)
    bqi, _ = tsparse.pad_rows(_mapped(queries, table), 64, cuda)
    live = torch.rand(ci.shape[0], device=cuda) > 0.1
    tol = 1e-5 * _scale(metric, qv.cpu().numpy(), cv.cpu().numpy())
    before = dict(tbf.LAUNCHES)
    kd, ki = tsparse.sparse_topk(ci, cv, live, qi, qv, k, metric, approx)
    assert tbf.LAUNCHES["k10_sparse_lookup"] == (
        before["k10_sparse_lookup"] + -(-k // 64))
    assert tbf.LAUNCHES["k10_compact"] == before["k10_compact"] + 1
    assert tbf.LAUNCHES["k10_sparse"] == before["k10_sparse"]
    pd, pi = tsparse._sparse_topk_plain(ci, cv, live, qi, qv, k, metric,
                                        approx)
    torch.cuda.synchronize()
    _equal_but_ties(ki.cpu().numpy(), kd.cpu().numpy(), pi.cpu().numpy(),
                    pd.cpu().numpy(), tol)
    bd, bi = tsparse.sparse_topk(bci, cv, live, bqi, qv, k, metric, approx,
                                 dim=BIG)
    assert torch.equal(bi, ki) and torch.equal(bd, kd)
    monkeypatch.setattr(tsparse, "_lookup_chunk", lambda p: 32)
    cd, cid = tsparse.sparse_topk(ci, cv, live, qi, qv, k, metric, approx)
    assert torch.equal(cid, ki) and torch.equal(cd, kd)
    # rows mapped and swept in blocks of 700 (the last one short), merged:
    # 3 chunks of queries x 5 blocks of rows
    monkeypatch.setattr(tsparse, "_lookup_rows", lambda p: 700)
    before = tbf.LAUNCHES["k10_compact"]
    rd, rid = tsparse.sparse_topk(ci, cv, live, qi, qv, k, metric, approx)
    assert tbf.LAUNCHES["k10_compact"] == before + 3 * 5
    assert torch.equal(rid, ki) and torch.equal(rd, kd)
    if metric == "l2" and not approx:
        rd, ri = tsparse._sparse_topk_plain(
            ci, cv.bfloat16().float(), live, qi, qv.bfloat16().float(), k,
            metric)
        with pytest.raises(AssertionError):
            _equal_but_ties(ki.cpu().numpy(), kd.cpu().numpy(),
                            ri.cpu().numpy(), rd.cpu().numpy(), tol)
