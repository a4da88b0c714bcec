"""The port's sparse ops (pgvector_rx_tpu_torch/ops/sparse.py) and its sparse
exact / approx engine (``graph/device._exact_search_sparse``, kernel K10's
plain version on the CPU) against the JAX package's, on the same numpy
inputs.

- ``pad_rows`` / ``densify_queries`` give JAX's arrays; ``pairwise``,
  ``pairwise_dense_q`` and ``gathered`` give JAX's distances within
  rtol 1e-5 of the metric's scale (sums in another order), four metrics.
- The order keys order negative distances (sparse ip) before positive ones
  and tie -0.0 with +0.0; on non-negative distances they are the old keys.
- ``_exact_search_sparse``, exact and approx, in each of JAX's three
  regimes (the densified-corpus product, the dense-query gather, the
  searchsorted merge; the last two forced by patching JAX's
  ``_SPARSE_MATMUL_FACTOR`` / ``DENSE_Q_MAX_DIM`` and the port's
  counterparts): ids equal but for ties, distances within rtol 1e-5 of the
  scale, with dead rows and a row mask.
- Ties (integer values, rows that share no index with the query) come back
  in JAX's order exactly, in ip and cosine; a control sweep on the old
  order keys (raw f32 bits) does not.
- K10's form (``_k10_form``) is the dense-query form exactly where JAX's
  sweep takes its dense-query gather (``dense_q_ok``), at, below and above
  both sides of the cutover; the form's operand and launch plan.
Card-only (``cuda``): both forms of K10 against their plain version in
four metrics and approx mode, k = 10 and 100 (the kernel's rounds), the
dense form with a zero row and the ip -0.0 tie and a dim on each side of
the cutover; and K4's sparse-row mode against the plain walk.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvector_rx_tpu.graph import device as jdev
from pgvector_rx_tpu.ops import sparse as jsparse
from pgvector_rx_tpu_torch.graph import device as tdev
from pgvector_rx_tpu_torch.ops import beam as tbeam
from pgvector_rx_tpu_torch.ops import bruteforce as tbf
from pgvector_rx_tpu_torch.ops import sparse as tsparse

torch.set_num_threads(1)

METRICS = ("l2", "ip", "cosine", "l1")
CPU = torch.device("cpu")
_INT_MAX = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rows(rng, n, dim, p, integer=False, empty_every=0):
    """n sorted-unique sparse rows of at most p entries over dim; values
    standard normal, or small integers (exact in f32 sums and in bf16)."""
    out = []
    for i in range(n):
        k = 0 if empty_every and i % empty_every == 0 else int(
            rng.integers(1, p + 1))
        idx = np.sort(rng.choice(dim, size=k, replace=False)).astype(np.int32)
        val = (rng.integers(1, 5, size=k).astype(np.float32) if integer
               else rng.standard_normal(k).astype(np.float32))
        out.append((idx, val))
    return out


def _scale(metric, qv, xv):
    """The size distances reach at these values: |q|^2 + |x|^2 (l2, ip),
    sum|q| + sum|x| (l1), 2 (cosine)."""
    if metric == "cosine":
        return 2.0
    if metric == "l1":
        return float(np.abs(qv).sum(1).max() + np.abs(xv).sum(1).max())
    return float((qv * qv).sum(1).max() + (xv * xv).sum(1).max())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_pad_rows_and_densify_equal_jax():
    rows = _rows(np.random.default_rng(1), 20, 40, 6, empty_every=7)
    ji, jv = jsparse.pad_rows(rows, 8)
    ti, tv = tsparse.pad_rows(rows, 8, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tv.numpy(), jv)
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    np.testing.assert_array_equal(
        tsparse.densify_queries(ti, tv, 40).numpy(),
        np.asarray(jsparse.densify_queries(jnp.asarray(ji), jnp.asarray(jv),
                                           40)))
    with pytest.raises(ValueError, match="more than 4 non-zero"):
        tsparse.pad_rows(rows, 4, device="cpu")


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_and_gathered_equal_jax(metric):
    rng = np.random.default_rng(2)
    base = _rows(rng, 300, 60, 8, empty_every=50)
    queries = _rows(rng, 7, 60, 8)
    bi, bv = jsparse.pad_rows(base, 8)
    qi, qv = jsparse.pad_rows(queries, 8)
    tol = 1e-5 * _scale(metric, qv, bv)
    ref = np.asarray(jsparse.pairwise(metric, bi, bv, qi, qv))
    got = tsparse.pairwise(metric, _t(bi), _t(bv), _t(qi), _t(qv)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    ref_d = np.asarray(jsparse.pairwise_dense_q(metric, 60, bi, bv, qi, qv))
    got_d = tsparse.pairwise_dense_q(metric, 60, _t(bi), _t(bv), _t(qi),
                                     _t(qv)).numpy()
    np.testing.assert_allclose(got_d, ref_d, rtol=0, atol=tol)
    ids = rng.integers(0, 300, size=(7, 9)).astype(np.int32)
    ref_g = np.asarray(jsparse.gathered(metric, bi, bv, ids, qi, qv))
    got_g = tsparse.gathered(metric, _t(bi), _t(bv), _t(ids), _t(qi),
                             _t(qv)).numpy()
    np.testing.assert_allclose(got_g, ref_g, rtol=0, atol=tol)
    # the walk's row distances are the same function
    walk = tbeam.row_dists((_t(bi), _t(bv)), metric, (_t(qi), _t(qv)),
                           _t(ids)).numpy()
    np.testing.assert_array_equal(walk, got_g)


def test_order_keys_order_signed_distances():
    d = torch.tensor([[3.0, -0.0, -2.5, 0.0, float("inf"), -1e-30, 1e-30,
                       -7.0]])
    rows = torch.arange(8)[None]
    keys = tbf._order_keys(d, rows)
    order = torch.argsort(keys, dim=1)[0].tolist()
    # -7, -2.5, -1e-30, then the two zeros tied (lower row first), ...
    assert order == [7, 2, 5, 1, 3, 6, 0, 4]
    back_d, back_i = tbf._from_order_keys(keys)
    assert back_i[0].tolist() == [0, 1, 2, 3, -1, 5, 6, 7]
    np.testing.assert_array_equal(
        back_d.numpy(),
        np.array([[3.0, 0.0, -2.5, 0.0, np.inf, -1e-30, 1e-30, -7.0]],
                 np.float32))
    # non-negative distances keep the old keys: the l1 sweep and K9 order
    # exactly as before
    pos = torch.tensor([[0.0, 1.5, 2.0, 1e-40, 3e38]])
    old = ((pos + 0.0).view(torch.int32).long() << 32) | torch.arange(5)
    assert torch.equal(tbf._order_keys(pos, torch.arange(5)[None]), old)
    assert tbf._from_order_keys(torch.tensor([-1]))[1].item() == -1


# ---------------------------------------------------------------------------
# _exact_search_sparse against JAX's, in its three regimes
# ---------------------------------------------------------------------------

_N, _P = 400, 8
_FIELDS = ("neighbors0", "upper_neighbors", "upper_slot", "levels",
           "traversable", "emit_tid", "tid_count", "sp_indices", "sp_values")


def _graphs(metric, dim, rows, seed):
    """A JAX sparse DeviceGraph (no edges: the sweep reads rows and flags
    only) with dead and untupled rows, and the port's copy of it."""
    rng = np.random.default_rng(seed)
    n = len(rows)
    si = np.full((n + 1, _P), _INT_MAX, np.int32)
    sv = np.zeros((n + 1, _P), np.float32)
    si[:n], sv[:n] = jsparse.pad_rows(rows, _P)
    trav = rng.random(n + 1) > 0.05
    trav[n] = False
    tid = np.ones(n + 1, np.int32)
    tid[rng.random(n + 1) < 0.02] = 0
    arrays = dict(
        neighbors0=np.full((n + 1, 16), -1, np.int32),
        upper_neighbors=np.full((1, 8), -1, np.int32),
        upper_slot=np.full(n + 1, -1, np.int32),
        levels=np.zeros(n + 1, np.int32), traversable=trav,
        emit_tid=np.arange(n + 1, dtype=np.int32), tid_count=tid,
        sp_indices=si, sp_values=sv)
    jg = jdev.DeviceGraph(kind="sparse", metric=metric, cap=n, m=8, entry=0,
                          entry_level=0,
                          **{f: jnp.asarray(a) for f, a in arrays.items()})
    tg = tdev.DeviceGraph.from_numpy(arrays, kind="sparse", metric=metric,
                                     cap=n, m=8, entry=0, entry_level=0,
                                     device="cpu")
    return jg, tg, sv, rng


def _equal_but_ties(ids_a, d_a, ids_b, d_b, tol):
    """Distances within ``tol`` at every rank; an id in one list and not
    the other lies within ``tol`` of the other list's k-th distance."""
    np.testing.assert_allclose(d_a, d_b, rtol=0, atol=tol)
    for r in range(ids_a.shape[0]):
        da = dict(zip(ids_a[r].tolist(), d_a[r].tolist()))
        db = dict(zip(ids_b[r].tolist(), d_b[r].tolist()))
        for i in set(da) - set(db):
            assert abs(da[i] - d_b[r, -1]) <= tol, (r, i)
        for i in set(db) - set(da):
            assert abs(db[i] - d_a[r, -1]) <= tol, (r, i)


# regime -> (dim, JAX patches, port patches); each regime its own dim, so
# no jit trace of another regime is reused
_REGIMES = {
    "matmul": (300, {}, {}),
    "dense_q": (301, {"_SPARSE_MATMUL_FACTOR": 1}, {"SPARSE_MATMUL_FACTOR": 1}),
    "searchsorted": (302, {"DENSE_Q_MAX_DIM": 100}, {"DENSE_Q_MAX_DIM": 100}),
}


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("regime", list(_REGIMES))
@pytest.mark.parametrize("approx", [False, True])
def test_exact_search_sparse_equals_jax(metric, regime, approx, monkeypatch):
    dim, jpatch, tpatch = _REGIMES[regime]
    for name, val in jpatch.items():
        monkeypatch.setattr(jsparse if name == "DENSE_Q_MAX_DIM" else jdev,
                            name, val)
    for name, val in tpatch.items():
        monkeypatch.setattr(tsparse if name == "DENSE_Q_MAX_DIM" else tdev,
                            name, val)
    rng = np.random.default_rng(5)
    rows = _rows(rng, _N, dim, _P, empty_every=97)
    jg, tg, sv, rng = _graphs(metric, dim, rows, 6)
    queries = _rows(rng, 12, dim, _P)
    queries[3] = rows[10]  # a row of the corpus: its own nearest
    qi, qv = jsparse.pad_rows(queries, _P)
    mask = rng.random(_N + 1) < 0.7
    tol = 1e-5 * _scale(metric, qv, sv)
    for m in (None, mask):
        jd, ji = jdev._exact_search_sparse(
            jg, jnp.asarray(qi), jnp.asarray(qv), 10, dim=dim,
            row_mask=None if m is None else jnp.asarray(m), approx=approx)
        td, ti = tdev._exact_search_sparse(
            tg, _t(qi), _t(qv), 10, dim=dim,
            row_mask=None if m is None else _t(m), approx=approx)
        _equal_but_ties(ti.numpy(), td.numpy(), np.asarray(ji),
                        np.asarray(jd), tol)
        assert (ti.numpy() >= 0).all()


def test_approx_rounds_to_bf16_only_in_the_product_regime(monkeypatch):
    """The port's approx takes bf16 values exactly where JAX's takes its
    bf16 product (l2 / ip / cosine, dim <= 1024 P): there the sweep's
    distances are the bf16 ones and the engine returns the winners' f32
    distances; elsewhere (l1, a larger dim) approx is the exact sweep."""
    rng = np.random.default_rng(8)
    rows = _rows(rng, _N, 300, _P)
    flags = []
    sweep = tsparse.sparse_topk
    monkeypatch.setattr(tsparse, "sparse_topk", lambda *a, **kw: (
        flags.append(kw["approx"]), sweep(*a, **kw))[1])
    for metric, dim, bf16 in (("l2", 300, True), ("cosine", 8 * _P * 128,
                                                   True),
                              ("l2", 8 * _P * 128 + 1, False),
                              ("l1", 300, False)):
        _, tg, _, _ = _graphs(metric, 300, rows, 9)
        qi, qv = (_t(a) for a in jsparse.pad_rows(rows[:32], _P))
        d, i = tdev._exact_search_sparse(tg, qi, qv, 10, dim=dim,
                                         approx=True)
        assert flags[-1] is bf16, (metric, dim)
        exact = tsparse.gathered(metric, tg.sp_indices, tg.sp_values, i, qi,
                                 qv)
        assert torch.equal(d, exact)  # f32 distances, whatever selected
        if bf16:
            raw, _ = sweep(tg.sp_indices, tg.sp_values,
                           tdev._live_rows(tg, None), qi, qv, 10, metric,
                           approx=True)
            assert not torch.equal(raw, d)  # the selection's were bf16's


@pytest.mark.parametrize("metric", ["ip", "cosine"])
def test_tie_order_equals_jax_exactly(metric, monkeypatch):
    """Integer values and rows that share no index with the query: the
    distances tie exactly (ip at -dot with zero overlap, -0.0 in JAX;
    cosine at 1.0), and the ids must be JAX's, tie order included. For ip,
    whose distances are negative, the same sweep on the old keys (raw f32
    bits) must not be."""
    rng = np.random.default_rng(11)
    dim = 48
    rows = _rows(rng, 120, dim, 3, integer=True, empty_every=9)
    rows[40] = rows[41] = rows[7]  # duplicates: ties at a negative ip
    jg, tg, _, rng = _graphs(metric, dim, rows, 12)
    queries = _rows(rng, 16, dim, 3, integer=True)
    qi, qv = jsparse.pad_rows(queries, _P)
    jd, ji = jdev._exact_search_sparse(jg, jnp.asarray(qi), jnp.asarray(qv),
                                       40, dim=dim)
    td, ti = tdev._exact_search_sparse(tg, _t(qi), _t(qv), 40, dim=dim)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd) + 0.0)
    tied = (np.asarray(jd)[:, 1:] == np.asarray(jd)[:, :-1]).any(1).mean()
    assert tied > 0.9  # the check is about ties
    if metric != "ip":
        return  # cosine distances are >= 0: the old keys order them too
    old_keys = (lambda d, r:
                ((d + 0.0).view(torch.int32).long() << 32) | r)
    monkeypatch.setattr(tsparse, "_order_keys", old_keys)
    monkeypatch.setattr(tsparse, "_from_order_keys", lambda keys: (
        torch.where(keys < 0, float("inf"),
                    (keys >> 32).to(torch.int32).view(torch.float32)),
        torch.where(keys < 0, -1, keys & 0xFFFFFFFF)))
    cd, ci = tdev._exact_search_sparse(tg, _t(qi), _t(qv), 40, dim=dim)
    assert not np.array_equal(ci.numpy(), np.asarray(ji))


@pytest.mark.parametrize("metric", METRICS)
def test_plain_sweep_blocks_and_the_tail(metric, monkeypatch):
    """Blocks smaller than the corpus merge to the same keys; fewer live
    rows than k leave (inf, -1) past them; the sorted search and the
    dense-query gather give the same sweep."""
    rng = np.random.default_rng(13)
    rows = _rows(rng, 200, 90, _P, empty_every=31)
    _, tg, _, rng = _graphs(metric, 90, rows, 14)
    qi, qv = (_t(a) for a in jsparse.pad_rows(_rows(rng, 6, 90, _P), _P))
    live = tdev._live_rows(tg, None)
    args = (tg.sp_indices, tg.sp_values, live, qi, qv, 30, metric)
    d1, i1 = tsparse._sparse_topk_plain(*args, dim=90)
    d0, i0 = tsparse._sparse_topk_plain(*args, dim=0)
    assert torch.equal(i1, i0)
    torch.testing.assert_close(d1, d0, rtol=0, atol=1e-5)
    monkeypatch.setattr(tsparse, "_CHUNK_ELEMS", 6 * _P * 17)
    d2, i2 = tsparse._sparse_topk_plain(*args, dim=90)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)
    few = torch.zeros_like(live)
    few[[3, 50, 120]] = True
    d3, i3 = tsparse.sparse_topk(tg.sp_indices, tg.sp_values, few, qi, qv,
                                 10, metric)
    assert (i3[:, 3:] == -1).all() and torch.isinf(d3[:, 3:]).all()
    assert set(i3[0, :3].tolist()) == {3, 50, 120}


def test_sparse_topk_refuses_bad_arguments():
    z = torch.zeros((4, 2), dtype=torch.int32)
    v = torch.zeros((4, 2))
    live = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="unknown sparse metric"):
        tsparse.sparse_topk(z, v, live, z, v, 2, "hamming")
    with pytest.raises(ValueError, match="l2, ip or cosine"):
        tsparse.sparse_topk(z, v, live, z, v, 2, "l1", approx=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsparse._sparse_topk_cuda(z, v, live, z, v, 2, "l2")


# ---------------------------------------------------------------------------
# K10's two forms: the shape rule and the dense-query form's operands
# ---------------------------------------------------------------------------

# (dim, B): below, at and above each side of JAX's dense_q_ok cutover
# (0 < dim <= DENSE_Q_MAX_DIM and B (dim + 1) 4 <= 2^30)
_FORM_SHAPES = [(0, 4), (1, 1), (30_000, 1024), (262_143, 1024),
                (262_144, 1024), (1 << 20, 255), (1 << 20, 256),
                ((1 << 20) + 1, 1)]


@pytest.mark.parametrize("dim,b", _FORM_SHAPES)
def test_k10_form_follows_jax_dense_q_ok(dim, b, monkeypatch):
    """K10 takes its dense-query form exactly where the JAX package's
    sweep takes its dense-query gather: JAX's l1 sweep (which never takes
    the densified-corpus product) is traced at the same shapes, abstractly
    (no array of that size is made), and the branch it reaches is read."""
    import jax

    reached = []
    for name in ("pairwise_dense_q", "pairwise"):
        orig = getattr(jsparse, name)
        monkeypatch.setattr(jsparse, name, lambda *a, _n=name, _o=orig:
                            reached.append(_n) or _o(*a))
    rows = _rows(np.random.default_rng(3), 20, 40, _P)
    jg, _, _, _ = _graphs("l1", 40, rows, 4)
    q = jax.ShapeDtypeStruct((b, _P), jnp.int32)
    qv = jax.ShapeDtypeStruct((b, _P), jnp.float32)
    jax.eval_shape(lambda g, qi_, qv_: jdev._exact_search_sparse.__wrapped__(
        g, qi_, qv_, 10, dim=dim), jg, q, qv)
    assert reached in (["pairwise_dense_q"], ["pairwise"])
    want = "dense" if reached == ["pairwise_dense_q"] else "lookup"
    assert tsparse._k10_form(dim, b) == want
    assert tsparse.dense_q_fits(dim, b) == (want == "dense")


def test_densify_queries_t_is_the_transposed_dense_queries():
    """The dense-query form's operand [dim + 1, ldq] (query-minor) holds
    ``densify_queries``' columns 0 .. dim - 1 transposed, a zero row
    ``dim`` and zero columns past B; bf16 holds the bf16-rounded values."""
    rows = _rows(np.random.default_rng(8), 9, 50, 6, empty_every=4)
    qi, qv = tsparse.pad_rows(rows, 8, device="cpu")
    t = tsparse.densify_queries_t(qi, qv, 50, 16)
    assert t.shape == (51, 16) and t.dtype == torch.float32
    assert torch.equal(t[:50, :9].T, tsparse.densify_queries(qi, qv, 50)[:, :50])
    assert not t[50].any() and not t[:, 9:].any()
    tb = tsparse.densify_queries_t(qi, qv, 50, 16, torch.bfloat16)
    assert torch.equal(tb.float(), tsparse._bf16(t))


@pytest.mark.parametrize("n,b,p,k", [(100_001, 1024, 64, 10),
                                     (100_001, 1024, 64, 64),
                                     (3000, 70, 64, 36), (50, 3, 8, 64),
                                     (10, 1, 1000, 64), (7, 300, 5, 1)])
def test_k10_dense_plan_fits_the_kernel(n, b, p, k):
    """The dense-query form's launch keeps the kernel's rules: shared
    memory within its limit, ldq a multiple of every tile the rounds may
    take, non-empty splits covering every row."""
    warps, ldq, rc, splits, rows = tsparse._k10_dense_plan(n, b, p, k, 132)
    assert 1 <= warps <= 8 and rc >= 1
    assert 8 * k * warps * 32 + 16 * rc * p <= tsparse._K10_SMEM
    assert ldq >= b and ldq % (32 * warps) == 0
    assert ldq == tsparse._k10_dense_plan(n, b, p, 1, 132)[1]
    assert splits * rows >= n and (splits - 1) * rows < n
    assert b * splits * k * 8 <= max(tsparse._K10D_PART_BYTES, b * k * 8)


# ---------------------------------------------------------------------------
# Card-only: K10 and K4's sparse-row mode against their plain versions
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("metric,approx", [("l2", False), ("ip", False),
                                           ("cosine", False), ("l1", False),
                                           ("l2", True), ("ip", True),
                                           ("cosine", True)])
@pytest.mark.parametrize("k", [10, 100])
def test_k10_equals_plain_on_the_card(metric, approx, k, cuda):
    rng = np.random.default_rng(17)
    rows = _rows(rng, 3000, 5000, 64, empty_every=211)
    ci, cv = tsparse.pad_rows(rows, 64, cuda)
    qi, qv = tsparse.pad_rows(_rows(rng, 70, 5000, 64), 64, cuda)
    live = torch.rand(ci.shape[0], device=cuda) > 0.1
    before = tbf.LAUNCHES["k10_sparse_lookup"]
    kd, ki = tsparse.sparse_topk(ci, cv, live, qi, qv, k, metric, approx)
    assert tbf.LAUNCHES["k10_sparse_lookup"] == before + -(-k // 64)
    pd, pi = tsparse._sparse_topk_plain(ci, cv, live, qi, qv, k, metric,
                                        approx, 5000)
    torch.cuda.synchronize()
    tol = 1e-5 * _scale(metric, qv.cpu().numpy(), cv.cpu().numpy())
    _equal_but_ties(ki.cpu().numpy(), kd.cpu().numpy(), pi.cpu().numpy(),
                    pd.cpu().numpy(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("metric,approx", [("l2", False), ("ip", False),
                                           ("cosine", False), ("l1", False),
                                           ("l2", True), ("ip", True),
                                           ("cosine", True)])
@pytest.mark.parametrize("k", [10, 100])
def test_k10_dense_form_equals_plain_on_the_card(metric, approx, k, cuda,
                                                 monkeypatch):
    """K10's dense-query form against its plain version (the same gather)
    with a zero row, a row that shares no index with a query (ip: the
    -0.0 tie) and dead rows; then a dim just past the cutover (the
    cutover lowered by patching DENSE_Q_MAX_DIM) takes the lookup form."""
    rng = np.random.default_rng(19)
    dim = 5000
    # index dim - 1 only in row 5 and query 0: every other row shares no
    # index with query 0 (ip ties at -0.0 / +0.0, cosine at 1)
    rows = _rows(rng, 3000, dim - 1, 64, empty_every=211)
    queries = _rows(rng, 70, dim - 1, 64)
    rows[5] = (np.array([dim - 1], np.int32), np.array([2.0], np.float32))
    queries[0] = (np.array([dim - 1], np.int32), np.array([-1.0],
                                                          np.float32))
    ci, cv = tsparse.pad_rows(rows, 64, cuda)
    qi, qv = tsparse.pad_rows(queries, 64, cuda)
    live = torch.rand(ci.shape[0], device=cuda) > 0.1
    live[5] = True
    tol = 1e-5 * _scale(metric, qv.cpu().numpy(), cv.cpu().numpy())
    for d, form in ((dim, "k10_sparse"), (dim + 1, "k10_sparse_lookup")):
        monkeypatch.setattr(tsparse, "DENSE_Q_MAX_DIM", dim)
        before = dict(tbf.LAUNCHES)
        kd, ki = tsparse.sparse_topk(ci, cv, live, qi, qv, k, metric, approx,
                                     dim=d)
        assert tbf.LAUNCHES[form] == before[form] + -(-k // 64), form
        pd, pi = tsparse._sparse_topk_plain(ci, cv, live, qi, qv, k, metric,
                                            approx, d)
        torch.cuda.synchronize()
        _equal_but_ties(ki.cpu().numpy(), kd.cpu().numpy(), pi.cpu().numpy(),
                        pd.cpu().numpy(), tol)
        if metric in ("ip", "cosine"):  # query 0's rows tie exactly (all
            # but row 5): the lowest live rows, in order
            np.testing.assert_array_equal(ki[0].cpu().numpy(),
                                          pi[0].cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_k4_sparse_mode_descends_in_its_launch(metric, cuda):
    """Sparse rows on a graph the native build made, their values on a
    grid of sixteenths (every distance then rounds alike in both
    versions): the descent in K4's launch lands where the plain descent
    lands, and the walk from there equals the plain walk."""
    from pgvector_rx_tpu_torch import HnswIndex
    from pgvector_rx_tpu_torch.data import make_sparse_dataset
    from pgvector_rx_tpu_torch.types import SparseVec

    from test_torch_scan import assert_descent_walk_matches_plain

    rows, qs = make_sparse_dataset(2000, 3000, 64, 32, seed=9)
    rows, qs = ([SparseVec(r.dim, r.indices, np.round(r.values * 16) / 16)
                 for r in part] for part in (rows, qs))
    idx = HnswIndex.build(rows, metric=metric, seed=1, device=cuda)
    g = idx.device_graph()
    assert g.entry_level >= 1
    q = tdev.prepare_queries(idx, qs, cuda)
    upper = (g.upper_slot, g.upper_neighbors, g.entry, g.entry_level)
    assert assert_descent_walk_matches_plain(
        g.rows, g.neighbors0, g.traversable, upper, g.m, metric, q) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
def test_k4_sparse_mode_equals_the_plain_walk(metric, cuda):
    from pgvector_rx_tpu_torch import HnswIndex
    from pgvector_rx_tpu_torch.data import make_sparse_dataset

    rows, qs = make_sparse_dataset(2000, 3000, 64, 32, seed=9)
    idx = HnswIndex.build(rows, metric=metric, seed=1, device=cuda)
    g = idx.device_graph()
    q = tdev.prepare_queries(idx, qs, cuda)
    s_ids, s_d = tdev._descent_seeds(g, q, g.entry_level)
    walk = (g.rows, g.neighbors0, g.traversable, None, metric,
            tbeam._queries(q, metric), s_ids.to(torch.int32).contiguous(),
            s_d.float().contiguous())
    kw = dict(width=40, spill=0, max_steps=192, scan=False)
    before = tbf.LAUNCHES["k4_beam_sparse"]
    kd, ki, ks = tbeam._serve_finish(*tbeam._walk_cuda(*walk, **kw))
    assert tbf.LAUNCHES["k4_beam_sparse"] == before + 1
    pd, pi, ps = tbeam._serve_finish(*tbeam._walk_plain(*walk, **kw))
    same = (ki == pi).all(dim=1).float().mean().item()
    assert same >= 0.95, same
    fin = torch.isfinite(pd)
    assert torch.equal(fin, torch.isfinite(kd))
    assert (kd[fin] - pd[fin]).abs().max().item() <= 1e-4
