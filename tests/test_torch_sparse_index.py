"""The sparse kind end to end in the port against the JAX package, on the
same data and seeds (``data.make_sparse_dataset``, bench_suite's sparse
generator, at a small size).

- A JAX sparse index (native build) carried into the port through its
  checkpoint: the exact, approx and beam engines return JAX's ids but for
  ties, distances within rtol 1e-5 of the metric's scale (the beam: the
  descent, then K4's sparse-row mode's plain walk, over the same graph).
- Checkpoints move both ways (``sp_indices`` / ``sp_values``), the serving
  load refuses them in both packages, and the append log replays sparse
  inserts.
- ``FlatIndex`` over sparse rows equals JAX's.
- A small tests/t/028 (3-d rows cast to sparsevec): exact and beam recall
  against the float64 top-k at the t/028 floors.
- Each of the four sparse operator classes makes an index that answers as
  JAX's does.
- The port's native sparse build (its engine memoizes pair distances)
  gives the JAX package's graph, its distances within 2 ulp.
- The sparse kind builds on the host only: ``method="device"`` and the
  serving-only native build raise, as in the JAX package.
"""

import functools

import numpy as np
import pytest
import torch

from pgvector_rx_tpu.config import SearchParams as JSearchParams
from pgvector_rx_tpu.index import access_method as jam
from pgvector_rx_tpu.index.flat import FlatIndex as JFlat
from pgvector_rx_tpu.index.hnsw import HnswIndex as JaxIndex
from pgvector_rx_tpu.types import SparseVec as JSparseVec
from pgvector_rx_tpu_torch import HnswIndex, SearchParams
from pgvector_rx_tpu_torch.data import make_sparse_dataset
from pgvector_rx_tpu_torch.graph import device as tdev
from pgvector_rx_tpu_torch.index import access_method
from pgvector_rx_tpu_torch.index.flat import FlatIndex
from pgvector_rx_tpu_torch.types import SparseVec

from test_index import brute_force, recall_at_k

torch.set_num_threads(1)

CPU = dict(device="cpu")
METRICS = ("l2", "ip", "cosine", "l1")
K, EF = 10, 40


def _jax_rows(rows):
    return [JSparseVec(r.dim, r.indices, r.values) for r in rows]


@functools.lru_cache(maxsize=None)
def _data():
    """bench_suite's sparse data at a small size: 1,200 rows of 16 draws
    over 2,000 dimensions; the first 40 rows are the queries."""
    return make_sparse_dataset(1200, 2000, 40, 16, seed=9)


@functools.lru_cache(maxsize=None)
def _jax_index(metric):
    rows, _ = _data()
    return JaxIndex.build(_jax_rows(rows), metric=metric, method="native",
                          seed=1)


def _scale(metric, rows):
    if metric == "cosine":
        return 2.0
    if metric == "l1":
        return 2.0 * max(float(np.abs(r.values).sum()) for r in rows)
    return 2.0 * max(float((r.values * r.values).sum()) for r in rows)


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


def _order(metric, d):
    """Operator distances -> order distances (l2 comes back as its root)."""
    return d ** 2 if metric == "l2" else d


@pytest.mark.parametrize("metric", METRICS)
def test_engines_on_a_jax_checkpoint_give_jax_ids(metric, tmp_path):
    j = _jax_index(metric)
    j.save(tmp_path / "ck")
    t = HnswIndex.load(tmp_path / "ck", **CPU)
    rows, queries = _data()
    g = t.device_graph()
    assert g.kind == "sparse" and g.cap == len(j.elements)
    assert g.sp_indices.shape == (g.cap + 1, t.store.budget)
    assert (g.sp_indices[g.cap] == 2**31 - 1).all()
    tol = 1e-5 * _scale(metric, rows)
    for method in ("exact", "approx", "device"):
        jd, ji = j.search(_jax_rows(queries), K, JSearchParams(ef_search=EF),
                          method=method)
        td, ti = t.search(queries, K, SearchParams(ef_search=EF),
                          method=method)
        assert (ti >= 0).all()
        _equal_but_ties(ti, _order(metric, td), ji, _order(metric, jd), tol)


@pytest.mark.parametrize("metric", METRICS)
def test_search_batch_gives_jax_search_one_sparse(metric, tmp_path):
    """The port's ``_search_batch`` (the greedy descent, then the walk's
    sparse rows) on a JAX sparse graph gives JAX's ``_search_one_sparse``
    (the same descent, ``pgvector_rx_tpu/graph/device.py:1861``) over the
    ef-wide beam: ids but for ties, distances within the metric's
    tolerance."""
    import jax
    import jax.numpy as jnp

    from pgvector_rx_tpu.graph import device as jdev

    j = _jax_index(metric)
    j.save(tmp_path / "ck")
    t = HnswIndex.load(tmp_path / "ck", **CPU)
    rows, queries = _data()
    jg, tg = j.device_graph(), t.device_graph()
    assert tg.entry_level >= 1
    steps = 4 * EF + 32
    qi, qv = jdev.prepare_queries(j, _jax_rows(queries))
    jd, ji, _ = jax.vmap(lambda a, b: jdev._search_one_sparse(
        jg, (a, b), EF, steps))(jnp.asarray(qi), jnp.asarray(qv))
    tq = tdev.prepare_queries(t, queries, "cpu")
    td, ti, _ = tdev._search_batch(tg, tq, EF, tg.entry_level, steps)
    fin = np.isfinite(np.asarray(jd))
    np.testing.assert_array_equal(np.isfinite(td.numpy()), fin)
    _equal_but_ties(np.where(fin, ti.numpy(), -1), td.numpy(),
                    np.where(fin, np.asarray(ji), -1), np.asarray(jd),
                    1e-5 * _scale(metric, rows))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_checkpoints_move_both_ways(metric, tmp_path):
    rows, queries = _data()
    t = HnswIndex.build(rows[:600], metric=metric, method="native", seed=4,
                        **CPU)
    t.save(tmp_path / "port")
    j = JaxIndex.load(tmp_path / "port")
    assert j.kind == "sparse" and len(j.elements) == len(t.elements)
    back = HnswIndex.load(tmp_path / "port", **CPU)
    assert back.heap_tids == t.heap_tids
    np.testing.assert_array_equal(back.store.indices[:600],
                                  t.store.indices[:600])
    for method in ("host", "exact", "device"):
        jd, ji = j.search(_jax_rows(queries), K, JSearchParams(ef_search=EF),
                          method=method)
        td, ti = back.search(queries, K, SearchParams(ef_search=EF),
                             method=method)
        _equal_but_ties(ti, _order(metric, td), ji, _order(metric, jd),
                        1e-5 * _scale(metric, rows))
    with pytest.raises(ValueError, match="dense and bit"):
        HnswIndex.load(tmp_path / "port", serving=True, **CPU)
    with pytest.raises(ValueError, match="dense and bit"):
        JaxIndex.load(tmp_path / "port", serving=True)


def test_append_log_replays_sparse_inserts(tmp_path):
    rows, queries = _data()
    idx = HnswIndex.build(rows[:200], metric="l2", method="native", seed=2,
                          **CPU)
    idx.save(tmp_path / "ck")
    idx.enable_log(tmp_path / "ck" / "log.jsonl")
    for i, r in enumerate(rows[200:210]):
        idx.insert(r if i % 2 else (r.indices, r.values), tid=1000 + i)
    idx.delete([3, 1005])
    idx._log.close()
    back = HnswIndex.load(tmp_path / "ck", **CPU)
    assert back.num_tuples == idx.num_tuples == 208
    for method in ("host", "exact"):
        d1, t1 = idx.search(queries, K, method=method)
        d2, t2 = back.search(queries, K, method=method)
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_allclose(d1, d2, rtol=1e-6)
    j = JaxIndex.load(tmp_path / "ck")  # the JAX package replays it too
    np.testing.assert_array_equal(
        j.search(_jax_rows(queries), K, JSearchParams(), method="host")[1],
        back.search(queries, K, method="host")[1])


@pytest.mark.parametrize("metric", METRICS)
def test_flat_index_equals_jax(metric):
    rows, queries = _data()
    rows = rows[:500] + [SparseVec(2000, [], [])]  # an empty row
    jf = JFlat.build(_jax_rows(rows), metric=metric, kind="sparse")
    tf = FlatIndex.build(rows, metric=metric, kind="sparse", **CPU)
    assert tf.num_tuples == 501
    jd, ji = jf.search(_jax_rows(queries), K)
    td, ti = tf.search(queries, K)
    _equal_but_ties(ti, _order(metric, td), ji, _order(metric, jd),
                    1e-5 * _scale(metric, rows))
    d1, i1 = tf.search(queries[5], 3)  # one query
    np.testing.assert_array_equal(i1, ti[5, :3])
    assert tf.search(queries[:2], 600)[1].shape == (2, 600)
    assert (tf.search(queries[:2], 600)[1][:, 501:] == -1).all()
    tf.delete([7])
    assert 7 not in tf.search(queries[7], K)[1]


def _t028(n, nq, seed):
    """tests/t/028's data: vector(3) rows (random()*random() coords) cast
    to sparsevec (zero coords drop), uniform queries."""
    rng = np.random.default_rng(seed)
    dense = (rng.random((n, 3)) * rng.random((n, 3))).astype(np.float32)
    qdense = rng.random((nq, 3)).astype(np.float32)

    def sv(x):
        ii = np.nonzero(x)[0].astype(np.int32)
        return SparseVec(3, ii, x[ii])

    return dense, qdense, [sv(x) for x in dense], [sv(q) for q in qdense]


@pytest.mark.parametrize("metric", METRICS)
def test_t028_small(metric):
    """tests/t/028 at 2,000 rows (10,000 in the JAX package's
    test_full_scale.py; the card runs it at full size): exact and beam
    recall@20 against the float64 top-20, floors 0.99 (ip 0.97)."""
    dense, qdense, rows, queries = _t028(2000, 20, 107)
    idx = HnswIndex.build(rows, metric=metric, seed=108, **CPU)
    gt = brute_force(dense, qdense, metric, 20)
    want = 0.97 if metric == "ip" else 0.99
    params = SearchParams(ef_search=40)
    for method in ("exact", "device"):
        _, ids = idx.search(queries, 20, params, method=method)
        assert recall_at_k(ids, gt, 20) >= want, method


@pytest.mark.parametrize("name", [n for n, oc in
                                  access_method.OPERATOR_CLASSES.items()
                                  if oc.kind == "sparse"])
def test_every_sparse_opclass_answers(name):
    """Each sparse operator class makes an index that takes rows and
    answers through the exact and beam engines, as JAX's does."""
    rows, queries = _data()
    out = []
    for mod, kw, rr in ((access_method, CPU, rows[:30]),
                        (jam, {}, _jax_rows(rows[:30]))):
        idx = mod.create_index_for_opclass(name, 2000, **kw)
        assert idx.kind == "sparse"
        idx.add_batch(rr)
        out.append([idx.search(rr[:4], 3, method=m)
                    for m in ("exact", "device")])
    metric = access_method.OPERATOR_CLASSES[name].metric
    (td, ti), (tbd, tbi) = out[0]
    (jd, ji), (jbd, jbi) = out[1]
    np.testing.assert_array_equal(ti[:, 0], np.arange(4))  # exact top-1
    # l2: compare squares, where the f32 cancellation is absolute
    tol = 1e-5 * _scale(metric, rows[:30])
    _equal_but_ties(ti, _order(metric, td), ji, _order(metric, jd), tol)
    assert (tbi >= 0).all()  # the beam answers, on the same host graph
    _equal_but_ties(tbi, _order(metric, tbd), jbi, _order(metric, jbd), tol)


@pytest.mark.parametrize("metric", METRICS)
def test_native_build_gives_the_jax_package_graph(metric):
    """The port's native engine memoizes sparse pair distances during the
    build; the graph (every layer's ids, and its distances within 2 ulp)
    and the entry stay the JAX package's, whose engine has no memo."""
    rows, _ = _data()
    j = _jax_index(metric)
    t = HnswIndex.build(rows, metric=metric, method="native", seed=1, **CPU)
    assert t.entry == j.entry and t.heap_tids == j.heap_tids
    for te, je in zip(t.elements, j.elements):
        assert te.level == je.level
        assert len(te.neighbors) == len(je.neighbors)
        for tl, jl in zip(te.neighbors, je.neighbors):
            assert [i for _, i in tl] == [i for _, i in jl]
            # the JAX package's committed binary and the port's build on
            # this host may sum a distance in another order (-ffast-math)
            np.testing.assert_array_max_ulp(
                np.array([d for d, _ in tl], np.float32),
                np.array([d for d, _ in jl], np.float32), maxulp=2)


def test_sparse_builds_on_the_host_only():
    rows, queries = _data()
    with pytest.raises(ValueError, match="method='native' or 'host'"):
        HnswIndex.build(rows[:50], method="device", **CPU)
    with pytest.raises(ValueError, match="serving-only native build"):
        HnswIndex.build(rows[:50], method="native", host_graph=False, **CPU)
    idx = HnswIndex.build(rows[:50], seed=1, **CPU)  # auto: native
    assert idx.kind == "sparse" and len(idx.elements) == 50
    with pytest.raises(ValueError, match="sparse kind serves through"):
        tdev.serve_topk(idx, queries, K)


def test_auto_engine_cuts_over_at_the_sparse_limit(monkeypatch):
    rows, queries = _data()
    idx = HnswIndex.build(rows[:200], seed=1, **CPU)
    used = []
    sweep = tdev._exact_search_sparse
    monkeypatch.setattr(tdev, "_exact_search_sparse", lambda *a, **kw: (
        used.append(True), sweep(*a, **kw))[1])
    tdev.search(idx, queries[:4], K, SearchParams())
    assert used == [True]
    monkeypatch.setattr(tdev, "SPARSE_EXACT_MAX_ROWS", 199)
    d, ids = tdev.search(idx, queries[:4], K, SearchParams())
    assert used == [True] and (ids >= 0).all()
