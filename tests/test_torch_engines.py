"""The port's serving engines against the JAX package's, on the very same
graph: the JAX index's DeviceGraph is carried into the port with
``DeviceGraph.from_numpy``, and both packages serve the same queries."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvector_rx_tpu.config import SearchParams
from pgvector_rx_tpu.graph import device as jdev
from pgvector_rx_tpu.index.hnsw import HnswIndex as JaxIndex
from pgvector_rx_tpu_torch import HnswIndex as TorchIndex
from pgvector_rx_tpu_torch.config import IndexParams as TIndexParams
from pgvector_rx_tpu_torch.config import SearchParams as TSearchParams
from pgvector_rx_tpu_torch.data import make_dataset
from pgvector_rx_tpu_torch.graph import device as tdev

torch.set_num_threads(1)

N, DIM, NQ, K = 3000, 32, 64, 10
_FIELDS = ("neighbors0", "upper_neighbors", "upper_slot", "levels",
           "traversable", "emit_tid", "tid_count", "values", "x2",
           "values_bf16")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _carry(j, device="cpu"):
    """A port index serving the JAX index's graph (same arrays)."""
    jg = j.device_graph()
    t = TorchIndex(j.dim, metric=j.metric, device=device,
                   params=TIndexParams(m=j.params.m,
                                       ef_construction=j.params.ef_construction))
    t.serving_only = True
    t.entry = j.entry
    t.heap_tids = list(j.heap_tids)
    t._device = tdev.DeviceGraph.from_numpy(
        {f: np.asarray(getattr(jg, f)) for f in _FIELDS},
        kind=jg.kind, metric=jg.metric, cap=jg.cap, m=jg.m, entry=jg.entry,
        entry_level=jg.entry_level, device=device,
    )
    return t


@pytest.fixture(scope="module", params=["l2", "cosine"])
def pair(request):
    data, queries = make_dataset(N, DIM, NQ, seed=5, n_clusters=50)
    if request.param == "cosine":
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    j = JaxIndex.build(data, metric=request.param, method="native",
                       host_graph=False, seed=1)
    return j, _carry(j), queries


def _serve(idx_j, idx_t, queries, engine):
    jd, ji = jdev.serve_topk(idx_j, jnp.asarray(queries), K, engine=engine,
                             chunk=NQ)
    td, ti = tdev.serve_topk(idx_t, queries, K, engine=engine, chunk=32)
    return np.asarray(jd), np.asarray(ji), td, ti


def _recall(ids, ref):
    return float(np.mean([len(set(ids[b]) & set(ref[b])) / K
                          for b in range(len(ref))]))


def _assert_same_except_ties(ti, td, ji, jd, rtol):
    for r in range(len(ji)):
        st, sj = set(ti[r].tolist()), set(ji[r].tolist())
        if st != sj:  # only a tie at the k-th distance may differ
            np.testing.assert_allclose(td[r, -1], jd[r, -1], rtol=rtol)


def test_exact_matches_jax(pair):
    j, t, q = pair
    jd, ji, td, ti = _serve(j, t, q, "exact")
    _assert_same_except_ties(ti, td, ji, jd, rtol=1e-5)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [61, 64, 65, 160, N])
def test_exact_any_k_matches_jax(pair, k):
    """Past the tensor-core form's k = 60 (on the card K1's select form,
    one sweep at any k) up to every row: the port's exact sweep returns
    the JAX package's (``_exact_search_batch``: one sweep, ``lax.top_k``)
    ids but for ties at the k-th, distances within rtol 1e-5."""
    j, t, queries = pair
    q = queries[:8]
    jd, ji = jdev._exact_search_batch(j.device_graph(), jnp.asarray(q), k)
    td, ti = tdev._exact_search_batch(t.device_graph(), torch.from_numpy(q),
                                      k)
    jd, ji, td, ti = np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()
    assert td.shape == (8, k) and (np.isfinite(td) == (ti >= 0)).all()
    assert (np.isfinite(jd) == np.isfinite(td)).all()
    _assert_same_except_ties(ti, td, ji, jd, rtol=1e-5)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)


def test_approx_recall_matches_jax(pair):
    j, t, q = pair
    _, ref, _, _ = _serve(j, t, q, "exact")
    jd, ji, td, ti = _serve(j, t, q, "approx")
    assert _recall(ti, ref) >= _recall(ji, ref) - 0.01
    # returned distances are exact f32 rescores of the returned rows
    rows = t.device_graph().values.numpy()[ti]
    if j.metric == "l2":
        want = ((rows - q[:, None, :]) ** 2).sum(-1)
    else:
        want = 1.0 - np.clip((rows * q[:, None, :]).sum(-1), -1.0, 1.0)
    np.testing.assert_allclose(td, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed_mode", ["coarse", "descent"])
def test_beam_matches_jax(pair, seed_mode, monkeypatch):
    """Same graph, same deterministic walk. Seeds come from a bf16 sweep
    (coarse) whose scores may round differently near ties in the two
    packages, so a few per-query sets may differ; recall must not."""
    j, t, q = pair
    if seed_mode == "descent":
        monkeypatch.setenv("PGV_BEAM_SEED", "descent")
    assert (tdev._coarse_upper(t.device_graph()) is None) == (
        seed_mode == "descent")
    _, ref, _, _ = _serve(j, t, q, "exact")
    jd, ji, td, ti = _serve(j, t, q, "beam")
    same = np.mean([set(ti[r].tolist()) == set(ji[r].tolist())
                    for r in range(NQ)])
    assert same >= 0.99, same
    assert abs(_recall(ti, ref) - _recall(ji, ref)) <= 0.005
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=1e-5)


def test_beam_refuses_unported_variants(pair, monkeypatch):
    """The beam's variants are ported (tests/test_torch_beam_variants.py):
    PGV_BEAM_EXPAND=4 serves JAX's result; what is refused is an invalid
    expansion."""
    j, t, q = pair
    monkeypatch.setenv("PGV_BEAM_EXPAND", "4")
    jd, ji, td, ti = _serve(j, t, q, "beam")
    same = np.mean([set(ti[r].tolist()) == set(ji[r].tolist())
                    for r in range(NQ)])
    assert same >= 0.99, same
    monkeypatch.setenv("PGV_BEAM_EXPAND", "0")
    with pytest.raises(ValueError, match="PGV_BEAM_EXPAND"):
        tdev.serve_topk(t, q, K, engine="beam")


@pytest.mark.parametrize("method", ["exact", "approx", "device"])
def test_index_search_matches_jax(pair, method):
    j, t, q = pair
    params, tparams = SearchParams(ef_search=40), TSearchParams(ef_search=40)
    jd, ji = j.search(q[:16], K, params, method=method)
    td, ti = t.search(q[:16], K, tparams, method=method)
    assert ti.dtype == np.int64 and td.dtype == np.float64
    _assert_same_except_ties(ti, td, ji, jd, rtol=1e-5)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-5)
    # single query in, single row out
    d1, i1 = t.search(q[0], K, tparams, method=method)
    assert i1.shape == (K,) and set(i1.tolist()) == set(ti[0].tolist())


@pytest.mark.parametrize("method", ["exact", "device"])
def test_index_search_filter_mask_matches_jax(pair, method):
    j, t, q = pair
    mask = np.random.default_rng(7).random(N) < 0.3
    params, tparams = SearchParams(ef_search=40), TSearchParams(ef_search=40)
    jd, ji = j.search(q[:16], K, params, method=method, filter_mask=mask)
    td, ti = t.search(q[:16], K, tparams, method=method, filter_mask=mask)
    emit = t.device_graph().emit_tid.numpy()
    allowed = set(emit[:N][mask].tolist())
    assert all(i in allowed for i in ti[ti >= 0].tolist())
    _assert_same_except_ties(ti, td, ji, jd, rtol=1e-5)
    np.testing.assert_allclose(td, jd, rtol=1e-4, atol=1e-5)


def test_serve_topk_filter_mask_prefilters(pair):
    j, t, q = pair
    mask = np.zeros(N, bool)
    mask[::3] = True
    for engine in ("exact", "approx"):
        jd, ji = jdev.serve_topk(j, jnp.asarray(q), K, engine=engine,
                                 chunk=NQ, filter_mask=mask)
        td, ti = tdev.serve_topk(t, q, K, engine=engine, filter_mask=mask)
        assert mask[ti].all()
        assert _recall(ti, np.asarray(ji)) >= 0.99


def test_host_method_uses_shared_scan(pair):
    """method="host" walks the port's copy of the reference scan on a host
    graph and agrees with the JAX package's."""
    j, t, q = pair
    data, _ = make_dataset(400, DIM, 1, seed=6)
    jh = JaxIndex.build(data, metric="l2", method="native", seed=2)
    th = TorchIndex.build(data, metric="l2", method="native", seed=2, device="cpu")
    jd, ji = jh.search(q[:4], K, SearchParams(ef_search=40), method="host")
    td, ti = th.search(torch.from_numpy(q[:4]), K, TSearchParams(ef_search=40),
                       method="host")
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd)


@pytest.mark.cuda
def test_engines_on_the_card_match_the_cpu(pair, cuda):
    """The same carried graph on the card: exact and approx run the K1 /
    K2 kernels and agree with the plain CPU engines; the beam is the
    same walk."""
    from pgvector_rx_tpu_torch.ops import bruteforce as tbf

    j, t, q = pair
    tc = _carry(j, device=cuda)
    _, ref = tdev.serve_topk(t, q, K, engine="exact")
    for engine, kernel in (("exact", "k1_topk"), ("approx", "k2_binned"),
                           ("beam", None)):
        before = dict(tbf.LAUNCHES)
        cd, ci = tdev.serve_topk(tc, q, K, engine=engine)
        pd, pi = tdev.serve_topk(t, q, K, engine=engine)
        if kernel:
            assert tbf.LAUNCHES[kernel] > before[kernel], engine
        if engine == "exact":
            _assert_same_except_ties(ci, cd, pi, pd, rtol=1e-5)
            np.testing.assert_allclose(cd, pd, rtol=1e-5, atol=1e-5)
        elif engine == "approx":
            assert _recall(ci, ref) >= _recall(pi, ref) - 0.01
        else:
            same = np.mean([set(ci[r].tolist()) == set(pi[r].tolist())
                            for r in range(NQ)])
            assert same >= 0.99, same
    td, ti = tc.search(q[:16], K, TSearchParams(ef_search=40), method="exact")
    cd, ci = t.search(q[:16], K, TSearchParams(ef_search=40), method="exact")
    _assert_same_except_ties(ti, td, ci, cd, rtol=1e-5)


def test_beam_l1_matches_jax_and_sweeps_refuse_l1():
    """l1 has no matmul identity: the beam serves it (gathered
    differences), and the exact/approx engines, which refused it before
    the l1 sweep was ported, now serve it with that sweep
    (tests/test_torch_l1.py holds them to JAX)."""
    data, queries = make_dataset(1500, 16, 32, seed=8, n_clusters=20)
    j = JaxIndex.build(data, metric="l1", method="native", host_graph=False,
                       seed=1)
    t = _carry(j)
    jd, ji = jdev.serve_topk(j, jnp.asarray(queries), K, engine="beam",
                             chunk=32)
    td, ti = tdev.serve_topk(t, queries, K, engine="beam")
    same = np.mean([set(ti[r].tolist()) == set(np.asarray(ji)[r].tolist())
                    for r in range(32)])
    assert same >= 0.99
    np.testing.assert_allclose(td, np.asarray(jd), rtol=1e-5)
    jd, ji = jdev.serve_topk(j, jnp.asarray(queries), K, engine="exact")
    td, ti = tdev.serve_topk(t, queries, K, engine="exact")
    _assert_same_except_ties(ti, td, np.asarray(ji), np.asarray(jd),
                             rtol=1e-5)
