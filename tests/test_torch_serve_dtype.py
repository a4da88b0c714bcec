"""The compact serve stores and the sweeps' distance values in the port,
against the JAX package on the same data (the port's versions of
tests/test_serve_dtype.py::TestServeDtype, whose sharded case is in
tests/test_torch_sharded.py, and of tests/test_serve_distances.py).

- A halfvec index keeps one f16 value array, ``PGV_SERVE_DTYPE=bf16`` one
  bf16 array, equal to JAX's; the engines score the stored (rounded)
  values in f32, as JAX does, and return JAX's ids and distances.
- Stores that are not f32 sweep in chunks of ``_EXACT_SWEEP_CHUNK`` rows
  (JAX's rule): with the chunk patched small in both packages, exact and
  approx give the single call's result and JAX's.
- The sweeps restore true operator distances per metric (float64 brute
  force), the l1 sweep past one block included, and deleted rows never
  surface.
- Tests marked ``cuda`` hold K1 and K2 over f16 / bf16 chunks against the
  plain sweep on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvector_rx_tpu.config import SearchParams as JSearchParams
from pgvector_rx_tpu.graph import device as jdev
from pgvector_rx_tpu.index.hnsw import HnswIndex as JaxIndex
from pgvector_rx_tpu_torch import HnswIndex
from pgvector_rx_tpu_torch.config import SearchParams
from pgvector_rx_tpu_torch.graph import device as tdev

from test_index import brute_force, recall_at_k

torch.set_num_threads(1)

CPU = dict(device="cpu")


def _np(t):
    return t.float().numpy()


def _mem_bytes(g):
    return sum(a.numel() * a.element_size()
               for a in (g.values, g.values_bf16) if a is not None)


def _same_as_jax(t, j, q, k, method, params=None, rtol=1e-5):
    """The port's ``search`` gives JAX's ids and distances (within rtol:
    f32 sums in another order)."""
    td, ti = t.search(q, k, params or SearchParams(), method=method)
    jd, ji = j.search(q, k, JSearchParams(
        ef_search=(params or SearchParams()).ef_search), method=method)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=rtol, atol=1e-6)
    return td, ti


class TestServeDtype:
    def test_halfvec_stores_one_f16_array(self, rng):
        data = rng.standard_normal((500, 16)).astype(np.float32)
        idx = HnswIndex.build(data, metric="l2", method="host",
                              dtype=np.float16, seed=40, **CPU)
        g = idx.device_graph()
        assert g.values.dtype == torch.float16
        assert g.values_bf16 is None
        idx32 = HnswIndex.build(data, metric="l2", method="host", seed=40,
                                **CPU)
        assert _mem_bytes(g) * 2 < _mem_bytes(idx32.device_graph())
        j = JaxIndex.build(data, metric="l2", method="host",
                           dtype=np.float16, seed=40)
        jg = j.device_graph()
        np.testing.assert_array_equal(_np(g.values),
                                      np.asarray(jg.values, np.float32))
        np.testing.assert_allclose(g.x2.numpy(), np.asarray(jg.x2),
                                   rtol=1e-6)

    def test_halfvec_distances_match_f16_stored_semantics(self, rng):
        data = rng.standard_normal((400, 12)).astype(np.float32)
        idx = HnswIndex.build(data, metric="l2", method="host",
                              dtype=np.float16, seed=41, **CPU)
        j = JaxIndex.build(data, metric="l2", method="host",
                           dtype=np.float16, seed=41)
        q = rng.standard_normal((8, 12)).astype(np.float32)
        d, ids = _same_as_jax(idx, j, q, 5, "exact")
        stored = data.astype(np.float16).astype(np.float32)
        for b in range(8):
            for c in range(5):
                true = np.sqrt(((stored[ids[b, c]] - q[b]) ** 2).sum())
                assert d[b, c] == pytest.approx(true, rel=1e-4)
        assert recall_at_k(ids, brute_force(stored, q, "l2", 5), 5) == 1.0

    def test_halfvec_device_build_compact(self, rng):
        data = rng.standard_normal((2000, 16)).astype(np.float32)
        idx = HnswIndex.build(data, metric="l2", method="device",
                              dtype=np.float16, host_graph=False, seed=42,
                              **CPU)
        g = idx.device_graph()
        assert g.values.dtype == torch.float16
        assert g.values_bf16 is None
        j = JaxIndex.build(data, metric="l2", method="device",
                           dtype=np.float16, host_graph=False, seed=42)
        q = rng.standard_normal((8, 16)).astype(np.float32)
        stored = data.astype(np.float16).astype(np.float32)
        gt = brute_force(stored, q, "l2", 5)
        _, ids = _same_as_jax(idx, j, q, 5, "exact")
        assert recall_at_k(ids, gt, 5) == 1.0
        # approx + beam engines serve from the compact store too, at JAX's
        # recall
        for method, params in (("approx", None),
                               ("device", SearchParams(ef_search=40))):
            _, ids_t = idx.search(q, 5, params or SearchParams(),
                                  method=method)
            _, ids_j = j.search(q, 5, JSearchParams(ef_search=40),
                                method=method)
            assert recall_at_k(ids_t, gt, 5) >= 0.9
            assert recall_at_k(ids_t, gt, 5) >= recall_at_k(ids_j, gt, 5) - 0.1

    def test_bf16_compact_opt_in(self, rng, monkeypatch):
        monkeypatch.setenv("PGV_SERVE_DTYPE", "bf16")
        data = rng.standard_normal((600, 16)).astype(np.float32)
        idx = HnswIndex.build(data, metric="l2", method="host", seed=43,
                              **CPU)
        g = idx.device_graph()
        assert g.values.dtype == torch.bfloat16
        assert g.values_bf16 is None
        j = JaxIndex.build(data, metric="l2", method="host", seed=43)
        np.testing.assert_array_equal(
            _np(g.values), np.asarray(j.device_graph().values, np.float32))
        q = rng.standard_normal((6, 16)).astype(np.float32)
        stored = _np(torch.from_numpy(data).to(torch.bfloat16))
        gt = brute_force(stored, q, "l2", 5)
        _, ids = _same_as_jax(idx, j, q, 5, "exact")
        assert recall_at_k(ids, gt, 5) >= 0.95  # bf16 rounding ties


@pytest.fixture
def small_chunk(monkeypatch):
    """``_EXACT_SWEEP_CHUNK`` at 256 rows in both packages (JAX reads it
    while tracing, so its caches are cleared before and after)."""
    jax.clear_caches()
    for mod in (jdev, tdev):
        monkeypatch.setattr(mod, "_EXACT_SWEEP_CHUNK", 256)
    yield 256
    jax.clear_caches()


@functools.lru_cache(maxsize=None)
def _compact_pair(dtype, metric):
    """(port index, JAX index, queries): both native builds of one 2,100 x
    24 corpus in a compact store (f16, or bf16 by ``PGV_SERVE_DTYPE``),
    shared by the exact and approx cases (neither changes them)."""
    rng = np.random.default_rng(7)
    data = rng.standard_normal((2100, 24)).astype(np.float32)
    q = rng.standard_normal((16, 24)).astype(np.float32)
    kw = dict(dtype=np.float16) if dtype == "f16" else {}
    with pytest.MonkeyPatch.context() as mp:
        if dtype == "bf16":
            mp.setenv("PGV_SERVE_DTYPE", "bf16")
        t = HnswIndex.build(data, metric=metric, method="native",
                            host_graph=False, seed=3, **kw, **CPU)
        j = JaxIndex.build(data, metric=metric, method="native",
                           host_graph=False, seed=3, **kw)
        t.device_graph(), j.device_graph()  # staged in that store
    return t, j, q


@pytest.mark.parametrize("dtype,metric", [("f16", "l2"), ("f16", "ip"),
                                          ("bf16", "cosine")])
@pytest.mark.parametrize("engine", ["exact", "approx"])
def test_chunked_sweep_equals_the_single_call(dtype, metric, engine,
                                              monkeypatch, small_chunk):
    """A 2,100-row compact store swept in chunks of 256 rows (9 chunks, the
    last one short) gives the single call's distances and ids and JAX's
    chunked sweep's; rows a filter excludes stay out."""
    if dtype == "bf16":
        monkeypatch.setenv("PGV_SERVE_DTYPE", "bf16")
    t, j, q = _compact_pair(dtype, metric)
    keep = np.ones(2100, bool)
    keep[[5, 300, 1999]] = False
    g = t.device_graph()
    assert g.values.dtype != torch.float32
    assert tdev._sweep_chunk_rows(g.values.shape[0], len(q)) == 256
    qt = tdev.prepare_queries(t, q, "cpu")
    mask = tdev._stage_filter_mask(g, keep)
    approx = engine == "approx"
    cd, ci = tdev._exact_search_batch(g, qt, 10, approx, row_mask=mask)
    monkeypatch.setattr(tdev, "_EXACT_SWEEP_CHUNK", 1 << 18)
    sd, si = tdev._exact_search_batch(g, qt, 10, approx, row_mask=mask)
    ex = tdev._exact_search_batch(g, qt, 10, row_mask=mask)[1].numpy()
    if approx:  # K2 bins rows by row mod 1,024 within each call: another
        # approximation than the single call's, as good
        assert recall_at_k(ci.numpy(), ex, 10) >= recall_at_k(
            si.numpy(), ex, 10) - 0.02
    else:
        np.testing.assert_array_equal(ci.numpy(), si.numpy())
        np.testing.assert_allclose(cd.numpy(), sd.numpy(), rtol=1e-6)
    assert keep[ci.numpy()].all()
    jd, ji = jdev.serve_topk(j, jdev.prepare_queries(j, q), 10,
                             engine=engine, chunk=16, filter_mask=keep)
    if engine == "exact":
        np.testing.assert_array_equal(ci.numpy(), np.asarray(ji))
    else:  # JAX selects each chunk with approx_min_k, the port with K2's
        # bins: recall against the exact order, not ids
        assert recall_at_k(ci.numpy(), ex, 10) >= recall_at_k(
            np.asarray(ji), ex, 10) - 0.02
    np.testing.assert_allclose(
        np.sort(cd.numpy(), 1)[:, 0], np.sort(np.asarray(jd), 1)[:, 0],
        rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# tests/test_serve_distances.py
# ---------------------------------------------------------------------------


def _dist_matrix(data, queries, metric):
    d = data.astype(np.float64)
    q = queries.astype(np.float64)
    if metric == "l2":
        return ((q[:, None, :] - d[None, :, :]) ** 2).sum(-1)
    if metric == "ip":
        return -(q @ d.T)
    if metric == "cosine":
        dn = d / np.linalg.norm(d, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        return 1.0 - qn @ dn.T
    return np.abs(q[:, None, :] - d[None, :, :]).sum(-1)  # l1


def _build(metric, n=600, dim=8, seed=11, method="host"):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((n, dim)).astype(np.float32)
    kw = dict(method=method, seed=seed)
    if method == "native":
        kw["host_graph"] = False
    t = HnswIndex.build(data, metric=metric, **kw, **CPU)
    j = JaxIndex.build(data, metric=metric, **kw)
    queries = rng.standard_normal((8, dim)).astype(np.float32)
    return t, j, data, queries


@pytest.fixture(scope="module")
def built():
    """``_build(metric)`` once per metric for the module: its exact and
    approx cases search the same pair of host-built indexes."""
    return functools.lru_cache(maxsize=None)(_build)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine", "l1"])
@pytest.mark.parametrize("engine", ["exact", "approx"])
def test_device_sweep_true_distances(built, metric, engine):
    t, j, data, queries = built(metric)
    gt = brute_force(data, queries, metric, 5)
    d, ids = t.search(queries, 5, SearchParams(ef_search=40), method=engine)
    jd, ji = j.search(queries, 5, JSearchParams(ef_search=40), method=engine)
    if engine == "exact":
        assert recall_at_k(ids, gt, 5) == 1.0
        np.testing.assert_array_equal(ids, ji)
    else:
        assert recall_at_k(ids, gt, 5) >= recall_at_k(ji, gt, 5) - 0.05
    ref = _dist_matrix(data, queries, metric)
    for b in range(len(queries)):
        for c in range(5):
            true = ref[b, ids[b, c]]
            if metric == "l2":  # operator domain: true euclidean
                true = np.sqrt(max(true, 0.0))
            assert d[b, c] == pytest.approx(true, rel=1e-4, abs=1e-5)


def test_l1_chunked_path_distances(monkeypatch):
    """l1 past one block of its sweep (the block patched to 512 rows, so
    2,100 rows take 5 blocks and the merge): the float64 distances and
    JAX's ids (JAX chunks l1 above 2,048 rows)."""
    monkeypatch.setattr(tdev, "_L1_CHUNK", 512)
    t, j, data, queries = _build("l1", n=2100, dim=4, seed=3,
                                 method="native")
    d, ids = t.search(queries, 5, method="exact")
    ref = _dist_matrix(data, queries, "l1")
    for b in range(len(queries)):
        for c in range(5):
            assert d[b, c] == pytest.approx(ref[b, ids[b, c]], rel=1e-4,
                                            abs=1e-5)
    assert recall_at_k(ids, brute_force(data, queries, "l1", 5), 5) == 1.0
    np.testing.assert_array_equal(ids, j.search(queries, 5,
                                                method="exact")[1])


def test_cosine_deleted_rows_stay_hidden():
    # an inf dead-row sentinel must survive the cosine restore (not become
    # a finite 2.0), so deleted elements never surface
    t, j, data, _ = _build("cosine", n=40, dim=6, seed=5)
    q = data[7:8]
    keep = {2, 9, 17}
    for idx in (t, j):
        idx.delete([r for r in range(40) if r not in keep])
        idx.vacuum()
    d, ids = t.search(q, 10, method="exact")
    assert {int(r) for r in ids[0] if r >= 0} == keep
    pad = ids[0] < 0
    assert pad.sum() == 7
    assert np.all(np.isinf(d[0][pad]))
    assert np.all(d[0][~pad] < 2.0 + 1e-6)
    np.testing.assert_array_equal(ids, j.search(q, 10, method="exact")[1])


# ---------------------------------------------------------------------------
# K1 and K2 over compact chunks, on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("approx", [False, True])
def test_compact_chunks_on_the_card_match_plain(cuda, dtype, approx,
                                                monkeypatch):
    """A compact store on the card swept in chunks of 8,192 rows (K1 or K2
    per chunk) equals the same graph's sweep on the CPU (the plain
    versions), ids but for ties, distances within rtol 1e-5; the chunks'
    kernels launched."""
    from pgvector_rx_tpu_torch.ops import bruteforce as tbf

    rng = np.random.default_rng(1)
    data = rng.standard_normal((50_000, 64)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    monkeypatch.setenv("PGV_SERVE_DTYPE", "f16" if dtype == torch.float16
                       else "bf16")
    t = HnswIndex.build(data, metric="l2", method="native",
                        host_graph=False, seed=1, device=cuda)
    g = t.device_graph()
    assert g.values.dtype == dtype
    monkeypatch.setattr(tdev, "_EXACT_SWEEP_CHUNK", 8192)
    name = "k2_binned" if approx else "k1_topk"
    before = tbf.LAUNCHES[name]
    kd, ki = tdev._exact_search_batch(g, q.to(cuda), 10, approx=approx)
    assert tbf.LAUNCHES[name] - before == -(-g.values.shape[0] // 8192)
    gc = tdev.DeviceGraph.from_numpy(
        {f: getattr(g, f) for f in ("neighbors0", "upper_neighbors",
                                    "upper_slot", "levels", "traversable",
                                    "emit_tid", "tid_count", "values",
                                    "x2")},
        kind="dense", metric="l2", cap=g.cap, m=g.m, entry=g.entry,
        entry_level=g.entry_level, device="cpu")
    pd, pi = tdev._exact_search_batch(gc, q, 10, approx=approx)
    kd, ki = kd.cpu().numpy(), ki.cpu().numpy()
    np.testing.assert_allclose(kd, pd.numpy(), rtol=1e-5, atol=1e-5)
    same = (ki == pi.numpy()).all(1).mean()
    assert same >= 0.95, same
