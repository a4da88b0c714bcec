"""l1 serving in the port (pgvector_rx_tpu_torch/graph/device.py: the l1
sweep ``l1_sweep_topk``, its rescore and coarse seeds) against the JAX
package, on the very same graph: a JAX host-graph index with deleted rows
is flattened once and carried into the port through
``DeviceGraph.from_numpy``. Exact and approx ``search`` / ``serve_topk``,
the beam engine and ``DeviceScan`` must return the JAX package's ids but
for ties. The card-only case holds the sweep on the card to a float64
top-k."""

import functools

import numpy as np
import pytest
import torch

from pgvector_rx_tpu.config import SearchParams as JSearchParams
from pgvector_rx_tpu.graph import device as jdev
from pgvector_rx_tpu.index.hnsw import HnswIndex as JaxIndex
from pgvector_rx_tpu_torch import HnswIndex as TorchIndex
from pgvector_rx_tpu_torch.config import IndexParams as TIndexParams
from pgvector_rx_tpu_torch.config import SearchParams as TSearchParams
from pgvector_rx_tpu_torch.data import make_dataset
from pgvector_rx_tpu_torch.graph import device as tdev

torch.set_num_threads(1)

N, DIM, NQ, K = 3000, 16, 64, 10
_FIELDS = ("neighbors0", "upper_neighbors", "upper_slot", "levels",
           "traversable", "emit_tid", "tid_count", "values", "x2",
           "values_bf16")


@functools.lru_cache(maxsize=None)
def _pair():
    """(JAX index, port index serving its graph, queries, deleted tids)."""
    data, queries = make_dataset(N, DIM, NQ, seed=41, n_clusters=30)
    j = JaxIndex.build(data, metric="l1", method="native", seed=5)
    dead = list(range(0, N, 97))
    j.delete(dead)
    jg = j.device_graph()
    t = TorchIndex(DIM, metric="l1", params=TIndexParams(), device="cpu")
    t.serving_only = True
    t.entry = j.entry
    t.heap_tids = [list(x) for x in j.heap_tids]
    t.store.bulk_load(j.store.rows[: j.store.count])
    t._device = tdev.DeviceGraph.from_numpy(
        {f: np.asarray(getattr(jg, f)) for f in _FIELDS},
        kind=jg.kind, metric=jg.metric, cap=jg.cap, m=jg.m, entry=jg.entry,
        entry_level=jg.entry_level, device="cpu",
    )
    return j, t, queries, set(dead)


def _same_but_ties(ids_a, d_a, ids_b, d_b, atol=1e-4):
    """Per row, ids in one list and not the other tie (within atol) with
    the other's k-th distance; distances agree rank by rank."""
    np.testing.assert_allclose(d_a, d_b, rtol=1e-5, atol=atol)
    for r in range(ids_a.shape[0]):
        sa, sb = set(ids_a[r].tolist()), set(ids_b[r].tolist())
        da = dict(zip(ids_a[r].tolist(), d_a[r].tolist()))
        db = dict(zip(ids_b[r].tolist(), d_b[r].tolist()))
        assert all(abs(da[i] - d_b[r, -1]) <= atol for i in sa - sb), r
        assert all(abs(db[i] - d_a[r, -1]) <= atol for i in sb - sa), r


@pytest.mark.parametrize("engine", ["exact", "approx", "beam"])
def test_serve_topk_matches_jax(engine):
    j, t, q, _ = _pair()
    jd, ji = jdev.serve_topk(j, q, K, engine=engine, ef=40)
    td, ti = tdev.serve_topk(t, q, K, engine=engine, ef=40)
    _same_but_ties(ti, td, np.asarray(ji), np.asarray(jd))


@pytest.mark.parametrize("chunk", [1 << 16, 256])
def test_exact_engine_orders_ties_as_jax(chunk, monkeypatch):
    """Fault 3d: on integer rows, where l1 distances tie as a rule, the
    exact engine returns JAX's ids in JAX's order (``lax.top_k``: the lower
    row first), also when the sweep merges several blocks."""
    rng = np.random.default_rng(43)
    data = rng.integers(-2, 3, (1200, 6)).astype(np.float32)
    queries = rng.integers(-2, 3, (24, 6)).astype(np.float32)
    j = JaxIndex.build(data, metric="l1", method="native", seed=6,
                       host_graph=False)
    jg = j.device_graph()
    t = TorchIndex(6, metric="l1", params=TIndexParams(), device="cpu")
    t.serving_only, t.entry = True, j.entry
    t.heap_tids = [list(x) for x in j.heap_tids]
    t._device = tdev.DeviceGraph.from_numpy(
        {f: np.asarray(getattr(jg, f)) for f in _FIELDS},
        kind=jg.kind, metric=jg.metric, cap=jg.cap, m=jg.m, entry=jg.entry,
        entry_level=jg.entry_level, device="cpu")
    monkeypatch.setattr(tdev, "_L1_CHUNK", chunk)
    jd, ji = jdev.serve_topk(j, queries, 15, engine="exact")
    td, ti = tdev.serve_topk(t, queries, 15, engine="exact")
    assert (np.diff(np.asarray(jd), axis=1) == 0).any()  # ties inside
    np.testing.assert_array_equal(td, np.asarray(jd))
    np.testing.assert_array_equal(ti, np.asarray(ji))


def test_coarse_seeds_rank_by_l1():
    """The beam engine's coarse seeds are the 8 upper rows nearest in l1
    over the bf16 copy of the rows (the JAX package's
    ``_exact_scores(approx=True)`` for l1), with exact f32 distances."""
    _, t, q, _ = _pair()
    g = t.device_graph()
    up_ids, up_rows = tdev._coarse_upper(g)
    s_ids, s_d = tdev._coarse_seeds(g, torch.from_numpy(q), up_ids, up_rows,
                                    8)
    rows = up_rows.float().double().numpy()
    ref = np.abs(q.astype(np.float64)[:, None, :] - rows[None]).sum(-1)
    ref[:, ~g.traversable[up_ids].numpy()] = np.inf
    slot = np.argsort(ref, axis=1, kind="stable")[:, :8]
    col = {int(e): c for c, e in enumerate(up_ids.tolist())}
    got = s_ids.numpy()
    got_ref = np.array([[ref[b, col[int(e)]] for e in got[b]]
                        for b in range(len(q))])
    _same_but_ties(got, got_ref, up_ids.numpy()[slot],
                   np.take_along_axis(ref, slot, 1), atol=1e-3)
    exact = np.abs(q[:, None, :].astype(np.float64)
                   - g.values.double().numpy()[got]).sum(-1)
    np.testing.assert_allclose(s_d.numpy(), exact, rtol=1e-5)


def test_exact_serve_topk_is_the_float64_top_k():
    """The l1 sweep over the live rows is the exact top-k: held to numpy
    float64 on the rows, dead rows excluded."""
    j, t, q, dead = _pair()
    rows = j.store.rows[:N].astype(np.float64)
    ref = np.abs(q.astype(np.float64)[:, None, :] - rows[None]).sum(-1)
    ref[:, sorted(dead)] = np.inf
    ref_i = np.argsort(ref, axis=1, kind="stable")[:, :K]
    td, ti = tdev.serve_topk(t, q, K, engine="exact")
    _same_but_ties(ti, td, ref_i, np.take_along_axis(ref, ref_i, 1))
    assert not set(ti.ravel().tolist()) & dead


@pytest.mark.parametrize("method", ["exact", "approx", "device"])
@pytest.mark.parametrize("masked", [False, True])
def test_search_matches_jax(method, masked):
    j, t, q, dead = _pair()
    mask = (np.arange(N) % 3 == 0) if masked else None
    jd, ji = j.search(q, K, JSearchParams(ef_search=40), method=method,
                      filter_mask=mask)
    td, ti = t.search(q, K, TSearchParams(ef_search=40), method=method,
                      filter_mask=mask)
    _same_but_ties(ti, td, ji, jd)
    got = set(ti[ti >= 0].tolist())
    assert not got & dead
    if masked:
        assert all(i % 3 == 0 for i in got)


def test_device_scan_matches_jax():
    """DeviceScan's exact blocks (40, then 160 rows) go through the l1
    sweep: the same stream as the JAX package's, tuple by tuple but for
    ties."""
    j, t, q, dead = _pair()
    for b in range(4):
        js = j.scan(q[b], JSearchParams(ef_search=40), method="device")
        ts = t.scan(q[b], TSearchParams(ef_search=40), method="device")
        jo, to = js.take(100), ts.take(100)
        jt, jdd = np.array([[x for x, _ in jo]]), np.array([[d for _, d in jo]])
        tt, tdd = np.array([[x for x, _ in to]]), np.array([[d for _, d in to]])
        _same_but_ties(tt, tdd, jt, jdd)
        assert not set(tt.ravel().tolist()) & dead
        assert (np.diff(tdd[0]) >= 0).all()


def test_l1_sweep_pads_and_penalises():
    """Fewer live rows than k: the tail is (inf, -1); inf rows are never
    returned."""
    x = torch.randn(40, 8)
    a = torch.full((40,), float("inf"))
    a[:3] = 0.0
    d, i = tdev.l1_sweep_topk(x, a, torch.randn(2, 8), 5)
    assert (i[:, :3] < 3).all() and torch.isinf(d[:, 3:]).all()
    d, i = tdev.l1_sweep_topk(x[:2], a[:2], torch.randn(2, 8), 5)
    assert (i[:, 2:] == -1).all() and torch.isinf(d[:, 2:]).all()


def test_l1_sweep_merges_its_blocks(monkeypatch):
    """Blocks smaller than the corpus merge into the same top-k."""
    g = torch.Generator().manual_seed(3)
    x, q = torch.randn(1000, 12, generator=g), torch.randn(7, 12, generator=g)
    a = torch.zeros(1000)
    d1, i1 = tdev.l1_sweep_topk(x, a, q, 20)
    monkeypatch.setattr(tdev, "_L1_CHUNK", 64)
    d2, i2 = tdev.l1_sweep_topk(x, a, q, 20)
    torch.testing.assert_close(d1, d2)
    assert torch.equal(i1, i2)


@pytest.mark.cuda
def test_l1_sweep_on_the_card_is_the_float64_top_k():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    g = torch.Generator().manual_seed(7)
    x = torch.randn(100_000, 128, generator=g)
    q = torch.randn(256, 128, generator=g)
    a = torch.zeros(100_000)
    a[::11] = float("inf")
    d, i = tdev.l1_sweep_topk(x.cuda(), a.cuda(), q.cuda(), 64)
    ref = torch.cdist(q.double(), x.double(), p=1) + a.double()[None, :]
    rd, ri = torch.topk(ref, 64, dim=1, largest=False)
    _same_but_ties(i.cpu().numpy(), d.cpu().double().numpy(), ri.numpy(),
                   rd.numpy(), atol=1e-3)
    assert (i.cpu() % 11 != 0).all()
