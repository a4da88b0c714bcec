"""The port's batched device build (pgvector_rx_tpu_torch/graph/
device_build.py) against the JAX package's, on the same numpy data and
seed: the same level draws and upper-slot shuffles, so layer-0 neighbour
sets can be compared row by row, and both graphs are served by the port's
own beam engine (the JAX graph enters through ``DeviceGraph.from_numpy``),
so any recall difference belongs to the build alone.

JAX builds run on the CPU as tests/test_device_build.py runs them; tests
marked ``cuda`` build on the card.
"""

import functools

import numpy as np
import pytest
import torch

from pgvector_rx_tpu.config import IndexParams
from pgvector_rx_tpu.graph import device as jdev
from pgvector_rx_tpu.graph import device_build as jdb
from pgvector_rx_tpu.index.hnsw import HnswIndex as JaxIndex
from pgvector_rx_tpu_torch import HnswIndex as TorchIndex
from pgvector_rx_tpu_torch.config import IndexParams as TIndexParams
from pgvector_rx_tpu_torch.config import SearchParams as TSearchParams
from pgvector_rx_tpu_torch.data import make_dataset
from pgvector_rx_tpu_torch.graph import device as tdev
from pgvector_rx_tpu_torch.graph import device_build as tdb

torch.set_num_threads(1)

K, EF, NQ = 10, 40, 200
_FIELDS = ("neighbors0", "upper_neighbors", "upper_slot", "levels",
           "traversable", "emit_tid", "tid_count", "values", "x2",
           "values_bf16")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _carry(j):
    """A port index serving the JAX index's graph (same arrays)."""
    jg = j.device_graph()
    t = TorchIndex(j.dim, metric=j.metric, params=_tparams(j.params), device="cpu")
    t.serving_only = True
    t.entry = j.entry
    t.heap_tids = list(j.heap_tids)
    t._device = tdev.DeviceGraph.from_numpy(
        {f: np.asarray(getattr(jg, f)) for f in _FIELDS},
        kind=jg.kind, metric=jg.metric, cap=jg.cap, m=jg.m, entry=jg.entry,
        entry_level=jg.entry_level, device="cpu",
    )
    return t


def _tparams(params):
    """The port's IndexParams with the JAX side's values."""
    return TIndexParams(m=params.m, ef_construction=params.ef_construction)


def _both(data, metric, params, seed=3):
    j = JaxIndex.build(data, metric=metric, params=params, method="device",
                       seed=seed, host_graph=False)
    t = TorchIndex.build(data, metric=metric, params=_tparams(params),
                         method="device", seed=seed, host_graph=False, device="cpu")
    return _carry(j), t


def _queries(metric, dim, seed):
    q = np.random.default_rng(seed).standard_normal((NQ, dim))
    q = q.astype(np.float32)
    if metric == "cosine":
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q


def _overlap(ga, gb, n):
    """Mean per-row share of ga's layer-0 neighbours that gb also has."""
    na, nb = ga.neighbors0[:n].numpy(), gb.neighbors0[:n].numpy()
    return float(np.mean([
        len(set(na[i][na[i] >= 0]) & set(nb[i][nb[i] >= 0]))
        / max(1, int((na[i] >= 0).sum()))
        for i in range(n)
    ]))


def _beam_recall(idx, q, gt):
    _, ids = tdev.serve_topk(idx, q, K, engine="beam", ef=EF)
    return float(np.mean([len(set(ids[b]) & set(gt[b])) / K
                          for b in range(len(q))]))


def _check_invariants(g, m, n):
    """Degrees, no self-edges, no edge to a dead row, entry at the top
    level, cap = the row count."""
    assert g.cap == n
    nb0 = g.neighbors0.cpu().numpy()
    alive = g.traversable.cpu().numpy()
    levels = g.levels.cpu().numpy()
    up = g.upper_neighbors.cpu().numpy()
    slot = g.upper_slot.cpu().numpy()
    assert nb0.shape[1] == 2 * m and up.shape[1] % m == 0
    ids = np.arange(nb0.shape[0])
    live0 = nb0[alive]
    assert (live0 != ids[alive][:, None]).all(), "self-edge at layer 0"
    assert alive[live0[live0 >= 0]].all(), "layer-0 edge to a dead row"
    assert (nb0[~alive] == -1).all()
    assert (live0 >= 0).sum(1).min() >= 1
    for e in np.nonzero(alive & (levels >= 1))[0]:
        for lc in range(1, levels[e] + 1):
            row = up[slot[e], (lc - 1) * m: lc * m]
            row = row[row >= 0]
            assert len(row) <= m and e not in row
            assert alive[row].all() and (levels[row] >= lc).all()
    assert alive[g.entry] and levels[g.entry] == levels[alive].max()
    assert g.entry_level == levels[g.entry]


# ---------------------------------------------------------------------------
# parity with the JAX build in both candidate regimes
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX graph carried into the port, port index, queries, rows):
    "ramp" (3,000 rows, all under the exact ramp), "ivf" (6,000 rows, the
    ramp ending at 2,048 in both packages), "cosine" and "ip" (1,200
    rows)."""
    params = IndexParams(m=8, ef_construction=32)
    if name in ("cosine", "ip"):
        data, _ = make_dataset(1200, 16, 1, seed=25, n_clusters=30)
        return (*_both(data, name, params), _queries(name, 16, 26), 1200)
    n = 3000 if name == "ramp" else 6000
    data = np.random.default_rng(21).standard_normal((n, 16))
    data = data.astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        if name == "ivf":
            mp.setattr(jdb, "_DESCENT_MIN_WIDTH", 2048)
            mp.setattr(tdb, "_DESCENT_MIN_WIDTH", 2048)
        j, t = _both(data, "l2", params)
    return j, t, _queries("l2", 16, 22), n


@pytest.fixture(scope="module", params=["ramp", "ivf", "cosine", "ip"])
def pair(request):
    return _case(request.param)


@pytest.fixture(scope="module")
def ivf():
    return _case("ivf")


def test_layer0_neighbours_match_jax(pair):
    j, t, _, n = pair
    assert _overlap(j.device_graph(), t.device_graph(), n) >= 0.95


def test_beam_recall_matches_jax(pair):
    j, t, q, _ = pair
    _, gt = tdev.serve_topk(t, q, K, engine="exact")
    r_t, r_j = _beam_recall(t, q, gt), _beam_recall(j, q, gt)
    assert abs(r_t - r_j) <= 0.005, (r_t, r_j)
    assert r_t >= 0.9


def test_structural_invariants(pair):
    _, t, _, n = pair
    _check_invariants(t.device_graph(), t.params.m, n)


def test_ivf_regime_matches_jax_entry_and_levels(ivf):
    j, t, _, n = ivf
    gj, gt = j.device_graph(), t.device_graph()
    assert (gj.entry, gj.entry_level) == (gt.entry, gt.entry_level)
    np.testing.assert_array_equal(gj.levels.numpy()[:n], gt.levels.numpy()[:n])
    np.testing.assert_array_equal(gj.upper_slot.numpy()[:n],
                                  gt.upper_slot.numpy()[:n])


# ---------------------------------------------------------------------------
# semantics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("host_graph", [True, False])
def test_duplicate_folding_caps_at_10(host_graph):
    data = np.tile(np.array([[1.0, 2.0, 3.0]], dtype=np.float32), (20, 1))
    idx = TorchIndex.build(data, metric="l2", method="device",
                           host_graph=host_graph, device="cpu")
    counts = sorted((len(t) for t in idx.heap_tids if t), reverse=True)
    assert counts[0] == 10 and idx.num_tuples == 20
    if not host_graph:
        g = idx.device_graph()
        assert int(g.tid_count.max()) == 10
        assert int(g.tid_count.sum()) == 20


def test_cosine_zero_norm_row_skipped():
    data = np.array([[1, 0], [0, 0], [0, 1], [1, 1]], dtype=np.float32)
    idx = TorchIndex.build(data, metric="cosine", method="device", device="cpu")
    assert idx.num_tuples == 3
    assert 1 not in {t for tl in idx.heap_tids for t in tl}


def test_host_graph_supports_search_insert_delete():
    rng = np.random.default_rng(54)
    data = rng.random((300, 8)).astype(np.float32)
    idx = TorchIndex.build(data, metric="l2", method="device", seed=55, device="cpu")
    assert not idx.serving_only and len(idx.elements) == 300
    for e in idx.elements:
        assert len(e.neighbors[0]) <= 2 * idx.params.m
    idx.insert(rng.random(8).astype(np.float32), 999)
    idx.delete([0, 1, 2])
    _, ids = idx.search(data[5], 5, method="host")
    assert 5 in set(ids) and not ({0, 1, 2} & set(ids))
    _, ids = idx.search(data[10:50], 1, TSearchParams(ef_search=40),
                        method="device")
    assert (ids[:, 0] == np.arange(10, 50)).mean() >= 0.95


def _graph_tensors(idx):
    g = idx.device_graph()
    return {f: getattr(g, f) for f in _FIELDS if getattr(g, f) is not None}


def test_tensor_input_gives_the_numpy_graph():
    data, _ = make_dataset(600, 16, 1, seed=27, n_clusters=30)
    a = TorchIndex.build(data, metric="l2", method="device", seed=4,
                         host_graph=False, device="cpu")
    b = TorchIndex.build(torch.from_numpy(data), metric="l2", seed=4,
                         host_graph=False, device="cpu")
    ta, tb = _graph_tensors(a), _graph_tensors(b)
    for f in ta:
        assert torch.equal(ta[f], tb[f]), f
    assert a.heap_tids == b.heap_tids
    np.testing.assert_array_equal(b.store.rows, data)


def test_two_builds_one_seed_are_identical(ivf):
    data = np.random.default_rng(21).standard_normal((6000, 16))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdb, "_DESCENT_MIN_WIDTH", 2048)
        again = TorchIndex.build(data.astype(np.float32), metric="l2",
                                 params=TIndexParams(m=8, ef_construction=32),
                                 method="device", seed=3, host_graph=False, device="cpu")
    ta, tb = _graph_tensors(ivf[1]), _graph_tensors(again)
    for f in ta:
        assert torch.equal(ta[f], tb[f]), f
    assert (ivf[1].device_graph().entry == again.device_graph().entry)


def test_capacity_picks_the_engine_and_bounds_masks_as_in_jax(monkeypatch):
    """Fault 3a: a device-built serving-only graph reports the JAX graph's
    padded capacity (``cap_pad_for(n) - 1``), so with the exact cutover
    between n and that capacity both packages pick the beam engine for
    ``search(method="auto")``, and both take a filter mask up to the
    capacity and refuse a longer one."""
    n = 600
    data = np.random.default_rng(8).standard_normal((n, 8)).astype(np.float32)
    j = JaxIndex.build(data, metric="l2", params=IndexParams(m=8),
                       method="device", seed=2, host_graph=False)
    t = TorchIndex.build(data, metric="l2", params=TIndexParams(m=8),
                         method="device", seed=2, host_graph=False,
                         device="cpu")
    cap = tdb.cap_pad_for(n) - 1
    assert j.device_graph().cap == t.device_graph().capacity == cap > n
    calls = []
    for name, mod in (("jax", jdev), ("torch", tdev)):
        monkeypatch.setattr(mod, "EXACT_ENGINE_MAX_ROWS", (n + cap) // 2)
        real = mod._exact_search_batch
        monkeypatch.setattr(
            mod, "_exact_search_batch",
            lambda *a, _real=real, _name=name, **kw: (
                calls.append(_name), _real(*a, **kw))[1])
    q = data[:40] + 0.01
    _, ji = j.search(q, 5)
    _, ti = t.search(q, 5)
    assert calls == []  # both walked the graph
    np.testing.assert_array_equal(ti, ji)
    for length in (n, cap):
        mask = np.ones(length, bool)
        _, ji = j.search(q, 5, method="exact", filter_mask=mask)
        _, ti = t.search(q, 5, method="exact", filter_mask=mask)
        np.testing.assert_array_equal(ti, ji)
    for idx in (j, t):
        with pytest.raises(ValueError, match="capacity"):
            idx.search(q, 5, method="exact",
                       filter_mask=np.ones(cap + 1, bool))


def test_auto_picks_the_device_build_at_20000_rows(monkeypatch):
    calls = []
    monkeypatch.setattr(tdb, "bulk_build",
                        lambda idx, data, ids, host_graph, consume_input:
                        calls.append((len(data), host_graph)))
    TorchIndex.build(np.zeros((20000, 4), np.float32), metric="l2", device="cpu")
    assert calls == [(20000, True)]
    small = TorchIndex.build(np.random.default_rng(1).random((50, 4)),
                             metric="l2", device="cpu")
    assert len(calls) == 1 and len(small.elements) == 50


# ---------------------------------------------------------------------------
# what is not ported raises
# ---------------------------------------------------------------------------


def _data(n=100, d=8):
    return np.random.default_rng(5).random((n, d)).astype(np.float32)


#: the PGV_BUILD_* knobs the port refuses, each at a value the JAX package
#: acts on, and the ROADMAP entry its refusal names
REFUSED = [("PGV_BUILD_TIMING", "1", "item 17"),
           ("PGV_BUILD_DEBUG", "1", "item 17"),
           ("PGV_BUILD_ABLATE", "be0", "Not to port"),
           ("PGV_BUILD_UPPER_STRATIFY", "1", "Not to port"),
           ("PGV_BUILD_IP_AUG", "1", "Not to port"),
           ("PGV_BUILD_RAMP", "buckets", "Not to port"),
           ("PGV_BUILD_CAP_FLOOR", "65536", "Not to port"),
           ("PGV_BUILD_UPPER_FLOOR", "4096", "Not to port"),
           ("PGV_BUILD_SUB_FLOORS", "128,128", "Not to port")]


@pytest.mark.parametrize("var,val,entry", REFUSED)
def test_build_env_settings_raise(monkeypatch, var, val, entry):
    """A knob the port does not build raises, naming its ROADMAP entry;
    the build and the insert read the same settings."""
    idx = TorchIndex.build(_data(), metric="l2", method="device",
                           host_graph=False, device="cpu")
    monkeypatch.setenv(var, val)
    with pytest.raises(NotImplementedError, match=f"{var}.*ROADMAP.*{entry}"):
        TorchIndex.build(_data(), metric="l2", method="device", device="cpu")
    with pytest.raises(NotImplementedError, match=var):
        idx.insert_bulk(_data(n=8))


@pytest.mark.parametrize("var,val", [("PGV_BUILD_STREAM", "0"),
                                     ("PGV_BUILD_STREAM_MIN", "1"),
                                     ("PGV_BUILD_STREAM_CHUNK", "1")])
def test_stream_settings_are_no_ops(monkeypatch, var, val):
    """The JAX package's upload-streaming knobs only schedule its host to
    device copy, which the port does not have: accepted, the same graph."""
    a = TorchIndex.build(_data(), metric="l2", method="device",
                         host_graph=False, device="cpu")
    monkeypatch.setenv(var, val)
    b = TorchIndex.build(_data(), metric="l2", method="device",
                         host_graph=False, device="cpu")
    ga, gb = _graph_tensors(a), _graph_tensors(b)
    for f in ga:
        assert torch.equal(ga[f], gb[f]), f


def test_default_env_settings_are_accepted(monkeypatch):
    monkeypatch.setenv("PGV_BUILD_GROUND", "auto")
    monkeypatch.setenv("PGV_BUILD_ALPHA", "1.0")
    idx = TorchIndex.build(_data(), metric="l2", method="device", device="cpu")
    assert idx.num_tuples == 100


def test_tensor_on_another_device_raises():
    """A corpus tensor on another device than the index's is refused,
    never moved silently."""
    with pytest.raises(ValueError, match="never moves"):
        TorchIndex.build(torch.from_numpy(_data()), metric="l2",
                         device="meta")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_card_build_invariants_and_recall(cuda):
    data, queries = make_dataset(20000, 32, NQ, seed=28)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdb, "_DESCENT_MIN_WIDTH", 4096)
        t = TorchIndex.build(torch.from_numpy(data).to(cuda), metric="l2",
                             params=TIndexParams(m=8, ef_construction=32),
                             seed=3, host_graph=False, device=cuda)
        c = TorchIndex.build(data, metric="l2",
                             params=TIndexParams(m=8, ef_construction=32),
                             method="device", seed=3, host_graph=False, device="cpu")
    g = t.device_graph()
    assert g.device.type == "cuda"
    _check_invariants(g, 8, 20000)
    _, gt = tdev.serve_topk(c, queries, K, engine="exact")
    r_card = _beam_recall(t, queries, gt)
    r_cpu = _beam_recall(c, queries, gt)
    assert r_card >= 0.95 and abs(r_card - r_cpu) <= 0.01, (r_card, r_cpu)
