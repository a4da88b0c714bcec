"""The port's beam-descent ground and l1 in its device build
(pgvector_rx_tpu_torch/graph/device_build.py) against the JAX package's,
on the same numpy data and seed.

Cases: 512-d cosine (3,072 rows) and 16-d l1 (4,096 rows), where the
ground "auto" picks the beam; 32-d l2 (4,096 rows) with the beam forced
through PGV_BUILD_GROUND; and a 512-d ``insert_bulk`` of 512 rows on top
of a 2,048-row build. The ramp ends at 2,048 rows in both packages, so the
walk builds the rest of each graph. Both graphs are
served by the port's beam engine (the JAX graph enters through
``DeviceGraph.from_numpy``), so a recall difference belongs to the build.
JAX builds run on the CPU as tests/test_device_build.py runs them.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvector_rx_tpu.config import IndexParams
from pgvector_rx_tpu.graph import device_build as jdb
from pgvector_rx_tpu.index.hnsw import HnswIndex as JaxIndex
from pgvector_rx_tpu_torch import HnswIndex as TorchIndex
from pgvector_rx_tpu_torch.config import IndexParams as TIndexParams
from pgvector_rx_tpu_torch.data import make_dataset
from pgvector_rx_tpu_torch.graph import device as tdev
from pgvector_rx_tpu_torch.graph import device_build as tdb

torch.set_num_threads(1)

K, EF, NQ = 10, 40, 200
M, EFC = 8, 32
_FIELDS = ("neighbors0", "upper_neighbors", "upper_slot", "levels",
           "traversable", "emit_tid", "tid_count", "values", "x2",
           "values_bf16")
#: case -> (metric, dim, PGV_BUILD_GROUND, rows, of them inserted after
#: the build)
_CASES = {"cosine512": ("cosine", 512, None, 3072, 0),
          "l1": ("l1", 16, None, 4096, 0),
          "beam_l2": ("l2", 32, "beam", 4096, 0),
          "insert512": ("cosine", 512, None, 2560, 512)}


def _carry(j):
    """A port index serving the JAX index's graph (same arrays)."""
    jg = j.device_graph()
    t = TorchIndex(j.dim, metric=j.metric,
                   params=TIndexParams(m=M, ef_construction=EFC), device="cpu")
    t.serving_only = True
    t.entry = j.entry
    t.heap_tids = list(j.heap_tids)
    t._device = tdev.DeviceGraph.from_numpy(
        {f: np.asarray(getattr(jg, f)) for f in _FIELDS},
        kind=jg.kind, metric=jg.metric, cap=jg.cap, m=jg.m, entry=jg.entry,
        entry_level=jg.entry_level, device="cpu",
    )
    return t


@functools.lru_cache(maxsize=None)
def _case(name):
    """(JAX graph carried into the port, port index, queries, rows)."""
    metric, dim, ground, n, n_ins = _CASES[name]
    data, queries = make_dataset(n, dim, NQ, seed=31, n_clusters=40)
    if metric == "cosine":
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    n0 = n - n_ins
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdb, "_DESCENT_MIN_WIDTH", 2048)
        mp.setattr(tdb, "_DESCENT_MIN_WIDTH", 2048)
        if ground:
            mp.setenv("PGV_BUILD_GROUND", ground)
        j = JaxIndex.build(data[:n0], metric=metric,
                           params=IndexParams(m=M, ef_construction=EFC),
                           method="device", seed=3, host_graph=False)
        t = TorchIndex.build(data[:n0], metric=metric,
                             params=TIndexParams(m=M, ef_construction=EFC),
                             method="device", seed=3, host_graph=False,
                             device="cpu")
        if n_ins:
            assert t.insert_bulk(data[n0:]) == n_ins
            # the JAX insert pads its batches to 1,024 rows; at 256 it runs
            # the port's schedule (64, 128, 256, 64) and compiles less
            mp.setenv("PGV_BUILD_BATCH", "256")
            assert j.insert_bulk(data[n0:]) == n_ins
    return _carry(j), t, queries, n


@pytest.fixture(scope="module", params=list(_CASES))
def pair(request):
    return _case(request.param)


def _beam_recall(idx, q, gt):
    _, ids = tdev.serve_topk(idx, q, K, engine="beam", ef=EF)
    return float(np.mean([len(set(ids[b]) & set(gt[b])) / K
                          for b in range(len(q))]))


def test_beam_recall_matches_jax(pair):
    j, t, q, _ = pair
    _, gt = tdev.serve_topk(t, q, K, engine="exact")
    r_t, r_j = _beam_recall(t, q, gt), _beam_recall(j, q, gt)
    assert abs(r_t - r_j) <= 0.005, (r_t, r_j)
    assert r_t >= 0.9


def test_structural_invariants(pair):
    from tests.test_torch_device_build import _check_invariants

    _, t, _, n = pair
    g = t.device_graph()
    _check_invariants(g, M, n)
    # the JAX graph's padded capacity, as a figure (fault 3a)
    assert g.capacity == tdb.cap_pad_for(n) - 1


def test_layer0_overlaps_jax(pair):
    j, t, _, n = pair
    na = j.device_graph().neighbors0[:n].numpy()
    nb = t.device_graph().neighbors0[:n].numpy()
    share = np.mean([len(set(na[i][na[i] >= 0]) & set(nb[i][nb[i] >= 0]))
                     / max(1, int((na[i] >= 0).sum())) for i in range(n)])
    assert share >= 0.9, share


@pytest.mark.parametrize("name", ["cosine512", "l1"])
def test_beam_ground_candidates_match_jax(name):
    """``_beam_ground_candidates`` alone, on the same graph (the JAX
    build's layer 0), seeds and entry: ids equal but for ties, distances
    to rtol 1e-5."""
    j, _, q, n = _case(name)
    jg = j.device_graph()
    metric = jg.metric
    rows = np.asarray(jg.values)[:n].astype(np.float32)
    levels = np.asarray(jg.levels)[:n]
    jb = jdb.DeviceBuilder(metric, rows, levels, M, EFC, batch_max=64)
    tb = tdb.DeviceBuilder(metric, torch.from_numpy(rows), levels, M, EFC,
                           batch_max=64)
    assert jb.cap == tb.cap
    nb0 = np.full((jb.cap + 1, 2 * M), -1, np.int32)
    nb0[:n] = np.asarray(jg.neighbors0)[:n]
    alive = np.zeros(jb.cap + 1, bool)
    alive[:n] = np.asarray(jg.traversable)[:n]
    tb.arrays.nb0_ids.copy_(torch.from_numpy(nb0))
    tb.arrays.alive.copy_(torch.from_numpy(alive))
    tb.arrays.entry = torch.tensor(jg.entry, dtype=torch.int64)

    # seeds: the 16 nearest level >= 1 rows of each query, f32 distances
    qr = q[:64].astype(np.float32)
    ups = np.nonzero(levels >= 1)[0]
    seed_ids = ups[np.argsort(
        tb._dist_point_rows(torch.from_numpy(qr),
                            torch.from_numpy(rows[ups])[None].expand(
                                64, -1, -1)).numpy(), axis=1,
        kind="stable")[:, :16]]
    seed_d = tb._dist_point_rows(
        torch.from_numpy(qr), torch.from_numpy(rows[seed_ids])).numpy()

    jd, ji = jb._beam_ground_candidates(
        jb.data, jnp.asarray(nb0), jnp.asarray(alive), jnp.int32(jg.entry),
        jnp.asarray(qr), jnp.asarray(seed_d), jnp.asarray(seed_ids, np.int32),
        16, 4,
    )
    td, ti = tb._beam_ground_candidates(
        tb.data, tb.arrays, torch.from_numpy(qr), torch.from_numpy(seed_d),
        torch.from_numpy(seed_ids).long(),
    )
    jd, ji, td, ti = np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()
    assert ti.shape == ji.shape == (64, EFC)
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=1e-6)
    for r in range(64):
        f = fin[r]
        sa, sb = set(ti[r][f].tolist()), set(ji[r][f].tolist())
        kth = jd[r][f][-1]
        tol = 1e-5 * abs(kth) + 1e-6
        ta = dict(zip(ti[r][f].tolist(), td[r][f].tolist()))
        tj = dict(zip(ji[r][f].tolist(), jd[r][f].tolist()))
        assert all(abs(ta[i] - kth) <= tol for i in sa - sb), r
        assert all(abs(tj[i] - kth) <= tol for i in sb - sa), r


@pytest.mark.parametrize("metric,dim,ground", [("cosine", 512, "beam"),
                                               ("l2", 768, "beam"),
                                               ("l1", 8, "beam"),
                                               ("cosine", 64, "ivf")])
def test_auto_ground_follows_the_jax_rule(metric, dim, ground):
    b = tdb.DeviceBuilder(metric, torch.zeros(16, dim), np.zeros(16, np.int32),
                          4, 16, batch_max=64)
    assert b.ivf == (ground == "ivf")


def test_ground_setting_is_read(monkeypatch):
    """PGV_BUILD_GROUND picks the ground (the beam at 16-d l2 here), and an
    unknown one is refused."""
    monkeypatch.setenv("PGV_BUILD_GROUND", "beam")
    b = tdb.DeviceBuilder("l2", torch.zeros(16, 16), np.zeros(16, np.int32),
                          4, 16, batch_max=64)
    assert not b.ivf
    monkeypatch.setenv("PGV_BUILD_GROUND", "walk")
    with pytest.raises(ValueError, match="ground"):
        tdb.DeviceBuilder("l2", torch.zeros(16, 16), np.zeros(16, np.int32),
                          4, 16, batch_max=64)


#: the knobs the port refuses: (name, a value the JAX package ignores, one
#: it acts on); the beam's own knobs are read
#: (tests/test_torch_build_knobs.py)
_REFUSED = [("PGV_BUILD_TIMING", "", "1"), ("PGV_BUILD_DEBUG", "", "1"),
            ("PGV_BUILD_ABLATE", ",", "be0"),
            ("PGV_BUILD_UPPER_STRATIFY", "0", "1"),
            ("PGV_BUILD_IP_AUG", "0", "1"),
            ("PGV_BUILD_RAMP", "single", "buckets"),
            ("PGV_BUILD_CAP_FLOOR", "0", "65536"),
            ("PGV_BUILD_UPPER_FLOOR", "0", "4096"),
            ("PGV_BUILD_SUB_FLOORS", "", "128")]


@pytest.mark.parametrize("var,off,on", _REFUSED)
def test_beam_knobs_keep_their_defaults(monkeypatch, var, off, on):
    """An l1 build (the beam ground) takes a refused knob at a value the
    JAX package ignores, and refuses one it acts on, naming the ROADMAP
    entry."""
    monkeypatch.setenv(var, off)
    data = np.random.default_rng(4).random((300, 8)).astype(np.float32)
    idx = TorchIndex.build(data, metric="l1", method="device", device="cpu")
    assert idx.num_tuples == 300
    monkeypatch.setenv(var, on)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TorchIndex.build(data, metric="l1", method="device", device="cpu")


@pytest.mark.parametrize("metric", ["cosine", "l1"])
def test_host_graph_build_at_the_beam_ground(metric):
    """``build(device="cpu")`` at 768-d cosine and at l1 builds a host graph
    that searches itself."""
    dim = 768 if metric == "cosine" else 12
    data, _ = make_dataset(600, dim, 1, seed=33, n_clusters=10)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdb, "_DESCENT_MIN_WIDTH", 256)
        idx = TorchIndex.build(data, metric=metric, method="device", seed=2,
                               params=TIndexParams(m=8, ef_construction=32),
                               device="cpu")
    assert len(idx.elements) == 600 and not idx.serving_only
    _, ids = idx.search(data[:50], 1, method="exact")
    assert (ids[:, 0] == np.arange(50)).all()
    _, ids = idx.search(data[:50], 1, method="host")
    assert (ids[:, 0] == np.arange(50)).mean() >= 0.95
