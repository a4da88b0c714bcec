"""The bit kind (hamming / jaccard) end to end in the port against the JAX
package, on the same numpy data and seeds.

- The device build (unpacked {0,1} f32 rows; "l2" for hamming, "jacbits"
  for jaccard; the beam ground) with both packages, the ramp ending at
  2,048 rows in both: structural invariants, the serving graph's words
  equal to JAX's, the duplicate fold (byte-equal zero rows never fold for
  jaccard) and beam tie-aware recall@10 within 0.005 of the JAX graph's.
- The three engines on a graph carried from JAX through its checkpoint
  return JAX's ids; checkpoints move both ways; the append log replays bit
  inserts.
- The port's versions of the JAX package's bit cases: tests/test_index.py
  (host recall, jaccard, the exact engine at both of JAX's sweep forms,
  duplicates), tests/test_device_build.py's jaccard build and
  tests/test_native.py's serving-only bit build.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvector_rx_tpu.config import IndexParams
from pgvector_rx_tpu.config import SearchParams as JSearchParams
from pgvector_rx_tpu.graph import device as jdev
from pgvector_rx_tpu.graph import device_build as jdb
from pgvector_rx_tpu.index.hnsw import HnswIndex as JaxIndex
from pgvector_rx_tpu.types import bitvec
from pgvector_rx_tpu_torch import HnswIndex
from pgvector_rx_tpu_torch.config import IndexParams as TIndexParams
from pgvector_rx_tpu_torch.config import SearchParams
from pgvector_rx_tpu_torch.data import make_dataset
from pgvector_rx_tpu_torch.graph import device as tdev
from pgvector_rx_tpu_torch.graph import device_build as tdb
from pgvector_rx_tpu_torch.ops import bits as tbits

torch.set_num_threads(1)

CPU = dict(device="cpu")
K, EF, M, EFC = 10, 40, 8, 32
N_BUILD, NBITS = 3072, 64
_FIELDS = ("neighbors0", "upper_neighbors", "upper_slot", "levels",
           "traversable", "emit_tid", "tid_count", "words")


def _sign_bits(n, nbits, n_q, seed):
    """BASELINE's bit data at a small size: sign bits of manifold rows."""
    data, q = make_dataset(n, nbits, n_q, seed=seed, n_clusters=40,
                           intrinsic=24)
    return (data > 0).astype(np.uint8), (q > 0).astype(np.uint8)


def _carry(j):
    """A port index serving the JAX index's graph (same arrays)."""
    jg = j.device_graph()
    t = HnswIndex(j.dim, metric=j.metric, kind="bit",
                  params=TIndexParams(m=j.params.m,
                                      ef_construction=j.params.ef_construction),
                  **CPU)
    t.serving_only = True
    t.entry = j.entry
    t.heap_tids = list(j.heap_tids)
    t._device = tdev.DeviceGraph.from_numpy(
        {f: np.asarray(getattr(jg, f)) for f in _FIELDS},
        kind=jg.kind, metric=jg.metric, cap=jg.cap, m=jg.m, entry=jg.entry,
        entry_level=jg.entry_level, **CPU)
    return t


@functools.lru_cache(maxsize=None)
def _built(metric):
    """(JAX graph carried into the port, port index, JAX index, packed
    queries, rows): both device builds of the same bits, serving-only."""
    bits, qb = _sign_bits(N_BUILD, NBITS, 200, seed=7)
    bits[0] = bits[1] = 0  # zero rows: hamming folds them, jaccard never
    bits[2:6] = bits[10]  # byte-equal copies: both fold them
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdb, "_DESCENT_MIN_WIDTH", 2048)
        mp.setattr(tdb, "_DESCENT_MIN_WIDTH", 2048)
        j = JaxIndex.build(bits, metric=metric,
                           params=IndexParams(m=M, ef_construction=EFC),
                           method="device", seed=3, host_graph=False)
        t = HnswIndex.build(bits, metric=metric,
                            params=TIndexParams(m=M, ef_construction=EFC),
                            method="device", seed=3, host_graph=False, **CPU)
    return _carry(j), t, j, tbits.pack_bits(qb), bits


def _tie_aware_recall(idx, qw, true_d):
    """Share of returned rows whose distance is at most the k-th true
    distance (ties at the k-th place count)."""
    d, _ = tdev.serve_topk(idx, qw, K, engine="beam", ef=EF)
    return float((d <= true_d[:, -1:]).mean())


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_device_build_invariants_and_words(metric):
    from tests.test_torch_device_build import _check_invariants

    jc, t, j, _, bits = _built(metric)
    assert t.kind == "bit" and t.serving_only
    g = t.device_graph()
    _check_invariants(g, M, N_BUILD)
    assert g.capacity == tdb.cap_pad_for(N_BUILD) - 1
    assert g.words.dtype == torch.int32 and g.values is None
    # the serving graph's words, packed on the device, are JAX's
    np.testing.assert_array_equal(
        g.words[:N_BUILD].numpy().view(np.uint32),
        np.asarray(j.device_graph().words)[:N_BUILD])
    np.testing.assert_array_equal(g.x2.numpy()[:N_BUILD],
                                  bits.sum(1).astype(np.float32))
    # the store keeps the packed bytes, equal to prepare_value's rows
    np.testing.assert_array_equal(
        t.store.rows[:N_BUILD],
        np.stack([t.prepare_value(r) for r in bits]))


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_duplicate_fold_rule(metric):
    """Byte-equal rows fold into one element; zero rows fold for hamming
    (distance 0) but never for jaccard (1.0 apart), in both packages."""
    _, t, j, _, _ = _built(metric)
    for idx in (t, j):
        copies = [len(idx.heap_tids[i]) for i in (2, 3, 4, 5, 10)]
        assert sum(copies) == 5 and max(copies) >= 2, copies
        zeros = [len(idx.heap_tids[i]) for i in (0, 1)]
        if metric == "jaccard":
            assert zeros == [1, 1]
        else:
            assert sorted(zeros) == [0, 2]


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_beam_recall_matches_jax(metric):
    jc, t, _, qw, _ = _built(metric)
    true_d, _ = tdev.serve_topk(t, qw, K, engine="exact")
    r_t = _tie_aware_recall(t, qw, true_d)
    r_j = _tie_aware_recall(jc, qw, true_d)
    assert abs(r_t - r_j) <= 0.005, (r_t, r_j)
    assert r_t >= 0.9


def test_bit_input_as_a_tensor_raises():
    bits = (np.random.default_rng(1).random((50, 16)) < 0.5).astype(np.uint8)
    with pytest.raises(ValueError, match="dense metrics only"):
        HnswIndex.build(torch.from_numpy(bits), metric="hamming", **CPU)


def test_bit_build_pins_the_beam_ground(monkeypatch):
    """A bit corpus always takes the beam ground; another
    ``PGV_BUILD_GROUND`` is ignored with a warning, as in JAX."""
    grounds = []
    init = tdb.DeviceBuilder.__init__

    def spy(self, *a, **kw):
        grounds.append(kw.get("ground"))
        init(self, *a, **kw)

    monkeypatch.setattr(tdb.DeviceBuilder, "__init__", spy)
    bits = (np.random.default_rng(2).random((300, 24)) < 0.5).astype(
        np.uint8)
    monkeypatch.setenv("PGV_BUILD_GROUND", "ivf")
    with pytest.warns(UserWarning, match="PGV_BUILD_GROUND=ivf ignored"):
        idx = HnswIndex.build(bits, metric="hamming", method="device", **CPU)
    monkeypatch.setenv("PGV_BUILD_GROUND", "beam")
    HnswIndex.build(bits, metric="jaccard", method="device", **CPU)
    assert grounds == ["beam", "beam"] and idx.num_tuples == 300


def test_auto_takes_the_device_build_at_20000_rows(monkeypatch):
    """``method="auto"`` builds a bit corpus of 20,000 rows or more on the
    device (while its f32 build rows fit 6 GiB), below that natively."""
    calls = []
    monkeypatch.setattr(tdb, "bulk_build",
                        lambda idx, data, ids, host_graph: calls.append(
                            len(data)))
    bits = np.zeros((20000, 8), np.uint8)
    HnswIndex.build(bits, metric="jaccard", **CPU)
    assert calls == [20000]
    small = HnswIndex.build(bits[:300], metric="jaccard", **CPU)
    assert calls == [20000] and small.num_tuples == 300


# ---------------------------------------------------------------------------
# engines on a JAX graph, checkpoints both ways, the append log
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_native(metric):
    rng = np.random.default_rng(21)
    bits = (rng.random((1500, 72)) < 0.3).astype(np.uint8)
    j = JaxIndex.build(bits, metric=metric, method="native", seed=5,
                       host_graph=False)
    q = (rng.random((40, 72)) < 0.3).astype(np.uint8)
    return j, bits, q


def _equal_but_ties(ids_a, d_a, ids_b, d_b):
    """Equal distances at every rank; below each row's k-th distance the
    same ids, in the same place wherever the distance is unique (JAX's
    approx engine orders ties as ``approx_min_k`` leaves them; the port's
    selects exactly)."""
    np.testing.assert_array_equal(d_a, d_b)
    for r in range(d_a.shape[0]):
        inner = d_a[r] < d_a[r, -1]
        assert set(ids_a[r][inner]) == set(ids_b[r][inner]), r
        vals, counts = np.unique(d_a[r], return_counts=True)
        uniq = inner & np.isin(d_a[r], vals[counts == 1])
        np.testing.assert_array_equal(ids_a[r][uniq], ids_b[r][uniq])


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_engines_on_a_jax_checkpoint_give_jax_ids(metric, tmp_path):
    """Exact and beam give JAX's ids, tie order included; approx equal
    distances and ids but for ties."""
    j, _, q = _jax_native(metric)
    j.save(tmp_path / "ck")
    t = HnswIndex.load(tmp_path / "ck", **CPU)
    assert t.kind == "bit" and t.device_graph().words.dtype == torch.int32
    qw = tbits.pack_bits(q)
    for engine in ("exact", "approx", "beam"):
        jd, ji = jdev.serve_topk(j, jnp.asarray(qw), K, engine=engine,
                                 chunk=8)
        td, ti = tdev.serve_topk(t, qw, K, engine=engine)
        if engine == "approx":
            _equal_but_ties(ti, td, np.asarray(ji), np.asarray(jd))
            continue
        np.testing.assert_array_equal(ti, np.asarray(ji), err_msg=engine)
        np.testing.assert_array_equal(td, np.asarray(jd), err_msg=engine)
    for method in ("exact", "approx", "device"):
        jd, jt = j.search(q, K, JSearchParams(ef_search=EF), method=method)
        td, tt = t.search(q, K, SearchParams(ef_search=EF), method=method)
        if method == "approx":
            _equal_but_ties(tt, td, jt, jd)
            continue
        np.testing.assert_array_equal(tt, jt, err_msg=method)
        np.testing.assert_array_equal(td, jd, err_msg=method)


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_search_batch_gives_jax_search_batch(metric):
    """The port's ``_search_batch`` (the greedy descent, then the walk: on
    the CPU ``_descent_seeds`` and the plain walk) on a JAX graph gives
    JAX's ``_search_batch`` at every rank of the ef-wide beam, distances
    and ids, ties included, and JAX's landing (``_descent_seed_one``)."""
    j, _, q = _jax_native(metric)
    jg, t = j.device_graph(), _carry(j)
    tg = t.device_graph()
    assert tg.entry_level >= 1
    qw = tbits.pack_bits(q)
    steps = 4 * EF + 32
    jd, ji, _ = jdev._search_batch(jg, jnp.asarray(qw), EF, jg.entry_level,
                                   steps)
    td, ti, _ = tdev._search_batch(tg, tbits.as_words(qw), EF,
                                   tg.entry_level, steps)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    land_i, land_d = tdev._descent_seeds(tg, tbits.as_words(qw),
                                         tg.entry_level)
    for r in range(0, len(qw), 8):
        ji1, jd1 = jdev._descent_seed_one(jg, jnp.asarray(qw[r]),
                                          jg.entry_level)
        assert int(land_i[r, 0]) == int(ji1[0])
        assert float(land_d[r, 0]) == float(jd1[0])


def _tied_upper_graph():
    """A bit graph (32 bits, query 0: a row's distance is its popcount)
    whose upper layers tie: at layer 2 the entry (popcount 4) sees rows 3
    (4: equal, no move), 1 and 2 (3: tied, slot 1 first); row 1 sees 4 (3:
    equal); at layer 1 row 1 sees 7 (1, dead), 5 and 6 (2: tied); row 5
    sees 6 (2: equal). The descent lands on 5 only by the first-slot and
    strict-< rules (the last slot would give 2 then 6, <= would move on)."""
    pops = [4, 3, 3, 4, 3, 2, 2, 1, 3, 4, 5, 6]
    n, m = len(pops), 4
    words = np.zeros((n + 1, 1), np.uint32)
    for i, p in enumerate(pops):
        words[i, 0] = (1 << p) - 1
    upper = np.full((4, 2 * m), -1, np.int32)
    slot = np.full(n + 1, -1, np.int32)
    levels = np.zeros(n + 1, np.int32)
    for row, (node, lvl, l1, l2) in enumerate([
            (0, 2, [3, 1, 2, -1], [3, 1, 2, -1]), (1, 2, [7, 5, 6, 0],
                                                   [0, 4, -1, -1]),
            (5, 1, [6, 1, -1, -1], []), (4, 2, [1, -1, -1, -1],
                                         [1, -1, -1, -1])]):
        slot[node], levels[node] = row, lvl
        upper[row, :len(l1)] = l1
        upper[row, m : m + len(l2)] = l2
    nb0 = np.full((n + 1, 2 * m), -1, np.int32)
    for i in range(n):
        nb0[i, :3] = [(i + 1) % n, (i + 5) % n, (i + 7) % n]
    trav = np.ones(n + 1, bool)
    trav[7] = trav[n] = False
    return dict(neighbors0=nb0, upper_neighbors=upper, upper_slot=slot,
                levels=levels, traversable=trav,
                emit_tid=np.arange(n + 1, dtype=np.int32),
                tid_count=np.ones(n + 1, np.int32), words=words), n, m


def test_descent_ties_land_where_jax_lands():
    """On tied upper neighbours the descent keeps JAX's rules: the first
    slot of the minimum, and no move on an equal distance."""
    arrays, n, m = _tied_upper_graph()
    jg = jdev.DeviceGraph(kind="bit", metric="hamming", cap=n, m=m, entry=0,
                          entry_level=2,
                          **{f: jnp.asarray(v) for f, v in arrays.items()})
    tg = tdev.DeviceGraph.from_numpy(arrays, kind="bit", metric="hamming",
                                     cap=n, m=m, entry=0, entry_level=2,
                                     **CPU)
    q = np.zeros((3, 1), np.uint32)
    ji, jd = jdev._descent_seed_one(jg, jnp.asarray(q[0]), 2)
    assert int(ji[0]) == 5 and float(jd[0]) == 2.0
    ti, td = tdev._descent_seeds(tg, tbits.as_words(q), 2)
    assert ti[:, 0].tolist() == [5, 5, 5] and td[:, 0].tolist() == [2.0] * 3
    jd, ji, _ = jdev._search_batch(jg, jnp.asarray(q), 8, 2, 64)
    td, ti, _ = tdev._search_batch(tg, tbits.as_words(q), 8, 2, 64)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("serving", [False, True])
def test_checkpoints_move_both_ways(serving, tmp_path):
    """A port bit checkpoint loads in JAX and a JAX one in the port, host
    graph (with a deleted row) or serving-only, with the same search ids."""
    rng = np.random.default_rng(22)
    bits = (rng.random((400, 40)) < 0.4).astype(np.uint8)
    q = bits[:12]
    kw = dict(metric="jaccard", seed=4, host_graph=not serving)
    t = HnswIndex.build(bits, method="native", **kw, **CPU)
    j = JaxIndex.build(bits, method="native", **kw)
    if not serving:
        t.delete([3])
        j.delete([3])
    t.save(tmp_path / "t")
    j.save(tmp_path / "j")
    jt = JaxIndex.load(tmp_path / "t")
    tj = HnswIndex.load(tmp_path / "j", **CPU)
    method = "device" if serving else "host"
    for a, b in ((t, jt), (tj, j)):
        da, ia = a.search(q, K, method=method)
        db, ib = b.search(q, K, method=method)
        np.testing.assert_array_equal(ia, ib)
        np.testing.assert_allclose(da, db, rtol=1e-6)
    if not serving:
        served = HnswIndex.load(tmp_path / "j", serving=True, **CPU)
        jserved = JaxIndex.load(tmp_path / "j", serving=True)
        np.testing.assert_array_equal(
            served.search(q, K, method="device")[1],
            jserved.search(q, K, method="device")[1])


def test_append_log_replays_bit_inserts(tmp_path):
    """Bit inserts log in the JAX package's encoding (packed bytes as hex,
    0/1 values as a list) and replay to the same index."""
    from pgvector_rx_tpu.index import storage as jstorage
    from pgvector_rx_tpu_torch.index import storage as tstorage

    rng = np.random.default_rng(23)
    bits = (rng.random((200, 24)) < 0.5).astype(np.uint8)
    idx = HnswIndex.build(bits, metric="hamming", method="host", seed=2,
                          **CPU)
    idx.save(tmp_path / "ck")
    idx.enable_log(tmp_path / "ck" / "log.jsonl")
    new = (rng.random((6, 24)) < 0.5).astype(np.uint8)
    for i, row in enumerate(new):
        idx.insert(row if i % 2 else np.packbits(row), tid=1000 + i)
    idx.delete([5])
    idx._log.close()
    back = HnswIndex.load(tmp_path / "ck", **CPU)
    jback = JaxIndex.load(tmp_path / "ck")
    assert back.num_tuples == idx.num_tuples == jback.num_tuples
    q = np.concatenate([new, bits[:6]])
    for other in (back, jback):
        np.testing.assert_array_equal(idx.search(q, 5, method="host")[1],
                                      other.search(q, 5, method="host")[1])
    j = JaxIndex(24, metric="hamming", kind="bit")
    for mod, index in ((tstorage, idx), (jstorage, j)):
        assert mod._encode_value(index, np.packbits(new[0])) == \
            {"packed": np.packbits(new[0]).tobytes().hex()}
        assert mod._encode_value(index, new[1]) == {"bits": new[1].tolist()}


# ---------------------------------------------------------------------------
# the JAX package's bit cases, in the port
# ---------------------------------------------------------------------------


def _brute(bits, q, metric, k):
    if metric == "hamming":
        dist = (q[:, None, :] != bits[None, :, :]).sum(-1).astype(np.float64)
    else:
        inter = (q[:, None, :] & bits[None, :, :]).sum(-1)
        union = (q[:, None, :] | bits[None, :, :]).sum(-1)
        dist = np.where(inter == 0, 1.0, 1.0 - inter / np.maximum(union, 1))
    return dist, np.argsort(dist, axis=1, kind="stable")[:, :k]


def test_bit_index_recall():
    bits = np.random.default_rng(41).integers(0, 2, size=(300, 64)).astype(
        np.uint8)
    idx = HnswIndex.build(bits, metric="hamming", method="host", seed=14,
                          **CPU)
    dists, ids = idx.search(bits[7], 5, method="host")
    assert ids[0] == 7 and dists[0] == 0.0


def test_jaccard_index():
    bits = np.random.default_rng(43).integers(0, 2, size=(300, 48)).astype(
        np.uint8)
    idx = HnswIndex.build(bits, metric="jaccard", method="host", seed=15,
                          **CPU)
    _, ids = idx.search(bits[3], 3, method="host")
    assert ids[0] == 3


def test_exact_engine_bit():
    bits = np.random.default_rng(5).integers(0, 2, size=(200, 64)).astype(
        np.uint8)
    idx = HnswIndex.build(bits, metric="hamming", method="host", seed=0,
                          **CPU)
    d, ids = idx.search(bits[:20], 3, SearchParams(), method="exact")
    assert (ids[:, 0] == np.arange(20)).all()
    assert (d[:, 0] == 0).all()


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
def test_exact_engine_bit_at_48_queries(metric):
    """48 queries (the JAX package's unpack + matmul form; the port has one
    sweep): distances equal the scalar reference's."""
    rng = np.random.default_rng(41)
    bits = rng.integers(0, 2, size=(300, 72)).astype(np.uint8)
    idx = HnswIndex.build(bits, metric=metric, method="host", seed=0, **CPU)
    q = bits[:48]
    d, _ = idx.search(q, 5, SearchParams(), method="exact")
    scalar = (bitvec.hamming_distance if metric == "hamming"
              else bitvec.jaccard_distance)
    ref = np.array([[scalar(qq, bits[j]) for j in range(len(bits))]
                    for qq in q])
    np.testing.assert_allclose(d, np.sort(ref, axis=1)[:, :5], rtol=1e-6,
                               atol=1e-6)


def test_bit_duplicates():
    row = np.array([1, 0, 1, 1, 0, 0, 1, 0], dtype=np.uint8)
    idx = HnswIndex.build(np.tile(row, (20, 1)), metric="hamming",
                          method="host", **CPU)
    counts = sorted((len(t) for t in idx.heap_tids if t), reverse=True)
    assert counts[0] == 10
    _, ids = idx.search(row, 20, SearchParams(ef_search=1), method="host")
    assert (np.asarray(ids) >= 0).sum() == 10


def test_jaccard_device_build():
    rng = np.random.default_rng(42)
    bits = (rng.random((600, 64)) < 0.5).astype(np.uint8)
    bits[0] = 0  # zero row: jaccard 1.0 to everything incl. itself
    bits[1] = 0  # identical zero rows must NOT duplicate-fold
    idx = HnswIndex.build(bits, metric="jaccard", method="device", seed=3,
                          **CPU)
    assert idx.kind == "bit"
    assert all(len(t) == 1 for t in idx.heap_tids[:2])
    q = bits[2:22]
    jac, gt = _brute(bits, q, "jaccard", 10)
    d, _ = idx.search(q, 10, SearchParams(ef_search=40), method="device")
    np.testing.assert_allclose(d, np.sort(jac, axis=1)[:, :10], atol=1e-6)
    _, tids_b = tdev.search(idx, q, 10, SearchParams(ef_search=40),
                            engine="beam")
    rec = np.mean([len(set(tids_b[b]) & set(gt[b])) / 10 for b in range(20)])
    assert rec >= 0.8, rec


def test_serving_bit_kind():
    rng = np.random.default_rng(92)
    bits = rng.integers(0, 2, size=(500, 48)).astype(np.uint8)
    idx = HnswIndex.build(bits, metric="hamming", method="native",
                          host_graph=False, **CPU)
    assert idx.serving_only and idx.device_graph().words is not None
    _, gt = _brute(bits, bits[:10], "hamming", 5)
    _, ids = idx.search(bits[:10], 5, SearchParams(ef_search=40))
    rec = np.mean([len(set(ids[b]) & set(gt[b])) / 5 for b in range(10)])
    assert rec >= 0.9
