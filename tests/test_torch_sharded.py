"""The sharded index of the port (pgvector_rx_tpu_torch/parallel/sharded.py):
the cases of tests/test_sharded.py (and the sharded cases of
tests/test_serve_dtype.py and tests/test_filter.py) run on the port with
every shard on "cpu" (the C++ engine builds the shards where the JAX
case's host build is not what it checks), and the port held to the JAX package's ShardedHnswIndex on the same
checkpoints (search, scan, the water-fill, checkpoints both ways), its
per-shard beam to the JAX package's ``beam_search_arrays``, and two card
cases (4 shards on one card) against K1 and the plain walks."""

import shutil
import tracemalloc
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvector_rx_tpu.config import SearchParams as JSearchParams
from pgvector_rx_tpu.graph import device as jdevice
from pgvector_rx_tpu.parallel import ShardedHnswIndex as JShardedHnswIndex
from pgvector_rx_tpu_torch.config import SearchParams
from pgvector_rx_tpu_torch.graph import device as tdevice
from pgvector_rx_tpu_torch.parallel import ShardedHnswIndex
from pgvector_rx_tpu_torch.parallel import sharded

from test_index import brute_force, recall_at_k

torch.set_num_threads(1)


def cpus(n):
    return ["cpu"] * n


@pytest.fixture(scope="module")
def serving_shards():
    """Two serving-only shards device-built from a tensor corpus (the
    serving-only cases of tests/test_sharded.py share this build)."""
    rng = np.random.default_rng(33)
    data = rng.standard_normal((1200, 12)).astype(np.float32)
    corpus = torch.from_numpy(data)
    idx = ShardedHnswIndex.build(corpus, n_shards=2, metric="l2",
                                 method="device", host_graph=False, seed=34,
                                 devices=cpus(2))
    return idx, data, corpus


@pytest.fixture(scope="module")
def sharded_setup():
    rng = np.random.default_rng(70)
    data = rng.standard_normal((1200, 12)).astype(np.float32)
    idx = ShardedHnswIndex.build(data, n_shards=8, metric="l2",
                                 method="native", seed=71, devices=cpus(8))
    return idx, data


# ---------------------------------------------------------------------------
# tests/test_sharded.py on the port
# ---------------------------------------------------------------------------


class TestSharded:
    def test_devices_rule(self, sharded_setup):
        """One device per shard (the JAX mesh's size check); None means
        the visible cards and raises without one; a shard must sit on its
        listed device."""
        idx, _ = sharded_setup
        assert [str(d) for d in idx.devices] == cpus(8)
        with pytest.raises(ValueError, match="7 devices but 8 shards"):
            ShardedHnswIndex(idx.shards, devices=cpus(7))
        if torch.cuda.is_available():
            with pytest.raises(ValueError, match="listed device"):
                ShardedHnswIndex(idx.shards)
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ShardedHnswIndex(idx.shards)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ShardedHnswIndex.build(np.zeros((8, 4), np.float32), 2)
        with pytest.raises(ValueError, match="at least one shard"):
            ShardedHnswIndex([], devices=[])

    def test_recall(self, sharded_setup):
        idx, data = sharded_setup
        rng = np.random.default_rng(72)
        q = rng.standard_normal((8, 12)).astype(np.float32)
        gt = brute_force(data, q, "l2", 10)
        d, tids = idx.search(q, 10, SearchParams(ef_search=40))
        assert recall_at_k(tids, gt, 10) >= 0.99

    def test_matches_single_index_distances(self, sharded_setup):
        idx, data = sharded_setup
        q = data[17]
        d, tids = idx.search(q, 5)
        assert tids[0] == 17
        assert d[0] == pytest.approx(0.0, abs=1e-5)
        for dist, t in zip(d, tids):
            true = np.sqrt(((data[t] - q) ** 2).sum())
            assert dist == pytest.approx(true, rel=1e-4)

    def test_results_sorted(self, sharded_setup):
        idx, data = sharded_setup
        d, _ = idx.search(data[3] + 0.01, 10)
        assert list(d) == sorted(d)

    def test_insert_and_delete(self):
        rng = np.random.default_rng(73)
        data = rng.random((160, 6)).astype(np.float32)
        idx = ShardedHnswIndex.build(data, n_shards=4, metric="l2",
                                     method="host", seed=74, devices=cpus(4))
        new = rng.random(6).astype(np.float32)
        idx.insert(new, 5000)
        d, tids = idx.search(new, 1)
        assert tids[0] == 5000
        idx.delete([5000])
        d, tids = idx.search(new, 1)
        assert tids[0] != 5000

    def test_insert_bulk_balances_and_recalls(self):
        rng = np.random.default_rng(77)
        data = rng.standard_normal((800, 10)).astype(np.float32)
        idx = ShardedHnswIndex.build(data, n_shards=4, metric="l2",
                                     method="native", seed=78, devices=cpus(4))
        skew = rng.standard_normal((60, 10)).astype(np.float32)
        idx.shards[0].insert_bulk(skew, tids=range(10_000, 10_060))
        extra = rng.standard_normal((300, 10)).astype(np.float32)
        added = idx.insert_bulk(extra, tids=range(800, 1100))
        assert added == 300
        assert idx.num_tuples == 1160
        sizes = [s.num_tuples for s in idx.shards]
        assert max(sizes) - min(sizes) <= 1
        all_data = np.concatenate([data, skew, extra])
        all_tids = np.concatenate(
            [np.arange(800), np.arange(10_000, 10_060), np.arange(800, 1100)]
        )
        q = extra[:16]
        gt = all_tids[
            np.argsort(((all_data[None] - q[:, None]) ** 2).sum(-1),
                       axis=1)[:, :5]
        ]
        _, tids = idx.search(q, 5, SearchParams(ef_search=40))
        assert recall_at_k(tids, gt, 5) >= 0.9

    def test_insert_bulk_default_tids(self):
        rng = np.random.default_rng(79)
        data = rng.standard_normal((200, 6)).astype(np.float32)
        idx = ShardedHnswIndex.build(data, n_shards=2, metric="l2",
                                     method="host", seed=80, devices=cpus(2))
        extra = rng.standard_normal((40, 6)).astype(np.float32)
        idx.insert_bulk(torch.from_numpy(extra))  # a tensor, default tids
        d, tids = idx.search(extra[:8], 1, SearchParams(ef_search=40))
        got = np.asarray(tids).ravel()
        assert (got == np.arange(200, 208)).mean() >= 0.9

    def test_cosine_sharded(self):
        rng = np.random.default_rng(75)
        data = rng.standard_normal((400, 8)).astype(np.float32)
        idx = ShardedHnswIndex.build(data, n_shards=4, metric="cosine",
                                     method="native", seed=76, devices=cpus(4))
        q = rng.standard_normal((4, 8)).astype(np.float32)
        gt = brute_force(data, q, "cosine", 5)
        _, tids = idx.search(q, 5, SearchParams(ef_search=40))
        assert recall_at_k(tids, gt, 5) >= 0.9


def test_sharded_exact_engine():
    rng = np.random.default_rng(21)
    data = rng.standard_normal((600, 16)).astype(np.float32)
    idx = ShardedHnswIndex.build(data, n_shards=4, metric="l2", method="native",
                                 devices=cpus(4))
    q = data[:32]
    d, tids = idx.search(q, 5, SearchParams(ef_search=16), engine="exact")
    assert (tids[:, 0] == np.arange(32)).all()
    np.testing.assert_allclose(d[:, 0], 0.0, atol=5e-3)
    with pytest.raises(ValueError, match="engine"):
        idx.search(q, 5, engine="approx")


@pytest.mark.parametrize("engine", ["exact", "beam"])
def test_more_shards_than_rows(engine):
    """An empty shard adds no candidate: k past the rows pads with
    (inf, -1)."""
    data = np.random.default_rng(22).random((3, 4)).astype(np.float32)
    idx = ShardedHnswIndex.build(data, n_shards=4, method="host",
                                 devices=cpus(4))
    assert [s.num_tuples for s in idx.shards] == [1, 1, 1, 0]
    d, tids = idx.search(data[1], 4, engine=engine)
    assert sorted(tids[:3].tolist()) == [0, 1, 2] and tids[0] == 1
    assert tids[3] == -1 and d[3] == np.inf


class TestShardedPersistence:
    def test_save_load_equivalence(self, sharded_setup, tmp_path):
        idx, data = sharded_setup
        q = data[7] + 0.02
        d0, t0 = idx.search(q, 10, SearchParams(ef_search=40))
        idx.save(tmp_path / "ck")
        idx2 = ShardedHnswIndex.load(tmp_path / "ck", devices=idx.devices)
        assert idx2.num_tuples == idx.num_tuples
        d1, t1 = idx2.search(q, 10, SearchParams(ef_search=40))
        assert list(t1) == list(t0)
        np.testing.assert_allclose(d1, d0, rtol=1e-5)

    def test_save_load_serving_only(self, serving_shards, tmp_path):
        idx, data, _ = serving_shards
        q = data[:6]
        d0, t0 = idx.search(q, 5, SearchParams(ef_search=40))
        idx.save(tmp_path / "ck2")
        idx2 = ShardedHnswIndex.load(tmp_path / "ck2", devices=cpus(2))
        d1, t1 = idx2.search(q, 5, SearchParams(ef_search=40))
        assert t1.tolist() == t0.tolist()


class TestShardedScan:
    def test_global_order_and_exactness(self, sharded_setup):
        idx, data = sharded_setup
        q = data[5]
        scan = idx.scan(q, SearchParams(ef_search=20,
                                        iterative_scan="relaxed_order"))
        items = scan.take(50)
        dists = [d for _, d in items]
        assert dists == sorted(dists)
        d_ref, t_ref = idx.search(q, 10, SearchParams(ef_search=40))
        assert [t for t, _ in items[:5]] == list(t_ref[:5])

    def test_max_scan_tuples_caps_merged_stream(self, sharded_setup):
        idx, data = sharded_setup
        scan = idx.scan(
            data[9],
            SearchParams(ef_search=20, iterative_scan="relaxed_order",
                         max_scan_tuples=25),
        )
        assert len(scan.take(10_000)) == 25
        assert scan.scan_stats.tuples_returned >= 25

    def test_exhausts_everything(self, sharded_setup):
        idx, data = sharded_setup
        scan = idx.scan(
            data[2],
            SearchParams(ef_search=30, iterative_scan="relaxed_order",
                         max_scan_tuples=10_000),
        )
        items = scan.take(10**6)
        assert len(items) == idx.num_tuples
        assert len({t for t, _ in items}) == idx.num_tuples


class TestShardedScaleRealism:
    def test_streamed_build_input(self):
        rng = np.random.default_rng(30)
        full = rng.standard_normal((1600, 10)).astype(np.float32)
        calls = []

        def part(s, n_shards):
            calls.append(s)
            return full[s::n_shards]

        def part_ids(s, n_shards):
            return np.arange(s, 1600, n_shards)

        idx = ShardedHnswIndex.build(part, n_shards=4, metric="l2",
                                     ids=part_ids, method="native", seed=31,
                                     devices=cpus(4))
        assert calls == [0, 1, 2, 3]
        assert idx.num_tuples == 1600
        _, tids = idx.search(full[:8], 1, SearchParams(ef_search=40))
        assert (np.asarray(tids).ravel() == np.arange(8)).mean() >= 0.9

    def test_streamed_default_tids_sequential(self):
        rng = np.random.default_rng(32)
        blocks = [rng.standard_normal((50, 6)).astype(np.float32)
                  for _ in range(3)]
        idx = ShardedHnswIndex.build(lambda s, n: blocks[s], n_shards=3,
                                     metric="l2", method="host",
                                     devices=cpus(3))
        _, tids = idx.search(blocks[1][0], 1)
        assert tids[0] == 50

    def test_device_resident_build_input(self, serving_shards):
        """A tensor corpus: each shard's strided slice is built where the
        tensor lives (the device build)."""
        idx, host, corpus = serving_shards
        assert all(s.serving_only for s in idx.shards)
        q = host[:8]
        gt = brute_force(host, q, "l2", 5)
        _, tids = idx.search(q, 5, SearchParams(ef_search=40))
        assert recall_at_k(tids, gt, 5) >= 0.95
        with pytest.raises(ValueError, match="device"):
            ShardedHnswIndex.build(corpus, n_shards=2, method="native",
                                   devices=cpus(2))

    def test_shards_on_their_devices_without_host_copies(self,
                                                         serving_shards):
        """Each shard's DeviceGraph sits on its listed device, and a search
        stages no shard through host numpy (tracemalloc-bounded: numpy
        allocations are traced, tensor storage is not)."""
        idx, data, _ = serving_shards
        for shard, dev in zip(idx.shards, idx.devices):
            g = shard.device_graph()
            assert g.device == dev and g.values.device == dev
        for engine in ("exact", "beam"):
            idx.search(data[:4], 5, engine=engine)  # warm
            tracemalloc.start()
            _, tids = idx.search(data[11], 5, SearchParams(ef_search=40),
                                 engine=engine)
            _, peak = tracemalloc.get_traced_memory()
            tracemalloc.stop()
            # one shard's rows alone are 28 KiB of f32
            assert peak < 16 << 10, f"host staging detected: peak={peak}"
            assert tids[0] == 11


class TestShardedServingOnly:
    def test_device_built_serving_shards(self, serving_shards):
        idx, data, _ = serving_shards
        q = data[:8]
        gt = brute_force(data, q, "l2", 5)
        d, tids = idx.search(q, 5, SearchParams(ef_search=40))
        assert recall_at_k(tids, gt, 5) >= 0.95
        scan = idx.scan(
            data[3],
            SearchParams(ef_search=20, iterative_scan="relaxed_order",
                         max_scan_tuples=40),
        )
        items = scan.take(1000)
        assert len(items) == 40
        assert [dd for _, dd in items] == sorted(dd for _, dd in items)
        with pytest.raises(RuntimeError):
            idx.shards[0].delete([1])


class TestShardedCheckpointResume:
    def test_build_checkpoints_and_resumes(self, tmp_path):
        rng = np.random.default_rng(95)
        data = rng.standard_normal((4000, 10)).astype(np.float32)
        kw = dict(n_shards=4, metric="l2", method="native", host_graph=False,
                  seed=9, checkpoint_dir=tmp_path / "ck", devices=cpus(4))
        idx = ShardedHnswIndex.build(data, **kw)
        for s in range(4):
            assert (tmp_path / "ck" / f"shard_{s:05d}" / "meta.json").exists()
        assert (tmp_path / "ck" / "sharded.json").exists()
        assert not (tmp_path / "ck" / "sharded.json.tmp").exists()
        q = rng.standard_normal((16, 10)).astype(np.float32)
        d1, t1 = idx.search(q, 5, SearchParams(ef_search=40))
        idx2 = ShardedHnswIndex.build(data, **kw)
        d2, t2 = idx2.search(q, 5, SearchParams(ef_search=40))
        assert np.array_equal(t1, t2)
        shutil.rmtree(tmp_path / "ck" / "shard_00002")
        idx3 = ShardedHnswIndex.build(data, **kw)
        d3, t3 = idx3.search(q, 5, SearchParams(ef_search=40))
        assert np.array_equal(t1, t3)

    def test_streamed_resume_needs_callable_ids(self, tmp_path):
        rng = np.random.default_rng(96)
        data = rng.standard_normal((2000, 8)).astype(np.float32)

        def part(s, n_shards):
            return data[s::n_shards]

        kw = dict(n_shards=2, metric="l2", method="native", host_graph=False,
                  seed=9, checkpoint_dir=tmp_path / "ck", devices=cpus(2))
        ShardedHnswIndex.build(part, **kw)
        with pytest.raises(ValueError, match="callable ids"):
            ShardedHnswIndex.build(part, **kw)


def test_sharded_compact_values(rng, monkeypatch):
    """tests/test_serve_dtype.py's sharded case: the bf16 serve dtype
    survives in every shard's graph (2 bytes a value on each device)."""
    monkeypatch.setenv("PGV_SERVE_DTYPE", "bf16")
    data = rng.standard_normal((800, 12)).astype(np.float32)
    idx = ShardedHnswIndex.build(data, n_shards=4, metric="l2",
                                 method="native", seed=44, devices=cpus(4))
    for shard in idx.shards:
        assert shard.device_graph().values.dtype == torch.bfloat16
    _, tids = idx.search(data[9], 5, SearchParams(ef_search=40))
    assert tids[0] == 9


def test_sharded_filter_exact_and_beam():
    """tests/test_filter.py's sharded case: the tid-keyed mask pre-filters
    the exact sweep (recall 1.0 over the subset) and post-filters the
    beam."""
    rng = np.random.default_rng(21)
    data = rng.random((800, 12)).astype(np.float32)
    queries = rng.random((10, 12)).astype(np.float32)
    idx = ShardedHnswIndex.build(data, n_shards=4, metric="l2",
                                 method="native", seed=5, devices=cpus(4))
    mask = (np.arange(len(data)) % 6) == 0
    k = 5
    _, ids = idx.search(queries, k, engine="exact", filter_mask=mask)
    keep = np.nonzero(mask)[0]
    gt = keep[brute_force(data[keep], queries, "l2", k)]
    assert recall_at_k(ids, gt, k) == 1.0
    assert all(mask[i] for row in ids for i in row if i >= 0)
    _, ids_b = idx.search(queries, k, SearchParams(ef_search=60),
                          engine="beam", filter_mask=mask)
    assert all(mask[i] for row in ids_b for i in row if i >= 0)
    _, ids_u = idx.search(queries, k, engine="exact")
    assert recall_at_k(ids_u, brute_force(data, queries, "l2", k), k) == 1.0
    for engine in ("exact", "beam"):  # an empty mask keeps no tid
        d, ids = idx.search(queries, k, engine=engine,
                            filter_mask=np.zeros(0, bool))
        assert (ids == -1).all() and np.isinf(d).all()


# ---------------------------------------------------------------------------
# the port held to the JAX package
# ---------------------------------------------------------------------------

#: (engine, filtered) of the JAX sharded searches made per metric (each an
#: XLA compile on 8 virtual devices: three in all). A mask that keeps every
#: tid gives JAX's unfiltered result.
_JAX_ENGINES = {"l2": ("beam", "exact"), "cosine": ("beam",)}
_N, _DIM, _K = 2000, 16, 10


_EPS = 2.0 ** -23


def _equal_but_for_ties(t_a, d_a, t_b, d_b, atol=1e-7):
    """Distances within rel 1e-5 (and ``atol``); ids equal but where a
    row's neighbouring distance ties (or at the k-th place)."""
    np.testing.assert_allclose(d_a, d_b, rtol=1e-5, atol=atol)
    for r, c in zip(*np.nonzero(t_a != t_b)):
        near = [d_b[r, j] for j in (c - 1, c + 1) if 0 <= j < d_b.shape[1]]
        assert c == d_b.shape[1] - 1 or any(
            abs(d_b[r, c] - x) <= 1e-5 * abs(x) + atol for x in near), (
            f"row {r} place {c}: {t_a[r, c]} vs {t_b[r, c]}")


def _held(c, engine, t, d, rt, rd):
    """``_equal_but_for_ties`` where f32 rounding leaves its mark: cosine's
    1 - q.x is exact to a few ulps of 1 (8 allowed); JAX's exact l2 is
    q2 + x2 - 2 q.x in one f32 expression, exact to a few ulps of
    q2 + x2, so the squared distances are compared with 8 ulps of the
    largest q2 + x2."""
    if c.metric == "cosine":
        _equal_but_for_ties(t, d, rt, rd, atol=8 * _EPS)
    elif engine == "exact":
        scale = float((c.q ** 2).sum(1).max() + (c.data ** 2).sum(1).max())
        _equal_but_for_ties(t, d ** 2, rt, rd ** 2, atol=8 * _EPS * scale)
    else:
        _equal_but_for_ties(t, d, rt, rd)


@pytest.fixture(scope="module", params=["l2", "cosine"])
def carried(request, tmp_path_factory):
    """A JAX ShardedHnswIndex (4 native host-graph shards) saved and loaded
    by the port, with JAX's searches of 16 queries at k = 10."""
    metric = request.param
    rng = np.random.default_rng(81)
    data = rng.standard_normal((_N, _DIM)).astype(np.float32)
    q = data[:16] + 0.05 * rng.standard_normal((16, _DIM)).astype(np.float32)
    jidx = JShardedHnswIndex.build(data, n_shards=4, metric=metric,
                                   method="native", seed=5)
    path = tmp_path_factory.mktemp(f"carried_{metric}") / "ck"
    jidx.save(path)
    tidx = ShardedHnswIndex.load(path, devices=cpus(4))
    masks = {"unfiltered": np.ones(_N, bool),
             "filtered": np.arange(_N) % 3 != 0}
    ref = {(e, f): jidx.search(q, _K, JSearchParams(ef_search=40), engine=e,
                               filter_mask=masks[f])
           for e in _JAX_ENGINES[metric] for f in masks}
    return SimpleNamespace(metric=metric, data=data, q=q, jidx=jidx,
                           tidx=tidx, masks=masks, ref=ref)


def _ref(c, engine, filt):
    """JAX's result, or for an engine JAX is not asked for here (cosine
    exact) the float64 brute force over the kept rows."""
    if (engine, filt) in c.ref:
        return c.ref[(engine, filt)]
    keep = np.nonzero(c.masks[filt])[0]
    gt = keep[brute_force(c.data[keep], c.q, c.metric, _K)]
    d = np.stack([brute_force_dists(c.data[gt[b]], c.q[b], c.metric)
                  for b in range(len(c.q))])
    return d, gt


def brute_force_dists(rows, q, metric):
    rows, q = rows.astype(np.float64), q.astype(np.float64)
    if metric == "cosine":
        return 1.0 - (rows @ q) / (np.linalg.norm(rows, axis=1)
                                   * np.linalg.norm(q))
    return np.sqrt(((rows - q) ** 2).sum(1))


@pytest.mark.parametrize("k", [1, _K])
@pytest.mark.parametrize("engine,filt", [("beam", "unfiltered"),
                                         ("beam", "filtered"),
                                         ("exact", "unfiltered"),
                                         ("exact", "filtered")])
def test_search_equals_jax(carried, engine, filt, k):
    """The port's sharded search of a JAX sharded checkpoint equals JAX's:
    ids but for ties, distances to rel 1e-5 (k = 1: the first of JAX's
    k = 10, since the merge is one stable sort)."""
    c = carried
    fm = None if filt == "unfiltered" else c.masks[filt]
    d, t = c.tidx.search(c.q, k, SearchParams(ef_search=40), engine=engine,
                         filter_mask=fm)
    rd, rt = _ref(c, engine, filt)
    assert d.dtype == np.float64 and t.dtype == np.int64
    assert d.shape == t.shape == (len(c.q), k)
    if filt == "filtered":
        assert (t % 3 != 0).all()
    _held(c, engine, t, d, rt[:, :k], rd[:, :k])


@pytest.mark.parametrize("engine", ["beam", "exact"])
def test_single_query_equals_jax(carried, engine):
    c = carried
    d, t = c.tidx.search(c.q[3], _K, SearchParams(ef_search=40),
                         engine=engine)
    assert d.shape == t.shape == (_K,)
    rd, rt = _ref(c, engine, "unfiltered")
    _held(c, engine, t[None], d[None], rt[3:4], rd[3:4])


def test_beam_search_arrays_equals_jax(carried):
    """Module 1: one shard's beam (the descent from its own entry, then the
    layer-0 walk) equals the JAX package's ``beam_search_arrays``."""
    c = carried
    shard = c.jidx.shards[1]
    jg = shard.device_graph()
    tg = c.tidx.shards[1].device_graph()
    q = c.q if c.metric == "l2" else c.q / np.linalg.norm(c.q, axis=1,
                                                          keepdims=True)
    lmax = jg.upper_neighbors.shape[1] // jg.m
    fn = jax.jit(jdevice.beam_search_arrays,
                 static_argnames=("metric", "ef", "lmax", "max_steps"))
    jd, jids = fn(jg.values, jg.neighbors0, jg.upper_neighbors,
                  jg.upper_slot, jg.traversable, jnp.int32(jg.entry),
                  jnp.int32(jg.entry_level), jnp.asarray(q),
                  metric=c.metric, ef=40, lmax=lmax, max_steps=192)
    td, tids = tdevice.beam_search_arrays(
        tg.values, tg.neighbors0, tg.upper_neighbors, tg.upper_slot,
        tg.traversable, tg.entry, tg.entry_level, torch.from_numpy(q),
        metric=c.metric, ef=40, m=tg.m, max_steps=192)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=8 * _EPS if c.metric == "cosine" else 0)


def test_port_checkpoint_loads_in_jax(carried, tmp_path):
    """A sharded index the port builds (its native engine) and saves loads
    in the JAX package (on the carried index's mesh) and searches alike."""
    c = carried
    rng = np.random.default_rng(82)
    data = rng.standard_normal((_N, _DIM)).astype(np.float32)
    tidx = ShardedHnswIndex.build(data, n_shards=4, metric=c.metric,
                                  method="native", seed=6, devices=cpus(4))
    tidx.save(tmp_path / "ck")
    jidx = JShardedHnswIndex.load(tmp_path / "ck", mesh=c.jidx.mesh)
    assert jidx.num_tuples == tidx.num_tuples == _N
    jd, jt = jidx.search(c.q, _K, JSearchParams(ef_search=40), engine="beam",
                         filter_mask=c.masks["unfiltered"])
    td, tt = tidx.search(c.q, _K, SearchParams(ef_search=40), engine="beam")
    _held(c, "beam", tt, td, np.asarray(jt), np.asarray(jd))


def test_sharded_scan_equals_jax(carried):
    """ShardedScan's merged stream (host-graph shards: HnswScan each)
    equals the JAX package's on the carried index."""
    c = carried
    kw = dict(ef_search=20, iterative_scan="relaxed_order",
              max_scan_tuples=60)
    got = c.tidx.scan(c.q[0], SearchParams(**kw)).take(100)
    want = c.jidx.scan(c.q[0], JSearchParams(**kw)).take(100)
    assert len(got) == len(want) == 60
    assert [t for t, _ in got] == [t for t, _ in want]
    np.testing.assert_allclose([d for _, d in got], [d for _, d in want],
                               rtol=1e-5, atol=8 * _EPS)


def test_beam_switches_leave_the_sharded_beam_alone(carried, monkeypatch):
    """JAX's ``beam_search_arrays`` reads no PGV_BEAM_* switch: with E = 4,
    bf16 ranking and the visited bitmap set, the single index's walk changes
    but the sharded beam does not."""
    c = carried
    params = SearchParams(ef_search=40)
    d0, t0 = c.tidx.search(c.q, _K, params, engine="beam")
    g = c.tidx.shards[0].device_graph()
    qn = torch.from_numpy(c.q) if c.metric == "l2" else \
        torch.nn.functional.normalize(torch.from_numpy(c.q), dim=1)
    steps0 = tdevice._search_batch(g, qn, 40, g.entry_level, 192)[2]
    monkeypatch.setenv("PGV_BEAM_EXPAND", "4")
    monkeypatch.setattr(tdevice, "_BEAM_BF16", True)
    monkeypatch.setattr(tdevice, "_VISITED_MAX_ROWS", 1 << 30)
    steps1 = tdevice._search_batch(g, qn, 40, g.entry_level, 192,
                                   tdevice._beam_expand())[2]
    assert (steps1 < steps0).any()  # the switches are live for _search_batch
    d1, t1 = c.tidx.search(c.q, _K, params, engine="beam")
    np.testing.assert_array_equal(t1, t0)
    np.testing.assert_array_equal(d1, d0)
    rd, rt = c.ref[("beam", "unfiltered")]
    _held(c, "beam", t1, d1, rt, rd)


@pytest.mark.parametrize("sizes", [[10, 10, 10, 10], [70, 0, 5, 5],
                                   [3, 9, 1, 1, 1, 7, 2, 0], [0]])
@pytest.mark.parametrize("n", [1, 5, 37, 300])
def test_water_fill_equals_jax(sizes, n):
    """``insert_bulk``'s allocation equals the JAX package's for the same
    shard sizes (its insert_bulk driven over stand-in shards)."""

    class Stub:
        def __init__(self, size):
            self.num_tuples, self.got = size, 0

        def insert_bulk(self, arr, tids):
            self.got = len(arr)
            return len(arr)

    jidx = object.__new__(JShardedHnswIndex)
    jidx.shards = [Stub(s) for s in sizes]
    jidx.insert_bulk(np.zeros((n, 2), np.float32), tids=range(n))
    want = [s.got for s in jidx.shards]
    got = sharded._water_fill(sizes, n)
    assert got.tolist() == want and sum(want) == n


def test_dryrun_multichip_on_cpu():
    sharded.dryrun_multichip(2, devices=cpus(2))


# ---------------------------------------------------------------------------
# on the card: 4 shards on cuda:0
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card_index():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(40)
    data = rng.standard_normal((40_000, 32)).astype(np.float32)
    corpus = torch.from_numpy(data).cuda()
    idx = ShardedHnswIndex.build(corpus, n_shards=4, metric="l2",
                                 method="device", host_graph=False, seed=41,
                                 devices=["cuda:0"] * 4)
    q = data[:256] + 0.1 * rng.standard_normal((256, 32)).astype(np.float32)
    return idx, corpus, q


@pytest.mark.cuda
def test_card_exact_equals_k1_over_the_union(card_index):
    from pgvector_rx_tpu_torch.ops import bruteforce as bf

    idx, corpus, q = card_index
    for shard in idx.shards:
        assert shard.device_graph().device.type == "cuda"
    bf.reset_launches()
    d, t = idx.search(q, _K, engine="exact")
    assert bf.LAUNCHES["k1_topk"] >= 4
    rd, rt = bf.l2_topk(corpus, torch.from_numpy(q).cuda(), _K)
    # K1's squared distances are a - 2 q.x + q2 in f32: exact to a few
    # ulps of the largest q2 + x2 (as JAX's, ``_held``)
    scale = float((q ** 2).sum(1).max() + (corpus ** 2).sum(1).max())
    _equal_but_for_ties(t, d ** 2, rt.cpu().numpy(),
                        rd.double().cpu().numpy(), atol=8 * _EPS * scale)


@pytest.mark.cuda
def test_card_beam_equals_the_plain_merge(card_index):
    """The sharded beam (one K4 launch a shard) equals the same merge over
    each shard's plain descent and walk, but for ties."""
    from pgvector_rx_tpu_torch.ops import beam

    idx, _, q = card_index
    ef = 40
    d, t = idx.search(q, _K, SearchParams(ef_search=ef), engine="beam")
    parts = []
    for shard in idx.shards:
        g = shard.device_graph()
        qd = torch.from_numpy(q).to(g.device)
        land, land_d = beam.descent_plain(
            g.values, g.traversable, g.upper_slot, g.upper_neighbors, g.m,
            g.metric, qd, g.entry, g.entry_level)
        raw = beam._walk_plain(g.values, g.neighbors0, g.traversable, None,
                               g.metric, qd, land[:, None].to(torch.int32),
                               land_d[:, None], width=ef, spill=0,
                               max_steps=4 * ef + 32, scan=False)
        pd, pids, _ = beam._serve_finish(*raw)
        tids = torch.where(pids >= 0, g.emit_tid[pids.clamp(min=0)].long(),
                           -1)
        parts.append((torch.where(tids >= 0, pd, float("inf")), tids))
    pd, pt = sharded._merge(parts, _K, idx.devices[0])
    pd = torch.sqrt(pd.clamp(min=0)).double().cpu().numpy()
    _equal_but_for_ties(t, d, pt.cpu().numpy(), pd)
