"""The port's flat index (index/flat.py), distance ops (ops/distances.py,
ops/bits.py), cost model (index/cost.py) and access-method facade
(index/access_method.py) against the JAX package's, on the same numpy
inputs: the port's versions of tests/test_flat.py (dense and bit cases;
the sparse ones in tests/test_torch_sparse_index.py), tests/test_cost_am.py and
the dense and bit classes of tests/test_ops.py."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from pgvector_rx_tpu.index import access_method as jam
from pgvector_rx_tpu.index import cost as jcost
from pgvector_rx_tpu.index.flat import FlatIndex as JFlat
from pgvector_rx_tpu.index.hnsw import HnswIndex as JaxIndex
from pgvector_rx_tpu.ops import bits as jbits
from pgvector_rx_tpu.ops import distances as jdist
from pgvector_rx_tpu.types import bitvec, vector
from pgvector_rx_tpu_torch import HnswIndex
from pgvector_rx_tpu_torch.index import access_method, cost
from pgvector_rx_tpu_torch.index.flat import FlatIndex
from pgvector_rx_tpu_torch.ops import bits, distances

torch.set_num_threads(1)

CPU = dict(device="cpu")


# ---------------------------------------------------------------------------
# tests/test_flat.py
# ---------------------------------------------------------------------------


class TestFlat:
    def test_exact_l2(self, rng):
        data = rng.random((500, 16)).astype(np.float32)
        idx = FlatIndex.build(data, metric="l2", **CPU)
        q = data[123]
        d, ids = idx.search(q, 5)
        assert ids[0] == 123
        assert d[0] == pytest.approx(0.0, abs=1e-6)
        true = np.argsort(((data - q) ** 2).sum(1))[:5]
        assert set(ids) == set(true)

    def test_delete(self, rng):
        data = rng.random((50, 8)).astype(np.float32)
        idx = FlatIndex.build(data, metric="l2", **CPU)
        assert idx.delete([10]) == 1
        _, ids = idx.search(data[10], 1)
        assert ids[0] != 10

    def test_sparse_flat_waits_for_item_15(self, rng):
        """Item 15 is ported: tests/test_flat.py's sparse cases (l2 over
        1,000-d rows against the dense exact order, cosine at 64-d)."""
        from pgvector_rx_tpu_torch.types import SparseVec

        rows = []
        for _ in range(80):
            dense = rng.standard_normal(1000).astype(np.float32)
            dense[rng.random(1000) < 0.95] = 0.0
            rows.append(SparseVec.from_dense(dense))
        idx = FlatIndex.build(rows, metric="l2", kind="sparse", **CPU)
        d, ids = idx.search(rows[11], 3)
        assert ids[0] == 11
        assert d[0] == pytest.approx(0.0, abs=1e-5)
        densified = np.stack([r.to_dense() for r in rows])
        true = np.argsort(((densified - densified[11]) ** 2).sum(1))[:3]
        assert set(ids) == set(true)
        rows = []
        for _ in range(40):
            dense = rng.standard_normal(64).astype(np.float32)
            dense[rng.random(64) < 0.7] = 0.0
            rows.append(SparseVec.from_dense(dense))
        idx = FlatIndex.build(rows, metric="cosine", kind="sparse", **CPU)
        d, ids = idx.search(rows[5], 2)
        assert ids[0] == 5
        assert d[0] == pytest.approx(0.0, abs=1e-5)

    def test_bit_flat(self, rng):
        b = rng.integers(0, 2, size=(100, 32)).astype(np.uint8)
        idx = FlatIndex.build(b, metric="hamming", kind="bit", **CPU)
        d, ids = idx.search(b[7], 1)
        assert ids[0] == 7 and d[0] == 0.0

    def test_planner_integration(self, rng):
        small = HnswIndex(4, metric="l2", **CPU)
        small.add_batch(rng.random((20, 4)).astype(np.float32))
        assert not cost.should_use_index(small, True, 40)

    def test_empty_and_short(self, rng):
        idx = FlatIndex("dense", "l2", 4, **CPU)
        d, ids = idx.search(np.zeros(4, np.float32), 3)
        assert (ids == -1).all() and np.isinf(d).all()
        idx = FlatIndex.build(rng.random((2, 4)).astype(np.float32), **CPU)
        d, ids = idx.search(rng.random((3, 4)).astype(np.float32), 5)
        assert (ids[:, 2:] == -1).all() and np.isinf(d[:, 2:]).all()
        assert (ids[:, :2] >= 0).all()


@pytest.mark.parametrize("kind,metric", [
    ("dense", "l2"), ("dense", "ip"), ("dense", "cosine"), ("dense", "l1"),
    ("bit", "hamming"), ("bit", "jaccard")])
def test_flat_search_equals_jax(kind, metric):
    """The same rows, ids and queries: the JAX flat index's ids and
    distances. Bit distances are equal exactly and in the JAX tie order
    (lower id first); l1 too (the l1 sweep orders ties by id); dense
    distances to f32 rounding, ids but for near ties."""
    rng = np.random.default_rng(len(metric))
    if kind == "bit":
        data = (rng.random((400, 40)) < 0.2).astype(np.uint8)
        q = data[:12]
    else:
        data = (rng.integers(-8, 9, (400, 12)) / 4.0).astype(np.float32)
        q = data[:12] + (0.5 if metric != "l1" else 0.0)
    tids = np.arange(1000, 1400)
    t = FlatIndex.build(data, metric=metric, kind=kind, ids=tids, **CPU)
    j = JFlat.build(data, metric=metric, kind=kind, ids=tids)
    td, ti = t.search(q, 15)
    jd, ji = j.search(q, 15)
    if kind == "bit" or metric == "l1":
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(ti, ji)
        return
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    for r in range(len(q)):
        inner = jd[r] < jd[r, -1] - 1e-4
        assert set(ti[r][inner]) <= set(ji[r]), r


# ---------------------------------------------------------------------------
# tests/test_cost_am.py
# ---------------------------------------------------------------------------


class TestCost:
    @pytest.fixture(scope="class")
    def idx(self):
        rng = np.random.default_rng(0)
        i = HnswIndex(8, metric="l2", **CPU)
        i.add_batch(rng.random((200, 8)).astype(np.float32))
        return i

    def test_no_order_by_infinite(self, idx):
        c = cost.estimate(idx, has_order_by=False, ef_search=40)
        assert math.isinf(c.total_cost)
        assert c.selectivity == 0.0

    def test_ratio_bounds(self, idx):
        r = cost.traversal_ratio(float(idx.num_tuples), 16, 40)
        assert 0.0 < r <= 1.0
        assert cost.traversal_ratio(1e6, 16, 40) < cost.traversal_ratio(
            1e3, 16, 40)
        for n in (0.0, 1.0, 200.0, 1e3, 1e6, 1e9):
            for m, ef in ((4, 1), (16, 40), (48, 400)):
                assert cost.traversal_ratio(n, m, ef) == \
                    jcost.traversal_ratio(n, m, ef)

    def test_index_beats_seqscan_when_large(self):
        big = HnswIndex(8, metric="l2", **CPU)
        big.elements = []
        big.heap_tids = [[i] for i in range(100000)]
        assert cost.should_use_index(big, True, 40)
        jbig = JaxIndex(8, metric="l2")
        jbig.heap_tids = big.heap_tids
        assert dataclasses.astuple(cost.estimate(big, True, 40)) == \
            dataclasses.astuple(jcost.estimate(jbig, True, 40))

    def test_empty_index_full_ratio(self):
        assert cost.traversal_ratio(0.0, 16, 40) == 1.0


class TestAccessMethod:
    def test_capability_flags(self):
        caps = access_method.AM_CAPABILITIES
        assert caps == jam.AM_CAPABILITIES
        assert caps["amcanorderbyop"] is True
        assert caps["amcanparallel"] is False
        assert caps["amgetbitmap"] is False

    def test_all_14_opclasses_registered(self):
        assert len(access_method.OPERATOR_CLASSES) == 14
        assert {k: (v.kind, v.metric, v.operator, v.dtype, v.has_norm_proc)
                for k, v in access_method.OPERATOR_CLASSES.items()} == \
            {k: (v.kind, v.metric, v.operator, v.dtype, v.has_norm_proc)
             for k, v in jam.OPERATOR_CLASSES.items()}
        assert access_method.validate_opclass("vector_cosine_ops")
        assert not access_method.validate_opclass("nonexistent_ops")

    def test_cosine_opclasses_have_norm_proc(self):
        for name, oc in access_method.OPERATOR_CLASSES.items():
            assert oc.has_norm_proc == ("cosine" in name)

    def test_create_from_opclass(self):
        idx = access_method.create_index_for_opclass("halfvec_ip_ops", 16,
                                                     **CPU)
        assert isinstance(idx, HnswIndex) and idx.device.type == "cpu"
        assert idx.metric == "ip"
        assert idx.dtype == np.float16
        idx2 = access_method.create_index_for_opclass("bit_jaccard_ops", 64,
                                                      **CPU)
        assert idx2.kind == "bit"
        with pytest.raises(ValueError, match="does not exist"):
            access_method.create_index_for_opclass("nope_ops", 4, **CPU)

    def test_phase_name(self):
        assert access_method.build_phase_name(2) == "loading tuples"
        assert access_method.build_phase_name(1) is None


@pytest.mark.parametrize("name", [n for n, oc in
                                  access_method.OPERATOR_CLASSES.items()
                                  if oc.kind != "sparse"])
def test_every_dense_and_bit_opclass_answers(name):
    """Each dense and bit operator class makes an index that takes rows
    and answers a query through the device engines, as JAX's does."""
    rng = np.random.default_rng(9)
    oc = access_method.OPERATOR_CLASSES[name]
    if oc.kind == "bit":
        rows = (rng.random((120, 24)) < 0.5).astype(np.uint8)
    else:
        rows = rng.standard_normal((120, 24)).astype(np.float32)
    out = []
    for mod, kw in ((access_method, CPU), (jam, {})):
        idx = mod.create_index_for_opclass(name, 24, **kw)
        idx.add_batch(rows)
        out.append(idx.search(rows[:4], 3, method="exact"))
    (td, ti), (jd, ji) = out
    np.testing.assert_array_equal(ti[:, 0], np.arange(4))
    np.testing.assert_array_equal(ti[:, 0], ji[:, 0])
    if oc.metric == "l2":  # operator distances: compare their squares,
        td, jd = td ** 2, jd ** 2  # where the f32 cancellation is absolute
    np.testing.assert_allclose(td, jd, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# tests/test_ops.py: the dense and bit classes
# ---------------------------------------------------------------------------

_SCALAR = {"l2": vector.l2_squared_distance,
           "ip": vector.negative_inner_product,
           "cosine": vector.cosine_distance, "l1": vector.l1_distance}


class TestDenseDistances:
    @pytest.mark.parametrize("metric", ["l2", "ip", "cosine", "l1"])
    def test_pairwise_matches_scalar_and_jax(self, metric, rng):
        base = rng.standard_normal((50, 16)).astype(np.float32)
        queries = rng.standard_normal((7, 16)).astype(np.float32)
        if metric == "cosine":
            base /= np.linalg.norm(base, axis=1, keepdims=True)
            queries /= np.linalg.norm(queries, axis=1, keepdims=True)
        got = distances.pairwise(metric, torch.from_numpy(base),
                                 torch.from_numpy(queries)).numpy()
        rel = 2e-3 if metric == "l2" else 1e-4
        for b in range(7):
            for n in range(0, 50, 7):
                assert got[b, n] == pytest.approx(
                    _SCALAR[metric](queries[b], base[n]), rel=rel, abs=1e-5)
        np.testing.assert_allclose(
            got, np.asarray(jdist.pairwise(metric, base, queries)),
            rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("metric", ["l2", "ip", "cosine", "l1"])
    def test_gathered_matches_scalar_and_jax(self, metric, rng):
        base = rng.standard_normal((50, 16)).astype(np.float32)
        queries = rng.standard_normal((4, 16)).astype(np.float32)
        if metric == "cosine":
            base /= np.linalg.norm(base, axis=1, keepdims=True)
            queries /= np.linalg.norm(queries, axis=1, keepdims=True)
        ids = rng.integers(0, 50, size=(4, 9)).astype(np.int32)
        got = distances.gathered(metric, torch.from_numpy(base),
                                 torch.from_numpy(ids),
                                 torch.from_numpy(queries)).numpy()
        for b in range(4):
            for k in range(9):
                assert got[b, k] == pytest.approx(
                    _SCALAR[metric](queries[b], base[ids[b, k]]), rel=1e-5,
                    abs=1e-6)
        np.testing.assert_allclose(
            got, np.asarray(jdist.gathered(metric, base, ids, queries)),
            rtol=1e-5, atol=1e-6)

    def test_operator_conversions_and_norms(self, rng):
        x = rng.standard_normal((5, 6)).astype(np.float32)
        x[2] = 0.0
        t = torch.from_numpy(x)
        np.testing.assert_allclose(distances.normalize_rows(t).numpy(),
                                   np.asarray(jdist.normalize_rows(x)),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(distances.row_norms(t).numpy(),
                                   np.asarray(jdist.row_norms(x)), rtol=1e-6)
        d = torch.tensor([0.0, 4.0, 9.0])
        for metric in ("l2", "ip", "cosine", "l1"):
            op = distances.order_to_operator_distance(metric, d)
            np.testing.assert_allclose(
                op.numpy(), np.asarray(
                    jdist.order_to_operator_distance(metric, d.numpy())))
            np.testing.assert_allclose(
                distances.operator_to_order_distance(metric, op).numpy(),
                d.numpy())


class TestBitDistances:
    @pytest.mark.parametrize("metric", ["hamming", "jaccard"])
    def test_matches_scalar(self, metric, rng):
        nbits = 77
        base_bits = rng.integers(0, 2, size=(30, nbits))
        query_bits = rng.integers(0, 2, size=(5, nbits))
        bw = bits.as_words(bits.pack_bits(base_bits))
        qw = bits.as_words(bits.pack_bits(query_bits))
        got = bits.pairwise(metric, bw, qw).numpy()
        scalar = (bitvec.hamming_distance if metric == "hamming"
                  else bitvec.jaccard_distance)
        for b in range(5):
            for n in range(0, 30, 7):
                assert got[b, n] == pytest.approx(
                    scalar(query_bits[b], base_bits[n]))

    def test_pack_roundtrip(self, rng):
        b = rng.integers(0, 2, size=(3, 100))
        assert np.array_equal(bits.unpack_bits(bits.pack_bits(b), 100), b)
        np.testing.assert_array_equal(bits.pack_bits(b), jbits.pack_bits(b))

    def test_gathered(self, rng):
        base_bits = rng.integers(0, 2, size=(30, 64))
        query_bits = rng.integers(0, 2, size=(4, 64))
        bw = bits.as_words(bits.pack_bits(base_bits))
        qw = bits.as_words(bits.pack_bits(query_bits))
        ids = rng.integers(0, 30, size=(4, 6)).astype(np.int32)
        allp = bits.pairwise("jaccard", bw, qw).numpy()
        got = bits.gathered("jaccard", bw, torch.from_numpy(ids), qw).numpy()
        np.testing.assert_allclose(got, np.take_along_axis(allp, ids, axis=1),
                                   rtol=1e-6)
