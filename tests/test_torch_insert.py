"""The port's batched device insert (``HnswIndex.insert_bulk``,
``graph/device_build.bulk_insert``) against the JAX package's: the same
start data, seed and insert rows in both packages, both grown graphs
served by the port's own beam engine; then the insert cases of
tests/test_device_build.py, tests/test_device_input.py and
tests/test_index.py on the port alone, with their floors."""

import numpy as np
import pytest
import torch

from pgvector_rx_tpu.config import IndexParams
from pgvector_rx_tpu.index.hnsw import HnswIndex as JaxIndex
from pgvector_rx_tpu_torch import HnswIndex as TorchIndex
from pgvector_rx_tpu_torch.config import SearchParams as TSearchParams
from pgvector_rx_tpu_torch.data import make_dataset
from pgvector_rx_tpu_torch.graph import device as tdev

from test_index import brute_force, recall_at_k
from test_torch_device_build import (_beam_recall, _carry, _check_invariants,
                                     _overlap, _tparams)

torch.set_num_threads(1)

K, NQ = 10, 200


def _grow(pkg, data, n0, params, seed):
    """A serving-only device build of the first n0 rows grown by
    insert_bulk with the rest."""
    kw = {} if pkg is JaxIndex else dict(device="cpu")
    p = params if pkg is JaxIndex else _tparams(params)
    idx = pkg.build(data[:n0], metric="l2", params=p, method="device",
                    seed=seed, host_graph=False, **kw)
    added = idx.insert_bulk(data[n0:], tids=range(n0, len(data)))
    assert added == len(data) - n0
    return idx


def test_insert_matches_jax():
    """Invariants of the grown graph, beam recall@10 at ef=40 within 0.005
    of the JAX insert's on the same data, and the layer-0 overlap of the
    two grown graphs (reported: the two builders break ties apart)."""
    data, queries = make_dataset(2000, 16, NQ, seed=31, n_clusters=30)
    params = IndexParams(m=8, ef_construction=32)
    j = _carry(_grow(JaxIndex, data, 1500, params, seed=3))
    t = _grow(TorchIndex, data, 1500, params, seed=3)
    g = t.device_graph()
    _check_invariants(g, 8, 2000)
    assert g.tid_count.sum() == 2000 and t.num_tuples == 2000
    _, gt = tdev.serve_topk(t, queries, K, engine="exact")
    r_t, r_j = _beam_recall(t, queries, gt), _beam_recall(j, queries, gt)
    overlap = _overlap(j.device_graph(), g, 2000)
    print(f"beam recall port {r_t:.4f} jax {r_j:.4f}, layer-0 overlap "
          f"{overlap:.4f}")
    assert abs(r_t - r_j) <= 0.005, (r_t, r_j)
    assert r_t >= 0.9
    assert overlap >= 0.9


class TestBulkInsert:
    def test_insert_recall(self):
        rng = np.random.default_rng(60)
        base = rng.standard_normal((1000, 12)).astype(np.float32)
        extra = rng.standard_normal((1000, 12)).astype(np.float32)
        idx = TorchIndex.build(base, metric="l2", method="device", seed=61,
                               device="cpu")
        added = idx.insert_bulk(extra)
        assert added == 1000
        assert len(idx.elements) == 2000
        data = np.concatenate([base, extra])
        q = rng.standard_normal((20, 12)).astype(np.float32)
        gt = brute_force(data, q, "l2", 10)
        _, ids = idx.search(q, 10, TSearchParams(ef_search=40), method="host")
        assert recall_at_k(ids, gt, 10) >= 0.97

    def test_duplicate_folding_into_existing(self):
        rng = np.random.default_rng(64)
        base = rng.standard_normal((300, 6)).astype(np.float32)
        idx = TorchIndex.build(base, metric="l2", method="device", seed=65,
                               device="cpu")
        # re-insert copies of existing rows: TIDs fold, no new elements
        added = idx.insert_bulk(base[:40].copy(), tids=range(1000, 1040))
        assert added == 0
        assert idx.num_tuples == 340
        assert all(len(t) == 2 for t in idx.heap_tids[:40])

    def test_entry_promotion_and_empty_index(self):
        rng = np.random.default_rng(66)
        idx = TorchIndex(8, metric="l2", device="cpu")
        idx.insert_bulk(rng.standard_normal((500, 8)).astype(np.float32))
        assert idx.entry is not None
        assert idx.count == 500
        lev = max(e.level for e in idx.elements)
        assert idx.elements[idx.entry].level == lev

    def test_serving_only_bulk_insert(self):
        rng = np.random.default_rng(69)
        base = rng.standard_normal((500, 8)).astype(np.float32)
        idx = TorchIndex.build(base, metric="l2", method="device",
                               host_graph=False, device="cpu")
        extra = rng.standard_normal((100, 8)).astype(np.float32)
        idx.insert_bulk(extra, tids=range(500, 600))
        data = np.concatenate([base, extra])
        q = extra[:10]
        gt = brute_force(data, q, "l2", 5)
        _, ids = idx.search(q, 5, TSearchParams(ef_search=40))
        assert recall_at_k(ids, gt, 5) >= 0.95

    def test_tensor_input_serving_only_stays_device_backed(self):
        """A tensor insert into a store backed by the build's tensor moves
        no row to the host, and serves like the numpy insert."""
        rng = np.random.default_rng(98)
        data = rng.standard_normal((300, 12)).astype(np.float32)
        extra = rng.standard_normal((60, 12)).astype(np.float32)
        idx = TorchIndex.build(torch.from_numpy(data), metric="l2",
                               host_graph=False, seed=6, device="cpu")
        ref = TorchIndex.build(data, metric="l2", method="device",
                               host_graph=False, seed=6, device="cpu")
        assert idx.insert_bulk(torch.from_numpy(extra)) == 60
        ref.insert_bulk(extra)
        assert idx.store._device_rows is not None  # still no host copy
        assert idx.store.count == 360
        gi, gr = idx.device_graph(), ref.device_graph()
        assert torch.equal(gi.neighbors0, gr.neighbors0)
        np.testing.assert_array_equal(idx.store.rows[:360],
                                      ref.store.rows[:360])


class TestMixedWorkload:
    """016_hnsw_inserts analog (tests/test_index.py): interleaved
    insert_bulk / delete / vacuum / scans; >= 997/1000 reachable."""

    def test_interleaved_bulk_insert_reachability(self):
        rng = np.random.default_rng(160)
        data0 = rng.standard_normal((200, 8)).astype(np.float32)
        idx = TorchIndex.build(data0, metric="l2", method="host", seed=161,
                               device="cpu")
        all_rows = {i: data0[i] for i in range(200)}
        next_tid = 200
        for round_ in range(5):
            batch = rng.standard_normal((200, 8)).astype(np.float32)
            tids = list(range(next_tid, next_tid + 200))
            idx.insert_bulk(batch, tids=tids)
            for t, row in zip(tids, batch):
                all_rows[t] = row
            next_tid += 200
            if round_ % 2 == 1:
                dead = rng.choice(sorted(all_rows), size=40, replace=False)
                idx.delete(dead)
                for t in dead:
                    all_rows.pop(int(t))
                idx.vacuum()
            _, ids = idx.search(batch[0], 1, TSearchParams(ef_search=40),
                                method="host")
            assert ids[0] >= 0
        live = sorted(all_rows.items())
        probe = live[:: max(1, len(live) // 400)][:400]
        hits = 0
        for t, row in probe:
            _, ids = idx.search(row, 1, TSearchParams(ef_search=60),
                                method="host")
            hits += int(ids[0] == t)
        assert hits / len(probe) >= 0.997, f"{hits}/{len(probe)} reachable"


def test_insert_refuses_a_tensor_on_another_device():
    idx = TorchIndex.build(np.random.default_rng(1).random((50, 4)),
                           metric="l2", method="device", device="cpu")
    with pytest.raises(ValueError, match="never moves"):
        idx.insert_bulk(torch.zeros((3, 4), device="meta"))


@pytest.mark.cuda
def test_card_insert_matches_cpu():
    """The same insert on the card and on the CPU: both grown graphs hold
    the invariants and serve at the same beam recall (K4 on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from pgvector_rx_tpu_torch.ops import bruteforce as tbf

    data, queries = make_dataset(6000, 32, NQ, seed=33)
    params = IndexParams(m=8, ef_construction=32)
    c = _grow(TorchIndex, data, 5000, params, seed=3)
    card = TorchIndex.build(torch.from_numpy(data[:5000]).cuda(),
                            metric="l2", params=_tparams(params), seed=3,
                            host_graph=False, device="cuda")
    card.insert_bulk(torch.from_numpy(data[5000:]).cuda())
    g = card.device_graph()
    assert g.device.type == "cuda"
    _check_invariants(g, 8, 6000)
    _, gt = tdev.serve_topk(c, queries, K, engine="exact")
    before = tbf.LAUNCHES["k4_beam"]
    r_card = _beam_recall(card, queries, gt)
    assert tbf.LAUNCHES["k4_beam"] > before
    r_cpu = _beam_recall(c, queries, gt)
    assert r_card >= 0.95 and abs(r_card - r_cpu) <= 0.01, (r_card, r_cpu)
