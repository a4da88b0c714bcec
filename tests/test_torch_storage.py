"""Persistence in the port (pgvector_rx_tpu_torch/index/storage.py): the
dense cases of tests/test_index.py::TestPersistence and the serving-only
round trips of tests/test_device_build.py and tests/test_device_input.py,
run on the port; checkpoints moved between the two packages (the file
format is one); and the port's two recorded deviations (an atomic
``arrays.npz``, no save into a directory with a live log)."""

import json
import os
import warnings

import numpy as np
import pytest
import torch

from pgvector_rx_tpu.config import IndexParams as JIndexParams
from pgvector_rx_tpu.config import SearchParams as JSearchParams
from pgvector_rx_tpu.graph import device_build as jdb
from pgvector_rx_tpu.index import storage as jstorage
from pgvector_rx_tpu.index.hnsw import HnswIndex as JaxIndex
from pgvector_rx_tpu_torch import HnswIndex
from pgvector_rx_tpu_torch.config import IndexParams, SearchParams
from pgvector_rx_tpu_torch.graph import device_build as tdb
from pgvector_rx_tpu_torch.index import storage

torch.set_num_threads(1)

CPU = dict(device="cpu")
_GRAPH = ("neighbors0", "upper_neighbors", "upper_slot", "levels",
          "traversable", "emit_tid", "tid_count")


def _host(n, d, seed, **kw):
    data = np.random.default_rng(seed).random((n, d)).astype(np.float32)
    return data, HnswIndex.build(data, metric="l2", method="host", seed=13,
                                 **kw, **CPU)


# ---------------------------------------------------------------------------
# tests/test_index.py::TestPersistence, dense cases
# ---------------------------------------------------------------------------


def test_save_load_roundtrip(tmp_path):
    rng = np.random.default_rng(31)
    data = rng.random((300, 5)).astype(np.float32)
    idx = HnswIndex.build(data, metric="l2", method="host", seed=12, **CPU)
    idx.save(tmp_path / "ckpt")
    loaded = HnswIndex.load(tmp_path / "ckpt", **CPU)
    q = rng.random((10, 5)).astype(np.float32)
    d1, i1 = idx.search(q, 10, method="host")
    d2, i2 = loaded.search(q, 10, method="host")
    assert np.array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2)


def test_log_replay_equivalence(tmp_path):
    """Insert/delete cycles after the checkpoint; the replayed copy answers
    queries identically (010:33-88 model)."""
    rng = np.random.default_rng(33)
    data = rng.random((200, 5)).astype(np.float32)
    idx = HnswIndex.build(data, metric="l2", method="host", seed=13, **CPU)
    idx.save(tmp_path / "ckpt")
    idx.enable_log(tmp_path / "ckpt" / "log.jsonl")
    for cycle in range(3):
        idx.delete(range(cycle * 20, cycle * 20 + 20))
        for j in range(10):
            idx.insert(rng.random(5).astype(np.float32), 1000 + cycle * 10 + j)
    replica = HnswIndex.load(tmp_path / "ckpt", **CPU)
    q = rng.random((10, 5)).astype(np.float32)
    d1, i1 = idx.search(q, 10, method="host")
    d2, i2 = replica.search(q, 10, method="host")
    assert np.array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2)


def test_log_torn_tail_tolerated(tmp_path):
    """A half-written final line is truncated with a warning and every
    complete record kept; corruption before the tail raises."""
    rng = np.random.default_rng(34)
    data, idx = _host(100, 5, 34)
    idx.save(tmp_path / "ckpt")
    idx.enable_log(tmp_path / "ckpt" / "log.jsonl")
    v0, v1 = rng.random((2, 5)).astype(np.float32)
    idx.insert(v0, 500)
    idx.insert(v1, 501)
    log_path = tmp_path / "ckpt" / "log.jsonl"
    with open(log_path, "a", encoding="utf-8") as fh:
        fh.write('{"op": "insert", "tid": 502, "val')
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        replica = HnswIndex.load(tmp_path / "ckpt", **CPU)
    assert any("torn" in str(x.message) for x in w)
    assert replica.count == idx.count
    _, i1 = idx.search(v1, 1, method="host")
    _, i2 = replica.search(v1, 1, method="host")
    assert np.array_equal(i1, i2)
    with warnings.catch_warnings(record=True) as w2:
        warnings.simplefilter("always")
        HnswIndex.load(tmp_path / "ckpt", **CPU)
    assert not any("torn" in str(x.message) for x in w2)
    lines = log_path.read_text().splitlines(keepends=True)
    log_path.write_text("{broken\n" + "".join(lines))
    with pytest.raises(ValueError, match="corrupt"):
        HnswIndex.load(tmp_path / "ckpt", **CPU)


def test_log_fsync_mode(tmp_path, monkeypatch):
    """The fsync kwarg drives os.fsync per record."""
    _, idx = _host(50, 5, 35)
    log = storage.AppendLog(tmp_path / "log.jsonl", idx, fsync=True)
    assert log.fsync is True
    calls = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: calls.append(fd)
                        or real_fsync(fd))
    log.record_insert(np.ones(5, np.float32), 1)
    log.close()
    assert len(calls) == 1


def test_log_fsync_default_on(tmp_path, monkeypatch):
    """Durability is the default; PGV_LOG_FSYNC=0 opts out."""
    _, idx = _host(50, 5, 35)
    monkeypatch.delenv("PGV_LOG_FSYNC", raising=False)
    log = storage.AppendLog(tmp_path / "log.jsonl", idx)
    assert log.fsync is True
    log.close()
    monkeypatch.setenv("PGV_LOG_FSYNC", "0")
    log = storage.AppendLog(tmp_path / "log2.jsonl", idx)
    assert log.fsync is False
    log.close()


def test_log_batch_group_commit(tmp_path, monkeypatch):
    """Records inside batch() share one fsync at its exit."""
    rng = np.random.default_rng(36)
    _, idx = _host(50, 5, 36)
    log = storage.AppendLog(tmp_path / "log.jsonl", idx, fsync=True)
    calls = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: calls.append(fd)
                        or real_fsync(fd))
    with log.batch():
        for j in range(7):
            log.record_insert(rng.random(5).astype(np.float32), j)
    log.close()
    assert len(calls) == 1
    assert (tmp_path / "log.jsonl").read_text().count('"op": "insert"') == 7


def test_log_torn_tail_byte_offsets(tmp_path):
    """Torn-tail truncation uses byte offsets: a multi-byte UTF-8 payload in
    the last complete record survives it byte for byte."""
    rng = np.random.default_rng(37)
    _, idx = _host(60, 5, 37)
    idx.save(tmp_path / "ckpt")
    log_path = tmp_path / "ckpt" / "log.jsonl"
    v = [round(float(x), 3) for x in rng.random(5)]
    with open(log_path, "w", encoding="utf-8") as fh:
        fh.write('{"op": "insert", "tid": 700, "value": ' + str(v)
                 + ', "note": "λλλ — ünïcode"}\n')
        fh.write('{"op": "insert", "tid": 701, "val')
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        replica = HnswIndex.load(tmp_path / "ckpt", **CPU)
    assert any("torn" in str(x.message) for x in w)
    assert replica.count == idx.count + 1
    raw = log_path.read_bytes()
    assert raw.count(b"\n") == 1 and json.loads(raw.decode())["tid"] == 700


def test_serving_load_of_host_checkpoint(tmp_path):
    """load(serving=True) converts a host-graph checkpoint into a
    serving-only index: the same DeviceGraph tensors and search results,
    the live count across vacuumed gaps, and dense log inserts replayed
    through insert_bulk; a logged delete refuses the serving load."""
    rng = np.random.default_rng(41)
    data = rng.standard_normal((1200, 8)).astype(np.float32)
    idx = HnswIndex.build(data, metric="l2", method="native", seed=5, **CPU)
    idx.delete(range(50, 150))
    idx.vacuum()
    idx.save(tmp_path / "ckpt")
    a = HnswIndex.load(tmp_path / "ckpt", **CPU)
    b = HnswIndex.load(tmp_path / "ckpt", serving=True, **CPU)
    assert b.serving_only and not b.elements and b.count == a.count
    ga, gb = a.device_graph(), b.device_graph()
    for f in _GRAPH:
        assert torch.equal(getattr(ga, f), getattr(gb, f)), f
    q = rng.standard_normal((20, 8)).astype(np.float32)
    _, i1 = a.search(q, 10)
    _, i2 = b.search(q, 10)
    assert np.array_equal(i1, i2)
    idx.enable_log(tmp_path / "ckpt" / "log.jsonl")
    for j in range(10):
        idx.insert(rng.standard_normal(8).astype(np.float32), 7000 + j)
    c = HnswIndex.load(tmp_path / "ckpt", serving=True, **CPU)
    assert c.num_tuples == idx.num_tuples
    idx.delete([7000])
    with pytest.raises(ValueError, match="serving load"):
        HnswIndex.load(tmp_path / "ckpt", serving=True, **CPU)


# ---------------------------------------------------------------------------
# serving-only round trips (tests/test_device_build.py,
# tests/test_device_input.py)
# ---------------------------------------------------------------------------


def test_serving_only_save_load_roundtrip(tmp_path):
    rng = np.random.default_rng(13)
    data = rng.standard_normal((300, 16)).astype(np.float32)
    idx = HnswIndex.build(data, metric="l2", method="device", seed=0,
                          host_graph=False, **CPU)
    q = data[:24]
    d0, i0 = idx.search(q, 5, SearchParams(ef_search=32), method="device")
    idx.save(tmp_path / "ck")
    idx2 = HnswIndex.load(tmp_path / "ck", **CPU)
    assert idx2.serving_only
    d1, i1 = idx2.search(q, 5, SearchParams(ef_search=32), method="device")
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(d0, d1, rtol=1e-5)
    _, i2 = idx2.search(q, 5, SearchParams(), method="exact")
    assert (i2[:, 0] == np.arange(24)).all()


def test_tensor_built_serving_only_save_load(tmp_path):
    """A store backed by the build's tensor downloads its rows on save."""
    rng = np.random.default_rng(93)
    data = rng.standard_normal((2200, 12)).astype(np.float32)
    idx = HnswIndex.build(torch.from_numpy(data), metric="l2", seed=1,
                          host_graph=False, **CPU)
    assert idx.store._device_rows is not None
    d_ref, t_ref = idx.search(data[31], 10)
    idx.save(str(tmp_path / "ck"))
    idx2 = HnswIndex.load(str(tmp_path / "ck"), **CPU)
    d2, t2 = idx2.search(data[31], 10)
    assert list(t2) == list(t_ref)
    np.testing.assert_allclose(d2, d_ref, rtol=1e-6)


def test_bit_and_sparse_checkpoints_raise(tmp_path):
    """Both kinds are ported, bit (item 14) and sparse (item 15):
    tests/test_device_build.py's serving-only bit round trip, and a JAX
    bit checkpoint loads with the same search ids (more in
    tests/test_torch_bit_index.py); a sparse checkpoint moves both ways and
    only its serving load raises, as JAX's does (more in
    tests/test_torch_sparse_index.py)."""
    from pgvector_rx_tpu.config import SearchParams as JSearchParams

    bits = (np.random.default_rng(3).random((400, 64)) < 0.5).astype(np.uint8)
    idx = HnswIndex.build(bits, metric="hamming", method="device", seed=3,
                          host_graph=False, **CPU)
    idx.save(tmp_path / "bit")
    idx2 = HnswIndex.load(tmp_path / "bit", **CPU)
    d1, t1 = idx.search(bits[:8], 5, SearchParams())
    d2, t2 = idx2.search(bits[:8], 5, SearchParams())
    np.testing.assert_array_equal(t1, t2)
    np.testing.assert_allclose(d1, d2)
    j = JaxIndex.build(bits[:40], metric="hamming", method="host")
    j.save(tmp_path / "jbit")
    back = HnswIndex.load(tmp_path / "jbit", **CPU)
    np.testing.assert_array_equal(
        back.search(bits[:8], 5, method="host")[1],
        j.search(bits[:8], 5, JSearchParams(), method="host")[1])
    sparse = HnswIndex.build([(np.array([0, 3]), np.array([1.0, 2.0]))] * 4,
                             method="host", **CPU)
    sparse.save(tmp_path / "sparse")
    assert JaxIndex.load(tmp_path / "sparse").num_tuples == 4
    JaxIndex.build([(np.array([0, 3]), np.array([1.0, 2.0]))] * 4,
                   method="host").save(tmp_path / "jsparse")
    back = HnswIndex.load(tmp_path / "jsparse", **CPU)
    assert back.kind == "sparse" and back.num_tuples == 4
    with pytest.raises(ValueError, match="dense and bit"):
        HnswIndex.load(tmp_path / "jsparse", serving=True, **CPU)


def test_insert_bulk_logs_one_group_commit(tmp_path, monkeypatch):
    """insert_bulk on a host-graph index appends every row to the log in
    one group commit, and a replay rebuilds the same answers."""
    rng = np.random.default_rng(44)
    data = rng.standard_normal((400, 8)).astype(np.float32)
    idx = HnswIndex.build(data, metric="l2", method="device", seed=2, **CPU)
    idx.save(tmp_path / "ck")
    idx.enable_log(tmp_path / "ck" / "log.jsonl")
    calls = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: calls.append(fd)
                        or real_fsync(fd))
    new = rng.standard_normal((30, 8)).astype(np.float32)
    assert idx.insert_bulk(new) == 30
    assert len(calls) == 1
    recs = (tmp_path / "ck" / "log.jsonl").read_text().splitlines()
    assert [json.loads(r)["tid"] for r in recs] == list(range(400, 430))
    replica = HnswIndex.load(tmp_path / "ck", **CPU)
    assert replica.num_tuples == idx.num_tuples == 430
    _, i1 = idx.search(new, 1, method="exact")
    _, i2 = replica.search(new, 1, method="exact")
    assert np.array_equal(i1, i2)


# ---------------------------------------------------------------------------
# checkpoints moved between the packages
# ---------------------------------------------------------------------------


def _queries(d, seed=9):
    return np.random.default_rng(seed).standard_normal((40, d)).astype(
        np.float32)


@pytest.mark.parametrize("serving", [False, True])
def test_jax_checkpoint_loads_in_the_port(tmp_path, serving):
    """A JAX host-graph checkpoint with deletes, loaded as a host graph or
    serving-only: the same search ids on every device method."""
    data = np.random.default_rng(51).standard_normal((800, 8)).astype(
        np.float32)
    j = JaxIndex.build(data, metric="cosine", method="native", seed=4)
    j.delete(range(0, 800, 50))
    j.save(tmp_path / "ck")
    t = HnswIndex.load(tmp_path / "ck", serving=serving, **CPU)
    assert t.serving_only == serving and t.count == j.count
    q = _queries(8)
    for method in ("exact", "approx", "device"):
        _, ji = j.search(q, 10, JSearchParams(ef_search=40), method=method)
        _, ti = t.search(q, 10, SearchParams(ef_search=40), method=method)
        np.testing.assert_array_equal(ti, ji, err_msg=method)
    if not serving:
        _, ji = j.search(q[:5], 10, method="host")
        _, ti = t.search(q[:5], 10, method="host")
        np.testing.assert_array_equal(ti, ji)


def test_jax_device_built_checkpoint_loads_in_the_port(tmp_path):
    """A JAX serving-only device build keeps its padded capacity in memory
    (cap = cap_pad_for(n) - 1); its checkpoint holds the n real rows and
    both packages load it with cap n."""
    data = np.random.default_rng(52).standard_normal((1500, 16)).astype(
        np.float32)
    j = JaxIndex.build(data, metric="l2", params=JIndexParams(m=8),
                       method="device", seed=3, host_graph=False)
    assert j.device_graph().cap == jdb.cap_pad_for(1500) - 1
    q = _queries(16)
    before = {m: j.search(q, 10, JSearchParams(ef_search=40), method=m)[1]
              for m in ("exact", "device")}
    j.save(tmp_path / "ck")
    t = HnswIndex.load(tmp_path / "ck", **CPU)
    j2 = JaxIndex.load(tmp_path / "ck")
    g = t.device_graph()
    assert g.cap == g.capacity == j2.device_graph().cap == 1500
    for m, ids in before.items():
        _, ti = t.search(q, 10, SearchParams(ef_search=40), method=m)
        np.testing.assert_array_equal(ti, ids, err_msg=m)


@pytest.mark.parametrize("serving_only", [False, True])
def test_port_checkpoint_loads_in_jax(tmp_path, serving_only):
    """A port checkpoint (host graph with a live log, or a serving-only
    device build) loads in the JAX package with the same search ids."""
    data = np.random.default_rng(53).standard_normal((900, 12)).astype(
        np.float32)
    t = HnswIndex.build(data, metric="l2", params=IndexParams(m=8),
                        method="device", seed=6, host_graph=not serving_only,
                        **CPU)
    t.save(tmp_path / "ck")
    if not serving_only:
        t.enable_log(tmp_path / "ck" / "log.jsonl")
        t.insert(data[0] + 0.5, 5000)
        t.delete([3, 4])
    j = JaxIndex.load(tmp_path / "ck")
    assert j.serving_only == serving_only and j.num_tuples == t.num_tuples
    q = _queries(12)
    for method in ("exact", "device"):
        _, ti = t.search(q, 10, SearchParams(ef_search=40), method=method)
        _, ji = j.search(q, 10, JSearchParams(ef_search=40), method=method)
        np.testing.assert_array_equal(ti, ji, err_msg=method)


def _checkpoint(path):
    """(meta.json, {name: array} of arrays.npz) of a checkpoint."""
    meta = json.loads((path / "meta.json").read_text())
    with np.load(path / "arrays.npz") as z:
        return meta, {f: z[f] for f in z.files}


#: the arrays of a checkpoint that hold distances the native engine summed
_DISTANCE_ARRAYS = ("nb_dists",)


def test_same_format_as_jax(tmp_path):
    """The file format, bit for bit: a checkpoint either package wrote is
    written back by the other (load, then save) with the same meta.json
    and every arrays.npz array equal in dtype and bits, floats included.
    Each direction reads one build only, so the check does not depend on
    which native binary built the graph."""
    assert storage.FORMAT_VERSION == jstorage.FORMAT_VERSION
    data = np.random.default_rng(54).random((120, 6)).astype(np.float32)
    j = JaxIndex.build(data, metric="l2", method="native", seed=2)
    j.save(tmp_path / "j")
    HnswIndex.load(tmp_path / "j", **CPU).save(tmp_path / "j_port")
    t = HnswIndex.build(data, metric="l2", method="native", seed=2, **CPU)
    t.save(tmp_path / "t")
    JaxIndex.load(tmp_path / "t").save(tmp_path / "t_jax")
    for first, back in (("j", "j_port"), ("t", "t_jax")):
        (m1, z1), (m2, z2) = (_checkpoint(tmp_path / first),
                              _checkpoint(tmp_path / back))
        assert m1 == m2, first
        assert sorted(z1) == sorted(z2), first
        for f in z1:
            assert z1[f].dtype == z2[f].dtype, (first, f)
            np.testing.assert_array_equal(z1[f], z2[f],
                                          err_msg=f"{first}: {f}")


def test_same_native_build_as_jax(tmp_path):
    """The two packages' native engines on the same data and seed write the
    same checkpoint: meta.json and every integer, bool and row array equal;
    the summed distances within 2 ulp. The JAX package loads its committed
    binary while it is newer than its source, the port compiles its own
    copy with -march=native -ffast-math on the host at hand, and two such
    builds on different CPUs may sum a distance in another order (1 ulp
    seen); the graph they choose stays the same."""
    data = np.random.default_rng(54).random((120, 6)).astype(np.float32)
    HnswIndex.build(data, metric="l2", method="native", seed=2,
                    **CPU).save(tmp_path / "t")
    JaxIndex.build(data, metric="l2", method="native",
                   seed=2).save(tmp_path / "j")
    (mt, zt), (mj, zj) = _checkpoint(tmp_path / "t"), _checkpoint(
        tmp_path / "j")
    assert mt == mj
    assert sorted(zt) == sorted(zj)
    for f in zt:
        assert zt[f].dtype == zj[f].dtype, f
        if f in _DISTANCE_ARRAYS:
            np.testing.assert_array_max_ulp(zt[f], zj[f], maxulp=2)
        else:
            np.testing.assert_array_equal(zt[f], zj[f], err_msg=f)


# ---------------------------------------------------------------------------
# the port's recorded deviations
# ---------------------------------------------------------------------------


def test_arrays_npz_is_replaced_atomically(tmp_path, monkeypatch):
    """A save that fails while writing the archive leaves the previous
    checkpoint whole (the JAX package writes arrays.npz in place)."""
    data, idx = _host(80, 5, 61)
    idx.save(tmp_path / "ck")
    before = (tmp_path / "ck" / "arrays.npz").read_bytes()
    idx.insert(data[0] + 1.0, 900)

    def torn(fh, **arrays):
        fh.write(b"PK partial")
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez_compressed", torn)
    with pytest.raises(OSError, match="disk full"):
        idx.save(tmp_path / "ck")
    monkeypatch.undo()
    assert (tmp_path / "ck" / "arrays.npz").read_bytes() == before
    assert HnswIndex.load(tmp_path / "ck", **CPU).num_tuples == 80


def test_save_refuses_a_directory_with_a_live_log(tmp_path):
    """Records in log.jsonl are already in the index: a checkpoint beside
    them would be replayed twice, so save refuses; an empty log is fine."""
    data, idx = _host(80, 5, 62)
    idx.save(tmp_path / "ck")
    idx.enable_log(tmp_path / "ck" / "log.jsonl")
    idx.save(tmp_path / "ck")  # the log is still empty
    idx.insert(data[1] + 1.0, 901)
    with pytest.raises(ValueError, match="twice"):
        idx.save(tmp_path / "ck")
    idx.save(tmp_path / "other")
    assert HnswIndex.load(tmp_path / "other", **CPU).num_tuples == 81
    assert HnswIndex.load(tmp_path / "ck", **CPU).num_tuples == 81


def test_load_defaults_to_the_card(tmp_path, monkeypatch):
    _, idx = _host(30, 4, 63)
    idx.save(tmp_path / "ck")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        HnswIndex.load(tmp_path / "ck")
