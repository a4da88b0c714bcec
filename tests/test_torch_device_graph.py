"""The port's DeviceGraph (pgvector_rx_tpu_torch/graph/device.py) against
the JAX package's, built from the same data and seed."""

import numpy as np
import pytest
import torch

from pgvector_rx_tpu.graph import device as jdev
from pgvector_rx_tpu.index.hnsw import HnswIndex as JaxIndex
from pgvector_rx_tpu_torch import HnswIndex as TorchIndex
from pgvector_rx_tpu_torch.graph import device as tdev

torch.set_num_threads(1)

_INT_FIELDS = ("neighbors0", "upper_neighbors", "upper_slot", "levels",
               "traversable", "emit_tid", "tid_count")


def _as_np(t):
    if t.dtype == torch.bfloat16:
        return t.float().cpu().numpy()
    return t.cpu().numpy()


def _assert_same_graph(jg, tg):
    for attr in ("kind", "metric", "cap", "m", "entry", "entry_level"):
        assert getattr(tg, attr) == getattr(jg, attr), attr
    for f in _INT_FIELDS:
        np.testing.assert_array_equal(_as_np(getattr(tg, f)),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    np.testing.assert_array_equal(_as_np(tg.values), np.asarray(jg.values))
    np.testing.assert_array_equal(
        _as_np(tg.values_bf16), np.asarray(jg.values_bf16).astype(np.float32)
    )
    # float sums in another order: last-bit differences only
    np.testing.assert_allclose(_as_np(tg.x2), np.asarray(jg.x2), rtol=1e-6)


def _data(n=2000, d=16, seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_native_serving_build_matches_jax(metric):
    data = _data()
    j = JaxIndex.build(data, metric=metric, method="native", host_graph=False,
                       seed=1)
    t = TorchIndex.build(data, metric=metric, method="native",
                         host_graph=False, seed=1, device="cpu")
    assert t.serving_only and t.entry == j.entry
    assert t.heap_tids == j.heap_tids
    np.testing.assert_array_equal(t.store.rows[: t.store.count],
                                  j.store.rows[: j.store.count])
    tg = t.device_graph()
    assert tg.device == torch.device("cpu")
    _assert_same_graph(j.device_graph(), tg)


def test_from_numpy_round_trips_a_jax_graph():
    j = JaxIndex.build(_data(), metric="l2", method="native",
                       host_graph=False, seed=2)
    jg = j.device_graph()
    arrays = {f: np.asarray(getattr(jg, f))
              for f in _INT_FIELDS + ("values", "x2", "values_bf16")}
    tg = tdev.DeviceGraph.from_numpy(
        arrays, kind=jg.kind, metric=jg.metric, cap=jg.cap, m=jg.m,
        entry=jg.entry, entry_level=jg.entry_level, device="cpu",
    )
    assert tg.values_bf16.dtype == torch.bfloat16
    assert tg.traversable.dtype == torch.bool
    _assert_same_graph(jg, tg)
    np.testing.assert_array_equal(_as_np(tg.x2), np.asarray(jg.x2))


@pytest.mark.parametrize("method", ["native", "host"])
def test_from_index_matches_jax(method):
    """Host-graph builds (native C++ or the Python reference engine)
    flatten to the same DeviceGraph in both packages."""
    n = 2000 if method == "native" else 300
    data = _data(n=n)
    j = JaxIndex.build(data, metric="l2", method=method, host_graph=True,
                       seed=4)
    t = TorchIndex.build(data, metric="l2", method=method, host_graph=True,
                         seed=4, device="cpu")
    assert not t.serving_only and len(t.elements) == len(j.elements)
    _assert_same_graph(jdev.DeviceGraph.from_index(j), t.device_graph())
    # the port's from_index also flattens the JAX package's host index
    _assert_same_graph(jdev.DeviceGraph.from_index(j),
                       tdev.DeviceGraph.from_index(j, device="cpu"))


def test_serve_dtype_policy(monkeypatch):
    data = _data(n=500)
    monkeypatch.setenv("PGV_SERVE_DTYPE", "bf16")
    t = TorchIndex.build(data, metric="l2", method="native", host_graph=False,
                         seed=1, device="cpu")
    j = JaxIndex.build(data, metric="l2", method="native", host_graph=False,
                       seed=1)
    tg, jg = t.device_graph(), j.device_graph()
    assert tg.values.dtype == torch.bfloat16 and tg.values_bf16 is None
    np.testing.assert_array_equal(_as_np(tg.values),
                                  np.asarray(jg.values).astype(np.float32))
    np.testing.assert_allclose(_as_np(tg.x2), np.asarray(jg.x2), rtol=1e-6)


def test_device_build_not_ported_yet():
    """The dense device build is ported at every width and metric
    (tests/test_torch_device_build.py, tests/test_torch_beam_ground.py);
    what of it is not raises, naming its ROADMAP item."""
    data = _data(n=100)
    with pytest.raises(NotImplementedError, match="item 13b"):
        TorchIndex.build(data, method="device", consume_input=True, device="cpu")
    # the bit kind's device build is ported (tests/test_torch_bit_index.py)
    bits = TorchIndex.build((data > 0).astype(np.uint8), metric="hamming",
                            method="device", device="cpu")
    assert bits.kind == "bit" and bits.num_tuples == 100
    # the sparse kind has no device build, as in the JAX package: it names
    # the host builds (tests/test_torch_sparse_index.py)
    with pytest.raises(ValueError, match="method='native' or 'host'"):
        TorchIndex.build([(np.array([0, 3]), np.array([1.0, 2.0]))] * 4,
                         method="device", device="cpu")
    with pytest.raises(ValueError, match="method='device'"):
        TorchIndex.build(torch.from_numpy(data), method="native", device="cpu")


def test_unported_seams_raise_instead_of_reaching_jax(tmp_path, monkeypatch):
    t = TorchIndex.build(_data(n=200), method="native", host_graph=False,
                         seed=1, device="cpu")
    # items 9, 10 and 12 are ported: the insert, the scan and persistence
    # run in the port
    assert t.insert_bulk(_data(n=4, seed=4)) == 4
    assert t.scan(_data(n=1)[0]).take(1)[0][0] == 0
    t.save(tmp_path / "ck")
    assert TorchIndex.load(tmp_path / "ck", device="cpu").num_tuples == 204
    # the beam variants (13b) run; an invalid expansion is refused; the bit
    # kind's checkpoints (item 14) and the sparse kind's (item 15) are
    # ported
    monkeypatch.setenv("PGV_BEAM_EXPAND", "4")
    assert t.search(_data(n=2), 5, method="device")[1].shape == (2, 5)
    monkeypatch.setenv("PGV_BEAM_EXPAND", "0")
    with pytest.raises(ValueError, match="PGV_BEAM_EXPAND"):
        t.search(_data(n=2), 5, method="device")
    monkeypatch.delenv("PGV_BEAM_EXPAND")
    bits = TorchIndex.build((_data(n=40) > 0.5).astype(np.uint8),
                            metric="hamming", method="host", device="cpu")
    bits.save(tmp_path / "bits")
    assert TorchIndex.load(tmp_path / "bits", device="cpu").num_tuples == 40
    sparse = TorchIndex.build([(np.array([0, 3]), np.array([1.0, 2.0]))] * 4,
                              method="host", device="cpu")
    sparse.save(tmp_path / "sparse")
    assert TorchIndex.load(tmp_path / "sparse",
                           device="cpu").num_tuples == 4


@pytest.mark.cuda
def test_native_serving_build_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    data = _data()
    j = JaxIndex.build(data, metric="l2", method="native", host_graph=False,
                       seed=1)
    t = TorchIndex.build(data, metric="l2", method="native",
                         host_graph=False, seed=1, device="cuda")
    tg = t.device_graph()
    assert tg.device.type == "cuda" and tg.values.is_cuda
    _assert_same_graph(j.device_graph(), tg)
