"""The port stands alone: no module of ``pgvector_rx_tpu_torch`` (nor
``chip_smoke.py``) imports JAX, the JAX package or its benchmark, and its
copies of the framework-free modules hold the JAX package's values and
give its results. Its entry points default to the card."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
from pgvector_rx_tpu import config as jconfig
from pgvector_rx_tpu import constants as jconstants
from pgvector_rx_tpu.index.hnsw import HnswIndex as JaxIndex
from pgvector_rx_tpu_torch import HnswIndex as TorchIndex
from pgvector_rx_tpu_torch import config as tconfig
from pgvector_rx_tpu_torch import constants as tconstants
from pgvector_rx_tpu_torch import data as tdata

_ROOT = Path(__file__).resolve().parents[1]
_FORBIDDEN = ("jax", "jaxlib", "bench", "pgvector_rx_tpu")


def _port_sources():
    files = sorted((_ROOT / "pgvector_rx_tpu_torch").rglob("*.py"))
    return [*files, _ROOT / "chip_smoke.py"]


def _imported_modules(path):
    """Every module an ``import`` / ``from ... import`` names, at any
    depth of the file (relative imports are the package's own)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(_ROOT)))
def test_no_module_imports_jax_or_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in _FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("seed", [0, 7])
def test_make_dataset_is_bench_make_dataset(seed):
    a = tdata.make_dataset(3000, 24, 50, seed=seed, n_clusters=40)
    b = bench.make_dataset(3000, 24, 50, seed=seed, n_clusters=40)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_make_sparse_dataset_is_bench_suites_generator(monkeypatch):
    """``data.make_sparse_dataset`` against the generator inside
    ``bench_suite.run_sparse`` itself, cut to 600 rows: the rows it hands
    to its build are taken and the run stopped there."""
    import bench_suite

    class Stop(Exception):
        pass

    def take(name, builder):
        cells = dict(zip(builder.__code__.co_freevars,
                         (c.cell_contents for c in builder.__closure__)))
        raise Stop(cells["rows"])

    monkeypatch.setattr(bench_suite, "scaled", lambda n: 600)
    monkeypatch.setattr(bench_suite, "build_or_load", take)
    with pytest.raises(Stop) as stop:
        bench_suite.run_sparse()
    ref = stop.value.args[0]
    rows, queries = tdata.make_sparse_dataset(600, 30_000, 1024, 64, seed=9)
    assert len(rows) == len(ref) == 600 and len(queries) == 600
    for a, b in zip(rows, ref):
        assert a.dim == b.dim == 30_000
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.values, b.values)
        assert a.values.dtype == b.values.dtype == np.float32


def test_native_build_gives_the_jax_package_layer0():
    data, _ = tdata.make_dataset(1500, 16, 1, seed=3, n_clusters=20)
    j = JaxIndex.build(data, metric="l2", method="native", seed=2)
    t = TorchIndex.build(data, metric="l2", method="native", seed=2,
                         device="cpu")
    assert len(t.elements) == len(j.elements) and t.entry == j.entry
    assert t.heap_tids == j.heap_tids
    for te, je in zip(t.elements, j.elements):
        assert te.level == je.level
        assert [i for _, i in te.neighbors[0]] == \
            [i for _, i in je.neighbors[0]]


def test_native_library_builds_inside_the_port():
    from pgvector_rx_tpu_torch import native

    assert native.available(), native._error
    assert native._lib_path().parent == _ROOT / "pgvector_rx_tpu_torch" / \
        "_build"


def test_storage_copy_writes_the_jax_format(tmp_path):
    """The port's ``index/storage.py`` is a copy of the JAX package's: the
    same format version, and the same log lines for the same mutations
    (checkpoints: tests/test_torch_storage.py)."""
    from pgvector_rx_tpu.index import storage as jstorage
    from pgvector_rx_tpu_torch.index import storage as tstorage

    assert tstorage.FORMAT_VERSION == jstorage.FORMAT_VERSION
    row = np.random.default_rng(4).random(6).astype(np.float32)
    for mod, idx, name in ((jstorage, JaxIndex(6), "j"),
                           (tstorage, TorchIndex(6, device="cpu"), "t")):
        log = mod.AppendLog(tmp_path / f"{name}.jsonl", idx, fsync=False)
        log.record_insert(row, 7)
        log.record_delete([7, 9])
        log.close()
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()


def _public(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_") and isinstance(v, (int, float, str))}


def test_constants_and_config_hold_the_jax_values():
    assert _public(tconstants) == _public(jconstants)
    for m in (2, 16, 48, 100):
        assert tconstants.hnsw_get_max_level(m) == \
            jconstants.hnsw_get_max_level(m)
        assert tconstants.hnsw_get_ml(m) == jconstants.hnsw_get_ml(m)
        for lc in range(3):
            assert tconstants.hnsw_get_layer_m(m, lc) == \
                jconstants.hnsw_get_layer_m(m, lc)
    for name in ("IndexParams", "SearchParams"):
        tf = dataclasses.fields(getattr(tconfig, name))
        jf = dataclasses.fields(getattr(jconfig, name))
        assert [(f.name, f.default) for f in tf] == \
            [(f.name, f.default) for f in jf]
    with pytest.raises(ValueError):
        tconfig.IndexParams(m=1).validate_for_build()
    with pytest.raises(ValueError):
        jconfig.IndexParams(m=1).validate_for_build()


def test_cost_and_access_method_copies_hold_the_jax_values():
    """``index/cost.py`` and ``index/access_method.py`` are copies: the
    same registry, flags and phases, and the same estimates (the flat
    index, distance ops and facade: tests/test_torch_flat_am.py)."""
    from pgvector_rx_tpu.index import access_method as jam
    from pgvector_rx_tpu.index import cost as jcost
    from pgvector_rx_tpu_torch.index import access_method as tam
    from pgvector_rx_tpu_torch.index import cost as tcost

    assert tam.AM_CAPABILITIES == jam.AM_CAPABILITIES
    assert tam.PROGRESS_PHASES == jam.PROGRESS_PHASES
    assert [dataclasses.astuple(v) for v in tam.OPERATOR_CLASSES.values()] \
        == [dataclasses.astuple(v) for v in jam.OPERATOR_CLASSES.values()]
    for n in (0.0, 1.0, 10.0, 5e4, 1e6, 1e9):
        for m, ef in ((2, 1), (16, 40), (100, 1000)):
            assert tcost.traversal_ratio(n, m, ef) == \
                jcost.traversal_ratio(n, m, ef)
        assert tcost.brute_force_cost(n, 2.5) == jcost.brute_force_cost(n, 2.5)
    t, j = TorchIndex(8, device="cpu"), JaxIndex(8)
    t.heap_tids = j.heap_tids = [[i] for i in range(5000)]
    for order_by in (True, False):
        assert dataclasses.astuple(tcost.estimate(t, order_by, 40)) == \
            dataclasses.astuple(jcost.estimate(j, order_by, 40))
        assert tcost.should_use_index(t, order_by, 40) == \
            jcost.should_use_index(j, order_by, 40)


# ---------------------------------------------------------------------------
# the entry points default to the card
# ---------------------------------------------------------------------------


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_constructor_without_a_device_raises_without_cuda(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TorchIndex(8)
    assert TorchIndex(8, device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("method", ["device", "native", "host"])
def test_build_without_a_device_raises_without_cuda(monkeypatch, method):
    _no_cuda(monkeypatch)
    data = np.random.default_rng(9).random((60, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TorchIndex.build(data, method=method)
    idx = TorchIndex.build(data, method=method, device="cpu")
    assert idx.device == torch.device("cpu") and idx.num_tuples == 60


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert TorchIndex(8).device == torch.device("cuda")


def test_flat_index_and_facade_default_to_the_card(monkeypatch):
    from pgvector_rx_tpu_torch.index.access_method import \
        create_index_for_opclass
    from pgvector_rx_tpu_torch.index.flat import FlatIndex

    _no_cuda(monkeypatch)
    for make in (lambda **kw: FlatIndex("bit", "hamming", 64, **kw),
                 lambda **kw: create_index_for_opclass("bit_jaccard_ops", 64,
                                                       **kw)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            make()
        assert make(device="cpu").device == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert FlatIndex("dense", "l2", 8).device == torch.device("cuda")
    assert create_index_for_opclass("vector_l2_ops", 8).device == \
        torch.device("cuda")
