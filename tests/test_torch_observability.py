"""The port's observability hooks: ``PGV_SCAN_STATS`` (graph/device.py's
``_record_scan_stats``) held to the JAX package's counters on a carried
graph, ``utils/profiling`` (``torch.profiler``), and the device build's
``PGV_BUILD_TIMING`` / ``PGV_BUILD_DEBUG`` lines and ``GROUP_STATS`` tuples,
none of which changes the graph."""

import dataclasses
import json
import re

import numpy as np
import pytest
import torch

from pgvector_rx_tpu.config import SearchParams as JSearchParams
from pgvector_rx_tpu.index.hnsw import HnswIndex as JaxIndex
from pgvector_rx_tpu_torch import HnswIndex
from pgvector_rx_tpu_torch.config import IndexParams, SearchParams
from pgvector_rx_tpu_torch.graph import device_build as tdb
from pgvector_rx_tpu_torch.utils import profiling, trace
from pgvector_rx_tpu_torch.utils.stats import ScanStats

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# PGV_SCAN_STATS
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """A JAX native build (3,000 x 16-d l2) and the port's load of its
    checkpoint, with 24 queries."""
    rng = np.random.default_rng(61)
    data = rng.standard_normal((3000, 16)).astype(np.float32)
    q = data[:24] + 0.1 * rng.standard_normal((24, 16)).astype(np.float32)
    jidx = JaxIndex.build(data, metric="l2", method="native", seed=3)
    path = tmp_path_factory.mktemp("stats") / "ck"
    jidx.save(path)
    return jidx, HnswIndex.load(path, device="cpu"), q


@pytest.mark.parametrize("method", ["exact", "approx", "device"])
def test_scan_stats_equal_jax(carried, monkeypatch, method):
    """Each engine's counters equal the JAX package's: a sweep scores B x
    capacity rows; the beam counts its steps, a node and a full layer-0
    list of rows a step."""
    jidx, tidx, q = carried
    monkeypatch.setenv("PGV_SCAN_STATS", "1")
    jidx.search(q, 10, JSearchParams(ef_search=40), method=method)
    tidx.search(q, 10, SearchParams(ef_search=40), method=method)
    want = dataclasses.asdict(jidx.last_scan_stats)
    assert isinstance(tidx.last_scan_stats, ScanStats)
    assert dataclasses.asdict(tidx.last_scan_stats) == want
    if method == "device":
        assert want["beam_steps"] > 0
        assert want["distances_computed"] == (
            want["beam_steps"] * tidx.device_graph().neighbors0.shape[1])
    else:
        assert want["distances_computed"] == len(q) * 3000


@pytest.mark.parametrize("value", [None, "0"])
def test_scan_stats_off_by_default(carried, monkeypatch, value):
    _, tidx, q = carried
    if value is None:
        monkeypatch.delenv("PGV_SCAN_STATS", raising=False)
    else:
        monkeypatch.setenv("PGV_SCAN_STATS", value)
    tidx.last_scan_stats = None
    tidx.search(q, 10, SearchParams(ef_search=40), method="device")
    assert tidx.last_scan_stats is None


def test_scan_stats_count_the_padded_capacity(monkeypatch):
    """A device-built graph's sweep counts the capacity the JAX graph
    reports (the padded one), as the JAX package's counter does."""
    data = np.random.default_rng(62).random((300, 8)).astype(np.float32)
    idx = HnswIndex.build(data, metric="l2", method="device",
                          host_graph=False, device="cpu")
    monkeypatch.setenv("PGV_SCAN_STATS", "1")
    idx.search(data[:5], 3, method="exact")
    cap = tdb.cap_pad_for(300) - 1
    assert idx.device_graph().capacity == cap
    assert idx.last_scan_stats.distances_computed == 5 * cap
    assert idx.last_scan_stats.nodes_visited == 5 * cap


# ---------------------------------------------------------------------------
# utils/profiling
# ---------------------------------------------------------------------------


def test_trace_writes_a_trace(tmp_path):
    with trace(tmp_path / "tr"):
        with profiling.annotate("pgv.matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "pgv.matmul" for e in events)
    with trace(None):  # a no-op
        pass


def test_annotate_is_record_function():
    assert isinstance(profiling.annotate("x"),
                      torch.profiler.record_function)


def test_trace_lets_errors_through(tmp_path):
    """An exception in the body, or the profiler's own, propagates (the
    JAX package's wrapper swallows both)."""
    with pytest.raises(KeyError):
        with trace(tmp_path / "tr"):
            raise KeyError("body")
    not_a_dir = tmp_path / "file"
    not_a_dir.write_text("")
    with pytest.raises(RuntimeError, match="directory"):
        with trace(not_a_dir):
            pass


# ---------------------------------------------------------------------------
# PGV_BUILD_TIMING / PGV_BUILD_DEBUG / GROUP_STATS
# ---------------------------------------------------------------------------

_N, _DESCENT_MIN = 500, 128
_GRAPH = ("neighbors0", "upper_neighbors", "upper_slot", "levels",
          "traversable", "emit_tid", "tid_count", "values")


def _build(ground, env, monkeypatch):
    """A 500 x 16-d l2 serving-only build past a 128-row ramp, on the IVF
    or the beam ground, under ``env``."""
    data = np.random.default_rng(63).random((_N, 16)).astype(np.float32)
    with monkeypatch.context() as mp:
        mp.setenv("PGV_BUILD_DESCENT_MIN", str(_DESCENT_MIN))
        mp.setenv("PGV_BUILD_GROUND", ground)
        for var, val in env.items():
            mp.setenv(var, val)
        idx = HnswIndex.build(data, metric="l2", method="device",
                              host_graph=False, seed=4, device="cpu",
                              params=IndexParams(m=8, ef_construction=32))
    return idx.device_graph()


@pytest.fixture(scope="module")
def plain_graphs():
    with pytest.MonkeyPatch.context() as mp:
        return {ground: _build(ground, {}, mp) for ground in ("ivf", "beam")}


def _same_graph(a, b):
    for f in _GRAPH:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert (a.entry, a.entry_level) == (b.entry, b.entry_level)


def _n_batches():
    return len(tdb.batch_schedule(_N, tdb.batch_max_for(_N)))


@pytest.mark.parametrize("ground", ["ivf", "beam"])
def test_build_timing_lines(plain_graphs, ground, monkeypatch, capsys):
    """PGV_BUILD_TIMING prints the builder's init steps, the build's phases
    and one line per batch, and builds the same graph."""
    g = _build(ground, {"PGV_BUILD_TIMING": "1"}, monkeypatch)
    _same_graph(g, plain_graphs[ground])
    err = capsys.readouterr().err
    inits = re.findall(r"^\[build\]   init\.(\S+) \d+\.\d\ds$", err, re.M)
    assert inits == ["pad", "upper-tables", "build-data", "arrays"]
    phases = re.findall(r"^\[build\] phase (\S+) \d+\.\d\ds$", err, re.M)
    assert phases == ["prep", "levels", "builder-init", "run_all", "absorb",
                      "finalize.store", "finalize.device-graph"]
    batches = re.findall(r"^\[build\] batch@(\d+) w=(-?\d+) elems=(\d+) "
                         r"\d+\.\d{3}s \(\d+/s\)$", err, re.M)
    assert len(batches) == _n_batches()
    assert sum(int(n) for _, _, n in batches) == _N - 1


@pytest.mark.parametrize("ground", ["ivf", "beam"])
def test_build_debug_lines(plain_graphs, ground, monkeypatch, capsys):
    """PGV_BUILD_DEBUG prints each batch's candidate search and its
    commit's three parts, and builds the same graph."""
    g = _build(ground, {"PGV_BUILD_DEBUG": "1"}, monkeypatch)
    _same_graph(g, plain_graphs[ground])
    err = capsys.readouterr().err
    search = re.findall(r"^\[build\] batch@(\d+) n=(\d+) w=(\d+) search "
                        r"\d+\.\d{3}s$", err, re.M)
    commit = re.findall(r"^\[build\] batch@(\d+) commit \d+\.\d{3}s \(fwd "
                        r"\d+\.\d{3} be0 \d+\.\d{3} beu \d+\.\d{3}\)$", err,
                        re.M)
    assert len(search) == len(commit) == _n_batches()
    assert [s for s, _, _ in search] == commit


@pytest.mark.parametrize("ground", ["ivf", "beam"])
def test_group_stats(plain_graphs, ground, monkeypatch):
    """A list bound to GROUP_STATS gets one (width, rows, seconds) tuple per
    batch, the width the JAX package's ``_width_for`` gives (the ramp's,
    then 0 for the IVF arm and -1 for the beam ground's merged program);
    the graph is the same."""
    assert tdb.GROUP_STATS is None
    stats = []
    monkeypatch.setattr(tdb, "GROUP_STATS", stats)
    g = _build(ground, {}, monkeypatch)
    _same_graph(g, plain_graphs[ground])
    sched = tdb.batch_schedule(_N, tdb.batch_max_for(_N))
    assert [rows for _, rows, _ in stats] == [z for _, z in sched]
    assert all(isinstance(s, float) and s >= 0 for _, _, s in stats)
    widths = [w for w, _, _ in stats]
    if ground == "ivf":
        want = [0 if s + 1 > _DESCENT_MIN else _DESCENT_MIN for s, _ in sched]
    else:
        want = [-1] * len(sched)
    assert widths == want
