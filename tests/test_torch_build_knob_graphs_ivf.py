"""Whole device builds under one PGV_BUILD_* knob, both packages on the
same numpy data and seed: the IVF ground's geometry (``IVF_HOP``,
``IVF_HOP_STRIDE``, ``IVF_CAP``, ``IVF_PROBES``). The knobs that change
selection and the beam ground are in
tests/test_torch_build_knob_graphs_select.py, on the helpers here.

Each case builds 3,000 rows with the ramp ending at 1,024 rows in both
packages (``_DESCENT_MIN_WIDTH`` patched), so the knob's arm builds the
rest. Both graphs are served by the port's beam engine (the JAX graph
enters through ``DeviceGraph.from_numpy``), so a recall difference belongs
to the build. The JAX package reads these knobs when it builds or traces:
each JAX build runs between two ``jax.clear_caches()``.
"""

import functools

import jax
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
from test_torch_device_build import (_beam_recall, _carry, _check_invariants,
                                     _overlap)

torch.set_num_threads(1)

K, NQ, N, RAMP = 10, 200, 3000, 1024
M, EFC = 8, 32

#: case -> (metric, {knob: value}, layer-0 overlap floor: the existing
#: parity tests' floor for that ground (tests/test_torch_device_build.py
#: 0.95 for the IVF ground, tests/test_torch_beam_ground.py 0.9 for the
#: beam ground) less 0.01)
CASES = {
    "ivf_hop32": ("l2", {"IVF_HOP": 32}, 0.94),
    "ivf_hop_stride2": ("l2", {"IVF_HOP_STRIDE": 2}, 0.94),
    "ivf_cap32": ("l2", {"IVF_CAP": 32}, 0.94),
    "ivf_probes8": ("l2", {"IVF_PROBES": 8}, 0.94),
    "be_k1": ("l2", {"BE_K": 1}, 0.94),
    "alpha1.2": ("l2", {"ALPHA": 1.2}, 0.94),
    "beam_rank_l1": ("l1", {"BEAM_MERGE": "rank"}, 0.89),
}


def _data():
    return make_dataset(N, 16, NQ, seed=51, n_clusters=40)


def _build_both(metric, knobs, jax_too=True):
    """(JAX graph carried into the port or None, port index) under
    ``PGV_BUILD_<knob>=value``."""
    data, _ = _data()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdb, "_DESCENT_MIN_WIDTH", RAMP)
        mp.setattr(tdb, "_DESCENT_MIN_WIDTH", RAMP)
        for k, v in knobs.items():
            mp.setenv("PGV_BUILD_" + k, str(v))
        j = None
        if jax_too:
            jax.clear_caches()
            j = _carry(JaxIndex.build(
                data, metric=metric, params=IndexParams(m=M, ef_construction=EFC),
                method="device", seed=3, host_graph=False))
            jax.clear_caches()
        t = TorchIndex.build(data, metric=metric,
                             params=TIndexParams(m=M, ef_construction=EFC),
                             method="device", seed=3, host_graph=False,
                             device="cpu")
    return j, t


@functools.lru_cache(maxsize=None)
def knob_case(name):
    metric, knobs, floor = CASES[name]
    j, t = _build_both(metric, knobs)
    return j, t, _data()[1], floor


@functools.lru_cache(maxsize=None)
def default_port_graph(metric):
    return _build_both(metric, {}, jax_too=False)[1].device_graph()


def check_overlap(name):
    j, t, _, floor = knob_case(name)
    share = _overlap(j.device_graph(), t.device_graph(), N)
    assert share >= floor, share


def check_recall(name):
    j, t, q, _ = knob_case(name)
    _, gt = tdev.serve_topk(t, q, K, engine="exact")
    r_t, r_j = _beam_recall(t, q, gt), _beam_recall(j, q, gt)
    assert abs(r_t - r_j) <= 0.005, (r_t, r_j)
    assert r_t >= 0.9


def check_invariants(name):
    _check_invariants(knob_case(name)[1].device_graph(), M, N)


def check_knob_is_read(name):
    """The knob changes the port's graph (it is not silently ignored)."""
    g = knob_case(name)[1].device_graph()
    assert not torch.equal(g.neighbors0,
                           default_port_graph(CASES[name][0]).neighbors0)


_HERE = ["ivf_hop32", "ivf_hop_stride2", "ivf_cap32", "ivf_probes8"]


@pytest.mark.parametrize("name", _HERE)
def test_layer0_overlaps_jax(name):
    check_overlap(name)


@pytest.mark.parametrize("name", _HERE)
def test_beam_recall_matches_jax(name):
    check_recall(name)


@pytest.mark.parametrize("name", _HERE)
def test_structural_invariants(name):
    check_invariants(name)


@pytest.mark.parametrize("name", _HERE)
def test_knob_is_read(name):
    check_knob_is_read(name)
