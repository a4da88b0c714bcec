"""Whole device builds under one PGV_BUILD_* knob that changes selection
or the beam ground: ``BE_K=1`` and ``ALPHA=1.2`` (l2, the IVF ground) and
``BEAM_MERGE=rank`` (l1, the beam ground), both packages on the same numpy
data and seed, on the helpers and cases of
tests/test_torch_build_knob_graphs_ivf.py.
"""

import pytest

from test_torch_build_knob_graphs_ivf import (check_invariants,
                                              check_knob_is_read,
                                              check_overlap,
                                              check_recall)

_HERE = ["be_k1", "alpha1.2", "beam_rank_l1"]


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
