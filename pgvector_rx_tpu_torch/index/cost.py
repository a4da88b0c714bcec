"""Planner cost model: the amcostestimate analog.

Parity source: reference ``src/index/handler.rs:20-116``. Reproduces the
traversal-ratio model: without an ORDER BY the index is unusable
(infinite cost, handler.rs:37-45); otherwise the expected fraction of
tuples visited is

    ratio = (entry_level * m + 2m * ef_search * layer0_selectivity) / N
    entry_level       = ln(N) * mL                    (handler.rs:63)
    layer0_selectivity = 0.55 * ln(N) / (ln(m) * (1 + ln(ef_search)))
                                                      (handler.rs:65-66)

clamped to 1. Here the "generic cost" substrate is a simple per-tuple /
per-distance accounting instead of PostgreSQL page costs, exposed so a
caller embedding this framework in a query planner can choose between
the HNSW index and a brute-force (seqscan-analog) scan.
"""

from __future__ import annotations

import dataclasses
import math

from ..constants import hnsw_get_layer_m, hnsw_get_ml


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    startup_cost: float
    total_cost: float
    selectivity: float
    tuples_visited: float  # expected graph tuples touched


def traversal_ratio(num_tuples: float, m: int, ef_search: int) -> float:
    """Expected fraction of the index visited by one scan.

    Parity: handler.rs:60-74 (scaling factor 0.55).
    """
    if num_tuples <= 0.0:
        return 1.0
    scaling_factor = 0.55
    entry_level = int(math.log(num_tuples) * hnsw_get_ml(m))
    layer0_tuples_max = hnsw_get_layer_m(m, 0) * float(ef_search)
    layer0_selectivity = (
        scaling_factor
        * math.log(num_tuples)
        / (math.log(m) * (1.0 + math.log(ef_search)))
    )
    r = (entry_level * m + layer0_tuples_max * layer0_selectivity) / num_tuples
    return min(r, 1.0)


def estimate(
    index,
    has_order_by: bool,
    ef_search: int,
    cost_per_distance: float = 1.0,
) -> CostEstimate:
    """Cost of one k-NN scan of `index` (amcostestimate analog)."""
    if not has_order_by:
        # HNSW cannot serve unordered scans (handler.rs:37-45,
        # scan.rs:732-734 errors at execution too)
        return CostEstimate(math.inf, math.inf, 0.0, 0.0)
    n = float(index.num_tuples)
    ratio = traversal_ratio(n, index.params.m, ef_search)
    visited = n * ratio
    total = visited * cost_per_distance
    return CostEstimate(
        startup_cost=total,  # all work happens before the first row
        total_cost=total,
        selectivity=ratio,
        tuples_visited=visited,
    )


def brute_force_cost(num_tuples: float, cost_per_distance: float = 1.0) -> float:
    """Seqscan-analog comparison cost."""
    return num_tuples * cost_per_distance


def should_use_index(index, has_order_by: bool, ef_search: int) -> bool:
    """Planner decision helper: index scan vs brute force."""
    c = estimate(index, has_order_by, ef_search)
    return c.total_cost < brute_force_cost(float(index.num_tuples))
