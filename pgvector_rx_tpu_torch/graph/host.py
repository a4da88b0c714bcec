"""Host (pure Python/numpy) HNSW graph algorithms.

Parity source: reference ``src/graph/mod.rs`` (pgvector-rx). Each function
mirrors one reference algorithm:

- :func:`search_layer`             <-> graph/mod.rs:161-255  (HNSW Alg. 2)
- :func:`select_neighbors`         <-> graph/mod.rs:269-339  (HNSW Alg. 4)
- :func:`find_element_neighbors`   <-> graph/mod.rs:355-427  (HNSW Alg. 1)
- :func:`update_neighbor_connections` <-> graph/mod.rs:442-489

The graph is an arena of elements with per-layer neighbor lists of
(distance, idx) candidates, parameterized by distance callbacks — the
same shape as the reference's ``GraphElement`` + ``DistanceFn`` design
(graph/mod.rs:57-84,:144-145), except distances are computed in batches
(one numpy call per neighbor-list expansion instead of one FFI call per
pair, scan.rs:155-228): results are bit-identical because the sequential
add/evict logic is applied to the precomputed values in the same order.

This layer is deliberately pg-free *and* jax-free. The device
implementation (:mod:`pgvector_rx_tpu.graph.device`) is validated
against this module.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np

from ..constants import hnsw_get_layer_m

#: dist_many(query, ids) -> float32 array of order-distances. ``query`` is
#: opaque to this module (an element index, raw value, ...).
DistManyFn = Callable[[object, Sequence[int]], np.ndarray]
#: pair_many(idx, ids) -> float32 array of element-to-element distances.
PairManyFn = Callable[[int, Sequence[int]], np.ndarray]


@dataclass
class GraphElement:
    """Parity: graph/mod.rs:57-84. neighbors[layer] is a list of (dist, idx)."""

    level: int
    neighbors: list = field(default_factory=list)  # list[layer] -> list[(d, idx)]
    deleted: bool = False
    version: int = 1

    def __post_init__(self):
        if not self.neighbors:
            self.neighbors = [[] for _ in range(self.level + 1)]


def search_layer(
    elements: Sequence[GraphElement],
    entry_points: list[tuple[float, int]],
    ef: int,
    layer: int,
    query,
    dist_many: DistManyFn,
    visited: Optional[set] = None,
    discarded: Optional[list] = None,
    add_entry_to_visited: bool = True,
    skip_count: Optional[set] = None,
) -> list[tuple[float, int]]:
    """HNSW Algorithm 2. Returns up to ef candidates sorted nearest first.

    Parity: graph/mod.rs:161-255 for the core; the optional
    ``visited``/``discarded``/``add_entry_to_visited``/``skip_count``
    arguments mirror the on-disk variant used for iterative scan and
    vacuum repair (scan.rs:301-433).

    ``discarded`` (a heapq min-heap of (d, idx)) collects candidates
    rejected or evicted once ef results exist — iterative-scan fuel.
    """
    if visited is None:
        visited = set()
    candidates: list[tuple[float, int]] = []  # min-heap (nearest first)
    results: list[tuple[float, int]] = []  # max-heap via negated distance
    w_len = 0

    for d, idx in entry_points:
        if add_entry_to_visited:
            visited.add(idx)
        heapq.heappush(candidates, (d, idx))
        heapq.heappush(results, (-d, idx))
        if skip_count is None or idx not in skip_count:
            w_len += 1

    while candidates:
        c_dist, c_idx = heapq.heappop(candidates)
        f_dist = -results[0][0] if results else float("inf")
        if c_dist > f_dist:
            if discarded is not None:
                heapq.heappush(discarded, (c_dist, c_idx))
            break

        c_elem = elements[c_idx]
        if c_elem.level < layer:
            continue

        # Batch: unvisited, live, at-layer neighbors of c (list order kept)
        todo: list[int] = []
        for _, n_idx in c_elem.neighbors[layer]:
            if n_idx in visited:
                continue
            visited.add(n_idx)
            e_elem = elements[n_idx]
            # On-disk parity: deleted elements fail load_element
            # (scan.rs:155-228); below-layer elements are skipped
            # (graph/mod.rs:213-216).
            if e_elem.deleted or e_elem.level < layer:
                continue
            todo.append(n_idx)
        if not todo:
            continue
        dists = dist_many(query, todo)

        for e_distance, n_idx in zip(dists, todo):
            e_distance = float(e_distance)
            always_add = w_len < ef
            f_dist = -results[0][0] if results else float("inf")
            if e_distance < f_dist or always_add:
                heapq.heappush(candidates, (e_distance, n_idx))
                heapq.heappush(results, (-e_distance, n_idx))
                if skip_count is None or n_idx not in skip_count:
                    w_len += 1
                if w_len > ef:
                    ev_d, ev_idx = heapq.heappop(results)
                    w_len -= 1
                    if discarded is not None:
                        heapq.heappush(discarded, (-ev_d, ev_idx))
            elif discarded is not None:
                heapq.heappush(discarded, (e_distance, n_idx))

    if discarded is not None:
        while candidates:
            heapq.heappush(discarded, heapq.heappop(candidates))

    out = sorted(((-d, idx) for d, idx in results), key=lambda t: (t[0], t[1]))
    return out


def check_element_closer(
    e: tuple[float, int],
    kept: list[tuple[float, int]],
    pair_many: PairManyFn,
) -> bool:
    """True iff e is closer to the query than to every kept neighbor.

    Parity: graph/mod.rs:315-339 (distance <= e.distance -> reject).
    """
    if not kept:
        return True
    e_dist, e_idx = e
    dists = pair_many(e_idx, [r_idx for _, r_idx in kept])
    return bool(np.all(dists > e_dist))


def select_neighbors(
    candidates: list[tuple[float, int]],
    max_neighbors: int,
    pair_many: PairManyFn,
) -> list[tuple[float, int]]:
    """HNSW Algorithm 4 heuristic. Parity: graph/mod.rs:269-308.

    ``candidates`` must be sorted nearest first. Returns at most
    ``max_neighbors``, keeping diversity, backfilling from discarded.

    The candidate-to-candidate distances are precomputed as one batched
    call per candidate row (identical results to the reference's
    pair-at-a-time calls; the greedy keep/discard loop is unchanged).
    """
    if len(candidates) <= max_neighbors:
        return list(candidates)

    ids = [idx for _, idx in candidates]
    # full candidate x candidate distance matrix in one batched call
    pm = getattr(pair_many, "pair_matrix", None)
    if pm is not None:
        mat = pm(ids)
    else:
        mat = np.stack([pair_many(i, ids) for i in ids])

    result: list[tuple[float, int]] = []
    kept_pos: list[int] = []
    discarded: list[tuple[float, int]] = []
    for ci, e in enumerate(candidates):
        if len(result) >= max_neighbors:
            break
        e_dist = e[0]
        r = mat[ci]
        closer = True
        for kp in kept_pos:
            if r[kp] <= e_dist:
                closer = False
                break
        if closer:
            result.append(e)
            kept_pos.append(ci)
        else:
            discarded.append(e)
    for d in discarded:
        if len(result) >= max_neighbors:
            break
        result.append(d)
    return result


def find_element_neighbors(
    elements: Sequence[GraphElement],
    new_idx: int,
    entry_idx: int,
    ef_construction: int,
    m: int,
    dist_many: DistManyFn,
    pair_many: PairManyFn,
    skip: Optional[set] = None,
    query=None,
) -> None:
    """HNSW Algorithm 1 (insert search). Parity: graph/mod.rs:355-427.

    Sets ``elements[new_idx].neighbors`` per layer. ``skip`` supports the
    vacuum-repair variant (skip = deleted ∪ {self}, searched with ef+1 —
    insert.rs:1080-1110): skipped elements are used for traversal but
    excluded from selection. ``query`` defaults to ``new_idx``.
    """
    if query is None:
        query = new_idx
    new_level = elements[new_idx].level
    entry_level = elements[entry_idx].level

    ep = [(float(dist_many(query, [entry_idx])[0]), entry_idx)]

    for lc in range(entry_level, new_level, -1):
        w = search_layer(elements, ep, 1, lc, query, dist_many)
        if w:
            ep = [w[0]]

    ef = ef_construction + (1 if skip else 0)
    start_level = min(new_level, entry_level)
    for lc in range(start_level, -1, -1):
        lm = hnsw_get_layer_m(m, lc)
        w = search_layer(elements, ep, ef, lc, query, dist_many, skip_count=skip)
        cands = [c for c in w if skip is None or c[1] not in skip]
        neighbors = select_neighbors(cands, lm, pair_many)
        elements[new_idx].neighbors[lc] = list(neighbors)
        ep = w


def update_neighbor_connections(
    elements: Sequence[GraphElement],
    new_idx: int,
    m: int,
    pair_many: PairManyFn,
) -> None:
    """Add back-edges from each selected neighbor to the new element,
    pruning with Algorithm 4 when a list is full.

    Parity: graph/mod.rs:442-489.
    """
    new_level = elements[new_idx].level
    for lc in range(new_level, -1, -1):
        lm = hnsw_get_layer_m(m, lc)
        for hc_dist, hc_idx in list(elements[new_idx].neighbors[lc]):
            new_candidate = (hc_dist, new_idx)
            neighbors = elements[hc_idx].neighbors[lc]
            if len(neighbors) < lm:
                neighbors.append(new_candidate)
            else:
                all_candidates = sorted(
                    neighbors + [new_candidate], key=lambda t: (t[0], t[1])
                )
                elements[hc_idx].neighbors[lc] = select_neighbors(
                    all_candidates, lm, pair_many
                )
