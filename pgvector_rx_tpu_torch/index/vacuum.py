"""Delete + vacuum: heap-TID removal, graph repair, slot recycling.

Parity source: reference ``src/index/vacuum.rs`` (ambulkdelete's three
passes, vacuum.rs:816-840):

1. :func:`delete_tids` / pass 1 <-> remove_heap_tids (vacuum.rs:118-217):
   drop dead heap TIDs from each element; elements left with none join
   the ``deleted`` set; track the highest-level survivor.
2. repair pass <-> repair_graph (vacuum.rs:288-544): repair the entry
   point first (replace with the highest survivor, or clear), then for
   every live element whose neighbor lists reference a deleted element
   or whose layer-0 list is unfilled (needs_updated, vacuum.rs:228-281),
   re-run the insert search with skip = deleted ∪ {self} and overwrite
   its neighbor lists wholesale.
3. mark pass <-> mark_deleted (vacuum.rs:655-793): zero the value, clear
   neighbors, set deleted, bump version (wrap 15 -> 1, vacuum.rs:797-803)
   and make the slot reusable for inserts.
"""

from __future__ import annotations

from .. import constants as C
from ..graph import host


def delete_tids(index, tids) -> int:
    """Remove heap TIDs from the index (the bulkdelete callback analog).

    Marks elements dead when all their TIDs are gone, then runs the
    repair + mark passes. Returns the number of elements deleted.
    """
    dead = set(int(t) for t in tids)
    index._invalidate_device()

    # Pass 1: remove TIDs, collect fully-dead elements
    deleted: set[int] = set()
    for idx, elem in enumerate(index.elements):
        if elem.deleted:
            continue
        kept = [t for t in index.heap_tids[idx] if t not in dead]
        if len(kept) != len(index.heap_tids[idx]):
            index.heap_tids[idx] = kept
            if not kept:
                deleted.add(idx)

    if index._log is not None:
        index._log.record_delete(sorted(dead))

    if deleted:
        if not _repair_graph_native(index, deleted):
            _repair_graph(index, deleted)
        _mark_deleted(index, deleted)
    return len(deleted)


def _repair_graph_native(index, deleted: set) -> bool:
    """Pass 2 on the native engine (~100x the Python repair on large
    deletes). Returns False to fall back to the Python path."""
    import os

    if os.environ.get("PGV_DISABLE_NATIVE"):
        return False
    from .. import native

    if not native.available():
        return False
    native.native_vacuum(index, deleted)
    return True


def run_vacuum(index) -> dict:
    """Explicit vacuum entry point: repairs any half-dead state left by
    prior deletes (amvacuumcleanup analog). delete_tids already runs the
    repair passes eagerly, so this validates and reports stats."""
    stats = {
        "num_elements": len(index.elements),
        "live_elements": index.count,
        "free_slots": len(index.free_slots),
        "num_tuples": index.num_tuples,
    }
    return stats


def _highest_survivor(index, deleted: set) -> int | None:
    """Highest-level live element, preferring lowest idx on ties
    (the reference keeps the first encountered on its page walk,
    vacuum.rs:182-205)."""
    best = None
    best_level = -1
    for idx, elem in enumerate(index.elements):
        if elem.deleted or idx in deleted or not index.heap_tids[idx]:
            continue
        if elem.level > best_level:
            best, best_level = idx, elem.level
    return best


def _needs_updated(index, idx: int, deleted: set) -> bool:
    """Parity: vacuum.rs:228-281 — references a deleted element, or the
    layer-0 list is not full."""
    elem = index.elements[idx]
    for layer_list in elem.neighbors:
        for _, n_idx in layer_list:
            if n_idx in deleted:
                return True
    lm0 = C.hnsw_get_layer_m(index.params.m, 0)
    if len(elem.neighbors[0]) < lm0:
        return True
    return False


def _repair_element(index, idx: int, entry_idx: int | None, deleted: set) -> None:
    """Re-find neighbors with skip = deleted ∪ {self}, overwrite lists.

    Parity: repair_graph_element (vacuum.rs:288-407) →
    find_element_neighbors_on_disk with skip (insert.rs:1080-1110).
    """
    if entry_idx is None:
        # No usable entry: clear neighbor lists (graph rebuilt as empty)
        elem = index.elements[idx]
        elem.neighbors = [[] for _ in range(elem.level + 1)]
        return
    # Searching from the element itself is fine: its old links are
    # traversed while skip excludes it from selection (insert.rs:1104-1110)
    skip = set(deleted)
    skip.add(idx)
    host.find_element_neighbors(
        index.elements,
        idx,
        entry_idx,
        index.params.ef_construction,
        index.params.m,
        index._dist_many,
        index._pair_many,
        skip=skip,
    )


def _repair_graph(index, deleted: set) -> None:
    """Pass 2. Parity: repair_graph + repair_graph_entry_point
    (vacuum.rs:413-544)."""
    highest = _highest_survivor(index, deleted)

    # Repair the highest point first so it can serve as entry. The search
    # runs from the OLD entry point: to-be-deleted elements stay
    # traversable until the mark pass, exactly like the reference, where
    # pass 3 runs after pass 2 (vacuum.rs:413-447 searches via the old
    # graph with skip = deleted).
    if highest is not None and _needs_updated(index, highest, deleted):
        _repair_element(index, highest, index.entry, deleted)

    # Entry point replacement / repair (vacuum.rs:455-524)
    if index.entry is not None:
        if index.entry in deleted:
            index.entry = highest  # may be None -> empty graph
        elif _needs_updated(index, index.entry, deleted):
            ep_for_repair = highest if highest is not None else index.entry
            _repair_element(index, index.entry, ep_for_repair, deleted)

    # Repair every other live element that references a deleted one or
    # has unfilled layer-0 slots
    for idx, elem in enumerate(index.elements):
        if elem.deleted or idx in deleted or idx == index.entry or idx == highest:
            continue
        if not index.heap_tids[idx]:
            continue
        if _needs_updated(index, idx, deleted):
            _repair_element(index, idx, index.entry, deleted)


def _mark_deleted(index, deleted: set) -> None:
    """Pass 3. Parity: mark_deleted (vacuum.rs:655-793): zero value,
    clear neighbors, set deleted, bump version 15 -> 1 wrap, free slot."""
    for idx in deleted:
        elem = index.elements[idx]
        elem.deleted = True
        elem.neighbors = [[] for _ in range(elem.level + 1)]
        elem.version = 1 if elem.version >= C.HNSW_MAX_VERSION else elem.version + 1
        index.store.zero(idx)
        index.heap_tids[idx] = []
        index.free_slots.append(idx)
    # Drop any stale forward-references from live elements to the dead
    for elem in index.elements:
        if elem.deleted:
            continue
        for lc, layer_list in enumerate(elem.neighbors):
            elem.neighbors[lc] = [
                (d, n) for d, n in layer_list if n not in deleted
            ]
