"""Observability counters.

The reference's observable surface is pgstat scan counting
(scan.rs:718-729), the build-progress phase API (handler.rs:110-116) and
EXPLAIN ANALYZE; SURVEY.md §5 calls for "an explicit stats struct
(distances computed, pages/nodes visited, resume count)" in the TPU
build — this module is that struct. ``HnswIndex.stats`` holds an
:class:`IndexStats`-shaped dict; scans can carry a :class:`ScanStats`.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class IndexStats:
    """Per-index counters (pgstat analog)."""

    scans: int = 0  # amgettuple first-calls (pgstat numscans parity)
    inserts: int = 0
    duplicates: int = 0  # TIDs absorbed into existing elements
    resumes: int = 0  # iterative-scan re-entries

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ScanStats:
    """Per-scan counters (EXPLAIN ANALYZE analog)."""

    nodes_visited: int = 0
    distances_computed: int = 0
    tuples_returned: int = 0
    resumes: int = 0
    beam_steps: int = 0  # device search loop iterations

    def merge(self, other: "ScanStats") -> None:
        self.nodes_visited += other.nodes_visited
        self.distances_computed += other.distances_computed
        self.tuples_returned += other.tuples_returned
        self.resumes += other.resumes
        self.beam_steps += other.beam_steps
