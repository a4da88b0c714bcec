"""Typed configuration: the TPU-native analog of reloptions and GUCs.

Parity source: reference ``src/index/options.rs`` (pgvector-rx).
- ``IndexParams`` <-> per-index reloptions ``m`` / ``ef_construction``
  (options.rs:114-122, :203-225), frozen at build time, persisted in the
  index metadata (the meta-page analog).
- ``SearchParams`` <-> per-session GUCs ``hnsw.ef_search``,
  ``hnsw.iterative_scan``, ``hnsw.max_scan_tuples``,
  ``hnsw.scan_mem_multiplier`` (options.rs:81-96, :156-198).

All range validation matches the reference's GUC/reloption ranges so the
options tests transfer.
"""

from __future__ import annotations

import dataclasses

from . import constants as C

_ITERATIVE_MODES = (
    C.HNSW_ITERATIVE_SCAN_OFF,
    C.HNSW_ITERATIVE_SCAN_RELAXED,
    C.HNSW_ITERATIVE_SCAN_STRICT,
)


def _check_range(name: str, value: int, lo: int, hi: int) -> None:
    if not (lo <= value <= hi):
        raise ValueError(f'value {value} out of bounds for option "{name}" ({lo} .. {hi})')


@dataclasses.dataclass(frozen=True)
class IndexParams:
    """Build-time index parameters (reloption analog, options.rs:114-122).

    Invariant enforced at build: ``ef_construction >= 2 * m``
    (reference build.rs:865-867).
    """

    m: int = C.HNSW_DEFAULT_M
    ef_construction: int = C.HNSW_DEFAULT_EF_CONSTRUCTION

    def __post_init__(self) -> None:
        _check_range("m", self.m, C.HNSW_MIN_M, C.HNSW_MAX_M)
        _check_range(
            "ef_construction",
            self.ef_construction,
            C.HNSW_MIN_EF_CONSTRUCTION,
            C.HNSW_MAX_EF_CONSTRUCTION,
        )

    def validate_for_build(self) -> None:
        if self.ef_construction < 2 * self.m:
            raise ValueError("ef_construction must be greater than or equal to 2 * m")


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Per-query search parameters (GUC analog, options.rs:81-96).

    ``scan_mem_multiplier``: the reference registers this GUC but never
    consults it in the scan path (SURVEY.md "Config / flag system"
    note). Here it IS enforced, restoring upstream pgvector's intent:
    an iterative scan stops resuming once its persistent state
    (visited set + discarded heap) exceeds
    ``scan_mem_multiplier * work_mem_bytes`` and drains the remaining
    discarded candidates instead (the same degradation path as
    max_scan_tuples, scan.rs:828-841).
    """

    ef_search: int = C.HNSW_DEFAULT_EF_SEARCH
    iterative_scan: str = C.HNSW_ITERATIVE_SCAN_OFF
    max_scan_tuples: int = C.HNSW_DEFAULT_MAX_SCAN_TUPLES
    scan_mem_multiplier: float = C.HNSW_DEFAULT_SCAN_MEM_MULTIPLIER
    # PostgreSQL work_mem default (4MB); the memory budget base for
    # iterative scan state
    work_mem_bytes: int = 4 * 1024 * 1024

    def __post_init__(self) -> None:
        _check_range(
            "hnsw.ef_search", self.ef_search, C.HNSW_MIN_EF_SEARCH, C.HNSW_MAX_EF_SEARCH
        )
        if self.iterative_scan not in _ITERATIVE_MODES:
            raise ValueError(
                f'invalid value for parameter "hnsw.iterative_scan": "{self.iterative_scan}"'
            )
        if self.max_scan_tuples < 1:
            raise ValueError(
                f'value {self.max_scan_tuples} out of bounds for option "hnsw.max_scan_tuples"'
            )
        if not (1.0 <= self.scan_mem_multiplier <= 1000.0):
            raise ValueError(
                f"value {self.scan_mem_multiplier} out of bounds for option "
                f'"hnsw.scan_mem_multiplier" (1 .. 1000)'
            )
