"""Shared/exclusive update lock — the reference's HNSW_UPDATE_LOCK.

The reference takes the page lock SHARED for a normal insert, so the
expensive neighbor search runs in parallel across backends, and
EXCLUSIVE only when the insert will (likely) update the entry point,
plus for vacuum (reference `src/index/insert.rs:1291-1313`,
`vacuum.rs`). Per-element writes are then serialized by per-page
buffer locks. This is the in-process analog: `HnswIndex.insert` holds
it shared around the Algorithm-1 search and uses the index's small
mutate lock (the buffer-lock analog) for the connect step; vacuum /
delete / checkpoint / bulk ops hold it exclusive.

Readers (scans) stay lock-free, exactly like the reference's scan path.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class UpdateLock:
    """Writer-preferring shared/exclusive lock.

    - many concurrent ``shared()`` holders;
    - one ``exclusive()`` holder, reentrant per-thread;
    - a waiting exclusive blocks NEW shared acquisitions (vacuum can't
      be starved by a stream of inserts);
    - a thread holding exclusive may nest ``shared()`` (no-op);
    - taking exclusive while holding only shared raises (would
      self-deadlock) — release shared and re-validate instead, the way
      insert.rs re-reads the meta page after its lock upgrade.
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._shared: dict[int, int] = {}  # thread ident -> hold depth
        self._excl_owner: int | None = None
        self._excl_depth = 0
        self._excl_waiting = 0

    # -- shared ------------------------------------------------------------

    def acquire_shared(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._excl_owner == me:  # nested under own exclusive
                self._excl_depth += 1
                return
            while self._excl_owner is not None or (
                self._excl_waiting and me not in self._shared
            ):
                self._cond.wait()
            self._shared[me] = self._shared.get(me, 0) + 1

    def release_shared(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._excl_owner == me:
                self._excl_depth -= 1
                return
            depth = self._shared.get(me, 0)
            if depth <= 0:
                raise RuntimeError("release_shared without acquire_shared")
            if depth == 1:
                del self._shared[me]
            else:
                self._shared[me] = depth - 1
            if not self._shared:
                self._cond.notify_all()

    # -- exclusive -----------------------------------------------------------

    def acquire_exclusive(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._excl_owner == me:
                self._excl_depth += 1
                return
            if me in self._shared:
                raise RuntimeError(
                    "cannot upgrade shared -> exclusive (release shared "
                    "and re-validate, like insert.rs's lock upgrade)"
                )
            self._excl_waiting += 1
            try:
                while self._excl_owner is not None or self._shared:
                    self._cond.wait()
            finally:
                self._excl_waiting -= 1
            self._excl_owner = me
            self._excl_depth = 1

    def release_exclusive(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._excl_owner != me:
                raise RuntimeError(
                    "release_exclusive by non-owner thread"
                )
            self._excl_depth -= 1
            if self._excl_depth == 0:
                self._excl_owner = None
                self._cond.notify_all()

    # -- context managers ------------------------------------------------

    @contextmanager
    def shared(self):
        self.acquire_shared()
        try:
            yield
        finally:
            self.release_shared()

    @contextmanager
    def exclusive(self):
        self.acquire_exclusive()
        try:
            yield
        finally:
            self.release_exclusive()
