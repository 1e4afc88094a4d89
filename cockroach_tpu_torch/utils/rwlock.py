"""Reader-writer lock with writer preference and write reentrancy.

The port's copy of cockroach_tpu/utils/rwlock.py: the engine's
statement gate (one global statement lock would serialize every
session). Plain read-only SELECTs share the lock; DML/DDL/txn
statements and anything that mutates engine-shared state take it
exclusively. Writer preference
keeps a stream of reads from starving writes (the reference instead
runs a connExecutor per connection against individually thread-safe
subsystems; this is the coarse-grained first step with the same
observable concurrency for read-mostly workloads).

Semantics:
- acquire_write is reentrant (RLock-like) — background jobs invoke
  statements while already holding the gate.
- acquire_read while holding write is a write reentry (no-op
  downgrade hazards).
- acquire_write while holding ONLY read raises: lock upgrades
  deadlock by construction, the caller must classify up front.
- ``with lock:`` takes the WRITE side, so existing `with
  engine._stmt_lock:` call sites keep their exclusive semantics.
"""

from __future__ import annotations

import threading


class RWLock:
    def __init__(self):
        self._cond = threading.Condition()
        self._readers: dict[int, int] = {}   # thread ident -> depth
        self._writer: int | None = None
        self._wdepth = 0
        self._waiting_writers = 0

    # -- read side ---------------------------------------------------------
    def acquire_read(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._wdepth += 1          # reentry under write
                return
            if me in self._readers:
                self._readers[me] += 1
                return
            while self._writer is not None or self._waiting_writers:
                self._cond.wait()
            self._readers[me] = 1

    def release_read(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._wdepth -= 1
                if self._wdepth == 0:
                    self._writer = None
                    self._cond.notify_all()
                return
            d = self._readers[me] - 1
            if d:
                self._readers[me] = d
            else:
                del self._readers[me]
                if not self._readers:
                    self._cond.notify_all()

    # -- write side --------------------------------------------------------
    def acquire_write(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._wdepth += 1
                return
            if me in self._readers:
                raise RuntimeError(
                    "read->write lock upgrade would deadlock; "
                    "classify the statement as a writer up front")
            self._waiting_writers += 1
            try:
                while self._writer is not None or self._readers:
                    self._cond.wait()
            finally:
                self._waiting_writers -= 1
            self._writer = me
            self._wdepth = 1

    def release_write(self) -> None:
        me = threading.get_ident()
        with self._cond:
            assert self._writer == me, "release_write by non-owner"
            self._wdepth -= 1
            if self._wdepth == 0:
                self._writer = None
                self._cond.notify_all()

    # `with lock:` == exclusive (backward compatible with the old RLock)
    def __enter__(self) -> "RWLock":
        self.acquire_write()
        return self

    def __exit__(self, *exc) -> None:
        self.release_write()
