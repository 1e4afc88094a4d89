"""Per-device memory and transfer scheduler (cockroach_tpu/exec/
movement.py).

Every path that moves table bytes onto the card reserves them here,
against the engine's one ``BytesMonitor`` (utils/mon.py), whose limit
is ``sql.exec.hbm_budget_bytes``:

* **resident** (``reserve_resident``/``release_resident``): the cached
  device copies of whole tables. These never wait: an over-budget
  upload raises MemoryQuotaError at once.
* **transient** (``lease``/``soft_lease``): the working window of a
  streamed scan (the page computing plus the pages in flight) or of a
  spill partition. A ``lease`` that finds the pool full of other
  transient leases waits for them to drain; a ``soft_lease`` admits
  when there is room and otherwise proceeds unreserved (the estimate
  is ours, the allocation happens regardless).
* **exchange** (``exchange_lease``): a distributed dispatch's shuffle
  and merge buffers. It waits for other transient traffic like a
  ``lease``, but on a pool full of resident bytes it proceeds
  unreserved and counts the overcommit instead of failing the query.

The ``exec.movement.*`` counters read the bytes admitted, leases, time
spent waiting, and the overlap seconds (host assembly and upload time
hidden behind device compute) the paged paths report.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager

from ..utils.mon import MemoryQuotaError

KIND_PAGE = "page"     # stream / spill page windows
KIND_SPILL = "spill"   # spill partition working slices
KIND_EXCHANGE = "exchange"  # a distributed dispatch's exchange buffers
KIND_REBALANCE = "rebalance"  # shard-lease handoff pages (elastic pod)
_KINDS = (KIND_PAGE, KIND_SPILL, KIND_REBALANCE)

# the longest a lease waits for other transient traffic to drain
WAIT_TIMEOUT = 120.0


class TransferScheduler:
    """One per engine; owns admission to the device-byte pool."""

    def __init__(self, monitor, metrics, wait_timeout: float = WAIT_TIMEOUT):
        self.monitor = monitor
        self.wait_timeout = wait_timeout
        self._cv = threading.Condition()
        self._transient = 0
        self._ids = itertools.count()
        self.m_h2d = metrics.counter(
            "exec.movement.h2d.bytes",
            "host->device bytes admitted through the scheduler")
        self.m_inflight = metrics.gauge(
            "exec.movement.inflight.bytes",
            "transient (lease-held) bytes currently reserved")
        self.m_wait = metrics.histogram(
            "exec.movement.wait_seconds",
            "time leases spent waiting for the pool to drain")
        self.m_leases = metrics.counter(
            "exec.movement.leases", "transient transfer leases granted")
        self.m_overlap = metrics.counter(
            "exec.movement.overlap_seconds",
            "host transfer seconds hidden behind device compute")
        self.m_exchange = metrics.counter(
            "exec.movement.exchange.bytes",
            "peer-exchange/shuffle bytes admitted through the scheduler")
        self.m_exch_overcommit = metrics.counter(
            "exec.movement.exchange.overcommit.bytes",
            "exchange bytes that proceeded unreserved after waiting "
            "for the pool (admission degraded, not denied)")
        self.m_rebalance = metrics.counter(
            "exec.movement.rebalance.bytes",
            "shard-lease rebalance bytes streamed between hosts "
            "through the scheduler")
        self.m_spill_fallbacks = metrics.counter(
            "exec.movement.dist_spill_fallbacks",
            "DistSQL shards that spilled past their HBM slice instead "
            "of failing")

    # -- resident ------------------------------------------------------
    def reserve_resident(self, account, nbytes: int) -> None:
        """Admit a long-lived device-table upload, or raise
        MemoryQuotaError."""
        self.monitor.reserve(account, nbytes)
        self.m_h2d.inc(nbytes)

    def release_resident(self, account) -> int:
        n = self.monitor.release(account)
        if n:
            with self._cv:
                self._cv.notify_all()
        return n

    # -- transient -----------------------------------------------------
    def transient_bytes(self) -> int:
        return self._transient

    def _admit(self, account, nbytes: int) -> None:
        """Reserve, waiting while other transient leases hold the
        pool; fail at once when only resident bytes fill it."""
        deadline = None
        waited = 0.0
        while True:
            try:
                self.monitor.reserve(account, nbytes)
                if waited:
                    self.m_wait.observe(waited)
                return
            except MemoryQuotaError:
                with self._cv:
                    if self._transient <= 0:
                        raise
                    if deadline is None:
                        deadline = time.monotonic() + self.wait_timeout
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise
                    t0 = time.monotonic()
                    self._cv.wait(timeout=min(remaining, 1.0))
                    waited += time.monotonic() - t0

    def _hold(self, nbytes: int, kind: str = KIND_PAGE):
        with self._cv:
            self._transient += nbytes
        self.m_leases.inc()
        self.m_inflight.set(self._transient)
        (self.m_rebalance if kind == KIND_REBALANCE else self.m_h2d).inc(
            nbytes)

    def _drop(self, account, nbytes: int) -> None:
        self.monitor.release(account)
        with self._cv:
            self._transient -= nbytes
            self._cv.notify_all()
        self.m_inflight.set(self._transient)

    @contextmanager
    def lease(self, kind: str, nbytes: int):
        """Context-managed transient reservation (``nbytes <= 0`` is a
        no-op)."""
        assert kind in _KINDS, kind
        nbytes = int(nbytes)
        if nbytes <= 0:
            yield 0
            return
        account = ("movement", kind, next(self._ids))
        self._admit(account, nbytes)
        self._hold(nbytes, kind)
        try:
            yield nbytes
        finally:
            self._drop(account, nbytes)

    @contextmanager
    def soft_lease(self, kind: str, nbytes: int):
        """Best-effort transient reservation: admits when the pool has
        room, else yields 0 and proceeds unreserved."""
        assert kind in _KINDS, kind
        nbytes = int(nbytes)
        if nbytes <= 0:
            yield 0
            return
        account = ("movement", kind, next(self._ids))
        try:
            self.monitor.reserve(account, nbytes)
        except MemoryQuotaError:
            yield 0
            return
        self._hold(nbytes, kind)
        try:
            yield nbytes
        finally:
            self._drop(account, nbytes)

    @contextmanager
    def exchange_lease(self, nbytes: int):
        """Lease for a distributed dispatch's exchange buffers: waits for
        other transient traffic to drain as a ``lease`` does, but on a
        genuinely full pool degrades to a counted overcommit rather
        than failing the query (the buffers are allocated either way)."""
        nbytes = int(nbytes)
        if nbytes <= 0:
            yield 0
            return
        account = ("movement", KIND_EXCHANGE, next(self._ids))
        try:
            self._admit(account, nbytes)
        except MemoryQuotaError:
            self.m_exchange.inc(nbytes)
            self.m_exch_overcommit.inc(nbytes)
            yield 0
            return
        self.m_exchange.inc(nbytes)
        with self._cv:
            self._transient += nbytes
        self.m_leases.inc()
        self.m_inflight.set(self._transient)
        try:
            yield nbytes
        finally:
            self._drop(account, nbytes)

    def note_overlap(self, seconds: float) -> None:
        if seconds > 0:
            self.m_overlap.inc(seconds)

    def note_exchange(self, nbytes: int) -> None:
        """Account exchange bytes that move through paths which manage
        their own buffers (DistSQL wire frames)."""
        if nbytes > 0:
            self.m_exchange.inc(nbytes)
