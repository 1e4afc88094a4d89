"""Admission control: bounded, fair-queued statement admission.

The analogue of pkg/util/admission (work queues in front of each
resource). Here the guarded resource is engine execution slots: each
statement acquires a slot before running; when slots are exhausted,
waiters queue and a bounded queue rejects overload with a clean error
instead of letting latency grow unboundedly (the reference's
admission.WorkQueue ordering + the sql.conn.max_open semantics folded
together).

Ordering is strict priority tiers (high > normal > low, the
WorkPriority analogue) with per-tenant weighted fair queueing inside a
tier: each tenant (session / application_name) carries a virtual
finish time advanced by 1/weight per admitted statement, so a tenant
flooding the queue interleaves with — rather than starves — the
others, like the reference's tenant-weighted WorkQueue heap ordering.

Load shedding: when queue depth, the recent grant-wait EWMA, or the
live device-dispatcher backlog crosses the shed thresholds (wired to
sql.admission.shed.* cluster settings), low-priority work is rejected
up front with ``AdmissionRejected`` rather than queued into unbounded
p99 growth.

Tenant quotas (sql.admission.tenant.*): beyond WFQ *ordering*, the
controller enforces hard per-tenant budgets at dispatch — a cap on
concurrently held slots and a ledger of in-flight estimated HBM bytes.
A statement whose tenant is at quota queues (even while global slots
are free) until one of that tenant's own statements releases; other
tenants' statements bypass it. A tenant with zero in-flight HBM is
always HBM-eligible, so a single over-budget statement can run alone
rather than deadlock.

The port's copy of cockroach_tpu/utils/admission.py. The port runs
each statement on its caller's thread, so the "dispatcher backlog" it
can show is the writers waiting at the statement gate.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field

PRIORITIES = {"high": 0, "normal": 1, "low": 2}

# EWMA smoothing for the recent grant-wait signal that drives shedding.
_WAIT_ALPHA = 0.3


class AdmissionRejected(Exception):
    pass


@dataclass(order=True)
class _Waiter:
    # (priority tier, virtual finish time, arrival seq): strict
    # priority first, weighted fair order within the tier, FIFO as the
    # final tie-break.
    rank: tuple
    event: threading.Event = field(compare=False)
    granted: bool = field(default=False, compare=False)
    t_enq: float = field(default=0.0, compare=False)
    tenant: str = field(default="", compare=False)
    hbm: int = field(default=0, compare=False)


class AdmissionController:
    def __init__(self, slots: int = 4, max_queue: int = 64):
        self.slots = slots
        self.max_queue = max_queue
        self._mu = threading.Lock()
        self._in_use = 0
        self._queue: list[_Waiter] = []
        self._seq = itertools.count()
        # per-tenant fair-queue state
        self._weights: dict[str, float] = {}
        self._vfinish: dict[str, float] = {}
        self._vclock = 0.0
        # shed thresholds (0 disables); wired from sql.admission.shed.*
        self.shed_queue_depth = 0
        self.shed_wait_seconds = 0.0
        self.shed_exec_queue_depth = 0
        self._wait_ewma = 0.0
        # per-tenant quota ledger (0 disables each); wired from
        # sql.admission.tenant.*
        self.tenant_slots = 0
        self.tenant_hbm_bytes = 0
        self._tenant_in_use: dict[str, int] = {}
        self._tenant_hbm: dict[str, int] = {}
        # counters (always mutated under _mu)
        self.admitted = 0
        self.rejected = 0
        self.queued = 0
        self.shed = 0
        self.tenant_slot_waits = 0
        self.tenant_hbm_waits = 0
        # optional hook: called with the grant wait in seconds for
        # every admission that had to queue (engine wires a histogram)
        self.wait_observer = None
        # optional hook: () -> p99 seconds of the data-movement wait
        # histogram (exec.movement.wait_seconds). When it crosses
        # shed_wait_seconds, the device interconnect is the bottleneck
        # — queueing MORE low-priority work only grows transfer-stall
        # p99 — so shedding triggers even while the grant-wait EWMA
        # still looks healthy. Never called under _mu by callers; we
        # call it inside _should_shed_locked, so it must not call back
        # into this controller.
        self.movement_wait_p99 = None
        # optional hook: () -> live device-dispatcher queue depth
        # (exec.device.queue.depth). When it crosses
        # shed_exec_queue_depth the mesh itself is backlogged; same
        # no-callback contract as movement_wait_p99.
        self.exec_queue_depth = None

    def set_weight(self, tenant: str, weight: float) -> None:
        with self._mu:
            self._weights[tenant] = max(float(weight), 1e-6)

    def _vft(self, tenant: str) -> float:
        """Virtual finish time for the tenant's next statement."""
        w = self._weights.get(tenant, 1.0)
        start = max(self._vclock, self._vfinish.get(tenant, 0.0))
        vft = start + 1.0 / w
        self._vfinish[tenant] = vft
        return vft

    def _quota_block_locked(self, tenant: str, hbm: int):
        """Why the tenant's quota blocks this statement: None when
        eligible, else "slots" / "hbm"."""
        if not tenant:
            return None
        if (self.tenant_slots
                and self._tenant_in_use.get(tenant, 0) >= self.tenant_slots):
            return "slots"
        if self.tenant_hbm_bytes and hbm:
            held = self._tenant_hbm.get(tenant, 0)
            # held == 0: always eligible — a statement bigger than the
            # whole tenant budget runs alone instead of deadlocking.
            if held and held + hbm > self.tenant_hbm_bytes:
                return "hbm"
        return None

    def _first_eligible_locked(self):
        """Index of the best-ranked quota-eligible waiter, else None."""
        for i, w in enumerate(self._queue):
            if self._quota_block_locked(w.tenant, w.hbm) is None:
                return i
        return None

    def _grant_ledger_locked(self, tenant: str, hbm: int) -> None:
        self._in_use += 1
        if tenant:
            self._tenant_in_use[tenant] = (
                self._tenant_in_use.get(tenant, 0) + 1)
            if hbm:
                self._tenant_hbm[tenant] = (
                    self._tenant_hbm.get(tenant, 0) + hbm)

    def _promote_locked(self) -> None:
        """Hand free slots to quota-eligible waiters in rank order.
        Ineligible waiters are bypassed (their tenant must first
        release something of its own)."""
        while self._in_use < self.slots and self._queue:
            i = self._first_eligible_locked()
            if i is None:
                return
            w = self._queue.pop(i)
            w.granted = True
            self._vclock = max(self._vclock, w.rank[1])
            self._grant_ledger_locked(w.tenant, w.hbm)
            w.event.set()

    def acquire(self, priority: str = "normal", timeout: float = 30.0,
                tenant: str = "", hbm: int = 0) -> None:
        p = PRIORITIES.get(priority, 1)
        with self._mu:
            blocked = self._quota_block_locked(tenant, hbm)
            if (self._in_use < self.slots and blocked is None
                    and self._first_eligible_locked() is None):
                # Fast path: a free slot, tenant under quota, and no
                # eligible waiter ranked ahead of us (quota-blocked
                # waiters don't bar the door — they are waiting on
                # their own tenant, not on a slot).
                self._grant_ledger_locked(tenant, hbm)
                self.admitted += 1
                return
            if len(self._queue) >= self.max_queue:
                self.rejected += 1
                raise AdmissionRejected(
                    f"admission queue full ({self.max_queue} waiters)")
            if p >= PRIORITIES["low"] and self._should_shed_locked():
                self.rejected += 1
                self.shed += 1
                raise AdmissionRejected(
                    "admission load shed: queue depth "
                    f"{len(self._queue)}, recent wait "
                    f"{self._wait_ewma:.2f}s over threshold")
            if blocked == "slots":
                self.tenant_slot_waits += 1
            elif blocked == "hbm":
                self.tenant_hbm_waits += 1
            w = _Waiter((p, self._vft(tenant), next(self._seq)),
                        threading.Event(), t_enq=time.monotonic(),
                        tenant=tenant, hbm=hbm)
            import bisect
            bisect.insort(self._queue, w)
            self.queued += 1
        granted = w.event.wait(timeout)
        obs = None
        with self._mu:
            if granted or w.granted:
                # release() handed the slot to us (possibly between the
                # wait timing out and this lock): the slot is ours.
                self.admitted += 1
                obs = self.wait_observer
                wait = time.monotonic() - w.t_enq
                self._wait_ewma += _WAIT_ALPHA * (wait - self._wait_ewma)
            else:
                # Timed out while still queued: remove ourselves so a
                # later release() can never hand a slot to a waiter
                # that already gave up (a stale waiter absorbing a
                # grant would leak the slot).
                self._queue.remove(w)
                self.rejected += 1
                raise AdmissionRejected(
                    f"admission wait exceeded {timeout}s")
        if obs is not None:
            obs(wait)

    def _should_shed_locked(self) -> bool:
        if self.shed_queue_depth and len(self._queue) >= self.shed_queue_depth:
            return True
        if self.shed_wait_seconds and self._wait_ewma >= self.shed_wait_seconds:
            return True
        if self.shed_wait_seconds and self.movement_wait_p99 is not None:
            try:
                p99 = self.movement_wait_p99()
            except Exception:
                p99 = None  # a broken signal must not wedge admission
            if p99 is not None and p99 >= self.shed_wait_seconds:
                return True
        if self.shed_exec_queue_depth and self.exec_queue_depth is not None:
            try:
                d = self.exec_queue_depth()
            except Exception:
                d = None  # a broken signal must not wedge admission
            if d is not None and d >= self.shed_exec_queue_depth:
                return True
        return False

    def release(self, tenant: str = "", hbm: int = 0) -> None:
        with self._mu:
            self._in_use = max(0, self._in_use - 1)
            if tenant:
                n = self._tenant_in_use.get(tenant, 0) - 1
                if n > 0:
                    self._tenant_in_use[tenant] = n
                else:
                    self._tenant_in_use.pop(tenant, None)
                if hbm:
                    h = self._tenant_hbm.get(tenant, 0) - hbm
                    if h > 0:
                        self._tenant_hbm[tenant] = h
                    else:
                        self._tenant_hbm.pop(tenant, None)
            self._promote_locked()

    def depth(self) -> int:
        with self._mu:
            return len(self._queue)

    def tenant_usage(self) -> dict:
        """Snapshot of the per-tenant ledger: tenant -> (slots, hbm)."""
        with self._mu:
            return {t: (n, self._tenant_hbm.get(t, 0))
                    for t, n in self._tenant_in_use.items()}
