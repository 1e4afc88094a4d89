"""Cross-session batch windows for the OLTP fast lane.

The port of cockroach_tpu/exec/oltpbatch.py. The lane
(exec/oltplane.py) compiles a point statement down to one native call;
what remains at high concurrency is per-statement dispatch: every
session takes the statement gate, reads the clock, bumps the timestamp
cache and, for a write, runs its own kv commit. Concurrent eligible
statements queue into a *window*; one thread (the leader) drains the
queue and runs the whole window fused (one multi-key mirror probe for
the reads, one group-committed kv transaction per write round), and
every waiter gets its own Result or statement error.

Batching is opportunistic, not timed: an uncontended request becomes
leader at once and runs solo; windows grow only when sessions pile up
behind a running window. Reads and writes collect into separate
windows, so a group commit never blocks readers behind it. The session
variable ``oltp_batch = off`` bypasses this module and is exactly the
per-statement path.

Counters (utils/metric.py): ``exec.oltp.batch.windows`` (a solo
statement is a window of one), ``exec.oltp.batch.fused`` (statements
that shared a window), ``exec.oltp.batch.size_p50`` (median window
size over the last 512) and ``exec.oltp.batch.flush_wait_seconds``
(per request, queue to outcome).
"""

from __future__ import annotations

import threading
import time
from collections import deque


class BatchReq:
    """One session's statement riding in a batch window."""

    __slots__ = ("plan", "lits", "session", "result", "error")

    def __init__(self, plan, lits, session):
        self.plan = plan
        self.lits = lits
        self.session = session
        self.result = None
        self.error = None

    @property
    def done(self) -> bool:
        return self.result is not None or self.error is not None


class _Collector:
    """One batch-window queue (reads or writes): its own condition
    variable, queue and leader slot, so the two kinds never wait on each
    other's windows."""

    def __init__(self, batcher, run_fn):
        self.batcher = batcher
        self.run_fn = run_fn
        # queue append, leader election and waiter wakeup all happen
        # under this one condition variable
        self.window_cv = threading.Condition()
        self.queue: list = []
        self.busy = False

    def submit(self, req) -> None:
        leader = False
        batch = None
        with self.window_cv:
            self.queue.append(req)
            while not req.done:
                if not self.busy:
                    # become the window leader: claim everything queued
                    # so far, our own request included
                    self.busy = True
                    batch, self.queue = self.queue, []
                    leader = True
                    break
                self.window_cv.wait(timeout=1.0)
        if leader:
            try:
                self.batcher._run_window(batch, self.run_fn)
            finally:
                with self.window_cv:
                    self.busy = False
                    self.window_cv.notify_all()


class LaneBatcher:
    """Batch-window collector in front of the lane executors."""

    def __init__(self, engine, metrics):
        self._reads = _Collector(self, engine._lane_read_batch)
        self._writes = _Collector(self, engine._lane_write_batch)
        # window stats, shared by both collectors, changed only under
        # this condition variable
        self.stats_cv = threading.Condition()
        self.windows = 0
        self.fused = 0
        self._sizes: deque = deque(maxlen=512)
        self._m_windows = metrics.counter(
            "exec.oltp.batch.windows",
            "OLTP batch windows executed (a solo statement is a window "
            "of one)")
        self._m_fused = metrics.counter(
            "exec.oltp.batch.fused",
            "statements that shared a multi-statement batch window")
        metrics.func_gauge(
            "exec.oltp.batch.size_p50", self.size_p50,
            "median batch-window size over the last 512 windows")
        self._m_wait = metrics.histogram(
            "exec.oltp.batch.flush_wait_seconds",
            "per-request wall time inside the batch window, queue to "
            "outcome (s)")

    def size_p50(self) -> float:
        with self.stats_cv:
            sizes = sorted(self._sizes)
        return float(sizes[len(sizes) // 2]) if sizes else 0.0

    def submit(self, plan, lits, session):
        """Execute one eligible statement through a batch window.
        Blocks until this request has an outcome; returns its Result or
        raises its per-statement error."""
        req = BatchReq(plan, lits, session)
        t0 = time.perf_counter()
        (self._reads if plan.kind == "point" else self._writes).submit(req)
        self._m_wait.observe(time.perf_counter() - t0)
        if req.error is not None:
            raise req.error
        return req.result

    # -- leader side --------------------------------------------------------
    def _run_window(self, batch, fn) -> None:
        self._run_phase(batch, fn)
        with self.stats_cv:
            self.windows += 1
            if len(batch) > 1:
                self.fused += len(batch)
            self._sizes.append(len(batch))
        self._m_windows.inc()
        if len(batch) > 1:
            self._m_fused.inc(len(batch))

    @staticmethod
    def _run_phase(reqs, fn) -> None:
        """Run one window; every request leaves with exactly one
        outcome even if the executor dies mid-window (a waiter must
        never hang or see two outcomes)."""
        if not reqs:
            return
        try:
            fn(reqs)
        except BaseException as e:
            for r in reqs:
                if not r.done:
                    r.error = e
            if not isinstance(e, Exception):
                raise
        for r in reqs:
            if not r.done:
                r.error = RuntimeError("batch window dropped a request")
