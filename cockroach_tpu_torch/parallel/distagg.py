"""Distributed query execution over the shard mesh (the counterpart of
cockroach_tpu/parallel/distagg.py).

The answer to DistSQL physical planning, as in the reference:

  reference DistSQL                       here
  -----------------                       ----
  PartitionSpans assigns key spans        table rows shard over the
  to nodes by leaseholder                 mesh's slots
  per-node TableReader + partial agg      the same compiled plan runs
  processors                              once per slot, a thread each
  final-stage merge at the gateway        psum/pmin/pmax at the shard
                                          axis's rendezvous, inside the
                                          plan (parallel/collective.py)
  lookup-join data movement               replicated build side

Eligibility (``analyze``): the plan's root chain is Limit?/Sort?/
Aggregate (ungrouped, dense, or hash strategy: shard-local hash groups
exchange to their hash owner, parallel/shuffle.py) over a probe spine
whose every HashJoin build side is scan-only (replicated). DISTINCT
aggregates run on one device. After the collectives every output is
replicated, so HAVING, Sort and Limit above the Aggregate run on every
shard and the caller takes shard 0's result.

Every execution on a mesh goes through that mesh's one dispatcher
thread (``queued_collective_call``), keyed by its slot key: two engines
over the same slots share one dispatcher, so two runs never share one
rendezvous domain at once. The dispatcher runs each execution to its
end (its shard threads joined) before it takes the next: one issuing
thread a domain, the reference's contract.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import queue
import threading
import time
from dataclasses import dataclass

from ..sql import plan as P
from . import collective
from . import mesh as meshmod


@dataclass
class DistDecision:
    ok: bool
    sharded: set  # aliases row-sharded over the mesh
    replicated: set  # aliases replicated (join build sides)
    reason: str = ""


def analyze(node: P.PlanNode) -> DistDecision:
    """Decide whether the plan can run sharded (see module doc)."""
    sharded: set = set()
    replicated: set = set()

    def scan_only(n) -> bool:
        if isinstance(n, P.Scan):
            replicated.add(n.alias)
            return True
        if isinstance(n, P.Filter):
            return scan_only(n.child)
        return False

    def probe_chain(n) -> bool:
        """The probe spine: Scan/Filter/Project/HashJoin(with scan-only
        build)."""
        if isinstance(n, P.Scan):
            sharded.add(n.alias)
            return True
        if isinstance(n, (P.Filter, P.Project)):
            return probe_chain(n.child)
        if isinstance(n, P.HashJoin):
            if n.join_type not in ("inner", "left", "semi", "anti"):
                return False
            return probe_chain(n.left) and scan_only(n.right)
        return False

    n = node
    if isinstance(n, P.Limit):
        n = n.child
    if isinstance(n, P.Sort):
        n = n.child
    if not isinstance(n, P.Aggregate):
        return DistDecision(False, set(), set(), "root is not an aggregate")
    for a in n.aggs:
        if a.distinct:
            return DistDecision(False, set(), set(), "DISTINCT aggregate")
    if not probe_chain(n.child):
        return DistDecision(False, set(), set(), "unsupported probe chain")
    return DistDecision(True, sharded, replicated)


def partials_replannable(node: P.PlanNode) -> bool:
    """May this statement's partial aggregates be recomputed under a
    different row assignment and still merge to the same answer? Yes
    for sum/count/min/max partials; DISTINCT aggregates (their partials
    are sets) are the exception. Non-aggregate reads carry no partial
    state."""
    n = node
    if isinstance(n, P.Limit):
        n = n.child
    if isinstance(n, P.Sort):
        n = n.child
    if not isinstance(n, P.Aggregate):
        return True
    return not any(a.distinct for a in n.aggs)


class CollectiveFault(RuntimeError):
    """An injected fault lost a collective dispatch. Raised from
    queued_collective_call when a fault rule drops the call; the session
    re-runs the statement locally (Prepared.run, distsql = off)."""


_SHUTDOWN = object()


def _fail_future(fut, msg: str) -> None:
    try:
        fut.set_exception(CollectiveFault(msg))
    except concurrent.futures.InvalidStateError:
        pass  # already done or cancelled


class _MeshDispatcher:
    """Single-thread FIFO executor for one slot set.

    Sessions enqueue distributed executions and block on futures; the
    one dispatcher thread runs them in order. A loop-level failure fails
    the in-flight and queued futures with CollectiveFault and marks the
    dispatcher dead; the next submit() respawns the thread. shutdown()
    retires the thread (engine close, test teardown); a later submit
    respawns it too."""

    def __init__(self, name: str):
        self._name = name
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._dead = False
        self._kill_next = False  # fault hook (inject_death)
        self.respawns = 0
        self._thread: threading.Thread | None = None
        self._spawn_locked()

    def _spawn_locked(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name=f"mesh-dispatch-{self._name}",
            daemon=True)
        self._thread.start()

    def depth(self) -> int:
        return self._q.qsize()

    def inject_death(self) -> None:
        """Fault hook (tests): the thread dies on its next dequeue,
        outside the per-item protection: a dispatch-loop bug's shape."""
        self._kill_next = True

    def shutdown(self, timeout: float = 2.0) -> None:
        with self._lock:
            t = self._thread
            if t is None or not t.is_alive():
                # nothing to retire: a queued entry would outlive the
                # thread and read as a busy mesh (depth)
                return
            self._q.put(_SHUTDOWN)
        t.join(timeout)

    def _fail_pending_locked(self) -> None:
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not _SHUTDOWN:
                _fail_future(item[3], "mesh dispatcher thread died")

    def submit(self, fn, args, kwargs, on_start=None):
        from ..exec import coldstart
        fut: concurrent.futures.Future = concurrent.futures.Future()
        # carry the submitting statement's compile-attribution cell:
        # kernel libraries load on the shard threads, but the bill
        # belongs to the statement that enqueued the call
        item = (fn, args, kwargs, fut, time.monotonic(), on_start,
                coldstart.attribution_cell())
        with self._lock:
            if self._dead or self._thread is None \
                    or not self._thread.is_alive():
                self._fail_pending_locked()
                self._dead = False
                self.respawns += 1
                self._spawn_locked()
            self._q.put(item)
        return fut

    def _loop(self) -> None:
        from ..exec import coldstart
        fut = None
        try:
            while True:
                item = self._q.get()
                if item is _SHUTDOWN:
                    with self._lock:
                        self._dead = True
                        self._fail_pending_locked()
                    return
                fn, args, kwargs, fut, t_enq, on_start, cell = item
                if self._kill_next:
                    self._kill_next = False
                    raise RuntimeError("injected dispatcher death")
                if on_start is not None:
                    on_start(time.monotonic() - t_enq)
                if not fut.set_running_or_notify_cancel():
                    continue
                prev = coldstart.set_attribution_cell(cell)
                try:
                    fut.set_result(fn(*args, **kwargs))
                except Exception as e:  # noqa: BLE001 - to the caller
                    fut.set_exception(e)
                finally:
                    coldstart.set_attribution_cell(prev)
        except BaseException:
            # a loop-level failure: fail the in-flight future and every
            # queued one (no session may hang), and mark dead so the
            # next submit() respawns
            if fut is not None:
                _fail_future(fut, "mesh dispatcher thread died")
            with self._lock:
                self._dead = True
                self._fail_pending_locked()
            raise


_DISPATCHERS: dict = {}
_DISPATCHERS_LOCK = threading.Lock()


def _dispatcher_key(mesh) -> tuple:
    return ("process",) if mesh is None else mesh.key()


def _dispatcher_for(mesh) -> _MeshDispatcher:
    key = _dispatcher_key(mesh)
    with _DISPATCHERS_LOCK:
        d = _DISPATCHERS.get(key)
        if d is None:
            d = _MeshDispatcher("-".join(str(k) for k in key))
            _DISPATCHERS[key] = d
        return d


def shutdown_dispatchers(mesh=None) -> None:
    """Retire dispatcher threads (engine close, test teardown): with a
    mesh, only its slot set's; else every one. The dispatcher objects
    stay registered (slot set -> dispatcher must stay one to one), and
    a later submit respawns a retired thread."""
    with _DISPATCHERS_LOCK:
        if mesh is None:
            items = list(_DISPATCHERS.values())
        else:
            d = _DISPATCHERS.get(_dispatcher_key(mesh))
            items = [d] if d is not None else []
    for d in items:
        d.shutdown()


# (FaultInjector-like object with plan(frm, to), frm, to) aimed at the
# dispatch path, or None (the default: no fault evaluation)
_ICI_FAULTS = None


def install_ici_faults(injector, frm="ici", to="ici") -> None:
    """Point the collective dispatch path at a fault injector (tests,
    chaos drills): every queued_collective_call consults
    ``injector.plan(frm, to)`` before dispatching. [] drops the call
    (CollectiveFault), [s] delays it s seconds, [0.0, 0.0] dispatches
    twice and keeps the last result (the collectives are reductions
    over read-only inputs, so a duplicate is idempotent). None heals."""
    global _ICI_FAULTS
    _ICI_FAULTS = (injector, frm, to) if injector is not None else None


# the longest a session waits for its dispatch to complete: a run's
# own budget (collective.COLLECTIVE_TIMEOUT_S) plus a margin for the
# executions queued ahead of it
DISPATCH_WAIT_S = 1800.0


def queued_collective_call(fn, metrics=None, mesh=None, movement=None,
                           lease_bytes: int = 0):
    """Wrap a distributed callable so that every execution on ``mesh``
    goes through its dispatcher. With a MetricRegistry each call counts
    as one collective dispatch (exec.allreduce.calls, its wall time in
    exec.allreduce.seconds), and the queue depth and enqueue-to-dispatch
    wait surface as exec.queue.*. With a movement scheduler and
    ``lease_bytes``, each call holds an exchange lease for its working
    buffers (exec/movement.py)."""
    m_calls = m_secs = m_depth = m_wait = None
    if metrics is not None:
        m_calls = metrics.counter(
            "exec.allreduce.calls",
            "distributed (collective) plan dispatches")
        m_secs = metrics.histogram(
            "exec.allreduce.seconds",
            "wall seconds per collective dispatch (incl. queue wait)")
        m_depth = metrics.gauge(
            "exec.queue.depth",
            "per-mesh collective dispatch-queue depth at enqueue")
        m_wait = metrics.histogram(
            "exec.queue.wait_seconds",
            "enqueue-to-dispatch wait per collective call")
    disp = _dispatcher_for(mesh)

    def on_start(wait: float) -> None:
        if m_wait is not None:
            m_wait.observe(wait)

    @functools.wraps(fn)
    def call(*args, **kwargs):
        if movement is not None and lease_bytes > 0:
            with movement.exchange_lease(lease_bytes):
                return _call_inner(*args, **kwargs)
        return _call_inner(*args, **kwargs)

    def _call_inner(*args, **kwargs):
        t0 = time.monotonic()
        try:
            faults = _ICI_FAULTS
            deliveries = [0.0]
            if faults is not None:
                inj, frm, to = faults
                deliveries = inj.plan(frm, to)
                if not deliveries:
                    raise CollectiveFault(
                        "fault injection dropped a collective dispatch")
            # the exchange's per-link rules (parallel/shuffle.py),
            # aggregated at dispatch
            from .shuffle import link_fault_plan
            lp = link_fault_plan()
            if lp is not None:
                if not lp:
                    raise CollectiveFault(
                        "fault injection dropped a shuffle link")
                merged = max(len(deliveries), len(lp))
                dly = max(deliveries[0], lp[0])
                deliveries = [dly] + [0.0] * (merged - 1)
            out = None
            for d in deliveries:
                if d:
                    time.sleep(d)
                if m_depth is not None:
                    m_depth.set(disp.depth() + 1)
                # domain-family gate (parallel/mesh.py): a full-mesh and
                # a sub-mesh execution share slots, so their windows
                # must not overlap
                win = meshmod.execution_window(mesh)
                with (win if win is not None else contextlib.nullcontext()):
                    fut = disp.submit(fn, args, kwargs, on_start)
                    out = fut.result(timeout=DISPATCH_WAIT_S)
            return out
        finally:
            if m_calls is not None:
                m_calls.inc()
                m_secs.observe(time.monotonic() - t0)
    return call


class MeshBatch:
    """One scan's device batches on a mesh: ``shards[i]`` is slot i's
    ColumnBatch (a row slice of the padded table when ``placement`` is
    "sharded", the whole table when "replicated")."""

    def __init__(self, shards: tuple, placement: str):
        self.shards = tuple(shards)
        self.placement = placement

    @property
    def n(self) -> int:
        """Rows of the table as the plan sees it: every slot's slice
        together when sharded, one copy when replicated."""
        if self.placement == meshmod.shard_spec():
            return sum(b.n for b in self.shards)
        return self.shards[0].n


def make_distributed_fn(runf, mesh, scan_aliases: dict,
                        timeout: float | None = None):
    """Run a compiled plan once per slot of ``mesh`` (the reference wraps
    it in shard_map).

    runf: RunContext -> ColumnBatch, compiled with the shard axis set.
    scan_aliases: alias -> table (the RunContext's scans keys).
    Returns fn(RunContext) -> shard 0's ColumnBatch (the outputs are
    replicated), where the RunContext's scans map each alias to its
    MeshBatch; shard i runs on a RunContext of the same read timestamp,
    partition and parameters over the batches of slot i, and shard 0's
    records into the caller's route."""
    from ..exec import coldstart
    from ..exec.compile import RunContext

    def wrapped(rc):
        missing = set(scan_aliases) - set(rc.scans)
        if missing:
            raise collective.CollectiveError(
                f"no mesh batch for scans {sorted(missing)}")
        cell = coldstart.attribution_cell()

        @contextlib.contextmanager
        def carry():
            # the issuing statement's compile bill (kernel libraries
            # load on the shard threads)
            prev = coldstart.set_attribution_cell(cell)
            try:
                yield
            finally:
                coldstart.set_attribution_cell(prev)

        def shard(i):
            return runf(RunContext(
                {a: b.shards[i] for a, b in rc.scans.items()}, rc.read_ts,
                rc.nparts, rc.pid, route=rc.route if i == 0 else None,
                params=rc.params))
        return collective.run_sharded(mesh.devices, shard, timeout,
                                      carry=carry)[0]
    return wrapped
