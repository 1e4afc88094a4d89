"""The query engine: statement dispatch, device upload, result decode.

The counterpart of cockroach_tpu/exec/engine.py, slimmed to what the
ported TPC-H and SSB queries need: ``Engine.execute`` runs CREATE TABLE,
ANALYZE, SET and SELECTs. A SELECT is decorrelated (correlated EXISTS
and scalar subqueries become grouped LEFT JOINs, sql/decorrelate.py);
its CTEs and derived tables are materialized into temp tables from
their compiled plans' output columns; then it is prepared and run. A
preparation goes bind/plan (sql/, host; uncorrelated subqueries run
first and are inlined as constants) -> join build checks (unique keys,
direct addressing, the expansion factor of duplicate keys) -> selection
compaction -> compile_plan (exec/compile.py), cached per statement
shape -> a ``Prepared`` over device-resident tables (exec/session.py).
Its run is one eager pass and a host decode, where the result's error
sentinels are checked: a top-k cut that crossed a tie replans with the
full sort, an overflowed compaction block replans uncompacted, a hash
GROUP BY past its table re-runs partition by partition. Statements that
differ only in filter literals share one compiled plan: the literals
ride each run as parameters (exec/planparam.py). Tables upload once
per (table, generation), padded to a rung of the shape ladder
(exec/coldstart.py: powers of two from 1,024 rows by default) with
never-visible padding rows, reserved against the device
budget ``sql.exec.hbm_budget_bytes`` (``Engine.settings``), and are
reused across statements.

Beyond the budget the reference's placement rules decide the route
(exec/scanplane.py): an aggregate-rooted plan streams its fact table
page by page (exec/stream.py, exec/compile.py compile_streaming), an
over-budget join build spills into a partitioned external hash join
and an over-budget sort into an external merge sort (exec/spill.py).

Writes go through the transactional KV plane (kv/, exec/dml.py):
INSERT, UPSERT, UPDATE and DELETE, in auto-commit or BEGIN ... COMMIT /
ROLLBACK, under NOT NULL, CHECK, FOREIGN KEY and primary-key
constraints (exec/constraints.py, with the descriptors of catalog/).
Committed effects reach the columnstore at the commit timestamp; a
SELECT inside an open transaction with writes reads an uploaded overlay
of its own writes, never cached. Point and range reads on the primary
key take host fast paths (exec/fastpath.py).

Sessions may run on their own threads: ``execute`` tries the OLTP lane
first (exec/oltplane.py, exec/oltpbatch.py: single-row statements on
an all-integer single-pk table, served by a native row mirror and
batch windows), then takes the statement gate (utils/rwlock.py): plain
single-SELECTs outside a txn share it, everything else is exclusive.
The per-statement state (``last_exec``, the statement and nesting
depth, the generation sinks) is per thread; the exec cache, the device
tables and their reservations are locked one by one.

Views re-plan as derived tables at every use; sequences allocate in KV
transactions of their own (``nextval`` never rolls back). Set operations
run their branches as statements and merge on the host; a prepared CTE
or derived-table statement composes its temps and main plan on the card
from its second run (exec/ctecompose.py). SHOW, EXPLAIN [ANALYZE],
session tracing, statement diagnostics and the profile planes are
exec/explain.py's and exec/profile.py's.

Schema changes run online (exec/ddl.py, exec/maintenance.py): CREATE
INDEX and ALTER TABLE publish descriptor versions through leases and
backfill as durable jobs. AS OF SYSTEM TIME sets a SELECT's read
timestamp, a runtime argument of its compiled plan (the upload carries
every version), below a table's GC threshold refused.

BACKUP and RESTORE (with incremental layers), CREATE CHANGEFEED, row
TTL and IMPORT run as jobs of the same registry (jobs/, cdc/,
exec/maintenance.py); a table with a live changefeed stays off the OLTP
lane.

On an engine with a mesh (``Engine(mesh=make_mesh(...))``; ``Engine()``
builds one over every card when there are several) an eligible plan
runs distributed (parallel/distagg.py): its probe-spine tables upload
sharded over the mesh's slots and its build sides replicated, the
compiled plan runs once per slot, and its aggregate partials merge with
the shard axis's collectives. Each dispatch goes to the full mesh or to
a pool sub-mesh (``_DistRouter``, sql.exec.submesh.size); a statement
whose collective dispatch faults re-runs on one device.

On a cluster-backed engine (``Engine(cluster=c)``, a kvserver.Cluster)
DML, the catalog, sequences and jobs ride raft-replicated,
leaseholder-served ranges (kv/rangekv.py), and the columnstore is a
materialization of the committed range data: before each statement,
every table it names is rebuilt from the ranges when its replicated
generation token moved (exec/dml.py ``_sync_scan_plane``). Scans, and
the kernels, still run on the engine's device; the OLTP lane declines.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import datetime
import decimal
import json
import re
import threading
import time
import weakref
from collections import Counter, deque

import numpy as np
import torch

from .. import resolve_device
from ..catalog import Catalog, LeaseManager
from ..kv.txn import DB as KVDB
from ..kv.txn import KVStore, Txn
from ..kv.concurrency import TxnAbortedError, TxnRetryError
from ..ops import hashtable
from ..ops.batch import ColumnBatch, pull_arrays, pull_batch_columns
from ..ops.join import MAX_EXPAND
from ..parallel import distagg
from ..parallel import mesh as meshmod
from ..parallel import multihost
from ..parallel.collective import AXIS
from ..sql import ast, parser
from ..sql.parser import ParseError
from ..sql import plan as P
from ..sql.binder import BindError, Binder, Scope, parse_timestamp
from ..sql.bound import BCol, BConst
from ..sql.decorrelate import decorrelate_exists, decorrelate_scalar
from ..sql.planner import CatalogView, PlanError, Planner
from ..sql.types import (INT8, ColumnSchema, Family, TableSchema,
                         common_numeric_type)
from ..storage.columnstore import ColumnStore
from ..storage.hlc import Clock, Timestamp
from ..storage.keys import prefix_end
from ..ops.cuda import autotune, paritygate
from ..utils.admission import AdmissionController
from ..utils.devstats import DeviceStats
from ..utils.rwlock import RWLock
from ..utils.metric import MetricRegistry
from ..utils.mon import BytesMonitor, MemoryQuotaError
from ..utils import log, tracing
from ..utils.settings import SettingError, Settings
from ..utils.sqlstats import StatsRegistry
from ..utils.stmtdiag import StmtDiagRegistry
from . import coldstart, profile
from .compile import (ExecError, ExecParams, RunContext, compile_plan,
                      compile_streaming)
from .constraints import ConstraintMixin
from .ddl import DDLMixin
from .dml import DMLMixin
from .explain import ExplainMixin, StatementObserver
from .expr import ExprContext, compile_expr
from .fastpath import FastpathMixin
from .joinfilter import find_specs
from .maintenance import MaintenanceMixin
from .movement import TransferScheduler
from .oltplane import OltpLaneMixin
from .planparam import (parameterize, plan_fingerprint, run_values,
                        shape_text)
from .scanplane import ScanPlaneMixin, scan_maps
from .session import (SENTINEL_COLUMNS, CompactOverflow, EngineError,
                      HashCapacityExceeded, Prepared, Result, Session,
                      TopKInexact)
from .spill import compile_spill_sort
from .stream import extract_zone_preds
from .stmtutil import (RerunPrepared, decode_scalar, host_sort,
                       propagate_as_of, rewrite_table_names, sort_rows)
from .tenantcache import TenantLRU

EPOCH_DATE = datetime.date(1970, 1, 1)
EPOCH_DT = datetime.datetime(1970, 1, 1)

# the names of CTE and derived-table temps start with this
TEMP_PREFIX = "__cte_"


class _RowPath(EngineError):
    """A CTE or derived-table body the columnar path cannot serve: it is
    materialized through decoded rows instead."""

# padding rows are never visible: created at +inf, deleted at 0
_PAD_TS = 2 ** 62
# ANALYZE output goes stale past this row-count drift (the reference's
# sql.stats.stale_row_fraction default)
_STALE_ROW_FRACTION = 0.2

# exception per sentinel column (session.SENTINEL_COLUMNS), checked in
# that order
_SENTINEL_EXCS = {
    "__ht_overflow": lambda: HashCapacityExceeded(
        "GROUP BY cardinality exceeded hash_group_capacity; "
        "SET hash_group_capacity to a larger power of two"),
    "__sum_overflow": lambda: EngineError(
        "decimal SUM overflowed int64 accumulation; "
        "CAST the argument to FLOAT to trade exactness for range"),
    "__topk_inexact": lambda: TopKInexact(
        "top-k cut crossed a primary-key tie group; "
        "replanning with the full sort"),
    "__compact_overflow": lambda: CompactOverflow(
        "selection compaction overflowed a block's capacity; "
        "replanning uncompacted"),
}
_MODES = ("auto", "on", "off")
# the values each enumerated session variable takes
_VAR_VALUES = {"pallas_groupagg": _MODES, "sort_normalized": _MODES,
               "streaming": ("auto", "off"),
               "streaming_pipeline": ("on", "off"),
               "spill": _MODES, "oltp_batch": ("auto", "off"),
               "distsql": ("auto", "on", "off", "always")}


def _per_thread(name: str, fresh):
    """A property whose value is per thread (``fresh()`` on a thread's
    first read): the per-statement state shared readers would race on."""

    def get(self):
        tl = self._tl
        if not hasattr(tl, name):
            setattr(tl, name, fresh())
        return getattr(tl, name)

    def set_(self, v):
        setattr(self._tl, name, v)
    return property(get, set_)


class _DistRouter:
    """Per-dispatch routing of one prepared distributed plan onto the
    full mesh or a pool sub-mesh (parallel/mesh.py MeshPool): the
    reference's _DistRouter.

    It stands in the exec cache for the compiled plan and is called as
    one, with a RunContext whose scans are the full mesh's MeshBatches.
    It builds one compiled plan per shard count and one queued call per
    target mesh, lazily; a psum over fewer shards is exact, so rows
    agree across targets (floats within their tolerance).

    Routing (sql.exec.submesh.size): ``off`` = always the full mesh; a
    power of two = that sub-mesh size when the working set fits,
    escalating to larger sizes and the full mesh when it does not;
    ``auto`` = the full mesh while the front door is idle, the smallest
    fitting sub-mesh once dispatches queue, so small queries run side
    by side on disjoint rendezvous domains."""

    # share of a slot's slice of the device budget a routed plan may
    # occupy
    FOOTPRINT_FRAC = 0.5

    def __init__(self, engine, node, meta, scan_aliases, exec_params,
                 upload_spec, sharded_bytes, repl_bytes):
        self.engine = engine
        self.node = node
        self.meta = meta
        self.scan_aliases = scan_aliases
        self.exec_params = exec_params
        # [(alias, table, placement, cols)]: how each scan resolves a
        # mesh batch against any target mesh
        self.upload_spec = upload_spec
        self.sharded_bytes = sharded_bytes
        self.repl_bytes = repl_bytes
        self._lock = threading.Lock()
        self._runfs: dict = {}   # n_shards -> compiled plan
        self._calls: dict = {}   # "full" | (size, idx) -> queued call

    def _runf_for(self, n_shards: int):
        f = self._runfs.get(n_shards)
        if f is None:
            p = dataclasses.replace(self.exec_params, n_shards=n_shards)
            f = self._runfs[n_shards] = compile_plan(self.node, p,
                                                     self.meta)
        return f

    def _call_for(self, key, mesh, n_shards: int):
        with self._lock:
            c = self._calls.get(key)
            if c is None:
                eng = self.engine
                c = self._calls[key] = distagg.queued_collective_call(
                    distagg.make_distributed_fn(
                        self._runf_for(n_shards), mesh, self.scan_aliases),
                    metrics=eng.metrics, mesh=mesh, movement=eng.movement,
                    # exchanged rows are bounded by one shard's
                    # post-filter slice plus the replicated builds
                    lease_bytes=(self.sharded_bytes // max(n_shards, 1)
                                 + self.repl_bytes))
            return c

    def _target_size(self):
        """Sub-mesh size for this dispatch, or None for the full mesh."""
        eng = self.engine
        mode = str(eng.settings.get("sql.exec.submesh.size"))
        if mode == "off":
            return None
        pool = eng._submesh_pool()
        if pool is None:
            return None
        full = eng.mesh.size
        sizes = sorted(pool.sizes())  # ascending; full mesh excluded
        if mode == "auto":
            busy = (distagg._dispatcher_for(eng.mesh).depth() > 0
                    or pool.occupancy() > 0)
            if not busy:
                return None
        else:
            want = int(mode)
            if want >= full:
                return None
            sizes = [s for s in sizes if s >= want]
        per_slot_budget = eng.hbm.limit / max(full, 1)
        for s in sizes:
            if per_slot_budget <= 0 or (
                    self.sharded_bytes / s + self.repl_bytes
                    <= self.FOOTPRINT_FRAC * per_slot_budget):
                return s
        return None  # the working set needs the full mesh

    def __call__(self, rc: RunContext):
        size = self._target_size()
        eng = self.engine
        if size is None:
            return self._call_for("full", eng.mesh, eng.mesh.size)(rc)
        pool = eng._submesh_pool()
        submesh, token = pool.acquire(size)
        try:
            call = self._call_for(token, submesh, size)
            sub = {alias: eng._device_table(tname, cols, placement,
                                            submesh)
                   for alias, tname, placement, cols in self.upload_spec}
            return call(RunContext(sub, rc.read_ts, rc.nparts, rc.pid,
                                   route=rc.route, params=rc.params))
        finally:
            pool.release(token)


class Engine(OltpLaneMixin, DMLMixin, ConstraintMixin, DDLMixin,
             MaintenanceMixin, FastpathMixin, ScanPlaneMixin, ExplainMixin):
    # the per-statement state, per thread: the last statement's route
    # (_fresh_route: its main query's Compact nodes, replans
    # ("no_topk", "no_compact", in order) and last run's
    # RunContext.route; the subqueries it evaluated, the temps it
    # materialized ([name, rows, "columnar" or "rows"]) and the
    # partition counts of its partitioned re-runs; under "all" the
    # totals over every plan run the statement made), whether a
    # statement is open, the depth of subquery / temp-body runs, the
    # open preparations' generation sets (tables that subqueries read
    # while a plan binds them join every open set), the CTE depth per
    # session and the waits of the open statement's scope (_run_scope)
    last_exec = _per_thread("last_exec", lambda: _fresh_route())
    _in_statement = _per_thread("in_statement", lambda: False)
    _nested = _per_thread("nested", lambda: 0)
    _gen_sinks = _per_thread("gen_sinks", list)
    _cte_depth = _per_thread("cte_depth", dict)
    _scope_waits = _per_thread("scope_waits", dict)
    # observability, per thread: the last statement's coarse profile
    # (exec/profile.py), the plan node of its main query (EXPLAIN
    # ANALYZE and diagnostics render it), whether the running statement
    # is analyzed (its plan takes no selection compaction) and the
    # capture of a composing CTE handle's slow run (exec/ctecompose.py)
    last_profile = _per_thread("last_profile", lambda: None)
    _last_plan = _per_thread("last_plan", lambda: None)
    _analyzing = _per_thread("analyzing", lambda: False)
    _cte_capture = _per_thread("cte_capture", lambda: None)

    def __init__(self, device=None, store: ColumnStore | None = None,
                 mesh: meshmod.Mesh | None = None, cluster=None):
        # the shard mesh of distributed plans: over every card when the
        # engine is on a card and there are several (the reference's
        # rule); a mesh of several slots on one device only when the
        # caller passes it. The engine's device is the mesh's slot 0:
        # uploads start there
        if mesh is not None and device is None:
            device = mesh.devices[0]
        self.device = resolve_device(device)
        if mesh is None and self.device.type == "cuda" \
                and torch.cuda.device_count() > 1:
            mesh = meshmod.make_mesh()
        if mesh is not None and str(mesh.devices[0]) != str(self.device):
            raise EngineError(f"the engine's device {self.device} must be "
                              f"its mesh's slot 0 ({mesh.devices[0]})")
        self.mesh = mesh
        # the sub-mesh dispatch pool (parallel/mesh.py MeshPool), built
        # at the first routed dispatch; None on a mesh too small to split
        self._mesh_pool = None
        self._mesh_pool_lock = threading.Lock()
        self.store = store or ColumnStore()
        # the transactional row plane: DML writes intents here through
        # kv.Txn and publishes committed effects into the columnstore
        # scan plane. With a Cluster (kvserver/cluster.py) attached, that
        # plane IS the raft-replicated range plane (kv/rangekv.py):
        # intents, the catalog, sequences and jobs replicate and survive
        # node failure, on the cluster's clock; without one, a
        # single-store KV serves the same interface on the scans' clock,
        # so commit timestamps land above bulk-ingested rows' mvcc_ts
        self.cluster = cluster
        if cluster is not None:
            from ..kv.rangekv import ClusterKVStore
            self.clock = cluster.clock
            self.kv = KVDB(ClusterKVStore(cluster))
        else:
            self.clock = Clock()
            self.kv = KVDB(KVStore(clock=self.clock))
        # cluster mode: the generation token each table's local
        # materialization was built from (exec/dml.py _sync_scan_plane)
        self._scan_gens: dict[str, bytes | None] = {}
        self.catalog = Catalog(self.kv,
                               id_floor=lambda: self.store._next_table_id)
        # descriptor leases (catalog/lease.py): schema changes publish
        # through them and wait for older versions to drain
        self.leases = LeaseManager(self.catalog, holder=f"sql-{id(self)}",
                                   now_ns=lambda: self.clock.now().wall)
        # per-table index descriptors from the catalog (exec/ddl.py
        # _table_indexes); the job registry and the protected-timestamp
        # records, built at first use (exec/maintenance.py)
        self._index_defs: dict[str, list] = {}
        self._jobs = None
        self._pts = None
        # changefeed event taps (cdc/changefeed.py TableFeed), and each
        # changefeed job's thread: job id -> (thread, table)
        self.cdc_feeds: list = []
        self._cdc_threads: dict[int, tuple] = {}
        # sessions this engine handed out (non-transactional DDL checks
        # their open txns' effects)
        self._open_sessions: weakref.WeakSet = weakref.WeakSet()
        # per-table (checks, fks) from the catalog, the FK children map
        # (None = rebuild) and compiled CHECK predicates
        self._constraint_defs: dict[str, tuple] = {}
        self._fk_children: dict | None = None
        self._check_fn_cache: dict = {}
        self.settings = Settings()
        self.metrics = MetricRegistry()
        # the executing statement's tenant, published per thread between
        # admission's acquire and release: ``value`` is admission's key,
        # ``app`` the rollup's (application_name or "(unset)")
        self._tenant_tl = threading.local()
        # the device-byte pool: resident uploads reserve against it,
        # streamed and spill windows lease from it; each reservation
        # belongs to the tenant whose statement made it
        self.hbm = BytesMonitor(
            "hbm", lambda: self.settings.get("sql.exec.hbm_budget_bytes"),
            owner=lambda: getattr(self._tenant_tl, "app", ""))
        self.movement = TransferScheduler(self.hbm, self.metrics)
        self.devstats = DeviceStats(self.device, self.hbm)
        self._tl = threading.local()
        # the statement gate: plain read-only SELECTs share it, every
        # other statement takes it exclusively (`with _stmt_lock:` is
        # the write side)
        self._stmt_lock = RWLock()
        self.devstats.register(
            self.metrics, lambda: self._stmt_lock._waiting_writers)
        # (table, generation) -> (uploaded column set, ColumnBatch);
        # each entry holds a reservation under the same key. Uploads and
        # evictions hold _device_lock, so two shared readers never
        # upload one table twice
        self._device_tables: dict[tuple, tuple] = {}
        # (table, generation, placement, mesh key) -> (the resident copy
        # it was cut from, MeshBatch, reservation account or None): a
        # table's slices or copies on a mesh (_device_table)
        self._mesh_tables: dict[tuple, tuple] = {}
        self._device_lock = threading.RLock()
        # compiled plans: exec-cache key -> (compiled plan, meta), and
        # the lookups by outcome (the reference's sql.plan.cache.*),
        # both under _cache_lock (a hit's move-to-end is a mutation)
        self._exec_cache = TenantLRU(self.EXEC_CACHE_MAX)
        self.plan_cache = {"hit": 0, "miss": 0}
        self._cache_lock = threading.Lock()
        # statement text -> parsed AST, under the same lock; both caches
        # tag their entries with the executing statement's tenant
        # (exec/tenantcache.py: sql.exec.plan_cache.tenant_budget bounds
        # a tenant to evicting its own entries)
        self._parse_cache = TenantLRU(self.PARSE_CACHE_MAX)
        # per-fingerprint statement statistics (SHOW STATEMENTS, the
        # node's /_status/statements) and per-tenant rollups
        self.sqlstats = StatsRegistry()
        # observability: span tracing (utils/tracing.py), the ring of
        # slow statements' recordings behind /debug/tracez (past
        # sql.trace.slow_statement.threshold) and statement diagnostics
        # (utils/stmtdiag.py: armed fingerprints capture a bundle on
        # their next execution)
        self.tracer = tracing.Tracer()
        self.slow_traces: deque = deque(maxlen=32)
        self.stmtdiag = StmtDiagRegistry(metrics=self.metrics)
        self.metrics.counter(
            "exec.profile.statements",
            "statements executed with an active profile sink")
        self.metrics.counter(
            "exec.profile.operators",
            "operator entries recorded into profile sinks")
        # admission in front of the statement gate (utils/admission.py):
        # a bounded, tenant-fair queue of execution slots
        self.admission = AdmissionController(slots=16, max_queue=128)
        self._admission_metrics()
        self._sessions_lock = threading.Lock()
        # name -> view descriptor (None = read the catalog again)
        self._view_defs: dict | None = None
        self._lane_init()
        # cold start (exec/coldstart.py): this card's and toolchain's
        # cache subdirectory (the shapes journal, kernel 1's tuning and
        # parity-verdict tables), None when the cache is off; the
        # compile, autotune and parity-gate metrics
        self._compile_cache_dir = coldstart.init_cache_dir(self.settings,
                                                           self.device)
        self._device_key = coldstart.device_key(self.device)
        coldstart.register_metrics(self.metrics)
        autotune.register_metrics(self.metrics)
        paritygate.register_metrics(self.metrics)
        self._mesh_metrics()
        self._kernel_metrics()

    # -- public API ----------------------------------------------------------
    def session(self) -> Session:
        s = Session()
        self._track_session(s)
        return s

    def close(self) -> None:
        """Release what the engine holds on its device: each resident
        table copy with its reservation, the compiled plans and the mesh
        dispatchers' threads (the full mesh's and every pool
        sub-mesh's). Its changefeed jobs are canceled (their threads end
        at their next check). The engine stays usable: a later statement
        uploads again, and a later dispatch respawns its dispatcher's
        thread (parallel/distagg.py). The pod's rendezvous, if this
        process joined one, is torn down (multihost.shutdown_distributed)."""
        for jid in list(self._cdc_threads):
            self.jobs.cancel(jid)
        self._cdc_threads.clear()
        with self._device_lock:
            for name in {k[0] for k in self._device_tables} | \
                    {k[0] for k in self._mesh_tables}:
                self._evict_device(name)
        with self._cache_lock:
            for k in list(self._exec_cache):
                del self._exec_cache[k]
        if self.mesh is not None:
            distagg.shutdown_dispatchers(self.mesh)
        pool = self._mesh_pool
        if pool is not None:
            for size in pool.sizes():
                for m in pool.submeshes(size):
                    distagg.shutdown_dispatchers(m)
        # tear down the cross-host rendezvous too: a closed engine must
        # not leave a live store client behind, or the next engine in
        # this process (back-to-back tests, hostd restarts) inherits a
        # stale coordinator
        multihost.shutdown_distributed()

    def _kernel_metrics(self) -> None:
        """The hand-written kernels' launch counts and their plain
        versions' call counts in this process (each wrapper's own
        LAUNCHES and PLAIN_CALLS, read live), so a node's kernel work is
        read off its /_status/vars from outside the process."""
        from ..ops.cuda import groupagg, groupagg_large
        m = self.metrics
        for name, mod in (("groupagg_large", groupagg_large),
                          ("groupagg", groupagg)):
            m.func_counter(f"kernel.{name}.launches",
                           lambda mod=mod: mod.LAUNCHES,
                           f"launches of the {name} CUDA kernel in this "
                           "process")
            m.func_counter(f"kernel.{name}.plain_calls",
                           lambda mod=mod: mod.PLAIN_CALLS,
                           f"calls of the {name} kernel's plain PyTorch "
                           "version (CPU tensors) in this process")

    # -- the mesh ------------------------------------------------------------
    def _mesh_metrics(self) -> None:
        """The sub-mesh plane's metrics (exec.submesh.*: the pool read
        live) and the exchange bytes tallied when plans were built."""
        from ..parallel import shuffle
        m = self.metrics
        m.func_gauge(
            "exec.submesh.count",
            lambda: (0 if self._mesh_pool is None else
                     sum(self._mesh_pool.count(s)
                         for s in self._mesh_pool.sizes())),
            "sub-meshes in the dispatch pool (0 = pool not built)")
        m.func_counter(
            "exec.submesh.dispatches",
            lambda: (0 if self._mesh_pool is None else
                     self._mesh_pool.dispatches),
            "distributed dispatches routed to a sub-mesh")
        m.func_gauge(
            "exec.submesh.occupancy",
            lambda: (0 if self._mesh_pool is None else
                     self._mesh_pool.occupancy()),
            "in-flight distributed dispatches across all sub-meshes")
        m.func_counter(
            "exec.movement.exchange.traced.bytes",
            shuffle.EXCHANGE_TRACED.value,
            "all_to_all exchange buffer bytes, tallied when a plan is "
            "built")
        # multi-host pod membership, read live off the rendezvous
        # (parallel/multihost.py): 1 until init_distributed ran
        m.func_gauge(
            "exec.multihost.hosts", multihost.num_hosts,
            "host processes in this engine's rendezvous domain "
            "(1 = single-host)")

    def _submesh_pool(self):
        """The MeshPool over this engine's mesh, built at first use;
        None when the mesh cannot split (absent or one slot)."""
        if self.mesh is None or self.mesh.size < 2:
            return None
        pool = self._mesh_pool
        if pool is None:
            with self._mesh_pool_lock:
                pool = self._mesh_pool
                if pool is None:
                    pool = self._mesh_pool = meshmod.MeshPool(self.mesh)
        return pool

    def _dist_decision(self, node, session: Session):
        """Distributed over the mesh or on one device: the analogue of
        DistSQL's shouldDistributePlan (the reference's rules). A
        statement under the fine profile plane (EXPLAIN ANALYZE, an
        armed diagnostics capture) runs on one device, as the
        reference's measured re-run does: its operators' spans are the
        issuing thread's."""
        if str(session.vars.get("distsql", "auto")) == "off":
            return None
        if self.mesh is None or self.mesh.size <= 1:
            return None
        if self.mesh.size & (self.mesh.size - 1):
            return None  # table padding is a power of two to split
        if not self.settings.get("sql.distsql.mesh_partitioning.enabled"):
            return None
        if self._analyzing or profile.requested():
            return None
        d = distagg.analyze(node)
        return d if d.ok else None

    def _track_session(self, s: Session) -> None:
        with self._sessions_lock:
            self._open_sessions.add(s)

    def execute(self, sql: str, session: Session | None = None) -> Result:
        # the OLTP lane first: it returns None for whatever it does not
        # serve bit for bit
        res = self.lane_execute(sql, session)
        if res is not None:
            return res
        session = session or self.session()
        self._track_session(session)
        app = str(session.vars.get("application_name") or "")
        # each anonymous connection is a tenant of its own
        tenant = app or f"s{id(session)}"
        try:
            stmt = self._parse_cached(sql, tenant)
        except Exception:
            # a syntax error inside an explicit txn block aborts it,
            # as any other statement failure does (pg semantics)
            if session.txn is not None:
                session.txn_aborted = True
            raise
        if session.txn_aborted and not isinstance(
                stmt, (ast.CommitTxn, ast.RollbackTxn)):
            raise EngineError(
                "current transaction is aborted, commands ignored "
                "until end of transaction block")
        # admission before the lane fence and the gate, as in the
        # reference: a statement queued here holds neither
        hbm_est = (self._stmt_hbm_estimate(stmt)
                   if self.admission.tenant_hbm_bytes else 0)
        self.admission.acquire(
            priority=str(session.vars.get("admission_priority", "normal")),
            tenant=tenant, hbm=hbm_est)
        prev = (getattr(self._tenant_tl, "value", ""),
                getattr(self._tenant_tl, "app", ""))
        self._tenant_tl.value = tenant
        # the rollup key: reservations made now belong to it
        self._tenant_tl.app = app or "(unset)"
        if self.cluster is not None and not self._in_statement:
            # the scan plane is a cache of committed range data: check
            # every referenced table's replicated generation token and
            # re-materialize what other gateways changed, under the
            # exclusive gate (the refresh rebuilds columnstore tables
            # other statements may be scanning)
            with self._stmt_lock:
                self._sync_scan_plane(stmt)
        obs = StatementObserver(self, stmt, session, sql)
        t0 = time.monotonic()
        # the statement's compile bill: plan builds and kernel builds
        # and loads run on this thread (exec/coldstart.py)
        c0 = coldstart.thread_compile_seconds()
        try:
            with obs.observe():
                with self._run_scope(self._stmt_tables(stmt),
                                     self._stmt_read_only(stmt, session,
                                                          sql)):
                    res = self._dispatch(stmt, session, sql)
                compile_s = coldstart.thread_compile_seconds() - c0
                if compile_s > 0:
                    self.tracer.tag(compile_s=round(compile_s, 6))
        except Exception:
            if session.txn is not None and not isinstance(
                    stmt, ast.BeginTxn):
                session.txn_aborted = True
            dt = time.monotonic() - t0
            self.metrics.counter("sql.failure.count",
                                 "statements that errored").inc()
            obs.failed()
            self.sqlstats.record(sql, dt, 0, failed=True)
            self.sqlstats.record_tenant(app or "(unset)", wall_s=dt,
                                        failed=True)
            raise
        finally:
            self._tenant_tl.value, self._tenant_tl.app = prev
            self.admission.release(tenant=tenant, hbm=hbm_est)
        dt = time.monotonic() - t0
        self.metrics.counter(f"sql.{type(stmt).__name__.lower()}.count",
                             "statements executed, by type").inc()
        self.metrics.histogram("sql.exec.latency",
                               "statement execution latency (s)").observe(dt)
        self.devstats.note_execute(dt)
        rows = max(len(res.rows), res.row_count)
        self.sqlstats.record(sql, dt, rows, compile_s=compile_s)
        psink = obs.psink
        # the statement's bytes moved and stalls (the coarse profile
        # plane: resident uploads, streamed pages, spilled partitions),
        # its time on the card and the tenant's own HBM high-water
        self.sqlstats.record_tenant(
            app or "(unset)", wall_s=dt, rows=rows,
            bytes_moved=psink.total_bytes_moved() if psink else 0,
            stall_s=psink.total_stall_seconds() if psink else 0.0,
            device_s=obs.device_seconds(),
            hbm_bytes=(self.hbm.owner_peak(app or "(unset)")
                       if psink else None))
        obs.compile_s = compile_s
        obs.finished(res, dt)
        return res

    def _parse_cached(self, sql: str, tenant: str):
        """The statement's AST, parsed once per text. A plain SELECT (no
        CTEs, no derived tables) runs without editing its AST (view
        expansion and the temp path copy before they rewrite), so it
        shares the cached object; any other statement gets a deep copy,
        since its executor may rewrite it in place."""
        with self._cache_lock:
            stmt = self._parse_cache.get(sql)
        if stmt is None:
            stmt = parser.parse(sql)
            with self._cache_lock:
                self._parse_cache.put(sql, stmt, tenant)
        if isinstance(stmt, ast.Select) and not stmt.ctes \
                and not self._has_derived(stmt):
            return stmt
        return copy.deepcopy(stmt)

    def _stmt_hbm_estimate(self, stmt) -> int:
        """The tenant HBM ledger's estimate of a statement: the device
        bytes of a resident upload of every column of each base table
        it names (exec/scanplane.py's reckoning), projection and filters
        ignored. It gates concurrency per tenant; uploads still reserve
        against the budget themselves."""
        total = 0
        for t in self._stmt_tables(stmt) or ():
            td = self.store.tables.get(t)
            if td is not None:
                total += self._table_device_bytes(td, None)
        return total

    def _admission_metrics(self) -> None:
        """The admission plane's metrics and settings hook
        (cockroach_tpu/exec/engine.py's wiring)."""
        m, adm = self.metrics, self.admission
        m.func_counter("admission.admitted", lambda: adm.admitted,
                       "statements granted an execution slot")
        m.func_counter("admission.rejected", lambda: adm.rejected,
                       "statements rejected (queue full, wait timeout, "
                       "or shed)")
        m.func_counter("admission.queued", lambda: adm.queued,
                       "statements that waited in the admission queue")
        adm.wait_observer = m.histogram(
            "admission.wait_seconds",
            "admission queue wait per queued grant (s)").observe
        # transfer-stall back-pressure: a saturated copy engine sheds
        # low-priority statements before they queue
        adm.movement_wait_p99 = lambda: self.movement.m_wait.quantile(0.99)
        # the backlog in front of the card: writers waiting at the gate
        adm.exec_queue_depth = self.devstats.queue_depth
        m.func_counter(
            "admission.tenant.slot_waits", lambda: adm.tenant_slot_waits,
            "statements queued because their tenant was at its "
            "concurrent-slot cap while global slots were free")
        m.func_counter(
            "admission.tenant.hbm_waits", lambda: adm.tenant_hbm_waits,
            "statements queued because their tenant's in-flight HBM "
            "ledger could not fit the statement's estimate")
        m.func_gauge(
            "admission.tenant.active", lambda: len(adm.tenant_usage()),
            "tenants currently holding at least one execution slot")
        m.func_counter(
            "admission.tenant.plan_evictions",
            lambda: (sum(self._exec_cache.tenant_evictions.values())
                     + sum(self._parse_cache.tenant_evictions.values())),
            "plan/parse cache entries a tenant evicted from its own "
            "partition on hitting sql.exec.plan_cache.tenant_budget")
        self._admission_settings()
        self.settings.on_change(
            lambda n, v: self._admission_settings()
            if n.startswith(("sql.admission.", "sql.exec.plan_cache.",
                             "sql.exec.hbm_budget_bytes")) else None)

    def _admission_settings(self) -> None:
        """The controller's shed thresholds and tenant quotas, and the
        caches' tenant budget, from sql.admission.* and
        sql.exec.plan_cache.tenant_budget (0 disables each)."""
        g, adm = self.settings.get, self.admission
        adm.shed_queue_depth = int(g("sql.admission.shed.queue_depth"))
        adm.shed_wait_seconds = float(g("sql.admission.shed.wait_seconds"))
        adm.shed_exec_queue_depth = int(
            g("sql.admission.shed.exec_queue_depth"))
        adm.tenant_slots = int(g("sql.admission.tenant.slots"))
        frac = float(g("sql.admission.tenant.hbm_fraction"))
        adm.tenant_hbm_bytes = (int(frac * int(g("sql.exec.hbm_budget_bytes")))
                                if frac > 0 else 0)
        budget = int(g("sql.exec.plan_cache.tenant_budget"))
        self._exec_cache.tenant_budget = budget
        self._parse_cache.tenant_budget = budget

    @contextlib.contextmanager
    def _gate(self, shared: bool):
        """The statement gate's shared or exclusive side."""
        if shared:
            self._stmt_lock.acquire_read()
            try:
                yield
            finally:
                self._stmt_lock.release_read()
        else:
            with self._stmt_lock:
                yield

    def _stmt_read_only(self, stmt, session: Session,
                        sql_text: str) -> bool:
        """May this statement run under the shared side of the gate?
        Plain single-SELECTs outside a txn do; anything that can change
        engine-shared state (DML and DDL, txn sessions, CTE and derived
        temps, views, which expand into derived temps, sequence calls,
        subqueries, which can decorrelate into temps) is exclusive."""
        if not isinstance(stmt, ast.Select):
            return False
        if session.txn is not None or session.effects:
            return False
        if stmt.ctes or self._has_derived(stmt):
            return False
        low = (sql_text or "").lower()
        if "nextval" in low or "setval" in low or "currval" in low:
            return False
        if low.count("select") != 1:
            return False
        views = self._view_map()
        refs = ([stmt.table] if stmt.table is not None else []) \
            + [j.table for j in stmt.joins]
        return not any(r.subquery is None and r.name in views
                       for r in refs)

    def _dispatch(self, stmt, session: Session, sql: str) -> Result:
        if isinstance(stmt, (ast.Select, ast.SetOp)):
            with self._statement():
                return self._exec_select(stmt, session, sql)
        if isinstance(stmt, ast.Explain):
            with self._statement():
                return self._exec_explain(stmt, session, sql)
        if isinstance(stmt, (ast.ShowVar, ast.ShowAll, ast.ShowTables,
                             ast.ShowColumns, ast.ShowCreateTable,
                             ast.ShowTrace)):
            return self._exec_show(stmt, session)
        if isinstance(stmt, ast.ConfigureZone):
            return self._exec_configure_zone(stmt)
        if isinstance(stmt, ast.ShowZone):
            return self._exec_show_zone(stmt)
        if isinstance(stmt, ast.ShowIndexes):
            return self._exec_show_indexes(stmt)
        if isinstance(stmt, ast.ShowJobs):
            return self._exec_show_jobs()
        if isinstance(stmt, ast.CancelJob):
            # asynchronous: the gate is held here and a changefeed's
            # thread may be waiting for it, so joining would deadlock;
            # the job sees the request at its next check and ends
            self.jobs.cancel(stmt.job_id)
            self._cdc_threads.pop(stmt.job_id, None)
            return Result(tag="CANCEL JOB")
        if isinstance(stmt, ast.Backup):
            return self._exec_backup(stmt)
        if isinstance(stmt, ast.Restore):
            return self._exec_restore(stmt)
        if isinstance(stmt, ast.CreateChangefeed):
            jid = self.create_changefeed(stmt.table, stmt.sink)
            return Result(names=["job_id"], rows=[(jid,)],
                          tag="CREATE CHANGEFEED")
        if isinstance(stmt, (ast.Insert, ast.Update, ast.Delete,
                             ast.Truncate, ast.AlterTable)) \
                and stmt.table in self._view_map():
            raise EngineError(
                f"{stmt.table!r} is a view; views are not modifiable")
        if isinstance(stmt, (ast.CreateTable, ast.DropTable,
                             ast.Truncate, ast.CreateView, ast.DropView,
                             ast.CreateIndex, ast.DropIndex,
                             ast.AlterTable, ast.Restore)):
            # eligibility may flip (a CHECK, an FK child, an index, a
            # column DEFAULT); a re-created or changed table needs a new
            # mirror
            self._lane_reset()
        if isinstance(stmt, ast.AlterTable):
            return self._exec_alter(stmt)
        if isinstance(stmt, ast.CreateIndex):
            return self._exec_create_index(stmt)
        if isinstance(stmt, ast.DropIndex):
            return self._exec_drop_index(stmt)
        if isinstance(stmt, ast.CreateView):
            return self._exec_create_view(stmt, session)
        if isinstance(stmt, ast.DropView):
            return self._exec_drop_view(stmt)
        if isinstance(stmt, ast.CreateSequence):
            return self._exec_create_sequence(stmt)
        if isinstance(stmt, ast.DropSequence):
            return self._exec_drop_sequence(stmt)
        if isinstance(stmt, ast.ShowSequences):
            return self._show_sequences()
        if isinstance(stmt, ast.Insert):
            return self._exec_insert(stmt, session)
        if isinstance(stmt, ast.Update):
            return self._exec_update(stmt, session)
        if isinstance(stmt, ast.Delete):
            return self._exec_delete(stmt, session)
        if isinstance(stmt, (ast.BeginTxn, ast.CommitTxn,
                             ast.RollbackTxn)):
            return self._txn_control(stmt, session)
        if isinstance(stmt, ast.CreateTable):
            return self._exec_create(stmt)
        if isinstance(stmt, ast.DropTable):
            return self._exec_drop(stmt)
        if isinstance(stmt, ast.Truncate):
            return self._exec_truncate(stmt)
        if isinstance(stmt, ast.Analyze):
            self.store.analyze(stmt.table)
            return Result(tag="ANALYZE")
        if isinstance(stmt, ast.ShowStatements):
            return Result(
                names=["fingerprint", "count", "mean_latency_ms",
                       "max_latency_ms", "rows", "failures"],
                rows=[(st.fingerprint, st.count,
                       round(st.mean_latency_s * 1e3, 3),
                       round(st.max_latency_s * 1e3, 3),
                       st.total_rows, st.failures)
                      for st in self.sqlstats.all()],
                tag="SHOW STATEMENTS")
        if isinstance(stmt, ast.SetVar) and stmt.cluster:
            try:
                self.settings.set(stmt.name, stmt.value)
            except SettingError as e:
                raise EngineError(str(e)) from e
            return Result(tag="SET CLUSTER SETTING")
        if isinstance(stmt, ast.SetVar) \
                and stmt.name == "statement_diagnostics":
            # SET statement_diagnostics = '<statement>' arms its
            # fingerprint: the next execution captures a bundle
            req = self.stmtdiag.arm(str(stmt.value))
            return Result(names=["request_id", "fingerprint"],
                          rows=[(req["request_id"], req["fingerprint"])],
                          tag="SET")
        if isinstance(stmt, ast.SetVar):
            value = stmt.value
            if stmt.name in _VAR_VALUES:
                value = str(value).lower()
                if value not in _VAR_VALUES[stmt.name]:
                    *head, last = _VAR_VALUES[stmt.name]
                    raise EngineError(
                        f"invalid value for {stmt.name}: {value!r} "
                        f"({', '.join(head)} or {last})")
            elif stmt.name == "hash_group_capacity":
                value = _capacity(value)
            elif stmt.name == "streaming_page_rows":
                try:
                    value = int(value)
                except (TypeError, ValueError):
                    value = 0
                if value <= 0:
                    raise EngineError("invalid value for "
                                      "streaming_page_rows: a positive "
                                      "row count")
            session.vars.set(stmt.name, value)
            return Result(tag="SET")
        raise EngineError(
            f"statement {type(stmt).__name__} is not yet ported")

    # -- transaction control -------------------------------------------------
    def _txn_control(self, stmt, session: Session) -> Result:
        """BEGIN opens a kv.Txn whose writes buffer their scan-plane
        effects; COMMIT publishes them at the commit timestamp (the
        COMMIT of an aborted txn is a ROLLBACK); ROLLBACK discards
        them."""
        if isinstance(stmt, ast.BeginTxn):
            if session.txn is not None:
                raise EngineError("transaction already open")
            session.txn = Txn(self.kv.store)
            session.effects = []
            session.txn_aborted = False
            return Result(tag="BEGIN")
        t = session.txn
        effects, aborted = session.effects, session.txn_aborted
        session.txn, session.effects = None, []
        session.txn_aborted = False
        if isinstance(stmt, ast.RollbackTxn) or aborted:
            if t is not None:
                t.rollback()
            return Result(tag="ROLLBACK")
        if t is None:
            return Result(tag="COMMIT")
        toks = {}
        try:
            if self.cluster is not None and effects:
                toks = self._bump_table_gens(
                    t, sorted({tb for tb, _ in effects}))
            commit_ts = t.commit()
        except (TxnRetryError, TxnAbortedError) as e:
            t.rollback()
            # the "restart transaction" class (40001): the client
            # retries the whole txn
            raise EngineError(f"restart transaction: {e}") from e
        self._publish(effects, commit_ts)
        self._scan_gens.update(toks)
        return Result(tag="COMMIT")

    def _read_ts(self, session: Session) -> Timestamp:
        return session.txn_read_ts or self.clock.now()

    def _as_of_ts(self, sel, session: Session) -> Timestamp | None:
        """The statement's AS OF SYSTEM TIME as a Timestamp, or None
        without one. The forms (a subset of the reference's,
        sql/as_of.go): a negative interval string ('-10s', '-2m',
        '-1h'), a timestamp string, or decimal HLC wall nanoseconds."""
        aso = getattr(sel, "as_of", None)
        if aso is None:
            return None
        if session.txn is not None:
            raise EngineError(
                "AS OF SYSTEM TIME is not allowed inside a transaction")
        if not isinstance(aso, ast.Literal):
            raise EngineError("AS OF SYSTEM TIME requires a constant")
        v = aso.value
        if isinstance(v, str):
            m = re.fullmatch(r"-(\d+(?:\.\d+)?)([smh])", v.strip())
            if m:
                mult = {"s": 1e9, "m": 60e9, "h": 3600e9}[m.group(2)]
                wall = self.clock.now().wall - int(float(m.group(1)) * mult)
            else:
                try:
                    wall = parse_timestamp(v) * 1000  # micros -> ns
                except Exception:
                    raise EngineError(
                        f"cannot parse AS OF SYSTEM TIME {v!r}") from None
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            wall = int(v)
        else:
            raise EngineError(f"cannot parse AS OF SYSTEM TIME {v!r}")
        if wall <= 0 or wall > self.clock.now().wall:
            raise EngineError("AS OF SYSTEM TIME must be in the past")
        return Timestamp(int(wall), 0)

    def _stmt_read_ts(self, sel, session: Session) -> Timestamp:
        """The read timestamp of one SELECT: its AS OF SYSTEM TIME, else
        the session's."""
        return self._as_of_ts(sel, session) or self._read_ts(session)

    @staticmethod
    def _overlay_puts(session: Session) -> dict:
        """Tables the session's open txn wrote -> its buffered puts on
        each (the tables a SELECT reads through the overlay)."""
        out: dict[str, int] = {}
        if session.txn is not None:
            for tb, op in session.effects:
                out[tb] = out.get(tb, 0) + (op[0] == "put")
        return out

    # -- sequences ------------------------------------------------------------
    SEQ_PREFIX = b"/seq/"

    def _sequence_ops(self, session: Session):
        return lambda fn, name, arg: self._sequence_op(session, fn, name,
                                                       arg)

    def _seq_desc(self, name: str) -> dict:
        raw = self.kv.txn(lambda t: t.get(self.SEQ_PREFIX + name.encode()))
        if raw is None:
            raise EngineError(f"sequence {name!r} does not exist")
        return json.loads(raw.decode())

    def _sequence_op(self, session: Session, fn: str, name: str,
                     arg) -> int:
        """nextval/currval/setval. nextval allocates in a KV txn of its
        own: a value is never handed out twice, and a ROLLBACK of the
        caller's txn never returns one (pg semantics)."""
        key = self.SEQ_PREFIX + name.encode()
        if fn == "currval":
            if name not in session.seq_currval:
                raise EngineError(f"currval of sequence {name!r} is not "
                                  f"yet defined in this session")
            return session.seq_currval[name]
        if fn == "nextval":
            def bump(t):
                raw = t.get(key)
                if raw is None:
                    raise EngineError(f"sequence {name!r} does not exist")
                d = json.loads(raw.decode())
                d["value"] = (d["start"] if d.get("value") is None
                              else d["value"] + d["increment"])
                t.put(key, json.dumps(d).encode())
                return d["value"]
            v = self.kv.txn(bump)
        else:  # setval
            desc = self._seq_desc(name)
            desc["value"] = int(arg)
            self.kv.txn(lambda t: t.put(key, json.dumps(desc).encode()))
            v = int(arg)
        session.seq_currval[name] = v
        return v

    def _show_sequences(self) -> Result:
        p = self.SEQ_PREFIX
        rows = []
        for k, v in self.kv.scan(p, prefix_end(p)):
            d = json.loads(v.decode())
            rows.append((k[len(p):].decode(), d["start"], d["increment"],
                         d.get("value")))
        return Result(names=["sequence_name", "start", "increment",
                             "last_value"], rows=sorted(rows),
                      tag="SHOW SEQUENCES")

    # -- planning ------------------------------------------------------------
    def catalog_view(self, read_ts: Timestamp | None = None,
                     sketch: bool = True,
                     int_ranges: bool = True,
                     stats: bool = True) -> CatalogView:
        """What the planner sees of the store: schemas, dictionaries,
        table statistics (ANALYZE output while fresh, else write-time
        sketches when ``sketch``) and the store's key probes.
        ``int_ranges=False`` withholds the int-range probe (inside an
        explicit txn overlay rows could fall outside a committed range
        and corrupt a mixed-radix group code). ``stats=False`` hides
        every data-dependent signal (row counts, distinct and
        uniqueness probes, int ranges), so the plan's shape is a
        function of the schema and the statement alone: every DistSQL
        node derives the same stage graph from the SQL while holding a
        different shard (distsql/shuffle.py)."""
        from ..sql.stats import TableStats
        # the planner sees the PUBLIC schema: a column mid-add or
        # mid-drop (WRITE_ONLY, jobs/schemachange.py) is in the store,
        # hidden until published; only PUBLIC indexes are access paths
        schemas = {}
        for n, td in self.store.tables.items():
            s = td.schema
            if any(c.hidden for c in s.columns):
                s = TableSchema(name=s.name,
                                columns=[c for c in s.columns
                                         if not c.hidden],
                                primary_key=list(s.primary_key),
                                table_id=s.table_id)
            schemas[n] = s
        indexes = {}
        for n in self.store.tables:
            if n.startswith(TEMP_PREFIX):
                continue   # a statement's temp: no descriptor, no index
            pub = [(i.name, tuple(i.columns), i.unique)
                   for i in self._table_indexes(n) if i.state == "public"]
            if pub:
                indexes[n] = pub
        dicts = {n: dict(td.dictionaries)
                 for n, td in self.store.tables.items()}
        if not stats:
            return CatalogView(schemas, dicts, {}, indexes=indexes)
        stats_map = {}
        for n, td in self.store.tables.items():
            st = None
            if td.stats is not None:
                # ANALYZE output wins while the table hasn't drifted
                # far from the row count it was computed at
                base = max(td.stats.analyzed_rows, 0)
                drifted = abs(td.row_count - base) > \
                    _STALE_ROW_FRACTION * max(base, 1)
                if not (sketch and drifted):
                    st = TableStats(
                        row_count=td.row_count,
                        distinct=dict(td.stats.distinct),
                        null_frac=dict(td.stats.null_frac),
                        analyzed=td.stats_generation == td.generation,
                        source="analyze",
                        analyzed_rows=td.stats.analyzed_rows)
            if st is None and sketch and td.chunks:
                st = self.store.sketch_stats(n)
                st.row_count = td.row_count
            if st is None:
                st = TableStats(row_count=td.row_count)
            stats_map[n] = st
        unique_fn = None
        if read_ts is not None:
            rti = read_ts.to_int()

            def unique_fn(t, cols, _rti=rti):
                return self.store.keys_unique_for_read(t, cols, _rti)
        return CatalogView(schemas, dicts, stats_map,
                           key_distinct_fn=self.store.key_distinct,
                           int_range_fn=(self.store.key_int_range
                                         if int_ranges else None),
                           keys_unique_fn=unique_fn, indexes=indexes)

    def _plan(self, stmt: ast.Select, session: Session,
              read_ts: Timestamp, no_memo: bool = False,
              for_explain: bool = False, trace=None):
        """(plan node, OutputMeta) of one SELECT. ``for_explain``: an
        EXPLAIN's plan, whose sequence calls bind to a placeholder
        instead of allocating (pg EXPLAIN semantics) and which may fold
        volatile builtins; ``trace`` is its sql/rules.RuleTrace."""
        if not isinstance(stmt, ast.Select):
            raise EngineError("can only EXPLAIN SELECT")
        in_txn = session.txn is not None
        cv = self.catalog_view(
            read_ts=None if in_txn else read_ts,
            int_ranges=not in_txn,
            sketch=(str(session.vars.get("optimizer_sketch_stats",
                                         "on")).lower()
                    not in ("off", "false")))

        # one run per distinct subquery of this plan: the planner may
        # bind a predicate more than once
        done = {}

        def subquery_eval(sel, limit_one):
            # AS OF pins the whole statement: its subqueries read at the
            # same timestamp
            sel = propagate_as_of(sel, stmt)
            key = (repr(sel), limit_one)
            if key not in done:
                done[key] = self._eval_subquery(sel, session, limit_one)
            return done[key]

        planner = Planner(
            cv, subquery_eval=subquery_eval,
            now_micros=read_ts.wall // 1000,
            sequence_ops=((lambda fn, name, arg: 0) if for_explain
                          else self._sequence_ops(session)),
            use_memo=(not no_memo
                      and session.vars.get("optimizer", "on") != "off"),
            volatile_fold_ok=for_explain,
            rules=session.vars.get("optimizer_rules", "on") != "off",
            trace=trace)
        return planner.plan_select(stmt)

    def _bound_agg_group_rows(self, node, read_ts: Timestamp,
                              overlay: dict) -> None:
        """Attach a static rows-per-group upper bound to Aggregate
        nodes whose group keys trace to stored columns of a scan
        (filters only shrink groups). The bound sizes the i32 limb
        width of exact int64 group sums; 0 = unknown. ``overlay``:
        table -> this txn's buffered puts, invisible to the store's
        measurement; each can add one row to some group."""

        def spine(n, names):
            while True:
                if isinstance(n, P.Filter):
                    n = n.child
                    continue
                if isinstance(n, P.Project):
                    nxt = []
                    items = dict(n.items)
                    for nm in names:
                        e = items.get(nm)
                        if not isinstance(e, BCol):
                            return None
                        nxt.append(e.name)
                    names = nxt
                    n = n.child
                    continue
                if isinstance(n, P.Scan):
                    stored = []
                    for nm in names:
                        s = n.columns.get(nm)
                        if s is None:
                            return None
                        stored.append(s)
                    return n.table, tuple(stored)
                return None

        def walk(n):
            if isinstance(n, P.Aggregate):
                if n.group_by and n.aggs:
                    names = []
                    for _, e in n.group_by:
                        if not isinstance(e, BCol):
                            names = None
                            break
                        names.append(e.name)
                    hit = spine(n.child, names) if names else None
                    if hit is not None:
                        table, stored = hit
                        k = self.store.key_max_multiplicity(
                            table, stored, read_ts.to_int(),
                            include_null_group=True)
                        k += overlay.get(table, 0)
                        if k > 0:
                            n.max_group_rows = k
                self._bound_agg_value_ranges(n, overlay)
            for attr in ("child", "left", "right"):
                c = getattr(n, attr, None)
                if c is not None:
                    walk(c)

        walk(node)

    def _bound_agg_value_ranges(self, agg, overlay: dict) -> None:
        """Attach stored-column value bounds to plain-column int64 SUM
        aggregates (BoundAgg.arg_max_abs/arg_nonneg): a SUM over a
        proven-non-negative narrow column needs limbs for bits(max)
        only."""
        colmap = {}

        def scans(n):
            if isinstance(n, P.Scan):
                for bname, sname in n.columns.items():
                    colmap[bname] = (n.table, sname)
                return
            for attr in ("child", "left", "right"):
                c = getattr(n, attr, None)
                if c is not None:
                    scans(c)

        scans(agg.child)
        for a in agg.aggs:
            if a.func not in ("sum", "sum_int") \
                    or not isinstance(a.arg, BCol):
                continue
            if a.arg.type.family not in (Family.INT, Family.DECIMAL):
                continue
            hit = colmap.get(a.arg.name)
            if hit is None or overlay.get(hit[0], 0):
                continue
            rng = self.store.key_int_range(hit[0], hit[1])
            if rng is None:
                continue
            lo, hi, _n = rng
            if lo >= 0 and hi > 0:
                a.arg_nonneg = True
                a.arg_max_abs = int(hi)

    # -- join build checks ---------------------------------------------------
    def _check_join_builds(self, node, read_ts: Timestamp,
                           overlay: dict) -> None:
        """The device hash join gathers ONE build row per probe key
        (ops/join.py: exact for unique build keys). Verify build-side
        key uniqueness on the host over the rows visible at the query's
        read timestamp before running, and pick direct addressing where
        the keys allow it. A duplicate-keyed build side sets the join's
        expansion factor K, measured over the visible rows (a static
        bound: ops/join.py then emits K copies per probe row); past
        MAX_JOIN_EXPANSION the join is refused. ``overlay``: table ->
        this txn's buffered puts, which widen the bound (each can add
        one more row per key) and forfeit the uniqueness fast path."""

        def walk(n):
            if isinstance(n, P.HashJoin):
                # the probe side first: its expansions bound this
                # join's probe rows
                walk(n.left)
                walk(n.right)
                if n.join_type in ("inner", "left"):
                    self._check_one_build(n, read_ts, overlay)
                return
            c = getattr(n, "child", None)
            if c is not None:
                walk(c)

        walk(node)

    def _check_one_build(self, join, read_ts: Timestamp,
                         overlay: dict) -> None:
        from ..sql.stats import _underlying_col
        b = join.right
        if not isinstance(b, P.Scan):
            return
        stored = []
        all_plain = True  # every key is a stored column, not computed
        computed = dict(b.computed)
        for rk in join.right_keys:
            sname = b.columns.get(rk)
            if sname is None:
                all_plain = False
                # computed key: a dictionary-code remap of a column is
                # injective, so check the underlying column instead
                inner = _underlying_col(computed.get(rk))
                if inner is not None:
                    sname = b.columns.get(inner.name)
            if sname is None:
                return  # cannot map back to storage; accept
            stored.append(sname)
        # direct addressing needs the RUNTIME key values' range, so
        # only plain stored keys qualify
        # a build the txn has written stays off direct addressing:
        # uncommitted rows could fall outside the measured range
        join.direct = None
        if all_plain and b.table not in overlay:
            self._maybe_direct_join(join, b, stored)
        buffered_puts = overlay.get(b.table, 0)
        if buffered_puts == 0 and self.store.keys_unique_for_read(
                b.table, tuple(stored), read_ts.to_int()):
            join.expand = 1
            return
        # measured at table granularity: a pushed build filter can only
        # lower the true multiplicity, so K is a safe upper bound
        k = self.store.key_max_multiplicity(b.table, tuple(stored),
                                            read_ts.to_int()) \
            + buffered_puts
        limit = self.MAX_JOIN_EXPANSION
        if k > limit and k <= MAX_EXPAND and _probe_rows_bound(
                self, join.left) * k <= self.MAX_WIDE_EXPANDED_ROWS:
            limit = MAX_EXPAND
        if k > limit:
            raise EngineError(
                f"hash join build side {b.table!r} has up to {k} "
                f"duplicate rows per key {stored} (limit "
                f"{self.MAX_JOIN_EXPANSION}, or {MAX_EXPAND} while the "
                f"expanded rows stay within "
                f"{self.MAX_WIDE_EXPANDED_ROWS}); make the lower-"
                "multiplicity table the build side")
        join.expand = max(k, 1)

    # the largest expansion factor a duplicate-keyed build may have (the
    # reference's), and past it, up to ops/join.py MAX_EXPAND, the
    # expanded rows a small probe side may reach
    MAX_JOIN_EXPANSION = 32
    MAX_WIDE_EXPANDED_ROWS = 1 << 24
    MAX_DIRECT_JOIN_SLOTS = 1 << 22
    # packed composite keys size the table by the SPAN PRODUCT
    MAX_PACKED_JOIN_SLOTS = 1 << 27

    def _maybe_direct_join(self, join, b, stored) -> None:
        """Direct-address the join when the build key is int-family
        with a dense enough value range (dimension pks, dict codes): one
        scatter + one gather instead of the hash table's rounds. A
        single key sizes the table by its span; composite keys pack
        mixed-radix and size it by the span product."""
        join.direct = None
        ranges = []
        n_all = 0
        for s in stored:
            col = self.store.table(b.table).schema.column(s)
            if col.type.family == Family.FLOAT:
                return
            r = self.store.key_int_range(b.table, s)
            if r is None:
                return
            lo, hi, n_all = r
            ranges.append((lo, hi - lo + 1))
        if len(ranges) == 1:
            lo, span = ranges[0]
            # density is a memory question: a sparse table is still one
            # scatter and one gather
            if span <= max(256 * n_all, 4096) \
                    and span + 1 <= self.MAX_DIRECT_JOIN_SLOTS:
                join.direct = (lo, span + 1)
            return
        total = 1
        for _, span in ranges:
            total *= span
            if total > self.MAX_PACKED_JOIN_SLOTS:
                return
        # payload folding allocates ~one size-length table per carried
        # payload column on top of the slot table: budget all of them
        if total * (2 + len(join.payload)) > 1 << 29:
            return
        if total <= max(2048 * n_all, 4096):
            join.direct = ("packed", tuple(lo for lo, _ in ranges),
                           tuple(span for _, span in ranges))

    # -- selection compaction (compile.compact_batch) ------------------------
    COMPACT_MAX_EST = 1 / 8     # only bother below this selectivity

    def _estimate_scan_selectivity(self, scan) -> float | None:
        """Upper-bound selectivity of a scan's pushed-down filter from
        stored column ranges (uniform within [min, max]) and dictionary
        sizes. Only int-family range/equality conjuncts, dictionary
        predicates and IN-lists contribute; every other conjunct can
        only shrink the true selectivity, so the estimate stays an upper
        bound, safe for sizing capacity."""
        from ..sql.bound import BBin, BConst, BDictLookup, BInList
        pred = scan.filter
        if pred is None:
            return None
        cons: dict[str, list] = {}
        dict_fracs: list[float] = []

        def _dict_len(col: BCol) -> int | None:
            stored = scan.columns.get(col.name)
            if stored is None:
                return None
            d = self.store.table(scan.table).dictionaries.get(stored)
            return len(d.values) if d is not None else None

        def walk(e):
            if isinstance(e, BBin) and e.op == "and":
                walk(e.left)
                walk(e.right)
                return
            if isinstance(e, BDictLookup) and isinstance(e.expr, BCol):
                # precomputed dictionary predicate (LIKE, ordered string
                # compare): the bool table's mean IS the fraction of
                # distinct values matching
                tbl = np.asarray(e.table)
                if tbl.size:
                    dict_fracs.append(float(tbl.mean()))
                return
            if isinstance(e, BInList) and isinstance(e.expr, BCol) \
                    and e.expr.type.uses_dictionary and not e.negated:
                n = _dict_len(e.expr)
                if n:
                    dict_fracs.append(min(1.0, len(e.values) / n))
                return
            if isinstance(e, BInList) and isinstance(e.expr, BCol) \
                    and not e.negated \
                    and e.expr.type.family in (Family.INT, Family.DATE):
                # near-unique values assumed: not a hard bound for
                # duplicate keys, but Compact's sentinel replans if it
                # undershoots
                stored = scan.columns.get(e.expr.name)
                if stored is not None:
                    r = self.store.key_int_range(scan.table, stored)
                    if r is not None and r[2] > 0:
                        dict_fracs.append(min(1.0, len(e.values) / r[2]))
                return
            if isinstance(e, BBin) and e.op in ("<", "<=", ">", ">=", "="):
                left, right, op = e.left, e.right, e.op
                if isinstance(left, BConst) and isinstance(right, BCol):
                    left, right = right, left
                    op = {"<": ">", "<=": ">=", ">": "<",
                          ">=": "<="}.get(op, op)
                if not (isinstance(left, BCol) and isinstance(right, BConst)
                        and isinstance(right.value, int)
                        and not isinstance(right.value, bool)):
                    return
                if op == "=" and left.type.uses_dictionary:
                    # dict-code equality: 1/ndv with the dictionary
                    # length as the distinct count
                    n = _dict_len(left)
                    if n:
                        dict_fracs.append(1.0 / n)
                    return
                cons.setdefault(left.name, []).append((op, right.value))
        walk(pred)
        if not cons and not dict_fracs:
            return None
        est = 1.0
        for f in dict_fracs:
            est *= f
        got = bool(dict_fracs)
        for bname, cs in cons.items():
            stored = scan.columns.get(bname)
            if stored is None:
                continue
            r = self.store.key_int_range(scan.table, stored)
            if r is None:
                continue
            lo_c, hi_c, _n = r
            lo, hi = lo_c, hi_c
            for op, v in cs:
                if op == ">=":
                    lo = max(lo, v)
                elif op == ">":
                    lo = max(lo, v + 1)
                elif op == "<=":
                    hi = min(hi, v)
                elif op == "<":
                    hi = min(hi, v - 1)
                else:           # =
                    lo, hi = max(lo, v), min(hi, v)
            width = hi_c - lo_c + 1
            if width <= 0:
                continue
            est *= max(0, hi - lo + 1) / width
            got = True
        return est if got else None

    def _compact_frac(self, est: float) -> float:
        # 4x headroom over the uniform estimate absorbs moderate
        # per-block skew; worse skew trips the sentinel and the engine
        # replans uncompacted
        return min(0.25, max(est * 4, 1 / 256))

    def _insert_compaction(self, node):
        """Wrap the DEEPEST point of a probe spine under aggregation
        where the estimated surviving fraction drops to <= 1/8 in a
        Compact node (compile.compact_batch): everything above (join
        probe gathers, CASE math, grouped scatters) then runs at a
        fraction of the batch width.

        Selectivity accumulates up the spine: a scan's pushed filter or
        an INNER join against a filtered build side both shrink the
        selected set, so the wrap point may be a Scan or a mid-spine
        HashJoin. A scan feeding aggregation with no join stays masked
        (the fused filter and aggregate are already one pass). Wraps
        above the last join also require a scatter-strategy aggregate
        (hash, or dense past 64 groups). An expanding join (duplicate
        build keys) bounds the wrap point: the spine below it still
        compacts, so its K-way copy runs over the packed width. Project
        and Window stop the walk."""

        def build_sel(jn) -> float:
            if jn.join_type != "inner":
                return 1.0
            if isinstance(jn.right, P.Scan):
                e = self._estimate_scan_selectivity(jn.right)
                return e if e is not None else 1.0
            return 1.0

        # returns (node, est, wrapped_below, joins_below)
        def spine(n, joins_above, agg_scatters):
            if isinstance(n, P.Filter):
                c, est, wrapped, jb = spine(n.child, joins_above,
                                            agg_scatters)
                n.child = c
                return n, est, wrapped, jb
            if isinstance(n, P.Scan):
                est = self._estimate_scan_selectivity(n)
                est = est if est is not None else 1.0
                if est <= self.COMPACT_MAX_EST and joins_above > 0:
                    return (P.Compact(n, frac=self._compact_frac(est)),
                            est, True, 0)
                return n, est, False, 0
            if isinstance(n, P.HashJoin):
                if n.expand != 1:
                    # the expanded output breaks the estimate for wraps
                    # at or above this node; report wrapped so nothing
                    # above compacts it
                    c, _, _, jb = spine(n.left, joins_above + 1,
                                        agg_scatters)
                    n.left = c
                    return n, 1.0, True, jb + 1
                c, left_est, wrapped, jb = spine(n.left, joins_above + 1,
                                                 agg_scatters)
                n.left = c
                est = left_est * build_sel(n)
                if not wrapped and est <= self.COMPACT_MAX_EST \
                        and (joins_above > 0 or agg_scatters):
                    return (P.Compact(n, frac=self._compact_frac(est)),
                            est, True, jb + 1)
                return n, est, wrapped, jb + 1
            return n, 1.0, False, 0

        def walk(n):
            if isinstance(n, P.Aggregate):
                dense = n.max_groups > 0
                scatters = bool(n.group_by) and \
                    (not dense or n.max_groups > 64)
                n.child = spine(n.child, 0, scatters)[0]
                return n
            if isinstance(n, P.Project):
                # compile bubbles the sentinel through Project
                n.child = spine(n.child, 0, True)[0]
                return n
            if isinstance(n, (P.Sort, P.Limit)):
                n.child = walk(n.child)
                return n
            return n
        return self._defer_payloads_past_compact(walk(node))

    def _defer_payloads_past_compact(self, root):
        """Payload pull-up: for every direct inner join BELOW a Compact,
        defer the payload columns no node between the join and the
        Compact consumes to a re-probe join ABOVE the Compact:

            join(match [+ used/packed payloads]) -> Compact
              -> join(deferred payloads)

        Each deferred payload gather then touches the compacted rows
        only. The build side is scanned twice; its tables are small.
        Packed (dictionary-code/bool) payloads stay below: they cost one
        fused gather already."""
        from ..sql.bound import referenced_columns

        def pull_up(compact):
            used: set[str] = set()
            deferred: list = []

            def descend(n):
                if isinstance(n, P.Filter):
                    used.update(referenced_columns(n.pred))
                    n.child = descend(n.child)
                    return n
                if isinstance(n, P.HashJoin):
                    used.update(n.left_keys)
                    used.update(n.right_keys)
                    if n.join_type == "inner" and n.expand == 1 \
                            and n.direct is not None:
                        packed = set(n.pack_payload or ())
                        defer = [p for p in n.payload
                                 if p not in packed and p not in used]
                        if defer:
                            n.payload = [p for p in n.payload
                                         if p not in defer]
                            deferred.append(P.HashJoin(
                                left=None, right=n.right,
                                left_keys=list(n.left_keys),
                                right_keys=list(n.right_keys),
                                payload=defer, join_type="inner",
                                expand=1, direct=n.direct,
                                pack_payload=[]))
                    used.update(n.payload)
                    n.left = descend(n.left)
                    return n
                return n

            compact.child = descend(compact.child)
            top = compact
            for dj in deferred:
                dj.left = top
                top = dj
            return top

        def walk(n):
            for attr in ("child", "left", "right"):
                c = getattr(n, attr, None)
                if c is not None:
                    setattr(n, attr, walk(c))
            if isinstance(n, P.Compact):
                return pull_up(n)
            return n

        return walk(root)

    # -- statement accounting ------------------------------------------------
    @contextlib.contextmanager
    def _statement(self):
        """Scope of one user-level statement (execute, or a prepared
        handle's run): ``last_exec`` starts fresh at the outermost
        entry; subqueries and temps inside it add to it."""
        if self._in_statement:
            yield
            return
        self._in_statement = True
        self.last_exec = _fresh_route()
        self.last_exec["waits"] = self._scope_waits
        try:
            yield
        finally:
            self._in_statement = False

    @contextlib.contextmanager
    def _run_scope(self, tables, shared: bool):
        """The scope of one statement (execute, or a prepared handle's
        run). Full-path statements read the columnstore: the lane's
        queued writes on ``tables`` (every table for None) publish first
        and lane writes there wait until the statement ends; then the
        gate is held, shared or exclusive. Inside a statement this
        thread is already running, both are held. Temps are not lane
        tables. The seconds spent getting in go to ``last_exec["waits"]``
        (``_nonlane_scope``'s ``fence_s``/``flush_s``, and ``gate_s``)."""
        if self._in_statement:
            yield
            return
        if tables is not None:
            tables = {t for t in tables if not t.startswith(TEMP_PREFIX)}
        waits: dict = {}
        with self._nonlane_scope(tables, waits):
            t0 = time.perf_counter()
            with self._gate(shared):
                waits["gate_s"] = time.perf_counter() - t0
                self._scope_waits = waits
                try:
                    yield
                finally:
                    self._scope_waits = {}

    @contextlib.contextmanager
    def _inner(self):
        """A statement run for another (a subquery, a temp's body): its
        route goes into ``last_exec["all"]`` only."""
        self._nested += 1
        try:
            yield
        finally:
            self._nested -= 1

    def _note_route(self, prep, route: dict) -> None:
        """Record one run of a prepared plan: the outer statement's runs
        set ``last_exec``'s own keys, every run adds to its totals."""
        le = self.last_exec
        compacts = _count_nodes(prep.node, P.Compact)
        tot = le["all"]
        tot["runs"] += 1
        tot["compact_nodes"] += compacts
        for k in ("compacts_applied", "topk_cuts", "group_ids"):
            tot[k] += route[k]
        tot["expansions"].extend(route["expansions"])
        if self._nested == 0:
            le.update(route)
            le["compact_nodes"] = compacts
            self._last_plan = prep.node

    def _note_replan(self, flag: str) -> None:
        self.last_exec["all"]["replans"].append(flag)
        if self._nested == 0:
            self.last_exec["replans"].append(flag)

    # -- SELECT --------------------------------------------------------------
    def prepare(self, sql: str, session: Session | None = None):
        """Prepare a SELECT for repeated execution (the pgwire prepared
        statement). Returns a ``Prepared``; a set operation, or a
        statement with CTEs or derived tables (including those
        decorrelation introduces), which materializes temps per
        execution, gets a re-execute handle (stmtutil.RerunPrepared)
        instead, which composes a CTE statement's later runs on the
        device (exec/ctecompose.py)."""
        session = session or self.session()
        stmt = parser.parse(sql)
        if isinstance(stmt, ast.SetOp):
            # the branches run as statements and merge on the host
            return RerunPrepared(self, session, stmt, sql)
        if not isinstance(stmt, ast.Select):
            raise EngineError("can only prepare SELECTs")
        stmt = self._expand_views(stmt)
        sel = stmt
        if not (stmt.ctes or self._has_derived(stmt)):
            sel = self._decorrelate(stmt)
        if sel.ctes or self._has_derived(sel):
            return RerunPrepared(self, session, stmt, sql)
        if sel.table is None:
            raise EngineError("can only prepare table-reading SELECTs")
        with self._statement():
            return self._prepare_select(sel, session, sql)

    def _exec_select(self, sel, session: Session,
                     sql_text: str) -> Result:
        """Run one SELECT or set operation: decorrelate, materialize
        CTEs and derived tables into temps, then prepare and run (the
        reference's ``_exec_select``; its re-runs live in
        Prepared.run)."""
        if isinstance(sel, ast.SetOp):
            return self._exec_setop(sel, session, sql_text)
        sel = self._decorrelate(self._expand_views(sel))
        if sel.ctes or self._has_derived(sel):
            return self._exec_with_temps(sel, session, sql_text)
        if sel.table is None:
            return self._exec_table_free(sel, session)
        match = self._index_fastpath_match(sel, session)
        if match is not None:
            res = self._exec_index_fastpath(sel, session, match)
            if res is not None:
                self.metrics.counter(
                    "sql.select.index_fastpath",
                    "SELECTs served by the primary-key point-read "
                    "path").inc()
                return res
        rmatch = self._range_fastpath_match(sel, session)
        if rmatch is not None:
            res = self._exec_range_fastpath(sel, session, rmatch)
            if res is not None:
                self.metrics.counter(
                    "sql.select.range_fastpath",
                    "SELECTs served by the ordered primary-key range "
                    "path").inc()
                return res
        return self._prepare_select(sel, session, sql_text).run()

    # -- set operations ------------------------------------------------------
    def _exec_setop(self, so: ast.SetOp, session: Session,
                    sql_text: str) -> Result:
        """UNION / INTERSECT / EXCEPT [ALL]: both branches run as
        ordinary statements on the card, and the combine is a host
        multiset merge over their decoded rows, as in the reference (and
        its setOpNode, sql/union.go). NULLs compare equal in the merge
        (rows are tuples; None == None); numeric branch types unify as
        expression arithmetic would."""
        if so.ctes:
            # WITH over a set op: the CTEs materialize into temps, then
            # both branches read them
            return self._exec_with_temps(so, session, sql_text)
        with self._inner():
            left = self._exec_select(so.left, session,
                                     f"(setop-l {so.left!r})")
            right = self._exec_select(so.right, session,
                                      f"(setop-r {so.right!r})")
        if len(left.names) != len(right.names):
            raise EngineError(
                f"each {so.op.upper()} branch must have the same number "
                f"of columns ({len(left.names)} vs {len(right.names)})")
        numeric = (Family.INT, Family.FLOAT, Family.DECIMAL)
        out_types = list(left.types)
        coerce_cols = {}  # column index -> unified SQLType
        for i, (lt, rt) in enumerate(zip(left.types, right.types)):
            if lt.family == rt.family or \
                    "unknown" in (lt.family.value, rt.family.value):
                continue
            if lt.family in numeric and rt.family in numeric:
                ut = common_numeric_type(lt, rt)
                out_types[i] = coerce_cols[i] = ut
                continue
            raise EngineError(
                f"{so.op.upper()} branch column types do not match: "
                f"{lt} vs {rt}")
        lrows, rrows = list(left.rows), list(right.rows)
        if coerce_cols:
            lrows = _unify_rows(lrows, coerce_cols)
            rrows = _unify_rows(rrows, coerce_cols)
        if so.op == "union":
            rows = lrows + rrows
            if not so.all:
                rows = list(dict.fromkeys(rows))
        elif so.all:
            # INTERSECT ALL keeps min(l, r) copies of a row, EXCEPT ALL
            # max(l - r, 0)
            rc = Counter(rrows)
            rows = []
            for r in lrows:
                hit = rc[r] > 0
                if hit:
                    rc[r] -= 1
                if hit == (so.op == "intersect"):
                    rows.append(r)
        else:
            rset = set(rrows)
            keep = so.op == "intersect"
            rows = list(dict.fromkeys(r for r in lrows
                                      if (r in rset) == keep))
        if so.order_by:
            rows = _sort_decoded(rows, left.names, so.order_by)
        rows = _cut(rows, so.limit, so.offset)
        return Result(names=list(left.names), rows=rows, types=out_types)

    # -- table-free SELECT ----------------------------------------------------
    def _exec_table_free(self, sel: ast.Select, session: Session) -> Result:
        """SELECT <exprs> with no FROM: one row, with SQL's answers for
        the clauses. A constant WHERE or HAVING that is not TRUE leaves
        no row (the reference ignores both and always returns one);
        GROUP BY over the one row keeps one group; ORDER BY has one row
        to order; LIMIT and OFFSET cut it. What the binder folds (the
        sequence builtins, literals, constant arithmetic) is taken as
        folded; other expressions run over a one-row batch.
        ``generate_series`` and ``unnest`` in the select list are the
        set-returning forms (``_maybe_generate_series``)."""
        binder = Binder(Scope(), sequence_ops=self._sequence_ops(session),
                        subquery_eval=lambda s, lim: self._eval_subquery(
                            s, session, lim),
                        now_micros=self._read_ts(session).wall // 1000)
        srf = self._maybe_generate_series(sel, binder)
        if srf is not None:
            return srf
        names, row, types = [], [], []
        for it in sel.items:
            if it.star:
                raise EngineError("SELECT * requires FROM")
            b = binder.bind(it.expr)
            names.append(it.alias or "column")
            row.append(self._table_free_value(b))
            types.append(b.type)
        keep = all(self._table_free_value(binder.bind(c)) is True
                   for c in (sel.where, sel.having) if c is not None)
        rows = _cut([tuple(row)] if keep else [], sel.limit, sel.offset)
        return Result(names=names, rows=rows, types=types)

    def _table_free_value(self, b):
        """The client value of a bound expression over the one row."""
        if isinstance(b, BConst):
            return (decode_scalar(b.value, b.value is not None, b.type,
                                  None)
                    if not isinstance(b.value, str) else b.value)
        d, v = compile_expr(b)(ExprContext({}, 1, self.device))
        # graftlint: waive[no-aliasing-upload] the compiled expression's
        # result over no columns (a tensor, or a Python scalar for a
        # constant), only read
        d = torch.as_tensor(d).reshape(-1)[:1]
        # graftlint: waive[no-aliasing-upload] as for d above
        v = torch.as_tensor(v).reshape(-1)[:1]
        return decode_scalar(d.cpu().numpy()[0], bool(v.cpu().numpy()[0]),
                             b.type, None)

    def _maybe_generate_series(self, sel: ast.Select, binder: Binder):
        """SELECT generate_series(a, b [, step]) and SELECT
        unnest(ARRAY[...]): the set-returning functions of a table-free
        select list (FROM generate_series(...) desugars to this as a
        derived table, sql/parser.py). Arguments fold to constants;
        ORDER BY, LIMIT and OFFSET apply, and WHERE or GROUP BY go
        through a CTE, as in the reference."""
        if len(sel.items) != 1 or sel.items[0].star:
            return None
        e = sel.items[0].expr
        if not (isinstance(e, ast.FuncCall)
                and e.name in ("generate_series", "unnest")):
            return None
        if sel.where is not None or sel.distinct or sel.group_by \
                or sel.having:
            raise EngineError(
                f"{e.name} supports only ORDER BY/LIMIT/OFFSET "
                "(materialize it in a CTE for WHERE/GROUP BY)")
        name = sel.items[0].alias or e.name
        if e.name == "unnest":
            rows, ty = self._unnest_rows(e, binder)
        else:
            if len(e.args) not in (2, 3):
                raise EngineError("generate_series(start, stop [, step])")
            vals = []
            for a in e.args:
                b = binder.bind(a)
                if not isinstance(b, BConst) or b.value is None:
                    raise EngineError(
                        "generate_series arguments must be constants")
                vals.append(int(b.value))
            start, stop = vals[0], vals[1]
            step = vals[2] if len(vals) == 3 else 1
            if step == 0:
                raise EngineError("generate_series step cannot be 0")
            rows = [(int(v),) for v in
                    range(start, stop + (1 if step > 0 else -1), step)]
            ty = INT8
        if sel.order_by:
            rows = _sort_decoded(rows, [name], sel.order_by)
        return Result(names=[name], rows=_cut(rows, sel.limit, sel.offset),
                      types=[ty])

    @staticmethod
    def _unnest_rows(e: ast.FuncCall, binder: Binder) -> tuple:
        """(rows, element type) of unnest over a constant array."""
        from ..sql import datum as dtm
        if len(e.args) != 1:
            raise EngineError("unnest(array)")
        b = binder.bind(e.args[0])
        if not isinstance(b, BConst):
            raise EngineError("unnest over columns is not supported "
                              "(constant arrays only)")
        elem = b.type.elem if b.type.family == Family.ARRAY else b.type
        if b.value is None:
            return [], elem
        if b.type.family != Family.ARRAY:
            raise EngineError("unnest needs an array argument")
        return [(v,) for v in dtm.parse_array(b.value, b.type.elem)], elem

    def _exec_params(self, session: Session, no_topk: bool) -> ExecParams:
        sortn = str(session.vars.get("sort_normalized", "auto")).lower()
        return ExecParams(
            pallas_groupagg=str(session.vars.get("pallas_groupagg",
                                                 "auto")).lower(),
            hash_group_capacity=_capacity(
                session.vars.get("hash_group_capacity", 1 << 17)),
            topk_sort=not no_topk,
            sort_normalized=sortn if sortn in _MODES else "off")

    def _autotune_mode(self, session: Session) -> str:
        """Kernel 1's launch-point autotune mode: the session variable
        ``pallas_autotune`` over the cluster setting
        ``sql.exec.pallas.autotune`` (ops/cuda/autotune.py)."""
        mode = session.vars.get("pallas_autotune", None)
        if mode is None:
            mode = self.settings.get("sql.exec.pallas.autotune")
        mode = str(mode).lower()
        if mode not in autotune.MODES:
            raise EngineError(f"pallas_autotune = {mode} is not a mode "
                              "(auto, on, off)")
        return mode

    def _on_exec_miss(self, session: Session, params: ExecParams,
                      sql_text: str, bucket: int) -> ExecParams:
        """An exec-cache miss: journal the statement for a restarted
        process's prewarm (with its paged bucket and the plan-changing
        session variables it ran under, non-default ones only), and give
        the plan kernel 1's launch point and the paths the parity gate
        promoted on this card. Both are performance-only, bit-identical
        under the gate's proof, so neither is in the exec-cache key."""
        jvars = {}
        if params.hash_group_capacity != 1 << 17:
            jvars["hash_group_capacity"] = params.hash_group_capacity
        if params.pallas_groupagg != "auto":
            jvars["pallas_groupagg"] = params.pallas_groupagg
        if params.sort_normalized != "auto":
            jvars["sort_normalized"] = params.sort_normalized
        coldstart.journal_record(self._compile_cache_dir, sql_text,
                                 bucket=bucket, vars=jvars)
        mode = params.pallas_groupagg
        if mode == "off":
            return params
        params.pallas_point = autotune.params_for(
            self._device_key, self._compile_cache_dir,
            self._autotune_mode(session), self.device)
        if mode == "auto":
            params.pallas_exact_paths = paritygate.promoted(
                self._device_key, self._compile_cache_dir, self.device,
                params.pallas_point)
        return params

    # the session variables a journal entry may replay into a prewarm
    # session: exactly the plan-changing ones _on_exec_miss journals
    _PREWARM_VARS = ("hash_group_capacity", "pallas_groupagg",
                     "sort_normalized")

    def prewarm(self, top_k: int | None = None) -> int:
        """Re-prepare the top-K statements of the previous run's shapes
        journal (exec/coldstart.py) so their tables are uploaded, their
        plans built and their kernel libraries loaded before the first
        user statement (``top_k`` defaults to the setting
        sql.exec.compile_cache.prewarm, 0 = off). Call it after the data
        is loaded. A resident statement runs once, its result decoded
        and dropped; a paged one warms without reading its data
        (Prepared.warm). A statement that cannot be prepared (its table
        is gone, say) is counted in exec.compile.prewarm_errors and
        logged; a kernel build or launch error raises. Returns the
        number of statements warmed."""
        if top_k is None:
            top_k = int(self.settings.get("sql.exec.compile_cache.prewarm"))
        if not top_k or not self._compile_cache_dir:
            return 0
        warmed = 0
        for sql, bucket, jvars in coldstart.journal_entries(
                self._compile_cache_dir, top_k):
            session = self.session()
            for name, val in jvars.items():
                if name in self._PREWARM_VARS:
                    session.vars.set(name, val)
            if bucket:
                session.vars.set("streaming_page_rows", bucket)
            try:
                prep = self.prepare(sql, session)
                if isinstance(prep, RerunPrepared):
                    pass  # its temps are made anew by every run
                elif prep.stream is not None or prep.spill is not None:
                    prep.warm(bucket)
                else:
                    # the whole run, result decode included: a bare
                    # dispatch leaves the decode's first-use work on the
                    # card to the first user statement
                    prep.run()
            except (EngineError, PlanError, BindError, ParseError) as e:
                # the statement no longer plans here; a kernel's build
                # or launch error is none of these and raises
                coldstart.note_prewarmed(False)
                log.warning(log.SQL_EXEC, "prewarm of %r failed: %s",
                            sql, e)
                continue
            warmed += 1
            coldstart.note_prewarmed(True)
        return warmed

    def _prepare_select(self, sel: ast.Select, session: Session,
                        sql_text: str, no_topk: bool = False,
                        no_compact: bool = False,
                        no_memo: bool = False,
                        no_dist: bool = False) -> Prepared:
        """Plan, place, check, upload and compile one SELECT into a
        Prepared.

        Uncorrelated subqueries run while the binder plans (their rows
        become constants), and the tables they read join this plan's
        generation set. The placement verdict follows the reference's
        order: spill (join, then sort) before stream before resident
        (exec/scanplane.py). A streamed or spilled table is not
        uploaded whole, and its cached resident copy is released. The
        compiled plan comes from the exec cache, keyed as the
        reference keys it: the statement text, the scans' padded row
        counts (a streamed scan's page rows) and dictionary sizes, the
        verdict, the session variables that change the compiled plan,
        the plan fingerprint (a subquery's inlined constant changes
        it), the replan flags and, unlike the reference's key, the
        generation of every table read (_cache_gens).

        Inside an open txn with writes, the tables it wrote read an
        overlay of committed chunks and its buffered effects, uploaded
        for this statement alone (never cached, never paged), at the
        txn's read timestamp.

        AS OF SYSTEM TIME sets the read timestamp of the whole
        preparation (the plan's checks, the handle's runs) and is
        refused below a scanned table's GC threshold; the timestamp is
        a runtime argument of the compiled plan, never part of its
        exec-cache key.

        On a mesh the distribution decision comes first, as in the
        reference (distributed > spill > stream > resident): a
        distributed plan's probe-spine tables upload sharded over the
        mesh and its build sides replicated, and it compiles behind a
        _DistRouter. A distributed upload past the budget re-prepares
        on one device (``no_dist``), where the spill and stream tiers
        page the same mergeable partials."""
        as_of = self._as_of_ts(sel, session)
        read_ts = as_of or self._read_ts(session)
        sink: set = set()
        self._gen_sinks.append(sink)
        try:
            with self.tracer.span("plan"):
                node, meta = self._plan(sel, session, read_ts,
                                        no_memo=no_memo)
        finally:
            self._gen_sinks.pop()
        scan_aliases, scan_cols = scan_maps(node)
        overlay = {t: n for t, n in self._overlay_puts(session).items()
                   if t in scan_aliases.values()}
        # an overlay's tables stay on one device, as in the reference
        decision = (None if overlay or no_dist else
                    self._dist_decision(node, session))
        spill = (None if overlay or decision is not None else
                 self._spill_decision(node, scan_aliases, scan_cols,
                                      session, meta))
        stream = (None if spill is not None or overlay
                  or decision is not None else
                  self._stream_decision(node, scan_aliases, scan_cols,
                                        session))
        paged = {stream[0]} if stream is not None else set()
        if spill is not None:
            paged = {spill.alias, spill.build_alias} - {""}
        try:
            self._check_join_builds(node, read_ts, overlay)
        except EngineError:
            # the memo's join order may have put the duplicate-heavy
            # side on the build side: the greedy order may not
            if meta.memo is not None and not no_memo:
                return self._prepare_select(sel, session, sql_text,
                                            no_topk=no_topk,
                                            no_compact=no_compact,
                                            no_memo=True, no_dist=no_dist)
            raise
        self._bound_agg_group_rows(node, read_ts, overlay)
        if not no_compact and not paged and not self._analyzing \
                and decision is None:
            # selection compaction is gated off under paging (its
            # sentinel cannot ride the page state), in an analyzed run
            # (EXPLAIN ANALYZE renders the planner's plan) and on a mesh
            # (the reference's rule: its sentinel would need merging
            # across the shards)
            node = self._insert_compaction(node)
        scans, gens, shapes = {}, sink, []
        resident = {t for a, t in scan_aliases.items() if a not in paged}
        # a distributed plan records how each scan resolves against any
        # target mesh, and the working set the router sizes sub-meshes
        # by (post-filter estimates: a selective scan's bytes mostly die
        # at its filter)
        upload_spec = []
        sharded_bytes = repl_bytes = 0
        for alias, tname in scan_aliases.items():
            if as_of is not None:
                self._check_gc_threshold(tname, as_of)
            # the read enters the timestamp cache (and an open txn's
            # refresh set): a conflicting writer is pushed above it
            self._register_table_read(session.txn, tname, read_ts)
            cols = scan_cols[alias]
            td = self.store.table(tname)
            if tname in overlay:
                # generation -1: every run re-prepares and re-uploads
                b = self._batch_from_chunks(
                    td, self._overlay_chunks(tname, session.effects,
                                             read_ts), cols)
                gens.add((tname, -1))
                scans[alias] = b
                shapes.append((tname, b.n, tuple(sorted(
                    (cn, len(d)) for cn, d in td.dictionaries.items()))))
                continue
            dl = tuple(sorted((cn, len(d))
                              for cn, d in td.dictionaries.items()))
            gens.add((tname, td.generation))
            if alias in paged:
                # never uploaded whole, and its resident copy goes (so
                # streaming saves the memory); the shape is the page
                # size (0 for a spill, whose verdict is in the key)
                if tname not in resident:
                    self._evict_device(tname)
                shapes.append((tname, stream[2] if stream is not None
                               else 0, dl))
                continue
            if decision is not None:
                placement = (meshmod.shard_spec()
                             if alias in decision.sharded
                             else meshmod.replicated_spec())
                try:
                    b = self._device_table(tname, cols, placement)
                except MemoryQuotaError:
                    # a shard working set past the budget: one device,
                    # where the spill and stream tiers take it
                    self.movement.m_spill_fallbacks.inc()
                    return self._prepare_select(
                        sel, session, sql_text, no_topk=no_topk,
                        no_compact=no_compact, no_memo=no_memo,
                        no_dist=True)
                upload_spec.append((alias, tname, placement, cols))
                nb = int(self._table_device_bytes(td, cols)
                         * self._scan_survival_frac(node, alias, tname))
                if placement == meshmod.shard_spec():
                    sharded_bytes += nb
                else:
                    repl_bytes += nb
                scans[alias] = b
                shapes.append((tname, b.n, dl))
                continue
            b = self._maybe_pruned_upload(node, alias, tname, cols)
            if b is None:
                b = self._device_table(tname, cols)
            scans[alias] = b
            shapes.append((tname, b.n, dl))
        # a subquery's temps are dropped when it returns: the base
        # tables behind them joined the sets when the temps were built
        for outer in self._gen_sinks:
            outer.update(g for g in gens if not g[0].startswith(TEMP_PREFIX))
        params = self._exec_params(session, no_topk)
        if decision is not None:
            params.axis_name, params.n_shards = AXIS, self.mesh.size
        cgens = self._cache_gens(gens)
        # statement-shape plan cache: filter literals leave the plan as
        # run parameters, so literal-varying statements of one shape
        # share a compiled plan (the reference's gate: not under stream,
        # spill, an overlay or CTE capture, nor plan_shape_cache = off;
        # an analyzed run renders the planner's plan, so it keeps its
        # literals too)
        pvals: tuple = ()
        psc = str(session.vars.get("plan_shape_cache", "auto")).lower()
        if psc != "off" and stream is None and spill is None \
                and not overlay and self._cte_capture is None \
                and not self._analyzing:
            pnode, vals = parameterize(node)
            if vals is not None:
                node, pvals = pnode, vals
        if pvals:
            # the literals left the plan, so they leave the key's text;
            # the structural fingerprint rejects a literal that changed
            # the plan's shape (a LIMIT, a re-ordered join)
            keytext, plan_fp = shape_text(sql_text), plan_fingerprint(node)
        else:
            # a subquery's inlined constant changes the fingerprint
            keytext, plan_fp = sql_text, hash(repr(node))
        key = (keytext, tuple(sorted(shapes)), cgens, stream, spill,
               params.hash_group_capacity, params.pallas_groupagg,
               params.sort_normalized, plan_fp, no_topk, no_compact,
               tuple(str(v.dtype) for v in pvals), decision is not None)
        journal = (sql_text, stream[2] if stream is not None
                   else spill.page_rows if spill is not None else 0)
        if spill is not None and spill.kind == "sort":
            compile_fn = compile_spill_sort
        elif stream is not None or spill is not None:
            # the spill join probes with the unchanged streaming page
            # program: each probe row lands in exactly one (partition,
            # page), so the page-partial algebra is exact over the sweep
            compile_fn = compile_streaming
        elif decision is not None:
            def compile_fn(node, params, meta):
                router = _DistRouter(self, node, meta, dict(scan_aliases),
                                     params, upload_spec, sharded_bytes,
                                     repl_bytes)
                # the full mesh's plan now, inside this plan build
                router._runf_for(self.mesh.size)
                return router
        else:
            compile_fn = compile_plan
        runf, meta, node = self._compiled(
            key, cgens, node, params, meta, compile_fn,
            miss=lambda: self._on_exec_miss(session, params, *journal))
        p_alias = spill.alias if spill is not None else (
            stream[0] if stream is not None else None)
        # zone checks of the paged scan's pushed-down predicates (the
        # spill join's probe skips none: every probe row belongs to
        # one partition whatever the predicate says); join-filter specs
        # over this plan, summarized per dispatch
        stream_zone = ()
        if stream is not None or (spill is not None
                                  and spill.kind == "sort"):
            stream_zone = extract_zone_preds(node, p_alias)
        jf_specs = ()
        if stream is not None or (spill is not None
                                  and spill.kind == "join"):
            jf_specs = find_specs(node, p_alias, self.store)
        prep = Prepared(
            self, session, sel, sql_text, runf, scans, meta,
            tuple(sorted(gens)), node, no_topk=no_topk,
            no_compact=no_compact, stream=stream,
            stream_cols=scan_cols.get(p_alias) if p_alias else None,
            stream_zone=stream_zone, spill=spill,
            spill_cols=(scan_cols.get(spill.build_alias)
                        if spill is not None and spill.build_alias
                        else None),
            joinfilter=jf_specs, placement=self._placement_key(session),
            scan_tables=dict(scan_aliases), as_of=as_of,
            params=run_values(pvals), decision=decision)
        cap = self._cte_capture
        if cap is not None and cap["want_main"] and not cap["disabled"]:
            # the last preparation after the temps is the main plan
            cap["preps"].append(prep)
        return prep

    # compiled plans and parses kept: at the cap the oldest half goes
    # (exec/tenantcache.py, as the reference's); an exec-cache hit
    # counts as new
    EXEC_CACHE_MAX = 512
    PARSE_CACHE_MAX = 4096

    def _cache_gens(self, gens) -> tuple:
        """The exec-cache key's part for the tables a plan reads:
        (table, committed generation, read through an overlay) for each,
        so a run after any write misses. Generations come from the
        store's one counter, so a hit never returns the plan or the
        dictionaries (meta) of a dropped or truncated table. A
        statement's temps are left out: they are made anew by every
        execution, from the base tables named here."""
        out = set()
        for t, g in gens:
            if t.startswith(TEMP_PREFIX):
                continue
            if g < 0:
                out.add((t, self.store.table(t).generation, True))
            else:
                out.add((t, g, False))
        return tuple(sorted(out))

    def _compiled(self, key, cgens: tuple, node, params: ExecParams,
                  meta, compile_fn=compile_plan, miss=None):
        """(compiled plan, meta, plan node) from the exec cache, or
        compiled now with ``compile_fn`` (compile_plan,
        compile_streaming or compile_spill_sort). A hit returns the plan
        node the entry was compiled from (the key's plan fingerprint
        makes it equal to ``node``): the fine profile plane keys its
        operators by that node's identity. ``key`` holds ``cgens``
        (_cache_gens); a miss drops the entries that read one of these
        tables at an older generation, which no later run can hit.
        ``miss()``, on a miss, gives the ExecParams to compile with."""
        with self._cache_lock:
            hit = self._exec_cache.get(key)
            if hit is not None:
                self.plan_cache["hit"] += 1
                self._exec_cache.touch(key)
        self.tracer.tag(plan_cache="hit" if hit is not None else "miss")
        self.metrics.counter(
            "sql.plan.cache.hit" if hit is not None
            else "sql.plan.cache.miss",
            "compiled-plan cache lookups, by outcome").inc()
        if hit is not None:
            return hit[0], hit[1], hit[3]
        with self._cache_lock:
            self.plan_cache["miss"] += 1
        if miss is not None:
            params = miss()
        try:
            with self.tracer.span("compile"), coldstart.plan_build():
                runf = compile_fn(node, params, meta)
        except ExecError as e:
            raise EngineError(str(e)) from e
        now = {t: g for t, g, _ in cgens}
        with self._cache_lock:
            for k in [k for k, v in self._exec_cache.items()
                      if any(now.get(t, g) != g for t, g, _ in v[2])]:
                del self._exec_cache[k]
            self._exec_cache.put(key, (runf, meta, cgens, node),
                                 getattr(self._tenant_tl, "value", ""))
        return runf, meta, node

    # -- subqueries, derived tables, CTEs -------------------------------------
    def _eval_subquery(self, sel: ast.Select, session: Session,
                       limit_one: bool = False):
        """Execute an uncorrelated expression subquery before the main
        statement and hand (rows, types) back to the binder, which
        inlines them as constants."""
        if limit_one and sel.limit is None:
            sel = copy.copy(sel)
            sel.limit = 1   # EXISTS needs one row, not the result set
        with self._inner():
            res = self._exec_select(sel, session, f"(subquery {sel!r})")
        self.last_exec["subqueries"] += 1
        return res.rows, res.types

    def _decorrelate(self, sel: ast.Select) -> ast.Select:
        """Unnest correlated (NOT) EXISTS and correlated scalar
        subqueries into grouped LEFT JOINs against derived tables
        (sql/decorrelate.py)."""

        def columns_of(name):
            if name not in self.store.tables:
                return None
            return set(self.store.table(name).schema.column_names)

        def is_string_col(table, col):
            try:
                sch = self.store.table(table).schema
                return sch.column(col).type.uses_dictionary
            except KeyError:
                return True   # unknown: refuse the min/max trick
        sel = decorrelate_exists(sel, columns_of, is_string_col)
        return decorrelate_scalar(sel, columns_of)

    @staticmethod
    def _has_derived(sel: ast.Select) -> bool:
        refs = ([sel.table] if sel.table is not None else []) + \
            [j.table for j in sel.joins]
        return any(r.subquery is not None for r in refs)

    def _exec_with_temps(self, sel, session: Session,
                         sql_text: str) -> Result:
        """WITH ctes / FROM (SELECT ...): materialize each into a temp
        table, rewrite the references, run the main query (or both
        branches of a set operation), drop the temps and evict their
        device copies. A composing CTE handle's slow run records what
        it composes from here (``_cte_capture``)."""
        # a DEEP copy: the rewrites below assign into nested JoinClause
        # and TableRef objects of the caller's AST, which a prepared
        # handle runs again
        sel = copy.deepcopy(sel)
        temps: list[str] = []
        mapping: dict[str, str] = {}
        # stable temp names, so re-executions of one statement produce
        # the same names and the main query's cache keys hit: the
        # session separates concurrent sessions, the depth a CTE body
        # that re-enters this path
        depth = self._cte_depth.get(id(session), 0)
        self._cte_depth[id(session)] = depth + 1
        cap = self._cte_capture
        if cap is not None and depth > 0:
            # a nested CTE body re-enters here: the composition models
            # one level, so such statements keep the slow path
            cap["disabled"] = True
        prefix = f"{TEMP_PREFIX}{id(session):x}_d{depth}"
        seq = [0]

        def tname_of(name: str) -> str:
            seq[0] += 1
            return f"{prefix}_{seq[0]}_{name}"

        try:
            for name, cols, sub in sel.ctes:
                sub = propagate_as_of(rewrite_table_names(sub, mapping),
                                      sel)
                tname = tname_of(name)
                temps.append(tname)
                self._materialize_temp_select(tname, sub, session, cols,
                                              f"(cte {sub!r})")
                mapping[name] = tname
            sel.ctes = []
            if isinstance(sel, ast.SetOp):
                if cap is not None:
                    cap["disabled"] = True   # a host merge: no main plan
                return self._exec_setop(
                    rewrite_table_names(sel, mapping), session, sql_text)
            refs = ([("table", sel.table)] if sel.table is not None
                    else []) + [("join", j) for j in sel.joins]
            for kind, obj in refs:
                ref = obj if kind == "table" else obj.table
                if ref.subquery is None:
                    continue
                sub = propagate_as_of(
                    rewrite_table_names(ref.subquery, mapping), sel)
                tname = tname_of(ref.alias)
                temps.append(tname)
                self._materialize_temp_select(tname, sub, session, None,
                                              f"(derived {sub!r})")
                newref = ast.TableRef(tname, ref.alias)
                if kind == "table":
                    sel.table = newref
                else:
                    obj.table = newref
            sel = rewrite_table_names(sel, mapping)
            if cap is not None and depth == 0:
                # the next preparation at this depth is the main plan
                cap["want_main"] = True
            return self._exec_select(sel, session, sql_text)
        finally:
            if depth:
                self._cte_depth[id(session)] = depth
            else:
                self._cte_depth.pop(id(session), None)
            for t in temps:
                if t in self.store.tables:
                    self.store.drop_table(t)
                self._evict_device(t)

    # -- composed CTE capture (exec/ctecompose.py) ---------------------------
    def _begin_cte_capture(self, stmt, session: Session) -> bool:
        """Start recording, on this thread, what a composing CTE
        handle's slow run composes from: its columnar temps (their
        bodies' Prepared plans and shapes) and its main Prepared plan.
        Only a SELECT outside a txn, on an engine without a mesh,
        composes."""
        if not isinstance(stmt, ast.Select) or session.txn is not None \
                or session.effects:
            return False
        if self.mesh is not None and self.mesh.size > 1:
            # the reference's rule: composition stays off on a mesh
            return False
        self._cte_capture = {"temps": [], "preps": [], "disabled": False,
                             "want_main": False}
        return True

    def _end_cte_capture(self):
        cap, self._cte_capture = self._cte_capture, None
        return cap

    def _materialize_temp_select(self, tname: str, sub: ast.Select,
                                 session: Session, rename,
                                 sql_text: str) -> None:
        """Materialize a CTE or derived-table SELECT into a temp table.

        Columnar path: run the compiled plan and ingest its output
        columns as they are, already in storage-physical form
        (scaled-int DECIMAL, day-number DATE, dictionary codes with the
        plan's dictionary), so no value goes through a Python decode
        and encode (the reference measured ~18 s that way for Q9's
        derived table at SF1, ~0.1 s columnar). A hash GROUP BY past
        capacity ingests its partitions' columns. Nested CTEs and
        shapes the columnar path cannot serve take the decoded-row
        path. ``last_exec["temps"]`` gets [name, rows, "columnar" or
        "rows"]."""
        try:
            if isinstance(sub, ast.SetOp):
                raise _RowPath("set operations merge on the host")
            if sub.ctes:
                raise _RowPath("nested CTEs take the row path")
            sub = self._decorrelate(self._expand_views(sub))
            if sub.ctes or self._has_derived(sub):
                raise _RowPath("derived tables take the row path")
            with self._inner():
                prep = self._prepare_select(sub, session, sql_text)
                if prep.spill is not None and prep.spill.kind == "sort":
                    raise _RowPath("a spilled sort merges on the host")
                try:
                    pulled = pull_batch_columns(prep.checked(),
                                                list(prep.meta.names))
                except HashCapacityExceeded:
                    if isinstance(prep.node, (P.Sort, P.Limit)):
                        # the partitions' rows need a host sort
                        raise _RowPath("a sorted partitioned result "
                                       "takes the row path") from None
                    pulled = self._partitioned_columns(prep, None)[0]
                    if self._cte_capture is not None:
                        # one run of the body's plan overflows: nothing
                        # to compose
                        self._cte_capture["disabled"] = True
            meta = prep.meta
            names = _temp_names(meta.names, rename, tname)
            cols: dict[str, np.ndarray] = {}
            valid: dict[str, np.ndarray] = {}
            for cname, oname, ty in zip(names, meta.names, meta.types):
                arr, v = pulled[oname]
                if ty.uses_dictionary:
                    d = meta.dictionaries.get(oname)
                    if d is None:
                        raise _RowPath("an undictionaried string "
                                       "takes the row path")
                    arr = np.clip(arr.astype(np.int32), 0,
                                  max(len(d.values) - 1, 0))
                cols[cname] = arr
                valid[cname] = v
            self._create_temp(tname, names, meta.types)
            for cname, oname, ty in zip(names, meta.names, meta.types):
                if ty.uses_dictionary:
                    self.store.set_dictionary(
                        tname, cname, list(meta.dictionaries[oname].values))
            n = len(next(iter(cols.values()))) if cols else 0
            if n:
                # temps ingest at wall 1, visible at any read timestamp
                self.store.insert_columns(tname, cols, Timestamp(1, 0),
                                          valid=valid)
            self.last_exec["temps"].append([tname, n, "columnar"])
            cap = self._cte_capture
            if cap is not None and not cap["disabled"]:
                cap["temps"].append({"tname": tname, "prep": prep,
                                     "meta": meta, "names": names,
                                     "rows": n})
            return
        except (EngineError, PlanError) as e:
            if tname in self.store.tables:
                self.store.drop_table(tname)
            # the row path re-plans with its own re-runs (a compaction
            # that overflowed inside a partitioned run, a GROUP BY whose
            # plan cannot be partitioned); a SUM overflow is an error
            if not isinstance(e, (_RowPath, PlanError, HashCapacityExceeded,
                                  CompactOverflow)):
                raise
        if self._cte_capture is not None:
            self._cte_capture["disabled"] = True   # a row-path temp
        with self._inner():
            res = self._exec_select(sub, session, sql_text)
        self._materialize_temp(tname, res, rename)
        self.last_exec["temps"].append([tname, len(res.rows), "rows"])

    def _create_temp(self, tname: str, names: list, types: list) -> None:
        schema = TableSchema(
            name=tname,
            columns=[ColumnSchema(n, t, True) for n, t in zip(names, types)],
            primary_key=[], table_id=self.store.alloc_table_id())
        for i, cs in enumerate(schema.columns):
            cs.cid = i + 1
        self.store.create_table(schema)

    def _materialize_temp(self, tname: str, res: Result,
                          rename: list | None) -> None:
        """Create a temp table from a decoded Result (the row path)."""
        names = _temp_names(res.names, rename, tname)
        if not res.types:
            raise EngineError("subquery produced no column types")
        self._create_temp(tname, names, res.types)
        if not res.rows:
            return
        cols: dict[str, np.ndarray] = {}
        valid: dict[str, np.ndarray] = {}
        for i, (cname, ty) in enumerate(zip(names, res.types)):
            vals = [r[i] for r in res.rows]
            valid[cname] = np.array([x is not None for x in vals],
                                    dtype=bool)
            f = ty.family
            if f == Family.STRING:
                arr = np.array([x if x is not None else "" for x in vals],
                               dtype=object)
            elif f == Family.DATE:
                arr = np.array([(x - EPOCH_DATE).days if x is not None
                                else 0 for x in vals], dtype=np.int64)
            elif f == Family.TIMESTAMP:
                arr = np.array([(x - EPOCH_DT) // datetime.timedelta(
                    microseconds=1) if x is not None else 0
                    for x in vals], dtype=np.int64)
            else:
                # DECIMAL floats are rescaled by insert_columns
                arr = np.array([x if x is not None else 0 for x in vals],
                               dtype=np.float64 if f == Family.DECIMAL
                               else ty.np_dtype)
            cols[cname] = arr
        self.store.insert_columns(tname, cols, Timestamp(1, 0),
                                  valid=valid)

    # -- partitioned hash GROUP BY ---------------------------------------------
    # level-1 fan-out ceiling; past it a partition subdivides under a
    # rotated salt (ops/hashtable.py partition_mask)
    MAX_SPILL_PARTITIONS = hashtable.PARTITION_L1

    def _partitioned_columns(self, prep: Prepared, read_ts):
        """Re-run a hash GROUP BY that overflowed ``hash_group_capacity``
        partition by partition (the reference's ``_run_partitioned``).

        The plan without its top Sort/Limit (a per-partition limit would
        cut wrongly) runs once per partition: each run keeps the rows
        whose salted key hash lands in its partition, so every group
        falls in exactly one. The partition count doubles from 2 until
        every partition fits; at the level-1 ceiling an overflowing
        partition subdivides under the rotated salt instead. The
        re-reads hit the resident device tables. A distributed plan's
        partitions run distributed too, and where the mesh splits into
        two or more sub-meshes of two or more slots they run side by
        side, one sub-mesh each (_sweep_partitions).

        Returns (pulled live columns concatenated over the partitions,
        the stripped Sort node, the stripped Limit node)."""
        node = prep.node
        limit_node = sort_node = None
        if isinstance(node, P.Limit):
            limit_node, node = node, node.child
        if isinstance(node, P.Sort):
            sort_node, node = node, node.child
        if not isinstance(node, P.Aggregate) or node.max_groups > 0:
            raise HashCapacityExceeded(
                "GROUP BY overflow in a plan shape that cannot be "
                "partitioned; SET hash_group_capacity to a larger power "
                "of two")
        params = self._exec_params(prep.session, prep.no_topk)
        decision = prep.decision
        compile_fn = compile_plan
        if decision is not None:
            params.axis_name, params.n_shards = AXIS, self.mesh.size

            def compile_fn(node, params, meta):
                return self._mesh_call(node, params, meta, self.mesh)
        shapes = tuple(sorted((a, b.n) for a, b in prep.scans.items()))
        cgens = self._cache_gens(prep.gens)
        key = ("partitioned", prep.sql_text, shapes, cgens,
               params.hash_group_capacity, params.pallas_groupagg,
               params.sort_normalized, hash(repr(node)),
               decision is not None)
        runf, meta, _ = self._compiled(key, cgens, node, params,
                                       prep.meta, compile_fn)
        names = list(meta.names)
        ts = (read_ts or prep.as_of
              or self._read_ts(prep.session)).to_int()

        def run_pid(fn, scans, nparts: int, pid: int) -> tuple:
            rc = RunContext(scans, ts, nparts, pid, params=prep.params)
            out = fn(rc)
            self._check_sentinels(out)
            return pull_batch_columns(out, names), rc.route

        def pid_parts(fn, scans, nparts: int, pid: int) -> list:
            try:
                return [run_pid(fn, scans, nparts, pid)]
            except HashCapacityExceeded:
                if nparts < self.MAX_SPILL_PARTITIONS:
                    raise   # the caller doubles the level-1 fan-out
                # keys that collide under the first salt: subdivide
                # this partition under the rotated salt
                l2 = 2
                while l2 <= self.MAX_SPILL_PARTITIONS:
                    try:
                        return [run_pid(fn, scans, nparts * l2,
                                        pid2 * nparts + pid)
                                for pid2 in range(l2)]
                    except HashCapacityExceeded:
                        l2 *= 2
                raise HashCapacityExceeded(
                    "GROUP BY did not fit hash_group_capacity even at "
                    f"{self.MAX_SPILL_PARTITIONS} partitions x "
                    f"{self.MAX_SPILL_PARTITIONS} rotated-salt "
                    "sub-partitions") from None

        nparts = 2
        while True:
            try:
                parts = self._sweep_partitions(
                    runf, prep, pid_parts, nparts, key, cgens, node,
                    params, meta)
                break
            except HashCapacityExceeded:
                if nparts >= self.MAX_SPILL_PARTITIONS:
                    raise
                nparts *= 2
        for _, route in parts:
            self._note_route(prep, route)
        self.last_exec["all"]["partitioned"].append(nparts)
        if self._nested == 0:
            self.last_exec["partitioned"].append(nparts)
        pulled = {c: tuple(np.concatenate([p[c][i] for p, _ in parts])
                           for i in (0, 1)) for c in names}
        return pulled, sort_node, limit_node

    def _mesh_call(self, node, params: ExecParams, meta, mesh):
        """A plan compiled for ``mesh`` (params' shard count), behind
        the mesh's dispatcher: called with a RunContext of MeshBatches."""
        return distagg.queued_collective_call(
            distagg.make_distributed_fn(compile_plan(node, params, meta),
                                        mesh, scan_maps(node)[0]),
            metrics=self.metrics, mesh=mesh)

    def _sweep_partitions(self, runf, prep: Prepared, pid_parts,
                          nparts: int, key, cgens, node,
                          params: ExecParams, meta) -> list:
        """Every partition's (pulled columns, route), in pid order (the
        reference's _sweep_spill_partitions). A distributed plan whose
        mesh splits into two or more sub-meshes of two or more slots
        runs its partitions over those sub-meshes side by side, pid i on
        sub-mesh i mod k (disjoint rendezvous domains, one gate mode);
        else they run one after another on the plan's own target."""
        subs = None
        if prep.decision is not None:
            subs = self._submesh_sweep(key, cgens, node, params, meta,
                                       prep.decision)
        if subs is None:
            return [p for pid in range(nparts)
                    for p in pid_parts(runf, prep.scans, nparts, pid)]
        calls, scanses = subs
        k = len(calls)
        results: list = [None] * nparts
        err = None
        with concurrent.futures.ThreadPoolExecutor(max_workers=k) as ex:
            futs = [ex.submit(pid_parts, calls[pid % k], scanses[pid % k],
                              nparts, pid) for pid in range(nparts)]
            for pid, f in enumerate(futs):
                try:
                    results[pid] = f.result()
                except HashCapacityExceeded as e:
                    err = err or e
        if err is not None:
            raise err
        self.metrics.counter(
            "exec.spill.submesh_sweeps",
            "spill partition sweeps fanned out over pool sub-meshes").inc()
        return [p for part in results for p in part]

    def _submesh_sweep(self, key, cgens, node, params: ExecParams, meta,
                       decision):
        """(calls, scans) a sub-mesh for a partition sweep over the
        largest sub-mesh size with two or more sub-meshes of two or more
        slots, or None when the pool yields none or the sub-meshes'
        placements pass the budget."""
        pool = self._submesh_pool()
        if pool is None:
            return None
        sizes = [s for s in pool.sizes() if s >= 2 and pool.count(s) >= 2]
        if not sizes:
            return None
        size = sizes[0]
        subs = pool.submeshes(size)
        sub_params = dataclasses.replace(params, n_shards=size)

        def compile_calls(node, params, meta):
            return tuple(self._mesh_call(node, params, meta, m)
                         for m in subs)
        calls, _, _ = self._compiled(key + ("submesh", size), cgens, node,
                                     sub_params, meta, compile_calls)
        aliases, cols = scan_maps(node)
        try:
            scanses = [{a: self._device_table(
                t, cols[a], meshmod.shard_spec() if a in decision.sharded
                else meshmod.replicated_spec(), m)
                for a, t in aliases.items()} for m in subs]
        except MemoryQuotaError:
            return None
        return calls, scanses

    def _run_partitioned(self, prep: Prepared, read_ts) -> Result:
        """The partitioned re-run as a Result: the partitions' rows with
        the statement's ORDER BY and LIMIT applied on the host."""
        pulled, sort_node, limit_node = self._partitioned_columns(prep,
                                                                  read_ts)
        res = self._decode(pulled, prep.meta)
        if sort_node is not None:
            res.rows = host_sort(res.rows, prep.meta, sort_node.keys)
        if limit_node is not None:
            off = limit_node.offset or 0
            end = (off + limit_node.limit if limit_node.limit is not None
                   else None)
            res.rows = res.rows[off:end]
        return res

    # -- device upload -------------------------------------------------------
    def _device_table(self, name: str, cols: frozenset,
                      placement: str = "single", mesh=None):
        """Resident device copy of ``name`` holding at least ``cols``:
        cached per table generation, or uploaded now. The upload's
        bytes are reserved against the budget before it moves
        (MemoryQuotaError past it) and released with the copy.

        With a mesh placement ("sharded" or "replicated", on ``mesh``,
        the engine's by default) a MeshBatch cut from that copy: the
        mesh is part of its identity (a batch placed on sub-mesh A never
        serves a plan for B), and it goes with the copy it was cut from
        (_place_on_mesh)."""
        if placement != "single":
            return self._mesh_table(name, cols, placement,
                                    mesh if mesh is not None else self.mesh)
        td = self.store.table(name)
        key = (name, td.generation)
        with self._device_lock:
            hit = self._device_tables.get(key)
            if hit is not None and cols <= hit[0]:
                return hit[1]
            self._evict_device(name)
            if hit is not None:
                cols = cols | hit[0]
            nbytes = self._table_device_bytes(td, cols)
            self.movement.reserve_resident(key, nbytes)
            try:
                with self.tracer.span("upload", table=name):
                    b = self._batch_from_chunks(td, td.chunks, cols)
            except BaseException:
                self.movement.release_resident(key)
                raise
            self._device_tables[key] = (cols, b)
        profile.note(f"upload:{name}", batches=1, rows=td.row_count,
                     bytes_uploaded=nbytes)
        return b

    def _mesh_table(self, name: str, cols: frozenset, placement: str,
                    mesh) -> distagg.MeshBatch:
        base = self._device_table(name, cols)
        key = (name, self.store.table(name).generation, placement,
               mesh.key())
        with self._device_lock:
            hit = self._mesh_tables.get(key)
            if hit is not None and hit[0] is base:
                return hit[1]
            if hit is not None:
                self._drop_mesh_table(key)
            if multihost.num_hosts() > 1:
                # resident uploads are host-local on a pod: a tensor
                # cannot be placed on another process's card. The
                # cross-host dimension of a scan is the DistSQL merge
                # tree's job (each host owns its shard)
                remote = [str(d) for d in mesh.devices
                          if not multihost.addressable(d)]
                if remote:
                    raise EngineError(
                        f"table {name!r}: resident upload targets a mesh "
                        f"with slots this process cannot address "
                        f"({', '.join(remote)}); use the host-local mesh "
                        "(parallel.mesh.pod_mesh)")
            mb, extra = self._place_on_mesh(name, base, placement, mesh)
            acct = None
            if extra:
                acct = ("mesh",) + key
                self.movement.reserve_resident(acct, extra)
            self._mesh_tables[key] = (base, mb, acct)
        return mb

    @staticmethod
    def _place_on_mesh(name: str, base: ColumnBatch, placement: str,
                       mesh) -> tuple:
        """(MeshBatch, bytes copied to other devices) of a resident copy
        on ``mesh``. Sharded: slot i takes rows [i*n/N, (i+1)*n/N) of
        the padded table (padding rows are never visible, so every
        slice is a valid batch); replicated: every slot the whole table.
        A slot on the copy's own device takes views of it, so a mesh of
        several slots on one card costs no bytes; a slot on another
        card takes a copy there."""
        def nbytes(b):
            return sum(t.numel() * t.element_size()
                       for t in (b.sel, *b.data, *b.valid))

        def on(b, dev):
            return ColumnBatch(tuple(t.to(dev) for t in b.data),
                               tuple(t.to(dev) for t in b.valid),
                               b.sel.to(dev), b.names)
        pieces = []
        if placement == meshmod.shard_spec():
            if base.n % mesh.size:
                raise EngineError(
                    f"table {name!r}: {base.n} padded rows do not split "
                    f"over {mesh.size} shards")
            per = base.n // mesh.size
            for i in range(mesh.size):
                lo, hi = i * per, (i + 1) * per
                pieces.append(ColumnBatch(
                    tuple(t[lo:hi] for t in base.data),
                    tuple(t[lo:hi] for t in base.valid),
                    base.sel[lo:hi], base.names))
        else:
            pieces = [base] * mesh.size
        extra = 0
        for i, dev in enumerate(mesh.devices):
            if dev != base.device:
                pieces[i] = on(pieces[i], dev)
                extra += nbytes(pieces[i])
        return distagg.MeshBatch(pieces, placement), extra

    def _drop_mesh_table(self, key) -> None:
        acct = self._mesh_tables.pop(key)[2]
        if acct is not None:
            self.movement.release_resident(acct)

    def _evict_device(self, name: str) -> None:
        """Drop every resident device copy of table ``name``, its mesh
        placements, and their reservations."""
        with self._device_lock:
            for k in [k for k in self._device_tables if k[0] == name]:
                del self._device_tables[k]
                self.movement.release_resident(k)
            for k in [k for k in self._mesh_tables if k[0] == name]:
                self._drop_mesh_table(k)

    def _batch_from_chunks(self, td, chunks, cols: frozenset) -> ColumnBatch:
        """Concatenate chunks, pad to the row count's shape-ladder rung
        (sel False, MVCC never-visible), and copy to the device with
        the MVCC columns. torch.tensor copies, so the device batch never
        aliases the store's arrays."""
        n = sum(c.n for c in chunks)
        padded = self._row_bucket(n)
        data, valid = {}, {}
        for col in td.schema.columns:
            cn = col.name
            if cn not in cols:
                continue
            arr = (np.concatenate([c.data[cn] for c in chunks]) if chunks
                   else np.zeros(0, dtype=col.type.np_dtype))
            va = (np.concatenate([c.valid[cn] for c in chunks]) if chunks
                  else np.zeros(0, bool))
            data[cn] = _pad(arr, padded)
            valid[cn] = _pad(va, padded)
        mts = (np.concatenate([c.mvcc_ts for c in chunks]) if chunks
               else np.zeros(0, np.int64))
        mdl = (np.concatenate([c.mvcc_del for c in chunks]) if chunks
               else np.zeros(0, np.int64))
        data["_mvcc_ts"] = _pad(mts, padded, fill=_PAD_TS)
        data["_mvcc_del"] = _pad(mdl, padded, fill=0)
        dev = self.device
        sel = torch.zeros(padded, dtype=torch.bool, device=dev)
        sel[:n] = True
        return ColumnBatch.from_dict(
            {k: torch.tensor(v, device=dev) for k, v in data.items()},
            {k: torch.tensor(v, device=dev) for k, v in valid.items()},
            sel=sel)

    # -- result materialization ---------------------------------------------
    def _check_sentinels(self, out: ColumnBatch) -> None:
        """Raise the exception of the first set error sentinel of a
        result batch. The flags reduce to scalars on the device and come
        over in one pull."""
        sent = [n for n in SENTINEL_COLUMNS if out.has(n)]
        if sent:
            flags = pull_arrays([torch.stack([torch.any(out.col(n))
                                              for n in sent])])[0]
            for name, f in zip(sent, flags):
                if bool(f):
                    raise _SENTINEL_EXCS[name]()

    def _materialize(self, out: ColumnBatch, meta: P.OutputMeta,
                     check: bool = True) -> Result:
        """Decode a device result batch into host rows, after its
        sentinels unless the caller checked them."""
        if check:
            self._check_sentinels(out)
        return self._decode(pull_batch_columns(out, list(meta.names)),
                            meta)

    @staticmethod
    def _decode(pulled: dict, meta: P.OutputMeta) -> Result:
        """Host rows from pulled live columns {name: (data, valid)}."""
        names = list(meta.names)
        res = Result(names=names, types=list(meta.types))
        cols = []
        for name, ty in zip(names, meta.types):
            d, v = pulled[name]
            cols.append(_decode_column(d, v, ty,
                                       meta.dictionaries.get(name)))
        res.rows = list(zip(*cols)) if cols else []
        return res


def _fresh_route() -> dict:
    return {"compact_nodes": 0, "replans": [], "subqueries": 0,
            "temps": [], "partitioned": [], "paging": None, "waits": {},
            "composed": False,
            "all": {"runs": 0, "compact_nodes": 0, "compacts_applied": 0,
                    "topk_cuts": 0, "group_ids": 0, "expansions": [],
                    "replans": [], "partitioned": [], "paging": []}}


def _temp_names(names, rename, tname: str) -> list:
    """A temp table's column names: the query's, or a CTE's list."""
    names = list(names)
    if rename is not None:
        if len(rename) != len(names):
            raise EngineError("CTE column list length does not match "
                              "query")
        names = list(rename)
    if len(set(names)) != len(names):
        raise EngineError(f"duplicate column names in {tname}")
    return names


def _probe_rows_bound(eng, node) -> int:
    """An upper bound on a plan's output rows: the padded row count of
    its largest scan, times the expansion of every join below."""
    if isinstance(node, P.Scan):
        return eng._row_bucket(eng.store.table(node.table).row_count)
    rows = max([_probe_rows_bound(eng, getattr(node, a))
                for a in ("child", "left") if getattr(node, a, None)
                is not None] or [1])
    return rows * max(getattr(node, "expand", 1), 1)


def _count_nodes(node, cls) -> int:
    n = int(isinstance(node, cls))
    for attr in ("child", "left", "right"):
        c = getattr(node, attr, None)
        if c is not None:
            n += _count_nodes(c, cls)
    return n


def _capacity(value) -> int:
    """hash_group_capacity as a positive power of two, or EngineError."""
    try:
        cap = int(value)
    except (TypeError, ValueError):
        cap = 0
    if cap <= 0 or cap & (cap - 1):
        raise EngineError(f"invalid value for hash_group_capacity: "
                          f"{value!r} (a positive power of two)")
    return cap


def _pad(a: np.ndarray, n: int, fill=0) -> np.ndarray:
    out = np.full(n, fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def _decode_column(data: np.ndarray, valid: np.ndarray, ty,
                   dictionary) -> list:
    return [decode_scalar(d, bool(m), ty, dictionary)
            for d, m in zip(data, valid)]


def _cut(rows: list, limit, offset) -> list:
    """LIMIT/OFFSET over host rows."""
    if offset:
        rows = rows[offset:]
    return rows if limit is None else rows[:limit]


def _unify_rows(rows: list, coerce_cols: dict) -> list:
    """A set operation's branch rows with the columns of
    ``coerce_cols`` (index -> unified SQLType) in the unified type."""
    out = []
    for r in rows:
        r = list(r)
        for i, ut in coerce_cols.items():
            if r[i] is None:
                continue
            if ut.family == Family.FLOAT:
                r[i] = float(r[i])
            elif ut.family == Family.DECIMAL:
                r[i] = decimal.Decimal(str(r[i]))
        out.append(tuple(r))
    return out


def _sort_decoded(rows: list, names: list, order_by) -> list:
    """Host ORDER BY of decoded rows by output column name or position
    (a set operation's, a set-returning function's)."""
    keys = []
    for ob in order_by:
        if isinstance(ob.expr, ast.Literal) \
                and isinstance(ob.expr.value, int):
            i = ob.expr.value - 1
        elif isinstance(ob.expr, ast.ColumnRef) and ob.expr.name in names:
            i = names.index(ob.expr.name)
        else:
            raise EngineError(
                "set-op ORDER BY must reference output columns")
        keys.append((i, ob.desc, ob.nulls_first))
    return sort_rows(rows, keys)
