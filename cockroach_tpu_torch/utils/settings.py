"""Cluster settings and session variables (the subset of
cockroach_tpu/utils/settings.py that this package reads).

``Settings`` is the typed cluster-setting registry
(``Engine.settings.get/set``, ``SET CLUSTER SETTING``, update callbacks
through ``on_change``); ``SessionVars`` holds one connection's
variables, with the reference's names."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable


class SettingError(Exception):
    pass


@dataclass
class _Setting:
    name: str
    default: object
    kind: type
    description: str = ""
    validate: Callable[[object], None] | None = None


class Settings:
    """Typed cluster-setting registry (cf. pkg/settings)."""

    def __init__(self):
        self._defs: dict[str, _Setting] = {}
        self._values: dict[str, object] = {}
        self._lock = threading.Lock()
        self._watchers: list[Callable[[str, object], None]] = []
        _register_builtins(self)

    def register(self, name: str, default, kind: type,
                 description: str = "",
                 validate: Callable[[object], None] | None = None) -> None:
        """``validate(value)`` raises SettingError for a value the
        setting refuses."""
        self._defs[name] = _Setting(name, default, kind, description,
                                    validate)

    def set(self, name: str, value) -> None:
        d = self._defs.get(name)
        if d is None:
            raise SettingError(f"unknown cluster setting {name!r}")
        if d.kind is bool and isinstance(value, str):
            value = value.lower() in ("true", "on", "1", "yes")
        try:
            value = d.kind(value)
        except (TypeError, ValueError) as e:
            raise SettingError(f"bad value for {name}: {value!r}") from e
        if d.validate is not None:
            d.validate(value)
        with self._lock:
            self._values[name] = value
            watchers = list(self._watchers)
        for w in watchers:
            w(name, value)

    def get(self, name: str):
        d = self._defs.get(name)
        if d is None:
            raise SettingError(f"unknown cluster setting {name!r}")
        with self._lock:
            return self._values.get(name, d.default)

    def snapshot(self) -> dict:
        """Every setting's current value (the diagnostics bundle's
        settings section)."""
        with self._lock:
            out = {n: d.default for n, d in self._defs.items()}
            out.update(self._values)
            return out

    def on_change(self, fn: Callable[[str, object], None]) -> None:
        """Call ``fn(name, value)`` after every successful set."""
        self._watchers.append(fn)


def _pow2(v) -> None:
    if v < 1 or v & (v - 1) != 0:
        raise SettingError("must be a power of two")


def _submesh_size(v) -> None:
    if v in ("auto", "off"):
        return
    try:
        n = int(v)
    except ValueError:
        raise SettingError("must be auto, off, or a power of two") from None
    if n < 1 or n & (n - 1) != 0:
        raise SettingError("must be auto, off, or a power of two")


def _register_builtins(s: Settings) -> None:
    # the reference's name, type and default, so both engines take the
    # same placement routes at the same budget
    s.register("sql.exec.hbm_budget_bytes", 12 << 30, int,
               "device-memory budget for resident table uploads; "
               "aggregate scans over bigger tables stream in pages, "
               "over-budget join builds and sorts spill (0 = no "
               "budget)")
    # distributed execution over the engine's shard mesh
    # (parallel/distagg.py, Engine._dist_decision and _DistRouter)
    s.register("sql.distsql.mesh_partitioning.enabled", True, bool,
               "partition scan spans over the device mesh")
    # DistSQL flows between engines (distsql/node.py)
    s.register("exec.agg.adaptive_raw_fraction", 0.5, float,
               "DistSQL adaptive aggregation: when a shard's "
               "estimated group count exceeds this fraction of its "
               "row count, ship raw rows instead of per-shard "
               "partial aggregates (Partial Partial Aggregates)")
    s.register("sql.exec.submesh.size", "auto", str,
               "devices per dispatch sub-mesh for eligible distributed "
               "plans: a power of two divides the mesh into disjoint "
               "rendezvous domains that execute concurrently; auto = "
               "the full mesh while idle, the smallest fitting sub-mesh "
               "once dispatches queue; off = always the full mesh",
               _submesh_size)
    # admission and the tenant quota plane (utils/admission.py)
    s.register("sql.admission.shed.queue_depth", 0, int,
               "admission queue depth at which low-priority statements "
               "are rejected up front instead of queued (0 disables)")
    s.register("sql.admission.shed.wait_seconds", 0.0, float,
               "recent admission grant-wait (EWMA, seconds) above which "
               "low-priority statements are shed (0 disables)")
    s.register("sql.admission.shed.exec_queue_depth", 0, int,
               "writers waiting at the statement gate above which "
               "low-priority statements are shed (0 disables)")
    s.register("sql.admission.tenant.slots", 0, int,
               "per-tenant cap on concurrently held admission slots; a "
               "tenant at its cap queues behind other tenants even when "
               "global slots are free (0 disables)")
    s.register("sql.admission.tenant.hbm_fraction", 0.0, float,
               "fraction of sql.exec.hbm_budget_bytes one tenant's "
               "in-flight statements may pin at once; statements whose "
               "estimated working set would push the tenant over wait "
               "for an eligible slot instead of dispatching (0 disables)")
    s.register("sql.exec.plan_cache.tenant_budget", 0, int,
               "per-tenant entry budget in the compiled-plan and parse "
               "caches: a tenant past its budget evicts its own oldest "
               "entries, never another tenant's (0 = shared LRU)")
    # the pgwire front door (server/pgwire.py, server/pgfront.py)
    s.register("server.prepared_statement_budget", 256, int,
               "named prepared statements one pgwire session may hold; "
               "Parse past the budget fails with 53400 (0 disables)")
    s.register("server.pgwire_frontend", "reactor", str,
               "pgwire connection front end: reactor = one selector "
               "event loop owns all sockets, idle sessions hold no "
               "thread, a bounded worker pool runs the protocol; "
               "threads = thread-per-connection socketserver")
    s.register("server.idle_session_timeout", 0.0, float,
               "seconds a pgwire session may sit idle outside a "
               "transaction before the server closes it (0 disables)")
    s.register("server.startup_deadline_seconds", 10.0, float,
               "deadline for a new connection to complete its startup "
               "packet and authentication (0 disables)")
    s.register("sql.exec.switch_interval", 0.0, float,
               "sys.setswitchinterval applied while the server runs (0 "
               "= the interpreter default). Process-global: a smaller "
               "quantum lets OLTP batch windows close while an analytic "
               "statement holds the interpreter lock")
    # zones and MVCC GC (exec/maintenance.py): a table's zone
    # (CONFIGURE ZONE) overrides both
    s.register("kv.range.max_bytes", 512 << 20, int,
               "range split threshold (cf. 512MB default)")
    s.register("kv.gc.ttl_seconds", 14400, int, "MVCC GC TTL")
    s.register("timeseries.retention.seconds", 6 * 3600, int,
               "fine-resolution (10s) timeseries slabs older than this "
               "are rolled up to coarse resolution and pruned by the "
               "node's maintenance loop")
    # observability: the slow-statement ring, operator profiles
    s.register("sql.trace.slow_statement.threshold", 0.0, float,
               "statements slower than this many seconds keep their "
               "trace recording in the /debug/tracez ring buffer "
               "(0 disables)")
    # cold start (exec/coldstart.py) and kernel 1's launch-point
    # autotune (ops/cuda/autotune.py): the reference's names
    s.register("sql.exec.compile_cache.dir", "", str,
               "root of the cold-start cache: shapes journal, kernel-1 "
               "tuning and parity-verdict tables ('' = "
               "$COCKROACH_TPU_COMPILE_CACHE_DIR or ~/.cache/"
               "cockroach_tpu_torch; 'off' disables). State lives in a "
               "per-toolchain, per-card subdirectory, so an upgrade "
               "invalidates by path, never by flush")
    s.register("sql.exec.compile_cache.prewarm", 0, int,
               "top-K statements of the previous run's shapes journal "
               "that Engine.prewarm() re-prepares at start (0 disables)")
    s.register("sql.exec.shape_bucket.min_rows", 1024, int,
               "smallest padded row bucket", _pow2)
    s.register("sql.exec.shape_bucket.steps_per_octave", 1, int,
               "row buckets per doubling of the shape ladder (1 = "
               "power-of-two padding; 2/4/8 insert intermediate "
               "buckets: less padding, more plan shapes)", _pow2)
    s.register("sql.exec.pallas.autotune", "auto", str,
               "kernel-1 launch-point autotune: auto = the tuning "
               "table's point, else the shipped one (never sweeps); on "
               "= sweep when the table has no entry, on a card or the "
               "CPU; off = the shipped point")
    s.register("sql.stmt_profile.enabled", True, bool,
               "per-statement coarse operator profile (exec/profile"
               ".py): the data-movement sites note their bytes and "
               "stalls into the executing statement's sink, and the "
               "statement's device time is taken from the card, feeding "
               "the per-tenant rollups at /_status/tenants (results "
               "are identical either way)")


def _meta_page_rows() -> int:
    from .metamorphic import metamorphic_pow2
    return metamorphic_pow2("sql.streaming_page_rows", 1 << 21, 12, 21)


@dataclass
class SessionVars:
    """Session variables with reference-compatible names."""
    values: dict = field(default_factory=lambda: {
        # one-pass GROUP BY kernels: auto (default) routes eligible
        # dense GROUP BYs with an exact-result envelope to the large-G
        # kernel (ops/cuda/groupagg_large.py); on also routes ungrouped
        # and <= 64-group aggregations over FLOAT arguments to the
        # small-G kernel (ops/cuda/groupagg.py) and lets the large-G
        # kernel take f32 float sums and MIN/MAX (approximate against
        # the plain path's float64); off keeps every aggregation on the
        # plain scatter path. Engine.execute rejects any other value.
        "pallas_groupagg": "auto",   # auto | on | off
        # distributed execution on an engine with a mesh: off runs
        # every statement on one device; the other values leave the
        # choice to the distribution decision (Engine._dist_decision)
        "distsql": "auto",           # auto | on | off | always
        # slots of the device hash table behind hash-strategy GROUP BY
        # (a power of two). Half of them are usable: a GROUP BY whose
        # build passes half with rows left to place overflows, and the
        # engine re-runs the plan partition by partition
        "hash_group_capacity": 1 << 17,
        # packed-lane sort keys (ops/sortkey.py) for ORDER BY, the
        # top-k cut and duplicate-key join chains: auto and on use
        # them, off sorts by successive stable argsorts
        "sort_normalized": "auto",   # auto | on | off
        # memo-based join ordering / rule pipeline / sketch-fed costing
        "optimizer": "on",           # on | off
        "optimizer_rules": "on",     # on | off
        "optimizer_sketch_stats": "on",   # on | off
        # secondary-index locator plane (exec/fastpath.py,
        # exec/oltplane.py): off sends point and range lookups through
        # the compiled scan
        "index_scan": "on",          # on | off
        # rows a key may match before a warm locator declines in favor
        # of the scan
        "index_lookup_limit": 4096,
        # cross-session batch windows on the OLTP lane
        # (exec/oltpbatch.py): auto fuses concurrent point statements
        # into one multi-key probe or one group commit; off takes the
        # per-statement lane path. Engine.execute rejects any other
        # value
        "oltp_batch": "auto",        # auto | off
        # beyond-memory paging (exec/stream.py): auto streams an
        # aggregate-rooted plan's fact table page by page when its
        # upload would not fit sql.exec.hbm_budget_bytes; off uploads
        # it whole (a quota error past the budget)
        "streaming": "auto",         # auto | off
        # rows per streamed page, rounded up to a power of two (2^21;
        # under COCKROACH_TPU_METAMORPHIC a seeded power of two from
        # 2^12, as in the reference)
        "streaming_page_rows": _meta_page_rows(),
        # on: a background worker assembles and uploads page i+1 while
        # the card computes page i; off: pages assemble synchronously
        "streaming_pipeline": "on",  # on | off
        # out-of-core tier (exec/spill.py): partitioned external hash
        # join and external merge sort. auto spills only when the
        # resident and streamed paths would pass the budget; on forces
        # every eligible shape; off never spills
        "spill": "auto",             # auto | on | off
        # admission tier for this session's statements (the reference's
        # admission.WorkPriority): high | normal | low
        "admission_priority": "normal",
        # SET tracing = off | on | cluster: on records each statement
        # for SHOW TRACE FOR SESSION; on one node cluster records what
        # on records (there are no remote participants)
        "tracing": "off",            # off | on | cluster
        # the tenant key of admission and the caches (drivers send it
        # in their startup packet)
        "application_name": "",
        # kernel 1's launch-point autotune (ops/cuda/autotune.py): None
        # defers to sql.exec.pallas.autotune; auto | on | off. Points
        # are performance-only: results are bit-identical across them
        "pallas_autotune": None,     # None | auto | on | off
        # statement-shape plan cache (exec/planparam.py): auto lifts
        # eligible filter literals into run parameters so statements
        # differing only in them share one compiled plan; off keys the
        # plan by the statement's text
        "plan_shape_cache": "auto",  # auto | off
    })

    def set(self, name: str, value) -> None:
        self.values[name] = value

    def get(self, name: str, default=None):
        return self.values.get(name, default)
