"""Per-statement execution statistics (pkg/sql/sqlstats analogue).

Statements aggregate by FINGERPRINT — the query text with literals
replaced by placeholders, so `SELECT a FROM t WHERE b = 7` and
`... b = 8` are one statement — tracking counts, latency moments, and
row counts. Surfaced through SHOW STATEMENTS.

The port's copy of cockroach_tpu/utils/sqlstats.py. A statement's
``compile_s`` is its seconds in plan builds and kernel library builds
and loads (exec/coldstart.py), where the reference's is XLA's compile.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field

from .metric import (NUM_BUCKETS, buckets_quantile, log2_bucket_index)


_NUM = re.compile(r"\b\d+(\.\d+)?([eE][-+]?\d+)?\b")
_STR = re.compile(r"'(?:[^']|'')*'")
_WS = re.compile(r"\s+")


def fingerprint(sql: str) -> str:
    """Normalize literals to '_' (the reference's tree-walking
    fingerprinter, here regex-shaped: same goal, no reparse)."""
    s = _STR.sub("'_'", sql)
    s = _NUM.sub("_", s)
    return _WS.sub(" ", s).strip()


@dataclass
class StmtStats:
    fingerprint: str
    count: int = 0
    total_latency_s: float = 0.0
    max_latency_s: float = 0.0
    total_rows: int = 0
    failures: int = 0
    # compile seconds attributed to the fingerprint's executions (the
    # reference's compile-vs-execute split): plan builds and kernel
    # library builds and loads
    total_compile_s: float = 0.0
    # latency distribution in the metric plane's shared log2 bucket
    # layout (utils/metric.py) — the recording path is unchanged;
    # quantiles derive from the same observations as the means, and
    # bucket arrays merge element-wise across nodes (the cluster
    # statements fan-out)
    latency_buckets: list = field(
        default_factory=lambda: [0] * NUM_BUCKETS)

    @property
    def mean_latency_s(self) -> float:
        return self.total_latency_s / self.count if self.count else 0.0

    def latency_quantile(self, q: float) -> float:
        return buckets_quantile(self.latency_buckets, q)

    @property
    def p50_latency_s(self) -> float:
        return self.latency_quantile(0.50)

    @property
    def p95_latency_s(self) -> float:
        return self.latency_quantile(0.95)

    @property
    def p99_latency_s(self) -> float:
        return self.latency_quantile(0.99)

    @property
    def mean_compile_s(self) -> float:
        return self.total_compile_s / self.count if self.count else 0.0

    @property
    def mean_exec_s(self) -> float:
        """Mean latency net of compilation — steady-state cost."""
        return max(0.0, self.mean_latency_s - self.mean_compile_s)


@dataclass
class TenantStats:
    """Per-tenant (application_name-keyed) resource rollup: statements,
    rows, the statements' wall time from admission's grant to the
    result (gate wait and host work included), bytes moved (resident
    uploads, streamed pages, spilled partitions: the coarse profile
    plane) and their stall time.
    ``device_seconds`` and ``hbm_bytes_held`` keep the reference's keys
    with what their names say: the statements' time on the card (CUDA
    events around each statement's dispatch; on a CPU engine its host
    clock) and the most the tenant's own reservations held at once in
    the device budget (utils/mon.py). Each stays None until measured:
    the profile plane off (``sql.stmt_profile.enabled``) measures
    neither.
    """
    app_name: str
    statements: int = 0
    failures: int = 0
    rows: int = 0
    wall_seconds: float = 0.0
    bytes_moved: int = 0
    stall_seconds: float = 0.0
    device_seconds: float | None = None
    hbm_bytes_held: int | None = None

    def to_wire(self) -> dict:
        return {"app_name": self.app_name,
                "statements": self.statements,
                "failures": self.failures, "rows": self.rows,
                "wall_seconds": self.wall_seconds,
                "device_seconds": self.device_seconds,
                "bytes_moved": self.bytes_moved,
                "hbm_bytes_held": self.hbm_bytes_held,
                "stall_seconds": self.stall_seconds}


class StatsRegistry:
    def __init__(self):
        self._mu = threading.Lock()
        self._stats: dict[str, StmtStats] = {}
        self._tenants: dict[str, TenantStats] = {}

    def record(self, sql: str, latency_s: float, rows: int,
               failed: bool = False, compile_s: float = 0.0) -> None:
        self.record_fp(fingerprint(sql), latency_s, rows, failed,
                       compile_s)

    def record_fp(self, fp: str, latency_s: float, rows: int,
                  failed: bool = False, compile_s: float = 0.0) -> None:
        """Record against a caller-computed fingerprint (the OLTP lane
        already normalized the literals out of its shape key)."""
        with self._mu:
            st = self._stats.get(fp)
            if st is None:
                st = self._stats[fp] = StmtStats(fp)
            st.count += 1
            st.total_latency_s += latency_s
            st.max_latency_s = max(st.max_latency_s, latency_s)
            st.latency_buckets[log2_bucket_index(latency_s)] += 1
            st.total_rows += rows
            st.total_compile_s += compile_s
            if failed:
                st.failures += 1

    def record_tenant(self, app_name: str, wall_s: float = 0.0,
                      bytes_moved: int = 0, rows: int = 0,
                      stall_s: float = 0.0, failed: bool = False,
                      device_s: float | None = None,
                      hbm_bytes: int | None = None) -> None:
        """Accumulate one statement against its tenant (engine:
        ``application_name`` session var, '(unset)' when empty).
        Exposed at /_status/tenants. ``device_s`` adds to the device
        seconds and ``hbm_bytes`` raises the HBM high-water, each when
        measured (not None)."""
        with self._mu:
            t = self._tenants.get(app_name)
            if t is None:
                t = self._tenants[app_name] = TenantStats(app_name)
            t.statements += 1
            t.rows += rows
            t.wall_seconds += wall_s
            t.bytes_moved += bytes_moved
            t.stall_seconds += stall_s
            if device_s is not None:
                t.device_seconds = (t.device_seconds or 0.0) + device_s
            if hbm_bytes is not None:
                t.hbm_bytes_held = max(t.hbm_bytes_held or 0, hbm_bytes)
            if failed:
                t.failures += 1

    def tenants(self) -> list[TenantStats]:
        with self._mu:
            return sorted(self._tenants.values(),
                          key=lambda t: -t.wall_seconds)

    def all(self) -> list[StmtStats]:
        with self._mu:
            return sorted(self._stats.values(),
                          key=lambda s: -s.total_latency_s)
