"""Named counters, gauges and histograms, and their Prometheus text.

The port of cockroach_tpu/utils/metric.py (pkg/util/metric
registry.go:31 and prometheus_exporter.go). Every subsystem registers
named metrics here: the streamed and spill tiers, the movement
scheduler, the OLTP lane, admission and the pgwire front ends.
``snapshot()`` gives every metric's value by name, as the reference's
registry does; the node's status server serves ``to_prometheus()``.

Func metrics (FuncCounter/FuncGauge) read their value from a callback
at scrape time, so hot paths keep plain-int counters. Histograms keep
log2 buckets, shared with utils/sqlstats.py's latency buckets so their
quantiles agree.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Optional


NUM_BUCKETS = 40


def log2_bucket_index(v: float, num_buckets: int = NUM_BUCKETS) -> int:
    """Bucket index for one observation in the shared log2 layout
    (used by Histogram below and utils/sqlstats latency buckets, so
    their quantiles agree)."""
    if v <= 0:
        return 0
    return min(num_buckets - 1, max(0, int(math.log2(v * 1e6) + 1)))


def log2_bucket_bound(i: int) -> float:
    """Upper bound (inclusive, seconds/units) of bucket `i`."""
    return (2.0 ** (i - 1)) / 1e6


def buckets_quantile(buckets: list, q: float) -> float:
    """Quantile estimate over log2 bucket counts: the upper bound of
    the bucket holding the q-th observation."""
    total = sum(buckets)
    if total == 0:
        return 0.0
    target = q * total
    acc = 0
    for i, c in enumerate(buckets):
        acc += c
        if acc >= target:
            return log2_bucket_bound(i)
    return log2_bucket_bound(len(buckets) - 1)


class Tally:
    """Plain counts by key under a lock, for module-level tallies that
    func metrics read (a process's autotune sweeps, parity checks)."""

    def __init__(self):
        self._c: dict[str, float] = {}
        self._lock = threading.Lock()

    def bump(self, key: str, by: float = 1) -> None:
        with self._lock:
            self._c[key] = self._c.get(key, 0) + by

    def value(self, key: str) -> float:
        with self._lock:
            return self._c.get(key, 0)


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, delta: int = 1) -> None:
        with self._lock:
            self._v += delta

    def value(self) -> int:
        return self._v


class Gauge:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    def inc(self, delta: float = 1.0) -> None:
        with self._lock:
            self._v += delta

    def dec(self, delta: float = 1.0) -> None:
        self.inc(-delta)

    def value(self) -> float:
        return self._v


class FuncCounter:
    """Counter whose value is read from a callback at scrape time."""

    def __init__(self, name: str, fn: Callable[[], float],
                 help_: str = ""):
        self.name = name
        self.help = help_
        self._fn = fn

    def value(self):
        try:
            return self._fn()
        except Exception:
            return 0


class FuncGauge(FuncCounter):
    pass


class Histogram:
    """Log-bucketed latency/size histogram (the reference uses HDR-ish
    histograms; log2 buckets keep it dependency-free)."""

    def __init__(self, name: str, help_: str = "",
                 num_buckets: int = NUM_BUCKETS):
        self.name = name
        self.help = help_
        self._buckets = [0] * num_buckets
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        b = log2_bucket_index(v, len(self._buckets))
        with self._lock:
            self._buckets[b] += 1
            self._sum += v
            self._count += 1

    def value(self) -> dict:
        return {"count": self._count, "sum": self._sum}

    def bucket_bounds(self) -> list[float]:
        """Upper bound (inclusive, seconds/units) of each bucket."""
        return [log2_bucket_bound(i)
                for i in range(len(self._buckets))]

    def buckets(self) -> list[int]:
        with self._lock:
            return list(self._buckets)

    def quantile(self, q: float) -> float:
        with self._lock:
            return buckets_quantile(self._buckets, q)


class MetricRegistry:
    """Named metric registry (pkg/util/metric/registry.go:31)."""

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()
        self._collectors: list[Callable[[], None]] = []

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_add(name, lambda: Counter(name, help_))

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_add(name, lambda: Gauge(name, help_))

    def histogram(self, name: str, help_: str = "") -> Histogram:
        return self._get_or_add(name, lambda: Histogram(name, help_))

    def func_counter(self, name: str, fn: Callable[[], float],
                     help_: str = "") -> FuncCounter:
        return self._get_or_add(name,
                                lambda: FuncCounter(name, fn, help_))

    def func_gauge(self, name: str, fn: Callable[[], float],
                   help_: str = "") -> FuncGauge:
        return self._get_or_add(name,
                                lambda: FuncGauge(name, fn, help_))

    def _get_or_add(self, name: str, mk):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = mk()
                self._metrics[name] = m
            return m

    def add_collector(self, fn: Callable[[], None]) -> None:
        """Run ``fn`` before every snapshot and export; collectors
        refresh dynamic metric families (per-peer gauges) in place."""
        with self._lock:
            self._collectors.append(fn)

    def _collect(self) -> None:
        for fn in list(self._collectors):
            try:
                fn()
            except Exception:
                pass

    def get(self, name: str) -> Optional[object]:
        return self._metrics.get(name)

    def snapshot(self) -> dict:
        self._collect()
        return {name: m.value() for name, m in sorted(self._metrics.items())}

    def to_prometheus(self) -> str:
        """Text exposition format (prometheus_exporter.go)."""
        self._collect()
        out = []
        for name, m in sorted(self._metrics.items()):
            pname = name.replace(".", "_").replace("-", "_")
            if m.help:
                help_ = m.help.replace("\\", "\\\\").replace("\n", "\\n")
                out.append(f"# HELP {pname} {help_}")
            if isinstance(m, (Counter, FuncCounter)) and \
                    not isinstance(m, (Gauge, FuncGauge)):
                out.append(f"# TYPE {pname} counter")
                out.append(f"{pname} {m.value()}")
            elif isinstance(m, (Gauge, FuncGauge)):
                out.append(f"# TYPE {pname} gauge")
                out.append(f"{pname} {m.value()}")
            elif isinstance(m, Histogram):
                # Real cumulative histogram exposition: each
                # `le`-labelled bucket counts observations <= its
                # upper bound, finishing at +Inf == _count.
                v = m.value()
                out.append(f"# TYPE {pname} histogram")
                acc = 0
                for bound, c in zip(m.bucket_bounds(), m.buckets()):
                    acc += c
                    out.append(
                        f'{pname}_bucket{{le="{bound:.6g}"}} {acc}')
                out.append(f'{pname}_bucket{{le="+Inf"}} {v["count"]}')
                out.append(f"{pname}_sum {v['sum']}")
                out.append(f"{pname}_count {v['count']}")
        return "\n".join(out) + "\n"
