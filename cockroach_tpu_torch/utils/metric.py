"""Named counters, gauges and histograms (the subset of
cockroach_tpu/utils/metric.py that the streamed and spill tiers and
the movement scheduler report through). ``snapshot()`` gives every
metric's value by name, as the reference's registry does, so tests can
hold the two engines' page and skip counters side by side."""

from __future__ import annotations

import threading


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, delta=1) -> None:
        with self._lock:
            self._v += delta

    def value(self):
        return self._v


class Gauge:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._v = 0

    def set(self, v) -> None:
        self._v = v

    def value(self):
        return self._v


class FuncGauge:
    """A gauge read from a function at snapshot time."""

    def __init__(self, name: str, fn, help_: str = ""):
        self.name = name
        self.help = help_
        self._fn = fn

    def value(self):
        return self._fn()


class Histogram:
    """Count and sum of the observed values (the reference keeps log2
    buckets too; nothing in this package reads them)."""

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._count += 1

    def value(self) -> dict:
        return {"count": self._count, "sum": self._sum}


class MetricRegistry:
    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get_or_add(name, lambda: Counter(name, help_))

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get_or_add(name, lambda: Gauge(name, help_))

    def func_gauge(self, name: str, fn, help_: str = "") -> FuncGauge:
        return self._get_or_add(name, lambda: FuncGauge(name, fn, help_))

    def histogram(self, name: str, help_: str = "") -> Histogram:
        return self._get_or_add(name, lambda: Histogram(name, help_))

    def _get_or_add(self, name: str, mk):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = mk()
                self._metrics[name] = m
            return m

    def get(self, name: str):
        return self._metrics.get(name)

    def snapshot(self) -> dict:
        with self._lock:
            return {n: m.value() for n, m in self._metrics.items()}
