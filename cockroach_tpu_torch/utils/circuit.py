"""Circuit breakers: fail fast on unavailable resources
(cockroach_tpu/utils/circuit.py, ported as it stands).

The analogue of pkg/util/circuit (probe-driven breakers) as used by
per-replica breakers (kvserver/replica_circuit_breaker.go): once a
resource reports enough consecutive failures the breaker trips, and
every subsequent check fails fast with BreakerTrippedError instead of
hanging a full timeout — until recovery is demonstrated and it resets.

Two recovery modes, composable:

- **probe**: a cheap callable run inline at check time (the original
  deterministic-harness mode; the reference probes from a background
  goroutine, same property: a probe is bounded and much cheaper than
  the operation's own retry loop).
- **cooldown**: the classic closed → open → half-open state machine
  for wall-clock fabrics (per-PEER breakers in netcluster/distsender).
  After ``cooldown`` seconds in the open state, exactly one caller is
  admitted as a trial (half-open); its success resets the breaker, its
  failure re-opens it and re-arms the cooldown. Without this, a peer
  breaker would need an out-of-band prober to ever heal.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class BreakerTrippedError(RuntimeError):
    """The resource is unavailable; the operation was not attempted."""


class Breaker:
    def __init__(self, name: str, threshold: int = 1,
                 probe: Optional[Callable[[], bool]] = None,
                 cooldown: Optional[float] = None,
                 clock=time.monotonic):
        self.name = name
        self.threshold = threshold
        self.probe = probe
        self.cooldown = cooldown
        self.clock = clock
        self.failures = 0      # consecutive
        self.tripped = False
        self.trip_count = 0    # total trips (metrics)
        self.half_open = False
        self._tripped_at: Optional[float] = None

    def check(self) -> None:
        """Raise BreakerTrippedError if tripped and recovery cannot be
        demonstrated; no-op when healthy. With a cooldown, the first
        check after the cooldown elapses is admitted as the half-open
        trial (the caller's own success/failure report decides)."""
        if not self.tripped:
            return
        if self.probe is not None:
            try:
                ok = self.probe()
            except Exception:
                ok = False
            if ok:
                self.reset()
                return
        if self.cooldown is not None and not self.half_open and \
                self._tripped_at is not None and \
                self.clock() - self._tripped_at >= self.cooldown:
            self.half_open = True      # admit exactly one trial
            return
        raise BreakerTrippedError(
            f"{self.name}: breaker tripped (probe failed; "
            f"{self.failures} consecutive failures)")

    def report_failure(self) -> None:
        self.failures += 1
        if self.half_open:
            # the trial failed: back to fully open, cooldown re-armed
            self.half_open = False
            self._tripped_at = self.clock()
            return
        if self.failures >= self.threshold and not self.tripped:
            self.tripped = True
            self.trip_count += 1
            self._tripped_at = self.clock()

    def report_success(self) -> None:
        self.reset()

    def register_metrics(self, reg, prefix: str) -> None:
        """Expose this breaker's state under `prefix` in a
        MetricRegistry (trips/failures counters + tripped gauge);
        values are read live at scrape time, no hot-path cost."""
        reg.func_counter(f"{prefix}.trips",
                         lambda: self.trip_count,
                         "total breaker trips")
        reg.func_gauge(f"{prefix}.failures",
                       lambda: self.failures,
                       "consecutive failures reported")
        reg.func_gauge(f"{prefix}.tripped",
                       lambda: 1.0 if self.tripped else 0.0,
                       "1 while the breaker is open")

    def reset(self) -> None:
        self.failures = 0
        self.tripped = False
        self.half_open = False
        self._tripped_at = None
