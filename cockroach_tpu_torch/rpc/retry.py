"""Unified retry policy: exponential backoff, jitter, deadlines
(cockroach_tpu/rpc/retry.py, ported as it stands).

The analogue of ``pkg/util/retry`` (retry.Options / retry.Start): one
policy object shared by every fabric client — DistSender's point/scan
loops, NetCluster's routed reads/proposes — instead of the per-call
``attempts=8`` constants that used to hang a dead peer for
``attempts * timeout`` serially.

Two time domains coexist here:

- the socket fabric (NetCluster) runs on wall-clock; ``Retrier.wait``
  sleeps real seconds;
- the in-process deterministic cluster is pump-driven; callers convert
  ``backoff()`` seconds into pump iterations (``DistSender._pause``)
  so tests stay fast and deterministic.

Jitter is seeded (callers pass their own ``random.Random``) so nemesis
schedules replay byte-identically.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with decorrelated jitter + a per-request
    deadline (retry.Options: InitialBackoff/MaxBackoff/Multiplier,
    plus the ctx deadline the reference threads through)."""

    max_attempts: int = 8
    base_backoff: float = 0.002      # seconds before the 2nd attempt
    max_backoff: float = 0.5
    multiplier: float = 2.0
    jitter: float = 0.4              # +/- fraction of the raw backoff
    deadline: Optional[float] = 8.0  # per-request wall budget; None = off

    def backoff(self, attempt: int,
                rng: Optional[random.Random] = None) -> float:
        """Backoff before attempt ``attempt`` (attempt 0 never waits)."""
        if attempt <= 0:
            return 0.0
        raw = min(self.base_backoff * (self.multiplier ** (attempt - 1)),
                  self.max_backoff)
        if self.jitter and rng is not None:
            raw *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(raw, 0.0)


class DeadlineExceeded(RuntimeError):
    """The request's overall deadline lapsed before it succeeded."""


class Retrier:
    """Iterator over attempts: enforces max_attempts AND the deadline.

    >>> r = Retrier(policy, rng)
    >>> for attempt in r:
    ...     try: return op()
    ...     except Transient: r.wait()
    """

    def __init__(self, policy: RetryPolicy,
                 rng: Optional[random.Random] = None,
                 clock=time.monotonic, metrics=None):
        self.policy = policy
        self.rng = rng
        self.clock = clock
        self.attempt = 0
        self.start = clock()
        self._m_attempts = self._m_backoff = None
        if metrics is not None:
            self._m_attempts = metrics.counter(
                "retry.attempts", "retry loop attempts started")
            self._m_backoff = metrics.gauge(
                "retry.backoff.seconds",
                "cumulative seconds spent in retry backoff")

    def expired(self) -> bool:
        return (self.policy.deadline is not None
                and self.clock() - self.start >= self.policy.deadline)

    def remaining(self) -> Optional[float]:
        """Wall budget left, or None when no deadline is set."""
        if self.policy.deadline is None:
            return None
        return max(self.policy.deadline - (self.clock() - self.start),
                   0.0)

    def __iter__(self):
        while self.attempt < self.policy.max_attempts:
            if self.attempt > 0 and self.expired():
                return
            if self._m_attempts is not None:
                self._m_attempts.inc()
            yield self.attempt
            self.attempt += 1

    def next_backoff(self) -> float:
        """Backoff for the upcoming attempt, clipped to the deadline."""
        b = self.policy.backoff(self.attempt, self.rng)
        rem = self.remaining()
        if rem is not None:
            b = min(b, rem)
        return b

    def wait(self) -> None:
        b = self.next_backoff()
        if self._m_backoff is not None and b > 0:
            self._m_backoff.inc(b)
        if b > 0:
            time.sleep(b)
