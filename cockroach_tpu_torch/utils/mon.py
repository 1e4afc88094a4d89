"""Memory accounting: budgeted byte reservations for device memory
(cockroach_tpu/utils/mon.py). The engine reserves an upload's bytes
BEFORE it copies them to the card, so an over-budget query fails with
a clean quota error naming the knob to turn instead of a CUDA
out-of-memory error."""

from __future__ import annotations

import threading
from typing import Callable


class MemoryQuotaError(Exception):
    pass


class BytesMonitor:
    """One budgeted pool with named accounts (flat: the reference's
    monitor tree collapses to (pool, account))."""

    def __init__(self, name: str, limit: Callable[[], int] | int):
        self.name = name
        self._limit = limit if callable(limit) else (lambda: limit)
        self._used = 0
        self._accounts: dict[object, int] = {}
        self._lock = threading.Lock()

    @property
    def used(self) -> int:
        return self._used

    @property
    def limit(self) -> int:
        return int(self._limit())

    def reserve(self, account, nbytes: int) -> None:
        """Grow ``account`` by nbytes; raises MemoryQuotaError if the
        pool would pass its limit (no partial reservation)."""
        with self._lock:
            limit = self.limit
            if limit > 0 and self._used + nbytes > limit:
                raise MemoryQuotaError(
                    f"{self.name}: reserving {nbytes} bytes for "
                    f"{account!r} exceeds budget ({self._used} of "
                    f"{limit} in use); drop cached tables or raise "
                    f"the budget setting sql.exec.hbm_budget_bytes")
            self._used += nbytes
            self._accounts[account] = self._accounts.get(account, 0) + nbytes

    def release(self, account) -> int:
        """Release everything held by ``account``."""
        with self._lock:
            n = self._accounts.pop(account, 0)
            self._used -= n
            return n

    def account_bytes(self, account) -> int:
        return self._accounts.get(account, 0)
