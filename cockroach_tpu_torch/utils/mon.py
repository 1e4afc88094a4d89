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
    monitor tree collapses to (pool, account)).

    ``owner()``, when given, names who makes each reservation (the
    engine passes the executing statement's tenant): an account belongs
    to the owner of its first reservation, and ``owner_peak`` is the
    most an owner's accounts held at once, the tenant's own HBM
    high-water."""

    def __init__(self, name: str, limit: Callable[[], int] | int,
                 owner: Callable[[], str] | None = None):
        self.name = name
        self._limit = limit if callable(limit) else (lambda: limit)
        self._used = 0
        self._accounts: dict[object, int] = {}
        self._lock = threading.Lock()
        self._owner = owner
        self._owner_of: dict[object, str] = {}
        self._owner_used: dict[str, int] = {}
        self._owner_peak: dict[str, int] = {}

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
            if self._owner is not None:
                who = self._owner_of.setdefault(account, self._owner())
                held = self._owner_used.get(who, 0) + nbytes
                self._owner_used[who] = held
                if held > self._owner_peak.get(who, 0):
                    self._owner_peak[who] = held

    def release(self, account) -> int:
        """Release everything held by ``account``."""
        with self._lock:
            n = self._accounts.pop(account, 0)
            self._used -= n
            who = self._owner_of.pop(account, None)
            if who is not None:
                self._owner_used[who] -= n
            return n

    def account_bytes(self, account) -> int:
        return self._accounts.get(account, 0)

    def owner_peak(self, owner: str) -> int | None:
        """The most ``owner``'s accounts held at once, or None when it
        never reserved."""
        with self._lock:
            return self._owner_peak.get(owner)
