"""Descriptor leases: cached schema versions under a drain protocol.

The port of cockroach_tpu/catalog/lease.py (the reference's
pkg/sql/catalog/lease: Acquire lease.go:672, WaitForOneVersion :990). A
planner leases (descriptor id, version) until an expiration and plans
from the leased copy; a schema changer publishes version v+1 and then
waits until no live lease is left on an older version (the two-version
invariant), so at most two consecutive versions are ever in use.

Leases are KV records at /lease/<desc_id>/<version>/<holder>, their
value the expiration in wall nanoseconds, so an expired lease (a holder
that died) never blocks a publish.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass

from .catalog import Catalog, CatalogError
from .descriptor import TableDescriptor

LEASE_PREFIX = b"/lease/"
DEFAULT_LEASE_NS = int(5 * 60 * 1e9)  # 5 min, the reference's default


def _version_prefix(desc_id: int, version: int) -> bytes:
    return (LEASE_PREFIX + str(desc_id).zfill(8).encode() + b"/"
            + str(version).zfill(8).encode() + b"/")


def lease_key(desc_id: int, version: int, holder: str) -> bytes:
    return _version_prefix(desc_id, version) + holder.encode()


@dataclass
class LeasedDescriptor:
    desc: TableDescriptor
    expiration_ns: int
    holder: str


class LeaseManager:
    """One holder's leases over a catalog."""

    def __init__(self, catalog: Catalog, holder: str, now_ns=None,
                 duration_ns: int = DEFAULT_LEASE_NS):
        self.catalog = catalog
        self.kv = catalog.kv
        self.holder = holder
        self.now_ns = now_ns or (lambda: int(_time.time() * 1e9))
        self.duration_ns = duration_ns
        # the holder's cache: desc_id -> LeasedDescriptor
        self._cache: dict[int, LeasedDescriptor] = {}

    def acquire(self, name: str) -> LeasedDescriptor:
        """Lease the current version of the named table, from the cache
        while the cached lease is live and current."""
        d = self.catalog.get_by_name(name)
        if d is None:
            raise CatalogError(f"table {name!r} does not exist")
        cached = self._cache.get(d.id)
        if cached is not None and cached.desc.version == d.version \
                and cached.expiration_ns > self.now_ns():
            return cached
        if cached is not None:
            self._release_entry(cached)
        exp = self.now_ns() + self.duration_ns
        self.kv.txn(lambda t: t.put(lease_key(d.id, d.version, self.holder),
                                    str(exp).encode()))
        leased = LeasedDescriptor(d, exp, self.holder)
        self._cache[d.id] = leased
        return leased

    def release(self, leased: LeasedDescriptor) -> None:
        self._release_entry(leased)
        self._cache.pop(leased.desc.id, None)

    def _release_entry(self, leased: LeasedDescriptor) -> None:
        self.kv.txn(lambda t: t.delete(
            lease_key(leased.desc.id, leased.desc.version, leased.holder)))

    def release_all(self) -> None:
        for leased in list(self._cache.values()):
            self.release(leased)

    # -- the two-version invariant ------------------------------------------
    def count_leases(self, desc_id: int, version: int) -> int:
        """Live (unexpired) leases on (desc, version), any holder."""
        start = _version_prefix(desc_id, version)
        now = self.now_ns()

        def fn(t):
            return sum(1 for _k, v in t.scan(start, start + b"\xff")
                       if int(v.decode()) > now)
        return self.kv.txn(fn)

    def wait_one_version(self, desc_id: int, timeout_s: float = 10.0,
                         poll_s: float = 0.01) -> None:
        """Block until no live lease is left on a version older than the
        current one (lease.go:990 WaitForOneVersion)."""
        deadline = _time.monotonic() + timeout_s
        while True:
            d = self.catalog.get_by_id(desc_id)
            if d is None:
                raise CatalogError(f"descriptor {desc_id} missing")
            stale = sum(self.count_leases(desc_id, v)
                        for v in range(max(1, d.version - 2), d.version))
            if stale == 0:
                return
            if _time.monotonic() > deadline:
                raise CatalogError(
                    f"timed out waiting for {stale} lease(s) on old "
                    f"versions of descriptor {desc_id}")
            _time.sleep(poll_s)

    def publish(self, desc: TableDescriptor,
                timeout_s: float = 10.0) -> TableDescriptor:
        """Write version+1 and wait for the old leases to drain: one step
        of a schema change."""
        out = self.catalog.write_new_version(desc)
        self.wait_one_version(out.id, timeout_s=timeout_s)
        return out
