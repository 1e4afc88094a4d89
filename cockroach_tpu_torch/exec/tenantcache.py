"""Tenant-partitioned plan/parse caches (the quota plane's cache side).

``TenantLRU`` is an insertion-ordered cache with two eviction tiers:

1. A **per-tenant entry budget** (``tenant_budget``, 0 = off): a
   tenant inserting past its budget evicts its *own* oldest entries
   first, so a noisy tenant churning novel statement shapes can never
   push another tenant's compiled executables out of the cache. This
   is the cache-side complement of the admission controller's slot /
   HBM ledger — quotas at dispatch AND at the memory the dispatch
   leaves behind.
2. The pre-existing **global cap** (``max_entries``): when the
   aggregate across all tenants reaches the cap, the oldest half is
   dropped regardless of owner — the same pressure valve the flat
   dict had, kept bit-compatible so seed tests observe identical
   eviction counts when partitioning is off.

It subclasses ``dict`` so the hot read path (``cache.get(key)`` from
the execute inner loop and the scanplane mixin) pays no wrapper cost
and existing code/tests using ``len`` / ``in`` / iteration /
``clear()`` work unchanged. Tenant attribution happens only on the
write path via ``put(key, val, tenant=...)``; plain ``cache[k] = v``
stores untagged (tenant "" is exempt from budgets).

The port's copy of cockroach_tpu/exec/tenantcache.py, with ``touch``
for the exec cache's move-to-end on a hit.
"""

from __future__ import annotations


class TenantLRU(dict):
    def __init__(self, max_entries: int, on_evict=None):
        super().__init__()
        self.max_entries = max_entries
        # entries one tenant may hold before self-eviction (0 = off);
        # refreshed from sql.exec.plan_cache.tenant_budget
        self.tenant_budget = 0
        # called with each evicted key (parse cache uses it to drop
        # the matching _plain_memo entry)
        self.on_evict = on_evict
        self._tenant_of: dict = {}            # key -> tenant
        self._tenant_keys: dict = {}          # tenant -> {key: None}
        self.tenant_evictions: dict = {}      # tenant -> self-evictions

    # -- write path -----------------------------------------------------------

    def put(self, key, val, tenant: str = "") -> None:
        if key in self:
            self._untag(key)
        elif tenant and self.tenant_budget:
            keys = self._tenant_keys.get(tenant)
            while keys and len(keys) >= self.tenant_budget:
                oldest = next(iter(keys))
                self._evict(oldest)
                self.tenant_evictions[tenant] = (
                    self.tenant_evictions.get(tenant, 0) + 1)
        if key not in self and len(self) >= self.max_entries:
            for k in list(self)[: self.max_entries // 2]:
                self._evict(k)
        super().__setitem__(key, val)
        if tenant:
            self._tenant_of[key] = tenant
            self._tenant_keys.setdefault(tenant, {})[key] = None

    def __setitem__(self, key, val) -> None:
        self.put(key, val)

    def touch(self, key) -> None:
        """Move ``key`` to the newest end (an LRU hit), keeping its
        tenant."""
        val = super().pop(key)
        super().__setitem__(key, val)
        t = self._tenant_of.get(key, "")
        if t:
            keys = self._tenant_keys[t]
            keys.pop(key, None)
            keys[key] = None

    # -- removal --------------------------------------------------------------

    def _untag(self, key) -> None:
        t = self._tenant_of.pop(key, "")
        if t:
            keys = self._tenant_keys.get(t)
            if keys is not None:
                keys.pop(key, None)
                if not keys:
                    del self._tenant_keys[t]

    def _evict(self, key) -> None:
        self._untag(key)
        super().__delitem__(key)
        if self.on_evict is not None:
            self.on_evict(key)

    def __delitem__(self, key) -> None:
        self._untag(key)
        super().__delitem__(key)

    def pop(self, key, *default):
        self._untag(key)
        return super().pop(key, *default)

    def clear(self) -> None:
        super().clear()
        self._tenant_of.clear()
        self._tenant_keys.clear()

    # -- introspection --------------------------------------------------------

    def tenant_entry_counts(self) -> dict:
        return {t: len(keys) for t, keys in self._tenant_keys.items()}
