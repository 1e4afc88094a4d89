"""Range descriptor / leaseholder cache (pkg/kv/kvclient/rangecache)
(cockroach_tpu/kv/rangecache.py).

The DistSender consults this cache to route key spans to replicas
without a meta lookup per request; entries are evicted when routing
errors prove them stale (rangecache.go's EvictionToken flow).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Optional

from cockroach_tpu_torch.kvserver.store import RangeDescriptor


@dataclass
class CacheEntry:
    desc: RangeDescriptor
    leaseholder: Optional[int] = None


class RangeCache:
    """Ordered map start_key -> CacheEntry over non-overlapping ranges."""

    def __init__(self):
        self._starts: list[bytes] = []
        self._entries: dict[bytes, CacheEntry] = {}
        self.lookups = 0
        self.misses = 0

    def insert(self, desc: RangeDescriptor,
               leaseholder: Optional[int] = None) -> None:
        # drop any cached entries this descriptor overlaps (stale
        # pre-split/pre-merge views)
        for s in [s for s in self._starts
                  if self._entries[s].desc.end_key > desc.start_key
                  and s < desc.end_key]:
            self._starts.remove(s)
            del self._entries[s]
        bisect.insort(self._starts, desc.start_key)
        self._entries[desc.start_key] = CacheEntry(desc, leaseholder)

    def lookup(self, key: bytes) -> Optional[CacheEntry]:
        self.lookups += 1
        i = bisect.bisect_right(self._starts, key) - 1
        if i < 0:
            self.misses += 1
            return None
        e = self._entries[self._starts[i]]
        if not e.desc.contains(key):
            self.misses += 1
            return None
        return e

    def evict(self, key: bytes) -> None:
        i = bisect.bisect_right(self._starts, key) - 1
        if i >= 0:
            s = self._starts[i]
            if self._entries[s].desc.contains(key):
                self._starts.pop(i)
                del self._entries[s]

    def update_leaseholder(self, key: bytes, node_id: int) -> None:
        e = self.lookup(key)
        if e is not None:
            e.leaseholder = node_id
