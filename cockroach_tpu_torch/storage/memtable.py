"""Sorted in-memory write buffer (the LSM memtable).

The analogue of Pebble's memtable (the reference's storage engine,
pkg/storage via cockroachdb/pebble). A bisect-maintained sorted key
list over a dict gives O(log n) point ops and ordered iteration
without a C skiplist; the C++ fast path (storage/native) replaces the
merge-heavy scan paths, not this buffer.

Entries map EngineKey -> value bytes | None (None = engine-level
tombstone, shadowing older SST entries until compaction drops both).
"""

from __future__ import annotations

import bisect
from typing import Iterator, Optional

from .keys import EngineKey


class Memtable:
    def __init__(self):
        self._keys: list[EngineKey] = []
        self._map: dict[EngineKey, Optional[bytes]] = {}
        self.size_bytes = 0

    def __len__(self) -> int:
        return len(self._keys)

    def put(self, key: EngineKey, value: Optional[bytes]) -> None:
        if key not in self._map:
            bisect.insort(self._keys, key)
            self.size_bytes += len(key.key) + 16
        else:
            old = self._map[key]
            self.size_bytes -= len(old) if old else 0
        self._map[key] = value
        self.size_bytes += len(value) if value else 0

    def get(self, key: EngineKey):
        """Returns (found, value)."""
        if key in self._map:
            return True, self._map[key]
        return False, None

    def iter_range(self, start: EngineKey,
                   end: Optional[EngineKey] = None
                   ) -> Iterator[tuple[EngineKey, Optional[bytes]]]:
        i = bisect.bisect_left(self._keys, start)
        while i < len(self._keys):
            k = self._keys[i]
            if end is not None and not k < end:
                return
            yield k, self._map[k]
            i += 1

    def entries(self) -> list[tuple[EngineKey, Optional[bytes]]]:
        return [(k, self._map[k]) for k in self._keys]
