"""Hybrid logical clocks (the analogue of pkg/util/hlc).

``Clock.now`` returns monotone timestamps combining wall time with a
logical counter (hlc.go:43,356); ``update`` forwards the clock on
message receipt so causally-related events order correctly across
nodes without synchronized clocks. MaxOffset (hlc.go:294) bounds clock
skew for uncertainty intervals in MVCC reads.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass


@dataclass(frozen=True)
class Timestamp:
    wall: int  # nanoseconds
    logical: int = 0

    # all six comparisons spelled out: functools.total_ordering's
    # derived wrappers were ~15% of a measured OLTP op (the tscache
    # floor scan compares hundreds of Timestamps per write)
    def __lt__(self, other: "Timestamp") -> bool:
        return self.wall < other.wall or (
            self.wall == other.wall and self.logical < other.logical)

    def __le__(self, other: "Timestamp") -> bool:
        return self.wall < other.wall or (
            self.wall == other.wall and self.logical <= other.logical)

    def __gt__(self, other: "Timestamp") -> bool:
        return self.wall > other.wall or (
            self.wall == other.wall and self.logical > other.logical)

    def __ge__(self, other: "Timestamp") -> bool:
        return self.wall > other.wall or (
            self.wall == other.wall and self.logical >= other.logical)

    def __eq__(self, other) -> bool:
        return (self.wall, self.logical) == (other.wall, other.logical)

    def __hash__(self):
        return hash((self.wall, self.logical))

    def next(self) -> "Timestamp":
        if self.logical >= 0xFFF:
            return Timestamp(self.wall + 0x1000, 0)
        return Timestamp(self.wall, self.logical + 1)

    def prev(self) -> "Timestamp":
        if self.logical > 0:
            return Timestamp(self.wall, self.logical - 1)
        return Timestamp(self.wall - 0x1000, 0xFFF)

    @property
    def is_empty(self) -> bool:
        return self.wall == 0 and self.logical == 0

    def to_int(self) -> int:
        """Pack into int64 for device-side MVCC columns. The clock
        quantizes wall nanos to 4096ns, so the low 12 bits of wall are
        free to carry the logical counter: the packing is bijective and
        order-preserving, and fits int64 until year ~2116."""
        return self.wall | (self.logical & 0xFFF)

    @staticmethod
    def from_int(v: int) -> "Timestamp":
        return Timestamp(v & ~0xFFF, v & 0xFFF)

    def __repr__(self):
        return f"{self.wall}.{self.logical}"


MIN_TIMESTAMP = Timestamp(0, 1)
MAX_TIMESTAMP = Timestamp((1 << 62) - 0x1000, 0)


class Clock:
    """Thread-safe HLC. Wall time is quantized to 4096ns so logical
    ticks pack into the low 12 bits of the int64 encoding (to_int)."""

    def __init__(self, max_offset_ns: int = 500_000_000,
                 wall_fn=None):
        self._lock = threading.Lock()
        self._wall_fn = wall_fn or time.time_ns
        self._last = Timestamp(0, 0)
        self.max_offset_ns = max_offset_ns

    def _wall(self) -> int:
        return self._wall_fn() & ~0xFFF

    def now(self) -> Timestamp:
        with self._lock:
            wall = self._wall()
            if wall > self._last.wall:
                self._last = Timestamp(wall, 0)
            else:
                self._last = self._last.next()
            return self._last

    def update(self, remote: Timestamp) -> Timestamp:
        """Forward the clock past a received timestamp (hlc.Update)."""
        with self._lock:
            cands = [Timestamp(self._wall(), 0), self._last.next(),
                     remote.next()]
            self._last = max(cands)
            return self._last

    def now_int(self) -> int:
        """``now()`` packed as ``Timestamp.to_int``."""
        return self.now().to_int()
