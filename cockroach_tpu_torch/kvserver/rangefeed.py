"""Rangefeed: per-range committed-write event streams (CDC primitive)
(cockroach_tpu/kvserver/rangefeed.py).

The analogue of pkg/kv/kvserver/rangefeed (processor.go:113 Processor,
catchup_scan.go): a registration over a key span receives

1. a catch-up scan of committed versions newer than its start ts,
2. live "value" events as writes commit on the range (emitted at
   apply time, so every replica sees them in log order; intents only
   emit when they RESOLVE to commit), and
3. "checkpoint" events carrying the resolved timestamp — the closed
   timestamp clamped below the oldest live intent — promising no
   further events at or below it.

Registrations are buffered queues the consumer drains (the reference
pushes over gRPC streams; here the changefeed job drains directly).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from ..storage.hlc import Timestamp


@dataclass
class RangefeedEvent:
    kind: str  # "value" | "checkpoint"
    key: bytes = b""
    value: Optional[bytes] = None  # None = deletion tombstone
    ts: Timestamp = None


@dataclass
class Registration:
    start_key: bytes
    end_key: bytes
    events: deque = field(default_factory=deque)
    resolved: Timestamp = Timestamp(0, 0)

    def matches(self, key: bytes) -> bool:
        return self.start_key <= key < self.end_key

    def drain(self) -> list[RangefeedEvent]:
        out = list(self.events)
        self.events.clear()
        return out


class Processor:
    """One per replica; fed by the apply loop and the closed-ts plane."""

    def __init__(self, replica):
        self.replica = replica
        self.regs: list[Registration] = []

    def register(self, start_key: bytes, end_key: bytes,
                 start_ts: Timestamp) -> Registration:
        reg = Registration(start_key, end_key)
        # catch-up: committed history since start_ts, in ts order
        for mv in self.replica.mvcc.committed_versions_after(
                start_key, end_key, start_ts):
            reg.events.append(RangefeedEvent(
                "value", mv.key, mv.value, mv.ts))
        self.regs.append(reg)
        return reg

    def unregister(self, reg: Registration) -> None:
        if reg in self.regs:
            self.regs.remove(reg)

    # -- feed points ---------------------------------------------------------
    def on_value(self, key: bytes, value: Optional[bytes],
                 ts: Timestamp) -> None:
        for reg in self.regs:
            if reg.matches(key):
                reg.events.append(RangefeedEvent("value", key, value, ts))

    def on_closed(self, closed: Timestamp) -> None:
        if not self.regs:
            return
        # resolved = closed clamped below the oldest live intent: an
        # unresolved txn may still commit at its (old) write ts
        oldest = self.replica.mvcc.oldest_intent_ts(
            self.replica.desc.start_key, self.replica.desc.end_key)
        resolved = closed
        if oldest is not None and not oldest > resolved:
            resolved = (Timestamp(oldest.wall, oldest.logical - 1)
                        if oldest.logical > 0
                        else Timestamp(oldest.wall - 1, 0))
        for reg in self.regs:
            if reg.resolved < resolved:
                reg.resolved = resolved
                reg.events.append(RangefeedEvent(
                    "checkpoint", ts=resolved))
