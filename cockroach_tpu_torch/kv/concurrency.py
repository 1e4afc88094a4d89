"""Concurrency control: span latches, timestamp cache, txn wait/push.

The analogue of pkg/kv/kvserver/concurrency (concurrency_manager.go:184
SequenceReq = latches + lock table + txnwait) and pkg/kv/kvserver/
tscache. Single-process scope: these structures guard one store's
keyspace; the distribution layer routes requests to the store owning a
range, exactly as Replica.Send sequences through its own latch manager.

- SpanLatchManager: short-lived R/W latches over key spans held for
  the duration of one request's evaluation (spanlatch/manager.go:59).
- TimestampCache: high-water read timestamps per span; writers must
  write above them (tscache intervalSkl semantics, flat list impl).
- TxnRegistry + push: txn records (PENDING/COMMITTED/ABORTED) with
  heartbeats; a reader/writer blocked on an intent pushes the owner —
  waits while the owner is live, aborts it when expired (txnwait queue
  + batcheval/cmd_push_txn.go PUSH_ABORT/PUSH_TIMESTAMP semantics,
  simplified to deadlock-by-timeout)."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..storage.hlc import Timestamp
from ..storage.mvcc import TxnMeta, TxnStatus


@dataclass
class Span:
    start: bytes
    end: bytes = b""  # empty = point span

    def _end(self) -> bytes:
        return self.end if self.end else self.start + b"\x00"

    def overlaps(self, other: "Span") -> bool:
        return self.start < other._end() and other.start < self._end()


@dataclass
class _Latch:
    span: Span
    write: bool
    owner: int  # request id


class SpanLatchManager:
    """Blocking span latches: writes conflict with everything
    overlapping; reads conflict with writes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._held: dict[int, list[_Latch]] = {}
        self._next_id = 0

    def acquire(self, spans: list[tuple[Span, bool]],
                timeout: float = 30.0) -> int:
        """spans: [(span, is_write)]. Returns a guard id for release."""
        deadline = time.monotonic() + timeout
        with self._cond:
            req = self._next_id
            self._next_id += 1
            while True:
                if not self._conflicts(spans):
                    self._held[req] = [_Latch(s, w, req) for s, w in spans]
                    return req
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError("latch acquisition timed out")
                self._cond.wait(remaining)

    def _conflicts(self, spans: list[tuple[Span, bool]]) -> bool:
        for latches in self._held.values():
            for lt in latches:
                for s, w in spans:
                    if (w or lt.write) and lt.span.overlaps(s):
                        return True
        return False

    def release(self, guard: int) -> None:
        with self._cond:
            self._held.pop(guard, None)
            self._cond.notify_all()


class TimestampCache:
    """Per-span high-water read timestamps (tscache). Writers consult
    get_max to avoid rewriting history beneath a served read."""

    # capacity discipline: every write's get_max scans the range-span
    # list linearly, so its length IS the per-write cost (measured:
    # ~1.9ms/write at the old 4096 cap under YCSB-E, where 95% scans
    # keep the list full). Point reads — the hot OLTP shape — live in
    # a dict keyed by start (O(1) for point writes); folding rotates
    # the oldest half into the low-water mark, exactly the reference's
    # tscache page rotation (spurious pushes only for reads older
    # than the fold, which the retry loop absorbs).
    SPAN_CAP = 512
    POINT_CAP = 8192

    def __init__(self, low_water: Optional[Timestamp] = None):
        self._lock = threading.Lock()
        # (start, end, ts, reader_txn_id) — the id lets a txn's own
        # reads not push its own writes (tscache stores txn IDs for
        # exactly this, tscache/cache.go)
        self._spans: list[tuple[bytes, bytes, Timestamp, Optional[str]]] = []
        # point reads: start -> (ts, reader_txn_id)
        self._points: dict[bytes, tuple[Timestamp, Optional[str]]] = {}
        self.low_water = low_water or Timestamp(0, 0)

    def add(self, span: Span, ts: Timestamp,
            txn_id: Optional[str] = None) -> None:
        end = span._end()
        with self._lock:
            if end == span.start + b"\x00":
                cur = self._points.get(span.start)
                if cur is None or cur[0] < ts:
                    self._points[span.start] = (ts, txn_id)
                elif cur[0] == ts and cur[1] != txn_id:
                    # two txns read at the same ts: the entry must
                    # block BOTH from writing beneath it — coalesce by
                    # clearing the owner (tscache/cache.go does the
                    # same on ratchet ties)
                    self._points[span.start] = (ts, None)
                if len(self._points) > self.POINT_CAP:
                    items = sorted(self._points.items(),
                                   key=lambda kv: kv[1][0])
                    half = len(items) // 2
                    self.low_water = max(self.low_water,
                                         items[half - 1][1][0])
                    self._points = dict(items[half:])
                return
            # _spans stays sorted by ts ascending: get_max scans from
            # the newest end and stops at the first entry at-or-below
            # its running floor — O(1) for the hot OLTP shape where
            # the newest scan span covers the write
            import bisect
            bisect.insort(self._spans, (span.start, end, ts, txn_id),
                          key=lambda e: e[2])
            if len(self._spans) > self.SPAN_CAP:
                # rotate: fold oldest half into the low-water mark
                half = len(self._spans) // 2
                self.low_water = max(self.low_water, self._spans[half - 1][2])
                self._spans = self._spans[half:]

    def get_max(self, span: Span, exclude: Optional[str] = None) -> Timestamp:
        end = span._end()
        with self._lock:
            hi = self.low_water
            if end == span.start + b"\x00":
                # point query: O(1) against the point table
                p = self._points.get(span.start)
                if p is not None and p[0] > hi and \
                        (exclude is None or p[1] != exclude):
                    hi = p[0]
            else:
                for k, (t, rid) in self._points.items():
                    if span.start <= k < end and t > hi and \
                            (exclude is None or rid != exclude):
                        hi = t
            for s, e, t, rid in reversed(self._spans):
                if t <= hi:
                    break          # sorted by ts: nothing newer left
                if exclude is not None and rid == exclude:
                    continue
                if s < end and span.start < e:
                    hi = t
            return hi


@dataclass
class TxnRecord:
    meta: TxnMeta
    status: TxnStatus = TxnStatus.PENDING
    commit_ts: Optional[Timestamp] = None
    last_heartbeat: float = field(default_factory=time.monotonic)


class TxnRegistry:
    """Txn records + push logic (the txn table lives in the system
    keyspace in the reference, batcheval/cmd_end_transaction.go; kept
    in memory here and checkpointed by the replication layer)."""

    HEARTBEAT_EXPIRY = 2.0  # seconds without heartbeat = expired

    def __init__(self):
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._records: dict[str, TxnRecord] = {}

    def begin(self, meta: TxnMeta) -> TxnRecord:
        with self._lock:
            rec = TxnRecord(meta=meta)
            self._records[meta.id] = rec
            return rec

    def get(self, txn_id: str) -> Optional[TxnRecord]:
        with self._lock:
            return self._records.get(txn_id)

    def remove(self, txn_id: str) -> None:
        """Evict a finished record. Only safe once the txn's intents
        are all resolved: push() maps unknown ids to ABORTED."""
        with self._lock:
            self._records.pop(txn_id, None)

    def heartbeat(self, txn_id: str) -> bool:
        with self._cond:
            rec = self._records.get(txn_id)
            if rec is None or rec.status != TxnStatus.PENDING:
                return False
            rec.last_heartbeat = time.monotonic()
            return True

    def end(self, txn_id: str, status: TxnStatus,
            commit_ts: Optional[Timestamp] = None) -> TxnRecord:
        with self._cond:
            rec = self._records[txn_id]
            if rec.status == TxnStatus.ABORTED and status == TxnStatus.COMMITTED:
                raise TxnAbortedError(txn_id)
            if rec.status == TxnStatus.PENDING:
                rec.status = status
                rec.commit_ts = commit_ts
            self._cond.notify_all()
            return rec

    def push(self, pushee: TxnMeta, push_abort: bool = False,
             timeout: float = 1.0) -> TxnRecord:
        """Block until the pushee finishes, expires, or the wait times
        out — then force-abort it (deadlock-by-timeout; the reference
        detects cycles in the txnwait queue instead)."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                rec = self._records.get(pushee.id)
                if rec is None:
                    # unknown txn: its record was evicted after full
                    # resolution, or it crashed — either way its
                    # leftover intents are removable (recovery path)
                    return TxnRecord(meta=pushee, status=TxnStatus.ABORTED)
                if rec.status != TxnStatus.PENDING:
                    return rec
                expired = (time.monotonic() - rec.last_heartbeat
                           > self.HEARTBEAT_EXPIRY)
                timed_out = time.monotonic() >= deadline
                if expired or (timed_out and push_abort):
                    rec.status = TxnStatus.ABORTED
                    self._cond.notify_all()
                    return rec
                if timed_out:
                    return rec  # caller decides (e.g. retry read)
                self._cond.wait(0.05)


class TxnAbortedError(Exception):
    def __init__(self, txn_id: str):
        super().__init__(f"txn {txn_id[:8]} aborted")
        self.txn_id = txn_id


class TxnRetryError(Exception):
    """Retryable: restart the txn at a higher timestamp (the analogue
    of TransactionRetryWithProtoRefreshError)."""

    def __init__(self, reason: str, retry_ts: Optional[Timestamp] = None):
        super().__init__(reason)
        self.retry_ts = retry_ts
