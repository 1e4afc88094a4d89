"""Transactional KV client: Txn coordination over MVCC + concurrency.

The analogue of pkg/kv (DB/Txn, db.go:896 retry loop) and kvcoord's
TxnCoordSender interceptor stack (txn_coord_sender.go:108):

- heartbeater: each op heartbeats the txn record (registry expiry
  fences abandoned txns, the epoch-lease analogue at txn scope);
- seq-num allocator: per-op sequence numbers on writes;
- span refresher: if the write ts got pushed above the read ts,
  commit first verifies no committed writes landed in any read span
  in (read_ts, write_ts] and silently advances the read ts —
  otherwise TxnRetryError restarts the txn (txn_interceptor_span_
  refresher.go);
- committer: EndTxn marks the record, then resolves intents at the
  commit timestamp (parallel commits are a later optimization).

Each request sequences through the store's latch manager and bumps
the timestamp cache, mirroring Replica.Send → concurrency.SequenceReq.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from ..storage.hlc import Clock, Timestamp
from ..storage.lsm import LSM
from ..storage.mvcc import (MVCC, TxnMeta, TxnStatus, WriteIntentError,
                            WriteTooOldError)
from .concurrency import (Span, SpanLatchManager, TimestampCache,
                          TxnAbortedError, TxnRegistry, TxnRetryError)


class KVStore:
    """One store: MVCC engine + its concurrency control plane (the
    single-range analogue of kvserver.Store)."""

    def __init__(self, engine: Optional[LSM] = None,
                 clock: Optional[Clock] = None):
        self.mvcc = MVCC(engine)
        self.latches = SpanLatchManager()
        self.tscache = TimestampCache()
        self.txns = TxnRegistry()
        self.clock = clock or Clock()
        # async batch intent cleanup (intentresolver analogue); the
        # sweep is driven by the node maintenance loop
        from .intentresolver import IntentResolver
        self.intent_resolver = IntentResolver(self)


class Txn:
    """A client transaction handle. Not thread-safe (one goroutine per
    txn, like kv.Txn)."""

    def __init__(self, store: KVStore):
        self.store = store
        now = store.clock.now()
        self.meta = TxnMeta(write_ts=now, read_ts=now)
        self.meta.key = b"txn-" + self.meta.id.encode()[:8]
        self._rec = store.txns.begin(self.meta)
        self.read_spans: list[Span] = []
        self.intent_keys: list[bytes] = []
        self.finished = False

    # -- internal ----------------------------------------------------------
    def _check_alive(self):
        rec = self.store.txns.get(self.meta.id)
        if rec is not None and rec.status == TxnStatus.ABORTED:
            raise TxnAbortedError(self.meta.id)
        self.store.txns.heartbeat(self.meta.id)

    def _handle_intent(self, err: WriteIntentError) -> None:
        """Push the conflicting txn, then resolve its intent."""
        rec = self.store.txns.push(err.txn_meta, push_abort=True)
        if rec.status == TxnStatus.PENDING:
            raise TxnRetryError("conflicting txn still pending")
        commit_ts = rec.commit_ts if rec.status == TxnStatus.COMMITTED \
            else None
        self.store.mvcc.resolve_intent(err.key, err.txn_meta, rec.status,
                                       commit_ts)

    def _with_latch(self, spans, fn):
        guard = self.store.latches.acquire(spans)
        try:
            return fn()
        finally:
            self.store.latches.release(guard)

    # -- reads -------------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        self._check_alive()
        span = Span(key)

        def do():
            mv = self.store.mvcc.get(key, self.meta.read_ts, txn=self.meta)
            # tscache bump must happen before the latch drops, or a
            # concurrent writer could sneak beneath the served read
            self.store.tscache.add(span, self.meta.read_ts, self.meta.id)
            return mv

        while True:
            try:
                mv = self._with_latch([(span, False)], do)
                break
            except WriteIntentError as e:
                self._handle_intent(e)
        self.read_spans.append(span)
        return mv.value if mv is not None else None

    def scan(self, start: bytes, end: bytes,
             max_keys: int = 0) -> list[tuple[bytes, bytes]]:
        self._check_alive()
        span = Span(start, end)

        def do():
            res = self.store.mvcc.scan(
                start, end, self.meta.read_ts, txn=self.meta,
                max_keys=max_keys)
            self.store.tscache.add(span, self.meta.read_ts, self.meta.id)
            return res

        while True:
            try:
                res = self._with_latch([(span, False)], do)
                break
            except WriteIntentError as e:
                self._handle_intent(e)
        self.read_spans.append(span)
        return [(mv.key, mv.value) for mv in res]

    # -- writes ------------------------------------------------------------
    def _write(self, key: bytes, value: Optional[bytes]) -> None:
        self._check_alive()
        self.meta.seq += 1
        span = Span(key)

        def do():
            # the timestamp cache fences writes below served reads;
            # our own reads don't push our writes (entries are tagged
            # with the reader's txn id, as in the reference's tscache)
            floor = self.store.tscache.get_max(span, exclude=self.meta.id)
            if floor >= self.meta.write_ts:
                self.meta.write_ts = floor.next()
            self.store.mvcc.put(key, self.meta.write_ts, value,
                                txn=self.meta)

        while True:
            try:
                self._with_latch([(span, True)], do)
                self.intent_keys.append(key)
                return
            except WriteIntentError as e:
                self._handle_intent(e)

    def put(self, key: bytes, value: bytes) -> None:
        self._write(key, value)

    def delete(self, key: bytes) -> None:
        self._write(key, None)

    def delete_range(self, start: bytes, end: bytes) -> int:
        victims = self.scan(start, end)
        for k, _ in victims:
            self._write(k, None)
        return len(victims)

    # -- lifecycle -----------------------------------------------------------
    def _refresh_reads(self) -> None:
        """Span refresher: advance read_ts to write_ts iff no committed
        write landed in any read span in between."""
        if self.meta.write_ts <= self.meta.read_ts:
            return
        for span in self.read_spans:
            if self.store.mvcc.has_writes_between(
                    span.start, span._end(), self.meta.read_ts,
                    self.meta.write_ts, exclude_txn=self.meta.id):
                raise TxnRetryError("read refresh failed",
                                    retry_ts=self.meta.write_ts)
        self.meta.read_ts = self.meta.write_ts

    def commit(self) -> Timestamp:
        if self.finished:
            raise ValueError("txn already finished")
        self._check_alive()
        self._refresh_reads()
        rec = self.store.txns.end(self.meta.id, TxnStatus.COMMITTED,
                                  commit_ts=self.meta.write_ts)
        if rec.status == TxnStatus.ABORTED:
            raise TxnAbortedError(self.meta.id)
        self.finished = True
        for k in self.intent_keys:
            self.store.mvcc.resolve_intent(k, self.meta,
                                           TxnStatus.COMMITTED,
                                           self.meta.write_ts)
        # record is only evictable once every intent is resolved:
        # pushers finding an intent of an unknown txn treat it as
        # aborted (recovery), which would be wrong before this point
        self.store.txns.remove(self.meta.id)
        return self.meta.write_ts

    def rollback(self) -> None:
        if self.finished:
            return
        self.finished = True
        try:
            self.store.txns.end(self.meta.id, TxnStatus.ABORTED)
        except KeyError:
            pass
        for k in self.intent_keys:
            self.store.mvcc.resolve_intent(k, self.meta, TxnStatus.ABORTED)
        self.store.txns.remove(self.meta.id)

    def _restart(self) -> None:
        """Epoch restart: abort-resolve old intents, advance ts."""
        for k in self.intent_keys:
            self.store.mvcc.resolve_intent(k, self.meta, TxnStatus.ABORTED)
        self.intent_keys = []
        self.read_spans = []
        self.meta.epoch += 1
        self.meta.seq = 0
        now = self.store.clock.now()
        self.meta.read_ts = max(self.meta.write_ts, now)
        self.meta.write_ts = self.meta.read_ts


class DB:
    """kv.DB facade: run retryable transactions (db.go:896)."""

    MAX_ATTEMPTS = 20

    def __init__(self, store: Optional[KVStore] = None):
        self.store = store or KVStore()

    def txn(self, fn: Callable[[Txn], object]) -> object:
        attempts = 0
        t = Txn(self.store)
        while True:
            attempts += 1
            if attempts > self.MAX_ATTEMPTS:
                raise TxnRetryError("too many retries")
            try:
                result = fn(t)
                t.commit()
                return result
            except TxnRetryError:
                t._restart()
                # re-begin the record for the new epoch if aborted
                rec = self.store.txns.get(t.meta.id)
                if rec is None or rec.status != TxnStatus.PENDING:
                    t = Txn(self.store)
            except TxnAbortedError:
                t.rollback()
                t = Txn(self.store)
            except BaseException:
                # non-retryable client error: don't leak a zombie
                # record + intents (db.go rolls back on any error)
                t.rollback()
                raise

    # non-transactional conveniences (singleton batches, kv.DB.Put)
    def put(self, key: bytes, value: bytes) -> None:
        self.txn(lambda t: t.put(key, value))

    def get(self, key: bytes) -> Optional[bytes]:
        return self.txn(lambda t: t.get(key))

    def scan(self, start: bytes, end: bytes,
             max_keys: int = 0) -> list[tuple[bytes, bytes]]:
        return self.txn(lambda t: t.scan(start, end, max_keys))

    def delete(self, key: bytes) -> None:
        self.txn(lambda t: t.delete(key))
