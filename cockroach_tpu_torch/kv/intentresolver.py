"""Async intent resolution: batch cleanup of finished-txn intents.

The analogue of pkg/kv/kvserver/intentresolver
(intent_resolver.go:132): readers that encounter intents of finished
or abandoned transactions enqueue them here instead of resolving one
at a time in the read path; ``process()`` drains the queue in batches,
resolving each intent according to its transaction record's
disposition. ``clean_span`` is the periodic sweep (driven by the node
maintenance loop) that discovers abandoned intents — a txn whose
coordinator died leaves PENDING intents with an expired heartbeat;
the sweep force-aborts and removes them so future readers never pay
a push.
"""

from __future__ import annotations

import time

from ..storage.mvcc import TxnStatus

MAX_KEY = b"\xff" * 12


class IntentResolver:
    def __init__(self, store):
        self.store = store          # kv.txn.KVStore
        self.queue: list = []       # [(key, TxnMeta)]
        self.resolved_total = 0

    def enqueue(self, key: bytes, meta) -> None:
        self.queue.append((key, meta))

    def _disposition(self, meta):
        """(status, commit_ts) to resolve with, or None = leave it
        (its txn is live and pending)."""
        rec = self.store.txns.get(meta.id)
        if rec is None:
            # record evicted after resolution or coordinator crashed
            # pre-commit: either way the intent is removable as aborted
            # (txn.py push() maps unknown ids the same way)
            return (TxnStatus.ABORTED, None)
        if rec.status == TxnStatus.COMMITTED:
            return (TxnStatus.COMMITTED, rec.commit_ts)
        if rec.status == TxnStatus.ABORTED:
            return (TxnStatus.ABORTED, None)
        expired = (time.monotonic() - rec.last_heartbeat
                   > self.store.txns.HEARTBEAT_EXPIRY)
        if expired:
            # force-abort the abandoned record, then resolve
            rec = self.store.txns.push(meta, push_abort=False,
                                       timeout=0.0)
            if rec.status != TxnStatus.PENDING:
                return (rec.status,
                        rec.commit_ts
                        if rec.status == TxnStatus.COMMITTED else None)
        return None

    def process(self) -> int:
        """Drain the queue; returns the number of intents resolved."""
        n = 0
        pending: list = []
        while self.queue:
            key, meta = self.queue.pop()
            d = self._disposition(meta)
            if d is None:
                pending.append((key, meta))
                continue
            status, commit_ts = d
            self.store.mvcc.resolve_intent(key, meta, status, commit_ts)
            n += 1
        self.queue = pending
        self.resolved_total += n
        return n

    def clean_span(self, start: bytes = b"",
                   end: bytes = MAX_KEY) -> int:
        """One sweep: find intents in [start, end) via an inconsistent
        scan, enqueue them all, resolve what is resolvable."""
        intents: list = []
        self.store.mvcc.scan(start, end, self.store.clock.now(),
                             inconsistent=True, intents_out=intents)
        for key, meta in intents:
            self.enqueue(key, meta)
        return self.process()
