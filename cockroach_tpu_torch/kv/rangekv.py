"""The engine's KV plane served from raft-replicated ranges
(cockroach_tpu/kv/rangekv.py).

The engine's entire transactional
machinery (kv/txn.py: latches, tscache floors, intent pushes, span
refresh, the DB retry loop) operates against an MVCC interface — so
instead of translating the reference's TxnCoordSender/DistSender pair
wholesale, we swap the MVCC *storage* underneath that machinery:

- ``RangeMVCC`` implements the MVCC surface kv.Txn uses (get / scan /
  put / resolve_intent / has_writes_between) by routing each key to
  its range's leaseholder replica. Reads are served by the leaseholder
  in-process (replica_read.go:43 — no consensus); writes and intent
  resolution are proposed through raft and applied deterministically
  on every replica (replica_raft.go:105 evalAndPropose -> apply).
- MVCC conflicts during apply come back as *results* (store.py batch
  eval catches WriteIntentError/WriteTooOldError) and are re-raised
  here client-side, so the gateway's push/retry protocol sees exactly
  the exceptions it sees on the local plane.
- A txn write's timestamp may be bumped below raft (WriteTooOld
  bumps the intent ts); the apply result reports the written ts and
  the gateway adopts it, mirroring how the reference's BatchResponse
  carries the pushed txn proto back to the TxnCoordSender.

With this store under the engine, DML intents, the catalog, sequences,
zone configs and job records all replicate and survive node failure —
the columnstore becomes what its docstring claims: a scan-plane
materialization of committed range data.

Reference path being rebuilt: pkg/sql/row/kv_batch_fetcher.go:107 ->
kv/kvclient/kvcoord/dist_sender.go:795 -> kvserver/replica_send.go:113.
"""

from __future__ import annotations

from typing import Optional

from ..kvserver.store import _dec_ts, _enc_ts, raise_op_error
from ..storage.hlc import Timestamp
from ..storage.mvcc import MVCCValue, TxnMeta, TxnStatus
from ..utils import tracing
from .concurrency import (Span, SpanLatchManager, TimestampCache,
                          TxnRecord, TxnRegistry)
from .txn import KVStore


class RangeMVCC:
    """MVCC facade over a Cluster: the storage half of DistSender.

    Key->range routing consults the cluster's descriptors (the range
    cache analogue); reads go straight at the leaseholder's engine,
    writes ride raft. Only the surface kv.Txn/IntentResolver actually
    use is implemented — anything else raises loudly.
    """

    def __init__(self, cluster):
        self.cluster = cluster

    # -- routing -----------------------------------------------------------
    def _ranges_overlapping(self, start: bytes, end: bytes):
        """Leaseholder replicas for each range overlapping [start,end),
        in key order (DistSender's span iteration, dist_sender.go:795)."""
        out = []
        cur = start
        guard = 0
        while cur < end:
            desc = self.cluster.range_for_key(cur)
            if desc is None:
                # gap in the keyspace (no range covers it): step to the
                # next descriptor start above cur, if any
                nxt = None
                for d in self.cluster.descriptors.values():
                    if d.start_key > cur and (nxt is None or
                                              d.start_key < nxt.start_key):
                        nxt = d
                if nxt is None or nxt.start_key >= end:
                    break
                cur = nxt.start_key
                continue
            out.append((desc, self.cluster._leaseholder_replica(cur)))
            cur = desc.end_key
            guard += 1
            if guard > 10000:
                raise RuntimeError("range iteration did not advance")
        return out

    def _leaseholder(self, key: bytes):
        return self.cluster._leaseholder_replica(key)

    def _propose(self, key: bytes, op: dict) -> object:
        rep = self._leaseholder(key)
        out = self.cluster.propose_and_wait(
            rep, {"kind": "batch", "ops": [op]})
        return raise_op_error(out[0])

    # -- reads (leaseholder, no consensus) ---------------------------------
    def get(self, key: bytes, read_ts: Timestamp,
            txn: Optional[TxnMeta] = None,
            inconsistent: bool = False) -> Optional[MVCCValue]:
        rep = self._leaseholder(key)
        # leaseholder-side tscache (tscache/cache.go): the floor a
        # served read leaves behind lives WITH the lease, so a write
        # arriving via any other gateway still pushes above it (closes
        # the gateway-local limitation noted in ClusterKVStore).  A
        # RemoteReplica proxy has no cache; those reads fall back to
        # the gateway-local discipline in Txn._write.
        tscache = getattr(rep, "tscache", None)
        if not inconsistent and tscache is not None:
            tscache.add(Span(key), read_ts,
                        txn.id if txn is not None else None)
        return rep.mvcc.get(
            key, read_ts, txn=txn, inconsistent=inconsistent)

    def scan(self, start: bytes, end: bytes, read_ts: Timestamp,
             txn: Optional[TxnMeta] = None, max_keys: int = 0,
             inconsistent: bool = False,
             intents_out: Optional[list] = None) -> list:
        out: list = []
        for desc, rep in self._ranges_overlapping(start, end):
            lo = max(start, desc.start_key)
            hi = min(end, desc.end_key)
            tscache = getattr(rep, "tscache", None)
            if not inconsistent and tscache is not None:
                tscache.add(Span(lo, hi), read_ts,
                            txn.id if txn is not None else None)
            out.extend(rep.mvcc.scan(
                lo, hi, read_ts, txn=txn,
                max_keys=(max_keys - len(out)) if max_keys else 0,
                inconsistent=inconsistent, intents_out=intents_out))
            if max_keys and len(out) >= max_keys:
                break
        return out

    def has_writes_between(self, start: bytes, end: bytes,
                           t0: Timestamp, t1: Timestamp,
                           exclude_txn: Optional[str] = None) -> bool:
        for desc, rep in self._ranges_overlapping(start, end):
            lo = max(start, desc.start_key)
            hi = min(end, desc.end_key)
            if rep.mvcc.has_writes_between(lo, hi, t0, t1,
                                           exclude_txn=exclude_txn):
                return True
        return False

    # -- writes (raft-replicated) ------------------------------------------
    def put(self, key: bytes, write_ts: Timestamp,
            value: Optional[bytes],
            txn: Optional[TxnMeta] = None) -> None:
        if txn is not None:
            # consult the LEASEHOLDER's tscache before proposing: a
            # read served there (possibly via another gateway) sets a
            # floor this write must exceed — same discipline Txn._write
            # applies against the gateway-local cache
            tscache = getattr(self._leaseholder(key), "tscache", None)
            if tscache is not None:
                floor = tscache.get_max(Span(key), exclude=txn.id)
                if not txn.write_ts > floor:
                    txn.write_ts = floor.next()
        op = {"op": "put" if value is not None else "delete",
              "key": key.decode("latin1"),
              "ts": _enc_ts(txn.write_ts if txn is not None
                            else write_ts)}
        if value is not None:
            op["value"] = value.decode("latin1")
        if txn is not None:
            op["txn"] = txn.to_json().decode()
        res = self._propose(key, op)
        if txn is not None and isinstance(res, dict) and "wts" in res:
            # adopt a below-raft WriteTooOld bump (refresh decides at
            # commit whether the txn must restart)
            wts = _dec_ts(res["wts"])
            if txn.write_ts < wts:
                txn.write_ts = wts

    def delete(self, key: bytes, write_ts: Timestamp,
               txn: Optional[TxnMeta] = None) -> None:
        self.put(key, write_ts, None, txn)

    def resolve_intent(self, key: bytes, txn: TxnMeta,
                       status: TxnStatus,
                       commit_ts: Optional[Timestamp] = None) -> bool:
        op = {"op": "resolve", "key": key.decode("latin1"),
              "txn": txn.to_json().decode(),
              "commit": status == TxnStatus.COMMITTED}
        if commit_ts is not None:
            op["commit_ts"] = _enc_ts(commit_ts)
        tracing.event("resolve-intent",
                      committed=status == TxnStatus.COMMITTED)
        try:
            self._propose(key, op)
        except (KeyError, RuntimeError):
            return False   # range gone / no quorum: a pusher cleans up
        return True


class ClusterTxnRegistry(TxnRegistry):
    """TxnRegistry that consults the REPLICATED txn record for ids it
    does not know locally: gateway B pushing
    gateway A's txn used to map the unknown id straight to ABORTED —
    an isolation violation the moment two gateways write. Now:

    - a replicated anchor-range record (kv/disttxn.py) is
      authoritative: committed/aborted finalize the push, staging runs
      the recovery protocol;
    - no record + a RECENT intent means a live foreign coordinator
      that simply hasn't written its record yet (records appear at
      commit time): the push reports PENDING and the pusher retries —
      never a silent abort;
    - no record + an old intent is an abandoned txn: removable,
      exactly like the local eviction case.
    """

    ABANDON_NS = int(3e9)

    def __init__(self, cluster):
        super().__init__()
        self.cluster = cluster

    def push(self, pushee: TxnMeta, push_abort: bool = False,
             timeout: float = 1.0) -> TxnRecord:
        with self._lock:
            known = pushee.id in self._records
        if known:
            return super().push(pushee, push_abort, timeout)
        from .disttxn import (propose_txn_record, read_txn_record,
                              recover_staging_txn)
        try:
            rep = self.cluster._leaseholder_replica(pushee.key)
        except (KeyError, RuntimeError):
            # anchor range unreachable (breaker/quorum blip): this is
            # NOT evidence of record absence — a committed record may
            # simply be unreadable right now. Report PENDING so the
            # pusher retries instead of removing a possibly-committed
            # intent (reachability != absence).
            return TxnRecord(meta=pushee, status=TxnStatus.PENDING)
        rec = read_txn_record(self.cluster, pushee)
        if rec is not None:
            if rec["status"] == "committed":
                return TxnRecord(meta=pushee,
                                 status=TxnStatus.COMMITTED,
                                 commit_ts=rec["ts"])
            if rec["status"] == "aborted":
                return TxnRecord(meta=pushee, status=TxnStatus.ABORTED)
            outcome, cts = recover_staging_txn(self.cluster, pushee,
                                               rec)
            if outcome == "committed":
                return TxnRecord(meta=pushee,
                                 status=TxnStatus.COMMITTED,
                                 commit_ts=cts)
            return TxnRecord(meta=pushee, status=TxnStatus.ABORTED)
        del rep
        age = self.cluster.clock.now().to_int() - \
            pushee.write_ts.to_int()
        if age < self.ABANDON_NS:
            return TxnRecord(meta=pushee, status=TxnStatus.PENDING)
        # abandoned: write the POISON record (CPut: only if still
        # absent) BEFORE declaring ABORTED, so a coordinator that
        # revives later finds the fence and cannot commit a txn whose
        # intents we are about to remove (the push_intent protocol,
        # cmd_push_txn.go's ABORTED record write)
        try:
            res = propose_txn_record(
                self.cluster, pushee.key, pushee.id, "aborted",
                self.cluster.clock.now())
        except (KeyError, RuntimeError):
            return TxnRecord(meta=pushee, status=TxnStatus.PENDING)
        if not res.get("ok"):
            existing = res.get("existing")
            if existing == "committed":
                rec2 = read_txn_record(self.cluster, pushee)
                if rec2 is None:
                    # the CPut proved a committed record exists, but
                    # the re-read could not reach the anchor range —
                    # reporting COMMITTED without its commit_ts (or
                    # worse, falling through to ABORTED) would let the
                    # pusher resolve intents wrongly. Reachability !=
                    # absence: PENDING, retry later.
                    return TxnRecord(meta=pushee,
                                     status=TxnStatus.PENDING)
                return TxnRecord(
                    meta=pushee, status=TxnStatus.COMMITTED,
                    commit_ts=rec2["ts"])
            if existing == "staging":
                rec2 = read_txn_record(self.cluster, pushee)
                if rec2 is None:
                    # same transient-unreachability case as above: a
                    # staging record may have committed; ABORTED here
                    # would remove intents of a commit in progress
                    return TxnRecord(meta=pushee,
                                     status=TxnStatus.PENDING)
                outcome, cts = recover_staging_txn(
                    self.cluster, pushee, rec2)
                if outcome == "committed":
                    return TxnRecord(meta=pushee,
                                     status=TxnStatus.COMMITTED,
                                     commit_ts=cts)
        return TxnRecord(meta=pushee, status=TxnStatus.ABORTED)


class ClusterKVStore(KVStore):
    """A KVStore whose MVCC plane is the cluster's replicated ranges.

    The gateway-local concurrency plane (latches, tscache) is
    per-SQL-gateway, like the reference's per-node concurrency
    manager; cross-gateway WRITE-write conflicts serialize on the
    replicated intents, and pushes of foreign txns consult the
    replicated anchor-range record (``ClusterTxnRegistry``). Reads
    additionally leave their floor in the LEASEHOLDER's timestamp
    cache (``Replica.tscache`` — tscache/cache.go is per-leaseholder
    in the reference), and ``RangeMVCC.put`` consults that floor
    before proposing, so a read served via gateway A pushes a write
    arriving via gateway B: multi-gateway DML no longer needs to
    route through a single gateway."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.mvcc = RangeMVCC(cluster)
        self.latches = SpanLatchManager()
        self.tscache = TimestampCache()
        self.txns = ClusterTxnRegistry(cluster)
        self.clock = cluster.clock
        from .intentresolver import IntentResolver
        self.intent_resolver = IntentResolver(self)
