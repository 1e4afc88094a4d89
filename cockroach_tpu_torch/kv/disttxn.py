"""Distributed transactions over raft-replicated ranges
(cockroach_tpu/kv/disttxn.py).

The single-store txn layer (kv/txn.py) does not drive the replicated
plane by itself. This is the
TxnCoordSender protocol (pkg/kv/kvclient/kvcoord) distilled onto the
Cluster harness:

1. Writes lay INTENTS (provisional MVCC versions + txn meta) through
   each key's leaseholder via raft — so intents replicate and survive
   node failure like any write.
2. COMMIT's atomic moment is a single raft write of the transaction
   RECORD (status COMMITTED, commit ts) on the txn's anchor range
   (batcheval/cmd_end_transaction.go). Intent resolution afterwards is
   asynchronous cleanup — a coordinator crash between commit and
   resolution loses nothing.
3. Readers that hit a foreign intent resolve it by consulting the
   record (the PushTxn path, kvserver/txnwait): COMMITTED -> resolve
   to the commit ts and retry; ABORTED -> remove the intent and retry;
   no record -> POISON the pushee by writing an ABORTED record first
   (batcheval/cmd_push_txn.go's PUSH_ABORT on a recordless txn), then
   remove the intent. The record write is conditional below raft
   (store.py ``txn_record``), so a concurrent commit and push race
   deterministically: whichever record lands first in the anchor
   range's log wins, and the loser observes it — the pushee's commit
   fails with a retryable TxnAbortedError instead of silently losing
   the pushed-away write (cmd_end_transaction.go's status check).

Records live at /txn/<id> keys proposed directly to the anchor key's
range, so the record replicates with the range (and travels in its
snapshots).
"""

from __future__ import annotations

import json
import uuid
from typing import Optional

from ..kv.concurrency import TxnAbortedError as _ConcurrencyTxnAbortedError
from ..kvserver.store import _dec_ts, _enc_ts, raise_op_error
from ..storage.hlc import MAX_TIMESTAMP, Timestamp
from ..storage.mvcc import TxnMeta, WriteIntentError


class DistTxnError(Exception):
    pass


class TxnAbortedError(DistTxnError, _ConcurrencyTxnAbortedError):
    """The txn record was poisoned ABORTED by a pusher before commit;
    the client must retry the whole transaction (the analogue of
    ABORT_REASON_ABORTED_RECORD_FOUND -> TransactionRetryWithProtoRefresh,
    surfaced to SQL as SQLSTATE 40001). Subclasses the concurrency
    layer's TxnAbortedError so existing `except TxnAbortedError`
    handlers in the SQL layer catch both."""

    def __init__(self, txn_id: str, reason: str):
        Exception.__init__(self, reason)
        self.txn_id = txn_id


def _record_key(txn_id: str) -> bytes:
    return b"\x00txn/" + txn_id.encode()


def propose_txn_record(cluster, anchor: bytes, txn_id: str,
                       status: str, ts: Timestamp,
                       writes: Optional[list] = None,
                       finalize_staging: bool = False) -> dict:
    """The single wire shape for conditional record writes — used by
    the commit path, the pusher's poison, and parallel-commit staging
    (which declares the txn's write set for the recovery proof) so no
    two sides can desynchronize below raft.

    ``finalize_staging`` marks a proposer with the authority to move a
    STAGING record to ABORTED: status recovery (which has verified the
    write set, cmd_recover_txn.go) or the txn's own coordinator. A
    pusher's blind poison must NOT carry it — a parallel commit whose
    implicit-commit condition already holds would otherwise be
    spuriously aborted; the poison instead fails with
    existing='staging' and the pusher runs recovery."""
    rep = cluster._leaseholder_replica(anchor)
    op = {"op": "txn_record",
          "key": _record_key(txn_id).decode("latin1"),
          "anchor": anchor.decode("latin1"),
          "status": status, "ts": _enc_ts(ts)}
    if finalize_staging:
        op["finalize_staging"] = True
    if writes is not None:
        op["writes"] = writes
    out = cluster.propose_and_wait(rep, {"kind": "batch", "ops": [op]})
    return out[0]


class DistTxn:
    """One distributed transaction against a kvserver Cluster."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.id = uuid.uuid4().hex[:12]
        self.read_ts = cluster.clock.now()
        self.write_ts = self.read_ts
        self.anchor: Optional[bytes] = None
        self.intents: list[bytes] = []
        self.status = "pending"
        # pipelined writes awaiting their raft application proof:
        # key -> the callback's out-dict (txn_interceptor_pipeliner.go)
        self._in_flight: list[tuple[bytes, dict]] = []

    def _meta(self) -> TxnMeta:
        return TxnMeta(id=self.id, key=self.anchor or b"",
                       write_ts=self.write_ts, read_ts=self.read_ts)

    # -- reads ---------------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        """Snapshot read; own intents visible; foreign intents below
        the read ts push through the record (retry loop)."""
        c = self.cluster
        for _ in range(10):
            rep = c._leaseholder_replica(key)
            try:
                return rep.read({
                    "op": "get", "key": key.decode("latin1"),
                    "ts": _enc_ts(self.read_ts),
                    "txn": self._meta().to_json().decode()})
            except WriteIntentError as e:
                push_intent(c, e.key, e.txn_meta)
        raise DistTxnError(f"could not resolve intent on {key!r}")

    # -- writes --------------------------------------------------------------
    def put(self, key: bytes, value: Optional[bytes]) -> None:
        if self.status != "pending":
            raise DistTxnError(f"txn is {self.status}")
        if self.anchor is None:
            self.anchor = key  # record lives on this key's range
        c = self.cluster
        rep = c._leaseholder_replica(key)
        op = {"op": "put" if value is not None else "delete",
              "key": key.decode("latin1"),
              "ts": _enc_ts(self.write_ts),
              "txn": self._meta().to_json().decode()}
        if value is not None:
            op["value"] = value.decode("latin1")
        res = c.propose_and_wait(rep, {"kind": "batch", "ops": [op]})[0]
        # batch eval reports MVCC conflicts as results (store.py);
        # swallowing one here would silently drop the write while
        # commit() succeeds
        raise_op_error(res)
        if isinstance(res, dict) and "wts" in res:
            wts = _dec_ts(res["wts"])
            if self.write_ts < wts:
                self.write_ts = wts   # below-raft WriteTooOld bump
        self.intents.append(key)

    def delete(self, key: bytes) -> None:
        self.put(key, None)

    # -- pipelined writes (txn_interceptor_pipeliner.go) ---------------------
    def put_pipelined(self, key: bytes, value: Optional[bytes]) -> None:
        """Lay the intent WITHOUT waiting for raft application: the
        proposal goes to the leaseholder and the txn tracks it as
        in-flight; the proof that it applied is collected at commit
        (QueryIntent's role in the reference). N writes reach
        consensus concurrently instead of serially."""
        if self.status != "pending":
            raise DistTxnError(f"txn is {self.status}")
        if self.anchor is None:
            self.anchor = key
        c = self.cluster
        rep = c._leaseholder_replica(key)
        op = {"op": "put" if value is not None else "delete",
              "key": key.decode("latin1"),
              "ts": _enc_ts(self.write_ts),
              "txn": self._meta().to_json().decode()}
        if value is not None:
            op["value"] = value.decode("latin1")
        out: dict = {}

        def cb(result):
            out["result"] = result

        if not rep.propose({"kind": "batch", "ops": [op]}, cb):
            # no leader reachable right now: fall back to the waiting
            # path, which retries around elections
            self.put(key, value)
            return
        self.intents.append(key)
        self._in_flight.append((key, out))

    def prove_in_flight(self) -> None:
        """Pump until every pipelined write applied; surface op errors
        and WriteTooOld bumps exactly as the synchronous path would."""
        c = self.cluster
        pending = self._in_flight
        self._in_flight = []
        if not pending:
            return
        if not c.pump_until(
                lambda: all("result" in out for _k, out in pending),
                max_iter=2000):
            missing = [k for k, out in pending if "result" not in out]
            raise DistTxnError(
                f"pipelined writes never applied: {missing!r}")
        for _key, out in pending:
            res = out["result"][0] if isinstance(out["result"], list) \
                else out["result"]
            raise_op_error(res)
            if isinstance(res, dict) and "wts" in res:
                wts = _dec_ts(res["wts"])
                if self.write_ts < wts:
                    self.write_ts = wts

    # -- commit / rollback ---------------------------------------------------
    def commit(self) -> Timestamp:
        """Write the COMMITTED record (the atomic moment), then resolve
        intents; the record makes resolution restartable by anyone.
        With pipelined writes outstanding this runs the parallel-commit
        protocol instead (txn_interceptor_committer.go): STAGE the
        record with the declared write set while the write proofs are
        still in flight — the txn is implicitly committed the moment
        every declared write and the staging record have applied — then
        flip to explicit COMMITTED and resolve."""
        if self.status != "pending":
            raise DistTxnError(f"txn is {self.status}")
        if self.anchor is None:  # read-only
            self.status = "committed"
            return self.read_ts
        if self._in_flight:
            return self._commit_parallel()
        commit_ts = self.cluster.clock.now()
        res = self._write_record("committed", commit_ts)
        if not res.get("ok"):
            # a pusher poisoned our record: our intents may already be
            # gone — committing now would lose them silently. Clean up
            # and surface a retryable abort.
            self.status = "aborted"
            self.resolve_all(commit=False, commit_ts=None)
            raise TxnAbortedError(
                self.id,
                f"txn {self.id} aborted by a concurrent push "
                f"(record is {res.get('existing')})")
        if res.get("existing") == "committed":
            # retry after an ambiguous first commit: the record already
            # applied at its own ts — adopt it, or intents resolved by
            # pushers (at the record's ts) and by us (at a fresh ts)
            # would split one txn across two commit timestamps
            commit_ts = _dec_ts(res["existing_ts"])
        self.status = "committed"
        self.resolve_all(commit=True, commit_ts=commit_ts)
        return commit_ts

    def _commit_parallel(self) -> Timestamp:
        """Parallel commit: one round-trip of latency for the whole
        commit instead of writes-then-record. The staging record
        declares every write key; recovery (``recover_staging_txn``)
        can finish or abort the txn from the record alone if we die."""
        c = self.cluster
        commit_ts = max(c.clock.now(), self.write_ts)
        res = propose_txn_record(
            c, self.anchor, self.id, "staging", commit_ts,
            writes=[k.decode("latin1") for k in self.intents])
        if not res.get("ok"):
            self.status = "aborted"
            self.resolve_all(commit=False, commit_ts=None)
            raise TxnAbortedError(
                self.id, f"txn {self.id} aborted by a concurrent push "
                f"(record is {res.get('existing')})")
        try:
            self.prove_in_flight()
        except Exception:
            # a write failed (or its proof timed out): the txn cannot
            # be implicitly committed — make the abort explicit so
            # recovery never finds all writes present. The conditional
            # can STILL lose to a recovery that already found every
            # declared write applied (a proof timeout, not an op
            # error, is the consistent cause): then the txn IS
            # committed — resolve that way instead of erasing some
            # intents of a committed txn
            res = propose_txn_record(c, self.anchor, self.id,
                                     "aborted", c.clock.now(),
                                     finalize_staging=True)
            if not res.get("ok") and res.get("existing") == "committed":
                self.status = "committed"
                cts = _dec_ts(res["existing_ts"])
                self.resolve_all(commit=True, commit_ts=cts)
                return cts
            self.status = "aborted"
            self.resolve_all(commit=False, commit_ts=None)
            raise
        if self.write_ts > commit_ts:
            # a proof came back with a WriteTooOld bump above the
            # staged ts: the staged commit moment is invalid. Abort
            # explicitly and surface a retry (the reference re-stages
            # at a new epoch; one epoch here keeps recovery simple).
            # The conditional can lose only to a recovery that found
            # every write at-or-below the staged ts — impossible with
            # a bumped intent — but honor a COMMITTED verdict anyway
            # rather than resolve committed intents as aborts
            res = propose_txn_record(c, self.anchor, self.id,
                                     "aborted", c.clock.now(),
                                     finalize_staging=True)
            if not res.get("ok") and res.get("existing") == "committed":
                self.status = "committed"
                cts = _dec_ts(res["existing_ts"])
                self.resolve_all(commit=True, commit_ts=cts)
                return cts
            self.status = "aborted"
            self.resolve_all(commit=False, commit_ts=None)
            raise TxnAbortedError(
                self.id, f"txn {self.id}: write bumped past the "
                "staged commit ts; retry")
        # implicitly committed — make it explicit (recovery may have
        # beaten us to either verdict)
        res = propose_txn_record(c, self.anchor, self.id, "committed",
                                 commit_ts)
        if not res.get("ok"):
            self.status = "aborted"
            self.resolve_all(commit=False, commit_ts=None)
            raise TxnAbortedError(
                self.id, f"txn {self.id} aborted during parallel "
                f"commit (record is {res.get('existing')})")
        if res.get("existing") == "committed":
            commit_ts = _dec_ts(res["existing_ts"])
        self.status = "committed"
        self.resolve_all(commit=True, commit_ts=commit_ts)
        return commit_ts

    def rollback(self) -> None:
        if self.status != "pending":
            return
        try:
            # wait for pipelined writes so resolve_all sees them all;
            # their individual failures don't matter to an abort
            self.prove_in_flight()
        except Exception:
            pass
        if self.anchor is not None:
            res = self._write_record("aborted", self.write_ts)
            if not res.get("ok") and res.get("existing") == "committed":
                # ambiguous-commit recovery: commit() may have raised
                # AmbiguousResultError AFTER its COMMITTED record
                # applied; destroying the intents now would lose a
                # committed txn — finish its resolution instead
                self.status = "committed"
                self.resolve_all(commit=True,
                                 commit_ts=_dec_ts(res["existing_ts"]))
                raise DistTxnError(
                    f"cannot rollback txn {self.id}: already committed")
        self.status = "aborted"
        self.resolve_all(commit=False, commit_ts=None)

    def _write_record(self, status: str, ts: Timestamp) -> dict:
        """Conditionally write the record through the anchor range's
        raft log; the decision happens at apply time so pushes and
        commits serialize on the log (see store.py ``txn_record``).
        Coordinator writes to the txn's OWN record carry
        finalize_staging authority."""
        return propose_txn_record(self.cluster, self.anchor, self.id,
                                  status, ts, finalize_staging=True)

    def resolve_all(self, commit: bool,
                    commit_ts: Optional[Timestamp]) -> None:
        """Post-commit cleanup; safe to re-run, safe to skip (readers
        push through the record). Once EVERY intent is resolved the
        record itself is deleted — the reference's EndTxn does the same
        when it can resolve synchronously, which is what keeps the
        record keyspace from growing with txn history. If any intent
        was skipped the record MUST stay: it is the only thing standing
        between the orphan intent and a pusher treating the txn as
        recordless."""
        c = self.cluster
        meta = self._meta()
        skipped = 0
        for key in self.intents:
            try:
                rep = c._leaseholder_replica(key)
            except (KeyError, RuntimeError):
                skipped += 1
                continue  # a pusher will clean this one up
            op = {"op": "resolve", "key": key.decode("latin1"),
                  "txn": meta.to_json().decode(),
                  "commit": commit}
            if commit_ts is not None:
                op["commit_ts"] = _enc_ts(commit_ts)
            c.propose_and_wait(rep, {"kind": "batch", "ops": [op]})
        if self.anchor is not None and skipped == 0:
            try:
                rep = c._leaseholder_replica(self.anchor)
                c.propose_and_wait(rep, {"kind": "batch", "ops": [{
                    "op": "delete",
                    "key": _record_key(self.id).decode("latin1"),
                    "ts": _enc_ts(c.clock.now())}]})
            except (KeyError, RuntimeError):
                pass  # leave the record; GC-able once intents resolve


def read_txn_record(cluster, txn_meta: TxnMeta):
    """The full record dict from the txn's anchor range, or None.
    Keys: status, ts (decoded), writes (staging only).

    Routed through ``_leaseholder_replica`` (NOT ``cluster.stores``):
    a NetCluster's stores map holds only the LOCAL node's store, so
    indexing by a remote leaseholder id raised KeyError and every
    cross-process intent push failed instead of resolving."""
    try:
        rep = cluster._leaseholder_replica(txn_meta.key)
    except (KeyError, RuntimeError):
        return None
    mv = rep.mvcc.get(_record_key(txn_meta.id),
                      MAX_TIMESTAMP, inconsistent=True)
    if mv is None:
        return None
    o = json.loads(mv.value.decode())
    return {"status": o["status"], "ts": _dec_ts(o["ts"]),
            "writes": o.get("writes")}


def recover_staging_txn(cluster, txn_meta: TxnMeta, rec: dict):
    """Transaction-status recovery (cmd_recover_txn.go): a pusher that
    finds a STAGING record decides the implicit-commit condition by
    checking every declared write for this txn's intent. All present
    -> the txn IS committed: finalize the record at its staged ts.
    Any missing -> the commit never happened: finalize ABORTED. Both
    finalizations are conditional record transitions, so a racing
    coordinator and pusher agree in the anchor range's log order.
    Returns ("committed", ts) or ("aborted", None)."""
    all_present = True
    for k in rec.get("writes") or []:
        key = k.encode("latin1")
        try:
            rep = cluster._leaseholder_replica(key)
        except (KeyError, RuntimeError):
            all_present = False
            break
        meta = rep.mvcc._meta(key)
        if meta is None or meta.id != txn_meta.id \
                or rec["ts"] < meta.write_ts:
            # absent, foreign, or written ABOVE the staged ts (a
            # WriteTooOld bump after staging): the implicit-commit
            # condition — every declared write at or below the staged
            # commit ts — does not hold
            all_present = False
            break
    if all_present:
        res = propose_txn_record(cluster, txn_meta.key, txn_meta.id,
                                 "committed", rec["ts"])
        if res.get("ok") or res.get("existing") == "committed":
            ts = (_dec_ts(res["existing_ts"])
                  if res.get("existing") == "committed" else rec["ts"])
            return "committed", ts
        return "aborted", None
    res = propose_txn_record(cluster, txn_meta.key, txn_meta.id,
                             "aborted", cluster.clock.now(),
                             finalize_staging=True)
    if not res.get("ok") and res.get("existing") == "committed":
        # the coordinator's explicit commit landed first: the txn is
        # committed after all (our missing intent was a not-yet-applied
        # proposal that has since applied)
        return "committed", _dec_ts(res["existing_ts"])
    return "aborted", None


def push_intent(cluster, key: bytes, txn_meta: TxnMeta) -> None:
    """Resolve a foreign intent by its record (PushTxn):
    COMMITTED -> rewrite the intent to the commit ts; ABORTED -> remove
    it; STAGING -> run transaction-status recovery (parallel commits:
    the record alone decides — all declared writes present at/below
    the staged ts means committed, else aborted); no record -> poison
    the pushee with an ABORTED record FIRST, then remove. Without the
    poison, removing the intent while the writer later commits
    unconditionally silently loses the write; with it, the writer's commit observes the ABORTED record and
    fails retryably."""
    rec = read_txn_record(cluster, txn_meta)
    if rec is None:
        # write ABORTED through the anchor range's log; a racing commit
        # may land first, in which case the conditional write reports
        # the existing COMMITTED record and we resolve to commit below
        res = propose_txn_record(cluster, txn_meta.key, txn_meta.id,
                                 "aborted", cluster.clock.now())
        if not res.get("ok") and res.get("existing") in ("committed",
                                                         "staging"):
            if res.get("existing") == "staging":
                # our poison raced a parallel commit's staging: the
                # record now decides — recover
                rec2 = read_txn_record(cluster, txn_meta)
                if rec2 is not None and rec2["status"] == "staging":
                    verdict = recover_staging_txn(cluster, txn_meta,
                                                  rec2)
                else:
                    verdict = ((rec2["status"], rec2["ts"])
                               if rec2 else ("aborted", None))
            else:
                verdict = ("committed", _dec_ts(res["existing_ts"]))
        else:
            verdict = ("aborted", None)
    elif rec["status"] == "staging":
        verdict = recover_staging_txn(cluster, txn_meta, rec)
    else:
        verdict = (rec["status"], rec["ts"])
    commit = verdict[0] == "committed"
    rep = cluster._leaseholder_replica(key)
    op = {"op": "resolve", "key": key.decode("latin1"),
          "txn": txn_meta.to_json().decode(), "commit": commit}
    if commit:
        op["commit_ts"] = _enc_ts(verdict[1])
    cluster.propose_and_wait(rep, {"kind": "batch", "ops": [op]})
