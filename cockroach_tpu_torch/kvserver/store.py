"""Store/Replica: ranges replicated by Raft, applied to the MVCC engine
(cockroach_tpu/kvserver/store.py).

Rebuild of the reference's core kvserver objects:
- ``Store`` (``pkg/kv/kvserver/store.go``): per-node container of
  replicas, routes incoming requests/raft traffic by range, pumps the
  raft scheduler (``scheduler.go:181`` worker pool → here a
  deterministic ``pump()``).
- ``Replica`` (``replica.go``, ``replica_send.go:113``): one member of
  one range's consensus group. Write path mirrors
  ``executeWriteBatch`` → ``evalAndPropose`` (``replica_raft.go:105``):
  commands are proposed to raft and applied to the local MVCC engine
  once committed; reads are served by the leaseholder without
  consensus (``replica_read.go:43``).
- Epoch leases (``replica_range_lease.go``): the lease record is itself
  replicated state; validity is tied to node-liveness epochs so a dead
  leaseholder is fenced by incrementing its epoch.

Commands are JSON-encoded MVCC batches — evaluation is deterministic,
so applying the same log yields identical engines on every replica.
"""

from __future__ import annotations

import copy
import json
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from cockroach_tpu_torch.kvserver.raft import (RaftNode, Snapshot,
                                         unpack_group)
from cockroach_tpu_torch.storage.hlc import MAX_TIMESTAMP, Clock, Timestamp
from cockroach_tpu_torch.storage.keys import EngineKey
from cockroach_tpu_torch.storage.mvcc import MVCC, TxnMeta, _dec_value
from cockroach_tpu_torch.utils import tracing


@dataclass
class RangeDescriptor:
    """Which nodes replicate [start_key, end_key) (roachpb.RangeDescriptor)."""

    range_id: int
    start_key: bytes
    end_key: bytes
    replicas: list[int]          # node ids
    generation: int = 0

    def contains(self, key: bytes) -> bool:
        return self.start_key <= key < self.end_key


@dataclass
class Lease:
    holder: int                  # node id; 0 = none
    epoch: int = 0               # liveness epoch of the holder
    sequence: int = 0


class RangeBoundsError(Exception):
    """Request span is outside the replica's bounds (RangeKeyMismatch)."""

    def __init__(self, desc: RangeDescriptor, key: bytes):
        super().__init__(
            f"key {key!r} outside r{desc.range_id} "
            f"[{desc.start_key!r},{desc.end_key!r})")
        self.desc = desc


def _enc_ts(t: Timestamp) -> list:
    return [t.wall, t.logical]


def _dec_ts(v: list) -> Timestamp:
    return Timestamp(v[0], v[1])


def raise_op_error(res: object) -> object:
    """Decode ONE batch-eval result: MVCC conflicts captured below
    raft (see Replica._eval) re-raise client-side as the same typed
    exceptions the local MVCC plane throws. Every proposer of write
    ops must route results through here (rangekv, distsender, disttxn,
    Cluster.put) — the wire shape lives in exactly one place."""
    if not (isinstance(res, dict) and "error" in res):
        return res
    from cockroach_tpu_torch.storage.mvcc import (WriteIntentError,
                                            WriteTooOldError)
    if res["error"] == "write_intent":
        raise WriteIntentError(
            res["key"].encode("latin1"),
            TxnMeta.from_json(res["txn"].encode()))
    if res["error"] == "write_too_old":
        raise WriteTooOldError.with_actual(
            res["key"].encode("latin1"), _dec_ts(res["actual_ts"]))
    raise RuntimeError(f"range write failed: {res['error']}")


class FollowerReadError(Exception):
    """The follower's closed timestamp has not reached the read ts."""


class Replica:
    def __init__(self, store: "Store", desc: RangeDescriptor):
        self.store = store
        self.desc = desc
        self.raft = RaftNode(store.node_id, list(desc.replicas),
                             rng=store.rng_for(desc.range_id))
        self.mvcc = MVCC()
        self.lease = Lease(holder=0)
        self.applied_index = 0
        self._waiters: dict[str, Callable] = {}
        # bounded dedup window for retried forwarded proposals
        self._applied_ids: set[str] = set()
        self._applied_order: deque[str] = deque()
        self.raft_log_size = 0
        # closed timestamps (pkg/kv/kvserver/closedts): the leaseholder
        # promises no new writes at or below closed_ts. It rides raft
        # commands (so followers learn it at apply time, consistent by
        # construction) and, for idle ranges, the side transport —
        # (ts, applied-index) pairs usable only once this replica has
        # applied that far (the LAI condition of sidetransport).
        self.closed_ts = Timestamp(0, 0)
        self._side_closed: Optional[tuple] = None  # (Timestamp, lai)
        # min write ts of proposals not yet applied here: the closed ts
        # must stay below every in-flight write (the reference's
        # propBuf closed-timestamp tracker, replica_proposal_buf.go)
        self._inflight_wts: dict[str, Timestamp] = {}
        # leaseholder-side timestamp cache (tscache/cache.go is
        # per-leaseholder in the reference): reads served HERE leave
        # their floor HERE, so a write arriving via a different
        # gateway still pushes above every served read. Travels with
        # the lease, not the gateway.
        from ..kv.concurrency import TimestampCache
        self.tscache = TimestampCache()
        from .rangefeed import Processor as RangefeedProcessor
        self.rangefeed = RangefeedProcessor(self)

    # ------------------------------------------------------------------
    # read / write entry points (leaseholder-gated)
    # ------------------------------------------------------------------
    def holds_lease(self) -> bool:
        if self.lease.holder != self.store.node_id:
            return False
        lv = self.store.liveness
        if lv is None:
            return self.raft.is_leader()
        return lv.epoch_of(self.store.node_id) == self.lease.epoch and \
            lv.is_live(self.store.node_id)

    def read(self, op: dict) -> object:
        """Serve a read at this replica (caller checked the lease).

        Spans are validated against the replica's bounds, like the
        server-side CheckRequest validation in the reference: a scan
        must not silently return a partial answer after a split."""
        read_ts = _dec_ts(op["ts"])
        txn = TxnMeta.from_json(op["txn"].encode()) \
            if op.get("txn") else None
        if op["op"] == "get":
            key = op["key"].encode("latin1")
            if not self.desc.contains(key):
                raise RangeBoundsError(self.desc, key)
            mv = self.mvcc.get(key, read_ts, txn=txn)
            return None if mv is None else mv.value
        if op["op"] == "scan":
            start = op["start"].encode("latin1")
            end = op["end"].encode("latin1")
            if not self.desc.contains(start) or end > self.desc.end_key:
                raise RangeBoundsError(self.desc, start)
            return [(mv.key, mv.value) for mv in self.mvcc.scan(
                start, end, read_ts, txn=txn,
                max_keys=op.get("limit", 0))]
        raise ValueError(f"unknown read op {op['op']}")

    # -- closed timestamps / follower reads -----------------------------
    def effective_closed_ts(self) -> Timestamp:
        """What this replica knows to be closed: raft-carried closed_ts
        plus any side-transport update whose lease-applied-index this
        replica has caught up to."""
        out = self.closed_ts
        if self._side_closed is not None:
            ts, lai = self._side_closed
            if self.applied_index >= lai and out < ts:
                out = ts
        return out

    def follower_read(self, op: dict) -> object:
        """Serve a read from THIS replica without the lease, valid only
        at or below the closed timestamp (follower reads,
        kvserver/replica_follower_read.go)."""
        read_ts = _dec_ts(op["ts"])
        closed = self.effective_closed_ts()
        if not (read_ts < closed or read_ts == closed):
            raise FollowerReadError(
                f"r{self.desc.range_id}: read ts {read_ts} above closed "
                f"ts {closed}")
        return self.read(op)

    def handle_side_closed(self, body: dict) -> None:
        ts = _dec_ts(body["ts"])
        lai = int(body["lai"])
        if self._side_closed is None or self._side_closed[0] < ts:
            self._side_closed = (ts, lai)
            eff = self.effective_closed_ts()
            if eff > Timestamp(0, 0):
                self.rangefeed.on_closed(eff)

    def _closed_target(self) -> Timestamp:
        wall = self.store.clock.now().wall - self.store.closedts_target_ns
        target = Timestamp(max(wall, 0), 0)
        for wts in self._inflight_wts.values():
            below = (Timestamp(wts.wall, wts.logical - 1)
                     if wts.logical > 0 else Timestamp(wts.wall - 1, 0))
            if below < target:
                target = below
        return target

    def propose(self, cmd: dict, done: Optional[Callable] = None) -> bool:
        """Propose a write command; ``done(result)`` fires when the
        command applies on THIS replica. Non-leader replicas forward to
        the known leader (etcd raft's MsgProp forwarding) — commands
        are tracked by id, not log index, so completion is observed
        locally regardless of who appended the entry."""
        if "_id" not in cmd:
            # globally unique across replica re-creations: a plain
            # counter would reuse ids after remove+re-add and trip the
            # dedup window on surviving replicas
            cmd["_id"] = f"{self.store.node_id}.{uuid.uuid4().hex[:16]}"
        if cmd.get("kind") == "batch" and self.holds_lease():
            self._prep_closed(cmd)
        if done is not None:
            self._waiters[cmd["_id"]] = done
        # span events fire on the PROPOSER's thread (the one holding
        # the recording); apply runs on the raft pump thread, so the
        # proposer-side waiter observes commit (netcluster
        # _local_propose emits raft-apply there)
        if self.raft.is_leader():
            tracing.event("raft-append", range_id=self.desc.range_id,
                          leader=self.store.node_id)
            self.raft.propose(json.dumps(cmd).encode())
            return True
        leader = self.raft.leader_id
        if leader is not None and leader != self.store.node_id:
            tracing.event("raft-forward", range_id=self.desc.range_id,
                          leader=leader)
            self.store.transport.send(
                self.store.node_id, leader,
                (self.desc.range_id, ("prop", cmd)))
            return True
        self._waiters.pop(cmd["_id"], None)
        return False

    def _prep_closed(self, cmd: dict) -> None:
        """Closed-timestamp discipline at the leaseholder: forward any
        write below the closed ts (the promise to followers is that
        history at or below it is immutable), and carry a new closed
        ts on the command so followers advance at apply time (closedts
        "raft transport")."""
        closed = self.closed_ts
        min_wts = None
        for op in cmd["ops"]:
            if "ts" not in op:
                continue
            wts = _dec_ts(op["ts"])
            if not closed < wts:
                wts = Timestamp(closed.wall, closed.logical + 1)
                op["ts"] = _enc_ts(wts)
            if min_wts is None or wts < min_wts:
                min_wts = wts
        if min_wts is not None:
            self._inflight_wts[cmd["_id"]] = min_wts
        target = self._closed_target()
        if min_wts is not None and not target < min_wts:
            target = Timestamp(min_wts.wall, min_wts.logical - 1) \
                if min_wts.logical > 0 else Timestamp(
                    min_wts.wall - 1, 0)
        if self.closed_ts < target:
            cmd["closed"] = _enc_ts(target)

    def propose_batch(self, cmds: list[dict],
                      dones: list[Optional[Callable]]) -> bool:
        """Group commit: propose a whole batch window of commands as
        ONE raft log entry (raft.propose_group). Each waiter is still
        registered and acked individually at apply time — per-command
        results and errors are preserved. Falls back to per-command
        propose when this replica is not the leader (forwarded
        proposals stay single-command: the leader owns windowing)."""
        if not (self.raft.is_leader() and self.holds_lease()):
            ok = True
            for cmd, done in zip(cmds, dones):
                ok = self.propose(cmd, done) and ok
            return ok
        datas = []
        for cmd, done in zip(cmds, dones):
            if "_id" not in cmd:
                cmd["_id"] = \
                    f"{self.store.node_id}.{uuid.uuid4().hex[:16]}"
            if cmd.get("kind") == "batch":
                self._prep_closed(cmd)
            if done is not None:
                self._waiters[cmd["_id"]] = done
            datas.append(json.dumps(cmd).encode())
        tracing.event("raft-group-append",
                      range_id=self.desc.range_id,
                      commands=len(datas))
        return self.raft.propose_group(datas) is not None

    # ------------------------------------------------------------------
    # raft plumbing
    # ------------------------------------------------------------------
    def step(self, msg) -> None:
        self.raft.step(msg)

    def tick(self) -> None:
        self.raft.tick()

    def handle_ready(self) -> None:
        rd = self.raft.ready()
        if not rd.any():
            return
        if rd.snapshot is not None:
            self._apply_snapshot(rd.snapshot)
        for e in rd.entries:
            self.raft_log_size += len(e.data)
        for m in rd.messages:
            self.store.transport.send(self.store.node_id, m.to,
                                      (self.desc.range_id, ("msg", m)))
        for e in rd.committed_entries:
            self._apply(e.index, e.data)
        # size-triggered raft log truncation (raft_log_queue analogue)
        if self.raft_log_size > self.store.raft_log_max and \
                self.raft.is_leader():
            self.raft.compact(self.applied_index, self._snapshot_state())
            self.raft_log_size = 0

    # ------------------------------------------------------------------
    # state machine
    # ------------------------------------------------------------------
    def _apply(self, index: int, data: bytes) -> None:
        self.applied_index = index
        if not data:
            return
        group = unpack_group(data)
        if group is not None:
            # group-commit entry: unpack and apply each command in
            # proposal order, acking every waiter individually (the
            # apply-side half of the group-commit contract)
            for sub in group:
                self._apply_cmd(json.loads(sub.decode()))
            return
        self._apply_cmd(json.loads(data.decode()))

    def _apply_cmd(self, cmd: dict) -> None:
        cmd_id = cmd.get("_id", "")
        self._inflight_wts.pop(cmd_id, None)
        if cmd_id and cmd_id in self._applied_ids:
            return      # retried forward landed twice: apply once
        if cmd_id:
            self._applied_ids.add(cmd_id)
            self._applied_order.append(cmd_id)
            from ..utils.metamorphic import metamorphic_int
            while len(self._applied_order) > metamorphic_int(
                    "kvserver.dedup_window", 10000, 200, 10000):
                self._applied_ids.discard(self._applied_order.popleft())
        result = self._eval(cmd)
        done = self._waiters.pop(cmd_id, None)
        if done is not None:
            done(result)

    def _eval(self, cmd: dict) -> object:
        kind = cmd.get("kind")
        if kind == "batch":
            from ..storage.mvcc import (WriteIntentError, WriteTooOldError)
            out = []
            for op in cmd["ops"]:
                # MVCC conflicts surface as RESULTS, not exceptions:
                # every replica computes the same error deterministically
                # in log order and the proposer's waiter re-raises
                # client-side (the eval-error half of the reference's
                # below-raft apply contract, replica_application.go)
                try:
                    out.append(self._eval_op(op))
                except WriteIntentError as e:
                    out.append({"error": "write_intent",
                                "key": e.key.decode("latin1"),
                                "txn": e.txn_meta.to_json().decode()})
                except WriteTooOldError as e:
                    out.append({"error": "write_too_old",
                                "key": e.key.decode("latin1"),
                                "actual_ts": _enc_ts(e.actual_ts)})
            if "closed" in cmd:
                # applied on every replica in log order: a follower's
                # closed_ts never runs ahead of its applied state
                ts = _dec_ts(cmd["closed"])
                if self.closed_ts < ts:
                    self.closed_ts = ts
                    self.rangefeed.on_closed(ts)
            return out
        if kind == "lease":
            self.lease = Lease(cmd["holder"], cmd["epoch"],
                               self.lease.sequence + 1)
            return self.lease
        if kind == "live_hb":
            # heartbeat of the replicated liveness record: epochs only
            # ratchet forward, expirations only extend (deterministic:
            # a pure function of cmd + current record)
            node, ep, exp = cmd["node"], cmd["epoch"], cmd["exp"]
            cur = self.store.repl_liveness.get(node)
            if cur is None or ep > cur[0]:
                self.store.repl_liveness[node] = (ep, exp)
            elif ep == cur[0] and exp > cur[1]:
                self.store.repl_liveness[node] = (ep, exp)
            # mirror the authoritative epoch into the gossip-plane
            # view so Replica.holds_lease (which compares the local
            # NodeLiveness epoch) agrees with leases taken under the
            # replicated record
            lv = self.store.liveness
            if lv is not None:
                rec = lv.records.get(node)
                if rec is None:
                    rec = lv.heartbeat(node)
                if rec.epoch < self.store.repl_liveness[node][0]:
                    rec.epoch = self.store.repl_liveness[node][0]
            return self.store.repl_liveness[node]
        if kind == "live_bump":
            # IncrementEpoch: CPut semantics — fence a node's leases
            # iff its record still has the expected epoch AND had
            # already expired at the proposer's observed now
            node, expect = cmd["node"], cmd["expect_epoch"]
            cur = self.store.repl_liveness.get(node)
            if cur is None or cur[0] != expect or cur[1] >= cmd["now"]:
                return {"ok": False,
                        "epoch": cur[0] if cur else 0}
            self.store.repl_liveness[node] = (cur[0] + 1, cur[1])
            return {"ok": True, "epoch": cur[0] + 1}
        if kind == "split":
            return self._apply_split(cmd)
        if kind == "merge":
            return self._apply_merge(cmd)
        if kind == "change_replicas":
            return self._apply_change_replicas(cmd)
        raise ValueError(f"unknown command kind {kind}")

    # -- range lifecycle triggers (applied below raft, so they run
    # deterministically on every replica: splitTrigger/mergeTrigger of
    # batcheval/cmd_end_transaction.go, simplified) -------------------
    def _apply_split(self, cmd: dict) -> RangeDescriptor:
        split_key = cmd["key"].encode("latin1")
        rhs = RangeDescriptor(cmd["new_range_id"], split_key,
                              self.desc.end_key, list(self.desc.replicas),
                              generation=self.desc.generation + 1)
        self.desc.end_key = split_key
        self.desc.generation += 1
        rhs_rep = self.store.create_replica(rhs)
        # move user data at keys >= split_key into the RHS engine;
        # local move — no snapshot needed, exactly like splitTrigger
        moved = []
        for ek, v in list(self.mvcc.engine.scan(EngineKey(split_key, -1),
                                                include_tombstones=True)):
            if ek.key >= split_key:
                moved.append((ek, v))
        # txn records (b"\x00txn/") sort below every user key and would
        # otherwise always stay on the LHS; move each with its anchor so
        # pushes routed by the anchor key keep finding the record after
        # the split (the reference's splitTrigger rewrites range-local
        # keys.TransactionKey entries the same way). All versions of a
        # record key travel together — moving the value but leaving its
        # deletion tombstone behind would resurrect a resolved record.
        rec_entries: dict[bytes, list] = {}
        rec_anchor: dict[bytes, bytes] = {}
        for ek, v in list(self.mvcc.engine.scan(EngineKey(b"\x00txn/", -1),
                                                include_tombstones=True)):
            if not ek.key.startswith(b"\x00txn/"):
                break
            rec_entries.setdefault(ek.key, []).append((ek, v))
            decoded = _dec_value(v) if v else None
            if decoded and ek.key not in rec_anchor:
                try:
                    rec_anchor[ek.key] = json.loads(
                        decoded.decode()).get("anchor", "").encode("latin1")
                except (ValueError, UnicodeDecodeError):
                    pass
        for rkey, entries in rec_entries.items():
            if rec_anchor.get(rkey, b"") >= split_key:
                moved.extend(entries)
        for ek, v in moved:
            if v is not None:
                rhs_rep.mvcc.engine.put(ek, v)
            else:
                rhs_rep.mvcc.engine.delete(ek)
            self.mvcc.engine.delete(ek)
        rhs_rep.lease = Lease(self.lease.holder, self.lease.epoch,
                              sequence=1)
        return rhs

    def _apply_merge(self, cmd: dict) -> RangeDescriptor:
        # the merge trigger carries the subsumed RHS state in the
        # command (the orchestrator read it from the RHS leaseholder at
        # freeze time), so application is deterministic even on stores
        # whose local RHS replica lags or is absent
        for k, v in cmd["rhs_state"]:
            ek = EngineKey.decode(k.encode("latin1"))
            if v is not None:
                self.mvcc.engine.put(ek, v.encode("latin1"))
            else:
                self.mvcc.engine.delete(ek)
        self.desc.end_key = cmd["rhs_end_key"].encode("latin1")
        self.desc.generation += 1
        self.store.remove_replica(cmd["rhs_range_id"])
        return self.desc

    def _apply_change_replicas(self, cmd: dict) -> RangeDescriptor:
        gen = cmd.get("generation")
        if gen is not None and gen <= self.desc.generation:
            # stale config from log replay: a learner created at
            # generation G starts with the config of its own addition;
            # replaying an older change (e.g. one that predates its
            # membership) must not remove it (the reference seeds new
            # replicas via snapshot at a log position, so they never
            # see pre-membership entries)
            return self.desc
        new_replicas = list(cmd["replicas"])
        self.desc.replicas = new_replicas
        self.desc.generation = (gen if gen is not None
                                else self.desc.generation + 1)
        if self.store.node_id not in new_replicas:
            self.store.remove_replica(self.desc.range_id)
        else:
            self.raft.update_membership(new_replicas)
        return self.desc

    def _eval_op(self, op: dict) -> object:
        from ..storage.mvcc import TxnStatus
        o = op["op"]
        wts = _dec_ts(op["ts"]) if "ts" in op else None
        txn = TxnMeta.from_json(op["txn"].encode()) if op.get("txn") else None
        if o == "put":
            key = op["key"].encode("latin1")
            self.mvcc.put(key, wts, op["value"].encode("latin1"), txn=txn)
            if txn is None:
                # committed immediately; intent writes emit at resolve
                self.rangefeed.on_value(
                    key, op["value"].encode("latin1"), wts)
                return True
            # mvcc.put may bump the intent ts past an existing version
            # (WriteTooOld); report the ts actually written so a
            # gateway txn coordinating over raft can adopt it
            return {"ok": True, "wts": _enc_ts(txn.write_ts)}
        if o == "delete":
            key = op["key"].encode("latin1")
            self.mvcc.delete(key, wts, txn=txn)
            if txn is None:
                self.rangefeed.on_value(key, None, wts)
                return True
            return {"ok": True, "wts": _enc_ts(txn.write_ts)}
        if o == "txn_record":
            # Conditional transaction-record state machine, the atomic
            # moment of the push/commit protocol
            # (batcheval/cmd_push_txn.go, cmd_end_transaction.go,
            # cmd_recover_txn.go). Evaluated below raft so every
            # replica decides identically in log order:
            #   absent   -> any status writes (committed / aborted /
            #               staging)
            #   staging  -> may transition to committed (explicit
            #               commit, or recovery finding every declared
            #               write present) or aborted (recovery finding
            #               one missing); idempotent re-stage allowed
            #   committed/aborted -> terminal; a different status
            #               reports the existing record instead
            key = op["key"].encode("latin1")
            want = op["status"]
            mv = self.mvcc.get(key, MAX_TIMESTAMP, inconsistent=True)
            if mv is not None:
                existing = json.loads(mv.value.decode())
                ex = existing["status"]
                if ex == want:
                    # idempotent retry: report the applied record's ts
                    # so a re-committed txn adopts it instead of
                    # minting a new one
                    return {"ok": True, "existing": ex,
                            "existing_ts": existing["ts"]}
                if ex == "staging" and (
                        want == "committed"
                        or (want == "aborted"
                            and op.get("finalize_staging"))):
                    # staging -> aborted requires finalize authority
                    # (recovery's write-set proof or the coordinator);
                    # a pusher's blind poison instead fails below with
                    # existing='staging' and runs recovery — otherwise
                    # it could abort a parallel commit whose
                    # implicit-commit condition already holds
                    rec = json.dumps({
                        "status": want, "ts": op["ts"],
                        "anchor": existing.get("anchor", "")})
                    # records are control state, not MVCC-versioned
                    # data: the rewrite always lands strictly above
                    # the staging version (same-ts would be
                    # write-too-old at the MVCC layer)
                    at = max(wts, Timestamp(mv.ts.wall,
                                            mv.ts.logical + 1))
                    self.mvcc.put(key, at, rec.encode())
                    return {"ok": True, "existing": ex,
                            "existing_ts": existing["ts"]}
                return {"ok": False, "existing": ex,
                        "existing_ts": existing["ts"]}
            # the anchor key travels in the record so splitTrigger can
            # keep the record co-located with its anchor's range; a
            # STAGING record also declares the txn's write set — the
            # recovery proof (parallel commits)
            rec = {"status": want, "ts": op["ts"],
                   "anchor": op.get("anchor", "")}
            if "writes" in op:
                rec["writes"] = op["writes"]
            self.mvcc.put(key, wts, json.dumps(rec).encode())
            return {"ok": True, "existing": None}
        if o == "resolve":
            key = op["key"].encode("latin1")
            commit = bool(op["commit"])
            commit_ts = _dec_ts(op["commit_ts"]) \
                if op.get("commit_ts") else None
            # capture the provisional value BEFORE the meta is removed
            # so a commit can emit it on the rangefeed
            val = None
            if commit:
                mv = self.mvcc._newest_version(key, txn.write_ts)
                if mv is not None and mv.ts == txn.write_ts:
                    val = mv.value
            done = self.mvcc.resolve_intent(
                key, txn,
                TxnStatus.COMMITTED if commit else TxnStatus.ABORTED,
                commit_ts=commit_ts)
            if done and commit:
                self.rangefeed.on_value(key, val,
                                        commit_ts or txn.write_ts)
            return True
        raise ValueError(f"unknown write op {o}")

    # ------------------------------------------------------------------
    # snapshots (InstallSnapshot / store_snapshot.go analogue)
    # ------------------------------------------------------------------
    def _snapshot_state(self) -> bytes:
        items = [(k.encode().decode("latin1"), v.decode("latin1"))
                 for k, v in self.mvcc.engine.scan(EngineKey(b"", -1))]
        return json.dumps({
            "kv": items,
            "lease": [self.lease.holder, self.lease.epoch,
                      self.lease.sequence],
            # descriptor travels with the snapshot: a follower restored
            # past compacted split/change_replicas triggers must still
            # learn its bounds and membership
            "desc": [self.desc.range_id,
                     self.desc.start_key.decode("latin1"),
                     self.desc.end_key.decode("latin1"),
                     list(self.desc.replicas), self.desc.generation],
        }).encode()

    def _apply_snapshot(self, snap: Snapshot) -> None:
        if not snap.data:
            return
        state = json.loads(snap.data.decode())
        self.mvcc = MVCC()
        for k, v in state["kv"]:
            self.mvcc.engine.put(EngineKey.decode(k.encode("latin1")),
                                 v.encode("latin1"))
        h, e, s = state["lease"]
        self.lease = Lease(h, e, s)
        if "desc" in state:
            rid, sk, ek2, reps, gen = state["desc"]
            if gen > self.desc.generation:
                self.desc = RangeDescriptor(rid, sk.encode("latin1"),
                                            ek2.encode("latin1"),
                                            list(reps), gen)
                self.raft.update_membership(list(reps))
        self.applied_index = snap.index


class Store:
    """All replicas on one node (pkg/kv/kvserver/store.go)."""

    def __init__(self, node_id: int, transport, clock: Optional[Clock] = None,
                 liveness=None, raft_log_max: int | None = None,
                 seed: int = 0,
                 closedts_target_ns: int = int(3e9)):
        self.node_id = node_id
        self.transport = transport
        self.clock = clock or Clock()
        self.liveness = liveness
        from ..utils.metamorphic import metamorphic_pow2
        if raft_log_max is None:
            raft_log_max = metamorphic_pow2(
                "kvserver.raft_log_max", 1 << 20, 12, 20)
        self.raft_log_max = raft_log_max
        # how far behind now the leaseholder closes (the reference's
        # kv.closed_timestamp.target_duration, default 3s)
        self.closedts_target_ns = closedts_target_ns
        # replicated liveness records: node_id -> (epoch, exp_hlc_int),
        # written ONLY by raft apply of live_hb/live_bump commands on
        # the system range (netcluster's linearized liveness plane;
        # liveness.go:185 stores the same records in a system range).
        # Empty on clusters that keep the gossip/tick NodeLiveness.
        self.repl_liveness: dict[int, tuple[int, int]] = {}
        self.replicas: dict[int, Replica] = {}
        self._seed = seed
        transport.register(node_id, self._handle_raft_message)

    def rng_for(self, range_id: int):
        import random
        return random.Random((self._seed << 16) ^ (self.node_id << 8)
                             ^ range_id)

    def create_replica(self, desc: RangeDescriptor) -> Replica:
        # every replica owns its descriptor copy: range-lifecycle
        # triggers mutate it independently below raft on each store
        r = Replica(self, copy.deepcopy(desc))
        self.replicas[desc.range_id] = r
        return r

    def remove_replica(self, range_id: int) -> None:
        self.replicas.pop(range_id, None)

    def replica_for_key(self, key: bytes) -> Optional[Replica]:
        for r in self.replicas.values():
            if r.desc.contains(key):
                return r
        return None

    def _handle_raft_message(self, frm: int, payload) -> None:
        range_id, (kind, body) = payload
        r = self.replicas.get(range_id)
        if r is None:
            return
        if kind == "msg":
            r.step(body)
        elif kind == "prop":
            # forwarded proposal: append if we are (still) the leader;
            # otherwise drop — the proposer's retry loop re-sends
            if r.raft.is_leader():
                r.raft.propose(json.dumps(body).encode())
        elif kind == "closedts":
            r.handle_side_closed(body)

    def tick(self) -> None:
        for r in list(self.replicas.values()):
            r.tick()

    def handle_ready_all(self) -> None:
        for r in list(self.replicas.values()):
            r.handle_ready()

    def broadcast_closed_ts(self) -> None:
        """Side transport for idle ranges (closedts/sidetransport
        sender.go:38): each leaseholder advances its closed ts toward
        now - target and ships (ts, applied index) to followers — no
        raft traffic needed on quiescent ranges."""
        for r in list(self.replicas.values()):
            if not r.holds_lease():
                continue
            target = r._closed_target()
            if r.closed_ts < target:
                r.closed_ts = target
                r.rangefeed.on_closed(target)
            body = {"ts": _enc_ts(r.closed_ts),
                    "lai": r.applied_index}
            for nid in r.desc.replicas:
                if nid != self.node_id:
                    self.transport.send(
                        self.node_id, nid,
                        (r.desc.range_id, ("closedts", body)))
