"""In-process multi-node cluster: N stores over a local transport
(cockroach_tpu/kvserver/cluster.py).

The analogue of ``testcluster.StartTestCluster``
(``pkg/testutils/testcluster/testcluster.go:58,233``): N real stores
with real raft replication and liveness in one process, driven by a
deterministic pump instead of goroutines. This is both the integration
-test harness and the substrate the distributed SQL layer schedules
flows onto.

Request routing here is deliberately minimal (try replicas until the
leaseholder answers); the full DistSender with range cache lives in
``kv/distsender.py``.
"""

from __future__ import annotations

import json
from typing import Optional

from cockroach_tpu_torch.kvserver.liveness import NodeLiveness
from cockroach_tpu_torch.kvserver.store import (EngineKey, Lease, RangeDescriptor,
                                          Replica, Store, _enc_ts,
                                          raise_op_error)
from cockroach_tpu_torch.kvserver.transport import LocalTransport
from cockroach_tpu_torch.storage.hlc import Clock
from cockroach_tpu_torch.utils.circuit import Breaker, BreakerTrippedError


class AmbiguousResultError(RuntimeError):
    """The proposal's fate is unknown: it reached raft (locally or via a
    forward) but the waiter timed out before observing the apply. It may
    still commit; a caller that blindly retries with a NEW command id
    could double-apply semantically (the reference returns
    AmbiguousResultError from this window, kvpb/errors.go)."""


class NotLeaseholderError(Exception):
    """Request hit a non-leaseholder replica; retry at ``hint``."""

    def __init__(self, range_id: Optional[int] = None,
                 hint: Optional[int] = None):
        super().__init__(f"r{range_id}: not leaseholder (try n{hint})")
        self.range_id = range_id
        self.hint = hint


class Cluster:
    def __init__(self, n_nodes: int = 3, seed: int = 0,
                 liveness_ttl: int = 30, transport=None):
        # pass transport=ChaosTransport(seed) for an adversarial
        # reorder/duplicate/delay delivery schedule
        self.transport = transport or LocalTransport()
        self.liveness = NodeLiveness(ttl_ticks=liveness_ttl)
        self.clock = Clock()
        self.stores: dict[int, Store] = {}
        self.descriptors: dict[int, RangeDescriptor] = {}
        self.down: set[int] = set()
        self._next_range_id = 1
        # per-range circuit breakers on the data path (the analogue of
        # per-replica breakers, replica_circuit_breaker.go): an
        # unavailable range fails fast instead of hanging each request
        # through the full proposal retry loop
        self.breakers: dict[int, Breaker] = {}
        # per-range request counters (QPS stand-in) feeding the
        # load-weighted lease rebalancer (store_rebalancer.go)
        self.range_load: dict[int, int] = {}
        for node_id in range(1, n_nodes + 1):
            self.stores[node_id] = Store(node_id, self.transport,
                                         clock=self.clock,
                                         liveness=self.liveness, seed=seed)
            self.liveness.heartbeat(node_id)

    # ------------------------------------------------------------------
    # topology
    # ------------------------------------------------------------------
    def create_range(self, start_key: bytes, end_key: bytes,
                     replicas: Optional[list[int]] = None
                     ) -> RangeDescriptor:
        replicas = replicas or sorted(self.stores)[:3]
        desc = RangeDescriptor(self._next_range_id, start_key, end_key,
                               list(replicas))
        self._next_range_id += 1
        self.descriptors[desc.range_id] = desc
        for nid in replicas:
            self.stores[nid].create_replica(desc)
        return desc

    def range_for_key(self, key: bytes) -> Optional[RangeDescriptor]:
        for d in self.descriptors.values():
            if d.contains(key):
                return d
        return None

    # ------------------------------------------------------------------
    # pump (the scheduler: ticks, ready handling, message delivery)
    # ------------------------------------------------------------------
    def _decommissioned(self, nid: int) -> bool:
        rec = self.liveness.records.get(nid)
        return rec is not None and rec.decommissioning

    def _can_heartbeat(self, nid: int) -> bool:
        """Liveness records live in a replicated system range; a node
        that cannot reach a quorum of the cluster cannot write its
        heartbeat (so partitioned nodes lapse, like the reference).
        Decommissioned nodes are out of the membership entirely."""
        if self._decommissioned(nid):
            return False  # out of the cluster: no more heartbeats
        members = [p for p in self.stores
                   if not self._decommissioned(p)]
        n = len(members)
        reachable = 1 + sum(
            1 for p in members
            if p != nid and p not in self.down
            and not self.transport._blocked(nid, p))
        return reachable > n // 2

    def decommission(self, node_id: int) -> None:
        """Permanently remove a (dead) node from the cluster membership
        (the operator's `node decommission`): it stops counting toward
        the liveness-write majority and can never hold leases again —
        the prerequisite for loss-of-quorum recovery when a majority of
        nodes is gone for good."""
        rec = self.liveness.records.get(node_id)
        if rec is not None:
            rec.decommissioning = True

    def pump(self, iterations: int = 1) -> None:
        for _ in range(iterations):
            self.liveness.tick()
            for nid, store in self.stores.items():
                if nid in self.down:
                    continue
                if self._can_heartbeat(nid):
                    self.liveness.heartbeat(nid)
                store.tick()
                store.handle_ready_all()
            self.transport.deliver_all()
            for nid, store in self.stores.items():
                if nid not in self.down:
                    store.handle_ready_all()

    def check_replica_consistency(self, range_id: int) -> None:
        """Assert every up replica of a range holds identical applied
        MVCC state — the consistency-checker queue's checksum compare
        (kvserver/consistency_queue.go), done by direct comparison.
        Call after draining traffic; raises AssertionError on
        divergence."""
        states = {}
        for nid, s in self.stores.items():
            if nid in self.down or range_id not in s.replicas:
                continue
            rep = s.replicas[range_id]
            states[nid] = rep._snapshot_state()
        vals = list(states.values())
        for nid, st in states.items():
            if st != vals[0]:
                first = next(iter(states))
                raise AssertionError(
                    f"replica divergence on r{range_id}: node {nid} "
                    f"!= node {first}")

    def tick_closed_ts(self) -> None:
        """One side-transport round: every live leaseholder closes up
        to now - target and ships it to followers (then pump delivers)."""
        for nid, store in self.stores.items():
            if nid not in self.down:
                store.broadcast_closed_ts()
        self.transport.deliver_all()

    def follower_get(self, key: bytes, node_id: int,
                     ts=None) -> Optional[bytes]:
        """Read from a specific (possibly follower) replica at ts —
        succeeds only below that replica's closed timestamp."""
        desc = self.range_for_key(key)
        if desc is None:
            raise KeyError(f"no range for key {key!r}")
        rep = self.stores[node_id].replicas[desc.range_id]
        return rep.follower_read({
            "op": "get", "key": key.decode("latin1"),
            "ts": _enc_ts(ts or self.clock.now())})

    def pump_until(self, cond, max_iter: int = 500) -> bool:
        for _ in range(max_iter):
            if cond():
                return True
            self.pump()
        return cond()

    # -- fault injection -------------------------------------------
    def stop_node(self, node_id: int) -> None:
        self.down.add(node_id)
        self.transport.stop_node(node_id)

    def restart_node(self, node_id: int) -> None:
        self.down.discard(node_id)
        self.transport.restart_node(node_id)
        self.liveness.heartbeat(node_id)
        # reconcile replicas from meta: a node restored by snapshot may
        # have missed below-raft split triggers whose log entries were
        # compacted, so ranges it should serve have no local replica
        # (the reference learns these from meta + incoming raft traffic)
        store = self.stores[node_id]
        for desc in self.descriptors.values():
            if node_id in desc.replicas and \
                    desc.range_id not in store.replicas:
                store.create_replica(desc)
        # replicaGC husks: ranges whose config moved on while the node
        # was down (e.g. loss-of-quorum recovery excluded it) — the
        # meta descriptor is authoritative
        for rid in [rid for rid, r in store.replicas.items()
                    if rid in self.descriptors
                    and node_id not in self.descriptors[rid].replicas]:
            store.remove_replica(rid)

    # ------------------------------------------------------------------
    # range lifecycle (split/merge queues + replicate queue/allocator)
    # ------------------------------------------------------------------
    def propose_and_wait(self, rep, cmd: dict, max_iter: int = 500):
        """Propose on ``rep`` (forwarding to the leader as needed) and
        pump until the command applies locally; retries around
        elections. Raises if the command never commits."""
        out = {}

        def cb(result):
            out["result"] = result
            out["ok"] = True

        reached_raft = False
        for _ in range(5):
            if rep.propose(cmd, cb):
                reached_raft = True
                if self.pump_until(lambda: "ok" in out, max_iter):
                    return out["result"]
            else:
                self.pump(5)
        rep._waiters.pop(cmd.get("_id", ""), None)   # don't leak the cb
        # the dedup window is the commit record: if the id landed there,
        # the command applied but the callback raced our timeout
        if cmd.get("_id", "") in rep._applied_ids:
            raise AmbiguousResultError(
                "proposal applied but result was not observed")
        if reached_raft:
            # a forwarded/appended attempt can still commit after we
            # stop waiting — this is NOT a definite failure
            raise AmbiguousResultError(
                "proposal handed to raft but not observed to commit")
        raise RuntimeError("proposal did not commit (quorum lost?)")

    def _propose_admin(self, range_id: int, cmd: dict,
                       max_iter: int = 500):
        lh = self.ensure_lease(range_id)
        if lh is None:
            raise RuntimeError(f"r{range_id}: no leaseholder")
        rep = self.stores[lh].replicas[range_id]
        return self.propose_and_wait(rep, cmd, max_iter)

    def split_range(self, key: bytes) -> RangeDescriptor:
        """AdminSplit: replicate a split trigger through the LHS group."""
        lhs = self.range_for_key(key)
        if lhs is None:
            raise KeyError(f"no range for {key!r}")
        if lhs.start_key == key:
            return lhs
        new_id = self._next_range_id
        self._next_range_id += 1
        rhs = self._propose_admin(lhs.range_id, {
            "kind": "split", "key": key.decode("latin1"),
            "new_range_id": new_id,
        })
        # mirror _apply_split's generation bumps so the cluster-side
        # descriptors stay in sync with the replicas' state machines
        # (change_replicas' stale-config guard compares generations)
        self.descriptors[new_id] = RangeDescriptor(
            new_id, key, lhs.end_key, list(lhs.replicas),
            generation=lhs.generation + 1)
        lhs.end_key = key
        lhs.generation += 1
        from ..utils import log
        log.structured(log.STORAGE, "range_split",
                       lhs=lhs.range_id, rhs=new_id,
                       split_key=key.decode("latin1"))
        return self.descriptors[new_id]

    def merge_ranges(self, lhs_range_id: int) -> RangeDescriptor:
        """AdminMerge: absorb the right-hand neighbour into the LHS."""
        lhs = self.descriptors[lhs_range_id]
        rhs = next((d for d in self.descriptors.values()
                    if d.start_key == lhs.end_key), None)
        if rhs is None:
            raise KeyError("no right-hand neighbour")
        if sorted(rhs.replicas) != sorted(lhs.replicas):
            raise RuntimeError("merge requires colocated replica sets")
        # subsume: freeze the RHS by reading its full state from the
        # (caught-up) leaseholder and carrying it in the merge trigger
        rhs_lh = self.ensure_lease(rhs.range_id)
        if rhs_lh is None:
            raise RuntimeError(f"r{rhs.range_id}: no leaseholder")
        rhs_rep = self.stores[rhs_lh].replicas[rhs.range_id]
        # drain in-flight RHS proposals before snapshotting: an acked
        # write must not vanish into a pre-write rhs_state (Subsume
        # blocks new traffic in the reference; here the orchestrator is
        # single-threaded, so draining is sufficient)
        drained = self.pump_until(
            lambda: rhs_rep.applied_index >= rhs_rep.raft.commit
            and not rhs_rep._waiters, 200)
        if not drained:
            raise RuntimeError(
                f"r{rhs.range_id}: cannot subsume, in-flight proposals")
        rhs_state = [(ek.encode().decode("latin1"),
                      None if v is None else v.decode("latin1"))
                     for ek, v in rhs_rep.mvcc.engine.scan(
                         EngineKey(b"", -1), include_tombstones=True)]
        self._propose_admin(lhs_range_id, {
            "kind": "merge", "rhs_range_id": rhs.range_id,
            "rhs_end_key": rhs.end_key.decode("latin1"),
            "rhs_state": rhs_state,
        })
        lhs.end_key = rhs.end_key
        lhs.generation += 1  # mirror _apply_merge's bump
        del self.descriptors[rhs.range_id]
        return lhs

    def change_replicas(self, range_id: int,
                        add: Optional[int] = None,
                        remove: Optional[int] = None) -> None:
        """One replica at a time (the simple-majority membership-change
        restriction; the reference uses joint consensus to lift it)."""
        desc = self.descriptors[range_id]
        new = [n for n in desc.replicas if n != remove]
        if add is not None and add not in new:
            new.append(add)
        if remove is not None and not new:
            raise RuntimeError(f"r{range_id}: cannot remove last replica")
        if remove is not None and self.leaseholder(range_id) == remove:
            # Removing a live leaseholder would wedge the range: the
            # survivors' lease record keeps naming a node that stays
            # live and unfenced, so no one can ever re-acquire. Transfer
            # the lease to a surviving replica first (the reference
            # transfers or rejects, replica_command.go).
            target = next((n for n in new if n not in self.down
                           and self.liveness.is_live(n)), None)
            if target is None:
                raise RuntimeError(
                    f"r{range_id}: cannot remove leaseholder n{remove}: "
                    "no live survivor to transfer the lease to")
            lh_rep = self.stores[remove].replicas[range_id]
            self.propose_and_wait(lh_rep, {
                "kind": "lease", "holder": target,
                "epoch": self.liveness.epoch_of(target)})
            # the transfer applied on the proposer; wait for the TARGET
            # to apply it too, or the lease exists only on the node we
            # are about to remove
            if not self.pump_until(
                    lambda: self.leaseholder(range_id) == target, 200):
                raise RuntimeError(
                    f"r{range_id}: lease transfer to n{target} did not "
                    "apply")
        newgen = desc.generation + 1
        if add is not None:
            # materialize the learner replica before the config commits
            # so it can receive raft traffic (snapshot-before-voter);
            # it is born at the NEW generation so log replay of older
            # config changes cannot remove it
            self.stores[add].create_replica(
                RangeDescriptor(range_id, desc.start_key, desc.end_key,
                                list(new), newgen))
        self._propose_admin(range_id, {
            "kind": "change_replicas", "replicas": new,
            "generation": newgen,
        })
        desc.replicas = new
        desc.generation = newgen
        if remove is not None and remove in self.stores:
            # replicaGC-queue analogue: the removed node stops getting
            # raft traffic before it can apply its own removal, so the
            # orchestrator (meta authority) collects the husk
            self.stores[remove].remove_replica(range_id)

    def replicate_queue_scan(self, target: int = 3) -> list[str]:
        """The replicate queue + allocator ComputeAction analogue:
        up-replicate under-replicated ranges and replace replicas on
        dead nodes (allocatorimpl/allocator.go:560)."""
        actions = []
        live = [n for n in self.stores if n not in self.down
                and self.liveness.is_live(n)]
        load = {n: 0 for n in live}
        for d in self.descriptors.values():
            for n in d.replicas:
                if n in load:
                    load[n] += 1
        for d in list(self.descriptors.values()):
            dead = [n for n in d.replicas if n not in live]
            live_members = [n for n in d.replicas if n in live]
            # replace-dead first (only while quorum of the old config
            # still stands), then up-replicate
            candidates = sorted((n for n in live if n not in d.replicas),
                                key=lambda n: load[n])
            if dead and len(live_members) > len(d.replicas) // 2 \
                    and candidates:
                # one replica at a time (change_replicas' safety
                # condition): add the replacement first, then remove
                # the dead member in a second config change
                add = candidates[0]
                self.change_replicas(d.range_id, add=add)
                self.change_replicas(d.range_id, remove=dead[0])
                load[add] += 1
                actions.append(f"r{d.range_id}: replace n{dead[0]} "
                               f"with n{add}")
            elif len(d.replicas) < min(target, len(live)) and candidates:
                add = candidates[0]
                self.change_replicas(d.range_id, add=add)
                load[add] += 1
                actions.append(f"r{d.range_id}: add n{add}")
        return actions

    def add_node(self) -> int:
        """Join a fresh empty store to the cluster (node addition; the
        rebalancer then moves replicas/leases onto it)."""
        node_id = max(self.stores) + 1
        self.stores[node_id] = Store(node_id, self.transport,
                                     clock=self.clock,
                                     liveness=self.liveness)
        self.liveness.heartbeat(node_id)
        return node_id

    def transfer_lease(self, range_id: int, to: int,
                       max_iter: int = 500) -> bool:
        """Cooperative lease transfer: the current holder proposes a
        lease record naming `to` (TransferLease,
        replica_range_lease.go). `to` must be a live replica member."""
        desc = self.descriptors.get(range_id)
        if desc is None or to not in desc.replicas or to in self.down \
                or not self.liveness.is_live(to):
            return False
        cur = self.leaseholder(range_id)
        if cur is None or cur == to:
            return cur == to
        lh_rep = self.stores[cur].replicas.get(range_id)
        if lh_rep is None:
            return False
        self.propose_and_wait(lh_rep, {
            "kind": "lease", "holder": to,
            "epoch": self.liveness.epoch_of(to)}, max_iter)
        return self.pump_until(
            lambda: self.leaseholder(range_id) == to, max_iter)

    def rebalance_scan(self, target: int = 3) -> list[str]:
        """Load/space-aware rebalancing (the allocator's rebalance
        actions + the store rebalancer: allocatorimpl/allocator.go:848,
        store_rebalancer.go). Two passes, one move per range per scan:

        1. replica counts: while the fullest live store holds 2+ more
           replicas than the emptiest, move one replica of a range it
           holds (and the emptiest lacks) over — add-then-remove, the
           same one-at-a-time discipline as the repair path.
        2. lease counts, weighted by per-range request load when the
           cluster has observed any (`range_load`): transfer leases
           from the busiest holder to the least-busy replica member.
        """
        actions: list[str] = []
        live = [n for n in self.stores if n not in self.down
                and self.liveness.is_live(n)]
        if len(live) < 2:
            return actions
        # -- pass 1: replica placement by count --------------------------
        counts = {n: 0 for n in live}
        for d in self.descriptors.values():
            for n in d.replicas:
                if n in counts:
                    counts[n] += 1
        moved = True
        while moved:
            moved = False
            full = max(live, key=lambda n: counts[n])
            empty = min(live, key=lambda n: counts[n])
            if counts[full] - counts[empty] < 2:
                break
            for d in self.descriptors.values():
                if full in d.replicas and empty not in d.replicas:
                    self.change_replicas(d.range_id, add=empty)
                    self.change_replicas(d.range_id, remove=full)
                    counts[full] -= 1
                    counts[empty] += 1
                    actions.append(f"r{d.range_id}: move replica "
                                   f"n{full} -> n{empty}")
                    moved = True
                    break
        # -- pass 2: lease placement by (load-weighted) count ------------
        # exponential decay per scan: yesterday's hot range must not
        # dominate today's placement (the reference uses decaying
        # per-replica QPS, store_rebalancer.go)
        for rid in list(self.range_load):
            self.range_load[rid] //= 2
            if self.range_load[rid] == 0:
                del self.range_load[rid]
        loads = self.range_load
        def weight(rid):
            return max(loads.get(rid, 0), 1)
        holder_load = {n: 0 for n in live}
        holders = {}
        for d in self.descriptors.values():
            lh = self.leaseholder(d.range_id)
            holders[d.range_id] = lh
            if lh in holder_load:
                holder_load[lh] += weight(d.range_id)
        moved = True
        while moved:
            moved = False
            busy = max(live, key=lambda n: holder_load[n])
            idle = min(live, key=lambda n: holder_load[n])
            gap = holder_load[busy] - holder_load[idle]
            for rid, lh in holders.items():
                if lh != busy:
                    continue
                w = weight(rid)
                if w * 2 > gap:   # moving it would overshoot
                    continue
                d = self.descriptors[rid]
                if idle not in d.replicas or not \
                        self.transfer_lease(rid, idle):
                    continue
                holder_load[busy] -= w
                holder_load[idle] += w
                holders[rid] = idle
                actions.append(f"r{rid}: lease n{busy} -> n{idle}")
                moved = True
                break
        return actions

    # ------------------------------------------------------------------
    # leases
    # ------------------------------------------------------------------
    def acquire_lease(self, range_id: int, node_id: int,
                      max_iter: int = 500) -> bool:
        """Have node_id's replica acquire the epoch lease for the range
        (request_lease path of replica_range_lease.go): fence a dead
        prior holder by epoch increment, then replicate a lease record."""
        rep = self.stores[node_id].replicas.get(range_id)
        if rep is None:
            return False
        self.pump_until(lambda: rep.raft.is_leader() or
                        rep.raft.leader_id is not None, max_iter)
        if not rep.raft.is_leader():
            return False
        cur = rep.lease
        # a holder no longer in the range's replica set is implicitly
        # fenced — it can never serve the range again (defense in depth
        # alongside the transfer-before-remove in change_replicas)
        holder_is_member = cur.holder in rep.desc.replicas
        if cur.holder and cur.holder != node_id and holder_is_member and \
                self.liveness.epoch_of(cur.holder) == cur.epoch and \
                self.liveness.is_live(cur.holder):
            return False         # current holder is alive and unfenced
        if cur.holder and cur.holder != node_id and holder_is_member and \
                self.liveness.epoch_of(cur.holder) == cur.epoch:
            # fencing a non-member is unnecessary (it cannot serve) and
            # would invalidate the live node's leases on OTHER ranges
            if not self.liveness.increment_epoch(cur.holder):
                return False
        try:
            self.propose_and_wait(rep, {
                "kind": "lease", "holder": node_id,
                "epoch": self.liveness.epoch_of(node_id)}, max_iter)
        except RuntimeError:
            return False
        return rep.holds_lease()

    def leaseholder(self, range_id: int) -> Optional[int]:
        for nid, store in self.stores.items():
            if nid in self.down:
                continue
            rep = store.replicas.get(range_id)
            if rep is not None and rep.holds_lease():
                return nid
        return None

    def ensure_lease(self, range_id: int) -> Optional[int]:
        lh = self.leaseholder(range_id)
        if lh is not None:
            return lh
        desc = self.descriptors[range_id]
        # prefer the raft leader; it can acquire immediately
        for nid in desc.replicas:
            if nid in self.down:
                continue
            rep = self.stores[nid].replicas.get(range_id)
            if rep and rep.raft.is_leader() and \
                    self.acquire_lease(range_id, nid):
                return nid
        for nid in desc.replicas:
            if nid not in self.down and self.acquire_lease(range_id, nid):
                return nid
        return None

    # ------------------------------------------------------------------
    # circuit breakers + loss-of-quorum recovery
    # ------------------------------------------------------------------
    def breaker(self, range_id: int) -> Breaker:
        b = self.breakers.get(range_id)
        if b is None:
            b = Breaker(f"r{range_id}", threshold=1,
                        probe=lambda: self._probe_range(range_id))
            self.breakers[range_id] = b
        return b

    def _probe_range(self, range_id: int) -> bool:
        """Breaker probe: can the range commit a no-op quickly? Bounded
        pump budget — orders of magnitude cheaper than the data path's
        own retry loop (the reference's probe proposes a lease/noop,
        replica_circuit_breaker.go sendProbe)."""
        desc = self.descriptors.get(range_id)
        if desc is None:
            return True
        lh = self.leaseholder(range_id)
        if lh is None:
            for nid in desc.replicas:
                if nid not in self.down and \
                        self.acquire_lease(range_id, nid, max_iter=25):
                    lh = nid
                    break
        if lh is None:
            return False
        rep = self.stores[lh].replicas[range_id]
        out = {}
        if not rep.propose({"kind": "batch", "ops": []},
                           lambda r: out.setdefault("ok", True)):
            return False
        return self.pump_until(lambda: "ok" in out, 25)

    def loq_recover(self, range_id: Optional[int] = None) -> list[str]:
        """Loss-of-quorum recovery (pkg/kv/kvserver/loqrecovery): for
        each range whose live replicas cannot form a quorum, rewrite
        the replica set down to the most-advanced live survivor, which
        then serves alone (and the replicate queue re-replicates).
        Accepts losing writes the survivor never saw — run only when
        the dead nodes are really gone, like the reference's
        ``debug recover`` plan/apply flow."""
        actions = []
        targets = ([self.descriptors[range_id]] if range_id is not None
                   else list(self.descriptors.values()))
        for desc in targets:
            live = [n for n in desc.replicas if n not in self.down]
            if len(live) > len(desc.replicas) // 2:
                continue  # quorum intact; nothing to recover
            if not live:
                actions.append(
                    f"r{desc.range_id}: unrecoverable (no live replica)")
                continue
            best = max(live, key=lambda n: (
                self.stores[n].replicas[desc.range_id].applied_index,
                self.stores[n].replicas[desc.range_id].raft.term))
            dead = sorted(n for n in desc.replicas if n not in live)
            rep = self.stores[best].replicas[desc.range_id]
            # replicaGC the other live minority members NOW: a stale
            # survivor (e.g. the old leaseholder) must not keep
            # serving the range beside the recovered one (split brain)
            for n in live:
                if n != best:
                    self.stores[n].remove_replica(desc.range_id)
            desc.replicas = [best]
            desc.generation += 1
            rep.desc.replicas = [best]
            rep.raft.update_membership([best])
            # NOTE: the lease record is left untouched — it is part of
            # the replicated state machine, and acquire_lease already
            # treats a holder outside desc.replicas as fenced; mutating
            # it here would diverge the survivor from later learners
            # replaying the log
            self.breakers.pop(desc.range_id, None)
            actions.append(
                f"r{desc.range_id}: reset to survivor n{best} "
                f"(lost {dead})")
        return actions

    # ------------------------------------------------------------------
    # KV client API (simple router; DistSender supersedes this)
    # ------------------------------------------------------------------
    def _leaseholder_replica(self, key: bytes) -> Replica:
        desc = self.range_for_key(key)
        if desc is None:
            raise KeyError(f"no range for key {key!r}")
        b = self.breaker(desc.range_id)
        b.check()
        # counted only for requests the breaker admitted: rejected
        # traffic must not inflate a dead range's load signal
        self.range_load[desc.range_id] = \
            self.range_load.get(desc.range_id, 0) + 1
        lh = self.ensure_lease(desc.range_id)
        if lh is None:
            b.report_failure()
            raise RuntimeError(f"r{desc.range_id}: no leaseholder "
                               "(quorum lost?)")
        return self.stores[lh].replicas[desc.range_id]

    def _gc_replica_txn_records(self, rep, now: int, ttl_ns: int,
                                seen: set, propose) -> int:
        """Shared per-replica sweep of aged ABORTED txn records (the
        txn-record GC half of the reference's gc queue, gc/gc.go).
        SAFETY: ttl_ns must exceed any live txn's possible lifetime
        (TxnLivenessThreshold) — deleting a LIVE pushee's poison
        record would let its commit succeed over removed intents.
        Used by both the in-process cluster and NetCluster's
        local-leaseholder slice (kvserver/netcluster.py)."""
        import json as _json

        from ..storage.hlc import MAX_TIMESTAMP
        n = 0
        keys = set()
        for ek, raw in list(rep.mvcc.engine.scan(
                EngineKey(b"\x00txn/", -1), include_tombstones=True)):
            if not ek.key.startswith(b"\x00txn/"):
                break  # ordered scan left the txn keyspace
            keys.add(ek.key)
        for key in keys - seen:
            seen.add(key)
            mv = rep.mvcc.get(key, MAX_TIMESTAMP, inconsistent=True)
            if mv is None:
                continue
            try:
                rec = _json.loads(mv.value.decode())
            except ValueError:
                continue
            if rec.get("status") != "aborted":
                continue  # committed records are deleted by
                # resolve_all once every intent resolves
            if now - mv.ts.wall < ttl_ns:
                continue
            propose(rep, {"kind": "batch", "ops": [{
                "op": "delete", "key": key.decode("latin1"),
                "ts": _enc_ts(self.clock.now())}]})
            n += 1
        return n

    def gc_txn_records(self, ttl_ns: int = int(3600e9)) -> int:
        """Sweep aged ABORTED txn records on every range's
        leaseholder (a pusher racing a fully-resolved commit can
        leave a bogus ABORTED record, disttxn push_intent; this
        bounds the leak)."""
        n = 0
        now = self.clock.now().wall
        seen: set[bytes] = set()
        for desc in list(self.descriptors.values()):
            lh = self.ensure_lease(desc.range_id)
            if lh is None:
                continue
            rep = self.stores[lh].replicas.get(desc.range_id)
            if rep is None:
                continue
            n += self._gc_replica_txn_records(
                rep, now, ttl_ns, seen, self.propose_and_wait)
        return n

    def put(self, key: bytes, value: bytes, max_iter: int = 500) -> None:
        rep = self._leaseholder_replica(key)
        b = self.breaker(rep.desc.range_id)
        cmd = {"kind": "batch", "ops": [{
            "op": "put", "key": key.decode("latin1"),
            "value": value.decode("latin1"),
            "ts": _enc_ts(self.clock.now()),
        }]}
        try:
            res = self.propose_and_wait(rep, cmd, max_iter)[0]
        except (RuntimeError, AmbiguousResultError):
            b.report_failure()
            raise
        b.report_success()
        # apply-time MVCC conflict (store.py batch eval): surface it
        # (typed) rather than silently dropping the write
        raise_op_error(res)

    def get(self, key: bytes) -> Optional[bytes]:
        rep = self._leaseholder_replica(key)
        return rep.read({"op": "get", "key": key.decode("latin1"),
                         "ts": _enc_ts(self.clock.now())})

    def scan(self, start: bytes, end: bytes, limit: int = 0):
        """Range-by-range scan across split boundaries (the simple
        client; DistSender adds caching and parallelism)."""
        out: list = []
        ts = _enc_ts(self.clock.now())
        cur = start
        while cur < end:
            desc = self.range_for_key(cur)
            if desc is None:
                break
            rep = self._leaseholder_replica(cur)
            piece_end = min(end, rep.desc.end_key)
            remaining = limit - len(out) if limit else 0
            if limit and remaining <= 0:
                break
            out.extend(rep.read({
                "op": "scan", "start": cur.decode("latin1"),
                "end": piece_end.decode("latin1"), "ts": ts,
                "limit": remaining}))
            cur = rep.desc.end_key
        return out
