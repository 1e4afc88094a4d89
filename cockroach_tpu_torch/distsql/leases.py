"""Shard leases for the elastic compute plane
(cockroach_tpu/distsql/leases.py).

The reference's core identity is range leases that MOVE: a store joins,
the allocator rebalances replicas toward it, and leaseholders hand off
without stopping traffic. A static pod pins each host's shard as a
contiguous slice at start-up, so it can neither grow nor survive a
host. This module is the compute-plane lease table that unpins it:

- **Lease records in the pod KV** (``ls/assign/<table>/<epoch>``): the
  full shard->owner assignment, written for epoch e+1 and published by
  the SAME epoch CAS the membership plane uses: a lease flip IS an
  epoch boundary, so every host resolves one owner per shard per epoch
  and a stale-epoch claim loses the CAS instead of double-owning.
- **Epoch-guarded reads**: ``ShardLeases.view_at(epoch)`` and
  ``current_view()`` return an immutable ``LeaseView``, the only
  sanctioned way to read ownership outside this module.
- **Two-phase handoff**: a rebalance writes a PENDING target
  (``ls/pending/<table>``); gaining hosts stream their new shards'
  rows page by page from the current owner (each page admitted through
  the movement scheduler's ``rebalance`` lease) while the old owner
  keeps serving, mark ready, and only then does the initiator flip the
  assignment at the next epoch. Old owners retire their moved rows at
  the first idle moment after the flip.
- **ShardKeeper**: the host-side shard store. The engine's sharded
  table is always REBUILT as "exactly my leased shards at the current
  epoch", so a host never serves rows it no longer owns (and flows
  stamped with an older epoch are refused: the gateway replans). Each
  rebuild is a DROP and CREATE, so the table takes a new generation and
  the engine's device copy, exec cache and kernel plans follow it.

Shard *data* durability rides the ``recover`` hook (deterministic
regeneration in the harness): failover correctness here is about
leases, epochs and replanning, not about Raft under the bench tables.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from cockroach_tpu_torch.parallel import multihost

# page size for shard-lease rebalance streams: the spill tier's fixed-
# shape page discipline (bounded working set per transfer, admission
# per page) applied to host→host shard movement
REBALANCE_PAGE_ROWS = 4096

# how long a gaining host waits on one shard-fetch stream before
# falling back to the recover hook (the owner may have died mid-move)
FETCH_TIMEOUT_S = 30.0


class LeaseError(Exception):
    pass


@dataclass(frozen=True)
class LeaseView:
    """Immutable shard-ownership snapshot at one membership epoch: the
    epoch-guarded accessor every planner and server read comes
    through."""

    epoch: int
    assignments: dict = field(default_factory=dict)  # table -> {sid: owner}

    def assignment(self, table: str) -> dict:
        return dict(self.assignments.get(table, {}))

    def owner(self, table: str, sid: int) -> Optional[int]:
        return self.assignments.get(table, {}).get(int(sid))

    def shards_of(self, table: str, host: int) -> list:
        return sorted(s for s, o in
                      self.assignments.get(table, {}).items()
                      if o == host)

    def owners(self, table: str) -> set:
        return set(self.assignments.get(table, {}).values())

    def validate(self) -> None:
        """Single-ownership invariant: every shard has exactly one
        owner by construction (dict), and no owner appears for a
        shard id outside the table's registered range. Kept as an
        explicit hook so churn tests assert it after every fault."""
        for table, asg in self.assignments.items():
            if len(asg) != len(set(asg.keys())):
                raise LeaseError(f"{table}: duplicate shard ids")


def plan_rebalance(current: dict, live: list) -> dict:
    """Deterministic minimal-move target assignment: keep every shard
    whose owner survives and is under quota, shed overloads, place
    orphans (dead/over-quota shards) on the least-loaded hosts. The
    allocator's rebalance loop, compressed to the pod scale."""
    live = sorted(set(live))
    if not live:
        raise LeaseError("no live hosts to assign shards to")
    nsh = len(current)
    base, extra = divmod(nsh, len(live))
    quota = {h: base + (1 if i < extra else 0)
             for i, h in enumerate(live)}
    loads: dict = {h: [] for h in live}
    orphans = []
    for sid in sorted(current):
        o = current[sid]
        if o in live and len(loads[o]) < quota[o]:
            loads[o].append(sid)
        else:
            orphans.append(sid)
    for sid in sorted(orphans):
        h = min(live, key=lambda x: (len(loads[x]) - quota[x], x))
        loads[h].append(sid)
    return {sid: h for h in live for sid in loads[h]}


class ShardLeases:
    """The lease table over the pod KV. All reads go through
    ``current_view``/``view_at``; transitions write the next epoch's
    assignment and CAS the shared pod epoch (multihost ``mb/epoch``)
    so lease flips and membership changes serialize on one clock."""

    def __init__(self, membership, metrics=None):
        self.membership = membership
        # raw epoch->assignment cache. Never read this directly
        # outside this module: view_at() is the epoch-guarded door.
        self._assignments: dict = {}
        self._mu = threading.Lock()
        self._metrics = metrics
        if metrics is not None:
            self.m_moves = metrics.counter(
                "exec.lease.moves",
                "shard leases transferred between hosts (rebalance "
                "flips, join/drain/failover)")
            self.m_failovers = metrics.counter(
                "exec.lease.failovers",
                "shard leases reassigned off a dead host by the "
                "statement-failover path")
            self.m_shards = metrics.gauge(
                "exec.lease.shards",
                "shards this host serves under the current epoch")

    # -- epoch-guarded reads ---------------------------------------
    def _load_assignment(self, table: str, epoch: int) -> Optional[dict]:
        with self._mu:
            hit = self._assignments.get((table, epoch))
        if hit is not None:
            return hit
        raw = multihost.kv_try_get(f"ls/assign/{table}/{epoch}")
        if raw is None:
            return None
        asg = {int(s): int(o) for s, o in json.loads(raw).items()}
        with self._mu:
            self._assignments[(table, epoch)] = asg
        return asg

    def tables(self) -> list:
        return sorted(multihost.kv_list("ls/tables/").keys())

    def register_table(self, table: str, nshards: int) -> None:
        multihost.kv_set(f"ls/tables/{table}",
                         json.dumps({"nshards": int(nshards)}))

    def nshards(self, table: str) -> int:
        raw = multihost.kv_try_get(f"ls/tables/{table}")
        if raw is None:
            raise LeaseError(f"table {table!r} has no lease records")
        return int(json.loads(raw)["nshards"])

    def view_at(self, epoch: int) -> LeaseView:
        """The shard-ownership view as of membership epoch ``epoch``:
        per table, the newest assignment published at or below it.
        This — not the raw records — is the sanctioned read path."""
        out = {}
        for table in self.tables():
            probe = int(epoch)
            while probe > 0:
                asg = self._load_assignment(table, probe)
                if asg is not None:
                    out[table] = asg
                    break
                probe -= 1
        return LeaseView(epoch=int(epoch), assignments=out)

    def current_view(self) -> LeaseView:
        return self.view_at(self.membership.epoch())

    # -- transitions -----------------------------------------------
    def transition(self, table: str, target: dict,
                   claim_epoch: Optional[int] = None) -> Optional[int]:
        """Atomically flip ``table``'s assignment to ``target`` at the
        next epoch boundary. The new assignment is create-only-CASed
        under epoch e+1 and then the pod epoch CASes e→e+1: a claim
        fenced to a stale epoch (claim_epoch < current, including the
        injected MembershipFaults.stale_epoch_claims) loses one of the
        two CASes and returns None — the shard is never double-owned.
        Returns the new epoch on success."""
        f = multihost.membership_faults()
        while True:
            e = self.membership.epoch()
            bid = e if claim_epoch is None else int(claim_epoch)
            if f is not None and f.stale_epoch_claims \
                    and f.applies(self.membership.host_id):
                bid = e - 1
            if bid != self.membership.epoch():
                return None     # fenced: the epoch moved past the bid
            wire = json.dumps({str(s): int(o)
                               for s, o in sorted(target.items())})
            if not multihost.kv_cas(f"ls/assign/{table}/{bid + 1}",
                                    None, wire):
                if claim_epoch is not None or bid != e:
                    return None   # someone legitimate owns that slot
                # our own retry raced a membership bump: rebid
                time.sleep(0.001)
                continue
            if multihost.kv_cas("mb/epoch", str(bid) if bid else None,
                                str(bid + 1)):
                if self._metrics is not None:
                    self.m_moves.inc(
                        self._count_moves(table, bid, target))
                return bid + 1
            if claim_epoch is not None or bid != e:
                return None
            time.sleep(0.001)

    def _count_moves(self, table: str, prev_epoch: int,
                     target: dict) -> int:
        prev = self.view_at(prev_epoch).assignment(table)
        return sum(1 for s, o in target.items() if prev.get(s) != o)


# ---------------------------------------------------------------------------
# host-side shard store + engine reconciliation
# ---------------------------------------------------------------------------

class ShardKeeper:
    """Host arrays for the shards this host HOLDS, and the discipline
    that keeps the engine's sharded table equal to exactly the shards
    this host is LEASED at the current epoch. Holding and serving are
    deliberately different states: a gaining host holds its streamed
    shard before the flip (old owner still serving), and a losing
    host keeps serving until its first idle reconcile after it."""

    def __init__(self, engine):
        self.engine = engine
        self._ddl: dict = {}
        # table -> {column: values}: string columns whose shards hold
        # dictionary codes (the generators' encoded form); each rebuild
        # installs these dictionaries before the codes go in
        self._dicts: dict = {}
        self._held: dict = {}       # (table, sid) -> {col: np.ndarray}
        self._installed: dict = {}  # table -> frozenset(sids)
        self._serve_floor: dict = {}  # table -> min servable epoch

    def register_table(self, table: str, ddl: str,
                       dictionaries: Optional[dict] = None) -> None:
        self._ddl[table] = ddl
        if dictionaries:
            self._dicts[table] = dict(dictionaries)
        self._installed.setdefault(table, frozenset())
        self._serve_floor.setdefault(table, 0)

    def tables(self) -> list:
        return sorted(self._ddl)

    def holds(self, table: str, sid: int) -> bool:
        return (table, int(sid)) in self._held

    def held(self, table: str) -> list:
        return sorted(s for t, s in self._held if t == table)

    def shard_rows(self, table: str, sid: int) -> dict:
        return self._held[(table, int(sid))]

    def put_shard(self, table: str, sid: int, cols: dict) -> None:
        self._held[(table, int(sid))] = cols

    def drop_shard(self, table: str, sid: int) -> None:
        self._held.pop((table, int(sid)), None)

    def installed(self, table: str) -> frozenset:
        return self._installed.get(table, frozenset())

    def can_serve_epoch(self, table: str, epoch: int) -> bool:
        """A flow stamped with an epoch older than this host's last
        engine rebuild must be refused: the rows that epoch expects
        here may have moved (serving them would double-count; serving
        without them would drop)."""
        return int(epoch) >= self._serve_floor.get(table, 0)

    def rebuild(self, table: str, want, epoch: int) -> None:
        """Reinstall the engine's sharded table as exactly ``want``
        (drop + create + insert, shard order). Rows go in at the
        MVCC floor (Timestamp(1,0)): shard movement is a placement
        change, not a data change, so a retried statement reading at
        its original read_ts still sees every row — the same reason a
        rebalanced replica carries its history with it."""
        from cockroach_tpu_torch.storage.hlc import Timestamp
        eng = self.engine
        want = frozenset(int(s) for s in want)
        eng.execute(f"DROP TABLE {table}")
        eng.execute(self._ddl[table])
        for col, values in self._dicts.get(table, {}).items():
            eng.store.set_dictionary(table, col, values)
        pieces = [self._held[(table, s)] for s in sorted(want)
                  if (table, s) in self._held]
        if pieces:
            cols = {c: np.concatenate([p[c] for p in pieces])
                    for c in pieces[0]}
            eng.store.insert_columns(table, cols, Timestamp(1, 0))
        self._installed[table] = want
        self._serve_floor[table] = int(epoch)


# ---------------------------------------------------------------------------
# shard streaming: spill-page chunks over the flow transport
# ---------------------------------------------------------------------------

def _xfer_inbox(node, xid: str):
    return node.registry.inbox(f"xfer:{xid}", 0)


def serve_shard_fetch(node, frm: int, payload) -> None:
    """Owner side of one shard-lease rebalance stream: page the held
    shard out in fixed-size spill-tier pages, each page admitted
    through the movement scheduler's ``rebalance`` lease, while the
    engine keeps serving the shard (host arrays only — no device
    work, no flow interruption)."""
    from cockroach_tpu_torch.distsql import serde
    from cockroach_tpu_torch.exec.movement import KIND_REBALANCE
    from cockroach_tpu_torch.exec.spill import host_page_iter
    _kind, xid, table, sid, page_rows, requester = payload
    pod = node.elastic
    try:
        if pod is None or not pod.keeper.holds(table, sid):
            raise LeaseError(
                f"node {node.node_id} does not hold {table}/{sid}")
        cols = pod.keeper.shard_rows(table, sid)
        # wire normalization: object/unicode string columns travel as
        # fixed-width bytes (the serde frame is raw buffers); the
        # fetch side decodes them back to str before installing
        cols = {k: (v.astype("S") if v.dtype.kind in "OU" else v)
                for k, v in cols.items()}
        n = len(next(iter(cols.values()))) if cols else 0
        mv = getattr(node.engine, "movement", None)
        for pn, pcols in host_page_iter(n, cols, int(page_rows)):
            valid = {c: np.ones(pn, dtype=bool) for c in pcols}
            chunk = serde.encode_columns(pn, pcols, valid)
            if mv is not None:
                with mv.lease(KIND_REBALANCE, len(chunk)):
                    node.transport.send(
                        node.node_id, requester,
                        ("shard_page", xid, chunk, False, None))
            else:
                node.transport.send(
                    node.node_id, requester,
                    ("shard_page", xid, chunk, False, None))
        node.transport.send(node.node_id, requester,
                            ("shard_page", xid, None, True, None))
    except Exception as e:      # noqa: BLE001 — ships to the requester
        node.transport.send(
            node.node_id, requester,
            ("shard_page", xid, None, True,
             f"{type(e).__name__}: {e}"))


def fetch_shard(node, owner: int, table: str, sid: int,
                page_rows: int = REBALANCE_PAGE_ROWS,
                timeout_s: float = FETCH_TIMEOUT_S) -> dict:
    """Gaining-host side: pull one shard's pages from its current
    owner over the flow transport. Raises LeaseError on owner error
    or silence (the caller falls back to the recover hook)."""
    xid = uuid.uuid4().hex[:12]
    ib = _xfer_inbox(node, xid)
    node.transport.send(node.node_id, owner,
                        ("shard_fetch", xid, table, int(sid),
                         int(page_rows), node.node_id))
    is_async = getattr(node.transport, "is_async", False)
    deadline = time.monotonic() + timeout_s
    try:
        while not ib.eof:
            if node.transport.deliver_all() == 0 \
                    and node.transport.pending() == 0:
                if not is_async:
                    raise LeaseError(
                        f"shard fetch {table}/{sid} from {owner} "
                        "stalled on an idle synchronous transport")
                if time.monotonic() > deadline:
                    raise LeaseError(
                        f"shard fetch {table}/{sid} from {owner} "
                        f"timed out ({timeout_s}s)")
                time.sleep(0.001)
        if ib.error:
            raise LeaseError(ib.error)
        chunks = ib.drain_arrays()
    finally:
        node.registry.release(f"xfer:{xid}")
    live = [(n, c) for n, c, _v in chunks if n > 0]
    if not live:
        if not chunks:
            raise LeaseError(f"shard fetch {table}/{sid}: empty stream")
        _n, c0, _v0 = chunks[0]
        out = {k: v[:0] for k, v in c0.items()}
    else:
        out = {c: np.concatenate([ch[1][c] for ch in live])
               for c in live[0][1]}
    # undo the wire normalization: bytes columns back to str so the
    # keeper holds the same representation the recover hook produces
    return {k: (v.astype(str) if v.dtype.kind == "S" else v)
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# the elastic pod: membership + leases + keeper + recovery, tied
# ---------------------------------------------------------------------------

# in-process sibling pods (degenerate LocalTransport pod): the
# failover and rebalance code can advance them directly instead of
# waiting on per-process serve loops. Cross-process pods register only
# themselves. Guarded by _PODS_LOCK; torn down with the multihost
# runtime.
_PODS_LOCK = threading.Lock()
_LOCAL_PODS: dict = {}


def local_pods() -> dict:
    with _PODS_LOCK:
        return dict(_LOCAL_PODS)


def _clear_local_pods() -> None:
    with _PODS_LOCK:
        _LOCAL_PODS.clear()


class ElasticPod:
    """One host's handle on the elastic compute plane. Owns the
    join/drain/failover choreography:

    - ``bootstrap``: founding assignment for the initial member set
    - ``join_pod``: membership join, then two-phase shard acquisition
      (stream from live owners) and the epoch flip
    - ``drain_pod``: orderly exit — shards stream OFF this host, flip,
      then leave
    - ``fail_over``: gateway-driven conviction of silent hosts, lease
      reassignment to survivors with recover-hook installs
    - ``reconcile``: the idle-time pump — serve pending fetches, mark
      ready, apply the current epoch's assignment to the engine
    """

    def __init__(self, host_id: int, membership, leases: ShardLeases,
                 keeper: ShardKeeper, node=None,
                 recover: Optional[Callable] = None):
        self.host_id = int(host_id)
        self.membership = membership
        self.leases = leases
        self.keeper = keeper
        self.node = node
        self.recover = recover
        if node is not None:
            node.elastic = self
        with _PODS_LOCK:
            _LOCAL_PODS[self.host_id] = self
        multihost.register_teardown(_clear_local_pods)

    # -- views ------------------------------------------------------
    def view(self) -> LeaseView:
        return self.leases.current_view()

    def data_nodes(self) -> list:
        """Node ids statements may be planned on: the live member set
        of the current epoch (drainers included — they serve until
        their leases have moved)."""
        return sorted(self.membership.view().live)

    def serving_shards(self, table: str) -> frozenset:
        return self.keeper.installed(table)

    def can_serve_epoch(self, epoch: int) -> bool:
        """True iff this host's ENGINE currently serves exactly the
        shards a flow planned at ``epoch`` expects here. Set equality
        — not an epoch floor — is the invariant: a host that rebuilt
        past the flow's epoch is still safe when its shard set did
        not change, and an unrebuilt host is unsafe the moment its
        assignment moved (serving would double-count the moved
        shards on their new owner)."""
        v = self.leases.view_at(int(epoch))
        return all(
            frozenset(v.shards_of(t, self.host_id))
            == self.keeper.installed(t)
            for t in self.keeper.tables())

    def maybe_reconcile(self) -> None:
        """Lazy catch-up for the flow-setup fence: a host that missed
        a lease flip (its serve loop has not run since) re-installs
        before refusing the flow. Never runs under an active
        statement; failures surface as a refusal, not a crash."""
        if self.node is not None and self.node._producing:
            return
        try:
            self.reconcile()
        except Exception:       # noqa: BLE001 — fence will refuse
            pass

    # -- founding ---------------------------------------------------
    def bootstrap(self, table: str, ddl: str, nshards: int,
                  owners: list) -> int:
        """Found the lease table: register, assign shards over the
        founding members, install this host's slice via the recover
        hook. Every founding host calls this; only the first transition
        wins the epoch slot, the rest adopt it."""
        self.keeper.register_table(table, ddl)
        self.leases.register_table(table, nshards)
        target = plan_rebalance(
            {s: -1 for s in range(nshards)}, owners)
        cur = self.view().assignment(table)
        if cur != target:
            self.leases.transition(table, target)
        self.reconcile()
        return self.membership.epoch()

    # -- data acquisition ------------------------------------------
    def _obtain(self, table: str, sid: int,
                owner: Optional[int]) -> dict:
        """One shard's rows: streamed from its live owner when there
        is one, regenerated through the recover hook when there isn't
        (the durable-storage stand-in — a dead host's shard data is
        recoverable by contract, the way a dead store's ranges are)."""
        if owner is not None and owner != self.host_id \
                and self.node is not None \
                and self.membership.alive(owner):
            try:
                return fetch_shard(self.node, owner, table, sid)
            except LeaseError:
                pass        # owner died mid-stream: recover below
        if self.recover is None:
            raise LeaseError(
                f"no live owner and no recover hook for {table}/{sid}")
        return self.recover(table, sid)

    # -- two-phase rebalance ---------------------------------------
    def start_rebalance(self, table: str, target: dict) -> str:
        pid = uuid.uuid4().hex[:8]
        multihost.kv_set(f"ls/pending/{table}", json.dumps({
            "id": pid, "by": self.host_id,
            "target": {str(s): int(o) for s, o in target.items()}}))
        return pid

    def _pending(self, table: str) -> Optional[dict]:
        raw = multihost.kv_try_get(f"ls/pending/{table}")
        if not raw:
            return None
        return json.loads(raw)

    def _try_complete(self, table: str, pend: dict) -> bool:
        target = {int(s): int(o) for s, o in pend["target"].items()}
        gainers = sorted(set(target.values()))
        ready = multihost.kv_list(f"ls/ready/{table}/{pend['id']}/")
        if not all(str(h) in ready or f"{h}" in ready
                   for h in gainers):
            return False
        if self.leases.transition(table, target) is None:
            # fenced (stale epoch / racing transition): drop the
            # pending record rather than wedging the pod on it
            pass
        multihost.kv_set(f"ls/pending/{table}", "")
        return True

    def reconcile(self) -> None:
        """The idle-time pump, called between statements (and by
        worker serve loops): acquire pending shards, ready-mark,
        complete our own rebalances, and re-install the engine table
        when the current epoch's assignment differs from what it
        serves. Never runs under an active flow on this node — a
        mid-statement rebuild would change a scan under the plan."""
        if self.membership.expelled():
            # a convicted (or fenced-incarnation) host must not
            # ready-mark or adopt shards: its lease claims are stale
            # by definition. Rejoining with a new incarnation clears
            # this.
            return
        for table in self.keeper.tables():
            pend = self._pending(table)
            if pend is not None:
                target = {int(s): int(o)
                          for s, o in pend["target"].items()}
                mine = [s for s, o in target.items()
                        if o == self.host_id]
                missing = [s for s in mine
                           if not self.keeper.holds(table, s)]
                if missing:
                    cur = self.view().assignment(table)
                    for sid in missing:
                        self.keeper.put_shard(
                            table, sid,
                            self._obtain(table, sid, cur.get(sid)))
                multihost.kv_set(
                    f"ls/ready/{table}/{pend['id']}/{self.host_id}",
                    "1")
                if pend.get("by") == self.host_id:
                    self._try_complete(table, pend)
            self._apply_assignment(table)

    def _apply_assignment(self, table: str) -> None:
        v = self.view()
        want = frozenset(v.shards_of(table, self.host_id))
        if want == self.keeper.installed(table):
            self._note_shards(len(want))
            return
        if self.node is not None and self.node._producing:
            return          # statement in flight: defer the rebuild
        missing = [s for s in want
                   if not self.keeper.holds(table, s)]
        for sid in missing:
            # safety net (post-failover adoptions): the flip already
            # happened, so the previous owner is gone — recover
            self.keeper.put_shard(table, sid,
                                  self._obtain(table, sid, None))
        for sid in self.keeper.held(table):
            if sid not in want:
                self.keeper.drop_shard(table, sid)
        self.keeper.rebuild(table, want, v.epoch)
        self._note_shards(len(want))

    def _note_shards(self, n: int) -> None:
        if self.leases._metrics is not None:
            self.leases.m_shards.set(n)

    def _drive(self, table: str, pid: str,
               timeout_s: float = 60.0) -> None:
        """Advance a rebalance to its flip: pump in-process sibling
        pods directly (degenerate pod), otherwise wait for remote
        serve loops to ready-mark. Raises on timeout — a wedged
        rebalance must fail loudly, not hang the statement ladder."""
        deadline = time.monotonic() + timeout_s
        while True:
            pend = self._pending(table)
            if pend is None or pend.get("id") != pid:
                return          # flipped (or superseded)
            for p in local_pods().values():
                if p.membership.expelled():
                    continue
                if p.node is None or not p.node._producing:
                    p.reconcile()
            if self.node is not None:
                self.node.transport.deliver_all()
            if time.monotonic() > deadline:
                raise LeaseError(
                    f"rebalance {pid} on {table!r} did not complete "
                    f"within {timeout_s}s")
            time.sleep(0.002)

    def _post_flip_round(self) -> None:
        """One reconcile sweep over the in-process sibling pods after
        a flip, so losing hosts retire their moved shards before the
        next statement (cross-process pods catch up lazily: their
        serve loop, or the flow-setup fence's maybe_reconcile)."""
        for p in local_pods().values():
            if p is self or p.membership.expelled():
                continue
            if p.node is None or not p.node._producing:
                try:
                    p.reconcile()
                except Exception:   # noqa: BLE001 — fence covers it
                    pass

    # -- lifecycle choreography ------------------------------------
    def join_pod(self, timeout_s: float = 60.0) -> int:
        """Online scale-out: become live (serving nothing), stream a
        balanced share of every table's shards from their owners while
        they keep serving, then flip at the next epoch boundary."""
        self.membership.join()
        live = self.data_nodes()
        for table in self.leases.tables():
            if table not in self.keeper._ddl:
                raise LeaseError(
                    f"join: {table!r} not registered with this "
                    "keeper (register_table first)")
            cur = self.view().assignment(table)
            target = plan_rebalance(cur, live)
            if target == cur:
                continue
            pid = self.start_rebalance(table, target)
            self._drive(table, pid, timeout_s)
        self.reconcile()
        self._post_flip_round()
        return self.membership.epoch()

    def drain_pod(self, timeout_s: float = 60.0) -> int:
        """Orderly exit: announce draining, stream every held shard
        to the survivors (this host keeps serving until the flip),
        then leave the member view."""
        self.membership.drain()
        survivors = [h for h in self.data_nodes()
                     if h != self.host_id]
        for table in self.leases.tables():
            cur = self.view().assignment(table)
            target = plan_rebalance(cur, survivors)
            if target != cur:
                pid = self.start_rebalance(table, target)
                self._drive(table, pid, timeout_s)
        self.reconcile()
        self._post_flip_round()
        return self.membership.leave()

    def fail_over(self, dead: list,
                  timeout_s: float = 60.0) -> tuple:
        """Statement-failover choreography (gateway side): convict the
        silent hosts (epoch bump fences their stale lease claims),
        reassign their shards to survivors — data via the recover
        hook, owners being gone — and flip. Returns (LeaseView after
        the flip, set of hosts whose shard set changed): the caller
        re-requests partials only from changed hosts."""
        for h in dead:
            self.membership.expel(h)
        live = self.data_nodes()
        changed: set = set(dead)
        for table in self.leases.tables():
            cur = self.view().assignment(table)
            target = plan_rebalance(cur, live)
            if target == cur:
                continue
            changed |= {o for s, o in target.items()
                        if cur.get(s) != o}
            pid = self.start_rebalance(table, target)
            self._drive(table, pid, timeout_s)
            if self.leases._metrics is not None:
                self.leases.m_failovers.inc(
                    sum(1 for s, o in target.items()
                        if cur.get(s) != o))
        self.reconcile()
        self._post_flip_round()
        return self.view(), changed
