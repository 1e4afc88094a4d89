"""A clean Raft consensus core, deterministic and message-passing
(cockroach_tpu/kvserver/raft.py).

Mirrors the role etcd-io/raft's ``RawNode`` plays in the reference
(``pkg/kv/kvserver/replica_raft.go:45-46``: one raft group per range,
stepped by a scheduler; ``handleRaftReadyRaftMuLocked`` drains a Ready
struct of entries-to-persist / messages-to-send / entries-to-apply).

This is a from-scratch implementation of the Raft algorithm (Ongaro &
Ousterhout) with the same drive model:

- ``tick()`` advances logical time (election/heartbeat timers).
- ``step(msg)`` feeds an incoming message.
- ``propose(data)`` appends a command on the leader.
- ``ready()`` drains the pending side effects: entries to append to the
  durable log, messages to send to peers, and newly committed entries
  to apply to the state machine.

No threads, no wall clock, no I/O: the embedder (``store.py``) owns
durability, transport and scheduling, which makes the core fully
deterministic under seeded tests (the reference gets the same property
from etcd raft's step API).
"""

from __future__ import annotations

import json
import random
import threading
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional

from cockroach_tpu_torch.utils import tracing

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

# A group-commit log entry: one raft append carrying a whole batch
# window's commands. The payload after the prefix is a JSON list of
# the individual command strings; the apply loop unpacks and acks
# each waiter separately (store.py Replica._apply).
GROUP_PREFIX = b"\x00grp\x00"


class _GroupCommitTally:
    """Process-wide group-commit counters feeding the
    kv.raft.groupcommit.* metric families. One proposal per bump, n
    commands riding in it; the single-node OLTP lane bumps the same
    tally at its fused kv commit (the WAL-append analogue there)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._proposals = 0
        self._commands = 0

    def bump(self, commands: int) -> None:
        with self._mu:
            self._proposals += 1
            self._commands += int(commands)

    def proposals(self) -> int:
        with self._mu:
            return self._proposals

    def commands(self) -> int:
        with self._mu:
            return self._commands


GROUPCOMMIT = _GroupCommitTally()


def pack_group(datas: list[bytes]) -> bytes:
    """Encode a batch window of command payloads into one log entry."""
    return GROUP_PREFIX + json.dumps(
        [d.decode("utf-8") for d in datas]).encode("utf-8")


def unpack_group(data: bytes) -> Optional[list[bytes]]:
    """The packed commands, or None if `data` is a plain entry."""
    if not data.startswith(GROUP_PREFIX):
        return None
    return [s.encode("utf-8")
            for s in json.loads(data[len(GROUP_PREFIX):])]


class MsgType(Enum):
    VOTE_REQ = "vote_req"
    VOTE_RESP = "vote_resp"
    APPEND = "append"          # also the heartbeat when entries == []
    APPEND_RESP = "append_resp"
    SNAPSHOT = "snapshot"


@dataclass
class Entry:
    term: int
    index: int
    data: bytes


@dataclass
class Snapshot:
    index: int
    term: int
    data: bytes


@dataclass
class Message:
    type: MsgType
    frm: int
    to: int
    term: int
    # VOTE_REQ / APPEND consistency check
    log_index: int = 0
    log_term: int = 0
    # APPEND payload
    entries: list[Entry] = field(default_factory=list)
    commit: int = 0
    # responses
    granted: bool = False
    success: bool = False
    match_index: int = 0
    # SNAPSHOT payload
    snapshot: Optional[Snapshot] = None


@dataclass
class HardState:
    """What must be durably persisted before messages are sent."""

    term: int = 0
    voted_for: Optional[int] = None
    commit: int = 0


@dataclass
class Ready:
    """Side effects drained from the core, in required handling order:
    persist hard_state+entries, then send messages, then apply
    committed_entries (same contract as replica_raft.go's ready loop)."""

    hard_state: Optional[HardState]
    entries: list[Entry]
    messages: list[Message]
    committed_entries: list[Entry]
    snapshot: Optional[Snapshot]
    leader: Optional[int]

    def any(self) -> bool:
        return bool(self.hard_state or self.entries or self.messages
                    or self.committed_entries or self.snapshot)


class RaftLog:
    """In-memory log with an optional compacted prefix.

    ``offset`` is the index of the first entry in ``entries``; entries
    at index <= snapshot_index have been compacted away.
    """

    def __init__(self):
        self.entries: list[Entry] = []
        self.offset = 1           # index of entries[0]
        self.snapshot_index = 0
        self.snapshot_term = 0

    # -- indexing ---------------------------------------------------
    def last_index(self) -> int:
        return self.offset + len(self.entries) - 1 if self.entries \
            else self.snapshot_index

    def term_at(self, index: int) -> Optional[int]:
        if index == self.snapshot_index:
            return self.snapshot_term
        if index < self.offset or index > self.last_index():
            return None
        return self.entries[index - self.offset].term

    def entry(self, index: int) -> Entry:
        return self.entries[index - self.offset]

    def slice_from(self, index: int) -> list[Entry]:
        if index < self.offset:
            return []
        return self.entries[index - self.offset:]

    # -- mutation ---------------------------------------------------
    def append(self, entries: list[Entry]) -> None:
        self.entries.extend(entries)

    def truncate_from(self, index: int) -> None:
        """Drop entries at >= index (conflict resolution)."""
        if index <= self.offset:
            self.entries = []
        else:
            self.entries = self.entries[: index - self.offset]

    def compact(self, index: int, term: int) -> None:
        """Discard entries <= index (they are covered by a snapshot)."""
        if index <= self.snapshot_index:
            return
        keep = self.slice_from(index + 1)
        self.entries = keep
        self.offset = index + 1
        self.snapshot_index = index
        self.snapshot_term = term

    def restore(self, snap: Snapshot) -> None:
        self.entries = []
        self.offset = snap.index + 1
        self.snapshot_index = snap.index
        self.snapshot_term = snap.term


class RaftNode:
    """One Raft participant for one consensus group (range)."""

    def __init__(self, node_id: int, peers: list[int], *,
                 election_timeout: int = 10, heartbeat_interval: int = 2,
                 rng: Optional[random.Random] = None):
        self.id = node_id
        self.peers = [p for p in peers if p != node_id]
        self.quorum = (len(peers) // 2) + 1
        self.state = FOLLOWER
        self.term = 0
        self.voted_for: Optional[int] = None
        self.leader_id: Optional[int] = None
        self.log = RaftLog()
        self.commit = 0
        self.applied = 0

        # leader volatile state
        self.next_index: dict[int, int] = {}
        self.match_index: dict[int, int] = {}
        self.votes: set[int] = set()

        self._rng = rng or random.Random(node_id)
        self._hb_interval = heartbeat_interval
        self._et_base = election_timeout
        self._elapsed = 0
        self._timeout = self._rand_timeout()

        # pending Ready state
        self._msgs: list[Message] = []
        self._unstable_from = 1   # first log index not yet handed out
        self._hs_dirty = False
        self._pending_snapshot: Optional[Snapshot] = None

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def tick(self) -> None:
        self._elapsed += 1
        if self.state == LEADER:
            if self._elapsed >= self._hb_interval:
                self._elapsed = 0
                self._broadcast_append(heartbeat_only=True)
        elif self._elapsed >= self._timeout:
            self._campaign()

    def propose(self, data: bytes) -> Optional[int]:
        """Append a command; returns its log index, or None if not leader."""
        if self.state != LEADER:
            return None
        idx = self.log.last_index() + 1
        self.log.append([Entry(self.term, idx, data)])
        self.match_index[self.id] = idx
        # no-op unless the proposing thread holds a recording (SET
        # tracing = cluster / EXPLAIN ANALYZE of a DML)
        tracing.event("raft-log-append", index=idx, term=self.term)
        pre = self.commit
        self._maybe_commit()
        if self.commit > pre:
            # single-replica groups commit on append
            tracing.event("raft-commit", index=self.commit,
                          term=self.term)
        self._broadcast_append()
        return idx

    def propose_group(self, datas: list[bytes]) -> Optional[int]:
        """Group commit: append one log entry carrying a whole batch
        window of commands (one WAL append / one replication round
        instead of len(datas) proposals). Returns the entry's index,
        or None if not leader. A single-command window degenerates to
        a plain propose — no packing overhead, no tally bump."""
        if not datas:
            return None
        if len(datas) == 1:
            return self.propose(datas[0])
        if self.state != LEADER:
            return None
        idx = self.propose(pack_group(datas))
        if idx is not None:
            GROUPCOMMIT.bump(len(datas))
        return idx

    def step(self, m: Message) -> None:
        if m.term > self.term:
            self._become_follower(m.term,
                                  m.frm if m.type == MsgType.APPEND else None)
        if m.type == MsgType.VOTE_REQ:
            self._handle_vote_req(m)
        elif m.type == MsgType.VOTE_RESP:
            self._handle_vote_resp(m)
        elif m.type == MsgType.APPEND:
            self._handle_append(m)
        elif m.type == MsgType.APPEND_RESP:
            self._handle_append_resp(m)
        elif m.type == MsgType.SNAPSHOT:
            self._handle_snapshot(m)

    def ready(self) -> Ready:
        hs = HardState(self.term, self.voted_for, self.commit) \
            if self._hs_dirty else None
        self._hs_dirty = False

        start = max(self._unstable_from, self.log.offset)
        entries = self.log.slice_from(start)
        self._unstable_from = self.log.last_index() + 1

        committed: list[Entry] = []
        while self.applied < self.commit:
            self.applied += 1
            e = self.log.term_at(self.applied)
            if e is None:        # covered by snapshot; skip
                continue
            committed.append(self.log.entry(self.applied))

        msgs, self._msgs = self._msgs, []
        snap, self._pending_snapshot = self._pending_snapshot, None
        return Ready(hs, list(entries), msgs, committed, snap,
                     self.leader_id)

    def compact(self, index: int, snapshot_data: bytes) -> None:
        """Embedder-triggered log truncation after a state-machine
        snapshot at ``index`` (mirrors raft_log_queue truncation)."""
        term = self.log.term_at(index)
        if term is None:
            return
        self.log.compact(index, term)
        self._snapshot_data = snapshot_data

    def is_leader(self) -> bool:
        return self.state == LEADER

    def update_membership(self, peers: list[int]) -> None:
        """Apply a membership change (the reference uses joint consensus
        via etcd ConfChange; we apply the simple single-step form — the
        embedder must change one replica at a time)."""
        self.peers = [p for p in peers if p != self.id]
        self.quorum = (len(peers) // 2) + 1
        if self.state == LEADER:
            last = self.log.last_index()
            for p in self.peers:
                self.next_index.setdefault(p, last + 1)
                self.match_index.setdefault(p, 0)
            for gone in [p for p in self.next_index if p not in self.peers]:
                self.next_index.pop(gone, None)
                self.match_index.pop(gone, None)
            self._maybe_commit()

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _rand_timeout(self) -> int:
        return self._et_base + self._rng.randrange(self._et_base)

    def _become_follower(self, term: int, leader: Optional[int]) -> None:
        if term > self.term:
            self.term = term
            self.voted_for = None
            self._hs_dirty = True
        self.state = FOLLOWER
        self.leader_id = leader
        self._elapsed = 0
        self._timeout = self._rand_timeout()

    def _campaign(self) -> None:
        self.state = CANDIDATE
        self.term += 1
        self.voted_for = self.id
        self.leader_id = None
        self.votes = {self.id}
        self._hs_dirty = True
        self._elapsed = 0
        self._timeout = self._rand_timeout()
        if self.quorum == 1:
            self._become_leader()
            return
        li = self.log.last_index()
        lt = self.log.term_at(li) or 0
        for p in self.peers:
            self._msgs.append(Message(MsgType.VOTE_REQ, self.id, p,
                                      self.term, log_index=li, log_term=lt))

    def _become_leader(self) -> None:
        self.state = LEADER
        self.leader_id = self.id
        self._elapsed = 0
        last = self.log.last_index()
        self.next_index = {p: last + 1 for p in self.peers}
        self.match_index = {p: 0 for p in self.peers}
        self.match_index[self.id] = last
        # Commit rule (§5.4.2): only entries from the current term may
        # advance commit; append a no-op to commit the prefix promptly.
        idx = last + 1
        self.log.append([Entry(self.term, idx, b"")])
        self.match_index[self.id] = idx
        self._broadcast_append()

    def _handle_vote_req(self, m: Message) -> None:
        granted = False
        if m.term >= self.term and self.voted_for in (None, m.frm):
            li = self.log.last_index()
            lt = self.log.term_at(li) or 0
            up_to_date = (m.log_term, m.log_index) >= (lt, li)
            if up_to_date:
                granted = True
                self.voted_for = m.frm
                self._hs_dirty = True
                self._elapsed = 0
        self._msgs.append(Message(MsgType.VOTE_RESP, self.id, m.frm,
                                  self.term, granted=granted))

    def _handle_vote_resp(self, m: Message) -> None:
        if self.state != CANDIDATE or m.term != self.term:
            return
        if m.granted:
            self.votes.add(m.frm)
            if len(self.votes) >= self.quorum:
                self._become_leader()

    def _handle_append(self, m: Message) -> None:
        if m.term < self.term:
            self._msgs.append(Message(MsgType.APPEND_RESP, self.id, m.frm,
                                      self.term, success=False))
            return
        self._become_follower(m.term, m.frm)
        prev_term = self.log.term_at(m.log_index)
        if m.log_index > 0 and prev_term is None and \
                m.log_index != self.log.snapshot_index:
            # gap: follower is behind the leader's prev index
            self._msgs.append(Message(
                MsgType.APPEND_RESP, self.id, m.frm, self.term,
                success=False, match_index=self.log.last_index()))
            return
        if m.log_index > 0 and prev_term is not None and \
                prev_term != m.log_term:
            # conflict at prev: truncate and ask for earlier entries
            self.log.truncate_from(m.log_index)
            self._unstable_from = min(self._unstable_from, m.log_index)
            self._msgs.append(Message(
                MsgType.APPEND_RESP, self.id, m.frm, self.term,
                success=False, match_index=m.log_index - 1))
            return
        for e in m.entries:
            have = self.log.term_at(e.index)
            if have is None:
                self.log.append([e])
            elif have != e.term:
                self.log.truncate_from(e.index)
                self._unstable_from = min(self._unstable_from, e.index)
                self.log.append([e])
        match = m.log_index + len(m.entries)
        if m.commit > self.commit:
            # Clamp to the verified prefix (prev + appended entries), not
            # our own last_index: on a heartbeat, entries past m.log_index
            # are not proven to match the leader's log, and committing
            # them could apply a divergent old-term suffix if messages
            # are reordered/duplicated (etcd raft sends
            # commit=min(commit, match) for the same reason).
            self.commit = max(self.commit, min(m.commit, match))
            self._hs_dirty = True
        self._msgs.append(Message(MsgType.APPEND_RESP, self.id, m.frm,
                                  self.term, success=True,
                                  match_index=match))

    def _handle_append_resp(self, m: Message) -> None:
        if self.state != LEADER or m.term != self.term:
            return
        if m.success:
            if m.match_index <= self.match_index.get(m.frm, 0):
                return
            self.match_index[m.frm] = m.match_index
            self.next_index[m.frm] = max(self.next_index.get(m.frm, 1),
                                         m.match_index + 1)
            self._maybe_commit()
            if self.next_index[m.frm] <= self.log.last_index():
                self._send_append(m.frm)
        else:
            # back off; use the follower's hint when provided
            hint = m.match_index
            self.next_index[m.frm] = max(1, min(
                self.next_index.get(m.frm, 1) - 1, hint + 1))
            self._send_append(m.frm)

    def _handle_snapshot(self, m: Message) -> None:
        snap = m.snapshot
        assert snap is not None
        if m.term < self.term or snap.index <= self.commit:
            self._msgs.append(Message(MsgType.APPEND_RESP, self.id, m.frm,
                                      self.term, success=True,
                                      match_index=self.log.last_index()))
            return
        self._become_follower(m.term, m.frm)
        self.log.restore(snap)
        # this log now starts at the snapshot: keep its state, so that
        # as a leader this node can send it to a follower that needs the
        # compacted prefix (an empty snapshot would leave that follower
        # without every key written before it)
        self._snapshot_data = snap.data
        self.commit = snap.index
        self.applied = snap.index
        self._unstable_from = snap.index + 1
        self._hs_dirty = True
        self._pending_snapshot = snap
        self._msgs.append(Message(MsgType.APPEND_RESP, self.id, m.frm,
                                  self.term, success=True,
                                  match_index=snap.index))

    def _maybe_commit(self) -> None:
        for idx in range(self.log.last_index(), self.commit, -1):
            if self.log.term_at(idx) != self.term:
                break   # §5.4.2: never count replicas for older terms
            votes = sum(1 for mi in self.match_index.values() if mi >= idx)
            if votes >= self.quorum:
                self.commit = idx
                self._hs_dirty = True
                break

    def _send_append(self, to: int, heartbeat_only: bool = False) -> None:
        ni = self.next_index.get(to, self.log.last_index() + 1)
        if ni <= self.log.snapshot_index:
            # follower needs compacted entries -> send a snapshot
            data = getattr(self, "_snapshot_data", b"")
            self._msgs.append(Message(
                MsgType.SNAPSHOT, self.id, to, self.term,
                snapshot=Snapshot(self.log.snapshot_index,
                                  self.log.snapshot_term, data)))
            return
        prev = ni - 1
        prev_term = self.log.term_at(prev) or 0
        entries = [] if heartbeat_only else self.log.slice_from(ni)
        self._msgs.append(Message(MsgType.APPEND, self.id, to, self.term,
                                  log_index=prev, log_term=prev_term,
                                  entries=list(entries),
                                  commit=self.commit))
        if entries:
            self.next_index[to] = entries[-1].index + 1

    def _broadcast_append(self, heartbeat_only: bool = False) -> None:
        for p in self.peers:
            self._send_append(p, heartbeat_only=heartbeat_only)
