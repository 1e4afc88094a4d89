"""Raft's append streams on the port (kvserver/raft.py), repaired.

The reference's leader answers every success response that leaves
entries unsent with another append, stale ones included. A stale
heartbeat response that lands after the next proposal so starts a
stream that lives as long as writes follow each other in that range,
and each later write adds one: a statement's messages grow with the
square of its writes to one range (tests/range_load_rate.py).

The port follows etcd instead, a named divergence from the reference:
- a success response that does not advance the follower's known match
  is ignored (``MaybeUpdate``);
- after an append that carries entries the follower's next index moves
  past them (the replicate state), so a lost append is found by the
  follower's reject at the next append or heartbeat, which backs the
  index off to the follower's hint.
"""

from __future__ import annotations

import pytest

import chip_smoke
from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.kvserver.cluster import Cluster
from cockroach_tpu_torch.kvserver.raft import Message, MsgType, RaftNode
from cockroach_tpu_torch.models import tpch
from cockroach_tpu_torch.sql.rowenc import RowCodec

ROWS = 1_200
PIECES = 4
N = 40


def _leader():
    """Node 1 of {1, 2, 3} as leader, its election's traffic drained."""
    r = RaftNode(1, [1, 2, 3])
    r._campaign()
    for p in (2, 3):
        r.step(Message(MsgType.VOTE_RESP, p, 1, r.term, granted=True))
    assert r.is_leader()
    r.ready()
    return r


def _appends(r):
    return [m for m in r.ready().messages if m.type == MsgType.APPEND]


def test_stale_success_sends_nothing():
    r = _leader()
    last = r.log.last_index()
    for p in (2, 3):
        r.step(Message(MsgType.APPEND_RESP, p, 1, r.term, success=True,
                       match_index=last))
    r.ready()
    r.propose(b"x")
    first = _appends(r)
    assert [(m.to, [e.data for e in m.entries]) for m in first] == [
        (2, [b"x"]), (3, [b"x"])]
    # a heartbeat's answer from before the proposal: no second stream
    r.step(Message(MsgType.APPEND_RESP, 2, 1, r.term, success=True,
                   match_index=last))
    assert _appends(r) == []
    # the append's own answer advances the match; nothing is left to send
    r.step(Message(MsgType.APPEND_RESP, 2, 1, r.term, success=True,
                   match_index=last + 1))
    assert _appends(r) == [] and r.match_index[2] == last + 1


def test_back_to_back_proposals_send_each_entry_once():
    r = _leader()
    last = r.log.last_index()
    for p in (2, 3):
        r.step(Message(MsgType.APPEND_RESP, p, 1, r.term, success=True,
                       match_index=last))
    r.ready()
    sent = []
    for i in range(5):
        r.propose(b"v%d" % i)
        sent += [e.data for m in _appends(r) if m.to == 2
                 for e in m.entries]
    assert sent == [b"v%d" % i for i in range(5)]


def test_lost_append_is_resent_after_the_followers_reject():
    r = _leader()
    last = r.log.last_index()
    r.step(Message(MsgType.APPEND_RESP, 2, 1, r.term, success=True,
                   match_index=last))
    r.ready()
    r.propose(b"lost")
    _appends(r)                           # dropped on the way to node 2
    r.tick()
    r.tick()                              # the heartbeat
    hb = [m for m in _appends(r) if m.to == 2]
    assert hb and hb[0].log_index == last + 1 and not hb[0].entries
    # node 2 lacks last + 1: it rejects with its last index as the hint
    r.step(Message(MsgType.APPEND_RESP, 2, 1, r.term, success=False,
                   match_index=last))
    again = _appends(r)
    assert [(m.to, [e.data for e in m.entries]) for m in again] == [
        (2, [b"lost"])]


def _split_cluster():
    li, _part, li_sql = chip_smoke.range_tables(ROWS)
    c = Cluster(n_nodes=3)
    c.create_range(b"\x00", b"\xff")
    c.pump_until(lambda: c.leaseholder(1) is not None)
    eng = Engine(cluster=c, device="cpu")
    eng.execute(tpch.DDL["lineitem"])
    for lo in range(0, ROWS, 600):
        eng.execute(chip_smoke._insert_sql("lineitem", li_sql, lo,
                                           min(ROWS, lo + 600)))
    codec = RowCodec(eng.store.table("lineitem").schema)
    for k in range(1, PIECES):
        c.split_range(codec.key_from_pk((ROWS * k // PIECES,)))
    c.pump(10)
    return c, eng, li


@pytest.fixture(scope="module")
def split_cluster():
    c, eng, li = _split_cluster()
    yield c, eng, li
    eng.close()


def test_update_messages_grow_linearly_after_a_split(split_cluster):
    """range_load_rate.py's ``update`` step at a CPU size: UPDATEs of
    the first N and 3N lineitem rows, all in the first of four ranges.
    3N writes cost at most about 3 times the messages of N (1,682 and
    4,874 messages); with the reference's rule they cost 7.6 times as
    many (8,242 and 62,954)."""
    c, eng, li = split_cluster
    total = "SELECT count(*), sum(l_quantity) FROM lineitem"
    (count0, qty0), = eng.execute(total).rows
    sent, hits = {}, 0
    for n in (N, 3 * N):
        key = int(li["l_orderkey"][n - 1])
        hit = int((li["l_orderkey"] <= key).sum())
        assert hit <= ROWS // PIECES          # one range
        hits += hit
        before = c.transport.sent
        eng.execute("UPDATE lineitem SET l_quantity = l_quantity + 1 "
                    f"WHERE l_orderkey <= {key}")
        sent[n] = c.transport.sent - before
    assert sent[3 * N] <= 3.3 * sent[N], sent
    c.pump(20)
    for rid in sorted(c.descriptors):
        c.check_replica_consistency(rid)
    assert eng.execute(total).rows == [(count0, qty0 + hits)]
