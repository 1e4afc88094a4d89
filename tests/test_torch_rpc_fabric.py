"""The port's socket fabric against the reference's
(tests/test_rpc_fabric.py, test_fault_injection.py's injector, socket,
breaker cases, test_kvserver_breadth.py::TestBreaker, test_heartbeat.py's
PeerMonitor cases, test_shuffle_flows.py::test_sharded_join_over_tcp,
test_join_skipping.py's two frame-fault cases).

- The codec: the port's bytes equal the reference ``encode_msg``'s for
  the same message, hand-made ones and every message a port flow sends.
- ``FaultInjector.plan`` gives the reference's schedule draw for draw
  for the same seed and rules; ``Retrier``'s backoffs equal the
  reference's for a seeded policy; ``Breaker`` moves through the
  reference's states for a seeded script of reports.
- SocketTransport, Gossip and PeerMonitor: the reference's cases.
- DistSQL over TCP: port nodes (``Engine(device="cpu")``), each on its
  own SocketTransport with a pump thread, against one reference
  ``Engine`` over the whole table; a tripped PeerMonitor fails a flow
  fast.
- The DistSQL flow, graph, adaptive, tree and EXPLAIN ANALYZE cases
  (tests/test_torch_distsql_flows.py and its neighbours) over a
  transport that passes every message through ``decode_msg(encode_msg(m))``
  before delivery, against the reference's gateway over reference
  nodes on the same arrays.

Tolerances: DECIMAL and FLOAT8 results within rel 1e-9 (the reference's
own flow tests compare floats so), everything else exactly; codec bytes,
schedules and backoffs exactly.
"""

import random
import threading
import time

import numpy as np
import pytest

import cockroach_tpu_torch.distsql.node as pnode
import cockroach_tpu_torch.kvserver.transport as ptr
from cockroach_tpu_torch.distsql.flow import FlowSpec
from cockroach_tpu_torch.distsql.node import (DistSQLNode, FlowError,
                                              FlowUnavailable, Gateway)
from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.models import tpch
from cockroach_tpu_torch.rpc import (DeadlineExceeded, FaultInjector, Gossip,
                                     Retrier, RetryPolicy, SocketTransport,
                                     decode_msg, encode_msg)
from cockroach_tpu_torch.rpc.gossip import wire_settings
from cockroach_tpu_torch.rpc.heartbeat import LivenessMonitor, PeerMonitor
from cockroach_tpu_torch.utils.circuit import Breaker, BreakerTrippedError
from cockroach_tpu_torch.utils.metric import MetricRegistry
from cockroach_tpu_torch.utils.settings import Settings
from tests.test_torch_distsql_flows import (TPCH_DDL, assert_rows_close,
                                            build_fabric, oracle_engine,
                                            port_engine, reference)
from tests.test_torch_groupagg_large import reference_modules
from tests.test_torch_ranges import reference_cases

ROWS = 3000
FLOAT_REL = 1e-9


@pytest.fixture(scope="module")
def ref_rpc():
    """The reference's rpc/context, rpc/retry and utils/circuit."""
    with reference_modules("cockroach_tpu.rpc.context",
                           "cockroach_tpu.rpc.retry",
                           "cockroach_tpu.utils.circuit") as mods:
        yield mods


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

HAND_MESSAGES = [
    ("setup_flow", {"a": 1, "blob": b"\x00\xff" * 10,
                    "list": [b"x", {"y": b"z"}, 3.5, None]}),
    {"hello": b"world"},
    ("flow_stream", "f-1", 0, b"\x01\x02" * 300, False, None),
    ("flow_stream", "f-1", "g:p2", None, True, "[flow-unavailable] x"),
    {"kind": "__gossip__", "infos": {"k": ["v", 5.0, 1],
                                     "n": [[1, 2], [b"a", b""]]}},
    {"nested": [[b"", bytearray(b"ab")], {"u": "ünïcode",
                                          "t": (1, 2.5, True, -7)}]},
    "a plain string", 42, -2.5, None, [], {},
]


class CodecTransport(ptr.LocalTransport):
    """LocalTransport whose every message is the codec's round trip:
    what a peer over TCP would receive (tuples come back as lists, bytes
    as bytes, anything JSON cannot carry raises in send)."""

    def __init__(self):
        super().__init__()
        self.messages: list = []

    def send(self, frm, to, msg):
        self.messages.append(msg)
        super().send(frm, to, decode_msg(encode_msg(msg)))


class _CodecModule:
    LocalTransport = CodecTransport


class TestCodec:
    def test_roundtrip_nested_bytes(self):
        msg = ("setup_flow", {"a": 1, "blob": b"\x00\xff" * 10,
                             "list": [b"x", {"y": b"z"}, 3.5, None]})
        out = decode_msg(encode_msg(msg))
        assert out[0] == "setup_flow"
        assert out[1]["blob"] == b"\x00\xff" * 10
        assert out[1]["list"][0] == b"x"
        assert out[1]["list"][1]["y"] == b"z"
        assert out[1]["list"][2] == 3.5

    @pytest.mark.parametrize("i", range(len(HAND_MESSAGES)))
    def test_bytes_equal_the_references(self, ref_rpc, i):
        jctx = ref_rpc[0]
        msg = HAND_MESSAGES[i]
        raw = encode_msg(msg)
        assert raw == jctx.encode_msg(msg)
        assert decode_msg(raw) == jctx.decode_msg(raw)

    def test_flow_messages_equal_the_references(self, ref_rpc):
        """Every message of a port flow (SetupFlow with join-filter
        frames, streams, acks, spans, profiles) encodes to the
        reference's bytes and decodes to the same value in both."""
        jctx = ref_rpc[0]
        tabs = {"lineitem": tpch.gen_lineitem(0.01, rows=600),
                "part": tpch.gen_part(0.01)}
        gw, _n, _e, transport = build_fabric(
            pnode, _CodecModule, port_engine, TPCH_DDL, tabs,
            replicated={"part"})
        from cockroach_tpu_torch.utils import tracing
        with tracing.capture("stmt"):
            gw.run(tpch.Q14)
        gw.run("EXPLAIN ANALYZE (DEBUG) " + tpch.Q1)
        kinds = {m[0] for m in transport.messages}
        assert {"setup_flow", "flow_stream", "flow_ack", "flow_span",
                "flow_profile"} <= kinds
        assert any(m[0] == "setup_flow" and m[1]["joinfilter"]
                   for m in transport.messages)
        for m in transport.messages:
            raw = encode_msg(m)
            assert raw == jctx.encode_msg(m)
            assert decode_msg(raw) == jctx.decode_msg(raw)

    def test_unencodable_message_raises_in_send(self):
        """No pickle: a value JSON cannot carry fails loudly at the
        sender instead of crossing the wire as code."""
        t0, t1 = _mesh_of_transports(2)
        try:
            with pytest.raises(TypeError):
                t0.send(0, 1, {"x": {1, 2}})
        finally:
            t0.close()
            t1.close()


# ---------------------------------------------------------------------------
# the fault injector, retry policy and breaker against the reference's
# ---------------------------------------------------------------------------

def _script_injector(mod, seed):
    inj = mod.FaultInjector(seed=seed)
    inj.set_rule(1, 2, drop=0.3, dup=0.2, delay=0.2, delay_s=0.07)
    inj.set_rule(2, 3, delay=0.5, delay_s=0.01, symmetric=True)
    rng = random.Random(seed + 1000)
    out = []
    for step in range(400):
        if step == 150:
            inj.partition(1, 3)
        if step == 250:
            inj.heal(1, 3)
        if step == 300:
            inj.clear_rules()
            inj.set_rule(3, 1, dup=0.6)
        frm, to = rng.choice([(1, 2), (2, 1), (2, 3), (3, 2), (1, 3),
                              (3, 1)])
        out.append((frm, to, tuple(inj.plan(frm, to))))
    return out, (inj.dropped, inj.duplicated, inj.delayed)


class TestFaultInjector:
    @pytest.mark.parametrize("seed", [0, 7, 42])
    def test_schedule_is_the_references(self, ref_rpc, seed):
        import cockroach_tpu_torch.rpc.context as pctx
        assert _script_injector(pctx, seed) == \
            _script_injector(ref_rpc[0], seed)

    def test_same_seed_same_schedule(self):
        plans = []
        for _ in range(2):
            inj = FaultInjector(seed=42)
            inj.set_rule(1, 2, drop=0.3, dup=0.2, delay=0.2)
            plans.append([tuple(inj.plan(1, 2)) for _ in range(200)])
        assert plans[0] == plans[1]
        inj = FaultInjector(seed=43)
        inj.set_rule(1, 2, drop=0.3, dup=0.2, delay=0.2)
        assert [tuple(inj.plan(1, 2)) for _ in range(200)] != plans[0]

    def test_certain_rules(self):
        inj = FaultInjector(seed=0)
        inj.set_rule(1, 2, drop=1.0)
        assert inj.plan(1, 2) == []
        inj.set_rule(1, 2, dup=1.0)
        assert inj.plan(1, 2) == [0.0, 0.0]
        inj.set_rule(1, 2, delay=1.0, delay_s=0.25)
        assert inj.plan(1, 2) == [0.25]
        assert inj.plan(2, 1) == [0.0]
        assert inj.dropped == 1 and inj.duplicated == 1
        assert inj.delayed == 1

    def test_partition_and_heal(self):
        inj = FaultInjector(seed=0)
        inj.partition(1, 2)
        assert inj.partitioned(1, 2) and inj.partitioned(2, 1)
        assert inj.plan(1, 2) == [] and inj.plan(2, 1) == []
        assert not inj.partitioned(1, 3)
        inj.heal(1, 2)
        assert inj.plan(1, 2) == [0.0]
        inj.partition(1, 2)
        inj.partition(1, 3)
        inj.heal()
        assert inj.plan(1, 2) == [0.0] and inj.plan(1, 3) == [0.0]


def _backoffs(mod, policy_kw, seed):
    pol = mod.RetryPolicy(**policy_kw)
    rng = random.Random(seed)
    raw = [pol.backoff(a, rng) for a in range(12)]
    now = [0.0]
    r = mod.Retrier(pol, random.Random(seed), clock=lambda: now[0])
    steps = []
    for attempt in r:
        b = r.next_backoff()
        steps.append((attempt, b, r.remaining(), r.expired()))
        now[0] += b + 0.05
    return raw, steps


class TestRetry:
    @pytest.mark.parametrize("kw", [
        {}, {"max_attempts": 10, "base_backoff": 0.01, "max_backoff": 0.2,
             "multiplier": 3.0, "jitter": 0.25, "deadline": 1.0},
        {"jitter": 0.0, "deadline": None, "max_attempts": 5}])
    @pytest.mark.parametrize("seed", [0, 5])
    def test_backoffs_are_the_references(self, ref_rpc, kw, seed):
        import cockroach_tpu_torch.rpc.retry as pretry
        assert _backoffs(pretry, kw, seed) == _backoffs(ref_rpc[1], kw,
                                                        seed)

    def test_deadline_stops_attempts(self):
        now = [0.0]
        r = Retrier(RetryPolicy(max_attempts=100, deadline=1.0),
                    clock=lambda: now[0])
        seen = []
        for a in r:
            seen.append(a)
            now[0] += 0.4
        assert seen == [0, 1, 2]
        assert r.expired() and r.remaining() == 0.0
        assert issubclass(DeadlineExceeded, RuntimeError)

    def test_metrics(self):
        reg = MetricRegistry()
        r = Retrier(RetryPolicy(max_attempts=3, base_backoff=0.001,
                                jitter=0.0), metrics=reg)
        for _ in r:
            r.wait()
        snap = reg.snapshot()
        assert snap["retry.attempts"] == 3
        assert snap["retry.backoff.seconds"] > 0


def _breaker_script(mod, seed):
    t = [0.0]
    probe_ok = [False]
    b = mod.Breaker("s", threshold=2, cooldown=1.0, clock=lambda: t[0],
                    probe=lambda: probe_ok[0])
    rng = random.Random(seed)
    out = []
    for _ in range(300):
        op = rng.random()
        t[0] += rng.random() * 0.6
        probe_ok[0] = rng.random() < 0.2
        if op < 0.45:
            b.report_failure()
            r = "fail"
        elif op < 0.6:
            b.report_success()
            r = "ok"
        else:
            try:
                b.check()
                r = "pass"
            except mod.BreakerTrippedError:
                r = "tripped"
        out.append((r, b.tripped, b.half_open, b.failures, b.trip_count))
    return out


class TestBreaker:
    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_states_are_the_references(self, ref_rpc, seed):
        import cockroach_tpu_torch.utils.circuit as pcirc
        assert _breaker_script(pcirc, seed) == \
            _breaker_script(ref_rpc[2], seed)

    def test_cooldown_half_open_cycle(self):
        t = [0.0]
        b = Breaker("x", threshold=1, cooldown=5.0, clock=lambda: t[0])
        b.check()
        b.report_failure()
        assert b.tripped and b.trip_count == 1
        with pytest.raises(BreakerTrippedError):
            b.check()
        t[0] = 4.9
        with pytest.raises(BreakerTrippedError):
            b.check()
        t[0] = 5.1
        b.check()
        assert b.half_open
        b.report_failure()
        assert b.tripped and not b.half_open
        with pytest.raises(BreakerTrippedError):
            b.check()
        t[0] = 10.2
        b.check()
        b.report_success()
        assert not b.tripped and b.failures == 0

    def test_probe_mode(self):
        ok = [False]
        b = Breaker("p", threshold=2, probe=lambda: ok[0])
        b.report_failure()
        assert not b.tripped
        b.report_failure()
        assert b.tripped
        with pytest.raises(BreakerTrippedError):
            b.check()
        ok[0] = True
        b.check()
        assert not b.tripped

    def test_unit(self):
        state = {"ok": False}
        b = Breaker("x", threshold=2, probe=lambda: state["ok"])
        b.check()
        b.report_failure()
        b.check()
        b.report_failure()
        with pytest.raises(BreakerTrippedError):
            b.check()
        assert b.trip_count == 1
        state["ok"] = True
        b.check()
        assert not b.tripped

    def test_register_metrics(self):
        reg = MetricRegistry()
        b = Breaker("m", threshold=1)
        b.register_metrics(reg, "rpc.breaker.n2")
        b.report_failure()
        snap = reg.snapshot()
        assert snap["rpc.breaker.n2.trips"] == 1
        assert snap["rpc.breaker.n2.tripped"] == 1.0
        b.reset()
        assert reg.snapshot()["rpc.breaker.n2.tripped"] == 0.0


# ---------------------------------------------------------------------------
# SocketTransport
# ---------------------------------------------------------------------------

def _mesh_of_transports(n, injector=None):
    ts = [SocketTransport(i, injector=injector) for i in range(n)]
    for a in ts:
        for b in ts:
            if a is not b:
                a.connect(b.node_id, b.addr)
    return ts


def _pump_until(cond, *transports, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        for t in transports:
            t.deliver_all()
        time.sleep(0.005)
    return cond()


class TestSocketTransport:
    def test_cross_transport_delivery(self):
        t0, t1 = _mesh_of_transports(2)
        try:
            got = []
            t1.register(1, lambda frm, msg: got.append((frm, msg)))
            t0.send(0, 1, {"hello": b"world"})
            assert _pump_until(lambda: got, t1)
            assert got == [(0, {"hello": b"world"})]
        finally:
            t0.close()
            t1.close()

    def test_frames_keep_order_and_metrics_count_them(self):
        t0, t1 = _mesh_of_transports(2)
        reg = MetricRegistry()
        t1.attach_metrics(reg)
        try:
            got = []
            t1.register(1, lambda frm, msg: got.append(msg))
            for i in range(50):
                t0.send(0, 1, ("m", i, b"x" * i))
            assert _pump_until(lambda: len(got) == 50, t1)
            assert got == [["m", i, b"x" * i] for i in range(50)]
            snap = reg.snapshot()
            assert snap["rpc.frames.delivered"] == 50
            assert snap["rpc.frames.pending"] == 0
            assert t0.sent == 50
        finally:
            t0.close()
            t1.close()

    def test_send_to_dead_peer_drops(self):
        (t0,) = _mesh_of_transports(1)
        try:
            t0.connect(9, ("127.0.0.1", 1))   # nothing listens there
            t0.send(0, 9, {"x": 1})           # must not raise
            t0.send(0, 8, {"x": 1})           # unknown peer: dropped
        finally:
            t0.close()

    def test_transport_partition_drops_both_ways(self):
        t0, t1 = _mesh_of_transports(2)
        try:
            got = []
            t1.register(1, lambda frm, msg: got.append(msg))
            t0.partition(1)
            t0.send(0, 1, "lost")
            t0.heal()
            t0.send(0, 1, "kept")
            assert _pump_until(lambda: got, t1)
            time.sleep(0.05)
            t1.deliver_all()
            assert got == ["kept"]
        finally:
            t0.close()
            t1.close()


class TestSocketTransportFaults:
    def _one(self, inj):
        t = SocketTransport(2, injector=inj)
        got = []
        t.register(2, lambda frm, msg: got.append((frm, msg)))
        return t, got

    def test_drop_dup(self):
        inj = FaultInjector(seed=0)
        t, got = self._one(inj)
        try:
            inj.set_rule(1, 2, drop=1.0)
            t.send(1, 2, "a")
            inj.set_rule(1, 2, dup=1.0)
            t.send(1, 2, "b")
            inj.clear_rules()
            t.send(1, 2, "c")
            t.deliver_all()
            assert [m for _, m in got] == ["b", "b", "c"]
        finally:
            t.close()

    def test_delay_holds_frame_until_due(self):
        inj = FaultInjector(seed=0)
        inj.set_rule(1, 2, delay=1.0, delay_s=0.15)
        t, got = self._one(inj)
        try:
            t.send(1, 2, "late")
            assert t.pending() == 1
            t.deliver_all()
            assert got == []
            assert _pump_until(lambda: got, t)
            assert [m for _, m in got] == ["late"]
        finally:
            t.close()

    def test_partition_drops_frames_already_queued(self):
        inj = FaultInjector(seed=0)
        t, got = self._one(inj)
        try:
            t.send(1, 2, "in-flight")
            inj.partition(1, 2)
            t.deliver_all()
            assert got == []
            inj.heal()
            t.send(1, 2, "after-heal")
            t.deliver_all()
            assert [m for _, m in got] == ["after-heal"]
        finally:
            t.close()

    def test_injected_faults_over_real_sockets(self):
        """One injector shared by two transports: frames 0 -> 1 are
        duplicated, frames 1 -> 0 dropped, across the TCP link."""
        inj = FaultInjector(seed=4)
        inj.set_rule(0, 1, dup=1.0)
        inj.set_rule(1, 0, drop=1.0)
        t0, t1 = _mesh_of_transports(2, injector=inj)
        reg = MetricRegistry()
        t0.attach_metrics(reg)
        try:
            g0, g1 = [], []
            t0.register(0, lambda frm, msg: g0.append(msg))
            t1.register(1, lambda frm, msg: g1.append(msg))
            t0.send(0, 1, "twice")
            t1.send(1, 0, "never")
            assert _pump_until(lambda: len(g1) == 2, t0, t1)
            time.sleep(0.05)
            t0.deliver_all()
            assert g1 == ["twice", "twice"] and g0 == []
            snap = reg.snapshot()
            assert snap["rpc.frames.duplicated"] == 1
            assert snap["rpc.frames.dropped"] == 1
        finally:
            t0.close()
            t1.close()


# ---------------------------------------------------------------------------
# gossip
# ---------------------------------------------------------------------------

def _converge(gossips, transports, settings, name, value):
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        for g in gossips:
            g.tick()
        for t in transports:
            t.deliver_all()
        if all(s.get(name) == value for s in settings):
            return True
        time.sleep(0.01)
    return False


class TestGossip:
    def test_settings_converge(self):
        transports = _mesh_of_transports(3)
        try:
            settings = [Settings() for _ in range(3)]
            gossips = []
            for i, (t, s) in enumerate(zip(transports, settings)):
                g = Gossip(i, t, peers=[0, 1, 2])
                t.register(i, lambda frm, msg, g=g: g.handle(frm, msg))
                wire_settings(g, s)
                gossips.append(g)
            settings[0].set("kv.gc.ttl_seconds", 777)
            assert _converge(gossips, transports, settings,
                             "kv.gc.ttl_seconds", 777)
            # a later change from ANOTHER node wins by timestamp
            settings[2].set("kv.gc.ttl_seconds", 888)
            assert _converge(gossips, transports, settings,
                             "kv.gc.ttl_seconds", 888)
        finally:
            for t in transports:
                t.close()

    def test_equal_ts_converges_by_origin(self):
        ta, tb = SocketTransport(0), SocketTransport(1)
        try:
            ga = Gossip(0, ta, peers=[0, 1])
            gb = Gossip(1, tb, peers=[0, 1])
            ga.add_info("k", "from-a", ts=5.0)
            gb.add_info("k", "from-b", ts=5.0)
            payload_a = {"kind": "__gossip__",
                         "infos": {k: list(v) for k, v in ga.infos.items()}}
            payload_b = {"kind": "__gossip__",
                         "infos": {k: list(v) for k, v in gb.infos.items()}}
            ga.handle(1, payload_b)
            gb.handle(0, payload_a)
            assert ga.get_info("k") == gb.get_info("k") == "from-b"
        finally:
            ta.close()
            tb.close()

    def test_local_set_during_remote_apply_still_publishes(self):
        """A local SET issued while gossip applies a remote update of a
        DIFFERENT setting is still published (per-key suppression). The
        port's cluster settings have no sql.exec.hash_group_capacity, so
        the interleaved setting is sql.exec.hbm_budget_bytes."""
        t = SocketTransport(0)
        try:
            g = Gossip(0, t, peers=[0])
            s = Settings()
            fired = []
            orig_set = s.set

            def interleaving_set(name, value):
                orig_set(name, value)
                if name == "kv.gc.ttl_seconds" and not fired:
                    fired.append(1)
                    orig_set("sql.exec.hbm_budget_bytes", 1 << 30)

            s.set = interleaving_set
            wire_settings(g, s)
            g.handle(1, {"kind": "__gossip__",
                         "infos": {"setting:kv.gc.ttl_seconds":
                                   [999, 9.0, 1]}})
            assert s.get("kv.gc.ttl_seconds") == 999
            assert s.get("sql.exec.hbm_budget_bytes") == 1 << 30
            assert g.get_info("setting:sql.exec.hbm_budget_bytes") == \
                1 << 30
        finally:
            t.close()

    def test_local_readd_at_stale_ts_still_wins_locally(self):
        t = SocketTransport(0)
        try:
            g = Gossip(0, t, peers=[0])
            g.add_info("k", "v1", ts=5.0)
            g.add_info("k", "v2", ts=5.0)
            assert g.get_info("k") == "v2"
            assert g.infos["k"][1] > 5.0
        finally:
            t.close()

    def test_info_merge_by_timestamp(self):
        t = SocketTransport(0)
        try:
            g = Gossip(0, t, peers=[0])
            g.add_info("k", "old", ts=1.0)
            assert not g.handle(0, {"kind": "nope"})
            g.handle(1, {"kind": "__gossip__",
                         "infos": {"k": ["new", 5.0, 1],
                                   "other": ["x", 2.0, 1]}})
            assert g.get_info("k") == "new"
            assert g.get_info("other") == "x"
            g.handle(1, {"kind": "__gossip__",
                         "infos": {"k": ["stale", 0.5, 1]}})
            assert g.get_info("k") == "new"
        finally:
            t.close()


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------

def _monitor_pair():
    t1 = SocketTransport(1)
    t2 = SocketTransport(2)
    t1.connect(2, t2.addr)
    t2.connect(1, t1.addr)
    m1 = PeerMonitor(1, t1)
    m2 = PeerMonitor(2, t2)
    t1.register(1, lambda frm, msg: m1.handle(frm, msg))
    t2.register(2, lambda frm, msg: m2.handle(frm, msg))
    return t1, t2, m1, m2


def _pump(*transports, rounds=4):
    for _ in range(rounds):
        for t in transports:
            t.deliver_all()
        time.sleep(0.02)


class TestHeartbeats:
    def test_healthy_round_trip(self):
        t1, t2, m1, _m2 = _monitor_pair()
        reg = MetricRegistry()
        m1.attach_metrics(reg)
        try:
            m1.tick()
            _pump(t1, t2)
            assert m1.healthy(2)
            assert 2 in m1.rtt_ns
            assert abs(m1.offset_ns[2]) < m1.max_offset_ns
            assert reg.snapshot()["rpc.heartbeat.unhealthy.peers"] == 0
        finally:
            t1.close()
            t2.close()

    def test_dead_peer_trips_within_bound(self):
        t1, t2, m1, _m2 = _monitor_pair()
        try:
            m1.tick()
            _pump(t1, t2)
            assert m1.healthy(2)
            t2.close()
            for _ in range(m1.miss_limit + 1):
                m1.tick()
                _pump(t1)
            assert not m1.healthy(2)
            assert m1.tripped_peers() == [2]
        finally:
            t1.close()

    def test_restarted_peer_reintegrates(self):
        t1, t2, m1, _m2 = _monitor_pair()
        addr2 = t2.addr
        try:
            t2.close()
            for _ in range(m1.miss_limit + 1):
                m1.tick()
                _pump(t1)
            assert not m1.healthy(2)
            t2b = SocketTransport(2, host=addr2[0], port=addr2[1])
            t2b.connect(1, t1.addr)
            m2b = PeerMonitor(2, t2b)
            t2b.register(2, lambda frm, msg: m2b.handle(frm, msg))
            try:
                for _ in range(3):
                    m1.tick()
                    _pump(t1, t2b)
                    if m1.healthy(2):
                        break
                assert m1.healthy(2)
            finally:
                t2b.close()
        finally:
            t1.close()

    def test_clock_skew_marks_peer(self):
        t1, t2, m1, m2 = _monitor_pair()
        try:
            m2.wall_ns = lambda: time.time_ns() + 10_000_000_000
            m1.tick()
            _pump(t1, t2)
            assert not m1.healthy(2)
            assert 2 in m1.skewed
            m2.wall_ns = time.time_ns
            m1.tick()
            _pump(t1, t2)
            assert m1.healthy(2)
        finally:
            t1.close()
            t2.close()

    def test_liveness_monitor_adapter(self):
        class Liveness:
            def is_live(self, n):
                return n != 3

        class Cluster:
            liveness = Liveness()
        for src in (Liveness(), Cluster()):
            mon = LivenessMonitor(src)
            assert mon.healthy(1) and not mon.healthy(3)


# ---------------------------------------------------------------------------
# DistSQL over TCP
# ---------------------------------------------------------------------------

class SocketFabric:
    """Port nodes each on their own SocketTransport, the data nodes each
    with a pump thread (threads standing in for processes); node 0 is
    the gateway's and is pumped by the gateway's own waits."""

    def __init__(self, engines):
        self.transports = _mesh_of_transports(len(engines))
        self.nodes = [DistSQLNode(i, e, t) for i, (e, t) in
                      enumerate(zip(engines, self.transports))]
        self.stops = {}
        self.threads = {}
        for i, t in enumerate(self.transports[1:], start=1):
            self.stops[i] = threading.Event()
            self.threads[i] = threading.Thread(
                target=self._pump, args=(t, self.stops[i]), daemon=True)
            self.threads[i].start()

    @staticmethod
    def _pump(t, stop):
        while not stop.is_set():
            if not t.deliver_all():
                time.sleep(0.002)

    def kill(self, i):
        """Node i's process dies: its pump stops and its fabric closes."""
        self.stops[i].set()
        self.threads[i].join(timeout=10)
        self.transports[i].close()

    def close(self):
        for i in self.threads:
            self.kill(i)
        self.transports[0].close()


def _shard(engines, name, cols, bounds):
    for i, eng in enumerate(engines):
        lo, hi = bounds[i], bounds[i + 1]
        eng.store.insert_columns(name, {k: v[lo:hi] for k, v in
                                        cols.items()}, eng.clock.now())


def _load_fabric_engines(li, part, n_data, shard_part):
    engines = []
    for _ in range(n_data + 1):
        eng = Engine(device="cpu")
        for ddl in TPCH_DDL:
            eng.execute(ddl)
        engines.append(eng)
    n = len(li["l_orderkey"])
    _shard(engines[1:], "lineitem", li,
           [n * i // n_data for i in range(n_data + 1)])
    if shard_part:
        m = len(part["p_partkey"])
        _shard(engines[1:], "part", part,
               [m * i // n_data for i in range(n_data + 1)])
    else:
        for eng in engines:
            eng.store.insert_columns("part", part, eng.clock.now())
    return engines


@pytest.fixture(scope="module")
def tcp_tables():
    return {"lineitem": tpch.gen_lineitem(0.01, rows=ROWS),
            "part": tpch.gen_part(0.01)}


@pytest.fixture(scope="module")
def ref_oracle(tcp_tables):
    """One reference Engine over the whole tables: rows of every query
    the TCP cases run."""
    qs = {"q6": tpch.Q6, "q1": tpch.Q1, "q14": tpch.Q14}
    with reference() as (jeng, _jnode, _jtr, _jt):
        one = oracle_engine(lambda _i: jeng.Engine(), TPCH_DDL, tcp_tables)
        return {k: one.execute(q).rows for k, q in qs.items()}


@pytest.fixture(scope="module")
def socket_fakedist(tcp_tables):
    fab = SocketFabric(_load_fabric_engines(
        tcp_tables["lineitem"], tcp_tables["part"], 3, False))
    gw = Gateway(fab.nodes[0], [1, 2, 3], replicated_tables={"part"})
    yield gw, fab
    fab.close()


class TestDistSQLOverSockets:
    def test_q6_over_tcp(self, socket_fakedist, ref_oracle):
        gw, _fab = socket_fakedist
        got = gw.run(tpch.Q6)
        assert_rows_close(got.rows, ref_oracle["q6"])

    def test_q1_groupby_over_tcp(self, socket_fakedist, ref_oracle):
        gw, fab = socket_fakedist
        got = gw.run(tpch.Q1)
        assert_rows_close(got.rows, ref_oracle["q1"])
        for rg, rw in zip(got.rows, ref_oracle["q1"]):
            assert rg[9] == rw[9]       # count_order exact
        assert sum(t.sent for t in fab.transports[1:]) > 0

    def test_q14_with_join_filter_and_tree_over_tcp(self, socket_fakedist,
                                                    ref_oracle):
        gw, fab = socket_fakedist
        assert_rows_close(gw.run(tpch.Q14).rows, ref_oracle["q14"])
        tree = Gateway(fab.nodes[0], [1, 2, 3], replicated_tables={"part"},
                       merge_fanout=2)
        got = tree.run(tpch.Q1)
        assert_rows_close(got.rows, ref_oracle["q1"])

    def test_no_inbox_left(self, socket_fakedist):
        gw, fab = socket_fakedist
        gw.run(tpch.Q6)
        assert all(not n.registry._inboxes for n in fab.nodes)

    def test_sharded_join_over_tcp(self, tcp_tables, ref_oracle):
        """Both sides row-sharded over three nodes: a graph flow whose
        exchange frames cross the sockets."""
        fab = SocketFabric(_load_fabric_engines(
            tcp_tables["lineitem"], tcp_tables["part"], 3, True))
        try:
            gw = Gateway(fab.nodes[0], [1, 2, 3])
            got = gw.run(tpch.Q14)
            assert_rows_close(got.rows, ref_oracle["q14"])
            assert fab.nodes[0].engine.metrics.snapshot()[
                "distsql.flows.graph"] == 1
        finally:
            fab.close()

    def test_monitor_fails_fast_on_dead_peer(self, tcp_tables):
        """Gateway(monitor=PeerMonitor): a data node whose fabric died
        trips its breaker through missed heartbeats, and the next flow
        fails fast with FlowUnavailable instead of waiting out the
        flow timeout."""
        fab = SocketFabric(_load_fabric_engines(
            {k: v[:300] for k, v in tcp_tables["lineitem"].items()},
            tcp_tables["part"], 2, False))
        try:
            node0, t0 = fab.nodes[0], fab.transports[0]
            mon = PeerMonitor(0, t0)
            t0.register(0, lambda frm, msg: mon.handle(frm, msg)
                        or node0._handle(frm, msg))
            for i in (1, 2):
                mi = PeerMonitor(i, fab.transports[i])
                node = fab.nodes[i]
                fab.transports[i].register(
                    i, lambda frm, msg, mi=mi, node=node:
                    mi.handle(frm, msg) or node._handle(frm, msg))
            mon.tick()
            assert _pump_until(lambda: 1 in mon.rtt_ns and 2 in mon.rtt_ns,
                               t0)
            gw = Gateway(node0, [1, 2], replicated_tables={"part"},
                         monitor=mon, flow_timeout=30.0)
            assert gw.run("SELECT count(*) FROM lineitem").rows == [(300,)]
            fab.kill(2)
            for _ in range(mon.miss_limit + 1):
                mon.tick()
                _pump_until(lambda: False, t0, timeout=0.05)
            assert not mon.healthy(2)
            t_start = time.monotonic()
            with pytest.raises(FlowUnavailable, match="unhealthy"):
                gw.run("SELECT count(*) FROM lineitem")
            assert time.monotonic() - t_start < 10.0
        finally:
            fab.close()


# ---------------------------------------------------------------------------
# the join-filter frame under transport faults (test_join_skipping.py)
# ---------------------------------------------------------------------------

T_DDL = "CREATE TABLE t (k INT8 NOT NULL PRIMARY KEY, v INT8)"
D_DDL = "CREATE TABLE d (k INT8 NOT NULL PRIMARY KEY, w INT8)"
DIST_Q = "SELECT count(*), sum(v) FROM t JOIN d ON t.k = d.k"


def _skip_fabric(transport_cls, make_engine, **gw_kw):
    transport = transport_cls()
    nodes, engines = [], []
    dk = np.arange(100, 160, dtype=np.int64)
    for i in range(4):
        eng = make_engine()
        eng.execute(T_DDL)
        eng.execute(D_DDL)
        ts = eng.clock.now()
        if i > 0:
            base = (i - 1) * 20000
            for c in range(4):
                lo = base + c * 500
                k = np.arange(lo, lo + 500, dtype=np.int64)
                eng.store.insert_columns("t", {"k": k, "v": k % 97}, ts)
        eng.store.insert_columns("d", {"k": dk, "w": dk * 2}, ts)
        engines.append(eng)
        nodes.append(DistSQLNode(i, eng, transport))
    gw = Gateway(nodes[0], [1, 2, 3], replicated_tables={"d"}, **gw_kw)
    return gw, engines


@pytest.fixture(scope="module")
def dist_q_rows():
    with reference() as (jeng, jnode, jtr, _jt):
        tr = jtr.LocalTransport
        nodes, transport = [], tr()
        dk = np.arange(100, 160, dtype=np.int64)
        for i in range(4):
            eng = jeng.Engine()
            eng.execute(T_DDL)
            eng.execute(D_DDL)
            ts = eng.clock.now()
            if i > 0:
                base = (i - 1) * 20000
                for c in range(4):
                    lo = base + c * 500
                    k = np.arange(lo, lo + 500, dtype=np.int64)
                    eng.store.insert_columns("t", {"k": k, "v": k % 97},
                                             ts)
            eng.store.insert_columns("d", {"k": dk, "w": dk * 2}, ts)
            nodes.append(jnode.DistSQLNode(i, eng, transport))
        return jnode.Gateway(nodes[0], [1, 2, 3],
                             replicated_tables={"d"}).run(DIST_Q).rows


def _faulty(inj):
    class FaultyTransport(ptr.LocalTransport):
        def send(self, frm, to, msg):
            if msg[0] == "setup_flow":
                for _ in inj.plan(frm, to):
                    super().send(frm, to, msg)
                return
            super().send(frm, to, msg)
    return FaultyTransport


def _counter(eng, name):
    m = eng.metrics.get(name)
    return m.value() if m is not None else 0


class TestJoinFilterFrameFaults:
    def test_frame_survives_dup_and_delay(self, dist_q_rows):
        inj = FaultInjector(seed=9)
        inj.set_rule(0, 1, dup=1.0)
        inj.set_rule(0, 2, delay=1.0, delay_s=0.0)
        gw, engines = _skip_fabric(_faulty(inj),
                                   lambda: Engine(device="cpu"))
        got = gw.run(DIST_Q)
        assert got.rows == dist_q_rows
        assert inj.duplicated >= 1 and inj.delayed >= 1
        assert sum(_counter(e, "exec.skip.joinfilter.chunks")
                   for e in engines) >= 11

    def test_dropped_setup_flow_fails_not_corrupts(self):
        inj = FaultInjector(seed=10)
        inj.set_rule(0, 3, drop=1.0)
        gw, _ = _skip_fabric(_faulty(inj), lambda: Engine(device="cpu"),
                             flow_timeout=1.5)
        with pytest.raises(FlowUnavailable):
            gw.run(DIST_Q)


# ---------------------------------------------------------------------------
# the DistSQL flow cases through the codec's round trip
# ---------------------------------------------------------------------------

PLAIN_Q = ("SELECT l_orderkey, l_quantity FROM lineitem "
           "WHERE l_quantity < 3 ORDER BY l_orderkey, l_quantity LIMIT 17")
JOIN_AGG = ("SELECT p_brand, count(*), sum(l_quantity) FROM lineitem "
            "JOIN part ON l_partkey = p_partkey "
            "GROUP BY p_brand ORDER BY p_brand")
GROUP_INT = ("SELECT l_linenumber, count(*), avg(l_extendedprice) "
             "FROM lineitem GROUP BY l_linenumber ORDER BY l_linenumber")
RAW_Q = ("SELECT l_orderkey, l_linenumber, count(*) AS c, "
         "sum(l_quantity) AS sq FROM lineitem "
         "GROUP BY l_orderkey, l_linenumber "
         "ORDER BY l_orderkey, l_linenumber LIMIT 40")
TREE_Q = ("SELECT l_returnflag, l_linestatus, count(*) AS c, "
          "sum(l_quantity) AS sq, min(l_orderkey) AS mo FROM lineitem "
          "GROUP BY l_returnflag, l_linestatus "
          "ORDER BY l_returnflag, l_linestatus")
# (case, gateway kind, sql, run kwargs): "rep" part replicated, "shard"
# both sides sharded (graph flows), "shuffle" prefer_shuffle on the
# replicated fabric, "tree" merge_fanout=2, "window" credits of 2
CODEC_CASES = {
    "q6": ("rep", tpch.Q6, {}),
    "q1": ("rep", tpch.Q1, {}),
    "q14_joinfilter": ("rep", tpch.Q14, {}),
    "plain_rows": ("rep", PLAIN_Q, {}),
    "q6_chunk1": ("rep", tpch.Q6, {"chunk_rows": 1}),
    "adaptive_raw": ("rep", RAW_Q, {}),
    "tree_merge": ("tree", TREE_Q, {}),
    "backpressure": ("window", PLAIN_Q, {"chunk_rows": 1}),
    "q14_graph": ("shard", tpch.Q14, {}),
    "join_agg_graph": ("shard", JOIN_AGG, {}),
    "q1_shuffled": ("shuffle", tpch.Q1, {}),
    "group_int_shuffled": ("shuffle", GROUP_INT, {}),
}


def _gateways(node_mod, transport_mod, make_engine, tables):
    rep, nodes, _e, _t = build_fabric(node_mod, transport_mod, make_engine,
                                      TPCH_DDL, tables,
                                      replicated={"part"})
    shard, _n, _e2, _t2 = build_fabric(node_mod, transport_mod, make_engine,
                                       TPCH_DDL, tables)
    data = [1, 2, 3]
    return {"rep": rep, "shard": shard,
            "shuffle": node_mod.Gateway(nodes[0], data,
                                        replicated_tables={"part"},
                                        prefer_shuffle=True),
            "tree": node_mod.Gateway(nodes[0], data,
                                     replicated_tables={"part"},
                                     merge_fanout=2),
            "window": node_mod.Gateway(nodes[0], data,
                                       replicated_tables={"part"},
                                       window=2)}, nodes


@pytest.fixture(scope="module")
def codec_ref_rows(tcp_tables):
    """The reference's rows of every codec case: its gateways over its
    fakedist fabrics on the same arrays."""
    with reference() as (jeng, jnode, jtr, _jt):
        gws, _n = _gateways(jnode, jtr, lambda _i: jeng.Engine(),
                            tcp_tables)
        return {c: gws[kind].run(sql, **kw).rows
                for c, (kind, sql, kw) in CODEC_CASES.items()}


@pytest.fixture(scope="module")
def codec_fabric(tcp_tables):
    return _gateways(pnode, _CodecModule, port_engine, tcp_tables)


class TestFlowsThroughTheCodec:
    @pytest.mark.parametrize("case", list(CODEC_CASES))
    def test_rows_are_the_references(self, codec_fabric, codec_ref_rows,
                                     case):
        gws, _nodes = codec_fabric
        kind, sql, kw = CODEC_CASES[case]
        got = gws[kind].run(sql, **kw)
        assert_rows_close(got.rows, codec_ref_rows[case], rel=FLOAT_REL)

    def test_explain_analyze_through_the_codec(self, codec_fabric):
        gws, _nodes = codec_fabric
        res = gws["rep"].run("EXPLAIN ANALYZE " + tpch.Q1)
        text = "\n".join(r[0] for r in res.rows)
        for nid in (1, 2, 3):
            assert f"node={nid}" in text

    def test_explain_analyze_debug_through_the_codec(self, codec_fabric):
        import json
        gws, _nodes = codec_fabric
        res = gws["rep"].run("EXPLAIN ANALYZE (DEBUG) " + tpch.Q6)
        bundle = json.loads(res.rows[0][0])
        assert bundle["rows_returned"] == 1
        assert {1, 2, 3} <= {op.get("node")
                             for op in bundle["profile"]["ops"]}

    def test_traced_flow_through_the_codec(self, codec_fabric,
                                           codec_ref_rows):
        from cockroach_tpu_torch.utils import tracing
        gws, _nodes = codec_fabric
        with tracing.capture("stmt") as rec:
            got = gws["rep"].run(tpch.Q6)
        assert_rows_close(got.rows, codec_ref_rows["q6"])
        assert {s.tags["node"] for s in rec.find_all("flow")} == {1, 2, 3}

    def test_remote_error_through_the_codec(self):
        transport = CodecTransport()
        ok = Engine(device="cpu")
        tpch.load(ok, sf=0.01, rows=100)
        n1 = DistSQLNode(1, ok, transport)
        DistSQLNode(2, Engine(device="cpu"), transport)
        with pytest.raises(FlowError, match="lineitem"):
            Gateway(n1, [1, 2]).run(tpch.Q6)

    def test_cancel_ahead_of_setup_through_the_codec(self):
        transport = CodecTransport()
        data = Engine(device="cpu")
        tpch.load(data, sf=0.01, rows=50)
        gw_eng = Engine(device="cpu")
        gw_eng.execute(tpch.DDL["lineitem"])
        DistSQLNode(0, gw_eng, transport)
        node = DistSQLNode(1, data, transport)
        spec = FlowSpec("f-c", gateway=0, stage="rows",
                        sql="SELECT l_orderkey FROM lineitem", stream_id=0)
        transport.send(0, 1, ("cancel_flow", "f-c"))
        transport.send(0, 1, ("setup_flow", spec.to_wire()))
        for _ in range(10):
            if transport.deliver_all() == 0:
                break
        assert node.flows_cancelled == 1 and node.flows_run == 0


# -- the node's fabric --------------------------------------------------------
# The reference's Node cases (test_rpc_fabric.py::TestMultiNodeServer,
# test_heartbeat.py::TestNodeFabricLiveness) on the port's Node, each Node
# on the CPU: cluster settings set over pgwire on one node converge on the
# other through gossip, node addresses are gossiped, and each node's
# PeerMonitor sees the other healthy, then not once its fabric stops.

_NODE_ON_THE_CPU = tuple(
    (f"Node(NodeConfig(node_id={i}, rpc_port=0,",
     f"Node(NodeConfig(node_id={i}, rpc_port=0, device='cpu',")
    for i in (1, 2))
reference_cases("test_rpc_fabric.py", globals(),
                only=("TestMultiNodeServer",), replace=_NODE_ON_THE_CPU)
reference_cases("test_heartbeat.py", globals(),
                only=("TestNodeFabricLiveness",),
                replace=_NODE_ON_THE_CPU)
