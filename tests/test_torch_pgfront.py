"""The port's reactor front end (server/pgfront.py) against its thread
front end, and the reactor's session hygiene.

1. **Parity**: both front ends drive the same ``_Conn`` handlers, so
   every reply stream is byte-identical (BackendKeyData, a connection
   counter, left out): simple queries, errors, the extended protocol
   with skip-until-Sync, SSL denial, a cancel packet and an unsupported
   protocol version.
2. **Parked sessions hold no thread**: 150 idle sessions on the reactor
   add no thread past the first 30, and none owns a worker.
3. **Hygiene**: the startup deadline closes a silent connection, the
   idle timeout retires an idle one but spares an open transaction, an
   RST teardown leaks no thread.
4. **The switch interval**: ``sql.exec.switch_interval`` sets
   ``sys.getswitchinterval()`` through the setting's hook, and 0
   restores the interpreter default.
5. **Sessions and admission**: 16 sessions over each front end run
   point statements on the OLTP lane beside full-path aggregates with
   admission slots at their default of 16; every statement finishes and
   the table holds what the sessions wrote.

Every socket has a timeout of 5 s or less, every server stops in a
fixture, and the sub-second deadlines keep the file short.
"""

import socket
import struct
import sys
import threading
import time

import pytest

from cockroach_tpu_torch.cli import PgClient
from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.server import pgfront
from cockroach_tpu_torch.server.pgwire import PgServer
from tests.test_torch_pgwire import (SYNC, TERMINATE, bind, execute, parse,
                                     query, split_frames, startup)

TIMEOUT = 5.0


@pytest.fixture(scope="module")
def engine():
    e = Engine(device="cpu")
    e.execute("CREATE TABLE par (k INT8 NOT NULL PRIMARY KEY, v INT8)")
    e.execute("INSERT INTO par VALUES " + ", ".join(
        f"({i}, {i * 10})" for i in range(64)))
    return e


@pytest.fixture(scope="module")
def servers(engine):
    out = {}
    try:
        for fe in ("reactor", "threads"):
            out[fe] = PgServer(engine, frontend=fe).start()
        yield out
    finally:
        for s in out.values():
            s.stop()


@pytest.fixture()
def settings(engine):
    """The engine's settings, put back to their defaults afterwards."""
    names = ("server.startup_deadline_seconds",
             "server.idle_session_timeout", "sql.exec.switch_interval")
    saved = {n: engine.settings.get(n) for n in names}
    try:
        yield engine.settings
    finally:
        for n, v in saved.items():
            engine.settings.set(n, v)


def _recv_all(sock) -> bytes:
    sock.settimeout(TIMEOUT)
    chunks = []
    while True:
        try:
            b = sock.recv(1 << 16)
        except (socket.timeout, TimeoutError):
            raise AssertionError("server did not close the connection")
        if not b:
            return b"".join(chunks)
        chunks.append(b)


def _exchange(addr, payload: bytes, prelude: bytes = b"") -> list:
    """Startup (after an optional prelude packet), the payload, then
    every frame until the server closes; BackendKeyData dropped."""
    sock = socket.create_connection(addr, timeout=TIMEOUT)
    try:
        try:
            sock.sendall(prelude + startup() + payload)
        except OSError:
            pass            # the server may close first (FATAL replies)
        data = _recv_all(sock)
    finally:
        sock.close()
    if data[:1] == b"N":    # SSL denied: one bare byte, not a frame
        return [(b"N*", b"")] + [f for f in split_frames(data[1:])
                                 if f[0] != b"K"]
    return [f for f in split_frames(data) if f[0] != b"K"]


PAYLOADS = {
    "simple": query("SELECT k, v FROM par WHERE k < 3 ORDER BY k")
    + query("SELECT count(*) FROM par") + TERMINATE,
    "multi_and_error": query("SELECT 1; SELECT nope FROM par; SELECT 2")
    + query("SELECT v FROM par WHERE k = 7") + TERMINATE,
    "extended_skip_until_sync": parse("SELECT nope FROM par") + bind()
    + execute() + SYNC + parse("SELECT v FROM par WHERE k = $1",
                               oids=(20,))
    + bind([b"5"]) + execute() + SYNC + TERMINATE,
    "portal": parse("SELECT k FROM par ORDER BY k", "s")
    + bind(portal="p", stmt="s") + execute("p", 5) + execute("p", 100)
    + SYNC + TERMINATE,
}


@pytest.mark.parametrize("name", sorted(PAYLOADS))
def test_frontends_reply_identically(servers, name):
    a = _exchange(servers["reactor"].addr, PAYLOADS[name])
    b = _exchange(servers["threads"].addr, PAYLOADS[name])
    assert a == b
    assert a[-1][0] in (b"Z", b"C")


def test_ssl_denied_then_cleartext(servers):
    ssl_req = struct.pack("!II", 8, 80877103)
    payload = query("SELECT 3") + TERMINATE
    a = _exchange(servers["reactor"].addr, payload, ssl_req)
    b = _exchange(servers["threads"].addr, payload, ssl_req)
    assert a == b and a[0] == (b"N*", b"")


def test_cancel_request_closes_silently(servers):
    cancel = struct.pack("!IIII", 16, 80877102, 1, 0)
    for fe in ("reactor", "threads"):
        sock = socket.create_connection(servers[fe].addr, timeout=TIMEOUT)
        try:
            sock.sendall(cancel)
            assert _recv_all(sock) == b""
        finally:
            sock.close()


def test_unsupported_protocol_is_fatal(servers):
    body = struct.pack("!I", 2 << 16) + b"user\x00root\x00\x00"
    pkt = struct.pack("!I", len(body) + 4) + body
    out = []
    for fe in ("reactor", "threads"):
        sock = socket.create_connection(servers[fe].addr, timeout=TIMEOUT)
        try:
            sock.sendall(pkt)
            out.append(split_frames(_recv_all(sock)))
        finally:
            sock.close()
    assert out[0] == out[1]
    assert out[0][0][0] == b"E" and b"0A000" in out[0][0][1]


def _connect_idle(addr) -> socket.socket:
    """A session that completed startup and now sits idle."""
    sock = socket.create_connection(addr, timeout=TIMEOUT)
    sock.sendall(startup())
    buf = b""
    while True:
        off = 0
        while off + 5 <= len(buf):
            (ln,) = struct.unpack_from("!I", buf, off + 1)
            if off + 1 + ln > len(buf):
                break
            if buf[off:off + 1] == b"Z":
                return sock
            off += 1 + ln
        buf = buf[off:]
        b = sock.recv(4096)
        if not b:
            raise ConnectionError("server closed during startup")
        buf += b


def _wait(pred, timeout=TIMEOUT) -> bool:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


def test_parked_sessions_hold_no_thread(servers):
    impl = servers["reactor"]._impl
    pool = impl._pool

    def besides_pool() -> int:
        # the worker pool starts its threads lazily, up to its bound,
        # as bursts of startups arrive: those are not a session's own
        return threading.active_count() - len(pool._threads)
    base = len(impl._sessions)
    socks = []
    try:
        for _ in range(30):
            socks.append(_connect_idle(servers["reactor"].addr))
        assert _wait(lambda: impl._count_active() == 0)
        threads_at_30 = threading.active_count()
        others_at_30 = besides_pool()
        for _ in range(120):
            socks.append(_connect_idle(servers["reactor"].addr))
        assert _wait(lambda: impl._count_active() == 0)
        assert len(impl._sessions) == base + 150
        # 120 more sessions add no thread but the bounded pool's
        assert besides_pool() <= others_at_30 + 2
        assert len(pool._threads) <= pool._max_workers
        # and they still answer
        c = socks[-1]
        c.sendall(query("SELECT 42"))
        assert b"42" in c.recv(4096)
    finally:
        for s in socks:
            s.close()
    assert _wait(lambda: len(impl._sessions) <= base)
    # 150 teardowns ran on the bounded pool: its size caps the threads
    assert threading.active_count() <= (threads_at_30 + 2
                                        + impl._pool._max_workers)


def test_startup_deadline_closes_a_silent_connection(servers, settings):
    settings.set("server.startup_deadline_seconds", 0.3)
    sock = socket.create_connection(servers["reactor"].addr,
                                    timeout=TIMEOUT)
    try:
        t0 = time.monotonic()
        assert _recv_all(sock) == b""
        assert time.monotonic() - t0 < 3.0
    finally:
        sock.close()


@pytest.mark.parametrize("frontend", ["reactor", "threads"])
def test_idle_timeout_retires_a_session(servers, settings, frontend):
    settings.set("server.idle_session_timeout", 0.3)
    sock = _connect_idle(servers[frontend].addr)
    try:
        assert _recv_all(sock) == b""
    finally:
        sock.close()


@pytest.mark.parametrize("frontend", ["reactor", "threads"])
def test_idle_timeout_spares_an_open_transaction(servers, settings,
                                                 frontend):
    c = PgClient(*servers[frontend].addr, timeout=TIMEOUT)
    try:
        settings.set("server.idle_session_timeout", 0.3)
        c.query("BEGIN")
        time.sleep(1.0)
        assert c.query("SELECT v FROM par WHERE k = 4")[1] == [("40",)]
        c.query("ROLLBACK")
        assert c.txn_status == b"I"
    finally:
        settings.set("server.idle_session_timeout", 0.0)
        c.close()


def test_rst_teardown_leaks_nothing(servers):
    impl = servers["reactor"]._impl
    base_threads = threading.active_count()
    for _ in range(10):
        sock = _connect_idle(servers["reactor"].addr)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
        sock.close()
    assert _wait(lambda: all(s.closed for s in
                             list(impl._sessions.values())))
    assert threading.active_count() <= base_threads + 2


def test_switch_interval_sets_and_restores(servers, settings):
    default = pgfront._DEFAULT_SWITCH_INTERVAL
    try:
        settings.set("sql.exec.switch_interval", 0.001)
        assert sys.getswitchinterval() == pytest.approx(0.001)
        settings.set("sql.exec.switch_interval", 0.0)
        assert sys.getswitchinterval() == pytest.approx(default)
    finally:
        sys.setswitchinterval(default)


@pytest.mark.parametrize("frontend", ["reactor", "threads"])
def test_sixteen_sessions_lane_and_full_path(engine, servers, frontend):
    """16 sessions, admission at its 16 slots: the lane's batch windows
    and the full-path aggregates all finish; every session's own key
    ends at the last value it wrote."""
    assert engine.admission.slots == 16
    table = f"ses_{frontend}"
    c = PgClient(*servers[frontend].addr, timeout=TIMEOUT)
    c.query(f"CREATE TABLE {table} (k INT8 NOT NULL PRIMARY KEY, v INT8)")
    c.query(f"INSERT INTO {table} VALUES " + ", ".join(
        f"({i}, 0)" for i in range(16)))
    c.close()
    errs, last = [], {}

    def session(i):
        try:
            cl = PgClient(*servers[frontend].addr, timeout=TIMEOUT)
            try:
                for j in range(1, 21):
                    cl.query(f"UPDATE {table} SET v = {j} WHERE k = {i}")
                    _, rows, _ = cl.query(
                        f"SELECT v FROM {table} WHERE k = {i}")
                    assert rows == [(str(j),)]
                    if j % 5 == 0:
                        cl.query(f"SELECT sum(v) FROM {table}")
                last[i] = j
            finally:
                cl.close()
        except Exception as e:  # pragma: no cover - reported below
            errs.append(e)

    threads = [threading.Thread(target=session, args=(i,))
               for i in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errs and len(last) == 16
    assert engine.execute(f"SELECT sum(v) FROM {table}").rows == [(320,)]
    assert engine.admission.depth() == 0


def test_chip_smoke_phase13_on_the_cpu():
    """chip_smoke.py's phase 13 at a small size on a CPU engine: every
    check it makes on the card but the kernel-vs-plain ones (the kernel
    wrappers' plain versions count the launches here)."""
    import numpy as np

    import chip_smoke
    from cockroach_tpu_torch.models import tpch
    eng = Engine(device="cpu")
    tpch.load(eng, sf=0.01, rows=20_000, tables=("lineitem", "part"),
              encoded=True)
    tpch.load(eng, sf=0.01, tables=("orders", "customer"))
    li = tpch.gen_lineitem(0.01, rows=20_000, encoded=True)
    li["l_returnflag"] = np.asarray(tpch.RF_VALUES)[li["l_returnflag"]]
    li["l_linestatus"] = np.asarray(tpch.LS_VALUES)[li["l_linestatus"]]
    eng.execute(chip_smoke.USERTABLE_DDL)
    records = 5_000
    i = np.arange(records, dtype=np.int64)
    eng.store.insert_columns("usertable", {
        "ycsb_key": i, "field0": i * 7 % 1000, "field1": i * 13 % 1000},
        eng.clock.now())
    default = sys.getswitchinterval()
    out = chip_smoke.frontdoor_phase(
        eng, li, tpch.gen_orders(0.01), tpch.gen_customer(0.01),
        tpch.gen_part(0.01), records, ops=320, clients=8, parked=40,
        side_ops=160, q1_runs=1)
    assert sys.getswitchinterval() == default
    for fe in ("threads", "reactor"):
        q = out["queries"][fe]
        assert (q["q1"]["groupagg_large"], q["q1f"]["groupagg"]) == (1, 1)
        assert (q["q1"]["execute_groupagg_large"],
                q["q1f"]["execute_groupagg"]) == (1, 1)
        assert q["q6_binary_params"]["rows"] == 1
    assert set(out["ycsb"]) == {f"{m}_{fe}" for m in "BE" for fe in (
        "threads", "reactor", "reactor_si1ms")}
    assert out["parked"]["threads_parked"] <= (
        out["parked"]["threads_before"] + out["parked"]["pool_workers"])
    adm = out["admission"]
    assert adm["tenant_slots_2"]["slot_waits"] >= 1
    assert adm["tenant_slots_0"]["slot_waits"] == 0
    quiet = [adm[f"tenant_slots_{c}"]["quiet_point"]["n"] for c in (0, 2)]
    assert min(quiet) >= 4
    assert adm["tenants"]["noisy"]["statements"] == 16
    assert adm["tenants"]["quiet"]["statements"] == sum(quiet)
    # the launches counted: Q1 over the wire and through execute() and
    # 5 timed Q1s a frontend, 21 timed Q1s through execute() each way
    # against the parse, Q1 beside YCSB-B both ways, 16 noisy Q1s (and
    # whatever Q3 launches)
    assert out["kernel_launches"]["groupagg_large"] >= \
        2 * (2 + 5) + 42 + 2 + 16
    assert out["beside_q1"]["q1"]["groupagg_large"] == 1


def test_wire_sessions_stream_at_once():
    """Four wire sessions run streamed Q1, Q6 and Q14 at once (a 1 MiB
    budget, pages of 4,096 rows, the prefetch worker on): every result
    equals the resident run's, and pages were streamed."""
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.server.miniclient import MiniClient
    eng = Engine(device="cpu")
    tpch.load(eng, sf=0.01, rows=20_000, tables=("lineitem", "part"),
              chunk_rows=4096)
    queries = (tpch.Q1, tpch.Q6, tpch.Q14)
    want = [eng.execute(q).rows for q in queries]
    eng.settings.set("sql.exec.hbm_budget_bytes", 1 << 20)
    s = eng.session()
    s.vars.set("streaming_page_rows", 4096)
    assert {eng.stream_verdict(q, s) for q in queries} == {"stream-scan"}
    for q in queries:            # compiled once, outside the timeouts
        eng.execute(q, s)
    pages0 = eng.metrics.snapshot().get("exec.stream.pages", 0)
    srv = PgServer(eng, frontend="reactor").start()
    errs, done = [], []

    def session(i):
        try:
            c = MiniClient(*srv.addr, timeout=TIMEOUT)
            try:
                c.query("SET streaming_page_rows = 4096")
                for j in range(3):
                    k = (i + j) % 3
                    rows = c.query(queries[k])[1]
                    assert len(rows) == len(want[k])
                    for g, w in zip(rows, want[k]):
                        assert len(g) == len(w)
                        for x, y in zip(g, w):
                            assert x == pytest.approx(y, rel=1e-9) \
                                if isinstance(y, float) else x == y
                done.append(i)
            finally:
                c.close()
        except Exception as e:  # pragma: no cover - reported below
            errs.append(e)

    try:
        ths = [threading.Thread(target=session, args=(i,))
               for i in range(4)]
        for t in ths:
            t.start()
        for t in ths:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ths)
    finally:
        srv.stop()
    assert not errs and sorted(done) == [0, 1, 2, 3]
    assert eng.metrics.snapshot()["exec.stream.pages"] - pages0 >= 12 * 2
