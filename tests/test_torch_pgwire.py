"""The port's pgwire server against the JAX package's, byte for byte.

A reference ``PgServer`` runs over the reference Engine (JAX on the
CPU) and the port's ``PgServer`` over ``Engine(device="cpu")``, each
frontend of the port (``threads`` and ``reactor``) in turn. The
reference Engine loads lineitem (capped at 20,000 rows), orders and
customer at sf 0.01; its store is carried into the port's Engine, so
both scan the same row versions. The same client script goes to both
servers: TPC-H Q1, Q6 and Q3, a SELECT with NULLs in INT, FLOAT8,
DECIMAL, STRING, DATE and BOOL columns, errors by SQLSTATE (a syntax
error, an unknown table, a serialization restart), the extended
protocol with text and binary parameters and binary results, portal
suspension, COPY both ways with a malformed line, the transaction
status bytes, cleartext and SCRAM auth, TLS, and the prepared-statement
budget. RowDescription, CommandComplete and every other frame are
equal byte for byte, ErrorResponses by severity and SQLSTATE, DataRows
field by field: equal bytes, except FLOAT8 text, which agrees within
rel 1e-9 (float64 sums in different orders). BackendKeyData (a
connection counter) is left out.

The reference runs inside ``reference_modules`` (see
test_torch_groupagg_large), which lets its Pallas modules import under
newer jax releases. Every socket has a timeout of 5 s and every server
stops in a fixture's ``finally``.
"""

import math
import shutil
import socket
import struct

import pytest

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.models import tpch
from cockroach_tpu_torch.server.miniclient import MiniClient, PgError
from cockroach_tpu_torch.server.pgwire import PgServer
from cockroach_tpu_torch.storage.transfer import store_from_arrays
from tests.test_torch_engine import _store_arrays
from tests.test_torch_groupagg_large import reference_modules

ROWS = 20_000
TABLES = ("lineitem", "orders", "customer")
FRONTENDS = ("threads", "reactor")
TIMEOUT = 5.0
OID_FLOAT8, OID_INT8, OID_BOOL = 701, 20, 16


# -- raw wire helpers ---------------------------------------------------------

def frame(typ: bytes, body: bytes = b"") -> bytes:
    return typ + struct.pack("!I", len(body) + 4) + body


def startup(user: str = "root", **params) -> bytes:
    kv = {"user": user, "database": "defaultdb", **params}
    body = struct.pack("!I", 196608) + b"".join(
        k.encode() + b"\x00" + v.encode() + b"\x00"
        for k, v in kv.items()) + b"\x00"
    return struct.pack("!I", len(body) + 4) + body


def query(sql: str) -> bytes:
    return frame(b"Q", sql.encode() + b"\x00")


def parse(sql: str, name: str = "", oids=()) -> bytes:
    return frame(b"P", name.encode() + b"\x00" + sql.encode() + b"\x00"
                 + struct.pack("!H", len(oids))
                 + b"".join(struct.pack("!I", o) for o in oids))


def bind(params=(), fmts=(), rfmts=(), portal: str = "",
         stmt: str = "") -> bytes:
    """Bind raw parameter bytes (None = NULL) with format and result
    format codes."""
    b = portal.encode() + b"\x00" + stmt.encode() + b"\x00"
    b += struct.pack("!H", len(fmts)) + b"".join(
        struct.pack("!H", f) for f in fmts)
    b += struct.pack("!H", len(params))
    for p in params:
        b += (struct.pack("!i", -1) if p is None
              else struct.pack("!I", len(p)) + p)
    b += struct.pack("!H", len(rfmts)) + b"".join(
        struct.pack("!H", f) for f in rfmts)
    return frame(b"B", b)


def execute(portal: str = "", max_rows: int = 0) -> bytes:
    return frame(b"E", portal.encode() + b"\x00"
                 + struct.pack("!i", max_rows))


SYNC = frame(b"S")
TERMINATE = frame(b"X")


def split_frames(data: bytes) -> list:
    out, off = [], 0
    while off < len(data):
        typ = data[off:off + 1]
        (ln,) = struct.unpack_from("!I", data, off + 1)
        out.append((typ, data[off + 5:off + 1 + ln]))
        off += 1 + ln
    return out


class Wire:
    """One raw connection: sends scripted bytes and returns the frames
    that come back up to the n-th ReadyForQuery (or the close)."""

    def __init__(self, addr, start: bytes | None = None):
        self.sock = socket.create_connection(addr, timeout=TIMEOUT)
        self.buf = b""
        self.hello = self.send(start or startup())

    def _frame(self):
        while True:
            if len(self.buf) >= 5:
                (ln,) = struct.unpack_from("!I", self.buf, 1)
                if len(self.buf) >= 1 + ln:
                    typ, body = self.buf[:1], self.buf[5:1 + ln]
                    self.buf = self.buf[1 + ln:]
                    return typ, body
            b = self.sock.recv(1 << 16)
            if not b:
                return None
            self.buf += b

    def send(self, payload: bytes, ready: int = 1) -> list:
        self.sock.sendall(payload)
        out = []
        while ready:
            f = self._frame()
            if f is None:
                break
            if f[0] == b"Z":
                ready -= 1
            if f[0] != b"K":
                out.append(f)
        return out

    def close(self):
        try:
            self.sock.sendall(TERMINATE)
        except OSError:
            pass
        self.sock.close()


def exchange(addr, payload: bytes, ready: int = 1,
             start: bytes | None = None) -> list:
    w = Wire(addr, start)
    try:
        return w.hello + w.send(payload, ready)
    finally:
        w.close()


def err_fields(body: bytes) -> dict:
    out, i = {}, 0
    while i < len(body) and body[i] != 0:
        j = body.index(0, i + 1)
        out[chr(body[i])] = body[i + 1:j].decode()
        i = j + 1
    return out


def row_desc(body: bytes) -> list:
    """[(oid, format)] of a RowDescription."""
    (n,) = struct.unpack_from("!H", body, 0)
    off, out = 2, []
    for _ in range(n):
        off = body.index(0, off) + 1
        _t, _a, oid, _sz, _m, fmt = struct.unpack_from("!IhIhih", body, off)
        out.append((oid, fmt))
        off += 18
    return out


def data_fields(body: bytes) -> list:
    (n,) = struct.unpack_from("!H", body, 0)
    off, out = 2, []
    for _ in range(n):
        (ln,) = struct.unpack_from("!i", body, off)
        off += 4
        if ln < 0:
            out.append(None)
        else:
            out.append(body[off:off + ln])
            off += ln
    return out


def assert_same(got: list, want: list) -> None:
    """Frame-by-frame equality under the rules of the module doc."""
    assert [t for t, _ in got] == [t for t, _ in want], (
        [t for t, _ in got], [t for t, _ in want])
    cols = None
    for (t, g), (_, w) in zip(got, want):
        if t == b"T":
            assert g == w
            cols = row_desc(g)
        elif t == b"D":
            gf, wf = data_fields(g), data_fields(w)
            assert len(gf) == len(wf)
            for i, (a, b) in enumerate(zip(gf, wf)):
                oid, fmt = cols[i] if cols else (0, 0)
                if oid == OID_FLOAT8 and a is not None and b is not None:
                    x, y = ((struct.unpack("!d", a)[0],
                             struct.unpack("!d", b)[0]) if fmt
                            else (float(a), float(b)))
                    assert math.isclose(x, y, rel_tol=1e-9), (i, a, b)
                else:
                    assert a == b, (i, a, b)
        elif t == b"E":
            ge, we = err_fields(g), err_fields(w)
            assert (ge["S"], ge["C"]) == (we["S"], we["C"]), (ge, we)
        else:
            assert g == w, (t, g, w)


# -- the two servers ------------------------------------------------------------

@pytest.fixture(scope="module")
def servers():
    """{"ref": reference server, "threads"/"reactor": the port's, and
    the engines and reference pgwire module}."""
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.models.tpch",
                           "cockroach_tpu.server.pgwire") as (
            jeng, jtpch, jpg):
        ref_eng = jeng.Engine()
        started = []
        try:
            jtpch.load(ref_eng, sf=0.01, rows=ROWS, tables=TABLES)
            port_eng = Engine(device="cpu", store=store_from_arrays(
                _store_arrays(ref_eng.store, jtpch.DDL)))
            # the reference compiles each new plan shape on first use:
            # warm the heavy ones here, outside the 5 s socket timeouts
            warm = ref_eng.session()
            warm.vars.set("distsql", "off")
            for q in (tpch.Q1, tpch.Q6, tpch.Q3, Q6_BOUND):
                ref_eng.execute(q, warm)
                port_eng.execute(q)
            out = {"ref_engine": ref_eng, "port_engine": port_eng,
                   "jpg": jpg}
            out["ref"] = jpg.PgServer(ref_eng, frontend="threads").start()
            started.append(out["ref"])
            for fe in FRONTENDS:
                out[fe] = PgServer(port_eng, frontend=fe).start()
                started.append(out[fe])
            yield out
        finally:
            for s in started:
                s.stop()
            ref_eng.close()


def both(servers, frontend, payload, ready=1, start=None):
    want = exchange(servers["ref"].addr, payload, ready, start)
    got = exchange(servers[frontend].addr, payload, ready, start)
    assert_same(got, want)
    return got


def _errors(frames) -> list:
    return [err_fields(b)["C"] for t, b in frames if t == b"E"]


# -- simple protocol ------------------------------------------------------------

@pytest.mark.parametrize("frontend", FRONTENDS)
@pytest.mark.parametrize("q", ["Q1", "Q6", "Q3"])
def test_tpch_query_over_the_wire(servers, frontend, q):
    got = both(servers, frontend,
               query("SET distsql = off") + query(getattr(tpch, q)), 2)
    rows = [b for t, b in got if t == b"D"]
    assert len(rows) == {"Q1": 4, "Q6": 1, "Q3": 10}[q]


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_nulls_in_every_type(servers, frontend):
    t = f"nt_{frontend}"
    got = both(servers, frontend, query(
        f"CREATE TABLE {t} (k INT PRIMARY KEY, i INT, f FLOAT8, "
        f"d DECIMAL(10,2), s STRING, dt DATE, b BOOL); "
        f"INSERT INTO {t} VALUES "
        f"(1, NULL, NULL, NULL, NULL, NULL, NULL), "
        f"(2, -7, 2.5, 12.25, 'x y', date '1998-12-01', true), "
        f"(3, 0, -0.125, -3.10, '', date '1970-01-01', false), "
        f"(4, NULL, 1e300, NULL, 'tab\there', NULL, NULL); "
        f"SELECT k, i, f, d, s, dt, b FROM {t} ORDER BY k; "
        f"SELECT i, f, d, s, dt, b FROM {t} WHERE k = 1"))
    desc = [row_desc(b) for t_, b in got if t_ == b"T"]
    assert [o for o, _ in desc[0]] == [20, 20, 701, 701, 25, 1082, 16]
    # a column whose every value is NULL is typed text
    assert [o for o, _ in desc[1]] == [25] * 6


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_multi_statement_and_empty_query(servers, frontend):
    got = both(servers, frontend,
               query("SELECT 1 + 1; SELECT 'a' AS s, 2.5 * 2 AS x, "
                                "1 < 2 AS b") + query("  ;  "), 2)
    assert (b"I", b"") in got


@pytest.mark.parametrize("frontend", FRONTENDS)
@pytest.mark.parametrize("sql,code", [
    ("SELEC 1", "XX000"),
    ("SELECT * FROM no_such_table", "XX000"),
    ("SELECT l_bogus FROM lineitem", "XX000"),
])
def test_error_sqlstate(servers, frontend, sql, code):
    got = both(servers, frontend, query(sql) + query("SELECT 2 + 3"), 2)
    assert _errors(got) == [code]
    assert (b"D", b"\x00\x01\x00\x00\x00\x015") in got   # session lives


def _restart_script(addr, t):
    """A read refresh that fails at COMMIT: 40001. Session a reads t_r
    in a txn; b writes t_r and reads t_w after it; a's write to t_w is
    pushed above b's read, so its commit must refresh t_r, and fails."""
    a, b = Wire(addr), Wire(addr)
    try:
        out = a.send(query(f"CREATE TABLE {t}_r (k INT PRIMARY KEY, v INT); "
                           f"CREATE TABLE {t}_w (k INT PRIMARY KEY, v INT); "
                           f"INSERT INTO {t}_r VALUES (1, 10)"))
        out += a.send(query("BEGIN"))
        out += a.send(query(f"SELECT count(*) FROM {t}_r"))
        out += b.send(query(f"INSERT INTO {t}_r VALUES (2, 20)"))
        out += b.send(query(f"SELECT count(*) FROM {t}_w"))
        out += a.send(query(f"INSERT INTO {t}_w VALUES (3, 30)"))
        out += a.send(query("COMMIT"))
        out += a.send(query(f"SELECT k, v FROM {t}_r ORDER BY k"))
        out += a.send(query(f"SELECT count(*) FROM {t}_w"))
        return out
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_serialization_restart_is_40001(servers, frontend):
    t = f"rs_{frontend}"
    want = _restart_script(servers["ref"].addr, t)
    got = _restart_script(servers[frontend].addr, t)
    assert_same(got, want)
    assert _errors(got) == ["40001"]


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_txn_status_bytes(servers, frontend):
    t = f"tx_{frontend}"
    got = both(servers, frontend,
               query(f"CREATE TABLE {t} (k INT PRIMARY KEY)")
               + query("BEGIN") + query(f"INSERT INTO {t} VALUES (1)")
               + query("ROLLBACK") + query("BEGIN")
               + query(f"SELECT bogus FROM {t}")
               + query(f"INSERT INTO {t} VALUES (2)")
               + query("ROLLBACK") + query("BEGIN")
               + query(f"INSERT INTO {t} VALUES (3)") + query("COMMIT")
               + query(f"SELECT count(*) FROM {t}"), 12)
    status = [b for t_, b in got if t_ == b"Z"]
    assert status == [b"I", b"I", b"T", b"T", b"I", b"T", b"E", b"E",
                      b"I", b"T", b"T", b"I", b"I"]
    assert _errors(got) == ["XX000", "25P02"]


# -- extended protocol ----------------------------------------------------------

Q6P = ("SELECT sum(l_extendedprice * l_discount) AS revenue FROM lineitem "
       "WHERE l_shipdate >= date $1 AND l_shipdate < date $2 "
       "AND l_discount BETWEEN $3 AND $4 AND l_quantity < $5")
# Q6P as the server binds the tests' parameters (text or binary)
Q6_BOUND = (Q6P.replace("$1", "'1994-01-01'").replace("$2", "'1995-01-01'")
            .replace("$3", "(0.05)").replace("$4", "(0.07)")
            .replace("$5", "(24)"))


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_extended_text_parameters(servers, frontend):
    params = [b"1994-01-01", b"1995-01-01", b"0.05", b"0.07", b"24"]
    got = both(servers, frontend,
               parse(Q6P, oids=(25, 25, 701, 701, 20))
               + frame(b"D", b"S\x00") + bind(params) + execute() + SYNC)
    types = [t for t, _ in got]
    assert types[types.index(b"1"):] == [b"1", b"t", b"n", b"2", b"T", b"D",
                                         b"C", b"Z"]


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_extended_binary_parameters_and_results(servers, frontend):
    t = f"bx_{frontend}"
    setup = query(f"CREATE TABLE {t} (k INT PRIMARY KEY, f FLOAT8, "
                  f"b BOOL, s STRING, dt DATE); INSERT INTO {t} VALUES "
                  f"(1, 1.5, true, 'one', date '1996-02-29'), "
                  f"(-2, -2.25, false, NULL, NULL), "
                  f"(3, NULL, NULL, 'three', date '1970-01-01')")
    sel = parse(f"SELECT k, f, b, s, dt FROM {t} WHERE k >= $1 "
                f"AND f IS NOT NULL OR k = $2 OR b = $3 ORDER BY k",
                oids=(OID_INT8, OID_INT8, OID_BOOL))
    got = both(servers, frontend, setup + sel
               + bind([struct.pack("!q", -5), struct.pack("!q", 3),
                       b"\x01"], fmts=(1,), rfmts=(1,))
               + execute() + SYNC
               + parse(f"SELECT f * $1 AS g FROM {t} ORDER BY k",
                       oids=(OID_FLOAT8,))
               + bind([struct.pack("!d", 0.5)], fmts=(1,), rfmts=(0,))
               + execute() + SYNC, 3)
    descs = [row_desc(b) for t_, b in got if t_ == b"T"]
    assert descs[0] == [(20, 1), (701, 1), (16, 1), (25, 1), (1082, 1)]


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_portal_suspension(servers, frontend):
    sql = "SELECT o_orderkey FROM orders WHERE o_orderkey < 40 ORDER BY 1"
    got = both(servers, frontend,
               parse(sql, "s1") + bind(portal="p1", stmt="s1")
               + execute("p1", 3) + execute("p1", 3) + execute("p1", 0)
               + execute("p1", 0) + frame(b"C", b"Pp1\x00")
               + frame(b"C", b"Ss1\x00") + SYNC)
    types = [t for t, _ in got]
    assert types.count(b"s") == 2
    assert types.count(b"C") == 2 and types.count(b"3") == 2


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_extended_error_skips_until_sync(servers, frontend):
    got = both(servers, frontend,
               parse("SELECT nope FROM lineitem") + bind() + execute()
               + SYNC + parse("SELECT 7 * 6") + bind() + execute() + SYNC
               + bind(stmt="missing") + SYNC, 3)
    assert _errors(got) == ["XX000", "XX000"]


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_prepared_statement_budget_53400(servers, frontend):
    for k in ("ref_engine", "port_engine"):
        servers[k].settings.set("server.prepared_statement_budget", 3)
    try:
        got = both(servers, frontend, b"".join(
            parse("SELECT 1", f"s{i}") for i in range(4)) + SYNC)
    finally:
        for k in ("ref_engine", "port_engine"):
            servers[k].settings.set("server.prepared_statement_budget",
                                    256)
    assert [t for t, _ in got].count(b"1") == 3
    assert _errors(got) == ["53400"]


# -- COPY -----------------------------------------------------------------------

@pytest.mark.parametrize("frontend", FRONTENDS)
def test_copy_in_and_out(servers, frontend):
    t = f"cp_{frontend}"
    data = (b"1\t2.5\tone\n2\t\\N\ttab\\there\n"
            b"3\t-1e3\tback\\\\slash\n\\.\n")
    got = both(servers, frontend,
               query(f"CREATE TABLE {t} (k INT PRIMARY KEY, f FLOAT8, "
                     f"s STRING)")
               + query(f"COPY {t} FROM STDIN")
               + frame(b"d", data[:13]) + frame(b"d", data[13:])
               + frame(b"c")
               + query(f"COPY {t} TO STDOUT")
               + query(f"COPY {t} (s, k) TO STDOUT"), 4)
    tags = [b for t_, b in got if t_ == b"C"]
    assert tags[1:] == [b"COPY 3\x00", b"COPY 3\x00", b"COPY 3\x00"]


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_copy_malformed_line_22p02(servers, frontend):
    t = f"cb_{frontend}"
    got = both(servers, frontend,
               query(f"CREATE TABLE {t} (k INT PRIMARY KEY, v INT)")
               + query(f"COPY {t} FROM STDIN")
               + frame(b"d", b"1\t10\n2\tNULL\n3\t30\n") + frame(b"c")
               + query(f"SELECT count(*) FROM {t}")
               + query(f"COPY {t} FROM STDIN")
               + frame(b"f", b"client gave up\x00"), 4)
    assert _errors(got) == ["22P02", "57014"]


# -- authentication and TLS -------------------------------------------------------

@pytest.fixture(scope="module")
def certs_dir(tmp_path_factory):
    if shutil.which("openssl") is None:
        pytest.skip("openssl is not installed")
    from cockroach_tpu_torch.cli import main
    d = str(tmp_path_factory.mktemp("certs"))
    assert main(["cert", "--certs-dir", d, "--host", "127.0.0.1"]) == 0
    return d


@pytest.fixture()
def auth_pair(servers, request):
    """A reference and a port server with a password gate; the param
    is (frontend, auth method, TLS)."""
    frontend, method, tls = request.param
    certs = request.getfixturevalue("certs_dir") if tls else None
    auth = {"root": "hunter2", "alice": "wonder"}
    ref = servers["jpg"].PgServer(servers["ref_engine"], auth=auth,
                                  auth_method=method, certs_dir=certs,
                                  frontend="threads")
    port = PgServer(servers["port_engine"], auth=auth, auth_method=method,
                    certs_dir=certs, frontend=frontend)
    ref.start()
    try:
        port.start()
        try:
            yield ref, port, tls
        finally:
            port.stop()
    finally:
        ref.stop()


AUTH_CASES = [(fe, m, tls) for fe in FRONTENDS
              for m, tls in (("cleartext", False), ("scram-sha-256", False),
                             ("scram-sha-256", True), ("cleartext", True))]


@pytest.mark.parametrize("auth_pair", AUTH_CASES, indirect=True,
                         ids=lambda c: "-".join(map(str, c)))
def test_auth_outcomes_match(auth_pair):
    ref, port, tls = auth_pair

    def outcome(addr, user, pw):
        try:
            c = MiniClient(*addr, user=user, password=pw, tls=tls,
                           timeout=TIMEOUT)
        except PgError as e:
            return ("rejected", e.sqlstate)
        try:
            return ("ok", c.query("SELECT 20 + 22 AS x"),
                    c.query_binary("SELECT $1 + 1 AS y", [41]))
        finally:
            c.close()

    for user, pw in (("root", "hunter2"), ("alice", "wonder"),
                     ("root", "wrong"), ("mallory", "hunter2")):
        want = outcome(ref.addr, user, pw)
        assert outcome(port.addr, user, pw) == want
        assert want[0] == ("ok" if pw in ("hunter2", "wonder")
                           and user != "mallory" else "rejected")


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_cleartext_handshake_bytes(servers, frontend):
    """The cleartext exchange is deterministic: its frames are equal."""
    auth = {"root": "hunter2"}
    ref = servers["jpg"].PgServer(servers["ref_engine"], auth=auth,
                                  frontend="threads").start()
    try:
        port = PgServer(servers["port_engine"], auth=auth,
                        frontend=frontend).start()
        try:
            pw = frame(b"p", b"hunter2\x00")
            for payload in (pw + query("SELECT 1"),
                            frame(b"p", b"nope\x00")):
                want = _auth_exchange(ref.addr, payload)
                got = _auth_exchange(port.addr, payload)
                assert_same(got, want)
        finally:
            port.stop()
    finally:
        ref.stop()


def _auth_exchange(addr, payload):
    sock = socket.create_connection(addr, timeout=TIMEOUT)
    try:
        sock.sendall(startup() + payload + TERMINATE)
        data = b""
        while True:
            b = sock.recv(1 << 16)
            if not b:
                break
            data += b
    finally:
        sock.close()
    return [f for f in split_frames(data) if f[0] != b"K"]


# -- what clients and operators send: set operations, SHOW, EXPLAIN -----------

OPERATOR_SETUP = (
    "CREATE TABLE w (k INT8 NOT NULL PRIMARY KEY, s STRING, "
    "d DECIMAL(8,2))",
    "INSERT INTO w VALUES (1, 'a', 1.50), (2, 'b', NULL), (3, 'a', 2.25)",
)
OPERATOR_SQL = {
    "union": "SELECT k FROM w UNION SELECT k + 1 FROM w ORDER BY 1",
    "except_strings": ("SELECT s FROM w EXCEPT SELECT s FROM w "
                       "WHERE k = 2 ORDER BY s"),
    "show_tables": "SHOW TABLES",
    "show_var": "SHOW hash_group_capacity",
    "show_setting": "SHOW sql.exec.hbm_budget_bytes",
    "show_columns": "SHOW COLUMNS FROM w",
    "show_create": "SHOW CREATE TABLE w",
    "explain": "EXPLAIN SELECT s, count(*) FROM w GROUP BY s",
    "explain_point": "EXPLAIN SELECT s FROM w WHERE k = 2",
    "series": "SELECT generate_series(1, 4) AS g",
}


@pytest.fixture(scope="module")
def operator_servers():
    """A reference server and the port's two frontends over engines that
    made the same table by the same SQL (their catalogs hold only it)."""
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.server.pgwire") as (jeng, jpg):
        ref_eng = jeng.Engine()
        port_eng = Engine(device="cpu")
        started = []
        try:
            for stmt in OPERATOR_SETUP:
                ref_eng.execute(stmt)
                port_eng.execute(stmt)
            warm = ref_eng.session()
            warm.vars.set("distsql", "off")
            for sql in OPERATOR_SQL.values():
                ref_eng.execute(sql, warm)
            out = {"ref": jpg.PgServer(ref_eng, frontend="threads").start()}
            started.append(out["ref"])
            for fe in FRONTENDS:
                out[fe] = PgServer(port_eng, frontend=fe).start()
                started.append(out[fe])
            yield out
        finally:
            for s in started:
                s.stop()
            ref_eng.close()


@pytest.mark.parametrize("frontend", FRONTENDS)
@pytest.mark.parametrize("name", list(OPERATOR_SQL))
def test_operator_statements_over_the_wire(operator_servers, frontend,
                                           name):
    got = both(operator_servers, frontend,
               query("SET distsql = off") + query(OPERATOR_SQL[name]), 2)
    assert [t for t, _ in got if t == b"E"] == []
    assert any(t == b"D" for t, _ in got)
