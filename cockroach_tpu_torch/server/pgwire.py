"""PostgreSQL wire protocol v3: the SQL front door.

The port of cockroach_tpu/server/pgwire.py (the reference's pgwire
server, pkg/sql/pgwire/server.go:685 ``ServeConn``; the per-connection
loop pkg/sql/pgwire/conn.go:280 ``serveImpl``). Scope: the startup
handshake, cleartext and SCRAM-SHA-256 auth (RFC 5802/7677), the TLS
upgrade, the simple query protocol, the extended protocol
(Parse/Bind/Describe/Execute/Close/Sync) with text and binary parameters
and binary results, row-limited Execute with portal suspension, COPY
FROM STDIN and TO STDOUT in text format, the prepared-statement budget,
and errors with SQLSTATE codes. Each connection owns an engine Session,
so transaction state (idle / open / aborted) is per connection and is
reported in ReadyForQuery. A startup packet's ``application_name``
becomes the session variable that admission keys its tenant by.

The reply bytes are the reference's for the same results: the encoders
below are its own, and ``_sqlstate`` applies its rules to the port's
exception classes. The framing is from the public PostgreSQL protocol
documentation.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac as hmac_mod
import re
import secrets
import socket
import socketserver
import struct
import threading

from ..exec.engine import Engine
from ..exec.session import EngineError, Result, Session
from ..kv.concurrency import TxnAbortedError, TxnRetryError
from ..utils.admission import AdmissionRejected
from ..utils.mon import MemoryQuotaError

PROTO_V3 = 196608          # 3.0
SSL_REQUEST = 80877103
CANCEL_REQUEST = 80877102
GSSENC_REQUEST = 80877104

# type OIDs (public pg catalog numbers)
OID_BOOL = 16
OID_INT8 = 20
OID_FLOAT8 = 701
OID_TEXT = 25
OID_DATE = 1082
OID_TIMESTAMP = 1114
OID_JSONB = 3802


class ProtocolError(Exception):
    pass


class PreparedBudgetError(Exception):
    """Session exceeded server.prepared_statement_budget (53400)."""


# -- SCRAM-SHA-256 (RFC 5802/7677; the reference's default auth
# method, pkg/sql/pgwire/auth_methods.go:69) --------------------------

def scram_verifier(password: str, salt: bytes | None = None,
                   iterations: int = 4096) -> dict:
    """Server-side verifier: the server never stores the password,
    only (salt, i, StoredKey, ServerKey) — exactly what CRDB keeps in
    system.users as a SCRAM hash."""
    salt = salt or secrets.token_bytes(16)
    salted = hashlib.pbkdf2_hmac("sha256", password.encode(), salt,
                                 iterations)
    ck = hmac_mod.new(salted, b"Client Key", hashlib.sha256).digest()
    sk = hmac_mod.new(salted, b"Server Key", hashlib.sha256).digest()
    return {"salt": salt, "i": iterations,
            "stored_key": hashlib.sha256(ck).digest(),
            "server_key": sk}


def _scram_attrs(msg: str) -> dict:
    return dict(kv.split("=", 1) for kv in msg.split(","))


def _sqlstate(exc: Exception) -> str:
    msg = str(exc)
    if isinstance(exc, CopyDataError):
        return "22P02"  # invalid_text_representation
    if isinstance(exc, PreparedBudgetError):
        return "53400"  # configuration_limit_exceeded
    if isinstance(exc, AdmissionRejected):
        # admission queue full / load shed: the clean front-door
        # rejection clients should retry with backoff
        return "53300"  # too_many_connections
    if isinstance(exc, (TxnRetryError, TxnAbortedError)) \
            or "restart transaction" in msg:
        return "40001"  # serialization_failure
    if "transaction is aborted" in msg:
        return "25P02"  # in_failed_sql_transaction
    if isinstance(exc, MemoryQuotaError):
        return "53200"  # out_of_memory
    if isinstance(exc, EngineError):
        return "42601" if "parse" in msg.lower() else "XX000"
    return "XX000"


def _infer_oid(rows, col: int) -> int:
    """Type OID from the first non-null value in column ``col``."""
    for row in rows:
        v = row[col]
        if v is None:
            continue
        if isinstance(v, bool):
            return OID_BOOL
        if isinstance(v, int):
            return OID_INT8
        if isinstance(v, float):
            return OID_FLOAT8
        if isinstance(v, datetime.datetime):
            return OID_TIMESTAMP
        if isinstance(v, datetime.date):
            return OID_DATE
        if isinstance(v, dict):
            return OID_JSONB
        return OID_TEXT
    return OID_TEXT


def _encode_text(v) -> bytes | None:
    """Text-format result encoding (format code 0)."""
    if v is None:
        return None
    if isinstance(v, bool):
        return b"t" if v else b"f"
    if isinstance(v, float):
        return repr(v).encode()
    if isinstance(v, dict):
        import json
        return json.dumps(v, sort_keys=True,
                          separators=(",", ":")).encode()
    if isinstance(v, list):
        # pg array_out text via the canonical encoder (quoting rules
        # for elements containing , { } " \ or spaces)
        from ..sql import datum as dtm
        from ..sql.types import BOOL, FLOAT8, INT8, STRING
        elem = STRING
        for x in v:
            if x is None:
                continue
            if isinstance(x, bool):
                elem = BOOL
            elif isinstance(x, int):
                elem = INT8
            elif isinstance(x, float):
                elem = FLOAT8
            break
        return dtm.canon_array(v, elem).encode()
    return str(v).encode()


_PG_EPOCH_DATE = datetime.date(2000, 1, 1)
_PG_EPOCH_DT = datetime.datetime(2000, 1, 1)


def _encode_binary(v, oid: int) -> bytes | None:
    """Binary-format result encoding (format code 1) for the common
    wire types; anything else falls back to its utf8 text bytes (the
    binary representation of text/varchar IS the text)."""
    if v is None:
        return None
    if oid == OID_BOOL:
        return b"\x01" if v else b"\x00"
    if oid == OID_INT8:
        return struct.pack("!q", int(v))
    if oid == OID_FLOAT8:
        return struct.pack("!d", float(v))
    if oid == OID_DATE and isinstance(v, datetime.date):
        return struct.pack("!i", (v - _PG_EPOCH_DATE).days)
    if oid == OID_TIMESTAMP and isinstance(v, datetime.datetime):
        d = v - _PG_EPOCH_DT
        micros = (d.days * 86_400_000_000 + d.seconds * 1_000_000
                  + d.microseconds)
        return struct.pack("!q", micros)
    if oid == OID_JSONB:
        return b"\x01" + (_encode_text(v) or b"")
    return _encode_text(v)


_COPY_RE = re.compile(
    r"copy\s+(?P<table>[a-zA-Z_][\w.]*)\s*"
    r"(?:\((?P<cols>[^)]*)\))?\s*"
    r"(?P<dir>from|to)\s+(?:stdin|stdout)"
    r"(?:\s+with)?(?:\s*\(?\s*format\s+text\s*\)?)?\s*$",
    re.IGNORECASE)


def _copy_text(v) -> str:
    """pg COPY text-format output encoding for one value."""
    if v is None:
        return "\\N"
    if isinstance(v, bool):
        return "t" if v else "f"
    s = _encode_text(v).decode()
    return (s.replace("\\", "\\\\").replace("\t", "\\t")
            .replace("\n", "\\n").replace("\r", "\\r"))


_COPY_UNESCAPE = {"t": "\t", "n": "\n", "r": "\r", "\\": "\\"}


def _copy_unescape(f: str) -> str:
    # single-pass: sequential replace() corrupts a literal backslash
    # followed by t/n/r ('a\\tb' on the wire means backslash + t)
    if "\\" not in f:
        return f
    out = []
    i, n = 0, len(f)
    while i < n:
        c = f[i]
        if c == "\\" and i + 1 < n:
            out.append(_COPY_UNESCAPE.get(f[i + 1], f[i + 1]))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _copy_parse_line(line: bytes, ncols: int) -> list:
    fields = line.decode().split("\t")
    if len(fields) != ncols:
        raise ProtocolError(
            f"COPY row has {len(fields)} columns, expected {ncols}")
    return [None if f == "\\N" else _copy_unescape(f) for f in fields]


class CopyDataError(Exception):
    """Bad field content in COPY text data (sqlstate 22P02)."""


_COPY_INT_RE = re.compile(r"[+-]?[0-9]+")
# pg numeric/float text: decimal with optional exponent, or the
# special values NaN/Infinity (case-insensitive)
_COPY_SPECIAL_FLOAT_RE = re.compile(r"[+-]?(nan|inf(inity)?)",
                                    re.IGNORECASE)
_COPY_FLOAT_RE = re.compile(
    r"[+-]?([0-9]+(\.[0-9]*)?|\.[0-9]+)([eE][+-]?[0-9]+)?"
    r"|[+-]?(nan|inf(inity)?)", re.IGNORECASE)


def _copy_check_numeric(v: str, is_float: bool, col: str) -> str:
    """Validate a COPY text field bound for a numeric column host-side.

    pg text format only accepts \\N as NULL — the literal text 'NULL'
    for an int column is invalid input, never SQL NULL — and a
    malformed token must fail with invalid-input-syntax, not be
    interpolated into the INSERT. Explicit regexes, not int()/float():
    Python accepts '1_000' and Unicode digits, which pg rejects (and
    which must never reach the interpolated INSERT).
    """
    # pg's int4in/float8in trim surrounding ASCII whitespace before
    # parsing ('  42' is valid input); the strict charset check runs
    # on the trimmed token (round-4 advisor, low)
    v = v.strip(" \t\r\n")
    pat = _COPY_FLOAT_RE if is_float else _COPY_INT_RE
    if not pat.fullmatch(v):
        kind = "type numeric" if is_float else "type int"
        raise CopyDataError(
            f"invalid input syntax for {kind}: {v!r} in column {col}")
    return v


def _copy_sql_literal(v, numeric: bool) -> str:
    """One VALUES literal for a COPY field. Quoting is decided by the
    TARGET COLUMN's type, not by sniffing the text — 'nan'/'inf'
    float-parse but are strings when the column says so."""
    if v is None:
        return "NULL"
    if numeric:
        # NaN/Infinity are valid pg float text but not bare SQL
        # tokens — the engine accepts them as quoted literals
        if _COPY_SPECIAL_FLOAT_RE.fullmatch(v):
            return "'" + v + "'"
        return v
    return "'" + v.replace("'", "''") + "'"


def split_statements(buf: str) -> list[str]:
    """Split a simple-Query string on top-level semicolons.

    Respects single-quoted literals (with '' escapes) and double-quoted
    identifiers; pgwire's simple query protocol allows multiple
    statements per message.
    """
    out, cur, i, n = [], [], 0, len(buf)
    quote = None
    while i < n:
        c = buf[i]
        if quote:
            cur.append(c)
            if c == quote:
                if quote == "'" and i + 1 < n and buf[i + 1] == "'":
                    cur.append(buf[i + 1])
                    i += 1
                else:
                    quote = None
        elif c in ("'", '"'):
            quote = c
            cur.append(c)
        elif c == ";":
            s = "".join(cur).strip()
            if s:
                out.append(s)
            cur = []
        else:
            cur.append(c)
        i += 1
    s = "".join(cur).strip()
    if s:
        out.append(s)
    return out


class _Writer:
    """Typed pgwire backend-message writer over a socket.

    ``sendall`` injects the flush primitive: the reactor front end
    hands workers a select-backed sendall that is safe on its
    non-blocking sockets; the thread front end keeps the plain
    blocking ``socket.sendall``.
    """

    def __init__(self, sock: socket.socket, sendall=None):
        self._sock = sock
        self._sendall = sendall or sock.sendall
        self._buf = bytearray()

    def msg(self, typ: bytes, payload: bytes = b""):
        self._buf += typ + struct.pack("!I", len(payload) + 4) + payload

    def flush(self):
        if self._buf:
            self._sendall(bytes(self._buf))
            self._buf.clear()

    # -- concrete messages ---------------------------------------------------
    def auth_ok(self):
        self.msg(b"R", struct.pack("!I", 0))

    def auth_sasl(self, mechs: list[str]):
        body = struct.pack("!I", 10) + b"".join(
            m.encode() + b"\x00" for m in mechs) + b"\x00"
        self.msg(b"R", body)

    def auth_sasl_continue(self, data: bytes):
        self.msg(b"R", struct.pack("!I", 11) + data)

    def auth_sasl_final(self, data: bytes):
        self.msg(b"R", struct.pack("!I", 12) + data)

    def auth_cleartext(self):
        """AuthenticationCleartextPassword (auth.go's password method;
        SCRAM is the reference default, cleartext its fallback — and
        ours, since the wire is already plaintext without TLS)."""
        self.msg(b"R", struct.pack("!I", 3))

    def copy_in_response(self, ncols: int):
        self.msg(b"G", struct.pack("!bH", 0, ncols)
                 + struct.pack(f"!{ncols}H", *([0] * ncols)))

    def copy_out_response(self, ncols: int):
        self.msg(b"H", struct.pack("!bH", 0, ncols)
                 + struct.pack(f"!{ncols}H", *([0] * ncols)))

    def copy_data(self, data: bytes):
        self.msg(b"d", data)

    def copy_done(self):
        self.msg(b"c")

    def parameter_status(self, key: str, val: str):
        self.msg(b"S", key.encode() + b"\x00" + val.encode() + b"\x00")

    def backend_key_data(self, pid: int, secret: int):
        self.msg(b"K", struct.pack("!II", pid & 0xFFFFFFFF, secret))

    def ready_for_query(self, status: bytes):
        self.msg(b"Z", status)
        self.flush()

    def row_description(self, names, oids, fmts=None):
        p = bytearray(struct.pack("!H", len(names)))
        fmts = fmts or [0] * len(names)
        for name, oid, fmt in zip(names, oids, fmts):
            p += name.encode() + b"\x00"
            p += struct.pack("!IhIhih", 0, 0, oid, -1, -1, fmt)
        self.msg(b"T", bytes(p))

    def data_row(self, encoded: list[bytes | None]):
        p = bytearray(struct.pack("!H", len(encoded)))
        for e in encoded:
            if e is None:
                p += struct.pack("!i", -1)
            else:
                p += struct.pack("!I", len(e)) + e
        self.msg(b"D", bytes(p))

    def command_complete(self, tag: str):
        self.msg(b"C", tag.encode() + b"\x00")

    def empty_query(self):
        self.msg(b"I")

    def no_data(self):
        self.msg(b"n")

    def parse_complete(self):
        self.msg(b"1")

    def bind_complete(self):
        self.msg(b"2")

    def close_complete(self):
        self.msg(b"3")

    def portal_suspended(self):
        self.msg(b"s")

    def parameter_description(self, oids):
        self.msg(b"t", struct.pack("!H", len(oids)) +
                 b"".join(struct.pack("!I", o) for o in oids))

    def error(self, message: str, code: str = "XX000",
              severity: str = "ERROR"):
        p = (b"S" + severity.encode() + b"\x00" +
             b"V" + severity.encode() + b"\x00" +
             b"C" + code.encode() + b"\x00" +
             b"M" + message.encode() + b"\x00" + b"\x00")
        self.msg(b"E", p)


class _Reader:
    def __init__(self, sock: socket.socket):
        self._sock = sock

    def _exactly(self, n: int) -> bytes:
        chunks = []
        while n:
            b = self._sock.recv(n)
            if not b:
                raise ConnectionError("client disconnected")
            chunks.append(b)
            n -= len(b)
        return b"".join(chunks)

    def startup(self) -> tuple[int, dict]:
        (length,) = struct.unpack("!I", self._exactly(4))
        if length < 8 or length > 1 << 20:
            raise ProtocolError(f"bad startup length {length}")
        body = self._exactly(length - 4)
        (code,) = struct.unpack("!I", body[:4])
        params = {}
        if code == PROTO_V3:
            parts = body[4:].split(b"\x00")
            for k, v in zip(parts[::2], parts[1::2]):
                if k:
                    params[k.decode()] = v.decode()
        return code, params

    def message(self) -> tuple[bytes, bytes]:
        typ = self._exactly(1)
        (length,) = struct.unpack("!I", self._exactly(4))
        if length < 4 or length > 1 << 28:
            raise ProtocolError(f"bad message length {length}")
        return typ, self._exactly(length - 4)


def _cstr(b: bytes, off: int) -> tuple[str, int]:
    end = b.index(b"\x00", off)
    return b[off:end].decode(), end + 1


def _scan_placeholders(sql: str):
    """Yield (start, end, index) for every $N outside string literals
    and quoted identifiers."""
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        if c == "-" and i + 1 < n and sql[i + 1] == "-":
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
        elif c == "/" and i + 1 < n and sql[i + 1] == "*":
            j = sql.find("*/", i + 2)
            i = n if j < 0 else j + 2
        elif c == "'":
            i += 1
            while i < n:
                if sql[i] == "'":
                    if i + 1 < n and sql[i + 1] == "'":
                        i += 2
                        continue
                    break
                i += 1
            i += 1
        elif c == '"':
            i = sql.find('"', i + 1)
            i = n if i < 0 else i + 1
        elif c == "$" and i + 1 < n and sql[i + 1].isdigit():
            j = i + 1
            while j < n and sql[j].isdigit():
                j += 1
            yield i, j, int(sql[i + 1:j])
            i = j
        else:
            i += 1


def _count_placeholders(sql: str) -> int:
    return max((idx for _s, _e, idx in _scan_placeholders(sql)),
               default=0)


def _decode_param(raw: bytes | None, fmt: int, oid: int) -> str:
    """One bound parameter -> SQL literal text. Text format re-quotes;
    binary format decodes the common wire types (int2/4/8, float8,
    bool, text) by declared oid."""
    if raw is None:
        return "NULL"
    if fmt == 1:   # binary — parenthesized like the text path, or a
        # negative value forms a '--' comment in the spliced SQL
        if oid == OID_INT8:
            return "(%d)" % struct.unpack("!q", raw)[0]
        if oid == 21 and len(raw) == 2:    # int2
            return "(%d)" % struct.unpack("!h", raw)[0]
        if oid == 23 and len(raw) == 4:    # int4
            return "(%d)" % struct.unpack("!i", raw)[0]
        if oid == OID_FLOAT8 and len(raw) == 8:
            return "(%s)" % repr(struct.unpack("!d", raw)[0])
        if oid == OID_BOOL and len(raw) == 1:
            return "TRUE" if raw[0] else "FALSE"
        s = raw.decode("utf-8")            # text-like payloads
    else:
        s = raw.decode("utf-8")
    if oid in (OID_INT8, 21, 23):
        return "(%d)" % int(s)        # validate AND parenthesize:
        # splicing raw text would let '-1' form a '--' comment or a
        # crafted payload inject statement text
    if oid in (OID_FLOAT8, 700, 1700):
        return "(%s)" % repr(float(s))
    if oid == OID_BOOL:
        low = s.lower()
        if low in ("t", "true", "1", "on", "yes"):
            return "TRUE"
        if low in ("f", "false", "0", "off", "no"):
            return "FALSE"
        raise EngineError(
            f"invalid input syntax for type boolean: {s!r}")
    return "'" + s.replace("'", "''") + "'"


def _bind_params(sql: str, oids: list, body: bytes, off: int):
    """Decode a Bind message's format codes + parameter values and
    substitute them into the SQL as literals. The statement then rides
    the normal parse/plan path — the reference binds placeholders into
    the AST instead (sql/pgwire/conn.go + planner placeholders); text
    substitution trades plan-cache hits across distinct values for a
    much smaller surface, and is what several pg poolers/proxies do."""
    (nfmt,) = struct.unpack_from("!H", body, off)
    off += 2
    fmts = []
    for _ in range(nfmt):
        (f,) = struct.unpack_from("!H", body, off)
        fmts.append(f)
        off += 2
    (nvals,) = struct.unpack_from("!H", body, off)
    off += 2
    vals = []
    for _ in range(nvals):
        (ln,) = struct.unpack_from("!i", body, off)
        off += 4
        if ln < 0:
            vals.append(None)
        else:
            vals.append(body[off:off + ln])
            off += ln
    lits = []
    for i, raw in enumerate(vals):
        fmt = fmts[i] if i < len(fmts) else (fmts[0] if len(fmts) == 1
                                             else 0)
        oid = oids[i] if i < len(oids) else 0
        lits.append(_decode_param(raw, fmt, oid))
    # result-format codes (0=text 1=binary): recorded on the portal
    # and honored per column at Execute time
    (nrfmt,) = struct.unpack_from("!H", body, off)
    off += 2
    rfmts = []
    for _ in range(nrfmt):
        (rf,) = struct.unpack_from("!H", body, off)
        off += 2
        rfmts.append(rf)
    # splice back-to-front so offsets stay valid
    spots = sorted(_scan_placeholders(sql), reverse=True)
    for s, e, idx in spots:
        if idx < 1 or idx > len(lits):
            raise EngineError(
                f"there is no parameter ${idx}")
        sql = sql[:s] + lits[idx - 1] + sql[e:]
    return sql, off, rfmts


class _Conn:
    """One client connection: the serveImpl loop (conn.go:280)."""

    def __init__(self, sock: socket.socket, engine: Engine, conn_id: int,
                 version: str, auth: dict | None = None,
                 tls=None, auth_method: str = "cleartext",
                 scram_users: dict | None = None,
                 reader=None, sendall=None):
        self.sock = sock
        self.engine = engine
        self.conn_id = conn_id
        self.version = version
        self.auth = auth
        self.auth_method = auth_method
        self.scram_users = scram_users or {}
        self.tls = tls  # ssl.SSLContext or None
        # the reactor front end injects a frame-queue reader and a
        # non-blocking-safe sendall; every protocol handler below is
        # shared verbatim between front ends (the bit-for-bit A/B)
        self.r = reader if reader is not None else _Reader(sock)
        self.w = _Writer(sock, sendall=sendall)
        self.session: Session = engine.session()
        # extended-protocol state: prepared statements (sql, declared
        # param oids) + bound portals (sql with params substituted,
        # plus any suspended result for row-limited Execute)
        self.stmts: dict[str, tuple] = {}
        self.portals: dict[str, dict] = {}
        self._errored = False  # skip-until-Sync after extended-proto error

    # -- helpers -------------------------------------------------------------
    def _txn_status(self) -> bytes:
        if self.session.txn_aborted:
            return b"E"
        return b"T" if self.session.in_txn else b"I"

    def _complete_tag(self, res: Result) -> str:
        if res.tag == "INSERT":
            return f"INSERT 0 {res.row_count}"
        if res.tag in ("UPDATE", "DELETE"):
            return f"{res.tag} {res.row_count}"
        if res.names:  # any row-returning statement
            return f"{res.tag} {len(res.rows)}"
        return res.tag

    def _send_result(self, res: Result, describe: bool = True):
        if res.names:
            oids = [_infer_oid(res.rows, i) for i in range(len(res.names))]
            if describe:
                self.w.row_description(res.names, oids)
            for row in res.rows:
                self.w.data_row([_encode_text(v) for v in row])
        self.w.command_complete(self._complete_tag(res))

    def _send_portal(self, p: dict, max_rows: int):
        """Row-limited portal execution: emit up to max_rows, then
        PortalSuspended; a later Execute on the same portal resumes
        where it stopped (pg portal suspension semantics)."""
        res = p["pending"]
        oids = p.get("oids")
        if oids is None:
            oids = p["oids"] = [_infer_oid(res.rows, i)
                                for i in range(len(res.names))]
        rf = p.get("rfmts") or []
        if len(rf) == 1:
            fmts = rf * len(res.names)
        elif len(rf) == len(res.names):
            fmts = rf
        else:
            fmts = [0] * len(res.names)
        if res.names and not p["described"]:
            self.w.row_description(res.names, oids, fmts)
            p["described"] = True
        rows = res.rows
        start = p["cursor"]
        end = len(rows) if max_rows <= 0 else min(len(rows),
                                                  start + max_rows)
        for row in rows[start:end]:
            self.w.data_row([
                _encode_binary(v, oid) if f == 1 else _encode_text(v)
                for v, oid, f in zip(row, oids, fmts)])
        p["cursor"] = end
        if end < len(rows):
            self.w.portal_suspended()
            return
        tag = self._complete_tag(res)
        self.w.command_complete(tag)
        del p["pending"]
        p["completed"] = True
        p["tag"] = tag

    def _execute(self, sql: str) -> Result:
        return self.engine.execute(sql, self.session)

    def _auth_fail(self, msg: str, code: str = "28P01") -> bool:
        self.w.error(msg, code=code, severity="FATAL")
        self.w.flush()
        return False

    def _auth_scram(self) -> bool:
        """RFC 5802/7677 SASL exchange (server side). Channel binding
        is not offered (gs2 'p=' is refused; 'n'/'y' accepted), like
        running the reference without tls-scram channel binding."""
        v = self.scram_users.get(self.user)
        self.w.auth_sasl(["SCRAM-SHA-256"])
        self.w.flush()
        typ, body = self.r.message()
        if typ != b"p":
            return self._auth_fail("expected SASL response", "08P01")
        mech, off = _cstr(body, 0)
        if mech != "SCRAM-SHA-256":
            return self._auth_fail(
                f"unsupported SASL mechanism {mech!r}", "28000")
        (ln,) = struct.unpack_from("!i", body, off)
        off += 4
        client_first = body[off:off + ln].decode()
        if client_first.startswith("p="):
            return self._auth_fail(
                "channel binding is not supported", "28000")
        if ",," not in client_first:
            return self._auth_fail("malformed client-first", "08P01")
        i = client_first.index(",,")
        gs2, bare = client_first[:i + 2], client_first[i + 2:]
        try:
            cnonce = _scram_attrs(bare)["r"]
        except (KeyError, ValueError):
            return self._auth_fail("malformed client-first", "08P01")
        if v is None:
            # unknown user: mimic a real exchange against a throwaway
            # verifier so usernames are not enumerable by timing shape
            v = scram_verifier(secrets.token_hex(8))
        snonce = cnonce + base64.b64encode(
            secrets.token_bytes(18)).decode()
        server_first = (f"r={snonce},"
                        f"s={base64.b64encode(v['salt']).decode()},"
                        f"i={v['i']}")
        self.w.auth_sasl_continue(server_first.encode())
        self.w.flush()
        typ, body = self.r.message()
        if typ != b"p":
            return self._auth_fail("expected SASL response", "08P01")
        client_final = body.decode()
        try:
            fattrs = _scram_attrs(client_final)
            proof = base64.b64decode(fattrs["p"])
            chan = base64.b64decode(fattrs["c"]).decode()
        except (KeyError, ValueError):
            return self._auth_fail("malformed client-final", "08P01")
        if fattrs.get("r") != snonce or chan != gs2:
            return self._auth_fail(
                "SCRAM nonce/channel mismatch", "28P01")
        without_proof = client_final[:client_final.rindex(",p=")]
        auth_msg = (bare + "," + server_first + ","
                    + without_proof).encode()
        csig = hmac_mod.new(v["stored_key"], auth_msg,
                            hashlib.sha256).digest()
        client_key = bytes(a ^ b for a, b in zip(proof, csig))
        if len(proof) != 32 or hashlib.sha256(client_key).digest() \
                != v["stored_key"] or \
                self.auth.get(self.user) is None:
            return self._auth_fail(
                f"password authentication failed for user "
                f"{self.user!r}")
        ssig = hmac_mod.new(v["server_key"], auth_msg,
                            hashlib.sha256).digest()
        self.w.auth_sasl_final(
            b"v=" + base64.b64encode(ssig))
        return True

    # -- protocol phases -----------------------------------------------------
    def handshake(self) -> bool:
        while True:
            code, params = self.r.startup()
            if code == SSL_REQUEST and self.tls is not None:
                # TLS upgrade (the reference's maybeUpgradeToSecureConn,
                # pgwire/server.go): accept, wrap, and continue the
                # startup over the encrypted stream
                self.sock.sendall(b"S")
                self.sock = self.tls.wrap_socket(self.sock,
                                                 server_side=True)
                self.r = _Reader(self.sock)
                self.w = _Writer(self.sock)
                continue
            if code in (SSL_REQUEST, GSSENC_REQUEST):
                self.sock.sendall(b"N")  # not supported; retry cleartext
                continue
            if code == CANCEL_REQUEST:
                return False
            if code != PROTO_V3:
                self.w.error(f"unsupported protocol {code >> 16}."
                             f"{code & 0xFFFF}", code="0A000",
                             severity="FATAL")
                self.w.flush()
                return False
            break
        return self.finish_startup(params)

    def finish_startup(self, params: dict) -> bool:
        """Authentication + session announcements for an accepted
        PROTO_V3 startup. Split from handshake() so the reactor front
        end — which parses startup packets on the event loop — can run
        just this phase on a worker thread."""
        self.user = params.get("user", "root")
        app = params.get("application_name")
        if app:
            self.session.vars.set("application_name", app)
        if self.auth is not None:
            if self.auth_method == "scram-sha-256":
                if not self._auth_scram():
                    return False
            else:
                # password gate (auth.go): the user must be known and
                # the cleartext password must match; anything else is
                # a FATAL 28P01 before any SQL is reachable
                self.w.auth_cleartext()
                self.w.flush()
                typ, body = self.r.message()
                if typ != b"p":
                    self.w.error("expected password message",
                                 code="08P01", severity="FATAL")
                    self.w.flush()
                    return False
                pw, _ = _cstr(body, 0)
                if self.auth.get(self.user) != pw:
                    self.w.error(
                        f"password authentication failed for user "
                        f"{self.user!r}", code="28P01",
                        severity="FATAL")
                    self.w.flush()
                    return False
        self.w.auth_ok()
        self.w.parameter_status("server_version", "13.0 cockroach-tpu "
                                + self.version)
        self.w.parameter_status("client_encoding", "UTF8")
        self.w.parameter_status("DateStyle", "ISO")
        self.w.parameter_status("integer_datetimes", "on")
        self.w.backend_key_data(self.conn_id, 0)
        self.w.ready_for_query(self._txn_status())
        return True

    def serve(self):
        if not self.handshake():
            return
        from ..utils import log
        log.info(log.SESSIONS, "client session opened user=%s",
                 getattr(self, "user", "?"))
        while True:
            typ, body = self._next_message()
            if typ is None:          # idle-session timeout
                return
            if not self.process(typ, body):
                return

    def _next_message(self):
        """Blocking read of the next frame, honoring
        server.idle_session_timeout while the session sits idle
        OUTSIDE a transaction (a session holding a txn open keeps its
        locks on purpose; pg's idle_session_timeout has the same
        carve-out via idle_in_transaction_session_timeout). Returns
        (None, None) when the idle deadline fires."""
        try:
            idle = float(self.engine.settings.get(
                "server.idle_session_timeout"))
        except Exception:
            idle = 0.0
        if idle <= 0 or self.session.in_txn:
            return self.r.message()
        try:
            self.sock.settimeout(idle)
            return self.r.message()
        except (socket.timeout, TimeoutError):
            return None, None
        finally:
            try:
                self.sock.settimeout(None)
            except OSError:
                pass

    def process(self, typ: bytes, body: bytes) -> bool:
        """Dispatch one frontend message; False = Terminate. Both
        front ends funnel through here — the thread loop above and
        the reactor's worker drain (server/pgfront.py) — so replies
        are byte-identical by construction."""
        if typ == b"X":          # Terminate
            return False
        if typ == b"Q":
            self._simple_query(body)
        elif typ in (b"P", b"B", b"D", b"E", b"C", b"H", b"S"):
            self._extended(typ, body)
        elif typ == b"F":        # function call: unsupported
            self.w.error("function call protocol unsupported",
                         code="0A000")
            self.w.ready_for_query(self._txn_status())
        else:
            self.w.error(f"unknown frontend message {typ!r}",
                         code="08P01")
            self.w.ready_for_query(self._txn_status())
        return True

    def _simple_query(self, body: bytes):
        sql, _ = _cstr(body, 0)
        m = _COPY_RE.match(sql.strip().rstrip(";"))
        if m is not None:
            try:
                self._copy(m)
            except Exception as e:
                self.w.error(str(e), code=_sqlstate(e))
            self.w.ready_for_query(self._txn_status())
            return
        stmts = split_statements(sql)
        if not stmts:
            self.w.empty_query()
            self.w.ready_for_query(self._txn_status())
            return
        for s in stmts:
            try:
                res = self._execute(s)
            except Exception as e:  # engine errors end the message batch
                self.w.error(str(e), code=_sqlstate(e))
                break
            self._send_result(res)
        self.w.ready_for_query(self._txn_status())

    # -- COPY (conn.go's processCopy; text format only) ----------------------
    def _copy_columns(self, table: str, collist: str | None) -> list[str]:
        schema = self.engine.store.table(table).schema
        if collist:
            return [c.strip() for c in collist.split(",")]
        return [c.name for c in schema.columns]

    def _copy(self, m):
        table = m.group("table")
        cols = self._copy_columns(table, m.group("cols"))
        if m.group("dir").lower() == "to":
            self._copy_out(table, cols)
        else:
            self._copy_in(table, cols)

    def _copy_out(self, table: str, cols: list[str]):
        res = self._execute(
            f"SELECT {', '.join(cols)} FROM {table}")
        self.w.copy_out_response(len(cols))
        for row in res.rows:
            line = "\t".join(_copy_text(v) for v in row)
            self.w.copy_data(line.encode() + b"\n")
        self.w.copy_done()
        self.w.command_complete(f"COPY {len(res.rows)}")

    def _copy_in(self, table: str, cols: list[str]):
        # resolve the schema BEFORE CopyInResponse: an unknown column
        # must error while the client is still in query mode — after
        # the response the client streams CopyData and any raise that
        # skips the drain loop desyncs the protocol
        from ..sql.types import Family
        schema = self.engine.store.table(table).schema
        numeric = [schema.column(c).type.family in
                   (Family.INT, Family.FLOAT, Family.DECIMAL)
                   for c in cols]
        is_float = [schema.column(c).type.family in
                    (Family.FLOAT, Family.DECIMAL) for c in cols]
        self.w.copy_in_response(len(cols))
        self.w.flush()
        buf = b""
        rows: list[list[str | None]] = []
        failed = None
        # A bad row must NOT abort the receive loop: pg keeps consuming
        # CopyData until CopyDone/CopyFail, then reports the error —
        # bailing early desyncs the protocol (the leftover frames would
        # be read as unknown frontend messages by serve()).
        parse_err: Exception | None = None
        while True:
            typ, body = self.r.message()
            if typ == b"d":
                if parse_err is not None:
                    continue         # drain only; first error wins
                buf += body
                # CopyData chunks can split mid-line: keep the tail
                while True:
                    nl = buf.find(b"\n")
                    if nl < 0:
                        break
                    line, buf = buf[:nl], buf[nl + 1:]
                    if line == b"\\.":
                        continue
                    if not line:
                        continue
                    try:
                        r = _copy_parse_line(line, len(cols))
                        for i, v in enumerate(r):
                            if v is not None and numeric[i]:
                                r[i] = _copy_check_numeric(
                                    v, is_float[i], cols[i])
                        rows.append(r)
                    except Exception as e:
                        parse_err = e
                        break
            elif typ == b"c":        # CopyDone
                break
            elif typ == b"f":        # CopyFail
                failed, _ = _cstr(body, 0)
                break
            elif typ in (b"H", b"S"):
                self.w.flush()
            else:
                raise ProtocolError(
                    f"unexpected message {typ!r} during COPY")
        if failed is not None:
            self.w.error(f"COPY failed: {failed}", code="57014")
            return
        if parse_err is not None:
            raise parse_err
        inserted = 0
        # batches through the normal INSERT path (constraints and
        # indexes apply), wrapped in ONE transaction so a mid-COPY
        # failure leaves nothing behind — pg's COPY is atomic per
        # statement
        BATCH = 1000
        own_txn = not self.session.in_txn
        if own_txn:
            self._execute("BEGIN")
        try:
            for lo in range(0, len(rows), BATCH):
                chunk = rows[lo:lo + BATCH]
                values = ", ".join(
                    "(" + ", ".join(
                        _copy_sql_literal(v, numeric[i])
                        for i, v in enumerate(r)) + ")"
                    for r in chunk)
                self._execute(
                    f"INSERT INTO {table} ({', '.join(cols)}) "
                    f"VALUES {values}")
                inserted += len(chunk)
            if own_txn:
                self._execute("COMMIT")
        except Exception:
            if own_txn:
                self._execute("ROLLBACK")
            raise
        self.w.command_complete(f"COPY {inserted}")

    def _extended(self, typ: bytes, body: bytes):
        # after an error, discard everything until Sync
        if self._errored and typ != b"S":
            return
        try:
            if typ == b"P":           # Parse
                name, off = _cstr(body, 0)
                sql, off = _cstr(body, off)
                (nparams,) = struct.unpack_from("!H", body, off)
                off += 2
                oids = []
                for _ in range(nparams):
                    (o,) = struct.unpack_from("!I", body, off)
                    oids.append(o)
                    off += 4
                # placeholders present but undeclared: count $N in the
                # text so Describe can report them (oid 0 = unknown)
                n_ph = _count_placeholders(sql)
                while len(oids) < n_ph:
                    oids.append(0)
                if name and name not in self.stmts:
                    # named statements are session-lifetime server
                    # memory; cap them so one session cannot grow the
                    # server unboundedly (the unnamed statement
                    # replaces itself and stays exempt)
                    try:
                        budget = int(self.engine.settings.get(
                            "server.prepared_statement_budget"))
                    except Exception:
                        budget = 0
                    if budget and len(self.stmts) >= budget:
                        raise PreparedBudgetError(
                            f"prepared statement budget ({budget}) "
                            f"exhausted; DEALLOCATE or Close unused "
                            f"statements")
                self.stmts[name] = (sql, oids)
                self.w.parse_complete()
            elif typ == b"B":         # Bind
                portal, off = _cstr(body, 0)
                stmt, off = _cstr(body, off)
                if stmt not in self.stmts:
                    raise EngineError(f"unknown prepared statement "
                                      f"{stmt!r}")
                sql, oids = self.stmts[stmt]
                sql, off, rfmts = _bind_params(sql, oids, body, off)
                self.portals[portal] = {"sql": sql, "rfmts": rfmts}
                self.w.bind_complete()
            elif typ == b"D":         # Describe
                kind, sql_name = body[:1], _cstr(body, 1)[0]
                src = self.portals if kind == b"P" else self.stmts
                if sql_name not in src:
                    raise EngineError(f"unknown {kind!r} {sql_name!r}")
                if kind == b"S":
                    self.w.parameter_description(self.stmts[sql_name][1])
                # row shape is only known post-execution here; NoData
                # keeps drivers on the simple path (they re-describe
                # from the result's RowDescription we emit on Execute)
                self.w.no_data()
            elif typ == b"E":         # Execute
                portal, off = _cstr(body, 0)
                if portal not in self.portals:
                    raise EngineError(f"unknown portal {portal!r}")
                (max_rows,) = struct.unpack_from("!i", body, off)
                p = self.portals[portal]
                if p.get("completed"):
                    # executing a completed portal returns no further
                    # rows (pg portal semantics) — never re-runs DML
                    self.w.command_complete(p["tag"])
                elif "pending" not in p:
                    res = self._execute(p["sql"])
                    p["pending"] = res
                    p["cursor"] = 0
                    p["described"] = False
                    self._send_portal(p, max_rows)
                else:
                    self._send_portal(p, max_rows)
            elif typ == b"C":         # Close
                kind, name = body[:1], _cstr(body, 1)[0]
                (self.portals if kind == b"P" else self.stmts).pop(
                    name, None)
                self.w.close_complete()
            elif typ == b"H":         # Flush
                self.w.flush()
            elif typ == b"S":         # Sync
                self._errored = False
                self.w.ready_for_query(self._txn_status())
        except Exception as e:
            self._errored = True
            self.w.error(str(e), code=_sqlstate(e))
            self.w.flush()


class PgServer:
    """The pgwire front door: listener + connection dispatch.

    Two interchangeable front ends behind one facade, selected by the
    ``server.pgwire_frontend`` cluster setting (or the ``frontend=``
    override):

    - ``reactor`` (default): one selector event loop owns every
      socket; idle sessions hold no thread and O(1) buffer memory; a
      bounded worker pool sized by *active statements* runs the
      protocol handlers (server/pgfront.py).
    - ``threads``: the legacy thread-per-connection
      socketserver.ThreadingTCPServer — the reference accepts in
      (*Server).AcceptClients (pkg/server/server.go:1915) and serves
      each conn on a goroutine; a thread per conn is that analogue.

    Both front ends drive the same ``_Conn`` protocol handlers, so
    replies are bit-identical — the A/B lever for the 1K/10K-session
    bench rungs.
    """

    def __init__(self, engine: Engine, host: str = "127.0.0.1",
                 port: int = 0, version: str = "0.2.0",
                 auth: dict | None = None,
                 certs_dir: str | None = None,
                 auth_method: str = "cleartext",
                 frontend: str | None = None):
        self.engine = engine
        self.version = version
        self.auth = auth  # user -> cleartext password; None = insecure
        self.auth_method = auth_method
        # SCRAM verifiers derived once: the serving path never sees
        # the password (auth_methods.go:69; RFC 5802)
        self.scram_users = ({u: scram_verifier(pw)
                             for u, pw in (auth or {}).items()}
                            if auth_method == "scram-sha-256" else {})
        self.tls = None
        if certs_dir is not None:
            import os
            import ssl
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(
                os.path.join(certs_dir, "node.crt"),
                os.path.join(certs_dir, "node.key"))
            self.tls = ctx
        self._next_id = [0]
        if frontend is None:
            try:
                frontend = str(engine.settings.get(
                    "server.pgwire_frontend"))
            except Exception:
                frontend = "threads"
        self.frontend = frontend
        if frontend == "reactor":
            from .pgfront import ReactorServer
            self._impl = ReactorServer(self, host, port)
        else:
            self._impl = _ThreadServer(self, host, port)

    def new_conn(self, sock: socket.socket, reader=None,
                 sendall=None) -> _Conn:
        """One _Conn with the next conn id; both front ends funnel
        connection construction through here."""
        self._next_id[0] += 1
        return _Conn(sock, self.engine, self._next_id[0], self.version,
                     auth=self.auth, tls=self.tls,
                     auth_method=self.auth_method,
                     scram_users=self.scram_users,
                     reader=reader, sendall=sendall)

    @property
    def addr(self) -> tuple[str, int]:
        return self._impl.addr

    def start(self):
        from . import pgfront
        # the r18 residue lever: a sub-default GIL switch quantum lets
        # OLTP batch windows close under analytic load (process-global;
        # see sql.exec.switch_interval). Armed here + on change.
        pgfront.apply_switch_interval(self.engine.settings)
        self.engine.settings.on_change(
            lambda n, v: pgfront.apply_switch_interval(
                self.engine.settings)
            if n == "sql.exec.switch_interval" else None)
        self._impl.start()
        return self

    def stop(self):
        self._impl.stop()


class _ThreadServer:
    """Thread-per-connection front end (the pre-reactor default)."""

    def __init__(self, parent: PgServer, host: str, port: int):
        outer = parent

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                # OLTP responses are one small packet per statement;
                # with cross-session batch windows a session's reply
                # can gate another session's window, so Nagle's 40ms
                # delayed-ACK interaction would land straight on the
                # fused lane's p99 (the reference sets TCP_NODELAY on
                # every pgwire conn for the same reason)
                try:
                    self.request.setsockopt(socket.IPPROTO_TCP,
                                            socket.TCP_NODELAY, 1)
                except OSError:
                    pass
                conn = outer.new_conn(self.request)
                try:
                    conn.serve()
                except (ConnectionError, ProtocolError, OSError):
                    pass
                finally:
                    if conn.session.txn is not None:
                        conn.session.txn.rollback()

        class Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Srv((host, port), Handler)
        self._thread: threading.Thread | None = None

    @property
    def addr(self) -> tuple[str, int]:
        return self._server.server_address[:2]

    def start(self):
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
            name="pgwire-accept", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=5)
