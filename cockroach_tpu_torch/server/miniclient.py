"""A minimal pure-Python PostgreSQL wire client.

The port's copy of cockroach_tpu/server/miniclient.py: an independently
written client of the PUBLIC v3 protocol (startup, TLS upgrade,
cleartext + SCRAM-SHA-256 auth with server-signature verification,
simple and extended query, text and BINARY result decoding). It
shares no code with the server module — the point of the exercise is
that our server interoperates with a client written only from the
public protocol documentation, the way psql/pg8000 would.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import secrets
import socket
import ssl as ssl_mod
import struct

_PG_EPOCH_DATE = datetime.date(2000, 1, 1)
_PG_EPOCH_DT = datetime.datetime(2000, 1, 1)

OID_BOOL, OID_INT8, OID_FLOAT8 = 16, 20, 701
OID_DATE, OID_TIMESTAMP, OID_JSONB = 1082, 1114, 3802


class PgError(Exception):
    def __init__(self, fields: dict):
        self.fields = fields
        super().__init__(fields.get("M", "server error"))

    @property
    def sqlstate(self):
        return self.fields.get("C")


class MiniClient:
    def __init__(self, host: str, port: int, user: str = "root",
                 password: str | None = None, database: str = "db",
                 tls: bool = False, timeout: float = 30.0,
                 application_name: str | None = None):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        if tls:
            self.sock.sendall(struct.pack("!II", 8, 80877103))
            if self.sock.recv(1) != b"S":
                raise PgError({"M": "server refused TLS"})
            ctx = ssl_mod.SSLContext(ssl_mod.PROTOCOL_TLS_CLIENT)
            ctx.check_hostname = False
            ctx.verify_mode = ssl_mod.CERT_NONE
            self.sock = ctx.wrap_socket(self.sock)
        self.user = user
        self.password = password
        params = f"user\x00{user}\x00database\x00{database}\x00"
        if application_name:
            params += f"application_name\x00{application_name}\x00"
        params = (params + "\x00").encode()
        head = struct.pack("!II", 8 + len(params), 196608)
        self.sock.sendall(head + params)
        self._auth_loop()
        self.parameters: dict[str, str] = {}
        self._ready()

    # -- framing -----------------------------------------------------

    def _recv_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            b = self.sock.recv(n - len(out))
            if not b:
                raise ConnectionError("server closed connection")
            out += b
        return out

    def _msg(self):
        typ = self._recv_exact(1)
        (ln,) = struct.unpack("!I", self._recv_exact(4))
        return typ, self._recv_exact(ln - 4)

    def _send(self, typ: bytes, body: bytes = b""):
        self.sock.sendall(typ + struct.pack("!I", len(body) + 4) + body)

    @staticmethod
    def _err_fields(body: bytes) -> dict:
        out = {}
        i = 0
        while i < len(body) and body[i] != 0:
            code = chr(body[i])
            j = body.index(0, i + 1)
            out[code] = body[i + 1:j].decode()
            i = j + 1
        return out

    # -- auth --------------------------------------------------------

    def _auth_loop(self):
        while True:
            typ, body = self._msg()
            if typ == b"E":
                raise PgError(self._err_fields(body))
            if typ != b"R":
                raise PgError({"M": f"unexpected {typ!r} during auth"})
            (code,) = struct.unpack_from("!I", body, 0)
            if code == 0:
                return
            if code == 3:      # cleartext
                self._send(b"p", (self.password or "").encode()
                           + b"\x00")
            elif code == 10:   # SASL
                mechs = body[4:].split(b"\x00")
                if b"SCRAM-SHA-256" not in mechs:
                    raise PgError({"M": "no supported SASL mechanism"})
                self._scram()
            else:
                raise PgError({"M": f"unsupported auth code {code}"})

    def _scram(self):
        cnonce = base64.b64encode(secrets.token_bytes(18)).decode()
        bare = f"n={self.user},r={cnonce}"
        first = "n,," + bare
        payload = (b"SCRAM-SHA-256\x00"
                   + struct.pack("!i", len(first)) + first.encode())
        self._send(b"p", payload)
        typ, body = self._msg()
        if typ == b"E":
            raise PgError(self._err_fields(body))
        (code,) = struct.unpack_from("!I", body, 0)
        if code != 11:
            raise PgError({"M": f"expected SASLContinue, got {code}"})
        server_first = body[4:].decode()
        attrs = dict(kv.split("=", 1) for kv in server_first.split(","))
        snonce, salt, iters = (attrs["r"],
                               base64.b64decode(attrs["s"]),
                               int(attrs["i"]))
        if not snonce.startswith(cnonce):
            raise PgError({"M": "server nonce does not extend ours"})
        salted = hashlib.pbkdf2_hmac(
            "sha256", (self.password or "").encode(), salt, iters)
        ck = hmac.new(salted, b"Client Key", hashlib.sha256).digest()
        stored = hashlib.sha256(ck).digest()
        without_proof = "c=" + base64.b64encode(b"n,,").decode() \
            + ",r=" + snonce
        auth_msg = (bare + "," + server_first + ","
                    + without_proof).encode()
        csig = hmac.new(stored, auth_msg, hashlib.sha256).digest()
        proof = bytes(a ^ b for a, b in zip(ck, csig))
        final = without_proof + ",p=" + base64.b64encode(proof).decode()
        self._send(b"p", final.encode())
        typ, body = self._msg()
        if typ == b"E":
            raise PgError(self._err_fields(body))
        (code,) = struct.unpack_from("!I", body, 0)
        if code != 12:
            raise PgError({"M": f"expected SASLFinal, got {code}"})
        fattrs = dict(kv.split("=", 1)
                      for kv in body[4:].decode().split(","))
        sk = hmac.new(salted, b"Server Key", hashlib.sha256).digest()
        want = hmac.new(sk, auth_msg, hashlib.sha256).digest()
        if base64.b64decode(fattrs["v"]) != want:
            # a MITM or a server that never knew the verifier
            raise PgError({"M": "server signature mismatch"})

    def _ready(self):
        while True:
            typ, body = self._msg()
            if typ == b"Z":
                return
            if typ == b"E":
                raise PgError(self._err_fields(body))
            if typ == b"S":
                k = body.split(b"\x00")
                self.parameters[k[0].decode()] = k[1].decode()
            # K (BackendKeyData), N (notice): ignored

    # -- decoding ----------------------------------------------------

    @staticmethod
    def _decode_text(raw: bytes, oid: int):
        s = raw.decode()
        if oid == OID_BOOL:
            return s == "t"
        if oid == OID_INT8 or oid in (21, 23):
            return int(s)
        if oid == OID_FLOAT8:
            return float(s)
        return s

    @staticmethod
    def _decode_binary(raw: bytes, oid: int):
        if oid == OID_BOOL:
            return raw != b"\x00"
        if oid == OID_INT8:
            return struct.unpack("!q", raw)[0]
        if oid == OID_FLOAT8:
            return struct.unpack("!d", raw)[0]
        if oid == OID_DATE:
            return _PG_EPOCH_DATE + datetime.timedelta(
                days=struct.unpack("!i", raw)[0])
        if oid == OID_TIMESTAMP:
            return _PG_EPOCH_DT + datetime.timedelta(
                microseconds=struct.unpack("!q", raw)[0])
        if oid == OID_JSONB:
            import json
            return json.loads(raw[1:].decode())
        return raw.decode()

    def _collect(self):
        cols, rows, tag = [], [], None
        err = None
        while True:
            typ, body = self._msg()
            if typ == b"T":
                (n,) = struct.unpack_from("!H", body, 0)
                off = 2
                cols = []
                for _ in range(n):
                    j = body.index(0, off)
                    name = body[off:j].decode()
                    off = j + 1
                    _t, _a, oid, _sz, _m, fmt = struct.unpack_from(
                        "!IhIhih", body, off)
                    off += 18
                    cols.append((name, oid, fmt))
            elif typ == b"D":
                (n,) = struct.unpack_from("!H", body, 0)
                off = 2
                row = []
                for i in range(n):
                    (ln,) = struct.unpack_from("!i", body, off)
                    off += 4
                    if ln < 0:
                        row.append(None)
                        continue
                    raw = body[off:off + ln]
                    off += ln
                    name, oid, fmt = cols[i]
                    row.append(self._decode_binary(raw, oid) if fmt
                               else self._decode_text(raw, oid))
                rows.append(tuple(row))
            elif typ == b"C":
                tag = body.rstrip(b"\x00").decode()
            elif typ == b"E":
                err = PgError(self._err_fields(body))
            elif typ == b"Z":
                if err is not None:
                    raise err
                return [c[0] for c in cols], rows, tag
            # 1/2/3/n/s (parse/bind/close complete, nodata,
            # suspended), N: skipped

    # -- queries -----------------------------------------------------

    def query(self, sql: str):
        """Simple-protocol query -> (names, rows, tag)."""
        self._send(b"Q", sql.encode() + b"\x00")
        return self._collect()

    def query_binary(self, sql: str, params: list | None = None,
                     param_oids: list | None = None):
        """Extended protocol: Parse/Bind/Execute with BINARY result
        format requested for every column."""
        params = params or []
        oids = param_oids or [OID_INT8 if isinstance(p, int)
                              else 0 for p in params]
        parse = bytearray(b"\x00" + sql.encode() + b"\x00")
        parse += struct.pack("!H", len(oids))
        for o in oids:
            parse += struct.pack("!I", o)
        self._send(b"P", bytes(parse))
        bind = bytearray(b"\x00\x00")       # unnamed portal + stmt
        bind += struct.pack("!H", 1) + struct.pack("!H", 0)  # text params
        bind += struct.pack("!H", len(params))
        for p in params:
            if p is None:
                bind += struct.pack("!i", -1)
            else:
                t = str(p).encode()
                bind += struct.pack("!i", len(t)) + t
        bind += struct.pack("!HH", 1, 1)    # ALL results binary
        self._send(b"B", bytes(bind))
        self._send(b"D", b"P\x00")
        self._send(b"E", b"\x00" + struct.pack("!i", 0))
        self._send(b"S")
        return self._collect()

    def close(self):
        try:
            self._send(b"X")
        except OSError:
            pass
        self.sock.close()
