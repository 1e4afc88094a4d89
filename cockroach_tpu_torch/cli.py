"""Command-line interface: start / sql / demo / workload / cert / version.

The port of cockroach_tpu/cli.py (the reference's cobra CLI,
pkg/cli/start.go:395 runStart; pkg/cli/clisqlshell for the shell;
pkg/cli/demo.go). Run as ``python -m cockroach_tpu_torch <command>``.
``start``, ``demo`` and ``workload`` run their engine on the CUDA card
(``--device cuda``, the default; without a card they raise) unless
``--device`` names another, such as ``cpu``. Cluster mode (``start
--kv-addr/--join/--bootstrap``), ``node`` and ``debug`` need the
cluster fabric, which is not ported yet: they raise.

The embedded ``PgClient`` is a from-scratch minimal pgwire v3 frontend
(startup, simple query, text results, COPY, extended protocol), so the
shell needs no driver; tests drive the server through it too.
"""

from __future__ import annotations

import argparse
import socket
import struct
import sys

from . import __version__

DEFAULT_PORT = 26257


class PgError(Exception):
    def __init__(self, fields: dict):
        self.fields = fields
        super().__init__(fields.get("M", "unknown error"))

    @property
    def sqlstate(self) -> str:
        return self.fields.get("C", "XX000")


class PgClient:
    """Minimal pgwire v3 frontend for the simple query protocol."""

    def __init__(self, host: str, port: int, user: str = "root",
                 database: str = "defaultdb", timeout: float = 30.0,
                 password: str | None = None, sslmode: str = "disable"):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.params: dict[str, str] = {}
        self.txn_status = b"I"
        self.password = password
        if sslmode != "disable":
            # SSLRequest -> 'S' -> wrap (libpq's sslmode=require; no
            # CA verification — the bundled certs are self-signed)
            import ssl
            self.sock.sendall(struct.pack("!II", 8, 80877103))
            resp = self.sock.recv(1)
            if resp != b"S":
                if sslmode == "require":
                    raise PgError({"M": "server does not support TLS"})
            else:
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
                self.sock = ctx.wrap_socket(self.sock,
                                            server_hostname=host)
        params = (f"user\x00{user}\x00database\x00{database}\x00\x00"
                  .encode())
        body = struct.pack("!I", 196608) + params
        self.sock.sendall(struct.pack("!I", len(body) + 4) + body)
        self._wait_ready()

    # -- framing -------------------------------------------------------------
    def _exactly(self, n: int) -> bytes:
        chunks = []
        while n:
            b = self.sock.recv(n)
            if not b:
                raise ConnectionError("server disconnected")
            chunks.append(b)
            n -= len(b)
        return b"".join(chunks)

    def _msg(self) -> tuple[bytes, bytes]:
        typ = self._exactly(1)
        (ln,) = struct.unpack("!I", self._exactly(4))
        return typ, self._exactly(ln - 4)

    @staticmethod
    def _err_fields(body: bytes) -> dict:
        fields = {}
        off = 0
        while off < len(body) and body[off:off + 1] != b"\x00":
            code = body[off:off + 1].decode()
            end = body.index(b"\x00", off + 1)
            fields[code] = body[off + 1:end].decode()
            off = end + 1
        return fields

    def _wait_ready(self):
        err = None
        while True:
            typ, body = self._msg()
            if typ == b"Z":
                self.txn_status = body
                if err:
                    raise PgError(err)
                return
            if typ == b"E":
                err = self._err_fields(body)
                if err.get("S") == "FATAL":
                    raise PgError(err)  # no ReadyForQuery is coming
            elif typ == b"S":
                k, v = body.split(b"\x00")[:2]
                self.params[k.decode()] = v.decode()
            elif typ == b"R":
                (code,) = struct.unpack_from("!I", body, 0)
                if code == 3:  # cleartext password requested
                    pw = (self.password or "").encode() + b"\x00"
                    self.sock.sendall(
                        b"p" + struct.pack("!I", len(pw) + 4) + pw)
            # K (key data), N (notice): nothing to do

    @staticmethod
    def _decode_row_desc(body) -> list[str]:
        (n,) = struct.unpack_from("!H", body, 0)
        off = 2
        names = []
        for _ in range(n):
            end = body.index(b"\x00", off)
            names.append(body[off:end].decode())
            off = end + 1 + 18
        return names

    @staticmethod
    def _decode_data_row(body) -> tuple:
        (n,) = struct.unpack_from("!H", body, 0)
        off = 2
        row = []
        for _ in range(n):
            (ln,) = struct.unpack_from("!i", body, off)
            off += 4
            if ln < 0:
                row.append(None)
            else:
                row.append(body[off:off + ln].decode())
                off += ln
        return tuple(row)

    # -- queries -------------------------------------------------------------
    def query(self, sql: str):
        """Run one simple-protocol Query; returns (names, rows, tags)."""
        payload = sql.encode() + b"\x00"
        self.sock.sendall(b"Q" + struct.pack("!I", len(payload) + 4)
                          + payload)
        names: list[str] = []
        rows: list[tuple] = []
        tags: list[str] = []
        err = None
        while True:
            typ, body = self._msg()
            if typ == b"T":
                names = self._decode_row_desc(body)
            elif typ == b"D":
                rows.append(self._decode_data_row(body))
            elif typ == b"C":
                tags.append(body.rstrip(b"\x00").decode())
            elif typ == b"I":
                tags.append("")
            elif typ == b"E":
                err = self._err_fields(body)
            elif typ == b"Z":
                self.txn_status = body
                if err:
                    raise PgError(err)
                return names, rows, tags

    # -- COPY (text format) --------------------------------------------------
    def copy_in(self, sql: str, lines: list[str]) -> str:
        """COPY ... FROM STDIN: send text-format rows, return the
        command tag ('COPY n')."""
        payload = sql.encode() + b"\x00"
        self.sock.sendall(b"Q" + struct.pack("!I", len(payload) + 4)
                          + payload)
        typ, body = self._msg()
        if typ == b"E":
            err = self._err_fields(body)
            self._wait_ready()
            raise PgError(err)
        if typ != b"G":
            raise PgError({"M": f"expected CopyInResponse, got {typ}"})
        data = ("".join(line + "\n" for line in lines)).encode()
        self._send(b"d", data)
        self._send(b"c", b"")
        tag = None
        err = None
        while True:
            typ, body = self._msg()
            if typ == b"C":
                tag = body.rstrip(b"\x00").decode()
            elif typ == b"E":
                err = self._err_fields(body)
            elif typ == b"Z":
                self.txn_status = body
                if err:
                    raise PgError(err)
                return tag

    def copy_out(self, sql: str) -> list[str]:
        """COPY ... TO STDOUT: returns the text-format lines."""
        payload = sql.encode() + b"\x00"
        self.sock.sendall(b"Q" + struct.pack("!I", len(payload) + 4)
                          + payload)
        lines: list[str] = []
        err = None
        while True:
            typ, body = self._msg()
            if typ == b"d":
                lines.extend(body.decode().splitlines())
            elif typ == b"E":
                err = self._err_fields(body)
            elif typ == b"Z":
                self.txn_status = body
                if err:
                    raise PgError(err)
                return lines
            # H (CopyOutResponse), c (CopyDone), C (tag): skip

    # -- extended protocol ---------------------------------------------------
    def _send(self, typ: bytes, payload: bytes):
        self.sock.sendall(typ + struct.pack("!I", len(payload) + 4)
                          + payload)

    def extended_query(self, sql: str, params=(), param_oids=(),
                       binary=False, max_rows: int = 0):
        """Parse/Bind/Describe/Execute/Sync round trip with parameters.

        params: python values (None|int|float|bool|str); binary=True
        sends int/float/bool in binary wire format (needs param_oids).
        Returns (param_oids_described, names, rows, completed) —
        completed False means the portal suspended at max_rows."""
        # Parse
        p = b"\x00" + sql.encode() + b"\x00"
        p += struct.pack("!H", len(param_oids))
        for o in param_oids:
            p += struct.pack("!I", o)
        self._send(b"P", p)
        # Describe statement (parameter oids come back)
        self._send(b"D", b"S\x00")
        # Bind
        b = b"\x00\x00"   # unnamed portal, unnamed stmt
        if binary:
            b += struct.pack("!H", len(params))
            b += b"".join(struct.pack("!H", 1) for _ in params)
        else:
            b += struct.pack("!H", 0)
        b += struct.pack("!H", len(params))
        for i, v in enumerate(params):
            if v is None:
                b += struct.pack("!i", -1)
                continue
            if binary:
                oid = param_oids[i] if i < len(param_oids) else 0
                if oid == 20:
                    raw = struct.pack("!q", int(v))
                elif oid == 701:
                    raw = struct.pack("!d", float(v))
                elif oid == 16:
                    raw = b"\x01" if v else b"\x00"
                else:
                    raw = str(v).encode()
            else:
                raw = ("t" if v is True else "f" if v is False
                       else str(v)).encode()
            b += struct.pack("!I", len(raw)) + raw
        b += struct.pack("!H", 0)   # result-format codes: all text
        self._send(b"B", b)
        # Execute + Sync
        self._send(b"E", b"\x00" + struct.pack("!i", max_rows))
        self._send(b"S", b"")
        oids_desc: list[int] = []
        names: list[str] = []
        rows: list[tuple] = []
        completed = True
        err = None
        while True:
            typ, body = self._msg()
            if typ == b"t":
                (n,) = struct.unpack_from("!H", body, 0)
                oids_desc = [struct.unpack_from("!I", body, 2 + 4 * i)[0]
                             for i in range(n)]
            elif typ == b"T":
                names = self._decode_row_desc(body)
            elif typ == b"D":
                rows.append(self._decode_data_row(body))
            elif typ == b"s":
                completed = False
            elif typ == b"E":
                err = self._err_fields(body)
            elif typ == b"Z":
                self.txn_status = body
                if err:
                    raise PgError(err)
                return oids_desc, names, rows, completed

    def close(self):
        try:
            self.sock.sendall(b"X" + struct.pack("!I", 4))
        except OSError:
            pass
        self.sock.close()


# -- commands ----------------------------------------------------------------

class NotPortedError(RuntimeError):
    pass


def _not_ported(what: str):
    raise NotPortedError(f"{what}: cluster mode is not yet ported")


def _device(args):
    """The engine's device: None for the card (Engine raises when there
    is none), else what ``--device`` names."""
    return None if args.device == "cuda" else args.device


def _parse_addr(addr: str) -> tuple[str, int]:
    if ":" in addr:
        host, port = addr.rsplit(":", 1)
        return host or "127.0.0.1", int(port)
    return addr, DEFAULT_PORT


def cmd_start(args) -> int:
    from .server import Node, NodeConfig

    if args.kv_addr or args.join or args.bootstrap:
        _not_ported("start --kv-addr/--join/--bootstrap")
    host, port = _parse_addr(args.listen_addr)
    node = Node(NodeConfig(listen_host=host, listen_port=port,
                           node_id=args.node_id, device=_device(args)))
    node.start()
    h, p = node.sql_addr
    print(f"cockroach-tpu node starting\n"
          f"version:     {__version__}\n"
          f"device:      {node.engine.device}\n"
          f"sql:         postgresql://root@{h}:{p}/defaultdb\n"
          f"status:      serving", flush=True)
    try:
        import threading
        threading.Event().wait()  # serve until interrupted
    except KeyboardInterrupt:
        print("\ninterrupt: shutting down", flush=True)
    node.stop()
    return 0


def _shell(client: PgClient) -> int:
    print(f"# cockroach-tpu sql shell (v{__version__}); "
          f"\\q to quit", flush=True)
    buf = ""
    while True:
        try:
            prompt = "> " if not buf else "... "
            line = input(prompt)
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if line.strip() in ("\\q", "exit", "quit"):
            break
        buf += line + "\n"
        if not buf.strip() or not buf.rstrip().endswith(";"):
            continue
        sql, buf = buf, ""
        try:
            names, rows, tags = client.query(sql)
        except PgError as e:
            print(f"ERROR: {e} (SQLSTATE {e.sqlstate})", flush=True)
            continue
        except ConnectionError:
            print("connection lost", flush=True)
            return 1
        _print_result(names, rows, tags)
    client.close()
    return 0


def _print_result(names, rows, tags):
    if names:
        widths = [max(len(n), *(len(str(r[i])) if r[i] is not None else 4
                                for r in rows)) if rows else len(n)
                  for i, n in enumerate(names)]
        print("  ".join(n.ljust(w) for n, w in zip(names, widths)))
        print("  ".join("-" * w for w in widths))
        for r in rows:
            print("  ".join(
                ("NULL" if v is None else str(v)).ljust(w)
                for v, w in zip(r, widths)))
    for t in tags:
        print(t, flush=True)


def cmd_sql(args) -> int:
    host, port = _parse_addr(args.url)
    try:
        client = PgClient(host, port)
    except OSError as e:
        print(f"cannot connect to {host}:{port}: {e}", file=sys.stderr)
        return 1
    if args.execute:
        rc = 0
        for sql in args.execute:
            try:
                names, rows, tags = client.query(sql)
                _print_result(names, rows, tags)
            except PgError as e:
                print(f"ERROR: {e} (SQLSTATE {e.sqlstate})",
                      file=sys.stderr)
                rc = 1
        client.close()
        return rc
    return _shell(client)


def cmd_demo(args) -> int:
    from .server import Node, NodeConfig

    print(f"# loading TPC-H sf={args.sf} demo data ...", flush=True)
    node = Node(NodeConfig(load_tpch_sf=args.sf,
                           device=_device(args))).start()
    try:
        h, p = node.sql_addr
        print(f"# demo node at postgresql://root@{h}:{p}/defaultdb",
              flush=True)
        return _shell(PgClient(h, p))
    finally:
        node.stop()


def cmd_workload(args) -> int:
    import json

    from .exec.engine import Engine
    from .workload import WORKLOADS

    eng = Engine(device=_device(args))
    cls = WORKLOADS[args.name]
    wl = cls(eng.kv if args.name == "kv" else eng)
    wl.setup()
    out = wl.run(steps=args.steps)
    print(json.dumps(out, default=str))
    return 0


def cmd_cert(args) -> int:
    """Create a self-signed CA + node certificate pair (the
    `cockroach cert create-ca` / `create-node` workflow, pkg/cli/cert.go
    + pkg/security — one subcommand here since the CA exists only to
    sign the node cert)."""
    import os
    import subprocess

    d = args.certs_dir
    os.makedirs(d, exist_ok=True)
    ca_key = os.path.join(d, "ca.key")
    ca_crt = os.path.join(d, "ca.crt")
    node_key = os.path.join(d, "node.key")
    node_crt = os.path.join(d, "node.crt")
    hosts = args.host or ["localhost", "127.0.0.1"]
    san = ",".join(
        ("IP:" if h.replace(".", "").isdigit() else "DNS:") + h
        for h in hosts)
    run = lambda *cmd: subprocess.run(  # noqa: E731
        cmd, check=True, capture_output=True)
    run("openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
        "-keyout", ca_key, "-out", ca_crt, "-days", "3650",
        "-subj", "/CN=cockroach-tpu CA")
    run("openssl", "req", "-newkey", "rsa:2048", "-nodes",
        "-keyout", node_key, "-out", os.path.join(d, "node.csr"),
        "-subj", "/CN=node")
    # SAN extension via a temp extfile (openssl x509 -req needs it)
    ext = os.path.join(d, "san.ext")
    with open(ext, "w") as f:
        f.write(f"subjectAltName={san}\n")
    run("openssl", "x509", "-req", "-in", os.path.join(d, "node.csr"),
        "-CA", ca_crt, "-CAkey", ca_key, "-CAcreateserial",
        "-out", node_crt, "-days", "3650", "-extfile", ext)
    os.remove(os.path.join(d, "node.csr"))
    os.remove(ext)
    os.chmod(node_key, 0o600)
    os.chmod(ca_key, 0o600)
    print(f"certificates written to {d}: ca.crt node.crt node.key")
    return 0


def main(argv=None) -> int:
    from .workload import WORKLOADS

    ap = argparse.ArgumentParser(
        prog="cockroach-tpu",
        description="SQL engine on PyTorch and CUDA, served over pgwire")
    sub = ap.add_subparsers(dest="command")

    def device_arg(p):
        p.add_argument("--device", default="cuda",
                       help="the engine's device (default cuda: raises "
                       "without a card; cpu runs the plain PyTorch path)")

    p_start = sub.add_parser("start", help="start a node")
    p_start.add_argument("--listen-addr", default=f"127.0.0.1:{DEFAULT_PORT}")
    p_start.add_argument("--node-id", type=int, default=1)
    p_start.add_argument("--kv-addr", default=None,
                         help="cluster mode (not yet ported)")
    p_start.add_argument("--bootstrap", action="store_true",
                         help="cluster mode (not yet ported)")
    p_start.add_argument("--join", action="append", default=None,
                         metavar="NID@HOST:PORT",
                         help="cluster mode (not yet ported)")
    device_arg(p_start)
    p_start.set_defaults(fn=cmd_start)

    p_sql = sub.add_parser("sql", help="open a SQL shell")
    p_sql.add_argument("--url", default=f"127.0.0.1:{DEFAULT_PORT}",
                       help="host:port of a running node")
    p_sql.add_argument("-e", "--execute", action="append",
                       help="run statement(s) and exit")
    p_sql.set_defaults(fn=cmd_sql)

    p_demo = sub.add_parser("demo", help="in-memory node + shell with "
                                         "TPC-H data")
    p_demo.add_argument("--sf", type=float, default=0.01)
    device_arg(p_demo)
    p_demo.set_defaults(fn=cmd_demo)

    p_wl = sub.add_parser("workload", help="run a load generator")
    p_wl.add_argument("name", choices=sorted(WORKLOADS))
    p_wl.add_argument("--steps", type=int, default=100)
    device_arg(p_wl)
    p_wl.set_defaults(fn=cmd_workload)

    for name in ("node", "debug"):
        p = sub.add_parser(name, help="cluster introspection (not yet "
                                      "ported)")
        p.add_argument("what", nargs="*")
        p.add_argument("--url", default=None)
        p.set_defaults(fn=lambda a, _n=name: _not_ported(_n))

    p_cert = sub.add_parser("cert", help="create self-signed CA + "
                                         "node TLS certificates")
    p_cert.add_argument("--certs-dir", default="certs")
    p_cert.add_argument("--host", action="append",
                        help="SAN hostnames/IPs (repeatable)")
    p_cert.set_defaults(fn=cmd_cert)

    p_ver = sub.add_parser("version", help="print version")
    p_ver.set_defaults(fn=lambda a: (print(
        f"cockroach-tpu v{__version__} (PyTorch/CUDA, pgwire v3)"), 0)[1])

    args = ap.parse_args(argv)
    if not args.command:
        ap.print_help()
        return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
