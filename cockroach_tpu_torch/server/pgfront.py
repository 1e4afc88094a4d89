"""Selector-driven pgwire front end: 10K sessions, threads ~ active.

The thread-per-connection front door (`pgwire._ThreadServer`) costs a
~8MB-stack thread per session whether or not it is doing anything — a
production front door parks tens of thousands of mostly-idle
connections. This module is the Theseus framing applied to scheduler
resources: never let an idle resource (a parked session) hold a scarce
one (a thread / GIL quantum).

Architecture — one event-loop thread owns every socket:

- ``selectors.DefaultSelector`` (epoll on Linux) watches the listener
  and every connection, all non-blocking. The loop's only jobs are
  accept, ``recv`` into per-session byte buffers, frame parsing, and
  timer sweeps — it NEVER executes SQL, authenticates, flushes
  replies, or takes an engine lock.
- Complete frames land in a per-session queue. A session with queued
  frames and no worker gets ONE — workers come from a bounded
  ``ThreadPoolExecutor``, so thread count tracks *active statements*,
  not connections; an idle session's cost is one socket + one
  ``_Session`` record (O(1) memory, zero threads).
- Workers drive the exact same ``_Conn.process`` handlers as the
  thread front end, writing replies straight to the socket through a
  select-backed ``sendall`` that tolerates the non-blocking fd. One
  worker per session at a time, so reply ordering is preserved and
  the two front ends are bit-identical on the wire (the A/B lever).
- Multi-message operations that must read mid-handler (SCRAM's two
  SASL legs, cleartext password, COPY's data stream) block their
  WORKER on the session's frame queue via ``_QueueReader`` — never
  the loop.
- Sweeps: a connection that has not completed startup within
  ``server.startup_deadline_seconds`` is closed (slow-loris can't pin
  the front door); a session idle outside a transaction longer than
  ``server.idle_session_timeout`` is retired. Half-closed sockets
  (RST, FIN) surface as EOF/errors on the loop and tear down through
  one idempotent path — no handler thread left behind.

The port's copy of cockroach_tpu/server/pgfront.py.
"""

from __future__ import annotations

import collections
import os
import select as _select
import selectors
import socket
import struct
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from . import pgwire as _pg

# GIL switch quantum to restore when sql.exec.switch_interval is 0
# (captured before anything changes it)
_DEFAULT_SWITCH_INTERVAL = sys.getswitchinterval()

# a worker blocked on a mid-handler read (COPY data, SASL leg) gives
# up after this long without a frame; the startup/idle sweeps usually
# retire the session first
_INLINE_READ_TIMEOUT = 3600.0

_RECV_CHUNK = 1 << 16


def apply_switch_interval(settings) -> None:
    """Arm sys.setswitchinterval from sql.exec.switch_interval
    (process-global — the GIL has one quantum; 0 restores the
    interpreter default). A sub-default quantum lets OLTP batch
    windows close while an analytic statement holds the GIL."""
    try:
        v = float(settings.get("sql.exec.switch_interval"))
    except Exception:
        return
    try:
        sys.setswitchinterval(v if v > 0 else _DEFAULT_SWITCH_INTERVAL)
    except (ValueError, OSError):
        pass


def _nb_sendall(sock: socket.socket, data: bytes,
                timeout: float = 30.0) -> None:
    """sendall for a non-blocking socket: spin send(), parking on
    select(write) when the kernel buffer is full. Worker-thread only —
    the event loop never writes more than a 1-byte startup reply."""
    view = memoryview(data)
    while view.nbytes:
        try:
            n = sock.send(view)
        except (BlockingIOError, InterruptedError):
            _, wl, _ = _select.select([], [sock], [], timeout)
            if not wl:
                raise ConnectionError("pgwire send timed out")
            continue
        view = view[n:]


class _QueueReader:
    """Drop-in for pgwire._Reader whose message() pops the session's
    frame queue (fed by the event loop) instead of recv()ing. Lets
    handlers that read mid-operation (COPY, SASL) run unchanged on
    worker threads."""

    def __init__(self, sess: "_Session"):
        self._sess = sess

    def message(self):
        s = self._sess
        with s.lk:
            while not s.frames:
                if s.eof or s.closed:
                    raise ConnectionError("client disconnected")
                if not s.cv.wait(timeout=_INLINE_READ_TIMEOUT):
                    raise ConnectionError("inline read timed out")
            return s.frames.popleft()

    def startup(self):  # pragma: no cover - loop owns startup framing
        raise _pg.ProtocolError("startup packets are parsed by the "
                                "reactor loop")


class _Session:
    """Per-connection reactor state: O(1) while idle."""

    __slots__ = ("sock", "fd", "buf", "framing", "frames", "lk", "cv",
                 "active", "eof", "closed", "ready", "t_conn", "t_last",
                 "conn")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.fd = sock.fileno()
        self.buf = bytearray()
        self.framing = "startup"       # -> "typed" after PROTO_V3
        self.frames: collections.deque = collections.deque()
        self.lk = threading.Lock()
        self.cv = threading.Condition(self.lk)
        self.active = False            # a worker owns this session now
        self.eof = False
        self.closed = False
        self.ready = False             # startup + auth completed
        self.t_conn = time.monotonic()
        self.t_last = self.t_conn
        self.conn = None               # pgwire._Conn


class ReactorServer:
    """The selector front end behind the PgServer facade."""

    def __init__(self, parent, host: str, port: int,
                 max_workers: int | None = None):
        self.parent = parent
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, port))
        self._lsock.listen(512)
        self._lsock.setblocking(False)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._lsock, selectors.EVENT_READ, None)
        self._wake_r, self._wake_w = os.pipe()
        os.set_blocking(self._wake_r, False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._sessions: dict[int, _Session] = {}
        # sockets retired by workers, pending loop-side unregister +
        # close (fd lifecycle stays with the loop: closing a watched
        # fd from another thread races the selector)
        self._dead: collections.deque = collections.deque()
        self._stopping = False
        self._thread: threading.Thread | None = None
        if max_workers is None:
            max_workers = max(8, min(32, (os.cpu_count() or 4) * 2))
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="pgfront-worker")
        self._t_sweep = 0.0
        m = parent.engine.metrics
        m.func_gauge(
            "pgwire.sessions.connected",
            lambda: len(self._sessions),
            "pgwire sessions the reactor currently owns")
        m.func_gauge(
            "pgwire.sessions.active", self._count_active,
            "reactor sessions a worker thread is serving right now")
        m.func_gauge(
            "pgwire.sessions.idle",
            lambda: max(0, len(self._sessions) - self._count_active()),
            "reactor sessions parked with no thread (connected-active)")
        self._m_lag = m.histogram(
            "pgwire.reactor.loop_lag_seconds",
            "event-loop wake-batch processing time (s): how long a "
            "newly readable socket can wait behind one loop pass")

    def _count_active(self) -> int:
        try:
            return sum(1 for s in list(self._sessions.values())
                       if s.active)
        except RuntimeError:  # dict resized mid-scrape; scrape-only
            return 0

    @property
    def addr(self):
        return self._lsock.getsockname()[:2]

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="pgfront-loop", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stopping = True
        self._wakeup()
        if self._thread:
            self._thread.join(timeout=5)
        self._pool.shutdown(wait=False)
        for s in list(self._sessions.values()):
            with s.lk:
                s.eof = True
                s.closed = True
                s.cv.notify_all()
            try:
                s.sock.close()
            except OSError:
                pass
        self._sessions.clear()
        try:
            self._sel.close()
        except Exception:
            pass
        try:
            self._lsock.close()
        except OSError:
            pass
        os.close(self._wake_r)
        os.close(self._wake_w)

    def _wakeup(self):
        try:
            os.write(self._wake_w, b"x")
        except OSError:
            pass

    # -- event loop (the only thread that touches the selector) --------------

    def _loop(self):
        sel = self._sel
        while not self._stopping:
            try:
                events = sel.select(timeout=0.25)
            except OSError:
                if self._stopping:
                    return
                continue
            t0 = time.monotonic()
            self._reap_dead()
            for key, _mask in events:
                if self._stopping:
                    return
                if key.fileobj is self._lsock:
                    self._accept()
                elif key.fd == self._wake_r:
                    try:
                        os.read(self._wake_r, 4096)
                    except OSError:
                        pass
                else:
                    sess = self._sessions.get(key.fd)
                    if sess is not None:
                        self._readable(sess)
            if events:
                self._m_lag.observe(time.monotonic() - t0)
            self._sweep()

    def _reap_dead(self):
        while self._dead:
            sock = self._dead.popleft()
            try:
                self._sel.unregister(sock)
            except (KeyError, ValueError, OSError):
                pass
            try:
                sock.close()
            except OSError:
                pass

    def _accept(self):
        while True:
            try:
                sock, _addr = self._lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            try:
                sock.setblocking(False)
                sock.setsockopt(socket.IPPROTO_TCP,
                                socket.TCP_NODELAY, 1)
            except OSError:
                try:
                    sock.close()
                except OSError:
                    pass
                continue
            sess = _Session(sock)
            sess.conn = self.parent.new_conn(
                sock, reader=_QueueReader(sess),
                sendall=lambda d, _s=sock: _nb_sendall(_s, d))
            self._sessions[sess.fd] = sess
            self._sel.register(sock, selectors.EVENT_READ, sess)

    def _readable(self, sess: _Session):
        if sess.closed:
            return
        try:
            data = sess.sock.recv(_RECV_CHUNK)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            # RST / half-close from the client side: same teardown as
            # an orderly FIN — never a leaked handler thread
            self._retire(sess)
            return
        if not data:
            self._retire(sess)
            return
        sess.t_last = time.monotonic()
        sess.buf += data
        try:
            self._parse(sess)
        except _pg.ProtocolError:
            self._retire(sess)

    # -- frame parsing (loop thread) ------------------------------------------

    def _parse(self, sess: _Session):
        buf = sess.buf
        while True:
            if sess.closed:
                return
            if sess.framing == "startup":
                if len(buf) < 4:
                    return
                (length,) = struct.unpack_from("!I", buf, 0)
                if length < 8 or length > 1 << 20:
                    raise _pg.ProtocolError(
                        f"bad startup length {length}")
                if len(buf) < length:
                    return
                body = bytes(buf[4:length])
                del buf[:length]
                if not self._startup_frame(sess, body):
                    return
            else:
                if len(buf) < 5:
                    return
                typ = bytes(buf[0:1])
                (length,) = struct.unpack_from("!I", buf, 1)
                if length < 4 or length > 1 << 28:
                    raise _pg.ProtocolError(
                        f"bad message length {length}")
                if len(buf) < 1 + length:
                    return
                body = bytes(buf[5:1 + length])
                del buf[:1 + length]
                self._enqueue(sess, typ, body)

    def _startup_frame(self, sess: _Session, body: bytes) -> bool:
        """One startup-phase packet; False = stop parsing this buffer
        (session closed or handed off)."""
        (code,) = struct.unpack_from("!I", body, 0)
        if code == _pg.SSL_REQUEST and self.parent.tls is not None:
            self._tls_handoff(sess)
            return False
        if code in (_pg.SSL_REQUEST, _pg.GSSENC_REQUEST):
            # deny and let the client retry cleartext on this conn; a
            # 1-byte reply into an empty socket buffer cannot
            # meaningfully block (anything else retires the conn)
            try:
                sess.sock.send(b"N")
            except OSError:
                self._retire(sess)
                return False
            return True
        if code == _pg.CANCEL_REQUEST:
            self._retire(sess)
            return False
        if code != _pg.PROTO_V3:
            # FATAL protocol error composed loop-side; single send,
            # best effort, then retire
            w = _pg._Writer(sess.sock, sendall=lambda d: None)
            w.error(f"unsupported protocol {code >> 16}."
                    f"{code & 0xFFFF}", code="0A000", severity="FATAL")
            try:
                sess.sock.send(bytes(w._buf))
            except OSError:
                pass
            self._retire(sess)
            return False
        params = {}
        parts = body[4:].split(b"\x00")
        for k, v in zip(parts[::2], parts[1::2]):
            if k:
                params[k.decode()] = v.decode()
        sess.framing = "typed"
        with sess.lk:
            sess.active = True
        self._pool.submit(self._run_startup, sess, params)
        return True

    def _enqueue(self, sess: _Session, typ: bytes, body: bytes):
        submit = False
        with sess.lk:
            sess.frames.append((typ, body))
            sess.cv.notify_all()
            if sess.ready and not sess.active:
                sess.active = True
                submit = True
        if submit:
            self._pool.submit(self._drain, sess)

    # -- worker side ----------------------------------------------------------

    def _run_startup(self, sess: _Session, params: dict):
        try:
            ok = sess.conn.finish_startup(params)
        except (ConnectionError, _pg.ProtocolError, OSError):
            ok = False
        except Exception:
            ok = False
        if not ok:
            self._teardown(sess)
            return
        sess.ready = True
        self._drain(sess)

    def _drain(self, sess: _Session):
        """Serve queued frames until the queue runs dry, then hand the
        session back to the loop (idle = no thread). Exactly one
        drain per session at a time (sess.active)."""
        while True:
            with sess.lk:
                if sess.closed:
                    sess.active = False
                    return
                if not sess.frames:
                    sess.active = False
                    if sess.eof:
                        break
                    return
                typ, body = sess.frames.popleft()
            try:
                alive = sess.conn.process(typ, body)
            except (ConnectionError, _pg.ProtocolError, OSError):
                alive = False
            except Exception:
                alive = False
            if not alive:
                break
        self._teardown(sess)

    def _teardown(self, sess: _Session):
        """Idempotent retirement: rollback any open txn, then hand the
        fd back to the loop for unregister+close. Runs on workers —
        rollback takes engine locks the loop must never touch."""
        with sess.lk:
            if sess.closed:
                return
            sess.closed = True
            sess.eof = True
            sess.cv.notify_all()
        conn = sess.conn
        if conn is not None and conn.session.txn is not None:
            try:
                conn.session.txn.rollback()
            except Exception:
                pass
        self._sessions.pop(sess.fd, None)
        self._dead.append(sess.sock)
        self._wakeup()

    # -- loop-side retirement & sweeps ----------------------------------------

    def _retire(self, sess: _Session):
        """Loop-side: stop watching now; delegate the engine-touching
        teardown to a worker unless one is already serving the session
        (it will observe eof and tear down itself)."""
        try:
            self._sel.unregister(sess.sock)
        except (KeyError, ValueError, OSError):
            pass
        with sess.lk:
            if sess.closed:
                return
            sess.eof = True
            sess.cv.notify_all()
            busy = sess.active
            if not busy:
                sess.active = True
        if not busy:
            self._pool.submit(self._teardown, sess)

    def _sweep(self):
        now = time.monotonic()
        if now - self._t_sweep < 0.25:
            return
        self._t_sweep = now
        try:
            stg = self.parent.engine.settings
            deadline = float(stg.get("server.startup_deadline_seconds"))
            idle = float(stg.get("server.idle_session_timeout"))
        except Exception:
            return
        if deadline <= 0 and idle <= 0:
            return
        for sess in list(self._sessions.values()):
            if sess.closed:
                continue
            if not sess.ready:
                # slow-loris guard: startup packet + auth must finish
                # inside the deadline or the conn is cut loose
                if deadline > 0 and now - sess.t_conn > deadline:
                    self._retire(sess)
                continue
            if idle > 0 and not sess.active and not sess.frames:
                conn = sess.conn
                in_txn = conn is not None and conn.session.in_txn
                if not in_txn and now - sess.t_last > idle:
                    self._retire(sess)

    # -- TLS ------------------------------------------------------------------

    def _tls_handoff(self, sess: _Session):
        """SSLRequest with TLS armed: this connection leaves the
        reactor and gets a dedicated thread running the blocking
        handlers over the wrapped socket (TLS framing on a
        non-blocking fd is not worth owning for a handful of
        encrypted conns; the 10K-session story is the plaintext
        pool behind a terminating proxy)."""
        try:
            self._sel.unregister(sess.sock)
        except (KeyError, ValueError, OSError):
            pass
        self._sessions.pop(sess.fd, None)
        sess.closed = True
        sock = sess.sock
        parent = self.parent

        def run():
            conn = None
            try:
                sock.setblocking(True)
                sock.sendall(b"S")
                tsock = parent.tls.wrap_socket(sock, server_side=True)
                conn = parent.new_conn(tsock)
                conn.serve()
            except (ConnectionError, _pg.ProtocolError, OSError):
                pass
            finally:
                if conn is not None and conn.session.txn is not None:
                    try:
                        conn.session.txn.rollback()
                    except Exception:
                        pass
                try:
                    sock.close()
                except OSError:
                    pass

        threading.Thread(target=run, name="pgfront-tls",
                         daemon=True).start()
