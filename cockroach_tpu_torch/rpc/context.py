"""Socket RPC transport: the fabric that lets distributed subsystems
leave one process (cockroach_tpu/rpc/context.py, ported as it stands:
the FaultInjector draws, the codec's bytes and the frame header are
the reference's).

The analogue of the reference's gRPC plumbing (pkg/rpc/context.go:361
creates servers and per-peer connection pools; raft_transport.go and
execinfrapb's FlowStream ride it). Here: one TCP listener per node, a
persistent outbound connection per peer, and length-prefixed framed
messages. Delivery is PULL-based to preserve the deterministic
`deliver_all()` contract of the in-process LocalTransport
(kvserver/transport.py) — incoming messages queue on the receiving
node until its loop drains them — so every subsystem written against
LocalTransport (DistSQL flows, raft harness) runs unchanged over real
sockets.

Wire format: a 4-byte big-endian length + a JSON document; bytes
values are hoisted into a binary section appended after the JSON
(zero-copy for flow chunks; no pickle — payloads from the network are
data, never code).
"""

from __future__ import annotations

import json
import random
import socket
import socketserver
import struct
import threading
import time
from collections import deque
from typing import Callable, Optional

_BYTES_MARK = "__b__"  # JSON placeholder: {"__b__": [offset, length]}


class FaultInjector:
    """Seeded per-peer-pair fault schedule for the socket fabric.

    The SocketTransport face of the in-process ChaosTransport
    (kvserver/transport.py): one injector instance is shared by every
    transport of a test cluster, so ``test_netcluster``-style clusters
    run the same nemesis schedules the raft harness does — drop,
    delay, duplicate, and partition framed messages per (frm, to)
    pair, deterministically from one seed.

    Rules are consulted at SEND time (outbound faults — the moral
    equivalent of the reference's TestingKnobs raft-message filters);
    partitions are additionally enforced at delivery time so frames
    already queued when the partition lands are dropped too.
    """

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # (frm, to) -> {"drop": p, "dup": p, "delay": p, "delay_s": s}
        self._rules: dict[tuple[int, int], dict] = {}
        self._parted: set[frozenset] = set()
        self.dropped = 0
        self.duplicated = 0
        self.delayed = 0

    # -- schedule configuration -----------------------------------------
    def set_rule(self, frm: int, to: int, drop: float = 0.0,
                 dup: float = 0.0, delay: float = 0.0,
                 delay_s: float = 0.05,
                 symmetric: bool = False) -> None:
        rule = {"drop": drop, "dup": dup, "delay": delay,
                "delay_s": delay_s}
        with self._lock:
            self._rules[(frm, to)] = rule
            if symmetric:
                self._rules[(to, frm)] = dict(rule)

    def clear_rules(self) -> None:
        with self._lock:
            self._rules.clear()

    def partition(self, a: int, b: int) -> None:
        with self._lock:
            self._parted.add(frozenset((a, b)))

    def heal(self, a: Optional[int] = None,
             b: Optional[int] = None) -> None:
        with self._lock:
            if a is None:
                self._parted.clear()
            else:
                self._parted.discard(frozenset((a, b)))

    def partitioned(self, a: int, b: int) -> bool:
        return frozenset((a, b)) in self._parted

    # -- the per-frame decision ------------------------------------------
    def plan(self, frm: int, to: int) -> list[float]:
        """Delivery schedule for one frame: a list of delays in
        seconds — ``[]`` drop, ``[0.0]`` deliver now, ``[0.0, 0.0]``
        duplicate, ``[delay_s]`` delay."""
        if self.partitioned(frm, to):
            self.dropped += 1
            return []
        with self._lock:
            rule = self._rules.get((frm, to))
            if rule is None:
                return [0.0]
            r = self._rng.random()
        if r < rule["drop"]:
            self.dropped += 1
            return []
        if r < rule["drop"] + rule["delay"]:
            self.delayed += 1
            return [rule["delay_s"]]
        if r < rule["drop"] + rule["delay"] + rule["dup"]:
            self.duplicated += 1
            return [0.0, 0.0]
        return [0.0]


def encode_msg(msg) -> bytes:
    """JSON + out-of-band binary sections (bytes values anywhere in
    lists/dicts are replaced by offsets into a trailing blob)."""
    blob = bytearray()

    def enc(v):
        if isinstance(v, (bytes, bytearray)):
            off = len(blob)
            blob.extend(v)
            return {_BYTES_MARK: [off, len(v)]}
        if isinstance(v, dict):
            return {k: enc(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [enc(x) for x in v]
        return v

    head = json.dumps(enc(msg)).encode()
    return struct.pack("!II", len(head), len(blob)) + head + bytes(blob)


def decode_msg(raw: bytes):
    hlen, _blen = struct.unpack_from("!II", raw, 0)
    head = json.loads(raw[8:8 + hlen].decode())
    blob = raw[8 + hlen:]

    def dec(v):
        if isinstance(v, dict):
            if set(v.keys()) == {_BYTES_MARK}:
                off, ln = v[_BYTES_MARK]
                return blob[off:off + ln]
            return {k: dec(x) for k, x in v.items()}
        if isinstance(v, list):
            return [dec(x) for x in v]
        return v

    return dec(head)


class SocketTransport:
    """LocalTransport-compatible transport over TCP sockets.

    One instance per node process. ``register`` installs the local
    handler; ``connect`` records a peer's address; ``send`` delivers
    locally or ships a frame to the peer's listener (whose transport
    queues it); ``deliver_all`` drains this node's inbound queue.
    """

    is_async = True  # consumers poll with a deadline, not spin-once

    def __init__(self, node_id: int, host: str = "127.0.0.1",
                 port: int = 0,
                 injector: Optional[FaultInjector] = None):
        self.node_id = node_id
        self._handlers: dict[int, Callable] = {}
        self._queue: deque = deque()
        self._qlock = threading.Lock()
        self._peers: dict[int, tuple[str, int]] = {}
        self._conns: dict[int, socket.socket] = {}
        self._clock = threading.Lock()
        # fault injection: peers this node is partitioned from —
        # frames to AND from them are dropped (the SocketTransport
        # face of LocalTransport.partition; netcluster partition
        # tests use it to split real fabrics)
        self._parted: set[int] = set()
        # seeded nemesis schedule shared by every transport of a test
        # cluster: drop/delay/duplicate/partition per peer-pair
        self.injector = injector
        self._delayed: list = []     # (due_monotonic, to, msg)
        self.sent = 0
        self.delivered = 0
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                sock = self.request
                try:
                    while True:
                        hdr = _exactly(sock, 12)
                        if hdr is None:
                            return
                        frm, ln = struct.unpack("!IQ", hdr)
                        raw = _exactly(sock, ln)
                        if raw is None:
                            return
                        to_and_msg = decode_msg(raw)
                        with outer._qlock:
                            outer._queue.append(
                                (frm, to_and_msg["to"], to_and_msg["m"]))
                except (ConnectionError, OSError):
                    return

        class Srv(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Srv((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            kwargs={"poll_interval": 0.05},
            name=f"rpc-n{node_id}", daemon=True)
        self._thread.start()

    @property
    def addr(self) -> tuple[str, int]:
        return self._server.server_address[:2]

    def attach_metrics(self, reg) -> None:
        """Surface this transport's frame accounting (and its
        injector's nemesis tallies) through a MetricRegistry as
        func-metrics — the hot path keeps its plain ints."""
        reg.func_counter("rpc.frames.sent", lambda: self.sent,
                         "fabric frames submitted for delivery")
        reg.func_counter("rpc.frames.delivered",
                         lambda: self.delivered,
                         "inbound fabric frames dispatched")
        reg.func_gauge("rpc.frames.pending", lambda: self.pending(),
                       "inbound frames queued, not yet dispatched")
        reg.func_counter(
            "rpc.frames.dropped",
            lambda: self.injector.dropped if self.injector else 0,
            "frames dropped by the fault injector")
        reg.func_counter(
            "rpc.frames.delayed",
            lambda: self.injector.delayed if self.injector else 0,
            "frames delayed by the fault injector")
        reg.func_counter(
            "rpc.frames.duplicated",
            lambda: self.injector.duplicated if self.injector else 0,
            "frames duplicated by the fault injector")

    def connect(self, node_id: int, addr: tuple[str, int]) -> None:
        self._peers[node_id] = addr

    # -- LocalTransport interface -------------------------------------------
    def register(self, node_id: int, handler: Callable) -> None:
        self._handlers[node_id] = handler

    def partition(self, *peers: int) -> None:
        self._parted.update(peers)

    def heal(self, *peers: int) -> None:
        if peers:
            self._parted.difference_update(peers)
        else:
            self._parted.clear()

    def send(self, frm: int, to: int, msg) -> None:
        self.sent += 1
        if to in self._parted:
            return                     # partitioned: dropped
        if self.injector is not None:
            for d in self.injector.plan(frm, to):
                if d <= 0:
                    self._ship(frm, to, msg)
                else:
                    with self._qlock:
                        self._delayed.append(
                            (time.monotonic() + d, frm, to, msg))
            return
        self._ship(frm, to, msg)

    def _ship(self, frm: int, to: int, msg) -> None:
        """Deliver locally or frame onto the peer's socket."""
        if to in self._handlers:       # local delivery
            with self._qlock:
                self._queue.append((frm, to, msg))
            return
        addr = self._peers.get(to)
        if addr is None:
            return  # unknown peer: dropped (like a dead node)
        payload = encode_msg({"to": to, "m": msg})
        frame = struct.pack("!IQ", frm, len(payload)) + payload
        with self._clock:
            try:
                conn = self._conns.get(to)
                if conn is None:
                    conn = socket.create_connection(addr, timeout=10)
                    self._conns[to] = conn
                conn.sendall(frame)
            except (ConnectionError, OSError):
                self._conns.pop(to, None)  # peer down: drop (retry on
                # the next send, like gRPC connection re-dial)

    def _flush_delayed(self) -> None:
        if not self._delayed:
            return
        now = time.monotonic()
        with self._qlock:
            due = [d for d in self._delayed if d[0] <= now]
            self._delayed = [d for d in self._delayed if d[0] > now]
        for _, frm, to, msg in due:
            self._ship(frm, to, msg)

    def deliver_all(self) -> int:
        self._flush_delayed()
        with self._qlock:
            batch = list(self._queue)
            self._queue.clear()
        n = 0
        for frm, to, msg in batch:
            if frm in self._parted:
                continue               # partitioned: dropped
            if self.injector is not None and \
                    self.injector.partitioned(frm, self.node_id):
                continue               # frames in flight when the
                # partition landed are dropped on delivery too
            h = self._handlers.get(to)
            if h is not None:
                h(frm, msg)
                n += 1
        self.delivered += n
        return n

    def pending(self) -> int:
        return len(self._queue) + len(self._delayed)

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        with self._clock:
            for c in self._conns.values():
                try:
                    c.close()
                except OSError:
                    pass
            self._conns.clear()


def _exactly(sock: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    while n:
        try:
            b = sock.recv(n)
        except (ConnectionError, OSError):
            return None
        if not b:
            return None
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)
