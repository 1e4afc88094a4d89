"""Flow specs, stream rendezvous, and batch streaming
(cockroach_tpu/distsql/flow.py, ported as it stands).

Rebuilds the flow runtime of the reference:
- ``FlowSpec`` — the serialized unit of work shipped to each node
  (``execinfrapb.FlowSpec`` carried by SetupFlowRequest,
  execinfrapb/api.proto:149). Our processor core is (sql, stage): the
  node re-plans the statement deterministically and applies the stage
  transform, instead of shipping an operator-tree proto.
- ``FlowRegistry`` — rendezvous of inbound streams keyed by
  (flow_id, stream_id) (flowinfra/flow_registry.go): the gateway's
  consumer and the remote producer find each other here regardless of
  arrival order.
- ``Outbox``/``Inbox`` — streaming producer/consumer of serialized
  columnar chunks (colflow/colrpc/outbox.go:150, inbox.go:326).

Flow control (round 3): the reference rides gRPC's HTTP/2 stream
windows for backpressure and a context for cancellation
(colrpc/outbox.go's stream.Send blocks on window exhaustion;
flowinfra/flow.go cancels every processor through the flow ctx). Our
framed-chunk fabric has neither, so both are explicit protocol here:

- **credits**: the consumer acks every data chunk it receives
  (``flow_ack``); the producer stops sending once
  ``sent - acked >= window`` and pumps its transport until credits
  return. One slow/overloaded gateway therefore bounds every
  producer's in-flight bytes at ``window * chunk_rows`` rows instead
  of letting fast producers queue an entire result set into memory.
- **cancellation**: the gateway broadcasts ``cancel_flow`` on any
  failure (remote error, stall, unhealthy peer); producers abort
  between chunks and ship nothing further. A flow cancelled before
  its SetupFlow arrives is remembered, so the late arrival is
  dropped instead of executed (the reference's flow registry keeps
  the same tombstone while the ctx is already dead).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np

from cockroach_tpu_torch.distsql import serde


class FlowCancelled(Exception):
    """The gateway cancelled this flow; abort quietly (no error ships
    back — the consumer is gone or no longer listening)."""


@dataclass
class FlowSpec:
    flow_id: str
    gateway: int                 # node id consuming the results
    stage: str                   # "rows" | "partial_agg" | "graph"
    sql: str
    stream_id: object            # gather stream id (int, or "g:p<n>")
    chunk_rows: int = 65536
    read_ts: Optional[int] = None
    window: int = 8              # max unacked chunks in flight
    # cluster mode: table -> [(start,end)] key spans (latin1 strings)
    # this node must materialize from the range plane before running
    # its stage — the PartitionSpans assignment by leaseholder
    # (distsql_physical_planner.go:1096). None = node-local shards.
    spans: Optional[dict] = None
    # multi-stage shuffle flows (distsql/shuffle.py): the graph kind
    # each node re-derives deterministically from the SQL, and the
    # ordered data-node set exchange buckets route over
    graph: Optional[str] = None
    data_nodes: Optional[list] = None
    # distributed tracing: when the gateway's statement is recording,
    # remote nodes run their stage under a local capture and ship the
    # finished span subtree back ahead of EOF (a "flow_span" frame)
    trace: bool = False
    # join-induced data skipping: compact wire frames (JoinFilter
    # .to_wire() dicts) derived by the gateway from replicated build
    # sides; remote nodes apply them to their probe-side shard scans
    # so non-matching chunks never upload (they can only SHRINK the
    # scanned set, never change visible rows — safe to drop on any
    # node that cannot apply them)
    joinfilter: Optional[list] = None
    # adaptive partial aggregation: the gateway built a raw-row fold
    # for this statement, so each node MAY ship raw source rows
    # instead of partials when its shard's group cardinality makes the
    # partial stage pure overhead (node.py _adaptive_agg_stage). Off =
    # every shard ships partials (the A/B lever and the safe default
    # for statements without a raw fold).
    adaptive: bool = False
    # statement diagnostics: when the gateway's statement wants a
    # per-operator profile (EXPLAIN ANALYZE (DEBUG) / armed capture),
    # remote nodes run their stage under a fine ProfileSink and ship
    # the node-tagged operator table back ahead of EOF (a
    # "flow_profile" frame, the flow_span analogue)
    profile: bool = False
    # overlapped exchange (exec/movement.py): producers double-buffer
    # the send side — batch k+1's device work (and the page upload
    # behind it) dispatches BEFORE the producer blocks on batch k's
    # host transfer and send (the stream.prefetch discipline turned
    # around). Off = the historical compute-then-ship frame exchange
    # — the A/B lever for the parity fuzz and the movement bench.
    overlap: bool = True
    # hierarchical partial-agg merge (round-15 multi-host tentpole):
    # instead of every producer fanning flat into the gateway, the
    # gateway arranges partial-agg streams into a k-ary host tree.
    # merge_to overrides the stream's consumer (a mid-tree node
    # instead of the gateway); merge_children lists the stream_ids
    # whose partial chunks THIS node must absorb and tree-merge
    # (physical.merge_partials) with its own before shipping one
    # merged stream up. None/empty = the classic flat fan-in.
    merge_to: Optional[int] = None
    merge_children: Optional[list] = None
    # idle bound for a mid-tree node's child-stream wait, set from the
    # gateway's flow_timeout: the merge wait runs INSIDE deliver_all
    # (it blocks the gateway's own pump when the merge node is the
    # gateway's node), so it must give up no later than the flow would
    merge_timeout: float = 300.0
    # elastic pod (round 16): the membership epoch this flow was
    # planned under. A host whose shard set was rebuilt at a NEWER
    # epoch refuses the flow (its shards moved out from under the
    # plan), shipping an unavailable-marked error so the gateway
    # replans instead of double-counting or dropping moved rows.
    # None = static pod, no epoch fencing.
    epoch: Optional[int] = None
    # the gateway session's kernel route (SET pallas_groupagg): every
    # node compiles its stage with it. The port's field: the
    # reference's nodes compile with ExecParams' default ("off")
    pallas_groupagg: str = "auto"

    def to_wire(self) -> dict:
        return {"flow_id": self.flow_id, "gateway": self.gateway,
                "stage": self.stage, "sql": self.sql,
                "stream_id": self.stream_id,
                "chunk_rows": self.chunk_rows, "read_ts": self.read_ts,
                "window": self.window, "spans": self.spans,
                "graph": self.graph, "data_nodes": self.data_nodes,
                "trace": self.trace, "joinfilter": self.joinfilter,
                "adaptive": self.adaptive, "profile": self.profile,
                "overlap": self.overlap, "merge_to": self.merge_to,
                "merge_children": self.merge_children,
                "merge_timeout": self.merge_timeout,
                "epoch": self.epoch,
                "pallas_groupagg": self.pallas_groupagg}

    @staticmethod
    def from_wire(d: dict) -> "FlowSpec":
        return FlowSpec(**d)


class Inbox:
    """Blocking consumer of one inbound stream; chunks accumulate until
    EOF. ``error`` carries a remote execution failure to the gateway
    (the reference propagates these as flow-level metadata)."""

    def __init__(self):
        self.chunks: deque[bytes] = deque()
        self.eof = False
        self.error: Optional[str] = None
        self.spans: list[dict] = []   # remote span subtrees (wire)
        # remote operator profiles: {"node", "device_time_s", "ops"}
        # wire dicts from flow_profile frames, stitched at the gateway
        self.profiles: list[dict] = []
        self.bytes_received = 0

    def push(self, chunk: Optional[bytes], eof: bool,
             error: Optional[str] = None) -> None:
        if chunk is not None:
            self.chunks.append(chunk)
            self.bytes_received += len(chunk)
        if error is not None:
            self.error = error
            self.eof = True
        elif eof:
            self.eof = True

    def drain_arrays(self) -> list[tuple[int, dict, dict]]:
        out = []
        while self.chunks:
            out.append(serde.bytes_to_arrays(self.chunks.popleft()))
        return out


class FlowRegistry:
    """(flow_id, stream_id) -> Inbox rendezvous (flow_registry.go)."""

    def __init__(self):
        self._inboxes: dict[tuple[str, int], Inbox] = {}

    def inbox(self, flow_id: str, stream_id: int) -> Inbox:
        key = (flow_id, stream_id)
        if key not in self._inboxes:
            self._inboxes[key] = Inbox()
        return self._inboxes[key]

    def release(self, flow_id: str) -> None:
        for key in [k for k in self._inboxes if k[0] == flow_id]:
            del self._inboxes[key]

    def release_stream(self, flow_id: str, stream_id) -> None:
        """Release ONE stream's inbox — the merge-tree case, where a
        mid-tree node drains its child streams from the same registry
        the gateway's own inboxes for this flow may live in (when the
        merge node IS the gateway's node): a flow-wide release there
        would orphan the gateway's live inbox references."""
        self._inboxes.pop((flow_id, stream_id), None)


class Outbox:
    """Chunks a host batch and pushes frames to the gateway's inbox via
    the transport (FlowStream).

    With a ``node`` (the owning DistSQLNode) attached, each data chunk
    consumes one credit: once ``window`` chunks are unacked the send
    loop pumps the transport until the consumer's ``flow_ack``s return
    (or the flow is cancelled / the credit wait times out). EOF/error
    frames never wait — they must always be deliverable so the gateway
    can finish."""

    CREDIT_TIMEOUT = 300.0       # idle bound, same spirit as the
    # gateway's FLOW_TIMEOUT: only true silence fails the stream

    def __init__(self, transport, frm: int, to: int, flow_id: str,
                 stream_id: int, node=None, window: int = 0):
        self.transport = transport
        self.frm = frm
        self.to = to
        self.flow_id = flow_id
        self.stream_id = stream_id
        self.node = node
        self.window = window
        self.chunks_sent = 0
        self.bytes_sent = 0
        self.max_outstanding = 0
        reg = getattr(node, "metrics", None) if node is not None \
            else None
        self._m_bytes = None if reg is None else reg.counter(
            "shuffle.bytes.sent",
            "serialized chunk bytes shipped to flow consumers")

    def _send(self, chunk: Optional[bytes], eof: bool,
              error: Optional[str] = None) -> None:
        self.transport.send(self.frm, self.to,
                            ("flow_stream", self.flow_id, self.stream_id,
                             chunk, eof, error))

    def _check_cancel(self) -> None:
        if self.node is not None and \
                self.flow_id in self.node.cancelled_flows:
            raise FlowCancelled(self.flow_id)

    def _outstanding(self) -> int:
        acked = self.node.acks.get((self.flow_id, self.stream_id), 0) \
            if self.node is not None else self.chunks_sent
        return self.chunks_sent - acked

    def _await_credit(self) -> None:
        if self.node is None or self.window <= 0:
            return
        deadline = time.monotonic() + self.CREDIT_TIMEOUT
        while self._outstanding() >= self.window:
            self._check_cancel()
            # pump our own transport: acks arrive on it. With the
            # shared in-process transport this re-enters deliver_all
            # (which drains a snapshot, so recursion terminates); on
            # the socket fabric it drains this node's listener queue.
            moved = self.transport.deliver_all()
            if moved:
                deadline = time.monotonic() + self.CREDIT_TIMEOUT
                continue
            if self.transport.pending() == 0 and \
                    not getattr(self.transport, "is_async", False):
                raise RuntimeError(
                    f"flow {self.flow_id}/{self.stream_id}: awaiting "
                    "credits on an idle synchronous transport "
                    "(consumer never acked)")
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"flow {self.flow_id}/{self.stream_id}: credit "
                    f"wait timed out ({self.CREDIT_TIMEOUT}s)")
            time.sleep(0.001)

    def _send_chunk(self, chunk: bytes) -> None:
        self._check_cancel()
        self._await_credit()
        self._send(chunk, False)
        self.chunks_sent += 1
        self.bytes_sent += len(chunk)
        if self._m_bytes is not None:
            self._m_bytes.inc(len(chunk))
        self.max_outstanding = max(self.max_outstanding,
                                   self._outstanding())

    def send_arrays(self, n: int, cols: dict[str, np.ndarray],
                    valid: dict[str, np.ndarray],
                    chunk_rows: int) -> None:
        if n == 0:
            self._send_chunk(serde.encode_columns(
                0, {k: v[:0] for k, v in cols.items()},
                {k: v[:0] for k, v in valid.items()}))
        for lo in range(0, n, chunk_rows):
            hi = min(n, lo + chunk_rows)
            self._send_chunk(serde.encode_columns(
                hi - lo,
                {k: v[lo:hi] for k, v in cols.items()},
                {k: v[lo:hi] for k, v in valid.items()}))

    def close(self, error: Optional[str] = None) -> None:
        self._send(None, True, error)
