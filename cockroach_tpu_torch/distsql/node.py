"""Per-node DistSQL server and the gateway's flow runner
(cockroach_tpu/distsql/node.py).

``DistSQLNode`` is the remote side: it handles SetupFlow by planning
the statement locally (specs carry SQL and a stage role; re-planning is
deterministic because every node shares the catalog), applying the
stage transform from ``physical.py``, running the local plan over its
own shard through ``compile_plan`` on its engine's device, and
streaming the result chunks to the gateway (``pkg/sql/distsql/
server.go:625`` SetupFlow; ``colrpc/outbox.go`` push side).

``Gateway`` is the DistSQLPlanner and runner: it assigns the flow to
every node holding a shard of the scanned table (ownership is shard
residency, the way leaseholders partition spans in
``distsql_physical_planner.go:1096``), collects inbound streams in the
FlowRegistry, unions them into the ``__union`` pseudo-table on its own
engine's device, and runs the final stage through the same compiler.

Each node is a port ``Engine`` over its own store, on the card unless
it was made with ``device="cpu"``, optionally on a shard mesh of its
own (its stage then runs distributed over that mesh). Batches cross the
wire as numpy arrays (serde.py); the consuming engine rebuilds torch
tensors on its own device. Read timestamps are ints, as RunContext
takes them.

Branches of the reference that wait for modules not yet ported raise
``FlowUnsupported`` naming what is missing: the leaseholder branch
(``cluster=``, span materialization, the replan and gateway-local rungs:
kvserver.Cluster and kv/rowfetch.RangeTable), the elastic pod
(``elastic=``, the epoch fence, shard-lease transfer frames:
distsql/leases.py) and socket transports (rpc/context.py).
"""

from __future__ import annotations

import dataclasses
import time as _time
import uuid
from collections import deque

import numpy as np
import torch

from cockroach_tpu_torch.distsql import shuffle as shfl
from cockroach_tpu_torch.distsql.flow import (FlowCancelled, FlowRegistry,
                                              FlowSpec, Outbox)
from cockroach_tpu_torch.distsql.physical import (RAW, UNION,
                                                  MergeUnsupported,
                                                  merge_partials, split)
from cockroach_tpu_torch.exec import profile as _prof
from cockroach_tpu_torch.exec.compile import (ExecParams, RunContext,
                                              compile_plan)
from cockroach_tpu_torch.exec.scanplane import scan_maps
from cockroach_tpu_torch.ops.batch import ColumnBatch, pull_arrays
from cockroach_tpu_torch.sql import parser
from cockroach_tpu_torch.sql.planner import PlanError, Planner
from cockroach_tpu_torch.storage.hlc import Timestamp
from cockroach_tpu_torch.utils import tracing
from cockroach_tpu_torch.utils.mon import MemoryQuotaError


class FlowError(Exception):
    pass


class FlowUnsupported(FlowError):
    """A branch of the reference's flows whose modules are not yet
    ported; the message names them. Raised, never answered around."""


_LEASEHOLDER = ("the leaseholder branch needs kvserver.Cluster and "
                "kv/rowfetch.RangeTable (the replicated KV plane, ROADMAP "
                "Queue 1 item 5), not yet ported")
_ELASTIC = ("the elastic pod needs distsql/leases.py (ROADMAP Queue 1 "
            "item 4), not yet ported")
_SOCKETS = ("socket transports need rpc/context.py's SocketTransport "
            "(ROADMAP Queue 1 item 2), not yet ported")

# end-of-iteration sentinel for the overlapped-send double buffer
_SHIP_DONE = object()

# error-frame marker distinguishing "a participant is gone" from "the
# statement errored" ACROSS the merge tree: a mid-tree node that times
# out waiting for a child stream ships this marker up, and the gateway
# raises FlowUnavailable instead of FlowError
_UNAVAILABLE_MARK = "[flow-unavailable]"

# error columns of a stage's output batch: a set flag on a live row
# fails the flow, and the columns never cross the wire
_FLAGS = ("__sum_overflow", "__ht_overflow")


class FlowUnavailable(FlowError):
    """The flow failed because a participant is gone (breaker tripped,
    streams stalled, node died mid-flow), NOT because the statement
    itself errored."""


def _xstream(edge: int, producer: int, consumer: int) -> str:
    """Stream id of one exchange-edge producer->consumer pair (unique
    so per-stream credit accounting stays exact)."""
    return f"x{edge}:p{producer}:c{consumer}"


class _GraphFlowState:
    """Per-node progress of one multi-stage shuffle flow: stages run
    as their exchange inputs reach EOF (event-driven: a stage run
    must never block a transport handler waiting for peers)."""

    def __init__(self, spec: FlowSpec, graph, device):
        self.spec = spec
        self.graph = graph
        self.started: set[int] = set()
        self.done: set[int] = set()
        self.running = False
        self.spans: list[dict] = []   # per-stage recordings (wire)
        # one sink across this node's stages of a profiling flow: its
        # wall_s accumulates per-stage execution time and ships home
        # once, on the gather stream
        self.psink = (_prof.ProfileSink(device=device) if spec.profile
                      else None)


def _device_batch(data: dict, vmask: dict, sel: np.ndarray,
                  device) -> ColumnBatch:
    """A scan-able batch of fresh host arrays on ``device``, with the
    MVCC columns of always-visible rows."""
    n = len(sel)
    data = dict(data)
    data["_mvcc_ts"] = np.zeros(n, dtype=np.int64)
    data["_mvcc_del"] = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
    return ColumnBatch.from_dict(
        {k: torch.tensor(v, device=device) for k, v in data.items()},
        {k: torch.tensor(v, device=device) for k, v in vmask.items()},
        sel=torch.tensor(sel, device=device))


def _gather(chunks, columns):
    """(total rows, {col: [arrays]}, {col: [masks]}, {col: dtype}) of
    wire chunks; the dtype prototype comes from any chunk, empty ones
    included."""
    cols: dict[str, list] = {c: [] for c in columns}
    valid: dict[str, list] = {c: [] for c in columns}
    proto: dict = {}
    total = 0
    for n, ccols, cvalid in chunks:
        for c in columns:
            if c in ccols:
                proto.setdefault(c, ccols[c].dtype)
        if n == 0:
            continue
        total += n
        for c in columns:
            cols[c].append(ccols[c])
            valid[c].append(cvalid[c])
    return total, cols, valid, proto


def _empty_union(columns, string_cols, proto):
    """The union of no rows: one invalid row with sel False (the
    reference's shape), typed from the chunks' schema where one came
    (string columns as int32 codes), else int64."""
    data = {}
    for c in columns:
        if c in string_cols:
            data[c] = np.zeros(1, dtype=np.int32)
        else:
            dt = proto.get(c, np.dtype(np.int64))
            data[c] = np.zeros(1, dtype=dt if dt.kind in "biuf"
                               else np.int64)
    vmask = {c: np.zeros(1, dtype=bool) for c in columns}
    return data, vmask, np.zeros(1, dtype=bool)


def _arrays_to_batch(chunks, columns, string_cols, shared_dict, device):
    """Assemble received exchange chunks into a scan-able ColumnBatch on
    the consuming engine's device. Every string column re-encodes
    against the stage's ONE shared dictionary so code equality (join
    keys, group keys, col=col) stays exact across edges."""
    total, cols, valid, proto = _gather(chunks, columns)
    if total == 0:
        data, vmask, sel = _empty_union(columns, string_cols, proto)
    else:
        data = {c: np.concatenate(cols[c]) for c in columns}
        vmask = {c: np.concatenate(valid[c]) for c in columns}
        sel = np.ones(total, dtype=bool)
        for c in string_cols:
            data[c] = shared_dict.encode_array(data[c].astype(str))
    return _device_batch(data, vmask, sel, device)


def _decode_strings(cols, valid, string_cols, dict_of, what: str):
    """Replace dictionary codes by wire strings (bytes) in place; codes
    are node-local, strings are the portable representation."""
    for name, src in string_cols.items():
        d = dict_of(src)
        codes = np.asarray(cols[name])
        if d is None or len(d) == 0:
            if valid[name].any():
                # valid rows but no dictionary to decode them with:
                # the same bug class as an out-of-range code
                raise FlowError(f"{name}: valid {what}rows but missing/"
                                "empty dictionary")
            vals = np.zeros(len(codes), dtype="S1")
        else:
            # an out-of-range code on a VALID row is a planner or
            # dictionary bug; clamping would decode the wrong string
            bad = valid[name] & ((codes < 0) | (codes >= len(d)))
            if bad.any():
                raise FlowError(
                    f"{name}: {what}dictionary code out of range "
                    f"(code {int(codes[bad][0])}, dict size {len(d)})")
            safe = np.clip(codes, 0, len(d) - 1)
            vals = d.decode_array(safe).astype("S")
        cols[name] = np.where(valid[name], vals, b"")


def _pull_output(batch: ColumnBatch, what: str):
    """(n, cols, valid) of a stage output's live rows on the host: the
    rows are gathered on the device and come over in one pull with the
    error flags, which raise FlowError when set on a live row."""
    names = [c for c in batch.names if not c.startswith(_FLAGS)]
    flags = [f for f in _FLAGS if batch.has(f)]
    live = torch.nonzero(batch.sel, as_tuple=True)[0]
    arrs = [batch.col(c).index_select(0, live) for c in names]
    arrs += [batch.col_valid(c).index_select(0, live) for c in names]
    if flags:
        arrs.append(torch.stack([
            torch.any(torch.logical_and(batch.col(f).to(torch.bool),
                                        batch.sel)) for f in flags]))
    pulled = pull_arrays(arrs)
    k = len(names)
    if flags:
        for f, hit in zip(flags, pulled[2 * k]):
            if bool(hit):
                raise FlowError(f"{what}: {f}")
    cols = {c: pulled[i] for i, c in enumerate(names)}
    valid = {c: pulled[k + i].astype(bool) for i, c in enumerate(names)}
    return len(live), cols, valid


class DistSQLNode:
    # remember this many cancelled flow ids, so a cancel that races
    # ahead of its SetupFlow still tombstones the late arrival
    CANCEL_MEMORY = 256

    def __init__(self, node_id: int, engine, transport, cluster=None):
        if cluster is not None:
            raise FlowUnsupported(f"DistSQLNode(cluster=...): {_LEASEHOLDER}")
        if getattr(transport, "is_async", False):
            raise FlowUnsupported(
                f"DistSQLNode over {type(transport).__name__}: {_SOCKETS}")
        self.node_id = node_id
        self.engine = engine
        self.transport = transport
        self.registry = FlowRegistry()
        # the engine's registry: flow/shuffle metrics land next to the
        # SQL metrics so one /_status/vars scrape covers the node
        self.metrics = getattr(engine, "metrics", None)
        transport.register(node_id, self._handle)
        self.flows_run = 0
        self.flows_cancelled = 0
        self.max_outstanding = 0   # high-water unacked chunks (stats)
        # producer-side credit state: (flow_id, stream_id) -> chunks
        # the consumer has acked (read by the Outbox's credit wait)
        self.acks: dict[tuple[str, int], int] = {}
        self._producing: set[tuple[str, int]] = set()
        self.cancelled_flows: set[str] = set()
        self._cancel_order: deque = deque()
        # SetupFlow idempotence under at-least-once delivery: a
        # duplicated frame must not run the stage (and push its
        # chunks) twice. Bounded the same way cancel memory is.
        self._flows_seen: set[tuple] = set()
        self._seen_order: deque = deque()
        # multi-stage shuffle flows in progress on this node
        self._graphs: dict[str, _GraphFlowState] = {}

    # -- rpc handlers ----------------------------------------------
    def _handle(self, frm: int, payload) -> None:
        kind = payload[0]
        if kind == "setup_flow":
            spec = FlowSpec.from_wire(payload[1])
            if spec.graph:
                self._setup_graph_flow(spec)
            else:
                self._setup_flow(spec)
        elif kind == "flow_stream":
            _, flow_id, stream_id, chunk, eof, error = payload
            if flow_id in self.cancelled_flows:
                # stale frame for a released/cancelled flow: dropping
                # it (no inbox, no ack) keeps late chunks from
                # re-creating registry entries nobody will ever drain
                return
            self.registry.inbox(flow_id, stream_id).push(chunk, eof, error)
            if chunk is not None:
                if self.metrics is not None:
                    self.metrics.counter(
                        "shuffle.bytes.received",
                        "serialized chunk bytes received from flow "
                        "producers").inc(len(chunk))
                # consumer side of the credit loop: one ack per data
                # chunk, returned to the producer that sent it
                self.transport.send(self.node_id, frm,
                                    ("flow_ack", flow_id, stream_id, 1))
            if flow_id in self._graphs and (eof or error is not None):
                # an exchange stream finished: some stage may now be
                # runnable
                self._graph_try_run(flow_id)
        elif kind == "flow_span":
            # a producer's finished recording (shipped ahead of its
            # EOF so the gateway sees it before the pump loop exits)
            _, flow_id, stream_id, wire = payload
            if flow_id not in self.cancelled_flows:
                self.registry.inbox(flow_id, stream_id).spans.append(wire)
        elif kind == "flow_profile":
            # a producer's node-tagged operator profile (statement
            # diagnostics), shipped ahead of EOF like flow_span
            _, flow_id, stream_id, wire = payload
            if flow_id not in self.cancelled_flows:
                self.registry.inbox(flow_id, stream_id).profiles \
                    .append(wire)
        elif kind == "flow_ack":
            _, flow_id, stream_id, n = payload
            key = (flow_id, stream_id)
            if key in self._producing:   # late acks for finished
                # streams would otherwise re-create state forever
                self.acks[key] = self.acks.get(key, 0) + n
        elif kind in ("shard_fetch", "shard_page"):
            raise FlowUnsupported(f"{kind} frame from node {frm}: "
                                  f"{_ELASTIC}")
        elif kind == "cancel_flow":
            self._cancel(payload[1])

    def _cancel(self, flow_id: str) -> None:
        self._graphs.pop(flow_id, None)
        if flow_id in self.cancelled_flows:
            return
        self.cancelled_flows.add(flow_id)
        self._cancel_order.append(flow_id)
        while len(self._cancel_order) > self.CANCEL_MEMORY:
            self.cancelled_flows.discard(self._cancel_order.popleft())

    # -- local stage execution -------------------------------------
    def _setup_flow(self, spec: FlowSpec) -> None:
        # hierarchical merge: a stream's consumer is its merge-tree
        # parent when the gateway planned one (flat fan-in otherwise)
        consumer = (spec.merge_to if spec.merge_to is not None
                    else spec.gateway)
        outbox = Outbox(self.transport, self.node_id, consumer,
                        spec.flow_id, spec.stream_id,
                        node=self, window=spec.window)
        if spec.flow_id in self.cancelled_flows:
            # cancel raced ahead of the SetupFlow: drop it unexecuted
            self.flows_cancelled += 1
            return
        key = (spec.flow_id, spec.stream_id)
        if key in self._flows_seen:
            return          # duplicate SetupFlow: already ran/running
        self._flows_seen.add(key)
        self._seen_order.append(key)
        while len(self._seen_order) > self.CANCEL_MEMORY:
            self._flows_seen.discard(self._seen_order.popleft())
        self._producing.add((spec.flow_id, spec.stream_id))
        try:
            self.flows_run += 1
            if spec.epoch is not None:
                raise FlowUnsupported(f"flow epoch {spec.epoch}: {_ELASTIC}")
            if spec.spans is not None:
                raise FlowUnsupported(f"flow spans: {_LEASEHOLDER}")
            sink = (_prof.ProfileSink(device=self.engine.device)
                    if spec.profile else None)

            def body():
                batches, stage = self._run_local(spec, sink=sink)
                if spec.merge_children:
                    self._merge_and_ship(spec, outbox, batches, stage)
                else:
                    self._ship_batches(spec, outbox, batches, stage)
            if spec.trace:
                # record this stage locally and ship the subtree back
                # BEFORE EOF (the gateway's pump loop exits on EOF)
                with tracing.capture("flow", node=self.node_id,
                                     stage=spec.stage) as rec:
                    body()
                self._send_flow_span(spec, tracing.span_to_wire(rec))
            else:
                body()
            if sink is not None:
                # node-tagged operator table, ahead of EOF (flow_span
                # discipline); device_time_s is the stage's measured
                # execution (planning and uploads excluded)
                self._send_flow_profile(spec, {
                    "node": self.node_id,
                    "device_time_s": sink.wall_s,
                    "ops": sink.to_wire(node=self.node_id)})
            outbox.close()
        except FlowCancelled:
            # the gateway told us to stop: abort quietly, nothing to
            # ship (the consumer released the flow already)
            self.flows_cancelled += 1
        except Exception as e:          # noqa: BLE001 — ships to gateway
            outbox.close(error=f"{type(e).__name__}: {e}")
        finally:
            self.max_outstanding = max(self.max_outstanding,
                                       outbox.max_outstanding)
            self._producing.discard((spec.flow_id, spec.stream_id))
            self.acks.pop((spec.flow_id, spec.stream_id), None)

    def _diag_consumer(self, spec: FlowSpec) -> int:
        """Diagnostic frames follow the DATA topology: a mid-tree
        stream's flow_span/flow_profile frames land on its merge
        parent, which relays them up re-tagged with its own stream."""
        return (spec.merge_to if spec.merge_to is not None
                else spec.gateway)

    def _send_flow_span(self, spec: FlowSpec, wire: dict) -> None:
        self.transport.send(self.node_id, self._diag_consumer(spec),
                            ("flow_span", spec.flow_id,
                             spec.stream_id, wire))

    def _send_flow_profile(self, spec: FlowSpec, wire: dict) -> None:
        self.transport.send(self.node_id, self._diag_consumer(spec),
                            ("flow_profile", spec.flow_id,
                             spec.stream_id, wire))

    def _exec_params(self, spec: FlowSpec) -> ExecParams:
        """The stage's static parameters: the gateway session's kernel
        route (``pallas_groupagg``, carried on the spec) with this
        engine's kernel-1 launch point and the paths its parity gate
        promoted, as the engine gives a plan it builds
        (Engine._on_exec_miss); the rest at their defaults."""
        from cockroach_tpu_torch.exec.session import Session
        from cockroach_tpu_torch.ops.cuda import autotune, paritygate
        eng = self.engine
        p = ExecParams(pallas_groupagg=spec.pallas_groupagg)
        if p.pallas_groupagg == "off":
            return p
        p.pallas_point = autotune.params_for(
            eng._device_key, eng._compile_cache_dir,
            eng._autotune_mode(Session()), eng.device)
        if p.pallas_groupagg == "auto":
            p.pallas_exact_paths = paritygate.promoted(
                eng._device_key, eng._compile_cache_dir, eng.device,
                p.pallas_point)
        return p

    def _run(self, runf, scans, read_ts: int, sink):
        """One stage run. A profiling flow runs under its own fine sink
        (operator spans resolve into it, its wall is the run's measured
        time); any other runs with no sink active, so a stage run on
        the gateway's thread never records into the statement's."""
        with _prof.active(sink, fine=sink is not None):
            out = runf(RunContext(scans, read_ts))
        if sink is not None:
            sink.resolve()
        return out

    def _mesh_runner(self, plan, params: ExecParams, read_ts: int, sink):
        """On an engine with a shard mesh, the stage distributed over it
        (exec/engine.py _DistRouter: probe-spine scans sharded, build
        sides replicated, partials merged by the mesh's collectives);
        None when the engine has no mesh or the plan cannot shard."""
        eng = self.engine
        if eng.mesh is None or eng.mesh.size <= 1 or sink is not None:
            return None
        from cockroach_tpu_torch.exec.engine import _DistRouter
        from cockroach_tpu_torch.parallel import distagg
        from cockroach_tpu_torch.parallel import mesh as meshmod
        from cockroach_tpu_torch.parallel.collective import AXIS
        d = distagg.analyze(plan)
        if not d.ok:
            return None
        aliases, cols = scan_maps(plan)
        spec, scans = [], {}
        for alias, tname in aliases.items():
            placement = (meshmod.shard_spec() if alias in d.sharded
                         else meshmod.replicated_spec())
            scans[alias] = eng._device_table(tname, cols[alias], placement)
            spec.append((alias, tname, placement, cols[alias]))
        p = dataclasses.replace(params, axis_name=AXIS,
                                n_shards=eng.mesh.size)
        router = _DistRouter(eng, plan, None, dict(aliases), p, spec, 0, 0)
        return lambda: router(RunContext(scans, read_ts))

    def _run_local(self, spec: FlowSpec, sink=None):
        eng = self.engine
        node, _meta = Planner(
            # int_ranges off: key_int_range reflects only this node's
            # LOCAL shard; per-node plans must stay deterministic and
            # range-independent across the fabric
            eng.catalog_view(int_ranges=False),
            use_memo=False).plan_select(parser.parse(spec.sql))
        # duplicate-keyed join builds must error, not silently drop
        # matches: the same guard as the engine's _prepare_select
        rts = (Timestamp.from_int(spec.read_ts) if spec.read_ts is not None
               else eng.clock.now())
        eng._check_join_builds(node, rts, {})
        stage = split(node)
        if spec.adaptive and stage.stage == "partial_agg" \
                and stage.raw_local is not None:
            stage = self._adaptive_agg_stage(stage)
        params = self._exec_params(spec)
        read_ts = int(rts.to_int())
        mesh_run = self._mesh_runner(stage.local, params, read_ts, sink)
        if mesh_run is not None:
            return [mesh_run()], stage
        runf = compile_plan(stage.local, params)
        # the port never narrows uploads (narrow32_cols is a named
        # divergence), so every node's partial dtypes are the plan's
        local_scans, local_cols = scan_maps(stage.local)
        local_scans = {a: t for a, t in local_scans.items() if t != UNION}
        scans = {}
        # join-induced data skipping: the gateway's wire frames prune
        # this node's probe-side shard chunks host-side before upload.
        # _filtered_scan_batch returns None when nothing drops (keep
        # the cached device table) and the frames can only SHRINK the
        # scanned set: any failure falls back to the full scan
        jf_by_table: dict = {}
        if spec.joinfilter:
            from cockroach_tpu_torch.exec.joinfilter import JoinFilter
            for d in spec.joinfilter:
                f = JoinFilter.from_wire(d)
                jf_by_table.setdefault(f.table, []).append(f)
        paged = None   # (alias, table) whose upload overflowed the budget
        builds = _join_build_aliases(stage.local)
        # build sides first: they can never page (every probe row must
        # see the whole build table), so they take first claim on the
        # budget and any overflow lands on a probe/source scan, which
        # the paged fallback below CAN absorb
        for alias, tbl in sorted(local_scans.items(),
                                 key=lambda kv: (kv[0] not in builds,
                                                 kv[0])):
            fl = jf_by_table.get(tbl)
            b = None
            if fl:
                try:
                    b = eng._filtered_scan_batch(tbl, fl, local_cols[alias],
                                                 spec.read_ts)
                except Exception:
                    b = None
            if b is not None:
                scans[alias] = b
                continue
            try:
                scans[alias] = eng._device_table(tbl, local_cols[alias])
            except MemoryQuotaError:
                # distributed spill, node side: this shard's working
                # set exceeds the node's budget, so page THE ONE
                # over-budget scan through the stream tier's pages.
                # Pages partition the shard exactly the way shards
                # partition the table, so per-page outputs union at the
                # gateway as per-shard outputs do; never a hash-join
                # BUILD side, never a graph flow, at most one scan
                if paged is not None or spec.graph is not None \
                        or alias in builds:
                    raise
                paged = (alias, tbl, local_cols[alias])
        if paged is not None:
            return self._paged_local(spec, runf, scans, paged,
                                     read_ts, sink=sink), stage
        return [self._run(runf, scans, read_ts, sink)], stage

    def _paged_local(self, spec: FlowSpec, runf, scans, paged,
                     read_ts: int, sink=None):
        """Generator of per-page stage outputs for a flow whose scan
        overflowed this node's budget (_run_local's distributed-spill
        rung). The page size comes from the budget's headroom so two
        pages (the one computing and the one the prefetch worker is
        uploading) fit; the upload's overlap is accounted to the
        movement scheduler as the spill tier accounts its feed."""
        from cockroach_tpu_torch.exec.spill import _STALL_HELP, _StallSum
        from cockroach_tpu_torch.exec.stream import \
            prefetch as stream_prefetch
        alias, tbl, cols = paged
        eng = self.engine
        mv = eng.movement
        mv.m_spill_fallbacks.inc()
        td = eng.store.table(tbl)
        nrows = max(int(td.row_count), 1)
        per_row = max(1, eng._table_device_bytes(td, cols)
                      // max(1, eng._row_bucket(nrows)))
        free = max(int(eng.hbm.limit) - int(eng.hbm.used), 0)
        target = max(1024, min(nrows, free // (2 * per_row)))
        page_rows = eng._row_bucket(target)
        src = eng._page_source(tbl, cols, page_rows, read_ts=spec.read_ts)

        def run_page(batch):
            s = dict(scans)
            s[alias] = batch
            return self._run(runf, s, read_ts, sink)

        def gen():
            stall = _StallSum(eng.metrics.histogram(
                "exec.stream.prefetch_stall_seconds", _STALL_HELP))
            busy = 0.0
            got = False
            with mv.soft_lease("page", 2 * src.page_bytes):
                it = stream_prefetch(src.pages(), stall_hist=stall)
                try:
                    for up in it:
                        got = True
                        t0 = _time.monotonic()
                        yield run_page(up.batch())
                        # time the consumer spent computing/shipping
                        # while the worker assembled the next page
                        busy += _time.monotonic() - t0
                finally:
                    it.close()
                if not got:
                    # every page MVCC-skipped: aggregates still need
                    # their identity state from one padding-only page
                    yield run_page(src.empty_page())
            ov = max(0.0, busy - stall.total)
            mv.note_overlap(ov)
            eng.metrics.counter(
                "exec.spill.upload_overlap_seconds",
                "seconds of partition/page assembly+upload hidden "
                "under device compute (worker busy time not surfacing "
                "as consumer stalls)").inc(ov)
        return gen()

    def _ship_batches(self, spec: FlowSpec, outbox: Outbox, batches,
                      stage) -> None:
        """Ship every stage-output batch on the flow's stream. With
        ``spec.overlap`` the producer double-buffers: it pulls batch
        k+1 (dispatching its device work, and behind it the next page
        upload) BEFORE blocking on batch k's host transfer and send.
        Off = compute-then-ship (the A/B lever)."""
        mv = self.engine.movement

        def ship(batch):
            n, cols, valid = self._host_output(batch, stage.local,
                                               stage.string_cols)
            outbox.send_arrays(n, cols, valid, spec.chunk_rows)
        try:
            if not spec.overlap:
                for batch in batches:
                    ship(batch)
                return
            it = iter(batches)
            prev = next(it, _SHIP_DONE)
            overlapped = 0.0
            while prev is not _SHIP_DONE:
                nxt = next(it, _SHIP_DONE)
                t0 = _time.monotonic()
                ship(prev)
                if nxt is not _SHIP_DONE:
                    # send of batch k ran while batch k+1's device
                    # work (dispatched by the pull above) proceeded
                    overlapped += _time.monotonic() - t0
                prev = nxt
            if overlapped > 0.0:
                mv.note_overlap(overlapped)
        finally:
            mv.note_exchange(outbox.bytes_sent)

    def _merge_and_ship(self, spec: FlowSpec, outbox: Outbox, batches,
                        stage) -> None:
        """Mid-tree node of a hierarchical partial-agg merge: absorb
        the child streams the gateway assigned to us
        (``spec.merge_children``), tree-merge their partial chunks with
        our own shard's partials (physical.merge_partials, host numpy),
        and ship ONE merged stream to our parent. Adaptive raw chunks
        pass through unmerged, as does anything merge_partials cannot
        combine exactly. The wait pumps our own transport and fails
        only on true silence, with ``_UNAVAILABLE_MARK`` in the error."""
        mv = self.engine.movement
        own = [self._host_output(b, stage.local, stage.string_cols)
               for b in batches]
        sids = list(spec.merge_children)
        inboxes = {sid: self.registry.inbox(spec.flow_id, sid)
                   for sid in sids}
        idle = float(spec.merge_timeout or Outbox.CREDIT_TIMEOUT)
        fwd_spans: list = []
        fwd_profiles: list = []
        try:
            deadline = _time.monotonic() + idle
            while not all(ib.eof for ib in inboxes.values()):
                if spec.flow_id in self.cancelled_flows:
                    raise FlowCancelled(spec.flow_id)
                moved = self.transport.deliver_all()
                if moved:
                    deadline = _time.monotonic() + idle
                    continue
                stalled = [s for s, ib in inboxes.items() if not ib.eof]
                if self.transport.pending() == 0 and \
                        not getattr(self.transport, "is_async", False):
                    raise FlowError(
                        f"{_UNAVAILABLE_MARK} merge streams {stalled} "
                        "stalled on an idle synchronous transport")
                if _time.monotonic() > deadline:
                    raise FlowError(
                        f"{_UNAVAILABLE_MARK} merge streams {stalled} "
                        f"stalled ({idle}s silence)")
                _time.sleep(0.001)
            errs = [ib.error for ib in inboxes.values() if ib.error]
            if errs:
                raise FlowError("; ".join(errs))
            absorbed = sum(ib.bytes_received for ib in inboxes.values())
            child = [c for ib in inboxes.values()
                     for c in ib.drain_arrays()]
            fwd_spans = [w for ib in inboxes.values() for w in ib.spans]
            fwd_profiles = [w for ib in inboxes.values()
                            for w in ib.profiles]
        finally:
            # per-stream release, NOT flow-wide: on the gateway's own
            # node the gateway's direct inboxes for this flow share
            # this registry
            for sid in sids:
                self.registry.release_stream(spec.flow_id, sid)
        if fwd_spans or fwd_profiles:
            for w in fwd_spans:
                self._send_flow_span(spec, w)
            for w in fwd_profiles:
                self._send_flow_profile(spec, w)
            if self.metrics is not None:
                self.metrics.counter(
                    "exec.multihost.diag.forwarded",
                    "flow_span/flow_profile frames relayed up the "
                    "merge tree by mid-tree nodes").inc(
                    len(fwd_spans) + len(fwd_profiles))
        chunks = own + child
        partial = [c for c in chunks if "__p0" in c[1]]
        raw = [c for c in chunks if "__p0" not in c[1]]
        shipped = list(partial)
        if len(partial) > 1 and stage.merge_funcs:
            try:
                shipped = [merge_partials(partial, stage.merge_cols,
                                          stage.merge_funcs)]
                if self.metrics is not None:
                    self.metrics.counter(
                        "exec.multihost.flows.merged",
                        "hierarchical merges performed at mid-tree "
                        "nodes (partial streams combined before the "
                        "gateway)").inc()
                    self.metrics.counter(
                        "exec.multihost.merge.bytes",
                        "child partial-stream bytes absorbed by "
                        "mid-tree merges instead of traversing the "
                        "links above this node").inc(absorbed)
            except MergeUnsupported:
                shipped = list(partial)   # forward unmerged
        try:
            for n, cols, valid in shipped + raw:
                outbox.send_arrays(n, cols, valid, spec.chunk_rows)
        finally:
            mv.note_exchange(outbox.bytes_sent)

    def _adaptive_agg_stage(self, stage):
        """Partial Partial Aggregates: decide, per shard at flow setup
        time, whether the partial-aggregate stage reduces THIS shard's
        data. A high-cardinality group key means nearly one group per
        row, so such shards ship raw source rows and the gateway folds
        them through stage.raw_merge. Only combine-exact aggregates
        take this path, so results are the same whichever shards
        flip."""
        eng = self.engine
        ship_raw = False
        try:
            frac = float(eng.settings.get("exec.agg.adaptive_raw_fraction"))
            if frac > 0:
                rows, groups = self._shard_group_estimate(stage)
                ship_raw = rows > 0 and groups >= frac * rows
        except Exception:
            ship_raw = False          # estimate failure -> partials
        if ship_raw:
            eng.metrics.counter(
                "exec.agg.adaptive.ship_raw",
                "adaptive DistSQL aggregation: shards that shipped "
                "raw rows (partials would not have reduced)").inc()
            return dataclasses.replace(
                stage, local=stage.raw_local,
                union_columns=list(stage.raw_columns),
                string_cols=dict(stage.raw_strings))
        eng.metrics.counter(
            "exec.agg.adaptive.partial",
            "adaptive DistSQL aggregation: shards that kept the "
            "partial-aggregate stage").inc()
        return stage

    def _shard_group_estimate(self, stage):
        """(shard rows, estimated group count) for this node's shard,
        from seal-time chunk sketches (storage/columnstore.py): a host
        lookup, no device work. Group cardinality is the row-capped
        product of per-key distincts (an upper bound, which errs only
        toward shipping raw). Any unresolvable key bails to (rows, 0):
        keep the partial stage."""
        from cockroach_tpu_torch.sql import plan as P
        from cockroach_tpu_torch.sql.bound import BCol, walk
        eng = self.engine
        colmap: dict = {}          # output column -> (table, stored)
        tables: set = set()

        def rec(n):
            if isinstance(n, P.Scan):
                if n.table not in (UNION, RAW):
                    tables.add(n.table)
                    for out, stored in n.columns.items():
                        colmap[out] = (n.table, stored)
            elif isinstance(n, P.HashJoin):
                rec(n.left)
                rec(n.right)
            elif hasattr(n, "child"):
                rec(n.child)
        rec(stage.local)
        if not tables:
            return 0, 0
        # the port's store seals every publish: each chunk has sketches
        rows = max(eng.store.table(t).row_count for t in tables)
        groups = 1.0
        for _, ge in stage.raw_merge.group_by:
            nd = 1.0
            for c in walk(ge):
                if not isinstance(c, BCol):
                    continue
                tc = colmap.get(c.name)
                if tc is None:
                    return rows, 0
                d = eng.store.sketch_stats(tc[0]).distinct.get(tc[1])
                if d is None:
                    return rows, 0
                nd *= max(1, int(d))
            groups = min(groups * nd, float(rows) * 2.0 + 1.0)
        return rows, min(groups, float(rows))

    def _host_output(self, batch, plan, string_cols, shared_dict=None):
        """Pull a stage's result to host arrays, compacted by sel, with
        dictionary-coded strings decoded for the wire."""
        n, cols, valid = _pull_output(batch, "local stage error")
        _decode_strings(cols, valid, string_cols,
                        lambda src: self._dictionary_for(plan, src,
                                                         shared_dict), "")
        return n, cols, valid

    def _dictionary_for(self, local_plan, bcol_name: str,
                        shared_dict=None):
        """Resolve a batch column name to the dictionary its codes
        index: follow Project/Aggregate renames down to the source
        Scan (table dictionary), an exchange scan (the stage's shared
        dictionary), or an expression that carries its own output
        dictionary (string builtins)."""
        from cockroach_tpu_torch.sql import plan as P
        from cockroach_tpu_torch.sql.bound import BCol

        def resolve(name, n):
            if isinstance(n, P.Scan):
                if n.table.startswith("__x") and name in n.columns:
                    return shared_dict
                # batch column names are scope-unique, so presence in
                # the column map is authoritative
                if name in n.columns:
                    stored = n.columns[name]
                    td = self.engine.store.table(n.table)
                    return td.dictionaries.get(stored)
                for cn, e in n.computed:
                    if cn == name:
                        d = getattr(e, "dictionary", None)
                        if d is not None:
                            return d
                        if isinstance(e, BCol):
                            return resolve(e.name, n)
                        return None
                return None
            if isinstance(n, P.Project):
                for cn, e in n.items:
                    if cn == name:
                        d = getattr(e, "dictionary", None)
                        if d is not None:
                            return d
                        if isinstance(e, BCol):
                            return resolve(e.name, n.child)
                        return None
                # the name addresses the pre-projection namespace
                return resolve(name, n.child)
            if isinstance(n, P.Aggregate):
                target = name
                for cn, e in n.items:
                    if cn == name and isinstance(e, BCol):
                        target = e.name
                        break
                for gn, ge in n.group_by:
                    if gn == target:
                        d = getattr(ge, "dictionary", None)
                        if d is not None:
                            return d
                        if isinstance(ge, BCol):
                            return resolve(ge.name, n.child)
                        return None
                return resolve(target, n.child)
            if isinstance(n, P.HashJoin):
                return resolve(name, n.left) or resolve(name, n.right)
            if hasattr(n, "child"):
                return resolve(name, n.child)
            return None
        return resolve(bcol_name, local_plan)

    # -- multi-stage shuffle flows (distsql/shuffle.py) -------------

    def _setup_graph_flow(self, spec: FlowSpec) -> None:
        if spec.flow_id in self.cancelled_flows:
            self.flows_cancelled += 1
            return
        try:
            if spec.spans is not None:
                raise FlowUnsupported(f"flow spans: {_LEASEHOLDER}")
            # stats=False: the stage graph must be identical on every
            # node, so planning may not consult local row counts or
            # uniqueness probes (shuffle.py module docstring)
            plan_node, _ = Planner(
                self.engine.catalog_view(int_ranges=False, stats=False),
                use_memo=False,
                dict_folds=False).plan_select(parser.parse(spec.sql))
            graph = shfl.decompose(spec.graph, plan_node)
        except Exception as e:        # noqa: BLE001 — ships to gateway
            Outbox(self.transport, self.node_id, spec.gateway,
                   spec.flow_id, spec.stream_id).close(
                error=f"{type(e).__name__}: {e}")
            return
        self.flows_run += 1
        self._graphs[spec.flow_id] = _GraphFlowState(spec, graph,
                                                     self.engine.device)
        self._graph_try_run(spec.flow_id)

    def _graph_try_run(self, flow_id: str) -> None:
        st = self._graphs.get(flow_id)
        if st is None or st.running:
            # running: a stage is executing higher up this stack (a
            # credit wait pumped the transport); the outer frame
            # re-checks readiness when its stage finishes
            return
        st.running = True
        try:
            progressed = True
            while progressed:
                progressed = False
                for stage in st.graph.stages:
                    if stage.sid in st.started or \
                            not self._stage_ready(st, stage):
                        continue
                    st.started.add(stage.sid)
                    self._run_stage(st, stage)
                    st.done.add(stage.sid)
                    progressed = True
            if len(st.done) == len(st.graph.stages):
                self._graph_finish(flow_id)
        except FlowCancelled:
            self.flows_cancelled += 1
            self._graph_finish(flow_id)
        except Exception as e:        # noqa: BLE001 — ships to gateway
            try:
                Outbox(self.transport, self.node_id, st.spec.gateway,
                       flow_id, st.spec.stream_id).close(
                    error=f"{type(e).__name__}: {e}")
            finally:
                self._graph_finish(flow_id)
        finally:
            st.running = False

    def _graph_finish(self, flow_id: str) -> None:
        self._graphs.pop(flow_id, None)
        self.registry.release(flow_id)
        for key in [k for k in self.acks if k[0] == flow_id]:
            del self.acks[key]
        for key in [k for k in self._producing if k[0] == flow_id]:
            self._producing.discard(key)

    def _stage_ready(self, st: _GraphFlowState, stage) -> bool:
        for e in stage.inputs:
            for p in st.spec.data_nodes:
                ib = self.registry.inbox(
                    st.spec.flow_id, _xstream(e, p, self.node_id))
                if ib.error:
                    raise FlowError(
                        f"exchange edge {e} from node {p}: {ib.error}")
                if not ib.eof:
                    return False
        return True

    def _edge_batch(self, st: _GraphFlowState, edge, shared_dict):
        chunks = []
        for p in st.spec.data_nodes:
            ib = self.registry.inbox(
                st.spec.flow_id, _xstream(edge.edge, p, self.node_id))
            chunks += ib.drain_arrays()
        return _arrays_to_batch(chunks, edge.columns, edge.string_cols,
                                shared_dict, self.engine.device)

    def _patch_probe_join(self, plan, scans) -> None:
        """Exchange-fed join build sides have unknown key multiplicity
        at plan time; measure it on the received data and bake it in
        as the static expansion factor (the engine's host probe,
        _check_one_build)."""
        from cockroach_tpu_torch.sql import plan as P

        def rec(n):
            if isinstance(n, P.HashJoin):
                r = n.right
                if isinstance(r, P.Scan) and r.table.startswith("__x"):
                    b = scans[r.alias]
                    arrs = [b.sel] + [b.col_valid(k) for k in n.right_keys] \
                        + [b.col(k) for k in n.right_keys]
                    host = pull_arrays(arrs)
                    nk = len(n.right_keys)
                    ok = host[0].astype(bool)
                    for v in host[1:1 + nk]:
                        ok = ok & v.astype(bool)
                    ks = host[1 + nk:]
                    if ok.any():
                        stacked = np.stack(
                            [v[ok].astype(np.int64) for v in ks], axis=1)
                        _, counts = np.unique(stacked, axis=0,
                                              return_counts=True)
                        n.expand = int(counts.max())
                    else:
                        n.expand = 1
                    cap = getattr(self.engine, "MAX_JOIN_EXPANSION", 64)
                    if n.expand > cap:
                        raise FlowError(
                            f"shuffle join build has up to {n.expand} "
                            f"rows per key (limit {cap})")
                rec(n.left)
                rec(n.right)
            elif getattr(n, "child", None) is not None:
                rec(n.child)
        rec(plan)

    def _stage_batch(self, st: _GraphFlowState, stage, shared):
        spec = st.spec
        eng = self.engine
        scans = {}
        aliases, cols = scan_maps(stage.plan)
        for alias, tbl in aliases.items():
            if tbl.startswith("__x"):
                continue           # exchange pseudo-tables fill below
            scans[alias] = eng._device_table(tbl, cols[alias])
        for e in stage.inputs:
            scans[shfl.exch_table(e)] = self._edge_batch(
                st, st.graph.edges[e], shared)
        self._patch_probe_join(stage.plan, scans)
        runf = compile_plan(stage.plan, self._exec_params(spec))
        read_ts = int(spec.read_ts if spec.read_ts is not None
                      else eng.clock.now().to_int())
        return self._run(runf, scans, read_ts, st.psink)

    def _run_stage(self, st: _GraphFlowState, stage) -> None:
        from cockroach_tpu_torch.storage.columnstore import Dictionary
        spec = st.spec
        shared = Dictionary()
        if spec.trace:
            with tracing.capture("flow-stage", node=self.node_id,
                                 stage=stage.sid) as rec:
                batch = self._stage_batch(st, stage, shared)
            st.spans.append(tracing.span_to_wire(rec))
        else:
            batch = self._stage_batch(st, stage, shared)
        if stage.output is None:
            n, cols, valid = self._host_output(
                batch, stage.plan, st.graph.string_cols, shared)
            key = (spec.flow_id, spec.stream_id)
            self._producing.add(key)
            out = Outbox(self.transport, self.node_id, spec.gateway,
                         spec.flow_id, spec.stream_id, node=self,
                         window=spec.window)
            try:
                out.send_arrays(n, cols, valid, spec.chunk_rows)
                if spec.trace:
                    # every stage that ran on this node rides home on
                    # the gather stream, ahead of its EOF
                    for w in st.spans:
                        self._send_flow_span(spec, w)
                if st.psink is not None:
                    self._send_flow_profile(spec, {
                        "node": self.node_id,
                        "device_time_s": st.psink.wall_s,
                        "ops": st.psink.to_wire(node=self.node_id)})
                out.close()
            finally:
                self._producing.discard(key)
                self.acks.pop(key, None)
                self.engine.movement.note_exchange(out.bytes_sent)
            return
        edge = st.graph.edges[stage.output]
        n, cols, valid = self._host_output(
            batch, stage.plan, edge.string_cols, shared)
        consumers = list(spec.data_nodes)
        buckets = (shfl.partition_buckets(cols, valid, edge.keys,
                                          len(consumers))
                   if n else None)
        keys = []
        sent = 0
        try:
            for i, c in enumerate(consumers):
                sid = _xstream(stage.output, self.node_id, c)
                key = (spec.flow_id, sid)
                keys.append(key)
                self._producing.add(key)
                ob = Outbox(self.transport, self.node_id, c,
                            spec.flow_id, sid, node=self,
                            window=spec.window)
                if n:
                    m = buckets == i
                    ob.send_arrays(int(m.sum()),
                                   {k: v[m] for k, v in cols.items()},
                                   {k: v[m] for k, v in valid.items()},
                                   spec.chunk_rows)
                else:
                    ob.send_arrays(0, cols, valid, spec.chunk_rows)
                ob.close()
                sent += ob.bytes_sent
        finally:
            for key in keys:
                self._producing.discard(key)
                self.acks.pop(key, None)
            self.engine.movement.note_exchange(sent)


def _final_params(union: ColumnBatch) -> ExecParams:
    """The gateway's stages over a union: a hash GROUP BY there holds at
    most one group a union row, so its table is sized to twice the rows
    (a power of two, under the hashtable's half-load bound) instead of
    the session default's 2^17 slots, which every per-group array of the
    final stage would span. The port's sizing; the rows are the same."""
    return ExecParams(hash_group_capacity=1 << max(10, (2 * union.n)
                                                   .bit_length()))


def _collect_scans(node) -> dict[str, str]:
    from cockroach_tpu_torch.sql import plan as P
    out: dict[str, str] = {}

    def rec(n):
        if isinstance(n, P.Scan):
            if n.table != UNION:
                out[n.alias] = n.table
        elif isinstance(n, P.HashJoin):
            rec(n.left)
            rec(n.right)
        elif hasattr(n, "child"):
            rec(n.child)
    rec(node)
    return out


def _join_build_aliases(node) -> set:
    """Aliases scanned under any hash-join BUILD subtree. A build side
    must be device-resident in full (probing against pages of it would
    drop matches), so those scans never take the paged rung."""
    from cockroach_tpu_torch.sql import plan as P
    out: set = set()

    def rec(n, under_build):
        if isinstance(n, P.Scan):
            if under_build and n.table != UNION:
                out.add(n.alias)
        elif isinstance(n, P.HashJoin):
            rec(n.left, under_build)
            rec(n.right, True)
        elif hasattr(n, "child"):
            rec(n.child, under_build)
    rec(node, False)
    return out


class Gateway:
    """Plans and runs one distributed statement (PlanAndRunAll,
    ``pkg/sql/distsql_running.go:1519``). The gateway owns a
    DistSQLNode (it may itself hold a shard) and fans SetupFlow out to
    every data node."""

    # Idle deadline of a flow: only true silence this long fails it
    FLOW_TIMEOUT = 300.0

    def __init__(self, own: DistSQLNode, data_nodes: list[int],
                 replicated_tables: set | None = None,
                 flow_timeout: float = FLOW_TIMEOUT,
                 monitor=None, window: int = 8, cluster=None,
                 prefer_shuffle: bool = False,
                 adaptive_agg: bool = True,
                 overlap: bool = True,
                 merge_fanout: int = 0,
                 elastic=None):
        if cluster is not None:
            raise FlowUnsupported(f"Gateway(cluster=...): {_LEASEHOLDER}")
        if elastic is not None:
            raise FlowUnsupported(f"Gateway(elastic=...): {_ELASTIC}")
        # prefer_shuffle: route every shuffle-decomposable statement
        # through the multi-stage hash-exchange graph, even when a
        # single-stage plan would work (the sharded x sharded join
        # takes it regardless: it has no single-stage plan)
        self.prefer_shuffle = prefer_shuffle
        # adaptive partial aggregation: each shard picks partials or
        # raw rows per statement; off forces the always-partial stage
        self.adaptive_agg = adaptive_agg
        # overlapped exchange: producers double-buffer compute against
        # host transfer and send; off = compute-then-ship
        self.overlap = overlap
        # hierarchical partial-agg merge: >0 arranges combine-exact
        # partial-agg streams into a merge_fanout-ary tree (heap layout
        # over the stream indices, stream 0 = the first node) instead
        # of the flat fan-in into the gateway; 0 = flat
        self.merge_fanout = int(merge_fanout)
        self.own = own
        self.nodes = data_nodes
        # tables fully present on every data node (dimension tables);
        # join build sides must come from these unless the graph flow
        # co-partitions both sides
        self.replicated_tables = replicated_tables or set()
        self.flow_timeout = flow_timeout
        # anything with healthy(node): lets the gateway fail fast on a
        # breaker-tripped peer instead of waiting out flow_timeout
        self.monitor = monitor
        self.window = window
        # DistSQL planner metrics ride the gateway engine's registry
        self.metrics = getattr(own.engine, "metrics", None)

    def _count(self, name: str, help_: str = "") -> None:
        if self.metrics is not None:
            self.metrics.counter(name, help_).inc()

    def _check_join_placement(self, plan_node) -> None:
        from cockroach_tpu_torch.distsql.physical import DistUnsupported
        from cockroach_tpu_torch.sql import plan as P

        def rec(n, build_side):
            if isinstance(n, P.Scan):
                if build_side and n.table not in self.replicated_tables:
                    raise DistUnsupported(
                        f"join build side {n.table!r} is not replicated "
                        "on all data nodes (shuffle joins not "
                        "supported yet)")
            elif isinstance(n, P.HashJoin):
                rec(n.left, build_side)
                rec(n.right, True)
            elif hasattr(n, "child"):
                rec(n.child, build_side)
        rec(plan_node, False)

    def _derive_join_frames(self, plan_node, read_ts):
        """Join-induced data skipping across the fabric: wire frames
        derived at the GATEWAY from replicated join build sides, applied
        by every data node to its probe-side shard scan so
        non-matching chunks skip host-side before anything crosses the
        transport. _check_join_placement has proven every build side
        replicated, so the gateway's copy of each is complete."""
        from cockroach_tpu_torch.exec import joinfilter as jf
        eng = self.own.engine
        frames = []
        for alias, tbl in _collect_scans(plan_node).items():
            if tbl == UNION or tbl in self.replicated_tables:
                continue  # probe spines only: sharded scans
            for spec in jf.find_specs(plan_node, alias, eng.store):
                if spec.build_table not in self.replicated_tables:
                    continue
                try:
                    f = jf.derive(eng, spec, int(read_ts))
                except Exception:
                    f = None
                if f is not None:
                    frames.append(f.to_wire())
        return frames or None

    def _pick_graph(self, node):
        """Choose a multi-stage shuffle decomposition: mandatory for a
        sharded x sharded join (no single-stage plan exists), opt-in
        for everything else via prefer_shuffle."""
        kind = shfl.graph_kind(node)
        if kind is None:
            return None
        if self.prefer_shuffle:
            return kind
        if kind == "join" and self._has_unreplicated_build(node):
            return kind
        return None

    def _has_unreplicated_build(self, plan_node) -> bool:
        from cockroach_tpu_torch.sql import plan as P
        found = []

        def rec(n, build_side):
            if isinstance(n, P.Scan):
                if build_side and n.table not in self.replicated_tables:
                    found.append(n.table)
            elif isinstance(n, P.HashJoin):
                rec(n.left, build_side)
                rec(n.right, True)
            elif hasattr(n, "child"):
                rec(n.child, build_side)
        rec(plan_node, False)
        return bool(found)

    @staticmethod
    def _pallas_mode(session) -> str:
        if session is None:
            return "auto"
        return str(session.vars.get("pallas_groupagg", "auto")).lower()

    def run(self, sql: str, chunk_rows: int = 65536, session=None):
        """Plan and run one statement over the data nodes.

        With a ``session`` whose ``SET tracing`` mode is on|cluster, the
        statement runs under a capture appended to ``session.trace``;
        "cluster" sets the recording-request bit so remote flows record
        and ship node-tagged spans back. The session's
        ``pallas_groupagg`` rides every flow's spec. ``EXPLAIN ANALYZE
        [(DEBUG)]`` runs the statement under a recording or a profile.

        Without a cluster a flow whose participant is gone raises
        FlowUnavailable (the reference's replan and gateway-local rungs
        need the range plane)."""
        if session is not None:
            tmode = str(session.vars.get("tracing", "off")).lower()
            if tmode in ("on", "cluster"):
                with tracing.capture(
                        sql, gateway=self.own.node_id,
                        record_request=tmode == "cluster") as rec:
                    res = self._run_stmt(sql, chunk_rows, session)
                session.trace.append(rec)
                return res
        return self._run_stmt(sql, chunk_rows, session)

    def _run_stmt(self, sql: str, chunk_rows: int, session):
        stripped = sql.lstrip()
        if stripped[:15].upper() == "EXPLAIN ANALYZE":
            rest = stripped[15:].lstrip()
            debug = rest[:7].upper() == "(DEBUG)"
            if debug:
                rest = rest[7:].lstrip()
            return self.explain_analyze(rest, chunk_rows, debug=debug,
                                        session=session)
        return self._run_once(sql, chunk_rows, list(self.nodes),
                              pallas=self._pallas_mode(session))

    def explain_analyze(self, sql: str, chunk_rows: int = 65536,
                        debug: bool = False, session=None):
        """EXPLAIN ANALYZE over the fabric: run the statement under a
        recording; remote nodes ship their stage recordings back on
        the flow streams and the result renders the stitched,
        node-tagged span tree. With ``debug``, capture a diagnostics
        bundle instead (node-tagged operator profiles and the trace)."""
        from cockroach_tpu_torch.exec.session import Result
        if debug:
            return self._explain_analyze_debug(sql, chunk_rows, session)
        with tracing.capture("explain-analyze",
                             gateway=self.own.node_id) as rec:
            t0 = _time.monotonic()
            res = self.run(sql, chunk_rows, session)
            total_ms = (_time.monotonic() - t0) * 1e3
        lines = [f"total: {total_ms:.2f}ms, "
                 f"rows returned: {len(res.rows)}",
                 "trace:"]
        lines.extend("  " + ln for ln in rec.tree_lines())
        return Result(names=["info"], rows=[(ln,) for ln in lines],
                      tag="EXPLAIN ANALYZE")

    def _explain_analyze_debug(self, sql: str, chunk_rows: int, session):
        """EXPLAIN ANALYZE (DEBUG) over the fabric: run with the fine
        profile request bit set, so every remote flow runs under a sink
        of its own and ships its node-tagged operator table and
        execution time home (flow_profile frames); the gateway stitches
        them with its own final stage's operators into a diagnostics
        bundle, stores it in the engine's stmtdiag registry and returns
        it as one JSON row."""
        import json as _json
        from cockroach_tpu_torch.exec.session import Result
        from cockroach_tpu_torch.utils.sqlstats import fingerprint as _fp
        eng = self.own.engine
        psink = _prof.ProfileSink(device=eng.device)
        m0 = {k: v for k, v in eng.metrics.snapshot().items()
              if isinstance(v, (int, float))}
        with _prof.active(psink, fine=True):
            with tracing.capture("explain-analyze-debug",
                                 gateway=self.own.node_id,
                                 record_request=True) as rec:
                t0 = _time.monotonic()
                res = self.run(sql, chunk_rows, session)
                dt = _time.monotonic() - t0
        psink.resolve()
        # statement device time = the remote flows' execution times +
        # the gateway's own final stage's, each measured around the
        # profiled region, so the operators' times add up to it
        device_s = (sum(w for _n, w in psink.remote_walls)
                    + psink.wall_s)
        bundle = {"sql": sql, "fingerprint": _fp(sql),
                  "gateway": self.own.node_id,
                  "nodes": list(self.nodes),
                  "latency_s": dt,
                  "device_time_s": device_s,
                  "rows_returned": len(res.rows),
                  "profile": {
                      "device_time_s": device_s,
                      "ops": psink.to_wire(node=self.own.node_id)},
                  "trace": tracing.span_to_wire(rec),
                  "settings": {k: str(v) for k, v in
                               eng.settings.snapshot().items()}}
        m1 = {k: v for k, v in eng.metrics.snapshot().items()
              if isinstance(v, (int, float))}
        bundle["metric_deltas"] = {k: v - m0.get(k, 0)
                                   for k, v in m1.items()
                                   if v != m0.get(k, 0)}
        bundle["id"] = eng.stmtdiag.fulfill(None, bundle)
        return Result(names=["bundle"],
                      rows=[(_json.dumps(bundle, default=str),)],
                      tag="EXPLAIN ANALYZE (DEBUG)")

    def _run_final(self, final, meta, union, read_ts: int):
        """The gateway's final stage over the union, on its engine's
        device, through compile_plan and _materialize. Under a fine
        profile (EXPLAIN ANALYZE (DEBUG)) its operators record into
        the statement's sink."""
        eng = self.own.engine
        runf = compile_plan(final, _final_params(union), meta)
        out = runf(RunContext({UNION: union}, read_ts))
        return eng._materialize(out, meta)

    def _check_monitor(self, nodes) -> None:
        # fail fast on breaker-tripped peers: scheduling a flow onto a
        # dead node would only discover it after flow_timeout of silence
        if self.monitor is not None:
            sick = [n for n in nodes if n != self.own.node_id
                    and not self.monitor.healthy(n)]
            if sick:
                raise FlowUnavailable(
                    f"node(s) {sick} unhealthy (rpc breaker tripped); "
                    "not scheduling flow")

    def _run_once(self, sql: str, chunk_rows: int = 65536,
                  nodes: list | None = None, pallas: str = "auto"):
        # the node set is a PARAMETER (not shared state): a concurrent
        # statement must never tear another's view
        nodes = list(nodes) if nodes is not None else list(self.nodes)
        eng = self.own.engine
        transport = self.own.transport
        try:
            node, meta = Planner(
                # int_ranges off: key_int_range reflects only this
                # node's LOCAL shard
                eng.catalog_view(int_ranges=False),
                use_memo=False).plan_select(parser.parse(sql))
        except PlanError:
            # some plans only exist under shuffle binding: a
            # dictionary fold can turn a one-sided ON conjunct into a
            # side-less constant the legacy planner rejects; retry
            # with the graph planner before giving up
            node, _ = Planner(
                eng.catalog_view(int_ranges=False, stats=False),
                use_memo=False,
                dict_folds=False).plan_select(parser.parse(sql))
            kind = shfl.graph_kind(node)
            if kind is None:
                raise
            return self._run_graph(sql, kind, chunk_rows, nodes, pallas)
        kind = self._pick_graph(node)
        if kind is not None:
            return self._run_graph(sql, kind, chunk_rows, nodes, pallas)
        self._check_join_placement(node)
        stage = split(node)
        flow_id = uuid.uuid4().hex[:12]
        read_ts = int(eng.clock.now().to_int())
        jf_frames = self._derive_join_frames(node, read_ts)
        self._check_monitor(nodes)

        # SetupFlow to each participant; stream i <- node i
        self._count("distsql.flows.launched",
                    "distributed flows fanned out by this gateway")
        # remote flows record only when the statement's capture asked
        # for remote recordings (SET tracing = cluster / EXPLAIN
        # ANALYZE); operator profiles likewise
        trace = tracing.recording_requested()
        profiled = _prof.requested()
        registry = self.own.registry
        adaptive = (self.adaptive_agg and stage.stage == "partial_agg"
                    and stage.raw_local is not None)
        # hierarchical merge: only combine-exact partial-agg flows may
        # tree-merge (any fold order is bit-identical); stream i rides
        # node i, the tree is a heap over stream indices, so stream 0
        # is the root and the gateway pumps ONE inbox
        fan = self.merge_fanout
        tree = (fan > 0 and stage.stage == "partial_agg"
                and stage.merge_exact and len(nodes) >= 2)
        if tree:
            self._count("distsql.flows.tree",
                        "distributed flows whose partial-agg streams "
                        "ran as a hierarchical merge tree")
        inboxes = []
        inbox_nodes = []
        for i, nid in enumerate(nodes):
            merge_to = merge_children = None
            if tree:
                if i > 0:
                    merge_to = nodes[(i - 1) // fan]
                kids = [k for k in range(fan * i + 1, fan * i + 1 + fan)
                        if k < len(nodes)]
                merge_children = kids or None
            spec = FlowSpec(flow_id, self.own.node_id, stage.stage, sql,
                            stream_id=i, chunk_rows=chunk_rows,
                            read_ts=read_ts, window=self.window,
                            trace=trace, joinfilter=jf_frames,
                            adaptive=adaptive, profile=profiled,
                            overlap=self.overlap,
                            merge_to=merge_to,
                            merge_children=merge_children,
                            merge_timeout=self.flow_timeout,
                            pallas_groupagg=pallas)
            if not tree or i == 0:
                # mid-tree streams terminate at their merge parent;
                # only the root stream reaches the gateway
                inboxes.append(registry.inbox(flow_id, i))
                inbox_nodes.append(nid)
            transport.send(self.own.node_id, nid,
                           ("setup_flow", spec.to_wire()))
        union, merged_dicts = self._pump_and_union(
            flow_id, inboxes, stage.union_columns, stage.string_cols,
            nodes, stage=(stage if adaptive else None),
            read_ts=read_ts,
            participants=(list(nodes) if tree else None),
            inbox_nodes=inbox_nodes)
        # output dictionaries come from the merged wire strings, not
        # the gateway's (possibly empty) local shard
        for out_name, union_col in stage.dict_outputs.items():
            if union_col in merged_dicts:
                meta.dictionaries[out_name] = merged_dicts[union_col]
        return self._run_final(stage.final, meta, union, read_ts)

    def _run_graph(self, sql: str, kind: str, chunk_rows: int,
                   nodes: list | None = None, pallas: str = "auto"):
        """Run one multi-stage shuffle flow (distsql/shuffle.py): every
        data node scans its shard, hash-exchanges rows with its peers,
        and gathers finished results to the gateway."""
        eng = self.own.engine
        transport = self.own.transport
        # stats=False: decomposition must match what every node
        # re-derives (shuffle.py module docstring)
        node, meta = Planner(
            eng.catalog_view(int_ranges=False, stats=False),
            use_memo=False,
            dict_folds=False).plan_select(parser.parse(sql))
        nodes = list(nodes) if nodes is not None else list(self.nodes)
        graph = shfl.decompose(kind, node)
        flow_id = uuid.uuid4().hex[:12]
        read_ts = int(eng.clock.now().to_int())
        self._check_monitor(nodes)
        self._count("distsql.flows.launched",
                    "distributed flows fanned out by this gateway")
        self._count("distsql.flows.graph",
                    "distributed flows run as multi-stage shuffle graphs")
        trace = tracing.recording_requested()
        profiled = _prof.requested()
        registry = self.own.registry
        inboxes = []
        for nid in nodes:
            sid = f"g:p{nid}"
            spec = FlowSpec(flow_id, self.own.node_id, "graph", sql,
                            stream_id=sid, chunk_rows=chunk_rows,
                            read_ts=read_ts, window=self.window,
                            graph=kind, data_nodes=list(nodes),
                            trace=trace, profile=profiled,
                            pallas_groupagg=pallas)
            inboxes.append(registry.inbox(flow_id, sid))
            transport.send(self.own.node_id, nid,
                           ("setup_flow", spec.to_wire()))
        union, merged_dicts = self._pump_and_union(
            flow_id, inboxes, graph.union_columns, graph.string_cols,
            nodes)
        for out_name, union_col in graph.dict_outputs.items():
            if union_col in merged_dicts:
                meta.dictionaries[out_name] = merged_dicts[union_col]
        return self._run_final(graph.final, meta, union, read_ts)

    def _pump_and_union(self, flow_id, inboxes, union_columns,
                        string_cols, nodes: list | None = None,
                        stage=None, read_ts=None,
                        participants: list | None = None,
                        inbox_nodes: list | None = None):
        # participants: the FULL node set feeding this flow when it is
        # wider than the direct producers (hierarchical merge): the
        # monitor fail-fast watches them all. inbox_nodes: producer
        # node per inbox (positional with ``inboxes``)
        nodes = nodes if nodes is not None else list(self.nodes)
        if inbox_nodes is None:
            inbox_nodes = list(nodes[:len(inboxes)])
        transport = self.own.transport
        registry = self.own.registry
        # drive the network until all streams finish: the in-process
        # transport is synchronous, so an empty queue means stalled
        fail_fast = None
        for spin in range(100_000_000):
            if all(ib.eof for ib in inboxes):
                break
            if self.monitor is not None and spin % 256 == 255:
                # a peer that trips mid-flow will never send EOF; stop
                # waiting for it the moment the breaker says so
                if participants is not None:
                    waiting = [n for n in participants
                               if n != self.own.node_id]
                else:
                    waiting = [inbox_nodes[i]
                               for i, ib in enumerate(inboxes)
                               if not ib.eof and
                               inbox_nodes[i] != self.own.node_id]
                sick = [n for n in waiting
                        if not self.monitor.healthy(n)]
                if sick:
                    fail_fast = FlowUnavailable(
                        f"node(s) {sick} became unhealthy mid-flow")
                    break
            if transport.deliver_all() == 0 and \
                    transport.pending() == 0:
                break
        try:
            if fail_fast is not None:
                raise fail_fast
            errs = [ib.error for ib in inboxes if ib.error]
            if errs:
                if any(_UNAVAILABLE_MARK in e for e in errs):
                    # a mid-tree node timed out on a child stream: a
                    # participant is gone, not a statement error
                    raise FlowUnavailable("; ".join(errs))
                raise FlowError("; ".join(errs))
            if not all(ib.eof for ib in inboxes):
                raise FlowUnavailable("flow streams stalled")
            # stitch the remote recordings that rode the streams into
            # the statement's active span (no-op unless recording)
            for ib in inboxes:
                for w in ib.spans:
                    tracing.attach_remote(w)
            # the same stitch for operator profiles: node-tagged remote
            # op tables and per-node execution times merge into the
            # statement's sink; the gather's bytes ride along
            psink = _prof.current()
            if psink is not None:
                total_rx = sum(ib.bytes_received for ib in inboxes)
                if total_rx:
                    psink.note("shuffle:gather", batches=len(inboxes),
                               bytes_shuffled=total_rx)
                for ib in inboxes:
                    for w in ib.profiles:
                        psink.merge_wire(w.get("ops", []),
                                         node=w.get("node"))
                        psink.remote_walls.append(
                            (w.get("node"),
                             float(w.get("device_time_s", 0.0))))
            chunks = [c for ib in inboxes for c in ib.drain_arrays()]
            if stage is not None:
                chunks = self._fold_raw_chunks(chunks, stage, read_ts)
            union, merged_dicts = self._union_batch(
                chunks, union_columns, string_cols)
        except Exception:
            # tell every producer to stop: without this a stalled or
            # errored flow leaves remote stages running and pushing
            # chunks at a gateway that has already given up
            for nid in nodes:
                transport.send(self.own.node_id, nid,
                               ("cancel_flow", flow_id))
            raise
        finally:
            registry.release(flow_id)
            # tombstone on the consuming node too: chunks still in
            # flight after release are dropped instead of re-creating
            # registry inboxes nobody will drain
            self.own._cancel(flow_id)
        return union, merged_dicts

    def _fold_raw_chunks(self, chunks, stage, read_ts):
        """Adaptive-aggregation merge: inbound chunks arrive partial
        (they carry the ``__p0..`` columns) or raw (source rows of
        shards whose group cardinality made partials pointless). Raw
        chunks union over the ``__rawunion`` pseudo-table and fold
        through stage.raw_merge, the combine-exact aggregate every node
        would have run, into ONE more partial-form chunk."""
        partial = [c for c in chunks if "__p0" in c[1]]
        raw = [c for c in chunks if "__p0" not in c[1]]
        if not raw:
            return partial
        self._count("distsql.agg.raw_folds",
                    "adaptive aggregation: gateway-side raw-row folds")
        raw_union, raw_dicts = self._union_batch(
            raw, stage.raw_columns, stage.raw_strings)
        runf = compile_plan(stage.raw_merge, _final_params(raw_union))
        out = runf(RunContext({RAW: raw_union}, int(read_ts)))
        n, cols, valid = _pull_output(out, "raw-row fold error")
        cols = {c: cols[c] for c in stage.union_columns}
        valid = {c: valid[c] for c in stage.union_columns}
        # dict-coded group keys came out as codes into the raw union's
        # merged dictionaries: decode to wire strings so the outer
        # union re-encodes them alongside the nodes' partial chunks
        _decode_strings(cols, valid, stage.string_cols, raw_dicts.get,
                        "raw-fold ")
        return partial + [(n, cols, valid)]

    def _union_batch(self, chunks, columns, string_cols):
        """The inbound chunks as one batch on the gateway engine's
        device, wire strings re-encoded against one merged dictionary
        per string column."""
        from cockroach_tpu_torch.storage.columnstore import Dictionary
        total, cols, valid, proto = _gather(chunks, columns)
        merged: dict[str, Dictionary] = {}
        if total == 0:
            data, vmask, sel = _empty_union(columns, string_cols, proto)
            for c in string_cols:
                merged[c] = Dictionary()
        else:
            data = {c: np.concatenate(cols[c]) for c in columns}
            vmask = {c: np.concatenate(valid[c]) for c in columns}
            sel = np.ones(total, dtype=bool)
            for c in string_cols:
                d = Dictionary()
                data[c] = d.encode_array(data[c].astype(str))
                merged[c] = d
        return (_device_batch(data, vmask, sel, self.own.engine.device),
                merged)
