"""Session state, results, errors and prepared statements (the subset of
cockroach_tpu/exec/session.py that this package's Engine uses)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..kv.txn import Txn
from ..storage.hlc import Timestamp
from ..utils.settings import SessionVars


class EngineError(Exception):
    pass


class HashCapacityExceeded(EngineError):
    """GROUP BY's distinct-key count exceeded the device hash table
    (``hash_group_capacity``). Prepared.run catches this and re-runs
    the plan hash-partitioned (Engine._run_partitioned)."""


class TopKInexact(EngineError):
    """The fused top-k ORDER BY ... LIMIT cut crossed a primary-key tie
    group (compile.py topk_sort_limit_batch). Prepared.run replans with
    the full device sort."""


class CompactOverflow(EngineError):
    """A selection-compaction block held more selected rows than its
    capacity (compile.py compact_batch): results would be missing rows.
    Prepared.run replans uncompacted."""


# The device error-sentinel columns a result batch may carry, in the
# order Engine._check_sentinels checks them.
SENTINEL_COLUMNS = ("__ht_overflow", "__sum_overflow",
                    "__topk_inexact", "__compact_overflow")


@dataclass
class Result:
    """Decoded query result."""
    names: list[str] = field(default_factory=list)
    rows: list[tuple] = field(default_factory=list)
    row_count: int = 0  # for DML
    tag: str = "SELECT"
    types: list = field(default_factory=list)  # SQLTypes (SELECT only)


@dataclass(eq=False)  # identity-hashed: sessions live in a WeakSet
class Session:
    """Per-connection state: the session variables and an open explicit
    transaction. The txn is a real kv.Txn: DML writes intents through
    it and buffers its scan-plane effects; COMMIT publishes them at the
    commit timestamp, ROLLBACK discards them."""
    vars: SessionVars = field(default_factory=SessionVars)
    txn: Optional[Txn] = None
    # ordered (table, op) effects: ("put", key, row) | ("del", key)
    effects: list = field(default_factory=list)
    # a failed statement aborts the whole txn (pg: "current transaction
    # is aborted" until ROLLBACK), which keeps statements atomic
    txn_aborted: bool = False
    # currval() state: sequence name -> last nextval in this session
    seq_currval: dict = field(default_factory=dict)
    # SET tracing = on: each statement's recording (utils/tracing.py
    # Span), shown by SHOW TRACE FOR SESSION
    trace: list = field(default_factory=list)

    @property
    def in_txn(self) -> bool:
        return self.txn is not None

    @property
    def txn_read_ts(self) -> Optional[Timestamp]:
        return self.txn.meta.read_ts if self.txn is not None else None


@dataclass(eq=False)
class Prepared:
    """A planned and compiled SELECT bound to device-resident tables.

    ``dispatch()`` runs the compiled plan and returns the device result
    batch; ``run()`` dispatches and materializes. The read timestamp is
    taken per execution. Before each one the generations of every table
    the preparation read (its scans and the tables behind subqueries it
    inlined as constants) are checked, and a moved generation
    re-prepares the statement into this handle, so a prepared statement
    sees current data like a pgwire portal re-executed after Bind.

    ``run()`` turns the result's sentinels into re-runs: a top-k cut
    that crossed a tie replans with the full sort (``no_topk``), an
    overflowed compaction block replans uncompacted (``no_compact``),
    and a hash GROUP BY past ``hash_group_capacity`` re-runs this plan
    partition by partition (Engine._run_partitioned). The flags stay
    set on the handle once a run needed them.

    A plan placed beyond memory runs page by page on every dispatch:
    ``stream`` = (alias, table, page_rows) pages the fact table through
    the card, ``spill`` (exec/spill.py SpillPlan) runs a partitioned
    external hash join or an external merge sort. The placement is
    decided again when the budget, the placement session variables or
    a table's generation moved since the preparation."""

    engine: object
    session: Session
    stmt: object                    # the ast.Select
    sql_text: str
    runf: object                    # compiled plan: RunContext -> batch
    scans: dict                     # alias -> device ColumnBatch
    meta: object                    # P.OutputMeta
    gens: tuple                     # ((table, generation), ...)
    node: object                    # the final plan (for partitioning)
    no_topk: bool = False
    no_compact: bool = False
    # beyond-memory paging: (alias, table, page_rows) of the streamed
    # fact table, its pruned columns, and the zone checks of its
    # pushed-down predicates (exec/stream.py extract_zone_preds)
    stream: Optional[tuple] = None
    stream_cols: Optional[frozenset] = None
    stream_zone: tuple = ()
    # the out-of-core verdict (exec/spill.py SpillPlan) and the spilled
    # build side's pruned columns (the probe's ride stream_cols)
    spill: Optional[object] = None
    spill_cols: Optional[frozenset] = None
    # join-induced skipping: JoinFilterSpecs over the paged probe,
    # summarized per dispatch at its read timestamp
    joinfilter: tuple = ()
    # Engine._placement_key at preparation
    placement: tuple = ()
    # alias -> table of every scan (a composed CTE run feeds the temps'
    # aliases batches of its own, exec/ctecompose.py)
    scan_tables: dict = field(default_factory=dict)
    # AS OF SYSTEM TIME: the fixed historical read timestamp of every
    # run (an interval form resolves again when the handle re-prepares)
    as_of: Optional[Timestamp] = None
    # statement-shape plan cache (exec/planparam.py): this statement's
    # lifted filter literals, as Python scalars, for the shared plan's
    # BParam nodes; () = not parameterized
    params: tuple = ()

    def _refresh(self) -> None:
        eng = self.engine
        cur = tuple((t, eng.store.table(t).generation
                     if t in eng.store.tables else -1)
                    for t, _ in self.gens)
        written = eng._overlay_puts(self.session)
        if cur != self.gens or any(t in written for t, _ in self.gens) \
                or eng._placement_key(self.session) != self.placement:
            self._reprepare()

    def _reprepare(self) -> None:
        p = self.engine._prepare_select(
            self.stmt, self.session, self.sql_text,
            no_topk=self.no_topk, no_compact=self.no_compact)
        for f in ("runf", "scans", "meta", "gens", "node", "stream",
                  "stream_cols", "stream_zone", "spill", "spill_cols",
                  "joinfilter", "placement", "scan_tables", "as_of",
                  "params"):
            setattr(self, f, getattr(p, f))

    def _join_filters(self, tsv: int) -> tuple:
        """This dispatch's semi-join filters (exec/joinfilter.py),
        derived under the reference's default rule (auto: builds up to
        joinfilter.AUTO_BUILD_CAP rows)."""
        if not self.joinfilter:
            return ()
        from . import joinfilter as jf
        out = []
        for spec in self.joinfilter:
            f = jf.derive(self.engine, spec, tsv)
            if f is not None:
                out.append(f)
        return tuple(out)

    def dispatch(self, read_ts=None):
        """Run the compiled plan once; the device result batch."""
        from .compile import RunContext
        self._refresh()
        ts = read_ts or self.as_of or self.engine._read_ts(self.session)
        tsv = ts.to_int()
        if self.spill is not None:
            if self.spill.kind != "join":
                raise EngineError("spill-sort statements merge on the "
                                  "host; use Prepared.run()")
            from .spill import run_spill_join
            return run_spill_join(self.engine, self, tsv)
        if self.stream is not None:
            return self._dispatch_paged(tsv)
        rc = RunContext(self.scans, tsv, params=self.params)
        out = self.runf(rc)
        self.engine._note_route(self, rc.route)
        return out

    def warm(self, bucket: int = 0) -> None:
        """Make a paged statement ready without reading its data
        (Engine.prewarm): its plan was built and its resident tables
        uploaded when it was prepared; here the kernel libraries load,
        and a streamed plan runs one never-visible padding page of
        ``bucket`` rows (its page rows when 0) through its page, combine
        and final steps, the path a run whose pages are all skipped
        takes."""
        from .compile import RunContext
        eng = self.engine
        if eng.device.type == "cuda":
            from ..ops.cuda import groupagg, groupagg_large
            groupagg._lib()
            groupagg_large._lib()
        if self.stream is None:
            return
        alias, tname, page_rows = self.stream
        src = eng._page_source(tname, self.stream_cols, bucket or page_rows)
        scans = dict(self.scans)
        scans[alias] = src.empty_page()
        tsv = eng._read_ts(self.session).to_int()
        s = self.runf.page_fn(RunContext(scans, tsv))
        s = self.runf.combine(s, s)
        self.runf.final_fn(s)

    def _dispatch_paged(self, tsv: int):
        """The streamed plan: page partials combined on the card, then
        finalized. A background worker uploads page i+1 while page i
        computes (``streaming_pipeline = off`` keeps it synchronous);
        zone-, MVCC- and join-filter-pruned pages never move. No step
        reads a device value back to the host."""
        from .compile import RunContext
        from .spill import _STALL_HELP, _StallSum
        eng = self.engine
        alias, tname, page_rows = self.stream
        pipeline = str(self.session.vars.get("streaming_pipeline",
                                             "on")) != "off"
        zpreds = self.stream_zone
        filters = self._join_filters(tsv)
        if filters:
            from .joinfilter import zone_pred
            zpreds = zpreds + tuple(zone_pred(f) for f in filters)
        src = eng._page_source(tname, self.stream_cols, page_rows,
                               zone_preds=zpreds, read_ts=tsv)
        stall = _StallSum(eng.metrics.histogram(
            "exec.stream.prefetch_stall_seconds", _STALL_HELP))
        skipped0 = eng.metrics.counter("exec.stream.pages_skipped").value()
        scans = dict(self.scans)
        route = RunContext.new_route()
        state = None
        pages = 0
        for page in eng._stream_pages(src, pipeline, stall):
            scans[alias] = page
            s = self.runf.page_fn(RunContext(scans, tsv, route=route))
            state = s if state is None else self.runf.combine(state, s)
            pages += 1
        if state is None:
            # every page was skipped: one never-visible padding page
            # gives the aggregate its empty state (COUNT 0, NULL sums)
            scans[alias] = src.empty_page()
            state = self.runf.page_fn(RunContext(scans, tsv, route=route))
        out = self.runf.final_fn(state)
        overlap = max(0.0, src.busy_seconds - stall.total) if pipeline \
            else 0.0
        eng.movement.note_overlap(overlap)
        eng._note_route(self, route)
        eng._note_paging(
            self, "stream", pages=pages, bytes_moved=src.bytes_moved,
            stall=stall.total if pipeline else 0.0, overlap=overlap,
            busy=src.busy_seconds,
            skipped=eng.metrics.counter("exec.stream.pages_skipped")
            .value() - skipped0)
        return out

    def checked(self, read_ts=None):
        """Dispatch until the result batch carries no replan sentinel:
        the checked device batch. HashCapacityExceeded and the SUM
        overflow error reach the caller."""
        while True:
            out = self.dispatch(read_ts)
            try:
                self.engine._check_sentinels(out)
                return out
            except TopKInexact:
                self._replan("no_topk")
            except CompactOverflow:
                self._replan("no_compact")

    def run(self, read_ts=None) -> Result:
        eng = self.engine
        s = self.session
        # the gate's side by execute()'s rule: uncorrelated subqueries
        # re-run when a generation moves, and can materialize temps
        with eng._run_scope({t for t, _ in self.gens},
                            eng._stmt_read_only(self.stmt, s,
                                                self.sql_text)), \
                eng._statement():
            self._refresh()
            if self.spill is not None and self.spill.kind == "sort":
                # the external merge sort's tail runs on the host
                from .spill import run_spill_sort
                ts = read_ts or self.as_of or eng._read_ts(self.session)
                with eng.tracer.span("dispatch"):
                    return run_spill_sort(eng, self, ts.to_int())
            while True:
                try:
                    with eng.tracer.span("dispatch"):
                        out = self.checked(read_ts)
                    with eng.tracer.span("materialize"):
                        return eng._materialize(out, self.meta,
                                                check=False)
                except HashCapacityExceeded:
                    try:
                        return eng._run_partitioned(
                            self, read_ts or self.as_of)
                    except CompactOverflow:
                        self._replan("no_compact")

    def _replan(self, flag: str) -> None:
        if getattr(self, flag):
            raise EngineError(f"{flag} replan did not converge")
        setattr(self, flag, True)
        self.engine._note_replan(flag)
        self._reprepare()
