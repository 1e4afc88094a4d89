"""Session state, results, errors and prepared statements (the subset of
cockroach_tpu/exec/session.py that this package's Engine uses)."""

from __future__ import annotations

from dataclasses import dataclass, field

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
    tag: str = "SELECT"
    types: list = field(default_factory=list)  # SQLTypes (SELECT only)


@dataclass(eq=False)
class Session:
    """Per-connection state: the session variables."""
    vars: SessionVars = field(default_factory=SessionVars)


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
    set on the handle once a run needed them."""

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

    def _refresh(self) -> None:
        eng = self.engine
        cur = tuple((t, eng.store.table(t).generation
                     if t in eng.store.tables else -1)
                    for t, _ in self.gens)
        if cur != self.gens:
            self._reprepare()

    def _reprepare(self) -> None:
        p = self.engine._prepare_select(
            self.stmt, self.session, self.sql_text,
            no_topk=self.no_topk, no_compact=self.no_compact)
        self.runf, self.scans, self.meta = p.runf, p.scans, p.meta
        self.gens, self.node = p.gens, p.node

    def dispatch(self, read_ts=None):
        """Run the compiled plan once; the device result batch."""
        from .compile import RunContext
        self._refresh()
        ts = read_ts or self.engine.clock.now()
        rc = RunContext(self.scans, ts.to_int())
        out = self.runf(rc)
        self.engine._note_route(self, rc.route)
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
        with eng._statement():
            while True:
                try:
                    return eng._materialize(self.checked(read_ts),
                                            self.meta, check=False)
                except HashCapacityExceeded:
                    try:
                        return eng._run_partitioned(self, read_ts)
                    except CompactOverflow:
                        self._replan("no_compact")

    def _replan(self, flag: str) -> None:
        if getattr(self, flag):
            raise EngineError(f"{flag} replan did not converge")
        setattr(self, flag, True)
        self.engine._note_replan(flag)
        self._reprepare()
