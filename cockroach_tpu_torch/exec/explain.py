"""What an operator reads: SHOW, EXPLAIN [ANALYZE [(DEBUG)]], session
tracing, the slow-statement ring and statement diagnostics (the
reference's cockroach_tpu/exec/engine.py:1203-1757 and the statement
observability of its ``_execute_stmt_inner``).

``StatementObserver`` wraps one ``Engine.execute``: the trace capture
(``SET tracing = on | cluster``, the slow-statement threshold
``sql.trace.slow_statement.threshold``, an armed diagnostics request),
the coarse profile sink (``sql.stmt_profile.enabled``), and the
statement's time on the card: a pair of CUDA events around its dispatch
on a CUDA engine, the host clock on a CPU engine (whose operators run
synchronously). The reference records the statement's wall time less
its XLA compile time as ``device_seconds``; the port takes it from the
card.

EXPLAIN ANALYZE runs the statement once, under a fine profile sink
(exec/profile.py): each operator of the plan it ran reports its rows and
its device time, and the rendered plan is that plan. The reference
executes the statement and then re-runs a fresh plan, unjitted, for the
measurement; the port's operators run eagerly already, so one run gives
both the result and the measurement, and each kernel launches once. Like
the reference's measured re-run, the analyzed run takes no selection
compaction and lifts no literal into a parameter, so the rendered plan
is the planner's. In place of the reference's ``xla compile`` line (its
XLA backend compile) the port prints ``plan build and kernel load``: the
statement's seconds in plan builds and kernel library builds and loads
(exec/coldstart.py), when there were any.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch

from ..sql import ast
from ..sql import plan as P
from ..utils import tracing
from ..utils.settings import SettingError
from ..utils.sqlstats import fingerprint
from . import coldstart, profile
from .scanplane import scan_maps
from .session import EngineError, Result
from .stmtutil import render_create


class StatementObserver:
    """The observability of one ``Engine.execute``: ``observe()`` wraps
    its dispatch, ``finished`` or ``failed`` closes it."""

    def __init__(self, eng, stmt, session, sql: str):
        self.eng, self.stmt, self.session, self.sql = eng, stmt, session, sql
        is_show_trace = isinstance(stmt, ast.ShowTrace)
        mode = str(session.vars.get("tracing", "off")).lower()
        # on one node "cluster" records what "on" records: there are no
        # remote participants to ask for recordings
        self.tracing = mode in ("on", "cluster") and not is_show_trace
        self.record_request = mode == "cluster" if self.tracing else True
        self.slow = float(eng.settings.get(
            "sql.trace.slow_statement.threshold"))
        self.fp = fingerprint(sql) if sql else type(stmt).__name__
        # an armed diagnostics request captures this execution: a trace
        # recording, the fine profile and a before-snapshot of metrics
        self.diag_req = eng.stmtdiag.should_capture(self.fp) if sql else None
        self.diag_m0 = (eng.metrics.snapshot()
                        if self.diag_req is not None else None)
        self.psink = (profile.ProfileSink(eng.device)
                      if self.diag_req is not None
                      or eng.settings.get("sql.stmt_profile.enabled")
                      else None)
        # slow-statement sampling records untraced statements too, never
        # a nested one (an open span means an outer statement records)
        self.capture = self.tracing or self.diag_req is not None or (
            self.slow > 0 and tracing.current_span() is None
            and not is_show_trace)
        self.rec = None
        self._clock = None
        # the statement's compile seconds (Engine.execute sets them)
        self.compile_s = 0.0

    @contextlib.contextmanager
    def observe(self):
        eng = self.eng
        with profile.active(self.psink, fine=self.diag_req is not None):
            if self.capture:
                with eng.tracer.capture(
                        self.sql or type(self.stmt).__name__,
                        record_request=self.record_request) as rec:
                    self.rec = rec
                    with self._device_clock():
                        yield
                if self.tracing:
                    self.session.trace.append(rec)
            else:
                with eng.tracer.span(
                        f"stmt:{type(self.stmt).__name__.lower()}"):
                    with self._device_clock():
                        yield

    @contextlib.contextmanager
    def _device_clock(self):
        """CUDA events around the dispatch on a CUDA engine (no sync
        here: ``device_seconds`` reads them once the result is on the
        host), the host clock on a CPU engine; nothing without a
        sink."""
        if self.psink is None:
            yield
            return
        if self.eng.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self._clock = (start, end)
        else:
            t0 = time.perf_counter()
            yield
            self._clock = time.perf_counter() - t0

    def device_seconds(self) -> float | None:
        c = self._clock
        if c is None:
            return None
        if isinstance(c, tuple):
            c[1].synchronize()
            return c[0].elapsed_time(c[1]) / 1e3
        return c

    def failed(self) -> None:
        # the armed execution failed: keep the request pending for the
        # next matching execution
        if self.diag_req is not None:
            self.eng.stmtdiag.rearm(self.fp, self.diag_req)

    def finished(self, res: Result, dt: float) -> None:
        eng, psink = self.eng, self.psink
        if psink is not None:
            psink.resolve()
            eng.metrics.counter(
                "exec.profile.statements",
                "statements executed with an active profile sink").inc()
            n_ops = len(psink.entries())
            if n_ops:
                eng.metrics.counter(
                    "exec.profile.operators",
                    "operator entries recorded into profile sinks"
                ).inc(n_ops)
            eng.last_profile = psink
        if self.rec is not None and self.slow > 0 and dt >= self.slow:
            # tenant-attributable slow traces: application_name and the
            # session ride every ring entry (/debug/tracez)
            eng.slow_traces.append({
                "sql": self.sql or type(self.stmt).__name__,
                "fingerprint": self.fp,
                "application_name": str(
                    self.session.vars.get("application_name") or ""),
                "session": f"s{id(self.session):x}",
                "duration_s": dt,
                "span": tracing.span_to_wire(self.rec)})
        if self.diag_req is not None:
            # diagnostics never fail the statement that carried them: a
            # failed assembly re-arms the request
            try:
                bundle = eng._diag_bundle(
                    self.stmt, self.session, self.sql, self.rec, psink, dt,
                    self.diag_m0, self.device_seconds(),
                    compile_s=self.compile_s)
                eng.stmtdiag.fulfill(self.diag_req, bundle)
            except Exception:
                eng.stmtdiag.rearm(self.fp, self.diag_req)


class ExplainMixin:
    """SHOW, EXPLAIN and the diagnostics of the Engine."""

    # -- SHOW ----------------------------------------------------------
    def _exec_show(self, stmt, session) -> Result:
        if isinstance(stmt, ast.ShowVar):
            v = session.vars.get(stmt.name, None)
            if v is None:
                try:
                    v = self.settings.get(stmt.name)
                except SettingError as e:
                    raise EngineError(str(e)) from e
            return Result(names=[stmt.name], rows=[(v,)], tag="SHOW")
        if isinstance(stmt, ast.ShowAll):
            return Result(
                names=["variable", "value"],
                rows=sorted((k, str(v))
                            for k, v in session.vars.values.items()),
                tag="SHOW ALL")
        if isinstance(stmt, ast.ShowTables):
            descs = sorted(self.catalog.list_tables(), key=lambda d: d.name)
            return Result(names=["table_name", "version"],
                          rows=[(d.name, d.version) for d in descs
                                if not d.name.startswith("__")],
                          tag="SHOW TABLES")
        if isinstance(stmt, ast.ShowTrace):
            return Result(names=["span"],
                          rows=[(line,) for rec in session.trace
                                for line in rec.tree_lines()],
                          tag="SHOW TRACE")
        d = self.catalog.get_by_name(stmt.table)
        if d is None:
            raise EngineError(f"table {stmt.table!r} does not exist")
        if isinstance(stmt, ast.ShowColumns):
            idx_cols = {cn for i in d.indexes for cn in i.columns} \
                | set(d.primary_key)
            return Result(
                names=["column_name", "data_type", "is_nullable",
                       "indexed"],
                rows=[(c.name, str(c.type), c.nullable, c.name in idx_cols)
                      for c in d.columns if c.state == "public"],
                tag="SHOW COLUMNS")
        # SHOW CREATE TABLE
        if d.view_sql:
            cols = (f" ({', '.join(d.view_columns)})"
                    if d.view_columns else "")
            ddl = f"CREATE VIEW {d.name}{cols} AS {d.view_sql}"
        else:
            ddl = render_create(d)
        return Result(names=["table_name", "create_statement"],
                      rows=[(d.name, ddl)], tag="SHOW CREATE TABLE")

    # -- EXPLAIN -------------------------------------------------------
    def _exec_explain(self, stmt: ast.Explain, session,
                      sql_text: str) -> Result:
        from ..sql.rules import RuleTrace
        from ..sql.stats import estimate
        if stmt.analyze:
            return self._explain_analyze(stmt.stmt, session, sql_text,
                                         debug=stmt.debug)
        target = stmt.stmt
        rtrace = RuleTrace()
        if isinstance(target, ast.Select):
            expanded = self._expand_views(target)
            if expanded is not target:
                rtrace.fire("expand_views")
            target = expanded
        if isinstance(target, ast.Select) and (
                target.ctes or self._has_derived(target)):
            # composite shapes (CTEs, derived tables, views): one plan
            # block a sub-select; the main stage is re-planned over the
            # materialized temps at execution
            return Result(names=["plan"],
                          rows=[(ln,) for ln in
                                self._explain_composite(target, session)],
                          tag="EXPLAIN")
        node, emeta = self._plan(target, session,
                                 self._stmt_read_ts(target, session),
                                 for_explain=True, trace=rtrace)
        costs = estimate(node, self.catalog_view().stats)
        tree = P.plan_tree_repr(node, costs=costs)
        rows = []
        tr = emeta.rule_trace
        if tr is not None and tr.firings:
            rows.append(("rules: " + "; ".join(tr.summary()),))
        for alias, (label, est, cost) in sorted(
                emeta.access_paths.items()):
            if not label.startswith("full"):
                rows.append((f"access: {alias} via {label} "
                             f"rows≈{est:.0f} cost≈{cost:.0f}",))
        if emeta.memo is not None:
            m_ = emeta.memo
            rows.append((f"memo: {m_.groups} groups, {m_.considered} "
                         f"plans costed; best order "
                         f"{[m_.root] + m_.order} cost≈{m_.cost:.0f}",))
        if isinstance(target, ast.Select):
            m = self._index_fastpath_match(target, session)
            if m is not None:
                label, cols, vals, _residual = m
                # the runtime's selectivity guard where a warm locator
                # exists; EXPLAIN never builds one (metadata only)
                tname = target.table.name
                td = self.store.table(tname)
                lim = int(session.vars.get("index_lookup_limit", 4096))
                cached = td.sec_index_cache.get(cols)
                declined = (cached is not None
                            and cached[0] == td.generation
                            and len(cached[1].get(vals, [])) > lim)
                if not declined:
                    rows.append((f"index scan {tname}@{label} "
                                 f"({', '.join(cols)}) = {vals!r}",))
        rows += [(line,) for line in tree.rstrip().split("\n")]
        return Result(names=["plan"], rows=rows, tag="EXPLAIN")

    def _explain_composite(self, sel: ast.Select, session) -> list[str]:
        """EXPLAIN of CTE, derived-table and view shapes: one plan block
        a sub-select; the main stage is re-planned over the
        materialized temps at execution."""
        from ..sql.stats import estimate
        lines: list[str] = []

        def emit(label: str, sub):
            if isinstance(sub, ast.Select):
                sub = self._expand_views(sub)
            lines.append(f"{label}:")
            if isinstance(sub, ast.Select) and (
                    sub.ctes or self._has_derived(sub)):
                lines.extend("  " + ln for ln in
                             self._explain_composite(sub, session))
            elif isinstance(sub, ast.Select) and sub.table is not None:
                node, _ = self._plan(sub, session, self._read_ts(session),
                                     for_explain=True)
                costs = estimate(node, self.catalog_view().stats)
                lines.extend("  " + ln for ln in P.plan_tree_repr(
                    node, costs=costs).rstrip().split("\n"))
            else:
                lines.append(
                    "  (table-free or set-op; planned at execution)")

        for name, _cols, s in sel.ctes:
            emit(f"cte {name}", s)
        refs = ([sel.table] if sel.table is not None else []) \
            + [j.table for j in sel.joins]
        for r in refs:
            if r.subquery is not None:
                emit(f"derived {r.alias or r.name}", r.subquery)
        lines.append("main: re-planned over the materialized temps at "
                     "execution")
        return lines

    # -- EXPLAIN ANALYZE -----------------------------------------------
    def _explain_analyze(self, sel, session, sql_text: str,
                         debug: bool = False) -> Result:
        """Run the statement once under a trace recording and a fine
        profile sink, then render the plan it ran with each operator's
        actual rows and device time beside the optimizer's estimates.
        ``debug`` (EXPLAIN ANALYZE (DEBUG)) instead assembles a
        statement diagnostics bundle, stores it in the registry
        (/_status/stmtdiag/<id>) and returns its JSON."""
        from ..sql.stats import estimate
        if not isinstance(sel, ast.Select):
            raise EngineError("can only EXPLAIN ANALYZE SELECT")
        m0 = self.metrics.snapshot() if debug else None
        c0 = coldstart.thread_compile_seconds()
        with self.tracer.capture(
                "explain-analyze-debug" if debug else "explain-analyze",
                record_request=True) as rec:
            t0 = time.monotonic()
            res, node, sink = self._measure_operator_profile(
                sel, session, sql_text)
            dt = time.monotonic() - t0
        if debug:
            bundle = self._diag_bundle(
                sel, session, sql_text, rec, sink, dt, m0, sink.wall_s,
                node=node, compile_s=coldstart.thread_compile_seconds() - c0)
            bundle["id"] = self.stmtdiag.fulfill(None, bundle)
            return Result(names=["bundle"],
                          rows=[(json.dumps(bundle, default=str),)],
                          tag="EXPLAIN ANALYZE (DEBUG)")
        lines = ["planning/execution:"]
        for name in ("plan", "compile", "upload", "dispatch",
                     "materialize"):
            s = rec.find(name)
            if s is not None:
                tag_s = "".join(f" {k}={v}" for k, v in s.tags.items())
                lines.append(f"  {name}: {s.duration_ms:.2f}ms{tag_s}")
        compile_ms = (coldstart.thread_compile_seconds() - c0) * 1e3
        if compile_ms > 0:
            lines.append(f"  plan build and kernel load: {compile_ms:.2f}ms")
        lines.append(f"  total: {dt * 1e3:.2f}ms, "
                     f"rows returned: {len(res.rows)}")
        if node is not None:
            cv = self.catalog_view()
            lines.append("plan:")
            lines.extend("  " + ln for ln in P.plan_tree_repr(
                node, costs=estimate(node, cv.stats),
                actuals=_actual_rows(node, sink),
                sources=self._scan_estimate_sources(node, cv),
                profile=sink).rstrip().split("\n"))
        return Result(names=["info"], rows=[(ln,) for ln in lines],
                      tag="EXPLAIN ANALYZE")

    def _scan_estimate_sources(self, node, cv) -> dict:
        """id(scan) -> where the optimizer's cardinalities for that
        table came from ("analyze" | "sketch" | "default")."""
        out: dict = {}

        def rec(n):
            if isinstance(n, P.Scan):
                st = cv.stats.get(n.table)
                out[id(n)] = getattr(st, "source", "default")
            for attr in ("child", "left", "right"):
                c = getattr(n, attr, None)
                if c is not None:
                    rec(c)
        rec(node)
        return out

    def _measure_operator_profile(self, sel, session, sql_text: str):
        """Run one SELECT under a fine profile sink, uncompacted:
        (result, the main query's plan node or None for a plan-free
        statement, the resolved sink). Each operator of the plan that
        ran has its rows and device seconds in the sink, keyed by that
        node's identity."""
        sink = profile.ProfileSink(self.device)
        self._last_plan = None
        self._analyzing = True
        try:
            with profile.active(sink, fine=True), self._statement():
                res = self._exec_select(sel, session, sql_text)
        finally:
            self._analyzing = False
        sink.resolve()
        return res, self._last_plan, sink

    def operator_profile(self, sql: str, session=None) -> dict:
        """One SELECT's operator digest (the top operators by device
        seconds, the bytes moved) from a profiled run of it."""
        from ..sql import parser
        sess = session or self.session()
        stmt = parser.parse(sql)
        if isinstance(stmt, ast.Explain):
            stmt = stmt.stmt
        with self._run_scope(self._stmt_tables(stmt), False):
            _res, _node, sink = self._measure_operator_profile(
                stmt, sess, sql)
        out = sink.summary()
        out["wall_s"] = round(sink.wall_s, 6)
        return out

    # -- statement diagnostics ------------------------------------------
    def _diag_bundle(self, stmt, session, sql_text: str, rec, psink,
                     dt: float, m0, device_s, node=None,
                     compile_s: float = 0.0) -> dict:
        """One statement diagnostics bundle (the reference's
        stmtdiagnostics zip, here a JSON dict): the plan that ran with
        its operators' profile, the profile itself, the trace recording,
        cluster settings and session variables, the statistics of every
        table it read, and the statement's metric deltas. Every section
        is best-effort: diagnostics never fail the statement."""
        from ..sql.stats import estimate
        target = stmt.stmt if isinstance(stmt, ast.Explain) else stmt
        if node is None and isinstance(target, ast.Select):
            node = self._last_plan
        bundle: dict = {
            "sql": sql_text,
            "fingerprint": (fingerprint(sql_text) if sql_text
                            else type(stmt).__name__),
            "statement": type(stmt).__name__,
            "latency_s": dt,
            # plan builds and kernel library builds and loads
            "compile_s": compile_s,
            "device_time_s": device_s,
        }
        try:
            if node is not None and psink is not None:
                cv = self.catalog_view()
                bundle["plan"] = P.plan_tree_repr(
                    node, costs=estimate(node, cv.stats),
                    actuals=_actual_rows(node, psink),
                    sources=self._scan_estimate_sources(node, cv),
                    profile=psink).rstrip().split("\n")
        except Exception:
            pass
        bundle.setdefault("plan", [])
        bundle["profile"] = {
            "device_time_s": (psink.wall_s if psink is not None
                              and psink.wall_s else device_s),
            "ops": psink.to_wire() if psink is not None else [],
        }
        try:
            bundle["trace"] = (tracing.span_to_wire(rec)
                               if rec is not None else None)
        except Exception:
            bundle["trace"] = None
        bundle["settings"] = {k: str(v) for k, v in
                              self.settings.snapshot().items()}
        bundle["session_vars"] = {k: str(v) for k, v in
                                  session.vars.values.items()}
        stats: dict = {}
        try:
            if node is not None:
                cv = self.catalog_view()
                for tname in sorted(set(scan_maps(node)[0].values())):
                    st = cv.stats.get(tname)
                    if st is None:
                        continue
                    stats[tname] = {
                        a: getattr(st, a) for a in
                        ("rows", "row_count", "source", "analyzed_rows",
                         "distinct")
                        if isinstance(getattr(st, a, None),
                                      (int, float, str))}
        except Exception:
            stats = {}
        bundle["sketch_stats"] = stats
        m1 = self.metrics.snapshot()
        m0 = m0 or {}
        bundle["metric_deltas"] = {
            k: v - m0.get(k, 0) for k, v in m1.items()
            if isinstance(v, (int, float))
            and isinstance(m0.get(k, 0), (int, float))
            and v != m0.get(k, 0)}
        return bundle


def _actual_rows(node, sink) -> dict:
    """id(plan node) -> the rows its operator produced in the profiled
    run (the est-vs-actual column)."""
    out = {}

    def walk(n):
        ent = sink.op_entry(n)
        if ent is not None:
            out[id(n)] = ent.rows
        for attr in ("child", "left", "right"):
            c = getattr(n, attr, None)
            if c is not None:
                walk(c)
    walk(node)
    return out
