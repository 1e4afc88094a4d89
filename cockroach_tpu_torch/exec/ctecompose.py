"""Composed on-card execution of CTE and derived-table statements (the
port of cockroach_tpu/exec/ctecompose.py).

The slow path (Engine._exec_with_temps) materializes each CTE or
derived-table body through the host: run the body's plan, pull its live
rows, ingest them into a temp table, upload the temp for the main plan's
scan, and plan the main query again, every execution. That path feeds
the statistics, the join checks and every consumer shape, but a prepared
statement re-run against unchanged base tables pays a pull, an upload
and a re-plan for nothing.

This module captures the pieces of one successful slow-path execution
(the bodies' Prepared plans, the main Prepared plan, and the temp
batches the main plan scanned) and composes them into one pipeline on
the card:

    body plan -> glue (compact the live rows into the temp's batch
    shape, write the MVCC columns) -> main plan -> one materialize

No value crosses to the host between stages; the only sync is the final
result pull. The reference's analogue is a WithExpr spool feeding its
readers in memory (sql/opt WithExpr; here the buffer stays in HBM).

The glue produces the temp batch of the port's upload
(Engine._batch_from_chunks): the captured width (rows bucketed by the
engine's shape ladder, exec/coldstart.py, as the reference's), live rows first in the body's
output order, padding rows with data 0, validity False, ``_mvcc_ts`` at
_DEAD_TS = 2^62 and ``_mvcc_del`` 0, live rows visible at any read
timestamp (written at wall 1, never deleted), and dictionary codes
clipped to the temp's dictionary as the ingest clips them.

Validity: a composition is used only while every base table's
generation is the captured one (generations come from one store counter)
and the session holds no transaction; then the bodies' visible rows, and
so each temp's row count and dictionaries, are the captured run's. A
drift, a glue overflow (more live rows than the captured width) or a
body sentinel sends the run back to the slow path, which captures again
(the glue folds a body's sentinels and its overflow into the
``__compact_overflow`` flag the engine already checks). Each composed
run and each declined composition is counted (``sql.cte.composed.*``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.batch import ColumnBatch
from ..storage.columnstore import MAX_TS_INT
from ..storage.hlc import Timestamp
from .compile import RunContext
from .session import SENTINEL_COLUMNS

# padding rows: created at +inf, deleted at 0 (never visible)
_DEAD_TS = 2 ** 62
# temps ingest at wall 1 (Engine._materialize_temp_select)
_LIVE_TS = Timestamp(1, 0).to_int()


def make_glue(template: ColumnBatch, cname_to_oname: dict,
              dict_clip: dict):
    """Body output -> temp scan batch adapter.

    ``template``: the captured temp batch the main plan scanned (its
    names, dtypes and width are the contract). ``cname_to_oname``: temp
    column -> body output column. ``dict_clip``: temp column ->
    dictionary length (codes clipped as the ingest clips them).
    Returns glue(b) -> (ColumnBatch, overflow flag as a device bool);
    no step reads a device value back to the host."""
    names = list(template.names)
    dtypes = {nm: template.col(nm).dtype for nm in names}
    w2 = template.n

    def glue(b: ColumnBatch):
        n, sel, dev = b.n, b.sel, b.sel.device
        # order-preserving compaction: live row i goes to slot pos[i];
        # rows past the width (an overflow) and dead rows go to a dump
        # slot past the end
        pos = torch.cumsum(sel.to(torch.int64), 0) - 1
        live_cnt = torch.count_nonzero(sel)
        dest = torch.where(torch.logical_and(sel, pos < w2), pos,
                           torch.full_like(pos, w2))
        idx = torch.full((w2 + 1,), n, dtype=torch.int64, device=dev)
        idx.scatter_(0, dest, torch.arange(n, dtype=torch.int64,
                                           device=dev))
        idx = idx[:w2]
        row_ok = idx < n
        idx_c = torch.clamp(idx, max=max(n - 1, 0))
        cols, valid = {}, {}
        for nm in names:
            if nm == "_mvcc_ts":
                cols[nm] = torch.where(
                    row_ok, torch.tensor(_LIVE_TS, device=dev),
                    torch.tensor(_DEAD_TS, device=dev))
                continue
            if nm == "_mvcc_del":
                cols[nm] = torch.where(
                    row_ok, torch.tensor(MAX_TS_INT, device=dev),
                    torch.tensor(0, device=dev))
                continue
            oname = cname_to_oname[nm]
            if n == 0:   # an empty body: every slot is padding
                cols[nm] = torch.zeros(w2, dtype=dtypes[nm], device=dev)
                valid[nm] = row_ok
                continue
            d = b.col(oname).index_select(0, idx_c)
            v = torch.logical_and(
                b.col_valid(oname).index_select(0, idx_c), row_ok)
            clip = dict_clip.get(nm)
            if clip is not None:
                d = torch.clamp(d.to(torch.int32), 0, max(clip - 1, 0))
            d = d.to(dtypes[nm])
            cols[nm] = torch.where(row_ok, d, torch.zeros_like(d))
            valid[nm] = v
        overflow = live_cnt > w2
        for s in SENTINEL_COLUMNS:
            if b.has(s):
                overflow = torch.logical_or(overflow, torch.any(b.col(s)))
        out = ColumnBatch.from_dict(cols, valid, sel=row_ok)
        return out, overflow

    return glue


@dataclass
class _Stage:
    prep: object          # the body's Prepared
    # one adapter a consuming alias: the main plan may scan one temp
    # under two aliases with different pruned column sets
    glues: list           # [(alias, glue), ...]


@dataclass
class ComposedCTE:
    engine: object
    session: object
    base_gens: tuple      # ((table, generation), ...), temps excluded
    stages: list
    main: object          # the main Prepared

    def valid(self) -> bool:
        if self.session.txn is not None or self.session.effects:
            return False
        tables = self.engine.store.tables
        for t, g in self.base_gens:
            td = tables.get(t)
            if td is None or td.generation != g:
                return False
        return True

    def dispatch(self, read_ts=None) -> ColumnBatch:
        """Launch the whole pipeline: the main plan's result batch with
        the glues' and the bodies' flags folded into its
        ``__compact_overflow`` column. Nothing waits on the card."""
        eng = self.engine
        ts = read_ts or eng._read_ts(self.session)
        tsv = ts.to_int()
        scans = dict(self.main.scans)
        flags = []
        with eng._inner():
            for st in self.stages:
                rc = RunContext(st.prep.scans, tsv, params=st.prep.params)
                sub_out = st.prep.runf(rc)
                eng._note_route(st.prep, rc.route)
                for a, glue in st.glues:
                    scans[a], ovf = glue(sub_out)
                    flags.append(ovf)
        rc = RunContext(scans, tsv, params=self.main.params)
        out = self.main.runf(rc)
        eng._note_route(self.main, rc.route)
        flag = flags[0]
        for f in flags[1:]:
            flag = torch.logical_or(flag, f)
        if out.has("__compact_overflow"):
            flag = torch.logical_or(flag,
                                    torch.any(out.col("__compact_overflow")))
        return out.with_column("__compact_overflow", flag.expand(out.n))

    def run(self, read_ts=None):
        out = self.dispatch(read_ts)
        return self.engine._materialize(out, self.main.meta)


def build_composition(engine, session, capture) -> ComposedCTE | None:
    """A ComposedCTE from one successful slow-path capture, or None when
    the shape cannot compose: a row-path temp, a nested CTE, a set
    operation, a paged or spilled plan, an AS OF SYSTEM TIME plan, a
    temp read by another temp's body, or a main query served by a fast
    path."""
    if (not capture or capture.get("disabled") or not capture["temps"]
            or not capture["preps"]):
        return None
    main = capture["preps"][-1]
    if main.stream is not None or main.spill is not None \
            or main.as_of is not None:
        return None
    scan_tables = main.scan_tables
    temp_names = {t["tname"] for t in capture["temps"]}
    for t in capture["temps"]:
        p = t["prep"]
        if p.stream is not None or p.spill is not None \
                or p.as_of is not None:
            return None
        if any(tb in temp_names for tb, _ in p.gens):
            return None   # a temp scanning another temp: slow path
    base: dict = {}
    for p in [main] + [t["prep"] for t in capture["temps"]]:
        for tb, g in p.gens:
            if tb in temp_names:
                continue
            if base.get(tb, g) != g:
                return None
            base[tb] = g
    stages, temp_aliases = [], []
    for t in capture["temps"]:
        aliases = [a for a, tn in scan_tables.items() if tn == t["tname"]]
        if not aliases:
            continue   # a CTE the main query never scans
        meta = t["meta"]
        cname_to_oname = dict(zip(t["names"], meta.names))
        dict_clip = {c: len(meta.dictionaries[o].values)
                     for c, o in cname_to_oname.items()
                     if meta.dictionaries.get(o) is not None}
        glues = []
        for a in aliases:
            template = main.scans.get(a)
            if template is None or t["rows"] > template.n:
                return None
            if any(nm not in cname_to_oname for nm in template.names
                   if nm not in ("_mvcc_ts", "_mvcc_del")):
                return None
            glues.append((a, make_glue(template, cname_to_oname,
                                       dict_clip)))
        stages.append(_Stage(prep=t["prep"], glues=glues))
        temp_aliases.extend(aliases)
    if not stages:
        return None
    # the temps were dropped and their reservations released by the
    # slow path's cleanup: holding their captured device batches would
    # keep untracked memory, and every composed dispatch replaces them
    main.scans = dict(main.scans)
    for a in temp_aliases:
        main.scans[a] = None
    return ComposedCTE(engine=engine, session=session,
                       base_gens=tuple(sorted(base.items())),
                       stages=stages, main=main)
