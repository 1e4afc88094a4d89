"""Placement and paging: the resident | stream | spill-join | spill-sort
verdict, the device-byte reckoning behind it, and the streamed-page
plumbing (the counterpart of the beyond-memory half of
cockroach_tpu/exec/scanplane.py). Mixed into exec/engine.py's Engine;
every bit of state lives on the Engine.

The byte reckoning is the reference's formulas over this package's
upload widths (no int32 narrowing) and the reference's row buckets (the
shape ladder, exec/coldstart.py): a table costs 16 bytes of MVCC columns
plus (itemsize + 1) per column per padded row, and an aggregation 16
bytes per aggregate per row of temporaries. Near a threshold the two
engines' verdicts can differ by the upload widths alone.
"""

from __future__ import annotations

import time

import numpy as np

from ..parallel.distagg import analyze
from ..sql import plan as P
from ..sql.types import Family
from . import coldstart, profile
from .compile import can_spill_sort, can_stream
from .session import Session
from .stream import PageSource, extract_zone_preds
from .stream import prefetch as stream_prefetch


def _spine(node) -> tuple[bool, set]:
    """(ok, probe-spine aliases) of the distribution analysis
    (parallel/distagg.py analyze), which gates paging too."""
    d = analyze(node)
    return d.ok, d.sharded


def _count_aggs(node) -> int:
    n = node
    if isinstance(n, P.Limit):
        n = n.child
    if isinstance(n, P.Sort):
        n = n.child
    if isinstance(n, P.Aggregate):
        return max(len(n.aggs), 1)
    return 1


def _has_join(node) -> bool:
    if isinstance(node, P.HashJoin):
        return True
    return any(_has_join(c) for c in (getattr(node, a, None)
                                      for a in ("child", "left", "right"))
               if c is not None)


def scan_maps(node) -> tuple[dict, dict]:
    """(alias -> table, alias -> stored columns read) of a plan."""
    aliases, cols = {}, {}

    def walk(n):
        if isinstance(n, P.Scan):
            aliases[n.alias] = n.table
            cols[n.alias] = cols.get(n.alias, frozenset()) \
                | frozenset(n.columns.values())
        for attr in ("child", "left", "right"):
            c = getattr(n, attr, None)
            if c is not None:
                walk(c)
    walk(node)
    return aliases, cols


class ScanPlaneMixin:
    """Engine methods for placement and paging."""

    # spill-join fan-out ceiling (the reference's)
    MAX_SPILL_JOIN_PARTITIONS = 256

    def shape_ladder(self) -> coldstart.ShapeLadder:
        """The shape-bucket ladder every padded row count comes from:
        resident uploads, streamed pages and spill partitions
        (exec/coldstart.py; settings sql.exec.shape_bucket.*)."""
        return coldstart.ladder_from_settings(self.settings)

    def _row_bucket(self, n: int) -> int:
        return self.shape_ladder().bucket(n)

    def _budget(self) -> int:
        return int(self.settings.get("sql.exec.hbm_budget_bytes"))

    def _placement_key(self, session: Session) -> tuple:
        """What a placement verdict depends on besides the plan and the
        tables' generations: a Prepared re-decides when it moves."""
        v = session.vars
        return (self._budget(), str(v.get("streaming", "auto")),
                str(v.get("spill", "auto")), self._page_rows(session),
                str(v.get("distsql", "auto")))

    # -- the verdicts -----------------------------------------------------
    def _stream_decision(self, node, scan_aliases: dict, scan_cols: dict,
                         session: Session):
        """Page the fact table through the card when its upload and the
        aggregation temporaries would not fit the budget. Only the
        probe-spine scan streams. Returns (alias, table, page_rows) or
        None."""
        if str(session.vars.get("streaming", "auto")) == "off":
            return None
        budget = self._budget()
        if budget <= 0 or not can_stream(node):
            return None
        ok, sharded = _spine(node)
        if not ok or len(sharded) != 1:
            return None
        alias = next(iter(sharded))
        tname = scan_aliases[alias]
        if self.store.table(tname).row_count == 0:
            return None
        page_rows = self._page_rows(session)
        ws = self._working_set(node, scan_aliases, scan_cols, alias,
                               page_rows, builds=False)
        if ws["probe_resident"] <= budget:
            return None
        # build sides still upload whole; an over-budget build fails
        # with a clean quota error
        return (alias, tname, page_rows)

    def _page_rows(self, session: Session) -> int:
        """The session's page size rounded up to the row bucket."""
        return self._row_bucket(
            int(session.vars.get("streaming_page_rows", 1 << 21)))

    def _spill_decision(self, node, scan_aliases: dict, scan_cols: dict,
                        session: Session, meta):
        """The out-of-core verdict (``SET spill = auto|on|off``): auto
        spills only when the resident and streamed paths would pass
        ``sql.exec.hbm_budget_bytes``, on forces every eligible shape,
        off never spills. Returns a spill.SpillPlan or None."""
        mode = str(session.vars.get("spill", "auto"))
        if mode == "off":
            return None
        budget = self._budget()
        if budget <= 0:
            return None
        page_rows = self._page_rows(session)
        sp = self._spill_join_decision(node, scan_aliases, scan_cols,
                                       mode, budget, page_rows)
        if sp is not None:
            return sp
        return self._spill_sort_decision(node, scan_aliases, scan_cols,
                                         meta, mode, budget, page_rows)

    def _spill_join_decision(self, node, scan_aliases: dict,
                             scan_cols: dict, mode: str, budget: int,
                             page_rows: int):
        """Partitioned external hash join: a streamable aggregate over a
        join spine whose build side is a plain Scan joined on raw
        stored int-family keys on BOTH sides (STRING dictionary codes
        and FLOAT bits partition wrongly), inner or left.

        Trigger (auto): the streamed path uploads every build whole,
        so its floor is the builds + two pages in flight + per-page
        aggregation temporaries; spill when that floor passes the
        budget. The LARGEST eligible build spills, in partitions that
        double until one fits what the budget leaves."""
        from .spill import SpillPlan
        if not _has_join(node) or not can_stream(node):
            return None
        ok, sharded = _spine(node)
        if not ok or len(sharded) != 1:
            return None
        alias = next(iter(sharded))
        tname = scan_aliases[alias]
        ptd = self.store.table(tname)
        if ptd.row_count == 0:
            return None
        probe_scan = None
        cands = []
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, P.Scan) and n.alias == alias:
                probe_scan = n
            if (isinstance(n, P.HashJoin)
                    and n.join_type in ("inner", "left")
                    and isinstance(n.right, P.Scan)
                    and alias in scan_maps(n.left)[0]):
                cands.append(n)
            for attr in ("child", "left", "right"):
                c = getattr(n, attr, None)
                if c is not None:
                    stack.append(c)
        if probe_scan is None:
            return None
        joins = []
        for j in cands:
            b = j.right
            pkeys = tuple(probe_scan.columns.get(k) for k in j.left_keys)
            bkeys = tuple(b.columns.get(k) for k in j.right_keys)
            if None in pkeys or None in bkeys:
                continue  # a computed or remapped key
            if not all(self._raw_partitionable(t, ks) for t, ks in
                       ((tname, pkeys), (b.table, bkeys))):
                continue
            btd = self.store.table(b.table)
            if btd.row_count == 0:
                continue
            bb = self._table_device_bytes(btd, scan_cols.get(b.alias))
            joins.append((bb, j, b, pkeys, bkeys))
        if not joins:
            return None
        ws = self._working_set(node, scan_aliases, scan_cols, alias,
                               page_rows)
        if mode == "auto" and ws["spill_floor"] <= budget:
            return None
        des_bytes, j, b, pkeys, bkeys = max(joins, key=lambda x: x[0])
        avail = max(budget - max(ws["builds"] - des_bytes, 0)
                    - ws["page_window"], 1)
        nparts = 2
        while (nparts < self.MAX_SPILL_JOIN_PARTITIONS
               and des_bytes // nparts > avail):
            nparts *= 2
        return SpillPlan(kind="join", alias=alias, table=tname,
                         page_rows=page_rows, build_alias=b.alias,
                         build_table=b.table, probe_keys=pkeys,
                         build_keys=bkeys, nparts=nparts)

    def _raw_partitionable(self, tname: str, stored_keys) -> bool:
        """May the spill partitioner hash these stored columns raw?
        Int family only (bool included)."""
        by_name = {c.name: c for c in self.store.table(tname).schema.columns}
        for k in stored_keys:
            col = by_name.get(k)
            if col is None or col.type.family == Family.STRING:
                return False
            if np.dtype(col.type.np_dtype).kind not in "iub":
                return False
        return True

    def _spill_sort_decision(self, node, scan_aliases: dict,
                             scan_cols: dict, meta, mode: str,
                             budget: int, page_rows: int):
        """External merge sort: Limit?/Sort over a join-free single-scan
        spine whose every key packs into sort-key lanes. Auto triggers
        when the upload plus the sort temporaries (a permutation and a
        lane per row) would pass the budget."""
        from .spill import SpillPlan
        if not can_spill_sort(node) or len(scan_aliases) != 1:
            return None
        alias, tname = next(iter(scan_aliases.items()))
        td = self.store.table(tname)
        if td.row_count == 0:
            return None
        limit_node = None
        n = node
        if isinstance(n, P.Limit):
            limit_node, n = n, n.child
        names = list(meta.names)
        for key in n.keys:
            kn = key[0]
            if kn not in names:
                return None  # a hidden key: its type is unknown here
            fam = meta.types[names.index(kn)].family
            if fam == Family.STRING:
                if meta.dictionaries.get(kn) is None:
                    return None
            elif fam not in (Family.INT, Family.DECIMAL, Family.DATE,
                             Family.TIMESTAMP, Family.BOOL, Family.FLOAT):
                return None
        if mode == "auto":
            eff_bytes, eff_rows = self._effective_table_bytes(
                node, alias, tname, scan_cols.get(alias))
            if eff_bytes + 24 * self._row_bucket(eff_rows) <= budget:
                return None
        return SpillPlan(
            kind="sort", alias=alias, table=tname, page_rows=page_rows,
            sort_keys=tuple((k[0], bool(k[1]), (k[2] if len(k) > 2
                                                else None))
                            for k in n.keys),
            limit=(limit_node.limit if limit_node is not None
                   and limit_node.limit is not None else -1),
            offset=((limit_node.offset or 0) if limit_node is not None
                    else 0))

    def _working_set(self, node, scan_aliases: dict, scan_cols: dict,
                     probe, page_rows: int, builds: bool = True) -> dict:
        """The placement rules' device bytes for one plan, reckoned in
        this one place for the verdicts and for reports:

          probe_resident  the probe scan's upload as a resident run
                          would really make it (zone-surviving chunks
                          when the table is over budget) plus the
                          aggregation temporaries over its rows (the
                          reference's 16 bytes per aggregate per row);
                          the stream verdict pages past the budget
          builds          every other scan's upload
          page_window     a paged run's two pages in flight (depth-2
                          prefetch) and their temporaries
          spill_floor     builds + page_window: what the streamed path
                          needs at least; the spill-join verdict
                          partitions past the budget
          resident        every scan's upload plus the temporaries
                          over the largest scan's rows

        ``probe`` None reckons no page (a plan that cannot page);
        ``builds`` False skips the build-side terms."""
        aggs = _count_aggs(node)

        def temps(rows: int) -> int:
            return 16 * aggs * self._row_bucket(rows)

        ups = {a: self._effective_table_bytes(node, a, t, scan_cols.get(a))
               for a, t in scan_aliases.items()
               if builds or a == probe}
        rows = max((r for _, r in ups.values()), default=0)
        out = {"resident": sum(b for b, _ in ups.values()) + temps(rows),
               "builds": sum(b for a, (b, _) in ups.items() if a != probe)}
        if probe is not None:
            pb, pr = ups[probe]
            out["probe_resident"] = pb + temps(pr)
            out["page_window"] = 2 * (
                temps(page_rows) + self._page_device_bytes(
                    self.store.table(scan_aliases[probe]),
                    scan_cols.get(probe), page_rows))
            out["spill_floor"] = out["builds"] + out["page_window"]
        return out

    def _plan_sql(self, sql: str, session: Session) -> tuple:
        """(plan, meta, alias -> table, alias -> columns) of a SELECT."""
        from ..sql import parser
        sel = self._decorrelate(parser.parse(sql))
        node, meta = self._plan(sel, session, self.clock.now())
        return (node, meta) + scan_maps(node)

    def working_set(self, sql: str, session: Session | None = None
                    ) -> dict:
        """The placement rules' device bytes for a SELECT
        (_working_set's terms), at the current budget and the session's
        page size; the probe is the scan a paged run would stream (None
        when the plan cannot page: no page terms). No execution, no
        uploads."""
        session = session or self.session()
        node, _, aliases, cols = self._plan_sql(sql, session)
        ok, sharded = _spine(node)
        probe = next(iter(sharded)) if ok and len(sharded) == 1 else None
        return self._working_set(node, aliases, cols, probe,
                                 self._page_rows(session))

    def stream_verdict(self, sql: str, session: Session | None = None
                       ) -> str:
        """Where would this SELECT run: "spill-join" | "spill-sort" |
        "stream-scan" | "resident" (no execution, no uploads)."""
        session = session or self.session()
        node, meta, aliases, cols = self._plan_sql(sql, session)
        sp = self._spill_decision(node, aliases, cols, session, meta)
        if sp is not None:
            return f"spill-{sp.kind}"
        if self._stream_decision(node, aliases, cols, session) is not None:
            return "stream-scan"
        return "resident"

    # -- byte reckoning ---------------------------------------------------
    def _page_device_bytes(self, td, cols, page_rows: int) -> int:
        """Device bytes of one streamed page of the pruned columns."""
        total = 16 * page_rows
        for col in td.schema.columns:
            if cols is None or col.name in cols:
                total += (np.dtype(col.type.np_dtype).itemsize + 1) \
                    * page_rows
        return total

    def _table_device_bytes(self, td, cols) -> int:
        """Device bytes a resident upload of these columns takes."""
        return self._page_device_bytes(td, cols,
                                       self._row_bucket(td.row_count))

    def _chunks_device_bytes(self, td, chunks, cols) -> int:
        return self._page_device_bytes(
            td, cols, self._row_bucket(sum(c.n for c in chunks)))

    def _zone_surviving_chunks(self, node, alias, tname):
        """(surviving chunks, compiled preds) of the plan's pushed-down
        predicates over ``alias``, judged against seal-time zones and
        blooms: the streamed page verdict, made once per chunk."""
        td = self.store.table(tname)
        preds = extract_zone_preds(node, alias)
        if not preds:
            return list(td.chunks), ()
        keep = []
        for c in td.chunks:
            ok = True
            for p in preds:
                if p.col is None:
                    ok = p.check(None, None, 0, 0)
                else:
                    ok = p.check(*c.zone(p.col)) and (
                        p.member is None or p.member.chunk_ok(c, p.col))
                if not ok:
                    break
            if ok:
                keep.append(c)
        return keep, preds

    def _effective_table_bytes(self, node, alias, tname, cols
                               ) -> tuple[int, int]:
        """(device bytes, rows) the upload of this scan would really
        take: the whole table when it fits the budget, else its
        zone-surviving chunks (what _maybe_pruned_upload ships)."""
        td = self.store.table(tname)
        full = self._table_device_bytes(td, cols)
        budget = self._budget()
        if budget <= 0 or full <= budget:
            return full, td.row_count
        keep, preds = self._zone_surviving_chunks(node, alias, tname)
        if not preds or len(keep) == len(td.chunks):
            return full, td.row_count
        return (self._chunks_device_bytes(td, keep, cols),
                sum(c.n for c in keep))

    def _scan_survival_frac(self, node, alias, tname) -> float:
        """Estimated post-filter fraction of a scan's rows (the
        reference's): the sketch-stats selectivity of its pushed-down
        predicates (the scan's filter and Filter nodes above it,
        separated only by Filter/Compact), floored at 1/64 so a
        footprint never sizes to zero; 1.0 when nothing is judgeable.
        The sub-mesh router sizes distributed plans by it."""
        from ..sql import stats as S
        from .stream import _find_chain
        if self.store.table(tname).row_count == 0:
            return 1.0
        chain = _find_chain(node, alias)
        if chain is None:
            return 1.0
        st = self.store.sketch_stats(tname)
        sel = 1.0
        if chain[0].filter is not None:
            sel *= S._pred_selectivity(chain[0].filter, st)
        for anc in chain[1:]:
            if isinstance(anc, P.Compact):
                continue
            if not isinstance(anc, P.Filter):
                break
            if anc.pred is not None:
                sel *= S._pred_selectivity(anc.pred, st)
        return float(min(1.0, max(sel, 1.0 / 64.0)))

    def _maybe_pruned_upload(self, node, alias, tname, cols):
        """An uncached upload of only the zone-surviving chunks, when
        the whole table would pass the budget but the scan's pushed-down
        predicates drop chunks on the host (a dropped chunk's rows fail
        the predicate in every version). None keeps the cached
        whole-table path."""
        budget = self._budget()
        if budget <= 0:
            return None
        td = self.store.table(tname)
        if self._table_device_bytes(td, cols) <= budget:
            return None
        keep, preds = self._zone_surviving_chunks(node, alias, tname)
        if not preds or len(keep) == len(td.chunks):
            return None
        self.metrics.counter(
            "exec.skip.predicate.chunks",
            "over-budget resident scan chunks pruned host-side by "
            "pushed-down zone predicates").inc(len(td.chunks) - len(keep))
        return self._batch_from_chunks(td, keep, cols)

    # -- paging -----------------------------------------------------------
    def _page_source(self, tname: str, cols, page_rows: int,
                     zone_preds=(), read_ts=None) -> PageSource:
        """One execution's page assembler over a chunk snapshot."""
        return PageSource(self.store.table(tname), cols, page_rows,
                          zone_preds=zone_preds, metrics=self.metrics,
                          read_ts=read_ts, device=self.device)

    def _stream_pages(self, src: PageSource, pipeline: bool, stall):
        """Device batches of ``src``'s pages, made ready on the
        consumer's thread. With ``pipeline`` a bounded worker assembles
        and uploads page i+1 while the card computes page i; ``stall``
        observes the consumer's wait per page."""
        it = stream_prefetch(src.pages(), stall_hist=stall) if pipeline \
            else src.pages()
        window = (2 if pipeline else 1) * src.page_bytes

        def leased():
            # the working window charges the movement budget for the
            # stream's lifetime (best-effort: a tight budget is an
            # observable overcommit, never a failure)
            with self.movement.soft_lease("page", window):
                try:
                    for up in it:
                        yield up.batch()
                finally:
                    close = getattr(it, "close", None)
                    if close is not None:
                        close()
        return leased()

    def _note_paging(self, prep, route: str, pages: int, bytes_moved: int,
                     stall: float, overlap: float, busy: float,
                     partitions: int = 0, skipped: int = 0) -> None:
        """Record one paged run in ``last_exec["paging"]``: its route,
        pages uploaded and skipped, bytes copied to the device, the
        consumer's stall and the worker's busy and overlap seconds, and
        a spill join's partitions."""
        entry = {"route": route, "pages": pages, "skipped": skipped,
                 "bytes": bytes_moved, "stall_s": stall,
                 "overlap_s": overlap, "busy_s": busy,
                 "partitions": partitions, "t": time.monotonic()}
        self.last_exec["all"]["paging"].append(entry)
        if self._nested == 0:
            self.last_exec["paging"] = entry
        # the coarse profile plane: a streamed scan's pages count as
        # uploads, a spill's partitions and runs as spilled bytes
        table = prep.stream[1] if prep.stream is not None \
            else prep.spill.table
        label = ("stream:" if route == "stream"
                 else route.replace("-", ":") + ":") + table
        moved = ({"bytes_uploaded": int(bytes_moved)} if route == "stream"
                 else {"bytes_spilled": int(bytes_moved)})
        profile.note(label, batches=max(pages, partitions), rows=0,
                     stall_seconds=stall, **moved)

    def drop_device_cache(self) -> None:
        """Evict every resident table copy and release its
        reservation."""
        with self._device_lock:
            for name in {k[0] for k in self._device_tables} | \
                    {k[0] for k in self._mesh_tables}:
                self._evict_device(name)
