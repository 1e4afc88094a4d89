"""Out-of-core spill tier: partitioned external hash join and external
merge sort over the streamed pages (the counterpart of
cockroach_tpu/exec/spill.py, without its sub-mesh sweep).

  spill-join   radix-partition BOTH sides on the host by a hash of the
               raw join key (ops/join.radix_partition_ids over the
               chunk snapshots), then per partition upload ONE build
               batch and stream the matching probe rows' pages against
               it. Equal keys share a partition, so the per-(partition,
               page) aggregate partials combine with the unchanged
               streaming algebra (exec/compile.py compile_streaming).
               Partition uploads overlap the probe through the same
               prefetch worker the streamed scans use.
  spill-sort   run the Sort's child over each streamed page, sort the
               page on the card by its packed key lanes (ops/sortkey.py),
               cut each run to LIMIT + OFFSET rows, pull the runs to the
               host and merge them with one stable host lexsort over
               the lanes (sortkey.merge_lanes_host). Stable runs in row
               order plus a stable merge give the permutation of one
               device sort over all rows.

The placement verdict (resident | stream | spill-join | spill-sort) is
made by exec/scanplane.py ``_spill_decision`` and rides on
``Prepared.spill`` as a SpillPlan; ``SET spill = auto|on|off`` gates it.
The exec.spill.* counters account for the tier.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import sortkey
from ..ops.batch import ColumnBatch, pull_arrays
from ..ops.join import radix_partition_ids
from ..sql import plan as P
from .compile import (ExecError, RunContext, _normalized_lanes,
                      _sort_rank_tables, compile_plan)
from .stream import prefetch as stream_prefetch

_STALL_HELP = ("consumer wait per streamed page (0 when the prefetch "
               "pipeline is ahead of the device)")


@dataclass(frozen=True)
class SpillPlan:
    """The spill verdict, carried on Prepared.spill and part of the
    exec-cache key (frozen, so hashable)."""
    kind: str                # "join" | "sort"
    alias: str               # the paged scan's alias (probe / sorted)
    table: str
    page_rows: int
    # spill-join only
    build_alias: str = ""
    build_table: str = ""
    probe_keys: tuple = ()   # stored key column names, probe table
    build_keys: tuple = ()   # stored key column names, build table
    nparts: int = 0
    # spill-sort only
    sort_keys: tuple = ()    # ((name, desc, null_first or None), ...)
    limit: int = -1          # -1 = no LIMIT
    offset: int = 0


class _StallSum:
    """Consumer stall seconds for the overlap figure, forwarded to the
    shared stall histogram."""

    def __init__(self, hist=None):
        self.total = 0.0
        self.hist = hist

    def observe(self, v: float) -> None:
        self.total += v
        if self.hist is not None:
            self.hist.observe(v)


def _spill_metrics(metrics):
    return (
        metrics.counter("exec.spill.partitions",
                        "spill-tier units processed: join partitions "
                        "swept + sort runs merged"),
        metrics.counter("exec.spill.bytes",
                        "host->device bytes moved by spill partition "
                        "and run uploads"),
        metrics.counter("exec.spill.rounds",
                        "spill-tier executions (join partition sweeps "
                        "+ external merge sorts)"),
        metrics.counter("exec.spill.upload_overlap_seconds",
                        "seconds of partition/page assembly and upload "
                        "hidden under device compute"),
    )


def _batch_bytes(src, n_rows: int) -> int:
    """Host->device bytes of one n_rows batch of src's columns (the
    PageSource.page_bytes shape)."""
    return n_rows * (16 + sum(d.itemsize + 1 for d in src.dtypes.values()))


def _host_key_cols(src, names):
    """Stored key columns and validity over the chunk snapshot: the
    partitioner's input. Invisible row versions partition too; MVCC
    masks them on the card like any row."""
    cols, valids = [], []
    for cn in names:
        if src.chunks:
            d = np.concatenate([c.data[cn] for c in src.chunks])
            v = np.concatenate([c.valid[cn] for c in src.chunks])
        else:
            d = np.zeros(0, dtype=src.dtypes[cn])
            v = np.zeros(0, dtype=bool)
        cols.append(d)
        valids.append(v)
    return cols, valids


def host_page_iter(n_rows: int, cols: dict, page_rows: int):
    """Fixed-size host pages over a column dict: yields ``(page_len,
    {col: slice})``, at least one (possibly empty) page."""
    page_rows = max(1, int(page_rows))
    if n_rows <= 0:
        yield 0, {c: v[:0] for c, v in cols.items()}
        return
    for lo in range(0, n_rows, page_rows):
        hi = min(n_rows, lo + page_rows)
        yield hi - lo, {c: v[lo:hi] for c, v in cols.items()}


def _partition_indices(pids: np.ndarray, nparts: int) -> list:
    """Global row indices per partition, ascending within each (a
    stable argsort keeps row order), so chunk-run gathers apply."""
    order = np.argsort(pids, kind="stable")
    bounds = np.searchsorted(pids[order], np.arange(nparts + 1))
    return [order[bounds[p]:bounds[p + 1]] for p in range(nparts)]


# ---------------------------------------------------------------------------
# partitioned external hash join
# ---------------------------------------------------------------------------

def run_spill_join(engine, prep, tsv: int) -> ColumnBatch:
    """Run a spill-join Prepared: sweep the partitions, combining the
    per-(partition, page) aggregate partials, and return the device
    result batch.

    Exact because (a) equal join keys hash to the same partition on
    both sides, so every match the resident join finds happens in
    exactly one partition, and (b) each probe row lands in exactly one
    (partition, page). Duplicate-key expansion and direct-address
    tables work per partition unchanged: a key's whole duplicate chain
    shares its partition."""
    sp: SpillPlan = prep.spill
    fns = prep.runf
    m_parts, m_bytes, m_rounds, m_overlap = _spill_metrics(engine.metrics)
    m_rounds.inc()

    psrc = engine._page_source(sp.table, prep.stream_cols, sp.page_rows)
    bsrc = engine._page_source(sp.build_table, prep.spill_cols,
                               engine._row_bucket(1))

    ppids = radix_partition_ids(*_host_key_cols(psrc, sp.probe_keys),
                                sp.nparts)
    bpids = radix_partition_ids(*_host_key_cols(bsrc, sp.build_keys),
                                sp.nparts)
    pidx = _partition_indices(ppids, sp.nparts)
    bidx = _partition_indices(bpids, sp.nparts)

    # join-induced skipping at row grain: a derived semi-join filter
    # prunes probe rows from the partitions before any gather (inner
    # and semi joins only: the join would drop those rows anyway)
    filters = prep._join_filters(tsv)
    if filters:
        keep = None
        for f in filters:
            cols, valids = _host_key_cols(psrc, (f.col,))
            k = f.rows_ok(cols[0], valids[0])
            keep = k if keep is None else (keep & k)
        if keep is not None and not keep.all():
            engine.metrics.counter(
                "exec.skip.joinfilter.rows",
                "spill-join probe rows pruned host-side by a semi-join "
                "filter (never gathered or uploaded)"
            ).inc(int(len(keep) - keep.sum()))
            pidx = [ix[keep[ix]] for ix in pidx]
    # one shared row bucket for every build partition
    bpad = engine._row_bucket(max(len(ix) for ix in bidx))
    bbytes = _batch_bytes(bsrc, bpad)

    def feed():
        """(kind, upload): each partition's build batch, then its probe
        pages. On the prefetch worker, item i+1's assembly and upload
        overlap the card's probe of item i, across partitions too."""
        for p in range(sp.nparts):
            if len(pidx[p]) == 0:
                continue  # no probe rows: nothing matches or emits
            m_parts.inc()
            m_bytes.inc(bbytes)
            yield ("build", bsrc.gather_batch(bidx[p], bpad))
            for page in psrc.gather_pages(pidx[p]):
                m_bytes.inc(psrc.page_bytes)
                yield ("page", page)

    pipeline = prep.session.vars.get("streaming_pipeline", "on") != "off"
    stall = _StallSum(engine.metrics.histogram(
        "exec.stream.prefetch_stall_seconds", _STALL_HELP))
    items = stream_prefetch(feed(), stall_hist=stall) if pipeline \
        else feed()
    state = None
    n_pages = 0
    scans = dict(prep.scans)
    route = RunContext.new_route()
    window = bbytes + (2 if pipeline else 1) * psrc.page_bytes
    with engine.movement.soft_lease("spill", window):
        try:
            for kind, up in items:
                b = up.batch()
                if kind == "build":
                    scans[sp.build_alias] = b
                    continue
                scans[sp.alias] = b
                n_pages += 1
                s = fns.page_fn(RunContext(scans, tsv, route=route))
                state = s if state is None else fns.combine(state, s)
        finally:
            close = getattr(items, "close", None)
            if close is not None:
                close()
    if state is None:
        # an empty probe: one never-visible padding round yields the
        # aggregate's empty state (COUNT 0, NULL sums)
        scans[sp.build_alias] = bsrc.gather_batch(
            np.zeros(0, dtype=np.int64), bpad).batch()
        scans[sp.alias] = psrc.empty_page()
        state = fns.page_fn(RunContext(scans, tsv, route=route))
    busy = psrc.busy_seconds + bsrc.busy_seconds
    overlap = max(0.0, busy - stall.total) if pipeline else 0.0
    m_overlap.inc(overlap)
    engine.movement.note_overlap(overlap)
    engine._note_paging(prep, "spill-join", pages=n_pages,
                        bytes_moved=psrc.bytes_moved + bsrc.bytes_moved,
                        stall=stall.total if pipeline else 0.0,
                        overlap=overlap, busy=busy,
                        partitions=sp.nparts)
    engine._note_route(prep, route)
    return fns.final_fn(state)


# ---------------------------------------------------------------------------
# external merge sort
# ---------------------------------------------------------------------------

def compile_spill_sort(node: P.PlanNode, params, meta):
    """The per-run device program of the external merge sort.

    Per page: run the Sort's child subtree, pack the key list into
    sort-key lanes (always: the lanes ARE the host merge keys; the
    decision checked encodability), stable-sort the run, cut it to
    LIMIT + OFFSET rows when a Limit rides above (a row past that rank
    in its own run never makes the global cut), and return (run batch,
    stacked lanes)."""
    limit_node = None
    n = node
    if isinstance(n, P.Limit):
        limit_node, n = n, n.child
    if not isinstance(n, P.Sort):
        raise ExecError("spill sort requires a Sort-rooted plan")
    keys = list(n.keys)
    rank_tables = _sort_rank_tables(keys, meta)
    childf = compile_plan(n.child, params)
    cut = (limit_node.limit + (limit_node.offset or 0)
           if limit_node is not None and limit_node.limit is not None
           else None)

    def run_fn(rc: RunContext):
        b = childf(rc)
        lanes = _normalized_lanes(b, keys, rank_tables, "spill")
        if lanes is None:
            raise ExecError("spill sort keys must be normalized-encodable")
        perm = sortkey.sort_perm(lanes, kind="spill")
        data = tuple(d[perm] for d in b.data)
        valid = tuple(v[perm] for v in b.valid)
        sel = b.sel[perm]
        lanes = [lane[perm] for lane in lanes]
        if cut is not None and cut < b.n:
            data = tuple(d[:cut] for d in data)
            valid = tuple(v[:cut] for v in valid)
            sel = sel[:cut]
            lanes = [lane[:cut] for lane in lanes]
        # dead rows keep their all-ones lanes: they merge last and the
        # host drops them by sel
        return ColumnBatch(data, valid, sel, b.names), torch.stack(lanes)

    return run_fn


def run_spill_sort(engine, prep, tsv: int):
    """Run a spill-sort Prepared and return the decoded Result (the
    merge happens on the host, so there is no device result batch)."""
    from .session import Result
    sp: SpillPlan = prep.spill
    meta = prep.meta
    names = list(meta.names)
    m_parts, m_bytes, m_rounds, m_overlap = _spill_metrics(engine.metrics)
    m_rounds.inc()
    src = engine._page_source(sp.table, prep.stream_cols, sp.page_rows,
                              zone_preds=prep.stream_zone, read_ts=tsv)
    pipeline = prep.session.vars.get("streaming_pipeline", "on") != "off"
    stall = _StallSum(engine.metrics.histogram(
        "exec.stream.prefetch_stall_seconds", _STALL_HELP))
    pages = stream_prefetch(src.pages(), stall_hist=stall) if pipeline \
        else src.pages()
    scans = dict(prep.scans)
    route = RunContext.new_route()
    runs = []  # (per-col data, per-col valid, lanes): live rows only
    n_pages = 0
    with engine.movement.soft_lease(
            "page", (2 if pipeline else 1) * src.page_bytes):
        try:
            for up in pages:
                scans[sp.alias] = up.batch()
                out, lanes = prep.runf(RunContext(scans, tsv, route=route))
                n_pages += 1
                m_parts.inc()
                m_bytes.inc(_batch_bytes(src, sp.page_rows))
                pulled = pull_arrays(
                    [out.sel, lanes] + [out.col(c) for c in names]
                    + [out.col_valid(c) for c in names])
                sel, lv = pulled[0], pulled[1]
                datas = pulled[2:2 + len(names)]
                valids = pulled[2 + len(names):]
                live = np.flatnonzero(sel)  # ascending: run order kept
                runs.append(([d[live] for d in datas],
                             [v[live] for v in valids], lv[:, live]))
        finally:
            close = getattr(pages, "close", None)
            if close is not None:
                close()
    engine._note_route(prep, route)
    overlap = max(0.0, src.busy_seconds - stall.total) if pipeline else 0.0
    m_overlap.inc(overlap)
    engine.movement.note_overlap(overlap)
    engine._note_paging(prep, "spill-sort", pages=n_pages,
                        bytes_moved=src.bytes_moved,
                        stall=stall.total if pipeline else 0.0,
                        overlap=overlap, busy=src.busy_seconds)

    res = Result(names=names, types=list(meta.types))
    if not runs:
        return res
    order = sortkey.merge_lanes_host([r[2] for r in runs])
    lo = sp.offset
    hi = (lo + sp.limit) if sp.limit >= 0 else None
    order = order[lo:hi]
    pulled = {name: (np.concatenate([r[0][i] for r in runs])[order],
                     np.concatenate([r[1][i] for r in runs])[order])
              for i, name in enumerate(names)}
    return engine._decode(pulled, meta)
