"""Streamed pages: chunk prefix offsets, zone-map and MVCC-window page
skipping, pinned-buffer uploads on a copy stream, and a bounded
background prefetch (the counterpart of cockroach_tpu/exec/stream.py).

A table bigger than the device budget runs page by page
(exec/scanplane.py ``_stream_pages``, exec/session.py
``Prepared.dispatch``):

  PageSource   one-time setup per execution (chunk snapshot, prefix
               offsets), then per page a binary search for its chunk
               span and one in-place fill per column of a host buffer
               set. Buffers are pinned and the upload is an async copy
               on a dedicated CUDA stream, so page i+1 crosses PCIe
               while page i computes on the consumer's stream.
  ZonePred     the plan's pushed-down conjuncts checked against the
               chunks' seal-time min/max/null counts: a page that
               cannot satisfy every conjunct is never assembled or
               uploaded. A chunk whose MVCC window excludes the read
               timestamp holds no visible row and is skipped too.
  prefetch()   a worker thread at most ``depth`` pages ahead of the
               consumer, with exception propagation and a join on
               close.

Zone checks are conservative by construction: bounds cover all row
versions and unknown bounds never skip, so deletes, NULLs and odd
dtypes can only keep a page, never drop one wrongly.

Buffer reuse on the card: the host buffer sets form a ring of
``depth + 1``. After a set's copies the copy stream records an event;
before the set is refilled the worker waits on that event, so a copy
still in flight never reads a half-refilled buffer. A page's device
tensors are allocated on the copy stream: the consumer waits on the
page's event before computing and marks every tensor with
``record_stream`` so the allocator does not hand the memory out again
while the consumer stream still reads it. The page path never falls
back: pinning that fails raises, and there is no pageable or CPU copy
when the engine's device is the card.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..ops.batch import ColumnBatch
from ..sql import bound as B
from ..sql import plan as P
from .expr import torch_dtype

# padding rows are never visible: created at +inf, deleted at 0
NEVER_TS = np.int64(2 ** 62)

PREFETCH_DEPTH = 2


# ---------------------------------------------------------------------------
# zone-map predicates
# ---------------------------------------------------------------------------

@dataclass
class ZonePred:
    """One pushed-down conjunct compiled to a zone check.

    ``check(lo, hi, nulls, nvalid) -> bool`` answers "may any row of a
    page with this combined zone satisfy the conjunct?"; False skips
    the page. ``lo``/``hi`` may be None (unknown bounds). ``col`` is
    None for row-independent conjuncts (a constant FALSE skips every
    page). ``member`` optionally refines a passing range verdict per
    chunk (``chunk_ok(chunk, col)``, a semi-join filter from
    exec/joinfilter.py); ``joinfilter`` marks predicates derived from a
    join's build side, whose skips count under exec.skip.joinfilter.*.
    """
    col: object
    check: object
    member: object = None
    joinfilter: bool = False


def _cmp_check(op: str, v):
    def check(lo, hi, nulls, nvalid):
        # NULL never satisfies a comparison
        if nvalid == 0:
            return False
        if lo is None:
            return True
        if op == "<":
            return lo < v
        if op == "<=":
            return lo <= v
        if op == ">":
            return hi > v
        if op == ">=":
            return hi >= v
        if op == "=":
            return lo <= v <= hi
        return not (lo == hi == v)  # "!="
    return check


def _between_check(vlo, vhi):
    def check(lo, hi, nulls, nvalid):
        if nvalid == 0:
            return False
        if lo is None:
            return True
        return not (hi < vlo or lo > vhi)
    return check


def _inlist_check(values):
    def check(lo, hi, nulls, nvalid):
        if nvalid == 0:
            return False
        if lo is None:
            return True
        return any(lo <= v <= hi for v in values)
    return check


def _isnull_check(negated: bool):
    def check(lo, hi, nulls, nvalid):
        return nvalid > 0 if negated else nulls > 0
    return check


def _dict_check(table):
    # dictionary codes are small dense ints: the chunk's code range
    # indexes the host-evaluated predicate table directly
    def check(lo, hi, nulls, nvalid):
        if nvalid == 0:
            return False
        if lo is None:
            return True
        a = max(int(lo), 0)
        b = min(int(hi), len(table) - 1)
        return a <= b and bool(table[a:b + 1].any())
    return check


_CMP_OPS = {"<", "<=", ">", ">=", "=", "!="}


def _compile_conjunct(e, colmap: dict):
    """One conjunct -> ZonePred, or None for shapes zone maps cannot
    judge (they simply skip nothing)."""
    def col_of(x):
        if isinstance(x, B.BCol):
            return colmap.get(x.name)
        return None

    if isinstance(e, B.BConst):
        # the planner folds unsatisfiable predicates to FALSE or NULL;
        # neither admits a row
        if e.value:
            return None
        return ZonePred(None, lambda lo, hi, nulls, nvalid: False)
    if isinstance(e, B.BBin) and e.op in _CMP_OPS:
        lc, rc = col_of(e.left), col_of(e.right)
        if lc is not None and isinstance(e.right, B.BConst):
            v = e.right.value
            return None if v is None else ZonePred(lc, _cmp_check(e.op, v))
        if rc is not None and isinstance(e.left, B.BConst):
            v = e.left.value
            if v is None:
                return None
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
            return ZonePred(rc, _cmp_check(flip.get(e.op, e.op), v))
        return None
    if isinstance(e, B.BBetween) and not e.negated:
        c = col_of(e.expr)
        if c is not None and isinstance(e.lo, B.BConst) \
                and isinstance(e.hi, B.BConst) \
                and e.lo.value is not None and e.hi.value is not None:
            return ZonePred(c, _between_check(e.lo.value, e.hi.value))
        return None
    if isinstance(e, B.BInList) and not e.negated:
        c = col_of(e.expr)
        vals = [v for v in e.values if v is not None]
        if c is not None and vals:
            return ZonePred(c, _inlist_check(vals))
        return None
    if isinstance(e, B.BIsNull):
        c = col_of(e.expr)
        if c is not None:
            return ZonePred(c, _isnull_check(e.negated))
        return None
    if isinstance(e, B.BDictLookup):
        c = col_of(e.expr)
        if c is not None and e.table is not None:
            return ZonePred(c, _dict_check(np.asarray(e.table)))
        return None
    return None


def _split_and(e, out: list):
    if isinstance(e, B.BBin) and e.op == "and":
        _split_and(e.left, out)
        _split_and(e.right, out)
    else:
        out.append(e)


def extract_zone_preds(node: P.PlanNode, alias: str) -> tuple:
    """The plan's pushed-down predicates over the streamed scan
    ``alias`` as zone checks: the scan's own filter plus any Filter
    separated from it only by Filter/Compact nodes (predicates above a
    Project or a join may name renamed or joined columns)."""
    chain = _find_chain(node, alias)
    if chain is None:
        return ()
    scan = chain[0]
    conjuncts: list = []
    if scan.filter is not None:
        _split_and(scan.filter, conjuncts)
    for anc in chain[1:]:
        if isinstance(anc, P.Compact):
            continue
        if isinstance(anc, P.Filter):
            if anc.pred is not None:
                _split_and(anc.pred, conjuncts)
            continue
        break
    preds = [_compile_conjunct(e, scan.columns) for e in conjuncts]
    return tuple(p for p in preds if p is not None)


def _find_chain(node, alias):
    """Ancestor chain [scan, parent, ..., root] of the aliased scan."""
    if isinstance(node, P.Scan):
        return [node] if node.alias == alias else None
    for attr in ("child", "left", "right"):
        c = getattr(node, attr, None)
        if c is not None:
            r = _find_chain(c, alias)
            if r is not None:
                r.append(node)
                return r
    return None


# ---------------------------------------------------------------------------
# uploads
# ---------------------------------------------------------------------------


class Upload:
    """One batch on its way to the device: its tensors, and on the card
    the copy stream's event after their copies. ``batch()`` runs on the
    consumer's thread: it makes the consumer's stream wait for the
    copies and ties every tensor's memory to that stream."""

    __slots__ = ("data", "valid", "event", "nbytes")

    def __init__(self, data: dict, valid: dict, event, nbytes: int):
        self.data = data
        self.valid = valid
        self.event = event
        self.nbytes = nbytes

    def batch(self) -> ColumnBatch:
        if self.event is not None:
            t0 = next(iter(self.data.values()))
            cur = torch.cuda.current_stream(t0.device)
            cur.wait_event(self.event)
            for t in (*self.data.values(), *self.valid.values()):
                t.record_stream(cur)
        return ColumnBatch.from_dict(self.data, self.valid)


class _BufferSet:
    """Host buffers for one page: a numpy view per column (data, a
    validity mask per column, the MVCC pair), pinned on the card's
    path, and the event after their last copy."""

    def __init__(self, dtypes: dict, rows: int, pinned: bool):
        self.tensors = {}
        self.arrays = {}
        for name, dt in dtypes.items():
            if pinned:
                # raises when the host cannot pin: no pageable fallback
                t = torch.empty(rows, dtype=torch_dtype(dt),
                                pin_memory=True)
                self.tensors[name] = t
                self.arrays[name] = t.numpy()
            else:
                self.arrays[name] = np.empty(rows, dtype=dt)
        self.event = None


class PageSource:
    """Assembles fixed-shape pages from a chunk snapshot and uploads
    them to ``device`` (the card when None; raises without one).

    Setup (chunk snapshot, prefix offsets) happens once per execution;
    per page the chunk span is a binary search over the prefix array
    and each column one in-place fill of a ring buffer set."""

    def __init__(self, td, cols, page_rows: int, zone_preds=(),
                 metrics=None, read_ts=None, device=None):
        self.chunks = list(td.chunks)
        self.page_rows = page_rows
        # the card unless the caller names the CPU (raises without one)
        self.device = resolve_device(device)
        # MVCC window skipping: a chunk whose seal-time [ts_min,
        # del_max) window excludes read_ts holds no visible version
        self.read_ts = None if read_ts is None else int(read_ts)
        self.offs = np.zeros(len(self.chunks) + 1, dtype=np.int64)
        if self.chunks:
            np.cumsum([c.n for c in self.chunks], out=self.offs[1:])
        self.total = int(self.offs[-1])
        self.names = [c.name for c in td.schema.columns
                      if cols is None or c.name in cols]
        self.dtypes = {c.name: np.dtype(c.type.np_dtype)
                       for c in td.schema.columns
                       if cols is None or c.name in cols}
        self.zone_preds = tuple(zone_preds)
        self.page_bytes = page_rows * (
            16 + sum(d.itemsize + 1 for d in self.dtypes.values()))
        self._buf_dtypes = dict(self.dtypes)
        self._buf_dtypes.update({f"__valid_{cn}": np.dtype(bool)
                                 for cn in self.names})
        self._buf_dtypes["_mvcc_ts"] = np.dtype(np.int64)
        self._buf_dtypes["_mvcc_del"] = np.dtype(np.int64)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda \
            else None
        # one set more than the prefetch queue holds
        self._ring: list = [None] * (PREFETCH_DEPTH + 1)
        self._next = 0
        # worker-side accounting: seconds spent assembling and
        # uploading, and bytes copied to the device
        self.busy_seconds = 0.0
        self.bytes_moved = 0
        self._m = {}
        if metrics is not None:
            for key, name, help_ in (
                    ("pages", "exec.stream.pages",
                     "streamed pages uploaded to the device"),
                    ("skipped", "exec.stream.pages_skipped",
                     "streamed pages pruned by zone maps (never "
                     "uploaded)"),
                    ("bytes", "exec.stream.bytes",
                     "host->device bytes moved by streamed pages"),
                    ("bytes_skipped", "exec.stream.bytes_skipped",
                     "host->device bytes avoided by page skipping"),
                    ("jf_pages", "exec.skip.joinfilter.pages",
                     "streamed pages pruned by a semi-join filter "
                     "derived from a hash-join build side"),
                    ("jf_bytes", "exec.skip.joinfilter.bytes",
                     "host->device bytes avoided by join-induced "
                     "skipping"),
                    ("mv_pages", "exec.skip.mvcc.pages",
                     "streamed pages pruned by the chunk MVCC window"),
                    ("mv_bytes", "exec.skip.mvcc.bytes",
                     "host->device bytes avoided by MVCC window "
                     "skipping")):
                self._m[key] = metrics.counter(name, help_)

    def _inc(self, key: str, v=1) -> None:
        m = self._m.get(key)
        if m is not None:
            m.inc(v)

    # -- page verdicts ---------------------------------------------------
    def _page_mvcc_ok(self, i0: int, i1: int) -> bool:
        """May any chunk in [i0, i1) hold a version visible at
        read_ts? (seal-time windows, storage/columnstore.py)"""
        rts = self.read_ts
        for ci in range(i0, i1):
            ts_min, del_max = self.chunks[ci].mvcc_window()
            if ts_min <= rts < del_max:
                return True
        return False

    def _page_verdict(self, i0: int, i1: int):
        """(may_match, by_joinfilter) for chunks [i0, i1) against every
        pushed-down conjunct. Combined chunk zones are supersets of any
        partial overlap; a pred's ``member`` refines the range verdict
        chunk by chunk (the page stays if ANY chunk may match)."""
        for p in self.zone_preds:
            if p.col is None:
                if not p.check(None, None, 0, 0):
                    return False, p.joinfilter
                continue
            lo = hi = None
            nulls = nvalid = 0
            unknown = False
            for ci in range(i0, i1):
                zlo, zhi, zn, zv = self.chunks[ci].zone(p.col)
                nulls += zn
                nvalid += zv
                if zv > 0:
                    if zlo is None:
                        unknown = True
                    else:
                        lo = zlo if lo is None else min(lo, zlo)
                        hi = zhi if hi is None else max(hi, zhi)
            if unknown:
                lo = hi = None
            if not p.check(lo, hi, nulls, nvalid):
                return False, p.joinfilter
            if p.member is not None and not unknown:
                if not any(p.member.chunk_ok(self.chunks[ci], p.col)
                           for ci in range(i0, i1)):
                    return False, p.joinfilter
        return True, False

    def _skip_page(self, by_joinfilter: bool, mvcc: bool = False) -> None:
        self._inc("skipped")
        self._inc("bytes_skipped", self.page_bytes)
        if mvcc:
            self._inc("mv_pages")
            self._inc("mv_bytes", self.page_bytes)
        elif by_joinfilter:
            self._inc("jf_pages")
            self._inc("jf_bytes", self.page_bytes)

    def pages(self):
        """Yield an Upload per surviving page, skipping zone-pruned and
        MVCC-window-excluded ones."""
        start = 0
        while start < self.total:
            end = min(start + self.page_rows, self.total)
            i0 = int(np.searchsorted(self.offs, start, side="right")) - 1
            i1 = int(np.searchsorted(self.offs, end, side="left"))
            if self.read_ts is not None \
                    and not self._page_mvcc_ok(i0, i1):
                self._skip_page(False, mvcc=True)
                start = end
                continue
            if self.zone_preds:
                ok, jf = self._page_verdict(i0, i1)
                if not ok:
                    self._skip_page(jf)
                    start = end
                    continue
            t0 = time.monotonic()
            bufs = self._ring_set()
            runs = []
            for ci in range(i0, i1):
                c = self.chunks[ci]
                coff = int(self.offs[ci])
                lo, hi = max(start - coff, 0), min(end - coff, c.n)
                runs.append((c, slice(lo, hi), coff + lo - start))
            vmask = self._fill(bufs, runs, end - start, self.page_rows)
            page = self._upload(bufs, self.page_rows, vmask)
            self.busy_seconds += time.monotonic() - t0
            self._inc("pages")
            self._inc("bytes", self.page_bytes)
            yield page
            start = end

    # -- assembly ----------------------------------------------------------
    def _ring_set(self) -> _BufferSet:
        """The next ring buffer set, once its previous copies are done
        (the event wait is what makes refilling it safe)."""
        k = self._next
        self._next = (k + 1) % len(self._ring)
        bufs = self._ring[k]
        if bufs is None:
            bufs = _BufferSet(self._buf_dtypes, self.page_rows, self._cuda)
            self._ring[k] = bufs
        elif bufs.event is not None:
            bufs.event.synchronize()
        return bufs

    def _fill(self, bufs: _BufferSet, runs, n: int, n_pad: int) -> set:
        """Fill ``bufs[:n]`` from ``runs`` of (chunk, row index,
        destination offset) and pad the tail never-visible. Returns the
        columns that hold a NULL (only those upload a validity mask)."""
        arr = bufs.arrays
        vmask = set()
        for cn in self.names:
            buf = arr[cn]
            vbuf = arr[f"__valid_{cn}"]
            for c, loc, dst in runs:
                d = c.data[cn][loc]
                k = d.shape[0]
                buf[dst:dst + k] = d
                v = c.valid[cn][loc]
                vbuf[dst:dst + k] = v
                if not v.all():
                    vmask.add(cn)
            buf[n:n_pad] = 0
            vbuf[n:n_pad] = False
        mts, mdl = arr["_mvcc_ts"], arr["_mvcc_del"]
        for c, loc, dst in runs:
            d = c.mvcc_ts[loc]
            k = d.shape[0]
            mts[dst:dst + k] = d
            mdl[dst:dst + k] = c.mvcc_del[loc]
        mts[n:n_pad] = NEVER_TS
        mdl[n:n_pad] = 0
        return vmask

    def _upload(self, bufs: _BufferSet, n_pad: int, vmask: set) -> Upload:
        """Copy ``n_pad`` rows of a filled buffer set to the device: on
        the card, async copies from pinned memory on the copy stream
        and an event after them; on the CPU, copies."""
        names = (*self.names, "_mvcc_ts", "_mvcc_del")
        vnames = [cn for cn in self.names if cn in vmask]
        nbytes = n_pad * (16 + sum(self.dtypes[cn].itemsize
                                   for cn in self.names) + len(vnames))
        self.bytes_moved += nbytes
        if not self._cuda:
            arr = bufs.arrays
            return Upload(
                {cn: torch.tensor(arr[cn][:n_pad]) for cn in names},
                {cn: torch.tensor(arr[f"__valid_{cn}"][:n_pad])
                 for cn in vnames}, None, nbytes)
        ts = bufs.tensors
        with torch.cuda.stream(self._stream):
            data = {cn: ts[cn][:n_pad].to(self.device, non_blocking=True)
                    for cn in names}
            valid = {cn: ts[f"__valid_{cn}"][:n_pad]
                     .to(self.device, non_blocking=True) for cn in vnames}
            ev = torch.cuda.Event()
            ev.record(self._stream)
        bufs.event = ev
        return Upload(data, valid, ev, nbytes)

    # -- spill-tier gathers (exec/spill.py) ---------------------------------
    def _runs_of(self, idx: np.ndarray) -> list:
        """(chunk, local indices, destination offset) runs for rows at
        ASCENDING global indices ``idx``: chunk ids are nondecreasing,
        so each (column, chunk run) is one fancy-index fill."""
        n = len(idx)
        if not n:
            return []
        ci = np.searchsorted(self.offs, idx, side="right") - 1
        bounds = np.flatnonzero(np.diff(ci)) + 1
        starts = np.concatenate(([0], bounds))
        ends = np.concatenate((bounds, [n]))
        return [(self.chunks[ci[s]], idx[s:e] - self.offs[ci[s]], int(s))
                for s, e in zip(starts, ends)]

    def gather_batch(self, idx: np.ndarray, n_pad: int) -> Upload:
        """One upload of exactly ``n_pad`` rows holding the rows at
        ascending global indices ``idx`` (a spill-join build
        partition; every partition pads to one shared row bucket). Its
        buffer set is its own, not the ring's."""
        t0 = time.monotonic()
        bufs = _BufferSet(self._buf_dtypes, n_pad, self._cuda)
        vmask = self._fill(bufs, self._runs_of(idx), len(idx), n_pad)
        up = self._upload(bufs, n_pad, vmask)
        self.busy_seconds += time.monotonic() - t0
        return up

    def gather_pages(self, idx: np.ndarray):
        """Yield page_rows-shaped uploads of the rows at ascending
        global indices ``idx`` (a spill-join probe partition), through
        the ring buffer sets like pages()."""
        for start in range(0, len(idx), self.page_rows):
            t0 = time.monotonic()
            sl = idx[start:start + self.page_rows]
            bufs = self._ring_set()
            vmask = self._fill(bufs, self._runs_of(sl), len(sl),
                               self.page_rows)
            up = self._upload(bufs, self.page_rows, vmask)
            self.busy_seconds += time.monotonic() - t0
            yield up

    def empty_page(self) -> ColumnBatch:
        """A page of never-visible padding rows only, made on the
        device: runs the page program to its identity state when every
        real page was skipped (an aggregate still yields its empty
        result)."""
        dev = self.device
        cols = {cn: torch.zeros(self.page_rows, dtype=torch_dtype(dt),
                                device=dev)
                for cn, dt in self.dtypes.items()}
        cols["_mvcc_ts"] = torch.full((self.page_rows,), int(NEVER_TS),
                                      dtype=torch.int64, device=dev)
        cols["_mvcc_del"] = torch.zeros(self.page_rows, dtype=torch.int64,
                                        device=dev)
        return ColumnBatch.from_dict(cols)


# ---------------------------------------------------------------------------
# bounded prefetch
# ---------------------------------------------------------------------------

_DONE = ("done", None)


def prefetch(it, depth: int = PREFETCH_DEPTH, stall_hist=None):
    """Run iterator ``it`` on a background thread at most ``depth``
    items ahead of the consumer.

    Returns a generator yielding ``it``'s items in order. A worker
    exception re-raises at the consumer's next pull; closing the
    generator (break, garbage collection, ``.close()``) stops and
    joins the worker, so no thread outlives the iteration.
    ``stall_hist`` observes the consumer's wait per item (zero when
    the pipeline is ahead)."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in it:
                if not _put(("ok", item)):
                    return
        except BaseException as e:  # re-raised at the consumer
            _put(("err", e))
            return
        _put(_DONE)

    t = threading.Thread(target=worker, name="page-prefetch", daemon=True)

    def gen():
        t.start()
        try:
            while True:
                t0 = time.monotonic()
                kind, val = q.get()
                if stall_hist is not None:
                    stall_hist.observe(time.monotonic() - t0)
                if kind == "done":
                    return
                if kind == "err":
                    raise val
                yield val
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=10.0)

    return gen()
