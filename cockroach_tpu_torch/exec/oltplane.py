"""The OLTP fast lane: statement-shape cache + native row mirror.

The port of cockroach_tpu/exec/oltplane.py. It runs on the host, as in
the reference: what the card sees of it is the deferred publish, which
the next analytic statement over the table flushes and uploads.

1. **Statement shapes** (`normalize`): literals are stripped from the
   SQL text (`SELECT ... WHERE k = 42` -> `... WHERE k = ?`, lits=[42])
   and the shape keys a cache of prebuilt handlers, so unparameterized
   client traffic skips the parser, binder and planner.
2. **Native row mirror** (`native/oltp.cpp`): eligible tables (one INT
   primary key, every column int64-representable, no CHECK, FK or
   column DEFAULT) keep an MVCC version mirror in C++. Point reads and
   ordered range scans run there with the GIL released.
3. **Write lane + deferred publish**: single-row INSERT/UPDATE/DELETE
   still write through kv.Txn (latches, timestamp-cache floor,
   intents, commit) and apply to the mirror at commit; the columnstore
   publish is queued and flushed in one chunk before the next
   full-path statement reads the table (`lane_flush`).

Full-path statements suspend lane writes only on the tables they can
read (`_stmt_tables`); a statement whose tables cannot be enumerated
(DDL, a view reference) suspends the lane everywhere. Lane reads bump
the timestamp cache like the Python fastpath, so a later writer never
commits beneath a served read. Every hit is recorded in the
engine's statement statistics under its shape (``sqlstats.record_fp``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import re
import threading
import time
from typing import Optional

import numpy as np

from ..kv.concurrency import Span, TxnAbortedError, TxnRetryError
from ..kv.txn import DB as KVDB
from ..kv.txn import Txn
from ..sql import ast
from ..sql.types import Family
from .session import EngineError, Result, Session
from .stmtutil import collect_tables, decode_scalar, split_conjuncts_ast

# literals: quoted strings first (so ints inside them don't match),
# then standalone integer tokens (not part of an identifier/number)
_LIT_RE = re.compile(r"'(?:[^']|'')*'|(?<![\w.])\d+(?![\w.\d])")


@functools.lru_cache(maxsize=8192)
def _normalize_text(sql: str):
    """Memoized (shape, literals-tuple) for one statement text: the
    regex pass runs once per distinct text, not once per execution."""
    lits: list = []

    def sub(m):
        tok = m.group(0)
        if tok.startswith("'"):
            lits.append(tok[1:-1].replace("''", "'"))
        else:
            lits.append(int(tok))
        return "?"

    return _LIT_RE.sub(sub, sql), tuple(lits)


def normalize(sql: str):
    """(shape, literals): literals replaced by ? placeholders."""
    shape, lits = _normalize_text(sql)
    return shape, list(lits)


# ---------------------------------------------------------------------------
# native table mirror
# ---------------------------------------------------------------------------

_INT_FAMS = (Family.INT, Family.BOOL, Family.DATE, Family.TIMESTAMP,
             Family.INTERVAL, Family.DECIMAL)


def mirror_eligible(schema) -> bool:
    """Single-column INT primary key, every column int64-representable
    in storage form, no hidden columns."""
    if len(schema.primary_key) != 1:
        return False
    pk = schema.primary_key[0]
    for c in schema.columns:
        if getattr(c, "hidden", False):
            return False
        if c.type.uses_dictionary or c.type.family not in _INT_FAMS:
            return False
        if np.dtype(c.type.np_dtype).kind not in "iub":
            return False
        if c.name == pk and c.type.family != Family.INT:
            return False
    return True


_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)


class TableMirror:
    """One table's native MVCC version mirror."""

    def __init__(self, lib, schema):
        self.lib = lib
        self.schema = schema
        self.pk = schema.primary_key[0]
        self.cols = [c.name for c in schema.columns]
        self.ncols = len(self.cols)
        self.h = lib.oltp_create(self.ncols)
        self.synced_gen = -1
        # per-thread scratch buffers for point reads and scans (each
        # call copies its rows out before returning)
        self._local = threading.local()

    def __del__(self):
        try:
            self.lib.oltp_destroy(self.h)
        except Exception:
            pass

    def _bufs(self, cap: int):
        st = getattr(self._local, "bufs", None)
        if st is None or st[0] < cap:
            keys = np.empty(cap, dtype=np.int64)
            vals = np.empty(cap * self.ncols, dtype=np.int64)
            vld = np.empty(cap * self.ncols, dtype=np.uint8)
            st = (cap, keys, vals, vld, keys.ctypes.data_as(_I64P),
                  vals.ctypes.data_as(_I64P), vld.ctypes.data_as(_U8P))
            self._local.bufs = st
        return st

    def rebuild(self, td) -> None:
        """Load every row version from the columnstore chunks, bulk
        loaded ones included (all versions: the chains keep history)."""
        self.lib.oltp_destroy(self.h)
        self.h = self.lib.oltp_create(self.ncols)
        parts = []
        for ch in td.chunks:
            n = ch.n
            if n == 0:
                continue
            cols = np.empty((self.ncols, n), dtype=np.int64)
            vld = np.empty((self.ncols, n), dtype=np.uint8)
            for i, cn in enumerate(self.cols):
                cols[i] = ch.data[cn].astype(np.int64)
                vld[i] = ch.valid[cn].astype(np.uint8)
            parts.append((ch.data[self.pk].astype(np.int64),
                          ch.mvcc_ts.astype(np.int64),
                          ch.mvcc_del.astype(np.int64), cols, vld))
        if parts:
            keys = np.concatenate([p[0] for p in parts])
            ts = np.concatenate([p[1] for p in parts])
            order = np.lexsort((ts, keys))
            keys = np.ascontiguousarray(keys[order])
            ts = np.ascontiguousarray(ts[order])
            del_ = np.ascontiguousarray(
                np.concatenate([p[2] for p in parts])[order])
            cols = np.ascontiguousarray(
                np.concatenate([p[3] for p in parts], axis=1)[:, order])
            vld = np.ascontiguousarray(
                np.concatenate([p[4] for p in parts], axis=1)[:, order])
            self.lib.oltp_bulk(
                self.h, len(keys), keys.ctypes.data_as(_I64P),
                ts.ctypes.data_as(_I64P), del_.ctypes.data_as(_I64P),
                cols.ctypes.data_as(_I64P), vld.ctypes.data_as(_U8P))
        self.synced_gen = td.generation

    def put(self, key: int, ts: int, vals: dict) -> None:
        v = np.empty(self.ncols, dtype=np.int64)
        m = np.empty(self.ncols, dtype=np.uint8)
        for i, cn in enumerate(self.cols):
            x = vals.get(cn)
            v[i] = 0 if x is None else int(x)
            m[i] = x is not None
        self.lib.oltp_put(self.h, int(key), int(ts),
                          v.ctypes.data_as(_I64P), m.ctypes.data_as(_U8P))

    def delete(self, key: int, ts: int) -> None:
        self.lib.oltp_del(self.h, int(key), int(ts))

    def live(self, key: int, read_ts: int) -> bool:
        return bool(self.lib.oltp_live(self.h, int(key), int(read_ts)))

    def read(self, key: int, read_ts: int):
        """(vals_i64_list, valid_list) or None."""
        _, _, vals, vld, _, vp, mp = self._bufs(max(64, self.ncols))
        if not self.lib.oltp_read(self.h, int(key), int(read_ts), vp, mp):
            return None
        return vals[:self.ncols].tolist(), vld[:self.ncols].tolist()

    def multiread(self, keys, read_ts: int):
        """Fused gather for one batch window: (vals row-major list,
        valid list, found list) over the whole key vector in one native
        call (one shared-lock acquisition, one GIL release)."""
        n = len(keys)
        karr = np.ascontiguousarray(keys, dtype=np.int64)
        vals = np.empty(max(n, 1) * self.ncols, dtype=np.int64)
        vld = np.empty(max(n, 1) * self.ncols, dtype=np.uint8)
        fnd = np.zeros(max(n, 1), dtype=np.uint8)
        self.lib.oltp_multiread(
            self.h, n, karr.ctypes.data_as(_I64P), int(read_ts),
            vals.ctypes.data_as(_I64P), vld.ctypes.data_as(_U8P),
            fnd.ctypes.data_as(_U8P))
        return vals.tolist(), vld.tolist(), fnd.tolist()

    def scan(self, lo, lo_strict, hi, hi_strict, read_ts: int, cap: int):
        """(nrows, keys[], vals row-major, valid row-major)."""
        _, keys, vals, vld, kp, vp, mp = self._bufs(max(cap, 64))
        n = self.lib.oltp_scan(
            self.h, int(lo) if lo is not None else 0, int(lo is not None),
            int(bool(lo_strict)), int(hi) if hi is not None else 0,
            int(hi is not None), int(bool(hi_strict)), int(read_ts),
            int(cap), kp, vp, mp)
        return n, keys, vals, vld


# ---------------------------------------------------------------------------
# lane plans (one per statement shape)
# ---------------------------------------------------------------------------

class LanePlan:
    """Prebuilt executor for one statement shape. kind:
    'point' | 'scan' | 'insert' | 'update' | 'delete'."""

    __slots__ = ("kind", "table", "out_names", "out_types", "out_pairs",
                 "pk_lit", "lo_lit", "lo_strict", "hi_lit", "hi_strict",
                 "limit_lit", "set_cols", "set_lits", "ins_cols",
                 "ins_lits", "nlits", "lit_kinds", "codec", "epoch")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw.get(k))


class ShapeIneligible(Exception):
    pass


# a lane write's table is read by a full-path statement in flight
_SUSPENDED = "nonlane active"
_CDC = "changefeed active"


# sentinel literal values used to discover slot roles: the shape text
# re-parses with slot i carrying SENT_BASE+i (or a marker string), so
# the role of each ? is read off the AST structurally, never guessed
# from runtime values (two slots can carry equal values)
SENT_BASE = 7_700_000_000
SENT_STR = "\x00slot{}"


class _Slot:
    """One literal slot reference discovered at sentinel position i;
    neg marks a sentinel consumed under unary minus."""

    __slots__ = ("i", "neg")

    def __init__(self, i: int, neg: bool = False):
        self.i = i
        self.neg = neg

    def get(self, lits):
        v = lits[self.i]
        return -v if self.neg else v


class _Const:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    def get(self, _lits):
        return self.v


def _slot_of(value, nlits):
    """Map a parsed literal value back to its slot (or None for a
    constant baked into the shape)."""
    if isinstance(value, str) and value.startswith("\x00slot"):
        return _Slot(int(value[6:]))
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        iv = int(value)
        if SENT_BASE <= iv < SENT_BASE + nlits:
            return _Slot(iv - SENT_BASE)
        if -SENT_BASE - nlits < iv <= -SENT_BASE:
            return _Slot(-iv - SENT_BASE, neg=True)
    return None


def _sentinel_sql(shape: str, lits: list) -> str:
    out = []
    for i, part in enumerate(shape.split("?")):
        out.append(part)
        if i < len(lits):
            out.append("'" + SENT_STR.format(i) + "'"
                       if isinstance(lits[i], str) else str(SENT_BASE + i))
    return "".join(out)


def _decoder(ty):
    """Per-type storage-int -> client-value decoder."""
    f = ty.family
    if f == Family.INT:
        return int
    if f == Family.BOOL:
        return bool
    return lambda v, _t=ty: decode_scalar(v, True, _t, None)


class OltpLaneMixin:
    """Engine methods of the OLTP fast lane; mixed into
    exec.engine.Engine (all state lives on the Engine instance)."""

    def _lane_init(self) -> None:
        self._lane_lib_h = None            # native/oltp.cpp, at first use
        self._lane_shapes: dict = {}       # shape -> LanePlan | None
        self._lane_mirrors: dict = {}      # table -> TableMirror
        self._lane_pending: dict = {}      # table -> [(op, tsi), ...]
        # moved by DDL: a plan classified before it is stale, even when
        # it reaches the gate after the DDL ran (_lane_check)
        self._lane_epoch = 0
        self._lane_lock = threading.Lock()
        # commit-vs-snapshot fence: a lane COMMIT (suspension check,
        # kv commit, mirror and queue apply) and a full-path statement's
        # suspension (count increment, pending check) each happen
        # atomically under this lock, so a full-path read never takes a
        # snapshot between a lane commit and its queue append
        self._lane_sync = threading.Lock()
        # full-path statements in flight whose tables are unknown, and
        # per table the full-path statements that can read it
        self._nonlane_active = 0
        self._nonlane_tables: dict = {}
        self._lane_hits = self.metrics.counter(
            "exec.oltp.lane.hits", "statements the OLTP lane served")
        self._lane_misses = self.metrics.counter(
            "exec.oltp.lane.misses",
            "statement shapes the OLTP lane classified as ineligible")
        self._lane_fallbacks = self.metrics.counter(
            "exec.oltp.lane.fallbacks",
            "lane writes sent to the full path because a full-path "
            "statement over their table was in flight")
        self._lane_flushes = self.metrics.counter(
            "exec.oltp.lane.flushes",
            "deferred publishes: one columnstore chunk per table flushed")
        self._lane_published = self.metrics.counter(
            "exec.oltp.lane.published_ops",
            "lane writes published to the columnstore")
        self._lane_cdc_declines = self.metrics.counter(
            "exec.oltp.lane.cdc_declines",
            "lane plans and writes declined: a changefeed is active on "
            "their table")
        self._gc_proposals = self.metrics.counter(
            "kv.groupcommit.proposals",
            "group commits: one kv commit per batch-window write round")
        self._gc_commands = self.metrics.counter(
            "kv.groupcommit.commands",
            "statements that rode group commits")
        from .oltpbatch import LaneBatcher
        self._lane_batcher = LaneBatcher(self, self.metrics)

    @property
    def lane_hits(self) -> int:
        return self._lane_hits.value()

    @property
    def lane_misses(self) -> int:
        return self._lane_misses.value()

    @property
    def _lane_lib(self):
        """The native row mirror's library, built at first use; a
        failed build raises (native.NativeBuildError)."""
        if self._lane_lib_h is None:
            from ..native import get_oltp
            self._lane_lib_h = get_oltp()
        return self._lane_lib_h

    # -- entry ------------------------------------------------------------
    def lane_execute(self, sql: str,
                     session: Optional[Session]) -> Optional[Result]:
        """Serve ``sql`` from the lane, or None to take the full path.
        Never raises for ineligibility, only for real statement errors
        (duplicate key, NOT NULL). A cluster-backed engine takes the
        full path for every statement: the lane's writes would bypass
        the replicated ranges."""
        if self.cluster is not None:
            return None
        if session is not None and (
                session.txn is not None or session.effects
                or session.txn_aborted
                or session.vars.get("index_scan", "on") == "off"):
            return None
        shape, lits = normalize(sql)
        plan = self._lane_shapes.get(shape, ShapeIneligible)
        if plan is ShapeIneligible:
            plan = self._lane_build(shape, lits)
        if plan is None:
            return None
        if len(lits) != plan.nlits or \
                plan.lit_kinds != [isinstance(v, str) for v in lits]:
            # a literal kind other than the one the shape was classified
            # with (WHERE k = 'abc' against a shape built for k = 42):
            # the full path binds it and raises the real type error
            return None
        t0 = time.perf_counter()
        try:
            if plan.kind == "scan":
                # range scans stay per statement: the native scan is
                # one fused pass already, and their result sizes would
                # make window buffers unbounded
                res = self._lane_read(plan, lits, session)
            elif session is not None and \
                    session.vars.get("oltp_batch", "auto") == "off":
                # off is exactly the per-statement path
                res = (self._lane_read(plan, lits, session)
                       if plan.kind == "point"
                       else self._lane_write(plan, lits))
            else:
                res = self._lane_batcher.submit(plan, lits, session)
        except ShapeIneligible as e:
            if str(e) == _SUSPENDED:
                self._lane_fallbacks.inc()
            return None
        if res is not None:
            self._lane_hits.inc()
            self.sqlstats.record_fp(shape, time.perf_counter() - t0,
                                    max(len(res.rows), res.row_count))
        return res

    # -- shape classification ---------------------------------------------
    def _lane_build(self, shape: str, lits: list):
        epoch = self._lane_epoch
        try:
            plan = self._lane_classify(shape, lits)
        except Exception:
            # whatever the classifier cannot read is not a lane shape:
            # the full path parses it and raises its own errors
            plan = None
        if plan is not None:
            # classified against these literal kinds (the sentinel SQL
            # bakes int-vs-string into the parse)
            plan.lit_kinds = [isinstance(v, str) for v in lits]
            plan.epoch = epoch
        else:
            self._lane_misses.inc()
        if len(self._lane_shapes) > 4096:
            self._lane_shapes.clear()
        self._lane_shapes[shape] = plan
        return plan

    def _lane_table_ok(self, tname: str) -> bool:
        """Schema-level eligibility: mirrorable columns and none of the
        write-path features the lane skips (CHECK, FK, FK children,
        column DEFAULTs, ALTER TABLE defaults, secondary indexes, whose
        unique entries and locators only the full path maintains) and no
        live changefeed: those statements take the full path."""
        if tname not in self.store.tables or tname in self._view_map():
            return False
        if self._lane_fed(tname):
            return False
        td = self.store.table(tname)
        if not mirror_eligible(td.schema):
            return False
        if any(c.default is not None for c in td.schema.columns) \
                or td.column_defaults or self._table_indexes(tname):
            return False
        d = self.catalog.get_by_name(tname)
        if d is not None and (d.checks or d.fks):
            return False
        return not self._fk_children_of(tname)

    def _lane_classify(self, shape: str, lits: list):
        from ..sql import parser
        stmt = parser.parse(_sentinel_sql(shape, lits))
        n = len(lits)

        def lit_ref(e):
            if not isinstance(e, ast.Literal) or e.value is None:
                return None
            s = _slot_of(e.value, n)
            return s if s is not None else _Const(e.value)

        for cls, fn in ((ast.Select, self._classify_select),
                        (ast.Insert, self._classify_insert),
                        (ast.Update, self._classify_update),
                        (ast.Delete, self._classify_delete)):
            if isinstance(stmt, cls):
                return fn(stmt, n, lit_ref)
        return None

    def _classify_select(self, sel, n, lit_ref):
        if (sel.table is None or sel.joins or sel.group_by
                or sel.having or sel.distinct or sel.ctes
                or getattr(sel, "as_of", None) is not None
                or sel.table.subquery is not None
                or getattr(sel, "windows", None)):
            return None
        tname = sel.table.name
        if sel.table.alias not in (None, tname) \
                or not self._lane_table_ok(tname):
            return None
        schema = self.store.table(tname).schema
        pk = schema.primary_key[0]
        out = []
        for item in sel.items:
            if item.star:
                out.extend((c.name, c.name) for c in schema.columns)
                continue
            e = item.expr
            if not (isinstance(e, ast.ColumnRef)
                    and e.table in (None, tname)
                    and any(c.name == e.name for c in schema.columns)):
                return None
            out.append((item.alias or e.name, e.name))
        eq = lo = hi = None
        lo_strict = hi_strict = False
        if sel.where is None:
            return None
        for c in split_conjuncts_ast(sel.where):
            if not (isinstance(c, ast.BinOp)
                    and c.op in ("=", "<", "<=", ">", ">=")):
                return None
            lhs, rhs, op = c.left, c.right, c.op
            if isinstance(lhs, ast.Literal) and \
                    isinstance(rhs, ast.ColumnRef):
                lhs, rhs = rhs, lhs
                op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op,
                                                                     op)
            if not (isinstance(lhs, ast.ColumnRef) and lhs.name == pk
                    and lhs.table in (None, tname)):
                return None
            ref = lit_ref(rhs)
            if ref is None or isinstance(getattr(rhs, "value", None), str):
                return None
            if op == "=":
                if eq is not None:
                    return None
                eq = ref
            elif op in (">", ">="):
                if lo is not None:
                    return None
                lo, lo_strict = ref, op == ">"
            else:
                if hi is not None:
                    return None
                hi, hi_strict = ref, op == "<"
        if eq is not None and (lo is not None or hi is not None):
            return None
        if sel.order_by:
            if len(sel.order_by) != 1:
                return None
            ob = sel.order_by[0]
            if not (isinstance(ob.expr, ast.ColumnRef)
                    and ob.expr.name == pk and not ob.desc):
                return None
        limit_ref = None
        if sel.limit is not None:
            limit_ref = lit_ref(sel.limit if isinstance(
                sel.limit, ast.Literal) else ast.Literal(sel.limit))
            if limit_ref is None:
                return None
        if sel.offset:
            return None
        if eq is None and lo is None and hi is None:
            return None
        types = {c.name: c.type for c in schema.columns}
        pos = {c.name: i for i, c in enumerate(schema.columns)}
        return LanePlan(
            kind="point" if eq is not None else "scan", table=tname,
            nlits=n, out_names=[o for o, _ in out],
            out_types=[types[s] for _, s in out],
            out_pairs=[(pos[s], _decoder(types[s])) for _, s in out],
            pk_lit=eq, lo_lit=lo, lo_strict=lo_strict, hi_lit=hi,
            hi_strict=hi_strict, limit_lit=limit_ref,
            codec=self.store.table(tname).codec)

    def _classify_insert(self, ins, n, lit_ref):
        if ins.select is not None or ins.upsert or len(ins.rows) != 1:
            return None
        tname = ins.table
        if not self._lane_table_ok(tname):
            return None
        schema = self.store.table(tname).schema
        cols = list(ins.columns or schema.column_names)
        if len(ins.rows[0]) != len(cols):
            return None
        refs = []
        for e in ins.rows[0]:
            if isinstance(e, ast.Literal) and e.value is None:
                refs.append(_Const(None))
                continue
            r = lit_ref(e)
            if r is None:
                return None
            refs.append(r)
        # every column left out must be nullable (no DEFAULTs: see
        # _lane_table_ok)
        if any(c.name not in cols and not c.nullable
               for c in schema.columns):
            return None
        return LanePlan(kind="insert", table=tname, nlits=n,
                        ins_cols=cols, ins_lits=refs,
                        codec=self.store.table(tname).codec)

    def _classify_update(self, upd, n, lit_ref):
        tname = upd.table
        if not self._lane_table_ok(tname):
            return None
        schema = self.store.table(tname).schema
        pk = schema.primary_key[0]
        sets, slits = [], []
        for cname, e in upd.assignments:
            if cname == pk or not any(c.name == cname
                                      for c in schema.columns):
                return None       # a pk rewrite or unknown column
            if isinstance(e, ast.Literal) and e.value is None:
                r = _Const(None)
            else:
                r = lit_ref(e)
                if r is None:
                    return None
            sets.append(cname)
            slits.append(r)
        eq = self._pk_eq(upd.where, tname, pk, lit_ref)
        if eq is None:
            return None
        return LanePlan(kind="update", table=tname, nlits=n, pk_lit=eq,
                        set_cols=sets, set_lits=slits,
                        codec=self.store.table(tname).codec)

    def _classify_delete(self, dele, n, lit_ref):
        tname = dele.table
        if not self._lane_table_ok(tname):
            return None
        pk = self.store.table(tname).schema.primary_key[0]
        eq = self._pk_eq(dele.where, tname, pk, lit_ref)
        if eq is None:
            return None
        return LanePlan(kind="delete", table=tname, nlits=n, pk_lit=eq,
                        codec=self.store.table(tname).codec)

    @staticmethod
    def _pk_eq(where, tname, pk, lit_ref):
        if not (isinstance(where, ast.BinOp) and where.op == "="):
            return None
        lhs, rhs = where.left, where.right
        if isinstance(lhs, ast.Literal) and isinstance(rhs, ast.ColumnRef):
            lhs, rhs = rhs, lhs
        if not (isinstance(lhs, ast.ColumnRef) and lhs.name == pk
                and lhs.table in (None, tname)):
            return None
        if isinstance(getattr(rhs, "value", None), str):
            return None
        return lit_ref(rhs)

    def _lane_check(self, plan: LanePlan) -> None:
        """Under the statement gate: the plan was classified after the
        last DDL, so its table and columns are the current ones."""
        if plan.epoch != self._lane_epoch:
            raise ShapeIneligible("schema changed")

    # -- mirrors ------------------------------------------------------------
    def _lane_mirror(self, tname: str) -> TableMirror:
        """Current mirror of ``tname``, rebuilt when the columnstore moved
        underneath it (a full-path write moves the generation)."""
        td = self.store.tables.get(tname)
        if td is None:
            raise ShapeIneligible(tname)
        m = self._lane_mirrors.get(tname)
        if m is not None and (m.synced_gen == td.generation
                              or self._lane_pending.get(tname)):
            return m
        with self._lane_lock:
            m = self._lane_mirrors.get(tname)
            if m is not None and (m.synced_gen == td.generation
                                  or self._lane_pending.get(tname)):
                return m
            m = TableMirror(self._lane_lib, td.schema)
            m.rebuild(td)
            self._lane_mirrors[tname] = m
            return m

    # -- read handlers ------------------------------------------------------
    @staticmethod
    def _lane_row(plan, vals, vld, base: int):
        return tuple(dec(vals[base + p]) if vld[base + p] else None
                     for p, dec in plan.out_pairs)

    def _lane_read(self, plan: LanePlan, lits, session):
        self._stmt_lock.acquire_read()
        try:
            self._lane_check(plan)
            m = self._lane_mirror(plan.table)
            read_ts = self.clock.now()
            rtsi = read_ts.to_int()
            tsc = self.kv.store.tscache
            if plan.kind == "point":
                key = int(plan.pk_lit.get(lits))
                tsc.add(Span(plan.codec.key_from_pk((key,))), read_ts,
                        None)
                got = m.read(key, rtsi)
                rows = [] if got is None else [
                    self._lane_row(plan, got[0], got[1], 0)]
                if plan.limit_lit is not None:
                    rows = rows[:max(int(plan.limit_lit.get(lits)), 0)]
                return Result(names=plan.out_names, rows=rows,
                              types=plan.out_types)
            lo = (int(plan.lo_lit.get(lits))
                  if plan.lo_lit is not None else None)
            hi = (int(plan.hi_lit.get(lits))
                  if plan.hi_lit is not None else None)
            limit = (int(plan.limit_lit.get(lits))
                     if plan.limit_lit is not None else None)
            cap_var = int(session.vars.get("index_lookup_limit", 4096)
                          if session is not None else 4096)
            if limit is not None and (limit < 0 or limit > cap_var):
                # the compiled path; this also bounds the buffer
                # allocation at cap_var
                return None
            cap = limit if limit is not None else cap_var + 1
            start, end = plan.codec.span()
            kb = plan.codec.key_from_pk((lo,)) if lo is not None else start
            ke = (plan.codec.key_from_pk((hi,)) + b"\xff"
                  if hi is not None else end)
            tsc.add(Span(kb, ke), read_ts, None)
            nrow, _keys, vals, vld = m.scan(lo, plan.lo_strict, hi,
                                            plan.hi_strict, rtsi, cap)
            if limit is None and nrow > cap_var:
                return None       # low selectivity: the compiled path
            ncols = m.ncols
            vlist = vals[:nrow * ncols].tolist()
            mlist = vld[:nrow * ncols].tolist()
            rows = [self._lane_row(plan, vlist, mlist, r * ncols)
                    for r in range(nrow)]
            return Result(names=plan.out_names, rows=rows,
                          types=plan.out_types)
        finally:
            self._stmt_lock.release_read()

    # -- write handlers -----------------------------------------------------
    def _nonlane_busy(self, table: str) -> bool:
        """A full-path statement that can read ``table`` is in flight."""
        return bool(self._nonlane_active or self._nonlane_tables.get(table))

    def _lane_write(self, plan: LanePlan, lits):
        """One auto-commit write through kv.Txn with the retry loop
        (KVDB.MAX_ATTEMPTS), applied to the mirror and queued for the
        publish at its commit timestamp."""
        from .dml import retry_exhausted
        self._stmt_lock.acquire_read()
        try:
            self._lane_check(plan)
            if self._nonlane_busy(plan.table):
                # a full-path statement over this table is in flight:
                # its snapshot was taken after a flush, so new writes
                # must not queue beneath it (re-checked at commit)
                raise ShapeIneligible(_SUSPENDED)
            if self._lane_fed(plan.table):
                # checked here too, not only at plan build: a feed
                # registers after CREATE CHANGEFEED returns
                raise ShapeIneligible(_CDC)
            m = self._lane_mirror(plan.table)
            td = self.store.table(plan.table)
            last = None
            for _ in range(KVDB.MAX_ATTEMPTS):
                t = Txn(self.kv.store)
                try:
                    with self._lane_sync:
                        if self._nonlane_busy(plan.table):
                            raise ShapeIneligible(_SUSPENDED)
                        res, op = self._lane_write_once(plan, lits, t, m,
                                                        td.schema)
                        tsi = t.commit().to_int()
                        if op is not None:
                            with self._lane_lock:
                                self._lane_apply_mirror(m, op, tsi)
                                self._lane_pending.setdefault(
                                    plan.table, []).append((op, tsi))
                    return res
                except (TxnRetryError, TxnAbortedError) as e:
                    t.rollback()
                    last = e
                except BaseException:
                    t.rollback()
                    raise
            raise retry_exhausted(last)
        finally:
            self._stmt_lock.release_read()

    @staticmethod
    def _lane_apply_mirror(m: TableMirror, op, tsi: int) -> None:
        if op[0] == "put":
            m.put(op[2][m.pk], tsi, op[2])
        else:
            m.delete(op[2], tsi)

    def _lane_write_once(self, plan, lits, t, m, schema):
        """Write one statement into txn ``t``: (Result, op) where op is
        ("put", key, row), ("del", key, pk) or None (nothing matched).
        Every statement error raises before ``t.put``, so a shared
        group-commit txn carries no trace of a failed request."""
        codec = plan.codec
        rtsi = t.meta.read_ts.to_int()
        if plan.kind == "insert":
            row = {}
            for cn, ref in zip(plan.ins_cols, plan.ins_lits):
                col = schema.column(cn)
                v = ref.get(lits)
                if v is None:
                    if not col.nullable:
                        raise EngineError(f"null in non-null column {cn}")
                    row[cn] = None
                else:
                    row[cn] = self._lane_coerce(col, v)
            for col in schema.columns:
                if col.name not in row:
                    if not col.nullable:
                        raise EngineError(
                            f"null in non-null column {col.name}")
                    row[col.name] = None
            key = codec.key(row)
            if t.get(key) is not None or m.live(row[m.pk], rtsi):
                raise EngineError(
                    f"duplicate key value {codec.pk_values(row)!r} "
                    f"violates primary key of {plan.table!r}")
            t.put(key, codec.encode_value(row))
            return Result(row_count=1, tag="INSERT"), ("put", key, row)
        pk_val = int(plan.pk_lit.get(lits))
        key = codec.key_from_pk((pk_val,))
        # the KV read registers the read span and surfaces conflicting
        # intents (push or abort through the txn machinery)
        t.get(key)
        got = m.read(pk_val, rtsi)
        if got is None:
            return (Result(row_count=0, tag=plan.kind.upper()), None)
        if plan.kind == "delete":
            t.delete(key)
            return Result(row_count=1, tag="DELETE"), ("del", key, pk_val)
        vals, vld = got
        row = {cn: (vals[i] if vld[i] else None)
               for i, cn in enumerate(m.cols)}
        for cn, ref in zip(plan.set_cols, plan.set_lits):
            v = ref.get(lits)
            col = schema.column(cn)
            if v is None:
                if not col.nullable:
                    raise EngineError(f"null in non-null column {cn}")
                row[cn] = None
            else:
                row[cn] = self._lane_coerce(col, v)
        t.put(key, codec.encode_value(row))
        return Result(row_count=1, tag="UPDATE"), ("put", key, row)

    @staticmethod
    def _lane_coerce(col, v):
        f = col.type.family
        if f == Family.INT:
            return int(v)
        if f == Family.BOOL:
            return bool(v)
        if f == Family.DECIMAL and isinstance(v, int):
            return v * 10 ** col.type.scale
        raise ShapeIneligible(f"uncoercible {f}")

    # -- batch windows (exec/oltpbatch.py drives these) ---------------------
    def _lane_read_batch(self, reqs) -> None:
        """One fused multi-key probe for a window of point reads: one
        gate acquisition, one read timestamp and one native multiread
        per table. Each request's tscache span is still registered on
        its own, so writers see exactly the spans the per-statement
        path would leave."""
        self._stmt_lock.acquire_read()
        try:
            read_ts = self.clock.now()
            rtsi = read_ts.to_int()
            tsc = self.kv.store.tscache
            groups: dict = {}
            for req in reqs:
                if req.plan.epoch != self._lane_epoch:
                    req.error = ShapeIneligible("schema changed")
                else:
                    groups.setdefault(req.plan.table, []).append(req)
            for tname, group in groups.items():
                try:
                    m = self._lane_mirror(tname)
                except ShapeIneligible as e:
                    for req in group:
                        req.error = e
                    continue
                keys = []
                for req in group:
                    key = int(req.plan.pk_lit.get(req.lits))
                    tsc.add(Span(req.plan.codec.key_from_pk((key,))),
                            read_ts, None)
                    keys.append(key)
                vals, vld, fnd = m.multiread(keys, rtsi)
                for i, req in enumerate(group):
                    plan = req.plan
                    rows = ([self._lane_row(plan, vals, vld, i * m.ncols)]
                            if fnd[i] else [])
                    if plan.limit_lit is not None:
                        rows = rows[:max(int(plan.limit_lit.get(req.lits)),
                                         0)]
                    req.result = Result(names=plan.out_names, rows=rows,
                                        types=plan.out_types)
        finally:
            self._stmt_lock.release_read()

    def _lane_write_batch(self, reqs) -> None:
        """Group commit for a window of single-row writes: the window
        splits into rounds with at most one write per (table, pk) (a
        second write to a key must observe the first's commit, which a
        shared txn cannot give it), and each round commits as one kv
        transaction while every waiter gets its own Result or error."""
        self._stmt_lock.acquire_read()
        try:
            live = []
            for req in reqs:
                if req.plan.epoch != self._lane_epoch:
                    req.error = ShapeIneligible("schema changed")
                elif self._nonlane_busy(req.plan.table):
                    # waiters fall back to the full path, as the
                    # per-statement lane does
                    req.error = ShapeIneligible(_SUSPENDED)
                elif self._lane_fed(req.plan.table):
                    req.error = ShapeIneligible(_CDC)
                else:
                    live.append(req)
            while live:
                seen: set = set()
                this_round, defer = [], []
                for req in live:
                    k = (req.plan.table, self._lane_req_pk(req))
                    (defer if k in seen else this_round).append(req)
                    seen.add(k)
                self._lane_write_round(this_round)
                live = defer
        finally:
            self._stmt_lock.release_read()

    def _lane_req_pk(self, req):
        """The primary-key value a write request targets (the round
        split's dedup key). Uncoercible values pass through raw: the
        round surfaces the real statement error."""
        plan, lits = req.plan, req.lits
        if plan.kind == "insert":
            pk = self.store.table(plan.table).schema.primary_key[0]
            for cn, ref in zip(plan.ins_cols, plan.ins_lits):
                if cn == pk:
                    v = ref.get(lits)
                    try:
                        return int(v)
                    except (TypeError, ValueError):
                        return v
            return None
        return int(plan.pk_lit.get(lits))

    def _lane_write_round(self, reqs) -> None:
        from .dml import retry_exhausted
        ctx: dict = {}
        for req in reqs:
            tname = req.plan.table
            if tname not in ctx:
                ctx[tname] = (self._lane_mirror(tname),
                              self.store.table(tname).schema)
        last = None
        for _ in range(KVDB.MAX_ATTEMPTS):
            t = Txn(self.kv.store)
            try:
                with self._lane_sync:
                    if any(self._nonlane_busy(tn) for tn in ctx):
                        raise ShapeIneligible(_SUSPENDED)
                    outcomes = []
                    for req in reqs:
                        m, schema = ctx[req.plan.table]
                        try:
                            outcomes.append((req, self._lane_write_once(
                                req.plan, req.lits, t, m, schema), None))
                        except (EngineError, ShapeIneligible) as e:
                            outcomes.append((req, None, e))
                    tsi = t.commit().to_int()   # one commit for the round
                    nops = 0
                    with self._lane_lock:
                        for req, res, _err in outcomes:
                            if res is None or res[1] is None:
                                continue
                            self._lane_apply_mirror(
                                ctx[req.plan.table][0], res[1], tsi)
                            self._lane_pending.setdefault(
                                req.plan.table, []).append((res[1], tsi))
                            nops += 1
                if nops:
                    self._gc_proposals.inc()
                    self._gc_commands.inc(nops)
                for req, res, err in outcomes:
                    if err is not None:
                        req.error = err
                    else:
                        req.result = res[0]
                return
            except (TxnRetryError, TxnAbortedError) as e:
                t.rollback()
                last = e
            except BaseException:
                t.rollback()
                raise
        raise retry_exhausted(last)

    # -- full-path statements: suspension and the deferred publish ----------
    @contextlib.contextmanager
    def _nonlane_scope(self, tables, waits: dict | None = None):
        """Scope of one full-path statement: lane writes on ``tables``
        (every table when None) are suspended while it runs, and their
        queued publishes are flushed before it takes its snapshot.
        ``waits`` gets the seconds spent on the commit fence
        (``fence_s``) and on the flush (``flush_s``)."""
        t0 = time.perf_counter()
        with self._lane_sync:
            # atomic with lane commits: after this block any lane write
            # to a suspended table already sits in _lane_pending
            # (flushed below) or sees the suspension and takes the
            # full path
            if tables is None:
                self._nonlane_active += 1
                pending = bool(self._lane_pending)
            else:
                nt = self._nonlane_tables
                for t in tables:
                    nt[t] = nt.get(t, 0) + 1
                pending = any(t in self._lane_pending for t in tables)
        t1 = time.perf_counter()
        try:
            if pending:
                with self._stmt_lock:
                    self.lane_flush(tables)
            if waits is not None:
                waits["fence_s"] = t1 - t0
                waits["flush_s"] = time.perf_counter() - t1
            yield
        finally:
            with self._lane_sync:
                if tables is None:
                    self._nonlane_active -= 1
                else:
                    nt = self._nonlane_tables
                    for t in tables:
                        n = nt.get(t, 0) - 1
                        if n > 0:
                            nt[t] = n
                        else:
                            nt.pop(t, None)

    def lane_flush(self, tables=None) -> None:
        """Publish queued lane writes to the columnstore, one sealed
        chunk per table (ColumnStore.apply_committed_batch). The caller
        holds the write side of the statement gate. ``tables`` limits
        the publish to those tables' queues."""
        with self._lane_lock:
            if tables is None:
                pending, self._lane_pending = self._lane_pending, {}
            else:
                pending = {t: self._lane_pending.pop(t)
                           for t in list(tables) if t in self._lane_pending}
        for table, entries in pending.items():
            entries.sort(key=lambda e: e[1])
            batches: list = []
            for op, tsi in entries:
                sop = (op[0], op[1], op[2]) if op[0] == "put" \
                    else ("del", op[1])
                if batches and batches[-1][1] == tsi:
                    batches[-1][0].append(sop)
                else:
                    batches.append(([sop], tsi))
            self.store.apply_committed_batch(table, batches)
            self._evict_device(table)
            self._lane_flushes.inc()
            self._lane_published.inc(len(entries))
            m = self._lane_mirrors.get(table)
            if m is not None:
                m.synced_gen = self.store.table(table).generation

    def _lane_fed(self, tname: str) -> bool:
        """A changefeed tails ``tname``: its feed is registered, or its
        job's thread lives. The feed takes its events from the publish
        path, which a deferred lane publish would starve, so the table's
        writes go the full path (dead threads gate nothing). Counted in
        exec.oltp.lane.cdc_declines."""
        if any(f.table == tname for f in self.cdc_feeds) or any(
                th.is_alive() and tb == tname
                for th, tb in list(self._cdc_threads.values())):
            self._lane_cdc_declines.inc()
            return True
        return False

    def _lane_feeds_changed(self) -> None:
        """A feed registered or closed (under the gate's write side): the
        shapes classified meanwhile are classified again."""
        self._lane_shapes.clear()

    def _lane_reset(self) -> None:
        """DDL (under the exclusive gate): every lane plan and mirror
        goes (eligibility may have flipped; a re-created table needs a
        new mirror), and plans classified before it go stale."""
        self._lane_epoch += 1
        self._lane_shapes.clear()
        self._lane_mirrors.clear()

    # statements that read and write no table: they neither flush nor
    # suspend the lane (COMMIT publishes a txn's effects, so it stays
    # global)
    _TABLELESS = (ast.SetVar, ast.BeginTxn, ast.RollbackTxn,
                  ast.CreateSequence, ast.DropSequence, ast.ShowSequences,
                  ast.ShowStatements, ast.ShowVar, ast.ShowAll,
                  ast.ShowTrace, ast.ShowJobs, ast.CancelJob)

    def _stmt_tables(self, stmt):
        """Base tables ``stmt`` can read or write, or None when they
        cannot be enumerated (DDL, COMMIT, views): None suspends the
        lane on every table."""
        if isinstance(stmt, self._TABLELESS):
            return set()
        if not isinstance(stmt, (ast.Select, ast.SetOp, ast.Insert,
                                 ast.Update, ast.Delete)):
            return None
        names: set = set()
        tbl = getattr(stmt, "table", None)
        if isinstance(tbl, str):
            names.add(tbl)
        try:
            collect_tables(stmt, names)
        except RecursionError:
            return None
        if names & self._view_map().keys():
            return None
        return names
