"""Join-induced page skipping: semi-join filters derived from a
hash-join build side (cockroach_tpu/exec/joinfilter.py).

Zone maps (exec/stream.py) skip streamed pages against the scan's own
pushed-down conjuncts; this module derives skipping from the query.
At dispatch the build side's visible, predicate-passing key set is
summarized on the host (min/max plus the exact sorted keys, or a
blocked bloom past KEY_CAP keys) and fed to the probe side's
PageSource as one more ZonePred. A probe page whose chunks cannot hold
a build key is never assembled or uploaded.

  ``find_specs``  at prepare: inner/semi hash joins over the paged
                  probe alias whose build side is a plain Scan chain,
                  keyed on raw int-family stored columns on both sides
                  (dictionary codes are per table, so they are out).
  ``derive``      at dispatch (the keys depend on the data and the
                  read timestamp): host-evaluate the build chain's
                  supported conjuncts over its chunks, keep the
                  versions visible at read_ts, and summarize the keys.
                  Unsupported conjuncts are dropped, never guessed, so
                  the summary stays a superset of the true key set.

Inner/semi only: a LEFT probe row without a match still emits, and an
ANTI row emits exactly when unmatched.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..sql import bound as B
from ..sql import plan as P
from ..storage.chunkstats import BlockedBloom
from .scanplane import scan_maps
from .stream import ZonePred, _find_chain, _split_and

# exact-keys cap: past this many distinct build keys the filter carries
# a bloom instead (never false-negative, ~2% false positives)
KEY_CAP = 1 << 16
# wire frames (distsql FlowSpec.joinfilter) carry exact keys up to this
# many; past it the frame carries a bloom (the remote side needs only
# the never-false-negative property)
WIRE_KEY_CAP = 4096
# derivation declines build sides past this row count (the reference's
# auto rule): the host key sweep is O(build rows) per dispatch
AUTO_BUILD_CAP = 1 << 22
# bloom-only membership probes enumerate a chunk's key range when it is
# at most this wide
RANGE_PROBE_CAP = 1 << 16


@dataclass(frozen=True)
class JoinFilterSpec:
    """One derivable semi-join filter, found at prepare; the keys are
    summarized per dispatch."""
    probe_table: str
    probe_col: str          # stored key column, probe table
    build_table: str
    build_col: str          # stored key column, build table
    build_conjuncts: tuple  # bound exprs restricting the build scan
    build_colmap: tuple     # ((batch name, stored name), ...)


class JoinFilter:
    """A derived build-side key summary, checkable at three grains:
    page zones (``zone_check``), chunk key sets (``chunk_ok``) and rows
    (``rows_ok``). False is always definite."""

    __slots__ = ("table", "col", "empty", "lo", "hi", "keys", "bloom")

    def __init__(self, table, col, empty=False, lo=0, hi=0,
                 keys=None, bloom=None):
        self.table = table
        self.col = col
        self.empty = empty
        self.lo = lo
        self.hi = hi
        self.keys = keys     # sorted int64 array, or None
        self.bloom = bloom   # BlockedBloom over the keys, or None

    def zone_check(self, lo, hi, nulls, nvalid) -> bool:
        if nvalid == 0:
            return False  # NULL probe keys never match inner/semi
        if self.empty:
            return False
        if lo is None:
            return True
        return not (hi < self.lo or lo > self.hi)

    def chunk_ok(self, chunk, col) -> bool:
        """May any key of ``chunk`` match? Consults the chunk's
        seal-time zone and blocked bloom."""
        if self.empty:
            return False
        zlo, zhi, _zn, zv = chunk.zone(col)
        if zv == 0:
            return False
        if zlo is None:
            return True
        if zhi < self.lo or zlo > self.hi:
            return False
        if self.keys is not None:
            a = int(np.searchsorted(self.keys, zlo, side="left"))
            b = int(np.searchsorted(self.keys, zhi, side="right"))
            ks = self.keys[a:b]
            if len(ks) == 0:
                return False
            bl = chunk.key_bloom(col)
            if bl is not None:
                return bl.might_contain_any(ks)
            return True
        if self.bloom is not None and zhi - zlo < RANGE_PROBE_CAP:
            cand = np.arange(zlo, zhi + 1, dtype=np.int64)
            return self.bloom.might_contain_any(cand)
        return True

    def rows_ok(self, vals: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """Keep mask over stored key values: False rows can never match
        the build side (NULL, out of range, or absent from the keys)."""
        n = len(vals)
        if self.empty:
            return np.zeros(n, dtype=bool)
        v64 = vals.astype(np.int64, copy=False)
        keep = valid & (v64 >= self.lo) & (v64 <= self.hi)
        if self.keys is not None:
            idx = np.searchsorted(self.keys, v64)
            hit = self.keys[np.minimum(idx, len(self.keys) - 1)] == v64
            keep &= hit
        elif self.bloom is not None:
            keep &= self.bloom.might_contain(v64)
        return keep

    def to_wire(self) -> dict:
        """The compact frame of FlowSpec.joinfilter: exact keys up to
        WIRE_KEY_CAP, a bloom above (built here from exact keys: the
        remote side needs only the never-false-negative property)."""
        keys = bloom = None
        if self.keys is not None and len(self.keys) <= WIRE_KEY_CAP:
            keys = self.keys.astype(np.int64).tobytes()
        elif self.keys is not None:
            bl = BlockedBloom(len(self.keys))
            bl.add(self.keys)
            bloom = bl.tobytes()
        elif self.bloom is not None:
            bloom = self.bloom.tobytes()
        return {"table": self.table, "col": self.col, "empty": self.empty,
                "lo": int(self.lo), "hi": int(self.hi), "keys": keys,
                "bloom": bloom}

    @classmethod
    def from_wire(cls, d: dict) -> "JoinFilter":
        keys = (np.frombuffer(d["keys"], dtype=np.int64).copy()
                if d.get("keys") is not None else None)
        bloom = (BlockedBloom.from_bytes(d["bloom"])
                 if d.get("bloom") is not None else None)
        return cls(d["table"], d["col"], empty=d["empty"], lo=d["lo"],
                   hi=d["hi"], keys=keys, bloom=bloom)


def zone_pred(f: JoinFilter) -> ZonePred:
    """A derived filter as a probe-side zone predicate; the filter is
    also the chunk-grain ``member`` refinement."""
    return ZonePred(f.col, f.zone_check, member=f, joinfilter=True)


# ---------------------------------------------------------------------------
# prepare-time detection
# ---------------------------------------------------------------------------

def _build_chain(node):
    """(scan, conjuncts) of a build side that is a Scan under only
    Filter/Compact nodes, or None. The conjuncts restrict which build
    rows exist — they must be applied before summarizing keys (the
    selectivity is the whole point: q3's build is orders filtered to
    one date sliver)."""
    conj: list = []
    n = node
    while True:
        if isinstance(n, P.Scan):
            if n.filter is not None:
                _split_and(n.filter, conj)
            return n, conj
        if isinstance(n, P.Filter):
            if n.pred is not None:
                _split_and(n.pred, conj)
            n = n.child
            continue
        if isinstance(n, P.Compact):
            n = n.child
            continue
        return None


def _plain_int_key(store, tname: str, col: str) -> bool:
    """Raw int-family stored column, at least 16-bit wide and NOT
    dict-coded: the widths chunkstats builds blooms for, and the only
    columns whose stored values compare identically across tables
    (dict codes are per-table — filtering probe codes against build
    codes would drop matching rows)."""
    try:
        td = store.table(tname)
    except KeyError:
        return False
    if col in getattr(td, "dictionaries", {}):
        return False
    by_name = {c.name: c for c in td.schema.columns}
    c = by_name.get(col)
    if c is None:
        return False
    dt = np.dtype(c.type.np_dtype)
    return dt.kind in "iu" and dt.itemsize >= 2


def find_specs(node: P.PlanNode, probe_alias: str, store) -> tuple:
    """Derivable JoinFilterSpecs for the streamed/spilled probe
    alias: inner/semi hash joins whose probe side contains the alias
    and whose build side is a plain Scan chain, keyed on raw
    int-family stored columns on both sides."""
    chain = _find_chain(node, probe_alias)
    if chain is None:
        return ()
    probe_scan = chain[0]
    specs = []
    stack = [node]
    while stack:
        n = stack.pop()
        if (isinstance(n, P.HashJoin)
                and n.join_type in ("inner", "semi")
                and probe_alias in scan_maps(n.left)[0]):
            bc = _build_chain(n.right)
            if bc is not None:
                bscan, conj = bc
                for lk, rk in zip(n.left_keys, n.right_keys):
                    pc = probe_scan.columns.get(lk)
                    bk = bscan.columns.get(rk)
                    if pc is None or bk is None:
                        continue  # computed/remapped key
                    if not (_plain_int_key(store, probe_scan.table, pc)
                            and _plain_int_key(store, bscan.table, bk)):
                        continue
                    specs.append(JoinFilterSpec(
                        probe_table=probe_scan.table, probe_col=pc,
                        build_table=bscan.table, build_col=bk,
                        build_conjuncts=tuple(conj),
                        build_colmap=tuple(sorted(
                            bscan.columns.items()))))
        for attr in ("child", "left", "right"):
            c = getattr(n, attr, None)
            if c is not None:
                stack.append(c)
    return tuple(specs)


# ---------------------------------------------------------------------------
# dispatch-time derivation
# ---------------------------------------------------------------------------

def _eval_conjunct(e, colmap: dict, data: dict, valid: dict):
    """Host-evaluate one build conjunct over a chunk's stored columns;
    None for unsupported shapes (the conjunct is dropped — the key
    summary stays a superset). Mirrors the shapes
    stream._compile_conjunct judges, evaluated exactly instead of
    against zones."""
    def col_of(x):
        if isinstance(x, B.BCol):
            sc = colmap.get(x.name)
            if sc is not None and sc in data:
                return sc
        return None

    if isinstance(e, B.BConst):
        n = len(next(iter(data.values()))) if data else 0
        return np.full(n, bool(e.value), dtype=bool)
    if isinstance(e, B.BBin) and e.op == "and":
        l = _eval_conjunct(e.left, colmap, data, valid)
        r = _eval_conjunct(e.right, colmap, data, valid)
        if l is None:
            return r
        if r is None:
            return l
        return l & r
    if isinstance(e, B.BBin) and e.op == "or":
        l = _eval_conjunct(e.left, colmap, data, valid)
        r = _eval_conjunct(e.right, colmap, data, valid)
        if l is None or r is None:
            return None  # an OR arm we cannot judge admits anything
        return l | r
    if isinstance(e, B.BBin) and e.op in ("<", "<=", ">", ">=",
                                          "=", "!="):
        lc, rc = col_of(e.left), col_of(e.right)
        if lc is not None and isinstance(e.right, B.BConst):
            c, v = lc, e.right.value
            op = e.op
        elif rc is not None and isinstance(e.left, B.BConst):
            c, v = rc, e.left.value
            op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(
                e.op, e.op)
        else:
            return None
        if v is None:
            return np.zeros(len(data[c]), dtype=bool)
        d, ok = data[c], valid[c]
        if d.dtype.kind not in "biuf":
            return None
        with np.errstate(invalid="ignore"):
            if op == "<":
                m = d < v
            elif op == "<=":
                m = d <= v
            elif op == ">":
                m = d > v
            elif op == ">=":
                m = d >= v
            elif op == "=":
                m = d == v
            else:
                m = d != v
        return ok & m
    if isinstance(e, B.BBetween) and not e.negated:
        c = col_of(e.expr)
        if (c is not None and isinstance(e.lo, B.BConst)
                and isinstance(e.hi, B.BConst)
                and e.lo.value is not None and e.hi.value is not None
                and data[c].dtype.kind in "biuf"):
            d = data[c]
            with np.errstate(invalid="ignore"):
                return valid[c] & (d >= e.lo.value) & (d <= e.hi.value)
        return None
    if isinstance(e, B.BInList) and not e.negated:
        c = col_of(e.expr)
        vals = [v for v in e.values if v is not None]
        if c is not None and vals and data[c].dtype.kind in "biu":
            return valid[c] & np.isin(data[c], np.asarray(vals))
        return None
    if isinstance(e, B.BIsNull):
        c = col_of(e.expr)
        if c is not None:
            return valid[c] if e.negated else ~valid[c]
        return None
    if isinstance(e, B.BDictLookup):
        c = col_of(e.expr)
        if c is not None and e.table is not None:
            tab = np.asarray(e.table)
            codes = data[c]
            if codes.dtype.kind not in "iu":
                return None
            cc = np.clip(codes, 0, len(tab) - 1)
            in_rng = (codes >= 0) & (codes < len(tab))
            return valid[c] & in_rng & tab[cc]
        return None
    return None


def derive(engine, spec: JoinFilterSpec, read_ts: int):
    """Summarize the build side's visible, predicate-passing keys at
    this dispatch's read timestamp. Returns a JoinFilter, or None
    when derivation is declined (a build past AUTO_BUILD_CAP rows, a
    missing table). Counts exec.skip.joinfilter.filters per
    derivation."""
    try:
        td = engine.store.table(spec.build_table)
    except KeyError:
        return None
    if td.row_count > AUTO_BUILD_CAP:
        return None
    colmap = dict(spec.build_colmap)
    parts = []
    for c in td.chunks:
        if spec.build_col not in c.data:
            return None
        live = (c.mvcc_ts <= read_ts) & (c.mvcc_del > read_ts)
        mask = live & c.valid[spec.build_col]
        for e in spec.build_conjuncts:
            m = _eval_conjunct(e, colmap, c.data, c.valid)
            if m is not None:
                mask &= m
        if mask.any():
            parts.append(c.data[spec.build_col][mask])
    engine.metrics.counter(
        "exec.skip.joinfilter.filters",
        "semi-join filters derived from hash-join build sides").inc()
    if not parts:
        return JoinFilter(spec.probe_table, spec.probe_col, empty=True)
    from ..ops.join import summarize_build_keys
    lo, hi, keys, bloom = summarize_build_keys(
        np.concatenate(parts), KEY_CAP)
    return JoinFilter(spec.probe_table, spec.probe_col,
                      lo=lo, hi=hi, keys=keys, bloom=bloom)
