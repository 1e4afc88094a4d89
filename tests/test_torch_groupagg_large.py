"""The PyTorch port's large-G group aggregation against the JAX kernel.

The same seeded numpy inputs go through the reference Pallas kernel
(cockroach_tpu/ops/pallas/groupagg_large.py, interpret mode on the CPU,
as tests/test_pallas_large_g.py runs it) and through the port's wrapper
(cockroach_tpu_torch/ops/cuda/groupagg_large.py) on CPU tensors, which
takes the plain PyTorch version. i32 rows (limb sums, counts, REPMIN)
and MIN/MAX rows must be equal; f32 sum rows agree within rtol 1e-5
(the two accumulate in different orders; the inputs are non-negative,
so no cancellation amplifies that). Grids stay within 64 steps.

The reference's Pallas modules import ``jax.experimental.enable_x64``,
which newer jax releases expose as ``jax.enable_x64``;
``reference_modules`` below aliases it while these tests run and
unloads what it let load afterwards, so other test files see jax and
the reference package unchanged.
"""

import contextlib
import importlib
import sys

import numpy as np
import pytest
import torch

from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl


@contextlib.contextmanager
def reference_modules(*names):
    """Import reference modules that need ``jax.experimental.enable_x64``
    (moved to ``jax.enable_x64`` in newer jax). Where the alias is
    missing it is added for the duration, and the Pallas modules it let
    load are unloaded afterwards, so other test files see jax and the
    reference package exactly as they would without these tests."""
    import jax
    import jax.experimental as jexp
    added = not hasattr(jexp, "enable_x64")
    if added:
        jexp.enable_x64 = jax.enable_x64
    before = set(sys.modules)
    try:
        yield tuple(importlib.import_module(n) for n in names)
    finally:
        if added:
            del jexp.enable_x64
            for name in sorted(set(sys.modules) - before, reverse=True):
                if not name.startswith(_PALLAS):
                    continue
                mod = sys.modules.pop(name)
                parent, _, leaf = name.rpartition(".")
                pmod = sys.modules.get(parent)
                if pmod is not None and getattr(pmod, leaf, None) is mod:
                    delattr(pmod, leaf)


_PALLAS = "cockroach_tpu.ops.pallas"

jpg = jgl = None  # the reference modules, bound by the fixture below


@pytest.fixture(scope="module", autouse=True)
def _reference_kernels():
    global jpg, jgl
    with reference_modules("cockroach_tpu.ops.pallas.groupagg",
                           "cockroach_tpu.ops.pallas.groupagg_large") as (
            jpg, jgl):
        yield
    jpg = jgl = None


GROUP_TILE = 128
BLOCK_ROWS = 256
_OPS = {"min": (2, tgl.MIN), "max": (3, tgl.MAX)}  # reference MIN, MAX


def _limb_cols(vals: np.ndarray, mask: np.ndarray, w: int):
    """w-bit limbs of int64 bit patterns (logical shifts), pre-masked."""
    u = vals.view(np.uint64)
    return [np.where(mask, (u >> np.uint64(j * w))
                     & np.uint64((1 << w) - 1), 0).astype(np.float32)
            for j in range(-(-64 // w))]


def _inputs(n, G, layout, mm_ops, seed, gid_lo=0, gid_hi=None,
            sel_frac=0.8):
    rng = np.random.default_rng(seed)
    gid = rng.integers(gid_lo, G if gid_hi is None else gid_hi,
                       size=n).astype(np.int32)
    sel = rng.random(n) < sel_frac
    eff = sel & (rng.random(n) < 0.9)
    vals = rng.integers(-(1 << 40), 1 << 40, size=n, dtype=np.int64)
    f_cols, i_cols = [], []
    if layout in ("f_and_i", "f_only"):
        for _ in range(2):
            f_cols.append(np.where(eff, rng.random(n) * 1000.0,
                                   0.0).astype(np.float32))
    if layout in ("f_and_i", "i_only"):
        w = jgl.limb_width(n, max_group_rows=n, block_rows=BLOCK_ROWS)
        i_cols += _limb_cols(vals, eff, w)
        i_cols.append(eff.astype(np.float32))
    mat = tuple(f_cols) + tuple(i_cols)
    mat_int = (False,) * len(f_cols) + (True,) * len(i_cols)
    small = rng.integers(-(1 << 20), 1 << 20, size=n).astype(np.float32)
    mm = tuple(np.where(eff, small, np.inf if op == "min" else -np.inf)
               .astype(np.float32) for op in mm_ops)
    return gid, sel, mat, mat_int, mm


def _run_both(gid, sel, mat, mat_int, mm, mm_ops, G, want_rep):
    jf, ji = jgl.large_group_aggregate(
        gid, sel, mat, mm, G, mat_int,
        mm_ops=tuple(_OPS[o][0] for o in mm_ops), want_rep=want_rep,
        group_tile=GROUP_TILE, block_rows=BLOCK_ROWS, interpret=True)
    before = tgl.PLAIN_CALLS
    tf, ti = tgl.large_group_aggregate(
        torch.from_numpy(gid), torch.from_numpy(sel),
        tuple(torch.from_numpy(c) for c in mat),
        tuple(torch.from_numpy(c) for c in mm), G, mat_int,
        mm_ops=tuple(_OPS[o][1] for o in mm_ops), want_rep=want_rep)
    assert tgl.PLAIN_CALLS == before + 1
    assert tf.dtype == torch.float32 and ti.dtype == torch.int32
    return np.asarray(jf), np.asarray(ji), tf.numpy(), ti.numpy()


def _check(jf, ji, tf, ti, n_f):
    assert tf.shape == jf.shape and ti.shape == ji.shape
    np.testing.assert_array_equal(ti, ji)               # i32: exact
    np.testing.assert_array_equal(tf[n_f:], jf[n_f:])   # MIN/MAX: exact
    np.testing.assert_allclose(tf[:n_f], jf[:n_f], rtol=1e-5)


SHAPES = [(1024, 40), (2048, 300), (4096, 500)]
MM_REP = [((), False), (("min",), True), (("min", "max"), True)]


@pytest.mark.parametrize("n,G", SHAPES)
@pytest.mark.parametrize("layout", ["f_and_i", "i_only", "f_only"])
@pytest.mark.parametrize("mm_ops,want_rep", MM_REP)
def test_matches_jax_kernel(n, G, layout, mm_ops, want_rep):
    seed = n + G + len(layout) + 7 * len(mm_ops)
    gid, sel, mat, mat_int, mm = _inputs(n, G, layout, mm_ops, seed)
    jf, ji, tf, ti = _run_both(gid, sel, mat, mat_int, mm, mm_ops, G,
                               want_rep)
    _check(jf, ji, tf, ti, sum(not b for b in mat_int))


def test_all_rows_masked():
    # every accumulator keeps its identity: 0, +/-inf, n for REPMIN
    n, G = 1024, 200
    gid, _, _, _, _ = _inputs(n, G, "i_only", (), 9)
    sel = np.zeros(n, bool)
    zero = np.zeros(n, np.float32)
    mm = (np.full(n, np.inf, np.float32), np.full(n, -np.inf, np.float32))
    jf, ji, tf, ti = _run_both(gid, sel, (zero, zero), (False, True), mm,
                               ("min", "max"), G, True)
    _check(jf, ji, tf, ti, 1)
    assert np.all(ti[1] == n) and np.all(tf[1] == np.inf)


def test_out_of_range_gids_contribute_nothing():
    # ids below 0 and at or above G (inside and past the reference's
    # padded group tile) match no group
    n, G = 2048, 150
    gid, sel, mat, mat_int, mm = _inputs(n, G, "f_and_i", ("max",), 11,
                                         gid_lo=-40, gid_hi=G + 200)
    jf, ji, tf, ti = _run_both(gid, sel, mat, mat_int, mm, ("max",), G,
                               True)
    _check(jf, ji, tf, ti, 2)
    ok = (gid >= 0) & (gid < G)
    want_cnt = np.bincount(gid[ok], weights=mat[-1][ok], minlength=G)
    np.testing.assert_array_equal(ti[-2], want_cnt.astype(np.int32))


@pytest.mark.parametrize("n", [128, 384, 1024, 4096, 65536, 1 << 23])
@pytest.mark.parametrize("block_rows", [256, 1024])
def test_row_block_and_limb_width_match_reference(n, block_rows):
    assert tgl.row_block(n, block_rows) == jgl.row_block(n, block_rows)
    for maxg in (0, 1, 7, 1000, n // 3, n, n + 1):
        for cap in (22, 9):
            assert tgl.limb_width(n, maxg, block_rows, cap) == \
                jgl.limb_width(n, maxg, block_rows, cap)


def test_nan_in_minmax_propagates():
    # a NaN among a group's MIN/MAX values makes that group's result NaN
    # (jnp.min / jnp.max), and only that group's
    n, G = 2048, 40
    gid, sel, mat, mat_int, mm = _inputs(n, G, "i_only", ("min", "max"), 13)
    hit = np.isin(gid, (3, 17)) & np.isfinite(mm[0])
    mm = tuple(np.where(hit & (np.arange(n) % 5 == 0), np.nan, c)
               .astype(np.float32) for c in mm)
    jf, ji, tf, ti = _run_both(gid, sel, mat, mat_int, mm, ("min", "max"),
                               G, False)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tf[1:], jf[1:])  # NaN where NaN
    assert set(np.flatnonzero(np.isnan(tf[1]))) == {3, 17}


# -- the slot interface: int64 values in, limbs cut by the kernel ----------
#
# The same seeded numpy inputs go through the JAX kernel, fed the columns
# the reference's plan compiler cuts in jnp (cockroach_tpu/exec/
# compile.py: limb, shadow and count columns as at :751-773, MIN/MAX
# high-limb columns as at :729-743), and through the port's slot
# interface, which takes the int64 values themselves. i32 rows (limbs,
# counts, REPMIN) and MIN/MAX rows must be equal, max-|value| exact.
# f32 rows: within 1e-5 of the group's sum of |f32(value)| (rtol 1e-5
# where the values are non-negative; the kernels add in different
# orders, and f32 sums of mixed signs lose digits in both).

INT64_MIN, INT64_MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max


def _ref_cut(gid, sel, slots, w):
    """The reference's pre-built columns for `slots` (tuples of numpy
    arrays), cut in jnp as its plan compiler cuts them. Returns the
    kernel's (mat, mat_int, mm, mm_ops) and per slot where its rows
    land: ("i", first, k) and ("f", shadow) for i64sum, ("i", row) for
    count, ("f", row) for f32sum, ("mm", row) for minmax."""
    import jax
    import jax.numpy as jnp
    f_cols, i_cols, mm_cols, mm_ops, where = [], [], [], [], []
    for kind, value, mask, k, op in slots:
        m = jnp.asarray(sel) if mask is None else \
            jnp.logical_and(jnp.asarray(sel), jnp.asarray(mask))
        if kind == "count":
            where.append((("i", len(i_cols)),))
            i_cols.append(m.astype(jnp.float32))
        elif kind == "i64sum":
            d64 = jnp.asarray(value).astype(jnp.int64)
            dz = jnp.where(m, d64, jnp.zeros_like(d64))
            lmask = jnp.int64((1 << w) - 1)
            where.append((("i", len(i_cols), k), ("f", len(f_cols))))
            for jl in range(k):
                limb = jax.lax.shift_right_logical(
                    dz, jnp.int64(jl * w)) & lmask
                i_cols.append(limb.astype(jnp.int32).astype(jnp.float32))
            f_cols.append(jnp.where(m, d64, 0).astype(jnp.float32))
        elif kind == "f32sum":
            where.append((("f", len(f_cols)),))
            f_cols.append(jnp.where(m, jnp.asarray(value), 0)
                          .astype(jnp.float32))
        else:
            d0 = jnp.asarray(value)
            ident = np.float32(np.inf if op == "min" else -np.inf)
            if jnp.issubdtype(d0.dtype, jnp.integer):
                hi = jnp.right_shift(d0.astype(jnp.int64),
                                     jnp.int64(tgl.MM_HI_SHIFT))
                mm_cols.append(jnp.where(m, hi.astype(jnp.float32), ident))
            else:
                mm_cols.append(jnp.where(m, d0.astype(jnp.float32), ident))
            where.append((("mm", len(mm_ops)),))
            mm_ops.append(op)
    n_f = len(f_cols)
    where = [tuple((t, r + n_f) if t == "mm" else (t, r, *rest)
                   for t, r, *rest in ws) for ws in where]
    mat = tuple(np.asarray(c) for c in f_cols + i_cols)
    mat_int = (False,) * n_f + (True,) * len(i_cols)
    return mat, mat_int, tuple(np.asarray(c) for c in mm_cols), \
        tuple(mm_ops), where


def _slot_inputs(n, G, w, seed, extremes, gid_lo=0, gid_hi=None):
    """Seeded inputs and a slot list as a query with duplicate
    arguments hands them over: sum and avg of the same values (limb
    counts k and ceil(64 / w)), a sum whose non-negative values bound
    k below ceil(64 / w), an int32 column, counts over NULL masks and
    over sel, INT/DECIMAL and FLOAT MIN/MAX (NaN and -0.0 among the
    floats), a FLOAT sum."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(gid_lo, G if gid_hi is None else gid_hi,
                       size=n).astype(np.int32)
    sel = rng.random(n) < 0.8
    m1, m2, mf = (rng.random(n) < 0.9 for _ in range(3))
    v1 = rng.integers(-(1 << 50), 1 << 50, size=n, dtype=np.int64)
    if extremes:
        pick = rng.choice(n, size=n // 8, replace=False)
        v1[pick] = rng.choice(np.array([INT64_MIN, INT64_MAX, -1,
                                        INT64_MIN + 1], np.int64),
                              size=pick.size)
    v2 = rng.integers(0, 1 << 18, size=n, dtype=np.int64)
    v3 = rng.integers(-(1 << 31), (1 << 31) - 1, size=n).astype(np.int32)
    f = rng.normal(size=n) * 100
    f[rng.random(n) < 0.03] = -0.0
    f[np.isin(gid, (3, 11)) & (rng.random(n) < 0.02)] = np.nan
    fpos = rng.random(n) * 1000
    full = -(-64 // w)
    kcap = -(-18 // w)
    slots = (("count", None, None, 0, ""),          # count(*)
             ("count", None, m1, 0, ""),            # sum(v1) validity
             ("i64sum", v1, m1, full, ""),          # sum(v1)
             ("count", None, m1, 0, ""),            # avg(v1) validity
             ("i64sum", v1, m1, full, ""),          # avg(v1)
             ("i64sum", v2, m2, kcap, ""),          # sum(v2), v2 < 2^18
             ("count", None, m2, 0, ""),
             ("i64sum", v2, m2, full, ""),          # avg(v2)
             ("i64sum", v3, None, full, ""),        # sum of int32
             ("mm", v1, m1, 0, "min"), ("mm", v1, m1, 0, "max"),
             ("mm", f, mf, 0, "min"), ("mm", f, mf, 0, "max"),
             ("f32sum", fpos, mf, 0, ""),
             ("count", None, None, 0, ""))          # liveness
    return gid, sel, slots


def _torch_slots(slots):
    """The port's slots over torch views of the same numpy arrays (one
    tensor per array, so duplicates share storage)."""
    t = {}

    def tt(a):
        if a is None:
            return None
        if id(a) not in t:
            t[id(a)] = torch.from_numpy(a)
        return t[id(a)]

    out = []
    for kind, value, mask, k, op in slots:
        if kind == "count":
            out.append(tgl.count(tt(mask)))
        elif kind == "i64sum":
            out.append(tgl.i64sum(tt(value), tt(mask), W_OF[0], k))
        elif kind == "f32sum":
            out.append(tgl.f32sum(tt(value), tt(mask)))
        else:
            out.append(tgl.minmax(tt(value), tt(mask), op))
    return tuple(out)


W_OF = [0]  # the limb width of the case being run


SLOT_CASES = [
    # (n, G, w, extremes, gid_lo, gid_hi)
    (1024, 40, 14, False, 0, None),
    (2048, 300, 9, True, 0, None),
    (1024, 64, 5, True, -40, 120),
    (2048, 150, 17, False, -40, 350),
]


@pytest.mark.parametrize("n,G,w,extremes,gid_lo,gid_hi", SLOT_CASES)
@pytest.mark.parametrize("want_rep", [False, True])
def test_slots_match_jax_kernel(n, G, w, extremes, gid_lo, gid_hi,
                                want_rep):
    gid, sel, slots = _slot_inputs(n, G, w, n + G + w, extremes, gid_lo,
                                   gid_hi)
    mat, mat_int, mm, mm_ops, where = _ref_cut(gid, sel, slots, w)
    jf, ji = jgl.large_group_aggregate(
        gid, sel, mat, mm, G, mat_int,
        mm_ops=tuple(_OPS[o][0] for o in mm_ops), want_rep=want_rep,
        group_tile=GROUP_TILE, block_rows=BLOCK_ROWS, interpret=True)
    jf, ji = np.asarray(jf), np.asarray(ji)
    W_OF[0] = w
    before = tgl.PLAIN_CALLS
    res = tgl.aggregate_slots(torch.from_numpy(gid), torch.from_numpy(sel),
                              _torch_slots(slots), G, want_rep)
    assert tgl.PLAIN_CALLS == before + 1
    tf, ti, mx = res.acc_f.numpy(), res.acc_i.numpy(), res.maxabs.numpy()
    assert tf.dtype == np.float32 and ti.dtype == np.int32
    # duplicates folded: sum and avg of v1 share rows, the three sel
    # counts one row
    assert res.rows[2] == res.rows[4] and res.rows[1] == res.rows[3]
    assert res.rows[0] == res.rows[-1]
    ok = (gid >= 0) & (gid < G)
    for (kind, value, mask, k, _), ws, got in zip(slots, where, res.rows):
        if kind == "count":
            np.testing.assert_array_equal(ti[got], ji[ws[0][1]])
        elif kind == "i64sum":
            (_, j0, _), (_, jfr) = ws
            r0, frow, mxi = got
            np.testing.assert_array_equal(ti[r0:r0 + k], ji[j0:j0 + k])
            m = sel if mask is None else sel & mask
            v = np.where(m, value.astype(np.int64), 0)
            mag = np.zeros(G)
            np.add.at(mag, gid[ok], np.abs(v[ok].astype(np.float32))
                      .astype(np.float64))
            assert np.all(np.abs(tf[frow].astype(np.float64) - jf[jfr])
                          <= 1e-5 * mag)
            # max |value| over the rows passing sel and the mask, all
            # gids: exact, and the old sentinel's float64 bound
            want = np.where(v < 0, -v, v).view(np.uint64).max()
            assert mx[mxi].view(np.uint64) == want
            assert float(want) == np.abs(v.astype(np.float64)).max()
        elif kind == "f32sum":
            np.testing.assert_allclose(tf[got], jf[ws[0][1]], rtol=1e-5)
        else:
            np.testing.assert_array_equal(tf[got], jf[ws[0][1]])
    if want_rep:
        np.testing.assert_array_equal(ti[res.rep_row], ji[len(mat) - sum(
            not b for b in mat_int)])
    if extremes:
        assert (mx.view(np.uint64) == np.uint64(1 << 63)).any()


def test_slots_plain_equals_wrapper_and_checks_caps():
    # aggregate_slots_plain is the same function; the argument struct's
    # caps raise
    gid, sel, slots = _slot_inputs(1024, 40, 9, 5, True)
    W_OF[0] = 9
    tslots = _torch_slots(slots)
    g, s = torch.from_numpy(gid), torch.from_numpy(sel)
    a = tgl.aggregate_slots(g, s, tslots, 40, True)
    b = tgl.aggregate_slots_plain(g, s, tslots, 40, True)
    for x, y in zip(a[:3], b[:3]):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)
    many = tuple(tgl.count(torch.rand(1024) < 0.5)
                 for _ in range(tgl.MAX_MASKS + 1))
    with pytest.raises(ValueError, match="masks"):
        tgl.aggregate_slots(g, s, many, 40)
    with pytest.raises(ValueError, match="limb layout"):
        tgl.aggregate_slots(g, s, (tgl.i64sum(torch.from_numpy(
            slots[2][1]), None, 9, 9),), 40)
    with pytest.raises(ValueError, match="int64 or int32"):
        tgl.aggregate_slots(g, s, (tgl.i64sum(torch.zeros(1024), None, 9,
                                              2),), 40)


def test_sum_avg_count_fold_into_one_value_slot():
    # sum(x), avg(x) and count(*) through the port's Engine: the kernel
    # reads x once (one int64 value column and one set of limb rows),
    # x's validity once (one count row for both), and count(*) and the
    # group liveness share sel's row
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.storage.transfer import store_from_arrays
    rng = np.random.default_rng(17)
    n = 300
    eng = Engine(device="cpu", store=store_from_arrays({"t": {
        "ddl": "CREATE TABLE t (g STRING, x INT)",
        "columns": {"g": rng.integers(0, 5, size=n).astype(np.int32),
                    "x": rng.integers(-99, 99, size=n)},
        "valid": {"x": rng.random(n) < 0.9},
        "mvcc_ts": np.ones(n, np.int64),
        "mvcc_del": np.full(n, INT64_MAX, np.int64),
        "dictionaries": {"g": [f"k{i}" for i in range(5)]}}}))
    on = eng.session()
    eng.execute("SET pallas_groupagg = on", on)
    calls = []
    kernel = tgl.aggregate_slots

    def recording(*args, **kw):
        calls.append((args, kw))
        return kernel(*args, **kw)

    tgl.aggregate_slots = recording
    try:
        rows = eng.execute("SELECT g, sum(x) AS s, avg(x) AS a, "
                           "count(*) AS c FROM t GROUP BY g "
                           "ORDER BY g", on).rows
    finally:
        tgl.aggregate_slots = kernel
    assert len(calls) == 1 and len(rows) == 5
    plan = tgl.plan_slots(*calls[0][0], **calls[0][1])
    kinds = [s[0] for s in plan.kslots]
    assert len(plan.cols) == 1 and plan.cols[0].dtype == torch.int64
    assert kinds.count(tgl._I64SUM) == 1
    # count rows: x's validity (sum, avg) and sel (count(*), liveness)
    assert kinds.count(tgl._COUNT) == 2 and len(plan.masks) == 1
    assert sorted(s[2] for s in plan.kslots if s[0] == tgl._COUNT) == \
        [tgl._SEL, 0]


def test_q1_reads_int64_slots_and_builds_no_limbs():
    # TPC-H Q1 on the port's Engine: one kernel call over int64 value
    # slots (the five distinct arguments, sum and avg folded), no call
    # of the pre-built-column interface, and no limb cut in PyTorch
    # outside the plain version the CPU stands in with
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops import agg as aggops
    eng = Engine(device="cpu")
    tpch.load(eng, sf=0.01, rows=20_000, encoded=True)
    calls, limbs, prebuilt = [], [0], [0]
    depth = [0]
    kernel, plain, cut, old = (tgl.aggregate_slots, tgl._plain, aggops.limb,
                               tgl.large_group_aggregate)

    def recording(*args, **kw):
        calls.append((args, kw))
        return kernel(*args, **kw)

    def in_plain(plan):
        depth[0] += 1
        try:
            return plain(plan)
        finally:
            depth[0] -= 1

    def counting_limb(*args):
        if not depth[0]:
            limbs[0] += 1
        return cut(*args)

    def counting_old(*args, **kw):
        prebuilt[0] += 1
        return old(*args, **kw)

    tgl.aggregate_slots, tgl._plain, aggops.limb = (recording, in_plain,
                                                    counting_limb)
    tgl.large_group_aggregate = counting_old
    try:
        before = tgl.PLAIN_CALLS
        rows = eng.execute(tpch.Q1).rows
    finally:
        tgl.aggregate_slots, tgl._plain, aggops.limb = kernel, plain, cut
        tgl.large_group_aggregate = old
    assert len(rows) == 4 and tgl.PLAIN_CALLS == before + 1
    assert len(calls) == 1 and limbs[0] == 0 and prebuilt[0] == 0
    args, kw = calls[0]
    n = args[0].shape[0]
    values = [s.value for s in args[2] if s.kind == "i64sum"]
    assert len(values) == 7 and all(v.dtype == torch.int64
                                    and v.shape == (n,) for v in values)
    plan = tgl.plan_slots(*args, **kw)
    assert len(plan.cols) == 5 and set(plan.col_types) == {0}
    assert [s[0] for s in plan.kslots].count(tgl._I64SUM) == 5
    # every count slot reads sel or one of the arguments' validity masks
    assert len(plan.masks) <= 5


@pytest.mark.parametrize("G,gid_lo,gid_hi", [(12, 0, None), (300, -40, 340)])
def test_compare_plain_holds_each_caller_slot(G, gid_lo, gid_hi):
    # the card's check (groupagg_large_check.compare_plain) on the CPU:
    # the wrapper's result passes, and a change to any one row that a
    # caller's slot reads is caught
    from cockroach_tpu_torch.ops.cuda.groupagg_large_check import (
        compare_plain, synthetic_slots)
    args = synthetic_slots(4096, G, 9, G, device="cpu", gid_lo=gid_lo,
                           gid_hi=gid_hi)
    good = tgl.aggregate_slots(*args)
    got = compare_plain(args, good)
    assert 0 < got["max_rel_err"] <= 1e-5 or got["max_abs_err"] == 0
    rows = good.rows
    limb0, shadow, mx = rows[2]
    bad_cases = [("i", rows[0]), ("i", limb0), ("i", good.rep_row),
                 ("f", shadow), ("f", rows[9]), ("f", rows[13]),
                 ("m", mx)]
    for part, r in bad_cases:
        acc_f, acc_i, maxabs = (good.acc_f.clone(), good.acc_i.clone(),
                                good.maxabs.clone())
        if part == "i":
            acc_i[r, 1] += 1
        elif part == "f":
            acc_f[r, 1] = acc_f[r, 1] * 1.01 + 1.0
        else:
            maxabs[r] -= 1
        with pytest.raises(AssertionError):
            compare_plain(args, tgl.SlotResult(acc_f, acc_i, maxabs, rows,
                                               good.rep_row))
