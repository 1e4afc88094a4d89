"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``gpu``: every test skips (from a fixture, at run time) when no
CUDA card is present. On a machine with one, run them without the
repository's conftest, which pins JAX to the CPU:

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

i32 rows (limb sums, counts, REPMIN) and MIN/MAX rows must be equal;
f32 sum rows agree within rtol 1e-5 (the kernel's atomics add in a
different order each run; the plain version sums in float64).
"""

import numpy as np
import pytest
import torch

from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
from cockroach_tpu_torch.ops.cuda.groupagg_large_check import (
    compare_plain, synthetic_slots)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(n, G, n_f, n_i, mm_ops, seed, device, gid_lo=0, gid_hi=None,
            sel_frac=0.8):
    g = torch.Generator(device="cpu").manual_seed(seed)
    hi = G if gid_hi is None else gid_hi
    gid = torch.randint(gid_lo, hi, (n,), generator=g, dtype=torch.int32)
    sel = torch.rand(n, generator=g) < sel_frac
    eff = sel & (torch.rand(n, generator=g) < 0.9)
    mat = [torch.where(eff, torch.rand(n, generator=g) * 1000, 0.0)
           for _ in range(n_f)]
    mat += [torch.where(eff, torch.randint(0, 1 << 10, (n,), generator=g),
                        0).to(torch.float32) for _ in range(n_i)]
    vals = torch.randint(-(1 << 20), 1 << 20, (n,), generator=g) \
        .to(torch.float32)
    mm = [torch.where(eff, vals, np.inf if op == tgl.MIN else -np.inf)
          for op in mm_ops]
    mat_int = (False,) * n_f + (True,) * n_i
    to = lambda t: t.to(device)  # noqa: E731
    return (to(gid), to(sel), tuple(map(to, mat)), tuple(map(to, mm)),
            mat_int)


def _check(gid, sel, mat, mm, G, mat_int, mm_ops, want_rep):
    before = tgl.LAUNCHES
    kf, ki = tgl.large_group_aggregate(gid, sel, mat, mm, G, mat_int,
                                       mm_ops, want_rep)
    torch.cuda.synchronize()
    assert tgl.LAUNCHES == before + 1
    pf, pi = tgl.large_group_aggregate_plain(gid, sel, mat, mm, G,
                                             mat_int, mm_ops, want_rep)
    kf, ki, pf, pi = (t.cpu().numpy() for t in (kf, ki, pf, pi))
    n_f = sum(not b for b in mat_int)
    np.testing.assert_array_equal(ki, pi)
    np.testing.assert_array_equal(kf[n_f:], pf[n_f:])  # NaN where NaN
    np.testing.assert_allclose(kf[:n_f], pf[:n_f], rtol=1e-5)


def test_minmax_nan_and_negative_zero(cuda):
    # -0.0 orders below +0.0 and above every negative value; a NaN makes
    # its group NaN (the plain version's and jnp's semantics)
    n, G = 1 << 16, 64
    gid, sel, mat, mm, mat_int = _inputs(n, G, 1, 1, (tgl.MIN, tgl.MAX), 21,
                                         cuda)
    r = torch.arange(n, device=cuda)
    mm = tuple(torch.where(r % 7 == 0, -0.0, torch.where(
        (gid == 9) & (r % 11 == 0), float("nan"), c)) for c in mm)
    _check(gid, sel, mat, mm, G, mat_int, (tgl.MIN, tgl.MAX), False)


CASES = [
    # (n, G, n_f, n_i, mm_ops, want_rep): shared-memory accumulators
    (1 << 16, 12, 7, 49, (), False),
    (1 << 16, 4096, 1, 3, (tgl.MIN, tgl.MAX), True),
    # global atomics (accumulators beyond 227 KB of shared memory)
    (1 << 16, 200_000, 1, 2, (tgl.MAX,), True),
    (4096, 3, 0, 1, (), True),
]


@pytest.mark.parametrize("n,G,n_f,n_i,mm_ops,want_rep", CASES)
def test_kernel_matches_plain(cuda, n, G, n_f, n_i, mm_ops, want_rep):
    gid, sel, mat, mm, mat_int = _inputs(n, G, n_f, n_i, mm_ops, n + G,
                                         cuda)
    _check(gid, sel, mat, mm, G, mat_int, mm_ops, want_rep)


@pytest.mark.parametrize("G", [100, 100_000])
def test_masked_and_out_of_range(cuda, G):
    n = 1 << 14
    gid, sel, mat, mm, mat_int = _inputs(
        n, G, 1, 2, (tgl.MIN,), 5, cuda, gid_lo=-50, gid_hi=G + 50,
        sel_frac=0.0)
    _check(gid, sel, mat, mm, G, mat_int, (tgl.MIN,), True)


# -- the slot interface: int64 values, limbs cut in the kernel --------------

def _check_slots(args, layout):
    """The kernel in `layout` against the plain version on the same
    tensors, per caller slot (groupagg_large_check.compare_plain: integer
    rows, max-|value| and MIN/MAX bit for bit, f32 sums within 1e-5 of
    the group's sum of |f32(value)|, since the values have both
    signs)."""
    plan = tgl.plan_slots(*args)
    if not tgl.fits(plan, layout):
        pytest.skip(f"{layout} does not fit G = {plan.num_groups}")
    before = tgl.LAUNCHES
    got = tgl.launch(plan, layout, tgl._lib())
    assert tgl.LAUNCHES == before + 1
    compare_plain(args, tgl.SlotResult(*got, plan.rows, plan.rep_row))


SLOT_CASES = [
    # (n, G, w): few groups (warp-aggregated adds), many groups in shared
    # memory, and G past shared memory (global atomics)
    (1 << 16, 12, 9),
    (1 << 16, 4, 14),
    (1 << 16, 1024, 17),
    (1 << 16, 200_000, 5),
]


@pytest.mark.parametrize("n,G,w", SLOT_CASES)
@pytest.mark.parametrize("layout", tgl.LAYOUTS)
def test_slots_match_plain(cuda, n, G, w, layout):
    _check_slots(synthetic_slots(n, G, w, n + G + w), layout)


@pytest.mark.parametrize("G", [100, 100_000])
def test_slots_masked_and_out_of_range(cuda, G):
    # through the wrapper, in the layout it chooses
    args = synthetic_slots(1 << 14, G, 9, 7, gid_lo=-50, gid_hi=G + 50,
                           sel_frac=0.0)
    before = tgl.LAUNCHES
    compare_plain(args, tgl.aggregate_slots(*args))
    assert tgl.LAUNCHES == before + 1


def test_engine_q1_q6_on_card_match_cpu(cuda):
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    rows = {}
    for dev in ("cpu", "cuda"):
        e = Engine(device=dev)
        tpch.load(e, sf=0.01, rows=50_000)
        rows[dev] = (e.execute(tpch.Q1).rows, e.execute(tpch.Q6).rows)
    for got, want in zip(rows["cuda"], rows["cpu"]):
        assert len(got) == len(want)
        for g_row, w_row in zip(got, want):
            for g, w in zip(g_row, w_row):
                assert g == pytest.approx(w, rel=1e-12)


# -- the small-G kernel (ops/cuda/groupagg.py) --------------------------------

ZERO_GROUP = 6   # _small_inputs: a group of -0.0 values


def _small_inputs(n, G, ops, seed, device, gid_lo=0, gid_hi=None,
                  sel_frac=0.8, nan_groups=(), f64=False, cols=None,
                  neg_zero=False, misalign=False, sel_mask=False):
    """Seeded inputs for the small-G kernel. cols: distinct value and
    mask columns, shared by the slots in turn (default one each per
    slot); neg_zero: zeros in 4% of the rows, -0.0 in even groups and
    +0.0 in odd ones, and -0.0 in every row of group ZERO_GROUP (a MIN
    or MAX that is a zero has one right sign); misalign: every column
    a view one element into its storage, so no pointer is aligned for
    the vector loads; sel_mask: every third slot's mask is sel itself."""
    rng = np.random.default_rng(seed)
    m = n + 1
    gid = rng.integers(gid_lo, G if gid_hi is None else gid_hi,
                       size=m).astype(np.int32)
    sel = rng.random(m) < sel_frac
    k = len(ops) if cols is None else cols
    off = 1 if misalign else 0

    def dev(a):
        return torch.from_numpy(a).to(device)[off:off + n]

    vals, masks = [], []
    for _ in range(k):
        # non-negative: no cancellation inflates the f32 sums' error
        v = (rng.random(m) * 100).astype(np.float64 if f64
                                         else np.float32)
        if neg_zero:
            zero = (rng.random(m) < 0.04) | (gid == ZERO_GROUP)
            v[zero] = np.where(gid[zero] % 2 == 0, -0.0, 0.0)
        v[np.isin(gid, nan_groups) & (rng.random(m) < 0.01)] = np.nan
        vals.append(dev(v))
        masks.append(dev(rng.random(m) < 0.9))
    sel_t = dev(sel)
    values = tuple(vals[a % k] for a in range(len(ops)))
    mask_of = tuple(sel_t if sel_mask and a % 3 == 0
                    else masks[(a + a // k) % k] for a in range(len(ops)))
    return dev(gid), sel_t, values, mask_of


def _check_small(gid, sel, vals, masks, G, ops):
    from cockroach_tpu_torch.ops.cuda import groupagg as tg
    before = tg.LAUNCHES
    ka, kc = tg.dense_group_aggregate(gid, sel, vals, masks, G, ops)
    torch.cuda.synchronize()
    assert tg.LAUNCHES == before + 1
    pa, pc = tg.dense_group_aggregate_plain(gid, sel, vals, masks, G, ops)
    ka, kc, pa, pc = (t.cpu().numpy() for t in (ka, kc, pa, pc))
    np.testing.assert_array_equal(kc, pc)
    for a, op in enumerate(ops):
        if op in (tg.MIN, tg.MAX, tg.COUNT):
            # NaN in the same cells, bit-equal elsewhere: -0.0 != +0.0
            nan = np.isnan(pa[:, a])
            np.testing.assert_array_equal(np.isnan(ka[:, a]), nan)
            np.testing.assert_array_equal(ka[~nan, a].view(np.int32),
                                          pa[~nan, a].view(np.int32))
        else:
            np.testing.assert_allclose(ka[:, a], pa[:, a], rtol=1e-5,
                                       atol=1e-2)


Q1F_OPS = (1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 0)
SMALL_CASES = [
    # (n, G, ops, f64, strategy, options)
    (1 << 16, 12, (0, 1, 0, 1, 0, 2, 3), True, "thread", {}),
    (1 << 16, 64, (0, 1, 2, 3), False, "thread", {}),
    (1 << 20, 1, (1, 0, 2, 3), True, "thread", {}),
    (128, 2, (0, 1), False, "thread", {}),
    # Q1F's slots: mixed-group warps, shared masks, sel as a mask
    (1 << 18, 12, Q1F_OPS, True, "thread", {"cols": 7, "sel_mask": True}),
    # per-block copies at G * A = 1024, NaN groups, -0.0 in MIN/MAX
    (1 << 16, 64, (0, 1, 2, 3) * 4, True, "cta",
     {"cols": 5, "nan_groups": (3, 40), "neg_zero": True}),
    # per-block copies (G * A = 19,200); 48 masks and 36 value columns,
    # past the kernel's first load batches and its 32 mask bits
    (1 << 14, 64, (0, 1, 2, 3) * 75, True, "cta",
     {"cols": 48, "nan_groups": (3,), "neg_zero": True}),
    # G = 1 with NaN and -0.0
    (1 << 16, 1, (1, 2, 3, 0), True, "thread",
     {"nan_groups": (0,), "neg_zero": True}),
    # misaligned float64 views: the scalar-load instantiation
    (1 << 16, 12, (0, 1, 2, 3), True, "thread",
     {"misalign": True, "nan_groups": (2,), "neg_zero": True}),
    (1 << 16, 64, (0, 1, 2, 3) * 4, True, "cta", {"misalign": True}),
]


@pytest.mark.parametrize("n,G,ops,f64,strategy,options", SMALL_CASES)
def test_small_kernel_matches_plain(cuda, n, G, ops, f64, strategy,
                                    options):
    from cockroach_tpu_torch.ops.cuda import groupagg as tg
    assert tg.choose_strategy(G, len(ops)) == strategy
    _check_small(*_small_inputs(n, G, ops, n + G, cuda, f64=f64,
                                **options), G, ops)


def test_small_kernel_masked_out_of_range_and_nan(cuda):
    ops = (0, 1, 2, 3)
    gid, sel, vals, masks = _small_inputs(1 << 14, 20, ops, 3, cuda,
                                          gid_lo=-30, gid_hi=60,
                                          sel_frac=0.0)
    _check_small(gid, sel, vals, masks, 20, ops)
    _check_small(*_small_inputs(1 << 16, 8, ops, 4, cuda,
                                nan_groups=(1, 5)), 8, ops)


def test_engine_q14_q1f_q6f_on_card_match_cpu(cuda):
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    rows = {}
    for dev in ("cpu", "cuda"):
        e = Engine(device=dev)
        tpch.load(e, sf=0.01, rows=50_000)
        s = e.session()
        e.execute("SET pallas_groupagg = on", s)
        rows[dev] = (e.execute(tpch.Q14).rows, e.execute(tpch.Q1F, s).rows,
                     e.execute(tpch.Q6F, s).rows)
    for got, want in zip(rows["cuda"], rows["cpu"]):
        assert len(got) == len(want)
        for g_row, w_row in zip(got, want):
            for g, w in zip(g_row, w_row):
                assert g == pytest.approx(w, rel=1e-5)


# -- the multi-table suite: sorts, top-k, hash GROUP BY, compaction,
#    expanding joins (plain PyTorch on both devices) ---------------------------

def test_sort_lanes_on_card_match_cpu(cuda):
    # int64 shifts and the float bit views must give the CPU's words
    from cockroach_tpu_torch.ops import sortkey
    rng = np.random.default_rng(4)
    n = 1 << 16
    i64 = rng.integers(-(1 << 63), (1 << 63) - 1, size=n, dtype=np.int64)
    i64[:3] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1]
    f64 = rng.normal(size=n)
    f64[:5] = [-0.0, 0.0, np.nan, -np.inf, np.inf]
    codes = rng.integers(0, 40, size=n).astype(np.int32)
    lut = rng.permutation(40).astype(np.int32)
    cols = [(i64, False, True, None), (f64, True, False, None),
            (codes, True, True, lut), (rng.random(n) < 0.5, False, False,
                                       None)]
    valid = [rng.random(n) < 0.9 for _ in cols]
    sel = rng.random(n) < 0.8
    out = []
    for dev in ("cpu", cuda):
        specs = [(torch.tensor(d, device=dev), torch.tensor(v, device=dev),
                  desc, nf, lu, None)
                 for (d, desc, nf, lu), v in zip(cols, valid)]
        lanes = sortkey.mask_dead(
            sortkey.pack_lanes(sortkey.encode_keys(specs), n, dev),
            torch.tensor(sel, device=dev))
        out.append(([la.cpu() for la in lanes],
                    sortkey.sort_perm(lanes).cpu()))
    assert len(out[0][0]) == len(out[1][0]) == 3
    for a, b in zip(out[0][0], out[1][0]):
        assert torch.equal(a, b)
    assert torch.equal(out[0][1], out[1][1])


def test_engine_suite_on_card_match_cpu(cuda):
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    rows = {}
    for dev in ("cpu", "cuda"):
        e = Engine(device=dev)
        tpch.load(e, sf=0.01, tables=tpch.ALL_TABLES)
        rows[dev] = [e.execute(getattr(tpch, q)).rows
                     for q in ("Q3", "Q5", "Q10", "Q12")]
    # DECIMAL sums are exact on both devices
    assert rows["cuda"] == rows["cpu"]


# -- streamed pages and the spill tier on the card -----------------------------

def test_page_source_on_card_pages_taken_before_read(cuda):
    """Every page uploaded (async copies from the pinned ring) before
    any is read, over chunks that split pages and columns with NULLs:
    each page must hold its own rows, validity and padding."""
    from cockroach_tpu_torch.exec import stream
    from cockroach_tpu_torch.sql.types import (INT8, ColumnSchema, SQLType,
                                               TableSchema)
    from cockroach_tpu_torch.storage.columnstore import ColumnStore
    from cockroach_tpu_torch.storage.hlc import Timestamp
    store = ColumnStore()
    store.create_table(TableSchema(
        name="t", columns=[ColumnSchema("a", INT8, False),
                           ColumnSchema("b", SQLType.decimal(12, 2),
                                        True)],
        primary_key=[], table_id=100))
    rng = np.random.default_rng(4)
    parts = []
    for n in (3000, 5000, 1234, 7000):
        a = rng.integers(-(1 << 40), 1 << 40, n)
        b = rng.integers(0, 1 << 30, n)
        bv = rng.random(n) > 0.1
        store.append_chunk("t", {"a": a, "b": b}, {"a": np.ones(n, bool),
                                                   "b": bv},
                           np.full(n, Timestamp(1, 0).to_int()),
                           np.full(n, 2 ** 62, dtype=np.int64))
        parts.append((a, b, bv))
    a, b, bv = (np.concatenate(x) for x in zip(*parts))
    src = stream.PageSource(store.table("t"), None, 4096, device=cuda)
    for ups in (list(src.pages()),
                list(stream.prefetch(src.pages()))):
        assert len(ups) == -(-len(a) // 4096)
        for i, up in enumerate(ups):
            batch = up.batch()
            lo, hi = i * 4096, min((i + 1) * 4096, len(a))
            k = hi - lo
            np.testing.assert_array_equal(batch.col("a")[:k].cpu().numpy(),
                                          a[lo:hi])
            got_v = batch.col_valid("b")[:k].cpu().numpy()
            np.testing.assert_array_equal(got_v, bv[lo:hi])
            np.testing.assert_array_equal(
                batch.col("b")[:k].cpu().numpy()[got_v], b[lo:hi][got_v])
            assert (batch.col("_mvcc_ts")[k:].cpu().numpy()
                    == int(stream.NEVER_TS)).all()


def test_streamed_and_spilled_on_card_match_cpu(cuda):
    """Q1, Q6 and Q14 streamed in 8,192-row pages over 4,096-row chunks,
    a spilled join and a spilled sort: the card's rows equal the CPU's
    (FLOAT8 within rel 1e-9, everything else exactly)."""
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.sql.types import Family
    join_q = ("SELECT o_orderpriority, count(*) AS n, "
              "sum(l_extendedprice) AS r FROM lineitem, orders "
              "WHERE l_orderkey = o_orderkey GROUP BY o_orderpriority "
              "ORDER BY o_orderpriority")
    sort_q = ("SELECT l_orderkey, l_linenumber, l_extendedprice FROM "
              "lineitem WHERE l_shipdate < date '1992-03-01' ORDER BY "
              "l_extendedprice DESC, l_orderkey, l_linenumber LIMIT 100")
    runs = [("q1", tpch.Q1, "stream-scan"), ("q6", tpch.Q6, "stream-scan"),
            ("q14", tpch.Q14, "spill-join"),
            ("join", join_q, "spill-join"), ("sort", sort_q, "spill-sort")]
    out = {}
    for dev in ("cpu", "cuda"):
        e = Engine(device=dev)
        tpch.load(e, sf=0.01, rows=50_000, chunk_rows=4096,
                  tables=("lineitem", "part", "orders"))
        e.settings.set("sql.exec.hbm_budget_bytes", 1 << 20)
        s = e.session()
        e.execute("SET streaming_page_rows = 8192", s)
        for q, sql, route in runs:
            assert e.stream_verdict(sql, s) == route, q
            out[dev, q] = e.execute(sql, s)
    for q, _, _ in runs:
        got, want = out["cuda", q], out["cpu", q]
        assert len(got.rows) == len(want.rows) > 0
        floats = [t.family == Family.FLOAT for t in want.types]
        for g_row, w_row in zip(got.rows, want.rows):
            for g, w, fl in zip(g_row, w_row, floats):
                if fl:
                    assert g == pytest.approx(w, rel=1e-9)
                else:
                    assert g == w


# -- windows, the write path and the txn overlay on the card -------------------

WINDOW_SQL = (
    "SELECT o_orderkey, row_number() OVER (PARTITION BY o_custkey ORDER BY "
    "o_totalprice DESC), rank() OVER (PARTITION BY o_custkey ORDER BY "
    "o_totalprice DESC), ntile(4) OVER (ORDER BY o_orderdate), "
    "lag(o_orderdate) OVER (PARTITION BY o_custkey ORDER BY o_orderdate), "
    "sum(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY o_orderdate), "
    "min(o_totalprice) OVER (PARTITION BY o_orderpriority), "
    "avg(o_totalprice) OVER (PARTITION BY o_custkey) FROM orders "
    "ORDER BY o_orderkey")


@pytest.mark.parametrize("mode", ["auto", "off"])
def test_windows_on_card_match_cpu(cuda, mode):
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    rows = {}
    for dev in ("cpu", "cuda"):
        e = Engine(device=dev)
        tpch.load(e, sf=0.01, tables=("orders",))
        s = e.session()
        e.execute(f"SET sort_normalized = {mode}", s)
        rows[dev] = e.execute(WINDOW_SQL, s).rows
    assert len(rows["cuda"]) == 15_000
    for g_row, w_row in zip(rows["cuda"], rows["cpu"]):
        assert g_row[:-1] == w_row[:-1]   # integers, dates, DECIMAL
        assert g_row[-1] == pytest.approx(w_row[-1], rel=1e-12)


def _refresh(e, tpch):
    """RF1 in a txn, RF2, an UPDATE and a rolled-back INSERT."""
    o_new, li_new = tpch.gen_refresh(0.01, n_orders=60)
    keys = ", ".join(str(int(k)) for k in tpch.rf2_orderkeys(0.01,
                                                             n_orders=60))
    s = e.session()
    e.execute("BEGIN", s)
    for st in (tpch.insert_statements("orders", o_new)
               + tpch.insert_statements("lineitem", li_new)):
        e.execute(st, s)
    e.execute("COMMIT", s)
    e.execute(f"DELETE FROM lineitem WHERE l_orderkey IN ({keys})")
    e.execute(f"DELETE FROM orders WHERE o_orderkey IN ({keys})")
    e.execute("UPDATE lineitem SET l_discount = 0.04 WHERE l_orderkey = 7")
    e.execute("BEGIN", s)
    e.execute(tpch.insert_statements("lineitem", li_new)[0], s)
    e.execute("ROLLBACK", s)


def test_refresh_then_q1_on_card_match_cpu(cuda):
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    rows = {}
    for dev in ("cpu", "cuda"):
        e = Engine(device=dev)
        tpch.load(e, sf=0.01, rows=50_000,
                  tables=("lineitem", "part", "orders"))
        _refresh(e, tpch)
        before = tgl.LAUNCHES
        rows[dev] = [e.execute(q).rows for q in (tpch.Q1, tpch.Q6,
                                                 tpch.Q14)]
        if dev == "cuda":
            assert tgl.LAUNCHES == before + 1   # Q1 through kernel 1
    for got, want in zip(rows["cuda"], rows["cpu"]):
        for g_row, w_row in zip(got, want):
            # Q1's DECIMAL sums and counts bit for bit; its AVGs rel 1e-12
            assert g_row[:6] == w_row[:6]
            for g, w in zip(g_row[6:], w_row[6:]):
                assert g == pytest.approx(w, rel=1e-12)


def test_txn_overlay_on_card_leaves_committed_copy(cuda):
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    e = Engine()
    tpch.load(e, sf=0.01, rows=20_000, tables=("lineitem",))
    q = "SELECT count(*), sum(l_quantity) FROM lineitem"
    committed = e.execute(q).rows
    gen = e.store.table("lineitem").generation
    (key, (cols, batch)), = [(k, v) for k, v in e._device_tables.items()
                             if k[0] == "lineitem"]
    snapshot = [t.clone() for t in batch.data]
    s = e.session()
    e.execute("BEGIN", s)
    e.execute("INSERT INTO lineitem SELECT * FROM lineitem "
              "WHERE l_orderkey < 100", s)
    in_txn = e.execute(q, s).rows
    assert in_txn != committed and in_txn[0][0] > committed[0][0]
    # the overlay was uploaded for the statement alone: the committed
    # copy is the one cached, unchanged, under the same generation
    assert [k for k in e._device_tables if k[0] == "lineitem"] == [key]
    assert key == ("lineitem", gen)
    assert all(torch.equal(a, b) for a, b in zip(batch.data, snapshot))
    assert e.execute(q).rows == committed
    e.execute("ROLLBACK", s)
    assert e.execute(q).rows == committed


# -- composed CTEs and the fine profile plane on the card ----------------------

def test_composed_ctes_on_card_match_cpu(cuda):
    """Prepared Q4, Q13, Q21 and Q22 compose on the card after their
    first run (no temp uploaded) and give the CPU engine's rows."""
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    engines = {}
    for dev in ("cpu", "cuda"):
        engines[dev] = e = Engine(device=dev)
        tpch.load(e, sf=0.01, rows=20_000, tables=tpch.ALL_TABLES)
    for q in ("q4", "q13", "q21", "q22"):
        want = engines["cpu"].execute(tpch.QUERIES[q]).rows
        e = engines["cuda"]
        p = e.prepare(tpch.QUERIES[q])
        for i in range(3):
            assert p.run().rows == want, (q, i)
            assert e.last_exec["composed"] == (i > 0)
        assert (p.composed_runs, p.declined) == (2, 0)


def test_explain_analyze_on_card_times_operators(cuda):
    """EXPLAIN ANALYZE of Q1 on the card: kernel 1 launches once, each
    operator has CUDA-event device time, the aggregate's above 0 and
    the operators' within the total."""
    import re

    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    e = Engine()
    tpch.load(e, sf=0.01, rows=20_000, tables=("lineitem",))
    e.execute(tpch.Q1)
    before = tgl.LAUNCHES
    lines = [r[0] for r in e.execute("EXPLAIN ANALYZE " + tpch.Q1).rows]
    assert tgl.LAUNCHES == before + 1
    plan = lines[lines.index("plan:") + 1:]
    dev = [float(re.search(r"device=([0-9.]+)ms", ln).group(1))
           for ln in plan]
    total = float(re.search(r"total: ([0-9.]+)ms", "\n".join(lines))
                  .group(1))
    agg = [d for ln, d in zip(plan, dev) if "Aggregate" in ln]
    assert agg and agg[0] > 0 and sum(dev) <= total
    assert "(actual rows=4)" in plan[0]
