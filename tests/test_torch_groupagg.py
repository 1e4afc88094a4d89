"""The PyTorch port's small-G group aggregation against the JAX kernel.

The same seeded numpy inputs go through the reference Pallas kernel
(cockroach_tpu/ops/pallas/groupagg.py:dense_group_aggregate, interpret
mode on the CPU, as tests/test_pallas_kernels.py runs it) and through
the port's wrapper (cockroach_tpu_torch/ops/cuda/groupagg.py) on CPU
tensors, which takes the plain PyTorch version. Counts and MIN/MAX must
be equal (NaN where NaN); sums agree within abs 1e-2 + rel 1e-5 (both
accumulate in a different order, the reference in f32 per block, the
port's plain version in float64 rounded to f32 once). The shapes follow
tests/test_pallas_kernels.py.
"""

import numpy as np
import pytest
import torch

from cockroach_tpu_torch.ops.cuda import groupagg as tg
from tests.test_torch_groupagg_large import reference_modules

jpg = None  # the reference module, bound by the fixture below


@pytest.fixture(scope="module", autouse=True)
def _reference_kernel():
    global jpg
    with reference_modules("cockroach_tpu.ops.pallas.groupagg") as (jpg,):
        yield
    jpg = None


def _data(n=8192, groups=6, seed=0, gid_lo=0, gid_hi=None):
    rng = np.random.default_rng(seed)
    gid = rng.integers(gid_lo, groups if gid_hi is None else gid_hi,
                       size=n).astype(np.int32)
    sel = rng.random(n) < 0.8
    v = rng.normal(size=n).astype(np.float32) * 100
    m = rng.random(n) < 0.9
    return gid, sel, v, m


def _run_both(gid, sel, values, masks, G, ops, block_rows=1024):
    ja, jc = jpg.dense_group_aggregate(gid, sel, tuple(values),
                                       tuple(masks), G, tuple(ops),
                                       block_rows=block_rows,
                                       interpret=True)
    before = tg.PLAIN_CALLS
    ta, tc = tg.dense_group_aggregate(
        torch.from_numpy(gid), torch.from_numpy(sel),
        tuple(torch.from_numpy(v) for v in values),
        tuple(torch.from_numpy(m) for m in masks), G, tuple(ops))
    assert tg.PLAIN_CALLS == before + 1
    assert ta.dtype == torch.float32 and tc.dtype == torch.int32
    assert ta.shape == tc.shape == (G, len(ops))
    ja, jc, ta, tc = np.asarray(ja), np.asarray(jc), ta.numpy(), tc.numpy()
    for a, op in enumerate(ops):
        if op == tg.COUNT:
            np.testing.assert_array_equal(tc[:, a], jc[:, a])
        elif op == tg.SUM:
            np.testing.assert_allclose(ta[:, a], ja[:, a], rtol=1e-5,
                                       atol=1e-2)
        else:
            np.testing.assert_array_equal(ta[:, a], ja[:, a])
    return ta, tc


def test_all_ops():
    gid, sel, v, m = _data()
    ta, tc = _run_both(gid, sel, (v,) * 4, (m,) * 4, 6,
                       (tg.COUNT, tg.SUM, tg.MIN, tg.MAX))
    eff = sel & m
    for g in range(6):
        gm = eff & (gid == g)
        assert tc[g, 0] == gm.sum()
        assert ta[g, 2] == v[gm].min() and ta[g, 3] == v[gm].max()


def test_empty_group_identities():
    gid, sel, v, m = _data(groups=3)
    ops = (tg.SUM, tg.MIN, tg.MAX, tg.COUNT)
    ta, tc = _run_both(gid, sel, (v,) * 4, (m,) * 4, 6, ops)
    # groups 3..5 never occur
    assert np.all(ta[3:, 0] == 0.0) and np.all(ta[3:, 1] == np.inf)
    assert np.all(ta[3:, 2] == -np.inf) and np.all(tc[3:, 3] == 0)


def test_single_block():
    gid, sel, v, m = _data(n=1024, groups=2)
    _, tc = _run_both(gid, sel, (v,), (m,), 2, (tg.COUNT,))
    eff = sel & m
    assert tc[0, 0] == (eff & (gid == 0)).sum()
    assert tc[1, 0] == (eff & (gid == 1)).sum()


def test_multi_agg_mixed_masks():
    n = 4096
    rng = np.random.default_rng(7)
    gid = rng.integers(0, 4, size=n).astype(np.int32)
    sel = np.ones(n, bool)
    v1 = rng.random(n).astype(np.float32)
    m1 = rng.random(n) < 0.5
    v2 = (rng.random(n) * 10).astype(np.float32)
    m2 = np.ones(n, bool)
    _run_both(gid, sel, (v1, v2, v1), (m1, m2, m2), 4,
              (tg.SUM, tg.MAX, tg.COUNT), block_rows=2048)


@pytest.mark.parametrize("G", [1, 64])
def test_group_count_bounds(G):
    gid, sel, v, m = _data(n=4096, groups=G, seed=G)
    _run_both(gid, sel, (v,) * 4, (m,) * 4, G,
              (tg.MAX, tg.COUNT, tg.SUM, tg.MIN))


def test_nan_values_propagate():
    gid, sel, v, m = _data(n=4096, groups=5, seed=11)
    v = v.copy()
    v[(gid == 1) & sel & m] = np.nan   # every value of group 1
    hit = np.flatnonzero((gid == 3) & sel & m)[:2]
    v[hit] = np.nan                    # two values of group 3
    ta, _ = _run_both(gid, sel, (v,) * 3, (m,) * 3, 5,
                      (tg.SUM, tg.MIN, tg.MAX))
    for g in range(5):
        assert np.all(np.isnan(ta[g])) == (g in (1, 3))


def test_signed_zero_min_max_match_reference():
    # zeros are -0.0 in even groups and +0.0 in odd ones, and group 2
    # holds only -0.0: a MIN or MAX that is a zero has one right sign
    gid, sel, v, m = _data(n=4096, groups=6, seed=13)
    v = np.abs(v)
    zero = (np.random.default_rng(13).random(4096) < 0.05) | (gid == 2)
    v[zero] = np.where(gid[zero] % 2 == 0, -0.0, 0.0)
    ta, _ = _run_both(gid, sel, (v,) * 3, (m,) * 3, 6,
                      (tg.MIN, tg.MAX, tg.SUM))
    ja, _ = jpg.dense_group_aggregate(gid, sel, (v,) * 3, (m,) * 3, 6,
                                      (tg.MIN, tg.MAX, tg.SUM),
                                      interpret=True)
    np.testing.assert_array_equal(ta[:, :2].view(np.int32),
                                  np.asarray(ja)[:, :2].view(np.int32))
    assert np.signbit(ta[[0, 2, 4], 0]).all()
    assert not np.signbit(ta[[1, 3, 5], 0]).any()
    assert ta[2, 1] == 0.0 and np.signbit(ta[2, 1])


def test_out_of_range_ids_and_masked_rows_contribute_nothing():
    n, G = 2048, 8
    gid, sel, v, m = _data(n=n, groups=G, seed=5, gid_lo=-10, gid_hi=20)
    _, tc = _run_both(gid, sel, (v, v), (m, m), G, (tg.COUNT, tg.SUM))
    ok = (gid >= 0) & (gid < G) & sel & m
    np.testing.assert_array_equal(tc[:, 0], np.bincount(gid[ok],
                                                        minlength=G))


def test_contract_checks():
    gid = torch.zeros(100, dtype=torch.int32)
    one = torch.ones(100, dtype=torch.bool)
    with pytest.raises(ValueError, match="multiple of 128"):
        tg.dense_group_aggregate(gid, one, (one,), (one,), 1, (tg.COUNT,))
    gid = torch.zeros(128, dtype=torch.int32)
    one = torch.ones(128, dtype=torch.bool)
    with pytest.raises(ValueError, match="num_groups"):
        tg.dense_group_aggregate(gid, one, (one,), (one,), 65, (tg.COUNT,))


# (G, A, strategy): the edges of each accumulator layout, where its
# copies (G * A 32-bit words each: 128 a block, or 1) and the plan's
# 32 * A + 16 descriptor bytes still fit in 227 KB of shared memory
STRATEGY_EDGES = [
    (12, 15, "thread"),   # TPC-H Q1F
    (1, 2, "thread"),     # TPC-H Q6F
    (32, 15, "cta"),      # TPC-H Q1F by return flag and ship mode
    (1, 427, "thread"), (1, 428, "cta"),
    (64, 7, "thread"), (64, 8, "cta"),
    (64, 220, "cta"), (64, 221, "cta"),
    (64, 807, "cta"),
]


@pytest.mark.parametrize("G,A,strategy", STRATEGY_EDGES)
def test_strategy_choice(G, A, strategy):
    assert tg.choose_strategy(G, A) == strategy


@pytest.mark.parametrize("G,A,strategy", STRATEGY_EDGES)
def test_fitting_strategies_start_with_the_choice(G, A, strategy):
    # the per-block layout fits wherever any does; the chosen one first
    fit = tg.fitting_strategies(G, A)
    assert fit[0] == strategy and fit[-1] == "cta"
    assert fit == [s for s in tg.STRATEGIES if s in fit]


def test_strategy_choice_refuses_past_the_block_layout():
    with pytest.raises(ValueError, match="do not fit"):
        tg.choose_strategy(64, 808)


def test_columns_deduplicated_by_storage():
    # two slots share one mask tensor, one slot's mask is sel itself, and
    # two value slots share one column: the kernel reads one mask and one
    # value column besides gid and sel
    gid, sel, v, m = _data(n=4096, groups=5, seed=21)
    ts, tm, tv = (torch.from_numpy(a) for a in (sel, m, v))
    ops = (tg.COUNT, tg.SUM, tg.COUNT, tg.MAX)
    plan = tg.column_plan(ts, (tv, tv, tv, tv), (tm, tm, ts, tm), ops)
    assert len(plan.masks) == 1 and len(plan.values) == 1
    assert plan.sel.data_ptr() == ts.data_ptr()
    # (value column, mask + 1, op, output column), in slot order
    assert plan.slots == [(-1, 1, tg.COUNT, 0), (0, 1, tg.SUM, 1),
                          (-1, 0, tg.COUNT, 2), (0, 1, tg.MAX, 3)]
    # the plain version gives the reference's counts for the same call
    _, tc = _run_both(gid, sel, (v, v, v, v), (m, m, sel, m), 5, ops)
    ok = sel & (gid >= 0) & (gid < 5)
    np.testing.assert_array_equal(tc[:, 0], np.bincount(gid[ok & m],
                                                        minlength=5))
    np.testing.assert_array_equal(tc[:, 2], np.bincount(gid[ok],
                                                        minlength=5))


def test_builds_are_named_by_source_and_content(tmp_path):
    # a variant of a kernel source, timed beside the checkout's own
    # (bench_groupagg --source), builds apart from it: by its file's
    # stem and a hash of its text, so an edit never loads a stale build
    from cockroach_tpu_torch.ops.cuda import build
    variant = tmp_path / "groupagg_variant.cu"
    variant.write_text("// a variant\n")
    own = build.lib_path("groupagg")
    assert own.parent == build.BUILD_DIR and own.name.startswith("groupagg-")
    first = build.lib_path(variant)
    assert first.name.startswith("groupagg_variant-") and first != own
    variant.write_text("// another variant\n")
    assert build.lib_path(variant) != first
