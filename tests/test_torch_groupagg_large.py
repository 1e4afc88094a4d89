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
