"""The port's packed sort-key lanes, sorts and top-k against the JAX
package's.

The same seeded numpy keys (INT64 with its extremes, INT32, FLOAT64
with -0.0, NaN and +-inf, DECIMAL as scaled int64, dictionary ranks,
BOOL, dense ids of an asserted width), each with NULLs and dead rows,
go through cockroach_tpu/ops/sortkey.py (uint64 lanes, JAX on the CPU)
and cockroach_tpu_torch/ops/sortkey.py (the same bit patterns held in
int64). ``encode_value``, ``encode_key``, ``pack_lanes`` and
``mask_dead`` must give bit-equal words, and ``sort_perm`` the same
permutation, under ASC/DESC and NULLS FIRST/LAST. ``sort_batch`` and
the fused ``topk_sort_limit_batch`` (with its __topk_inexact sentinel)
must give the reference's rows in the reference's order under
``sort_normalized`` auto, on and off. Exact: no tolerance.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cockroach_tpu.exec import compile as jc
from cockroach_tpu.ops import sortkey as jsk
from cockroach_tpu.ops.batch import ColumnBatch as JBatch
from cockroach_tpu_torch.exec import compile as tc
from cockroach_tpu_torch.ops import sortkey as tsk
from cockroach_tpu_torch.ops.batch import ColumnBatch as TBatch

N = 4096


def _as_u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _column(kind: str, rng) -> tuple[np.ndarray, dict]:
    """One key column of `kind` (and the encode kwargs it needs)."""
    if kind == "int64":
        d = rng.integers(-(1 << 62), 1 << 62, size=N, dtype=np.int64)
        d[:8] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0, 1,
                 np.iinfo(np.int64).min + 1, np.iinfo(np.int64).max - 1, 0]
        d[8: N // 2] = rng.integers(-4, 4, size=N // 2 - 8)  # ties
        return d, {}
    if kind == "int32":
        d = rng.integers(-(1 << 31), (1 << 31) - 1, size=N).astype(np.int32)
        d[:4] = [np.iinfo(np.int32).min, np.iinfo(np.int32).max, -1, 0]
        d[4: N // 2] = rng.integers(-3, 3, size=N // 2 - 4)
        return d, {}
    if kind == "float64":
        d = rng.normal(size=N) * 1e3
        d[:8] = [-0.0, 0.0, np.nan, -np.inf, np.inf, -np.nan, 5e-324,
                 -5e-324]
        d[8: N // 2] = rng.choice([-0.0, 0.0, 1.5, -1.5, np.nan],
                                  size=N // 2 - 8)
        return d, {}
    if kind == "decimal":   # DECIMAL(15,2) as scaled int64 cents
        return np.round(rng.uniform(-1e6, 1e6, size=N) * 100).astype(
            np.int64) // 7 * 7, {}
    if kind == "dict":      # string codes ordered by dictionary rank
        lut = rng.permutation(37).astype(np.int32)
        return rng.integers(0, 37, size=N).astype(np.int32), {"lut": lut}
    if kind == "bool":
        return rng.random(N) < 0.5, {}
    if kind == "width":     # dense group ids, asserted 11 bits wide
        return rng.integers(0, 1 << 11, size=N).astype(np.int32), \
            {"width": 11}
    raise ValueError(kind)


KINDS = ("int64", "int32", "float64", "decimal", "dict", "bool", "width")


def _to_jax(d, kw):
    return jnp.asarray(d), {k: (jnp.asarray(v) if k == "lut" else v)
                            for k, v in kw.items()}


def _to_torch(d, kw):
    return torch.from_numpy(np.ascontiguousarray(d)), kw


@pytest.mark.parametrize("kind", KINDS)
def test_encode_value_bit_equal(kind):
    d, kw = _column(kind, np.random.default_rng(len(kind)))
    jb, jw = jsk.encode_value(*_to_jax(d, kw)[:1], **_to_jax(d, kw)[1])
    tb, tw = tsk.encode_value(*_to_torch(d, kw)[:1], **kw)
    assert tw == jw
    np.testing.assert_array_equal(_as_u64(tb), np.asarray(jb))


@pytest.mark.parametrize("desc,null_first",
                         list(itertools.product([False, True], repeat=2)))
@pytest.mark.parametrize("kind", KINDS)
def test_encode_key_bit_equal(kind, desc, null_first):
    rng = np.random.default_rng(7 + len(kind))
    d, kw = _column(kind, rng)
    valid = rng.random(N) < 0.85
    jd, jkw = _to_jax(d, kw)
    want = jsk.encode_key(jd, jnp.asarray(valid), desc, null_first, **jkw)
    got = tsk.encode_key(torch.from_numpy(np.ascontiguousarray(d)),
                         torch.from_numpy(valid), desc, null_first, **kw)
    assert [w for _, w in got] == [w for _, w in want]
    for (tb, _), (jb, _) in zip(got, want):
        np.testing.assert_array_equal(_as_u64(tb), np.asarray(jb))


def _specs(kinds, seed, desc_flags, nf_flags):
    """The same key list as JAX and torch specs."""
    rng = np.random.default_rng(seed)
    jspecs, tspecs = [], []
    for kind, desc, nf in zip(kinds, desc_flags, nf_flags):
        d, kw = _column(kind, rng)
        valid = rng.random(N) < 0.9
        jd, jkw = _to_jax(d, kw)
        jspecs.append((jd, jnp.asarray(valid), desc, nf, jkw.get("lut"),
                       kw.get("width")))
        tspecs.append((torch.from_numpy(np.ascontiguousarray(d)),
                       torch.from_numpy(valid), desc, nf, kw.get("lut"),
                       kw.get("width")))
    return jspecs, tspecs


# key lists of one to four keys: one lane, a field straddling a lane
# boundary, and three lanes
KEY_LISTS = [
    ("int64",), ("dict", "int32"), ("float64", "decimal"),
    ("bool", "int64", "width"), ("decimal", "int32", "int64", "dict"),
    ("width", "bool", "dict"),
]


@pytest.mark.parametrize("kinds", KEY_LISTS, ids="-".join)
@pytest.mark.parametrize("variant", range(3))
def test_pack_mask_and_sort_perm_equal(kinds, variant):
    rng = np.random.default_rng(100 + variant)
    desc = [bool(x) for x in rng.random(len(kinds)) < 0.5]
    nf = [bool(x) for x in rng.random(len(kinds)) < 0.5]
    jspecs, tspecs = _specs(kinds, variant * 31 + len(kinds), desc, nf)
    sel = rng.random(N) < 0.8
    jlanes = jsk.mask_dead(jsk.pack_lanes(jsk.encode_keys(jspecs), N),
                           jnp.asarray(sel))
    tlanes = tsk.mask_dead(tsk.pack_lanes(tsk.encode_keys(tspecs), N),
                           torch.from_numpy(sel))
    assert len(tlanes) == len(jlanes)
    for tl, jl in zip(tlanes, jlanes):
        np.testing.assert_array_equal(_as_u64(tl), np.asarray(jl))
    np.testing.assert_array_equal(tsk.sort_perm(tlanes).numpy(),
                                  np.asarray(jsk.sort_perm(jlanes)))


def test_sort_perm_orders_unsigned_and_counts():
    # words past 2^63 sort above every smaller word, as uint64 does
    words = np.array([0, 1 << 63, (1 << 64) - 1, 5, (1 << 63) - 1, 5],
                     dtype=np.uint64)
    lane = torch.from_numpy(words.view(np.int64).copy())
    before = (tsk.NORMALIZED.value("sort"), tsk.LANES.value("sort"))
    perm = tsk.sort_perm([lane], kind="sort")
    assert perm.tolist() == [0, 3, 5, 4, 1, 2]
    assert (tsk.NORMALIZED.value("sort"), tsk.LANES.value("sort")) == \
        (before[0] + 1, before[1] + 1)


def test_unencodable_dtype_is_none():
    assert tsk.encode_value(torch.zeros(4, dtype=torch.complex64)) is None
    assert tsk.encode_keys([(torch.zeros(4, dtype=torch.complex64),
                             torch.ones(4, dtype=torch.bool), False, False,
                             None, None)]) is None


def _sort_batches(seed, n=2000):
    """A batch of sort keys (a heavily tied INT, a DECIMAL, a FLOAT64 with
    NaN and -0.0, dictionary codes, a BOOL) with NULLs and dead rows,
    as JAX and torch batches, plus the rank table of the codes."""
    rng = np.random.default_rng(seed)
    cols = {"k": rng.integers(0, 4, size=n),
            "dec": rng.integers(-10**6, 10**6, size=n) // 50 * 50,
            "f": np.where(rng.random(n) < 0.05, np.nan,
                          np.where(rng.random(n) < 0.05, -0.0,
                                   np.round(rng.normal(size=n), 2))),
            "s": rng.integers(0, 11, size=n).astype(np.int32),
            "b": rng.random(n) < 0.5,
            "row": np.arange(n)}
    valid = {k: rng.random(n) < 0.9 for k in cols}
    valid["row"] = np.ones(n, dtype=bool)
    sel = rng.random(n) < 0.8
    jb = JBatch.from_dict({k: jnp.asarray(v) for k, v in cols.items()},
                          {k: jnp.asarray(v) for k, v in valid.items()},
                          sel=jnp.asarray(sel))
    tb = TBatch.from_dict({k: torch.from_numpy(v) for k, v in cols.items()},
                          {k: torch.from_numpy(v) for k, v in valid.items()},
                          sel=torch.from_numpy(sel))
    rank = {"s": rng.permutation(11).astype(np.int32)}
    return jb, tb, rank


SORT_KEYS = [
    [("k", False), ("dec", True), ("row", False)],
    [("f", True, False), ("s", False, True)],
    [("b", False), ("s", True), ("dec", False, True), ("f", False)],
    [("dec", True)],
]


def _assert_same_rows(got, want):
    sel = np.asarray(want.sel)
    np.testing.assert_array_equal(got.sel.numpy(), sel)
    for name in want.names:
        np.testing.assert_array_equal(
            got.col_valid(name).numpy()[sel],
            np.asarray(want.col_valid(name))[sel], err_msg=name)
        np.testing.assert_array_equal(
            got.col(name).numpy()[sel], np.asarray(want.col(name))[sel],
            err_msg=name)


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("keys", range(len(SORT_KEYS)))
def test_sort_batch_equal(keys, mode):
    jb, tb, rank = _sort_batches(keys)
    key_list = SORT_KEYS[keys]
    want = jc.sort_batch(jb, key_list, rank, mode)
    before = tsk.NORMALIZED.value("sort")
    got = tc.sort_batch(tb, key_list, rank, mode)
    assert tsk.NORMALIZED.value("sort") == before + (mode != "off")
    np.testing.assert_array_equal(got.col("row").numpy(),
                                  np.asarray(want.col("row")))
    _assert_same_rows(got, want)


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("keys,limit,offset", [
    (0, 10, 0), (1, 25, 5), (2, 7, 0), (3, 40, 3), (1, 600, 0),
])
def test_topk_sort_limit_equal(keys, limit, offset, mode):
    jb, tb, rank = _sort_batches(10 + keys)
    key_list = SORT_KEYS[keys]
    want = jc.topk_sort_limit_batch(jb, key_list, rank, limit, offset, mode)
    got = tc.topk_sort_limit_batch(tb, key_list, rank, limit, offset, mode)
    inexact = bool(got.col("__topk_inexact")[0])
    assert inexact == bool(np.asarray(want.col("__topk_inexact"))[0])
    if inexact:
        # which tied rows make the cut is the top-k's own choice; the
        # engine replans with the full sort
        return
    _assert_same_rows(got, want)
    # an exact cut is the full sort's first rows
    full = tc.limit_batch(tc.sort_batch(tb, key_list, rank, mode),
                          limit, offset)
    np.testing.assert_array_equal(got.col("row")[got.sel].numpy(),
                                  full.col("row")[full.sel].numpy())


def test_topk_flags_ties_across_the_cut():
    # key k has 4 values over 2,000 rows: under every mode the rank
    # word ties across the 128-row candidate cut
    for mode in ("auto", "on", "off"):
        _, tb, rank = _sort_batches(10)
        got = tc.topk_sort_limit_batch(tb, SORT_KEYS[0], rank, 10, 0, mode)
        assert bool(got.col("__topk_inexact")[0])
