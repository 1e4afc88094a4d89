"""Hash-strategy GROUP BY ids and selection compaction: the port against
the JAX package.

The same seeded numpy keys and masks go through
cockroach_tpu/ops/hashtable.py ``group_ids`` and
cockroach_tpu/exec/compile.py ``_key_encode`` / ``compact_batch`` (JAX
on the CPU, its non-TPU cumulative-sum compaction) and through their
counterparts in cockroach_tpu_torch on CPU tensors. Group ids, group
counts (-1 on overflow) and representative rows must be bit-equal, as
must the compacted columns, validity, selection and the
__compact_overflow sentinel. Exact: no tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cockroach_tpu.exec import compile as jc
from cockroach_tpu.ops import hashtable as jht
from cockroach_tpu.ops.batch import ColumnBatch as JBatch
from cockroach_tpu_torch.exec import compile as tc
from cockroach_tpu_torch.ops import hashtable as tht
from cockroach_tpu_torch.ops.batch import ColumnBatch as TBatch


def _group_keys(seed, n, ndistinct):
    """A signed int64 key past 2^32, an int32 key and a validity column,
    drawn from `ndistinct` combinations; a mask with dead rows."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, ndistinct, size=n)
    a_vals = rng.integers(-(1 << 40), 1 << 40, size=ndistinct)
    b_vals = rng.integers(-(1 << 31), (1 << 31) - 1,
                          size=ndistinct).astype(np.int32)
    v_vals = (rng.random(ndistinct) < 0.9).astype(np.int32)
    a = np.where(v_vals[pick] == 1, a_vals[pick], 0)
    mask = rng.random(n) < 0.85
    return (a, b_vals[pick], v_vals[pick]), mask


@pytest.mark.parametrize("n,ndistinct,capacity", [
    (1000, 7, 16),          # few groups
    (4096, 900, 2048),      # many groups, long probe chains
    (4096, 3000, 8192),
    (2000, 500, 256),       # more distinct keys than slots: ng = -1
])
def test_group_ids_equal(n, ndistinct, capacity):
    cols, mask = _group_keys(n + ndistinct, n, ndistinct)
    jg, jng, jrep = jht.group_ids(tuple(jnp.asarray(c) for c in cols),
                                  jnp.asarray(mask), capacity)
    tg, tng, trep, _ = tht.group_ids(
        tuple(torch.from_numpy(c) for c in cols), torch.from_numpy(mask),
        capacity)
    assert int(tng) == int(jng)
    if ndistinct > capacity:
        # both overflow; the port stops at half load, the reference at
        # its round bound, so their slots then differ
        assert int(tng) == -1
        return
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(trep.numpy(), np.asarray(jrep))
    assert 0 < int(tng) <= ndistinct


@pytest.mark.parametrize("dtype", ["int64", "int32", "float64", "bool"])
def test_key_encode_equal(dtype):
    rng = np.random.default_rng(5)
    n = 512
    d = {"int64": lambda: rng.integers(-(1 << 62), 1 << 62, size=n),
         "int32": lambda: rng.integers(-9, 9, size=n).astype(np.int32),
         "float64": lambda: np.where(rng.random(n) < 0.1, -0.0,
                                     rng.normal(size=n)),
         "bool": lambda: rng.random(n) < 0.5}[dtype]()
    v = rng.random(n) < 0.8
    jd, jv = jc._key_encode(jnp.asarray(d), jnp.asarray(v))
    td, tv = tc._key_encode(torch.from_numpy(d), torch.from_numpy(v))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _batch_pair(seed, n, sel_frac):
    rng = np.random.default_rng(seed)
    cols = {"a": rng.integers(-(1 << 40), 1 << 40, size=n),
            "b": rng.random(n) < 0.5,
            "c": rng.normal(size=n),
            "d": rng.integers(0, 9, size=n).astype(np.int32)}
    valid = {k: rng.random(n) < 0.9 for k in cols}
    sel = rng.random(n) < sel_frac
    jb = JBatch.from_dict({k: jnp.asarray(v) for k, v in cols.items()},
                          {k: jnp.asarray(v) for k, v in valid.items()},
                          sel=jnp.asarray(sel))
    tb = TBatch.from_dict({k: torch.from_numpy(v) for k, v in cols.items()},
                          {k: torch.from_numpy(v) for k, v in valid.items()},
                          sel=torch.from_numpy(sel))
    return jb, tb


@pytest.mark.parametrize("n,block,frac,sel_frac", [
    (8192, 1024, 0.125, 0.05),    # packs: 8 blocks of 128 slots
    (8192, 1024, 0.2, 0.15),      # kb rounds up to 256
    (8192, 1024, 0.125, 0.3),     # overflows: the sentinel is set
    (16384, 2048, 0.01, 0.0),     # nothing selected
    (4096, 4096, 0.1, 0.05),      # one block: passes through
    (6144, 4096, 0.1, 0.05),      # not a multiple of the block
    (8192, 1024, 1.0, 0.05),      # kb reaches the block: passes through
])
def test_compact_batch_equal(n, block, frac, sel_frac):
    jb, tb = _batch_pair(n + block, n, sel_frac)
    want = jc.compact_batch(jb, frac, block)
    got = tc.compact_batch(tb, frac, block)
    assert tuple(got.names) == tuple(want.names)
    assert (got is tb) == (want is jb)
    np.testing.assert_array_equal(got.sel.numpy(), np.asarray(want.sel))
    for name in got.names:
        np.testing.assert_array_equal(got.col_valid(name).numpy(),
                                      np.asarray(want.col_valid(name)),
                                      err_msg=name)
        np.testing.assert_array_equal(got.col(name).numpy(),
                                      np.asarray(want.col(name)),
                                      err_msg=name)
    if got is not tb:
        # the selected rows, in row order, up to each block's capacity
        kb = got.n // (n // block)
        assert kb % 128 == 0
        flag = bool(got.col("__compact_overflow")[0])
        sel = tb.sel.reshape(-1, block)
        assert flag == bool((sel.sum(dim=1) > kb).any())
        if not flag:
            np.testing.assert_array_equal(
                got.col("a")[got.sel].numpy(), tb.col("a")[tb.sel].numpy())
