"""The PyTorch port's hash table and hash join against the JAX package's.

The same seeded numpy keys, masks and payloads go through
cockroach_tpu/ops/hashtable.py and ops/join.py (JAX on the CPU) and
through cockroach_tpu_torch/ops/hashtable.py and ops/join.py on CPU
tensors. The hash, the build's claim and slot arrays, and the probe's
(matched, build_row) must be bit-equal; every join type over the
direct-addressed, packed composite-key and hash-table paths must give
the same selection, the same validity and the same payload values
wherever a value is valid. A duplicate-keyed build side (K = 3 rows a
key at most) goes through ``_dup_chain`` (bit-equal chains under every
``sort_normalized`` mode) and the K-way ``_expand_join`` for inner and
left joins over the direct and hash-table paths, with the same rules.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cockroach_tpu.ops import hashtable as jht
from cockroach_tpu.ops import join as jjoin
from cockroach_tpu.ops.batch import ColumnBatch as JBatch
from cockroach_tpu_torch.ops import hashtable as tht
from cockroach_tpu_torch.ops import join as tjoin
from cockroach_tpu_torch.ops.batch import ColumnBatch as TBatch

JOIN_TYPES = ("inner", "left", "semi", "anti")


def _keys(seed, n):
    """Signed int64 keys spanning negatives and values past 2^32, and an
    int32 column, for the hash."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-(1 << 62), 1 << 62, size=n, dtype=np.int64)
    a[: n // 4] = rng.integers(-5, 5, size=n // 4)
    a[n // 4: n // 2] = (1 << 32) + rng.integers(-3, 3, size=n // 4)
    b = rng.integers(-(1 << 31), (1 << 31) - 1, size=n).astype(np.int32)
    return a, b


@pytest.mark.parametrize("capacity", [16, 1 << 12, 1 << 20])
@pytest.mark.parametrize("ncols", [1, 2])
def test_hash_columns_bit_equal(capacity, ncols):
    a, b = _keys(capacity + ncols, 4096)
    cols = (a, b)[:ncols]
    want = np.asarray(jht._hash_columns(tuple(jnp.asarray(c) for c in cols),
                                        capacity))
    got = tht._hash_columns(tuple(torch.from_numpy(c) for c in cols),
                            capacity)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _build_side(seed, n, dup=False):
    rng = np.random.default_rng(seed)
    k1 = rng.permutation(np.arange(-n, 2 * n, dtype=np.int64))[:n]
    if dup:
        k1[1::7] = k1[::7][: len(k1[1::7])]
    k2 = rng.integers(0, 3, size=n).astype(np.int32)
    mask = rng.random(n) < 0.85
    return k1, k2, mask


@pytest.mark.parametrize("dup", [False, True])
@pytest.mark.parametrize("ncols", [1, 2])
def test_build_and_probe_equal(dup, ncols):
    n = 1000
    k1, k2, mask = _build_side(ncols + 2 * dup, n, dup)
    cap = 2048
    bk = (k1, k2)[:ncols]
    jclaim, jslot, jconv = jht.build(tuple(jnp.asarray(c) for c in bk),
                                     jnp.asarray(mask), cap)
    tbk = tuple(torch.from_numpy(c) for c in bk)
    tclaim, tslot, tconv, trounds = tht.build(tbk, torch.from_numpy(mask),
                                              cap)
    np.testing.assert_array_equal(tclaim.numpy(), np.asarray(jclaim))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    assert tconv == bool(jconv) is True
    assert trounds >= 1

    rng = np.random.default_rng(40 + ncols)
    m = 3000
    p1 = rng.integers(-2 * n, 3 * n, size=m).astype(np.int64)
    p2 = rng.integers(0, 3, size=m).astype(np.int32)
    pmask = rng.random(m) < 0.9
    pk = (p1, p2)[:ncols]
    jm, jrow = jht.probe(jclaim, tuple(jnp.asarray(c) for c in bk),
                         tuple(jnp.asarray(c) for c in pk),
                         jnp.asarray(pmask), cap, n)
    tm, trow, prounds = tht.probe(tclaim, tbk,
                                  tuple(torch.from_numpy(c) for c in pk),
                                  torch.from_numpy(pmask), cap, n)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(trow.numpy(), np.asarray(jrow))
    assert tm.numpy().any() and not tm.numpy().all()
    assert prounds >= 1


def _batches(cols: dict, valid: dict, sel: np.ndarray):
    jb = JBatch.from_dict({k: jnp.asarray(v) for k, v in cols.items()},
                          {k: jnp.asarray(v) for k, v in valid.items()},
                          sel=jnp.asarray(sel))
    tb = TBatch.from_dict({k: torch.from_numpy(v) for k, v in cols.items()},
                          {k: torch.from_numpy(v) for k, v in valid.items()},
                          sel=torch.from_numpy(sel))
    return jb, tb


def _join_inputs(seed, nb=300, npr=1024, sparse=False):
    """A build side with unique (k1) and unique (k1, k2) keys, dead rows
    and NULL keys, and payloads of four kinds; a probe side with keys in
    and out of the build's range and NULL keys."""
    rng = np.random.default_rng(seed)
    step = 40 if sparse else 1
    k1 = (rng.permutation(nb) * step + 7).astype(np.int64)
    k2 = rng.integers(0, 4, size=nb).astype(np.int32)
    bcols = {
        "b_k1": k1, "b_k2": k2,
        "b_i64": rng.integers(-(1 << 40), 1 << 40, size=nb),
        "b_code": rng.integers(0, 25, size=nb).astype(np.int32),
        "b_flag": rng.random(nb) < 0.5,
        "b_f64": rng.normal(size=nb),
    }
    bvalid = {k: rng.random(nb) < 0.9 for k in bcols}
    bsel = rng.random(nb) < 0.9
    p1 = rng.integers(0, nb * step + 20, size=npr).astype(np.int64)
    p2 = rng.integers(0, 4, size=npr).astype(np.int32)
    pcols = {"p_k1": p1, "p_k2": p2, "p_x": rng.normal(size=npr)}
    pvalid = {k: rng.random(npr) < 0.95 for k in pcols}
    psel = rng.random(npr) < 0.9
    return (bcols, bvalid, bsel), (pcols, pvalid, psel)


PAYLOAD = ["b_i64", "b_code", "b_flag", "b_f64"]
PACK = ["b_code", "b_flag"]


def _direct_for(build, keys):
    """The engine's direct-addressing decision, from the build's key
    ranges over all rows."""
    bcols = build[0]
    ranges = [(int(bcols[k].min()), int(bcols[k].max()) -
               int(bcols[k].min()) + 1) for k in keys]
    if len(keys) == 1:
        return (ranges[0][0], ranges[0][1] + 1)
    return ("packed", tuple(r[0] for r in ranges),
            tuple(r[1] for r in ranges))


PATHS = [
    # (path, build keys, probe keys, sparse build keys, pack payload)
    ("direct_folded", ["b_k1"], ["p_k1"], False, PACK),
    ("direct_folded_unpacked", ["b_k1"], ["p_k1"], False, []),
    ("direct_sparse", ["b_k1"], ["p_k1"], True, PACK),
    ("packed", ["b_k1", "b_k2"], ["p_k1", "p_k2"], False, PACK),
    ("hash", ["b_k1"], ["p_k1"], False, PACK),
    ("hash_two_keys", ["b_k1", "b_k2"], ["p_k1", "p_k2"], True, PACK),
]


@pytest.mark.parametrize("join_type", JOIN_TYPES)
@pytest.mark.parametrize("path,bkeys,pkeys,sparse,pack", PATHS)
def test_hash_join_equal(path, bkeys, pkeys, sparse, pack, join_type):
    build, probe = _join_inputs(len(path) + len(join_type), sparse=sparse)
    jb, tb = _batches(*build)
    jp, tp = _batches(*probe)
    direct = None if path.startswith("hash") else _direct_for(build, bkeys)
    want = jjoin.hash_join(jp, jb, pkeys, bkeys, PAYLOAD, join_type,
                           direct=direct, pack_payload=pack)
    got = tjoin.hash_join(tp, tb, pkeys, bkeys, PAYLOAD, join_type,
                          direct=direct, pack_payload=pack)
    assert got.names == want.names
    sel = np.asarray(want.sel)
    np.testing.assert_array_equal(got.sel.numpy(), sel)
    assert 0 < sel.sum() < len(sel)
    for name in got.names:
        v = np.asarray(want.col_valid(name))
        np.testing.assert_array_equal(got.col_valid(name).numpy(), v,
                                      err_msg=name)
        np.testing.assert_array_equal(got.col(name).numpy()[v],
                                      np.asarray(want.col(name))[v],
                                      err_msg=name)


def test_hash_join_refuses_expansion():
    # the engine bounds K at 64 (ops/join.py MAX_EXPAND); the join
    # refuses anything past it
    build, probe = _join_inputs(3)
    _, tb = _batches(*build)
    _, tp = _batches(*probe)
    with pytest.raises(ValueError, match="past the limit 64"):
        tjoin.hash_join(tp, tb, ["p_k1"], ["b_k1"], PAYLOAD, expand=65)


def _dup_inputs(seed, nkeys=200, npr=1024, K=3):
    """A build side whose keys repeat up to K times (with dead rows and
    NULL keys among the duplicates), and a probe side over and past the
    build's key range."""
    rng = np.random.default_rng(seed)
    # key i repeats 1 + i % K times
    k1 = rng.permutation(np.repeat(np.arange(nkeys),
                                   1 + np.arange(nkeys) % K))
    nb = len(k1)
    bcols = {"b_k1": k1 * 3 + 5,
             "b_k2": (k1 % 4).astype(np.int32),
             "b_i64": rng.integers(-(1 << 40), 1 << 40, size=nb),
             "b_code": rng.integers(0, 25, size=nb).astype(np.int32)}
    bvalid = {k: rng.random(nb) < 0.95 for k in bcols}
    bsel = rng.random(nb) < 0.9
    pcols = {"p_k1": rng.integers(0, nkeys + 8, size=npr) * 3 + 5,
             "p_x": rng.normal(size=npr)}
    pcols["p_k2"] = ((pcols["p_k1"] - 5) // 3 % 4).astype(np.int32)
    pvalid = {k: rng.random(npr) < 0.95 for k in pcols}
    psel = rng.random(npr) < 0.9
    return (bcols, bvalid, bsel), (pcols, pvalid, psel)


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("ncols", [1, 2])
def test_dup_chain_equal(mode, ncols):
    (bcols, bvalid, bsel), _ = _dup_inputs(ncols)
    keys = ["b_k1", "b_k2"][:ncols]
    mask = bsel & bvalid["b_k1"]
    want = jjoin._dup_chain(tuple(jnp.asarray(bcols[k]) for k in keys),
                            jnp.asarray(mask), len(mask), mode)
    got = tjoin._dup_chain(tuple(torch.from_numpy(bcols[k]) for k in keys),
                           torch.from_numpy(mask), len(mask), mode)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() < len(mask)).sum() > 50


DUP_PATHS = [("direct", ["b_k1"], ["p_k1"]),
             ("hash", ["b_k1"], ["p_k1"]),
             ("hash_two_keys", ["b_k1", "b_k2"], ["p_k1", "p_k2"])]


@pytest.mark.parametrize("mode", ["auto", "off"])
@pytest.mark.parametrize("join_type", ["inner", "left"])
@pytest.mark.parametrize("path,bkeys,pkeys", DUP_PATHS)
def test_expand_join_equal(path, bkeys, pkeys, join_type, mode):
    build, probe = _dup_inputs(len(path) + len(join_type))
    jb, tb = _batches(*build)
    jp, tp = _batches(*probe)
    direct = _direct_for(build, bkeys) if path == "direct" else None
    payload = ["b_i64", "b_code"]
    want = jjoin.hash_join(jp, jb, pkeys, bkeys, payload, join_type,
                           expand=3, direct=direct, sort_normalized=mode)
    got = tjoin.hash_join(tp, tb, pkeys, bkeys, payload, join_type,
                          expand=3, direct=direct, sort_normalized=mode)
    assert got.n == 3 * tp.n and got.names == want.names
    sel = np.asarray(want.sel)
    np.testing.assert_array_equal(got.sel.numpy(), sel)
    # every copy count 0..3 occurs among the probe rows
    copies = sel.reshape(-1, 3).sum(axis=1)
    assert set(copies.tolist()) >= {0, 1, 2, 3}
    for name in got.names:
        v = np.asarray(want.col_valid(name))
        np.testing.assert_array_equal(got.col_valid(name).numpy(), v,
                                      err_msg=name)
        np.testing.assert_array_equal(got.col(name).numpy()[v],
                                      np.asarray(want.col(name))[v],
                                      err_msg=name)
