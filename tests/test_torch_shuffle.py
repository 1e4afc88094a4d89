"""The hash-partitioned all-to-all exchange (parallel/shuffle.py) against
the reference's (cockroach_tpu/parallel/shuffle.py under shard_map on
its 8-device host mesh) and a numpy oracle (tests/test_shuffle.py's
cases).

The same seeded inputs go through both: ``dest_of`` gives the same
destination for every row (one key column and two), and ``exchange``
hands each shard the same received keys, values and validity in the
same order (source shard, then local order), with the same overflow
flag under skew and nothing received from all-empty shards. The
sharded-by-sharded join of the reference's test runs through the
port's exchange and ops/join.py hash_join per shard.
"""

import numpy as np
import pytest
import torch

from cockroach_tpu_torch.ops.batch import ColumnBatch
from cockroach_tpu_torch.ops.join import hash_join
from cockroach_tpu_torch.parallel import collective, shuffle
from cockroach_tpu_torch.parallel.collective import AXIS

D = 8
CPU = [torch.device("cpu")] * D


@pytest.fixture(scope="module")
def ref():
    """The reference's shuffle module and a runner of its exchange under
    shard_map over D devices."""
    # imported here: the card-only case runs without the reference
    from tests.test_torch_groupagg_large import reference_modules
    with reference_modules("cockroach_tpu.parallel.shuffle",
                           "cockroach_tpu.parallel.distagg",
                           "cockroach_tpu.parallel.mesh") as (
            jshuf, jdist, jmesh):
        import jax.numpy as jnp
        mesh = jmesh.make_mesh(n=D)

        def run(keys, vals, valid, cap):
            def body(k, v, ok):
                k, v, ok = k[0], v[0], ok[0]
                dest = jshuf.dest_of((k,), D)
                recv, rvalid, ovf = jshuf.exchange(dest, ok, D, cap,
                                                   [k, v])
                return (recv[0][None], recv[1][None], rvalid[None],
                        jnp.asarray(ovf)[None])
            sh = jmesh.shard_spec()
            f = jdist.shard_map(body, mesh=mesh, in_specs=(sh, sh, sh),
                                out_specs=(sh, sh, sh, sh),
                                **{jdist._SM_CHECK_KW: False})
            out = f(jnp.asarray(keys), jnp.asarray(vals),
                    jnp.asarray(valid))
            return tuple(np.asarray(x) for x in out)
        yield jshuf, run


def _port_exchange(keys, vals, valid, cap, devices=CPU):
    """Per-shard (keys, vals, valid, overflow) of the port's exchange,
    stacked [D, ...]."""
    def fn(i):
        dev = devices[i]
        k = torch.from_numpy(keys[i]).to(dev)
        v = torch.from_numpy(vals[i]).to(dev)
        ok = torch.from_numpy(valid[i]).to(dev)
        dest = shuffle.dest_of((k,), D)
        recv, rvalid, ovf = shuffle.exchange(dest, ok, D, cap, [k, v])
        return recv[0], recv[1], rvalid, ovf
    out = collective.run_sharded(devices, fn, timeout=60.0)
    return tuple(np.stack([o[j].cpu().numpy() for o in out])
                 for j in range(4))


@pytest.mark.parametrize("ncols", [1, 2])
def test_dest_of_matches_reference(ref, ncols):
    jshuf, _ = ref
    import jax.numpy as jnp
    rng = np.random.default_rng(ncols)
    cols = [rng.integers(-(1 << 62), 1 << 62, 4096).astype(np.int64)
            for _ in range(ncols)]
    cols[0][:16] = [0, -1, 1, 2 ** 31, -(2 ** 31), 2 ** 32, 7, 8,
                    9, 10, 11, 12, 13, 14, 15, 16]
    want = np.asarray(jshuf.dest_of(tuple(jnp.asarray(c) for c in cols), D))
    got = shuffle.dest_of(tuple(torch.from_numpy(c) for c in cols), D)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert set(np.unique(want)) == set(range(D))


def test_rows_land_on_hash_owner(ref):
    _, run = ref
    rng = np.random.default_rng(0)
    n_local = 64
    keys = rng.integers(0, 1000, size=(D, n_local)).astype(np.int64)
    vals = rng.integers(0, 10**6, size=(D, n_local)).astype(np.int64)
    valid = rng.random((D, n_local)) < 0.9
    rk, rv, rval, ovf = _port_exchange(keys, vals, valid, n_local)
    assert not ovf.any()
    for got, want in zip((rk, rv, rval, ovf),
                         run(keys, vals, valid, n_local)):
        assert np.array_equal(got, want)
    # every received row is on its hash owner; nothing lost or doubled
    for s in range(D):
        got = rk[s][rval[s]]
        if len(got):
            assert (shuffle.dest_of((torch.from_numpy(got),), D)
                    .numpy() == s).all()
    sent = sorted((int(k), int(v)) for k, v, ok in
                  zip(keys.reshape(-1), vals.reshape(-1),
                      valid.reshape(-1)) if ok)
    recv = sorted((int(k), int(v)) for s in range(D)
                  for k, v in zip(rk[s][rval[s]], rv[s][rval[s]]))
    assert recv == sent


def test_overflow_flag_on_skew(ref):
    # every row has the SAME key: one destination gets them all
    _, run = ref
    n_local = 32
    keys = np.zeros((D, n_local), dtype=np.int64)
    vals = np.arange(D * n_local, dtype=np.int64).reshape(D, n_local)
    valid = np.ones((D, n_local), dtype=bool)
    got = _port_exchange(keys, vals, valid, n_local // 4)
    assert got[3].all()
    for g, w in zip(got, run(keys, vals, valid, n_local // 4)):
        assert np.array_equal(g, w)


def test_empty_shards_ok(ref):
    _, run = ref
    n_local = 16
    keys = np.arange(D * n_local, dtype=np.int64).reshape(D, n_local)
    vals = keys * 10
    valid = np.zeros((D, n_local), dtype=bool)
    got = _port_exchange(keys, vals, valid, n_local)
    assert not got[3].any() and not got[2].any()
    assert np.array_equal(got[2], run(keys, vals, valid, n_local)[2])


def test_pack_for_exchange_blocks():
    """A shard's send buffer: block d holds its rows bound for d in
    local order, up to cap; the rest are dropped and flagged."""
    dest = torch.tensor([2, 0, 2, 1, 2, 0, 2], dtype=torch.int32)
    valid = torch.tensor([True, True, True, True, True, False, True])
    vals = torch.arange(7, dtype=torch.int64) * 10
    (packed,), pvalid, ovf = shuffle.pack_for_exchange(dest, valid, 3, 2,
                                                       [vals])
    assert pvalid.tolist() == [True, False, True, False, True, True]
    assert packed[pvalid].tolist() == [10, 30, 0, 20]
    assert bool(ovf)  # dest 2 had four rows for two places


def test_link_faults_fold_into_one_plan():
    class Rules:
        def __init__(self, rules):
            self.rules = rules

        def plan(self, frm, to):
            return self.rules.get((frm, to), [0.0])
    shuffle.install_link_faults(Rules({("shard:0", "shard:2"): [0.25]}), 4)
    try:
        assert shuffle.link_fault_plan() == [0.25]
        shuffle.install_link_faults(
            Rules({("shard:1", "shard:3"): [0.0, 0.0]}), 4)
        assert shuffle.link_fault_plan() == [0.0, 0.0]
        shuffle.install_link_faults(Rules({("shard:3", "shard:0"): []}), 4)
        assert shuffle.link_fault_plan() == []
    finally:
        shuffle.install_link_faults(None, 0)
    assert shuffle.link_fault_plan() is None


def test_sharded_sharded_join_matches_oracle():
    """Both sides row-sharded; each exchanged by its join key, then a
    local join per shard, and the partial sums psum-merged (the
    reference's ops-layer case)."""
    rng = np.random.default_rng(1)
    n_l, n_r = 512, 256
    lk = rng.integers(0, 200, size=n_l).astype(np.int64)
    lv = rng.integers(0, 10**6, size=n_l).astype(np.int64)
    rk = np.arange(n_r, dtype=np.int64)  # unique build keys
    rv = rng.integers(0, 10**6, size=n_r).astype(np.int64)
    cap = 2 * max(n_l, n_r) // D

    def fn(i):
        lks = torch.from_numpy(lk.reshape(D, -1)[i])
        lvs = torch.from_numpy(lv.reshape(D, -1)[i])
        rks = torch.from_numpy(rk.reshape(D, -1)[i])
        rvs = torch.from_numpy(rv.reshape(D, -1)[i])
        (lk2, lv2), lval, o1 = shuffle.exchange(
            shuffle.dest_of((lks,), D), torch.ones(lks.shape, dtype=torch.bool),
            D, cap, [lks, lvs])
        (rk2, rv2), rval, o2 = shuffle.exchange(
            shuffle.dest_of((rks,), D), torch.ones(rks.shape, dtype=torch.bool),
            D, cap, [rks, rvs])
        ones_l = torch.ones(lval.shape, dtype=torch.bool)
        ones_r = torch.ones(rval.shape, dtype=torch.bool)
        probe = ColumnBatch((lk2, lv2), (ones_l, ones_l), lval, ("k", "v"))
        build = ColumnBatch((rk2, rv2), (ones_r, ones_r), rval, ("k", "w"))
        out = hash_join(probe, build, ["k"], ["k"], ["w"], "inner")
        m = out.sel
        tot = torch.where(m, out.col("v") + out.col("w"), 0).sum()
        return (AXIS.psum(tot.reshape(1))[0],
                AXIS.psum(m.sum().reshape(1))[0], bool(o1 or o2))
    tot, cnt, ovf = collective.run_sharded(CPU, fn, timeout=60.0)[0]
    assert not ovf
    rmap = {int(k): int(v) for k, v in zip(rk, rv)}
    pairs = [int(v) + rmap[int(k)] for k, v in zip(lk, lv) if int(k) in rmap]
    assert int(cnt) == len(pairs)
    assert int(tot) == sum(pairs)


@pytest.mark.gpu
def test_exchange_on_card_matches_cpu():
    """Eight shard slots on one card exchange what eight CPU slots do."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1000, size=(D, 256)).astype(np.int64)
    vals = rng.integers(0, 10**6, size=(D, 256)).astype(np.int64)
    valid = rng.random((D, 256)) < 0.9
    want = _port_exchange(keys, vals, valid, 256)
    got = _port_exchange(keys, vals, valid, 256,
                         [torch.device("cuda", 0)] * D)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
