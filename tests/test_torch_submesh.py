"""Sub-mesh dispatch (tests/test_submesh.py's cases, on the port): the
MeshPool carves the 8-slot CPU mesh into disjoint power-of-two
sub-meshes, the engine's _DistRouter routes each distributed dispatch
onto the full mesh or the least-loaded sub-mesh under
``sql.exec.submesh.size``, and rows are the same at every size: equal
to the full mesh's, to one device's and to the reference's 8-device
mesh on the same statements.
"""

import random
import threading

import pytest
import torch

from cockroach_tpu_torch.exec.engine import Engine, _DistRouter
from cockroach_tpu_torch.parallel import distagg
from cockroach_tpu_torch.parallel.mesh import MeshPool, _DomainGate, make_mesh

ROWS = 3000
CPU8 = [torch.device("cpu")] * 8
AGGS = ("sum(v)", "count(*)", "min(v)", "max(v)", "min(w)", "max(w)")
JOIN = ("SELECT tag, count(*), sum(v) FROM fact JOIN dim ON fact.g = dim.g "
        "WHERE v > 250 GROUP BY tag ORDER BY tag")


def _setup() -> list:
    rng = random.Random(7)
    vals = ",".join(
        f"({i},{rng.randrange(1000)},{rng.random() * 100:.3f},"
        f"{i % 7},{i % 3})" for i in range(ROWS))
    return ["CREATE TABLE fact (k INT PRIMARY KEY, v INT, w FLOAT, "
            "g INT, h INT)",
            f"INSERT INTO fact (k, v, w, g, h) VALUES {vals}",
            "CREATE TABLE dim (g INT PRIMARY KEY, tag INT)",
            "INSERT INTO dim (g, tag) VALUES "
            + ",".join(f"({i},{i % 2})" for i in range(7))]


def _fuzzed() -> list:
    """Distributed GROUP BYs whose aggregates are exact at any shard
    count (int sums, count, min/max), and a join with a replicated
    build side."""
    rng = random.Random(1234)
    out = []
    for _ in range(2):
        a1, a2 = rng.sample(AGGS, 2)
        key = rng.choice(("g", "h"))
        lit = rng.randrange(100, 900)
        out.append(f"SELECT {key}, {a1}, {a2} FROM fact WHERE v > {lit} "
                   f"GROUP BY {key} ORDER BY {key}")
    return out + [JOIN]


@pytest.fixture(scope="module")
def reference():
    # imported here: the card-only case runs without the reference
    from tests.test_torch_groupagg_large import reference_modules
    with reference_modules("cockroach_tpu.exec.engine") as (jeng,):
        e = jeng.Engine()
        try:
            assert e.mesh is not None and e.mesh.size == 8
            for stmt in _setup():
                e.execute(stmt)
            return {q: e.execute(q).rows for q in _fuzzed()}
        finally:
            e.close()


@pytest.fixture(scope="module")
def eng():
    e = Engine(device="cpu", mesh=make_mesh(CPU8))
    for stmt in _setup():
        e.execute(stmt)
    yield e
    e.settings.set("sql.exec.submesh.size", "auto")
    e.close()


class TestMeshPool:
    def test_partitions_are_disjoint_pow2_covers(self):
        pool = MeshPool(make_mesh(CPU8))
        assert pool.sizes() == [4, 2, 1] and pool.num_hosts == 1
        for s in pool.sizes():
            subs = pool.submeshes(s)
            assert len(subs) == pool.count(s) == 8 // s
            assert all(len(m.ids) == s and m.size == s for m in subs)
            assert sorted(i for m in subs for i in m.ids) == \
                list(range(8))  # disjoint, full cover

    def test_acquire_rotates_ties_and_tracks_load(self):
        pool = MeshPool(make_mesh(CPU8))
        toks = [pool.acquire(2)[1] for _ in range(4)]
        assert sorted(t[1] for t in toks) == [0, 1, 2, 3]
        assert pool.occupancy() == 4
        for t in toks:
            pool.release(t)
        assert pool.occupancy() == 0
        _, busy = pool.acquire(4)
        _, other = pool.acquire(4)
        assert other[1] != busy[1]
        pool.release(busy)
        pool.release(other)
        assert pool.dispatches == 4 + 2

    def test_release_never_goes_negative(self):
        pool = MeshPool(make_mesh(CPU8))
        _, t = pool.acquire(4)
        pool.release(t)
        pool.release(t)
        assert pool.occupancy() == 0

    def test_make_mesh_refuses_to_truncate(self):
        with pytest.raises(RuntimeError, match="truncate"):
            make_mesh(CPU8[:2], n=4)
        assert make_mesh(CPU8, n=4).size == 4

    def test_domain_gate_excludes_cross_mode_shares_same_mode(self):
        gate = _DomainGate()
        order = []
        entered = threading.Event()
        release = threading.Event()

        def sub_holder():
            with gate.window("sub"):
                order.append("sub1")
                entered.set()
                release.wait(5)

        def root_entrant():
            with gate.window("root"):
                order.append("root")

        t1 = threading.Thread(target=sub_holder)
        t1.start()
        assert entered.wait(5)
        t2 = threading.Thread(target=root_entrant)
        t2.start()
        t2.join(0.2)
        assert t2.is_alive() and order == ["sub1"]
        # a second sub entry queues behind the waiting root
        second = threading.Event()

        def sub_second():
            with gate.window("sub"):
                second.set()
        t3 = threading.Thread(target=sub_second)
        t3.start()
        t3.join(0.2)
        assert t3.is_alive()
        release.set()
        for t in (t1, t2, t3):
            t.join(5)
            assert not t.is_alive()
        assert order == ["sub1", "root"] and second.is_set()


class TestSubmeshRouting:
    Q = "SELECT g, sum(v) FROM fact GROUP BY g ORDER BY g"

    def test_explicit_size_routes_through_pool(self, eng):
        pool = eng._submesh_pool()
        assert pool is not None
        base = pool.dispatches
        eng.settings.set("sql.exec.submesh.size", "2")
        try:
            eng.execute(self.Q)
        finally:
            eng.settings.set("sql.exec.submesh.size", "auto")
        assert pool.dispatches == base + 1

    def test_off_and_idle_auto_stay_on_full_mesh(self, eng):
        pool = eng._submesh_pool()
        for mode in ("off", "auto"):
            eng.settings.set("sql.exec.submesh.size", mode)
            base = pool.dispatches
            eng.execute(self.Q)
            assert pool.dispatches == base, mode
        eng.settings.set("sql.exec.submesh.size", "auto")

    def test_busy_auto_takes_the_smallest_fitting_size(self, eng):
        r = _DistRouter(eng, None, None, {}, None, [],
                        sharded_bytes=1 << 10, repl_bytes=0)
        pool = eng._submesh_pool()
        eng.settings.set("sql.exec.submesh.size", "auto")
        assert r._target_size() is None  # idle
        _, tok = pool.acquire(4)
        try:
            assert r._target_size() == 1
        finally:
            pool.release(tok)

    def test_oversized_working_set_escalates_to_full_mesh(self, eng):
        r = _DistRouter(eng, None, None, {}, None, [],
                        sharded_bytes=10 ** 15, repl_bytes=0)
        eng.settings.set("sql.exec.submesh.size", "2")
        try:
            assert r._target_size() is None
        finally:
            eng.settings.set("sql.exec.submesh.size", "auto")

    def test_small_working_set_takes_requested_size(self, eng):
        r = _DistRouter(eng, None, None, {}, None, [],
                        sharded_bytes=1 << 10, repl_bytes=0)
        eng.settings.set("sql.exec.submesh.size", "2")
        try:
            assert r._target_size() == 2
        finally:
            eng.settings.set("sql.exec.submesh.size", "auto")

    def test_setting_refuses_non_powers_of_two(self, eng):
        from cockroach_tpu_torch.utils.settings import SettingError
        for bad in ("3", "zero", "0"):
            with pytest.raises(SettingError):
                eng.settings.set("sql.exec.submesh.size", bad)

    def test_submesh_metrics_registered(self, eng):
        eng._submesh_pool()
        assert eng.metrics.get("exec.submesh.count").value() == 2 + 4 + 8
        assert eng.metrics.get("exec.submesh.dispatches").value() >= 0
        assert eng.metrics.get("exec.submesh.occupancy").value() == 0

    def test_placement_is_per_target_mesh(self, eng):
        """A table placed on sub-mesh A never serves sub-mesh B: each
        has its own MeshBatch, of its own slot count; on one device the
        slices are views of the resident copy."""
        pool = eng._submesh_pool()
        a, b = pool.submeshes(4)
        cols = frozenset({"g", "v"})
        ma = eng._device_table("fact", cols, "sharded", a)
        mb = eng._device_table("fact", cols, "sharded", b)
        assert ma is not mb and len(ma.shards) == len(mb.shards) == 4
        assert ma is eng._device_table("fact", cols, "sharded", a)
        base = eng._device_table("fact", cols)
        assert sum(s.n for s in ma.shards) == base.n
        assert ma.shards[0].sel.data_ptr() == base.sel.data_ptr()
        full = eng._device_table("fact", cols, "replicated")
        assert all(s is base for s in full.shards)


class TestSubmeshParity:
    def test_fuzzed_groupby_parity_across_sizes(self, reference, eng):
        s = eng.session()
        try:
            for q in _fuzzed():
                eng.settings.set("sql.exec.submesh.size", "off")
                want = eng.execute(q, s).rows
                assert want == reference[q], q
                for size in ("4", "2", "1"):
                    eng.settings.set("sql.exec.submesh.size", size)
                    assert eng.execute(q, s).rows == want, (q, size)
            local = eng.session()
            eng.execute("SET distsql = off", local)
            for q in _fuzzed():
                assert eng.execute(q, local).rows == reference[q], q
        finally:
            eng.settings.set("sql.exec.submesh.size", "auto")

    def test_concurrent_sessions_on_disjoint_submeshes(self, eng):
        """Two sessions dispatch onto 4-slot sub-meshes concurrently
        (disjoint rendezvous domains) and agree with serial runs."""
        q_a = "SELECT g, sum(v) FROM fact GROUP BY g ORDER BY g"
        q_b = ("SELECT h, count(*) FROM fact WHERE v > 111 "
               "GROUP BY h ORDER BY h")
        eng.settings.set("sql.exec.submesh.size", "off")
        want = {q: eng.execute(q).rows for q in (q_a, q_b)}
        eng.settings.set("sql.exec.submesh.size", "4")
        results: dict = {}
        errors: list = []

        def run(q):
            try:
                s = eng.session()
                for _ in range(4):
                    results[q] = eng.execute(q, s).rows
            except BaseException as e:  # noqa: BLE001 - surfaced below
                errors.append(e)

        try:
            ts = [threading.Thread(target=run, args=(q,))
                  for q in (q_a, q_b)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in ts), \
                "concurrent sub-mesh dispatch deadlocked"
            assert not errors, errors
            assert results == want
        finally:
            eng.settings.set("sql.exec.submesh.size", "auto")

    def test_close_retires_threads_and_respawns_on_demand(self, eng):
        d = distagg._dispatcher_for(eng.mesh)
        eng.execute("SELECT g, count(*) FROM fact GROUP BY g ORDER BY g")
        eng.close()
        assert not d._thread.is_alive()
        rows = eng.execute(
            "SELECT g, count(*) FROM fact GROUP BY g ORDER BY g").rows
        assert len(rows) == 7
        assert d is distagg._dispatcher_for(eng.mesh)
        assert d._thread.is_alive()


@pytest.mark.gpu
def test_submesh_on_card_matches_full_mesh():
    """Four shard slots on one card: Q on the 2-slot sub-meshes equals
    the full mesh's rows, routed through the pool."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    e = Engine(mesh=make_mesh([torch.device("cuda", 0)] * 4))
    try:
        for stmt in _setup():
            e.execute(stmt)
        q = TestSubmeshRouting.Q
        e.settings.set("sql.exec.submesh.size", "off")
        want = e.execute(q).rows
        pool = e._submesh_pool()
        base = pool.dispatches
        e.settings.set("sql.exec.submesh.size", "2")
        assert e.execute(q).rows == want
        assert pool.dispatches == base + 1
    finally:
        e.close()
