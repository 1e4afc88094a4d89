"""The port's multi-host pod against the reference's
(tests/test_multihost.py).

Three layers:

1. In-process units: the merge-tree topology (against the reference
   module's answers), the degenerate single-process rendezvous
   (in-process KV store with CAS and listing, idempotent init and
   shutdown, LIFO teardowns), ``env_topology``, and the pod hooks of the
   mesh and the engine (the ``exec.multihost.hosts`` gauge, the
   rendezvous torn down by ``Engine.close``, the rendezvous domain in the
   gate key, ``MeshPool.num_hosts``, ``pod_mesh``, the upload guard).
2. The control plane over ``torch.distributed.TCPStore`` in two
   processes: address exchange, barriers, and ``kv_cas``/``kv_list``
   refused on the pod store as the reference refuses them.
3. Real multi-process pods: ``python -m cockroach_tpu_torch.server.hostd
   --device cpu`` subprocesses rendezvous on localhost, each owning its
   shard of lineitem, and ship partial-agg streams over the socket
   fabric's host merge tree. Tier-1 runs the 2-process pod, whose rows
   equal one reference ``Engine``'s over the same generated data
   exactly (DECIMAL sums as their decimal strings, Q14's FLOAT8 as the
   same float); the 4-process ladder, flat fan-in and the fault modes
   are ``slow``, as in the reference; one ``gpu`` case runs the pod on
   the card.
"""

import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

from cockroach_tpu_torch.parallel import mesh as meshmod
from cockroach_tpu_torch.parallel import multihost
from cockroach_tpu_torch.server.hostd import GROUPBY_SQL, _jsonable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROWS = 600
POD_TIMEOUT_S = 300.0


@pytest.fixture(scope="module")
def ref_mh():
    from tests.test_torch_groupagg_large import reference_modules
    with reference_modules("cockroach_tpu.parallel.multihost") as (m,):
        yield m


@pytest.fixture(autouse=True)
def _no_live_rendezvous():
    multihost.shutdown_distributed()
    yield
    multihost.shutdown_distributed()


# ---------------------------------------------------------------------------
# merge-tree topology
# ---------------------------------------------------------------------------

class TestTreeTopology:
    def test_gateway_has_no_parent(self):
        assert multihost.tree_parent(0) is None
        assert multihost.tree_parent(0, fanout=7) is None

    def test_heap_layout_small_pod(self):
        assert multihost.tree_children(0, 7, 2) == [1, 2]
        assert multihost.tree_children(1, 7, 2) == [3, 4]
        assert multihost.tree_children(2, 7, 2) == [5, 6]
        assert multihost.tree_children(3, 7, 2) == []

    @pytest.mark.parametrize("n,f", [(2, 1), (4, 2), (7, 2), (9, 3),
                                     (16, 4)])
    def test_parent_child_consistency(self, n, f):
        for pid in range(1, n):
            parent = multihost.tree_parent(pid, f)
            assert pid in multihost.tree_children(parent, n, f)
        seen = [k for p in range(n)
                for k in multihost.tree_children(p, n, f)]
        assert sorted(seen) == list(range(1, n))

    def test_merge_depth(self):
        assert multihost.merge_depth(1, 2) == 0
        assert multihost.merge_depth(2, 2) == 1
        assert multihost.merge_depth(3, 2) == 1
        assert multihost.merge_depth(7, 2) == 2
        assert multihost.merge_depth(4, 8) == 1

    @pytest.mark.parametrize("f", [0, 1, 2, 3, 5])
    def test_answers_are_the_references(self, ref_mh, f):
        for n in range(1, 40):
            assert multihost.merge_depth(n, f) == ref_mh.merge_depth(n, f)
            for pid in range(n):
                assert multihost.tree_parent(pid, f) == \
                    ref_mh.tree_parent(pid, f)
                assert multihost.tree_children(pid, n, f) == \
                    ref_mh.tree_children(pid, n, f)
                mine = multihost.HostTopology(pid, n, fanout=max(1, f))
                ref = ref_mh.HostTopology(pid, n, fanout=max(1, f))
                assert (mine.parent(), mine.children(), mine.is_gateway) \
                    == (ref.parent(), ref.children(), ref.is_gateway)


# ---------------------------------------------------------------------------
# degenerate single-process rendezvous
# ---------------------------------------------------------------------------

class TestDegeneratePod:
    def test_kv_roundtrip_and_idempotence(self):
        assert not multihost.is_active()
        topo = multihost.init_distributed(num_processes=1)
        try:
            assert topo.is_gateway
            assert multihost.num_hosts() == 1
            assert multihost.init_distributed(num_processes=1) is topo
            multihost.kv_set("probe", "42")
            assert multihost.kv_get("probe") == "42"
            assert multihost.kv_try_get("probe") == "42"
            assert multihost.kv_try_get("absent") is None
            multihost.barrier("ready")
            with pytest.raises(RuntimeError, match="already initialized"):
                multihost.init_distributed(num_processes=2, process_id=1)
        finally:
            multihost.shutdown_distributed()
        assert not multihost.is_active()
        assert multihost.num_hosts() == 1

    def test_cas_and_list_like_the_references(self, ref_mh):
        """The in-process store's CAS and listing give the reference's
        answers for one script of operations."""
        def script(mh):
            mh.init_distributed(num_processes=1)
            try:
                out = [mh.kv_cas("e", None, "1"), mh.kv_cas("e", None, "2"),
                       mh.kv_cas("e", "1", "2"), mh.kv_cas("e", "1", "3"),
                       mh.kv_try_get("e")]
                for i in range(3):
                    mh.kv_set(f"flowaddr/{i}", f"h:{i}")
                mh.kv_set("other/x", "y")
                out.append(mh.kv_list("flowaddr/"))
                mh.publish_flow_addr("127.0.0.1", 5)
                out.append(mh.kv_get("flowaddr/0"))
                return out
            finally:
                mh.shutdown_distributed()
        assert script(multihost) == script(ref_mh)

    def test_teardowns_run_lifo_once(self):
        order = []
        multihost.init_distributed(num_processes=1)
        multihost.register_teardown(lambda: order.append("a"))
        multihost.register_teardown(lambda: 1 / 0)   # swallowed
        multihost.register_teardown(lambda: order.append("b"))
        multihost.shutdown_distributed()
        assert order == ["b", "a"]
        multihost.shutdown_distributed()
        assert order == ["b", "a"]

    def test_env_topology(self, monkeypatch, ref_mh):
        assert multihost.env_topology() is None
        monkeypatch.setenv("COCKROACH_TPU_MULTIHOST_PROCS", "4")
        monkeypatch.setenv("COCKROACH_TPU_MULTIHOST_ID", "3")
        monkeypatch.setenv("COCKROACH_TPU_MULTIHOST_COORD",
                           "127.0.0.1:9999")
        t = multihost.env_topology()
        assert (t.num_processes, t.process_id) == (4, 3)
        assert t.parent() == 1 and not t.is_gateway
        r = ref_mh.env_topology()
        assert (t.process_id, t.num_processes, t.coordinator, t.fanout) \
            == (r.process_id, r.num_processes, r.coordinator, r.fanout)

    def test_bad_coordinator_refused(self):
        with pytest.raises(ValueError, match="host:port"):
            multihost.init_distributed("nowhere", num_processes=2)
        assert not multihost.is_active()


# ---------------------------------------------------------------------------
# the pod's hooks in the mesh and the engine
# ---------------------------------------------------------------------------

class TestPodHooks:
    def test_engine_gauge_and_close_tears_down(self):
        from cockroach_tpu_torch.exec.engine import Engine
        eng = Engine(device="cpu")
        assert eng.metrics.snapshot()["exec.multihost.hosts"] == 1
        multihost.init_distributed(num_processes=1)
        torn = []
        multihost.register_teardown(lambda: torn.append(1))
        eng.close()
        assert torn == [1] and not multihost.is_active()

    def test_gate_key_and_pool_read_the_rendezvous(self, monkeypatch):
        cpu = torch.device("cpu")
        m = meshmod.make_mesh([cpu] * 4)
        assert meshmod._devkey(m)[0] == -1
        monkeypatch.setattr(multihost, "_TOPOLOGY",
                            multihost.HostTopology(1, 2))
        assert meshmod._devkey(m)[0] == 1
        assert meshmod.MeshPool(m).num_hosts == 2

    def test_pod_mesh_is_host_local(self):
        assert multihost.global_mesh("cpu") == [torch.device("cpu")]
        pm = meshmod.pod_mesh("cpu")
        assert pm.size == 1 and pm.devices == (torch.device("cpu"),)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                multihost.global_mesh()

    @pytest.mark.skipif(torch.cuda.is_available(),
                        reason="needs a slot this process cannot address")
    def test_upload_to_unaddressable_slot_refused_on_a_pod(
            self, monkeypatch):
        from cockroach_tpu_torch.exec.engine import Engine, EngineError
        eng = Engine(device="cpu")
        eng.execute("CREATE TABLE t (a INT)")
        eng.execute("INSERT INTO t VALUES (1), (2)")
        mesh = meshmod.Mesh([torch.device("cpu"), torch.device("cuda", 3)])
        monkeypatch.setattr(multihost, "num_hosts", lambda: 2)
        with pytest.raises(EngineError, match="cannot address"):
            eng._device_table("t", frozenset({"a"}), "sharded", mesh)
        assert multihost.addressable("cpu")
        assert not multihost.addressable("cuda:3")


# ---------------------------------------------------------------------------
# the control plane over a TCPStore, in two processes
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # test files run several at once: one or two threads each
    env["OMP_NUM_THREADS"] = "2"
    env["TORCH_CPP_LOG_LEVEL"] = "ERROR"
    return env


_STORE_CHILD = r"""
import json, sys
from cockroach_tpu_torch.parallel import multihost as mh
pid, port = int(sys.argv[1]), int(sys.argv[2])
mh.init_distributed(f"127.0.0.1:{port}", 2, pid)
mh.publish_flow_addr("127.0.0.1", 1000 + pid)
out = {"peers": {str(k): list(v) for k, v in mh.peer_flow_addrs(30).items()},
       "hosts": mh.num_hosts()}
for r in range(3):
    mh.kv_set(f"round/{r}/{pid}", str(r))
    mh.barrier("step")
    out.setdefault("rounds", []).append(mh.kv_try_get(f"round/{r}/{1 - pid}"))
for name, fn in (("cas", lambda: mh.kv_cas("k", None, "v")),
                 ("list", lambda: mh.kv_list("round/"))):
    try:
        fn()
        out[name] = "allowed"
    except RuntimeError as e:
        out[name] = str(e)
try:
    mh.kv_get("never", timeout_s=0.2)
except KeyError:
    out["timeout"] = "KeyError"
mh.barrier("bye")
print(json.dumps(out), flush=True)
mh.shutdown_distributed()
"""


def test_tcpstore_control_plane():
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _STORE_CHILD, str(pid), str(port)],
        env=_child_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in (1, 0)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for o in outs:
        assert o["peers"] == {"0": ["127.0.0.1", 1000],
                              "1": ["127.0.0.1", 1001]}
        assert o["hosts"] == 2
        # each round's barrier passed only after both hosts wrote it
        assert o["rounds"] == ["0", "1", "2"]
        assert "no conditional write" in o["cas"]
        assert "in-process" in o["list"]
        assert o["timeout"] == "KeyError"


_LATE_CHILD = r"""
import sys, time
from cockroach_tpu_torch.parallel import multihost as mh
pid, port = int(sys.argv[1]), int(sys.argv[2])
mh.init_distributed(f"127.0.0.1:{port}", 2, pid)


class _Late:
    # host 1 reads the last barrier's release only after host 0 passed it
    def __init__(self, store):
        self.store = store

    def __getattr__(self, name):
        return getattr(self.store, name)

    def wait(self, keys, *args):
        if any("barrier/bye/release" in k for k in keys):
            time.sleep(2.0)
        return self.store.wait(keys, *args)


if pid == 1:
    mh._STORE = _Late(mh._STORE)
mh.barrier("bye")
mh.shutdown_distributed()
print("left", flush=True)
"""


def test_host0_serves_the_store_until_every_host_left():
    """Host 0 arrives last at the last barrier and shuts down at once:
    the store it serves must outlive host 1's read of that barrier's
    release (the shutdown barrier), or host 1 fails on a closed
    connection."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LATE_CHILD, str(pid), str(port)],
        env=_child_env(), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in (1, 0)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-3000:]
            assert out.strip().splitlines()[-1] == "left"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


# ---------------------------------------------------------------------------
# real multi-process pods
# ---------------------------------------------------------------------------

def run_pod(nprocs: int, *, fanout: int = 2, rows: int = ROWS,
            queries: str = "groupby,join", flow_timeout: float = 60.0,
            fault: str = "none", device: str = "cpu",
            timeout: float = POD_TIMEOUT_S) -> dict:
    """Spawn an N-process hostd pod on localhost and return host 0's
    JSON result line (results + per-host metric slices)."""
    port = _free_port()

    def cmd(pid):
        return [sys.executable, "-m", "cockroach_tpu_torch.server.hostd",
                "--process-id", str(pid),
                "--num-processes", str(nprocs),
                "--coordinator", f"127.0.0.1:{port}",
                "--fanout", str(fanout), "--rows", str(rows),
                "--device", device, "--queries", queries,
                "--flow-timeout", str(flow_timeout),
                "--fault", fault]

    env = _child_env()
    workers = [subprocess.Popen(cmd(pid), env=env, cwd=REPO,
                                stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
               for pid in range(1, nprocs)]
    try:
        proc = subprocess.run(cmd(0), env=env, cwd=REPO,
                              capture_output=True, text=True,
                              timeout=timeout)
    finally:
        deadline = time.monotonic() + 30.0
        for w in workers:
            try:
                w.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                w.kill()
                w.wait()
    assert proc.returncode == 0, \
        f"gateway host failed:\n{proc.stdout}\n{proc.stderr[-4000:]}"
    assert all(w.returncode == 0 for w in workers), \
        [w.returncode for w in workers]
    line = next((ln for ln in proc.stdout.splitlines()
                 if ln.startswith("{")), None)
    assert line, f"no result line on stdout:\n{proc.stdout}"
    return json.loads(line)


@pytest.fixture(scope="module")
def pod_oracle():
    """One reference Engine over the SAME generated data the pod shards
    across hosts: the exact reference."""
    from tests.test_torch_distsql_flows import reference
    with reference() as (jeng, _jnode, _jtr, jtpch):
        eng = jeng.Engine()
        eng.execute(jtpch.DDL["lineitem"])
        eng.execute(jtpch.DDL["part"])
        ts = eng.clock.now()
        eng.store.insert_columns(
            "lineitem", jtpch.gen_lineitem(0.01, rows=ROWS), ts)
        eng.store.insert_columns("part", jtpch.gen_part(0.01), ts)
        rows = {name: [[_jsonable(v) for v in r]
                       for r in eng.execute(sql).rows]
                for name, sql in (("groupby", GROUPBY_SQL),
                                  ("join", jtpch.Q14))}
        eng.close()
    return rows


class TestTwoHostPod:
    """Tier-1: one 2-process pod, rows equal to the reference engine's,
    the merge tree engaged."""

    @pytest.fixture(scope="class")
    def pod(self):
        return run_pod(2, fanout=2, queries="groupby,join")

    def test_groupby_equals_the_reference(self, pod, pod_oracle):
        assert "error" not in pod["results"]["groupby"]
        assert pod["results"]["groupby"]["rows"] == pod_oracle["groupby"]
        assert pod["results"]["groupby"]["names"] == [
            "l_returnflag", "l_linestatus", "sum_qty", "sum_base_price",
            "count_order"]

    def test_join_equals_the_reference(self, pod, pod_oracle):
        assert "error" not in pod["results"]["join"]
        assert pod["results"]["join"]["rows"] == pod_oracle["join"]

    def test_tree_and_rendezvous_metrics(self, pod):
        m0 = pod["metrics"]["0"]
        assert m0["exec.multihost.hosts"] == 2
        assert m0["distsql.flows.tree"] >= 1
        # 2 hosts, fanout 2: stream 1 merges on the gateway's own node
        assert m0["exec.multihost.flows.merged"] >= 1
        assert m0["exec.multihost.merge.bytes"] > 0
        m1 = pod["metrics"]["1"]
        assert m1["exec.multihost.hosts"] == 2
        assert m1["shuffle.bytes.sent"] > 0
        assert m1["rpc.frames.sent"] > 0
        assert pod["hosts"] == 2 and pod["rows"] == ROWS


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_hostd_without_a_card_raises():
    """--device defaults to the card: without one, hostd fails instead
    of running on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "cockroach_tpu_torch.server.hostd",
         "--rows", "10"], env=_child_env(), cwd=REPO,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr or "cuda" in proc.stderr


@pytest.mark.slow
class TestPodLadder:
    def test_four_hosts_with_interior_merge(self, pod_oracle):
        pod = run_pod(4, fanout=2, queries="groupby")
        assert pod["results"]["groupby"]["rows"] == pod_oracle["groupby"]
        # heap layout: host 1 is interior (its child 3) and must have
        # tree-merged, so its upward stream replaced its child's
        m = pod["metrics"]
        assert m["1"]["exec.multihost.flows.merged"] >= 1
        assert m["1"]["exec.multihost.merge.bytes"] > 0
        assert m["0"]["exec.multihost.hosts"] == 4

    def test_flat_fanin_matches_tree(self, pod_oracle):
        pod = run_pod(2, fanout=0, queries="groupby")
        assert pod["results"]["groupby"]["rows"] == pod_oracle["groupby"]
        assert pod["metrics"]["0"].get("distsql.flows.tree", 0) == 0


@pytest.mark.slow
class TestPodFaults:
    """A dead dispatcher or a dropped merge link surfaces as a clean
    typed error on the gateway within the flow timeout: never a hang,
    never a wrong answer."""

    def _assert_clean_failure(self, pod, nprocs):
        err = pod["results"]["groupby"].get("error", "")
        assert "FlowUnavailable" in err, pod["results"]
        assert "stalled" in err
        assert pod["metrics"]["0"]["exec.multihost.hosts"] == nprocs

    def test_dispatcher_death(self):
        pod = run_pod(3, fanout=2, queries="groupby",
                      flow_timeout=8.0, fault="dispatcher-death")
        self._assert_clean_failure(pod, 3)

    def test_dropped_merge_link(self):
        pod = run_pod(3, fanout=2, queries="groupby",
                      flow_timeout=8.0, fault="drop-link")
        self._assert_clean_failure(pod, 3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_two_host_pod_on_the_card(cuda):
    """Both hosts on cuda:0, each with its own CUDA context: rows equal
    one port engine's on the card over the whole generated tables (no
    JAX on the card's machine)."""
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.server.hostd import _build_engine
    pod = run_pod(2, fanout=2, queries="groupby,join", device="cuda")
    one, _n = _build_engine(0, 1, ROWS)
    for name, sql in (("groupby", GROUPBY_SQL), ("join", tpch.Q14)):
        want = [[_jsonable(v) for v in r] for r in one.execute(sql).rows]
        assert pod["results"][name]["rows"] == want
    one.close()
    assert pod["metrics"]["0"]["exec.multihost.hosts"] == 2
    assert pod["metrics"]["1"]["rpc.frames.sent"] > 0
