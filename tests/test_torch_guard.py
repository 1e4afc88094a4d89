"""Guards on the PyTorch port's boundaries.

- No module of cockroach_tpu_torch, and not chip_smoke.py, imports
  jax or anything of the JAX package (an AST scan of every import).
- Entry points never quietly fall back to the CPU: without a card and
  without an explicit device, Engine(), the server's Node and the CLI's
  start, demo and workload raise, and the kernel wrapper takes its
  plain version only for CPU tensors.
- The OLTP lane's native row mirror (native/oltp.cpp) builds into
  ``_build/``, never beside its source, and a failed build raises: the
  lane is never turned off in silence.
"""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "cockroach_tpu")


def _port_files():
    files = sorted((ROOT / "cockroach_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py"]
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_scan_covers_the_package():
    names = {p.name for p in _port_files()}
    assert {"engine.py", "compile.py", "groupagg_large.py", "groupagg.py",
            "hashtable.py", "join.py", "chip_smoke.py", "oltplane.py",
            "oltpbatch.py", "rwlock.py", "ycsb.py",
            # the front door
            "pgwire.py", "pgfront.py", "miniclient.py", "node.py", "ts.py",
            "cli.py", "__main__.py", "log.py", "sqlstats.py",
            "admission.py", "tenantcache.py", "tpcc.py", "bank.py",
            "kvload.py", "movr.py", "ssb.py",
            # the operator's planes, composed CTEs, test-time checks
            "profile.py", "ctecompose.py", "explain.py", "tracing.py",
            "stmtdiag.py", "invariants.py", "metamorphic.py"} <= names
    server = ROOT / "cockroach_tpu_torch" / "server"
    assert {p.name for p in _port_files() if p.parent == server} == {
        "__init__.py", "pgwire.py", "pgfront.py", "miniclient.py",
        "node.py", "ts.py", "hostd.py"}
    assert ROOT / "cockroach_tpu_torch" / "native" / "__init__.py" in \
        _port_files()


def test_port_scan_covers_jobs_and_cdc():
    """The import scan reaches every module of jobs/ and cdc/."""
    pkg = ROOT / "cockroach_tpu_torch"
    scanned = set(_port_files())
    for sub, names in (("jobs", {"__init__.py", "registry.py",
                                 "schemachange.py", "backup.py", "ttl.py",
                                 "import_job.py"}),
                       ("cdc", {"__init__.py", "changefeed.py"})):
        assert {p.name for p in (pkg / sub).glob("*.py")} == names
        assert {pkg / sub / n for n in names} <= scanned


def test_port_scan_covers_parallel():
    """The import scan reaches every module of parallel/ (the mesh, its
    collectives, the distribution decision, the shuffle and the pod's
    rendezvous), and none of
    them imports jax or the JAX package, directly or through a module
    of the port they load."""
    import importlib
    import sys
    pkg = ROOT / "cockroach_tpu_torch"
    names = {"__init__.py", "mesh.py", "collective.py", "distagg.py",
             "shuffle.py", "multihost.py"}
    assert {p.name for p in (pkg / "parallel").glob("*.py")} == names
    assert {pkg / "parallel" / n for n in names} <= set(_port_files())
    for n in sorted(names - {"__init__.py"}):
        path = pkg / "parallel" / n
        assert not set(_imported_roots(path)) & set(FORBIDDEN), n
        m = importlib.import_module(f"cockroach_tpu_torch.parallel.{n[:-3]}")
        assert Path(m.__file__) == path
    loaded = [name for name, m in list(sys.modules.items())
              if name.startswith("cockroach_tpu_torch.")
              and getattr(m, "__file__", None)]
    for name in loaded:
        path = Path(sys.modules[name].__file__)
        if path.suffix == ".py":
            assert not set(_imported_roots(path)) & set(FORBIDDEN), name


def test_port_scan_covers_distsql():
    """The import scan reaches every module of distsql/, kvserver/ and
    kv/ (serde, flow, physical, shuffle, node, the shard leases; the
    transport, raft, stores, the range cluster, liveness, rangefeeds,
    the cluster over TCP and its versions; the txn plane, DistSender, the range cache, rangekv, disttxn,
    rowfetch), and none of them imports jax or the JAX package, directly
    or through a module of the port they load."""
    import importlib
    import sys
    pkg = ROOT / "cockroach_tpu_torch"
    for sub, names in (("distsql", {"__init__.py", "serde.py", "flow.py",
                                    "physical.py", "shuffle.py",
                                    "node.py", "leases.py"}),
                       ("kvserver", {"__init__.py", "transport.py",
                                     "raft.py", "store.py", "cluster.py",
                                     "liveness.py", "rangefeed.py",
                                     "netcluster.py",
                                     "clusterversion.py"}),
                       ("kv", {"__init__.py", "concurrency.py", "txn.py",
                               "intentresolver.py", "protectedts.py",
                               "rangecache.py", "distsender.py",
                               "rangekv.py", "disttxn.py",
                               "rowfetch.py"})):
        assert {p.name for p in (pkg / sub).glob("*.py")} == names
        assert {pkg / sub / n for n in names} <= set(_port_files())
        for n in sorted(names):
            path = pkg / sub / n
            assert not set(_imported_roots(path)) & set(FORBIDDEN), n
            mod = (f"cockroach_tpu_torch.{sub}" if n == "__init__.py"
                   else f"cockroach_tpu_torch.{sub}.{n[:-3]}")
            assert Path(importlib.import_module(mod).__file__) == path
    loaded = [name for name, m in list(sys.modules.items())
              if name.startswith("cockroach_tpu_torch.")
              and getattr(m, "__file__", None)]
    for name in loaded:
        path = Path(sys.modules[name].__file__)
        if path.suffix == ".py":
            assert not set(_imported_roots(path)) & set(FORBIDDEN), name


def test_port_scan_covers_the_fabric_and_the_pod():
    """The import scan reaches every module of rpc/ (the socket
    transport and codec, gossip, heartbeats, retry), utils/circuit.py,
    parallel/multihost.py and server/hostd.py, and none of them imports
    jax or the JAX package, directly or through a module of the port
    they load."""
    import importlib
    import sys
    pkg = ROOT / "cockroach_tpu_torch"
    rpc = {"__init__.py", "context.py", "gossip.py", "heartbeat.py",
           "retry.py"}
    assert {p.name for p in (pkg / "rpc").glob("*.py")} == rpc
    paths = [pkg / "rpc" / n for n in sorted(rpc)] + [
        pkg / "utils" / "circuit.py", pkg / "parallel" / "multihost.py",
        pkg / "server" / "hostd.py"]
    assert set(paths) <= set(_port_files())
    for path in paths:
        assert not set(_imported_roots(path)) & set(FORBIDDEN), path
        rel = path.relative_to(ROOT).with_suffix("")
        mod = ".".join(rel.parts[:-1] if rel.name == "__init__"
                       else rel.parts)
        assert Path(importlib.import_module(mod).__file__) == path
    loaded = [name for name, m in list(sys.modules.items())
              if name.startswith("cockroach_tpu_torch.")
              and getattr(m, "__file__", None)]
    for name in loaded:
        path = Path(sys.modules[name].__file__)
        if path.suffix == ".py":
            assert not set(_imported_roots(path)) & set(FORBIDDEN), name


def test_port_scan_covers_analysis():
    """The import scan reaches every module of analysis/ (graftlint's
    core, runner, CLI and its eight rules), and none of them imports jax
    or anything of the JAX package, not even the reference's own
    analysis/ (which holds no JAX): directly or through a module of the
    port they load."""
    import importlib
    import sys
    pkg = ROOT / "cockroach_tpu_torch" / "analysis"
    names = {"__init__.py", "__main__.py", "core.py", "runner.py",
             "rules_device.py", "rules_concurrency.py", "rules_plan.py",
             "rules_registration.py", "rules_lease.py", "rules_reactor.py"}
    assert {p.name for p in pkg.glob("*.py")} == names
    assert {pkg / n for n in names} <= set(_port_files())
    for n in sorted(names):
        path = pkg / n
        assert not set(_imported_roots(path)) & set(FORBIDDEN), n
        mod = ("cockroach_tpu_torch.analysis" if n == "__init__.py"
               else f"cockroach_tpu_torch.analysis.{n[:-3]}")
        assert Path(importlib.import_module(mod).__file__) == path
    loaded = [name for name, m in list(sys.modules.items())
              if name.startswith("cockroach_tpu_torch.analysis")
              and getattr(m, "__file__", None)]
    assert len(loaded) == len(names)
    for name in loaded:
        path = Path(sys.modules[name].__file__)
        assert path.parent == pkg
        assert not set(_imported_roots(path)) & set(FORBIDDEN), name


def test_native_sources_are_the_ports_own():
    """The lane's C++ and the gate's lock live in the port: nothing of
    them is loaded from the JAX package."""
    from cockroach_tpu_torch import native
    from cockroach_tpu_torch.utils import rwlock
    assert native.OLTP_SRC == ROOT / "cockroach_tpu_torch" / "native" / \
        "oltp.cpp"
    assert Path(rwlock.__file__).parent == ROOT / "cockroach_tpu_torch" / \
        "utils"


def test_observability_modules_are_the_ports_own():
    """The planes copied from JAX-free modules of the reference live in
    the port and load nothing of the JAX package."""
    import importlib
    pkg = ROOT / "cockroach_tpu_torch"
    for mod, where in (("exec.profile", "exec"), ("exec.ctecompose", "exec"),
                       ("utils.tracing", "utils"),
                       ("utils.stmtdiag", "utils"),
                       ("utils.invariants", "utils"),
                       ("utils.metamorphic", "utils")):
        m = importlib.import_module(f"cockroach_tpu_torch.{mod}")
        assert Path(m.__file__).parent == pkg / where
        assert not set(_imported_roots(Path(m.__file__))) & set(FORBIDDEN)


def test_oltp_mirror_builds_into_build_dir():
    from cockroach_tpu_torch import native
    before = {p.name for p in native.OLTP_SRC.parent.iterdir()}
    lib = native.get_oltp()
    path = native.lib_path(native.OLTP_SRC)
    assert path.parent == ROOT / "cockroach_tpu_torch" / "_build"
    assert path.exists() and path.name.startswith("oltp-")
    assert {p.name for p in native.OLTP_SRC.parent.iterdir()} == before
    assert not list(native.OLTP_SRC.parent.glob("*.so"))
    h = lib.oltp_create(2)
    assert lib.oltp_nversions(h) == 0
    lib.oltp_destroy(h)


def test_failed_native_build_raises(tmp_path, monkeypatch):
    from cockroach_tpu_torch import native
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(native.NativeBuildError, match="failed"):
        native.load_library(bad)
    assert not list((tmp_path / "_build").glob("*.so"))
    with pytest.raises(native.NativeBuildError):
        native.load_library(native.OLTP_SRC, cxx=str(tmp_path / "no-cxx"))


def test_lane_raises_when_its_build_fails(monkeypatch):
    """An engine whose lane cannot be built raises at its first lane
    statement instead of serving everything on the full path."""
    from cockroach_tpu_torch import native
    from cockroach_tpu_torch.exec.engine import Engine

    def broken():
        raise native.NativeBuildError("g++ failed")
    monkeypatch.setattr(native, "get_oltp", broken)
    e = Engine(device="cpu")
    e.execute("CREATE TABLE t (k INT PRIMARY KEY, v INT)")
    with pytest.raises(native.NativeBuildError):
        e.execute("INSERT INTO t VALUES (1, 2)")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_engine_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from cockroach_tpu_torch import default_device
    from cockroach_tpu_torch.exec.engine import Engine
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_device()


def test_cluster_engine_and_elastic_pod_without_card_raise():
    """A cluster-backed engine and an elastic pod host keep the device
    policy: the card unless a device is named (the Cluster itself is
    host code and takes no device)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import subprocess
    import sys
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.kvserver.cluster import Cluster
    c = Cluster(n_nodes=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(cluster=c)
    assert Engine(cluster=c, device="cpu").cluster is c
    proc = subprocess.run(
        [sys.executable, "-m", "cockroach_tpu_torch.server.hostd",
         "--elastic", "--rows", "10"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr


def test_server_and_cli_without_card_raise():
    """The node and the CLI's engine commands keep the device policy:
    the card unless a device is named."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from cockroach_tpu_torch import cli
    from cockroach_tpu_torch.server import Node, NodeConfig
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Node(NodeConfig())
    for argv in (["start", "--listen-addr", "127.0.0.1:0"],
                 ["demo", "--sf", "0.01"], ["workload", "kv"],
                 ["workload", "kv", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)


def test_cluster_start_without_card_raises():
    """``start`` in cluster mode keeps the device policy too, and leaves
    no pump thread of its NetCluster behind when the engine raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import threading

    from cockroach_tpu_torch import cli
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["start", "--listen-addr", "127.0.0.1:0", "--bootstrap",
                  "--kv-addr", "127.0.0.1:0"])
    assert not [t for t in threading.enumerate()
                if t.name.startswith("nc-pump-")]


def test_wrapper_uses_plain_version_only_for_cpu_tensors():
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    n = 256
    gid = torch.zeros(n, dtype=torch.int32)
    sel = torch.ones(n, dtype=torch.bool)
    col = torch.ones(n)
    launches, plain = tgl.LAUNCHES, tgl.PLAIN_CALLS
    _, acc_i = tgl.large_group_aggregate(gid, sel, (col,), (), 1, (True,))
    assert int(acc_i[0, 0]) == n
    assert (tgl.LAUNCHES, tgl.PLAIN_CALLS) == (launches, plain + 1)
    meta = torch.zeros(n, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tgl.large_group_aggregate(meta, sel, (col,), (), 1, (True,))


def test_small_wrapper_uses_plain_version_only_for_cpu_tensors():
    from cockroach_tpu_torch.ops.cuda import groupagg as tg
    n = 256
    gid = torch.zeros(n, dtype=torch.int32)
    sel = torch.ones(n, dtype=torch.bool)
    col = torch.ones(n)
    launches, plain = tg.LAUNCHES, tg.PLAIN_CALLS
    _, cnt = tg.dense_group_aggregate(gid, sel, (col,), (sel,), 1,
                                      (tg.COUNT,))
    assert int(cnt[0, 0]) == n
    assert (tg.LAUNCHES, tg.PLAIN_CALLS) == (launches, plain + 1)
    meta = torch.zeros(n, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tg.dense_group_aggregate(meta, sel, (col,), (sel,), 1, (tg.COUNT,))
