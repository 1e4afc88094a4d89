"""The port's Node and command-line interface.

- ``Node(NodeConfig(load_tpch_sf=0.01, device="cpu"))`` starts, answers
  TPC-H Q1 and Q6 over the wire equal to the numpy oracles, and stops.
- Each status endpoint returns the reference Node's keys; the
  ``/_status/statements`` page holds Q1's fingerprint and count; the
  Prometheus page serves the admission metrics; the endpoints the port
  does not have yet answer 404 "not yet ported".
- ``cli.main`` runs ``version``, ``sql -e`` (and its errors), ``demo``
  over piped statements, and ``workload`` for every registered workload
  on the CPU at small steps and scale; ``python -m cockroach_tpu_torch
  start`` runs as a process and serves ``sql -e``.
- Cluster flags, ``node`` and ``debug`` raise "not yet ported".
- Without a card, ``Node()`` and ``start``/``demo``/``workload`` without
  ``--device`` raise: nothing falls back to the CPU by itself.
"""

import io
import json
import math
import os
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from cockroach_tpu_torch import cli
from cockroach_tpu_torch.models import tpch
from cockroach_tpu_torch.server import Node, NodeConfig
from tests.test_torch_groupagg_large import reference_modules

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 5.0


@pytest.fixture(scope="module")
def node():
    n = Node(NodeConfig(load_tpch_sf=0.01, device="cpu")).start()
    try:
        # first runs upload and compile: keep them out of the clients'
        # 5 s socket timeouts
        for q in (tpch.Q1, tpch.Q6):
            n.engine.execute(q)
        yield n
    finally:
        n.stop()


def _get(node, path):
    host, port = node.http_addr
    with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                timeout=TIMEOUT) as r:
        return r.read()


def _li():
    return tpch.gen_lineitem(0.01)


def test_tpch_over_the_wire_equals_oracles(node):
    c = cli.PgClient(*node.sql_addr, timeout=TIMEOUT)
    try:
        names, rows, tags = c.query(tpch.Q1)
        want = tpch.ref_q1(_li())
        assert tags == ["SELECT %d" % len(want)] and len(rows) == len(want)
        for got, w in zip(rows, want):
            assert got[:2] == tuple(w[:2])
            for g, x in zip(got[2:], w[2:]):
                assert math.isclose(float(g), float(x), rel_tol=1e-9)
        _, rows, _ = c.query(tpch.Q6)
        assert math.isclose(float(rows[0][0]), tpch.ref_q6(_li()),
                            rel_tol=1e-9)
    finally:
        c.close()
    stmts = json.loads(_get(node, "/_status/statements"))["statements"]
    from cockroach_tpu_torch.utils.sqlstats import fingerprint
    q1 = [s for s in stmts if s["fingerprint"] == fingerprint(tpch.Q1)]
    assert len(q1) == 1 and q1[0]["count"] >= 1
    assert q1[0]["total_rows"] == 4 * q1[0]["count"]


def _reference_payloads():
    """The reference Node's status pages after the same statements."""
    with reference_modules("cockroach_tpu.server.node") as (jnode,):
        n = jnode.Node(jnode.NodeConfig())
        n.start()
        try:
            return _payloads(n)
        finally:
            n.stop()


def _payloads(n) -> dict:
    n.engine.execute("CREATE TABLE st (k INT PRIMARY KEY, v INT)")
    n.engine.execute("INSERT INTO st VALUES (1, 2)")
    s = n.engine.session()
    s.vars.set("application_name", "app")
    n.engine.execute("SELECT sum(v) FROM st", s)
    n.tsdb.record()
    host, port = n.http_addr
    out = {}
    for path in ("/healthz", "/_status/statements", "/_status/tenants",
                 "/ts/metrics",
                 "/ts/query?name=admission.admitted&start=0&end=9999999999"):
        with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                    timeout=TIMEOUT) as r:
            out[path] = json.loads(r.read())
    return out


def _item_keys(payload) -> dict:
    """Each list of a status page by the keys its items carry."""
    return {k: sorted({kk for item in v for kk in item})
            for k, v in payload.items()}


def test_status_endpoints_have_the_reference_keys():
    want = _reference_payloads()
    n = Node(NodeConfig(device="cpu")).start()
    try:
        got = _payloads(n)
    finally:
        n.stop()
    assert set(got["/healthz"]) == set(want["/healthz"])
    assert _item_keys(got["/_status/statements"]) == _item_keys(
        want["/_status/statements"])
    # the tenants' rollups: the reference's keys and their wall time;
    # the device time and the tenant's own HBM high-water are measured
    # (on a CPU engine the device time is the dispatch's host clock)
    assert _item_keys(got["/_status/tenants"]) == {
        k: sorted(set(v) | {"wall_seconds"})
        for k, v in _item_keys(want["/_status/tenants"]).items()}
    tenants = {t["app_name"]: t for t in got["/_status/tenants"]["tenants"]}
    assert set(tenants) == {"app", "(unset)"}
    assert tenants["app"]["wall_seconds"] > 0
    assert 0 < tenants["app"]["device_seconds"] \
        <= tenants["app"]["wall_seconds"]
    assert tenants["app"]["hbm_bytes_held"] > 0
    assert "admission.admitted" in got["/ts/metrics"]
    assert "admission.admitted" in want["/ts/metrics"]
    q = "/ts/query?name=admission.admitted&start=0&end=9999999999"
    # the INSERT rode the lane, which admission does not gate
    assert [v for _, v in got[q]] == [v for _, v in want[q]] == [2.0]


def test_prometheus_page_and_not_ported_endpoints(node):
    text = _get(node, "/_status/vars").decode()
    assert text == _get(node, "/metrics").decode()
    for name in ("admission_admitted", "admission_tenant_slot_waits",
                 "exec_device_hbm_bytes", "sql_exec_latency_bucket"):
        assert name in text
    for path in ("/_debug/ranges", "/_status/nodes",
                 "/debug/tracez?cluster=1"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(node, path)
        assert ei.value.code == 404
        assert b"not yet ported" in ei.value.read()
    # served since the tracing and diagnostics planes came
    assert json.loads(_get(node, "/debug/tracez")) == {"traces": []}
    assert json.loads(_get(node, "/_status/stmtdiag")) == {
        "armed": [], "bundles": []}
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(node, "/_status/stmtdiag/3")
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(node, "/ts/query?start=0")
    assert ei.value.code == 400


def test_maintenance_pass_records_and_sweeps(node):
    node.maintain_once()
    assert "admission.admitted" in node.tsdb.list_metrics()


def test_version_and_sql_execute(node, capsys):
    assert cli.main(["version"]) == 0
    assert "PyTorch/CUDA" in capsys.readouterr().out
    h, p = node.sql_addr
    assert cli.main(["sql", "--url", f"{h}:{p}", "-e", "SELECT 40 + 2",
                     "-e", "SELECT count(*) AS n FROM part"]) == 0
    out = capsys.readouterr().out.split("\n")
    assert "42" in out[2] and out[3] == "SELECT 1"
    assert out[6].strip() == str(len(tpch.gen_part(0.01)["p_partkey"]))
    assert cli.main(["sql", "--url", f"{h}:{p}", "-e", "SELEC 1"]) == 1
    assert "SQLSTATE XX000" in capsys.readouterr().err


def test_demo_reads_statements_from_stdin(monkeypatch, capsys):
    monkeypatch.setattr(sys, "stdin", io.StringIO(
        tpch.Q6.strip() + ";\n\\q\n"))
    assert cli.main(["demo", "--sf", "0.01", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = out.split("\n")
    i = lines.index("SELECT 1")
    assert math.isclose(float(lines[i - 1].split()[-1]),
                        tpch.ref_q6(_li()), rel_tol=1e-9)


WORKLOAD_STEPS = {"ycsb": 20, "tpcc": 10, "bank": 10, "kv": 50, "movr": 10,
                  "ssb": 1}


@pytest.mark.parametrize("name", sorted(WORKLOAD_STEPS))
def test_workload_runs_on_the_cpu(name, capsys):
    from cockroach_tpu_torch.workload import WORKLOADS
    assert set(WORKLOADS) == set(WORKLOAD_STEPS)
    assert cli.main(["workload", name, "--device", "cpu", "--steps",
                     str(WORKLOAD_STEPS[name])]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if name == "tpcc":
        assert out["steps"] == 10 and out["new_orders"] + out[
            "payments"] + out["order_statuses"] + out["deliveries"] \
            + out["stock_levels"] == 10
    elif name == "bank":
        assert out["total"] == 100 * 1000
    elif name == "ssb":
        assert set(out) == {"q1.1", "q1.2", "q2.1", "q3.1", "q4.1"}
    else:
        assert out


@pytest.mark.parametrize("argv,what", [
    (["start", "--kv-addr", "127.0.0.1:0", "--device", "cpu"], "start"),
    (["start", "--bootstrap", "--device", "cpu"], "start"),
    (["start", "--join", "2@127.0.0.1:1", "--device", "cpu"], "start"),
    (["node", "status", "--url", "127.0.0.1:1"], "node"),
    (["debug", "ranges", "--url", "127.0.0.1:1"], "debug"),
])
def test_cluster_commands_are_not_ported(argv, what):
    with pytest.raises(cli.NotPortedError, match=f"{what}.*not yet ported"):
        cli.main(argv)


def test_no_card_no_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Node()
    for argv in (["workload", "bank"], ["demo"],
                 ["start", "--listen-addr", "127.0.0.1:0"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(argv)


def test_start_as_a_process_serves_sql():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "cockroach_tpu_torch", "start", "--device",
         "cpu", "--listen-addr", "127.0.0.1:0"], cwd=str(ROOT), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        addr = None
        for line in proc.stdout:
            if line.startswith("sql:"):
                addr = line.split("@", 1)[1].split("/", 1)[0]
                break
        assert addr is not None
        out = subprocess.run(
            [sys.executable, "-m", "cockroach_tpu_torch", "sql", "--url",
             addr, "-e", "CREATE TABLE z (k INT PRIMARY KEY)", "-e",
             "INSERT INTO z VALUES (1), (2)", "-e", "SHOW STATEMENTS"],
            cwd=str(ROOT), env=env, capture_output=True, text=True,
            timeout=60)
        assert out.returncode == 0, out.stderr
        assert "INSERT INTO z VALUES (_), (_)" in out.stdout
    finally:
        proc.terminate()
        proc.wait(timeout=30)
