"""The port's tracing, statement diagnostics and profile planes.

- utils/tracing.py: nested spans, per-thread captures, the wire codec,
  trace contexts and remote grafting (tests/test_tracing_stats.py's
  cases, run against the port's copy).
- The Engine: the slow-statement ring (``sql.trace.slow_statement.
  threshold``), ``SET tracing = on | cluster`` with SHOW TRACE FOR
  SESSION, the spans EXPLAIN ANALYZE reads (plan, upload, dispatch,
  materialize), the plan cache's tag.
- utils/stmtdiag.py and the Node (``Node(NodeConfig(load_tpch_sf=0.01,
  device="cpu"))``): arming by POST /_status/stmtdiag and SET
  statement_diagnostics, the one-shot capture, /_status/stmtdiag/<id>,
  its errors, EXPLAIN ANALYZE (DEBUG) and the bundle's sections, the
  slow Q1 at /debug/tracez, the tenants' device_seconds and
  hbm_bytes_held (tests/test_stmtdiag.py's cases that need no cluster).
- exec/profile.py: the coarse sink notes a resident upload, a streamed
  scan's pages and a spill join's partitions under a small budget; a
  fine sink gives one entry per operator of the plan that ran, with
  self times adding up to the profiled wall; the path without a sink
  (``sql.stmt_profile.enabled`` off) gives the same rows; concurrent
  notes and nested activations.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from cockroach_tpu_torch.exec import profile as prof
from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.models import tpch
from cockroach_tpu_torch.server import Node, NodeConfig
from cockroach_tpu_torch.sql import parser
from cockroach_tpu_torch.storage.hlc import Timestamp
from cockroach_tpu_torch.utils import tracing
from cockroach_tpu_torch.utils.sqlstats import fingerprint
from cockroach_tpu_torch.utils.stmtdiag import StmtDiagRegistry
from cockroach_tpu_torch.utils.tracing import Tracer

Q = ("SELECT l_returnflag, count(*), sum(l_quantity) FROM lineitem "
     "GROUP BY l_returnflag ORDER BY l_returnflag")
BUNDLE_KEYS = {"sql", "fingerprint", "plan", "profile", "trace",
               "settings", "session_vars", "sketch_stats",
               "metric_deltas", "latency_s", "compile_s",
               "device_time_s"}
TIMEOUT = 10


# -- utils/tracing.py ------------------------------------------------------

def test_nested_spans():
    tr = Tracer()
    with tr.capture("root") as rec:
        with tr.span("a"):
            with tr.span("b", rows=3):
                pass
        with tr.span("c"):
            pass
    assert [c.name for c in rec.children] == ["a", "c"]
    assert rec.children[0].children[0].name == "b"
    assert rec.find("b").tags == {"rows": 3}
    assert rec.find("b").duration_ms >= 0


def test_spans_without_capture_are_harmless():
    tr = Tracer()
    with tr.span("orphan"):
        tr.tag(x=1)
    assert tracing.current_span() is None


def test_capture_isolated_per_thread():
    tr = Tracer()
    seen = []

    def worker():
        with tr.capture("w") as rec:
            with tr.span("inner"):
                pass
        seen.append(rec)

    with tr.capture("main") as rec:
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=TIMEOUT)
    assert rec.find("inner") is None
    assert seen[0].find("inner") is not None


def test_trace_context_and_record_request_bit():
    assert tracing.trace_context() is None
    assert tracing.event("nobody-listening") is None
    assert tracing.attach_remote({"n": "x"}) is None
    with tracing.capture("root") as rec:
        assert tracing.trace_context() == {
            "tid": rec.trace_id, "sid": rec.span_id, "rec": 1}
        with tracing.span("child") as s:
            assert tracing.trace_context()["sid"] == s.span_id
    with tracing.capture("local", record_request=False):
        assert "rec" not in tracing.trace_context()
        assert not tracing.recording_requested()
    with tracing.capture("remote", remote_ctx={"tid": 42, "sid": 17}) \
            as rec:
        assert not tracing.recording_requested()
    assert rec.trace_id == 42 and rec.tags["parent_sid"] == 17


def test_wire_roundtrip_and_json_safe_tags():
    with tracing.capture("root", q="sel", blob=b"\x01") as rec:
        with tracing.span("inner", rows=7):
            tracing.event("mark", hit=True)
        for i in range(3):
            with tracing.span("rpc-attempt", attempt=i):
                pass
    w = tracing.span_to_wire(rec)
    assert all(isinstance(v, (str, int, float, bool, type(None)))
               for v in w["t"].values())
    back = tracing.span_from_wire(json.loads(json.dumps(w)))
    assert back.name == "root" and back.tags["q"] == "sel"
    assert back.find("inner").tags == {"rows": 7}
    assert back.find("mark").tags == {"hit": True}
    assert [s.tags["attempt"] for s in back.find_all("rpc-attempt")] == \
        [0, 1, 2]
    remote = {"n": "rpc:read", "b": 0, "e": 10, "t": {"node": 2},
              "c": [], "sid": 9, "tid": 4}
    with tracing.capture("stmt") as rec2:
        tracing.attach_remote(remote)
    assert rec2.find("rpc:read").tags["node"] == 2


# -- the Engine's tracing ------------------------------------------------

@pytest.fixture()
def eng():
    e = Engine(device="cpu")
    e.execute("CREATE TABLE t (a INT, s STRING)")
    e.execute("INSERT INTO t VALUES (1,'x'),(2,'y'),(3,'x')")
    return e


def test_slow_statement_ring(eng):
    eng.execute("SELECT a FROM t")
    assert len(eng.slow_traces) == 0
    eng.settings.set("sql.trace.slow_statement.threshold", 1e-9)
    eng.execute("INSERT INTO t VALUES (4, 'z')")
    eng.execute("SELECT count(*) FROM t")
    assert len(eng.slow_traces) >= 2
    last = eng.slow_traces[-1]
    assert last["sql"] == last["fingerprint"] == "SELECT count(*) FROM t"
    assert last["duration_s"] > 0
    span = tracing.span_from_wire(last["span"])
    assert span.find("plan") is not None
    assert span.find("dispatch") is not None


@pytest.mark.parametrize("mode", ["on", "cluster"])
def test_session_tracing_and_show_trace(eng, mode):
    s = eng.session()
    eng.execute(f"SET tracing = {mode}", s)
    eng.execute("SELECT s, count(*) FROM t GROUP BY s", s)
    eng.execute("SET tracing = off", s)
    rows = eng.execute("SHOW TRACE FOR SESSION", s).rows
    text = "\n".join(r[0] for r in rows)
    assert "SELECT s, count(*) FROM t GROUP BY s" in text
    for name in ("plan:", "upload:", "dispatch:", "materialize:"):
        assert name in text
    n = len(rows)
    eng.execute("SELECT count(*) FROM t", s)
    assert len(eng.execute("SHOW TRACE FOR SESSION", s).rows) == n


def test_plan_cache_tag(eng):
    eng.execute("SELECT a FROM t WHERE a = 1")
    with eng.tracer.capture("c") as rec:
        eng.execute("SELECT a FROM t WHERE a = 1")
    assert rec.find("plan") is not None
    assert [s.tags.get("plan_cache") for s in rec.find_all("stmt:select")] \
        == ["hit"]


# -- statement diagnostics -------------------------------------------------

def test_registry_arm_capture_rearm():
    reg = StmtDiagRegistry()
    req = reg.arm("SELECT a FROM t WHERE a = 1")
    assert req["fingerprint"] == fingerprint("SELECT a FROM t WHERE a = 5")
    assert reg.arm(req["fingerprint"], is_fingerprint=True) == req
    rid = reg.should_capture(req["fingerprint"])
    assert rid == req["request_id"]
    assert reg.should_capture(req["fingerprint"]) is None
    reg.rearm(req["fingerprint"], rid)
    assert reg.summary()["armed"] == [req]
    bid = reg.fulfill(reg.should_capture(req["fingerprint"]), {"x": 1})
    assert bid == rid and reg.get(bid)["x"] == 1
    assert reg.summary()["bundles"][0]["id"] == bid


@pytest.fixture(scope="module")
def node():
    n = Node(NodeConfig(load_tpch_sf=0.01, device="cpu")).start()
    yield n
    n.stop()


def _get(node, path):
    host, port = node.http_addr
    with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                timeout=TIMEOUT) as r:
        return json.loads(r.read())


def _post(node, path, payload):
    host, port = node.http_addr
    req = urllib.request.Request(
        f"http://{host}:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return json.loads(r.read())


def test_http_arm_capture_fetch(node):
    sql = "SELECT count(*) FROM lineitem WHERE l_quantity > 7"
    out = _post(node, "/_status/stmtdiag", {"sql": sql})
    rid, fp = out["request_id"], out["fingerprint"]
    assert {"request_id": rid, "fingerprint": fp} in \
        _get(node, "/_status/stmtdiag")["armed"]
    node.engine.execute(sql)
    node.engine.execute(sql)   # one-shot: no second bundle
    summary = _get(node, "/_status/stmtdiag")
    assert not any(a["request_id"] == rid for a in summary["armed"])
    assert sum(b["id"] == rid for b in summary["bundles"]) == 1
    bundle = _get(node, f"/_status/stmtdiag/{rid}")
    assert BUNDLE_KEYS <= set(bundle)
    assert bundle["fingerprint"] == fp and bundle["sql"] == sql
    assert any("scan" in o["op"] for o in bundle["profile"]["ops"])
    assert any("device=" in ln for ln in bundle["plan"])
    assert bundle["device_time_s"] > 0


def test_http_fetch_errors(node):
    for path, code in (("/_status/stmtdiag/999999", 404),
                       ("/_status/stmtdiag/nope", 400)):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(node, path)
        assert ei.value.code == code
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(node, "/_status/stmtdiag", {"bogus": 1})
    assert ei.value.code == 400


def test_set_statement_diagnostics(node):
    eng = node.engine
    sql = "SELECT sum(l_quantity) FROM lineitem WHERE l_tax > 0.01"
    res = eng.execute(f"SET statement_diagnostics = '{sql}'")
    assert res.names == ["request_id", "fingerprint"]
    rid, fp = res.rows[0]
    eng.execute(sql)
    bundle = eng.stmtdiag.get(rid)
    assert bundle is not None and bundle["fingerprint"] == fp
    assert BUNDLE_KEYS <= set(bundle)
    assert "sql.stmt_profile.enabled" in bundle["settings"]
    assert "application_name" in bundle["session_vars"]
    assert "lineitem" in bundle["sketch_stats"]


def test_explain_analyze_debug_bundle(node):
    res = node.engine.execute("EXPLAIN ANALYZE (DEBUG) " + Q)
    assert res.names == ["bundle"] and len(res.rows) == 1
    bundle = json.loads(res.rows[0][0])
    assert BUNDLE_KEYS <= set(bundle)
    dev = bundle["profile"]["device_time_s"]
    op_sum = sum(o["device_seconds"] for o in bundle["profile"]["ops"])
    assert dev > 0
    # self times add up to the profiled wall
    assert op_sum == pytest.approx(dev, rel=1e-6, abs=1e-9)
    assert node.engine.stmtdiag.get(bundle["id"])["sql"] == bundle["sql"]


def test_tracez_lists_the_slow_statement(node):
    eng = node.engine
    s = eng.session()
    s.vars.set("application_name", "slowapp")
    eng.settings.set("sql.trace.slow_statement.threshold", 1e-9)
    try:
        eng.execute(tpch.Q1, s)
    finally:
        eng.settings.set("sql.trace.slow_statement.threshold", 0.0)
    traces = _get(node, "/debug/tracez")["traces"]
    ent = [t for t in traces if t["fingerprint"] == fingerprint(tpch.Q1)]
    assert ent and ent[-1]["application_name"] == "slowapp"
    assert ent[-1]["session"].startswith("s")
    assert tracing.span_from_wire(ent[-1]["span"]).find("dispatch")


def test_tenant_rollup_device_seconds_and_hbm(node):
    eng = node.engine
    sa, sb = eng.session(), eng.session()
    sa.vars.set("application_name", "tenant_a")
    sb.vars.set("application_name", "tenant_b")
    eng.execute(Q, sa)
    eng.execute(Q, sa)
    eng.execute("SELECT count(*) FROM lineitem", sb)
    by_name = {t["app_name"]: t for t in
               _get(node, "/_status/tenants")["tenants"]}
    a = by_name["tenant_a"]
    assert a["statements"] == 2
    assert 0 < a["device_seconds"] <= a["wall_seconds"]
    assert by_name["tenant_b"]["device_seconds"] > 0
    # HBM of a tenant's own reservations; a tenant whose statements
    # found every table resident reserved nothing new
    assert a["hbm_bytes_held"] is None or a["hbm_bytes_held"] >= 0


# -- the profile plane ------------------------------------------------------

def test_coarse_sink_notes_resident_upload(eng):
    eng.execute("SELECT count(*) FROM t")
    ents = dict(eng.last_profile.entries())
    assert ents["upload:t"].bytes_uploaded > 0
    assert ents["upload:t"].batches == 1
    eng.execute("SELECT count(*) FROM t")     # resident now: no upload
    assert "upload:t" not in dict(eng.last_profile.entries())
    tenants = {t.app_name: t for t in eng.sqlstats.tenants()}
    assert tenants["(unset)"].hbm_bytes_held > 0
    assert tenants["(unset)"].bytes_moved > 0


def _fact_engine():
    rng = np.random.default_rng(0)
    e = Engine(device="cpu")
    e.execute("CREATE TABLE fact (k INT8, g INT8 NOT NULL, v INT8)")
    e.execute("CREATE TABLE dim (k INT8, w INT8)")
    n, m = 6000, 1500
    e.store.insert_columns("fact", {
        "k": rng.integers(0, m, n).astype(np.int64) * 7 + 3,
        "g": rng.integers(0, 8, n).astype(np.int64),
        "v": rng.integers(-100, 100, n).astype(np.int64)},
        Timestamp(1, 0))
    e.store.insert_columns("dim", {
        "k": np.arange(m, dtype=np.int64) * 7 + 3,
        "w": rng.integers(0, 50, m).astype(np.int64)}, Timestamp(1, 0))
    return e


JOIN_Q = ("SELECT g, sum(v) AS sv, sum(w) AS sw, count(*) AS c "
          "FROM fact JOIN dim ON fact.k = dim.k GROUP BY g ORDER BY g")
STREAM_Q = "SELECT g, sum(v) AS s FROM fact GROUP BY g ORDER BY g"


def test_coarse_sink_notes_spill_and_stream():
    e = _fact_engine()
    s = e.session()
    s.vars.set("streaming_page_rows", 2048)
    want_join = e.execute(JOIN_Q, s).rows
    want_stream = e.execute(STREAM_Q, s).rows
    e.settings.set("sql.exec.hbm_budget_bytes", 1 << 16)
    assert e.execute(JOIN_Q, s).rows == want_join
    assert e.last_exec["paging"]["route"] == "spill-join"
    parts = e.last_exec["paging"]["partitions"]
    ents = dict(e.last_profile.entries())
    assert ents["spill:join:fact"].batches == parts >= 2
    assert ents["spill:join:fact"].bytes_spilled == \
        e.last_exec["paging"]["bytes"] > 0
    assert e.execute(STREAM_Q, s).rows == want_stream
    assert e.last_exec["paging"]["route"] == "stream"
    ents = dict(e.last_profile.entries())
    assert ents["stream:fact"].bytes_uploaded == \
        e.last_exec["paging"]["bytes"] > 0
    assert ents["stream:fact"].batches == e.last_exec["paging"]["pages"]


def _plan_nodes(node):
    out = [node]
    for attr in ("child", "left", "right"):
        c = getattr(node, attr, None)
        if c is not None:
            out += _plan_nodes(c)
    return out


def test_fine_sink_one_entry_per_operator():
    e = _fact_engine()
    res, node, sink = e._measure_operator_profile(
        parser.parse(JOIN_Q), e.session(), JOIN_Q)
    nodes = _plan_nodes(node)
    assert all(sink.op_entry(n) is not None for n in nodes)
    assert len(sink.entries()) >= len(nodes)
    assert sink.op_entry(node).rows == len(res.rows) == 8
    assert sum(sink.op_entry(n).device_seconds for n in nodes) == \
        pytest.approx(sink.wall_s, rel=1e-6, abs=1e-9)
    digest = e.operator_profile(JOIN_Q)
    assert {t["op"] for t in digest["top_ops"]} and digest["wall_s"] > 0


def test_path_without_a_sink_gives_the_same_rows():
    e = _fact_engine()
    on = e.execute(JOIN_Q).rows
    e.settings.set("sql.stmt_profile.enabled", False)
    off = e.execute(JOIN_Q).rows
    assert on == off
    assert e.last_profile is not None      # the previous statement's
    tenants = {t.app_name: t for t in e.sqlstats.tenants()}
    # the plane off measures no device time for that statement
    before = tenants["(unset)"].device_seconds
    e.execute(JOIN_Q)
    assert {t.app_name: t for t in e.sqlstats.tenants()}[
        "(unset)"].device_seconds == before


def test_concurrent_notes_and_nested_activation():
    sink = prof.ProfileSink()

    def worker():
        for _ in range(1000):
            sink.note("op", batches=1, bytes_uploaded=2)

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
    ents = dict(sink.entries())
    assert ents["op"].batches == 8000 and ents["op"].bytes_uploaded == 16000
    prof.note("nobody-listening", batches=1)
    outer, inner = prof.ProfileSink(), prof.ProfileSink()
    with prof.active(outer):
        with prof.active(inner, fine=True):
            assert prof.current() is inner and prof.fine_sink() is inner
        assert prof.current() is outer and prof.fine_sink() is None
    assert prof.current() is None
