"""The port's log plane, time-series DB and statement statistics.

The log cases are tests/test_log.py's (channels, severities, sinks,
redaction, structured events), each run against the port's
``utils/log.py`` and the reference's; the call sites are the port's own
(the node's ``node_start``/``node_stop`` and pgwire's session event).
The tsdb cases are tests/test_tsdb.py's over the port's ``server/ts.py``,
``Engine(device="cpu")`` and ``Node``. The statement statistics: the
same statements through the OLTP lane and the full path give the
reference Engine's fingerprints, counts, row totals and failures, and
``SHOW STATEMENTS`` the same rows but for the latencies.
"""

import importlib
import json
import os
import urllib.error
import urllib.request

import pytest

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.server.node import Node, NodeConfig
from cockroach_tpu_torch.server.ts import (COARSE_RES_S, FINE_RES_S,
                                           SLAB_S, TimeSeriesDB)
from cockroach_tpu_torch.utils import log as port_log
from tests.test_torch_groupagg_large import reference_modules


@pytest.fixture(params=["port", "reference"])
def log(request):
    return importlib.import_module(
        {"port": "cockroach_tpu_torch.utils.log",
         "reference": "cockroach_tpu.utils.log"}[request.param])


class TestRedaction:
    def test_args_are_wrapped_and_redactable(self, log):
        with log.scope() as mem:
            log.info(log.DEV, "user %s did %s", "alice", "a thing")
        [e] = mem.entries
        assert "‹alice›" in e.msg
        assert log.redact(e.msg) == "user ××× did ×××"
        assert log.strip_markers(e.msg) == "user alice did a thing"

    def test_literal_text_survives_redaction(self, log):
        assert log.redact("plain message") == "plain message"
        assert log.redact("a ‹secret› b ‹two› c") == "a ××× b ××× c"

    def test_redacted_sink_renders_masked(self, log):
        with log.scope(log.MemorySink(redacted=True)) as mem:
            log.info(log.DEV, "key=%s", "hunter2")
        assert mem.lines()[0].endswith("key=×××")
        assert "hunter2" not in mem.lines()[0]


class TestSinks:
    def test_severity_threshold(self, log):
        with log.scope(log.MemorySink(threshold=log.WARNING)) as mem:
            log.info(log.DEV, "quiet")
            log.warning(log.DEV, "loud")
            log.error(log.DEV, "louder")
        assert [e.severity for e in mem.entries] == ["W", "E"]

    def test_channel_filter(self, log):
        with log.scope(log.MemorySink(channels={log.OPS})) as mem:
            log.info(log.DEV, "dev")
            log.info(log.OPS, "ops")
        assert [e.channel for e in mem.entries] == ["OPS"]

    def test_multiple_sinks_fan_out(self, log):
        a = log.MemorySink(channels={log.OPS})
        b = log.MemorySink()
        with log.scope(a, b):
            log.info(log.OPS, "x")
            log.info(log.DEV, "y")
        assert len(a.entries) == 1 and len(b.entries) == 2

    def test_file_sink_json(self, log, tmp_path):
        p = os.path.join(tmp_path, "logs", "node.log")
        s = log.FileSink(p, format="json", redacted=True)
        with log.scope(s):
            log.info(log.HEALTH, "heartbeat from %s", "n1")
        s.close()
        [line] = open(p).read().splitlines()
        obj = json.loads(line)
        assert obj["channel"] == "HEALTH"
        assert obj["message"] == "heartbeat from ×××"

    def test_file_sink_crdb_format(self, log, tmp_path):
        p = os.path.join(tmp_path, "node.log")
        s = log.FileSink(p)
        with log.scope(s):
            log.warning(log.STORAGE, "compaction lagging")
        s.close()
        line = open(p).read().strip()
        assert line.startswith("W") and "[STORAGE]" in line


class TestStructuredEvents:
    def test_event_payload(self, log):
        with log.scope() as mem:
            log.structured(log.OPS, "node_start", node_id=3,
                           sql_addr="localhost:5432")
        [e] = mem.entries
        assert e.event["type"] == "node_start"
        assert e.event["node_id"] == 3
        line = e.render(redacted=False)
        assert "node_start" in line and "localhost:5432" in line
        masked = e.render(redacted=True)
        assert "localhost:5432" not in masked

    def test_fatal_raises(self, log):
        with log.scope():
            with pytest.raises(SystemExit):
                log.fatal(log.OPS, "disk gone")


class TestCallSites:
    def test_node_start_and_stop_events(self):
        with port_log.scope() as mem:
            n = Node(NodeConfig(device="cpu", http_port=None)).start()
            addr = "%s:%d" % n.sql_addr
            n.stop()
        evs = [(e.channel, e.event["type"]) for e in mem.entries
               if e.event]
        assert evs == [(port_log.OPS, "node_start"),
                       (port_log.OPS, "node_stop")]
        assert addr in mem.entries[0].render(redacted=False)
        assert addr not in mem.entries[0].render(redacted=True)

    def test_pgwire_session_opened(self):
        from cockroach_tpu_torch.server.miniclient import MiniClient
        from cockroach_tpu_torch.server.pgwire import PgServer
        srv = PgServer(Engine(device="cpu"), frontend="threads").start()
        try:
            with port_log.scope(port_log.MemorySink(
                    channels={port_log.SESSIONS})) as mem:
                c = MiniClient(*srv.addr, user="alice", timeout=5.0)
                c.query("SELECT 1")
                c.close()
            assert [e.channel for e in mem.entries] == ["SESSIONS"]
            assert mem.entries[0].render(redacted=False).endswith(
                "client session opened user=alice")
        finally:
            srv.stop()


class FakeClock:
    def __init__(self, start=1_000_000 - 1_000_000 % SLAB_S):
        self.t = start

    def __call__(self):
        return self.t


def make_tsdb():
    e = Engine(device="cpu")
    clock = FakeClock()
    ts = TimeSeriesDB(e.kv, e.metrics, now_s=clock)
    return e, ts, clock


class TestRecordQuery:
    def test_roundtrip_and_downsample(self):
        e, ts, clock = make_tsdb()
        g = e.metrics.gauge("test.gauge", "x")
        t0 = clock.t
        for i in range(12):
            g.set(float(i))
            ts.record()
            clock.t += FINE_RES_S
        pts = ts.query("test.gauge", t0, clock.t)
        assert len(pts) == 12
        assert pts[0] == (t0, 0.0) and pts[-1][1] == 11.0
        # downsample to 60s buckets, avg of 6 samples each
        ds = ts.query("test.gauge", t0, clock.t, downsample_s=60)
        assert len(ds) == 2
        assert ds[0][1] == sum(range(6)) / 6
        assert ds[1][1] == sum(range(6, 12)) / 6
        mx = ts.query("test.gauge", t0, clock.t, downsample_s=60,
                      agg="max")
        assert [v for _, v in mx] == [5.0, 11.0]

    def test_rate_of_counter(self):
        e, ts, clock = make_tsdb()
        c = e.metrics.counter("test.ctr", "x")
        t0 = clock.t
        for _ in range(5):
            c.inc(20)
            ts.record()
            clock.t += FINE_RES_S
        pts = ts.query("test.ctr", t0, clock.t, rate=True)
        # 20 per 10s = 2/s between consecutive samples
        assert all(abs(v - 2.0) < 1e-9 for _, v in pts)

    def test_window_filtering_and_list(self):
        e, ts, clock = make_tsdb()
        g = e.metrics.gauge("a.b", "x")
        t0 = clock.t
        for i in range(6):
            g.set(i)
            ts.record()
            clock.t += FINE_RES_S
        mid = t0 + 2 * FINE_RES_S
        pts = ts.query("a.b", mid, mid + 2 * FINE_RES_S)
        assert [v for _, v in pts] == [2.0, 3.0]
        assert "a.b" in ts.list_metrics()

    def test_slab_boundary(self):
        """Samples spanning an hour boundary land in two slabs and
        query as one contiguous series."""
        e, ts, clock = make_tsdb()
        clock.t += SLAB_S - FINE_RES_S  # last sample slot of the slab
        g = e.metrics.gauge("x.y", "x")
        t0 = clock.t
        for i in range(3):
            g.set(i)
            ts.record()
            clock.t += FINE_RES_S
        pts = ts.query("x.y", t0, clock.t)
        assert [v for _, v in pts] == [0.0, 1.0, 2.0]


class TestMaintenance:
    def test_rollup_and_prune(self):
        e, ts, clock = make_tsdb()
        g = e.metrics.gauge("m.n", "x")
        t0 = clock.t
        # one hour of samples at 10s
        for i in range(SLAB_S // FINE_RES_S):
            g.set(float(i % 30))
            ts.record()
            clock.t += FINE_RES_S
        # advance past the fine retention; roll up
        clock.t += 7 * 3600
        out = ts.maintain(retention_fine_s=6 * 3600)
        # one slab per recorded series (the engine registers some
        # metrics at construction, so >= covers m.n plus those)
        assert out["rolled_up"] >= 1
        # fine samples are gone, coarse remain and answer queries
        pts = ts.query("m.n", t0, t0 + SLAB_S,
                       downsample_s=COARSE_RES_S)
        assert len(pts) == SLAB_S // COARSE_RES_S
        # each coarse bucket is the average of its fine samples
        assert abs(pts[0][1] - sum(i % 30 for i in range(30)) / 30) \
            < 1e-9
        # prune everything beyond coarse retention
        clock.t += 40 * 24 * 3600
        out = ts.maintain(retention_coarse_s=30 * 24 * 3600)
        assert out["pruned"] >= 1
        assert ts.query("m.n", t0, t0 + SLAB_S) == []


class TestMaintenanceIdempotent:
    def test_second_maintain_is_a_noop(self):
        """maintain() twice at the same clock: the second pass finds
        nothing to roll up or prune, and queries are unchanged."""
        e, ts, clock = make_tsdb()
        g = e.metrics.gauge("m.idem", "x")
        t0 = clock.t
        for i in range(SLAB_S // FINE_RES_S):
            g.set(float(i))
            ts.record()
            clock.t += FINE_RES_S
        clock.t += 7 * 3600
        first = ts.maintain(retention_fine_s=6 * 3600)
        assert first["rolled_up"] >= 1
        before = ts.query("m.idem", t0, t0 + SLAB_S,
                          downsample_s=COARSE_RES_S)
        second = ts.maintain(retention_fine_s=6 * 3600)
        assert second == {"rolled_up": 0, "pruned": 0}
        after = ts.query("m.idem", t0, t0 + SLAB_S,
                         downsample_s=COARSE_RES_S)
        assert after == before

    def test_rollup_preserves_query_continuity(self):
        """A window straddling the rollup horizon answers from coarse
        and fine slabs as one series (fine wins where both exist)."""
        e, ts, clock = make_tsdb()
        g = e.metrics.gauge("m.cont", "x")
        t0 = clock.t
        # two hours of samples; only the first ages past retention
        for i in range(2 * SLAB_S // FINE_RES_S):
            g.set(float(i))
            ts.record()
            clock.t += FINE_RES_S
        clock.t = t0 + SLAB_S + 6 * 3600 + FINE_RES_S
        ts.maintain(retention_fine_s=6 * 3600)
        pts = ts.query("m.cont", t0, t0 + 2 * SLAB_S,
                       downsample_s=COARSE_RES_S)
        assert len(pts) == 2 * SLAB_S // COARSE_RES_S
        # values keep ascending across the coarse/fine seam
        vals = [v for _, v in pts]
        assert vals == sorted(vals)


class TestRetentionSetting:
    def test_retention_setting_drives_maintenance(self):
        """`timeseries.retention.seconds` (cluster setting) is the
        fine-slab retention the node's maintenance pass actually uses:
        at the default the hour-old slab survives, after shrinking the
        setting the same pass rolls it up."""
        n = Node(NodeConfig(http_port=0, listen_port=0, device="cpu"))
        n.start()
        try:
            clock = FakeClock()
            n.tsdb.now_s = clock
            g = n.engine.metrics.gauge("ret.g", "x")
            t0 = clock.t
            for i in range(SLAB_S // FINE_RES_S):
                g.set(float(i))
                n.tsdb.record()
                clock.t += FINE_RES_S
            # 2h later: inside the 6h default, nothing rolls up
            clock.t = t0 + SLAB_S + 2 * 3600
            n.run_ts_maintenance()
            fine_key = f"/ts/{FINE_RES_S}/ret.g/".encode()
            assert list(n.engine.kv.scan(fine_key,
                                         fine_key + b"\xff"))
            # shrink retention to 1h: the same pass now rolls up
            n.settings.set("timeseries.retention.seconds", 3600)
            n.run_ts_maintenance()
            assert not list(n.engine.kv.scan(fine_key,
                                             fine_key + b"\xff"))
            pts = n.tsdb.query("ret.g", t0, t0 + SLAB_S,
                               downsample_s=COARSE_RES_S)
            assert len(pts) == SLAB_S // COARSE_RES_S
        finally:
            n.stop()


class TestDeviceUtilizationSeries:
    def test_device_family_recorded_and_queryable(self):
        """The exec.device.* func-metrics are scalars, so record()
        keeps them and /ts/query-style reads graph a history — the
        device-utilization plane's storage path."""
        e, ts, clock = make_tsdb()
        t0 = clock.t
        for _ in range(4):
            e.devstats.note_execute(0.5)
            ts.record()
            clock.t += FINE_RES_S
        names = ts.list_metrics()
        for fam in ("exec.device.hbm.bytes", "exec.device.hbm.watermark",
                    "exec.device.util.seconds", "exec.device.queue.depth"):
            assert fam in names, f"{fam} not recorded"
        pts = ts.query("exec.device.util.seconds", t0, clock.t)
        assert [v for _, v in pts] == [0.5, 1.0, 1.5, 2.0]
        # as a rate: 0.5s of device time per 10s wall = 0.05 util
        rate = ts.query("exec.device.util.seconds", t0, clock.t,
                        rate=True)
        assert all(abs(v - 0.05) < 1e-9 for _, v in rate)


class TestNodeIntegration:
    def test_http_endpoints(self):
        n = Node(NodeConfig(http_port=0, listen_port=0, device="cpu"))
        n.start()
        try:
            n.engine.execute("CREATE TABLE t (a INT)")
            n.engine.execute("INSERT INTO t VALUES (1)")
            n.tsdb.record()
            host, port = n.http_addr
            names = json.loads(urllib.request.urlopen(
                f"http://{host}:{port}/ts/metrics",
                timeout=5).read())
            assert "sql.exec.latency" not in names  # histograms skipped
            assert any(x.startswith("sql.") for x in names)
            name = names[0]
            pts = json.loads(urllib.request.urlopen(
                f"http://{host}:{port}/ts/query?name={name}"
                f"&start=0&end=4000000000", timeout=5).read())
            assert isinstance(pts, list) and pts
        finally:
            n.stop()

    def test_http_server_side_downsample(self):
        """/ts/query applies downsample/agg/rate on the server; a
        missing name is a 400, not a stack trace."""
        n = Node(NodeConfig(http_port=0, listen_port=0, device="cpu"))
        n.start()
        try:
            g = n.engine.metrics.gauge("http.ds", "x")
            clock = FakeClock()
            n.tsdb.now_s = clock
            t0 = clock.t
            for i in range(12):
                g.set(float(i))
                n.tsdb.record()
                clock.t += FINE_RES_S
            host, port = n.http_addr
            base = (f"http://{host}:{port}/ts/query?name=http.ds"
                    f"&start={t0}&end={clock.t}")
            ds = json.loads(urllib.request.urlopen(
                base + "&downsample=60&agg=max", timeout=5).read())
            assert [v for _, v in ds] == [5.0, 11.0]
            rate = json.loads(urllib.request.urlopen(
                base + "&rate=1", timeout=5).read())
            assert all(abs(v - 0.1) < 1e-9 for _, v in rate)
            try:
                urllib.request.urlopen(
                    f"http://{host}:{port}/ts/query?start=0",
                    timeout=5)
                raise AssertionError("expected HTTP 400")
            except urllib.error.HTTPError as ex:
                assert ex.code == 400
        finally:
            n.stop()


# -- statement statistics -------------------------------------------------------

STATS_SETUP = ["CREATE TABLE kv (k INT8 NOT NULL PRIMARY KEY, v INT8)",
               "INSERT INTO kv VALUES (1, 10), (2, 20), (3, 30), (4, 40)"]


def _stats_script(n: int) -> list:
    out = []
    for i in range(n):
        k = i % 4 + 1
        out += [f"SELECT v FROM kv WHERE k = {k}",            # lane
                f"UPDATE kv SET v = {i} WHERE k = {k}",       # lane
                f"SELECT sum(v) FROM kv WHERE k <= {k}",      # full path
                f"SELECT k, v FROM kv WHERE v >= {i} ORDER BY k"]
    return out + ["SELECT nope FROM kv", "SELECT nope FROM kv"]


def _stats(eng) -> tuple:
    for sql in STATS_SETUP + _stats_script(6):
        try:
            eng.execute(sql)
        except Exception:
            pass
    rows = sorted((s.fingerprint, s.count, s.total_rows, s.failures)
                  for s in eng.sqlstats.all())
    show = sorted((r[0], r[1], r[4], r[5])
                  for r in eng.execute("SHOW STATEMENTS").rows)
    return rows, show, eng.lane_hits


def test_statement_stats_equal_reference():
    with reference_modules("cockroach_tpu.exec.engine") as (jeng,):
        ref = jeng.Engine()
        try:
            want = _stats(ref)
        finally:
            ref.close()
    got = _stats(Engine(device="cpu"))
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2] >= 12          # the lane served its shapes
    fps = {r[0]: r for r in got[0]}
    assert fps["SELECT v FROM kv WHERE k = ?"][1] == 6
    assert fps["SELECT nope FROM kv"][3] == 2


def test_statements_endpoint_lists_fingerprints():
    n = Node(NodeConfig(device="cpu")).start()
    try:
        for sql in STATS_SETUP + _stats_script(2)[:-2]:
            n.engine.execute(sql)
        host, port = n.http_addr
        body = json.loads(urllib.request.urlopen(
            f"http://{host}:{port}/_status/statements", timeout=5).read())
        counts = {s["fingerprint"]: s["count"] for s in body["statements"]}
        assert counts["SELECT v FROM kv WHERE k = ?"] == 2
        assert counts["SELECT sum(v) FROM kv WHERE k <= _"] == 2
        s0 = body["statements"][0]
        assert sum(s0["latency_buckets"]) == s0["count"]
    finally:
        n.stop()
