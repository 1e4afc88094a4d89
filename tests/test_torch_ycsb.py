"""YCSB through the port against the JAX package's workload client.

For each mix A-F, the reference's YCSB drives the reference Engine and
the port's copy drives ``Engine(device="cpu")`` from the same seed over
2,000 records: every statement (the operation sequence), every result
row (reads and scans) and every write's outcome must be equal, and so
must the final table. The primary-key range fastpath's rows equal the
same scans through the device path (``SET index_scan = off`` puts the
fastpath out of reach) after the E mix's inserts. ``run_concurrent``
holds its invariants (its thread order is not deterministic).
"""

import pytest

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.workload.ycsb import MIXES, YCSB
from tests.test_torch_groupagg_large import reference_modules

RECORDS = 2_000
STEPS = 300
FINAL = "SELECT ycsb_key, field0, field1 FROM usertable ORDER BY ycsb_key"


class Recorder:
    """An engine front that records each statement and its outcome."""

    def __init__(self, eng):
        self.eng = eng
        self.log: list = []

    def execute(self, sql, session=None):
        res = self.eng.execute(sql, session)
        self.log.append((sql, res.tag, list(res.rows),
                         getattr(res, "row_count", 0)))
        return res


def _drive(eng, ycsb_cls, workload):
    rec = Recorder(eng)
    y = ycsb_cls(rec, workload, records=RECORDS, seed=1)
    y.setup()
    y.run(STEPS)
    return rec.log, dict(y.ops), eng.execute(FINAL).rows


@pytest.fixture(scope="module")
def reference():
    out = {}
    with reference_modules("cockroach_tpu.exec.engine",
                           "cockroach_tpu.workload.ycsb") as (jeng, jy):
        for w in sorted(MIXES):
            e = jeng.Engine()
            try:
                out[w] = _drive(e, jy.YCSB, w)
            finally:
                e.close()
    return out


@pytest.mark.parametrize("workload", sorted(MIXES))
def test_ycsb_mix_equals_reference(reference, workload):
    want_log, want_ops, want_final = reference[workload]
    got_log, got_ops, got_final = _drive(Engine(device="cpu"), YCSB,
                                         workload)
    assert got_ops == want_ops
    assert len(got_log) == len(want_log)
    for g, w in zip(got_log, want_log):
        assert g == w, (g[0][:120], g[1:], w[1:])
    assert got_final == want_final
    assert len(got_final) == RECORDS + got_ops["insert"]


def test_range_fastpath_equals_device_path():
    """The OLTP lane serves an auto-commit scan, the range fastpath the
    same scan inside a transaction (the lane stays out of explicit
    txns), the device path it under SET index_scan = off: all equal."""
    eng = Engine(device="cpu")
    y = YCSB(eng, "E", records=RECORDS, seed=5)
    y.setup()
    y.run(200)
    off = eng.session()
    eng.execute("SET index_scan = off", off)
    txn = eng.session()
    fast = eng.metrics.counter("sql.select.range_fastpath")
    for k in (0, 17, 1_999, RECORDS + 3, y.next_key - 2, y.next_key + 5):
        sql = (f"SELECT ycsb_key, field0 FROM usertable WHERE ycsb_key "
               f">= {k} ORDER BY ycsb_key LIMIT 10")
        n0, h0 = fast.value(), eng.lane_hits
        got = eng.execute(sql).rows
        assert (fast.value(), eng.lane_hits) == (n0, h0 + 1)  # the lane
        eng.execute("BEGIN", txn)
        in_txn = eng.execute(sql, txn).rows
        eng.execute("COMMIT", txn)
        assert fast.value() == n0 + 1        # the fastpath served it
        want = eng.execute(sql, off).rows
        assert (fast.value(), eng.lane_hits) == (n0 + 1, h0 + 1)
        assert got == in_txn == want
        assert [r[0] for r in got] == list(range(k, min(k + 10,
                                                        y.next_key)))


@pytest.mark.parametrize("workload", ["A", "E"])
def test_run_concurrent_invariants(workload):
    """4 drivers over 2,000 records: the run finishes within its
    timeout, every key's field0 is its loaded value or one some driver
    wrote to it, every insert landed once, count and sum(field1) are
    exact, and the lane's rows equal the device path's."""
    eng = Engine(device="cpu")
    y = YCSB(eng, workload, records=RECORDS, seed=1)
    y.setup()
    res = y.run_concurrent(800, workers=4, record_latency=True,
                           session_vars={"oltp_batch": "auto"},
                           timeout=120.0)
    assert sum(res["ops"].values()) == 800 and res["p99_ms"] > 0
    values = {i: {i * 7 % 1000} for i in range(RECORDS)}
    inserted = {}
    for d in y.drivers:
        for k, v in d.writes:
            if k >= RECORDS:
                assert k not in inserted
                inserted[k] = v
            values.setdefault(k, set()).add(v)
    assert len(inserted) == res["ops"]["insert"]
    rows = eng.execute(FINAL).rows
    assert len(rows) == RECORDS + len(inserted)
    for k, f0, f1 in rows:
        assert f0 in values[k], k
        assert f1 == (k * 13 % 1000 if k < RECORDS else 0)
    want = (len(rows), sum(r[2] for r in rows))
    assert eng.execute("SELECT count(*), sum(field1) FROM usertable"
                       ).rows == [want]
    for k in (0, 5, RECORDS - 1, *list(inserted)[:3]):
        lane = eng.execute(f"SELECT field0, field1 FROM usertable "
                           f"WHERE ycsb_key = {k}").rows
        assert lane == [r[1:] for r in rows if r[0] == k]


def test_chip_smoke_ycsb_phase_on_the_cpu():
    """chip_smoke.py's YCSB-E (phase 11) at a small size on a CPU
    engine: every statement served by the lane, every scan equal to the
    oracle, then a sample of the scans inside a txn, each through the
    range fastpath once and equal to the oracle."""
    import chip_smoke
    out = chip_smoke.ycsb_phase(Engine(device="cpu"), 2_000, 400)
    assert out["fastpath"]["scans"] == chip_smoke.FASTPATH_SAMPLE
    assert out["final_rows"] == 2_000 + out["mix"]["insert"]
