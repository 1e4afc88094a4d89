"""YCSB through the port against the JAX package's workload client.

For each mix A-F, the reference's YCSB drives the reference Engine and
the port's copy drives ``Engine(device="cpu")`` from the same seed over
2,000 records: every statement (the operation sequence), every result
row (reads and scans) and every write's outcome must be equal, and so
must the final table. The primary-key range fastpath's rows equal the
same scans through the device path (``SET index_scan = off`` puts the
fastpath out of reach) after the E mix's inserts.
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
    eng = Engine(device="cpu")
    y = YCSB(eng, "E", records=RECORDS, seed=5)
    y.setup()
    y.run(200)
    off = eng.session()
    eng.execute("SET index_scan = off", off)
    fast = eng.metrics.counter("sql.select.range_fastpath")
    for k in (0, 17, 1_999, RECORDS + 3, y.next_key - 2, y.next_key + 5):
        sql = (f"SELECT ycsb_key, field0 FROM usertable WHERE ycsb_key "
               f">= {k} ORDER BY ycsb_key LIMIT 10")
        n0 = fast.value()
        got = eng.execute(sql).rows
        assert fast.value() == n0 + 1        # the fastpath served it
        want = eng.execute(sql, off).rows
        assert fast.value() == n0 + 1        # the device path did
        assert got == want
        assert [r[0] for r in got] == list(range(k, min(k + 10,
                                                        y.next_key)))
