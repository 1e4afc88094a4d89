"""Kernel 1's fuzzed parity gate (ops/cuda/paritygate.py) against the
JAX package's.

On the CPU the port's gate (kernel 1's plain version through the
high-limb-plus-refinement formulation) promotes ``int_minmax`` and not
``float_sum``, as the reference's does in interpret mode
(tests/test_pallas_large_g.py ``test_gate_promotes_int_minmax_not_
float_sum``); the verdict persists per device key and a corrupt table
is fuzzed again. The metrics are exported. The reference's end-to-end
case (its ``test_int_minmax_rides_kernel_under_auto_bit_exact``:
adjacent int64 values around 2^40, where an f32 MIN/MAX of the value
would collapse them) runs on both engines: under `auto` the port routes
the GROUP BY to kernel 1's wrapper (its plain version here), and its
rows equal the reference's under `auto` and under `off`, and numpy's.
"""

import json

import numpy as np
import pytest

from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
from cockroach_tpu_torch.ops.cuda import paritygate as pgate
from tests.test_torch_groupagg_large import reference_modules


@pytest.fixture(autouse=True)
def fresh():
    pgate.forget()
    yield
    pgate.forget()


def test_gate_promotes_what_the_reference_promotes(tmp_path):
    calls = tgl.PLAIN_CALLS
    got = pgate.fuzz("cpu", str(tmp_path / "port"), "cpu")
    assert got == ("int_minmax",)
    assert tgl.PLAIN_CALLS == calls   # the wrapper's counts untouched
    assert pgate.load_table(str(tmp_path / "port"))["cpu"]["exact"] == \
        ["int_minmax"]
    with reference_modules("cockroach_tpu.ops.pallas.paritygate") as (rg,):
        want = rg.fuzz("cpu", str(tmp_path / "ref"), interpret=True)
        assert rg.PATHS == pgate.PATHS
        assert rg.MM_HI_SHIFT == pgate.MM_HI_SHIFT
    assert got == want


def test_promoted_reads_the_table_and_refuzzes_a_corrupt_one(tmp_path):
    root = str(tmp_path)
    c0 = pgate.CHECKS.value("exact") + pgate.CHECKS.value("approx")
    m0, h0 = pgate.TABLE.value("miss"), pgate.TABLE.value("hit")
    assert pgate.promoted("cpu", root, "cpu") == ("int_minmax",)
    assert pgate.TABLE.value("miss") == m0 + 1
    assert pgate.CHECKS.value("exact") + pgate.CHECKS.value("approx") \
        == c0 + 2
    pgate.forget()
    assert pgate.promoted("cpu", root, "cpu") == ("int_minmax",)
    assert pgate.TABLE.value("hit") == h0 + 1   # read back, no fuzz
    assert pgate.CHECKS.value("exact") + pgate.CHECKS.value("approx") \
        == c0 + 2
    with open(pgate.table_path(root), "w") as f:
        f.write("{not json")
    assert pgate.load_table(root) == {}
    pgate.forget()
    assert pgate.promoted("cpu", root, "cpu") == ("int_minmax",)
    assert pgate.TABLE.value("miss") == m0 + 2
    with open(pgate.table_path(root)) as f:
        assert json.load(f)["tables"]["cpu"]["exact"] == ["int_minmax"]
    # another card's verdict is not this one's; a verdict naming an
    # unknown path is refused
    with open(pgate.table_path(root), "w") as f:
        json.dump({"version": pgate.TABLE_VERSION, "tables": {
            "cpu": {"exact": ["int_minmax", "warp_magic"]},
            "NVIDIA H100 80GB HBM3": {"exact": ["float_sum"]}}}, f)
    pgate.forget()
    assert pgate.promoted("cpu", root, "cpu") == ("int_minmax",)
    assert pgate.TABLE.value("miss") == m0 + 3


def test_verdict_holds_for_its_kernel_source_and_point(tmp_path,
                                                       monkeypatch):
    """A verdict names the content hash of csrc/groupagg_large.cu and
    the launch point it was fuzzed at: an edited kernel, or another
    point, is fuzzed again; the same source and point read it back."""
    from cockroach_tpu_torch.ops.cuda import autotune as at
    root = str(tmp_path)
    other = at.CANDIDATES[2]
    assert pgate.promoted("cpu", root, "cpu") == ("int_minmax",)
    entry = pgate.load_table(root)["cpu"]
    assert entry["point"] == "256x4x4" and len(entry["kernel"]) == 16
    m0, h0 = pgate.TABLE.value("miss"), pgate.TABLE.value("hit")
    pgate.forget()
    assert pgate.promoted("cpu", root, "cpu", at.DEFAULT) == \
        ("int_minmax",)
    assert pgate.TABLE.value("hit") == h0 + 1
    pgate.forget()
    assert pgate.promoted("cpu", root, "cpu", other) == ("int_minmax",)
    assert pgate.TABLE.value("miss") == m0 + 1
    assert pgate.load_table(root)["cpu"]["point"] == "512x4x2"
    from cockroach_tpu_torch.ops.cuda import build
    monkeypatch.setattr(build, "source_tag", lambda name: "0" * 16)
    pgate.forget()
    assert pgate.promoted("cpu", root, "cpu", other) == ("int_minmax",)
    assert pgate.TABLE.value("miss") == m0 + 2
    assert pgate.load_table(root)["cpu"]["kernel"] == "0" * 16


def test_metrics_exported():
    e = Engine(device="cpu")
    snap = e.metrics.snapshot()
    e.close()
    for want in ("exec.paritygate.checks", "exec.paritygate.seconds",
                 "exec.paritygate.table_hit", "exec.paritygate.table_miss",
                 "exec.autotune.runs", "exec.autotune.seconds",
                 "exec.autotune.table_hit", "exec.autotune.table_miss",
                 "exec.compile.cache_hit", "exec.compile.cache_miss",
                 "exec.compile.seconds", "exec.compile.prewarmed",
                 "exec.compile.prewarm_errors"):
        assert want in snap, want


def _mmx():
    rng = np.random.default_rng(77)
    n = 8192
    gk = rng.integers(0, 64, n).astype(np.int64)
    v = (np.int64(1) << 40) + rng.integers(-1000, 1000, n).astype(np.int64)
    v[rng.random(n) < 0.5] *= -1
    return gk, v


SQL = ("SELECT g, min(v) AS mn, max(v) AS mx FROM mmx "
       "GROUP BY g ORDER BY g")


@pytest.fixture(scope="module")
def reference_rows():
    gk, v = _mmx()
    with reference_modules("cockroach_tpu.exec.engine") as (jeng,):
        e = jeng.Engine()
        try:
            e.execute("CREATE TABLE mmx (g INT8 NOT NULL, v INT8)")
            e.store.insert_columns("mmx", {"g": gk, "v": v}, e.clock.now())
            out = {}
            for mode in ("off", "auto"):
                s = e.session()
                s.vars.set("distsql", "off")
                s.vars.set("pallas_groupagg", mode)
                out[mode] = e.execute(SQL, session=s).rows
            return out
        finally:
            e.close()


def test_int_minmax_rides_kernel_1_under_auto_bit_exact(reference_rows):
    gk, v = _mmx()
    e = Engine(device="cpu")
    e.execute("CREATE TABLE mmx (g INT8 NOT NULL, v INT8)")
    e.store.insert_columns("mmx", {"g": gk, "v": v}, e.clock.now())
    s = e.session()
    s.vars.set("pallas_groupagg", "off")
    calls = tgl.PLAIN_CALLS
    off = e.execute(SQL, session=s).rows
    assert tgl.PLAIN_CALLS == calls
    s.vars.set("pallas_groupagg", "auto")
    seen = []
    kernel = tgl.aggregate_slots

    def recording(*args, **kw):
        seen.append(sorted(slot.kind for slot in args[2]))
        return kernel(*args, **kw)
    tgl.aggregate_slots = recording
    try:
        got = e.execute(SQL, session=s).rows
    finally:
        tgl.aggregate_slots = kernel
    e.close()
    assert tgl.PLAIN_CALLS == calls + 1
    assert seen == [["count", "count", "count", "mm", "mm"]]
    assert got == off == reference_rows["auto"] == reference_rows["off"]
    want = [(g, int(v[gk == g].min()), int(v[gk == g].max()))
            for g in range(64)]
    assert [tuple(int(x) for x in r) for r in got] == want
