"""Kernel 1's launch-point autotuner (ops/cuda/autotune.py).

The tuning table's plumbing: a corrupt table, a stale version, an
invalid entry and another card's entry all degrade to the shipped point
with the miss counted; ``off`` never reads the table; a sweep through an
injected timer persists its winner, which a fresh lookup (and an engine
built after it) reads back without sweeping; `auto` never sweeps, and
a lead under MARGIN keeps the shipped point. Every candidate's limb
width keeps the exactness bounds, and the plain version's results, and
an engine's rows, do not depend on the point.

Card-only (marked ``gpu``, skipped here; run them on a card with
``python -m pytest tests/test_torch_autotune.py --noconftest -q``):
every launch point held bit for bit against the plain version, and the
parity gate's fuzz on the CUDA kernel in both layouts at every point.
This file imports no JAX.
"""

import json
import os

import numpy as np
import pytest
import torch

from cockroach_tpu_torch.ops.cuda import autotune as at
from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
from cockroach_tpu_torch.ops.cuda import paritygate as pgate


@pytest.fixture(autouse=True)
def fresh():
    at.forget()
    yield
    at.forget()


def _write(root, payload) -> None:
    os.makedirs(root, exist_ok=True)
    with open(at.table_path(str(root)), "w", encoding="utf-8") as f:
        f.write(payload if isinstance(payload, str) else json.dumps(payload))


def _entry(p) -> dict:
    return {"block": p[0], "rows": p[1], "min_blocks": p[2],
            "limb_cap": p[3]}


@pytest.mark.parametrize("case", ["corrupt", "stale", "invalid",
                                  "foreign", "missing"])
def test_bad_table_degrades_to_the_shipped_point(tmp_path, case):
    good = _entry(at.CANDIDATES[2])
    payload = {
        "corrupt": "{not json",
        "stale": {"version": at.TABLE_VERSION + 1,
                  "tables": {"cpu": good}},
        "invalid": {"version": at.TABLE_VERSION,
                    "tables": {"cpu": dict(good, rows=3)}},
        "foreign": {"version": at.TABLE_VERSION,
                    "tables": {"NVIDIA H100 80GB HBM3": good}},
    }.get(case)
    if payload is not None:
        _write(tmp_path, payload)
    m0, h0, r0 = (at.TABLE.value("miss"), at.TABLE.value("hit"),
                  at.RUNS.value("sweep"))
    assert at.params_for("cpu", str(tmp_path), "auto", "cpu") == at.DEFAULT
    assert at.TABLE.value("miss") == m0 + 1
    assert at.TABLE.value("hit") == h0 and at.RUNS.value("sweep") == r0


def test_off_never_reads_the_table(tmp_path, monkeypatch):
    _write(tmp_path, {"version": at.TABLE_VERSION,
                      "tables": {"cpu": _entry(at.CANDIDATES[1])}})

    def no_read(root):
        raise AssertionError("off read the tuning table")
    monkeypatch.setattr(at, "load_table", no_read)
    m0, h0 = at.TABLE.value("miss"), at.TABLE.value("hit")
    assert at.params_for("cpu", str(tmp_path), "off", "cpu") == at.DEFAULT
    assert (at.TABLE.value("miss"), at.TABLE.value("hit")) == (m0, h0)
    with pytest.raises(ValueError, match="not a mode"):
        at.params_for("cpu", str(tmp_path), "sometimes", "cpu")


def test_sweep_persists_and_reloads(tmp_path):
    winner = at.CANDIDATES[4]
    timed = []

    def timer(point, run):
        res = run()
        assert isinstance(res, tgl.SlotResult)
        timed.append(point)
        return 1.0 if point == winner else 2.0 + at.CANDIDATES.index(point)

    r0 = at.RUNS.value("sweep")
    assert at.params_for("cpu", str(tmp_path), "on", "cpu",
                         timer=timer) == winner
    assert timed == list(at.CANDIDATES)
    assert at.RUNS.value("sweep") == r0 + 1
    table = at.load_table(str(tmp_path))["cpu"]
    assert (table["block"], table["rows"], table["min_blocks"],
            table["limb_cap"]) == winner
    assert table["timings"][at.point_name(winner)] == 1.0
    # a fresh process (no memo) reads it back without a sweep
    at.forget()
    h0 = at.TABLE.value("hit")
    assert at.params_for("cpu", str(tmp_path), "auto", "cpu") == winner
    assert at.TABLE.value("hit") == h0 + 1
    assert at.RUNS.value("sweep") == r0 + 1
    # and so does an engine over the same root
    from cockroach_tpu_torch.exec import coldstart
    at.forget()
    from cockroach_tpu_torch.exec.engine import Engine
    e = Engine(device="cpu")
    e._compile_cache_dir = str(tmp_path)
    e.execute("CREATE TABLE t (k INT8 NOT NULL, g INT8 NOT NULL, "
              "v INT8 NOT NULL)")
    n = 8192
    e.store.insert_columns("t", {"k": np.arange(n), "g": np.arange(n) % 9,
                                 "v": np.arange(n) * 3}, e.clock.now())
    seen = []
    kernel = tgl.aggregate_slots

    def recording(*args, **kw):
        seen.append(kw.get("point"))
        return kernel(*args, **kw)
    tgl.aggregate_slots = recording
    try:
        e.execute("SELECT g, sum(v) FROM t GROUP BY g")
    finally:
        tgl.aggregate_slots = kernel
    e.close()
    assert seen == [winner] and at.RUNS.value("sweep") == r0 + 1
    assert coldstart.device_key(torch.device("cpu")) == "cpu"


def test_auto_never_sweeps_and_a_small_lead_keeps_the_shipped_point(
        tmp_path):
    """`auto` without a table entry takes the shipped point on a card
    too, without a sweep; a sweep's fastest point displaces the shipped
    one only by a lead of more than MARGIN."""
    r0 = at.RUNS.value("sweep")
    assert at.params_for("NVIDIA H100 80GB HBM3", str(tmp_path), "auto",
                         "cuda") == at.DEFAULT
    assert at.RUNS.value("sweep") == r0
    close = at.CANDIDATES[1]

    def timer(point, run):
        run()
        return 1.0 - at.MARGIN / 2 if point == close else 1.0
    sweep = at.autotune("cpu", str(tmp_path), "cpu", timer=timer)
    assert sweep.best == at.DEFAULT
    assert sweep.timings[at.point_name(close)] < \
        sweep.timings[at.point_name(at.DEFAULT)]
    at.forget()
    assert at.params_for("cpu", str(tmp_path), "auto", "cpu") == at.DEFAULT
    assert at.RUNS.value("sweep") == r0 + 1


@pytest.mark.parametrize("point", at.CANDIDATES)
def test_every_point_keeps_the_exactness_bound(point):
    block, rows, mb, cap = point
    assert tgl.kernel_point(point) == (block, rows, mb)
    assert block * mb <= 2048 and 32 * rows <= 256
    for n in (128, 1024, 4096, 1 << 16, 6_001_280, 1 << 23, 1 << 26):
        n = -(-n // 128) * 128
        for maxg in (1, 7, 1000, n // 3, n):
            w = tgl.limb_width(n, maxg, block_rows=block * rows, cap=cap)
            blk = tgl.row_block(n, block * rows)
            assert 1 <= w <= cap
            # every group's int32 running sum
            assert max(1, min(maxg, n)) * ((1 << w) - 1) < 1 << 31
            # a tile's partial (the reference's f32 block bound)
            assert blk * ((1 << w) - 1) < 1 << 24
            # a warp's unsigned reduction of 32 * rows limbs
            assert 32 * rows * ((1 << w) - 1) < 1 << 32
    if point == at.DEFAULT:
        assert tgl.limb_width(1 << 20, 1000, block_rows=block * rows,
                              cap=cap) == tgl.limb_width(1 << 20, 1000)


def _slot_inputs(device, seed=5, n=1 << 14, G=300):
    rng = np.random.default_rng(seed)
    gid = torch.tensor(rng.integers(-3, G + 3, n), dtype=torch.int32,
                       device=device)
    sel = torch.tensor(rng.random(n) < 0.8, device=device)
    mask = torch.tensor(rng.random(n) < 0.9, device=device)
    v = torch.tensor(rng.integers(-(1 << 62), 1 << 62, n), device=device)
    f = torch.tensor(rng.standard_normal(n) * 100, device=device)
    return gid, sel, mask, v, f, G


def _slots(point, mask, v, f, n, G):
    w = tgl.limb_width(n, n, block_rows=point[0] * point[1], cap=point[3])
    k = -(-64 // w)
    return (tgl.i64sum(v, mask, w, k), tgl.count(mask), tgl.count(),
            tgl.minmax(v, mask, tgl.MIN), tgl.minmax(v, None, tgl.MAX),
            tgl.f32sum(f, mask))


def _recombined(res, point, n):
    """The i64 sum recombined from its limbs, and every other row."""
    w = tgl.limb_width(n, n, block_rows=point[0] * point[1], cap=point[3])
    k = -(-64 // w)
    r0, frow, mx = res.rows[0]
    shifts = torch.arange(0, k * w, w, dtype=torch.int64,
                          device=res.acc_i.device)
    total = (res.acc_i[r0:r0 + k].to(torch.int64) << shifts[:, None]).sum(0)
    return total, res.acc_i[res.rows[1]], res.acc_i[res.rows[2]], \
        res.acc_f[res.rows[3]], res.acc_f[res.rows[4]], res.maxabs[mx], \
        res.acc_i[res.rep_row]


def test_plain_results_do_not_depend_on_the_point():
    gid, sel, mask, v, f, G = _slot_inputs("cpu")
    n = gid.shape[0]
    base = None
    for p in at.CANDIDATES:
        res = tgl.aggregate_slots(gid, sel, _slots(p, mask, v, f, n, G), G,
                                  True, point=p)
        got = _recombined(res, p, n)
        if base is None:
            base = got
        for a, b in zip(got, base):
            assert torch.equal(a, b), p
    with pytest.raises(ValueError, match="no kernel instantiation"):
        tgl.aggregate_slots(gid, sel, _slots(at.DEFAULT, mask, v, f, n, G),
                            G, point=(64, 4, 4, 22))


def test_engine_rows_do_not_depend_on_the_point(tmp_path, monkeypatch):
    from cockroach_tpu_torch.exec.engine import Engine
    rng = np.random.default_rng(3)
    n = 20_000
    cols = {"g": rng.integers(0, 700, n), "v": rng.integers(-10**13,
                                                            10**13, n),
            "d": rng.integers(0, 10**9, n)}
    sql = ("SELECT g, sum(v), avg(v), count(*), sum(d), min(v), max(v) "
           "FROM t GROUP BY g ORDER BY g")
    rows = []
    for p in at.CANDIDATES:
        monkeypatch.setattr(at, "params_for", lambda *a, p=p, **k: p)
        e = Engine(device="cpu")
        e.execute("CREATE TABLE t (g INT8 NOT NULL, v INT8 NOT NULL, "
                  "d DECIMAL(12,2) NOT NULL)")
        e.store.insert_columns("t", dict(cols, d=cols["d"] / 100),
                               e.clock.now())
        calls = tgl.PLAIN_CALLS
        rows.append(e.execute(sql).rows)
        assert tgl.PLAIN_CALLS == calls + 1
        e.close()
    assert all(r == rows[0] for r in rows[1:]) and len(rows[0]) == 700


# -- on a card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("point", at.CANDIDATES)
@pytest.mark.parametrize("G", [12, 4096, 200_000])
def test_every_point_equals_the_plain_version_on_a_card(cuda, point, G):
    from cockroach_tpu_torch.ops.cuda.groupagg_large_check import (
        compare_plain)
    gid, sel, mask, v, f, _ = _slot_inputs(cuda, seed=G, n=1 << 20, G=G)
    n = gid.shape[0]
    slots = _slots(point, mask, v, f, n, G)
    before = tgl.LAUNCHES
    res = tgl.aggregate_slots(gid, sel, slots, G, True, point=point)
    torch.cuda.synchronize()
    assert tgl.LAUNCHES == before + 1
    want = tgl.aggregate_slots_plain(gid, sel, slots, G, True)
    # integer rows (limbs, counts, REPMIN), max-|value| words and MIN/MAX
    # rows bit for bit; f32 sums as the card tests hold them (atomic
    # order), through compare_plain
    assert torch.equal(res.acc_i, want.acc_i)
    assert torch.equal(res.maxabs, want.maxabs)
    for r in (res.rows[3], res.rows[4]):
        assert torch.equal(res.acc_f[r], want.acc_f[r])
    compare_plain((gid, sel, slots, G, True), res)


@pytest.mark.gpu
@pytest.mark.parametrize("point", at.CANDIDATES)
def test_parity_gate_fuzz_on_the_cuda_kernel(cuda, tmp_path, point):
    pgate.forget()
    before = tgl.LAUNCHES
    got = pgate.fuzz(torch.cuda.get_device_name(cuda), str(tmp_path), cuda,
                     point)
    # three seeds in each of the two layouts a path; a path's fuzz
    # stops at its first difference
    launched = tgl.LAUNCHES - before
    assert launched == 12 if "float_sum" in got else 7 <= launched < 12
    assert "int_minmax" in got
    assert pgate.load_table(str(tmp_path))[
        torch.cuda.get_device_name(cuda)]["exact"] == sorted(got)
