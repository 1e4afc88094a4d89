"""Holding the large-G kernel against its plain version.

``compare_plain(args, got)`` checks a kernel's ``SlotResult`` for
``aggregate_slots(*args)`` against ``aggregate_slots_plain(*args)`` on
the same tensors, slot by slot as the caller reads them (through
``rows`` and ``rep_row``); ``synthetic_slots`` makes seeded slot inputs
with the extremes the kernel must survive. ``chip_smoke.py``, the card
tests and ``bench_groupagg_large`` use both.
"""

from __future__ import annotations

import torch

from . import groupagg_large as tgl


def _magnitude(gid, sel, slot, G: int) -> torch.Tensor:
    """Per group, the sum of |f32(value)| over the rows a sum slot adds:
    the scale f32 accumulation error is measured against."""
    ok = (gid >= 0) & (gid < G)
    idx = torch.where(ok, gid.to(torch.int64), G)
    m = sel if slot.mask is None else sel & slot.mask
    v = slot.value.to(torch.int64 if slot.kind == "i64sum"
                      else torch.float64)
    a = torch.where(m, v, 0).to(torch.float32).abs().to(torch.float64)
    mag = torch.zeros(G + 1, dtype=torch.float64, device=gid.device)
    mag.index_add_(0, idx, a)
    return mag[:G].cpu()


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """f32 rows equal bit for bit, any NaN equal to any NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(
        a[~na].view(torch.int32), b[~nb].view(torch.int32))


def compare_plain(args: tuple, got: tgl.SlotResult) -> dict:
    """`got`, the kernel's result for aggregate_slots(*args), against the
    plain version on the same tensors, per caller slot: count and limb
    rows, REPMIN and max-|value| exactly, MIN/MAX rows bit for bit, f32
    sums (shadows and FLOAT sums) within 1e-5 of the group's sum of
    |f32(value)|, since the kernel adds in another order and values may
    have both signs. Raises AssertionError on a mismatch; returns the
    largest absolute and relative f32 sum errors."""
    gid, sel, slots, G = args[0], args[1], args[2], args[3]
    if gid.is_cuda:
        torch.cuda.synchronize()
    want = tgl.aggregate_slots_plain(*args)
    if got.rows != want.rows or got.rep_row != want.rep_row:
        raise AssertionError("slot rows differ from the plain version's")
    kf, ki, kmx = (t.cpu() for t in (got.acc_f, got.acc_i, got.maxabs))
    pf, pi, pmx = (t.cpu() for t in (want.acc_f, want.acc_i, want.maxabs))
    sel_b = sel.to(torch.bool)
    worst_abs = worst_rel = 0.0

    def near(label, row, slot):
        nonlocal worst_abs, worst_rel
        mag = _magnitude(gid, sel_b, slot, G)
        err = (kf[row].to(torch.float64) - pf[row].to(torch.float64)).abs()
        if bool(torch.any(err > 1e-5 * mag)):
            raise AssertionError(f"{label}: f32 sums beyond 1e-5 of the "
                                 "group's magnitude")
        worst_abs = max(worst_abs, float(err.max()))
        worst_rel = max(worst_rel, float((err / mag.clamp(min=1e-30))
                                         .max()))

    for s, (slot, r) in enumerate(zip(slots, got.rows)):
        label = f"slot {s} ({slot.kind})"
        if slot.kind == "count":
            if not torch.equal(ki[r], pi[r]):
                raise AssertionError(f"{label}: count row differs")
        elif slot.kind == "i64sum":
            r0, frow, mx = r
            if not torch.equal(ki[r0:r0 + slot.k], pi[r0:r0 + slot.k]):
                raise AssertionError(f"{label}: limb rows differ")
            if not torch.equal(kmx[mx], pmx[mx]):
                raise AssertionError(f"{label}: max-|value| differs")
            near(label, frow, slot)
        elif slot.kind == "f32sum":
            near(label, r, slot)
        elif not _same_bits(kf[r], pf[r]):
            raise AssertionError(f"{label}: MIN/MAX row differs")
    if got.rep_row >= 0 and not torch.equal(ki[got.rep_row],
                                            pi[got.rep_row]):
        raise AssertionError("REPMIN row differs")
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel}


def synthetic_slots(n, G, w, seed, device="cuda", gid_lo=0, gid_hi=None,
                    sel_frac=0.8) -> tuple:
    """Seeded slot inputs: int64 values with negatives, INT64_MIN and
    INT64_MAX (summed and averaged, so folded), non-negative values with
    a capped limb count, an int32 column, NULL masks, INT and FLOAT
    MIN/MAX with NaN and -0.0, a FLOAT sum, counts over masks and over
    sel. Returns aggregate_slots' arguments (gid, sel, slots, G, True)."""
    g = torch.Generator(device=device).manual_seed(seed)
    hi = G if gid_hi is None else gid_hi

    def rand():
        return torch.rand(n, generator=g, device=device)

    gid = torch.randint(gid_lo, hi, (n,), generator=g, device=device,
                        dtype=torch.int32)
    sel = rand() < sel_frac
    m1, m2, mf = (rand() < 0.9 for _ in range(3))
    v1 = torch.randint(-(1 << 50), 1 << 50, (n,), generator=g,
                       device=device)
    ext = torch.tensor([-(1 << 63), (1 << 63) - 1, -1], device=device)
    v1 = torch.where(rand() < 0.125, ext[torch.randint(
        0, 3, (n,), generator=g, device=device)], v1)
    v2 = torch.randint(0, 1 << 18, (n,), generator=g, device=device)
    v3 = torch.randint(-(1 << 31), (1 << 31) - 1, (n,), generator=g,
                       device=device, dtype=torch.int32)
    f = torch.randn(n, generator=g, device=device,
                    dtype=torch.float64) * 100
    f = torch.where(rand() < 0.03, -0.0, f)
    f = torch.where((gid % 97 == 5) & (rand() < 0.02), float("nan"), f)
    fpos = rand().double() * 1000
    full = -(-64 // w)
    slots = (tgl.count(), tgl.count(m1), tgl.i64sum(v1, m1, w, full),
             tgl.count(m1), tgl.i64sum(v1, m1, w, full),
             tgl.i64sum(v2, m2, w, -(-18 // w)), tgl.count(m2),
             tgl.i64sum(v2, m2, w, full), tgl.i64sum(v3, None, w, full),
             tgl.minmax(v1, m1, tgl.MIN), tgl.minmax(v1, m1, tgl.MAX),
             tgl.minmax(f, mf, tgl.MIN), tgl.minmax(f, mf, tgl.MAX),
             tgl.f32sum(fpos, mf), tgl.count())
    return gid, sel, slots, G, True
