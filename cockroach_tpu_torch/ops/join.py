"""Hash join on device: build + probe + gather.

The counterpart of cockroach_tpu/ops/join.py ``hash_join`` for unique
build keys (``expand == 1``). The probe side keeps its length: each
probe row gathers its (unique) matching build row's columns, and the
join verdict lands in the selection mask:

  INNER: sel &= matched
  LEFT : sel unchanged; build columns NULL where unmatched
  SEMI : sel &= matched, no build columns
  ANTI : sel &= ~matched

Three ways to find the build row, chosen by the engine as the
reference's does: direct addressing (one scatter builds key -> row, one
gather probes) for a dense single int key, the same over a packed
composite key, and the open-addressing hash table (ops/hashtable.py)
otherwise. Duplicate-keyed build sides (``expand > 1``: the duplicate
chains of the reference's ``_dup_chain``/``_expand_join``) are not
ported yet.

Every gather and scatter index is clamped into range explicitly: JAX
clamps or drops an out-of-range index, torch raises on the CPU and
trips a device-side assert on CUDA.
"""

from __future__ import annotations

import torch

from ..utils.num import next_pow2
from . import hashtable
from .batch import ColumnBatch


def hash_join(probe: ColumnBatch, build: ColumnBatch,
              probe_keys: list[str], build_keys: list[str],
              build_payload: list[str], join_type: str = "inner",
              suffix: str = "", expand: int = 1,
              direct=None, pack_payload=()) -> ColumnBatch:
    """Join `probe` against `build` and return the probe batch extended
    with `build_payload` columns gathered from matches. `direct` is
    None (hash table), (base, size) for a direct-addressed single key,
    or ("packed", los, spans) for a mixed-radix packed composite key."""
    if expand > 1:
        raise NotImplementedError(
            "hash_join with duplicate build keys (expand > 1) is not yet "
            "ported")
    if join_type not in ("inner", "left", "semi", "anti"):
        raise ValueError(f"unsupported join type {join_type!r}")
    bkeys = tuple(build.col(k) for k in build_keys)
    pkeys = tuple(probe.col(k) for k in probe_keys)
    bmask = build.sel
    # build rows with NULL keys never match (SQL join semantics)
    for k in build_keys:
        bmask = torch.logical_and(bmask, build.col_valid(k))
    pmask = probe.sel
    for k in probe_keys:
        pmask = torch.logical_and(pmask, probe.col_valid(k))
    nb = build.n

    if direct is not None and direct[0] == "packed":
        # composite-key direct addressing: mixed-radix-pack the
        # components into ONE synthetic key, then reuse the single-key
        # machinery. The engine proved every component's value range.
        _, los, spans = direct
        bp = torch.zeros(bkeys[0].shape, dtype=torch.int64,
                         device=build.device)
        pp = torch.zeros(pkeys[0].shape, dtype=torch.int64,
                         device=probe.device)
        ok_p = torch.ones(pkeys[0].shape, dtype=torch.bool,
                          device=probe.device)
        for kb, kp, lo, span in zip(bkeys, pkeys, los, spans):
            bp = bp * span + (kb.to(torch.int64) - lo)
            pp = pp * span + (kp.to(torch.int64) - lo)
            ok_p = ok_p & (kp >= lo) & (kp - lo < span)
        size = 1
        for span in spans:
            size *= int(span)
        size += 1
        # an out-of-range component would alias a neighbouring slot
        # after packing: steer the whole packed key out of range
        pp = torch.where(ok_p, pp, size)
        bkeys, pkeys = (bp,), (pp,)
        direct = (0, size)

    if direct is not None and len(bkeys) == 1:
        base, size = direct
        bidx = torch.clamp(bkeys[0].to(torch.int64) - base, 0, size - 1)
        bslot = torch.where(bmask, bidx, size - 1)
        # scatter-min keeps the FIRST (lowest-rowid) duplicate
        table = torch.full((size,), nb, dtype=torch.int32,
                           device=build.device)
        table.scatter_reduce_(0, bslot, torch.arange(
            nb, dtype=torch.int32, device=build.device), reduce="amin",
            include_self=True)
        pk0 = pkeys[0].to(torch.int64)
        in_range = (pk0 >= base) & (pk0 - base < size - 1)
        pidx = torch.clamp(pk0 - base, 0, size - 1)
        if size <= 4 * probe.n:
            return _folded_join(probe, build, table, pidx,
                                pmask & in_range, build_payload,
                                join_type, suffix, pack_payload)
        owner = table[pidx]
        build_row = torch.clamp(owner, max=nb - 1)
        # no key re-check: direct addressing is collision-free (every
        # live build key has its own slot in [0, size-2], dead rows go
        # to the sentinel slot size-1, and in_range keeps probes off it)
        matched = pmask & in_range & (owner < nb)
    else:
        cap = next_pow2(max(2 * nb, 16))
        claim, _, _ = hashtable.build(bkeys, bmask, cap)
        matched, build_row = hashtable.probe(claim, bkeys, pkeys, pmask,
                                             cap, nb)

    if join_type == "semi":
        return probe.and_sel(matched)
    if join_type == "anti":
        return probe.and_sel(torch.logical_not(matched))
    out = probe
    for name in build_payload:
        data = build.col(name)[build_row]
        valid = build.col_valid(name)[build_row] & matched
        out = out.with_column(name + suffix, data, valid)
    return out.and_sel(matched) if join_type == "inner" else out


def _folded_join(probe, build, table, pidx, base_ok, build_payload,
                 join_type, suffix, pack_payload) -> ColumnBatch:
    """Direct join with payload folding: each payload column is first
    gathered over the (small) key domain, so every probe-side gather is
    addressed by the probe key directly instead of through the owner
    row. A dictionary-code payload (int32 >= 0, or bool) also folds the
    match and NULL bits into its table (-2 = no build row, -1 = NULL,
    >= 0 = the code): the whole join is then one probe-side gather."""
    nb = build.n
    owner_slot = torch.clamp(table, max=nb - 1)
    vtab = table < nb                  # slot -> live build row?
    packable = [c for c in build_payload if c in pack_payload
                and build.col(c).dtype in (torch.int32, torch.bool)]
    out = probe
    if packable and join_type in ("inner", "left"):
        matched = None
        for name in build_payload:
            col = build.col(name)
            ptab = col[owner_slot]
            pvtab = build.col_valid(name)[owner_slot]
            if name not in packable:
                out = out.with_column(name + suffix, ptab[pidx],
                                      (pvtab & vtab)[pidx] & base_ok)
                continue
            is_bool = col.dtype == torch.bool
            code = ptab.to(torch.int32) if is_bool else ptab
            packed = torch.where(vtab, torch.where(pvtab, code, -1), -2) \
                .to(torch.int32)
            t = packed[pidx]
            if matched is None:
                matched = base_ok & (t >= -1)
            data = (t == 1) if is_bool else torch.clamp(t, min=0)
            out = out.with_column(name + suffix, data, (t >= 0) & base_ok)
        return out.and_sel(matched) if join_type == "inner" else out
    matched = base_ok & vtab[pidx]
    if join_type == "semi":
        return probe.and_sel(matched)
    if join_type == "anti":
        return probe.and_sel(torch.logical_not(matched))
    for name in build_payload:
        ptab = build.col(name)[owner_slot]
        pvtab = build.col_valid(name)[owner_slot] & vtab
        out = out.with_column(name + suffix, ptab[pidx],
                              pvtab[pidx] & matched)
    return out.and_sel(matched) if join_type == "inner" else out
