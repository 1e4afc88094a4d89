"""Hash join on device: build + probe + gather, and row expansion.

The counterpart of cockroach_tpu/ops/join.py ``hash_join``. For unique
build keys (``expand == 1``) the probe side keeps its length: each
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
otherwise.

A duplicate-keyed build side (``expand == K > 1``, the engine's static
bound on the key multiplicity) gives probe.n * K output rows: copy j of
probe row p follows the build side's per-key duplicate chain j hops
(``_dup_chain``: one stable sort makes equal keys adjacent runs;
``_expand_join``: K gathers, interleaved copy-minor).

Every gather and scatter index is clamped into range explicitly: JAX
clamps or drops an out-of-range index, torch raises on the CPU and
trips a device-side assert on CUDA.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.num import next_pow2
from . import hashtable, sortkey
from .batch import ColumnBatch

# the largest K a duplicate-keyed build side may expand a probe row to:
# twice the reference engine's MAX_JOIN_EXPANSION of 32, which a
# customer's orders pass at SF 0.1 and up (TPC-H Q13); the engine takes
# K past 32 only for small probe sides (Engine.MAX_WIDE_EXPANDED_ROWS)
MAX_EXPAND = 64

# Fibonacci-multiplicative mix of the host-side spill partitioner (the
# reference's constant, so both engines put a key in the same partition)
_SPILL_MULT = np.uint64(0x9E3779B97F4A7C15)


def radix_partition_ids(cols, valids, nparts: int) -> np.ndarray:
    """Host partition id per row for the spill-partitioned hash join
    (exec/spill.py), bit-equal to the reference's.

    ``cols``/``valids`` are ONE side's stored int-family key columns;
    both sides partition with this function, so every probe/build
    pair hash_join could match (equal values on every key column)
    lands in the same partition. NULL keys hash as 0: they match
    nothing on the card, so any partition is right. ``nparts`` is a
    power of two; ids take the high bits of the mixed word."""
    h = np.zeros(len(cols[0]), dtype=np.uint64)
    for d, v in zip(cols, valids):
        # an int64 view keeps negative keys equal across the int32 and
        # int64 widths the two sides may store
        k = d.astype(np.int64, copy=False).view(np.uint64)
        k = np.where(v, k, np.uint64(0))
        h = (h ^ k) * _SPILL_MULT
    if nparts <= 1:
        return np.zeros(len(h), dtype=np.int64)
    shift = np.uint64(64 - (nparts - 1).bit_length())
    return (h >> shift).astype(np.int64)


def summarize_build_keys(keys: np.ndarray, key_cap: int):
    """Semi-join filter summary of a build side's visible keys
    (exec/joinfilter.py): (lo, hi, sorted unique keys or None, bloom or
    None). Up to ``key_cap`` keys stay exact; past it a blocked bloom
    stands in, which is never false-negative either."""
    from ..storage.chunkstats import BlockedBloom
    keys = np.unique(keys.astype(np.int64, copy=False))
    lo, hi = int(keys[0]), int(keys[-1])
    if len(keys) <= key_cap:
        return lo, hi, keys, None
    bl = BlockedBloom(len(keys))
    bl.add(keys)
    return lo, hi, None, bl


def hash_join(probe: ColumnBatch, build: ColumnBatch,
              probe_keys: list[str], build_keys: list[str],
              build_payload: list[str], join_type: str = "inner",
              suffix: str = "", expand: int = 1,
              direct=None, pack_payload=(),
              sort_normalized: str = "off",
              rounds: dict | None = None) -> ColumnBatch:
    """Join `probe` against `build` and return the probe batch extended
    with `build_payload` columns gathered from matches. `direct` is
    None (hash table), (base, size) for a direct-addressed single key,
    or ("packed", los, spans) for a mixed-radix packed composite key.
    expand=K>1: duplicate build keys, probe.n * K output rows;
    `sort_normalized` picks how the duplicate chains are sorted.
    `rounds`, when given, receives the hash table's "build" and "probe"
    round counts (the host syncs paid) where the hash-table path runs."""
    if expand > MAX_EXPAND:
        raise ValueError(f"join expansion {expand} is past the limit "
                         f"{MAX_EXPAND}")
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
        if expand <= 1 and size <= 4 * probe.n:
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
        claim, _, _, b_rounds = hashtable.build(bkeys, bmask, cap)
        matched, build_row, p_rounds = hashtable.probe(
            claim, bkeys, pkeys, pmask, cap, nb)
        if rounds is not None:
            rounds.update(build=b_rounds, probe=p_rounds)

    if join_type == "semi":
        return probe.and_sel(matched)
    if join_type == "anti":
        return probe.and_sel(torch.logical_not(matched))
    if expand <= 1:
        out = probe
        for name in build_payload:
            data = build.col(name)[build_row]
            valid = build.col_valid(name)[build_row] & matched
            out = out.with_column(name + suffix, data, valid)
        return out.and_sel(matched) if join_type == "inner" else out
    return _expand_join(probe, build, bkeys, bmask, matched, build_row,
                        build_payload, join_type, suffix, expand,
                        sort_normalized)


def _dup_chain(bkeys: tuple, bmask, n: int, mode: str = "off"):
    """next_dup[i] = the next live build row with row i's key (or n).
    One stable sort makes equal live keys adjacent runs in ascending
    row order, so chaining is a shifted compare; the chain start (the
    lowest row per key) is the row the build's claim resolves to.
    Under auto/on the sort goes through packed lanes
    (ops/sortkey.py), under off through successive argsorts; the run
    equality below compares the raw keys, so the chains are the same
    either way."""
    dev = bmask.device
    order = None
    if mode in ("auto", "on"):
        live = torch.ones(n, dtype=torch.bool, device=dev)
        specs = [(k, live, False, False, None, None) for k in bkeys]
        fields = sortkey.encode_keys(specs)
        if fields is not None:
            lanes = sortkey.mask_dead(sortkey.pack_lanes(fields, n, dev),
                                      bmask)
            order = sortkey.sort_perm(lanes, kind="join")
        else:
            sortkey.FALLBACKS.bump("join")
    if order is None:
        dead = torch.logical_not(bmask).to(torch.int32)
        order = sortkey.lexsort(tuple(reversed(bkeys)) + (dead,))
    same = torch.ones(max(n - 1, 0), dtype=torch.bool, device=dev)
    for k in bkeys:
        s = k[order]
        same = same & (s[1:] == s[:-1])
    m_s = bmask[order]
    same = same & m_s[1:] & m_s[:-1]
    nxt = torch.where(same, order[1:], n)
    next_dup = torch.full((n,), n, dtype=order.dtype, device=dev)
    next_dup[order[:-1]] = nxt
    return next_dup


def _expand_join(probe, build, bkeys, bmask, matched, build_row,
                 build_payload, join_type, suffix, K: int,
                 sort_normalized: str = "off") -> ColumnBatch:
    """probe.n * K rows, copy-minor: copy j of probe row p is row
    p * K + j and carries the build row j hops down p's chain."""
    n_b = build.n
    next_dup = _dup_chain(bkeys, bmask, n_b, sort_normalized)
    rows = [build_row.to(torch.int64)]
    has = [matched]
    for _ in range(K - 1):
        nxt = next_dup[torch.clamp(rows[-1], 0, n_b - 1)]
        has.append(has[-1] & (nxt < n_b))
        rows.append(torch.clamp(nxt, max=n_b - 1))

    def interleave(cols):  # K tensors of [n] -> [n * K], copy-minor
        return torch.stack(cols, dim=1).reshape(-1)

    has_i = interleave(has)
    cols, valid = {}, {}
    for i, name in enumerate(probe.names):
        cols[name] = torch.repeat_interleave(probe.data[i], K)
        valid[name] = torch.repeat_interleave(probe.valid[i], K)
    for name in build_payload:
        src, srcv = build.col(name), build.col_valid(name)
        cols[name + suffix] = interleave([src[r] for r in rows])
        valid[name + suffix] = interleave([srcv[r] for r in rows]) & has_i
    sel = torch.repeat_interleave(probe.sel, K)
    if join_type == "inner":
        sel = sel & has_i
    else:  # left: unmatched probe rows keep exactly copy 0
        copy0 = (torch.arange(K, device=probe.device) == 0).repeat(probe.n)
        keep = torch.where(interleave([matched] * K), has_i, copy0)
        sel = sel & keep
    return ColumnBatch.from_dict(cols, valid, sel=sel)


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
