"""Window functions: sort once, then scans, all on the device.

The port of cockroach_tpu/ops/window.py. Rows are sorted by
(partition keys, order keys); every window value is computed in the
sorted domain with cumulative scans and gathers, then scattered back to
the original row order. No per-partition loop exists anywhere: a
million tiny partitions cost the same as one big one.

Default frames match PostgreSQL: aggregates without ORDER BY see the
whole partition; with ORDER BY they see RANGE UNBOUNDED PRECEDING ..
CURRENT ROW *including peers* (ties share a value), which is also what
last_value returns.

``jax.lax.associative_scan`` (the reference's segment-resetting running
MIN/MAX) has no eager PyTorch counterpart: ``_segmented`` is a log-step
(Hillis-Steele) scan of ``torch.where``/``torch.minimum`` passes over
(segment id, value). ``torch.minimum`` and ``torch.maximum`` propagate
NaN as ``jnp.minimum``/``jnp.maximum`` do.
"""

from __future__ import annotations

import torch

from . import sortkey


def order_and_segments(part_keys: list, order_keys: list, sel,
                       mode: str = "off"):
    """Sort the rows and describe partitions and peer groups.

    part_keys: list of (data, valid); order_keys: list of
    (data, valid, desc). Unselected rows sort to the end and form
    their own "partition" (excluded by callers through in_part).

    mode (sort_normalized): auto/on pack (partition keys, order keys)
    into uint64 lanes and run one stable argsort per lane
    (ops/sortkey.py); off runs successive stable argsorts, least
    significant key first.

    Returns (order, seg_start, peer_start, in_part), all in the sorted
    domain except ``order``, which indexes original rows:
      order[i]      original index of sorted row i
      seg_start[i]  sorted index of row i's partition start
      peer_start[i] sorted index of row i's ORDER BY peer-group start
      in_part[i]    sorted row i belongs to a real (selected) partition
    """
    n = sel.shape[0]
    order = None
    if mode in ("auto", "on"):
        specs = []
        for d, v in part_keys:
            # partitions group NULLs together, after live values
            specs.append((d, v, False, False, None, None))
        for d, v, desc in order_keys:
            # NULLS LAST for asc, FIRST for desc (pg default)
            specs.append((d, v, desc, desc, None, None))
        fields = sortkey.encode_keys(specs)
        if fields is not None:
            lanes = sortkey.mask_dead(
                sortkey.pack_lanes(fields, n, device=sel.device), sel)
            order = sortkey.sort_perm(lanes, kind="window")
        else:
            sortkey.FALLBACKS.bump("window")
    if order is None:
        keys = []  # least significant first (the LAST key is primary)
        for d, v, desc in reversed(order_keys):
            keys.append(_sortable(d, desc))
            keys.append((v if desc else torch.logical_not(v))
                        .to(torch.int32))
        for d, v in reversed(part_keys):
            keys.append(_sortable(d, False))
            keys.append(torch.logical_not(v).to(torch.int32))
        keys.append(torch.logical_not(sel).to(torch.int32))
        order = sortkey.lexsort(keys)

    def sorted_eq(pairs):
        """Row i equals row i-1 on every (data, valid) pair."""
        eq = torch.ones(n, dtype=torch.bool, device=sel.device)
        for d, v in pairs:
            ds, vs = d[order], v[order]
            pd, pv = torch.roll(ds, 1), torch.roll(vs, 1)
            same = (ds == pd) & (vs == pv)
            # two NULLs are the same partition or peer
            both_null = ~vs & ~pv
            eq = eq & (same | both_null)
        return eq

    sel_s = sel[order]
    same_part = sorted_eq(list(part_keys))
    same_part = same_part & (sel_s == torch.roll(sel_s, 1))
    pb = ~same_part
    pb[0] = True  # partition boundary
    same_peer = same_part & sorted_eq([(d, v) for d, v, _ in order_keys])
    ob = ~same_peer
    ob[0] = True  # peer boundary

    idx = torch.arange(n, device=sel.device)
    seg_start = torch.cummax(torch.where(pb, idx, 0), 0).values
    peer_start = torch.cummax(torch.where(ob, idx, 0), 0).values
    return order, seg_start, peer_start, sel_s


def _sortable(d, desc: bool):
    if d.is_floating_point():
        d = d.to(torch.float64)
        return -d if desc else d
    d = d.to(torch.int64)
    # bitwise NOT reverses int order with no wraparound (negation maps
    # INT64_MIN to itself)
    return ~d if desc else d


def _rev_cummin(x):
    return torch.flip(torch.cummin(torch.flip(x, [0]), 0).values, [0])


def _last_of(starts, n):
    """Sorted index of the LAST row of each row's run of equal
    ``starts`` (the peer group's or the partition's end)."""
    idx = torch.arange(n, device=starts.device)
    is_last = torch.ones(n, dtype=torch.bool, device=starts.device)
    is_last[:-1] = starts[1:] != starts[:-1]
    return _rev_cummin(torch.where(is_last, idx, n - 1))


def _peer_end(peer_start, n):
    return _last_of(peer_start, n)


def _seg_end(seg_start, n):
    return _last_of(seg_start, n)


def scatter_back(order, vals, valid, n):
    out_d = torch.zeros(n, dtype=vals.dtype, device=vals.device)
    out_d[order] = vals
    out_v = torch.zeros(n, dtype=torch.bool, device=vals.device)
    out_v[order] = valid
    return out_d, out_v


def row_number(order, seg_start, sel_s):
    n = order.shape[0]
    rn = torch.arange(n, device=order.device) - seg_start + 1
    return scatter_back(order, rn.to(torch.int64), sel_s, n)


def rank(order, seg_start, peer_start, sel_s):
    n = order.shape[0]
    r = peer_start - seg_start + 1
    return scatter_back(order, r.to(torch.int64), sel_s, n)


def dense_rank(order, seg_start, peer_start, sel_s):
    n = order.shape[0]
    ob = peer_start == torch.arange(n, device=order.device)
    c = torch.cumsum(ob.to(torch.int64), 0)
    dr = c - c[seg_start] + 1
    return scatter_back(order, dr, sel_s, n)


def lag_lead(order, seg_start, sel_s, data, valid, offset: int):
    """offset > 0 = lag, < 0 = lead; NULL outside the partition."""
    n = order.shape[0]
    src = torch.arange(n, device=order.device) - offset
    ds, vs = data[order], valid[order]
    seg_end = _seg_end(seg_start, n)
    ok = (src >= seg_start) & (src <= seg_end)
    src = torch.clamp(src, 0, n - 1)
    out = torch.where(ok, ds[src], ds)
    outv = ok & vs[src]
    return scatter_back(order, out, outv & sel_s, n)


def ntile(order, seg_start, sel_s, buckets: int):
    """pg semantics: rows split sequentially into `buckets` groups as
    evenly as possible; the first (size % buckets) groups get one
    extra row; when size < buckets, row r lands in bucket r."""
    n = order.shape[0]
    rn = torch.arange(n, device=order.device) - seg_start
    size = _seg_end(seg_start, n) - seg_start + 1
    q = torch.div(size, buckets, rounding_mode="floor")
    rem = size % buckets             # groups with q+1 rows
    big_span = rem * (q + 1)         # rows covered by the big groups
    in_big = rn < big_span
    b_big = torch.div(rn, q + 1, rounding_mode="floor") + 1
    b_small = rem + torch.div(rn - big_span, torch.clamp(q, min=1),
                              rounding_mode="floor") + 1
    b = torch.where(in_big, b_big, b_small)
    return scatter_back(order, b.to(torch.int64), sel_s, n)


def first_value(order, seg_start, sel_s, data, valid):
    n = order.shape[0]
    ds, vs = data[order], valid[order]
    return scatter_back(order, ds[seg_start], vs[seg_start] & sel_s, n)


def last_value(order, seg_start, peer_start, sel_s, data, valid,
               framed: bool):
    """framed=True (ORDER BY present): the value at the end of the peer
    group (pg's default-frame last_value); else the partition end."""
    n = order.shape[0]
    ds, vs = data[order], valid[order]
    end = _peer_end(peer_start, n) if framed else _seg_end(seg_start, n)
    return scatter_back(order, ds[end], vs[end] & sel_s, n)


def window_agg(func: str, order, seg_start, peer_start, sel_s,
               data, valid, framed: bool):
    """sum/count/min/max/avg over the window.

    framed=False: whole-partition value broadcast to every row.
    framed=True: running value up to the current row's peer-group end.
    """
    n = order.shape[0]
    dev = order.device
    if data is None:  # count(*)
        ds = torch.ones(n, dtype=torch.int64, device=dev)
        m = sel_s
    else:
        ds, vs = data[order], valid[order]
        m = vs & sel_s
    seg_end = _seg_end(seg_start, n)
    end = _peer_end(peer_start, n) if framed else seg_end
    before = torch.clamp(seg_start - 1, min=0)
    has_before = seg_start > 0

    def window_sum(x):
        # inclusive cumulative value at `end`, minus everything before
        # the partition start
        cum = torch.cumsum(x, 0)
        return cum[end] - torch.where(has_before, cum[before],
                                      torch.zeros_like(cum[before]))

    cntw = window_sum(m.to(torch.int64))
    if func in ("sum", "sum_int", "avg", "count", "count_rows"):
        if func in ("count", "count_rows"):
            out, v = cntw, torch.ones(n, dtype=torch.bool, device=dev)
        else:
            acc = torch.float64 if ds.is_floating_point() else torch.int64
            x = torch.where(m, ds.to(acc), torch.zeros((), dtype=acc,
                                                      device=dev))
            total = window_sum(x)
            if func == "avg":
                out = total.to(torch.float64) / torch.clamp(cntw, min=1)
            else:
                out = total
            v = cntw > 0
        return scatter_back(order, out, v & sel_s, n)
    if func in ("min", "max"):
        if ds.is_floating_point():
            ident = float("inf") if func == "min" else float("-inf")
        else:
            info = torch.iinfo(ds.dtype)
            ident = info.max if func == "min" else info.min
        x = torch.where(m, ds, torch.full((), ident, dtype=ds.dtype,
                                          device=dev))
        seg_id = torch.cumsum(
            (seg_start == torch.arange(n, device=dev)).to(torch.int64), 0)
        run = _segmented(x, seg_id, func)
        return scatter_back(order, run[end], (cntw > 0) & sel_s, n)
    raise ValueError(f"window aggregate {func} unsupported")


def _segmented(x, seg_id, func: str):
    """Segment-reset running min/max: an inclusive log-step scan over
    (segment id, value) that forgets the accumulator wherever the
    segment changes. ``seg_id`` is non-decreasing, so equal ids at
    distance s mean one segment covers the whole stretch."""
    pick = torch.minimum if func == "min" else torch.maximum
    n = x.shape[0]
    s = 1
    while s < n:
        same = torch.zeros(n, dtype=torch.bool, device=x.device)
        same[s:] = seg_id[s:] == seg_id[:-s]
        prev = torch.empty_like(x)
        prev[s:] = x[:-s]
        prev[:s] = x[:s]
        x = torch.where(same, pick(prev, x), x)
        s *= 2
    return x
