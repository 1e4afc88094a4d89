"""Aggregation: masked reductions and grouped aggregates over dense ids.

The counterpart of cockroach_tpu/ops/agg.py. Rows map to a dense group
id in [0, num_groups) and each aggregate is a scatter-reduction over
those ids (``index_add_`` / ``scatter_reduce_``), which the card runs
as native atomics; the JAX package's unrolled small-G reductions are a
TPU habit (scatters are slow there) and are not carried over.

Rows whose id falls outside [0, num_groups) or whose mask is False
contribute nothing: torch raises on out-of-range scatter indices
where JAX drops them, so every scatter here routes such rows to a
spill slot ``num_groups`` that is cut off afterwards.
"""

from __future__ import annotations

import numpy as np
import torch


def _minident(dtype):
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _maxident(dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def _slot(group_ids, mask, num_groups: int) -> torch.Tensor:
    """int64 scatter index: the group id for masked, in-range rows,
    else the spill slot num_groups."""
    ok = mask & (group_ids >= 0) & (group_ids < num_groups)
    return torch.where(ok, group_ids.to(torch.int64), num_groups)


# ---------------------------------------------------------------------------
# ungrouped (scalar) aggregates
# ---------------------------------------------------------------------------

def masked_sum(data, mask, acc_dtype=None):
    d = data.to(acc_dtype) if acc_dtype is not None else data
    return torch.sum(torch.where(mask, d, torch.zeros_like(d)))


def masked_count(mask):
    return torch.sum(mask.to(torch.int64))


def _bool_fold(fold):
    """MIN/MAX over BOOL: fold the values as uint8 (False < True), then
    back to BOOL."""
    def folded(data, *args):
        if data.dtype == torch.bool:
            return fold(data.to(torch.uint8), *args).to(torch.bool)
        return fold(data, *args)
    return folded


@_bool_fold
def masked_min(data, mask):
    return torch.amin(torch.where(mask, data, _minident(data.dtype)))


@_bool_fold
def masked_max(data, mask):
    return torch.amax(torch.where(mask, data, _maxident(data.dtype)))


# ---------------------------------------------------------------------------
# grouped aggregates over dense group ids
# ---------------------------------------------------------------------------

def _scatter_add(values, slot, num_groups: int) -> torch.Tensor:
    out = torch.zeros(num_groups + 1, dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, slot, values)
    return out[:num_groups]


def _scatter_reduce(values, slot, num_groups: int, reduce: str,
                    ident) -> torch.Tensor:
    out = torch.full((num_groups + 1,), ident, dtype=values.dtype,
                     device=values.device)
    out.scatter_reduce_(0, slot, values, reduce=reduce, include_self=True)
    return out[:num_groups]


def group_rep_index(group_ids, mask, num_groups: int):
    """(representative masked row index per group, nonempty mask): the
    smallest masked row id per group, in one int32 scatter-min."""
    n = group_ids.shape[0]
    rowid = torch.arange(n, dtype=torch.int32, device=group_ids.device)
    rep = _scatter_reduce(rowid, _slot(group_ids, mask, num_groups),
                          num_groups, "amin", n)
    return torch.clamp(rep, max=n - 1), rep < n


def group_any_via_rep(data, valid, rep, nonempty):
    """Per-group `any` value via the shared representative index (the
    value is constant within each group). Empty / all-NULL groups take
    the max identity."""
    idx = rep.to(torch.int64)
    v = torch.logical_and(nonempty, valid.index_select(0, idx))
    d = torch.where(v, data.index_select(0, idx), _maxident(data.dtype))
    return d, v


def group_sum(data, group_ids, mask, num_groups: int, acc_dtype=None,
              max_group_rows: int = 0, arg_max_abs: int = 0,
              arg_nonneg: bool = False):
    d = data.to(acc_dtype) if acc_dtype is not None else data
    slot = _slot(group_ids, mask, num_groups)
    if d.dtype == torch.int64:
        return _group_sum_i64_limbs(d, slot, num_groups, max_group_rows,
                                    arg_max_abs if arg_nonneg else 0)
    return _scatter_add(d, slot, num_groups)


def shift_right_logical(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 (jax.lax.shift_right_logical): torch's
    ``>>`` is arithmetic, so the sign-extended top ``s`` bits are masked
    off."""
    if s == 0:
        return x
    return (x >> s) & ((1 << (64 - s)) - 1)


def limb(x: torch.Tensor, j: int, w: int) -> torch.Tensor:
    """The j-th w-bit limb of int64 two's-complement bit patterns, as
    the reference cuts it: logical shift by j*w, then keep w bits."""
    return shift_right_logical(x, j * w) & ((1 << w) - 1)


def _group_sum_i64_limbs(d, slot, num_groups: int,
                         max_group_rows: int, max_abs: int = 0):
    """Exact int64 group sum via w-bit limbs accumulated in int32 and
    recombined with wrapping int64 shifts/adds, bit-for-bit the JAX
    package's int64 modular arithmetic (negatives included). Each
    group's limb sum is bounded by max_group_rows * (2^w - 1) < 2^31."""
    maxg = max(int(max_group_rows), 1) if max_group_rows > 0 \
        else max(int(d.shape[0]), 1)
    w = int(np.floor(np.log2((2.0 ** 31 - 1) / maxg + 1)))
    w = max(1, min(22, w))
    bits = 64
    if max_abs > 0:
        bits = min(64, max(1, int(max_abs).bit_length()))
    k = -(-bits // w)
    total = torch.zeros(num_groups, dtype=torch.int64, device=d.device)
    for j in range(k):
        s = _scatter_add(limb(d, j, w).to(torch.int32), slot, num_groups)
        total = total + (s.to(torch.int64) << (j * w))
    return total


def group_count(group_ids, mask, num_groups: int):
    return _scatter_add(mask.to(torch.int32),
                        _slot(group_ids, mask, num_groups),
                        num_groups).to(torch.int64)


@_bool_fold
def group_min(data, group_ids, mask, num_groups: int):
    return _scatter_reduce(data, _slot(group_ids, mask, num_groups),
                           num_groups, "amin", _minident(data.dtype))


@_bool_fold
def group_max(data, group_ids, mask, num_groups: int):
    return _scatter_reduce(data, _slot(group_ids, mask, num_groups),
                           num_groups, "amax", _maxident(data.dtype))


def group_any(data, group_ids, mask, num_groups: int):
    """Per-group representative of a value that is constant within
    each group (the planner's functionally dependent group keys ride
    as ``any``): a scatter-max, whose empty groups hold the very
    negative identity (iinfo.min, -inf), so page partials combine by
    max and pick the one real value."""
    return group_max(data, group_ids, mask, num_groups)


def distinct_first_mask(data, mask, group_ids, num_groups: int,
                        sort_normalized: str = "off"):
    """True at the FIRST masked occurrence of each (group, value) pair.

    DISTINCT aggregates become ordinary aggregates with this extra mask:
    sort the rows by (group, value), flag where either changes, scatter
    the flags back, one sort and no per-group work. Under
    ``sort_normalized`` auto/on the pair packs into sort-key lanes (the
    group field sized to bit_length(num_groups), masked-out rows riding
    as code num_groups) and each lane sorts once (ops/sortkey.py);
    under off, or for a dtype with no encoding, successive stable
    argsorts take the reference's lexsort order."""
    from . import sortkey
    n = data.shape[0]
    g = torch.where(mask, group_ids.to(torch.int64), num_groups)
    if data.dtype == torch.bool:
        data = data.to(torch.int32)
    order = None
    if sort_normalized in ("auto", "on"):
        enc = sortkey.encode_value(data)
        if enc is not None:
            gw = max(1, int(num_groups).bit_length())
            order = sortkey.sort_perm(
                sortkey.pack_lanes([(g, gw), enc], n, data.device),
                kind="distinct")
        else:
            sortkey.FALLBACKS.bump("distinct")
    if order is None:
        order = sortkey.lexsort((data, g))
    gs, ds = g[order], data[order]
    first = torch.ones(n, dtype=torch.bool, device=data.device)
    first[1:] = torch.logical_or(gs[1:] != gs[:-1], ds[1:] != ds[:-1])
    first = torch.logical_and(first, gs < num_groups)
    out = torch.zeros(n, dtype=torch.bool, device=data.device)
    out[order] = first
    return out
