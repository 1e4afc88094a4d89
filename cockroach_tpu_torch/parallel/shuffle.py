"""Hash-partitioned all-to-all exchange: the shuffle (the counterpart of
cockroach_tpu/parallel/shuffle.py).

The reference moves rows between flow processors with the HashRouter:
each producer hash-partitions its output and ships bucket i to consumer
i. Here, as in the reference's accelerator form, it is one all-to-all
over the shard axis:

  1. every shard gives each local row a destination
     ``hash(key) % n_shards`` (``dest_of``);
  2. rows sort by destination and scatter into a [n_shards * cap] send
     buffer (``pack_for_exchange``: cap is the per-destination budget,
     with an overflow flag when skew exceeds it);
  3. the all-to-all swaps buffer block d with shard d: afterwards every
     row with one key hash lives on one shard (``exchange``).

Overflow does not corrupt results: surplus rows are dropped from the
send buffer and the returned flag, the same on every shard, is True; the
engine maps it to HashCapacityExceeded and re-runs the plan partition
by partition.
"""

from __future__ import annotations

import threading

import torch

from ..ops.hashtable import _hash_columns
from .collective import AXIS


class _ByteTally:
    """Thread-safe byte counter of the exchanges plans were built with:
    a distributed hash GROUP BY adds its send buffers' bytes (one
    shard's, n_shards * cap rows a payload column) on its plan's first
    run, as the reference adds them when it traces the program. Read as
    ``exec.movement.exchange.traced.bytes``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._bytes = 0

    def bump(self, nbytes: int) -> None:
        with self._lock:
            self._bytes += int(nbytes)

    def value(self) -> int:
        with self._lock:
            return self._bytes


EXCHANGE_TRACED = _ByteTally()

# -- per-link fault injection ------------------------------------------------
# The all-to-all is one collective, but it stands for D*(D-1) directed
# links; a chaos drill wants rules per link ("shard 0 -> shard 2
# drops"). They are evaluated at dispatch (distagg.queued_collective_
# call) and aggregated: a dropped link loses that block of the
# exchange, which makes the whole result wrong, so any dropped link
# faults the dispatch (CollectiveFault -> the session's distsql = off
# re-run); dup and delay become a duplicate dispatch / the worst
# link's delay.

_LINK_FAULTS = None  # (injector with plan(frm, to), n_shards) or None


def install_link_faults(injector, n_shards: int) -> None:
    """Register per-link fault rules for the exchange, keyed
    ``("shard:<s>", "shard:<d>")`` in the injector; None heals."""
    global _LINK_FAULTS
    _LINK_FAULTS = ((injector, int(n_shards))
                    if injector is not None else None)


def link_fault_plan():
    """Every directed shard pair's rule folded into one dispatch plan
    ([] drop, [0.0] deliver, [0.0, 0.0] dup, [s] delay); None when no
    injector is installed."""
    lf = _LINK_FAULTS
    if lf is None:
        return None
    inj, n = lf
    delay = 0.0
    dup = False
    for s in range(n):
        for d in range(n):
            if s == d:
                continue  # the self block never leaves the slot
            plan = inj.plan(f"shard:{s}", f"shard:{d}")
            if not plan:
                return []  # one lost link corrupts the exchange
            delay = max(delay, plan[0])
            dup = dup or len(plan) > 1
    return [delay, 0.0] if dup else [delay]


# the salt decorrelating the destination hash from the hash table's slot
# hash (0x9E3779B9 as an int32 bit pattern)
_DEST_SALT = 0x9E3779B9 - (1 << 32)


def dest_of(key_cols: tuple, n_shards: int) -> torch.Tensor:
    """Destination shard per row: hash(keys) % n_shards, the
    reference's hash bit for bit."""
    salt = torch.full(key_cols[0].shape, _DEST_SALT, dtype=torch.int32,
                      device=key_cols[0].device)
    h = _hash_columns(tuple(key_cols) + (salt,), 1 << 16)
    return (h % n_shards).to(torch.int32)


def pack_for_exchange(dest: torch.Tensor, valid: torch.Tensor,
                      n_shards: int, cap: int, arrays: list):
    """Scatter rows into a [n_shards * cap] send buffer, block d holding
    (up to cap) rows bound for shard d, in their local order.

    Returns (packed_arrays, packed_valid, overflow)."""
    n = dest.shape[0]
    dev = dest.device
    # invalid rows sort to the end (dest = n_shards sentinel)
    d = torch.where(valid, dest.to(torch.int64), n_shards)
    order = torch.argsort(d, stable=True)
    dsort = d[order]
    starts = torch.searchsorted(
        dsort, torch.arange(n_shards, dtype=torch.int64, device=dev))
    rank = torch.arange(n, dtype=torch.int64, device=dev) - \
        starts[torch.clamp(dsort, 0, n_shards - 1)]
    live = dsort < n_shards
    fits = live & (rank < cap)
    overflow = torch.any(live & (rank >= cap))
    # rows past their block's cap land in one trash slot, cut below
    slot = torch.where(fits, dsort * cap + rank, n_shards * cap)
    out_valid = torch.zeros(n_shards * cap + 1, dtype=torch.bool,
                            device=dev)
    out_valid[slot] = fits
    packed = []
    for a in arrays:
        buf = torch.zeros((n_shards * cap + 1,) + tuple(a.shape[1:]),
                          dtype=a.dtype, device=dev)
        buf[slot] = a[order]
        packed.append(buf[:n_shards * cap])
    return packed, out_valid[:n_shards * cap], overflow


def exchange(dest: torch.Tensor, valid: torch.Tensor, n_shards: int,
             cap: int, arrays: list, axis=AXIS, tally: bool = False):
    """The shuffle: pack, then all-to-all. Each shard returns the rows
    (from every shard) whose dest is its own index, in (source shard,
    local order); n_shards * cap rows. The overflow flag is every
    shard's, or-ed. ``tally`` adds the send buffers' bytes to
    EXCHANGE_TRACED."""
    packed, pvalid, overflow = pack_for_exchange(
        dest, valid, n_shards, cap, arrays)
    if tally:
        EXCHANGE_TRACED.bump(sum(p.numel() * p.element_size()
                                 for p in packed))
    recv = [axis.all_to_all(p) for p in packed]
    rvalid = axis.all_to_all(pvalid)
    any_ovf = axis.psum(overflow.to(torch.int32).reshape(1))[0] > 0
    return recv, rvalid, any_ovf
