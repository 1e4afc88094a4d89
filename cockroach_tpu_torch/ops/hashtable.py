"""Device hash table: vectorized open-addressing build, probe, group ids.

The counterpart of cockroach_tpu/ops/hashtable.py (``_hash_columns``,
``_keys_equal``, ``build``, ``group_ids``, ``probe``). Open addressing
with linear probing keeps all state in flat tensors:

  - ``claim``: int32[capacity+1]; claim[s] = row id that owns slot s,
    or N (empty). Slot `capacity` is a trash slot for masked scatters.
  - build: every live row proposes itself for its hash slot; a
    scatter-min arbitrates; losers with a different key probe to the
    next slot; rows that find their own key stop (duplicate).
  - keys are tuples of int columns compared through gathers at the
    owning row (the table stores row ids, never keys).

Each of the reference's ``lax.while_loop``s is a Python loop here that
ends when every row is done: one host sync per round (``done.all()``).
The build, the probe and ``group_ids`` return their round counts (the
host syncs paid) to their caller: concurrent sessions and the shard
threads of a mesh build tables at once, so no count is kept in the
module.

The hash is bit-identical to the reference's uint32 arithmetic. torch
has no ``>>`` for uint32 on the CPU, so it runs in int64 on values kept
below 2^32, and each 32x32-bit product is split into two products below
2^49 so nothing overflows int64.

Every gather index is in range by construction (slots are masked to
[0, capacity), owners clamped to [0, N-1]): torch raises on an
out-of-range index where JAX clamps it.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_MUL_LO = 2654435761
_MUL_HI = 2246822519

# the share of its slots past which a build with rows left overflows
MAX_LOAD = 0.5


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a 32-bit constant,
    without overflowing int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_columns(key_cols: tuple, capacity: int) -> torch.Tensor:
    """Fibonacci-style multiplicative hash of one or more int columns,
    mixed like colexechash's per-column rehashing (hash.go)."""
    h = torch.zeros(key_cols[0].shape, dtype=torch.int64,
                    device=key_cols[0].device)
    for c in key_cols:
        c64 = c.to(torch.int64)
        lo = c64 & _M32
        hi = (c64 >> 32) & _M32
        h = _mul32(h ^ lo, _MUL_LO)
        h = _mul32(h ^ hi, _MUL_HI)
        h = h ^ (h >> 15)   # h < 2^32: the arithmetic shift is logical
    return (h & (capacity - 1)).to(torch.int32)


def _keys_equal(key_cols: tuple, rows_a: torch.Tensor,
                rows_b: torch.Tensor) -> torch.Tensor:
    eq = torch.ones(rows_a.shape, dtype=torch.bool, device=rows_a.device)
    for c in key_cols:
        eq = torch.logical_and(eq, c[rows_a] == c[rows_b])
    return eq


def build(key_cols: tuple, mask: torch.Tensor, capacity: int):
    """Insert all live rows; returns (claim, slot_of_row, converged,
    rounds).

    slot_of_row[i] = the slot whose owner has row i's key (the owner may
    be an earlier duplicate). capacity must be a power of two, >= 2N to
    keep probe chains short. Where the build converges, its slots and
    claims match the reference's bit for bit.

    The build ends unconverged as soon as it holds more than MAX_LOAD x
    capacity keys with rows left over, where the reference probes on to
    its round bound (capacity + 2 rounds, a host sync each): linear
    probing's chains, one round a slot, grow without bound as a table
    fills. A GROUP BY over more than half its slots thus reads as an
    overflow, and the engine's partitioned re-run gives the same rows; a
    join's table (>= 2N slots) never passes half."""
    n = key_cols[0].shape[0]
    if capacity & (capacity - 1):
        raise ValueError("capacity must be a power of two")
    dev = mask.device
    rowid = torch.arange(n, dtype=torch.int32, device=dev)
    slot = _hash_columns(key_cols, capacity)
    claim = torch.full((capacity + 1,), n, dtype=torch.int32, device=dev)
    if n == 0:
        return claim, slot, True, 0
    done = torch.logical_not(mask)
    rounds = 0
    while rounds < capacity + 2:
        # one host sync a round, for both flags
        all_done, occupied = torch.stack(
            [done.all().to(torch.int64),
             (claim[:capacity] < n).sum()]).tolist()
        if all_done:
            break
        if occupied > MAX_LOAD * capacity:
            return claim, slot, False, rounds
        active = torch.logical_not(done)
        empty = claim[slot] == n
        attempt = torch.logical_and(active, empty)
        tgt = torch.where(attempt, slot, capacity).to(torch.int64)
        claim.scatter_reduce_(0, tgt, rowid, reduce="amin",
                              include_self=True)
        owner = claim[slot]
        occupied = owner < n
        key_eq = _keys_equal(key_cols, torch.clamp(owner, max=n - 1),
                             rowid)
        found = active & occupied & key_eq
        done = torch.logical_or(done, found)
        # probe on: occupied by a different key
        advance = active & occupied & torch.logical_not(key_eq)
        slot = torch.where(advance, (slot + 1) & (capacity - 1), slot)
        rounds += 1
    return claim, slot, bool(done.all()), rounds


def group_ids(key_cols: tuple, mask: torch.Tensor, capacity: int):
    """Dense group ids for GROUP BY: (gid[int32 per row], num_groups
    [0-d int32 tensor], rep_row[int32, capacity], build rounds).

    gid is dense in [0, num_groups) in hash-slot order; dead rows get
    0. rep_row[g] is a representative row of group g (to gather the
    group-key output columns), valid for g < num_groups. num_groups is
    -1 when the table overflowed (its build passed half of capacity with
    rows left to place): callers must check. num_groups stays on the device; the build's
    rounds are the only host syncs."""
    n = key_cols[0].shape[0]
    claim, slot, converged, rounds = build(key_cols, mask, capacity)
    occupied = claim[:capacity] < n
    dense = torch.cumsum(occupied.to(torch.int32), 0, dtype=torch.int32) - 1
    gid = torch.where(mask, dense[slot.to(torch.int64)], 0) \
        .to(torch.int32)
    count = occupied.to(torch.int32).sum(dtype=torch.int32)
    num_groups = count if converged else torch.full_like(count, -1)
    # rep_row: scatter each owner row into its dense id (the trash
    # slot `capacity` takes the empty slots)
    tgt = torch.where(occupied, dense, capacity).to(torch.int64)
    rep = torch.zeros(capacity + 1, dtype=torch.int32, device=mask.device)
    rep[tgt] = torch.clamp(claim[:capacity], max=max(n - 1, 0))
    return gid, num_groups, rep[:capacity], rounds


def probe(table_claim: torch.Tensor, build_keys: tuple, probe_keys: tuple,
          probe_mask: torch.Tensor, capacity: int, n_build: int):
    """For each probe row, find the build slot owning its key.

    Returns (matched[bool], build_row[int32], rounds): build_row is the
    row id of the *first* build row with that key (exact for unique
    build keys, i.e. PK-FK joins). ``n_build`` is the build side's row
    count (the empty sentinel)."""
    n = probe_keys[0].shape[0]
    dev = probe_mask.device
    matched = torch.zeros(n, dtype=torch.bool, device=dev)
    build_row = torch.zeros(n, dtype=torch.int32, device=dev)
    if n == 0:
        return matched, build_row, 0
    slot = _hash_columns(probe_keys, capacity)
    done = torch.logical_not(probe_mask)
    rounds = 0
    # every chain ends at an empty slot (capacity > n_build); the bound
    # only guards a table with none
    while rounds <= capacity and not bool(done.all()):
        active = torch.logical_not(done)
        owner = table_claim[slot]
        occupied = owner < n_build
        safe_owner = torch.clamp(owner, max=max(n_build - 1, 0))
        key_eq = torch.ones(n, dtype=torch.bool, device=dev)
        for bc, pc in zip(build_keys, probe_keys):
            key_eq = torch.logical_and(key_eq, bc[safe_owner] == pc)
        hit = active & occupied & key_eq
        miss_empty = active & torch.logical_not(occupied)
        matched = torch.logical_or(matched, hit)
        build_row = torch.where(hit, safe_owner, build_row)
        done = done | hit | miss_empty
        advance = active & occupied & torch.logical_not(key_eq)
        slot = torch.where(advance, (slot + 1) & (capacity - 1), slot)
        rounds += 1
    return matched, build_row, rounds


# level-1 fan-out ceiling of the two-level partition encoding below
# (Engine.MAX_SPILL_PARTITIONS)
PARTITION_L1 = 256


def partition_mask(key_cols: tuple, nparts: int, pid: int) -> torch.Tensor:
    """Row mask for the partitioned re-run of an overflowed hash GROUP
    BY: True where salted_hash(keys) & (nparts - 1) == pid. The salt
    column decorrelates the partition hash from the group table's hash,
    so one partition's groups spread over all table slots. nparts must
    be a power of two; nparts == 1 keeps every row.

    Past the level-1 ceiling (PARTITION_L1), ``nparts = l1 * l2``
    encodes a second level under a rotated salt, and
    ``pid = pid2 * l1 + pid1`` selects level-1 bucket pid1 and level-2
    bucket pid2: keys that collide under the first salt spread again
    under the second. Bit-identical to the reference's masks."""
    l1 = min(nparts, PARTITION_L1)
    l2 = nparts // l1
    pid1 = pid & (l1 - 1)
    pid2 = pid // l1
    shape, dev = key_cols[0].shape, key_cols[0].device
    salt = torch.full(shape, 0x85EBCA6B - (1 << 32), dtype=torch.int32,
                      device=dev)
    h = _hash_columns(tuple(key_cols) + (salt,), 1 << 16)
    m = (h & (l1 - 1)) == pid1
    if l2 == 1:
        return m
    # the rotated-salt level: murmur3's other mixing constant
    salt2 = torch.full(shape, 0x5C2B2AE3, dtype=torch.int32, device=dev)
    h2 = _hash_columns(tuple(key_cols) + (salt2,), 1 << 16)
    return m & ((h2 & (l2 - 1)) == pid2)
