"""Write-time per-chunk statistics.

Zone maps used to be computed lazily on first scan; this module moves
summary construction to chunk SEAL time and adds two new per-chunk
summaries, the way Taurus-style NDP pushes statistics maintenance to
the write path so the read path only consults them:

- **zones** — per-column (lo, hi, null_count, valid_count), the same
  tuple `Chunk.zone` always served, but precomputed for every column
  at seal/compaction instead of on demand.
- **blocked bloom filters** — over int-family columns (which includes
  dict-coded string columns: their chunk arrays hold int32 codes).
  One cache line (a uint64 word) per key block; 4 bits per key. Used
  by join-induced skipping to reject chunks whose key range overlaps
  a semi-join filter but whose actual key set does not.
- **distinct-count sketch** — a 256-register HLL-style estimator per
  column, mergeable by register max; sizes the exact-keys vs bloom
  decision when a semi-join filter is derived from a build side.

MVCC window: `ts_min` is exact forever (mvcc_ts is immutable after
seal). `del_max` is the max mvcc_del AT SEAL TIME — tombstones only
ever LOWER mvcc_del (a live row's sentinel becomes a finite deletion
timestamp, never the reverse), so the sealed value stays a valid
upper bound without any post-seal invalidation. A chunk is invisible
at read_ts when ts_min > read_ts (everything born later) or
del_max <= read_ts (everything dead by then).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np

# fnv/murmur-style 64-bit finalizer constants (splitmix64)
_MIX1 = np.uint64(0xFF51AFD7ED558CCD)
_MIX2 = np.uint64(0xC4CEB9FE1A85EC53)
_S33 = np.uint64(33)


def mix64(keys: np.ndarray) -> np.ndarray:
    """Vectorized 64-bit avalanche over int-family keys (splitmix64
    finalizer). Views through int64 first so every int width hashes
    its sign-extended value identically."""
    h = np.ascontiguousarray(keys).astype(np.int64,
                                          copy=False).view(np.uint64)
    h = h ^ (h >> _S33)
    h = h * _MIX1
    h = h ^ (h >> _S33)
    h = h * _MIX2
    return h ^ (h >> _S33)


def _next_pow2(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


class BlockedBloom:
    """Register-blocked bloom filter: each key sets 4 bits inside ONE
    uint64 word, so a membership probe touches a single cache line.
    Sized at ~8 keys/word (~2% false positives); never false-negative.
    Serializes to the raw word array (`tobytes`/`from_bytes`) so a
    semi-join filter can ship as a compact wire frame."""

    __slots__ = ("words",)

    def __init__(self, n_keys: int = 0, words: np.ndarray | None = None):
        if words is not None:
            self.words = words
        else:
            n = _next_pow2(max(8, (int(n_keys) + 7) // 8))
            self.words = np.zeros(n, dtype=np.uint64)

    def add(self, keys: np.ndarray) -> None:
        if len(keys):
            self.add_hashed(mix64(keys))

    def add_hashed(self, h: np.ndarray) -> None:
        """Insert pre-hashed keys (seal-time stats hash each column
        once and feed the same digest to bloom and sketch)."""
        if len(h) == 0:
            return
        block = (h & np.uint64(len(self.words) - 1)).astype(np.int64)
        np.bitwise_or.at(self.words, block, self._masks(h))

    def might_contain(self, keys: np.ndarray) -> np.ndarray:
        """Boolean array: False is definite absence."""
        if len(keys) == 0:
            return np.zeros(0, dtype=bool)
        h = mix64(keys)
        block = (h & np.uint64(len(self.words) - 1)).astype(np.int64)
        m = self._masks(h)
        return (self.words[block] & m) == m

    def might_contain_any(self, keys: np.ndarray) -> bool:
        return bool(self.might_contain(keys).any())

    def tobytes(self) -> bytes:
        return self.words.tobytes()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "BlockedBloom":
        return cls(words=np.frombuffer(raw, dtype=np.uint64).copy())

    @staticmethod
    def _masks(h: np.ndarray) -> np.ndarray:
        one = np.uint64(1)
        m = one << ((h >> np.uint64(32)) & np.uint64(63))
        m |= one << ((h >> np.uint64(38)) & np.uint64(63))
        m |= one << ((h >> np.uint64(44)) & np.uint64(63))
        m |= one << ((h >> np.uint64(50)) & np.uint64(63))
        return m

class DistinctSketch:
    """256-register HLL-style distinct estimator. Registers hold the
    max leading-zero rank of the low 56 hash bits per bucket; two
    sketches over disjoint row sets merge by elementwise max (the
    compaction story: rebuilt chunks re-sketch, table-level estimates
    merge)."""

    __slots__ = ("regs",)
    _M = 256

    def __init__(self, regs: np.ndarray | None = None):
        self.regs = (regs if regs is not None
                     else np.zeros(self._M, dtype=np.uint8))

    def add(self, keys: np.ndarray) -> None:
        if len(keys):
            self.add_hashed(mix64(keys))

    def add_hashed(self, h: np.ndarray) -> None:
        if len(h) == 0:
            return
        idx = (h >> np.uint64(56)).astype(np.int64)
        low = (h & np.uint64((1 << 56) - 1)).astype(np.int64)
        # rank = leading zeros of the 56-bit suffix, + 1
        nbits = np.zeros(len(low), dtype=np.int64)
        nz = low > 0
        nbits[nz] = np.floor(np.log2(low[nz].astype(np.float64))) + 1
        rho = (56 - nbits + 1).astype(np.uint8)
        np.maximum.at(self.regs, idx, rho)

    def merge(self, other: "DistinctSketch") -> None:
        np.maximum(self.regs, other.regs, out=self.regs)

    def estimate(self) -> int:
        m = float(self._M)
        regs = self.regs.astype(np.float64)
        est = (0.7213 / (1 + 1.079 / m)) * m * m \
            / np.sum(np.exp2(-regs))
        zeros = int(np.count_nonzero(self.regs == 0))
        if est <= 2.5 * m and zeros:
            est = m * np.log(m / zeros)       # linear counting
        return int(round(est))


@dataclass
class ChunkStats:
    """Everything a chunk precomputes at seal: zone tuples for every
    data column, blooms + distinct sketches for int-family columns,
    and the MVCC visibility window."""

    zones: dict = field(default_factory=dict)
    blooms: dict = field(default_factory=dict)
    distinct: dict = field(default_factory=dict)
    ts_min: int = 0
    del_max: int = 0


def column_zone(vals: np.ndarray, valid: np.ndarray):
    """(lo, hi, null_count, valid_count) for one column; None bounds
    when the dtype is unordered (object) or no valid row exists —
    byte-identical to the historical lazy `Chunk.zone` result."""
    nvalid = int(valid.sum())
    nulls = len(valid) - nvalid
    if vals.dtype.kind not in "biuf" or nvalid == 0:
        return (None, None, nulls, nvalid)
    vv = vals if nvalid == len(vals) else vals[valid]
    lo, hi = vv.min(), vv.max()
    if vals.dtype.kind == "f":
        if np.isnan(lo) or np.isnan(hi):
            return (None, None, nulls, nvalid)
        return (float(lo), float(hi), nulls, nvalid)
    return (int(lo), int(hi), nulls, nvalid)


def _column_stats(vals: np.ndarray, v: np.ndarray):
    """(zone, bloom or None, sketch or None) of one column."""
    z = column_zone(vals, v)
    if not (vals.dtype.kind in "iu" and vals.dtype.itemsize >= 2):
        return z, None, None
    # z[3] is the valid count: reuse it to skip the boolean gather on
    # fully-valid columns, and hash once for both summaries
    keys = vals if z[3] == len(vals) else vals[v]
    h = mix64(keys) if len(keys) else keys
    bl = BlockedBloom(len(keys))
    bl.add_hashed(h)
    sk = DistinctSketch()
    sk.add_hashed(h)
    return z, bl, sk


# chunks of at least this many rows summarize their columns on a pool
# of threads (the hashing and scatters release the GIL for long spans)
_PARALLEL_ROWS = 1 << 20


def compute(data: dict, valid: dict, mvcc_ts: np.ndarray,
            mvcc_del: np.ndarray) -> ChunkStats:
    """Build the full seal-time summary for one chunk. Blooms and
    sketches cover int-family columns only (ints + dict codes); float
    and object columns still get zones."""
    st = ChunkStats()
    n = len(mvcc_ts)
    cols = list(data)
    if n >= _PARALLEL_ROWS and len(cols) > 1:
        with ThreadPoolExecutor(min(len(cols), os.cpu_count() or 1)) as ex:
            stats = list(ex.map(lambda c: _column_stats(data[c], valid[c]),
                                cols))
    else:
        stats = [_column_stats(data[c], valid[c]) for c in cols]
    for col, (z, bl, sk) in zip(cols, stats):
        st.zones[col] = z
        if bl is not None:
            st.blooms[col] = bl
            st.distinct[col] = sk
    st.ts_min = int(mvcc_ts.min()) if n else 0
    st.del_max = int(mvcc_del.max()) if n else 0
    return st


def extend(st: ChunkStats, col: str, vals: np.ndarray,
           valid: np.ndarray) -> None:
    """Add one column's summaries to a sealed chunk's stats (the backfill
    of a column that ALTER TABLE added)."""
    z, bl, sk = _column_stats(vals, valid)
    st.zones[col] = z
    if bl is not None:
        st.blooms[col] = bl
        st.distinct[col] = sk
