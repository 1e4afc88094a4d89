"""Order-preserving sort-key normalization: one word, one argsort.

The counterpart of cockroach_tpu/ops/sortkey.py. Every comparator-
shaped operator (ORDER BY, the top-k cut, duplicate-key join chains)
encodes its whole key list into fixed-width unsigned words whose
integer order IS the comparator order, then sorts the words: one
stable single-key argsort per 64-bit lane instead of two per key.

Per key the encoding is a ``[flag:2][value:w]`` bit field:

  value  order-preserving unsigned image of the column: sign-biased
         ints, IEEE-754 monotone-bit floats (negatives complemented,
         positives sign-flipped), dictionary RANK for strings, with w
         taken from the dtype or dictionary size;
  DESC   complements the value bits within the field (no wraparound:
         negation maps INT64_MIN to itself);
  flag   0 = NULL ordered first, 1 = live, 2 = NULL ordered last.
         NULL rows keep their value bits, so ties inside a NULL run
         break as the successive-argsort path breaks them;
  dead   rows outside the selection mask get all-ones on every lane:
         live lane-0 words start with flag <= 2, so dead rows sort
         strictly last, tied with each other in row order.

Fields concatenate major-key-first into 64-bit lanes (left-justified;
a field may straddle a lane boundary), and ``sort_perm`` sorts LSD
over the lanes, least-significant lane first.

torch has no unsigned 64-bit arithmetic worth the name, so a lane is an
int64 tensor holding the uint64 bit pattern: the lanes are bit-equal to
the reference's uint64 lanes viewed as int64. Two rules make that
exact. ``>>`` on int64 is arithmetic, so every right shift is masked to
the bits it keeps; ``<<`` discards the bits it shifts out, as uint64
does. And the order: ``lane ^ INT64_MIN`` flips the sign bit, so signed
int64 order of the flipped word is unsigned order of the lane.

The tallies count sorts per consumer site ("sort" / "topk" / "join"):
NORMALIZED sorts that went through packed lanes, LANES the lanes they
sorted, FALLBACKS sorts that wanted lanes and took the successive-
argsort path (a key dtype with no encoding).
"""

from __future__ import annotations

import numpy as np
import torch

INT64_MIN = -(1 << 63)
_ALL_ONES = -1  # the uint64 all-ones pattern as int64

# float dtype -> the signed int dtype of its width (for .view)
_INT_OF_FLOAT = {torch.float64: torch.int64, torch.float32: torch.int32,
                 torch.float16: torch.int16, torch.bfloat16: torch.int16}
_UNSIGNED = (torch.uint8,)
_SIGNED = (torch.int8, torch.int16, torch.int32, torch.int64)


class _Tally:
    """Per-site counter (the reference's, without its lock: the port
    runs statements on one thread)."""

    def __init__(self):
        self._counts: dict[str, int] = {}

    def bump(self, kind: str, delta: int = 1) -> None:
        self._counts[kind] = self._counts.get(kind, 0) + delta

    def value(self, kind: str | None = None) -> int:
        if kind is None:
            return sum(self._counts.values())
        return self._counts.get(kind, 0)

    def reset(self) -> None:
        self._counts.clear()


NORMALIZED = _Tally()
FALLBACKS = _Tally()
LANES = _Tally()


def _low_mask(w: int) -> int:
    """The low-`w`-bits mask as an int64 value (w = 64: all ones)."""
    return _ALL_ONES if w >= 64 else (1 << w) - 1


def encode_value(d: torch.Tensor, *, lut=None, width: int | None = None):
    """Order-preserving unsigned image of one column.

    Returns ``(bits, w)``: an int64 tensor holding a uint64 pattern
    whose low ``w`` bits order exactly as SQL compares ``d`` ascending
    (high bits zero), or None when the dtype has no encoding.

    lut:   dictionary rank table (code -> sort rank); the field width
           shrinks to the dictionary size.
    width: caller-asserted width for values already in [0, 2**width).
    """
    if lut is not None:
        lut = torch.as_tensor(lut, device=d.device)
        size = int(lut.shape[0])
        rank = lut[torch.clamp(d.to(torch.int64), 0, size - 1)]
        return rank.to(torch.int64), max(1, (size - 1).bit_length())
    if width is not None:
        return d.to(torch.int64), width
    dt = d.dtype
    if dt == torch.bool:
        return d.to(torch.int64), 1
    if dt in _UNSIGNED:
        return d.to(torch.int64), torch.iinfo(dt).bits
    if dt in _SIGNED:
        w = torch.iinfo(dt).bits
        if w == 64:
            return d ^ INT64_MIN, 64
        # sign bias: [-2^(w-1), 2^(w-1)) -> [0, 2^w)
        return d.to(torch.int64) + (1 << (w - 1)), w
    if dt in _INT_OF_FLOAT:
        idt = _INT_OF_FLOAT[dt]
        w = torch.iinfo(idt).bits
        ub = d.view(idt)
        sign = -(1 << (w - 1))   # the sign bit in idt
        # IEEE-754 monotone bits: complement negatives (more negative
        # = bigger magnitude = smaller), set the sign bit of positives
        bits = torch.where((ub & sign) != 0, ~ub, ub | sign)
        if w < 64:
            bits = bits.to(torch.int64) & _low_mask(w)
        return bits, w
    return None


def encode_key(d, valid, desc: bool, null_first: bool, *, lut=None,
               width: int | None = None):
    """One comparator key -> ``[flag:2][value:w]`` field pieces: a list
    of (bits, width <= 64), flag piece first, or None when the dtype
    has no encoding. DESC complements the value bits only; NULLS
    FIRST/LAST stays an independent axis."""
    enc = encode_value(d, lut=lut, width=width)
    if enc is None:
        return None
    bits, w = enc
    if desc:
        bits = bits ^ _low_mask(w)
    one = torch.ones((), dtype=torch.int64, device=bits.device)
    flag = torch.where(valid, one, one * (0 if null_first else 2))
    return [(flag, 2), (bits, w)]


def encode_keys(specs):
    """Flatten key specs ``(d, valid, desc, null_first, lut, width)``
    into packable field pieces, major first; None when ANY key has no
    encoding (normalization is all-or-nothing per sort)."""
    fields = []
    for d, valid, desc, null_first, lut, width in specs:
        f = encode_key(d, valid, desc, null_first, lut=lut, width=width)
        if f is None:
            return None
        fields.extend(f)
    return fields


def pack_lanes(fields, n: int, device=None):
    """Pack (bits, width) pieces, major field first, into 64-bit lanes
    (most-significant lane first), left-justified: lane 0's top bits
    belong to the primary field, the last lane zero-pads at the bottom.
    Fields may straddle lane boundaries."""
    if device is None:
        device = fields[0][0].device if fields else None
    lanes = []
    acc = torch.zeros(n, dtype=torch.int64, device=device)
    used = 0
    for bits, w in fields:
        assert 0 < w <= 64, "encode_key emits pieces of <= 64 bits"
        while w:
            take = min(w, 64 - used)
            # arithmetic shift, then keep the `take` bits wanted
            part = (bits >> (w - take)) if w > take else bits
            part = part & _low_mask(take)
            # shift-by-64 is undefined; a full-lane piece replaces acc
            acc = part if used == 0 else (acc << take) | part
            used += take
            w -= take
            if used == 64:
                lanes.append(acc)
                acc = torch.zeros(n, dtype=torch.int64, device=device)
                used = 0
    if used:
        lanes.append(acc << (64 - used))
    if not lanes:
        lanes.append(torch.zeros(n, dtype=torch.int64, device=device))
    return lanes


def mask_dead(lanes, sel):
    """Demote dead (~sel) rows below every live row: all-ones on every
    lane, tied with each other so the stable sort keeps row order."""
    return [torch.where(sel, lane, _ALL_ONES) for lane in lanes]


def ordered(lane: torch.Tensor) -> torch.Tensor:
    """The int64 word whose signed order is the lane's unsigned order."""
    return lane ^ INT64_MIN


def merge_lanes_host(runs) -> np.ndarray:
    """Host merge of the spill sort's device-sorted runs
    (exec/spill.py), bit-equal to the reference's.

    ``runs`` holds one ``[L, k_i]`` numpy lane stack per run, all
    packed by the same key specs, as uint64 or as this module's int64
    bit patterns. Returns the stable ascending permutation over the
    runs' concatenation: each run is sorted and runs concatenate in row
    order, so a stable lexsort over the unsigned lanes gives the
    permutation one sort_perm over all rows would."""
    lanes = [np.concatenate([r[i] for r in runs]).view(np.uint64)
             for i in range(runs[0].shape[0])]
    # np.lexsort takes its LAST key as primary; lanes are major-first
    return np.lexsort(tuple(reversed(lanes)))


def sort_perm(lanes, *, kind: str | None = None) -> torch.Tensor:
    """Stable ascending permutation over the packed word: one stable
    argsort per lane, least significant first, so the major lane's
    order dominates and prior lanes (finally the row index) break
    ties."""
    if kind is not None:
        NORMALIZED.bump(kind)
        LANES.bump(kind, len(lanes))
    perm = None
    for lane in reversed(lanes):
        key = ordered(lane)
        if perm is None:
            perm = torch.argsort(key, stable=True)
        else:
            perm = perm[torch.argsort(key[perm], stable=True)]
    return perm


def lexsort(keys) -> torch.Tensor:
    """numpy.lexsort's permutation (the LAST key is primary) as
    successive stable argsorts, least significant key first."""
    perm = None
    for k in keys:
        if perm is None:
            perm = torch.argsort(k, stable=True)
        else:
            perm = perm[torch.argsort(k[perm], stable=True)]
    return perm
