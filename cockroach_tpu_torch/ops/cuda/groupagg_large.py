"""One-pass large-G dense grouped aggregation: CUDA kernel + plain version.

Replaces cockroach_tpu/ops/pallas/groupagg_large.py:large_group_aggregate.
The TPU kernel folds each (group tile, row block) step into a VMEM
accumulator with a one_hot(gid)^T @ mat product on the MXU, O(n * G)
work, and takes exact int64 sums as w-bit limb columns in f32 that the
caller builds beforehand (Mosaic has no 64-bit lanes). The Hopper kernel
(csrc/groupagg_large.cu) adds each row into its own group, O(n) work, and
cuts the limbs itself from the table's int64 values in registers.

Slots (``aggregate_slots``) name the table's own tensors:
  ``i64sum(value, mask, w, k)``: k int32 limb rows of where(sel & mask,
      value, 0) (the logical shift-and-mask of ops/agg.py ``limb``), its
      f32 shadow row, and the largest |value| over the rows that pass sel
      and the mask, as a uint64 bit pattern in an int64 word;
  ``count(mask)``: one int32 row (mask None: sel itself);
  ``f32sum(value, mask)``: one f32 row (FLOAT sums);
  ``minmax(value, mask, op)``: one f32 row; an integer column reduces
      its arithmetic high limb value >> MM_HI_SHIFT, a float column its
      value.
The wrapper folds slots that read the same tensors (by storage): sum(x)
and avg(x) share one set of limb rows and one shadow, count slots with
one mask share one row. Each distinct column is read once, so the
kernel is bounded by n * (4 + 1 + the distinct value columns' widths +
1 per distinct mask) bytes plus its outputs (TPC-H Q1: 50 B a row).

Accumulators (``choose_layout``): one [NF + NI, G] copy per block in
shared memory where it fits, else global atomics; inside the kernel a
warp whose rows hold few groups adds with one reduction per group (see
the source's header).

``large_group_aggregate`` is the TPU kernel's own interface over
pre-built f32 columns (f32 sum columns, integer-valued columns summed in
int32, pre-masked MIN/MAX columns, REPMIN), one code path of the same
kernel: (f32[NF, G], i32[NI, G]) with NF = max(1, n_f + len(mm_ops))
and NI = max(1, n_i + want_rep).

Both entry points launch the kernel for CUDA tensors and raise if they
cannot; they take the plain PyTorch version only for tensors on the
CPU. LAUNCHES counts kernel launches, PLAIN_CALLS calls of the plain
version through the wrappers.
"""

from __future__ import annotations

import ctypes
import math
import struct
import threading
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from .. import agg as aggops
from . import build
from .paritygate import MM_HI_SHIFT

MIN, MAX = "min", "max"

# Tile constants of the TPU kernel, kept so limb_width (which the
# exactness of its f32 block partials bounded) gives the same limb
# layout as the reference's.
LANES = 128
GROUP_TILE = 512
BLOCK_ROWS = 1024

# the kernel's launch points (block, rows, min_blocks), in the order of
# csrc/groupagg_large.cu's POINTS table (checked when the library loads):
# threads a block, rows a thread per tile, blocks an SM the registers
# are capped for. The first is the shipped point; ops/cuda/autotune.py
# times them.
KERNEL_POINTS = ((256, 4, 4), (128, 4, 8), (512, 4, 2), (256, 2, 4),
                 (256, 8, 2))
DEFAULT_POINT = KERNEL_POINTS[0]

# csrc/groupagg_large.cu: dynamic shared memory a block may take, the
# caps of its by-value argument struct, its accumulator layouts
SMEM_LIMIT = 232_448 - 1024
MAX_COLS, MAX_MASKS, MAX_SLOTS = 64, 30, 64
LAYOUTS = ("shared", "global")

# the kernel's slot kinds, column types and mask codes
_COUNT, _ISUM, _I64SUM, _FSUM, _MIN, _MAX = range(6)
_DTYPES = {torch.int64: 0, torch.int32: 1, torch.float32: 2,
           torch.float64: 3}
_NONE, _SEL = -2, -1

LAUNCHES = 0
PLAIN_CALLS = 0
# the counts are bumped from a distributed plan's shard threads too
_COUNT_LOCK = threading.Lock()


def row_block(n: int, block_rows: int = BLOCK_ROWS) -> int:
    """Largest power-of-two row block that divides n (n % 128 == 0, so
    this is >= 128), capped by the block budget."""
    if n % LANES:
        raise ValueError("row count must be a multiple of 128")
    return min(block_rows, n & -n)


def limb_width(n: int, max_group_rows: int,
               block_rows: int = BLOCK_ROWS, cap: int = 22) -> int:
    """The widest limb w with both the reference kernel's f32 block
    partial (blk*(2^w-1) < 2^24) and the per-group i32 running sum
    (maxg*(2^w-1) < 2^31) exact. The int32 atomics here only need the
    second bound; the first is kept so the layouts match."""
    blk = row_block(n, block_rows)
    maxg = max_group_rows if max_group_rows and 0 < max_group_rows <= n \
        else n
    maxg = max(1, maxg)
    w = int(math.floor(math.log2((2 ** 31 - 1) / maxg + 1)))
    w = min(w, 24 - int(math.log2(blk)), 22, cap)
    return max(1, w)


# -- slots ----------------------------------------------------------------

class Slot(NamedTuple):
    kind: str            # "i64sum", "count", "f32sum", "mm"
    value: object        # [n] tensor (None for count)
    mask: object         # [n] bool tensor, or None for sel itself
    w: int = 0
    k: int = 0
    op: str = ""


def i64sum(value, mask, w: int, k: int) -> Slot:
    return Slot("i64sum", value, mask, w, k)


def count(mask=None) -> Slot:
    return Slot("count", None, mask)


def f32sum(value, mask) -> Slot:
    return Slot("f32sum", value, mask)


def minmax(value, mask, op: str) -> Slot:
    if op not in (MIN, MAX):
        raise ValueError(f"unknown MIN/MAX op {op!r}")
    return Slot("mm", value, mask, op=op)


@dataclass
class Plan:
    """One call as the kernel reads it: the distinct columns and masks,
    the kernel's slot words, the output sizes, and for each caller's
    slot where its result lands."""
    gid: torch.Tensor
    sel: torch.Tensor                 # uint8 [n]
    num_groups: int
    cols: list = field(default_factory=list)
    col_types: list = field(default_factory=list)
    masks: list = field(default_factory=list)   # uint8 [n] each
    kslots: list = field(default_factory=list)  # [kind, col, mask, row, w, k, frow, mx]
    nf: int = 1
    ni: int = 1
    n_mx: int = 0
    rep_row: int = -1
    rows: list = field(default_factory=list)


class SlotResult(NamedTuple):
    """aggregate_slots' result. rows[s], for the caller's slot s: i64sum
    (first limb row of acc_i, shadow row of acc_f, index into maxabs),
    count: its acc_i row, f32sum and minmax: their acc_f row. rep_row:
    the REPMIN row of acc_i (-1 without one)."""
    acc_f: torch.Tensor
    acc_i: torch.Tensor
    maxabs: torch.Tensor
    rows: list
    rep_row: int


def _key(t: torch.Tensor):
    return t.data_ptr(), t.dtype, t.stride(), t.shape


def _u8(t: torch.Tensor) -> torch.Tensor:
    if t.dtype is not torch.bool:
        t = t.to(torch.bool)
    if not t.is_contiguous():
        t = t.contiguous()
    return t.view(torch.uint8)


def _int32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype is not torch.int32:
        t = t.to(torch.int32)
    return t if t.is_contiguous() else t.contiguous()


def _check_device(gid):
    if gid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"groupagg_large: unsupported device {gid.device}")


def _check_column(t, n, dev):
    if t.device != dev or t.shape != (n,):
        raise ValueError("every column must be [n] on gid's device")


class _Columns:
    """Distinct value columns and masks of one call, by storage (a
    tensor object seen before skips the storage key and the checks)."""

    def __init__(self, plan: Plan, n: int, sel):
        self.plan, self.n, self.sel = plan, n, sel
        self.dev = plan.gid.device
        self.col_ix, self.mask_ix = {}, {}
        self.seen = {}
        self.sel_key = None

    def col(self, t, kind: str) -> int:
        """A value column as the kernel reads it: "int" (int64 or int32
        in place), "float" (float32 or float64 in place, else f32) or
        "any" (an integer or float dtype in place, else f32)."""
        ix = self.seen.get((id(t), kind))
        if ix is None:
            ix = self.seen[(id(t), kind)] = self._col(t, kind)
        return ix

    def _col(self, t, kind: str) -> int:
        _check_column(t, self.n, self.dev)
        ints = t.dtype in (torch.int64, torch.int32)
        if kind == "int" and not ints:
            raise ValueError(f"an integer slot needs int64 or int32 "
                             f"values, not {t.dtype}")
        convert = t.dtype not in _DTYPES or (kind == "float" and ints)
        key = _key(t) + (convert,)
        ix = self.col_ix.get(key)
        if ix is None:
            if convert:
                t = t.to(torch.float32)
            if not t.is_contiguous():
                t = t.contiguous()
            if len(self.plan.cols) == MAX_COLS:
                raise ValueError(f"more than {MAX_COLS} distinct columns")
            ix = self.col_ix[key] = len(self.plan.cols)
            self.plan.cols.append(t)
            self.plan.col_types.append(_DTYPES[t.dtype])
        return ix

    def mask(self, m) -> int:
        if m is None or m is self.sel:
            return _SEL
        ix = self.seen.get(id(m))
        if ix is None:
            ix = self.seen[id(m)] = self._mask(m)
        return ix

    def _mask(self, m) -> int:
        _check_column(m, self.n, self.dev)
        key = _key(m)
        if self.sel_key is None:
            self.sel_key = _key(self.sel)
        if key == self.sel_key:
            return _SEL
        ix = self.mask_ix.get(key)
        if ix is None:
            if len(self.plan.masks) == MAX_MASKS:
                raise ValueError(f"more than {MAX_MASKS} distinct masks")
            ix = self.mask_ix[key] = len(self.plan.masks)
            self.plan.masks.append(_u8(m))
        return ix


def plan_slots(gid, sel, slots, num_groups: int,
               want_rep: bool = False, point=None) -> Plan:
    """The kernel's view of `slots`: columns folded by storage, slots
    with the same columns folded into one (an i64sum keeps the larger
    k), output rows assigned. Takes aggregate_slots' arguments; the
    launch point does not change the plan."""
    _check_device(gid)
    n = gid.shape[0]
    if num_groups < 1 or n >= 2 ** 31:
        raise ValueError("need 1 <= num_groups and n < 2^31")
    _check_column(sel, n, gid.device)
    plan = Plan(_int32(gid), _u8(sel), num_groups)
    cols = _Columns(plan, n, sel)
    # fold key (kind, column, mask, w or op) -> limb count k
    folded = {}
    keys = []  # per caller's slot: its fold key
    for kind, value, mask, w, k, op in slots:
        if kind == "i64sum":
            if not 1 <= w <= 22 or not 1 <= k <= -(-64 // w):
                raise ValueError(f"bad limb layout w={w} k={k}")
            key = (_I64SUM, cols.col(value, "int"), cols.mask(mask), w)
        elif kind == "count":
            key = (_COUNT, -1, cols.mask(mask), 0)
        elif kind == "f32sum":
            key = (_FSUM, cols.col(value, "float"), cols.mask(mask), 0)
        elif kind == "mm":
            key = (_MIN if op == MIN else _MAX, cols.col(value, "any"),
                   cols.mask(mask), 0)
        else:
            raise ValueError(f"unknown slot kind {kind!r}")
        if folded.get(key, -1) < k:
            folded[key] = k
        keys.append(key)
    if len(folded) > MAX_SLOTS:
        raise ValueError(f"more than {MAX_SLOTS} distinct slots")
    # f32 rows (sums, shadows, MIN/MAX) and i32 rows (limbs and counts,
    # then REPMIN) in the order the slots first appear
    where = {}
    nf = ni = n_mx = 0
    for key, k in folded.items():
        kind, col, mask, w = key
        if kind == _I64SUM:
            plan.kslots.append([kind, col, mask, ni, w, k, nf, n_mx])
            where[key] = (ni, nf, n_mx)
            ni, nf, n_mx = ni + k, nf + 1, n_mx + 1
        elif kind == _COUNT:
            plan.kslots.append([kind, col, mask, ni, 0, 0, 0, 0])
            where[key] = ni
            ni += 1
        else:
            plan.kslots.append([kind, col, mask, nf, 0, 0, 0, 0])
            where[key] = nf
            nf += 1
    if want_rep:
        plan.rep_row = ni
        ni += 1
    plan.nf, plan.ni, plan.n_mx = max(1, nf), max(1, ni), n_mx
    plan.rows = [where[key] for key in keys]
    return plan


def plan_columns(gid, sel, mat_values, mm_values, num_groups: int,
                 mat_int: tuple, mm_ops: tuple = (),
                 want_rep: bool = False) -> Plan:
    """The kernel's view of the pre-built-column interface: one slot per
    column, in order (no mask: the columns come pre-masked; only REPMIN
    reads sel)."""
    _check_device(gid)
    n = gid.shape[0]
    n_mat = len(mat_values)
    if n_mat < 1 or len(mat_int) != n_mat:
        raise ValueError("need one mat_int flag per mat column")
    n_mat_i = sum(bool(b) for b in mat_int)
    n_mat_f = n_mat - n_mat_i
    if any(mat_int[:n_mat_f]) or not all(mat_int[n_mat_f:]):
        raise ValueError("float columns must precede integer columns")
    if len(mm_values) != len(mm_ops):
        raise ValueError("one mm op per mm column")
    if num_groups < 1 or n >= 2 ** 31:
        raise ValueError("need 1 <= num_groups and n < 2^31")
    if n_mat + len(mm_ops) > min(MAX_COLS, MAX_SLOTS):
        raise ValueError(f"more than {min(MAX_COLS, MAX_SLOTS)} columns")
    _check_column(sel, n, gid.device)
    plan = Plan(_int32(gid), _u8(sel), num_groups)
    for t in (*mat_values, *mm_values):
        _check_column(t, n, gid.device)
        t = t if t.dtype is torch.float32 else t.to(torch.float32)
        plan.cols.append(t if t.is_contiguous() else t.contiguous())
        plan.col_types.append(_DTYPES[torch.float32])
    for c in range(n_mat_f):
        plan.kslots.append([_FSUM, c, _NONE, c, 0, 0, 0, 0])
    for c in range(n_mat_i):
        plan.kslots.append([_ISUM, n_mat_f + c, _NONE, c, 0, 0, 0, 0])
    for r, op in enumerate(mm_ops):
        if op not in (MIN, MAX):
            raise ValueError(f"unknown MIN/MAX op {op!r}")
        plan.kslots.append([_MIN if op == MIN else _MAX, n_mat + r, _NONE,
                            n_mat_f + r, 0, 0, 0, 0])
    plan.nf = max(1, n_mat_f + len(mm_ops))
    plan.ni = max(1, n_mat_i + (1 if want_rep else 0))
    plan.rep_row = n_mat_i if want_rep else -1
    return plan


# -- entry points -----------------------------------------------------------

def aggregate_slots(gid, sel, slots: tuple, num_groups: int,
                    want_rep: bool = False, point=None) -> SlotResult:
    """One-pass large-G grouped aggregation over slots (module
    docstring). gid: int[n] dense ids; rows outside [0, G) match no
    group. sel: bool[n]. ``point``: the launch point (block, rows,
    min_blocks[, limb_cap]), the shipped one when None; every point
    gives the same result."""
    plan = plan_slots(gid, sel, slots, num_groups, want_rep)
    return SlotResult(*_run(plan, point), plan.rows, plan.rep_row)


def aggregate_slots_plain(gid, sel, slots: tuple, num_groups: int,
                          want_rep: bool = False,
                          point=None) -> SlotResult:
    """aggregate_slots in plain PyTorch scatters, on any device (the
    launch point does not change the result)."""
    plan = plan_slots(gid, sel, slots, num_groups, want_rep)
    return SlotResult(*_plain(plan), plan.rows, plan.rep_row)


def large_group_aggregate(gid, sel, mat_values: tuple, mm_values: tuple,
                          num_groups: int, mat_int: tuple,
                          mm_ops: tuple = (), want_rep: bool = False):
    """The pre-built-column interface (module docstring): mat_values,
    one [n] column per sum slot, float columns first, then the
    `mat_int` True tail (integer-valued f32 columns); mm_values/mm_ops:
    MIN/MAX columns, pre-masked to their identities."""
    plan = plan_columns(gid, sel, mat_values, mm_values, num_groups,
                        mat_int, mm_ops, want_rep)
    return _run(plan)[:2]


def large_group_aggregate_plain(gid, sel, mat_values: tuple,
                                mm_values: tuple, num_groups: int,
                                mat_int: tuple, mm_ops: tuple = (),
                                want_rep: bool = False):
    """large_group_aggregate in plain PyTorch scatters, on any device."""
    plan = plan_columns(gid, sel, mat_values, mm_values, num_groups,
                        mat_int, mm_ops, want_rep)
    return _plain(plan)[:2]


def _run(plan: Plan, point=None):
    global PLAIN_CALLS
    dev = plan.gid.device
    kp = kernel_point(point)
    if dev.type == "cpu":
        with _COUNT_LOCK:
            PLAIN_CALLS += 1
        return _plain(plan)
    return launch(plan, choose_layout(plan), _lib(), kp)


def kernel_point(point) -> tuple:
    """The (block, rows, min_blocks) of a launch point or an autotune
    point (which adds the limb cap); raises for one the library does not
    hold."""
    if point is None:
        return DEFAULT_POINT
    kp = tuple(int(v) for v in point[:3])
    if kp not in KERNEL_POINTS:
        raise ValueError(f"no kernel instantiation for launch point {kp}")
    return kp


def choose_layout(plan: Plan) -> str:
    """Shared-memory accumulators where one [NF + NI, G] copy fits in a
    block's shared memory, else global atomics."""
    return "shared" if fits(plan, "shared") else "global"


def fits(plan: Plan, layout: str) -> bool:
    """Whether a layout takes the plan: global atomics always, shared
    memory where one [NF + NI, G] copy of the accumulators fits."""
    return layout == "global" or \
        4 * (plan.nf + plan.ni) * plan.num_groups <= SMEM_LIMIT


def launch(plan: Plan, layout: str, lib: ctypes.CDLL,
           point: tuple = DEFAULT_POINT):
    """Allocate the outputs and launch `lib`'s kernel once, with the
    given accumulator layout and launch point, on the current stream
    (asynchronous; the library initialises the outputs itself). Raises
    if it is refused. Returns (acc_f, acc_i, maxabs)."""
    run, out = launcher(plan, layout, lib, point)
    run()
    return out


def launcher(plan: Plan, layout: str, lib: ctypes.CDLL,
             point: tuple = DEFAULT_POINT):
    """One launch prepared: returns (run, (acc_f, acc_i, maxabs)), the
    outputs allocated and the arguments packed, run() launching on the
    current stream. Each run initialises the outputs and folds the rows
    into them again."""
    dev = plan.gid.device
    G = plan.num_groups
    if not fits(plan, layout):
        raise ValueError(f"layout {layout!r} does not fit G = {G}")
    # one allocation: f32 rows, i32 rows, then the int64 words at an
    # even offset
    nfw, niw = plan.nf * G, plan.ni * G
    off = (nfw + niw + 1) & ~1
    buf = torch.empty(off + 2 * max(1, plan.n_mx), dtype=torch.int32,
                      device=dev)
    acc_f = buf[:nfw].view(torch.float32).view(plan.nf, G)
    acc_i = buf[nfw:nfw + niw].view(plan.ni, G)
    maxabs = buf[off:].view(torch.int64)
    nc, nm, ns = len(plan.cols), len(plan.masks), len(plan.kslots)
    args = (plan.gid.data_ptr(), plan.sel.data_ptr(), acc_f.data_ptr(),
            acc_i.data_ptr(), maxabs.data_ptr(),
            struct.pack(f"{nc}q", *(c.data_ptr() for c in plan.cols)),
            bytes(plan.col_types), nc,
            struct.pack(f"{nm}q", *(m.data_ptr() for m in plan.masks)), nm,
            struct.pack(f"{8 * ns}i", *(v for s in plan.kslots for v in s)),
            ns, plan.gid.shape[0], G, plan.nf, plan.ni, plan.n_mx,
            plan.rep_row, LAYOUTS.index(layout),
            KERNEL_POINTS.index(kernel_point(point)))
    stream = torch._C._cuda_getCurrentRawStream(dev.index)

    def run():
        global LAUNCHES
        err = lib.groupagg_large_launch(*args, stream)
        if err != 0:
            raise RuntimeError(
                "groupagg_large launch failed: "
                + lib.groupagg_large_error_string(err).decode())
        with _COUNT_LOCK:
            LAUNCHES += 1

    return run, (acc_f, acc_i, maxabs)


def _lib() -> ctypes.CDLL:
    return typed(build.load("groupagg_large"))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` (a build of csrc/groupagg_large.cu) with its C signatures;
    raises if its launch points are not KERNEL_POINTS."""
    if not getattr(lib, "_typed", False):
        p, i, ll, b = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_char_p)
        lib.groupagg_large_launch.argtypes = [
            p, p, p, p, p, b, b, i, b, i, b, i, ll, i, i, i, i, i, i, i, p]
        lib.groupagg_large_launch.restype = i
        lib.groupagg_large_error_string.argtypes = [i]
        lib.groupagg_large_error_string.restype = ctypes.c_char_p
        lib.groupagg_large_points.argtypes = [p, i]
        lib.groupagg_large_points.restype = i
        cap = 3 * 16
        buf = (ctypes.c_int * cap)()
        got = lib.groupagg_large_points(buf, cap)
        pts = tuple(tuple(buf[3 * j:3 * j + 3]) for j in range(got))
        if pts != KERNEL_POINTS:
            raise RuntimeError(f"groupagg_large library holds launch "
                               f"points {pts}, not {KERNEL_POINTS}")
        lib._typed = True
    return lib


# -- plain version ----------------------------------------------------------

def _plain(plan: Plan):
    """The plan in plain PyTorch scatters, on any device. Float sums
    accumulate in float64 and round to f32 once (so they sit within f32
    rounding of the exact sum); integer sums accumulate in int64 and
    wrap to int32 like the kernel's atomics; a NaN in a MIN/MAX operand
    makes its group's result NaN. Returns (acc_f, acc_i, maxabs)."""
    gid = plan.gid
    n = gid.shape[0]
    dev = gid.device
    G = plan.num_groups
    ok = (gid >= 0) & (gid < G)
    slot = torch.where(ok, gid.to(torch.int64), G)
    sel = plan.sel.to(torch.bool)
    acc_f = torch.zeros((plan.nf, G + 1), dtype=torch.float64, device=dev)
    acc_i = torch.zeros((plan.ni, G + 1), dtype=torch.int64, device=dev)
    maxabs = torch.zeros(max(1, plan.n_mx), dtype=torch.int64, device=dev)

    def passes(mask):
        if mask == _NONE:
            return torch.ones(n, dtype=torch.bool, device=dev)
        if mask == _SEL:
            return sel
        return sel & plan.masks[mask].to(torch.bool)

    def fsum(row, v):
        acc_f[row].index_add_(0, slot, v.to(torch.float32)
                              .to(torch.float64))

    for kind, c, mask, row, w, k, frow, mx in plan.kslots:
        m = passes(mask)
        if kind == _COUNT:
            acc_i[row].index_add_(0, slot, m.to(torch.int64))
        elif kind == _ISUM:
            v = torch.round(plan.cols[c].to(torch.float32))
            acc_i[row].index_add_(0, slot, torch.where(m, v, 0)
                                  .to(torch.int64))
        elif kind == _I64SUM:
            v = torch.where(m, plan.cols[c].to(torch.int64), 0)
            for j in range(k):
                acc_i[row + j].index_add_(0, slot, aggops.limb(v, j, w))
            fsum(frow, v)
            # |v| as uint64 bits: -INT64_MIN wraps to itself, 2^63
            a = torch.where(v < 0, -v, v)
            maxabs[mx] = torch.where(torch.any(a < 0),
                                     torch.iinfo(torch.int64).min,
                                     torch.amax(a))
        elif kind == _FSUM:
            fsum(row, torch.where(m, plan.cols[c].to(torch.float64), 0.0))
        else:
            col = plan.cols[c]
            v = (col.to(torch.int64) >> MM_HI_SHIFT).to(torch.float32) \
                if not col.is_floating_point() else col.to(torch.float32)
            op = "amin" if kind == _MIN else "amax"
            ident = math.inf if kind == _MIN else -math.inf
            r = torch.full((G + 1,), ident, dtype=torch.float32,
                           device=dev)
            r.scatter_reduce_(0, slot, torch.where(m, v, ident), reduce=op,
                              include_self=True)
            nans = torch.zeros(G + 1, dtype=torch.int64, device=dev)
            nans.index_add_(0, slot, (m & torch.isnan(v)).to(torch.int64))
            acc_f[row] = torch.where(nans > 0, math.nan, r).to(torch.float64)
    if plan.rep_row >= 0:
        rslot = torch.where(ok & sel, slot, G)
        rid = torch.arange(n, dtype=torch.int64, device=dev)
        acc_i[plan.rep_row] = n
        acc_i[plan.rep_row].scatter_reduce_(0, rslot, rid, reduce="amin",
                                            include_self=True)
    return (acc_f[:, :G].to(torch.float32).contiguous(),
            acc_i[:, :G].to(torch.int32), maxabs)
