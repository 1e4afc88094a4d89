"""One-pass small-G grouped COUNT/SUM/MIN/MAX: CUDA kernel + plain version.

Replaces cockroach_tpu/ops/pallas/groupagg.py:dense_group_aggregate.
The TPU kernel folds each row block into scalar SMEM accumulators with
one masked full-tile reduction per (group, slot) pair, G * A reductions
per block. The Hopper kernel (csrc/groupagg.cu) sends each row to its
own group instead. It is bounded by device-memory bytes, each distinct
column read once: gid 4 B + sel 1 B + per distinct value column 4 or
8 B + per distinct mask 1 B a row.

Shared accumulators updated with atomics contend when the rows of one
warp fall in several groups, and a mask read once per slot repeats
bytes. So the wrapper deduplicates value and mask columns by storage
(``column_plan``: a mask that is sel itself is not read at all) and the
kernel loads each distinct column once per row, four consecutive rows a
thread in vector loads (a scalar-load build of the same kernel takes
pointers that are not aligned for them). Its accumulators follow
``choose_strategy(G, A)``: one private copy per thread where G * A
words a thread fit in shared memory (no atomics in the row loop), else
one per block, with the lanes of a warp that hold one group combined by
``__match_any_sync`` and shuffles before one shared atomic. Each block
merges its copies and makes one global update per (group, slot).

The contract is the TPU kernel's: ops per slot are COUNT, SUM, MIN, MAX
= 0, 1, 2, 3; values accumulate in f32 and counts in i32; the result is
(f32[G, A], i32[G, A]), a COUNT slot's in the i32 array and the others'
in the f32 array (the unused column of each array holds 0). Empty
groups hold 0, 0, +inf and -inf. A row counts in slot a of group g when
sel, masks[a] and gid == g hold; the value of a COUNT slot is never
read. n % 128 == 0 and G <= 64, as the reference asserts, so both
packages route the same plans here.

``dense_group_aggregate`` launches the kernel for CUDA tensors and
raises if it cannot; it takes the plain PyTorch version only for
tensors on the CPU. LAUNCHES counts kernel launches, PLAIN_CALLS calls
of the plain version through the wrapper.
"""

from __future__ import annotations

import ctypes
import math
import threading
from dataclasses import dataclass

import torch

from . import build

# op kinds, per aggregate slot (the reference's values)
COUNT, SUM, MIN, MAX = 0, 1, 2, 3

LANES = 128
MAX_GROUPS = 64

# Dynamic shared memory a block may use on Hopper (227 KB).
SMEM_LIMIT = 232_448
# csrc/groupagg.cu's threads per block, and the accumulator copies per
# block of each strategy, in the kernel's order
BLOCK = 128
STRATEGIES = {"thread": BLOCK, "cta": 1}

LAUNCHES = 0
PLAIN_CALLS = 0
# the counts are bumped from a distributed plan's shard threads too
_COUNT_LOCK = threading.Lock()


def _check(gid, sel, values, masks, num_groups, ops):
    n = gid.shape[0]
    if n % LANES:
        raise ValueError("row count must be a multiple of 128")
    if not 1 <= num_groups <= MAX_GROUPS:
        raise ValueError(f"need 1 <= num_groups <= {MAX_GROUPS}")
    if not ops or len(values) != len(ops) or len(masks) != len(ops):
        raise ValueError("need one value and one mask per slot")
    for op in ops:
        if op not in (COUNT, SUM, MIN, MAX):
            raise ValueError(f"unknown op {op!r}")
    for t in (sel, *values, *masks):
        if t.device != gid.device or t.shape != (n,):
            raise ValueError("every column must be [n] on gid's device")


def _init_outputs(num_groups, ops, device):
    acc = torch.zeros((num_groups, len(ops)), dtype=torch.float32,
                      device=device)
    for a, op in enumerate(ops):
        if op in (MIN, MAX):
            acc[:, a] = math.inf if op == MIN else -math.inf
    cnt = torch.zeros((num_groups, len(ops)), dtype=torch.int32,
                      device=device)
    return acc, cnt


def fitting_strategies(num_groups: int, num_slots: int) -> list[str]:
    """The accumulator layouts, in STRATEGIES' order, whose copies (G * A
    32-bit words each) fit in shared memory for G groups and A slots
    beside the plan's descriptors, which take at most 32 * A + 16
    bytes."""
    words = num_groups * num_slots
    return [name for name, copies in STRATEGIES.items()
            if 4 * words * copies + 32 * num_slots + 16 <= SMEM_LIMIT]


def choose_strategy(num_groups: int, num_slots: int) -> str:
    """The kernel's accumulator layout for G groups and A slots: the
    first that fits. Raises past the per-block layout."""
    fit = fitting_strategies(num_groups, num_slots)
    if not fit:
        raise ValueError(f"G * A = {num_groups * num_slots} accumulators "
                         "do not fit in 227 KB of shared memory")
    return fit[0]


@dataclass
class ColumnPlan:
    """One call as the kernel reads it: sel, the distinct mask columns
    and the distinct value columns (by storage), and per slot (value
    column or -1 for COUNT, mask column + 1 or 0 when the mask is sel,
    op, output column)."""
    sel: torch.Tensor                 # uint8 [n]
    masks: list[torch.Tensor]         # uint8 [n] each
    values: list[torch.Tensor]        # float32 or float64 [n] each
    slots: list[tuple[int, int, int, int]]


def _key(t: torch.Tensor):
    return t.data_ptr(), t.dtype, t.stride()


def _u8(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bool).contiguous().view(torch.uint8)


def column_plan(sel, values, masks, ops) -> ColumnPlan:
    """Deduplicate the slots' columns by storage (works on any device)."""
    sel_key = _key(sel)
    plan = ColumnPlan(_u8(sel), [], [], [])
    mask_ix, value_ix = {}, {}
    for a, (v, m, op) in enumerate(zip(values, masks, ops)):
        k = _key(m)
        if k == sel_key:
            mi = 0
        else:
            if k not in mask_ix:
                mask_ix[k] = len(plan.masks)
                plan.masks.append(_u8(m))
            mi = mask_ix[k] + 1
        vi = -1
        if op != COUNT:
            k = _key(v)
            if k not in value_ix:
                # float64 columns are read in place and rounded to f32
                # in registers; anything else becomes f32 first
                if v.dtype not in (torch.float32, torch.float64):
                    v = v.to(torch.float32)
                value_ix[k] = len(plan.values)
                plan.values.append(v.contiguous())
            vi = value_ix[k]
        plan.slots.append((vi, mi, op, a))
    return plan


def dense_group_aggregate(gid, sel, values: tuple, masks: tuple,
                          num_groups: int, ops: tuple):
    """One-pass grouped aggregation (contract in the module docstring).
    gid: int[n] dense ids; sel, masks: bool[n]; values: float[n], one
    per slot (ignored for COUNT slots)."""
    global PLAIN_CALLS
    dev = gid.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"dense_group_aggregate: unsupported device {dev}")
    ops = tuple(int(op) for op in ops)
    _check(gid, sel, values, masks, num_groups, ops)
    if dev.type == "cpu":
        with _COUNT_LOCK:
            PLAIN_CALLS += 1
        return dense_group_aggregate_plain(gid, sel, values, masks,
                                           num_groups, ops)
    return _launch(gid, sel, values, masks, num_groups, ops,
                   choose_strategy(num_groups, len(ops)), _lib())


def _launch(gid, sel, values, masks, num_groups, ops, strategy: str,
            lib: ctypes.CDLL):
    """Allocate and initialise the outputs and launch `lib`'s kernel
    once with the given accumulator layout on the current stream
    (asynchronous); raises if the launch is refused."""
    launch, acc, cnt = _launcher(gid, sel, values, masks, num_groups, ops,
                                 strategy, lib)
    launch()
    return acc, cnt


def _launcher(gid, sel, values, masks, num_groups, ops, strategy: str,
              lib: ctypes.CDLL):
    """One launch of `lib`'s kernel, prepared: returns (launch, acc,
    cnt), with the outputs initialised and launch() folding the rows
    into them on the current stream (asynchronous; each call folds them
    in again), raising if the launch is refused. The library sizes the
    layout's shared memory itself."""
    dev = gid.device
    n = gid.shape[0]
    A = len(ops)
    if n >= 2 ** 31:
        raise ValueError("need n < 2^31")
    gid32 = gid.to(torch.int32).contiguous()
    plan = column_plan(sel, values, masks, ops)
    nM, nV = len(plan.masks), len(plan.values)
    # op | mask << 2 | value column << 16 | output column << 32; the
    # strategies' shared-memory limit keeps A, and so both column
    # fields, far inside their bits
    descs = [op | (mi << 2) | ((vi + 1) << 16) | (a << 32)
             for vi, mi, op, a in plan.slots]
    # pointers and descriptors reach the card from pinned memory without
    # waiting for the stream (the host allocator keeps the buffer until
    # the copy has run); the plan keeps the columns alive meanwhile
    words = torch.tensor(
        [t.data_ptr() for t in plan.masks + plan.values]
        + [int(v.dtype == torch.float64) for v in plan.values]
        + descs, dtype=torch.int64)
    words = words.pin_memory().to(dev, non_blocking=True)
    vec = (gid32.data_ptr() % 16 == 0
           and all(t.data_ptr() % 4 == 0 for t in [plan.sel] + plan.masks)
           and all(t.data_ptr() % 16 == 0 for t in plan.values))
    acc, cnt = _init_outputs(num_groups, ops, dev)

    def launch():
        global LAUNCHES
        err = lib.groupagg_launch(
            gid32.data_ptr(), plan.sel.data_ptr(), words.data_ptr(),
            acc.data_ptr(), cnt.data_ptr(), n, num_groups, A, nM, nV,
            list(STRATEGIES).index(strategy), int(vec),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError("groupagg launch failed: "
                               + lib.groupagg_error_string(err).decode())
        with _COUNT_LOCK:
            LAUNCHES += 1

    return launch, acc, cnt


def _lib() -> ctypes.CDLL:
    return typed(build.load("groupagg"))


def typed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` (a build of csrc/groupagg.cu) with its C signatures set."""
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.groupagg_launch.argtypes = [p, p, p, p, p, ll, i, i, i, i, i, i,
                                        p]
        lib.groupagg_launch.restype = i
        lib.groupagg_error_string.argtypes = [i]
        lib.groupagg_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def dense_group_aggregate_plain(gid, sel, values: tuple, masks: tuple,
                                num_groups: int, ops: tuple):
    """The same function in plain PyTorch scatters, on any device. Sums
    of the f32-rounded values accumulate in float64 and round to f32
    once; counts accumulate in int64 and narrow to int32; MIN/MAX use
    scatter_reduce_ with a per-group NaN count, so a NaN value makes
    its group's result NaN on every device."""
    G = num_groups
    dev = gid.device
    ok = sel.to(torch.bool) & (gid >= 0) & (gid < G)
    acc, cnt = _init_outputs(G + 1, ops, dev)
    for a, op in enumerate(ops):
        m = ok & masks[a].to(torch.bool)
        slot = torch.where(m, gid.to(torch.int64), G)
        if op == COUNT:
            c = torch.zeros(G + 1, dtype=torch.int64, device=dev)
            c.index_add_(0, slot, m.to(torch.int64))
            cnt[:, a] = c.to(torch.int32)
            continue
        v = values[a].to(torch.float32)
        if op == SUM:
            s = torch.zeros(G + 1, dtype=torch.float64, device=dev)
            s.index_add_(0, slot, torch.where(m, v.to(torch.float64), 0.0))
            acc[:, a] = s.to(torch.float32)
            continue
        ident = math.inf if op == MIN else -math.inf
        r = torch.full((G + 1,), ident, dtype=torch.float32, device=dev)
        r.scatter_reduce_(0, slot, torch.where(m, v, ident),
                          reduce="amin" if op == MIN else "amax",
                          include_self=True)
        nans = torch.zeros(G + 1, dtype=torch.int64, device=dev)
        nans.index_add_(0, slot, (m & torch.isnan(v)).to(torch.int64))
        acc[:, a] = torch.where(nans > 0, math.nan, r)
    return acc[:G].contiguous(), cnt[:G].contiguous()
