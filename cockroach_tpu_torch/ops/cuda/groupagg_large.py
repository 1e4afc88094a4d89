"""One-pass large-G dense grouped aggregation: CUDA kernel + plain version.

Replaces cockroach_tpu/ops/pallas/groupagg_large.py:large_group_aggregate.
The TPU kernel folds each (group tile, row block) step into a VMEM
accumulator with a one_hot(gid)^T @ mat product on the MXU, O(n * G)
work. The Hopper kernel (csrc/groupagg_large.cu) adds each row into its
own group with atomics instead, O(n) work: it is bounded by device-
memory bytes, each row read once, n * (4 * n_mat + 4 * n_mm + 5) bytes.
Per-CTA accumulators live in shared memory when they fit, else the
atomics go to global memory (see the source's header).

The output contract is the TPU kernel's, so the caller's limb split
and recombination (exec/compile.py) are unchanged:
(f32[NF, G], i32[NI, G]) with NF = max(1, n_f + len(mm_ops)) (float
sums first, then MIN/MAX rows) and NI = max(1, n_i + want_rep)
(integer sums first, then the REPMIN row: the smallest selected row id,
n for an empty group).

``large_group_aggregate`` launches the kernel for CUDA tensors and
raises if it cannot; it takes the plain PyTorch version only for
tensors on the CPU. LAUNCHES counts kernel launches, PLAIN_CALLS calls
of the plain version through the wrapper.
"""

from __future__ import annotations

import ctypes
import math
import torch

from . import build

MIN, MAX = "min", "max"

# Tile constants of the TPU kernel, kept so limb_width (which the
# exactness of its f32 block partials bounded) gives the same limb
# layout as the reference's.
LANES = 128
GROUP_TILE = 512
BLOCK_ROWS = 1024

# Dynamic shared memory a block may use on Hopper (227 KB).
SMEM_LIMIT = 232_448

LAUNCHES = 0
PLAIN_CALLS = 0


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


def _layout(mat_values, mat_int, mm_ops, want_rep):
    n_mat = len(mat_values)
    if n_mat < 1 or len(mat_int) != n_mat:
        raise ValueError("need one mat_int flag per mat column")
    n_mat_i = sum(bool(b) for b in mat_int)
    n_mat_f = n_mat - n_mat_i
    # f columns first, then i columns
    if any(mat_int[:n_mat_f]) or not all(mat_int[n_mat_f:]):
        raise ValueError("float columns must precede integer columns")
    for op in mm_ops:
        if op not in (MIN, MAX):
            raise ValueError(f"unknown MIN/MAX op {op!r}")
    nf = max(1, n_mat_f + len(mm_ops))
    ni = max(1, n_mat_i + (1 if want_rep else 0))
    return n_mat_f, n_mat_i, nf, ni


def _init_outputs(n, num_groups, n_mat_f, n_mat_i, nf, ni, mm_ops,
                  want_rep, device, int_dtype):
    acc_f = torch.zeros((nf, num_groups), dtype=torch.float32,
                        device=device)
    for r, op in enumerate(mm_ops):
        acc_f[n_mat_f + r].fill_(math.inf if op == MIN else -math.inf)
    acc_i = torch.zeros((ni, num_groups), dtype=int_dtype, device=device)
    if want_rep:
        acc_i[n_mat_i].fill_(n)
    return acc_f, acc_i


def large_group_aggregate(gid, sel, mat_values: tuple, mm_values: tuple,
                          num_groups: int, mat_int: tuple,
                          mm_ops: tuple = (), want_rep: bool = False):
    """One-pass large-G grouped aggregation (contract in the module
    docstring). gid: int[n] dense ids; rows outside [0, G) match no
    group. sel is read only by the REPMIN row. mat_values: one [n]
    column per sum slot, float columns first, then the `mat_int` True
    tail (limb and count columns, integer-valued). mm_values/mm_ops:
    MIN/MAX columns, pre-masked to their identities."""
    global PLAIN_CALLS
    dev = gid.device
    if dev.type == "cpu":
        PLAIN_CALLS += 1
        return large_group_aggregate_plain(
            gid, sel, mat_values, mm_values, num_groups, mat_int,
            mm_ops, want_rep)
    if dev.type != "cuda":
        raise ValueError(f"large_group_aggregate: unsupported device {dev}")
    return _launch(gid, sel, mat_values, mm_values, num_groups, mat_int,
                   mm_ops, want_rep)


def _launch(gid, sel, mat_values, mm_values, num_groups, mat_int, mm_ops,
            want_rep):
    """Check the inputs, allocate and initialise the outputs and launch
    the kernel once on the current stream (asynchronous); raises if the
    launch is refused."""
    global LAUNCHES
    dev = gid.device
    n = gid.shape[0]
    if len(mm_values) != len(mm_ops):
        raise ValueError("one mm op per mm column")
    if num_groups < 1 or n >= 2 ** 31 or len(mm_ops) > 32:
        raise ValueError("need 1 <= num_groups, n < 2^31 and at most 32 "
                         "MIN/MAX columns")
    n_mat_f, n_mat_i, nf, ni = _layout(mat_values, mat_int, mm_ops,
                                       want_rep)
    for t in (sel, *mat_values, *mm_values):
        if t.device != dev or t.shape != (n,):
            raise ValueError("every column must be [n] on gid's device")
    gid32 = gid.to(torch.int32).contiguous()
    sel8 = sel.to(torch.bool).contiguous().view(torch.uint8)
    # the kernel reads every column in place: f32 columns are not copied
    cols = [v.to(torch.float32).contiguous()
            for v in (*mat_values, *mm_values)]
    # the column pointers go to the card from pinned memory without
    # waiting for the stream (the host allocator keeps the buffer until
    # the copy has run)
    ptrs = torch.tensor([c.data_ptr() for c in cols], dtype=torch.int64) \
        .pin_memory().to(dev, non_blocking=True)
    acc_f, acc_i = _init_outputs(n, num_groups, n_mat_f, n_mat_i, nf, ni,
                                 mm_ops, want_rep, dev, torch.int32)
    smem = (nf + ni) * num_groups * 4
    mm_max_mask = sum(1 << r for r, op in enumerate(mm_ops) if op == MAX)
    lib = _lib()
    err = lib.groupagg_large_launch(
        gid32.data_ptr(), sel8.data_ptr(), ptrs.data_ptr(),
        acc_f.data_ptr(), acc_i.data_ptr(), n, num_groups, n_mat_f,
        n_mat_i, len(mm_ops), mm_max_mask, int(bool(want_rep)), nf, ni,
        smem if smem <= SMEM_LIMIT else 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("groupagg_large launch failed: "
                           + lib.groupagg_large_error_string(err).decode())
    LAUNCHES += 1
    return acc_f, acc_i


def _lib() -> ctypes.CDLL:
    lib = build.load("groupagg_large")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.groupagg_large_launch.argtypes = [
            p, p, p, p, p, ll, i, i, i, i, ctypes.c_uint, i, i, i, i, p]
        lib.groupagg_large_launch.restype = i
        lib.groupagg_large_error_string.argtypes = [i]
        lib.groupagg_large_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def large_group_aggregate_plain(gid, sel, mat_values: tuple,
                                mm_values: tuple, num_groups: int,
                                mat_int: tuple, mm_ops: tuple = (),
                                want_rep: bool = False):
    """The same function in plain PyTorch scatters, on any device.
    Float sums accumulate in float64 and round to f32 once (so they sit
    within f32 rounding of the exact sum); integer sums accumulate in
    int64 and wrap to int32 like the kernel's atomics; a NaN in a
    MIN/MAX column makes its group's result NaN."""
    n = gid.shape[0]
    dev = gid.device
    n_mat_f, n_mat_i, nf, ni = _layout(mat_values, mat_int, mm_ops,
                                       want_rep)
    G = num_groups
    ok = (gid >= 0) & (gid < G)
    slot = torch.where(ok, gid.to(torch.int64), G)
    acc_f, acc_i = _init_outputs(n, G + 1, n_mat_f, n_mat_i, nf, ni,
                                 mm_ops, want_rep, dev, torch.int64)
    for c in range(n_mat_f):
        s = torch.zeros(G + 1, dtype=torch.float64, device=dev)
        s.index_add_(0, slot, mat_values[c].to(torch.float64))
        acc_f[c] = s.to(torch.float32)
    for c in range(n_mat_i):
        v = torch.round(mat_values[n_mat_f + c].to(torch.float32))
        acc_i[c].index_add_(0, slot, v.to(torch.int64))
    for r, op in enumerate(mm_ops):
        v = mm_values[r].to(torch.float32)
        acc_f[n_mat_f + r].scatter_reduce_(
            0, slot, v, reduce="amin" if op == MIN else "amax",
            include_self=True)
        # a NaN makes its group's result NaN on every device
        nans = torch.zeros(G + 1, dtype=torch.int64, device=dev)
        nans.index_add_(0, slot, torch.isnan(v).to(torch.int64))
        acc_f[n_mat_f + r] = torch.where(nans > 0, math.nan,
                                         acc_f[n_mat_f + r])
    if want_rep:
        rslot = torch.where(ok & sel.to(torch.bool), slot, G)
        rid = torch.arange(n, dtype=torch.int64, device=dev)
        acc_i[n_mat_i].scatter_reduce_(0, rslot, rid, reduce="amin",
                                       include_self=True)
    return acc_f[:, :G].contiguous(), acc_i[:, :G].to(torch.int32)
