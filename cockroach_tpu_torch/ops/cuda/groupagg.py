"""One-pass small-G grouped COUNT/SUM/MIN/MAX: CUDA kernel + plain version.

Replaces cockroach_tpu/ops/pallas/groupagg.py:dense_group_aggregate.
The TPU kernel folds each row block into scalar SMEM accumulators with
one masked full-tile reduction per (group, slot) pair, G * A reductions
per block. The Hopper kernel (csrc/groupagg.cu) sends each row to its
own group instead: per-CTA [G, A] accumulators in shared memory, a warp
pre-reduction when a warp's rows share one group, and global atomics to
merge the CTAs. It is bounded by device-memory bytes, each row read
once: gid 4 B + sel 1 B + per distinct slot column its value (4 or 8 B)
and mask (1 B).

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

import torch

from . import build

# op kinds, per aggregate slot (the reference's values)
COUNT, SUM, MIN, MAX = 0, 1, 2, 3

LANES = 128
MAX_GROUPS = 64

# Dynamic shared memory a block may use on Hopper (227 KB).
SMEM_LIMIT = 232_448

LAUNCHES = 0
PLAIN_CALLS = 0


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
        PLAIN_CALLS += 1
        return dense_group_aggregate_plain(gid, sel, values, masks,
                                           num_groups, ops)
    return _launch(gid, sel, values, masks, num_groups, ops)


def _launch(gid, sel, values, masks, num_groups, ops):
    """Allocate and initialise the outputs and launch the kernel once on
    the current stream (asynchronous); raises if the launch is
    refused."""
    global LAUNCHES
    dev = gid.device
    n = gid.shape[0]
    A = len(ops)
    smem = num_groups * A * 8 + A * 4
    if n >= 2 ** 31 or smem > SMEM_LIMIT:
        raise ValueError("need n < 2^31 and G * A * 8 + A * 4 bytes of "
                         "shared memory within 227 KB")
    gid32 = gid.to(torch.int32).contiguous()
    sel8 = sel.to(torch.bool).contiguous().view(torch.uint8)
    keep = [gid32, sel8]   # alive until the launch is queued
    vptrs, mptrs, descs = [], [], []
    for v, m, op in zip(values, masks, ops):
        if op == COUNT:
            vptrs.append(0)
        else:
            # float64 columns are read in place and rounded to f32 in
            # registers; anything else becomes f32 first
            if v.dtype not in (torch.float32, torch.float64):
                v = v.to(torch.float32)
            v = v.contiguous()
            keep.append(v)
            vptrs.append(v.data_ptr())
        m8 = m.to(torch.bool).contiguous().view(torch.uint8)
        keep.append(m8)
        mptrs.append(m8.data_ptr())
        descs.append(op | (4 if op != COUNT and v.dtype == torch.float64
                           else 0))
    # pointers and descriptors reach the card from pinned memory without
    # waiting for the stream (the host allocator keeps the buffer until
    # the copy has run)
    slots = torch.tensor(vptrs + mptrs + descs, dtype=torch.int64) \
        .pin_memory().to(dev, non_blocking=True)
    acc, cnt = _init_outputs(num_groups, ops, dev)
    lib = _lib()
    err = lib.groupagg_launch(
        gid32.data_ptr(), sel8.data_ptr(), slots.data_ptr(),
        acc.data_ptr(), cnt.data_ptr(), n, num_groups, A, smem,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("groupagg launch failed: "
                           + lib.groupagg_error_string(err).decode())
    LAUNCHES += 1
    return acc, cnt


def _lib() -> ctypes.CDLL:
    lib = build.load("groupagg")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.groupagg_launch.argtypes = [p, p, p, p, p, ll, i, i, i, p]
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
