"""cockroach_tpu_torch: the SQL engine's device side in PyTorch and CUDA.

A second package beside ``cockroach_tpu`` (the JAX reference). The host
layers (SQL parser, binder, planner, columnar MVCC store, TPC-H
workload) are this package's own copies; the device layers (columnar
batch, SQL kernels, expression compiler, aggregation, plan compiler)
are PyTorch tensor code, and the one hand-written kernel on the main
path is CUDA C++ for Hopper (``csrc/groupagg_large.cu``).

    sql/        parser, AST, binder, planner, stats (host)
    storage/    columnar MVCC store, HLC, state transfer (host)
    models/     TPC-H generators, Q1/Q6 texts and numpy oracles
    ops/        ColumnBatch, SQL kernels, aggregation
    ops/cuda/   wrappers of the hand-written CUDA kernels
    csrc/       CUDA C++ sources (built with nvcc at first use)
    exec/       plan compiler, the Engine, streamed pages and spill
    utils/      settings, memory budget, device memory, metrics

Device policy: every entry point runs on ``cuda`` unless the caller
passes ``device="cpu"``; with no card and no explicit device it raises
instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.4.0"


def default_device() -> torch.device:
    """The device entry points use when the caller names none: the
    current CUDA card. Raises when there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' explicitly to "
            "run the plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, or default_device() when None."""
    if device is None:
        return default_device()
    return torch.device(device)
