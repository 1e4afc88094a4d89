"""Device-resident columnar batch: the analogue of ``coldata.Batch``.

The reference's batch (pkg/col/coldata/batch.go:30) is a set of typed
column vectors plus an optional selection vector of live row indices.
As in the JAX package, filters here narrow a boolean ``sel`` mask
instead of compacting, and every column carries a boolean validity
mask (NULL handling, coldata/nulls.go). All tensors share the leading
dimension ``n`` and the batch's device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch


@dataclass
class ColumnBatch:
    """A fixed-length slab of columns + selection mask.

    data:  tuple of tensors, each shape (n,)
    valid: tuple of bool tensors shape (n,), True = non-NULL
    sel:   bool tensor shape (n,), True = row is live
    names: tuple of column names
    """

    data: tuple
    valid: tuple
    sel: torch.Tensor
    names: tuple

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_dict(cols: Mapping[str, torch.Tensor],
                  valid: Mapping[str, torch.Tensor] | None = None,
                  sel: torch.Tensor | None = None) -> "ColumnBatch":
        names = tuple(cols.keys())
        data = tuple(cols[c] for c in names)
        if not data:
            raise ValueError("ColumnBatch needs at least one column")
        n = data[0].shape[0]
        dev = data[0].device
        valid = valid or {}
        vmasks = tuple(
            valid[c].to(torch.bool) if c in valid
            else torch.ones(n, dtype=torch.bool, device=dev)
            for c in names)
        if sel is None:
            sel = torch.ones(n, dtype=torch.bool, device=dev)
        return ColumnBatch(data=data, valid=vmasks, sel=sel, names=names)

    # -- accessors ---------------------------------------------------------
    @property
    def n(self) -> int:
        return self.data[0].shape[0]

    @property
    def device(self) -> torch.device:
        return self.sel.device

    def index(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise KeyError(
                f"column {name!r} not in batch {self.names}") from None

    def col(self, name: str) -> torch.Tensor:
        return self.data[self.index(name)]

    def col_valid(self, name: str) -> torch.Tensor:
        return self.valid[self.index(name)]

    def has(self, name: str) -> bool:
        return name in self.names

    # -- functional updates ------------------------------------------------
    def with_sel(self, sel: torch.Tensor) -> "ColumnBatch":
        return ColumnBatch(self.data, self.valid, sel, self.names)

    def and_sel(self, mask: torch.Tensor) -> "ColumnBatch":
        """Apply a filter: narrow the selection (the reference's filter
        ops produce selection vectors the same way, colexecsel)."""
        return self.with_sel(torch.logical_and(self.sel, mask))

    def with_column(self, name: str, data: torch.Tensor,
                    valid: torch.Tensor | None = None) -> "ColumnBatch":
        """Add or replace a column (projection output)."""
        if valid is None:
            valid = torch.ones(self.n, dtype=torch.bool, device=self.device)
        if name in self.names:
            i = self.index(name)
            datas = list(self.data)
            valids = list(self.valid)
            datas[i] = data
            valids[i] = valid
            return ColumnBatch(tuple(datas), tuple(valids), self.sel,
                               self.names)
        return ColumnBatch(self.data + (data,), self.valid + (valid,),
                           self.sel, self.names + (name,))

    def __repr__(self) -> str:
        return f"ColumnBatch(n={self.n}, cols={list(self.names)})"


# -- device -> host ----------------------------------------------------------

def pull_arrays(arrs: list) -> list[np.ndarray]:
    """Copy tensors to host numpy arrays (numpy inputs pass through)."""
    return [a if isinstance(a, np.ndarray)
            else a.detach().to("cpu").numpy() for a in arrs]


def pull_batch_columns(batch: ColumnBatch, names: list):
    """The LIVE rows of the named columns as host arrays:
    {name: (data, valid)}. The live rows are gathered on the device,
    so the copy moves live bytes only."""
    live = torch.nonzero(batch.sel, as_tuple=True)[0]
    datas = [batch.col(c).index_select(0, live) for c in names]
    valids = [batch.col_valid(c).index_select(0, live) for c in names]
    pulled = pull_arrays(datas + valids)
    k = len(names)
    return {c: (pulled[i], pulled[k + i]) for i, c in enumerate(names)}


def concat(batches: list[ColumnBatch]) -> ColumnBatch:
    """Concatenate batches with identical schemas along rows."""
    first = batches[0]
    data = tuple(torch.cat([b.data[i] for b in batches])
                 for i in range(len(first.names)))
    valid = tuple(torch.cat([b.valid[i] for b in batches])
                  for i in range(len(first.names)))
    sel = torch.cat([b.sel for b in batches])
    return ColumnBatch(data, valid, sel, first.names)


def pad_to(batch: ColumnBatch, n: int) -> ColumnBatch:
    """Pad a batch to ``n`` rows with dead rows (sel False, zero data,
    NULL validity)."""
    cur = batch.n
    if cur == n:
        return batch
    if cur > n:
        raise ValueError(f"batch of {cur} rows cannot pad to {n}")

    def padarr(a):
        return torch.cat([a, torch.zeros((n - cur,) + tuple(a.shape[1:]),
                                         dtype=a.dtype, device=a.device)])

    return ColumnBatch(tuple(padarr(d) for d in batch.data),
                       tuple(padarr(v) for v in batch.valid),
                       padarr(batch.sel), batch.names)
