"""Invariant checks (cockroach_tpu/utils/invariants.py; the reference's
buildutil.CrdbTestBuild-gated assertion infrastructure, distilled).

`expensive_enabled()` gates O(n) structural checks — on under pytest
(tests/conftest.py sets COCKROACH_TPU_INVARIANTS=1) and off in
production. Cheap O(1) assertions stay unconditional at their call
sites. `validate_table` is the deep checker tests call directly at
interesting points (the replicated plane's `validate_replica` and
`validate_cluster` wait for that plane)."""

from __future__ import annotations

import os

import numpy as np

from ..storage.columnstore import MAX_TS_INT


def expensive_enabled() -> bool:
    return os.environ.get("COCKROACH_TPU_INVARIANTS", "") == "1"


def validate_table(store, name: str) -> None:
    """Columnstore structural invariants: every chunk's arrays agree
    on length and dtype discipline; rowids unique among live rows;
    deletion timestamps never precede write timestamps."""
    td = store.table(name)
    seen_rowids: set[int] = set()
    for ci, chunk in enumerate(td.chunks):
        n = chunk.n
        assert len(chunk.mvcc_ts) == n and len(chunk.mvcc_del) == n, \
            f"{name} chunk {ci}: mvcc arrays wrong length"
        assert len(chunk.rowid) == n, \
            f"{name} chunk {ci}: rowid array wrong length"
        for cn, arr in chunk.data.items():
            assert len(arr) == n, \
                f"{name} chunk {ci} col {cn}: data length {len(arr)}!={n}"
            assert cn in chunk.valid and len(chunk.valid[cn]) == n, \
                f"{name} chunk {ci} col {cn}: valid missing/short"
            assert chunk.valid[cn].dtype == np.bool_, \
                f"{name} chunk {ci} col {cn}: valid not bool"
        bad = chunk.mvcc_del < chunk.mvcc_ts
        assert not bad.any(), \
            f"{name} chunk {ci}: deletion before write at rows " \
            f"{np.nonzero(bad)[0][:5]}"
        for ri in range(n):
            if int(chunk.mvcc_del[ri]) == MAX_TS_INT:
                rid = int(chunk.rowid[ri])
                assert rid not in seen_rowids, \
                    f"{name}: duplicate live rowid {rid}"
                seen_rowids.add(rid)
    for col in td.schema.columns:
        if col.type.uses_dictionary:
            assert col.name in td.dictionaries, \
                f"{name}: dict-encoded column {col.name} has no dictionary"
