"""Invariant checks (cockroach_tpu/utils/invariants.py; the reference's
buildutil.CrdbTestBuild-gated assertion infrastructure, distilled).

`expensive_enabled()` gates O(n) structural checks — on under pytest
(tests/conftest.py sets COCKROACH_TPU_INVARIANTS=1) and off in
production. Cheap O(1) assertions stay unconditional at their call
sites. `validate_table` / `validate_replica` / `validate_cluster` are
the deep checkers tests call directly at interesting points."""

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


def validate_replica(rep) -> None:
    """Raft and replica invariants: applied never exceeds committed; the
    commit index never exceeds the last log index; the lease epoch is
    non-negative."""
    r = rep.raft
    assert rep.applied_index <= r.commit, \
        f"applied {rep.applied_index} > commit {r.commit}"
    assert r.commit <= r.log.last_index(), \
        f"commit {r.commit} > last log index {r.log.last_index()}"
    assert rep.lease.epoch >= 0


def validate_cluster(cluster) -> None:
    """``validate_replica`` over every replica of every live node."""
    for nid, store in cluster.stores.items():
        if nid in cluster.down:
            continue
        for rep in store.replicas.values():
            validate_replica(rep)
