"""kv workload: raw read/write mix against the transactional KV plane.

The reference's kv generator (pkg/workload/kv) hits the KV layer with
a --read-percent mix over random keys; here it exercises kv.DB
(latches, tscache, MVCC) directly, bypassing SQL — the layer-isolation
load generator.

The port's copy of cockroach_tpu/workload/kvload.py.
"""

from __future__ import annotations

import struct

import numpy as np


class KVLoad:
    name = "kv"

    def __init__(self, db, keyspace: int = 10_000, read_percent: int = 95,
                 seed: int = 0, batch: int = 1):
        self.db = db
        self.keyspace = keyspace
        self.read_percent = read_percent
        self.rng = np.random.default_rng(seed)
        self.batch = batch
        self.reads = 0
        self.writes = 0

    def setup(self) -> None:
        pass  # keyspace is lazy

    @staticmethod
    def _key(i: int) -> bytes:
        return b"/kv/" + struct.pack(">q", i)

    def step(self) -> None:
        if self.rng.integers(0, 100) < self.read_percent:
            k = int(self.rng.integers(0, self.keyspace))
            self.db.get(self._key(k))
            self.reads += 1
        else:
            def txn(t):
                for _ in range(self.batch):
                    k = int(self.rng.integers(0, self.keyspace))
                    t.put(self._key(k),
                          struct.pack(">q", int(self.rng.integers(0, 1 << 40))))
            self.db.txn(txn)
            self.writes += 1

    def run(self, steps: int = 1000) -> dict:
        import time
        t0 = time.monotonic()
        for _ in range(steps):
            self.step()
        dt = time.monotonic() - t0
        return {"reads": self.reads, "writes": self.writes,
                "ops_per_sec": steps / dt if dt > 0 else 0.0}
