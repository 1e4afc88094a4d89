"""YCSB core workloads A-F against the SQL engine.

The port of cockroach_tpu/workload/ycsb.py (pkg/workload/ycsb/ycsb.go):
a usertable of (key, fields), zipfian-or-uniform key selection,
per-workload operation mixes:

  A: 50% read / 50% update        D: 95% read / 5% insert (latest)
  B: 95% read / 5% update         E: 95% scan / 5% insert
  C: 100% read                    F: 50% read / 50% read-modify-write

``setup`` loads the records through INSERT statements of at most
``load_batch`` rows each. The reference's multi-threaded
``run_concurrent`` waits for the engine's statement gate.
"""

from __future__ import annotations

import numpy as np

MIXES = {
    "A": {"read": 0.5, "update": 0.5},
    "B": {"read": 0.95, "update": 0.05},
    "C": {"read": 1.0},
    "D": {"read": 0.95, "insert": 0.05},
    "E": {"scan": 0.95, "insert": 0.05},
    "F": {"read": 0.5, "rmw": 0.5},
}


class _CdfSampler:
    """Batched inverse-CDF sampler: rng.choice(p=...) rebuilds the
    distribution per draw (O(n)); searchsorted over a buffered
    uniform block is ~100x cheaper and was 14% of measured YCSB-E op
    latency."""

    def __init__(self, weights, rng, batch: int = 4096):
        self.rng = rng
        w = np.asarray(weights, dtype=np.float64)
        self.cdf = np.cumsum(w / w.sum())
        self.n = len(w)
        self.batch = batch
        self._buf: list = []

    def sample(self) -> int:
        if not self._buf:
            u = self.rng.random(self.batch)
            self._buf = np.minimum(
                np.searchsorted(self.cdf, u), self.n - 1).tolist()
        return int(self._buf.pop())


class _Zipf(_CdfSampler):
    """Bounded zipfian sampler (the YCSB ScrambledZipfian without the
    scramble; theta 0.99 like the spec)."""

    def __init__(self, n: int, rng, theta: float = 0.99):
        ranks = np.arange(1, n + 1, dtype=np.float64)
        super().__init__(1.0 / np.power(ranks, theta), rng)


class YCSB:
    name = "ycsb"

    def __init__(self, engine, workload: str = "A", records: int = 1000,
                 seed: int = 0, distribution: str = "zipfian",
                 scan_limit: int = 10, session=None,
                 record_latency: bool = False):
        if workload not in MIXES:
            raise ValueError(f"unknown YCSB workload {workload!r}")
        self.engine = engine
        self.mix = MIXES[workload]
        self.workload = workload
        self.records = records
        self.rng = np.random.default_rng(seed)
        self.distribution = distribution
        self.zipf = (_Zipf(records, self.rng)
                     if distribution == "zipfian" else None)
        self.scan_limit = scan_limit
        self.next_key = records
        self.ops = {op: 0 for op in
                    ("read", "update", "insert", "scan", "rmw")}
        self.retries = 0               # client-side txn restarts
        # each instance is one client session: its session vars ride
        # with it into every statement
        self.session = session
        self.record_latency = record_latency
        self.latencies: list = []      # per-step seconds when enabled
        # hoisted: the mix is fixed, don't rebuild per step
        self._op_names, op_probs = zip(*self.mix.items())
        self._op_sampler = _CdfSampler(op_probs, self.rng, batch=1024)

    def setup(self, load_batch: int = 10_000) -> None:
        e = self.engine
        e.execute("CREATE TABLE usertable (ycsb_key INT8 NOT NULL "
                  "PRIMARY KEY, field0 INT8, field1 INT8)")
        for lo in range(0, self.records, load_batch):
            vals = ", ".join(
                f"({i}, {i * 7 % 1000}, {i * 13 % 1000})"
                for i in range(lo, min(lo + load_batch, self.records)))
            e.execute(f"INSERT INTO usertable VALUES {vals}")

    def _key(self) -> int:
        if self.workload == "D":
            # "latest" distribution: reads skew toward recently
            # inserted keys (ycsb.go's latestGenerator) — zipfian over
            # the DISTANCE from the newest key, over the live keyspace
            off = (self.zipf.sample() if self.zipf is not None
                   else int(self.rng.integers(0, self.records)))
            return max(0, self.next_key - 1 - (off % self.next_key))
        if self.zipf is not None:
            return self.zipf.sample()
        return int(self.rng.integers(0, self.records))

    def _write_retry(self, sql: str):
        """Execute a write, retrying client-side on txn restarts —
        what every YCSB client does against the reference (lib/pq
        surfaces SQLSTATE 40001, the workload retries the op). Contended
        per-statement writes restart under write-write races; retry
        time counts toward the op's recorded latency, which is the
        client-observed truth."""
        from ..exec.session import EngineError
        while True:
            try:
                return self.engine.execute(sql, self.session)
            except EngineError as exc:
                if "restart transaction" not in str(exc):
                    raise
                self.retries += 1

    def step(self) -> str:
        import time
        op = self._op_names[self._op_sampler.sample()]
        e = self.engine
        s = self.session
        k = self._key()
        t0 = time.perf_counter() if self.record_latency else 0.0
        if op == "read":
            e.execute(f"SELECT field0, field1 FROM usertable "
                      f"WHERE ycsb_key = {k}", s)
        elif op == "update":
            self._write_retry(f"UPDATE usertable SET field0 = "
                              f"{int(self.rng.integers(0, 1000))} "
                              f"WHERE ycsb_key = {k}")
        elif op == "insert":
            self._write_retry(f"INSERT INTO usertable VALUES "
                              f"({self.next_key}, 0, 0)")
            self.next_key += 1
        elif op == "scan":
            e.execute(f"SELECT ycsb_key, field0 FROM usertable "
                      f"WHERE ycsb_key >= {k} ORDER BY ycsb_key "
                      f"LIMIT {self.scan_limit}", s)
        elif op == "rmw":
            r = e.execute(f"SELECT field0 FROM usertable "
                          f"WHERE ycsb_key = {k}", s)
            v = (r.rows[0][0] or 0) + 1 if r.rows else 0
            self._write_retry(f"UPDATE usertable SET field0 = {v} "
                              f"WHERE ycsb_key = {k}")
        if self.record_latency:
            self.latencies.append(time.perf_counter() - t0)
        self.ops[op] += 1
        return op

    def run(self, steps: int = 100) -> dict:
        import time
        t0 = time.monotonic()
        for _ in range(steps):
            self.step()
        dt = time.monotonic() - t0
        return {"ops": dict(self.ops), "seconds": dt,
                "ops_per_sec": steps / dt if dt > 0 else 0.0}
