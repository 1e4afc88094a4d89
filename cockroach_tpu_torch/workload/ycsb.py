"""YCSB core workloads A-F against the SQL engine.

The port of cockroach_tpu/workload/ycsb.py (pkg/workload/ycsb/ycsb.go):
a usertable of (key, fields), zipfian-or-uniform key selection,
per-workload operation mixes:

  A: 50% read / 50% update        D: 95% read / 5% insert (latest)
  B: 95% read / 5% update         E: 95% scan / 5% insert
  C: 100% read                    F: 50% read / 50% read-modify-write

``setup`` loads the records through INSERT statements of at most
``load_batch`` rows each. ``run_concurrent`` runs N drivers over one
engine on threads of their own (the reference's ``--concurrency``).
Every driver logs the field0 value each of its writes gave a key
(``writes``), so a concurrent run's final table can be held to what
some driver wrote.
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
        # the same by operation kind
        self.op_latencies: dict = {op: [] for op in self.ops}
        self.writes: list = []         # (key, field0) of every write
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
            v = int(self.rng.integers(0, 1000))
            self._write_retry(f"UPDATE usertable SET field0 = "
                              f"{v} WHERE ycsb_key = {k}")
            self.writes.append((k, v))
        elif op == "insert":
            self._write_retry(f"INSERT INTO usertable VALUES "
                              f"({self.next_key}, 0, 0)")
            self.writes.append((self.next_key, 0))
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
            self.writes.append((k, v))
        if self.record_latency:
            dt = time.perf_counter() - t0
            self.latencies.append(dt)
            self.op_latencies[op].append(dt)
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

    def run_concurrent(self, steps: int = 100, workers: int = 16,
                       session_vars: dict | None = None,
                       record_latency: bool = False,
                       timeout: float = 600.0,
                       insert_base: int | None = None) -> dict:
        """N concurrent drivers over one engine, each with its own
        worker object (its own RNG seeded 1000 + w, zipf and counters;
        nothing shared but the engine). Insert keyspaces are disjoint
        per worker: worker w inserts from ``insert_base`` (the record
        count by default) + (w + 1) * 10,000,000, above any key a
        sequential run inserted; a later concurrent run over the same
        table passes another base.
        ``session_vars`` gives every driver its own Session with those
        variables set (the ``oltp_batch`` A/B rides this);
        ``record_latency`` adds p50/p99 milliseconds, overall and per
        operation kind. A driver that has not finished within
        ``timeout`` seconds of the start raises (a deadlock must fail,
        not hang). The drivers stay in ``self.drivers`` (their
        ``writes`` logs)."""
        import threading
        import time

        from ..exec.session import Session

        per = max(steps // workers, 1)
        drivers = []
        for w in range(workers):
            session = None
            if session_vars is not None:
                session = Session()
                for k, v in session_vars.items():
                    session.vars.set(k, v)
            d = YCSB(self.engine, workload=self.workload,
                     records=self.records, seed=1000 + w,
                     distribution=self.distribution,
                     scan_limit=self.scan_limit, session=session,
                     record_latency=record_latency)
            d.next_key = (self.records if insert_base is None
                          else insert_base) + (w + 1) * 10_000_000
            drivers.append(d)
        self.drivers = drivers
        errors: list = []

        def drive(d):
            try:
                for _ in range(per):
                    d.step()
            except Exception as exc:
                errors.append(exc)

        threads = [threading.Thread(target=drive, args=(d,), daemon=True)
                   for d in drivers]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(max(0.0, t0 + timeout - time.monotonic()))
        dt = time.monotonic() - t0
        stuck = sum(t.is_alive() for t in threads)
        if stuck:
            raise TimeoutError(f"{stuck} of {workers} YCSB drivers did "
                               f"not finish within {timeout} s")
        if errors:
            raise errors[0]
        total = per * workers
        out = {"ops": {op: sum(d.ops[op] for d in drivers)
                       for op in self.ops},
               "seconds": dt, "workers": workers,
               "ops_per_sec": total / dt if dt > 0 else 0.0,
               "retries": sum(d.retries for d in drivers)}
        if record_latency:
            out.update(_percentiles(
                [x for d in drivers for x in d.latencies]))
            for op in self.ops:
                xs = [x for d in drivers for x in d.op_latencies[op]]
                if xs:
                    out[op] = _percentiles(xs)
        return out


def _percentiles(xs: list) -> dict:
    """p50/p99 milliseconds of a list of seconds."""
    xs = sorted(xs)
    if not xs:
        return {}
    return {"p50_ms": xs[len(xs) // 2] * 1e3,
            "p99_ms": xs[min(len(xs) - 1, int(len(xs) * 0.99))] * 1e3}
