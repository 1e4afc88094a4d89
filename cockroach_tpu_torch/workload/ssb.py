"""SSB as a workload: load the star schema, run the query flights.

The port of the reference's ``SSB`` class (cockroach_tpu/workload/
ssb.py), over the generators, DDL and query texts of models/ssb.py.
"""

from __future__ import annotations

import time

from ..models.ssb import QUERIES, load


class SSB:
    """Workload-registry wrapper: load + run the query flights."""

    name = "ssb"

    def __init__(self, engine, sf: float = 0.01, seed: int = 0,
                 rows: int | None = None):
        self.engine = engine
        self.sf = sf
        self.seed = seed
        self.rows = rows
        self.data = None

    def setup(self) -> None:
        self.data = load(self.engine, self.sf, seed=self.seed,
                         rows=self.rows)

    def run(self, steps: int = 1) -> dict:
        out = {}
        for name, sql in QUERIES.items():
            t0 = time.monotonic()
            for _ in range(steps):
                r = self.engine.execute(sql)
            out[name] = {"rows": len(r.rows),
                         "seconds": (time.monotonic() - t0) / steps}
        return out
