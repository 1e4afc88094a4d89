"""Bank workload: transfer transactions with an invariant.

The reference's bank generator (pkg/workload/bank) moves money
between accounts in explicit transactions; the total balance is a
serializability invariant — any lost/partial transfer shows up as a
changed total. Used by kvnemesis-style tests here too
(tests/test_kv_txn.py runs a lower-level variant).

The port's copy of cockroach_tpu/workload/bank.py.
"""

from __future__ import annotations

import numpy as np


class Bank:
    name = "bank"

    def __init__(self, engine, accounts: int = 100, seed: int = 0,
                 initial_balance: int = 1000):
        self.engine = engine
        self.accounts = accounts
        self.initial = initial_balance
        self.rng = np.random.default_rng(seed)
        self.transfers = 0
        self.retries = 0

    def setup(self) -> None:
        e = self.engine
        e.execute("CREATE TABLE bank (id INT8 NOT NULL PRIMARY KEY, "
                  "balance INT8 NOT NULL)")
        vals = ", ".join(f"({i}, {self.initial})"
                         for i in range(self.accounts))
        e.execute(f"INSERT INTO bank VALUES {vals}")

    def total(self) -> int:
        return self.engine.execute(
            "SELECT sum(balance) AS s FROM bank").rows[0][0]

    def step(self, session=None) -> None:
        """One transfer txn: read two balances, move a random amount."""
        e = self.engine
        s = session or e.session()
        a, b = self.rng.choice(self.accounts, size=2, replace=False)
        amt = int(self.rng.integers(1, 100))
        for _ in range(5):
            try:
                e.execute("BEGIN", s)
                bal_a = e.execute(
                    f"SELECT balance FROM bank WHERE id = {a}", s).rows[0][0]
                e.execute(f"UPDATE bank SET balance = {bal_a - amt} "
                          f"WHERE id = {a}", s)
                bal_b = e.execute(
                    f"SELECT balance FROM bank WHERE id = {b}", s).rows[0][0]
                e.execute(f"UPDATE bank SET balance = {bal_b + amt} "
                          f"WHERE id = {b}", s)
                e.execute("COMMIT", s)
                self.transfers += 1
                return
            except Exception:
                try:
                    e.execute("ROLLBACK", s)
                except Exception:
                    pass
                self.retries += 1
        # give up on this transfer after retries (contention)

    def run(self, steps: int = 100) -> dict:
        for _ in range(steps):
            self.step()
        return {"transfers": self.transfers, "retries": self.retries,
                "total": self.total()}

    def check(self) -> bool:
        """The invariant: money is conserved."""
        return self.total() == self.accounts * self.initial
