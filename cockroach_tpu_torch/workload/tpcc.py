"""TPC-C workload: the OLTP benchmark the reference gates releases on.

The analogue of pkg/workload/tpcc (tpcc.go): the full 9-table schema
at configurable (scaled-down) cardinalities and all five spec
transactions — NEW-ORDER (45%), PAYMENT (43%), ORDER-STATUS,
DELIVERY and STOCK-LEVEL (4% each) — implemented as real
multi-statement SQL transactions through the engine's txn layer
(BEGIN..COMMIT, retry on 40001), per TPC-C v5.11 clause 2.

Scaled defaults (items/customers per district) keep CI-sized runs
fast; the ratios and the per-txn read/write shapes match the spec, so
contention behavior is representative.

The port's copy of cockroach_tpu/workload/tpcc.py.
"""

from __future__ import annotations

import numpy as np

DDL = {
    "warehouse": """CREATE TABLE warehouse (
        w_id INT PRIMARY KEY, w_name STRING, w_city STRING,
        w_tax DECIMAL(4,4), w_ytd DECIMAL(12,2))""",
    "district": """CREATE TABLE district (
        d_id INT, d_w_id INT, d_name STRING, d_city STRING,
        d_tax DECIMAL(4,4), d_ytd DECIMAL(12,2), d_next_o_id INT,
        PRIMARY KEY (d_w_id, d_id))""",
    "customer": """CREATE TABLE customer (
        c_id INT, c_d_id INT, c_w_id INT, c_last STRING,
        c_credit STRING, c_balance DECIMAL(12,2),
        c_ytd_payment DECIMAL(12,2), c_payment_cnt INT,
        PRIMARY KEY (c_w_id, c_d_id, c_id))""",
    "item": """CREATE TABLE item (
        i_id INT PRIMARY KEY, i_name STRING, i_price DECIMAL(5,2),
        i_data STRING)""",
    "stock": """CREATE TABLE stock (
        s_i_id INT, s_w_id INT, s_quantity INT,
        s_ytd INT, s_order_cnt INT, s_remote_cnt INT,
        PRIMARY KEY (s_w_id, s_i_id))""",
    "orders": """CREATE TABLE orders (
        o_id INT, o_d_id INT, o_w_id INT, o_c_id INT,
        o_entry_d TIMESTAMP, o_carrier_id INT, o_ol_cnt INT,
        o_all_local INT,
        PRIMARY KEY (o_w_id, o_d_id, o_id))""",
    "new_order": """CREATE TABLE new_order (
        no_o_id INT, no_d_id INT, no_w_id INT,
        PRIMARY KEY (no_w_id, no_d_id, no_o_id))""",
    "order_line": """CREATE TABLE order_line (
        ol_o_id INT, ol_d_id INT, ol_w_id INT, ol_number INT,
        ol_i_id INT, ol_quantity INT, ol_amount DECIMAL(6,2),
        PRIMARY KEY (ol_w_id, ol_d_id, ol_o_id, ol_number))""",
    "history": """CREATE TABLE history (
        h_c_id INT, h_c_d_id INT, h_c_w_id INT, h_d_id INT,
        h_w_id INT, h_amount DECIMAL(6,2))""",
}

LAST_NAMES = ["BAR", "OUGHT", "ABLE", "PRI", "PRES",
              "ESE", "ANTI", "CALLY", "ATION", "EING"]


class TPCC:
    name = "tpcc"

    def __init__(self, engine, warehouses: int = 1, districts: int = 10,
                 customers_per_district: int = 30, items: int = 100,
                 seed: int = 0):
        self.engine = engine
        self.W = warehouses
        self.D = districts
        self.C = customers_per_district
        self.I = items
        self.rng = np.random.default_rng(seed)
        self.new_orders = 0
        self.payments = 0
        self.order_statuses = 0
        self.deliveries = 0
        self.stock_levels = 0
        self.retries = 0

    # -- load ---------------------------------------------------------------
    def setup(self) -> None:
        e = self.engine
        rng = self.rng
        for ddl in DDL.values():
            e.execute(ddl)
        e.execute("INSERT INTO warehouse VALUES " + ", ".join(
            f"({w}, 'wh{w}', 'city{w % 5}', "
            f"{(w % 2000) / 10000:.4f}, 0.00)"
            for w in range(1, self.W + 1)))
        e.execute("INSERT INTO district VALUES " + ", ".join(
            f"({d}, {w}, 'd{d}', 'city{d % 5}', 0.0500, 0.00, 1)"
            for w in range(1, self.W + 1)
            for d in range(1, self.D + 1)))
        e.execute("INSERT INTO customer VALUES " + ", ".join(
            f"({c}, {d}, {w}, "
            f"'{LAST_NAMES[c % 10]}{LAST_NAMES[(c // 10) % 10]}', "
            f"'{'GC' if rng.random() < 0.9 else 'BC'}', "
            f"-10.00, 10.00, 1)"
            for w in range(1, self.W + 1)
            for d in range(1, self.D + 1)
            for c in range(1, self.C + 1)))
        e.execute("INSERT INTO item VALUES " + ", ".join(
            f"({i}, 'item{i}', {float(rng.integers(100, 10000)) / 100:.2f}, "
            f"'data{i}')"
            for i in range(1, self.I + 1)))
        e.execute("INSERT INTO stock VALUES " + ", ".join(
            f"({i}, {w}, {int(rng.integers(10, 101))}, 0, 0, 0)"
            for w in range(1, self.W + 1)
            for i in range(1, self.I + 1)))

    # -- transactions -------------------------------------------------------
    def _txn(self, fn):
        """Run fn(session) inside BEGIN..COMMIT with 40001 retries."""
        e = self.engine
        for _ in range(10):
            s = e.session()
            e.execute("BEGIN", session=s)
            try:
                out = fn(s)
                e.execute("COMMIT", session=s)
                return out
            except Exception as ex:
                try:
                    e.execute("ROLLBACK", session=s)
                except Exception:
                    pass
                if "restart transaction" in str(ex) or \
                        "retry" in str(ex).lower():
                    self.retries += 1
                    continue
                raise
        raise RuntimeError("txn retry budget exhausted")

    def new_order(self, w: int | None = None) -> int:
        """TPC-C 2.4: order entry — the throughput metric (tpmC)."""
        rng = self.rng
        w = w or int(rng.integers(1, self.W + 1))
        d = int(rng.integers(1, self.D + 1))
        c = int(rng.integers(1, self.C + 1))
        ol_cnt = int(rng.integers(5, 16))
        lines = [(int(rng.integers(1, self.I + 1)),
                  int(rng.integers(1, 11))) for _ in range(ol_cnt)]

        def fn(s):
            e = self.engine
            o_id = e.execute(
                f"SELECT d_next_o_id FROM district WHERE d_w_id = {w} "
                f"AND d_id = {d}", session=s).rows[0][0]
            e.execute(f"UPDATE district SET d_next_o_id = {o_id + 1} "
                      f"WHERE d_w_id = {w} AND d_id = {d}", session=s)
            e.execute(
                f"INSERT INTO orders VALUES ({o_id}, {d}, {w}, {c}, "
                f"timestamp '2026-01-01 00:00:00', NULL, {ol_cnt}, 1)",
                session=s)
            e.execute(f"INSERT INTO new_order VALUES ({o_id}, {d}, {w})",
                      session=s)
            for n, (i_id, qty) in enumerate(lines, 1):
                price = e.execute(
                    f"SELECT i_price FROM item WHERE i_id = {i_id}",
                    session=s).rows[0][0]
                squty = e.execute(
                    f"SELECT s_quantity FROM stock WHERE s_w_id = {w} "
                    f"AND s_i_id = {i_id}", session=s).rows[0][0]
                new_q = squty - qty if squty - qty >= 10 else \
                    squty - qty + 91
                e.execute(
                    f"UPDATE stock SET s_quantity = {new_q}, "
                    f"s_ytd = s_ytd + {qty}, "
                    f"s_order_cnt = s_order_cnt + 1 "
                    f"WHERE s_w_id = {w} AND s_i_id = {i_id}",
                    session=s)
                amount = float(price) * qty
                e.execute(
                    f"INSERT INTO order_line VALUES ({o_id}, {d}, {w}, "
                    f"{n}, {i_id}, {qty}, {amount:.2f})", session=s)
            return o_id

        o_id = self._txn(fn)
        self.new_orders += 1
        return o_id

    def payment(self) -> None:
        """TPC-C 2.5: payment against warehouse/district/customer."""
        rng = self.rng
        w = int(rng.integers(1, self.W + 1))
        d = int(rng.integers(1, self.D + 1))
        c = int(rng.integers(1, self.C + 1))
        amount = float(rng.integers(100, 500000)) / 100

        def fn(s):
            e = self.engine
            e.execute(f"UPDATE warehouse SET w_ytd = w_ytd + {amount} "
                      f"WHERE w_id = {w}", session=s)
            e.execute(f"UPDATE district SET d_ytd = d_ytd + {amount} "
                      f"WHERE d_w_id = {w} AND d_id = {d}", session=s)
            e.execute(
                f"UPDATE customer SET c_balance = c_balance - {amount}, "
                f"c_ytd_payment = c_ytd_payment + {amount}, "
                f"c_payment_cnt = c_payment_cnt + 1 "
                f"WHERE c_w_id = {w} AND c_d_id = {d} AND c_id = {c}",
                session=s)
            e.execute(
                f"INSERT INTO history VALUES ({c}, {d}, {w}, {d}, {w}, "
                f"{amount:.2f})", session=s)

        self._txn(fn)
        self.payments += 1

    def order_status(self) -> list:
        """TPC-C 2.6: read-only — a customer's most recent order."""
        rng = self.rng
        w = int(rng.integers(1, self.W + 1))
        d = int(rng.integers(1, self.D + 1))
        c = int(rng.integers(1, self.C + 1))
        e = self.engine
        rows = e.execute(
            f"SELECT o_id, o_ol_cnt FROM orders WHERE o_w_id = {w} "
            f"AND o_d_id = {d} AND o_c_id = {c} "
            f"ORDER BY o_id DESC LIMIT 1").rows
        self.order_statuses += 1
        if not rows:
            return []
        o_id = rows[0][0]
        return e.execute(
            f"SELECT ol_i_id, ol_quantity, ol_amount FROM order_line "
            f"WHERE ol_w_id = {w} AND ol_d_id = {d} "
            f"AND ol_o_id = {o_id} ORDER BY ol_number").rows

    def delivery(self, carrier: int | None = None,
                 w: int | None = None) -> int:
        """TPC-C 2.7: batch-deliver the oldest undelivered order of
        every district of one warehouse in a single transaction —
        the spec's deferred-execution txn. Returns orders delivered."""
        rng = self.rng
        w = w or int(rng.integers(1, self.W + 1))
        carrier = carrier or int(rng.integers(1, 11))

        def fn(s):
            e = self.engine
            delivered = 0
            for d in range(1, self.D + 1):
                rows = e.execute(
                    f"SELECT min(no_o_id) FROM new_order "
                    f"WHERE no_w_id = {w} AND no_d_id = {d}",
                    session=s).rows
                o_id = rows[0][0] if rows else None
                if o_id is None:
                    continue  # spec 2.7.4.2: skip empty districts
                e.execute(
                    f"DELETE FROM new_order WHERE no_w_id = {w} "
                    f"AND no_d_id = {d} AND no_o_id = {o_id}",
                    session=s)
                c = e.execute(
                    f"SELECT o_c_id FROM orders WHERE o_w_id = {w} "
                    f"AND o_d_id = {d} AND o_id = {o_id}",
                    session=s).rows[0][0]
                e.execute(
                    f"UPDATE orders SET o_carrier_id = {carrier} "
                    f"WHERE o_w_id = {w} AND o_d_id = {d} "
                    f"AND o_id = {o_id}", session=s)
                amount = e.execute(
                    f"SELECT sum(ol_amount) FROM order_line "
                    f"WHERE ol_w_id = {w} AND ol_d_id = {d} "
                    f"AND ol_o_id = {o_id}", session=s).rows[0][0]
                e.execute(
                    f"UPDATE customer SET c_balance = c_balance + "
                    f"{float(amount):.2f} WHERE c_w_id = {w} "
                    f"AND c_d_id = {d} AND c_id = {c}", session=s)
                delivered += 1
            return delivered

        out = self._txn(fn)
        self.deliveries += 1
        return out

    def stock_level(self, threshold: int | None = None,
                    d: int | None = None,
                    w: int | None = None) -> int:
        """TPC-C 2.8: read-only — distinct items among the district's
        last 20 orders whose stock sits below a threshold."""
        rng = self.rng
        w = w or int(rng.integers(1, self.W + 1))
        d = d or int(rng.integers(1, self.D + 1))
        if threshold is None:
            threshold = int(rng.integers(10, 21))
        e = self.engine
        next_o = e.execute(
            f"SELECT d_next_o_id FROM district WHERE d_w_id = {w} "
            f"AND d_id = {d}").rows[0][0]
        n = e.execute(
            f"SELECT count(DISTINCT s_i_id) FROM order_line "
            f"JOIN stock ON s_w_id = ol_w_id AND s_i_id = ol_i_id "
            f"WHERE ol_w_id = {w} AND ol_d_id = {d} "
            f"AND ol_o_id >= {next_o - 20} AND ol_o_id < {next_o} "
            f"AND s_quantity < {threshold}").rows[0][0]
        self.stock_levels += 1
        return int(n or 0)

    # -- the mix ------------------------------------------------------------
    def step(self) -> str:
        """Full five-transaction mix at the spec's minimum weights:
        NEW-ORDER 45%, PAYMENT 43%, ORDER-STATUS/DELIVERY/STOCK-LEVEL
        4% each (tpcc.go uses the same deck weights)."""
        r = self.rng.random()
        if r < 0.45:
            self.new_order()
            return "new_order"
        if r < 0.88:
            self.payment()
            return "payment"
        if r < 0.92:
            self.order_status()
            return "order_status"
        if r < 0.96:
            self.delivery()
            return "delivery"
        self.stock_level()
        return "stock_level"

    def run(self, steps: int = 50) -> dict:
        """Drive the mix; counters in the result are deltas for THIS
        run (the instance counters stay cumulative), so a warmup pass
        before a measured pass doesn't inflate tpm_c."""
        import time
        before = (self.new_orders, self.payments, self.order_statuses,
                  self.deliveries, self.stock_levels, self.retries)
        t0 = time.monotonic()
        for _ in range(steps):
            self.step()
        dt = time.monotonic() - t0
        no, pay, osts, dlv, stk, rty = (
            a - b for a, b in zip(
                (self.new_orders, self.payments, self.order_statuses,
                 self.deliveries, self.stock_levels, self.retries),
                before))
        return {"steps": steps, "elapsed_s": dt,
                "tpm_c": no / dt * 60 if dt else 0.0,
                "new_orders": no,
                "payments": pay,
                "order_statuses": osts,
                "deliveries": dlv,
                "stock_levels": stk,
                "retries": rty}
