"""MovR workload: the reference's demo dataset + simulation.

The analogue of pkg/workload/movr (movr.go): users, vehicles, and
rides across cities, with a simulation step that starts and ends rides
— the dataset `cockroach demo` boots with. City becomes a plain
dictionary-encoded column here (the reference uses it as a partition
key for multi-region demos; partitioning-by-locality is a later
round).

The port's copy of cockroach_tpu/workload/movr.py, with the step loop
(``run``) the other workloads have, so the CLI's ``workload movr`` runs.
"""

from __future__ import annotations

import numpy as np

CITIES = ["new york", "boston", "washington dc", "seattle",
          "san francisco", "los angeles", "amsterdam", "paris", "rome"]

VEHICLE_TYPES = ["skateboard", "bike", "scooter"]


class MovR:
    name = "movr"

    def __init__(self, engine, users: int = 50, vehicles: int = 15,
                 rides: int = 100, seed: int = 0):
        self.engine = engine
        self.n_users = users
        self.n_vehicles = vehicles
        self.n_rides = rides
        self.rng = np.random.default_rng(seed)
        self.rides_started = 0
        self.rides_ended = 0

    def setup(self) -> None:
        e = self.engine
        rng = self.rng
        e.execute("""CREATE TABLE users (
            id INT PRIMARY KEY, city STRING, name STRING)""")
        e.execute("""CREATE TABLE vehicles (
            id INT PRIMARY KEY, city STRING, type STRING,
            owner_id INT, status STRING)""")
        e.execute("""CREATE TABLE rides (
            id INT PRIMARY KEY, city STRING, rider_id INT,
            vehicle_id INT, start_time TIMESTAMP,
            end_time TIMESTAMP, revenue DECIMAL(10,2))""")
        e.execute("INSERT INTO users VALUES " + ", ".join(
            f"({i}, '{CITIES[int(rng.integers(len(CITIES)))]}', "
            f"'user{i}')" for i in range(self.n_users)))
        e.execute("INSERT INTO vehicles VALUES " + ", ".join(
            f"({i}, '{CITIES[int(rng.integers(len(CITIES)))]}', "
            f"'{VEHICLE_TYPES[int(rng.integers(3))]}', "
            f"{int(rng.integers(self.n_users))}, 'available')"
            for i in range(self.n_vehicles)))
        if self.n_rides:
            e.execute("INSERT INTO rides VALUES " + ", ".join(
                f"({i}, '{CITIES[int(rng.integers(len(CITIES)))]}', "
                f"{int(rng.integers(self.n_users))}, "
                f"{int(rng.integers(self.n_vehicles))}, "
                f"timestamp '2026-01-0{1 + int(rng.integers(9))} "
                f"0{int(rng.integers(10))}:00:00', NULL, "
                f"{float(rng.integers(100, 9900)) / 100:.2f})"
                for i in range(self.n_rides)))
        self._next_ride = self.n_rides

    # -- simulation ---------------------------------------------------------
    def start_ride(self) -> int:
        e = self.engine
        rng = self.rng
        rid = self._next_ride
        self._next_ride += 1
        v = int(rng.integers(self.n_vehicles))
        e.execute(f"UPDATE vehicles SET status = 'in_use' "
                  f"WHERE id = {v}")
        e.execute(
            f"INSERT INTO rides VALUES ({rid}, "
            f"'{CITIES[int(rng.integers(len(CITIES)))]}', "
            f"{int(rng.integers(self.n_users))}, {v}, "
            f"timestamp '2026-02-01 12:00:00', NULL, 0.00)")
        self.rides_started += 1
        return rid

    def end_ride(self, ride_id: int) -> None:
        e = self.engine
        rev = float(self.rng.integers(100, 9900)) / 100
        e.execute(
            f"UPDATE rides SET end_time = "
            f"timestamp '2026-02-01 12:30:00', revenue = {rev:.2f} "
            f"WHERE id = {ride_id}")
        self.rides_ended += 1

    def step(self) -> None:
        rid = self.start_ride()
        if self.rng.random() < 0.8:
            self.end_ride(rid)

    def run(self, steps: int = 100) -> dict:
        import time
        before = (self.rides_started, self.rides_ended)
        t0 = time.monotonic()
        for _ in range(steps):
            self.step()
        dt = time.monotonic() - t0
        started, ended = (a - b for a, b in zip(
            (self.rides_started, self.rides_ended), before))
        return {"steps": steps, "elapsed_s": dt,
                "rides_started": started, "rides_ended": ended,
                "cities": len(self.revenue_by_city())}

    # -- demo queries --------------------------------------------------------
    def revenue_by_city(self) -> list:
        return self.engine.execute(
            "SELECT city, sum(revenue) AS rev, count(*) AS rides "
            "FROM rides GROUP BY city ORDER BY city").rows

    def busiest_vehicles(self, limit: int = 5) -> list:
        return self.engine.execute(
            "SELECT vehicle_id, count(*) AS n FROM rides "
            f"GROUP BY vehicle_id ORDER BY n DESC, vehicle_id "
            f"LIMIT {limit}").rows
