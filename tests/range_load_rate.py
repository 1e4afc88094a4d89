"""Write rates through raft on both packages: the same SQL on a 3-node
in-process Cluster behind a cluster-backed Engine.

Not a test. It times, on the host's CPU, the statements that
chip_smoke.py's phase 22 sends (lineitem rows of the sf 0.01 generator
in INSERTs of 1,000 rows, then part at sf 0.01), once through the
reference package (cockroach_tpu, under JAX_PLATFORMS=cpu) and once
through the port (cockroach_tpu_torch, device="cpu"), each in its own
process, one after the other. The range plane is host code in both, so
these are host times.

Three steps a package, the first two on one cluster, the third on a
fresh one:
- ``load``: every row into one range, then lineitem's span split in 4;
- ``update``: after that split, an UPDATE of the first UPDATE_ROWS
  lineitem rows, and one of three times as many;
- ``split_first``: lineitem's span split in 4 before SPLIT_ROWS rows go
  in.

The reference's raft sends each leader's append stream again on every
success response that leaves entries unsent, stale ones included, so a
stale heartbeat response that arrives after the next proposal starts a
stream that lives as long as writes follow each other in that range;
each write then adds one. A statement's cost grows with the square of
its writes to one range once that happens (see ``raft_messages``). The
port ignores a success that does not advance the follower's match and
moves the follower's next index past what it sent (etcd's rules), so
its messages grow linearly with the writes
(tests/test_torch_raft_appends.py).

Run from the root of the repository:

    JAX_PLATFORMS=cpu python tests/range_load_rate.py

It prints one JSON line a package and one with both.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 20_000
UPDATE_ROWS = 200
SPLIT_ROWS = 2_000
PIECES = 4
BATCH = 1_000


def _modules(package: str):
    names = [f"{package}.exec.engine", f"{package}.kvserver.cluster",
             f"{package}.models.tpch", f"{package}.sql.rowenc"]
    if package == "cockroach_tpu":
        from tests.test_torch_groupagg_large import reference_modules
        return reference_modules(*names)
    return contextlib.nullcontext(
        tuple(importlib.import_module(n) for n in names))


def _cluster(mods, package: str):
    E, C, T, R = mods
    c = C.Cluster(n_nodes=3)
    c.create_range(b"\x00", b"\xff")
    c.pump_until(lambda: c.leaseholder(1) is not None)
    eng = E.Engine(cluster=c, **({"device": "cpu"}
                                 if package == "cockroach_tpu_torch"
                                 else {}))
    eng.execute(T.DDL["lineitem"])
    eng.execute(T.DDL["part"])
    codec = R.RowCodec(eng.store.table("lineitem").schema)
    return c, eng, codec


def _split(c, codec, rows: int) -> None:
    for k in range(1, PIECES):
        c.split_range(codec.key_from_pk((rows * k // PIECES,)))
    c.pump(10)


def _insert(eng, table, cols, n) -> float:
    import chip_smoke
    t0 = time.perf_counter()
    for lo in range(0, n, BATCH):
        eng.execute(chip_smoke._insert_sql(table, cols, lo,
                                           min(n, lo + BATCH)))
    return time.perf_counter() - t0


def _timed(c, fn) -> dict:
    sent = c.transport.sent
    t0 = time.perf_counter()
    fn()
    return {"seconds": time.perf_counter() - t0,
            "raft_messages": c.transport.sent - sent}


def one_package(package: str) -> dict:
    import chip_smoke
    rows, split_rows = ROWS, SPLIT_ROWS
    li, part, li_sql = chip_smoke.range_tables(rows)
    nparts = len(part["p_partkey"])
    out: dict = {"package": package, "rows": rows, "parts": nparts}
    with _modules(package) as mods:
        c, eng, codec = _cluster(mods, package)
        load = _timed(c, lambda: (_insert(eng, "lineitem", li_sql, rows),
                                  _insert(eng, "part", part, nparts)))
        load["rows_per_s"] = (rows + nparts) / load["seconds"]
        split = _timed(c, lambda: _split(c, codec, rows))
        out.update(load=load, split_after_load=split)
        upd = {}
        for n in (UPDATE_ROWS, 3 * UPDATE_ROWS):
            key = int(li["l_orderkey"][n - 1])
            hit = int((li["l_orderkey"] <= key).sum())
            r = _timed(c, lambda: eng.execute(
                "UPDATE lineitem SET l_quantity = l_quantity + 1 "
                f"WHERE l_orderkey <= {key}"))
            r.update(rows=hit, rows_per_s=hit / r["seconds"])
            upd[str(n)] = r
        out["update_after_split"] = upd
        eng.close()
        c, eng, codec = _cluster(mods, package)
        _split(c, codec, split_rows)
        first = _timed(c, lambda: _insert(eng, "lineitem", li_sql,
                                          split_rows))
        first.update(rows=split_rows,
                     rows_per_s=split_rows / first["seconds"])
        out["split_first"] = first
        eng.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("both", "cockroach_tpu",
                                          "cockroach_tpu_torch"),
                    default="both")
    args = ap.parse_args(argv)
    sys.path[:0] = [_ROOT]
    if args.package != "both":
        print(json.dumps(one_package(args.package)), flush=True)
        return 0
    both = {}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for pkg in ("cockroach_tpu", "cockroach_tpu_torch"):
        cmd = [sys.executable, os.path.abspath(__file__), "--package", pkg]
        res = subprocess.run(cmd, cwd=_ROOT, env=env, check=True,
                             capture_output=True, text=True)
        both[pkg] = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps(both[pkg]), flush=True)
    print(json.dumps({"both": both}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
