"""TPC-H workload: schemas, data generator, queries, numpy oracle.

Mirrors the reference's workload generator (pkg/workload/tpch/tpch.go:
34-39: 6,001,215 lineitem rows per SF; queries.go for query texts;
expected_rows.go for correctness). Our generator produces the TPC-H
*shape* (columns, domains, value distributions close to spec) with a
seeded RNG; correctness is gated by comparing engine results against a
direct numpy evaluation of the same arrays (the oracle below), the way
the reference cross-checks colexec against the row engine
(colexectestutils.RunTests).
"""

from __future__ import annotations

import datetime

import numpy as np

LINEITEM_PER_SF = 6_001_215  # tpch.go:39
PART_PER_SF = 200_000
SUPP_PER_SF = 10_000
ORDERS_PER_SF = 1_500_000

EPOCH = datetime.date(1970, 1, 1)


def _days(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - EPOCH).days


DDL = {
    "lineitem": """
CREATE TABLE lineitem (
    l_orderkey      INT8 NOT NULL,
    l_partkey       INT8 NOT NULL,
    l_suppkey       INT8 NOT NULL,
    l_linenumber    INT8 NOT NULL,
    l_quantity      DECIMAL(15,2) NOT NULL,
    l_extendedprice DECIMAL(15,2) NOT NULL,
    l_discount      DECIMAL(15,2) NOT NULL,
    l_tax           DECIMAL(15,2) NOT NULL,
    l_returnflag    STRING NOT NULL,
    l_linestatus    STRING NOT NULL,
    l_shipdate      DATE NOT NULL,
    l_commitdate    DATE NOT NULL,
    l_receiptdate   DATE NOT NULL,
    l_shipinstruct  STRING NOT NULL,
    l_shipmode      STRING NOT NULL
)""",
    "part": """
CREATE TABLE part (
    p_partkey     INT8 NOT NULL,
    p_name        STRING NOT NULL,
    p_mfgr        STRING NOT NULL,
    p_brand       STRING NOT NULL,
    p_type        STRING NOT NULL,
    p_size        INT8 NOT NULL,
    p_container   STRING NOT NULL,
    p_retailprice DECIMAL(15,2) NOT NULL
)""",
}

SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
SHIPINSTRUCT = ["DELIVER IN PERSON", "COLLECT COD", "NONE",
                "TAKE BACK RETURN"]
TYPES_SYL1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPES_SYL2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPES_SYL3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAINERS = ["SM CASE", "SM BOX", "MED BAG", "MED BOX", "LG CASE",
              "LG BOX", "JUMBO PACK", "WRAP JAR"]
BRANDS = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
MFGRS = [f"Manufacturer#{i}" for i in range(1, 6)]
NAMES = ["goldenrod lavender", "blush thistle", "spring green",
         "cornflower chocolate", "forest blanched", "ghost linen",
         "antique misty", "navy powder"]


RF_VALUES = ["R", "A", "N"]
LS_VALUES = ["O", "F"]

# string-column dictionaries for the encoded fast path (codes index
# into these, in this order)
LINEITEM_DICTS = {
    "l_returnflag": RF_VALUES,
    "l_linestatus": LS_VALUES,
    "l_shipinstruct": SHIPINSTRUCT,
    "l_shipmode": SHIPMODES,
}


def gen_lineitem(sf: float, seed: int = 0, rows: int | None = None,
                 encoded: bool = False) -> dict:
    """Generate lineitem columns as numpy arrays (decimals as floats —
    the columnar store scales them at ingest).

    encoded=True returns int32 dictionary codes for the string columns
    (see LINEITEM_DICTS) instead of object arrays — the only path that
    scales to SF100-class row counts (object arrays + np.unique over
    600M strings would dominate ingest)."""
    n = rows if rows is not None else int(LINEITEM_PER_SF * sf)
    rng = np.random.default_rng(seed)
    nparts = max(int(PART_PER_SF * max(sf, 0.01)), 1000)
    orderkey = np.sort(rng.integers(1, ORDERS_PER_SF * max(sf, 0.01) + 1,
                                    size=n).astype(np.int64))
    partkey = rng.integers(1, nparts + 1, size=n).astype(np.int64)
    # one of the part's 4 partsupp suppliers (the partsupp generator's
    # rule), so lineitem⋈partsupp on (partkey, suppkey) never drops rows —
    # the spec's referential guarantee
    nsupp = max(int(SUPP_PER_SF * max(sf, 0.01)), 100)
    suppkey = (partkey + rng.integers(0, 4, size=n) * 7) % nsupp + 1
    linenumber = rng.integers(1, 8, size=n).astype(np.int64)
    quantity = rng.integers(1, 51, size=n).astype(np.float64)
    # spec: extendedprice = quantity * part price; part price ~ 90000+...
    pprice = (90000 + (partkey % 200001) / 10 + 100 * (partkey % 1000)) / 100
    extendedprice = np.round(quantity * pprice, 2)
    discount = rng.integers(0, 11, size=n) / 100.0
    tax = rng.integers(0, 9, size=n) / 100.0
    shipdate = rng.integers(_days("1992-01-02"), _days("1998-12-02"),
                            size=n).astype(np.int32)
    commitdate = shipdate + rng.integers(-60, 60, size=n).astype(np.int32)
    receiptdate = shipdate + rng.integers(1, 31, size=n).astype(np.int32)
    # spec correlation with currentdate (1995-06-17): returnflag R/A if
    # receiptdate <= currentdate else N; linestatus F if shipdate <=
    # currentdate else O — yields the canonical 4 groups (A/F, N/F,
    # N/O, R/F)
    cutoff = _days("1995-06-17")
    received = receiptdate <= cutoff
    # both paths draw the rf coin at the same rng stream position so
    # encoded and object datasets agree row-for-row on rf/ls
    coin = rng.random(n) < 0.5
    if encoded:
        # codes into LINEITEM_DICTS (R=0, A=1, N=2; O=0, F=1)
        rf = np.where(received, np.where(coin, 0, 1), 2).astype(np.int32)
        ls = np.where(shipdate > cutoff, 0, 1).astype(np.int32)
        si = rng.integers(0, len(SHIPINSTRUCT), size=n).astype(np.int32)
        sm = rng.integers(0, len(SHIPMODES), size=n).astype(np.int32)
    else:
        rf = np.where(received,
                      np.where(coin, "R", "A"), "N").astype(object)
        ls = np.where(shipdate > cutoff, "O", "F").astype(object)
        si = rng.choice(SHIPINSTRUCT, size=n).astype(object)
        sm = rng.choice(SHIPMODES, size=n).astype(object)
    return {
        "l_orderkey": orderkey,
        "l_partkey": partkey,
        "l_suppkey": suppkey,
        "l_linenumber": linenumber,
        "l_quantity": quantity,
        "l_extendedprice": extendedprice,
        "l_discount": discount,
        "l_tax": tax,
        "l_returnflag": rf,
        "l_linestatus": ls,
        "l_shipdate": shipdate,
        "l_commitdate": commitdate,
        "l_receiptdate": receiptdate,
        "l_shipinstruct": si,
        "l_shipmode": sm,
    }


def gen_part(sf: float, seed: int = 1, rows: int | None = None) -> dict:
    n = rows if rows is not None else max(int(PART_PER_SF * max(sf, 0.01)),
                                          1000)
    rng = np.random.default_rng(seed)
    partkey = np.arange(1, n + 1, dtype=np.int64)
    t1 = rng.choice(TYPES_SYL1, size=n)
    t2 = rng.choice(TYPES_SYL2, size=n)
    t3 = rng.choice(TYPES_SYL3, size=n)
    ptype = np.array([f"{a} {b} {c}" for a, b, c in zip(t1, t2, t3)],
                     dtype=object)
    price = np.round((90000 + (partkey % 200001) / 10
                      + 100 * (partkey % 1000)) / 100, 2)
    return {
        "p_partkey": partkey,
        "p_name": rng.choice(NAMES, size=n).astype(object),
        "p_mfgr": rng.choice(MFGRS, size=n).astype(object),
        "p_brand": rng.choice(BRANDS, size=n).astype(object),
        "p_type": ptype,
        "p_size": rng.integers(1, 51, size=n).astype(np.int64),
        "p_container": rng.choice(CONTAINERS, size=n).astype(object),
        "p_retailprice": price,
    }


def load(engine, sf: float, seed: int = 0, tables=("lineitem", "part"),
         rows: int | None = None, encoded: bool = False) -> None:
    """Create + bulk-ingest TPC-H tables (lineitem, part) into an Engine.

    ``rows`` caps the *lineitem* row count only (CI-speed slices);
    part always gets its full SF-proportional size so the key spaces
    stay consistent with gen_lineitem's foreign keys.
    ``encoded`` uses the pre-encoded string fast path (same numeric
    data and returnflag/linestatus values as the object path for a
    given seed, so the numpy oracles still agree)."""
    ts = engine.clock.now()
    for t in tables:
        engine.execute(DDL[t])
        if t == "lineitem":
            if encoded:
                for cn, vals in LINEITEM_DICTS.items():
                    engine.store.set_dictionary(t, cn, vals)
            cols = gen_lineitem(sf, seed=seed, rows=rows, encoded=encoded)
        else:
            cols = gen_part(sf)
        engine.store.insert_columns(t, cols, ts)
        # column stats feed the planner (sql/stats.py), as after the
        # reference's own loads
        engine.execute(f"ANALYZE {t}")


# ---------------------------------------------------------------------------
# queries (texts follow pkg/workload/tpch/queries.go)
# ---------------------------------------------------------------------------

Q1 = """
SELECT
    l_returnflag,
    l_linestatus,
    sum(l_quantity) AS sum_qty,
    sum(l_extendedprice) AS sum_base_price,
    sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
    sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
    avg(l_quantity) AS avg_qty,
    avg(l_extendedprice) AS avg_price,
    avg(l_discount) AS avg_disc,
    count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= date '1998-12-01' - interval '90 day'
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""

Q6 = """
SELECT sum(l_extendedprice * l_discount) AS revenue
FROM lineitem
WHERE l_shipdate >= date '1994-01-01'
  AND l_shipdate < date '1994-01-01' + interval '1 year'
  AND l_discount BETWEEN 0.06 - 0.01 AND 0.06 + 0.01
  AND l_quantity < 24
"""

Q14 = """
SELECT 100.00 * sum(CASE WHEN p_type LIKE 'PROMO%%'
                         THEN l_extendedprice * (1 - l_discount)
                         ELSE 0 END)
       / sum(l_extendedprice * (1 - l_discount)) AS promo_revenue
FROM lineitem, part
WHERE l_partkey = p_partkey
  AND l_shipdate >= date '1995-09-01'
  AND l_shipdate < date '1995-09-01' + interval '1 month'
""".replace("%%", "%")

# Q1 and Q6 with every aggregate argument cast to FLOAT8: the shapes
# that reach the small-G kernel under SET pallas_groupagg = on (its f32
# envelope admits FLOAT value aggregates only). They keep Q1's and Q6's
# answers, so ref_q1 and ref_q6 are their oracles.
Q1F = """
SELECT
    l_returnflag,
    l_linestatus,
    sum(l_quantity::FLOAT8) AS sum_qty,
    sum(l_extendedprice::FLOAT8) AS sum_base_price,
    sum((l_extendedprice * (1 - l_discount))::FLOAT8) AS sum_disc_price,
    sum((l_extendedprice * (1 - l_discount) * (1 + l_tax))::FLOAT8)
        AS sum_charge,
    avg(l_quantity::FLOAT8) AS avg_qty,
    avg(l_extendedprice::FLOAT8) AS avg_price,
    avg(l_discount::FLOAT8) AS avg_disc,
    count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= date '1998-12-01' - interval '90 day'
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""

Q6F = """
SELECT sum((l_extendedprice * l_discount)::FLOAT8) AS revenue
FROM lineitem
WHERE l_shipdate >= date '1994-01-01'
  AND l_shipdate < date '1994-01-01' + interval '1 year'
  AND l_discount BETWEEN 0.06 - 0.01 AND 0.06 + 0.01
  AND l_quantity < 24
"""


# ---------------------------------------------------------------------------
# numpy oracle (row-engine stand-in for cross-checking, cf. §4.6)
# ---------------------------------------------------------------------------

def ref_q1(li: dict) -> list[tuple]:
    mask = li["l_shipdate"] <= _days("1998-12-01") - 90
    keys = sorted(set(zip(li["l_returnflag"][mask], li["l_linestatus"][mask])))
    out = []
    for rf, ls in keys:
        m = mask & (li["l_returnflag"] == rf) & (li["l_linestatus"] == ls)
        q = li["l_quantity"][m]
        ep = li["l_extendedprice"][m]
        dc = li["l_discount"][m]
        tx = li["l_tax"][m]
        disc_price = ep * (1 - dc)
        charge = disc_price * (1 + tx)
        out.append((rf, ls, q.sum(), ep.sum(), disc_price.sum(),
                    charge.sum(), q.mean(), ep.mean(), dc.mean(),
                    int(m.sum())))
    return out


def ref_q6(li: dict) -> float:
    d0, d1 = _days("1994-01-01"), _days("1995-01-01")
    m = ((li["l_shipdate"] >= d0) & (li["l_shipdate"] < d1)
         & (li["l_discount"] >= 0.05) & (li["l_discount"] <= 0.07)
         & (li["l_quantity"] < 24))
    return float((li["l_extendedprice"][m] * li["l_discount"][m]).sum())


def ref_q14(li: dict, part: dict) -> float:
    d0, d1 = _days("1995-09-01"), _days("1995-10-01")
    m = (li["l_shipdate"] >= d0) & (li["l_shipdate"] < d1)
    ptype = np.empty(int(part["p_partkey"].max()) + 1, dtype=object)
    ptype[part["p_partkey"]] = part["p_type"]
    types = ptype[li["l_partkey"][m]]
    promo = np.array([t is not None and t.startswith("PROMO")
                      for t in types])
    rev = (li["l_extendedprice"][m] * (1 - li["l_discount"][m]))
    return float(100.0 * rev[promo].sum() / rev.sum())
