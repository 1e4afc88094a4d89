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


NATIONS = ["ALGERIA", "ARGENTINA", "BRAZIL", "CANADA", "EGYPT",
           "ETHIOPIA", "FRANCE", "GERMANY", "INDIA", "INDONESIA",
           "IRAN", "IRAQ", "JAPAN", "JORDAN", "KENYA", "MOROCCO",
           "MOZAMBIQUE", "PERU", "CHINA", "ROMANIA", "SAUDI ARABIA",
           "VIETNAM", "RUSSIA", "UNITED KINGDOM", "UNITED STATES"]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
# nation -> region mapping per the TPC-H spec's nation table
NATION_REGION = [0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0,
                 1, 2, 3, 4, 2, 3, 3, 1]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY",
            "HOUSEHOLD"]
ORDER_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM",
                    "4-NOT SPECIFIED", "5-LOW"]

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
    "orders": """
CREATE TABLE orders (
    o_orderkey      INT8 NOT NULL,
    o_custkey       INT8 NOT NULL,
    o_orderstatus   STRING NOT NULL,
    o_totalprice    DECIMAL(15,2) NOT NULL,
    o_orderdate     DATE NOT NULL,
    o_orderpriority STRING NOT NULL,
    o_shippriority  INT8 NOT NULL
)""",
    "customer": """
CREATE TABLE customer (
    c_custkey    INT8 NOT NULL,
    c_name       STRING NOT NULL,
    c_nationkey  INT8 NOT NULL,
    c_phone      STRING NOT NULL,
    c_acctbal    DECIMAL(15,2) NOT NULL,
    c_mktsegment STRING NOT NULL
)""",
    "supplier": """
CREATE TABLE supplier (
    s_suppkey   INT8 NOT NULL,
    s_name      STRING NOT NULL,
    s_nationkey INT8 NOT NULL,
    s_acctbal   DECIMAL(15,2) NOT NULL
)""",
    "partsupp": """
CREATE TABLE partsupp (
    ps_partkey    INT8 NOT NULL,
    ps_suppkey    INT8 NOT NULL,
    ps_availqty   INT8 NOT NULL,
    ps_supplycost DECIMAL(15,2) NOT NULL
)""",
    "nation": """
CREATE TABLE nation (
    n_nationkey INT8 NOT NULL,
    n_name      STRING NOT NULL,
    n_regionkey INT8 NOT NULL
)""",
    "region": """
CREATE TABLE region (
    r_regionkey INT8 NOT NULL,
    r_name      STRING NOT NULL
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


def _n_orders(sf: float) -> int:
    return int(ORDERS_PER_SF * max(sf, 0.01))


def _n_supp(sf: float) -> int:
    return max(int(SUPP_PER_SF * max(sf, 0.01)), 100)


def _n_cust(sf: float) -> int:
    return max(int(150_000 * max(sf, 0.01)), 500)


def gen_orders(sf: float, seed: int = 2) -> dict:
    n = _n_orders(sf)
    rng = np.random.default_rng(seed)
    orderkey = np.arange(1, n + 1, dtype=np.int64)
    orderdate = rng.integers(_days("1992-01-01"), _days("1998-08-02"),
                             size=n).astype(np.int32)
    # F for 'old' orders (the spec derives status from line statuses;
    # the date split yields the same three populations)
    cutoff = _days("1995-06-17")
    status = np.where(orderdate < cutoff - 90, "F",
                      np.where(orderdate < cutoff, "P", "O")).astype(object)
    # spec 4.2.3: custkeys divisible by 3 never place orders; draw
    # uniformly over the valid keys so per-key multiplicity stays flat
    ncust = _n_cust(sf)
    m = ncust - ncust // 3  # count of keys in [1, ncust] not % 3 == 0
    idx = rng.integers(0, m, size=n).astype(np.int64)
    ck = 3 * (idx // 2) + 1 + (idx % 2)
    return {
        "o_orderkey": orderkey,
        "o_custkey": ck,
        "o_orderstatus": status,
        "o_totalprice": np.round(rng.uniform(900, 500000, size=n), 2),
        "o_orderdate": orderdate,
        "o_orderpriority": rng.choice(ORDER_PRIORITIES,
                                      size=n).astype(object),
        "o_shippriority": np.zeros(n, dtype=np.int64),
    }


def gen_customer(sf: float, seed: int = 3) -> dict:
    n = _n_cust(sf)
    rng = np.random.default_rng(seed)
    custkey = np.arange(1, n + 1, dtype=np.int64)
    return {
        "c_custkey": custkey,
        "c_name": np.array([f"Customer#{k:09d}" for k in custkey],
                           dtype=object),
        "c_nationkey": (nat := rng.integers(0, 25, size=n).astype(
            np.int64)),
        # spec 4.2.2.9: country code = nationkey + 10
        "c_phone": np.array(
            [f"{nk + 10}-{rng.integers(100, 999)}-"
             f"{rng.integers(100, 999)}-{rng.integers(1000, 9999)}"
             for nk in nat], dtype=object),
        "c_acctbal": np.round(rng.uniform(-999, 9999, size=n), 2),
        "c_mktsegment": rng.choice(SEGMENTS, size=n).astype(object),
    }


def gen_supplier(sf: float, seed: int = 4) -> dict:
    n = _n_supp(sf)
    rng = np.random.default_rng(seed)
    suppkey = np.arange(1, n + 1, dtype=np.int64)
    return {
        "s_suppkey": suppkey,
        "s_name": np.array([f"Supplier#{k:09d}" for k in suppkey],
                           dtype=object),
        "s_nationkey": rng.integers(0, 25, size=n).astype(np.int64),
        "s_acctbal": np.round(rng.uniform(-999, 9999, size=n), 2),
    }


def gen_partsupp(sf: float) -> dict:
    """4 suppliers per part, chosen by the same deterministic rule
    gen_lineitem uses, so every lineitem (partkey, suppkey) pair has a
    partsupp row, as the spec guarantees."""
    nparts = max(int(PART_PER_SF * max(sf, 0.01)), 1000)
    nsupp = _n_supp(sf)
    partkey = np.repeat(np.arange(1, nparts + 1, dtype=np.int64), 4)
    i = np.tile(np.arange(4, dtype=np.int64), nparts)
    suppkey = (partkey + i * 7) % nsupp + 1
    rng = np.random.default_rng(5)
    return {
        "ps_partkey": partkey,
        "ps_suppkey": suppkey,
        "ps_availqty": rng.integers(1, 10000,
                                    size=len(partkey)).astype(np.int64),
        "ps_supplycost": np.round(
            rng.uniform(1, 1000, size=len(partkey)), 2),
    }


def gen_nation() -> dict:
    return {
        "n_nationkey": np.arange(25, dtype=np.int64),
        "n_name": np.array(NATIONS, dtype=object),
        "n_regionkey": np.array(NATION_REGION, dtype=np.int64),
    }


def gen_region() -> dict:
    return {
        "r_regionkey": np.arange(5, dtype=np.int64),
        "r_name": np.array(REGIONS, dtype=object),
    }


ALL_TABLES = ("lineitem", "part", "orders", "customer", "supplier",
              "partsupp", "nation", "region")


def load(engine, sf: float, seed: int = 0, tables=("lineitem", "part"),
         rows: int | None = None, encoded: bool = False) -> None:
    """Create + bulk-ingest TPC-H tables into an Engine.

    ``rows`` caps the *lineitem* row count only (CI-speed slices);
    the other tables always get their full SF-proportional size so the
    key spaces stay consistent with gen_lineitem's foreign keys.
    ``encoded`` uses the pre-encoded string fast path (same numeric
    data and returnflag/linestatus values as the object path for a
    given seed, so the numpy oracles still agree)."""
    ts = engine.clock.now()
    gens = {
        "part": lambda: gen_part(sf),
        "orders": lambda: gen_orders(sf),
        "customer": lambda: gen_customer(sf),
        "supplier": lambda: gen_supplier(sf),
        "partsupp": lambda: gen_partsupp(sf),
        "nation": gen_nation,
        "region": gen_region,
    }
    for t in tables:
        engine.execute(DDL[t])
        if t == "lineitem":
            if encoded:
                for cn, vals in LINEITEM_DICTS.items():
                    engine.store.set_dictionary(t, cn, vals)
            cols = gen_lineitem(sf, seed=seed, rows=rows, encoded=encoded)
        else:
            cols = gens[t]()
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


Q3 = """
SELECT
    l_orderkey,
    sum(l_extendedprice * (1 - l_discount)) AS revenue,
    o_orderdate,
    o_shippriority
FROM customer, orders, lineitem
WHERE c_mktsegment = 'BUILDING'
  AND c_custkey = o_custkey
  AND l_orderkey = o_orderkey
  AND o_orderdate < date '1995-03-15'
  AND l_shipdate > date '1995-03-15'
GROUP BY l_orderkey, o_orderdate, o_shippriority
ORDER BY revenue DESC, o_orderdate, l_orderkey
LIMIT 10
"""

Q5 = """
SELECT n_name, sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM customer, orders, lineitem, supplier, nation, region
WHERE c_custkey = o_custkey
  AND l_orderkey = o_orderkey
  AND l_suppkey = s_suppkey
  AND c_nationkey = s_nationkey
  AND s_nationkey = n_nationkey
  AND n_regionkey = r_regionkey
  AND r_name = 'ASIA'
  AND o_orderdate >= date '1994-01-01'
  AND o_orderdate < date '1995-01-01'
GROUP BY n_name
ORDER BY revenue DESC, n_name
"""

Q12 = """
SELECT l_shipmode,
    sum(CASE WHEN o_orderpriority = '1-URGENT'
               OR o_orderpriority = '2-HIGH'
             THEN 1 ELSE 0 END) AS high_line_count,
    sum(CASE WHEN o_orderpriority <> '1-URGENT'
              AND o_orderpriority <> '2-HIGH'
             THEN 1 ELSE 0 END) AS low_line_count
FROM orders, lineitem
WHERE o_orderkey = l_orderkey
  AND l_shipmode IN ('MAIL', 'SHIP')
  AND l_commitdate < l_receiptdate
  AND l_shipdate < l_commitdate
  AND l_receiptdate >= date '1994-01-01'
  AND l_receiptdate < date '1995-01-01'
GROUP BY l_shipmode
ORDER BY l_shipmode
"""

# Q10 (returned-item reporting)
Q10 = """
SELECT c_custkey, c_name,
       sum(l_extendedprice * (1 - l_discount)) AS revenue,
       c_acctbal, n_name
FROM customer, orders, lineitem, nation
WHERE c_custkey = o_custkey
  AND l_orderkey = o_orderkey
  AND o_orderdate >= date '1993-10-01'
  AND o_orderdate < date '1994-01-01'
  AND l_returnflag = 'R'
  AND c_nationkey = n_nationkey
GROUP BY c_custkey, c_name, c_acctbal, n_name
ORDER BY revenue DESC
LIMIT 20
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


def _lookup(keys: np.ndarray, values: np.ndarray, fill=-1) -> np.ndarray:
    """key -> value as an array indexed by key (keys are small ints)."""
    out = np.full(int(keys.max()) + 1, fill, dtype=values.dtype)
    out[keys] = values
    return out


def _date(days: int) -> datetime.date:
    return datetime.date.fromordinal(EPOCH.toordinal() + int(days))


def _keyed_sums(keys: np.ndarray, values: np.ndarray):
    """(distinct keys in first-appearance order, their float sums).
    np.bincount adds each key's values in row order, as a running
    Python sum does, so the sums are bit-equal to one."""
    uniq, first = np.unique(keys, return_index=True)
    sums = np.bincount(keys, weights=values)[uniq]
    order = np.argsort(first, kind="stable")
    return uniq[order], sums[order]


def ref_q3(li, orders, cust) -> list[tuple]:
    """Q3 over numpy arrays: the rows of the reference's ref_q3."""
    building = cust["c_custkey"][cust["c_mktsegment"] == "BUILDING"]
    bset = np.zeros(int(cust["c_custkey"].max()) + 1, dtype=bool)
    bset[building] = True
    cut = _days("1995-03-15")
    om = (orders["o_orderdate"] < cut) & bset[orders["o_custkey"]]
    odate = _lookup(orders["o_orderkey"][om],
                    orders["o_orderdate"][om].astype(np.int64))
    lk = li["l_orderkey"]
    lm = (li["l_shipdate"] > cut) & (lk < odate.shape[0])
    lm[lm] = odate[lk[lm]] >= 0
    r = li["l_extendedprice"][lm] * (1 - li["l_discount"][lm])
    keys, sums = _keyed_sums(lk[lm], r)
    rows = [(int(k), float(v), _date(odate[k]), 0)
            for k, v in zip(keys, sums)]
    rows.sort(key=lambda t: (-t[1], t[2], t[0]))
    return rows[:10]


def ref_q5(li, orders, cust, supp) -> list[tuple]:
    """Q5 over numpy arrays: the rows of the reference's ref_q5."""
    asia = np.array(NATION_REGION) == 2
    d0, d1 = _days("1994-01-01"), _days("1995-01-01")
    om = (orders["o_orderdate"] >= d0) & (orders["o_orderdate"] < d1)
    o_cust = _lookup(orders["o_orderkey"][om], orders["o_custkey"][om])
    c_nat = _lookup(cust["c_custkey"], cust["c_nationkey"])
    s_nat = _lookup(supp["s_suppkey"], supp["s_nationkey"])
    lk = li["l_orderkey"]
    ck = np.full(lk.shape[0], -1, dtype=np.int64)
    inr = lk < o_cust.shape[0]
    ck[inr] = o_cust[lk[inr]]
    sn = s_nat[li["l_suppkey"]]
    m = (ck >= 0) & asia[sn]
    m[m] = c_nat[ck[m]] == sn[m]
    r = li["l_extendedprice"][m] * (1 - li["l_discount"][m])
    nats, sums = _keyed_sums(sn[m], r)
    return sorted(((NATIONS[int(n)], float(v)) for n, v in zip(nats, sums)),
                  key=lambda t: (-t[1], t[0]))


def ref_q10(li, orders, cust, nation) -> list[tuple]:
    """Q10 over numpy arrays: the rows of the reference's ref_q10, whose
    stable sort on revenue leaves ties in the order each customer's
    first returned line appears."""
    d0, d1 = _days("1993-10-01"), _days("1994-01-01")
    od = orders["o_orderdate"]
    osel = (od >= d0) & (od < d1)
    o_cust = _lookup(orders["o_orderkey"][osel], orders["o_custkey"][osel])
    rows_r = np.nonzero(li["l_returnflag"] == "R")[0]
    lk = li["l_orderkey"][rows_r]
    ck = np.full(lk.shape[0], -1, dtype=np.int64)
    inr = lk < o_cust.shape[0]
    ck[inr] = o_cust[lk[inr]]
    hit = rows_r[ck >= 0]
    r = li["l_extendedprice"][hit] * (1 - li["l_discount"][hit])
    keys, sums = _keyed_sums(ck[ck >= 0], r)
    order = np.argsort(-sums, kind="stable")[:20]
    n_name = dict(zip(nation["n_nationkey"].tolist(), nation["n_name"]))
    cidx = _lookup(cust["c_custkey"],
                   np.arange(cust["c_custkey"].shape[0], dtype=np.int64))
    out = []
    for j in order:
        k = int(keys[j])
        i = cidx[k]
        out.append((k, cust["c_name"][i], float(sums[j]),
                    round(float(cust["c_acctbal"][i]), 2),
                    n_name[int(cust["c_nationkey"][i])]))
    return out


def ref_q12(li, orders) -> list[tuple]:
    """Q12 over numpy arrays: the rows of the reference's ref_q12."""
    d0, d1 = _days("1994-01-01"), _days("1995-01-01")
    m = (np.isin(li["l_shipmode"], ["MAIL", "SHIP"])
         & (li["l_commitdate"] < li["l_receiptdate"])
         & (li["l_shipdate"] < li["l_commitdate"])
         & (li["l_receiptdate"] >= d0) & (li["l_receiptdate"] < d1))
    prio = _lookup(orders["o_orderkey"], np.isin(
        orders["o_orderpriority"], ["1-URGENT", "2-HIGH"]), fill=False)
    hi = prio[li["l_orderkey"][m]]
    sm = li["l_shipmode"][m]
    out = []
    for mode in sorted(set(sm.tolist())):
        k = sm == mode
        out.append((mode, int((hi & k).sum()), int((~hi & k).sum())))
    return out
