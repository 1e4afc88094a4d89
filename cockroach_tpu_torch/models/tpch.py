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


def gen_refresh(sf: float, seed: int = 7, n_orders: int | None = None
                ) -> tuple[dict, dict]:
    """TPC-H RF1's new sales (spec 5.3.7: SF x 1,500 orders of 1 to 7
    lines each) in this module's generator domains: (orders, lineitem)
    column dicts with object strings, float decimals and day-number
    dates. The order keys follow the generated orders' (every key above
    the current maximum); each line's dates follow its order's date."""
    n = n_orders or max(int(1500 * sf), 1)
    rng = np.random.default_rng(seed)
    first = _n_orders(sf) + 1
    okey = np.arange(first, first + n, dtype=np.int64)
    odate = rng.integers(_days("1992-01-01"), _days("1998-08-02"),
                         size=n).astype(np.int32)
    cutoff = _days("1995-06-17")
    ncust = _n_cust(sf)
    m = ncust - ncust // 3
    idx = rng.integers(0, m, size=n).astype(np.int64)
    orders = {
        "o_orderkey": okey,
        "o_custkey": 3 * (idx // 2) + 1 + (idx % 2),
        "o_orderstatus": np.where(odate < cutoff - 90, "F", np.where(
            odate < cutoff, "P", "O")).astype(object),
        "o_totalprice": np.round(rng.uniform(900, 500000, size=n), 2),
        "o_orderdate": odate,
        "o_orderpriority": rng.choice(ORDER_PRIORITIES,
                                      size=n).astype(object),
        "o_shippriority": np.zeros(n, dtype=np.int64),
    }
    lines = rng.integers(1, 8, size=n)
    k = int(lines.sum())
    lkey = np.repeat(okey, lines)
    start = np.repeat(np.cumsum(lines) - lines, lines)
    linenumber = (np.arange(k) - start + 1).astype(np.int64)
    nparts = max(int(PART_PER_SF * max(sf, 0.01)), 1000)
    nsupp = max(int(SUPP_PER_SF * max(sf, 0.01)), 100)
    partkey = rng.integers(1, nparts + 1, size=k).astype(np.int64)
    quantity = rng.integers(1, 51, size=k).astype(np.float64)
    pprice = (90000 + (partkey % 200001) / 10 + 100 * (partkey % 1000)) / 100
    ship = (np.repeat(odate, lines)
            + rng.integers(1, 122, size=k)).astype(np.int32)
    receipt = ship + rng.integers(1, 31, size=k).astype(np.int32)
    coin = rng.random(k) < 0.5
    lineitem = {
        "l_orderkey": lkey,
        "l_partkey": partkey,
        "l_suppkey": (partkey + rng.integers(0, 4, size=k) * 7) % nsupp + 1,
        "l_linenumber": linenumber,
        "l_quantity": quantity,
        "l_extendedprice": np.round(quantity * pprice, 2),
        "l_discount": rng.integers(0, 11, size=k) / 100.0,
        "l_tax": rng.integers(0, 9, size=k) / 100.0,
        "l_returnflag": np.where(receipt <= cutoff, np.where(
            coin, "R", "A"), "N").astype(object),
        "l_linestatus": np.where(ship > cutoff, "O", "F").astype(object),
        "l_shipdate": ship,
        "l_commitdate": (np.repeat(odate, lines)
                         + rng.integers(30, 91, size=k)).astype(np.int32),
        "l_receiptdate": receipt,
        "l_shipinstruct": rng.choice(SHIPINSTRUCT, size=k).astype(object),
        "l_shipmode": rng.choice(SHIPMODES, size=k).astype(object),
    }
    return orders, lineitem


def rf2_orderkeys(sf: float, seed: int = 8,
                  n_orders: int | None = None) -> np.ndarray:
    """TPC-H RF2's old sales: SF x 1,500 distinct keys of the generated
    orders, ascending."""
    n = n_orders or max(int(1500 * sf), 1)
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(np.arange(1, _n_orders(sf) + 1), size=n,
                              replace=False)).astype(np.int64)


def insert_statements(table: str, cols: dict, batch: int = 1000) -> list:
    """Multi-row INSERT texts for generator columns (the DDL's column
    order; DATE columns as ISO literals, DECIMALs with their two
    places), at most `batch` rows each."""
    from ..sql import parser
    schema = parser.parse(DDL[table])
    names = [c.name for c in schema.columns]
    fmts = []
    for c in schema.columns:
        fam = c.type.family.value
        if fam == "date":
            fmts.append(lambda v: f"'{EPOCH + datetime.timedelta(days=int(v))}'")
        elif fam == "decimal":
            fmts.append(lambda v: f"{float(v):.2f}")
        elif fam == "string":
            fmts.append(lambda v: "'" + str(v).replace("'", "''") + "'")
        else:
            fmts.append(lambda v: str(int(v)))
    n = len(cols[names[0]])
    out = []
    for lo in range(0, n, batch):
        rows = []
        for i in range(lo, min(lo + batch, n)):
            rows.append("(" + ", ".join(f(cols[cn][i]) for f, cn in
                                        zip(fmts, names)) + ")")
        out.append(f"INSERT INTO {table} VALUES " + ", ".join(rows))
    return out


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
         rows: int | None = None, encoded: bool = False,
         chunk_rows: int | None = None, analyze: bool = True) -> None:
    """Create + bulk-ingest TPC-H tables into an Engine.

    ``rows`` caps the *lineitem* row count only (CI-speed slices);
    the other tables always get their full SF-proportional size so the
    key spaces stay consistent with gen_lineitem's foreign keys.
    ``encoded`` uses the pre-encoded string fast path (same numeric
    data and returnflag/linestatus values as the object path for a
    given seed, so the numpy oracles still agree). ``chunk_rows`` cuts
    each table into sealed chunks of that many rows (the reference's
    option): per-chunk zone maps then have ranges narrow enough for
    streamed pages to skip on. ``analyze=False`` leaves the tables
    without ANALYZE statistics (the planner then reads the chunks'
    seal-time sketches): a single-table scan needs none, and ANALYZE
    over hundreds of millions of rows takes minutes."""
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
        if chunk_rows:
            n = len(next(iter(cols.values())))
            for lo in range(0, n, chunk_rows):
                engine.store.insert_columns(
                    t, {k: v[lo:lo + chunk_rows] for k, v in cols.items()},
                    ts)
        else:
            engine.store.insert_columns(t, cols, ts)
        # column stats feed the planner (sql/stats.py), as after the
        # reference's own loads
        if analyze:
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
# queries with subqueries, derived tables and CTEs (the reference's texts)
# ---------------------------------------------------------------------------

Q9 = """
SELECT nation, o_year, sum(amount) AS sum_profit
FROM (
    SELECT n_name AS nation,
           extract(year FROM o_orderdate) AS o_year,
           l_extendedprice * (1 - l_discount)
               - ps_supplycost * l_quantity AS amount
    FROM part, supplier, lineitem, partsupp, orders, nation
    WHERE s_suppkey = l_suppkey
      AND ps_suppkey = l_suppkey
      AND ps_partkey = l_partkey
      AND p_partkey = l_partkey
      AND o_orderkey = l_orderkey
      AND s_nationkey = n_nationkey
      AND p_name LIKE '%%green%%'
) AS profit
GROUP BY nation, o_year
ORDER BY nation, o_year DESC
""".replace("%%", "%")
# threshold parameterized: the spec's 300 is near-empty at tiny SFs
Q18_TEMPLATE = """
SELECT c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
       sum(l_quantity) AS total_qty
FROM customer, orders, lineitem
WHERE o_orderkey IN (
        SELECT l_orderkey FROM lineitem
        GROUP BY l_orderkey HAVING sum(l_quantity) > {threshold})
  AND c_custkey = o_custkey
  AND o_orderkey = l_orderkey
GROUP BY c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
ORDER BY o_totalprice DESC, o_orderdate, o_orderkey
LIMIT 100
"""
Q18 = Q18_TEMPLATE.format(threshold=300)

# the join equality is factored out of the OR groups (semantically
# identical to the spec text; lets the equi-join planner see it).
# Containers/shipmodes use this generator's domains ('REG AIR').
Q19 = """
SELECT sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM lineitem, part
WHERE p_partkey = l_partkey
  AND l_shipinstruct = 'DELIVER IN PERSON'
  AND l_shipmode IN ('AIR', 'REG AIR')
  AND (
      (p_brand = 'Brand#12'
       AND p_container IN ('SM CASE', 'SM BOX')
       AND l_quantity >= 1 AND l_quantity <= 11
       AND p_size BETWEEN 1 AND 5)
   OR (p_brand = 'Brand#23'
       AND p_container IN ('MED BAG', 'MED BOX')
       AND l_quantity >= 10 AND l_quantity <= 20
       AND p_size BETWEEN 1 AND 10)
   OR (p_brand = 'Brand#34'
       AND p_container IN ('LG CASE', 'LG BOX')
       AND l_quantity >= 20 AND l_quantity <= 30
       AND p_size BETWEEN 1 AND 15)
  )
"""

#  lineitem leads the FROM list so the fact table is the probe spine
#  (build sides stay small: supplier/orders/nation + the grouped
#  EXISTS tables) — semantically identical to the spec order
Q21 = """
SELECT s_name, count(*) AS numwait
FROM lineitem l1, supplier, orders, nation
WHERE s_suppkey = l1.l_suppkey
  AND o_orderkey = l1.l_orderkey
  AND o_orderstatus = 'F'
  AND l1.l_receiptdate > l1.l_commitdate
  AND EXISTS (
      SELECT * FROM lineitem l2
      WHERE l2.l_orderkey = l1.l_orderkey
        AND l2.l_suppkey <> l1.l_suppkey)
  AND NOT EXISTS (
      SELECT * FROM lineitem l3
      WHERE l3.l_orderkey = l1.l_orderkey
        AND l3.l_suppkey <> l1.l_suppkey
        AND l3.l_receiptdate > l3.l_commitdate)
  AND s_nationkey = n_nationkey
  AND n_name = 'SAUDI ARABIA'
GROUP BY s_name
ORDER BY numwait DESC, s_name
LIMIT 100
"""

# Q17 (queries.go's small-quantity-order revenue): the correlated
# scalar avg decorrelates into a grouped LEFT JOIN
# (sql/decorrelate.py decorrelate_scalar)
Q17 = """
SELECT sum(l_extendedprice) / 7.0 AS avg_yearly
FROM lineitem, part
WHERE p_partkey = l_partkey
  AND p_brand = 'Brand#23'
  AND p_container = 'MED BOX'
  AND l_quantity < (
      SELECT 0.2 * avg(l2.l_quantity)
      FROM lineitem AS l2
      WHERE l2.l_partkey = p_partkey)
"""

# Q22 (global sales opportunity): uncorrelated scalar avg +
# NOT EXISTS anti-join + substring country codes
Q22 = """
SELECT cntrycode, count(*) AS numcust, sum(c_acctbal) AS totacctbal
FROM (
  SELECT substring(c_phone, 1, 2) AS cntrycode, c_acctbal, c_custkey
  FROM customer
  WHERE substring(c_phone, 1, 2) IN ('13', '31', '23', '29', '30', '18', '17')
) AS custsale
WHERE c_acctbal > (
      SELECT avg(c_acctbal) FROM customer
      WHERE c_acctbal > 0.00
        AND substring(c_phone, 1, 2)
            IN ('13', '31', '23', '29', '30', '18', '17'))
  AND NOT EXISTS (
      SELECT * FROM orders WHERE o_custkey = c_custkey)
GROUP BY cntrycode
ORDER BY cntrycode
"""

# Q2 (minimum-cost supplier): the correlated min over a four-table
# subquery decorrelates into a grouped LEFT JOIN whose derived table
# carries the joins (decorrelate_scalar's multi-table shape); the
# outer five-table graph reorders around the pinned left join
Q2 = """
SELECT s_acctbal, s_name, n_name, p_partkey, p_mfgr
FROM part, supplier, partsupp, nation, region
WHERE p_partkey = ps_partkey
  AND s_suppkey = ps_suppkey
  AND p_size = 15
  AND p_type LIKE '%BRASS'
  AND s_nationkey = n_nationkey
  AND n_regionkey = r_regionkey
  AND r_name = 'EUROPE'
  AND ps_supplycost = (
      SELECT min(ps2.ps_supplycost)
      FROM partsupp AS ps2, supplier AS s2, nation AS n2, region AS r2
      WHERE ps2.ps_partkey = p_partkey
        AND s2.s_suppkey = ps2.ps_suppkey
        AND s2.s_nationkey = n2.n_nationkey
        AND n2.n_regionkey = r2.r_regionkey
        AND r2.r_name = 'EUROPE')
ORDER BY s_acctbal DESC, n_name, s_name, p_partkey
LIMIT 100
"""

# Q4 (order priority checking): EXISTS semi-join
Q4 = """
SELECT o_orderpriority, count(*) AS order_count
FROM orders
WHERE o_orderdate >= date '1993-07-01'
  AND o_orderdate < date '1993-10-01'
  AND EXISTS (
      SELECT * FROM lineitem
      WHERE l_orderkey = o_orderkey AND l_commitdate < l_receiptdate)
GROUP BY o_orderpriority
ORDER BY o_orderpriority
"""

# Q7 (volume shipping): six-table join + year extraction + the
# symmetric two-nation OR predicate
Q7 = """
SELECT supp_nation, cust_nation, l_year, sum(volume) AS revenue
FROM (
  SELECT n1.n_name AS supp_nation, n2.n_name AS cust_nation,
         extract(year FROM l_shipdate) AS l_year,
         l_extendedprice * (1 - l_discount) AS volume
  FROM supplier, lineitem, orders, customer, nation AS n1, nation AS n2
  WHERE s_suppkey = l_suppkey
    AND o_orderkey = l_orderkey
    AND c_custkey = o_custkey
    AND s_nationkey = n1.n_nationkey
    AND c_nationkey = n2.n_nationkey
    AND ((n1.n_name = 'FRANCE' AND n2.n_name = 'GERMANY')
      OR (n1.n_name = 'GERMANY' AND n2.n_name = 'FRANCE'))
    AND l_shipdate BETWEEN date '1995-01-01' AND date '1996-12-31'
) AS shipping
GROUP BY supp_nation, cust_nation, l_year
ORDER BY supp_nation, cust_nation, l_year
"""

# Q8 (national market share): eight tables, conditional share ratio
Q8 = """
SELECT o_year,
       sum(CASE WHEN nation = 'BRAZIL' THEN volume ELSE 0 END)
           / sum(volume) AS mkt_share
FROM (
  SELECT extract(year FROM o_orderdate) AS o_year,
         l_extendedprice * (1 - l_discount) AS volume,
         n2.n_name AS nation
  FROM part, supplier, lineitem, orders, customer,
       nation AS n1, nation AS n2, region
  WHERE p_partkey = l_partkey
    AND s_suppkey = l_suppkey
    AND l_orderkey = o_orderkey
    AND o_custkey = c_custkey
    AND c_nationkey = n1.n_nationkey
    AND n1.n_regionkey = r_regionkey
    AND r_name = 'AMERICA'
    AND s_nationkey = n2.n_nationkey
    AND o_orderdate BETWEEN date '1995-01-01' AND date '1996-12-31'
    AND p_type = 'ECONOMY ANODIZED STEEL'
) AS all_nations
GROUP BY o_year
ORDER BY o_year
"""

# Q11 (important stock): grouped HAVING against an uncorrelated
# scalar threshold over the same join
Q11 = """
SELECT ps_partkey, sum(ps_supplycost * ps_availqty) AS value
FROM partsupp, supplier, nation
WHERE ps_suppkey = s_suppkey
  AND s_nationkey = n_nationkey
  AND n_name = 'GERMANY'
GROUP BY ps_partkey
HAVING sum(ps_supplycost * ps_availqty) > (
    SELECT sum(ps_supplycost * ps_availqty) * 0.0001
    FROM partsupp, supplier, nation
    WHERE ps_suppkey = s_suppkey
      AND s_nationkey = n_nationkey
      AND n_name = 'GERMANY')
ORDER BY value DESC
"""

# Q13 (customer distribution): LEFT JOIN + two-level grouping
Q13 = """
SELECT c_count, count(*) AS custdist
FROM (
  SELECT c_custkey, count(o_orderkey) AS c_count
  FROM customer LEFT JOIN orders ON c_custkey = o_custkey
  GROUP BY c_custkey
) AS c_orders
GROUP BY c_count
ORDER BY custdist DESC, c_count DESC
"""

# Q15 (top supplier): CTE revenue view + uncorrelated max
Q15 = """
WITH revenue AS (
  SELECT l_suppkey AS supplier_no,
         sum(l_extendedprice * (1 - l_discount)) AS total_revenue
  FROM lineitem
  WHERE l_shipdate >= date '1996-01-01'
    AND l_shipdate < date '1996-04-01'
  GROUP BY l_suppkey)
SELECT s_suppkey, s_name, total_revenue
FROM supplier, revenue
WHERE s_suppkey = supplier_no
  AND total_revenue = (SELECT max(total_revenue) FROM revenue)
ORDER BY s_suppkey
"""

# Q15 as the TPC-H specification writes it: a view, the query over it,
# and the view dropped again (the same rows as the CTE form above)
Q15_VIEW = ("""
CREATE VIEW revenue0 (supplier_no, total_revenue) AS
  SELECT l_suppkey, sum(l_extendedprice * (1 - l_discount))
  FROM lineitem
  WHERE l_shipdate >= date '1996-01-01'
    AND l_shipdate < date '1996-04-01'
  GROUP BY l_suppkey
""", """
SELECT s_suppkey, s_name, total_revenue
FROM supplier, revenue0
WHERE s_suppkey = supplier_no
  AND total_revenue = (SELECT max(total_revenue) FROM revenue0)
ORDER BY s_suppkey
""", "DROP VIEW revenue0")

# Q16 (parts/supplier relationship): NOT IN subquery + count distinct
Q16 = """
SELECT p_brand, p_type, p_size, count(DISTINCT ps_suppkey) AS supplier_cnt
FROM partsupp, part
WHERE p_partkey = ps_partkey
  AND p_brand <> 'Brand#45'
  AND p_size IN (49, 14, 23, 45, 19, 3, 36, 9)
  AND ps_suppkey NOT IN (
      SELECT s_suppkey FROM supplier WHERE s_acctbal < 0)
GROUP BY p_brand, p_type, p_size
ORDER BY supplier_cnt DESC, p_brand, p_type, p_size
"""

# Q20 (potential part promotion): nested IN subqueries + a
# two-key-correlated scalar half-sum threshold
Q20 = """
SELECT s_name
FROM supplier, nation
WHERE s_suppkey IN (
    SELECT ps_suppkey FROM partsupp
    WHERE ps_partkey IN (
        SELECT p_partkey FROM part WHERE p_name LIKE 'forest%')
      AND ps_availqty > (
          SELECT 0.5 * sum(l_quantity) FROM lineitem
          WHERE l_partkey = ps_partkey AND l_suppkey = ps_suppkey
            AND l_shipdate >= date '1994-01-01'
            AND l_shipdate < date '1995-01-01'))
  AND s_nationkey = n_nationkey
  AND n_name = 'CANADA'
ORDER BY s_name
"""

QUERIES = {"q1": Q1, "q2": Q2, "q3": Q3, "q4": Q4, "q5": Q5, "q6": Q6,
           "q7": Q7, "q8": Q8, "q9": Q9, "q10": Q10, "q11": Q11,
           "q12": Q12, "q13": Q13, "q14": Q14, "q15": Q15, "q16": Q16,
           "q17": Q17, "q18": Q18, "q19": Q19, "q20": Q20, "q21": Q21,
           "q22": Q22}


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


# ---------------------------------------------------------------------------
# numpy oracles of the subquery, derived-table and CTE queries: the rows
# of the reference's loop oracles (models/tpch.py ref_q2 ... ref_q22),
# vectorized. Float sums add each key's values in row order
# (np.bincount), as the loops' running sums do.
# ---------------------------------------------------------------------------

def _years(days: np.ndarray) -> np.ndarray:
    """Calendar year of each day number."""
    return np.asarray(days, dtype="datetime64[D]").astype(
        "datetime64[Y]").astype(np.int64) + 1970


def _pair_keys(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """One int64 key per (a, b) pair of non-negative ints."""
    return a.astype(np.int64) * (int(b.max(initial=0)) + 1) + b


def _seq_sum(values: np.ndarray) -> float:
    """A running sum in row order (np.sum adds pairwise)."""
    return float(np.bincount(np.zeros(len(values), dtype=np.int64),
                             weights=values, minlength=1)[0])


def _strings_where(arr: np.ndarray, fn) -> np.ndarray:
    return np.fromiter((fn(x) for x in arr), dtype=bool, count=len(arr))


def ref_q2(part, supp, ps, nation, region) -> list[tuple]:
    eur = region["r_regionkey"][region["r_name"] == "EUROPE"][0]
    nat_eur = _lookup(nation["n_nationkey"], nation["n_regionkey"] == eur,
                      fill=False)
    s_nat = _lookup(supp["s_suppkey"], supp["s_nationkey"])
    pk, sk = ps["ps_partkey"], ps["ps_suppkey"]
    cost = ps["ps_supplycost"]
    in_eur = nat_eur[s_nat[sk]]
    min_cost = np.full(int(pk.max()) + 1, np.inf)
    np.minimum.at(min_cost, pk[in_eur], cost[in_eur])
    pm = (part["p_size"] == 15) & _strings_where(
        part["p_type"], lambda t: t.endswith("BRASS"))
    psel = _lookup(part["p_partkey"], pm, fill=False)
    pidx = _lookup(part["p_partkey"],
                   np.arange(len(part["p_partkey"]), dtype=np.int64))
    sidx = _lookup(supp["s_suppkey"],
                   np.arange(len(supp["s_suppkey"]), dtype=np.int64))
    hit = np.nonzero(psel[pk] & in_eur & (cost == min_cost[pk]))[0]
    out = [(round(float(supp["s_acctbal"][sidx[s]]), 2),
            supp["s_name"][sidx[s]], NATIONS[int(s_nat[s])], int(p),
            part["p_mfgr"][pidx[p]])
           for p, s in zip(pk[hit], sk[hit])]
    out.sort(key=lambda t: (-t[0], t[2], t[1], t[3]))
    return out[:100]


def ref_q4(li, orders) -> list[tuple]:
    d0, d1 = _days("1993-07-01"), _days("1993-10-01")
    ok_max = int(max(li["l_orderkey"].max(), orders["o_orderkey"].max()))
    late = np.zeros(ok_max + 1, dtype=bool)
    late[li["l_orderkey"][li["l_commitdate"] < li["l_receiptdate"]]] = True
    od = orders["o_orderdate"]
    m = (od >= d0) & (od < d1) & late[orders["o_orderkey"]]
    pri, cnt = np.unique(orders["o_orderpriority"][m].astype(str),
                         return_counts=True)
    return [(str(p), int(c)) for p, c in zip(pri, cnt)]


def ref_q7(li, orders, cust, supp, nation) -> list[tuple]:
    d0, d1 = _days("1995-01-01"), _days("1996-12-31")
    names = _lookup(nation["n_nationkey"],
                    np.asarray(nation["n_name"], dtype=object), fill=None)
    s_nat = _lookup(supp["s_suppkey"], supp["s_nationkey"])
    c_nat = _lookup(cust["c_custkey"], cust["c_nationkey"])
    o_cust = _lookup(orders["o_orderkey"], orders["o_custkey"])
    m = (li["l_shipdate"] >= d0) & (li["l_shipdate"] <= d1)
    rows = np.nonzero(m)[0]
    sn = s_nat[li["l_suppkey"][rows]]
    cn = c_nat[o_cust[li["l_orderkey"][rows]]]
    fr = list(nation["n_name"]).index("FRANCE")
    de = list(nation["n_name"]).index("GERMANY")
    keep = ((sn == fr) & (cn == de)) | ((sn == de) & (cn == fr))
    rows, sn, cn = rows[keep], sn[keep], cn[keep]
    yr = _years(li["l_shipdate"][rows])
    vol = li["l_extendedprice"][rows] * (1 - li["l_discount"][rows])
    keys, sums = _keyed_sums((sn * 25 + cn) * 10000 + yr, vol)
    return sorted((names[k // 10000 // 25], names[k // 10000 % 25],
                   int(k % 10000), float(v)) for k, v in zip(keys, sums))


def ref_q8(li, orders, cust, supp, part, nation, region) -> list[tuple]:
    d0, d1 = _days("1995-01-01"), _days("1996-12-31")
    amer = region["r_regionkey"][region["r_name"] == "AMERICA"][0]
    nat_amer = _lookup(nation["n_nationkey"],
                       nation["n_regionkey"] == amer, fill=False)
    p_sel = _lookup(part["p_partkey"],
                    part["p_type"] == "ECONOMY ANODIZED STEEL", fill=False)
    s_nat = _lookup(supp["s_suppkey"], supp["s_nationkey"])
    c_nat = _lookup(cust["c_custkey"], cust["c_nationkey"])
    o_cust = _lookup(orders["o_orderkey"], orders["o_custkey"])
    o_date = _lookup(orders["o_orderkey"],
                     orders["o_orderdate"].astype(np.int64))
    rows = np.nonzero(p_sel[li["l_partkey"]])[0]
    ok = li["l_orderkey"][rows]
    od = o_date[ok]
    keep = (od >= d0) & (od <= d1)
    keep[keep] = nat_amer[c_nat[o_cust[ok[keep]]]]
    rows, od = rows[keep], od[keep]
    yr = _years(od)
    vol = li["l_extendedprice"][rows] * (1 - li["l_discount"][rows])
    brazil = s_nat[li["l_suppkey"][rows]] == NATIONS.index("BRAZIL")
    years, den = _keyed_sums(yr, vol)
    num = dict(zip(*(a.tolist() for a in _keyed_sums(yr[brazil],
                                                     vol[brazil]))))
    return sorted((int(y), num.get(int(y), 0.0) / float(d))
                  for y, d in zip(years, den))


def ref_q9(li, orders, supp, part, ps) -> list[tuple]:
    green = _lookup(part["p_partkey"], _strings_where(
        part["p_name"], lambda n: "green" in n), fill=False)
    rows = np.nonzero(green[li["l_partkey"]])[0]
    pk, sk = li["l_partkey"][rows], li["l_suppkey"][rows]
    ps_key = _pair_keys(ps["ps_partkey"], ps["ps_suppkey"])
    order = np.argsort(ps_key, kind="stable")
    kmax = int(ps["ps_suppkey"].max(initial=0)) + 1
    at = order[np.searchsorted(ps_key[order], pk * kmax + sk)]
    cost = ps["ps_supplycost"][at]
    s_nat = _lookup(supp["s_suppkey"], supp["s_nationkey"])
    o_year = _lookup(orders["o_orderkey"], _years(orders["o_orderdate"]))
    amount = li["l_extendedprice"] * (1 - li["l_discount"])
    amt = amount[rows] - cost * li["l_quantity"][rows]
    keys, sums = _keyed_sums(
        s_nat[sk] * 10000 + o_year[li["l_orderkey"][rows]], amt)
    out = [(NATIONS[int(k // 10000)], int(k % 10000), float(v))
           for k, v in zip(keys, sums)]
    return sorted(out, key=lambda t: (t[0], -t[1]))


def ref_q11(ps, supp, nation) -> list[tuple]:
    ger = nation["n_nationkey"][nation["n_name"] == "GERMANY"][0]
    s_sel = _lookup(supp["s_suppkey"], supp["s_nationkey"] == ger,
                    fill=False)
    m = s_sel[ps["ps_suppkey"]]
    v = ps["ps_supplycost"][m] * ps["ps_availqty"][m]
    keys, sums = _keyed_sums(ps["ps_partkey"][m], v)
    thr = _seq_sum(v) * 0.0001
    rows = [(int(k), float(s)) for k, s in zip(keys, sums) if s > thr]
    rows.sort(key=lambda t: -t[1])
    return rows


def ref_q13(orders, cust) -> list[tuple]:
    ck = cust["c_custkey"]
    per_cust = np.bincount(orders["o_custkey"],
                           minlength=int(ck.max()) + 1)[ck]
    counts, dist = np.unique(per_cust, return_counts=True)
    return sorted(((int(c), int(d)) for c, d in zip(counts, dist)),
                  key=lambda t: (-t[1], -t[0]))


def ref_q15(li, supp) -> list[tuple]:
    d0, d1 = _days("1996-01-01"), _days("1996-04-01")
    m = (li["l_shipdate"] >= d0) & (li["l_shipdate"] < d1)
    if not m.any():
        return []
    keys, sums = _keyed_sums(li["l_suppkey"][m], li["l_extendedprice"][m]
                             * (1 - li["l_discount"][m]))
    mx = sums.max()
    s_name = _lookup(supp["s_suppkey"],
                     np.asarray(supp["s_name"], dtype=object), fill=None)
    return sorted((int(k), s_name[k], float(r))
                  for k, r in zip(keys, sums) if r == mx)


def ref_q16(part, ps, supp) -> list[tuple]:
    bad = _lookup(supp["s_suppkey"], supp["s_acctbal"] < 0, fill=False)
    pm = (part["p_brand"] != "Brand#45") & np.isin(
        part["p_size"], [49, 14, 23, 45, 19, 3, 36, 9])
    pidx = _lookup(part["p_partkey"][pm], np.nonzero(pm)[0])
    pk, sk = ps["ps_partkey"], ps["ps_suppkey"]
    inr = pk < pidx.shape[0]
    idx = np.full(len(pk), -1, dtype=np.int64)
    idx[inr] = pidx[pk[inr]]
    keep = (idx >= 0) & ~bad[sk]
    idx, sk = idx[keep], sk[keep]
    brands, bcode = np.unique(part["p_brand"][idx].astype(str),
                              return_inverse=True)
    types, tcode = np.unique(part["p_type"][idx].astype(str),
                             return_inverse=True)
    size = part["p_size"][idx]
    group = (bcode.astype(np.int64) * len(types) + tcode) * 51 + size
    pairs = np.unique(_pair_keys(group, sk))
    g, n = np.unique(pairs // (int(sk.max(initial=0)) + 1),
                     return_counts=True)
    rows = [(str(brands[k // 51 // len(types)]),
             str(types[k // 51 % len(types)]), int(k % 51), int(c))
            for k, c in zip(g, n)]
    rows.sort(key=lambda r: (-r[3], r[0], r[1], r[2]))
    return rows


def ref_q17(li, part) -> float:
    keys = li["l_partkey"]
    qty = li["l_quantity"]
    size = int(keys.max()) + 1
    sums = np.bincount(keys, weights=qty, minlength=size)
    counts = np.bincount(keys, minlength=size)
    avg = sums / np.maximum(counts, 1)
    pm = (part["p_brand"] == "Brand#23") & \
        (part["p_container"] == "MED BOX")
    sel = np.zeros(size, dtype=bool)
    sel[part["p_partkey"][pm]] = True
    m = sel[keys] & (qty < 0.2 * avg[keys])
    return float(li["l_extendedprice"][m].sum() / 7.0)


def ref_q18(li, orders, cust, threshold=300) -> list[tuple]:
    ok_max = int(max(li["l_orderkey"].max(), orders["o_orderkey"].max()))
    qty = np.bincount(li["l_orderkey"], weights=li["l_quantity"],
                      minlength=ok_max + 1)
    big = np.zeros(ok_max + 1, dtype=bool)
    big[li["l_orderkey"]] = True
    big &= qty > threshold
    c_name = _lookup(cust["c_custkey"],
                     np.asarray(cust["c_name"], dtype=object), fill=None)
    rows = []
    for i in np.nonzero(big[orders["o_orderkey"]])[0]:
        ok = int(orders["o_orderkey"][i])
        ck = int(orders["o_custkey"][i])
        rows.append((c_name[ck], ck, ok, _date(orders["o_orderdate"][i]),
                     float(orders["o_totalprice"][i]), float(qty[ok])))
    rows.sort(key=lambda t: (-t[4], t[3], t[2]))
    return rows[:100]


def ref_q19(li, part) -> float:
    b, c, s = part["p_brand"], part["p_container"], part["p_size"]
    groups = (("Brand#12", ["SM CASE", "SM BOX"], 1, 11, 5),
              ("Brand#23", ["MED BAG", "MED BOX"], 10, 20, 10),
              ("Brand#34", ["LG CASE", "LG BOX"], 20, 30, 15))
    q = li["l_quantity"]
    m = np.zeros(len(q), dtype=bool)
    for brand, conts, qlo, qhi, smax in groups:
        pm = _lookup(part["p_partkey"], (b == brand) & np.isin(c, conts)
                     & (s >= 1) & (s <= smax), fill=False)
        m |= pm[li["l_partkey"]] & (q >= qlo) & (q <= qhi)
    m &= (np.isin(li["l_shipmode"], ["AIR", "REG AIR"])
          & (li["l_shipinstruct"] == "DELIVER IN PERSON"))
    return float((li["l_extendedprice"][m]
                  * (1 - li["l_discount"][m])).sum())


def ref_q20(li, supp, part, ps, nation) -> list[tuple]:
    can = nation["n_nationkey"][nation["n_name"] == "CANADA"][0]
    forest = _lookup(part["p_partkey"], _strings_where(
        part["p_name"], lambda n: n.startswith("forest")), fill=False)
    d0, d1 = _days("1994-01-01"), _days("1995-01-01")
    m = (li["l_shipdate"] >= d0) & (li["l_shipdate"] < d1)
    kmax = int(max(li["l_suppkey"].max(), ps["ps_suppkey"].max())) + 1
    keys, sums = _keyed_sums(
        li["l_partkey"][m].astype(np.int64) * kmax + li["l_suppkey"][m],
        li["l_quantity"][m])
    order = np.argsort(keys)
    keys, sums = keys[order], sums[order]
    pk, sk = ps["ps_partkey"], ps["ps_suppkey"]
    want = pk.astype(np.int64) * kmax + sk
    at = np.clip(np.searchsorted(keys, want), 0, max(len(keys) - 1, 0))
    has = (keys[at] == want) if len(keys) else np.zeros(len(pk), bool)
    # an empty scalar subquery is NULL: avail > NULL never passes
    ok = forest[pk] & has
    ok[ok] = ps["ps_availqty"][ok] > 0.5 * sums[at[ok]]
    s_nat = _lookup(supp["s_suppkey"], supp["s_nationkey"])
    s_name = _lookup(supp["s_suppkey"],
                     np.asarray(supp["s_name"], dtype=object), fill=None)
    return sorted((s_name[k],) for k in np.unique(sk[ok])
                  if s_nat[k] == can)


def ref_q21(li, orders, supp) -> list[tuple]:
    saudi = NATIONS.index("SAUDI ARABIA")
    ok, sk = li["l_orderkey"], li["l_suppkey"]
    size = int(max(ok.max(), orders["o_orderkey"].max())) + 1
    f_orders = _lookup(orders["o_orderkey"], orders["o_orderstatus"] == "F",
                       fill=False)
    late = li["l_receiptdate"] > li["l_commitdate"]
    # per order: the least and greatest supplier, of all lines and of
    # the late ones; another supplier exists iff one differs from sk
    big = np.iinfo(np.int64).max
    lo, hi = np.full(size, big), np.full(size, -1)
    np.minimum.at(lo, ok, sk)
    np.maximum.at(hi, ok, sk)
    llo, lhi = np.full(size, big), np.full(size, -1)
    np.minimum.at(llo, ok[late], sk[late])
    np.maximum.at(lhi, ok[late], sk[late])
    s_nat = _lookup(supp["s_suppkey"], supp["s_nationkey"])
    m = late & f_orders[ok] & (s_nat[sk] == saudi)
    m &= (lo[ok] != sk) | (hi[ok] != sk)                   # EXISTS
    m &= ~(((llo[ok] != sk) & (llo[ok] != big))
           | ((lhi[ok] != sk) & (lhi[ok] != -1)))           # NOT EXISTS
    s_name = _lookup(supp["s_suppkey"],
                     np.asarray(supp["s_name"], dtype=object), fill=None)
    names, counts = np.unique(s_name[sk[m]].astype(str), return_counts=True)
    out = sorted(((str(n), int(c)) for n, c in zip(names, counts)),
                 key=lambda t: (-t[1], t[0]))
    return out[:100]


def ref_q22(cust, orders) -> list[tuple]:
    codes = np.array([p[:2] for p in cust["c_phone"]], dtype=object)
    in_list = np.isin(codes, ["13", "31", "23", "29", "30", "18", "17"])
    pos = in_list & (cust["c_acctbal"] > 0.0)
    avg_bal = float(cust["c_acctbal"][pos].mean())
    ck = cust["c_custkey"]
    has_orders = np.zeros(int(max(ck.max(), orders["o_custkey"].max())) + 1,
                          dtype=bool)
    has_orders[orders["o_custkey"]] = True
    m = in_list & (cust["c_acctbal"] > avg_bal) & ~has_orders[ck]
    cc, inv = np.unique(codes[m].astype(str), return_inverse=True)
    n = np.bincount(inv, minlength=len(cc))
    s = np.bincount(inv, weights=cust["c_acctbal"][m], minlength=len(cc))
    return sorted((str(c), int(k), round(float(v), 2))
                  for c, k, v in zip(cc, n, s))


# the oracles' table arguments, by query (keys of oracle_rows' `tables`)
ORACLE_ARGS = {
    "q2": ("part", "supplier", "partsupp", "nation", "region"),
    "q4": ("lineitem", "orders"),
    "q7": ("lineitem", "orders", "customer", "supplier", "nation"),
    "q8": ("lineitem", "orders", "customer", "supplier", "part", "nation",
           "region"),
    "q9": ("lineitem", "orders", "supplier", "part", "partsupp"),
    "q11": ("partsupp", "supplier", "nation"),
    "q13": ("orders", "customer"),
    "q15": ("lineitem", "supplier"),
    "q16": ("part", "partsupp", "supplier"),
    "q17": ("lineitem", "part"),
    "q18": ("lineitem", "orders", "customer"),
    "q19": ("lineitem", "part"),
    "q20": ("lineitem", "supplier", "part", "partsupp", "nation"),
    "q21": ("lineitem", "orders", "supplier"),
    "q22": ("customer", "orders"),
}


def oracle_rows(q: str, tables: dict) -> list[tuple]:
    """Query ``q``'s oracle as the query's result rows. ``tables`` maps
    table name -> generator columns, strings as Python strings."""
    out = globals()[f"ref_{q}"](*(tables[t] for t in ORACLE_ARGS[q]))
    return [(out,)] if isinstance(out, float) else out
