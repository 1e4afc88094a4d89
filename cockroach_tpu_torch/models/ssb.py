"""SSB, the Star Schema Benchmark (O'Neil et al.): a lineorder fact
table joined against date, part, supplier and customer dimensions;
flights Q1 (restrictive scan), Q2 (brand rollup), Q3 (customer and
supplier geography) and Q4 (profit).

The counterpart of cockroach_tpu/workload/ssb.py: the same seeded
generators, DDL and query texts, with numpy oracles for all five
flights (q1.1 and q2.1 the reference's, vectorized; q1.2, q3.1 and
q4.1 this package's own). SSB's ``supplier`` and ``customer`` clash by
name with TPC-H's, so SSB loads into an Engine of its own.
"""

from __future__ import annotations

import numpy as np

LINEORDER_PER_SF = 6_000_000

DDL = {
    "date": """
CREATE TABLE date (
    d_datekey   INT8 NOT NULL PRIMARY KEY,
    d_year      INT8 NOT NULL,
    d_yearmonth STRING NOT NULL,
    d_weeknum   INT8 NOT NULL
)""",
    "supplier": """
CREATE TABLE supplier (
    s_suppkey INT8 NOT NULL PRIMARY KEY,
    s_city    STRING NOT NULL,
    s_nation  STRING NOT NULL,
    s_region  STRING NOT NULL
)""",
    "part_ssb": """
CREATE TABLE part_ssb (
    p_partkey  INT8 NOT NULL PRIMARY KEY,
    p_mfgr     STRING NOT NULL,
    p_category STRING NOT NULL,
    p_brand1   STRING NOT NULL
)""",
    "customer": """
CREATE TABLE customer (
    c_custkey INT8 NOT NULL PRIMARY KEY,
    c_city    STRING NOT NULL,
    c_nation  STRING NOT NULL,
    c_region  STRING NOT NULL
)""",
    "lineorder": """
CREATE TABLE lineorder (
    lo_orderkey      INT8 NOT NULL,
    lo_custkey       INT8 NOT NULL,
    lo_partkey       INT8 NOT NULL,
    lo_suppkey       INT8 NOT NULL,
    lo_orderdate     INT8 NOT NULL,
    lo_quantity      INT8 NOT NULL,
    lo_extendedprice INT8 NOT NULL,
    lo_discount      INT8 NOT NULL,
    lo_revenue       INT8 NOT NULL,
    lo_supplycost    INT8 NOT NULL
)""",
}

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = {r: [f"{r[:3]}_NATION{i}" for i in range(5)] for r in REGIONS}
MFGRS = [f"MFGR#{i}" for i in range(1, 6)]


def _dates():
    """The 7-year date dim 1992-1998 (one row per day, datekey
    yyyymmdd)."""
    import datetime
    days = []
    d = datetime.date(1992, 1, 1)
    while d <= datetime.date(1998, 12, 31):
        days.append(d)
        d += datetime.timedelta(days=1)
    return days


def gen_dims(sf: float, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    days = _dates()
    date = {
        "d_datekey": np.array([d.year * 10000 + d.month * 100 + d.day
                               for d in days], dtype=np.int64),
        "d_year": np.array([d.year for d in days], dtype=np.int64),
        "d_yearmonth": np.array([f"{d.year}{d.month:02d}" for d in days],
                                dtype=object),
        "d_weeknum": np.array([d.isocalendar()[1] for d in days],
                              dtype=np.int64),
    }
    ns = max(int(2_000 * max(sf, 0.01)), 20)
    s_region = rng.choice(REGIONS, size=ns)
    supplier = {
        "s_suppkey": np.arange(1, ns + 1, dtype=np.int64),
        "s_city": np.array([f"{r[:4]}CITY{rng.integers(0, 10)}"
                            for r in s_region], dtype=object),
        "s_nation": np.array([rng.choice(NATIONS[r]) for r in s_region],
                             dtype=object),
        "s_region": s_region.astype(object),
    }
    npart = max(int(200_000 * max(sf, 0.001)), 200)
    mfgr = rng.choice(MFGRS, size=npart)
    cat = np.array([f"{m}{rng.integers(1, 6)}" for m in mfgr], dtype=object)
    part = {
        "p_partkey": np.arange(1, npart + 1, dtype=np.int64),
        "p_mfgr": mfgr.astype(object),
        "p_category": cat,
        "p_brand1": np.array([f"{c}{rng.integers(1, 41)}" for c in cat],
                             dtype=object),
    }
    nc = max(int(30_000 * max(sf, 0.001)), 30)
    c_region = rng.choice(REGIONS, size=nc)
    customer = {
        "c_custkey": np.arange(1, nc + 1, dtype=np.int64),
        "c_city": np.array([f"{r[:4]}CITY{rng.integers(0, 10)}"
                            for r in c_region], dtype=object),
        "c_nation": np.array([rng.choice(NATIONS[r]) for r in c_region],
                             dtype=object),
        "c_region": c_region.astype(object),
    }
    return {"date": date, "supplier": supplier, "part_ssb": part,
            "customer": customer}


def gen_lineorder(sf: float, dims: dict, seed: int = 0,
                  rows: int | None = None) -> dict:
    n = rows if rows is not None else int(LINEORDER_PER_SF * sf)
    rng = np.random.default_rng(seed)
    datekeys = dims["date"]["d_datekey"]
    quantity = rng.integers(1, 51, size=n).astype(np.int64)
    eprice = rng.integers(90_000, 10_000_000, size=n).astype(np.int64)
    discount = rng.integers(0, 11, size=n).astype(np.int64)
    revenue = eprice * (100 - discount) // 100
    return {
        "lo_orderkey": np.arange(1, n + 1, dtype=np.int64),
        "lo_custkey": rng.integers(
            1, len(dims["customer"]["c_custkey"]) + 1, size=n
        ).astype(np.int64),
        "lo_partkey": rng.integers(
            1, len(dims["part_ssb"]["p_partkey"]) + 1, size=n
        ).astype(np.int64),
        "lo_suppkey": rng.integers(
            1, len(dims["supplier"]["s_suppkey"]) + 1, size=n
        ).astype(np.int64),
        "lo_orderdate": rng.choice(datekeys, size=n).astype(np.int64),
        "lo_quantity": quantity,
        "lo_extendedprice": eprice,
        "lo_discount": discount,
        "lo_revenue": revenue,
        "lo_supplycost": (eprice * 6 // 10),
    }


def load(engine, sf: float = 0.01, seed: int = 0,
         rows: int | None = None) -> dict:
    dims = gen_dims(sf, seed=seed + 1)
    lo = gen_lineorder(sf, dims, seed=seed, rows=rows)
    ts = engine.clock.now()
    for name, ddl in DDL.items():
        engine.execute(ddl)
        engine.store.insert_columns(
            name, dims[name] if name != "lineorder" else lo, ts)
    return {"dims": dims, "lineorder": lo}


# -- queries (texts follow the SSB spec) -------------------------------------

Q1_1 = """
SELECT sum(lo_extendedprice * lo_discount) AS revenue
FROM lineorder, date
WHERE lo_orderdate = d_datekey AND d_year = 1993
  AND lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25
"""

Q1_2 = """
SELECT sum(lo_extendedprice * lo_discount) AS revenue
FROM lineorder, date
WHERE lo_orderdate = d_datekey AND d_yearmonth = '199401'
  AND lo_discount BETWEEN 4 AND 6
  AND lo_quantity >= 26 AND lo_quantity <= 35
"""

Q2_1 = """
SELECT d_year, p_brand1, sum(lo_revenue) AS revenue
FROM lineorder, date, part_ssb, supplier
WHERE lo_orderdate = d_datekey AND lo_partkey = p_partkey
  AND lo_suppkey = s_suppkey
  AND p_category = 'MFGR#12' AND s_region = 'AMERICA'
GROUP BY d_year, p_brand1
ORDER BY d_year, p_brand1
"""

Q3_1 = """
SELECT c_nation, s_nation, d_year, sum(lo_revenue) AS revenue
FROM lineorder, customer, supplier, date
WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
  AND lo_orderdate = d_datekey
  AND c_region = 'ASIA' AND s_region = 'ASIA'
  AND d_year >= 1992 AND d_year <= 1997
GROUP BY c_nation, s_nation, d_year
ORDER BY d_year, revenue DESC
"""

Q4_1 = """
SELECT d_year, c_nation,
       sum(lo_revenue - lo_supplycost) AS profit
FROM lineorder, customer, supplier, date
WHERE lo_custkey = c_custkey AND lo_suppkey = s_suppkey
  AND lo_orderdate = d_datekey
  AND c_region = 'AMERICA' AND s_region = 'AMERICA'
GROUP BY d_year, c_nation
ORDER BY d_year, c_nation
"""

QUERIES = {"q1.1": Q1_1, "q1.2": Q1_2, "q2.1": Q2_1, "q3.1": Q3_1,
           "q4.1": Q4_1}


# -- numpy oracles -----------------------------------------------------------

def _dim_index(dims: dict, table: str, key_col: str,
               keys: np.ndarray) -> np.ndarray:
    """Row index into a dimension table of each foreign key."""
    dkeys = dims[table][key_col]
    order = np.argsort(dkeys, kind="stable")
    return order[np.searchsorted(dkeys[order], keys)]


def _dim_col(dims, table, key_col, val_col, keys) -> np.ndarray:
    return dims[table][val_col][_dim_index(dims, table, key_col, keys)]


def _grouped_int_sums(keys: list, values: np.ndarray) -> dict:
    """{key tuple: int sum} over rows, keys given as parallel arrays."""
    if not len(values):
        return {}
    uniq, inv = np.unique(np.stack([np.asarray(k).astype(str)
                                    for k in keys], axis=1),
                          axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    sums = np.zeros(len(uniq), dtype=np.int64)
    np.add.at(sums, inv, values.astype(np.int64))
    first = np.zeros(len(uniq), dtype=np.int64)
    first[inv[::-1]] = np.arange(len(inv))[::-1]
    out = {}
    for g, s in zip(range(len(uniq)), sums):
        i = first[g]
        out[tuple(k[i].item() if hasattr(k[i], "item") else k[i]
                  for k in keys)] = int(s)
    return out


def ref_q1_1(lo: dict, dims: dict) -> int:
    yr = _dim_col(dims, "date", "d_datekey", "d_year", lo["lo_orderdate"])
    m = ((yr == 1993) & (lo["lo_discount"] >= 1) & (lo["lo_discount"] <= 3)
         & (lo["lo_quantity"] < 25))
    return int((lo["lo_extendedprice"][m] * lo["lo_discount"][m]).sum())


def ref_q1_2(lo: dict, dims: dict) -> int:
    ym = _dim_col(dims, "date", "d_datekey", "d_yearmonth",
                  lo["lo_orderdate"])
    m = ((ym == "199401") & (lo["lo_discount"] >= 4)
         & (lo["lo_discount"] <= 6) & (lo["lo_quantity"] >= 26)
         & (lo["lo_quantity"] <= 35))
    return int((lo["lo_extendedprice"][m] * lo["lo_discount"][m]).sum())


def ref_q2_1(lo: dict, dims: dict) -> list[tuple]:
    pi = _dim_index(dims, "part_ssb", "p_partkey", lo["lo_partkey"])
    sreg = _dim_col(dims, "supplier", "s_suppkey", "s_region",
                    lo["lo_suppkey"])
    m = (dims["part_ssb"]["p_category"][pi] == "MFGR#12") & \
        (sreg == "AMERICA")
    yr = _dim_col(dims, "date", "d_datekey", "d_year",
                  lo["lo_orderdate"][m])
    out = _grouped_int_sums([yr, dims["part_ssb"]["p_brand1"][pi[m]]],
                            lo["lo_revenue"][m])
    return sorted((y, b, r) for (y, b), r in out.items())


def _geo(lo: dict, dims: dict, region: str):
    """Rows whose customer and supplier are both in `region`, with the
    customer's and supplier's nations and the order year."""
    ci = _dim_index(dims, "customer", "c_custkey", lo["lo_custkey"])
    si = _dim_index(dims, "supplier", "s_suppkey", lo["lo_suppkey"])
    m = (dims["customer"]["c_region"][ci] == region) & \
        (dims["supplier"]["s_region"][si] == region)
    yr = _dim_col(dims, "date", "d_datekey", "d_year",
                  lo["lo_orderdate"][m])
    return (m, dims["customer"]["c_nation"][ci[m]],
            dims["supplier"]["s_nation"][si[m]], yr)


def ref_q3_1(lo: dict, dims: dict) -> list[tuple]:
    m, cn, sn, yr = _geo(lo, dims, "ASIA")
    keep = (yr >= 1992) & (yr <= 1997)
    out = _grouped_int_sums([cn[keep], sn[keep], yr[keep]],
                            lo["lo_revenue"][m][keep])
    return sorted(((c, s, y, r) for (c, s, y), r in out.items()),
                  key=lambda t: (t[2], -t[3], t[0], t[1]))


def ref_q4_1(lo: dict, dims: dict) -> list[tuple]:
    m, cn, _sn, yr = _geo(lo, dims, "AMERICA")
    out = _grouped_int_sums([yr, cn], lo["lo_revenue"][m]
                            - lo["lo_supplycost"][m])
    return sorted((y, c, p) for (y, c), p in out.items())
