"""Carry table state into this package's ColumnStore from plain arrays.

The database's counterpart of weights is its tables. Another engine's
store (the JAX reference's, in the parity tests) is read out into numpy
arrays per table: the schema DDL, the physical columns (scaled int64
DECIMALs, int32 dictionary codes for strings, int32 day numbers for
DATEs) with their validity, the MVCC bounds ``_mvcc_ts`` / ``_mvcc_del``
and the string dictionaries. ``store_from_arrays`` rebuilds a store
from them, so both engines scan the same row versions at the same MVCC
timestamps.
"""

from __future__ import annotations

import numpy as np

from ..sql import ast, parser
from ..sql.types import ColumnSchema, TableSchema
from .columnstore import ColumnStore


def schema_from_create(c: ast.CreateTable, table_id: int) -> TableSchema:
    """The TableSchema a parsed CREATE TABLE declares."""
    schema = TableSchema(
        name=c.name,
        columns=[ColumnSchema(d.name, d.type, d.nullable)
                 for d in c.columns],
        primary_key=list(c.primary_key),
        table_id=table_id)
    for i, cs in enumerate(schema.columns):
        cs.cid = i + 1
    return schema


def store_from_arrays(tables: dict[str, dict]) -> ColumnStore:
    """Build a ColumnStore from per-table arrays.

    tables: name -> {
        "ddl": CREATE TABLE text,
        "columns": {column: physical ndarray[n]},
        "valid": {column: bool ndarray[n]} (missing = all valid),
        "mvcc_ts": int64 ndarray[n], "mvcc_del": int64 ndarray[n],
        "dictionaries": {string column: list of values in code order},
        "chunks": [rows of each sealed chunk] (missing = one chunk),
    }
    Each table's rows are cut into the source's sealed chunks (each
    gets its zones, blooms and MVCC window at seal, as the source's
    did, so both engines skip the same pages), then the table is
    ANALYZEd so the planner sees the statistics the source had after
    its ANALYZE.
    """
    store = ColumnStore()
    for name, t in tables.items():
        stmt = parser.parse(t["ddl"])
        if not isinstance(stmt, ast.CreateTable) or stmt.name != name:
            raise ValueError(f"ddl for {name!r} is not its CREATE TABLE")
        schema = schema_from_create(stmt, store.alloc_table_id())
        store.create_table(schema)
        for col, values in t.get("dictionaries", {}).items():
            store.set_dictionary(name, col, values)
        n = len(t["mvcc_ts"])
        data, valid = {}, {}
        for cs in schema.columns:
            arr = np.asarray(t["columns"][cs.name],
                             dtype=cs.type.np_dtype)
            if arr.shape != (n,):
                raise ValueError(f"{name}.{cs.name}: {arr.shape} rows, "
                                 f"MVCC columns have {n}")
            # copies: the store must not alias the caller's arrays
            data[cs.name] = arr.copy()
            v = t.get("valid", {}).get(cs.name)
            valid[cs.name] = (np.ones(n, dtype=bool) if v is None
                              else np.asarray(v, dtype=bool).copy())
        mts = np.asarray(t["mvcc_ts"], dtype=np.int64).copy()
        mdl = np.asarray(t["mvcc_del"], dtype=np.int64).copy()
        sizes = list(t.get("chunks") or [n])
        if sum(sizes) != n:
            raise ValueError(f"{name}: chunks hold {sum(sizes)} rows, "
                             f"MVCC columns have {n}")
        lo = 0
        for k in sizes:
            hi = lo + k
            store.append_chunk(name, {c: a[lo:hi] for c, a in data.items()},
                               {c: a[lo:hi] for c, a in valid.items()},
                               mts[lo:hi], mdl[lo:hi])
            lo = hi
        store.analyze(name)
    return store
