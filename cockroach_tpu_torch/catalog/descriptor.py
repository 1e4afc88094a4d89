"""Table descriptors: the serialized schema record.

The analogue of descpb.TableDescriptor (pkg/sql/catalog/descpb): a
versioned, state-carrying schema object. Columns carry a state so a
schema change can add a column in DELETE_AND_WRITE_ONLY before it
becomes PUBLIC (the two-step of the reference's schema changer);
readers only see PUBLIC columns.

Serialization is JSON (the reference uses protobuf; the wire format is
an implementation detail — what matters is that descriptors round-trip
through the KV plane byte-exactly and carry their version).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from ..sql.types import ColumnSchema, Family, SQLType, TableSchema

PUBLIC = "public"
WRITE_ONLY = "write_only"    # writes include it, reads don't see it
DROPPED = "dropped"


@dataclass
class ColumnDescriptor:
    name: str
    type: SQLType
    nullable: bool = True
    state: str = PUBLIC
    default: object = None  # constant backfill value
    # stable per-table column id tagging value-side KV payloads
    # (descpb.ColumnDescriptor.ID): survives DROP + re-ADD of a name
    # with a different type without rewriting stored rows
    col_id: int = 0


@dataclass
class IndexDescriptor:
    """A secondary index (the analogue of descpb.IndexDescriptor).

    ``index_id`` numbers the index's keyspace under the table prefix
    (primary is 1, like the reference); unique indexes materialize KV
    entries at /Table/<tid>/<index_id>/<vals> so concurrent writers
    of the same value conflict transactionally. Non-unique indexes
    are scan-plane accelerators only (rebuilt lazily per generation,
    storage/columnstore.py ensure_secondary_index)."""
    name: str
    index_id: int
    columns: list = field(default_factory=list)
    unique: bool = False
    state: str = PUBLIC


@dataclass
class TableDescriptor:
    id: int
    name: str
    version: int = 1
    columns: list[ColumnDescriptor] = field(default_factory=list)
    primary_key: list[str] = field(default_factory=list)
    state: str = PUBLIC  # table-level: public | dropped
    indexes: list[IndexDescriptor] = field(default_factory=list)
    # views: the body SQL text; re-planned (expanded as a derived
    # table) at each use, like the reference's view descriptors
    # (pkg/sql/create_view.go stores the rewritten query text)
    view_sql: str = ""
    view_columns: list = field(default_factory=list)  # output renames
    # CHECK constraints: [{"name", "expr_sql"}] — re-bound at each
    # DML against the live schema (pkg/sql/catalog descpb checks)
    checks: list = field(default_factory=list)
    # FOREIGN KEYs (RESTRICT): [{"name", "columns", "ref_table",
    # "ref_columns"}]
    fks: list = field(default_factory=list)
    # next col_id to allocate (never reused, like descpb NextColumnID)
    next_col_id: int = 1

    def allocate_col_ids(self) -> None:
        for c in self.columns:
            if c.col_id == 0:
                c.col_id = self.next_col_id
                self.next_col_id += 1

    # -- schema views -------------------------------------------------------
    def public_schema(self) -> TableSchema:
        """What readers/planners see: PUBLIC columns only."""
        return TableSchema(
            name=self.name,
            columns=[ColumnSchema(c.name, c.type, c.nullable,
                                  cid=c.col_id, default=c.default)
                     for c in self.columns if c.state == PUBLIC],
            primary_key=list(self.primary_key),
            table_id=self.id)

    def column(self, name: str) -> ColumnDescriptor:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    # -- serde --------------------------------------------------------------
    def encode(self) -> bytes:
        return json.dumps({
            "id": self.id,
            "name": self.name,
            "version": self.version,
            "state": self.state,
            "primary_key": self.primary_key,
            "columns": [{
                "name": c.name,
                "type": _enc_type(c.type),
                "nullable": c.nullable,
                "state": c.state,
                "default": c.default,
                "col_id": c.col_id,
            } for c in self.columns],
            "indexes": [{
                "name": i.name,
                "index_id": i.index_id,
                "columns": list(i.columns),
                "unique": i.unique,
                "state": i.state,
            } for i in self.indexes],
            "view_sql": self.view_sql,
            "view_columns": list(self.view_columns),
            "checks": list(self.checks),
            "fks": list(self.fks),
            "next_col_id": self.next_col_id,
        }).encode()

    @classmethod
    def decode(cls, raw: bytes) -> "TableDescriptor":
        o = json.loads(raw.decode())
        return cls(
            id=o["id"], name=o["name"], version=o["version"],
            state=o["state"], primary_key=list(o["primary_key"]),
            columns=[ColumnDescriptor(
                c["name"], _dec_type(c["type"]), c["nullable"],
                c["state"], c.get("default"),
                col_id=c.get("col_id", 0)) for c in o["columns"]],
            indexes=[IndexDescriptor(
                i["name"], i["index_id"], list(i["columns"]),
                i["unique"], i["state"])
                for i in o.get("indexes", [])],
            view_sql=o.get("view_sql", ""),
            view_columns=list(o.get("view_columns", [])),
            checks=list(o.get("checks", [])),
            fks=list(o.get("fks", [])),
            next_col_id=o.get("next_col_id", 1))

    @classmethod
    def from_schema(cls, schema: TableSchema) -> "TableDescriptor":
        # preserve stable column ids the schema already carries (e.g.
        # RESTORE re-registering a backed-up table whose KV rows are
        # tagged with the original ids); allocate only for the rest
        d = cls(
            id=schema.table_id, name=schema.name,
            columns=[ColumnDescriptor(c.name, c.type, c.nullable,
                                      col_id=getattr(c, "cid", 0),
                                      default=getattr(c, "default", None))
                     for c in schema.columns],
            primary_key=list(schema.primary_key))
        d.next_col_id = 1 + max(
            (c.col_id for c in d.columns), default=0)
        d.allocate_col_ids()
        return d


def _enc_type(t: SQLType) -> dict:
    out = {"family": t.family.value, "width": t.width,
           "precision": t.precision, "scale": t.scale}
    if t.elem is not None:           # ARRAY element type
        out["elem"] = _enc_type(t.elem)
    return out


def _dec_type(o: dict) -> SQLType:
    return SQLType(Family(o["family"]), width=o["width"],
                   precision=o["precision"], scale=o["scale"],
                   elem=_dec_type(o["elem"]) if "elem" in o else None)
