"""Row <-> KV encoding: SQL rows mapped onto the transactional KV plane.

The analogue of the reference's ``pkg/sql/rowenc`` (index key encoding,
``EncodeIndexKey``) and the value side of ``pkg/sql/row`` writers. Every
table row has exactly one KV pair on primary index 1:

    key   = /Table/<id>/1/<pk cols...>      (order-preserving, keys.py)
    value = null-bitmap + packed non-pk column values

Tables with no declared PRIMARY KEY get a hidden ``rowid`` key column
(the reference synthesizes a ``rowid INT DEFAULT unique_rowid()``
column the same way, pkg/sql/catalog/tabledesc). Rowids are allocated
by the storage layer (storage/columnstore.py) and threaded through
here as ``row["__rowid__"]``.

Values are "storage-logical": STRING columns travel as UTF-8 strings
(dictionary codes are store-local and must not leak into the
replicated KV plane); DECIMAL/DATE/TIMESTAMP are their physical int
forms (scaled int, epoch days, epoch micros) exactly as the column
store holds them.
"""

from __future__ import annotations

import struct

from ..storage import keys
from .types import Family, TableSchema

ROWID = "__rowid__"


class RowCodec:
    """Encode/decode rows of one table schema to KV pairs."""

    def __init__(self, schema: TableSchema):
        self.schema = schema
        self.table_id = schema.table_id
        self.pk_cols = list(schema.primary_key)
        self.synthetic_pk = not self.pk_cols
        # value columns: everything not in the pk (pk is recoverable
        # from the key; the reference likewise omits key cols from the
        # value, rowenc/valueside)
        self.value_cols = [c for c in schema.columns
                           if c.name not in self.pk_cols]
        # precomputed wire tags (decode_value is the per-row hot path)
        self._tag_of = {
            c.name: ((b"#%d" % c.cid) if getattr(c, "cid", 0)
                     else c.name.encode("utf-8"))
            for c in self.value_cols}
        self._col_by_tag = {t.decode("utf-8"): self.schema.column(n)
                            for n, t in self._tag_of.items()}

    # -- spans -------------------------------------------------------------
    def span(self) -> tuple[bytes, bytes]:
        p = keys.table_prefix(self.table_id)
        return p, keys.prefix_end(p)

    # -- keys --------------------------------------------------------------
    def pk_values(self, row: dict) -> tuple:
        if self.synthetic_pk:
            return (int(row[ROWID]),)
        return tuple(row[c] for c in self.pk_cols)

    def key(self, row: dict) -> bytes:
        return keys.table_key(self.table_id, self.pk_values(row))

    def key_from_pk(self, pk_vals: tuple) -> bytes:
        return keys.table_key(self.table_id, pk_vals)

    # -- values ------------------------------------------------------------
    # Self-describing tagged encoding: each present (non-null) column
    # is written as [tag_len:u8][tag][payload_len:u32][payload].
    # Absent columns decode as NULL, unknown tags are skipped — so
    # rows written under an older schema version decode correctly
    # after ADD/DROP COLUMN without a KV rewrite, exactly why the
    # reference tags value-side datums with column ids
    # (pkg/sql/rowenc/valueside/encode.go). The tag is the stable
    # catalog column id ("#<cid>") when the schema carries one —
    # immune to DROP + re-ADD of a name with a different type — and
    # the column name for catalog-less schemas (tests, bulk loaders).
    def encode_value(self, row: dict) -> bytes:
        buf = bytearray()
        n = 0
        for c in self.value_cols:
            v = row.get(c.name)
            if v is None:
                continue
            f = c.type.family
            if f == Family.BOOL:
                payload = struct.pack(">B", 1 if v else 0)
            elif f == Family.FLOAT:
                payload = struct.pack(">d", float(v))
            elif f in (Family.STRING, Family.BYTES, Family.ARRAY,
                       Family.JSON):
                # datum families store their canonical text
                payload = v.encode("utf-8") if isinstance(v, str) \
                    else bytes(v)
            else:  # INT / DECIMAL / DATE / TIMESTAMP / INTERVAL: int64
                payload = struct.pack(">q", int(v))
            tag = self._tag_of[c.name]
            buf += struct.pack(">B", len(tag)) + tag
            buf += struct.pack(">I", len(payload)) + payload
            n += 1
        return struct.pack(">H", n) + bytes(buf)

    def decode_value(self, b: bytes) -> dict:
        row: dict = {c.name: None for c in self.value_cols}
        (n,) = struct.unpack_from(">H", b, 0)
        off = 2
        by_tag = self._col_by_tag
        for _ in range(n):
            nl = b[off]
            off += 1
            tag = b[off:off + nl].decode("utf-8")
            off += nl
            (pl,) = struct.unpack_from(">I", b, off)
            off += 4
            payload = b[off:off + pl]
            off += pl
            c = by_tag.get(tag)
            if c is None:
                continue   # column dropped since this row was written
            f = c.type.family
            if f == Family.BOOL:
                row[c.name] = bool(payload[0])
            elif f == Family.FLOAT:
                (row[c.name],) = struct.unpack(">d", payload)
            elif f in (Family.STRING, Family.ARRAY, Family.JSON):
                row[c.name] = payload.decode("utf-8")
            elif f == Family.BYTES:
                row[c.name] = payload
            else:
                (row[c.name],) = struct.unpack(">q", payload)
        return row

    def decode_key(self, key: bytes) -> tuple:
        """Recover pk values from an encoded table key."""
        prefix = keys.table_prefix(self.table_id)
        if not key.startswith(prefix):
            raise ValueError(f"key {key!r} not in table {self.table_id}")
        off = len(prefix)
        out = []
        cols = ([None] if self.synthetic_pk
                else [self.schema.column(c) for c in self.pk_cols])
        for c in cols:
            fam = Family.INT if c is None else c.type.family
            if fam in (Family.STRING, Family.BYTES):
                v, off = keys.decode_bytes(key, off)
                out.append(v.decode("utf-8") if fam == Family.STRING else v)
            elif fam == Family.FLOAT:
                v, off = keys.decode_float(key, off)
                out.append(v)
            else:
                v, off = keys.decode_int(key, off)
                out.append(v)
        return tuple(out)

    def decode_row(self, key: bytes, value: bytes) -> dict:
        """Full row from a KV pair (pk cols from the key, rest from the
        value) — the cFetcher decode contract, colfetcher/cfetcher.go:668."""
        row = self.decode_value(value)
        pk = self.decode_key(key)
        if self.synthetic_pk:
            row[ROWID] = pk[0]
        else:
            for name, v in zip(self.pk_cols, pk):
                row[name] = v
        return row
