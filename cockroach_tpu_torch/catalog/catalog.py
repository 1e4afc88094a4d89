"""Catalog: transactional descriptor storage over the KV plane.

The analogue of the reference's descs.Collection + system.descriptor /
system.namespace tables (pkg/sql/catalog/descs): descriptors live at
/desc/<id>, the name index at /nsp/<name> -> id, and every mutation is
a KV transaction — so concurrent CREATEs of the same name conflict on
the namespace key exactly like the reference's two-writer case.
"""

from __future__ import annotations

from typing import Optional

from .descriptor import DROPPED, TableDescriptor

DESC_PREFIX = b"/desc/"
NSP_PREFIX = b"/nsp/"
ID_SEQ_KEY = b"/desc_id_seq"


class CatalogError(Exception):
    pass


def desc_key(desc_id: int) -> bytes:
    return DESC_PREFIX + str(desc_id).zfill(8).encode()


def nsp_key(name: str) -> bytes:
    return NSP_PREFIX + name.encode()


class Catalog:
    """Descriptor reads/writes through kv.DB transactions.

    ``id_floor`` gives the least id a new descriptor may take: the
    column store's next table id, so a table carried into the store
    without a descriptor never shares its keyspace with a CREATEd one.
    """

    def __init__(self, kv, id_floor=None):
        self.kv = kv
        self._id_floor = id_floor or (lambda: 0)

    # -- id allocation -------------------------------------------------------
    def _next_id(self, t) -> int:
        raw = t.get(ID_SEQ_KEY)
        nxt = max((int(raw.decode()) if raw else 100) + 1,
                  self._id_floor())
        t.put(ID_SEQ_KEY, str(nxt).encode())
        return nxt

    # -- mutations -----------------------------------------------------------
    def create_table(self, desc: TableDescriptor) -> TableDescriptor:
        """Write a new descriptor + namespace entry; errors if the name
        exists. desc.id == 0 allocates an id."""
        def fn(t):
            if t.get(nsp_key(desc.name)) is not None:
                raise CatalogError(
                    f"table {desc.name!r} already exists")
            if desc.id == 0:
                desc.id = self._next_id(t)
            desc.version = 1
            t.put(nsp_key(desc.name), str(desc.id).encode())
            t.put(desc_key(desc.id), desc.encode())
            return desc
        return self.kv.txn(fn)

    def drop_table(self, name: str) -> TableDescriptor:
        """Mark dropped + remove the namespace entry (readers holding
        leases still resolve the descriptor by id until they drain)."""
        def fn(t):
            d = self._must_get_by_name(t, name)
            d.state = DROPPED
            d.version += 1
            t.delete(nsp_key(name))
            t.put(desc_key(d.id), d.encode())
            return d
        return self.kv.txn(fn)

    def write_new_version(self, desc: TableDescriptor) -> TableDescriptor:
        """Publish ``desc`` at version+1 (one schema-change step); the
        caller then waits for old leases (LeaseManager.wait_one_version).
        A writer holding a stale copy fails with "version skew"."""
        def fn(t):
            cur_raw = t.get(desc_key(desc.id))
            if cur_raw is None:
                raise CatalogError(f"descriptor {desc.id} missing")
            cur = TableDescriptor.decode(cur_raw)
            if cur.version != desc.version:
                raise CatalogError(
                    f"version skew on {desc.name!r}: have "
                    f"{desc.version}, stored {cur.version}")
            desc.version += 1
            t.put(desc_key(desc.id), desc.encode())
            return desc
        return self.kv.txn(fn)

    # -- reads ---------------------------------------------------------------
    def get_by_name(self, name: str) -> Optional[TableDescriptor]:
        def fn(t):
            raw = t.get(nsp_key(name))
            if raw is None:
                return None
            d = t.get(desc_key(int(raw.decode())))
            return TableDescriptor.decode(d) if d is not None else None
        return self.kv.txn(fn)

    def get_by_id(self, desc_id: int) -> Optional[TableDescriptor]:
        def fn(t):
            raw = t.get(desc_key(desc_id))
            return TableDescriptor.decode(raw) if raw is not None else None
        return self.kv.txn(fn)

    def list_tables(self) -> list[TableDescriptor]:
        def fn(t):
            out = []
            for _k, v in t.scan(DESC_PREFIX, DESC_PREFIX + b"\xff"):
                d = TableDescriptor.decode(v)
                if d.state != DROPPED:
                    out.append(d)
            return out
        return self.kv.txn(fn)

    def _must_get_by_name(self, t, name: str) -> TableDescriptor:
        raw = t.get(nsp_key(name))
        if raw is None:
            raise CatalogError(f"table {name!r} does not exist")
        d = t.get(desc_key(int(raw.decode())))
        if d is None:
            raise CatalogError(f"dangling namespace entry for {name!r}")
        return TableDescriptor.decode(d)
