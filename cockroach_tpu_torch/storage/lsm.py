"""The LSM storage engine: WAL + memtable + SST levels.

The analogue of the reference's Pebble engine (pkg/storage/pebble.go
wrapping cockroachdb/pebble): an ordered durable map from EngineKey to
value bytes with engine-level tombstones. Semantics mirrored:

- writes land in a WAL (durability) and the memtable (visibility);
- the memtable flushes to immutable L0 SSTs (sst.py);
- tiered compaction merges L0 runs + L1 into one sorted L1 run,
  dropping shadowed entries and tombstones;
- readers merge memtable -> L0 (newest first) -> L1, first hit wins;
- crash recovery = load MANIFEST-listed SSTs + replay the WAL.

Ephemeral mode (dir=None) keeps everything in memory — the analogue of
storage.NewDefaultInMemForTesting used throughout the reference's
tests.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import Iterator, Optional

from .keys import EngineKey
from .memtable import Memtable
from .sst import SST

_WAL_HDR = struct.Struct("<IBII")  # crc, op, klen, vlen
_OP_PUT, _OP_DEL, _OP_BATCH = 0, 1, 2
_BATCH_ENT = struct.Struct("<BII")  # op, klen, vlen


class LSM:
    def __init__(self, dir: Optional[str] = None,
                 memtable_size: int = 16 << 20,
                 l0_compaction_threshold: int = 4):
        self._lock = threading.RLock()
        self.dir = dir
        self.memtable_size = memtable_size
        self.l0_threshold = l0_compaction_threshold
        self.mem = Memtable()
        self.l0: list[SST] = []   # newest first
        self.l1: Optional[SST] = None
        self._wal = None
        self._wal_seq = 0
        self.stats = {"flushes": 0, "compactions": 0, "wal_replayed": 0}
        if dir is not None:
            os.makedirs(dir, exist_ok=True)
            self._recover()
            self._open_wal()

    # -- write path --------------------------------------------------------
    def put(self, key: EngineKey, value: bytes) -> None:
        with self._lock:
            self._log(_OP_PUT, key, value)
            self.mem.put(key, value)
            self._maybe_flush()

    def delete(self, key: EngineKey) -> None:
        with self._lock:
            self._log(_OP_DEL, key, b"")
            self.mem.put(key, None)
            self._maybe_flush()

    def write_batch(self, ops: list[tuple[EngineKey, Optional[bytes]]]) -> None:
        """Atomic batch apply (pebble.Batch.Commit): the whole batch is
        one framed WAL record, so crash replay applies all of it or
        none (intent meta + provisional value must not tear apart)."""
        with self._lock:
            payload = bytearray()
            for k, v in ops:
                ek = k.encode()
                val = v if v is not None else b""
                op = _OP_PUT if v is not None else _OP_DEL
                payload += _BATCH_ENT.pack(op, len(ek), len(val)) + ek + val
            self._log(_OP_BATCH, None, bytes(payload))
            for k, v in ops:
                self.mem.put(k, v)
            self._maybe_flush()

    def atomic(self) -> threading.RLock:
        """The engine's lock, held across a read-modify-write of several
        calls (it is re-entrant: the calls inside take it again)."""
        return self._lock

    # -- read path ---------------------------------------------------------
    def get(self, key: EngineKey) -> Optional[bytes]:
        with self._lock:
            found, v = self.mem.get(key)
            if found:
                return v
            for sst in self.l0:
                found, v = sst.get(key)
                if found:
                    return v
            if self.l1 is not None:
                found, v = self.l1.get(key)
                if found:
                    return v
            return None

    def get_newest(self, start: EngineKey, end: EngineKey, want=None
                   ) -> Optional[tuple[EngineKey, Optional[bytes]]]:
        """First live merged entry in [start, end): the MVCC
        newest-version point probe. scan() materializes every version
        in the range under the lock before the caller sees one — for
        a hot key carrying V versions that is O(V) per point lookup
        (zipfian OLTP keys reach thousands). This stops at the first
        entry that is not an engine tombstone and passes ``want``."""
        with self._lock:
            sources = [self.mem.iter_range(start, end)]
            sources += [s.iter_range(start, end) for s in self.l0]
            if self.l1 is not None:
                sources.append(self.l1.iter_range(start, end))
            for k, v in _merge(sources):
                if v is None:
                    continue
                if want is not None and not want(k):
                    continue
                return k, v
        return None

    def scan(self, start: EngineKey, end: Optional[EngineKey] = None,
             include_tombstones: bool = False
             ) -> Iterator[tuple[EngineKey, Optional[bytes]]]:
        """Merged ordered iteration; newest source wins per EngineKey."""
        with self._lock:
            sources = [self.mem.iter_range(start, end)]
            sources += [s.iter_range(start, end) for s in self.l0]
            if self.l1 is not None:
                sources.append(self.l1.iter_range(start, end))
            # materialize under the lock: the memtable iterator is
            # invalidated by concurrent writes
            items = list(_merge(sources))
        for k, v in items:
            if v is None and not include_tombstones:
                continue
            yield k, v

    # -- maintenance -------------------------------------------------------
    def _maybe_flush(self):
        if self.mem.size_bytes >= self.memtable_size:
            self.flush()

    def flush(self) -> None:
        """Memtable -> new L0 SST; resets the WAL."""
        with self._lock:
            entries = self.mem.entries()
            if not entries:
                return
            sst = SST(entries)
            if self.dir is not None:
                path = os.path.join(self.dir,
                                    f"{self._next_file_num():06d}.sst")
                sst.write(path)
            self.l0.insert(0, sst)
            self.mem = Memtable()
            self.stats["flushes"] += 1
            if self.dir is not None:
                self._write_manifest()
                self._reset_wal()
            if len(self.l0) >= self.l0_threshold:
                self.compact()

    def compact(self) -> None:
        """Merge all L0 runs + L1 into one L1 run. Shadowed versions and
        tombstones are dropped (engine-level GC; MVCC GC is a layer up)."""
        with self._lock:
            sources = [s.entries() for s in self.l0]
            if self.l1 is not None:
                sources.append(self.l1.entries())
            merged = [(k, v) for k, v in _merge(sources) if v is not None]
            old = [s.path for s in self.l0 + ([self.l1] if self.l1 else [])
                   if s.path]
            self.l1 = SST(merged) if merged else None
            self.l0 = []
            if self.dir is not None and self.l1 is not None:
                self.l1.write(os.path.join(
                    self.dir, f"{self._next_file_num():06d}.sst"))
            self.stats["compactions"] += 1
            if self.dir is not None:
                self._write_manifest()
                for p in old:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass

    def close(self) -> None:
        with self._lock:
            if self._wal is not None:
                self._wal.close()
                self._wal = None

    # -- durability --------------------------------------------------------
    def _open_wal(self):
        self._wal_path = os.path.join(self.dir, "WAL")
        self._wal = open(self._wal_path, "ab")

    def _reset_wal(self):
        if self._wal is not None:
            self._wal.close()
        open(self._wal_path, "wb").close()
        self._wal = open(self._wal_path, "ab")

    def _log(self, op: int, key: Optional[EngineKey], value: bytes) -> None:
        if self.dir is None or self._wal is None:
            return
        ek = key.encode() if key is not None else b""
        payload = ek + value
        crc = zlib.crc32(bytes([op]) + payload)
        self._wal.write(_WAL_HDR.pack(crc, op, len(ek), len(value)) + payload)
        self._wal.flush()

    def _next_file_num(self) -> int:
        self._wal_seq += 1
        return self._wal_seq

    def _write_manifest(self):
        files = [os.path.basename(s.path) for s in self.l0 if s.path]
        l1 = os.path.basename(self.l1.path) if self.l1 and self.l1.path else None
        tmp = os.path.join(self.dir, "MANIFEST.tmp")
        with open(tmp, "w") as f:
            json.dump({"l0": files, "l1": l1, "seq": self._wal_seq}, f)
        os.replace(tmp, os.path.join(self.dir, "MANIFEST"))

    def _recover(self):
        man = os.path.join(self.dir, "MANIFEST")
        if os.path.exists(man):
            with open(man) as f:
                m = json.load(f)
            self._wal_seq = m.get("seq", 0)
            self.l0 = [SST.load(os.path.join(self.dir, p)) for p in m["l0"]]
            if m.get("l1"):
                self.l1 = SST.load(os.path.join(self.dir, m["l1"]))
        wal = os.path.join(self.dir, "WAL")
        if os.path.exists(wal):
            with open(wal, "rb") as f:
                raw = f.read()
            off = 0
            while off + _WAL_HDR.size <= len(raw):
                crc, op, klen, vlen = _WAL_HDR.unpack_from(raw, off)
                off += _WAL_HDR.size
                if off + klen + vlen > len(raw):
                    break  # torn tail write
                ek = raw[off: off + klen]
                val = raw[off + klen: off + klen + vlen]
                off += klen + vlen
                if zlib.crc32(bytes([op]) + ek + val) != crc:
                    break  # corrupt tail
                if op == _OP_BATCH:
                    for k, v in self._decode_batch(val):
                        self.mem.put(k, v)
                else:
                    key = EngineKey.decode(ek)
                    self.mem.put(key, val if op == _OP_PUT else None)
                self.stats["wal_replayed"] += 1

    @staticmethod
    def _decode_batch(payload: bytes
                      ) -> list[tuple[EngineKey, Optional[bytes]]]:
        ops = []
        off = 0
        while off + _BATCH_ENT.size <= len(payload):
            op, klen, vlen = _BATCH_ENT.unpack_from(payload, off)
            off += _BATCH_ENT.size
            ek = payload[off: off + klen]
            val = payload[off + klen: off + klen + vlen]
            off += klen + vlen
            ops.append((EngineKey.decode(ek),
                        val if op == _OP_PUT else None))
        return ops


def _merge(sources: list) -> Iterator[tuple[EngineKey, Optional[bytes]]]:
    """K-way merge, newest source first; emits each EngineKey once with
    the newest source's value (the LSM read rule)."""
    import heapq

    heap: list = []
    for prio, it in enumerate(sources):
        it = iter(it)
        for k, v in it:
            heap.append((k, prio, v, it))
            break
    heapq.heapify(heap)
    last: Optional[EngineKey] = None
    while heap:
        k, prio, v, it = heapq.heappop(heap)
        if last is None or k != last:
            yield k, v
            last = k
        for nk, nv in it:
            heapq.heappush(heap, (nk, prio, nv, it))
            break
