"""Immutable sorted string tables (SSTs) with a binary on-disk format.

The persistence unit of the LSM engine (storage/lsm.py), mirroring
Pebble's sstables at the semantic level: an SST is a sorted run of
(EngineKey, value|tombstone) entries, immutable once written, merged
away by compaction.

On-disk format (little-endian):

    magic "CTSST1\\0\\0" | u32 count | u32 reserved
    u64 key_blob_len   | key_blob   (concatenated encoded EngineKeys)
    u64 val_blob_len   | val_blob   (concatenated values)
    count * (u32 key_off, u32 key_len, u32 val_off, u32 val_len, u8 flags)
    u64 crc32 of everything above

flags bit0 = tombstone. Readers mmap-free: the whole table loads into
numpy offset arrays; key lookup is binary search over the encoded-key
blob (encoded EngineKeys compare bytewise in logical order, keys.py).
"""

from __future__ import annotations

import bisect
import struct
import zlib
from typing import Iterator, Optional

from .keys import EngineKey

_MAGIC = b"CTSST1\x00\x00"
_IDX = struct.Struct("<IIIIB")


class SST:
    def __init__(self, entries: list[tuple[EngineKey, Optional[bytes]]],
                 path: Optional[str] = None):
        self._ekeys: list[bytes] = [k.encode() for k, _ in entries]
        self._vals: list[Optional[bytes]] = [v for _, v in entries]
        self.path = path
        self.smallest = entries[0][0] if entries else None
        self.largest = entries[-1][0] if entries else None

    def __len__(self):
        return len(self._ekeys)

    # -- point lookup ------------------------------------------------------
    def _bisect(self, ek: bytes) -> int:
        return bisect.bisect_left(self._ekeys, ek)

    def get(self, key: EngineKey):
        """Returns (found, value)."""
        ek = key.encode()
        i = self._bisect(ek)
        if i < len(self._ekeys) and self._ekeys[i] == ek:
            return True, self._vals[i]
        return False, None

    def iter_range(self, start: EngineKey,
                   end: Optional[EngineKey] = None
                   ) -> Iterator[tuple[EngineKey, Optional[bytes]]]:
        i = self._bisect(start.encode())
        eend = end.encode() if end is not None else None
        while i < len(self._ekeys):
            ek = self._ekeys[i]
            if eend is not None and ek >= eend:
                return
            yield EngineKey.decode(ek), self._vals[i]
            i += 1

    def entries(self) -> Iterator[tuple[EngineKey, Optional[bytes]]]:
        for ek, v in zip(self._ekeys, self._vals):
            yield EngineKey.decode(ek), v

    # -- persistence -------------------------------------------------------
    def write(self, path: str) -> None:
        key_blob = b"".join(self._ekeys)
        val_parts = []
        idx = bytearray()
        koff = voff = 0
        for ek, v in zip(self._ekeys, self._vals):
            flags = 0 if v is not None else 1
            vlen = len(v) if v is not None else 0
            idx += _IDX.pack(koff, len(ek), voff, vlen, flags)
            koff += len(ek)
            if v is not None:
                val_parts.append(v)
                voff += vlen
        val_blob = b"".join(val_parts)
        body = (_MAGIC + struct.pack("<II", len(self._ekeys), 0)
                + struct.pack("<Q", len(key_blob)) + key_blob
                + struct.pack("<Q", len(val_blob)) + val_blob
                + bytes(idx))
        with open(path, "wb") as f:
            f.write(body)
            f.write(struct.pack("<Q", zlib.crc32(body)))
        self.path = path

    @staticmethod
    def load(path: str) -> "SST":
        with open(path, "rb") as f:
            raw = f.read()
        body, (crc,) = raw[:-8], struct.unpack("<Q", raw[-8:])
        if zlib.crc32(body) != crc:
            raise IOError(f"SST checksum mismatch: {path}")
        if body[:8] != _MAGIC:
            raise IOError(f"bad SST magic: {path}")
        count, _ = struct.unpack_from("<II", body, 8)
        off = 16
        (kb_len,) = struct.unpack_from("<Q", body, off)
        off += 8
        key_blob = body[off: off + kb_len]
        off += kb_len
        (vb_len,) = struct.unpack_from("<Q", body, off)
        off += 8
        val_blob = body[off: off + vb_len]
        off += vb_len
        sst = SST.__new__(SST)
        sst._ekeys = []
        sst._vals = []
        for i in range(count):
            ko, kl, vo, vl, flags = _IDX.unpack_from(body, off + i * _IDX.size)
            sst._ekeys.append(key_blob[ko: ko + kl])
            sst._vals.append(None if flags & 1 else val_blob[vo: vo + vl])
        sst.path = path
        sst.smallest = EngineKey.decode(sst._ekeys[0]) if count else None
        sst.largest = EngineKey.decode(sst._ekeys[-1]) if count else None
        return sst
