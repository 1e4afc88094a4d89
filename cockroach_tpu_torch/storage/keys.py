"""Order-preserving key encodings and the keyspace layout.

The analogue of the reference's pkg/keys (keyspace layout) and
pkg/util/encoding (order-preserving scalar encodings used by
pkg/sql/rowenc to map SQL rows onto KV keys). Everything here is
host-side: keys exist for the row-oriented KV plane (point reads,
writes, replication); the analytic scan plane reads columns directly
(storage/columnstore.py) and never decodes keys — the lesson of the
reference's direct columnar scans (pkg/storage/col_mvcc.go) taken to
its conclusion.

Layout (mirrors pkg/keys/constants.go):

    /Min .. /Meta2/..   range addressing (distribution layer)
    /System/..          liveness, settings
    /Table/<id>/<index>/<pk...>  user data

MVCC keys sort (user_key ASC, timestamp DESC), with the bare metadata
key (intent marker) before all versioned keys — the Pebble comparator
contract (pkg/storage/engine_key.go): encoded as key + 0x00 + suffix,
where suffix is empty for meta and an 8-byte big-endian *inverted*
timestamp for versions.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from .hlc import Timestamp

# ---------------------------------------------------------------------------
# scalar encodings (order-preserving, pkg/util/encoding analogue)
# ---------------------------------------------------------------------------

_INT_OFFSET = 1 << 63  # map int64 -> uint64 preserving order


def encode_int(buf: bytearray, v: int) -> None:
    """8-byte big-endian with sign offset: sorts like the integer."""
    buf += struct.pack(">Q", (v + _INT_OFFSET) & 0xFFFFFFFFFFFFFFFF)


def encode_int_keys(prefix: bytes, cols: list) -> list[bytes]:
    """Many keys at once: ``prefix`` followed by encode_int of each
    column's value, row by row, for int64 columns of equal length. The
    bulk form of table_key over int-family primary keys (a numpy pass
    instead of a Python loop per row); its bytes equal encode_int's."""
    import numpy as np
    n = len(cols[0]) if cols else 0
    if n == 0:
        return []
    words = [(np.asarray(c).astype(np.int64).view(np.uint64)
              ^ np.uint64(_INT_OFFSET)).astype(">u8").view(np.uint8)
             .reshape(n, 8) for c in cols]
    head = np.frombuffer(prefix, dtype=np.uint8)
    out = np.concatenate([np.broadcast_to(head, (n, len(head)))] + words,
                         axis=1)
    stride = out.shape[1]
    raw = np.ascontiguousarray(out).tobytes()
    return [raw[i:i + stride] for i in range(0, n * stride, stride)]


def decode_int(b: bytes, off: int) -> tuple[int, int]:
    (u,) = struct.unpack_from(">Q", b, off)
    return u - _INT_OFFSET, off + 8


def encode_float(buf: bytearray, v: float) -> None:
    """IEEE754 big-endian with sign-dependent bit flip (the standard
    order-preserving float trick, encoding/float.go)."""
    (u,) = struct.unpack(">Q", struct.pack(">d", v))
    u = u ^ 0xFFFFFFFFFFFFFFFF if u & (1 << 63) else u | (1 << 63)
    buf += struct.pack(">Q", u)


def decode_float(b: bytes, off: int) -> tuple[float, int]:
    (u,) = struct.unpack_from(">Q", b, off)
    u = u ^ (1 << 63) if u & (1 << 63) else u ^ 0xFFFFFFFFFFFFFFFF
    return struct.unpack(">d", struct.pack(">Q", u))[0], off + 8


_ESCAPE = b"\x00\xff"
_TERM = b"\x00\x01"


def encode_bytes(buf: bytearray, v: bytes) -> None:
    """0x00-escaped + terminated: preserves prefix ordering
    (encoding/bytes.go EncodeBytesAscending)."""
    buf += v.replace(b"\x00", _ESCAPE)
    buf += _TERM


def decode_bytes(b: bytes, off: int) -> tuple[bytes, int]:
    out = bytearray()
    i = off
    while True:
        j = b.index(b"\x00", i)
        out += b[i:j]
        nxt = b[j + 1]
        if nxt == 0x01:
            return bytes(out), j + 2
        if nxt == 0xFF:
            out += b"\x00"
            i = j + 2
        else:
            raise ValueError(f"corrupt bytes encoding at {j}")


def encode_str(buf: bytearray, v: str) -> None:
    encode_bytes(buf, v.encode("utf-8"))


# ---------------------------------------------------------------------------
# keyspace layout
# ---------------------------------------------------------------------------

MIN_KEY = b""
MAX_KEY = b"\xff\xff"
META_PREFIX = b"\x02meta"     # range addressing records
SYSTEM_PREFIX = b"\x03sys"    # liveness, settings, jobs
TABLE_PREFIX = b"\x04tbl"     # user table data


def table_prefix(table_id: int, index_id: int = 1) -> bytes:
    buf = bytearray(TABLE_PREFIX)
    encode_int(buf, table_id)
    encode_int(buf, index_id)
    return bytes(buf)


def table_key(table_id: int, pk_vals: tuple, index_id: int = 1) -> bytes:
    """Encode /Table/<id>/<index>/<pk...> (rowenc.EncodeIndexKey)."""
    buf = bytearray(table_prefix(table_id, index_id))
    for v in pk_vals:
        if isinstance(v, bool):
            encode_int(buf, int(v))
        elif isinstance(v, int):
            encode_int(buf, v)
        elif isinstance(v, float):
            encode_float(buf, v)
        elif isinstance(v, str):
            encode_str(buf, v)
        elif isinstance(v, bytes):
            encode_bytes(buf, v)
        else:
            raise TypeError(f"unencodable pk value {v!r}")
    return bytes(buf)


def system_key(name: str, *parts) -> bytes:
    buf = bytearray(SYSTEM_PREFIX)
    encode_str(buf, name)
    for p in parts:
        if isinstance(p, int):
            encode_int(buf, p)
        else:
            encode_str(buf, str(p))
    return bytes(buf)


def next_key(key: bytes) -> bytes:
    """Smallest key greater than every key with prefix `key`."""
    return key + b"\x00"


def prefix_end(prefix: bytes) -> bytes:
    """End of the keyspace covered by `prefix` (PrefixEnd)."""
    b = bytearray(prefix)
    for i in reversed(range(len(b))):
        if b[i] != 0xFF:
            b[i] += 1
            return bytes(b[: i + 1])
    return MAX_KEY


# ---------------------------------------------------------------------------
# MVCC (engine) keys
# ---------------------------------------------------------------------------

_MAX_U64 = (1 << 64) - 1


@dataclass(frozen=True, order=True)
class EngineKey:
    """Comparable (user_key, version) pair. inv_ts orders newer
    versions first; -1 is the bare metadata (intent) position, which
    sorts before every version of the same key."""
    key: bytes
    inv_ts: int  # -1 = meta; else _MAX_U64 - ts_int

    @staticmethod
    def meta(key: bytes) -> "EngineKey":
        return EngineKey(key, -1)

    @staticmethod
    def versioned(key: bytes, ts: Timestamp) -> "EngineKey":
        return EngineKey(key, _MAX_U64 - ts.to_int())

    @property
    def is_meta(self) -> bool:
        return self.inv_ts < 0

    @property
    def ts(self) -> Timestamp:
        assert not self.is_meta
        return Timestamp.from_int(_MAX_U64 - self.inv_ts)

    def encode(self) -> bytes:
        """Wire/SST form: escaped key + 0x00 + optional 8-byte suffix.
        Byte comparison of encodings == tuple comparison of (key,
        inv_ts) because the escape keeps 0x00-freedom in the body."""
        buf = bytearray()
        encode_bytes(buf, self.key)
        if not self.is_meta:
            buf += struct.pack(">Q", self.inv_ts)
        return bytes(buf)

    @staticmethod
    def decode(b: bytes) -> "EngineKey":
        key, off = decode_bytes(b, 0)
        if off == len(b):
            return EngineKey(key, -1)
        (inv,) = struct.unpack_from(">Q", b, off)
        return EngineKey(key, inv)


MIN_ENGINE_KEY = EngineKey(MIN_KEY, -1)
