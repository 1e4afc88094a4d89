"""Columnar wire format: host column dicts <-> bytes
(cockroach_tpu/distsql/serde.py; the bytes are the reference's, byte for
byte, for the same numpy input).

The role of ``pkg/col/colserde`` (ArrowBatchConverter +
RecordBatchSerializer, arrowbatchconverter.go:49): batches crossing a
host boundary are serialized as a self-describing header plus raw
little-endian column buffers, so the receiver reconstructs numpy
arrays without copies beyond the frombuffer view. Layout:

    magic "CTB1" | u32 header_len | header JSON | buffer bytes...

Header: {"n": rows, "cols": [{"name", "dtype", "nbytes"}...]}; buffers
appear in header order: per column the data buffer then a packed
uint8 validity buffer. The selection mask rides as column "__sel".
(pyarrow is not in the image, so the framing is Arrow-IPC-inspired
rather than Arrow-IPC-compatible; the schema maps 1:1 if we swap the
container later.)
"""

from __future__ import annotations

import json
import struct

import numpy as np

MAGIC = b"CTB1"


def encode_columns(n: int, cols: dict[str, np.ndarray],
                   valid: dict[str, np.ndarray]) -> bytes:
    header = {"n": n, "cols": []}
    buffers: list[bytes] = []
    for name, arr in cols.items():
        arr = np.ascontiguousarray(arr)
        v = np.ascontiguousarray(
            valid.get(name, np.ones(n, dtype=bool)).astype(np.uint8))
        header["cols"].append({"name": name, "dtype": arr.dtype.str,
                               "nbytes": arr.nbytes})
        buffers.append(arr.tobytes())
        buffers.append(v.tobytes())
    hj = json.dumps(header).encode()
    return b"".join([MAGIC, struct.pack("<I", len(hj)), hj] + buffers)


def decode_columns(raw: bytes) -> tuple[int, dict[str, np.ndarray],
                                        dict[str, np.ndarray]]:
    if raw[:4] != MAGIC:
        raise ValueError("bad batch frame magic")
    (hlen,) = struct.unpack_from("<I", raw, 4)
    header = json.loads(raw[8:8 + hlen].decode())
    n = header["n"]
    off = 8 + hlen
    cols: dict[str, np.ndarray] = {}
    valid: dict[str, np.ndarray] = {}
    for c in header["cols"]:
        dt = np.dtype(c["dtype"])
        nb = c["nbytes"]
        cols[c["name"]] = np.frombuffer(raw, dtype=dt, count=nb // dt.itemsize,
                                        offset=off)
        off += nb
        valid[c["name"]] = np.frombuffer(raw, dtype=np.uint8,
                                         count=n, offset=off).astype(bool)
        off += n
    return n, cols, valid


def _host(t) -> np.ndarray:
    """A torch tensor (on any device) or an array as a numpy array."""
    return t.cpu().numpy() if hasattr(t, "cpu") else np.asarray(t)


def batch_to_bytes(batch) -> bytes:
    """Serialize a ColumnBatch, sel compacted away: only live rows
    travel (the Outbox's implicit sel materialization, like colserde
    compacting through the selection vector). Device tensors come to
    the host with ``.cpu().numpy()``."""
    host = {name: _host(d) for name, d in zip(batch.names, batch.data)}
    validh = {name: _host(v) for name, v in zip(batch.names, batch.valid)}
    sel = _host(batch.sel)
    cols = {n: a[sel] for n, a in host.items()}
    valid = {n: a[sel] for n, a in validh.items()}
    n = int(sel.sum())
    return encode_columns(n, cols, valid)


def bytes_to_arrays(raw: bytes):
    return decode_columns(raw)
