"""The port's native key encoder (cockroach_tpu_torch/native/keyenc.cpp)
against storage/keys.py, byte for byte.

1. Each scalar encoding (int64, float64, escaped bytes) and both batch
   encoders (``batch_encode_int_keys``, ``batch_encode_str_keys``) equal
   the reference's ``storage/keys.py`` and the port's own, over seeded
   values with NUL bytes, empty strings, non-ASCII text and negative
   ints.
2. A STRING primary key's index build goes through the native encoder
   and equals the ``row_key`` loop; int-family keys stay on
   ``encode_int_keys``; DML routed through that index lands on the right
   rows.
3. A failed build raises ``NativeBuildError``: no STRING-pk index is
   built without the encoder.
"""

import ctypes

import numpy as np
import pytest

from cockroach_tpu.storage import keys as RK
from cockroach_tpu_torch import native
from cockroach_tpu_torch.exec.engine import Engine
from cockroach_tpu_torch.storage import keys as K
from cockroach_tpu_torch.storage.columnstore import MAX_TS_INT

STRS = ["alpha", "", "\x00", "a\x00b", "\x00\x00lead", "trail\x00",
        "héllo", "日本語のキー", "emoji \U0001F600", "x" * 300,
        "with\x00nul? no — utf8", "\xff\xfe"]


@pytest.fixture(scope="module")
def lib():
    return native.get_keyenc()


def _both(fn_name, *args):
    """The reference's and the port's storage/keys.py encoding."""
    out = []
    for mod in (RK, K):
        buf = bytearray()
        getattr(mod, fn_name)(buf, *args)
        out.append(bytes(buf))
    assert out[0] == out[1]
    return out[0]


def test_int64_matches_keys(lib):
    rng = np.random.default_rng(0)
    vals = [int(v) for v in rng.integers(-2 ** 62, 2 ** 62, 300)] + \
        [0, -1, 1, 2 ** 63 - 1, -2 ** 63, -2 ** 40, 2 ** 24 + 1]
    out = (ctypes.c_uint8 * 8)()
    for v in vals:
        lib.keyenc_int64(v, out)
        assert bytes(out) == _both("encode_int", v), v


def test_float64_matches_keys(lib):
    rng = np.random.default_rng(1)
    vals = [float(v) for v in rng.normal(size=200) * 1e6] + \
        [0.0, -0.0, 1.5, -1.5, float("inf"), float("-inf"), 5e-324]
    out = (ctypes.c_uint8 * 8)()
    for v in vals:
        lib.keyenc_float64(v, out)
        assert bytes(out) == _both("encode_float", v), v


def test_bytes_matches_keys(lib):
    for s in STRS:
        v = s.encode("utf-8")
        out = (ctypes.c_uint8 * (2 * len(v) + 2))()
        src = (ctypes.c_uint8 * max(len(v), 1)).from_buffer_copy(
            v or b"\x00")
        n = lib.keyenc_bytes(src, len(v), out)
        assert bytes(out[:n]) == _both("encode_bytes", v), s


def test_batch_int_keys_match_table_key():
    rng = np.random.default_rng(2)
    vals = np.concatenate([rng.integers(-2 ** 62, 2 ** 62, 100),
                           [5, -3, 0, 2 ** 40, -2 ** 63, 2 ** 63 - 1]]
                          ).astype(np.int64)
    got = native.batch_encode_int_keys(K.table_prefix(42), vals)
    assert got == [RK.table_key(42, (int(v),)) for v in vals]
    assert got == K.encode_int_keys(K.table_prefix(42), [vals])
    assert native.batch_encode_int_keys(K.table_prefix(42),
                                        np.zeros(0, np.int64)) == []


def test_batch_str_keys_match_table_key():
    rng = np.random.default_rng(3)
    fuzz = ["".join(chr(int(c)) for c in
                    rng.choice([0, 1, 65, 255, 0x3b1, 0x1F600],
                               size=int(rng.integers(0, 6))))
            for _ in range(100)]
    strs = STRS + fuzz
    got = native.batch_encode_str_keys(K.table_prefix(7), strs)
    assert got == [RK.table_key(7, (s,)) for s in strs]
    assert got == [K.table_key(7, (s,)) for s in strs]
    assert native.batch_encode_str_keys(K.table_prefix(7), []) == []


def test_keys_order_as_the_codec_orders():
    vals = np.sort(np.random.default_rng(4).integers(-10 ** 9, 10 ** 9,
                                                     100))
    encs = native.batch_encode_int_keys(b"", vals)
    assert encs == sorted(encs)
    strs = sorted(s.encode("utf-8") for s in STRS)
    encs = native.batch_encode_str_keys(b"", [s.decode() for s in strs])
    assert encs == sorted(encs)


def _loop_index(e, table):
    """The pk index as the row_key loop builds it."""
    td = e.store.table(table)
    want = {}
    for ci, chunk in enumerate(td.chunks):
        for ri in np.nonzero(chunk.mvcc_del == MAX_TS_INT)[0]:
            want[e.store.row_key(td, chunk, int(ri))] = (ci, int(ri))
    return want


def _string_pk_engine():
    e = Engine(device="cpu")
    e.execute("CREATE TABLE t (s STRING PRIMARY KEY, b INT)")
    vals = ", ".join(f"('{s}', {i})" for i, s in enumerate(
        ["key0", "", "héllo", "日本", "b'q", "zz"] +
        [f"k{i}" for i in range(30)]) if "'" not in s)
    e.execute(f"INSERT INTO t VALUES {vals}")
    return e


def test_string_pk_index_goes_through_keyenc(monkeypatch):
    e = _string_pk_engine()
    e.store.seal("t")
    calls = []
    real = native.batch_encode_str_keys
    monkeypatch.setattr(native, "batch_encode_str_keys",
                        lambda *a: calls.append(1) or real(*a))
    e.store.table("t").pk_index = None
    idx = e.store.ensure_pk_index("t")
    assert calls and idx == _loop_index(e, "t")


@pytest.mark.parametrize("ddl", [
    "CREATE TABLE t (a INT PRIMARY KEY, b INT)",
    "CREATE TABLE t (b INT)",
    "CREATE TABLE t (a INT, c INT, b INT, PRIMARY KEY (a, c))",
])
def test_int_family_pk_index_stays_on_numpy(monkeypatch, ddl):
    e = Engine(device="cpu")
    e.execute(ddl)
    cols = len(e.store.table("t").schema.columns)
    e.execute("INSERT INTO t VALUES " + ",".join(
        "(" + ", ".join(str(i * (j + 1) - 20) for j in range(cols)) + ")"
        for i in range(50)))

    def refuse(*a):
        raise AssertionError("int keys went to the native encoder")
    monkeypatch.setattr(native, "batch_encode_int_keys", refuse)
    monkeypatch.setattr(native, "batch_encode_str_keys", refuse)
    e.store.table("t").pk_index = None
    assert e.store.ensure_pk_index("t") == _loop_index(e, "t")


def test_dml_against_string_pk_index():
    e = _string_pk_engine()
    e.execute("UPDATE t SET b = 99 WHERE s = 'héllo'")
    e.execute("DELETE FROM t WHERE s = ''")
    e.execute("UPSERT INTO t VALUES ('日本', -1)")
    rows = dict(e.execute("SELECT s, b FROM t").rows)
    assert rows["héllo"] == 99 and "" not in rows and rows["日本"] == -1
    assert len(rows) == 34


def test_failed_keyenc_build_raises(monkeypatch):
    def broken():
        raise native.NativeBuildError("g++ failed")
    monkeypatch.setattr(native, "get_keyenc", broken)
    e = _string_pk_engine()
    e.store.table("t").pk_index = None
    with pytest.raises(native.NativeBuildError):
        e.store.ensure_pk_index("t")
