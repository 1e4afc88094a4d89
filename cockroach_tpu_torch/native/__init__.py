"""The port's host-native code: the OLTP lane's MVCC row mirror and the
bulk primary-key encoder.

``oltp.cpp`` and ``keyenc.cpp`` (the port's copies of the sources of
cockroach_tpu/native/) each build with ``g++ -O3 -shared -fPIC
-std=c++17`` at first use, never at import, into ``_build/`` beside the
package, named by a hash of its source (as ``ops/cuda/build.py`` names
the CUDA builds), and load through ctypes. Each ABI is a handful of
flat C functions.

Unlike the reference, whose loader returns None and so turns the lane
off (or the key encoder over to Python) quietly, a failed build or load
raises ``NativeBuildError``: either is absent by error, never by
silence.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
OLTP_SRC = _HERE / "oltp.cpp"
KEYENC_SRC = _HERE / "keyenc.cpp"
BUILD_DIR = _HERE.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_oltp_lib = None
_keyenc_lib = None


class NativeBuildError(RuntimeError):
    pass


def lib_path(src: Path) -> Path:
    """Where the build of ``src`` goes (content-addressed)."""
    tag = hashlib.sha256(Path(src).read_bytes()).hexdigest()
    return BUILD_DIR / f"{Path(src).stem}-{tag[:16]}.so"


def build_library(src: Path, cxx: str | None = None) -> Path:
    """Compile ``src`` into ``_build/`` unless its build is there;
    returns the library's path. The build goes to a temporary file
    first and is renamed into place, so concurrent builders never load
    a half-written library. Raises NativeBuildError."""
    out = lib_path(src)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx or os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
           str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        os.unlink(tmp)
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise NativeBuildError(f"{' '.join(cmd)} failed:\n"
                               f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _bind_oltp(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_int64
    i64p = ctypes.POINTER(i64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    vp = ctypes.c_void_p
    lib.oltp_create.argtypes = [i64]
    lib.oltp_create.restype = vp
    lib.oltp_destroy.argtypes = [vp]
    lib.oltp_destroy.restype = None
    lib.oltp_nversions.argtypes = [vp]
    lib.oltp_nversions.restype = i64
    lib.oltp_bulk.argtypes = [vp, i64, i64p, i64p, i64p, i64p, u8p]
    lib.oltp_bulk.restype = None
    lib.oltp_put.argtypes = [vp, i64, i64, i64p, u8p]
    lib.oltp_put.restype = ctypes.c_int
    lib.oltp_del.argtypes = [vp, i64, i64]
    lib.oltp_del.restype = ctypes.c_int
    lib.oltp_live.argtypes = [vp, i64, i64]
    lib.oltp_live.restype = ctypes.c_int
    lib.oltp_read.argtypes = [vp, i64, i64, i64p, u8p]
    lib.oltp_read.restype = ctypes.c_int
    lib.oltp_multiread.argtypes = [vp, i64, i64p, i64, i64p, u8p, u8p]
    lib.oltp_multiread.restype = i64
    lib.oltp_scan.argtypes = [vp, i64, ctypes.c_int, ctypes.c_int,
                              i64, ctypes.c_int, ctypes.c_int,
                              i64, i64, i64p, i64p, u8p]
    lib.oltp_scan.restype = i64
    return lib


def _bind_keyenc(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64 = ctypes.c_int64
    i64p = ctypes.POINTER(i64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.keyenc_batch_int.argtypes = [u8p, i64, i64p, i64, u8p, i64p]
    lib.keyenc_batch_int.restype = None
    lib.keyenc_batch_bytes.argtypes = [u8p, i64, u8p, i64p, i64, u8p, i64p]
    lib.keyenc_batch_bytes.restype = i64
    lib.keyenc_int64.argtypes = [i64, u8p]
    lib.keyenc_int64.restype = None
    lib.keyenc_float64.argtypes = [ctypes.c_double, u8p]
    lib.keyenc_float64.restype = None
    lib.keyenc_bytes.argtypes = [u8p, i64, u8p]
    lib.keyenc_bytes.restype = i64
    return lib


# each source's ABI, by the source's stem
_BINDERS = {"oltp": _bind_oltp, "keyenc": _bind_keyenc}


def load_library(src: Path, cxx: str | None = None) -> ctypes.CDLL:
    """Build (if needed) and load ``src`` with its ABI bound (the row
    mirror's for oltp.cpp, the key encoder's for keyenc.cpp). Raises
    NativeBuildError."""
    path = build_library(src, cxx)
    try:
        return _BINDERS[Path(src).stem](ctypes.CDLL(str(path)))
    except (OSError, AttributeError, KeyError) as e:
        raise NativeBuildError(f"loading {path}: {e}") from e


def get_oltp() -> ctypes.CDLL:
    """The native OLTP row mirror (oltp.cpp), built at first use.
    Raises NativeBuildError when it cannot be built or loaded."""
    global _oltp_lib
    with _lock:
        if _oltp_lib is None:
            _oltp_lib = load_library(OLTP_SRC)
        return _oltp_lib


def get_keyenc() -> ctypes.CDLL:
    """The native key encoder (keyenc.cpp), built at first use. Raises
    NativeBuildError when it cannot be built or loaded."""
    global _keyenc_lib
    with _lock:
        if _keyenc_lib is None:
            _keyenc_lib = load_library(KEYENC_SRC)
        return _keyenc_lib


def _u8p(buf) -> "ctypes._Pointer":
    return ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8))


def batch_encode_int_keys(prefix: bytes, vals) -> list[bytes]:
    """n keys of ``prefix`` + the order-preserving int64 of each value
    (storage/keys.py ``table_key`` of one int-family column)."""
    import numpy as np
    lib = get_keyenc()
    vals = np.ascontiguousarray(vals, dtype=np.int64)
    n = len(vals)
    stride = len(prefix) + 8
    out = np.empty(max(n * stride, 1), dtype=np.uint8)
    offs = np.empty(n + 1, dtype=np.int64)
    pbuf = (ctypes.c_uint8 * max(len(prefix), 1)).from_buffer_copy(
        prefix or b"\x00")
    lib.keyenc_batch_int(
        _u8p(pbuf), len(prefix),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    raw = out.tobytes()
    return [raw[i * stride:(i + 1) * stride] for i in range(n)]


def batch_encode_str_keys(prefix: bytes, strs) -> list[bytes]:
    """n keys of ``prefix`` + the escaped, terminated UTF-8 of each
    string (storage/keys.py ``table_key`` of one STRING column)."""
    import numpy as np
    lib = get_keyenc()
    blobs = [s.encode("utf-8") for s in strs]
    n = len(blobs)
    data = b"".join(blobs)
    doffs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(b) for b in blobs], out=doffs[1:])
    cap = n * len(prefix) + 2 * len(data) + 2 * n
    out = np.empty(max(cap, 1), dtype=np.uint8)
    offs = np.empty(n + 1, dtype=np.int64)
    pbuf = (ctypes.c_uint8 * max(len(prefix), 1)).from_buffer_copy(
        prefix or b"\x00")
    dbuf = (ctypes.c_uint8 * max(len(data), 1)).from_buffer_copy(
        data or b"\x00")
    lib.keyenc_batch_bytes(
        _u8p(pbuf), len(prefix), _u8p(dbuf),
        doffs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    raw = out.tobytes()
    return [raw[offs[i]:offs[i + 1]] for i in range(n)]
