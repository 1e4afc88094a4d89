"""The port's host-native code: the OLTP lane's MVCC row mirror.

``oltp.cpp`` (the port's copy of cockroach_tpu/native/oltp.cpp) builds
with ``g++ -O3 -shared -fPIC -std=c++17`` at first use, never at
import, into ``_build/`` beside the package, named by a hash of its
source (as ``ops/cuda/build.py`` names the CUDA builds), and loads
through ctypes. The ABI is a handful of flat C functions.

Unlike the reference, whose loader returns None and so turns the lane
off quietly, a failed build or load raises ``NativeBuildError``: the
lane is absent by error, never by silence.
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
BUILD_DIR = _HERE.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_oltp_lib = None


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


def load_library(src: Path, cxx: str | None = None) -> ctypes.CDLL:
    """Build (if needed) and load ``src`` with the row mirror's ABI
    bound. Raises NativeBuildError."""
    path = build_library(src, cxx)
    try:
        return _bind_oltp(ctypes.CDLL(str(path)))
    except (OSError, AttributeError) as e:
        raise NativeBuildError(f"loading {path}: {e}") from e


def get_oltp() -> ctypes.CDLL:
    """The native OLTP row mirror (oltp.cpp), built at first use.
    Raises NativeBuildError when it cannot be built or loaded."""
    global _oltp_lib
    with _lock:
        if _oltp_lib is None:
            _oltp_lib = load_library(OLTP_SRC)
        return _oltp_lib
