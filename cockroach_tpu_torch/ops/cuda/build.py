"""Build the package's CUDA C++ sources with nvcc and load them.

Each source under ``csrc/`` compiles on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes
seconds), loaded with ctypes. Libraries land in ``_build/`` beside the
package, named by a hash of their source, so an edited source never
loads a stale build. Nothing is compiled when a module is imported:
the first launch builds (``load``), and ``compile_all`` starts every
nvcc at once for a caller that wants all kernels ready up front (also
for variants of a source kept elsewhere, to time them side by side).
Each library made ready is tallied for the cold-start plane
(exec/coldstart.py): found in ``_build/`` and loaded, or built with
nvcc, and its seconds billed to the loading thread's statement.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH = "arch=compute_90a,code=sm_90a"

_loaded: dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    """nvcc of the CUDA toolkit PyTorch finds (CUDA_HOME or CUDA_PATH,
    else nvcc on PATH, else /usr/local/cuda)."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise BuildError("nvcc not found (set CUDA_HOME)")


def _source(name: str | Path) -> Path:
    """csrc/<name>.cu for a name, or the given path to a source."""
    return name if isinstance(name, Path) else CSRC / f"{name}.cu"


def source_tag(name: str | Path) -> str:
    """The content hash of csrc/<name>.cu (or of the source at a path)
    that names its build."""
    return hashlib.sha256(_source(name).read_bytes()).hexdigest()[:16]


def lib_path(name: str | Path) -> Path:
    """Where the build of csrc/<name>.cu (or of the source at a path)
    goes (content-addressed)."""
    return BUILD_DIR / f"{_source(name).stem}-{source_tag(name)}.so"


def _start(name: str | Path):
    """Start nvcc for csrc/<name>.cu (or a source path); returns
    (Popen, tmp, out) or None when the library is already built."""
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
           str(_source(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str | Path, started) -> str:
    """Wait for one started build; returns nvcc's output."""
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise BuildError(f"nvcc failed for {_source(name)}:\n{log}")
    os.replace(tmp, out)
    return log


def compile_all(names: list) -> dict:
    """Build every named source (csrc/<name>.cu, or a source path), all
    nvcc processes running at once. Returns {name: nvcc output
    (register/shared-memory report)}."""
    started = {n: _start(n) for n in names}
    return {n: _finish(n, s) for n, s in started.items()}


def load(name: str | Path) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu (or of a source path), built
    first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        from ...exec import coldstart
        t0 = time.perf_counter()
        started = _start(name)
        _finish(name, started)
        lib = ctypes.CDLL(str(lib_path(name)))
        _loaded[name] = lib
        coldstart.note_library(started is not None,
                               time.perf_counter() - t0)
    return lib
