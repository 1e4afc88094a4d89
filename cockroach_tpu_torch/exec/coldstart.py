"""Cold start: cache root, shape ladder, shapes journal, compile tallies.

The port of cockroach_tpu/exec/coldstart.py. A restarted engine pays,
under its first user statements, every table upload, every plan build
and every kernel library load. This module holds the cross-process
state that lets ``Engine.prewarm`` pay them at start instead:

1. **Cache root.** ``resolve_cache_root``: the cluster setting
   ``sql.exec.compile_cache.dir``, then the environment variable
   ``COCKROACH_TPU_COMPILE_CACHE_DIR``, then ``~/.cache/
   cockroach_tpu_torch``; ``off`` disables it. Its subdirectory is keyed
   by the torch version, the CUDA version, the GPU's name and
   ``SCHEMA_VERSION`` (``cpu`` on a CPU engine), so state written by
   another card or toolchain is never read: invalidation is a new
   subdirectory, never a flush. The subdirectory holds the shapes
   journal here and the tuning and verdict tables of
   ops/cuda/autotune.py and ops/cuda/paritygate.py; a verdict also
   names the kernel source's content hash and the launch point it was
   fuzzed at, and is fuzzed again when either differs. The reference points
   JAX's persistent XLA cache at the same place; the port has no XLA
   program to persist, and its kernel libraries are content-addressed
   under ops/cuda/build.py's ``_build/``.

2. **Shape ladder.** ``ShapeLadder`` is the closed set of padded row
   counts: resident uploads, streamed pages and spill partitions bucket
   through it (``Engine._row_bucket``). ``steps_per_octave = 1`` is the
   power-of-two ladder from ``min_rows`` (1,024); larger values insert
   evenly spaced rungs per octave. Every rung is a multiple of 128, so
   kernel 1's ``n % 128 == 0`` rule holds on any ladder.

3. **Shapes journal.** Statements that miss the exec cache append their
   text (with their paged bucket and their plan-changing session
   variables) to a journal in the cache subdirectory; ``Engine.prewarm``
   re-prepares the top-K of the previous run.

4. **Compile tallies.** The port's own compile work: plan builds
   (``compile_plan`` and its streamed and spilled variants) and kernel
   libraries loaded from ``_build/`` against those built with nvcc.
   ``thread_compile_seconds`` is this thread's seconds in plan builds
   plus kernel builds and loads; a statement takes the delta around its
   dispatch as its ``compile_s`` (``/_status/statements``, EXPLAIN
   ANALYZE).
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass

from ..utils.num import next_pow2

# Bump when the on-disk layout (cache subdirectory, journal or table
# formats) changes incompatibly: old state is never looked at again.
SCHEMA_VERSION = 1

ENV_VAR = "COCKROACH_TPU_COMPILE_CACHE_DIR"
_OFF = ("off", "none", "disabled")
_JOURNAL_NAME = "shapes_journal.jsonl"
_JOURNAL_MAX_BYTES = 8 << 20  # stop appending past this; bounded state

_LOCK = threading.Lock()
_TLS = threading.local()


class _Tally:
    """Process-wide compile tallies (engines share the kernel libraries
    of one process, so the counts are the process's)."""

    def __init__(self):
        self.plan_builds = 0
        self.plan_seconds = 0.0
        self.lib_loads = 0     # libraries found in _build/
        self.lib_builds = 0    # libraries compiled with nvcc
        self.lib_seconds = 0.0
        self.prewarmed = 0
        self.prewarm_errors = 0


TALLY = _Tally()


def _cell() -> list:
    c = getattr(_TLS, "cell", None)
    if c is None:
        c = _TLS.cell = [0.0]
    return c


def thread_compile_seconds() -> float:
    """Seconds of plan builds and kernel builds and loads billed to this
    thread: compile work runs synchronously on the statement's thread,
    so a delta around a dispatch is the statement's own."""
    return _cell()[0]


def attribution_cell() -> list:
    """The mutable cell this thread's compile seconds are billed to.
    Cross-thread executors (the mesh dispatcher, a distributed plan's
    shard threads: parallel/distagg.py) capture it on the issuing
    thread and adopt it around the call, so the statement's delta stays
    its own."""
    return _cell()


def set_attribution_cell(cell) -> list:
    """Point this thread's compile billing at ``cell``; returns the
    previous cell, for the caller to restore."""
    prev = _cell()
    _TLS.cell = cell if cell is not None else [0.0]
    return prev


def _bill(seconds: float) -> None:
    # shard threads of one statement share its cell
    with _LOCK:
        _cell()[0] += seconds


@contextmanager
def plan_build():
    """Time one plan build (a compile_plan call) and bill it."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _LOCK:
            TALLY.plan_builds += 1
            TALLY.plan_seconds += dt
        _bill(dt)


def note_library(built: bool, seconds: float) -> None:
    """One kernel library made ready (ops/cuda/build.py load): built
    with nvcc, or found in _build/ and loaded."""
    with _LOCK:
        if built:
            TALLY.lib_builds += 1
        else:
            TALLY.lib_loads += 1
        TALLY.lib_seconds += seconds
    _bill(seconds)


def note_prewarmed(ok: bool) -> None:
    with _LOCK:
        if ok:
            TALLY.prewarmed += 1
        else:
            TALLY.prewarm_errors += 1


def register_metrics(metrics) -> None:
    """exec.compile.* (idempotent per registry)."""
    metrics.func_counter(
        "exec.compile.cache_hit", lambda: TALLY.lib_loads,
        "kernel libraries loaded from the content-addressed build "
        "directory without running nvcc (process-wide)")
    metrics.func_counter(
        "exec.compile.cache_miss", lambda: TALLY.lib_builds,
        "kernel libraries compiled with nvcc (process-wide)")
    metrics.func_counter(
        "exec.compile.plan_builds", lambda: TALLY.plan_builds,
        "plans built on an exec-cache miss (process-wide)")
    metrics.func_counter(
        "exec.compile.seconds",
        lambda: TALLY.plan_seconds + TALLY.lib_seconds,
        "seconds in plan builds and kernel library builds and loads "
        "(process-wide)")
    metrics.func_counter(
        "exec.compile.prewarmed", lambda: TALLY.prewarmed,
        "statements re-prepared by Engine.prewarm from the shapes "
        "journal")
    metrics.func_counter(
        "exec.compile.prewarm_errors", lambda: TALLY.prewarm_errors,
        "journaled statements Engine.prewarm could not warm (logged)")


# -- the cache root ----------------------------------------------------------

def default_cache_root() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "cockroach_tpu_torch")


def resolve_cache_root(settings=None) -> str | None:
    """Setting > environment > user default; "off" disables."""
    configured = ""
    if settings is not None:
        configured = str(settings.get("sql.exec.compile_cache.dir"))
    if configured.lower() in _OFF:
        return None
    if configured:
        return configured
    env = os.environ.get(ENV_VAR, "")
    if env.lower() in _OFF:
        return None
    return env or default_cache_root()


def device_key(device) -> str:
    """Who the cached state is for: ``cpu``, or the card's name. The
    tuning and verdict tables key their entries by it."""
    if getattr(device, "type", str(device)) != "cuda":
        return "cpu"
    import torch
    return torch.cuda.get_device_name(device)


def cache_dir(root: str, device) -> str:
    """Per-toolchain, per-card, per-schema subdirectory of ``root``."""
    import torch
    key = device_key(device)
    if key != "cpu":
        key = f"{key}-cuda{torch.version.cuda}"
    tag = re.sub(r"[^A-Za-z0-9._+-]+", "_",
                 f"{key}-torch{torch.__version__}-v{SCHEMA_VERSION}")
    return os.path.join(root, tag)


def init_cache_dir(settings, device) -> str | None:
    """The engine's cache subdirectory, made if missing; None when the
    cache is off, or when the directory cannot be made (logged: the
    engine then runs without journal or tables, cold after a restart)."""
    root = resolve_cache_root(settings)
    if root is None:
        return None
    d = cache_dir(root, device)
    try:
        os.makedirs(d, exist_ok=True)
    except OSError as e:
        from ..utils import log
        log.warning(log.SQL_EXEC, "cold-start cache %s unusable: %s", d, e)
        return None
    return d


# -- shape bucket ladder -----------------------------------------------------

@dataclass(frozen=True)
class ShapeLadder:
    """The closed set of padded row counts. ``bucket(n)`` maps a row
    count to its rung; ``budget(max_n)`` is the number of distinct
    shapes a row sweep up to max_n can make.

    steps_per_octave = 1 is the power-of-two padding; s > 1 inserts s
    evenly spaced rungs per octave (s = 2: 1024, 1536, 2048, 3072, ...).
    min_rows and steps_per_octave must be powers of two with
    min_rows / steps_per_octave >= 128, so every rung is a multiple of
    128."""

    min_rows: int = 1024
    steps_per_octave: int = 1

    def __post_init__(self):
        mr, s = self.min_rows, self.steps_per_octave
        if mr < 128 or mr & (mr - 1):
            raise ValueError("min_rows must be a power of two >= 128")
        if not (1 <= s <= 8) or s & (s - 1):
            raise ValueError(
                "steps_per_octave must be a power of two in [1, 8]")
        if mr // s < 128:
            raise ValueError("min_rows/steps_per_octave must be >= 128")

    def bucket(self, n: int) -> int:
        n = max(int(n), 1)
        if n <= self.min_rows:
            return self.min_rows
        p = next_pow2(n)
        if self.steps_per_octave == 1:
            return p
        half = p // 2
        step = half // self.steps_per_octave
        # smallest rung in (half, p] that covers n
        return half + step * (-(-(n - half) // step))

    def budget(self, max_n: int, min_n: int = 1) -> int:
        """Distinct rungs a sweep over [min_n, max_n] can touch."""
        return len(self.rungs(max_n, min_n))

    def rungs(self, max_n: int, min_n: int = 1) -> list[int]:
        out, b = [self.bucket(min_n)], self.bucket(min_n)
        hi = self.bucket(max_n)
        while b < hi:
            b = self.bucket(b + 1)
            out.append(b)
        return out


def ladder_from_settings(settings) -> ShapeLadder:
    return ShapeLadder(
        int(settings.get("sql.exec.shape_bucket.min_rows")),
        int(settings.get("sql.exec.shape_bucket.steps_per_octave")))


# -- shapes journal ----------------------------------------------------------

def journal_path(cache_d: str) -> str:
    return os.path.join(cache_d, _JOURNAL_NAME)


def journal_record(cache_d: str | None, sql_text: str,
                   bucket: int = 0, vars: dict | None = None) -> None:
    """Append an exec-cache miss to the shapes journal. ``bucket`` is a
    paged statement's page rows (0: resident); ``vars`` its non-default
    plan-changing session variables, which a prewarm replays so it
    prepares the plan the statement ran. A journal past its size bound
    takes no more entries; a write that fails is logged (a lost entry
    costs only prewarm coverage)."""
    if not cache_d or not sql_text:
        return
    p = journal_path(cache_d)
    try:
        if os.path.getsize(p) > _JOURNAL_MAX_BYTES:
            return
    except FileNotFoundError:
        pass
    rec = {"sql": sql_text, "n": int(bucket)}
    if vars:
        rec["vars"] = dict(vars)
    line = json.dumps(rec, sort_keys=True) + "\n"
    try:
        with _LOCK, open(p, "a", encoding="utf-8") as f:
            f.write(line)
    except OSError as e:
        from ..utils import log
        log.warning(log.SQL_EXEC, "shapes journal %s: %s", p, e)


def journal_entries(cache_d: str | None, k: int) -> list[tuple]:
    """The k statement texts with the most journaled misses, hottest
    first, each with its dominant page bucket (0: resident) and its
    dominant session-variable dict ({}: defaults). Lines that do not
    parse are skipped; a missing journal is an empty plan."""
    if not cache_d or k <= 0:
        return []
    counts: Counter = Counter()
    buckets: dict[str, Counter] = {}
    varcounts: dict[str, Counter] = {}
    vartabs: dict[str, dict] = {}
    try:
        with open(journal_path(cache_d), encoding="utf-8") as f:
            lines = f.readlines()
    except FileNotFoundError:
        return []
    for line in lines:
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if not isinstance(rec, dict):
            continue
        sql = rec.get("sql")
        if not isinstance(sql, str) or not sql:
            continue
        counts[sql] += 1
        b = rec.get("n")
        if isinstance(b, int) and b > 0:
            buckets.setdefault(sql, Counter())[b] += 1
        jv = rec.get("vars")
        if isinstance(jv, dict) and jv:
            key = json.dumps(jv, sort_keys=True)
            varcounts.setdefault(sql, Counter())[key] += 1
            vartabs.setdefault(sql, {})[key] = jv

    def dominant_vars(sql: str) -> dict:
        if sql not in varcounts:
            return {}
        return vartabs[sql][varcounts[sql].most_common(1)[0][0]]

    return [(sql,
             (buckets[sql].most_common(1)[0][0] if sql in buckets else 0),
             dominant_vars(sql))
            for sql, _ in counts.most_common(k)]


def journal_top(cache_d: str | None, k: int) -> list[str]:
    """The k statement texts with the most journaled misses, hottest
    first (journal_entries without the buckets and variables)."""
    return [e[0] for e in journal_entries(cache_d, k)]
