"""Resumable bulk IMPORT into the columnstore (the port of
cockroach_tpu/jobs/import_job.py; the reference's pkg/sql/importer).

Data arrives a chunk at a time from a deterministic generator (seeded
synthetic columns; a CSV reader is a drop-in generator), each chunk
lands as one sealed columnstore chunk, and progress checkpoints after
every chunk.

Exactly once across crashes without a transaction spanning the ingest
and the job record: the job records the table's row count when it
first starts, and on resume recomputes how many chunks landed from the
store itself ((row_count - baseline) // chunk_rows, or all of them once
every row is there: the last chunk may be partial), not from the
checkpoint, which may be a chunk behind. A crash between an ingest and
its checkpoint therefore never ingests a chunk twice.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from .registry import JobContext, _CrashForTesting

IMPORT_JOB = "IMPORT"


def synthetic_chunk(seed: int, chunk_index: int, chunk_rows: int,
                    columns: dict) -> dict:
    """Deterministic per-chunk columns: chunk i is the same whenever and
    wherever it is generated (what makes a resume safe). ``columns``
    maps name -> "int" | "float" | a dictionary size (string codes)."""
    rng = np.random.default_rng((seed << 20) ^ chunk_index)
    out = {}
    for name, kind in columns.items():
        if kind == "int":
            out[name] = rng.integers(0, 1 << 30,
                                     size=chunk_rows).astype(np.int64)
        elif kind == "float":
            out[name] = rng.random(chunk_rows)
        else:
            out[name] = rng.integers(0, int(kind),
                                     size=chunk_rows).astype(np.int32)
    return out


class ImportResumer:
    """payload: {table, total_rows, chunk_rows, seed, columns};
    progress: {baseline_rows, chunks_done}."""

    def __init__(self, engine, chunk_generator: Optional[Callable] = None,
                 crash_after_chunk: Optional[int] = None):
        self.engine = engine
        self.generate = chunk_generator or synthetic_chunk
        self.crash_after_chunk = crash_after_chunk

    def resume(self, ctx: JobContext) -> None:
        p = ctx.payload
        table = p["table"]
        total = int(p["total_rows"])
        chunk_rows = int(p["chunk_rows"])
        n_chunks = (total + chunk_rows - 1) // chunk_rows
        store = self.engine.store
        td = store.table(table)
        prog = ctx.progress()
        if "baseline_rows" not in prog:
            prog = {"baseline_rows": td.row_count, "chunks_done": 0}
            ctx.checkpoint(prog, fraction=0.0)
        baseline = int(prog["baseline_rows"])
        done_rows = td.row_count - baseline
        done = n_chunks if done_rows >= total else done_rows // chunk_rows
        for ci in range(done, n_chunks):
            ctx.check_cancel()
            rows = min(chunk_rows, total - ci * chunk_rows)
            cols = self.generate(int(p["seed"]), ci, rows, p["columns"])
            store.insert_columns(table, cols, self.engine.clock.now())
            if (self.crash_after_chunk is not None
                    and ci >= self.crash_after_chunk):
                raise _CrashForTesting()
            ctx.checkpoint({"baseline_rows": baseline,
                            "chunks_done": ci + 1},
                           fraction=(ci + 1) / n_chunks)

    def on_fail_or_cancel(self, ctx: JobContext) -> None:
        # the chunks that landed stay, as in the reference
        pass
