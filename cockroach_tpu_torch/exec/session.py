"""Session state, results and errors (the subset of
cockroach_tpu/exec/session.py that this package's Engine uses)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.settings import SessionVars


class EngineError(Exception):
    pass


class HashCapacityExceeded(EngineError):
    """GROUP BY's distinct-key count exceeded the device hash table
    (``hash_group_capacity``). The reference re-executes hash-
    partitioned (its spill path); the port has no spill yet, so this
    reaches the caller."""


class TopKInexact(EngineError):
    """The fused top-k ORDER BY ... LIMIT cut crossed a primary-key tie
    group (compile.py topk_sort_limit_batch). The engine replans with
    the full device sort."""


class CompactOverflow(EngineError):
    """A selection-compaction block held more selected rows than its
    capacity (compile.py compact_batch): results would be missing rows.
    The engine replans uncompacted."""


# The device error-sentinel columns a result batch may carry, in the
# order Engine._materialize checks them.
SENTINEL_COLUMNS = ("__ht_overflow", "__sum_overflow",
                    "__topk_inexact", "__compact_overflow")


@dataclass
class Result:
    """Decoded query result."""
    names: list[str] = field(default_factory=list)
    rows: list[tuple] = field(default_factory=list)
    tag: str = "SELECT"
    types: list = field(default_factory=list)  # SQLTypes (SELECT only)


@dataclass(eq=False)
class Session:
    """Per-connection state: the session variables."""
    vars: SessionVars = field(default_factory=SessionVars)
