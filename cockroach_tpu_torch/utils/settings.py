"""Session variables (the subset of cockroach_tpu/utils/settings.py
SessionVars that this package reads)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class SessionVars:
    """Session variables with reference-compatible names."""
    values: dict = field(default_factory=lambda: {
        # one-pass GROUP BY kernels: auto (default) routes eligible
        # dense GROUP BYs with an exact-result envelope to the large-G
        # kernel (ops/cuda/groupagg_large.py); on also routes ungrouped
        # and <= 64-group aggregations over FLOAT arguments to the
        # small-G kernel (ops/cuda/groupagg.py) and lets the large-G
        # kernel take f32 float sums and MIN/MAX (approximate against
        # the plain path's float64); off keeps every aggregation on the
        # plain scatter path. Engine.execute rejects any other value.
        "pallas_groupagg": "auto",   # auto | on | off
        # slots of the device hash table behind hash-strategy GROUP BY
        # (a power of two). Half of them are usable: a GROUP BY whose
        # build passes half with rows left to place overflows, and the
        # engine re-runs the plan partition by partition
        "hash_group_capacity": 1 << 17,
        # packed-lane sort keys (ops/sortkey.py) for ORDER BY, the
        # top-k cut and duplicate-key join chains: auto and on use
        # them, off sorts by successive stable argsorts
        "sort_normalized": "auto",   # auto | on | off
        # memo-based join ordering / rule pipeline / sketch-fed costing
        "optimizer": "on",           # on | off
        "optimizer_rules": "on",     # on | off
        "optimizer_sketch_stats": "on",   # on | off
    })

    def set(self, name: str, value) -> None:
        self.values[name] = value

    def get(self, name: str, default=None):
        return self.values.get(name, default)
