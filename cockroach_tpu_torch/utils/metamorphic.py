"""Metamorphic constants (cockroach_tpu/utils/metamorphic.py; the
pkg/util/metamorphic analogue).

Internal tuning constants (chunk sizes, log-truncation thresholds,
paging sizes) must never affect RESULTS — only performance. Under
COCKROACH_TPU_METAMORPHIC=<seed>, every registered constant takes a
seeded-random value from its legal range instead of the production
default, so the whole test suite re-runs with perturbed internals and
any result difference is a bug. Without the env var this module is a
passthrough (zero overhead, production defaults).

Chosen values are recorded in `chosen` so failures can be reproduced
(the reference logs them the same way)."""

from __future__ import annotations

import os
import random
import threading

_seed = os.environ.get("COCKROACH_TPU_METAMORPHIC")
_rng = random.Random(int(_seed)) if _seed else None

chosen: dict[str, object] = {}

# two threads first-touching the same knob would each draw from _rng
# and could adopt different "constants" for one name: the
# check-and-draw is atomic
_CHOSEN_LOCK = threading.Lock()


def is_active() -> bool:
    return _rng is not None


def metamorphic_pow2(name: str, default: int, lo_bits: int,
                     hi_bits: int) -> int:
    """A power-of-two constant in [2^lo_bits, 2^hi_bits]."""
    if _rng is None:
        return default
    with _CHOSEN_LOCK:
        if name not in chosen:
            chosen[name] = 1 << _rng.randint(lo_bits, hi_bits)
        return chosen[name]
