"""Statement diagnostics registry (cockroach_tpu/utils/stmtdiag.py; the
reference's ``pkg/sql/stmtdiagnostics``).

An operator arms a statement fingerprint — over HTTP
(``POST /_status/stmtdiag``), SQL (``SET statement_diagnostics =
'<stmt>'``), or implicitly via ``EXPLAIN ANALYZE (DEBUG)`` — and the
NEXT execution matching that fingerprint captures a JSON diagnostics
bundle: bound plan, per-operator profile (exec/profile.py), trace
recording, cluster settings + session vars, sketch stats, and metric
deltas. Completed bundles are retrievable at
``GET /_status/stmtdiag/<id>`` until they age out of the bounded ring.

The reference stores requests/bundles in system tables and gossips
armed fingerprints cluster-wide (stmtdiagnostics/statement_diagnostics
.go); here the registry is per-engine state behind one lock (one node:
the cluster fan-out of the status plane is not ported).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from .sqlstats import fingerprint

# completed bundles retained per engine; diagnostics are a debugging
# aid, not an archive — old bundles age out ring-buffer style
MAX_BUNDLES = 32


class StmtDiagRegistry:
    """Armed fingerprints and completed diagnostics bundles."""

    def __init__(self, metrics=None):
        self._mu = threading.Lock()
        # fingerprint -> request id (one-shot: capturing pops it)
        self._armed: dict[str, int] = {}
        self._bundles: dict[int, dict] = {}
        self._order: deque[int] = deque()
        self._next_id = 1
        self._m_armed = self._m_captured = self._m_fetched = None
        if metrics is not None:
            self._m_armed = metrics.counter(
                "stmtdiag.armed",
                "statement diagnostics requests armed")
            self._m_captured = metrics.counter(
                "stmtdiag.captured",
                "statement diagnostics bundles captured")
            self._m_fetched = metrics.counter(
                "stmtdiag.fetched",
                "statement diagnostics bundles served over HTTP")

    # -- arming ----------------------------------------------------
    def arm(self, sql_or_fp: str, is_fingerprint: bool = False) -> dict:
        """Arm a fingerprint; the next matching execution captures a
        bundle. Returns {request_id, fingerprint}. Re-arming a pending
        fingerprint returns the existing request."""
        fp = sql_or_fp if is_fingerprint else fingerprint(sql_or_fp)
        with self._mu:
            rid = self._armed.get(fp)
            if rid is None:
                rid = self._next_id
                self._next_id += 1
                self._armed[fp] = rid
                if self._m_armed is not None:
                    self._m_armed.inc()
            return {"request_id": rid, "fingerprint": fp}

    def should_capture(self, fp: str) -> int | None:
        """Pop-and-return the armed request id for ``fp`` (None when
        not armed). One-shot: only the next execution captures."""
        with self._mu:
            return self._armed.pop(fp, None)

    def rearm(self, fp: str, rid: int) -> None:
        """Put a popped request back (capture failed; keep waiting)."""
        with self._mu:
            self._armed.setdefault(fp, rid)

    # -- bundles ---------------------------------------------------
    def fulfill(self, rid: int | None, bundle: dict) -> int:
        """Store a completed bundle; returns its bundle id (the
        request id when the capture was armed, else a fresh id for
        inline EXPLAIN ANALYZE (DEBUG) captures)."""
        with self._mu:
            bid = rid if rid is not None else self._next_id
            if rid is None:
                self._next_id += 1
            bundle = dict(bundle)
            bundle["id"] = bid
            bundle.setdefault("captured_at", time.time())
            self._bundles[bid] = bundle
            self._order.append(bid)
            while len(self._order) > MAX_BUNDLES:
                self._bundles.pop(self._order.popleft(), None)
            if self._m_captured is not None:
                self._m_captured.inc()
            return bid

    def get(self, bid: int) -> dict | None:
        with self._mu:
            b = self._bundles.get(bid)
            if b is not None and self._m_fetched is not None:
                self._m_fetched.inc()
            return b

    def summary(self) -> dict:
        """The ``GET /_status/stmtdiag`` listing: pending requests and
        completed bundle summaries (newest first)."""
        with self._mu:
            return {
                "armed": [{"request_id": rid, "fingerprint": fp}
                          for fp, rid in sorted(self._armed.items(),
                                                key=lambda kv: kv[1])],
                "bundles": [
                    {"id": bid,
                     "fingerprint": self._bundles[bid].get(
                         "fingerprint", ""),
                     "captured_at": self._bundles[bid].get(
                         "captured_at", 0.0)}
                    for bid in reversed(self._order)
                    if bid in self._bundles],
            }
