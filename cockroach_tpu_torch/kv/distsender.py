"""DistSender: range-addressed batch routing with retries
(cockroach_tpu/kv/distsender.py).

Rebuild of ``pkg/kv/kvclient/kvcoord/dist_sender.go:299,795``:
- splits a batch of point/span ops by range boundaries
  (``divideAndSendBatchToRanges`` ``:1210``),
- routes each piece to the cached leaseholder, trying other replicas
  on failure,
- refreshes stale cache entries from the meta authority (here the
  cluster's descriptor map — the analogue of the meta ranges) on
  NotLeaseholder / RangeKeyMismatch, and retries with backoff.

The transport is an in-process call into the target store (the gRPC
``Internal.Batch`` boundary of the reference).
"""

from __future__ import annotations

import copy
import random
import time
from dataclasses import dataclass, field, replace
from typing import Optional

from cockroach_tpu_torch.kv.rangecache import RangeCache
from cockroach_tpu_torch.kvserver.cluster import Cluster, NotLeaseholderError
from cockroach_tpu_torch.kvserver.store import (RangeBoundsError, _enc_ts,
                                          raise_op_error)
from cockroach_tpu_torch.rpc.retry import (DeadlineExceeded, Retrier,
                                     RetryPolicy)
from cockroach_tpu_torch.storage.hlc import Timestamp
from cockroach_tpu_torch.utils import tracing
from cockroach_tpu_torch.utils.circuit import Breaker, BreakerTrippedError

# the pump-driven cluster has no wall clock: backoff seconds convert
# to pump iterations at the NetCluster pump cadence (5ms/iteration)
_PUMP_SECONDS = 0.005

# one retry policy for every DistSender request (replaces the old
# per-call `attempts=8` constants; see rpc/retry.py + ROBUSTNESS.md)
DEFAULT_POLICY = RetryPolicy(max_attempts=8, base_backoff=0.005,
                             max_backoff=0.16, deadline=30.0)


class RangeKeyMismatchError(Exception):
    pass


@dataclass
class BatchRequest:
    """A list of op dicts: {op: get|scan|put|delete, key|start/end, ...}."""

    ops: list[dict] = field(default_factory=list)

    def get(self, key: bytes) -> "BatchRequest":
        self.ops.append({"op": "get", "key": key})
        return self

    def scan(self, start: bytes, end: bytes,
             limit: int = 0) -> "BatchRequest":
        self.ops.append({"op": "scan", "start": start, "end": end,
                         "limit": limit})
        return self

    def put(self, key: bytes, value: bytes) -> "BatchRequest":
        self.ops.append({"op": "put", "key": key, "value": value})
        return self

    def delete(self, key: bytes) -> "BatchRequest":
        self.ops.append({"op": "delete", "key": key})
        return self


class DistSender:
    def __init__(self, cluster: Cluster,
                 policy: RetryPolicy = DEFAULT_POLICY,
                 seed: int = 0, metrics=None):
        self.cluster = cluster
        self.cache = RangeCache()
        self.policy = policy
        self.rng = random.Random(seed)   # seeded jitter: deterministic
        # per-node breakers (dist_sender's moral copy of the reference
        # per-replica breakers): a down node trips; the probe heals it
        # the moment the authority stops listing it as down
        self.node_breakers: dict[int, Breaker] = {}
        self.retries = 0
        self.rpcs = 0
        self.evictions = 0
        self._m_attempt = None
        if metrics is not None:
            self.attach_metrics(metrics)

    def attach_metrics(self, reg) -> None:
        """distsender.* in a MetricRegistry: func-counters over the
        plain ints plus a per-attempt latency histogram."""
        reg.func_counter("distsender.retries", lambda: self.retries,
                         "batch pieces retried after routing errors")
        reg.func_counter("distsender.rpcs", lambda: self.rpcs,
                         "Internal.Batch RPC attempts issued")
        reg.func_counter("distsender.rangecache.evictions",
                         lambda: self.evictions,
                         "range-cache entries evicted as stale")
        reg.func_gauge("distsender.breakers.tripped",
                       lambda: sum(1 for b in self.node_breakers
                                   .values() if b.tripped),
                       "per-node breakers currently open")
        self._m_attempt = reg.histogram(
            "distsender.attempt.latency",
            "seconds per Internal.Batch attempt")

    def _evict(self, key: bytes) -> None:
        self.evictions += 1
        tracing.event("rangecache-evict")
        self.cache.evict(key)

    def _node_breaker(self, nid: int) -> Breaker:
        b = self.node_breakers.get(nid)
        if b is None:
            b = Breaker(f"distsender->n{nid}", threshold=1,
                        probe=lambda n=nid: n not in self.cluster.down)
            self.node_breakers[nid] = b
        return b

    def _pause(self, attempt: int) -> None:
        """Backoff between attempts, in pump iterations (the
        deterministic clusters have no wall clock to sleep on)."""
        b = self.policy.backoff(attempt, self.rng)
        self.cluster.pump(max(2, int(b / _PUMP_SECONDS)))

    # ------------------------------------------------------------------
    # meta lookup (the meta-range scan of the reference)
    # ------------------------------------------------------------------
    def _meta_lookup(self, key: bytes):
        desc = self.cluster.range_for_key(key)
        if desc is None:
            raise KeyError(f"no range containing {key!r}")
        # snapshot, never alias: the authority mutates its descriptors
        # in place on split/merge and the cache must go stale honestly
        self.cache.insert(copy.deepcopy(desc))
        return self.cache.lookup(key)

    def _entry_for(self, key: bytes):
        e = self.cache.lookup(key)
        if e is None:
            e = self._meta_lookup(key)
        return e

    # ------------------------------------------------------------------
    # sending
    # ------------------------------------------------------------------
    def send(self, batch: BatchRequest,
             ts: Optional[Timestamp] = None) -> list:
        """Execute the batch; per-op results positionally.

        Results: get→value|None, scan→[(k,v)], put/delete→True.
        """
        ts = ts or self.cluster.clock.now()
        results: list = [None] * len(batch.ops)
        for i, op in enumerate(batch.ops):
            if op["op"] == "scan":
                results[i] = self._send_scan(op, ts)
            else:
                results[i] = self._send_point(op, ts)
        return results

    def _send_point(self, op: dict, ts: Timestamp,
                    attempts: Optional[int] = None):
        key = op["key"]
        pol = self.policy if attempts is None else \
            replace(self.policy, max_attempts=attempts)
        r = Retrier(pol, self.rng)
        for attempt in r:
            entry = self._entry_for(key)
            desc = entry.desc
            try:
                with tracing.span("rpc-attempt", attempt=attempt):
                    return self._rpc(desc, entry, op, ts, key)
            except (RangeKeyMismatchError, RangeBoundsError, KeyError):
                self.retries += 1
                self._evict(key)
            except NotLeaseholderError as e:
                self.retries += 1
                if e.hint:
                    self.cache.update_leaseholder(key, e.hint)
                else:
                    self._evict(key)
                self._pause(attempt + 1)
        if r.expired():
            raise DeadlineExceeded(
                f"batch op to {key!r} exceeded its "
                f"{pol.deadline}s deadline")
        raise RuntimeError(f"batch op to {key!r} exhausted retries")

    def _send_scan(self, op: dict, ts: Timestamp) -> list:
        """Iterate range-by-range across split boundaries
        (divideAndSendBatchToRanges)."""
        out = []
        cur, end = op["start"], op["end"]
        limit = op.get("limit", 0)
        failures = 0
        r = Retrier(self.policy, self.rng)
        while cur < end:
            if failures >= self.policy.max_attempts:
                raise RuntimeError(f"scan piece at {cur!r} exhausted "
                                   "retries (range unavailable?)")
            if failures and r.expired():
                raise DeadlineExceeded(
                    f"scan piece at {cur!r} exceeded its "
                    f"{self.policy.deadline}s deadline")
            entry = self._entry_for(cur)
            desc = entry.desc
            piece = dict(op)
            piece["start"] = cur
            piece["end"] = min(end, desc.end_key)
            remaining = 0
            if limit:
                remaining = limit - len(out)
                if remaining <= 0:
                    break
                piece["limit"] = remaining
            try:
                with tracing.span("rpc-attempt", attempt=failures):
                    out.extend(self._rpc(desc, entry, piece, ts, cur))
            except (RangeKeyMismatchError, RangeBoundsError, KeyError,
                    NotLeaseholderError):
                self.retries += 1
                failures += 1
                self._evict(cur)
                self._pause(failures)
                continue
            failures = 0
            cur = desc.end_key
        return out

    def _rpc(self, desc, entry, op: dict, ts: Timestamp, key: bytes):
        """One Internal.Batch 'RPC' against a replica of desc."""
        self.rpcs += 1
        t0 = time.monotonic()
        try:
            return self._rpc_inner(desc, entry, op, ts, key)
        finally:
            if self._m_attempt is not None:
                self._m_attempt.observe(time.monotonic() - t0)

    def _rpc_inner(self, desc, entry, op: dict, ts: Timestamp,
                   key: bytes):
        order = [entry.leaseholder] if entry.leaseholder else []
        order += [n for n in desc.replicas if n not in order]
        last_err: Exception = NotLeaseholderError()
        for nid in order:
            b = self._node_breaker(nid)
            if nid in self.cluster.down:
                b.report_failure()   # trips: later attempts fail fast
                continue
            try:
                b.check()            # probe heals once it leaves down
            except BreakerTrippedError:
                tracing.event("breaker-skip", node=nid)
                last_err = NotLeaseholderError()
                continue
            store = self.cluster.stores.get(nid)
            rep = store.replicas.get(desc.range_id) if store else None
            if rep is None:
                last_err = RangeKeyMismatchError()
                continue
            # range bounds may have moved (split/merge) since caching
            if not rep.desc.contains(key):
                self.cache.insert(copy.deepcopy(rep.desc))
                last_err = RangeKeyMismatchError()
                continue
            if not rep.holds_lease():
                tracing.event("lease-check", range_id=desc.range_id,
                              node=nid, ok=False)
                lh = self.cluster.ensure_lease(desc.range_id)
                if lh is not None and lh != nid:
                    last_err = NotLeaseholderError(hint=lh)
                    continue
                if lh is None:
                    last_err = NotLeaseholderError()
                    continue
                lh_store = self.cluster.stores.get(lh)
                if lh_store is None:
                    # NetCluster: only the local store is in the map —
                    # route through the fabric stub instead of
                    # KeyError'ing
                    try:
                        rep = self.cluster._leaseholder_replica(key)
                    except (KeyError, RuntimeError) as e:
                        last_err = e
                        continue
                else:
                    rep = lh_store.replicas[desc.range_id]
            b.report_success()
            entry.leaseholder = (rep.node_id
                                 if not hasattr(rep, "store")
                                 else rep.store.node_id)
            tracing.event("lease-check", range_id=desc.range_id,
                          node=entry.leaseholder, ok=True)
            return self._execute(rep, op, ts)
        raise last_err

    def _execute(self, rep, op: dict, ts: Timestamp):
        o = dict(op)
        kind = o.pop("op")
        if kind in ("get", "scan"):
            req = {"op": kind, "ts": _enc_ts(ts)}
            if kind == "get":
                req["key"] = op["key"].decode("latin1")
            else:
                req["start"] = op["start"].decode("latin1")
                req["end"] = op["end"].decode("latin1")
                req["limit"] = op.get("limit", 0)
            return rep.read(req)
        # writes go through raft
        wire = {"op": kind, "key": op["key"].decode("latin1"),
                "ts": _enc_ts(ts)}
        if kind == "put":
            wire["value"] = op["value"].decode("latin1")
        res = self.cluster.propose_and_wait(rep, {"kind": "batch",
                                                  "ops": [wire]})[0]
        # apply-time MVCC conflicts come back as results; re-raise so
        # a non-txn writer never silently loses its write
        raise_op_error(res)
        return True
