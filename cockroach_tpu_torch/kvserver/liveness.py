"""Node liveness: heartbeat records with epochs, driving lease validity
(cockroach_tpu/kvserver/liveness.py).

Rebuild of ``pkg/kv/kvserver/liveness/liveness.go:185,668``: every node
heartbeats a record ``{epoch, expiration}``; a node is live while its
record is unexpired. Epoch leases reference the holder's epoch, so
fencing a dead leaseholder = incrementing its epoch
(``IncrementEpoch``), which atomically invalidates all its leases.

The reference stores these records in a replicated system range; here
the registry object *is* the applied state of that range, shared by the
in-process cluster (the same simplification testcluster uses for single
process tests). Time is tick-based and driven by the cluster pump, so
failure-detection tests are deterministic.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class LivenessRecord:
    node_id: int
    epoch: int
    expiration: int          # tick at which the record lapses
    draining: bool = False
    decommissioning: bool = False


class NodeLiveness:
    def __init__(self, ttl_ticks: int = 9):
        self.ttl = ttl_ticks
        self.records: dict[int, LivenessRecord] = {}
        self.now = 0

    def tick(self) -> None:
        self.now += 1

    def heartbeat(self, node_id: int) -> LivenessRecord:
        rec = self.records.get(node_id)
        if rec is None:
            rec = LivenessRecord(node_id, epoch=1,
                                 expiration=self.now + self.ttl)
            self.records[node_id] = rec
            return rec
        if rec.expiration < self.now:
            # our own record lapsed while we were down/partitioned:
            # re-join at a new epoch (old leases stay fenced)
            rec.epoch += 1
        rec.expiration = self.now + self.ttl
        return rec

    def is_live(self, node_id: int) -> bool:
        rec = self.records.get(node_id)
        return rec is not None and rec.expiration >= self.now \
            and not rec.decommissioning

    def epoch_of(self, node_id: int) -> int:
        rec = self.records.get(node_id)
        return rec.epoch if rec else 0

    def increment_epoch(self, node_id: int) -> bool:
        """Fence a non-live node's leases (IncrementEpoch). Fails while
        the record is still live — you cannot fence a live node."""
        rec = self.records.get(node_id)
        if rec is None or rec.expiration >= self.now:
            return False
        rec.epoch += 1
        return True

    def set_draining(self, node_id: int, draining: bool) -> None:
        rec = self.records.get(node_id)
        if rec:
            rec.draining = draining

    def set_decommissioning(self, node_id: int, v: bool = True) -> None:
        rec = self.records.get(node_id)
        if rec:
            rec.decommissioning = v

    def live_nodes(self) -> list[int]:
        return sorted(n for n in self.records if self.is_live(n))
