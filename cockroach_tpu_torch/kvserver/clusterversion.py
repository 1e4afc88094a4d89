"""Cluster versioning and feature gates
(cockroach_tpu/kvserver/clusterversion.py).

The analogue of ``pkg/clusterversion`` + ``pkg/upgrade``: every binary
carries a BINARY_VERSION and a MIN_SUPPORTED version; the CLUSTER runs
at an *active* version persisted in the replicated keyspace, only ever
ratcheted forward, and features that change cross-node behavior
consult a gate (``is_active``) instead of assuming every peer runs
this binary, so a multi-process deployment can mix two binaries.

Join-time handshake (netcluster.py): a joiner sends its binary
version; the seed refuses binaries older than MIN_SUPPORTED (they
cannot apply newer raft commands) and the joiner refuses clusters
whose ACTIVE version exceeds its own binary (it would be asked to
serve features it does not have) — the two directions of the
reference's version gating (pkg/server/init.go + clusterversion
handshake).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True, order=True)
class Version:
    major: int
    minor: int

    def __str__(self) -> str:
        return f"{self.major}.{self.minor}"

    @staticmethod
    def parse(s: str) -> "Version":
        a, b = str(s).split(".")
        return Version(int(a), int(b))


# this binary: liveness rides a replicated system range
BINARY_VERSION = Version(25, 2)
# oldest binary this one can share a cluster with
MIN_SUPPORTED = Version(25, 1)

# feature gates: behavior that changed across rounds and must not be
# assumed of peers until the cluster version ratchets past it
GATES = {
    # liveness records proposed onto the system range
    # (netcluster.py); below this the gossip plane is authoritative
    "replicated_liveness": Version(25, 2),
    # multi-stage shuffle flows with hash-exchange edges
    # (distsql/shuffle.py); a gateway must not schedule graph flows
    # onto nodes that cannot decompose them
    "shuffle_flows": Version(25, 2),
}


class ClusterVersion:
    """Per-node view of the cluster's active version.

    The active version starts at the BOOTSTRAP binary's version,
    propagates in the join snapshot and by broadcast, and only
    ratchets forward (finalization; the reference persists it in a
    system key and gates each upgrade migration on it)."""

    def __init__(self, binary: Version = BINARY_VERSION,
                 min_supported: Version = MIN_SUPPORTED):
        self.binary = binary
        self.min_supported = min_supported
        self.active = min_supported

    def activate(self, v: Version) -> bool:
        """Ratchet the active version (SET CLUSTER SETTING version).
        Refused above this binary — a node cannot run features it
        does not have."""
        if v > self.binary:
            raise ValueError(
                f"version {v} is newer than this binary "
                f"({self.binary})")
        if v > self.active:
            self.active = v
            return True
        return False

    def is_active(self, gate: str) -> bool:
        return self.active >= GATES[gate]

    def check_join(self, joiner_binary: Version) -> None:
        """Seed-side admission check for a joining binary."""
        if joiner_binary < self.min_supported:
            raise IncompatibleVersionError(
                f"binary {joiner_binary} is older than the cluster's "
                f"minimum supported version {self.min_supported}")

    def check_cluster(self, cluster_active: Version) -> None:
        """Joiner-side check of the cluster's active version."""
        if cluster_active > self.binary:
            raise IncompatibleVersionError(
                f"cluster runs at {cluster_active}, newer than this "
                f"binary ({self.binary}); upgrade the binary first")


class IncompatibleVersionError(RuntimeError):
    pass
