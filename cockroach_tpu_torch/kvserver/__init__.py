"""KV server layer of the port (cockroach_tpu/kvserver/): Raft
replication, stores and replicas, epoch leases, liveness, rangefeeds, the
in-process multi-node ``Cluster`` over the in-process message transport
(``transport.LocalTransport``, which the DistSQL flows also ride), and
its deployment form over TCP (``netcluster.NetCluster``: one Store a
process, raft and routed requests on the socket fabric) with the
cluster version and its feature gates (``clusterversion``). The
replication plane is host code; only scan and aggregate work goes to
the card."""

from cockroach_tpu_torch.kvserver.raft import (  # noqa: F401
    Message, RaftNode, Ready)
from cockroach_tpu_torch.kvserver.transport import (  # noqa: F401
    ChaosTransport, LocalTransport)
from cockroach_tpu_torch.kvserver.clusterversion import (  # noqa: F401
    BINARY_VERSION, ClusterVersion, IncompatibleVersionError, Version)
from cockroach_tpu_torch.kvserver.netcluster import NetCluster  # noqa: F401
