"""KV server layer of the port (cockroach_tpu/kvserver/): Raft
replication, stores and replicas, epoch leases, liveness, rangefeeds and
the in-process multi-node ``Cluster``, over the in-process message
transport (``transport.LocalTransport``) the DistSQL flows also ride.
The replication plane is host code; only scan and aggregate work goes to
the card. The socket cluster (``netcluster.py``) and cluster versions
are still to port."""

from cockroach_tpu_torch.kvserver.raft import (  # noqa: F401
    Message, RaftNode, Ready)
from cockroach_tpu_torch.kvserver.transport import (  # noqa: F401
    ChaosTransport, LocalTransport)
