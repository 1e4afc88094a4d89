"""Distributed observability on the port over raft on TCP.

The reference's own cases, tests/test_distributed_trace.py (11), run on
the port's modules (``reference_cases`` of test_torch_ranges.py) with
every ``Engine`` and ``Node`` on the CPU: a 3-node NetCluster (raft over
TCP) carries lineitem, split in thirds with one lease per node; a
DistSQL gateway over port engines (``DistSQLNode(cluster=...)``) runs a
distributed GROUP BY equal to an oracle engine's rows and EXPLAIN
ANALYZE with node-tagged remote spans; ``/_status/vars`` serves the rpc,
distsender, breaker and shuffle families; ``/debug/tracez``,
``/_status/statements`` and their ``?cluster=1`` fan-out across nodes
(merged exactly, and ``partial`` within its timeout when a peer is
partitioned away); ``SET tracing = cluster`` stitches the raft-propose
and raft-apply events of a replicated INSERT and the remote flow spans
into one session recording, and ``SET tracing = on`` keeps remote nodes
dark. Each assertion holds the port to the reference's.
"""

from __future__ import annotations

from cockroach_tpu_torch.exec.engine import Engine as PortEngine
from tests.test_torch_ranges import reference_cases


class CpuEngine(PortEngine):
    """The port's Engine on the CPU (the reference's cases build theirs
    with no device, which on the port means the card)."""

    def __init__(self, *args, **kw):
        kw.setdefault("device", "cpu")
        super().__init__(*args, **kw)


reference_cases(
    "test_distributed_trace.py", globals(),
    replace=(("Node(NodeConfig(listen_port=0, http_port=0))",
              "Node(NodeConfig(listen_port=0, http_port=0, device='cpu'))"),),
    bind={"Engine": CpuEngine})
