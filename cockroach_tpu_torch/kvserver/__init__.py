"""KV server layer of the port: so far only the in-process message
transport the DistSQL flows ride (``transport.LocalTransport``). Raft,
stores, leases and liveness (cockroach_tpu/kvserver/) are still to
port."""

from cockroach_tpu_torch.kvserver.transport import (  # noqa: F401
    ChaosTransport, LocalTransport)
