"""Cluster fabric: socket RPC transport + gossip (reference: pkg/rpc,
pkg/gossip; cockroach_tpu/rpc/, ported as it stands)."""

from cockroach_tpu_torch.rpc.context import (FaultInjector, SocketTransport,
                                             decode_msg, encode_msg)
from cockroach_tpu_torch.rpc.gossip import Gossip
from cockroach_tpu_torch.rpc.retry import (DeadlineExceeded, Retrier,
                                           RetryPolicy)

__all__ = ["FaultInjector", "SocketTransport", "Gossip", "encode_msg",
           "decode_msg", "RetryPolicy", "Retrier", "DeadlineExceeded"]
