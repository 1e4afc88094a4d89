"""Distributed SQL flows between engines (cockroach_tpu/distsql/).

Co-scheduled shards of one engine run as one plan over its shard mesh
(``parallel/``); flows between engines use this package: serialized
flow specs set up per-node stages (``SetupFlow``,
pkg/sql/distsql/server.go:625), and columnar batches stream back over a
transport (``FlowStream`` + Outbox/Inbox, pkg/sql/colflow/colrpc) in the
framing of ``serde.py``.
"""

from cockroach_tpu_torch.distsql.flow import (FlowRegistry,  # noqa: F401
                                              FlowSpec, Inbox, Outbox)
from cockroach_tpu_torch.distsql.node import (DistSQLNode,  # noqa: F401
                                              Gateway)
