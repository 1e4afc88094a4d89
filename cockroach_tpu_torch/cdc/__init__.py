"""CDC: changefeeds over SQL tables (the port of cockroach_tpu/cdc;
the reference's pkg/ccl/changefeedccl)."""

from .changefeed import (CHANGEFEED_JOB, ChangefeedResumer, CollectorSink,
                         FeedEvent, FileSink, TableFeed, encode_event,
                         open_sink)

__all__ = ["CHANGEFEED_JOB", "ChangefeedResumer", "TableFeed",
           "CollectorSink", "FileSink", "FeedEvent", "encode_event",
           "open_sink"]
