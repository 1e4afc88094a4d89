"""Jobs: the durable registry and the schema-change resumers (the port
of cockroach_tpu/jobs; BACKUP, RESTORE, IMPORT, row TTL and changefeeds
are not ported yet)."""

from .registry import (CANCELED, FAILED, PENDING, RUNNING, SUCCEEDED,
                       JobCanceled, JobContext, JobRecord, JobsError,
                       Registry)
from .schemachange import (INDEX_BACKFILL_JOB, SCHEMA_CHANGE_JOB,
                           IndexBackfillResumer, SchemaChangeResumer)

__all__ = ["Registry", "JobRecord", "JobContext", "JobsError",
           "JobCanceled", "PENDING", "RUNNING", "SUCCEEDED", "FAILED",
           "CANCELED", "SCHEMA_CHANGE_JOB", "SchemaChangeResumer",
           "INDEX_BACKFILL_JOB", "IndexBackfillResumer"]
