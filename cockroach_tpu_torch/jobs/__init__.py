"""Jobs: the durable registry and its resumers (the port of
cockroach_tpu/jobs): schema changes and index backfills, BACKUP and
RESTORE, row TTL and IMPORT."""

from .backup import BACKUP_JOB, RESTORE_JOB, BackupResumer, RestoreResumer
from .import_job import IMPORT_JOB, ImportResumer, synthetic_chunk
from .registry import (CANCELED, FAILED, PENDING, RUNNING, SUCCEEDED,
                       JobCanceled, JobContext, JobRecord, JobsError,
                       Registry)
from .schemachange import (INDEX_BACKFILL_JOB, SCHEMA_CHANGE_JOB,
                           IndexBackfillResumer, SchemaChangeResumer)
from .ttl import TTL_JOB, TTLResumer

__all__ = ["Registry", "JobRecord", "JobContext", "JobsError",
           "JobCanceled", "ImportResumer", "IMPORT_JOB",
           "synthetic_chunk", "PENDING", "RUNNING", "SUCCEEDED", "FAILED",
           "CANCELED", "SCHEMA_CHANGE_JOB", "SchemaChangeResumer",
           "INDEX_BACKFILL_JOB", "IndexBackfillResumer", "BACKUP_JOB",
           "RESTORE_JOB", "BackupResumer", "RestoreResumer", "TTL_JOB",
           "TTLResumer"]
