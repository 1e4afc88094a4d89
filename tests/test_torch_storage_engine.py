"""The reference's storage-engine cases on the port.

tests/test_storage_engine.py (order-preserving key encodings, the LSM's
flush, compaction, persistence and SST format, a randomized run against
a dict model, and MVCC's edges: own-intent replacement, write-too-old,
intents blocking writers, max-keys scans, GC under intents, epoch
restarts, inconsistent scans, atomic WAL batches) runs unchanged on the
port's ``storage.keys``, ``storage.lsm``, ``storage.mvcc`` and
``storage.sst`` (``reference_cases`` of test_torch_ranges.py).
"""

from tests.test_torch_ranges import reference_cases

reference_cases("test_storage_engine.py", globals())
