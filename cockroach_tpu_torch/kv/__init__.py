"""The transactional KV plane (single store): MVCC intents, latches,
the timestamp cache and the transaction coordinator that DML writes
through (exec/dml.py)."""
