"""The transactional KV plane: MVCC intents, latches, the timestamp
cache and the transaction coordinator that DML writes through
(exec/dml.py), over one store (``txn.KVStore``) or over the replicated
ranges of a kvserver.Cluster (``rangekv.ClusterKVStore``, with
``disttxn``'s transaction records, ``distsender``'s routing and
``rowfetch``'s range-backed tables)."""
