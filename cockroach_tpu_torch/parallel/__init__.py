"""Distributed execution over a mesh of shard slots (the counterpart of
cockroach_tpu/parallel/): the mesh and its sub-mesh pool (mesh.py), the
shard axis's collectives (collective.py), the distribution decision and
the per-mesh dispatcher (distagg.py), and the hash-partitioned exchange
(shuffle.py)."""
