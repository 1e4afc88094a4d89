"""Workload generators run through the SQL engine (TPC-H and SSB's
data live in models/).

The port of cockroach_tpu/workload: each workload has ``setup``
(schema and initial data) and ``run`` (a step loop reporting its
counts and rates), runnable as ``python -m cockroach_tpu_torch workload
<name>`` or in tests. ``kv`` drives the transactional KV plane
(``Engine.kv``) directly; the others drive SQL.
"""

from .bank import Bank
from .kvload import KVLoad
from .movr import MovR
from .ssb import SSB
from .tpcc import TPCC
from .ycsb import YCSB

WORKLOADS = {
    "bank": Bank,
    "kv": KVLoad,
    "ycsb": YCSB,
    "ssb": SSB,
    "tpcc": TPCC,
    "movr": MovR,
}

__all__ = ["Bank", "KVLoad", "YCSB", "SSB", "TPCC", "MovR",
           "WORKLOADS"]
