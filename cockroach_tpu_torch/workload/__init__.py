"""Workload generators run through the SQL engine (TPC-H and SSB live
in models/)."""
