#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port (cockroach_tpu_torch) on one card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
1. Card and build: prints the card's name and power limit and builds
   every CUDA kernel of the main path from csrc/ (one nvcc per source,
   all started at once). The whole run shares one fresh cold-start
   cache root (COCKROACH_TPU_COMPILE_CACHE_DIR, removed at its end);
   the parity gate's verdicts and kernel 1's launch point are resolved
   in it here, as an engine's first `auto` plan build would (a fuzz and
   a sweep at the synthetic shape), before any run is counted.
2. Main path: Engine() on the card loads TPC-H SF1 lineitem
   (6,001,215 rows, padded on the device to 8,388,608) and part
   (200,000 rows) through CREATE TABLE / bulk ingest / ANALYZE, then
   runs through Engine.execute, each with every kernel launch count
   set to 0 just before it and read just after: Q1 and Q6 (default
   `auto`), Q14 (lineitem x part, a direct-addressed hash join), and
   under SET pallas_groupagg = on the FLOAT8 variants Q1F and Q6F. Q1
   and Q6 are held to the numpy oracles at tests/test_tpch.py's
   tolerances (Q6 rel 1e-9, Q1 rel 1e-6), Q14 to ref_q14 at rel 1e-9,
   Q1F and Q6F to the float64 oracles with counts exact and sums and
   averages within rel 1e-5 (the small-G kernel adds in f32). Q1 must
   launch the large-G kernel once, Q1F and Q6F the small-G kernel once
   each, with no separate group-liveness count (ops.agg.group_count is
   counted per query: Q1F reads liveness from its kernel launch), and
   Q1 under `on` must equal Q1 under `auto` bit for bit.
3. Q1 under SET pallas_groupagg = off must give the same DECIMAL sums
   and counts as through the kernel; medians of 5 warm runs of Q1, Q6,
   Q1 `off`, Q14, Q1F and Q6F are timed.
4. Each kernel against its plain PyTorch version on the card. Large-G,
   through its slot interface (int64 values, limbs cut in the kernel):
   at the exact slots Q1 handed it in phase 2, and at seeded slots with
   negative int64 values, INT64_MIN and INT64_MAX at G = 12 (few groups
   a warp: warp-aggregated adds) and G = 200,000 (global atomics), and
   all masked with out-of-range group ids; through its pre-built-column
   interface at G = 4096 with MIN/MAX/REPMIN (shared-memory
   accumulators), G = 200,000 (global atomics), an all-masked input
   with out-of-range group ids and MIN/MAX with -0.0 and NaN. i32 rows,
   max-|value| words, MIN/MAX rows and REPMIN must match exactly, f32
   sums within rtol 1e-5 (atomic order), or within 1e-5 of the group's
   sum of |value| where the values have both signs. Kernel 1's time
   alone (CUDA events around bare launches) and through its wrapper,
   its host time per call, and both byte bounds (the slots' columns,
   and the pre-built columns) are measured at Q1, Q5, Q10 and Q12.
   Small-G: at the exact inputs Q1F and Q6F handed it, G = 64 with all
   four ops, G = 1 at n = 2^23, an all-masked input with out-of-range
   ids, NaN values in some groups, and G = 64
   with 16 and with 300 slots (the per-block accumulator strategy,
   which Q1F's shape does not reach; 300 slots read 48 masks, past the
   kernel's 31 mask bits) with NaN groups and -0.0 in MIN/MAX columns;
   counts exact, MIN/MAX bit for bit (-0.0 is not +0.0; NaN where
   NaN), f32 sums within rtol 1e-5. Wrapper, plain
   and library-call times use CUDA events after warm-up; the small-G
   kernel's time alone at Q1F and Q6F uses CUDA events around bare
   launches (bench_groupagg.kernel_ms).
5. The join's hash-table path: ops.join.hash_join on Q14's scanned
   batches with direct=None must give the direct path's selection and
   payload; prints its build and probe round counts and its time.
6. The multi-table suite: loads orders, customer, supplier, partsupp,
   nation and region at SF1 beside lineitem and part (prints the load
   seconds), then runs TPC-H Q3, Q5, Q10, Q12, QPS (lineitem x partsupp
   on the part key alone, 4 partsupp rows a key) and QH (returned-item
   revenue per customer and ship mode) through Engine.execute, each
   with every count set to 0 just before it and read just after,
   against the numpy oracles: DECIMAL values within rel 1e-9, keys,
   counts and dates exactly, rows in the oracle's order. Routes from
   the counts: Q5, Q10 (its keys reduced to the dense c_custkey) and
   Q12 launch the large-G kernel once each, Q3 (1,499,977 dense codes)
   none; QH, and only QH, numbers its groups with hashtable.group_ids
   (its build rounds are printed); Q3, Q10 and QH cut with the fused
   top-k and need no TopKInexact replan; every sort goes through packed
   sort-key lanes (no fallback); QPS expands its join 4 ways; the
   Compact nodes applied and the replans of each query are printed. Q3,
   Q10 and QH under SET sort_normalized = off must give the same rows.
   The packed lanes built on the card equal those built on the CPU, bit
   for bit. Medians of 5 warm runs and the peak device memory are
   printed, and the large-G kernel is held against its plain version at
   the exact slots Q5, Q10 and Q12 handed it (integer rows exactly,
   f32 within rtol 1e-5), with its times and bounds there.
7. Subqueries, derived tables and CTEs: TPC-H Q2, Q4, Q7, Q8, Q9, Q11,
   Q13, Q15, Q16, Q17, Q18, Q19, Q20, Q21 and Q22 through
   Engine.execute on the SF1 tables, each with every count set to 0
   just before it and read just after, against the numpy oracles
   (models/tpch.py): DECIMAL values within rel 1e-9, FLOAT8 values
   (Q8's share, Q17's average) within rel 1e-6, keys, counts, strings
   and dates exactly, rows in the oracle's order (Q11 orders by value
   alone, so rows of equal value compare in one canonical order). One
   route line per query: kernel launches, and over every plan run the
   statement made, group_ids calls, partitioned re-runs and their
   partition counts, temps and their rows, subqueries evaluated,
   Compact nodes and replans. At SF1 the large-G kernel's launches per
   query (SF1_PHASE7_LAUNCHES) and Q20's partition count (16: its
   decorrelated GROUP BY overflows the default hash table) are
   checked (Q2 launches once where the parity gate promoted
   int_minmax: its min(ps_supplycost) per part key). Every temp of Q2,
   Q4, Q7, Q8, Q9, Q13, Q15, Q17, Q20, Q21
   and Q22 must take the columnar path (Engine.last_exec["temps"]), not
   the decoded rows. No sort may leave the packed lanes, and no temp
   may outlive its statement. Every call of the large-G kernel these
   queries make is held against its plain version at the exact slots
   the query handed it, as in phase 4 (compare_slots). Medians of 3
   warm runs and the peak device memory.
8. SSB: a second Engine loads lineorder (6,000,000 rows) and the
   dimensions at the generator's SF1 sizes and runs the five flights
   against the numpy oracles (models/ssb.py), integers exactly, with
   routes (the large-G kernel once each in q2.1, q3.1, q4.1, checked,
   and held against its plain version at each call's slots) and
   medians of 3 warm runs.
9. Prepared statements: Q1, Q6, Q3 and Q15 through Engine.prepare and 5
   runs each, every run equal to execute's rows; a second prepare of
   the same text hits the exec cache (Q15's re-execute handle hits it
   on its runs), with the counters; the host ms per run both ways, the
   median wall time minus torch.profiler's device busy time.
10. Beyond memory at TPC-H SF3 (`beyond_memory_phase()`), in an Engine
   of its own (the SF1
   engines are freed first): prints the host's MemTotal/MemAvailable and
   the card's free and total memory, loads lineitem (18,003,645 rows),
   part (600,000) and orders (4,500,000) with the generators' seeds
   and prints the load seconds. At sql.exec.hbm_budget_bytes = 1 GiB
   and pages of 2^21 rows Q1, Q6 and Q14 must stream (9 pages at SF3
   uploaded or skipped, kernel 1 never launched, peak
   max_memory_allocated() under 2 GiB) and equal the numpy oracles;
   SET streaming_pipeline = off must give identical rows. Both ways:
   one warm run in the whole run (medians of 3 by itself), rows/s, H2D
   GB/s over the wall time, the
   consumer's stall and the worker's overlap seconds; and Q14's
   per-page direct-join table rebuild alone. At 64 GiB the same
   queries run resident (Q1 launches kernel 1 once) and must equal the
   streamed rows (INT, DECIMAL, STRING, DATE exactly, FLOAT8 within rel
   1e-9), with the placement rules' working-set estimate
   (Engine.working_set) printed beside the measured peak. A lineitem x
   orders aggregate on the order key must spill into at least 4
   partitions at a budget sized from that same reckoning and equal its
   resident run and a numpy oracle; a sort of a one-week l_shipdate
   slice under SET spill = on must equal its resident run and a numpy
   lexsort oracle, in order; a streamed Q6 through Engine.prepare runs
   3 times, equal each time. Every kernel-1 call of these path runs
   (resident Q1 over 2^25 padded rows, the resident join) is held
   against the plain version at its own slots. One JSON `stream` line
   holds these numbers.
11. Windows, the write path and YCSB-E, on the SF1 engine of phases
   6-9 after phase 9 (it changes the tables; phase 10 runs after it).
   (a) Five window queries over the orders of customers 1..30,000
   (about 300,000 of SF1's 1,500,000 rows, ~20,000 customers as whole
   partitions; `WINDOW_CUSTKEY`, cut from every order):
   row_number, rank, dense_rank and ntile(4)
   by o_totalprice DESC; lag, lead, first_value and last_value of
   o_orderdate; running sum, avg, count, min and max of o_totalprice;
   a whole-partition sum; two windows over a filtered scan. Each is
   checked in full against a numpy oracle (integers, DECIMAL and dates
   exactly, AVG rel 1e-9, rows in o_orderkey order), then timed: one
   warm full run and one warm run in the whole run (the median of 3 by
   itself) with an outer LIMIT 1000 (decoding every row to Python is
   most of a full run). (b)
   TPC-H's refresh pair through SQL: the pk locators built and timed
   (the reference's pure-Python row_key loop timed over 50,000 rows
   beside them), RF1 (1,500 orders and their ~6,000 lines, multi-row INSERTs in one
   transaction) with a Q6 inside it that must read its own writes, RF2
   (DELETE of 1,500 orders' lines and orders), an UPDATE of one
   order's l_discount and a rolled-back INSERT; then Q1, Q6, Q14 and Q3
   against the oracles over arrays changed the same way (phase 2's and
   6's tolerances). Q1 must launch kernel 1 once, and each kernel-1
   call is held against the plain version at its slots (`path_checks`
   "sf1 q1 phase 11"); a second run of each must hit the exec cache.
   Then a further UPDATE changes l_discount and l_extendedprice of 200
   orders' lines (Q3's first order among them): each query's next run
   must miss the exec cache, equal the oracle over arrays changed the
   same way (Q1 again through kernel 1, checked) and read lineitem's
   device copy of the new generation, and its run after that must hit.
   A small table is refilled after TRUNCATE and after DROP + CREATE
   with the same row count and dictionary size, and must read its own
   strings through execute() and a Prepared made before the TRUNCATE.
   (c) YCSB-E (BASELINE.json config 5): 10,000 records in the whole run
   (100,000 by itself, `dml_phase_alone`) loaded by the
   workload's INSERTs of 10,000 rows, then 2,000 operations in the
   whole run (10,000 by itself; 95%
   scans of 10, 5% inserts, zipfian, seed 1, every statement served by
   the OLTP lane), timed; every scan's rows are then held against a
   sorted-keys oracle replayed from the run's log, and count/sums of
   usertable on the card against it.
12. The OLTP lane beside the card, on the SF1 engine after phase 11
   (`oltp_phase`; `oltp_phase_alone()` runs it by itself). usertable
   is dropped and bulk-loaded again with 1,000,000 records (i, i*7 %
   1000, i*13 % 1000) through the store's ingest path; the native
   mirror's first rebuild is timed. YCSB A-F run 5,000 operations
   each in one session (zipfian, seed 1, scans of 10): every statement
   must be a lane hit; ops/s and p50/p99 per operation kind; A's and
   E's reads and scans are then replayed against an oracle of every
   mix's writes. A and E run at 16 workers (8,000 operations each)
   with oltp_batch auto, then off: ops/s, p50/p99, retries, the batch
   counters (windows, fused statements, window size p50, wait in the
   window) and the group commits. A third YCSB-A at 16 workers runs
   with TPC-H Q1 5 times in a thread of its own: each Q1 equals the
   oracle over lineitem as phase 11 left it and launches kernel 1 once,
   lane statements complete while it runs, and no lane write falls to
   the full path. Then `SELECT field0, count(*), sum(field1),
   min(field1), max(field1) FROM usertable GROUP BY field0` (under
   `auto` where the parity gate promoted int_minmax, else under SET
   pallas_groupagg = on) flushes the lane's queue as one chunk, misses
   the exec cache, uploads usertable again and launches kernel 1 once,
   held against the plain version at its slots and against numpy over
   the full path's rows (and equal to its `off` run); its second run
   hits. Every key's field0 must be
   its value before the concurrent runs or one some driver wrote, and
   count(*) and sum(field1) exact. TPC-H Q15 runs as the specification
   writes it (CREATE VIEW revenue0, the query, DROP VIEW): one temp,
   kernel 1 once, equal to the Q15 oracle. A DEFAULT nextval column
   takes 10,000 rows of an INSERT ... SELECT: keys dense and unique,
   a value drawn in a rolled-back txn never handed out. usertable
   gains one chunk per flush. The timestamp cache's size and the cost
   of one add are printed. Phase 12 must take 150 s or less.
13. The front door, on the SF1 engine after phase 12
   (`frontdoor_phase`, then `entry_points_phase`;
   `frontdoor_phase_alone()` runs both by themselves). A PgServer runs
   over that Engine, first with the `threads` frontend, then the
   `reactor`. Under each, one client (server/miniclient.py) sends
   TPC-H Q1, Q6, Q14 and Q3 through the simple protocol, Q6 through the
   extended protocol with its dates, discount bounds and quantity as
   $n parameters in text and then in binary (the dates in text both
   times), then `SET pallas_groupagg = on` and Q1F; then each
   text once more through execute(). Every count is set to 0 just
   before each run and read just after, and phase 13's launches are
   the sum of what was read. The decoded rows equal the numpy oracles
   over the arrays as phase 11 left them (phase 2's and 6's
   tolerances) and execute()'s rows for the same text (Q1F within rel
   1e-5); Q1 launches kernel 1 once and Q1F kernel 2 once, each way,
   and each launch is held against its plain version at the inputs it
   was given. Medians of 5 warm runs of Q1, Q6 and a usertable pk
   point SELECT over the wire, and through execute(), where Q1 and Q6
   also take 21 warm runs with the parse cache and 21 with a parse per
   statement; the timed runs' launches are counted the same way, but
   not held against the plain version one by one. 16 wire sessions, a thread each in a client process of
   their own (`wire_client_main`, so their Python does not share the
   server's interpreter lock), run YCSB-B and then YCSB-E (1,000
   operations a mix, the port's statement texts, a 40001 retried):
   ops/s and p50/p99 by kind, and 200 written keys read back as some
   session wrote them; under `threads`, `reactor`, and `reactor` with
   sql.exec.switch_interval = 0.001 (which must set the interpreter's
   switch interval and restore it at 0). Then 1,000 idle sessions are
   parked on the reactor while the 16 live sessions run YCSB-B (600
   operations): the server process's thread count (it may grow by the
   worker pool at most), the RSS a parked session costs (its client
   end included), the live p99; and Q1 from a 17th session beside
   YCSB-B (600 operations) equals its oracle and launches kernel 1
   once (checked) while lane statements complete.
   Admission, at 4 execution slots: 8 sessions of a noisy tenant
   (`application_name`) send Q1 twice each (each equal to the oracle,
   every launch checked) while 4 of a quiet tenant send pk point reads
   that the lane refuses (a residual conjunct), so each takes the full
   path through admission; once with no tenant cap and once at
   sql.admission.tenant.slots = 2. For each: the quiet and noisy
   p50/p99, admission.tenant.slot_waits (at least 1 at the cap) and
   queued; then what /_status/tenants serves. The entry points, on the card,
   reusing the kernels phase 1 built (`_build/` unchanged): a Node
   with TPC-H SF 0.05 in process (Q1 over the wire equals its oracle,
   launches kernel 1 once, checked; /_status/statements lists its
   fingerprint with count 1; /_status/vars serves the metrics; stop()
   returns), and as processes of their own, started together:
   `python3 -m cockroach_tpu_torch demo --sf 0.05` with Q1 and Q6 on
   stdin (its printed rows equal the SF 0.05 oracles), `start
   --listen-addr 127.0.0.1:0` with `sql -e` of a CREATE TABLE, an
   INSERT of 500 lineitem rows, Q6 (equal to its oracle) and SHOW
   STATEMENTS (Q6's fingerprint with count 1), and `workload tpcc
   --steps 100` (exit 0, its JSON line). The in-process Node's client
   (application_name `phase14`) sends its Q1 past a 1 ms
   sql.trace.slow_statement.threshold: /debug/tracez lists it; POST
   /_status/stmtdiag arms Q6, whose next run over the wire equals its
   oracle and captures a bundle fetched at /_status/stmtdiag/<id>;
   /_status/tenants shows the tenant's device_seconds.
14. What clients and operators send, on the SF1 engine after phase 9
   and before phase 11's writes, on phase 7's tables and oracles
   (`observability_phase`; `observability_phase_alone()` loads SF1 and
   runs it by itself). Every statement run is driven with every count
   set to 0 just before it and read just after, each kernel launch held
   against its plain version at its inputs. Composed CTEs: TPC-H Q4,
   Q15, Q21, Q13 and Q22 prepared, run once (the slow path captures)
   and 5 times more: every run equals its oracle at phase 7's
   tolerances and launches kernel 1 as phase 7 does; runs 2-6 compose
   (no temp materialized or uploaded, nothing declined). One slow run
   (execute) and one composed run of Q4 and Q21 under torch.profiler:
   wall, busy and HtoD ms. A customer inserted between two runs of
   composed Q22 sends the next run to the slow path (rows equal the
   oracle over the changed table), and the run after it composes
   again; its delete does the same and restores phase 7's rows. Set
   operations: a UNION ALL of two Q1-shaped aggregates split at ship
   date 1995-06-17 (kernel 1 once a branch; also prepared, run
   twice), an EXCEPT and an INTERSECT of BUILDING customers against
   the distinct o_custkey, and a UNION of n_name and r_name, each equal
   to its numpy oracle. EXPLAIN ANALYZE of Q1, and of Q1F under SET
   pallas_groupagg = on: kernel 1, then kernel 2, once each; the root's
   actual rows equal the rows returned; the aggregate's device ms is
   above 0 and the operators' add up to no more than the total; each
   operator's device ms printed beside the kernel's own CUDA-event ms
   at the same inputs. EXPLAIN ANALYZE (DEBUG) of Q6 returns a bundle
   that the registry serves by its id. SET tracing = on, Q1, SHOW TRACE
   FOR SESSION (plan, dispatch and materialize spans); Q6 past a 1 ms
   slow-statement threshold enters the ring. Medians of 5 warm runs of
   Q1 and Q6 through execute with sql.stmt_profile.enabled on, off, on
   (the coarse plane's cost; those runs' launches are counted apart).
15. Schema and history, on the SF1 engine after phase 13, with the HLC
   wall time t0 phase 11 took before RF1. Q1 and Q6 AS OF SYSTEM TIME
   t0, twice each, and a prepared Q1 AS OF t0 equal the oracles of the
   tables phase 11 started from; without AS OF, its post-refresh
   oracles. The second AS OF Q1 hits the exec cache and moves no byte
   to the card. After a quiet window, an UPDATE of one order's lines
   that leaves Q1 as it was; then one text of Q1 AS OF SYSTEM TIME
   '-Ns', each run reading at a new timestamp inside the window, equals
   the present oracle, and its second and later runs plan and move
   nothing. A protected timestamp at t0 on lineitem and orders and
   a zone of gc.ttl_seconds = 1 on lineitem: a GC pass removes nothing
   t0 can see and AS OF Q1 is unchanged; released, the next pass
   removes exactly the versions deleted below its threshold (every one
   RF2 deleted among them), present Q1 equals its oracle, and AS OF t0
   is refused below the GC threshold. CREATE INDEX on o_custkey runs its
   backfill job (SHOW JOBS: succeeded; SHOW INDEXES: public) and 20
   point SELECTs by o_custkey take the index fast path once each and
   equal the oracle; a UNIQUE index on s_name is built and refuses a
   duplicate with the reference's text; a UNIQUE index on l_orderkey
   fails in its job and leaves no index. ALTER TABLE lineitem ADD
   COLUMN l_fee DECIMAL(15,2) NOT NULL DEFAULT 0.05 backfills, Q1 with
   sum(l_fee) gives 0.05 x count_order in every group, exactly, and
   after DROP COLUMN plain Q1 equals its oracle. Each Q1 launches
   kernel 1 once, held against the plain version at its own slots;
   kernel 2's launches are counted too, each held against its plain
   version.
16. Jobs and changefeeds, on the SF1 engine after phase 15 (`jobs_phase`;
   `jobs_phase_alone()` loads SF1 and runs it by itself), in a temporary
   directory removed at its end. CREATE CHANGEFEED FOR supplier into a
   file sink delivers its 10,000 rows from cursor 0; a changefeed on
   lineitem from now; an UPDATE of one order's lines goes the full path
   (the lane counts a "changefeed active" decline) and its events
   arrive. BACKUP TABLE lineitem, orders INTO a collection (SHOW JOBS:
   succeeded; one protection record at the layer's end_ts). A row-TTL
   pass over l_shipdate deletes exactly the rows at or before the 5,000th
   ship date (numpy's count), the feed gets exactly those keys as
   deletes and a resolved timestamp past them, and Q1 equals its oracle
   over the rest. A second BACKUP adds an incremental layer and moves
   the one protection record to its end_ts. RESTORE into a second engine
   on the card: its Q1 and Q6 equal the source's and the oracles, and an
   INSERT there takes a rowid past every restored one; the engine closes.
   An IMPORT of 6,000,000 rows in chunks of 500,000, whose first session
   crashes after chunk 3 with a lease of 0, is adopted by a second
   session: count(*), sum(a) and a GROUP BY s equal the sums of
   synthetic_chunk's arrays exactly. CANCEL JOB ends both feeds' threads;
   the supplier sink holds its 10,000 rows and one UPDATE, resolved
   timestamps monotone. Each Q1 launches kernel 1 once and the GROUP BY
   as its route takes it, each launch held against the plain version;
   kernel 2's launches are read from its count.
17. Cold start and kernel infrastructure, on the SF1 engine after phase
   9 (lineitem as loaded; `coldstart_phase`; `coldstart_phase_alone()`
   loads SF1 and runs it by itself). (a) The parity gate: its verdicts
   (and a second fuzz's, which must agree); under `auto`, `SELECT
   l_suppkey, min(l_extendedprice), max(l_orderkey), min(l_quantity)
   FROM lineitem GROUP BY l_suppkey` (6,001,215 rows, 10,000 groups)
   and Q2 launch kernel 1 exactly when int_minmax was promoted, each
   launch held against the plain version, the GROUP BY's rows equal to
   numpy's bit for bit and Q2's to phase 7's oracle, both equal to
   their `off` runs. (b) The launch-point sweep with CUDA events at the
   synthetic shape (n = 2^16, G = 2^12) and at Q1's captured slots,
   every point's ms and the winner persisted per card name; every
   point held against the plain version at both shapes (integer and
   MIN/MAX rows bit for bit); Q1 at the shipped point and at the tuned
   one (read back from the table, no second sweep) give the same rows.
   (c) Q6 with five literal sets from TPC-H's substitution ranges: one
   exec-cache miss, then four hits, each equal to its numpy oracle
   (rel 1e-9); the host ms of a run with new literals, plan_shape_cache
   off and on. (d) Two child processes ingest the Q1/Q6 columns of
   lineitem from an .npz and share a cache root holding the tuning and
   verdict tables: the first (prewarm 0) journals its misses, the
   second (sql.exec.compile_cache.prewarm = 8) prewarms them and its
   first Q1 and Q6 are exec-cache hits; each prints its prewarm
   seconds, statements warmed, first Q1 and Q6 ms, plan_cache, and
   kernel-library loads and builds; their rows equal phase 2's, and
   each Q1 launch is held against the plain version.
18. Distributed aggregation over a shard mesh, after phase 17 (lineitem
   as loaded; `distributed_phase`; `distributed_phase_alone()` loads SF1
   lineitem and part and runs it by itself). An Engine over the SF1
   store on make_mesh([cuda:0] * 4): four shard slots on the one card.
   Q1, Q6, Q14, phase 17's MIN/MAX GROUP BY and, under SET
   pallas_groupagg = on, Q1F and Q6F run distributed and under SET
   distsql = off, each with every count set to 0 just before it and
   read just after: one dispatch each distributed, none local; rows
   equal to the local run's (INT, DECIMAL, STRING, DATE exactly, FLOAT8
   within rel 1e-9, Q1F and Q6F within rel 1e-5) and to the numpy
   oracles. Kernel 1 launches 4 times for Q1 (and for the MIN/MAX GROUP
   BY where int_minmax was promoted), kernel 2 4 times each for Q1F and
   Q6F, every launch held against its plain version at its shard's
   inputs and launch point. tests/test_dist_hash_groupby.py's hg table
   at 6,000,000 rows and 100,000 keys (spread past a span of 2^21 so
   that it groups by hash) takes the hash route through the exchange
   (two group_ids a shard) and equals numpy and the local run. Q1 on
   the pool's 2-slot sub-meshes (sql.exec.submesh.size = 2) gives the
   same rows through kernel 1 twice; no CollectiveFault retry; the
   dispatchers' queues empty. Then 5 warm runs each way in pairs (3 for
   hg), their medians, and for each way the device busy ms
   (torch.profiler), the host ms and the idle share; kernel 1's and
   kernel 2's numbers (slot_numbers, small_numbers) at one shard's Q1
   and Q1F inputs.
19. DistSQL flows between engines (lineitem as loaded, after phase 18;
   `flows_phase_alone()` runs it by itself): four data nodes and a
   gateway, port Engines on the card over LocalTransport, each with a
   device budget of 8 GiB; every data node holds a contiguous quarter of
   lineitem (1,500,303 or 1,500,304 rows), `part` replicated on every
   node for gateway A and quartered for gateway B. Through Gateway.run,
   each with every count set to 0 just before it and read just after:
   Q1, Q6 and Q14 on A (Q14 derives a join-filter frame from the
   replicated part), Q14 on B (the sharded x sharded join, a graph flow
   with two exchange stages), a GROUP BY over l_partkey <= 40,000
   through _decompose_groupby (prefer_shuffle), Q1F and Q6F under `on`,
   a GROUP BY of (l_orderkey, l_linenumber) over one ship date whose
   every node ships raw rows to the gateway's fold, and one of
   l_linenumber whose every node keeps partials. Rows equal the SF1
   engine's (FLOAT8 within rel 1e-9, 1e-5 under `on`) and the numpy
   oracles; kernel 1 launches 4 times for Q1 (once a data node, kernel
   2 none), kernel 2 4 times each for Q1F and Q6F (kernel 1 none), each
   launch held against its plain version at its node's inputs;
   shuffle.bytes.received > 0; no inbox is left in any registry. Then
   the pieces of one flow statement (the nodes' stage runs and output
   pulls, serde, the rest of the pump, the final stage), 5 warm runs
   through the gateway paired with the SF1 engine's, their medians,
   device busy ms (torch.profiler), host ms and idle share, and kernel
   1's numbers at one node's Q1 slots (slot_numbers). Last, Q1 on A and
   Q14 on B once more through a Gateway whose five nodes each own a
   SocketTransport (rpc/context.py) over the same engines, the data
   nodes each with a pump thread, all in this process (the reference's
   socket_fakedist shape): rows equal the LocalTransport runs' (the
   parity contract), kernel 1 launches 4 times for Q1 (each launch held
   against its plain version) and none for Q14; then 3 warm runs each,
   their median beside LocalTransport's.
20. The multi-process pod (lineitem as loaded, after phase 19;
   `pod_phase_alone()` runs it by itself): the card's free memory is
   printed, then two processes of server/hostd.py (`--num-processes 2
   --fanout 2 --sf 1 --queries q6,groupby,join --repeat 5`, the
   coordinator a TCPStore on a free localhost port) run on the one card,
   each through pod_child_main, which runs hostd.main inside
   recording_slots() with every count at 0. Each host generates SF1
   lineitem and part with the SF1 engine's generators and seeds and
   keeps its half of lineitem (3,000,607 or 3,000,608 rows) and all of
   part; host 0's gateway runs each query 5 times over the socket fabric
   and the host merge tree. Both hosts must exit 0 within 240 s. Host
   0's GROUP BY rows (Q1's exact sums and count) equal the SF1 engine's
   bit for bit, its Q6 and Q14 the SF1 engine's and the numpy oracles
   within rel 1e-9, the GROUP BY also the numpy Q1 oracle's sums and
   counts; on each host kernel 1 launches once in each GROUP BY run's
   stage and never for Q6 or Q14, and each launch is held against its
   plain version at that host's inputs; exec.multihost.hosts is 2 on
   both hosts, host 0 tree-merged (distsql.flows.tree,
   exec.multihost.flows.merged >= 1, exec.multihost.merge.bytes > 0)
   and host 1 shipped (shuffle.bytes.sent, rpc.frames.sent > 0). One
   JSON `pod` line: each query's first and best-of-5 seconds, each
   host's start-up seconds (spawn to ready, interpreter, rendezvous,
   generation and ingest) and its mem_get_info() and its own peak allocated and reserved bytes after
   the run, the
   launches and the metrics.
21. The elastic pod at SF1 (lineitem as loaded, after phase 20;
   `elastic_phase_alone()`): three server/hostd.py --elastic processes
   (`--sf 1 --nshards 8 --queries groupby,q6 --repeat 8
   --statement-gap 0.25`, heartbeats every 0.25 s, a 30 s liveness
   window, both printed), each through elastic_child_main inside
   recording_slots() with every count at 0: host 0 founds the pod
   (`--initial-hosts 2`), host 1 drains after the founder's 4th GROUP
   BY run, host 2 joins after its 2nd (`--late-join`, streaming its
   shards from their live owners before the flip); all exit 0 within
   240 s. Every GROUP BY run equals the SF1 engine's rows bit for bit
   (and the numpy Q1 oracle's sums and counts), every Q6 run within rel
   1e-9, both consistent; three epochs or more; kernel 1 once in each
   GROUP BY stage a host runs over installed shards, never for Q6, each
   launch held against its plain version; leases moved and shard bytes
   streamed. Then three in-process ElasticPods over SocketTransports,
   port engines on the card with SF1 lineitem in 8 shards: host 2 is
   killed mid-scan and the GROUP BY comes back through the failover
   rung with the SF1 engine's rows. One JSON `elastic` line.
22. SQL on raft-replicated ranges (`ranges_phase_alone()`): a 3-node
   Cluster; lineitem's span split in 4 ranges and part's in 2, then
   20,000 lineitem rows and 2,000 parts (the sf 0.01 generators) loaded
   through a gateway's INSERTs of 1,000 rows (rows/s and raft messages
   a row printed). Q1 (under `auto`: kernel 1 once, held against its plain
   version), Q6 and Q14 through gateway A equal a local engine's and
   the numpy oracles; an UPDATE of 202 rows through A (rows/s and raft
   messages a row printed)
   shows on gateway B, B's AS OF read from before it equals A's first
   Q1; after stop_node of a leaseholder, a fresh gateway C has every
   row; Q1 and Q14 (`auto`) and Q1F (`on`) through Gateway(cluster=c)
   over three DistSQLNodes equal A's (kernel 1 and kernel 2 once a
   node holding spans, each launch held
   against its plain version), also after a transfer_lease;
   /_debug/ranges lists every range with its leaseholder; medians of 5
   warm Q1 runs on A and on the local engine, busy ms, host ms, idle
   share. One JSON `ranges` line.
23. Raft over TCP (`netcluster_phase_alone()`): three processes of
   `python -m cockroach_tpu_torch start --device cuda --kv-addr ...` on
   the one card. Node 1 (`--bootstrap`) alone takes the first 6,144
   lineitem rows of the sf 0.01 generator through its pgwire in INSERTs
   of 1,000 into one range (rows/s printed); nodes 2 and 3 then start
   with `--join` node 1, one after the other, and are up-replicated
   onto by snapshot (seconds printed); 200 more rows go in through node
   2 and an UPDATE of 100 rows through node 3, replicated three ways.
   Then, with nothing else running in this process, Q1 through each
   node's pgwire (first and best of 5) equals the numpy
   oracle over the final rows, the same rows on every node, and kernel
   1 launches once a run in each node's process, read from its
   /_status/vars (`kernel.groupagg_large.launches`). This process joins
   as node 4 (NetCluster(4, join=...), Engine(cluster=n4) on the card,
   no replica): its 6 Q1 runs equal the oracle, each launch held
   against the plain version at its slots, with busy ms and idle share.
   /_status/nodes on each node lists every other node healthy;
   /debug/tracez?cluster=1 from node 2 merges the rings of nodes 1-4,
   not partial; `node status` and `debug ranges` read node 2's URL.
   Then the leaseholder's process is killed (SIGKILL): the first answer
   to Q1 on a survivor equals the oracle (kill to that answer: the
   failover seconds; only the errors of a moving lease or a refused
   connection are retried, each counted under "retried", and a wrong
   answer ends the run), so does Q1 on the other survivor, 10 rows go
   in through a survivor, the status plane shows the dead node
   unhealthy and the fan-out partial, and the killed node restarts with
   `--join` a survivor and its first answer to Q1 holds that write (the
   rejoin seconds), as does node 4's. In the whole run, the first half
   (the load, the joins and the three-way writes) runs in a thread
   beside phases 22, 14 and 11: it touches no engine or kernel count of
   this process, but it shares the host's cores and the card with them,
   so those phases' lines carry "beside_phase23_first_half" and phase
   23's "first_half_beside" names them; the second half runs after
   phase 11, alone. One JSON `netcluster` line.
24. graftlint (`analysis_phase()`), first and alone, before phase 1:
   `python -m cockroach_tpu_torch.analysis --json` in a process of its
   own over this checkout, under the card host's Python and torch. Its
   exit code must be 0 (no unwaived finding of any of the eight rules,
   no malformed waiver); nothing catches a failure. One JSON `analysis`
   line (printed after phase 23's): files, functions, findings and
   waived per rule, the analyzer's own seconds and the process's, the
   Python, torch and CUDA versions, and the card's name and power
   limit.
25. The reference's SQL logic corpus on the card (`logic_phase()`),
   last, after phase 10: every golden file of
   tests/testdata/logic_test/ (83) through the port's Engine on the
   card under `local` (one engine, DistSQL off) and `fakedist` (a mesh
   of 4 slots of the card, `make_mesh([cuda:0] * 4)`, DistSQL auto),
   driven by tests/test_torch_logic.py's `run_file` (loaded by path;
   it imports no JAX). Every block's output must equal its golden;
   nothing catches a failure. The kernel counts are set to 0 before
   each config and read after it, and each kernel call is held against
   its plain version at its own arguments (the corpus's tables are under
   kernel 1's 4,096 rows: on an H100 it launched none). One
   JSON `logic`
   line a config: files, blocks, seconds, launches, and the card's
   name and power limit.
Each phase's seconds are printed. After phase 10, one JSON `dml` line
holds phase 11's numbers, one JSON `oltp` line phase 12's, one JSON
`frontdoor` line phase 13's, one JSON `observability` line phase
14's (with the node's checks under "node"), one JSON `history` line
phase 15's, one JSON `jobs` line phase 16's, one JSON `coldstart`
line phase 17's, one JSON `distributed` line phase 18's, one JSON
`flows` line phase 19's, one JSON `pod` line phase 20's, one JSON
`elastic` line phase 21's, one JSON `ranges` line phase 22's, one
JSON `netcluster` line phase 23's and one JSON `analysis` line phase
24's (phase 25's `logic` lines come before them, as it runs), each
with the card's name and power limit; then one JSON line of
per-kernel numbers (the
large-G kernel's launches count Q1, Q5, Q10, Q12 and the path runs of
phases 7, 8, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20 (both pod
hosts'), 21 (every elastic host's and the kill's), 22, 23 (every
start process's, read from its /_status/vars, and node 4's) and 25, the
small-G kernel's Q1F, Q6F and phases 13's, 14's, 18's, 19's, 22's and
25's; `path_checks` holds each of the large-G kernel's calls in phases
7, 8, 10-23 (in phase 23, node 4's) and 25 held against the plain
version, and the small-G kernel's phase 13, 14, 18, 19, 22 and 25
calls), the nvidia-smi
line, and the last line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --profile DIR

also profiles the phase 6 queries with torch.profiler after the last
check (profile_tpch.profile_queries; traces and numbers into DIR).
"""

from __future__ import annotations

import atexit
import contextlib
import gc
import json
import statistics
import struct
import subprocess
import sys
import time

SF = 1
ZERO_GROUP = 6              # small_synthetic: a group of -0.0 values
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)

# the lineitem x partsupp half of TPC-H Q9 without its supplier key: a
# duplicate-keyed build side (4 partsupp rows per part key)
QPS = """
SELECT count(*) AS n, sum(ps_supplycost * l_quantity) AS cost
FROM lineitem, partsupp
WHERE l_partkey = ps_partkey
  AND l_shipdate >= date '1995-01-01' AND l_shipdate < date '1995-02-01'
"""
# returned-item revenue per customer and ship mode (Q10's filters): at
# SF1 o_custkey spans 150,000 values, past the 4,096 a dense code of two
# keys may take, so it groups by hash (hashtable.group_ids). Q10 itself
# does not: the planner reduces its keys by functional dependency to the
# one dense key c_custkey (150,001 groups, the large-G kernel).
QH = """
SELECT o_custkey, l_shipmode, count(*) AS n,
       sum(l_extendedprice * (1 - l_discount)) AS revenue
FROM orders, lineitem
WHERE l_orderkey = o_orderkey
  AND o_orderdate >= date '1993-10-01' AND o_orderdate < date '1994-01-01'
  AND l_returnflag = 'R'
GROUP BY o_custkey, l_shipmode
ORDER BY revenue DESC, o_custkey, l_shipmode
LIMIT 20
"""


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def analysis_phase() -> dict:
    """Phase 24: graftlint over this checkout in a process of its own,
    under this host's Python and torch. A nonzero exit (an unwaived
    finding, a malformed waiver, or no package to scan) raises."""
    import platform
    from pathlib import Path

    import torch
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "cockroach_tpu_torch.analysis", "--json"],
        cwd=str(Path(__file__).resolve().parent), capture_output=True,
        text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(
            f"phase 24: graftlint exited {proc.returncode}:\n"
            f"{proc.stdout[-6000:]}\n{proc.stderr[-3000:]}")
    rep = json.loads(proc.stdout)
    timings = rep["timings"]
    rules = [k for k in timings if k not in ("index_seconds",
                                             "total_seconds")]
    if len(rules) != 8:
        raise AssertionError(f"phase 24: rules that ran: {rules}")
    out = {"files": rep["files"], "functions": rep["functions"],
           "exit_code": rep["exit_code"],
           "rules": {r: rep["counts"].get(r, {"findings": 0, "waived": 0})
                     for r in rules},
           "analyzer_s": timings["total_seconds"],
           "index_s": timings["index_seconds"], "process_s": wall,
           "python": platform.python_version(), "torch": torch.__version__,
           "cuda": torch.version.cuda, "card": _smi()}
    print(f"phase 24 (graftlint): exit 0, {rep['files']} files, "
          f"{wall:.1f} s", flush=True)
    return out


LOGIC_SLOTS = 4             # phase 25's fakedist mesh: slots of the card


def logic_corpus():
    """tests/test_torch_logic.py, loaded by its path (the card's machine
    may have another package named ``tests``): the corpus's files, its
    configs and ``run_file``."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent / "tests" / "test_torch_logic.py"
    spec = importlib.util.spec_from_file_location("_logic_corpus", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def logic_phase(device: str = "cuda:0") -> list:
    """Phase 25: the reference's SQL logic corpus through the port's
    Engine on ``device`` under `local` and `fakedist` (LOGIC_SLOTS slots
    of it). A block that differs from its golden raises. The kernel
    counts are set to 0 before each config and read after it; on the
    card each kernel call of the config is held against its plain
    version (check_calls, _check_small_calls). Returns one dict a
    config, each printed as a JSON `logic` line (its checks under
    "path_checks" and "small_checks")."""
    from cockroach_tpu_torch.ops.cuda import groupagg as tg
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    mod = logic_corpus()
    on_card = device.startswith("cuda")
    card = _smi() if on_card else "cpu"
    lines = []
    for cfg in ("local", "fakedist"):
        _counts_zero()
        t0 = time.perf_counter()
        with recording_slots() as calls, recording_small() as scalls:
            blocks = sum(mod.run_file(path, mod.CONFIGS[cfg],
                                      device=device, slots=LOGIC_SLOTS)
                         for path in mod.FILES)
        seconds = time.perf_counter() - t0
        launches = {"groupagg_large": tgl.LAUNCHES, "groupagg": tg.LAUNCHES}
        line = {"config": cfg, "files": len(mod.FILES), "blocks": blocks,
                "seconds": seconds,
                "slots": LOGIC_SLOTS if mod.CONFIGS[cfg]["mesh"] else 1,
                "launches": launches,
                "plain_calls": {"groupagg_large": tgl.PLAIN_CALLS,
                                "groupagg": tg.PLAIN_CALLS},
                "card": card}
        print(json.dumps({"logic": line}), flush=True)
        line["path_checks"] = (check_calls(
            f"phase 25 {cfg}", calls, launches["groupagg_large"])
            if on_card else [])
        line["small_checks"] = (_check_small_calls(
            f"phase 25 {cfg}", scalls, launches["groupagg"])
            if on_card else [])
        lines.append(line)
    return lines


def _cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _sync() -> None:
    """Wait for the card (the CPU has nothing to wait for)."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _median_ms(fn, reps: int = 5) -> float:
    times = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _close(got, want, rel) -> bool:
    if isinstance(want, str) or isinstance(got, str):
        return got == want
    return abs(got - want) <= rel * max(abs(want), 1e-300)


def check_q1(rows, want) -> None:
    if len(rows) != len(want):
        raise AssertionError(f"Q1: {len(rows)} groups, oracle {len(want)}")
    for g_row, w_row in zip(rows, want):
        if tuple(g_row[:2]) != tuple(w_row[:2]):
            raise AssertionError(f"Q1 keys {g_row[:2]} != {w_row[:2]}")
        for g, w in zip(g_row[2:], w_row[2:]):
            if not _close(g, float(w), 1e-6):
                raise AssertionError(f"Q1 {g_row} != oracle {w_row}")


def compare_kernel(tgl, args, label: str) -> dict:
    """Kernel vs plain version on the same card inputs; raises on a
    mismatch. Returns the largest absolute and relative f32 errors."""
    import numpy as np
    import torch
    gid, sel, mat, mm, G, mat_int, mm_ops, want_rep = args
    kf, ki = tgl.large_group_aggregate(*args)
    torch.cuda.synchronize()
    pf, pi = tgl.large_group_aggregate_plain(*args)
    kf, ki, pf, pi = (t.cpu().numpy() for t in (kf, ki, pf, pi))
    n_f = sum(not b for b in mat_int)
    if not np.array_equal(ki, pi):
        raise AssertionError(f"{label}: i32 rows differ")
    if not np.array_equal(kf[n_f:], pf[n_f:], equal_nan=True):
        raise AssertionError(f"{label}: MIN/MAX rows differ")
    err = np.abs(kf[:n_f].astype(np.float64) - pf[:n_f])
    rel = err / np.maximum(np.abs(pf[:n_f].astype(np.float64)), 1e-30)
    if n_f and not np.all(err <= 1e-5 * np.abs(pf[:n_f]) + 0.0):
        raise AssertionError(f"{label}: f32 sums beyond rtol 1e-5: "
                             f"max rel {float(rel.max())}")
    out = {"max_abs_err": float(err.max()) if n_f else 0.0,
           "max_rel_err": float(rel.max()) if n_f else 0.0}
    print(f"kernel vs plain [{label}]: n={gid.shape[0]} G={G} "
          f"n_mat={len(mat)} n_mm={len(mm)} rep={want_rep} ok {out}",
          flush=True)
    return out


def compare_slots(tgl, args, label: str) -> tuple:
    """The wrapper aggregate_slots against aggregate_slots_plain on the
    same card inputs (at the recorded launch point, args[5], where there
    is one), per caller slot through the rows each reads; raises on a
    mismatch. Returns the largest f32 errors (relative to the group's
    sum of |value|), and the shape: rows, groups, slots, the kernel's
    layout and launch point."""
    from cockroach_tpu_torch.ops.cuda.groupagg_large_check import (
        compare_plain)
    before = tgl.LAUNCHES
    out = compare_plain(args, tgl.aggregate_slots(*args))
    if tgl.LAUNCHES != before + 1:
        raise AssertionError(f"{label}: the wrapper did not launch once")
    plan = tgl.plan_slots(*args)
    layout = tgl.choose_layout(plan)
    point = list(tgl.kernel_point(args[5] if len(args) > 5 else None))
    print(f"kernel vs plain [{label}]: n={plan.gid.shape[0]} "
          f"G={plan.num_groups} slots={len(args[2])} "
          f"kernel_slots={len(plan.kslots)} columns={len(plan.cols)} "
          f"masks={len(plan.masks)} layout={layout} point={point} ok {out}",
          flush=True)
    return out, {"n": int(plan.gid.shape[0]), "G": plan.num_groups,
                 "slots": len(args[2]), "layout": layout, "point": point}


@contextlib.contextmanager
def recording_slots():
    """Record every call of the large-G kernel's wrapper while the block
    runs: yields a list that gets each call's arguments in slot_args'
    form, for the kernel-vs-plain checks at the shapes the queries gave
    it."""
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    kernel = tgl.aggregate_slots
    calls: list = []

    def recording(*args, **kw):
        calls.append(_slot_call(args, kw))
        return kernel(*args, **kw)

    tgl.aggregate_slots = recording
    try:
        yield calls
    finally:
        tgl.aggregate_slots = kernel


def engine_point(device="cuda") -> tuple:
    """Kernel 1's launch point an `auto` engine of this process builds
    its plans with: the tuning table's entry for the card under the
    run's cache root, else the shipped point (ops/cuda/autotune.py)."""
    import torch

    from cockroach_tpu_torch.exec import coldstart
    from cockroach_tpu_torch.ops.cuda import autotune
    from cockroach_tpu_torch.utils.settings import Settings
    dev = torch.device(device)
    root = coldstart.init_cache_dir(Settings(), dev)
    return autotune.table_point(coldstart.device_key(dev), root) \
        or autotune.DEFAULT


def check_calls(label, calls, launches, point=None) -> list:
    """The large-G kernel against its plain version at each recorded
    call of one query (compare_slots: the same tolerances as phase 4),
    each at the launch point the query launched with, which must be
    ``point`` (default: engine_point()); every launch the query made
    must have been recorded. Returns one record a call: its shape and
    errors."""
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    if len(calls) != launches:
        raise AssertionError(f"{label}: {len(calls)} recorded calls of the "
                             f"large-G kernel, {launches} launches")
    want = tuple(engine_point() if point is None else point)
    for args in calls:
        if args[5] is None or tuple(args[5]) != want:
            raise AssertionError(f"{label}: kernel 1 launched at the point "
                                 f"{args[5]}, the engine's is {want}")
    out = []
    for i, args in enumerate(calls):
        errs, shape = compare_slots(tgl, args, f"{label} call {i + 1}")
        out.append(dict(shape, **errs))
    calls.clear()
    return out


def synthetic(n, G, n_f, n_i, mm_ops, seed, gid_lo=0, gid_hi=None,
              sel_frac=0.8):
    """Seeded kernel inputs on the card: float and integer-valued sum
    columns and MIN/MAX columns, pre-masked to 0 / their identities as
    the plan compiler hands them over."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    hi = G if gid_hi is None else gid_hi
    gid = torch.randint(gid_lo, hi, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    sel = torch.rand(n, generator=g, device=dev) < sel_frac
    eff = sel & (torch.rand(n, generator=g, device=dev) < 0.9)
    mat = [torch.where(eff, torch.rand(n, generator=g, device=dev) * 1000,
                       0.0) for _ in range(n_f)]
    mat += [torch.where(eff, torch.randint(0, 1 << 10, (n,), generator=g,
                                           device=dev), 0).float()
            for _ in range(n_i)]
    vals = torch.randint(-(1 << 20), 1 << 20, (n,), generator=g,
                         device=dev).float()
    mm = [torch.where(eff, vals, float("inf") if op == "min"
                      else float("-inf")) for op in mm_ops]
    mat_int = (False,) * n_f + (True,) * n_i
    return (gid, sel, tuple(mat), tuple(mm), G, mat_int, tuple(mm_ops),
            True)


def check_float(label, got, want, rel=1e-5) -> float:
    """Rows of Q1F/Q6F against the float64 oracle: strings and counts
    exact, floats within `rel`. Returns the largest relative error."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} rows, oracle {len(want)}")
    worst = 0.0
    for g_row, w_row in zip(got, want):
        for g, w in zip(g_row, w_row):
            if not isinstance(w, float):   # group keys and counts
                if g != w:
                    raise AssertionError(f"{label} {g_row} != {w_row}")
                continue
            err = abs(g - w) / max(abs(w), 1e-300)
            worst = max(worst, err)
            if err > rel:
                raise AssertionError(f"{label} {g_row} != oracle {w_row} "
                                     f"(rel {err})")
    return worst


def _same_bits(got, want) -> bool:
    """NaN in the same cells, and bit-equal elsewhere (so -0.0 is not
    +0.0)."""
    import numpy as np
    gn, wn = np.isnan(got), np.isnan(want)
    return np.array_equal(gn, wn) and np.array_equal(
        np.ascontiguousarray(got).view(np.int32)[~gn],
        np.ascontiguousarray(want).view(np.int32)[~wn])


def compare_small(tg, args, label: str) -> dict:
    """Small-G kernel vs plain version on the same card inputs; raises
    on a mismatch. Returns the largest f32 sum errors and how many NaN
    and -0.0 cells the result holds."""
    import numpy as np
    import torch
    gid, sel, vals, masks, G, ops = args
    ka, kc = tg.dense_group_aggregate(*args)
    torch.cuda.synchronize()
    pa, pc = tg.dense_group_aggregate_plain(*args)
    ka, kc, pa, pc = (t.cpu().numpy() for t in (ka, kc, pa, pc))
    if not np.array_equal(kc, pc):
        raise AssertionError(f"{label}: counts differ")
    sums = [a for a, op in enumerate(ops) if op == tg.SUM]
    exact = [a for a in range(len(ops)) if a not in sums]
    if not _same_bits(ka[:, exact], pa[:, exact]):
        raise AssertionError(f"{label}: MIN/MAX columns differ")
    k64, p64 = ka[:, sums].astype(np.float64), pa[:, sums].astype(np.float64)
    if not np.array_equal(np.isnan(k64), np.isnan(p64)):
        raise AssertionError(f"{label}: NaN sums differ")
    fin = ~np.isnan(p64)
    err = np.abs(k64 - p64)[fin]
    rel = err / np.maximum(np.abs(p64[fin]), 1e-30)
    if not np.all(err <= 1e-5 * np.abs(p64[fin])):
        raise AssertionError(f"{label}: f32 sums beyond rtol 1e-5: "
                             f"max rel {float(rel.max())}")
    out = {"max_abs_err": float(err.max()) if err.size else 0.0,
           "max_rel_err": float(rel.max()) if rel.size else 0.0,
           "nan_cells": int(np.isnan(ka).sum()),
           "neg_zero_cells": int(((ka == 0) & np.signbit(ka)).sum())}
    print(f"small kernel vs plain [{label}]: n={gid.shape[0]} G={G} "
          f"A={len(ops)} ok {out}", flush=True)
    return out


def small_synthetic(n, G, ops, seed, gid_lo=0, gid_hi=None, sel_frac=0.8,
                    nan_groups=(), cols=None, neg_zero=False):
    """Seeded small-G kernel inputs on the card: float64 value columns
    (as the engine hands them over) and bool masks. Values are
    non-negative, so no cancellation inflates the f32 sums' relative
    error. cols: distinct value and mask columns, shared by the slots
    in turn (default one each per slot); neg_zero: zeros in 4% of the
    rows, -0.0 in even groups and +0.0 in odd ones, and -0.0 in every row
    of group ZERO_GROUP, so a MIN or MAX that is a zero has one right
    sign whatever order the rows fold in."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    hi = G if gid_hi is None else gid_hi
    gid = torch.randint(gid_lo, hi, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    sel = torch.rand(n, generator=g, device=dev) < sel_frac
    k = len(ops) if cols is None else cols
    vals, masks = [], []
    for _ in range(k):
        v = torch.rand(n, generator=g, device=dev,
                       dtype=torch.float64) * 1000
        if neg_zero:
            u = torch.rand(n, generator=g, device=dev)
            zero = torch.where(gid % 2 == 0, -0.0, 0.0).to(v.dtype)
            v = torch.where((u < 0.04) | (gid == ZERO_GROUP), zero, v)
        if nan_groups:
            hit = torch.isin(gid, torch.tensor(nan_groups, device=dev)) \
                & (torch.rand(n, generator=g, device=dev) < 1e-3)
            v = torch.where(hit, float("nan"), v)
        vals.append(v)
        masks.append(torch.rand(n, generator=g, device=dev) < 0.9)
    return (gid, sel, tuple(vals[a % k] for a in range(len(ops))),
            tuple(masks[(a + a // k) % k] for a in range(len(ops))), G,
            tuple(ops))


def _distinct_bytes(cols) -> int:
    """Bytes per row of the distinct columns among `cols` (by storage)."""
    seen = {}
    for c in cols:
        seen[c.data_ptr()] = c.element_size()
    return sum(seen.values())


def _distinct_content_bytes(cols) -> int:
    """Bytes per row of the columns among `cols` that differ in content:
    what the function needs when equal columns are read once."""
    import torch
    kept = []
    for c in cols:
        if not any(c.dtype == k.dtype and torch.equal(c, k) for k in kept):
            kept.append(c)
    return sum(c.element_size() for c in kept)


def small_numbers(tg, args, label: str) -> dict:
    """The small-G kernel's times at one shape: through its wrapper, alone
    (CUDA events around bare launches), its plain version, one
    index_add_ of the masked [n, A] f32 matrix into G rows (the library
    yardstick), and its byte bound: gid, sel with the distinct masks,
    the distinct value columns (each read once, float64 in place) and
    the [G, A] outputs. Columns are distinct by storage, as the kernel
    reads them; content_bound_ms counts columns equal in content once,
    as a plan that shared equal arguments would hand them over."""
    import torch

    from cockroach_tpu_torch.bench_groupagg import kernel_ms
    gid, sel, vals, masks, G, ops = args
    n, A = gid.shape[0], len(ops)
    out = {"strategy": tg.choose_strategy(G, A),
           "ms": _cuda_ms(lambda: tg.dense_group_aggregate(*args)),
           "kernel_ms": kernel_ms(args),
           "plain_ms": _cuda_ms(
               lambda: tg.dense_group_aggregate_plain(*args), reps=3,
               warm=1)}
    sel_b = sel.to(torch.bool)
    cols = []
    for v, m, op in zip(vals, masks, ops):
        mk = sel_b & m.to(torch.bool)
        cols.append(mk.float() if op == tg.COUNT
                    else torch.where(mk, v.float(), 0.0))
    matrix = torch.stack(cols, dim=1)
    gid64 = gid.long()
    out["library_ms"] = _cuda_ms(lambda: torch.zeros(
        G, A, device="cuda").index_add_(0, gid64, matrix))
    del matrix, cols
    read = [v for v, op in zip(vals, ops) if op != tg.COUNT]
    nbytes = n * (gid.element_size() + _distinct_bytes((sel,) + masks)
                  + _distinct_bytes(read)) + G * A * 8
    content = n * (gid.element_size()
                   + _distinct_content_bytes((sel,) + masks)
                   + _distinct_content_bytes(read)) + G * A * 8
    out.update({"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "content_bound_ms": content / HBM_BYTES_PER_S * 1e3,
                "shape": {"n": n, "G": G, "A": A, "bytes": nbytes,
                          "content_bytes": content,
                          "value_bytes_per_row": _distinct_bytes(read),
                          "mask_bytes_per_row":
                              _distinct_bytes((sel,) + masks) - 1}})
    print(f"small kernel numbers [{label}]: {json.dumps(out)}", flush=True)
    return out


def slot_numbers(tgl, args) -> dict:
    """The large-G kernel's numbers at one query's slots: its time
    through the wrapper, alone (CUDA events around bare launches of a
    prepared plan), its plain version's, one index_add_ of the
    pre-built [n, n_mat] f32 matrix into G rows (the library
    yardstick), the wrapper's host time per call, the layout, and the
    byte bounds: the slots' distinct columns each read once
    (``bound_ms``), the columns distinct in content, a mask that
    leaves sel as it is not read (``content_bound_ms``), and the
    pre-built columns (``prebuilt_bound_ms``), outputs written once."""
    import torch

    from cockroach_tpu_torch.bench_groupagg_large import (
        host_us, kernel_ms, prebuilt_columns, shape)
    shp = shape(args)
    plan = tgl.plan_slots(*args)
    point = args[5] if len(args) > 5 else None
    out = {"point": list(tgl.kernel_point(point)),
           "ms": _cuda_ms(lambda: tgl.aggregate_slots(*args)),
           "kernel_ms": kernel_ms(plan, point=point),
           "plain_ms": _cuda_ms(lambda: tgl.aggregate_slots_plain(*args),
                                reps=3, warm=1),
           "host_us": host_us(lambda: tgl.aggregate_slots(*args))}
    (gid, _, mat, _, _, _, _), _ = prebuilt_columns(args[0], args[1], args[2],
                                               args[4])
    rowmajor = torch.stack(mat, dim=1)
    del mat
    gid64 = gid.long()
    out["library_ms"] = _cuda_ms(lambda: torch.zeros(
        args[3], rowmajor.shape[1], device="cuda").index_add_(
            0, gid64, rowmajor))
    del rowmajor
    out.update({"bound_ms": shp["bound_ms"], "bound_by": "bytes",
                "content_bound_ms": shp["content_bound_ms"],
                "prebuilt_bound_ms": shp["prebuilt_bound_ms"],
                "layout": shp["layout"], "shape": shp})
    return out


def _slot_call(args, kw) -> tuple:
    full = dict(zip(("gid", "sel", "slots", "num_groups", "want_rep",
                     "point"), args), **kw)
    return (full["gid"], full["sel"], tuple(full["slots"]),
            full["num_groups"], bool(full.get("want_rep", False)),
            full.get("point"))


def slot_args(captured, key) -> tuple:
    """The large-G kernel's slot-interface arguments as a query passed
    them: (gid, sel, slots, G, want_rep, point), the point being the
    launch point the engine launched with, so a check or a timing
    launches the same instantiation."""
    return _slot_call(*captured[key])


def check_rows(label, got, want, rel=1e-9) -> float:
    """Rows against an oracle's, in order: floats within `rel`, every
    other value exactly. Returns the largest relative float error."""
    if len(got) != len(want) or not want:
        raise AssertionError(f"{label}: {len(got)} rows, oracle "
                             f"{len(want)}")
    worst = 0.0
    for g_row, w_row in zip(got, want):
        if len(g_row) != len(w_row):
            raise AssertionError(f"{label}: {g_row} != oracle {w_row}")
        for g, w in zip(g_row, w_row):
            if isinstance(w, float):
                err = abs(g - w) / max(abs(w), 1e-300)
                worst = max(worst, err)
                if err > rel:
                    raise AssertionError(f"{label}: {g_row} != oracle "
                                         f"{w_row} (rel {err})")
            elif g != w:
                raise AssertionError(f"{label}: {g_row} != oracle {w_row}")
    return worst


def ref_qps(li, ps) -> list[tuple]:
    """QPS over numpy arrays: every partsupp row of a lineitem row's part
    key matches it."""
    import numpy as np

    from cockroach_tpu_torch.models import tpch
    d0, d1 = tpch._days("1995-01-01"), tpch._days("1995-02-01")
    m = (li["l_shipdate"] >= d0) & (li["l_shipdate"] < d1)
    per_key = np.bincount(ps["ps_partkey"])
    cost_of_key = np.bincount(ps["ps_partkey"], weights=ps["ps_supplycost"])
    pk = li["l_partkey"][m]
    return [(int(per_key[pk].sum()),
             float((li["l_quantity"][m] * cost_of_key[pk]).sum()))]


def ref_qh(li, orders) -> list[tuple]:
    """QH over numpy arrays (l_shipmode as strings)."""
    import numpy as np

    from cockroach_tpu_torch.models import tpch
    d0, d1 = tpch._days("1993-10-01"), tpch._days("1994-01-01")
    od = orders["o_orderdate"]
    osel = (od >= d0) & (od < d1)
    o_cust = np.full(int(orders["o_orderkey"].max()) + 1, -1, np.int64)
    o_cust[orders["o_orderkey"][osel]] = orders["o_custkey"][osel]
    rows_r = np.nonzero(li["l_returnflag"] == "R")[0]
    ck = o_cust[li["l_orderkey"][rows_r]]
    hit = rows_r[ck >= 0]
    code = {m: i for i, m in enumerate(tpch.SHIPMODES)}
    nm = len(tpch.SHIPMODES)
    key = ck[ck >= 0] * nm + np.fromiter(
        (code[m] for m in li["l_shipmode"][hit]), np.int64, len(hit))
    uniq, inv = np.unique(key, return_inverse=True)
    rev = np.bincount(inv, weights=li["l_extendedprice"][hit]
                      * (1 - li["l_discount"][hit]))
    rows = [(int(k // nm), tpch.SHIPMODES[k % nm], int(c), float(r))
            for k, c, r in zip(uniq, np.bincount(inv), rev)]
    rows.sort(key=lambda t: (-t[3], t[0], t[1]))
    return rows[:20]


def check_lanes_on_card() -> dict:
    """Packed sort-key lanes and their permutation built on the card
    equal those built on the CPU, bit for bit: int64 extremes, float64
    with -0.0, NaN and +-inf, dictionary ranks, bools, with NULLs, dead
    rows, ASC/DESC and NULLS FIRST/LAST (three lanes, fields straddling
    lane boundaries)."""
    import numpy as np
    import torch

    from cockroach_tpu_torch.ops import sortkey
    rng = np.random.default_rng(21)
    n = 1 << 20
    i64 = rng.integers(-(1 << 63), (1 << 63) - 1, size=n, dtype=np.int64)
    i64[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0]
    f64 = rng.normal(size=n)
    f64[:6] = [-0.0, 0.0, np.nan, -np.inf, np.inf, 5e-324]
    codes = rng.integers(0, 40, size=n).astype(np.int32)
    lut = rng.permutation(40).astype(np.int32)
    flags = rng.random(n) < 0.5
    cols = [(i64, False, True, None), (f64, True, False, None),
            (codes, True, True, lut), (flags, False, False, None),
            (i64[::-1].copy(), True, False, None)]
    valid = [rng.random(n) < 0.9 for _ in cols]
    sel = rng.random(n) < 0.8
    out = {}
    for dev in ("cpu", "cuda"):
        specs = [(torch.tensor(d, device=dev), torch.tensor(v, device=dev),
                  desc, nf, lu, None)
                 for (d, desc, nf, lu), v in zip(cols, valid)]
        lanes = sortkey.mask_dead(
            sortkey.pack_lanes(sortkey.encode_keys(specs), n, dev),
            torch.tensor(sel, device=dev))
        out[dev] = ([lane.cpu() for lane in lanes],
                    sortkey.sort_perm(lanes).cpu())
    if len(out["cpu"][0]) != len(out["cuda"][0]) or not all(
            torch.equal(a, b) for a, b in zip(out["cpu"][0],
                                              out["cuda"][0])):
        raise AssertionError("packed lanes on the card != on the CPU")
    if not torch.equal(out["cpu"][1], out["cuda"][1]):
        raise AssertionError("sort_perm on the card != on the CPU")
    return {"rows": n, "lanes": len(out["cuda"][0])}


# large-G kernel launches per suite query at SF1; Q3 groups by
# l_orderkey densely over 1,499,977 codes, past the kernel's 2^19, so it
# takes the plain scatters
SF1_KERNEL_LAUNCHES = {"q3": 0, "q5": 1, "q10": 1, "q12": 1, "qps": 0,
                       "qh": 0}


def suite_phase(eng, li, sf, captured, recorder,
                kernel_launches=SF1_KERNEL_LAUNCHES) -> tuple:
    """Phase 6 on a loaded engine (lineitem from `li`, part): loads the
    other tables at `sf`, runs the suite with its counts and route
    checks against the oracles (`kernel_launches`: the large-G kernel's
    launches each query must make), Q3, Q10 and QH under
    sort_normalized = off, and the medians. Returns (routes, medians);
    the large-G kernel's inputs at Q5, Q10 and Q12 land in `captured`.
    On a CPU engine (a rehearsal) the kernel wrappers' plain-version
    calls stand in for their launches."""
    import numpy as np
    import torch

    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops import sortkey
    from cockroach_tpu_torch.ops.cuda import groupagg as tg
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl

    on_card = eng.device.type == "cuda"
    rows = {}
    kernel = tgl.aggregate_slots
    t0 = time.perf_counter()
    tpch.load(eng, sf=sf, tables=("orders", "customer", "supplier",
                                  "partsupp", "nation", "region"))
    load_s = time.perf_counter() - t0
    li["l_shipmode"] = np.asarray(tpch.SHIPMODES, dtype=object)[
        li["l_shipmode"]]
    orders, cust = tpch.gen_orders(sf), tpch.gen_customer(sf)
    supp, ps = tpch.gen_supplier(sf), tpch.gen_partsupp(sf)
    want = {"q3": tpch.ref_q3(li, orders, cust),
            "q5": tpch.ref_q5(li, orders, cust, supp),
            "q10": tpch.ref_q10(li, orders, cust, tpch.gen_nation()),
            "q12": tpch.ref_q12(li, orders), "qps": ref_qps(li, ps),
            "qh": ref_qh(li, orders)}
    print(f"load SF{sf} orders, customer, supplier, partsupp, nation, "
          f"region: {load_s:.1f} s (host generate + ingest + ANALYZE; "
          f"{time.perf_counter() - t0 - load_s:.1f} s more for the "
          "oracles)", flush=True)
    suite = {"q3": tpch.Q3, "q5": tpch.Q5, "q10": tpch.Q10,
             "q12": tpch.Q12, "qps": QPS, "qh": QH}
    routes = {}
    tgl.aggregate_slots = recorder("suite", kernel)
    try:
        for q, sql in suite.items():
            captured.pop("suite", None)
            tgl.LAUNCHES = tg.LAUNCHES = 0
            tgl.PLAIN_CALLS = tg.PLAIN_CALLS = 0
            for tally in (sortkey.NORMALIZED, sortkey.LANES,
                          sortkey.FALLBACKS):
                tally.reset()
            t1 = time.perf_counter()
            rows[q] = eng.execute(sql).rows
            _sync()
            routes[q] = {
                "first_run_s": time.perf_counter() - t1,
                "groupagg_large": (tgl.LAUNCHES if on_card
                                   else tgl.PLAIN_CALLS),
                "groupagg": tg.LAUNCHES if on_card else tg.PLAIN_CALLS,
                "normalized_sorts": {k: sortkey.NORMALIZED.value(k)
                                     for k in ("sort", "topk", "join")},
                "lanes": sortkey.LANES.value(),
                "sort_fallbacks": sortkey.FALLBACKS.value(),
                **eng.last_exec,
            }
            if "suite" in captured:
                captured[q] = captured.pop("suite")
            print(f"{q} route: " + json.dumps(routes[q]), flush=True)
    finally:
        tgl.aggregate_slots = kernel
    for q, n_kernel in kernel_launches.items():
        if routes[q]["groupagg_large"] != n_kernel:
            raise AssertionError(f"{q} launched the large-G kernel "
                                 f"{routes[q]['groupagg_large']} times, "
                                 f"not {n_kernel}")
    if routes["qh"]["group_ids"] != 1 or sum(
            r["group_ids"] for q, r in routes.items() if q != "qh"):
        raise AssertionError("QH, and only QH, groups through group_ids")
    for q in ("q3", "q10", "qh"):
        if routes[q]["topk_cuts"] != 1 or "no_topk" in routes[q]["replans"]:
            raise AssertionError(f"{q} did not cut with the top-k alone")
    for q, r in routes.items():
        if r["sort_fallbacks"] or not sum(r["normalized_sorts"].values()):
            raise AssertionError(f"{q} sorted off the packed lanes: {r}")
    if routes["qps"]["expansions"] != [4]:
        raise AssertionError(f"QPS did not expand its join 4 ways: "
                             f"{routes['qps']['expansions']}")
    errs_suite = {q: check_rows(q.upper(), rows[q], want[q])
                  for q in suite}
    s_off = eng.session()
    eng.execute("SET sort_normalized = off", s_off)
    for q in ("q3", "q10", "qh"):
        if eng.execute(suite[q], s_off).rows != rows[q]:
            raise AssertionError(f"{q} under sort_normalized = off gave "
                                 "other rows")
    print(f"Q3, Q5, Q10, Q12, QPS, QH ok (max rel err {errs_suite}); Q3, "
          "Q10 and QH equal under sort_normalized = off", flush=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    e2e_suite = {f"{q}_ms": _median_ms(lambda: eng.execute(sql))
                 for q, sql in suite.items()}
    if on_card:
        # the resident tables and what earlier phases hold, and the peak
        e2e_suite["memory_allocated_before"] = before
        e2e_suite["max_memory_allocated"] = \
            torch.cuda.max_memory_allocated()
    print("end-to-end, suite (median of 5 warm runs): "
          + json.dumps(e2e_suite), flush=True)
    return routes, e2e_suite


# the subquery, derived-table and CTE queries of phase 7
SUBQUERY_QUERIES = ("q2", "q4", "q7", "q8", "q9", "q11", "q13", "q15",
                    "q16", "q17", "q18", "q19", "q20", "q21", "q22")
DECIMAL_REL = 1e-9          # exact DECIMAL sums against float64 oracles
FLOAT_REL = 1e-6            # FLOAT8 results (shares, averages)


def _counts_zero() -> None:
    from cockroach_tpu_torch.ops import sortkey
    from cockroach_tpu_torch.ops.cuda import groupagg as tg
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    tgl.LAUNCHES = tg.LAUNCHES = 0
    tgl.PLAIN_CALLS = tg.PLAIN_CALLS = 0
    for tally in (sortkey.NORMALIZED, sortkey.LANES, sortkey.FALLBACKS):
        tally.reset()


def _route(eng, on_card: bool, first_run_s: float) -> dict:
    """One statement's route from the counts and Engine.last_exec: its
    kernel launches (plain-version calls on a CPU engine), and over
    every plan run it made: group_ids calls, partitioned re-runs and
    their partition counts, temps and their rows, subqueries, Compact
    nodes, top-k cuts and replans."""
    from cockroach_tpu_torch.ops import sortkey
    from cockroach_tpu_torch.ops.cuda import groupagg as tg
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    le = eng.last_exec
    tot = le["all"]
    return {
        "first_run_s": first_run_s,
        "groupagg_large": tgl.LAUNCHES if on_card else tgl.PLAIN_CALLS,
        "groupagg": tg.LAUNCHES if on_card else tg.PLAIN_CALLS,
        "plan_runs": tot["runs"], "group_ids": tot["group_ids"],
        "partitioned": tot["partitioned"],
        "temps": [[t.split("_", 5)[-1], n, path]
                  for t, n, path in le["temps"]],
        "subqueries": le["subqueries"],
        "compact_nodes": tot["compact_nodes"],
        "compacts_applied": tot["compacts_applied"],
        "topk_cuts": tot["topk_cuts"], "expansions": tot["expansions"],
        "replans": tot["replans"],
        "sort_fallbacks": sortkey.FALLBACKS.value(),
    }


def _tie_canon(rows: list, col: int, rel: float) -> list:
    """Rows with every run of (within `rel`) equal values in column
    `col` put in one canonical order: an ORDER BY on that column alone
    leaves such rows in any order."""
    out, i = [], 0
    while i < len(rows):
        j = i + 1
        while j < len(rows) and abs(rows[j][col] - rows[i][col]) <= \
                rel * max(abs(rows[i][col]), 1e-300):
            j += 1
        out.extend(sorted(rows[i:j], key=repr))
        i = j
    return out


def check_result(label, res, want) -> float:
    """A Result against its oracle's rows, in order: FLOAT8 columns
    within FLOAT_REL, DECIMAL within DECIMAL_REL, keys, counts, strings
    and dates exactly. Returns the largest relative error."""
    from cockroach_tpu_torch.sql.types import Family
    got = res.rows
    if len(got) != len(want) or not want:
        raise AssertionError(f"{label}: {len(got)} rows, oracle "
                             f"{len(want)}")
    rels = [FLOAT_REL if t.family == Family.FLOAT else DECIMAL_REL
            for t in res.types]
    worst = 0.0
    for g_row, w_row in zip(got, want):
        if len(g_row) != len(w_row):
            raise AssertionError(f"{label}: {g_row} != oracle {w_row}")
        for g, w, rel in zip(g_row, w_row, rels):
            if isinstance(w, float):
                err = abs(g - w) / max(abs(w), 1e-300)
                worst = max(worst, err)
                if err > rel:
                    raise AssertionError(f"{label}: {g_row} != oracle "
                                         f"{w_row} (rel {err})")
            elif g != w:
                raise AssertionError(f"{label}: {g_row} != oracle {w_row}")
    return worst


# large-G kernel launches per phase 7 query at SF1 (the dense
# groupings of at most 2^19 codes whose aggregates have an exact
# envelope; Q2 groups by MIN, Q16 by DISTINCT, Q18 by 1.5M order keys,
# Q19 is ungrouped and Q20 groups by hash), and the partition count of
# Q20's decorrelated GROUP BY (about 530K groups, past half of 2^17
# slots)
SF1_PHASE7_LAUNCHES = {"q2": 0, "q4": 1, "q7": 1, "q8": 1, "q9": 1,
                       "q11": 1, "q13": 2, "q15": 1, "q16": 0, "q17": 1,
                       "q18": 0, "q19": 0, "q20": 0, "q21": 1, "q22": 2}


def phase7_launches(infra: dict) -> dict:
    """SF1_PHASE7_LAUNCHES as the card's parity gate routes them: with
    int_minmax promoted, Q2's min(ps_supplycost) per part key (200,000
    dense groups) takes kernel 1 under `auto`."""
    out = dict(SF1_PHASE7_LAUNCHES)
    if "int_minmax" in infra["exact_paths"]:
        out.update({q: out[q] + 1 for q in MINMAX_QUERIES})
    return out
SF1_Q20_PARTITIONS = [16]
SF1_SSB_LAUNCHES = {"q1.1": 0, "q1.2": 0, "q2.1": 1, "q3.1": 1, "q4.1": 1}


def _check_launches(label, routes, want) -> None:
    for q, n in (want or {}).items():
        if routes[q]["groupagg_large"] != n:
            raise AssertionError(f"{label} {q} launched the large-G kernel "
                                 f"{routes[q]['groupagg_large']} times, "
                                 f"not {n}")


def _oracle_tables(li, sf) -> dict:
    """Every TPC-H table's generator columns at `sf` for the oracles,
    lineitem from `li`."""
    from cockroach_tpu_torch.models import tpch
    return {"lineitem": li, "orders": tpch.gen_orders(sf),
            "customer": tpch.gen_customer(sf),
            "supplier": tpch.gen_supplier(sf), "part": tpch.gen_part(sf),
            "partsupp": tpch.gen_partsupp(sf),
            "nation": tpch.gen_nation(), "region": tpch.gen_region()}


def subquery_phase(eng, li, sf, reps: int = 3,
                   kernel_launches=SF1_PHASE7_LAUNCHES,
                   q20_partitions=SF1_Q20_PARTITIONS,
                   keep: dict | None = None) -> dict:
    """Phase 7 on an engine holding every TPC-H table at `sf` (lineitem
    from `li`, strings decoded): Q2 ... Q22 through Engine.execute, each
    with every count set to 0 just before it and read just after,
    against the numpy oracles and the expected routes
    (`kernel_launches`, Q20's `q20_partitions`; None skips a check),
    then the medians of `reps` warm runs and the peak device memory.
    Returns {query: route}; `keep` gets the generator's tables and the
    oracles' rows (phase 14 reads them)."""
    import numpy as np
    import torch

    from cockroach_tpu_torch.models import tpch
    on_card = eng.device.type == "cuda"
    for col, vals in (("l_shipinstruct", tpch.SHIPINSTRUCT),
                      ("l_shipmode", tpch.SHIPMODES),
                      ("l_returnflag", tpch.RF_VALUES),
                      ("l_linestatus", tpch.LS_VALUES)):
        if li[col].dtype.kind in "iu":   # dictionary codes
            li[col] = np.asarray(vals, dtype=object)[li[col]]
    t0 = time.perf_counter()
    tables = _oracle_tables(li, sf)
    want = {q: tpch.oracle_rows(q, tables) for q in SUBQUERY_QUERIES}
    if keep is not None:
        keep.update(tables=tables, want=dict(want))
    print(f"phase 7 oracles: {time.perf_counter() - t0:.1f} s", flush=True)
    s = eng.session()
    routes, errs = {}, {}
    for q in SUBQUERY_QUERIES:
        _counts_zero()
        t1 = time.perf_counter()
        with recording_slots() as calls:
            res = eng.execute(tpch.QUERIES[q], s)
            _sync()
        routes[q] = _route(eng, on_card, time.perf_counter() - t1)
        print(f"{q} route: " + json.dumps(routes[q]), flush=True)
        if on_card:
            routes[q]["kernel_checks"] = check_calls(
                f"{q.upper()} SF{sf}", calls, routes[q]["groupagg_large"])
        rows_path = [t for t in routes[q]["temps"] if t[2] != "columnar"]
        if rows_path:
            raise AssertionError(f"{q}: temps took the decoded-row path: "
                                 f"{rows_path}")
        rows = res.rows
        if q == "q11":
            # ORDER BY value alone: equal values come in any order
            res.rows = _tie_canon(rows, 1, DECIMAL_REL)
            want[q] = _tie_canon(want[q], 1, DECIMAL_REL)
        errs[q] = check_result(q.upper(), res, want[q])
        if routes[q]["sort_fallbacks"]:
            raise AssertionError(f"{q} sorted off the packed lanes")
    _check_launches("phase 7", routes, kernel_launches)
    if q20_partitions is not None and \
            routes["q20"]["partitioned"] != q20_partitions:
        raise AssertionError(f"Q20 partitioned {routes['q20']['partitioned']}"
                             f", not {q20_partitions}")
    if any(r["groupagg"] for r in routes.values()):
        raise AssertionError("a phase 7 query launched the small-G kernel "
                             "under auto")
    print(f"Q2 ... Q22 ok at SF{sf} (max rel err {errs})", flush=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    med = {f"{q}_ms": _median_ms(lambda q=q: eng.execute(tpch.QUERIES[q], s),
                                 reps=reps)
           for q in SUBQUERY_QUERIES}
    if on_card:
        med["memory_allocated_before"] = before
        med["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    leaked = [t for t in eng.store.tables if t.startswith("__cte_")] + \
        [k for k in eng._device_tables if k[0].startswith("__cte_")]
    if leaked:
        raise AssertionError(f"temps left behind: {leaked}")
    print(f"end-to-end, phase 7 (median of {reps} warm runs): "
          + json.dumps(med), flush=True)
    return routes


def ssb_phase(device, sf, reps: int = 3,
              kernel_launches=SF1_SSB_LAUNCHES) -> dict:
    """Phase 8: SSB in an Engine of its own (its supplier and customer
    clash with TPC-H's): lineorder at LINEORDER_PER_SF * sf rows, the
    dimensions at the generator's sizes, the five flights against the
    numpy oracles, the large-G kernel's launches against
    `kernel_launches`, with routes and medians. Returns {flight:
    route}."""
    import torch

    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import ssb
    t0 = time.perf_counter()
    eng = Engine(device=device)
    data = ssb.load(eng, sf=sf)
    lo, dims = data["lineorder"], data["dims"]
    want = {}
    for q in ssb.QUERIES:
        w = getattr(ssb, "ref_" + q.replace(".", "_"))(lo, dims)
        want[q] = [(w,)] if isinstance(w, int) else w
    print(f"load SSB SF{sf}: {eng.store.table('lineorder').row_count} "
          f"lineorder rows, {time.perf_counter() - t0:.1f} s (generate + "
          "ingest + oracles)", flush=True)
    on_card = eng.device.type == "cuda"
    s = eng.session()
    routes = {}
    for q, sql in ssb.QUERIES.items():
        _counts_zero()
        t1 = time.perf_counter()
        with recording_slots() as calls:
            res = eng.execute(sql, s)
            _sync()
        routes[q] = _route(eng, on_card, time.perf_counter() - t1)
        print(f"ssb {q} route: " + json.dumps(routes[q]), flush=True)
        if on_card:
            routes[q]["kernel_checks"] = check_calls(
                f"SSB {q} SF{sf}", calls, routes[q]["groupagg_large"])
        check_result(f"SSB {q}", res, want[q])
    _check_launches("SSB", routes, kernel_launches)
    print(f"SSB q1.1 ... q4.1 ok at SF{sf}", flush=True)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    med = {f"{q}_ms": _median_ms(lambda sql=sql: eng.execute(sql, s),
                                 reps=reps)
           for q, sql in ssb.QUERIES.items()}
    if on_card:
        med["memory_allocated_before"] = before
        med["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print(f"end-to-end, SSB (median of {reps} warm runs): "
          + json.dumps(med), flush=True)
    return routes


def _device_busy_ms(fn, runs: int) -> float:
    """Kernel time per call of `fn` from torch.profiler (one stream, so
    kernels do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        _sync()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type.name == "CUDA") / 1e3 / runs


def prepared_phase(eng, runs: int = 5) -> dict:
    """Phase 9: Q1, Q6, Q3 and Q15 through Engine.prepare and `runs`
    runs of the handle, each equal to execute's rows; a second prepare
    of the same text hits the exec cache (Q15, a CTE statement, gets a
    re-execute handle whose runs hit it). On the card, the host ms per
    run both ways: the median wall time minus the device busy time
    (torch.profiler's kernel time per run), beside the CUDA-event span
    of a run."""
    from cockroach_tpu_torch.exec.session import Prepared
    from cockroach_tpu_torch.models import tpch
    on_card = eng.device.type == "cuda"
    out = {}
    for q in ("q1", "q6", "q3", "q15"):
        sql = tpch.QUERIES[q]
        s = eng.session()
        want = eng.execute(sql, s).rows
        p = eng.prepare(sql, s)
        for i in range(runs):
            if p.run().rows != want:
                raise AssertionError(f"{q}: prepared run {i} != execute")
        cache0 = dict(eng.plan_cache)
        p2 = eng.prepare(sql, s)
        if isinstance(p, Prepared):
            hits = eng.plan_cache["hit"] - cache0["hit"]
            if hits != 1 or eng.plan_cache["miss"] != cache0["miss"]:
                raise AssertionError(f"{q}: second prepare missed the "
                                     f"exec cache: {eng.plan_cache}")
        else:
            p2.run()
            hits = eng.plan_cache["hit"] - cache0["hit"]
            if hits < 2 or eng.plan_cache["miss"] != cache0["miss"]:
                raise AssertionError(f"{q}: re-run missed the exec cache: "
                                     f"{eng.plan_cache}")
        rec = {"handle": type(p).__name__, "cache_hits": hits,
               "plan_cache": dict(eng.plan_cache),
               "execute_ms": _median_ms(lambda: eng.execute(sql, s),
                                        reps=runs),
               "prepared_ms": _median_ms(p.run, reps=runs)}
        if on_card:
            for way, fn in (("execute", lambda: eng.execute(sql, s)),
                            ("prepared", p.run)):
                busy = _device_busy_ms(fn, runs)
                rec[f"{way}_device_ms"] = busy
                rec[f"{way}_host_ms"] = rec[f"{way}_ms"] - busy
                # CUDA events around a run span the device's idle gaps
                # too, so they bound the wall time, not the busy time
                rec[f"{way}_event_ms"] = _cuda_ms(fn, reps=runs, warm=1)
        out[q] = rec
        print(f"{q} prepared: " + json.dumps(rec), flush=True)
    return out


# -- phase 14: what clients and operators send --------------------------------

COMPOSED_QUERIES = ("q4", "q15", "q21", "q13", "q22")
COMPOSED_RUNS = 6               # the capturing run, then 5 composed
PROFILED_CTE = ("q4", "q21")    # slow against composed under the profiler
SPLIT_DATE = "1995-06-17"
Q1_SHAPE = ("SELECT l_returnflag, l_linestatus, sum(l_quantity) AS "
            "sum_qty, sum(l_extendedprice) AS sum_base_price, count(*) AS "
            "count_order FROM lineitem WHERE l_shipdate {op} DATE "
            f"'{SPLIT_DATE}' GROUP BY l_returnflag, l_linestatus")
UNION_ALL_Q1 = (Q1_SHAPE.format(op="<=") + " UNION ALL "
                + Q1_SHAPE.format(op=">") + " ORDER BY 1, 2, 5")
SEGMENT = "BUILDING"
EXCEPT_Q = (f"SELECT c_custkey FROM customer WHERE c_mktsegment = "
            f"'{SEGMENT}' EXCEPT SELECT DISTINCT o_custkey FROM orders "
            "ORDER BY 1")
INTERSECT_Q = EXCEPT_Q.replace("EXCEPT", "INTERSECT")
UNION_STR_Q = "SELECT n_name FROM nation UNION SELECT r_name FROM region " \
    "ORDER BY 1"
# the customer a write adds between two runs of composed Q22: a
# country code Q22 counts, a balance above its average, no orders
NEW_CUSTOMER = {"c_custkey": 999_999_999, "c_name": "Customer#999999999",
                "c_nationkey": 3, "c_phone": "13-555-555-5555",
                "c_acctbal": 9999.99, "c_mktsegment": SEGMENT}
PLANE_AB_RUNS = 5               # warm runs a way, profile plane on/off


def _profiled(fn, on_card: bool = True) -> dict:
    """Wall, device-busy and HtoD ms of one run of `fn` from
    torch.profiler, as profile_tpch measures them (off the card: the
    wall ms alone)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not on_card:
        t0 = time.perf_counter()
        fn()
        return {"wall_ms": (time.perf_counter() - t0) * 1e3, "busy_ms": None,
                "htod_ms": None, "idle_share": None}
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    htod = sum(e.time_range.elapsed_us() for e in dev
               if "HtoD" in e.name) / 1e3
    return {"wall_ms": wall, "busy_ms": busy, "htod_ms": htod,
            "idle_share": max(0.0, 1.0 - busy / wall)}


def _analyze_ops(rows) -> tuple:
    """(per plan line: (operator, device ms, actual rows), total ms, rows
    returned) of an EXPLAIN ANALYZE."""
    import re
    lines = [r[0] for r in rows]
    ops = []
    for ln in lines[lines.index("plan:") + 1:]:
        dev = re.search(r"device=([0-9.]+)ms", ln)
        act = re.search(r"actual rows=([0-9]+)", ln)
        ops.append((ln.strip().split(" ")[0], float(dev.group(1)),
                    int(act.group(1))))
    tot = next(ln for ln in lines if ln.strip().startswith("total:"))
    m = re.search(r"total: ([0-9.]+)ms, rows returned: ([0-9]+)", tot)
    return ops, float(m.group(1)), int(m.group(2))


def observability_phase(eng, kept: dict,
                        kernel_launches=SF1_PHASE7_LAUNCHES) -> dict:
    """Phase 14 on the SF1 engine after phase 9, before phase 11's
    writes (`kept`: phase 7's tables and oracles). Composed CTEs, set
    operations, EXPLAIN ANALYZE, tracing and the profile plane's cost.
    Every statement run is driven with every count set to 0 just before
    it and read just after, and on the card each kernel launch is held
    against its plain version at its inputs. Returns the phase's
    numbers: launches by kernel ("launches", counted; "timed_launches",
    the A/B loops', not held one by one), kernel 1's and kernel 2's
    path checks, and everything the observability line prints."""
    import numpy as np

    from cockroach_tpu_torch.bench_groupagg import kernel_ms as small_ms
    from cockroach_tpu_torch.bench_groupagg_large import kernel_ms
    from cockroach_tpu_torch.exec.engine import TEMP_PREFIX
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    from cockroach_tpu_torch.utils import tracing
    from cockroach_tpu_torch.utils.sqlstats import fingerprint
    on_card = eng.device.type == "cuda"
    t_phase = time.perf_counter()
    tables, want = kept["tables"], kept["want"]
    out = {"launches": {"groupagg_large": 0, "groupagg": 0},
           "checks": {}, "small_checks": {}}
    temp_uploads = []
    upload = eng._batch_from_chunks   # the bound method

    def counting_upload(td, chunks, cols):
        if td.schema.name.startswith(TEMP_PREFIX):
            temp_uploads.append(td.schema.name)
        return upload(td, chunks, cols)

    def driven(label, fn):
        """fn() with the counts at 0 before and read after; each launch
        of kernel 1 and 2 held against its plain version. Returns (fn's
        value, (kernel 1 launches, kernel 2 launches), kernel 1's
        recorded calls, kernel 2's)."""
        _counts_zero()
        with recording_slots() as calls, recording_small() as scalls:
            val = fn()
            _sync()
        k1, k2 = _kernel_counts(on_card)
        out["launches"]["groupagg_large"] += k1
        out["launches"]["groupagg"] += k2
        kept1, kept2 = list(calls), list(scalls)
        if on_card:
            if k1 or calls:
                out["checks"][label] = check_calls(label, calls, k1)
            if k2 or scalls:
                out["small_checks"][label] = _check_small_calls(
                    label, scalls, k2)
        return val, (k1, k2), kept1, kept2

    eng._batch_from_chunks = counting_upload
    try:
        # -- 14.1 composed CTEs ----------------------------------------
        composed = {}
        for q in COMPOSED_QUERIES:
            sql = tpch.QUERIES[q]
            s = eng.session()
            p = eng.prepare(sql, s)
            runs = []
            for i in range(COMPOSED_RUNS):
                temp_uploads.clear()
                t0 = time.perf_counter()
                res, (k1, _), _, _ = driven(f"{q} composed run {i + 1}",
                                            p.run)
                ms = (time.perf_counter() - t0) * 1e3
                check_result(f"{q.upper()} run {i + 1}", res, want[q])
                le = eng.last_exec
                if i == 0 and (le["composed"] or not le["temps"]):
                    raise AssertionError(f"{q}: the first run composed")
                if i > 0 and (not le["composed"] or le["temps"]
                              or temp_uploads):
                    raise AssertionError(
                        f"{q} run {i + 1}: not composed (temps "
                        f"{le['temps']}, temp uploads {temp_uploads})")
                if kernel_launches is not None and \
                        k1 != kernel_launches[q]:
                    raise AssertionError(f"{q} run {i + 1} launched kernel "
                                         f"1 {k1} times, not "
                                         f"{kernel_launches[q]}")
                runs.append({"ms": ms, "composed": le["composed"],
                             "groupagg_large": k1})
            if (p.composed_runs, p.declined) != (COMPOSED_RUNS - 1, 0):
                raise AssertionError(f"{q}: {p.composed_runs} composed "
                                     f"runs, {p.declined} declined")
            composed[q] = {"runs": runs, "slow_ms": runs[0]["ms"],
                           "composed_median_ms": statistics.median(
                               r["ms"] for r in runs[1:])}
            if q in PROFILED_CTE and on_card:
                # one slow run (execute takes the temps through the
                # host) and one composed run, under the profiler
                composed[q]["slow"] = driven(
                    f"{q} profiled slow",
                    lambda: _profiled(lambda: eng.execute(sql, s)))[0]
                composed[q]["composed"] = driven(
                    f"{q} profiled composed",
                    lambda: _profiled(p.run))[0]
                if not eng.last_exec["composed"]:
                    raise AssertionError(f"{q}: profiled run not composed")
            print(f"{q} composed: " + json.dumps(composed[q]), flush=True)
            if q == "q22":
                composed[q]["write"] = _composed_write_check(
                    eng, p, s, tables, want, driven)
        out["composed"] = composed
    finally:
        del eng._batch_from_chunks

    # -- 14.2 set operations ------------------------------------------------
    li, orders, cust = tables["lineitem"], tables["orders"], \
        tables["customer"]
    split = tpch._days(SPLIT_DATE)
    want_union = []
    for mask in (li["l_shipdate"] <= split, li["l_shipdate"] > split):
        for rf, ls in sorted(set(zip(li["l_returnflag"][mask],
                                     li["l_linestatus"][mask]))):
            m = mask & (li["l_returnflag"] == rf) & \
                (li["l_linestatus"] == ls)
            want_union.append((rf, ls, float(li["l_quantity"][m].sum()),
                               float(li["l_extendedprice"][m].sum()),
                               int(m.sum())))
    want_union.sort(key=lambda r: (r[0], r[1], r[4]))
    seg = cust["c_custkey"][np.asarray(cust["c_mktsegment"]) == SEGMENT]
    want_except = [(int(k),) for k in np.setdiff1d(seg, orders["o_custkey"])]
    want_inter = [(int(k),) for k in np.intersect1d(seg,
                                                    orders["o_custkey"])]
    want_str = [(v,) for v in sorted(set(tpch.NATIONS) | set(tpch.REGIONS))]
    s = eng.session()
    setops = {}
    for label, sql, w in (("union_all_q1", UNION_ALL_Q1, want_union),
                          ("except", EXCEPT_Q, want_except),
                          ("intersect", INTERSECT_Q, want_inter),
                          ("union_strings", UNION_STR_Q, want_str)):
        t0 = time.perf_counter()
        res, (k1, k2), _, _ = driven(label, lambda: eng.execute(sql, s))
        setops[label] = {"ms": (time.perf_counter() - t0) * 1e3,
                         "rows": len(res.rows), "groupagg_large": k1}
        check_result(label, res, w)
    if setops["union_all_q1"]["groupagg_large"] != 2:
        raise AssertionError("the UNION ALL of two Q1-shaped aggregates did "
                             "not launch kernel 1 once a branch")
    p = eng.prepare(UNION_ALL_Q1, s)
    for i in range(2):
        res, (k1, _), _, _ = driven(f"union_all_q1 prepared {i + 1}", p.run)
        check_result(f"prepared UNION ALL run {i + 1}", res, want_union)
        if k1 != 2:
            raise AssertionError("a prepared UNION ALL run did not launch "
                                 "kernel 1 once a branch")
    out["setops"] = setops
    print("set operations: " + json.dumps(setops), flush=True)

    # -- 14.3 EXPLAIN ANALYZE ----------------------------------------------
    analyze = {}
    s_on = eng.session()
    eng.execute("SET pallas_groupagg = on", s_on)
    for label, sql, sess, kern in (("q1", tpch.Q1, s, 0),
                                   ("q1f", tpch.Q1F, s_on, 1)):
        res, ks, c1, c2 = driven(f"explain analyze {label}",
                                 lambda: eng.execute("EXPLAIN ANALYZE "
                                                     + sql, sess))
        if ks != ((1, 0) if kern == 0 else (0, 1)):
            raise AssertionError(f"EXPLAIN ANALYZE {label} launched "
                                 f"{ks}, not its kernel once")
        ops, total, nrows = _analyze_ops(res.rows)
        agg = [o for o in ops if o[0] == "Aggregate"]
        if nrows != 4 or ops[0][2] != nrows:
            raise AssertionError(f"EXPLAIN ANALYZE {label}: actual rows "
                                 f"{ops[0][2]}, returned {nrows}")
        if not agg or agg[0][1] <= 0:
            raise AssertionError(f"EXPLAIN ANALYZE {label}: no device ms "
                                 f"for the aggregate: {ops}")
        if sum(o[1] for o in ops) > total:
            raise AssertionError(f"EXPLAIN ANALYZE {label}: operators' "
                                 f"{sum(o[1] for o in ops)} ms pass the "
                                 f"total {total}")
        analyze[label] = {"operators": ops, "total_ms": total}
        if on_card:
            analyze[label]["kernel_event_ms"] = (
                kernel_ms(tgl.plan_slots(*c1[0])) if kern == 0
                else small_ms(c2[0]))
        print(f"EXPLAIN ANALYZE {label}: " + json.dumps(analyze[label]),
              flush=True)
    res, _, _, _ = driven("explain analyze debug q6", lambda: eng.execute(
        "EXPLAIN ANALYZE (DEBUG) " + tpch.Q6, s))
    bundle = json.loads(res.rows[0][0])
    again = eng.stmtdiag.get(bundle["id"])
    stored = json.loads(json.dumps(again, default=str)) if again else {}
    if any(stored.get(k) != v for k, v in bundle.items()):
        raise AssertionError("the debug bundle's id does not fetch it")
    analyze["q6_debug_bundle"] = {"id": bundle["id"],
                                  "ops": len(bundle["profile"]["ops"]),
                                  "device_time_s":
                                      bundle["profile"]["device_time_s"]}
    out["explain_analyze"] = analyze

    # -- 14.4 tracing and the planes' cost ----------------------------------
    st = eng.session()
    eng.execute("SET tracing = on", st)
    driven("traced q1", lambda: eng.execute(tpch.Q1, st))
    eng.execute("SET tracing = off", st)
    text = "\n".join(r[0] for r in eng.execute("SHOW TRACE FOR SESSION",
                                               st).rows)
    for name in ("plan:", "dispatch:", "materialize:"):
        if name not in text:
            raise AssertionError(f"SHOW TRACE FOR SESSION has no {name}")
    ring0 = len(eng.slow_traces)
    eng.settings.set("sql.trace.slow_statement.threshold", 0.001)
    try:
        driven("slow q6", lambda: eng.execute(tpch.Q6, s))
    finally:
        eng.settings.set("sql.trace.slow_statement.threshold", 0.0)
    slow = list(eng.slow_traces)[ring0:]
    if not any(t["fingerprint"] == fingerprint(tpch.Q6) for t in slow):
        raise AssertionError("Q6 did not enter the slow-statement ring")
    if tracing.span_from_wire(slow[-1]["span"]).find("dispatch") is None:
        raise AssertionError("the ring's span has no dispatch")
    ab = {"q1_ms": {}, "q6_ms": {}}
    k0 = _kernel_counts(on_card)
    for i, enabled in enumerate((True, False, True)):
        eng.settings.set("sql.stmt_profile.enabled", enabled)
        for q, sql in (("q1", tpch.Q1), ("q6", tpch.Q6)):
            ab[f"{q}_ms"][f"{'on' if enabled else 'off'}_{i}"] = \
                _median_ms(lambda: eng.execute(sql, s), reps=PLANE_AB_RUNS)
    eng.settings.set("sql.stmt_profile.enabled", True)
    k1 = _kernel_counts(on_card)
    out["timed_launches"] = {"groupagg_large": k1[0] - k0[0],
                             "groupagg": k1[1] - k0[1]}
    out["tracing"] = {"show_trace_lines": text.count("\n") + 1,
                      "slow_ring": len(slow), "profile_plane_ab": ab}
    print("tracing and the profile plane's cost: "
          + json.dumps(out["tracing"]), flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def observability_phase_alone(sf: float = SF, device=None,
                              rows: int | None = None) -> dict:
    """Phase 14 by itself (``python3 -c "import chip_smoke;
    chip_smoke.observability_phase_alone()"``): loads every TPC-H table
    at `sf` as phases 2 and 6 do (``device`` names another than the
    card for a rehearsal, ``rows`` caps lineitem), computes phase 7's
    oracles for the composed queries, runs the phase and prints its
    line. Phase 7's kernel-1 counts hold at SF1 only."""
    import numpy as np

    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    if device is None:
        print(f"card: {_smi()}", flush=True)
    t0 = time.perf_counter()
    eng = Engine(device=device)
    tpch.load(eng, sf=sf, rows=rows, tables=("lineitem", "part"),
              encoded=True)
    tpch.load(eng, sf=sf, tables=("orders", "customer", "supplier",
                                  "partsupp", "nation", "region"))
    li = tpch.gen_lineitem(sf, rows=rows, encoded=True)
    for col, vals in (("l_returnflag", tpch.RF_VALUES),
                      ("l_linestatus", tpch.LS_VALUES),
                      ("l_shipmode", tpch.SHIPMODES),
                      ("l_shipinstruct", tpch.SHIPINSTRUCT)):
        li[col] = np.asarray(vals, dtype=object)[li[col]]
    tables = _oracle_tables(li, sf)
    kept = {"tables": tables,
            "want": {q: tpch.oracle_rows(q, tables)
                     for q in COMPOSED_QUERIES}}
    print(f"load SF{sf}: {time.perf_counter() - t0:.1f} s", flush=True)
    out = observability_phase(
        eng, kept, kernel_launches=SF1_PHASE7_LAUNCHES if sf == 1
        and rows is None else None)
    for k in ("checks", "small_checks"):
        out[k] = {label: len(v) for label, v in out[k].items()}
    print(json.dumps({"observability": out}, default=str), flush=True)
    return out


def _composed_write_check(eng, p, s, tables, want, driven) -> dict:
    """A customer added between two runs of composed Q22 sends the next
    run to the slow path, whose rows equal the oracle over the changed
    table; the run after it composes again. Deleting the customer does
    the same and restores phase 7's rows."""
    import numpy as np

    from cockroach_tpu_torch.models import tpch
    c = NEW_CUSTOMER
    cust = {k: np.append(v, c[k]) for k, v in tables["customer"].items()}
    changed = tpch.oracle_rows("q22", dict(tables, customer=cust))
    if changed == want["q22"]:
        raise AssertionError("the added customer does not change Q22")
    cols = ", ".join(c)
    vals = ", ".join(repr(v) for v in c.values())
    out = {}
    for step, stmt, w in (
            ("insert", f"INSERT INTO customer ({cols}) VALUES ({vals})",
             changed),
            ("delete", "DELETE FROM customer WHERE c_custkey = "
                       f"{c['c_custkey']}", want["q22"])):
        eng.execute(stmt, s)
        declined = p.declined
        for i, must_compose in enumerate((False, True)):
            res, _, _, _ = driven(f"q22 after {step} {i + 1}", p.run)
            check_result(f"Q22 after the {step}, run {i + 1}", res, w)
            if eng.last_exec["composed"] != must_compose:
                raise AssertionError(f"Q22 after the {step}, run {i + 1}: "
                                     f"composed {eng.last_exec['composed']}")
        if p.declined != declined + 1:
            raise AssertionError(f"the {step} did not decline once")
        out[step] = {"declined": p.declined, "composed": p.composed_runs}
    return out


# -- phase 10: beyond memory at SF3 -------------------------------------------

# SF3 (18,003,645 lineitem rows) streams each query past the 1 GiB
# budget. Its tables pad to SF5's device shapes (lineitem to 2^25 rows,
# orders to 2^23), so every placement estimate, verdict and spill
# partition count is SF5's; an SF5 load took 45-53 s of the whole run
# on an H100's host, an SF10 load 93-124 s
BEYOND_SF = 3
STREAM_BUDGET = 1 << 30
RESIDENT_BUDGET = 1 << 36
PAGE_ROWS = 1 << 21             # the default streaming_page_rows
PEAK_LIMIT = 2 << 30            # budget + page window + page temporaries
# a lineitem x orders aggregate on the order key: orders is the build
# side the spill tier partitions
SPILL_JOIN_Q = """
SELECT o_orderpriority, count(*) AS n, sum(l_extendedprice) AS revenue
FROM lineitem, orders
WHERE l_orderkey = o_orderkey
GROUP BY o_orderpriority
ORDER BY o_orderpriority
"""
# a one-week l_shipdate slice of lineitem, sorted
SPILL_SORT_Q = """
SELECT l_orderkey, l_linenumber, l_shipdate, l_extendedprice
FROM lineitem
WHERE l_shipdate >= date '1995-03-01' AND l_shipdate < date '1995-03-08'
ORDER BY l_extendedprice DESC, l_orderkey, l_linenumber
"""


def _meminfo() -> dict:
    """MemTotal and MemAvailable of the host, in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(val.split()[0]) * 1024
    return out


def ref_q1_codes(li) -> list:
    """tpch.ref_q1 over lineitem whose l_returnflag and l_linestatus are
    the generator's dictionary codes (tpch.RF_VALUES, LS_VALUES): the same
    rows, the same sums over the same rows in the same order, with the
    groups found and masked on the int codes instead of on the decoded
    strings."""
    import numpy as np

    from cockroach_tpu_torch.models import tpch
    rf_v, ls_v = np.asarray(tpch.RF_VALUES), np.asarray(tpch.LS_VALUES)
    mask = li["l_shipdate"] <= tpch._days("1998-12-01") - 90
    code = li["l_returnflag"].astype(np.int64) * len(ls_v) \
        + li["l_linestatus"]
    keys = sorted((rf_v[c // len(ls_v)], ls_v[c % len(ls_v)], c)
                  for c in np.unique(code[mask]))
    out = []
    for rf, ls, c in keys:
        m = mask & (code == c)
        q = li["l_quantity"][m]
        ep = li["l_extendedprice"][m]
        dc = li["l_discount"][m]
        tx = li["l_tax"][m]
        disc_price = ep * (1 - dc)
        charge = disc_price * (1 + tx)
        out.append((rf, ls, q.sum(), ep.sum(), disc_price.sum(),
                    charge.sum(), q.mean(), ep.mean(), dc.mean(),
                    int(m.sum())))
    return out


def same_result(label, got, want, rel=1e-9) -> float:
    """Two Results row for row, in order: FLOAT values within `rel`,
    every other value (INT, DECIMAL, STRING, DATE) exactly. Returns the
    largest relative FLOAT error."""
    from cockroach_tpu_torch.sql.types import Family
    if len(got.rows) != len(want.rows) or not want.rows:
        raise AssertionError(f"{label}: {len(got.rows)} rows, want "
                             f"{len(want.rows)}")
    floats = [t.family == Family.FLOAT for t in want.types]
    worst = 0.0
    for g_row, w_row in zip(got.rows, want.rows):
        for g, w, fl in zip(g_row, w_row, floats):
            if fl and g is not None and w is not None:
                err = abs(g - w) / max(abs(w), 1e-300)
                worst = max(worst, err)
                if err > rel:
                    raise AssertionError(f"{label}: {g_row} != {w_row}")
            elif g != w:
                raise AssertionError(f"{label}: {g_row} != {w_row}")
    return worst


def _measured(eng, run) -> tuple:
    """(Result, wall ms, peak bytes allocated, kernel-1 launches) of
    `run()`, with every count set to 0 just before it (plain-version
    calls on a CPU engine)."""
    import torch
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    _counts_zero()
    torch.cuda.synchronize()
    eng.devstats.reset_peak()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    k1 = tgl.LAUNCHES if eng.device.type == "cuda" else tgl.PLAIN_CALLS
    return res, ms, eng.devstats.hbm_watermark(), k1


def _timed(eng, sql, session) -> tuple:
    """_measured of one Engine.execute."""
    return _measured(eng, lambda: eng.execute(sql, session))


class PathRuns:
    """Phase 10's path runs: each is measured (_measured) with every
    kernel-1 call recorded, its launches are added to `launches` under
    the run's kind, and on the card each call is held against the plain
    version at the slots it was given (check_calls, phase 4's
    tolerances), the records under `checks` by label. Warm runs that
    only time a statement go through _timed and are not counted."""

    def __init__(self, eng):
        self.eng = eng
        self.launches: dict = {}
        self.checks: dict = {}

    def run(self, kind: str, label: str, run) -> tuple:
        with recording_slots() as calls:
            res, ms, peak, k1 = _measured(self.eng, run)
        self.launches[kind] = self.launches.get(kind, 0) + k1
        if self.eng.device.type == "cuda":
            got = check_calls(label, calls, k1)
            if got:
                self.checks[label] = got
        return res, ms, peak, k1

    def execute(self, kind: str, label: str, sql, session) -> tuple:
        return self.run(kind, label, lambda: self.eng.execute(sql, session))


def beyond_memory_phase(reps: int = 3) -> dict:
    """Phase 10: TPC-H Q1, Q6 and Q14 streamed at BEYOND_SF under a 1 GiB
    device budget, then resident; a spilled lineitem x orders join and a
    spilled sort; a streamed prepared statement."""
    import numpy as np
    import torch

    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops import join
    from cockroach_tpu_torch.ops.batch import ColumnBatch

    sf = BEYOND_SF
    host = _meminfo()
    eng = Engine()
    free, total = eng.devstats.free_total() or (0, 0)
    print(f"phase 10 host memory: {json.dumps(host)}; card free {free} "
          f"of {total} bytes", flush=True)
    # lineitem is generated once: ingested as tpch.load ingests it
    # (pre-encoded strings), and read by the oracles. No ANALYZE: the
    # planner reads the chunks' seal-time sketches (a minute saved)
    t0 = time.perf_counter()
    li = tpch.gen_lineitem(sf, encoded=True)
    eng.execute(tpch.DDL["lineitem"])
    for cn, vals in tpch.LINEITEM_DICTS.items():
        eng.store.set_dictionary("lineitem", cn, vals)
    eng.store.insert_columns("lineitem", li, eng.clock.now())
    tpch.load(eng, sf=sf, tables=("part", "orders"), analyze=False)
    load_s = time.perf_counter() - t0
    n_rows = eng.store.table("lineitem").row_count
    if n_rows != int(tpch.LINEITEM_PER_SF * sf):
        raise AssertionError(f"SF{sf} lineitem has {n_rows} rows")
    print(f"load SF{sf}: {n_rows} lineitem, "
          f"{eng.store.table('orders').row_count} orders, "
          f"{eng.store.table('part').row_count} part rows in "
          f"{load_s:.1f} s", flush=True)
    t0 = time.perf_counter()
    want = {"q1": ref_q1_codes(li), "q6": tpch.ref_q6(li),
            "q14": tpch.ref_q14(li, tpch.gen_part(sf))}
    print(f"SF{sf} oracles: {time.perf_counter() - t0:.1f} s", flush=True)

    page_rows = PAGE_ROWS
    n_pages = -(-n_rows // page_rows)
    out = {"sf": sf, "lineitem_rows": n_rows, "load_s": load_s,
           "host": host, "card_free": free, "card_total": total,
           "stream_budget": STREAM_BUDGET, "page_rows": page_rows,
           "queries": {}}
    paths = PathRuns(eng)
    streamed = {}
    s = eng.session()
    s_sync = eng.session()
    eng.execute("SET streaming_pipeline = off", s_sync)
    for sess in (s, s_sync):
        eng.execute(f"SET streaming_page_rows = {page_rows}", sess)
    sqls = {"q1": tpch.Q1, "q6": tpch.Q6, "q14": tpch.Q14}
    eng.settings.set("sql.exec.hbm_budget_bytes", STREAM_BUDGET)
    for q, sql in sqls.items():
        verdict = eng.stream_verdict(sql, s)
        if verdict != "stream-scan":
            raise AssertionError(f"{q} at 1 GiB: {verdict}, not streamed")
        res, first_ms, peak, k1 = paths.execute(
            "streamed", f"sf{sf} {q} streamed", sql, s)
        pg = dict(eng.last_exec["paging"])
        if k1:
            raise AssertionError(f"streamed {q} launched kernel 1 {k1} "
                                 "times (its page state takes the plain "
                                 "reductions)")
        if pg["route"] != "stream" or pg["pages"] + pg["skipped"] != n_pages:
            raise AssertionError(f"{q}: {pg}, not {n_pages} pages")
        if peak >= PEAK_LIMIT:
            raise AssertionError(f"streamed {q} peaked at {peak} bytes")
        if q == "q1":
            check_q1(res.rows, want["q1"])
        elif not _close(res.rows[0][0], want[q], 1e-9):
            raise AssertionError(f"{q} {res.rows[0][0]} != oracle {want[q]}")
        entry = {"verdict": verdict, "first_ms": first_ms,
                 "pages": pg["pages"], "skipped": pg["skipped"]}
        # FLOAT8 sums add by atomics, in no fixed order: later runs
        # agree within rel 1e-9, everything else exactly
        for mode, sess in (("pipeline_on", s), ("pipeline_off", s_sync)):
            runs = []
            for _ in range(reps):
                r, ms, pk, k1 = _timed(eng, sql, sess)
                if k1:
                    raise AssertionError(f"streamed {q} {mode} launched "
                                         f"kernel 1 {k1} times")
                same_result(f"{q} {mode}", r, res)
                runs.append((ms, pk, dict(eng.last_exec["paging"])))
            med = statistics.median(m for m, _, _ in runs)
            peak = max(pk for _, pk, _ in runs)
            if peak >= PEAK_LIMIT:
                raise AssertionError(f"streamed {q} {mode} peaked at "
                                     f"{peak} bytes")
            entry[mode] = {
                "ms": med, "rows_per_s": n_rows / (med / 1e3),
                "h2d_gbps": statistics.median(
                    p["bytes"] / (m / 1e3) / 1e9 for m, _, p in runs),
                "h2d_bytes": runs[-1][2]["bytes"],
                "stall_s": statistics.median(p["stall_s"]
                                             for _, _, p in runs),
                "overlap_s": statistics.median(p["overlap_s"]
                                               for _, _, p in runs),
                "peak_bytes": peak}
        streamed[q] = res
        out["queries"][q] = entry
        print(f"{q} streamed: " + json.dumps(entry), flush=True)

    # Q14's direct-join table is rebuilt on every page, as the
    # reference's per-page program does: the rebuild alone, against a
    # 128-row probe
    part_b = eng._device_table("part", frozenset({"p_partkey", "p_type"}))
    lo, hi, _ = eng.store.key_int_range("part", "p_partkey")
    probe = ColumnBatch.from_dict({"l_partkey": torch.arange(
        1, 129, dtype=torch.int64, device=part_b.device)})
    rebuild_ms = _cuda_ms(lambda: join.hash_join(
        probe, part_b, ["l_partkey"], ["p_partkey"], ["p_type"], "inner",
        direct=(lo, hi - lo + 2)))
    out["queries"]["q14"]["join_rebuild_ms_per_page"] = rebuild_ms
    print(f"q14 direct-join table rebuild: {rebuild_ms:.3f} ms a page, "
          f"{rebuild_ms * n_pages:.1f} ms over {n_pages} pages", flush=True)

    # the same queries resident
    eng.settings.set("sql.exec.hbm_budget_bytes", RESIDENT_BUDGET)
    resident = {}
    for q, sql in sqls.items():
        verdict = eng.stream_verdict(sql, s)
        if verdict != "resident":
            raise AssertionError(f"{q} at 64 GiB: {verdict}")
        res, first_ms, peak, k1 = paths.execute(
            "resident", f"sf{sf} {q} resident", sql, s)
        if q == "q1" and k1 != 1:
            raise AssertionError(f"resident Q1 launched kernel 1 {k1} times")
        worst = same_result(f"{q} resident vs streamed", res, streamed[q])
        warm = []
        for _ in range(reps):
            _, ms, _, k1_warm = _timed(eng, sql, s)
            if k1_warm != k1:
                raise AssertionError(f"a warm resident {q} launched kernel "
                                     f"1 {k1_warm} times, not {k1}")
            warm.append(ms)
        resident[q] = res
        entry = {"verdict": verdict, "first_ms": first_ms,
                 "ms": statistics.median(warm),
                 "rows_per_s": n_rows / (statistics.median(warm) / 1e3),
                 "peak_bytes": peak, "kernel1": k1,
                 "estimate_bytes": eng.working_set(sql, s)["resident"],
                 "float_rel_err_vs_streamed": worst}
        out["queries"][q]["resident"] = entry
        print(f"{q} resident: " + json.dumps(entry), flush=True)

    # spill join: the placement rules' own reckoning sizes a budget
    # that leaves, beside the page window, room for 3/8 of the orders
    # build: partitions double until one fits, so 4
    ws = eng.working_set(SPILL_JOIN_Q, s)
    budget = ws["page_window"] + ws["builds"] * 3 // 8
    res_join, join_first_ms, join_peak, _ = paths.execute(
        "spill_join_resident", f"sf{sf} spill_join resident", SPILL_JOIN_Q, s)
    eng.drop_device_cache()
    eng.settings.set("sql.exec.hbm_budget_bytes", budget)
    p = eng.prepare(SPILL_JOIN_Q, s)
    if p.spill is None or p.spill.kind != "join" or p.spill.nparts < 4:
        raise AssertionError(f"spill join at {budget}: {p.spill}")
    spilled, spill_ms, spill_peak, _ = paths.run(
        "spill_join", f"sf{sf} spill_join", p.run)
    pg = dict(eng.last_exec["paging"])
    same_result("spill join vs resident", spilled, res_join)
    # the oracle: each order's priority as a code in sorted order (the
    # keys are dense 1..n), counted and summed over lineitem's rows
    prios = sorted(tpch.ORDER_PRIORITIES)
    lut = {v: i for i, v in enumerate(prios)}
    opri = tpch.gen_orders(sf)["o_orderpriority"]
    code = np.fromiter((lut[v] for v in opri), dtype=np.int64,
                       count=len(opri))[li["l_orderkey"] - 1]
    want_join = [(k, int(c), float(r)) for k, c, r in zip(
        prios, np.bincount(code, minlength=len(prios)),
        np.bincount(code, li["l_extendedprice"], minlength=len(prios)))]
    check_rows("spill join vs oracle", spilled.rows, want_join)
    out["spill_join"] = {
        "budget": budget, "partitions": p.spill.nparts,
        "seconds": spill_ms / 1e3, "peak_bytes": spill_peak,
        "h2d_bytes": pg["bytes"], "stall_s": pg["stall_s"],
        "overlap_s": pg["overlap_s"], "resident_ms": join_first_ms,
        "resident_peak_bytes": join_peak, "working_set": ws}
    print("spill join: " + json.dumps(out["spill_join"]), flush=True)
    del opri, code

    # spill sort under SET spill = on
    eng.settings.set("sql.exec.hbm_budget_bytes", RESIDENT_BUDGET)
    s_spill = eng.session()
    eng.execute("SET spill = on", s_spill)
    eng.execute(f"SET streaming_page_rows = {page_rows}", s_spill)
    if eng.stream_verdict(SPILL_SORT_Q, s_spill) != "spill-sort":
        raise AssertionError("the shipdate slice sort did not spill")
    res_sort, sort_ms, sort_peak, _ = paths.execute(
        "spill_sort", f"sf{sf} spill_sort", SPILL_SORT_Q, s_spill)
    pg = dict(eng.last_exec["paging"])
    res_sort_res, sort_res_ms, sort_res_peak, _ = paths.execute(
        "spill_sort_resident", f"sf{sf} spill_sort resident", SPILL_SORT_Q, s)
    same_result("spill sort vs resident", res_sort, res_sort_res)
    d0, d1 = tpch._days("1995-03-01"), tpch._days("1995-03-08")
    m = (li["l_shipdate"] >= d0) & (li["l_shipdate"] < d1)
    order = np.lexsort((li["l_linenumber"][m], li["l_orderkey"][m],
                        -li["l_extendedprice"][m]))
    epoch = __import__("datetime").date(1970, 1, 1)
    delta = __import__("datetime").timedelta
    want_sort = [(int(k), int(n), epoch + delta(days=int(d)), float(p_))
                 for k, n, d, p_ in zip(li["l_orderkey"][m][order],
                                        li["l_linenumber"][m][order],
                                        li["l_shipdate"][m][order],
                                        li["l_extendedprice"][m][order])]
    check_rows("spill sort vs oracle", res_sort.rows, want_sort)
    out["spill_sort"] = {
        "rows": len(res_sort.rows), "pages": pg["pages"], "ms": sort_ms,
        "peak_bytes": sort_peak, "resident_ms": sort_res_ms,
        "resident_peak_bytes": sort_res_peak,
        "resident_estimate_bytes": eng.working_set(
            SPILL_SORT_Q, s)["resident"]}
    print("spill sort: " + json.dumps(out["spill_sort"]), flush=True)

    # a streamed prepared statement, run 3 times
    eng.drop_device_cache()
    eng.settings.set("sql.exec.hbm_budget_bytes", STREAM_BUDGET)
    p = eng.prepare(tpch.Q6, s)
    if p.stream is None:
        raise AssertionError("prepared Q6 did not stream at 1 GiB")
    runs = [paths.run("prepared", f"sf{sf} prepared q6 run {i + 1}",
                      p.run)[0] for i in range(3)]
    for r in runs:
        same_result("prepared streamed Q6", r, streamed["q6"])
    out["prepared_q6_runs"] = len(runs)
    # every path run's kernel-1 launches by kind, and each call held
    # against the plain version
    out["kernel1_launches"] = paths.launches
    out["path_checks"] = paths.checks
    del eng, li
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 11: windows, the write path and YCSB-E on the SF1 engine ----------

WINDOW_LIMIT = 1000             # the timed runs' outer ORDER BY ... LIMIT
# every window query reads the orders of customers 1..WINDOW_CUSTKEY
# (about a fifth of SF1's 1.5M): whole o_custkey partitions, so each
# row's window values are those of the whole table
WINDOW_CUSTKEY = 30_000
# window queries over orders: (select list, WHERE), each run with an
# outer ORDER BY o_orderkey (the oracle's row order)
_BY_PRICE = "(PARTITION BY o_custkey ORDER BY o_totalprice DESC)"
_BY_DATE = "(PARTITION BY o_custkey ORDER BY o_orderdate)"
WINDOW_QUERIES = {
    "ranking": (f"row_number() OVER {_BY_PRICE}, rank() OVER {_BY_PRICE}, "
                f"dense_rank() OVER {_BY_PRICE}, ntile(4) OVER {_BY_PRICE}",
                ""),
    "navigation": (f"lag(o_orderdate) OVER {_BY_DATE}, lead(o_orderdate) "
                   f"OVER {_BY_DATE}, first_value(o_orderdate) OVER "
                   f"{_BY_DATE}, last_value(o_orderdate) OVER {_BY_DATE}",
                   ""),
    "running": (f"sum(o_totalprice) OVER {_BY_DATE}, avg(o_totalprice) "
                f"OVER {_BY_DATE}, count(o_totalprice) OVER {_BY_DATE}, "
                f"min(o_totalprice) OVER {_BY_DATE}, max(o_totalprice) "
                f"OVER {_BY_DATE}", ""),
    "partition_total": ("sum(o_totalprice) OVER (PARTITION BY o_custkey)",
                        ""),
    "filtered": (f"row_number() OVER {_BY_PRICE}, sum(o_totalprice) OVER "
                 f"{_BY_DATE}", "o_orderdate >= DATE '1996-01-01'"),
}


def window_sql(name: str, limit: int | None = None) -> str:
    items, where = WINDOW_QUERIES[name]
    sql = (f"SELECT o_orderkey, {items} FROM orders WHERE o_custkey <= "
           f"{WINDOW_CUSTKEY}")
    if where:
        sql += f" AND {where}"
    sql += " ORDER BY o_orderkey"
    return sql + (f" LIMIT {limit}" if limit else "")


def _segments(part, keys):
    """The window oracle's sorted domain: rows ordered by (part, keys,
    row index), the row index standing for the stored order that the
    engine's stable sort keeps among ties. Returns (order, seg_start,
    peer_start, peer_end, seg_end), all in the sorted domain."""
    import numpy as np
    n = len(part)
    idx = np.arange(n)
    order = np.lexsort([idx] + list(reversed(keys)) + [part])
    ps = part[order]
    ks = [k[order] for k in keys]
    new_seg = np.ones(n, bool)
    new_seg[1:] = ps[1:] != ps[:-1]
    new_peer = new_seg.copy()
    for k in ks:
        new_peer[1:] |= k[1:] != k[:-1]
    seg_start = np.maximum.accumulate(np.where(new_seg, idx, 0))
    peer_start = np.maximum.accumulate(np.where(new_peer, idx, 0))

    def ends(new):
        last = np.ones(n, bool)
        last[:-1] = new[1:]
        return np.minimum.accumulate(np.where(last, idx, n - 1)[::-1])[::-1]
    return order, seg_start, peer_start, ends(new_peer), ends(new_seg)


def _running(x, seg_start, end):
    """Per-row sum of x over [seg_start, end] (sorted domain)."""
    import numpy as np
    cum = np.cumsum(x)
    before = np.where(seg_start > 0, cum[np.maximum(seg_start - 1, 0)], 0)
    return cum[end] - before


def _running_extreme(x, seg_start, end, fn):
    """Running max (fn=np.maximum) or min of non-negative x per
    partition, read at `end`."""
    import numpy as np
    seg_id = np.cumsum(seg_start == np.arange(len(x)))
    big = int(x.max()) + 1 if len(x) else 1
    if fn is np.maximum:
        run = np.maximum.accumulate(x + seg_id * big) - seg_id * big
    else:
        run = -(np.maximum.accumulate(-x + seg_id * big) - seg_id * big)
    return run[end]


def window_oracle(name: str, orders: dict) -> list:
    """Rows of window_sql(name) over the generator's orders, by numpy:
    integers and dates exactly, DECIMAL as the engine decodes it
    (cents / 100), AVG as float64."""
    import datetime

    import numpy as np
    ok = orders["o_orderkey"]
    cust = orders["o_custkey"]
    cents = np.round(orders["o_totalprice"] * 100).astype(np.int64)
    date = orders["o_orderdate"].astype(np.int64)
    keep = cust <= WINDOW_CUSTKEY
    if name == "filtered":
        keep &= date >= (datetime.date(1996, 1, 1)
                         - datetime.date(1970, 1, 1)).days
    ok, cust, cents, date = ok[keep], cust[keep], cents[keep], date[keep]
    n = len(ok)
    cols = []

    def back(sorted_vals, order):
        out = np.empty_like(sorted_vals)
        out[order] = sorted_vals
        return out

    def day(v):
        return datetime.date(1970, 1, 1) + datetime.timedelta(days=int(v))

    if name in ("ranking", "filtered"):
        order, ss, pst, pe, se = _segments(cust, [-cents])
        i = np.arange(n)
        rn = i - ss + 1
        if name == "ranking":
            rk = pst - ss + 1
            c = np.cumsum(pst == i)
            dr = c - c[ss] + 1
            rn0, size = i - ss, se - ss + 1
            q, rem = size // 4, size % 4
            big = rem * (q + 1)
            nt = np.where(rn0 < big, rn0 // (q + 1) + 1,
                          rem + (rn0 - big) // np.maximum(q, 1) + 1)
            cols = [back(v, order).tolist() for v in (rn, rk, dr, nt)]
        else:
            cols = [back(rn, order).tolist()]
    if name in ("navigation", "running", "filtered"):
        order, ss, pst, pe, se = _segments(cust, [date])
        i = np.arange(n)
        ds = date[order]
        if name == "navigation":
            lag = [None if j - 1 < s else day(ds[j - 1])
                   for j, s in zip(i, ss)]
            lead = [None if j + 1 > e else day(ds[j + 1])
                    for j, e in zip(i, se)]
            first = [day(v) for v in ds[ss]]
            last = [day(v) for v in ds[pe]]
            for vals in (lag, lead, first, last):
                out = [None] * n
                for j, v in zip(order, vals):
                    out[j] = v
                cols.append(out)
        else:
            cs = cents[order]
            tot = _running(cs, ss, pe)
            cnt = pe - ss + 1
            if name == "running":
                mn = _running_extreme(cs, ss, pe, np.minimum)
                mx = _running_extreme(cs, ss, pe, np.maximum)
                cols += [(back(tot, order) / 100).tolist(),
                         (back(tot, order) / 100 / back(cnt, order)
                          ).tolist(),
                         back(cnt, order).tolist(),
                         (back(mn, order) / 100).tolist(),
                         (back(mx, order) / 100).tolist()]
            else:
                cols.append((back(tot, order) / 100).tolist())
    if name == "partition_total":
        order, ss, pst, pe, se = _segments(cust, [])
        tot = _running(cents[order], ss, se)
        cols = [(back(tot, order) / 100).tolist()]
    # ORDER BY o_orderkey: the generator's orders are in key order
    return list(zip(ok.tolist(), *cols))


def check_window(label, got, want) -> float:
    """Window rows against the oracle's, in order: FLOAT8 (AVG) within
    rel 1e-9, every other value (integers, DECIMAL, dates) exactly."""
    if len(got) != len(want) or not want:
        raise AssertionError(f"{label}: {len(got)} rows, oracle "
                             f"{len(want)}")
    worst = 0.0
    for g_row, w_row in zip(got, want):
        for k, (g, w) in enumerate(zip(g_row, w_row)):
            if label.startswith("running") and k == 2:
                err = abs(g - w) / max(abs(w), 1e-300)
                worst = max(worst, err)
                if err > 1e-9:
                    raise AssertionError(f"{label}: {g_row} != oracle "
                                         f"{w_row}")
            elif g != w:
                raise AssertionError(f"{label}: {g_row} != oracle {w_row}")
    return worst


def window_phase(eng, orders: dict, reps: int = 3) -> dict:
    """Phase 11a: the window queries over the orders of customers
    1..WINDOW_CUSTKEY (whole partitions), each checked once in full
    against its oracle (that first run timed), then timed as medians of
    `reps` warm runs with an outer LIMIT (decoding every row to Python
    objects takes seconds a query and would be most of the time), those
    rows checked too."""
    out = {}
    for name in WINDOW_QUERIES:
        want = window_oracle(name, orders)
        t0 = time.perf_counter()
        res = eng.execute(window_sql(name))
        first_s = time.perf_counter() - t0
        err = check_window(name, res.rows, want)
        lim = window_sql(name, WINDOW_LIMIT)
        check_window(name + " limit", eng.execute(lim).rows,
                     want[:WINDOW_LIMIT])
        out[name] = {
            "rows": len(res.rows), "first_s": first_s,
            "limit_ms": _median_ms(lambda: eng.execute(lim), reps=reps),
            "max_rel_err": err}
        print(f"window {name}: " + json.dumps(out[name]), flush=True)
    return out


def _apply_refresh(li, orders, li_new, o_new, rf2, upd_key, upd_disc):
    """The oracle's tables after RF1, RF2 and the UPDATE: RF1's rows in
    the forms `li` holds (decoded strings or dictionary codes),
    RF2's orders and their lines removed, one order's l_discount set."""
    import numpy as np

    from cockroach_tpu_torch.models import tpch
    new = {}
    for c, v in li.items():
        add = li_new[c]
        if v.dtype.kind in "iu" and add.dtype == object:
            vocab = tpch.LINEITEM_DICTS[c]
            add = np.asarray([vocab.index(x) for x in add], dtype=v.dtype)
        new[c] = np.concatenate([v, add.astype(v.dtype)])
    keep = ~np.isin(new["l_orderkey"], rf2)
    new = {c: v[keep] for c, v in new.items()}
    new["l_discount"] = np.where(new["l_orderkey"] == upd_key, upd_disc,
                                 new["l_discount"])
    o2 = {c: np.concatenate([v, o_new[c].astype(v.dtype)])
          for c, v in orders.items()}
    okeep = ~np.isin(o2["o_orderkey"], rf2)
    return new, {c: v[okeep] for c, v in o2.items()}


# rows of lineitem whose keys the pure-Python row_key loop encodes, timed
PK_LOOP_SAMPLE = 50_000


def check_refreshed(q, res, want) -> None:
    """Q1, Q6, Q14 or Q3 after a write, against its oracle at phase 2's
    and 6's tolerances."""
    if q == "q1":
        check_q1(res.rows, want)
    elif q in ("q6", "q14"):
        if not _close(res.rows[0][0], want, DECIMAL_REL):
            raise AssertionError(f"{q} after the write {res.rows[0][0]} "
                                 f"!= {want}")
    else:
        check_result("Q3 after the write", res, want)


def recreate_check(eng) -> dict:
    """TRUNCATE and DROP + CREATE give a table new dictionaries: refilled
    with the same row count and dictionary size, it reads its own
    strings, through execute() (a miss) and through a Prepared made
    before the TRUNCATE."""
    ddl = "CREATE TABLE recreated (k INT PRIMARY KEY, s STRING, " \
          "m DECIMAL(6,2))"
    q = "SELECT s, m FROM recreated ORDER BY k"
    eng.execute(ddl)
    eng.execute("INSERT INTO recreated VALUES (1, 'a', 1.10), (2, 'b', 2.20)")
    s = eng.session()
    p = eng.prepare(q, s)
    steps = [([], [("a", 1.1), ("b", 2.2)]),
             (["TRUNCATE recreated", "INSERT INTO recreated VALUES "
               "(1, 'b', 3.30), (2, 'a', 4.40)"], [("b", 3.3), ("a", 4.4)]),
             (["DROP TABLE recreated", ddl, "INSERT INTO recreated VALUES "
               "(1, 'y', 5.50), (2, 'x', 6.60)"], [("y", 5.5), ("x", 6.6)])]
    misses = []
    for writes, want in steps:
        for w in writes:
            eng.execute(w, s)
        miss = eng.plan_cache["miss"]
        got = eng.execute(q, s).rows
        misses.append(eng.plan_cache["miss"] - miss)
        if got != want or p.run().rows != want or \
                misses[-1] != (1 if writes else 0):
            raise AssertionError(f"after {writes}: {got} (prepared "
                                 f"{p.run().rows}), want {want}, "
                                 f"misses {misses[-1]}")
    eng.execute("DROP TABLE recreated")
    return {"steps": len(steps), "misses": misses}


def refresh_phase(eng, li, part, orders, cust, sf, reps: int = 3) -> dict:
    """Phase 11b: TPC-H's refresh pair through SQL, then Q1, Q6, Q14
    and Q3 against the oracles over arrays changed the same way."""
    import numpy as np

    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    on_card = eng.device.type == "cuda"
    o_new, li_new = tpch.gen_refresh(sf)
    rf2 = tpch.rf2_orderkeys(sf)
    keys = ", ".join(str(int(k)) for k in rf2)
    upd_key = int(next(k for k in li["l_orderkey"] if k not in set(rf2)))
    out = {"rf1_orders": len(o_new["o_orderkey"]),
           "rf1_lineitems": len(li_new["l_orderkey"]),
           "rf2_orders": len(rf2),
           "lineitem_chunks_before": len(eng.store.table("lineitem").chunks)}
    # the pk locators the write path needs, built by the bulk encoder
    # (storage/keys.py encode_int_keys); the reference's pure-Python
    # path (row_key per row) is timed over a sample of lineitem beside it
    td = eng.store.table("lineitem")
    chunk = td.chunks[0]
    sample = min(PK_LOOP_SAMPLE, chunk.n)
    t0 = time.perf_counter()
    for ri in range(sample):
        eng.store.row_key(td, chunk, ri)
    out["pk_row_key_loop"] = {"rows": sample,
                              "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    for t in ("lineitem", "orders"):
        eng.store.ensure_pk_index(t)
    out["pk_index_s"] = time.perf_counter() - t0
    want_q6_old = tpch.ref_q6(li)
    li2, orders2 = _apply_refresh(li, orders, li_new, o_new, rf2,
                                  upd_key, 0.04)
    rf1_only, _ = _apply_refresh(li, orders, li_new, o_new,
                                 rf2[:0], -1, 0.0)
    want = {"q6_rf1": tpch.ref_q6(rf1_only), "q1": tpch.ref_q1(li2),
            "q6": tpch.ref_q6(li2), "q14": tpch.ref_q14(li2, part),
            "q3": tpch.ref_q3(li2, orders2, cust)}
    del rf1_only
    # the HLC wall time before the first write: phase 15 reads AS OF it
    time.sleep(0.002)
    out["t0_wall"] = eng.clock.now().wall
    time.sleep(0.002)
    # RF1 in one transaction, with a Q6 that reads its own writes
    s = eng.session()
    t0 = time.perf_counter()
    eng.execute("BEGIN", s)
    for st in (tpch.insert_statements("orders", o_new)
               + tpch.insert_statements("lineitem", li_new)):
        eng.execute(st, s)
    t1 = time.perf_counter()
    q6_txn = eng.execute(tpch.Q6, s).rows[0][0]
    out["q6_in_txn_s"] = time.perf_counter() - t1
    q6_out = eng.execute(tpch.Q6).rows[0][0]
    eng.execute("COMMIT", s)
    out["rf1_s"] = time.perf_counter() - t0 - out["q6_in_txn_s"]
    if not _close(q6_txn, want["q6_rf1"], DECIMAL_REL):
        raise AssertionError(f"Q6 in RF1's txn {q6_txn} != oracle "
                             f"{want['q6_rf1']}")
    if not _close(q6_out, want_q6_old, DECIMAL_REL):
        raise AssertionError(f"Q6 outside RF1's txn saw its writes: {q6_out}")
    # RF2
    t0 = time.perf_counter()
    n_li = eng.execute(
        f"DELETE FROM lineitem WHERE l_orderkey IN ({keys})").row_count
    n_o = eng.execute(
        f"DELETE FROM orders WHERE o_orderkey IN ({keys})").row_count
    out["rf2_s"] = time.perf_counter() - t0
    out["rf2_deleted"] = {"lineitem": n_li, "orders": n_o}
    if n_o != len(rf2):
        raise AssertionError(f"RF2 deleted {n_o} orders, not {len(rf2)}")
    t0 = time.perf_counter()
    n_up = eng.execute("UPDATE lineitem SET l_discount = 0.04 WHERE "
                       f"l_orderkey = {upd_key}").row_count
    out["update_s"] = time.perf_counter() - t0
    out["update_rows"] = n_up
    # an insert rolled back changes nothing
    eng.execute("BEGIN", s)
    eng.execute(tpch.insert_statements("lineitem", li_new)[0], s)
    eng.execute("ROLLBACK", s)
    out["lineitem_chunks_after"] = len(eng.store.table("lineitem").chunks)
    queries = {"q1": tpch.Q1, "q6": tpch.Q6, "q14": tpch.Q14,
               "q3": tpch.Q3}
    routes = {}
    for q, sql in queries.items():
        _counts_zero()
        with recording_slots() as calls:
            res = eng.execute(sql)
            _sync()
        k1 = tgl.LAUNCHES if on_card else tgl.PLAIN_CALLS
        routes[q] = {"groupagg_large": k1}
        check_refreshed(q, res, want[q])
        if q == "q1" and k1 != 1:
            raise AssertionError(f"Q1 after the refresh launched "
                                 f"kernel 1 {k1} times, not once")
        if on_card and k1:
            routes[q]["kernel_checks"] = check_calls(
                f"sf1 {q} after refresh", calls, k1)
        if q == "q3":
            q3_top = int(res.rows[0][0])
        # the second run hits the exec cache and reads the cached copy
        cache0 = dict(eng.plan_cache)
        if eng.execute(sql).rows != res.rows:
            raise AssertionError(f"{q}: second run gave other rows")
        if eng.plan_cache["hit"] <= cache0["hit"] or \
                eng.plan_cache["miss"] != cache0["miss"]:
            raise AssertionError(f"{q}: second run missed the exec cache")
        routes[q]["ms"] = _median_ms(lambda: eng.execute(sql), reps=reps)
    # a further write that changes DECIMAL values of every query's
    # input (Q3's first order among them): each query's first run after
    # it misses the exec cache and equals the oracle over the changed
    # arrays, and its second run hits
    gen0 = eng.store.table("lineitem").generation
    more = np.unique(np.concatenate([
        [q3_top], np.random.default_rng(11).choice(
            np.setdiff1d(li2["l_orderkey"], [upd_key]), 199,
            replace=False)])).astype(np.int64)
    t0 = time.perf_counter()
    n_more = eng.execute(
        "UPDATE lineitem SET l_discount = 0.06, l_extendedprice = "
        "l_extendedprice + 1.00 WHERE l_orderkey IN "
        f"({', '.join(str(int(k)) for k in more)})").row_count
    out["further_update"] = {"orders": len(more), "rows": n_more,
                             "s": time.perf_counter() - t0}
    hit3 = np.isin(li2["l_orderkey"], more)
    if n_more != int(hit3.sum()):
        raise AssertionError(f"the further UPDATE wrote {n_more} rows, "
                             f"not {int(hit3.sum())}")
    li2["l_discount"] = np.where(hit3, 0.06, li2["l_discount"])
    li2["l_extendedprice"] = np.where(hit3, li2["l_extendedprice"] + 1.0,
                                      li2["l_extendedprice"])
    want = {"q1": tpch.ref_q1(li2), "q6": tpch.ref_q6(li2),
            "q14": tpch.ref_q14(li2, part),
            "q3": tpch.ref_q3(li2, orders2, cust)}
    for q, sql in queries.items():
        cache0 = dict(eng.plan_cache)
        _counts_zero()
        with recording_slots() as calls:
            res = eng.execute(sql)
            _sync()
        k1 = tgl.LAUNCHES if on_card else tgl.PLAIN_CALLS
        after = {"groupagg_large": k1, "miss": eng.plan_cache["miss"]
                 - cache0["miss"]}
        if after["miss"] < 1:
            raise AssertionError(f"{q}: the run after the further write "
                                 "hit the exec cache")
        check_refreshed(q, res, want[q])
        if q == "q1" and k1 != 1:
            raise AssertionError(f"Q1 after the further write launched "
                                 f"kernel 1 {k1} times, not once")
        if on_card and k1:
            after["kernel_checks"] = check_calls(
                f"sf1 {q} after further write", calls, k1)
        cache0 = dict(eng.plan_cache)
        if eng.execute(sql).rows != res.rows or \
                eng.plan_cache["hit"] <= cache0["hit"] or \
                eng.plan_cache["miss"] != cache0["miss"]:
            raise AssertionError(f"{q}: the second run after the further "
                                 f"write missed or differed")
        routes[q + " after write"] = after
    resident = [g for (t, g) in eng._device_tables if t == "lineitem"]
    if resident != [eng.store.table("lineitem").generation] or \
            resident[0] == gen0:
        raise AssertionError(f"lineitem's device copy is not the moved "
                             f"generation's: {resident}, was {gen0}")
    out["recreate"] = recreate_check(eng)
    out["routes"] = routes
    out["q6_in_txn"], out["q6_outside_txn"] = q6_txn, q6_out
    print("refresh: " + json.dumps(out), flush=True)
    # lineitem's and orders' arrays as this phase left them, for the
    # oracles of phases 12 and 13 (taken off before the dml line prints)
    out["li_after"], out["orders_after"] = li2, orders2
    return out


HISTORY_SAMPLE = 20             # point SELECTs by o_custkey
# seconds with no lineitem write before phase 15's own write: AS OF
# '-Ns' reads land in the middle of that window, historical (a newer
# version exists) and with a known state
INTERVAL_WINDOW_S = 6.0
FEE_DDL = ("ALTER TABLE lineitem ADD COLUMN l_fee DECIMAL(15,2) NOT NULL "
           "DEFAULT 0.05")
GC_REFUSED = "must be after replica GC threshold"


def _as_of(sql: str, wall: int) -> str:
    """A lineitem query read AS OF SYSTEM TIME ``wall``."""
    return sql.replace("FROM lineitem\n",
                       f"FROM lineitem AS OF SYSTEM TIME {wall}\n")


@contextlib.contextmanager
def _gc_pauses(out: list):
    """Appends to ``out`` the ms the cyclic collector ran while the
    block ran: a host pause inside a statement's time."""
    marks: list = []

    def note(_phase, _info):
        marks.append(time.perf_counter())
    gc.callbacks.append(note)
    try:
        yield
    finally:
        gc.callbacks.remove(note)
        out.append(sum(b - a for a, b in zip(marks[::2], marks[1::2]))
                   * 1e3)


def history_phase(eng, li, li_after, orders_after, sf, t0_wall) -> dict:
    """Phase 15 on the engine phase 11 wrote: AS OF SYSTEM TIME t0 (the
    HLC wall time before RF1) against the oracles of `li`, the present
    against `li_after`; protected timestamps, a zone and MVCC GC; the
    online CREATE INDEX jobs; ALTER TABLE ADD/DROP COLUMN under Q1. Each
    kernel-1 launch is counted from 0 and held against the plain
    version at its slots (on the card), each kernel-2 launch at its
    inputs; AS OF '-Ns' beside a write reads at a new historical
    timestamp each statement and must plan and upload nothing the
    second time."""
    import numpy as np

    from cockroach_tpu_torch.exec.session import EngineError
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    from cockroach_tpu_torch.storage.hlc import Timestamp
    on_card = eng.device.type == "cuda"
    t_phase = time.perf_counter()
    # every lineitem write so far committed at or before this
    t_quiet = eng.clock.now().wall
    want = {"q1_then": tpch.ref_q1(li), "q6_then": tpch.ref_q6(li),
            "q1_now": tpch.ref_q1(li_after), "q6_now": tpch.ref_q6(li_after)}
    q1_then, q6_then = _as_of(tpch.Q1, t0_wall), _as_of(tpch.Q6, t0_wall)
    out = {"t0_wall": t0_wall, "runs": {}}
    checks: dict = {}
    small_checks: list = []
    total = [0, 0]

    def run(label, fn, k1_want, check):
        """One statement: both kernels' launches from 0, rows checked."""
        _counts_zero()
        pause: list = []
        with recording_slots() as calls, recording_small() as scalls, \
                _gc_pauses(pause):
            t0 = time.perf_counter()
            res = fn()
            _sync()
            dt = time.perf_counter() - t0
        k1, k2 = _kernel_counts(on_card)
        if k1 != k1_want:
            raise AssertionError(f"{label}: kernel 1 launched {k1} times, "
                                 f"not {k1_want}")
        check(res.rows)
        if on_card and k1:
            checks[f"sf1 {label} phase 15"] = check_calls(
                f"phase 15 {label}", calls, k1)
        if on_card and k2:
            small_checks.extend(_check_small_calls(f"phase 15 {label}",
                                                   scalls, k2))
        total[0] += k1
        total[1] += k2
        out["runs"][label] = {"ms": dt * 1e3, "kernel1": k1, "kernel2": k2,
                              "gc_ms": pause[0]}
        return res

    def q1_is(w):
        return lambda rows: check_q1(rows, w)

    def q6_is(w):
        def check(rows):
            if not _close(rows[0][0], w, DECIMAL_REL):
                raise AssertionError(f"Q6 {rows[0][0]} != oracle {w}")
        return check

    def moved() -> int:
        ps = eng.last_profile
        return ps.total_bytes_moved() if ps is not None else -1

    # -- 1. AS OF t0 against the tables phase 11 started from -----------
    run("q1 as of t0", lambda: eng.execute(q1_then), 1,
        q1_is(want["q1_then"]))
    miss = eng.plan_cache["miss"]
    run("q1 as of t0 again", lambda: eng.execute(q1_then), 1,
        q1_is(want["q1_then"]))
    out["q1_as_of_second_htod_bytes"] = moved()
    if eng.plan_cache["miss"] != miss or out["q1_as_of_second_htod_bytes"]:
        raise AssertionError(
            f"the second AS OF Q1 planned again or uploaded: misses "
            f"{eng.plan_cache['miss'] - miss}, "
            f"{out['q1_as_of_second_htod_bytes']} bytes")
    for label in ("q6 as of t0", "q6 as of t0 again"):
        run(label, lambda: eng.execute(q6_then), 0, q6_is(want["q6_then"]))
    p = eng.prepare(q1_then)
    run("prepared q1 as of t0", p.run, 1, q1_is(want["q1_then"]))
    run("q1 now", lambda: eng.execute(tpch.Q1), 1, q1_is(want["q1_now"]))
    run("q6 now", lambda: eng.execute(tpch.Q6), 0, q6_is(want["q6_now"]))
    _counts_zero()
    out["q1_as_of_ms"] = _median_ms(lambda: eng.execute(q1_then), reps=3)
    out["q1_now_ms"] = _median_ms(lambda: eng.execute(tpch.Q1), reps=3)
    timed, timed2 = _kernel_counts(on_card)
    # three runs each of two statements already run (and checked) above
    want2 = 3 * (out["runs"]["q1 as of t0 again"]["kernel2"]
                 + out["runs"]["q1 now"]["kernel2"])
    if timed != 6 or timed2 != want2:
        raise AssertionError(f"6 timed Q1 runs launched kernel 1 {timed} "
                             f"times, kernel 2 {timed2} (not {want2})")
    total[0] += timed
    total[1] += timed2
    out["timed_launches"] = {"groupagg_large": timed, "groupagg": timed2}

    # -- 1b. AS OF '-Ns' beside a write -------------------------------------
    # each statement of one text reads at a new historical timestamp, in
    # the quiet window before the write: the state of li_after
    time.sleep(max(0.0, INTERVAL_WINDOW_S
                   - (eng.clock.now().wall - t_quiet) / 1e9))
    t_write = eng.clock.now().wall     # the UPDATE commits after it
    upd = int(li_after["l_orderkey"][0])
    eng.execute("UPDATE lineitem SET l_shipmode = l_shipmode WHERE "
                f"l_orderkey = {upd}")
    run("q1 now after a write", lambda: eng.execute(tpch.Q1), 1,
        q1_is(want["q1_now"]))
    ago = round((eng.clock.now().wall - t_write) / 1e9
                + INTERVAL_WINDOW_S / 2, 6)
    q1_ago = _as_of(tpch.Q1, f"'-{ago:.6f}s'")
    ago_ns = int(ago * 1e9)
    out["interval"] = {"ago_s": ago, "runs": []}
    for label in ("q1 as of interval", "q1 as of interval again"):
        miss = eng.plan_cache["miss"]
        before = eng.clock.now().wall
        run(label, lambda: eng.execute(q1_ago), 1, q1_is(want["q1_now"]))
        after = eng.clock.now().wall
        # the read timestamp lies in [before, after] - ago
        if not t_quiet < before - ago_ns or not after - ago_ns < t_write:
            raise AssertionError(f"{label} read outside the quiet window")
        out["interval"]["runs"].append({
            "misses": eng.plan_cache["miss"] - miss, "htod_bytes": moved(),
            "read_ts_lo": before - ago_ns})
    second = out["interval"]["runs"][1]
    if second["misses"] or second["htod_bytes"]:
        raise AssertionError(f"the second AS OF '-Ns' Q1 planned again or "
                             f"uploaded: {second}")
    _counts_zero()
    before = eng.clock.now().wall
    out["q1_as_of_interval_ms"] = _median_ms(lambda: eng.execute(q1_ago),
                                             reps=3)
    timed, timed2 = _kernel_counts(on_card)
    want2 = 3 * out["runs"]["q1 as of interval again"]["kernel2"]
    if timed != 3 or timed2 != want2 or \
            eng.clock.now().wall - ago_ns >= t_write:
        raise AssertionError(f"3 timed AS OF '-Ns' Q1 runs: kernel 1 "
                             f"{timed}, kernel 2 {timed2} (not {want2}), "
                             f"from {before - ago_ns} against {t_write}")
    total[0] += timed
    total[1] += timed2
    out["timed_launches"]["groupagg_large"] += timed
    out["timed_launches"]["groupagg"] += timed2

    # -- 2. protected timestamps, a zone, MVCC GC ---------------------------
    td = eng.store.table("lineitem")
    rid = eng.protectedts.protect(Timestamp(t0_wall, 0).to_int(),
                                  ["lineitem", "orders"], meta="phase 15")
    eng.execute("ALTER TABLE lineitem CONFIGURE ZONE USING "
                "gc.ttl_seconds = 1")
    protected = eng.run_gc("lineitem")
    if protected:
        raise AssertionError(f"a GC pass under the protection at t0 "
                             f"removed {protected} versions")
    run("q1 as of t0 after protected gc", lambda: eng.execute(q1_then), 1,
        q1_is(want["q1_then"]))
    eng.protectedts.release(rid)
    thr = eng.gc_threshold("lineitem").to_int()
    expect = sum(int((c.mvcc_del <= thr).sum()) for c in td.chunks)
    versions0 = td.row_count
    t0 = time.perf_counter()
    removed = eng.run_gc("lineitem")
    out["gc"] = {"s": time.perf_counter() - t0, "removed": removed,
                 "versions_before": versions0,
                 "versions_after": eng.store.table("lineitem").row_count,
                 "protected_pass_removed": protected}
    rf2 = tpch.rf2_orderkeys(sf)
    left = sum(int(np.isin(c.data["l_orderkey"], rf2).sum())
               for c in eng.store.table("lineitem").chunks)
    if removed != expect or left:
        raise AssertionError(f"GC removed {removed} versions, {expect} lay "
                             f"below its threshold; {left} RF2 lines left")
    run("q1 now after gc", lambda: eng.execute(tpch.Q1), 1,
        q1_is(want["q1_now"]))
    try:
        eng.execute(q1_then)
        raise AssertionError("AS OF t0 below the GC threshold was served")
    except EngineError as e:
        if GC_REFUSED not in str(e):
            raise
        out["as_of_refused"] = str(e)
    out["zone"] = eng.execute(
        "SHOW ZONE CONFIGURATION FOR TABLE lineitem").rows
    print(f"phase 15 zone: {out['zone']}; gc: {out['gc']}", flush=True)

    # -- 3. online CREATE INDEX ---------------------------------------------
    t0 = time.perf_counter()
    eng.execute("CREATE INDEX o_cust_idx ON orders (o_custkey)")
    out["o_cust_idx_s"] = time.perf_counter() - t0
    job = eng.execute("SHOW JOBS").rows[-1]
    idx = eng.execute("SHOW INDEXES FROM orders").rows
    if job[1:3] != ("index-backfill", "succeeded") or \
            ("orders", "o_cust_idx", "o_custkey", False, "public") not in idx:
        raise AssertionError(f"CREATE INDEX: job {job}, indexes {idx}")
    cust = orders_after["o_custkey"]
    keys = np.random.default_rng(15).choice(np.unique(cust), HISTORY_SAMPLE,
                                            replace=False)
    fast = eng.metrics.counter("sql.select.index_fastpath")
    t0 = time.perf_counter()
    for k in keys.tolist():
        c0 = fast.value()
        got = eng.execute(f"SELECT o_orderkey, o_totalprice FROM orders "
                          f"WHERE o_custkey = {k}").rows
        hit = cust == k
        oracle = sorted(zip(orders_after["o_orderkey"][hit].tolist(),
                            np.round(orders_after["o_totalprice"][hit], 2)
                            .tolist()))
        if fast.value() != c0 + 1 or sorted(
                (o, round(v, 2)) for o, v in got) != oracle:
            raise AssertionError(f"o_custkey = {k}: {got} != {oracle} "
                                 f"(fast path {fast.value() - c0})")
    out["point_selects"] = {"n": HISTORY_SAMPLE,
                            "ms": (time.perf_counter() - t0) * 1e3
                            / HISTORY_SAMPLE}
    t0 = time.perf_counter()
    eng.execute("CREATE UNIQUE INDEX s_name_key ON supplier (s_name)")
    out["s_name_key_s"] = time.perf_counter() - t0
    dup = ("duplicate key value ('Supplier#000000001',) violates unique "
           "index 's_name_key' of 'supplier'")
    try:
        eng.execute("INSERT INTO supplier VALUES "
                    "(99999999, 'Supplier#000000001', 1, 1.00)")
        raise AssertionError("a duplicate s_name was inserted")
    except EngineError as e:
        if str(e) != dup:
            raise
    t0 = time.perf_counter()
    try:
        eng.execute("CREATE UNIQUE INDEX l_ok_key ON lineitem (l_orderkey)")
        raise AssertionError("a unique index over l_orderkey was built")
    except EngineError as e:
        out["l_ok_key_error"] = str(e)
    out["l_ok_key_s"] = time.perf_counter() - t0
    job = eng.execute("SHOW JOBS").rows[-1]
    li_idx = eng.execute("SHOW INDEXES FROM lineitem").rows
    if "duplicate key value" not in out["l_ok_key_error"] or \
            job[2] != "failed" or len(li_idx) != 1:
        raise AssertionError(f"l_ok_key: {out['l_ok_key_error']}, job "
                             f"{job}, indexes {li_idx}")
    out["jobs"] = eng.execute("SHOW JOBS").rows

    # -- 4. ALTER TABLE under Q1 ----------------------------------------------
    t0 = time.perf_counter()
    eng.execute(FEE_DDL)
    out["add_column_s"] = time.perf_counter() - t0

    def fee_is(rows):
        check_q1([r[:-1] for r in rows], want["q1_now"])
        for r in rows:
            if round(r[-1] * 100) != 5 * r[-2]:
                raise AssertionError(f"sum(l_fee) {r[-1]} != 0.05 x {r[-2]}")
    q1_fee = tpch.Q1.replace("count(*) AS count_order",
                             "count(*) AS count_order, sum(l_fee) AS fee")
    run("q1 with l_fee", lambda: eng.execute(q1_fee), 1, fee_is)
    t0 = time.perf_counter()
    eng.execute("ALTER TABLE lineitem DROP COLUMN l_fee")
    out["drop_column_s"] = time.perf_counter() - t0
    run("q1 after drop column", lambda: eng.execute(tpch.Q1), 1,
        q1_is(want["q1_now"]))
    out["launches"] = {"groupagg_large": total[0], "groupagg": total[1]}
    out["path_checks"] = checks
    out["small_checks"] = small_checks
    out["seconds"] = time.perf_counter() - t_phase
    return out


def history_phase_alone(sf: float = SF, device=None, rows=None) -> dict:
    """Phase 15 by itself: loads lineitem, part, orders, customer and
    supplier at `sf`, runs phase 11's refresh pair (its t0 and its
    tables' oracles), then history_phase, and prints its line
    (``python3 -c "import chip_smoke; chip_smoke.history_phase_alone()"``;
    on the CPU ``history_phase_alone(0.01, "cpu", rows=20000)``)."""
    import numpy as np

    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    smi = _smi() if device is None else "cpu"
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    eng = Engine(device=device)
    tpch.load(eng, sf=sf, rows=rows, tables=("lineitem", "part"),
              encoded=True)
    tpch.load(eng, sf=sf, tables=("orders", "customer", "supplier"))
    li = tpch.gen_lineitem(sf, rows=rows, encoded=True)
    li["l_returnflag"] = np.asarray(tpch.RF_VALUES)[li["l_returnflag"]]
    li["l_linestatus"] = np.asarray(tpch.LS_VALUES)[li["l_linestatus"]]
    li["l_shipmode"] = np.asarray(tpch.SHIPMODES, dtype=object)[
        li["l_shipmode"]]
    print(f"load SF{sf}: {time.perf_counter() - t0:.1f} s", flush=True)
    refresh = refresh_phase(eng, li, tpch.gen_part(sf), tpch.gen_orders(sf),
                            tpch.gen_customer(sf), sf, reps=1)
    out = history_phase(eng, li, refresh["li_after"],
                        refresh["orders_after"], sf, refresh["t0_wall"])
    print(f"phase 15: {out['seconds']:.1f} s", flush=True)
    print(json.dumps({"history": dict(out, card=smi)}), flush=True)
    return out


# -- phase 16: jobs and changefeeds ------------------------------------------

IMPORT_ROWS = 6_000_000         # the IMPORT job's rows
IMPORT_CHUNK = 500_000          # rows a chunk (one sealed chunk each)
IMPORT_CRASH = 3                # the first session dies after this chunk
IMPORT_COLUMNS = {"a": "int", "b": "float", "s": 16}
IMPORT_DDL = ("CREATE TABLE imp (a INT8 NOT NULL, b FLOAT NOT NULL, "
              "s STRING NOT NULL)")
IMPORT_GROUP_BY = "SELECT s, count(*), sum(a) FROM imp GROUP BY s ORDER BY s"
TTL_ROW = 5_000                 # the TTL cutoff is this row's ship date
FEED_TIMEOUT = 60.0             # seconds a feed has to deliver


def _feed_lines(path: str) -> tuple:
    """(row events, resolved timestamps) in a file sink so far."""
    rows, resolved = [], []
    try:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    except FileNotFoundError:
        return rows, resolved
    for line in text.splitlines():
        if not line.endswith("}"):
            continue            # a line the feed is still writing
        o = json.loads(line)
        if "resolved" in o:
            resolved.append(o["resolved"])
        else:
            rows.append(o)
    return rows, resolved


def _wait_feed(path: str, cond, label: str) -> tuple:
    deadline = time.monotonic() + FEED_TIMEOUT
    while True:
        got = _feed_lines(path)
        if cond(*got):
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"{label}: the feed delivered "
                                 f"{len(got[0])} rows, {len(got[1])} "
                                 "resolved timestamps")
        time.sleep(0.02)


def _collection_bytes(path: str, layer: int) -> int:
    import os
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path) if f.startswith(f"l{layer}_"))


def jobs_phase(eng, li_after, sf, import_rows: int = IMPORT_ROWS,
               import_chunk: int = IMPORT_CHUNK,
               ttl_row: int = TTL_ROW) -> dict:
    """Phase 16 on the engine phase 15 left (``li_after``: lineitem's
    arrays as it holds them): changefeeds on supplier (from cursor 0)
    and lineitem (from now), a full BACKUP of lineitem and orders, a row
    TTL pass over lineitem, an incremental BACKUP, RESTORE into a second
    engine, an IMPORT job of ``import_rows`` rows in chunks of
    ``import_chunk`` that crashes and is adopted, and CANCEL JOB of both
    feeds. The TTL cutoff is the ship date of lineitem's ``ttl_row``-th
    row in ship-date order. Each step checks its own result; each kernel-1 launch is
    held against the plain version at its slots (on the card), each
    kernel-2 launch at its inputs."""
    import os
    import tempfile

    import numpy as np

    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.jobs import (IMPORT_JOB, ImportResumer,
                                          Registry, synthetic_chunk)
    from cockroach_tpu_torch.jobs.registry import _CrashForTesting
    from cockroach_tpu_torch.models import tpch
    on_card = eng.device.type == "cuda"
    t_phase = time.perf_counter()
    out = {"steps_s": {}}
    checks: dict = {}
    small_checks: list = []
    total = [0, 0]

    def run(label, fn, k1_want, check=None):
        """One statement: both kernels' launches from 0, rows checked."""
        _counts_zero()
        with recording_slots() as calls, recording_small() as scalls:
            t0 = time.perf_counter()
            res = fn()
            _sync()
            dt = time.perf_counter() - t0
        k1, k2 = _kernel_counts(on_card)
        if k1_want is not None and k1 != k1_want:
            raise AssertionError(f"{label}: kernel 1 launched {k1} times, "
                                 f"not {k1_want}")
        if check is not None:
            check(res.rows)
        if on_card and k1:
            checks[f"sf1 {label} phase 16"] = check_calls(
                f"phase 16 {label}", calls, k1)
        if on_card and k2:
            small_checks.extend(_check_small_calls(f"phase 16 {label}",
                                                   scalls, k2))
        total[0] += k1
        total[1] += k2
        out.setdefault("runs", {})[label] = {"ms": dt * 1e3, "kernel1": k1,
                                             "kernel2": k2}
        return res

    def step(name, t0):
        out["steps_s"][name] = time.perf_counter() - t0

    def q1_is(w):
        return lambda rows: check_q1(rows, w)

    def q6_is(w):
        def check(rows):
            if not _close(rows[0][0], w, DECIMAL_REL):
                raise AssertionError(f"Q6 {rows[0][0]} != oracle {w}")
        return check

    with tempfile.TemporaryDirectory(prefix="phase16-") as tmp:
        coll = os.path.join(tmp, "collection")
        sup_path = os.path.join(tmp, "supplier.ndjson")
        li_path = os.path.join(tmp, "lineitem.ndjson")

        # -- 1. feeds -----------------------------------------------------
        t0 = time.perf_counter()
        n_sup = eng.store.table("supplier").row_count
        jid_sup = eng.execute(f"CREATE CHANGEFEED FOR supplier INTO "
                              f"'file://{sup_path}'").rows[0][0]
        rows, _ = _wait_feed(sup_path, lambda r, res: res,
                             "supplier catch-up")
        if len(rows) != n_sup or any(r["after"] is None for r in rows):
            raise AssertionError(f"supplier catch-up: {len(rows)} events, "
                                 f"{n_sup} rows")
        out["supplier_catch_up_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        cursor = eng.clock.now().to_int()
        jid_li = eng.create_changefeed("lineitem", f"file://{li_path}",
                                       cursor=cursor)
        _wait_feed(li_path, lambda r, res: res, "lineitem feed start")
        out["lineitem_feed_start_s"] = time.perf_counter() - t1
        threads = {j: eng._cdc_threads[j][0] for j in (jid_sup, jid_li)}
        declines = eng.metrics.counter("exec.oltp.lane.cdc_declines")
        d0, h0 = declines.value(), eng.lane_hits
        upd = int(li_after["l_orderkey"][-1])
        n_upd = int((li_after["l_orderkey"] == upd).sum())
        t1 = time.perf_counter()
        res = eng.execute("UPDATE lineitem SET l_shipmode = l_shipmode "
                          f"WHERE l_orderkey = {upd}")
        out["lineitem_update_s"] = time.perf_counter() - t1
        if res.row_count != n_upd or declines.value() <= d0 \
                or eng.lane_hits != h0:
            raise AssertionError(
                f"lineitem UPDATE: {res.row_count} rows of {n_upd}, lane "
                f"declines {declines.value() - d0}, lane hits "
                f"{eng.lane_hits - h0}")
        rows, _ = _wait_feed(li_path, lambda r, res: len(r) >= n_upd,
                             "lineitem UPDATE's events")
        if len(rows) != n_upd or any(r["after"]["l_orderkey"] != upd
                                     for r in rows):
            raise AssertionError(f"lineitem feed: {len(rows)} events for "
                                 f"the UPDATE of {n_upd} rows")
        t1 = time.perf_counter()
        eng.execute("UPDATE supplier SET s_acctbal = s_acctbal "
                    "WHERE s_suppkey = 1")
        _wait_feed(sup_path, lambda r, res: len(r) >= n_sup + 1,
                   "supplier UPDATE's event")
        out["supplier_update_s"] = time.perf_counter() - t1
        out["lane_cdc_declines"] = declines.value() - d0
        step("feeds", t0)

        # -- 2. full backup -----------------------------------------------
        t0 = time.perf_counter()
        res = eng.execute(f"BACKUP TABLE lineitem, orders INTO '{coll}'")
        out["full_backup_s"] = time.perf_counter() - t0
        job = eng.execute("SHOW JOBS").rows[-1]
        recs = [r for r in eng.protectedts.records() if r[3] == coll]
        with open(os.path.join(coll, "BACKUP_MANIFEST.json")) as f:
            end0 = json.load(f)["layers"][0]["end_ts"]
        if job[:3] != (res.rows[0][0], "backup", "succeeded") \
                or len(recs) != 1 or recs[0][1] != end0:
            raise AssertionError(f"full BACKUP: job {job}, protection "
                                 f"records {recs}, layer end {end0}")
        out["full_bytes"] = _collection_bytes(coll, 0)
        print(f"phase 16 full BACKUP: {out['full_backup_s']:.2f} s, "
              f"{out['full_bytes']} bytes", flush=True)
        step("full_backup", t0)

        # -- 3. row TTL over l_shipdate -------------------------------------
        t0 = time.perf_counter()
        ship = li_after["l_shipdate"]
        day = int(np.sort(ship)[ttl_row])
        want_del = int((ship <= day).sum())
        if not 1_000 <= want_del <= 20_000:
            raise AssertionError(f"the TTL cutoff deletes {want_del} rows")
        td = eng.store.table("lineitem")
        now_i = eng.clock.now().to_int()
        want_keys = set()
        for c in td.chunks:
            idx = np.flatnonzero(c.live_mask(now_i)
                                 & (c.data["l_shipdate"] <= day))
            want_keys.update(k.hex() for k in eng.store.keys_at(td, c, idx))
        if len(want_keys) != want_del:
            raise AssertionError(f"{len(want_keys)} live lineitem rows at "
                                 f"or before the cutoff, oracle {want_del}")
        n_before = len(_feed_lines(li_path)[0])
        ttl_s = eng.clock.now().wall // 10 ** 9 - (day * 86_400 + 43_200)
        jid = eng.run_ttl("lineitem", "l_shipdate", ttl_s)
        deleted = eng.jobs.job(jid).progress["deleted"]
        if deleted != want_del:
            raise AssertionError(f"TTL deleted {deleted} rows, oracle "
                                 f"{want_del}")
        out["ttl_s"] = time.perf_counter() - t0
        rows, resolved = _wait_feed(
            li_path, lambda r, res: len(r) >= n_before + want_del and res
            and res[-1] >= max(x["updated"] for x in r[n_before:]),
            "TTL deletes")
        gone = rows[n_before:]
        if len(gone) != want_del or any(r["after"] is not None
                                        for r in gone) \
                or {r["key"] for r in gone} != want_keys:
            raise AssertionError(f"the lineitem feed's TTL events: "
                                 f"{len(gone)}, oracle {want_del} keys")
        out["ttl_feed_s"] = time.perf_counter() - t0 - out["ttl_s"]
        kept = ship > day
        li_now = {k: v[kept] for k, v in li_after.items()}
        want_q1, want_q6 = tpch.ref_q1(li_now), tpch.ref_q6(li_now)
        src_rows = run("q1 after ttl", lambda: eng.execute(tpch.Q1), 1,
                       q1_is(want_q1)).rows
        src_q1 = out["runs"]["q1 after ttl"]
        src_q6 = run("q6 after ttl", lambda: eng.execute(tpch.Q6), 0,
                     q6_is(want_q6)).rows
        _counts_zero()
        out["q1_source_ms"] = _median_ms(lambda: eng.execute(tpch.Q1),
                                         reps=3)
        timed, timed2 = _kernel_counts(on_card)
        if timed != 3:
            raise AssertionError(f"3 runs of Q1 launched kernel 1 {timed} "
                                 "times")
        total[0] += timed
        total[1] += timed2
        step("ttl", t0)

        # -- 4. incremental backup ------------------------------------------
        t0 = time.perf_counter()
        eng.execute(f"BACKUP TABLE lineitem, orders INTO '{coll}'")
        out["incremental_backup_s"] = time.perf_counter() - t0
        out["incremental_bytes"] = _collection_bytes(coll, 1)
        recs = [r for r in eng.protectedts.records() if r[3] == coll]
        with open(os.path.join(coll, "BACKUP_MANIFEST.json")) as f:
            end1 = json.load(f)["layers"][1]["end_ts"]
        if len(recs) != 1 or recs[0][1] != end1 or not end1 > end0:
            raise AssertionError(f"incremental BACKUP: protection records "
                                 f"{recs}, layer ends {end0}, {end1}")
        print(f"phase 16 incremental BACKUP: "
              f"{out['incremental_backup_s']:.2f} s, "
              f"{out['incremental_bytes']} bytes against the full layer's "
              f"{out['full_bytes']}", flush=True)
        step("incremental_backup", t0)

        # -- 5. restore into a second engine ----------------------------------
        t0 = time.perf_counter()
        e2 = Engine(device=eng.device)
        e2.execute(f"RESTORE TABLE lineitem, orders FROM '{coll}'")
        out["restore_s"] = time.perf_counter() - t0
        for t in ("lineitem", "orders"):
            a = e2.execute(f"SELECT count(*) FROM {t}").rows
            b = eng.execute(f"SELECT count(*) FROM {t}").rows
            if a != b:
                raise AssertionError(f"restored {t}: {a} rows, source {b}")
        first = run("q1 restored", lambda: e2.execute(tpch.Q1), 1,
                    q1_is(want_q1))
        for r, w in zip(first.rows, src_rows):
            # INT and DECIMAL exact, the FLOAT8 averages within 1e-12
            if r[:6] + r[9:] != w[:6] + w[9:] or any(
                    not _close(a, b, 1e-12) for a, b in zip(r[6:9],
                                                            w[6:9])):
                raise AssertionError(f"restored Q1 {r} != source's {w}")
        out["q1_restored_first_ms"] = out["runs"]["q1 restored"]["ms"]
        out["q1_source_first_ms"] = src_q1["ms"]
        got6 = run("q6 restored", lambda: e2.execute(tpch.Q6), 0,
                   q6_is(want_q6)).rows
        if got6 != src_q6:
            raise AssertionError(f"restored Q6 {got6} != source {src_q6}")
        _counts_zero()
        out["q1_restored_ms"] = _median_ms(lambda: e2.execute(tpch.Q1),
                                           reps=3)
        timed, timed2 = _kernel_counts(on_card)
        if timed != 3:
            raise AssertionError(f"3 runs of restored Q1 launched kernel 1 "
                                 f"{timed} times")
        total[0] += timed
        total[1] += timed2
        td2 = e2.store.table("lineitem")
        top = max(int(c.rowid.max()) for c in td2.chunks if c.n)
        e2.execute("INSERT INTO lineitem VALUES (1, 1, 1, 9, 1.00, 1.00, "
                   "0.00, 0.00, 'N', 'O', '1998-01-01', '1998-01-01', "
                   "'1998-01-01', 'NONE', 'AIR')")
        new_rid = int(e2.store.table("lineitem").chunks[-1].rowid.max())
        if new_rid <= top:
            raise AssertionError(f"the INSERT after RESTORE took rowid "
                                 f"{new_rid}, a restored one reaches {top}")
        out["insert_rowid_past_restored"] = [new_rid, top]
        print(f"phase 16 RESTORE: {out['restore_s']:.2f} s; Q1 restored "
              f"first {out['q1_restored_first_ms']:.2f} ms, warm "
              f"{out['q1_restored_ms']:.2f}; source first "
              f"{out['q1_source_first_ms']:.2f}, warm "
              f"{out['q1_source_ms']:.2f}", flush=True)
        e2.close()
        del e2, td2
        gc.collect()
        if on_card:
            import torch
            torch.cuda.empty_cache()
        step("restore", t0)

        # -- 6. IMPORT, crashed and adopted -----------------------------------
        t0 = time.perf_counter()
        eng.execute(IMPORT_DDL)
        eng.store.set_dictionary("imp", "s", [f"v{i}" for i in range(16)])
        payload = {"table": "imp", "total_rows": import_rows,
                   "chunk_rows": import_chunk, "seed": 16,
                   "columns": IMPORT_COLUMNS}
        reg1 = Registry(eng.kv, session_id="import-1", lease_seconds=0.0)
        reg1.register(IMPORT_JOB, lambda: ImportResumer(
            eng, crash_after_chunk=IMPORT_CRASH))
        jid = reg1.create(IMPORT_JOB, payload)
        try:
            reg1.run_job(jid)
            raise AssertionError("the IMPORT's first session did not crash")
        except _CrashForTesting:
            pass
        reg2 = Registry(eng.kv, session_id="import-2")
        reg2.register(IMPORT_JOB, lambda: ImportResumer(eng))
        rec = reg2.run_job(jid)
        out["import_s"] = time.perf_counter() - t0
        out["import_rows_per_s"] = import_rows / out["import_s"]
        n_chunks = -(-import_rows // import_chunk)
        parts = [synthetic_chunk(16, i, min(import_chunk, import_rows
                                            - i * import_chunk),
                                 IMPORT_COLUMNS) for i in range(n_chunks)]
        a = np.concatenate([p["a"] for p in parts])
        s = np.concatenate([p["s"] for p in parts])
        got = eng.execute("SELECT count(*), sum(a) FROM imp").rows
        if rec.status != "succeeded" or got != [(import_rows,
                                                 int(a.sum()))]:
            raise AssertionError(f"IMPORT: {rec.status}, {got} against "
                                 f"{import_rows} rows, sum {int(a.sum())}")
        cnt = np.bincount(s, minlength=16)
        sums = np.bincount(s, weights=a, minlength=16)
        want_g = sorted((f"v{i}", int(cnt[i]), int(sums[i]))
                        for i in range(16) if cnt[i])

        def group_by_is(rows):
            if [tuple(r) for r in rows] != want_g:
                raise AssertionError(f"IMPORT GROUP BY {rows} != {want_g}")
        run("import group by", lambda: eng.execute(IMPORT_GROUP_BY), None,
            group_by_is)
        out["import_group_by"] = out["runs"]["import group by"]
        print(f"phase 16 IMPORT: {import_rows} rows in "
              f"{out['import_s']:.2f} s; its GROUP BY launched kernel 1 "
              f"{out['import_group_by']['kernel1']} times", flush=True)
        step("import", t0)

        # -- 7. cancel both feeds ---------------------------------------------
        t0 = time.perf_counter()
        for j in (jid_sup, jid_li):
            eng.execute(f"CANCEL JOB {j}")
        for j, th in threads.items():
            th.join(timeout=FEED_TIMEOUT)
            if th.is_alive() or eng.jobs.job(j).status != "canceled":
                raise AssertionError(f"changefeed {j}: thread alive "
                                     f"{th.is_alive()}, job "
                                     f"{eng.jobs.job(j).status}")
        sup_rows, sup_res = _feed_lines(sup_path)
        li_rows, li_res = _feed_lines(li_path)
        if len(sup_rows) != n_sup + 1 or sup_res != sorted(sup_res) \
                or li_res != sorted(li_res):
            raise AssertionError(f"supplier sink: {len(sup_rows)} events "
                                 f"for {n_sup} rows and one UPDATE; "
                                 "resolved timestamps monotone: "
                                 f"{sup_res == sorted(sup_res)}, "
                                 f"{li_res == sorted(li_res)}")
        out["feed_events"] = {"supplier": len(sup_rows),
                              "supplier_resolved": len(sup_res),
                              "lineitem": len(li_rows),
                              "lineitem_resolved": len(li_res)}
        out["jobs"] = eng.execute("SHOW JOBS").rows[-8:]
        step("cancel", t0)
    out["rows_deleted"] = deleted
    out["launches"] = {"groupagg_large": total[0], "groupagg": total[1]}
    out["path_checks"] = checks
    out["small_checks"] = small_checks
    out["seconds"] = time.perf_counter() - t_phase
    return out


def jobs_phase_alone(sf: float = SF, device=None, rows=None) -> dict:
    """Phase 16 by itself: loads lineitem, orders and supplier at `sf`,
    runs jobs_phase and prints its line (``python3 -c "import chip_smoke;
    chip_smoke.jobs_phase_alone()"``; on the CPU
    ``jobs_phase_alone(0.01, "cpu", rows=20000)``)."""
    import numpy as np

    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    smi = _smi() if device is None else "cpu"
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    eng = Engine(device=device)
    tpch.load(eng, sf=sf, rows=rows, tables=("lineitem",), encoded=True)
    tpch.load(eng, sf=sf, tables=("orders", "supplier"))
    li = tpch.gen_lineitem(sf, rows=rows, encoded=True)
    li["l_returnflag"] = np.asarray(tpch.RF_VALUES)[li["l_returnflag"]]
    li["l_linestatus"] = np.asarray(tpch.LS_VALUES)[li["l_linestatus"]]
    print(f"load SF{sf}: {time.perf_counter() - t0:.1f} s", flush=True)
    # the IMPORT and the TTL cutoff scale with sf below SF1
    scale = min(sf, 1.0)
    out = jobs_phase(eng, li, sf, import_rows=int(IMPORT_ROWS * scale),
                     import_chunk=int(IMPORT_CHUNK * scale),
                     ttl_row=max(1_000, int(TTL_ROW * scale)))
    print(f"phase 16: {out['seconds']:.1f} s", flush=True)
    print(json.dumps({"jobs": dict(out, card=smi)}), flush=True)
    return out


class _YcsbFront:
    """The YCSB client's engine: times each statement by operation kind
    and logs every scan's rows and every insert. ``check`` replays the
    log against a sorted-keys oracle after the run, so the oracle's work
    stays out of the timed operations."""

    def __init__(self, eng, records: int):
        self.eng = eng
        self.records = records
        self.log = []           # (sql, rows of a scan | None)
        self.lat = {"scan": [], "insert": []}
        self.loading = True     # setup's INSERTs are the records below

    def execute(self, sql, session=None):
        t0 = time.perf_counter()
        res = self.eng.execute(sql, session)
        dt = time.perf_counter() - t0
        if sql.startswith("SELECT ycsb_key, field0"):
            self.log.append((sql, res.rows))
            self.lat["scan"].append(dt)
        elif sql.startswith("INSERT") and not self.loading:
            self.log.append((sql, None))
            self.lat["insert"].append(dt)
        return res

    def check(self) -> tuple:
        """Replay the log: every scan's rows equal the oracle's at that
        point. Returns the oracle's (sorted keys, values by key)."""
        import bisect
        values = {i: (i * 7 % 1000, i * 13 % 1000)
                  for i in range(self.records)}
        keys = list(range(self.records))    # ascending
        for sql, rows in self.log:
            if rows is None:
                k = int(sql.split("(")[1].split(",")[0])
                values[k] = (0, 0)
                bisect.insort(keys, k)
                continue
            k = int(sql.split(">=")[1].split()[0])
            lim = int(sql.rsplit("LIMIT", 1)[1])
            i = bisect.bisect_left(keys, k)
            want = [(x, values[x][0]) for x in keys[i:i + lim]]
            if rows != want:
                raise AssertionError(f"YCSB scan at {k}: {rows} != {want}")
        return keys, values


FASTPATH_SAMPLE = 300          # YCSB-E scans re-run inside a txn


def _fastpath_sample(eng, log, keys, values) -> dict:
    """The primary-key range fastpath on the card: a sample of YCSB-E's
    scans (every n-th) inside BEGIN/COMMIT, where the lane stays out.
    Each must go through the fastpath once and equal the oracle's final
    state (``keys`` sorted, ``values`` by key)."""
    import bisect
    fast = eng.metrics.counter("sql.select.range_fastpath")
    scans = [sql for sql, rows in log if rows is not None]
    sample = scans[::max(1, len(scans) // FASTPATH_SAMPLE)][
        :FASTPATH_SAMPLE]
    s = eng.session()
    lat = []
    for sql in sample:
        n0 = fast.value()
        t0 = time.perf_counter()
        eng.execute("BEGIN", s)
        rows = eng.execute(sql, s).rows
        eng.execute("COMMIT", s)
        lat.append(time.perf_counter() - t0)
        if fast.value() != n0 + 1:
            raise AssertionError(f"{sql!r} in a txn did not go through "
                                 "the range fastpath once")
        k = int(sql.split(">=")[1].split()[0])
        lim = int(sql.rsplit("LIMIT", 1)[1])
        i = bisect.bisect_left(keys, k)
        want = [(x, values[x][0]) for x in keys[i:i + lim]]
        if rows != want:
            raise AssertionError(f"fastpath scan at {k}: {rows} != {want}")
    lat.sort()
    return {"scans": len(sample),
            "txn_p50_ms": lat[len(lat) // 2] * 1e3 if lat else None,
            "txn_p99_ms": (lat[min(len(lat) - 1, int(len(lat) * 0.99))]
                           * 1e3 if lat else None)}


def ycsb_phase(eng, records: int, ops: int, seed: int = 1) -> dict:
    """Phase 11c: YCSB-E (95% scans of 10, 5% inserts, zipfian keys,
    every statement served by the OLTP lane) over `records` rows loaded
    by the workload's own INSERT statements, then a sample of its scans
    through the range fastpath (_fastpath_sample)."""
    from cockroach_tpu_torch.workload.ycsb import YCSB
    front = _YcsbFront(eng, records)
    y = YCSB(front, "E", records=records, seed=seed)
    t0 = time.perf_counter()
    y.setup()
    load_s = time.perf_counter() - t0
    front.loading = False
    hits = eng.lane_hits
    res = y.run(ops)
    if len(front.lat["scan"]) != y.ops["scan"] or \
            eng.lane_hits - hits != ops:
        raise AssertionError("a YCSB-E statement left the OLTP lane")
    keys, values = front.check()
    fastpath = _fastpath_sample(eng, front.log, keys, values)
    want = (len(keys), sum(v[0] for v in values.values()),
            sum(v[1] for v in values.values()))
    got = eng.execute("SELECT count(*), sum(field0), sum(field1) "
                      "FROM usertable").rows[0]
    if tuple(got) != want:
        raise AssertionError(f"usertable {got} != oracle {want}")

    def pct(xs, p):
        xs = sorted(xs)
        return xs[min(len(xs) - 1, int(len(xs) * p))] * 1e3 if xs else None
    out = {"records": records, "ops": ops, "load_s": load_s,
           "ops_per_s": res["ops_per_sec"], "mix": res["ops"],
           "final_rows": want[0], "fastpath": fastpath}
    for kind, xs in front.lat.items():
        out[f"{kind}_p50_ms"] = pct(xs, 0.5)
        out[f"{kind}_p99_ms"] = pct(xs, 0.99)
    print("ycsb-e: " + json.dumps(out), flush=True)
    return out


def dml_phase(eng, li, part, sf, ycsb_records: int = 100_000,
              ycsb_ops: int = 10_000, reps: int = 3) -> dict:
    """Phase 11 on a loaded engine (every TPC-H table at `sf`, lineitem
    from `li`): windows over orders, TPC-H's refresh pair with Q1, Q6,
    Q14 and Q3 after it, and YCSB-E. Runs last among the SF1 phases: it
    changes the tables."""
    import torch

    from cockroach_tpu_torch.models import tpch
    on_card = eng.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    orders, cust = tpch.gen_orders(sf), tpch.gen_customer(sf)
    t0 = time.perf_counter()
    windows = window_phase(eng, orders, reps=reps)
    win_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    refresh = refresh_phase(eng, li, part, orders, cust, sf, reps=reps)
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ycsb = ycsb_phase(eng, ycsb_records, ycsb_ops)
    out = {"windows": windows, "refresh": refresh, "ycsb_e": ycsb,
           "seconds": {"windows": win_s, "refresh": ref_s,
                       "ycsb_e": time.perf_counter() - t0}}
    if on_card:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


def dml_phase_alone(sf: float = SF, ycsb_records: int = 100_000,
                    ycsb_ops: int = 10_000) -> dict:
    """Phase 11 by itself: loads every TPC-H table at `sf` on the card
    as phases 2 and 6 do, then runs dml_phase and prints its line
    (``python3 -c "import chip_smoke; chip_smoke.dml_phase_alone()"``).
    On the card its Q1 call is held against the plain version too."""
    import numpy as np

    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    smi = _smi()
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    eng = Engine()
    tpch.load(eng, sf=sf, tables=("lineitem", "part"), encoded=True)
    tpch.load(eng, sf=sf, tables=("orders", "customer", "supplier",
                                  "partsupp", "nation", "region"))
    li = tpch.gen_lineitem(sf, encoded=True)
    li["l_returnflag"] = np.asarray(tpch.RF_VALUES)[li["l_returnflag"]]
    li["l_linestatus"] = np.asarray(tpch.LS_VALUES)[li["l_linestatus"]]
    li["l_shipmode"] = np.asarray(tpch.SHIPMODES, dtype=object)[
        li["l_shipmode"]]
    print(f"load SF{sf}: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    out = dml_phase(eng, li, tpch.gen_part(sf), sf, ycsb_records,
                    ycsb_ops)
    out["refresh"].pop("li_after")
    out["refresh"].pop("orders_after")
    print(f"phase 11: {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({"dml": dict(out, card=smi)}), flush=True)
    return out


def oltp_phase_alone(sf: float = SF, **kw) -> dict:
    """Phase 12 by itself: loads lineitem and supplier at `sf` on the
    card, builds the kernels, runs oltp_phase over the unchanged
    lineitem and prints its line (``python3 -c "import chip_smoke;
    chip_smoke.oltp_phase_alone()"``); `kw` goes to oltp_phase."""
    import numpy as np

    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import build
    smi = _smi()
    print(f"card: {smi}", flush=True)
    build.compile_all(["groupagg_large", "groupagg"])
    t0 = time.perf_counter()
    eng = Engine()
    tpch.load(eng, sf=sf, tables=("lineitem", "supplier"), encoded=True)
    li = tpch.gen_lineitem(sf, encoded=True)
    li["l_returnflag"] = np.asarray(tpch.RF_VALUES)[li["l_returnflag"]]
    li["l_linestatus"] = np.asarray(tpch.LS_VALUES)[li["l_linestatus"]]
    eng.execute(USERTABLE_DDL)       # phase 11's table, which 12 drops
    print(f"load SF{sf}: {time.perf_counter() - t0:.1f} s", flush=True)
    out = oltp_phase(eng, li, tpch.gen_supplier(sf), **kw)
    out.pop("path_checks")
    print(f"phase 12: {out['seconds']:.1f} s", flush=True)
    print(json.dumps({"oltp": dict(out, card=smi)}), flush=True)
    return out


def frontdoor_phase_alone(sf: float = SF, records: int = 1_000_000,
                          **kw) -> dict:
    """Phase 13 by itself: builds the kernels, loads lineitem, part,
    orders and customer at `sf` and a bulk-loaded usertable of
    `records` keys on the card, runs frontdoor_phase and the entry
    points and prints the `frontdoor` line (``python3 -c "import
    chip_smoke; chip_smoke.frontdoor_phase_alone()"``); `kw` goes to
    frontdoor_phase."""
    import numpy as np

    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import build
    smi = _smi()
    print(f"card: {smi}", flush=True)
    build.compile_all(["groupagg_large", "groupagg"])
    t0 = time.perf_counter()
    eng = Engine()
    tpch.load(eng, sf=sf, tables=("lineitem", "part"), encoded=True)
    tpch.load(eng, sf=sf, tables=("orders", "customer"))
    li = tpch.gen_lineitem(sf, encoded=True)
    li["l_returnflag"] = np.asarray(tpch.RF_VALUES)[li["l_returnflag"]]
    li["l_linestatus"] = np.asarray(tpch.LS_VALUES)[li["l_linestatus"]]
    li["l_shipmode"] = np.asarray(tpch.SHIPMODES, dtype=object)[
        li["l_shipmode"]]
    eng.execute(USERTABLE_DDL)
    i = np.arange(records, dtype=np.int64)
    eng.store.insert_columns("usertable", {
        "ycsb_key": i, "field0": i * 7 % 1000, "field1": i * 13 % 1000},
        eng.clock.now())
    print(f"load SF{sf}: {time.perf_counter() - t0:.1f} s", flush=True)
    out = frontdoor_phase(eng, li, tpch.gen_orders(sf),
                          tpch.gen_customer(sf), tpch.gen_part(sf),
                          records, **kw)
    out["entry_points"] = entry_points_phase()
    out.pop("path_checks")
    out.pop("small_checks")
    out["entry_points"].pop("node_checks")
    print(f"phase 13: {out['seconds']:.1f} s", flush=True)
    print(json.dumps({"frontdoor": dict(out, card=smi)}), flush=True)
    return out


# -- 12. the OLTP lane beside the card ---------------------------------------
OLTP_RECORDS = 1_000_000        # usertable rows, bulk-ingested
# phase 12's depth, cut to leave phase 13 its time (20,000 and 32,000
# before it)
OLTP_OPS = 5_000                # operations per single-session mix
OLTP_CONC_OPS = 8_000           # operations per concurrent run
OLTP_WORKERS = 16
OLTP_GROUP_BY = ("SELECT field0, count(*), sum(field1), min(field1), "
                 "max(field1) FROM usertable GROUP BY field0")
USERTABLE_DDL = ("CREATE TABLE usertable (ycsb_key INT8 NOT NULL PRIMARY "
                 "KEY, field0 INT8, field1 INT8)")


class _LaneFront:
    """The YCSB client's engine for phase 12: logs every statement with
    its rows (reads and scans) so the oracle replay runs after the timed
    operations, and counts the statements."""

    def __init__(self, eng):
        self.eng = eng
        self.log = []

    def execute(self, sql, session=None):
        res = self.eng.execute(sql, session)
        self.log.append((sql, res.rows))
        return res


class _UsertableOracle:
    """usertable as the workload's statements leave it: field values by
    key, the keys in order (for scans), replayed from statement logs."""

    def __init__(self, records: int):
        import numpy as np
        i = np.arange(records, dtype=np.int64)
        self.f0 = dict(zip(range(records), (i * 7 % 1000).tolist()))
        self.f1 = dict(zip(range(records), (i * 13 % 1000).tolist()))
        self.keys = list(range(records))

    def replay(self, label, log, check: bool) -> int:
        """Apply a log in order; with ``check`` every read and scan must
        equal the oracle at that point. Returns the statements checked."""
        import bisect
        checked = 0
        for sql, rows in log:
            if sql.startswith("UPDATE"):
                v = int(sql.split("field0 = ")[1].split()[0])
                self.f0[int(sql.rsplit("= ", 1)[1])] = v
            elif sql.startswith("INSERT"):
                k = int(sql.split("(")[1].split(",")[0])
                self.f0[k], self.f1[k] = 0, 0
                bisect.insort(self.keys, k)
            elif not check:
                continue
            elif sql.startswith("SELECT ycsb_key, field0"):
                k = int(sql.split(">=")[1].split()[0])
                lim = int(sql.rsplit("LIMIT", 1)[1])
                i = bisect.bisect_left(self.keys, k)
                want = [(x, self.f0[x]) for x in self.keys[i:i + lim]]
                if rows != want:
                    raise AssertionError(f"{label} scan at {k}: {rows} != "
                                         f"{want}")
                checked += 1
            else:
                k = int(sql.rsplit("= ", 1)[1])
                if sql.startswith("SELECT field0, field1"):
                    want = [(self.f0[k], self.f1[k])] if k in self.f0 else []
                else:
                    want = [(self.f0[k],)] if k in self.f0 else []
                if rows != want:
                    raise AssertionError(f"{label} read of {k}: {rows} != "
                                         f"{want}")
                checked += 1
        return checked


def _tscache_cost(eng, n: int = 20_000) -> dict:
    """The timestamp cache after the lane's runs: its point and span
    entries, and the microseconds of one add of a point read's span and
    of a range scan's (each lane read adds one)."""
    from cockroach_tpu_torch.kv.concurrency import Span
    tsc = eng.kv.store.tscache
    codec = eng.store.table("usertable").codec
    out = {"points": len(tsc._points), "spans": len(tsc._spans)}
    keys = [codec.key_from_pk((k,)) for k in range(n)]
    ts = eng.clock.now()
    t0 = time.perf_counter()
    for kb in keys:
        tsc.add(Span(kb), ts, None)
    out["point_add_us"] = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for kb in keys:
        tsc.add(Span(kb, kb + b"\xff"), ts, None)
    out["span_add_us"] = (time.perf_counter() - t0) / n * 1e6
    return out


def _lane_counts(eng) -> dict:
    snap = eng.metrics.snapshot()
    out = {k: snap.get(k, 0) for k in (
        "exec.oltp.lane.hits", "exec.oltp.lane.fallbacks",
        "exec.oltp.lane.flushes", "exec.oltp.lane.published_ops",
        "exec.oltp.batch.windows", "exec.oltp.batch.fused",
        "kv.groupcommit.proposals", "kv.groupcommit.commands")}
    wait = snap.get("exec.oltp.batch.flush_wait_seconds") or {}
    out["flush_wait_count"] = wait.get("count", 0)
    out["flush_wait_s"] = wait.get("sum", 0.0)
    return out


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def _group_by_oracle(rows) -> list:
    """The usertable GROUP BY from full-path rows, by numpy."""
    import numpy as np
    a = np.asarray([r[1:] for r in rows], dtype=np.int64)
    keys, inv = np.unique(a[:, 0], return_inverse=True)
    cnt = np.bincount(inv)
    sums = np.bincount(inv, weights=a[:, 1].astype(np.float64))
    mins = np.full(len(keys), np.iinfo(np.int64).max)
    maxs = np.full(len(keys), np.iinfo(np.int64).min)
    np.minimum.at(mins, inv, a[:, 1])
    np.maximum.at(maxs, inv, a[:, 1])
    return sorted(zip(keys.tolist(), cnt.tolist(),
                      sums.astype(np.int64).tolist(), mins.tolist(),
                      maxs.tolist()))


def _lane_group_by(eng, on_card: bool, label: str) -> tuple:
    """The usertable GROUP BY with its route: kernel-1 launches (held
    against the plain version at their slots on the card), exec-cache
    misses, the lane flushes it made and whether it uploaded usertable.

    It runs under `auto` where the card's parity gate promoted
    int_minmax (ops/cuda/paritygate.py), else under SET pallas_groupagg
    = on: its INT MIN/MAX take kernel 1 only there. The same statement
    under `off` (no kernel) must give the same rows."""
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    from cockroach_tpu_torch.ops.cuda import paritygate
    s_on = eng.session()
    exact = paritygate.promoted(eng._device_key, eng._compile_cache_dir,
                                eng.device, engine_point(eng.device))
    s_on.vars.set("pallas_groupagg",
                  "auto" if "int_minmax" in exact else "on")
    c0, miss0 = _lane_counts(eng), eng.plan_cache["miss"]
    hit0 = eng.plan_cache["hit"]
    chunks0 = len(eng.store.table("usertable").chunks)
    resident0 = {k for k in eng._device_tables if k[0] == "usertable"}
    _counts_zero()
    t0 = time.perf_counter()
    with recording_slots() as calls:
        res = eng.execute(OLTP_GROUP_BY, s_on)
        _sync()
    route = {"s": time.perf_counter() - t0,
             "groupagg_large": tgl.LAUNCHES if on_card else tgl.PLAIN_CALLS,
             "exec_cache_misses": eng.plan_cache["miss"] - miss0,
             "exec_cache_hits": eng.plan_cache["hit"] - hit0,
             "flushes": _delta(c0, _lane_counts(eng))[
                 "exec.oltp.lane.flushes"],
             "chunks_added": len(eng.store.table("usertable").chunks)
             - chunks0,
             "uploaded": bool({k for k in eng._device_tables
                               if k[0] == "usertable"} - resident0),
             "groups": len(res.rows)}
    if route["groupagg_large"] != 1:
        raise AssertionError(f"{label}: the usertable GROUP BY launched "
                             f"kernel 1 {route['groupagg_large']} times")
    if on_card:
        route["kernel_checks"] = check_calls(label, calls, 1)
    s_off = eng.session()
    s_off.vars.set("pallas_groupagg", "off")
    if sorted(eng.execute(OLTP_GROUP_BY, s_off).rows) != sorted(res.rows):
        raise AssertionError(f"{label}: off's rows != the kernel's")
    route["mode"] = s_on.vars.get("pallas_groupagg")
    print(f"{label} route: " + json.dumps(
        {k: v for k, v in route.items() if k != "kernel_checks"}),
        flush=True)
    return sorted(res.rows), route


def _concurrent(eng, workload, mode, records, ops, workers, insert_base,
                beside=None) -> tuple:
    """One run_concurrent with its counters; ``beside`` runs in a thread
    of its own while the drivers run."""
    import threading

    from cockroach_tpu_torch.workload.ycsb import YCSB
    y = YCSB(eng, workload, records=records, seed=1)
    c0 = _lane_counts(eng)
    result = {}
    th = None
    if beside is not None:
        th = threading.Thread(target=lambda: result.update(beside()),
                              daemon=True)
    res = {}

    def drive():
        res.update(y.run_concurrent(ops, workers=workers,
                                    session_vars={"oltp_batch": mode},
                                    record_latency=True, timeout=600.0,
                                    insert_base=insert_base))
    dth = threading.Thread(target=drive, daemon=True)
    dth.start()
    if th is not None:
        # start beside the drivers once all of them are issuing
        # statements (each builds its zipfian sampler first)
        h0 = eng.lane_hits
        deadline = time.perf_counter() + 120.0
        while eng.lane_hits - h0 < 8 * workers and dth.is_alive() and \
                time.perf_counter() < deadline:
            time.sleep(0.001)
        th.start()
        th.join(600.0)
        if th.is_alive() or "error" in result:
            raise AssertionError(f"the statement beside the lane failed: "
                                 f"{result.get('error')}")
    dth.join(660.0)
    if dth.is_alive() or not res:
        raise AssertionError(f"YCSB-{workload} at {workers} workers did "
                             "not finish")
    d = _delta(c0, _lane_counts(eng))
    stmts = sum(len(dr.latencies) + dr.ops["rmw"] for dr in y.drivers)
    out = {"ops_per_s": res["ops_per_sec"], "seconds": res["seconds"],
           "p50_ms": res["p50_ms"], "p99_ms": res["p99_ms"],
           "retries": res["retries"], "mix": res["ops"],
           "by_op": {op: res[op] for op in res["ops"] if op in res},
           "lane_hits": d["exec.oltp.lane.hits"], "statements": stmts,
           "fallbacks": d["exec.oltp.lane.fallbacks"],
           "batch_windows": d["exec.oltp.batch.windows"],
           "batch_fused": d["exec.oltp.batch.fused"],
           "batch_size_p50": eng.metrics.snapshot()[
               "exec.oltp.batch.size_p50"],
           "flush_wait_mean_ms": (d["flush_wait_s"] / d["flush_wait_count"]
                                  * 1e3 if d["flush_wait_count"] else 0.0),
           "groupcommit_proposals": d["kv.groupcommit.proposals"],
           "groupcommit_commands": d["kv.groupcommit.commands"]}
    if mode == "off" and out["batch_windows"]:
        raise AssertionError("oltp_batch = off went through batch windows")
    if out["lane_hits"] + out["fallbacks"] != stmts:
        raise AssertionError(f"{workload} {mode}: {stmts} statements, "
                             f"{out['lane_hits']} lane hits, "
                             f"{out['fallbacks']} fallbacks")
    return out, y.drivers, result


def oltp_phase(eng, li_after, supplier, records: int = OLTP_RECORDS,
               ops: int = OLTP_OPS, conc_ops: int = OLTP_CONC_OPS,
               workers: int = OLTP_WORKERS, q1_runs: int = 5) -> dict:
    """Phase 12 on the SF1 engine after phase 11 (lineitem and supplier
    resident; ``li_after``: lineitem's arrays as phase 11 left them,
    strings decoded): the OLTP lane over a bulk-loaded usertable,
    single-session and concurrent YCSB, Q1 beside the lane, the lane's
    writes handed to kernel 1, Q15 through a view and a DEFAULT nextval
    column. Returns the phase's numbers (the `oltp` line)."""
    import numpy as np

    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    from cockroach_tpu_torch.workload.ycsb import MIXES, YCSB
    on_card = eng.device.type == "cuda"
    t_phase = time.perf_counter()
    out = {"records": records, "ops": ops, "conc_ops": conc_ops,
           "workers": workers}
    # setup: phase 11's usertable goes; 1,000,000 records through the
    # store's ingest path, as the TPC-H tables are loaded
    eng.execute("DROP TABLE usertable")
    eng.execute(USERTABLE_DDL)
    t0 = time.perf_counter()
    i = np.arange(records, dtype=np.int64)
    eng.store.insert_columns("usertable", {
        "ycsb_key": i, "field0": i * 7 % 1000, "field1": i * 13 % 1000},
        eng.clock.now())
    out["load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng._lane_mirror("usertable")
    out["mirror_rebuild_s"] = time.perf_counter() - t0
    chunks0 = len(eng.store.table("usertable").chunks)
    c_start = _lane_counts(eng)
    oracle = _UsertableOracle(records)

    # single-session mixes, zipfian, seed 1, scans of 10
    single, logs = {}, {}
    insert_base = {"D": records, "E": records + 500_000}
    for w in sorted(MIXES):
        front = _LaneFront(eng)
        y = YCSB(front, w, records=records, seed=1, record_latency=True)
        y.next_key = insert_base.get(w, records)
        c0 = _lane_counts(eng)
        res = y.run(ops)
        d = _delta(c0, _lane_counts(eng))
        if d["exec.oltp.lane.hits"] != len(front.log):
            raise AssertionError(f"YCSB-{w}: {len(front.log)} statements, "
                                 f"{d['exec.oltp.lane.hits']} served by the "
                                 "lane")
        lat = {}
        for op, xs in y.op_latencies.items():
            if xs:
                xs = sorted(xs)
                lat[op] = {"p50_ms": xs[len(xs) // 2] * 1e3,
                           "p99_ms": xs[min(len(xs) - 1,
                                            int(len(xs) * 0.99))] * 1e3}
        single[w] = {"ops_per_s": res["ops_per_sec"],
                     "seconds": res["seconds"], "mix": res["ops"],
                     "by_op": lat, "statements": len(front.log),
                     "lane_hits": d["exec.oltp.lane.hits"],
                     "lane_misses": eng.lane_misses,
                     "groupcommit_proposals": d["kv.groupcommit.proposals"]}
        logs[w] = front.log
        print(f"ycsb-{w} single session: " + json.dumps(single[w]),
              flush=True)
    out["single"] = single
    # the replay, after the timed runs: every read and scan of A and E
    # against the oracle at its point (the other mixes' writes applied)
    t0 = time.perf_counter()
    out["replayed"] = {w: oracle.replay(f"YCSB-{w}", logs[w],
                                        check=w in ("A", "E"))
                       for w in sorted(MIXES)}
    out["replay_s"] = time.perf_counter() - t0
    del logs
    pending = len(eng._lane_pending.get("usertable", ()))
    got, out["group_by_single"] = _lane_group_by(eng, on_card,
                                                 "usertable GROUP BY single")
    if got != _group_by_oracle([(k, oracle.f0[k], oracle.f1[k])
                                for k in oracle.keys]):
        raise AssertionError("the usertable GROUP BY after the single-"
                             "session mixes != the oracle")
    out["group_by_single"]["pending_published"] = pending

    # concurrent: A and E at 16 workers, oltp_batch auto then off
    conc, drivers = {}, []
    bases = iter(range(records + 1_000_000, records + 9_000_000, 1_000_000))
    for w in ("A", "E"):
        for mode in ("auto", "off"):
            r, ds, _ = _concurrent(eng, w, mode, records, conc_ops, workers,
                                   next(bases))
            drivers += ds
            conc[f"{w}_{mode}"] = r
            print(f"ycsb-{w} {workers} workers oltp_batch={mode}: "
                  + json.dumps(r), flush=True)
    out["concurrent"] = conc

    # Q1 in a thread of its own while YCSB-A runs at 16 workers
    want_q1 = tpch.ref_q1(li_after)

    def q1_beside():
        import torch
        runs = []
        try:
            if on_card:
                torch.cuda.set_device(eng.device)
            for _ in range(q1_runs):
                h0 = eng.lane_hits
                k0 = tgl.LAUNCHES if on_card else tgl.PLAIN_CALLS
                t1, c1 = time.perf_counter(), time.thread_time()
                with recording_slots() as calls:
                    res = eng.execute(tpch.Q1)
                    _sync()
                k1 = (tgl.LAUNCHES if on_card else tgl.PLAIN_CALLS) - k0
                # the scope's waits (fence, flush, gate) and this
                # thread's CPU seconds: the rest of "s" is spent waiting
                # inside the statement (the interpreter lock, the card)
                run = {"s": time.perf_counter() - t1, "groupagg_large": k1,
                       "lane_hits_during": eng.lane_hits - h0,
                       "thread_cpu_s": time.thread_time() - c1,
                       **eng.last_exec["waits"]}
                check_q1(res.rows, want_q1)
                if k1 != 1:
                    raise AssertionError(f"Q1 beside the lane launched "
                                         f"kernel 1 {k1} times")
                if on_card:
                    run["kernel_checks"] = check_calls(
                        "sf1 q1 beside the lane", calls, k1)
                runs.append(run)
        except BaseException as e:
            return {"error": repr(e), "runs": runs}
        return {"runs": runs}

    r, ds, q1 = _concurrent(eng, "A", "auto", records, conc_ops, workers,
                            next(bases), beside=q1_beside)
    drivers += ds
    if r["fallbacks"]:
        raise AssertionError(f"{r['fallbacks']} lane writes took the full "
                             "path beside Q1")
    if not sum(x["lane_hits_during"] for x in q1["runs"]):
        raise AssertionError("no lane statement completed while Q1 ran")
    out["beside_q1"] = {"ycsb_a": r, "q1": q1["runs"]}
    print("ycsb-A beside Q1: " + json.dumps(out["beside_q1"]), flush=True)

    # the lane hands over to the card: the GROUP BY flushes the queue,
    # misses the exec cache, uploads usertable again and runs kernel 1
    pending = len(eng._lane_pending.get("usertable", ()))
    if not pending:
        raise AssertionError("the concurrent runs left nothing queued")
    got, route = _lane_group_by(eng, on_card, "usertable GROUP BY")
    route["pending_published"] = pending
    if route["exec_cache_misses"] < 1 or route["flushes"] != 1 or \
            route["chunks_added"] != 1 or not route["uploaded"]:
        raise AssertionError(f"the GROUP BY after the lane's writes: "
                             f"{route}")
    # the full path's rows: the concurrent invariants and the GROUP BY's
    # numpy oracle
    t0 = time.perf_counter()
    rows = eng.execute("SELECT ycsb_key, field0, field1 FROM usertable"
                       ).rows
    out["full_read_s"] = time.perf_counter() - t0
    written: dict = {}
    inserted = set()
    for dr in drivers:
        for k, v in dr.writes:
            written.setdefault(k, set()).add(v)
            if k >= records + 1_000_000:
                inserted.add(k)
    want_n = len(oracle.keys) + len(inserted)
    if len(rows) != want_n:
        raise AssertionError(f"usertable has {len(rows)} rows, not {want_n}")
    bad = [(k, f0) for k, f0, f1 in rows
           if not (f0 == oracle.f0.get(k) or f0 in written.get(k, ()))
           or f1 != oracle.f1.get(k, 0)]
    if bad:
        raise AssertionError(f"keys off their written values: {bad[:5]}")
    agg = eng.execute("SELECT count(*), sum(field1) FROM usertable").rows[0]
    if tuple(agg) != (want_n, sum(oracle.f1.values())):
        raise AssertionError(f"count/sum(field1) {agg} != "
                             f"{(want_n, sum(oracle.f1.values()))}")
    if got != _group_by_oracle(rows):
        raise AssertionError("the usertable GROUP BY != numpy over the full "
                             "path's rows")
    got2, again = _lane_group_by(eng, on_card, "usertable GROUP BY again")
    if got2 != got or again["exec_cache_misses"] or \
            not again["exec_cache_hits"] or again["flushes"] or \
            again["uploaded"]:
        raise AssertionError(f"the second GROUP BY missed or differed: "
                             f"{again}")
    route["second_run"] = again
    out["group_by"] = route
    del rows

    # Q15 through a view, as the TPC-H specification writes it
    create, query, drop = tpch.Q15_VIEW
    eng.execute(create)
    _counts_zero()
    t0 = time.perf_counter()
    with recording_slots() as calls:
        res = eng.execute(query)
        _sync()
    q15 = {"s": time.perf_counter() - t0,
           "groupagg_large": tgl.LAUNCHES if on_card else tgl.PLAIN_CALLS,
           "temps": len(eng.last_exec["temps"])}
    eng.execute(drop)
    check_result("Q15 view", res, tpch.oracle_rows(
        "q15", {"lineitem": li_after, "supplier": supplier}))
    if q15["groupagg_large"] != SF1_PHASE7_LAUNCHES["q15"] or \
            q15["temps"] != 1:
        raise AssertionError(f"Q15's view form: {q15}")
    if on_card:
        q15["kernel_checks"] = check_calls("sf1 q15 view", calls, 1)
    out["q15_view"] = q15

    # a DEFAULT nextval column over INSERT ... SELECT of 10,000 rows
    eng.execute("CREATE SEQUENCE useq")
    eng.execute("CREATE TABLE seqt (k INT8 PRIMARY KEY DEFAULT "
                "nextval('useq'), v INT8)")
    s = eng.session()
    eng.execute("BEGIN", s)
    rolled = eng.execute("SELECT nextval('useq')", s).rows[0][0]
    eng.execute("ROLLBACK", s)
    seq_n = min(10_000, records)
    t0 = time.perf_counter()
    n = eng.execute("INSERT INTO seqt (v) SELECT ycsb_key FROM usertable "
                    f"WHERE ycsb_key < {seq_n}").row_count
    seq_s = time.perf_counter() - t0
    keys = sorted(r[0] for r in eng.execute("SELECT k FROM seqt").rows)
    if n != seq_n or keys != list(range(rolled + 1, rolled + 1 + n)):
        raise AssertionError(f"nextval keys: {n} rows, {keys[:3]} ... "
                             f"{keys[-3:]}, rolled back {rolled}")
    out["sequence"] = {"rows": n, "s": seq_s, "rolled_back": rolled,
                       "first": keys[0], "last": keys[-1]}
    eng.execute("DROP TABLE seqt")
    eng.execute("DROP SEQUENCE useq")

    out["tscache"] = _tscache_cost(eng)
    c_end = _lane_counts(eng)
    d = _delta(c_start, c_end)
    out["chunks"] = {"before": chunks0,
                     "after": len(eng.store.table("usertable").chunks),
                     "flushes": d["exec.oltp.lane.flushes"],
                     "published_ops": d["exec.oltp.lane.published_ops"]}
    if out["chunks"]["after"] - chunks0 != out["chunks"]["flushes"]:
        raise AssertionError(f"usertable chunks {out['chunks']}: not one "
                             "chunk per flush")
    out["kernel1_launches"] = {
        "group_by_single": out["group_by_single"]["groupagg_large"],
        "group_by": route["groupagg_large"],
        "group_by_again": again["groupagg_large"],
        "q1_beside": sum(x["groupagg_large"] for x in q1["runs"]),
        "q15_view": q15["groupagg_large"]}
    out["path_checks"] = {} if not on_card else {
        "sf1 usertable group by single phase 12":
            out["group_by_single"].pop("kernel_checks"),
        "sf1 usertable group by phase 12": route.pop("kernel_checks"),
        "sf1 usertable group by again phase 12":
            again.pop("kernel_checks"),
        "sf1 q1 beside the lane phase 12": [
            c for x in q1["runs"] for c in x.pop("kernel_checks")],
        "sf1 q15 view phase 12": q15.pop("kernel_checks")}
    out["seconds"] = time.perf_counter() - t_phase
    return out


# -- 13. the front door -------------------------------------------------------
FRONT_OPS = 1_000               # YCSB operations a mix over the wire
FRONT_SIDE_OPS = 600            # YCSB-B beside the parked sessions, Q1
ENTRY_TPCC_STEPS = 100          # `workload tpcc --steps` among the entry points
FRONT_CLIENTS = 16              # wire sessions, one thread each
FRONT_PARKED = 1_000            # idle sessions parked on the reactor
FRONT_SF = 0.05                 # the entry points' own TPC-H scale
FRONT_Q1_RUNS = 2               # Q1s a noisy-tenant session sends
ADM_SLOTS = 4                   # execution slots in the admission step
FRONT_TIMEOUT = 600.0           # a wire client's socket timeout (s)
PARSE_REPS = 21                 # warm runs a way, parse cache vs none
# Q6 with its date and discount bounds and its quantity cut as $n
Q6_PARAMS = ("SELECT sum(l_extendedprice * l_discount) AS revenue FROM "
             "lineitem WHERE l_shipdate >= date $1 AND l_shipdate < "
             "date $2 AND l_discount BETWEEN $3 AND $4 AND "
             "l_quantity < $5")
Q6_OIDS = (25, 25, 701, 701, 20)
Q6_TEXT = (b"1994-01-01", b"1995-01-01", b"0.05", b"0.07", b"24")


class _WireResult:
    def __init__(self, rows, tag):
        self.rows, self.tag = rows, tag


class _WireFront:
    """YCSB's engine over the wire: each thread sends its statements on
    a connection of its own, so run_concurrent's drivers are that many
    pgwire sessions; a 40001 comes back as the engine's restart error,
    which the workload retries."""

    def __init__(self, addr, **kw):
        import threading
        self.addr, self.kw = addr, kw
        self._tl = threading.local()
        self._lock = threading.Lock()
        self.clients = []

    def _client(self):
        from cockroach_tpu_torch.server.miniclient import MiniClient
        c = getattr(self._tl, "c", None)
        if c is None:
            c = MiniClient(*self.addr, timeout=FRONT_TIMEOUT, **self.kw)
            with self._lock:
                self.clients.append(c)
            self._tl.c = c
        return c

    def execute(self, sql, session=None):
        from cockroach_tpu_torch.exec.session import EngineError
        from cockroach_tpu_torch.server.miniclient import PgError
        try:
            _names, rows, tag = self._client().query(sql)
        except PgError as e:
            if e.sqlstate == "40001":
                raise EngineError(f"restart transaction: {e}") from e
            raise
        return _WireResult(rows, tag)

    def close(self):
        for c in self.clients:
            c.close()


class _WireClients:
    """The YCSB wire sessions' process (``wire_client_main``): one
    command a run, its result read back when the run ends."""

    def __init__(self):
        import os
        from pathlib import Path
        root = Path(__file__).resolve().parent
        env = dict(os.environ)
        env["PYTHONPATH"] = str(root) + os.pathsep + env.get("PYTHONPATH",
                                                             "")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.wire_client_main())"], cwd=root, env=env,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def send(self, cmd: dict) -> None:
        self.proc.stdin.write(json.dumps(cmd) + "\n")
        self.proc.stdin.flush()

    def result(self, label: str) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise AssertionError(f"{label}: the client process exited "
                                 f"({self.proc.poll()})")
        res = json.loads(line)
        if "error" in res:
            raise AssertionError(f"{label}: {res['error']}")
        return res

    def close(self) -> None:
        try:
            self.proc.stdin.write("\n")
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def wire_client_main() -> int:
    """Phase 13's YCSB sessions as a process of their own: one JSON
    command a line on stdin ({"addr": [host, port], "mix", "records",
    "ops", "clients", "insert_base"}), one JSON line back a command:
    YCSB.run_concurrent's numbers over that many wire sessions, a thread
    each, and the values written to the first 200 keys written (or
    {"error": ...}). An empty line ends it."""
    from cockroach_tpu_torch.workload.ycsb import YCSB
    for line in sys.stdin:
        if not line.strip():
            break
        cmd = json.loads(line)
        front = _WireFront(tuple(cmd["addr"]))
        try:
            y = YCSB(front, cmd["mix"], records=cmd["records"], seed=1)
            res = y.run_concurrent(
                cmd["ops"], workers=cmd["clients"], record_latency=True,
                timeout=FRONT_TIMEOUT, insert_base=cmd["insert_base"])
        except Exception as e:
            print(json.dumps({"error": repr(e)}), flush=True)
            continue
        finally:
            front.close()
        written: dict = {}
        for d in y.drivers:
            for k, v in d.writes:
                written.setdefault(k, []).append(v)
        res["written"] = [[k, written[k]] for k in sorted(written)[:200]]
        print(json.dumps(res), flush=True)
    return 0


def _wire_form(rows) -> list:
    """Engine rows as a wire client decodes them: dates as their text."""
    import datetime
    return [tuple(v.isoformat() if isinstance(v, datetime.date) else v
                  for v in r) for r in rows]


def _extended(c, sql, params, fmts, oids):
    """Parse/Bind/Execute/Sync on a MiniClient, with per-parameter
    format codes (0 text, 1 binary) and text results."""
    import struct
    c._send(b"P", b"\x00" + sql.encode() + b"\x00"
            + struct.pack("!H", len(oids))
            + b"".join(struct.pack("!I", o) for o in oids))
    b = bytearray(b"\x00\x00")
    b += struct.pack("!H", len(fmts)) + b"".join(
        struct.pack("!H", f) for f in fmts)
    b += struct.pack("!H", len(params))
    for p in params:
        b += struct.pack("!i", len(p)) + p
    b += struct.pack("!H", 0)
    c._send(b"B", bytes(b))
    c._send(b"E", b"\x00" + struct.pack("!i", 0))
    c._send(b"S")
    return c._collect()


@contextlib.contextmanager
def recording_small():
    """Record every call of the small-G kernel's wrapper while the block
    runs (its arguments, for compare_small)."""
    from cockroach_tpu_torch.ops.cuda import groupagg as tg
    kernel = tg.dense_group_aggregate
    calls: list = []

    def recording(*args, **kw):
        calls.append((args[0], args[1], tuple(args[2]), tuple(args[3]),
                      args[4], tuple(args[5])))
        return kernel(*args, **kw)

    tg.dense_group_aggregate = recording
    try:
        yield calls
    finally:
        tg.dense_group_aggregate = kernel


def _kernel_counts(on_card: bool) -> tuple:
    from cockroach_tpu_torch.ops.cuda import groupagg as tg
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    if on_card:
        return tgl.LAUNCHES, tg.LAUNCHES
    return tgl.PLAIN_CALLS, tg.PLAIN_CALLS


def _pctl(xs) -> dict:
    xs = sorted(xs)
    return {"n": len(xs), "p50_ms": xs[len(xs) // 2] * 1e3,
            "p99_ms": xs[min(len(xs) - 1, int(len(xs) * 0.99))] * 1e3}


def _rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def _connect_idle(addr):
    """A raw session that completed startup and now sits idle."""
    import socket
    import struct
    sock = socket.create_connection(addr, timeout=60)
    body = struct.pack("!I", 196608) + b"user\x00root\x00\x00"
    sock.sendall(struct.pack("!I", len(body) + 4) + body)
    buf = b""
    while True:
        off = 0
        while off + 5 <= len(buf):
            (ln,) = struct.unpack_from("!I", buf, off + 1)
            if off + 1 + ln > len(buf):
                break
            if buf[off:off + 1] == b"Z":
                return sock
            off += 1 + ln
        buf = buf[off:]
        b = sock.recv(4096)
        if not b:
            raise ConnectionError("server closed during startup")
        buf += b


def _check_wire_query(eng, c, label, sql, check, on_card, session=None,
                      k1=None, k2=None, extended=None) -> dict:
    """One statement over the wire, then the same text through
    execute(), each with its kernel launches (counted from 0 just before
    it and read just after), held against its oracle (``check(rows)``)
    and against each other; each launch of either held against the plain
    version at its inputs (on the card). ``k1``/``k2``: the launches of
    kernel 1 and 2 each must make."""
    _counts_zero()
    t0 = time.perf_counter()
    with recording_slots() as calls, recording_small() as scalls:
        names, rows, tag = (extended(c) if extended is not None
                            else c.query(sql))
        _sync()
    s = time.perf_counter() - t0
    n1, n2 = _kernel_counts(on_card)
    _counts_zero()
    with recording_slots() as dcalls, recording_small() as dscalls:
        direct = _wire_form(eng.execute(sql, session).rows)
        _sync()
    d1, d2 = _kernel_counts(on_card)
    for how, got in (("wire", (n1, n2)), ("execute", (d1, d2))):
        if (k1 is not None and got[0] != k1) or \
                (k2 is not None and got[1] != k2):
            raise AssertionError(f"{label} {how}: kernel launches {got}, "
                                 f"want ({k1}, {k2})")
    err = check(rows)
    out = {"s": s, "groupagg_large": n1, "groupagg": n2,
           "execute_groupagg_large": d1, "execute_groupagg": d2,
           "rows": len(rows), "tag": tag}
    if k2:
        # the small-G kernel adds in f32 with atomics: two runs agree
        # within its tolerance, not bit for bit
        check_float(f"{label} vs execute", rows, direct)
    elif rows != direct:
        raise AssertionError(f"{label}: wire rows != execute's: "
                             f"{rows[:2]} vs {direct[:2]}")
    if err is not None:
        out["max_rel_err"] = err
    if on_card:
        out["kernel_checks"] = (check_calls(label, calls, n1)
                                + check_calls(f"{label} execute", dcalls, d1))
        out["small_checks"] = _check_small_calls(label, scalls + dscalls,
                                                 n2 + d2)
    return out


def _check_small_calls(label, calls, launches) -> list:
    """The small-G kernel against its plain version at each recorded
    call; every launch must have been recorded."""
    from cockroach_tpu_torch.ops.cuda import groupagg as tg
    if len(calls) != launches:
        raise AssertionError(f"{label}: {len(calls)} recorded calls of the "
                             f"small-G kernel, {launches} launches")
    return [compare_small(tg, a, f"{label} small") for a in calls]


def frontdoor_phase(eng, li, orders, cust, part, records: int,
                    ops: int = FRONT_OPS, clients: int = FRONT_CLIENTS,
                    parked: int = FRONT_PARKED,
                    side_ops: int = FRONT_SIDE_OPS,
                    q1_runs: int = FRONT_Q1_RUNS) -> dict:
    """Phase 13 on the SF1 engine after phase 12: the pgwire server
    (server/pgwire.py, server/pgfront.py) over ``eng``. ``li``,
    ``orders``: the arrays as phase 11 left them (strings decoded);
    ``records``: usertable's bulk-loaded keys. Returns the `frontdoor`
    numbers."""
    import resource
    import sys as _sys
    import threading

    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.server.miniclient import MiniClient
    from cockroach_tpu_torch.server.node import _tenants_payload
    from cockroach_tpu_torch.server.pgwire import PgServer
    on_card = eng.device.type == "cuda"
    t_phase = time.perf_counter()
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    need = 2 * parked + 1024
    if soft < need:
        resource.setrlimit(resource.RLIMIT_NOFILE, (
            need if hard == resource.RLIM_INFINITY else min(hard, need),
            hard))
    want_q1, want_q6 = tpch.ref_q1(li), tpch.ref_q6(li)
    want_q14 = tpch.ref_q14(li, part)
    want_q3 = _wire_form(tpch.ref_q3(li, orders, cust))
    checks = {
        "q1": (tpch.Q1, lambda r: check_q1(r, want_q1), 1, 0),
        "q6": (tpch.Q6, lambda r: check_rows("Q6 wire", r, [(want_q6,)]),
               None, 0),
        "q14": (tpch.Q14, lambda r: check_rows("Q14 wire", r,
                                               [(want_q14,)]), None, 0),
        "q3": (tpch.Q3, lambda r: check_rows("Q3 wire", r, want_q3),
               None, 0)}
    s_on = eng.session()
    eng.execute("SET pallas_groupagg = on", s_on)
    point = "SELECT field0, field1 FROM usertable WHERE ycsb_key = 4242"
    out = {"queries": {}, "wire_ms": {}, "ycsb": {}}
    k_total, timed = [0, 0], [0, 0]
    path_checks, small_checks = {}, []
    # each run's drivers insert from base + (w + 1) * 10,000,000
    bases = iter(range(records + 200_000_000, records + 4_000_000_000,
                       200_000_000))
    # the 16 YCSB sessions run in a process of their own, so their
    # Python does not share the server's interpreter lock
    sessions = _WireClients()

    def note(label, r):
        k_total[0] += r["groupagg_large"] + r["execute_groupagg_large"]
        k_total[1] += r["groupagg"] + r["execute_groupagg"]
        if r.get("kernel_checks"):
            path_checks[f"sf1 {label} phase 13"] = r.pop("kernel_checks")
        small_checks.extend(r.pop("small_checks", []))

    def counted(label, fn, held=True):
        """fn() with the counts from 0 just before it, read just after
        and added to the phase's. ``held``: each launch recorded and
        held against the plain version (timed runs are counted only:
        recording would keep every call's inputs on the card while they
        are timed). Returns fn's value and the launches
        of kernels 1 and 2."""
        _counts_zero()
        if held:
            with recording_slots() as calls, recording_small() as scalls:
                r = fn()
                _sync()
        else:
            r = fn()
            _sync()
        n1, n2 = _kernel_counts(on_card)
        k_total[0] += n1
        k_total[1] += n2
        if not held:
            timed[0] += n1
            timed[1] += n2
        elif on_card:
            path_checks[f"sf1 {label} phase 13"] = check_calls(label, calls,
                                                               n1)
            small_checks.extend(_check_small_calls(label, scalls, n2))
        return r, (n1, n2)

    def ycsb_over(addr, mix, label, beside=None, n_ops=ops):
        h0 = eng.lane_hits
        sessions.send({"addr": list(addr), "mix": mix, "records": records,
                       "ops": n_ops, "clients": clients,
                       "insert_base": next(bases)})
        side = {}
        if beside is not None:
            deadline = time.perf_counter() + 120.0
            while eng.lane_hits - h0 < 8 * clients and \
                    time.perf_counter() < deadline:
                time.sleep(0.001)
            side = beside()
        res = sessions.result(label)
        # every written key reads back one of the values some session
        # wrote to it (a sample, through execute's own sessions)
        for k, vs in res["written"]:
            got = eng.execute(f"SELECT field0 FROM usertable WHERE "
                              f"ycsb_key = {k}").rows
            if not got or got[0][0] not in vs:
                raise AssertionError(f"{label}: key {k} reads {got}, "
                                     f"written {vs}")
        r = {"ops_per_s": res["ops_per_sec"], "seconds": res["seconds"],
             "p50_ms": res["p50_ms"], "p99_ms": res["p99_ms"],
             "mix": res["ops"], "retries": res["retries"],
             "by_op": {op: res[op] for op in res["ops"] if op in res},
             "lane_hits": eng.lane_hits - h0}
        print(f"{label}: " + json.dumps(r), flush=True)
        return r, side

    def admission_run(cap: int) -> dict:
        """Noisy Q1s and quiet point reads at once under tenant slots
        ``cap`` (0: none); the quiet sessions read until the noisy ones
        are done, once at least. Latencies, waits and the lane hits in the run."""
        snap0, h0 = eng.metrics.snapshot(), eng.lane_hits
        eng.settings.set("sql.admission.tenant.slots", cap)
        noisy_lat, quiet_lat, errs = [], [], []
        lock, done = threading.Lock(), threading.Event()

        def noisy():
            try:
                c = MiniClient(*srv.addr, timeout=FRONT_TIMEOUT,
                               application_name="noisy")
                for _ in range(q1_runs):
                    t1 = time.perf_counter()
                    rows = c.query(tpch.Q1)[1]
                    with lock:
                        noisy_lat.append(time.perf_counter() - t1)
                    check_q1(rows, want_q1)
                c.close()
            except BaseException as e:
                errs.append(e)

        def quiet(i):
            try:
                c = MiniClient(*srv.addr, timeout=FRONT_TIMEOUT,
                               application_name="quiet")
                j = 0
                while j == 0 or not done.is_set():
                    k = (i * 7919 + j * 104729) % records
                    j += 1
                    t1 = time.perf_counter()
                    rows = c.query(f"SELECT field1 FROM usertable WHERE "
                                   f"ycsb_key = {k} AND field1 >= 0")[1]
                    with lock:
                        quiet_lat.append(time.perf_counter() - t1)
                    if rows != [(k * 13 % 1000,)]:
                        raise AssertionError(f"quiet read {k}: {rows}")
                c.close()
            except BaseException as e:
                errs.append(e)
        try:
            loud = [threading.Thread(target=noisy) for _ in range(8)]
            calm = [threading.Thread(target=quiet, args=(i,))
                    for i in range(4)]
            t0 = time.perf_counter()
            for th in calm + loud:
                th.start()
            for th in loud:
                th.join(FRONT_TIMEOUT)
            done.set()
            for th in calm:
                th.join(FRONT_TIMEOUT)
            seconds = time.perf_counter() - t0
        finally:
            done.set()
            eng.settings.set("sql.admission.tenant.slots", 0)
        if errs or any(th.is_alive() for th in loud + calm):
            raise AssertionError(f"admission run (tenant slots {cap}) "
                                 f"failed: {errs[:1]}")
        if eng.lane_hits != h0:
            raise AssertionError("a quiet read took the lane")
        snap1 = eng.metrics.snapshot()
        return {"seconds": seconds,
                **{k: snap1[f"admission.{m}"] - snap0[f"admission.{m}"]
                   for k, m in (("slot_waits", "tenant.slot_waits"),
                                ("queued", "queued"),
                                ("admitted", "admitted"))},
                "noisy_q1": _pctl(noisy_lat), "quiet_point": _pctl(quiet_lat)}

    try:
        # 1. queries, then YCSB-B and -E, under each frontend
        for fe in ("threads", "reactor"):
            srv = PgServer(eng, frontend=fe).start()
            try:
                c = MiniClient(*srv.addr, timeout=FRONT_TIMEOUT)
                q = out["queries"][fe] = {}
                for name, (sql, check, k1, k2) in checks.items():
                    q[name] = _check_wire_query(eng, c, f"{name} {fe}", sql,
                                                check, on_card, k1=k1, k2=k2)
                    note(f"{name} wire {fe}", q[name])
                for fmt, params in (
                        ("text", Q6_TEXT),
                        ("binary", Q6_TEXT[:2] + (
                            struct.pack("!d", 0.05), struct.pack("!d", 0.07),
                            struct.pack("!q", 24)))):
                    fmts = (0, 0, 0, 0, 0) if fmt == "text" \
                        else (0, 0, 1, 1, 1)
                    q[f"q6_{fmt}_params"] = _check_wire_query(
                        eng, c, f"q6 extended {fmt} {fe}", tpch.Q6,
                        lambda r: check_rows("Q6 extended", r, [(want_q6,)]),
                        on_card, k2=0, extended=lambda cl, p=params, f=fmts:
                        _extended(cl, Q6_PARAMS, p, f, Q6_OIDS))
                    note(f"q6 extended {fmt} {fe}", q[f"q6_{fmt}_params"])
                c.query("SET pallas_groupagg = on")
                q["q1f"] = _check_wire_query(
                    eng, c, f"q1f {fe}", tpch.Q1F,
                    lambda r: check_float("Q1F wire", r, want_q1), on_card,
                    session=s_on, k1=0, k2=1)
                note(f"q1f wire {fe}", q["q1f"])
                c.query("SET pallas_groupagg = auto")
                out["wire_ms"][fe], _ = counted(f"timed wire {fe}", lambda: {
                    "q1": _median_ms(lambda: c.query(tpch.Q1)),
                    "q6": _median_ms(lambda: c.query(tpch.Q6)),
                    "point": _median_ms(lambda: c.query(point))},
                    held=False)
                c.close()
                print(f"queries over the wire ({fe}): " + json.dumps(
                    {"queries": q, "wire_ms": out["wire_ms"][fe]}), flush=True)
                for mix in ("B", "E"):
                    out["ycsb"][f"{mix}_{fe}"], _ = ycsb_over(
                        srv.addr, mix, f"ycsb-{mix} {clients} wire sessions "
                        f"{fe}")
            finally:
                srv.stop()
        def execute_medians():
            from cockroach_tpu_torch.sql import parser
            ms = {"point": _median_ms(lambda: eng.execute(point))}
            # the parse cache against a parse per statement (the point
            # read is the lane's, which parses no statement): Q1 and Q6
            # in turns, PARSE_REPS warm runs each way
            for k, sql in (("q1", tpch.Q1), ("q6", tpch.Q6)):
                ms[k] = _median_ms(lambda: eng.execute(sql), PARSE_REPS)
                eng._parse_cached = lambda text, _tenant: parser.parse(text)
                try:
                    ms[f"{k}_parse_each"] = _median_ms(
                        lambda: eng.execute(sql), PARSE_REPS)
                finally:
                    del eng._parse_cached
            return ms
        out["execute_ms"], _ = counted("timed execute", execute_medians,
                                       held=False)
        out["wire_overhead_ms"] = {
            k: out["wire_ms"]["reactor"][k] - out["execute_ms"][k]
            for k in out["wire_ms"]["reactor"]}

        # 2. the reactor with a 1 ms switch interval, parked sessions, Q1
        #    beside YCSB-B
        srv = PgServer(eng, frontend="reactor").start()
        try:
            default_si = _sys.getswitchinterval()
            eng.settings.set("sql.exec.switch_interval", 0.001)
            try:
                if abs(_sys.getswitchinterval() - 0.001) > 1e-9:
                    raise AssertionError("sql.exec.switch_interval did not "
                                         "set the switch interval")
                for mix in ("B", "E"):
                    out["ycsb"][f"{mix}_reactor_si1ms"], _ = ycsb_over(
                        srv.addr, mix, f"ycsb-{mix} {clients} wire sessions "
                        "reactor switch_interval=0.001")
            finally:
                eng.settings.set("sql.exec.switch_interval", 0.0)
            if _sys.getswitchinterval() != default_si:
                raise AssertionError("the switch interval was not restored")

            impl = srv._impl
            threads0, rss0 = threading.active_count(), _rss_bytes()
            t0 = time.perf_counter()
            socks = [_connect_idle(srv.addr) for _ in range(parked)]
            connect_s = time.perf_counter() - t0
            deadline = time.perf_counter() + 30
            while impl._count_active() and time.perf_counter() < deadline:
                time.sleep(0.01)
            rss1, threads1 = _rss_bytes(), threading.active_count()
            try:
                live, _ = ycsb_over(srv.addr, "B", f"ycsb-B {clients} wire "
                                    f"sessions beside {parked} parked",
                                    n_ops=side_ops)
                if len(impl._sessions) < parked:
                    raise AssertionError("parked sessions were retired")
                threads_live = threading.active_count()
            finally:
                for s in socks:
                    s.close()
            out["parked"] = {
                "sessions": parked, "connect_s": connect_s,
                "threads_before": threads0, "threads_parked": threads1,
                "threads_with_live_clients": threads_live,
                "pool_workers": impl._pool._max_workers,
                "rss_bytes_per_parked_session": (rss1 - rss0) / parked,
                "live_ycsb_b": live}
            print("parked sessions: " + json.dumps(out["parked"]), flush=True)
            if threads1 > threads0 + impl._pool._max_workers:
                raise AssertionError(f"{parked} parked sessions took threads: "
                                     f"{threads0} -> {threads1}")

            def q1_beside():
                c = MiniClient(*srv.addr, timeout=FRONT_TIMEOUT)
                try:
                    h0 = eng.lane_hits
                    r = _check_wire_query(
                        eng, c, "q1 beside ycsb-B", tpch.Q1,
                        lambda rows: check_q1(rows, want_q1), on_card, k1=1)
                    r["lane_hits_during"] = eng.lane_hits - h0
                    return r
                finally:
                    c.close()
            beside, q1 = ycsb_over(srv.addr, "B", f"ycsb-B {clients} wire "
                                   "sessions beside Q1", beside=q1_beside,
                                   n_ops=side_ops)
            if not q1["lane_hits_during"]:
                raise AssertionError("no lane statement ran while Q1 did")
            note("q1 wire beside ycsb-B", q1)
            out["beside_q1"] = {"ycsb_b": beside, "q1": q1}
            print("Q1 beside YCSB-B over the wire: " + json.dumps(q1),
                  flush=True)

            # 3. admission at ADM_SLOTS execution slots: a noisy tenant
            #    sends Q1 from 8 sessions while a quiet tenant sends pk
            #    point reads from 4, first with no tenant cap, then with
            #    2 slots a tenant. The quiet reads carry a residual
            #    conjunct, so the lane refuses them and they take the
            #    full path (the primary-key fastpath) through admission
            out["admission"] = {"slots": ADM_SLOTS}
            # the full path's first pk read of usertable builds its
            # sorted row locators (seconds at 1,000,000 records): built
            # here, so that neither run's latencies hold it
            t0 = time.perf_counter()
            eng.execute("SELECT field1 FROM usertable WHERE ycsb_key = 0 "
                        "AND field1 >= 0")
            out["admission"]["locators_s"] = time.perf_counter() - t0
            slots0 = eng.admission.slots
            eng.admission.slots = ADM_SLOTS
            try:
                for cap in (0, 2):
                    r, (n1, n2) = counted(
                        f"q1 noisy tenant, tenant slots {cap}",
                        lambda cap=cap: admission_run(cap))
                    if (n1, n2) != (8 * q1_runs, 0):
                        raise AssertionError(
                            f"{8 * q1_runs} noisy Q1s launched the kernels "
                            f"{(n1, n2)} times")
                    out["admission"][f"tenant_slots_{cap}"] = r
            finally:
                eng.admission.slots = slots0
            out["admission"]["tenants"] = {
                t["app_name"]: t for t in _tenants_payload(eng)["tenants"]
                if t["app_name"] in ("noisy", "quiet")}
            print("admission: " + json.dumps(out["admission"]), flush=True)
            if out["admission"]["tenant_slots_2"]["slot_waits"] < 1:
                raise AssertionError("8 noisy sessions at 2 tenant slots "
                                     "never waited")
        finally:
            srv.stop()
    finally:
        sessions.close()
    out["kernel_launches"] = {"groupagg_large": k_total[0],
                              "groupagg": k_total[1]}
    # of which in timed runs, counted but not held against the plain
    # version one by one
    out["kernel_launches_timed"] = {"groupagg_large": timed[0],
                                    "groupagg": timed[1]}
    out["path_checks"] = path_checks
    out["small_checks"] = small_checks
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _shell_rows(text: str, first: str) -> list:
    """The rows the CLI shell printed for a result whose first column
    header is ``first``: whitespace-split, up to the command tag."""
    lines = text.splitlines()
    # the shell's prompts ("> ", "... ") precede a header read from stdin
    i = next(j for j, ln in enumerate(lines)
             if ln.lstrip("> .").split()[:1] == [first])
    rows = []
    for ln in lines[i + 2:]:
        if ln.startswith("SELECT "):
            break
        rows.append(ln.split())
    return rows


NODE_TENANT = "phase14"          # the node client's application_name


def _node_observability(base: str, c, want_q6) -> dict:
    """Phase 14 through the node, after its client's slow Q1:
    /debug/tracez lists that Q1; POST /_status/stmtdiag arms Q6, whose
    next run over the wire captures a bundle fetched at
    /_status/stmtdiag/<id>; /_status/tenants shows the client's tenant
    with a device time and an HBM high-water."""
    import urllib.request

    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.utils.sqlstats import fingerprint

    def get(path):
        return json.loads(urllib.request.urlopen(base + path,
                                                 timeout=30).read())
    traces = [t for t in get("/debug/tracez")["traces"]
              if t["fingerprint"] == fingerprint(tpch.Q1)]
    if not traces or traces[-1]["application_name"] != NODE_TENANT:
        raise AssertionError("/debug/tracez does not list the slow Q1")
    req = urllib.request.Request(
        base + "/_status/stmtdiag",
        data=json.dumps({"sql": tpch.Q6}).encode(),
        headers={"Content-Type": "application/json"})
    armed = json.loads(urllib.request.urlopen(req, timeout=30).read())
    got_q6 = float(c.query(tpch.Q6)[1][0][0])
    if not _close(got_q6, want_q6, 1e-9):
        raise AssertionError(f"node Q6 {got_q6} != {want_q6}")
    bundle = get(f"/_status/stmtdiag/{armed['request_id']}")
    if bundle["fingerprint"] != armed["fingerprint"] or \
            not bundle["profile"]["ops"] or not bundle["plan"]:
        raise AssertionError(f"stmtdiag bundle: {sorted(bundle)}")
    tenant = {t["app_name"]: t for t in
              get("/_status/tenants")["tenants"]}.get(NODE_TENANT)
    if tenant is None or not tenant["device_seconds"]:
        raise AssertionError(f"/_status/tenants {NODE_TENANT}: {tenant}")
    return {"tracez_q1_duration_s": traces[-1]["duration_s"],
            "stmtdiag_bundle_id": bundle["id"],
            "stmtdiag_device_time_s": bundle["device_time_s"],
            "stmtdiag_ops": len(bundle["profile"]["ops"]),
            "tenant": tenant}


def entry_points_phase(sf: float = FRONT_SF, device=None) -> dict:
    """Phase 13's entry points on the card (``device`` names another,
    for a rehearsal): Node in process, then ``demo``, ``start`` + ``sql
    -e`` and ``workload tpcc`` as processes of their own, all at once.
    Each reuses the kernels phase 1 built: _build/ is unchanged."""
    import os
    import urllib.request
    from pathlib import Path

    import numpy as np

    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import build
    from cockroach_tpu_torch.server import Node, NodeConfig
    from cockroach_tpu_torch.server.miniclient import MiniClient
    from cockroach_tpu_torch.utils.sqlstats import fingerprint
    on_card = device is None
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    built = {p.name: p.stat().st_mtime_ns
             for p in build.BUILD_DIR.glob("*.so")}
    li = tpch.gen_lineitem(sf)
    want_q1, want_q6 = tpch.ref_q1(li), tpch.ref_q6(li)
    out = {"sf": sf}
    dev = [] if device is None else ["--device", device]
    cmd = [sys.executable, "-m", "cockroach_tpu_torch"]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root) + os.pathsep + env.get("PYTHONPATH", "")
    # the processes start first: each takes seconds to reach the card
    demo = subprocess.Popen(
        cmd + ["demo", "--sf", str(sf)] + dev, cwd=root, env=env,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    import tempfile
    start_err = tempfile.TemporaryFile(mode="w+")
    start = subprocess.Popen(
        cmd + ["start", "--listen-addr", "127.0.0.1:0"] + dev, cwd=root,
        env=env, stdout=subprocess.PIPE, stderr=start_err, text=True)
    wl = subprocess.Popen(cmd + ["workload", "tpcc", "--steps",
                                 str(ENTRY_TPCC_STEPS)] + dev,
                          cwd=root, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True)
    procs = (demo, start, wl)
    try:
        # in process
        t0 = time.perf_counter()
        node = Node(NodeConfig(load_tpch_sf=sf, device=device)).start()
        try:
            start_s = time.perf_counter() - t0
            c = MiniClient(*node.sql_addr, timeout=FRONT_TIMEOUT,
                           application_name=NODE_TENANT)
            # phase 14 through the node: Q1 past the slow-statement
            # threshold
            c.query("SET CLUSTER SETTING sql.trace.slow_statement."
                    "threshold = 0.001")
            k0 = _kernel_counts(on_card)[0]
            with recording_slots() as calls:
                rows = c.query(tpch.Q1)[1]
                _sync()
            n1 = _kernel_counts(on_card)[0] - k0
            c.query("SET CLUSTER SETTING sql.trace.slow_statement."
                    "threshold = 0")
            check_q1(rows, want_q1)
            if n1 != 1:
                raise AssertionError(f"Node's Q1 launched kernel 1 {n1} "
                                     "times")
            node_checks = check_calls("node q1", calls, 1) if on_card \
                else []
            host, port = node.http_addr
            base = f"http://{host}:{port}"
            stmts = json.loads(urllib.request.urlopen(
                base + "/_status/statements", timeout=30).read())
            q1 = [s for s in stmts["statements"]
                  if s["fingerprint"] == fingerprint(tpch.Q1)]
            if len(q1) != 1 or q1[0]["count"] != 1:
                raise AssertionError(f"/_status/statements Q1: {q1}")
            metrics = urllib.request.urlopen(base + "/_status/vars",
                                             timeout=30).read().decode()
            if "admission_admitted" not in metrics:
                raise AssertionError("/_status/vars has no admission "
                                     "metrics")
            out["observability"] = _node_observability(base, c,
                                                       want_q6)
            c.close()
        finally:
            t0 = time.perf_counter()
            node.stop()
            stop_s = time.perf_counter() - t0
        out["node"] = {"start_s": start_s, "stop_s": stop_s,
                       "q1_launches": n1, "q1_count": q1[0]["count"],
                       "metrics_lines": metrics.count("\n")}

        # start + sql -e: a small lineitem made over the wire, Q6 and
        # SHOW STATEMENTS
        addr = None
        for line in start.stdout:
            if line.startswith("sql:"):
                addr = line.split("@", 1)[1].split("/", 1)[0]
                break
        if addr is None:
            start_err.seek(0)
            raise AssertionError("start printed no sql: line: "
                                 + start_err.read()[-2000:])
        small = tpch.gen_lineitem(0.01, rows=500)
        inserts = tpch.insert_statements("lineitem", small)
        sql = subprocess.run(
            cmd + ["sql", "--url", addr, "-e", tpch.DDL["lineitem"]]
            + [a for s in inserts for a in ("-e", s)]
            + ["-e", tpch.Q6, "-e", "SHOW STATEMENTS"], cwd=root, env=env,
            capture_output=True, text=True, timeout=300)
        if sql.returncode != 0:
            raise AssertionError(f"sql -e failed: {sql.stderr[-2000:]}")
        got_q6 = float(_shell_rows(sql.stdout, "revenue")[0][0])
        if not _close(got_q6, tpch.ref_q6(small), 1e-9):
            raise AssertionError(f"start + sql -e Q6 {got_q6} != "
                                 f"{tpch.ref_q6(small)}")
        fp = fingerprint(tpch.Q6)
        line = next(ln for ln in sql.stdout.splitlines()
                    if ln.startswith(fp))
        if line[len(fp):].split()[0] != "1":
            raise AssertionError(f"SHOW STATEMENTS Q6: {line}")
        out["start_sql"] = {"q6": got_q6, "q6_count": 1,
                            "statements": len(inserts) + 3}

        # demo with Q1 and Q6 piped on stdin
        text, err = demo.communicate(
            tpch.Q1.strip() + ";\n" + tpch.Q6.strip() + ";\n\\q\n",
            timeout=600)
        if demo.returncode != 0:
            raise AssertionError(f"demo exited {demo.returncode}: "
                                 f"{err[-2000:]}")
        q1_rows = [(r[0], r[1], *map(float, r[2:]))
                   for r in _shell_rows(text, "l_returnflag")]
        check_q1(q1_rows, want_q1)
        q6_demo = float(_shell_rows(text, "revenue")[0][0])
        if not _close(q6_demo, want_q6, 1e-9):
            raise AssertionError(f"demo Q6 {q6_demo} != {want_q6}")
        out["demo"] = {"q1_groups": len(q1_rows), "q6": q6_demo}

        wout, werr = wl.communicate(timeout=600)
        if wl.returncode != 0:
            raise AssertionError(f"workload tpcc exited {wl.returncode}: "
                                 f"{werr[-2000:]}")
        tpcc = json.loads(wout.strip().splitlines()[-1])
        if tpcc["steps"] != ENTRY_TPCC_STEPS:
            raise AssertionError(f"workload tpcc: {tpcc}")
        out["workload_tpcc"] = tpcc
    finally:
        import signal
        if start.poll() is None:
            start.send_signal(signal.SIGINT)
        for p in procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        start_err.close()
    if start.returncode != 0:
        raise AssertionError(f"start exited {start.returncode} on SIGINT")
    after = {p.name: p.stat().st_mtime_ns
             for p in build.BUILD_DIR.glob("*.so")}
    if on_card and after != built:
        raise AssertionError(f"the entry points built kernels again: "
                             f"{sorted(set(after) ^ set(built))}")
    out["node_checks"] = node_checks
    out["seconds"] = time.perf_counter() - t_phase
    print("entry points: " + json.dumps(
        {k: v for k, v in out.items() if k != "node_checks"}), flush=True)
    return out


# -- 17. cold start and kernel infrastructure ---------------------------------

MINMAX_GROUP_BY = ("SELECT l_suppkey, min(l_extendedprice), "
                   "max(l_orderkey), min(l_quantity) FROM lineitem "
                   "GROUP BY l_suppkey")
# TPC-H queries whose routes take kernel 1 for an INT/DECIMAL MIN/MAX
# under `auto` once the parity gate promoted int_minmax (Q2's
# decorrelated min(ps_supplycost) per part key, 200,000 dense groups)
MINMAX_QUERIES = ("q2",)
# Q6 with literals from TPC-H's substitution ranges (DATE: 1 January of
# 1993-1997, DISCOUNT: 0.02-0.09, QUANTITY: 24-25); written on one line
# so its statement shape is not tpch.Q6's
Q6_SHAPE = ("SELECT sum(l_extendedprice * l_discount) AS revenue FROM "
            "lineitem WHERE l_shipdate >= date '{y}-01-01' AND l_shipdate "
            "< date '{y}-01-01' + interval '1 year' AND l_discount BETWEEN "
            "{d} - 0.01 AND {d} + 0.01 AND l_quantity < {q}")
Q6_LITERALS = ((1993, "0.02", 24), (1994, "0.06", 25), (1995, "0.04", 24),
               (1996, "0.09", 25), (1997, "0.07", 24))
# new literals for the host-time comparison, shape cache off and on
Q6_TIMED = ((1993, "0.03", 25), (1995, "0.05", 25), (1996, "0.08", 24),
            (1997, "0.04", 25), (1994, "0.09", 24), (1993, "0.08", 24))
# the lineitem columns Q1 and Q6 read: the cold-start children's table
COLD_COLUMNS = ("l_quantity", "l_extendedprice", "l_discount", "l_tax",
                "l_returnflag", "l_linestatus", "l_shipdate")
COLD_PREWARM = 8


@contextlib.contextmanager
def cache_root():
    """A fresh cold-start cache root for the run (exec/coldstart.py reads
    COCKROACH_TPU_COMPILE_CACHE_DIR), removed at its end: every engine of
    the run, and every process it starts, shares it."""
    import os
    import shutil
    import tempfile
    from cockroach_tpu_torch.exec.coldstart import ENV_VAR
    root = tempfile.mkdtemp(prefix="chip-smoke-cache-")
    prev = os.environ.get(ENV_VAR)
    os.environ[ENV_VAR] = root
    try:
        yield root
    finally:
        if prev is None:
            os.environ.pop(ENV_VAR, None)
        else:
            os.environ[ENV_VAR] = prev
        shutil.rmtree(root, ignore_errors=True)


def kernel_infra(device: str = "cuda") -> dict:
    """Phase 1's half of phase 17: kernel 1's launch point for this card
    and the parity gate's verdicts at it, resolved as an engine's first
    `auto` plan build would resolve them (the tuning table's point, else
    the shipped one: `auto` never sweeps; a fuzz in both layouts at that
    point, persisted under the cache root), before any main-path run is
    counted."""
    import torch

    from cockroach_tpu_torch.exec import coldstart
    from cockroach_tpu_torch.ops.cuda import autotune, paritygate
    from cockroach_tpu_torch.utils.settings import Settings
    dev = torch.device(device)
    key = coldstart.device_key(dev)
    d = coldstart.init_cache_dir(Settings(), dev)
    r0 = autotune.RUNS.value("sweep")
    point = autotune.params_for(key, d, "auto", dev)
    if autotune.RUNS.value("sweep") != r0:
        raise AssertionError("`auto` swept the launch points")
    t0 = time.perf_counter()
    exact = paritygate.promoted(key, d, dev, point)
    out = {"cache_dir": d, "exact_paths": list(exact),
           "point": list(point), "fuzz_s": time.perf_counter() - t0}
    print("kernel infrastructure: " + json.dumps(out), flush=True)
    return out


def q6_oracle(li, year: int, disc: str, qty: int) -> float:
    import numpy as np

    from cockroach_tpu_torch.models import tpch
    d0 = tpch._days(f"{year}-01-01")
    d1 = tpch._days(f"{year + 1}-01-01")
    lo, hi = float(disc) - 0.01, float(disc) + 0.01
    # the DECIMAL(15,2) bounds, exactly as the engine compares them
    lo, hi = round(lo * 100) / 100, round(hi * 100) / 100
    dc = np.round(li["l_discount"] * 100)
    m = ((li["l_shipdate"] >= d0) & (li["l_shipdate"] < d1)
         & (dc >= round(lo * 100)) & (dc <= round(hi * 100))
         & (li["l_quantity"] < qty))
    return float((li["l_extendedprice"][m] * li["l_discount"][m]).sum())


def minmax_oracle(li) -> list:
    """MINMAX_GROUP_BY by numpy: rows sorted by l_suppkey."""
    import numpy as np
    keys = li["l_suppkey"]
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    out = [np.minimum.reduceat(li["l_extendedprice"][order], starts),
           np.maximum.reduceat(li["l_orderkey"][order], starts),
           np.minimum.reduceat(li["l_quantity"][order], starts)]
    return [(int(k), float(a), int(b), float(c))
            for k, a, b, c in zip(ks[starts], *out)]


def _child_env(root: str) -> dict:
    import os
    from cockroach_tpu_torch.exec.coldstart import ENV_VAR
    return dict(os.environ, **{ENV_VAR: root})


def coldstart_child_main() -> int:
    """A cold-start child process (phase 17d): argv = [npz, prewarm,
    device] (device "cuda": the card; "cpu" for a rehearsal).
    Loads the lineitem columns of the npz into an Engine on the card,
    prewarms the top `prewarm` journaled statements, then runs Q1 and
    Q6 once each with every count set to 0 just before and read just
    after (each kernel-1 launch held against its plain version), and
    prints one JSON line of what it measured."""
    import numpy as np

    from cockroach_tpu_torch.exec import coldstart
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import groupagg as tg
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    t_start = time.perf_counter()
    path, prewarm = sys.argv[1], int(sys.argv[2])
    cols = dict(np.load(path))
    eng = Engine(device=None if sys.argv[3] == "cuda" else sys.argv[3])
    eng.execute(
        "CREATE TABLE lineitem (l_quantity DECIMAL(15,2) NOT NULL, "
        "l_extendedprice DECIMAL(15,2) NOT NULL, l_discount DECIMAL(15,2) "
        "NOT NULL, l_tax DECIMAL(15,2) NOT NULL, l_returnflag STRING NOT "
        "NULL, l_linestatus STRING NOT NULL, l_shipdate DATE NOT NULL)")
    for cn in ("l_returnflag", "l_linestatus"):
        eng.store.set_dictionary("lineitem", cn, tpch.LINEITEM_DICTS[cn])
    eng.store.insert_columns("lineitem", cols, eng.clock.now())
    load_s = time.perf_counter() - t_start
    eng.settings.set("sql.exec.compile_cache.prewarm", prewarm)
    tally = coldstart.TALLY
    t0 = time.perf_counter()
    warmed = eng.prewarm()
    _sync()
    out = {"prewarm": prewarm, "load_s": load_s,
           "prewarm_s": time.perf_counter() - t0, "warmed": warmed,
           "prewarm_errors": tally.prewarm_errors,
           "point": list(engine_point(eng.device))}
    for q, sql in (("q1", tpch.Q1), ("q6", tpch.Q6)):
        _counts_zero()
        h0, m0 = eng.plan_cache["hit"], eng.plan_cache["miss"]
        t0 = time.perf_counter()
        with recording_slots() as calls:
            rows = eng.execute(sql).rows
            _sync()
        out[f"{q}_first_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{q}_hit"] = eng.plan_cache["hit"] - h0
        out[f"{q}_miss"] = eng.plan_cache["miss"] - m0
        on_card = eng.device.type == "cuda"
        out[f"{q}_launches"] = {
            "groupagg_large": tgl.LAUNCHES if on_card else tgl.PLAIN_CALLS,
            "groupagg": tg.LAUNCHES if on_card else tg.PLAIN_CALLS}
        out[f"{q}_checks"] = check_calls(
            f"child {q}", calls, tgl.LAUNCHES) if on_card else []
        out[f"{q}_rows"] = [[str(v) for v in r] for r in rows]
    out.update(plan_cache=dict(eng.plan_cache), lib_loads=tally.lib_loads,
               lib_builds=tally.lib_builds, plan_builds=tally.plan_builds,
               seconds=time.perf_counter() - t_start)
    eng.close()
    print("COLDSTART " + json.dumps(out), flush=True)
    return 0


def _run_child(npz: str, prewarm: int, root: str, device: str) -> dict:
    cmd = [sys.executable, "-c", "import sys, chip_smoke; "
           "sys.exit(chip_smoke.coldstart_child_main())", npz, str(prewarm),
           device]
    proc = subprocess.run(cmd, env=_child_env(root), capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"cold-start child (prewarm {prewarm}) "
                             f"failed:\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    line = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("COLDSTART ")][-1]
    return json.loads(line[len("COLDSTART "):])


def coldstart_phase(eng, li, li_codes, kept, sf, infra, q1_args,
                    q1_rows, q6_rows) -> dict:
    """Phase 17 on the SF1 engine after phase 9 (lineitem as loaded):
    (a) the parity gate's verdicts, the MIN/MAX GROUP BY and the MIN/MAX
    TPC-H queries under `auto`; (b) the launch-point sweep; (c) the
    plan shape cache on Q6's literal sets; (d) two cold-start child
    processes. Returns its numbers, with "launches" (kernel 1's and
    kernel 2's in this process's counted runs) and "path_checks"."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from cockroach_tpu_torch.exec import coldstart
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import autotune, paritygate
    from cockroach_tpu_torch.ops.cuda import groupagg as tg
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    from cockroach_tpu_torch.ops.cuda.groupagg_large_check import (
        compare_plain)
    on_card = eng.device.type == "cuda"
    t_start = time.perf_counter()
    key = eng._device_key
    d = eng._compile_cache_dir
    launches = {"groupagg_large": 0, "groupagg": 0}
    checks: dict = {}
    out: dict = {"card": _smi() if on_card else "cpu"}

    def counted(label, sql, session=None, point=None):
        _counts_zero()
        with recording_slots() as calls:
            res = eng.execute(sql, session)
            _sync()
        n1 = tgl.LAUNCHES if on_card else tgl.PLAIN_CALLS
        n2 = tg.LAUNCHES if on_card else tg.PLAIN_CALLS
        launches["groupagg_large"] += n1
        launches["groupagg"] += n2
        if on_card and n1:
            checks[label] = check_calls(label, calls, n1, point)
        return res, n1

    # -- (a) the parity gate ------------------------------------------------
    point0 = engine_point(eng.device)
    if list(point0) != list(infra["point"]):
        raise AssertionError(f"the engine's point {point0} != phase 1's "
                             f"{infra['point']}")
    exact = paritygate.promoted(key, d, eng.device, point0)
    if tuple(infra["exact_paths"]) != exact:
        raise AssertionError(f"the engine's verdicts {exact} != phase 1's "
                             f"{infra['exact_paths']}")
    t0 = time.perf_counter()
    again = paritygate.fuzz(key, None, eng.device, point0)
    out["gate"] = {"promoted": list(exact), "fuzz_again": list(again),
                   "fuzz_s": time.perf_counter() - t0,
                   "phase1_fuzz_s": infra["fuzz_s"]}
    print("parity gate on the card: " + json.dumps(out["gate"]), flush=True)
    if again != exact:
        raise AssertionError(f"a second fuzz gave {again}, not {exact}")
    want_mm = 1 if "int_minmax" in exact else 0
    res, n1 = counted("minmax group by", MINMAX_GROUP_BY)
    got = sorted(tuple(r) for r in res.rows)
    want = minmax_oracle(li)
    if n1 != want_mm:
        raise AssertionError(f"the MIN/MAX GROUP BY launched kernel 1 {n1} "
                             f"times under auto, not {want_mm}")
    if [(int(a), float(b), int(c), float(e)) for a, b, c, e in got] != want:
        raise AssertionError("the MIN/MAX GROUP BY rows != numpy")
    s_off = eng.session()
    s_off.vars.set("pallas_groupagg", "off")
    if sorted(tuple(r) for r in eng.execute(MINMAX_GROUP_BY, s_off).rows) \
            != got:
        raise AssertionError("the MIN/MAX GROUP BY under off != auto")
    out["minmax_group_by"] = {"groups": len(got), "rows_in": int(
        eng.store.table("lineitem").row_count), "launches": n1,
        "ms": _median_ms(lambda: eng.execute(MINMAX_GROUP_BY), reps=3),
        "off_ms": _median_ms(lambda: eng.execute(MINMAX_GROUP_BY, s_off),
                             reps=3)}
    out["minmax_queries"] = {}
    for q in MINMAX_QUERIES:
        res, n1 = counted(f"{q} minmax", tpch.QUERIES[q])
        err = check_result(q.upper(), res, kept["want"][q])
        if n1 != want_mm:
            raise AssertionError(f"{q} launched kernel 1 {n1} times under "
                                 f"auto, not {want_mm}")
        if eng.execute(tpch.QUERIES[q], s_off).rows != res.rows:
            raise AssertionError(f"{q} under off != auto")
        # `off` is the route these queries took before the gate: no
        # kernel-1 launch
        out["minmax_queries"][q] = {
            "launches": n1, "max_rel_err": err,
            "ms": _median_ms(lambda q=q: eng.execute(tpch.QUERIES[q]),
                             reps=3),
            "off_ms": _median_ms(
                lambda q=q: eng.execute(tpch.QUERIES[q], s_off), reps=3)}
    print("MIN/MAX under auto: " + json.dumps(
        {"group_by": out["minmax_group_by"],
         "queries": out["minmax_queries"]}), flush=True)

    # -- (b) the launch-point sweep -----------------------------------------
    gid, sel, slots, G, rep = q1_args[:5]
    n = gid.shape[0]

    def q1_slots(p):
        """Q1's captured slots with each i64 sum's limbs re-cut to the
        point's exactness bound (the same bits)."""
        wmax = tgl.limb_width(n, n, block_rows=p[0] * p[1], cap=p[3])
        out_s = []
        for s in slots:
            if s.kind == "i64sum" and s.w > wmax:
                s = tgl.i64sum(s.value, s.mask, wmax,
                               min(-(-(s.w * s.k) // wmax), -(-64 // wmax)))
            out_s.append(s)
        return tuple(out_s)

    def q1_workload(p):
        sp = q1_slots(p)
        return lambda: tgl.aggregate_slots(gid, sel, sp, G, rep, point=p)

    # the sweep (what `on` runs, plus Q1's slots) persists under a root
    # of its own: the run's main path keeps the point phase 1 resolved,
    # and the tuned Q1 below reads the winner back from there
    d_tune = os.path.join(d, "sweep")
    os.makedirs(d_tune, exist_ok=True)
    shutil.copy(paritygate.table_path(d), d_tune)
    runs0 = autotune.RUNS.value("sweep")
    sweep = autotune.autotune(key, d_tune, eng.device,
                              workloads=(q1_workload,))
    shapes = autotune.CUDA_SHAPES if on_card else autotune.CPU_SHAPES
    points = {}
    for p in autotune.CANDIDATES:
        name = autotune.point_name(p)
        rec = {"ms": sweep.timings[name] * 1e3}
        cases = [(f"synthetic {n_s}x{g_s}",
                  autotune.synthetic_slots(p, n_s, g_s, eng.device))
                 for n_s, g_s in shapes]
        cases.append(("q1", (gid, sel, q1_slots(p), G, rep)))
        for label, case in cases:
            args = (*case, p)
            before = tgl.LAUNCHES
            res_p = tgl.aggregate_slots(*args)
            _sync()
            if on_card and tgl.LAUNCHES != before + 1:
                raise AssertionError(f"point {name} did not launch once")
            rec[label] = compare_plain(args, res_p)
            del args, case, res_p
        points[name] = rec
    out["sweep"] = {"winner": autotune.point_name(sweep.best),
                    "margin": autotune.MARGIN,
                    "phase1_point": autotune.point_name(infra["point"]),
                    "points": points}
    print(f"launch-point sweep [{out['card']}]: "
          + json.dumps(out["sweep"]), flush=True)
    # Q1 under the tuned point against the shipped point, bit for bit
    def drop_plans():
        with eng._cache_lock:
            for k in list(eng._exec_cache):
                del eng._exec_cache[k]

    def fresh_q1(session, point):
        drop_plans()
        seen = []
        kernel = tgl.aggregate_slots

        def recording(*args, **kw):
            seen.append(kw.get("point"))
            return kernel(*args, **kw)
        tgl.aggregate_slots = recording
        try:
            rows = counted("q1 " + str(session.vars.get("pallas_autotune")),
                           tpch.Q1, session, point)[0].rows
        finally:
            tgl.aggregate_slots = kernel
        return rows, seen

    autotune.forget()
    s_ship = eng.session()
    s_ship.vars.set("pallas_autotune", "off")
    shipped, seen_ship = fresh_q1(s_ship, autotune.DEFAULT)
    # the gate's verdict at the winner, fuzzed outside the counted run
    # when the winner is not the shipped point
    out["sweep"]["gate_at_winner"] = list(paritygate.promoted(
        key, d_tune, eng.device, sweep.best))
    h0 = autotune.TABLE.value("hit")
    eng._compile_cache_dir = d_tune
    try:
        tuned, seen_tuned = fresh_q1(eng.session(), sweep.best)
    finally:
        # later statements plan at the run's point again
        eng._compile_cache_dir = d
        drop_plans()
    if shipped != tuned or tuned != q1_rows:
        raise AssertionError("Q1 under the tuned point != the shipped "
                             "point's rows")
    # the first recorded call is the query's (the rest are its checks)
    if seen_ship[:1] != [autotune.DEFAULT] or \
            seen_tuned[:1] != [sweep.best]:
        raise AssertionError(f"Q1 ran at {seen_ship} and {seen_tuned}")
    if autotune.TABLE.value("hit") != h0 + 1 or \
            autotune.RUNS.value("sweep") != runs0 + 1:
        raise AssertionError("the tuned point was not read back from the "
                             "table without a sweep")
    out["sweep"]["q1_tuned_equals_shipped"] = True

    # -- (c) the plan shape cache --------------------------------------------
    s = eng.session()
    m0, h0 = eng.plan_cache["miss"], eng.plan_cache["hit"]
    q6 = []
    for y, dsc, qty in Q6_LITERALS:
        res, _ = counted(f"q6 {y}", Q6_SHAPE.format(y=y, d=dsc, q=qty), s)
        want6 = q6_oracle(li, y, dsc, qty)
        if not _close(res.rows[0][0], want6, 1e-9):
            raise AssertionError(f"Q6 ({y}, {dsc}, {qty}) {res.rows[0][0]} "
                                 f"!= oracle {want6}")
        q6.append(res.rows[0][0])
    misses = eng.plan_cache["miss"] - m0
    hits = eng.plan_cache["hit"] - h0
    if (misses, hits) != (1, 4):
        raise AssertionError(f"Q6's five literal sets: {misses} misses, "
                             f"{hits} hits, not 1 and 4")
    s_text = eng.session()
    s_text.vars.set("plan_shape_cache", "off")
    host = {}
    for mode, sess, lits in (("off", s_text, Q6_TIMED[:3]),
                             ("on", s, Q6_TIMED[3:])):
        ms = []
        for y, dsc, qty in lits:
            t0 = time.perf_counter()
            eng.execute(Q6_SHAPE.format(y=y, d=dsc, q=qty), sess)
            ms.append((time.perf_counter() - t0) * 1e3)
        host[f"new_literals_{mode}_ms"] = statistics.median(ms)
    out["plan_shape_cache"] = dict(host, revenue=q6, misses=misses,
                                   hits=hits)
    print("plan shape cache, Q6 literal sets: "
          + json.dumps(out["plan_shape_cache"]), flush=True)

    # -- (d) cold start in two child processes --------------------------------
    tmp = tempfile.mkdtemp(prefix="chip-smoke-cold-")
    try:
        npz = os.path.join(tmp, "lineitem.npz")
        cols = {c: li_codes.get(c, li[c]) for c in COLD_COLUMNS}
        np.savez(npz, **cols)
        root = os.path.join(tmp, "root")
        child_dir = coldstart.cache_dir(root, eng.device)
        os.makedirs(child_dir)
        # a restarted node keeps its tuning and verdict tables: those of
        # the sweep's root, the verdict there fuzzed at the tuned point
        for f in (autotune.table_path(d_tune),
                  paritygate.table_path(d_tune)):
            shutil.copy(f, child_dir)
        dev = eng.device.type
        cold = _run_child(npz, 0, root, dev)
        warm = _run_child(npz, COLD_PREWARM, root, dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want_rows = {"q1": [[str(v) for v in r] for r in q1_rows],
                 "q6": [[str(v) for v in r] for r in q6_rows]}
    for c in (cold, warm):
        for q in ("q1", "q6"):
            if c.pop(f"{q}_rows") != want_rows[q]:
                raise AssertionError(f"child (prewarm {c['prewarm']}) {q} "
                                     "rows != phase 2's")
        if c["q1_launches"]["groupagg_large"] != 1:
            raise AssertionError("a child's Q1 did not launch kernel 1 once")
    if cold["q1_hit"] != 0 or warm["warmed"] != 2 or warm["q1_hit"] != 1 \
            or warm["q6_hit"] != 1 or warm["prewarm_errors"]:
        raise AssertionError(f"cold start: unwarmed {cold}, warmed {warm}")
    checks["child q1 unwarmed"] = cold.pop("q1_checks")
    checks["child q1 warmed"] = warm.pop("q1_checks")
    cold.pop("q6_checks")
    warm.pop("q6_checks")
    out["coldstart"] = {"unwarmed": cold, "warmed": warm}
    print("cold start (children): " + json.dumps(out["coldstart"]),
          flush=True)
    out["launches"] = launches
    out["child_launches"] = {
        "groupagg_large": sum(c[f"{q}_launches"]["groupagg_large"]
                              for c in (cold, warm) for q in ("q1", "q6")),
        "groupagg": sum(c[f"{q}_launches"]["groupagg"]
                        for c in (cold, warm) for q in ("q1", "q6"))}
    out["path_checks"] = checks
    out["seconds"] = time.perf_counter() - t_start
    return out


def coldstart_phase_alone(sf: float = SF, device=None,
                          rows: int | None = None) -> dict:
    """Phase 17 by itself on the card: builds the kernels, resolves the
    gate and the launch point under a fresh cache root, loads every
    TPC-H table at `sf`, runs phase 2's Q1 and Q6 (capturing Q1's slots)
    and phase 7's Q2 oracle, then phase 17. Prints its JSON line."""
    import numpy as np

    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import build
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    with cache_root():
        if device is None:
            build.compile_all(["groupagg_large", "groupagg"])
        infra = kernel_infra(device or "cuda")
        eng = Engine(device=device)
        tpch.load(eng, sf=sf, tables=tpch.ALL_TABLES, encoded=True,
                  rows=rows)
        li = tpch.gen_lineitem(sf, encoded=True, rows=rows)
        codes = {c: li[c].copy() for c in ("l_returnflag", "l_linestatus")}
        captured = {}
        kernel = tgl.aggregate_slots

        def recording(*args, **kw):
            captured.setdefault("q1", (args, kw))
            return kernel(*args, **kw)
        tgl.aggregate_slots = recording
        try:
            q1_rows = eng.execute(tpch.Q1).rows
        finally:
            tgl.aggregate_slots = kernel
        q6_rows = eng.execute(tpch.Q6).rows
        tables = _oracle_tables(dict(li, **{
            c: np.asarray(v, dtype=object)[li[c]] for c, v in
            (("l_returnflag", tpch.RF_VALUES),
             ("l_linestatus", tpch.LS_VALUES),
             ("l_shipinstruct", tpch.SHIPINSTRUCT),
             ("l_shipmode", tpch.SHIPMODES))}), sf)
        kept = {"want": {q: tpch.oracle_rows(q, tables)
                         for q in MINMAX_QUERIES}}
        out = coldstart_phase(eng, li, codes, kept, sf, infra,
                              slot_args(captured, "q1"), q1_rows, q6_rows)
        eng.close()
        _sync()
    print(json.dumps({"coldstart": out}), flush=True)
    return out


# -- 18. distributed aggregation over a shard mesh ----------------------------

DIST_SHARDS = 4                 # slots of the mesh, all on one card
DIST_REPS = 5                   # warm pairs (distributed, local) a query
HG_ROWS = 6_000_000             # tests/test_dist_hash_groupby.py's hg table
HG_KEYS = 100_000
# its keys spread past a span of 2^21, so that the GROUP BY takes the
# hash strategy (the test's keys 0..99,999 plan densely)
HG_SPREAD = (1 << 22) + 1
HG_REPS = 3                     # warm pairs of the hg GROUP BY
HG_DDL = "CREATE TABLE hg (k INT8 NOT NULL, v INT8, f FLOAT)"
HG_SQL = "SELECT k, sum(v) AS s, count(*) AS c FROM hg GROUP BY k"


def hg_columns(rows: int = HG_ROWS, keys: int = HG_KEYS) -> dict:
    import numpy as np
    rng = np.random.default_rng(7)
    return {"k": rng.integers(0, keys, size=rows).astype(np.int64)
            * HG_SPREAD,
            "v": rng.integers(-1000, 1000, size=rows).astype(np.int64),
            "f": rng.random(rows)}


def hg_oracle(cols: dict) -> list:
    """HG_SQL by numpy: (k, sum(v), count(*)) sorted by k."""
    import numpy as np
    keys, inv = np.unique(cols["k"], return_inverse=True)
    sums = np.zeros(len(keys), dtype=np.int64)
    np.add.at(sums, inv, cols["v"])
    return [(int(k), int(s), int(c)) for k, s, c in
            zip(keys, sums, np.bincount(inv))]


def distributed_phase(src, want: dict, exact_paths,
                      reps: int = DIST_REPS, hg_rows: int = HG_ROWS,
                      hg_reps: int = HG_REPS) -> dict:
    """Phase 18 on the SF1 tables of ``src`` (lineitem and part as
    loaded): an Engine over the same store on a mesh of DIST_SHARDS
    slots of ``src``'s device. Q1, Q6, Q14, MINMAX_GROUP_BY and, under
    `on`, Q1F and Q6F run distributed and with distsql = off, each with
    every count set to 0 just before it and read just after; the hg
    GROUP BY takes the hash route through the exchange. Rows equal the
    local run's and the oracles in ``want`` (q1, q6, q14, minmax); kernel
    1 launches once a shard for Q1 (and for the MIN/MAX GROUP BY where
    ``exact_paths`` holds int_minmax), kernel 2 once a shard for Q1F and
    Q6F, each launch held against its plain version at its shard's
    inputs; Q1 once more on 2-slot sub-meshes; no CollectiveFault retry;
    the dispatchers' queues empty. Then warm pairs, the host ms and the
    device idle share of each query both ways, and kernel 1's and kernel
    2's numbers at one shard's Q1 and Q1F inputs. Returns its numbers,
    with "launches", "timed_launches", "path_checks" and
    "small_checks"."""
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import groupagg as tg
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    from cockroach_tpu_torch.parallel.mesh import make_mesh
    t_start = time.perf_counter()
    dev = src.device
    on_card = dev.type == "cuda"
    eng = Engine(store=src.store, mesh=make_mesh([dev] * DIST_SHARDS))
    out: dict = {"card": _smi() if on_card else "cpu",
                 "shards": DIST_SHARDS, "queries": {}}
    launches = {"groupagg_large": 0, "groupagg": 0}
    large_checks: dict = {}
    small_checks: dict = {}
    first: dict = {}
    dispatches = eng.metrics.counter("exec.allreduce.calls")
    sessions = {}
    for dist in ("auto", "off"):
        for mode in ("auto", "on"):
            s = eng.session()
            s.vars.set("distsql", dist)
            s.vars.set("pallas_groupagg", mode)
            sessions[dist, mode] = s

    def counted(label, sql, dist, mode="auto"):
        _counts_zero()
        d0 = dispatches.value()
        with recording_slots() as calls, recording_small() as scalls:
            res = eng.execute(sql, sessions[dist, mode])
            _sync()
        n1, n2 = _kernel_counts(on_card)
        launches["groupagg_large"] += n1
        launches["groupagg"] += n2
        first.setdefault(label, (calls[:1], scalls[:1]))
        if on_card and n1:
            large_checks[f"sf1 {label} phase 18"] = check_calls(
                label, calls, n1)
        if on_card and n2:
            small_checks[label] = _check_small_calls(label, scalls, n2)
        tot = eng.last_exec["all"]
        return res, {"groupagg_large": n1, "groupagg": n2,
                     "dispatches": dispatches.value() - d0,
                     "group_ids": tot["group_ids"],
                     "partitioned": list(tot["partitioned"])}

    def expect(label, route, **want_route):
        got = {k: route[k] for k in want_route}
        if got != want_route:
            raise AssertionError(f"phase 18 {label}: route {got}, want "
                                 f"{want_route}")

    t0 = time.perf_counter()
    eng.execute(HG_DDL)
    hg = hg_columns(hg_rows)
    eng.store.insert_columns("hg", hg, eng.clock.now())
    want = dict(want, hg=hg_oracle(hg))
    del hg
    out["hg_load_s"] = time.perf_counter() - t0
    mm = 1 if "int_minmax" in exact_paths else 0
    n = DIST_SHARDS
    cases = {
        "q1": (tpch.Q1, "auto", {"groupagg_large": n, "groupagg": 0}),
        "q6": (tpch.Q6, "auto", {"groupagg_large": 0, "groupagg": 0}),
        "q14": (tpch.Q14, "auto", {"groupagg_large": 0, "groupagg": 0}),
        "minmax": (MINMAX_GROUP_BY, "auto",
                   {"groupagg_large": mm * n, "groupagg": 0}),
        "q1f": (tpch.Q1F, "on", {"groupagg_large": 0, "groupagg": n}),
        "q6f": (tpch.Q6F, "on", {"groupagg_large": 0, "groupagg": n}),
        "hg": (HG_SQL, "auto", {"groupagg_large": 0, "groupagg": 0}),
    }
    rows = {}
    for q, (sql, mode, kern) in cases.items():
        t0 = time.perf_counter()
        dres, droute = counted(q, sql, "auto", mode)
        first_s = time.perf_counter() - t0
        lres, lroute = counted(f"{q} local", sql, "off", mode)
        # one dispatch, and one more a partition of a partitioned re-run
        expect(q, droute, dispatches=1 + sum(droute["partitioned"]),
               **kern)
        expect(f"{q} local", lroute, dispatches=0)
        if q == "hg":
            # the hash route through the exchange, on every shard
            if droute["group_ids"] < 2:
                raise AssertionError(f"phase 18 hg: group_ids "
                                     f"{droute['group_ids']}, no exchange")
            got = sorted(tuple(r) for r in dres.rows)
            if got != want["hg"] or sorted(
                    tuple(r) for r in lres.rows) != got:
                raise AssertionError("phase 18 hg: rows != numpy or local")
            err = 0.0
        else:
            rel = 1e-5 if mode == "on" else 1e-9
            err = same_result(f"phase 18 {q} distributed vs local", dres,
                              lres, rel)
            if q == "q1":
                check_q1(dres.rows, want["q1"])
            elif q in ("q6", "q14"):
                if not _close(dres.rows[0][0], want[q], 1e-9):
                    raise AssertionError(f"phase 18 {q}: {dres.rows[0][0]} "
                                         f"!= oracle {want[q]}")
            elif q == "minmax":
                got = sorted((int(a), float(b), int(c), float(e))
                             for a, b, c, e in dres.rows)
                if got != want["minmax"]:
                    raise AssertionError("phase 18 minmax: rows != numpy")
            else:
                check_float(f"phase 18 {q}", dres.rows,
                            want["q1"] if q == "q1f" else [(want["q6"],)])
        rows[q] = dres.rows
        out["queries"][q] = {"route": droute, "local_route": lroute,
                             "first_run_s": first_s,
                             "dist_vs_local_max_rel_err": err}
        print(f"phase 18 {q}: " + json.dumps(out["queries"][q]), flush=True)

    # Q1 on the pool's 2-slot sub-meshes
    pool = eng._submesh_pool()
    p0 = pool.dispatches
    eng.settings.set("sql.exec.submesh.size", "2")
    try:
        res, route = counted("q1 submesh 2", tpch.Q1, "auto")
    finally:
        eng.settings.set("sql.exec.submesh.size", "auto")
    expect("q1 submesh 2", route, groupagg_large=2, dispatches=1)
    if pool.dispatches != p0 + 1 or res.rows != rows["q1"]:
        raise AssertionError("phase 18: Q1 on a 2-slot sub-mesh did not "
                             "route there or gave other rows")
    out["submesh2_q1"] = route
    retries = eng.metrics.counter(
        "sql.distsql.collective_fault.retries").value()
    depth = eng.devstats.dispatch_depth()
    if retries or depth:
        raise AssertionError(f"phase 18: {retries} CollectiveFault "
                             f"retries, dispatcher depth {depth}")
    out.update(collective_fault_retries=retries, dispatcher_depth=depth)

    # warm pairs in one process, and the card's busy time of each way
    t_timed = time.perf_counter()
    _counts_zero()
    out["timed"] = {}
    for q, (sql, mode, _) in cases.items():
        n_reps = hg_reps if q == "hg" else reps
        ms = {"auto": [], "off": []}
        for _ in range(n_reps):
            for dist in ("auto", "off"):
                _sync()
                t0 = time.perf_counter()
                eng.execute(sql, sessions[dist, mode])
                _sync()
                ms[dist].append((time.perf_counter() - t0) * 1e3)
        rec = {}
        for dist, name in (("auto", "distributed"), ("off", "local")):
            med = statistics.median(ms[dist])
            busy = (_device_busy_ms(
                lambda: eng.execute(sql, sessions[dist, mode]), 2)
                if on_card else 0.0)
            rec[name] = {"median_ms": med, "runs_ms": ms[dist],
                         "device_busy_ms": busy,
                         "host_ms": med - busy,
                         "idle_share": max(0.0, 1.0 - busy / med)}
        out["timed"][q] = rec
        print(f"phase 18 timed {q}: " + json.dumps(rec), flush=True)
    # Q1 on the 2-slot sub-meshes, in pairs with the full mesh: the host
    # cost a shard adds
    ms2 = {"2": [], "4": []}
    for _ in range(reps):
        for size, setting in (("2", "2"), ("4", "off")):
            eng.settings.set("sql.exec.submesh.size", setting)
            _sync()
            t0 = time.perf_counter()
            eng.execute(tpch.Q1, sessions["auto", "auto"])
            _sync()
            ms2[size].append((time.perf_counter() - t0) * 1e3)
    eng.settings.set("sql.exec.submesh.size", "auto")
    out["timed"]["q1_by_shards"] = {
        f"{k}_shards_median_ms": statistics.median(v)
        for k, v in ms2.items()}
    print("phase 18 timed Q1 by shard count: "
          + json.dumps(out["timed"]["q1_by_shards"]), flush=True)
    out["timed_launches"] = dict(zip(("groupagg_large", "groupagg"),
                                     _kernel_counts(on_card)))
    out["timed_s"] = time.perf_counter() - t_timed

    # the kernels at one shard's inputs
    if on_card:
        q1_call = first["q1"][0][0]
        q1f_call = first["q1f"][1][0]
        out["shard_numbers"] = {
            "q1": slot_numbers(tgl, q1_call),
            "q1f": small_numbers(tg, q1f_call, "Q1F shard")}
        print("phase 18 kernel 1 at a Q1 shard: "
              + json.dumps(out["shard_numbers"]["q1"]), flush=True)
    eng.execute("DROP TABLE hg")
    eng.close()
    out["launches"] = launches
    out["path_checks"] = large_checks
    out["small_checks"] = small_checks
    out["seconds"] = time.perf_counter() - t_start
    return out


def distributed_phase_alone(sf: float = SF, device=None,
                            rows: int | None = None,
                            hg_rows: int = HG_ROWS) -> dict:
    """Phase 18 by itself on the card: builds the kernels, resolves the
    gate and the launch point under a fresh cache root, loads lineitem
    and part at `sf`, then runs phase 18. Prints its JSON line."""
    import numpy as np

    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import build
    with cache_root():
        if device is None:
            build.compile_all(["groupagg_large", "groupagg"])
        infra = kernel_infra(device or "cuda")
        src = Engine(device=device)
        tpch.load(src, sf=sf, tables=("lineitem", "part"), encoded=True,
                  rows=rows)
        li = tpch.gen_lineitem(sf, encoded=True, rows=rows)
        for c, vals in (("l_returnflag", tpch.RF_VALUES),
                        ("l_linestatus", tpch.LS_VALUES)):
            li[c] = np.asarray(vals)[li[c]]
        part = tpch.gen_part(sf)
        want = {"q1": tpch.ref_q1(li), "q6": tpch.ref_q6(li),
                "q14": tpch.ref_q14(li, part), "minmax": minmax_oracle(li)}
        out = distributed_phase(src, want, infra["exact_paths"],
                                hg_rows=hg_rows)
        src.close()
        _sync()
    for k in ("path_checks", "small_checks"):
        out[k] = len(out[k])
    print(json.dumps({"distributed": out}), flush=True)
    return out


FLOW_NODES = 4                  # data nodes of phase 19, all on one card
FLOW_REPS = 5                   # warm pairs (gateway, one engine) a query
FLOW_BUDGET = 8 << 30           # each phase 19 engine's device budget
FLOW_PARTKEY_MAX = 40_000       # the l_partkey GROUP BY's range (node
                                # hash tables stay under half their slots)
FLOW_SHIPDATE = "1995-03-15"    # the adaptive GROUP BY's one ship date
FLOW_GROUPBY = ("SELECT l_partkey, count(*) AS c, sum(l_quantity) AS sq "
                "FROM lineitem WHERE l_partkey <= "
                f"{FLOW_PARTKEY_MAX} GROUP BY l_partkey "
                "ORDER BY l_partkey")
FLOW_RAW = ("SELECT l_orderkey, l_linenumber, count(*) AS c, "
            "sum(l_quantity) AS sq FROM lineitem WHERE l_shipdate = "
            f"DATE '{FLOW_SHIPDATE}' GROUP BY l_orderkey, l_linenumber "
            "ORDER BY l_orderkey, l_linenumber")
FLOW_PARTIAL = ("SELECT l_linenumber, count(*) AS c, sum(l_quantity) AS sq "
                "FROM lineitem GROUP BY l_linenumber ORDER BY l_linenumber")


def flow_oracles(li) -> dict:
    """numpy rows of phase 19's own statements over lineitem ``li``
    (numeric columns as generated; DECIMAL sums as floats)."""
    import datetime

    import numpy as np
    out = {}
    pk, qty = li["l_partkey"], li["l_quantity"]
    m = pk <= FLOW_PARTKEY_MAX
    keys, inv = np.unique(pk[m], return_inverse=True)
    out["groupby"] = list(zip(keys.tolist(),
                              np.bincount(inv).tolist(),
                              np.bincount(inv, weights=qty[m]).tolist()))
    day = (datetime.date.fromisoformat(FLOW_SHIPDATE)
           - datetime.date(1970, 1, 1)).days
    m = li["l_shipdate"] == day
    pairs = np.stack([li["l_orderkey"][m], li["l_linenumber"][m]], axis=1)
    keys, inv = np.unique(pairs, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    out["raw"] = list(zip(keys[:, 0].tolist(), keys[:, 1].tolist(),
                          np.bincount(inv).tolist(),
                          np.bincount(inv, weights=qty[m]).tolist()))
    keys, inv = np.unique(li["l_linenumber"], return_inverse=True)
    out["partial"] = list(zip(keys.tolist(), np.bincount(inv).tolist(),
                              np.bincount(inv, weights=qty).tolist()))
    return out


def _oracle_rows(label, got, want, rel=1e-9) -> None:
    if len(got) != len(want):
        raise AssertionError(f"phase 19 {label}: {len(got)} rows, numpy "
                             f"{len(want)}")
    for g_row, w_row in zip(got, want):
        for g, w in zip(g_row, w_row):
            if not _close(float(g), float(w), rel):
                raise AssertionError(f"phase 19 {label}: {g_row} != numpy "
                                     f"{w_row}")


def _fabric(device, li_codes, part, parts_sharded: bool, budget: int):
    """A gateway (node 0, no lineitem rows) over FLOW_NODES data nodes on
    ``device``, each a port Engine over its own store holding a
    contiguous quarter of lineitem (dictionary codes under the
    generator's dictionaries) and part whole (every node, the gateway
    too) or quartered over the data nodes."""
    from cockroach_tpu_torch.distsql.node import DistSQLNode
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.kvserver.transport import LocalTransport
    from cockroach_tpu_torch.models import tpch
    transport = LocalTransport()
    n = len(li_codes["l_orderkey"])
    n_part = len(part["p_partkey"])
    nodes, engines = [], []
    for i in range(FLOW_NODES + 1):
        eng = Engine(device=device)
        eng.settings.set("sql.exec.hbm_budget_bytes", budget)
        eng.execute(tpch.DDL["lineitem"])
        eng.execute(tpch.DDL["part"])
        for cn, vals in tpch.LINEITEM_DICTS.items():
            eng.store.set_dictionary("lineitem", cn, vals)
        ts = eng.clock.now()
        if i > 0:
            lo, hi = n * (i - 1) // FLOW_NODES, n * i // FLOW_NODES
            eng.store.insert_columns(
                "lineitem", {k: v[lo:hi] for k, v in li_codes.items()}, ts)
        if not parts_sharded:
            eng.store.insert_columns("part", part, ts)
        elif i > 0:
            lo = n_part * (i - 1) // FLOW_NODES
            hi = n_part * i // FLOW_NODES
            eng.store.insert_columns(
                "part", {k: v[lo:hi] for k, v in part.items()}, ts)
        engines.append(eng)
        nodes.append(DistSQLNode(i, eng, transport))
    return nodes, engines


SOCKET_REPS = 3                 # phase 19's warm runs over sockets


class _SocketFabric:
    """Port DistSQLNodes over ``engines``, each on its own SocketTransport
    (rpc/context.py) with a pump thread for every data node, all in this
    process: the reference's socket_fakedist shape. Node 0 is the
    gateway's, pumped by the gateway's own waits."""

    def __init__(self, engines):
        import threading

        from cockroach_tpu_torch.distsql.node import DistSQLNode
        from cockroach_tpu_torch.rpc.context import SocketTransport
        self.transports = [SocketTransport(i) for i in range(len(engines))]
        for a in self.transports:
            for b in self.transports:
                if a is not b:
                    a.connect(b.node_id, b.addr)
        self.nodes = [DistSQLNode(i, e, t) for i, (e, t) in
                      enumerate(zip(engines, self.transports))]
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._pump, args=(t,),
                                          daemon=True)
                         for t in self.transports[1:]]
        for th in self._threads:
            th.start()

    def _pump(self, t):
        while not self._stop.is_set():
            if not t.deliver_all():
                time.sleep(0.0005)

    def close(self):
        self._stop.set()
        for th in self._threads:
            th.join(timeout=30)
        for t in self.transports:
            t.close()


class _FlowClock:
    """Wall seconds of one flow statement's pieces, by wrapping the
    flow modules' functions while it runs: the nodes' stage runs and
    their output pulls (``stage_s``: device work, launched and
    synchronized by the pull), the wire's encode and decode
    (``serde_s``), the gateway's pump and union (``pump_s``, which holds
    the in-process transport's stage runs and serde) and its final
    stage (``final_s``)."""

    def __init__(self):
        self.t = {"stage_s": 0.0, "serde_s": 0.0, "pump_s": 0.0,
                  "final_s": 0.0}

    def _wrap(self, owner, name, key):
        fn = getattr(owner, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.t[key] += time.perf_counter() - t0
        setattr(owner, name, timed)
        return owner, name, fn

    @contextlib.contextmanager
    def running(self):
        from cockroach_tpu_torch.distsql import node as pnode
        from cockroach_tpu_torch.distsql import serde
        saved = [self._wrap(pnode.DistSQLNode, "_run", "stage_s"),
                 self._wrap(pnode, "_pull_output", "stage_s"),
                 self._wrap(serde, "encode_columns", "serde_s"),
                 self._wrap(serde, "decode_columns", "serde_s"),
                 self._wrap(pnode.Gateway, "_pump_and_union", "pump_s"),
                 self._wrap(pnode.Gateway, "_run_final", "final_s")]
        try:
            yield self.t
        finally:
            for owner, name, fn in saved:
                setattr(owner, name, fn)
            # the gateway's final stage pulls through _pull_output only
            # for a raw fold; the pump holds the nodes' stages and serde
            self.t["pump_other_s"] = max(
                0.0, self.t["pump_s"] - self.t["stage_s"]
                - self.t["serde_s"])


def flows_phase(src, li_codes, part, want: dict, reps: int = FLOW_REPS,
                budget: int = FLOW_BUDGET) -> dict:
    """Phase 19: DistSQL flows between engines. FLOW_NODES data nodes and
    a gateway, port Engines on ``src``'s device over LocalTransport, each
    holding a contiguous quarter of lineitem (``li_codes``: every
    dictionary column as codes) and ``part`` replicated (gateway A) or
    quartered (gateway B, the graph flow). Through Gateway.run, each with
    every count set to 0 just before it and read just after: Q1, Q6 and
    Q14 on A (Q14 with join-filter frames shipped), Q14 on B (the
    sharded x sharded join: two exchange stages), FLOW_GROUPBY through
    _decompose_groupby (A with prefer_shuffle), Q1F and Q6F under
    `on`, and the adaptive stage: FLOW_RAW (every node ships raw rows)
    and FLOW_PARTIAL (every node keeps partials). Rows equal ``src``'s
    (one engine over the whole tables) and the numpy oracles in
    ``want``; kernel 1 launches once a data node for Q1 (kernel 2 none),
    kernel 2 once a data node for Q1F and Q6F (kernel 1 none), each
    launch held against its plain version at its node's inputs;
    shuffle.bytes.received > 0 and no inbox left in any registry. Then
    warm pairs through the gateway and on ``src``, both ways' device
    busy ms (torch.profiler), host ms and idle share, the pieces of one
    flow statement (_FlowClock), and kernel 1's numbers at one node's Q1
    slots. Returns its numbers, with "launches", "timed_launches",
    "path_checks" and "small_checks"."""
    import gc as _gc

    from cockroach_tpu_torch.distsql.node import Gateway
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    t_start = time.perf_counter()
    dev = src.device
    on_card = dev.type == "cuda"
    out: dict = {"card": _smi() if on_card else "cpu",
                 "nodes": FLOW_NODES, "budget": budget, "queries": {}}
    t0 = time.perf_counter()
    nodes_a, engines_a = _fabric(dev, li_codes, part, False, budget)
    nodes_b, engines_b = _fabric(dev, li_codes, part, True, budget)
    out["load_s"] = time.perf_counter() - t0
    data = list(range(1, FLOW_NODES + 1))
    gw = Gateway(nodes_a[0], data, replicated_tables={"part"})
    gw_shuffle = Gateway(nodes_a[0], data, replicated_tables={"part"},
                         prefer_shuffle=True)
    gw_sharded = Gateway(nodes_b[0], data)
    s_on = src.session()
    src.execute("SET pallas_groupagg = on", s_on)
    engines = engines_a + engines_b
    launches = {"groupagg_large": 0, "groupagg": 0}
    large_checks: dict = {}
    small_checks: dict = {}
    first: dict = {}

    def msum(name, engs=engines) -> float:
        return sum(m.value() for e in engs
                   if (m := e.metrics.get(name)) is not None)

    n = FLOW_NODES
    cases = {
        "q1": (gw, tpch.Q1, None, {"groupagg_large": n, "groupagg": 0}),
        "q6": (gw, tpch.Q6, None, {"groupagg_large": 0, "groupagg": 0}),
        "q14": (gw, tpch.Q14, None, {"groupagg_large": 0, "groupagg": 0}),
        "q14_sharded": (gw_sharded, tpch.Q14, None,
                        {"groupagg_large": 0, "groupagg": 0}),
        "groupby": (gw_shuffle, FLOW_GROUPBY, None,
                    {"groupagg_large": 0, "groupagg": 0}),
        "q1f": (gw, tpch.Q1F, s_on, {"groupagg_large": 0, "groupagg": n}),
        "q6f": (gw, tpch.Q6F, s_on, {"groupagg_large": 0, "groupagg": n}),
        "raw": (gw, FLOW_RAW, None, {"groupagg_large": 0, "groupagg": 0}),
        "partial": (gw, FLOW_PARTIAL, None,
                    {"groupagg_large": 0, "groupagg": 0}),
    }
    rows = {}
    for q, (g, sql, sess, kern) in cases.items():
        metrics0 = {k: msum(k) for k in (
            "distsql.flows.graph", "exec.agg.adaptive.ship_raw",
            "exec.agg.adaptive.partial", "distsql.agg.raw_folds",
            "exec.skip.joinfilter.filters")}
        _counts_zero()
        t0 = time.perf_counter()
        with recording_slots() as calls, recording_small() as scalls:
            res = g.run(sql, session=sess)
            _sync()
        first_s = time.perf_counter() - t0
        n1, n2 = _kernel_counts(on_card)
        launches["groupagg_large"] += n1
        launches["groupagg"] += n2
        first.setdefault(q, (calls[:1], scalls[:1]))
        if on_card and n1:
            large_checks[f"sf1 {q} phase 19"] = check_calls(
                f"phase 19 {q}", calls, n1)
        if on_card and n2:
            small_checks[q] = _check_small_calls(f"phase 19 {q}", scalls,
                                                 n2)
        route = {"groupagg_large": n1, "groupagg": n2}
        if route != kern:
            raise AssertionError(f"phase 19 {q}: kernel launches {route}, "
                                 f"want {kern}")
        delta = {k: msum(k) - v for k, v in metrics0.items()}
        if q == "q14_sharded" and delta["distsql.flows.graph"] != 1:
            raise AssertionError("phase 19: the sharded Q14 did not run "
                                 "as a graph flow")
        if q == "groupby" and delta["distsql.flows.graph"] != 1:
            raise AssertionError("phase 19: the GROUP BY did not run "
                                 "through _decompose_groupby")
        if q == "q14" and (delta["exec.skip.joinfilter.filters"] < 1
                           or delta["distsql.flows.graph"]):
            raise AssertionError(f"phase 19 q14: no join-filter frame or "
                                 f"a graph flow: {delta}")
        if q == "raw" and (delta["exec.agg.adaptive.ship_raw"] != n
                           or delta["distsql.agg.raw_folds"] != 1):
            raise AssertionError(f"phase 19 raw: {delta}, want every node "
                                 "to ship raw rows, one gateway fold")
        if q == "partial" and (delta["exec.agg.adaptive.partial"] != n
                               or delta["exec.agg.adaptive.ship_raw"]):
            raise AssertionError(f"phase 19 partial: {delta}, want every "
                                 "node to keep partials")
        local = src.execute(sql, sess)
        rel = 1e-5 if sess is s_on else 1e-9
        err = same_result(f"phase 19 {q} gateway vs one engine", res,
                          local, rel)
        if q == "q1":
            check_q1(res.rows, want["q1"])
        elif q in ("q6", "q14", "q14_sharded"):
            w = want["q6" if q == "q6" else "q14"]
            if not _close(res.rows[0][0], w, 1e-9):
                raise AssertionError(f"phase 19 {q}: {res.rows[0][0]} != "
                                     f"oracle {w}")
        elif q == "q1f":
            check_float("phase 19 q1f", res.rows, want["q1"])
        elif q == "q6f":
            check_float("phase 19 q6f", res.rows, [(want["q6"],)])
        else:
            _oracle_rows(q, res.rows, want[q])
        rows[q] = res
        out["queries"][q] = {"route": route, "metrics": delta,
                             "first_run_s": first_s, "rows": len(res.rows),
                             "gateway_vs_local_max_rel_err": err}
        print(f"phase 19 {q}: " + json.dumps(out["queries"][q]), flush=True)
    received = msum("shuffle.bytes.received")
    if received <= 0:
        raise AssertionError("phase 19: no shuffle bytes received")
    out["shuffle_bytes_received"] = received
    out["shuffle_bytes_sent"] = msum("shuffle.bytes.sent")

    # the pieces of one statement through the gateway
    out["pieces"] = {}
    for q in ("q1", "q14", "q14_sharded"):
        g, sql, sess, _ = cases[q]
        clock = _FlowClock()
        _sync()
        t0 = time.perf_counter()
        with clock.running() as t:
            g.run(sql, session=sess)
            _sync()
        out["pieces"][q] = dict(t, wall_s=time.perf_counter() - t0)
    print("phase 19 pieces: " + json.dumps(out["pieces"]), flush=True)

    # warm pairs in one process, and the card's busy time of each way
    t_timed = time.perf_counter()
    _counts_zero()
    out["timed"] = {}
    for q in ("q1", "q6", "q14", "q14_sharded", "q1f"):
        g, sql, sess, _ = cases[q]
        ways = {"gateway": lambda: g.run(sql, session=sess),
                "local": lambda: src.execute(sql, sess)}
        ms = {w: [] for w in ways}
        for _ in range(reps):
            for w, fn in ways.items():
                _sync()
                t0 = time.perf_counter()
                fn()
                _sync()
                ms[w].append((time.perf_counter() - t0) * 1e3)
        rec = {}
        for w, fn in ways.items():
            med = statistics.median(ms[w])
            busy = _device_busy_ms(fn, 2) if on_card else 0.0
            rec[w] = {"median_ms": med, "runs_ms": ms[w],
                      "device_busy_ms": busy, "host_ms": med - busy,
                      "idle_share": max(0.0, 1.0 - busy / med)}
        out["timed"][q] = rec
        print(f"phase 19 timed {q}: " + json.dumps(rec), flush=True)
    out["timed_launches"] = dict(zip(("groupagg_large", "groupagg"),
                                     _kernel_counts(on_card)))
    out["timed_s"] = time.perf_counter() - t_timed

    # Q1 and the sharded Q14 once more over real sockets
    socket_nodes = []
    out["sockets"] = {}
    for q, engs, kern in (("q1", engines_a, n), ("q14_sharded", engines_b,
                                                   0)):
        fab = _SocketFabric(engs)
        try:
            g = Gateway(fab.nodes[0], data, replicated_tables=(
                {"part"} if q == "q1" else None))
            _counts_zero()
            t0 = time.perf_counter()
            with recording_slots() as calls:
                res = g.run(cases[q][1])
                _sync()
            first_s = time.perf_counter() - t0
            n1, n2 = _kernel_counts(on_card)
            if (n1, n2) != (kern, 0):
                raise AssertionError(f"phase 19 {q} over sockets: kernel "
                                     f"launches {(n1, n2)}, want "
                                     f"{(kern, 0)}")
            launches["groupagg_large"] += n1
            if on_card and n1:
                large_checks[f"sf1 {q} phase 19 sockets"] = check_calls(
                    f"phase 19 {q} over sockets", calls, n1)
            err = same_result(f"phase 19 {q} sockets vs LocalTransport",
                              res, rows[q])
            ms = []
            for _ in range(SOCKET_REPS):
                _sync()
                t0 = time.perf_counter()
                g.run(cases[q][1])
                _sync()
                ms.append((time.perf_counter() - t0) * 1e3)
            frames = sum(t.sent for t in fab.transports)
            socket_nodes += fab.nodes
        finally:
            fab.close()
        rec = {"first_run_s": first_s, "median_ms": statistics.median(ms),
               "runs_ms": ms, "frames_sent": frames,
               "local_median_ms": out["timed"][q]["gateway"]["median_ms"],
               "launches": n1, "max_rel_err_vs_local": err}
        out["sockets"][q] = rec
        print(f"phase 19 {q} over sockets: " + json.dumps(rec), flush=True)
    out["sockets_timed_launches"] = _kernel_counts(on_card)[0]
    leftover = [(e_i, len(nd.registry._inboxes))
                for e_i, nd in enumerate(nodes_a + nodes_b + socket_nodes)
                if nd.registry._inboxes]
    if leftover:
        raise AssertionError(f"phase 19: inboxes left in registries "
                             f"{leftover}")

    # kernel 1 at one node's Q1 slots
    if on_card:
        out["node_q1_kernel"] = slot_numbers(tgl, first["q1"][0][0])
        print("phase 19 kernel 1 at a node's Q1 shard: "
              + json.dumps(out["node_q1_kernel"]), flush=True)
    for e in engines:
        e.close()
    del nodes_a, nodes_b, engines_a, engines_b, engines, gw, gw_shuffle
    del gw_sharded
    _gc.collect()
    if on_card:
        import torch
        torch.cuda.empty_cache()
    out["launches"] = launches
    out["path_checks"] = large_checks
    out["small_checks"] = small_checks
    out["seconds"] = time.perf_counter() - t_start
    return out


def flows_phase_alone(sf: float = SF, device=None,
                      rows: int | None = None) -> dict:
    """Phase 19 by itself on the card: builds the kernels, resolves the
    gate and the launch point under a fresh cache root, loads lineitem
    and part at `sf` into one engine (the comparison), then runs phase
    19. Prints its JSON line. ``device="cpu"`` with a small `sf` and
    `rows` rehearses it on the CPU (plain-version calls stand for
    launches; no kernel checks or timings)."""
    import numpy as np

    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import build
    with cache_root():
        if device is None:
            build.compile_all(["groupagg_large", "groupagg"])
        kernel_infra(device or "cuda")
        src = Engine(device=device)
        tpch.load(src, sf=sf, tables=("lineitem", "part"), encoded=True,
                  rows=rows)
        li_codes = tpch.gen_lineitem(sf, encoded=True, rows=rows)
        li = dict(li_codes)
        for c, vals in (("l_returnflag", tpch.RF_VALUES),
                        ("l_linestatus", tpch.LS_VALUES)):
            li[c] = np.asarray(vals)[li[c]]
        part = tpch.gen_part(sf)
        want = dict(flow_oracles(li), q1=tpch.ref_q1(li),
                    q6=tpch.ref_q6(li), q14=tpch.ref_q14(li, part))
        out = flows_phase(src, li_codes, part, want)
        src.close()
        _sync()
    for k in ("path_checks", "small_checks"):
        out[k] = len(out[k])
    print(json.dumps({"flows": out}), flush=True)
    return out


POD_HOSTS = 2                   # phase 20: hostd processes on the one card
POD_REPEAT = 5                  # runs of each query (first and best kept)
POD_QUERIES = ("q6", "groupby", "join")
POD_TIMEOUT_S = 240             # each host process's limit


def _pod_mem() -> dict:
    """The card's free and total bytes (mem_get_info: every process's
    use counts), and this process's own peak allocated and reserved."""
    import torch
    free, total = torch.cuda.mem_get_info()
    return {"free_bytes": free, "total_bytes": total,
            "process_max_allocated_bytes": torch.cuda.max_memory_allocated(),
            "process_reserved_bytes": torch.cuda.memory_reserved()}


def pod_child_main() -> int:
    """One host of phase 20's pod: argv = server/hostd.py's arguments.
    Runs hostd.main(argv) inside recording_slots(), with each kernel-1
    launch attributed to the query of the flow stage that made it, then
    holds every recorded launch against the plain version at that
    host's inputs (check_calls) and prints one line tagged POD_CHECKS:
    launches per query, the checks, the host's start-up seconds
    (rendezvous, generation and ingest, ready) and its memory (_pod_mem)
    after the run. On the CPU (``--device cpu``) plain-version calls
    stand for launches and nothing is held against anything."""
    import torch

    from cockroach_tpu_torch.distsql import node as pnode
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import groupagg as tg
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    from cockroach_tpu_torch.parallel import multihost
    from cockroach_tpu_torch.server import hostd
    t_start = time.time()
    argv = sys.argv[1:]
    on_card = "cpu" not in argv
    names = {tpch.Q6: "q6", hostd.GROUPBY_SQL: "groupby", tpch.Q14: "join"}
    per_query = {"q6": [], "groupby": [], "join": []}
    setup = pnode.DistSQLNode._setup_flow
    times: dict = {}

    def attributed(self, spec):
        n1, n2 = _kernel_counts(on_card)
        try:
            return setup(self, spec)
        finally:
            m1, m2 = _kernel_counts(on_card)
            per_query[names.get(spec.sql, spec.sql)].append(
                {"groupagg_large": m1 - n1, "groupagg": m2 - n2})

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.time()
            try:
                return fn(*a, **kw)
            finally:
                times[name] = time.time() - t0
                times[f"{name}_done_at"] = time.time()
        return run

    saved = (multihost.init_distributed, hostd._build_engine,
             multihost.barrier)
    pnode.DistSQLNode._setup_flow = attributed
    multihost.init_distributed = timed("rendezvous_s", saved[0])
    hostd._build_engine = timed("build_s", saved[1])
    multihost.barrier = timed("ready_barrier_s", saved[2])
    tgl.LAUNCHES = tg.LAUNCHES = 0
    try:
        with recording_slots() as calls:
            rc = hostd.main(argv)
            _sync()
        launches = _kernel_counts(on_card)
        checks = (check_calls("phase 20 host", calls, launches[0])
                  if on_card and launches[0] else [])
    finally:
        pnode.DistSQLNode._setup_flow = setup
        (multihost.init_distributed, hostd._build_engine,
         multihost.barrier) = saved
    out = {"rc": rc, "started_at": t_start,
           "ready_at": times.get("ready_barrier_s_done_at"),
           "rendezvous_s": times.get("rendezvous_s"),
           "build_s": times.get("build_s"),
           "launches": {"groupagg_large": launches[0],
                        "groupagg": launches[1]},
           "per_query": per_query, "checks": checks,
           "mem": _pod_mem() if on_card and torch.cuda.is_available()
           else None, "seconds": time.time() - t_start}
    print("POD_CHECKS " + json.dumps(out), flush=True)
    return rc


def _pod_tagged(stdout: str, tag: str) -> dict:
    lines = [ln for ln in stdout.splitlines() if ln.startswith(tag)]
    if not lines:
        raise AssertionError(f"phase 20: no {tag!r} line")
    return json.loads(lines[-1][len(tag):])


def pod_phase(src, want: dict, sf: float = SF, rows: int | None = None,
              device: str = "cuda") -> dict:
    """Phase 20: a pod of POD_HOSTS hostd processes on the one card
    (`--num-processes 2 --fanout 2 --sf 1 --queries q6,groupby,join
    --repeat 5`, the coordinator on a free localhost port), each through
    pod_child_main, so that every kernel-1 launch of a host is held
    against the plain version at that host's inputs. Host 0's results
    must equal ``src``'s (the single engine over the same generated
    tables: GROUP BY rows bit for bit, Q6 and Q14 by the parity contract)
    and the numpy oracles in ``want``; kernel 1 launches once a host a
    GROUP BY run and never for Q6 or Q14; the rendezvous gauge reads 2
    on both hosts; host 0 tree-merged host 1's partials; host 1 shipped
    frames. Returns the `pod` line's numbers."""
    import os
    import socket

    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.server.hostd import GROUPBY_SQL, _jsonable
    t_start = time.perf_counter()
    on_card = device == "cuda"
    out: dict = {"card": _smi() if on_card else "cpu", "hosts": POD_HOSTS,
                 "repeat": POD_REPEAT, "sf": sf,
                 "parent_mem_before": _pod_mem() if on_card else None}
    print("phase 20 card memory before the pod: "
          + json.dumps(out["parent_mem_before"]), flush=True)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]

    def cmd(pid):
        c = [sys.executable, "-c", "import sys, chip_smoke; "
             "sys.exit(chip_smoke.pod_child_main())",
             "--process-id", str(pid), "--num-processes", str(POD_HOSTS),
             "--coordinator", f"127.0.0.1:{port}", "--fanout", "2",
             "--sf", str(sf), "--queries", ",".join(POD_QUERIES),
             "--repeat", str(POD_REPEAT), "--device", device]
        return c + (["--rows", str(rows)] if rows is not None else [])

    env = dict(os.environ, TORCH_CPP_LOG_LEVEL="ERROR")
    spawned_at = time.time()
    procs = [subprocess.Popen(cmd(pid), env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for pid in range(POD_HOSTS)]
    results = []
    try:
        for pid, proc in enumerate(procs):
            try:
                so, se = proc.communicate(timeout=POD_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"phase 20: host {pid} did not end "
                                     f"within {POD_TIMEOUT_S} s")
            if proc.returncode != 0:
                raise AssertionError(f"phase 20: host {pid} exited "
                                     f"{proc.returncode}:\n{so[-3000:]}\n"
                                     f"{se[-4000:]}")
            results.append((so, se))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["wall_s"] = time.time() - spawned_at
    pod = json.loads(next(ln for ln in results[0][0].splitlines()
                          if ln.startswith("{")))
    hosts = [_pod_tagged(so, "POD_CHECKS ") for so, _ in results]

    # rows: host 0's against the single engine and numpy
    res = pod["results"]
    for q in POD_QUERIES:
        if "error" in res[q]:
            raise AssertionError(f"phase 20 {q}: {res[q]['error']}")
    local = {q: src.execute(sql) for q, sql in (
        ("q6", tpch.Q6), ("groupby", GROUPBY_SQL), ("join", tpch.Q14))}
    want_gb = [[_jsonable(v) for v in r] for r in local["groupby"].rows]
    if res["groupby"]["rows"] != want_gb:
        raise AssertionError(f"phase 20 groupby: {res['groupby']['rows']} "
                             f"!= the single engine's {want_gb}")
    for g_row, w_row in zip(res["groupby"]["rows"], want["q1"]):
        if tuple(g_row[:2]) != tuple(w_row[:2]) or g_row[4] != w_row[9] \
                or not _close(g_row[2], float(w_row[2]), 1e-9) \
                or not _close(g_row[3], float(w_row[3]), 1e-9):
            raise AssertionError(f"phase 20 groupby {g_row} != numpy "
                                 f"{w_row}")
    errs = {}
    for q, w in (("q6", want["q6"]), ("join", want["q14"])):
        got = res[q]["rows"][0][0]
        mine = local[q].rows[0][0]
        if not _close(got, mine, 1e-9) or not _close(got, w, 1e-9):
            raise AssertionError(f"phase 20 {q}: {got} != the single "
                                 f"engine's {mine} or numpy's {w}")
        errs[q] = abs(got - mine) / max(abs(mine), 1e-300)
    out["max_rel_err_vs_engine"] = errs

    # routes: kernel 1 once a host a GROUP BY run, never for Q6 or Q14
    for pid, h in enumerate(hosts):
        runs = h["per_query"]
        gb = [r["groupagg_large"] for r in runs["groupby"]]
        if gb != [1] * POD_REPEAT:
            raise AssertionError(f"phase 20 host {pid}: kernel 1 per "
                                 f"GROUP BY run {gb}, want 1 each")
        for q in ("q6", "join"):
            if any(r["groupagg_large"] or r["groupagg"] for r in runs[q]) \
                    or len(runs[q]) != POD_REPEAT:
                raise AssertionError(f"phase 20 host {pid} {q}: "
                                     f"{runs[q]}")
        if h["launches"]["groupagg_large"] != POD_REPEAT or \
                h["launches"]["groupagg"]:
            raise AssertionError(f"phase 20 host {pid}: launches "
                                 f"{h['launches']}")
        if on_card and len(h["checks"]) != POD_REPEAT:
            raise AssertionError(f"phase 20 host {pid}: "
                                 f"{len(h['checks'])} launches checked")

    # the rendezvous, the merge tree and the fabric
    m0, m1 = pod["metrics"]["0"], pod["metrics"]["1"]
    if m0.get("exec.multihost.hosts") != POD_HOSTS or \
            (m1 or {}).get("exec.multihost.hosts") != POD_HOSTS:
        raise AssertionError(f"phase 20: exec.multihost.hosts {m0}, {m1}")
    if m0.get("distsql.flows.tree", 0) < 1 or \
            m0.get("exec.multihost.flows.merged", 0) < 1 or \
            m0.get("exec.multihost.merge.bytes", 0) <= 0:
        raise AssertionError(f"phase 20: host 0 did not tree-merge: {m0}")
    if m1.get("shuffle.bytes.sent", 0) <= 0 or \
            m1.get("rpc.frames.sent", 0) <= 0:
        raise AssertionError(f"phase 20: host 1 shipped nothing: {m1}")

    out.update(
        queries={q: {"first_s": pod["timings"][q]["first_s"],
                     "best_s": pod["timings"][q]["elapsed_s"],
                     "rows_per_s": pod["timings"][q]["rows_per_s"]}
                 for q in POD_QUERIES},
        lineitem_rows=pod["rows"],
        startup={str(pid): {
            "spawn_to_ready_s": h["ready_at"] - spawned_at,
            "interpreter_s": h["started_at"] - spawned_at,
            "rendezvous_s": h["rendezvous_s"],
            "generate_and_ingest_s": h["build_s"]}
            for pid, h in enumerate(hosts)},
        host_mem={str(pid): h["mem"] for pid, h in enumerate(hosts)},
        launches={str(pid): h["launches"] for pid, h in enumerate(hosts)},
        metrics=pod["metrics"],
        seconds=time.perf_counter() - t_start)
    out["path_checks"] = {f"sf{sf:g} pod host {pid} phase 20": h["checks"]
                          for pid, h in enumerate(hosts) if h["checks"]}
    print("phase 20: " + json.dumps({k: v for k, v in out.items()
                                     if k != "path_checks"}), flush=True)
    return out


def pod_phase_alone(sf: float = SF, device: str = "cuda",
                    rows: int | None = None) -> dict:
    """Phase 20 by itself: builds the kernels, resolves the gate and the
    launch point under a fresh cache root, loads lineitem and part at
    `sf` into one engine (the comparison), then runs the pod and prints
    its `pod` line. ``device="cpu"`` with a small `sf` and `rows`
    rehearses it on the CPU (plain-version calls stand for launches; no
    kernel checks)."""
    import numpy as np

    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import build
    with cache_root():
        if device == "cuda":
            build.compile_all(["groupagg_large", "groupagg"])
        kernel_infra(device)
        src = Engine(device=None if device == "cuda" else device)
        tpch.load(src, sf=sf, tables=("lineitem", "part"), encoded=True,
                  rows=rows)
        li = tpch.gen_lineitem(sf, encoded=True, rows=rows)
        codes = {c: li[c] for c in ("l_returnflag", "l_linestatus")}
        for c, vals in (("l_returnflag", tpch.RF_VALUES),
                        ("l_linestatus", tpch.LS_VALUES)):
            li[c] = np.asarray(vals)[li[c]]
        want = {"q1": ref_q1_codes(dict(li, **codes)), "q6": tpch.ref_q6(li),
                "q14": tpch.ref_q14(li, tpch.gen_part(sf))}
        out = pod_phase(src, want, sf, rows, device)
        src.close()
    out["path_checks"] = len(out["path_checks"])
    print(json.dumps({"pod": out}), flush=True)
    return out


ELASTIC_HOSTS = 3               # phase 21: hostd --elastic processes
ELASTIC_NSHARDS = 8
ELASTIC_REPEAT = 8
ELASTIC_GAP = 0.25              # seconds between the founder's statements
ELASTIC_QUERIES = ("groupby", "q6")
# heartbeats every 0.25 s and 30 s of silence before a host is suspect:
# SF1's generation (about 5 s) and kernel 1's runs hold the interpreter
# that sends the beats, and no live host may be expelled
ELASTIC_HEARTBEAT_S = 0.25
ELASTIC_WINDOW_S = 30.0
ELASTIC_TIMEOUT_S = 240
ELASTIC_DRAIN_AFTER = 1.0       # host 1's drain timer (then it waits its cue)
ELASTIC_JOIN_AT = 2             # cues: after the founder's 2nd GROUP BY run
ELASTIC_DRAIN_AT = 4            # the joiner, after its 4th host 1's drain
# the in-process kill: heartbeat window, flow idle timeout
KILL_WINDOW_S = 2.0
KILL_FLOW_TIMEOUT_S = 8.0


def _elastic_cue(name: str) -> str:
    return f"phase21/{name}"


def _pump_until(pod, cond, what: str, timeout: float = 120.0) -> None:
    """Serve this host's flows and lease work until ``cond()`` holds,
    through hostd's own serve step: a host waiting on the pod must go on
    serving it. A failed reconcile is retried until the deadline."""
    from cockroach_tpu_torch.server import hostd
    deadline = time.monotonic() + timeout
    known = {pod.host_id}
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 21: {what} within {timeout} s")
        if not hostd.elastic_serve_step(pod.node.transport, pod, known):
            time.sleep(0.005)


def elastic_child_main() -> int:
    """One host of phase 21's elastic pod: argv = server/hostd.py's
    arguments (with --elastic). Runs hostd.main(argv) inside
    recording_slots() with every count at 0, attributing each kernel
    launch to the flow stage that made it (its query, epoch, and the
    shards the host served), then holds every recorded kernel-1 launch
    against the plain version at that host's inputs. Churn lands at
    fixed points of the founder's statement loop: the founder posts a
    cue after its ELASTIC_JOIN_AT-th and ELASTIC_DRAIN_AT-th GROUP BY
    runs and waits (serving its flows) for the flip that follows each;
    the joiner starts its join at the first cue, host 1 its drain at the
    second. Prints one line tagged ELASTIC_CHECKS."""
    import torch

    from cockroach_tpu_torch.distsql import leases as L
    from cockroach_tpu_torch.distsql import node as pnode
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.parallel import multihost
    from cockroach_tpu_torch.server import hostd
    t_start = time.time()
    argv = sys.argv[1:]
    on_card = "cpu" not in argv
    hid = int(argv[argv.index("--process-id") + 1])
    names = {tpch.Q6: "q6", hostd.GROUPBY_SQL: "groupby"}
    flows: list = []
    times: dict = {}
    streamed = {"bytes": 0, "seconds": 0.0, "shards": 0}
    setup = pnode.DistSQLNode._setup_flow
    run = pnode.Gateway.run
    fetch = L.fetch_shard
    drain = L.ElasticPod.drain_pod
    join = L.ElasticPod.join_pod
    bootstrap = L.ElasticPod.bootstrap

    def attributed(self, spec):
        n1, n2 = _kernel_counts(on_card)
        ran = self.flows_run
        try:
            return setup(self, spec)
        finally:
            m1, m2 = _kernel_counts(on_card)
            pod = self.elastic
            flows.append({
                "query": names.get(spec.sql, spec.sql[:40]),
                "epoch": spec.epoch, "ran": self.flows_run - ran,
                "shards": len(pod.keeper.installed("lineitem"))
                if pod is not None else 0,
                "groupagg_large": m1 - n1, "groupagg": m2 - n2})

    gb_runs = [0]

    def cued_run(self, sql, *a, **kw):
        pod = self.elastic
        if sql == hostd.GROUPBY_SQL:
            if gb_runs[0] == ELASTIC_JOIN_AT:
                _pump_until(pod, lambda: 2 in pod.view().owners(
                    "lineitem"), "the joiner's lease flip")
            elif gb_runs[0] == ELASTIC_DRAIN_AT:
                _pump_until(pod, lambda: 1 not in
                            pod.membership.view().live, "host 1's drain")
        out = run(self, sql, *a, **kw)
        if sql == hostd.GROUPBY_SQL:
            gb_runs[0] += 1
            if gb_runs[0] == ELASTIC_JOIN_AT:
                multihost.kv_set(_elastic_cue("join"), "1")
            elif gb_runs[0] == ELASTIC_DRAIN_AT:
                multihost.kv_set(_elastic_cue("drain"), "1")
        return out

    def timed_fetch(node, owner, table, sid, *a, **kw):
        t0 = time.time()
        out = fetch(node, owner, table, sid, *a, **kw)
        streamed["seconds"] += time.time() - t0
        streamed["bytes"] += sum(v.nbytes for v in out.values())
        streamed["shards"] += 1
        return out

    def cued_join(self, *a, **kw):
        _pump_until(self, lambda: multihost.kv_try_get(
            _elastic_cue("join")) is not None, "the join cue")
        t0 = time.time()
        try:
            return join(self, *a, **kw)
        finally:
            times["join_s"] = time.time() - t0
            times["joined_at"] = time.time()

    def cued_drain(self, *a, **kw):
        _pump_until(self, lambda: multihost.kv_try_get(
            _elastic_cue("drain")) is not None, "the drain cue")
        t0 = time.time()
        try:
            return drain(self, *a, **kw)
        finally:
            times["drain_s"] = time.time() - t0

    def timed_bootstrap(self, *a, **kw):
        out = bootstrap(self, *a, **kw)
        times["ready_at"] = time.time()
        return out

    pnode.DistSQLNode._setup_flow = attributed
    pnode.Gateway.run = cued_run
    L.fetch_shard = timed_fetch
    L.ElasticPod.join_pod = cued_join
    L.ElasticPod.drain_pod = cued_drain
    L.ElasticPod.bootstrap = timed_bootstrap
    from cockroach_tpu_torch.ops.cuda import groupagg as tg
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    tgl.LAUNCHES = tg.LAUNCHES = 0
    tgl.PLAIN_CALLS = tg.PLAIN_CALLS = 0
    try:
        with recording_slots() as calls:
            rc = hostd.main(argv)
            _sync()
        launches = _kernel_counts(on_card)
        checks = (check_calls(f"phase 21 host {hid}", calls, launches[0])
                  if on_card and launches[0] else [])
    finally:
        pnode.DistSQLNode._setup_flow = setup
        pnode.Gateway.run = run
        L.fetch_shard = fetch
        L.ElasticPod.join_pod = join
        L.ElasticPod.drain_pod = drain
        L.ElasticPod.bootstrap = bootstrap
    out = {"rc": rc, "host": hid, "started_at": t_start,
           "times": times, "flows": flows, "streamed": streamed,
           "launches": {"groupagg_large": launches[0],
                        "groupagg": launches[1]},
           "checks": checks,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated()
           if on_card and torch.cuda.is_available() else None,
           "seconds": time.time() - t_start}
    print("ELASTIC_CHECKS " + json.dumps(out), flush=True)
    return rc


def _elastic_flow_checks(hosts: dict) -> int:
    """Each host's flows: a GROUP BY stage that ran over installed shards
    launched kernel 1 once, any other stage (Q6, an empty host's, a
    refused one) none, and kernel 2 never. Returns the kernel-1 launches
    the flows account for."""
    total = 0
    for hid, h in hosts.items():
        for f in h["flows"]:
            want = 1 if (f["query"] == "groupby" and f["ran"]
                         and f["shards"]) else 0
            if f["groupagg_large"] != want or f["groupagg"]:
                raise AssertionError(f"phase 21 host {hid} flow {f}: "
                                     f"kernel 1 {want} time(s) wanted")
            total += want
        if h["launches"]["groupagg_large"] != sum(
                f["groupagg_large"] for f in h["flows"]):
            raise AssertionError(f"phase 21 host {hid}: launches outside "
                                 f"its flows {h['launches']}")
    return total


def elastic_kill(src, li_enc: dict, part: dict, device: str = "cuda",
                 nshards: int = ELASTIC_NSHARDS) -> dict:
    """Phase 21's in-process kill: three ElasticPods over in-process
    SocketTransports (a pump thread each for hosts 1 and 2), each a port
    Engine on ``device`` holding its share of lineitem (``li_enc``, the
    encoded generator columns) in ``nshards`` shards; host 2 is killed
    just before the gateway's first transport pump of a GROUP BY (the
    reference's test_kill_mid_scan hook): its heartbeats stop and every
    link to it is cut. The statement must come back through the
    failover rung with ``src``'s rows, the lease table must place every
    shard once on a survivor, and kernel 1 must launch once per
    survivor's stage, each launch held against its plain version."""
    import threading

    from cockroach_tpu_torch.distsql import leases as L
    from cockroach_tpu_torch.distsql.node import DistSQLNode, Gateway
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.parallel import multihost
    from cockroach_tpu_torch.rpc.context import SocketTransport
    from cockroach_tpu_torch.server.hostd import GROUPBY_SQL, _jsonable
    from cockroach_tpu_torch.storage.hlc import Timestamp
    on_card = device == "cuda"
    n = len(li_enc["l_orderkey"])

    def recover(table, sid):
        lo, hi = sid * n // nshards, (sid + 1) * n // nshards
        return {k: v[lo:hi] for k, v in li_enc.items()}

    multihost.init_distributed(num_processes=1)
    transports = [SocketTransport(i) for i in range(3)]
    for a in transports:
        for b in transports:
            if a is not b:
                a.connect(b.node_id, b.addr)
    stop = threading.Event()

    def pump(t):
        while not stop.is_set():
            if not t.deliver_all():
                time.sleep(0.0005)

    engines, pods = [], []
    t0 = time.perf_counter()
    try:
        for hid in range(3):
            eng = Engine(device=None if on_card else device)
            eng.execute(tpch.DDL["lineitem"])
            eng.execute(tpch.DDL["part"])
            eng.store.insert_columns("part", part, Timestamp(1, 0))
            engines.append(eng)
            node = DistSQLNode(hid, eng, transports[hid])
            mem = multihost.Membership(hid, f"h{hid}", metrics=eng.metrics,
                                       heartbeat_interval=0.05,
                                       liveness_window=KILL_WINDOW_S)
            keeper = L.ShardKeeper(eng)
            keeper.register_table("lineitem", tpch.DDL["lineitem"],
                                  dictionaries=tpch.LINEITEM_DICTS)
            pods.append(L.ElasticPod(hid, mem, L.ShardLeases(
                mem, metrics=eng.metrics), keeper, node=node,
                recover=recover))
            mem.join()
            mem.start_heartbeat()
        for p in pods:
            p.bootstrap("lineitem", tpch.DDL["lineitem"], nshards,
                        [0, 1, 2])
        threads = [threading.Thread(target=pump, args=(t,), daemon=True)
                   for t in transports[1:]]
        for th in threads:
            th.start()
        gw = Gateway(pods[0].node, [0, 1, 2], replicated_tables={"part"},
                     flow_timeout=KILL_FLOW_TIMEOUT_S, elastic=pods[0])
        setup_s = time.perf_counter() - t0
        want = [[_jsonable(v) for v in r]
                for r in src.execute(GROUPBY_SQL).rows]
        warm = [[_jsonable(v) for v in r] for r in gw.run(GROUPBY_SQL).rows]
        if warm != want:
            raise AssertionError(f"phase 21 kill, before: {warm} != {want}")
        owners_before = sorted(pods[0].view().owners("lineitem"))
        gate = transports[0]
        deliver = gate.deliver_all
        fired = []

        def kill():
            pods[2].membership.stop_heartbeat()
            for t in transports[:2]:
                t.partition(2)
            transports[2].partition(0, 1)

        def hooked():
            if not fired:
                fired.append(time.perf_counter())
                kill()
            return deliver()

        gate.deliver_all = hooked
        _counts_zero()
        with recording_slots() as calls:
            t1 = time.perf_counter()
            try:
                got = gw.run(GROUPBY_SQL)
            finally:
                gate.deliver_all = deliver
            _sync()
            failover_s = time.perf_counter() - t1
        launches = _kernel_counts(on_card)[0]
        checks = (check_calls("phase 21 kill", calls, launches)
                  if on_card else [])
        rows = [[_jsonable(v) for v in r] for r in got.rows]
        if rows != want:
            raise AssertionError(f"phase 21 kill: {rows} != the SF1 "
                                 f"engine's {want}")
        snap = engines[0].metrics.snapshot()
        if snap.get("distsql.degrade.failover", 0) < 1:
            raise AssertionError("phase 21 kill: no failover rung")
        view = pods[0].view()
        asg = view.assignment("lineitem")
        if sorted(asg) != list(range(nshards)) or \
                set(asg.values()) - {0, 1}:
            raise AssertionError(f"phase 21 kill: leases {asg}")
        served = {}
        for p in pods[:2]:
            p.maybe_reconcile()
            for s in p.keeper.installed("lineitem"):
                if s in served:
                    raise AssertionError(f"phase 21 kill: shard {s} on "
                                         "two hosts")
                served[s] = p.host_id
        if served != asg:
            raise AssertionError(f"phase 21 kill: engines {served} != "
                                 f"leases {asg}")
        # the first attempt launches on the hosts whose stage ran before
        # the loss was found (the victim's too: its pump thread is in
        # this process), the replan once on each survivor
        if not 2 <= launches <= 6:
            raise AssertionError(f"phase 21 kill: {launches} kernel-1 "
                                 "launches")
        return {"setup_s": setup_s, "failover_s": failover_s,
                "owners_before": owners_before,
                "owners_after": sorted(set(asg.values())),
                "failovers": snap.get("distsql.degrade.failover", 0),
                "lease_failovers": sum(
                    e.metrics.snapshot().get("exec.lease.failovers", 0)
                    for e in engines),
                "partials_reused": snap.get(
                    "distsql.failover.partials_reused", 0),
                "launches": launches, "checks": checks}
    finally:
        stop.set()
        for p in pods:
            p.membership.stop_heartbeat()
        for t in transports:
            t.close()
        for e in engines:
            e.close()
        multihost.shutdown_distributed()


def elastic_phase(src, want: dict, li_enc: dict, part: dict,
                  sf: float = SF, rows: int | None = None,
                  device: str = "cuda") -> dict:
    """Phase 21: the elastic pod at ``sf`` (the shape of the reference's
    test_late_join_mid_statement_loop). Three server/hostd.py --elastic
    processes on the one card, each through elastic_child_main: host 0
    founds the pod (--initial-hosts 2), host 1 is a founding member that
    drains part-way, host 2 joins the running pod (--late-join) and
    streams its shards from their live owners before the flip; all with
    --sf, --nshards 8, --queries groupby,q6, --repeat 8,
    --statement-gap 0.25 and the heartbeat settings above. Every GROUP
    BY run must equal ``src``'s rows (the SF1 engine) bit for bit and
    the numpy Q1 oracle's sums and counts, every Q6 run ``src``'s and
    the oracle's within rel 1e-9, both consistent; at least three epochs
    are seen; kernel 1 launches once in each GROUP BY stage a host runs
    over installed shards and never for Q6, each launch held against its
    plain version; leases moved and shard bytes were streamed. Then the
    in-process kill (elastic_kill). Returns the `elastic` line's
    numbers."""
    import os
    import tempfile

    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.server.hostd import GROUPBY_SQL, _jsonable
    t_start = time.perf_counter()
    on_card = device == "cuda"
    out: dict = {"card": _smi() if on_card else "cpu", "sf": sf,
                 "hosts": ELASTIC_HOSTS, "nshards": ELASTIC_NSHARDS,
                 "repeat": ELASTIC_REPEAT, "statement_gap": ELASTIC_GAP,
                 "heartbeat_interval_s": ELASTIC_HEARTBEAT_S,
                 "liveness_window_s": ELASTIC_WINDOW_S}
    print("phase 21 heartbeats: every "
          f"{ELASTIC_HEARTBEAT_S} s, liveness window {ELASTIC_WINDOW_S} s",
          flush=True)
    addr_file = os.path.join(tempfile.mkdtemp(), "kv_addr")
    base = [sys.executable, "-c", "import sys, chip_smoke; "
            "sys.exit(chip_smoke.elastic_child_main())",
            "--elastic", "--device", device, "--sf", str(sf),
            "--nshards", str(ELASTIC_NSHARDS),
            "--queries", ",".join(ELASTIC_QUERIES),
            "--repeat", str(ELASTIC_REPEAT),
            "--statement-gap", str(ELASTIC_GAP),
            "--flow-timeout", "120",
            "--heartbeat-interval", str(ELASTIC_HEARTBEAT_S),
            "--liveness-window", str(ELASTIC_WINDOW_S)] + (
        ["--rows", str(rows)] if rows is not None else [])
    env = dict(os.environ, TORCH_CPP_LOG_LEVEL="ERROR")
    spawned_at = time.time()
    procs = {0: subprocess.Popen(
        base + ["--process-id", "0", "--kv-addr-file", addr_file,
                "--initial-hosts", "2"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)}
    results = {}
    try:
        deadline = time.time() + ELASTIC_TIMEOUT_S
        while not (os.path.exists(addr_file)
                   and open(addr_file).read().strip()):
            if procs[0].poll() is not None:
                raise AssertionError("phase 21: the founder exited "
                                     f"{procs[0].returncode}:\n"
                                     f"{procs[0].stderr.read()[-4000:]}")
            if time.time() > deadline:
                raise AssertionError("phase 21: no coordinator address")
            time.sleep(0.05)
        addr = open(addr_file).read().strip()
        procs[1] = subprocess.Popen(
            base + ["--process-id", "1", "--kv-addr", addr,
                    "--drain-after", str(ELASTIC_DRAIN_AFTER)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        procs[2] = subprocess.Popen(
            base + ["--process-id", "2", "--kv-addr", addr, "--late-join"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for hid, proc in procs.items():
            left = max(1.0, deadline - time.time())
            try:
                so, se = proc.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"phase 21: host {hid} did not end "
                                     f"within {ELASTIC_TIMEOUT_S} s")
            if proc.returncode != 0:
                raise AssertionError(f"phase 21: host {hid} exited "
                                     f"{proc.returncode}:\n{so[-3000:]}\n"
                                     f"{se[-4000:]}")
            results[hid] = so
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["wall_s"] = time.time() - spawned_at
    pod = json.loads(next(ln for ln in reversed(results[0].splitlines())
                          if ln.startswith("{")))
    hosts = {hid: json.loads(next(
        ln for ln in so.splitlines() if ln.startswith("ELASTIC_CHECKS "))
        [len("ELASTIC_CHECKS "):]) for hid, so in results.items()}

    # rows: every run against the SF1 engine and the numpy oracles
    res = pod["results"]
    for q in ELASTIC_QUERIES:
        if "error" in res[q]:
            raise AssertionError(f"phase 21 {q}: {res[q]['error']}")
        if not res[q]["consistent"]:
            raise AssertionError(f"phase 21 {q}: runs disagreed")
    want_gb = [[_jsonable(v) for v in r]
               for r in src.execute(GROUPBY_SQL).rows]
    if res["groupby"]["rows"] != want_gb:
        raise AssertionError(f"phase 21 groupby: {res['groupby']['rows']} "
                             f"!= the SF1 engine's {want_gb}")
    for g_row, w_row in zip(res["groupby"]["rows"], want["q1"]):
        if tuple(g_row[:2]) != tuple(w_row[:2]) or g_row[4] != w_row[9] \
                or not _close(float(g_row[2]), float(w_row[2]), 1e-9) \
                or not _close(float(g_row[3]), float(w_row[3]), 1e-9):
            raise AssertionError(f"phase 21 groupby {g_row} != numpy "
                                 f"{w_row}")
    got6, mine6 = res["q6"]["rows"][0][0], src.execute(tpch.Q6).rows[0][0]
    if not _close(float(got6), float(mine6), 1e-9) or \
            not _close(float(got6), want["q6"], 1e-9):
        raise AssertionError(f"phase 21 q6: {got6} != {mine6} or "
                             f"{want['q6']}")
    out["q6_rel_err_vs_engine"] = abs(float(got6) - float(mine6)) / max(
        abs(float(mine6)), 1e-300)

    # epochs, launches, leases, streaming
    runs = pod["runs"]
    epochs = sorted({r["epoch_before"] for r in runs}
                    | {r["epoch_after"] for r in runs})
    if len(epochs) < 3:
        raise AssertionError(f"phase 21: epochs seen {epochs}")
    launches = _elastic_flow_checks(hosts)
    if launches < ELASTIC_REPEAT:
        raise AssertionError(f"phase 21: {launches} kernel-1 launches")
    if on_card:
        for hid, h in hosts.items():
            if len(h["checks"]) != h["launches"]["groupagg_large"]:
                raise AssertionError(f"phase 21 host {hid}: checks")
    metrics = pod["metrics"]
    moves = sum((m or {}).get("exec.lease.moves", 0)
                for m in metrics.values())
    sent = sum((m or {}).get("exec.movement.rebalance.bytes", 0)
               for m in metrics.values())
    streamed = hosts[2]["streamed"]
    if moves <= 0 or sent <= 0 or streamed["bytes"] <= 0:
        raise AssertionError(f"phase 21: lease moves {moves}, rebalance "
                             f"bytes {sent}, streamed {streamed}")
    flips, prev = [], None
    for r in runs:
        if prev is not None and r["epoch_before"] != prev:
            flips.append({"query": r["query"], "epoch": r["epoch_before"],
                          "owners": r["owners_before"],
                          "seconds": r["seconds"]})
        prev = r["epoch_after"]
    mb = pod["membership"]
    if not mb.get("elastic") or 1 in mb["live"] or 2 not in mb["live"]:
        raise AssertionError(f"phase 21 membership: {mb}")

    # the in-process kill, at the same scale
    t0 = time.perf_counter()
    kill = elastic_kill(src, li_enc, part, device)
    kill["seconds"] = time.perf_counter() - t0
    out.update(
        queries={q: {"first_s": pod["timings"][q]["first_s"],
                     "best_s": pod["timings"][q]["elapsed_s"]}
                 for q in ELASTIC_QUERIES},
        first_run_after_flip=flips, epochs=epochs,
        lease_moves=moves, rebalance_bytes_sent=sent,
        streamed_to_joiner=streamed,
        failovers=kill["failovers"],
        startup={str(hid): {
            "spawn_to_ready_s": (h["times"].get("ready_at")
                                 or h["times"].get("joined_at")
                                 or h["started_at"]) - spawned_at,
            "interpreter_s": h["started_at"] - spawned_at,
            "join_s": h["times"].get("join_s"),
            "drain_s": h["times"].get("drain_s")}
            for hid, h in hosts.items()},
        peak_allocated_bytes={str(hid): h["peak_allocated_bytes"]
                              for hid, h in hosts.items()},
        launches={str(hid): h["launches"] for hid, h in hosts.items()},
        membership=mb, kill={k: v for k, v in kill.items()
                             if k != "checks"},
        metrics=metrics, seconds=time.perf_counter() - t_start)
    out["path_checks"] = {f"sf{sf:g} elastic host {hid} phase 21": h["checks"]
                          for hid, h in hosts.items() if h["checks"]}
    if kill["checks"]:
        out["path_checks"][f"sf{sf:g} elastic kill phase 21"] = \
            kill["checks"]
    out["kernel1_launches"] = launches + kill["launches"]
    print("phase 21: " + json.dumps({k: v for k, v in out.items()
                                     if k not in ("path_checks",
                                                  "metrics")}), flush=True)
    return out


def elastic_phase_alone(sf: float = SF, device: str = "cuda",
                        rows: int | None = None) -> dict:
    """Phase 21 by itself: builds the kernels, resolves the gate and the
    launch point under a fresh cache root, loads lineitem and part at
    `sf` into one engine (the comparison), then runs the elastic pod
    and the in-process kill and prints the `elastic` line.
    ``device="cpu"`` with a small `sf` and `rows` rehearses it on the
    CPU (plain-version calls stand for launches; no kernel checks)."""
    import numpy as np

    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops.cuda import build
    with cache_root():
        if device == "cuda":
            build.compile_all(["groupagg_large", "groupagg"])
        kernel_infra(device)
        src = Engine(device=None if device == "cuda" else device)
        tpch.load(src, sf=sf, tables=("lineitem", "part"), encoded=True,
                  rows=rows)
        li = tpch.gen_lineitem(sf, encoded=True, rows=rows)
        enc = dict(li)
        for c, vals in (("l_returnflag", tpch.RF_VALUES),
                        ("l_linestatus", tpch.LS_VALUES)):
            li[c] = np.asarray(vals)[li[c]]
        part = tpch.gen_part(sf)
        want = {"q1": ref_q1_codes(enc), "q6": tpch.ref_q6(li)}
        out = elastic_phase(src, want, enc, part, sf, rows, device)
        src.close()
    out["path_checks"] = len(out["path_checks"])
    print(json.dumps({"elastic": out}), flush=True)
    return out


# phase 22: SQL on raft-replicated ranges, at the sf 0.01 tests' size:
# RANGE_ROWS lineitem rows and all 2,000 parts, through INSERTs of
# RANGE_BATCH rows. A cut from SF1: raft is host code, a few hundred
# rows a second, so SF1's 6,001,215 rows would take hours. Raft is the
# reference's, draws included: a leader
# sends its append stream again on every success response that leaves
# entries unsent, stale ones too, so once a stale heartbeat response
# lands after the next proposal, every write that follows in that range
# adds a stream, and a statement's cost grows with the square of its
# writes to one range (tests/range_load_rate.py times both packages).
# The rows go into one range, which did not start that storm, and the
# spans are split after the load; the UPDATE after the split, which
# does start it, writes RANGE_UPDATE_ROWS rows
RANGE_ROWS = 20_000
RANGE_PIECES = 4
RANGE_BATCH = 1_000
RANGE_UPDATE_ROWS = 200
RANGE_REPS = 5


def _sql_lit(v):
    import numpy as np
    if isinstance(v, (str, np.str_)):
        return "'" + str(v).replace("'", "''") + "'"
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(int(v))


def _insert_sql(table: str, cols: dict, lo: int, hi: int) -> str:
    names = list(cols)
    return (f"INSERT INTO {table} ({', '.join(names)}) VALUES "
            + ", ".join("(" + ", ".join(_sql_lit(cols[c][i])
                                        for c in names) + ")"
                        for i in range(lo, hi)))


def range_tables(rows: int = RANGE_ROWS) -> tuple:
    """Phase 22's rows: lineitem's first ``rows`` and all of part from
    the sf 0.01 generators, as numpy columns (for the oracles) and as
    SQL literal columns (dates as ISO strings)."""
    import datetime

    from cockroach_tpu_torch.models import tpch
    li = tpch.gen_lineitem(0.01, rows=rows)
    part = tpch.gen_part(0.01)
    epoch = datetime.date(1970, 1, 1)
    li_sql = dict(li)
    for c in ("l_shipdate", "l_commitdate", "l_receiptdate"):
        li_sql[c] = [str(epoch + datetime.timedelta(days=int(d)))
                     for d in li[c]]
    return li, part, li_sql


def _ranges_q(run, label, on_card, kernels, phase: int = 22) -> tuple:
    """(Result, wall s, kernel-1 checks, kernel-2 checks) of ``run()``,
    one statement, with every count at 0 just before it; ``kernels`` is
    the (large, small) launch count it must make."""
    _counts_zero()
    t0 = time.perf_counter()
    with recording_slots() as calls, recording_small() as scalls:
        res = run()
        _sync()
    dt = time.perf_counter() - t0
    n1, n2 = _kernel_counts(on_card)
    if (n1, n2) != tuple(kernels):
        raise AssertionError(f"phase {phase} {label}: kernels {(n1, n2)}, "
                             f"want {kernels}")
    c1 = check_calls(f"phase {phase} {label}", calls, n1) \
        if on_card and n1 else []
    c2 = _check_small_calls(f"phase {phase} {label}", scalls, n2) \
        if on_card and n2 else []
    return res, dt, c1, c2


def ranges_phase(device: str = "cuda", rows: int = RANGE_ROWS) -> dict:
    """Phase 22: SQL on ranges. A 3-node kvserver.Cluster; gateway A, an
    Engine(cluster=c) on the card, creates lineitem and part, splits
    the lineitem span in RANGE_PIECES ranges by rowid and part's in two,
    then INSERTs the rows in statements of RANGE_BATCH (the load's rows/s
    and raft messages a row printed). A local port engine L holds the same rows (tpch.load
    at sf 0.01, ``rows`` of lineitem).
    Through A, under `auto`: Q1 (kernel 1 once, held against its plain
    version) equals L's (DECIMAL sums bit for bit, AVGs within rel
    1e-9) and the numpy oracle; Q6 and Q14 (no kernel) equal L's and
    the oracles within rel 1e-9. An UPDATE of RANGE_UPDATE_ROWS rows
    through A (its rows/s printed) is seen by Q1 on a second gateway B
    (the generation token), and B's AS OF SYSTEM TIME read from before
    it equals A's first Q1. After stop_node of one lineitem range's
    leaseholder, Q1 on a fresh gateway C has every committed row. Then
    the leaseholder-partitioned flow: DistSQLNodes 1-3 (one per cluster
    node, port engines on the card) and gateway node 0 with
    Gateway(cluster=c): Q1 and Q14 under `auto` and Q1F under `on`
    equal A's rows, kernel 1 launching once per node holding lineitem
    spans for Q1 and kernel 2 once per such node for Q1F, each held
    against its plain version; after transfer_lease of one range
    the partition still covers the table and Q1 still equals. A
    Node(cluster=c) lists every range with its leaseholder at
    /_debug/ranges. Medians of RANGE_REPS warm Q1 runs on A paired with
    L (device busy ms, host ms, idle share). Returns the `ranges` line's
    numbers, with "launches" and "path_checks"."""
    import urllib.request

    from cockroach_tpu_torch.distsql.node import DistSQLNode, Gateway
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.kv.rowfetch import RangeTable
    from cockroach_tpu_torch.kvserver.cluster import Cluster
    from cockroach_tpu_torch.kvserver.transport import LocalTransport
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.server import Node, NodeConfig
    from cockroach_tpu_torch.sql.rowenc import RowCodec
    t_start = time.perf_counter()
    on_card = device == "cuda"
    dev = None if on_card else device
    li, part, li_sql = range_tables(rows)
    parts = len(part["p_partkey"])
    out: dict = {"card": _smi() if on_card else "cpu", "rows": rows,
                 "parts": parts, "ranges_of_lineitem": RANGE_PIECES,
                 "batch": RANGE_BATCH}
    launches = {"groupagg_large": 0, "groupagg": 0}
    checks1: dict = {}
    checks2: dict = {}
    want_q1 = tpch.ref_q1(li)
    want_q6 = tpch.ref_q6(li)
    want_q14 = tpch.ref_q14(li, part)

    c = Cluster(n_nodes=3)
    c.create_range(b"\x00", b"\xff")
    c.pump_until(lambda: c.leaseholder(1) is not None)
    a, local = Engine(cluster=c, device=dev), Engine(device=dev)
    a.execute(tpch.DDL["lineitem"])
    a.execute(tpch.DDL["part"])
    # the same rows, without the SQL path's parse and write time
    tpch.load(local, sf=0.01, rows=rows, tables=("lineitem", "part"))
    stmts = [_insert_sql("lineitem", li_sql, lo, min(rows, lo + RANGE_BATCH))
             for lo in range(0, rows, RANGE_BATCH)]
    stmts += [_insert_sql("part", part, lo, min(parts, lo + RANGE_BATCH))
              for lo in range(0, parts, RANGE_BATCH)]
    # split first, then load: each INSERT writes into four lineitem
    # ranges (and part's two), which the append streams of raft's stale
    # responses made quadratic before the port's repair
    li_codec = RowCodec(a.store.table("lineitem").schema)
    p_codec = RowCodec(a.store.table("part").schema)
    t0 = time.perf_counter()
    for k in range(1, RANGE_PIECES):
        c.split_range(li_codec.key_from_pk((rows * k // RANGE_PIECES,)))
    c.split_range(p_codec.key_from_pk((int(part["p_partkey"][parts // 2]),)))
    c.pump(10)
    split_s = time.perf_counter() - t0
    sent = c.transport.sent
    t0 = time.perf_counter()
    for sql in stmts:
        a.execute(sql)
    load_s = time.perf_counter() - t0
    load_msgs = c.transport.sent - sent
    out.update(order="split_first", split_s=split_s,
               ranges=len(c.descriptors), load_s=load_s,
               load_rows_per_s=(rows + parts) / load_s,
               load_raft_messages=load_msgs,
               load_raft_messages_per_row=load_msgs / (rows + parts))
    print(f"phase 22: split in {split_s:.1f} s into "
          f"{len(c.descriptors)} ranges, then {rows + parts} rows through "
          f"raft in {load_s:.1f} s ({(rows + parts) / load_s:.1f} rows/s, "
          f"{load_msgs} raft messages, "
          f"{load_msgs / (rows + parts):.1f} a row)", flush=True)
    sa, sl = a.session(), local.session()
    rows_of = {}
    for q, sql, kern in (("q1", tpch.Q1, (1, 0)), ("q6", tpch.Q6, (0, 0)),
                         ("q14", tpch.Q14, (0, 0))):
        got, dt, k1, _k2 = _ranges_q(lambda: a.execute(sql, sa), f"A {q}",
                                     on_card, kern)
        launches["groupagg_large"] += kern[0]
        if k1:
            checks1[f"sf0.01 ranges A {q} phase 22"] = k1
        mine = local.execute(sql, sl)
        same_result(f"phase 22 A {q}", got, mine)
        rows_of[q] = got
        out.setdefault("first_s", {})[q] = dt
    check_q1(rows_of["q1"].rows, want_q1)
    for q, w in (("q6", want_q6), ("q14", want_q14)):
        if not _close(rows_of[q].rows[0][0], w, 1e-9):
            raise AssertionError(f"phase 22 {q}: {rows_of[q].rows} != {w}")

    # an UPDATE through A seen on B through the generation token
    b = Engine(cluster=c, device=dev)
    sb = b.session()
    before = a.clock.now().wall
    last = int(li["l_orderkey"][RANGE_UPDATE_ROWS - 1])
    n_upd = int((li["l_orderkey"] <= last).sum())
    upd = ("UPDATE lineitem SET l_quantity = l_quantity + 1 "
           f"WHERE l_orderkey <= {last}")
    sent = c.transport.sent
    t0 = time.perf_counter()
    a.execute(upd)
    upd_s = time.perf_counter() - t0
    upd_msgs = c.transport.sent - sent
    out["update"] = {"rows": n_upd, "seconds": upd_s,
                     "rows_per_s": n_upd / upd_s,
                     "raft_messages": upd_msgs,
                     "raft_messages_per_row": upd_msgs / n_upd}
    print(f"phase 22 UPDATE of split ranges: {n_upd} rows in {upd_s:.2f} s "
          f"({upd_msgs} raft messages, {upd_msgs / n_upd:.1f} a row)",
          flush=True)
    local.execute(upd)
    got_b, _dt, k1, _ = _ranges_q(lambda: b.execute(tpch.Q1, sb), "B q1",
                                  on_card, (1, 0))
    launches["groupagg_large"] += 1
    checks1["sf0.01 ranges B q1 phase 22"] = k1
    after_l = local.execute(tpch.Q1, sl)
    same_result("phase 22 B q1 after the UPDATE", got_b, after_l)
    if got_b.rows == rows_of["q1"].rows:
        raise AssertionError("phase 22: B did not see A's UPDATE")
    got_asof, _dt, k1, _ = _ranges_q(
        lambda: b.execute(_as_of(tpch.Q1, before), sb), "B q1 as of",
        on_card, (1, 0))
    launches["groupagg_large"] += 1
    checks1["sf0.01 ranges B q1 as-of phase 22"] = k1
    same_result("phase 22 B q1 AS OF before the UPDATE", got_asof,
                rows_of["q1"])

    # a lineitem range's leaseholder stops; a fresh gateway C
    rt_li = RangeTable(c, a.store.table("lineitem").schema)
    victim = c.leaseholder(c.range_for_key(rt_li.codec.span()[0] + b"\x01")
                           .range_id)
    c.stop_node(victim)
    c.pump(c.liveness.ttl + 2)
    cc = Engine(cluster=c, device=dev)
    sc = cc.session()
    got_c, _dt, k1, _ = _ranges_q(lambda: cc.execute(tpch.Q1, sc), "C q1",
                                  on_card, (1, 0))
    launches["groupagg_large"] += 1
    checks1["sf0.01 ranges C q1 phase 22"] = k1
    same_result("phase 22 C q1 after stop_node", got_c, after_l)
    c.restart_node(victim)
    c.pump(20)
    out["stopped_node"] = victim

    # the leaseholder-partitioned flow
    transport = LocalTransport()
    nodes = []
    for i in range(4):
        e = Engine(device=dev)
        e.execute(tpch.DDL["lineitem"])
        e.execute(tpch.DDL["part"])
        nodes.append(DistSQLNode(i, e, transport, cluster=c))
    li_ranges = [d for d in sorted(c.descriptors.values(),
                                   key=lambda d: d.start_key)
                 if d.start_key < rt_li.codec.span()[1]
                 and d.end_key > rt_li.codec.span()[0]]
    for i, d in enumerate(li_ranges):
        want_lh = d.replicas[i % len(d.replicas)]
        if c.leaseholder(d.range_id) != want_lh:
            c.transfer_lease(d.range_id, want_lh)
    c.pump(10)
    gw = Gateway(nodes[0], [1, 2, 3], cluster=c)
    sg = nodes[0].engine.session()
    # kernel 2 takes Q1F only under `on`
    sg_on = nodes[0].engine.session()
    nodes[0].engine.execute("SET pallas_groupagg = on", sg_on)
    holders = sorted(n for n, p in rt_li.partition_spans().items() if p)
    nh = len(holders)
    flows = {}
    for q, sql, kern, ss in (("q1", tpch.Q1, (nh, 0), sg),
                             ("q14", tpch.Q14, (0, 0), sg),
                             ("q1f", tpch.Q1F, (0, nh), sg_on)):
        got, dt, k1, k2 = _ranges_q(lambda: gw.run(sql, session=ss),
                                    f"flow {q}", on_card, kern)
        launches["groupagg_large"] += kern[0]
        launches["groupagg"] += kern[1]
        if k1:
            checks1[f"sf0.01 ranges flow {q} phase 22"] = k1
        if k2:
            checks2[f"ranges flow {q} phase 22"] = k2
        mine = a.execute(sql, sa)
        same_result(f"phase 22 flow {q}", got, mine,
                    rel=1e-5 if q == "q1f" else 1e-9)
        flows[q] = {"first_s": dt, "nodes_with_spans": nh}
    moved = li_ranges[0]
    to = next(n for n in moved.replicas if n != c.leaseholder(
        moved.range_id))
    c.transfer_lease(moved.range_id, to)
    c.pump(10)
    parts_after = rt_li.partition_spans()
    covered = sorted(p for ps in parts_after.values() for p in ps)
    lo, hi = rt_li.codec.span()
    if covered[0][0] != lo or covered[-1][1] != hi or any(
            x[1] != y[0] for x, y in zip(covered, covered[1:])):
        raise AssertionError(f"phase 22: spans {covered} do not tile "
                             "lineitem")
    nh2 = sum(1 for p in parts_after.values() if p)
    got, _dt, k1, _ = _ranges_q(lambda: gw.run(tpch.Q1, session=sg),
                                "flow q1 after transfer", on_card, (nh2, 0))
    launches["groupagg_large"] += nh2
    if k1:
        checks1["sf0.01 ranges flow q1 after transfer phase 22"] = k1
    same_result("phase 22 flow q1 after transfer_lease", got, after_l)
    flows["after_transfer"] = {"nodes_with_spans": nh2,
                               "moved_range": moved.range_id, "to": to}

    # /_debug/ranges
    node = Node(NodeConfig(cluster=c, device=dev, listen_port=0)).start()
    try:
        body = json.loads(urllib.request.urlopen(
            "http://%s:%d/_debug/ranges" % node.http_addr,
            timeout=10).read())
    finally:
        node.stop()
    if len(body["ranges"]) < RANGE_PIECES or any(
            r["leaseholder"] is None for r in body["ranges"]):
        raise AssertionError(f"phase 22 /_debug/ranges: {body}")

    # warm Q1 pairs: A against L (device busy times on the card only)
    pairs = {"A": [], "local": []}
    for _ in range(RANGE_REPS):
        for k, e, s in (("A", a, sa), ("local", local, sl)):
            pairs[k].append(_profiled(lambda e=e, s=s: e.execute(tpch.Q1, s),
                                      on_card))
    warm = {}
    for k, runs in pairs.items():
        med = statistics.median(r["wall_ms"] for r in runs)
        warm[k] = {"median_ms": med}
        if on_card:
            busy = statistics.median(r["busy_ms"] for r in runs)
            warm[k].update(busy_ms=busy, host_ms=med - busy,
                           idle_share=max(0.0, 1.0 - busy / med))
    for e in [a, b, cc, local] + [n.engine for n in nodes]:
        e.close()
    out.update(queries=out.pop("first_s"), flows=flows,
               debug_ranges=len(body["ranges"]), warm_q1=warm,
               launches=launches, seconds=time.perf_counter() - t_start)
    out["path_checks"] = checks1
    out["small_checks"] = checks2
    print("phase 22: " + json.dumps({k: v for k, v in out.items()
                                     if k not in ("path_checks",
                                                  "small_checks")}),
          flush=True)
    return out


def ranges_phase_alone(device: str = "cuda", rows: int = RANGE_ROWS) -> dict:
    """Phase 22 by itself: builds the kernels, resolves the gate and the
    launch point under a fresh cache root, and runs it (``device="cpu"``
    rehearses it on the CPU: plain-version calls stand for launches, no
    kernel checks)."""
    from cockroach_tpu_torch.ops.cuda import build
    with cache_root():
        if device == "cuda":
            build.compile_all(["groupagg_large", "groupagg"])
        kernel_infra(device)
        out = ranges_phase(device, rows)
    out["path_checks"] = len(out["path_checks"])
    out["small_checks"] = len(out["small_checks"])
    print(json.dumps({"ranges": out}), flush=True)
    return out


NC_ROWS = 6_144                 # lineitem rows node 1 takes alone
NC_BATCH = 1_000                # rows an INSERT
NC_INSERT_ROWS = 200            # then through node 2, replicated 3 ways
NC_UPDATE_ROWS = 100            # about this many rows through node 3
NC_SURVIVOR_ROWS = 10           # written through a survivor after the kill
NC_REPS = 5                     # warm Q1 runs a node (best kept)
NC_WAIT_S = 180.0               # a node's limit to serve, a failover's


class _StartProc:
    """One ``python -m cockroach_tpu_torch start`` process of phase 23:
    its stdout read by a thread of its own (the lines it prints up to
    "status: serving", by their key), its stderr into a file."""

    def __init__(self, nid: int, args: list, logdir: str):
        import os
        import queue
        import threading
        from pathlib import Path
        root = str(Path(__file__).resolve().parent)
        self.nid = nid
        self.log = os.path.join(logdir, f"n{nid}-{time.time_ns()}.err")
        self._err = open(self.log, "w")
        self.spawned = time.perf_counter()
        env = dict(os.environ, TORCH_CPP_LOG_LEVEL="ERROR")
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "cockroach_tpu_torch", "start",
             "--node-id", str(nid), "--listen-addr", "127.0.0.1:0", *args],
            cwd=root, stdout=subprocess.PIPE, stderr=self._err, text=True,
            env=env)
        self._lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()
        self.lines: dict = {}

    def _read(self):
        for line in self.proc.stdout:
            self._lines.put(line)
        self._lines.put(None)

    def serving(self, timeout: float = NC_WAIT_S) -> dict:
        """Wait for "status: serving"; returns (and keeps) the printed
        lines by key, with the spawn-to-serving seconds."""
        import queue
        deadline = time.perf_counter() + timeout
        while self.lines.get("status") != "serving":
            try:
                line = self._lines.get(
                    timeout=max(0.0, deadline - time.perf_counter()))
            except queue.Empty:
                line = None
            if line is None:
                raise AssertionError(
                    f"phase 23: node {self.nid} did not serve (exit "
                    f"{self.proc.poll()}): {self.tail()}")
            key, _, val = line.partition(":")
            self.lines[key.strip()] = val.strip()
        self.lines["spawn_to_serving_s"] = time.perf_counter() - self.spawned
        return self.lines

    @property
    def sql(self) -> tuple:
        h, p = self.lines["sql"].split("@", 1)[1].split("/", 1)[0].split(":")
        return h, int(p)

    @property
    def http(self) -> str:
        return self.lines["http"]

    def tail(self) -> str:
        if not self._err.closed:
            self._err.flush()
        with open(self.log) as f:
            return f.read()[-4000:]

    def kill(self) -> None:
        import signal
        self.proc.send_signal(signal.SIGKILL)
        self.proc.wait(timeout=30)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        try:
            self.proc.wait(timeout=30)
        finally:
            self._err.close()


def _nc_body(base: str, path: str) -> str:
    import urllib.request
    with urllib.request.urlopen(f"http://{base}{path}", timeout=30) as r:
        return r.read().decode()


def _nc_get(base: str, path: str):
    return json.loads(_nc_body(base, path))


def _nc_launches(base: str, on_card: bool) -> int:
    """Kernel 1's launches in the node behind ``base`` (its plain
    version's calls off the card), read from its /_status/vars."""
    name = ("kernel_groupagg_large_launches" if on_card
            else "kernel_groupagg_large_plain_calls")
    for line in _nc_body(base, "/_status/vars").splitlines():
        if line.startswith(name + " "):
            return int(float(line.split()[1]))
    raise AssertionError(f"phase 23: {name} missing at {base}")


def _nc_sql(addr, sqls: list, timeout: float = NC_WAIT_S) -> list:
    """Each statement through one pgwire session of the node at
    ``addr``; the rows of each."""
    from cockroach_tpu_torch.server.miniclient import MiniClient
    c = MiniClient(*addr, timeout=timeout)
    try:
        return [c.query(q)[1] for q in sqls]
    finally:
        c.close()


def _nc_q1(node, want, on_card: bool, reps: int = NC_REPS) -> dict:
    """Q1 through ``node``'s pgwire: the first run and ``reps`` warm
    runs, each equal to ``want`` (check_q1); kernel 1 must launch once a
    run in that node's process (its /_status/vars, read before and
    after). Returns the rows, first and best seconds and launches."""
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.server.miniclient import MiniClient
    k0 = _nc_launches(node.http, on_card)
    c = MiniClient(*node.sql, timeout=NC_WAIT_S)
    times, rows = [], None
    try:
        for _ in range(1 + reps):
            t0 = time.perf_counter()
            got = c.query(tpch.Q1)[1]
            times.append(time.perf_counter() - t0)
            check_q1(got, want)
            if rows is not None and got != rows:
                raise AssertionError(f"phase 23 n{node.nid}: Q1 changed "
                                     f"between runs: {got} != {rows}")
            rows = got
    finally:
        c.close()
    n = _nc_launches(node.http, on_card) - k0
    if n != 1 + reps:
        raise AssertionError(f"phase 23 n{node.nid}: kernel 1 launched {n} "
                             f"times in {1 + reps} Q1 runs")
    return {"rows": rows, "first_s": times[0],
            "best_s": min(times[1:]) if reps else None, "launches": n}


# what a statement meets while a lease moves or a replica catches up
# (the range plane's own messages): nothing of it was applied
NC_TRANSIENT = ("not leaseholder", "no leaseholder",
                "no reachable leaseholder", "breaker tripped")
# a read may also time out at a peer that just died; a write may not be
# retried on that (its proposal's fate is unknown)
NC_TRANSIENT_READ = NC_TRANSIENT + ("timed out",)


class _NotYet(Exception):
    """A cluster view that converges within its limit has not yet: a
    liveness record lapsed under load, a dead node not yet marked."""


def _nc_retry(fn, what: str, transient: tuple = NC_TRANSIENT_READ,
              timeout: float = NC_WAIT_S) -> tuple:
    """``fn()`` until it returns, retrying only what a moving lease or a
    catching-up replica raises: a refused or reset connection, a PgError
    whose message holds one of ``transient`` (or, from an engine of this
    process, the RuntimeError or NotLeaseholderError of the range plane
    whose message holds one), or _NotYet. Anything else,
    a wrong answer's AssertionError first, ends the run at once, and so
    does a retried error past ``timeout``. Returns (``fn()``'s result,
    the errors retried: a count by kind)."""
    from cockroach_tpu_torch.kvserver.cluster import NotLeaseholderError
    from cockroach_tpu_torch.server.miniclient import PgError
    deadline = time.perf_counter() + timeout
    retried: dict = {}
    while True:
        try:
            return fn(), retried
        except (PgError, OSError, _NotYet, RuntimeError,
                NotLeaseholderError) as e:
            kind = type(e).__name__
            if isinstance(e, _NotYet):
                kind = str(e).split(":")[0]      # which view
            elif isinstance(e, (PgError, RuntimeError,
                                NotLeaseholderError)):
                kind = next((t for t in transient if t in str(e)), None)
                if kind is None:
                    raise
            if time.perf_counter() > deadline:
                raise AssertionError(f"phase 23: {what} failed past "
                                     f"{timeout} s: {e}") from e
            retried[kind] = retried.get(kind, 0) + 1
            time.sleep(0.1)


def _nc_cli(argv: list) -> str:
    import contextlib
    import io

    from cockroach_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"phase 23: cli {argv} exited {rc}")
    return buf.getvalue()


def _nc_status(nodes: dict, dead: set, tracez_from, want_nodes) -> dict:
    """The status plane: /_status/nodes on every live node lists each
    other node healthy and the dead ones not; /debug/tracez?cluster=1
    from ``tracez_from`` merges the rings of ``want_nodes`` (each with a
    lineitem entry), partial exactly when a node is dead; `node status`
    and `debug ranges` read a node's status URL. A peer's health, the
    fan-out's answering nodes and the dead node's SUSPECT line converge
    within the liveness TTL and the fan-out's timeout: short of them it
    raises _NotYet; any other fault, AssertionError."""
    out = {}
    for nid, node in nodes.items():
        if nid in dead:
            continue
        o = _nc_get(node.http, "/_status/nodes")
        if o["node_id"] != nid:
            raise AssertionError(f"phase 23 n{nid} /_status/nodes: {o}")
        health = {int(p): v["healthy"] for p, v in o["peers"].items()}
        for p in set(nodes) - {nid}:
            if health.get(p) is not (p not in dead):
                raise _NotYet(f"phase 23 n{nid} /_status/nodes: peer {p} "
                              f"{health}, dead {dead}")
        out[f"n{nid}_peers"] = health
    body = _nc_get(tracez_from.http, "/debug/tracez?cluster=1&timeout=2")
    by_node: dict = {}
    for t in body["traces"]:
        if "lineitem" in t.get("sql", ""):
            by_node[t["node"]] = by_node.get(t["node"], 0) + 1
    if sorted(by_node) != sorted(body["nodes"]):
        raise AssertionError(f"phase 23 tracez?cluster=1 from "
                             f"n{tracez_from.nid}: nodes {body['nodes']}, "
                             f"entries {by_node}")
    if body["partial"] is not bool(dead) or sorted(body["nodes"]) != \
            sorted(want_nodes):
        raise _NotYet(f"phase 23 tracez?cluster=1 from n{tracez_from.nid}: "
                      f"partial {body['partial']}, nodes {body['nodes']}, "
                      f"dead {dead}")
    out["tracez"] = {"from": tracez_from.nid, "partial": body["partial"],
                     "nodes": body["nodes"], "entries": by_node}
    text = _nc_cli(["node", "status", "--url", tracez_from.http])
    if not text.startswith(f"node {tracez_from.nid}  v"):
        raise AssertionError(f"phase 23 node status: {text}")
    if dead and "SUSPECT" not in text:
        raise _NotYet(f"phase 23 node status: {text}")
    text = _nc_cli(["debug", "ranges", "--url", tracez_from.http])
    if not text.startswith("r1: ") or "leaseholder=" not in text:
        raise AssertionError(f"phase 23 debug ranges: {text}")
    out["debug_ranges"] = text.strip()
    return out


class NetClusterRun:
    """Phase 23: raft over TCP, in two halves. ``first()``: three `python
    -m cockroach_tpu_torch start --device <device> --kv-addr` processes
    on the one card. Node 1 (`--bootstrap`) alone takes the sf 0.01
    generator's first NC_ROWS lineitem rows through its pgwire in INSERTs
    of NC_BATCH (rows/s printed), into one range; nodes 2 and 3 then
    start with `--join 1@<node 1's kv address>`, one after the other, and
    are up-replicated onto (seconds printed). NC_INSERT_ROWS more rows go
    in through node 2 and an UPDATE of about NC_UPDATE_ROWS rows through
    node 3, each replicated three ways. ``first()`` touches nothing of
    this process's engines or kernel counts, so the whole run drives it
    from a thread beside other phases (``start_thread``/``join``; its
    timings are then not taken alone, and ``first_half_beside`` names
    those phases). ``second()``, with nothing else running in this
    process: Q1 through each node's pgwire (first and best of NC_REPS)
    equals the numpy oracle over the final rows, and every node's rows
    are equal; kernel 1 launches once a run in each node's process, read
    from its /_status/vars. This process joins as node 4 (NetCluster(4,
    join=...), Engine(cluster=n4) on the card: a gateway with no
    replica); its Q1 runs equal the oracle, each launch held against the
    plain version at its own slots, with busy ms and idle share. The
    status plane is read (_nc_status). Then the leaseholder's process is
    killed with SIGKILL: the first answer to Q1 on a survivor must equal
    the oracle (kill to that answer: the failover seconds; only a moving
    lease's errors are retried, _nc_retry), Q1 on the other survivor
    too, NC_SURVIVOR_ROWS rows go in through a survivor, the status
    plane shows the dead node, and the killed node restarts with `--join
    <a survivor>` on its old kv address and answers Q1 with that write
    (spawn to that answer: the rejoin seconds). ``second()`` returns the
    `netcluster` line's numbers, with "launches", "path_checks" and
    "retried" (each retried error, by step and kind); ``stop()`` ends
    every process and node it started."""

    def __init__(self, device: str = "cuda"):
        import socket
        import tempfile
        self.t_start = time.perf_counter()
        self.device = device
        self.on_card = device == "cuda"
        total = NC_ROWS + NC_INSERT_ROWS + NC_SURVIVOR_ROWS
        li, _part, self.li_sql = range_tables(total)
        # the oracle's arrays; li_sql keeps the rows as inserted
        self.li = {k: v.copy() for k, v in li.items()}
        self.last = int(self.li["l_orderkey"][NC_UPDATE_ROWS - 1])
        upd = self.li["l_orderkey"][:NC_ROWS + NC_INSERT_ROWS] <= self.last
        self.li["l_quantity"][:NC_ROWS + NC_INSERT_ROWS][upd] += 1
        self.out: dict = {
            "card": _smi() if self.on_card else "cpu", "rows": NC_ROWS,
            "batch": NC_BATCH, "insert_rows": NC_INSERT_ROWS,
            "update_rows": int(upd.sum()),
            "survivor_rows": NC_SURVIVOR_ROWS, "first_half_beside": [],
            "retried": {}}
        self.kv_ports = {}
        for nid in (1, 2, 3):
            with socket.socket() as sk:
                sk.bind(("127.0.0.1", 0))
                self.kv_ports[nid] = sk.getsockname()[1]
        self.logdir = tempfile.mkdtemp(prefix="phase23-")
        self.procs: list = []
        self.nodes: dict = {}
        self.n4 = self.eng4 = None
        self._thread = None
        self._error = None

    def oracle(self, n: int) -> list:
        from cockroach_tpu_torch.models import tpch
        return tpch.ref_q1({k: v[:n] for k, v in self.li.items()})

    def _start(self, nid: int, extra: list) -> "_StartProc":
        p = _StartProc(nid, ["--device", self.device, "--kv-addr",
                             f"127.0.0.1:{self.kv_ports[nid]}", *extra],
                       self.logdir)
        self.procs.append(p)
        self.nodes[nid] = p
        return p

    def _retry(self, fn, what: str, **kw):
        """_nc_retry, its retried errors kept under "retried"."""
        res, retried = _nc_retry(fn, what, **kw)
        if retried:
            self.out["retried"][what] = retried
        return res

    def _failed(self) -> None:
        for p in self.procs:
            print(f"phase 23 node {p.nid} stderr (exit {p.proc.poll()}):\n"
                  f"{p.tail()}", file=sys.stderr, flush=True)

    def first(self) -> None:
        from cockroach_tpu_torch.models import tpch
        out, nodes = self.out, self.nodes
        try:
            # 1-2. node 1 alone, the load through its pgwire
            self._start(1, ["--bootstrap"]).serving()
            out["spawn_to_serving_s"] = {
                "n1": nodes[1].lines["spawn_to_serving_s"]}
            stmts = [tpch.DDL["lineitem"]]
            stmts += [_insert_sql("lineitem", self.li_sql, lo,
                                  min(NC_ROWS, lo + NC_BATCH))
                      for lo in range(0, NC_ROWS, NC_BATCH)]
            t0 = time.perf_counter()
            _nc_sql(nodes[1].sql, stmts)
            load_s = time.perf_counter() - t0
            out.update(load_s=load_s, load_rows_per_s=NC_ROWS / load_s)
            print(f"phase 23 load: {NC_ROWS} rows through node 1's raft "
                  f"in {load_s:.1f} s ({NC_ROWS / load_s:.1f} rows/s)",
                  flush=True)

            # 3. nodes 2 and 3 join and are replicated onto, one after
            # the other (two joins served at once race in the seed's
            # replicate_queue_scan); a joiner's reads may meet
            # NotLeaseholder until its replica has caught up, so each
            # must first answer count(*) with every row (its refresh
            # from ranges, too)
            t0 = time.perf_counter()
            for nid in (2, 3):
                self._start(nid, ["--join", f"1@127.0.0.1:"
                                  f"{self.kv_ports[1]}"]).serving()
                out["spawn_to_serving_s"][f"n{nid}"] = nodes[nid].lines[
                    "spawn_to_serving_s"]
            r1 = _nc_get(nodes[1].http, "/_debug/ranges")["ranges"]
            if len(r1) != 1 or sorted(r1[0]["replicas"]) != [1, 2, 3]:
                raise AssertionError(f"phase 23: ranges after the joins: "
                                     f"{r1}")
            out["up_replication_s"] = time.perf_counter() - t0
            for nid in (2, 3):
                n = self._retry(lambda nid=nid: _nc_sql(
                    nodes[nid].sql, ["SELECT count(*) FROM lineitem"]),
                    f"count(*) on node {nid} after its join")[0][0][0]
                if n != NC_ROWS:
                    raise AssertionError(f"phase 23: node {nid} counts {n} "
                                         f"rows, not {NC_ROWS}")
            out["joined_to_reading_s"] = time.perf_counter() - t0
            print(f"phase 23: nodes 2 and 3 joined and were replicated "
                  f"onto in {out['up_replication_s']:.1f} s, and read every "
                  f"row {out['joined_to_reading_s']:.1f} s after node 2's "
                  "spawn", flush=True)

            # 5. writes replicated three ways
            t0 = time.perf_counter()
            _nc_sql(nodes[2].sql, [_insert_sql(
                "lineitem", self.li_sql, NC_ROWS, NC_ROWS + NC_INSERT_ROWS)])
            out["insert_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            _nc_sql(nodes[3].sql, ["UPDATE lineitem SET l_quantity = "
                                   "l_quantity + 1 WHERE l_orderkey <= "
                                   f"{self.last}"])
            out["update_s"] = time.perf_counter() - t0
            print(f"phase 23: {NC_INSERT_ROWS} rows through node 2 in "
                  f"{out['insert_s']:.2f} s, UPDATE of "
                  f"{out['update_rows']} rows through node 3 in "
                  f"{out['update_s']:.2f} s", flush=True)
            out["first_half_s"] = time.perf_counter() - self.t_start
        except BaseException:
            self._failed()
            raise

    def start_thread(self) -> None:
        """``first()`` in a thread of its own (its error kept for
        ``join``)."""
        import threading

        def run():
            try:
                self.first()
            except BaseException as e:   # re-raised by join()
                self._error = e
        self._thread = threading.Thread(target=run, name="phase23",
                                        daemon=True)
        self._thread.start()

    def beside(self, phase: str) -> bool:
        """Whether ``first()``'s thread is running as ``phase`` starts
        (then named in "first_half_beside")."""
        running = self._thread is not None and self._thread.is_alive()
        if running:
            self.out["first_half_beside"].append(phase)
        return running

    def join(self) -> float:
        """Wait for ``first()``'s thread and raise its error; returns the
        seconds waited."""
        t0 = time.perf_counter()
        self._thread.join()
        if self._error is not None:
            raise self._error
        return time.perf_counter() - t0

    def second(self) -> dict:
        from cockroach_tpu_torch.exec.engine import Engine
        from cockroach_tpu_torch.kvserver.netcluster import NetCluster
        from cockroach_tpu_torch.models import tpch
        from cockroach_tpu_torch.server.node import register_status_sources
        out, nodes, on_card = self.out, self.nodes, self.on_card
        want = self.oracle(NC_ROWS + NC_INSERT_ROWS)
        checks: dict = {}
        q1: dict = {}
        try:
            # 6-7. Q1 on every node, kernel 1 in each process
            t_second = time.perf_counter()
            for nid in (1, 2, 3):
                _nc_sql(nodes[nid].sql, [
                    "SET CLUSTER SETTING sql.trace.slow_statement."
                    "threshold = 0.000001"])
                q1[f"n{nid}"] = _nc_q1(nodes[nid], want, on_card)
            if len({repr(r["rows"]) for r in q1.values()}) != 1:
                raise AssertionError(f"phase 23: Q1 rows differ between "
                                     f"nodes: {q1}")

            # 8. this process joins as node 4, a gateway with no replica
            self.n4 = n4 = NetCluster(
                4, join={1: ("127.0.0.1", self.kv_ports[1])})
            n4.join()
            self.eng4 = eng4 = Engine(
                cluster=n4, device=None if on_card else self.device)
            eng4.settings.set("sql.trace.slow_statement.threshold", 1e-6)
            register_status_sources(n4, eng4)
            s4 = eng4.session()
            runs4 = []
            for i in range(1 + NC_REPS):
                got: dict = {}

                def q1_4():
                    got["res"] = eng4.execute(tpch.Q1, s4)
                # a moving lease's error is asked again, as over pgwire
                prof, dt, k1, _k2 = self._retry(
                    lambda: _ranges_q(lambda: _profiled(q1_4, on_card),
                                      f"n4 q1 run {i + 1}", on_card, (1, 0),
                                      phase=23),
                    f"Q1 run {i + 1} on node 4")
                if k1:
                    checks[f"sf0.01 netcluster n4 q1 run {i + 1} "
                           "phase 23"] = k1
                check_q1(got["res"].rows, want)
                runs4.append(dict(prof, wall_s=dt))
            if n4.store.replicas:
                raise AssertionError(f"phase 23: node 4 holds replicas "
                                     f"{sorted(n4.store.replicas)}")
            warm = runs4[1:]
            q1["n4"] = {
                "first_s": runs4[0]["wall_s"],
                "best_s": min(r["wall_ms"] for r in warm) / 1e3,
                "launches": len(runs4),
                "busy_ms": statistics.median(r["busy_ms"] for r in warm)
                if on_card else None,
                "idle_share": statistics.median(
                    r["idle_share"] for r in warm) if on_card else None}
            out["q1"] = {k: {kk: vv for kk, vv in v.items() if kk != "rows"}
                         for k, v in q1.items()}
            print("phase 23 Q1: " + json.dumps(out["q1"]), flush=True)

            # 10. the status plane, every node live (a renewal of a
            # replicated liveness record can miss NetCluster.LIVE_TTL_NS
            # under load: the view is read again until it holds)
            out["status_before"] = self._retry(lambda: _nc_status(
                nodes, set(), nodes[2], [1, 2, 3, 4]),
                "the status plane before the kill", timeout=30.0)

            # 9. SIGKILL the leaseholder's process
            lh = _nc_get(nodes[2].http, "/_debug/ranges")["ranges"][0][
                "leaseholder"]
            if lh not in nodes:
                raise AssertionError(f"phase 23: leaseholder {lh}")
            out["killed"] = lh
            launches = {f"n{nid}": _nc_launches(nodes[nid].http, on_card)
                        for nid in nodes}
            survivors = [n for n in (1, 2, 3) if n != lh]
            t_kill = time.perf_counter()
            nodes[lh].kill()
            # the first answer must be right: a wrong one is not retried
            after = {}
            after[f"n{survivors[0]}"] = self._retry(
                lambda: _nc_q1(nodes[survivors[0]], want, on_card, reps=0),
                f"Q1 on node {survivors[0]} after the kill")
            out["failover_s"] = time.perf_counter() - t_kill
            after[f"n{survivors[1]}"] = self._retry(
                lambda: _nc_q1(nodes[survivors[1]], want, on_card, reps=0),
                f"Q1 on node {survivors[1]} after the kill")
            t0 = time.perf_counter()
            self._retry(lambda: _nc_sql(nodes[survivors[0]].sql, [_insert_sql(
                "lineitem", self.li_sql, NC_ROWS + NC_INSERT_ROWS,
                NC_ROWS + NC_INSERT_ROWS + NC_SURVIVOR_ROWS)]),
                f"the write through node {survivors[0]}",
                transient=NC_TRANSIENT)
            out["survivor_write_s"] = time.perf_counter() - t0
            want = self.oracle(NC_ROWS + NC_INSERT_ROWS + NC_SURVIVOR_ROWS)
            for nid in survivors:
                after[f"n{nid}"] = _nc_q1(nodes[nid], want, on_card, reps=0)
            print(f"phase 23: node {lh} killed; Q1 on node {survivors[0]} "
                  f"answered, correct, {out['failover_s']:.2f} s after the "
                  f"kill; {NC_SURVIVOR_ROWS} rows through it in "
                  f"{out['survivor_write_s']:.2f} s", flush=True)
            # the dead node's replicated liveness record lapses within
            # NetCluster.LIVE_TTL_NS
            out["status_after_kill"] = self._retry(lambda: _nc_status(
                nodes, {lh}, nodes[survivors[0]], [*survivors, 4]),
                "the status plane after the kill", timeout=30.0)

            # the killed node rejoins through a survivor
            killed = nodes[lh]
            t0 = time.perf_counter()
            self._start(lh, ["--join", f"{survivors[0]}@127.0.0.1:"
                             f"{self.kv_ports[survivors[0]]}"]).serving()
            # its first reads may meet NotLeaseholder while it catches up;
            # its first answer must hold the survivor's write
            after[f"n{lh} rejoined"] = self._retry(
                lambda: _nc_q1(nodes[lh], want, on_card, reps=0),
                f"Q1 on the rejoined node {lh}")
            out["rejoin_s"] = time.perf_counter() - t0
            out["rejoin_spawn_to_serving_s"] = nodes[lh].lines[
                "spawn_to_serving_s"]
            killed.stop()
            out["after_kill_q1"] = {k: {kk: vv for kk, vv in v.items()
                                        if kk != "rows"}
                                    for k, v in after.items()}
            # the rejoin may move a lease under node 4's read, as it may
            # under its runs above: that error is asked again
            res, _dt, k1, _ = self._retry(
                lambda: _ranges_q(lambda: eng4.execute(tpch.Q1, s4),
                                  "n4 q1 after the rejoin", on_card, (1, 0),
                                  phase=23),
                "Q1 on node 4 after the rejoin")
            check_q1(res.rows, want)
            if k1:
                checks["sf0.01 netcluster n4 q1 after the rejoin "
                       "phase 23"] = k1
            for nid in nodes:
                key = f"n{nid}" + (" rejoined" if nid == lh else "")
                launches[key] = _nc_launches(nodes[nid].http, on_card)
            launches["n4"] = len(runs4) + 1
            out["kernel1_launches"] = launches
            print(f"phase 23: node {lh} rejoined and answered Q1 with the "
                  f"survivor's write {out['rejoin_s']:.1f} s after its "
                  f"spawn; kernel 1 launches by process: {launches}; "
                  f"errors retried: {out['retried']}", flush=True)
        except BaseException:
            self._failed()
            raise
        finally:
            self.stop()
        out["second_half_s"] = time.perf_counter() - t_second
        out["launches"] = {"groupagg_large": sum(launches.values()),
                           "groupagg": 0}
        out["seconds"] = out["first_half_s"] + out["second_half_s"]
        out["path_checks"] = checks
        print("phase 23: " + json.dumps({k: v for k, v in out.items()
                                         if k != "path_checks"}), flush=True)
        return out

    def stop(self) -> None:
        if self.eng4 is not None:
            self.eng4.close()
            self.eng4 = None
        if self.n4 is not None:
            self.n4.stop()
            self.n4 = None
        for p in self.procs:
            p.stop()


def netcluster_phase(device: str = "cuda") -> dict:
    """Phase 23 in one go (NetClusterRun's two halves, one after the
    other)."""
    run = NetClusterRun(device)
    try:
        run.first()
        return run.second()
    finally:
        run.stop()


def netcluster_phase_alone(device: str = "cuda") -> dict:
    """Phase 23 by itself: builds the kernels, resolves the gate and the
    launch point under a fresh cache root, and runs it (``device="cpu"``
    rehearses it on the CPU: plain-version calls stand for launches, no
    kernel checks)."""
    from cockroach_tpu_torch.ops.cuda import build
    with cache_root():
        if device == "cuda":
            build.compile_all(["groupagg_large", "groupagg"])
        kernel_infra(device)
        out = netcluster_phase(device)
    out["path_checks"] = len(out["path_checks"])
    print(json.dumps({"netcluster": out}), flush=True)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    import argparse
    ap = argparse.ArgumentParser(description="Build and drive the port "
                                 "on one card.")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="also profile the phase 6 queries into DIR")
    opts = ap.parse_args()

    with cache_root():
        return _main(opts)


def _main(opts) -> int:
    import torch
    # -- 24. graftlint, alone, before the first card phase ------------------
    lint = analysis_phase()
    t_start = time.perf_counter()
    kernels, smi, name, dml = sf1_phases(opts)
    # the SF1 engines and tables went with sf1_phases' frame: free what
    # the allocator still caches before SF3 loads
    gc.collect()
    torch.cuda.empty_cache()

    # -- 10. beyond memory at SF3 ----------------------------------------------
    t0 = time.perf_counter()
    stream = beyond_memory_phase(reps=1)
    kernels[0]["launches"] += sum(stream["kernel1_launches"].values())
    kernels[0]["phase10_launches"] = stream["kernel1_launches"]
    kernels[0]["path_checks"].update(stream.pop("path_checks"))
    print(f"phase 10: {time.perf_counter() - t0:.1f} s; all phases "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"stream": stream}), flush=True)

    # -- 25. the reference's logic corpus on the card ----------------------
    t0 = time.perf_counter()
    for line in logic_phase():
        for i, k in enumerate(("groupagg_large", "groupagg")):
            kernels[i]["launches"] += line["launches"][k]
            kernels[i].setdefault("phase25_launches", {})[line["config"]] = \
                line["launches"][k]
        if line["path_checks"]:
            kernels[0]["path_checks"][f"phase 25 {line['config']}"] = \
                line["path_checks"]
        if line["small_checks"]:
            kernels[1]["path_checks"][f"phase 25 {line['config']}"] = \
                line["small_checks"]
    print(f"phase 25: {time.perf_counter() - t0:.1f} s", flush=True)
    oltp = dml.pop("oltp")
    front = dml.pop("frontdoor")
    obs = dml.pop("observability")
    hist = dml.pop("history")
    jobs = dml.pop("jobs")
    cold = dml.pop("coldstart")
    dist = dml.pop("distributed")
    flows = dml.pop("flows")
    pod = dml.pop("pod")
    elastic = dml.pop("elastic")
    ranges = dml.pop("ranges")
    netc = dml.pop("netcluster")
    obs["node"] = front["entry_points"].pop("observability")
    print(json.dumps({"dml": dict(dml, card=smi)}), flush=True)
    print(json.dumps({"oltp": dict(oltp, card=smi)}), flush=True)
    print(json.dumps({"frontdoor": dict(front, card=smi)}), flush=True)
    print(json.dumps({"observability": dict(obs, card=smi)}), flush=True)
    print(json.dumps({"history": dict(hist, card=smi)}), flush=True)
    print(json.dumps({"jobs": dict(jobs, card=smi)}), flush=True)
    print(json.dumps({"coldstart": dict(cold, card=smi)}), flush=True)
    print(json.dumps({"distributed": dict(dist, card=smi)}), flush=True)
    print(json.dumps({"flows": dict(flows, card=smi)}), flush=True)
    print(json.dumps({"pod": dict(pod, card=smi)}), flush=True)
    print(json.dumps({"elastic": dict(elastic, card=smi)}), flush=True)
    print(json.dumps({"ranges": dict(ranges, card=smi)}), flush=True)
    print(json.dumps({"netcluster": dict(netc, card=smi)}), flush=True)
    print(json.dumps({"analysis": lint}), flush=True)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def sf1_phases(opts) -> tuple:
    """Phases 1-9 and 11-23 (phases 22 and 23 at their own scale; 23's
    first half in a thread beside 22, 14 and 11, each line saying
    whether it overlapped); returns
    (kernels, nvidia-smi line, card name, phase 11's numbers with phase
    12's under "oltp", phase 13's under "frontdoor", 14's under
    "observability", 15's under "history", 16's under "jobs", 17's under
    "coldstart", 18's under "distributed", 19's under "flows", 20's
    under "pod", 21's under "elastic", 22's under "ranges" and 23's
    under "netcluster"). Every
    engine and table of these
    phases lives in this frame only, so they are freed when it
    returns."""
    import numpy as np
    import torch

    from cockroach_tpu_torch.exec import compile as C
    from cockroach_tpu_torch.exec.engine import Engine
    from cockroach_tpu_torch.models import tpch
    from cockroach_tpu_torch.ops import agg as aggops
    from cockroach_tpu_torch.ops import join, sortkey
    from cockroach_tpu_torch.ops.cuda import build
    from cockroach_tpu_torch.ops.cuda import groupagg as tg
    from cockroach_tpu_torch.ops.cuda import groupagg_large as tgl
    from cockroach_tpu_torch.ops.cuda.groupagg_large_check import (
        synthetic_slots)

    t_start = time.perf_counter()
    smi = _smi()
    name = torch.cuda.get_device_name(0)
    print(f"card: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name}", flush=True)

    # -- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    logs = build.compile_all(["groupagg_large", "groupagg"])
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    # the parity gate's verdicts and kernel 1's launch point, as the
    # first `auto` plan build would resolve them (phase 17 reports them)
    infra = kernel_infra()

    # -- 2. main path ---------------------------------------------------
    t0 = time.perf_counter()
    eng = Engine()
    tpch.load(eng, sf=SF, tables=("lineitem", "part"), encoded=True)
    n_rows = eng.store.table("lineitem").row_count
    li = tpch.gen_lineitem(SF, encoded=True)
    # phase 17's cold-start children ingest the dictionary codes
    li_codes = {c: li[c] for c in ("l_returnflag", "l_linestatus")}
    li["l_returnflag"] = np.asarray(tpch.RF_VALUES)[li["l_returnflag"]]
    li["l_linestatus"] = np.asarray(tpch.LS_VALUES)[li["l_linestatus"]]
    part = tpch.gen_part(SF)
    want_q1, want_q6 = ref_q1_codes(dict(li, **li_codes)), tpch.ref_q6(li)
    want_q14 = tpch.ref_q14(li, part)
    print(f"load SF{SF}: {n_rows} lineitem rows, "
          f"{eng.store.table('part').row_count} part rows, "
          f"{time.perf_counter() - t0:.1f} s (host generate + ingest + "
          "ANALYZE + oracle)", flush=True)
    s_on = eng.session()
    eng.execute("SET pallas_groupagg = on", s_on)

    captured = {}
    recorded = (tgl.aggregate_slots, tg.dense_group_aggregate,
                C.hash_join, aggops.group_count)
    liveness_counts = {}

    def counting_group_count(*args, **kw):
        liveness_counts[q] = liveness_counts.get(q, 0) + 1
        return recorded[3](*args, **kw)

    def recorder(key, fn):
        def recording(*args, **kw):
            captured.setdefault(key, (args, kw))
            return fn(*args, **kw)
        return recording

    main_path = [("q1", tpch.Q1, None), ("q6", tpch.Q6, None),
                 ("q14", tpch.Q14, None), ("q1f", tpch.Q1F, s_on),
                 ("q6f", tpch.Q6F, s_on)]
    tgl.aggregate_slots = recorder("q1", recorded[0])
    C.hash_join = recorder("q14", recorded[2])
    aggops.group_count = counting_group_count
    rows, per_query = {}, {}
    launches = {"groupagg_large": 0, "groupagg": 0}
    try:
        for q, sql, sess in main_path:
            tg.dense_group_aggregate = recorder(q, recorded[1])
            tgl.LAUNCHES = tg.LAUNCHES = 0
            rows[q] = eng.execute(sql, sess).rows
            torch.cuda.synchronize()
            per_query[q] = {"groupagg_large": tgl.LAUNCHES,
                            "groupagg": tg.LAUNCHES}
            for k, v in per_query[q].items():
                launches[k] += v
    finally:
        tgl.aggregate_slots, tg.dense_group_aggregate, \
            C.hash_join, aggops.group_count = recorded
    print(f"main path launches: {launches} (per query: {per_query}); "
          f"plain group-liveness counts: {liveness_counts}", flush=True)
    if per_query["q1"]["groupagg_large"] != 1:
        raise AssertionError("Q1 did not launch the large-G kernel once")
    for q in ("q1f", "q6f"):
        if per_query[q] != {"groupagg_large": 0, "groupagg": 1}:
            raise AssertionError(f"{q} did not launch the small-G kernel "
                                 f"once: {per_query[q]}")
        if liveness_counts.get(q):
            raise AssertionError(f"{q} counted group liveness beside the "
                                 "kernel")
    check_q1(rows["q1"], want_q1)
    if not _close(rows["q6"][0][0], want_q6, 1e-9):
        raise AssertionError(f"Q6 {rows['q6'][0][0]} != oracle {want_q6}")
    if not _close(rows["q14"][0][0], want_q14, 1e-9):
        raise AssertionError(f"Q14 {rows['q14'][0][0]} != oracle "
                             f"{want_q14}")
    jargs, jkw = captured["q14"]
    if not jkw.get("direct") or jkw["direct"][0] == "packed":
        raise AssertionError(f"Q14 did not direct-address its join: "
                             f"{jkw.get('direct')}")
    q1f_err = check_float("Q1F", rows["q1f"], want_q1)
    q6f_err = check_float("Q6F", rows["q6f"], [(want_q6,)])
    q1_on = eng.execute(tpch.Q1, s_on).rows
    if q1_on != rows["q1"]:
        raise AssertionError(f"Q1 under on {q1_on} != auto {rows['q1']}")
    print(f"Q1 ok ({len(rows['q1'])} groups), Q6 ok ({rows['q6'][0][0]}), "
          f"Q14 ok ({rows['q14'][0][0]}, direct {jkw['direct']}), "
          f"Q1F ok (max rel err {q1f_err}), Q6F ok ({rows['q6f'][0][0]}, "
          f"rel err {q6f_err}), Q1 on == auto", flush=True)

    # -- 3. off path, end-to-end times ------------------------------------
    s_off = eng.session()
    eng.execute("SET pallas_groupagg = off", s_off)
    q1_off = eng.execute(tpch.Q1, s_off).rows
    for a, o in zip(rows["q1"], q1_off):
        if tuple(a[:6]) != tuple(o[:6]) or a[9] != o[9]:
            raise AssertionError(f"Q1 off {o} != kernel path {a}")
    print("Q1 off: DECIMAL sums and counts equal the kernel path",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    before = (tgl.LAUNCHES, tg.LAUNCHES)
    e2e = {
        "q1_ms": _median_ms(lambda: eng.execute(tpch.Q1)),
        "q6_ms": _median_ms(lambda: eng.execute(tpch.Q6)),
        "q1_off_ms": _median_ms(lambda: eng.execute(tpch.Q1, s_off)),
        "q14_ms": _median_ms(lambda: eng.execute(tpch.Q14)),
        "q1f_ms": _median_ms(lambda: eng.execute(tpch.Q1F, s_on)),
        "q6f_ms": _median_ms(lambda: eng.execute(tpch.Q6F, s_on)),
    }
    if (tgl.LAUNCHES - before[0], tg.LAUNCHES - before[1]) != (5, 10):
        raise AssertionError("each timed Q1, Q1F and Q6F must launch its "
                             "kernel once")
    for q in ("q1", "q6", "q1_off", "q14", "q1f", "q6f"):
        e2e[f"{q}_rows_per_s"] = n_rows / (e2e[f"{q}_ms"] / 1e3)
    e2e["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    print("end-to-end (median of 5 warm runs): "
          + json.dumps(e2e), flush=True)

    # -- 4. kernels vs plain ----------------------------------------------
    q1_args = slot_args(captured, "q1")
    errs, _ = compare_slots(tgl, q1_args, "Q1 SF1")
    compare_slots(tgl, synthetic_slots(1 << 23, 12, 9, 5),
                  "slots G=12, negative int64, INT64_MIN/MAX")
    compare_slots(tgl, synthetic_slots(1 << 22, 200_000, 14, 6),
                  "slots G=200000 global atomics, negative int64")
    compare_slots(tgl, synthetic_slots(1 << 20, 300, 9, 7, gid_lo=-64,
                                       gid_hi=364, sel_frac=0.0),
                  "slots all masked, gid out of range")
    compare_kernel(tgl, synthetic(1 << 23, 4096, 1, 3, (tgl.MIN, tgl.MAX),
                                  1), "G=4096 shared memory")
    compare_kernel(tgl, synthetic(1 << 23, 200_000, 1, 2, (tgl.MAX,), 2),
                   "G=200000 global atomics")
    compare_kernel(tgl, synthetic(1 << 20, 300, 1, 2, (tgl.MIN,), 3,
                                  gid_lo=-64, gid_hi=364, sel_frac=0.0),
                   "all masked, gid out of range")
    nz = synthetic(1 << 20, 4096, 1, 1, (tgl.MIN, tgl.MAX), 4)
    r = torch.arange(1 << 20, device="cuda")
    nz_mm = tuple(torch.where(r % 7 == 0, -0.0, torch.where(
        (nz[0] % 97 == 5) & (r % 11 == 0), float("nan"), c)) for c in nz[3])
    compare_kernel(tgl, nz[:3] + (nz_mm,) + nz[4:],
                   "MIN/MAX with -0.0 and NaN")

    q1_numbers = slot_numbers(tgl, q1_args)
    print("large kernel numbers [Q1 SF1]: " + json.dumps(q1_numbers),
          flush=True)
    kernels = [{
        "name": "groupagg_large", "route": "cuda",
        "source": "cockroach_tpu_torch/csrc/groupagg_large.cu",
        "replaces": "cockroach_tpu/ops/pallas/groupagg_large.py:149",
        "launches": launches["groupagg_large"],
        "max_abs_err": errs["max_abs_err"], "ms": q1_numbers["ms"],
        "kernel_ms": q1_numbers["kernel_ms"], "point": q1_numbers["point"],
        "plain_ms": q1_numbers["plain_ms"],
        "bound_ms": q1_numbers["bound_ms"], "bound_by": "bytes",
        "content_bound_ms": q1_numbers["content_bound_ms"],
        "prebuilt_bound_ms": q1_numbers["prebuilt_bound_ms"],
        "library_ms": q1_numbers["library_ms"], "ok": True,
        "layout": q1_numbers["layout"], "host_us": q1_numbers["host_us"],
        "shape": q1_numbers["shape"],
        "max_rel_err": errs["max_rel_err"],
    }]

    def small_args(q):
        args, _ = captured[q]
        return (args[0], args[1], tuple(args[2]), tuple(args[3]), args[4],
                tuple(args[5]))

    q1f_args, q6f_args = small_args("q1f"), small_args("q6f")
    serr = compare_small(tg, q1f_args, "Q1F SF1")
    compare_small(tg, q6f_args, "Q6F SF1")
    allops = (tg.COUNT, tg.SUM, tg.MIN, tg.MAX)
    compare_small(tg, small_synthetic(1 << 23, 64, allops, 11), "G=64")
    compare_small(tg, small_synthetic(1 << 23, 1, (tg.SUM, tg.COUNT,
                                                   tg.MIN, tg.MAX), 12),
                  "G=1 n=2^23")
    compare_small(tg, small_synthetic(1 << 20, 16, allops, 13, gid_lo=-40,
                                      gid_hi=56, sel_frac=0.0),
                  "all masked, gid out of range")
    nan_args = small_synthetic(1 << 20, 8, allops, 14, nan_groups=(2, 5))
    if compare_small(tg, nan_args, "NaN in groups 2 and 5")[
            "nan_cells"] == 0:
        raise AssertionError("the NaN input produced no NaN")
    for A, cols, seed in ((16, 5, 15), (300, 48, 16)):
        sargs = small_synthetic(1 << 20, 64, allops * (A // 4), seed,
                                nan_groups=(3, 40), cols=cols,
                                neg_zero=True)
        label = f"G=64 A={A} {tg.choose_strategy(64, A)}, NaN and -0.0"
        got = compare_small(tg, sargs, label)
        if got["nan_cells"] == 0 or got["neg_zero_cells"] == 0:
            raise AssertionError(f"{label}: the input produced no NaN or "
                                 "no -0.0")
    small = small_numbers(tg, q1f_args, "Q1F SF1")
    small_q6f = small_numbers(tg, q6f_args, "Q6F SF1")
    kernels.append({
        "name": "groupagg", "route": "cuda",
        "source": "cockroach_tpu_torch/csrc/groupagg.cu",
        "replaces": "cockroach_tpu/ops/pallas/groupagg.py:136",
        "launches": launches["groupagg"],
        "max_abs_err": serr["max_abs_err"], "ms": small["ms"],
        "kernel_ms": small["kernel_ms"], "plain_ms": small["plain_ms"],
        "bound_ms": small["bound_ms"], "bound_by": "bytes",
        "library_ms": small["library_ms"], "ok": True,
        "strategy": small["strategy"], "shape": small["shape"],
        "max_rel_err": serr["max_rel_err"],
        "q6f": small_q6f,
    })

    # -- 5. the join's hash-table path --------------------------------------
    jargs, jkw = captured["q14"]
    probe, bside = jargs[0], jargs[1]
    direct = join.hash_join(*jargs, **jkw)
    hkw = dict(jkw, direct=None)
    rounds = {}
    hashed = join.hash_join(*jargs, rounds=rounds, **hkw)
    torch.cuda.synchronize()
    if not torch.equal(direct.sel, hashed.sel):
        raise AssertionError("Q14 hash-table join selection != direct")
    for col in jargs[4]:
        v = direct.col_valid(col)
        if not torch.equal(v, hashed.col_valid(col)) or not torch.equal(
                direct.col(col)[v], hashed.col(col)[v]):
            raise AssertionError(f"Q14 hash-table payload {col} != direct")
    hash_ms = _median_ms(lambda: join.hash_join(*jargs, **hkw), reps=3)
    direct_ms = _median_ms(lambda: join.hash_join(*jargs, **jkw), reps=3)
    print("Q14 join, hash-table path equals direct: " + json.dumps({
        "probe_rows": probe.n, "build_rows": bside.n,
        "matched": int(direct.sel.sum()), "build_rounds": rounds["build"],
        "probe_rounds": rounds["probe"], "hash_join_ms": hash_ms,
        "direct_join_ms": direct_ms}), flush=True)

    # -- 6. the multi-table suite -------------------------------------------
    routes, _ = suite_phase(eng, li, SF, captured, recorder)
    lanes_ok = check_lanes_on_card()
    print(f"packed lanes on the card equal the CPU's ({lanes_ok})",
          flush=True)
    large = kernels[0]
    large["launches"] += sum(r["groupagg_large"] for r in routes.values())
    for q in ("q5", "q10", "q12"):
        qargs = slot_args(captured, q)
        got, _ = compare_slots(tgl, qargs, f"{q.upper()} SF1")
        large[q] = dict(slot_numbers(tgl, qargs), **got)
        print(f"large kernel numbers [{q.upper()} SF1]: "
              + json.dumps(large[q]), flush=True)
    print(f"phases 1-6: {time.perf_counter() - t_start:.1f} s", flush=True)

    # -- 7. subqueries, derived tables and CTEs at SF1 -----------------------
    t0 = time.perf_counter()
    kept: dict = {}
    sub_routes = subquery_phase(eng, li, SF, keep=kept,
                                kernel_launches=phase7_launches(infra))
    print(f"phase 7: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 8. SSB at SF1, in an Engine of its own --------------------------------
    t0 = time.perf_counter()
    ssb_routes = ssb_phase("cuda", SF)
    print(f"phase 8: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 9. prepared statements and the exec cache -----------------------------
    t0 = time.perf_counter()
    prepared_phase(eng)
    print(f"phase 9: {time.perf_counter() - t0:.1f} s", flush=True)
    for routes_n in (sub_routes, ssb_routes):
        large["launches"] += sum(r["groupagg_large"]
                                 for r in routes_n.values())
        kernels[1]["launches"] += sum(r["groupagg"]
                                      for r in routes_n.values())
    large["phase7_launches"] = {q: r["groupagg_large"]
                                for q, r in sub_routes.items()
                                if r["groupagg_large"]}
    large["phase8_launches"] = {q: r["groupagg_large"]
                                for q, r in ssb_routes.items()
                                if r["groupagg_large"]}
    # each phase 7 and 8 launch, held against the plain version at the
    # slots its query handed it
    large["path_checks"] = {
        q: r["kernel_checks"] for q, r in [*sub_routes.items(),
                                           *(("ssb " + k, v) for k, v in
                                             ssb_routes.items())]
        if r.get("kernel_checks")}

    # -- 17. cold start and kernel infrastructure ----------------------------
    # (lineitem as loaded: before phase 11's writes)
    t0 = time.perf_counter()
    cold = coldstart_phase(eng, li, li_codes, kept, SF, infra,
                           slot_args(captured, "q1"), rows["q1"],
                           rows["q6"])
    for i, k in enumerate(("groupagg_large", "groupagg")):
        kernels[i]["launches"] += cold["launches"][k]
        kernels[i]["phase17_launches"] = cold["launches"][k]
        kernels[i]["phase17_child_launches"] = cold["child_launches"][k]
    large["path_checks"].update(
        (f"sf1 {k} phase 17", v) for k, v in cold.pop("path_checks").items())
    large["launch_point"] = cold["sweep"]["winner"]
    large["exact_paths"] = cold["gate"]["promoted"]
    print(f"phase 17: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 18. distributed aggregation over a shard mesh ----------------------
    # (lineitem as loaded: before phase 11's writes)
    t0 = time.perf_counter()
    dist = distributed_phase(eng, {"q1": want_q1, "q6": want_q6,
                                   "q14": want_q14,
                                   "minmax": minmax_oracle(li)},
                             infra["exact_paths"])
    for i, k in enumerate(("groupagg_large", "groupagg")):
        kernels[i]["launches"] += dist["launches"][k]
        kernels[i]["phase18_launches"] = dist["launches"][k]
        kernels[i]["phase18_timed_launches"] = dist["timed_launches"][k]
    large["path_checks"].update(dist.pop("path_checks"))
    small_checks18 = dist.pop("small_checks")
    large["phase18_shard"] = dist["shard_numbers"]["q1"]
    kernels[1]["phase18_shard"] = dist["shard_numbers"]["q1f"]
    print(f"phase 18: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 19. DistSQL flows between engines ----------------------------------
    # (lineitem as loaded: before phase 11's writes; phase 18's engine
    # is closed)
    t0 = time.perf_counter()
    flows = flows_phase(eng, dict(li, **li_codes), part,
                        dict(flow_oracles(li), q1=want_q1, q6=want_q6,
                             q14=want_q14))
    for i, k in enumerate(("groupagg_large", "groupagg")):
        kernels[i]["launches"] += flows["launches"][k]
        kernels[i]["phase19_launches"] = flows["launches"][k]
        kernels[i]["phase19_timed_launches"] = flows["timed_launches"][k]
    large["path_checks"].update(flows.pop("path_checks"))
    small_checks19 = flows.pop("small_checks")
    large["phase19_node"] = flows["node_q1_kernel"]
    print(f"phase 19: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 20. the multi-process pod ------------------------------------------
    # (lineitem as loaded: before phase 11's writes)
    t0 = time.perf_counter()
    pod = pod_phase(eng, {"q1": want_q1, "q6": want_q6, "q14": want_q14})
    n20 = sum(h["groupagg_large"] for h in pod["launches"].values())
    large["launches"] += n20
    large["phase20_launches"] = pod["launches"]
    large["path_checks"].update(pod.pop("path_checks"))
    print(f"phase 20: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 21. the elastic pod (lineitem as loaded) ----------------------------
    t0 = time.perf_counter()
    elastic = elastic_phase(eng, {"q1": want_q1, "q6": want_q6},
                            dict(li, **li_codes), part)
    large["launches"] += elastic["kernel1_launches"]
    large["phase21_launches"] = dict(elastic["launches"],
                                     kill=elastic["kill"]["launches"])
    large["path_checks"].update(elastic.pop("path_checks"))
    print(f"phase 21: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 23, first half: three start processes, in a thread beside phases
    # 22, 14 and 11 (it uses no engine or kernel count of this process; it
    # shares the host's cores and the card with them, so each of those
    # phases and phase 23 say in their lines whether they overlapped)
    netc_run = NetClusterRun()
    atexit.register(netc_run.stop)
    netc_run.start_thread()

    # -- 22. SQL on raft-replicated ranges -----------------------------------
    t0 = time.perf_counter()
    beside22 = netc_run.beside("phase 22")
    ranges = ranges_phase()
    ranges["beside_phase23_first_half"] = beside22
    for i, k in enumerate(("groupagg_large", "groupagg")):
        kernels[i]["launches"] += ranges["launches"][k]
        kernels[i]["phase22_launches"] = ranges["launches"][k]
    large["path_checks"].update(ranges.pop("path_checks"))
    small_checks22 = ranges.pop("small_checks")
    print(f"phase 22: {time.perf_counter() - t0:.1f} s", flush=True)


    # -- 14. set operations, composed CTEs, EXPLAIN ANALYZE, tracing -------
    # (on phase 7's tables, before phase 11's writes)
    t0 = time.perf_counter()
    beside14 = netc_run.beside("phase 14")
    obs = observability_phase(eng, kept)
    obs["beside_phase23_first_half"] = beside14
    del kept
    for i, k in enumerate(("groupagg_large", "groupagg")):
        kernels[i]["launches"] += obs["launches"][k]
        kernels[i]["phase14_launches"] = obs["launches"][k]
        kernels[i]["phase14_timed_launches"] = obs["timed_launches"][k]
    large["path_checks"].update(
        (f"sf1 {k} phase 14", v) for k, v in obs.pop("checks").items())
    small_checks14 = obs.pop("small_checks")
    print(f"phase 14: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 11. windows, the write path and YCSB-E (it changes the tables) ------
    t0 = time.perf_counter()
    # YCSB-E at 10,000 records and 2,000 operations, and one timed run a
    # query, in the whole run (phase 23's room)
    beside11 = netc_run.beside("phase 11")
    dml = dml_phase(eng, li, part, SF, ycsb_records=10_000,
                    ycsb_ops=2_000, reps=1)
    dml["beside_phase23_first_half"] = beside11
    routes11 = dml["refresh"]["routes"]
    large["launches"] += sum(r["groupagg_large"] for r in routes11.values())
    large["phase11_launches"] = {q: r["groupagg_large"]
                                 for q, r in routes11.items()}
    large["path_checks"].update(
        (f"sf1 {q} phase 11", r["kernel_checks"])
        for q, r in routes11.items() if r.get("kernel_checks"))
    print(f"phase 11: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 23, second half: this process as node 4, the kill, the rejoin ------
    t0 = time.perf_counter()
    waited = netc_run.join()
    netc = netc_run.second()
    netc["first_half_waited_s"] = waited
    large["launches"] += netc["launches"]["groupagg_large"]
    large["phase23_launches"] = netc["kernel1_launches"]
    large["path_checks"].update(netc.pop("path_checks"))
    print(f"phase 23: {time.perf_counter() - t0:.1f} s after phase 11 "
          f"({waited:.1f} s of it waiting for the first half)", flush=True)

    # -- 12. the OLTP lane beside the card ---------------------------------
    t0 = time.perf_counter()
    li_after = dml["refresh"].pop("li_after")
    orders_after = dml["refresh"].pop("orders_after")
    oltp = oltp_phase(eng, li_after, tpch.gen_supplier(SF))
    large["launches"] += sum(oltp["kernel1_launches"].values())
    large["phase12_launches"] = oltp["kernel1_launches"]
    large["path_checks"].update(oltp.pop("path_checks"))
    print(f"phase 12: {time.perf_counter() - t0:.1f} s", flush=True)
    if oltp["seconds"] > 150:
        raise AssertionError(f"phase 12 took {oltp['seconds']:.1f} s, past "
                             "its 150 s")
    dml["oltp"] = oltp

    # -- 13. the front door ------------------------------------------------
    t0 = time.perf_counter()
    front = frontdoor_phase(eng, li_after, orders_after,
                            tpch.gen_customer(SF), part, OLTP_RECORDS)
    entry = entry_points_phase()
    front["entry_points"] = entry
    for i, k in enumerate(("groupagg_large", "groupagg")):
        n = front["kernel_launches"][k] + (entry["node"]["q1_launches"]
                                           if i == 0 else 0)
        kernels[i]["launches"] += n
        kernels[i]["phase13_launches"] = n
        kernels[i]["phase13_timed_launches"] = \
            front["kernel_launches_timed"][k]
    large["path_checks"].update(front.pop("path_checks"))
    large["path_checks"][f"sf{FRONT_SF} node q1 phase 13"] = entry.pop(
        "node_checks")
    kernels[1]["path_checks"] = {"phase 13": front.pop("small_checks"),
                                 "phase 14": small_checks14,
                                 "phase 18": small_checks18,
                                 "phase 19": small_checks19,
                                 "phase 22": small_checks22}
    front["seconds_with_entry_points"] = time.perf_counter() - t0
    print(f"phase 13: {front['seconds_with_entry_points']:.1f} s",
          flush=True)
    dml["frontdoor"] = front
    dml["observability"] = obs

    # -- 15. schema and history (it changes the tables) ---------------------
    t0 = time.perf_counter()
    hist = history_phase(eng, li, li_after, orders_after, SF,
                         dml["refresh"]["t0_wall"])
    for i, k in enumerate(("groupagg_large", "groupagg")):
        kernels[i]["launches"] += hist["launches"][k]
        kernels[i]["phase15_launches"] = hist["launches"][k]
    large["path_checks"].update(hist.pop("path_checks"))
    kernels[1]["path_checks"]["phase 15"] = hist.pop("small_checks")
    print(f"phase 15: {time.perf_counter() - t0:.1f} s", flush=True)
    dml["history"] = hist

    # -- 16. jobs and changefeeds (it changes the tables) -------------------
    t0 = time.perf_counter()
    jobs = jobs_phase(eng, li_after, SF)
    for i, k in enumerate(("groupagg_large", "groupagg")):
        kernels[i]["launches"] += jobs["launches"][k]
        kernels[i]["phase16_launches"] = jobs["launches"][k]
    large["path_checks"].update(jobs.pop("path_checks"))
    kernels[1]["path_checks"]["phase 16"] = jobs.pop("small_checks")
    print(f"phase 16: {time.perf_counter() - t0:.1f} s", flush=True)
    dml["jobs"] = jobs
    dml["coldstart"] = cold
    dml["distributed"] = dist
    dml["flows"] = flows
    dml["pod"] = pod
    dml["elastic"] = elastic
    dml["ranges"] = ranges
    dml["netcluster"] = netc
    if opts.profile:
        from cockroach_tpu_torch.profile_tpch import profile_queries
        profile_queries(eng, {"q3": (tpch.Q3, None), "q5": (tpch.Q5, None),
                              "q10": (tpch.Q10, None),
                              "q12": (tpch.Q12, None), "qps": (QPS, None),
                              "qh": (QH, None)}, 3, opts.profile)

    return kernels, smi, name, dml


if __name__ == "__main__":
    sys.exit(main())
