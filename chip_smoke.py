#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (duckdb_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result lines):
1. the card's name and power limit, torch/CUDA versions; build every
   kernel from csrc/ and print nvcc's -Xptxas -v report, and, side by
   side, the host libraries (csrc/csv2col.cpp, csrc/parquet_codec.cpp,
   csrc/arrow_c.cpp, capi/capi.cpp) with the host C++ compiler;
2. generate all eight TPC-H tables at SF1 from a fixed seed (data/,
   ignored by git) and load them with duckdb_tpu_torch.connect().load_tpch();
3. the main path: TPC-H Q1 (bench.py's text) once through the port's
   entry points with every kernel launch count reset just before and read
   just after; its rows are checked against an independent numpy group-by
   of the generated files (DECIMAL exact, DOUBLE within 1e-9 relative),
   and its grouped sum must have taken the lane-private (small) regime;
4. each kernel against its plain PyTorch version on the card, exactly
   equal, on the inputs the main path gave it and on edge cases (one and
   256 slots, both sides of the nseg threshold, 1 to 40 vectors,
   negatives, dead ids holding values, sums that wrap, every row in one
   slot, 4 live slots of 20, a ragged tail; then int64 ids dead on both
   sides, views 1-3 rows off a larger tensor, 1.7% and 24% live rows over
   junk, the single regime's row threshold and one row either side, a
   spilled chunk's K 19 at 32,768 rows, K 25 in two launches, 0-129
   rows, ids and vectors that no row puts on one 16-byte boundary), each
   timed, with the ids' dtype, the live share, the regime, the load width
   (8 bytes where the alignments are mixed) and the device launches of one
   wrapper call (`call_launches`: the kernel's launches
   and any aten op of the call that works on the card), which must be the
   kernel's launches alone (no conversion, copy or fill);
5. timings with CUDA events at the main path's shapes (kernel, plain
   version, one library call, the least time the card could take, and
   the call's ids, live share and device launches, as in 4),
   the grouped sum over a sweep of shapes at N = 6,291,456, and Q1's
   median of 5 warm runs after 1 warm-up, as rows/s;
6. the join path: TPC-H Q3, Q5, Q10 and Q12, each once with the counts
   reset just before and read just after, its rows checked against the
   numpy oracle (testing/tpch_oracle.py), its route asserted (Q5 and Q12
   group into dense slots through the grouped sum's small regime, Q3 and
   Q10 through the sort-group mode), the kernel checked against its plain
   version on the inputs Q5 and Q12 gave it and timed at their shapes,
   and each query's median of 5 warm runs after 1 warm-up, with the
   device-to-host synchronizations of one warm run;
7. the subquery path: TPC-H Q4, Q11, Q17, Q18 and Q21 (the specification's
   texts and values), the same way: rows against the numpy oracle, the
   route asserted (Q4, Q18 and Q21 fuse their semi/anti joins as
   membership steps and run no semi/anti join eagerly; Q11's HAVING
   scalar subquery and Q17's correlated average each add a dense
   aggregate), the grouped sum against its plain version on every input
   the five gave it (Q4's five priorities, Q11's and Q17's ungrouped sums)
   and timed there, and each query's warm median and host syncs;
8. derived tables, OR factoring and outer joins: TPC-H Q7, Q8, Q15, Q19
   (the specification's texts and values) and q13_nolike (Q13 without its
   NOT LIKE conjunct), the same way: rows against the numpy oracle, the
   route asserted (q13_nolike's customer-orders LEFT join runs eagerly on
   the card, the four TPC-H queries run no eager join), the grouped sum
   against its plain version on every input the five gave it (Q8's years,
   Q15's max, Q19's single sum) and timed there, each query's warm median,
   lineitem rows/s (customer rows/s for q13_nolike) and host syncs; then
   one FULL join, customer FULL JOIN orders ON c_custkey = o_custkey AND
   o_totalprice > the median price, whose pairs, unmatched customers and
   unmatched orders must equal numpy's;
9. LIKE and count(DISTINCT): TPC-H Q2, Q9, Q13, Q14, Q16 and Q20 (the
   specification's texts and values), the same way: rows against the numpy
   oracle, the route asserted (Q13's LEFT join, Q16's NOT IN and Q20's two
   IN joins run eagerly, Q2, Q9 and Q14 run no eager join; Q9 and Q14
   launch the grouped sum), the grouped sum against its plain version on
   every input they gave it and timed there, each query's warm median,
   rows/s and host syncs; then the LIKE matcher: the three near-unique
   dictionaries the queries match (p_name for Q9 and Q20, o_comment for
   Q13, s_comment for Q16) must have gone through the device matcher and
   not the host loop, and on each of them the matcher's LUT on the card
   must equal the host regex's for every pattern of the six queries plus
   `_` and escape cases; the matcher's time on o_comment is printed;
10. string functions and the general aggregate path: TPC-H Q6 and Q22 (the
   specification's texts and values) and `general_agg` (one query over
   lineitem grouped by l_returnflag, l_linestatus with stddev_samp,
   var_pop, median, quantile_disc, mode, first(... ORDER BY ...), arg_max,
   bool_or, product, count(*) FILTER, string min/max and corr), the same
   way: rows against the numpy oracle (DOUBLE within 1e-9 relative), the
   route asserted (Q6 fuses into one slot; Q22 and general_agg take the
   general path, Q22 with its NOT EXISTS as an eager anti join), all three
   launch the grouped sum, whose result equals its plain version on every
   input they gave it and is timed there, Q22's substring over c_phone
   (150,000 values) must have run as a plane op on the card and no string
   function as a host loop; each query's warm median, rows/s (customer
   for Q22) and host syncs; then every plane op of ops/strings on the card
   against its host function (testing/plane_checks) over c_phone, p_name
   and o_comment, and the time of Q22's substring op on c_phone's plane;
11. casts, the extended function library, the bit and HLL aggregates and
   SELECT without FROM: the four FUNCTION_QUERIES of testing/tpch_oracle.py
   (fn_dates: date_trunc, date_diff, last_day, dayname, isodow over
   lineitem; fn_math: DuckDB's truncating % and //, greatest, nullif, if,
   gcd, bit_xor/bit_or/bit_and, hash, approx_count_distinct, ln and the
   geomean macro over lineitem; fn_strings: left, strpos, initcap, reverse,
   lpad, right and ascii over part; fn_casts: strftime, TIMESTAMP →
   VARCHAR, strpos and ascii over orders), the same way: rows against the
   numpy oracle (approx_count_distinct equal to a numpy HyperLogLog with
   the same hash and registers, and within three of HLL's standard errors,
   6.9%, of the exact distinct count), the route asserted (the general
   path, perfect but for fn_dates' sort-group over its computed TIMESTAMP
   key; no eager join), all four launch the grouped sum (the bit
   aggregates count bits through it), whose result equals its plain
   version on every input they gave it and is timed at each shape;
   strpos, left, right and reverse over p_name's dictionary, initcap over
   reverse's result and strpos and ascii over o_comment's must have run as
   plane ops and no string function as a host loop; each query's warm
   median, rows/s and host syncs. Then hash64 on the card equals the
   CPU's bit for bit over l_orderkey, and SELECTs without FROM give
   DuckDB's answers: greatest(1, NULL, 3) = 3, -7 % 3 = -1, -7 // 2 = -3,
   and CAST('1e309' AS DOUBLE) raises where TRY_CAST gives NULL. (Phase 10's
   plane-op check covers the new plane ops too.)
12. nested values: the NESTED_QUERIES of testing/tpch_oracle.py
   (nested_agg: histogram, its element and cardinality, approx_top_k,
   list(DISTINCT), bitstring_agg, count and sum over lineitem;
   nested_collect: each order's list(l_partkey ORDER BY l_linenumber)
   through len, list_sort, list_reduce and list_filter's lambdas;
   nested_words: UNNEST of string_split over part's names; nested_pack: a
   columnar list_value in a derived table with list_contains and string
   element access; nested_pack_agg: string_agg ... ORDER BY over
   supplier), the same way: rows against the numpy oracle, the route
   asserted exactly (nested_agg perfect on the general path with the
   grouped sum's small regime for its count and sum; nested_collect's
   per-order lists perfect on the general path, its outer grouping the
   fused sort-group mode), the grouped sum against its plain version on
   every input they gave it and timed at each shape, each query's first
   run, warm median (3 runs for nested_collect, 5 otherwise), rows/s and
   host syncs. Then [{'a': 1}], CAST('[1, 2, NULL]' AS INTEGER[]),
   CAST([1,2] AS VARCHAR) and list_value(p_partkey, p_size) over part's
   200,000 rows must give DuckDB's answers on the card.
13. the rest of the scalar functions: the MORE_QUERIES of
   testing/tpch_oracle.py (more_dates: isoyear, yearweek, epoch_ms,
   date_sub, make_timestamp, millennium and julian over orders; more_math:
   acosh, asinh, signbit and cot over lineitem; more_text: bit_length,
   to_base64, sha256, jaccard, damerau_levenshtein, md5_number,
   regexp_extract_all and parse_filename over part; parity_lists:
   list_dot_product, list_distance, list_zip, list_grade_up and
   list_resize over a columnar list of part; json_orders: json_object
   over two columns of orders, then json_extract(_string)) and count(*)
   and sum over range(10,000,000), the same way as phase 12: rows against
   the numpy oracle (numpy's arange for range), the route exactly, each
   launches the grouped sum, which equals its plain version on every input
   and is timed at each shape, each query's first run, warm median of 5,
   rows/s and host syncs. Then range()'s column was made on the card;
   duckdb_functions() counts each type as the port's catalog does;
   epoch_ms(BIGINT) is a TIMESTAMP; current_query() gives its own text.
14. the SELECT forms: the SELECT_FORM_QUERIES of testing/tpch_oracle.py
   (rollup_q1: Q1's measures over ROLLUP (l_returnflag, l_linestatus) with
   grouping(); cube_flags: CUBE over the two flags; setops_big: UNION ALL
   of lineitem and partsupp, 6.8M rows concatenated on the card;
   INTERSECT, EXCEPT and their ALL forms of l_partkey and p_partkey, held
   to multisets; values_join: a VALUES list joined to supplier;
   recursive_months: WITH RECURSIVE over the 84 months joined to orders;
   mark_q4 and mark_in_or: EXISTS and IN as MARK joins; notin_residual:
   NOT IN correlated by a residual; asof_ship: an ASOF join of lineitem
   and orders; band_join: an inequality join of part and supplier;
   cross_small; positional; using_left, using_full and natural_join held
   to DuckDB's USING rules; sample_rows: an exact reservoir count), the
   same way as phase 13: rows against the numpy oracle, the route
   exactly, the grouped sum against its plain version on every input and
   timed at each shape (rollup_q1 must launch it once per ROLLUP branch,
   mark_q4 at least once), each query's first run, warm median, rows/s
   and host syncs. Then TABLESAMPLE 10% REPEATABLE (42) must count within
   5 standard deviations of 600,121.5 and repeat itself, and
   duckdb_columns(), pragma_table_info('lineitem') and duckdb_tables()
   must equal the generator's schema.

15. window functions, QUALIFY and DISTINCT ON: the WINDOW_QUERIES of
   testing/tpch_oracle.py (win_rank_lineitem: rank() over all of lineitem
   per order, kept where 1, then a grouped count and sum; win_running_orders:
   a running DECIMAL sum over orders per priority; win_frames_lineitem: a
   7-row trailing avg, a 7-row centred min and max (the sparse table) and a
   30-day RANGE sum per supplier; win_lag_lead; win_dist_partsupp: ntile,
   percent_rank, cume_dist and dense_rank; win_median_part: a
   whole-partition median; qualify_top3: QUALIFY on a select alias;
   distinct_on_nation: DISTINCT ON), the same way as phase 14: rows against
   the numpy oracle, the route exactly (one window node each), the grouped
   sum against its plain version on every input and timed at each shape,
   each query's first run, warm median of 5, rows/s and host syncs; then the
   device busy share of win_rank_lineitem and win_frames_lineitem under
   torch.profiler.
16. out-of-core execution: under catalog.set_memory_limit(OOC_LIMIT) Q1, Q3,
   Q6 and a pure select with ORDER BY … LIMIT run in chunks of lineitem (at
   least 4): rows bit-identical to the same query in memory and equal to
   the numpy oracle, the out_of_core route with its chunk count, the grouped
   sum's launches (one per chunk and one for the merge of Q1 and Q6) held to
   the plain version and timed at the chunk and merge shapes, each query's
   warm median of 5 under the limit and in memory; then an ORDER BY whose
   result passes the limit sorts range partitions (columns equal to the
   in-memory run's and to a numpy lexsort); the limit goes back to 0.

17. multi-device execution (parallel/shard.py): the card count
   (nvidia-smi -L) and the shard -> device map of SHARDS shards (shared
   round-robin when there are fewer cards); q1_local_partial on the JAX
   package's entry inputs (rebuilt here with numpy) against its plain
   version; then, on a fresh connection under SET num_shards = SHARDS, Q1
   (the grouped sum once per shard, each launch held to the plain version,
   max abs err 0), Q3, a left, a semi and an anti join under SET
   exchange_join_threshold = 0, a duplicate-key self-join of lineitem,
   ORDER BY over all of lineitem, a TopN and a PARTITION BY l_orderkey
   window (row_number, a whole-partition count and sum): each equal to its
   run on phase 3's single-device connection and to numpy where the script
   has an oracle, its sharded routes present, its first run, warm median
   of 3, host syncs and the bytes copied between cards; each shard's kernel
   timed on its own card, and a time under its bound (by more than
   BOUND_SLACK) fails the phase; then one Q1 under num_shards = 0 (AUTO),
   which prints the shard count it chose. Phases 1-16 run with SET
   num_shards = 1, the port's default.

18. DML at SF1 on a connection of its own (every column of lineitem and
   orders on the card first): CREATE TABLE li AS SELECT * FROM lineitem
   (6,001,215 rows), DELETE of the rows shipped before 1993, UPDATE of
   l_discount where l_returnflag = 'R' and it is under 0.10, INSERT … SELECT
   of lineitem's orders divisible by 7, each Count held to numpy over the
   same files with the same edits; Q1 over li against that numpy oracle,
   its grouped sum held to the plain version and timed; BEGIN, a DELETE of
   the 'F' rows, count(*), ROLLBACK, Q1 equal to step 5's; two cursors in
   transactions writing li, the second's COMMIT raising
   TransactionException and Q1 afterwards showing only the first's write;
   CREATE TABLE o with a PRIMARY KEY over orders (1,500,000 rows), a
   duplicate key raising ConstraintException, INSERT … ON CONFLICT DO
   UPDATE of the 1,000 smallest keys changing exactly those rows (Count
   1,000: DuckDB counts the rows an upsert updates); INSERT …
   SELECT … GROUP BY into agg through the grouped sum (held to the plain
   version) equal to numpy; DROP of the three tables, after which the pool
   holds none of their columns and memory_allocated() is at most 64 MiB
   above its value before step 1. Each step prints its wall ms, host syncs
   (CUDA sync debug mode, on during the step) and the bytes it moved
   between host and card (TransferCounter), beside the card's name and
   power limit.

19. a file database at SF1 (storage/persist.py) in the git-ignored
   build/phase19_db: lineitem (6,001,215 rows, 16 columns) registered and
   CHECKPOINTed, with its bytes on disk against the columns' raw bytes and
   the scheme of each column; close (the pool keeps none of its columns)
   and reopen, then Q1 (first run: the columns load and reach the card;
   warm median) equal to numpy, its grouped sum held to the plain version
   and timed; a child process that opens the database, commits phase 18's
   DELETE, UPDATE and INSERT … SELECT on lineitem in one transaction and
   dies by os._exit right after COMMIT, its Counts held to numpy; the
   reopen replays the WAL (recovery wall ms) and Q1 equals numpy of the
   edited table; one more committed DELETE, the WAL then cut inside its
   unit: the reopen drops that unit, cuts it off the WAL, and Q1 equals
   the step before; a fresh in-memory connection ATTACHes the directory
   READ_ONLY, Q1 over ext.lineitem equals it too and a write raises. Each step prints its wall
   ms, host syncs and host<->device bytes beside the card's name and power
   limit; the directory is removed at the end.
20. the file readers at SF1 (storage/csv.py, parquet.py, multi_file.py,
   api/files.py) in the git-ignored build/phase20: numpy writes all of
   lineitem (6,001,215 rows, 16 columns) as dbgen's '|'-delimited text,
   then CREATE TABLE with the TPC-H schema and COPY FROM it (wall ms,
   MB/s, csv2col's own ms), Q1 over it (first run, warm median) equal to
   numpy; COPY TO li.csv (HEADER), the types read_csv_auto sniffs (DECIMAL
   as DOUBLE, as the JAX package sniffs), Q1 over it within 1e-9 relative;
   COPY TO li.parquet (bytes on disk against the raw planes), Q1 over
   read_parquet decoding only Q1's 7 of 16 columns, equal to numpy; three
   COPY (SELECT the other 15 columns … WHERE l_returnflag = X) TO
   hive/l_returnflag=X/part.parquet, Q1 over read_parquet(…,
   hive_partitioning=true) equal to numpy; the committed fixtures
   (tests/data/torch_io/, written by pyarrow) through read_parquet and
   read_json equal to their expected rows; the eight tables and a small
   one (a key, a DEFAULT, '', a sequence, a macro) through EXPORT DATABASE
   (FORMAT PARQUET) and IMPORT into a fresh connection: Q1 and Q3 equal to
   numpy, a duplicate key raising, the DEFAULT, '' and nextval and the
   macro as before. Each Q1's grouped sum is held to the plain version and
   timed at its shape; each step prints its wall ms, host syncs and
   host<->device bytes beside the card's name and power limit.

21. MERGE, ALTER and PIVOT at SF1 (api/merge.py, alter.py, pivot.py,
   appender.py) on a connection of its own: CREATE TABLE li AS SELECT of
   all of lineitem (6,001,215 rows, 16 columns) and stg of its orders
   divisible by 50, about half of stg's keys moved past lineitem's by an
   UPDATE; MERGE_LI (delete the matched rows shipped from MERGE_SHIP_CUT
   on, update the other matched rows' l_quantity and l_discount, insert
   the unmatched stg rows) with its Count held to merge_numpy and Q1 over
   li equal to numpy exactly; the same MERGE with a source key twice
   raising InvalidInputException and Q1 unchanged; ALTERS (ADD COLUMN
   l_batch DEFAULT 7, RENAME COLUMN l_quantity TO l_qty, l_linenumber to
   BIGINT, DROP COLUMN l_comment, the pool's bytes before and after the
   drop) and Q1_ALTERED equal to numpy; BEGIN, DROP COLUMN l_tax, a MERGE,
   ROLLBACK, and Q1 equal to the step before with l_tax back; PIVOT li ON
   l_returnflag USING sum(l_qty) GROUP BY l_linestatus and UNPIVOT of the
   same table made by CTAS equal to numpy, with whether the FILTERed sums
   reached the kernel and at which shapes; 200,000 Python tuples through
   the appender into a table with a PRIMARY KEY (rows/s, held to Python),
   then a duplicate key raising ConstraintException with the table
   unchanged. Every Q1 and the PIVOT's sums hold the grouped sum to its
   plain version (max abs err 0) and time it at each shape; each step
   prints its wall ms, host syncs and host<->device bytes beside the
   card's name and power limit.
22. the settings, the log, the profiler and the clients (main/,
   cli/, capi/) on phase 3's connection: SET of temp_directory, join_order
   and default_null_order read back by current_setting() and RESET, and
   duckdb_settings()' 187 rows; EXPLAIN ANALYZE of Q1 through the kernel
   (its rows in last_profile equal numpy's, the profile's total beside
   the step's wall, every operator's rows and ms); Q1's QueryLog line in
   duckdb_logs(), then OOC_SELECT under OOC_LIMIT with temp_directory set
   to build/phase22_tmp, in chunks, equal to phase 16's numpy rows, its
   spill directory made there and its out_of_core lines logged; Q1 under
   SET pallas_grouped_sum = 'off' with no launch and numpy's rows, then
   after RESET through the kernel again; lineitem at SF1 into the file
   database build/phase22_db, `python -m duckdb_tpu_torch.cli
   build/phase22_db -csv -c Q1` in a subprocess on the card with its CSV
   rows equal to numpy's, then the C API (capi.cpp, built with the host
   compiler in phase 1 beside the kernel) loaded in this process:
   duckdb_open of the same database, duckdb_query of Q1 and its values
   (duckdb_value_double, else duckdb_value_varchar) equal to numpy's,
   through the kernel. Each Q1's
   grouped sum is held to the plain version (max abs err 0) and timed;
   each step prints its wall ms, host syncs and host<->device bytes
   beside the card's name and power limit.
23. the grammar fuzzer (testing/fuzz.py) on a card connection against a
   CPU connection of the port: SETUP's tables and seeds 1, 7 and 11 × 400
   queries, then t1 and t2 by SETUP's formulas over range(1,000,000) and
   range(400,000) and seed 1 × 200 queries. No non-typed error on the card;
   where both answer, the same rows (DOUBLE within 1e-9 relative; in order
   under a top-level ORDER BY without LIMIT, the first column in order with
   one, the row count only under a LIMIT without ORDER BY, else as
   multisets); where one refuses, the other with the same class. Every
   grouped-sum launch of the card queries is held to the plain version
   (max abs err 0) right after the query's wall and each shape timed once;
   each step prints its counts, its median query wall and its seconds.
24. two processes started by spawn over one ProcessMesh
   (parallel/shard.py) on the card: gloo, both ranks on cuda:0 with two
   shards each, the collectives staged through the host. Each rank reads
   its half of lineitem and orders with numpy and runs Q1's partial
   through the kernel then an all_reduce (each rank's launches held to
   the plain version and reported through the group), the exchange join
   of l_orderkey into orders (each rank checks that its shards received
   exactly the rows their hash owns, each with its order's row), lineitem
   against itself on l_orderkey (the pair count against numpy's Σ count²),
   the sharded sort on l_extendedprice and a TopN of 100 by it descending,
   all held to numpy. Each step prints its wall, the bytes sent between
   ranks and staged through the host, and the backend.
   `tools/chip_phase24.py --backend nccl --world 4` runs it with one card
   per rank.
25. the faults F28-F31 and C1-C5, Arrow, nested Parquet and the
   configuration matrix: F28-F31's forms on a card connection (repeat's
   LIST overload, a string function over a LIST, date_part(1), a list
   function over a scalar, string literals read as the parameter's type,
   UINT64 and BLOB from Parquet) and C1-C5 through the C API library;
   lineitem at SF1 from phase 3's connection through the port's own
   Arrow export (api/arrow_interop.py over csrc/arrow_c.cpp, no pyarrow),
   whole and in record batches of ARROW_BATCH_ROWS, imported back by
   from_arrow (export and import wall ms and MB/s), Q1 over each import
   through the kernel equal to numpy, every Arrow struct released; the
   nested and TIME fixtures read to their expected rows, a deeper nesting
   refused naming its column, INTEGER[], VARCHAR[] and TIME written by COPY
   TO and read back; the fifteen configurations of MATRIX_CONFIGS × the
   seven MATRIX_QUERIES at SF 0.01, each equal to the numpy oracle, every
   grouped-sum launch held to the plain version (none under pallas_off).
   `tools/chip_phase25.py` runs it alone;
26. the windows over frames (execution/window_exec.py over
   ops/frame_stats.py, ROADMAP item 44) at SF1: first the forms of G1-G3
   (an empty list into a list column by INSERT, UPDATE and CASE, || over
   lists, SET's None) on a card connection; then the seven PHASE26
   windows (a moving median over 101 rows, a running quantile_cont, a
   30-day stddev_samp, a running var_pop over orders, a count(DISTINCT)
   over 101 rows, a moving median(DISTINCT) over 101 rows and a
   stddev(DISTINCT) over 101 rows), each wrapped in a grouped count/sum/min/max whose
   count(*) goes through the grouped sum (its launches counted and held to
   the plain version; the route named where none launched), its groups
   and an exact read-back of the rows whose order key is a multiple of
   PHASE26_MOD held to a numpy oracle written apart from the port (sorted
   windows in chunks of rows, exact integer moments, bitmask distinct
   sets), and its warm median, host syncs, the card's busy share and the
   peak device memory the query took. `tools/chip_phase26.py` runs it
   alone;
27. the JAX package's test statements on the card against the CPU
   (duckdb_tpu_torch/testing/replay.py): first the forms of H1-H4
   (Result.fetchone() from execute(), sql() and a cursor; median,
   quantile_cont, stddev and var with DISTINCT over the whole partition,
   a running and a moving frame, equal to their distinct values' numpy
   answers; a STRUCT literal with a NULL field and a widening nested value
   into nested columns) on a card connection; then the whole recorded
   corpus (tests/data/torch_replay/corpus.jsonl.gz; all 287 sequences took
   38.6 s on an H100 80GB HBM3 at 700 W, so none is sampled), each
   sequence on a card connection and a CPU connection
   of the port in directories of its own, every statement compared
   (testing/replay.py: every column, DOUBLE within 1e-9 relative, the rest
   exact, in order where a closing ORDER BY names result columns; a LIMIT
   without ORDER BY by row count only, counted apart; a refusal by the
   same class on both, no untyped error, nondeterministic statements run
   but not compared), every grouped-sum launch held to the
   plain version and each new shape timed once; the counts, the corpus's
   left-out sequences by reason, the median statement wall on the card
   and the phase's seconds are printed, and any problem outside
   replay.KNOWN fails it. `tools/chip_phase27.py` runs it alone. The
   script's whole time is printed last.

The last two lines are the kernels JSON and {"ok": true, "device": ...}.
Imports nothing of JAX or duckdb_tpu.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SF = 1.0
SEED = 0
DATA = os.path.join(ROOT, "data", f"tpch_gen_sf{SF:g}_seed{SEED}")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# about 200 µs of the card's clock: more than the host takes to enqueue one
# wrapper call, so cuda_ms measures the card and not the host
SPIN_CYCLES_PER_CALL = 400_000
# the grouped sum's sweep: (K vectors, nseg slots, live slots) at Q1's N
SWEEP_N = 6_291_456
SWEEP = ((16, 20, 4), (16, 20, 20), (1, 1, 1), (24, 1, 1), (9, 216, 216), (24, 256, 256))
# H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet), the
# data sheet's only CUDA-core rate; int64 adds issue no faster, so it
# gives a lower bound on their time
CUDA_CORE_OPS_PER_S = 67e12
# a kernel time under bound / BOUND_SLACK (above 105% of the roofline) is
# one the events did not measure: phase 17 fails on it
BOUND_SLACK = 1.05

# bench.py's Q1 text
Q1 = """
SELECT l_returnflag, l_linestatus, sum(l_quantity) AS sum_qty,
  sum(l_extendedprice) AS sum_base_price,
  sum(l_extendedprice * (1 - l_discount)) AS sum_disc_price,
  sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) AS sum_charge,
  avg(l_quantity) AS avg_qty, avg(l_extendedprice) AS avg_price,
  avg(l_discount) AS avg_disc, count(*) AS count_order
FROM lineitem
WHERE l_shipdate <= CAST('1998-09-02' AS date)
GROUP BY l_returnflag, l_linestatus
ORDER BY l_returnflag, l_linestatus
"""


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


LINEITEM_NUMPY = ("l_orderkey", "l_linenumber", "l_quantity", "l_extendedprice",
                  "l_discount", "l_tax", "l_returnflag", "l_linestatus", "l_shipdate")


def lineitem_numpy(data_dir: str) -> dict:
    """The lineitem columns Q1 and phase 18 read, from the generated files:
    integers (DECIMAL in cents, dates in days) as int64, the one-character
    flags as their bytes."""
    import numpy as np

    t = os.path.join(data_dir, "lineitem")
    out = {}
    for name in LINEITEM_NUMPY:
        if os.path.exists(os.path.join(t, name + ".bytes")):
            out[name] = np.fromfile(os.path.join(t, name + ".bytes"), dtype="S1")
        elif os.path.exists(os.path.join(t, name + ".i64")):
            out[name] = np.fromfile(os.path.join(t, name + ".i64"), dtype=np.int64)
        else:
            out[name] = np.fromfile(os.path.join(t, name + ".i32"),
                                    dtype=np.int32).astype(np.int64)
    return out


def numpy_q1(data_dir: str):
    """Q1 over the generated files with numpy alone → rows as Q1 returns them."""
    return numpy_q1_of(lineitem_numpy(data_dir))


def numpy_q1_of(cols: dict):
    """Q1 over lineitem columns as lineitem_numpy gives them."""
    import datetime
    import decimal

    qty, price = cols["l_quantity"], cols["l_extendedprice"]
    disc, tax = cols["l_discount"], cols["l_tax"]
    ship = cols["l_shipdate"]
    rf, ls = cols["l_returnflag"], cols["l_linestatus"]
    keep = ship <= (datetime.date(1998, 9, 2) - datetime.date(1970, 1, 1)).days
    rows = []
    for r in sorted(set(rf[keep].tolist())):
        for s in sorted(set(ls[keep].tolist())):
            m = keep & (rf == r) & (ls == s)
            cnt = int(m.sum())
            if not cnt:
                continue
            sq, sp = int(qty[m].sum()), int(price[m].sum())
            sd = int((price[m] * (100 - disc[m])).sum())
            sc = int((price[m] * (100 - disc[m]) * (100 + tax[m])).sum())
            dec = decimal.Decimal
            rows.append((r.decode(), s.decode(), dec(sq).scaleb(-2), dec(sp).scaleb(-2),
                         dec(sd).scaleb(-4), dec(sc).scaleb(-6),
                         float(sq) / (cnt * 100.0), float(sp) / (cnt * 100.0),
                         float(int(disc[m].sum())) / (cnt * 100.0), cnt))
    return rows


# phase 21 step 4's ALTERs of li, and Q1 over li written with the new name
ALTERS = ("ALTER TABLE li ADD COLUMN l_batch INTEGER DEFAULT 7",
          "ALTER TABLE li RENAME COLUMN l_quantity TO l_qty",
          "ALTER TABLE li ALTER COLUMN l_linenumber TYPE BIGINT",
          "ALTER TABLE li DROP COLUMN l_comment")
Q1_ALTERED = Q1.replace("FROM lineitem", "FROM li").replace("l_quantity", "l_qty")
MERGE_SHIP_CUT = "1998-08-01"  # phase 21's MERGE deletes the matched rows shipped from here
MERGE_LI = ("MERGE INTO li USING stg ON li.l_orderkey = stg.l_orderkey AND "
            "li.l_linenumber = stg.l_linenumber "
            f"WHEN MATCHED AND stg.l_shipdate >= DATE '{MERGE_SHIP_CUT}' THEN DELETE "
            "WHEN MATCHED THEN UPDATE SET l_quantity = stg.l_quantity + 1, "
            "l_discount = stg.l_discount "
            "WHEN NOT MATCHED THEN INSERT *")


def merge_numpy(li: dict, stg: dict) -> dict:
    """Phase 21's MERGE of stg into li over lineitem_numpy columns: a li row
    whose (l_orderkey, l_linenumber) stg holds is deleted when stg's row
    shipped on or after MERGE_SHIP_CUT, else takes stg's l_quantity + 1
    and l_discount; stg's other rows are appended. → {"cols": li after,
    "count", "deleted", "updated", "inserted"}."""
    import datetime

    import numpy as np

    lk = li["l_orderkey"] * 8 + li["l_linenumber"]
    sk = stg["l_orderkey"] * 8 + stg["l_linenumber"]
    order = np.argsort(sk, kind="stable")
    pos = np.searchsorted(sk[order], lk).clip(0, max(len(sk) - 1, 0))
    src = order[pos] if len(sk) else np.zeros(len(lk), np.int64)
    hit = (sk[src] == lk) if len(sk) else np.zeros(len(lk), bool)
    cut = (datetime.date.fromisoformat(MERGE_SHIP_CUT) - datetime.date(1970, 1, 1)).days
    late = stg["l_shipdate"][src] >= cut if len(sk) else hit
    dele, upd = hit & late, hit & ~late
    cols = {k: v.copy() for k, v in li.items()}
    cols["l_quantity"][upd] = stg["l_quantity"][src[upd]] + 100  # DECIMAL(15,2) cents
    cols["l_discount"][upd] = stg["l_discount"][src[upd]]
    ins = ~np.isin(sk, lk)
    cols = {k: np.concatenate([v[~dele], stg[k][ins]]) for k, v in cols.items()}
    return {"cols": cols, "count": int(dele.sum() + upd.sum() + ins.sum()),
            "deleted": int(dele.sum()), "updated": int(upd.sum()), "inserted": int(ins.sum())}


def rows_match(got, want) -> str:
    """'' when the rows agree (DECIMAL/str/int exact, float 1e-9 relative)."""
    if len(got) != len(want):
        return f"{len(got)} rows, expected {len(want)}"
    for i, (g, w) in enumerate(zip(got, want)):
        for j, (a, b) in enumerate(zip(g, w)):
            if isinstance(b, float):
                ok = abs(a - b) <= 1e-9 * max(abs(b), 1e-300)
            else:
                ok = a == b and type(a) is type(b)
            if not ok:
                return f"row {i} column {j}: {a!r} != {b!r}"
    return ""


def cuda_ms(fn, reps: int) -> float:
    """Device ms per call of fn: reps calls between two CUDA events. A spin
    of the card (torch.cuda._sleep, SPIN_CYCLES_PER_CALL a call) goes first,
    so the host enqueues every call before the card reaches them and a call
    that is shorter on the card than its Python on the host is timed on the
    card."""
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(got, want) -> int:
    """Largest |difference| over the K result vectors (0 when all equal)."""
    import torch

    errs = [0]
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            errs.append(max(1, abs(int((g - w).abs().max()))))
    return max(errs)


def edge_cases(device, GS):
    """(name, dense, vectors, nseg) inputs that stress the kernel's contract.

    Ids are uniform over [-1, nseg + 2) (dead ones included) or drawn from a
    few given ids; in the second kind dead rows keep their values, which the
    kernel must ignore. Then junk_cases'."""
    import torch

    gen = torch.Generator(device="cpu").manual_seed(SEED)
    big = 1 << 20
    small_max_nseg = GS.SMALL_MAX_NSEG
    cases = []
    for n, nseg, k, ids in (
            (big, 1, 1, None), (big, 1, 24, None), (big, 256, 1, None),
            (big, 256, 24, None), (big, 256, 40, None), (1000, 20, 15, None),
            (big + 77, 20, 16, (7,)),               # every row in one slot
            (big + 77, 20, 16, (0, 1, 4, 5, -1)),   # 4 live of 20, as Q1
            (big, small_max_nseg, 16, None),        # last small-regime nseg
            (big, small_max_nseg + 1, 16, None),    # first large-regime nseg
            (big, 216, 9, (100,)),                  # large regime, one slot
            (big, 20, 25, (3, 9, 21))):             # 2 launches, 21 is dead
        if ids is None:
            dense = torch.randint(-1, nseg + 2, (n,), generator=gen, dtype=torch.int32)
        else:
            pick = torch.randint(0, len(ids), (n,), generator=gen)
            dense = torch.tensor(ids, dtype=torch.int32)[pick]
        dead = (dense < 0) | (dense >= nseg)
        vecs = []
        for j in range(k):
            # full-range values wrap; small negatives stay exact
            hi = 2**63 - 1 if j % 2 == 0 else 2**20
            v = torch.randint(-hi, hi, (n,), generator=gen, dtype=torch.int64)
            vecs.append((torch.where(dead, 0, v) if ids is None else v).to(device))
        name = f"n={n} nseg={nseg} K={k}" + ("" if ids is None else f" ids {ids}")
        cases.append((name, dense.to(device), vecs, nseg))
    return cases + junk_cases(device, GS, gen)


# (n, nseg, K, live share, id dtype, row offset): int64 ids, views off a
# 16-byte boundary, sparse live rows, the single regime's threshold, a
# spilled chunk's K 19 and K 25 in two launches (also in the single regime),
# row counts around one tile; then mixed alignments, where the offset is
# (the ids', the vectors', the last vector's): no row puts every pointer on
# a 16-byte boundary, so the lane-private tables load 8 bytes at a time
JUNK_CASES = (
    (1 << 20, 20, 16, 0.9, "int64", 0), (7_168, 26, 1, 0.5, "int64", 0),
    (100_000, 216, 5, 0.9, "int64", 0), ((1 << 20) + 5, 20, 16, 0.9, "int32", 1),
    (32_768, 20, 19, 1.0, "int32", 1), (1_000_003, 7, 2, 0.9, "int64", 3),
    (1_000_003, 20, 4, 0.9, "int32", 2), (6_291_456, 1, 3, 0.017, "int32", 0),
    (6_291_456, 20, 5, 0.24, "int32", 0), (6_291_456, 12, 1, 0.98, "int64", 0),
    (32_768, 20, 19, 0.02, "int32", 0), ("threshold-1", 20, 4, 0.9, "int32", 0),
    ("threshold", 20, 4, 0.9, "int32", 0), ("threshold+1", 20, 4, 0.9, "int32", 0),
    (32_768, 20, 25, 0.95, "int32", 0), (1_000, 20, 19, 0.95, "int32", 1),
    (1_024, 20, 25, 0.95, "int32", 3), (0, 7, 3, 0.8, "int32", 0),
    (1, 7, 3, 0.8, "int32", 0), (127, 7, 3, 0.8, "int32", 0), (128, 7, 3, 0.8, "int32", 0),
    (129, 7, 3, 0.8, "int32", 0),
    (1_000, 20, 4, 0.9, "int32", (0, 1, 1)), (1_000, 20, 4, 0.9, "int64", (0, 1, 1)),
    (1_000, 20, 5, 0.9, "int32", (0, 0, 1)), (1_000, 7, 2, 0.9, "int64", (0, 0, 1)),
    (100_000, 20, 5, 0.9, "int32", (0, 1, 1)), (100_000, 20, 4, 0.9, "int64", (0, 1, 1)),
    (1_000_003, 20, 5, 0.9, "int32", (0, 0, 1)), (100_000, 7, 2, 0.9, "int64", (0, 0, 1)))


def junk_cases(device, GS, gen):
    """JUNK_CASES as (name, dense, vectors, nseg): ids live with the given
    share, else dead (negative, or past nseg up to 2^40 for int64 ids), and
    every row of every vector, dead ones too, full-range junk; with a row
    offset every tensor is a view that starts that many rows into a larger
    one (an offset triple sets the ids', the vectors' and the last
    vector's apart: "mixed alignment" in the name)."""
    import torch

    cases = []
    for n, nseg, k, live_share, dtype, offset in JUNK_CASES:
        if isinstance(n, str):
            n = GS.SINGLE_MAX_ROWS + {"threshold-1": -1, "threshold": 0, "threshold+1": 1}[n]
        ids_at, vecs_at, last_at = offset if isinstance(offset, tuple) else (offset,) * 3
        total = n + max(ids_at, vecs_at, last_at)
        far = 2**40 if dtype == "int64" else 2**31 - 1
        live = torch.rand(total, generator=gen) < live_share
        dead = torch.where(torch.rand(total, generator=gen) < 0.5,
                           torch.randint(-far, 0, (total,), generator=gen),
                           torch.randint(nseg, far, (total,), generator=gen))
        dense = torch.where(live, torch.randint(0, nseg, (total,), generator=gen), dead)
        dense = dense.to(getattr(torch, dtype)).to(device)[ids_at:ids_at + n]
        vecs = [torch.randint(-(2**63 - 1), 2**63 - 1, (total,), generator=gen,
                              dtype=torch.int64).to(device)[at:at + n]
                for at in [vecs_at] * (k - 1) + [last_at]]
        where = (f"mixed alignment: ids at row {ids_at}, vectors at {vecs_at}, the last at "
                 f"{last_at}" if isinstance(offset, tuple) else f"row offset {offset}")
        cases.append((f"n={n} nseg={nseg} K={k} {dtype} ids, {live_share:.1%} live, junk in "
                      f"dead rows, {where}", dense, vecs, nseg))
    return cases


def bound_of(dense, vecs, nseg):
    """(least ms, what bounds it, bytes, adds) for grouped_sum_i64 on these
    inputs: every slot id read at its own width (4 or 8 bytes), the K values
    of live rows only (dead rows contribute nothing), the (nseg, K) output
    written once; one int64 add per live value."""
    n, k = dense.shape[0], len(vecs)
    n_live = int(((dense >= 0) & (dense < nseg)).sum())
    bytes_moved = n * dense.element_size() + n_live * 8 * k + nseg * k * 8
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = n_live * k / CUDA_CORE_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), \
        bytes_moved, n_live * k


# aten ops that allocate or make views: they launch nothing on the card
NO_DEVICE_WORK = frozenset((
    "empty", "empty_strided", "unbind", "select", "slice", "view", "alias", "as_strided",
    "_reshape_alias", "detach", "t", "transpose", "expand", "squeeze", "unsqueeze",
    "lift_fresh"))


def call_launches(GS, fn):
    """(kernel launches, other device work) of one call of fn, counted on
    the host: the wrapper's launch count, and the name of every aten op the
    call dispatches that does work on the card (any but NO_DEVICE_WORK's
    allocations and views: a conversion, copy, clone or fill)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Dispatched(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func)
            return func(*args, **(kwargs or {}))

    before = GS.grouped_sum_i64.launches
    with Dispatched():
        fn()
    work = [str(f) for f in ops if f._overloadpacket.__name__ not in NO_DEVICE_WORK]
    return GS.grouped_sum_i64.launches - before, work


def call_profile(GS, dense, vecs, nseg) -> dict:
    """How one wrapper call runs on the card: the ids' dtype, the live share
    of the rows, its device launches (`call_launches`), its regime and the
    width of its loads (16 or 8 bytes for the lane-private tables, one row
    a lane for the large regime). Raises where a call on int32 or int64 ids
    and contiguous tensors runs anything but the kernel's launches, one per
    launch plan."""
    import torch

    narrow = GS.grouped_sum_i64.narrow_launches
    kernels, work = call_launches(GS, lambda: GS.grouped_sum_i64(dense, vecs, nseg))
    narrow = GS.grouped_sum_i64.narrow_launches - narrow
    n = dense.shape[0]
    plans, k = 0, len(vecs)
    while k:
        k -= GS.launch_plan(nseg, k, n).vectors
        plans += 1
    taken = dense.dtype in (torch.int32, torch.int64) and dense.is_contiguous() \
        and all(v.is_contiguous() for v in vecs)
    if taken and (work or kernels != plans):
        raise RuntimeError(f"grouped_sum_i64 at N={n} K={len(vecs)} nseg={nseg} made "
                           f"{kernels} kernel launches and {work} on the card, expected "
                           f"{plans} kernel launches and nothing else")
    live = int(((dense >= 0) & (dense < nseg)).sum())
    regime = GS.launch_plan(nseg, len(vecs), n).regime
    return {"ids": str(dense.dtype).replace("torch.", ""), "live_share": live / max(n, 1),
            "device_launches": kernels + len(work), "regime": regime,
            "loads": "row a lane" if regime == "large" else "8-byte" if narrow else "16-byte"}


def call_text(call) -> str:
    return (f"ids {call['ids']}, live {100 * call['live_share']:.2f}%, "
            f"{call['device_launches']} device launches per call, regime {call['regime']}, "
            f"{call['loads']} loads")


def time_kernel(GS, dense, vecs, nseg, reps):
    """(kernel ms, plain ms, index_add_ ms, call_profile) on these inputs."""
    import torch

    call = call_profile(GS, dense, vecs, nseg)
    d64 = dense.to(torch.int64)
    d64 = torch.where((d64 < 0) | (d64 >= nseg), nseg, d64)
    mat = torch.stack(vecs, dim=1)
    acc = torch.zeros((nseg + 1, len(vecs)), dtype=torch.int64, device=dense.device)
    kernel_ms = cuda_ms(lambda: GS.grouped_sum_i64(dense, vecs, nseg), reps)
    plain_ms = cuda_ms(lambda: GS.grouped_sum_i64_plain(dense, vecs, nseg), reps)
    library_ms = cuda_ms(lambda: acc.index_add_(0, d64, mat), reps)
    return kernel_ms, plain_ms, library_ms, call


def count_syncs(fn) -> int:
    """Device-to-host synchronizations while fn runs, as CUDA's sync debug
    mode reports them (each .item(), nonzero, device-to-host copy, ...)."""
    import warnings

    import torch

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def warm_median(con, sql, want, runs=5, exact=True):
    """Median host seconds of `runs` warm runs after 1 warm-up; each run
    ends in a synchronize and must give `want` (DOUBLE values within 1e-9
    relative unless `exact`: float sums through atomics take any order).
    → (median, times) or a failure message."""
    import torch

    times = []
    for i in range(runs + 1):
        t0 = time.perf_counter()
        rows = con.sql(sql).rows()
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
        if (rows != want) if exact else rows_match(rows, want):
            return None, "rows changed between runs"
    return statistics.median(times), times


def sweep(GS, card: str):
    """Time GS.grouped_sum_i64 at N = SWEEP_N over SWEEP's (K, nseg, live
    slots) shapes, every row live: kernel ms beside the bytes bound (ids
    read once, values read once, sums written once, at 3.35 TB/s), the
    roofline share, and one index_add_ of the same sums. Returns the rows."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = []
    for k, nseg, live in SWEEP:
        slots = torch.randperm(nseg, generator=gen, device="cuda")[:live]
        pick = torch.randint(0, live, (SWEEP_N,), generator=gen, device="cuda")
        dense = slots[pick].to(torch.int32)
        vecs = [torch.randint(-2**40, 2**40, (SWEEP_N,), generator=gen, device="cuda",
                              dtype=torch.int64) for _ in range(k)]
        kernel_ms = cuda_ms(lambda: GS.grouped_sum_i64(dense, vecs, nseg), 20)
        d64, mat = dense.to(torch.int64), torch.stack(vecs, dim=1)
        acc = torch.zeros((nseg, k), dtype=torch.int64, device="cuda")
        library_ms = cuda_ms(lambda: acc.index_add_(0, d64, mat), 5)
        bytes_moved = SWEEP_N * (4 + 8 * k) + nseg * k * 8
        bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        row = {"k": k, "nseg": nseg, "live": live, "kernel_ms": kernel_ms,
               "bound_ms": bound_ms, "roofline": bound_ms / kernel_ms,
               "index_add_ms": library_ms}
        print(f"sweep N={SWEEP_N} K={k} nseg={nseg} live={live} on {card}: kernel "
              f"{kernel_ms:.4f} ms, bound {bound_ms:.4f} ms ({bytes_moved} bytes), "
              f"roofline {100 * row['roofline']:.1f}%, index_add_ {library_ms:.4f} ms")
        out.append(row)
        del vecs, mat, d64
    return out


def full_join_counts(con, card: str) -> str:
    """customer FULL JOIN orders ON c_custkey = o_custkey AND o_totalprice >
    the median price: the pairs, the customers without such an order and
    the orders at or below the median must equal numpy's, and the join
    must run eagerly on the card. '' when they do."""
    import numpy as np
    import torch

    def col(table, name):
        base = os.path.join(DATA, table, name)
        kind = ".i64" if os.path.exists(base + ".i64") else ".i32"
        return np.fromfile(base + kind, dtype=np.int64 if kind == ".i64" else np.int32)

    price, ocust, ckey = col("orders", "o_totalprice"), col("orders", "o_custkey"), \
        col("customer", "c_custkey")
    median = int(np.median(price))
    big = price > median
    want = (int(big.sum()), int((~np.isin(ckey, ocust[big])).sum()), int((~big).sum()))
    sql = (f"SELECT count(*) AS n, count(c_custkey) AS custs, count(o_orderkey) AS ords "
           f"FROM customer FULL JOIN orders ON c_custkey = o_custkey "
           f"AND o_totalprice > {median // 100}.{median % 100:02d}")
    con.routes.clear()
    (n, custs, ords), = con.sql(sql).rows()
    torch.cuda.synchronize()
    routes = dict(con.routes)
    pairs = custs + ords - n
    got = (pairs, custs - pairs, ords - pairs)
    if routes.get("eager_full") != 1:
        return f"the FULL join missed the eager full join: routes {routes}"
    if got != want:
        return f"FULL join counts (pairs, unmatched customers, unmatched orders) {got}, " \
            f"numpy {want}"
    med, times = warm_median(con, sql, [(n, custs, ords)])
    if med is None:
        return f"FULL join: {times}"
    syncs = count_syncs(lambda: con.sql(sql).rows())
    print(f"FULL join SF{SF:g} on {card}: pairs {got[0]}, unmatched customers {got[1]}, "
          f"unmatched orders {got[2]} equal numpy's; routes {routes}; median of 5 warm "
          f"runs {med * 1e3:.3f} ms (runs {', '.join(f'{t * 1e3:.3f}' for t in times)} "
          f"ms), {(len(ckey) + len(price)) / med:.0f} customer+orders rows/s, {syncs} "
          f"host syncs per run")
    return ""


# phase 9: (table, column) of each near-unique dictionary a query matches,
# with the query's pattern; and the patterns the matcher is held to the
# host regex on: the six queries' own, plus `_` and escape cases
LIKE_DICTS = {("part", "p_name"): ("%green%", "forest%"),
              ("orders", "o_comment"): ("%special%requests%",),
              ("supplier", "s_comment"): ("%Customer%Complaints%",)}
LIKE_PATTERNS = ("%BRASS", "%green%", "%special%requests%", "PROMO%", "MEDIUM POLISHED%",
                 "%Customer%Complaints%", "forest%", "%gr_en%", "_%", "%\\%%", "%\\_%",
                 "C_stomer%")


def like_matcher(con, card: str, device_events) -> str:
    """The device matcher took the three near-unique dictionaries during
    the queries (device_events: its (pattern, values) records), and on each
    its LUT on the card equals the host regex's for every LIKE_PATTERNS
    entry (and ILIKE for one). '' when it does."""
    import re

    import numpy as np
    import torch

    from duckdb_tpu_torch.ops import strings as TS
    from duckdb_tpu_torch.planner.bound import like_to_regex

    for (table, col), patterns in LIKE_DICTS.items():
        dvals = con.catalog.get_table(table).host_column(col)[2]
        if len(dvals) < TS.DEVICE_LIKE_MIN_DICT:
            return f"{table}.{col} holds {len(dvals)} values, under the device threshold"
        for p in patterns:
            if (p, len(dvals)) not in device_events:
                return f"{table}.{col} LIKE {p!r} missed the device matcher: {device_events}"
        checked = 0
        for p in LIKE_PATTERNS + ("%SPECIAL%",):
            ci = p == "%SPECIAL%"
            got = TS.device_like_lut(dvals, p, ci, torch.device("cuda"))
            if got is None or not got.is_cuda:
                return f"{table}.{col}: the matcher gave no LUT on the card for {p!r}"
            prog = re.compile(like_to_regex(p), re.DOTALL | (re.IGNORECASE if ci else 0))
            want = np.fromiter((prog.match(s) is not None for s in dvals), dtype=bool,
                               count=len(dvals))
            if not np.array_equal(got.cpu().numpy(), want):
                return f"{table}.{col} LIKE {p!r}: the card's LUT differs from the host regex"
            checked += int(want.sum())
        print(f"LIKE matcher on {table}.{col} ({len(dvals)} values, card {card}): "
              f"{len(LIKE_PATTERNS) + 1} LUTs equal the host regex ({checked} matches)")
    dvals = con.catalog.get_table("orders").host_column("o_comment")[2]
    plane, lens = TS._pack_dict(dvals, torch.device("cuda"))
    segs = TS.tokenize_pattern("%special%requests%", False)
    ms = cuda_ms(lambda: TS._like_match(plane, lens, segs, False), 10)
    print(f"LIKE matcher time on o_comment's plane {tuple(plane.shape)} for "
          f"'%special%requests%' on {card}: {ms:.4f} ms "
          f"({plane.numel() / ms / 1e6:.1f} GB/s of plane)")
    return ""


# phase 10: the dictionaries every plane op is held to its host function on
PLANE_DICTS = (("customer", "c_phone"), ("part", "p_name"), ("orders", "o_comment"))


def plane_ops(con, card: str) -> str:
    """Every plane op on the card equals its host function over PLANE_DICTS
    (testing/plane_checks), and the time of Q22's substring op and of the
    whole transform (op, transfer, decode) on c_phone. '' when they agree."""
    import torch

    from duckdb_tpu_torch.ops import strings as TS
    from duckdb_tpu_torch.testing import plane_checks

    for table, col in PLANE_DICTS:
        dvals = con.catalog.get_table(table).host_column(col)[2]
        if len(dvals) < TS.DEVICE_STR_MIN_DICT:
            return f"{table}.{col} holds {len(dvals)} values, under the device threshold"
        t0 = time.perf_counter()
        bad = plane_checks.check_dictionary(dvals, torch.device("cuda"))
        if bad:
            return f"{table}.{col}: the plane ops {bad} differ from their host functions"
        print(f"string plane ops on {table}.{col} ({len(dvals)} values, card {card}): "
              f"{len(plane_checks.TRANSFORMS)} transforms and {len(plane_checks.VALUES)} "
              f"LUTs equal the host functions ({time.perf_counter() - t0:.1f} s with the "
              f"host loops)")
    dvals = con.catalog.get_table("customer").host_column("c_phone")[2]
    plane, lens = TS._pack_dict(dvals, torch.device("cuda"))
    op_ms = cuda_ms(lambda: TS.op_substring(plane, lens, 0, 2), 20)
    t0 = time.perf_counter()
    for _ in range(5):
        TS._decode_plane(*TS.op_substring(plane, lens, 0, 2))
    whole_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"substring(c_phone, 1, 2) plane op on {tuple(plane.shape)} on {card}: "
          f"{op_ms:.4f} ms on the card, {whole_ms:.3f} ms with the transfer and decode")
    return ""


# HyperLogLog's relative standard error with 2,048 registers is
# 1.04 / sqrt(2048) = 2.3%; an estimate more than three of them off the
# exact count is a fault, not chance
HLL_MAX_REL_ERR = 3 * 1.04 / 2048 ** 0.5


def hll_near_exact(rows) -> str:
    """fn_math's approx_count_distinct (column 12) within HLL_MAX_REL_ERR of
    the exact distinct l_partkey count of each group; '' when it is."""
    from duckdb_tpu_torch.testing import tpch_oracle

    exact = tpch_oracle.fn_math_distinct(tpch_oracle._Tables(DATA))
    bad = ""
    for r, n in zip(rows, exact):
        rel = abs(r[12] - n) / n
        print(f"approx_count_distinct({r[0]}, {r[1]}): {r[12]} against {n} distinct "
              f"({100 * rel:.3f}% off; limit {100 * HLL_MAX_REL_ERR:.2f}%)")
        if rel > HLL_MAX_REL_ERR:
            bad = f"fn_math: approx_count_distinct {r[12]} is {100 * rel:.3f}% off {n}"
    return bad


def functions_end(con, card: str) -> str:
    """hash64 on the card equals the CPU's bit for bit over l_orderkey, and
    SELECT without FROM gives DuckDB's answers for greatest with a NULL,
    truncating % and //, and a text value beyond DOUBLE's range; '' when
    they do."""
    import decimal

    import torch

    from duckdb_tpu_torch.ops.hash import hash64
    from duckdb_tpu_torch.planner.bound import BindError
    from duckdb_tpu_torch.errors import ConversionException

    keys = con.catalog.get_table("lineitem").device_column("l_orderkey").data
    ms = cuda_ms(lambda: hash64(keys), 20)
    if not torch.equal(hash64(keys).cpu(), hash64(keys.cpu())):
        return "hash64 on the card differs from the CPU's"
    print(f"hash64 over l_orderkey ({keys.shape[0]} values) on {card}: equal to the CPU's "
          f"bit for bit, {ms:.4f} ms on the card")
    want = [(3, -1, -3, 1, -3, decimal.Decimal("3.0"))]
    got = con.sql("SELECT greatest(1, NULL, 3), -7 % 3, -7 // 2, 7 % -3, 7 // -2, "
                  "least(NULL, 3.0, 5)").rows()
    if got != want:
        return f"SELECT without FROM: {got}, DuckDB gives {want}"
    if con.sql("SELECT TRY_CAST('1e309' AS DOUBLE), TRY_CAST('1e308' AS DOUBLE)").rows() \
            != [(None, 1e308)]:
        return "TRY_CAST('1e309' AS DOUBLE) is not NULL"
    try:
        con.sql("SELECT CAST('1e309' AS DOUBLE)").rows()
        return "CAST('1e309' AS DOUBLE) did not raise"
    except (BindError, ConversionException) as err:
        print(f"SELECT without FROM on {card}: {got[0]} as DuckDB; CAST('1e309' AS DOUBLE) "
              f"raises ({err}), TRY_CAST gives NULL")
    return ""


# phase 12: the routes each nested query takes (exactly), its warm runs
# (nested_collect rebuilds about 1.5M lists per run on the host: 3 runs),
# and the table its rate counts
NESTED_ROUTES = {
    "nested_agg": {"general_aggregate": 1, "general_perfect": 1},
    "nested_collect": {"general_aggregate": 1, "general_perfect": 1, "sort_group": 1},
    "nested_words": {"dense": 1},
    "nested_pack": {"general_aggregate": 1, "general_sort_group": 1},
    "nested_pack_agg": {"general_aggregate": 1, "general_perfect": 1}}
NESTED_WARM_RUNS = {"nested_collect": 3}
NESTED_RATE_TABLE = {"nested_agg": "lineitem", "nested_collect": "lineitem",
                     "nested_words": "part", "nested_pack": "part",
                     "nested_pack_agg": "supplier"}


def nested_end(con, card: str) -> str:
    """Nested values on the card give DuckDB's answers: a list of structs,
    a text cast to INTEGER[], a list cast to VARCHAR, and list_value over
    part's 200,000 rows against numpy; '' when they do."""
    from duckdb_tpu_torch.testing import tpch_oracle

    checks = [("SELECT [{'a': 1}]", [([{"a": 1}],)]),
              ("SELECT CAST('[1, 2, NULL]' AS INTEGER[])", [([1, 2, None],)]),
              ("SELECT CAST([1,2] AS VARCHAR)", [("[1, 2]",)])]
    for sql, want in checks:
        got = con.sql(sql).rows()
        if got != want:
            return f"{sql}: {got}, DuckDB gives {want}"
    t = tpch_oracle._Tables(DATA)
    want = sorted([int(k), int(s)] for k, s in zip(t("part", "p_partkey"), t("part", "p_size")))
    t0 = time.perf_counter()
    got = con.sql("SELECT list_value(p_partkey, p_size) FROM part").rows()
    first_s = time.perf_counter() - t0
    if sorted(r[0] for r in got) != want or len(got) != 200_000 * SF:
        return f"list_value(p_partkey, p_size) over part: {len(got)} rows differ from numpy"
    print(f"nested values on {card}: [{{'a': 1}}], CAST('[1, 2, NULL]' AS INTEGER[]) and "
          f"CAST([1,2] AS VARCHAR) give DuckDB's answers; list_value(p_partkey, p_size) over "
          f"{len(got)} part rows equals numpy ({first_s:.3f} s with Result.rows())")
    return ""


# phase 13: the route each MORE_QUERIES query and the range() count take
# (exactly), and the table (or table function) its rate counts
RANGE_N = 10_000_000
RANGE_SQL = f"SELECT count(*), sum(range) FROM range({RANGE_N})"
MORE_ROUTES = {"more_dates": {"dense": 1}, "more_math": {"dense": 1},
               "more_text": {"general_aggregate": 1, "general_perfect": 1},
               "parity_lists": {"general_aggregate": 1, "general_sort_group": 1},
               "json_orders": {"general_aggregate": 1, "general_perfect": 1},
               "range": {"dense": 1}}
MORE_RATE_TABLE = {"more_dates": "orders", "more_math": "lineitem", "more_text": "part",
                   "parity_lists": "part", "json_orders": "orders", "range": "range"}


def more_end(con, card: str) -> str:
    """On the card: range()'s column was made there; duckdb_functions()
    counts each function type as the port's catalog does; epoch_ms(BIGINT)
    is a TIMESTAMP; current_query() gives its own text. '' when they do."""
    import datetime

    from duckdb_tpu_torch.planner.function_catalog import function_types

    entry = con.catalog.get_table(con._plan_tables[RANGE_SQL][0])
    if entry.device_column("range").data.device.type != "cuda":
        return "range()'s column is not on the card"
    counts = dict(con.sql("SELECT function_type, count(*) FROM duckdb_functions() "
                          "GROUP BY 1").rows())
    types = function_types()
    want_counts = {t: sum(1 for v in types.values() if v == t) for t in set(types.values())}
    if counts != want_counts:
        return f"duckdb_functions() counts {counts}, the catalog {want_counts}"
    if con.sql("SELECT epoch_ms(1700000000000)").rows() != [
            (datetime.datetime(2023, 11, 14, 22, 13, 20),)]:
        return "epoch_ms(1700000000000) is not the TIMESTAMP 2023-11-14 22:13:20"
    q = "SELECT current_query() AS q, 13 AS phase"
    if con.sql(q).rows() != [(q, 13)]:
        return "current_query() does not give its own text"
    print(f"on {card}: range({RANGE_N})'s column made on the card; duckdb_functions() "
          f"counts {counts}; epoch_ms(BIGINT) is a TIMESTAMP; current_query() gives its text")
    return ""


# phase 14: the route each SELECT_FORM_QUERIES query takes (exactly), the
# table its rate counts, and the queries with fewer warm runs
SELECT_ROUTES = {
    "rollup_q1": {"dense": 3, "set_op": 1},
    "cube_flags": {"dense": 4, "set_op": 1},
    "setops_big": {"set_op": 1, "dense": 1},
    "setops_intersect": {"set_op": 1, "sort_group": 1, "dense": 1},
    "setops_except": {"set_op": 1, "sort_group": 1, "dense": 1},
    "setops_intersect_all": {"set_op": 1, "sort_group": 1, "dense": 1},
    "setops_except_all": {"set_op": 1, "sort_group": 1, "dense": 1},
    "values_join": {"set_op": 1, "dense": 1},
    "recursive_months": {"cte_recursive": 1, "probe_dense": 1, "dense": 1},
    "mark_q4": {"dense": 1, "mark_build": 1},
    "mark_in_or": {"mark_build": 1, "dense": 1},
    "notin_residual": {"eager_anti": 1, "dense": 1},
    "asof_ship": {"eager_asof": 1, "dense": 1},
    "band_join": {"ie_join": 1, "dense": 1},
    "cross_small": {"cross_product": 1, "dense": 1},
    "positional": {"positional": 1, "dense": 1},
    "using_left": {"eager_left": 1, "dense": 1},
    "using_full": {"eager_full": 1, "dense": 1},
    "natural_join": {"dense": 1},
    "sample_rows": {"sample": 1, "dense": 1}}
SELECT_RATE_TABLE = {"values_join": "supplier", "recursive_months": "orders",
                     "mark_q4": "orders", "mark_in_or": "orders", "band_join": "part",
                     "cross_small": "nation", "using_left": "orders", "using_full": "orders",
                     "natural_join": "orders"}
SELECT_WARM_RUNS = {}


def select_forms_end(con, card: str) -> str:
    """On the card: TABLESAMPLE 10% REPEATABLE (42) counts within 5
    standard deviations of the binomial mean and repeats itself; the
    catalog functions list the generator's schema. '' when they do."""
    import math

    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import TABLE_COLUMNS

    n = con.catalog.get_table("lineitem").nrows
    got = con.sql(tpch_oracle.SAMPLE_PERCENT_QUERY).rows()[0][0]
    sigma = math.sqrt(n * 0.1 * 0.9)
    if abs(got - n * 0.1) > 5 * sigma:
        return f"TABLESAMPLE 10% counted {got}, not within 5 sigma of {n * 0.1}"
    if con.sql(tpch_oracle.SAMPLE_PERCENT_QUERY).rows()[0][0] != got:
        return "TABLESAMPLE 10% REPEATABLE (42) did not repeat itself"
    t0 = time.perf_counter()
    cols = con.sql("SELECT table_name, column_name, column_index FROM duckdb_columns()").rows()
    cat_s = time.perf_counter() - t0
    if cols != [(t, c, i) for t in sorted(TABLE_COLUMNS)
                for i, (c, _) in enumerate(TABLE_COLUMNS[t])]:
        return f"duckdb_columns() differs from the schema: {cols[:5]}"
    info = con.sql("SELECT cid, name FROM pragma_table_info('lineitem')").rows()
    if info != [(i, c) for i, (c, _) in enumerate(TABLE_COLUMNS["lineitem"])]:
        return f"pragma_table_info('lineitem') differs from the schema: {info[:5]}"
    tables = con.sql("SELECT name, estimated_size, column_count FROM duckdb_tables()").rows()
    want = [(t, con.catalog.get_table(t).nrows, len(TABLE_COLUMNS[t]))
            for t in sorted(TABLE_COLUMNS)]
    if tables != want:
        return f"duckdb_tables() gives {tables}, the catalog {want}"
    print(f"on {card}: TABLESAMPLE 10% REPEATABLE (42) counted {got} of {n} "
          f"({(got - n * 0.1) / sigma:+.2f} sigma) twice; duckdb_columns() "
          f"({len(cols)} rows, {cat_s:.3f} s), pragma_table_info('lineitem') and "
          "duckdb_tables() equal the schema")
    return ""


# phase 15: the route each WINDOW_QUERIES query takes (exactly), and the
# table its rate counts
WINDOW_ROUTES = {"win_rank_lineitem": {"window": 1, "dense": 1},
                 "win_running_orders": {"window": 1, "dense": 1},
                 "win_frames_lineitem": {"window": 1, "dense": 1},
                 "win_lag_lead": {"window": 1, "dense": 1},
                 "win_dist_partsupp": {"window": 1, "sort_group": 1},
                 "win_median_part": {"window": 1, "dense": 1},
                 "qualify_top3": {"window": 1},
                 "distinct_on_nation": {"window": 1}}
WINDOW_RATE_TABLE = {"win_running_orders": "orders", "win_dist_partsupp": "partsupp",
                     "win_median_part": "part", "qualify_top3": "customer",
                     "distinct_on_nation": "customer"}
# phase 16: the device memory limit (48 MiB: every query below needs at
# least 4 chunks of lineitem), the queries run under it, and the ORDER BY
# whose result passes it
OOC_LIMIT = 48 << 20
OOC_SELECT = ("SELECT l_orderkey, l_linenumber, l_extendedprice FROM lineitem "
              "WHERE l_quantity < 3 ORDER BY l_extendedprice DESC, l_orderkey, l_linenumber "
              "LIMIT 100")
OOC_SORT = ("SELECT l_orderkey, l_linenumber, l_extendedprice FROM lineitem "
            "WHERE l_quantity <= 20 ORDER BY l_extendedprice DESC, l_orderkey, l_linenumber")


def busy_share(con, sql, card: str, runs: int = 3) -> str:
    """Device busy share of `runs` warm runs of sql under torch.profiler:
    the summed CUDA kernel time over the wall (tools/profile_torch_query.py's
    measure). '' or a failure message."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    con.sql(sql).rows()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            con.sql(sql).rows()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / runs
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / runs
    top = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: -e.self_device_time_total)[:4]
    busy = "not measured (no device time in the trace)" if device_ms <= 0 \
        else f"{100 * device_ms / wall_ms:.1f}%"
    print(f"busy share on {card}: wall {wall_ms:.3f} ms/query under the profiler, CUDA kernel "
          f"time {device_ms:.3f} ms/query, device busy {busy}; top kernels "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / runs:.3f} ms"
                      for e in top))
    return ""


def numpy_ooc_select(data_dir: str, limit=None, max_qty_cents=299):
    """OOC_SELECT (l_quantity < 3, LIMIT 100) or OOC_SORT (l_quantity <= 20,
    no limit) over the generated files: (l_orderkey, l_linenumber,
    l_extendedprice in cents) columns in ORDER BY order."""
    import numpy as np

    t = os.path.join(data_dir, "lineitem")

    def col(name):
        for ext, dt in ((".i64", np.int64), (".i32", np.int32)):
            if os.path.exists(os.path.join(t, name + ext)):
                return np.fromfile(os.path.join(t, name + ext), dtype=dt).astype(np.int64)
        raise FileNotFoundError(name)

    keep = col("l_quantity") <= max_qty_cents
    ok, ln, price = col("l_orderkey")[keep], col("l_linenumber")[keep], \
        col("l_extendedprice")[keep]
    order = np.lexsort((ln, ok, -price))[:limit]
    return ok[order], ln[order], price[order]


SHARDS = 4
SHARD_QUERIES = {
    "q01": None,  # Q1, set in sharded_phase
    "q03": None,
    "left_join": "SELECT o_orderkey, o_totalprice, c_name FROM orders LEFT JOIN customer "
                 "ON o_custkey = c_custkey AND c_acctbal > 0 "
                 "ORDER BY o_totalprice DESC, o_orderkey LIMIT 100",
    "semi_join": "SELECT o_orderkey, o_totalprice FROM orders WHERE EXISTS (SELECT 1 FROM "
                 "customer WHERE c_custkey = o_custkey AND c_mktsegment = 'BUILDING') "
                 "ORDER BY o_totalprice, o_orderkey LIMIT 100",
    "anti_join": "SELECT o_orderkey, o_totalprice FROM orders WHERE NOT EXISTS (SELECT 1 FROM "
                 "customer WHERE c_custkey = o_custkey AND c_mktsegment = 'BUILDING') "
                 "ORDER BY o_totalprice, o_orderkey LIMIT 100",
    "dup_self_join": "SELECT count(*), sum(a.l_quantity), sum(b.l_extendedprice) FROM lineitem a "
                     "JOIN lineitem b ON a.l_orderkey = b.l_orderkey WHERE a.l_linenumber = 1",
    "order_lineitem": "SELECT l_orderkey, l_linenumber, l_extendedprice FROM lineitem "
                      "ORDER BY l_extendedprice DESC, l_orderkey, l_linenumber",
    "topn_lineitem": "SELECT l_orderkey, l_linenumber, l_extendedprice FROM lineitem "
                     "ORDER BY l_extendedprice DESC, l_orderkey, l_linenumber LIMIT 100",
    "window_lineitem": "SELECT l_orderkey, l_linenumber, row_number() OVER (PARTITION BY "
                       "l_orderkey ORDER BY l_linenumber) AS rn, count(*) OVER (PARTITION BY "
                       "l_orderkey) AS c, sum(l_quantity) OVER (PARTITION BY l_orderkey) AS s "
                       "FROM lineitem",
}
# the sharded operators each must show (any other may run too)
SHARD_ROUTES = {"q01": {"sharded_agg": 1}, "q03": {"exchange_join": 1},
                "left_join": {"exchange_join": 1, "eager_left": 1, "sharded_topn": 1},
                "semi_join": {"exchange_join": 1, "eager_semi": 1, "sharded_topn": 1},
                "anti_join": {"exchange_join": 1, "eager_anti": 1, "sharded_topn": 1},
                "dup_self_join": {"exchange_join_dup": 1, "sharded_agg": 1},
                "order_lineitem": {"sharded_sort": 1}, "topn_lineitem": {"sharded_topn": 1},
                "window_lineitem": {"sharded_window": 1}}
# compared as host columns, not Python rows (6,001,215 rows)
SHARD_COLUMNS = ("order_lineitem", "window_lineitem")


def graft_inputs():
    """__graft_entry__.entry()'s Q1 inputs, rebuilt with numpy (that module
    imports jax): n 2,048, 8 groups, seed 0."""
    import numpy as np

    n = 2048
    rng = np.random.default_rng(0)
    qty = rng.integers(1, 50, n) * 100
    price = rng.integers(1000, 100000, n)
    disc = rng.integers(0, 10, n)
    tax = rng.integers(0, 8, n)
    gid = rng.integers(0, 8, n).astype(np.int32)
    live = rng.random(n) < 0.95
    return (qty, price, disc, tax, gid, live), 8


def numpy_lineitem_order(limit=None):
    """ORDER BY l_extendedprice DESC, l_orderkey, l_linenumber over the
    generated lineitem → (orderkey, linenumber, price in cents) columns."""
    return numpy_ooc_select(DATA, limit=limit, max_qty_cents=1 << 62)


def numpy_lineitem_window():
    """SHARD_QUERIES["window_lineitem"]'s columns in row order: row_number
    by linenumber, the line count and quantity sum of each order."""
    import numpy as np

    t = os.path.join(DATA, "lineitem")

    def col(name):
        for ext, dt in ((".i64", np.int64), (".i32", np.int32)):
            if os.path.exists(os.path.join(t, name + ext)):
                return np.fromfile(os.path.join(t, name + ext), dtype=dt).astype(np.int64)
        raise FileNotFoundError(name)

    ok, ln, qty = col("l_orderkey"), col("l_linenumber"), col("l_quantity")
    _, inv, counts = np.unique(ok, return_inverse=True, return_counts=True)
    sums = np.zeros(len(counts), dtype=np.int64)
    np.add.at(sums, inv, qty)
    order = np.lexsort((np.arange(len(ok)), ln, ok))
    first = np.r_[True, ok[order][1:] != ok[order][:-1]]
    start = np.maximum.accumulate(np.where(first, np.arange(len(ok)), 0))
    rn = np.empty(len(ok), dtype=np.int64)
    rn[order] = np.arange(len(ok)) - start + 1
    return ok, ln, rn, counts[inv], sums[inv]


def _columns_equal(a, b) -> bool:
    import numpy as np

    return a.nrows == b.nrows and all(
        np.array_equal(np.asarray(x[0]), np.asarray(y[0]))
        and (x[1] is None) == (y[1] is None)
        and (x[1] is None or np.array_equal(np.asarray(x[1]), np.asarray(y[1])))
        for x, y in zip(a.columns, b.columns))


def sharded_phase(con, card, recording, recorded, launches_by_query, shapes, reps) -> str:
    """Phase 17 (see the module docstring). '' or a failure message."""
    import decimal

    import numpy as np
    import torch

    import duckdb_tpu_torch
    from duckdb_tpu_torch.execution.executor import Executor
    from duckdb_tpu_torch.ops import grouped as grouped_mod
    from duckdb_tpu_torch.ops import grouped_sum as GS
    from duckdb_tpu_torch.parallel import shard
    from duckdb_tpu_torch.testing import tpch_oracle

    cards = subprocess.run(["nvidia-smi", "-L"], capture_output=True, text=True, timeout=60,
                           check=True).stdout.strip().splitlines()
    mesh = shard.mesh_for(SHARDS, con.device)
    print(f"cards (nvidia-smi -L): {len(cards)}; torch.cuda.device_count() "
          f"{torch.cuda.device_count()}; {SHARDS} shards: {mesh}; "
          f"{'shards share cards' if mesh.shared else 'one card per shard'}")

    # q1_local_partial on the JAX package's entry inputs, against its plain version
    arrays, groups = graft_inputs()
    cuda_in = [torch.from_numpy(np.asarray(a)).to(con.device) for a in arrays]
    GS.grouped_sum_i64.launches = 0
    got = shard.q1_local_partial(*cuda_in, groups)
    torch.cuda.synchronize()
    q1_launches = launches_by_query["q1_local_partial"] = GS.grouped_sum_i64.launches
    want = shard.q1_local_partial(*(torch.from_numpy(np.asarray(a)) for a in arrays), groups)
    qty, price, disc, tax, gid, live = arrays
    omd = price * (100 - disc)
    oracle = [np.array([int(x[live & (gid == g)].sum()) for g in range(groups)], dtype=np.int64)
              for x in (qty, price, omd, omd * (100 + tax), disc, np.ones_like(qty))]
    err = max_abs_err([g.cpu() for g in got], list(want))
    if err or q1_launches != 1 or any(
            not np.array_equal(g.cpu().numpy(), o) for g, o in zip(got, oracle)):
        return (f"q1_local_partial on the card: max abs err {err} against its plain version, "
                f"{q1_launches} launches, or it differs from numpy")
    print(f"q1_local_partial (n 2048, 8 groups, seed 0) on {card}: 1 launch, max abs err 0 "
          f"against its plain version, equal to numpy")

    queries = dict(SHARD_QUERIES, q01=Q1, q03=tpch_oracle.QUERIES["q03"])
    oracles = {"q01": lambda: numpy_q1(DATA), "q03": lambda: tpch_oracle.answer("q03", DATA)}
    ok_, ln_, price_ = numpy_lineitem_order(limit=100)
    oracles["topn_lineitem"] = lambda: [(int(a), int(b), decimal.Decimal(int(c)).scaleb(-2))
                                        for a, b, c in zip(ok_, ln_, price_)]
    sharded = duckdb_tpu_torch.connect(device=con.device)
    sharded.load_tpch(DATA)
    sharded.sql(f"SET num_shards = {SHARDS}")
    sharded.sql("SET exchange_join_threshold = 0")
    con.sql("SET exchange_join_threshold = 0")
    placement = "sharded_shared_card" if mesh.shared else "sharded"
    try:
        for name, sql in queries.items():
            columns = name in SHARD_COLUMNS
            single = con.sql(sql)
            recorded.clear()
            grouped_mod.grouped_sum_i64 = recording
            GS.grouped_sum_i64.launches = 0
            GS.grouped_sum_i64.regime_launches = {"single": 0, "small": 0, "large": 0}
            sharded.routes.clear()
            shard.COPIED["bytes"] = 0
            t0 = time.perf_counter()
            res = sharded.sql(sql)
            got = None if columns else res.rows()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
            launches = GS.grouped_sum_i64.launches
            launches_by_query[f"{name}_sharded"] = launches
            routes = dict(sharded.routes)
            copied = shard.COPIED["bytes"]
            if columns:
                if not _columns_equal(res, single):
                    return f"{name} on {SHARDS} shards differs from its single-device run"
                want_cols = numpy_lineitem_order() if name == "order_lineitem" \
                    else numpy_lineitem_window()
                if any(not np.array_equal(np.asarray(c[0]).astype(np.int64), w)
                       for c, w in zip(res.columns, want_cols)):
                    return f"{name} on {SHARDS} shards differs from numpy"
            else:
                bad = rows_match(got, single.rows())
                if bad:
                    return f"{name} on {SHARDS} shards differs from its single-device run: {bad}"
                if name in oracles:
                    bad = rows_match(got, oracles[name]())
                    if bad:
                        return f"{name} on {SHARDS} shards differs from the numpy oracle: {bad}"
            want_routes = SHARD_ROUTES[name]
            if any(routes.get(k, 0) < v for k, v in want_routes.items()) \
                    or not routes.get(placement):
                return f"{name} missed its sharded route {want_routes} ({placement}): {routes}"
            if name == "q01" and (launches != SHARDS or len(recorded) != SHARDS):
                return (f"sharded Q1 launched the grouped sum {launches} times, not once per "
                        f"shard ({SHARDS})")
            for dense, vecs, nseg in recorded:
                if dense.device.type != con.device.type:
                    return f"{name}: the grouped sum ran off the card"
                err = max_abs_err(GS.grouped_sum_i64(dense, vecs, nseg),
                                  GS.grouped_sum_i64_plain(dense, vecs, nseg))
                torch.cuda.synchronize()
                if err:
                    return f"grouped_sum_i64 disagrees with its plain version on {name}'s shard"
            timed = set()
            for dense, vecs, nseg in recorded:
                n_q, k_q = dense.shape[0], len(vecs)
                if (n_q, k_q, nseg, dense.device) in timed:
                    continue
                timed.add((n_q, k_q, nseg, dense.device))
                with torch.cuda.device(dense.device):  # cuda_ms's events on that card
                    k_ms, p_ms, l_ms, call = time_kernel(GS, dense, vecs, nseg, reps)
                b_ms, b_by, b_bytes, b_adds = bound_of(dense, vecs, nseg)
                if k_ms * BOUND_SLACK < b_ms:
                    return (f"grouped_sum_i64 on {dense.device} at {name}'s shard shape timed "
                            f"{k_ms:.4f} ms, under its bound {b_ms:.4f} ms: the events did not "
                            f"time the launches")
                print(f"grouped_sum_i64 at {name}_sharded's shard shape N={n_q} K={k_q} "
                      f"nseg={nseg} on {dense.device} of {card}: max abs err 0, kernel "
                      f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, index_add_ {l_ms:.4f} ms, bound "
                      f"{b_ms:.4f} ms by {b_by} ({b_bytes} bytes, {b_adds} adds); "
                      f"{call_text(call)}")
                shapes.append({"query": f"{name}_sharded", "n": n_q, "k": k_q, "nseg": nseg,
                               "max_abs_err": 0, "kernel_ms": k_ms, "plain_ms": p_ms,
                               "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms, **call})
            times = []
            for _ in range(4):
                t0 = time.perf_counter()
                again = sharded.sql(sql)
                same = _columns_equal(again, res) if columns else again.rows() == got
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                if not same:
                    return f"{name} on {SHARDS} shards changed between runs"
            med = statistics.median(times[1:])
            syncs = count_syncs(lambda: sharded.sql(sql).rows() if not columns
                                else sharded.sql(sql))
            t0 = time.perf_counter()
            con.sql(sql) if columns else con.sql(sql).rows()
            torch.cuda.synchronize()
            single_s = time.perf_counter() - t0
            print(f"{name} on {SHARDS} shards ({card}): first run {first_s:.3f} s, "
                  f"{res.nrows} rows equal the single-device run"
                  f"{' and numpy' if name in oracles or columns else ''}; routes {routes}; "
                  f"grouped_sum_i64 launches {launches}; median of 3 warm runs "
                  f"{med * 1e3:.3f} ms (runs {', '.join(f'{x * 1e3:.3f}' for x in times[1:])} "
                  f"ms; one single-device run {single_s * 1e3:.3f} ms), {syncs} host syncs, "
                  f"{copied} bytes copied between cards")
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
        con.sql("RESET exchange_join_threshold")
    del sharded

    # AUTO: every visible card once the rows pass auto_shard_rows
    con.sql("SET num_shards = 0")
    try:
        con.routes.clear()
        rows = con.sql(Q1).rows()
        chosen = Executor(con.catalog)._join_shards(
            rows=con.catalog.get_table("lineitem").nrows)
        routes = dict(con.routes)
    finally:
        con.sql("SET num_shards = 1")
    bad = rows_match(rows, numpy_q1(DATA))
    if bad:
        return f"Q1 under num_shards = 0 differs from numpy: {bad}"
    visible = shard.visible_devices(con.device)
    if (chosen > 1) != ("sharded_agg" in routes) or chosen != max(visible, 1):
        return f"AUTO chose {chosen} shards on {visible} cards with routes {routes}"
    print(f"num_shards = 0 (AUTO) on {visible} visible card(s): chose {chosen} shard(s) for "
          f"lineitem's rows; Q1 equals numpy; routes {routes}")
    return ""


def out_of_core_phase(con, card, recording, recorded, launches_by_query, shapes, reps) -> str:
    """Phase 16 (see the module docstring). '' or a failure message."""
    import decimal

    import numpy as np
    import torch

    from duckdb_tpu_torch.catalog import catalog as C
    from duckdb_tpu_torch.ops import grouped as grouped_mod
    from duckdb_tpu_torch.ops import grouped_sum as GS
    from duckdb_tpu_torch.testing import tpch_oracle

    def numpy_select():
        ok, ln, price = numpy_ooc_select(DATA, limit=100)
        return [(int(a), int(b), decimal.Decimal(int(c)).scaleb(-2))
                for a, b, c in zip(ok, ln, price)]

    queries = {"q01": (Q1, lambda: numpy_q1(DATA)),
               "q03": (tpch_oracle.QUERIES["q03"], lambda: tpch_oracle.answer("q03", DATA)),
               "q06": (tpch_oracle.GENERAL_QUERIES["q06"],
                       lambda: tpch_oracle.answer("q06", DATA)),
               "ooc_select": (OOC_SELECT, numpy_select)}
    nrows = con.catalog.get_table("lineitem").nrows
    for name, (sql, oracle) in queries.items():
        C.set_memory_limit(0)
        in_memory = con.sql(sql).rows()
        mem_med, mem_times = warm_median(con, sql, in_memory)
        C.set_memory_limit(OOC_LIMIT)
        recorded.clear()
        grouped_mod.grouped_sum_i64 = recording
        GS.grouped_sum_i64.launches = 0
        GS.grouped_sum_i64.regime_launches = {"single": 0, "small": 0, "large": 0}
        con.routes.clear()
        t0 = time.perf_counter()
        got = con.sql(sql).rows()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
        launches = GS.grouped_sum_i64.launches
        routes = dict(con.routes)
        launches_by_query[f"{name}_ooc"] = launches
        chunks = routes.get("out_of_core_chunks", 0)
        if got != in_memory:
            return f"{name} under the limit differs from its run in memory"
        bad = rows_match(got, oracle())
        if bad:
            return f"{name} under the limit differs from the numpy oracle: {bad}"
        if routes.get("out_of_core") != 1 or chunks < 4:
            return f"{name} did not run in at least 4 chunks: routes {routes}"
        if name in ("q01", "q06") and launches != chunks + 1:
            return (f"{name} launched the grouped sum {launches} times, not once per chunk "
                    f"and once for the merge ({chunks} + 1)")
        print(f"{name} under memory_limit {OOC_LIMIT} on {card}: first run {first_s:.3f} s, "
              f"{len(got)} rows equal the in-memory run and the numpy oracle; "
              f"{chunks} chunks of lineitem ({-(-nrows // chunks)} rows each); routes "
              f"{routes}; grouped_sum_i64 launches {launches}")
        timed = set()
        for dense, vecs, nseg in recorded:
            err = max_abs_err(GS.grouped_sum_i64(dense, vecs, nseg),
                              GS.grouped_sum_i64_plain(dense, vecs, nseg))
            torch.cuda.synchronize()
            n_q, k_q = dense.shape[0], len(vecs)
            if err:
                return f"grouped_sum_i64 disagrees with its plain version on {name}'s chunks"
            if (n_q, k_q, nseg) in timed:
                continue
            timed.add((n_q, k_q, nseg))
            k_ms, p_ms, l_ms, call = time_kernel(GS, dense, vecs, nseg, reps)
            b_ms, b_by, b_bytes, b_adds = bound_of(dense, vecs, nseg)
            print(f"grouped_sum_i64 at {name}_ooc's shape N={n_q} K={k_q} nseg={nseg} on "
                  f"{card}: max abs err {err}, kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"index_add_ {l_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({b_bytes} bytes, "
                  f"{b_adds} adds); {call_text(call)}")
            shapes.append({"query": f"{name}_ooc", "n": n_q, "k": k_q, "nseg": nseg,
                           "max_abs_err": err, "kernel_ms": k_ms, "plain_ms": p_ms,
                           "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms, **call})
        med, times = warm_median(con, sql, in_memory)
        if med is None:
            return f"{name}: {times}"
        syncs = count_syncs(lambda: con.sql(sql).rows())
        print(f"{name} SF{SF:g} on {card}: under the limit median of 5 warm runs "
              f"{med * 1e3:.3f} ms (runs {', '.join(f'{t * 1e3:.3f}' for t in times)} ms), "
              f"{nrows / med:.0f} lineitem rows/s, {syncs} host syncs; in memory "
              f"{mem_med * 1e3:.3f} ms")

    # the ORDER BY whose result passes the limit: range partitions
    C.set_memory_limit(0)
    mem = con.sql(OOC_SORT)
    C.set_memory_limit(OOC_LIMIT)
    con.routes.clear()
    t0 = time.perf_counter()
    res = con.sql(OOC_SORT)
    sort_s = time.perf_counter() - t0
    C.set_memory_limit(0)
    routes = dict(con.routes)
    want = numpy_ooc_select(DATA, limit=None, max_qty_cents=2000)
    if res.nrows != mem.nrows or res.nrows != len(want[0]):
        return f"the ORDER BY under the limit gave {res.nrows} rows, in memory {mem.nrows}"
    for (a, _, _), (b, _, _), w in zip(res.columns, mem.columns, want):
        if not (np.array_equal(np.asarray(a).astype(np.int64), np.asarray(b).astype(np.int64))
                and np.array_equal(np.asarray(a).astype(np.int64), w)):
            return "the range-partitioned ORDER BY differs from the in-memory run or numpy"
    if routes.get("out_of_core_sort") != 1:
        return f"the ORDER BY under the limit did not sort range partitions: routes {routes}"
    print(f"ORDER BY of {res.nrows} rows under memory_limit {OOC_LIMIT} on {card}: "
          f"{sort_s:.3f} s, {routes.get('out_of_core_chunks')} chunks, "
          f"{routes.get('out_of_core_sort_partitions')} range partitions; columns equal the "
          f"in-memory run's and numpy's lexsort")
    return ""


class TransferCounter:
    """Bytes that cross between the host and a CUDA device through
    torch.Tensor.to / .cpu / .cuda (every promotion, result copy and host
    read of the port goes through one of them) while counting."""

    def __init__(self):
        import torch

        self.torch = torch
        self.bytes = 0
        self._orig = {}

    def __enter__(self):
        T = self.torch.Tensor
        for name in ("to", "cpu", "cuda"):
            self._orig[name] = getattr(T, name)

        def wrap(orig):
            def f(t, *args, **kwargs):
                out = orig(t, *args, **kwargs)
                if out is not t and out.device.type != t.device.type:
                    self.bytes += t.numel() * t.element_size()
                return out
            return f

        for name, orig in self._orig.items():
            setattr(T, name, wrap(orig))
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(self.torch.Tensor, name, orig)
        return False


class Steps:
    """What phases 18 and 19 share: a step run with its wall time, host syncs
    (CUDA sync debug mode) and host<->device bytes (TransferCounter); a step
    whose grouped-sum launches are counted and whose kernel inputs are
    recorded; and the kernel held to its plain version and timed at each
    shape a step recorded."""

    def __init__(self, phase, card, recording, recorded, launches_by_query, shapes, reps):
        self.phase, self.card, self.reps = phase, card, reps
        self.recording, self.recorded = recording, recorded
        self.launches_by_query, self.shapes = launches_by_query, shapes

    def step(self, label, fn):
        """→ (fn's value, the line to print)."""
        import warnings

        import torch

        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught, TransferCounter() as moved:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                value = fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        return value, (f"phase {self.phase} step {label} on {self.card}: {wall * 1e3:.3f} ms "
                       f"wall, {syncs} host syncs, {moved.bytes} host<->device bytes")

    def with_kernel(self, label, name, fn):
        from duckdb_tpu_torch.ops import grouped as grouped_mod
        from duckdb_tpu_torch.ops import grouped_sum as GS

        self.recorded.clear()
        grouped_mod.grouped_sum_i64 = self.recording
        GS.grouped_sum_i64.launches = 0
        try:
            value, line = self.step(label, fn)
        finally:
            grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
        self.launches_by_query[name] = GS.grouped_sum_i64.launches
        return value, line

    def kernel_check(self, name, timed=None) -> str:
        """'' when the kernel equals its plain version on every recorded
        input, each shape timed once (once across the calls that share
        `timed`); else a failure message."""
        import torch

        from duckdb_tpu_torch.ops import grouped_sum as GS

        timed = set() if timed is None else timed
        for dense, vecs, nseg in self.recorded:
            err = max_abs_err(GS.grouped_sum_i64(dense, vecs, nseg),
                              GS.grouped_sum_i64_plain(dense, vecs, nseg))
            torch.cuda.synchronize()
            if err:
                return f"grouped_sum_i64 disagrees with its plain version on {name}"
            n_q, k_q = dense.shape[0], len(vecs)
            if (n_q, k_q, nseg) in timed:
                continue
            timed.add((n_q, k_q, nseg))
            k_ms, p_ms, l_ms, call = time_kernel(GS, dense, vecs, nseg, self.reps)
            b_ms, b_by, b_bytes, b_adds = bound_of(dense, vecs, nseg)
            print(f"grouped_sum_i64 at {name}'s shape N={n_q} K={k_q} nseg={nseg} on "
                  f"{self.card}: max abs err 0, kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"index_add_ {l_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({b_bytes} bytes, "
                  f"{b_adds} adds); {call_text(call)}")
            self.shapes.append({"query": name, "n": n_q, "k": k_q, "nseg": nseg,
                                "max_abs_err": 0, "kernel_ms": k_ms, "plain_ms": p_ms,
                                "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms, **call})
        return ""


def dml_phase(card, recording, recorded, launches_by_query, shapes, reps) -> str:
    """Phase 18 (see the module docstring). '' or a failure message."""
    import datetime
    import decimal
    import gc

    import numpy as np
    import torch

    import duckdb_tpu_torch
    from duckdb_tpu_torch.api.connection import TransactionException
    from duckdb_tpu_torch.catalog import catalog as C
    from duckdb_tpu_torch.errors import ConstraintException

    con = duckdb_tpu_torch.connect()
    con.load_tpch(DATA)
    con.sql("SET num_shards = 1")
    for table in ("lineitem", "orders"):  # resident before the baseline
        entry = con.catalog.get_table(table)
        for cd in entry.columns:
            entry.device_column(cd.name)
    base = lineitem_numpy(DATA)
    li = {k: v.copy() for k, v in base.items()}

    def day(s):
        return (datetime.date.fromisoformat(s) - datetime.date(1970, 1, 1)).days

    kit = Steps(18, card, recording, recorded, launches_by_query, shapes, reps)
    step, kernel_check, with_kernel = kit.step, kit.kernel_check, kit.with_kernel

    def count_of(res):
        return res.rows()[0][0]

    q1_li = Q1.replace("FROM lineitem", "FROM li")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()

    # 1. CREATE TABLE … AS SELECT
    _, line = step("1 CREATE TABLE li AS SELECT * FROM lineitem",
                   lambda: con.sql("CREATE TABLE li AS SELECT * FROM lineitem"))
    n = con.catalog.get_table("li").nrows
    if n != len(li["l_orderkey"]):
        return f"li has {n} rows, lineitem {len(li['l_orderkey'])}"
    print(line + f"; {n} rows")
    # 2. DELETE
    got, line = step("2 DELETE", lambda: count_of(con.sql(
        "DELETE FROM li WHERE l_shipdate < DATE '1993-01-01'")))
    gone = li["l_shipdate"] < day("1993-01-01")
    li = {k: v[~gone] for k, v in li.items()}
    if got != int(gone.sum()):
        return f"DELETE counted {got}, numpy {int(gone.sum())}"
    print(line + f"; Count {got} equals numpy's")
    # 3. UPDATE
    got, line = step("3 UPDATE", lambda: count_of(con.sql(
        "UPDATE li SET l_discount = l_discount + 0.01 WHERE l_returnflag = 'R' AND "
        "l_discount < 0.10")))
    m = (li["l_returnflag"] == b"R") & (li["l_discount"] < 10)
    li["l_discount"] = np.where(m, li["l_discount"] + 1, li["l_discount"])
    if got != int(m.sum()):
        return f"UPDATE counted {got}, numpy {int(m.sum())}"
    print(line + f"; Count {got} equals numpy's")
    # 4. INSERT … SELECT
    got, line = step("4 INSERT … SELECT", lambda: count_of(con.sql(
        "INSERT INTO li SELECT * FROM lineitem WHERE l_orderkey % 7 = 0")))
    add = base["l_orderkey"] % 7 == 0
    li = {k: np.concatenate([v, base[k][add]]) for k, v in li.items()}
    if got != int(add.sum()):
        return f"INSERT counted {got}, numpy {int(add.sum())}"
    print(line + f"; Count {got} equals numpy's")
    # 5. Q1 over the edited table, through the kernel
    rows5, line = with_kernel("5 Q1 over li", "q01_dml", lambda: con.sql(q1_li).rows())
    bad = rows_match(rows5, numpy_q1_of(li))
    if bad:
        return f"Q1 over li differs from the numpy oracle: {bad}"
    if launches_by_query["q01_dml"] < 1:
        return "Q1 over li did not launch the grouped sum"
    print(line + f"; {len(rows5)} rows equal numpy's; grouped_sum_i64 launches "
          f"{launches_by_query['q01_dml']}")
    bad = kernel_check("q01_dml")
    if bad:
        return bad
    # 6. a rolled-back DELETE
    con.sql("BEGIN")
    got, line = step("6 DELETE in a transaction", lambda: count_of(con.sql(
        "DELETE FROM li WHERE l_linestatus = 'F'")))
    f_rows = int((li["l_linestatus"] == b"F").sum())
    inside = count_of(con.sql("SELECT count(*) FROM li"))
    con.sql("ROLLBACK")
    if got != f_rows or inside != len(li["l_orderkey"]) - f_rows:
        return f"the DELETE in the transaction counted {got} and left {inside} rows"
    again, line2 = step("6 Q1 after ROLLBACK", lambda: con.sql(q1_li).rows())
    if again != rows5:
        return "Q1 after the ROLLBACK differs from step 5"
    print(line + f"; Count {got} and count(*) {inside} equal numpy's")
    print(line2 + "; equals step 5")
    # 7. two cursors: first committer wins at table granularity
    c2 = con.cursor()
    con.sql("BEGIN")
    c2.sql("BEGIN")
    got, line = step("7 UPDATE by cursor 1", lambda: count_of(con.sql(
        "UPDATE li SET l_tax = l_tax + 0.01 WHERE l_linenumber = 1")))
    if got != int((li["l_linenumber"] == 1).sum()):
        return f"cursor 1's UPDATE counted {got}"
    if c2.sql(q1_li).rows() != rows5:
        return "cursor 2 saw cursor 1's uncommitted UPDATE"
    c2.sql("UPDATE li SET l_tax = 0 WHERE l_linenumber = 2")
    con.sql("COMMIT")
    try:
        c2.sql("COMMIT")
        return "cursor 2's COMMIT of a table cursor 1 wrote did not raise"
    except TransactionException:
        pass
    li["l_tax"] = np.where(li["l_linenumber"] == 1, li["l_tax"] + 1, li["l_tax"])
    rows7, line2 = step("7 Q1 after both COMMITs", lambda: con.sql(q1_li).rows())
    bad = rows_match(rows7, numpy_q1_of(li)) or rows_match(c2.sql(q1_li).rows(), rows7)
    if bad:
        return f"Q1 after the two commits differs from numpy (cursor 1's update only): {bad}"
    print(line + "; cursor 2's Q1 equals step 5; cursor 2's COMMIT raised "
          "TransactionException")
    print(line2 + "; equals numpy with cursor 1's update and not cursor 2's")
    del c2
    # 8. constraints and ON CONFLICT
    o_dir = os.path.join(DATA, "orders")
    okey = np.fromfile(os.path.join(o_dir, "o_orderkey.i64"), dtype=np.int64)
    oprice = np.fromfile(os.path.join(o_dir, "o_totalprice.i64"), dtype=np.int64)
    con.sql("CREATE TABLE o (o_orderkey BIGINT PRIMARY KEY, o_custkey BIGINT NOT NULL, "
            "o_totalprice DECIMAL(15,2), o_orderdate DATE)")
    got, line = step("8 INSERT INTO o", lambda: count_of(con.sql(
        "INSERT INTO o SELECT o_orderkey, o_custkey, o_totalprice, o_orderdate FROM orders")))
    if got != len(okey):
        return f"INSERT INTO o counted {got}, orders has {len(okey)}"
    print(line + f"; Count {got}")
    try:
        con.sql(f"INSERT INTO o SELECT o_orderkey, o_custkey, o_totalprice, o_orderdate "
                f"FROM orders WHERE o_orderkey = {int(okey[0])}")
        return "a duplicate primary key did not raise"
    except ConstraintException as err:
        print(f"phase 18 step 8: a duplicate key raised ConstraintException ({err})")
    kth = int(np.sort(okey)[999])
    got, line = step("8 INSERT … ON CONFLICT DO UPDATE", lambda: count_of(con.sql(
        "INSERT INTO o SELECT o_orderkey, o_custkey, o_totalprice + 1, o_orderdate FROM "
        f"orders WHERE o_orderkey <= {kth} ON CONFLICT DO UPDATE SET "
        "o_totalprice = excluded.o_totalprice")))
    low = okey <= kth
    want = [(int(low.sum()), decimal.Decimal(int(oprice[low].sum()) + 100 * int(low.sum()))
             .scaleb(-2)),
            (int((~low).sum()), decimal.Decimal(int(oprice[~low].sum())).scaleb(-2))]
    have = [tuple(con.sql(f"SELECT count(*), sum(o_totalprice) FROM o WHERE o_orderkey "
                          f"{op} {kth}").rows()[0]) for op in ("<=", ">")]
    # DuckDB's Count of an upsert is the rows appended plus the rows updated
    if got != 1000 or int(low.sum()) != 1000 or have != want:
        return f"the upsert counted {got} and left {have}, numpy {want}"
    print(line + f"; Count {got} (1000 rows updated, none appended); the 1000 keys' sum and "
          "count and the others' equal numpy's")
    # 9. INSERT … SELECT … GROUP BY through the kernel
    con.sql("CREATE TABLE agg (f VARCHAR, s VARCHAR, q DECIMAL(38,2))")
    got, line = with_kernel("9 INSERT … SELECT … GROUP BY", "insert_agg_dml",
                            lambda: count_of(con.sql(
        "INSERT INTO agg SELECT l_returnflag, l_linestatus, sum(l_quantity) FROM li "
        "GROUP BY l_returnflag, l_linestatus")))
    want = sorted((r.decode(), s_.decode(),
                   decimal.Decimal(int(li["l_quantity"][(li["l_returnflag"] == r)
                                                        & (li["l_linestatus"] == s_)].sum()))
                   .scaleb(-2))
                  for r, s_ in set(zip(li["l_returnflag"].tolist(),
                                       li["l_linestatus"].tolist())))
    rows9 = con.sql("SELECT * FROM agg ORDER BY f, s").rows()
    bad = rows_match(rows9, want)
    if bad or got != len(want):
        return f"agg differs from numpy: {bad or got}"
    if launches_by_query["insert_agg_dml"] < 1:
        return "INSERT … SELECT … GROUP BY did not launch the grouped sum"
    print(line + f"; {got} rows equal numpy's; grouped_sum_i64 launches "
          f"{launches_by_query['insert_agg_dml']}")
    bad = kernel_check("insert_agg_dml")
    if bad:
        return bad
    # 10. DROP: the pool lets the tables go, the card its memory
    entries = [con.catalog.get_table(t) for t in ("li", "o", "agg")]
    _, line = step("10 DROP", lambda: con.sql("DROP TABLE li; DROP TABLE o; DROP TABLE agg"))
    if any(C.POOL.holds(e) for e in entries):
        return "the pool still holds a column of a dropped table"
    del entries
    recorded.clear()  # the kernel inputs this phase kept to check and time
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem1 = torch.cuda.memory_allocated()
    if mem1 - mem0 > 64 << 20:
        return (f"after the drops the card holds {mem1 - mem0} bytes more than before step 1 "
                "(over 64 MiB)")
    print(line + f"; the pool holds no column of li, o or agg; memory_allocated "
          f"{mem1 - mem0:+d} bytes against before step 1")
    return ""

FILE_DB = os.path.join(ROOT, "build", "phase19_db")
# phase 19 step 4's committed DELETE, which the cut WAL tears
TORN_DELETE = "DELETE FROM lineitem WHERE l_quantity > 45"
# phase 19 step 3's transaction: phase 18's edits, on lineitem itself
FILE_EDITS = ("DELETE FROM lineitem WHERE l_shipdate < DATE '1993-01-01'",
              "UPDATE lineitem SET l_discount = l_discount + 0.01 WHERE l_returnflag = 'R' "
              "AND l_discount < 0.10",
              "INSERT INTO lineitem SELECT * FROM lineitem WHERE l_orderkey % 7 = 0")
FILE_CHILD = """
import os, sys
sys.path.insert(0, {root!r})
import duckdb_tpu_torch
con = duckdb_tpu_torch.connect({db!r})
con.sql("BEGIN")
counts = [con.sql(q).rows()[0][0] for q in {edits!r}]
con.sql("COMMIT")
print(counts, flush=True)
os._exit(0)  # killed right after COMMIT returned: no close(), no checkpoint
"""


def file_db_phase(card, recording, recorded, launches_by_query, shapes, reps) -> str:
    """Phase 19 (see the module docstring). '' or a failure message."""
    import datetime
    import gc
    import shutil

    import numpy as np
    import torch

    import duckdb_tpu_torch
    from duckdb_tpu_torch.api import connection as AC
    from duckdb_tpu_torch.catalog import catalog as C
    from duckdb_tpu_torch.storage import persist

    kit = Steps(19, card, recording, recorded, launches_by_query, shapes, reps)
    shutil.rmtree(FILE_DB, ignore_errors=True)
    li = lineitem_numpy(DATA)

    def disk_bytes(path):
        return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)

    def q1_step(label, name, con, want):
        rows, line = kit.with_kernel(label, name, lambda: con.sql(Q1).rows())
        bad = rows_match(rows, want)
        if bad:
            return f"{label}: Q1 differs from numpy: {bad}"
        if launches_by_query[name] < 1:
            return f"{label}: Q1 did not launch the grouped sum"
        print(line + f"; {len(rows)} rows equal numpy's; grouped_sum_i64 launches "
              f"{launches_by_query[name]}")
        return kit.kernel_check(name)

    # 1. lineitem at SF1 in a file database, then CHECKPOINT
    con = duckdb_tpu_torch.connect(FILE_DB)
    con.load_tpch(DATA, tables=["lineitem"])
    entry = con.catalog.get_table("lineitem")
    _, line = kit.step("1 load lineitem's columns from the generated files",
                       lambda: [entry.host_column(cd.name) for cd in entry.columns])
    print(line)
    _, line = kit.step("1 CHECKPOINT of lineitem", lambda: con.sql("CHECKPOINT"))
    raw = 0
    for cd in entry.columns:
        values, validity, dvals = entry.host_column(cd.name)
        raw += values.nbytes + (0 if validity is None else validity.nbytes)
        raw += 0 if dvals is None else sum(len(str(v).encode()) for v in dvals)
    gen_dir = persist._data_gen_dir(FILE_DB, persist._current_gen(FILE_DB))
    with open(os.path.join(gen_dir, "lineitem", "meta.json")) as f:
        cols = json.load(f)["columns"]
    schemes = {c["name"]: c["enc"]["s"] if c["kind"] == "z" else c["kind"] for c in cols}
    disk = disk_bytes(FILE_DB)
    print(line + f"; {entry.nrows} rows, {len(cols)} columns, {disk} bytes on disk against "
          f"{raw} raw bytes ({disk / raw:.3f}); codec {persist.C.CODEC}; schemes {schemes}")
    if entry.nrows != len(li["l_orderkey"]) or len(cols) != 16:
        return f"the file database holds {entry.nrows} rows of {len(cols)} columns"
    del entry

    # 2. close, reopen: Q1's first run reads the columns and sends them to
    # the card, then its warm median
    con.close()
    if any(C.POOL.holds(e) for e in con._db.catalog.tables.values()):
        return "the pool still holds a column of the closed database"
    con, line = kit.step("2 reopen", lambda: duckdb_tpu_torch.connect(FILE_DB))
    print(line + "; columns load lazily")
    want = numpy_q1_of(li)
    bad = q1_step("2 Q1 over the reopened lineitem (first run)", "q01_file_reopen", con, want)
    if bad:
        return bad
    med, times = warm_median(con, Q1, want)
    if med is None:
        return f"Q1 over the reopened lineitem: {times}"
    print(f"phase 19 Q1 over the reopened lineitem on {card}: median of 5 warm runs "
          f"{med * 1e3:.3f} ms (runs {', '.join(f'{t * 1e3:.3f}' for t in times)} ms)")
    con.close()

    # 3. a child process commits phase 18's edits in one transaction and is
    # killed right after COMMIT; the reopen replays the WAL
    def day(text):
        return (datetime.date.fromisoformat(text) - datetime.date(1970, 1, 1)).days

    gone = li["l_shipdate"] < day("1993-01-01")
    li = {k: v[~gone] for k, v in li.items()}
    upd = (li["l_returnflag"] == b"R") & (li["l_discount"] < 10)
    li["l_discount"] = np.where(upd, li["l_discount"] + 1, li["l_discount"])
    add = li["l_orderkey"] % 7 == 0
    want_counts = [int(gone.sum()), int(upd.sum()), int(add.sum())]
    li = {k: np.concatenate([v, v[add]]) for k, v in li.items()}
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", FILE_CHILD.format(
        root=ROOT, db=FILE_DB, edits=FILE_EDITS)], capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    child_s = time.perf_counter() - t0
    if out.returncode != 0 or out.stdout.strip() != str(want_counts):
        return (f"the child's transaction gave {out.stdout.strip()!r} (rc {out.returncode}), "
                f"numpy {want_counts}: {out.stderr[-2000:]}")
    wal_size = persist.wal_size(FILE_DB)
    print(f"phase 19 step 3 on {card}: a child process committed the DELETE, UPDATE and "
          f"INSERT … SELECT in one transaction (Counts {want_counts} equal numpy's) and was "
          f"killed after COMMIT; {child_s * 1e3:.3f} ms with its start; WAL {wal_size} bytes")
    con, line = kit.step("3 recovery (open and WAL replay)",
                         lambda: duckdb_tpu_torch.connect(FILE_DB))
    print(line)
    want3 = numpy_q1_of(li)
    bad = q1_step("3 Q1 over the recovered lineitem", "q01_file_recovered", con, want3)
    if bad:
        return bad

    # 4. one more committed DELETE, then the WAL cut inside that unit: the
    # reopen drops the torn unit
    n_before = con.sql("SELECT count(*) FROM lineitem").rows()[0][0]
    con.sql(TORN_DELETE)
    del con
    AC._OPEN_DBS.clear()  # the process died as the unit was written
    wal = os.path.join(FILE_DB, persist.WAL_NAME)
    size = os.path.getsize(wal)
    with open(wal, "r+b") as f:
        f.truncate(size - (size - wal_size) // 2)
    gc.collect()
    con, line = kit.step("4 reopen over the torn WAL", lambda: duckdb_tpu_torch.connect(FILE_DB))
    n_after = con.sql("SELECT count(*) FROM lineitem").rows()[0][0]
    if n_after != n_before:
        return f"the torn unit was applied: {n_after} rows, {n_before} before it"
    if persist.wal_size(FILE_DB) != wal_size:
        return (f"the reopen left {persist.wal_size(FILE_DB)} WAL bytes, not the "
                f"{wal_size} of the last complete unit")
    print(line + f"; {n_after} rows: the torn DELETE's unit was dropped and cut off the WAL "
          f"({wal_size} bytes left)")
    bad = q1_step("4 Q1 after the torn unit", "q01_file_torn", con, want3)
    if bad:
        return bad
    _, line = kit.step("4 close (checkpoint)", con.close)
    print(line + f"; {disk_bytes(FILE_DB)} bytes on disk")

    # 5. ATTACH READ_ONLY from a fresh in-memory connection
    mem = duckdb_tpu_torch.connect()
    _, line = kit.step("5 ATTACH READ_ONLY", lambda: mem.sql(
        f"ATTACH '{FILE_DB}' AS ext (READ_ONLY)"))
    print(line)
    rows, line = kit.with_kernel("5 Q1 over ext.lineitem", "q01_file_attached",
                                 lambda: mem.sql(Q1.replace("FROM lineitem",
                                                            "FROM ext.lineitem")).rows())
    bad = rows_match(rows, want3)
    if bad or launches_by_query["q01_file_attached"] < 1:
        return f"Q1 over ext.lineitem: {bad or 'no grouped-sum launch'}"
    print(line + f"; {len(rows)} rows equal step 4's; grouped_sum_i64 launches "
          f"{launches_by_query['q01_file_attached']}")
    bad = kit.kernel_check("q01_file_attached")
    if bad:
        return bad
    try:
        mem.sql("DELETE FROM ext.lineitem WHERE l_orderkey = 1")
        return "a write into the READ_ONLY attached database did not raise"
    except Exception as err:  # noqa: BLE001 — the message is what is checked
        if "read-only" not in str(err):
            return f"the READ_ONLY write raised {err!r}"
        print(f"phase 19 step 5: a write into ext raised ({err})")
    mem.close()
    recorded.clear()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(FILE_DB, ignore_errors=True)
    return ""



# phase 20: the file readers at SF1, in the git-ignored build/phase20
FILES_DIR = os.path.join(ROOT, "build", "phase20")
# the committed fixtures pyarrow wrote (the card has no pyarrow), with
# their expected rows beside them (tools/make_torch_io_fixtures.py)
FIXTURES = os.path.join(ROOT, "tests", "data", "torch_io")


def _digits(v, pad: int = 0):
    """Non-negative integers → (their decimal digits, lengths), each at
    least `pad` digits (zero-padded), with integer arithmetic alone."""
    import numpy as np

    v = np.asarray(v, dtype=np.int64)
    width = max(len(str(int(v.max()))) if len(v) else 1, pad, 1)
    digits = (v[:, None] // 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)) % 10
    lens = np.maximum(np.floor(np.log10(np.maximum(v, 1))).astype(np.int64) + 1, pad)
    keep = np.arange(width) >= (width - lens)[:, None]
    return (digits[keep] + ord("0")).astype(np.uint8), lens


def _civil(days):
    """Days since 1970-01-01 → (year, month, day) arrays (the civil calendar)."""
    import numpy as np

    z = np.asarray(days, dtype=np.int64) + 719468
    era = np.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = np.where(mp < 10, mp + 3, mp - 9)
    return yoe + era * 400 + (m <= 2), m, d


def _text_rows(columns, lo: int, hi: int) -> bytes:
    """Rows [lo, hi) of lineitem_text's columns as text."""
    import numpy as np

    pieces = []  # per row, in order: (bytes, lengths) or a constant byte string
    for i, (kind, data) in enumerate(columns):
        if kind == "str":
            blob, offs = data
            pieces.append((blob[offs[lo]:offs[hi]], np.diff(offs[lo:hi + 1])))
        elif kind == "date":
            y, m, d = _civil(data[lo:hi])
            pieces += [_digits(y, 4), b"-", _digits(m, 2), b"-", _digits(d, 2)]
        elif kind == "money":  # DECIMAL(15,2) from cents (all >= 0 in lineitem)
            v = data[lo:hi]
            pieces += [_digits(v // 100), b".", _digits(v % 100, 2)]
        else:
            pieces.append(_digits(data[lo:hi]))
        pieces.append(b"|" if i < len(columns) - 1 else b"\n")
    n = hi - lo
    row = np.zeros(n, dtype=np.int64)
    for p in pieces:
        row += len(p) if isinstance(p, bytes) else p[1]
    pos = np.zeros(n, dtype=np.int64)
    np.cumsum(row[:-1], out=pos[1:])
    out = np.empty(int(row.sum()), dtype=np.uint8)
    for p in pieces:
        if isinstance(p, bytes):
            for k, b in enumerate(p):
                out[pos + k] = b
            pos += len(p)
            continue
        blob, lens = p
        first = np.zeros(n, dtype=np.int64)
        np.cumsum(lens[:-1], out=first[1:])
        out[np.repeat(pos - first, lens) + np.arange(len(blob))] = blob
        pos += lens
    return out.tobytes()


def lineitem_text(data_dir: str) -> bytes:
    """All 16 lineitem columns of the generated files as '|'-delimited text
    with no header (dbgen's layout without its trailing '|'), with numpy
    alone: each row's fields placed by their lengths, the rows in as many
    ranges as the host has cores, each on a thread (numpy lets go of the
    interpreter lock)."""
    import concurrent.futures

    import numpy as np

    from duckdb_tpu_torch.testing.tpch_gen import LINEITEM_COLUMNS

    t = os.path.join(data_dir, "lineitem")
    money = ("l_quantity", "l_extendedprice", "l_discount", "l_tax")
    columns = []
    for name, kind in LINEITEM_COLUMNS:
        base = os.path.join(t, name)
        if kind == "str":
            lens = np.fromfile(base + ".len", dtype=np.uint32).astype(np.int64)
            offs = np.zeros(len(lens) + 1, dtype=np.int64)
            np.cumsum(lens, out=offs[1:])
            columns.append(("str", (np.fromfile(base + ".bytes", dtype=np.uint8), offs)))
        elif kind == "date":
            columns.append(("date", np.fromfile(base + ".i32", dtype=np.int32)))
        else:
            v = np.fromfile(base + (".i64" if kind == "i64" else ".i32"),
                            dtype=np.int64 if kind == "i64" else np.int32).astype(np.int64)
            columns.append(("money" if name in money else "int", v))
    n = len(columns[0][1])
    cuts = np.linspace(0, n, (os.cpu_count() or 1) + 1).astype(np.int64)
    with concurrent.futures.ThreadPoolExecutor(len(cuts) - 1) as pool:
        parts = list(pool.map(lambda r: _text_rows(columns, int(r[0]), int(r[1])),
                              zip(cuts[:-1], cuts[1:])))
    return b"".join(parts)


def fixture_value(v):
    """An expected value of a fixture's JSON: {"decimal": text},
    {"date": iso}, {"timestamp": iso}, {"time": iso}, {"blob": hex},
    {"struct": {field: value}}, a list of such values, or a plain JSON
    value."""
    import datetime
    import decimal

    if isinstance(v, list):
        return [fixture_value(x) for x in v]
    if isinstance(v, dict):
        (kind, text), = v.items()
        if kind == "decimal":
            return decimal.Decimal(text)
        if kind == "date":
            return datetime.date.fromisoformat(text)
        if kind == "time":
            return datetime.time.fromisoformat(text)
        if kind == "blob":
            return bytes.fromhex(text)
        if kind == "struct":
            return {k: fixture_value(x) for k, x in text.items()}
        return datetime.datetime.fromisoformat(text)
    return v


def fixture_cases():
    """[(file, SQL over it, expected rows)] of the committed fixtures."""
    cases = []
    for name in sorted(os.listdir(FIXTURES)):
        if name.endswith(".expected.json"):
            with open(os.path.join(FIXTURES, name)) as f:
                want = json.load(f)
            path = os.path.join(FIXTURES, want["file"])
            reader = "read_parquet" if path.endswith(".parquet") else "read_json"
            cases.append((path, f"SELECT * FROM {reader}('{path}') ORDER BY {want['order_by']}",
                          [tuple(fixture_value(v) for v in r) for r in want["rows"]]))
    return cases


# phase 20 step 6's small table: a key, a default, an empty string, a
# sequence past its start and a macro, each asked for after IMPORT
SMALL_SETUP = ("CREATE TABLE small (id INTEGER PRIMARY KEY, s VARCHAR DEFAULT 'dflt')",
               "INSERT INTO small VALUES (1, ''), (2, 'two')",
               "CREATE SEQUENCE seq START WITH 5", "SELECT nextval('seq')",
               "CREATE MACRO plus1(x) AS x + 1")


def file_readers_phase(card, recording, recorded, launches_by_query, shapes, reps) -> str:
    """Phase 20 (see the module docstring). '' or a failure message."""
    import gc
    import shutil

    import torch

    import duckdb_tpu_torch
    from duckdb_tpu_torch.catalog.tpch import TPCH_SCHEMA
    from duckdb_tpu_torch.storage import csv as csvmod
    from duckdb_tpu_torch.storage import parquet as pqmod
    from duckdb_tpu_torch.testing import tpch_oracle

    kit = Steps(20, card, recording, recorded, launches_by_query, shapes, reps)
    shutil.rmtree(FILES_DIR, ignore_errors=True)
    os.makedirs(FILES_DIR)
    want = numpy_q1(DATA)
    nrows = len(lineitem_numpy(DATA)["l_orderkey"])

    def q1_step(label, name, con, source, want_rows, exact=True):
        sql = Q1.replace("FROM lineitem", f"FROM {source}")
        rows, line = kit.with_kernel(label, name, lambda: con.sql(sql).rows())
        if exact:
            bad = rows_match(rows, want_rows)
        else:  # DECIMAL sniffed as DOUBLE: sums within 1e-9 relative, counts exact
            bad = rows_match(rows, [tuple(float(v) if hasattr(v, "as_tuple") else v for v in r)
                                    for r in want_rows])
        if bad:
            return f"{label}: Q1 differs: {bad}", line
        return "", line + f"; {len(rows)} rows equal numpy's; grouped_sum_i64 launches " \
                          f"{launches_by_query[name]}"

    def disk(path):
        if os.path.isfile(path):
            return os.path.getsize(path)
        return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs)

    # 1. numpy writes lineitem as dbgen's text; CREATE TABLE; COPY FROM
    tbl = os.path.join(FILES_DIR, "lineitem.tbl")
    t0 = time.perf_counter()
    text = lineitem_text(DATA)
    with open(tbl, "wb") as f:
        f.write(text)
    print(f"phase 20 step 1: numpy wrote lineitem.tbl ({len(text)} bytes, {nrows} rows) in "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    del text
    con = duckdb_tpu_torch.connect()
    cols = ", ".join(f"{n} {t!r}" for n, t in TPCH_SCHEMA["lineitem"])
    con.sql(f"CREATE TABLE lineitem ({cols})")
    tokenizer = []
    real_load = csvmod.load_csv

    def timed_load(*args, **kwargs):
        t = time.perf_counter()
        try:
            return real_load(*args, **kwargs)
        finally:
            tokenizer.append(time.perf_counter() - t)

    csvmod.load_csv = timed_load
    try:
        got, line = kit.step("1 COPY lineitem FROM lineitem.tbl", lambda: con.sql(
            f"COPY lineitem FROM '{tbl}' (DELIMITER '|', HEADER false)").rows())
    finally:
        csvmod.load_csv = real_load
    wall = float(line.split(": ")[1].split(" ms")[0]) / 1e3
    if got != [(nrows,)]:
        return f"COPY FROM gave {got}, expected {nrows} rows"
    mb = os.path.getsize(tbl) / 1e6
    print(line + f"; Count {got[0][0]}; {mb / wall:.1f} MB/s; csv2col's read "
          f"{tokenizer[0] * 1e3:.3f} ms ({mb / tokenizer[0]:.1f} MB/s)")
    bad, line = q1_step("1 Q1 over the copied lineitem (first run)", "q01_copy_from", con,
                        "lineitem", want)
    if bad:
        return bad
    print(line)
    bad = kit.kernel_check("q01_copy_from")
    if bad or launches_by_query["q01_copy_from"] < 1:
        return bad or "Q1 over the copied lineitem did not launch the grouped sum"
    med, times = warm_median(con, Q1, want)
    if med is None:
        return f"Q1 over the copied lineitem: {times}"
    print(f"phase 20 Q1 over the copied lineitem on {card}: median of 5 warm runs "
          f"{med * 1e3:.3f} ms (runs {', '.join(f'{t * 1e3:.3f}' for t in times)} ms)")
    os.remove(tbl)

    # 2. COPY TO CSV with a header, then Q1 over read_csv_auto
    li_csv = os.path.join(FILES_DIR, "li.csv")
    _, line = kit.step("2 COPY lineitem TO li.csv (HEADER)",
                       lambda: con.sql(f"COPY lineitem TO '{li_csv}' (HEADER)"))
    print(line + f"; {os.path.getsize(li_csv)} bytes")
    _, sniffed_types = csvmod.sniff_csv(li_csv)[1:]
    expect = {"BIGINT": "INTEGER", "INTEGER": "INTEGER", "DATE": "DATE", "VARCHAR": "VARCHAR"}
    table_types = [str(t) for _, t in TPCH_SCHEMA["lineitem"]]
    want_sniffed = [expect.get(t, "DOUBLE" if t.startswith("DECIMAL") else t)
                    for t in table_types]
    if [str(t) for _, t in sniffed_types] != want_sniffed:
        return f"read_csv_auto sniffed {sniffed_types}, expected {want_sniffed}"
    print(f"phase 20 step 2: sniffed {[str(t) for _, t in sniffed_types]} for the table's "
          f"{table_types} (keys under 2^31 as INTEGER, DECIMAL as DOUBLE, as the JAX "
          "package sniffs)")
    bad, line = q1_step("2 Q1 over read_csv_auto('li.csv')", "q01_read_csv_auto", con,
                        f"read_csv_auto('{li_csv}')", want, exact=False)
    if bad:
        return bad
    print(line)
    bad = kit.kernel_check("q01_read_csv_auto")
    if bad:
        return bad
    os.remove(li_csv)

    # 3. COPY TO Parquet, then Q1 over read_parquet
    li_pq = os.path.join(FILES_DIR, "li.parquet")
    _, line = kit.step("3 COPY lineitem TO li.parquet (FORMAT PARQUET)",
                       lambda: con.sql(f"COPY lineitem TO '{li_pq}' (FORMAT PARQUET)"))
    entry = con.catalog.get_table("lineitem")
    raw = 0
    for cd in entry.columns:
        values, validity, dvals = entry.host_column(cd.name)
        raw += values.nbytes + (0 if validity is None else validity.nbytes)
        raw += 0 if dvals is None else sum(len(str(v).encode()) for v in dvals)
    print(line + f"; {disk(li_pq)} bytes on disk against {raw} raw bytes "
          f"({disk(li_pq) / raw:.3f}); {len(pqmod.ParquetFile(li_pq).row_groups)} row groups")
    decoded = []
    real_column = pqmod.load_column

    def counted(path, name, pf=None):
        decoded.append(name)
        return real_column(path, name, pf)

    pqmod.load_column = counted
    try:
        bad, line = q1_step("3 Q1 over read_parquet('li.parquet')", "q01_parquet", con,
                            f"read_parquet('{li_pq}')", want)
    finally:
        pqmod.load_column = real_column
    if bad:
        return bad
    print(line + f"; decoded {len(decoded)} of 16 columns: {sorted(decoded)}")
    if len(decoded) != 7:
        return f"Q1 over read_parquet decoded {sorted(decoded)}, not Q1's 7 columns"
    bad = kit.kernel_check("q01_parquet")
    if bad or launches_by_query["q01_parquet"] < 1:
        return bad or "Q1 over read_parquet did not launch the grouped sum"
    os.remove(li_pq)

    # 4. three hive partitions, the flag only in the path
    others = ", ".join(n for n, _ in TPCH_SCHEMA["lineitem"] if n != "l_returnflag")
    hive = os.path.join(FILES_DIR, "hive")

    def write_hive():
        for flag in ("A", "N", "R"):
            os.makedirs(os.path.join(hive, f"l_returnflag={flag}"))
            con.sql(f"COPY (SELECT {others} FROM lineitem WHERE l_returnflag = '{flag}') TO "
                    f"'{hive}/l_returnflag={flag}/part.parquet'")

    _, line = kit.step("4 three COPY (SELECT … WHERE l_returnflag = X) TO hive/…", write_hive)
    print(line + f"; {disk(hive)} bytes on disk")
    bad, line = q1_step("4 Q1 over the hive partitions", "q01_hive", con,
                        f"read_parquet('{hive}/*/*.parquet', hive_partitioning=true)", want)
    if bad:
        return bad
    print(line)
    bad = kit.kernel_check("q01_hive")
    if bad or launches_by_query["q01_hive"] < 1:
        return bad or "Q1 over the hive partitions did not launch the grouped sum"
    shutil.rmtree(hive)
    con.close()
    del con, entry
    gc.collect()

    # 5. the committed fixtures pyarrow wrote
    fx = duckdb_tpu_torch.connect()
    for path, sql, rows_want in fixture_cases():
        got, line = kit.step(f"5 {os.path.basename(path)}", lambda: fx.sql(sql).rows())
        bad = rows_match(got, rows_want)
        if bad:
            return f"fixture {path}: {bad}"
        print(line + f"; {len(got)} rows equal the expected rows")
    fx.close()

    # 6. the eight tables and a small one, EXPORT … (FORMAT PARQUET), IMPORT
    src = duckdb_tpu_torch.connect()
    src.load_tpch(DATA)
    for sql in SMALL_SETUP:
        src.sql(sql)
    exp = os.path.join(FILES_DIR, "exp")
    _, line = kit.step("6 EXPORT DATABASE (FORMAT PARQUET) of the 8 tables and small",
                       lambda: src.sql(f"EXPORT DATABASE '{exp}' (FORMAT PARQUET)"))
    print(line + f"; {disk(exp)} bytes on disk")
    src.close()
    del src
    gc.collect()
    dst = duckdb_tpu_torch.connect()
    _, line = kit.step("6 IMPORT DATABASE into a fresh connection",
                       lambda: dst.sql(f"IMPORT DATABASE '{exp}'"))
    print(line + f"; tables {sorted(n for n in dst.catalog.tables if not n.startswith('__'))}")
    bad, line = q1_step("6 Q1 over the imported lineitem", "q01_imported", dst, "lineitem",
                        want)
    if bad:
        return bad
    print(line)
    bad = kit.kernel_check("q01_imported")
    if bad or launches_by_query["q01_imported"] < 1:
        return bad or "Q1 over the imported lineitem did not launch the grouped sum"
    q3 = tpch_oracle.QUERIES["q03"]
    rows, line = kit.step("6 Q3 over the imported tables", lambda: dst.sql(q3).rows())
    bad = rows_match(rows, tpch_oracle.answer("q03", DATA))
    if bad:
        return f"Q3 over the imported tables differs from the numpy oracle: {bad}"
    print(line + f"; {len(rows)} rows equal the numpy oracle's")
    checks = []
    try:
        dst.sql("INSERT INTO small VALUES (1, 'dup')")
        return "a duplicate key in the imported small table did not raise"
    except Exception as err:  # noqa: BLE001 — the class is what is checked
        if type(err).__name__ != "ConstraintException":
            return f"the duplicate key raised {err!r}"
        checks.append("duplicate key raised ConstraintException")
    dst.sql("INSERT INTO small (id) VALUES (3)")
    got = dst.sql("SELECT id, s, s IS NULL FROM small ORDER BY id").rows()
    if got != [(1, "", False), (2, "two", False), (3, "dflt", False)]:
        return f"the imported small table holds {got}"
    checks.append("the DEFAULT applied and '' is not NULL")
    if dst.sql("SELECT nextval('seq'), plus1(41)").rows() != [(6, 42)]:
        return "nextval('seq') or plus1() did not answer as before the export"
    checks.append("nextval('seq') gave 6 and plus1(41) 42")
    print(f"phase 20 step 6 on {card}: {'; '.join(checks)}")
    dst.close()
    del dst
    recorded.clear()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(FILES_DIR, ignore_errors=True)
    return ""

def merge_alter_phase(card, recording, recorded, launches_by_query, shapes, reps) -> str:
    """Phase 21 (see the module docstring). '' or a failure message."""
    import datetime
    import decimal
    import gc

    import numpy as np
    import torch

    import duckdb_tpu_torch
    from duckdb_tpu_torch.catalog import catalog as C
    from duckdb_tpu_torch.errors import ConstraintException, InvalidInputException

    con = duckdb_tpu_torch.connect()
    con.load_tpch(DATA, tables=["lineitem"])
    con.sql("SET num_shards = 1")
    base = lineitem_numpy(DATA)
    kit = Steps(21, card, recording, recorded, launches_by_query, shapes, reps)
    step, kernel_check, with_kernel = kit.step, kit.kernel_check, kit.with_kernel
    q1_li = Q1.replace("FROM lineitem", "FROM li")

    def count_of(res):
        return res.rows()[0][0]

    def q1_step(label, name, sql, want):
        rows, line = with_kernel(label, name, lambda: con.sql(sql).rows())
        bad = rows_match(rows, want)
        if bad:
            return None, f"{label}: Q1 differs from numpy: {bad}"
        if launches_by_query[name] < 1:
            return None, f"{label}: Q1 did not launch the grouped sum"
        print(line + f"; {len(rows)} rows equal numpy's exactly; grouped_sum_i64 launches "
              f"{launches_by_query[name]}")
        return rows, kernel_check(name)

    # 1. the target and the staging table
    _, line = step("1 CREATE TABLE li, stg AS SELECT", lambda: con.sql(
        "CREATE TABLE li AS SELECT * FROM lineitem; "
        "CREATE TABLE stg AS SELECT * FROM lineitem WHERE l_orderkey % 50 = 0"))
    stg = {k: v[base["l_orderkey"] % 50 == 0] for k, v in base.items()}
    moved, line2 = step("1 UPDATE stg", lambda: count_of(con.sql(
        "UPDATE stg SET l_orderkey = l_orderkey + 6000000 WHERE l_orderkey % 100 = 50")))
    away = stg["l_orderkey"] % 100 == 50
    stg["l_orderkey"] = np.where(away, stg["l_orderkey"] + 6000000, stg["l_orderkey"])
    n_li, n_stg = (con.catalog.get_table(t).nrows for t in ("li", "stg"))
    if (n_li, n_stg, moved) != (len(base["l_orderkey"]), len(stg["l_orderkey"]),
                                int(away.sum())):
        return f"li {n_li}, stg {n_stg} rows and {moved} moved keys differ from numpy"
    print(line + f"; li {n_li} rows, stg {n_stg} rows, equal numpy's")
    print(line2 + f"; Count {moved} equals numpy's")
    # 2. MERGE, then Q1 through the kernel
    got, line = step("2 MERGE", lambda: count_of(con.sql(MERGE_LI)))
    merged = merge_numpy(base, stg)
    li = merged["cols"]
    if got != merged["count"] or con.catalog.get_table("li").nrows != len(li["l_orderkey"]):
        return f"MERGE counted {got}, numpy {merged['count']}"
    print(line + f"; Count {got} equals numpy's ({merged['deleted']} deleted, "
          f"{merged['updated']} updated, {merged['inserted']} inserted)")
    rows2, bad = q1_step("2 Q1 over li after MERGE", "q01_merge", q1_li, numpy_q1_of(li))
    if bad:
        return bad
    # 3. a source row twice: the MERGE raises and changes nothing (M1)
    con.sql("BEGIN")
    con.sql("INSERT INTO stg SELECT * FROM stg LIMIT 1")

    def refused():
        try:
            con.sql(MERGE_LI)
        except InvalidInputException as err:
            return err
        return None

    err, line = step("3 MERGE with a source key twice", refused)
    con.sql("ROLLBACK")
    if err is None:
        return "a MERGE whose source holds a key twice did not raise"
    if con.sql(q1_li).rows() != rows2:
        return "Q1 over li changed after the refused MERGE"
    print(line + f"; raised InvalidInputException ({err}); Q1 over li unchanged")
    # 4. ALTER: add, rename, retype, drop; the pool lets l_comment's bytes go
    con.catalog.get_table("li").device_column("l_comment")
    for sql in ALTERS:
        used = C.POOL.used
        _, line = step(f"4 {sql}", lambda: con.sql(sql))
        dropped = "DROP COLUMN" in sql
        print(line + (f"; pool {used} bytes before, {C.POOL.used} after" if dropped else ""))
        if dropped and C.POOL.used >= used:
            return f"the pool kept l_comment's bytes after the DROP ({used} -> {C.POOL.used})"
    entry = con.catalog.get_table("li")
    if repr(entry.col_types["l_linenumber"]) != "BIGINT" or "l_comment" in entry.col_types \
            or not np.array_equal(entry.host_column("l_linenumber")[0], li["l_linenumber"]):
        return "the ALTERs did not leave li as numpy says"
    if count_of(con.sql("SELECT count(*) FROM li WHERE l_batch = 7")) != entry.nrows:
        return "ADD COLUMN … DEFAULT 7 did not fill every row"
    rows4, bad = q1_step("4 Q1 (l_qty) after the ALTERs", "q01_alter", Q1_ALTERED,
                         numpy_q1_of(li))
    if bad:
        return bad
    # 5. a rolled-back DROP COLUMN and MERGE
    con.sql("BEGIN")
    _, line = step("5 DROP COLUMN l_tax in a transaction",
                   lambda: con.sql("ALTER TABLE li DROP COLUMN l_tax"))
    print(line)
    got, line = step("5 MERGE in the transaction", lambda: count_of(con.sql(
        "MERGE INTO li USING stg ON li.l_orderkey = stg.l_orderkey AND "
        "li.l_linenumber = stg.l_linenumber WHEN MATCHED THEN UPDATE SET l_qty = l_qty + 1")))
    con.sql("ROLLBACK")
    # stg matches the rows step 2 updated and those it inserted
    matched = merged["updated"] + merged["inserted"]
    if got != matched:
        return f"the MERGE in the transaction counted {got}, numpy {matched}"
    print(line + f"; Count {got} equals numpy's")
    rows5, bad = q1_step("5 Q1 after ROLLBACK", "q01_rollback", Q1_ALTERED, numpy_q1_of(li))
    if bad:
        return bad
    if rows5 != rows4 or "l_tax" not in con.catalog.get_table("li").col_types:
        return "the ROLLBACK did not bring li back"
    print("phase 21 step 5: Q1 equals step 4's; l_tax is back")
    # 6. PIVOT, then UNPIVOT of the same table made by CTAS
    flags = sorted(set(li["l_returnflag"].tolist()))
    stati = sorted(set(li["l_linestatus"].tolist()))

    def qty(r, s):
        m = (li["l_returnflag"] == r) & (li["l_linestatus"] == s)
        return decimal.Decimal(int(li["l_quantity"][m].sum())).scaleb(-2) if m.any() else None

    want6 = [(s.decode(),) + tuple(qty(r, s) for r in flags) for s in stati]
    res6, line = with_kernel("6 PIVOT li ON l_returnflag", "pivot_li", lambda: con.sql(
        "PIVOT li ON l_returnflag USING sum(l_qty) GROUP BY l_linestatus"))
    if res6.names != ["l_linestatus"] + [r.decode() for r in flags] or res6.rows() != want6:
        return f"PIVOT gave {res6.names} {res6.rows()}, numpy {want6}"
    shapes6 = sorted({(d.shape[0], len(v), n) for d, v, n in recorded})
    print(line + f"; {len(want6)} rows equal numpy's; the FILTERed sums "
          + (f"reached grouped_sum_i64 ({launches_by_query['pivot_li']} launches at "
             f"N, K, nseg {shapes6})" if launches_by_query["pivot_li"]
             else "did not reach grouped_sum_i64"))
    if launches_by_query["pivot_li"]:
        bad = kernel_check("pivot_li")
        if bad:
            return bad
    cols6 = ", ".join(f"sum(l_qty) FILTER (WHERE l_returnflag = '{r.decode()}') AS "
                      f"\"{r.decode()}\"" for r in flags)
    con.sql(f"CREATE TABLE pv AS SELECT l_linestatus, {cols6} FROM li GROUP BY l_linestatus")
    if sorted(con.sql("SELECT * FROM pv").rows()) != want6:
        return "the PIVOT's table made by CTAS differs from the PIVOT"
    on = ", ".join(f'"{r.decode()}"' for r in flags)
    res, line = step("6 UNPIVOT pv", lambda: con.sql(
        f"UNPIVOT pv ON {on} INTO NAME rf VALUE qty"))
    want = sorted((s.decode(), r.decode(), qty(r, s)) for s in stati for r in flags
                  if qty(r, s) is not None)
    if sorted(res.rows()) != want:
        return f"UNPIVOT gave {sorted(res.rows())}, numpy {want}"
    print(line + f"; {len(want)} rows equal numpy's")
    # 7. the appender: 200,000 Python tuples into a table with a key
    con.sql("CREATE TABLE ap (k BIGINT PRIMARY KEY, v VARCHAR, d DATE, x DECIMAL(12,2))")
    day0 = datetime.date(1992, 1, 1)
    tuples = [(i, f"v{i % 1000}", day0 + datetime.timedelta(days=i % 2500),
               decimal.Decimal(i % 100000).scaleb(-2)) for i in range(200_000)]

    def append():
        with con.appender("ap") as app:
            app.append_rows(tuples)

    t0 = time.perf_counter()
    _, line = step("7 appender of 200,000 rows", append)
    secs = time.perf_counter() - t0
    have = con.sql("SELECT count(*), sum(k), count(DISTINCT v), min(d), max(d), sum(x) "
                   "FROM ap").rows()[0]
    want7 = (200_000, sum(range(200_000)), 1000, day0, day0 + datetime.timedelta(days=2499),
             sum(t[3] for t in tuples))
    if have != want7:
        return f"the appended table holds {have}, Python {want7}"
    print(line + f"; {200_000 / secs:.0f} rows/s; count, sums, distinct and range equal "
          "Python's")
    try:
        with con.appender("ap") as app:
            app.append_row(7, "dup", day0, decimal.Decimal(1))
        return "an appended duplicate key did not raise"
    except ConstraintException as err:
        print(f"phase 21 step 7: an appended duplicate key raised ConstraintException ({err})")
    if con.sql("SELECT count(*) FROM ap").rows() != [(200_000,)]:
        return "the refused append changed ap"
    print("phase 21 step 7: ap keeps its 200,000 rows")
    con.close()
    del con, entry
    recorded.clear()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return ""

# phase 22: the settings step's SET values (read back by current_setting,
# then RESET), the temp directory of its out-of-core select, and the file
# database the CLI and the C API read
PHASE22_TMP = os.path.join(ROOT, "build", "phase22_tmp")
PHASE22_DB = os.path.join(ROOT, "build", "phase22_db")
PHASE22_SETS = (("temp_directory", PHASE22_TMP), ("join_order", "greedy"),
                ("default_null_order", "nulls_first"))
PHASE22_DEFAULTS = {"temp_directory": "", "join_order": "dp", "default_null_order": "nulls_last"}


def text_rows_match(got, want) -> str:
    """rows_match for rows of text (the CLI's CSV, the C API's
    duckdb_value_varchar), each cell read as the type of want's cell."""
    import decimal

    def typed(text, w):
        if isinstance(w, float):
            return float(text)
        if isinstance(w, decimal.Decimal):
            return decimal.Decimal(text)
        if isinstance(w, int):
            return int(text)
        return text

    if len(got) != len(want):
        return f"{len(got)} rows, expected {len(want)}"
    return rows_match([tuple(typed(t, w) for t, w in zip(g, wr)) for g, wr in zip(got, want)],
                      want)


def main_clients_phase(con, card, recording, recorded, launches_by_query, shapes, reps) -> str:
    """Phase 22 (see the module docstring). '' or a failure message."""
    import ctypes
    import csv
    import decimal
    import shutil

    import duckdb_tpu_torch
    import duckdb_tpu_torch.capi

    kit = Steps(22, card, recording, recorded, launches_by_query, shapes, reps)
    want_q1 = numpy_q1(DATA)

    # 1. SET, current_setting and RESET of three settings; duckdb_settings()
    def settings_step():
        got = {}
        for name, value in PHASE22_SETS:
            con.sql(f"SET {name} = '{value}'")
            got[name] = con.sql(f"SELECT current_setting('{name}')").rows()[0][0]
        n = con.sql("SELECT count(*) FROM duckdb_settings()").rows()[0][0]
        for name, _ in PHASE22_SETS:
            con.sql(f"RESET {name}")
        back = {name: con.sql(f"SELECT current_setting('{name}')").rows()[0][0]
                for name, _ in PHASE22_SETS}
        return got, n, back

    (got, n, back), line = kit.step("1 SET, current_setting, RESET", settings_step)
    if got != dict(PHASE22_SETS) or back != PHASE22_DEFAULTS:
        return f"current_setting read {got} after SET and {back} after RESET"
    if n != 187:
        return f"duckdb_settings() has {n} rows, not 187"
    print(line + f"; read back {got}, after RESET {back}; duckdb_settings() has {n} rows")

    # 2. EXPLAIN ANALYZE of Q1: the profile, and Q1's rows through the kernel
    res, line = kit.with_kernel("2 EXPLAIN ANALYZE Q1", "explain_analyze_q1",
                                lambda: con.sql("EXPLAIN ANALYZE " + Q1))
    prof = con.last_profile
    bad = rows_match(prof.result.rows(), want_q1)
    if bad:
        return f"EXPLAIN ANALYZE's Q1 differs from numpy: {bad}"
    if launches_by_query["explain_analyze_q1"] < 1:
        return "EXPLAIN ANALYZE of Q1 did not launch the grouped sum"
    if res.names != ["explain_value"] or res.rows() != [(prof.render(),)]:
        return "EXPLAIN ANALYZE did not return the profile's text"
    ops = ", ".join(f"{op.name} {op.cardinality} rows {op.time_s * 1e3:.3f} ms"
                    for op in prof.root.walk())
    print(line + f"; the profile's total {prof.total_s * 1e3:.3f} ms (planning "
          f"{prof.phases['planning'] * 1e3:.3f} ms, execution "
          f"{prof.phases['execution'] * 1e3:.3f} ms); operators: {ops}; "
          f"{len(prof.result.rows())} rows equal numpy's; grouped_sum_i64 launches "
          f"{launches_by_query['explain_analyze_q1']}")
    bad = kit.kernel_check("explain_analyze_q1")
    if bad:
        return bad

    # 3. duckdb_logs(): Q1's QueryLog line; phase 16's select under OOC_LIMIT
    # with temp_directory set logs its out_of_core lines
    _, line = kit.step("3 Q1", lambda: con.sql(Q1).rows())
    n_query = con.sql("SELECT count(*) FROM duckdb_logs() WHERE type = 'QueryLog' "
                      "AND message LIKE 'query returned 4 rows%'").rows()[0][0]
    if n_query < 1:
        return "duckdb_logs() holds no QueryLog line of Q1's 4 rows"
    print(line + f"; duckdb_logs() holds {n_query} QueryLog lines of 4 rows")
    ooc_sql = "SELECT count(*) FROM duckdb_logs() WHERE type = 'out_of_core'"
    before = con.sql(ooc_sql).rows()[0][0]
    shutil.rmtree(PHASE22_TMP, ignore_errors=True)
    con.sql(f"SET temp_directory = '{PHASE22_TMP}'")
    con.sql(f"SET memory_limit = '{OOC_LIMIT}'")
    con.routes.clear()
    try:
        rows, line = kit.step("3 OOC_SELECT under OOC_LIMIT",
                              lambda: con.sql(OOC_SELECT).rows())
    finally:
        con.sql("RESET memory_limit")
        con.sql("RESET temp_directory")
    ok, ln, price = numpy_ooc_select(DATA, limit=100)
    bad = rows_match(rows, [(int(a), int(b), decimal.Decimal(int(c)).scaleb(-2))
                            for a, b, c in zip(ok, ln, price)])
    if bad:
        return f"OOC_SELECT under OOC_LIMIT differs from phase 16's numpy rows: {bad}"
    chunks = con.routes["out_of_core_chunks"]
    logged = con.sql(ooc_sql).rows()[0][0] - before
    if chunks < 4 or logged < 1:
        return f"OOC_SELECT ran in {chunks} chunks and logged {logged} out_of_core lines"
    if not os.path.isdir(PHASE22_TMP):
        return "the chunked select made no spill directory under temp_directory"
    lines = con.sql("SELECT message FROM duckdb_logs() WHERE type = 'out_of_core'").rows()
    print(line + f"; {len(rows)} rows equal phase 16's numpy rows; {chunks} chunks; spill "
          f"directory under {PHASE22_TMP}; {logged} out_of_core lines, the last: "
          f"{lines[-1][0]!r}")
    shutil.rmtree(PHASE22_TMP, ignore_errors=True)

    # 4. pallas_grouped_sum: 'off' keeps Q1's sums off the kernel; RESET
    con.sql("SET pallas_grouped_sum = 'off'")
    try:
        rows, line = kit.with_kernel("4 Q1 under pallas_grouped_sum = 'off'",
                                     "q1_grouped_sum_off", lambda: con.sql(Q1).rows())
    finally:
        con.sql("RESET pallas_grouped_sum")
    bad = rows_match(rows, want_q1)
    if bad or launches_by_query["q1_grouped_sum_off"]:
        return (f"Q1 under pallas_grouped_sum = 'off': {bad or 'rows equal'}, grouped_sum_i64 "
                f"launches {launches_by_query['q1_grouped_sum_off']}")
    print(line + "; rows equal numpy's; grouped_sum_i64 launches 0")
    rows, line = kit.with_kernel("4 Q1 after RESET pallas_grouped_sum", "q1_grouped_sum_reset",
                                 lambda: con.sql(Q1).rows())
    bad = rows_match(rows, want_q1)
    if bad or launches_by_query["q1_grouped_sum_reset"] < 1:
        return (f"Q1 after RESET pallas_grouped_sum: {bad or 'rows equal'}, grouped_sum_i64 "
                f"launches {launches_by_query['q1_grouped_sum_reset']}")
    print(line + f"; rows equal numpy's; grouped_sum_i64 launches "
          f"{launches_by_query['q1_grouped_sum_reset']}")
    bad = kit.kernel_check("q1_grouped_sum_reset")
    if bad:
        return bad

    # 5. the CLI in a subprocess on the card, over lineitem in a file database
    shutil.rmtree(PHASE22_DB, ignore_errors=True)

    def write_db():
        w = duckdb_tpu_torch.connect(PHASE22_DB)
        w.load_tpch(DATA, tables=["lineitem"])
        w.sql("CHECKPOINT")
        w.close()

    _, line = kit.step("5 lineitem at SF1 into a file database", write_db)
    print(line)
    cmd = [sys.executable, "-m", "duckdb_tpu_torch.cli", PHASE22_DB, "-csv", "-c",
           " ".join(Q1.split()) + ";"]
    out, line = kit.step("5 the CLI's Q1 in a subprocess", lambda: subprocess.run(
        cmd, capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT}))
    if out.returncode != 0:
        return f"the CLI exited {out.returncode}: {out.stderr[-2000:]}"
    table = list(csv.reader(out.stdout.splitlines()))
    bad = text_rows_match(table[1:], want_q1)
    if bad or table[0][:2] != ["l_returnflag", "l_linestatus"]:
        return f"the CLI's Q1 differs from numpy: {bad or table[0]}"
    print(line + f"; {len(table) - 1} CSV rows equal numpy's")

    # 6. the C API in this process: duckdb_open of the same database, Q1
    lib = duckdb_tpu_torch.capi.library()
    V, U = ctypes.c_void_p, ctypes.c_uint64

    class CResult(ctypes.Structure):
        _fields_ = [("internal_data", V)]

    lib.duckdb_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(V)]
    lib.duckdb_connect.argtypes = [V, ctypes.POINTER(V)]
    lib.duckdb_query.argtypes = [V, ctypes.c_char_p, V]
    lib.duckdb_result_error.argtypes = [V]
    lib.duckdb_result_error.restype = ctypes.c_char_p
    for f in ("duckdb_column_count", "duckdb_row_count"):
        getattr(lib, f).argtypes, getattr(lib, f).restype = [V], U
    lib.duckdb_value_varchar.argtypes, lib.duckdb_value_varchar.restype = [V, U, U], V
    lib.duckdb_value_double.argtypes = [V, U, U]
    lib.duckdb_value_double.restype = ctypes.c_double
    lib.duckdb_column_type.argtypes, lib.duckdb_column_type.restype = [V, U], ctypes.c_int
    lib.duckdb_free.argtypes = [V]
    lib.duckdb_disconnect.argtypes = lib.duckdb_close.argtypes = [ctypes.POINTER(V)]
    lib.duckdb_library_version.restype = ctypes.c_char_p
    db, c = V(), V()
    if lib.duckdb_open(PHASE22_DB.encode(), ctypes.byref(db)) or \
            lib.duckdb_connect(db, ctypes.byref(c)):
        return "duckdb_open or duckdb_connect of the phase's database failed"

    def capi_q1():
        res = CResult()
        if lib.duckdb_query(c, Q1.encode(), ctypes.byref(res)):
            err = lib.duckdb_result_error(ctypes.byref(res))
            lib.duckdb_destroy_result(ctypes.byref(res))
            raise RuntimeError(f"duckdb_query of Q1 failed: {err}")
        out = []
        ncols = lib.duckdb_column_count(ctypes.byref(res))
        double = [lib.duckdb_column_type(ctypes.byref(res), k) == 11 for k in range(ncols)]
        for r in range(lib.duckdb_row_count(ctypes.byref(res))):
            row = []
            for k in range(ncols):
                if double[k]:  # DUCKDB_TYPE_DOUBLE: read as a double
                    row.append(repr(lib.duckdb_value_double(ctypes.byref(res), k, r)))
                    continue
                p = lib.duckdb_value_varchar(ctypes.byref(res), k, r)
                row.append(ctypes.cast(p, ctypes.c_char_p).value.decode())
                lib.duckdb_free(p)
            out.append(row)
        lib.duckdb_destroy_result(ctypes.byref(res))
        return out

    try:
        rows, line = kit.with_kernel("6 the C API's Q1", "capi_q1", capi_q1)
    finally:
        lib.duckdb_disconnect(ctypes.byref(c))
        lib.duckdb_close(ctypes.byref(db))
    bad = text_rows_match(rows, want_q1)
    if bad:
        return f"the C API's Q1 differs from numpy: {bad}"
    if launches_by_query["capi_q1"] < 1:
        return "the C API's Q1 did not launch the grouped sum"
    print(line + f"; {lib.duckdb_library_version().decode()}: {len(rows)} rows read with "
          f"duckdb_value_double and duckdb_value_varchar equal numpy's; grouped_sum_i64 launches "
          f"{launches_by_query['capi_q1']}")
    bad = kit.kernel_check("capi_q1")
    shutil.rmtree(PHASE22_DB, ignore_errors=True)
    recorded.clear()
    return bad


# phase 23: the fuzzer's seeds and sizes, card against CPU
def card_recording(GS, recorded):
    """A grouped-sum wrapper that keeps each launch's inputs on the card in
    `recorded` for launch_checker."""
    def recording(dense, vectors, nseg):
        if dense.is_cuda:
            recorded.append((dense, list(vectors), nseg))
        return GS.grouped_sum_i64(dense, vectors, nseg)
    return recording


def launch_checker(GS, recorded, timed, shapes, worst, label, reps):
    """What phases 23 and 27 run after each card statement: every
    grouped-sum launch recorded since (card_recording) is held to the plain
    version on its inputs, and each new shape is timed once under `label`;
    the launches of the check and of timing are not counted. → a callback
    giving '' or what failed; worst[0] keeps the largest error."""
    def after(*_):
        counted = GS.grouped_sum_i64.launches
        try:
            for dense, vecs, nseg in recorded:
                err = max_abs_err(GS.grouped_sum_i64(dense, vecs, nseg),
                                  GS.grouped_sum_i64_plain(dense, vecs, nseg))
                worst[0] = max(worst[0], err)
                if err:
                    return f"grouped_sum_i64 disagrees with its plain version (err {err})"
                shape = (dense.shape[0], len(vecs), nseg)
                if shape in timed:
                    continue
                timed.add(shape)
                k_ms, p_ms, l_ms, call = time_kernel(GS, dense, vecs, nseg, reps)
                b_ms, b_by, _, _ = bound_of(dense, vecs, nseg)
                shapes.append({"query": label, "n": shape[0], "k": shape[1],
                               "nseg": nseg, "max_abs_err": 0, "kernel_ms": k_ms,
                               "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                               "library_ms": l_ms, **call})
            return ""
        finally:
            recorded.clear()
            GS.grouped_sum_i64.launches = counted
    return after


FUZZ_SMALL = ((1, 400), (7, 400), (11, 400))  # (seed, queries) over SETUP's tables
FUZZ_BIG = ((1, 200),)  # over t1 of FUZZ_T1_ROWS and t2 of FUZZ_T2_ROWS rows
FUZZ_T1_ROWS, FUZZ_T2_ROWS = 1_000_000, 400_000


def fuzz_phase(card, launches_by_query, shapes, reps) -> str:
    """Phase 23: the grammar fuzzer (duckdb_tpu_torch/testing/fuzz.py) on a
    card connection against a CPU connection of the port. Step 1: SETUP's
    tables, FUZZ_SMALL's seeds; step 2: t1 and t2 by SETUP's formulas at
    FUZZ_T1_ROWS / FUZZ_T2_ROWS rows, FUZZ_BIG's seeds. No non-typed error
    on the card; where both answer, the same rows (fuzz.rows_differ); where
    one refuses, the other refuses with the same class. Every grouped-sum
    launch a card query makes is held to the plain version on its inputs
    right after the query's wall is taken (the launches made by that check
    and by timing are not counted), and each new shape is timed once. → ''
    or the failure."""
    import torch

    import duckdb_tpu_torch
    from duckdb_tpu_torch.ops import grouped as grouped_mod
    from duckdb_tpu_torch.ops import grouped_sum as GS
    from duckdb_tpu_torch.testing import fuzz as FZ

    phase_t0 = time.perf_counter()
    recorded, timed = [], set()
    worst = [0]
    recording = card_recording(GS, recorded)

    def check_launches(step):
        return launch_checker(GS, recorded, timed, shapes, worst, f"fuzz_{step}", reps)

    def run_step(step, setup, seeds):
        t0 = time.perf_counter()
        card_con = duckdb_tpu_torch.connect()
        cpu_con = duckdb_tpu_torch.connect(device="cpu")
        for stmt in setup:
            card_con.sql(stmt)
            cpu_con.sql(stmt)
        setup_s = time.perf_counter() - t0
        grouped_mod.grouped_sum_i64 = recording
        GS.grouped_sum_i64.launches = 0
        try:
            answered = refused = 0
            walls, problems = [], []
            for seed, n in seeds:
                a, r, p, w = FZ.card_against_cpu(n, seed, card_con, cpu_con,
                                                 after_card=check_launches(step))
                answered, refused = answered + a, refused + r
                walls += w
                problems += [(seed,) + x for x in p]
        finally:
            grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
        launches = launches_by_query[f"fuzz_{step}"] = GS.grouped_sum_i64.launches
        print(f"phase 23 step {step} on {card}: seeds {seeds}, {answered} answered and {refused} "
              f"refused by both, median query wall {statistics.median(walls) * 1e3:.3f} ms on the "
              f"card (max {max(walls) * 1e3:.3f} ms), {launches} grouped_sum_i64 launches, "
              f"tables made in {setup_s:.1f} s, step {time.perf_counter() - t0:.1f} s")
        if problems:
            seed, i, sql, what = problems[0]
            return (f"phase 23 step {step}: {len(problems)} problem(s); first: seed {seed} "
                    f"query {i}: {what}\n  {sql}")
        return ""

    bad = run_step("small", FZ.SETUP, FUZZ_SMALL)
    if bad:
        return bad
    bad = run_step("big", FZ.sized_setup(FUZZ_T1_ROWS, FUZZ_T2_ROWS), FUZZ_BIG)
    if bad:
        return bad
    total = launches_by_query["fuzz_small"] + launches_by_query["fuzz_big"]
    if total < 1:
        return "phase 23: the fuzz queries on the card never launched grouped_sum_i64"
    torch.cuda.synchronize()
    print(f"phase 23 on {card}: every grouped_sum_i64 launch ({total}) equals its plain version "
          f"(max abs err {worst[0]}); {len(timed)} shapes timed; phase "
          f"{time.perf_counter() - phase_t0:.1f} s")
    return ""


# phase 24: two processes on the card (gloo), or one card per rank (NCCL)
PHASE24_LOCAL = 2  # shards per rank
PHASE24_TOPN = 100
PHASE24_DIR = os.path.join(ROOT, "build", "phase24")
Q1_CUT_DAYS = 10471  # DATE '1998-09-02' as days since 1970-01-01


def _table_col(data_dir: str, table: str, name: str):
    import numpy as np

    t = os.path.join(data_dir, table)
    for ext, dt in ((".i64", np.int64), (".i32", np.int32)):
        if os.path.exists(os.path.join(t, name + ext)):
            return np.fromfile(os.path.join(t, name + ext), dtype=dt).astype(np.int64)
    raise FileNotFoundError(f"{table}.{name}")


def q1_inputs_numpy(cols: dict):
    """Q1's grouped-sum inputs from lineitem_numpy's columns: the six
    (returnflag, linestatus) pairs as slots 0-5 of 8, and the rows the
    shipdate cut keeps."""
    import numpy as np

    rf = np.searchsorted(np.array([b"A", b"N", b"R"]), cols["l_returnflag"])
    ls = np.searchsorted(np.array([b"F", b"O"]), cols["l_linestatus"])
    gid = (rf * 2 + ls).astype(np.int32)
    live = cols["l_shipdate"] <= Q1_CUT_DAYS
    return (cols["l_quantity"], cols["l_extendedprice"], cols["l_discount"], cols["l_tax"],
            gid, live)


def numpy_q1_sums(cols: dict):
    """The six per-slot sums of q1_local_partial over all of lineitem."""
    import numpy as np

    qty, price, disc, tax, gid, live = q1_inputs_numpy(cols)
    omd = price * (100 - disc)
    vals = (qty, price, omd, omd * (100 + tax), disc, np.ones_like(qty))
    return np.array([[int(v[live & (gid == g)].sum()) for g in range(8)] for v in vals],
                    dtype=np.int64)


def phase24_rank(rank, world, backend, local, port, data_dir, out_dir, device_type="cuda"):
    """One rank of phase 24 (a torch.multiprocessing.spawn target): joins the
    process group, reads its half of lineitem and of orders with numpy, and
    runs Q1's partial through the kernel, the exchange join, the
    duplicate-key join, the sharded sort and a TopN over the ProcessMesh,
    checking what it can on its own. Writes out_dir/rank<r>.json (and the
    sort's and the TopN's row ids as .npy) for the parent to check."""
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from duckdb_tpu_torch.ops import grouped_sum as GS
    from duckdb_tpu_torch.ops import sort as S
    from duckdb_tpu_torch.parallel import shard as TS

    torch.set_num_threads(1)
    if device_type == "cuda":
        device = torch.device("cuda", rank if backend == "nccl" else 0)
    else:
        device = torch.device("cpu")
    mesh = TS.init_process_mesh(backend, local, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank, device=device)
    if device.type == "cuda":
        GS.build()
    li = lineitem_numpy(data_dir)
    o_key = _table_col(data_dir, "orders", "o_orderkey")
    n, n_o = len(li["l_orderkey"]), len(o_key)
    lo, hi = rank * n // world, (rank + 1) * n // world
    o_lo, o_hi = rank * n_o // world, (rank + 1) * n_o // world

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    steps = {}

    def step(name, fn):
        sync()
        before = dict(TS.COPIED)
        t0 = time.perf_counter()
        value = fn()
        sync()
        steps[name] = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                       "sent_bytes": TS.COPIED["sent"] - before["sent"],
                       "staged_bytes": TS.COPIED["staged"] - before["staged"]}
        return value

    out = {"rank": rank, "world": world, "backend": backend, "device": str(device),
           "mesh": repr(mesh), "rows": hi - lo}
    # 1. Q1's partial through the kernel on each of this rank's shards, then all_reduce
    q1_in = [on(x[lo:hi]) for x in q1_inputs_numpy(li)]
    partial, recorded = TS.q1_local_partial, []

    def recording(*args):
        out = partial(*args)
        recorded.append((args, out))
        return out

    TS.q1_local_partial = recording
    GS.grouped_sum_i64.launches = 0
    try:
        sums = step("q1_partial", lambda: TS.make_sharded_q1(mesh, 8)(*q1_in))
    finally:
        TS.q1_local_partial = partial
    launches = GS.grouped_sum_i64.launches
    # each launch's result held to the plain version on the same inputs
    err = max((max_abs_err(out, GS.grouped_sum_i64_plain(*TS.q1_partial_inputs(*args), args[-1]))
               for args, out in recorded), default=0)
    if device.type == "cuda" and recorded:  # the first shard's shape, timed once
        dense, vecs = TS.q1_partial_inputs(*recorded[0][0])
        k_ms, p_ms, l_ms, call = time_kernel(GS, dense, vecs, 8, 20)
        b_ms, b_by, _, _ = bound_of(dense, vecs, 8)
        out["kernel_shape"] = {"n": dense.shape[0], "k": len(vecs), "nseg": 8, "kernel_ms": k_ms,
                               "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                               "bound_by": b_by, **call}
    sync()
    out["q1_sums"] = torch.stack(sums).cpu().tolist()
    # every rank's launches and error, read on each rank in one all_gather
    out["kernel_by_rank"] = TS.all_host_ints(mesh, [torch.tensor([launches, err], device=device)])
    if device.type == "cuda" and launches < 1:
        raise RuntimeError(f"rank {rank}: Q1's partial never launched grouped_sum_i64")
    # 2. the exchange join: lineitem's orderkey probes orders' (unique keys)
    rows, o_rows = torch.arange(lo, hi, device=device), torch.arange(o_lo, o_hi, device=device)
    ones = torch.ones(hi - lo, dtype=torch.bool, device=device)
    o_ones = torch.ones(o_hi - o_lo, dtype=torch.bool, device=device)
    pk = on(li["l_orderkey"][lo:hi])
    j = step("exchange_join", lambda: TS.make_exchange_join(mesh)(
        pk, ones, rows, on(o_key[o_lo:o_hi]), o_ones, o_rows))
    # held here: every probe row this rank's shards own (by the key's hash)
    # arrives once, with its order's row
    all_keys = on(li["l_orderkey"])
    owner = TS._hash_dest(all_keys, mesh.n)
    o_sorted, o_perm = torch.sort(on(o_key))
    pairs = 0
    for jl, (rp, br) in enumerate(zip(j.rp, j.br)):
        want_rp = torch.nonzero(owner == mesh.first + jl).reshape(-1)
        got_rp, order = torch.sort(rp)
        if not torch.equal(got_rp, want_rp):
            raise RuntimeError(f"rank {rank} shard {jl}: the exchange routed other probe rows")
        want_br = o_perm[torch.searchsorted(o_sorted, all_keys[got_rp])]
        if not torch.equal(br[order], want_br):
            raise RuntimeError(f"rank {rank} shard {jl}: a probe row met the wrong order")
        pairs += rp.numel()
    out["join_pairs"] = pairs
    # 3. lineitem against itself on l_orderkey (duplicate build keys)
    dj = step("dup_join", lambda: TS.make_exchange_join_dup(mesh)(pk, ones, rows, pk, ones, rows))
    out["dup_pairs"] = sum(x.numel() for x in dj.pr)
    for pr, br in zip(dj.pr, dj.br):
        if not torch.equal(all_keys[pr], all_keys[br]):
            raise RuntimeError(f"rank {rank}: a duplicate-key pair joins two orderkeys")
    del dj
    # 4. ORDER BY l_extendedprice, row id; 5. its TopN, DESC
    price = on(li["l_extendedprice"][lo:hi])
    keys = S.orderable_int64(price, None, False, False)[None]
    got = step("sort", lambda: TS.make_sharded_sort(mesh, 1)(keys, ones, rows))
    np.save(os.path.join(out_dir, f"sort_rank{rank}.npy"), torch.cat(got).cpu().numpy())
    dkeys = S.orderable_int64(price, None, True, False)[None]

    def topn():
        cand = TS.make_sharded_topn(mesh, PHASE24_TOPN, 1)(dkeys, ones, rows)
        return cand.rows[S.sort_permutation(list(cand.keys), cand.live)][:PHASE24_TOPN]

    np.save(os.path.join(out_dir, f"topn_rank{rank}.npy"), step("topn", topn).cpu().numpy())
    out["steps"] = steps
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def process_mesh_phase(card, launches_by_query, backend="gloo", world=2,
                       device_type="cuda", shapes=None) -> str:
    """Phase 24: `world` ranks started by spawn (CUDA is already initialized
    here), each with PHASE24_LOCAL shards: under gloo all on cuda:0, their
    collectives staged through the host; under NCCL one card each. Checks
    each rank's results (phase24_rank) against numpy: Q1's psum, the
    exchange join's pairs, the duplicate-key join's pair count, the sort's
    order and the TopN; every rank's grouped-sum launches held to the plain
    version (max abs err 0). → '' or the failure."""
    import shutil

    import numpy as np
    import torch.multiprocessing as mp

    t0 = time.perf_counter()
    shutil.rmtree(PHASE24_DIR, ignore_errors=True)
    os.makedirs(PHASE24_DIR)
    mp.spawn(phase24_rank, nprocs=world, join=True,
             args=(world, backend, PHASE24_LOCAL, _free_port(), DATA, PHASE24_DIR, device_type))
    spawn_s = time.perf_counter() - t0
    ranks = []
    for r in range(world):
        with open(os.path.join(PHASE24_DIR, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    li = lineitem_numpy(DATA)
    want_q1 = numpy_q1_sums(li)
    if not all(np.array_equal(np.array(x["q1_sums"]), want_q1) for x in ranks):
        return "phase 24: Q1's all_reduced partial sums differ from numpy"
    by_rank = ranks[0]["kernel_by_rank"]
    for r, (launches, err) in enumerate(by_rank):
        launches_by_query[f"q1_partial_phase24_rank{r}"] = launches
        if err:
            return f"phase 24: rank {r}'s grouped_sum_i64 disagrees with its plain version"
        if device_type == "cuda" and launches < 1:
            return f"phase 24: rank {r} never launched grouped_sum_i64"
    n = len(li["l_orderkey"])
    if sum(x["join_pairs"] for x in ranks) != n:
        return "phase 24: the exchange join's pairs do not cover lineitem"
    _, counts = np.unique(li["l_orderkey"], return_counts=True)
    if sum(x["dup_pairs"] for x in ranks) != int((counts.astype(np.int64) ** 2).sum()):
        return "phase 24: the duplicate-key join's pair count differs from numpy's"
    price = li["l_extendedprice"]
    got = np.concatenate([np.load(os.path.join(PHASE24_DIR, f"sort_rank{r}.npy"))
                          for r in range(world)])
    if not np.array_equal(got, np.argsort(price, kind="stable")):
        return "phase 24: the sharded sort's order differs from numpy's stable argsort"
    want_top = np.lexsort((np.arange(n), -price))[:PHASE24_TOPN]
    for r in range(world):
        if not np.array_equal(np.load(os.path.join(PHASE24_DIR, f"topn_rank{r}.npy")), want_top):
            return f"phase 24: rank {r}'s TopN differs from numpy's"
    for x in ranks:
        if "kernel_shape" in x:
            r = x["kernel_shape"]
            if shapes is not None:
                shapes.append({"query": f"q1_partial_phase24_rank{x['rank']}", "max_abs_err": 0,
                               **r})
            print(f"grouped_sum_i64 at rank {x['rank']}'s Q1 shard shape N={r['n']} K={r['k']} "
                  f"nseg={r['nseg']} on {card}: max abs err 0, kernel {r['kernel_ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, index_add_ {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms by {r['bound_by']}")
    for name in ranks[0]["steps"]:
        walls = [x["steps"][name]["wall_ms"] for x in ranks]
        sent = sum(x["steps"][name]["sent_bytes"] for x in ranks)
        staged = sum(x["steps"][name]["staged_bytes"] for x in ranks)
        print(f"phase 24 step {name} ({backend}, {world} ranks x {PHASE24_LOCAL} shards) on "
              f"{card}: wall {max(walls):.3f} ms (slowest rank), {sent} bytes sent between "
              f"ranks, {staged} bytes staged through the host")
    print(f"phase 24 on {card}: backend {backend}, {[x['mesh'] for x in ranks]}; grouped_sum_i64 "
          f"launches by rank {[a for a, _ in by_rank]}, max abs err "
          f"{max(e for _, e in by_rank)}; Q1, the join pairs ({n}), the duplicate-key pairs, "
          f"the sort and the TopN of {PHASE24_TOPN} equal numpy's; ranks ran in {spawn_s:.1f} s, "
          f"phase {time.perf_counter() - t0:.1f} s")
    return ""


# phase 25: the faults' forms, Arrow through the C stream interface, the
# nested and TIME Parquet columns, and the configuration matrix
PHASE25_DIR = os.path.join(ROOT, "build", "phase25")
ARROW_BATCH_ROWS = 1_000_000
MATRIX_SF, MATRIX_SEED = 0.01, 7
MATRIX_DATA = os.path.join(ROOT, "data", f"tpch_gen_sf{MATRIX_SF:g}_seed{MATRIX_SEED}")
# tests/test_config_matrix.py's fifteen configurations, copied (the card's
# machine has another tests package) and held equal by
# tests/test_torch_config_matrix.py
MATRIX_CONFIGS = {
    "chunked": ["SET memory_limit = '64MB'"],
    "sharded": ["SET num_shards = 8"],
    "greedy_join": ["SET join_order = 'greedy'"],
    "pallas_off": ["SET pallas_grouped_sum = 'off'"],
    "shard_everything": ["SET num_shards = 8", "SET auto_shard_rows = 1"],
    "exchange_join_forced": ["SET num_shards = 8", "SET exchange_join_threshold = 0"],
    "spill_4mb": ["SET memory_limit = '4MB'"],
    "spill_sharded": ["SET memory_limit = '32MB'", "SET num_shards = 8"],
    "greedy_spill": ["SET join_order = 'greedy'", "SET memory_limit = '64MB'"],
    "threads_1": ["SET threads = 1"],
    "shard2_tiny": ["SET num_shards = 2", "SET auto_shard_rows = 1"],
    "exchange_spill": ["SET num_shards = 8", "SET exchange_join_threshold = 0",
                       "SET memory_limit = '64MB'"],
    "pallas_off_sharded": ["SET pallas_grouped_sum = 'off'", "SET num_shards = 8"],
    "spill_2mb": ["SET memory_limit = '2MB'"],
    "greedy_sharded": ["SET join_order = 'greedy'", "SET num_shards = 8"],
}
MATRIX_QUERIES = ("q01", "q03", "q05", "q06", "q10", "q12", "q14")
MATRIX_RESETS = ("memory_limit", "num_shards", "auto_shard_rows", "exchange_join_threshold",
                 "pallas_grouped_sum", "threads", "join_order")


def capi_faults(lib) -> str:
    """C1-C5 through the C API library on this machine: '' or what failed."""
    import ctypes

    V, U = ctypes.c_void_p, ctypes.c_uint64

    class CResult(ctypes.Structure):
        _fields_ = [("internal_data", V)]

    class Hugeint(ctypes.Structure):
        _fields_ = [("lower", ctypes.c_uint64), ("upper", ctypes.c_int64)]

    for name, args, res in (
            ("duckdb_create_config", [ctypes.POINTER(V)], ctypes.c_int),
            ("duckdb_set_config", [V, ctypes.c_char_p, ctypes.c_char_p], ctypes.c_int),
            ("duckdb_destroy_config", [ctypes.POINTER(V)], None),
            ("duckdb_open_ext", [ctypes.c_char_p, ctypes.POINTER(V), V,
                                 ctypes.POINTER(ctypes.c_char_p)], ctypes.c_int),
            ("duckdb_connect", [V, ctypes.POINTER(V)], ctypes.c_int),
            ("duckdb_disconnect", [ctypes.POINTER(V)], None),
            ("duckdb_close", [ctypes.POINTER(V)], None),
            ("duckdb_query", [V, ctypes.c_char_p, V], ctypes.c_int),
            ("duckdb_destroy_result", [V], None),
            ("duckdb_value_int64", [V, U, U], ctypes.c_int64),
            ("duckdb_create_uint64", [ctypes.c_uint64], V),
            ("duckdb_create_hugeint", [Hugeint], V),
            ("duckdb_destroy_value", [ctypes.POINTER(V)], None),
            ("duckdb_get_varchar", [V], V),
            ("duckdb_free", [V], None),
            ("duckdb_appender_create", [V, ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(V)],
             ctypes.c_int),
            ("duckdb_append_value", [V, V], ctypes.c_int),
            ("duckdb_appender_end_row", [V], ctypes.c_int),
            ("duckdb_appender_destroy", [ctypes.POINTER(V)], ctypes.c_int),
            ("duckdb_column_logical_type", [V, U], V),
            ("duckdb_decimal_width", [V], ctypes.c_uint8),
            ("duckdb_destroy_logical_type", [ctypes.POINTER(V)], None),
            ("duckdb_result_get_chunk", [CResult, U], V),
            ("duckdb_data_chunk_get_vector", [V, U], V),
            ("duckdb_destroy_data_chunk", [ctypes.POINTER(V)], None),
            ("duckdb_tpu_torch_live_vectors", [], ctypes.c_long)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res

    def open_with(pairs):
        cfg, db, err = V(), V(), ctypes.c_char_p()
        lib.duckdb_create_config(ctypes.byref(cfg))
        for k, v in pairs:
            lib.duckdb_set_config(cfg, k.encode(), v.encode())
        rc = lib.duckdb_open_ext(b":memory:", ctypes.byref(db), cfg, ctypes.byref(err))
        lib.duckdb_destroy_config(ctypes.byref(cfg))
        return rc, db, err

    # C5: a bad option fails the open and says why
    rc, db, err = open_with([("join_order", "sideways")])
    if rc == 0 or not err.value or b"join_order" not in err.value:
        return f"C5: duckdb_open_ext took a bad option (rc {rc}, error {err.value!r})"
    lib.duckdb_free(err)
    rc, db, err = open_with([("join_order", "greedy")])
    con = V()
    if rc or lib.duckdb_connect(db, ctypes.byref(con)):
        return f"C5: duckdb_open_ext of a good option failed ({err.value!r})"
    res = CResult()
    try:
        def query(sql):
            if lib.duckdb_query(con, sql.encode(), ctypes.byref(res)):
                raise RuntimeError(f"duckdb_query failed: {sql}")

        # C1: a UBIGINT value appends itself
        query("CREATE TABLE u (x BIGINT)")
        lib.duckdb_destroy_result(ctypes.byref(res))
        app = V()
        lib.duckdb_appender_create(con, None, b"u", ctypes.byref(app))
        v = V(lib.duckdb_create_uint64(123_456_789_012))
        lib.duckdb_append_value(app, v)
        lib.duckdb_destroy_value(ctypes.byref(v))
        lib.duckdb_appender_end_row(app)
        lib.duckdb_appender_destroy(ctypes.byref(app))
        query("SELECT x FROM u")
        got = lib.duckdb_value_int64(ctypes.byref(res), 0, 0)
        lib.duckdb_destroy_result(ctypes.byref(res))
        if got != 123_456_789_012:
            return f"C1: an appended UBIGINT value reads {got}"
        # C3: a DECIMAL column's own width; C2: a chunk owns its vectors
        query("SELECT CAST(12.5 AS DECIMAL(10,2)) AS d, range AS r FROM range(3000)")
        t = V(lib.duckdb_column_logical_type(ctypes.byref(res), 0))
        width = lib.duckdb_decimal_width(t)
        lib.duckdb_destroy_logical_type(ctypes.byref(t))
        base = lib.duckdb_tpu_torch_live_vectors()
        chunk = lib.duckdb_result_get_chunk(res, 0)
        first = lib.duckdb_data_chunk_get_vector(chunk, 1)
        same = all(lib.duckdb_data_chunk_get_vector(chunk, 1) == first for _ in range(10_000))
        alive = lib.duckdb_tpu_torch_live_vectors() - base
        lib.duckdb_destroy_data_chunk(ctypes.byref(V(chunk)))
        after = lib.duckdb_tpu_torch_live_vectors() - base
        lib.duckdb_destroy_result(ctypes.byref(res))
        if width != 10:
            return f"C3: DECIMAL(10,2) reports width {width}"
        if not same or alive != 1 or after != 0:
            return f"C2: vectors of a chunk: same {same}, alive {alive}, after its destroy {after}"
    finally:
        lib.duckdb_disconnect(ctypes.byref(con))
        lib.duckdb_close(ctypes.byref(db))
    # C4: HUGEINT and UBIGINT text in full
    for make, n in (("hugeint", -(1 << 100) - 7), ("uint64", (1 << 64) - 1)):
        v = V(lib.duckdb_create_hugeint(Hugeint(lower=n & ((1 << 64) - 1), upper=n >> 64))
              if make == "hugeint" else lib.duckdb_create_uint64(n))
        p = lib.duckdb_get_varchar(v)
        text = ctypes.cast(p, ctypes.c_char_p).value.decode()
        lib.duckdb_free(p)
        lib.duckdb_destroy_value(ctypes.byref(v))
        if text != str(n):
            return f"C4: duckdb_get_varchar of a {make} gives {text}, not {n}"
    return ""


def faults_step(card) -> str:
    """Phase 25 step 1: the F28-F31 forms on the card, each as the tests
    hold it. '' or what failed."""
    import datetime

    import duckdb_tpu_torch
    from duckdb_tpu_torch import errors
    from duckdb_tpu_torch.planner.bound import BindError

    con = duckdb_tpu_torch.connect()
    con.sql("CREATE TABLE lists AS SELECT * FROM (VALUES ([1, 2]), (NULL), ([3])) t(x)")
    answers = [
        ("SELECT repeat([1, 2], 2)", [([1, 2, 1, 2],)]),  # F30
        ("SELECT repeat(x, 2) FROM lists", [([1, 2, 1, 2],), (None,), ([3, 3],)]),
        ("SELECT make_time('1', '2', '3')", [(datetime.time(1, 2, 3),)]),  # F29
        ("SELECT factorial('2'), gcd('2', '2')", [(2, 2)]),
        ("SELECT make_date('2020', '1', '2')", [(datetime.date(2020, 1, 2),)]),
    ]
    refusals = [
        ("SELECT reverse([1, 2])", BindError), ("SELECT strlen(x) FROM lists", BindError),
        ("SELECT date_part(1)", BindError), ("SELECT array_append(1, 1)", BindError),  # F28
        ("SELECT split(1, 1)", BindError),
        ("SELECT make_date('a', 'a', 'a')", errors.ConversionException),
        ("SELECT day('2')", errors.ConversionException),
        ("SELECT day(s) FROM (VALUES ('2')) t(s)", BindError),
    ]
    for sql, want in answers:
        got = con.sql(sql).rows()
        if got != want:
            return f"{sql} gives {got}, not {want}"
    for sql, cls in refusals:
        try:
            con.sql(sql).rows()
        except cls:
            continue
        except Exception as err:  # noqa: BLE001 — a bare error is the fault
            return f"{sql} raised {type(err).__name__}: {err}, not {cls.__name__}"
        return f"{sql} answered where it must raise {cls.__name__}"
    # F31: UINT64 as HUGEINT, BYTE_ARRAY as BLOB, summed on the card
    path = os.path.join(FIXTURES, "unsigned_binary.parquet")
    with open(path + ".expected.json") as f:
        rows = json.load(f)["rows"]
    want = [(sum(r[1] for r in rows if r[1] is not None),
             sum(1 for r in rows if r[3] is not None))]
    got = con.sql(f"SELECT sum(u64), count(bin) FROM read_parquet('{path}')").rows()
    row1 = con.sql(f"SELECT u64, bin FROM read_parquet('{path}') WHERE k = 1").rows()
    if got != want or row1 != [(2**63 + 5, fixture_value(rows[1][3]))]:
        return f"F31: {got} / {row1}, not {want} / {(2**63 + 5, rows[1][3])}"
    print(f"phase 25 step 1 on {card}: F28-F31's {len(answers) + len(refusals) + 1} forms "
          "answer or raise as the tests hold them")
    return ""


def arrow_step(con, kit, want_q1) -> str:
    """Phase 25 step 2: lineitem through the port's own Arrow export and
    import, whole and in record batches, then Q1 over each import through
    the kernel. '' or what failed."""
    import gc

    import numpy as np

    from duckdb_tpu_torch.api import arrow_interop as AI

    res, line = kit.step("2 SELECT * FROM lineitem to the host", lambda: con.sql(
        "SELECT * FROM lineitem"))
    print(line)
    nbytes = sum(np.asarray(v).nbytes + (0 if ok is None else np.asarray(ok).nbytes)
                 for v, ok, _ in res.columns)
    for label, make, name in (("whole", lambda: res.arrow(), "li_arrow"),
                              (f"in batches of {ARROW_BATCH_ROWS}",
                               lambda: res.fetch_record_batch(ARROW_BATCH_ROWS), "li_batches")):
        export = make()
        t0 = time.perf_counter()
        capsule = export.__arrow_c_stream__()
        export_s = time.perf_counter() - t0

        class Stream:  # the capsule, handed over as a consumer takes one
            def __arrow_c_stream__(self, requested_schema=None):
                return capsule

        t0 = time.perf_counter()
        con.from_arrow(Stream(), name)
        import_s = time.perf_counter() - t0
        del capsule
        gc.collect()
        print(f"phase 25 step 2 on {kit.card}: lineitem ({res.nrows} rows, {nbytes} bytes of "
              f"host planes) exported {label} ({export.num_batches} batches) in "
              f"{export_s * 1e3:.3f} ms ({nbytes / export_s / 1e6:.1f} MB/s), imported by "
              f"from_arrow in {import_s * 1e3:.3f} ms ({nbytes / import_s / 1e6:.1f} MB/s)")
        if name == "li_batches" and export.num_batches != -(-res.nrows // ARROW_BATCH_ROWS):
            return f"fetch_record_batch gave {export.num_batches} batches"
        q1 = Q1.replace("FROM lineitem", f"FROM {name}")
        rows, line = kit.with_kernel(f"2 Q1 over {name}", f"arrow_q1_{name}",
                                     lambda: con.sql(q1).rows())
        bad = rows_match(rows, want_q1)
        if bad:
            return f"Q1 over {name} differs from numpy: {bad}"
        if kit.launches_by_query[f"arrow_q1_{name}"] < 1:
            return f"Q1 over {name} did not launch the grouped sum"
        print(line + f"; rows equal numpy's; grouped_sum_i64 launches "
              f"{kit.launches_by_query[f'arrow_q1_{name}']}")
        bad = kit.kernel_check(f"arrow_q1_{name}")
        if bad:
            return bad
        con.sql(f"DROP TABLE {name}")
    del res
    gc.collect()
    if AI.live_structs():
        return f"{AI.live_structs()} Arrow structs were never released"
    return ""


def parquet_step(card) -> str:
    """Phase 25 step 3: the item 49 fixtures read to their expected rows,
    and LIST and TIME columns written by COPY TO read back. '' or what
    failed."""
    import shutil

    import duckdb_tpu_torch

    con = duckdb_tpu_torch.connect()
    cases = [c for c in fixture_cases()
             if os.path.basename(c[0]) in ("nested_time.parquet", "unsigned_binary.parquet")]
    for path, sql, want in cases:
        got = con.sql(sql).rows()
        if got != want:
            return f"{os.path.basename(path)} differs from its expected rows"
    try:
        con.sql(f"SELECT * FROM read_parquet('{os.path.join(FIXTURES, 'nested_deep.parquet')}')")
        return "nested_deep.parquet read where it must raise"
    except ValueError as err:
        if '"ll"' not in str(err):
            return f"nested_deep.parquet raised without naming its column: {err}"
    shutil.rmtree(PHASE25_DIR, ignore_errors=True)
    os.makedirs(PHASE25_DIR)
    src = os.path.join(FIXTURES, "nested_time.parquet")
    out = os.path.join(PHASE25_DIR, "lists.parquet")
    con.sql(f"COPY (SELECT k, l, ls, t32, t64 FROM read_parquet('{src}') ORDER BY k) TO "
            f"'{out}' (FORMAT PARQUET)")
    back = con.sql(f"SELECT * FROM read_parquet('{out}') ORDER BY k").rows()
    want = con.sql(f"SELECT k, l, ls, t32, t64 FROM read_parquet('{src}') ORDER BY k").rows()
    shutil.rmtree(PHASE25_DIR, ignore_errors=True)
    if back != want:
        return "the LIST and TIME columns written by COPY TO read back differently"
    print(f"phase 25 step 3 on {card}: {len(cases)} item 49 / F31 fixtures equal their "
          f"expected rows, nested_deep.parquet refused naming \"ll\", and {len(back)} rows of "
          "INTEGER[], VARCHAR[] and TIME written by COPY TO read back equal")
    return ""


def matrix_step(kit) -> str:
    """Phase 25 step 4: the fifteen configurations × MATRIX_QUERIES at SF
    0.01 on the card, each equal to the numpy oracle, every launch held to
    the plain version. '' or what failed."""
    import duckdb_tpu_torch
    from duckdb_tpu_torch.catalog import catalog as C
    from duckdb_tpu_torch.testing import tpch_oracle
    from duckdb_tpu_torch.testing.tpch_gen import TABLE_COLUMNS, write_tables

    t0 = time.perf_counter()
    if not all(os.path.exists(os.path.join(MATRIX_DATA, t, "meta.json")) for t in TABLE_COLUMNS):
        write_tables(MATRIX_DATA, MATRIX_SF, MATRIX_SEED)
    texts = {**tpch_oracle.QUERIES, **tpch_oracle.LIKE_QUERIES, **tpch_oracle.GENERAL_QUERIES,
             "q01": Q1}
    wants = {q: numpy_q1(MATRIX_DATA) if q == "q01" else tpch_oracle.answer(q, MATRIX_DATA)
             for q in MATRIX_QUERIES}
    print(f"phase 25 step 4: SF {MATRIX_SF} seed {MATRIX_SEED} data and the numpy answers in "
          f"{time.perf_counter() - t0:.1f} s")
    walls, timed = [], set()
    for config, sets in MATRIX_CONFIGS.items():
        con = duckdb_tpu_torch.connect()
        con.load_tpch(MATRIX_DATA)

        def run():
            out = {}
            for q in MATRIX_QUERIES:
                for s in sets:
                    con.sql(s)
                try:
                    t = time.perf_counter()
                    out[q] = con.sql(texts[q]).rows()
                    walls.append(time.perf_counter() - t)
                finally:
                    for s in MATRIX_RESETS:
                        con.sql(f"RESET {s}")
                    C.set_memory_limit(0)
            return out

        got, line = kit.with_kernel(f"4 {config}", f"matrix_{config}", run)
        for q in MATRIX_QUERIES:
            bad = rows_match(got[q], wants[q])
            if bad:
                return f"{q} under {config} differs from numpy: {bad}"
        launches = kit.launches_by_query[f"matrix_{config}"]
        if config.startswith("pallas_off") != (launches == 0):
            return f"{config}: {launches} grouped_sum_i64 launches"
        print(line + f"; {len(MATRIX_QUERIES)} queries equal numpy's; routes "
              f"{sorted(k for k in con.routes if k.startswith(('sharded', 'out_of_core')))}; "
              f"grouped_sum_i64 launches {launches}")
        bad = kit.kernel_check(f"matrix_{config}", timed)
        if bad:
            return bad
    print(f"phase 25 step 4 on {kit.card}: {len(MATRIX_CONFIGS)} configurations x "
          f"{len(MATRIX_QUERIES)} queries, median query wall "
          f"{statistics.median(walls) * 1e3:.3f} ms (max {max(walls) * 1e3:.3f} ms)")
    return ""


def faults_arrow_matrix_phase(con, card, recording, recorded, launches_by_query, shapes,
                              reps) -> str:
    """Phase 25 (see the module docstring). '' or a failure message."""
    import duckdb_tpu_torch.capi

    phase_t0 = time.perf_counter()
    kit = Steps(25, card, recording, recorded, launches_by_query, shapes, reps)
    bad = faults_step(card)
    if bad:
        return f"phase 25 step 1: {bad}"
    bad, line = kit.step("1 C1-C5 through the C API", lambda: capi_faults(
        duckdb_tpu_torch.capi.library()))
    if bad:
        return f"phase 25 step 1: {bad}"
    print(line + "; C1-C5 hold")
    bad = arrow_step(con, kit, numpy_q1(DATA))
    if bad:
        return f"phase 25 step 2: {bad}"
    bad = parquet_step(card)
    if bad:
        return f"phase 25 step 3: {bad}"
    bad = matrix_step(kit)
    if bad:
        return f"phase 25 step 4: {bad}"
    print(f"phase 25 on {card}: {time.perf_counter() - phase_t0:.1f} s")
    return ""


# phase 26: median, quantile_cont, stddev and var over frames, and DISTINCT
# over a frame (ROADMAP item 44), at SF1
PHASE26_MOD = 10007
PHASE26_CHUNK = 250_000  # oracle rows per chunk: no [rows, frame] array of lineitem whole
LI_KEYS = ("l_returnflag", "l_linestatus")
PHASE26 = {  # name → (table, group keys, the window)
    "win_median_rows": ("lineitem", LI_KEYS,
                        "median(l_extendedprice) OVER (PARTITION BY l_suppkey ORDER BY "
                        "l_shipdate ROWS BETWEEN 50 PRECEDING AND 50 FOLLOWING)"),
    "win_quantile_running": ("lineitem", LI_KEYS,
                             "quantile_cont(l_quantity, 0.9) OVER (PARTITION BY l_partkey "
                             "ORDER BY l_shipdate)"),
    "win_stddev_30d": ("lineitem", LI_KEYS,
                       "stddev_samp(l_discount) OVER (PARTITION BY l_suppkey ORDER BY "
                       "l_shipdate RANGE BETWEEN INTERVAL '30 days' PRECEDING AND CURRENT ROW)"),
    "win_var_pop_orders": ("orders", ("o_orderstatus",),
                           "var_pop(o_totalprice) OVER (PARTITION BY o_custkey ORDER BY "
                           "o_orderdate)"),
    "win_distinct_rows": ("lineitem", LI_KEYS,
                          "count(DISTINCT l_quantity) OVER (PARTITION BY l_suppkey ORDER BY "
                          "l_shipdate ROWS BETWEEN 100 PRECEDING AND CURRENT ROW)"),
    "win_median_distinct_rows": ("lineitem", LI_KEYS,
                                 "median(DISTINCT l_quantity) OVER (PARTITION BY l_suppkey "
                                 "ORDER BY l_shipdate ROWS BETWEEN 50 PRECEDING AND 50 "
                                 "FOLLOWING)"),
    "win_stddev_distinct_rows": ("lineitem", LI_KEYS,
                                 "stddev(DISTINCT l_discount) OVER (PARTITION BY l_suppkey "
                                 "ORDER BY l_shipdate ROWS BETWEEN 100 PRECEDING AND CURRENT "
                                 "ROW)"),
}
PHASE26_COLS = {
    "lineitem": ("l_orderkey", "l_linenumber", "l_suppkey", "l_partkey", "l_shipdate",
                 "l_extendedprice", "l_quantity", "l_discount", "l_returnflag", "l_linestatus"),
    "orders": ("o_orderkey", "o_custkey", "o_orderdate", "o_totalprice", "o_orderstatus")}


def phase26_sql(name):
    """(the grouped query, the read-back query) of one PHASE26 window."""
    table, keys, window = PHASE26[name]
    pk = "l_orderkey, l_linenumber" if table == "lineitem" else "o_orderkey"
    by = ", ".join(str(i + 1) for i in range(len(keys)))
    grouped = (f"SELECT {', '.join(keys)}, count(*), sum(m), min(m), max(m) FROM (SELECT "
               f"{', '.join(keys)}, {window} AS m FROM {table}) GROUP BY {by} ORDER BY {by}")
    readback = (f"SELECT {pk}, m FROM (SELECT {pk}, {window} AS m FROM {table}) WHERE "
                f"{pk.split(',')[0]} % {PHASE26_MOD} = 0 ORDER BY {pk}")
    return grouped, readback


def phase26_columns(data_dir: str) -> dict:
    """{table: {column: numpy array}} of PHASE26_COLS from the generated
    files (integers, DECIMAL cents and date days as int64, flags as bytes)."""
    import numpy as np

    out = {}
    for table, names in PHASE26_COLS.items():
        cols = {}
        for name in names:
            path = os.path.join(data_dir, table, name)
            if os.path.exists(path + ".i64") or os.path.exists(path + ".i32"):
                cols[name] = _table_col(data_dir, table, name)
            else:
                cols[name] = np.fromfile(path + ".bytes", dtype="S1")
        out[table] = cols
    return out


def _window_order(part, order):
    """(sorted position → row, partition start, partition end and last peer
    of each sorted position): a stable sort by (partition, order key), so
    that ties keep the table's row order as the port's sort does. The order
    key is a date in days (below 2^16)."""
    import numpy as np

    perm = np.argsort(part * (1 << 16) + order, kind="stable")
    p, o = part[perm], order[perm]
    n = len(perm)
    new_part = np.ones(n, bool)
    new_part[1:] = p[1:] != p[:-1]
    new_peer = new_part.copy()
    new_peer[1:] |= o[1:] != o[:-1]
    idx = np.arange(n)
    start = np.maximum.accumulate(np.where(new_part, idx, 0))
    last = np.ones(n, bool)
    last[:-1] = new_part[1:]
    end = np.minimum.accumulate(np.where(last, idx, n)[::-1])[::-1]
    last_peer = np.ones(n, bool)
    last_peer[:-1] = new_peer[1:]
    peer_e = np.minimum.accumulate(np.where(last_peer, idx, n)[::-1])[::-1]
    return perm, start, end, peer_e


def _sorted_frames(v, lo, hi, pick):
    """For each frame [lo, hi] (positions of v), pick(its values sorted,
    padding after them, its size): frames go in buckets of sizes (w/2, w]
    for w = 1, 2, 4, …, each bucket PHASE26_CHUNK frames at a time, so no
    [frames, longest frame] array is built whole."""
    import numpy as np

    c = hi - lo + 1
    out = np.empty(len(lo), dtype=np.float64)
    pad = np.iinfo(np.int64).max
    w, top = 1, int(c.max()) if len(c) else 0
    while w // 2 < top:
        rows = np.lib.stride_tricks.sliding_window_view(
            np.concatenate([v, np.full(w, pad)]), w)  # rows[i] = v[i:i + w], padded
        sel = np.flatnonzero((c <= w) & (c > w // 2))
        for a in range(0, len(sel), PHASE26_CHUNK):
            s = sel[a:a + PHASE26_CHUNK]
            vals = np.where(np.arange(w)[None, :] < c[s, None], rows[lo[s]], pad)
            out[s] = pick(np.sort(vals, axis=1), c[s])
        w *= 2
    return out


def _row_pick(vals, k):
    import numpy as np

    return vals[np.arange(vals.shape[0]), k]


def _popcount64(x):
    import numpy as np

    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(x).astype(np.int64)
    lut = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)
    return lut[x.view(np.uint8).reshape(-1, 8)].sum(axis=1)


def _frame_or(bits, lo, hi):
    """The OR of bits[lo..hi] for each frame (positions), from a sparse
    table of ORs over aligned power-of-two runs."""
    import numpy as np

    n = len(bits)
    length = hi - lo + 1
    level = np.floor(np.log2(length)).astype(np.int64)
    table = [bits]
    while (1 << len(table)) <= int(length.max()):
        prev, h = table[-1], 1 << (len(table) - 1)
        nxt = prev.copy()
        nxt[:n - h] |= prev[h:]
        table.append(nxt)
    out = np.zeros(n, dtype=np.uint64)
    for j, t in enumerate(table):
        at = level == j
        out[at] = t[lo[at]] | t[hi[at] - (1 << j) + 1]
    return out


def _set_bits(masks, width):
    """Per mask (uint64), its bits 0..width-1 as an int64 matrix of 0/1."""
    import numpy as np

    return ((masks[:, None] >> np.arange(width, dtype=np.uint64)[None, :])
            & np.uint64(1)).astype(np.int64)


def phase26_oracle(cols: dict, name: str):
    """Each row's window value (table order) of one PHASE26 window, from
    numpy alone: float64 with NaN for NULL, or int64 for the count."""
    import numpy as np

    if name == "win_var_pop_orders":
        # two passes over each running frame's prices as DOUBLE (cents / 100,
        # as DuckDB reads a DECIMAL), PHASE26_CHUNK frames at a time
        o = cols["orders"]
        perm, start, end, peer_e = _window_order(o["o_custkey"], o["o_orderdate"])
        x = o["o_totalprice"][perm] / 100.0
        width = int((end - start).max()) + 1
        m = np.empty(len(perm))
        for a in range(0, len(perm), PHASE26_CHUNK):
            b = min(len(perm), a + PHASE26_CHUNK)
            idx = start[a:b, None] + np.arange(width)[None, :]
            inside = idx <= peer_e[a:b, None]
            vals = np.where(inside, x[np.minimum(idx, len(x) - 1)], 0.0)
            c = inside.sum(axis=1)
            mean = vals.sum(axis=1) / c
            m[a:b] = (np.where(inside, vals - mean[:, None], 0.0) ** 2).sum(axis=1) / c
        out = np.empty(len(perm))
        out[perm] = m
        return out
    li = cols["lineitem"]
    part = li["l_partkey"] if name == "win_quantile_running" else li["l_suppkey"]
    perm, start, end, peer_e = _window_order(part, li["l_shipdate"])
    n = len(perm)
    pos = np.arange(n)
    if name == "win_median_rows":
        lo, hi = np.maximum(pos - 50, start), np.minimum(pos + 50, end)
        v = li["l_extendedprice"][perm]

        def median(vals, c):
            return (_row_pick(vals, (c - 1) // 2) + _row_pick(vals, c // 2)) / 200.0

        # whole frames of 101 values: the 51st smallest by a partial sort
        full = np.flatnonzero(hi - lo == 100)
        rows = np.lib.stride_tricks.sliding_window_view(v, 101)  # rows[i] = v[i:i + 101]
        m = np.empty(n)
        for a in range(0, len(full), PHASE26_CHUNK):
            s = full[a:a + PHASE26_CHUNK]
            frames = rows[lo[s]]
            frames.partition(50, axis=1)
            m[s] = frames[:, 50] / 100.0
        part_rows = np.flatnonzero(hi - lo != 100)
        m[part_rows] = _sorted_frames(v, lo[part_rows], hi[part_rows], median)
    elif name == "win_quantile_running":
        def q90(vals, c):
            p = (c - 1) * 0.9
            k = np.floor(p).astype(np.int64)
            f = p - k
            a, b = _row_pick(vals, k) / 100.0, _row_pick(vals, np.ceil(p).astype(np.int64))
            return a * (1.0 - f) + b / 100.0 * f

        m = _sorted_frames(li["l_quantity"][perm], start, peer_e, q90)
    elif name == "win_stddev_30d":
        # exact integer moments of the discounts (cents) in each frame
        key = part[perm] * (1 << 16) + li["l_shipdate"][perm]
        lo = np.searchsorted(key, key - 30, "left")
        hi = np.searchsorted(key, key, "right") - 1
        d = li["l_discount"][perm]  # cents
        p1 = np.concatenate([[0], np.cumsum(d)])
        p2 = np.concatenate([[0], np.cumsum(d * d)])
        c = hi - lo + 1
        s1, s2 = p1[hi + 1] - p1[lo], p2[hi + 1] - p2[lo]
        with np.errstate(invalid="ignore", divide="ignore"):
            var = (c * s2 - s1 * s1).astype(np.float64) / (c * (c - 1)).astype(np.float64)
        m = np.where(c >= 2, np.sqrt(var) / 100.0, np.nan)
    elif name == "win_median_distinct_rows":
        # the set of quantities (whole units 1..50) in each frame as a
        # bitmask; the median of its members, PHASE26_CHUNK rows at a time
        bits = np.left_shift(np.uint64(1), (li["l_quantity"][perm] // 100 - 1).astype(np.uint64))
        masks = _frame_or(bits, np.maximum(pos - 50, start), np.minimum(pos + 50, end))
        m = np.empty(n)
        for a in range(0, n, PHASE26_CHUNK):
            cum = np.cumsum(_set_bits(masks[a:a + PHASE26_CHUNK], 50), axis=1)
            c = cum[:, -1]
            # the k-th member (from 0) is the bit where the running count passes k
            lo_q = (cum <= ((c - 1) // 2)[:, None]).sum(axis=1) + 1
            hi_q = (cum <= (c // 2)[:, None]).sum(axis=1) + 1
            m[a:a + PHASE26_CHUNK] = (lo_q + hi_q) / 2.0
    elif name == "win_stddev_distinct_rows":
        # the set of discounts (cents 0..10) in each frame as a bitmask;
        # exact integer moments of its members
        bits = np.left_shift(np.uint64(1), li["l_discount"][perm].astype(np.uint64))
        masks = _frame_or(bits, np.maximum(pos - 100, start), pos)
        member = _set_bits(masks, 11)
        d = np.arange(11, dtype=np.int64)
        c, s1, s2 = member.sum(axis=1), member @ d, member @ (d * d)
        with np.errstate(invalid="ignore", divide="ignore"):
            var = (c * s2 - s1 * s1).astype(np.float64) / (c * (c - 1)).astype(np.float64)
        m = np.where(c >= 2, np.sqrt(var) / 100.0, np.nan)
    else:  # win_distinct_rows: OR of one bit per quantity over the frame
        bits = np.left_shift(np.uint64(1), (li["l_quantity"][perm] // 100 - 1).astype(np.uint64))
        m = _popcount64(_frame_or(bits, np.maximum(pos - 100, start), pos))
        out = np.empty(n, dtype=np.int64)
        out[perm] = m
        return out
    out = np.empty(n)
    out[perm] = m
    return out


def phase26_want(cols: dict, name: str, m):
    """(the grouped query's rows, the read-back's rows) from the oracle's m."""
    import numpy as np

    table, keys, _ = PHASE26[name]
    t = cols[table]
    is_count = m.dtype.kind == "i"
    codes = [t[k] for k in keys]
    groups = sorted(set(zip(*[c.tolist() for c in codes])))
    rows = []
    for g in groups:
        sel = np.ones(len(m), bool)
        for c, v in zip(codes, g):
            sel &= c == v
        v = m[sel]
        live = v if is_count else v[~np.isnan(v)]
        if is_count:
            agg = (int(live.sum()), int(live.min()), int(live.max()))
        elif len(live):
            agg = (float(live.sum()), float(live.min()), float(live.max()))
        else:
            agg = (None, None, None)
        rows.append(tuple(x.decode() for x in g) + (int(sel.sum()),) + agg)
    okey = t["l_orderkey" if table == "lineitem" else "o_orderkey"]
    pick = np.flatnonzero(okey % PHASE26_MOD == 0)
    if table == "lineitem":
        pick = pick[np.lexsort((t["l_linenumber"][pick], okey[pick]))]
        pk = [(int(okey[i]), int(t["l_linenumber"][i])) for i in pick]
    else:
        pick = pick[np.argsort(okey[pick], kind="stable")]
        pk = [(int(okey[i]),) for i in pick]

    def val(x):
        return int(x) if is_count else (None if np.isnan(x) else float(x))

    return rows, [k + (val(m[i]),) for k, i in zip(pk, pick)]


def g_forms_step(card) -> str:
    """Phase 26 step 1: G1-G3's forms on a card connection, as
    tests/test_torch_shadow_faults.py holds them. '' or what failed."""
    import duckdb_tpu_torch

    con = duckdb_tpu_torch.connect()
    con.sql("CREATE TABLE lt (id INTEGER, s VARCHAR[], l INTEGER[])")
    checks = [
        ("INSERT INTO lt VALUES (1, ['a','b'], [10,20,30]), (2, ['c'], []), (3, NULL, [5])",
         [(3,)]),
        ("INSERT INTO lt (id, l) VALUES (4, [])", [(1,)]),
        ("UPDATE lt SET l = [] WHERE id = 1", [(1,)]),
        ("SELECT id, s, l, CASE WHEN id = 3 THEN [] ELSE l END, coalesce(s, []), l || [7] "
         "FROM lt ORDER BY id",
         [(1, ["a", "b"], [], [], ["a", "b"], [7]), (2, ["c"], [], [], ["c"], [7]),
          (3, None, [5], [], [], [5, 7]), (4, None, [], [], [], [7])]),
        ("SELECT [1, 2] || [3], [] || [1], [1] || NULL", [([1, 2, 3], [1], None)]),
    ]
    for sql, want in checks:
        got = con.sql(sql).rows()
        if got != want:
            return f"{sql} gives {got}, not {want}"
    if con.sql("SET threads = 4") is not None:
        return "SET returned a result (G3)"
    print(f"phase 26 step 1 on {card}: G1-G3's {len(checks) + 1} forms answer as the tests "
          "hold them")
    return ""


def frame_windows_phase(con, card, recording, recorded, launches_by_query, shapes,
                        reps) -> str:
    """Phase 26 (see the module docstring). '' or a failure message."""
    import torch

    phase_t0 = time.perf_counter()
    bad = g_forms_step(card)
    if bad:
        return f"phase 26 step 1: {bad}"
    t0 = time.perf_counter()
    cols = phase26_columns(DATA)
    print(f"phase 26 step 2: the oracle's columns read in {time.perf_counter() - t0:.1f} s")
    kit = Steps(26, card, recording, recorded, launches_by_query, shapes, reps)
    timed = set()
    for name in PHASE26:
        grouped, readback = phase26_sql(name)
        t0 = time.perf_counter()
        want, want_rows = phase26_want(cols, name, phase26_oracle(cols, name))
        oracle_s = time.perf_counter() - t0
        con.routes.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rows, line = kit.with_kernel(f"2 {name}", name, lambda: con.sql(grouped).rows())
        peak = torch.cuda.max_memory_allocated() - base
        bad = rows_match(rows, want)
        if bad:
            return f"phase 26 {name}: the groups differ from numpy: {bad}"
        got_rows = con.sql(readback).rows()
        bad = rows_match(got_rows, want_rows)
        if bad:
            return f"phase 26 {name}: the read-back rows differ from numpy: {bad}"
        launches = launches_by_query[name]
        route = ", ".join(f"{k} {v}" for k, v in sorted(con.routes.items()))
        print(line + f"; groups and {len(got_rows)} read-back rows equal numpy's (oracle "
              f"{oracle_s:.1f} s); routes {route}; grouped_sum_i64 launches {launches}"
              + ("" if launches else " (the count(*) took no grouped-sum route)")
              + f"; peak device memory {peak / 2 ** 20:.1f} MiB above the tables on {card}")
        bad = kit.kernel_check(name, timed)
        if bad:
            return bad
        med, times = warm_median(con, grouped, rows, runs=3, exact=False)
        if med is None:
            return f"phase 26 {name}: {times}"
        syncs = count_syncs(lambda: con.sql(grouped).rows())
        print(f"phase 26 {name} on {card}: warm median {med * 1e3:.3f} ms of 3 after 1 warm-up "
              f"({', '.join(f'{t * 1e3:.3f}' for t in times)} ms), {syncs} host syncs")
        bad = busy_share(con, grouped, card, runs=1)
        if bad:
            return bad
    print(f"phase 26 on {card}: {time.perf_counter() - phase_t0:.1f} s")
    return ""


# phase 27: H1-H4's forms, then the recorded corpus card against CPU
REPLAY_DIR = os.path.join(ROOT, "build", "phase27")


def h_forms_step(card) -> str:
    """Phase 27 step 1: H1-H4's forms on a card connection, as
    tests/test_torch_fetchone.py, test_torch_frame_windows.py and
    test_torch_shadow_faults.py hold them. '' or what failed."""
    import decimal

    import numpy as np

    import duckdb_tpu_torch

    con = duckdb_tpu_torch.connect()
    con.sql("CREATE TABLE t AS SELECT * FROM (VALUES (1, 2.5, 1), (1, 0.5, 2), (1, 0.5, 3), "
            "(2, 3.0, 1), (2, 3.0, 2), (2, NULL, 3), (2, 5.0, 4)) v(a, c, o)")
    first = "SELECT a, c FROM t ORDER BY a DESC, o"
    for how, res in (("execute", con.execute(first)), ("sql", con.sql(first)),
                     ("a cursor's sql", con.cursor().sql(first))):
        if res.fetchone() != (2, decimal.Decimal("3.0")):
            return f"H1: {how}(…).fetchone() gives {res.fetchone()}"
    if con.sql("SELECT * FROM t WHERE a > 5").fetchone() is not None:
        return "H1: fetchone() of an empty result is not None"
    windows = {
        "median(DISTINCT a) OVER ()": [1.5] * 7,
        "stddev(DISTINCT c) OVER ()": [float(np.std([0.5, 2.5, 3.0, 5.0], ddof=1))] * 7,
        "quantile_cont(DISTINCT c, 0.5) OVER (PARTITION BY a)": [1.5] * 3 + [4.0] * 4,
        "var_pop(DISTINCT c) OVER (PARTITION BY a ORDER BY o)": [0.0, 1.0, 1.0, 0.0, 0.0,
                                                                   0.0, 1.0],
        "var_pop(DISTINCT c) OVER (PARTITION BY a ORDER BY o ROWS BETWEEN 1 PRECEDING AND "
        "1 FOLLOWING)": [1.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0],
        "median(DISTINCT c) OVER (PARTITION BY a ORDER BY o ROWS BETWEEN 1 PRECEDING AND "
        "1 FOLLOWING)": [1.5, 1.5, 0.5, 3.0, 3.0, 4.0, 5.0],
    }
    for expr, want in windows.items():
        got = [r[0] for r in con.sql(f"SELECT {expr} FROM t ORDER BY a, o").rows()]
        if any(abs(g - w) > 1e-12 * max(1.0, abs(w)) for g, w in zip(got, want)) \
                or len(got) != len(want):
            return f"H2: {expr} gives {got}, not {want}"
    con.sql("CREATE TABLE v (i INTEGER, st STRUCT(a INTEGER, b VARCHAR), "
            "sp STRUCT(x INTEGER, y DECIMAL(4, 1)), l DOUBLE[])")
    con.sql("INSERT INTO v VALUES (1, {'a': 1, 'b': 'x'}, {'x': 1, 'y': 2.5}, [1, 2]), "
            "(2, {'a': NULL, 'b': 'y'}, NULL, NULL)")
    got = con.sql("SELECT * FROM v ORDER BY i").rows()
    want = [(1, {"a": 1, "b": "x"}, {"x": 1, "y": decimal.Decimal("2.5")}, [1.0, 2.0]),
            (2, {"a": None, "b": "y"}, None, None)]
    if got != want:
        return f"H3/H4: the nested inserts read back as {got}, not {want}"
    print(f"phase 27 step 1 on {card}: H1-H4's {len(windows) + 6} forms answer as the tests "
          "hold them")
    return ""


def replay_phase(card, launches_by_query, shapes, reps) -> str:
    """Phase 27 (see the module docstring): step 1, then every sequence of
    the corpus card against CPU. '' or a failure."""
    import shutil

    import torch

    from duckdb_tpu_torch.ops import grouped as grouped_mod
    from duckdb_tpu_torch.ops import grouped_sum as GS
    from duckdb_tpu_torch.testing import replay as RP

    phase_t0 = time.perf_counter()
    bad = h_forms_step(card)
    if bad:
        return f"phase 27 step 1: {bad}"
    header, sequences = RP.load()
    recorded, timed, worst = [], set(), [0]
    shutil.rmtree(REPLAY_DIR, ignore_errors=True)
    grouped_mod.grouped_sum_i64 = card_recording(GS, recorded)
    GS.grouped_sum_i64.launches = 0
    t0 = time.perf_counter()
    try:
        report = RP.replay(sequences, ("cuda", "cpu"), REPLAY_DIR,
                           after_first=launch_checker(GS, recorded, timed, shapes, worst,
                                                      "replay", reps))
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    launches = launches_by_query["replay"] = GS.grouped_sum_i64.launches
    torch.cuda.synchronize()
    counts = report.counts()
    print(f"phase 27 step 2 on {card}: corpus of {header['sequences']} sequences and "
          f"{header['statements']} statements ({header['recorded']} recorded; left out by "
          f"reason {header['excluded']}; {header['duplicates_dropped']} duplicates dropped); "
          "replayed all")
    print(f"phase 27 step 2 on {card}: sequences {counts['sequences']}, statements "
          f"{counts['statements']}, compared {counts['compared']}, held to their row counts "
          f"(LIMIT without ORDER BY) {counts['count_only']}, answered "
          f"{counts['answered']}, refused {counts['refused']}, nondeterministic "
          f"{counts['nondeterministic']}, problems {counts['problems']}, known "
          f"{counts['known']}; median statement wall {report.median_wall_ms():.3f} ms on the "
          f"card (max {max(report.walls, default=0) * 1e3:.3f} ms); grouped_sum_i64 launches "
          f"{launches}, each equal to its plain version (max abs err {worst[0]}), "
          f"{len(timed)} shapes timed; step {time.perf_counter() - t0:.1f} s")
    for fault, sid, sql, what in report.known:
        print(f"phase 27 known fault {fault} (open in ROADMAP): {sid}: {what}\n  {sql}")
    if report.problems:
        shown = "\n".join(f"  {sid}: {what}\n    {sql[:300]}"
                          for sid, sql, what in report.problems[:10])
        return f"phase 27: {len(report.problems)} problem(s), the first:\n{shown}"
    if worst[0]:
        return f"phase 27: grouped_sum_i64 disagreed with its plain version (err {worst[0]})"
    if launches < 1:
        return "phase 27: the replayed statements never launched grouped_sum_i64 on the card"
    print(f"phase 27 on {card}: {time.perf_counter() - phase_t0:.1f} s")
    return ""


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device: this script runs only on a GPU host")
    sys.path.insert(0, ROOT)
    try:
        import duckdb_tpu_torch
        from duckdb_tpu_torch.ops import grouped as grouped_mod
        from duckdb_tpu_torch.ops import grouped_sum as GS
        from duckdb_tpu_torch.testing import tpch_oracle
        from duckdb_tpu_torch.testing.tpch_gen import TABLE_COLUMNS, write_tables
    except ImportError as err:
        return fail(f"the port is not beside this script ({err})")
    device = torch.device("cuda")
    script_t0 = time.perf_counter()

    # 1. card, versions, build
    card = card_line()
    print(card)
    print(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # the kernel (nvcc) and the file readers' host libraries (the host C++
    # compiler, storage/host_lib.py) build side by side
    import concurrent.futures

    import duckdb_tpu_torch.capi
    from duckdb_tpu_torch.storage import host_lib

    def timed(fn, *args):
        t = time.perf_counter()
        fn(*args)
        return time.perf_counter() - t

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        gs_s = pool.submit(timed, GS.build, True)
        host_s = {name: pool.submit(timed, host_lib.load, name, True)
                  for name in ("csv2col", "parquet_codec", "arrow_c")}
        host_s["duckdb_tpu_torch_capi"] = pool.submit(timed, duckdb_tpu_torch.capi.library, True)
        gs_s = gs_s.result()
        host_s = {name: f.result() for name, f in host_s.items()}
    print(f"built {GS.LIBRARY} in {gs_s:.1f} s and the host libraries "
          f"{', '.join(f'lib{n}.so {s:.1f} s' for n, s in host_s.items())} with "
          f"{host_lib.compiler()}, {time.perf_counter() - t0:.1f} s in all; nvcc -Xptxas -v:")
    print(GS.build_log.strip())

    # 2. data
    t0 = time.perf_counter()
    if not all(os.path.exists(os.path.join(DATA, t, "meta.json")) for t in TABLE_COLUMNS):
        write_tables(DATA, SF, SEED)
    con = duckdb_tpu_torch.connect()
    con.load_tpch(DATA)
    # phases 1-16 on one device, also on a host with several cards (phase 17 shards)
    con.sql("SET num_shards = 1")
    nrows = con.catalog.get_table("lineitem").nrows
    sizes = {t: con.catalog.get_table(t).nrows for t in TABLE_COLUMNS}
    print(f"data: TPC-H SF{SF:g} seed {SEED}, rows {sizes}, "
          f"{time.perf_counter() - t0:.1f} s to generate and register")

    # 3. the main path, with the kernel's inputs recorded for phase 4
    recorded = []
    calls_by_site = {}  # the grouped sum's calls by the module that made them

    def recording(dense, vectors, nseg):
        recorded.append((dense, list(vectors), nseg))
        frame = sys._getframe(1)
        # the caller past ops/grouped and the general path's Groups helpers
        while frame is not None and (
                os.path.basename(frame.f_code.co_filename) in ("grouped.py", "chip_smoke.py")
                or frame.f_code.co_name in ("reduce", "count", "<lambda>")):
            frame = frame.f_back
        site = "?" if frame is None else os.path.relpath(frame.f_code.co_filename, ROOT)
        calls_by_site[site] = calls_by_site.get(site, 0) + 1
        return GS.grouped_sum_i64(dense, vectors, nseg)

    grouped_mod.grouped_sum_i64 = recording
    GS.grouped_sum_i64.launches = 0
    GS.grouped_sum_i64.regime_launches = {"single": 0, "small": 0, "large": 0}
    t0 = time.perf_counter()
    got = con.sql(Q1).rows()
    torch.cuda.synchronize()
    launches = GS.grouped_sum_i64.launches
    regime_launches = dict(GS.grouped_sum_i64.regime_launches)
    first_s = time.perf_counter() - t0
    grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    if launches < 1:
        return fail("Q1 did not launch the grouped_sum_i64 kernel")
    if regime_launches["small"] < 1:
        return fail(f"Q1's grouped sum missed the lane-private (small) regime: "
                    f"{regime_launches}")
    if any(d.device.type != "cuda" for d, _, _ in recorded):
        return fail("the grouped sum ran on a tensor off the card")
    want = numpy_q1(DATA)
    bad = rows_match(got, want)
    if bad:
        return fail(f"Q1 rows differ from the numpy reference: {bad}")
    dense_q1, vecs_q1, nseg_q1 = recorded[-1]
    n_q1, k_q1 = dense_q1.shape[0], len(vecs_q1)
    plan_q1 = GS.launch_plan(nseg_q1, k_q1, n_q1)
    print(f"Q1 (first run, columns load to the card): {first_s:.3f} s, {len(got)} rows "
          f"match numpy; grouped_sum_i64 launches {launches} by regime "
          f"{regime_launches}, shape N={n_q1} K={k_q1} nseg={nseg_q1}, plan {plan_q1}")
    for r in got:
        print("  ", r)

    # 4. kernel against its plain version, exactly; each edge case's call
    # profiled (ids, live share, device launches) and timed
    worst = 0
    edge_shapes = []
    for name, dense, vecs, nseg in [("Q1 inputs", dense_q1, vecs_q1, nseg_q1)] \
            + edge_cases(device, GS):
        err = max_abs_err(GS.grouped_sum_i64(dense, vecs, nseg),
                          GS.grouped_sum_i64_plain(dense, vecs, nseg))
        torch.cuda.synchronize()
        if err:
            return fail(f"grouped_sum_i64 disagrees with its plain version on {name}")
        worst = max(worst, err)
        k_ms, p_ms, l_ms, call = time_kernel(GS, dense, vecs, nseg, 20)
        if "mixed alignment" in name and call["regime"] != "large" \
                and call["loads"] != "8-byte":
            return fail(f"grouped_sum_i64 took {call['loads']} loads on {name}")
        b_ms, b_by, _, _ = bound_of(dense, vecs, nseg)
        print(f"kernel vs plain, {name}: max abs err {err}; kernel {k_ms:.4f} ms, plain "
              f"{p_ms:.4f} ms, index_add_ {l_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}; "
              f"{call_text(call)}")
        edge_shapes.append({"case": name, "max_abs_err": err, "kernel_ms": k_ms,
                            "plain_ms": p_ms, "bound_ms": b_ms, "library_ms": l_ms, **call})

    # 5. timings at the Q1 shape
    reps = 50
    kernel_ms, plain_ms, library_ms, call_q1 = time_kernel(GS, dense_q1, vecs_q1, nseg_q1, reps)
    kernel_ms2 = cuda_ms(lambda: GS.grouped_sum_i64(dense_q1, vecs_q1, nseg_q1), reps)
    bound_ms, bound_by, bytes_moved, adds = bound_of(dense_q1, vecs_q1, nseg_q1)
    print(f"grouped_sum_i64 at N={n_q1} K={k_q1} nseg={nseg_q1} on {card}: kernel "
          f"{kernel_ms:.4f} ms (again {kernel_ms2:.4f}), plain {plain_ms:.4f} ms, "
          f"index_add_ {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved} bytes at 3.35 TB/s = {bytes_moved / HBM_BYTES_PER_S * 1e3:.4f} "
          f"ms; {adds} int64 adds at 67 T/s = {adds / CUDA_CORE_OPS_PER_S * 1e3:.4f} ms); "
          f"{call_text(call_q1)}")

    swept = sweep(GS, card)

    med, times = warm_median(con, Q1, got)
    if med is None:
        return fail(f"Q1: {times}")
    syncs = count_syncs(lambda: con.sql(Q1).rows())
    print(f"Q1 SF{SF:g} on {card}: median of 5 warm runs {med * 1e3:.3f} ms "
          f"(runs {', '.join(f'{t * 1e3:.3f}' for t in times)} ms), "
          f"{nrows / med:.0f} rows/s, {syncs} host syncs per run")

    # 6. the join path: Q3, Q5, Q10, Q12; 7. the subquery path: Q4, Q11,
    # Q17, Q18, Q21; 8. the FROM path: Q7, Q8, Q15, Q19, q13_nolike; 9. the
    # LIKE path: Q2, Q9, Q13, Q14, Q16, Q20; 10. the general path: Q6, Q22,
    # general_agg
    from duckdb_tpu_torch.ops import strings as TS

    TS.device_like_events.clear()
    TS.device_str_events.clear()
    TS.host_loop_events.clear()
    launches_by_query = {"q01": launches}
    shapes = []
    subquery_routes = {"q04": {"fused_semi": 1}, "q11": {"dense": 2},
                       "q17": {"dense": 2}, "q18": {"fused_semi": 1, "sort_group": 1},
                       "q21": {"fused_semi": 1, "fused_anti": 1}}
    # the eager joins each runs (every other eager_* route is a failure)
    from_routes = {"q07": {}, "q08": {}, "q15": {}, "q19": {},
                   "q13_nolike": {"eager_left": 1},
                   "q02": {}, "q09": {}, "q13": {"eager_left": 1}, "q14": {},
                   "q16": {"eager_anti": 1}, "q20": {"eager_semi": 2}}
    # those that reach the grouped sum
    from_kernel = ("q08", "q15", "q19", "q09", "q14")
    # phase 11: the routes each must show (no eager join), and the plane ops
    # each must have run over a near-unique dictionary
    function_routes = {
        "fn_dates": {"general_aggregate": 1, "general_sort_group": 1},
        "fn_math": {"general_aggregate": 1, "general_perfect": 1},
        "fn_strings": {"general_aggregate": 1, "general_perfect": 1},
        "fn_casts": {"general_aggregate": 1, "general_perfect": 1}}
    p_name_values = len(con.catalog.get_table("part").host_column("p_name")[2])
    o_comment_values = len(con.catalog.get_table("orders").host_column("o_comment")[2])
    function_plane_ops = {
        # initcap runs over reverse's result, a dictionary as long as p_name's
        "fn_strings": [("left:[5]", p_name_values), ("strpos:green", p_name_values),
                       ("reverse:[]", p_name_values), ("initcap:[]", p_name_values),
                       ("right:[4]", p_name_values)],
        "fn_casts": [("strpos:special", o_comment_values), ("ascii", o_comment_values)]}
    # phase 10: the routes each must show (every eager_* route listed)
    general_routes = {"q06": {"dense": 1},
                      "q22": {"dense": 1, "general_aggregate": 1, "general_perfect": 1,
                              "eager_anti": 1},
                      "general_agg": {"general_aggregate": 1, "general_perfect": 1}}
    # rows/s over the table each query reads most of (lineitem otherwise)
    rate_table = {"q13_nolike": "customer", "q13": "customer", "q02": "partsupp",
                  "q16": "partsupp", "q22": "customer", "fn_strings": "part",
                  "fn_casts": "orders"}
    c_phone_values = len(con.catalog.get_table("customer").host_column("c_phone")[2])
    for name, sql in {**tpch_oracle.QUERIES, **tpch_oracle.SUBQUERY_QUERIES,
                      **tpch_oracle.FROM_QUERIES, **tpch_oracle.LIKE_QUERIES,
                      **tpch_oracle.GENERAL_QUERIES, **tpch_oracle.FUNCTION_QUERIES}.items():
        recorded.clear()
        grouped_mod.grouped_sum_i64 = recording
        GS.grouped_sum_i64.launches = 0
        GS.grouped_sum_i64.regime_launches = {"single": 0, "small": 0, "large": 0}
        con.routes.clear()
        t0 = time.perf_counter()
        got = con.sql(sql).rows()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        q_launches = GS.grouped_sum_i64.launches
        q_regimes = dict(GS.grouped_sum_i64.regime_launches)
        routes = dict(con.routes)
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
        launches_by_query[name] = q_launches
        want = tpch_oracle.answer(name, DATA)
        bad = rows_match(got, want)
        if bad or not want or want == [(None,)]:
            return fail(f"{name} rows differ from the numpy oracle: {bad or 'no rows'}")
        if name in ("q05", "q12"):
            if routes.get("dense") != 1 or q_launches < 1 or q_regimes["small"] < 1:
                return fail(f"{name} missed the grouped sum's small regime: routes "
                            f"{routes}, launches {q_launches} {q_regimes}")
            if any(d.device.type != "cuda" for d, _, _ in recorded):
                return fail(f"{name}: the grouped sum ran on a tensor off the card")
        elif name in subquery_routes:
            want_routes = subquery_routes[name]
            if any(routes.get(k) != n for k, n in want_routes.items()) \
                    or any(k.startswith("eager_") for k in routes):
                return fail(f"{name} missed its route {want_routes}: routes {routes}")
            if name in ("q04", "q11", "q17") and (q_launches < 1 or any(
                    d.device.type != "cuda" for d, _, _ in recorded)):
                return fail(f"{name} did not launch the grouped sum on the card: "
                            f"launches {q_launches} {q_regimes}")
        elif name in from_routes:
            eager = {k: n for k, n in routes.items() if k.startswith("eager_")}
            if eager != from_routes[name]:
                return fail(f"{name} ran the eager joins {eager}, expected "
                            f"{from_routes[name]}: routes {routes}")
            if name in from_kernel and (q_launches < 1 or any(
                    d.device.type != "cuda" for d, _, _ in recorded)):
                return fail(f"{name} did not launch the grouped sum on the card: "
                            f"launches {q_launches} {q_regimes}")
        elif name in general_routes:
            want_routes = general_routes[name]
            if {k: routes.get(k) for k in want_routes} != want_routes or \
                    {k for k in routes if k.startswith("eager_")} != \
                    {k for k in want_routes if k.startswith("eager_")}:
                return fail(f"{name} missed its route {want_routes}: routes {routes}")
            if q_launches < 1 or any(d.device.type != "cuda" for d, _, _ in recorded):
                return fail(f"{name} did not launch the grouped sum on the card: "
                            f"launches {q_launches} {q_regimes}")
            if name == "q22" and ("substr:1:2", c_phone_values) not in TS.device_str_events:
                return fail(f"Q22's substring over c_phone ({c_phone_values} values) did "
                            f"not run as a plane op: {TS.device_str_events}")
        elif name in function_routes:
            want_routes = function_routes[name]
            if {k: routes.get(k) for k in want_routes} != want_routes or \
                    any(k.startswith("eager_") for k in routes):
                return fail(f"{name} missed its route {want_routes}: routes {routes}")
            if q_launches < 1 or any(d.device.type != "cuda" for d, _, _ in recorded):
                return fail(f"{name} did not launch the grouped sum on the card: "
                            f"launches {q_launches} {q_regimes}")
            missing = [e for e in function_plane_ops.get(name, [])
                       if e not in TS.device_str_events]
            if missing:
                return fail(f"{name}: {missing} did not run as plane ops: "
                            f"{TS.device_str_events}")
            if name == "fn_math":
                bad = hll_near_exact(got)
                if bad:
                    return fail(bad)
        elif routes.get("sort_group") != 1:
            return fail(f"{name} did not take the sort-group mode: routes {routes}")
        print(f"{name} (first run, columns load to the card): {first_s:.3f} s, {len(got)} "
              f"rows match the numpy oracle; routes {routes}; grouped_sum_i64 launches "
              f"{q_launches} by regime {q_regimes}")
        for r in got[:3]:
            print("  ", r)
        timed = set()
        for dense, vecs, nseg in recorded:
            err = max_abs_err(GS.grouped_sum_i64(dense, vecs, nseg),
                              GS.grouped_sum_i64_plain(dense, vecs, nseg))
            torch.cuda.synchronize()
            n_q, k_q = dense.shape[0], len(vecs)
            print(f"kernel vs plain, {name} inputs N={n_q} K={k_q} nseg={nseg}: "
                  f"max abs err {err}")
            if err:
                return fail(f"grouped_sum_i64 disagrees with its plain version on {name}")
            worst = max(worst, err)
            if name in function_routes:
                # the general path repeats shapes (one call per aggregate):
                # each is checked, the first of a shape timed
                if (n_q, k_q, nseg) in timed:
                    continue
                timed.add((n_q, k_q, nseg))
            k_ms, p_ms, l_ms, call = time_kernel(GS, dense, vecs, nseg, reps)
            b_ms, b_by, b_bytes, b_adds = bound_of(dense, vecs, nseg)
            print(f"grouped_sum_i64 at {name}'s shape N={n_q} K={k_q} nseg={nseg} on "
                  f"{card}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, index_add_ "
                  f"{l_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({b_bytes} bytes, "
                  f"{b_adds} adds); {call_text(call)}")
            shapes.append({"query": name, "n": n_q, "k": k_q, "nseg": nseg,
                           "max_abs_err": err, "kernel_ms": k_ms, "plain_ms": p_ms,
                           "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms, **call})
        med, times = warm_median(con, sql, got,
                                 exact=name not in ("general_agg", "fn_math"))
        if med is None:
            return fail(f"{name}: {times}")
        syncs = count_syncs(lambda: con.sql(sql).rows())
        table = rate_table.get(name, "lineitem")
        print(f"{name} SF{SF:g} on {card}: median of 5 warm runs {med * 1e3:.3f} ms "
              f"(runs {', '.join(f'{t * 1e3:.3f}' for t in times)} ms), "
              f"{sizes[table] / med:.0f} {table} rows/s, {syncs} host syncs per run")

    # 8. (end) one FULL join at SF1, its three counts against numpy's
    bad = full_join_counts(con, card)
    if bad:
        return fail(bad)

    # 9. (end) the LIKE matcher: the device path ran, and equals the host regex
    if TS.host_loop_events:
        return fail(f"a LIKE or string function ran a host loop over a large "
                    f"dictionary: {TS.host_loop_events}")
    bad = like_matcher(con, card, set(TS.device_like_events))
    if bad:
        return fail(bad)

    # 10. (end) every string plane op on the card equals its host function
    bad = plane_ops(con, card)
    if bad:
        return fail(bad)

    # 11. (end) hash64 on the card, and SELECT without FROM
    bad = functions_end(con, card)
    if bad:
        return fail(bad)

    def oracle_phase(queries, want_routes, warm_runs, rate_table, need_kernel,
                     oracle=lambda name: tpch_oracle.answer(name, DATA)):
        """Each query once with the kernel's counts reset just before and
        read just after: rows against `oracle` (numpy's), the route exactly,
        the grouped sum on the card (launched at least once where
        `need_kernel`) and equal to its plain version on every input, timed
        at each shape; then the warm median, rows/s and host syncs. → '' or
        a failure message."""
        nonlocal worst
        for name, sql in queries.items():
            recorded.clear()
            grouped_mod.grouped_sum_i64 = recording
            GS.grouped_sum_i64.launches = 0
            GS.grouped_sum_i64.regime_launches = {"single": 0, "small": 0, "large": 0}
            con.routes.clear()
            t0 = time.perf_counter()
            got = con.sql(sql).rows()
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            q_launches = GS.grouped_sum_i64.launches
            q_regimes = dict(GS.grouped_sum_i64.regime_launches)
            routes = dict(con.routes)
            grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
            launches_by_query[name] = q_launches
            t0 = time.perf_counter()
            want = oracle(name)
            oracle_s = time.perf_counter() - t0
            bad = rows_match(got, want)
            if bad or not want:
                return f"{name} rows differ from the numpy oracle: {bad or 'no rows'}"
            if routes != want_routes[name]:
                return f"{name} missed its route {want_routes[name]}: routes {routes}"
            if (need_kernel and q_launches < 1) or any(
                    d.device.type != "cuda" for d, _, _ in recorded):
                return (f"{name} did not launch the grouped sum on the card: launches "
                        f"{q_launches} {q_regimes}")
            if name == "nested_agg" and (q_regimes["small"] < 1 or len(recorded) < 3):
                return (f"nested_agg's count and sum missed the grouped sum's small regime: "
                        f"launches {q_launches} {q_regimes}")
            print(f"{name} (first run): {first_s:.3f} s, {len(got)} rows match the numpy "
                  f"oracle ({oracle_s:.1f} s to answer); routes {routes}; grouped_sum_i64 "
                  f"launches {q_launches} by regime {q_regimes}")
            for r in got[:3]:
                print("  ", repr(r)[:300])
            timed = set()
            for dense, vecs, nseg in recorded:
                err = max_abs_err(GS.grouped_sum_i64(dense, vecs, nseg),
                                  GS.grouped_sum_i64_plain(dense, vecs, nseg))
                torch.cuda.synchronize()
                n_q, k_q = dense.shape[0], len(vecs)
                print(f"kernel vs plain, {name} inputs N={n_q} K={k_q} nseg={nseg}: "
                      f"max abs err {err}")
                if err:
                    return f"grouped_sum_i64 disagrees with its plain version on {name}"
                worst = max(worst, err)
                if (n_q, k_q, nseg) in timed:
                    continue
                timed.add((n_q, k_q, nseg))
                k_ms, p_ms, l_ms, call = time_kernel(GS, dense, vecs, nseg, reps)
                b_ms, b_by, b_bytes, b_adds = bound_of(dense, vecs, nseg)
                print(f"grouped_sum_i64 at {name}'s shape N={n_q} K={k_q} nseg={nseg} on "
                      f"{card}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, index_add_ "
                      f"{l_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} ({b_bytes} bytes, "
                      f"{b_adds} adds); {call_text(call)}")
                shapes.append({"query": name, "n": n_q, "k": k_q, "nseg": nseg,
                               "max_abs_err": err, "kernel_ms": k_ms, "plain_ms": p_ms,
                               "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms, **call})
            runs = warm_runs.get(name, 5)
            med, times = warm_median(con, sql, got, runs=runs,
                                     exact=not any(isinstance(v, float) for r in got for v in r))
            if med is None:
                return f"{name}: {times}"
            syncs = count_syncs(lambda: con.sql(sql).rows())
            table = rate_table[name]
            print(f"{name} SF{SF:g} on {card}: first run {first_s:.3f} s, median of {runs} "
                  f"warm runs {med * 1e3:.3f} ms (runs "
                  f"{', '.join(f'{t * 1e3:.3f}' for t in times)} ms), "
                  f"{sizes[table] / med:.0f} {table} rows/s, {syncs} host syncs per run")
        return ""

    # 12. nested values: NESTED_QUERIES, then nested constants and casts
    phase12_t0 = time.perf_counter()
    bad = oracle_phase(tpch_oracle.NESTED_QUERIES, NESTED_ROUTES, NESTED_WARM_RUNS,
                       NESTED_RATE_TABLE, need_kernel=False)
    if bad:
        return fail(bad)

    # 12. (end) nested constants, casts and a columnar list_value on the card
    bad = nested_end(con, card)
    if bad:
        return fail(bad)
    print(f"phase 12 took {time.perf_counter() - phase12_t0:.1f} s")

    # 13. the rest of the scalar functions: MORE_QUERIES and a count and sum
    # over range(10,000,000) against numpy, then duckdb_functions(), epoch_ms
    # and current_query() on the card
    phase13_t0 = time.perf_counter()
    import numpy as np

    sizes["range"] = RANGE_N  # range()'s rows, for its rate
    want_range = [(RANGE_N, int(np.arange(RANGE_N, dtype=np.int64).sum()))]
    bad = oracle_phase({**tpch_oracle.MORE_QUERIES, "range": RANGE_SQL}, MORE_ROUTES, {},
                       MORE_RATE_TABLE, need_kernel=True,
                       oracle=lambda name: want_range if name == "range"
                       else tpch_oracle.answer(name, DATA))
    if bad:
        return fail(bad)
    bad = more_end(con, card)
    if bad:
        return fail(bad)
    print(f"phase 13 took {time.perf_counter() - phase13_t0:.1f} s")

    # 14. the SELECT forms: SELECT_FORM_QUERIES against numpy, then a
    # sampled percentage and the catalog functions
    phase14_t0 = time.perf_counter()
    bad = oracle_phase(tpch_oracle.SELECT_FORM_QUERIES, SELECT_ROUTES, SELECT_WARM_RUNS,
                       {n: SELECT_RATE_TABLE.get(n, "lineitem")
                        for n in tpch_oracle.SELECT_FORM_QUERIES}, need_kernel=False)
    if bad:
        return fail(bad)
    if launches_by_query["rollup_q1"] < 3 or launches_by_query["mark_q4"] < 1:
        return fail(f"rollup_q1 ({launches_by_query['rollup_q1']}) or mark_q4 "
                    f"({launches_by_query['mark_q4']}) missed the grouped sum")
    bad = select_forms_end(con, card)
    if bad:
        return fail(bad)
    print(f"phase 14 took {time.perf_counter() - phase14_t0:.1f} s")

    # 15. windows: WINDOW_QUERIES against numpy, then two busy shares
    phase15_t0 = time.perf_counter()
    bad = oracle_phase(tpch_oracle.WINDOW_QUERIES, WINDOW_ROUTES, {},
                       {n: WINDOW_RATE_TABLE.get(n, "lineitem")
                        for n in tpch_oracle.WINDOW_QUERIES}, need_kernel=False)
    if bad:
        return fail(bad)
    if launches_by_query["win_rank_lineitem"] < 1 or launches_by_query["win_frames_lineitem"] < 1:
        return fail("win_rank_lineitem or win_frames_lineitem missed the grouped sum")
    for name in ("win_rank_lineitem", "win_frames_lineitem"):
        print(f"{name}:", end=" ")
        busy_share(con, tpch_oracle.WINDOW_QUERIES[name], card)
    print(f"phase 15 took {time.perf_counter() - phase15_t0:.1f} s")

    # 16. out-of-core: Q1, Q3, Q6 and a select in chunks under OOC_LIMIT,
    # then an ORDER BY over more rows than the limit holds
    phase16_t0 = time.perf_counter()
    from duckdb_tpu_torch.catalog import catalog as C

    try:
        bad = out_of_core_phase(con, card, recording, recorded, launches_by_query, shapes,
                                reps)
    finally:
        C.set_memory_limit(0)
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    if bad:
        return fail(bad)
    worst = max(worst, max((r["max_abs_err"] for r in shapes), default=0))
    print(f"phase 16 took {time.perf_counter() - phase16_t0:.1f} s")

    # 17. multi-device: the sharded routes over SHARDS shards
    phase17_t0 = time.perf_counter()
    try:
        bad = sharded_phase(con, card, recording, recorded, launches_by_query, shapes, reps)
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    if bad:
        return fail(bad)
    print(f"phase 17 took {time.perf_counter() - phase17_t0:.1f} s")

    # 18. DML at SF1: edits of a copy of lineitem held to numpy, transactions,
    # constraints, and the grouped sum on the edited tables
    phase18_t0 = time.perf_counter()
    try:
        bad = dml_phase(card, recording, recorded, launches_by_query, shapes, reps)
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    if bad:
        return fail(bad)
    worst = max(worst, max((r["max_abs_err"] for r in shapes), default=0))
    print(f"phase 18 took {time.perf_counter() - phase18_t0:.1f} s")

    # 19. a file database at SF1: checkpoint, reopen, recovery of a killed
    # child's commit, a torn WAL unit dropped, ATTACH READ_ONLY
    phase19_t0 = time.perf_counter()
    try:
        bad = file_db_phase(card, recording, recorded, launches_by_query, shapes, reps)
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    if bad:
        return fail(bad)
    worst = max(worst, max((r["max_abs_err"] for r in shapes), default=0))
    print(f"phase 19 took {time.perf_counter() - phase19_t0:.1f} s")

    # 20. the file readers at SF1: COPY FROM text, CSV and Parquet written
    # and read back, hive partitions, the fixtures, EXPORT / IMPORT
    phase20_t0 = time.perf_counter()
    try:
        bad = file_readers_phase(card, recording, recorded, launches_by_query, shapes, reps)
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    if bad:
        return fail(bad)
    worst = max(worst, max((r["max_abs_err"] for r in shapes), default=0))
    print(f"phase 20 took {time.perf_counter() - phase20_t0:.1f} s")

    # 21. MERGE, ALTER and PIVOT at SF1: each edit of lineitem held to numpy,
    # Q1 through the kernel after each, PIVOT / UNPIVOT, the appender
    phase21_t0 = time.perf_counter()
    try:
        bad = merge_alter_phase(card, recording, recorded, launches_by_query, shapes, reps)
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    if bad:
        return fail(bad)
    worst = max(worst, max((r["max_abs_err"] for r in shapes), default=0))
    print(f"phase 21 took {time.perf_counter() - phase21_t0:.1f} s")

    # 22. settings, the profile of Q1, duckdb_logs(), pallas_grouped_sum, and
    # the clients: the CLI in a subprocess and the C API in this process
    phase22_t0 = time.perf_counter()
    try:
        bad = main_clients_phase(con, card, recording, recorded, launches_by_query, shapes, reps)
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    if bad:
        return fail(bad)
    worst = max(worst, max((r["max_abs_err"] for r in shapes), default=0))
    print(f"phase 22 took {time.perf_counter() - phase22_t0:.1f} s")

    # 23. the grammar fuzzer on a card connection against a CPU connection:
    # SETUP's tables and t1/t2 at 1,000,000 / 400,000 rows, every launch
    # held to the plain version
    phase23_t0 = time.perf_counter()
    try:
        bad = fuzz_phase(card, launches_by_query, shapes, reps)
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    if bad:
        return fail(bad)
    print(f"phase 23 took {time.perf_counter() - phase23_t0:.1f} s")

    # 24. two processes (spawned, gloo) sharing the card over one
    # ProcessMesh: Q1's partial through the kernel on each rank, the
    # exchange joins, the sort and a TopN, held to numpy
    phase24_t0 = time.perf_counter()
    bad = process_mesh_phase(card, launches_by_query, shapes=shapes)
    if bad:
        return fail(bad)
    print(f"phase 24 took {time.perf_counter() - phase24_t0:.1f} s")

    # 25. the faults' forms and C1-C5, lineitem through Arrow and back, the
    # nested and TIME Parquet columns, the configuration matrix at SF 0.01
    phase25_t0 = time.perf_counter()
    try:
        bad = faults_arrow_matrix_phase(con, card, recording, recorded, launches_by_query,
                                        shapes, reps)
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    if bad:
        return fail(bad)
    worst = max(worst, max((r["max_abs_err"] for r in shapes), default=0))
    print(f"phase 25 took {time.perf_counter() - phase25_t0:.1f} s")

    # 26. the windows over frames: G1-G3's forms, then five windows at SF1
    # held to numpy, their outer count(*) through the kernel
    phase26_t0 = time.perf_counter()
    try:
        bad = frame_windows_phase(con, card, recording, recorded, launches_by_query, shapes,
                                  reps)
    finally:
        grouped_mod.grouped_sum_i64 = GS.grouped_sum_i64
    if bad:
        return fail(bad)
    worst = max(worst, max((r["max_abs_err"] for r in shapes), default=0))
    print(f"phase 26 took {time.perf_counter() - phase26_t0:.1f} s")

    # 27. H1-H4's forms, then the JAX package's recorded test statements on
    # the card against the CPU, every launch held to the plain version
    phase27_t0 = time.perf_counter()
    bad = replay_phase(card, launches_by_query, shapes, reps)
    if bad:
        return fail(bad)
    worst = max(worst, max((r["max_abs_err"] for r in shapes), default=0))
    print(f"phase 27 took {time.perf_counter() - phase27_t0:.1f} s")
    print(f"chip_smoke.py took {time.perf_counter() - script_t0:.1f} s in all on {card}")

    print(json.dumps({"kernels": [{
        "name": "grouped_sum_i64", "route": "cuda",
        "source": "duckdb_tpu_torch/csrc/grouped_sum.cu",
        "replaces": "duckdb_tpu/ops/pallas_agg.py:182",
        "launches": sum(launches_by_query.values()),
        "launches_by_query": launches_by_query,
        "regime": plan_q1.regime, "regime_launches": regime_launches,
        "max_abs_err": worst, "ms": kernel_ms, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "query_shapes": shapes, "edge_cases": edge_shapes,
        "calls_by_site": calls_by_site,
        "sweep": [{key: r[key] for key in ("k", "nseg", "live", "kernel_ms", "index_add_ms")}
                  for r in swept]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
