"""Drive presto_tpu_torch's main path on one CUDA card and hold every
kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py              # everything below
    python3 chip_smoke.py --kernels    # the kernel phases alone, no result

Run from the repository root on a machine with a CUDA card and nvcc.
It builds the kernels from presto_tpu_torch/csrc into build/ (one nvcc
per source, started together), checks each kernel's compile-time bounds
against its launch plan, checks each kernel at synthetic shapes (the
main path's and edge shapes), times it (CUDA events around back-to-back
calls) beside its plain version, its byte/operation bound and the one
PyTorch call that computes the same function, and launches
fused_group_sums ten times a shape to see whether
its result is bit-identical.  fused_group_sums and its plain version are
also each held against the correctly rounded sums (math.fsum on the
host), so that the kernel's check does not rest on the plain version
alone.  block_gather is timed in turns with index_select, once so and
once on the card alone (the card sleeps while the host queues the
calls, so a call whose host side outlasts its kernel does not idle the
card), against the bound at 32-byte sector granularity too, and on the
card alone at each stage size of a sweep beside its plan's (each launch
checked byte for byte, its count of tiles through the ring held
against the plan's arithmetic); it must refuse a source off a 16-byte
boundary.  The staged and the flat take_rows are timed at Q3's shape,
and one copy_ of Q3's gather output gives the rate the card moves in
practice.

Then it runs all 22 TPC-H queries at SF1 through
`presto_tpu_torch.connect(...).sql(...)`, four times each with the
kernels' launch counts set to 0 just before and read just after, and
once more with both kernels' inputs captured: at every (kernel, shape)
no earlier query reached, the kernel is held against its plain version
on that very input and timed (block_gather's shapes are then summed
into its time-weighted share of the bound).  Each query's rows must be
identical in the four runs wherever its f64 sums add in a fixed order
(every sum but fused_group_sums' shared-table path), and must agree
with the port's own CPU run (at SF1, or at SF0.1 where the CPU would
take long; the card then runs the query at SF0.1 too) under a
tie-aware comparison: rows
whose ORDER BY keys agree within QUERY_RTOL compare as a multiset, and
at a LIMIT the rows tied with the last kept row may differ.  Q1, Q3, Q6
and Q18 are also held against numpy computations from the generated
columns.  Every run's counters of ordering-aware execution and dynamic
filtering (sorts taken, elided and replayed from the memo, ordering
guard trips, runtime filters produced and applied, probe rows pruned)
must equal presto_tpu's at SF1 (REFERENCE_COUNTERS_SF1), in both
executors, and Q3, Q5, Q8, Q17 and Q18 run again in each with
both features switched off and with each alone: nothing elided,
memoized or pruned by what is off, rows that agree with the runs with
both on, and the times of every variant printed side by side.
The relational phase runs the 13 queries of presto_tpu_torch/
relational_queries.py (window functions, UNION ALL, ROLLUP, EXCEPT,
INTERSECT, FULL and CROSS joins) at SF1 the same way in both executors,
with the same checks (rows against the port's CPU run at SF1, or at
SF0.1 on both for W1 and W2; W3's running sums, prefix-sum differences
whose rounding follows the order of the adds, within a tolerance from
the magnitude of the prefix, FLOAT_PREFIX_QUERIES), its
counters and memo entries against presto_tpu's SF1 values, and prints
one `relational` line a query: warm and replay times, device busy and
idle shares, the top device operations for W1, J1 and S2, and the
kernel shapes each query reached.
The tpcds phase runs the 99 TPC-DS queries of presto_tpu_torch/
tpcds_queries.py over tpcds_catalog(1.0) (nothing cut: 23,490,000
inventory rows among them) the same way in both executors: cold and two
warm dynamic runs, a build and three replays in compiled mode, compiled
rows against the dynamic ones, rows against the port's CPU run in the
dynamic executor at SF0.1 (the card reruns the query there), counters
and memo entries against presto_tpu's SF1 values (DS_REFERENCE_SF1). A
query presto_tpu could not run at SF1 on the host that froze them runs
once more at SF0.1 the same way, held there to its SF0.1 values
(DS_REFERENCE_SF01); one presto_tpu itself cannot run at SF1
(DS_RAISES_AT_SF1) must raise its error there in both executors and runs
at SF0.1 alone (ds_scales). Each kernel is held against its
plain version at every shape no earlier query reached; one `tpcds` line
a query gives its warm and replay times, the graph's device time and
pool bytes, device busy and idle shares, launches and kernel shapes, and
a summary line the graphs, the queries that ran dynamic, the memo's
evictions and bytes, and the top device operations of the three slowest
replays.
The functions phase runs the 11 queries of presto_tpu_torch/
function_queries.py (F1 to F11: approx_distinct with its XXH64 of string
dictionaries, approx_percentile, min_by and max_by, the bivariate and
moment aggregates, the boolean and bitwise aggregates, avg over
intervals, and the scalar string, regular expression, date, math,
bitwise and JSON functions) over the TPC-H SF1 sessions in both
executors: rows, counters, execution mode and memo entry against
presto_tpu's SF1 values frozen in FN_REFERENCE_SF1 (rows in order; ints,
strings, booleans, approx_distinct and approx_percentile exactly, other
floats within QUERY_RTOL, except F4's cancelling moments, held within a
forward-error bound computed from the SF1 columns, fn_tolerances), and
compiled rows against the dynamic ones (columns where presto_tpu's own
two modes differ exempt, FN_MODE_EXEMPT).  One `functions` line a
query: cold, warm and replay times, device busy and idle shares, peak
device bytes, the graph or "DYNAMIC", launches and kernel shapes.
The collections phase runs C1 to C9 of presto_tpu_torch/
collection_queries.py (ARRAY, MAP and ROW values, lambdas, UNNEST over
30,003,005 and 18,001,803 expanded rows, the collection aggregates) on
the same sessions in both executors, a cold and a warm dynamic run and
a build and one replay each: rows (floats within QUERY_RTOL, inside
collection values too), counters, execution mode and memo entry against
presto_tpu's SF1 values (COLL_REFERENCE_SF1); one `collections` line a
query adds the take_rows route of each UNNEST expansion
(unnest_routes), and a `collections_kernels` line must show
fused_group_sums launched on a grouped expansion and block_gather at an
expansion's shape (or the expansion sent flat by take_rows' rules).
The writes phase runs the statement corpus of presto_tpu_torch/
statement_queries.py (D1 to D9: CREATE TABLE AS with range and hash
buckets and sorts, INSERT, a rolled-back and a committed transaction,
DELETE, EXPLAIN, EXPLAIN ANALYZE, the SHOW family, SET SESSION, DROP
TABLE) over the TPC-H SF1 tables, in fresh sessions: twice in "auto"
(the second run's rows and tables identical to the first's), once in
"dynamic", and D2 and D3 once in "compiled", every run but the second
under the capture (each kernel at each new shape against its plain
version): every statement's
rows, write stats and counters and every written table's digest (rows,
column sums, each page's bucket, rows, sort-key sequence and rows as a
multiset) against presto_tpu's SF1 values (WRITE_REFERENCE_SF1); one
`writes` line a statement and run, and a `writes_kernels` line (D1, D4
and D5 must launch fused_group_sums, D3 or D5 block_gather).
The decimals phase runs the decimal corpus of presto_tpu_torch/
decimal_queries.py (N1 to N9: CREATE TABLE AS of the TPC-H money columns
as DECIMAL(12,2), Q1, Q3, Q6 and Q18 over them, casts, an INSERT and a
DELETE, and the statements that raise in presto_tpu) over the TPC-H SF1
tables, in fresh sessions, once in "dynamic", "auto" and "compiled",
every run under the capture: each statement's rows (decimals exactly),
column types, error, execution mode, counters and memo entry against
presto_tpu's SF1 values (DEC_REFERENCE_SF1); one `decimals` line a
statement and mode (ms, launches, shapes, memo entry, and for the
queries a warm profile's busy and idle shares), a
`decimals_segment_sum128` line (the exact Int128 sum's share of N2's
device time) and a `decimals_kernels` line (N7 and NG must launch
fused_group_sums, N5 or N6 block_gather).
The functions_ext phase runs the extended function corpus of
presto_tpu_torch/function_ext_queries.py (E1 to E10: math, CDFs and
inverse CDFs, string distances, VARBINARY hashes over customer JOIN
orders, URLs, zone-less dates, the array and map long tail, IS DISTINCT
FROM, DECIMAL math, and a DOUBLE column divided by 3 as VARCHAR) over
the TPC-H SF1 tables, in fresh sessions, once in "dynamic", "auto" and
"compiled" (E2 once more warm: its replay where the first run built a
graph), every first run under the capture: each query's rows, types,
error, execution mode, counters and memo entry against presto_tpu's SF1
values (FX_REFERENCE_SF1), E1's sine sums against their exact values
(FX_E1_SIN_SF1), E9b's DECIMAL math against Python's decimal
(FX_DECIMAL_SF1); the volatile queries E8 against their properties
(TABLESAMPLE counts within 6 sigma of the binomial mean, random() in
[0, 1), distinct uuids, permutations, two runs that differ); one
`functions_ext` line a query and mode and a `functions_ext_kernels`
line (E1 must launch fused_group_sums, E4 block_gather).  The decimals
phase also holds E10's strings on the card to the CPU's and presto_tpu's
(`division_strings`).
The zones_sketches phase runs presto_tpu_torch/zone_sketch_queries.py
(Z1 to Z5: zone conversions over orders and lineitem, a join filtered
by a zoned wall clock, zoned scalars and a session-zone script; K1 to
K6: approx_set, t-digests, q-digests, array and weighted
approx_percentile, min_by / max_by with a count, approx_most_frequent,
reduce_agg, map_union_sum) at SF1 the same way, each record against
presto_tpu's SF1 values (ZS_REFERENCE_SF1; blobs by their SHA-256),
and Z6's session constants against their properties; a `zones` line
names each zone's TZif file and its SHA-256 (a zone found nowhere fails
the phase), one `zones_sketches` line a query and mode, a
`zones_sketches_kernels` line (Z1, Z2 and K4 must launch
fused_group_sums, Z3 or K5 block_gather) and the phase's seconds beside
its 60 s target (`zones_sketches_total`).
segment_sum is held to bit identity in ten calls and to the correctly
rounded sums on the inputs of Q15 and Q3; the integer
division fault C1, a SELECT without FROM and a DISTINCT aggregate run on
the card against the CPU; a profile of each flagship TPC-H query (Q1,
Q3, Q6, Q18) gives its device busy and idle shares.  No check reads a
time.

Every phase prints one JSON line.  A phase that fails prints one JSON
line with its name, its query, the exception and its traceback's tail
(to stdout and stderr); the other phases still run, and the script then
ends with {"ok": false, "failed": [...]} and exit code 1.  Otherwise its
last lines are its own wall time, the kernels' summary, the card's name
and power limit, and {"ok": true, "device": {...}}.  Without a CUDA
device it exits 2 before printing a result.
"""

import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback

# H100 SXM data sheet (at its 700 W limit): HBM3 bandwidth and the FP64
# rate outside the tensor cores (the kernels here add in f64 on the CUDA
# cores)
HBM_BYTES_PER_S = 3.35e12
F64_FLOPS = 34e12
SF = 1
# fused_group_sums' limits are relative to each group's sum of |x|, the
# scale of a sum's rounding error (a sum whose terms cancel may be far
# smaller than its error bound)
KERNEL_RTOL = 1e-12  # kernel vs plain version, f64: summation order only
# fused_group_sums' kernel and plain version each vs the correctly
# rounded sums: a two-level f64 sum is off by about 1e-14 of its sum of
# |x| (one chain of 2.9M adds, as one index_add_ does, by 2.8e-12)
EXACT_RTOL = 1e-13
QUERY_RTOL = 1e-9    # sums/averages across packages, devices, orders
# fused_group_sums shapes (k, n, G, first element's offset into its
# buffer): Q1 at SF1 (k=15 rows of sums, 4 groups), the executor gate's
# largest group count, the largest and the smallest G of each path at an
# even n, rows that start 8 bytes off a 16-byte boundary, a single group,
# and an empty input
FGS_SHAPES = [(15, 6_000_601, 4, 0), (8, 1_000_003, 4096, 0),
              (4, 1_000_000, 16, 0), (4, 1_000_000, 17, 0),
              (5, 1_000_000, 3, 1), (2, 8_191, 1, 0), (3, 0, 4, 0)]
# the f32-input entry (float32_compute's rows): Q1's compiled shape at
# SF1, its dynamic one at each misalignment a float row can have, both
# paths' edges, and the shapes below one 16-byte vector a row
FGS_SHAPES_F32 = [(15, 6_000_601, 16, 0), (15, 6_000_601, 4, 1),
                  (4, 1_000_000, 16, 2), (4, 1_000_001, 17, 3),
                  (8, 1_000_003, 4096, 1), (5, 1_000_000, 3, 0),
                  (2, 3, 1, 0), (3, 0, 4, 0)]
FGS_REPEATS = 10  # launches a shape whose outputs must be bit-identical
# block_gather shapes (source rows n, words w, indices m, how the sorted
# indices are drawn): the main path's four gathers at SF1 (Q3's orders
# at lineitem first), then edge shapes
BG_SHAPES = [
    ("q3_orders_at_lineitem", 1_500_000, 12, 6_000_601, "uniform"),
    ("q18_orders_at_lineitem", 1_500_000, 11, 6_000_601, "uniform"),
    ("customer_at_orders", 150_000, 4, 1_500_000, "uniform"),
    ("q18_group_keys", 6_000_601, 2, 1_500_000, "uniform"),
    # half the indices dense over the first eighth of the rows (their
    # tiles fit a stage), half sparse over the rest (they do not)
    ("skewed", 8_000_000, 4, 2_000_000, "skewed"),
    ("span_beyond_budget", 16_000_000, 2, 4_096, "uniform"),
    ("m_not_multiple_of_ib", 100_000, 3, 1_000_003, "uniform"),
    ("one_source_row", 1, 5, 5_000, "uniform"),
    ("no_indices", 1_000, 4, 0, "uniform"),
    ("one_index", 1_000, 7, 1, "uniform"),
]
# block_gather's stage bytes, timed at every shape beside the plan's
# own: no stage (every tile reads its rows directly), 8 KB, and the
# largest stage at 4, 2 and 1 blocks an SM (G.bg_stage_cap)
STAGE_SWEEP_FIXED = (0, 8192)
STAGE_SWEEP_RESIDENCIES = (4, 2, 1)
# kernel and index_select timed in turns, this many times each in each
# timing (back-to-back, card alone); the median of each is reported
BG_TURNS = 3
# the card's sleep per queued call when card_ms runs ahead of the host
# (about 100 us at the H100's 1.98 GHz boost clock)
SLEEP_CYCLES_PER_CALL = 200_000
# the captured shapes whose time is compared with index_select's in the
# summary: those whose bound is at least this (ms)
BG_MIN_COMPARED_MS = 0.02
SLICE_QUERIES = tuple(range(1, 23))
# the TPC-H queries profiled warm in the dynamic executor (busy and idle
# shares)
PROFILED_QUERIES = SLICE_QUERIES
DYNAMIC_RUNS = 3  # runs of each query in the dynamic executor
COMPILED_REPLAYS = 3  # replays of each query's graph after its first run
# TPC-DS at a cut depth (the functions_ext phase's time): a cold and a
# warm dynamic run, one replay after the build
DS_DYNAMIC_RUNS = 2
DS_COMPILED_REPLAYS = 1
# the relational corpus (presto_tpu_torch/relational_queries.py): window
# functions (W), set operations and grouping sets (S), FULL and CROSS
# joins (J)
RELATIONAL = ("W1", "W2", "W3", "W4", "W5", "W6", "S1", "S2", "S3", "S4",
              "J1", "J2", "J3")
# the function corpus (presto_tpu_torch/function_queries.py)
FUNCTIONS = tuple(f"F{i}" for i in range(1, 12))
# device operations each function query's profiles list
FN_TOP_KERNELS = 5
# the collection corpus (presto_tpu_torch/collection_queries.py)
COLLECTIONS = tuple(f"C{i}" for i in range(1, 10))
# the collection queries that UNNEST, each with its expanded row count
# read from its own rows (a count(*) over the expansion)
COLL_EXPANSIONS = {"C1": lambda rows: sum(r[1] for r in rows),
                   "C2": lambda rows: sum(r[1] for r in rows),
                   "C3": lambda rows: rows[0][0]}
# the collection queries that group an UNNEST expansion, one of which
# must launch fused_group_sums
COLL_GROUPED_EXPANSIONS = ("C1", "C2")
# runs of each collection query: a cold and a warm one in the dynamic
# executor, a build and one replay in compiled mode (their host work,
# per dictionary entry, is most of a run where they run dynamic)
COLL_DYNAMIC_RUNS = 2
COLL_REPLAYS = 1
# function queries whose compiled rows are held to presto_tpu's dynamic
# rows: presto_tpu's compiled program reassociates width_bucket's
# (x - lo) / (hi - lo) * n into (x - lo) * (n / (hi - lo)) (XLA's
# algebraic simplifier), which moves rows on a bucket's edge into the
# next bucket at SF1 (ROADMAP.md section C); the port computes the
# written formula in both executors
FN_COMPILED_AS_DYNAMIC = {"F9": "presto_tpu's compiled width_bucket is "
                                "reassociated by XLA"}
# the port's CPU run each card run is held against: SF1 where the CPU
# takes a few seconds, SF0.1 elsewhere
CPU_CHECK_SF = {**{q: SF if q in (1, 2, 6, 11, 16, 22) else 0.1
                   for q in SLICE_QUERIES},
                **{n: 0.1 if n in ("W1", "W2") else SF for n in RELATIONAL}}
# queries whose float sums are prefix-sum differences (a window's running
# sum): the card adds them in another order than the CPU (exec/window.py
# fixed_order_cumsum: one fixed order on each, so the card's rows are
# identical from run to run), so they agree with the CPU within
# PREFIX_ULPS_PER_SQRT_ROW * sqrt(n) ulps of the largest prefix (a
# running sum's rounding error grows as a random walk over the n rows it
# adds), computed from the column in the phase
FLOAT_PREFIX_QUERIES = {"W3": ("orders", "o_totalprice")}
PREFIX_ULPS_PER_SQRT_ROW = 1.0
# the relational queries whose profile lists the top device operations
RELATIONAL_TOP = ("W1", "J1", "S2")
# presto_tpu's memo entry for each query run once at SF1 on the CPU
# (`python -m tests.test_torch_compiled 1 Q`): three queries trip a
# guard there; compiled mode on the card must leave the same entries
REFERENCE_MEMO_SF1 = {**{q: "DYNAMIC" if q in (9, 13, 16) else "executable"
                         for q in SLICE_QUERIES},
                      # the relational corpus (`python -m
                      # tests.test_torch_setops_joins 1 NAME`)
                      **{name: "executable" for name in RELATIONAL}}
# the counters of ordering-aware execution and dynamic filtering in
# QueryStats (in the order of presto_tpu_torch.exec.executor
# .SORT_STATS_KEYS), presto_tpu's for each query run once at SF1
# on the CPU in each executor (`python -m tests.test_torch_compiled 1 Q`,
# one query a process; the port's CPU run gave the same for all 22):
# "compiled" is the default mode's first run, a tripped guard's dynamic
# rerun included (Q9, Q13, Q16); the card must give the same
REFERENCE_COUNTERS_SF1 = {
    1: {"dynamic": [2, 1, 0, 0, 0, 0, 0],
        "compiled": [0, 1, 0, 0, 0, 0, 0]},
    2: {"dynamic": [3, 3, 0, 0, 2, 2, 1432244],
        "compiled": [3, 3, 0, 0, 2, 2, 0]},
    3: {"dynamic": [4, 2, 0, 0, 2, 2, 6569069],
        "compiled": [4, 2, 0, 0, 2, 2, 0]},
    4: {"dynamic": [5, 1, 0, 0, 0, 0, 0],
        "compiled": [3, 1, 0, 0, 0, 0, 0]},
    5: {"dynamic": [6, 0, 0, 0, 1, 1, 4809915],
        "compiled": [4, 0, 0, 0, 1, 1, 0]},
    6: {"dynamic": [0, 0, 0, 0, 0, 0, 0],
        "compiled": [0, 0, 0, 0, 0, 0, 0]},
    7: {"dynamic": [6, 0, 0, 0, 3, 3, 0],
        "compiled": [6, 0, 0, 0, 3, 3, 0]},
    8: {"dynamic": [6, 0, 0, 0, 3, 3, 7275856],
        "compiled": [3, 0, 0, 0, 3, 3, 0]},
    9: {"dynamic": [8, 1, 0, 0, 1, 1, 0],
        "compiled": [14, 1, 0, 0, 2, 2, 0]},
    10: {"dynamic": [6, 0, 0, 0, 2, 2, 5751803],
         "compiled": [6, 0, 0, 0, 2, 2, 0]},
    11: {"dynamic": [1, 2, 0, 0, 2, 2, 1532640],
         "compiled": [1, 2, 0, 0, 2, 2, 766320]},
    12: {"dynamic": [6, 0, 0, 0, 1, 1, 1469369],
         "compiled": [4, 0, 0, 0, 1, 1, 0]},
    13: {"dynamic": [6, 2, 0, 0, 0, 0, 0],
         "compiled": [12, 4, 0, 0, 0, 0, 0]},
    14: {"dynamic": [0, 0, 0, 0, 1, 1, 0],
         "compiled": [0, 0, 0, 0, 1, 1, 0]},
    15: {"dynamic": [8, 0, 0, 0, 0, 0, 0],
         "compiled": [8, 0, 0, 0, 0, 0, 0]},
    16: {"dynamic": [3, 2, 0, 0, 1, 1, 679688],
         "compiled": [6, 4, 0, 0, 2, 2, 679688]},
    17: {"dynamic": [4, 1, 0, 0, 1, 1, 5995018],
         "compiled": [4, 1, 0, 0, 1, 1, 0]},
    18: {"dynamic": [11, 3, 1, 0, 4, 4, 7500090],
         "compiled": [7, 4, 0, 0, 4, 4, 0]},
    19: {"dynamic": [0, 0, 0, 0, 0, 0, 0],
         "compiled": [0, 0, 0, 0, 0, 0, 0]},
    20: {"dynamic": [9, 0, 0, 0, 1, 1, 791336],
         "compiled": [9, 0, 0, 0, 1, 1, 0]},
    21: {"dynamic": [11, 1, 0, 0, 1, 1, 5755660],
         "compiled": [8, 1, 0, 0, 1, 1, 0]},
    22: {"dynamic": [5, 1, 0, 0, 0, 0, 0],
         "compiled": [3, 1, 0, 0, 0, 0, 0]},
    # the relational corpus, the same way (`python -m
    # tests.test_torch_setops_joins 1 NAME`, one query a process)
    "W1": {"dynamic": [2, 1, 0, 0, 0, 0, 0],
           "compiled": [3, 0, 0, 0, 0, 0, 0]},
    "W2": {"dynamic": [2, 1, 0, 0, 0, 0, 0],
           "compiled": [0, 1, 0, 0, 0, 0, 0]},
    "W3": {"dynamic": [1, 0, 0, 0, 0, 0, 0],
           "compiled": [1, 0, 0, 0, 0, 0, 0]},
    "W4": {"dynamic": [1, 0, 0, 0, 0, 0, 0],
           "compiled": [1, 0, 0, 0, 0, 0, 0]},
    "W5": {"dynamic": [1, 0, 0, 0, 0, 0, 0],
           "compiled": [1, 0, 0, 0, 0, 0, 0]},
    "W6": {"dynamic": [1, 0, 0, 0, 0, 0, 0],
           "compiled": [1, 0, 0, 0, 0, 0, 0]},
    "S1": {"dynamic": [2, 1, 0, 0, 0, 0, 0],
           "compiled": [0, 1, 0, 0, 0, 0, 0]},
    "S2": {"dynamic": [5, 0, 0, 0, 0, 0, 0],
           "compiled": [1, 0, 0, 0, 0, 0, 0]},
    "S3": {"dynamic": [3, 2, 0, 0, 0, 0, 0],
           "compiled": [3, 2, 0, 0, 0, 0, 0]},
    "S4": {"dynamic": [3, 2, 0, 0, 0, 0, 0],
           "compiled": [3, 2, 0, 0, 0, 0, 0]},
    "J1": {"dynamic": [6, 0, 0, 0, 0, 0, 0],
           "compiled": [6, 0, 0, 0, 0, 0, 0]},
    "J2": {"dynamic": [1, 0, 0, 0, 0, 0, 0],
           "compiled": [1, 0, 0, 0, 0, 0, 0]},
    "J3": {"dynamic": [0, 0, 0, 0, 0, 0, 0],
           "compiled": [0, 0, 0, 0, 0, 0, 0]}}
# the queries these features touch, run again with both switched off
# (ordering_aware_execution and dynamic_filtering) and with each alone:
# the same rows, and nothing elided, memoized or pruned by what is off
SWITCHED_OFF_QUERIES = (3, 5, 8, 17, 18)
SWITCHES_OFF = {
    "both_off": {"ordering_aware_execution": False,
                 "dynamic_filtering": False},
    "ordering_off": {"ordering_aware_execution": False},
    "filtering_off": {"dynamic_filtering": False}}
# the counters (positions in SORT_STATS_KEYS) each switch leaves at 0
SWITCH_ZEROES = {"ordering_aware_execution": (1, 2, 3),
                 "dynamic_filtering": (4, 5, 6)}
# the memo phase: distinct TPC-H texts, as qgen's streams send them (Q1's
# delta, Q6's year, discount and quantity), in one session whose memo
# may hold MEMO_BOUND_BYTES; each is checked against the dynamic run
MEMO_BOUND_BYTES = 2 << 30
MEMO_TEXTS = 24
# each query's ORDER BY as (output column, 1 ascending or -1
# descending), and its LIMIT (tests/tpch_queries.py,
# presto_tpu_torch/relational_queries.py)
ORDER_KEYS = {
    1: ((0, 1), (1, 1)), 2: ((0, -1), (2, 1), (1, 1), (3, 1)),
    3: ((1, -1), (2, 1)), 4: ((0, 1),), 5: ((1, -1),),
    7: ((0, 1), (1, 1), (2, 1)), 8: ((0, 1),), 9: ((0, 1), (1, -1)),
    10: ((2, -1),), 11: ((1, -1),), 12: ((0, 1),), 13: ((1, -1), (0, -1)),
    15: ((0, 1),), 16: ((3, -1), (0, 1), (1, 1), (2, 1)),
    18: ((4, -1), (3, 1)), 20: ((0, 1),), 21: ((1, -1), (0, 1)),
    22: ((0, 1),),
    "W1": ((0, 1),), "W2": ((0, 1),), "W3": ((0, 1), (1, 1)),
    "W4": ((0, 1),), "W5": ((0, 1), (1, 1)), "W6": ((0, 1),),
    "S1": ((0, 1),), "S2": ((0, 1), (1, 1)), "J2": ((0, 1), (1, 1))}
LIMITS = {2: 100, 3: 10, 10: 20, 18: 100, 21: 100,
          "W3": 100, "W4": 80, "W5": 100, "W6": 100}
# queries whose float segment_sum input is held to bit identity and to
# the correctly rounded sums
SEGMENT_SUM_QUERIES = (15, 3)
SEGMENT_SUM_REPEATS = 10
# the rest of the SQL surface this slice adds, run on the card against
# the CPU: fault C1 (integer division and modulo by zero), Values and a
# DISTINCT aggregate
SURFACE = {
    "c1": ("SELECT o_custkey, o_custkey / 0, o_custkey % 0, "
           "-o_custkey / 0, o_shippriority / 0 FROM orders "
           "ORDER BY o_orderkey LIMIT 3"),
    "values": "SELECT 1, 'a'",
    "count_distinct": ("SELECT o_orderpriority, count(DISTINCT o_custkey), "
                       "count(*) FROM orders GROUP BY 1 ORDER BY 1"),
}


# TPC-DS (presto_tpu_torch/tpcds_queries.py): all 99 queries at SF1 in
# both executors, the tpcds phase
DS_QUERIES = tuple(range(1, 100))
# the port's CPU run (dynamic executor) each card run is held against,
# and the card reruns the query there: SF0.1 for all 99 (their CPU runs
# took 40.7 s together beside an H100, q14 the longest at 20.2 s)
DS_CPU_CHECK_SF = 0.1
# presto_tpu's counters and memo entry for each TPC-DS query at SF1 on
# the CPU (`python -m tests.test_torch_tpcds_q1 1 Q <cache dir>`, one
# query a process, q1 to q99 through the four files), keyed "ds<Q>":
# {"dynamic": [...], "compiled": [...], "memo": [entry]} in
# SORT_STATS_KEYS order ("compiled" is the "auto" run's, a tripped
# guard's dynamic rerun included; memo [] where the static executor
# fell back to the dynamic one and memoized nothing)
DS_REFERENCE_SF1 = {
    1: {"dynamic": [9, 1, 0, 0, 2, 2, 460692],
        "compiled": [8, 0, 0, 0, 2, 2, 0], "memo": ["executable"]},
    2: {"dynamic": [11, 0, 0, 0, 0, 0, 0],
        "compiled": [11, 0, 0, 0, 0, 0, 0], "memo": []},
    3: {"dynamic": [3, 0, 0, 0, 2, 2, 2857453],
        "compiled": [3, 0, 0, 0, 2, 2, 0], "memo": ["executable"]},
    4: {"dynamic": [52, 0, 0, 0, 30, 30, 18150960],
        "compiled": [52, 0, 0, 0, 30, 30, 18150960], "memo": []},
    5: {"dynamic": [2, 1, 0, 0, 0, 0, 0],
        "compiled": [3, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    6: {"dynamic": [9, 1, 0, 0, 1, 1, 2831411],
        "compiled": [6, 0, 0, 0, 1, 1, 0], "memo": ["executable"]},
    7: {"dynamic": [3, 0, 0, 0, 1, 1, 2835448],
        "compiled": [6, 0, 0, 0, 2, 2, 2835448], "memo": ["DYNAMIC"]},
    9: {"dynamic": [0, 0, 0, 0, 0, 0, 0],
        "compiled": [0, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    10: {"dynamic": [12, 0, 0, 0, 4, 4, 4747225],
         "compiled": [12, 0, 0, 0, 4, 4, 0], "memo": ["executable"]},
    11: {"dynamic": [26, 0, 0, 0, 12, 12, 8638256],
         "compiled": [26, 0, 0, 0, 12, 12, 8638256], "memo": []},
    12: {"dynamic": [3, 0, 0, 0, 1, 1, 509248],
         "compiled": [6, 0, 0, 0, 2, 2, 509248], "memo": ["DYNAMIC"]},
    13: {"dynamic": [0, 0, 0, 0, 1, 1, 0],
         "compiled": [0, 0, 0, 0, 2, 2, 0], "memo": ["DYNAMIC"]},
    14: {"dynamic": [270, 59, 29, 0, 150, 150, 85277285],
         "compiled": [567, 89, 29, 0, 300, 300, 115519085], "memo": ["DYNAMIC"]},
    15: {"dynamic": [3, 0, 0, 0, 1, 1, 1369340],
         "compiled": [3, 0, 0, 0, 1, 1, 0], "memo": ["executable"]},
    16: {"dynamic": [6, 2, 0, 0, 1, 1, 1294696],
         "compiled": [12, 4, 0, 0, 2, 2, 1294696], "memo": ["DYNAMIC"]},
    17: {"dynamic": [9, 0, 0, 0, 2, 2, 1467499],
         "compiled": [18, 0, 0, 0, 4, 4, 1467499], "memo": ["DYNAMIC"]},
    18: {"dynamic": [14, 0, 0, 0, 5, 5, 6649810],
         "compiled": [28, 0, 0, 0, 10, 10, 6649810], "memo": ["DYNAMIC"]},
    19: {"dynamic": [3, 0, 0, 0, 1, 1, 2833133],
         "compiled": [3, 0, 0, 0, 1, 1, 0], "memo": ["executable"]},
    20: {"dynamic": [3, 0, 0, 0, 1, 1, 1020348],
         "compiled": [6, 0, 0, 0, 2, 2, 1020348], "memo": ["DYNAMIC"]},
    21: {"dynamic": [3, 0, 0, 0, 1, 1, 22680000],
         "compiled": [6, 0, 0, 0, 2, 2, 22680000], "memo": ["DYNAMIC"]},
    22: {"dynamic": [14, 0, 0, 0, 10, 10, 94050000],
         "compiled": [28, 0, 0, 0, 20, 20, 94050000], "memo": ["DYNAMIC"]},
    23: {"dynamic": [24, 0, 0, 0, 12, 12, 6730760],
         "compiled": [24, 0, 0, 0, 12, 12, 2302156], "memo": ["executable"]},
    24: {"dynamic": [12, 1, 1, 1, 0, 0, 0],
         "compiled": [23, 3, 1, 1, 0, 0, 0], "memo": ["DYNAMIC"]},
    25: {"dynamic": [9, 0, 0, 0, 2, 2, 1527584],
         "compiled": [18, 0, 0, 0, 4, 4, 1527584], "memo": ["DYNAMIC"]},
    27: {"dynamic": [3, 0, 0, 0, 1, 1, 2835448],
         "compiled": [6, 0, 0, 0, 2, 2, 2835448], "memo": ["DYNAMIC"]},
    28: {"dynamic": [4, 0, 0, 0, 0, 0, 0],
         "compiled": [4, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    29: {"dynamic": [6, 0, 0, 0, 1, 1, 268649],
         "compiled": [12, 0, 0, 0, 2, 2, 268649], "memo": ["DYNAMIC"]},
    30: {"dynamic": [10, 0, 0, 0, 2, 2, 115146],
         "compiled": [8, 0, 0, 0, 2, 2, 0], "memo": ["executable"]},
    31: {"dynamic": [28, 0, 0, 0, 12, 12, 0],
         "compiled": [28, 0, 0, 0, 12, 12, 0], "memo": []},
    32: {"dynamic": [4, 1, 0, 0, 3, 3, 2697976],
         "compiled": [4, 1, 0, 0, 3, 3, 0], "memo": ["executable"]},
    34: {"dynamic": [4, 2, 0, 0, 2, 2, 2151002],
         "compiled": [10, 2, 0, 0, 4, 4, 2151002], "memo": ["DYNAMIC"]},
    35: {"dynamic": [12, 0, 0, 0, 3, 3, 4283047],
         "compiled": [12, 0, 0, 0, 3, 3, 0], "memo": ["executable"]},
    36: {"dynamic": [8, 0, 0, 0, 9, 9, 6908910],
         "compiled": [4, 0, 0, 0, 9, 9, 0], "memo": ["executable"]},
    37: {"dynamic": [6, 0, 0, 0, 2, 2, 24093157],
         "compiled": [6, 0, 0, 0, 2, 2, 24093157], "memo": []},
    38: {"dynamic": [12, 2, 0, 0, 4, 4, 4028498],
         "compiled": [12, 2, 0, 0, 4, 4, 0], "memo": ["executable"]},
    39: {"dynamic": [8, 0, 0, 0, 6, 6, 37620000],
         "compiled": [8, 0, 0, 0, 6, 6, 37620000], "memo": []},
    40: {"dynamic": [6, 0, 0, 0, 1, 1, 1393240],
         "compiled": [6, 0, 0, 0, 1, 1, 0], "memo": ["executable"]},
    41: {"dynamic": [6, 2, 0, 0, 0, 0, 0],
         "compiled": [5, 1, 0, 0, 0, 0, 0], "memo": ["executable"]},
    42: {"dynamic": [3, 0, 0, 0, 1, 1, 2832692],
         "compiled": [3, 0, 0, 0, 1, 1, 0], "memo": ["executable"]},
    43: {"dynamic": [3, 0, 0, 0, 2, 2, 2302970],
         "compiled": [1, 0, 0, 0, 2, 2, 0], "memo": ["executable"]},
    44: {"dynamic": [14, 0, 0, 0, 0, 0, 0],
         "compiled": [14, 0, 0, 0, 0, 0, 0], "memo": []},
    45: {"dynamic": [7, 1, 0, 0, 1, 1, 683880],
         "compiled": [7, 1, 0, 0, 1, 1, 0], "memo": ["executable"]},
    46: {"dynamic": [1, 2, 0, 0, 3, 3, 2756801],
         "compiled": [3, 0, 0, 0, 3, 3, 0], "memo": ["executable"]},
    47: {"dynamic": [13, 0, 0, 0, 9, 9, 6615528],
         "compiled": [13, 0, 0, 0, 9, 9, 6615528], "memo": []},
    48: {"dynamic": [0, 0, 0, 0, 1, 1, 0],
         "compiled": [0, 0, 0, 0, 2, 2, 0], "memo": ["DYNAMIC"]},
    50: {"dynamic": [6, 0, 0, 0, 1, 1, 283135],
         "compiled": [6, 0, 0, 0, 1, 1, 0], "memo": ["executable"]},
    51: {"dynamic": [11, 0, 0, 0, 2, 2, 2879094],
         "compiled": [11, 0, 0, 0, 2, 2, 0], "memo": ["executable"]},
    53: {"dynamic": [3, 0, 0, 0, 1, 1, 2021322],
         "compiled": [6, 0, 0, 0, 2, 2, 2021322], "memo": ["DYNAMIC"]},
    54: {"dynamic": [20, 0, 0, 0, 0, 0, 0],
         "compiled": [40, 0, 0, 0, 0, 0, 0], "memo": ["DYNAMIC"]},
    55: {"dynamic": [3, 0, 0, 0, 1, 1, 2833817],
         "compiled": [3, 0, 0, 0, 1, 1, 0], "memo": ["executable"]},
    57: {"dynamic": [13, 0, 0, 0, 9, 9, 3301308],
         "compiled": [13, 0, 0, 0, 9, 9, 3301308], "memo": []},
    58: {"dynamic": [13, 0, 0, 0, 3, 3, 4955658],
         "compiled": [13, 0, 0, 0, 3, 3, 0], "memo": ["executable"]},
    59: {"dynamic": [13, 0, 0, 0, 2, 2, 0],
         "compiled": [13, 0, 0, 0, 2, 2, 0], "memo": []},
    61: {"dynamic": [1, 0, 0, 0, 4, 4, 5339724],
         "compiled": [2, 0, 0, 0, 8, 8, 5339724], "memo": ["DYNAMIC"]},
    62: {"dynamic": [3, 0, 0, 0, 4, 4, 575657],
         "compiled": [1, 0, 0, 0, 4, 4, 0], "memo": ["executable"]},
    63: {"dynamic": [3, 0, 0, 0, 1, 1, 1744048],
         "compiled": [4, 0, 0, 0, 2, 2, 1744048], "memo": ["DYNAMIC"]},
    64: {"dynamic": [28, 2, 2, 0, 2, 2, 844],
         "compiled": [58, 2, 2, 0, 4, 4, 844], "memo": ["DYNAMIC"]},
    65: {"dynamic": [7, 3, 0, 0, 2, 2, 4605940],
         "compiled": [8, 0, 0, 0, 2, 2, 0], "memo": ["executable"]},
    66: {"dynamic": [7, 0, 0, 0, 4, 4, 2014476],
         "compiled": [14, 0, 0, 0, 8, 8, 2014476], "memo": ["DYNAMIC"]},
    67: {"dynamic": [17, 0, 0, 0, 27, 27, 23340114],
         "compiled": [13, 0, 0, 0, 27, 27, 0], "memo": ["executable"]},
    68: {"dynamic": [1, 2, 0, 0, 2, 2, 2852162],
         "compiled": [3, 0, 0, 0, 2, 2, 0], "memo": ["executable"]},
    69: {"dynamic": [9, 0, 0, 0, 3, 3, 3515017],
         "compiled": [9, 0, 0, 0, 3, 3, 0], "memo": ["executable"]},
    70: {"dynamic": [23, 0, 0, 0, 12, 12, 13817820],
         "compiled": [36, 0, 0, 0, 24, 24, 13817820], "memo": ["DYNAMIC"]},
    72: {"dynamic": [6, 0, 0, 0, 3, 3, 1419932],
         "compiled": [6, 0, 0, 0, 3, 3, 1419932], "memo": []},
    73: {"dynamic": [4, 2, 0, 0, 2, 2, 2171898],
         "compiled": [10, 2, 0, 0, 4, 4, 2171898], "memo": ["DYNAMIC"]},
    74: {"dynamic": [26, 0, 0, 0, 12, 12, 8638256],
         "compiled": [26, 0, 0, 0, 12, 12, 8638256], "memo": []},
    75: {"dynamic": [31, 3, 3, 2, 6, 6, 9117796],
         "compiled": [31, 3, 3, 2, 6, 6, 9117796], "memo": []},
    76: {"dynamic": [3, 0, 0, 0, 6, 6, 0],
         "compiled": [3, 0, 0, 0, 6, 6, 0], "memo": ["executable"]},
    77: {"dynamic": [62, 0, 0, 0, 18, 18, 16353534],
         "compiled": [24, 0, 0, 0, 18, 18, 0], "memo": ["executable"]},
    78: {"dynamic": [25, 0, 0, 0, 1, 1, 2302970],
         "compiled": [25, 0, 0, 0, 1, 1, 2302970], "memo": []},
    79: {"dynamic": [1, 2, 0, 0, 3, 3, 2743703],
         "compiled": [3, 0, 0, 0, 3, 3, 0], "memo": ["executable"]},
    80: {"dynamic": [47, 6, 6, 0, 9, 9, 4542285],
         "compiled": [86, 6, 6, 0, 18, 18, 4542285], "memo": ["DYNAMIC"]},
    81: {"dynamic": [10, 0, 0, 0, 3, 3, 293421],
         "compiled": [8, 0, 0, 0, 3, 3, 0], "memo": ["executable"]},
    82: {"dynamic": [6, 0, 0, 0, 3, 3, 25471829],
         "compiled": [6, 0, 0, 0, 3, 3, 25471829], "memo": []},
    83: {"dynamic": [31, 0, 0, 0, 8, 8, 438168],
         "compiled": [31, 0, 0, 0, 8, 8, 0], "memo": ["executable"]},
    84: {"dynamic": [4, 0, 0, 0, 1, 1, 96049],
         "compiled": [4, 0, 0, 0, 1, 1, 0], "memo": ["executable"]},
    85: {"dynamic": [9, 0, 0, 0, 1, 1, 0],
         "compiled": [7, 0, 0, 0, 1, 1, 0], "memo": ["executable"]},
    86: {"dynamic": [8, 0, 0, 0, 6, 6, 1728372],
         "compiled": [4, 0, 0, 0, 6, 6, 0], "memo": ["executable"]},
    87: {"dynamic": [12, 2, 0, 0, 4, 4, 4028498],
         "compiled": [24, 4, 0, 0, 8, 8, 4028498], "memo": ["DYNAMIC"]},
    88: {"dynamic": [0, 0, 0, 0, 4, 4, 5712379],
         "compiled": [0, 0, 0, 0, 4, 4, 0], "memo": ["executable"]},
    89: {"dynamic": [3, 0, 0, 0, 1, 1, 2591910],
         "compiled": [6, 0, 0, 0, 2, 2, 2591910], "memo": ["DYNAMIC"]},
    90: {"dynamic": [0, 0, 0, 0, 4, 4, 1311992],
         "compiled": [0, 0, 0, 0, 8, 8, 1311992], "memo": ["DYNAMIC"]},
    91: {"dynamic": [3, 0, 0, 0, 2, 2, 237729],
         "compiled": [1, 0, 0, 0, 2, 2, 0], "memo": ["executable"]},
    92: {"dynamic": [4, 1, 0, 0, 2, 2, 1365944],
         "compiled": [4, 1, 0, 0, 2, 2, 0], "memo": ["executable"]},
    93: {"dynamic": [6, 0, 0, 0, 0, 0, 0],
         "compiled": [6, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    94: {"dynamic": [6, 2, 0, 0, 1, 1, 646232],
         "compiled": [12, 4, 0, 0, 2, 2, 646232], "memo": ["DYNAMIC"]},
    95: {"dynamic": [15, 3, 0, 0, 2, 2, 1033944],
         "compiled": [30, 6, 0, 0, 4, 4, 1033944], "memo": ["DYNAMIC"]},
    96: {"dynamic": [0, 0, 0, 0, 2, 2, 2871133],
         "compiled": [0, 0, 0, 0, 2, 2, 0], "memo": ["executable"]},
    97: {"dynamic": [10, 0, 0, 0, 2, 2, 3452374],
         "compiled": [10, 0, 0, 0, 2, 2, 0], "memo": ["executable"]},
    98: {"dynamic": [3, 0, 0, 0, 1, 1, 2040732],
         "compiled": [6, 0, 0, 0, 2, 2, 2040732], "memo": ["DYNAMIC"]},
    99: {"dynamic": [3, 0, 0, 0, 4, 4, 1149545],
         "compiled": [1, 0, 0, 0, 4, 4, 0], "memo": ["executable"]},
}
# the queries presto_tpu could not run at SF1 on the CPU that froze these
# values: in the executors named, one allocation past the 20 GB of
# address space that run gave each process (q26's, for one, is
# segment_sum's float32 one-hot of 1,441,548 rows by 3,766 groups,
# presto_tpu/exec/kernels.py:459-470).  Their values are at SF0.1
# (`python -m tests.test_torch_tpcds_q1 0.1 Q`), and the card reruns each
# there in both executors to be held to them
DS_REFERENCE_SF01_REASON = {
    26: "dynamic and compiled: one allocation of 21,715,479,072 bytes",
    33: "dynamic and compiled: one allocation of 25,529,325,504 bytes",
    49: "dynamic: one allocation of 27,237,100,224 bytes",
    52: "dynamic: one allocation of 38,459,154,208 bytes",
    56: "dynamic and compiled: one allocation of 11,615,238,144 bytes",
    60: "dynamic and compiled: one allocation of 20,427,493,472 bytes",
    71: "dynamic: one allocation of 11,534,576,768 bytes",
}
DS_REFERENCE_SF01 = {
    8: {"dynamic": [13, 0, 0, 0, 1, 1, 273610],
        "compiled": [13, 0, 0, 0, 1, 1, 273610], "memo": []},
    26: {"dynamic": [3, 0, 0, 0, 1, 1, 142064],
         "compiled": [1, 0, 0, 0, 1, 1, 0], "memo": ["executable"]},
    33: {"dynamic": [3, 0, 0, 0, 3, 3, 449626],
         "compiled": [3, 0, 0, 0, 3, 3, 0], "memo": ["executable"]},
    49: {"dynamic": [20, 0, 0, 0, 0, 0, 0],
         "compiled": [14, 0, 0, 0, 0, 0, 0], "memo": ["executable"]},
    52: {"dynamic": [3, 0, 0, 0, 1, 1, 283213],
         "compiled": [3, 0, 0, 0, 1, 1, 0], "memo": ["executable"]},
    56: {"dynamic": [3, 0, 0, 0, 3, 3, 491522],
         "compiled": [1, 0, 0, 0, 3, 3, 0], "memo": ["executable"]},
    60: {"dynamic": [3, 0, 0, 0, 3, 3, 451729],
         "compiled": [1, 0, 0, 0, 3, 3, 0], "memo": ["executable"]},
    71: {"dynamic": [3, 0, 0, 0, 3, 3, 496036],
         "compiled": [3, 0, 0, 0, 3, 3, 0], "memo": ["executable"]},
}
# the queries presto_tpu itself cannot run at SF1, with its error there
# (the same in both executors): the card must raise it at SF1 in both,
# and runs the query at SF0.1 for its rows, counters and memo entry
# (DS_REFERENCE_SF01)
DS_RAISES_AT_SF1 = {
    8: "ExecutionError: cross join too large: 143781 x 9707",
}
# the queries whose graph device ms and pool bytes the summary reports
# beside their dynamic busy ms (the largest static capacities)
DS_GRAPH_REPORT = (22, 29, 4)
# replays whose top device operations the summary lists
DS_TOP_REPLAYS = 3
# the queries profiled in both executors (busy and idle shares, top
# kernels): DS_GRAPH_REPORT's; the other queries' lines carry their
# CUDA-event and host times only (the phase's depth, cut for the
# functions_ext, zones_sketches and geo_ml_f32 phases' time: q64, q23,
# q24, q72, q78, q95 and then q14 and q4, whose profiles took 26.4 s and
# 13.5 s, were profiled before)
DS_PROFILED = (22, 29)
# presto_tpu's values for the function corpus at SF1 on the CPU, in each
# executor (`python -m tests.test_torch_functions_corpus 1 NAME`, one
# query a process): rows in order (the compiled rows only where they
# differ from the dynamic ones), the counters in SORT_STATS_KEYS order
# ("compiled" is the default mode's first run, a tripped guard's dynamic
# rerun included), the execution mode and memo entry
FN_REFERENCE_SF1 = {
    "F1": {
        "dynamic": {"counters": [2, 1, 0, 0, 0, 0, 0], "rows": [
            ['A', 'F', 665024, 201491, 1364130, 1224, 1497096, 37139128.0,
             7259822872861228177, 1497115],
            ['N', 'F', 32416, 35446, 38773, 29, 38288, 1013152.0,
             -6438796759407566284, 39234],
            ['N', 'O', 773205, 201624, 2787159, 1230, 2986792, 73607424.0,
             4216096910704188318, 2966674],
            ['R', 'F', 665578, 201503, 1356601, 1224, 1504248, 37127024.0,
             -1761984145819709982, 1497578]]},
        "compiled": {"mode": "compiled", "memo": "executable",
                     "counters": [0, 1, 0, 0, 0, 0, 0]}},
    "F2": {
        "dynamic": {"counters": [3, 0, 0, 0, 0, 0, 0], "rows": [
            [75281, 46, 44, 40, 44],
            [141335, 42, 40, 42, 42],
            [121295, 42, 40, 48, 40],
            [146756, 42, 30, 42, 40],
            [6905, 39, 35, 35, 39],
            [75878, 39, 37, 40, 39],
            [11891, 42, 30, 44, 38],
            [14291, 39, 37, 37, 38],
            [24194, 39, 42, 39, 38],
            [29171, 42, 42, 35, 38],
            [38633, 37, 37, 30, 38],
            [74162, 40, 40, 40, 38],
            [92735, 46, 40, 37, 38],
            [120176, 39, 42, 42, 38],
            [44066, 42, 40, 39, 37],
            [55403, 32, 33, 35, 37],
            [74036, 35, 37, 30, 37],
            [85169, 39, 37, 33, 37],
            [96044, 40, 40, 35, 37],
            [102428, 44, 35, 35, 37],
            [130121, 39, 39, 39, 37],
            [7994, 37, 35, 39, 36],
            [8843, 33, 39, 37, 36],
            [12068, 33, 33, 37, 36],
            [16826, 32, 30, 42, 36],
            [24107, 39, 37, 30, 36],
            [28619, 37, 37, 33, 36],
            [33914, 39, 40, 37, 36],
            [42008, 30, 33, 39, 36],
            [54953, 39, 35, 37, 36],
            [58937, 37, 37, 44, 36],
            [67067, 33, 32, 44, 36],
            [68093, 39, 37, 35, 36],
            [106271, 35, 37, 33, 36],
            [112037, 39, 35, 35, 36],
            [130886, 35, 30, 42, 36],
            [133427, 39, 33, 33, 36],
            [139949, 37, 39, 40, 36],
            [53, 37, 33, 37, 35],
            [3995, 33, 39, 33, 35],
            [4814, 37, 39, 35, 35],
            [16454, 35, 30, 33, 35],
            [25601, 35, 33, 40, 35],
            [26264, 30, 37, 28, 35],
            [27431, 37, 37, 42, 35],
            [31076, 39, 35, 35, 35],
            [36545, 40, 35, 32, 35],
            [40553, 37, 37, 35, 35],
            [41063, 32, 35, 35, 35],
            [45839, 32, 32, 35, 35],
            [48149, 30, 33, 33, 35],
            [48221, 40, 42, 32, 35],
            [51734, 35, 28, 37, 35],
            [57860, 39, 35, 37, 35],
            [62765, 35, 33, 39, 35],
            [67523, 30, 35, 35, 35],
            [74657, 39, 37, 40, 35],
            [79964, 42, 30, 33, 35],
            [81578, 32, 32, 37, 35],
            [81743, 37, 37, 39, 35],
            [83822, 35, 39, 40, 35],
            [83984, 39, 33, 40, 35],
            [90101, 40, 37, 39, 35],
            [90125, 28, 33, 37, 35],
            [91142, 37, 33, 42, 35],
            [96176, 42, 37, 37, 35],
            [107684, 39, 33, 40, 35],
            [121301, 35, 27, 32, 35],
            [126212, 40, 30, 44, 35],
            [6572, 39, 30, 33, 34],
            [7103, 28, 33, 35, 34],
            [13319, 37, 30, 35, 34],
            [14534, 37, 37, 35, 34],
            [16736, 35, 33, 39, 34],
            [18308, 35, 33, 32, 34],
            [27680, 33, 37, 33, 34],
            [28340, 39, 37, 40, 34],
            [28364, 37, 30, 37, 34],
            [28784, 28, 35, 33, 34],
            [29162, 37, 35, 35, 34],
            [30629, 28, 39, 28, 34],
            [31148, 37, 30, 40, 34],
            [33101, 35, 33, 32, 34],
            [33197, 37, 30, 35, 34],
            [33236, 40, 32, 35, 34],
            [36194, 32, 33, 37, 34],
            [37700, 35, 30, 35, 34],
            [38528, 33, 32, 33, 34],
            [39758, 35, 33, 37, 34],
            [40811, 35, 28, 35, 34],
            [47066, 35, 33, 35, 34],
            [50045, 27, 35, 30, 34],
            [53381, 37, 37, 32, 34],
            [58697, 42, 37, 40, 34],
            [60686, 35, 30, 35, 34],
            [68705, 35, 35, 35, 34],
            [74126, 35, 35, 37, 34],
            [77198, 33, 27, 33, 34],
            [78062, 40, 37, 35, 34],
            [79223, 37, 30, 35, 34]]},
        "compiled": {"mode": "compiled", "memo": "executable",
                     "counters": [3, 0, 0, 0, 0, 0, 0]}},
    "F3": {
        "dynamic": {"counters": [2, 1, 0, 0, 0, 0, 0], "rows": [
            ['AIR', 36721.880000000005, 50.0, 869058, 'affix foxes run after',
             'COLLECT COD', 'F', 857885],
            ['FOB', 36689.93, 50.0, 3799300, 'nag above beyond realms',
             'COLLECT COD', 'F', 857484],
            ['MAIL', 36709.86, 50.0, 3826915, 'about accounts special beyond',
             'TAKE BACK RETURN', 'F', 858774],
            ['RAIL', 36703.38, 50.0, 5574472,
             'dependencies detect sleep beans', 'NONE', 'O', 856145],
            ['REG AIR', 36667.37, 50.0, 86472, 'before along courts final',
             'COLLECT COD', 'O', 856306],
            ['SHIP', 36707.62, 50.0, 790050, 'dugouts accounts after sublate',
             'TAKE BACK RETURN', 'F', 857801],
            ['TRUCK', 36610.74, 50.0, 2538887, 'along between haggle boost',
             'DELIVER IN PERSON', 'F', 856206]]},
        "compiled": {"mode": "compiled", "memo": "executable",
                     "counters": [0, 1, 0, 0, 0, 0, 0]}},
    "F4": {
        "dynamic": {"counters": [2, 1, 0, 0, 0, 0, 0], "rows": [
            ['A', 0.9288029030982244, 311971.0903493438, 311970.8819678298,
             1499.1513622250047, 8.634971771811252, -0.00037184593109018096,
             -1.2291934250456171, 28649.821549971748, 20.249137497970942,
             57244104191.08004, 0.05002616365476265],
            ['N', 0.9288527527765829, 312211.62853348156, 312211.5246674855,
             1499.644982198928, -2.0830063037210493, -0.00043025779841431857,
             -1.2301412210691398, 28629.19364113183, 21.25446477008346,
             114908916780.08994, 0.05001949161451377],
            ['R', 0.9288134033086443, 312262.72309558414, 312262.5145837583,
             1499.6302551393528, 5.4109259344040765, 0.0010532434904067117,
             -1.2303787420961032, 28605.84442728059, 20.248934231926317,
             57232240751.98996, 0.04998392738141184]]},
        "compiled": {"mode": "compiled", "memo": "executable",
                     "counters": [0, 1, 0, 0, 0, 0, 0], "rows": [
            ['A', 0.9288029030982248, 311971.09034934384, 311970.88196782983,
             1499.1513622250054, 8.634971771796081, -0.0003718459310884407,
             -1.2291934250456085, 28649.821549971748, 20.249137497970942,
             57244104191.08004, 0.05002616365476265],
            ['N', 0.9288527527765832, 312211.6285334816, 312211.52466748556,
             1499.6449821989283, -2.0830063037325766, -0.0004302577984129461,
             -1.230141221069131, 28629.19364113183, 21.25446477008346,
             114908916780.08994, 0.05001949161451377],
            ['R', 0.9288134033086443, 312262.72309558414, 312262.5145837583,
             1499.6302551393528, 5.4109259344050535, 0.0010532434904058673,
             -1.2303787420961043, 28605.84442728059, 20.248934231926317,
             57232240751.98996, 0.04998392738141184]]}},
    "F5": {
        "dynamic": {"counters": [5, 1, 0, 0, 0, 0, 0], "rows": [
            ['AUTOMOBILE', False, True, True, 0, 262143, 8742672176308498965,
             43210845673, 1, 301724],
            ['BUILDING', False, True, True, 0, 262143, -1137479174336715944,
             42989303237, 1, 300016],
            ['FURNITURE', False, True, True, 0, 262143, 7394190283433978633,
             43177316396, 1, 298524],
            ['HOUSEHOLD', False, True, True, 0, 262143, 2185867574935493672,
             43319850037, 1, 300075],
            ['MACHINERY', False, True, True, 0, 262143, 188068202532659996,
             43324772993, 1, 299661]]},
        "compiled": {"mode": "compiled", "memo": "DYNAMIC",
                     "counters": [8, 2, 0, 0, 0, 0, 0]}},
    "F6": {
        "dynamic": {"counters": [2, 1, 0, 0, 0, 0, 0], "rows": [
            ['ANODIZED', 39987, 1309439, 41, 137787, 7937, 5137, 2849,
             'Manufacturer#5', 'JUMBO BAG', 'Brand#55.-', '11#dnarB',
             'WRAP_PKG', 2639142, 'A1111'],
            ['BRUSHED', 40004, 1309163, 41, 130468, 7860, 5011, 2919,
             'Manufacturer#5', 'JUMBO BAG', 'Brand#55.-', '11#dnarB',
             'WRAP_PKG', 2640264, 'A1111'],
            ['BURNISHED', 40359, 1321503, 39, 144909, 8113, 5151, 2947,
             'Manufacturer#5', 'JUMBO BAG', 'Brand#55.-', '11#dnarB',
             'WRAP_PKG', 2663694, 'A1111'],
            ['PLATED', 39911, 1306901, 40, 120550, 7969, 5036, 2925,
             'Manufacturer#5', 'JUMBO BAG', 'Brand#55.-', '11#dnarB',
             'WRAP_PKG', 2634126, 'A1111'],
            ['POLISHED', 39739, 1301517, 40, 135291, 7890, 4922, 2864,
             'Manufacturer#5', 'JUMBO BAG', 'Brand#55.-', '11#dnarB',
             'WRAP_PKG', 2622774, 'A1111']]},
        "compiled": {"mode": "compiled", "memo": "executable",
                     "counters": [0, 1, 0, 0, 0, 0, 0]}},
    "F7": {
        "dynamic": {"counters": [3, 0, 0, 0, 1, 1, 0], "rows": [
            [0, 595, '000001000', '101002398608', 61485],
            [1, 504, '000001000', '111001848535', 59264],
            [2, 571, '000001000', '121003194028', 60587],
            [3, 595, '000001000', '131001248791', 61936],
            [4, 563, '000001000', '141005554328', 60721],
            [5, 539, '000001000', '151002245456', 58214],
            [6, 561, '000001000', '161006313621', 61364],
            [7, 561, '000001000', '171005374800', 59706],
            [8, 548, '000001000', '181007842075', 59627],
            [9, 575, '000001000', '191001322599', 59354],
            [10, 552, '000001000', '201001186644', 59287],
            [11, 583, '000001000', '211001803212', 60294],
            [12, 586, '000001000', '221002403297', 59507],
            [13, 570, '000001000', '231005014241', 60470],
            [14, 557, '000001000', '241002029295', 58596],
            [15, 602, '000001000', '251001638910', 61470],
            [16, 518, '000001000', '261001976734', 59277],
            [17, 548, '000001000', '271002922495', 59220],
            [18, 523, '000001000', '281003907585', 59789],
            [19, 521, '000001000', '291001048045', 59783],
            [20, 558, '000001000', '301001075319', 60381],
            [21, 518, '000001000', '311002992529', 59553],
            [22, 532, '000001000', '321004097930', 59418],
            [23, 542, '000001000', '331002047288', 60884],
            [24, 558, '000001000', '341001093152', 59813]]},
        "compiled": {"mode": "compiled", "memo": "executable",
                     "counters": [1, 0, 0, 0, 1, 1, 0]}},
    "F8": {
        "dynamic": {"counters": [2, 1, 0, 0, 0, 0, 0], "rows": [
            [8035, 19725, 8095, 8066, 50121521, 83, 8065, 78856, 78856, 31, 1,
             5, 1, 19725, 549984.44],
            [8066, 18355, 8124, 8095, 46088791, 82, 8094, 74701, 74701, 60, 32,
             9, 5, 18355, 549958.32],
            [8095, 19541, 8155, 8126, 48479810, 81, 8125, 76840, 76840, 91, 61,
             14, 9, 19541, 549997.0],
            [8126, 19195, 8185, 8156, 47035225, 80, 8155, 76123, 76123, 121,
             92, 18, 14, 19195, 549981.11],
            [8156, 19339, 8216, 8187, 46801373, 79, 8186, 81322, 81322, 152,
             122, 22, 18, 19339, 549986.37],
            [8187, 18915, 8246, 8217, 45198877, 78, 8216, 72528, 72528, 182,
             153, 27, 23, 18915, 549996.55],
            [8217, 19482, 8277, 8248, 45956870, 77, 8247, 77836, 77836, 213,
             183, 31, 27, 19482, 549963.36],
            [8248, 19518, 8308, 8279, 45439186, 76, 8278, 79785, 79785, 244,
             214, 36, 31, 19518, 549993.23],
            [8279, 18862, 8338, 8309, 43337786, 75, 8308, 73262, 73262, 274,
             245, 40, 36, 18862, 549994.61],
            [8309, 19484, 8369, 8340, 44170104, 74, 8339, 80289, 80289, 305,
             275, 44, 40, 19484, 549993.26],
            [8340, 18897, 8399, 8370, 42265405, 73, 8369, 75609, 75609, 335,
             306, 49, 44, 18897, 549973.39],
            [8370, 19447, 8430, 8401, 42900434, 72, 8400, 75923, 75923, 366,
             336, 53, 49, 19447, 549991.38],
            [8401, 19722, 8461, 8432, 42895990, 71, 8431, 82867, 82867, 31, 1,
             53, 1, 19722, 549938.11],
            [8432, 17458, 8489, 8460, 37455390, 70, 8459, 69706, 69706, 59, 32,
             8, 5, 17458, 549964.16],
            [8460, 19477, 8520, 8491, 41211669, 69, 8490, 74301, 74301, 90, 60,
             13, 9, 19477, 549985.92],
            [8491, 19057, 8550, 8521, 39745369, 68, 8520, 76796, 76796, 120,
             91, 17, 13, 19057, 549992.85],
            [8521, 19536, 8581, 8552, 40147033, 67, 8551, 79422, 79422, 151,
             121, 22, 17, 19536, 549977.42],
            [8552, 18990, 8611, 8582, 38444906, 66, 8581, 74158, 74158, 181,
             152, 26, 22, 18990, 549999.42],
            [8582, 19615, 8642, 8613, 39111434, 65, 8612, 80303, 80303, 212,
             182, 30, 26, 19615, 549976.52],
            [8613, 19498, 8673, 8644, 38273515, 64, 8643, 77012, 77012, 243,
             213, 35, 30, 19498, 549968.52],
            [8644, 18750, 8703, 8674, 36231667, 63, 8673, 74584, 74584, 273,
             244, 39, 35, 18750, 549970.68],
            [8674, 19883, 8734, 8705, 37817814, 62, 8704, 83215, 83215, 304,
             274, 43, 39, 19883, 549975.4],
            [8705, 18835, 8764, 8735, 35248831, 61, 8734, 72517, 72517, 334,
             305, 48, 44, 18835, 549994.55],
            [8735, 19555, 8795, 8766, 36001500, 60, 8765, 78518, 78518, 365,
             335, 52, 48, 19555, 549972.81],
            [8766, 19564, 8826, 8797, 35412833, 59, 8796, 79137, 79137, 31, 1,
             52, 1, 19564, 549978.43],
            [8797, 17311, 8854, 8825, 30822537, 58, 8824, 69030, 69030, 59, 32,
             9, 5, 17311, 549978.8],
            [8825, 19592, 8885, 8856, 34307381, 57, 8855, 76349, 76349, 90, 60,
             13, 9, 19592, 549999.75],
            [8856, 18836, 8915, 8886, 32409370, 56, 8885, 76912, 76912, 120,
             91, 17, 13, 18836, 549993.43],
            [8886, 19450, 8946, 8917, 32869549, 55, 8916, 76485, 76485, 151,
             121, 22, 17, 19450, 549991.63],
            [8917, 18999, 8976, 8947, 31528811, 54, 8946, 75444, 75444, 181,
             152, 26, 22, 18999, 549954.5],
            [8947, 19717, 9007, 8978, 32114828, 53, 8977, 82847, 82847, 212,
             182, 30, 26, 19717, 549897.62],
            [8978, 19374, 9038, 9009, 30958832, 52, 9008, 73686, 73686, 243,
             213, 35, 31, 19374, 549997.21],
            [9009, 18930, 9068, 9039, 29672253, 51, 9038, 76194, 76194, 273,
             244, 39, 35, 18930, 549988.66],
            [9039, 19326, 9099, 9070, 29705446, 50, 9069, 78836, 78836, 304,
             274, 44, 39, 19326, 549988.18],
            [9070, 18712, 9129, 9100, 28188682, 49, 9099, 72548, 72548, 334,
             305, 48, 44, 18712, 549998.37],
            [9100, 19388, 9160, 9131, 28617365, 48, 9130, 79267, 79267, 365,
             335, 52, 48, 19388, 549992.25],
            [9131, 19528, 9191, 9162, 28218588, 47, 9161, 77294, 77294, 31, 1,
             52, 1, 19528, 549892.57],
            [9162, 17919, 9219, 9190, 25364207, 46, 9189, 71486, 71486, 59, 32,
             9, 5, 17919, 549998.27],
            [9190, 19630, 9250, 9221, 27205946, 45, 9220, 78221, 78221, 90, 60,
             13, 9, 19630, 549992.9],
            [9221, 18805, 9280, 9251, 25491065, 44, 9250, 77756, 77756, 120,
             91, 17, 13, 18805, 549996.84],
            [9251, 19597, 9311, 9282, 25963379, 43, 9281, 74537, 74537, 151,
             121, 22, 18, 19597, 549970.41],
            [9282, 18966, 9341, 9312, 24551715, 42, 9311, 76439, 76439, 181,
             152, 26, 22, 10121, 549993.31],
            [9312, 19761, 9372, 9343, 24976578, 41, 9342, 80006, 80006, 212,
             182, 31, 26, 0, 549920.64],
            [9343, 19559, 9403, 9374, 24116323, 40, 9373, 76255, 76255, 243,
             213, 35, 31, 0, 549960.27],
            [9374, 19036, 9433, 9404, 22890487, 39, 9403, 78121, 78121, 273,
             244, 39, 35, 0, 549975.36],
            [9404, 19422, 9464, 9435, 22761930, 38, 9434, 76468, 76468, 304,
             274, 44, 39, 0, 549933.39],
            [9435, 18992, 9494, 9465, 21680079, 37, 9464, 75113, 75113, 334,
             305, 48, 44, 0, 549973.25],
            [9465, 19769, 9525, 9496, 21963138, 36, 9495, 83387, 83387, 365,
             335, 52, 48, 0, 549992.4],
            [9496, 19539, 9556, 9527, 21102806, 35, 9526, 73987, 73987, 31, 1,
             5, 1, 0, 549888.46],
            [9527, 18214, 9585, 9556, 19125116, 34, 9555, 73469, 73469, 60, 32,
             9, 5, 0, 549986.41],
            [9556, 19516, 9616, 9587, 19905703, 33, 9586, 82174, 82174, 91, 61,
             13, 9, 0, 549978.27],
            [9587, 18924, 9646, 9617, 18723420, 32, 9616, 72495, 72495, 121,
             92, 18, 14, 0, 549953.78],
            [9617, 19671, 9677, 9648, 18864385, 31, 9647, 78515, 78515, 152,
             122, 22, 18, 0, 549965.01],
            [9648, 18771, 9707, 9678, 17429560, 30, 9677, 77778, 77778, 182,
             153, 26, 22, 0, 549998.38],
            [9678, 19552, 9738, 9709, 17558314, 29, 9708, 74781, 74781, 213,
             183, 31, 27, 0, 549981.6],
            [9709, 19796, 9769, 9740, 17163627, 28, 9739, 81524, 81524, 244,
             214, 35, 31, 0, 549997.41],
            [9740, 18987, 9799, 9770, 15884277, 27, 9769, 75889, 75889, 274,
             245, 40, 35, 0, 549983.04],
            [9770, 19692, 9830, 9801, 15874655, 26, 9800, 76823, 76823, 305,
             275, 44, 40, 0, 549970.25],
            [9801, 19075, 9860, 9831, 14793116, 25, 9830, 78531, 78531, 335,
             306, 48, 44, 0, 549939.31],
            [9831, 19792, 9891, 9862, 14746313, 24, 9861, 78033, 78033, 366,
             336, 52, 1, 0, 549996.54],
            [9862, 19626, 9922, 9893, 14011336, 23, 9892, 78466, 78466, 31, 1,
             5, 1, 0, 549958.98],
            [9893, 17625, 9950, 9921, 12065273, 22, 9920, 70854, 70854, 59, 32,
             9, 5, 0, 549988.65],
            [9921, 19623, 9981, 9952, 12853304, 21, 9951, 80121, 80121, 90, 60,
             14, 9, 0, 549993.03],
            [9952, 19149, 10011, 9982, 11957406, 20, 9981, 74441, 74441, 120,
             91, 18, 14, 0, 549962.9],
            [9982, 19468, 10042, 10013, 11561197, 19, 10012, 79366, 79366, 151,
             121, 22, 18, 0, 549997.32],
            [10013, 19070, 10072, 10043, 10746864, 18, 10042, 75837, 75837,
             181, 152, 27, 22, 0, 549986.63],
            [10043, 19587, 10103, 10074, 10441515, 17, 10073, 76731, 76731,
             212, 182, 31, 27, 0, 549990.49],
            [10074, 19461, 10134, 10105, 9769058, 16, 10104, 81234, 81234, 243,
             213, 35, 31, 0, 549966.66],
            [10105, 19120, 10164, 10135, 9015030, 15, 10134, 73663, 73663, 273,
             244, 40, 36, 0, 549996.76],
            [10135, 19637, 10195, 10166, 8660807, 14, 10165, 78029, 78029, 304,
             274, 44, 40, 0, 549882.75],
            [10166, 19003, 10225, 10196, 7801010, 13, 10195, 79246, 79246, 334,
             305, 48, 44, 0, 549931.74],
            [10196, 19512, 10256, 10227, 7414267, 12, 10226, 74268, 74268, 365,
             335, 52, 1, 0, 549934.16],
            [10227, 19704, 10287, 10258, 6876811, 11, 10257, 80793, 80793, 31,
             1, 5, 1, 0, 549988.33],
            [10258, 17689, 10315, 10286, 5649399, 10, 10285, 71134, 71134, 59,
             32, 9, 5, 0, 549998.1],
            [10286, 19393, 10346, 10317, 5625072, 9, 10316, 75922, 75922, 90,
             60, 14, 9, 0, 549996.47],
            [10317, 18853, 10376, 10347, 4894211, 8, 10346, 74320, 74320, 120,
             91, 18, 14, 0, 549949.77],
            [10347, 19623, 10407, 10378, 4497468, 7, 10377, 82402, 82402, 151,
             121, 22, 18, 0, 549998.4],
            [10378, 19110, 10437, 10408, 3792904, 6, 10407, 73203, 73203, 181,
             152, 27, 23, 0, 549985.89],
            [10408, 1899, 10440, 10439, 345612, 5, 10438, 7602, 7602, 184, 182,
             27, 27, 0, 549712.01]]},
        "compiled": {"mode": "compiled", "memo": "executable",
                     "counters": [3, 0, 0, 0, 0, 0, 0], "rows": [
            [8035, 19725, 8095, 8066, 50121521, 83, 8065, 78856, 78856, 31, 1,
             5, 1, 19725, 549984.44],
            [8066, 18355, 8124, 8095, 46088791, 82, 8094, 74701, 74701, 60, 32,
             9, 5, 18355, 549958.32],
            [8095, 19541, 8155, 8126, 48479810, 81, 8125, 76840, 76840, 91, 61,
             14, 9, 19541, 549997.0],
            [8126, 19195, 8185, 8156, 47035225, 80, 8155, 76123, 76123, 121,
             92, 18, 14, 19195, 549981.11],
            [8156, 19339, 8216, 8187, 46801373, 79, 8186, 81322, 81322, 152,
             122, 22, 18, 19339, 549986.37],
            [8187, 18915, 8246, 8217, 45198877, 78, 8216, 72528, 72528, 182,
             153, 27, 23, 18915, 549996.5499999999],
            [8217, 19482, 8277, 8248, 45956870, 77, 8247, 77836, 77836, 213,
             183, 31, 27, 19482, 549963.36],
            [8248, 19518, 8308, 8279, 45439186, 76, 8278, 79785, 79785, 244,
             214, 36, 31, 19518, 549993.23],
            [8279, 18862, 8338, 8309, 43337786, 75, 8308, 73262, 73262, 274,
             245, 40, 36, 18862, 549994.61],
            [8309, 19484, 8369, 8340, 44170104, 74, 8339, 80289, 80289, 305,
             275, 44, 40, 19484, 549993.26],
            [8340, 18897, 8399, 8370, 42265405, 73, 8369, 75609, 75609, 335,
             306, 49, 44, 18897, 549973.39],
            [8370, 19447, 8430, 8401, 42900434, 72, 8400, 75923, 75923, 366,
             336, 53, 49, 19447, 549991.38],
            [8401, 19722, 8461, 8432, 42895990, 71, 8431, 82867, 82867, 31, 1,
             53, 1, 19722, 549938.11],
            [8432, 17458, 8489, 8460, 37455390, 70, 8459, 69706, 69706, 59, 32,
             8, 5, 17458, 549964.16],
            [8460, 19477, 8520, 8491, 41211669, 69, 8490, 74301, 74301, 90, 60,
             13, 9, 19477, 549985.9199999999],
            [8491, 19057, 8550, 8521, 39745369, 68, 8520, 76796, 76796, 120,
             91, 17, 13, 19057, 549992.85],
            [8521, 19536, 8581, 8552, 40147033, 67, 8551, 79422, 79422, 151,
             121, 22, 17, 19536, 549977.4199999999],
            [8552, 18990, 8611, 8582, 38444906, 66, 8581, 74158, 74158, 181,
             152, 26, 22, 18990, 549999.4199999999],
            [8582, 19615, 8642, 8613, 39111434, 65, 8612, 80303, 80303, 212,
             182, 30, 26, 19615, 549976.52],
            [8613, 19498, 8673, 8644, 38273515, 64, 8643, 77012, 77012, 243,
             213, 35, 30, 19498, 549968.52],
            [8644, 18750, 8703, 8674, 36231667, 63, 8673, 74584, 74584, 273,
             244, 39, 35, 18750, 549970.6799999999],
            [8674, 19883, 8734, 8705, 37817814, 62, 8704, 83215, 83215, 304,
             274, 43, 39, 19883, 549975.4],
            [8705, 18835, 8764, 8735, 35248831, 61, 8734, 72517, 72517, 334,
             305, 48, 44, 18835, 549994.5499999999],
            [8735, 19555, 8795, 8766, 36001500, 60, 8765, 78518, 78518, 365,
             335, 52, 48, 19555, 549972.8099999999],
            [8766, 19564, 8826, 8797, 35412833, 59, 8796, 79137, 79137, 31, 1,
             52, 1, 19564, 549978.4299999999],
            [8797, 17311, 8854, 8825, 30822537, 58, 8824, 69030, 69030, 59, 32,
             9, 5, 17311, 549978.7999999999],
            [8825, 19592, 8885, 8856, 34307381, 57, 8855, 76349, 76349, 90, 60,
             13, 9, 19592, 549999.75],
            [8856, 18836, 8915, 8886, 32409370, 56, 8885, 76912, 76912, 120,
             91, 17, 13, 18836, 549993.4299999999],
            [8886, 19450, 8946, 8917, 32869549, 55, 8916, 76485, 76485, 151,
             121, 22, 17, 19450, 549991.63],
            [8917, 18999, 8976, 8947, 31528811, 54, 8946, 75444, 75444, 181,
             152, 26, 22, 18999, 549954.5],
            [8947, 19717, 9007, 8978, 32114828, 53, 8977, 82847, 82847, 212,
             182, 30, 26, 19717, 549897.62],
            [8978, 19374, 9038, 9009, 30958832, 52, 9008, 73686, 73686, 243,
             213, 35, 31, 19374, 549997.21],
            [9009, 18930, 9068, 9039, 29672253, 51, 9038, 76194, 76194, 273,
             244, 39, 35, 18930, 549988.66],
            [9039, 19326, 9099, 9070, 29705446, 50, 9069, 78836, 78836, 304,
             274, 44, 39, 19326, 549988.1799999999],
            [9070, 18712, 9129, 9100, 28188682, 49, 9099, 72548, 72548, 334,
             305, 48, 44, 18712, 549998.37],
            [9100, 19388, 9160, 9131, 28617365, 48, 9130, 79267, 79267, 365,
             335, 52, 48, 19388, 549992.25],
            [9131, 19528, 9191, 9162, 28218588, 47, 9161, 77294, 77294, 31, 1,
             52, 1, 19528, 549892.57],
            [9162, 17919, 9219, 9190, 25364207, 46, 9189, 71486, 71486, 59, 32,
             9, 5, 17919, 549998.27],
            [9190, 19630, 9250, 9221, 27205946, 45, 9220, 78221, 78221, 90, 60,
             13, 9, 19630, 549992.9],
            [9221, 18805, 9280, 9251, 25491065, 44, 9250, 77756, 77756, 120,
             91, 17, 13, 18805, 549996.84],
            [9251, 19597, 9311, 9282, 25963379, 43, 9281, 74537, 74537, 151,
             121, 22, 18, 19597, 549970.41],
            [9282, 18966, 9341, 9312, 24551715, 42, 9311, 76439, 76439, 181,
             152, 26, 22, 10121, 549993.3099999999],
            [9312, 19761, 9372, 9343, 24976578, 41, 9342, 80006, 80006, 212,
             182, 31, 26, 0, 549920.64],
            [9343, 19559, 9403, 9374, 24116323, 40, 9373, 76255, 76255, 243,
             213, 35, 31, 0, 549960.27],
            [9374, 19036, 9433, 9404, 22890487, 39, 9403, 78121, 78121, 273,
             244, 39, 35, 0, 549975.36],
            [9404, 19422, 9464, 9435, 22761930, 38, 9434, 76468, 76468, 304,
             274, 44, 39, 0, 549933.39],
            [9435, 18992, 9494, 9465, 21680079, 37, 9464, 75113, 75113, 334,
             305, 48, 44, 0, 549973.25],
            [9465, 19769, 9525, 9496, 21963138, 36, 9495, 83387, 83387, 365,
             335, 52, 48, 0, 549992.4],
            [9496, 19539, 9556, 9527, 21102806, 35, 9526, 73987, 73987, 31, 1,
             5, 1, 0, 549888.46],
            [9527, 18214, 9585, 9556, 19125116, 34, 9555, 73469, 73469, 60, 32,
             9, 5, 0, 549986.41],
            [9556, 19516, 9616, 9587, 19905703, 33, 9586, 82174, 82174, 91, 61,
             13, 9, 0, 549978.27],
            [9587, 18924, 9646, 9617, 18723420, 32, 9616, 72495, 72495, 121,
             92, 18, 14, 0, 549953.78],
            [9617, 19671, 9677, 9648, 18864385, 31, 9647, 78515, 78515, 152,
             122, 22, 18, 0, 549965.01],
            [9648, 18771, 9707, 9678, 17429560, 30, 9677, 77778, 77778, 182,
             153, 26, 22, 0, 549998.38],
            [9678, 19552, 9738, 9709, 17558314, 29, 9708, 74781, 74781, 213,
             183, 31, 27, 0, 549981.6],
            [9709, 19796, 9769, 9740, 17163627, 28, 9739, 81524, 81524, 244,
             214, 35, 31, 0, 549997.41],
            [9740, 18987, 9799, 9770, 15884277, 27, 9769, 75889, 75889, 274,
             245, 40, 35, 0, 549983.0399999999],
            [9770, 19692, 9830, 9801, 15874655, 26, 9800, 76823, 76823, 305,
             275, 44, 40, 0, 549970.25],
            [9801, 19075, 9860, 9831, 14793116, 25, 9830, 78531, 78531, 335,
             306, 48, 44, 0, 549939.3099999999],
            [9831, 19792, 9891, 9862, 14746313, 24, 9861, 78033, 78033, 366,
             336, 52, 1, 0, 549996.5399999999],
            [9862, 19626, 9922, 9893, 14011336, 23, 9892, 78466, 78466, 31, 1,
             5, 1, 0, 549958.98],
            [9893, 17625, 9950, 9921, 12065273, 22, 9920, 70854, 70854, 59, 32,
             9, 5, 0, 549988.65],
            [9921, 19623, 9981, 9952, 12853304, 21, 9951, 80121, 80121, 90, 60,
             14, 9, 0, 549993.03],
            [9952, 19149, 10011, 9982, 11957406, 20, 9981, 74441, 74441, 120,
             91, 18, 14, 0, 549962.9],
            [9982, 19468, 10042, 10013, 11561197, 19, 10012, 79366, 79366, 151,
             121, 22, 18, 0, 549997.32],
            [10013, 19070, 10072, 10043, 10746864, 18, 10042, 75837, 75837,
             181, 152, 27, 22, 0, 549986.63],
            [10043, 19587, 10103, 10074, 10441515, 17, 10073, 76731, 76731,
             212, 182, 31, 27, 0, 549990.49],
            [10074, 19461, 10134, 10105, 9769058, 16, 10104, 81234, 81234, 243,
             213, 35, 31, 0, 549966.66],
            [10105, 19120, 10164, 10135, 9015030, 15, 10134, 73663, 73663, 273,
             244, 40, 36, 0, 549996.76],
            [10135, 19637, 10195, 10166, 8660807, 14, 10165, 78029, 78029, 304,
             274, 44, 40, 0, 549882.75],
            [10166, 19003, 10225, 10196, 7801010, 13, 10195, 79246, 79246, 334,
             305, 48, 44, 0, 549931.74],
            [10196, 19512, 10256, 10227, 7414267, 12, 10226, 74268, 74268, 365,
             335, 52, 1, 0, 549934.16],
            [10227, 19704, 10287, 10258, 6876811, 11, 10257, 80793, 80793, 31,
             1, 5, 1, 0, 549988.33],
            [10258, 17689, 10315, 10286, 5649399, 10, 10285, 71134, 71134, 59,
             32, 9, 5, 0, 549998.1],
            [10286, 19393, 10346, 10317, 5625072, 9, 10316, 75922, 75922, 90,
             60, 14, 9, 0, 549996.47],
            [10317, 18853, 10376, 10347, 4894211, 8, 10346, 74320, 74320, 120,
             91, 18, 14, 0, 549949.77],
            [10347, 19623, 10407, 10378, 4497468, 7, 10377, 82402, 82402, 151,
             121, 22, 18, 0, 549998.4],
            [10378, 19110, 10437, 10408, 3792904, 6, 10407, 73203, 73203, 181,
             152, 27, 23, 0, 549985.89],
            [10408, 1899, 10440, 10439, 345612, 5, 10438, 7602, 7602, 184, 182,
             27, 27, 0, 549712.01]]}},
    "F9": {
        "dynamic": {"counters": [2, 1, 0, 0, 0, 0, 0], "rows": [
            [1, 855795, 49725546.0, 4357935.0, 3517367.0, 4972554600.0,
             1688812.2284080735, 900135.6271580162, 1074954.510310152,
             3160682.6251212666, 1550831.5412056828, 559.0, 2996.214900000001,
             155065.68168179697, 1328741.5884685894, 37.69911184307752,
             0.21746254627672362, 8561173.0, 31129.219999999987],
            [2, 919074, 151158864.0, 4684400.0, 3780026.0, 15115886400.0,
             3145493.359216203, 966738.24218451, 2242814.4557378567,
             3868425.9249333357, 3235697.2929270836, 1043.0, 3221.746299999998,
             166584.83587904327, 1439500.192232194, 75.39822368615503,
             0.21746254627672362, 11461208.0, 33454.94000000001],
            [3, 918298, 252075190.0, 4672934.0, 3772193.0, 25207519000.0,
             4070090.643537906, 965845.7996522832, 2721646.1326135187,
             4073935.67243781, 3926505.378576147, -1326.0, 3212.2861000000025,
             166247.55416631568, 1440022.804184132, 113.09733552923255,
             0.21746254627672362, 18293009.0, 33386.11000000004],
            [4, 916704, 352487204.0, 4669595.0, 3768017.0, 35248720400.0,
             4812055.993517986, 964211.3609962895, 3028673.105056638,
             4202165.003428013, 4369451.669138984, 834.0, 3209.2551000000008,
             166098.23793631827, 1438228.8274802112, 150.79644737231007,
             0.21746254627672362, 25572253.0, 33365.15000000001],
            [5, 881716, 434940971.0, 4488679.0, 3625325.0, 43494097100.0,
             5203937.287378641, 927380.376358304, 3121558.7649470135,
             4137587.594875015, 4503457.350032544, -221.0, 3084.2442,
             159781.80417186694, 1383691.1987551854, 157.07963267948966,
             0.21746254627672362, 31028696.0, 32070.740000000038],
            [6, 676775, 406878425.0, 3446491.0, 2783178.0, 40687842500.0,
             4235091.058866805, 711842.9686910369, 2478164.0556366616,
             3234158.343610975, 3575234.9935762957, 328.0, 2370.1753999999987,
             122659.84560946279, 1062195.7995194308, 157.07963267948966,
             0.21746254627672362, 26657948.0, 24614.34999999998],
            [7, 456267, 324189365.0, 2323319.0, 1875238.0, 32418936500.0,
             2971487.7887569424, 479907.24311755184, 1708562.4223836835,
             2213559.767468897, 2464934.5338221714, -521.0, 1597.7888999999989,
             82633.45286790335, 716159.9203517236, 157.07963267948966,
             0.21746254627672362, 19406419.0, 16592.969999999983],
            [8, 267384, 218841288.0, 1359987.0, 1099816.0, 21884128800.0,
             1802118.0436520742, 281221.6043248782, 1020052.2907407243,
             1313643.7789124344, 1471624.3812990715, -310.0, 934.7489000000006,
             48435.44371740941, 419710.77392185136, 157.07963267948966,
             0.21746254627672362, 12159551.0, 9716.82999999999],
            [9, 102033, 93959827.0, 519259.0, 419370.0, 9395982700.0,
             706838.9839043911, 107315.89499451498, 394937.6911950429,
             506516.8937656918, 569774.6485472257, 69.0, 356.98090000000025,
             18483.34005099651, 160166.69524025824, 157.07963267948966,
             0.21746254627672362, 4898253.0, 3707.8000000000034],
            [10, 6555, 6598264.0, 32865.0, 26740.0, 659826400.0,
             46152.53311250505, 6889.4870505765475, 25586.842346265505,
             32795.282031536575, 36914.010564964934, -134.0,
             22.436699999999995, 1181.412767609662, 10290.054977112073,
             157.07963267948966, 0.21746254627672362, 324964.0,
             236.10999999999993]]},
        "compiled": {"mode": "compiled", "memo": "executable",
                     "counters": [3, 0, 0, 0, 0, 0, 0], "rows": [
            [1, 855801, 49726206.0, 4357964.0, 3517395.0, 4972620600.0,
             1688831.8194656384, 900141.9271561668, 1074968.7070652922,
             3160706.8734773495, 1550852.0227881107, 558.0, 2996.2344000124986,
             155066.9123958939, 1328750.9861575474, 37.69911184307752,
             0.21746254627672362, 8561237.0, 31129.43999976179],
            [2, 919082, 151161284.0, 4684442.0, 3780076.0, 15116128400.0,
             3145538.1243252624, 966746.6550881275, 2242842.961717022,
             3868462.470494838, 3235738.418363753, 1044.0, 3221.7715000158587,
             166586.6787210124, 1439512.752737536, 75.39822368615503,
             0.21746254627672362, 11461440.0, 33455.249999764696],
            [3, 918284, 252072110.0, 4672863.0, 3772115.0, 25207211000.0,
             4070026.2874190276, 965831.086751526, 2721603.4298747093,
             4073874.8785200063, 3926443.7715398856, -1326.0,
             3212.241400015853, 166244.48061208177, 1440000.8459893134,
             113.09733552923255, 0.21746254627672362, 18292713.0,
             33385.579999762034],
            [4, 916717, 352492924.0, 4669663.0, 3768063.0, 35249292400.0,
             4812140.6822760375, 964225.0357084381, 3028721.822967725,
             4202225.368312873, 4369521.9542201925, 835.0, 3209.3032000156677,
             166100.3648958805, 1438249.2324454316, 150.79644737231007,
             0.21746254627672362, 25572805.0, 33365.599999762104],
            [5, 881703, 434935251.0, 4488611.0, 3625279.0, 43493525100.0,
             5203852.5985845225, 927366.7016467575, 3121510.0470341984,
             4137527.2299899417, 4503387.064932495, -222.0, 3084.196100013764,
             159779.67721353204, 1383670.793788488, 157.07963267948966,
             0.21746254627672362, 31028144.0, 32070.28999974801],
            [6, 676775, 406878425.0, 3446491.0, 2783178.0, 40687842500.0,
             4235091.058854287, 711842.9686917473, 2478164.05563691,
             3234158.343611079, 3575234.993569741, 328.0, 2370.1754000033006,
             122659.84560965074, 1062195.799520082, 157.07963267948966,
             0.21746254627672362, 26657948.0, 24614.34999985595],
            [7, 456267, 324189365.0, 2323319.0, 1875238.0, 32418936500.0,
             2971487.788755562, 479907.24311842857, 1708562.422383322,
             2213559.767468868, 2464934.533816651, -521.0, 1597.7888999999268,
             82633.45286795363, 716159.9203522374, 157.07963267948966,
             0.21746254627672362, 19406419.0, 16592.969999973448],
            [8, 267384, 218841288.0, 1359987.0, 1099816.0, 21884128800.0,
             1802118.0436509578, 281221.6043251037, 1020052.2907403478,
             1313643.7789124688, 1471624.3812984321, -310.0, 934.7489000013308,
             48435.44371741712, 419710.7739217899, 157.07963267948966,
             0.21746254627672362, 12159551.0, 9716.830000012606],
            [9, 102033, 93959827.0, 519259.0, 419370.0, 9395982700.0,
             706838.9839047068, 107315.89499453943, 394937.69119456416,
             506516.89376567875, 569774.6485476128, 69.0, 356.9809000001145,
             18483.34005100287, 160166.69524025338, 157.07963267948966,
             0.21746254627672362, 4898253.0, 3707.800000004676],
            [10, 6555, 6598264.0, 32865.0, 26740.0, 659826400.0,
             46152.53311250334, 6889.487050576284, 25586.842346267556,
             32795.28203153662, 36914.01056496173, -134.0, 22.436699999999536,
             1181.4127676096662, 10290.05497711233, 157.07963267948966,
             0.21746254627672362, 324964.0, 236.11000000001462]]}},
    "F10": {
        "dynamic": {"counters": [2, 1, 0, 0, 0, 0, 0], "rows": [
            ['F', 83883796, 54293291393, 2156920344537, 47999792, 0, 0, 15, -2,
             0, 719489, 0, -5999975],
            ['O', 81859191, 53068398284, 2112483338841, 47999800, 0, 0, 15, -1,
             0, 703440, 0, -5999976],
            ['P', 9004965, 5819613085, 231095466316, 47999808, 0, 0, 15, -70,
             0, 77071, 0, -5999977]]},
        "compiled": {"mode": "compiled", "memo": "executable",
                     "counters": [0, 1, 0, 0, 0, 0, 0]}},
    "F11": {
        "dynamic": {"counters": [2, 1, 0, 0, 0, 0, 0], "rows": [
            ['1', 300041, '["a","b"]', '{"p":1,"tags":["a","b"]}', 600082, 0,
             300041],
            ['2', 300574, '[]', '{"p":2,"tags":[]}', 0, 0, 300574],
            ['3', 899385, '["c"]', '{"p":3,"tags":["c"],"x":{"y":true}}',
             899385, 1, 899385]]},
        "compiled": {"mode": "compiled", "memo": "executable",
                     "counters": [0, 1, 0, 0, 0, 0, 0]}},
}
REFERENCE_COUNTERS_SF1.update({
    name: {mode: v[mode]["counters"] for mode in ("dynamic", "compiled")}
    for name, v in FN_REFERENCE_SF1.items()})
REFERENCE_MEMO_SF1.update({name: v["compiled"]["memo"]
                           for name, v in FN_REFERENCE_SF1.items()})
# presto_tpu's values of the collection corpus at SF1 in each executor
# (`python -m tests.test_torch_collections_corpus 1 NAME`, one query a
# process): rows in order, collection values as lists (the compiled rows
# only where they differ from the dynamic ones), the counters in
# SORT_STATS_KEYS order, the execution mode and memo entry
COLL_REFERENCE_SF1 = {
    "C1": {
        "dynamic": {"counters": [2, 1, 0, 0, 1, 1, 0], "rows":
            [['almond', 322503, 8209284.0], ['antique', 332153, 8471104.0],
             ['aquamarine', 325488, 8297128.0], ['azure', 327026, 8338183.0],
             ['beige', 326198, 8305426.0], ['bisque', 327734, 8351765.0],
             ['black', 322103, 8205791.0], ['blanched', 328466, 8372952.0],
             ['blue', 325283, 8299708.0], ['blush', 323723, 8251163.0],
             ['brown', 323377, 8251588.0], ['burlywood', 326992, 8337622.0],
             ['burnished', 326578, 8328536.0],
             ['chartreuse', 327816, 8355684.0],
             ['chiffon', 332344, 8471503.0], ['chocolate', 321992, 8220348.0],
             ['coral', 325932, 8311661.0], ['cornflower', 324566, 8276552.0],
             ['cornsilk', 325598, 8298956.0], ['cream', 327561, 8339897.0],
             ['cyan', 322597, 8213639.0], ['dark', 332014, 8459610.0],
             ['deep', 327722, 8329501.0], ['dim', 326373, 8319628.0],
             ['dodger', 315641, 8037722.0], ['drab', 327632, 8348719.0],
             ['firebrick', 320740, 8178965.0], ['floral', 326949, 8323696.0],
             ['forest', 329092, 8378173.0], ['frosted', 328455, 8377060.0],
             ['gainsboro', 327855, 8364192.0], ['ghost', 327489, 8342406.0],
             ['goldenrod', 323463, 8250769.0], ['green', 327763, 8354765.0],
             ['grey', 329077, 8404087.0], ['honeydew', 323733, 8246450.0],
             ['hot', 323288, 8247152.0], ['indian', 324528, 8274541.0],
             ['ivory', 332160, 8484857.0], ['khaki', 329035, 8393831.0],
             ['lace', 329647, 8421573.0], ['lavender', 328478, 8372194.0],
             ['lawn', 330653, 8421333.0], ['lemon', 329470, 8396849.0],
             ['light', 323045, 8236125.0], ['lime', 325605, 8293514.0],
             ['linen', 325630, 8297299.0], ['magenta', 325201, 8281344.0],
             ['maroon', 325207, 8294402.0], ['medium', 329707, 8411896.0],
             ['metallic', 320369, 8157868.0], ['midnight', 330907, 8430928.0],
             ['mint', 324755, 8286763.0], ['misty', 329737, 8415593.0],
             ['moccasin', 329447, 8395296.0], ['navajo', 326339, 8318419.0],
             ['navy', 319752, 8155492.0], ['olive', 320309, 8166038.0],
             ['orange', 326216, 8332015.0], ['orchid', 323878, 8261813.0],
             ['pale', 329643, 8402612.0], ['papaya', 329625, 8393837.0],
             ['peach', 328950, 8384593.0], ['peru', 328486, 8371139.0],
             ['pink', 323777, 8264980.0], ['plum', 319025, 8123022.0],
             ['powder', 329661, 8414018.0], ['puff', 328496, 8381664.0],
             ['purple', 326124, 8317807.0], ['red', 324846, 8277873.0],
             ['rose', 326125, 8314995.0], ['rosy', 327876, 8364747.0],
             ['royal', 327991, 8352925.0], ['saddle', 328353, 8376492.0],
             ['salmon', 325569, 8295067.0], ['sandy', 324529, 8253080.0],
             ['seashell', 322406, 8229425.0], ['sienna', 325972, 8296178.0],
             ['sky', 325907, 8299963.0], ['slate', 325335, 8286409.0],
             ['smoke', 326429, 8325130.0], ['snow', 321747, 8204922.0],
             ['spring', 322734, 8234301.0], ['steel', 323808, 8254869.0],
             ['tan', 327097, 8347886.0], ['thistle', 326698, 8338330.0],
             ['tomato', 325501, 8281651.0], ['turquoise', 319783, 8144264.0],
             ['violet', 326413, 8324310.0], ['wheat', 322981, 8220050.0],
             ['white', 331566, 8453750.0], ['yellow', 326161, 8312353.0]]},
        "compiled": {"mode": "compiled", "memo": 'executable',
                     "counters": [1, 0, 0, 0, 1, 1, 0]}},
    "C2": {
        "dynamic": {"counters": [2, 1, 0, 0, 0, 0, 0], "rows":
            [[1, 6000601, 229385261723.15964],
             [2, 6000601, 458770523446.3194], [3, 6000601, 688155785169.481]]},
        "compiled": {"mode": "compiled", "memo": 'executable',
                     "counters": [3, 0, 0, 0, 0, 0, 0],
                     "rows":
            [[1, 6000601, 229385261723.17267],
             [2, 6000601, 458770523446.34534],
             [3, 6000601, 688155785169.4708]]}},
    "C3": {
        "dynamic": {"counters": [2, 0, 0, 0, 0, 0, 0], "rows":
            [[1500000, 54437983918423, 44]]},
        "compiled": {"mode": "dynamic", "memo": None,
                     "counters": [2, 0, 0, 0, 0, 0, 0]}},
    "C4": {
        "dynamic": {"counters": [2, 0, 0, 0, 0, 0, 0], "rows":
            [[99997, 1500000, 50900944163.899994, 4192729071.49,
              27515693734.15, 299369, 99596, 251423, 209967, 1422929]]},
        "compiled": {"mode": "dynamic", "memo": None,
                     "counters": [2, 0, 0, 0, 0, 0, 0]}},
    "C5": {
        "dynamic": {"counters": [2, 1, 0, 0, 0, 0, 0], "rows":
            [['A',
              [['AIR', 214399], ['FOB', 214093], ['MAIL', 214097],
               ['RAIL', 213061], ['REG AIR', 214013], ['SHIP', 213760],
               ['TRUCK', 213692]],
              [['F', 4]],
              [[0.00913000729402398, 374279.0],
               [0.03642977564864716, 374279.0],
               [0.06362806890047265, 374279.0],
               [0.09091691202795786, 374278.0]]],
             ['N',
              [['AIR', 429324], ['FOB', 428894], ['MAIL', 430436],
               ['RAIL', 429170], ['REG AIR', 429213], ['SHIP', 429529],
               ['TRUCK', 429342]],
              [['F', 2], ['O', 1]],
              [[0.009107624052366214, 751477.0],
               [0.036394633501757194, 751477.0],
               [0.06365509523245559, 751477.0],
               [0.09092061367147615, 751477.0]]],
             ['R',
              [['AIR', 214162], ['FOB', 214497], ['MAIL', 214241],
               ['RAIL', 213914], ['REG AIR', 213080], ['SHIP', 214512],
               ['TRUCK', 213172]],
              [['F', 1]],
              [[0.009106879098278557, 374395.0],
               [0.03633523417780689, 374395.0],
               [0.06360609411475612, 374394.0],
               [0.09088764777213312, 374394.0]]]]},
        "compiled": {"mode": "dynamic", "memo": None,
                     "counters": [2, 1, 0, 0, 0, 0, 0]}},
    "C6": {
        "dynamic": {"counters": [2, 0, 0, 0, 0, 0, 0], "rows":
            [[['AIR', 'FOB', 'MAIL', 'RAIL', 'REG AIR', 'SHIP', 'TRUCK'],
              [214399, 214093, 214097, 213061, 214013, 213760, 213692],
              214097, 7,
              [['AIR', 428798], ['FOB', 428186], ['MAIL', 428194],
               ['RAIL', 426122], ['REG AIR', 428026], ['SHIP', 427520],
               ['TRUCK', 427384]],
              [['AIR', 214399], ['FOB', 214093], ['MAIL', 214097],
               ['RAIL', 213061], ['REG AIR', 214013], ['SHIP', 213760],
               ['TRUCK', 213692]]]]},
        "compiled": {"mode": "dynamic", "memo": None,
                     "counters": [2, 0, 0, 0, 0, 0, 0]}},
    "C7": {
        "dynamic": {"counters": [6, 0, 0, 0, 0, 0, 0], "rows":
            [[['1-URGENT', '5-LOW', '2-HIGH', '3-MEDIUM', '4-NOT SPECIFIED'],
              5, 15, 1]]},
        "compiled": {"mode": "dynamic", "memo": None,
                     "counters": [6, 0, 0, 0, 0, 0, 0]}},
    "C8": {
        "dynamic": {"counters": [2, 1, 0, 0, 0, 0, 0], "rows":
            [['Brand#11', 7784, 3414, 7784, 7377, 224012, 3854,
              'STEEL,THISTLE,TOMATO,WHITE,YELLOW', 60210, 1282, 36858, 1225,
              58353, 'yellowstandard turquoiseanodized steelsteel'],
             ['Brand#12', 7903, 3447, 7903, 7508, 226839, 3825,
              'SALMON,SEASHELL,TAN,TURQUOISE,YELLOW', 61068, 1242, 37359,
              1194, 59465, 'yellowstandard smokeplated royalbrass'],
             ['Brand#13', 8132, 3520, 8132, 7704, 233896, 4022,
              'SMOKE,SMOKE,WHITE,WHITE,YELLOW', 62900, 1289, 38504, 1245,
              61132, 'yellowstandard turquoiseanodized gainsborotin'],
             ['Brand#14', 7956, 3440, 7956, 7559, 228849, 3813,
              'SADDLE,SALMON,SPRING,TAN,WHITE', 61547, 1243, 37679, 1186,
              59690, 'yellowstandard thistlebrushed siennabrass'],
             ['Brand#15', 7994, 3466, 7994, 7570, 229922, 3871,
              'SALMON,SIENNA,SKY,SMOKE,TURQUOISE', 61783, 1257, 37801, 1205,
              60053, 'yellowstandard yellowplated gainsborocopper'],
             ['Brand#21', 7985, 3456, 7985, 7545, 229120, 3902,
              'ROYAL,ROYAL,SKY,THISTLE,TURQUOISE', 61669, 1349, 37714, 1287,
              59812, 'yellowstandard wheatanodized springnickel'],
             ['Brand#22', 7902, 3405, 7902, 7527, 226805, 3916,
              'THISTLE,THISTLE,TOMATO,VIOLET,WHEAT', 61151, 1211, 37445, 1159,
              59308, 'yellowstandard violetpolished magentanickel'],
             ['Brand#23', 7897, 3410, 7897, 7464, 226899, 3858,
              'SMOKE,STEEL,TAN,TOMATO,TOMATO', 61049, 1238, 37358, 1181,
              59194, 'yellowstandard violetbrushed lemonbrass'],
             ['Brand#24', 8087, 3525, 8087, 7638, 232138, 3987,
              'SIENNA,SLATE,TAN,TOMATO,WHEAT', 62556, 1300, 38295, 1232,
              60838, 'yellowstandard whiteplated browncopper'],
             ['Brand#25', 7901, 3414, 7901, 7471, 227117, 3858,
              'SEASHELL,SLATE,WHITE,WHITE,YELLOW', 61071, 1302, 37368, 1237,
              59194, 'yellowstandard roseburnished skybrass'],
             ['Brand#31', 7997, 3535, 7997, 7566, 230177, 3983,
              'SANDY,SANDY,SNOW,SNOW,WHEAT', 61841, 1248, 37850, 1189, 60036,
              'yellowstandard springburnished siennanickel'],
             ['Brand#32', 8077, 3528, 8077, 7667, 231831, 4001,
              'SMOKE,SPRING,STEEL,WHEAT,YELLOW', 62486, 1291, 38255, 1221,
              60606, 'yellowstandard wheatanodized greennickel'],
             ['Brand#33', 7983, 3487, 7983, 7574, 229705, 3959,
              'SKY,SPRING,SPRING,STEEL,TOMATO', 61713, 1261, 37764, 1219,
              60010, 'yellowstandard whitepolished ghostcopper'],
             ['Brand#34', 8173, 3542, 8173, 7721, 235004, 3918,
              'SEASHELL,SEASHELL,SIENNA,VIOLET,WHEAT', 63206, 1309, 38687,
              1248, 61289, 'yellowstandard violetplated mediumnickel'],
             ['Brand#35', 8105, 3524, 8105, 7658, 232851, 3902,
              'SALMON,SLATE,SNOW,WHITE,WHITE', 62679, 1278, 38364, 1224,
              60650, 'yellowstandard smokebrushed cornsilkcopper'],
             ['Brand#41', 8134, 3602, 8134, 7717, 234078, 4092,
              'SADDLE,SALMON,TAN,WHEAT,YELLOW', 62944, 1247, 38542, 1191,
              60918, 'yellowstandard violetanodized snowbrass'],
             ['Brand#42', 8263, 3668, 8263, 7823, 237869, 4009,
              'SKY,STEEL,VIOLET,WHEAT,WHITE', 63905, 1327, 39116, 1275, 62050,
              'yellowstandard whiteburnished sandysteel'],
             ['Brand#43', 8016, 3500, 8016, 7578, 230210, 3871,
              'SIENNA,TURQUOISE,TURQUOISE,WHEAT,WHITE', 61966, 1311, 37918,
              1254, 60077, 'yellowstandard wheatbrushed dodgercopper'],
             ['Brand#44', 7875, 3392, 7875, 7478, 226362, 3785,
              'SLATE,SNOW,STEEL,VIOLET,YELLOW', 60941, 1221, 37316, 1177,
              59229, 'yellowstandard redplated skynickel'],
             ['Brand#45', 7939, 3528, 7939, 7525, 228929, 3830,
              'SLATE,SMOKE,TOMATO,TOMATO,YELLOW', 61482, 1188, 37665, 1142,
              59594, 'yellowstandard wheatplated siennanickel'],
             ['Brand#51', 8076, 3544, 8076, 7629, 232343, 3891,
              'SKY,SNOW,TOMATO,WHITE,WHITE', 62444, 1303, 38216, 1249, 60487,
              'yellowstandard yellowanodized navycopper'],
             ['Brand#52', 7916, 3416, 7916, 7481, 227365, 3898,
              'SANDY,SLATE,TOMATO,VIOLET,WHITE', 61159, 1334, 37411, 1283,
              59139, 'yellowstandard tomatopolished dodgernickel'],
             ['Brand#53', 7959, 3458, 7959, 7522, 228613, 3859,
              'SIENNA,THISTLE,TOMATO,TOMATO,WHEAT', 61442, 1308, 37565, 1247,
              59803, 'yellowstandard whiteplated creamtin'],
             ['Brand#54', 7947, 3407, 7947, 7532, 228261, 3864,
              'TAN,TAN,THISTLE,TOMATO,WHITE', 61442, 1278, 37601, 1216, 59475,
              'yellowstandard turquoiseplated limesteel'],
             ['Brand#55', 7999, 3404, 7999, 7531, 229328, 3877,
              'TURQUOISE,TURQUOISE,VIOLET,VIOLET,YELLOW', 61751, 1376, 37754,
              1310, 59944, 'yellowstandard whiteplated siennanickel']]},
        "compiled": {"mode": "dynamic", "memo": None,
                     "counters": [2, 1, 0, 0, 0, 0, 0]}},
    "C9": {
        "dynamic": {"counters": [1, 0, 0, 0, 0, 0, 0], "rows":
            [['ALGERIA', 'carefully', 2, [['x', 1], ['y', 2]],
              [[10, 'u'], [20, 'v']], [1.0, 2.0], [1, 'z'], None, 'even',
              'z'],
             ['ARGENTINA', 'after', 2, [['x', 1], ['y', 2]],
              [[10, 'u'], [20, 'v']], [1.0, 2.0], [1, 'z'], None, 'bold',
              'z'],
             ['BRAZIL', 'at', 2, [['x', 1], ['y', 2]], [[10, 'u'], [20, 'v']],
              [1.0, 2.0], [1, 'z'], None, 'theodolites', 'z'],
             ['CANADA', 'unusual', 2, [['x', 1], ['y', 2]],
              [[10, 'u'], [20, 'v']], [1.0, 2.0], [1, 'z'], None, 'against',
              'z'],
             ['CHINA', 'before', 2, [['x', 1], ['y', 2]],
              [[10, 'u'], [20, 'v']], [1.0, 2.0], [1, 'z'], None, 'quickly',
              'z']]},
        "compiled": {"mode": "dynamic", "memo": None,
                     "counters": [1, 0, 0, 0, 0, 0, 0]}},
}

REFERENCE_COUNTERS_SF1.update({
    name: {mode: v[mode]["counters"] for mode in ("dynamic", "compiled")}
    for name, v in COLL_REFERENCE_SF1.items()})
REFERENCE_MEMO_SF1.update({name: v["compiled"]["memo"]
                           for name, v in COLL_REFERENCE_SF1.items()})
# presto_tpu's values of the statement corpus (presto_tpu_torch/
# statement_queries.py) at SF1 on the CPU, each fact once: "dynamic"
# whole, {id: {"rows", "stats" (execution_mode, rows_written,
# bytes_written, write_files), "counters", "digest"
# (statement_queries.table_digest of the table written; None, or the id
# of an earlier statement whose digest it equals)}}, "auto" and
# "compiled" only what differs (statement_queries.expand_reference
# gives each mode whole; "compiled" runs D2 and D3 alone), from
# `JAX_PLATFORMS=cpu python -m tests.test_torch_statements 1 <cache dir>`
WRITE_REFERENCE_SF1 = {
    "dynamic": {
        "D1": {'rows': [[4]],
               'stats': ['dynamic', 4, 128, 0],
               'counters': [2, 0, 0, 0, 0, 0, 0],
               'digest': {'rows': 4,
                          'sums': {'l_returnflag': 7282263060,
                                   'l_linestatus': 4791522564,
                                   'revenue': 217915044563.13873,
                                   'n': 6000601},
                          'order': {'l_returnflag': 3440020942,
                                    'l_linestatus': 391525534,
                                    'n': 3488851466},
                          'pages': [[None, 4, 0, 17728647867162783916]],
                          'ordering': [],
                          'write_properties': {}}},
        "D2": {'rows': [[6000601]],
               'stats': ['dynamic', 6000601, 264026444, 0],
               'counters': [0, 0, 0, 0, 0, 0, 0],
               'digest': {'rows': 6000601,
                          'sums': {'l_orderkey': 18000712696407,
                                   'l_partkey': 599938387411,
                                   'l_suppkey': 30006943654,
                                   'l_quantity': 152962802.0,
                                   'l_extendedprice': 229385261723.15994,
                                   'l_shipdate': 55711075191},
                          'order': {'l_orderkey': 4052313609,
                                    'l_partkey': 1476067890,
                                    'l_suppkey': 3766950701,
                                    'l_shipdate': 3795576022},
                          'pages': [[0,
                                     375037,
                                     1062493734,
                                     10373469860454308264],
                                    [1,
                                     375038,
                                     2758154998,
                                     13729658309794533905],
                                    [2,
                                     375037,
                                     2064473759,
                                     13198620046059947235],
                                    [3,
                                     375038,
                                     1727707307,
                                     3745574045033612199],
                                    [4,
                                     375037,
                                     697100398,
                                     2382789346324655637],
                                    [5,
                                     375038,
                                     3590820923,
                                     4774727483628575127],
                                    [6,
                                     375037,
                                     253767043,
                                     9461722880552679716],
                                    [7,
                                     375038,
                                     1993808994,
                                     5916474618947862703],
                                    [8,
                                     375038,
                                     4170406215,
                                     7052688778219356101],
                                    [9,
                                     375037,
                                     1593632121,
                                     224710989465175767],
                                    [10,
                                     375038,
                                     592496536,
                                     6449817989757345545],
                                    [11,
                                     375037,
                                     1623786506,
                                     17719680324542538508],
                                    [12,
                                     375038,
                                     1752444774,
                                     13521067166114719672],
                                    [13,
                                     375037,
                                     1815139045,
                                     11737851673271795461],
                                    [14,
                                     375038,
                                     3028194326,
                                     5400659748630729758],
                                    [15,
                                     375038,
                                     110006983,
                                     3122278900057759766]],
                          'ordering': [['l_orderkey', True]],
                          'write_properties': {'bucketed_by': ['l_orderkey'],
                                               'bucket_count': 16,
                                               'sorted_by': [['l_orderkey',
                                                              True]],
                                               'partitioned_by': [],
                                               'bucketing': 'range'}}},
        "D3": {'rows': [[1500000]],
               'stats': ['dynamic', 1500000, 54000000, 0],
               'counters': [0, 0, 0, 0, 1, 1, 0],
               'digest': {'rows': 1500000,
                          'sums': {'o_orderkey': 4499982750000,
                                   'o_custkey': 112410436586,
                                   'o_orderdate': 13835178342,
                                   'o_totalprice': 413171118835.98004,
                                   'c_mktsegment': 1969628282709100},
                          'order': {'o_orderkey': 571030903,
                                    'o_custkey': 3568677477,
                                    'o_orderdate': 382975859,
                                    'c_mktsegment': 3557076221},
                          'pages': [[0,
                                     46200,
                                     3170668444,
                                     9501530312027532639],
                                    [1,
                                     47911,
                                     3871099761,
                                     12154285186535632341],
                                    [2,
                                     48063,
                                     1990486797,
                                     15227873504006070347],
                                    [3,
                                     47191,
                                     406836151,
                                     12940103470621851133],
                                    [4,
                                     48639,
                                     4032501074,
                                     5531233265718070757],
                                    [5,
                                     47207,
                                     227101738,
                                     17781717197147077130],
                                    [6,
                                     45049,
                                     2865047219,
                                     17137662449740219115],
                                    [7,
                                     46645,
                                     1929580275,
                                     10397137722776177275],
                                    [8,
                                     46522,
                                     2868018335,
                                     6160963211707744066],
                                    [9,
                                     47376,
                                     2172888073,
                                     9464063111470653473],
                                    [10,
                                     46694,
                                     2630417796,
                                     808084568111723230],
                                    [11,
                                     46066,
                                     2708764964,
                                     4250865577872899522],
                                    [12,
                                     46290,
                                     1915384664,
                                     17234266875047924936],
                                    [13,
                                     45913,
                                     1578457035,
                                     13097640272416831189],
                                    [14,
                                     47915,
                                     804950781,
                                     13015708054966350472],
                                    [15,
                                     47003,
                                     3998820902,
                                     9386840027128710724],
                                    [16, 47262, 27190900, 329823791178458594],
                                    [17,
                                     45784,
                                     720457127,
                                     10179929848205196285],
                                    [18,
                                     48027,
                                     2979778674,
                                     9570627576061540595],
                                    [19,
                                     47261,
                                     1156129540,
                                     15746228242359397155],
                                    [20,
                                     47457,
                                     4125358659,
                                     3906764041924922762],
                                    [21,
                                     47020,
                                     105710059,
                                     9200058825272207838],
                                    [22,
                                     46709,
                                     2212311170,
                                     6583293621926476402],
                                    [23,
                                     46432,
                                     2690386008,
                                     8751495803162005527],
                                    [24,
                                     47959,
                                     2169923588,
                                     1424580822712666080],
                                    [25,
                                     46909,
                                     801340972,
                                     7123967026564405549],
                                    [26,
                                     46931,
                                     3523507467,
                                     3161986173376017571],
                                    [27,
                                     46138,
                                     1160466409,
                                     17816042745875774252],
                                    [28,
                                     45957,
                                     1968237334,
                                     218282267407569823],
                                    [29,
                                     46706,
                                     4178986938,
                                     17406628685156141677],
                                    [30,
                                     45533,
                                     4179496106,
                                     13560084800555174987],
                                    [31,
                                     47231,
                                     332245264,
                                     3087029044858133476]],
                          'ordering': [],
                          'write_properties': {'bucketed_by': ['o_custkey'],
                                               'bucket_count': 32,
                                               'sorted_by': [['o_orderdate',
                                                              False]],
                                               'partitioned_by': [],
                                               'bucketing': 'hash'}}},
        "D4": {'rows': [[1]],
               'stats': ['dynamic', 1, 32, 0],
               'counters': [2, 0, 0, 0, 0, 0, 0],
               'digest': {'rows': 5,
                          'sums': {'l_returnflag': 8413054766,
                                   'l_linestatus': 5670340752,
                                   'revenue': 219406580004.36584,
                                   'n': 6041449},
                          'order': {'l_returnflag': 3333037312,
                                    'l_linestatus': 2299748226,
                                    'n': 517636972},
                          'pages': [[None, 1, 0, 17328790111027156804]],
                          'ordering': [],
                          'write_properties': {}}},
        "D5": {'rows': [[1, 6, 216225.16999999998, 23.666666666666668],
                        [2, 5, 143581.9, 17.0],
                        [3, 2, 44272.259999999995, 15.5],
                        [4, 5, 182242.97999999998, 31.8],
                        [5, 4, 117708.00000000001, 23.0],
                        [6, 4, 146859.29, 23.25],
                        [7, 2, 84985.19, 26.5],
                        [8, 6, 225588.71000000002, 24.666666666666668],
                        [33, 3, 91655.84000000001, 16.666666666666668],
                        [34, 4, 172245.90000000002, 27.25],
                        [35, 3, 71938.85, 15.333333333333334],
                        [36, 3, 64653.04, 14.333333333333334],
                        [37, 4, 174365.15, 37.25],
                        [38, 5, 232782.41999999998, 33.6],
                        [39, 5, 287528.68, 34.8],
                        [40, 2, 113435.02, 29.5]],
               'stats': ['dynamic', 0, 0, 0],
               'counters': [3, 3, 0, 0, 0, 0, 0],
               'digest': None},
        "D6a": {'rows': [[True]],
                'stats': ['', 0, 0, 0],
                'counters': [0, 0, 0, 0, 0, 0, 0],
                'digest': None},
        "D6b": {'rows': [[63]],
                'stats': ['dynamic', 63, 2772, 0],
                'counters': [0, 0, 0, 0, 0, 0, 0],
                'digest': {'rows': 6000664,
                           'sums': {'l_orderkey': 18000712697616,
                                    'l_partkey': 599944866108,
                                    'l_suppkey': 30007275810,
                                    'l_quantity': 152964403.0,
                                    'l_extendedprice': 229387631791.55994,
                                    'l_shipdate': 55711658206},
                           'order': {'l_orderkey': 1040595681,
                                     'l_partkey': 358890581,
                                     'l_suppkey': 387564063,
                                     'l_shipdate': 2736460530},
                           'pages': [[0, 3, 1076248072, 6667826826418334825],
                                     [1, 4, 2243470284, 9090345071474682435],
                                     [2, 4, 1030862505, 4348875220560982218],
                                     [3, 4, 3631265351, 1825735520871590402],
                                     [4, 4, 2639762235, 2028635094330738044],
                                     [5, 4, 3444532676, 9252934060488713528],
                                     [6, 4, 3106697279, 2134746604835902518],
                                     [7, 4, 3546611580, 6627373296233190990],
                                     [8, 4, 1859952832, 11272776493763599898],
                                     [9, 4, 2254253501, 17066418462451230145],
                                     [10, 4, 1973296421, 7033768438804316735],
                                     [11, 4, 3276127155, 10866114333438723113],
                                     [12, 4, 1777162404, 15566746872201256167],
                                     [13, 4, 1605061154, 13265740317318022533],
                                     [14, 4, 3159145994, 8935519278759784929],
                                     [15, 4, 442289718, 6600025768366363160]],
                           'ordering': [],
                           'write_properties': {'bucketed_by': ['l_orderkey'],
                                                'bucket_count': 16,
                                                'sorted_by': [['l_orderkey',
                                                               True]],
                                                'partitioned_by': [],
                                                'bucketing': 'range'}}},
        "D6c": {'rows': [[True]],
                'stats': ['', 0, 0, 0],
                'counters': [0, 0, 0, 0, 0, 0, 0],
                'digest': {'rows': 6000601,
                           'sums': {'l_orderkey': 18000712696407,
                                    'l_partkey': 599938387411,
                                    'l_suppkey': 30006943654,
                                    'l_quantity': 152962802.0,
                                    'l_extendedprice': 229385261723.15994,
                                    'l_shipdate': 55711075191},
                           'order': {'l_orderkey': 4052313609,
                                     'l_partkey': 1476067890,
                                     'l_suppkey': 3766950701,
                                     'l_shipdate': 3795576022},
                           'pages': [],
                           'ordering': [],
                           'write_properties': {'bucketed_by': ['l_orderkey'],
                                                'bucket_count': 16,
                                                'sorted_by': [['l_orderkey',
                                                               True]],
                                                'partitioned_by': [],
                                                'bucketing': 'range'}}},
        "D6d": {'rows': [[1, 6, 216225.16999999998, 23.666666666666668],
                         [2, 5, 143581.9, 17.0],
                         [3, 2, 44272.259999999995, 15.5],
                         [4, 5, 182242.97999999998, 31.8],
                         [5, 4, 117708.00000000001, 23.0],
                         [6, 4, 146859.29, 23.25],
                         [7, 2, 84985.19, 26.5],
                         [8, 6, 225588.71000000002, 24.666666666666668],
                         [33, 3, 91655.84000000001, 16.666666666666668],
                         [34, 4, 172245.90000000002, 27.25],
                         [35, 3, 71938.85, 15.333333333333334],
                         [36, 3, 64653.04, 14.333333333333334],
                         [37, 4, 174365.15, 37.25],
                         [38, 5, 232782.41999999998, 33.6],
                         [39, 5, 287528.68, 34.8],
                         [40, 2, 113435.02, 29.5]],
                'stats': ['dynamic', 0, 0, 0],
                'counters': [5, 1, 0, 0, 0, 0, 0],
                'digest': None},
        "D6e": {'rows': [[True]],
                'stats': ['', 0, 0, 0],
                'counters': [0, 0, 0, 0, 0, 0, 0],
                'digest': None},
        "D6f": {'rows': [[63]],
                'stats': ['dynamic', 63, 2772, 0],
                'counters': [0, 0, 0, 0, 0, 0, 0],
                'digest': 'D6b'},
        "D6g": {'rows': [[True]],
                'stats': ['', 0, 0, 0],
                'counters': [0, 0, 0, 0, 0, 0, 0],
                'digest': None},
        "D6h": {'rows': [[1, 12, 432450.33999999997, 23.666666666666668],
                         [2, 10, 287163.8, 17.0],
                         [3, 4, 88544.51999999999, 15.5],
                         [4, 10, 364485.95999999996, 31.8],
                         [5, 8, 235416.00000000003, 23.0],
                         [6, 8, 293718.58, 23.25],
                         [7, 4, 169970.38, 26.5],
                         [8, 12, 451177.42000000004, 24.666666666666668],
                         [33, 6, 183311.68000000002, 16.666666666666668],
                         [34, 8, 344491.80000000005, 27.25],
                         [35, 6, 143877.7, 15.333333333333334],
                         [36, 6, 129306.08, 14.333333333333334],
                         [37, 8, 348730.3, 37.25],
                         [38, 10, 465564.83999999997, 33.6],
                         [39, 10, 575057.36, 34.8],
                         [40, 4, 226870.04, 29.5]],
                'stats': ['dynamic', 0, 0, 0],
                'counters': [5, 1, 0, 0, 0, 0, 0],
                'digest': None},
        "D7": {'rows': [[230760]],
               'stats': ['', 0, 0, 0],
               'counters': [0, 0, 0, 0, 0, 0, 0],
               'digest': {'rows': 1269240,
                          'sums': {'o_orderkey': 3809388147250,
                                   'o_custkey': 95107716651,
                                   'o_orderdate': 11938994564,
                                   'o_totalprice': 349575944840.7001,
                                   'c_mktsegment': 1666005639885784},
                          'order': {'o_orderkey': 1134454733,
                                    'o_custkey': 2938699618,
                                    'o_orderdate': 4009424219,
                                    'c_mktsegment': 1115422708},
                          'pages': [],
                          'ordering': [],
                          'write_properties': {'bucketed_by': ['o_custkey'],
                                               'bucket_count': 32,
                                               'sorted_by': [['o_orderdate',
                                                              False]],
                                               'partitioned_by': [],
                                               'bucketing': 'hash'}}},
        "D7b": {'rows': [[1269240, 349575944840.7, 8401]],
                'stats': ['dynamic', 0, 0, 0],
                'counters': [0, 0, 0, 0, 0, 0, 0],
                'digest': None},
        "D8a": {'rows': [["Output [('l_orderkey', 'l_orderkey$14'), ('n', "
                          "'n$15'), ('revenue', 'revenue$16'), ('qty', "
                          "'qty$17')]  {rows: 1,692,507}\n"
                          "  Sort [('l_orderkey$14', True, None)]  {rows: "
                          '1,692,507}\n'
                          '    Project {l_orderkey$14 := l_orderkey$0, n$15 '
                          ':= count$11, revenue$16 := sum$12, qty$17 := '
                          'avg$13}  {rows: 1,692,507}\n'
                          "      Aggregate SINGLE keys=['l_orderkey$0'] "
                          '{count$11 := count(), sum$12 := '
                          'sum(l_extendedprice$4), avg$13 := '
                          'avg(l_quantity$3)}  {rows: 1,692,507}\n'
                          '        Project {l_orderkey$0 := l_orderkey$0, '
                          'l_quantity$3 := l_quantity$3, l_extendedprice$4 := '
                          'l_extendedprice$4}  {rows: 1,692,507}\n'
                          "          Join INNER [('l_orderkey$0', "
                          "'o_orderkey$6')]  {rows: 1,692,507}\n"
                          '            Filter [lt(l_orderkey$0, CAST(64 AS '
                          'BIGINT))]  {rows: 2,000,221}\n'
                          "              TableScan li_range ['l_orderkey', "
                          "'l_quantity', 'l_extendedprice']  {rows: "
                          '6,000,664}\n'
                          "            TableScan ord_hash ['o_orderkey']  "
                          '{rows: 1,269,240}']],
                'stats': ['', 0, 0, 0],
                'counters': [0, 0, 0, 0, 0, 0, 0],
                'digest': None},
        "D8b": {'rows': [["Output [('l_returnflag', 'l_returnflag$4'), "
                          "('l_linestatus', 'l_linestatus$5'), ('revenue', "
                          "'revenue$6'), ('n', 'n$7')]   <- rows=5 time=?\n"
                          "  Sort [('l_returnflag$4', True, None), "
                          "('l_linestatus$5', True, None)]   <- rows=5 "
                          'time=?\n'
                          '    Project {l_returnflag$4 := l_returnflag$0, '
                          'l_linestatus$5 := l_linestatus$1, revenue$6 := '
                          'revenue$2, n$7 := n$3}   <- rows=5 time=?\n'
                          "      TableScan rev ['l_returnflag', "
                          "'l_linestatus', 'revenue', 'n']   <- rows=5 "
                          'time=?']],
                'stats': ['dynamic', 0, 0, 0],
                'counters': [1, 0, 0, 0, 0, 0, 0],
                'digest': None},
        "D8c": {'rows': [['CREATE TABLE li_range (\n'
                          '   l_orderkey bigint,\n'
                          '   l_partkey bigint,\n'
                          '   l_suppkey bigint,\n'
                          '   l_quantity double,\n'
                          '   l_extendedprice double,\n'
                          '   l_shipdate date\n'
                          ')\n'
                          'WITH (\n'
                          "   connector = 'memory',\n"
                          "   bucketed_by = ARRAY['l_orderkey'],\n"
                          '   bucket_count = 16,\n'
                          "   sorted_by = ARRAY['l_orderkey asc']\n"
                          ')']],
                'stats': ['', 0, 0, 0],
                'counters': [0, 0, 0, 0, 0, 0, 0],
                'digest': None},
        "D8d": {'rows': [['o_orderkey', 'BIGINT'],
                         ['o_custkey', 'BIGINT'],
                         ['o_orderdate', 'DATE'],
                         ['o_totalprice', 'DOUBLE'],
                         ['c_mktsegment', 'VARCHAR'],
                         ['# sorted_by', 'o_orderdate DESC'],
                         ['# bucketed_by', 'o_custkey (hash, 32 buckets)']],
                'stats': ['', 0, 0, 0],
                'counters': [0, 0, 0, 0, 0, 0, 0],
                'digest': None},
        "D8e": {'rows': [['l_orderkey', 1500000.0, 1.0, 5999976.0, None],
                         ['l_partkey', 200000.0, 1.0, 200000.0, None],
                         ['l_suppkey', 10000.0, 1.0, 10000.0, None],
                         ['l_quantity', 50.0, 1.0, 50.0, None],
                         ['l_extendedprice',
                          965158.0,
                          901.0,
                          104949.50000000001,
                          None],
                         ['l_shipdate', 2496.0, 8036.0, 10531.0, None],
                         [None, None, None, None, 6000664.0]],
                'stats': ['', 0, 0, 0],
                'counters': [0, 0, 0, 0, 0, 0, 0],
                'digest': None},
        "D8f": {'rows': [['customer'],
                         ['li_range'],
                         ['lineitem'],
                         ['nation'],
                         ['ord_hash'],
                         ['orders'],
                         ['part'],
                         ['partsupp'],
                         ['region'],
                         ['rev'],
                         ['supplier']],
                'stats': ['', 0, 0, 0],
                'counters': [0, 0, 0, 0, 0, 0, 0],
                'digest': None},
        "D8g": {'rows': [[True]],
                'stats': ['', 0, 0, 0],
                'counters': [0, 0, 0, 0, 0, 0, 0],
                'digest': None},
        "D9": {'rows': [[True]],
               'stats': ['', 0, 0, 0],
               'counters': [0, 0, 0, 0, 0, 0, 0],
               'digest': None},
        "D9b": {'rows': [['customer'],
                         ['li_range'],
                         ['lineitem'],
                         ['nation'],
                         ['ord_hash'],
                         ['orders'],
                         ['part'],
                         ['partsupp'],
                         ['region'],
                         ['supplier']],
                'stats': ['', 0, 0, 0],
                'counters': [0, 0, 0, 0, 0, 0, 0],
                'digest': None},
    },
    "auto": {
        "D5": {'stats': ['compiled', 0, 0, 0]},
        "D6d": {'stats': ['compiled', 0, 0, 0]},
        "D6h": {'rows': [[1, 12, 432450.33999999997, 23.666666666666668],
                         [2, 10, 287163.8, 17.0],
                         [3, 4, 88544.51999999999, 15.5],
                         [4, 10, 364485.9599999999, 31.8],
                         [5, 8, 235416.00000000006, 23.0],
                         [6, 8, 293718.58, 23.25],
                         [7, 4, 169970.38, 26.5],
                         [8, 12, 451177.4199999999, 24.666666666666668],
                         [33, 6, 183311.68000000002, 16.666666666666668],
                         [34, 8, 344491.80000000005, 27.25],
                         [35, 6, 143877.7, 15.333333333333334],
                         [36, 6, 129306.08, 14.333333333333334],
                         [37, 8, 348730.3, 37.25],
                         [38, 10, 465564.83999999997, 33.6],
                         [39, 10, 575057.3600000001, 34.8],
                         [40, 4, 226870.04, 29.5]],
                'stats': ['compiled', 0, 0, 0]},
        "D7b": {'stats': ['compiled', 0, 0, 0]},
    },
    "compiled": {
        "D2": {'stats': ['compiled', 6000601, 288028848, 0]},
        "D3": {'stats': ['compiled', 1500000, 60000000, 0]},
    },
}

# presto_tpu's counters and memo entry of each query at each scale
# factor the card holds it there, {sf: {name: ...}}; the TPC-DS queries
# keyed "ds<Q>"
# presto_tpu's values of the decimal corpus (presto_tpu_torch/
# decimal_queries.py) at SF1 on the CPU, each fact once: "dynamic" whole,
# {id: {"rows" (a Decimal as "d:<text>"), "types", "error" ([type,
# first line of the message] or None), "mode", "counters", "memo"}},
# "auto" and "compiled" only what differs (decimal_queries.
# expand_reference gives each mode whole), from `JAX_PLATFORMS=cpu
# python -m tests.torch_decimal_common 1 <cache dir>`
DEC_REFERENCE_SF1 = {'dynamic': {'N1a': {'error': None,
                     'rows': [[6000601]],
                     'types': ['BIGINT'],
                     'mode': 'dynamic',
                     'counters': [0, 0, 0, 0, 0, 0, 0],
                     'memo': []},
             'N1b': {'error': None,
                     'rows': [[1500000]],
                     'types': ['BIGINT'],
                     'mode': 'dynamic',
                     'counters': [0, 0, 0, 0, 0, 0, 0],
                     'memo': []},
             'N2': {'error': None,
                    'rows': [['A',
                              'F',
                              'd:38175716.00',
                              'd:57244104191.08',
                              'd:54380485143.6237',
                              25.499521412850715,
                              38236.27723393264,
                              0.05002616365462454,
                              1497115],
                             ['N',
                              'F',
                              'd:997717.00',
                              'd:1496531023.67',
                              'd:1422159975.6779',
                              25.429907733088648,
                              38143.7279826169,
                              0.0497955854615663,
                              39234],
                             ['N',
                              'O',
                              'd:74647007.00',
                              'd:111937609235.44',
                              'd:106339180109.1461',
                              25.49094906967111,
                              38225.18826510378,
                              0.05002359330582434,
                              2928373],
                             ['R',
                              'F',
                              'd:38158831.00',
                              'd:57232240751.99',
                              'd:54372266278.0123',
                              25.480362959391766,
                              38216.53413177039,
                              0.049983927381276584,
                              1497578]],
                    'types': ['VARCHAR',
                              'VARCHAR',
                              'DECIMAL(38,2)',
                              'DECIMAL(38,2)',
                              'DECIMAL(38,4)',
                              'DOUBLE',
                              'DOUBLE',
                              'DOUBLE',
                              'BIGINT'],
                    'mode': 'dynamic',
                    'counters': [2, 1, 0, 0, 0, 0, 0],
                    'memo': []},
             'N3': {'error': ['NotImplementedError',
                              'long-decimal x long-decimal multiply '
                              '(128x128) is not supported; cast one side '
                              'down or to DOUBLE'],
                    'rows': None,
                    'memo': []},
             'N4': {'error': None,
                    'rows': [['d:124264691.8866']],
                    'types': ['DECIMAL(38,4)'],
                    'mode': 'dynamic',
                    'counters': [0, 0, 0, 0, 0, 0, 0],
                    'memo': []},
             'N5': {'error': None,
                    'rows': [[1708744, 'd:406285.3865', 9194, 0, 75099.93],
                             [3432737, 'd:396873.5829', 9196, 0, 90261.37],
                             [5645442, 'd:390060.8908', 9201, 0, 513634.21],
                             [4746277, 'd:389356.6019', 9187, 0, 12253.31],
                             [5405825, 'd:388245.7642', 9195, 0, 472585.09],
                             [340488, 'd:382034.2307', 9201, 0, 467699.0],
                             [3437922, 'd:380195.0782', 9178, 0, 271912.85],
                             [826277, 'd:376878.2186', 9196, 0, 53695.73],
                             [3527746, 'd:376737.2668', 9188, 0, 482586.82],
                             [2759432,
                              'd:375577.1538',
                              9188,
                              0,
                              173744.75]],
                    'types': ['BIGINT',
                              'DECIMAL(38,4)',
                              'DATE',
                              'INTEGER',
                              'DECIMAL(12,2)'],
                    'mode': 'dynamic',
                    'counters': [6, 0, 0, 0, 2, 2, 6569069],
                    'memo': []},
             'N6': {'error': None,
                    'rows': [['Customer#000051242',
                              51242,
                              5631618,
                              9144,
                              549072.04,
                              'd:305.00'],
                             ['Customer#000103718',
                              103718,
                              587844,
                              9304,
                              543416.11,
                              'd:310.00'],
                             ['Customer#000090776',
                              90776,
                              1443112,
                              8062,
                              525181.12,
                              'd:309.00'],
                             ['Customer#000044053',
                              44053,
                              2214690,
                              10136,
                              516285.33,
                              'd:310.00'],
                             ['Customer#000090877',
                              90877,
                              4845704,
                              8509,
                              501237.27,
                              'd:302.00'],
                             ['Customer#000114593',
                              114593,
                              4543938,
                              8718,
                              499704.46,
                              'd:309.00'],
                             ['Customer#000022078',
                              22078,
                              608903,
                              9900,
                              496791.87,
                              'd:306.00'],
                             ['Customer#000040091',
                              40091,
                              3458788,
                              9118,
                              496637.33,
                              'd:309.00'],
                             ['Customer#000043895',
                              43895,
                              1628997,
                              9739,
                              474452.36,
                              'd:302.00'],
                             ['Customer#000117746',
                              117746,
                              1032229,
                              10347,
                              469396.35,
                              'd:305.00'],
                             ['Customer#000077156',
                              77156,
                              691816,
                              9420,
                              448743.17,
                              'd:303.00'],
                             ['Customer#000044318',
                              44318,
                              5239397,
                              9478,
                              448460.21,
                              'd:311.00'],
                             ['Customer#000006425',
                              6425,
                              3428551,
                              9328,
                              440416.7,
                              'd:302.00'],
                             ['Customer#000025184',
                              25184,
                              4978145,
                              9080,
                              433412.61,
                              'd:311.00'],
                             ['Customer#000091514',
                              91514,
                              378469,
                              9222,
                              430690.16,
                              'd:304.00'],
                             ['Customer#000118574',
                              118574,
                              814885,
                              9721,
                              429294.49,
                              'd:303.00'],
                             ['Customer#000099872',
                              99872,
                              1080580,
                              9966,
                              410705.56,
                              'd:309.00'],
                             ['Customer#000054523',
                              54523,
                              2054053,
                              9267,
                              409750.27,
                              'd:306.00'],
                             ['Customer#000110849',
                              110849,
                              1810632,
                              9386,
                              396152.46,
                              'd:301.00'],
                             ['Customer#000014897',
                              14897,
                              692705,
                              9784,
                              385693.01,
                              'd:301.00'],
                             ['Customer#000143360',
                              143360,
                              2012966,
                              9275,
                              372866.45,
                              'd:302.00'],
                             ['Customer#000006730',
                              6730,
                              1455432,
                              9526,
                              368658.34,
                              'd:308.00'],
                             ['Customer#000010109',
                              10109,
                              5862754,
                              8835,
                              342439.16,
                              'd:304.00'],
                             ['Customer#000115169',
                              115169,
                              4399906,
                              8677,
                              337801.05,
                              'd:301.00'],
                             ['Customer#000093863',
                              93863,
                              4626658,
                              8828,
                              328607.27,
                              'd:301.00'],
                             ['Customer#000020246',
                              20246,
                              402628,
                              9720,
                              320473.19,
                              'd:308.00'],
                             ['Customer#000076327',
                              76327,
                              4734116,
                              9941,
                              318386.04,
                              'd:313.00'],
                             ['Customer#000036173',
                              36173,
                              3236102,
                              8235,
                              313647.4,
                              'd:309.00'],
                             ['Customer#000125753',
                              125753,
                              2464387,
                              9776,
                              306293.21,
                              'd:302.00'],
                             ['Customer#000050960',
                              50960,
                              1357222,
                              8081,
                              300183.42,
                              'd:305.00'],
                             ['Customer#000136943',
                              136943,
                              5560870,
                              8880,
                              298344.74,
                              'd:302.00'],
                             ['Customer#000066944',
                              66944,
                              5174950,
                              8237,
                              292593.85,
                              'd:305.00'],
                             ['Customer#000069727',
                              69727,
                              875814,
                              9701,
                              289690.85,
                              'd:303.00'],
                             ['Customer#000142148',
                              142148,
                              5125474,
                              8617,
                              286523.95,
                              'd:323.00'],
                             ['Customer#000081184',
                              81184,
                              1665698,
                              10307,
                              277102.22,
                              'd:302.00'],
                             ['Customer#000129566',
                              129566,
                              5130598,
                              10263,
                              267973.04,
                              'd:301.00'],
                             ['Customer#000053366',
                              53366,
                              1201256,
                              9111,
                              262790.89,
                              'd:302.00'],
                             ['Customer#000069704',
                              69704,
                              462689,
                              9400,
                              261514.74,
                              'd:306.00'],
                             ['Customer#000112082',
                              112082,
                              926757,
                              9456,
                              253631.38,
                              'd:302.00'],
                             ['Customer#000080141',
                              80141,
                              3955783,
                              10158,
                              225068.04,
                              'd:301.00'],
                             ['Customer#000028556',
                              28556,
                              5992930,
                              9138,
                              207941.52,
                              'd:321.00'],
                             ['Customer#000137560',
                              137560,
                              4734626,
                              9562,
                              191394.91,
                              'd:306.00'],
                             ['Customer#000089378',
                              89378,
                              4562183,
                              8759,
                              191233.04,
                              'd:309.00'],
                             ['Customer#000034388',
                              34388,
                              1175173,
                              9057,
                              181961.38,
                              'd:306.00'],
                             ['Customer#000063106',
                              63106,
                              3963201,
                              8262,
                              181576.07,
                              'd:301.00'],
                             ['Customer#000069293',
                              69293,
                              2788903,
                              9034,
                              169350.37,
                              'd:324.00'],
                             ['Customer#000070001',
                              70001,
                              1835170,
                              8497,
                              154290.2,
                              'd:302.00'],
                             ['Customer#000128612',
                              128612,
                              3176999,
                              8985,
                              147732.55,
                              'd:303.00'],
                             ['Customer#000093476',
                              93476,
                              3532419,
                              8859,
                              144413.39,
                              'd:303.00'],
                             ['Customer#000071884',
                              71884,
                              3733313,
                              9397,
                              130545.05,
                              'd:311.00'],
                             ['Customer#000030758',
                              30758,
                              5346758,
                              10232,
                              122404.8,
                              'd:315.00'],
                             ['Customer#000102956',
                              102956,
                              5198726,
                              9421,
                              113172.82,
                              'd:305.00'],
                             ['Customer#000138139',
                              138139,
                              1931971,
                              8279,
                              112962.78,
                              'd:316.00'],
                             ['Customer#000078560',
                              78560,
                              5331079,
                              9105,
                              93830.79,
                              'd:301.00'],
                             ['Customer#000042976',
                              42976,
                              4560930,
                              9724,
                              88343.38,
                              'd:302.00'],
                             ['Customer#000028403',
                              28403,
                              3264738,
                              9580,
                              86446.79,
                              'd:308.00'],
                             ['Customer#000124535',
                              124535,
                              1834984,
                              8520,
                              61047.58,
                              'd:308.00'],
                             ['Customer#000047398',
                              47398,
                              1962629,
                              8820,
                              50172.56,
                              'd:304.00'],
                             ['Customer#000007622',
                              7622,
                              3557954,
                              9362,
                              37621.17,
                              'd:302.00'],
                             ['Customer#000027808',
                              27808,
                              3734721,
                              9297,
                              26797.47,
                              'd:323.00'],
                             ['Customer#000018508',
                              18508,
                              5791075,
                              10037,
                              16544.02,
                              'd:305.00'],
                             ['Customer#000101753',
                              101753,
                              4588775,
                              10374,
                              10228.77,
                              'd:302.00']],
                    'types': ['VARCHAR',
                              'BIGINT',
                              'BIGINT',
                              'DATE',
                              'DECIMAL(12,2)',
                              'DECIMAL(38,2)'],
                    'mode': 'dynamic',
                    'counters': [13, 1, 1, 0, 4, 4, 7500090],
                    'memo': []},
             'N7': {'error': None,
                    'rows': [['A',
                              'F',
                              57244104191.08,
                              'd:57244104191.080000',
                              'd:903.00',
                              'd:104949.55',
                              'd:57243390316.00',
                              1497115,
                              680492,
                              59877.06999999996],
                             ['N',
                              'F',
                              1496531023.67,
                              'd:1496531023.670000',
                              'd:909.00',
                              'd:103548.56',
                              'd:1496512333.00',
                              39234,
                              17730,
                              1564.61],
                             ['N',
                              'O',
                              113412385756.42,
                              'd:113412385756.420000',
                              'd:901.00',
                              'd:104799.58',
                              'd:113410972403.00',
                              2966674,
                              1348802,
                              118634.71999999994],
                             ['R',
                              'F',
                              57232240751.99,
                              'd:57232240751.990000',
                              'd:905.00',
                              'd:104899.58',
                              'd:57231526573.00',
                              1497578,
                              680084,
                              59931.35000000002]],
                    'types': ['VARCHAR',
                              'VARCHAR',
                              'DOUBLE',
                              'DECIMAL(38,6)',
                              'DECIMAL(30,2)',
                              'DECIMAL(31,2)',
                              'DECIMAL(38,2)',
                              'BIGINT',
                              'BIGINT',
                              'DOUBLE'],
                    'mode': 'dynamic',
                    'counters': [2, 1, 0, 0, 0, 0, 0],
                    'memo': []},
             'N7b': {'error': None,
                     'rows': [['ALGERIA', 'd:0.0000', '0.0', '0.00'],
                              ['ARGENTINA',
                               'd:1.2500',
                               '0.3333333333333333',
                               '1.00'],
                              ['BRAZIL',
                               'd:2.5000',
                               '0.6666666666666666',
                               '1.00'],
                              ['CANADA', 'd:3.7500', '1.0', '1.00'],
                              ['CHINA', 'd:22.5000', '6.0', '2.00'],
                              ['EGYPT',
                               'd:5.0000',
                               '1.3333333333333333',
                               '4.00'],
                              ['ETHIOPIA',
                               'd:6.2500',
                               '1.6666666666666667',
                               '0.00'],
                              ['FRANCE', 'd:7.5000', '2.0', '3.00'],
                              ['GERMANY',
                               'd:8.7500',
                               '2.3333333333333335',
                               '3.00'],
                              ['INDIA',
                               'd:10.0000',
                               '2.6666666666666665',
                               '2.00'],
                              ['INDONESIA', 'd:11.2500', '3.0', '2.00'],
                              ['IRAN',
                               'd:12.5000',
                               '3.3333333333333335',
                               '4.00'],
                              ['IRAQ',
                               'd:13.7500',
                               '3.6666666666666665',
                               '4.00'],
                              ['JAPAN', 'd:15.0000', '4.0', '2.00'],
                              ['JORDAN',
                               'd:16.2500',
                               '4.333333333333333',
                               '4.00'],
                              ['KENYA',
                               'd:17.5000',
                               '4.666666666666667',
                               '0.00'],
                              ['MOROCCO', 'd:18.7500', '5.0', '0.00'],
                              ['MOZAMBIQUE',
                               'd:20.0000',
                               '5.333333333333333',
                               '0.00'],
                              ['PERU',
                               'd:21.2500',
                               '5.666666666666667',
                               '1.00'],
                              ['ROMANIA',
                               'd:23.7500',
                               '6.333333333333333',
                               '3.00'],
                              ['RUSSIA',
                               'd:27.5000',
                               '7.333333333333333',
                               '3.00'],
                              ['SAUDI ARABIA',
                               'd:25.0000',
                               '6.666666666666667',
                               '4.00'],
                              ['UNITED KINGDOM',
                               'd:28.7500',
                               '7.666666666666667',
                               '3.00'],
                              ['UNITED STATES', 'd:30.0000', '8.0', '1.00'],
                              ['VIETNAM', 'd:26.2500', '7.0', '2.00']],
                     'types': ['VARCHAR',
                               'DECIMAL(30,4)',
                               'VARCHAR',
                               'VARCHAR'],
                     'mode': 'dynamic',
                     'counters': [1, 0, 0, 0, 0, 0, 0],
                     'memo': []},
             'N7c': {'error': ['TypeError',
                               'int() argument must be a string, a '
                               'bytes-like object or a real number, not '
                               "'list'"],
                     'rows': None,
                     'memo': []},
             'NG': {'error': None,
                    'rows': [['A',
                              0.02,
                              0.09,
                              0.0,
                              104949.5,
                              1089920,
                              483740,
                              27782293.0],
                             ['N',
                              0.02,
                              0.09,
                              0.0,
                              104799.5,
                              2186724,
                              971665,
                              55750880.0],
                             ['R',
                              0.02,
                              0.09,
                              0.0,
                              104899.5,
                              1089795,
                              484289,
                              27754524.0]],
                    'types': ['VARCHAR',
                              'DECIMAL(12,2)',
                              'DECIMAL(12,2)',
                              'DECIMAL(12,2)',
                              'DECIMAL(12,2)',
                              'BIGINT',
                              'BIGINT',
                              'DOUBLE'],
                    'mode': 'dynamic',
                    'counters': [2, 1, 0, 0, 0, 0, 0],
                    'memo': []},
             'N8a': {'error': None,
                     'rows': [[2]],
                     'types': ['BIGINT'],
                     'mode': 'dynamic',
                     'counters': [0, 0, 0, 0, 0, 0, 0],
                     'memo': []},
             'N8n': {'error': ['ExecutionError',
                               'INSERT of NULL values into column '
                               "'l_quantity' is not supported by this "
                               'connector'],
                     'rows': None,
                     'memo': []},
             'N8b': {'error': None,
                     'rows': [[240194]],
                     'types': ['BIGINT'],
                     'mode': '',
                     'counters': [0, 0, 0, 0, 0, 0, 0],
                     'memo': []},
             'N8c': {'error': None,
                     'rows': [[5760409,
                               'd:152602682.00',
                               3.0,
                               9999999999.0,
                               2703.0,
                               'd:230389.31',
                               5760409]],
                     'types': ['BIGINT',
                               'DECIMAL(38,2)',
                               'DECIMAL(12,2)',
                               'DECIMAL(12,2)',
                               'DECIMAL(12,2)',
                               'DECIMAL(38,2)',
                               'BIGINT'],
                     'mode': 'dynamic',
                     'counters': [0, 0, 0, 0, 0, 0, 0],
                     'memo': []},
             'N8d': {'error': None,
                     'rows': [['l_orderkey',
                               1490986.0,
                               1.0,
                               9000002.0,
                               None],
                              ['l_returnflag', 4.0, None, None, None],
                              ['l_linestatus', 3.0, None, None, None],
                              ['l_shipdate', 2497.0, 8036.0, 10562.0, None],
                              ['l_quantity', 48.0, 3.0, 50.0, None],
                              ['l_extendedprice',
                               893786.0,
                               2703.0,
                               9999999999.0,
                               None],
                              ['l_discount', 11.0, 0.0, 0.1, None],
                              ['l_tax', 9.0, 0.0, 0.08, None],
                              [None, None, None, None, 5760409.0]],
                     'types': ['VARCHAR',
                               'DOUBLE',
                               'DOUBLE',
                               'DOUBLE',
                               'DOUBLE'],
                     'mode': '',
                     'counters': [0, 0, 0, 0, 0, 0, 0],
                     'memo': []},
             'N9': {'error': ['ValueError',
                              'DECIMAL overflow: CAST DECIMAL(38,2) -> '
                              'DECIMAL(18,10) value does not fit a short '
                              'decimal'],
                    'rows': None,
                    'memo': []}},
 'auto': {'N1a': {},
          'N1b': {},
          'N2': {'mode': 'compiled', 'memo': ['DYNAMIC']},
          'N3': {'memo': ['DYNAMIC']},
          'N4': {'mode': 'compiled', 'memo': ['DYNAMIC']},
          'N5': {'mode': 'compiled', 'memo': ['DYNAMIC']},
          'N6': {'mode': 'compiled', 'memo': ['DYNAMIC']},
          'N7': {'mode': 'compiled', 'memo': ['DYNAMIC']},
          'N7b': {'mode': 'compiled', 'memo': ['DYNAMIC']},
          'N7c': {},
          'NG': {'mode': 'compiled',
                 'counters': [0, 1, 0, 0, 0, 0, 0],
                 'memo': ['executable']},
          'N8a': {},
          'N8n': {},
          'N8b': {},
          'N8c': {'mode': 'compiled', 'memo': ['DYNAMIC']},
          'N8d': {},
          'N9': {'memo': ['DYNAMIC']}},
 'compiled': {'N1a': {'mode': 'compiled'},
              'N1b': {'mode': 'compiled'},
              'N2': {'mode': 'compiled', 'memo': ['DYNAMIC']},
              'N3': {'memo': ['DYNAMIC']},
              'N4': {'mode': 'compiled', 'memo': ['DYNAMIC']},
              'N5': {'mode': 'compiled', 'memo': ['DYNAMIC']},
              'N6': {'mode': 'compiled', 'memo': ['DYNAMIC']},
              'N7': {'mode': 'compiled', 'memo': ['DYNAMIC']},
              'N7b': {'mode': 'compiled', 'memo': ['DYNAMIC']},
              'N7c': {'error': ['StaticFallback',
                                'The numpy.ndarray conversion method '
                                '__array__() was called on traced array '
                                'with shape int64[25,2]']},
              'NG': {'mode': 'compiled',
                     'counters': [0, 1, 0, 0, 0, 0, 0],
                     'memo': ['executable']},
              'N8a': {'mode': 'compiled'},
              'N8n': {'error': ['WriteError',
                                'INSERT of NULL values into column '
                                "'l_quantity' is not supported by this "
                                'connector']},
              'N8b': {},
              'N8c': {'mode': 'compiled', 'memo': ['DYNAMIC']},
              'N8d': {},
              'N9': {'memo': ['DYNAMIC']}}}
#: presto_tpu's values of the extended function corpus at SF1 on the CPU
#: (tests/torch_functions_ext_common.py, one query a process; E9b, which
#: raises in presto_tpu, is held to FX_DECIMAL_SF1), each fact once:
#: "dynamic" whole, "auto" and "compiled" where they differ
FX_REFERENCE_SF1 = {'auto': {'E1': {'counters': [0, 1, 0, 0, 0, 0, 0],
                 'memo': ['executable'],
                 'mode': 'compiled'},
          'E10': {},
          'E2': {'counters': [0, 1, 0, 0, 0, 0, 0],
                 'memo': ['executable'],
                 'mode': 'compiled',
                 'rows': [['1-URGENT', 2951651.310240426, 76840.84342359615,
                           741126.2829385224, 1531835.614872363, 2834142.0,
                           467352.5180099778, 2927344.9208813435,
                           2909889.357609784, 299622672.5557865, 300041],
                          ['2-HIGH', 2956315.4752777936, 76870.05885390424,
                           740860.3076549858, 1531818.4849405373, 2836884.0,
                           467370.33791687415, 2931881.6217771713,
                           2914082.393398103, 300148968.57877326, 300574],
                          ['3-MEDIUM', 2956945.593758591, 77067.64985018168,
                           743617.3963277717, 1536631.1803415786, 2840283.0,
                           468833.7039850612, 2932560.683894266,
                           2915432.5595921953, 300093324.91943234, 300519],
                          ['4-NOT SPECIFIED', 2942306.354461462,
                           76638.50710696228, 739265.5852274011,
                           1527858.1300265684, 2825474.0, 466157.0634011249,
                           2917988.972681572, 2900791.5848161154,
                           298639269.8378289, 299064],
                          ['5-LOW', 2949164.200450654, 76755.0725832261,
                           740126.2771540403, 1529925.6209772339, 2831096.0,
                           466783.8041816684, 2924825.535641453,
                           2907302.4548847843, 299377540.27547514, 299802]]},
          'E3': {'counters': [0, 1, 0, 0, 0, 0, 0],
                 'memo': ['executable'],
                 'mode': 'compiled'},
          'E4': {},
          'E5': {'memo': ['executable'], 'mode': 'compiled'},
          'E6': {},
          'E7': {},
          'E9a': {'counters': [0, 1, 0, 0, 0, 0, 0],
                  'memo': ['executable'],
                  'mode': 'compiled'}},
 'compiled': {'E1': {'counters': [0, 1, 0, 0, 0, 0, 0],
                     'memo': ['executable'],
                     'mode': 'compiled'},
              'E10': {'counters': None,
                      'error': ['StaticFallback',
                                'The numpy.ndarray conversion method '
                                '__array__() was called on traced array with '
                                'shape float64[25]'],
                      'mode': None,
                      'rows': None,
                      'types': None},
              'E2': {'counters': [0, 1, 0, 0, 0, 0, 0],
                     'memo': ['executable'],
                     'mode': 'compiled',
                     'rows': [['1-URGENT', 2951651.310240426,
                               76840.84342359615, 741126.2829385224,
                               1531835.614872363, 2834142.0, 467352.5180099778,
                               2927344.9208813435, 2909889.357609784,
                               299622672.5557865, 300041],
                              ['2-HIGH', 2956315.4752777936, 76870.05885390424,
                               740860.3076549858, 1531818.4849405373,
                               2836884.0, 467370.33791687415,
                               2931881.6217771713, 2914082.393398103,
                               300148968.57877326, 300574],
                              ['3-MEDIUM', 2956945.593758591,
                               77067.64985018168, 743617.3963277717,
                               1536631.1803415786, 2840283.0,
                               468833.7039850612, 2932560.683894266,
                               2915432.5595921953, 300093324.91943234,
                               300519],
                              ['4-NOT SPECIFIED', 2942306.354461462,
                               76638.50710696228, 739265.5852274011,
                               1527858.1300265684, 2825474.0,
                               466157.0634011249, 2917988.972681572,
                               2900791.5848161154, 298639269.8378289, 299064],
                              ['5-LOW', 2949164.200450654, 76755.0725832261,
                               740126.2771540403, 1529925.6209772339,
                               2831096.0, 466783.8041816684, 2924825.535641453,
                               2907302.4548847843, 299377540.27547514,
                               299802]]},
              'E3': {'counters': [0, 1, 0, 0, 0, 0, 0],
                     'memo': ['executable'],
                     'mode': 'compiled'},
              'E4': {'counters': None,
                     'error': ['StaticFallback',
                               'The numpy.ndarray conversion method '
                               '__array__() was called on traced array with '
                               'shape int64[6000000]'],
                     'mode': None,
                     'rows': None,
                     'types': None},
              'E5': {'memo': ['executable'], 'mode': 'compiled'},
              'E6': {'counters': None,
                     'error': ['StaticFallback',
                               'The numpy.ndarray conversion method '
                               '__array__() was called on traced array with '
                               'shape int32[1500000]'],
                     'mode': None,
                     'rows': None,
                     'types': None},
              'E7': {'counters': None,
                     'error': ['StaticFallback',
                               'The numpy.ndarray conversion method '
                               '__array__() was called on traced array with '
                               'shape int64[999980]'],
                     'mode': None,
                     'rows': None,
                     'types': None},
              'E9a': {'counters': [0, 1, 0, 0, 0, 0, 0],
                      'memo': ['executable'],
                      'mode': 'compiled'}},
 'dynamic': {'E1': {'counters': [2, 1, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [['A', 'F', 379.9671732923966, 4183751.8612067294,
                              4283331.655262387, 748902.6692135716,
                              672140.5197953122, 778355.697045147,
                              600892.7128818909, 135714, 15266800, 1497115],
                             ['N', 'F', 42.1273831145743, 109497.36160622032,
                              111733.97129686829, 19522.48841789805,
                              17523.240230781234, 20338.363479559368,
                              15696.235990574898, 3557, 400603, 39234],
                             ['N', 'O', 2460.8031953199397, 8289258.535533532,
                              8487187.41153142, 1484006.2633832763,
                              1331792.4173410167, 1541807.391582177,
                              1190428.3487869916, 269209, 30255985, 2966674],
                             ['R', 'F', -0.6824484649718165, 4183323.27522672,
                              4281041.785695794, 748428.6213988576,
                              671710.5251024218, 778112.7125438199,
                              600568.5401506672, 135814, 15270438, 1497578]],
                    'types': ['VARCHAR', 'VARCHAR', 'DOUBLE', 'DOUBLE',
                              'DOUBLE', 'DOUBLE', 'DOUBLE', 'DOUBLE', 'DOUBLE',
                              'BIGINT', 'BIGINT', 'BIGINT']},
             'E10': {'counters': [1, 0, 0, 0, 0, 0, 0],
                     'error': None,
                     'memo': [],
                     'mode': 'dynamic',
                     'rows': [[0, '1.6666666666666667', '1.67', '1.66',
                               '0.22184874961635637'],
                              [1, '2.0', '2.0', '2.0', '0.3010299956639812'],
                              [2, '2.3333333333333335', '2.33', '2.33',
                               '0.36797678529459443'],
                              [3, '2.6666666666666665', '2.67', '2.66',
                               '0.4259687322722811'],
                              [4, '3.0', '3.0', '3.0', '0.4771212547196625'],
                              [5, '3.3333333333333335', '3.33', '3.33',
                               '0.5228787452803376'],
                              [6, '3.6666666666666665', '3.67', '3.66',
                               '0.5642714304385626'],
                              [7, '4.0', '4.0', '4.0', '0.6020599913279624'],
                              [8, '4.333333333333333', '4.33', '4.33',
                               '0.6368220975871742'],
                              [9, '4.666666666666667', '4.67', '4.66',
                               '0.6690067809585757'],
                              [10, '5.0', '5.0', '5.0', '0.6989700043360187'],
                              [11, '5.333333333333333', '5.33', '5.33',
                               '0.7269987279362623'],
                              [12, '5.666666666666667', '5.67', '5.66',
                               '0.7533276666586115'],
                              [13, '6.0', '6.0', '6.0', '0.7781512503836436'],
                              [14, '6.333333333333333', '6.33', '6.33',
                               '0.8016323462331665'],
                              [15, '6.666666666666667', '6.67', '6.66',
                               '0.8239087409443188'],
                              [16, '7.0', '7.0', '7.0', '0.8450980400142568'],
                              [17, '7.333333333333333', '7.33', '7.33',
                               '0.8653014261025437'],
                              [18, '7.666666666666667', '7.67', '7.66',
                               '0.8846065812979305'],
                              [19, '8.0', '8.0', '8.0', '0.9030899869919435'],
                              [20, '8.333333333333334', '8.33', '8.33',
                               '0.9208187539523751'],
                              [21, '8.666666666666666', '8.67', '8.66',
                               '0.9378520932511554'],
                              [22, '9.0', '9.0', '9.0', '0.954242509439325'],
                              [23, '9.333333333333334', '9.33', '9.33',
                               '0.9700367766225567'],
                              [24, '9.666666666666666', '9.67', '9.66',
                               '0.9852767431792936']],
                     'types': ['BIGINT', 'VARCHAR', 'VARCHAR', 'VARCHAR',
                               'VARCHAR']},
             'E2': {'counters': [2, 1, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [['1-URGENT', 2951651.310240426, 76840.84342359615,
                              741126.2829385224, 1531835.614872363, 2834142.0,
                              467352.5180099778, 2927344.9208813435,
                              2909889.357609784, 299622672.5557865, 300041],
                             ['2-HIGH', 2956315.4752777936, 76870.05885390424,
                              740860.3076549858, 1531818.4849405373, 2836884.0,
                              467370.33791687415, 2931881.6217771713,
                              2914082.393398103, 300148968.57877326, 300574],
                             ['3-MEDIUM', 2956945.593758591, 77067.64985018168,
                              743617.3963277716, 1536631.1803415783, 2840283.0,
                              468833.7039850612, 2932560.683894266,
                              2915432.5595921953, 300093324.91943234, 300519],
                             ['4-NOT SPECIFIED', 2942306.354461462,
                              76638.50710696228, 739265.5852274011,
                              1527858.1300265684, 2825474.0, 466157.0634011249,
                              2917988.972681572, 2900791.5848161154,
                              298639269.8378289, 299064],
                             ['5-LOW', 2949164.200450654, 76755.0725832261,
                              740126.2771540403, 1529925.6209772339, 2831096.0,
                              466783.8041816684, 2924825.535641453,
                              2907302.4548847843, 299377540.27547514,
                              299802]],
                    'types': ['VARCHAR', 'DOUBLE', 'DOUBLE', 'DOUBLE',
                              'DOUBLE', 'DOUBLE', 'DOUBLE', 'DOUBLE', 'DOUBLE',
                              'DOUBLE', 'BIGINT']},
             'E3': {'counters': [2, 1, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [['Manufacturer#1', 39769, 71406, 331901,
                              0.38461538461538464, 31985, 'J511', 'S545',
                              'eCoNoMY aNoDiZeD TiN', 426340, 20, 'wrap pkg',
                              'economy anodized brass'],
                             ['Manufacturer#2', 39772, 31875, 332276,
                              0.38461538461538464, 71559, 'J511', 'S545',
                              'eCoNoMY aNoDiZeD TiN', 425192, 20, 'wrap pkg',
                              'economy anodized brass'],
                             ['Manufacturer#3', 40335, 72687, 336838,
                              0.38461538461538464, 72673, 'J511', 'S545',
                              'eCoNoMY aNoDiZeD TiN', 431906, 20, 'wrap pkg',
                              'economy anodized brass'],
                             ['Manufacturer#4', 40227, 72438, 335942,
                              0.38461538461538464, 72320, 'J511', 'S545',
                              'eCoNoMY aNoDiZeD TiN', 431138, 20, 'wrap pkg',
                              'economy anodized brass'],
                             ['Manufacturer#5', 39897, 71835, 333230,
                              0.38461538461538464, 71718, 'J511', 'S545',
                              'eCoNoMY aNoDiZeD TiN', 426479, 20, 'wrap pkg',
                              'economy anodized brass']],
                    'types': ['VARCHAR', 'BIGINT', 'BIGINT', 'BIGINT',
                              'DOUBLE', 'BIGINT', 'VARCHAR', 'VARCHAR',
                              'VARCHAR', 'BIGINT', 'BIGINT', 'VARCHAR',
                              'VARCHAR']},
             'E4': {'counters': [5, 1, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [['AUTOMOBILE', 301724, 646895406110402,
                              'FFFAA25B1480159EC2B24696EF71E8F1',
                              'BIjN7LsdMHbmVBKE5V+yl9rDVzJo1aMW8R0tH0U60T4=',
                              9223172133212540253,
                              '0006068E3403339A40E9A67344FF5A90AB4E33F3',
                              'B1FFA305B6DA26946F1256E1603CD20D5CCDC9147AFA80B3CB6E8775FFFB85B5',
                              'Customer#000149987', 3619622, 9999.75,
                              83094126003.56001],
                             ['BUILDING', 300016, 644565267900880,
                              'FFFFB34DFB507BC740BE98D3E3F90E3F',
                              'wjb2VHMT1f/a+4RPteIc/NC0bQiG51FfWTH2LsjxtEU=',
                              9222053054558924978,
                              '0000F57131B16388CEFC6D9C713C9BF54FCE2DA4',
                              '549B12F6306899D3C3C1E24CCB021F10B48C7BF55CB9E74FE75DFA2F89FF8F6F',
                              'Customer#000149996', 3601180, 9999.49,
                              82671016495.98],
                             ['FURNITURE', 298524, 638598758723536,
                              'FFFF1ACC97219330F3C19C38DF4C55AF',
                              'xcsa9s1Vyq/W90/FFjpiTITqLvCwSXo3l9nYwIqK/7w=',
                              9222386845688208195,
                              '000015F98F35B0479C506547D131D61AB3F29FA4',
                              'D2A324984FCBAE957C837181015DA4FFA2A9E573342B4D19A2F3474957C76E53',
                              'Customer#000149999', 3581973, 9998.83,
                              82239945483.55003],
                             ['HOUSEHOLD', 300075, 646491323615849,
                              'FFFE4C768034F92C325CB1F1E0CF1C13',
                              'qdTFJZI2q/3CU8Nf9FgX+/4bbHOWloGjcQyV1DboeXM=',
                              9223075023142423118,
                              '0000F57131B16388CEFC6D9C713C9BF54FCE2DA4',
                              'F1D097F7BD3AAE933DDFB95C0F3407EA616089C8EB4153FA0761C31DA48BC9F7',
                              'Customer#000149990', 3579740, 9999.86,
                              82688039067.50002],
                             ['MACHINERY', 299661, 642140838685107,
                              'FFFED23C57A0C27D1B1F5B20A3CB0CDF',
                              'txa9GWrwzgYn+3aqjGc7YKQ11/4JduyTP9NJxtakdvs=',
                              9222457002685142536,
                              '00024368159F46D3ADB97990C3BEE069C0B7E2CA',
                              '51715D675687851FCC890E85A11D8A01905C2C664652CF3DA58517A3D7FDE0BB',
                              'Customer#000149993', 3582229, 9999.9,
                              82477991785.39]],
                    'types': ['VARCHAR', 'BIGINT', 'BIGINT', 'VARCHAR',
                              'VARCHAR', 'BIGINT', 'VARCHAR', 'VARCHAR',
                              'VARCHAR', 'BIGINT', 'DOUBLE', 'DOUBLE']},
             'E5': {'counters': [3, 0, 0, 0, 1, 1, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [['algeria.example.com', '/africa', 'AUTOMOBILE',
                              8080, 'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://algeria.example.com:8080/africa?seg=AUTOMOBILE&k=1#top',
                              'AFRICA/ALGERIA/AUTOMOBILE', 'AUTOMOBILE',
                              1221],
                             ['algeria.example.com', '/africa', 'BUILDING',
                              8080, 'https', 'top', 'seg=BUILDING&k=1',
                              'https://algeria.example.com:8080/africa?seg=BUILDING&k=1#top',
                              'AFRICA/ALGERIA/BUILDING', 'BUILDING', 1230],
                             ['algeria.example.com', '/africa', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://algeria.example.com:8080/africa?seg=FURNITURE&k=1#top',
                              'AFRICA/ALGERIA/FURNITURE', 'FURNITURE', 1235],
                             ['algeria.example.com', '/africa', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://algeria.example.com:8080/africa?seg=HOUSEHOLD&k=1#top',
                              'AFRICA/ALGERIA/HOUSEHOLD', 'HOUSEHOLD', 1199],
                             ['algeria.example.com', '/africa', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://algeria.example.com:8080/africa?seg=MACHINERY&k=1#top',
                              'AFRICA/ALGERIA/MACHINERY', 'MACHINERY', 1232],
                             ['argentina.example.com', '/america',
                              'AUTOMOBILE', 8080, 'https', 'top',
                              'seg=AUTOMOBILE&k=1',
                              'https://argentina.example.com:8080/america?seg=AUTOMOBILE&k=1#top',
                              'AMERICA/ARGENTINA/AUTOMOBILE', 'AUTOMOBILE',
                              1189],
                             ['argentina.example.com', '/america', 'BUILDING',
                              8080, 'https', 'top', 'seg=BUILDING&k=1',
                              'https://argentina.example.com:8080/america?seg=BUILDING&k=1#top',
                              'AMERICA/ARGENTINA/BUILDING', 'BUILDING', 1163],
                             ['argentina.example.com', '/america', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://argentina.example.com:8080/america?seg=FURNITURE&k=1#top',
                              'AMERICA/ARGENTINA/FURNITURE', 'FURNITURE',
                              1203],
                             ['argentina.example.com', '/america', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://argentina.example.com:8080/america?seg=HOUSEHOLD&k=1#top',
                              'AMERICA/ARGENTINA/HOUSEHOLD', 'HOUSEHOLD',
                              1262],
                             ['argentina.example.com', '/america', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://argentina.example.com:8080/america?seg=MACHINERY&k=1#top',
                              'AMERICA/ARGENTINA/MACHINERY', 'MACHINERY',
                              1145],
                             ['brazil.example.com', '/america', 'AUTOMOBILE',
                              8080, 'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://brazil.example.com:8080/america?seg=AUTOMOBILE&k=1#top',
                              'AMERICA/BRAZIL/AUTOMOBILE', 'AUTOMOBILE',
                              1215],
                             ['brazil.example.com', '/america', 'BUILDING',
                              8080, 'https', 'top', 'seg=BUILDING&k=1',
                              'https://brazil.example.com:8080/america?seg=BUILDING&k=1#top',
                              'AMERICA/BRAZIL/BUILDING', 'BUILDING', 1201],
                             ['brazil.example.com', '/america', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://brazil.example.com:8080/america?seg=FURNITURE&k=1#top',
                              'AMERICA/BRAZIL/FURNITURE', 'FURNITURE', 1198],
                             ['brazil.example.com', '/america', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://brazil.example.com:8080/america?seg=HOUSEHOLD&k=1#top',
                              'AMERICA/BRAZIL/HOUSEHOLD', 'HOUSEHOLD', 1251],
                             ['brazil.example.com', '/america', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://brazil.example.com:8080/america?seg=MACHINERY&k=1#top',
                              'AMERICA/BRAZIL/MACHINERY', 'MACHINERY', 1231],
                             ['canada.example.com', '/america', 'AUTOMOBILE',
                              8080, 'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://canada.example.com:8080/america?seg=AUTOMOBILE&k=1#top',
                              'AMERICA/CANADA/AUTOMOBILE', 'AUTOMOBILE',
                              1252],
                             ['canada.example.com', '/america', 'BUILDING',
                              8080, 'https', 'top', 'seg=BUILDING&k=1',
                              'https://canada.example.com:8080/america?seg=BUILDING&k=1#top',
                              'AMERICA/CANADA/BUILDING', 'BUILDING', 1241],
                             ['canada.example.com', '/america', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://canada.example.com:8080/america?seg=FURNITURE&k=1#top',
                              'AMERICA/CANADA/FURNITURE', 'FURNITURE', 1184],
                             ['canada.example.com', '/america', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://canada.example.com:8080/america?seg=HOUSEHOLD&k=1#top',
                              'AMERICA/CANADA/HOUSEHOLD', 'HOUSEHOLD', 1226],
                             ['canada.example.com', '/america', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://canada.example.com:8080/america?seg=MACHINERY&k=1#top',
                              'AMERICA/CANADA/MACHINERY', 'MACHINERY', 1194],
                             ['china.example.com', '/asia', 'AUTOMOBILE', 8080,
                              'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://china.example.com:8080/asia?seg=AUTOMOBILE&k=1#top',
                              'ASIA/CHINA/AUTOMOBILE', 'AUTOMOBILE', 1233],
                             ['china.example.com', '/asia', 'BUILDING', 8080,
                              'https', 'top', 'seg=BUILDING&k=1',
                              'https://china.example.com:8080/asia?seg=BUILDING&k=1#top',
                              'ASIA/CHINA/BUILDING', 'BUILDING', 1219],
                             ['china.example.com', '/asia', 'FURNITURE', 8080,
                              'https', 'top', 'seg=FURNITURE&k=1',
                              'https://china.example.com:8080/asia?seg=FURNITURE&k=1#top',
                              'ASIA/CHINA/FURNITURE', 'FURNITURE', 1152],
                             ['china.example.com', '/asia', 'HOUSEHOLD', 8080,
                              'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://china.example.com:8080/asia?seg=HOUSEHOLD&k=1#top',
                              'ASIA/CHINA/HOUSEHOLD', 'HOUSEHOLD', 1182],
                             ['china.example.com', '/asia', 'MACHINERY', 8080,
                              'https', 'top', 'seg=MACHINERY&k=1',
                              'https://china.example.com:8080/asia?seg=MACHINERY&k=1#top',
                              'ASIA/CHINA/MACHINERY', 'MACHINERY', 1158],
                             ['egypt.example.com', '/middle east',
                              'AUTOMOBILE', 8080, 'https', 'top',
                              'seg=AUTOMOBILE&k=1',
                              'https://egypt.example.com:8080/middle '
                              'east?seg=AUTOMOBILE&k=1#top',
                              'MIDDLE EAST/EGYPT/AUTOMOBILE', 'AUTOMOBILE',
                              1170],
                             ['egypt.example.com', '/middle east', 'BUILDING',
                              8080, 'https', 'top', 'seg=BUILDING&k=1',
                              'https://egypt.example.com:8080/middle '
                              'east?seg=BUILDING&k=1#top',
                              'MIDDLE EAST/EGYPT/BUILDING', 'BUILDING', 1185],
                             ['egypt.example.com', '/middle east', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://egypt.example.com:8080/middle '
                              'east?seg=FURNITURE&k=1#top',
                              'MIDDLE EAST/EGYPT/FURNITURE', 'FURNITURE',
                              1166],
                             ['egypt.example.com', '/middle east', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://egypt.example.com:8080/middle '
                              'east?seg=HOUSEHOLD&k=1#top',
                              'MIDDLE EAST/EGYPT/HOUSEHOLD', 'HOUSEHOLD',
                              1226],
                             ['egypt.example.com', '/middle east', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://egypt.example.com:8080/middle '
                              'east?seg=MACHINERY&k=1#top',
                              'MIDDLE EAST/EGYPT/MACHINERY', 'MACHINERY',
                              1268],
                             ['ethiopia.example.com', '/africa', 'AUTOMOBILE',
                              8080, 'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://ethiopia.example.com:8080/africa?seg=AUTOMOBILE&k=1#top',
                              'AFRICA/ETHIOPIA/AUTOMOBILE', 'AUTOMOBILE',
                              1176],
                             ['ethiopia.example.com', '/africa', 'BUILDING',
                              8080, 'https', 'top', 'seg=BUILDING&k=1',
                              'https://ethiopia.example.com:8080/africa?seg=BUILDING&k=1#top',
                              'AFRICA/ETHIOPIA/BUILDING', 'BUILDING', 1209],
                             ['ethiopia.example.com', '/africa', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://ethiopia.example.com:8080/africa?seg=FURNITURE&k=1#top',
                              'AFRICA/ETHIOPIA/FURNITURE', 'FURNITURE', 1141],
                             ['ethiopia.example.com', '/africa', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://ethiopia.example.com:8080/africa?seg=HOUSEHOLD&k=1#top',
                              'AFRICA/ETHIOPIA/HOUSEHOLD', 'HOUSEHOLD', 1192],
                             ['ethiopia.example.com', '/africa', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://ethiopia.example.com:8080/africa?seg=MACHINERY&k=1#top',
                              'AFRICA/ETHIOPIA/MACHINERY', 'MACHINERY', 1168],
                             ['france.example.com', '/europe', 'AUTOMOBILE',
                              8080, 'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://france.example.com:8080/europe?seg=AUTOMOBILE&k=1#top',
                              'EUROPE/FRANCE/AUTOMOBILE', 'AUTOMOBILE', 1174],
                             ['france.example.com', '/europe', 'BUILDING',
                              8080, 'https', 'top', 'seg=BUILDING&k=1',
                              'https://france.example.com:8080/europe?seg=BUILDING&k=1#top',
                              'EUROPE/FRANCE/BUILDING', 'BUILDING', 1206],
                             ['france.example.com', '/europe', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://france.example.com:8080/europe?seg=FURNITURE&k=1#top',
                              'EUROPE/FRANCE/FURNITURE', 'FURNITURE', 1198],
                             ['france.example.com', '/europe', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://france.example.com:8080/europe?seg=HOUSEHOLD&k=1#top',
                              'EUROPE/FRANCE/HOUSEHOLD', 'HOUSEHOLD', 1221],
                             ['france.example.com', '/europe', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://france.example.com:8080/europe?seg=MACHINERY&k=1#top',
                              'EUROPE/FRANCE/MACHINERY', 'MACHINERY', 1246],
                             ['germany.example.com', '/europe', 'AUTOMOBILE',
                              8080, 'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://germany.example.com:8080/europe?seg=AUTOMOBILE&k=1#top',
                              'EUROPE/GERMANY/AUTOMOBILE', 'AUTOMOBILE',
                              1184],
                             ['germany.example.com', '/europe', 'BUILDING',
                              8080, 'https', 'top', 'seg=BUILDING&k=1',
                              'https://germany.example.com:8080/europe?seg=BUILDING&k=1#top',
                              'EUROPE/GERMANY/BUILDING', 'BUILDING', 1220],
                             ['germany.example.com', '/europe', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://germany.example.com:8080/europe?seg=FURNITURE&k=1#top',
                              'EUROPE/GERMANY/FURNITURE', 'FURNITURE', 1211],
                             ['germany.example.com', '/europe', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://germany.example.com:8080/europe?seg=HOUSEHOLD&k=1#top',
                              'EUROPE/GERMANY/HOUSEHOLD', 'HOUSEHOLD', 1209],
                             ['germany.example.com', '/europe', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://germany.example.com:8080/europe?seg=MACHINERY&k=1#top',
                              'EUROPE/GERMANY/MACHINERY', 'MACHINERY', 1152],
                             ['india.example.com', '/asia', 'AUTOMOBILE', 8080,
                              'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://india.example.com:8080/asia?seg=AUTOMOBILE&k=1#top',
                              'ASIA/INDIA/AUTOMOBILE', 'AUTOMOBILE', 1247],
                             ['india.example.com', '/asia', 'BUILDING', 8080,
                              'https', 'top', 'seg=BUILDING&k=1',
                              'https://india.example.com:8080/asia?seg=BUILDING&k=1#top',
                              'ASIA/INDIA/BUILDING', 'BUILDING', 1131],
                             ['india.example.com', '/asia', 'FURNITURE', 8080,
                              'https', 'top', 'seg=FURNITURE&k=1',
                              'https://india.example.com:8080/asia?seg=FURNITURE&k=1#top',
                              'ASIA/INDIA/FURNITURE', 'FURNITURE', 1165],
                             ['india.example.com', '/asia', 'HOUSEHOLD', 8080,
                              'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://india.example.com:8080/asia?seg=HOUSEHOLD&k=1#top',
                              'ASIA/INDIA/HOUSEHOLD', 'HOUSEHOLD', 1185],
                             ['india.example.com', '/asia', 'MACHINERY', 8080,
                              'https', 'top', 'seg=MACHINERY&k=1',
                              'https://india.example.com:8080/asia?seg=MACHINERY&k=1#top',
                              'ASIA/INDIA/MACHINERY', 'MACHINERY', 1194],
                             ['indonesia.example.com', '/asia', 'AUTOMOBILE',
                              8080, 'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://indonesia.example.com:8080/asia?seg=AUTOMOBILE&k=1#top',
                              'ASIA/INDONESIA/AUTOMOBILE', 'AUTOMOBILE',
                              1164],
                             ['indonesia.example.com', '/asia', 'BUILDING',
                              8080, 'https', 'top', 'seg=BUILDING&k=1',
                              'https://indonesia.example.com:8080/asia?seg=BUILDING&k=1#top',
                              'ASIA/INDONESIA/BUILDING', 'BUILDING', 1185],
                             ['indonesia.example.com', '/asia', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://indonesia.example.com:8080/asia?seg=FURNITURE&k=1#top',
                              'ASIA/INDONESIA/FURNITURE', 'FURNITURE', 1203],
                             ['indonesia.example.com', '/asia', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://indonesia.example.com:8080/asia?seg=HOUSEHOLD&k=1#top',
                              'ASIA/INDONESIA/HOUSEHOLD', 'HOUSEHOLD', 1265],
                             ['indonesia.example.com', '/asia', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://indonesia.example.com:8080/asia?seg=MACHINERY&k=1#top',
                              'ASIA/INDONESIA/MACHINERY', 'MACHINERY', 1195],
                             ['iran.example.com', '/middle east', 'AUTOMOBILE',
                              8080, 'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://iran.example.com:8080/middle '
                              'east?seg=AUTOMOBILE&k=1#top',
                              'MIDDLE EAST/IRAN/AUTOMOBILE', 'AUTOMOBILE',
                              1202],
                             ['iran.example.com', '/middle east', 'BUILDING',
                              8080, 'https', 'top', 'seg=BUILDING&k=1',
                              'https://iran.example.com:8080/middle '
                              'east?seg=BUILDING&k=1#top',
                              'MIDDLE EAST/IRAN/BUILDING', 'BUILDING', 1216],
                             ['iran.example.com', '/middle east', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://iran.example.com:8080/middle '
                              'east?seg=FURNITURE&k=1#top',
                              'MIDDLE EAST/IRAN/FURNITURE', 'FURNITURE',
                              1185],
                             ['iran.example.com', '/middle east', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://iran.example.com:8080/middle '
                              'east?seg=HOUSEHOLD&k=1#top',
                              'MIDDLE EAST/IRAN/HOUSEHOLD', 'HOUSEHOLD',
                              1203],
                             ['iran.example.com', '/middle east', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://iran.example.com:8080/middle '
                              'east?seg=MACHINERY&k=1#top',
                              'MIDDLE EAST/IRAN/MACHINERY', 'MACHINERY',
                              1206],
                             ['iraq.example.com', '/middle east', 'AUTOMOBILE',
                              8080, 'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://iraq.example.com:8080/middle '
                              'east?seg=AUTOMOBILE&k=1#top',
                              'MIDDLE EAST/IRAQ/AUTOMOBILE', 'AUTOMOBILE',
                              1198],
                             ['iraq.example.com', '/middle east', 'BUILDING',
                              8080, 'https', 'top', 'seg=BUILDING&k=1',
                              'https://iraq.example.com:8080/middle '
                              'east?seg=BUILDING&k=1#top',
                              'MIDDLE EAST/IRAQ/BUILDING', 'BUILDING', 1166],
                             ['iraq.example.com', '/middle east', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://iraq.example.com:8080/middle '
                              'east?seg=FURNITURE&k=1#top',
                              'MIDDLE EAST/IRAQ/FURNITURE', 'FURNITURE',
                              1249],
                             ['iraq.example.com', '/middle east', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://iraq.example.com:8080/middle '
                              'east?seg=HOUSEHOLD&k=1#top',
                              'MIDDLE EAST/IRAQ/HOUSEHOLD', 'HOUSEHOLD',
                              1174],
                             ['iraq.example.com', '/middle east', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://iraq.example.com:8080/middle '
                              'east?seg=MACHINERY&k=1#top',
                              'MIDDLE EAST/IRAQ/MACHINERY', 'MACHINERY',
                              1225],
                             ['japan.example.com', '/asia', 'AUTOMOBILE', 8080,
                              'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://japan.example.com:8080/asia?seg=AUTOMOBILE&k=1#top',
                              'ASIA/JAPAN/AUTOMOBILE', 'AUTOMOBILE', 1160],
                             ['japan.example.com', '/asia', 'BUILDING', 8080,
                              'https', 'top', 'seg=BUILDING&k=1',
                              'https://japan.example.com:8080/asia?seg=BUILDING&k=1#top',
                              'ASIA/JAPAN/BUILDING', 'BUILDING', 1175],
                             ['japan.example.com', '/asia', 'FURNITURE', 8080,
                              'https', 'top', 'seg=FURNITURE&k=1',
                              'https://japan.example.com:8080/asia?seg=FURNITURE&k=1#top',
                              'ASIA/JAPAN/FURNITURE', 'FURNITURE', 1162],
                             ['japan.example.com', '/asia', 'HOUSEHOLD', 8080,
                              'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://japan.example.com:8080/asia?seg=HOUSEHOLD&k=1#top',
                              'ASIA/JAPAN/HOUSEHOLD', 'HOUSEHOLD', 1229],
                             ['japan.example.com', '/asia', 'MACHINERY', 8080,
                              'https', 'top', 'seg=MACHINERY&k=1',
                              'https://japan.example.com:8080/asia?seg=MACHINERY&k=1#top',
                              'ASIA/JAPAN/MACHINERY', 'MACHINERY', 1209],
                             ['jordan.example.com', '/middle east',
                              'AUTOMOBILE', 8080, 'https', 'top',
                              'seg=AUTOMOBILE&k=1',
                              'https://jordan.example.com:8080/middle '
                              'east?seg=AUTOMOBILE&k=1#top',
                              'MIDDLE EAST/JORDAN/AUTOMOBILE', 'AUTOMOBILE',
                              1213],
                             ['jordan.example.com', '/middle east', 'BUILDING',
                              8080, 'https', 'top', 'seg=BUILDING&k=1',
                              'https://jordan.example.com:8080/middle '
                              'east?seg=BUILDING&k=1#top',
                              'MIDDLE EAST/JORDAN/BUILDING', 'BUILDING',
                              1167],
                             ['jordan.example.com', '/middle east',
                              'FURNITURE', 8080, 'https', 'top',
                              'seg=FURNITURE&k=1',
                              'https://jordan.example.com:8080/middle '
                              'east?seg=FURNITURE&k=1#top',
                              'MIDDLE EAST/JORDAN/FURNITURE', 'FURNITURE',
                              1196],
                             ['jordan.example.com', '/middle east',
                              'HOUSEHOLD', 8080, 'https', 'top',
                              'seg=HOUSEHOLD&k=1',
                              'https://jordan.example.com:8080/middle '
                              'east?seg=HOUSEHOLD&k=1#top',
                              'MIDDLE EAST/JORDAN/HOUSEHOLD', 'HOUSEHOLD',
                              1187],
                             ['jordan.example.com', '/middle east',
                              'MACHINERY', 8080, 'https', 'top',
                              'seg=MACHINERY&k=1',
                              'https://jordan.example.com:8080/middle '
                              'east?seg=MACHINERY&k=1#top',
                              'MIDDLE EAST/JORDAN/MACHINERY', 'MACHINERY',
                              1146],
                             ['kenya.example.com', '/africa', 'AUTOMOBILE',
                              8080, 'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://kenya.example.com:8080/africa?seg=AUTOMOBILE&k=1#top',
                              'AFRICA/KENYA/AUTOMOBILE', 'AUTOMOBILE', 1182],
                             ['kenya.example.com', '/africa', 'BUILDING', 8080,
                              'https', 'top', 'seg=BUILDING&k=1',
                              'https://kenya.example.com:8080/africa?seg=BUILDING&k=1#top',
                              'AFRICA/KENYA/BUILDING', 'BUILDING', 1171],
                             ['kenya.example.com', '/africa', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://kenya.example.com:8080/africa?seg=FURNITURE&k=1#top',
                              'AFRICA/KENYA/FURNITURE', 'FURNITURE', 1183],
                             ['kenya.example.com', '/africa', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://kenya.example.com:8080/africa?seg=HOUSEHOLD&k=1#top',
                              'AFRICA/KENYA/HOUSEHOLD', 'HOUSEHOLD', 1203],
                             ['kenya.example.com', '/africa', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://kenya.example.com:8080/africa?seg=MACHINERY&k=1#top',
                              'AFRICA/KENYA/MACHINERY', 'MACHINERY', 1190],
                             ['morocco.example.com', '/africa', 'AUTOMOBILE',
                              8080, 'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://morocco.example.com:8080/africa?seg=AUTOMOBILE&k=1#top',
                              'AFRICA/MOROCCO/AUTOMOBILE', 'AUTOMOBILE',
                              1294],
                             ['morocco.example.com', '/africa', 'BUILDING',
                              8080, 'https', 'top', 'seg=BUILDING&k=1',
                              'https://morocco.example.com:8080/africa?seg=BUILDING&k=1#top',
                              'AFRICA/MOROCCO/BUILDING', 'BUILDING', 1213],
                             ['morocco.example.com', '/africa', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://morocco.example.com:8080/africa?seg=FURNITURE&k=1#top',
                              'AFRICA/MOROCCO/FURNITURE', 'FURNITURE', 1183],
                             ['morocco.example.com', '/africa', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://morocco.example.com:8080/africa?seg=HOUSEHOLD&k=1#top',
                              'AFRICA/MOROCCO/HOUSEHOLD', 'HOUSEHOLD', 1207],
                             ['morocco.example.com', '/africa', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://morocco.example.com:8080/africa?seg=MACHINERY&k=1#top',
                              'AFRICA/MOROCCO/MACHINERY', 'MACHINERY', 1292],
                             ['mozambique.example.com', '/africa',
                              'AUTOMOBILE', 8080, 'https', 'top',
                              'seg=AUTOMOBILE&k=1',
                              'https://mozambique.example.com:8080/africa?seg=AUTOMOBILE&k=1#top',
                              'AFRICA/MOZAMBIQUE/AUTOMOBILE', 'AUTOMOBILE',
                              1166],
                             ['mozambique.example.com', '/africa', 'BUILDING',
                              8080, 'https', 'top', 'seg=BUILDING&k=1',
                              'https://mozambique.example.com:8080/africa?seg=BUILDING&k=1#top',
                              'AFRICA/MOZAMBIQUE/BUILDING', 'BUILDING', 1183],
                             ['mozambique.example.com', '/africa', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://mozambique.example.com:8080/africa?seg=FURNITURE&k=1#top',
                              'AFRICA/MOZAMBIQUE/FURNITURE', 'FURNITURE',
                              1182],
                             ['mozambique.example.com', '/africa', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://mozambique.example.com:8080/africa?seg=HOUSEHOLD&k=1#top',
                              'AFRICA/MOZAMBIQUE/HOUSEHOLD', 'HOUSEHOLD',
                              1152],
                             ['mozambique.example.com', '/africa', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://mozambique.example.com:8080/africa?seg=MACHINERY&k=1#top',
                              'AFRICA/MOZAMBIQUE/MACHINERY', 'MACHINERY',
                              1209],
                             ['peru.example.com', '/america', 'AUTOMOBILE',
                              8080, 'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://peru.example.com:8080/america?seg=AUTOMOBILE&k=1#top',
                              'AMERICA/PERU/AUTOMOBILE', 'AUTOMOBILE', 1218],
                             ['peru.example.com', '/america', 'BUILDING', 8080,
                              'https', 'top', 'seg=BUILDING&k=1',
                              'https://peru.example.com:8080/america?seg=BUILDING&k=1#top',
                              'AMERICA/PERU/BUILDING', 'BUILDING', 1198],
                             ['peru.example.com', '/america', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://peru.example.com:8080/america?seg=FURNITURE&k=1#top',
                              'AMERICA/PERU/FURNITURE', 'FURNITURE', 1246],
                             ['peru.example.com', '/america', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://peru.example.com:8080/america?seg=HOUSEHOLD&k=1#top',
                              'AMERICA/PERU/HOUSEHOLD', 'HOUSEHOLD', 1197],
                             ['peru.example.com', '/america', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://peru.example.com:8080/america?seg=MACHINERY&k=1#top',
                              'AMERICA/PERU/MACHINERY', 'MACHINERY', 1149],
                             ['romania.example.com', '/europe', 'AUTOMOBILE',
                              8080, 'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://romania.example.com:8080/europe?seg=AUTOMOBILE&k=1#top',
                              'EUROPE/ROMANIA/AUTOMOBILE', 'AUTOMOBILE',
                              1211],
                             ['romania.example.com', '/europe', 'BUILDING',
                              8080, 'https', 'top', 'seg=BUILDING&k=1',
                              'https://romania.example.com:8080/europe?seg=BUILDING&k=1#top',
                              'EUROPE/ROMANIA/BUILDING', 'BUILDING', 1173],
                             ['romania.example.com', '/europe', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://romania.example.com:8080/europe?seg=FURNITURE&k=1#top',
                              'EUROPE/ROMANIA/FURNITURE', 'FURNITURE', 1215],
                             ['romania.example.com', '/europe', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://romania.example.com:8080/europe?seg=HOUSEHOLD&k=1#top',
                              'EUROPE/ROMANIA/HOUSEHOLD', 'HOUSEHOLD', 1223],
                             ['romania.example.com', '/europe', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://romania.example.com:8080/europe?seg=MACHINERY&k=1#top',
                              'EUROPE/ROMANIA/MACHINERY', 'MACHINERY', 1185],
                             ['russia.example.com', '/europe', 'AUTOMOBILE',
                              8080, 'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://russia.example.com:8080/europe?seg=AUTOMOBILE&k=1#top',
                              'EUROPE/RUSSIA/AUTOMOBILE', 'AUTOMOBILE', 1197],
                             ['russia.example.com', '/europe', 'BUILDING',
                              8080, 'https', 'top', 'seg=BUILDING&k=1',
                              'https://russia.example.com:8080/europe?seg=BUILDING&k=1#top',
                              'EUROPE/RUSSIA/BUILDING', 'BUILDING', 1242],
                             ['russia.example.com', '/europe', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://russia.example.com:8080/europe?seg=FURNITURE&k=1#top',
                              'EUROPE/RUSSIA/FURNITURE', 'FURNITURE', 1144],
                             ['russia.example.com', '/europe', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://russia.example.com:8080/europe?seg=HOUSEHOLD&k=1#top',
                              'EUROPE/RUSSIA/HOUSEHOLD', 'HOUSEHOLD', 1189],
                             ['russia.example.com', '/europe', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://russia.example.com:8080/europe?seg=MACHINERY&k=1#top',
                              'EUROPE/RUSSIA/MACHINERY', 'MACHINERY', 1221],
                             ['saudi-arabia.example.com', '/middle east',
                              'AUTOMOBILE', 8080, 'https', 'top',
                              'seg=AUTOMOBILE&k=1',
                              'https://saudi-arabia.example.com:8080/middle '
                              'east?seg=AUTOMOBILE&k=1#top',
                              'MIDDLE EAST/SAUDI ARABIA/AUTOMOBILE',
                              'AUTOMOBILE', 1228],
                             ['saudi-arabia.example.com', '/middle east',
                              'BUILDING', 8080, 'https', 'top',
                              'seg=BUILDING&k=1',
                              'https://saudi-arabia.example.com:8080/middle '
                              'east?seg=BUILDING&k=1#top',
                              'MIDDLE EAST/SAUDI ARABIA/BUILDING', 'BUILDING',
                              1187],
                             ['saudi-arabia.example.com', '/middle east',
                              'FURNITURE', 8080, 'https', 'top',
                              'seg=FURNITURE&k=1',
                              'https://saudi-arabia.example.com:8080/middle '
                              'east?seg=FURNITURE&k=1#top',
                              'MIDDLE EAST/SAUDI ARABIA/FURNITURE',
                              'FURNITURE', 1207],
                             ['saudi-arabia.example.com', '/middle east',
                              'HOUSEHOLD', 8080, 'https', 'top',
                              'seg=HOUSEHOLD&k=1',
                              'https://saudi-arabia.example.com:8080/middle '
                              'east?seg=HOUSEHOLD&k=1#top',
                              'MIDDLE EAST/SAUDI ARABIA/HOUSEHOLD',
                              'HOUSEHOLD', 1209],
                             ['saudi-arabia.example.com', '/middle east',
                              'MACHINERY', 8080, 'https', 'top',
                              'seg=MACHINERY&k=1',
                              'https://saudi-arabia.example.com:8080/middle '
                              'east?seg=MACHINERY&k=1#top',
                              'MIDDLE EAST/SAUDI ARABIA/MACHINERY',
                              'MACHINERY', 1158],
                             ['united-kingdom.example.com', '/europe',
                              'AUTOMOBILE', 8080, 'https', 'top',
                              'seg=AUTOMOBILE&k=1',
                              'https://united-kingdom.example.com:8080/europe?seg=AUTOMOBILE&k=1#top',
                              'EUROPE/UNITED KINGDOM/AUTOMOBILE', 'AUTOMOBILE',
                              1206],
                             ['united-kingdom.example.com', '/europe',
                              'BUILDING', 8080, 'https', 'top',
                              'seg=BUILDING&k=1',
                              'https://united-kingdom.example.com:8080/europe?seg=BUILDING&k=1#top',
                              'EUROPE/UNITED KINGDOM/BUILDING', 'BUILDING',
                              1266],
                             ['united-kingdom.example.com', '/europe',
                              'FURNITURE', 8080, 'https', 'top',
                              'seg=FURNITURE&k=1',
                              'https://united-kingdom.example.com:8080/europe?seg=FURNITURE&k=1#top',
                              'EUROPE/UNITED KINGDOM/FURNITURE', 'FURNITURE',
                              1165],
                             ['united-kingdom.example.com', '/europe',
                              'HOUSEHOLD', 8080, 'https', 'top',
                              'seg=HOUSEHOLD&k=1',
                              'https://united-kingdom.example.com:8080/europe?seg=HOUSEHOLD&k=1#top',
                              'EUROPE/UNITED KINGDOM/HOUSEHOLD', 'HOUSEHOLD',
                              1200],
                             ['united-kingdom.example.com', '/europe',
                              'MACHINERY', 8080, 'https', 'top',
                              'seg=MACHINERY&k=1',
                              'https://united-kingdom.example.com:8080/europe?seg=MACHINERY&k=1#top',
                              'EUROPE/UNITED KINGDOM/MACHINERY', 'MACHINERY',
                              1223],
                             ['united-states.example.com', '/america',
                              'AUTOMOBILE', 8080, 'https', 'top',
                              'seg=AUTOMOBILE&k=1',
                              'https://united-states.example.com:8080/america?seg=AUTOMOBILE&k=1#top',
                              'AMERICA/UNITED STATES/AUTOMOBILE', 'AUTOMOBILE',
                              1232],
                             ['united-states.example.com', '/america',
                              'BUILDING', 8080, 'https', 'top',
                              'seg=BUILDING&k=1',
                              'https://united-states.example.com:8080/america?seg=BUILDING&k=1#top',
                              'AMERICA/UNITED STATES/BUILDING', 'BUILDING',
                              1175],
                             ['united-states.example.com', '/america',
                              'FURNITURE', 8080, 'https', 'top',
                              'seg=FURNITURE&k=1',
                              'https://united-states.example.com:8080/america?seg=FURNITURE&k=1#top',
                              'AMERICA/UNITED STATES/FURNITURE', 'FURNITURE',
                              1200],
                             ['united-states.example.com', '/america',
                              'HOUSEHOLD', 8080, 'https', 'top',
                              'seg=HOUSEHOLD&k=1',
                              'https://united-states.example.com:8080/america?seg=HOUSEHOLD&k=1#top',
                              'AMERICA/UNITED STATES/HOUSEHOLD', 'HOUSEHOLD',
                              1216],
                             ['united-states.example.com', '/america',
                              'MACHINERY', 8080, 'https', 'top',
                              'seg=MACHINERY&k=1',
                              'https://united-states.example.com:8080/america?seg=MACHINERY&k=1#top',
                              'AMERICA/UNITED STATES/MACHINERY', 'MACHINERY',
                              1217],
                             ['vietnam.example.com', '/asia', 'AUTOMOBILE',
                              8080, 'https', 'top', 'seg=AUTOMOBILE&k=1',
                              'https://vietnam.example.com:8080/asia?seg=AUTOMOBILE&k=1#top',
                              'ASIA/VIETNAM/AUTOMOBILE', 'AUTOMOBILE', 1201],
                             ['vietnam.example.com', '/asia', 'BUILDING', 8080,
                              'https', 'top', 'seg=BUILDING&k=1',
                              'https://vietnam.example.com:8080/asia?seg=BUILDING&k=1#top',
                              'ASIA/VIETNAM/BUILDING', 'BUILDING', 1183],
                             ['vietnam.example.com', '/asia', 'FURNITURE',
                              8080, 'https', 'top', 'seg=FURNITURE&k=1',
                              'https://vietnam.example.com:8080/asia?seg=FURNITURE&k=1#top',
                              'ASIA/VIETNAM/FURNITURE', 'FURNITURE', 1238],
                             ['vietnam.example.com', '/asia', 'HOUSEHOLD',
                              8080, 'https', 'top', 'seg=HOUSEHOLD&k=1',
                              'https://vietnam.example.com:8080/asia?seg=HOUSEHOLD&k=1#top',
                              'ASIA/VIETNAM/HOUSEHOLD', 'HOUSEHOLD', 1120],
                             ['vietnam.example.com', '/asia', 'MACHINERY',
                              8080, 'https', 'top', 'seg=MACHINERY&k=1',
                              'https://vietnam.example.com:8080/asia?seg=MACHINERY&k=1#top',
                              'ASIA/VIETNAM/MACHINERY', 'MACHINERY', 1211]],
                    'types': ['VARCHAR', 'VARCHAR', 'VARCHAR', 'BIGINT',
                              'VARCHAR', 'VARCHAR', 'VARCHAR', 'VARCHAR',
                              'VARCHAR', 'VARCHAR', 'BIGINT']},
             'E6': {'counters': [2, 1, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [['1992-01', 5460491480.720002, 19725, 5, 30, 1,
                              1992, 19725, 19725, 1500],
                             ['1992-02', 5045306787.360002, 18355, 5, 30, 1,
                              1992, 18355, 18355, 1500],
                             ['1992-03', 5390294699.989996, 19541, 5, 30, 1,
                              1992, 19541, 19541, 1500],
                             ['1992-04', 5264829491.320003, 19195, 5, 30, 1,
                              1992, 19195, 19195, 1500],
                             ['1992-05', 5329032122.28, 19339, 5, 30, 1, 1992,
                              19339, 19339, 1500],
                             ['1992-06', 5203160521.119998, 18915, 5, 30, 1,
                              1992, 18915, 18915, 1500],
                             ['1992-07', 5379798472.799998, 19482, 5, 30, 1,
                              1992, 19482, 19482, 1500],
                             ['1992-08', 5391192642.389998, 19518, 5, 30, 1,
                              1992, 19518, 19518, 1500],
                             ['1992-09', 5165991011.290002, 18862, 5, 30, 1,
                              1992, 18862, 18862, 1500],
                             ['1992-10', 5416421133.980001, 19484, 5, 30, 1,
                              1992, 19484, 19484, 1500],
                             ['1992-11', 5185548335.830002, 18897, 5, 30, 1,
                              1992, 18897, 18897, 1500],
                             ['1992-12', 5363107296.199999, 19447, 5, 30, 1,
                              1992, 19447, 19447, 1500],
                             ['1993-01', 5415209780.509997, 19722, 5, 30, 1,
                              1993, 19722, 19722, 1500],
                             ['1993-02', 4782450572.1799965, 17458, 5, 30, 1,
                              1993, 17458, 17458, 1500],
                             ['1993-03', 5376579197.709995, 19477, 5, 30, 1,
                              1993, 19477, 19477, 1500],
                             ['1993-04', 5266829066.95, 19057, 5, 30, 1, 1993,
                              19057, 19057, 1500],
                             ['1993-05', 5372042329.860001, 19536, 5, 30, 1,
                              1993, 19536, 19536, 1500],
                             ['1993-06', 5193413802.739999, 18990, 5, 30, 1,
                              1993, 18990, 18990, 1500],
                             ['1993-07', 5410520514.35, 19615, 5, 30, 1, 1993,
                              19615, 19615, 1500],
                             ['1993-08', 5349441911.429995, 19498, 5, 30, 1,
                              1993, 19498, 19498, 1500],
                             ['1993-09', 5143600585.929999, 18750, 5, 30, 1,
                              1993, 18750, 18750, 1500],
                             ['1993-10', 5459424067.920003, 19883, 5, 30, 1,
                              1993, 19883, 19883, 1500],
                             ['1993-11', 5168959876.199997, 18835, 5, 30, 1,
                              1993, 18835, 18835, 1500],
                             ['1993-12', 5317362575.09, 19555, 5, 30, 1, 1993,
                              19555, 19555, 1500],
                             ['1994-01', 5389423459.02, 19564, 5, 30, 1, 1994,
                              19564, 19564, 1500],
                             ['1994-02', 4744102977.2699995, 17311, 5, 30, 1,
                              1994, 17311, 17311, 1500],
                             ['1994-03', 5409326967.920003, 19592, 5, 30, 1,
                              1994, 19592, 19592, 1500],
                             ['1994-04', 5204968624.780002, 18836, 5, 30, 1,
                              1994, 18836, 18836, 1500],
                             ['1994-05', 5365312813.289999, 19450, 5, 30, 1,
                              1994, 19450, 19450, 1500],
                             ['1994-06', 5234032539.759999, 18999, 5, 30, 1,
                              1994, 18999, 18999, 1500],
                             ['1994-07', 5422780053.179998, 19717, 5, 30, 1,
                              1994, 19717, 19717, 1500],
                             ['1994-08', 5324720107.270001, 19374, 5, 30, 1,
                              1994, 19374, 19374, 1500],
                             ['1994-09', 5245157508.069998, 18930, 5, 30, 1,
                              1994, 18930, 18930, 1500],
                             ['1994-10', 5341483346.5199995, 19326, 5, 30, 1,
                              1994, 19326, 19326, 1500],
                             ['1994-11', 5146233952.909998, 18712, 5, 30, 1,
                              1994, 18712, 18712, 1500],
                             ['1994-12', 5355479935.280001, 19388, 5, 30, 1,
                              1994, 19388, 19388, 1500],
                             ['1995-01', 5387984121.150002, 19528, 5, 30, 1,
                              1995, 0, 19528, 1500],
                             ['1995-02', 4955521235.82, 17919, 5, 30, 1, 1995,
                              0, 17919, 1500],
                             ['1995-03', 5381074916.449993, 19630, 5, 30, 1,
                              1995, 0, 19630, 1500],
                             ['1995-04', 5210230492.95, 18805, 5, 30, 1, 1995,
                              0, 18805, 1500],
                             ['1995-05', 5427662969.920004, 19597, 5, 30, 1,
                              1995, 0, 19597, 1500],
                             ['1995-06', 5234152690.149997, 18966, 5, 30, 1,
                              1995, 0, 10121, 1500],
                             ['1995-07', 5433083384.330001, 19761, 5, 30, 1,
                              1995, 0, 0, 1500],
                             ['1995-08', 5385534505.569999, 19559, 5, 30, 1,
                              1995, 0, 0, 1500],
                             ['1995-09', 5281357038.480002, 19036, 5, 30, 1,
                              1995, 0, 0, 1500],
                             ['1995-10', 5374285385.590001, 19422, 5, 30, 1,
                              1995, 0, 0, 1500],
                             ['1995-11', 5253438822.229997, 18992, 5, 30, 1,
                              1995, 0, 0, 1500],
                             ['1995-12', 5429685310.74, 19769, 5, 30, 1, 1995,
                              0, 0, 1500],
                             ['1996-01', 5392025204.830001, 19539, 5, 30, 1,
                              1996, 0, 0, 1500],
                             ['1996-02', 4984986362.670003, 18214, 5, 30, 1,
                              1996, 0, 0, 1500],
                             ['1996-03', 5375375321.28, 19516, 5, 30, 1, 1996,
                              0, 0, 1500],
                             ['1996-04', 5235104131.720001, 18924, 5, 30, 1,
                              1996, 0, 0, 1500],
                             ['1996-05', 5430981103.009998, 19671, 5, 30, 1,
                              1996, 0, 0, 1500],
                             ['1996-06', 5140664226.459996, 18771, 5, 30, 1,
                              1996, 0, 0, 1500],
                             ['1996-07', 5375064738.230001, 19552, 5, 30, 1,
                              1996, 0, 0, 1500],
                             ['1996-08', 5447774557.280002, 19796, 5, 30, 1,
                              1996, 0, 0, 1500],
                             ['1996-09', 5235513149.500002, 18987, 5, 30, 1,
                              1996, 0, 0, 1500],
                             ['1996-10', 5388885244.430001, 19692, 5, 30, 1,
                              1996, 0, 0, 1500],
                             ['1996-11', 5252611816.149996, 19075, 5, 30, 1,
                              1996, 0, 0, 1500],
                             ['1996-12', 5468475731.519997, 19792, 5, 30, 1,
                              1997, 0, 0, 1500],
                             ['1997-01', 5397569120.169998, 19626, 5, 30, 1,
                              1997, 0, 0, 1500],
                             ['1997-02', 4839772527.839999, 17625, 5, 30, 1,
                              1997, 0, 0, 1500],
                             ['1997-03', 5427643830.000001, 19623, 5, 30, 1,
                              1997, 0, 0, 1500],
                             ['1997-04', 5324734291.779999, 19149, 5, 30, 1,
                              1997, 0, 0, 1500],
                             ['1997-05', 5363348904.290002, 19468, 5, 30, 1,
                              1997, 0, 0, 1500],
                             ['1997-06', 5250785991.729999, 19070, 5, 30, 1,
                              1997, 0, 0, 1500],
                             ['1997-07', 5394605935.4, 19587, 5, 30, 1, 1997,
                              0, 0, 1500],
                             ['1997-08', 5379649766.3, 19461, 5, 30, 1, 1997,
                              0, 0, 1500],
                             ['1997-09', 5288085726.160002, 19120, 5, 30, 1,
                              1997, 0, 0, 1500],
                             ['1997-10', 5438797362.660001, 19637, 5, 30, 1,
                              1997, 0, 0, 1500],
                             ['1997-11', 5228662382.790001, 19003, 5, 30, 1,
                              1997, 0, 0, 1500],
                             ['1997-12', 5340630668.349999, 19512, 5, 30, 1,
                              1998, 0, 0, 1500],
                             ['1998-01', 5419523460.500002, 19704, 5, 30, 1,
                              1998, 0, 0, 1500],
                             ['1998-02', 4848167498.0, 17689, 5, 30, 1, 1998,
                              0, 0, 1500],
                             ['1998-03', 5322319865.759999, 19393, 5, 30, 1,
                              1998, 0, 0, 1500],
                             ['1998-04', 5220842895.579994, 18853, 5, 30, 1,
                              1998, 0, 0, 1500],
                             ['1998-05', 5390611859.13, 19623, 5, 30, 1, 1998,
                              0, 0, 1500],
                             ['1998-06', 5251345972.15, 19110, 5, 30, 1, 1998,
                              0, 0, 1500],
                             ['1998-07', 528517755.50999975, 1899, 5, 30, 1,
                              1998, 0, 0, 1500]],
                    'types': ['VARCHAR', 'DOUBLE', 'BIGINT', 'BIGINT',
                              'BIGINT', 'BIGINT', 'BIGINT', 'BIGINT', 'BIGINT',
                              'BIGINT']},
             'E7': {'counters': [2, 1, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [['Manufacturer#1', 39769, 47, 228703.59999999998,
                              4, 'yellow,yellow,white,cornflower,burlywood',
                              4206, 5, 2129, 35563, 3],
                             ['Manufacturer#2', 39772, 48, 228415.80000000005,
                              4, 'yellow,yellow,yellow,chartreuse,brown', 4178,
                              5, 2196, 35594, 3],
                             ['Manufacturer#3', 40335, 47, 231913.6, 4,
                              'yellow,yellow,yellow,khaki,black', 4241, 5,
                              2081, 36094, 3],
                             ['Manufacturer#4', 40227, 47, 231489.59999999995,
                              4, 'yellow,yellow,white,light,beige', 4148, 5,
                              2107, 36079, 3],
                             ['Manufacturer#5', 39897, 46, 229182.0, 4,
                              'yellow,yellow,yellow,violet,firebrick', 4225, 5,
                              2202, 35672, 3]],
                    'types': ['VARCHAR', 'BIGINT', 'BIGINT', 'DOUBLE',
                              'BIGINT', 'VARCHAR', 'BIGINT', 'BIGINT',
                              'BIGINT', 'BIGINT', 'BIGINT']},
             'E9a': {'counters': [2, 1, 0, 0, 0, 0, 0],
                     'error': None,
                     'memo': [],
                     'mode': 'dynamic',
                     'rows': [['A', 1282716, 0, 117198, 29082379.0],
                              ['N', 2576584, 2542871, 234458, 58354418.0],
                              ['R', 1283416, 0, 116696, 29079307.0]],
                     'types': ['VARCHAR', 'BIGINT', 'BIGINT', 'BIGINT',
                               'DOUBLE']}}}

#: E9b's rows from Python's decimal over the generated SF1 columns
#: (`python -m tests.torch_functions_ext_common decimal 1`)
FX_DECIMAL_SF1 = [['A', 'F', 1497115, '57243390316', '57244817677', '57244137490', '5574018.58',
  '626', '40790.83', '10489.95'],
 ['N', 'F', 39234, '1496512333', '1496549686', '1496532160', '145881.17',
  '-226', '1071.16', '9979.60'],
 ['N', 'O', 2966674, '113410972403', '113413799940', '113412444860',
  '11047793.92', '1005', '80895.03', '10479.95'],
 ['R', 'F', 1497578, '57231526573', '57232954049', '57232272410', '5579051.99',
  '-1084', '40828.33', '10424.90']]

#: E1's sums of sin(l_extendedprice) over the generated SF1 columns,
#: exact sums of numpy's sines (`python -m
#: tests.torch_functions_ext_common sin 1`), in place of presto_tpu's:
#: its SF1 scan gives 768,510 of the 6,000,601 prices one ulp off (up
#: to 2.9e-11), which moves the R/F group's sum, cancelling to -0.68,
#: by 3.7e-9 (ROADMAP C)
FX_E1_SIN_SF1 = [["A", "F", 379.9671732848458],
                 ["N", "F", 42.127383114841656],
                 ["N", "O", 2460.803195312635],
                 ["R", "F", -0.6824484686475433]]

#: presto_tpu's records of the time-zone and sketch corpus at SF1, each
#: fact once (zone_sketch_queries.compact_reference), from `JAX_PLATFORMS=cpu
#: python -m tests.torch_zone_sketch_common 1 <ID> <cache dir>`, one query
#: a process ("Z5" for the script), with this machine's
#: /usr/share/zoneinfo (the `zones` line gives each file's SHA-256)
ZS_REFERENCE_SF1 = {'auto': {'K1a': {},
          'K1b': {},
          'K2': {},
          'K3': {},
          'K4': {},
          'K5': {},
          'K6': {},
          'K6b': {},
          'Z1': {},
          'Z2': {},
          'Z3': {},
          'Z4': {},
          'Z4b': {'counters': [3, 0, 0, 0, 0, 0, 0],
                  'memo': ['executable'],
                  'mode': 'compiled',
                  'rows': [[18, 1500000, 413171118835.99976]]},
          'Z5a': {},
          'Z5b': {'memo': ['executable'], 'mode': 'compiled'},
          'Z5c': {'memo': ['executable'], 'mode': 'compiled'},
          'Z5d': {}},
 'compiled': {'K1a': {'counters': None,
                      'error': ['StaticFallback',
                                'approx_set is dynamic-mode only'],
                      'mode': None,
                      'rows': None,
                      'types': None},
              'K1b': {'counters': None,
                      'error': ['StaticFallback',
                                'approx_set is dynamic-mode only'],
                      'mode': None,
                      'rows': None,
                      'types': None},
              'K2': {'counters': None,
                     'error': ['StaticFallback',
                               'tdigest_agg is dynamic-mode only'],
                     'mode': None,
                     'rows': None,
                     'types': None},
              'K3': {'counters': None,
                     'error': ['StaticFallback',
                               'qdigest_agg is dynamic-mode only'],
                     'mode': None,
                     'rows': None,
                     'types': None},
              'K4': {'counters': None,
                     'error': ['StaticFallback',
                               'array/weighted approx_percentile is '
                               'dynamic-mode only'],
                     'mode': None,
                     'rows': None,
                     'types': None},
              'K5': {'counters': None,
                     'error': ['StaticFallback',
                               'min_by is dynamic-mode only'],
                     'mode': None,
                     'rows': None,
                     'types': None},
              'K6': {'counters': None,
                     'error': ['StaticFallback',
                               'reduce_agg is dynamic-mode only'],
                     'mode': None,
                     'rows': None,
                     'types': None},
              'K6b': {'counters': None,
                      'error': ['StaticFallback',
                                'map_agg is dynamic-mode only'],
                      'mode': None,
                      'rows': None,
                      'types': None},
              'Z1': {'counters': None,
                     'error': ['StaticFallback',
                               'The numpy.ndarray conversion method '
                               '__array__() was called on traced array with '
                               'shape int32[1500000]'],
                     'mode': None,
                     'rows': None,
                     'types': None},
              'Z2': {'counters': None,
                     'error': ['StaticFallback',
                               'The numpy.ndarray conversion method '
                               '__array__() was called on traced array with '
                               'shape int32[6000601]'],
                     'mode': None,
                     'rows': None,
                     'types': None},
              'Z3': {'counters': None,
                     'error': ['StaticFallback',
                               'The numpy.ndarray conversion method '
                               '__array__() was called on traced array with '
                               'shape int32[6000601]'],
                     'mode': None,
                     'rows': None,
                     'types': None},
              'Z4': {'counters': None,
                     'error': ['StaticFallback',
                               'Abstract tracer value encountered where '
                               'concrete value is expected: traced array '
                               'with shape int64[]'],
                     'mode': None,
                     'rows': None,
                     'types': None},
              'Z4b': {'counters': [3, 0, 0, 0, 0, 0, 0],
                      'memo': ['executable'],
                      'mode': 'compiled',
                      'rows': [[18, 1500000, 413171118835.99976]]},
              'Z5a': {},
              'Z5b': {'memo': ['executable'], 'mode': 'compiled'},
              'Z5c': {'memo': ['executable'], 'mode': 'compiled'},
              'Z5d': {'counters': None,
                      'error': ['StaticFallback',
                                'The numpy.ndarray conversion method '
                                '__array__() was called on traced array with '
                                'shape int32[1500000]'],
                      'mode': None,
                      'rows': None,
                      'types': None}},
 'dynamic': {'K1a': {'counters': [2, 1, 0, 0, 0, 0, 0],
                     'error': None,
                     'memo': [],
                     'mode': 'dynamic',
                     'rows': [['1-URGENT', 90333,
                               'sha256:96daac3a091ab3bd43e5dd440292b9c43237e2fa2fb9b35d0b2fa0ffcb44106c'],
                              ['2-HIGH', 90469,
                               'sha256:7e23263cd7a2791f70971215c8676b1a0bf02daff7bfcd325c50449425da6acf'],
                              ['3-MEDIUM', 92923,
                               'sha256:e3859db9a741c54b43ac1029ca5b597ba8447262096dd4a29a1481fe2babec20'],
                              ['4-NOT SPECIFIED', 92530,
                               'sha256:7872a92e7fac6528bef558a30ea0593f8bc8e97a655de2d0fddfc2d56063df39'],
                              ['5-LOW', 90985,
                               'sha256:2071d5725a9e301476bb51828c72d636f29c0e0adde30f8ae212cb989010d908']],
                     'types': ['VARCHAR', 'BIGINT', 'VARCHAR']},
             'K1b': {'counters': [2, 0, 0, 0, 0, 0, 0],
                     'error': None,
                     'memo': [],
                     'mode': 'dynamic',
                     'rows': [[99920, 0]],
                     'types': ['BIGINT', 'BIGINT']},
             'K2': {'counters': [2, 1, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [['A', 25.504470810429773,
                              [5.531780123234409, 45.480154964373035],
                              0.49078714011746744, 12.959683344102288,
                              [[1626.9691976423092, 3526.295288013344,
                                5697.405266160179, 7892.524971078437,
                                10094.536269366607, 12298.031053880673,
                                14475.663743064995, 16654.61228327163,
                                18803.483045096753, 20948.525190299537,
                                23071.177707800336, 25169.476338627836,
                                27240.995895633845, 29295.338683560985,
                                31312.259092504697, 33304.59961471573,
                                35263.48190756356, 37181.94418081002,
                                39068.23591624541, 40919.280266809554,
                                42716.51377955137, 44474.215599051066,
                                46206.67100852559, 47898.50345191304,
                                49569.544552239706, 51230.174344645544,
                                52899.77123580905, 54595.50398648017,
                                56325.489612656755, 58093.03908549311,
                                59932.676407641164, 61806.30041982964,
                                63706.60221168523, 65647.3180673203,
                                67621.09828452194, 69624.60502002646,
                                71667.52723043312, 73716.95873086515,
                                75788.60594822581, 77897.4821933113,
                                80044.94995022703, 82234.54290169897,
                                84450.00025112768, 86682.54412363392,
                                88891.58530376352, 91162.43833828924,
                                93528.8164402678, 95905.3817402398,
                                98702.40795278172, 101931.07471965952,
                                104949.50000000001],
                               [37664.0, 112842.0, 187575.0, 261569.0,
                                334533.0, 406175.0, 476206.0, 544368.0,
                                610378.0, 673990.0, 734936.0, 792965.0,
                                847880.0, 899434.0, 947465.0, 991735.0,
                                1032102.0, 1068403.0, 1100453.0, 1128183.0,
                                1151470.0, 1170209.0, 1184323.0, 1193741.0,
                                1198509.0, 1198519.0, 1193793.0, 1184338.0,
                                1170203.0, 1151484.0, 1128242.0, 1100518.0,
                                1068416.0, 1032147.0, 991741.0, 947493.0,
                                899480.0, 847932.0, 793023.0, 734971.0,
                                674059.0, 610401.0, 544424.0, 476262.0,
                                406270.0, 334625.0, 261677.0, 187704.0,
                                113007.0, 37829.0, 50.0],
                               100.0, 903.0, 104949.50000000001, 38175716.0],
                              65338.905483004186],
                             ['N', 25.48728604675503,
                              [5.52339315198953, 45.4851261195677],
                              0.4911144501042686, 12.94983651428874,
                              [[1623.0449992063661, 3521.1340690395014,
                                5696.294492513052, 7889.064832054105,
                                10083.301483275676, 12280.654663510339,
                                14475.623969722268, 16648.841851914272,
                                18804.204014054827, 20936.148469264972,
                                23059.798678535433, 25160.785269928012,
                                27230.379623661553, 29276.89475784857,
                                31298.053653533196, 33289.51605941494,
                                35243.70267370527, 37165.51534636269,
                                39059.4160740602, 40915.78498627178,
                                42727.48897532228, 44487.61900798006,
                                46211.678375907344, 47904.44868639024,
                                49574.25281796598, 51238.56392654655,
                                52911.27032971889, 54613.34901651471,
                                56348.13264178488, 58120.35238232391,
                                59933.12937010529, 61786.04327414923,
                                63693.85655589992, 65637.21218599938,
                                67613.74395432815, 69613.52638328263,
                                71657.2944837953, 73730.20484690368,
                                75839.19750250342, 77953.62923449957,
                                80098.48068315444, 82283.34209920875,
                                84458.92450326764, 86677.91104257035,
                                88948.49186090761, 91224.24066947198,
                                93574.9510470521, 96063.92948559603,
                                98783.45567348876, 101849.25393873769,
                                104799.50000000001],
                               [75602.0, 226508.0, 376522.0, 525050.0,
                                671507.0, 815315.0, 955883.0, 1092718.0,
                                1225205.0, 1352873.0, 1475189.0, 1591703.0,
                                1701925.0, 1805440.0, 1901833.0, 1990712.0,
                                2071728.0, 2144574.0, 2208964.0, 2264638.0,
                                2311332.0, 2348945.0, 2377241.0, 2396222.0,
                                2405760.0, 2405722.0, 2396224.0, 2377290.0,
                                2348946.0, 2311352.0, 2264648.0, 2208983.0,
                                2144595.0, 2071748.0, 1990773.0, 1901860.0,
                                1805455.0, 1701998.0, 1591798.0, 1475244.0,
                                1352915.0, 1225295.0, 1092782.0, 956003.0,
                                815387.0, 671604.0, 525122.0, 376669.0,
                                226663.0, 75740.0, 50.0],
                               100.0, 901.0, 104799.50000000001, 76628255.0],
                              65327.63560642383],
                             ['R', 25.473605988974857,
                              [5.504346141758424, 45.46606682316469],
                              0.49129422033845405, 12.931856211976127,
                              [[1617.66763991819, 3519.5671117257907,
                                5682.623237791464, 7877.131044810964,
                                10070.243386455724, 12268.850508974274,
                                14448.48302991209, 16641.593939705817,
                                18795.950957500245, 20932.451062453616,
                                23060.72410919493, 25160.53478245344,
                                27227.734129547804, 29280.774143311886,
                                31306.604874312063, 33295.51094723149,
                                35258.655000591316, 37191.41451377497,
                                39080.05693297386, 40931.43661469698,
                                42735.19376454507, 44502.46220877066,
                                46229.04785379266, 47913.37855303704,
                                49584.44966554364, 51250.30808767379,
                                52920.225931983565, 54618.6848951693,
                                56352.25095356554, 58119.51325280215,
                                59925.07462668465, 61773.61075820473,
                                63669.692916303924, 65615.02907597086,
                                67596.83620209804, 69616.68223437444,
                                71659.89215600674, 73740.96812977306,
                                75817.32383253823, 77904.5596500895,
                                80040.83250693168, 82221.32913451809,
                                84416.59665706825, 86636.07004387978,
                                88898.51473860227, 91194.27928831543,
                                93499.35353836675, 95977.17558282692,
                                98724.8420074921, 101926.10896094967,
                                104899.50000000001],
                               [37647.0, 112794.0, 187492.0, 261454.0,
                                334385.0, 405993.0, 475994.0, 544132.0,
                                610120.0, 673667.0, 734594.0, 792612.0,
                                847502.0, 899032.0, 947028.0, 991310.0,
                                1031638.0, 1067911.0, 1099971.0, 1127707.0,
                                1150981.0, 1169705.0, 1183786.0, 1193237.0,
                                1197944.0, 1197986.0, 1193240.0, 1183814.0,
                                1169736.0, 1150980.0, 1127706.0, 1099980.0,
                                1067934.0, 1031699.0, 991350.0, 947084.0,
                                899102.0, 847571.0, 792647.0, 734645.0,
                                673720.0, 610215.0, 544175.0, 476074.0,
                                406086.0, 334474.0, 261567.0, 187620.0,
                                112917.0, 37823.0, 50.0],
                               100.0, 905.0, 104899.50000000001, 38158831.0],
                              65306.05893983318]],
                    'types': ['VARCHAR', 'DOUBLE', 'ARRAY(DOUBLE)', 'DOUBLE',
                              'DOUBLE',
                              "ROW(('means', Type(name='ARRAY', "
                              "params=(Type(name='DOUBLE', "
                              "params=()),))),('weights', Type(name='ARRAY', "
                              "params=(Type(name='DOUBLE', "
                              "params=()),))),('compression', "
                              "Type(name='DOUBLE', params=())),('min', "
                              "Type(name='DOUBLE', params=())),('max', "
                              "Type(name='DOUBLE', params=())),('sum', "
                              "Type(name='DOUBLE', params=())))",
                              'DOUBLE']},
             'K3': {'counters': [2, 1, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [['F', 0.04999999999999999, 0.09999999999999998,
                              0.5405354182879153, 3033927,
                              'sha256:4677fa5c0e2d4ec2b49afb3804ac1ad1fd4622c6127e41597fa8b7f989584a0f'],
                             ['O', 0.04999999999999999, 0.09999999999999999,
                              0.5439930373205819, 2966674,
                              'sha256:6d69134e2eaacb0ec2dab109c45422dcec3d26b67dd1dbf984237c468cda3089']],
                    'types': ['VARCHAR', 'DOUBLE', 'DOUBLE', 'DOUBLE',
                              'BIGINT', 'VARCHAR']},
             'K4': {'counters': [2, 1, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [['A', 'F', [6.0, 26.0, 46.0], 0.05, 38175716.0,
                              1497115],
                             ['N', 'F', [5.0, 25.0, 45.0], 0.05, 997717.0,
                              39234],
                             ['N', 'O', [6.0, 25.0, 46.0], 0.05, 75630538.0,
                              2966674],
                             ['R', 'F', [5.0, 25.0, 45.0], 0.05, 38158831.0,
                              1497578]],
                    'types': ['VARCHAR', 'VARCHAR', 'ARRAY(DOUBLE)', 'DOUBLE',
                              'DOUBLE', 'BIGINT']},
             'K5': {'counters': [5, 1, 0, 0, 1, 1, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [['1-URGENT', [4625222, 4507041, 637382], [1, 2],
                              [['MAIL', 172066], ['REG AIR', 171783],
                               ['TRUCK', 171739]]],
                             ['2-HIGH', [2538887, 5876036, 1347654], [1, 2],
                              [['AIR', 172379], ['FOB', 172327],
                               ['SHIP', 172767]]],
                             ['3-MEDIUM', [1105608, 2622660, 5150758], [1, 2],
                              [['AIR', 171972], ['FOB', 172090],
                               ['MAIL', 172205]]],
                             ['4-NOT SPECIFIED', [3799300, 86472, 869058],
                              [1, 2],
                              [['MAIL', 171077], ['SHIP', 171147],
                               ['TRUCK', 170987]]],
                             ['5-LOW', [790050, 2110433, 2935779], [1, 2],
                              [['AIR', 171927], ['FOB', 171624],
                               ['RAIL', 171564]]]],
                    'types': ['VARCHAR', 'ARRAY(BIGINT)', 'ARRAY(INTEGER)',
                              'MAP(VARCHAR,BIGINT)']},
             'K6': {'counters': [2, 1, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [['F', 198085489505.0, 719489],
                             ['O', 193807695808.33002, 703440],
                             ['P', 21277933522.65, 77071]],
                    'types': ['VARCHAR', 'DOUBLE', 'BIGINT']},
             'K6b': {'counters': [2, 2, 0, 0, 0, 0, 0],
                     'error': None,
                     'memo': [],
                     'mode': 'dynamic',
                     'rows': [[[['F', 719489], ['O', 703440], ['P', 77071]]]],
                     'types': ['MAP(VARCHAR,BIGINT)']},
             'Z1': {'counters': [2, 1, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [[22, 839324, 231430393705.63992,
                              275734.2738985659],
                             [23, 660676, 181740725130.33997,
                              275082.9833842004]],
                    'types': ['BIGINT', 'BIGINT', 'DOUBLE', 'DOUBLE']},
             'Z2': {'counters': [2, 1, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [[1992, 1, '1992', 10, 719415000000000, 80030,
                              3051849488.35, 0.05004035986505059],
                             [1992, 1, '1992', 11, 725461200000000, 30318,
                              1156349453.4500015, 0.050121050201200675],
                             [1992, 2, '1992', 10, 719501400000000, 80197,
                              3068765284.860004, 0.04998640846914472],
                             [1992, 2, '1992', 11, 725547600000000, 30210,
                              1154288100.7699995, 0.04979576299238659],
                             [1992, 3, '1992', 10, 719587800000000, 80819,
                              3083420243.200001, 0.050051349311424284],
                             [1992, 3, '1992', 11, 725634000000000, 30461,
                              1159732400.6899996, 0.049834870818423534],
                             [1992, 4, '1992', 10, 719674200000000, 80499,
                              3073318853.7299995, 0.04994645896222319],
                             [1992, 4, '1992', 11, 725720400000000, 30378,
                              1165656161.8499992, 0.04972249654355135],
                             [1992, 5, '1992', 10, 719760600000000, 80334,
                              3062048211.25, 0.04987091393432425],
                             [1992, 5, '1992', 11, 725202000000000, 28488,
                              1090806137.4899998, 0.0501302302723953],
                             [1992, 6, '1992', 10, 719847000000000, 80713,
                              3082843183.0200005, 0.050038283795671074],
                             [1992, 6, '1992', 11, 725288400000000, 28653,
                              1099278883.7599998, 0.05026803476075801],
                             [1992, 7, '1992', 10, 719933400000000, 81103,
                              3098569067.460002, 0.05000986400009874],
                             [1992, 7, '1992', 11, 725374800000000, 28595,
                              1097392916.9799995, 0.04996188144780554],
                             [1993, 1, '1993', 10, 751469400000000, 85858,
                              3273897346.3500037, 0.05001793659297911],
                             [1993, 1, '1993', 11, 756910800000000, 45397,
                              1737654099.579999, 0.05006057669008962],
                             [1993, 2, '1993', 10, 751555800000000, 86117,
                              3294500853.0000005, 0.049991871523624845],
                             [1993, 2, '1993', 11, 756997200000000, 45088,
                              1724331548.3300006, 0.050254169623846774],
                             [1993, 3, '1993', 10, 751642200000000, 86053,
                              3295685361.949998, 0.05000499692050249],
                             [1993, 3, '1993', 11, 757083600000000, 45129,
                              1729955033.079997, 0.04979481043231622],
                             [1993, 4, '1993', 10, 751728600000000, 85426,
                              3270086384.539999, 0.049885866129749726],
                             [1993, 4, '1993', 11, 757170000000000, 45183,
                              1728418523.4799998, 0.0502467742292455],
                             [1993, 5, '1993', 10, 751815000000000, 86362,
                              3291592396.9399986, 0.05002385308353215],
                             [1993, 5, '1993', 11, 757256400000000, 47727,
                              1829289547.2900014, 0.04986527542062153],
                             [1993, 6, '1993', 10, 751901400000000, 85788,
                              3282200036.640001, 0.05010735767240171],
                             [1993, 6, '1993', 11, 756738000000000, 45326,
                              1743637350.1300004, 0.050110753210078046],
                             [1993, 7, '1993', 10, 751987800000000, 85754,
                              3290224122.0900035, 0.049891317023112586],
                             [1993, 7, '1993', 11, 756824400000000, 45564,
                              1742343301.3499992, 0.049976955491177234],
                             [1994, 1, '1994', 10, 782919000000000, 85866,
                              3293246626.1000013, 0.05003493815945776],
                             [1994, 1, '1994', 11, 788360400000000, 45036,
                              1710072752.9099987, 0.050084821032063326],
                             [1994, 2, '1994', 10, 783005400000000, 85578,
                              3271963092.63, 0.049881862160835726],
                             [1994, 2, '1994', 11, 788446800000000, 45379,
                              1737671386.8200011, 0.05001432380616581],
                             [1994, 3, '1994', 10, 783091800000000, 85469,
                              3266714189.919999, 0.050079093004481115],
                             [1994, 3, '1994', 11, 788533200000000, 45220,
                              1729104230.09, 0.05021959310039805],
                             [1994, 4, '1994', 10, 783178200000000, 85507,
                              3259145693.420002, 0.05010350029822121],
                             [1994, 4, '1994', 11, 788619600000000, 45358,
                              1729483619.0999975, 0.050063715331363876],
                             [1994, 5, '1994', 10, 783264600000000, 85220,
                              3255260707.529994, 0.04998908706876323],
                             [1994, 5, '1994', 11, 788706000000000, 44991,
                              1722960006.1499984, 0.049952879464781864],
                             [1994, 6, '1994', 10, 783351000000000, 85576,
                              3270654865.400004, 0.050072216509301666],
                             [1994, 6, '1994', 11, 788792400000000, 48096,
                              1841583471.69, 0.04974446939454422],
                             [1994, 7, '1994', 10, 783437400000000, 85647,
                              3260509847.8100014, 0.04982521279204173],
                             [1994, 7, '1994', 11, 788274000000000, 45460,
                              1743592762.6399977, 0.04990585129784427],
                             [1995, 1, '1995', 10, 814368600000000, 85944,
                              3280874645.699998, 0.05004968351484688],
                             [1995, 1, '1995', 11, 819810000000000, 45108,
                              1727433811.7899985, 0.0500873459253347],
                             [1995, 2, '1995', 10, 814455000000000, 85861,
                              3285446383.4699984, 0.04991870581521291],
                             [1995, 2, '1995', 11, 819896400000000, 45498,
                              1752005010.1200006, 0.05012923644995384],
                             [1995, 3, '1995', 10, 814541400000000, 85903,
                              3278253117.3199983, 0.049969267662363384],
                             [1995, 3, '1995', 11, 819982800000000, 45610,
                              1734914340.5000005, 0.05010392457794343],
                             [1995, 4, '1995', 10, 814627800000000, 86277,
                              3299738646.329997, 0.05011532621672053],
                             [1995, 4, '1995', 11, 820069200000000, 44985,
                              1718395003.7199988, 0.050222074024674886],
                             [1995, 5, '1995', 10, 814714200000000, 86078,
                              3296635767.07, 0.0500225376983666],
                             [1995, 5, '1995', 11, 820155600000000, 45528,
                              1732359341.3099997, 0.04993608328940435],
                             [1995, 6, '1995', 10, 814800600000000, 86177,
                              3294501798.6600027, 0.04987606902073636],
                             [1995, 6, '1995', 11, 820242000000000, 45420,
                              1733621343.0499983, 0.05018383971818579],
                             [1995, 7, '1995', 10, 814887000000000, 86052,
                              3287319499.3300033, 0.05003114395946639],
                             [1995, 7, '1995', 11, 820328400000000, 47934,
                              1834819683.3999991, 0.05018108232152544],
                             [1996, 1, '1996', 10, 845818200000000, 75411,
                              2892825236.16, 0.04992242511039502],
                             [1996, 1, '1996', 11, 851864400000000, 58619,
                              2242890573.3400006, 0.05028983776591206],
                             [1996, 2, '1996', 10, 845904600000000, 75545,
                              2886187459.45, 0.05005043351644716],
                             [1996, 2, '1996', 11, 851950800000000, 58319,
                              2228870323.1400003, 0.049877569917179704],
                             [1996, 3, '1996', 10, 845991000000000, 75576,
                              2895033149.6600018, 0.050009659151053196],
                             [1996, 3, '1996', 11, 851432400000000, 56139,
                              2144143541.1500018, 0.05014855982472075],
                             [1996, 4, '1996', 10, 846077400000000, 75409,
                              2879245520.9900002, 0.050006365287962984],
                             [1996, 4, '1996', 11, 851518800000000, 55768,
                              2126843289.5499995, 0.04995194376703484],
                             [1996, 5, '1996', 10, 846163800000000, 75695,
                              2889227892.6900015, 0.04997806988572557],
                             [1996, 5, '1996', 11, 851605200000000, 55604,
                              2124627170.6600015, 0.05010700669016616],
                             [1996, 6, '1996', 10, 846250200000000, 75909,
                              2911637984.9699965, 0.05001172456493958],
                             [1996, 6, '1996', 11, 851691600000000, 55512,
                              2116459121.9000003, 0.049962170341547825],
                             [1996, 7, '1996', 10, 846336600000000, 75656,
                              2889117130.269996, 0.04996193295971236],
                             [1996, 7, '1996', 11, 851778000000000, 55488,
                              2120419740.7599995, 0.05005748990772774],
                             [1997, 1, '1997', 10, 877267800000000, 75802,
                              2906718077.0699987, 0.050137727236748336],
                             [1997, 1, '1997', 11, 883314000000000, 55778,
                              2131479694.8599973, 0.05007978055864323],
                             [1997, 2, '1997', 10, 877354200000000, 75995,
                              2890088812.400001, 0.04999342061977762],
                             [1997, 2, '1997', 11, 883400400000000, 55976,
                              2140525638.26, 0.05020187223095615],
                             [1997, 3, '1997', 10, 877440600000000, 76111,
                              2919185591.8800015, 0.04997687587865092],
                             [1997, 3, '1997', 11, 883486800000000, 58612,
                              2236551806.130002, 0.04998037944448235],
                             [1997, 4, '1997', 10, 877527000000000, 75868,
                              2885563150.71, 0.05001753044761958],
                             [1997, 4, '1997', 11, 882968400000000, 55908,
                              2135250385.64, 0.04991450239679476],
                             [1997, 5, '1997', 10, 877613400000000, 75929,
                              2907026215.0700006, 0.049960357702590594],
                             [1997, 5, '1997', 11, 883054800000000, 55670,
                              2125069773.9100006, 0.049912340578408425],
                             [1997, 6, '1997', 10, 877699800000000, 75576,
                              2898401437.8200006, 0.04992762252566957],
                             [1997, 6, '1997', 11, 883141200000000, 55739,
                              2132840985.9100008, 0.050050413534509015],
                             [1997, 7, '1997', 10, 877786200000000, 75541,
                              2883345218.5499997, 0.050248739095325706],
                             [1997, 7, '1997', 11, 883227600000000, 55998,
                              2146119913.55, 0.050246080217150636],
                             [1998, 1, '1998', 10, 908717400000000, 58005,
                              2222331932.4500012, 0.05018050168088961],
                             [1998, 1, '1998', 11, 909320400000000, 30159,
                              1150133984.7300005, 0.04993600583573724],
                             [1998, 2, '1998', 10, 908803800000000, 57619,
                              2206180982.000001, 0.04979312379597011],
                             [1998, 2, '1998', 11, 909406800000000, 30321,
                              1159097737.0799987, 0.04973054978397808],
                             [1998, 3, '1998', 10, 908890200000000, 56819,
                              2175047721.3700004, 0.0497939069677397],
                             [1998, 3, '1998', 11, 909493200000000, 30387,
                              1162916678.869999, 0.049824266956264164],
                             [1998, 4, '1998', 10, 908976600000000, 56407,
                              2156162600.6800013, 0.05004556172106295],
                             [1998, 4, '1998', 11, 909579600000000, 33173,
                              1267591981.82, 0.05008078859313294],
                             [1998, 5, '1998', 10, 909063000000000, 56567,
                              2169244099.2600026, 0.04998903954602501],
                             [1998, 5, '1998', 11, 909666000000000, 32974,
                              1261432403.2400005, 0.04981470249287314],
                             [1998, 6, '1998', 10, 909149400000000, 55871,
                              2136218615.8200002, 0.05016520198313969],
                             [1998, 6, '1998', 11, 909752400000000, 32888,
                              1253641205.1200001, 0.05013926052055463],
                             [1998, 7, '1998', 10, 909235800000000, 55531,
                              2116002515.32, 0.04988294826313229],
                             [1998, 7, '1998', 11, 909838800000000, 32379,
                              1237148493.3599985, 0.05016986318292721]],
                    'types': ['BIGINT', 'BIGINT', 'VARCHAR', 'BIGINT',
                              'TIMESTAMP WITH TIME ZONE', 'BIGINT', 'DOUBLE',
                              'DOUBLE']},
             'Z3': {'counters': [5, 1, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [['1-URGENT', 355057, 13567133403.950018],
                             ['2-HIGH', 354339, 13528931244.339996],
                             ['3-MEDIUM', 353857, 13511057525.580006],
                             ['4-NOT SPECIFIED', 352390, 13495527472.769999],
                             ['5-LOW', 354023, 13563044336.95999]],
                    'types': ['VARCHAR', 'BIGINT', 'DOUBLE']},
             'Z4': {'counters': [0, 0, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [[1590992100000000, 1590992100000000,
                              1591025400000000,
                              '2020-06-01 17:30:00.000 Asia/Kolkata', -3, -30,
                              0, 18414, 84600000000, 1591000200.25,
                              '10:00:00.000+05:30',
                              '2020-06-01 21:00:00.000 Asia/Tokyo',
                              '1969-12-31 19:30:00.000 -04:30',
                              '2020-03-08 01:30:00.000 America/New_York',
                              1604208600.0,
                              '2020-03-08 03:30:00.000 America/New_York',
                              '2020-02-29 12:00:00.000 America/New_York']],
                    'types': ['TIMESTAMP WITH TIME ZONE',
                              'TIMESTAMP WITH TIME ZONE',
                              'TIMESTAMP WITH TIME ZONE', 'VARCHAR', 'BIGINT',
                              'BIGINT', 'BIGINT', 'DATE', 'TIME', 'DOUBLE',
                              'VARCHAR', 'VARCHAR', 'VARCHAR', 'VARCHAR',
                              'DOUBLE', 'VARCHAR', 'VARCHAR']},
             'Z4b': {'counters': [2, 1, 0, 0, 0, 0, 0],
                     'error': None,
                     'memo': [],
                     'mode': 'dynamic',
                     'rows': [[18, 1500000, 413171118835.9798]],
                     'types': ['BIGINT', 'BIGINT', 'DOUBLE']},
             'Z5a': {'counters': [0, 0, 0, 0, 0, 0, 0],
                     'error': None,
                     'memo': [],
                     'mode': '',
                     'rows': [[True]],
                     'types': ['BOOLEAN']},
             'Z5b': {'counters': [0, 0, 0, 0, 0, 0, 0],
                     'error': None,
                     'memo': [],
                     'mode': 'dynamic',
                     'rows': [['Asia/Tokyo']],
                     'types': ['VARCHAR']},
             'Z5c': {'counters': [0, 0, 0, 0, 0, 0, 0],
                     'error': None,
                     'memo': [],
                     'mode': 'dynamic',
                     'rows': [['2020-06-01 12:00:00.000 Asia/Tokyo', True]],
                     'types': ['VARCHAR', 'BOOLEAN']},
             'Z5d': {'counters': [0, 0, 0, 0, 0, 0, 0],
                     'error': None,
                     'memo': [],
                     'mode': 'dynamic',
                     'rows': [[690985, 8035]],
                     'types': ['BIGINT', 'DATE']}}}

#: K2's weighted-digest columns at SF1 (destructure_tdigest(w),
#: value_at_quantile(w, 0.75)): presto_tpu's t-digest over the generated
#: columns (`python -m tests.torch_zone_sketch_common weighted 1`, which
#: first checks the port's l_returnflag, l_extendedprice and l_quantity
#: bit for bit against presto_tpu's host generator), in place of
#: presto_tpu's records, whose SF1 scan gives some prices one ulp off,
#: which reorders equal prices and moves the weighted centroids
#: (ROADMAP C)
ZS_K2_WEIGHTED_SF1 = [['A',
  [[1626.9691976423092, 3526.2952880133453, 5697.405266160174,
    7892.524971078435, 10094.536269366592, 12298.031053880684,
    14475.663743064988, 16654.612283271632, 18803.48304509675,
    20948.525190299544, 23071.177707800336, 25169.476338627832,
    27240.995895633838, 29295.338683561007, 31312.259092504686,
    33304.59961471571, 35263.48190756356, 37181.94418080993,
    39068.23591624541, 40919.280266809576, 42716.513779551395,
    44474.21559905105, 46206.67100852557, 47898.50345191303,
    49569.54455223968, 51230.16672109845, 52899.763505324176,
    54595.50398648017, 56325.48961265673, 58093.0390854931, 59932.67640764118,
    61806.300419829655, 63706.60221168522, 65647.31806732032,
    67621.09828452198, 69624.60502002649, 71667.52723043314,
    73716.95873086514, 75788.60594822583, 77897.48219331128,
    80044.94995022705, 82234.54290169897, 84450.00025112767,
    86682.54412363394, 88891.58530376351, 91162.43833828924, 93528.8164402678,
    95905.3817402398, 98702.40795278172, 101931.07471965952,
    104949.49999999999],
   [37664.0, 112842.0, 187575.0, 261569.0, 334533.0, 406175.0, 476206.0,
    544368.0, 610378.0, 673990.0, 734936.0, 792965.0, 847880.0, 899434.0,
    947465.0, 991735.0, 1032102.0, 1068403.0, 1100453.0, 1128183.0, 1151470.0,
    1170209.0, 1184323.0, 1193741.0, 1198509.0, 1198508.0, 1193804.0,
    1184338.0, 1170203.0, 1151484.0, 1128242.0, 1100518.0, 1068416.0,
    1032147.0, 991741.0, 947493.0, 899480.0, 847932.0, 793023.0, 734971.0,
    674059.0, 610401.0, 544424.0, 476262.0, 406270.0, 334625.0, 261677.0,
    187704.0, 113007.0, 37829.0, 50.0],
   100.0, 903.0, 104949.49999999999, 38175716.0],
  65338.90548300419],
 ['N',
  [[1623.0449992063661, 3521.1340690395004, 5696.294492513051,
    7889.064832054094, 10083.30148327568, 12280.654663510339,
    14475.623969722277, 16648.841851914294, 18804.204014054812,
    20936.148469264976, 23059.79867853544, 25160.785269928012,
    27230.379623661545, 29276.89475784857, 31298.05052685658,
    33289.51304423321, 35243.702673705266, 37165.51534636265,
    39059.416074060166, 40915.78498627175, 42727.48897532233,
    44487.6190079801, 46211.67837590723, 47904.44868639022, 49574.25281796602,
    51238.56392654658, 52911.270329718885, 54613.349016514665,
    56348.132641784854, 58120.352382323916, 59933.129370105285,
    61786.043274149204, 63693.85655589992, 65637.2121859994,
    67613.74395432808, 69613.52208905313, 71657.289951353, 73730.2048469037,
    75839.19750250352, 77953.6292344996, 80098.48068315443, 82283.34209920875,
    84458.92450326761, 86677.91104257037, 88948.49186090763,
    91224.24066947201, 93574.95104705212, 96063.92948559603,
    98783.45567348876, 101849.25393873767, 104799.49999999999],
   [75602.0, 226508.0, 376522.0, 525050.0, 671507.0, 815315.0, 955883.0,
    1092718.0, 1225205.0, 1352873.0, 1475189.0, 1591703.0, 1701925.0,
    1805440.0, 1901827.0, 1990718.0, 2071728.0, 2144574.0, 2208964.0,
    2264638.0, 2311332.0, 2348945.0, 2377241.0, 2396222.0, 2405760.0,
    2405722.0, 2396224.0, 2377290.0, 2348946.0, 2311352.0, 2264648.0,
    2208983.0, 2144595.0, 2071748.0, 1990773.0, 1901852.0, 1805463.0,
    1701998.0, 1591798.0, 1475244.0, 1352915.0, 1225295.0, 1092782.0,
    956003.0, 815387.0, 671604.0, 525122.0, 376669.0, 226663.0, 75740.0,
    50.0],
   100.0, 901.0, 104799.49999999999, 76628255.0],
  65327.63560642384],
 ['R',
  [[1617.66763991819, 3519.5671117257916, 5682.623237791466,
    7877.1310448109625, 10070.243386455733, 12268.850508974256,
    14448.483029912093, 16641.59393970581, 18795.95095750025,
    20932.451062453616, 23060.72410919496, 25160.534782453466,
    27227.73412954783, 29280.77414331187, 31306.60487431207,
    33295.510947231494, 35258.65500059132, 37191.414513774966,
    39080.056932973814, 40931.41739475548, 42735.1480197486,
    44502.41063557006, 46228.99510175448, 47913.32032881269,
    49584.39828413003, 51250.23626006931, 52920.14460648985,
    54618.628238791614, 56352.19414305293, 58119.48321132835,
    59925.07462668463, 61773.61075820472, 63669.69291630391,
    65615.02907597087, 67596.83620209801, 69616.68223437443, 71659.8921560067,
    73740.96812977309, 75817.32383253823, 77904.5596500895, 80040.83250693166,
    82221.32913451809, 84416.59665706826, 86636.07004387978,
    88898.51473860227, 91194.27928831542, 93499.35353836673,
    95977.17558282694, 98724.8420074921, 101926.10896094967,
    104899.49999999999],
   [37647.0, 112794.0, 187492.0, 261454.0, 334385.0, 405993.0, 475994.0,
    544132.0, 610120.0, 673667.0, 734594.0, 792612.0, 847502.0, 899032.0,
    947028.0, 991310.0, 1031638.0, 1067911.0, 1099971.0, 1127683.0, 1150970.0,
    1169706.0, 1183781.0, 1193232.0, 1197958.0, 1197942.0, 1193273.0,
    1183818.0, 1169734.0, 1151019.0, 1127706.0, 1099980.0, 1067934.0,
    1031699.0, 991350.0, 947084.0, 899102.0, 847571.0, 792647.0, 734645.0,
    673720.0, 610215.0, 544175.0, 476074.0, 406086.0, 334474.0, 261567.0,
    187620.0, 112917.0, 37823.0, 50.0],
   100.0, 905.0, 104899.49999999999, 38158831.0],
  65306.05893983319]]

#: presto_tpu's SF1 records of TPC-H Q1, Q3, Q6 and Q18 under
#: float32_compute in "dynamic" and "compiled" (`JAX_PLATFORMS=cpu python
#: -m tests.torch_geo_ml_common f32 1 Q <cache dir>`, one query a process;
#: geo_ml_queries.compact_reference's form)
F32_REFERENCE_SF1 = {'compiled': {'Q1': {'counters': [0, 1, 0, 0, 0, 0, 0],
                     'memo': ['executable'],
                     'mode': 'compiled'},
              'Q18': {'counters': [7, 4, 0, 0, 4, 4, 0],
                      'memo': ['executable'],
                      'mode': 'compiled'},
              'Q3': {'counters': [4, 2, 0, 0, 2, 2, 0],
                     'memo': ['executable'],
                     'mode': 'compiled'},
              'Q6': {'memo': ['executable'], 'mode': 'compiled'}},
 'dynamic': {'Q1': {'counters': [2, 1, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [['A',
                              'F',
                              38175716.0,
                              57244104191.89667,
                              54380485079.60889,
                              56555691940.16077,
                              25.499521412850715,
                              38236.27723447876,
                              0.05002616372316135,
                              1497115],
                             ['N',
                              'F',
                              997717.0,
                              1496531023.6170654,
                              1422159974.116394,
                              1478932813.0843506,
                              25.429907733088648,
                              38143.72798126792,
                              0.04979558552989877,
                              39234],
                             ['N',
                              'O',
                              74647007.0,
                              111937609237.32422,
                              106339179987.42511,
                              110591674932.00677,
                              25.49094906967111,
                              38225.18826574491,
                              0.050023593374726255,
                              2928373],
                             ['R',
                              'F',
                              38158831.0,
                              57232240755.833374,
                              54372266221.09808,
                              56548239639.6579,
                              25.480362959391766,
                              38216.534134337824,
                              0.049983927448793236,
                              1497578]],
                    'types': ['VARCHAR',
                              'VARCHAR',
                              'DOUBLE',
                              'DOUBLE',
                              'DOUBLE',
                              'DOUBLE',
                              'DOUBLE',
                              'DOUBLE',
                              'DOUBLE',
                              'BIGINT']},
             'Q18': {'counters': [11, 3, 1, 0, 4, 4, 7500090],
                     'error': None,
                     'memo': [],
                     'mode': 'dynamic',
                     'rows': [['Customer#000051242',
                               51242,
                               5631618,
                               9144,
                               549072.0625,
                               305.0],
                              ['Customer#000103718',
                               103718,
                               587844,
                               9304,
                               543416.125,
                               310.0],
                              ['Customer#000090776',
                               90776,
                               1443112,
                               8062,
                               525181.125,
                               309.0],
                              ['Customer#000044053',
                               44053,
                               2214690,
                               10136,
                               516285.34375,
                               310.0],
                              ['Customer#000090877',
                               90877,
                               4845704,
                               8509,
                               501237.28125,
                               302.0],
                              ['Customer#000114593',
                               114593,
                               4543938,
                               8718,
                               499704.46875,
                               309.0],
                              ['Customer#000022078',
                               22078,
                               608903,
                               9900,
                               496791.875,
                               306.0],
                              ['Customer#000040091',
                               40091,
                               3458788,
                               9118,
                               496637.34375,
                               309.0],
                              ['Customer#000043895',
                               43895,
                               1628997,
                               9739,
                               474452.375,
                               302.0],
                              ['Customer#000117746',
                               117746,
                               1032229,
                               10347,
                               469396.34375,
                               305.0],
                              ['Customer#000077156',
                               77156,
                               691816,
                               9420,
                               448743.15625,
                               303.0],
                              ['Customer#000044318',
                               44318,
                               5239397,
                               9478,
                               448460.21875,
                               311.0],
                              ['Customer#000006425',
                               6425,
                               3428551,
                               9328,
                               440416.6875,
                               302.0],
                              ['Customer#000025184',
                               25184,
                               4978145,
                               9080,
                               433412.625,
                               311.0],
                              ['Customer#000091514',
                               91514,
                               378469,
                               9222,
                               430690.15625,
                               304.0],
                              ['Customer#000118574',
                               118574,
                               814885,
                               9721,
                               429294.5,
                               303.0],
                              ['Customer#000099872',
                               99872,
                               1080580,
                               9966,
                               410705.5625,
                               309.0],
                              ['Customer#000054523',
                               54523,
                               2054053,
                               9267,
                               409750.28125,
                               306.0],
                              ['Customer#000110849',
                               110849,
                               1810632,
                               9386,
                               396152.46875,
                               301.0],
                              ['Customer#000014897',
                               14897,
                               692705,
                               9784,
                               385693.0,
                               301.0],
                              ['Customer#000143360',
                               143360,
                               2012966,
                               9275,
                               372866.4375,
                               302.0],
                              ['Customer#000006730',
                               6730,
                               1455432,
                               9526,
                               368658.34375,
                               308.0],
                              ['Customer#000010109',
                               10109,
                               5862754,
                               8835,
                               342439.15625,
                               304.0],
                              ['Customer#000115169',
                               115169,
                               4399906,
                               8677,
                               337801.0625,
                               301.0],
                              ['Customer#000093863',
                               93863,
                               4626658,
                               8828,
                               328607.28125,
                               301.0],
                              ['Customer#000020246',
                               20246,
                               402628,
                               9720,
                               320473.1875,
                               308.0],
                              ['Customer#000076327',
                               76327,
                               4734116,
                               9941,
                               318386.03125,
                               313.0],
                              ['Customer#000036173',
                               36173,
                               3236102,
                               8235,
                               313647.40625,
                               309.0],
                              ['Customer#000125753',
                               125753,
                               2464387,
                               9776,
                               306293.21875,
                               302.0],
                              ['Customer#000050960',
                               50960,
                               1357222,
                               8081,
                               300183.40625,
                               305.0],
                              ['Customer#000136943',
                               136943,
                               5560870,
                               8880,
                               298344.75,
                               302.0],
                              ['Customer#000066944',
                               66944,
                               5174950,
                               8237,
                               292593.84375,
                               305.0],
                              ['Customer#000069727',
                               69727,
                               875814,
                               9701,
                               289690.84375,
                               303.0],
                              ['Customer#000142148',
                               142148,
                               5125474,
                               8617,
                               286523.9375,
                               323.0],
                              ['Customer#000081184',
                               81184,
                               1665698,
                               10307,
                               277102.21875,
                               302.0],
                              ['Customer#000129566',
                               129566,
                               5130598,
                               10263,
                               267973.03125,
                               301.0],
                              ['Customer#000053366',
                               53366,
                               1201256,
                               9111,
                               262790.875,
                               302.0],
                              ['Customer#000069704',
                               69704,
                               462689,
                               9400,
                               261514.734375,
                               306.0],
                              ['Customer#000112082',
                               112082,
                               926757,
                               9456,
                               253631.375,
                               302.0],
                              ['Customer#000080141',
                               80141,
                               3955783,
                               10158,
                               225068.046875,
                               301.0],
                              ['Customer#000028556',
                               28556,
                               5992930,
                               9138,
                               207941.515625,
                               321.0],
                              ['Customer#000137560',
                               137560,
                               4734626,
                               9562,
                               191394.90625,
                               306.0],
                              ['Customer#000089378',
                               89378,
                               4562183,
                               8759,
                               191233.046875,
                               309.0],
                              ['Customer#000034388',
                               34388,
                               1175173,
                               9057,
                               181961.375,
                               306.0],
                              ['Customer#000063106',
                               63106,
                               3963201,
                               8262,
                               181576.0625,
                               301.0],
                              ['Customer#000069293',
                               69293,
                               2788903,
                               9034,
                               169350.375,
                               324.0],
                              ['Customer#000070001',
                               70001,
                               1835170,
                               8497,
                               154290.203125,
                               302.0],
                              ['Customer#000128612',
                               128612,
                               3176999,
                               8985,
                               147732.546875,
                               303.0],
                              ['Customer#000093476',
                               93476,
                               3532419,
                               8859,
                               144413.390625,
                               303.0],
                              ['Customer#000071884',
                               71884,
                               3733313,
                               9397,
                               130545.046875,
                               311.0],
                              ['Customer#000030758',
                               30758,
                               5346758,
                               10232,
                               122404.796875,
                               315.0],
                              ['Customer#000102956',
                               102956,
                               5198726,
                               9421,
                               113172.8203125,
                               305.0],
                              ['Customer#000138139',
                               138139,
                               1931971,
                               8279,
                               112962.78125,
                               316.0],
                              ['Customer#000078560',
                               78560,
                               5331079,
                               9105,
                               93830.7890625,
                               301.0],
                              ['Customer#000042976',
                               42976,
                               4560930,
                               9724,
                               88343.3828125,
                               302.0],
                              ['Customer#000028403',
                               28403,
                               3264738,
                               9580,
                               86446.7890625,
                               308.0],
                              ['Customer#000124535',
                               124535,
                               1834984,
                               8520,
                               61047.578125,
                               308.0],
                              ['Customer#000047398',
                               47398,
                               1962629,
                               8820,
                               50172.55859375,
                               304.0],
                              ['Customer#000007622',
                               7622,
                               3557954,
                               9362,
                               37621.171875,
                               302.0],
                              ['Customer#000027808',
                               27808,
                               3734721,
                               9297,
                               26797.470703125,
                               323.0],
                              ['Customer#000018508',
                               18508,
                               5791075,
                               10037,
                               16544.01953125,
                               305.0],
                              ['Customer#000101753',
                               101753,
                               4588775,
                               10374,
                               10228.76953125,
                               302.0]],
                     'types': ['VARCHAR',
                               'BIGINT',
                               'BIGINT',
                               'DATE',
                               'DOUBLE',
                               'DOUBLE']},
             'Q3': {'counters': [4, 2, 0, 0, 2, 2, 6569069],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [[1708744, 406285.375, 9194, 0],
                             [3432737, 396873.59375, 9196, 0],
                             [5645442, 390060.875, 9201, 0],
                             [4746277, 389356.5625, 9187, 0],
                             [5405825, 388245.75, 9195, 0],
                             [340488, 382034.21875, 9201, 0],
                             [3437922, 380195.0625, 9178, 0],
                             [826277, 376878.21875, 9196, 0],
                             [3527746, 376737.25, 9188, 0],
                             [2759432, 375577.1875, 9188, 0]],
                    'types': ['BIGINT', 'DOUBLE', 'DATE', 'INTEGER']},
             'Q6': {'counters': [0, 0, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [[124264688.0]],
                    'types': ['DOUBLE']}}}

#: presto_tpu's records of G at geo_ml_queries.FULL (`... torch_geo_ml_common
#: geo`)
GEO_REFERENCE = {'auto': {'G1': {},
          'G2': {},
          'G3': {},
          'G4': {},
          'G4b': {'memo': ['executable'], 'mode': 'compiled'},
          'G5': {'memo': ['executable'], 'mode': 'compiled'}},
 'compiled': {'G1': {'counters': None,
                     'error': ['StaticFallback',
                               'spatial join is dynamic-mode only'],
                     'mode': None,
                     'rows': None,
                     'types': None},
              'G2': {'counters': None,
                     'error': ['StaticFallback',
                               'spatial join is dynamic-mode only'],
                     'mode': None,
                     'rows': None,
                     'types': None},
              'G3': {'counters': None,
                     'error': ['StaticFallback',
                               'spatial join is dynamic-mode only'],
                     'mode': None,
                     'rows': None,
                     'types': None},
              'G4': {},
              'G4b': {'memo': ['executable'], 'mode': 'compiled'},
              'G5': {'memo': ['executable'], 'mode': 'compiled'}},
 'dynamic': {'G1': {'counters': [0, 0, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [[6206690]],
                    'types': ['BIGINT']},
             'G2': {'counters': [3, 0, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [[9899, 994534],
                             [9892, 824780],
                             [9898, 490442],
                             [9893, 436362],
                             [9894, 405643],
                             [9891, 342618],
                             [9890, 299714],
                             [9895, 247201],
                             [9897, 104164],
                             [9896, 101286],
                             [9976, 25332],
                             [9973, 25270],
                             [9958, 17618],
                             [9907, 16942],
                             [9946, 16407],
                             [9909, 12885],
                             [9906, 10673],
                             [9971, 9567],
                             [9926, 9427],
                             [9905, 8445],
                             [9997, 7779],
                             [9953, 7266],
                             [9964, 6918],
                             [9914, 6799],
                             [9948, 6197],
                             [9990, 6111],
                             [9925, 5802],
                             [9901, 5546],
                             [9924, 4904],
                             [9933, 4844],
                             [7217, 4547],
                             [578, 4372],
                             [4636, 4319],
                             [9590, 3961],
                             [6013, 3901],
                             [9937, 3871],
                             [9998, 3701],
                             [9919, 3689],
                             [5836, 3410],
                             [8287, 3265],
                             [3899, 2926],
                             [8379, 2918],
                             [4193, 2908],
                             [9490, 2874],
                             [4222, 2867],
                             [9923, 2862],
                             [9992, 2860],
                             [4735, 2848],
                             [6068, 2845],
                             [5296, 2844],
                             [8820, 2778],
                             [4147, 2767],
                             [2951, 2754],
                             [3168, 2751],
                             [5742, 2748],
                             [6102, 2710],
                             [6975, 2706],
                             [9283, 2701],
                             [9456, 2660],
                             [5732, 2652],
                             [1916, 2648],
                             [7693, 2644],
                             [465, 2620],
                             [8620, 2613],
                             [223, 2605],
                             [8898, 2587],
                             [9017, 2587],
                             [3645, 2563],
                             [244, 2560],
                             [9994, 2557],
                             [5635, 2543],
                             [4939, 2488],
                             [9689, 2486],
                             [6457, 2482],
                             [5902, 2469],
                             [6306, 2466],
                             [1, 2456],
                             [4881, 2445],
                             [3525, 2444],
                             [222, 2433],
                             [560, 2426],
                             [7741, 2417],
                             [7548, 2397],
                             [883, 2364],
                             [1951, 2361],
                             [5801, 2351],
                             [8736, 2339],
                             [8973, 2332],
                             [8276, 2328],
                             [50, 2327],
                             [5009, 2324],
                             [3883, 2322],
                             [5841, 2322],
                             [3730, 2319],
                             [8480, 2310],
                             [7923, 2304],
                             [5424, 2293],
                             [2549, 2289],
                             [8883, 2278],
                             [3089, 2263]],
                    'types': ['BIGINT', 'BIGINT']},
             'G3': {'counters': [0, 0, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [[9591, 48900377, 4811776895]],
                    'types': ['BIGINT', 'BIGINT', 'BIGINT']},
             'G4': {'counters': None,
                    'error': ['ValueError',
                              'setting an array element with a sequence. The '
                              'requested array has an inhomogeneous shape '
                              'after 2 dimensions. The detected shape was '
                              '(10000, 2) + inhomogeneous part.'],
                    'memo': [],
                    'mode': None,
                    'rows': None,
                    'types': None},
             'G4b': {'counters': [1, 0, 0, 0, 0, 0, 0],
                     'error': None,
                     'memo': [],
                     'mode': 'dynamic',
                     'rows': [[0,
                               0.1374012203028343,
                               'POINT (1.7064647089829077 60.43652326312235)',
                               'sha256:3fd94ee32ba5dad07761be7976d03db1ac5d453945086e31a837bf427d34e481',
                               5,
                               0.0],
                              [1,
                               0.7143460616566699,
                               'POINT (63.26869198912948 51.70022929685876)',
                               'sha256:fd5b98ca2881bd6b59fdb38df2d281cd783ce8ff008a42d2a448ed83267d32c4',
                               5,
                               0.0],
                              [2,
                               1151.658802928388,
                               'POINT (54.37566692902349 91.68860525547878)',
                               'sha256:e5c898bc9c70ed0321527298c5104cccb10853289989c300bd6654e9c4facf59',
                               5,
                               0.0],
                              [3,
                               993.3100304882846,
                               'POINT (27.335675542155894 61.94673026230947)',
                               'sha256:641e814a2ecc0a2752d3626a00af39bf05e7783bfe61861ed7f12ff9a932c263',
                               5,
                               0.0],
                              [4,
                               1957.4673795001522,
                               'POINT (14.421678529837713 43.359832638327966)',
                               'sha256:787364f36e114d403744c82efd69d82cb4fb782d6aa430217de7024795869bf2',
                               5,
                               0.0],
                              [5,
                               1024.7920660095424,
                               'POINT (43.514112396040844 18.72656349056475)',
                               'sha256:7dc13fb045898df411215928e2e95ecd5961e52af43722c8c83f8d0c1f1a0a48',
                               5,
                               0.0],
                              [6,
                               1828.4529812004685,
                               'POINT (1.5594510851764345 16.72026726336715)',
                               'sha256:c4b71fabc4d23df498e6edea0a1076c3ac2a43c1adb58fc09aef369059e1ca9f',
                               5,
                               0.0],
                              [7,
                               632.283740940996,
                               'POINT (21.116339804463358 55.55515396480657)',
                               'sha256:e9e74e2b686f5b88c5d1c208a8df9e5f28bede90977c3aaa5f01eb8f5771c517',
                               5,
                               0.0],
                              [8,
                               466.73151656357913,
                               'POINT (93.81454749057481 70.61880803017002)',
                               'sha256:b6275913d6ec057b6b4fe3c0d0d378331f607f318bd1ab7404290a3ba7327ead',
                               5,
                               0.0],
                              [9,
                               490.2795181188203,
                               'POINT (93.90090039460057 70.05770762363186)',
                               'sha256:3f5d49c1fe9e3bfb5106d66a9edc82e44c74678d2eaf649a00bdd513cdb313e4',
                               5,
                               0.0],
                              [10,
                               618.6029679049165,
                               'POINT (52.4745837442633 50.27658072386516)',
                               'sha256:10ce2f8a803d777dcdf6fe3c92b4d50e4f21f232ba018d6884ae5af1c808bc1e',
                               5,
                               0.0],
                              [11,
                               1733.7528968167017,
                               'POINT (72.69758299176708 60.26444497004358)',
                               'sha256:ee60fa636b1a4d26b850b26dbdef4946d436863ffbde4f5d4d1b55f8c5e1515b',
                               5,
                               0.0],
                              [12,
                               6.044560167997588,
                               'POINT (78.850605241402 58.87728933535582)',
                               'sha256:145c94d8a014b23aff8920ff2f240612d6d2d2c612905c9425fdc59d49a4d266',
                               36,
                               0.0],
                              [13,
                               9.80157401936691,
                               'POINT (90.13319120839164 11.502690835465943)',
                               'sha256:b01b207636330b2dc48c000bcf625bf96990453ec2fdb837783b2da07230105e',
                               54,
                               0.0]],
                     'types': ['INTEGER',
                               'DOUBLE',
                               'VARCHAR',
                               'VARCHAR',
                               'BIGINT',
                               'DOUBLE']},
             'G5': {'counters': [0, 0, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [[716, 67809057.76828691]],
                    'types': ['BIGINT', 'DOUBLE']}}}

#: presto_tpu's records of M over the SF1 tables, `models` holding its M1
#: blobs (`... torch_geo_ml_common ml 1 <cache dir>`)
ML_REFERENCE_SF1 = {'auto': {'M1': {},
          'M2': {'counters': [0, 1, 0, 0, 0, 0, 0],
                 'memo': ['executable'],
                 'mode': 'compiled'},
          'M3': {}},
 'compiled': {'M1': {'counters': None,
                     'error': ['StaticFallback',
                               'learn_classifier is dynamic-mode only'],
                     'mode': None,
                     'rows': None,
                     'types': None},
              'M2': {'counters': [0, 1, 0, 0, 0, 0, 0],
                     'memo': ['executable'],
                     'mode': 'compiled'},
              'M3': {'counters': None,
                     'error': ['StaticFallback',
                               'classification_precision is dynamic-mode '
                               'only'],
                     'mode': None,
                     'rows': None,
                     'types': None}},
 'dynamic': {'M1': {'blobs': ['{"kind": "classifier", "w": '
                              '[[-0.0003877704384208751, '
                              '-0.00020116173028195282, '
                              '0.0005889321687028284], [-0.20194721391230613, '
                              '0.006697983256426921, 0.19524923065587882], '
                              '[-0.14773319708175453, 0.03890726489499709, '
                              '0.10882593218675739], [-0.0032340203073194865, '
                              '0.006509029823135724, '
                              '-0.0032750095158162375]], "b": '
                              '[3.8353964187338416, -7.652976952914942, '
                              '3.8175805341810802], "classes": ["A", "N", '
                              '"R"]}',
                              '{"kind": "regressor", "w": '
                              '[0.13539226820848074, -2.489238585681414, '
                              '0.011915871970709981], "b": '
                              '25.559931663588085, "classes": null}'],
                    'counters': [0, 0, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [['sha256:e5b3451cfce32d5fcf6c511d1569d65fd1716269a3ee5c0472dfacde0a573a5d',
                              'sha256:f78385347aec17ecffd5e205d47d173f04756d5dc01e068cd94cc6d3d86354b3']],
                    'types': ['VARBINARY', 'VARBINARY']},
             'M2': {'counters': [2, 1, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [['A', 895560, 22854546.38133794],
                             ['N', 3185506, 81239587.72421834],
                             ['R', 1919535, 48938528.328013554]],
                    'types': ['VARCHAR', 'BIGINT', 'DOUBLE']},
             'M3': {'counters': [0, 0, 0, 0, 0, 0, 0],
                    'error': None,
                    'memo': [],
                    'mode': 'dynamic',
                    'rows': [[[0.24957133460465045,
                               0.249576132721271,
                               0.2495191058708174,
                               0.24943863458340776,
                               0.24936738721034318,
                               0.24937580448980914,
                               0.24937919583676188,
                               0.2494892361502567,
                               0.24931335128557255,
                               0.24899632275399133],
                              [1.0,
                               0.9093109006676113,
                               0.8183607130980823,
                               0.7272302344185078,
                               0.6359955875420178,
                               0.5451535746385163,
                               0.45412258994189286,
                               0.36351495548145074,
                               0.2725133515583162,
                               0.09065571208978765],
                              [0.0,
                               0.1,
                               0.2,
                               0.3,
                               0.4,
                               0.5,
                               0.6,
                               0.7,
                               0.8,
                               0.9],
                              'sha256:88b4266914171c43490c297ee687162f724e93eac1a5373bb9695335d1a9b055']],
                    'types': ['ARRAY(DOUBLE)',
                              'ARRAY(DOUBLE)',
                              'ARRAY(DOUBLE)',
                              'VARCHAR']}}}


REFERENCE_COUNTERS = {SF: REFERENCE_COUNTERS_SF1, DS_CPU_CHECK_SF: {}}
REFERENCE_MEMO = {SF: REFERENCE_MEMO_SF1, DS_CPU_CHECK_SF: {}}
for _sf, _refs in ((SF, DS_REFERENCE_SF1),
                   (DS_CPU_CHECK_SF, DS_REFERENCE_SF01)):
    REFERENCE_COUNTERS[_sf].update({
        f"ds{q}": {"dynamic": v["dynamic"], "compiled": v["compiled"]}
        for q, v in _refs.items()})
    REFERENCE_MEMO[_sf].update({f"ds{q}": v["memo"][0] if v["memo"] else None
                                for q, v in _refs.items()})


def ds_scales(qid) -> tuple:
    """The scale factors the card runs a TPC-DS query at, in order: SF1,
    then SF0.1 where presto_tpu's values are at SF0.1 alone, or SF0.1
    alone where presto_tpu raises at SF1.  Counters and memo are held at
    each scale where presto_tpu's values are (REFERENCE_COUNTERS)."""
    if qid in DS_RAISES_AT_SF1:
        return (DS_CPU_CHECK_SF,)
    if qid in DS_REFERENCE_SF01:
        return (SF, DS_CPU_CHECK_SF)
    return (SF,)


# every TPC-DS query is held to presto_tpu's values at its last scale
assert all(f"ds{q}" in REFERENCE_COUNTERS[ds_scales(q)[-1]]
           for q in DS_QUERIES)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3, ahead: bool = False) -> float:
    """Mean device time of fn() over `iters` back-to-back calls, by CUDA
    events: where a call's host side outlasts its kernels, the host's
    share is in it.  `ahead`: see card_ms."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if ahead:
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_ms(fn, iters: int) -> float:
    """Mean time of fn() over `iters` calls on the card alone: the card
    first sleeps while the host queues the calls, so the events time its
    work without the host's gaps."""
    return cuda_ms(fn, iters, ahead=True)


def phase_build():
    from presto_tpu_torch.exec import cuda_build

    names = ["fused_group_sums", "block_gather"]
    t0 = time.perf_counter()
    cuda_build.build_all(names)
    row = {"phase": "build", "seconds": time.perf_counter() - t0,
           "fgs_template_bounds": check_fgs_bounds(),
           "bg_bounds": check_bg_bounds()}
    for name in names:
        info = cuda_build.build_info.get(name, {})
        row[name] = {"nvcc_seconds": info.get("seconds"), "ptxas": [
            ln.strip() for ln in info.get("log", "").splitlines()
            if "registers" in ln or "Compiling entry" in ln
            or "spill" in ln],
            "sass_atomics": sass_atomics(cuda_build.library_path(name))}
    emit(row)


def check_fgs_bounds():
    """The launch plan's limits against the compile-time bounds of
    csrc/fused_group_sums.cu (threads a block, register-path rows a
    slice at each group-slot count): they must agree, or a plan would
    not fit its template.  Returns {group slots: rows a slice}."""
    import ctypes

    from presto_tpu_torch.exec import cuda_build
    from presto_tpu_torch.exec import kernels as K

    lib = cuda_build.load("fused_group_sums")
    out = {}
    slots = 1
    while slots <= K._FGS_REGISTER_GROUPS:
        threads, rows = ctypes.c_int(), ctypes.c_int()
        lib.fused_group_sums_bounds(slots, ctypes.byref(threads),
                                    ctypes.byref(rows))
        if (threads.value, rows.value) != (
                K._FGS_THREADS, K.fgs_register_slice_rows(slots)):
            raise AssertionError(
                f"fused_group_sums at {slots} group slots: the source's "
                f"bounds (threads {threads.value}, rows {rows.value}) differ "
                f"from the launch plan's (threads {K._FGS_THREADS}, rows "
                f"{K.fgs_register_slice_rows(slots)})")
        out[slots] = rows.value
        slots *= 2
    return out


def check_bg_bounds():
    """The launch plan's constants against the compile-time bounds of
    csrc/block_gather.cu (threads a block, indices a tile, ring stages,
    the residency its register bound allows, a block's most shared
    memory): they must agree, or the kernel would refuse every plan."""
    import ctypes

    from presto_tpu_torch.exec import cuda_build
    from presto_tpu_torch.exec import gather as G

    lib = cuda_build.load("block_gather")
    vals = [ctypes.c_int() for _ in range(5)]
    lib.block_gather_bounds(*[ctypes.byref(v) for v in vals])
    source = dict(zip(("threads", "tile", "stages", "blocks_per_sm",
                       "max_smem"), (v.value for v in vals)))
    plan = {"threads": G._BG_THREADS, "tile": G._BG_TILE,
            "stages": G._BG_STAGES,
            "blocks_per_sm": G._BG_MAX_BLOCKS_PER_SM,
            "max_smem": G._BG_SMEM_PER_BLOCK}
    if source != plan:
        raise AssertionError(f"block_gather: the source's bounds {source} "
                             f"differ from the launch plan's {plan}")
    return source


def sass_atomics(lib):
    """{kernel: sorted atomic opcodes} in the library's SASS, from
    cuobjdump: shows whether an f64 atomicAdd on shared memory is one
    instruction or a compare-and-swap loop."""
    from presto_tpu_torch.exec import cuda_build

    tool = os.path.join(os.path.dirname(cuda_build.nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return "not measured: no cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    out, kernel = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            kernel = ln.split("Function :")[1].strip()
            out[kernel] = set()
        elif kernel is not None:
            for word in ln.replace(";", " ").split():
                if word.startswith(("ATOM", "RED")):
                    out[kernel].add(word)
    return {kern: sorted(ops) for kern, ops in out.items()}


def fgs_inputs(k, n, G, offset, seed, dtype=None):
    """vals [k, n] (f64, or `dtype`) whose first element sits `offset`
    elements into its buffer (a contiguous view), and gid [n], from a
    seeded generator."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.rand((k * n + offset,), dtype=dtype or torch.float64,
                     device="cuda", generator=g) * 1e4
    vals = buf[offset:].view(k, n)
    gid = torch.randint(0, G, (n,), dtype=torch.int32, device="cuda",
                        generator=g)
    return vals, gid


def fgs_bound(k, n, G, elem_bytes=8):
    """(ms, what bounds it): the least time for the function, reading
    vals (elem_bytes a value: 8 for f64, 4 for f32) and gid once and
    writing the [k, G] f64 result once, with one f64 add per value."""
    byte_s = (k * n * elem_bytes + n * 4 + k * G * 8) / HBM_BYTES_PER_S
    op_s = k * n / F64_FLOPS
    return max(byte_s, op_s) * 1e3, "bytes" if byte_s >= op_s else \
        "operations"


def rel_err(x, ref, rtol, scale=None):
    """(max abs error, max relative error, every error within rtol of
    the scale) of x against ref, the scale |ref| unless given."""
    import torch

    err = (x - ref).abs()
    if not err.numel():
        return 0.0, 0.0, True
    scale = ref.abs() if scale is None else scale
    return (float(err.max()),
            float((err / scale.clamp_min(1e-300)).max()),
            bool(torch.all(err <= rtol * scale)))


def fgs_check(vals, gid, G, sm):
    """fused_group_sums on one input: its launch plan, its error against
    the plain version, the kernel's and the plain version's errors
    against the correctly rounded sums (each relative to the group's
    sum of |x|), whether FGS_REPEATS launches agree bit for bit, and
    (n > 0) its time beside the plain version, index_add_ and the
    bound."""
    import torch

    from presto_tpu_torch.exec import kernels as K

    k, n = vals.shape
    plan = K.fused_group_sums_launch_shape(n, k, G, sm, vals.element_size())
    out = K.fused_group_sums_cuda(vals, gid, G)
    plain = K.fused_group_sums_plain(vals, gid, G)
    same = all(torch.equal(out, K.fused_group_sums_cuda(vals, gid, G))
               for _ in range(FGS_REPEATS - 1))
    torch.cuda.synchronize()
    scale = K.fused_group_sums_plain(vals.abs(), gid, G)
    max_abs, max_rel, ok = rel_err(out, plain, KERNEL_RTOL, scale)
    exact = torch.from_numpy(exact_group_sums(vals, gid, G)).cuda()
    vs_exact = {name: rel_err(x, exact, EXACT_RTOL, scale)
                for name, x in (("kernel", out), ("plain", plain))}
    row = {"k": k, "n": n, "groups": G, "dtype": str(vals.dtype)[6:],
           "entry": ("fused_group_sums_f32in"
                     if vals.dtype == torch.float32
                     else "fused_group_sums_f64"), "path": plan.path,
           "plan": plan._asdict(), "max_abs_err": max_abs,
           "max_rel_err": max_rel, "ok": ok,
           "max_rel_err_vs_exact": {name: e[1]
                                    for name, e in vs_exact.items()},
           f"bit_identical_in_{FGS_REPEATS}": same,
           # the register path has no atomics; the shared-table path adds
           # with shared-memory atomics, whose order the card chooses
           "deterministic": plan.path == "registers"}
    if n:
        iters = 20 if n > 100_000 else 200

        def library():
            # index_add_ adds into the f64 table only from f64 values
            return torch.zeros((k, G), dtype=torch.float64,
                               device="cuda").index_add_(
                1, gid, vals if vals.dtype == torch.float64
                else vals.double())

        row["ms"] = cuda_ms(lambda: K.fused_group_sums_cuda(vals, gid, G), iters)
        row["plain_ms"] = cuda_ms(
            lambda: K.fused_group_sums_plain(vals, gid, G), iters)
        row["library_ms"] = cuda_ms(library, iters)
        row["bound_ms"], row["bound_by"] = fgs_bound(k, n, G,
                                                     vals.element_size())
        row["roofline_share"] = row["bound_ms"] / row["ms"]
    if not ok:
        raise AssertionError(
            f"fused_group_sums disagrees with its plain version at "
            f"k={k} n={n} G={G}: max err {max_rel} of the sum of |x|")
    for name in ("kernel", "plain"):
        _, rel, within = vs_exact[name]
        if not within:
            raise AssertionError(
                f"fused_group_sums' {name} version is {rel} of the sum "
                f"of |x| off the correctly rounded sums at k={k} n={n} "
                f"G={G}, beyond {EXACT_RTOL}")
    if row["deterministic"] and not same:
        raise AssertionError(
            f"fused_group_sums' register path gave different bits in "
            f"{FGS_REPEATS} launches at k={k} n={n} G={G}")
    return row


def phase_kernel():
    import torch

    rows = []
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [(s, torch.float64) for s in FGS_SHAPES] \
        + [(s, torch.float32) for s in FGS_SHAPES_F32]
    for i, ((k, n, G, offset), dtype) in enumerate(shapes):
        vals, gid = fgs_inputs(k, n, G, offset, seed=i, dtype=dtype)
        row = fgs_check(vals, gid, G, sm)
        row["offset"] = offset
        emit({"phase": "kernel", "name": "fused_group_sums", **row})
        rows.append(row)
        del vals, gid
    return rows


def bg_inputs(n, w, m, how, seed):
    """A (n, w) int32 word matrix and m ascending int32 indices drawn
    from a seeded generator."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    src = torch.randint(-2**31, 2**31 - 1, (n, w), dtype=torch.int32,
                        device="cuda", generator=g)
    if how == "skewed":
        half = m // 2
        dense = torch.randint(0, n // 8, (half,), device="cuda", generator=g)
        sparse = torch.randint(n // 8, n, (m - half,), device="cuda",
                               generator=g)
        idx = torch.cat([dense, sparse])
    else:
        idx = torch.randint(0, n, (m,), device="cuda", generator=g)
    return src, torch.sort(idx.to(torch.int32)).values


def bg_bound(n, w, m, distinct):
    """(ms, what bounds it): read the m indices, write m x w words, and
    read each source row this input needs once (`distinct` rows)."""
    byte_s = (m * 4 + m * w * 4 + min(n, distinct) * w * 4) / HBM_BYTES_PER_S
    return byte_s * 1e3, "bytes"


def source_sectors(sidx, w):
    """The 32-byte sectors of a (n, w) word matrix that the sorted rows
    sidx touch: the least the card can read of the source, since device
    memory moves whole sectors."""
    import torch

    first = sidx.long() * (4 * w) // 32
    last = ((sidx.long() + 1) * (4 * w) - 1) // 32
    prev = torch.cat([last.new_full((1,), -1), last[:-1]])
    return int((last - torch.maximum(first, prev + 1) + 1).clamp_min(0)
               .sum())


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def expected_staged_tiles(sidx, n, w, stage_bytes):
    """The tiles of sorted indices that go through the ring at this
    stage size by the plan's own window arithmetic (G.copy_window,
    G.tile_staged), which the kernel's staged_blocks count must equal."""
    from presto_tpu_torch.exec import gather as G

    m = sidx.shape[0]
    if not m:
        return 0
    lo = sidx[::G._BG_TILE].tolist()
    hi = sidx[G._BG_TILE - 1::G._BG_TILE].tolist()
    if len(hi) < len(lo):
        hi.append(int(sidx[-1]))
    return sum(G.tile_staged(G.copy_window(a, b, w, n), stage_bytes)
               for a, b in zip(lo, hi))


def check_staged_count(what, staged, expected):
    if staged != expected:
        raise AssertionError(f"block_gather {what}: {staged} tiles went "
                             f"through the ring, the plan's window "
                             f"arithmetic says {expected}")


def bg_check(src, sidx):
    """block_gather on one input: byte-identical to its plain version,
    its launch plan and the share of its tiles that went through the
    TMA ring (and that the reference's window check would have let
    through), and (m > 0) its time beside the plain version and
    index_select (kernel and index_select in turns, the median of
    BG_TURNS each, back-to-back and on the card alone), the byte bound,
    the bound at sector granularity and the time at each stage size
    (sweep_stage_bytes).  Raises when it differs, or when its count of
    tiles through the ring differs from the plan's arithmetic."""
    import torch

    from presto_tpu_torch.exec import gather as G

    (n, w), m = src.shape, sidx.shape[0]
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    staged = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = G.block_gather_cuda(src, sidx, staged_blocks=staged)
    plain = G.block_gather_plain(src, sidx)
    torch.cuda.synchronize()
    ok = out.shape == plain.shape and torch.equal(out, plain)
    tiles = -(-m // G._BG_TILE)
    ib = G._IB
    # the share of blocks whose indices the reference's aligned window
    # (presto_tpu/exec/gather.py:218-220) would have covered; the
    # reference runs its kernel only when all are
    W = G.window_rows(n, m)
    covered = None
    if W is not None and m >= ib:
        padded = torch.cat([sidx, sidx[-1:].expand((-m) % ib)])
        first, last = padded[::ib] // W, padded[ib - 1::ib]
        covered = float((last < (first + 1) * W).float().mean())
    plan = G.block_gather_launch_shape(n, w, m, sm)
    check_staged_count(f"at n={n} w={w} m={m}", int(staged),
                       expected_staged_tiles(sidx, n, w, plan.stage_bytes))
    row = {"n": n, "w": w, "m": m, "byte_identical": ok,
           "max_abs_err": 0.0 if ok else float("nan"),
           "plan": plan._asdict(), "tiles": tiles,
           "staged_tile_share": int(staged) / tiles if tiles else None,
           "reference_window_rows": W,
           "reference_covered_block_share": covered}
    if m:
        distinct = int(torch.unique_consecutive(sidx).numel())
        iters = 20 if m > 100_000 else 200
        turns = {"ms": [], "library_ms": [], "card_ms": [],
                 "library_card_ms": []}
        for _ in range(BG_TURNS):
            for key, timing, fn in (
                    ("ms", cuda_ms, lambda: G.block_gather_cuda(src, sidx)),
                    ("library_ms", cuda_ms,
                     lambda: torch.index_select(src, 0, sidx.long())),
                    ("card_ms", card_ms,
                     lambda: G.block_gather_cuda(src, sidx)),
                    ("library_card_ms", card_ms,
                     lambda: torch.index_select(src, 0, sidx.long()))):
                turns[key].append(timing(fn, iters))
        for key, times in turns.items():
            row[key] = median(times)
            row[key + "_turns"] = times
        row["plain_ms"] = cuda_ms(
            lambda: G.block_gather_plain(src, sidx), iters)
        # the one PyTorch call for this function is index_select,
        # which is also the plain version's call
        row["library_call"] = "torch.index_select (= the plain version)"
        row["bound_ms"], row["bound_by"] = bg_bound(n, w, m, distinct)
        row["roofline_share"] = row["bound_ms"] / row["ms"]
        row["card_share"] = row["bound_ms"] / row["card_ms"]
        sectors = source_sectors(sidx, w)
        row["source_sectors"] = sectors
        row["sector_bound_ms"] = (m * 4 + m * w * 4 + sectors * 32) \
            / HBM_BYTES_PER_S * 1e3
        row["sector_share"] = row["sector_bound_ms"] / row["ms"]
        row["card_sector_share"] = row["sector_bound_ms"] / row["card_ms"]
        row["by_stage_bytes"] = sweep_stage_bytes(src, sidx, iters)
    if not ok:
        raise AssertionError(f"block_gather differs from its plain version "
                             f"at n={n} w={w} m={m}")
    return row


def phase_block_gather():
    rows = []
    for i, (name, n, w, m, how) in enumerate(BG_SHAPES):
        src, sidx = bg_inputs(n, w, m, how, seed=100 + i)
        row = {"shape": name, **bg_check(src, sidx)}
        emit({"phase": "kernel", "name": "block_gather", **row})
        rows.append(row)
        del src, sidx
    phase_unaligned_source()
    phase_take_rows_routes()
    phase_copy_rate()
    return rows


def phase_unaligned_source():
    """The kernel's TMA copies need a source on a 16-byte boundary: the
    wrapper must refuse one 4 bytes past it, and launch nothing."""
    import torch

    from presto_tpu_torch.exec import gather as G

    buf = torch.zeros((4 * 1000 + 1,), dtype=torch.int32, device="cuda")
    src = buf[1:].view(1000, 4)
    sidx = torch.arange(1000, dtype=torch.int32, device="cuda")
    before = G.block_gather_cuda.launches
    try:
        G.block_gather_cuda(src, sidx)
    except ValueError as e:
        refused = str(e)
    else:
        refused = None
    emit({"phase": "unaligned_source", "address_mod_16":
          src.data_ptr() % 16, "refused": refused})
    if refused is None or G.block_gather_cuda.launches != before:
        raise AssertionError("block_gather launched on a source off a "
                             "16-byte boundary")


def phase_copy_rate():
    """What the card moves in practice: one device-to-device copy_ of
    Q3's gather output (6,000,601 x 12 words, 288 MB) into another
    buffer, against the same byte bound (read once, write once)."""
    import torch

    _, n, w, m, _ = BG_SHAPES[0]
    a = torch.empty((m, w), dtype=torch.int32, device="cuda")
    b = torch.empty_like(a)
    ms = cuda_ms(lambda: b.copy_(a), 20)
    bound = 2 * a.numel() * 4 / HBM_BYTES_PER_S * 1e3
    emit({"phase": "copy_rate", "bytes": a.numel() * 4, "ms": ms,
          "bound_ms": bound, "roofline_share": bound / ms})


def sweep_stage_bytes(src, sidx, iters):
    """block_gather's time on the card alone (card_ms), residency and
    staged-tile share at the plan's stage size, at each of
    STAGE_SWEEP_FIXED and at the largest stage of each residency in
    STAGE_SWEEP_RESIDENCIES, on one input; each launch is checked byte
    for byte against the plain version, and its count of tiles through
    the ring against the plan's arithmetic."""
    import torch

    from presto_tpu_torch.exec import gather as G

    (n, w), m = src.shape, sidx.shape[0]
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = G.block_gather_launch_shape(n, w, m, sm).stage_bytes
    plain = G.block_gather_plain(src, sidx)
    tiles = -(-m // G._BG_TILE)
    out = {}
    for stage in sorted({chosen, *STAGE_SWEEP_FIXED, *(
            G.bg_stage_cap(r) for r in STAGE_SWEEP_RESIDENCIES)}):
        plan = G.block_gather_plan_at(n, w, m, sm, stage)
        staged = torch.zeros(1, dtype=torch.int32, device="cuda")
        dst = torch.empty_like(plain)
        G.launch_block_gather(src, sidx, plan, dst, staged)
        if not torch.equal(dst, plain):
            raise AssertionError(f"block_gather with {plan} differs from "
                                 f"its plain version at n={n} w={w} m={m}")
        check_staged_count(f"with {plan} at n={n} w={w} m={m}",
                           int(staged),
                           expected_staged_tiles(sidx, n, w, stage))
        out[stage] = {
            "card_ms": card_ms(lambda: G.launch_block_gather(
                src, sidx, plan, dst), iters),
            "blocks_per_sm": plan.blocks_per_sm,
            "staged_tile_share": int(staged) / tiles,
            "plan_choice": stage == chosen}
    return out


def phase_take_rows_routes():
    """At Q3's shape, the whole staged take_rows (sort, kernel, way home)
    against the flat take_rows on the same request-order indices: does
    the staged route pay on this card?"""
    import torch

    from presto_tpu_torch.exec import gather as G
    from presto_tpu_torch.exec import kernels as K

    _, n, w, m, _ = BG_SHAPES[0]
    g = torch.Generator(device="cuda").manual_seed(7)
    # 12 words: five i64 columns, one i32 and one bool
    arrays = [torch.randint(-2**62, 2**62, (n,), device="cuda", generator=g)
              for _ in range(5)]
    arrays.append(torch.randint(0, 10**6, (n,), dtype=torch.int32,
                                device="cuda", generator=g))
    arrays.append(torch.rand((n,), device="cuda", generator=g) < 0.5)
    idx = torch.randint(0, n, (m,), dtype=torch.int32, device="cuda",
                        generator=g)
    # the flat route on the card: staging switched off for this phase
    real = G._staging_enabled
    times = {}
    results = {}
    try:
        for route, staging in (("staged", real), ("flat", lambda d: False)):
            G._staging_enabled = staging
            results[route] = K.take_rows(arrays, idx)
            times[route] = cuda_ms(lambda: K.take_rows(arrays, idx), 10)
    finally:
        G._staging_enabled = real
    same = all(torch.equal(a, b) for a, b in zip(results["staged"],
                                                  results["flat"]))
    emit({"phase": "take_rows_routes", "n": n, "words": w, "m": m,
          "index_order": "request order, uniform random",
          "staged_ms": times["staged"], "flat_ms": times["flat"],
          "identical": same})
    if not same:
        raise AssertionError("staged and flat take_rows differ at Q3's shape")


# ---- the slice: Q1, Q6, Q3 and Q18 through connect().sql() -------------------


def _days(s: str) -> int:
    import numpy as np

    return int((np.datetime64(s, "D") - np.datetime64("1970-01-01", "D"))
               / np.timedelta64(1, "D"))


def numpy_q1(cols):
    """TPC-H Q1 straight from the generated columns."""
    import numpy as np

    live = cols["l_shipdate"] <= _days("1998-12-01") - 90
    rf = cols["l_returnflag"][live].astype(str)
    ls = cols["l_linestatus"][live].astype(str)
    keys, gid = np.unique(np.char.add(rf, ls), return_inverse=True)
    qty = cols["l_quantity"][live]
    price = cols["l_extendedprice"][live]
    disc = cols["l_discount"][live]
    tax = cols["l_tax"][live]
    cnt = np.bincount(gid, minlength=len(keys))

    def s(x):
        return np.bincount(gid, weights=x, minlength=len(keys))

    disc_price = price * (1 - disc)
    out = []
    for g, key in enumerate(keys):
        out.append((key[0], key[1], s(qty)[g], s(price)[g],
                    s(disc_price)[g], s(disc_price * (1 + tax))[g],
                    s(qty)[g] / cnt[g], s(price)[g] / cnt[g],
                    s(disc)[g] / cnt[g], int(cnt[g])))
    return out


def numpy_q6(cols):
    lo, hi = _days("1994-01-01"), _days("1995-01-01")
    d = cols["l_discount"]
    live = ((cols["l_shipdate"] >= lo) & (cols["l_shipdate"] < hi)
            & (d >= 0.05) & (d <= 0.07) & (cols["l_quantity"] < 24))
    return [(float((cols["l_extendedprice"][live] * d[live]).sum()),)]


def _top(rows, n, key):
    return sorted(rows, key=key)[:n]


def numpy_q3(c, o, li):
    """TPC-H Q3: BUILDING customers' orders before 1995-03-15, their
    lines shipped after it, revenue per order, top 10."""
    import numpy as np

    day = _days("1995-03-15")
    cust = c["c_custkey"][c["c_mktsegment"].astype(str) == "BUILDING"]
    live_o = (o["o_orderdate"] < day) & np.isin(o["o_custkey"], cust)
    okeys = o["o_orderkey"][live_o]
    odate = o["o_orderdate"][live_o]
    oprio = o["o_shippriority"][live_o]
    sorter = np.argsort(okeys)
    lk = li["l_orderkey"]
    pos = np.clip(np.searchsorted(okeys, lk, sorter=sorter), 0,
                  len(okeys) - 1)
    hit = (okeys[sorter][pos] == lk) & (li["l_shipdate"] > day)
    row = sorter[pos[hit]]
    rev = li["l_extendedprice"][hit] * (1 - li["l_discount"][hit])
    groups, gid = np.unique(row, return_inverse=True)
    total = np.bincount(gid, weights=rev)
    out = [(int(okeys[r]), float(total[g]), int(odate[r]), int(oprio[r]))
           for g, r in enumerate(groups)]
    return _top(out, 10, lambda t: (-t[1], t[2]))


def numpy_q18(c, o, li):
    """TPC-H Q18: orders whose lines sum to more than 300 units, with
    their customer, top 100 by total price."""
    import numpy as np

    keys, gid = np.unique(li["l_orderkey"], return_inverse=True)
    qty = np.bincount(gid, weights=li["l_quantity"])
    big = keys[qty > 300]
    sorter = np.argsort(o["o_orderkey"])
    orow = sorter[np.searchsorted(o["o_orderkey"], big, sorter=sorter)]
    csort = np.argsort(c["c_custkey"])
    crow = csort[np.searchsorted(c["c_custkey"], o["o_custkey"][orow],
                                 sorter=csort)]
    out = [(str(c["c_name"][cr]), int(c["c_custkey"][cr]),
            int(o["o_orderkey"][r]), int(o["o_orderdate"][r]),
            float(o["o_totalprice"][r]), float(q))
           for r, cr, q in zip(orow, crow, qty[qty > 300])]
    return _top(out, 100, lambda t: (-t[4], t[3]))


def values_agree(a, b, abs_tol=0.0) -> bool:
    """Floats within QUERY_RTOL (or abs_tol), everything else equal."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or math.isclose(a, b, rel_tol=QUERY_RTOL,
                                      abs_tol=abs_tol)
    return a == b


def rows_agree(ra, rb, abs_tol=0.0) -> bool:
    return len(ra) == len(rb) and all(values_agree(a, b, abs_tol)
                                      for a, b in zip(ra, rb))


def unmatched(actual, expected, abs_tol=0.0):
    """The expected rows that no distinct actual row agrees with."""
    left = list(actual)
    missing = []
    for r in expected:
        i = next((i for i, a in enumerate(left)
                  if rows_agree(a, r, abs_tol)), None)
        if i is None:
            missing.append(r)
        else:
            del left[i]
    return missing


def in_order(ka, kb, dirs) -> bool:
    """Sort key ka comes before kb (or ties with it) under dirs.  NULL
    sorts last ascending and first descending (the defaults)."""
    for a, b, d in zip(ka, kb, dirs):
        if values_agree(a, b):
            continue
        if a is None or b is None:
            return (b is None) if d > 0 else (a is None)
        return (a < b) if d > 0 else (a > b)
    return True


def label(qid) -> str:
    """Q<number> for a TPC-H query, the name for a relational one."""
    return f"Q{qid}" if isinstance(qid, int) else qid


def assert_query_rows(what, qid, actual, expected, abs_tol=0.0):
    """Rows of one query against expected rows, tie-aware: consecutive
    expected rows whose ORDER BY keys agree within QUERY_RTOL form one
    group, which the actual rows at the same places must match as a
    multiset with the same key; at a LIMIT, the rows that tie with the
    last kept row may differ (only their key is held).  A query without
    ORDER BY is one multiset.  Floats agree within QUERY_RTOL, or within
    abs_tol where a query's sums are prefix-sum differences."""
    if len(actual) != len(expected):
        raise AssertionError(f"{what}: {len(actual)} rows, expected "
                             f"{len(expected)}")
    spec = ORDER_KEYS.get(qid)
    if spec is None:
        missing = unmatched(actual, expected, abs_tol)
        if missing:
            raise AssertionError(f"{what}: no row agrees with {missing[:3]}")
        return
    cols, dirs = [c for c, _ in spec], [d for _, d in spec]

    def key(r):
        return [r[c] for c in cols]

    groups, lo = [], 0
    for i in range(1, len(expected) + 1):
        if i == len(expected) or not rows_agree(key(expected[i]),
                                                key(expected[lo])):
            groups.append((lo, i))
            lo = i
    cut = LIMITS.get(qid) == len(expected)
    for gi, (lo, hi) in enumerate(groups):
        head = key(expected[lo])
        if gi and not in_order(key(expected[lo - 1]), head, dirs):
            raise AssertionError(f"{what}: expected rows {lo - 1} and {lo} "
                                 f"are not in ORDER BY order {spec}")
        for r in actual[lo:hi]:
            if not rows_agree(key(r), head):
                raise AssertionError(f"{what}: row {r} at {lo}..{hi - 1} "
                                     f"has not the sort key {head}")
        if cut and gi == len(groups) - 1:
            continue  # ties with the last kept row may be other rows
        missing = unmatched(actual[lo:hi], expected[lo:hi], abs_tol)
        if missing:
            raise AssertionError(f"{what}: rows {lo}..{hi - 1}: no row "
                                 f"agrees with {missing[:3]}")


FAILED = []


def fail(phase, query, error, tb=()):
    """Report a failed phase: one JSON line naming the phase, the query,
    the error and its traceback's tail, to stdout and stderr."""
    line = json.dumps({"phase": phase, "query": query, "ok": False,
                       "error": error[:2000], "traceback": list(tb)[-14:]})
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)
    FAILED.append(phase if query is None else f"{phase} {query}")


def guarded(phase, query, fn, *args):
    """Run one phase; if it raises, report it (fail) and return None, so
    that the phases after it still run."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 -- every failure is reported
        fail(phase, query, f"{type(e).__name__}: {e}",
             "".join(traceback.format_exception(e)).splitlines())
        return None


class Capture:
    """Wraps the executor's calls of both kernels and of segment_sum for
    one run of a query (run).  At each (kernel, shape) not seen before it
    keeps a copy of the inputs (never while a CUDA graph is being
    captured, whose tensors hold nothing yet); check then holds the
    kernel against its plain version on that very input and times it
    (fgs_check, bg_check).  It notes the fused_group_sums paths the run
    takes, and in the dynamic executor keeps the largest float
    segment_sum input."""

    def __init__(self, sm):
        self.sm = sm
        # (k, n, G) or (k, n, G, "f32") -> (query, fgs_check row, mode)
        self.fgs_rows = {}
        self.bg_rows = {}  # (n, w, m) -> (query, bg_check row, mode)

    def run(self, session, qid, sql, mode):
        import torch

        from presto_tpu_torch.exec import gather as G
        from presto_tpu_torch.exec import kernels as K

        real = (K.fused_group_sums, G.block_gather, K.segment_sum)
        self.paths, self.seg, self.shapes = set(), None, []
        self.pending = pending = {}
        self.query, self.mode = label(qid), mode

        def fgs(vals, gid, n_groups):
            out = real[0](vals, gid, n_groups)
            # an f32-input launch is a shape of its own
            key = tuple(vals.shape) + (n_groups,) + (
                ("f32",) if vals.dtype == torch.float32 else ())
            self.paths.add(K.fused_group_sums_launch_shape(
                key[1], key[0], n_groups, self.sm,
                vals.element_size()).path)
            if torch.cuda.is_current_stream_capturing():
                return out
            self.shapes.append(("fused_group_sums", key))
            if key not in self.fgs_rows and ("fgs", key) not in pending:
                pending["fgs", key] = (vals.clone(), gid.clone(), n_groups)
            return out

        def bg(src, sidx):
            out = real[1](src, sidx)
            key = tuple(src.shape) + (sidx.shape[0],)
            if torch.cuda.is_current_stream_capturing():
                return out
            self.shapes.append(("block_gather", key))
            if key not in self.bg_rows and ("bg", key) not in pending:
                pending["bg", key] = (src.clone(), sidx.clone())
            return out

        def seg(x, gid, n_groups, order=None):
            if mode == "dynamic" and x.is_floating_point() and (
                    self.seg is None or x.shape[0] > self.seg[0].shape[0]):
                self.seg = (x.clone(), gid.clone(), n_groups)
            return real[2](x, gid, n_groups, order)

        K.fused_group_sums, G.block_gather, K.segment_sum = fgs, bg, seg
        try:
            result = session.sql(sql)
            torch.cuda.synchronize()
        finally:
            K.fused_group_sums, G.block_gather, K.segment_sum = real
        return result

    def check(self):
        """Each kernel against its plain version at the new shapes of the
        last run (its launches here are no launches of the main path)."""
        for (name, key), args in self.pending.items():
            if name == "fgs":
                row = fgs_check(*args, self.sm)
                self.fgs_rows[key] = (self.query, row, self.mode)
                name = "fused_group_sums"
            else:
                row = bg_check(*args)
                self.bg_rows[key] = (self.query, row, self.mode)
                name = "block_gather"
            emit({"phase": "kernel_at_query_shape", "query": self.query,
                  "mode": self.mode, "name": name, **row})
        self.pending = {}


def phase_query(qid, sql, sessions, capture, counters, out,
                n_runs=DYNAMIC_RUNS):
    """One query in the dynamic executor: n_runs runs on the card with
    every kernel's launch count set to 0 just before and read just
    after, one captured run (each kernel at each new shape, see Capture)
    where a kernel launched or the query's segment_sum input is checked
    (SEGMENT_SUM_QUERIES), then its rows: identical in every run where
    the query's f64 sums are deterministic by design, and agreeing with
    the port's CPU run (and, for Q1, Q3, Q6 and Q18, with numpy) under
    the tie-aware comparison."""
    import torch

    run_sf = out.get("sf", SF)
    gpu = sessions["dynamic", run_sf]
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, times, sorts = [], [], []
    for _ in range(n_runs):
        t = time.perf_counter()
        result = gpu.sql(sql)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        runs.append(result.rows)
        sorts.append(sort_counters(result.stats))
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = out["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    out["launches"] = launches
    out["dynamic_counters"] = sorts[0]
    if any(c != sorts[0] for c in sorts[1:]):
        raise AssertionError(f"{label(qid)}: counters differ between runs: "
                             f"{sorts}")
    if any(launches.values()) or qid in SEGMENT_SUM_QUERIES:
        capture.run(gpu, qid, sql, "dynamic")
        out["dynamic_kernel_shapes"] = capture.shapes
        capture.check()
        out["fgs_paths"] = sorted(capture.paths)
        if capture.seg is not None:
            out["segment_sum_input"] = capture.seg
    else:  # no kernel launched: the captured run would find no shape
        out["dynamic_kernel_shapes"], out["fgs_paths"] = [], []
    rows = runs[0]
    out["rows"], out["warm_ms"], out["cold_ms"] = rows, times[1:], times[0]
    out["dynamic_rows"] = rows
    identical = all(r == rows for r in runs[1:])
    # the register path of fused_group_sums, segment_sum and a window's
    # prefix sums add in a fixed order; the shared-table path adds with
    # atomics
    by_design = "shared_table" not in out["fgs_paths"]
    row = {"phase": "query", "query": label(qid), "sf": run_sf,
           "rows": len(rows),
           "cold_ms": times[0], "warm_ms": times[1:],
           f"launches_in_{n_runs}_runs": launches,
           "fgs_paths": out["fgs_paths"],
           "peak_device_bytes": peak,
           f"runs_identical_of_{n_runs}": identical,
           "identical_by_design": by_design}
    if by_design and not identical:
        raise AssertionError(
            f"{label(qid)}: the card's rows differ between runs")
    if "reference_rows" in out:  # frozen presto_tpu rows, not the CPU's
        out["reference_rows"](f"{label(qid)} dynamic on cuda", rows)
        row["matches_reference"] = f"presto_tpu at SF{run_sf}"
        emit(row)
        return
    sf = CPU_CHECK_SF[qid]
    t = time.perf_counter()
    on_cpu = sessions["cpu", sf].sql(sql)
    row["cpu_check_seconds"] = time.perf_counter() - t
    if out.get("cpu_runs_auto", True):
        # compiled mode on the card is then held to the CPU's too
        out["cpu_mode"] = on_cpu.stats.execution_mode
        out["cpu_memo"] = memo_entry(sessions["cpu", sf], sql)
    on_gpu = rows if sf == run_sf else sessions["dynamic", sf].sql(sql).rows
    assert_query_rows(f"{label(qid)} cuda vs cpu at SF{sf}", qid, on_gpu,
                      on_cpu.rows, out.get("abs_tol", {}).get(sf, 0.0))
    row["matches_cpu_at_sf"] = sf
    if qid in out.get("numpy", {}):
        assert_query_rows(f"{label(qid)} cuda vs numpy", qid, rows,
                          out["numpy"][qid])
    row["matches_numpy"] = qid in out.get("numpy", {}) or "not checked"
    emit(row)


def sort_counters(stats) -> list:
    """A QueryStats' counters of ordering-aware execution and dynamic
    filtering, in SORT_STATS_KEYS order."""
    from presto_tpu_torch.exec.executor import SORT_STATS_KEYS

    return [getattr(stats, k) for k in SORT_STATS_KEYS]


def phase_counters(qid, out):
    """The counters of the query's runs in both executors on the card
    against presto_tpu's at the runs' scale (REFERENCE_COUNTERS)."""
    sf = out.get("sf", SF)
    ref = REFERENCE_COUNTERS[sf].get(qid, {})
    row = {"phase": "counters", "query": label(qid), "sf": sf,
           "reference": ref}
    wrong = []
    for mode in ("dynamic", "compiled"):
        got = row[mode] = out.get(f"{mode}_counters")
        if got is None or got != ref.get(mode):
            wrong.append(f"{mode} {got} on cuda, {ref.get(mode)} in "
                         "presto_tpu")
    emit(row)
    if wrong:
        raise AssertionError(f"{label(qid)} counters: " + "; ".join(wrong))


def drop_memo(session) -> None:
    """Release every graph of a session's memo and give its pools back
    to the card."""
    import torch

    from presto_tpu_torch.exec import compile_cache as CC

    memo = getattr(session, "_compiled_cache", None)
    for entry in (memo.values() if memo is not None else ()):
        if isinstance(entry, tuple):
            entry[1].release()
    session._compiled_cache = CC.GraphMemo(0, 0)
    torch.cuda.empty_cache()


def phase_switched_off(qid, sql, sessions, out):
    """The query with ordering-aware execution and dynamic filtering
    switched off, both and each alone (SWITCHES_OFF), in both executors:
    DYNAMIC_RUNS dynamic runs, and a build with COMPILED_REPLAYS
    replays.  What is off may elide, memoize, trip or prune nothing
    (sorts_taken still counts the sorts run), and the rows must agree
    with the runs with both on (tie-aware, QUERY_RTOL).  The times of
    every variant are printed beside those with both on; nothing is
    claimed from them."""
    import torch

    row = {"phase": "switched_off", "query": label(qid), "sf": SF,
           "card": card_line(),
           "on": {"dynamic_warm_ms": out.get("warm_ms"),
                  "compiled_replay_ms": out.get("replay_ms")}}
    for variant, props in SWITCHES_OFF.items():
        got = row[variant] = {}
        zero = sorted({i for p in props for i in SWITCH_ZEROES[p]})
        for mode, runs_n in (("dynamic", DYNAMIC_RUNS),
                             ("compiled", 1 + COMPILED_REPLAYS)):
            session = sessions[variant, mode]
            results, times = [], []
            for _ in range(runs_n):
                t = time.perf_counter()
                results.append(session.sql(sql))
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            counts = got[f"{mode}_counters"] = sort_counters(
                results[0].stats)
            if any(counts[i] for i in zero):
                raise AssertionError(f"{label(qid)}: {mode} with {variant} "
                                     f"counts {counts}")
            on_rows = out.get(f"{mode}_rows")
            if on_rows is None:
                raise AssertionError(
                    f"{label(qid)}: no {mode} run with both on")
            assert_query_rows(f"{label(qid)} {mode} {variant} vs on", qid,
                              results[0].rows, on_rows)
            if mode == "dynamic":
                got["dynamic_warm_ms"] = times[1:]
            else:
                got.update({"compiled_first_run_ms": times[0],
                            "compiled_replay_ms": times[1:],
                            "compiled_memo": memo_entry(session, sql)})
                drop_memo(session)
        got["rows_match_on"] = True
    emit(row)


def memo_entry(session, sql):
    """The compiled-mode memo's entry for `sql`: "DYNAMIC", "executable"
    or None."""
    from presto_tpu_torch.exec.executor import query_cache_key

    entry = getattr(session, "_compiled_cache", {}).get(
        query_cache_key(session, sql))
    if entry is None or entry == "DYNAMIC":
        return entry
    return "executable"


def phase_compiled(qid, sql, sessions, capture, counters, out,
                   n_replays=COMPILED_REPLAYS, profile=True):
    """One query in compiled mode (the default) on the card: the first
    run builds it (compile_cache.build_graph: one eager static pass
    under torch's sync debug mode "error", then the capture of one CUDA
    graph, then a replay), with the kernels' launch counts set to 0 just
    before and read just after, each kernel held against its plain
    version at every shape not seen before (Capture, after the run);
    then n_replays replays, bit-identical wherever no captured
    launch took fused_group_sums' shared-table path, and equal to the
    card's dynamic run under the tie-aware comparison; the execution
    mode must be the port's CPU run's.  One more replay is profiled,
    and timed alone by CUDA events.  A capture failure raises here: it
    never falls back to the dynamic executor."""
    import torch

    from presto_tpu_torch.exec.executor import query_cache_key

    run_sf = out.get("sf", SF)
    gpu = sessions["compiled", run_sf]
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    first = capture.run(gpu, qid, sql, "compiled")
    first_ms = (time.perf_counter() - t) * 1e3
    entry = gpu._compiled_cache.get(query_cache_key(gpu, sql))
    launches = out["compiled_launches"] = {
        name: fn.launches for name, fn in counters.items()}
    paths = sorted(capture.paths)
    capture.check()
    exe = entry[1] if isinstance(entry, tuple) else None
    row = {"phase": "compiled", "query": label(qid), "sf": run_sf,
           "execution_mode": first.stats.execution_mode,
           "graph": exe is not None and exe.graph is not None,
           "memo": memo_entry(gpu, sql),
           "first_run_ms": first_ms, "fgs_paths": paths,
           "launches_in_build": launches,
           # every (kernel, shape) of the eager pass, which the graph
           # repeats: (k, n, G) and (n, w, m)
           "kernel_shapes": capture.shapes}
    if exe is not None:
        row.update({"eager_ms": exe.eager_ms, "capture_ms": exe.capture_ms,
                    "pool_bytes": exe.pool_bytes})
    if row["graph"]:
        # the build ran the static executor twice, eagerly and under
        # capture, and the replays launch what the capture recorded
        if any(n % 2 for n in launches.values()):
            raise AssertionError(f"{label(qid)}: odd launch counts {launches} "
                                 "in an eager pass and its capture")
        row["launches_per_graph"] = {name: n // 2
                                     for name, n in launches.items()}
    runs, times = [first.rows], []
    sorts = [sort_counters(first.stats)]
    for _ in range(n_replays):
        t = time.perf_counter()
        result = gpu.sql(sql)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        runs.append(result.rows)
        sorts.append(sort_counters(result.stats))
    # a memo hit reports the build's counters; after a tripped guard
    # the build reports its static pass and its dynamic rerun, and the
    # later runs the dynamic executor's alone
    out["compiled_counters"] = sorts[0]
    later = out.get("dynamic_counters") \
        if row["memo"] == "DYNAMIC" else sorts[0]
    if any(c != later for c in sorts[1:]):
        raise AssertionError(f"{label(qid)}: counters of the later runs "
                             f"{sorts[1:]}, {later} expected")
    out["compiled_rows"], out["replay_ms"] = runs[0], times
    row.update({"replay_ms": times, "replay_median_ms": median(times),
                "dynamic_warm_ms": out.get("warm_ms"),
                "replay_phase_ms": {k: v / 1e6 for k, v in
                                    gpu.last_stats.phase_ns.items()}})
    if exe is not None and exe.graph is not None:
        row["replays"] = exe.replays
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        exe.graph.replay()
        end.record()
        torch.cuda.synchronize()
        row["graph_device_ms"] = start.elapsed_time(end)
    if profile:
        row.update(profile_run(gpu, sql))
    identical = all(r == runs[0] for r in runs[1:])
    by_design = "shared_table" not in paths
    row.update({f"replays_identical_of_{n_replays + 1}": identical,
                "identical_by_design": by_design})
    if by_design and not identical:
        raise AssertionError(f"{label(qid)}: compiled replays differ")
    if "rows" in out:
        (out.get("compare_compiled") or assert_query_rows)(
            f"{label(qid)} compiled vs dynamic on cuda", qid, runs[0],
            out["rows"], out.get("abs_tol", {}).get(SF, 0.0))
        row["matches_dynamic"] = True
    if "cpu_mode" in out:
        row["cpu_execution_mode"] = out["cpu_mode"]
        row["cpu_memo"] = out["cpu_memo"]
        if out["cpu_mode"] != row["execution_mode"]:
            raise AssertionError(
                f"{label(qid)}: execution mode {row['execution_mode']} "
                "on cuda, "
                f"{out['cpu_mode']} on the CPU")
        if CPU_CHECK_SF[qid] == run_sf and out["cpu_memo"] != row["memo"]:
            raise AssertionError(
                f"{label(qid)}: memo {row['memo']} on cuda, "
                f"{out['cpu_memo']} on "
                "the CPU")
    # a tripped guard reports "compiled" too: the memo tells them apart;
    # held wherever presto_tpu's entry at this scale is known (ds_scales)
    refs = REFERENCE_MEMO[run_sf]
    row["reference_memo"] = refs.get(qid, "not known at this scale")
    if qid in refs and row["memo"] != refs[qid]:
        raise AssertionError(f"{label(qid)}: memo {row['memo']} on cuda, "
                             f"{refs[qid]} in presto_tpu")
    emit(row)
    out["compiled_row"] = row


def phase_segment_sum(qid, x, gid, G):
    """segment_sum on the float input one run of a query gives it:
    SEGMENT_SUM_REPEATS calls bit-identical, within EXACT_RTOL of each
    group's sum of |x| off the correctly rounded sums, timed beside one
    index_add_ (the atomic version it replaced)."""
    import torch

    from presto_tpu_torch.exec import kernels as K

    out = K.segment_sum(x, gid, G)
    same = all(torch.equal(out, K.segment_sum(x, gid, G))
               for _ in range(SEGMENT_SUM_REPEATS - 1))
    live = gid < G
    exact = torch.from_numpy(exact_group_sums(
        x[live][None], gid[live].to(torch.int32), G)[0]).cuda()
    scale = torch.zeros((G,), dtype=x.dtype, device=x.device).index_add_(
        0, gid[live].long(), x[live].abs())
    _, rel, within = rel_err(out, exact, EXACT_RTOL, scale)

    def one_index_add():
        acc = torch.zeros((G + 1,), dtype=x.dtype, device=x.device)
        return acc.index_add_(0, gid.long(), x)[:G]

    row = {"phase": "segment_sum", "query": label(qid), "n": x.shape[0],
           "live_rows": int(live.sum()), "groups": G, "dtype": str(x.dtype),
           f"bit_identical_in_{SEGMENT_SUM_REPEATS}": same,
           "max_rel_err_vs_exact": rel,
           "ms": cuda_ms(lambda: K.segment_sum(x, gid, G), 10),
           "index_add_ms": cuda_ms(one_index_add, 10)}
    emit(row)
    if not same:
        raise AssertionError(f"segment_sum gave different bits in "
                             f"{SEGMENT_SUM_REPEATS} calls at "
                             f"{label(qid)}'s input")
    if not within:
        raise AssertionError(f"segment_sum is {rel} off the correctly "
                             f"rounded sums at {label(qid)}'s input")


def phase_surface(sessions):
    """The fault C1 query, a SELECT without FROM and a DISTINCT aggregate
    on the card, in the dynamic executor and in compiled mode, each
    against the port's CPU run at SF1."""
    rows = {}
    for mode in ("dynamic", "compiled"):
        for name, sql in SURFACE.items():
            r = sessions[mode, SF].sql(sql)
            on_cpu = sessions["cpu", SF].sql(sql).rows
            if r.rows != on_cpu:
                raise AssertionError(f"{name} ({mode}): cuda {r.rows[:3]} "
                                     f"!= cpu {on_cpu[:3]}")
            if r.stats.execution_mode != mode:
                raise AssertionError(f"{name}: ran {r.stats.execution_mode}"
                                     f", not {mode}")
            rows[mode, name] = r.rows[:3]
        if any(r[1:] != (-2, None, 2, -1) for r in rows[mode, "c1"]):
            raise AssertionError(f"c1 ({mode}): {rows[mode, 'c1']} are not "
                                 "the reference's (x, -2, None, 2, -1)")
    emit({"phase": "surface", "matches_cpu": True,
          "rows": {f"{m}:{n}": r for (m, n), r in rows.items()}})


def memo_texts():
    """MEMO_TEXTS distinct TPC-H texts with qgen's parameters: Q6
    (year, discount, quantity) and Q1 (delta days) in turns."""
    from presto_tpu_torch.tpch_queries import QUERIES

    q1, q6 = QUERIES[1], QUERIES[6]
    assert "INTERVAL '90' DAY" in q1 and "'1994-01-01'" in q6
    texts = []
    for i in range(MEMO_TEXTS):
        if i % 3 == 2:
            texts.append((1, q1.replace("INTERVAL '90' DAY",
                                        f"INTERVAL '{60 + i}' DAY")))
            continue
        year, disc, qty = 1993 + i % 5, 0.02 + (i % 8) / 100, 24 + i % 2
        texts.append((6, q6.replace("'1994-01-01'", f"'{year}-01-01'")
                      .replace("BETWEEN 0.05 AND 0.07",
                               f"BETWEEN {disc - 0.01:.2f} AND "
                               f"{disc + 0.01:.2f}")
                      .replace("< 24", f"< {qty}")))
    return texts


def phase_memo_bound(sessions):
    """Distinct texts in one compiled session whose memo may hold
    MEMO_BOUND_BYTES: after each query the memo is within its bound, the
    device memory it holds is what its entries weigh (evicted graphs'
    pools went back to the device), and the rows equal the dynamic run's;
    the first text, long evicted, builds again and agrees too."""
    import torch

    import presto_tpu_torch
    from presto_tpu_torch.exec.executor import query_cache_key

    dyn = sessions["dynamic", SF]
    cat = dyn.catalog
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved()
    session = presto_tpu_torch.connect(
        cat, device="cuda", compiled_cache_max_bytes=MEMO_BOUND_BYTES)
    texts = memo_texts()
    built, pools, worst, t0 = 0, [], 0, time.perf_counter()
    for qid, sql in texts + texts[:1]:
        r = session.sql(sql)
        torch.cuda.synchronize()
        memo = session._compiled_cache
        if r.stats.execution_mode != "compiled" \
                or memo_entry(session, sql) != "executable":
            raise AssertionError(f"a {label(qid)} text ran "
                                 f"{r.stats.execution_mode}, memo "
                                 f"{memo_entry(session, sql)}")
        built += r.stats.compiles
        pools.append(memo.get(query_cache_key(session, sql))[1].pool_bytes)
        if memo.nbytes > MEMO_BOUND_BYTES and len(memo) > 1:
            raise AssertionError(f"the memo holds {memo.nbytes} bytes in "
                                 f"{len(memo)} entries")
        worst = max(worst, torch.cuda.memory_reserved() - base)
        assert_query_rows(f"memo text of {label(qid)}", qid, r.rows,
                          dyn.sql(sql).rows)
    seconds = time.perf_counter() - t0
    memo = session._compiled_cache
    torch.cuda.empty_cache()
    held = torch.cuda.memory_reserved() - base
    row = {"phase": "memo_bound", "texts": len(texts), "runs": len(pools),
           "bound_bytes": MEMO_BOUND_BYTES, "builds": built,
           "evictions": memo.evictions, "entries_held": len(memo),
           "memo_bytes": memo.nbytes, "reserved_held_bytes": held,
           "reserved_peak_over_base_bytes": worst,
           "pools_built_bytes": sum(pools), "seconds": seconds}
    emit(row)
    if built != len(texts) + 1 or not memo.evictions:
        raise AssertionError(f"{built} builds and {memo.evictions} "
                             f"evictions for {len(texts)} texts")
    # the bytes left reserved are the held entries' (pool allocation
    # rounds up to 2 MB blocks)
    if held > memo.nbytes + (64 << 20):
        raise AssertionError(f"{held} bytes stay reserved for a memo of "
                             f"{memo.nbytes}")
    del session, memo
    torch.cuda.empty_cache()


def phase_slice(capture):
    """All 22 TPC-H queries at SF1 through connect().sql() on the card,
    each in the dynamic executor (phase_query) and then in compiled mode
    (phase_compiled), whose graphs all stay held to the end."""
    import torch

    import presto_tpu_torch
    from presto_tpu_torch.catalog import tpch_catalog
    from presto_tpu_torch.exec import compile_cache as CC
    from presto_tpu_torch.exec import gather as G
    from presto_tpu_torch.exec import kernels as K
    from presto_tpu_torch.tpch_queries import QUERIES

    root = os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(root, "build", "tpch_cache")
    cats = {sf: tpch_catalog(sf, cache) for sf in sorted(
        set(CPU_CHECK_SF.values()) | {SF})}
    # the CPU sessions run as a user's would (auto: compiled mode)
    sessions = {("cpu", sf): presto_tpu_torch.connect(cat, device="cpu")
                for sf, cat in cats.items()}
    sessions.update({("dynamic", sf): presto_tpu_torch.connect(
        cat, device="cuda", execution_mode="dynamic")
        for sf, cat in cats.items()})
    sessions["compiled", SF] = presto_tpu_torch.connect(cats[SF],
                                                        device="cuda")
    for variant, props in SWITCHES_OFF.items():
        sessions[variant, "dynamic"] = presto_tpu_torch.connect(
            cats[SF], device="cuda", execution_mode="dynamic", **props)
        sessions[variant, "compiled"] = presto_tpu_torch.connect(
            cats[SF], device="cuda", **props)
    need = {"lineitem": ["l_quantity", "l_extendedprice", "l_discount",
                         "l_tax", "l_returnflag", "l_linestatus",
                         "l_shipdate", "l_orderkey"],
            "orders": ["o_orderkey", "o_custkey", "o_orderdate",
                       "o_shippriority", "o_totalprice"],
            "customer": ["c_custkey", "c_name", "c_mktsegment"]}
    cols = {}
    for table, names in need.items():
        t0 = time.perf_counter()
        cols[table] = cats[SF].get(table).read(names)
        emit({"phase": "generate", "sf": SF, "table": table,
              "rows": len(cols[table][names[0]]),
              "seconds": time.perf_counter() - t0})
    li, o, c = cols["lineitem"], cols["orders"], cols["customer"]
    expected = {1: numpy_q1(li), 6: numpy_q6(li), 3: numpy_q3(c, o, li),
                18: numpy_q18(c, o, li)}
    fn_tol = {"F4": fn_tolerances(li)}
    del cols, li, o, c

    counters = {"fused_group_sums": K.fused_group_sums_cuda,
                "block_gather": G.block_gather_cuda}
    launches = {mode: {name: 0 for name in counters}
                for mode in ("dynamic", "compiled")}
    by_query = {}
    segment_inputs = {}
    compiled_rows = {}
    for qid in SLICE_QUERIES:
        out = {"numpy": expected}
        guarded("query", label(qid), phase_query, qid, QUERIES[qid],
                sessions, capture, counters, out)
        guarded("compiled", label(qid), phase_compiled, qid, QUERIES[qid],
                sessions, capture, counters, out)
        guarded("counters", label(qid), phase_counters, qid, out)
        if qid in SWITCHED_OFF_QUERIES:
            guarded("switched_off", label(qid), phase_switched_off, qid,
                    QUERIES[qid], sessions, out)
        for mode, got in (("dynamic", out.get("launches")),
                          ("compiled", out.get("compiled_launches"))):
            if got is not None:
                by_query.setdefault(label(qid), {})[mode] = got
                for name in counters:
                    launches[mode][name] += got[name]
        if qid in SEGMENT_SUM_QUERIES and "segment_sum_input" in out:
            segment_inputs[qid] = out["segment_sum_input"]
        if "compiled_row" in out:
            compiled_rows[qid] = out["compiled_row"]
    t0 = time.perf_counter()
    guarded("relational", None, phase_relational, sessions, capture,
            counters, launches, by_query)
    emit({"phase": "relational_total", "queries": len(RELATIONAL),
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    guarded("functions", None, phase_functions, sessions, capture,
            counters, launches, by_query, fn_tol)
    emit({"phase": "functions_total", "queries": len(FUNCTIONS),
          "tolerances": fn_tol, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    guarded("collections", None, phase_collections, sessions, capture,
            counters, launches, by_query)
    emit({"phase": "collections_total", "queries": len(COLLECTIONS),
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    guarded("writes", None, phase_writes, cats[SF], capture, counters,
            launches, by_query)
    emit({"phase": "writes_total", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    guarded("decimals", None, phase_decimals, cats[SF], capture, counters,
            launches, by_query)
    emit({"phase": "decimals_total", "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    guarded("functions_ext", None, phase_functions_ext, cats[SF], capture,
            counters, launches, by_query)
    emit({"phase": "functions_ext_total",
          "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    guarded("zones_sketches", None, phase_zones_sketches, cats[SF],
            capture, counters, launches, by_query)
    emit({"phase": "zones_sketches_total", "card": card_line(),
          "seconds": time.perf_counter() - t0,
          "target_seconds": ZS_TARGET_SECONDS})
    t0 = time.perf_counter()
    guarded("geo_ml_f32", None, phase_geo_ml_f32, cats[SF], capture,
            counters, launches, by_query)
    emit({"phase": "geo_ml_f32_total", "card": card_line(),
          "seconds": time.perf_counter() - t0,
          "target_seconds": GM_TARGET_SECONDS})
    torch.cuda.synchronize()
    emit({"phase": "slice", "launches": launches,
          "launches_by_query": by_query})
    emit({"phase": "compiled_summary",
          "graphs": sum(r["graph"] for r in compiled_rows.values()),
          "queries": len(compiled_rows),
          "memory_reserved_with_all_graphs": torch.cuda.memory_reserved(),
          "memo_bound_bytes": CC.memo_bound(sessions["compiled", SF]),
          "memo_evictions": sessions["compiled", SF]._compiled_cache.evictions,
          "sum_pool_bytes": sum(r.get("pool_bytes", 0)
                                for r in compiled_rows.values()),
          "shared_table_path": [label(q) for q, r in compiled_rows.items()
                                if "shared_table" in r["fgs_paths"]],
          "not_captured": {label(q): (r["execution_mode"], r["memo"])
                           for q, r in compiled_rows.items()
                           if not r["graph"]}})
    for qid in SEGMENT_SUM_QUERIES:
        if qid not in segment_inputs:
            fail("segment_sum", label(qid),
                 f"{label(qid)} gave segment_sum no float input")
            continue
        guarded("segment_sum", label(qid), phase_segment_sum, qid,
                *segment_inputs.pop(qid))
    guarded("surface", None, phase_surface, sessions)
    guarded("memo_bound", None, phase_memo_bound, sessions)
    for qid in PROFILED_QUERIES:
        guarded("profile", label(qid), phase_profile,
                sessions["dynamic", SF], qid, QUERIES[qid])
    for name in counters:
        for mode in launches:
            if not launches[mode][name]:
                fail("slice", None, f"no query launched {name} in "
                     f"{mode} mode")
    return launches["compiled"]


def prefix_tolerances(sessions):
    """{query: {sf: abs_tol}} for FLOAT_PREFIX_QUERIES at the scale
    factors they run at: PREFIX_ULPS_PER_SQRT_ROW * sqrt(n) ulps of the
    largest prefix, which sum(|x|) over the column bounds."""
    import numpy as np

    out = {}
    for name, (table, column) in FLOAT_PREFIX_QUERIES.items():
        for sf in {SF, CPU_CHECK_SF[name]}:
            x = sessions["dynamic", sf].catalog.get(table).read(
                [column])[column]
            bound = float(np.abs(np.asarray(x, dtype=np.float64)).sum())
            out.setdefault(name, {})[sf] = (PREFIX_ULPS_PER_SQRT_ROW
                                            * math.sqrt(len(x))
                                            * 2.0 ** -52 * bound)
    return out


def relational_row(name, sql, sessions, out, seconds):
    """The relational phase's line for one corpus query: its card, rows,
    times in both executors, device busy and idle shares (a profiled warm
    dynamic run and the compiled replay's), counters and memo entry
    beside presto_tpu's, the tolerance its rows were held to, and the
    kernel shapes it reached.  Raises when a step of the query failed."""
    missing = [k for k in ("warm_ms", "compiled_row", "compiled_counters")
               if k not in out]
    if missing:
        raise AssertionError(f"{name}: no {missing} (a step failed)")
    comp = out["compiled_row"]
    prof = profile_run(sessions["dynamic", SF], sql,
                       top=8 if name in RELATIONAL_TOP else 0)
    row = {"phase": "relational", "query": name, "card": card_line(),
           "sf": SF, "rows": len(out["rows"]),
           "matches_cpu_at_sf": CPU_CHECK_SF[name],
           "abs_tol": out.get("abs_tol") or None,
           "dynamic_warm_ms": out["warm_ms"],
           "compiled_replay_ms": out["replay_ms"],
           "compiled_graph": comp["graph"],
           "graph_device_ms": comp.get("graph_device_ms"),
           "dynamic_profile": prof,
           "compiled_profile": {k: comp.get(k) for k in (
               "wall_ms", "device_busy_ms", "device_idle_share",
               "kernel_launches")},
           "counters": {"dynamic": out["dynamic_counters"],
                        "compiled": out["compiled_counters"]},
           "reference_counters": REFERENCE_COUNTERS_SF1.get(name),
           "memo": comp["memo"], "reference_memo": REFERENCE_MEMO_SF1[name],
           "launches": {"dynamic": out["launches"],
                        "compiled": out.get("compiled_launches")},
           "kernel_shapes": {"dynamic": out.get("dynamic_kernel_shapes"),
                             "compiled": comp["kernel_shapes"]},
           "seconds": seconds}
    if name in RELATIONAL_TOP and comp.get("top_kernels"):
        row["compiled_top_kernels"] = comp["top_kernels"]
    emit(row)


def phase_relational(sessions, capture, counters, launches, by_query):
    """The relational corpus at SF1 on the card, each query in the
    dynamic executor (phase_query) and in compiled mode (phase_compiled)
    with its counters against presto_tpu's (phase_counters), then one
    `relational` line (relational_row).  Launch counts add into the
    slice's."""
    from presto_tpu_torch.relational_queries import QUERIES

    if tuple(QUERIES) != RELATIONAL:
        raise AssertionError(f"corpus {tuple(QUERIES)} != {RELATIONAL}")
    tolerances = prefix_tolerances(sessions)
    for name in RELATIONAL:
        t0 = time.perf_counter()
        out = {"abs_tol": tolerances.get(name, {})}
        sql = QUERIES[name]
        guarded("query", name, phase_query, name, sql, sessions, capture,
                counters, out)
        guarded("compiled", name, phase_compiled, name, sql, sessions,
                capture, counters, out)
        guarded("counters", name, phase_counters, name, out)
        guarded("relational", name, relational_row, name, sql, sessions,
                out, time.perf_counter() - t0)
        for mode, got in (("dynamic", out.get("launches")),
                          ("compiled", out.get("compiled_launches"))):
            if got is not None:
                by_query.setdefault(name, {})[mode] = got
                for kernel in counters:
                    launches[mode][kernel] += got[kernel]


UNIT_ROUNDOFF = 2.0 ** -53  # of f64


def fn_tolerances(li) -> dict:
    """{returnflag: {column: rtol}} for F4's bivariate and moment
    columns, from the SF1 lineitem columns: each value is a difference of
    grouped sums (covar_pop = E[xy] - E[x]E[y], skewness's third central
    moment from the raw power sums, ...), so two summation orders may
    part by up to 2 n u (the worst-case error of two n-term sums, u the
    unit roundoff) times its condition number, the summed magnitude of
    its terms over its own; the bound where it passes QUERY_RTOL."""
    import numpy as np

    flags = np.asarray(li["l_returnflag"]).astype(str)
    out = {}
    for flag in sorted(set(flags.tolist())):
        m = flags == flag
        n = float(m.sum())
        y = np.asarray(li["l_extendedprice"], np.float64)[m]
        x = np.asarray(li["l_quantity"], np.float64)[m]
        ex, ey = x.mean(), y.mean()
        exy, exx, eyy = (x * y).mean(), (x * x).mean(), (y * y).mean()
        covp, varx, vary = exy - ex * ey, exx - ex * ex, eyy - ey * ey
        k_cov = (abs(exy) + abs(ex * ey)) / abs(covp)
        k_vx, k_vy = (exx + ex * ex) / varx, (eyy + ey * ey) / vary
        slope = covp / varx
        k_slope = k_cov + k_vx
        icept = ey - slope * ex
        k_icept = (abs(ey) + abs(slope * ex) * (1 + k_slope)) / abs(icept)

        def moments(col):
            v = np.asarray(li[col], np.float64)[m]
            mu = v.mean()
            e2, e3, e4 = (v * v).mean(), (v ** 3).mean(), (v ** 4).mean()
            m2 = e2 - mu * mu
            m3 = e3 - 3 * mu * e2 + 2 * mu ** 3
            m4 = e4 - 4 * mu * e3 + 6 * mu * mu * e2 - 3 * mu ** 4
            k_m2 = (e2 + mu * mu) / m2
            k_m3 = (abs(e3) + 3 * abs(mu) * e2 + 2 * abs(mu) ** 3) / abs(m3)
            k_m4 = (e4 + 4 * abs(mu) * abs(e3) + 6 * mu * mu * e2
                    + 3 * mu ** 4) / abs(m4)
            return m2, m4, k_m2, k_m3, k_m4

        _, _, k_m2d, k_m3d, _ = moments("l_discount")
        m2t, m4t, k_m2t, _, k_m4t = moments("l_tax")
        # kurtosis = A - B, A = n(n+1)/((n-1)(n-2)(n-3)) * M4 / sd2^2
        a = n * (n + 1) / ((n - 1) * (n - 2) * (n - 3)) \
            * (n * m4t) / (n * m2t / (n - 1)) ** 2
        b = 3.0 * (n - 1) ** 2 / ((n - 2) * (n - 3))
        k_kurt = abs(a) * (k_m4t + 2 * k_m2t) / abs(a - b)

        def rtol(k):
            return max(QUERY_RTOL, 2 * n * UNIT_ROUNDOFF * k)

        out[flag] = {1: rtol(k_cov + 0.5 * (k_vx + k_vy)), 2: rtol(k_cov),
                     3: rtol(k_cov), 4: rtol(k_slope), 5: rtol(k_icept),
                     6: rtol(k_m3d + 1.5 * k_m2d), 7: rtol(k_kurt)}
    return out


def assert_fn_rows(what, name, actual, expected, tolerances=None,
                   skip=()):
    """Rows of a function query in order, value by value: the columns
    of EXACT_FLOAT_COLUMNS and every non-float exactly, other floats
    within QUERY_RTOL or the row's bound in `tolerances` ({first column:
    {column: rtol}}); columns in `skip` are not compared."""
    from presto_tpu_torch.function_queries import EXACT_FLOAT_COLUMNS

    exact = EXACT_FLOAT_COLUMNS.get(name, ())
    if len(actual) != len(expected):
        raise AssertionError(f"{what}: {len(actual)} rows, expected "
                             f"{len(expected)}")
    for k, (ra, re_) in enumerate(zip(actual, expected)):
        tol = (tolerances or {}).get(re_[0], {})
        for i, (a, b) in enumerate(zip(ra, re_)):
            if i in skip:
                continue
            if isinstance(a, float) and isinstance(b, float) \
                    and i not in exact:
                ok = a == b or (math.isnan(a) and math.isnan(b)) \
                    or math.isclose(a, b, rel_tol=tol.get(i, QUERY_RTOL),
                                    abs_tol=0.0)
            else:
                ok = type(a) is type(b) and a == b
            if not ok:
                raise AssertionError(f"{what}: row {k} column {i}: {a!r}, "
                                     f"expected {b!r} ({list(ra)} vs "
                                     f"{list(re_)})")


def fn_reference_rows(name, mode) -> list:
    """presto_tpu's SF1 rows of a function query in a mode ("dynamic" or
    "compiled"; FN_REFERENCE_SF1 keeps compiled rows only where they
    differ from the dynamic ones)."""
    ref = FN_REFERENCE_SF1[name]
    return ref[mode].get("rows", ref["dynamic"]["rows"])


def fn_mode_exempt(name) -> tuple:
    """The columns where presto_tpu's own two modes give different rows
    at SF1 (approx_distinct's register count follows the static
    capacity, not the live group count): compiled rows on the card need
    not equal the dynamic ones there.  None for a query whose compiled
    rows are held to presto_tpu's dynamic ones (FN_COMPILED_AS_DYNAMIC)."""
    if name in FN_COMPILED_AS_DYNAMIC:
        return ()
    cols = set()
    for rd, rc in zip(fn_reference_rows(name, "dynamic"),
                      fn_reference_rows(name, "compiled")):
        cols.update(i for i, (a, b) in enumerate(zip(rd, rc))
                    if not values_agree(a, b))
    return tuple(sorted(cols))


def functions_row(name, sql, sessions, out, seconds):
    """The functions phase's line for one corpus query: its card, rows,
    cold, warm and replay times, device busy and idle shares (a profiled
    warm dynamic run and the compiled replay's), peak device bytes of
    the dynamic runs, the graph or "DYNAMIC", counters and memo beside
    presto_tpu's, launches and kernel shapes."""
    missing = [k for k in ("warm_ms", "compiled_row", "compiled_counters")
               if k not in out]
    if missing:
        raise AssertionError(f"{name}: no {missing} (a step failed)")
    comp = out["compiled_row"]
    prof = profile_run(sessions["dynamic", SF], sql, top=FN_TOP_KERNELS)
    emit({"phase": "functions", "query": name, "card": card_line(),
          "sf": SF, "rows": len(out["rows"]),
          "cold_ms": out["cold_ms"], "dynamic_warm_ms": out["warm_ms"],
          "compiled_first_run_ms": comp["first_run_ms"],
          "compiled_replay_ms": out["replay_ms"],
          "graph": "graph" if comp["graph"] else comp["memo"],
          "graph_device_ms": comp.get("graph_device_ms"),
          "pool_bytes": comp.get("pool_bytes"),
          "peak_device_bytes": out["peak_device_bytes"],
          "dynamic_profile": prof,
          "compiled_profile": {k: comp.get(k) for k in (
              "wall_ms", "device_busy_ms", "device_idle_share",
              "kernel_launches", "top_kernels")},
          "counters": {"dynamic": out["dynamic_counters"],
                       "compiled": out["compiled_counters"]},
          "reference_counters": REFERENCE_COUNTERS_SF1[name],
          "memo": comp["memo"], "reference_memo": REFERENCE_MEMO_SF1[name],
          "exempt_compiled_columns": fn_mode_exempt(name),
          "launches": {"dynamic": out["launches"],
                       "compiled": out.get("compiled_launches")},
          "kernel_shapes": {
              "dynamic": sorted(set(map(tuple, out.get(
                  "dynamic_kernel_shapes", [])))),
              "compiled": sorted(set(map(tuple, comp["kernel_shapes"])))},
          "seconds": seconds})


def phase_functions(sessions, capture, counters, launches, by_query,
                    tolerances):
    """The function corpus at SF1 on the card over the TPC-H sessions,
    each query in the dynamic executor (phase_query, its rows held to
    presto_tpu's dynamic rows) and in compiled mode (phase_compiled, its
    rows held to the dynamic run's and to presto_tpu's compiled rows, its
    execution mode to presto_tpu's), with the counters of both against
    presto_tpu's (phase_counters), then one `functions` line
    (functions_row).  Launch counts add into the slice's."""
    from presto_tpu_torch.function_queries import QUERIES

    if tuple(QUERIES) != FUNCTIONS:
        raise AssertionError(f"corpus {tuple(QUERIES)} != {FUNCTIONS}")
    for name in FUNCTIONS:
        t0 = time.perf_counter()
        sql, ref = QUERIES[name], FN_REFERENCE_SF1[name]
        tol = tolerances.get(name)
        skip = fn_mode_exempt(name)

        def held(mode):
            def check(what, rows):
                assert_fn_rows(what, name, rows,
                               fn_reference_rows(name, mode), tol)
            return check

        def compiled_vs_dynamic(what, qid, rows, dynamic_rows, abs_tol):
            assert_fn_rows(what, name, rows, dynamic_rows, skip=skip)

        out = {"reference_rows": held("dynamic"),
               "compare_compiled": compiled_vs_dynamic}
        guarded("query", name, phase_query, name, sql, sessions, capture,
                counters, out)
        guarded("compiled", name, phase_compiled, name, sql, sessions,
                capture, counters, out)
        if "compiled_rows" in out:
            held_to = "dynamic" if name in FN_COMPILED_AS_DYNAMIC \
                else "compiled"
            guarded("functions", name, held(held_to),
                    f"{name} compiled on cuda vs presto_tpu {held_to}",
                    out["compiled_rows"])
            mode = out["compiled_row"]["execution_mode"]
            if mode != ref["compiled"]["mode"]:
                fail("functions", name, f"execution mode {mode} on cuda, "
                     f"{ref['compiled']['mode']} in presto_tpu")
        guarded("counters", name, phase_counters, name, out)
        guarded("functions", name, functions_row, name, sql, sessions,
                out, time.perf_counter() - t0)
        for mode, got in (("dynamic", out.get("launches")),
                          ("compiled", out.get("compiled_launches"))):
            if got is not None:
                by_query.setdefault(name, {})[mode] = got
                for kernel in counters:
                    launches[mode][kernel] += got[kernel]


def tuplify(v):
    """A JSON value with every list made a tuple (collection values)."""
    if isinstance(v, list):
        return tuple(tuplify(x) for x in v)
    return v


def coll_reference_rows(name, mode) -> list:
    """presto_tpu's SF1 rows of a collection query in a mode ("dynamic"
    or "compiled"; COLL_REFERENCE_SF1 keeps compiled rows only where they
    differ from the dynamic ones), collection values as tuples."""
    ref = COLL_REFERENCE_SF1[name]
    rows = ref[mode].get("rows", ref["dynamic"]["rows"])
    return [tuple(tuplify(v) for v in r) for r in rows]


def assert_coll_rows(what, name, actual, expected):
    """Rows of a collection query in order: ints, strings and booleans
    exactly, floats within QUERY_RTOL, inside collection values too (C5's
    numeric_histogram means are np.mean on the host, whose last bits
    follow numpy's build)."""
    if len(actual) != len(expected):
        raise AssertionError(f"{what}: {len(actual)} rows, expected "
                             f"{len(expected)}")
    def agree(a, b):
        if isinstance(a, float) and isinstance(b, float):
            return a == b or math.isclose(a, b, rel_tol=QUERY_RTOL,
                                          abs_tol=0.0)
        if isinstance(a, tuple) and isinstance(b, tuple):
            return len(a) == len(b) and all(map(agree, a, b))
        return type(a) is type(b) and a == b

    for k, (ra, re_) in enumerate(zip(actual, expected)):
        for i, (a, b) in enumerate(zip(ra, re_)):
            if not agree(a, b):
                raise AssertionError(f"{what}: row {k} column {i}: "
                                     f"{a!r:.200}, expected {b!r:.200}")


def unnest_routes(name, out) -> list:
    """The take_rows route (exec/gather.py gather_route, of UNNEST's
    presorted gather) of a corpus query's UNNEST expansion in each mode:
    [mode, source rows, indices, words, route] for each block_gather
    shape the run captured at the expansion's index count (its expanded
    rows; the static executor's n x maxlen slots equal them where every
    array has one length, as in C1 and C2) from fewer source rows (a
    gather of the expanded batch itself has as many).  A mode that
    captured no such shape sent the expansion flat: every staged gather
    launches block_gather, which Capture sees."""
    import torch

    from presto_tpu_torch.exec import gather as G

    m = COLL_EXPANSIONS[name](out["rows"])
    dev = torch.device("cuda")
    got = []
    for mode, shapes in (
            ("dynamic", out.get("dynamic_kernel_shapes", [])),
            ("compiled", out.get("compiled_row", {}).get("kernel_shapes",
                                                          []))):
        hits = sorted({tuple(key) for kernel, key in shapes
                       if kernel == "block_gather" and key[2] == m
                       and key[0] < m})
        got += [[mode, n, m, w, G.gather_route(n, m, w, True, dev)]
                for n, w, _ in hits] or [[mode, None, m, None, "flat"]]
    return got


def collections_row(name, sql, sessions, out, routes, seconds):
    """The collections phase's line for one corpus query: its card,
    rows, cold, warm and replay times, device busy and idle shares (a
    profiled warm dynamic run and the compiled replay's), peak device
    bytes, the graph or "DYNAMIC", counters and memo beside presto_tpu's,
    launches, kernel shapes and the take_rows route of each UNNEST
    expansion."""
    missing = [k for k in ("warm_ms", "compiled_row", "compiled_counters")
               if k not in out]
    if missing:
        raise AssertionError(f"{name}: no {missing} (a step failed)")
    comp = out["compiled_row"]
    # where compiled mode runs dynamic, its profiled run is a dynamic one
    prof = profile_run(sessions["dynamic", SF], sql, top=FN_TOP_KERNELS) \
        if comp["graph"] else "the compiled profile (a dynamic run)"
    emit({"phase": "collections", "query": name, "card": card_line(),
          "sf": SF, "rows": len(out["rows"]),
          "cold_ms": out["cold_ms"], "dynamic_warm_ms": out["warm_ms"],
          "compiled_first_run_ms": comp["first_run_ms"],
          "compiled_replay_ms": out["replay_ms"],
          "graph": "graph" if comp["graph"] else comp["memo"],
          "graph_device_ms": comp.get("graph_device_ms"),
          "pool_bytes": comp.get("pool_bytes"),
          "peak_device_bytes": out["peak_device_bytes"],
          "dynamic_profile": prof,
          "compiled_profile": {k: comp.get(k) for k in (
              "wall_ms", "device_busy_ms", "device_idle_share",
              "kernel_launches", "top_kernels")},
          "counters": {"dynamic": out["dynamic_counters"],
                       "compiled": out["compiled_counters"]},
          "reference_counters": REFERENCE_COUNTERS_SF1[name],
          "memo": comp["memo"], "reference_memo": REFERENCE_MEMO_SF1[name],
          "launches": {"dynamic": out["launches"],
                       "compiled": out.get("compiled_launches")},
          "kernel_shapes": {
              "dynamic": sorted(set(map(tuple, out.get(
                  "dynamic_kernel_shapes", [])))),
              "compiled": sorted(set(map(tuple, comp["kernel_shapes"])))},
          # [mode, source rows, indices, words, route]
          "unnest_routes": routes,
          "seconds": seconds})


def phase_collections(sessions, capture, counters, launches, by_query):
    """The collection corpus at SF1 on the card over the TPC-H sessions,
    each query in the dynamic executor (phase_query, its rows held to
    presto_tpu's dynamic rows) and in compiled mode (phase_compiled: its
    rows held to the dynamic run's and to presto_tpu's compiled rows, its
    execution mode and memo entry to presto_tpu's), the counters of both
    against presto_tpu's (phase_counters), then one `collections` line
    (collections_row).  C1 or C2 must launch fused_group_sums on the
    grouped expansion, and C1 or C2 must launch block_gather at the
    expansion's shape or show that take_rows' rules sent it flat.
    Launch counts add into the slice's."""
    from presto_tpu_torch.collection_queries import QUERIES

    if tuple(QUERIES) != COLLECTIONS:
        raise AssertionError(f"corpus {tuple(QUERIES)} != {COLLECTIONS}")
    expansions = {}
    for name in COLLECTIONS:
        t0 = time.perf_counter()
        sql, ref = QUERIES[name], COLL_REFERENCE_SF1[name]

        def held(mode, _name=name):
            def check(what, rows):
                assert_coll_rows(what, _name, rows,
                                 coll_reference_rows(_name, mode))
            return check

        def compiled_vs_dynamic(what, qid, rows, dynamic_rows, abs_tol):
            assert_coll_rows(what, qid, rows, dynamic_rows)

        out = {"reference_rows": held("dynamic"),
               "compare_compiled": compiled_vs_dynamic}
        guarded("query", name, phase_query, name, sql, sessions, capture,
                counters, out, COLL_DYNAMIC_RUNS)
        guarded("compiled", name, phase_compiled, name, sql, sessions,
                capture, counters, out, COLL_REPLAYS)
        seen = unnest_routes(name, out) \
            if name in COLL_EXPANSIONS and "rows" in out else []
        if "compiled_rows" in out:
            guarded("collections", name, held("compiled"),
                    f"{name} compiled on cuda vs presto_tpu compiled",
                    out["compiled_rows"])
            mode = out["compiled_row"]["execution_mode"]
            if mode != ref["compiled"]["mode"]:
                fail("collections", name, f"execution mode {mode} on cuda, "
                     f"{ref['compiled']['mode']} in presto_tpu")
        guarded("counters", name, phase_counters, name, out)
        guarded("collections", name, collections_row, name, sql, sessions,
                out, seen, time.perf_counter() - t0)
        for mode, got in (("dynamic", out.get("launches")),
                          ("compiled", out.get("compiled_launches"))):
            if got is not None:
                by_query.setdefault(name, {})[mode] = got
                for kernel in counters:
                    launches[mode][kernel] += got[kernel]
        if name in COLL_GROUPED_EXPANSIONS:
            expansions[name] = (out, seen)
    fgs = [n for n, (o, _) in expansions.items()
           if any(o.get(k, {}).get("fused_group_sums")
                  for k in ("launches", "compiled_launches"))]
    # a staged route is one block_gather launch at the expansion's shape
    bg = [n for n, (_, seen) in expansions.items()
          if any(r[-1] == "staged" for r in seen)]
    flat = [n for n, (_, seen) in expansions.items()
            if seen and all(r[-1] == "flat" for r in seen)]
    emit({"phase": "collections_kernels", "fused_group_sums_in": fgs,
          "block_gather_in": bg, "flat_expansions_in": flat})
    if not fgs:
        raise AssertionError("no grouped UNNEST expansion launched "
                             "fused_group_sums")
    if not bg and not flat:
        raise AssertionError("no UNNEST expansion launched block_gather "
                             "or went flat by take_rows' rules")



# ---------------------------------------------------------------------------
# the writes phase: the statement corpus at SF1
# ---------------------------------------------------------------------------

#: runs of the statement script a mode: the second "auto" run, in a fresh
#: session, must give rows and tables identical to the first
WRITE_RUNS = {"auto": 2, "dynamic": 1}


def _fresh_catalog(tables):
    """A catalog over the SF1 TPC-H tables whose writes stay its own."""
    from presto_tpu_torch.catalog import Catalog

    cat = Catalog()
    for t in tables:
        cat.register(t)
    return cat


def write_script_run(tables, mode, capture, counters, ids=None,
                     captured=False):
    """One run of the statement script (presto_tpu_torch/
    statement_queries.py) in a fresh session on the card: each statement
    with every kernel's launch count set to 0 just before and read just
    after, its wall time, its rows, write stats and counters, and the
    digest of the table it wrote (pages through a PageLog).  captured:
    each statement runs under the Capture, which holds each kernel at
    each new shape against its plain version after the statement's
    counts are read."""
    import torch

    import presto_tpu_torch
    from presto_tpu_torch import statement_queries as SQ
    from presto_tpu_torch.connectors import AppendPageSink

    session = presto_tpu_torch.connect(_fresh_catalog(tables),
                                       device="cuda", execution_mode=mode)
    out = {}
    with SQ.PageLog(AppendPageSink) as log:
        for sid, sql, table in SQ.SCRIPT:
            if ids is not None and sid not in ids:
                continue
            for fn in counters.values():
                fn.launches = 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            if captured:
                res = capture.run(session, sid, sql, mode)
            else:
                res = session.sql(sql)
                torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            launches = {k: fn.launches for k, fn in counters.items()}
            shapes = sorted(set(map(tuple, capture.shapes))) \
                if captured else None
            if captured:
                capture.check()
            dig = None
            if table is not None:
                tab = session.catalog.get(table)
                wp = tab.write_properties() or {}
                dig = SQ.table_digest(
                    tab.data, [p for p in log.take() if p[0] == tab.name],
                    [c for c, _a in wp.get("sorted_by", [])])
                dig["ordering"] = [[c, bool(a)] for c, a in tab.ordering()]
                dig["write_properties"] = wp
            log.take()
            out[sid] = {"result": res, "digest": dig, "ms": ms,
                        "launches": launches, "shapes": shapes}
    del session
    return out


def check_write_run(mode, run, reference):
    """A run's statements against presto_tpu's SF1 values: rows (floats
    within QUERY_RTOL), execution mode, rows and bytes written, files,
    the queries' seven counters, and each written table's digest (float
    sums within QUERY_RTOL, all else exactly)."""
    from presto_tpu_torch import statement_queries as SQ

    for sid, got in run.items():
        ref = reference[sid]
        res = got["result"]
        bad = SQ.rows_mismatch(sid, SQ.comparable(sid, res.rows),
                               [tuple(r) for r in ref["rows"]], QUERY_RTOL)
        if bad:
            raise AssertionError(f"{mode} {bad}")
        stats = [getattr(res.stats, k) for k in (
            "execution_mode", "rows_written", "bytes_written",
            "write_files")]
        if stats != ref["stats"]:
            raise AssertionError(f"{mode} {sid}: mode, rows, bytes, files "
                                 f"{stats}, presto_tpu {ref['stats']}")
        if sid in SQ.QUERY_IDS and sort_counters(res.stats) \
                != ref["counters"]:
            raise AssertionError(
                f"{mode} {sid}: counters {sort_counters(res.stats)}, "
                f"presto_tpu {ref['counters']}")
        if ref["digest"] is not None:
            bad = SQ.digest_mismatch(got["digest"], ref["digest"],
                                     QUERY_RTOL)
            if bad:
                raise AssertionError(f"{mode} {sid} table: {bad}")


def check_write_repeat(first, second):
    """Two runs of the script in fresh sessions: identical rows and
    identical table digests (every bit)."""
    for sid, got in first.items():
        a, b = got["result"].rows, second[sid]["result"].rows
        from presto_tpu_torch import statement_queries as SQ

        if SQ.comparable(sid, a) != SQ.comparable(sid, b):
            raise AssertionError(f"{sid}: rows differ between two runs")
        if got["digest"] != second[sid]["digest"]:
            raise AssertionError(f"{sid}: the table differs between two "
                                 "runs")


def phase_writes(cat, capture, counters, launches, by_query):
    """The statement corpus at SF1 on the card over the TPC-H tables of
    `cat`, each run in a fresh session: twice in "auto" (the second run
    held identical to the first), once in "dynamic", and D2 and D3 once
    in "compiled" (the writer's compiled source path); every run but the
    second "auto" one under the Capture (each kernel at each new shape,
    of either executor, against its plain version).  Every
    run is held to presto_tpu's SF1 values (WRITE_REFERENCE_SF1); a
    rollback must leave the table's digest as it was, and D5's text
    after each write must see the write (a new graph, counts doubled
    after the committed insert).  One `writes` line a statement and mode.
    D1, D4 and D5 must launch fused_group_sums and D3 or D5
    block_gather.  Launch counts of the "auto" runs add into the
    compiled mode's, the "dynamic" run's into the dynamic executor's."""
    from presto_tpu_torch import statement_queries as SQ

    tables = list(cat.tables.values())
    runs = {}
    for mode, n in WRITE_RUNS.items():
        for i in range(n):
            runs[mode, i] = write_script_run(
                tables, mode, capture, counters, captured=(i == 0))
    runs["compiled", 0] = write_script_run(
        tables, "compiled", capture, counters, ids=SQ.COMPILED_IDS,
        captured=True)
    for (mode, i), run in runs.items():
        for sid, got in run.items():
            res = got["result"]
            emit({"phase": "writes", "mode": mode, "run": i, "id": sid,
                  "card": card_line(), "ms": got["ms"],
                  "rows_written": res.stats.rows_written,
                  "execution_mode": res.stats.execution_mode,
                  "launches": got["launches"],
                  "kernel_shapes": got["shapes"]})
        check_write_run(mode, run,
                        SQ.expand_reference(WRITE_REFERENCE_SF1, mode))
        key = "dynamic" if mode == "dynamic" else "compiled"
        for sid, got in run.items():
            by_query.setdefault(f"writes {mode} {i} {sid}", {})[key] = \
                got["launches"]
            for kernel in counters:
                launches[key][kernel] += got["launches"][kernel]
    check_write_repeat(runs["auto", 0], runs["auto", 1])
    auto = runs["auto", 0]
    if auto["D6c"]["digest"]["sums"] != auto["D2"]["digest"]["sums"] \
            or auto["D6c"]["digest"]["order"] \
            != auto["D2"]["digest"]["order"]:
        raise AssertionError("ROLLBACK left li_range changed")
    d5, back, commit = (auto[s]["result"] for s in ("D5", "D6d", "D6h"))
    if back.rows != d5.rows \
            or [r[1] for r in commit.rows] != [2 * r[1] for r in d5.rows]:
        raise AssertionError("D5 after the writes does not see them")
    if any(r.stats.compile_cache_hits for r in (back, commit)):
        raise AssertionError("D5 replayed a graph captured before a write")
    both = {mode: {sid: got["launches"] for sid, got in runs[mode, 0].items()}
            for mode in ("auto", "dynamic")}
    fgs_in = {sid for m in both for sid, n in both[m].items()
              if n["fused_group_sums"]}
    bg_in = {sid for m in both for sid, n in both[m].items()
             if n["block_gather"]}
    emit({"phase": "writes_kernels", "fused_group_sums_in": sorted(fgs_in),
          "block_gather_in": sorted(bg_in),
          "seconds": {f"{m} {i}": sum(g["ms"] for g in r.values()) / 1e3
                      for (m, i), r in runs.items()}})
    missing = [s for s in ("D1", "D4", "D5") if s not in fgs_in]
    if missing:
        raise AssertionError(f"{missing} launched no fused_group_sums")
    if not bg_in & {"D3", "D5"}:
        raise AssertionError("neither D3 nor D5 launched block_gather")


# ---------------------------------------------------------------------------
# the decimals phase: the decimal corpus at SF1
# ---------------------------------------------------------------------------

DEC_MODES = ("dynamic", "auto", "compiled")
#: the queries profiled warm after each mode's script (busy and idle)
DEC_PROFILED = ("N2", "N4", "N5", "N6", "N7", "NG", "N8c")


class _CapturedSession:
    """A session whose statements run under the Capture, for
    decimal_queries.record."""

    def __init__(self, session, capture, sid, mode):
        self.session, self.capture = session, capture
        self.sid, self.mode = sid, mode

    @property
    def _compiled_cache(self):
        return getattr(self.session, "_compiled_cache", None)

    def sql(self, text):
        return self.capture.run(self.session, self.sid, text, self.mode)


def corpus_run(tables, mode, capture, counters, statements, record,
               warm_ids=(), same_rows=None, props=None):
    """One pass of a corpus's statements [(id, sql)] in a fresh session on
    the card, each under the Capture: every kernel's launch count set to
    0 just before and read just after, its wall time, its record
    (`record(session, id, sql)`: rows or error, types, execution mode,
    counters, memo entry) and the kernel shapes it met, each new shape
    then held against its plain version; the statements of warm_ids once
    more warm (a replay where the first run built a graph), their rows
    held to the first run's (`same_rows(record, result)`); `props` are
    the session's properties.  Returns the session and {id: run}."""
    import torch

    import presto_tpu_torch

    session = presto_tpu_torch.connect(_fresh_catalog(tables),
                                       device="cuda", execution_mode=mode,
                                       **(props or {}))
    out = {}
    for sid, sql in statements:
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        rec = record(_CapturedSession(session, capture, sid, mode), sid, sql)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        launches = {k: fn.launches for k, fn in counters.items()}
        shapes = sorted(set(map(tuple, capture.shapes)))
        capture.check()
        warm = None
        if rec["error"] is None and sid in warm_ids:
            t = time.perf_counter()
            again = session.sql(sql)
            torch.cuda.synchronize()
            warm = (time.perf_counter() - t) * 1e3
            if not same_rows(rec, again):
                raise AssertionError(f"{sid} {mode}: the warm run's rows "
                                     "differ from the first run's")
        out[sid] = {"record": rec, "ms": ms, "warm_ms": warm,
                    "launches": launches, "shapes": shapes}
    return session, out


def corpus_verdict(phase, runs, differs, counters, launches, by_query,
                   fused_ids, gather_ids, failures=(), **kernels_line):
    """A corpus's runs ({mode: {id: run}}, corpus_run's) against their
    records: one `phase` line a statement and mode, its launches added
    into the executor's (the "auto" and "compiled" runs' into the
    compiled mode's, the "dynamic" run's into the dynamic executor's),
    and a `<phase>_kernels` line (with kernels_line's keys).  Raises at
    the first of the failures found before and the differences
    (`differs(mode, id, record)`: '' or the difference), where a
    statement of fused_ids launched no
    fused_group_sums, or where none of gather_ids launched
    block_gather."""
    bad = list(failures)
    for mode, run in runs.items():
        key = "dynamic" if mode == "dynamic" else "compiled"
        for sid, got in run.items():
            rec = got["record"]
            emit({"phase": phase, "mode": mode, "id": sid,
                  "card": card_line(), "ms": got["ms"],
                  "warm_ms": got["warm_ms"],
                  "execution_mode": rec.get("mode"), "memo": rec["memo"],
                  "error": rec["error"], "rows": None if rec["rows"] is None
                  else len(rec["rows"]), "launches": got["launches"],
                  "kernel_shapes": got["shapes"],
                  "profile": got.get("profile"),
                  "python_top": got.get("python_top")})
            miss = differs(mode, sid, rec)
            if miss:
                bad.append(f"{mode} {miss}")
            by_query.setdefault(f"{phase} {mode} {sid}", {})[key] = \
                got["launches"]
            for kernel in counters:
                launches[key][kernel] += got["launches"][kernel]
    fgs_in = sorted({sid for run in runs.values() for sid, g in run.items()
                     if g["launches"]["fused_group_sums"]})
    bg_in = sorted({sid for run in runs.values() for sid, g in run.items()
                    if g["launches"]["block_gather"]})
    emit({"phase": f"{phase}_kernels", "fused_group_sums_in": fgs_in,
          "block_gather_in": bg_in, "card": card_line(),
          "seconds": {m: sum(g["ms"] + (g["warm_ms"] or 0.0)
                             for g in r.values()) / 1e3
                      for m, r in runs.items()}, **kernels_line})
    if bad:
        emit({"phase": f"{phase}_differences",
              "ids": [b.split(":")[0] for b in bad]})
        raise AssertionError("; ".join(bad[:5]))
    missing = [s for s in fused_ids if s not in fgs_in]
    if missing:
        raise AssertionError(f"{missing} launched no fused_group_sums")
    if not set(bg_in) & set(gather_ids):
        raise AssertionError(f"none of {gather_ids} launched block_gather")


def python_profile(session, sql, top=8):
    """The functions of most self time (cProfile; built-ins and torch
    calls included) in one warm run, for a run whose wall the device's
    busy time leaves mostly unexplained."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    prof.enable()
    session.sql(sql)
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats
    rows = [(f"{os.path.basename(f)}:{line}({fn})", tt * 1e3)
            for (f, line, fn), (_cc, _nc, tt, _ct, _callers) in stats.items()]
    rows.sort(key=lambda r: -r[1])
    return rows[:top]


def dec_segment_sum128_share(session, sql, busy_ms):
    """segment_sum128's time in one warm run of `sql` (its calls
    recorded, then each timed alone by CUDA events) and its share of the
    run's device busy time."""
    from presto_tpu_torch.exec import dec128 as D128

    real, calls = D128.segment_sum128, []

    def rec(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    D128.segment_sum128 = rec
    try:
        session.sql(sql)
    finally:
        D128.segment_sum128 = real
    ms = sum(cuda_ms(lambda a=a, k=k: real(*a, **k), iters=10)
             for a, k in calls)
    return {"calls": len(calls), "ms": ms,
            "share_of_busy": ms / busy_ms if isinstance(busy_ms, float)
            else "not measured"}


def phase_decimals(cat, capture, counters, launches, by_query):
    """The decimal corpus at SF1 on the card over the TPC-H tables of
    `cat`: the script once in "dynamic", "auto" and "compiled", each in
    a fresh session under the Capture (corpus_run), then a warm profiled
    run of each query of DEC_PROFILED (device busy and idle).  Every
    statement's record is held to presto_tpu's SF1 values
    (DEC_REFERENCE_SF1): rows with decimals exactly and floats within
    QUERY_RTOL, column types, the error of a statement that raises (type
    and message), execution mode, counters and memo entry.  One
    `decimals` line a statement and mode, one `decimals_segment_sum128`
    line (its share of N2's device time) and a `decimals_kernels` line
    (corpus_verdict): N7 and NG must launch fused_group_sums, N5 or N6
    block_gather."""
    from presto_tpu_torch import decimal_queries as DQ
    from presto_tpu_torch.exec.executor import SORT_STATS_KEYS

    tables = list(cat.tables.values())
    runs = {}
    for mode in DEC_MODES:
        session, runs[mode] = corpus_run(
            tables, mode, capture, counters, DQ.SCRIPT,
            lambda s, sid, sql: DQ.record(s, sid, sql, SORT_STATS_KEYS))
        for sid in DEC_PROFILED:
            runs[mode][sid]["profile"] = profile_run(
                session, DQ.statement(sid), top=4, host_top=4)
        if mode == "dynamic":
            runs[mode]["N2"]["python_top"] = python_profile(
                session, DQ.statement("N2"))
            busy = runs[mode]["N2"]["profile"].get("device_busy_ms")
            emit({"phase": "decimals_segment_sum128", "query": "N2",
                  "card": card_line(), "device_busy_ms": busy,
                  **dec_segment_sum128_share(session, DQ.statement("N2"),
                                             busy)})
        del session
    want = {mode: DQ.expand_reference(DEC_REFERENCE_SF1, mode)
            for mode in DEC_MODES}
    corpus_verdict("decimals", runs,
                   lambda mode, sid, rec: DQ.mismatch(
                       sid, rec, want[mode][sid], QUERY_RTOL),
                   counters, launches, by_query, DQ.FUSED_IDS,
                   DQ.GATHER_IDS)
    division_strings(cat)


# ---------------------------------------------------------------------------
# the functions_ext phase: the extended function corpus at SF1
# ---------------------------------------------------------------------------

FX_MODES = ("dynamic", "auto", "compiled")
#: the queries run once more warm in each mode (E2: its dynamic rerun
#: and its graph's replay)
FX_WARM_IDS = ("E2",)
#: binomial spread a TABLESAMPLE group count may lie from its mean
FX_SAMPLE_SIGMAS = 6.0


def fx_volatile(tables, mode, capture, counters, full_counts, n_lineitem):
    """E8 in one mode: two runs of each volatile text (the first under the
    Capture), held to their properties; returns its line and launches."""
    import torch

    import presto_tpu_torch
    from presto_tpu_torch import function_ext_queries as FQ

    session = presto_tpu_torch.connect(_fresh_catalog(tables),
                                       device="cuda", execution_mode=mode)
    runs, launches, ms = {}, {k: 0 for k in counters}, {}
    for qid, sql in FQ.VOLATILE.items():
        for fn in counters.values():
            fn.launches = 0
        got, times = [], []
        for i in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = capture.run(session, qid, sql, mode) if i == 0 \
                else session.sql(sql)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            got.append(res.rows)
            if i == 0:
                capture.check()
        for k, fn in counters.items():
            launches[k] += fn.launches
        runs[qid], ms[qid] = got, times
    bad = []

    def near(count, n, p=0.1):
        return abs(count - n * p) <= FX_SAMPLE_SIGMAS * math.sqrt(
            n * p * (1 - p))

    for rows in runs["E8a"]:
        for flag, count in rows:
            if not near(count, full_counts[flag]):
                bad.append(f"E8a {flag}: {count} of {full_counts[flag]}")
    for rows in runs["E8b"]:
        if not near(rows[0][0], n_lineitem):
            bad.append(f"E8b: {rows[0][0]} of {n_lineitem}")
    for rows in runs["E8c"]:
        uuids = {r[3] for r in rows}
        if not (len(rows) == 25 and all(0.0 <= r[1] < 1.0 and 0 <= r[2] < 10
                                        for r in rows)
                and len(uuids) == 25):
            bad.append(f"E8c: {rows[:3]}")
    for rows in runs["E8d"]:
        if any(sorted(r[1]) != list(range(1, 9)) for r in rows):
            bad.append(f"E8d: {rows[:2]}")
    for qid, (a, b) in runs.items():
        if a == b:
            bad.append(f"{qid}: two runs gave the same rows")
    return {"phase": "functions_ext_volatile", "mode": mode,
            "card": card_line(), "ms": ms, "launches": launches,
            "sample_counts": [runs["E8a"][0], runs["E8b"][0][0][0]],
            "memo_entries": len(getattr(session, "_compiled_cache", None)
                                or {}),
            "failures": bad}, launches


def fx_expected_decimal_rows() -> list:
    from decimal import Decimal

    return [[r[0], r[1], r[2]] + [Decimal(v) for v in r[3:]]
            for r in FX_DECIMAL_SF1]


def phase_functions_ext(cat, capture, counters, launches, by_query):
    """The extended function corpus at SF1 on the card over the TPC-H
    tables of `cat`, in "dynamic", "auto" and "compiled", each in a
    fresh session under the Capture (corpus_run; FX_WARM_IDS run once
    more warm), each query's record held to presto_tpu's SF1 values
    (FX_REFERENCE_SF1; E1's sine sums to their exact values,
    FX_E1_SIN_SF1; E9b's rows to Python's decimal, FX_DECIMAL_SF1,
    its memo to "DYNAMIC" outside "dynamic"), and E8's properties
    (fx_volatile).  One `functions_ext` line a query and mode, one
    `functions_ext_volatile` line a mode and a `functions_ext_kernels`
    line (corpus_verdict): E1 must launch fused_group_sums and E4
    block_gather."""
    import presto_tpu_torch
    from presto_tpu_torch import function_ext_queries as FQ
    from presto_tpu_torch.exec.executor import SORT_STATS_KEYS

    tables = list(cat.tables.values())
    probe = presto_tpu_torch.connect(cat, device="cuda",
                                     execution_mode="dynamic")
    full_counts = dict(probe.sql(
        "SELECT l_returnflag, count(*) FROM lineitem JOIN orders "
        "ON l_orderkey = o_orderkey GROUP BY l_returnflag").rows)
    n_lineitem = probe.sql("SELECT count(*) FROM lineitem").rows[0][0]
    del probe
    runs, bad = {}, []
    for mode in FX_MODES:
        session, runs[mode] = corpus_run(
            tables, mode, capture, counters, FQ.QUERIES.items(),
            lambda s, _qid, sql: FQ.record(s, sql, SORT_STATS_KEYS),
            FX_WARM_IDS, lambda rec, again: not FQ.mismatch(
                "", {**rec, "rows": FQ.values(again.rows)}, rec,
                QUERY_RTOL))
        del session
        row, vlaunch = fx_volatile(tables, mode, capture, counters,
                                   full_counts, n_lineitem)
        emit(row)
        bad += [f"{mode} {b}" for b in row["failures"]]
        key = "dynamic" if mode == "dynamic" else "compiled"
        by_query.setdefault(f"functions_ext {mode} E8", {})[key] = vlaunch
        for kernel in counters:
            launches[key][kernel] += vlaunch[kernel]
    want = {mode: FQ.expand_reference(FX_REFERENCE_SF1, mode)
            for mode in FX_MODES}
    col = FQ.E1_SIN_COLUMN
    for ref in want.values():
        rows = ref["E1"]["rows"]
        if [r[:2] for r in rows] != [e[:2] for e in FX_E1_SIN_SF1]:
            raise AssertionError("E1's groups are not FX_E1_SIN_SF1's")
        ref["E1"] = {**ref["E1"], "rows": [
            r[:col] + [e[2]] + r[col + 1:]
            for r, e in zip(rows, FX_E1_SIN_SF1)]}
    decimal_rows = fx_expected_decimal_rows()

    def differs(mode, qid, rec):
        if qid != "E9b":
            return FQ.mismatch(qid, rec, want[mode][qid], QUERY_RTOL)
        if rec["error"] is not None or FQ.decimal_math_values(
                rec["rows"]) != decimal_rows:
            return f"E9b: {rec['error'] or rec['rows']}"
        memo = [] if mode == "dynamic" else ["DYNAMIC"]
        return "" if rec["memo"] == memo else f"E9b memo {rec['memo']}"

    corpus_verdict("functions_ext", runs, differs, counters, launches,
                   by_query, FQ.FUSED_IDS, FQ.GATHER_IDS, bad,
                   E2_ms={m: [r["E2"]["ms"], r["E2"]["warm_ms"]]
                          for m, r in runs.items()})


# ---------------------------------------------------------------------------
# the zones_sketches phase: the time-zone and sketch corpus at SF1
# ---------------------------------------------------------------------------

ZS_MODES = ("dynamic", "auto", "compiled")
#: the phase's budget on the card (its `zones_sketches_total` line)
ZS_TARGET_SECONDS = 60.0
#: runs of Z6 (the session constants) a mode
ZS_VOLATILE_RUNS = 2
#: the queries profiled warm after the "dynamic" pass (busy and idle)
ZS_PROFILED = ("Z1", "Z2")
#: the SHA-256 of each zone's TZif file where ZS_REFERENCE_SF1 was
#: frozen (/usr/share/zoneinfo); the `zones` line says which files match
ZS_ZONE_SHA256 = {
    "America/New_York":
        "e9ed07d7bee0c76a9d442d091ef1f01668fee7c4f26014c0a868b19fe6c18a95",
    "Asia/Kolkata":
        "e90c341036cb7203200e293cb3b513267e104a39a594f35e195254e6bc0a17cf",
    "Australia/Lord_Howe":
        "2ee7f42f1fe2247ba1de465de0bc518dfdfab4b179fb05b650531534a353ee08",
    "Europe/Berlin":
        "5ee475f71a0fc1a32faeb849f8c39c6e7aa66d6d41ec742b97b3a7436b3b0701",
    "Asia/Kathmandu":
        "4d4796eeb0d289f3934ac371be8f628086197c621311951ffb4123825c910d6b",
    "Asia/Tokyo":
        "a02b9e66044dc5c35c5f76467627fdcba4aee1cc958606b85c777095cad82ceb",
}


def zone_files() -> dict:
    """Each named zone of the corpus: where its TZif file was found (a
    zoneinfo directory or the tzdata wheel), its SHA-256 and whether that
    is the frozen records' file (ZS_ZONE_SHA256).  A zone that resolves
    nowhere fails the phase: nothing falls back to UTC."""
    import hashlib

    from presto_tpu_torch import zone_sketch_queries as ZQ
    from presto_tpu_torch.functions import tzdb

    out = {}
    for zone in ZQ.ZONES:
        path = tzdb.tzif_path(zone)
        if path is None:
            raise AssertionError(f"no TZif file for {zone}")
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        root = path[:-len(zone)].rstrip("/")
        out[zone] = {"found_in": "tzdata wheel" if "tzdata" in root
                     else root, "sha256": digest,
                     "as_frozen": digest == ZS_ZONE_SHA256.get(zone)}
    return out


def zs_volatile(tables, mode) -> list:
    """Z6 in a fresh session (UTC) on the card: ZS_VOLATILE_RUNS runs held
    to their properties (zone_sketch_queries.volatile_faults) and a new
    memo entry each run outside "dynamic"; returns the faults."""
    import presto_tpu_torch
    from presto_tpu_torch import zone_sketch_queries as ZQ

    session = presto_tpu_torch.connect(_fresh_catalog(tables),
                                       device="cuda", execution_mode=mode)
    sql = ZQ.VOLATILE["Z6"]
    t0 = int(time.time() * 1e6)
    rows = [session.sql(sql).rows for _ in range(ZS_VOLATILE_RUNS)]
    bad = ZQ.volatile_faults(rows, t0, int(time.time() * 1e6))
    memo = [] if mode == "dynamic" else ["executable"] * ZS_VOLATILE_RUNS
    if ZQ.memo_state(session, sql) != memo:
        bad.append(f"Z6 memo {ZQ.memo_state(session, sql)}")
    return [f"{mode} Z6: {b}" for b in bad]


def phase_zones_sketches(cat, capture, counters, launches, by_query):
    """The time-zone and sketch corpus at SF1 on the card over the TPC-H
    tables of `cat`, in "dynamic", "auto" and "compiled", each in a fresh
    session under the Capture (corpus_run: the queries, then Z5's
    script), each record held to presto_tpu's SF1 values
    (ZS_REFERENCE_SF1: rows, blobs by their SHA-256, types, errors,
    execution mode, counters and memo entries; K2's weighted digest to
    ZS_K2_WEIGHTED_SF1), and Z6 to its
    properties (zs_volatile); ZS_PROFILED profiled warm in "dynamic"
    (device busy and idle).  A `zones` line first (zone_files), one
    `zones_sketches` line a query and mode, and a
    `zones_sketches_kernels` line (corpus_verdict): Z1, Z2 and K4 must
    launch fused_group_sums, Z3 or K5 block_gather."""
    from presto_tpu_torch import zone_sketch_queries as ZQ
    from presto_tpu_torch.exec.executor import SORT_STATS_KEYS

    emit({"phase": "zones", "files": zone_files()})
    tables = list(cat.tables.values())
    statements = list(ZQ.QUERIES.items()) + ZQ.SCRIPT
    runs, bad = {}, []
    for mode in ZS_MODES:
        session, runs[mode] = corpus_run(
            tables, mode, capture, counters, statements,
            lambda s, _sid, sql: ZQ.record(s, sql, SORT_STATS_KEYS))
        if mode == "dynamic":
            for sid in ZS_PROFILED:
                runs[mode][sid]["profile"] = profile_run(
                    session, ZQ.QUERIES[sid], top=4, host_top=4)
        del session
        bad += zs_volatile(tables, mode)
    want = {mode: ZQ.expand_reference(ZS_REFERENCE_SF1, mode)
            for mode in ZS_MODES}
    for ref in want.values():
        rows = ref["K2"]["rows"]
        if rows is None:
            continue
        if [r[0] for r in rows] != [w[0] for w in ZS_K2_WEIGHTED_SF1]:
            raise AssertionError("K2's groups are not ZS_K2_WEIGHTED_SF1's")
        held = []
        for r, w in zip(rows, ZS_K2_WEIGHTED_SF1):
            r = list(r)
            for c, v in zip(ZQ.K2_WEIGHTED_COLUMNS, w[1:]):
                r[c] = v
            held.append(r)
        ref["K2"] = {**ref["K2"], "rows": held}
    corpus_verdict("zones_sketches", runs,
                   lambda mode, sid, rec: ZQ.mismatch(
                       sid, rec, want[mode][sid], QUERY_RTOL),
                   counters, launches, by_query, ZQ.FUSED_IDS,
                   ZQ.GATHER_IDS, bad)


GM_TARGET_SECONDS = 90.0  # the geo_ml_f32 phase's budget on the card
#: M1's weights trained on the card's host against presto_tpu's frozen
#: ones: the same numpy, its BLAS on another machine (a product of 98,000
#: rows in another blocking order moves each weight by a few ulps of its
#: 300 gradient steps; 1e-9 of the largest weight leaves a factor of
#: 10^5 over that and is far below any weight's effect on a label)
GM_MODEL_RTOL = 1e-9


class _F32Launches:
    """fused_group_sums_cuda's f32-input launches, set and read as a
    kernel wrapper's count is (corpus_run sets every count to 0)."""

    @property
    def launches(self):
        from presto_tpu_torch.exec import kernels as K

        return K.fused_group_sums_cuda.launches_f32

    @launches.setter
    def launches(self, v):
        from presto_tpu_torch.exec import kernels as K

        K.fused_group_sums_cuda.launches_f32 = v


def _memory_tables(tables: dict) -> list:
    """geo_ml_queries' {name: (schema, columns)} as the port's memory
    tables."""
    from presto_tpu_torch import types as T
    from presto_tpu_torch.catalog import MemoryTable

    return [MemoryTable(name, {c: T.parse_type(t) for c, t in schema.items()},
                        cols) for name, (schema, cols) in tables.items()]


def gm_brute_force(tables) -> dict:
    """G1's count by brute force on the card (geo_ml_queries.
    brute_force_contains: boxes for the squares, a crossing count for the
    polygons), with its seconds."""
    import numpy as np
    import torch

    from presto_tpu_torch import geo_ml_queries as GQ

    t0 = time.perf_counter()
    x = np.ma.filled(tables["pts"][1]["x"], np.nan)
    xy = np.stack([x, tables["pts"][1]["y"]], axis=1)
    count = GQ.brute_force_contains(xy, GQ.square_boxes(tables),
                                    GQ.polygon_wkts(tables), 32_768, torch,
                                    "cuda")
    torch.cuda.synchronize()
    return {"count": count, "seconds": time.perf_counter() - t0}


def phase_geo_ml_f32(cat, capture, counters, launches, by_query):
    """The geospatial, ML and float32_compute corpus on the card
    (presto_tpu_torch/geo_ml_queries.py), each statement under the
    Capture (corpus_run; a warm run after the first, its rows held to the
    first's):

    - F32: TPC-H Q1, Q3, Q6 and Q18 at SF1 under float32_compute in
      "dynamic" and "compiled", held to presto_tpu's SF1 records
      (F32_REFERENCE_SF1: execution mode, counters and memo equal; rows
      within geo_ml_queries.f32_tolerance, Q6's revenue within 1.86e-5,
      and each float an f32 value exactly where presto_tpu's is);
    - G at geo_ml_queries.FULL (4,000,000 points, 10,000 regions) in
      "dynamic", "auto" and "compiled", held to presto_tpu's records
      (GEO_REFERENCE), and G1 to a brute-force count on the card;
    - M over the SF1 tables, `models` holding presto_tpu's M1 blobs, held
      to its records (ML_REFERENCE_SF1; M1's blobs by their weights,
      within GM_MODEL_RTOL, the card's host training with its own BLAS).

    One `geo_ml_f32` line a statement and mode (corpus_verdict), a
    `geo_ml_f32_kernels` line with fused_group_sums' f32-input launches
    apart, and the brute-force line.  Q1 must launch fused_group_sums'
    f32-input entry in both modes; G1, G2 or G3 block_gather."""
    import numpy as np

    from presto_tpu_torch import geo_ml_queries as GQ
    from presto_tpu_torch import types as T
    from presto_tpu_torch.catalog import MemoryTable
    from presto_tpu_torch.exec.executor import SORT_STATS_KEYS
    from presto_tpu_torch.tpch_queries import QUERIES

    counters = {**counters, "fused_group_sums_f32in": _F32Launches()}
    for mode in launches:
        launches[mode].setdefault("fused_group_sums_f32in", 0)
    n_li = cat.get("lineitem").row_count()
    tpch = list(cat.tables.values())

    def record(session, _sid, sql):
        return GQ.record(session, sql, SORT_STATS_KEYS)

    def same_rows(rec, result):
        return [[GQ.value(v) for v in r] for r in result.rows] == rec["rows"]

    runs = {mode: {} for mode in GQ.GEO_ML_MODES}
    f32_ids = [(f"Q{q}", QUERIES[q]) for q in GQ.F32_QUERIES]
    for mode in GQ.F32_MODES:
        _s, got = corpus_run(tpch, mode, capture, counters, f32_ids, record,
                             [sid for sid, _ in f32_ids], same_rows,
                             {"float32_compute": True})
        runs[mode].update(got)
    tables = GQ.geo_tables(GQ.FULL)
    geo = list(GQ.geo_queries(tables, GQ.FULL).items())
    geo_tables = _memory_tables(tables)
    for mode in GQ.GEO_ML_MODES:
        _s, got = corpus_run(geo_tables, mode, capture, counters, geo,
                             record, [sid for sid, _ in geo], same_rows)
        runs[mode].update(got)
    brute = gm_brute_force(tables)
    emit({"phase": "geo_ml_f32_brute_force", "card": card_line(), **brute})
    blobs = [b.encode() for b in ML_REFERENCE_SF1["dynamic"]["M1"]["blobs"]]
    schema, cols = GQ.models_table(blobs)
    models = MemoryTable("models", {c: T.parse_type(t)
                                    for c, t in schema.items()}, cols)
    ml = list(GQ.ML_QUERIES.items())
    for mode in GQ.GEO_ML_MODES:
        _s, got = corpus_run(tpch + [models], mode, capture, counters, ml,
                             record, ("M2",), same_rows)
        runs[mode].update(got)
    del tables, geo_tables

    want = {mode: {**(GQ.expand_reference(F32_REFERENCE_SF1, mode)
                      if mode in GQ.F32_MODES else {}),
                   **GQ.expand_reference(GEO_REFERENCE, mode),
                   **GQ.expand_reference(ML_REFERENCE_SF1, mode)}
            for mode in GQ.GEO_ML_MODES}

    def differs(mode, sid, rec):
        ref = want[mode][sid]
        if sid.startswith("Q"):
            return GQ.mismatch(sid, {**rec, "rows": None},
                               {**ref, "rows": None}) or GQ.f32_mismatch(
                int(sid[1:]), rec["rows"] or [], ref["rows"] or [], n_li)
        return GQ.mismatch(sid, rec, ref, QUERY_RTOL,
                           model_rtol=GM_MODEL_RTOL)

    report = {"f32": {}, "models": {}}
    for mode in GQ.F32_MODES:
        for sid, _sql in f32_ids:
            rec, ref = runs[mode][sid]["record"], want[mode][sid]
            report["f32"][f"{mode} {sid}"] = {
                "rows": rec["rows"] if sid == "Q6" else None,
                "max_rel_difference_and_bound": GQ.f32_differences(
                    int(sid[1:]), rec["rows"] or [], ref["rows"] or [],
                    n_li)}
    for mode in GQ.GEO_ML_MODES:
        rec, ref = runs[mode]["M1"]["record"], want[mode]["M1"]
        if rec.get("blobs") and ref.get("blobs"):
            report["models"][mode] = [GQ.model_difference(x, y) for x, y
                                      in zip(rec["blobs"], ref["blobs"])]
    emit({"phase": "geo_ml_f32_differences", "card": card_line(),
          "model_rtol": GM_MODEL_RTOL, **report})
    bad = []
    g1 = runs["dynamic"]["G1"]["record"]["rows"]
    if g1 != [[brute["count"]]]:
        bad.append(f"G1: {g1} against the brute-force {brute['count']}")
    f32_in = {mode: runs[mode]["Q1"]["launches"]["fused_group_sums_f32in"]
              for mode in GQ.F32_MODES}
    if not all(f32_in.values()):
        bad.append(f"Q1 launched no f32-input fused_group_sums: {f32_in}")
    corpus_verdict("geo_ml_f32", runs, differs, counters, launches,
                   by_query, ("Q1",), GQ.GATHER_IDS, bad,
                   fused_group_sums_f32in={
                       m: sum(g["launches"]["fused_group_sums_f32in"]
                              for g in r.values()) for m, r in runs.items()})


def division_strings(cat):
    """E10's strings (a DOUBLE column divided by 3, its round, truncate
    and log10, as VARCHAR) on the card in "dynamic" and "auto" against
    the port's CPU strings and presto_tpu's (FX_REFERENCE_SF1): a tensor
    divided by a host scalar on the card is one ulp off at times."""
    import presto_tpu_torch
    from presto_tpu_torch import function_ext_queries as FQ

    sql = FQ.QUERIES["E10"]
    cpu = presto_tpu_torch.connect(cat, device="cpu",
                                   execution_mode="dynamic").sql(sql).rows
    want = FQ.expand_reference(FX_REFERENCE_SF1, "dynamic")["E10"]["rows"]
    got = {mode: presto_tpu_torch.connect(
        cat, device="cuda", execution_mode=mode).sql(sql).rows
        for mode in ("dynamic", "auto")}
    row = {"phase": "division_strings", "card": card_line(),
           "rows": len(cpu), "cpu_equals_presto_tpu":
               FQ.values(cpu) == want}
    for mode, rows in got.items():
        row[f"{mode}_equals_cpu"] = rows == cpu
        row[f"{mode}_differences"] = [[a, b] for a, b in zip(rows, cpu)
                                      if a != b][:3]
    emit(row)
    if not (row["cpu_equals_presto_tpu"] and all(
            row[f"{m}_equals_cpu"] for m in got)):
        raise AssertionError(f"division strings differ: {row}")


def exact_group_sums(vals, gid, G):
    """[k, G] f64 numpy: each group's sum of each value row, correctly
    rounded (math.fsum on the host; f32 rows by exponent buckets)."""
    import numpy as np

    v, g = vals.cpu().numpy(), gid.cpu().numpy()
    if v.dtype == np.float32:
        return _exact_group_sums_f32(v, g, G)
    order = np.argsort(g, kind="stable")
    bounds = np.searchsorted(g[order], np.arange(G + 1))
    out = np.zeros((v.shape[0], G))
    for j in range(v.shape[0]):
        vj = v[j][order]
        for c in range(G):
            out[j, c] = math.fsum(vj[bounds[c]:bounds[c + 1]])
    return out


def _exact_group_sums_f32(v, g, G):
    """exact_group_sums of f32 rows without a Python step a value: the
    values of one frexp exponent e are multiples of 2^(e-24) below 2^e in
    magnitude, so fewer than 2^23 of them sum exactly in f64 in any order
    (one bincount a row over (group, exponent) slots); math.fsum then
    adds each group's few exponent sums, correctly rounded."""
    import numpy as np

    n = v.shape[1]
    if n >= 1 << 23:
        raise ValueError("more than 2^23 values a row: a bucket's sum "
                         "could round")
    out = np.zeros((v.shape[0], G))
    for j in range(v.shape[0]):
        x = v[j].astype(np.float64)
        e = np.frexp(x)[1]
        lo = int(e.min(initial=0))
        width = int(e.max(initial=0)) - lo + 1
        slots = np.bincount(g.astype(np.int64) * width + (e - lo), weights=x,
                            minlength=G * width).reshape(G, width)
        out[j] = [math.fsum(row) for row in slots]
    return out


def profile_run(session, sql, top=8, host_top=0):
    """Where one warm run's time goes: wall time, summed device kernel
    time (so the device's busy and idle shares of the wall) and the
    kernels that took most of it, from torch.profiler; with host_top,
    also the host operations of most self time; and the seconds the
    profile took."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        session.sql(sql)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    row = {"wall_ms": wall_ms}
    if busy_ms > 0:
        row["fgs_kernels_ms"] = sum(e.self_device_time_total for e in kernels
                                    if "fgs_" in e.key) / 1e3
        kernels.sort(key=lambda e: -e.self_device_time_total)
        row.update({
            "device_busy_ms": busy_ms, "device_idle_share":
                max(0.0, 1 - busy_ms / wall_ms),
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [[e.key[:80], e.count,
                             e.self_device_time_total / 1e3]
                            for e in kernels[:top]]})
    else:
        row["device_busy_ms"] = "not measured"
    if host_top:
        ops = [e for e in prof.key_averages()
               if e.device_type != DeviceType.CUDA]
        ops.sort(key=lambda e: -e.self_cpu_time_total)
        row["host_top"] = [[e.key[:60], e.count, e.self_cpu_time_total / 1e3]
                           for e in ops[:host_top]]
    # the whole profile's cost, the profiler's own work included
    row["profile_seconds"] = time.perf_counter() - t0
    return row


def phase_profile(session, qid, sql):
    """A profile of one warm run of a query in the dynamic executor."""
    emit({"phase": "profile", "query": label(qid),
          **profile_run(session, sql)})


def phase_bg_shapes(capture):
    """block_gather over every shape the queries gave it (Capture), in
    each timing (back-to-back `ms`, card alone `card_ms`): the summed
    time against the summed bound (the time-weighted share), the shapes
    below half their bound, and those slower than index_select where the
    bound is at least BG_MIN_COMPARED_MS."""
    rows = [(q, r) for q, r, _ in capture.bg_rows.values() if r.get("ms")]
    bound = sum(r["bound_ms"] for _, r in rows)

    def tag(q, r):
        return f"{q} ({r['n']}, {r['w']}, {r['m']})"

    out = {"phase": "block_gather_shapes", "shapes": len(rows),
           "sum_bound_ms": bound}
    for prefix, lib in (("", "library_ms"), ("card_", "library_card_ms")):
        key = prefix + "ms"
        ms = sum(r[key] for _, r in rows)
        out.update({
            f"sum_{key}": ms,
            f"{prefix}time_weighted_share": bound / ms if ms else None,
            f"sum_{lib}": sum(r[lib] for _, r in rows),
            f"{prefix}below_half_bound": [
                tag(q, r) for q, r in rows if r["bound_ms"] < 0.5 * r[key]],
            f"{prefix}slower_than_index_select": [
                tag(q, r) for q, r in rows
                if r["bound_ms"] >= BG_MIN_COMPARED_MS and r[key] > r[lib]]})
    emit(out)


def order_spec(session, sql):
    """(ORDER_KEYS entry, LIMIT) of a query from its optimized plan: the
    Sort or TopN under the Output (through Limits and Projects that pass
    the sort keys on), each key as (output column, 1 or -1).  Keys from
    the first one that is not an output column, or whose NULL order is
    not the default, are left out; no sort gives (None, None)."""
    from presto_tpu_torch.exec.executor import plan_statement
    from presto_tpu_torch.plan import ir
    from presto_tpu_torch.plan import nodes as P
    from presto_tpu_torch.sql.parser import parse

    root = plan_statement(session, parse(sql)).root
    columns = {sym: i for i, sym in enumerate(root.symbols)}
    node, limit = root.source, None
    while True:
        if isinstance(node, P.Limit):
            limit = node.count if limit is None else min(limit, node.count)
        elif isinstance(node, P.Project):
            # an output symbol that passes a source symbol on
            columns = {e.name: columns[sym]
                       for sym, e in node.assignments.items()
                       if isinstance(e, ir.Ref) and sym in columns}
        elif isinstance(node, (P.Sort, P.TopN)):
            break
        else:
            return None, None
        node = node.source
    if isinstance(node, P.TopN):
        limit = node.count if limit is None else min(limit, node.count)
    keys = []
    for sym, asc, nulls_first in node.keys:
        if sym not in columns or nulls_first not in (None, not asc):
            break
        keys.append((columns[sym], 1 if asc else -1))
    return (tuple(keys) or None), limit


def phase_raises_at_sf1(qid, sql, sessions):
    """A query presto_tpu cannot run at SF1 (DS_RAISES_AT_SF1): the card
    raises presto_tpu's error there, in both executors."""
    import presto_tpu_torch.exec.executor as E

    want = DS_RAISES_AT_SF1[qid]
    got = {}
    for mode in ("dynamic", "compiled"):
        try:
            sessions[mode, SF].sql(sql)
            got[mode] = "no error"
        except E.ExecutionError as e:
            got[mode] = f"{type(e).__name__}: {e}"
    emit({"phase": "raises_at_sf1", "query": f"ds{qid}", "sf": SF,
          "reference": want, **got})
    if any(v != want for v in got.values()):
        raise AssertionError(f"ds{qid} at SF1: {got}, presto_tpu: {want}")


def tpcds_row(name, sql, sessions, out, seconds):
    """The tpcds phase's line for one query: its card, rows, times in
    both executors (warm, replay, the graph alone by CUDA events),
    device busy and idle shares (for DS_PROFILED: a profiled warm
    dynamic run and a profiled replay), pool bytes, counters and memo
    beside presto_tpu's, launches of each kernel and the kernel shapes
    it reached."""
    missing = [k for k in ("warm_ms", "compiled_row", "compiled_counters")
               if k not in out]
    if missing:
        raise AssertionError(f"{name}: no {missing} (a step failed)")
    comp = out["compiled_row"]
    sf = out["sf"]
    prof = profile_run(sessions["dynamic", sf], sql, top=0) \
        if int(name[2:]) in DS_PROFILED else {"device_busy_ms": "not measured"}
    row = {"phase": "tpcds", "query": name, "card": card_line(), "sf": sf,
           "rows": len(out["rows"]),
           "matches_cpu_at_sf": CPU_CHECK_SF[name],
           "dynamic_warm_ms": out["warm_ms"],
           "compiled_replay_ms": out["replay_ms"],
           "compiled_graph": comp["graph"], "memo": comp["memo"],
           "reference_memo": comp["reference_memo"],
           "graph_device_ms": comp.get("graph_device_ms"),
           "pool_bytes": comp.get("pool_bytes"),
           "eager_ms": comp.get("eager_ms"),
           "capture_ms": comp.get("capture_ms"),
           "dynamic_profile": prof,
           "compiled_profile": {k: comp.get(k) for k in (
               "wall_ms", "device_busy_ms", "device_idle_share",
               "kernel_launches")},
           "counters": {"dynamic": out["dynamic_counters"],
                        "compiled": out["compiled_counters"]},
           "reference_counters": REFERENCE_COUNTERS[sf].get(name),
           "launches": {"dynamic": out["launches"],
                        "compiled": out.get("compiled_launches")},
           "fgs_paths": comp["fgs_paths"],
           "kernel_shapes": {
               "dynamic": sorted(set(map(tuple, out.get(
                   "dynamic_kernel_shapes", [])))),
               "compiled": sorted(set(map(tuple, comp["kernel_shapes"])))},
           "seconds": seconds}
    emit(row)
    return {**row, "compiled_top_kernels": comp.get("top_kernels")}


def phase_tpcds(capture, counters):
    """All 99 TPC-DS queries at SF1 (tpcds_catalog(1.0), nothing cut) on
    the card, each in the dynamic executor (phase_query: cold and warm
    runs, kernel shapes, rows against the port's CPU run in the dynamic
    executor at DS_CPU_CHECK_SF) and in
    compiled mode (phase_compiled: build, replays, rows against the
    dynamic run, memo entry against presto_tpu's), with the counters of
    both against presto_tpu's (phase_counters), at each scale of
    ds_scales, then one `tpcds` line (tpcds_row) of its first scale.
    The compiled sessions keep the memo's default bound.  Returns the
    launches of each kernel in each mode."""
    import torch

    import presto_tpu_torch
    from presto_tpu_torch.catalog import tpcds_catalog
    from presto_tpu_torch.exec import compile_cache as CC
    from presto_tpu_torch.tpcds_queries import QUERIES

    t_phase = time.perf_counter()
    cats = {sf: tpcds_catalog(sf) for sf in (SF, DS_CPU_CHECK_SF)}
    gen, nbytes = {}, 0
    t0 = time.perf_counter()
    for table in cats[SF].tables.values():
        t = time.perf_counter()
        data = table.read()
        gen[table.name] = [len(next(iter(data.values()))),
                           time.perf_counter() - t]
        # string columns at 8 bytes a value (a reference each)
        nbytes += sum(a.nbytes for a in data.values())
    emit({"phase": "generate", "benchmark": "tpcds", "sf": SF,
          "tables": gen, "host_bytes": nbytes,
          "seconds": time.perf_counter() - t0})
    sessions = {("dynamic", sf): presto_tpu_torch.connect(
        cat, device="cuda", execution_mode="dynamic")
        for sf, cat in cats.items()}
    sessions["cpu", DS_CPU_CHECK_SF] = presto_tpu_torch.connect(
        cats[DS_CPU_CHECK_SF], device="cpu", execution_mode="dynamic")
    sessions.update({("compiled", sf): presto_tpu_torch.connect(
        cat, device="cuda") for sf, cat in cats.items()})
    launches = {mode: {name: 0 for name in counters}
                for mode in ("dynamic", "compiled")}
    rows = {}
    for qid in DS_QUERIES:
        name, sql = f"ds{qid}", QUERIES[qid]
        t0 = time.perf_counter()
        CPU_CHECK_SF[name] = DS_CPU_CHECK_SF
        spec = guarded("tpcds", name, order_spec, sessions["dynamic", SF],
                       sql)
        if spec is None:
            continue
        ORDER_KEYS[name], limit = spec
        if limit is not None:
            LIMITS[name] = limit
        if qid in DS_RAISES_AT_SF1:
            guarded("tpcds", name, phase_raises_at_sf1, qid, sql, sessions)
        for i, sf in enumerate(ds_scales(qid)):
            out = {"cpu_runs_auto": False, "sf": sf}
            guarded("query", name, phase_query, name, sql, sessions,
                    capture, counters, out, DS_DYNAMIC_RUNS)
            guarded("compiled", name, phase_compiled, name, sql, sessions,
                    capture, counters, out, DS_COMPILED_REPLAYS,
                    qid in DS_PROFILED)
            if name in REFERENCE_COUNTERS[sf]:
                guarded("counters", name, phase_counters, name, out)
            if i == 0:
                row = guarded("tpcds", name, tpcds_row, name, sql, sessions,
                              out, time.perf_counter() - t0)
                if row is not None:
                    rows[qid] = row
            for mode, got in (("dynamic", out.get("launches")),
                              ("compiled", out.get("compiled_launches"))):
                for kernel in (got or {}):
                    launches[mode][kernel] += got[kernel]
    torch.cuda.synchronize()
    memo = sessions["compiled", SF]._compiled_cache

    def busy(q):
        prof = rows[q]["dynamic_profile"]
        return prof.get("device_busy_ms")

    slowest = sorted(rows, key=lambda q: -median(
        rows[q]["compiled_replay_ms"]))[:DS_TOP_REPLAYS]
    emit({"phase": "tpcds_summary", "card": card_line(), "sf": SF,
          "queries": len(DS_QUERIES), "lines": len(rows),
          "graphs": [q for q in rows if rows[q]["compiled_graph"]],
          "dynamic": {f"ds{q}": rows[q]["memo"] for q in rows
                      if not rows[q]["compiled_graph"]},
          "memo_bound_bytes": CC.memo_bound(sessions["compiled", SF]),
          "memo_entries": len(memo), "memo_bytes": memo.nbytes,
          "memo_evictions": memo.evictions,
          "memory_reserved": torch.cuda.memory_reserved(),
          "sum_pool_bytes": sum(r.get("pool_bytes") or 0
                                for r in rows.values()),
          "launches": launches,
          "graph_report": {f"ds{q}": {
              "graph_device_ms": rows[q]["graph_device_ms"],
              "pool_bytes": rows[q]["pool_bytes"],
              "dynamic_busy_ms": busy(q),
              "dynamic_warm_ms": rows[q]["dynamic_warm_ms"]}
              for q in DS_GRAPH_REPORT if q in rows},
          "slowest_replays": {f"ds{q}": {
              "replay_ms": rows[q]["compiled_replay_ms"],
              "top_kernels": rows[q]["compiled_top_kernels"]}
              for q in slowest},
          "seconds": time.perf_counter() - t_phase})
    for kernel in counters:
        if not any(launches[mode][kernel] for mode in launches):
            fail("tpcds", None, f"no TPC-DS query launched {kernel}")
    for s in list(sessions.values()):
        drop_memo(s)
    del sessions, cats
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import presto_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = card_line()
    emit({"phase": "device", "card": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})
    guarded("build", None, phase_build)
    if FAILED:  # nothing below runs without the kernels
        return finish(1, t0)
    guarded("kernel", None, phase_kernel)
    bg_rows = guarded("kernel", None, phase_block_gather)
    if "--kernels" in sys.argv[1:]:  # the kernel phases alone, no result
        emit({"phase": "total", "seconds": time.perf_counter() - t0,
              "failed": FAILED})
        return 1 if FAILED else 0
    from presto_tpu_torch.exec import gather as G
    from presto_tpu_torch.exec import kernels as K

    sm = torch.cuda.get_device_properties(0).multi_processor_count
    capture = Capture(sm)
    launches = guarded("slice", None, phase_slice, capture)
    gc.collect()
    torch.cuda.empty_cache()  # the TPC-H sessions' graphs and columns
    ds_launches = guarded("tpcds", None, phase_tpcds, capture,
                          {"fused_group_sums": K.fused_group_sums_cuda,
                           "block_gather": G.block_gather_cuda})
    guarded("block_gather_shapes", None, phase_bg_shapes, capture)
    q1_rows = {}  # by dtype: Q1's compiled shape, else its dynamic one
    for q, row, mode in capture.fgs_rows.values():
        if q == "Q1" and (mode == "compiled" or row["dtype"] not in q1_rows):
            q1_rows[row["dtype"]] = row
    if FAILED or not (bg_rows and len(q1_rows) == 2 and launches
                      and ds_launches):
        return finish(1, t0)
    kernels = []
    # each kernel at its main path's shape: the input Q1's compiled run
    # gives fused_group_sums (f64 rows, and f32 ones under
    # float32_compute: the f32-input entry), Q3's orders-at-lineitem
    # gather for block_gather; launches: the compiled runs of the 22
    # TPC-H queries, the relational, function, collection and other
    # corpora and the 99 TPC-DS queries, the f32-input entry's apart
    f32_launches = launches.get("fused_group_sums_f32in", 0)
    for name, src, replaces, row, n in (
            ("fused_group_sums", "fused_group_sums.cu",
             "presto_tpu/exec/kernels.py:1484", q1_rows["float64"],
             launches["fused_group_sums"] - f32_launches
             + ds_launches["compiled"]["fused_group_sums"]),
            ("fused_group_sums_f32in", "fused_group_sums.cu",
             "presto_tpu/exec/kernels.py:1558", q1_rows["float32"],
             f32_launches),
            ("block_gather", "block_gather.cu",
             "presto_tpu/exec/gather.py:160", bg_rows[0],
             launches["block_gather"]
             + ds_launches["compiled"]["block_gather"])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"presto_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": n,
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    return finish(0, t0, kernels)


def finish(rc: int, t0: float, kernels=None) -> int:
    """The last lines: the script's wall time since t0, the kernels'
    summary (when every phase passed), the card, then the contract line,
    or the list of the phases that failed (never the contract line
    after a failure)."""
    import torch

    emit({"phase": "total", "seconds": time.perf_counter() - t0,
          "failed": len(FAILED)})
    if kernels is not None:
        emit({"kernels": kernels})
    print(card_line(), flush=True)
    if rc or FAILED:
        emit({"ok": False, "failed": FAILED})
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
