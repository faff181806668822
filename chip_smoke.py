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
that torch.cumsum adds on the card in an order that may vary, within a
tolerance from the magnitude of the prefix, FLOAT_PREFIX_QUERIES), its
counters and memo entries against presto_tpu's SF1 values, and prints
one `relational` line a query: warm and replay times, device busy and
idle shares, the top device operations for W1, J1 and S2, and the
kernel shapes each query reached.
segment_sum is held to bit identity in ten calls and to the correctly
rounded sums on the inputs of Q15 and Q3; the integer
division fault C1, a SELECT without FROM and a DISTINCT aggregate run on
the card against the CPU; a profile of each query gives its device busy
and idle shares.  No check reads a time.

Every phase prints one JSON line.  A phase that fails prints one JSON
line with its name, its query, the exception and its traceback's tail
(to stdout and stderr); the other phases still run, and the script then
ends with {"ok": false, "failed": [...]} and exit code 1.  Otherwise its
last lines are its own wall time, the kernels' summary, the card's name
and power limit, and {"ok": true, "device": {...}}.  Without a CUDA
device it exits 2 before printing a result.
"""

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
KERNEL_RTOL = 1e-12  # kernel vs plain version, f64: summation order only
# fused_group_sums' kernel and plain version each vs the correctly
# rounded sums: a two-level f64 sum of positive values is off by about
# 1e-14 (one chain of 2.9M adds, as one index_add_ does, by 2.8e-12)
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
DYNAMIC_RUNS = 3  # runs of each query in the dynamic executor
COMPILED_REPLAYS = 3  # replays of each query's graph after its first run
# the relational corpus (presto_tpu_torch/relational_queries.py): window
# functions (W), set operations and grouping sets (S), FULL and CROSS
# joins (J)
RELATIONAL = ("W1", "W2", "W3", "W4", "W5", "W6", "S1", "S2", "S3", "S4",
              "J1", "J2", "J3")
# the port's CPU run each card run is held against: SF1 where the CPU
# takes a few seconds, SF0.1 elsewhere
CPU_CHECK_SF = {**{q: SF if q in (1, 2, 6, 11, 16, 22) else 0.1
                   for q in SLICE_QUERIES},
                **{n: 0.1 if n in ("W1", "W2") else SF for n in RELATIONAL}}
# queries whose float sums are prefix-sum differences (a window's running
# sum): torch.cumsum on the card adds in an order that may vary from run
# to run, so their rows need not be identical, and they agree with the
# CPU within PREFIX_ULPS_PER_SQRT_ROW * sqrt(n) ulps of the largest
# prefix (a running sum's rounding error grows as a random walk over the
# n rows it adds), computed from the column in the phase
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


def fgs_inputs(k, n, G, offset, seed):
    """vals [k, n] whose first element sits `offset` doubles into its
    buffer (a contiguous view), and gid [n], from a seeded generator."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    buf = torch.rand((k * n + offset,), dtype=torch.float64, device="cuda",
                     generator=g) * 1e4
    vals = buf[offset:].view(k, n)
    gid = torch.randint(0, G, (n,), dtype=torch.int32, device="cuda",
                        generator=g)
    return vals, gid


def fgs_bound(k, n, G):
    """(ms, what bounds it): the least time for the function, reading
    vals and gid once and writing the [k, G] result once, with one f64
    add per value."""
    byte_s = (k * n * 8 + n * 4 + k * G * 8) / HBM_BYTES_PER_S
    op_s = k * n / F64_FLOPS
    return max(byte_s, op_s) * 1e3, "bytes" if byte_s >= op_s else \
        "operations"


def rel_err(x, ref, rtol):
    """(max abs error, max relative error, every error within rtol of
    |ref|) of x against ref."""
    import torch

    err = (x - ref).abs()
    if not err.numel():
        return 0.0, 0.0, True
    return (float(err.max()),
            float((err / ref.abs().clamp_min(1e-300)).max()),
            bool(torch.all(err <= rtol * ref.abs())))


def fgs_check(vals, gid, G, sm):
    """fused_group_sums on one input: its launch plan, its error against
    the plain version, the kernel's and the plain version's errors
    against the correctly rounded sums, whether FGS_REPEATS launches
    agree bit for bit, and (n > 0) its time beside the plain version,
    index_add_ and the bound."""
    import torch

    from presto_tpu_torch.exec import kernels as K

    k, n = vals.shape
    plan = K.fused_group_sums_launch_shape(n, k, G, sm)
    out = K.fused_group_sums_cuda(vals, gid, G)
    plain = K.fused_group_sums_plain(vals, gid, G)
    same = all(torch.equal(out, K.fused_group_sums_cuda(vals, gid, G))
               for _ in range(FGS_REPEATS - 1))
    torch.cuda.synchronize()
    max_abs, max_rel, ok = rel_err(out, plain, KERNEL_RTOL)
    exact = torch.from_numpy(exact_group_sums(vals, gid, G)).cuda()
    vs_exact = {name: rel_err(x, exact, EXACT_RTOL)
                for name, x in (("kernel", out), ("plain", plain))}
    row = {"k": k, "n": n, "groups": G, "path": plan.path,
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
            return torch.zeros((k, G), dtype=torch.float64,
                               device="cuda").index_add_(1, gid, vals)

        row["ms"] = cuda_ms(lambda: K.fused_group_sums_cuda(vals, gid, G), iters)
        row["plain_ms"] = cuda_ms(
            lambda: K.fused_group_sums_plain(vals, gid, G), iters)
        row["library_ms"] = cuda_ms(library, iters)
        row["bound_ms"], row["bound_by"] = fgs_bound(k, n, G)
        row["roofline_share"] = row["bound_ms"] / row["ms"]
    if not ok:
        raise AssertionError(
            f"fused_group_sums disagrees with its plain version at "
            f"k={k} n={n} G={G}: max rel err {max_rel}")
    for name in ("kernel", "plain"):
        _, rel, within = vs_exact[name]
        if not within:
            raise AssertionError(
                f"fused_group_sums' {name} version is {rel} off the "
                f"correctly rounded sums at k={k} n={n} G={G}, beyond "
                f"{EXACT_RTOL}")
    if row["deterministic"] and not same:
        raise AssertionError(
            f"fused_group_sums' register path gave different bits in "
            f"{FGS_REPEATS} launches at k={k} n={n} G={G}")
    return row


def phase_kernel():
    import torch

    rows = []
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (k, n, G, offset) in enumerate(FGS_SHAPES):
        vals, gid = fgs_inputs(k, n, G, offset, seed=i)
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
        self.fgs_rows = {}  # (k, n, G) -> (query, fgs_check row, mode)
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
            key = tuple(vals.shape) + (n_groups,)
            self.paths.add(K.fused_group_sums_launch_shape(
                key[1], key[0], n_groups, self.sm).path)
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


def phase_query(qid, sql, sessions, capture, counters, out):
    """One query in the dynamic executor: DYNAMIC_RUNS runs on the card
    with every kernel's launch count set to 0 just before and read just
    after, one captured run (each kernel at each new shape, see
    Capture), then its rows: identical in every run where the query's
    f64 sums are deterministic by design, and agreeing with the port's
    CPU run (and, for Q1, Q3, Q6 and Q18, with numpy) under the
    tie-aware comparison."""
    import torch

    gpu = sessions["dynamic", SF]
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, times, sorts = [], [], []
    for _ in range(DYNAMIC_RUNS):
        t = time.perf_counter()
        result = gpu.sql(sql)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        runs.append(result.rows)
        sorts.append(sort_counters(result.stats))
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    out["launches"] = launches
    out["dynamic_counters"] = sorts[0]
    if any(c != sorts[0] for c in sorts[1:]):
        raise AssertionError(f"{label(qid)}: counters differ between runs: "
                             f"{sorts}")
    capture.run(gpu, qid, sql, "dynamic")
    out["dynamic_kernel_shapes"] = capture.shapes
    capture.check()
    out["fgs_paths"] = sorted(capture.paths)
    if capture.seg is not None:
        out["segment_sum_input"] = capture.seg
    rows = runs[0]
    out["rows"], out["warm_ms"] = rows, times[1:]
    out["dynamic_rows"] = rows
    identical = all(r == rows for r in runs[1:])
    # the register path of fused_group_sums and segment_sum add in a
    # fixed order; the shared-table path adds with atomics, and a float
    # prefix sum (torch.cumsum on the card) in an order that may vary
    by_design = "shared_table" not in capture.paths \
        and qid not in FLOAT_PREFIX_QUERIES
    row = {"phase": "query", "query": label(qid), "sf": SF, "rows": len(rows),
           "cold_ms": times[0], "warm_ms": times[1:],
           f"launches_in_{DYNAMIC_RUNS}_runs": launches,
           "fgs_paths": out["fgs_paths"],
           "peak_device_bytes": peak,
           f"runs_identical_of_{DYNAMIC_RUNS}": identical,
           "identical_by_design": by_design}
    if by_design and not identical:
        raise AssertionError(
            f"{label(qid)}: the card's rows differ between runs")
    sf = CPU_CHECK_SF[qid]
    t = time.perf_counter()
    on_cpu = sessions["cpu", sf].sql(sql)
    row["cpu_check_seconds"] = time.perf_counter() - t
    out["cpu_mode"] = on_cpu.stats.execution_mode
    out["cpu_memo"] = memo_entry(sessions["cpu", sf], sql)
    on_gpu = rows if sf == SF else sessions["dynamic", sf].sql(sql).rows
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
    against presto_tpu's (REFERENCE_COUNTERS_SF1)."""
    ref = REFERENCE_COUNTERS_SF1.get(qid, {})
    row = {"phase": "counters", "query": label(qid), "sf": SF,
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


def phase_compiled(qid, sql, sessions, capture, counters, out):
    """One query in compiled mode (the default) on the card: the first
    run builds it (compile_cache.build_graph: one eager static pass
    under torch's sync debug mode "error", then the capture of one CUDA
    graph, then a replay), with the kernels' launch counts set to 0 just
    before and read just after, each kernel held against its plain
    version at every shape not seen before (Capture, after the run);
    then COMPILED_REPLAYS replays, bit-identical wherever no captured
    launch took fused_group_sums' shared-table path, and equal to the
    card's dynamic run under the tie-aware comparison; the execution
    mode must be the port's CPU run's.  One more replay is profiled,
    and timed alone by CUDA events.  A capture failure raises here: it
    never falls back to the dynamic executor."""
    import torch

    from presto_tpu_torch.exec.executor import query_cache_key

    gpu = sessions["compiled", SF]
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
    row = {"phase": "compiled", "query": label(qid), "sf": SF,
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
    for _ in range(COMPILED_REPLAYS):
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
    row.update(profile_run(gpu, sql))
    identical = all(r == runs[0] for r in runs[1:])
    by_design = "shared_table" not in paths \
        and qid not in FLOAT_PREFIX_QUERIES
    row.update({f"replays_identical_of_{COMPILED_REPLAYS + 1}": identical,
                "identical_by_design": by_design})
    if by_design and not identical:
        raise AssertionError(f"{label(qid)}: compiled replays differ")
    if "rows" in out:
        assert_query_rows(f"{label(qid)} compiled vs dynamic on cuda", qid,
                          runs[0], out["rows"],
                          out.get("abs_tol", {}).get(SF, 0.0))
        row["matches_dynamic"] = True
    if "cpu_mode" in out:
        row["cpu_execution_mode"] = out["cpu_mode"]
        row["cpu_memo"] = out["cpu_memo"]
        if out["cpu_mode"] != row["execution_mode"]:
            raise AssertionError(
                f"{label(qid)}: execution mode {row['execution_mode']} "
                "on cuda, "
                f"{out['cpu_mode']} on the CPU")
        if CPU_CHECK_SF[qid] == SF and out["cpu_memo"] != row["memo"]:
            raise AssertionError(
                f"{label(qid)}: memo {row['memo']} on cuda, "
                f"{out['cpu_memo']} on "
                "the CPU")
    # a tripped guard reports "compiled" too: the memo tells them apart
    row["reference_memo"] = REFERENCE_MEMO_SF1[qid]
    if row["memo"] != REFERENCE_MEMO_SF1[qid]:
        raise AssertionError(f"{label(qid)}: memo {row['memo']} on cuda, "
                             f"{REFERENCE_MEMO_SF1[qid]} in presto_tpu")
    emit(row)
    out["compiled_row"] = row


def phase_segment_sum(qid, x, gid, G):
    """segment_sum on the float input one run of a query gives it:
    SEGMENT_SUM_REPEATS calls bit-identical, within EXACT_RTOL of the
    correctly rounded sums, timed beside one index_add_ (the atomic
    version it replaced)."""
    import torch

    from presto_tpu_torch.exec import kernels as K

    out = K.segment_sum(x, gid, G)
    same = all(torch.equal(out, K.segment_sum(x, gid, G))
               for _ in range(SEGMENT_SUM_REPEATS - 1))
    live = gid < G
    exact = torch.from_numpy(exact_group_sums(
        x[live][None], gid[live].to(torch.int32), G)[0]).cuda()
    _, rel, within = rel_err(out, exact, EXACT_RTOL)

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
    for qid in SLICE_QUERIES:
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


def exact_group_sums(vals, gid, G):
    """[k, G] f64 numpy: each group's sum of each value row, correctly
    rounded (math.fsum on the host)."""
    import numpy as np

    v, g = vals.cpu().numpy(), gid.cpu().numpy()
    order = np.argsort(g, kind="stable")
    bounds = np.searchsorted(g[order], np.arange(G + 1))
    out = np.zeros((v.shape[0], G))
    for j in range(v.shape[0]):
        vj = v[j][order]
        for c in range(G):
            out[j, c] = math.fsum(vj[bounds[c]:bounds[c + 1]])
    return out


def profile_run(session, sql, top=8):
    """Where one warm run's time goes: wall time, summed device kernel
    time (so the device's busy and idle shares of the wall) and the
    kernels that took most of it, from torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    capture = Capture(sm)
    launches = guarded("slice", None, phase_slice, capture)
    guarded("block_gather_shapes", None, phase_bg_shapes, capture)
    q1_rows = [row for q, row, mode in capture.fgs_rows.values()
               if q == "Q1" and mode == "compiled"]
    if FAILED or not (bg_rows and q1_rows and launches):
        return finish(1, t0)
    kernels = []
    # each kernel at its main path's shape: the input Q1's compiled run
    # gives fused_group_sums, Q3's orders-at-lineitem gather for
    # block_gather; launches: the compiled runs of the 22 queries
    for name, src, replaces, row in (
            ("fused_group_sums", "fused_group_sums.cu",
             "presto_tpu/exec/kernels.py:1484", q1_rows[0]),
            ("block_gather", "block_gather.cu",
             "presto_tpu/exec/gather.py:160", bg_rows[0])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"presto_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
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
