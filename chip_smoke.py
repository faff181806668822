"""Drive presto_tpu_torch's main path on one CUDA card and hold every
kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc.
It builds the kernels from presto_tpu_torch/csrc into build/ (one nvcc
per source, started together), checks each kernel at synthetic shapes
(the main path's and edge shapes), times it beside its plain version,
its byte/operation bound and the one PyTorch call that computes the same
function, and launches fused_group_sums ten times a shape to see whether
its result is bit-identical.  fused_group_sums and its plain version are
also each held against the correctly rounded sums (math.fsum on the
host), so that the kernel's check does not rest on the plain version
alone.

Then it runs all 22 TPC-H queries at SF1 through
`presto_tpu_torch.connect(...).sql(...)`, four times each with the
kernels' launch counts set to 0 just before and read just after, and
once more with both kernels' inputs captured: at every (kernel, shape)
no earlier query reached, the kernel is held against its plain version
on that very input and timed.  Each query's rows must be identical in
the four runs wherever its f64 sums add in a fixed order (every sum but
fused_group_sums' shared-table path), and must agree with the port's own
CPU run (at SF1, or at SF0.1 where the CPU would take long; the card
then runs the query at SF0.1 too) under a tie-aware comparison: rows
whose ORDER BY keys agree within QUERY_RTOL compare as a multiset, and
at a LIMIT the rows tied with the last kept row may differ.  Q1, Q3, Q6
and Q18 are also held against numpy computations from the generated
columns.  segment_sum is held to bit identity in ten calls and to the
correctly rounded sums on the inputs of Q15 and Q3; the integer
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
    # half the indices dense over the first eighth of the rows (blocks
    # fit shared memory), half sparse over the rest (they do not)
    ("skewed", 8_000_000, 4, 2_000_000, "skewed"),
    ("span_beyond_budget", 16_000_000, 2, 4_096, "uniform"),
    ("m_not_multiple_of_ib", 100_000, 3, 1_000_003, "uniform"),
    ("one_source_row", 1, 5, 5_000, "uniform"),
    ("no_indices", 1_000, 4, 0, "uniform"),
]
# block_gather's shared-memory budget per thread block (KB), timed at the
# main path's four shapes; the port launches with G._SMEM_MAX_BYTES
SMEM_SWEEP_KB = (12, 24, 48, 96, 192)
SLICE_QUERIES = tuple(range(1, 23))
# the port's CPU run each card run is held against: SF1 where the CPU
# takes a few seconds, SF0.1 elsewhere
CPU_CHECK_SF = {q: SF if q in (1, 2, 6, 11, 16, 22) else 0.1
                for q in SLICE_QUERIES}
# each query's ORDER BY as (output column, 1 ascending or -1
# descending), and its LIMIT (tests/tpch_queries.py)
ORDER_KEYS = {
    1: ((0, 1), (1, 1)), 2: ((0, -1), (2, 1), (1, 1), (3, 1)),
    3: ((1, -1), (2, 1)), 4: ((0, 1),), 5: ((1, -1),),
    7: ((0, 1), (1, 1), (2, 1)), 8: ((0, 1),), 9: ((0, 1), (1, -1)),
    10: ((2, -1),), 11: ((1, -1),), 12: ((0, 1),), 13: ((1, -1), (0, -1)),
    15: ((0, 1),), 16: ((3, -1), (0, 1), (1, 1), (2, 1)),
    18: ((4, -1), (3, 1)), 20: ((0, 1),), 21: ((1, -1), (0, 1)),
    22: ((0, 1),)}
LIMITS = {2: 100, 3: 10, 10: 20, 18: 100, 21: 100}
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


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from presto_tpu_torch.exec import cuda_build

    names = ["fused_group_sums", "block_gather"]
    t0 = time.perf_counter()
    cuda_build.build_all(names)
    row = {"phase": "build", "seconds": time.perf_counter() - t0,
           "fgs_template_bounds": check_fgs_bounds()}
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


def bg_check(src, sidx):
    """block_gather on one input: byte-identical to its plain version,
    the share of its thread blocks that staged rows in shared memory
    (and that the reference's window check would have let through),
    and (m > 0) its time beside the plain version, index_select and the
    bound.  Raises when it differs."""
    import torch

    from presto_tpu_torch.exec import gather as G

    (n, w), m = src.shape, sidx.shape[0]
    staged = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = G.block_gather_cuda(src, sidx, staged_blocks=staged)
    plain = G.block_gather_plain(src, sidx)
    torch.cuda.synchronize()
    ok = out.shape == plain.shape and torch.equal(out, plain)
    ib = G._IB
    blocks = -(-m // ib)
    # the share of blocks whose indices the reference's aligned window
    # (presto_tpu/exec/gather.py:218-220) would have covered; the
    # reference runs its kernel only when all are
    W = G.window_rows(n, m)
    covered = None
    if W is not None and m >= ib:
        padded = torch.cat([sidx, sidx[-1:].expand((-m) % ib)])
        first, last = padded[::ib] // W, padded[ib - 1::ib]
        covered = float((last < (first + 1) * W).float().mean())
    row = {"n": n, "w": w, "m": m, "byte_identical": ok,
           "max_abs_err": 0.0 if ok else float("nan"),
           "smem_rows": G.smem_rows(w), "blocks": blocks,
           "staged_block_share": int(staged) / blocks if blocks else None,
           "reference_window_rows": W,
           "reference_covered_block_share": covered}
    if m:
        distinct = int(torch.unique_consecutive(sidx).numel())
        iters = 20 if m > 100_000 else 200
        row["ms"] = cuda_ms(lambda: G.block_gather_cuda(src, sidx), iters)
        row["plain_ms"] = cuda_ms(
            lambda: G.block_gather_plain(src, sidx), iters)
        # the one PyTorch call for this function is index_select,
        # which is also the plain version's call
        row["library_call"] = "torch.index_select (= the plain version)"
        row["library_ms"] = cuda_ms(
            lambda: torch.index_select(src, 0, sidx.long()), iters)
        row["bound_ms"], row["bound_by"] = bg_bound(n, w, m, distinct)
        row["roofline_share"] = row["bound_ms"] / row["ms"]
    if not ok:
        raise AssertionError(f"block_gather differs from its plain version "
                             f"at n={n} w={w} m={m}")
    return row


def phase_block_gather():
    rows = []
    for i, (name, n, w, m, how) in enumerate(BG_SHAPES):
        src, sidx = bg_inputs(n, w, m, how, seed=100 + i)
        row = {"shape": name, **bg_check(src, sidx)}
        if i < 4:  # the main path's shapes
            row["by_smem_budget_kb"] = sweep_smem_budget(
                src, sidx, 20 if m > 100_000 else 200)
        emit({"phase": "kernel", "name": "block_gather", **row})
        rows.append(row)
        del src, sidx
    phase_take_rows_routes()
    return rows


def sweep_smem_budget(src, sidx, iters):
    """block_gather's ms and staged-block share at each budget of
    SMEM_SWEEP_KB, on one input."""
    import torch

    from presto_tpu_torch.exec import gather as G

    blocks = -(-sidx.shape[0] // G._IB)
    saved = G._SMEM_MAX_BYTES
    out = {}
    try:
        for kb in SMEM_SWEEP_KB:
            G._SMEM_MAX_BYTES = kb * 1024
            staged = torch.zeros(1, dtype=torch.int32, device="cuda")
            G.block_gather_cuda(src, sidx, staged_blocks=staged)
            out[kb] = {"ms": cuda_ms(lambda: G.block_gather_cuda(src, sidx),
                                     iters),
                       "staged_block_share": int(staged) / blocks}
    finally:
        G._SMEM_MAX_BYTES = saved
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


def values_agree(a, b) -> bool:
    """Floats within QUERY_RTOL, everything else equal."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or math.isclose(a, b, rel_tol=QUERY_RTOL, abs_tol=0)
    return a == b


def rows_agree(ra, rb) -> bool:
    return len(ra) == len(rb) and all(values_agree(a, b)
                                      for a, b in zip(ra, rb))


def unmatched(actual, expected):
    """The expected rows that no distinct actual row agrees with."""
    left = list(actual)
    missing = []
    for r in expected:
        i = next((i for i, a in enumerate(left) if rows_agree(a, r)), None)
        if i is None:
            missing.append(r)
        else:
            del left[i]
    return missing


def in_order(ka, kb, dirs) -> bool:
    """Sort key ka comes before kb (or ties with it) under dirs."""
    for a, b, d in zip(ka, kb, dirs):
        if values_agree(a, b):
            continue
        return (a < b) if d > 0 else (a > b)
    return True


def assert_query_rows(what, qid, actual, expected):
    """Rows of one query against expected rows, tie-aware: consecutive
    expected rows whose ORDER BY keys agree within QUERY_RTOL form one
    group, which the actual rows at the same places must match as a
    multiset with the same key; at a LIMIT, the rows that tie with the
    last kept row may differ (only their key is held).  A query without
    ORDER BY is one multiset."""
    if len(actual) != len(expected):
        raise AssertionError(f"{what}: {len(actual)} rows, expected "
                             f"{len(expected)}")
    spec = ORDER_KEYS.get(qid)
    if spec is None:
        missing = unmatched(actual, expected)
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
        missing = unmatched(actual[lo:hi], expected[lo:hi])
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
    one extra run of a query.  At each (kernel, shape) not seen before it
    holds the kernel against its plain version on that very input and
    times it (fgs_check, bg_check); it notes the fused_group_sums paths
    the query takes, and keeps the largest float segment_sum input."""

    def __init__(self, sm):
        self.sm = sm
        self.fgs_rows = {}  # (k, n, G) -> (query, fgs_check row)
        self.bg_rows = {}  # (n, w, m) -> (query, bg_check row)

    def run(self, session, qid, sql):
        import torch

        from presto_tpu_torch.exec import gather as G
        from presto_tpu_torch.exec import kernels as K

        real = (K.fused_group_sums, G.block_gather, K.segment_sum)
        self.paths, self.seg = set(), None
        query = f"Q{qid}"

        def fgs(vals, gid, n_groups):
            out = real[0](vals, gid, n_groups)
            key = tuple(vals.shape) + (n_groups,)
            self.paths.add(K.fused_group_sums_launch_shape(
                key[1], key[0], n_groups, self.sm).path)
            if key not in self.fgs_rows:
                row = fgs_check(vals, gid, n_groups, self.sm)
                self.fgs_rows[key] = (query, row)
                emit({"phase": "kernel_at_query_shape", "query": query,
                      "name": "fused_group_sums", **row})
            return out

        def bg(src, sidx):
            out = real[1](src, sidx)
            key = tuple(src.shape) + (sidx.shape[0],)
            if key not in self.bg_rows:
                row = bg_check(src, sidx)
                self.bg_rows[key] = (query, row)
                emit({"phase": "kernel_at_query_shape", "query": query,
                      "name": "block_gather", **row})
            return out

        def seg(x, gid, n_groups, order=None):
            if x.is_floating_point() and (
                    self.seg is None or x.shape[0] > self.seg[0].shape[0]):
                self.seg = (x.clone(), gid.clone(), n_groups)
            return real[2](x, gid, n_groups, order)

        K.fused_group_sums, G.block_gather, K.segment_sum = fgs, bg, seg
        try:
            session.sql(sql)
            torch.cuda.synchronize()
        finally:
            K.fused_group_sums, G.block_gather, K.segment_sum = real


def phase_query(qid, sql, sessions, capture, counters, out):
    """One query of the main path: four runs on the card with every
    kernel's launch count set to 0 just before and read just after, one
    captured run (each kernel at each new shape, see Capture), then its
    rows: identical in the four runs where the query's f64 sums are
    deterministic by design, and agreeing with the port's CPU run (and,
    for Q1, Q3, Q6 and Q18, with numpy) under the tie-aware comparison."""
    import torch

    gpu = sessions["cuda", SF]
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runs, times = [], []
    for _ in range(4):
        t = time.perf_counter()
        runs.append(gpu.sql(sql).rows)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    out["launches"] = launches
    capture.run(gpu, qid, sql)
    out["fgs_paths"] = sorted(capture.paths)
    if capture.seg is not None:
        out["segment_sum_input"] = capture.seg
    rows = runs[0]
    identical = all(r == rows for r in runs[1:])
    # the register path of fused_group_sums and segment_sum add in a
    # fixed order; the shared-table path adds with atomics
    by_design = "shared_table" not in capture.paths
    row = {"phase": "query", "query": f"Q{qid}", "sf": SF, "rows": len(rows),
           "cold_ms": times[0], "warm_ms": times[1:],
           "launches_in_4_runs": launches, "fgs_paths": out["fgs_paths"],
           "peak_device_bytes": peak, "runs_identical_of_4": identical,
           "identical_by_design": by_design}
    if by_design and not identical:
        raise AssertionError(f"Q{qid}: the card's rows differ between runs")
    sf = CPU_CHECK_SF[qid]
    t = time.perf_counter()
    on_cpu = sessions["cpu", sf].sql(sql).rows
    row["cpu_check_seconds"] = time.perf_counter() - t
    on_gpu = rows if sf == SF else sessions["cuda", sf].sql(sql).rows
    assert_query_rows(f"Q{qid} cuda vs cpu at SF{sf}", qid, on_gpu, on_cpu)
    row["matches_cpu_at_sf"] = sf
    if qid in out["numpy"]:
        assert_query_rows(f"Q{qid} cuda vs numpy", qid, rows,
                          out["numpy"][qid])
    row["matches_numpy"] = qid in out["numpy"] or "not checked"
    emit(row)


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

    row = {"phase": "segment_sum", "query": f"Q{qid}", "n": x.shape[0],
           "live_rows": int(live.sum()), "groups": G, "dtype": str(x.dtype),
           f"bit_identical_in_{SEGMENT_SUM_REPEATS}": same,
           "max_rel_err_vs_exact": rel,
           "ms": cuda_ms(lambda: K.segment_sum(x, gid, G), 10),
           "index_add_ms": cuda_ms(one_index_add, 10)}
    emit(row)
    if not same:
        raise AssertionError(f"segment_sum gave different bits in "
                             f"{SEGMENT_SUM_REPEATS} calls at Q{qid}'s input")
    if not within:
        raise AssertionError(f"segment_sum is {rel} off the correctly "
                             f"rounded sums at Q{qid}'s input")


def phase_surface(sessions):
    """The fault C1 query, a SELECT without FROM and a DISTINCT aggregate
    on the card, against the port's CPU run at SF1."""
    rows = {}
    for name, sql in SURFACE.items():
        on_gpu = sessions["cuda", SF].sql(sql).rows
        on_cpu = sessions["cpu", SF].sql(sql).rows
        if on_gpu != on_cpu:
            raise AssertionError(f"{name}: cuda {on_gpu[:3]} != cpu "
                                 f"{on_cpu[:3]}")
        rows[name] = on_gpu[:3]
    if any(r[1:] != (-2, None, 2, -1) for r in rows["c1"]):
        raise AssertionError(f"c1: {rows['c1']} are not the reference's "
                             "(x, -2, None, 2, -1)")
    emit({"phase": "surface", "rows": rows, "matches_cpu": True})


def phase_slice(capture):
    """All 22 TPC-H queries at SF1 through connect().sql() on the card."""
    import presto_tpu_torch
    from presto_tpu_torch.catalog import tpch_catalog
    from presto_tpu_torch.exec import gather as G
    from presto_tpu_torch.exec import kernels as K
    from presto_tpu_torch.tpch_queries import QUERIES

    root = os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(root, "build", "tpch_cache")
    cats = {sf: tpch_catalog(sf, cache) for sf in sorted(
        set(CPU_CHECK_SF.values()) | {SF})}
    sessions = {(dev, sf): presto_tpu_torch.connect(cat, device=dev)
                for sf, cat in cats.items() for dev in ("cuda", "cpu")}
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
    launches = {name: 0 for name in counters}
    by_query = {}
    segment_inputs = {}
    for qid in SLICE_QUERIES:
        out = {"numpy": expected}
        guarded("query", f"Q{qid}", phase_query, qid, QUERIES[qid],
                sessions, capture, counters, out)
        if "launches" in out:
            by_query[f"Q{qid}"] = out["launches"]
            for name in counters:
                launches[name] += out["launches"][name]
        if qid in SEGMENT_SUM_QUERIES and "segment_sum_input" in out:
            segment_inputs[qid] = out["segment_sum_input"]
    emit({"phase": "slice", "launches": launches,
          "launches_by_query": by_query})
    for qid in SEGMENT_SUM_QUERIES:
        if qid not in segment_inputs:
            fail("segment_sum", f"Q{qid}",
                 f"Q{qid} gave segment_sum no float input")
            continue
        guarded("segment_sum", f"Q{qid}", phase_segment_sum, qid,
                *segment_inputs.pop(qid))
    guarded("surface", None, phase_surface, sessions)
    for qid in SLICE_QUERIES:
        guarded("profile", f"Q{qid}", phase_profile, sessions["cuda", SF],
                qid, QUERIES[qid])
    for name, fn in (("fused_group_sums", K.fused_group_sums_cuda),
                     ("block_gather", G.block_gather_cuda)):
        if not launches[name]:
            fail("slice", None, f"no query on cuda launched {name}")
    return launches


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


def phase_profile(session, qid, sql, top=8):
    """Where a warm query's time goes: wall time, summed device kernel
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
    row = {"phase": "profile", "query": f"Q{qid}", "wall_ms": wall_ms}
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
    emit(row)


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
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    capture = Capture(sm)
    launches = guarded("slice", None, phase_slice, capture)
    q1_rows = [row for q, row in capture.fgs_rows.values() if q == "Q1"]
    if FAILED or not (bg_rows and q1_rows and launches):
        return finish(1, t0)
    kernels = []
    # each kernel at its main path's shape: the input one Q1 run gives
    # fused_group_sums, Q3's orders-at-lineitem gather for block_gather
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
