"""Drive presto_tpu_torch's main path on one CUDA card and hold every
kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc.
It builds the kernels from presto_tpu_torch/csrc into build/ (one nvcc
per source, started together), checks each kernel at the shapes the
main path gives it (and at edge shapes), times it beside its plain
version, its byte/operation bound and the one PyTorch call that computes
the same function, and launches fused_group_sums ten times a shape to
see whether its result is bit-identical.  fused_group_sums and its
plain version are also each held against the correctly rounded sums
(math.fsum on the host), so that the kernel's check does not rest on
the plain version alone.  Then it runs TPC-H Q1, Q6, Q3
and Q18 at SF1 through `presto_tpu_torch.connect(...).sql(...)`, checks
the rows against a numpy computation from the generated columns and
against the same queries on the CPU (Q1/Q6 at SF1, Q3/Q18 at SF0.1),
and holds fused_group_sums against its plain version on the very input
one Q1 run gives it (and against the correctly rounded sums there
too).  Every phase prints one JSON line; the last line
is {"ok": true, "device": {...}}.  Any failure raises and exits
non-zero; without a CUDA device it exits 2 before printing a result.
"""

import json
import math
import os
import subprocess
import sys
import time

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
SLICE_QUERIES = (1, 6, 3, 18)
CPU_CHECK_SF = {1: SF, 6: SF, 3: 0.1, 18: 0.1}


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


def fgs_check(vals, gid, G, sm, shown=None):
    """fused_group_sums on one input: its launch plan, its error against
    the plain version, the kernel's and the plain version's errors
    against the correctly rounded sums (and those of the `shown` {name:
    [k, G] sums}, reported only), whether FGS_REPEATS launches agree bit
    for bit, and (n > 0) its time beside the plain version, index_add_
    and the bound."""
    import torch

    from presto_tpu_torch.exec import kernels as K

    k, n = vals.shape
    plan = K.fused_group_sums_launch_shape(n, k, G, sm)
    out = K.fused_group_sums(vals, gid, G)
    plain = K.fused_group_sums_plain(vals, gid, G)
    same = all(torch.equal(out, K.fused_group_sums(vals, gid, G))
               for _ in range(FGS_REPEATS - 1))
    torch.cuda.synchronize()
    max_abs, max_rel, ok = rel_err(out, plain, KERNEL_RTOL)
    exact = torch.from_numpy(exact_group_sums(vals, gid, G)).cuda()
    vs_exact = {name: rel_err(x, exact, EXACT_RTOL)
                for name, x in (("kernel", out), ("plain", plain),
                                *(shown or {}).items())}
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

        row["ms"] = cuda_ms(lambda: K.fused_group_sums(vals, gid, G), iters)
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


def phase_block_gather():
    import torch

    from presto_tpu_torch.exec import gather as G

    rows = []
    for i, (name, n, w, m, how) in enumerate(BG_SHAPES):
        src, sidx = bg_inputs(n, w, m, how, seed=100 + i)
        staged = torch.zeros(1, dtype=torch.int32, device="cuda")
        out = G.block_gather_cuda(src, sidx, staged_blocks=staged)
        plain = G.block_gather_plain(src, sidx)
        torch.cuda.synchronize()
        ok = out.shape == plain.shape and torch.equal(out, plain)
        blocks = -(-m // G._IB)
        row = {"shape": name, "n": n, "w": w, "m": m, "byte_identical": ok,
               "max_abs_err": 0.0 if ok else float("nan"),
               "smem_rows": G.smem_rows(w), "blocks": blocks,
               "staged_block_share": int(staged) / blocks if blocks else None}
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
        if i < 4:  # the main path's shapes
            row["by_smem_budget_kb"] = sweep_smem_budget(src, sidx, iters)
        emit({"phase": "kernel", "name": "block_gather", **row})
        rows.append(row)
        if not ok:
            raise AssertionError(f"block_gather differs from its plain "
                                 f"version at {name} (n={n} w={w} m={m})")
        del src, sidx, out, plain
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


def assert_rows_match(what, actual, expected):
    if len(actual) != len(expected):
        raise AssertionError(f"{what}: {len(actual)} rows, expected "
                             f"{len(expected)}")
    for ra, re_ in zip(actual, expected):
        for va, ve in zip(ra, re_):
            if isinstance(va, float) or isinstance(ve, float):
                ok = math.isclose(va, ve, rel_tol=QUERY_RTOL, abs_tol=0)
            else:
                ok = va == ve
            if not ok:
                raise AssertionError(f"{what}: {ra} != {re_}")


def phase_slice():
    import torch

    import presto_tpu_torch
    from presto_tpu_torch.catalog import tpch_catalog
    from presto_tpu_torch.exec import gather as G
    from presto_tpu_torch.exec import kernels as K
    from presto_tpu_torch.tpch_queries import QUERIES

    root = os.path.dirname(os.path.abspath(__file__))
    cache = os.path.join(root, "build", "tpch_cache")
    cat = tpch_catalog(SF, cache)
    need = {"lineitem": ["l_quantity", "l_extendedprice", "l_discount",
                         "l_tax", "l_returnflag", "l_linestatus",
                         "l_shipdate", "l_orderkey"],
            "orders": ["o_orderkey", "o_custkey", "o_orderdate",
                       "o_shippriority", "o_totalprice"],
            "customer": ["c_custkey", "c_name", "c_mktsegment"]}
    cols = {}
    for table, names in need.items():
        t0 = time.perf_counter()
        cols[table] = cat.get(table).read(names)
        emit({"phase": "generate", "sf": SF, "table": table,
              "rows": len(cols[table][names[0]]),
              "seconds": time.perf_counter() - t0})
    li, o, c = cols["lineitem"], cols["orders"], cols["customer"]
    expected = {1: numpy_q1(li), 6: numpy_q6(li), 3: numpy_q3(c, o, li),
                18: numpy_q18(c, o, li)}

    counters = {"fused_group_sums": K.fused_group_sums_cuda,
                "block_gather": G.block_gather_cuda}
    gpu = presto_tpu_torch.connect(cat, device="cuda")
    walls = {}
    rows = {}
    launches = {name: 0 for name in counters}
    per_query = {}
    peaks = {}
    for qid in SLICE_QUERIES:
        # each query of the main path: counts from 0 just before, read
        # just after
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(4):
            t = time.perf_counter()
            r = gpu.sql(QUERIES[qid])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            rows[qid] = r.rows
        walls[qid] = {"cold_ms": times[0], "warm_ms": times[1:]}
        per_query[qid] = {name: fn.launches for name, fn in counters.items()}
        peaks[qid] = torch.cuda.max_memory_allocated()
        for name in counters:
            launches[name] += per_query[qid][name]

    cpu_cats = {SF: cat, 0.1: tpch_catalog(0.1, cache)}
    for qid in SLICE_QUERIES:
        assert_rows_match(f"Q{qid} cuda vs numpy", rows[qid], expected[qid])
        sf = CPU_CHECK_SF[qid]
        on_cpu = presto_tpu_torch.connect(cpu_cats[sf], device="cpu") \
            .sql(QUERIES[qid]).rows
        on_gpu = rows[qid] if sf == SF else presto_tpu_torch.connect(
            cpu_cats[sf], device="cuda").sql(QUERIES[qid]).rows
        assert_rows_match(f"Q{qid} cuda vs cpu at SF{sf}", on_gpu, on_cpu)
        emit({"phase": "slice", "query": f"Q{qid}", "sf": SF,
              "rows": len(rows[qid]), **walls[qid],
              "launches_in_4_runs": per_query[qid],
              "peak_device_bytes": peaks[qid],
              "matches_numpy": True, "matches_cpu_at_sf": sf})
    if not per_query[1]["fused_group_sums"]:
        raise AssertionError("Q1 on cuda never launched fused_group_sums")
    for qid in (3, 18):
        if not per_query[qid]["block_gather"]:
            raise AssertionError(f"Q{qid} on cuda never launched "
                                 "block_gather")
    emit({"phase": "slice", "launches": launches,
          "peak_device_bytes": max(peaks.values())})
    for qid in (3, 18):
        phase_launch_log(gpu, qid, QUERIES[qid])
    q1_row = phase_q1_input(gpu, QUERIES[1])
    for qid in SLICE_QUERIES:
        phase_profile(gpu, qid, QUERIES[qid])
    return launches, q1_row


def phase_q1_input(session, sql):
    """One more Q1 run with its fused_group_sums input captured, then the
    kernel held against its plain version and the correctly rounded sums
    on that input (the main path's real gid: skewed groups, masked rows
    in the last group)."""
    import torch

    from presto_tpu_torch.exec import kernels as K

    calls = []
    real = K.fused_group_sums

    def captured(vals, gid, n_groups):
        calls.append((vals.clone(), gid.clone(), n_groups))
        return real(vals, gid, n_groups)

    K.fused_group_sums = captured
    try:
        session.sql(sql)
    finally:
        K.fused_group_sums = real
    if len(calls) != 1:
        raise AssertionError(f"Q1 called fused_group_sums {len(calls)} "
                             "times, expected once")
    vals, gid, G = calls[0]
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    # shown beside them: one index_add_ over all rows, which adds each
    # group's rows in one chain and drifts by 1e-12 on this input
    one_chain = torch.zeros((vals.shape[0], G), dtype=torch.float64,
                            device="cuda").index_add_(1, gid, vals)
    row = fgs_check(vals, gid, G, sm, shown={"one_index_add_": one_chain})
    row["group_rows"] = torch.bincount(gid, minlength=G).tolist()
    emit({"phase": "kernel_q1_input", "name": "fused_group_sums", **row})
    if not row[f"bit_identical_in_{FGS_REPEATS}"]:
        raise AssertionError("fused_group_sums gave different bits in "
                             f"{FGS_REPEATS} launches on Q1's input")
    return row


def phase_launch_log(session, qid, sql):
    """One more run of a query with every block_gather call logged: its
    shape, the share of thread blocks that staged their rows in shared
    memory, and the share of blocks whose indices the reference's
    aligned window (presto_tpu/exec/gather.py:218-220) would have
    covered; the reference runs its kernel only when all are."""
    import torch

    from presto_tpu_torch.exec import gather as G

    log = []
    real = G.block_gather

    def logged(src, sidx):
        staged = torch.zeros(1, dtype=torch.int32, device=src.device)
        out = G.block_gather_cuda(src, sidx, staged_blocks=staged)
        (n, w), m, ib = src.shape, sidx.shape[0], G._IB
        W = G.window_rows(n, m)
        covered = None
        if W is not None and m >= ib:
            padded = torch.cat([sidx, sidx[-1:].expand((-m) % ib)])
            first, last = padded[::ib] // W, padded[ib - 1::ib]
            covered = float((last < (first + 1) * W).float().mean())
        log.append({"n": n, "w": w, "m": m,
                    "staged_block_share": int(staged) / -(-m // ib),
                    "reference_window_rows": W,
                    "reference_covered_block_share": covered})
        return out

    G.block_gather = logged
    try:
        session.sql(sql)
    finally:
        G.block_gather = real
    emit({"phase": "launch_log", "query": f"Q{qid}",
          "block_gather_calls": log})


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
    phase_build()
    phase_kernel()
    bg_rows = phase_block_gather()
    launches, q1_row = phase_slice()
    kernels = []
    # each kernel at its main path's shape: the input one Q1 run gives
    # fused_group_sums, Q3's orders-at-lineitem gather for block_gather
    for name, src, replaces, row in (
            ("fused_group_sums", "fused_group_sums.cu",
             "presto_tpu/exec/kernels.py:1484", q1_row),
            ("block_gather", "block_gather.cu",
             "presto_tpu/exec/gather.py:160", bg_rows[0])):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"presto_tpu_torch/csrc/{src}", "replaces": replaces,
            "launches": launches[name], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]})
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
