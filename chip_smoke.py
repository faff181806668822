"""Drive presto_tpu_torch's main path on one CUDA card and hold every
kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and nvcc.
It builds the kernels from presto_tpu_torch/csrc into build/, checks
each kernel at the shapes the main path gives it (and at edge shapes),
times it beside its plain version, its byte/operation bound and the one
PyTorch call that computes the same function, then runs TPC-H Q1 and Q6
at SF1 through `presto_tpu_torch.connect(...).sql(...)` and checks the
rows against a numpy computation from the generated columns and against
the same queries on the CPU.  Every phase prints one JSON line; the last
line is {"ok": true, "device": {...}}.  Any failure raises and exits
non-zero, and without a CUDA device it exits 2 before printing a result.
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
QUERY_RTOL = 1e-9    # sums/averages across packages, devices, orders
# fused_group_sums shapes: Q1 at SF1 (k=15 rows of sums, 4 groups), a
# group count that forces the shared-memory tiling, a single group, and
# an empty input
FGS_SHAPES = [(15, 6_000_601, 4), (8, 1_000_003, 4096), (2, 8_191, 1),
              (3, 0, 4)]


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

    t0 = time.perf_counter()
    cuda_build.build_all(["fused_group_sums"])
    info = cuda_build.build_info.get("fused_group_sums", {})
    ptxas = [ln.strip() for ln in info.get("log", "").splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": info.get("seconds"), "ptxas": ptxas})


def fgs_inputs(k, n, G, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    vals = torch.rand((k, n), dtype=torch.float64, device="cuda",
                      generator=g) * 1e4
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


def phase_kernel():
    import torch

    from presto_tpu_torch.exec import kernels as K

    rows = []
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    for i, (k, n, G) in enumerate(FGS_SHAPES):
        vals, gid = fgs_inputs(k, n, G, seed=i)
        out = K.fused_group_sums(vals, gid, G)
        plain = K.fused_group_sums_plain(vals, gid, G)
        torch.cuda.synchronize()
        err = (out - plain).abs()
        max_abs = float(err.max()) if err.numel() else 0.0
        max_rel = float((err / plain.abs().clamp_min(1e-300)).max()) \
            if err.numel() else 0.0
        ok = bool(torch.all(err <= KERNEL_RTOL * plain.abs()))
        blocks, gtile = K.fused_group_sums_launch_shape(n, k, G, sm)
        row = {"k": k, "n": n, "groups": G, "max_abs_err": max_abs,
               "max_rel_err": max_rel, "ok": ok, "row_blocks": blocks,
               "group_tiles": -(-G // gtile), "smem_bytes": 8 * k * gtile}
        if n:
            iters = 20 if n > 100_000 else 200

            def library():
                return torch.zeros((k, G), dtype=torch.float64,
                                   device="cuda").index_add_(1, gid, vals)

            row["ms"] = cuda_ms(lambda: K.fused_group_sums(vals, gid, G),
                                iters)
            row["plain_ms"] = cuda_ms(
                lambda: K.fused_group_sums_plain(vals, gid, G), iters)
            row["library_ms"] = cuda_ms(library, iters)
            row["bound_ms"], row["bound_by"] = fgs_bound(k, n, G)
            row["roofline_share"] = row["bound_ms"] / row["ms"]
        emit({"phase": "kernel", "name": "fused_group_sums", **row})
        rows.append(row)
        if not ok:
            raise AssertionError(
                f"fused_group_sums disagrees with its plain version at "
                f"k={k} n={n} G={G}: max rel err {max_rel}")
        del vals, gid
    return rows


# ---- the slice: Q1 and Q6 through connect().sql() ---------------------------


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
    from presto_tpu_torch.exec import kernels as K
    from presto_tpu_torch.tpch_queries import QUERIES

    root = os.path.dirname(os.path.abspath(__file__))
    cat = tpch_catalog(SF, os.path.join(root, "build", "tpch_cache"))
    lineitem = cat.get("lineitem")
    t0 = time.perf_counter()
    cols = lineitem.read(["l_quantity", "l_extendedprice", "l_discount",
                          "l_tax", "l_returnflag", "l_linestatus",
                          "l_shipdate"])
    emit({"phase": "generate", "sf": SF, "table": "lineitem",
          "rows": len(cols["l_shipdate"]),
          "seconds": time.perf_counter() - t0})
    expected = {1: numpy_q1(cols), 6: numpy_q6(cols)}

    gpu = presto_tpu_torch.connect(cat, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path's run: counts from 0 just before, read just after
    K.fused_group_sums_cuda.launches = 0
    walls = {}
    rows = {}
    q1_launches = None
    for qid in (1, 6):
        times = []
        for rep in range(4):
            t = time.perf_counter()
            r = gpu.sql(QUERIES[qid])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            if qid == 1 and rep == 0:
                q1_launches = K.fused_group_sums_cuda.launches
            rows[qid] = r.rows
        walls[qid] = {"cold_ms": times[0], "warm_ms": times[1:]}
    launches = {"fused_group_sums": K.fused_group_sums_cuda.launches}
    peak = torch.cuda.max_memory_allocated()

    cpu = presto_tpu_torch.connect(cat, device="cpu")
    for qid in (1, 6):
        assert_rows_match(f"Q{qid} cuda vs numpy", rows[qid], expected[qid])
        assert_rows_match(f"Q{qid} cuda vs cpu", rows[qid],
                          cpu.sql(QUERIES[qid]).rows)
        emit({"phase": "slice", "query": f"Q{qid}", "sf": SF,
              "rows": len(rows[qid]), **walls[qid],
              "matches_numpy": True, "matches_cpu": True})
    if not q1_launches:
        raise AssertionError("Q1 on cuda never launched fused_group_sums")
    emit({"phase": "slice", "q1_fused_group_sums_launches": q1_launches,
          "peak_device_bytes": peak})
    for qid in (1, 6):
        phase_profile(gpu, qid, QUERIES[qid])
    return launches


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
    kernel_rows = phase_kernel()
    launches = phase_slice()
    q1 = kernel_rows[0]  # the main path's shape
    emit({"kernels": [{
        "name": "fused_group_sums", "route": "cuda",
        "source": "presto_tpu_torch/csrc/fused_group_sums.cu",
        "replaces": "presto_tpu/exec/kernels.py:1484",
        "launches": launches["fused_group_sums"],
        "max_abs_err": q1["max_abs_err"], "ms": q1["ms"],
        "plain_ms": q1["plain_ms"], "bound_ms": q1["bound_ms"],
        "bound_by": q1["bound_by"], "library_ms": q1["library_ms"]}]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
