"""Runs of the time-zone and sketch corpus (presto_tpu_torch/
zone_sketch_queries.py) in either package: each query of QUERIES in a
fresh session, the SCRIPT (Z5) in order in one session, over a catalog
of the package's TPC-H tables; and presto_tpu's values frozen at SF0.01
in tests/torch_zone_sketch_frozen.json.

`JAX_PLATFORMS=cpu python -m tests.torch_zone_sketch_common` rewrites
the frozen file (presto_tpu at SF0.01 in "dynamic", "auto" and
"compiled", about four minutes); `... torch_zone_sketch_common SF
ID[,ID...] [CACHE_DIR]` prints presto_tpu's values at scale factor SF as
one JSON line instead, each fact once
(zone_sketch_queries.compact_reference; "Z5" stands for the script):
chip_smoke.py's ZS_REFERENCE_SF1 came from it at SF 1, one query a
process.  `... torch_zone_sketch_common weighted SF` prints K2's
weighted-digest columns from presto_tpu's t-digest over the generated
columns, after checking that the port generates them as presto_tpu's
host generator does (zone_sketch_queries.weighted_digest_rows;
chip_smoke.py's ZS_K2_WEIGHTED_SF1).  `... torch_zone_sketch_common
host-times SF` prints the seconds of K2's host work (host_times).
"""

import json
import os
import sys

from presto_tpu_torch import zone_sketch_queries as ZQ
from presto_tpu_torch.exec.executor import SORT_STATS_KEYS

MODES = ("dynamic", "auto", "compiled")
FROZEN = os.path.join(os.path.dirname(__file__),
                      "torch_zone_sketch_frozen.json")
#: every record: the queries, then the script's statements
IDS = ZQ.REFERENCE_IDS + ("Z5",)


def session(pkg: str, catalog, mode: str, device: str = "cpu"):
    if pkg == "port":
        import presto_tpu_torch

        return presto_tpu_torch.connect(catalog, execution_mode=mode,
                                        device=device)
    import presto_tpu

    return presto_tpu.connect(catalog, execution_mode=mode)


def catalog(pkg: str, sf: float, cache_dir=None):
    if pkg == "port":
        from presto_tpu_torch.catalog import tpch_catalog

        return tpch_catalog(sf)
    from presto_tpu.catalog import tpch_catalog

    return tpch_catalog(sf, cache_dir)


def run(pkg: str, cat, mode: str, ids=IDS, device: str = "cpu") -> dict:
    """{id: record} of the queries, each in a fresh session, and of the
    script's statements ("Z5" in ids), in one."""
    out = {q: ZQ.record(session(pkg, cat, mode, device), ZQ.QUERIES[q],
                        SORT_STATS_KEYS) for q in ids if q != "Z5"}
    if "Z5" in ids:
        out.update(ZQ.run_script(session(pkg, cat, mode, device),
                                 SORT_STATS_KEYS))
    return out


def reference(sf: float, ids=IDS, cache_dir=None) -> dict:
    """presto_tpu's records {mode: {id: record}} at scale factor sf."""
    cat = catalog("ref", sf, cache_dir)
    return {mode: run("ref", cat, mode, ids) for mode in MODES}


def k2_columns(sf: float) -> dict:
    """lineitem's l_returnflag, l_extendedprice and l_quantity as the
    port generates them, checked bit for bit against presto_tpu's host
    generator (its device scan's prices may lie one ulp off, ROADMAP C)."""
    import numpy as np

    cols = ["l_returnflag", "l_extendedprice", "l_quantity"]
    mine = catalog("port", sf).get("lineitem").read(cols)
    theirs = catalog("ref", sf).get("lineitem").read(cols)
    for c in cols:
        a, b = np.asarray(mine[c]), np.asarray(theirs[c])
        same = np.array_equal(a.view(np.int64), b.view(np.int64)) \
            if a.dtype == np.float64 == b.dtype \
            else np.array_equal(a.astype(str), b.astype(str))
        if not same:
            raise AssertionError(f"{c}: the port's column is not "
                                 "presto_tpu's host-generated one")
    return mine


def weighted_rows(sf: float) -> list:
    """K2's weighted-digest columns over the generated columns, by
    presto_tpu's t-digest."""
    from presto_tpu.functions import tdigest

    d = k2_columns(sf)
    return ZQ.weighted_digest_rows(d["l_returnflag"], d["l_extendedprice"],
                                   d["l_quantity"], tdigest)


def host_times(sf: float, repeats: int = 3) -> dict:
    """Seconds of K2's host work at scale factor sf, best of `repeats`:
    each t-digest's two compress passes (tdigest_from_values) by the
    port's _compress and by presto_tpu's, over each l_returnflag group's
    quantities and its prices weighted by them, with the blobs compared;
    collections.rows_by_group over the groups; and its stable argsort of
    the group ids as int64 against the same sort of 16-bit keys."""
    import time

    import numpy as np

    from presto_tpu.functions import tdigest as RT
    from presto_tpu_torch.exec import collections as CL
    from presto_tpu_torch.functions import tdigest as PT

    d = k2_columns(sf)
    flags = np.asarray(d["l_returnflag"]).astype(str)
    _, gid = np.unique(flags, return_inverse=True)
    gid = gid.astype(np.int64)
    price = np.asarray(d["l_extendedprice"], np.float64)
    qty = np.asarray(d["l_quantity"], np.float64)
    c = PT.DEFAULT_COMPRESSION

    def best(fn):
        ts = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = fn()
            ts.append(time.perf_counter() - t0)
        return min(ts), out

    def digests(mod):
        out = []
        for g in range(gid.max() + 1):
            m = gid == g
            for vals, ws in ((qty[m], np.ones(int(m.sum()))),
                             (price[m], qty[m])):
                a, b = mod._compress(vals, ws, 2 * c)
                out.append(mod._compress(a, b, c))
        return out

    t_port, mine = best(lambda: digests(PT))
    t_ref, theirs = best(lambda: digests(RT))
    same = all(np.array_equal(a.view(np.int64), b.view(np.int64))
               for x, y in zip(mine, theirs) for a, b in zip(x, y))
    take = np.ones(len(gid), bool)
    t_rbg, _ = best(lambda: CL.rows_by_group(gid, take, 3))
    t_u16, o16 = best(lambda: np.argsort(gid.astype(np.uint16),
                                         kind="stable"))
    t_i64, o64 = best(lambda: np.argsort(gid, kind="stable"))
    return {"sf": sf, "rows": len(gid), "compress_port_s": t_port,
            "compress_presto_tpu_s": t_ref, "centroids_equal": same,
            "rows_by_group_s": t_rbg, "argsort_u16_s": t_u16,
            "argsort_i64_s": t_i64, "orders_equal": bool(
                np.array_equal(o16, o64))}


def frozen() -> dict:
    with open(FROZEN) as f:
        return json.load(f)


def _jsonable(obj):
    return json.loads(json.dumps(obj))


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    if len(sys.argv) > 1 and sys.argv[1] == "weighted":
        print(json.dumps(weighted_rows(float(sys.argv[2]))))
    elif len(sys.argv) > 1 and sys.argv[1] == "host-times":
        print(json.dumps(host_times(float(sys.argv[2]))))
    elif len(sys.argv) > 1:
        ids = tuple(sys.argv[2].split(",")) if len(sys.argv) > 2 else IDS
        got = reference(float(sys.argv[1]), ids,
                        sys.argv[3] if len(sys.argv) > 3 else None)
        print(json.dumps(ZQ.compact_reference(_jsonable(got))))
    else:
        got = ZQ.compact_reference(_jsonable(reference(0.01)))
        with open(FROZEN, "w") as f:
            json.dump(got, f, indent=0, sort_keys=True)
            f.write("\n")
