"""Host time of presto_tpu_torch's collection fast paths, on and off.

Runs C1, C4 and C8 of presto_tpu_torch/collection_queries.py at TPC-H
SF1 in the dynamic executor on the card, cold (every dictionary's kept
per-entry results dropped first, as on a query's first run) and warm,
under each of these variants of functions/scalar.py:

- `all`: as shipped;
- `no_native_order`: _canonical_order always takes the repr pre-sort
  and the _tuple_cmp sort, never Python's own tuple order;
- `no_head_key`: repr_order is sorted(key=repr) over whole tuples;
- `none`: both off.

Each variant's rows must equal the `all` run's (the fast paths give the
loops' values, in the loops' order).  Prints one JSON line per (query,
variant) with cold and warm wall ms, then the card's name and power
limit.  Run from the repository root, on a machine with a card:

    python3 tools/torch_collection_host_paths.py [--sf 1] [--warm 2]
        [--queries C1,C4,C8]
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FAST_PATHS = ("native_order", "head_key")
# each variant with the fast paths it switches off; `all` runs first and
# last, to show drift over the call
VARIANTS = {"all": (), **{f"no_{p}": (p,) for p in FAST_PATHS},
            "none": FAST_PATHS}
ORDER = ("all", "no_native_order", "no_head_key", "none", "all")


@contextlib.contextmanager
def variant(name):
    """The fast paths of `name` switched off for the block."""
    from presto_tpu_torch.exec import collections as C
    from presto_tpu_torch.functions import scalar as S

    saved = S._natively_ordered, S.repr_order, C.repr_order
    off = VARIANTS[name]
    if "native_order" in off:
        S._natively_ordered = lambda uniq: False
    if "head_key" in off:
        S.repr_order = C.repr_order = lambda uniq: sorted(uniq, key=repr)
    try:
        yield
    finally:
        S._natively_ordered, S.repr_order, C.repr_order = saved


def drop_kept_results():
    """Empty every dictionary's kept per-entry results (Dictionary.derived),
    as they are before a query first reads the dictionary."""
    from presto_tpu_torch.batch import Dictionary

    for obj in gc.get_objects():
        if type(obj) is Dictionary:
            obj._derived.clear()


def timed(session, sql):
    import torch

    t = time.perf_counter()
    rows = session.sql(sql).rows
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3, rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--queries", default="C1,C4,C8")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import presto_tpu_torch
    from presto_tpu_torch.catalog import tpch_catalog
    from presto_tpu_torch.collection_queries import QUERIES

    cat = tpch_catalog(args.sf, os.path.join(ROOT, "build", "tpch_cache"))
    session = presto_tpu_torch.connect(cat, device="cuda",
                                       execution_mode="dynamic")
    names = args.queries.split(",")
    expected = {}
    for name in names:  # loads the tables and builds the kernels
        expected[name] = timed(session, QUERIES[name])[1]
    for name in names:
        for v in ORDER:
            with variant(v):
                drop_kept_results()
                cold, rows = timed(session, QUERIES[name])
                warm = [timed(session, QUERIES[name]) for _ in
                        range(args.warm)]
            same = rows == expected[name] and all(
                r == expected[name] for _, r in warm)
            print(json.dumps({"query": name, "variant": v, "sf": args.sf,
                              "cold_ms": cold,
                              "warm_ms": [ms for ms, _ in warm],
                              "rows_equal_all": same}), flush=True)
            if not same:
                print(f"{name} {v}: rows differ", file=sys.stderr)
                return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
