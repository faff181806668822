"""Runs of the extended function corpus (presto_tpu_torch/
function_ext_queries.py) in either package, each query in a fresh
session over a catalog of the package's TPC-H tables, and presto_tpu's
values frozen at SF0.01 in tests/torch_functions_ext_frozen.json.

`JAX_PLATFORMS=cpu python -m tests.torch_functions_ext_common` rewrites
the frozen file (presto_tpu at SF0.01 in "dynamic", "auto" and
"compiled", about four minutes); `... torch_functions_ext_common SF
QID[,QID...] [CACHE_DIR]` prints presto_tpu's values at scale factor SF
as one JSON line instead, each fact once
(function_ext_queries.compact_reference): chip_smoke.py's
FX_REFERENCE_SF1 came from it at SF 1, one query a process.
`... torch_functions_ext_common decimal SF` prints E9b's rows from
Python's decimal over the port's generated columns (chip_smoke.py's
FX_DECIMAL_SF1), `... sin SF` E1's exact sine sums
(function_ext_queries.exact_sin_sums; chip_smoke.py's FX_E1_SIN_SF1).
"""

import json
import os
import sys

from presto_tpu_torch import function_ext_queries as FQ
from presto_tpu_torch.exec.executor import SORT_STATS_KEYS

MODES = ("dynamic", "auto", "compiled")
FROZEN = os.path.join(os.path.dirname(__file__),
                      "torch_functions_ext_frozen.json")
#: the queries whose records are frozen (E9b raises in presto_tpu)
IDS = FQ.REFERENCE_IDS + ("E9b",)


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
    """{qid: record} of the queries, each in a fresh session."""
    return {q: FQ.record(session(pkg, cat, mode, device), FQ.QUERIES[q],
                         SORT_STATS_KEYS) for q in ids}


def reference(sf: float, ids=IDS, cache_dir=None) -> dict:
    """presto_tpu's records {mode: {qid: record}} at scale factor sf."""
    cat = catalog("ref", sf, cache_dir)
    return {mode: run("ref", cat, mode, ids) for mode in MODES}


def decimal_rows(sf: float):
    """E9b's rows from Python's decimal over the port's lineitem."""
    cat = catalog("port", sf)
    d = cat.get("lineitem").read(["l_returnflag", "l_linestatus",
                                  "l_extendedprice", "l_discount"])
    return FQ.decimal_math_rows(d["l_returnflag"], d["l_linestatus"],
                                d["l_extendedprice"], d["l_discount"])


def sin_sums(sf: float):
    """E1's exact sine sums over the port's lineitem."""
    d = catalog("port", sf).get("lineitem").read(
        ["l_returnflag", "l_linestatus", "l_extendedprice"])
    return FQ.exact_sin_sums(d["l_returnflag"], d["l_linestatus"],
                             d["l_extendedprice"])


def decimal_json(rows) -> list:
    return [[str(v) if not isinstance(v, (int, str)) else v for v in r]
            for r in rows]


def frozen() -> dict:
    with open(FROZEN) as f:
        return json.load(f)


def _jsonable(obj):
    return json.loads(json.dumps(obj))


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    if len(sys.argv) > 1 and sys.argv[1] == "decimal":
        print(json.dumps(decimal_json(decimal_rows(float(sys.argv[2])))))
    elif len(sys.argv) > 1 and sys.argv[1] == "sin":
        print(json.dumps(sin_sums(float(sys.argv[2]))))
    elif len(sys.argv) > 1:
        ids = tuple(sys.argv[2].split(",")) if len(sys.argv) > 2 else IDS
        got = reference(float(sys.argv[1]), ids,
                        sys.argv[3] if len(sys.argv) > 3 else None)
        print(json.dumps(FQ.compact_reference(_jsonable(got))))
    else:
        got = FQ.compact_reference(_jsonable(reference(0.01)))
        got["decimal"] = decimal_json(decimal_rows(0.01))
        with open(FROZEN, "w") as f:
            json.dump(got, f, indent=0, sort_keys=True)
            f.write("\n")
