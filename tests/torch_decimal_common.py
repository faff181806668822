"""Runs of the decimal corpus (presto_tpu_torch/decimal_queries.py) in
either package, each in a fresh session over a fresh catalog that shares
one set of TPC-H tables, and presto_tpu's values frozen at SF0.01 in
tests/torch_decimal_frozen.json.

`JAX_PLATFORMS=cpu python -m tests.torch_decimal_common` rewrites the
frozen file (presto_tpu at SF0.01 in "dynamic", "auto" and "compiled",
about two minutes); `... torch_decimal_common SF [CACHE_DIR]` prints
presto_tpu's values at scale factor SF as one JSON line instead, each
fact once (decimal_queries.compact_reference): chip_smoke.py's
DEC_REFERENCE_SF1 came from it at SF 1.
"""

import json
import os
import sys

from presto_tpu_torch import decimal_queries as DQ
from presto_tpu_torch.exec.executor import SORT_STATS_KEYS

MODES = ("dynamic", "auto", "compiled")
FROZEN = os.path.join(os.path.dirname(__file__), "torch_decimal_frozen.json")


def port_tables(sf: float):
    from presto_tpu_torch.catalog import tpch_catalog

    return list(tpch_catalog(sf).tables.values())


def ref_tables(sf: float, cache_dir=None):
    from presto_tpu.catalog import tpch_catalog

    return [t for n, t in tpch_catalog(sf, cache_dir).tables.items()
            if "." not in n]


def run(pkg: str, tables, mode: str, ids=None, device: str = "cpu") -> dict:
    """The script in a fresh session of `pkg` ("port" or "ref")."""
    if pkg == "port":
        import presto_tpu_torch as lib
        from presto_tpu_torch.catalog import Catalog
        kw = {"device": device}
    else:
        import presto_tpu as lib
        from presto_tpu.catalog import Catalog
        kw = {}
    cat = Catalog()
    for t in tables:
        cat.register(t)
    session = lib.connect(cat, execution_mode=mode, **kw)
    return DQ.run_script(session, SORT_STATS_KEYS, ids)


def reference(sf: float, cache_dir=None) -> dict:
    """presto_tpu's records {mode: {id: record}} at scale factor sf."""
    tables = ref_tables(sf, cache_dir)
    return {mode: run("ref", tables, mode) for mode in MODES}


def frozen() -> dict:
    with open(FROZEN) as f:
        return json.load(f)


def _jsonable(obj):
    return json.loads(json.dumps(obj))


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    if len(sys.argv) > 1:
        got = reference(float(sys.argv[1]),
                        sys.argv[2] if len(sys.argv) > 2 else None)
        print(json.dumps(DQ.compact_reference(_jsonable(got))))
    else:
        got = DQ.compact_reference(_jsonable(reference(0.01)))
        with open(FROZEN, "w") as f:
            json.dump(got, f, indent=0, sort_keys=True)
            f.write("\n")
