"""Runs of the geospatial, ML and float32_compute corpus
(presto_tpu_torch/geo_ml_queries.py) in either package, and presto_tpu's
values at chip_smoke.py's sizes.

Each mode runs its statements in order in one fresh session, as
chip_smoke.py's corpus_run does.  From the repository root:

- `JAX_PLATFORMS=cpu python -m tests.torch_geo_ml_common geo` prints
  presto_tpu's G records at geo_ml_queries.FULL (4,000,000 points, 10,000
  regions) as one JSON line (chip_smoke.py's GEO_REFERENCE);
- `... ml SF [CACHE_DIR]` its M records over TPC-H at scale factor SF,
  the `models` table holding its own M1 blobs (chip_smoke.py's
  ML_REFERENCE_SF1 at SF 1);
- `... f32 SF Q[,Q...] [CACHE_DIR]` its float32_compute records of TPC-H
  queries in "dynamic" and "compiled" (chip_smoke.py's F32_REFERENCE_SF1,
  one query a process);
- with no argument, it rewrites tests/torch_geo_ml_frozen.json
  (about five minutes): presto_tpu's records in "dynamic", "auto" and
  "compiled" of the 22 TPC-H queries at SF0.01 under float32_compute
  ("f32"), of G at geo_ml_queries.SMALL ("geo") and of M at SF0.01
  ("ml"), which tests/test_torch_float32.py, test_torch_geospatial.py
  and test_torch_ml.py hold the port to (presto_tpu's compiles of these
  take minutes, past the tests' budget; their slow tests rerun
  presto_tpu live against the file).
"""

import json
import os
import sys

from presto_tpu_torch import geo_ml_queries as GQ
from presto_tpu_torch.exec.executor import SORT_STATS_KEYS
from presto_tpu_torch.tpch_queries import QUERIES as TPCH


FROZEN = os.path.join(os.path.dirname(__file__), "torch_geo_ml_frozen.json")
TPCH_IDS = tuple(range(1, 23))


def frozen() -> dict:
    with open(FROZEN) as f:
        return json.load(f)


def connect(pkg: str, catalog, mode: str, device: str = "cpu", **props):
    if pkg == "port":
        import presto_tpu_torch

        return presto_tpu_torch.connect(catalog, execution_mode=mode,
                                        device=device, **props)
    import presto_tpu

    return presto_tpu.connect(catalog, execution_mode=mode, **props)


def register(pkg: str, catalog, tables: dict):
    """Register {name: (schema of type names, columns)} as memory tables
    of the package's catalog."""
    if pkg == "port":
        from presto_tpu_torch import types as T
    else:
        from presto_tpu import types as T
    for name, (schema, cols) in tables.items():
        catalog.register_memory(
            name, {c: T.parse_type(t) for c, t in schema.items()}, cols)
    return catalog


def empty_catalog(pkg: str):
    if pkg == "port":
        from presto_tpu_torch.catalog import Catalog
    else:
        from presto_tpu.catalog import Catalog
    return Catalog()


def tpch(pkg: str, sf: float, cache_dir=None):
    if pkg == "port":
        from presto_tpu_torch.catalog import tpch_catalog

        return tpch_catalog(sf)
    from presto_tpu.catalog import tpch_catalog

    return tpch_catalog(sf, cache_dir)


def run(session, statements) -> dict:
    """{id: record} of [(id, sql)] in order in one session."""
    return {sid: GQ.record(session, sql, SORT_STATS_KEYS)
            for sid, sql in statements}


def geo_runs(pkg: str, sizes: dict, modes=GQ.GEO_ML_MODES, device="cpu"):
    """{mode: {id: record}} of G at `sizes`."""
    tables = GQ.geo_tables(sizes)
    queries = list(GQ.geo_queries(tables, sizes).items())
    cat = register(pkg, empty_catalog(pkg), tables)
    return {mode: run(connect(pkg, cat, mode, device), queries)
            for mode in modes}


def ml_runs(pkg: str, cat, blobs, modes=GQ.GEO_ML_MODES, device="cpu"):
    """{mode: {id: record}} of M over the TPC-H catalog `cat`, the
    `models` table holding `blobs` (a classifier's and a regressor's)."""
    register(pkg, cat, {"models": GQ.models_table(blobs)})
    return {mode: run(connect(pkg, cat, mode, device),
                      list(GQ.ML_QUERIES.items()))
            for mode in modes}


def f32_runs(pkg: str, cat, qids, modes=GQ.F32_MODES, device="cpu"):
    """{mode: {Q<n>: record}} of TPC-H queries under float32_compute."""
    return {mode: run(connect(pkg, cat, mode, device, float32_compute=True),
                      [(f"Q{q}", TPCH[q]) for q in qids])
            for mode in modes}


def reference_blobs(cat) -> list:
    """presto_tpu's M1 blobs over the TPC-H catalog `cat`."""
    rows = connect("ref", cat, "dynamic").sql(GQ.M1).rows
    return [bytes(b) for b in rows[0]]


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    what = sys.argv[1] if len(sys.argv) > 1 else "frozen"
    if what == "frozen":
        cat = tpch("ref", 0.01, "/tmp/presto_tpu_cache")
        got = {"f32": f32_runs("ref", cat, TPCH_IDS, GQ.GEO_ML_MODES),
               "geo": geo_runs("ref", GQ.SMALL),
               "ml": ml_runs("ref", cat, reference_blobs(cat))}
        with open(FROZEN, "w") as f:
            json.dump(got, f, indent=0, sort_keys=True)
            f.write("\n")
    elif what == "geo":
        print(json.dumps(geo_runs("ref", GQ.FULL)))
    elif what == "ml":
        sf = float(sys.argv[2])
        cat = tpch("ref", sf, sys.argv[3] if len(sys.argv) > 3 else None)
        print(json.dumps(ml_runs("ref", cat, reference_blobs(cat))))
    elif what == "f32":
        sf = float(sys.argv[2])
        cat = tpch("ref", sf, sys.argv[4] if len(sys.argv) > 4 else None)
        qids = [int(q) for q in sys.argv[3].split(",")]
        print(json.dumps(f32_runs("ref", cat, qids)))
