"""The function corpus of presto_tpu_torch (presto_tpu_torch/
function_queries.py) against presto_tpu on the CPU at SF0.01: F1 to F5,
the aggregates, here; F6 to F11, the scalar functions, in
tests/test_torch_functions_corpus_scalars.py, with this file's checks
(a file a half keeps each inside the tier-1 command's time a file).

Each query runs in `execution_mode` "dynamic" and "auto" in both
packages, over TPC-H catalogs built in memory for this module.  Rows
must equal presto_tpu's (integers, strings, booleans, approx_distinct
and approx_percentile exactly; other floats within rtol 1e-9), and so
must the seven counters of QueryStats, the execution mode and the
compiled memo's entry.  Every static pass reads nothing back to the
host and stores no Python scalar into a tensor.  The corpus reaches each
of the 65 scalar names and 23 aggregates this slice ports.

`python -m tests.test_torch_functions_corpus SF NAME[,NAME...]
[CACHE_DIR]` prints presto_tpu's rows, counters and memo entries (and
the port's on the CPU) in both modes as one JSON line: chip_smoke.py's
FN_REFERENCE_SF1 came from it at SF1, one query a process.  A slow test
recomputes that table and compares.
"""

import json
import sys

import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu.catalog import tpch_catalog as ref_tpch_catalog
from presto_tpu_torch.catalog import tpch_catalog
from presto_tpu_torch.exec.executor import (COLLECTION_AGGS, HOST_AGGS,
                                            ML_AGGS, PORTED_AGGS,
                                            plan_statement)
from presto_tpu_torch.function_queries import EXACT_FLOAT_COLUMNS, QUERIES
from presto_tpu_torch.plan import ir
from presto_tpu_torch.sql.parser import parse
from tests.test_torch_compiled import _memo_state
from tests.test_torch_functions import SCALAR_NAMES
from tests.test_torch_tpch import counters
from tests.torch_functions_common import (assert_rows_equal,
                                          static_pass_builds)
from tests.torch_threads import torch_one_thread  # noqa: F401

MODES = ("dynamic", "auto")
#: the queries this file holds (the aggregates)
NAMES = ("F1", "F2", "F3", "F4", "F5")


class Runs:
    """run(package, mode, name): the query's result and memo entry, one
    session a package and mode over one in-memory catalog a package,
    each query run once on first use."""

    def __init__(self):
        self.port_catalog = tpch_catalog(0.01)
        cats = {"port": (presto_tpu_torch, self.port_catalog,
                         {"device": "cpu"}),
                "ref": (presto_tpu, ref_tpch_catalog(0.01, None), {})}
        self.sessions = {(pkg, mode): lib.connect(cat, execution_mode=mode,
                                                  **kw)
                         for pkg, (lib, cat, kw) in cats.items()
                         for mode in MODES}
        self.done = {}

    def __call__(self, pkg, mode, name):
        key = (pkg, mode, name)
        if key not in self.done:
            s = self.sessions[pkg, mode]
            result = s.sql(QUERIES[name])
            self.done[key] = (result, _memo_state(s, QUERIES[name]))
        return self.done[key]


def assert_query_matches_reference(name, mode, runs):
    mine, my_memo = runs("port", mode, name)
    ref, ref_memo = runs("ref", mode, name)
    assert_rows_equal(mine.rows, ref.rows, EXACT_FLOAT_COLUMNS.get(name, ()))
    assert counters(mine.stats) == counters(ref.stats)
    assert mine.stats.execution_mode == ref.stats.execution_mode
    assert my_memo == ref_memo


def assert_static_pass_reads_nothing_back(name, catalog):
    """The query's static pass (what compiled mode captures on a card)
    with every host read and every Python scalar store made to raise:
    the dictionary tables and value hashes reach the device through
    batch.upload, and approx_percentile's p comes from the plan."""
    result, built = static_pass_builds(QUERIES[name], catalog)
    assert result.stats.execution_mode == "compiled" and len(built) == 1


@pytest.fixture(scope="module")
def runs():
    return Runs()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_query_matches_reference(name, mode, runs):
    assert_query_matches_reference(name, mode, runs)


@pytest.mark.parametrize("name", NAMES)
def test_static_pass_reads_nothing_back(name, runs):
    assert_static_pass_reads_nothing_back(name, runs.port_catalog)


def _reached(node, calls: set, aggs: set) -> None:
    """The scalar function and aggregate names a plan evaluates."""
    def walk_expr(e):
        if isinstance(e, ir.Call):
            calls.add(e.fn)
        for child in vars(e).values() if hasattr(e, "__dict__") else ():
            for c in (child if isinstance(child, tuple) else (child,)):
                if isinstance(c, ir.RowExpr):
                    walk_expr(c)

    for value in vars(node).values():
        items = value.values() if isinstance(value, dict) else (
            value if isinstance(value, (list, tuple)) else (value,))
        for v in items:
            if isinstance(v, ir.AggCall):
                aggs.add(v.fn)
                for arg in v.args:
                    walk_expr(arg)
            elif isinstance(v, ir.RowExpr):
                walk_expr(v)
            elif hasattr(v, "source") or hasattr(v, "left"):
                _reached(v, calls, aggs)


def test_corpus_reaches_every_ported_name(runs):
    session = presto_tpu_torch.connect(runs.port_catalog, device="cpu")
    calls, aggs = set(), set()
    for sql in QUERIES.values():
        _reached(plan_statement(session, parse(sql)).root, calls, aggs)
    assert set(SCALAR_NAMES) <= calls, set(SCALAR_NAMES) - calls
    # (the host aggregates of a later slice are the zone/sketch corpus',
    # the ML aggregates of the next the geo/ML corpus')
    new_aggs = PORTED_AGGS - COLLECTION_AGGS - HOST_AGGS - ML_AGGS - {
        "count", "count_if", "sum", "avg", "min", "max", "stddev",
        "stddev_samp", "stddev_pop", "variance", "var_samp", "var_pop"}
    assert len(new_aggs) == 23
    assert new_aggs <= aggs, new_aggs - aggs


def reference_at(sf, names, cache_dir=None, port=True):
    """{package: {name: {"dynamic": {...}, "compiled": {...}}}} of the
    corpus queries at scale factor `sf` on the CPU (presto_tpu's, and the
    port's unless `port` is false), each with its rows, its counters in
    SORT_STATS_KEYS order and, for "compiled" (the "auto" run), the
    execution mode and memo entry.  The packages cache generated tables
    in directories of their own under `cache_dir`."""
    def cache(pkg):
        return None if cache_dir is None else f"{cache_dir}/{pkg}"

    out = {}
    packages = [("presto_tpu", presto_tpu,
                 ref_tpch_catalog(sf, cache("presto_tpu")), {})]
    if port:
        packages.append(("presto_tpu_torch", presto_tpu_torch,
                         tpch_catalog(sf, cache("presto_tpu_torch")),
                         {"device": "cpu"}))
    for pkg, lib, cat, kw in packages:
        got = out[pkg] = {}
        for name in names:
            entry = got[name] = {}
            for mode, label in (("dynamic", "dynamic"), ("auto", "compiled")):
                session = lib.connect(cat, execution_mode=mode, **kw)
                result = session.sql(QUERIES[name])
                entry[label] = {
                    "rows": [list(r) for r in result.rows],
                    "counters": list(counters(result.stats).values())}
                if label == "compiled":
                    memo = _memo_state(session, QUERIES[name])
                    entry[label].update({
                        "mode": result.stats.execution_mode,
                        "memo": memo[0] if memo else None})
    return out


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_frozen_sf1_reference_is_presto_tpu(name):
    """chip_smoke.py's FN_REFERENCE_SF1 entry for the query equals
    presto_tpu's values at SF1, recomputed (minutes a query, up to a few
    GB of host memory)."""
    import chip_smoke

    got = reference_at(1, [name], port=False)["presto_tpu"][name]
    frozen = chip_smoke.FN_REFERENCE_SF1[name]
    for mode in ("dynamic", "compiled"):
        assert_rows_equal(chip_smoke.fn_reference_rows(name, mode),
                          got[mode]["rows"],
                          EXACT_FLOAT_COLUMNS.get(name, ()))
        assert frozen[mode]["counters"] == got[mode]["counters"]
    assert frozen["compiled"]["memo"] == got["compiled"]["memo"]
    assert frozen["compiled"]["mode"] == got["compiled"]["mode"]


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python -m tests.test_torch_functions_corpus SF
    # NAME[,NAME...] [CACHE_DIR]
    print(json.dumps({"sf": float(sys.argv[1]), **reference_at(
        float(sys.argv[1]), sys.argv[2].split(","),
        sys.argv[3] if len(sys.argv) > 3 else None)}))
