"""The collection corpus of presto_tpu_torch (presto_tpu_torch/
collection_queries.py, C1 to C9) against presto_tpu on the CPU at SF0.01.

Each query runs in `execution_mode` "dynamic" and "auto" over a TPC-H
catalog built in memory for this module.  Rows must equal presto_tpu's
(integers, strings, booleans and collection values exactly, floats
within rtol 1e-9), and so must the seven counters of QueryStats, the
execution mode and the compiled memo's entry: C1 and C2 run as one
compiled program in both packages, C3 to C9 fall back to the dynamic
executor (host-built aggregates, lambdas, element functions over
constant arrays).  presto_tpu's values are frozen in
tests/torch_collections_frozen.json (tests/torch_collections_common.py),
and a slow test runs presto_tpu live against them.  The
static passes of C1 and C2 read nothing back to the host.  The corpus
reaches each of the 38 collection names of functions/scalar.py and the
eight collection aggregates.

`python -m tests.test_torch_collections_corpus SF NAME[,NAME...]
[CACHE_DIR]` prints presto_tpu's rows, counters and memo entries (and
the port's on the CPU) in both modes as one JSON line: chip_smoke.py's
COLL_REFERENCE_SF1 came from it at SF1, one query a process.  A slow
test recomputes that table and compares.
"""

import json
import sys

import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu.catalog import tpch_catalog as ref_tpch_catalog
from presto_tpu_torch.catalog import tpch_catalog
from presto_tpu_torch.collection_queries import EXACT_FLOAT_COLUMNS, QUERIES
from presto_tpu_torch.exec.executor import COLLECTION_AGGS, plan_statement
from presto_tpu_torch.sql.parser import parse
from tests.test_torch_collections import COLLECTION_NAMES
from tests.test_torch_compiled import _memo_state
from tests.test_torch_functions_corpus import _reached
from tests.test_torch_tpch import counters
from tests.torch_collections_common import (MODES, assert_frozen,
                                            check_reference, frozen,
                                            tuplify, values_of)
from tests.torch_functions_common import (assert_rows_equal,
                                          static_pass_builds)
from tests.torch_threads import torch_one_thread  # noqa: F401

#: the queries that run as one compiled program in "auto"
COMPILED = ("C1", "C2")

#: presto_tpu's query memory limit in reference_at
REFERENCE_MEMORY_LIMIT = 64 << 30


class Runs:
    """run(mode, name): the port's values of a corpus query on the CPU
    (tests/torch_collections_common.py values_of), one session a mode
    over one in-memory catalog, each query run once on first use."""

    def __init__(self):
        self.port_catalog = tpch_catalog(0.01)
        self.sessions = {mode: presto_tpu_torch.connect(
            self.port_catalog, execution_mode=mode, device="cpu")
            for mode in MODES}
        self.done = {}

    def __call__(self, mode, name):
        if (mode, name) not in self.done:
            self.done[mode, name] = values_of(self.sessions[mode],
                                              QUERIES[name])
        return self.done[mode, name]


@pytest.fixture(scope="module")
def runs():
    return Runs()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_reference(name, mode, runs):
    got = runs(mode, name)
    assert_frozen(got, frozen(__name__, name, mode),
                  EXACT_FLOAT_COLUMNS.get(name, ()))
    if mode == "auto":
        assert (got["mode"] == "compiled") == (name in COMPILED)


@pytest.mark.parametrize("name", COMPILED)
def test_static_pass_reads_nothing_back(name, runs):
    result, built = static_pass_builds(QUERIES[name], runs.port_catalog)
    assert result.stats.execution_mode == "compiled" and len(built) == 1
    assert_rows_equal(result.rows, [tuple(tuplify(v) for v in r) for r in
                                    runs("dynamic", name)["rows"]])


def frozen_cases():
    """{case: (presto_tpu's catalog, sql)} of the values frozen for this
    module (tests/torch_collections_common.py)."""
    ref = ref_tpch_catalog(0.01, None)
    return {name: (ref, sql) for name, sql in QUERIES.items()}


@pytest.mark.slow
def test_frozen_values_are_presto_tpus():
    """presto_tpu, run live at SF0.01, gives the frozen values."""
    check_reference(__name__)


def test_corpus_reaches_every_collection_name(runs):
    session = presto_tpu_torch.connect(runs.port_catalog, device="cpu")
    calls, aggs = set(), set()
    for sql in QUERIES.values():
        _reached(plan_statement(session, parse(sql)).root, calls, aggs)
    assert len(COLLECTION_NAMES) == 38 and len(COLLECTION_AGGS) == 8
    assert set(COLLECTION_NAMES) <= calls, set(COLLECTION_NAMES) - calls
    assert COLLECTION_AGGS <= aggs, COLLECTION_AGGS - aggs


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
    # presto_tpu's dynamic C1 at SF1 accounts 5.4 GB of columns after the
    # expansion, past its default query limit of 4 GiB
    # (query_max_memory_bytes, an accounting limit the port does not
    # have): the reference runs with a limit no query here reaches
    packages = [("presto_tpu", presto_tpu,
                 ref_tpch_catalog(sf, cache("presto_tpu")),
                 {"query_max_memory_bytes": REFERENCE_MEMORY_LIMIT})]
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
    """chip_smoke.py's COLL_REFERENCE_SF1 entry for the query equals
    presto_tpu's values at SF1, recomputed (up to minutes a query and
    several GB of host memory)."""
    import chip_smoke

    got = reference_at(1, [name], port=False)["presto_tpu"][name]
    frozen = chip_smoke.COLL_REFERENCE_SF1[name]
    for mode in ("dynamic", "compiled"):
        assert_rows_equal(chip_smoke.coll_reference_rows(name, mode),
                          [tuple(chip_smoke.tuplify(v) for v in r)
                           for r in got[mode]["rows"]],
                          EXACT_FLOAT_COLUMNS.get(name, ()))
        assert frozen[mode]["counters"] == got[mode]["counters"]
    assert frozen["compiled"]["memo"] == got["compiled"]["memo"]
    assert frozen["compiled"]["mode"] == got["compiled"]["mode"]


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python -m tests.test_torch_collections_corpus SF
    # NAME[,NAME...] [CACHE_DIR]
    print(json.dumps({"sf": float(sys.argv[1]), **reference_at(
        float(sys.argv[1]), sys.argv[2].split(","),
        sys.argv[3] if len(sys.argv) > 3 else None)}))
