"""What the three TPC-H files of the dynamic executor
(tests/test_torch_tpch.py, _q8.py, _q15.py) share: their fixtures and
checks.  Each file holds a range of the 22 queries, so that `--dist
loadfile` spreads them over workers; tests/test_torch_tpch.py says what
each test holds.
"""

import math
import sqlite3

import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu_torch.catalog import tpch_catalog
from presto_tpu_torch.exec.executor import SORT_STATS_KEYS
from presto_tpu_torch.tpch_queries import QUERIES
from tests.sqlite_oracle import assert_same_results, normalize, to_sqlite
from tests.test_tpch_correctness import ORDERED

RTOL = 1e-9


def _once(session):
    """{qid: QueryResult} of `session`, each query run once on first
    use."""
    cache = {}

    def result(qid):
        if qid not in cache:
            cache[qid] = session.sql(QUERIES[qid])
        return cache[qid]

    return result


@pytest.fixture(scope="module")
def port_results():
    return _once(presto_tpu_torch.connect(tpch_catalog(0.01), device="cpu",
                                          execution_mode="dynamic"))


@pytest.fixture(scope="module")
def oracle(tpch_sqlite_tiny):
    conn = sqlite3.connect(":memory:")
    tpch_sqlite_tiny.backup(conn)
    for table, cols in (("lineitem", "l_orderkey"), ("lineitem", "l_partkey"),
                        ("part", "p_partkey"), ("orders", "o_orderkey"),
                        ("supplier", "s_suppkey"),
                        ("partsupp", "ps_partkey, ps_suppkey"),
                        ("customer", "c_custkey")):
        name = f"{table}_{cols.split(',')[0]}"
        conn.execute(f"CREATE INDEX {name} ON {table}({cols})")
    conn.execute("ANALYZE")
    yield conn
    conn.close()


@pytest.fixture(scope="module")
def reference(tpch_catalog_tiny):
    return _once(presto_tpu.connect(tpch_catalog_tiny,
                                    execution_mode="dynamic"))


def counters(stats) -> dict:
    """The seven counters of ordering-aware execution and dynamic
    filtering in a QueryStats."""
    return {k: getattr(stats, k) for k in SORT_STATS_KEYS}


def _assert_rows_match(actual, expected, ordered):
    if not ordered:  # rounded keys: last-bit differences keep the order
        actual = [r for _, r in sorted(zip(normalize(actual), actual),
                                       key=lambda p: repr(p[0]))]
        expected = [r for _, r in sorted(zip(normalize(expected), expected),
                                         key=lambda p: repr(p[0]))]
    assert len(actual) == len(expected)
    for ra, re_ in zip(actual, expected):
        assert len(ra) == len(re_)
        for va, ve in zip(ra, re_):
            if isinstance(va, float) or isinstance(ve, float):
                assert math.isclose(va, ve, rel_tol=RTOL, abs_tol=0), \
                    (ra, re_)
            else:
                assert va == ve, (ra, re_)


def reference_params(qids):
    """pytest params of `qids`: presto_tpu's Q21 is its suite's heaviest
    dynamic-mode query, slow-marked in tests/test_tpch_correctness.py
    too; the port's Q21 stays in tier-1 through the oracle leg, and
    presto_tpu's through the counters leg (about 9 s, CPU)."""
    return [pytest.param(q, marks=pytest.mark.slow) if q == 21 else q
            for q in qids]


def check_oracle(qid, port_results, oracle):
    expected = oracle.execute(to_sqlite(QUERIES[qid])).fetchall()
    assert_same_results(port_results(qid).rows, expected,
                        ordered=qid in ORDERED)


def check_reference(qid, port_results, reference):
    _assert_rows_match(port_results(qid).rows, reference(qid).rows,
                       qid in ORDERED)


def check_counters(qid, port_results, reference):
    assert counters(port_results(qid).stats) \
        == counters(reference(qid).stats)
