"""What the four TPC-DS query files (tests/test_torch_tpcds_q*.py) share:
their fixtures, their checks and the tool that freezes presto_tpu's
counters and memo entries into them.

Each file holds a range of the 99 queries of
presto_tpu_torch/tpcds_queries.py, so that `--dist loadfile` spreads
them over workers, and runs each query through
`presto_tpu_torch.connect(tpcds_catalog(0.01), device="cpu")` in
`execution_mode` "dynamic" and "auto":
- the rows against the sqlite oracle, as tests/test_tpcds.py compares
  them (its SQLITE_OVERRIDES, tolerances and legal reorderings, q53 a
  non-strict xfail);
- the seven counters of QueryStats (SORT_STATS_KEYS) and the compiled
  memo's entry against presto_tpu's values at SF0.01, frozen in the
  file (FROZEN) by its `__main__` tool;
- every query against presto_tpu run live in both executors: rows at
  rtol 1e-9, counters, execution mode and memo entry, and presto_tpu's
  counters and memo entry equal to FROZEN.  LIVE queries (those that
  needed a piece this package lacked, and those whose compiled mode once
  differed) run so in tier-1, but for the queries tests/test_tpcds.py
  marks slow; the other queries' live runs are slow-marked (presto_tpu's
  runs dominate: about 40 minutes for the 99 on one CPU core).

The oracle is a copy of the shared sqlite database with an index on
every surrogate key and order number: sqlite then runs the 99 queries
in about 10 s, where q16 and q48 alone took 16 s each without them
(CPU, SF0.01).  Indexes change no result.
"""

import json
import math
import sqlite3
import sys

import pytest
import torch

import presto_tpu
import presto_tpu_torch
from presto_tpu_torch.catalog import tpcds_catalog
from presto_tpu_torch.exec.executor import SORT_STATS_KEYS
from presto_tpu_torch.tpcds_queries import QUERIES
from tests.sqlite_oracle import assert_same_results, build_sqlite, to_sqlite
from tests.test_torch_compiled import _memo_state
from tests.test_torch_tpch import _assert_rows_match, counters
from tests.test_tpcds import _SLOW_QIDS, _TIE_DRIFT_XFAIL
from tests.tpcds_queries import SQLITE_OVERRIDES

SF = 0.01
MODES = ("dynamic", "auto")
#: held live against presto_tpu: the queries that reached abs, concat,
#: upper, round, a comparison across dictionaries or stddev_samp (q8,
#: q17, q19, q24, q39, q47, q53, q57, q63, q66, q78, q80, q84, q89),
#: and those whose mode in "auto" differed before the tpcds connector
#: (q37, q54, q64)
LIVE = {8, 17, 19, 24, 37, 39, 47, 53, 54, 57, 63, 64, 66, 78, 80, 84, 89}
#: the ORDER BY queries whose ties reorder legally against sqlite
#: (tests/test_tpcds.py)
_UNORDERED = {34, 46, 50, 65, 68, 73, 79, 89}


def oracle_params(qids):
    """pytest params of `qids`, q53 a non-strict xfail as in
    tests/test_tpcds.py."""
    return [pytest.param(q, marks=pytest.mark.xfail(
        reason="LIMIT-boundary float-tie drift vs sqlite "
               "(tests/test_tpcds.py _TIE_DRIFT_XFAIL)", strict=False))
            if q in _TIE_DRIFT_XFAIL else q for q in qids]


def live_params(qids):
    """pytest params of `qids`, slow but for the LIVE queries that
    tests/test_tpcds.py does not mark slow (presto_tpu's runs
    dominate)."""
    return [q if q in LIVE and q not in _SLOW_QIDS
            else pytest.param(q, marks=pytest.mark.slow) for q in qids]


def _cached(session):
    cache = {}

    def run(qid):
        if qid not in cache:
            sql = QUERIES[qid]
            cache[qid] = (session.sql(sql), _memo_state(session, sql))
        return cache[qid]

    return run


@pytest.fixture(scope="module")
def one_thread():
    """torch on one thread while the module runs: under `-n 6` every
    worker's own thread pool would oversubscribe the cores (on an
    8-core CPU the 99 queries took 25 times longer beside five busy
    processes than alone)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def port(one_thread):
    """{mode: run(qid) -> (QueryResult, memo entry)}, each query run once
    a mode on first use."""
    cat = tpcds_catalog(SF)
    return {mode: _cached(presto_tpu_torch.connect(
        cat, device="cpu", execution_mode=mode)) for mode in MODES}


@pytest.fixture(scope="module")
def reference():
    from presto_tpu.catalog import tpcds_catalog as ref_catalog

    cat = ref_catalog(SF)
    return {mode: _cached(presto_tpu.connect(cat, execution_mode=mode))
            for mode in MODES}


class _Stddev:
    """Welford sample stddev, tests/sqlite_oracle.py's (a backup copy of
    a database carries no functions)."""

    def __init__(self):
        self.n, self.mean, self.m2 = 0, 0.0, 0.0

    def step(self, v):
        if v is None:
            return
        self.n += 1
        d = v - self.mean
        self.mean += d / self.n
        self.m2 += d * (v - self.mean)

    def finalize(self):
        if self.n < 2:
            return None
        return math.sqrt(self.m2 / (self.n - 1))


@pytest.fixture(scope="module")
def oracle():
    from presto_tpu.connectors import tpcds as ref_gen

    conn = sqlite3.connect(":memory:")
    build_sqlite(SF, generator=ref_gen).backup(conn)
    conn.create_aggregate("stddev_samp", 1, _Stddev)
    conn.create_aggregate("stddev", 1, _Stddev)
    for table, cols in ref_gen.SCHEMAS.items():
        for c in cols:
            if c.endswith(("_sk", "_number")):
                conn.execute(f"CREATE INDEX ix_{c} ON {table}({c})")
    conn.execute("ANALYZE")
    yield conn
    conn.close()


def check_oracle(qid, mode, port, oracle):
    """tests/test_tpcds.py's comparison of one query's rows."""
    sql = QUERIES[qid]
    rows = port[mode](qid)[0].rows
    expected = oracle.execute(
        to_sqlite(SQLITE_OVERRIDES.get(qid, sql))).fetchall()
    abs_tol = 2e-4 if qid in (47, 89) else 1e-4
    assert_same_results(rows, expected, ordered=False, abs_tol=abs_tol)
    if "ORDER BY" in sql.upper() and qid not in _UNORDERED:
        assert_same_results(rows, expected, ordered=True, abs_tol=abs_tol)


def check_frozen(qid, mode, port, frozen):
    """The counters and memo entry against presto_tpu's frozen ones."""
    result, memo = port[mode](qid)
    key = "compiled" if mode == "auto" else "dynamic"
    assert list(counters(result.stats).values()) == frozen[qid][key]
    if mode == "auto":
        assert memo == frozen[qid]["memo"]
        # a StaticFallback runs dynamic and memoizes nothing
        assert result.stats.execution_mode \
            == ("compiled" if memo else "dynamic")


def check_live(qid, mode, port, reference, frozen):
    """Rows (rtol 1e-9, as multisets), counters, mode and memo entry
    against presto_tpu's run of the same text, whose counters and memo
    entry must be the frozen ones."""
    mine, my_memo = port[mode](qid)
    theirs, their_memo = reference[mode](qid)
    _assert_rows_match(mine.rows, theirs.rows, False)
    assert counters(mine.stats) == counters(theirs.stats)
    assert mine.stats.execution_mode == theirs.stats.execution_mode
    assert my_memo == their_memo
    key = "compiled" if mode == "auto" else "dynamic"
    assert list(counters(theirs.stats).values()) == frozen[qid][key]
    if mode == "auto":
        assert their_memo == frozen[qid]["memo"]


def reference_states(sf, qids, cache_dir=None):
    """{qid: {"dynamic": [...], "compiled": [...], "memo": [...]}}:
    presto_tpu's counters (SORT_STATS_KEYS order) for each query run
    once in "dynamic" and once in "auto" ("compiled": the auto run's,
    a tripped guard's dynamic rerun included), and its memo entry.  A
    run that raises gives "<exception type>: <message>" in place of its
    counters."""
    from presto_tpu.catalog import tpcds_catalog as ref_catalog

    cat = ref_catalog(sf, cache_dir)
    sessions = {mode: presto_tpu.connect(cat, execution_mode=mode)
                for mode in MODES}
    out = {}
    for qid in qids:
        got = {}
        for mode, session in sessions.items():
            key = "compiled" if mode == "auto" else "dynamic"
            try:
                stats = session.sql(QUERIES[qid]).stats
            except Exception as e:  # noqa: BLE001 -- recorded as the value
                got[key] = f"{type(e).__name__}: {e}"
                continue
            got[key] = [getattr(stats, k) for k in SORT_STATS_KEYS]
        got["memo"] = _memo_state(sessions["auto"], QUERIES[qid])
        out[qid] = got
    return out


def main(argv=None):
    """`JAX_PLATFORMS=cpu python -m tests.test_torch_tpcds_qN SF
    Q[,Q...] [CACHE_DIR]`: one JSON line of presto_tpu's counters and
    memo entries on the CPU at scale factor SF, keyed "ds<Q>" (the
    files' FROZEN at 0.01; chip_smoke.py's REFERENCE_COUNTERS_SF1 and
    REFERENCE_MEMO_SF1 at 1, one query a process)."""
    argv = sys.argv[1:] if argv is None else argv
    sf = float(argv[0])
    qids = [int(q) for q in argv[1].split(",")]
    states = reference_states(sf, qids, argv[2] if len(argv) > 2 else None)
    print(json.dumps({"sf": sf, "counters": list(SORT_STATS_KEYS),
                      "presto_tpu": {f"ds{q}": s
                                     for q, s in states.items()}}))
