"""The time-zone and sketch corpus (presto_tpu_torch/zone_sketch_queries.py:
Z1 to Z5, K1 to K6) through presto_tpu_torch on the CPU at SF0.01, in
execution_mode "dynamic", "auto" and "compiled", each query once a mode
in a fresh session and Z5's script in one session, against presto_tpu's
values frozen in tests/torch_zone_sketch_frozen.json: rows (floats
within rtol 1e-9, blobs, strings and integers exactly; long blobs and
strings by their SHA-256), column types, the error of a query that
raises (a StaticFallback by type), execution mode, the seven counters
and the memo entry.  Z6's session constants are held to their
properties in every mode.  Z4b, the fixed-offset conversion, builds its
static pass with every host read and every Python scalar store patched
to raise.  Also the statements of the slice's probe table, each at
presto_tpu's value.  `-m slow` runs presto_tpu live against the frozen
values (about a minute).
"""

import time

import pytest

import presto_tpu_torch
from presto_tpu_torch import zone_sketch_queries as ZQ
from presto_tpu_torch.exec import kernels as K
from tests import torch_zone_sketch_common as ZC
from tests.torch_functions_common import static_pass_builds
from tests.torch_threads import torch_one_thread  # noqa: F401

SF = 0.01
RTOL = 1e-9


@pytest.fixture(scope="module")
def catalog():
    return ZC.catalog("port", SF)


@pytest.fixture(scope="module")
def runs(catalog):
    cache = {}

    def get(mode, qid):
        if (mode, qid) not in cache:
            cache[mode, qid] = ZC.run("port", catalog, mode, (qid,))
        return cache[mode, qid]

    return get


@pytest.mark.parametrize("mode", ZC.MODES)
@pytest.mark.parametrize("qid", ZQ.REFERENCE_IDS)
def test_query_matches_presto_tpu(qid, mode, runs):
    want = ZQ.expand_reference(ZC.frozen(), mode)[qid]
    assert ZQ.mismatch(qid, runs(mode, qid)[qid], want, RTOL) == ""


@pytest.mark.parametrize("mode", ZC.MODES)
def test_script_matches_presto_tpu(mode, runs):
    want = ZQ.expand_reference(ZC.frozen(), mode)
    got = runs(mode, "Z5")
    for sid, _sql in ZQ.SCRIPT:
        assert ZQ.mismatch(sid, got[sid], want[sid], RTOL) == ""


@pytest.mark.parametrize("mode", ZC.MODES)
def test_session_constants_hold_their_properties(mode, catalog):
    s = presto_tpu_torch.connect(catalog, device="cpu", execution_mode=mode)
    sql = ZQ.VOLATILE["Z6"]
    t0 = int(time.time() * 1e6)
    rows = [s.sql(sql).rows for _ in range(3)]
    t1 = int(time.time() * 1e6)
    assert ZQ.volatile_faults(rows, t0, t1) == []
    memo = [] if mode == "dynamic" else ["executable"] * 3
    assert ZQ.memo_state(s, sql) == memo


def test_fixed_offset_static_pass_reads_nothing_back(catalog):
    result, built = static_pass_builds(ZQ.QUERIES["Z4b"], catalog)
    assert result.stats.execution_mode == "compiled" and len(built) == 1


def test_corpus_reaches_fused_group_sums(catalog, monkeypatch):
    """Z2 and K4 group lineitem's rows (past the fused pass's 32,768-row
    floor at SF0.01) through kernels.fused_group_sums in the dynamic
    executor, the one they run in; Z1's orders are below the floor here
    and reach it at SF1 (chip_smoke.py)."""
    real, calls = K.fused_group_sums, []

    def counted(vals, gid, n_groups):
        calls.append(tuple(vals.shape))
        return real(vals, gid, n_groups)

    monkeypatch.setattr(K, "fused_group_sums", counted)
    for qid in ("Z2", "K4"):
        del calls[:]
        ZC.run("port", catalog, "auto", (qid,))
        assert calls and calls[0][1] == 59_833, qid


#: the probe table of the slice: presto_tpu's values at SF0.01
PROBES = [
    ("SELECT TIMESTAMP '2020-01-01 00:00:00 UTC'", [(1577836800000000,)]),
    ("SELECT hour(at_timezone(TIMESTAMP '2020-06-01 12:00:00 UTC', "
     "'America/New_York'))", [(8,)]),
    ("SELECT timezone_hour(TIMESTAMP '2020-06-01 12:00:00 Asia/Kolkata')",
     [(5,)]),
    ("SELECT count(*) FROM orders WHERE with_timezone(CAST(o_orderdate AS "
     "TIMESTAMP), 'America/New_York') < TIMESTAMP '1995-01-01 00:00:00 "
     "UTC'", [(6951,)]),
    ("SELECT typeof(current_timestamp), current_timezone()",
     [("TIMESTAMP WITH TIME ZONE", "UTC")]),
    ("SELECT cardinality(approx_set(l_orderkey)) FROM lineitem", [(14381,)]),
    ("SELECT l_returnflag, value_at_quantile(tdigest_agg(l_quantity), 0.5) "
     "FROM lineitem GROUP BY 1 ORDER BY 1",
     [("A", 25.400977259117777), ("N", 25.500897017747675),
      ("R", 25.673114554617268)]),
    ("SELECT value_at_quantile(qdigest_agg(l_quantity), 0.9) FROM lineitem",
     [(45.6375,)]),
    ("SELECT approx_percentile(l_quantity, ARRAY[0.25, 0.9]) FROM lineitem",
     [((13.0, 46.0),)]),
    ("SELECT approx_percentile(l_quantity, l_tax * 100 + 1, 0.5) "
     "FROM lineitem", [(26.0,)]),
    ("SELECT min_by(l_orderkey, l_extendedprice, 2) FROM lineitem",
     [((24772, 51779),)]),
    ("SELECT approx_most_frequent(2, l_shipmode, 100) FROM lineitem",
     [((("FOB", 8607), ("TRUCK", 8644)),)]),
    ("SELECT reduce_agg(l_quantity, 0.0, (s, x) -> s + x, "
     "(a, b) -> a + b) FROM lineitem", [(1528036.0,)]),
]


@pytest.mark.parametrize("sql,want", PROBES)
def test_probe_gives_presto_tpus_value(sql, want, catalog):
    assert presto_tpu_torch.connect(catalog, device="cpu").sql(sql).rows \
        == want


@pytest.mark.slow
def test_frozen_values_are_presto_tpus():
    got = ZQ.compact_reference(ZC._jsonable(ZC.reference(SF)))
    want = ZC.frozen()
    for mode in ZC.MODES:
        mine = ZQ.expand_reference(got, mode)
        theirs = ZQ.expand_reference(want, mode)
        for qid in theirs:
            assert ZQ.mismatch(qid, mine[qid], theirs[qid], RTOL) == "", \
                (mode, qid)


def test_corpus_reaches_every_host_aggregate(catalog):
    """Every aggregate of exec/host_aggs.py (HOST_AGGS, min_by / max_by
    with a count, the ARRAY and weighted approx_percentile) is in a
    corpus plan."""
    from presto_tpu_torch.exec.executor import HOST_AGGS, plan_statement
    from presto_tpu_torch.sql.parser import parse
    from tests.test_torch_functions_corpus import _reached

    s = presto_tpu_torch.connect(catalog, device="cpu")
    calls, aggs = set(), set()
    for sql in ZQ.QUERIES.values():
        _reached(plan_statement(s, parse(sql)).root, calls, aggs)
    assert HOST_AGGS | {"min_by", "max_by", "approx_percentile"} <= aggs
    for name in ("with_timezone", "at_timezone", "timezone_hour",
                 "timezone_minute", "from_unixtime", "to_unixtime",
                 "value_at_quantile", "values_at_quantiles",
                 "quantile_at_value", "scale_tdigest",
                 "destructure_tdigest", "empty_approx_set", "cardinality"):
        assert name in calls, name


def test_k2_weighted_columns_are_the_generated_columns_digest(catalog):
    """K2's weighted-digest columns at SF0.01 equal presto_tpu's t-digest
    over the port's generated columns (zone_sketch_queries.
    weighted_digest_rows, which chip_smoke.py's ZS_K2_WEIGHTED_SF1 holds
    the card's SF1 run to), and those columns are presto_tpu's
    host-generated ones bit for bit (weighted_rows checks them)."""
    rows = ZQ.expand_reference(ZC.frozen(), "dynamic")["K2"]["rows"]
    want = ZC.weighted_rows(SF)
    assert [r[0] for r in rows] == [w[0] for w in want]
    for r, w in zip(rows, want):
        got = [r[0]] + [r[c] for c in ZQ.K2_WEIGHTED_COLUMNS]
        assert ZQ.mismatch("K2", {"error": None, "rows": [got]},
                           {"error": None, "rows": [w]}, RTOL) == ""
