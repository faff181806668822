"""The extended function corpus (presto_tpu_torch/function_ext_queries.py,
E1 to E9) through presto_tpu_torch on the CPU at SF0.01, in
execution_mode "dynamic", "auto" and "compiled", each query once a mode
in a fresh session, against presto_tpu's values frozen in
tests/torch_functions_ext_frozen.json: rows (floats within rtol 1e-9,
VARBINARY, strings and integers exactly), column types, the error of a
query that raises (a StaticFallback by type), execution mode, the seven
counters and the memo entry.  E9b's DECIMAL math is held to Python's
decimal over the generated columns (the frozen "decimal" rows); presto_tpu
raises a TypeError there, so its counters are the port's own.  E1's sum
of sines, whose terms cancel, is also held to the exact sums.  E8, the
volatile queries, is tests/test_torch_volatile.py's.

Each query whose "auto" run is a graph (E1, E2, E3, E5, E9a) builds its
static pass with every host read and every Python scalar store patched
to raise.  `-m slow` runs presto_tpu live against the frozen values
(about four minutes).
"""

import pytest

from presto_tpu_torch import function_ext_queries as FQ
from tests import torch_functions_ext_common as XC
from tests.torch_functions_common import static_pass_builds
from tests.torch_threads import torch_one_thread  # noqa: F401

SF = 0.01
RTOL = 1e-9
#: the queries whose "auto" run captures a graph
GRAPH_IDS = ("E1", "E2", "E3", "E5", "E9a")


@pytest.fixture(scope="module")
def catalog():
    return XC.catalog("port", SF)


@pytest.fixture(scope="module")
def runs(catalog):
    cache = {}

    def get(mode, qid):
        if (mode, qid) not in cache:
            cache[mode, qid] = XC.run("port", catalog, mode, (qid,))[qid]
        return cache[mode, qid]

    return get


@pytest.mark.parametrize("mode", XC.MODES)
@pytest.mark.parametrize("qid", FQ.REFERENCE_IDS)
def test_query_matches_presto_tpu(qid, mode, runs):
    want = FQ.expand_reference(XC.frozen(), mode)[qid]
    assert FQ.mismatch(qid, runs(mode, qid), want, RTOL) == ""


@pytest.mark.parametrize("mode", XC.MODES)
def test_decimal_math_equals_python_decimal(mode, runs):
    got = runs(mode, "E9b")
    assert got["error"] is None
    want = [[r[0], r[1], r[2]] + [FQ.Decimal(v) for v in r[3:]]
            for r in XC.frozen()["decimal"]]
    assert FQ.decimal_math_values(got["rows"]) == want
    # a long-decimal sum: the plan memoizes DYNAMIC outside "dynamic"
    assert got["memo"] == ([] if mode == "dynamic" else ["DYNAMIC"])
    ref = FQ.expand_reference(XC.frozen(), mode)["E9b"]
    assert ref["error"][0] == "TypeError"


def test_frozen_decimal_rows_are_python_decimals_of_the_columns():
    rows = XC.decimal_json(XC.decimal_rows(SF))
    assert rows == XC.frozen()["decimal"]


@pytest.mark.parametrize("mode", XC.MODES)
def test_e1_sine_sums_are_the_exact_sums(mode, catalog, runs):
    """E1's sum of sin(l_extendedprice), whose terms cancel, within 1e-13
    of each group's sum of |sin| of the exact sum of numpy's sines
    (function_ext_queries.exact_sin_sums, which chip_smoke.py holds E1
    to at SF1, where presto_tpu's scan gives some prices one ulp off)."""
    import numpy as np

    d = catalog.get("lineitem").read(["l_returnflag", "l_linestatus",
                                      "l_extendedprice"])
    rf, ls = np.asarray(d["l_returnflag"]), np.asarray(d["l_linestatus"])
    s = np.abs(np.sin(np.asarray(d["l_extendedprice"], dtype=np.float64)))
    exact = FQ.exact_sin_sums(rf, ls, d["l_extendedprice"])
    rows = runs(mode, "E1")["rows"]
    assert [r[:2] for r in rows] == [e[:2] for e in exact]
    for r, (a, b, want) in zip(rows, exact):
        scale = s[(rf == a) & (ls == b)].sum()
        assert abs(r[FQ.E1_SIN_COLUMN] - want) <= 1e-13 * scale, (a, b)


@pytest.mark.parametrize("qid", GRAPH_IDS)
def test_static_pass_reads_nothing_back(qid, catalog):
    result, built = static_pass_builds(FQ.QUERIES[qid], catalog)
    assert result.stats.execution_mode == "compiled" and len(built) == 1


def test_corpus_reaches_the_kernel_paths(runs):
    """E1's sums and count(*) are one grouped pass (fused_group_sums on
    the card); E4 joins (its gathers are block_gather's); the graphs of
    GRAPH_IDS are the "auto" runs that are executables."""
    for qid in GRAPH_IDS:
        assert runs("auto", qid)["memo"] == ["executable"], qid
    # E4's round trips read the column on the host: its static pass
    # falls back and "auto" runs the dynamic executor
    assert runs("auto", "E4")["mode"] == "dynamic"


@pytest.mark.slow
def test_frozen_values_are_presto_tpus():
    got = FQ.compact_reference(XC._jsonable(XC.reference(SF)))
    want = XC.frozen()
    for mode in XC.MODES:
        mine = FQ.expand_reference(got, mode)
        theirs = FQ.expand_reference(want, mode)
        for qid in XC.IDS:
            assert FQ.mismatch(qid, mine[qid], theirs[qid], RTOL) == "", \
                (mode, qid)


@pytest.mark.slow
def test_sf1_sine_sums_are_exact():
    """chip_smoke.py's FX_E1_SIN_SF1 against exact_sin_sums at SF1."""
    import chip_smoke

    assert XC.sin_sums(1) == chip_smoke.FX_E1_SIN_SF1


@pytest.mark.slow
def test_sf1_reference_is_presto_tpus():
    """chip_smoke.py's FX_REFERENCE_SF1 against presto_tpu at SF1 (tens
    of minutes, several GB)."""
    import chip_smoke

    got = FQ.compact_reference(XC._jsonable(XC.reference(
        1, FQ.REFERENCE_IDS)))
    for mode in XC.MODES:
        mine = FQ.expand_reference(got, mode)
        theirs = FQ.expand_reference(chip_smoke.FX_REFERENCE_SF1, mode)
        for qid in FQ.REFERENCE_IDS:
            assert FQ.mismatch(qid, mine[qid], theirs[qid], RTOL) == "", \
                (mode, qid)
