"""The decimal corpus (presto_tpu_torch/decimal_queries.py, N1 to N9)
through presto_tpu_torch on the CPU at SF0.01, in execution_mode
"dynamic", "auto" and "compiled", each mode once in a fresh session,
against presto_tpu's values frozen in tests/torch_decimal_frozen.json
(rows with decimals exactly and floats within rtol 1e-9, column types,
the error of a statement that raises, execution mode, the seven
counters and the memo entry).  N2 and N4 are also held to Python's
decimal module over the generated columns; NG, the query over short
decimals alone, runs as a graph in "auto" whose static pass reads
nothing back to the host.

`-m slow` runs presto_tpu live against the frozen values (about two
minutes), and recomputes chip_smoke.py's DEC_REFERENCE_SF1 from
presto_tpu at SF1 (several minutes).
"""

import datetime

import numpy as np
import pytest

from presto_tpu_torch import decimal_queries as DQ
from tests import torch_decimal_common as DC
from tests.torch_functions_common import static_pass_builds
from tests.torch_threads import torch_one_thread  # noqa: F401

SF = 0.01
RTOL = 1e-9


@pytest.fixture(scope="module")
def tables():
    return DC.port_tables(SF)


@pytest.fixture(scope="module")
def runs(tables):
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = DC.run("port", tables, mode)
        return cache[mode]

    return get


@pytest.mark.parametrize("mode", DC.MODES)
@pytest.mark.parametrize("sid", [sid for sid, _s in DQ.SCRIPT])
def test_statement_matches_presto_tpu(sid, mode, runs):
    want = DQ.expand_reference(DC.frozen(), mode)[sid]
    got = runs(mode)[sid]
    assert DQ.mismatch(sid, got, want, RTOL) == ""
    if sid in DQ.RAISES:  # "compiled" raises StaticFallback, WriteError
        assert got["error"] is not None
        assert mode == "compiled" or got["error"][0] == DQ.RAISES[sid]


def test_short_decimal_query_runs_as_a_graph(runs):
    assert runs("auto")["NG"]["memo"] == ["executable"]
    assert runs("auto")["NG"]["mode"] == "compiled"
    long_plans = [sid for sid, r in runs("auto").items()
                  if r["memo"] == ["DYNAMIC"]]
    assert {"N2", "N4", "N5", "N6", "N7", "N9"} <= set(long_plans)


def _days(text):
    return (datetime.date.fromisoformat(text)
            - datetime.date(1970, 1, 1)).days


def _cents(x):
    """DOUBLE -> the unscaled DECIMAL(12,2) value, half away from zero
    (CAST(x AS DECIMAL(12,2)))."""
    return (np.sign(x) * np.floor(np.abs(x) * 100 + 0.5)).astype(np.int64)


@pytest.fixture(scope="module")
def lineitem(tables):
    t = next(t for t in tables if t.name == "lineitem")
    d = t.read(["l_returnflag", "l_linestatus", "l_shipdate", "l_quantity",
                "l_extendedprice", "l_discount"])
    return {k: (np.asarray(v) if k in ("l_returnflag", "l_linestatus",
                                         "l_shipdate") else _cents(
                np.asarray(v, np.float64)))
            for k, v in d.items()}


def _dec(unscaled: int, scale: int) -> str:
    from decimal import Decimal

    return "d:" + str(Decimal(unscaled).scaleb(-scale))


def test_n2_equals_python_decimal(lineitem, runs):
    li = lineitem
    keep = li["l_shipdate"] <= _days("1998-09-02")
    groups = {}
    for rf, ls, q, p, d in zip(li["l_returnflag"][keep],
                               li["l_linestatus"][keep],
                               li["l_quantity"][keep].tolist(),
                               li["l_extendedprice"][keep].tolist(),
                               li["l_discount"][keep].tolist()):
        g = groups.setdefault((str(rf), str(ls)), [0, 0, 0, 0])
        g[0] += q
        g[1] += p
        g[2] += p * (100 - d)  # scale 4
        g[3] += 1
    want = [[rf, ls, _dec(g[0], 2), _dec(g[1], 2), _dec(g[2], 4), g[3]]
            for (rf, ls), g in sorted(groups.items())]
    for mode in ("dynamic", "auto"):
        got = [r[:5] + [r[8]] for r in runs(mode)["N2"]["rows"]]
        assert got == want, mode


def test_n4_equals_python_decimal(lineitem, runs):
    li = lineitem
    keep = (li["l_shipdate"] >= _days("1994-01-01")) \
        & (li["l_shipdate"] < _days("1995-01-01")) \
        & (li["l_discount"] >= 5) & (li["l_discount"] <= 7) \
        & (li["l_quantity"] < 2400)
    total = sum(p * d for p, d in zip(li["l_extendedprice"][keep].tolist(),
                                      li["l_discount"][keep].tolist()))
    for mode in ("dynamic", "auto"):
        assert runs(mode)["N4"]["rows"] == [[_dec(total, 4)]], mode


def test_graph_static_pass_reads_nothing_back(tables):
    """NG's static pass (what "auto" captures on a card) with every host
    read and Python scalar store patched to raise: it builds, and its
    rows are the dynamic run's."""
    from presto_tpu_torch.catalog import Catalog

    cat = Catalog()
    for t in tables:
        cat.register(t)
    import presto_tpu_torch

    presto_tpu_torch.connect(cat, device="cpu",
                             execution_mode="dynamic").sql(
        DQ.statement("N1a"))
    result, built = static_pass_builds(DQ.statement("NG"), cat)
    assert len(built) == 1
    dyn = presto_tpu_torch.connect(cat, device="cpu",
                                   execution_mode="dynamic").sql(
        DQ.statement("NG"))
    assert DQ.values(result.rows) == DQ.values(dyn.rows)


@pytest.mark.slow
def test_frozen_values_are_presto_tpus():
    got = DQ.compact_reference(DC._jsonable(DC.reference(SF)))
    assert got == DC.frozen()


@pytest.mark.slow
def test_sf1_reference_is_presto_tpus():
    import chip_smoke

    got = DQ.compact_reference(DC._jsonable(DC.reference(1)))
    for mode in DC.MODES:
        mine = DQ.expand_reference(got, mode)
        theirs = DQ.expand_reference(chip_smoke.DEC_REFERENCE_SF1, mode)
        assert DQ.script_mismatches(mine, theirs, RTOL) == [], mode
