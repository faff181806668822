"""DECIMAL in presto_tpu_torch against presto_tpu on the CPU: every case
of tests/test_decimal128.py run through both packages in
execution_mode "dynamic" and "auto" (the same rows, decimals exactly,
or the same error's type and message), each also held to the Python
`decimal` values that file holds presto_tpu to; the four statements
with which a DECIMAL table could be created but never used; the
ingest of Python ints, Decimals, strings and floats into memory tables;
and the typing of decimal arithmetic."""

import random
from decimal import Decimal

import numpy as np
import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu import types as RT
from presto_tpu.catalog import Catalog as RefCatalog
from presto_tpu_torch import types as PT
from presto_tpu_torch.catalog import Catalog as PortCatalog
from tests.torch_threads import torch_one_thread  # noqa: F401

MODES = ("dynamic", "auto")


def _sessions(build=None, mode="dynamic", tpch=None):
    """(presto_tpu session, port session) over catalogs built alike:
    build(catalog, types_module) registers memory tables; `tpch` a pair
    of TPC-H catalogs to use instead."""
    if tpch is not None:
        ref_cat, port_cat = tpch
    else:
        ref_cat, port_cat = RefCatalog(), PortCatalog()
        if build is not None:
            build(ref_cat, RT)
            build(port_cat, PT)
    return (presto_tpu.connect(ref_cat, execution_mode=mode),
            presto_tpu_torch.connect(port_cat, device="cpu",
                                     execution_mode=mode))


def _outcome(session, sql):
    try:
        return ("rows", session.sql(sql).rows)
    except Exception as e:  # noqa: BLE001 - an error is an outcome here
        return ("error", type(e).__name__, str(e).split("\n")[0])


def _equal(b, a) -> bool:
    """Outcomes equal: floats within rtol 1e-9 (summation order), all
    else exactly (decimals too)."""
    if b[0] != a[0] or b[0] == "error":
        return b == a
    if len(b[1]) != len(a[1]):
        return False
    for rb, ra in zip(b[1], a[1]):
        if len(rb) != len(ra):
            return False
        for x, y in zip(rb, ra):
            if isinstance(x, float) and isinstance(y, float):
                if not (x == y or abs(x - y) <= 1e-9 * max(abs(x), abs(y))):
                    return False
            elif type(x) is not type(y) or not np.array_equal(
                    np.asarray(x, dtype=object), np.asarray(y, dtype=object)):
                return False
    return True


def _same(ref, port, sql):
    """The port's outcome of sql equals presto_tpu's; returns the rows."""
    a, b = _outcome(ref, sql), _outcome(port, sql)
    assert _equal(b, a), (sql, b, a)
    return b[1] if b[0] == "rows" else None


def _one(rows):
    assert len(rows) == 1 and len(rows[0]) == 1, rows
    return rows[0][0]


BIG = "123456789012345678901234.50"

#: (case, [(sql, expected single value or a check, or None)])
LITERAL_CASES = {
    "literal_arithmetic_exact": [
        (f"SELECT CAST('{BIG}' AS DECIMAL(38,2)) "
         "+ CAST('0.44' AS DECIMAL(38,2))",
         Decimal("123456789012345678901234.94")),
        (f"SELECT CAST('{BIG}' AS DECIMAL(38,2)) "
         "- CAST('0.51' AS DECIMAL(38,2))",
         Decimal("123456789012345678901233.99")),
        (f"SELECT -CAST('{BIG}' AS DECIMAL(38,2))",
         Decimal("-123456789012345678901234.50"))],
    "short_mul_produces_exact_long": [
        ("SELECT CAST('4000000000.12' AS DECIMAL(18,2)) "
         "* CAST('4000000001.34' AS DECIMAL(18,2))",
         Decimal("4000000000.12") * Decimal("4000000001.34")),
        ("SELECT CAST('-4000000000.12' AS DECIMAL(18,2)) "
         "* CAST('4000000001.34' AS DECIMAL(18,2))",
         -Decimal("4000000000.12") * Decimal("4000000001.34"))],
    "long_compare_and_where": [
        ("SELECT CAST('99999999999999999999.99' AS DECIMAL(38,2)) "
         "> CAST('99999999999999999999.98' AS DECIMAL(38,2))", True),
        ("SELECT CAST('99999999999999999999.99' AS DECIMAL(38,2)) "
         "= CAST('99999999999999999999.99' AS DECIMAL(38,2))", True)],
    "cast_round_trips": [
        ("SELECT CAST(CAST('12345678901234567890.123456' AS DECIMAL(38,6)) "
         "AS VARCHAR)", "12345678901234567890.123456"),
        ("SELECT CAST(CAST('123.455' AS DECIMAL(38,3)) AS DECIMAL(10,2))",
         123.46),
        ("SELECT CAST(CAST('12345678901234567890.123456' AS DECIMAL(38,6)) "
         "AS DOUBLE)", float(Decimal("12345678901234567890.123456"))),
        ("SELECT TRY_CAST('1" + "0" * 38 + "' AS DECIMAL(38,0))", None)],
    "scalar_subquery_long_decimal": [
        ("SELECT (SELECT CAST('12345.67' AS DECIMAL(38,2)))",
         Decimal("12345.67")),
        ("SELECT 1 WHERE CAST('12345.67' AS DECIMAL(38,2)) = "
         "(SELECT CAST('12345.67' AS DECIMAL(38,2)))", 1)],
    "long_to_short_cast_overflow": [
        ("SELECT CAST(CAST('99999999999999999999.00' AS DECIMAL(38,2)) "
         "AS DECIMAL(10,2))", ValueError),
        ("SELECT TRY_CAST(CAST('99999999999999999999.00' AS DECIMAL(38,2)) "
         "AS DECIMAL(10,2))", None)],
    "extreme_scale_compare_exact": [
        ("SELECT 1 WHERE CAST('" + "9" * 34 + "' AS DECIMAL(38,0)) > "
         "CAST('0.555' AS DECIMAL(38,3))", 1),
        ("SELECT 1 WHERE CAST('-" + "9" * 34 + "' AS DECIMAL(38,0)) < "
         "CAST('0.555' AS DECIMAL(38,3))", 1),
        ("SELECT CAST('" + "9" * 38 + "' AS DECIMAL(38,0)) > "
         "CAST('0.5' AS DECIMAL(38,1))", ValueError)],
    "cast_respects_declared_precision": [
        ("SELECT CAST('999999999999999999999' AS DECIMAL(19,0))", ValueError),
        ("SELECT TRY_CAST('999999999999999999999' AS DECIMAL(19,0))", None)],
    "deep_rescale_rounding_exact": [
        (f"SELECT CAST(CAST('{sign}7.{frac}' AS DECIMAL(38,25)) "
         "AS DECIMAL(38,0))", Decimal(int(sign + "1") * want))
        for frac, want in [("4" + "9" * 24, 7), ("5" + "0" * 23 + "1", 8),
                           ("5" + "0" * 24, 8)] for sign in ("", "-")],
    "long_decimal_to_bigint_overflow": [
        ("SELECT CAST(CAST('99999999999999999999.00' AS DECIMAL(38,2)) "
         "AS BIGINT)", ValueError),
        ("SELECT TRY_CAST(CAST('99999999999999999999.00' AS DECIMAL(38,2)) "
         "AS BIGINT)", None),
        ("SELECT CAST(CAST('41.50' AS DECIMAL(38,2)) AS BIGINT)", 42)],
    "decimal_typed_literal": [
        ("SELECT DECIMAL '1.5' + DECIMAL '2.25'", 3.75),
        ("SELECT DECIMAL '99999999999999999999.5' * 2",
         Decimal("199999999999999999999.0"))],
    "decimal_to_int_cast_overflow_and_rounding": [
        ("SELECT CAST(DECIMAL '2.5' AS BIGINT)", 3),
        ("SELECT CAST(DECIMAL '-2.5' AS BIGINT)", -3),
        ("SELECT CAST(DECIMAL '3000000000.5' AS BIGINT)", 3000000001),
        ("SELECT CAST(DECIMAL '3000000000.5' AS INTEGER)", ValueError),
        ("SELECT CAST(DECIMAL '40000.5' AS SMALLINT)", ValueError),
        ("SELECT CAST(DECIMAL '200.0' AS TINYINT)", ValueError),
        ("SELECT CAST(DECIMAL '99999999999999999999999999999.0' "
         "AS BIGINT)", ValueError),
        ("SELECT TRY_CAST(DECIMAL '3000000000.5' AS INTEGER)", None)],
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", sorted(LITERAL_CASES))
def test_decimal128_literal_cases(case, mode):
    ref, port = _sessions(mode=mode)
    for sql, want in LITERAL_CASES[case]:
        got = _outcome(port, sql)
        assert _equal(got, _outcome(ref, sql)), sql
        if isinstance(want, type):
            assert got[0] == "error" and got[1] == want.__name__, (sql, got)
        elif isinstance(want, float):
            assert _one(got[1]) == pytest.approx(want), sql
        else:
            assert _one(got[1]) == want, sql


def test_decimal_to_int_column_cast(mode="dynamic"):
    ref, port = _sessions(mode=mode)
    rows = _same(ref, port, "SELECT CAST(CAST(x AS DECIMAL(10,1)) AS "
                 "INTEGER) FROM (VALUES (2.5),(1.4)) t(x)")
    assert rows == [(3,), (1,)]


@pytest.fixture(scope="module")
def tpch_pair(tpch_catalog_tiny):
    from presto_tpu_torch.catalog import tpch_catalog

    return tpch_catalog_tiny, tpch_catalog(0.01)


@pytest.mark.parametrize("mode", MODES)
def test_motivating_statements(mode):
    """CREATE TABLE with a DECIMAL column, then INSERT into it, decimal
    literal arithmetic, and grouped sums and maxima of DOUBLE columns
    cast to long decimals, as presto_tpu answers them."""
    from presto_tpu.catalog import tpch_catalog as ref_tpch
    from presto_tpu_torch.catalog import tpch_catalog

    ref_cat, port_cat = RefCatalog(), PortCatalog()
    for n, t in ref_tpch(0.01, None).tables.items():
        if "." not in n and n == "lineitem":
            ref_cat.register(t)
    port_cat.register(tpch_catalog(0.01).tables["lineitem"])
    ref, port = _sessions(tpch=(ref_cat, port_cat), mode=mode)
    assert _same(ref, port, "CREATE TABLE memory.default.d "
                 "(x DECIMAL(12,2))") == [(True,)]
    assert _same(ref, port, "INSERT INTO memory.default.d "
                 "VALUES (DECIMAL '1.25')") == [(1,)]
    assert _same(ref, port, "SELECT x, x + 1, x * x FROM "
                 "memory.default.d") == [(1.25, 2.25, Decimal("1.5625"))]
    assert _same(ref, port, "SELECT DECIMAL '1.50' + DECIMAL '2.25'") \
        == [(3.75,)]
    rows = _same(ref, port, "SELECT l_returnflag, "
                 "sum(CAST(l_extendedprice AS DECIMAL(30,2))), "
                 "max(CAST(l_quantity AS DECIMAL(20,0))) FROM lineitem "
                 "GROUP BY 1 ORDER BY 1")
    assert rows[0] == ("A", Decimal("545484881.81"), Decimal("50"))


@pytest.mark.parametrize("mode", MODES)
def test_tpch_q1_exact_decimal_semantics(mode, tpch_pair):
    """test_decimal128's Q1 pipeline: DOUBLE -> VARCHAR -> DECIMAL(12,2)
    columns written by CTAS, their sums and the sum of long products,
    equal in both packages and to Python's decimal over the same
    rows."""
    ref_base, port_base = tpch_pair
    ref_cat, port_cat = RefCatalog(), PortCatalog()
    ref_cat.register(ref_base.tables["lineitem"])
    port_cat.register(port_base.tables["lineitem"])
    ref, port = _sessions(tpch=(ref_cat, port_cat), mode=mode)
    _same(ref, port, """
        CREATE TABLE memory.l AS
        SELECT l_returnflag AS rf, l_linestatus AS ls,
               CAST(CAST(l_quantity AS VARCHAR) AS DECIMAL(12,2)) AS qty,
               CAST(CAST(l_extendedprice AS VARCHAR) AS DECIMAL(12,2))
                   AS price,
               CAST(CAST(l_discount AS VARCHAR) AS DECIMAL(12,2)) AS disc
        FROM lineitem""")
    got = _same(ref, port, """
        SELECT rf, ls, sum(qty) AS sq, sum(price) AS sp,
               sum(price * (CAST('1.00' AS DECIMAL(12,2)) - disc)) AS sd
        FROM memory.l GROUP BY rf, ls ORDER BY rf, ls""")
    raw = port.sql("SELECT rf, ls, qty, price, disc FROM memory.l").rows
    agg = {}
    for rf, ls, qty, price, disc in raw:
        a = agg.setdefault((rf, ls), [Decimal(0)] * 3)
        qty, price, disc = (Decimal(str(x)).quantize(Decimal("0.01"))
                            for x in (qty, price, disc))
        a[0] += qty
        a[1] += price
        a[2] += price * (Decimal("1.00") - disc)
    want = [(rf, ls, *agg[(rf, ls)]) for rf, ls in sorted(agg)]
    assert [tuple(r) for r in got] == want


@pytest.mark.parametrize("name,a,b", [
    ("add", (12, 2), (3, 2)), ("sub", (18, 0), (12, 2)),
    ("mul", (12, 2), (12, 2)), ("mul", (10, 2), (9, 4)),
    ("add", (38, 2), (12, 2)), ("div", (12, 2), (5, 1))])
def test_decimal_result_types(name, a, b):
    from presto_tpu.functions import scalar as RS
    from presto_tpu_torch.functions import scalar as PS

    ref_t = RS.REGISTRY[name].resolve([RT.decimal(*a), RT.decimal(*b)])
    port_t = PS.REGISTRY[name].resolve([PT.decimal(*a), PT.decimal(*b)])
    assert str(port_t) == str(ref_t)
