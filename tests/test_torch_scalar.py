"""The scalar functions, DISTINCT aggregates and literal rows that the 22
TPC-H queries reach, each through presto_tpu_torch and presto_tpu on the
CPU at SF0.01, rows compared: integer division and modulo (a zero
divisor included), LIKE, SUBSTRING, CASE, IF, EXTRACT and its
shorthands, IS NULL, COALESCE, NULLIF, count(DISTINCT ...) and SELECT
without FROM.

Keys, counts and strings must be equal; floats agree to rtol 1e-9, the
tolerance the reference holds itself to across summation orders.
"""

import math

import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu_torch.catalog import tpch_catalog
from tests.torch_threads import torch_one_thread  # noqa: F401

RTOL = 1e-9

# integer division and modulo by zero (ROADMAP fault C1): the reference
# returns -2 for x / 0 (x > 0), 2 for -x / 0, -1 for 0 / 0, and NULL
# for x % 0
C1 = ("SELECT o_custkey, o_custkey / 0, o_custkey % 0, -o_custkey / 0, "
      "o_shippriority / 0 FROM orders ORDER BY o_orderkey LIMIT 3")

PROBES = {
    "c1": C1,
    "int_div_mod_signs": (
        "SELECT o_orderkey, o_custkey % 7, -o_custkey % 7, o_custkey % -7, "
        "(-o_custkey) / 7, o_custkey / -7, o_custkey / (o_custkey - "
        "o_custkey), o_shippriority % o_shippriority "
        "FROM orders ORDER BY o_orderkey LIMIT 40"),
    "int_div_mod_literals": ("SELECT 7 % 0, 7 / 0, -7 / 0, 0 / 0, -7 % 3, "
                             "7 / -2, -7 / 2"),
    # the division runs over every row, also the ones the filter drops
    "div_by_zero_in_dropped_rows": (
        "SELECT count(*), sum(o_custkey / o_shippriority) FROM orders "
        "WHERE o_shippriority > 0"),
    "float_mod": ("SELECT o_orderkey, o_totalprice % 7.5, "
                  "o_totalprice % 0.0 FROM orders ORDER BY o_orderkey "
                  "LIMIT 20"),
    "like_prefix_suffix_infix": (
        "SELECT count_if(p_type LIKE 'PROMO%'), "
        "count_if(p_type LIKE '%BRASS'), count_if(p_name LIKE '%green%'), "
        "count_if(p_type NOT LIKE 'MEDIUM POLISHED%') FROM part"),
    "like_underscores_at_the_ends": (
        "SELECT p_partkey, p_name FROM part WHERE p_name LIKE '_o%' "
        "AND p_name LIKE '%e_' ORDER BY p_partkey"),
    "like_two_wildcards": (
        "SELECT count(*) FROM orders "
        "WHERE o_comment NOT LIKE '%special%requests%'"),
    "like_escape": (
        "SELECT o_orderkey, CASE WHEN o_orderkey % 3 = 0 THEN 'a_b%c' "
        "WHEN o_orderkey % 3 = 1 THEN 'axb%c' ELSE 'a_bxc' END "
        "LIKE 'a!_b!%%' ESCAPE '!' FROM orders ORDER BY o_orderkey LIMIT 12"),
    "like_literal": ("SELECT 'a_b%' LIKE 'a#_b#%' ESCAPE '#', "
                     "'axb' LIKE 'a#_b' ESCAPE '#', 'abc' LIKE '%c'"),
    "substring": (
        "SELECT c_custkey, substring(c_phone, 1, 2), substr(c_phone, 4), "
        "substring(c_name, -3), substring(c_name, -5, 2), "
        "substring(c_phone, 20) FROM customer ORDER BY c_custkey LIMIT 60"),
    "substring_literal_and_in": (
        "SELECT substring('hello', 2, 3), substr('hello', -2), count(*) "
        "FROM customer WHERE substring(c_phone, 1, 2) IN ('13', '31', '23')"),
    "case_with_else": (
        "SELECT o_orderkey, CASE WHEN o_orderpriority = '1-URGENT' THEN 1 "
        "WHEN o_orderpriority = '2-HIGH' THEN 2 ELSE 0 END "
        "FROM orders ORDER BY o_orderkey LIMIT 50"),
    "case_without_else": (
        "SELECT o_orderkey, CASE WHEN o_totalprice > 200000 "
        "THEN o_totalprice END FROM orders ORDER BY o_orderkey LIMIT 50"),
    "case_null_branches_and_null_condition": (
        "SELECT o_orderkey, CASE WHEN o_orderstatus = 'F' THEN NULL "
        "ELSE o_custkey END, CASE WHEN nullif(o_shippriority, 0) = 0 "
        "THEN 'null condition' ELSE 'else' END "
        "FROM orders ORDER BY o_orderkey LIMIT 50"),
    "case_operand_strings": (
        "SELECT o_orderkey, CASE o_orderstatus WHEN 'F' THEN 'final' "
        "WHEN 'O' THEN 'open' ELSE 'other' END, CASE WHEN o_orderkey % 3 "
        "= 0 THEN o_orderpriority ELSE 'none' END "
        "FROM orders ORDER BY o_orderkey LIMIT 50"),
    "case_in_aggregates": (
        "SELECT l_shipmode, sum(CASE WHEN l_returnflag = 'R' THEN 1 "
        "ELSE 0 END), sum(CASE WHEN l_linestatus = 'F' "
        "THEN l_extendedprice ELSE 0 END) "
        "FROM lineitem GROUP BY l_shipmode ORDER BY l_shipmode"),
    "if": ("SELECT o_orderkey, if(o_totalprice > 100000, 'big', 'small'), "
           "if(o_orderstatus = 'F', o_custkey, 0), if(o_totalprice > "
           "100000, o_orderstatus, o_orderpriority) "
           "FROM orders ORDER BY o_orderkey LIMIT 30"),
    "extract_and_shorthands": (
        "SELECT o_orderkey, extract(year FROM o_orderdate), "
        "year(o_orderdate), month(o_orderdate), day(o_orderdate), "
        "quarter(o_orderdate), extract(month FROM o_orderdate), "
        "extract(day FROM o_orderdate), extract(quarter FROM o_orderdate), "
        "extract(dow FROM o_orderdate), extract(doy FROM o_orderdate), "
        "extract(week FROM o_orderdate) "
        "FROM orders ORDER BY o_orderkey LIMIT 100"),
    "group_by_year": (
        "SELECT extract(year FROM l_shipdate) AS y, count(*), "
        "sum(l_quantity) FROM lineitem GROUP BY 1 ORDER BY 1"),
    "is_null_after_left_join": (
        "SELECT count(*), count_if(o.o_orderkey IS NOT NULL) "
        "FROM customer c LEFT JOIN orders o ON c.c_custkey = o.o_custkey "
        "WHERE o.o_orderkey IS NULL OR o.o_totalprice > 300000"),
    "is_null_on_non_null_column": (
        "SELECT count(*), count_if(o_comment IS NOT NULL) FROM orders "
        "WHERE o_comment IS NULL OR o_orderkey < 100"),
    "coalesce": (
        "SELECT c.c_custkey, coalesce(o.o_orderkey, -1), "
        "coalesce(o.o_totalprice, 0.0), coalesce(o.o_shippriority, "
        "o.o_custkey, c.c_nationkey) "
        "FROM customer c LEFT JOIN orders o ON c.c_custkey = o.o_custkey "
        "AND o.o_totalprice > 350000 ORDER BY 1, 2 LIMIT 200"),
    "nullif": (
        "SELECT o_orderkey, nullif(o_shippriority, 0), "
        "nullif(o_orderstatus, 'F'), nullif(o_custkey, 206) "
        "FROM orders ORDER BY o_orderkey LIMIT 20"),
    "count_distinct_global": (
        "SELECT count(DISTINCT o_custkey), count(DISTINCT o_orderstatus), "
        "sum(o_totalprice), count(*) FROM orders"),
    "distinct_aggregates_grouped": (
        "SELECT o_orderpriority, count(DISTINCT o_custkey), "
        "avg(o_totalprice), sum(DISTINCT o_shippriority), "
        "min(DISTINCT o_custkey), count(*) "
        "FROM orders GROUP BY 1 ORDER BY 1"),
    "count_distinct_with_nulls": (
        "SELECT c.c_nationkey, count(DISTINCT o.o_orderstatus), "
        "count(DISTINCT o.o_custkey) FROM customer c LEFT JOIN orders o "
        "ON c.c_custkey = o.o_custkey AND o.o_totalprice > 300000 "
        "GROUP BY 1 ORDER BY 1"),
    "select_without_from": "SELECT 1",
    "select_expressions_without_from": "SELECT 1 + 2 AS x, 'a' AS y",
    "values": ("SELECT x, y FROM (VALUES (1, 'a'), (2, NULL), (3, 'c')) "
               "AS t(x, y) ORDER BY x"),
}


@pytest.fixture(scope="module")
def port():
    return presto_tpu_torch.connect(tpch_catalog(0.01), device="cpu")


@pytest.fixture(scope="module")
def reference(tpch_catalog_tiny):
    return presto_tpu.connect(tpch_catalog_tiny)


def _assert_rows_match(actual, expected):
    assert len(actual) == len(expected)
    for ra, re_ in zip(actual, expected):
        assert len(ra) == len(re_)
        for va, ve in zip(ra, re_):
            if isinstance(va, float) and isinstance(ve, float):
                assert va == ve or math.isclose(va, ve, rel_tol=RTOL) \
                    or (math.isnan(va) and math.isnan(ve)), (ra, re_)
            else:
                assert va == ve, (ra, re_)


@pytest.mark.parametrize("name", list(PROBES))
def test_matches_reference(name, port, reference):
    sql = PROBES[name]
    rows = port.sql(sql).rows
    expected = reference.sql(sql).rows
    if "ORDER BY" not in sql:
        rows, expected = sorted(rows, key=repr), sorted(expected, key=repr)
    _assert_rows_match(rows, expected)


def test_c1_rows_are_the_references(port):
    rows = port.sql(C1).rows
    assert [r[1:] for r in rows] == [(-2, None, 2, -1)] * 3
    assert all(r[0] > 0 for r in rows)
