"""Joins through presto_tpu_torch against presto_tpu and the sqlite
oracle, on the CPU at SF0.01: TPC-H Q3 and Q18 and the join shapes
around them (fan-out, LEFT, ANTI, MARK with a NULL, string keys whose
dictionaries differ).

Both packages see identical data: the port gets the reference's
generated columns as plain numpy (catalog_from_numpy).  Keys and counts
must be equal; sums agree to rtol 1e-9, the tolerance the reference
holds itself to across summation orders.
"""

import math
import sqlite3

import numpy as np
import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu.catalog import Catalog as RefCatalog
from presto_tpu.exec.executor import plan_statement as ref_plan_statement
from presto_tpu.plan.nodes import plan_tree_str as ref_plan_tree_str
from presto_tpu.sql.parser import parse as ref_parse
from presto_tpu import types as RT
from presto_tpu_torch.catalog import catalog_from_numpy, tpch_catalog
from presto_tpu_torch.exec import gather as G
from presto_tpu_torch.exec.executor import plan_statement
from presto_tpu_torch.plan.nodes import plan_tree_str
from presto_tpu_torch.sql.parser import parse
from presto_tpu_torch.tpch_queries import QUERIES
from tests.sqlite_oracle import to_sqlite
from tests.torch_threads import torch_one_thread  # noqa: F401

RTOL = 1e-9
Q18_250 = QUERIES[18].replace("> 300", "> 250")

JOIN_QUERIES = {
    "q3": QUERIES[3],
    "q18": QUERIES[18],
    "q18_250": Q18_250,
    # lineitem x lineitem on l_orderkey: up to 7 x 7 matches per order
    "fanout": ("SELECT a.l_orderkey, count(*), sum(b.l_quantity) "
               "FROM lineitem a, lineitem b "
               "WHERE a.l_orderkey = b.l_orderkey "
               "GROUP BY a.l_orderkey ORDER BY a.l_orderkey"),
    # a filter across both sides: SEMI and ANTI through the expansion
    "exists_filter": ("SELECT count(*), sum(c_acctbal) FROM customer "
                      "WHERE EXISTS (SELECT * FROM orders "
                      "WHERE o_custkey = c_custkey "
                      "AND o_totalprice > c_acctbal * 40)"),
    "not_exists_filter": ("SELECT count(*) FROM customer "
                          "WHERE NOT EXISTS (SELECT * FROM orders "
                          "WHERE o_custkey = c_custkey "
                          "AND o_totalprice > c_acctbal * 40)"),
    "left": ("SELECT c_custkey, count(o_orderkey), sum(o_totalprice) "
             "FROM customer LEFT JOIN orders ON c_custkey = o_custkey "
             "GROUP BY c_custkey ORDER BY c_custkey"),
    "left_filter": ("SELECT c_custkey, count(o_orderkey) "
                    "FROM customer LEFT JOIN orders ON c_custkey = o_custkey "
                    "AND o_totalprice > c_acctbal * 40 "
                    "GROUP BY c_custkey ORDER BY c_custkey"),
    "right": ("SELECT count(*), count(c_custkey), sum(o_totalprice) "
              "FROM customer RIGHT JOIN orders "
              "ON c_custkey = o_custkey AND c_nationkey = 3"),
    "not_exists": ("SELECT count(*) FROM customer WHERE NOT EXISTS "
                   "(SELECT * FROM orders WHERE o_custkey = c_custkey)"),
    "in": ("SELECT count(*), sum(o_totalprice) FROM orders "
           "WHERE o_custkey IN (SELECT c_custkey FROM customer "
           "WHERE c_nationkey = 7)"),
}
EXPECTED_ROWS = {"q3": 10, "q18": 0, "q18_250": 59}


@pytest.fixture(scope="module")
def port_tpch(tpch_catalog_tiny):
    tables = {}
    for name in ("customer", "orders", "lineitem"):
        t = tpch_catalog_tiny.get(name)
        tables[name] = {"schema": {c: str(ty) for c, ty in t.schema.items()},
                        "columns": t.read(list(t.schema))}
    return catalog_from_numpy(tables)


def _assert_rows_match(actual, expected):
    assert len(actual) == len(expected)
    for ra, re_ in zip(actual, expected):
        assert len(ra) == len(re_)
        for va, ve in zip(ra, re_):
            if isinstance(va, float) or isinstance(ve, float):
                assert math.isclose(va, ve, rel_tol=RTOL, abs_tol=0), \
                    (ra, re_)
            else:
                assert va == ve, (ra, re_)


@pytest.mark.parametrize("name", list(JOIN_QUERIES))
def test_join_matches_reference_and_oracle(name, port_tpch,
                                           tpch_catalog_tiny,
                                           tpch_sqlite_tiny):
    sql = JOIN_QUERIES[name]
    rows = presto_tpu_torch.connect(port_tpch, device="cpu").sql(sql).rows
    ref = presto_tpu.connect(tpch_catalog_tiny).sql(sql).rows
    oracle = tpch_sqlite_tiny.execute(to_sqlite(sql)).fetchall()
    if name in EXPECTED_ROWS:
        assert len(rows) == EXPECTED_ROWS[name]
    _assert_rows_match(rows, ref)
    if "ORDER BY" not in sql:
        oracle = sorted(oracle)
        rows = sorted(rows)
    _assert_rows_match(rows, oracle)


@pytest.mark.parametrize("df", [True, False])
@pytest.mark.parametrize("qid", [3, 18])
def test_dynamic_filtering_does_not_change_rows(qid, df, port_tpch,
                                                tpch_catalog_tiny):
    """The port applies no runtime filter; its rows equal the reference's
    with dynamic filtering on (Q18 produces and applies one) and off."""
    sql = Q18_250 if qid == 18 else QUERIES[qid]
    rows = presto_tpu_torch.connect(port_tpch, device="cpu",
                                    dynamic_filtering=df).sql(sql).rows
    ref = presto_tpu.connect(tpch_catalog_tiny,
                             dynamic_filtering=df).sql(sql).rows
    assert len(rows) == EXPECTED_ROWS["q3" if qid == 3 else "q18_250"]
    _assert_rows_match(rows, ref)


@pytest.mark.parametrize("qid", [3, 18])
def test_optimized_join_plans_print_identically(qid, tpch_catalog_tiny):
    ref = ref_plan_statement(presto_tpu.connect(tpch_catalog_tiny),
                             ref_parse(QUERIES[qid]))
    port = plan_statement(
        presto_tpu_torch.connect(tpch_catalog(0.01), device="cpu"),
        parse(QUERIES[qid]))
    assert plan_tree_str(port.root) == ref_plan_tree_str(ref.root)


@pytest.mark.parametrize("qid", [3, 18])
def test_forced_staging_gives_the_same_rows(qid, port_tpch, monkeypatch):
    """With the staged route forced at test sizes, every large gather of
    the query goes through block_gather (here its plain version) and the
    rows do not change."""
    sql = Q18_250 if qid == 18 else QUERIES[qid]
    # the dynamic executor's gathers (compiled mode's are held in
    # tests/test_torch_compiled.py)
    flat = presto_tpu_torch.connect(port_tpch, device="cpu",
                                    execution_mode="dynamic").sql(sql).rows
    monkeypatch.setattr(G, "_staging_enabled", lambda device: True)
    monkeypatch.setattr(G, "_STAGED_MIN_INDICES", 1000)
    monkeypatch.setattr(G, "_IB", 64)
    shapes = []
    real = G.block_gather

    def spy(src, sidx):
        shapes.append((tuple(src.shape), tuple(sidx.shape)))
        return real(src, sidx)

    monkeypatch.setattr(G, "block_gather", spy)
    staged = presto_tpu_torch.connect(port_tpch, device="cpu",
                                      execution_mode="dynamic").sql(sql).rows
    assert staged == flat
    # customer at orders (4 words), orders at lineitem (12 / 11 words),
    # and for Q18 the subquery's l_orderkey group keys (2 words)
    want = [(1500, 4), (15000, 12)] if qid == 3 else \
        [(59833, 2), (1500, 4), (15000, 11)]
    assert [s for s, _ in shapes] == want


# ---- small tables: NULLs in a subquery, string keys ------------------------

_T1 = {"k": np.arange(1, 9, dtype=np.int64),
       "s": np.array(["ant", "bee", "cat", "dog", "eel", "fox", "gnu",
                      "hen"], dtype=object)}
_T2 = {"k": np.ma.masked_array(np.array([2, 3, 5, 0, 11], dtype=np.int64),
                               mask=[False, False, False, True, False]),
       "s": np.array(["cat", "yak", "ant", "cat", "zebu"], dtype=object),
       "v": np.array([1.5, 2.5, 3.5, 4.5, 5.5])}
_SCHEMAS = {"t1": {"k": "BIGINT", "s": "VARCHAR"},
            "t2": {"k": "BIGINT", "s": "VARCHAR", "v": "DOUBLE"}}

SMALL_QUERIES = {
    # a NULL in the subquery: NOT IN keeps no row, IN is unaffected
    "not_in_null": "SELECT k FROM t1 WHERE k NOT IN (SELECT k FROM t2) "
                   "ORDER BY k",
    "in_null": "SELECT k FROM t1 WHERE k IN (SELECT k FROM t2) ORDER BY k",
    "not_in": "SELECT k FROM t1 WHERE k NOT IN "
              "(SELECT k FROM t2 WHERE v > 1.0 AND v < 4.0) ORDER BY k",
    "not_exists": "SELECT k FROM t1 WHERE NOT EXISTS "
                  "(SELECT * FROM t2 WHERE t2.k = t1.k) ORDER BY k",
    # string keys: t1.s and t2.s have different dictionaries
    "string_key": "SELECT t1.k, t1.s, t2.v FROM t1, t2 WHERE t1.s = t2.s "
                  "ORDER BY t1.k, t2.v",
    "string_key_left": "SELECT t1.s, count(t2.v) FROM t1 LEFT JOIN t2 "
                       "ON t1.s = t2.s GROUP BY t1.s ORDER BY t1.s",
}


@pytest.fixture(scope="module")
def small_catalogs():
    tables = {"t1": _T1, "t2": _T2}
    port = catalog_from_numpy({n: {"schema": _SCHEMAS[n], "columns": t}
                               for n, t in tables.items()})
    ref = RefCatalog()
    conn = sqlite3.connect(":memory:")
    for name, cols in tables.items():
        schema = _SCHEMAS[name]
        ref.register_memory(name, {c: RT.parse_type(t)
                                   for c, t in schema.items()}, cols)
        conn.execute(f"CREATE TABLE {name} ({', '.join(schema)})")
        rows = zip(*[[None if np.ma.is_masked(v) else
                      (v.item() if isinstance(v, np.generic) else v)
                      for v in cols[c]] for c in schema])
        conn.executemany(f"INSERT INTO {name} VALUES "
                         f"({', '.join('?' * len(schema))})", rows)
    return port, ref, conn


@pytest.mark.parametrize("name", list(SMALL_QUERIES))
def test_small_joins_match_reference_and_oracle(name, small_catalogs):
    port, ref, conn = small_catalogs
    sql = SMALL_QUERIES[name]
    rows = presto_tpu_torch.connect(port, device="cpu").sql(sql).rows
    _assert_rows_match(rows, presto_tpu.connect(ref).sql(sql).rows)
    _assert_rows_match(rows, conn.execute(sql).fetchall())
    if name == "not_in_null":
        assert rows == []
