"""TPC-H Q1 and Q6 through presto_tpu_torch against presto_tpu and the
sqlite oracle, on the CPU at SF0.01.

The port gets the reference's generated lineitem columns as plain numpy
(catalog_from_numpy), so both packages see identical data.  Keys and
counts must be equal; sums and averages agree to rtol 1e-9, the
tolerance the reference holds itself to across summation orders.
"""

import math

import numpy as np
import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu.exec.executor import plan_statement as ref_plan_statement
from presto_tpu.plan.nodes import plan_tree_str as ref_plan_tree_str
from presto_tpu.sql.parser import parse as ref_parse
from presto_tpu_torch.catalog import catalog_from_numpy, tpch_catalog
from presto_tpu_torch.exec import kernels as K
from presto_tpu_torch.exec.executor import plan_statement
from presto_tpu_torch.plan.nodes import plan_tree_str
from presto_tpu_torch.sql.parser import parse
from presto_tpu_torch.tpch_queries import QUERIES
from tests.sqlite_oracle import to_sqlite
from tests.tpch_queries import QUERIES as REF_QUERIES
from tests.torch_threads import torch_one_thread  # noqa: F401

RTOL = 1e-9
FUSED_PROBE = ("SELECT l_returnflag, count(*), sum(l_extendedprice), "
               "avg(l_quantity) FROM lineitem GROUP BY l_returnflag "
               "ORDER BY 1")


@pytest.fixture(scope="module")
def port_catalog(tpch_catalog_tiny):
    t = tpch_catalog_tiny.get("lineitem")
    return catalog_from_numpy({"lineitem": {
        "schema": {c: str(ty) for c, ty in t.schema.items()},
        "columns": t.read(list(t.schema))}})


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


@pytest.fixture
def fused_calls(monkeypatch):
    """Records the [k, n] shape and group count of every fused_group_sums
    call the executor makes."""
    calls = []
    real = K.fused_group_sums

    def spy(vals, gid, n_groups):
        calls.append((tuple(vals.shape), n_groups))
        return real(vals, gid, n_groups)

    monkeypatch.setattr(K, "fused_group_sums", spy)
    return calls


def test_query_texts_are_the_reference_corpus():
    assert QUERIES == REF_QUERIES


@pytest.mark.parametrize("qid", [1, 6])
def test_query_matches_reference_and_oracle(qid, port_catalog,
                                            tpch_catalog_tiny,
                                            tpch_sqlite_tiny, fused_calls):
    # the dynamic executor's kernel calls (compiled mode's are held in
    # tests/test_torch_compiled.py)
    rows = presto_tpu_torch.connect(port_catalog, device="cpu",
                                    execution_mode="dynamic") \
        .sql(QUERIES[qid]).rows
    ref = presto_tpu.connect(tpch_catalog_tiny).sql(QUERIES[qid]).rows
    oracle = tpch_sqlite_tiny.execute(to_sqlite(QUERIES[qid])).fetchall()
    assert len(rows) == (4 if qid == 1 else 1)
    _assert_rows_match(rows, ref)
    _assert_rows_match(rows, oracle)
    # Q1 reaches the fused kernel with 15 rows (two per sum/avg, one for
    # count(*)) over every lineitem row and 4 groups; Q6 has one sum
    n = tpch_catalog_tiny.get("lineitem").row_count()
    assert fused_calls == ([((15, n), 4)] if qid == 1 else [])


@pytest.mark.parametrize("fused", [True, False])
def test_fused_agg_in_query(fused, port_catalog, tpch_catalog_tiny,
                            fused_calls):
    s = presto_tpu_torch.connect(port_catalog, device="cpu",
                                 pallas_fused_agg=fused)
    rows = s.sql(FUSED_PROBE).rows
    assert bool(fused_calls) == fused
    ref = presto_tpu.connect(tpch_catalog_tiny).sql(FUSED_PROBE).rows
    _assert_rows_match(rows, ref)


@pytest.mark.parametrize("qid", [1, 6])
def test_optimized_plans_print_identically(qid, tpch_catalog_tiny):
    ref = ref_plan_statement(presto_tpu.connect(tpch_catalog_tiny),
                             ref_parse(QUERIES[qid]))
    port = plan_statement(
        presto_tpu_torch.connect(tpch_catalog(0.01), device="cpu"),
        parse(QUERIES[qid]))
    assert plan_tree_str(port.root) == ref_plan_tree_str(ref.root)


def test_tpch_generator_matches_reference():
    from presto_tpu.connectors import tpch as ref_tpch
    from presto_tpu_torch.connectors import tpch

    assert list(tpch.SCHEMAS) == list(ref_tpch.SCHEMAS)
    for table in tpch.SCHEMAS:
        mine = tpch.generate(table, 0.01)
        theirs = ref_tpch.generate(table, 0.01)
        assert list(mine) == list(theirs), table
        for col in theirs:
            assert np.array_equal(mine[col], theirs[col]), (table, col)


@pytest.mark.parametrize("prop,prefix", [
    ({"distributed": True}, ""),
    ({"execution_mode": "chunked"}, ""),
    # EXPLAIN ANALYZE refuses the mode on its own path
    ({"execution_mode": "chunked"}, "EXPLAIN ANALYZE ")])
def test_unported_modes_raise(prop, prefix, port_catalog):
    s = presto_tpu_torch.connect(port_catalog, device="cpu", **prop)
    with pytest.raises(NotImplementedError):
        s.sql(prefix + QUERIES[6])


@pytest.mark.parametrize("sql,name", [
    ("SELECT approx_most_frequent(3, l_shipmode, 100) FROM lineitem",
     "approx_most_frequent"),
    # CREATE TABLE AS is ported (exec/writer.py); a materialized view is
    # not
    ("CREATE MATERIALIZED VIEW t AS SELECT l_orderkey FROM lineitem",
     "CreateMaterializedView"),
    ("SELECT st_point(l_discount, l_tax) FROM lineitem", "st_point"),
    ("SELECT evaluate_classifier_predictions(l_shipmode, l_shipmode) "
     "FROM lineitem", "evaluate_classifier_predictions"),
])
def test_unported_nodes_and_functions_raise_with_their_name(
        sql, name, port_catalog, tpch_catalog_tiny):
    s = presto_tpu_torch.connect(port_catalog, device="cpu")
    if name in PORTED_SINCE:
        rows = s.sql(sql).rows
        expected = PORTED_SINCE[name]
        if expected is None:  # presto_tpu's rows, live
            expected = presto_tpu.connect(tpch_catalog_tiny).sql(sql).rows
        assert len(rows) == len(expected)
        for mine, theirs in zip(rows, expected):
            assert all(np.array_equal(np.asarray(a), np.asarray(b))
                       for a, b in zip(mine, theirs))
        return
    with pytest.raises(NotImplementedError, match=name):
        s.sql(sql)


#: names that a later slice ported: exec/host_aggs.py's, with
#: presto_tpu's rows at SF0.01, and functions/geospatial.py's and
#: ml.py's, held to presto_tpu's rows live (st_point gives an (x, y)
#: array a row)
PORTED_SINCE = {
    "approx_most_frequent": [((("FOB", 8607), ("RAIL", 8579),
                               ("TRUCK", 8644)),)],
    "st_point": None,
    "evaluate_classifier_predictions": None}
