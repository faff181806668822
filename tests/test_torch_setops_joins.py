"""The relational corpus of presto_tpu_torch (presto_tpu_torch/
relational_queries.py: window functions, UNION ALL, ROLLUP, EXCEPT,
INTERSECT, FULL and CROSS joins) and the set operations and joins around
it, against presto_tpu on the CPU at SF0.01.

Each query runs in `execution_mode` "dynamic" and in "auto" (compiled
mode, the default) in both packages (W3 to W6, tests/test_window.py's
texts, in tests/test_torch_window.py).  Three things must equal
presto_tpu's: the rows (keys and counts equal, floats within rtol 1e-9),
the seven counters of ordering-aware execution and dynamic filtering in
QueryStats, and the compiled memo's entry.  Where sqlite runs the query
its rows must agree too; sqlite has no ROLLUP, CUBE or GROUPING SETS, so
those are held against a hand-expanded UNION ALL text.  Optimized plans
print identically in both packages, and every static pass reads
nothing back to the host.  The cross join over its size bound raises
presto_tpu's error in each mode, and compact and concat_batches equal
presto_tpu's on the same seeded inputs.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto_tpu
import presto_tpu_torch
from presto_tpu import types as RT
from presto_tpu.batch import Batch as RBatch
from presto_tpu.batch import Column as RColumn
from presto_tpu.batch import Dictionary as RDictionary
from presto_tpu.catalog import Catalog as RCatalog
from presto_tpu.exec import kernels as RK
from presto_tpu.exec.executor import plan_statement as ref_plan_statement
from presto_tpu.plan.nodes import plan_tree_str as ref_plan_tree_str
from presto_tpu.sql.parser import parse as ref_parse
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column, Dictionary
from presto_tpu_torch.catalog import Catalog, tpch_catalog
from presto_tpu_torch.exec import compile_cache as CC
from presto_tpu_torch.exec import kernels as K
from presto_tpu_torch.exec.executor import (ExecutionError, StaticFallback,
                                            plan_statement)
from presto_tpu_torch.plan.nodes import plan_tree_str
from presto_tpu_torch.relational_queries import QUERIES as CORPUS
from presto_tpu_torch.sql.parser import parse
from tests.sqlite_oracle import assert_same_results, to_sqlite
from tests.test_torch_compiled import HostRead, _memo_state, no_host_reads
from tests.test_torch_tpch import _assert_rows_match, counters

MODES = ("dynamic", "auto")

#: set operations and grouping sets beyond the corpus, over TPC-H
EXTRA = {
    "union_distinct": ("SELECT n_name AS x FROM nation WHERE n_regionkey = 1 "
                       "UNION SELECT r_name FROM region "
                       "UNION SELECT n_name FROM nation WHERE n_nationkey < 3 "
                       "ORDER BY x"),
    "union_all_dictionaries": ("SELECT n_name FROM nation UNION ALL "
                               "SELECT r_name FROM region ORDER BY 1"),
    "cube": ("SELECT l_returnflag, l_linestatus, count(*), sum(l_quantity) "
             "FROM lineitem GROUP BY CUBE (l_returnflag, l_linestatus) "
             "ORDER BY 1, 2"),
    "grouping_sets": ("SELECT o_orderpriority, o_orderstatus, count(*), "
                      "sum(o_totalprice), "
                      "grouping(o_orderpriority, o_orderstatus) g "
                      "FROM orders GROUP BY GROUPING SETS "
                      "((o_orderpriority), (o_orderstatus), ()) "
                      "ORDER BY 1, 2"),
    "full_join_filter": ("SELECT n_name, r_name FROM nation FULL JOIN region "
                         "ON n_regionkey = r_regionkey AND r_regionkey < 2 "
                         "ORDER BY 1, 2"),
    "cross_join_filter": ("SELECT n_name, r_name FROM nation CROSS JOIN "
                          "region WHERE n_regionkey < r_regionkey "
                          "ORDER BY 1, 2"),
}

#: the oracle's text where sqlite cannot run the query's own: grouping
#: sets as the UNION ALL of their groupings
SQLITE_OVERRIDES = {
    "S2": ("SELECT l_returnflag, l_linestatus, sum(l_quantity), "
           "sum(l_extendedprice), count(*) FROM lineitem "
           "GROUP BY l_returnflag, l_linestatus UNION ALL "
           "SELECT l_returnflag, NULL, sum(l_quantity), sum(l_extendedprice), "
           "count(*) FROM lineitem GROUP BY l_returnflag UNION ALL "
           "SELECT NULL, NULL, sum(l_quantity), sum(l_extendedprice), "
           "count(*) FROM lineitem"),
    "cube": ("SELECT l_returnflag, l_linestatus, count(*), sum(l_quantity) "
             "FROM lineitem GROUP BY l_returnflag, l_linestatus UNION ALL "
             "SELECT l_returnflag, NULL, count(*), sum(l_quantity) "
             "FROM lineitem GROUP BY l_returnflag UNION ALL "
             "SELECT NULL, l_linestatus, count(*), sum(l_quantity) "
             "FROM lineitem GROUP BY l_linestatus UNION ALL "
             "SELECT NULL, NULL, count(*), sum(l_quantity) FROM lineitem"),
    "grouping_sets": ("SELECT o_orderpriority, NULL, count(*), "
                      "sum(o_totalprice), 1 FROM orders "
                      "GROUP BY o_orderpriority UNION ALL "
                      "SELECT NULL, o_orderstatus, count(*), "
                      "sum(o_totalprice), 2 FROM orders "
                      "GROUP BY o_orderstatus UNION ALL "
                      "SELECT NULL, NULL, count(*), sum(o_totalprice), 3 "
                      "FROM orders"),
}

QUERIES = {**CORPUS, **EXTRA}
# W3 to W6 are tests/test_window.py's texts, which
# tests/test_torch_window.py runs through the same checks
RUN = sorted(set(QUERIES) - {"W3", "W4", "W5", "W6"})
# rows whose order the ORDER BY fixes completely (NULL keys sort last
# in both packages, first in sqlite: the oracle compares multisets)
ORDERED = {"W1", "W2", "S1", "J2", "union_distinct",
           "union_all_dictionaries", "cross_join_filter"}

#: NULL-keyed set operations and empty-side outer joins over VALUES (the
#: reference's cases of tests/test_semijoin_nulls.py), with presto_tpu's
#: rows.  The planner lowers INTERSECT and EXCEPT to SEMI and ANTI joins,
#: where a NULL key matches nothing: both packages drop the NULL from
#: INTERSECT and keep it in EXCEPT, where SQL's set semantics (and
#: sqlite) keep it and drop it
VALUES_CASES = {
    "intersect_nulls": (
        "SELECT a FROM (VALUES (1), (2), (CAST(NULL AS BIGINT))) t(a) "
        "INTERSECT SELECT b FROM (VALUES (2), (CAST(NULL AS BIGINT)), (3)) "
        "u(b) ORDER BY a", [(2,)]),
    "except_nulls": (
        "SELECT a FROM (VALUES (1), (2), (CAST(NULL AS BIGINT)), (1)) t(a) "
        "EXCEPT SELECT b FROM (VALUES (2), (CAST(NULL AS BIGINT))) u(b)",
        [(1,), (None,)]),
    "union_nulls": (
        "SELECT a FROM (VALUES (1), (CAST(NULL AS BIGINT))) t(a) UNION "
        "SELECT b FROM (VALUES (CAST(NULL AS BIGINT)), (1), (4)) u(b) "
        "ORDER BY a", [(1,), (4,), (None,)]),
    "right_empty_probe": (
        "SELECT k FROM (SELECT 1 AS x FROM (VALUES (1)) v(q) LIMIT 0) l "
        "RIGHT JOIN (VALUES (1), (2)) u(k) ON l.x = u.k ORDER BY k",
        [(1,), (2,)]),
    "full_empty_probe": (
        "SELECT x, k FROM (SELECT q AS x FROM (VALUES (9)) v(q) LIMIT 0) l "
        "FULL JOIN (VALUES (1)) u(k) ON l.x = u.k", [(None, 1)]),
    "left_empty_build": (
        "SELECT k FROM (VALUES (1), (2)) u(k) LEFT JOIN "
        "(SELECT 5 AS y FROM (VALUES (0)) w(z) LIMIT 0) r "
        "ON u.k = r.y ORDER BY k", [(1,), (2,)]),
    "full_both_sides": (
        "SELECT a, b FROM (VALUES (1), (2), (CAST(NULL AS BIGINT))) t(a) "
        "FULL JOIN (VALUES (2), (3), (CAST(NULL AS BIGINT))) u(b) "
        "ON a = b ORDER BY a, b",
        [(1, None), (2, 2), (None, 3), (None, None), (None, None)]),
}


def _cached(session):
    cache = {}

    def run(name, sql):
        if name not in cache:
            cache[name] = (session.sql(sql), _memo_state(session, sql))
        return cache[name]

    return run


@pytest.fixture(scope="module")
def runs(tpch_catalog_tiny):
    """{(package, mode): run(name, sql)}, one session a package and
    mode, each query run once on first use."""
    cat = tpch_catalog(0.01)
    out = {}
    for mode in MODES:
        out["port", mode] = _cached(presto_tpu_torch.connect(
            cat, device="cpu", execution_mode=mode))
        out["ref", mode] = _cached(presto_tpu.connect(
            tpch_catalog_tiny, execution_mode=mode))
    return out


def assert_matches_reference(mine, mine_memo, ref, ref_memo, ordered):
    _assert_rows_match(mine.rows, ref.rows, ordered)
    assert counters(mine.stats) == counters(ref.stats)
    assert mine.stats.execution_mode == ref.stats.execution_mode
    assert mine_memo == ref_memo


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", RUN)
def test_query_matches_reference(name, mode, runs):
    sql = QUERIES[name]
    assert_matches_reference(*runs["port", mode](name, sql),
                             *runs["ref", mode](name, sql),
                             name in ORDERED)


@pytest.mark.parametrize("name", RUN)
def test_query_matches_oracle(name, runs, tpch_sqlite_tiny):
    sql = QUERIES[name]
    expected = tpch_sqlite_tiny.execute(
        to_sqlite(SQLITE_OVERRIDES.get(name, sql))).fetchall()
    for mode in MODES:
        assert_same_results(runs["port", mode](name, sql)[0].rows, expected,
                            ordered=name in ORDERED)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_optimized_plans_print_identically(name, tpch_catalog_tiny):
    ref = ref_plan_statement(presto_tpu.connect(tpch_catalog_tiny),
                             ref_parse(QUERIES[name]))
    port = plan_statement(
        presto_tpu_torch.connect(tpch_catalog(0.01), device="cpu"),
        parse(QUERIES[name]))
    assert plan_tree_str(port.root) == ref_plan_tree_str(ref.root)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(VALUES_CASES))
def test_values_case_matches_reference(name, mode):
    sql, rows = VALUES_CASES[name]
    port = presto_tpu_torch.connect(Catalog(), device="cpu",
                                    execution_mode=mode)
    ref = presto_tpu.connect(RCatalog(), execution_mode=mode)
    mine, theirs = port.sql(sql), ref.sql(sql)
    assert sorted(mine.rows, key=repr) == sorted(rows, key=repr)
    assert_matches_reference(mine, _memo_state(port, sql), theirs,
                             _memo_state(ref, sql), True)


# ---- no host read in the static pass ----------------------------------------


@contextlib.contextmanager
def no_scalar_stores():
    """A Python scalar stored into a tensor (`t[0] = True`) raises
    HostRead while the block runs: on a CUDA tensor the store
    synchronizes, which graph capture forbids."""
    real = torch.Tensor.__setitem__

    def store(self, key, value):
        if not isinstance(value, torch.Tensor):
            raise HostRead(f"a Python {type(value).__name__} stored")
        return real(self, key, value)

    torch.Tensor.__setitem__ = store
    try:
        yield
    finally:
        torch.Tensor.__setitem__ = real


def test_the_patch_catches_a_scalar_store():
    new = torch.zeros(3, dtype=torch.bool)
    with pytest.raises(HostRead), no_scalar_stores():
        new[0] = True
    new[1:] = torch.ones(2, dtype=torch.bool)  # restored
    assert new.tolist() == [False, True, True]


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_static_pass_reads_nothing_back(name):
    """Each query's static pass (the program compiled mode captures on a
    card) up to its packed fetch, with every host read of
    tests/test_torch_compiled.py and every scalar store made to raise."""
    real = CC.build_graph
    built = []

    def build(fn, example, device=None):
        def program(*args):
            with no_host_reads(), no_scalar_stores():
                out = fn(*args)
            built.append(out)
            return out

        return real(program, example, device)

    CC.build_graph = build
    try:
        result = presto_tpu_torch.connect(tpch_catalog(0.01),
                                          device="cpu").sql(QUERIES[name])
    finally:
        CC.build_graph = real
    # a StaticFallback (full_join_filter's unbounded fanout, as in
    # presto_tpu) builds nothing and runs dynamic
    assert len(built) == (result.stats.execution_mode == "compiled")


# ---- the cross join's size bound --------------------------------------------

TOO_LARGE = "SELECT count(*) FROM lineitem CROSS JOIN orders"


@pytest.mark.parametrize("mode,error", [("dynamic", ExecutionError),
                                        ("auto", ExecutionError),
                                        ("compiled", StaticFallback)])
def test_too_large_cross_join_raises_the_reference_error(mode, error,
                                                        tpch_catalog_tiny):
    """The dynamic executor raises ExecutionError over 50,000,000 rows
    after compaction; the static one StaticFallback before it, which
    "auto" answers with the dynamic executor and "compiled" raises."""
    from presto_tpu.exec.executor import ExecutionError as RExecutionError
    from presto_tpu.exec.executor import StaticFallback as RStaticFallback

    ref_error = {ExecutionError: RExecutionError,
                 StaticFallback: RStaticFallback}[error]
    with pytest.raises(ref_error) as theirs:
        presto_tpu.connect(tpch_catalog_tiny,
                           execution_mode=mode).sql(TOO_LARGE)
    with pytest.raises(error) as mine:
        presto_tpu_torch.connect(tpch_catalog(0.01), device="cpu",
                                 execution_mode=mode).sql(TOO_LARGE)
    assert str(mine.value) == str(theirs.value)
    assert str(mine.value).startswith(
        ("cross join too large: ", "static cross join too large: "))


# ---- compact and concat_batches against presto_tpu's ------------------------

def _pair(n, seed, live_share, with_dict=None, null_share=0.0):
    """One batch in each package from the same seeded numpy columns: an
    int64, a float64 with NULLs, an int32 and a string column (codes
    into `with_dict`)."""
    rng = np.random.default_rng(seed)
    sel = rng.random(n) < live_share
    a = rng.integers(-2**40, 2**40, n)
    f = rng.standard_normal(n)
    fv = rng.random(n) >= null_share
    i = rng.integers(-1000, 1000, n).astype(np.int32)
    words = with_dict if with_dict is not None else np.array(["x"])
    s = rng.integers(0, len(words), n).astype(np.int32)
    port_dict, ref_dict = Dictionary(words), RDictionary(words)
    port = Batch({"a": Column(torch.from_numpy(a), None, T.BIGINT),
                  "f": Column(torch.from_numpy(f), torch.from_numpy(fv),
                              T.DOUBLE),
                  "i": Column(torch.from_numpy(i), None, T.INTEGER),
                  "s": Column(torch.from_numpy(s), None, T.VARCHAR,
                              port_dict)},
                 torch.from_numpy(sel))
    ref = RBatch({"a": RColumn(jnp.asarray(a), None, RT.BIGINT),
                  "f": RColumn(jnp.asarray(f), jnp.asarray(fv), RT.DOUBLE),
                  "i": RColumn(jnp.asarray(i), None, RT.INTEGER),
                  "s": RColumn(jnp.asarray(s), None, RT.VARCHAR, ref_dict)},
                 jnp.asarray(sel))
    return port, ref


def _assert_batches_equal(port, ref):
    assert list(port.columns) == list(ref.columns)
    assert np.array_equal(port.sel.numpy(), np.asarray(ref.sel))
    for name, c in port.columns.items():
        r = ref.columns[name]
        assert np.array_equal(c.data.numpy(), np.asarray(r.data)), name
        assert (c.valid is None) == (r.valid is None), name
        if c.valid is not None:
            assert np.array_equal(c.valid.numpy(), np.asarray(r.valid))
        assert (c.dictionary is None) == (r.dictionary is None), name
        if c.dictionary is not None:
            assert list(c.dictionary.values) == list(r.dictionary.values)


@pytest.mark.parametrize("n,live_share,seed", [(1000, 0.3, 1), (777, 1.0, 2),
                                               (500, 0.0, 3), (0, 0.5, 4)])
def test_compact_matches_reference(n, live_share, seed):
    port, ref = _pair(n, seed, live_share, null_share=0.2)
    _assert_batches_equal(K.compact(port), RK.compact(ref))


@pytest.mark.parametrize("case", ["same_dictionary", "merged_dictionaries",
                                  "typed_null_branch"])
def test_concat_batches_matches_reference(case):
    words1 = np.array(["apple", "kiwi", "pear"])
    words2 = np.array(["apple", "banana", "kiwi", "zucchini"])
    p1, r1 = _pair(300, 5, 0.6, words1)
    if case == "same_dictionary":
        p2 = Batch(dict(p1.columns), p1.sel.flip(0))
        r2 = RBatch(dict(r1.columns), jnp.flip(r1.sel))
    else:
        p2, r2 = _pair(200, 6, 0.4, words2, null_share=0.5)
    if case == "typed_null_branch":
        # a grouping set's padding: the string column typed NULL, no
        # dictionary
        n = p2.capacity
        p2.columns["s"] = Column(torch.zeros(n, dtype=torch.int32),
                                 torch.zeros(n, dtype=torch.bool), T.VARCHAR)
        r2.columns["s"] = RColumn(jnp.zeros(n, jnp.int32),
                                  jnp.zeros(n, bool), RT.VARCHAR)
    _assert_batches_equal(K.concat_batches([p1, p2, p1]),
                          RK.concat_batches([r1, r2, r1]))


def sf_states(sf, names, cache_dir=None):
    """{name: {"memo": [presto_tpu's memo entry, the port's], "counters":
    [presto_tpu's, the port's]}} for corpus queries run on the CPU at
    scale factor `sf`, once in "auto" and once in "dynamic" in each
    package ({"compiled": [...], "dynamic": [...]} in SORT_STATS_KEYS
    order; "compiled" is the "auto" run's, a tripped guard's dynamic
    rerun included), with the port's rows as a check."""
    from presto_tpu.catalog import tpch_catalog as ref_catalog

    out = {name: {"memo": [], "counters": [], "rows": []} for name in names}
    for lib, cat, kw in ((presto_tpu, ref_catalog(sf, cache_dir), {}),
                         (presto_tpu_torch, tpch_catalog(sf, cache_dir),
                          {"device": "cpu"})):
        auto = lib.connect(cat, **kw)
        dynamic = lib.connect(cat, execution_mode="dynamic", **kw)
        for name in names:
            got = {}
            for mode, session in (("compiled", auto), ("dynamic", dynamic)):
                result = session.sql(CORPUS[name])
                got[mode] = counters(result.stats)
            out[name]["memo"].append(_memo_state(auto, CORPUS[name]))
            out[name]["counters"].append(
                {m: list(c.values()) for m, c in got.items()})
            out[name]["rows"].append(len(result.rows))
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python -m tests.test_torch_setops_joins SF
    # NAME[,NAME...] [CACHE_DIR]: one JSON line of both packages' memo
    # entries and counters for corpus queries (chip_smoke.py's
    # REFERENCE_COUNTERS_SF1 and REFERENCE_MEMO_SF1 for them came from
    # this, one query a process)
    import json
    import sys

    names = sys.argv[2].split(",")
    states = sf_states(float(sys.argv[1]), names,
                       sys.argv[3] if len(sys.argv) > 3 else None)
    print(json.dumps({
        "sf": float(sys.argv[1]),
        **{pkg: {n: {"memo": r["memo"][i], "counters": r["counters"][i],
                     "rows": r["rows"][i]}
                 for n, r in states.items()}
           for i, pkg in enumerate(("presto_tpu", "presto_tpu_torch"))}}))
