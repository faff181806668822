"""The write path of presto_tpu_torch on the CPU against presto_tpu's:
the layout functions write_bucket_ids and write_sort_perm on seeded
numpy keys (exactly), the write properties, INSERT's coercions and
errors, a declared layout on an empty table, the SHOW family, EXPLAIN of
a write, a static pass over an engine-written table with host reads and
scalar stores patched to raise, and the NotImplementedError of every
statement and target that is not ported.  Rows, errors and arrays must
be equal exactly (floats too: these inputs are the same bits in both
packages).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import presto_tpu
import presto_tpu_torch
from presto_tpu.exec import kernels as RK
from presto_tpu.exec import writer as RW
from presto_tpu import types as RTy
from presto_tpu.catalog import Catalog as RefCatalog
from presto_tpu.catalog import MemoryTable as RefMemoryTable
from presto_tpu_torch import statement_queries as SQ
from presto_tpu_torch import types as PTy
from presto_tpu_torch.catalog import Catalog, MemoryTable
from presto_tpu_torch.exec import compile_cache as CC
from presto_tpu_torch.exec import kernels as PK
from presto_tpu_torch.exec import writer as PW
from tests.test_torch_compiled import no_host_reads
from tests.test_torch_setops_joins import no_scalar_stores
from tests.torch_threads import torch_one_thread  # noqa: F401

CPU = torch.device("cpu")
I64 = np.iinfo(np.int64)


# ---------------------------------------------------------------------------
# write_bucket_ids and write_sort_perm
# ---------------------------------------------------------------------------


def _bucket_keys(kind, rng):
    n = 4099
    if kind == "small":
        return [rng.integers(-50, 50, n)]
    if kind == "full_range":  # every bit pattern, top bit set in half
        return [rng.integers(I64.min, I64.max, n, dtype=np.int64,
                             endpoint=True)]
    if kind == "extremes":
        return [np.array([I64.min, I64.max, -1, 0, 1, I64.min + 1,
                          I64.max - 1, 1 << 62, -(1 << 62)] * 3)]
    # several key columns of mixed widths
    return [rng.integers(I64.min, I64.max, n, dtype=np.int64),
            rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
            rng.integers(0, 3, n)]


@pytest.mark.parametrize("count", [1, 2, 7, 16, 32, 1000, (1 << 31) - 1])
@pytest.mark.parametrize("kind", ["small", "full_range", "extremes",
                                  "several"])
def test_write_bucket_ids_match_reference(kind, count):
    keys = _bucket_keys(kind, np.random.default_rng(7))
    mine = PK.write_bucket_ids(keys, count, CPU)
    theirs = np.asarray(RK.write_bucket_ids(keys, count))
    assert mine.dtype == np.int32
    assert mine.tolist() == theirs.tolist()


def _sort_keys(kind, rng):
    n = 3001
    if kind == "int_ties":
        return [rng.integers(-5, 5, n)], [True]
    if kind == "int_desc":
        return [rng.integers(I64.min, I64.max, n, dtype=np.int64)], [False]
    special = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, -np.nan, 1.5,
                        -1.5, 5e-324, -5e-324])
    f = np.where(rng.random(n) < 0.3, rng.choice(special, n),
                 rng.integers(-3, 3, n).astype(np.float64))
    if kind == "float_asc":
        return [f], [True]
    if kind == "float_desc":
        return [f], [False]
    # nulls-last flags, then string codes, then a float, mixed directions
    return ([(rng.random(n) < 0.1).astype(np.int8), rng.integers(0, 4, n),
             f, rng.integers(-2, 2, n).astype(np.int32)],
            [True, False, True, False])


@pytest.mark.parametrize("kind", ["int_ties", "int_desc", "float_asc",
                                  "float_desc", "mixed"])
def test_write_sort_perm_matches_reference(kind):
    keys, asc = _sort_keys(kind, np.random.default_rng(11))
    mine = PK.write_sort_perm(keys, CPU, asc)
    theirs = np.asarray(RK.write_sort_perm(keys, asc))
    assert mine.tolist() == theirs.tolist()


# ---------------------------------------------------------------------------
# write properties, pages and coercions
# ---------------------------------------------------------------------------

SCHEMA = {"a": "BIGINT", "b": "DOUBLE", "s": "VARCHAR", "d": "DATE"}

PROPS = [
    {"bucketed_by": ["a"], "bucket_count": 4},
    {"bucketed_by": ["A"], "sorted_by": ["a", "b desc"]},
    {"bucketed_by": "a", "bucket_count": 3, "sorted_by": "b"},
    {"sorted_by": ["s desc", "d"], "partitioned_by": ["d"]},
    {"partitioned_by": "s,d"},
    {"bucketed_by": ["s"], "sorted_by": ["s"], "bucket_count": 2},
    {"connector": "memory"},
    {"sorted_by": ["b sideways"]},
    {"bucketed_by": ["nope"]},
    {"bucketed_by": ["a"], "bucket_count": 0},
    {"bucketed_by": ["s"], "sorted_by": ["b"]},
    {"bucketed_by": ["b"]},
]


def _parse(mod, types, props):
    schema = {c: types.parse_type(t) for c, t in SCHEMA.items()}
    try:
        wp = mod.WriteProperties.parse(props, schema, "memory")
        return wp.to_dict() if wp is not None else None
    except mod.WriteError as e:
        return ("WriteError", str(e))


@pytest.mark.parametrize("i", range(len(PROPS)))
def test_write_properties_match_reference(i):
    assert _parse(PW, PTy, PROPS[i]) == _parse(RW, RTy, PROPS[i])


def test_pages_ordered_matches_reference():
    from presto_tpu.connectors import PageMeta as RM

    from presto_tpu_torch.connectors import PageMeta as PM

    cases = [[[[1], [3]], [[3], [5]]], [[[1], [4]], [[3], [5]]],
             [[[1, "a"], [1, "b"]], [[1, "b"], [2, "a"]]], [[[1], [2]], None]]
    for ranges in cases:
        for sort in ([("k", True)], [("k", False)], []):
            mine = PW.pages_ordered(
                [PM(seq=i, rows=1, key_ranges=r)
                 for i, r in enumerate(ranges)], sort)
            theirs = RW.pages_ordered(
                [RM(seq=i, rows=1, key_ranges=r)
                 for i, r in enumerate(ranges)], sort)
            assert mine == theirs


# ---------------------------------------------------------------------------
# a memory table's appends
# ---------------------------------------------------------------------------


def _pages(case):
    """(table's first rows, pages to append): int and float columns, a
    NULL mask on one page where `case` asks for it, empty pages."""
    rng = np.random.default_rng(7)

    def page(n, masked=False):
        x = rng.integers(-9, 9, n)
        f = rng.standard_normal(n)
        if masked:
            f = np.ma.masked_array(f, mask=rng.random(n) < 0.3)
        return {"x": x, "f": f}

    first = page(0 if case == "empty_table" else 5, case == "masked_first")
    pages = [page(3), page(0), page(4, case == "masked_later"), page(2)]
    return first, pages


def _same_data(mine, theirs):
    assert list(mine) == list(theirs)
    for c in theirs:
        a, b = mine[c], theirs[c]
        assert isinstance(a, np.ma.MaskedArray) \
            == isinstance(b, np.ma.MaskedArray), c
        assert a.dtype == b.dtype, c
        assert np.ma.getmaskarray(a).tolist() \
            == np.ma.getmaskarray(b).tolist(), c
        assert np.ma.getdata(a).tolist() == np.ma.getdata(b).tolist(), c


@pytest.mark.parametrize("case", ["plain", "masked_first", "masked_later",
                                  "empty_table"])
def test_append_pages_equals_page_by_page_append(case):
    """MemoryTable.append_pages (one concatenation a column) leaves the
    arrays presto_tpu's MemoryTable leaves after one append a page."""
    schema = {"x": PTy.BIGINT, "f": PTy.DOUBLE}
    ref_schema = {"x": RTy.BIGINT, "f": RTy.DOUBLE}
    first, pages = _pages(case)
    mine = MemoryTable("t", schema, dict(first))
    theirs = RefMemoryTable("t", ref_schema, dict(first))
    assert mine.append_pages([dict(p) for p in pages]) \
        == sum(theirs.append(dict(p)) for p in pages)
    assert mine.row_count() == theirs.row_count()
    _same_data(mine.data, theirs.data)


@pytest.mark.parametrize("end", ["finish", "abort"])
def test_append_sink_appends_its_pages_once(end):
    """AppendPageSink holds a write's pages and appends them in one
    append_pages at finish, or at abort, leaving what presto_tpu's sink
    leaves, which appends each page as it comes."""
    from presto_tpu.connectors import AppendPageSink as RefSink

    from presto_tpu_torch.connectors import AppendPageSink

    first, pages = _pages("masked_later")
    mine = MemoryTable("t", {"x": PTy.BIGINT, "f": PTy.DOUBLE}, dict(first))
    theirs = RefMemoryTable("t", {"x": RTy.BIGINT, "f": RTy.DOUBLE},
                            dict(first))
    calls = []
    real = mine.append_pages
    mine.append_pages = lambda ps: calls.append(len(ps)) or real(ps)
    sink, ref_sink = AppendPageSink(mine), RefSink(theirs)
    for p in pages:
        assert sink.append_page(dict(p)) == ref_sink.append_page(dict(p))
    assert mine.row_count() == len(first["x"]) and not calls
    getattr(sink, end)()
    getattr(ref_sink, end)()
    assert calls == [3]
    assert [(m.seq, m.rows) for m in sink.pages] \
        == [(m.seq, m.rows) for m in ref_sink.pages]
    _same_data(mine.data, theirs.data)
    if end == "finish":
        assert (sink.finished.rows, sink.finished.bytes) \
            == (ref_sink.finished.rows, ref_sink.finished.bytes)
    sink.abort()  # after finish: nothing more
    assert calls == [3]


def _pair(**props):
    """(presto_tpu session, port session) over a small memory table with
    a NULL and a string column."""
    n = 40
    a = np.arange(n) * 7 % 13
    b = np.where(np.arange(n) % 5 == 0, -0.0, np.arange(n) * 0.25)
    s = np.array(["x", "yy", "z", ""] * (n // 4), dtype=object)
    data = {"a": a, "b": b, "s": s}
    types = {"a": "BIGINT", "b": "DOUBLE", "s": "VARCHAR"}
    ref, port = RefCatalog(), Catalog()
    ref.register(RefMemoryTable("src", {c: RTy.parse_type(t)
                                        for c, t in types.items()},
                                {c: v.copy() for c, v in data.items()}))
    port.register(MemoryTable("src", {c: PTy.parse_type(t)
                                      for c, t in types.items()},
                              {c: v.copy() for c, v in data.items()}))
    return (presto_tpu.connect(ref, **props),
            presto_tpu_torch.connect(port, device="cpu", **props))


def _outcome(session, sql):
    try:
        r = session.sql(sql)
        return (r.rows, [str(t) for _n, t in r.columns])
    except Exception as e:  # noqa: BLE001 -- the outcome is compared
        return (type(e).__name__, str(e))


def _tables_equal(ref, port, name):
    rt, pt = ref.catalog.get(name), port.catalog.get(name)
    assert list(rt.schema) == list(pt.schema)
    assert [str(t) for t in rt.schema.values()] \
        == [str(t) for t in pt.schema.values()]
    for c in rt.schema:
        x, y = np.asarray(pt.data[c]), np.asarray(rt.data[c])
        assert x.tolist() == y.tolist(), c
        if x.dtype.kind == "f":  # -0.0 stays -0.0
            assert np.signbit(x).tolist() == np.signbit(y).tolist(), c
    assert pt.write_properties() == rt.write_properties()
    assert pt.ordering() == rt.ordering()


WRITE_CASES = {
    "declared_layout_then_insert": [
        "CREATE TABLE t (a bigint, b double, s varchar) WITH "
        "(bucketed_by = ARRAY['a'], bucket_count = 3, "
        "sorted_by = ARRAY['b desc'])",
        "INSERT INTO t SELECT a, b, s FROM src",
        "INSERT INTO t SELECT a + 1, b, s FROM src WHERE a > 6",
        "SHOW CREATE TABLE t", "SHOW COLUMNS FROM t"],
    "range_layout_with_strings": [
        "CREATE TABLE t WITH (bucketed_by = ARRAY['s'], bucket_count = 3, "
        "sorted_by = ARRAY['s', 'a desc']) AS SELECT s, a, b FROM src",
        "SHOW COLUMNS FROM t", "SELECT s, a FROM t ORDER BY s LIMIT 5"],
    "partitioned": [
        "CREATE TABLE t WITH (partitioned_by = ARRAY['s'], "
        "sorted_by = ARRAY['b']) AS SELECT a, b, s FROM src",
        "SHOW CREATE TABLE t"],
    "coercion_and_reorder": [
        "CREATE TABLE t (x double, y bigint, z varchar)",
        "INSERT INTO t SELECT a, a, s FROM src",
        "INSERT INTO t (z, y, x) SELECT s, a, b FROM src WHERE a < 3"],
    "insert_errors": [
        "CREATE TABLE t (x double, y bigint)",
        "INSERT INTO t SELECT a FROM src",
        "INSERT INTO t (x) SELECT a FROM src",
        "INSERT INTO t (x, q) SELECT a, a FROM src",
        "INSERT INTO t SELECT CAST(NULL AS double), a FROM src",
        "INSERT INTO t SELECT s, a FROM src"],
    "ctas_errors": [
        "CREATE TABLE t AS SELECT a FROM src",
        "CREATE TABLE t AS SELECT a FROM src",
        "CREATE TABLE IF NOT EXISTS t AS SELECT a FROM src",
        "CREATE TABLE n AS SELECT CAST(NULL AS bigint) AS k FROM src",
        "CREATE TABLE u WITH (bucketed_by = ARRAY['b']) AS "
        "SELECT a, b FROM src",
        "CREATE TABLE t (a bigint)", "CREATE TABLE IF NOT EXISTS t (a bigint)",
        "DROP TABLE nope", "DROP TABLE IF EXISTS nope",
        "DELETE FROM nope", "INSERT INTO nope SELECT 1"],
    "delete": [
        "CREATE TABLE t AS SELECT a, b, s FROM src",
        "DELETE FROM t WHERE s = 'yy' OR b > 5", "SELECT count(*) FROM t",
        "DELETE FROM t", "SELECT count(*) FROM t"],
    "show_and_explain": [
        "SHOW CATALOGS", "SHOW SCHEMAS", "SHOW STATS FOR src",
        "EXPLAIN (TYPE VALIDATE) SELECT a FROM src",
        "EXPLAIN CREATE TABLE e AS SELECT a, count(*) AS n FROM src "
        "GROUP BY a",
        "EXPLAIN INSERT INTO src SELECT a, b, s FROM src",
        "EXPLAIN ANALYZE CREATE TABLE e AS SELECT a FROM src",
        "SET SESSION no_such_property = 1"],
}


@pytest.mark.parametrize("case", sorted(WRITE_CASES))
@pytest.mark.parametrize("mode", ["dynamic", "compiled"])
def test_write_case_matches_reference(case, mode):
    ref, port = _pair(execution_mode=mode)
    # the schemas presto_tpu's system tables alone add (the port has none)
    system = {n.split(".")[-2] for n in ref.catalog.tables
              if n.startswith(SQ.SYSTEM_TABLE_PREFIXES)} - {"default"}
    for sql in WRITE_CASES[case]:
        if mode == "compiled" and sql.startswith("EXPLAIN ANALYZE"):
            continue  # not ported: test_explain_analyze_in_compiled_...
        a, b = _outcome(ref, sql), _outcome(port, sql)
        if sql == "SHOW SCHEMAS":
            a = ([r for r in a[0] if r[0] not in system], a[1])
        assert a == b, (sql, a, b)
        for name in port.catalog.tables:  # every table after every step
            _tables_equal(ref, port, name)


def test_show_session_matches_reference():
    ref, port = _pair()
    ref.sql("SET SESSION task_concurrency = 3")
    port.sql("SET SESSION task_concurrency = 3")
    mine = port.sql("SHOW SESSION").rows
    # compiled_cache_max_bytes is the port's own property (its memo)
    assert [r for r in mine if r[0] != "compiled_cache_max_bytes"] \
        == ref.sql("SHOW SESSION").rows
    assert ("task_concurrency", "3") in mine


#: the names of presto_tpu/functions/scalar.py itself that ROADMAP A item
#: 2 lists as not ported: the T-digest readers, empty_approx_set and the
#: 14 trigonometric names that scalar_ext.py registers again
_SCALAR_PY_UNPORTED = {
    "value_at_quantile", "values_at_quantiles", "quantile_at_value",
    "scale_tdigest", "destructure_tdigest", "empty_approx_set", "sin",
    "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "tanh", "cbrt",
    "degrees", "radians", "exp2", "log2"}
#: the function modules ROADMAP A item 2 lists as not ported
_UNPORTED_MODULES = {"scalar_ext", "scalar_ext2", "datetime_tz",
                     "geospatial", "ml", "sketches", "tdigest"}

#: imports presto_tpu's scalar functions and prints, for each registered
#: name, the function module whose import registered it
_OWNERS = r"""
import json, sys
owner = {}
def prof(frame, event, arg):
    if event == "call" and frame.f_code.co_name == "register" \
            and frame.f_code.co_filename.endswith(
                "presto_tpu/functions/scalar.py"):
        f = frame.f_back
        while f is not None and f.f_code.co_name != "<module>":
            f = f.f_back
        if f is not None:
            owner.setdefault(frame.f_locals.get("name"),
                             f.f_globals.get("__name__"))
sys.setprofile(prof)
import presto_tpu.functions.scalar as S
sys.setprofile(None)
print(json.dumps({n: owner.get(n) for n in S.REGISTRY}))
"""


def test_show_functions_matches_reference():
    """The port's scalar rows are a subset of presto_tpu's; every name
    it lacks is registered by a module ROADMAP A item 2 lists as not
    ported (or is one of the names of scalar.py it lists); the aggregate
    and window rows are equal."""
    ref, port = _pair()
    theirs = ref.sql("SHOW FUNCTIONS").rows
    mine = port.sql("SHOW FUNCTIONS").rows
    assert [r for r in mine if r[1] != "scalar"] \
        == [r for r in theirs if r[1] != "scalar"]
    my_scalars = {r[0] for r in mine if r[1] == "scalar"}
    their_scalars = {r[0] for r in theirs if r[1] == "scalar"}
    assert my_scalars <= their_scalars
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root)
    owners = json.loads(subprocess.run(
        [sys.executable, "-c", _OWNERS], env=env, cwd=root, check=True,
        capture_output=True, text=True).stdout)
    missing = their_scalars - my_scalars
    for name in sorted(missing):
        module = owners[name].rsplit(".", 1)[-1]
        if module == "scalar":
            assert name in _SCALAR_PY_UNPORTED, name
        else:
            assert module in _UNPORTED_MODULES, (name, module)


# ---------------------------------------------------------------------------
# a static pass over an engine-written table
# ---------------------------------------------------------------------------


def test_static_pass_over_a_written_table_reads_nothing_back():
    """The graph of a query over a table written by CTAS (with its
    recorded ordering claim) is built by a static pass that reads nothing
    back to the host and stores no Python scalar into a tensor."""
    _ref, port = _pair()
    port.sql("CREATE TABLE w WITH (bucketed_by = ARRAY['a'], "
             "bucket_count = 4, sorted_by = ARRAY['a']) AS "
             "SELECT a, b, s FROM src")
    assert port.catalog.get("w").ordering() == [("a", True)]
    real = CC.build_graph
    built = {}

    def build(fn, example, device=None):
        def program(*args):
            with no_host_reads(), no_scalar_stores():
                out = fn(*args)
            built["out"] = out
            return out

        return real(program, example, device)

    CC.build_graph = build
    try:
        r = port.sql("SELECT a, count(*), sum(b) FROM w WHERE s <> 'z' "
                     "GROUP BY a ORDER BY a")
    finally:
        CC.build_graph = real
    assert r.stats.execution_mode == "compiled" and "out" in built
    assert r.rows == port.sql(
        "SELECT a, count(*), sum(b) FROM src WHERE s <> 'z' GROUP BY a "
        "ORDER BY a").rows


# ---------------------------------------------------------------------------
# what is not ported
# ---------------------------------------------------------------------------

NOT_PORTED = {
    "PREPARE p FROM SELECT 1": "serving tier",
    "EXECUTE p": "serving tier",
    "DEALLOCATE PREPARE p": "serving tier",
    "DESCRIBE INPUT p": "serving tier",
    "DESCRIBE OUTPUT p": "serving tier",
    "CREATE MATERIALIZED VIEW mv AS SELECT a FROM src": "materialized views",
    "REFRESH MATERIALIZED VIEW mv": "materialized views",
    "DROP MATERIALIZED VIEW mv": "materialized views",
    "SHOW MATERIALIZED VIEWS": "materialized views",
    "EXPLAIN (TYPE DISTRIBUTED) SELECT a FROM src": "distributed execution",
    "CREATE TABLE f WITH (connector = 'parquet') AS SELECT a FROM src":
        "file connectors",
    "CREATE TABLE f WITH (connector = 'localfile') AS SELECT a FROM src":
        "file connectors",
    "CREATE TABLE f (a bigint) WITH (connector = 'orc')": "file connectors",
    "CREATE TABLE f WITH (connector = 'blackhole') AS SELECT a FROM src":
        "file connectors",
    "CREATE TABLE f WITH (connector = 'hive') AS SELECT a FROM src":
        "file connectors",
}


@pytest.mark.parametrize("sql", sorted(NOT_PORTED))
def test_statement_not_ported_raises(sql):
    _ref, port = _pair()
    with pytest.raises(NotImplementedError, match=NOT_PORTED[sql]):
        port.sql(sql)
    assert "f" not in port.catalog


_CTAS = "CREATE TABLE c AS SELECT a, b FROM src WHERE a > 1"


@pytest.mark.parametrize("props,match,sql", [
    ({"execution_mode": "chunked"}, "chunked execution", _CTAS),
    ({"distributed": True}, "distributed execution", _CTAS),
    ({"chunked_rows_threshold": 10}, "chunked execution", _CTAS),
    ({"distributed": True}, "distributed execution",
     "INSERT INTO src SELECT a, b, s FROM src WHERE a > 1")])
def test_streamed_and_unported_writes_raise(props, match, sql):
    """Where presto_tpu streams a single-scan write (chunked or
    distributed execution, or "auto" above chunked_rows_threshold rows)
    the port raises, and writes nothing: no table created, no row
    inserted."""
    _ref, port = _pair(**props)
    with pytest.raises(NotImplementedError, match=match):
        port.sql(sql)
    assert "c" not in port.catalog
    assert port.catalog.get("src").row_count() == 40


def test_explain_analyze_in_compiled_mode_raises():
    _ref, port = _pair(execution_mode="compiled")
    with pytest.raises(NotImplementedError, match="cost analysis"):
        port.sql("EXPLAIN ANALYZE SELECT a FROM src")


def test_open_sink_refuses_a_staged_sink_table():
    from presto_tpu_torch.connectors import AppendPageSink, open_sink

    class FileTable(MemoryTable):
        def page_sink(self, props, defer_gc=False):
            raise AssertionError("not reached")

    t = FileTable("ft", {"a": PTy.BIGINT}, {"a": np.arange(3)})
    with pytest.raises(NotImplementedError, match="FileTable 'ft'"):
        open_sink(t)
    assert isinstance(open_sink(MemoryTable("m", {"a": PTy.BIGINT},
                                            {"a": np.arange(3)})),
                      AppendPageSink)
    assert SQ.statement("D1").startswith("CREATE TABLE rev")
