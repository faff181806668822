"""ARRAY, MAP and ROW values in presto_tpu_torch against presto_tpu on the
CPU: the 38 collection names of functions/scalar.py, ARRAY || ARRAY and
the casts between collections of one kind.

Both packages read one memory table made from seeded numpy columns with
NULLs and empty strings; its arrays come from array_agg per group (a
group whose values are all NULL gives a NULL array, NULL values give
NULL elements), from split and from constructors, empty ones from
slice past the end and ARRAY[].  Each probe groups several names in one
SELECT and runs in `execution_mode` "dynamic" and "auto": rows, the
seven counters of QueryStats, the execution mode and the memo entry
must equal presto_tpu's, frozen in tests/torch_collections_frozen.json
(tests/torch_collections_common.py; a slow test runs presto_tpu live
against them).  The cases of tests/test_arrays.py and
tests/test_maps_rows.py run again the same way; the rejections (a
lambda capturing a row column, UNNEST of a non-array) run in both
packages live.
The two canonical orders of tuple dictionaries (hazard of every
function that builds one: the codes feed =, GROUP BY, ORDER BY and
union merges) are held to presto_tpu's value for value.
"""

import numpy as np
import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu import types as RT
from presto_tpu.catalog import Catalog as RCatalog
from presto_tpu.catalog import tpch_catalog as ref_tpch_catalog
from presto_tpu_torch import types as T
from presto_tpu_torch.catalog import Catalog, tpch_catalog
from presto_tpu_torch.functions import scalar as S
from tests.torch_collections_common import (MODES, assert_frozen,
                                            check_reference, frozen,
                                            values_of)
from tests.torch_functions_common import static_pass_builds
from tests.torch_threads import torch_one_thread  # noqa: F401

#: the 38 collection names of functions/scalar.py's REGISTRY
COLLECTION_NAMES = (
    "array_constructor", "element_at", "subscript", "cardinality",
    "contains", "array_min", "array_max", "array_position",
    "array_distinct", "slice", "flatten", "array_remove", "array_union",
    "array_intersect", "array_except", "arrays_overlap", "sequence",
    "split", "transform", "filter", "any_match", "all_match", "none_match",
    "zip_with", "reduce", "map", "map_keys", "map_values", "map_entries",
    "map_concat", "map_from_entries", "map_filter", "transform_values",
    "transform_keys", "row", "row_field", "array_sort", "array_join")

N = 120
WORDS = ["ab", "", "red fox", "banana", "a b c", "green", "ab", "zeta",
         "blue sky"]
SCHEMA = {"id": "BIGINT", "g": "BIGINT", "v": "BIGINT", "x": "DOUBLE",
          "s": "VARCHAR", "k": "VARCHAR"}

#: the arrays of the probes: one row a group, g = 7 all NULL (a NULL
#: array), NULL elements elsewhere
ARRAYS = ("(SELECT g, array_agg(v) AS a, array_agg(s) AS w, "
          "array_agg(x) AS f FROM t GROUP BY g)")


def _columns():
    rng = np.random.default_rng(13)
    g = rng.integers(0, 8, N)
    v = rng.integers(-4, 6, N)
    x = np.round(rng.normal(0, 10, N), 2)
    null_v = rng.random(N) < 0.1
    null_v[g == 7] = True

    def pick(values, null_share):
        a = np.array(values, dtype=object)[rng.integers(0, len(values), N)]
        return np.ma.masked_array(a, rng.random(N) < null_share)

    return {"id": np.arange(N, dtype=np.int64), "g": g.astype(np.int64),
            "v": np.ma.masked_array(v.astype(np.int64), null_v),
            "x": np.ma.masked_array(x, rng.random(N) < 0.1),
            "s": pick(WORDS, 0.1), "k": pick(["p", "q", "r"], 0.0)}


PROBES = {
    "array_access": (
        f"SELECT g, a, cardinality(a), element_at(a, 1), element_at(a, -1), "
        f"element_at(a, 100), element_at(a, 0), a[2], contains(a, 3), "
        f"array_position(a, 3), array_min(a), array_max(a), array_min(f), "
        f"array_max(w), cardinality(slice(a, 100, 2)) FROM {ARRAYS} "
        f"ORDER BY g"),
    "array_set_functions": (
        f"SELECT g, array_distinct(a), slice(a, 2, 3), array_remove(a, 3), "
        f"array_union(a, ARRAY[1, 2]), array_intersect(a, ARRAY[1, 2, 3]), "
        f"array_except(a, ARRAY[3]), arrays_overlap(a, ARRAY[3, 4]), "
        f"array_sort(a), array_sort(f), array_join(a, '-'), "
        f"array_join(a, ',', 'N'), array_join(f, ';') FROM {ARRAYS} "
        f"ORDER BY g"),
    "string_arrays": (
        f"SELECT g, w, contains(w, 'ab'), array_sort(w), array_join(w, '|'), "
        f"array_distinct(w), array_position(w, 'green'), "
        f"flatten(transform(w, x -> split(x, 'a'))), "
        f"cardinality(array_union(w, ARRAY['ab', 'zz'])) FROM {ARRAYS} "
        f"ORDER BY g"),
    "lambdas": (
        f"SELECT g, transform(a, x -> x * 2), filter(a, x -> x > 0), "
        f"any_match(a, x -> x > 4), all_match(a, x -> x >= 0), "
        f"none_match(a, x -> x = 0), "
        f"reduce(a, 0, (s, x) -> s + coalesce(x, 0), s -> s * 10), "
        f"reduce(f, 0.0, (s, x) -> s + x, s -> s), "
        f"zip_with(a, w, (p, q) -> coalesce(p, 0) + length(q)), "
        f"array_sort(a, (p, q) -> IF(p < q, 1, IF(p = q, 0, -1))), "
        f"transform(w, x -> upper(x)) FROM {ARRAYS} ORDER BY g"),
    "split_and_sequence": (
        "SELECT id, split(s, ' '), split(s, 'a', 2), element_at(split(s, ' '),"
        " 2), split(s, ' ')[1], sequence(1, 5), "
        "sequence(5, 1, -2), sequence(0, 10, 3), sequence(2, 2) "
        "FROM t ORDER BY id"),
    "constructors": (
        "SELECT ARRAY[1, NULL, 3], ARRAY['a', 'b'], ARRAY[], "
        "ARRAY[ARRAY[1, 2], ARRAY[3]], cardinality(ARRAY[]), "
        "array_min(ARRAY[]), ARRAY[1.5, 2], ROW(1, 'x', NULL), "
        "ARRAY[1, 2] || ARRAY[3], concat(ARRAY['a'], ARRAY['b', 'c']), "
        "sequence(3, 1)"),
    "maps": (
        "SELECT map(ARRAY['a', 'b'], ARRAY[1, 2]), map(), "
        "map(ARRAY['b', 'a'], ARRAY[2, 1]), "
        "map_keys(map(ARRAY['a', 'b'], ARRAY[1, 2])), "
        "map_values(map(ARRAY['b', 'a'], ARRAY[2, 1])), "
        "map_entries(map(ARRAY[2, 1], ARRAY['y', 'x'])), "
        "map_concat(map(ARRAY['a'], ARRAY[1]), map(ARRAY['a', 'b'], "
        "ARRAY[9, 2])), map_from_entries(ARRAY[ROW('x', 1), ROW('y', 2)]), "
        "element_at(map(ARRAY['a'], ARRAY[1]), 'z'), "
        "map(ARRAY['a', 'b'], ARRAY[1, 2])['a'], "
        "cardinality(map(ARRAY['a'], ARRAY[1]))"),
    "map_lambdas": (
        "SELECT map_filter(map(ARRAY['a', 'b', 'c'], ARRAY[1, 2, 3]), "
        "(k, v) -> v > 1), transform_values(map(ARRAY['a', 'b'], "
        "ARRAY[1, 2]), (k, v) -> v * 10), transform_keys(map(ARRAY['a', "
        "'b'], ARRAY[1, 2]), (k, v) -> upper(k)), "
        "transform_keys(map(ARRAY[1, 2], ARRAY['u', 'v']), (k, v) -> k * 10)"),
    "map_columns": (
        "SELECT g, h, map_keys(h), map_values(h), element_at(h, 'ab'), "
        "h['green'], cardinality(h), map_filter(h, (k, v) -> v > 1), "
        "transform_values(h, (k, v) -> v * 10), "
        "transform_keys(h, (k, v) -> concat(k, '!')), map_entries(h), "
        "map_concat(h, map(ARRAY['ab'], ARRAY[-1])) FROM (SELECT g, "
        "histogram(s) AS h FROM t GROUP BY g) ORDER BY g"),
    "rows": (
        "SELECT ROW(1, 'x'), ROW(1, 'x')[1], ROW(1, 'x')[2], "
        "CAST(ROW(1, 'x') AS ROW(a BIGINT, b VARCHAR)).a, "
        "CAST(ROW(1, 'x') AS ROW(a BIGINT, b VARCHAR)).b"),
    "row_fields_of_a_subquery": (
        "SELECT r.a, r.b FROM (SELECT CAST(ROW(5, 'y') AS "
        "ROW(a BIGINT, b VARCHAR)) AS r)"),
    "casts": (
        f"SELECT g, CAST(a AS ARRAY(DOUBLE)), CAST(f AS ARRAY(BIGINT)), "
        f"CAST(a AS ARRAY(VARCHAR)), CAST(f AS ARRAY(VARCHAR)), "
        f"CAST(ARRAY[1, 2] AS ARRAY(DOUBLE)), CAST(NULL AS ARRAY(BIGINT)), "
        f"CAST(NULL AS MAP(VARCHAR, BIGINT)), "
        f"CAST(map(ARRAY['a'], ARRAY[1]) AS MAP(VARCHAR, DOUBLE)) "
        f"FROM {ARRAYS} ORDER BY g"),
    "order_and_extremes": (
        f"SELECT a, w FROM {ARRAYS} ORDER BY a, g"),
    "array_extremes": (
        f"SELECT max(a), min(a), max(w), min(w) FROM {ARRAYS}"),
    "union_of_arrays": (
        "SELECT a FROM (SELECT ARRAY[1] AS a UNION ALL SELECT ARRAY[2] "
        "UNION ALL SELECT ARRAY[1, 2]) ORDER BY a"),
    "values_with_collections": (
        "SELECT a, cardinality(a), m['a'] FROM (VALUES (ARRAY[1, 2], "
        "MAP(ARRAY['a'], ARRAY[7])), (ARRAY[], MAP(ARRAY['b'], ARRAY[8]))) "
        "AS t(a, m) ORDER BY 2"),
}


def _catalogs():
    cols = _columns()
    port, ref = Catalog(), RCatalog()
    port.register_memory("t", {c: T.parse_type(t) for c, t in SCHEMA.items()},
                         cols)
    ref.register_memory("t", {c: RT.parse_type(t)
                              for c, t in SCHEMA.items()}, cols)
    return port, ref


@pytest.fixture(scope="module")
def sessions():
    """The port's sessions on the CPU, by catalog ("t": the memory
    table; "tpch": TPC-H at SF0.01) and mode."""
    port = _catalogs()[0]
    tpch = tpch_catalog(0.01)
    return {(cat, mode): presto_tpu_torch.connect(c, device="cpu",
                                                  execution_mode=mode)
            for cat, c in (("t", port), ("tpch", tpch)) for mode in MODES}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(PROBES))
def test_matches_reference(name, mode, sessions):
    assert_frozen(values_of(sessions["t", mode], PROBES[name]),
                  frozen(__name__, f"probe:{name}", mode))


def test_every_name_is_registered_and_probed():
    probed = " ".join(PROBES.values()).lower()
    spelled = {"array_constructor": "array[", "subscript": "a[2]",
               "row_field": ").a", "row": "row("}
    for name in COLLECTION_NAMES:
        assert name in S.REGISTRY, name
        assert spelled.get(name, f"{name}(") in probed, name
    assert len(COLLECTION_NAMES) == len(set(COLLECTION_NAMES)) == 38
    # 103 core names, these 38, and the 153 of functions/scalar_ext.py
    # and scalar_ext2.py
    # and 18 of a later slice (datetime_tz.py's and the sketch readers)
    # and 17 of the next (geospatial.py's 14 and ml.py's 3)
    assert len(S.REGISTRY) == 103 + 38 + 153 + 18 + 17


#: probes that run as one compiled program in "auto" in both packages
STATIC_PROBES = ("split_and_sequence", "rows", "row_fields_of_a_subquery",
                 "union_of_arrays", "values_with_collections")


@pytest.mark.parametrize("name", STATIC_PROBES)
def test_static_pass_reads_nothing_back(name):
    """The probe's static pass with every host read and every Python
    scalar store made to raise: the per-entry tables reach the device
    through batch.upload."""
    result, built = static_pass_builds(PROBES[name], _catalogs()[0])
    assert result.stats.execution_mode == "compiled" and len(built) == 1


# ---- the cases of tests/test_arrays.py and tests/test_maps_rows.py ---------

REPLAYED = (
    "SELECT ARRAY[3,1,2]",
    "SELECT cardinality(ARRAY[1,2,3]), element_at(ARRAY[10,20], 2), "
    "ARRAY[10,20][1]",
    "SELECT array_sort(ARRAY[3,1,2])",
    "SELECT array_distinct(ARRAY[1,2,1,3,2])",
    "SELECT array_join(ARRAY[1,2,3], '~')",
    "SELECT slice(ARRAY[1,2,3,4], 2, 2)",
    "SELECT x FROM UNNEST(ARRAY[10,20,30]) AS t(x)",
    "SELECT x, o FROM UNNEST(ARRAY['a','b']) WITH ORDINALITY AS t(x, o)",
    "SELECT n_regionkey, array_agg(n_nationkey) AS arr FROM nation "
    "GROUP BY n_regionkey ORDER BY n_regionkey",
    "SELECT q.r, u.x FROM (SELECT n_regionkey AS r, "
    "array_agg(n_nationkey) AS a FROM nation GROUP BY n_regionkey) q "
    "CROSS JOIN UNNEST(q.a) AS u(x) ORDER BY u.x",
    "SELECT array_agg(n_name) FROM nation WHERE n_regionkey = 0",
    "SELECT x FROM UNNEST(ARRAY[]) AS t(x)",
    "SELECT ARRAY[1] AS a UNION ALL SELECT ARRAY[2]",
    "SELECT ARRAY[1, NULL, 1]",
    "SELECT array_distinct(ARRAY[1, NULL, 1])",
    "SELECT element_at(ARRAY[10,20], 5)",
    "SELECT array_min(ARRAY[])",
    "SELECT array_max(ARRAY[NULL, 3, 1])",
    "SELECT array_agg(CASE WHEN n_nationkey < 3 THEN n_nationkey END) "
    "FROM nation",
    "SELECT transform(ARRAY[1,2,3], x -> x * 2)",
    "SELECT transform(ARRAY[1,2,NULL], x -> x + 1)",
    "SELECT transform(ARRAY['a','bb'], x -> length(x))",
    "SELECT filter(ARRAY[1,2,3,4], x -> x % 2 = 0)",
    "SELECT filter(ARRAY[1,NULL,3], x -> x > 1)",
    "SELECT any_match(ARRAY[1,2,3], x -> x > 2), "
    "all_match(ARRAY[1,2,3], x -> x > 0), none_match(ARRAY[1,2], x -> x > 5)",
    "SELECT any_match(ARRAY[1,NULL], x -> x > 5)",
    "SELECT any_match(ARRAY[], x -> x > 5)",
    "SELECT reduce(ARRAY[1,2,3,4], 0, (s, x) -> s + x, s -> s)",
    "SELECT reduce(ARRAY[1,2,3], 100, (s, x) -> s + x)",
    "SELECT reduce(ARRAY[5, 20, 50], 0.0, (s, x) -> s + x, s -> s / 3)",
    "SELECT zip_with(ARRAY[1,2,3], ARRAY[10,20,30], (x, y) -> x + y)",
    "SELECT zip_with(ARRAY[1,2], ARRAY[10,20,30], "
    "(x, y) -> coalesce(x, 0) + y)",
    "SELECT k, transform(a, x -> x * 10) FROM (SELECT o_orderstatus AS k, "
    "array_agg(o_orderkey) AS a FROM orders GROUP BY o_orderstatus) "
    "ORDER BY k",
    "SELECT flatten(ARRAY[ARRAY[1,2], ARRAY[3]])",
    "SELECT array_remove(ARRAY[1,2,1,3], 1)",
    "SELECT array_union(ARRAY[1,2], ARRAY[2,3]), "
    "array_intersect(ARRAY[1,2,3], ARRAY[2,3,4]), "
    "array_except(ARRAY[1,2,3], ARRAY[2]), "
    "arrays_overlap(ARRAY[1,2], ARRAY[2,3])",
    "SELECT sequence(1, 5), sequence(5, 1, -2)",
    "SELECT split('a,b,c', ','), split('a,b,c', ',', 2)",
    "SELECT ARRAY[1,2] || ARRAY[3]",
    "SELECT ARRAY[ARRAY[1,2], ARRAY[3]]",
    "SELECT set_union(a) FROM (VALUES (ARRAY[1,2]), (ARRAY[2,3])) AS t(a)",
    "SELECT cardinality(a) FROM (VALUES (ARRAY[1,2,3]), (ARRAY[])) AS t(a) "
    "ORDER BY 1",
    "SELECT m['a'] FROM (VALUES (MAP(ARRAY['a'], ARRAY[7]))) AS t(m)",
    "SELECT a FROM (VALUES (ARRAY[2]), (ARRAY[10]), (ARRAY[1,5])) AS t(a) "
    "ORDER BY a",
    "SELECT max(a), min(a) FROM (VALUES (ARRAY[2]), (ARRAY[10])) AS t(a)",
    "SELECT map(ARRAY['a','b'], ARRAY[1,2])",
    "SELECT cardinality(map(ARRAY['a'], ARRAY[1])), "
    "element_at(map(ARRAY['a','b'], ARRAY[1,2]), 'b'), "
    "element_at(map(ARRAY['a'], ARRAY[1]), 'z'), "
    "map(ARRAY['a','b'], ARRAY[1,2])['a']",
    "SELECT map()",
    "SELECT map(ARRAY['b','a'], ARRAY[2,1])",
    "SELECT map_keys(map(ARRAY['a','b'], ARRAY[1,2])), "
    "map_values(map(ARRAY['b','a'], ARRAY[2,1]))",
    "SELECT map_from_entries(map_entries(map(ARRAY['a','b'], ARRAY[1,2])))",
    "SELECT map_concat(map(ARRAY['a'], ARRAY[1]), "
    "map(ARRAY['a','b'], ARRAY[9,2]))",
    "SELECT map_filter(map(ARRAY['a','b','c'], ARRAY[1,2,3]), "
    "(k, v) -> v > 1)",
    "SELECT transform_values(map(ARRAY['a','b'], ARRAY[1,2]), "
    "(k, v) -> v * 10)",
    "SELECT transform_keys(map(ARRAY['a','b'], ARRAY[1,2]), "
    "(k, v) -> upper(k))",
    "SELECT n_regionkey, map_agg(n_name, n_nationkey) FROM nation "
    "GROUP BY n_regionkey ORDER BY n_regionkey",
    "SELECT element_at(map_agg(n_name, n_nationkey), 'ALGERIA') FROM nation",
    "SELECT multimap_agg(n_regionkey, n_nationkey) FROM nation "
    "WHERE n_regionkey < 2",
    "SELECT ROW(1, 'x')",
    "SELECT ROW(1, 'x')[1], ROW(1, 'x')[2]",
    "SELECT CAST(ROW(1, 'x') AS ROW(a BIGINT, b VARCHAR)).a",
    "SELECT r.a, r.b FROM (SELECT CAST(ROW(5, 'y') AS "
    "ROW(a BIGINT, b VARCHAR)) AS r)",
    "SELECT CAST(NULL AS MAP(VARCHAR, BIGINT))",
    "SELECT map_agg(nullif(n_name, 'ALGERIA'), n_nationkey) "
    "FROM nation WHERE n_regionkey = 0",
)


@pytest.mark.parametrize("mode", MODES)
def test_reference_collection_cases(mode, sessions):
    """Every query of tests/test_arrays.py and tests/test_maps_rows.py
    (nation, orders and VALUES at SF0.01) gives presto_tpu's rows,
    counters, execution mode and memo entry."""
    for i, sql in enumerate(REPLAYED):
        assert_frozen(values_of(sessions["tpch", mode], sql),
                      frozen(__name__, f"replayed:{i}", mode))


def frozen_cases():
    """{case: (presto_tpu's catalog, sql)} of the values frozen for this
    module (tests/torch_collections_common.py)."""
    ref = _catalogs()[1]
    tpch = ref_tpch_catalog(0.01, None)
    cases = {f"probe:{n}": (ref, sql) for n, sql in PROBES.items()}
    cases.update({f"replayed:{i}": (tpch, sql)
                  for i, sql in enumerate(REPLAYED)})
    return cases


@pytest.mark.slow
def test_frozen_values_are_presto_tpus():
    """presto_tpu, run live, gives the frozen values of every case."""
    check_reference(__name__)


#: a lambda capturing a column of the row
CAPTURE = ("SELECT transform(ks, x -> x + k) FROM ("
           "SELECT 1 AS k, ARRAY[1,2] AS ks)")


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_lambda_capture_rejected(pkg, sessions):
    session = sessions["tpch", "dynamic"] if pkg == "port" \
        else presto_tpu.connect(ref_tpch_catalog(0.01, None),
                                execution_mode="dynamic")
    with pytest.raises(NotImplementedError, match="captures"):
        session.sql(CAPTURE)


def test_unnest_of_a_non_array_is_a_semantic_error(sessions):
    ref = presto_tpu.connect(ref_tpch_catalog(0.01, None),
                             execution_mode="dynamic")
    for session in (sessions["tpch", "dynamic"], ref):
        with pytest.raises(Exception, match="UNNEST"):
            session.sql("SELECT x FROM UNNEST(42) AS t(x)")


def test_sketch_cardinality_raises_not_ported():
    """A later slice ported the sketch readers (functions/sketches.py):
    cardinality of an HLL, P4HLL or QDIGEST now resolves to BIGINT, and
    of a TDIGEST it resolves to nothing, as in the reference."""
    from presto_tpu_torch.functions.scalar import lookup

    for t in (T.HLL, T.P4HLL, T.qdigest_of(T.DOUBLE)):
        assert lookup("cardinality").resolve([t]) == T.BIGINT
    assert lookup("cardinality").resolve([T.tdigest_of(T.DOUBLE)]) is None


# ---- hazard (a): the canonical orders of tuple dictionaries ---------------


def _entries(seed: int, n: int) -> list:
    """Seeded host tuples of every kind a dictionary holds: ints, floats
    equal to ints, strings, booleans, NULLs, nested tuples, mixed types
    and prefixes."""
    rng = np.random.default_rng(seed)
    atoms = [0, 1, 2, -3, 1.0, 2.5, -0.0, "a", "b", "", "ab", True, False,
             None, (1, 2), (1,), ("x", None), ()]
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 4))
        out.append(tuple(atoms[int(j)] for j in rng.integers(0, len(atoms),
                                                              k)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tuple_dictionary_order_is_the_references(seed):
    """_tuple_dict_normalize's semantic order (repr pre-sort, then
    _tuple_cmp) and _tuples_to_dict_column's repr order give presto_tpu's
    dictionaries and codes, value for value."""
    import jax.numpy as jnp

    from presto_tpu.exec import executor as RE
    from presto_tpu.exec.colval import ColVal as RColVal
    from presto_tpu.functions import scalar as RS
    from presto_tpu_torch.exec import collections as CL
    from presto_tpu_torch.exec.colval import ColVal

    vals = _entries(seed, 200)
    obj = np.empty(len(vals), dtype=object)
    obj[:] = vals
    t = T.array_of(T.BIGINT)
    mine = S._tuple_dict_normalize(obj, ColVal(
        __import__("torch").arange(len(vals), dtype=__import__(
            "torch").int32), None, t), t)
    theirs = RS._tuple_dict_normalize(obj, RColVal(
        jnp.arange(len(vals), dtype=jnp.int32), None, RT.array_of(
            RT.BIGINT)), RT.array_of(RT.BIGINT))
    assert list(mine.dictionary.values) == list(theirs.dictionary.values)
    assert [repr(v) for v in mine.dictionary.values] \
        == [repr(v) for v in theirs.dictionary.values]
    assert mine.data.tolist() == np.asarray(theirs.data).tolist()
    col = CL.tuples_to_dict_column(vals, None, t,
                                   __import__("torch").device("cpu"))
    ref = RE._tuples_to_dict_column(obj, None, RT.array_of(RT.BIGINT))
    assert [repr(v) for v in col.dictionary.values] \
        == [repr(v) for v in ref.dictionary.values]
    assert col.data.tolist() == np.asarray(ref.data).tolist()


@pytest.mark.parametrize("kind", ["str", "int", "float", "bool"])
def test_native_order_equals_the_comparator_order(kind):
    """The fast path of _canonical_order (one element type, no NULL,
    nothing nested) sorts as the reference's comparator does."""
    import functools

    rng = np.random.default_rng(5)
    pool = {"str": ["", "a", "ab", "b", "B", "é"], "int": [-2, 0, 1, 10],
            "float": [-1.5, -0.0, 0.25, 3.0, 1e300],
            "bool": [True, False]}[kind]
    uniq = list({tuple(pool[int(j)] for j in rng.integers(
        0, len(pool), int(rng.integers(0, 5)))) for _ in range(300)})
    slow = sorted(sorted(uniq, key=repr),
                  key=functools.cmp_to_key(S._tuple_cmp))
    assert S._canonical_order(uniq) == slow


def test_dictionary_values_of_a_query_are_the_references(sessions):
    """A query's collection dictionaries themselves, not only its rows:
    split, array_agg and transform build tuples whose repr (and so
    whose order) is presto_tpu's (no numpy scalars)."""
    from presto_tpu.exec.executor import Executor as RExecutor
    from presto_tpu.exec.executor import plan_statement as ref_plan
    from presto_tpu.sql.parser import parse as ref_parse
    from presto_tpu_torch.exec.executor import Executor, plan_statement
    from presto_tpu_torch.sql.parser import parse

    sql = (f"SELECT g, a, split(w[1], ' ') AS p, transform(f, x -> x * 2) "
           f"AS d FROM {ARRAYS}")
    port = sessions["t", "dynamic"]
    ref = presto_tpu.connect(_catalogs()[1], execution_mode="dynamic")
    mine = Executor(port).evaluate(plan_statement(port, parse(sql)))
    theirs = RExecutor(ref).evaluate(ref_plan(ref, ref_parse(sql)))
    names = [c for c in mine.columns if mine.columns[c].dictionary
             is not None]
    assert len(names) == 3
    for c in names:
        ours = [repr(v) for v in mine.columns[c].dictionary.values]
        refs = [repr(v) for v in theirs.columns[c].dictionary.values]
        assert ours == refs, c


@pytest.mark.parametrize("kind", ["int", "float", "str", "nested", "mixed"])
def test_repr_order_equals_the_repr_sort(kind):
    """repr_order's head-key sort (the repr of each tuple's first element,
    then the whole repr within a tie) gives sorted(key=repr), the order
    of the reference's repr-keyed dictionaries: empty tuples, one-element
    tuples, heads that prefix one another and NULL elements included."""
    rng = np.random.default_rng(23)
    pool = {"int": [-3, 0, 1, 10, 11, 100], "float": [-1.5, 0.25, 2.0, 1e300],
            "str": ["", "a", "a,", "ab", "b'", "é"],
            "nested": [(), (1,), (1, 2), ("a",), None],
            "mixed": [None, 1, "1", 1.0, True, (2,)]}[kind]
    uniq = list({tuple(pool[int(j)] for j in rng.integers(
        0, len(pool), int(rng.integers(0, 5)))) for _ in range(400)})
    assert S.repr_order(uniq) == sorted(uniq, key=repr)
