"""UNNEST in both executors of presto_tpu_torch against presto_tpu on the
CPU.

CROSS JOIN UNNEST over constants, split words, sequences, aggregated
arrays and VALUES, WITH ORDINALITY, with empty and NULL arrays, NULL
elements, string and nested elements, in "dynamic" and "auto": rows, the
seven counters, the execution mode and the memo entry equal
presto_tpu's, frozen in tests/torch_collections_frozen.json (a slow
test runs presto_tpu live against them).  presto_tpu's dynamic UNNEST
builds its element column with numpy from the live elements, and the
port keeps what that gives
(a NULL string element as the text 'None', a NULL DOUBLE as NaN, a
TypeError for a NULL integer); nested elements, where presto_tpu's
dynamic path fails, take the static path's element dictionary in the
port.  The static expansion falls back past capacity x maxlen >
50,000,000 rows, as presto_tpu's does; its static pass reads nothing
back to the host and stores no Python scalar into a tensor; the
expansion's gather routes by take_rows' rules (staged here by patching
gather._staging_enabled, as the gather tests do).
"""

import inspect

import numpy as np
import pytest

import presto_tpu_torch
from presto_tpu import types as RT
from presto_tpu.catalog import Catalog as RCatalog
from presto_tpu_torch import types as T
from presto_tpu_torch.catalog import Catalog
from presto_tpu_torch.exec import gather as G
from presto_tpu_torch.exec.executor import Executor, StaticFallback
from tests.torch_collections_common import (MODES, assert_frozen,
                                            check_reference, frozen,
                                            tuplify, values_of)
from tests.torch_functions_common import (assert_rows_equal,
                                          static_pass_builds)
from tests.torch_threads import torch_one_thread  # noqa: F401

N = 300
SCHEMA = {"id": "BIGINT", "g": "BIGINT", "v": "BIGINT", "x": "DOUBLE",
          "s": "VARCHAR", "n": "BIGINT"}


def _columns():
    rng = np.random.default_rng(29)
    words = ["alpha beta", "", "gamma", "delta epsilon zeta", "eta  theta",
             "iota"]
    s = np.array(words, dtype=object)[rng.integers(0, len(words), N)]
    return {"id": np.arange(N, dtype=np.int64),
            "g": rng.integers(0, 40, N).astype(np.int64),
            "v": np.ma.masked_array(rng.integers(-50, 50, N).astype(np.int64),
                                    rng.random(N) < 0.05),
            "x": rng.normal(0, 1, N),
            "s": np.ma.masked_array(s, rng.random(N) < 0.1),
            "n": rng.integers(0, 4, N).astype(np.int64)}


def _catalogs():
    cols = _columns()
    port, ref = Catalog(), RCatalog()
    port.register_memory("t", {c: T.parse_type(t) for c, t in SCHEMA.items()},
                         cols)
    ref.register_memory("t", {c: RT.parse_type(t)
                              for c, t in SCHEMA.items()}, cols)
    return port, ref


CASES = {
    "split_words": ("SELECT id, w FROM t CROSS JOIN UNNEST(split(s, ' ')) "
                    "AS u(w) ORDER BY id, w"),
    "split_words_with_ordinality": (
        "SELECT id, w, o FROM t CROSS JOIN UNNEST(split(s, ' ')) "
        "WITH ORDINALITY AS u(w, o) ORDER BY id, o"),
    "grouped_words": ("SELECT w, count(*), sum(v), max(x) FROM t CROSS JOIN "
                      "UNNEST(split(s, ' ')) AS u(w) GROUP BY w ORDER BY w"),
    "sequence": ("SELECT k, count(*), sum(v * k) FROM t CROSS JOIN "
                 "UNNEST(sequence(1, 4)) AS u(k) GROUP BY k ORDER BY k"),
    "constant_strings": ("SELECT x, o FROM UNNEST(ARRAY['b', 'a', 'b']) "
                         "WITH ORDINALITY AS u(x, o)"),
    "constant_with_null_double": (
        "SELECT x FROM UNNEST(ARRAY[1.5, NULL, 2]) AS u(x)"),
    "empty_constant": "SELECT x FROM UNNEST(ARRAY[]) AS u(x)",
    "aggregated_with_ordinality": (
        "SELECT g, e, o FROM (SELECT g, array_agg(v) AS a FROM t "
        "WHERE v IS NOT NULL GROUP BY g) CROSS JOIN UNNEST(a) "
        "WITH ORDINALITY AS u(e, o) ORDER BY g, o"),
    "aggregated_strings": (
        "SELECT g, e FROM (SELECT g, array_agg(s) AS a FROM t "
        "WHERE s IS NOT NULL GROUP BY g) CROSS JOIN UNNEST(a) AS u(e) "
        "ORDER BY g, e"),
    "null_and_empty_arrays": (
        "SELECT id, e FROM (SELECT id, CASE WHEN n = 0 THEN NULL "
        "WHEN n = 1 THEN slice(split(s, ' '), 5, 1) ELSE split(s, ' ') END "
        "AS a FROM t) CROSS JOIN UNNEST(a) AS u(e) ORDER BY id, e"),
    "values_arrays": (
        "SELECT k, e, o FROM (VALUES (1, ARRAY[10, 20]), (2, ARRAY[]), "
        "(3, ARRAY[30])) AS v(k, a) CROSS JOIN UNNEST(a) WITH ORDINALITY "
        "AS u(e, o) ORDER BY k, o"),
    "values_strings_with_null": (
        "SELECT k, e FROM (VALUES (1, ARRAY['p', NULL]), (2, ARRAY['q'])) "
        "AS v(k, a) CROSS JOIN UNNEST(a) AS u(e) ORDER BY k, e"),
    "filtered_source": (
        "SELECT id, w FROM t CROSS JOIN UNNEST(split(s, ' ')) AS u(w) "
        "WHERE v > 0 AND w <> '' ORDER BY id, w"),
}


@pytest.fixture(scope="module")
def sessions():
    port = _catalogs()[0]
    return {mode: presto_tpu_torch.connect(port, device="cpu",
                                           execution_mode=mode)
            for mode in MODES}


def expected(case: str, mode: str) -> dict:
    return frozen(__name__, case, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_reference(name, mode, sessions):
    assert_frozen(values_of(sessions[mode], CASES[name]),
                  expected(name, mode))


#: the cases whose source runs in the static executor in both packages
STATIC = ("split_words", "split_words_with_ordinality", "grouped_words",
          "sequence", "constant_strings", "constant_with_null_double",
          "empty_constant", "null_and_empty_arrays", "values_arrays",
          "values_strings_with_null", "filtered_source")


def frozen_rows(case: str, mode: str) -> list:
    return [tuple(tuplify(v) for v in r)
            for r in expected(case, mode)["rows"]]


@pytest.mark.parametrize("name", STATIC)
def test_static_pass_reads_nothing_back(name):
    result, built = static_pass_builds(CASES[name], _catalogs()[0])
    assert result.stats.execution_mode == "compiled" and len(built) == 1
    assert_rows_equal(result.rows, frozen_rows(name, "auto"))


NULL_ELEMENTS = {
    "BIGINT": "SELECT x FROM UNNEST(ARRAY[1, NULL, 2]) AS u(x)",
    "VARCHAR": ("SELECT x, o FROM UNNEST(ARRAY['b', 'a', NULL]) "
                "WITH ORDINALITY AS u(x, o)"),
}


@pytest.mark.parametrize("elem", sorted(NULL_ELEMENTS))
def test_null_elements_follow_the_reference_in_both_executors(elem,
                                                             sessions):
    """The static expansion gives NULL; the dynamic one what the
    reference's numpy conversion gives: the text 'None' for a string, a
    TypeError for an integer."""
    sql = NULL_ELEMENTS[elem]
    for mode in MODES:
        assert_frozen(values_of(sessions[mode], sql),
                      expected(f"null:{elem}", mode))
    if elem == "BIGINT":
        assert expected(f"null:{elem}", "dynamic")["error"] == "TypeError"
        with pytest.raises(TypeError, match="NoneType"):
            sessions["dynamic"].sql(sql)
    else:
        assert ("None", 3) in sessions["dynamic"].sql(sql).rows


NESTED = ("SELECT k, cardinality(e), e FROM (VALUES (1, ARRAY[ARRAY[1, 2], "
          "ARRAY[3]]), (2, ARRAY[ARRAY[4, 5, 6]])) AS v(k, a) "
          "CROSS JOIN UNNEST(a) AS u(e) ORDER BY k, e")


def test_nested_elements(sessions):
    """Nested elements with their element dictionary: the static path
    equals presto_tpu's, and the port's dynamic path gives the same rows
    (presto_tpu's dynamic path cannot hold them: numpy sees a ragged
    sequence, and raises ValueError)."""
    assert_frozen(values_of(sessions["auto"], NESTED),
                  expected("nested", "auto"))
    assert frozen_rows("nested", "auto") == [
        (1, 2, (1, 2)), (1, 1, (3,)), (2, 3, (4, 5, 6))]
    assert sessions["dynamic"].sql(NESTED).rows \
        == frozen_rows("nested", "auto")
    assert expected("nested", "dynamic")["error"] == "ValueError"


def frozen_cases():
    """{case: (presto_tpu's catalog, sql)} of the values frozen for this
    module (tests/torch_collections_common.py)."""
    ref = _catalogs()[1]
    cases = {name: (ref, sql) for name, sql in CASES.items()}
    cases.update({f"null:{e}": (ref, sql)
                  for e, sql in NULL_ELEMENTS.items()})
    cases["nested"] = (ref, NESTED)
    return cases


@pytest.mark.slow
def test_frozen_values_are_presto_tpus():
    """presto_tpu, run live, gives the frozen values of every case."""
    check_reference(__name__)


def test_static_bound_is_the_references():
    from presto_tpu.exec.executor import Executor as RExecutor

    assert Executor.STATIC_UNNEST_MAX == 50_000_000
    assert "total > 50_000_000" in inspect.getsource(
        RExecutor._unnest_static)


@pytest.mark.parametrize("mode,error", [("auto", None),
                                        ("compiled", StaticFallback)])
def test_static_fallback_past_the_bound(mode, error, monkeypatch):
    """Past capacity x maxlen > the bound, "auto" runs the dynamic
    executor (no memo entry) and "compiled" raises StaticFallback with
    the reference's message."""
    monkeypatch.setattr(Executor, "STATIC_UNNEST_MAX", 100)
    session = presto_tpu_torch.connect(_catalogs()[0], device="cpu",
                                       execution_mode=mode)
    sql = CASES["split_words"]
    if error is not None:
        with pytest.raises(error, match=r"static UNNEST expansion too "
                                        r"large: 300 x 3"):
            session.sql(sql)
        return
    result = session.sql(sql)
    assert result.stats.execution_mode == "dynamic"
    assert not [k for k in getattr(session, "_compiled_cache", {})
                if k[0] == sql]
    assert_rows_equal(result.rows, frozen_rows("split_words", "dynamic"))


@pytest.mark.parametrize("mode", MODES)
def test_staged_expansion_gather(mode, monkeypatch):
    """With staging on, the expansion (indices ascending with repeats)
    goes through block_gather's plain version and gives the same rows."""
    monkeypatch.setattr(G, "_staging_enabled", lambda device: True)
    monkeypatch.setattr(G, "_STAGED_MIN_INDICES", 16)
    calls = []
    real = G.block_gather

    def counted(mat, idx):
        calls.append(idx.shape[0])
        return real(mat, idx)

    monkeypatch.setattr(G, "block_gather", counted)
    session = presto_tpu_torch.connect(_catalogs()[0], device="cpu",
                                       execution_mode=mode)
    assert_rows_equal(session.sql(CASES["grouped_words"]).rows,
                      frozen_rows("grouped_words", mode))
    assert calls
