"""The scalar functions and aggregates the 99 TPC-DS queries add to
presto_tpu_torch, against presto_tpu on the CPU: abs, round, upper,
concat and `||`, comparisons of two string columns whose dictionaries
differ, and the stddev/variance family.

Both packages read one memory table made from seeded numpy columns with
NULLs, and run each probe in `execution_mode` "dynamic" and "auto".
Rows, the seven counters of QueryStats and the compiled memo's entry
must equal presto_tpu's (floats within rtol 1e-9).  round() is held at
.5 ties of both signs and at a negative number of digits, where it
rounds half away from zero; the moments at groups of 0, 1, 2 and more
rows, where the sample variants are NULL below two rows.  The moments
read a column of eighths, whose squares and sums are exact in f64, so
both packages form the same E[x^2] and E[x]^2: their difference
cancels, and the reference's compiler contracts it into a fused
multiply-add (a var_pop of 7.7e-12 for one row of normal draws where
the port gives 0.0), so over inexact inputs the comparison would hold
rounding, not the function.  The static
pass of a cross-dictionary comparison and of a concat reads nothing
back to the host and stores no Python scalar into a tensor.
"""

import numpy as np
import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu import types as RT
from presto_tpu.catalog import Catalog as RCatalog
from presto_tpu_torch import types as T
from presto_tpu_torch.catalog import Catalog
from presto_tpu_torch.exec import compile_cache as CC
from tests.test_torch_compiled import _memo_state, no_host_reads
from tests.test_torch_setops_joins import no_scalar_stores
from tests.test_torch_tpch import _assert_rows_match, counters
from tests.torch_threads import torch_one_thread  # noqa: F401

MODES = ("dynamic", "auto")
N = 240
WORDS_1 = ["apple", "Banana", "cherry", "kiwi", "pear", "plum", "zeta", ""]
WORDS_2 = ["apple", "banana", "Cherry", "kiwi", "quince", "zeta", "a"]
SCHEMA = {"id": "BIGINT", "g": "BIGINT", "x": "DOUBLE", "m": "DOUBLE",
          "i": "BIGINT", "s1": "VARCHAR", "s2": "VARCHAR"}


def _columns():
    """The table's numpy columns, from a seed: x mixes random doubles
    with exact .5 ties of both signs, m holds eighths; g has groups of
    1, 2 and 3 rows (the last all NULL in x and m) beside larger
    ones."""
    rng = np.random.default_rng(11)
    g = rng.integers(0, 8, N)
    g[:1], g[1:3], g[3:6] = 100, 101, 102
    ties = np.array([0.5, -0.5, 1.5, -1.5, 2.5, -2.5, 0.25, -0.25, 0.125,
                     -0.125, 15.0, -15.0, 25.0, -25.0, 0.0, 1e15 + 0.5])
    x = rng.normal(0, 1000, N)
    x[6:6 + len(ties)] = ties
    i = rng.integers(-10**6, 10**6, N)
    m = rng.integers(-80_000, 80_000, N) / 8.0
    x_null = rng.random(N) < 0.1
    x_null[3:6] = True
    x_null[:3] = False
    x_null[6:6 + len(ties)] = False
    return {
        "id": np.arange(N, dtype=np.int64),
        "g": g.astype(np.int64),
        "x": np.ma.masked_array(x, x_null),
        "m": np.ma.masked_array(m, x_null),
        "i": np.ma.masked_array(i.astype(np.int64), rng.random(N) < 0.1),
        "s1": np.ma.masked_array(
            np.array(WORDS_1, dtype=object)[rng.integers(0, len(WORDS_1),
                                                         N)],
            rng.random(N) < 0.1),
        "s2": np.ma.masked_array(
            np.array(WORDS_2, dtype=object)[rng.integers(0, len(WORDS_2),
                                                         N)],
            rng.random(N) < 0.1)}


_MOMENTS = ("stddev(m), stddev_samp(m), stddev_pop(m), variance(m), "
            "var_samp(m), var_pop(m)")

PROBES = {
    "abs": ("SELECT id, abs(x), abs(i), abs(-3), abs(-2.5), abs(x - i) "
            "FROM t ORDER BY id"),
    "round": ("SELECT id, round(x), round(x, 1), round(x, 2), "
              "round(x, -1), round(i), round(i, -2), round(2.5), "
              "round(-2.5), round(-0.25, 1), round(15.0, -1) "
              "FROM t ORDER BY id"),
    "round_in_aggregates": ("SELECT g, round(sum(x), 2), round(avg(i), -3) "
                            "FROM t GROUP BY g ORDER BY g"),
    "upper": ("SELECT id, upper(s1), upper(s2), upper('mIxEd') FROM t "
              "ORDER BY id"),
    "upper_grouped": ("SELECT upper(s1), count(*) FROM t GROUP BY upper(s1) "
                      "ORDER BY 1"),
    "concat_literal_and_column": (
        "SELECT id, s1 || '-x', concat('p:', s2), concat(s1, ', '), "
        "'a' || 'b' FROM t ORDER BY id"),
    "concat_dictionaries": (
        "SELECT id, s1 || s2, concat(s2, ', ', s1), upper(s1 || s2) "
        "FROM t ORDER BY id"),
    "concat_grouped": ("SELECT s1 || ', ' || s2 AS name, count(*) FROM t "
                       "GROUP BY s1 || ', ' || s2 ORDER BY name"),
    "compare_dictionaries": (
        "SELECT id, s1 = s2, s1 <> s2, s1 < s2, s1 <= s2, s1 > s2, "
        "s1 >= s2 FROM t ORDER BY id"),
    "compare_dictionaries_in_filter": (
        "SELECT count(*), count_if(s1 < s2), sum(i) FROM t "
        "WHERE s1 = s2 OR s1 > s2"),
    "compare_upper_with_column": (
        "SELECT id, upper(s1) = upper(s2), upper(s1) < s2 FROM t "
        "WHERE upper(s1) <> s2 ORDER BY id"),
    "moments_grouped": (f"SELECT g, {_MOMENTS}, count(m) FROM t "
                        "GROUP BY g ORDER BY g"),
    "moments_of_integers": ("SELECT g, stddev_samp(i), var_pop(i) FROM t "
                            "GROUP BY g ORDER BY g"),
    "moments_global": f"SELECT {_MOMENTS}, count(*) FROM t",
    "moments_global_one_row": f"SELECT {_MOMENTS} FROM t WHERE id = 0",
    "moments_global_empty": f"SELECT {_MOMENTS} FROM t WHERE id < 0",
    "moments_filtered_groups": (f"SELECT g, {_MOMENTS} FROM t WHERE id < 60 "
                                "GROUP BY g ORDER BY g"),
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
    port, ref = _catalogs()
    return {(pkg, mode): lib.connect(cat, execution_mode=mode, **kw)
            for pkg, lib, cat, kw in (
                ("port", presto_tpu_torch, port, {"device": "cpu"}),
                ("ref", presto_tpu, ref, {}))
            for mode in MODES}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(PROBES))
def test_matches_reference(name, mode, sessions):
    sql = PROBES[name]
    port, ref = sessions["port", mode], sessions["ref", mode]
    mine, theirs = port.sql(sql), ref.sql(sql)
    _assert_rows_match(mine.rows, theirs.rows, "ORDER BY" in sql)
    assert counters(mine.stats) == counters(theirs.stats)
    assert mine.stats.execution_mode == theirs.stats.execution_mode
    assert _memo_state(port, sql) == _memo_state(ref, sql)


def test_round_is_half_away_from_zero(sessions):
    rows = sessions["port", "dynamic"].sql(
        "SELECT x, round(x), round(x, 1), round(x, -1) FROM t "
        "WHERE id >= 6 AND id < 20 ORDER BY id").rows
    want = {0.5: (1.0, 0.5, 0.0), -0.5: (-1.0, -0.5, -0.0),
            1.5: (2.0, 1.5, 0.0), -1.5: (-2.0, -1.5, -0.0),
            2.5: (3.0, 2.5, 0.0), -2.5: (-3.0, -2.5, -0.0),
            0.25: (0.0, 0.3, 0.0), -0.25: (-0.0, -0.3, -0.0),
            15.0: (15.0, 15.0, 20.0), -15.0: (-15.0, -15.0, -20.0),
            25.0: (25.0, 25.0, 30.0), -25.0: (-25.0, -25.0, -30.0)}
    seen = {r[0]: r[1:] for r in rows if r[0] in want}
    assert seen == want


def test_sample_moments_are_null_below_two_rows(sessions):
    rows = {r[0]: r[1:] for r in sessions["port", "dynamic"].sql(
        PROBES["moments_grouped"]).rows}
    # stddev, stddev_samp, stddev_pop, variance, var_samp, var_pop, count
    assert rows[100] == (None, None, 0.0, None, None, 0.0, 1)
    assert rows[102] == (None,) * 6 + (0,)
    two = rows[101]
    assert two[0] == two[1] and two[3] == two[4] and two[6] == 2
    assert two[4] == pytest.approx(2 * two[5], rel=1e-12)


@pytest.mark.parametrize("name", ["compare_dictionaries",
                                  "compare_dictionaries_in_filter",
                                  "concat_dictionaries", "concat_grouped",
                                  "concat_literal_and_column"])
def test_static_pass_reads_nothing_back(name):
    """The probe's static pass (what compiled mode captures on a card)
    with every host read and every Python scalar store made to raise:
    the recode and concat tables reach the device through
    batch.upload."""
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
        result = presto_tpu_torch.connect(_catalogs()[0], device="cpu").sql(
            PROBES[name])
    finally:
        CC.build_graph = real
    assert result.stats.execution_mode == "compiled" and len(built) == 1


def test_concat_over_the_product_cap_raises():
    from presto_tpu_torch.exec.colval import ColVal
    from presto_tpu_torch.batch import Dictionary
    from presto_tpu_torch.functions import scalar as S

    import torch

    big = Dictionary(np.array([f"w{k:05d}" for k in range(1100)],
                              dtype=object))
    col = ColVal(torch.zeros(4, dtype=torch.int32), None, T.VARCHAR, big)
    with pytest.raises(NotImplementedError, match="exceeds"):
        S.lookup("concat").emit([col, col])
    plain = ColVal(torch.zeros(4, dtype=torch.int32), None, T.VARCHAR)
    with pytest.raises(NotImplementedError, match="non-dictionary"):
        S.lookup("concat").emit([plain, col])
