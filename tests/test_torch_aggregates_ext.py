"""The 23 aggregates this slice adds to presto_tpu_torch's executor, and
avg over both interval types, against presto_tpu on the CPU.

One memory table from a seeded numpy generator holds groups of 1 to 4
rows (FILTER clauses and an always-false one give groups of 0 rows),
groups whose values are all NULL, ties in the keys of min_by and max_by
with a NULL value at a winning row, NaN, -0.0 and 0.0 among the doubles,
and strings with NULLs.  Doubles are eighths, so the moments' power sums
are exact in f64 and both packages cancel them alike.  Grouped entropy
reads groups of two or more positive values: over one value it cancels
to 0 plus a few ulps, which in presto_tpu differ between its two modes
(its log2 inside and outside the grouped sum rounds differently), as
var_pop's do in tests/test_torch_tpcds_functions.py.  A second table
has 9,000 groups: approx_distinct's error argument asks for m = 64 to
65,536 registers, and the register matrix's bound (2^23 cells) shrinks m
past 8,192 groups at m = 1,024, on one side of that count and the other.
Each probe runs in `execution_mode` "dynamic" and "auto"; rows (NaN equal
to NaN, floats within rtol 1e-9, approx_distinct and approx_percentile
exactly), the seven counters of QueryStats, the execution mode and the
memo entry must equal presto_tpu's, and each static pass reads nothing
back to the host.
"""

import numpy as np
import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu import types as RT
from presto_tpu.catalog import Catalog as RCatalog
from presto_tpu_torch import types as T
from presto_tpu_torch.catalog import Catalog
from tests.test_torch_compiled import _memo_state
from tests.test_torch_tpch import counters
from tests.torch_functions_common import (assert_rows_equal,
                                          static_pass_builds)
from tests.torch_threads import torch_one_thread  # noqa: F401

MODES = ("dynamic", "auto")
N = 400
BIG_GROUPS = 9_000
BIG_ROWS_PER_GROUP = 8
SCHEMA = {"id": "BIGINT", "g": "BIGINT", "v": "DOUBLE", "w": "DOUBLE",
          "iv": "BIGINT", "k": "BIGINT", "b": "BOOLEAN", "s": "VARCHAR"}
BIG_SCHEMA = {"g": "BIGINT", "x": "BIGINT", "s": "VARCHAR"}


def _columns():
    """Groups 0..119 of 1 to 4 rows (g = 0 to 3 in turn gets 1 to 4
    rows); groups 100..119 have every v, w and iv NULL."""
    rng = np.random.default_rng(23)
    sizes = np.array([1 + (grp % 4) for grp in range(120)])
    g = np.repeat(np.arange(120), sizes)[:N]
    n = len(g)
    v = rng.integers(-800, 800, n) / 8.0
    w = rng.integers(-40, 40, n) / 8.0
    w[:6] = [float("nan"), -0.0, 0.0, 0.0, -0.0, float("nan")]
    all_null = g >= 100
    v_null = (rng.random(n) < 0.1) | all_null
    iv = rng.integers(-(1 << 40), 1 << 40, n)
    iv[:4] = [-1, 0, (1 << 62) + 7, -(1 << 63)]
    k = rng.integers(0, 3, n)  # few keys: ties at the extremes
    val_null = rng.random(n) < 0.2
    words = np.array(["kiwi", "", "Äpfel", "plum", "fig", "zeta"],
                     dtype=object)
    return {"id": np.arange(n, dtype=np.int64),
            "g": g.astype(np.int64),
            "v": np.ma.masked_array(v, v_null),
            "w": np.ma.masked_array(w, all_null),
            "iv": np.ma.masked_array(iv.astype(np.int64),
                                     val_null | all_null),
            "k": np.ma.masked_array(k.astype(np.int64), rng.random(n) < 0.1),
            "b": np.ma.masked_array(rng.random(n) < 0.7,
                                    rng.random(n) < 0.15),
            "s": np.ma.masked_array(words[rng.integers(0, len(words), n)],
                                    rng.random(n) < 0.15)}


def _big_columns():
    rng = np.random.default_rng(5)
    g = np.repeat(np.arange(BIG_GROUPS), BIG_ROWS_PER_GROUP)
    x = rng.integers(0, 1 << 20, len(g))
    s = np.array([f"w{int(v) % 5000}" for v in x], dtype=object)
    return {"g": g.astype(np.int64), "x": x.astype(np.int64), "s": s}


PROBES = {
    "sketches": (
        "SELECT g, approx_distinct(iv), approx_distinct(v, 0.1), "
        "approx_distinct(s), approx_distinct(w), count(iv) WITH ERROR, "
        "sum(v) WITH ERROR, sum(iv) WITH ERROR, checksum(v), checksum(s), "
        "checksum(b) FROM t GROUP BY g ORDER BY g"),
    "percentiles": (
        "SELECT g, approx_percentile(v, 0.5), approx_percentile(w, 0.0), "
        "approx_percentile(w, 1.0), approx_percentile(iv, 0.99), "
        "approx_percentile(w, 0.25) FROM t GROUP BY g ORDER BY g"),
    "min_max_by_and_any": (
        "SELECT g, min_by(iv, k), max_by(iv, k), min_by(s, v), "
        "max_by(v, k), min_by(w, s), arbitrary(s), any_value(iv), "
        "arbitrary(v) FROM t GROUP BY g ORDER BY g"),
    "booleans_and_bits": (
        "SELECT g, bool_and(b), every(v > 0), bool_or(b), "
        "bitwise_and_agg(iv), bitwise_or_agg(iv), bitwise_or_agg(k) "
        "FROM t GROUP BY g ORDER BY g"),
    "bivariate": (
        "SELECT g, corr(v, w), covar_samp(v, w), covar_pop(v, w), "
        "regr_slope(v, w), regr_intercept(v, w) FROM t "
        "WHERE id > 5 GROUP BY g ORDER BY g"),
    "moments": (
        "SELECT g, skewness(v), kurtosis(v), geometric_mean(abs(v)), "
        "entropy(power(2, coalesce(k, 1))) FILTER (WHERE g % 4 > 0), "
        "geometric_mean(k), entropy(coalesce(k, 0) + 1) "
        "FILTER (WHERE g % 4 > 0) FROM t "
        "GROUP BY g ORDER BY g"),
    "intervals": (
        "SELECT g, avg(CASE WHEN iv > 0 THEN INTERVAL '2' DAY "
        "ELSE INTERVAL '-3' HOUR END), "
        "avg(CASE WHEN k = 1 THEN INTERVAL '5' MONTH "
        "WHEN k = 2 THEN INTERVAL '-1' YEAR END) FROM t "
        "GROUP BY g ORDER BY g"),
    "empty_groups_by_filter": (
        "SELECT g, approx_distinct(v) FILTER (WHERE id < 0), "
        "approx_percentile(v, 0.5) FILTER (WHERE id < 0), "
        "min_by(iv, k) FILTER (WHERE k > 5), "
        "bool_or(b) FILTER (WHERE id < 0), "
        "checksum(iv) FILTER (WHERE id < 0), "
        "corr(v, w) FILTER (WHERE id < 0), count(*) FROM t "
        "GROUP BY g ORDER BY g"),
    "global": (
        "SELECT approx_distinct(iv), approx_percentile(v, 0.5), "
        "min_by(s, iv), max_by(s, iv), bool_and(b), checksum(iv), "
        "corr(v, w), skewness(w), kurtosis(w), entropy(k), "
        "bitwise_and_agg(k), geometric_mean(k), count(v) WITH ERROR "
        "FROM t"),
    "global_empty": (
        "SELECT approx_distinct(iv), approx_percentile(v, 0.5), "
        "min_by(s, iv), bool_or(b), checksum(iv), covar_pop(v, w), "
        "bitwise_or_agg(k), arbitrary(s) FROM t WHERE id < 0"),
    "distinct": (
        "SELECT g % 7, approx_distinct(DISTINCT k), count(DISTINCT k), "
        "approx_distinct(k) FROM t GROUP BY g % 7 ORDER BY 1"),
    "register_counts_few_groups": (
        "SELECT g % 16 AS h, approx_distinct(x, 0.13), "
        "approx_distinct(x, 0.0325), approx_distinct(s, 0.0040625) "
        "FROM big GROUP BY g % 16 ORDER BY h"),
    "register_counts_many_groups": (
        "SELECT count(*), sum(a), sum(b), sum(c), max(a), min(c) FROM ("
        "SELECT g, approx_distinct(x) a, approx_distinct(x, 0.0040625) b, "
        "approx_distinct(s, 0.13) c FROM big GROUP BY g) t"),
}

#: probes whose float columns hold exact values (approx_percentile)
EXACT = {"percentiles": (1, 2, 3, 4, 5)}


def _catalogs():
    port, ref = Catalog(), RCatalog()
    for name, schema, cols in (("t", SCHEMA, _columns()),
                               ("big", BIG_SCHEMA, _big_columns())):
        port.register_memory(name, {c: T.parse_type(t)
                                    for c, t in schema.items()}, cols)
        ref.register_memory(name, {c: RT.parse_type(t)
                                   for c, t in schema.items()}, cols)
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
    assert_rows_equal(mine.rows, theirs.rows, EXACT.get(name, ()))
    assert counters(mine.stats) == counters(theirs.stats)
    assert mine.stats.execution_mode == theirs.stats.execution_mode
    assert _memo_state(port, sql) == _memo_state(ref, sql)


def test_ties_and_null_winners(sessions):
    """min_by / max_by rank by the key's validity alone and take the last
    of tied rows, whose NULL value comes back NULL; groups of all-NULL
    values give NULL (and approx_distinct 0)."""
    rows = {r[0]: r[1:] for r in sessions["port", "dynamic"].sql(
        "SELECT g, min_by(iv, k), approx_distinct(iv), count(iv), "
        "bool_and(v > 0) FROM t GROUP BY g").rows}
    cols = _columns()
    g, k, iv = cols["g"], cols["k"], cols["iv"]
    for grp in (7, 11, 50):
        live = (g == grp) & ~np.ma.getmaskarray(k)
        if not live.any():
            continue
        low = np.ma.getdata(k)[live].min()
        last = np.flatnonzero(live & (np.ma.getdata(k) == low))[-1]
        want = None if np.ma.getmaskarray(iv)[last] \
            else int(np.ma.getdata(iv)[last])
        assert rows[grp][0] == want
    assert rows[105][1:] == (0, 0, None)


@pytest.mark.parametrize("name", sorted(PROBES))
def test_static_pass_reads_nothing_back(name):
    result, built = static_pass_builds(PROBES[name], _catalogs()[0])
    assert len(built) == (result.stats.execution_mode == "compiled")
