"""DECIMAL columns of memory tables in presto_tpu_torch against
presto_tpu on the CPU, in execution_mode "dynamic" and "auto": the
table cases of tests/test_decimal128.py (exact sums, minima and maxima
of 26-digit values, ORDER BY of long values and the DESC tie in the low
limb, 38-digit strings) and the ingest of Python ints, Decimals,
strings, floats and unscaled integers (the same rows in both packages,
and Python's decimal values)."""

import random
from decimal import Decimal

import numpy as np
import pytest

from tests.test_torch_decimal import MODES, _same, _sessions
from tests.torch_threads import torch_one_thread  # noqa: F401


def _fixture_data(n=20_000, seed=7):
    rng = random.Random(seed)
    vals = [Decimal(rng.randint(-10 ** 24, 10 ** 24)) / 100
            for _ in range(n)]
    grp = [rng.randrange(5) for _ in range(n)]
    return vals, grp


def _fixture_builder(vals, grp):
    def build(cat, T):
        cat.register_memory(
            "t", {"g": T.BIGINT, "v": T.decimal(38, 2)},
            {"g": np.asarray(grp, np.int64),
             "v": np.asarray([str(v) for v in vals], dtype=object)})
    return build


@pytest.mark.parametrize("mode", MODES)
def test_sum_min_max_exact_over_table(mode):
    vals, grp = _fixture_data()
    ref, port = _sessions(_fixture_builder(vals, grp), mode)
    r = _same(ref, port, "SELECT sum(v), min(v), max(v) FROM t")[0]
    assert r == (sum(vals), min(vals), max(vals))
    rows = _same(ref, port, "SELECT g, sum(v), min(v), max(v) FROM t "
                 "GROUP BY g ORDER BY g")
    for g, sm, mn, mx in rows:
        sub = [v for v, gg in zip(vals, grp) if gg == g]
        assert (sm, mn, mx) == (sum(sub), min(sub), max(sub)), g


@pytest.mark.parametrize("mode", MODES)
def test_order_by_long_exact(mode):
    vals, grp = _fixture_data(n=3000)
    ref, port = _sessions(_fixture_builder(vals, grp), mode)
    rows = _same(ref, port, "SELECT v FROM t ORDER BY v LIMIT 50")
    assert [r[0] for r in rows] == sorted(vals)[:50]
    rows = _same(ref, port, "SELECT v FROM t ORDER BY v DESC LIMIT 50")
    assert [r[0] for r in rows] == sorted(vals, reverse=True)[:50]


@pytest.mark.parametrize("mode", MODES)
def test_ingest_38_digit_strings(mode):
    vals = ["1234567890123456789012345678.90",
            "-9999999999999999999999999999999999.99"]

    def build(cat, T):
        cat.register_memory("big", {"v": T.decimal(38, 2)},
                            {"v": np.asarray(vals, dtype=object)})

    ref, port = _sessions(build, mode)
    rows = _same(ref, port, "SELECT v FROM big ORDER BY v")
    assert rows == [(Decimal(vals[1]),), (Decimal(vals[0]),)]


@pytest.mark.parametrize("mode", MODES)
def test_desc_sort_low_limb_tie(mode):
    k = 3 << 64
    vals = [k, k + 1, k - 1]

    def build(cat, T):
        cat.register_memory("t", {"v": T.decimal(38, 0)},
                            {"v": np.asarray([str(v) for v in vals],
                                             dtype=object)})

    ref, port = _sessions(build, mode)
    rows = _same(ref, port, "SELECT v FROM t ORDER BY v DESC")
    assert [r[0] for r in rows] == [Decimal(k + 1), Decimal(k),
                                    Decimal(k - 1)]


def test_ingest_ints_decimals_floats():
    """Long decimals ingest from Python ints, Decimals and strings (half
    up at the column's scale), short ones from floats (scaled and
    rounded) and from unscaled integers."""
    def build(cat, T):
        cat.register_memory("m", {"a": T.decimal(30, 2),
                                  "b": T.decimal(30, 1),
                                  "c": T.decimal(10, 2),
                                  "d": T.decimal(10, 2)},
                            {"a": np.asarray([1, -7, 10 ** 25], dtype=object),
                             "b": np.asarray([Decimal("0.05"),
                                              Decimal("-0.05"), "2.449"],
                                             dtype=object),
                             "c": np.asarray([1.005, -2.5, 0.0]),
                             "d": np.asarray([125, -1, 0], np.int64)})

    ref, port = _sessions(build)
    rows = _same(ref, port, "SELECT a, b, c, d FROM m")
    assert [r[0] for r in rows] == [Decimal("1.00"), Decimal("-7.00"),
                                    Decimal(10 ** 25).quantize(
                                        Decimal("0.01"))]
    assert [r[1] for r in rows] == [Decimal("0.1"), Decimal("-0.1"),
                                    Decimal("2.4")]
    assert [r[3] for r in rows] == [1.25, -0.01, 0.0]
