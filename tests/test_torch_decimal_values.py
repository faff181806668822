"""Long DECIMAL values of a memory table (tests/test_torch_decimal_
columns.py's table) through presto_tpu_torch and presto_tpu on the CPU,
in execution_mode "dynamic" and "auto": sorts, arithmetic, comparisons,
casts, aggregates, CTAS, INSERT, SHOW STATS and DELETE (the same rows,
or the same error, in both packages).  Where presto_tpu computes a long
value limb by limb (truncate below 0, division), the port is held to
Python's decimal, or to presto_tpu's dec128.to_float64, instead."""

from decimal import Decimal

import numpy as np
import pytest

from tests.test_torch_decimal import MODES, _same, _sessions
from tests.test_torch_decimal_columns import _table_builder
from tests.torch_threads import torch_one_thread  # noqa: F401

VALUE_CASES = [
    # long values: sort, arithmetic, comparisons, CASE-free aggregates
    "SELECT k, big FROM w ORDER BY big DESC, k LIMIT 5",
    "SELECT g, sum(big), min(big), max(big), avg(big), count(big) FROM w "
    "GROUP BY g ORDER BY g",
    "SELECT k, big + q, big - 1, big * 3, -big, q * q FROM w "
    "ORDER BY k LIMIT 5",
    "SELECT count(*) FROM w WHERE big > q AND big < DECIMAL '1000000000.5'",
    "SELECT k, CAST(big AS DOUBLE), CAST(big AS BIGINT), "
    "CAST(q AS INTEGER), CAST(q AS VARCHAR), truncate(q, 1) FROM w "
    "ORDER BY k LIMIT 5",
    # presto_tpu truncates a long value limb by limb: right for values
    # in [0, 2^63), garbage below 0 (test_truncate_long_is_exact)
    "SELECT k, truncate(big, 1), truncate(big) FROM w WHERE big >= 0 "
    "ORDER BY k LIMIT 5",
    "SELECT stddev(q), var_pop(q), corr(q, k), approx_percentile(q, 0.5) "
    "FROM w",
    "SELECT k, q / 3, q / DECIMAL '0.7' FROM w WHERE q <> 0 ORDER BY k "
    "LIMIT 5",
    # CTAS, INSERT and SHOW STATS with a long column
    "CREATE TABLE w2 AS SELECT k, q, big FROM w WHERE k < 50",
    "INSERT INTO w2 SELECT k + 1000, -q, -big FROM w WHERE k < 5",
    "SELECT count(*), sum(q), sum(big), min(big) FROM w2",
    "SHOW STATS FOR w2",
    "DELETE FROM w2 WHERE big < 0",
    "SELECT count(*), sum(big) FROM w2",
]


@pytest.mark.parametrize("mode", MODES)
def test_value_cases(mode):
    ref, port = _sessions(_table_builder, mode)
    for sql in VALUE_CASES:
        _same(ref, port, sql)


def test_truncate_long_is_exact():
    """truncate of long values, negative ones too, against Python's
    decimal (toward zero, the scale kept)."""
    _ref, port = _sessions(_table_builder)
    rows = port.sql("SELECT big, truncate(big, 1), truncate(big) FROM w "
                    "ORDER BY k").rows
    for big, t1, t0 in rows:
        assert t1 == big.quantize(Decimal("0.1"), rounding="ROUND_DOWN") \
            .quantize(Decimal("0.01"))
        assert t0 == big.quantize(Decimal("1"), rounding="ROUND_DOWN") \
            .quantize(Decimal("0.01"))
    assert any(big < 0 for big, _a, _b in rows)


def _ref_to_float64(v: Decimal, scale: int) -> float:
    """presto_tpu's dec128.to_float64 of a value's limbs, over 10^scale:
    hi * 2^64 + u64(lo) in float64, which cancels for negative values of
    small magnitude (the high limb is -1), as the reference does."""
    n = int(v.scaleb(scale))
    hi, lo = n >> 64, n & ((1 << 64) - 1)
    return (float(hi) * 2.0 ** 64 + float(lo)) / 10 ** scale


def test_long_division_promotes_to_double():
    """A long value divided promotes to DOUBLE: both sides through
    dec128.to_float64 (presto_tpu's own division gives per-limb
    pairs)."""
    _ref, port = _sessions(_table_builder)
    rows = port.sql("SELECT big, q, big / q, CAST(big AS DOUBLE) FROM w "
                    "WHERE q <> 0 ORDER BY k").rows
    for big, q, r, d in rows:
        want = _ref_to_float64(big, 2)
        assert d == want
        with np.errstate(divide="ignore", invalid="ignore"):
            quot = np.float64(want) / np.float64(
                _ref_to_float64(Decimal(repr(q)), 2))
        assert r == quot or (r != r and quot != quot)
