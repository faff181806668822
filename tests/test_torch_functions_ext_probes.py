"""The scalar names of presto_tpu/functions/scalar_ext.py and
scalar_ext2.py in presto_tpu_torch over the columns of `vals` (seed 11,
n = 500, as tests/test_functions_ext.py builds it), against presto_tpu
on the CPU; tests/test_torch_functions_ext.py holds the SQL cases of
tests/test_functions_ext.py and test_functions_ext2.py and states the
tolerances.  Here also: betainc alone against jax.scipy.special.betainc
and scipy.special.betainc, DECIMAL abs, round, floor, ceil, sign and mod
against Python's decimal, the registry's coverage (the names of
presto_tpu's registry the port still lacks, listed so that a later
slice shrinks the list) and the dictionary-product bound.

The `inverses` probe runs in "dynamic" only: presto_tpu's compiled
program of eleven inverse CDFs takes about 30 s to build on the CPU, and
the graph of the same functions is E2's (tests/
test_torch_functions_ext_corpus.py, every mode).
"""

import decimal
import math

import numpy as np
import pytest
import scipy.special
import torch

import presto_tpu_torch
from presto_tpu_torch import types as T
from presto_tpu_torch.catalog import Catalog, MemoryTable
from presto_tpu_torch.functions import scalar as S
from presto_tpu_torch.functions import scalar_ext as X
from tests.test_torch_functions_ext import (  # noqa: F401 (a fixture)
    MODES, _assert_like_reference, _run_both, sessions)
from tests.torch_functions_common import values_equal
from tests.torch_threads import torch_one_thread  # noqa: F401

#: the same names over the columns of vals
COLUMN_PROBES = {
    "math": (
        "SELECT g, sum(sin(x)), sum(cos(y)), sum(tan(x)), sum(atan(y)), "
        "sum(asin(x / 11)), sum(acos(y / 10)), sum(sinh(y)), sum(cosh(y)), "
        "sum(tanh(x)), sum(degrees(x)), sum(radians(i)), sum(log2(c)), "
        "sum(exp2(y)), count_if(is_nan(x / i)), count_if(is_finite(x / i)), "
        "count_if(is_infinite(x / (i - i))) FROM vals GROUP BY g ORDER BY g"),
    "cdfs": (
        "SELECT g, sum(normal_cdf(3, 2, x)), sum(cauchy_cdf(0, 1, y)), "
        "sum(laplace_cdf(1, 2, x)), sum(logistic_cdf(0, 1, y)), "
        "sum(weibull_cdf(1.5, 2, x)), sum(poisson_cdf(10, c)), "
        "sum(chi_squared_cdf(3, c)), sum(gamma_cdf(2, 3, c)), "
        "sum(binomial_cdf(50, 0.3, c)), "
        "sum(wilson_interval_lower(c, 50, 1.96)), "
        "sum(wilson_interval_upper(c, 50, 1.96)), "
        "sum(normal_cdf(0, x, 1)) FROM vals GROUP BY g ORDER BY g"),
    "betainc_cdfs": (
        "SELECT g, sum(beta_cdf(2, 5, c / 50.0)), "
        "sum(f_cdf(5, 2, abs(x))), sum(beta_cdf(0.5, 0.5, c / 51.0)) "
        "FROM vals GROUP BY g ORDER BY g"),
    "inverses": (
        "SELECT g, sum(inverse_normal_cdf(0, 1, c / 51.0)), "
        "sum(inverse_cauchy_cdf(0, 1, c / 51.0)), "
        "sum(inverse_laplace_cdf(0, 2, c / 51.0)), "
        "sum(inverse_logistic_cdf(1, 2, c / 51.0)), "
        "sum(inverse_weibull_cdf(1.5, 2, c / 51.0)), "
        "sum(inverse_chi_squared_cdf(3, c / 51.0)), "
        "sum(inverse_gamma_cdf(2, 3, c / 51.0)), "
        "sum(inverse_poisson_cdf(10, c / 51.0)), "
        "sum(inverse_beta_cdf(2, 5, c / 51.0)), "
        "sum(inverse_f_cdf(5, 2, c / 51.0)), "
        "sum(inverse_binomial_cdf(20, 0.3, c / 51.0)) "
        "FROM vals GROUP BY g ORDER BY g"),
    "cbrt": "SELECT i, cbrt(i), cbrt(x), cbrt(x * 1e6) FROM vals ORDER BY i",
    "bits": (
        "SELECT i, bit_count(i, 64), bit_count(i, 8), bit_count(i, 32), "
        "bitwise_logical_shift_right(i, c), "
        "bitwise_arithmetic_shift_right(i, c), "
        "bitwise_logical_shift_right(i, 64), "
        "bitwise_arithmetic_shift_right(i, 70) FROM vals ORDER BY i, c"),
    "host_per_value": (
        "SELECT g, i, to_base(i, 7), to_big_endian_64(i), "
        "to_ieee754_64(x), to_big_endian_32(i), "
        "from_big_endian_64(to_big_endian_64(i)) FROM vals "
        "ORDER BY g, i, x"),
    "strings": (
        "SELECT to_base(c, 36) b, soundex(to_base(c, 36)), "
        "levenshtein_distance(to_base(c, 36), 'z'), "
        "md5(to_utf8(to_base(c, 36))), crc32(to_utf8(to_base(c, 36))), "
        "to_hex(sha1(to_utf8(to_base(c, 36)))), count(*) FROM vals "
        "GROUP BY 1, 2, 3, 4, 5, 6 ORDER BY 1"),
    "dates": (
        "SELECT g, date_add('day', i, DATE '2000-02-29') d, "
        "day_of_month(date_add('day', i, DATE '2000-02-29')), "
        "yow(date_add('day', i, DATE '2000-02-29')), "
        "hour(CAST(date_add('day', i, DATE '2000-02-29') AS TIMESTAMP) "
        "+ INTERVAL '5' HOUR), "
        "date_format(date_add('day', i, DATE '2000-02-29'), '%Y-%m') "
        "FROM vals ORDER BY g, d"),
}

#: the columns of the probes whose doubles take a wider bound than 1e-9
_CBRT_ULPS = 4


#: probes that run in one mode only (the module docstring says why)
PROBE_MODES = {"inverses": ("dynamic",)}
_PROBE_RUNS = [(name, mode) for name in sorted(COLUMN_PROBES)
               for mode in PROBE_MODES.get(name, MODES)]


@pytest.mark.parametrize("name,mode", _PROBE_RUNS)
def test_column_probe_matches_reference(name, mode, sessions):
    sql = COLUMN_PROBES[name]
    if name != "cbrt":
        _assert_like_reference(sessions, sql, mode)
        return
    _, _, mine, theirs = _run_both(sessions, sql, mode)
    assert len(mine.rows) == len(theirs.rows)
    for ra, rb in zip(mine.rows, theirs.rows):
        for a, b in zip(ra, rb):
            if isinstance(a, float) and math.isfinite(b):
                assert abs(a - b) <= _CBRT_ULPS * math.ulp(b), (ra, rb)
            else:
                assert values_equal(a, b), (ra, rb)


def test_varbinary_values_come_back_as_bytes(sessions):
    rows = sessions["port", "dynamic"].sql(
        "SELECT md5(to_utf8(to_base(c, 36))), to_big_endian_32(c) FROM vals "
        "ORDER BY c LIMIT 3").rows
    assert all(isinstance(v, bytes) for r in rows for v in r)


# ---------------------------------------------------------------------------
# betainc alone
# ---------------------------------------------------------------------------


def _betainc_grid():
    rng = np.random.default_rng(5)
    a = np.concatenate([rng.uniform(0.05, 3, 120), rng.uniform(3, 300, 120),
                        [0.5, 1.0, 2.0, 5.0, 1000.0, 20000.0]])
    b = np.concatenate([rng.uniform(0.05, 3, 120), rng.uniform(3, 300, 120),
                        [0.5, 1.0, 5.0, 2.0, 1000.0, 30000.0]])
    x = np.concatenate([rng.uniform(0, 1, 240),
                        [1e-12, 1 - 1e-12, 0.5, 0.999, 0.001, 0.2]])
    tails = np.concatenate([10.0 ** -np.arange(1, 16),
                            1 - 10.0 ** -np.arange(1, 16)])
    a = np.concatenate([a, np.full(30, 2.5), [0.0, 1.0, 2.0, -1.0]])
    b = np.concatenate([b, np.full(30, 7.5), [1.0, 0.0, 2.0, 1.0]])
    x = np.concatenate([x, tails, [0.3, 0.3, 1.5, 0.3]])
    return a, b, x


def test_betainc_matches_jax_and_scipy():
    import jax.scipy.special as jsp

    a, b, x = _betainc_grid()
    mine = X.betainc(*(torch.from_numpy(v) for v in (a, b, x)),
                     iters=X.BETAINC_MAX_ITERS).numpy()
    theirs = np.asarray(jsp.betainc(a, b, x))
    sp = scipy.special.betainc(a, b, x)
    ok = np.isfinite(theirs)
    assert np.array_equal(np.isnan(mine), np.isnan(theirs))
    np.testing.assert_allclose(mine[ok], theirs[ok], rtol=1e-12, atol=1e-300)
    fin = ok & np.isfinite(sp)
    np.testing.assert_allclose(mine[fin], sp[fin], rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("ab", [(2.0, 5.0), (0.5, 0.5), (30.0, 3000.0),
                                (2.5, 10000.0)])
def test_betainc_iteration_count_for_constant_parameters(ab):
    """The count betainc_iters gives constant parameters agrees with the
    full count within 1e-13 relative (a converged step multiplies by a
    factor within 2^-53 of 1)."""
    x = torch.linspace(0, 1, 257, dtype=torch.float64)
    a, b = (torch.full_like(x, v) for v in ab)
    full = X.betainc(a, b, x, X.BETAINC_MAX_ITERS)
    short = X.betainc(a, b, x, X.betainc_iters(*ab))
    torch.testing.assert_close(short, full, rtol=1e-13, atol=0)


# ---------------------------------------------------------------------------
# DECIMAL math against Python's decimal
# ---------------------------------------------------------------------------

_DEC_VALUES = ["1.5", "-1.5", "1.255", "-1.255", "0.004", "-0.005", "7.5",
               "2", "0", "123.456", "-999.999"]


def _dec_round(v: decimal.Decimal, d: int) -> decimal.Decimal:
    return v.quantize(decimal.Decimal(1).scaleb(-d),
                      rounding=decimal.ROUND_HALF_UP)


@pytest.mark.parametrize("mode", MODES + ("compiled",))
def test_decimal_math_equals_python_decimal(mode):
    s = presto_tpu_torch.connect(Catalog(), device="cpu", execution_mode=mode)
    D = decimal.Decimal
    for v in _DEC_VALUES:
        lit = f"DECIMAL '{v}'"
        dv = D(v)
        row = s.sql(f"SELECT abs({lit}), floor({lit}), ceil({lit}), "
                    f"sign({lit}), round({lit}), round({lit}, 2), "
                    f"round({lit}, 1)").rows[0]
        want = [abs(dv), dv.to_integral_value(decimal.ROUND_FLOOR),
                dv.to_integral_value(decimal.ROUND_CEILING),
                D((dv > 0) - (dv < 0)), _dec_round(dv, 0), _dec_round(dv, 2),
                _dec_round(dv, 1)]
        assert [D(str(r)) for r in row] == want, (v, row)
        for w in ("2", "0.7", "-3"):
            got = s.sql(f"SELECT mod({lit}, DECIMAL '{w}')").rows[0][0]
            rem = dv.copy_abs() % D(w).copy_abs()
            assert D(str(got)) == (rem if dv >= 0 else -rem), (v, w, got)


def test_decimal_math_over_columns_equals_python_decimal():
    cat = Catalog()
    rng = np.random.default_rng(3)
    vals = np.round(rng.normal(0, 50, 200), 3)
    cat.register(MemoryTable("d", {"v": T.decimal(10, 3),
                                   "w": T.decimal(30, 3)},
                             {"v": vals, "w": vals}))
    s = presto_tpu_torch.connect(cat, device="cpu",
                                 execution_mode="dynamic")
    rows = s.sql("SELECT v, floor(v), ceil(v), round(v, 1), sign(v), "
                 "abs(v), mod(v, DECIMAL '0.7'), floor(w), ceil(w), "
                 "round(w, 1), sign(w), abs(w) FROM d").rows
    D = decimal.Decimal
    for r in rows:
        dv = D(str(r[0])).quantize(D("0.001"))
        want = [dv.to_integral_value(decimal.ROUND_FLOOR),
                dv.to_integral_value(decimal.ROUND_CEILING),
                _dec_round(dv, 1), D((dv > 0) - (dv < 0)), abs(dv)]
        rem = dv.copy_abs() % D("0.7")
        got = [D(str(v)) for v in r[1:6]]
        assert got == want, r
        assert D(str(r[6])) == (rem if dv >= 0 else -rem), r
        assert [D(v) for v in r[7:]] == want, r


def test_decimal_mod_result_type():
    s = presto_tpu_torch.connect(Catalog(), device="cpu")
    assert s.sql("SELECT typeof(mod(DECIMAL '7.5', DECIMAL '2'))") \
        .rows[0][0] == "DECIMAL(2,1)"
    assert s.sql("SELECT typeof(mod(DECIMAL '123.45', 7))").rows[0][0] \
        == "DECIMAL(5,2)"


# ---------------------------------------------------------------------------
# what is still missing
# ---------------------------------------------------------------------------

#: presto_tpu's registry names the port still lacks, by the module that
#: defines them: the HyperLogLog states of chunked and distributed
#: execution (functions/geospatial.py and ml.py are ported now)
STILL_MISSING = {
    "sketches": {"$hll_reg", "$hll_rho"},
}


def test_registry_holds_every_name_but_the_listed_ones():
    from presto_tpu.functions.scalar import REGISTRY as REF

    missing = set(REF) - set(S.REGISTRY)
    listed = set().union(*STILL_MISSING.values())
    assert missing == listed
    assert [len(v) for v in STILL_MISSING.values()] == [2]
    assert not set(S.REGISTRY) - set(REF)


def test_this_slice_adds_153_names():
    from presto_tpu.functions import scalar_ext as RX, scalar_ext2 as RX2
    from presto_tpu.functions.scalar import REGISTRY as REF

    ext_names = {n for n in REF if getattr(REF[n].emit, "__module__", "")
                 in (RX.__name__, RX2.__name__)}
    assert ext_names <= set(S.REGISTRY)
    # and the later slices: datetime_tz.py (12 names) and the sketch
    # readers (6); geospatial.py (14) and ml.py (3)
    assert len(S.REGISTRY) == 141 + 153 + 18 + 17


@pytest.mark.parametrize("sql,module", [
    ("SELECT features(1.0, 2.0)", "features"),
    ("SELECT st_npoints(st_geometryfromtext('POINT (1 2)'))",
     "st_geometryfromtext"),
    ("SELECT st_x(st_point(1, 2))", "st_point")])
def test_names_of_later_slices_raise(sql, module):
    """These names came with a later slice (functions/geospatial.py and
    ml.py): they run now and do what presto_tpu does, a value or its
    error (a bare constant feature row or point cannot be fetched as one
    row in presto_tpu, IndexError)."""
    import presto_tpu
    from presto_tpu.catalog import Catalog as RCatalog

    def outcome(session):
        try:
            return ("rows", session.sql(sql).rows)
        except Exception as e:  # the reference's error is the record
            return ("error", type(e).__name__, str(e))

    mine = outcome(presto_tpu_torch.connect(Catalog(), device="cpu"))
    theirs = outcome(presto_tpu.connect(RCatalog()))
    assert module in sql
    assert mine == theirs


def test_str2_product_bound_raises_as_in_the_reference():
    cat = Catalog()
    words = np.asarray([f"w{i}" for i in range(600)], dtype=object)
    cat.register(MemoryTable("w", {"a": T.VARCHAR, "b": T.VARCHAR},
                             {"a": words, "b": words[::-1].copy()}))
    s = presto_tpu_torch.connect(cat, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="levenshtein_distance over non-dictionary"):
        s.sql("SELECT levenshtein_distance(a, b) FROM w")
    assert X.STR2_PRODUCT_MAX == 1 << 18
