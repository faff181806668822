"""The scalar names of presto_tpu/functions/scalar_ext.py and
scalar_ext2.py in presto_tpu_torch, against presto_tpu on the CPU; the
probes over the table's columns, betainc, the DECIMAL math and the
registry's coverage are tests/test_torch_functions_ext_probes.py's.

Every SQL case of the scalar tests in tests/test_functions_ext.py and of
tests/test_functions_ext2.py (but now(), which waits for
functions/datetime_tz.py) runs through both packages on the same
MemoryTable `vals` (seed 11, n = 500, as those tests build it), in
`execution_mode` "dynamic" and "auto".  Rows must be equal: integers, BOOLEAN,
VARCHAR and VARBINARY values exactly (VARBINARY as Python bytes),
doubles within rtol 1e-9, except where a case states a wider bound:

- the regularized incomplete beta (beta_cdf, f_cdf, binomial_cdf and
  their inverses): the port's continued fraction stops at a fixed count
  where jax's loop stops at convergence of the whole batch, and torch's
  lgamma is not XLA's: rtol 1e-12 against jax.scipy.special.betainc and
  scipy.special.betainc over a seeded grid with both tails, 1e-9 through
  SQL;
- cbrt: a pow and one Newton step against XLA's cbrt, 4 ulps.

The execution mode, QueryStats' seven counters and the memo entry must
be presto_tpu's too.
"""

import numpy as np
import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu import types as RT
from presto_tpu.catalog import Catalog as RCatalog, MemoryTable as RMemoryTable
from presto_tpu_torch import types as T
from presto_tpu_torch.catalog import Catalog, MemoryTable
from tests.test_torch_compiled import _memo_state
from tests.test_torch_tpch import counters
from tests.torch_functions_common import assert_rows_equal
from tests.torch_threads import torch_one_thread  # noqa: F401

MODES = ("dynamic", "auto")
N = 500
SCHEMA = {"g": "BIGINT", "x": "DOUBLE", "y": "DOUBLE", "i": "BIGINT",
          "c": "BIGINT"}


def _columns():
    rng = np.random.default_rng(11)
    return {"g": rng.integers(0, 4, N), "x": rng.normal(3.0, 2.0, N),
            "y": rng.normal(-1.0, 1.5, N), "i": rng.integers(-1000, 1000, N),
            "c": rng.integers(1, 50, N)}


def _catalogs():
    cols = _columns()
    port, ref = Catalog(), RCatalog()
    port.register(MemoryTable(
        "vals", {c: T.parse_type(t) for c, t in SCHEMA.items()}, cols))
    ref.register(RMemoryTable(
        "vals", {c: RT.parse_type(t) for c, t in SCHEMA.items()}, cols))
    return port, ref


@pytest.fixture(scope="module")
def sessions():
    port, ref = _catalogs()
    return {(pkg, mode): lib.connect(cat, execution_mode=mode, **kw)
            for pkg, lib, cat, kw in (
                ("port", presto_tpu_torch, port, {"device": "cpu"}),
                ("ref", presto_tpu, ref, {}))
            for mode in MODES}


_U = "'https://user@example.com:8443/a/b?x=1&y=2#frag'"
_TS = "TIMESTAMP '2026-07-31 13:45:12'"

#: tests/test_functions_ext.py's scalar cases (:56-251)
EXT_CASES = [
    # math
    "SELECT sin(0.7)", "SELECT atan(1.0)", "SELECT tanh(0.3)",
    "SELECT cbrt(27.0)", "SELECT degrees(pi())", "SELECT radians(180.0)",
    "SELECT log2(8.0)",
    *[f"SELECT mod({a}, {b})" for a, b in ((10, 3), (-10, 3), (10, -3),
                                          (-10, -3))],
    "SELECT mod(10.5, 3.0)",
    "SELECT is_nan(nan())", "SELECT is_finite(1.0)",
    "SELECT is_infinite(infinity())",
    "SELECT bit_count(7, 64)", "SELECT bit_count(-1, 64)",
    "SELECT bitwise_logical_shift_right(-1, 60)",
    "SELECT bitwise_arithmetic_shift_right(-16, 2)",
    "SELECT normal_cdf(0, 1, 1.96)", "SELECT inverse_normal_cdf(0, 1, 0.975)",
    "SELECT cauchy_cdf(0, 1, 0)", "SELECT logistic_cdf(0, 1, 0)",
    "SELECT laplace_cdf(0, 1, 0)", "SELECT weibull_cdf(1, 1, 1)",
    "SELECT chi_squared_cdf(2, 3.0)", "SELECT beta_cdf(1, 1, 0.3)",
    "SELECT to_base(255, 16)", "SELECT to_base(-10, 2)",
    "SELECT from_base('ff', 16)", "SELECT from_base('-1010', 2)",
    # strings and regular expressions
    "SELECT levenshtein_distance('kitten', 'sitting')",
    "SELECT hamming_distance('karolin', 'kathrin')",
    "SELECT jaccard_index('abc', 'bcd')",
    "SELECT translate('abcd', 'bd', 'x')", "SELECT soundex('Robert')",
    "SELECT normalize('Amélie')", "SELECT concat_ws('-', 'a', 'b', 'c')",
    "SELECT regexp_count('1a2b3c', '[0-9]')",
    "SELECT regexp_position('abc123', '[0-9]')",
    "SELECT regexp_extract_all('1a2b3', '[0-9]')",
    "SELECT regexp_split('a1b22c', '[0-9]+')",
    # binary and hashes
    "SELECT to_hex(to_utf8('ab'))", "SELECT from_utf8(from_hex('6162'))",
    "SELECT to_base64(to_utf8('presto'))",
    "SELECT from_utf8(from_base64('cHJlc3Rv'))",
    "SELECT crc32(to_utf8('presto'))", "SELECT md5(to_utf8('abc'))",
    "SELECT sha256(to_utf8('abc'))",
    "SELECT hmac_sha256(to_utf8('msg'), to_utf8('key'))",
    "SELECT to_hex(xxhash64(to_utf8('')))",
    "SELECT to_big_endian_64(258)",
    "SELECT from_big_endian_64(to_big_endian_64(-7))",
    "SELECT from_ieee754_64(to_ieee754_64(2.5))",
    # URL
    *[f"SELECT url_extract_{p}({_U})" for p in (
        "protocol", "host", "port", "path", "query", "fragment")],
    f"SELECT url_extract_parameter({_U}, 'y')",
    "SELECT url_encode('a b&c')", "SELECT url_decode('a+b%26c')",
    # dates (timezone_hour waits for functions/datetime_tz.py)
    f"SELECT hour({_TS})", f"SELECT minute({_TS})", f"SELECT second({_TS})",
    "SELECT day_of_week(DATE '2026-07-31')",
    "SELECT day_of_month(DATE '2026-07-31')",
    "SELECT day_of_year(DATE '2026-02-01')",
    "SELECT week_of_year(DATE '2016-01-01')",
    "SELECT year_of_week(DATE '2016-01-01')",
    "SELECT yow(DATE '2026-07-31')",
    "SELECT date_format(TIMESTAMP '2026-07-31 09:05:00', '%Y-%m-%d %H:%i')",
    "SELECT format_datetime(DATE '2026-07-31', 'yyyy/MM/dd')",
    "SELECT date_parse('2026-07-31', '%Y-%m-%d')",
    "SELECT day(date_parse('31/07/2026', '%d/%m/%Y'))",
    "SELECT from_iso8601_date('2026-07-31') = DATE '2026-07-31'",
    "SELECT to_iso8601(DATE '2026-07-31')",
    "SELECT day(to_date('2026-07-31', 'yyyy-MM-dd'))",
    "SELECT to_milliseconds(parse_duration('1.5s'))",
    "SELECT to_milliseconds(parse_duration('42ms'))",
    # JSON, arrays, misc
    "SELECT json_array_get('[1, 2, 3]', 1)",
    "SELECT json_array_get('[1, 2, 3]', -1)",
    "SELECT json_array_contains('[1, 2, 3]', 2)",
    "SELECT json_array_contains('[1, 2]', 5)",
    "SELECT array_sum(ARRAY[1, 2, 3])",
    "SELECT array_average(ARRAY[1.0, 2.0, 4.0])",
    "SELECT array_duplicates(ARRAY[1, 2, 1, 3, 3])",
    "SELECT array_has_duplicates(ARRAY[1, 2, 1])",
    "SELECT typeof(1.0)", "SELECT typeof('x')",
]

_INV = [
    ("beta_cdf(2.0, 5.0, {v})", "inverse_beta_cdf(2.0, 5.0, {p})", 0.3),
    ("chi_squared_cdf(3.0, {v})", "inverse_chi_squared_cdf(3.0, {p})", 0.95),
    ("gamma_cdf(2.0, 2.0, {v})", "inverse_gamma_cdf(2.0, 2.0, {p})", 0.5),
    ("f_cdf(5.0, 2.0, {v})", "inverse_f_cdf(5.0, 2.0, {p})", 0.7),
    ("laplace_cdf(1.0, 2.0, {v})", "inverse_laplace_cdf(1.0, 2.0, {p})",
     0.25),
    ("logistic_cdf(0.0, 1.0, {v})", "inverse_logistic_cdf(0.0, 1.0, {p})",
     0.75),
    ("weibull_cdf(1.5, 1.0, {v})", "inverse_weibull_cdf(1.5, 1.0, {p})",
     0.5),
]

#: tests/test_functions_ext2.py's deterministic cases
EXT2_CASES = [
    "SELECT typeof(random(10))",
    *[f"SELECT {inv.format(p=p)}" for _, inv, p in _INV],
    "SELECT inverse_chi_squared_cdf(3.0, 0.95)",
    "SELECT inverse_logistic_cdf(0.0, 1.0, 0.75)",
    "SELECT inverse_laplace_cdf(0.0, 1.0, 0.25)",
    "SELECT inverse_poisson_cdf(3.0, 0.5)",
    "SELECT inverse_binomial_cdf(20, 0.5, 0.5)",
    "SELECT inverse_poisson_cdf(10.0, 0.9)",
    "SELECT poisson_cdf(10.0, 13), poisson_cdf(10.0, 14)",
    "SELECT inverse_beta_cdf(2.0, 5.0, 1.5)",
    "SELECT cosine_similarity(MAP(ARRAY['a','b'], ARRAY[1.0,2.0]), "
    "MAP(ARRAY['a','b'], ARRAY[2.0,4.0]))",
    "SELECT cosine_similarity(MAP(ARRAY['a'], ARRAY[1.0]), "
    "MAP(ARRAY['b'], ARRAY[1.0]))",
    "SELECT strrpos('abcabc', 'b')", "SELECT strrpos('abcabc', 'b', 2)",
    "SELECT strrpos('abc', 'z')",
    "SELECT split_to_map('a=1,b=2', ',', '=')",
    "SELECT split_to_multimap('a=1,a=2,b=3', ',', '=')",
    "SELECT split_to_map('a=1,a=2', ',', '=')",
    *[f"SELECT word_stem('{w}')" for w in (
        "running", "ponies", "caresses", "relational", "hopeful", "sky")],
    "SELECT word_stem(x) FROM (VALUES ('flies'),('denied')) AS t(x)",
    "SELECT key_sampling_percent('some_key')",
    "SELECT color('red')", "SELECT color('#f00')", "SELECT rgb(16, 32, 48)",
    "SELECT render('hi', color('red'))", "SELECT render(true)",
    "SELECT render(false)", "SELECT bar(0.5, 10)",
    "SELECT array_frequency(ARRAY[1,1,2,NULL])",
    "SELECT array_cum_sum(ARRAY[1,2,3])",
    "SELECT array_cum_sum(ARRAY[1.5, 2.5])",
    "SELECT array_cum_sum(ARRAY[1, NULL, 2])",
    "SELECT array_normalize(ARRAY[3.0, 4.0], 2)",
    "SELECT array_normalize(ARRAY[0.0, 0.0], 2)",
    "SELECT array_sort_desc(ARRAY[1,3,2])",
    "SELECT array_sort_desc(ARRAY[1, NULL, 2])",
    "SELECT combinations(ARRAY[1,2,3], 2)",
    "SELECT ngrams(ARRAY['a','b','c'], 2)", "SELECT ngrams(ARRAY['a'], 3)",
    "SELECT zip(ARRAY[1,2], ARRAY['a','b','c'])",
    "SELECT map_remove_null_values(MAP(ARRAY['a','b'], ARRAY[1, NULL]))",
    "SELECT map_normalize(MAP(ARRAY['a','b'], ARRAY[1.0, 3.0]))",
    "SELECT map_subset(MAP(ARRAY['a','b'], ARRAY[1,2]), ARRAY['a','c'])",
    "SELECT multimap_from_entries(ARRAY[ROW('a',1), ROW('a',2), "
    "ROW('b',3)])",
    "SELECT map_zip_with(MAP(ARRAY['a','b'], ARRAY[1,2]), "
    "MAP(ARRAY['b','c'], ARRAY[10,20]), "
    "(k, v1, v2) -> coalesce(v1,0) + coalesce(v2,0))",
    "SELECT all_keys_match(MAP(ARRAY['a','ab'], ARRAY[1,2]), "
    "k -> length(k) >= 1)",
    "SELECT any_keys_match(MAP(ARRAY['a'], ARRAY[1]), k -> k = 'z')",
    "SELECT no_keys_match(MAP(ARRAY['a'], ARRAY[1]), k -> k = 'z')",
    "SELECT any_values_match(MAP(ARRAY['a','b'], ARRAY[1,2]), v -> v > 1)",
    "SELECT no_values_match(MAP(ARRAY['a'], ARRAY[1]), v -> v > 5)",
    "SELECT any_values_match(MAP(ARRAY['a','b'], ARRAY[1, NULL]), "
    "v -> v > 5)",
    "SELECT all_keys_match(MAP(ARRAY['a'], ARRAY[1]), k -> k > 'z')",
    "SELECT array_sort(ARRAY[3, 1, NULL, 2])",
    "SELECT array_sort(ARRAY[3, 2, 5, 1, 2], (x, y) -> y - x)",
    "SELECT array_sort(ARRAY['a', 'ccc', 'bb'], (x, y) -> "
    "IF(length(x) < length(y), -1, IF(length(x) > length(y), 1, 0)))",
    "SELECT regexp_replace('new york', '(\\w)(\\w*)', "
    "x -> upper(x[1]) || lower(x[2]))",
    "SELECT parse_presto_data_size('1kB')",
    "SELECT parse_presto_data_size('2.5GB')",
    "SELECT array_join(ARRAY[1, NULL, 2], ',')",
    "SELECT array_join(ARRAY[1, NULL, 2], ',', 'N/A')",
    "SELECT ARRAY[1,2] < ARRAY[1,3]", "SELECT ARRAY[2] < ARRAY[10]",
    "SELECT ARRAY[1,2] > ARRAY[1]", "SELECT ROW(1,'a') < ROW(2,'a')",
    "SELECT ROW(1,'b') >= ROW(1,'a')",
    "SELECT 1 IS DISTINCT FROM NULL", "SELECT NULL IS NOT DISTINCT FROM NULL",
    "SELECT 1 IS DISTINCT FROM 1", "SELECT 'a' IS NOT DISTINCT FROM 'a'",
    "SELECT x IS DISTINCT FROM y FROM (VALUES (1, 1), (1, NULL), "
    "(CAST(NULL AS INTEGER), NULL)) AS t(x, y)",
    "SELECT count(*) FROM (VALUES (1),(2)) t(x) WHERE x IS DISTINCT FROM 1",
]

def _run_both(sessions, sql, mode):
    port, ref = sessions["port", mode], sessions["ref", mode]
    return port, ref, port.sql(sql), ref.sql(sql)


def _assert_like_reference(sessions, sql, mode, rtol=1e-9):
    port, ref, mine, theirs = _run_both(sessions, sql, mode)
    assert_rows_equal(mine.rows, theirs.rows, rtol=rtol)
    assert counters(mine.stats) == counters(theirs.stats)
    assert mine.stats.execution_mode == theirs.stats.execution_mode
    assert _memo_state(port, sql) == _memo_state(ref, sql)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sql", EXT_CASES)
def test_ext_case_matches_reference(sql, mode, sessions):
    _assert_like_reference(sessions, sql, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sql", EXT2_CASES)
def test_ext2_case_matches_reference(sql, mode, sessions):
    _assert_like_reference(sessions, sql, mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fwd,inv,p", _INV)
def test_inverse_cdf_round_trip(fwd, inv, p, mode, sessions):
    """tests/test_functions_ext2.py's round trip, through the port."""
    s = sessions["port", mode]
    v = s.sql(f"SELECT {inv.format(p=p)}").rows[0][0]
    back = s.sql(f"SELECT {fwd.format(v=v)}").rows[0][0]
    assert back == pytest.approx(p, abs=1e-6)
