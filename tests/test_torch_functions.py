"""The 65 scalar names this slice adds to presto_tpu_torch's
functions/scalar.py, against presto_tpu on the CPU: strings, regular
expressions, math, bitwise, dates and JSON.

Both packages read one memory table made from seeded numpy columns with
NULLs, empty and non-ASCII strings, negatives, zero, NaN and +-inf,
dates at month ends and on 29 February, and timestamps before and after
the epoch.  Each probe groups several names in one SELECT and runs in
`execution_mode` "dynamic" and "auto"; rows (NaN equal to NaN, floats
within rtol 1e-9, every other value and its Python type exactly), the
seven counters of QueryStats, the execution mode and the memo entry must
equal presto_tpu's.  Shift counts 0, 63, 64, 65 and negative ones are
held against presto_tpu, where torch leaves them undefined.  Each
probe's static pass reads nothing back to the host and stores no Python
scalar into a tensor.  Names outside the slice still raise
NotImplementedError naming themselves.
"""

import numpy as np
import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu import types as RT
from presto_tpu.catalog import Catalog as RCatalog
from presto_tpu_torch import types as T
from presto_tpu_torch.catalog import Catalog
from presto_tpu_torch.functions import scalar as S
from tests.test_torch_compiled import _memo_state
from tests.test_torch_tpch import counters
from tests.torch_functions_common import (assert_rows_equal,
                                          static_pass_builds)
from tests.torch_threads import torch_one_thread  # noqa: F401

MODES = ("dynamic", "auto")

#: the names this slice ports, in the groups of presto_tpu's scalar.py
SCALAR_NAMES = (
    # strings
    "lower", "trim", "ltrim", "rtrim", "reverse", "replace", "length",
    "strpos", "starts_with", "ends_with", "lpad", "rpad", "repeat",
    "split_part", "position", "codepoint", "contains_str", "chr",
    # regular expressions
    "regexp_like", "regexp_extract", "regexp_replace",
    # math
    "sqrt", "exp", "ln", "log10", "log", "floor", "ceil", "ceiling", "sign",
    "power", "pow", "truncate", "atan2", "pi", "e", "width_bucket",
    "greatest", "least",
    # bitwise
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_left_shift",
    "bitwise_right_shift", "bitwise_not",
    # dates
    "date", "date_add", "date_diff", "date_trunc", "last_day_of_month",
    "day_of_week", "day_of_year", "week_of_year", "dow", "doy", "week",
    "from_unixtime", "to_unixtime",
    # JSON
    "json_extract", "json_extract_scalar", "json_format", "json_parse",
    "json_array_length", "json_size", "is_json_scalar")

N = 160
WORDS = ["apple pie", "", " padded ", "héllo wörld", "x-y-z", "a$b\\c",
         "日本語", "Mixed-Case", "green-blue-red", "ab"]
JSON_TEXTS = ['{"a": {"b": [1, 2.0, true]}, "c": null}', "[1, 2, 3]", "null",
              '"s"', "not json", '{"x": 1.5, "y": [[]]}', "{}", "[]",
              '{"a": {"b": "deep"}}', "4e2"]
VALID_JSON = ['{"k": [3, 4], "m": {"n": false}}', "[1, [2, 3]]", "17",
              '"text"', "null", '{"z": 1e3}']
DATE_TEXTS = ["2000-02-29", "1999-12-31", " 2024-01-01 ", "1969-07-20"]
DAYS = [11016, 11017, 10956, 10957, 0, -1, -365, 12477, 12478, 19782, 19783,
        -719528, 47541]  # 29 Feb 2000, month and year ends, the epoch, ...
SCHEMA = {"id": "BIGINT", "i": "BIGINT", "n": "BIGINT", "x": "DOUBLE",
          "s": "VARCHAR", "j": "VARCHAR", "jv": "VARCHAR", "ds": "VARCHAR",
          "d": "DATE", "ts": "TIMESTAMP"}


def _columns():
    rng = np.random.default_rng(7)
    i = rng.integers(-10**6, 10**6, N)
    i[:6] = [0, -1, 1, (1 << 62) + 5, -(1 << 62) - 3, 255]
    n = rng.integers(-3, 70, N)
    n[:8] = [0, 63, 64, 65, -1, -64, 1, 2]
    x = rng.normal(0, 300, N)
    x[:9] = [float("nan"), float("inf"), float("-inf"), 0.0, -0.0, 2.5, -2.5,
             1e-300, 123456.789]
    d = rng.integers(-3000, 20000, N)
    d[:len(DAYS)] = DAYS
    ts = rng.integers(-10**15, 2 * 10**15, N)
    ts[:3] = [0, -1, 86_400_000_000 * 11016 + 3_600_000_001]

    def pick(values, null_share):
        v = np.array(values, dtype=object)[rng.integers(0, len(values), N)]
        return np.ma.masked_array(v, rng.random(N) < null_share)

    def nulls(a, share):
        mask = rng.random(N) < share
        mask[:len(DAYS)] = False
        return np.ma.masked_array(a, mask)

    return {"id": np.arange(N, dtype=np.int64),
            "i": nulls(i.astype(np.int64), 0.1),
            "n": nulls(n.astype(np.int64), 0.1),
            "x": nulls(x, 0.1),
            "s": pick(WORDS, 0.1),
            "j": pick(JSON_TEXTS, 0.1),
            "jv": pick(VALID_JSON, 0.0),
            "ds": pick(DATE_TEXTS, 0.0),
            "d": nulls(d.astype(np.int32), 0.1),
            "ts": nulls(ts.astype(np.int64), 0.1)}


PROBES = {
    "strings_case_and_trim": (
        "SELECT id, lower(s), trim(s), ltrim(s), rtrim(s), reverse(s), "
        "replace(s, '-', '+'), replace(s, 'l'), length(s), "
        "upper(lower(s)), length('日本語') FROM t ORDER BY id"),
    "strings_search": (
        "SELECT id, strpos(s, 'l'), position(s, '-'), starts_with(s, 'a'), "
        "ends_with(s, 'd'), contains_str(s, 'een'), codepoint(s), chr(233), "
        "codepoint('Ω'), starts_with('abc', 'ab') FROM t ORDER BY id"),
    "strings_pad_and_split": (
        "SELECT id, lpad(s, 8, '*.'), rpad(s, 4), lpad(s, 0), "
        "rpad(s, 12, 'é'), repeat(s, 2), repeat(s, 0), "
        "split_part(s, '-', 1), split_part(s, '-', 3), "
        "split_part(s, '-', 5), lpad('x', 3, 'ab') FROM t ORDER BY id"),
    "strings_in_keys_and_filters": (
        "SELECT lower(s), split_part(s, '-', 2), count(*), "
        "sum(length(s)) FROM t WHERE strpos(s, 'e') > 0 OR s = '' "
        "GROUP BY lower(s), split_part(s, '-', 2) ORDER BY 1, 2"),
    "regexp": (
        "SELECT id, regexp_like(s, '[a-z]-[a-z]'), regexp_like(s, '^$'), "
        "regexp_extract(s, '[a-z]+'), "
        "regexp_extract(s, '([a-z]+)-([a-z]+)', 2), "
        "regexp_replace(s, '([a-z])-', '$1+'), regexp_replace(s, 'l'), "
        "regexp_replace(s, 'a', '\\\\$') FROM t ORDER BY id"),
    "regexp_in_filter": (
        "SELECT count(*), count_if(regexp_like(s, 'o')) FROM t "
        "WHERE regexp_like(s, '[^ ]+ [^ ]+') OR length(s) < 3"),
    "math_unary": (
        "SELECT id, sqrt(x), exp(x), ln(x), log10(x), log(2, x), "
        "floor(x), ceil(x), ceiling(x), floor(i), ceil(i), sqrt(i), "
        "ln(i), sqrt(2), floor(-2.5), ceil(n) FROM t ORDER BY id"),
    "math_sign_power_truncate": (
        "SELECT id, sign(x), sign(i), sign(-0.0), power(x, 2), "
        "power(x, 0.5), pow(2, n), pow(i, n), truncate(x), truncate(x, 2), "
        "truncate(x, -1), truncate(i), atan2(x, i), atan2(1, 2), pi(), e() "
        "FROM t ORDER BY id"),
    "math_buckets_and_folds": (
        "SELECT id, width_bucket(x, -100, 100, 8), "
        "width_bucket(i, 0, 1000000, 4), width_bucket(2.5, 0, 10, 4), "
        "greatest(x, 1.0), greatest(i, n, 5), least(x, 0.0), least(i, n), "
        "greatest(d, DATE '2000-01-01'), least(3, 7), greatest(x, x, -1.5) "
        "FROM t ORDER BY id"),
    "bitwise": (
        "SELECT id, bitwise_and(i, n), bitwise_or(i, 12), "
        "bitwise_xor(i, n), bitwise_not(i), bitwise_left_shift(i, n), "
        "bitwise_right_shift(i, n), bitwise_left_shift(1, n), "
        "bitwise_right_shift(-1, n), bitwise_left_shift(i, 64), "
        "bitwise_right_shift(i, 63), bitwise_right_shift(i, -2), "
        "bitwise_and(5, 3), bitwise_not(0), bitwise_right_shift(-8, 1), "
        "bitwise_left_shift(3, 70) FROM t ORDER BY id"),
    "dates_add_and_diff": (
        "SELECT id, date_add('day', n, d), date_add('week', -2, d), "
        "date_add('month', n, d), date_add('year', 1, d), "
        "date_add('MONTH', 1, DATE '2000-01-31'), "
        "date_diff('day', d, DATE '2000-02-29'), "
        "date_diff('week', d, DATE '2000-02-29'), "
        "date_diff('month', d, DATE '2000-02-29'), "
        "date_diff('quarter', DATE '2000-02-29', d), "
        "date_diff('year', d, DATE '2024-02-29'), "
        "date_diff('hour', ts, TIMESTAMP '2001-01-01 00:00:00'), "
        "date_diff('second', TIMESTAMP '1969-12-31 23:59:59', ts), "
        "date_diff('day', ts, TIMESTAMP '2030-06-15 12:00:00') "
        "FROM t ORDER BY id"),
    "dates_trunc_and_fields": (
        "SELECT id, date_trunc('day', d), date_trunc('week', d), "
        "date_trunc('month', d), date_trunc('quarter', d), "
        "date_trunc('YEAR', d), date_trunc('hour', ts), "
        "date_trunc('minute', ts), date_trunc('second', ts), "
        "date_trunc('month', ts), last_day_of_month(d), "
        "last_day_of_month(ts), day_of_week(d), dow(ts), day_of_year(d), "
        "doy(ts), week_of_year(d), week(ts), "
        "last_day_of_month(DATE '2100-02-10') FROM t ORDER BY id"),
    "dates_text_and_unixtime": (
        "SELECT id, date(ds), date('2020-02-29'), from_unixtime(x), "
        "from_unixtime(i), to_unixtime(ts), "
        "to_unixtime(TIMESTAMP '1970-01-02 00:00:01'), "
        "from_unixtime(1.5) FROM t ORDER BY id"),
    "dates_in_keys": (
        "SELECT date_trunc('month', d) m, week(d), count(*), "
        "max(date_add('day', 1, d)) FROM t WHERE d IS NOT NULL "
        "GROUP BY date_trunc('month', d), week(d) ORDER BY 1, 2"),
    "json_paths": (
        "SELECT id, json_extract(j, '$.a.b'), json_extract(j, '$.a'), "
        "json_extract_scalar(j, '$.a.b[1]'), "
        "json_extract_scalar(j, '$.a.b[2]'), json_extract_scalar(j, '$.x'), "
        "json_extract_scalar(j, '$[0]'), json_array_length(j), "
        "json_size(j, '$.a'), json_size(j, '$'), is_json_scalar(j) "
        "FROM t ORDER BY id"),
    "json_parse_and_format": (
        "SELECT id, json_format(json_parse(jv)), json_parse(jv), "
        "json_extract(json_parse(jv), '$.k'), "
        "json_array_length(json_parse(jv)), "
        "json_extract_scalar(json_parse(jv), '$.m.n'), "
        "is_json_scalar(json_parse(jv)), json_format(json_parse('[1, 2]')) "
        "FROM t ORDER BY id"),
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
    assert_rows_equal(mine.rows, theirs.rows)
    assert counters(mine.stats) == counters(theirs.stats)
    assert mine.stats.execution_mode == theirs.stats.execution_mode
    assert _memo_state(port, sql) == _memo_state(ref, sql)


def test_every_name_is_registered_and_probed():
    probed = " ".join(PROBES.values())
    for name in SCALAR_NAMES:
        assert name in S.REGISTRY, name
        assert f"{name}(" in probed, name
    assert len(SCALAR_NAMES) == len(set(SCALAR_NAMES)) == 65


@pytest.mark.parametrize("name", sorted(PROBES))
def test_static_pass_reads_nothing_back(name):
    """The probe's static pass (what compiled mode captures on a card)
    with every host read and every Python scalar store made to raise:
    the dictionary tables reach the device through batch.upload, and the
    shifts and conversions build their constants on the device."""
    result, built = static_pass_builds(PROBES[name], _catalogs()[0])
    assert result.stats.execution_mode == "compiled" and len(built) == 1


#: names of presto_tpu's functions (and aggregates) that the port left
#: out when this slice landed; PORTED_SINCE's (datetime_tz.py, the
#: sketch states, the host aggregates, geospatial.py and ml.py) came
#: with a later slice and now give presto_tpu's rows, or raise its error
#: (st_geometryfromtext over a column builds an int32 table of parsed
#: tuples in presto_tpu, a ValueError)
LEFT_OUT = {
    "st_point": "SELECT st_point(x, x) FROM t",
    "st_geometryfromtext": "SELECT st_geometryfromtext(s) FROM t",
    "features": "SELECT features(x, x) FROM t",
    "evaluate_classifier_predictions": (
        "SELECT evaluate_classifier_predictions(s, s) FROM t"),
    "map_union_sum": ("SELECT map_union_sum(h) FROM "
                      "(SELECT histogram(s) AS h FROM t)"),
    "at_timezone": "SELECT at_timezone(ts, 'UTC') FROM t",
    "reduce_agg": ("SELECT reduce_agg(i, 0, (a, b) -> a + b, "
                   "(a, b) -> a + b) FROM t"),
    "approx_most_frequent": "SELECT approx_most_frequent(3, s, 100) FROM t",
    "approx_set": "SELECT approx_set(i) FROM t",
    "min_by": "SELECT min_by(i, x, 2) FROM t",
}


PORTED_SINCE = {"map_union_sum", "at_timezone", "reduce_agg",
                "approx_most_frequent", "approx_set", "min_by",
                "st_point", "st_geometryfromtext", "features",
                "evaluate_classifier_predictions"}


def _outcome(session, sql):
    """(rows with array values as tuples, the execution mode), or the
    error's type and text."""
    try:
        r = session.sql(sql)
    except Exception as e:  # the reference's error is the record
        return ("error", type(e).__name__, str(e))
    return ([tuple(tuple(v.tolist()) if isinstance(v, np.ndarray) else v
                   for v in row) for row in r.rows],
            r.stats.execution_mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(LEFT_OUT))
def test_names_left_out_raise(name, mode, sessions):
    if name in PORTED_SINCE:
        mine = _outcome(sessions["port", mode], LEFT_OUT[name])
        theirs = _outcome(sessions["ref", mode], LEFT_OUT[name])
        if theirs[0] == "error":
            assert mine == theirs
            return
        assert_rows_equal(mine[0], theirs[0])
        assert mine[1] == theirs[1]
        return
    session = presto_tpu_torch.connect(_catalogs()[0], device="cpu",
                                       execution_mode=mode)
    with pytest.raises(NotImplementedError, match=name):
        session.sql(LEFT_OUT[name])


def test_chr_of_a_column_raises_as_in_the_reference(sessions):
    sql = "SELECT chr(n) FROM t"
    with pytest.raises(NotImplementedError, match="chr of non-constant"):
        sessions["ref", "dynamic"].sql(sql)
    with pytest.raises(NotImplementedError, match="chr of non-constant"):
        sessions["port", "dynamic"].sql(sql)
