"""Scalar function registry: SQL-level signature resolution + torch emission.

Reference: presto_tpu/functions/scalar.py, with the modules it imports
at its end (the last registration of a name wins, as there).  This
module holds the core and imports functions/scalar_ext.py,
scalar_ext2.py, datetime_tz.py, geospatial.py and ml.py at its end, in
the reference's order.  329 names:
- arithmetic (add, sub, mul, div, mod, neg) over the numeric types
  (DECIMAL's through functions/decimals.py: short decimals as scaled
  int64, long ones as Int128 limbs), DATE and TIMESTAMP +- INTERVAL,
  the six comparisons (numeric, decimal across scales and temporal;
  strings against a literal, within one dictionary or across two;
  ARRAY and ROW values pairwise, scalar_ext2.py), IS [NOT] DISTINCT
  FROM, three-valued AND / OR / NOT, CASTs between the numeric types,
  DECIMAL included, from numbers, booleans, decimals and dates to
  VARCHAR and from VARCHAR to numbers, IS NULL, COALESCE, NULLIF, IF,
  CASE, LIKE;
- strings: SUBSTRING / SUBSTR, UPPER, LOWER, TRIM, LTRIM, RTRIM,
  REVERSE, REPLACE, LENGTH, STRPOS, POSITION, STARTS_WITH, ENDS_WITH,
  CONTAINS_STR, LPAD, RPAD, REPEAT, SPLIT_PART, CODEPOINT, CHR (of a
  constant), CONCAT and `||`; REGEXP_LIKE, REGEXP_EXTRACT and
  REGEXP_REPLACE (Python's re; `$n` group references; a lambda
  replacement in scalar_ext2.py); scalar_ext.py's distances, codecs,
  hashes, URL and regexp long tail and scalar_ext2.py's strrpos,
  split_to_map, word_stem and color functions;
- math: ABS, ROUND, TRUNCATE, FLOOR, CEIL / CEILING, SIGN and MOD
  (DECIMAL too: the SQL values, functions/decimals.py), SQRT, EXP, LN,
  LOG10, LOG(base, x), POWER / POW, ATAN2, PI, E, WIDTH_BUCKET,
  GREATEST, LEAST; bitwise AND, OR, XOR, NOT and the shifts;
  scalar_ext.py's trigonometric family, CDFs, bit_count and
  scalar_ext2.py's inverse CDFs and cosine_similarity;
- dates: the EXTRACT family (year, month, day, quarter, day of week,
  day of year, week), DATE(text), DATE_ADD, DATE_DIFF, DATE_TRUNC,
  LAST_DAY_OF_MONTH, DAY_OF_WEEK / DOW, DAY_OF_YEAR / DOY, WEEK_OF_YEAR
  / WEEK, FROM_UNIXTIME (one argument), TO_UNIXTIME; scalar_ext.py's
  zone-less fields, formats and parsers over DATE and TIMESTAMP;
- JSON over VARCHAR or JSON dictionaries: JSON_EXTRACT,
  JSON_EXTRACT_SCALAR, JSON_FORMAT, JSON_PARSE, JSON_ARRAY_LENGTH,
  JSON_SIZE, IS_JSON_SCALAR, and scalar_ext.py's json_array_get and
  json_array_contains;
- collections: ARRAY constructor, ELEMENT_AT, subscript, CARDINALITY,
  CONTAINS, ARRAY_MIN, ARRAY_MAX, ARRAY_POSITION, ARRAY_DISTINCT,
  SLICE, FLATTEN, ARRAY_REMOVE, ARRAY_UNION, ARRAY_INTERSECT,
  ARRAY_EXCEPT, ARRAYS_OVERLAP, SEQUENCE, SPLIT, ARRAY_SORT (NULLs
  last, and with a comparator lambda) and ARRAY_JOIN (with a NULL
  replacement) as scalar_ext2.py registers them last; the lambdas
  TRANSFORM, FILTER, ANY_MATCH, ALL_MATCH, NONE_MATCH, ZIP_WITH,
  REDUCE; MAP, MAP_KEYS, MAP_VALUES, MAP_ENTRIES, MAP_CONCAT,
  MAP_FROM_ENTRIES, MAP_FILTER, TRANSFORM_VALUES, TRANSFORM_KEYS; ROW
  and ROW_FIELD (field access by name on a CAST ROW); ARRAY || ARRAY;
  CASTs between two ARRAY, MAP or ROW types of one kind and CAST(NULL
  AS a collection); the array and map long tail of scalar_ext.py and
  scalar_ext2.py;
- the volatile functions random / rand, uuid and shuffle
  (scalar_ext2.py), which TABLESAMPLE reaches;
- time zones (functions/datetime_tz.py over tzdb.py): at_timezone,
  with_timezone, now, current_timestamp, current_date, current_time,
  localtime, localtimestamp, current_timezone, current_user,
  timezone_hour / timezone_minute, TO_UNIXTIME and FROM_UNIXTIME with
  a zone or an offset, the date functions over a TIMESTAMP WITH TIME
  ZONE (on its zone's wall clock), TIME fields, TIMESTAMP WITH TIME
  ZONE +- INTERVAL, and the CASTs among TIMESTAMP WITH TIME ZONE, TIME,
  TIME WITH TIME ZONE, TIMESTAMP, DATE and VARCHAR;
- sketches (functions/sketches.py, tdigest.py): CARDINALITY of an HLL,
  P4HLL or QDIGEST, EMPTY_APPROX_SET, VALUE_AT_QUANTILE,
  VALUES_AT_QUANTILES, QUANTILE_AT_VALUE, SCALE_TDIGEST,
  DESTRUCTURE_TDIGEST, and the CASTs of a sketch to and from VARBINARY
  (its bytes) and VARCHAR (base64);
- geospatial (functions/geospatial.py): ST_Point, ST_GeometryFromText,
  ST_AsText, ST_X, ST_Y, ST_Contains, ST_Within, ST_Distance,
  ST_Intersects, ST_Area, ST_Envelope, ST_Centroid, ST_NPoints,
  ST_Length (a point column as an (n, 2) float64 tensor, a geometry as
  a parsed host tuple);
- ML (functions/ml.py): FEATURES, CLASSIFY, REGRESS over the model
  blobs of the learn_* aggregates.
Not ported: the $hll_reg and $hll_rho of distributed approx_distinct.
The planner resolves only
registered names, so any other function raises NotImplementedError
with its name (plan/planner.py `_call`).

String and collection functions are host transforms over the dictionary
(one Python call per dictionary entry, never per row), kept beside the
dictionary (`Dictionary.derived`), followed by one lookup on the device
through `batch.upload`: a string result is a new sorted dictionary and
a code table, a collection one a tuple dictionary in the reference's
canonical order (`_tuple_dict_normalize`) and a code table, a BOOLEAN
one a predicate table, a numeric one a value table.  A lambda's body
runs once over the flattened elements of every dictionary entry
(`LambdaVal.apply`).  Where the reference's static program reads device
values on the host (a lambda's results, the codes that `map`,
`map_concat`, `zip_with` and ARRAY || ARRAY pair row by row, a
constant computed on the device), its trace fails and "auto" falls
back; the port's static pass raises StaticFallback at the same places
(`colval.refuse_host_read`).

Null semantics as in the reference: strict null propagation, except
AND/OR/IS NULL/COALESCE/NULLIF/IF/CASE, which implement SQL
three-valued logic, and integer `mod`, whose result is NULL for a zero
divisor.  Where torch and XLA differ, the reference's values are kept:
shift counts outside [0, 63] give 0, float -> int conversions give 0
for NaN and saturate, sign keeps -0.0 and NaN, log10 is ln(x) times
(1 / ln(10)) rounded.  No tensor is divided by a host number: on a
card torch divides through the reciprocal, one ulp off at times, so a
host operand becomes a 0-d tensor first (decimals.true_div).
"""

from __future__ import annotations

import base64
import binascii
import datetime
import functools
import itertools
import json
import math
import operator
import re
import struct
from typing import Callable, Dict, Optional

import numpy as np
import torch

from presto_tpu_torch import session_ctx
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Dictionary, upload
from presto_tpu_torch.functions import decimals as DEC
from presto_tpu_torch.exec.colval import (ColVal, LambdaVal, all_valid,
                                          in_static_pass, refuse_host_read,
                                          translate_codes)

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def torch_dtype(t: T.Type) -> torch.dtype:
    """The torch dtype of a type's physical representation (the reference's
    numpy dtype; strings are int32 dictionary codes)."""
    if t.is_string:
        return torch.int32
    dt = _TORCH_DTYPES.get(t.numpy_dtype())
    if dt is None:
        raise NotImplementedError(f"type {t} is not ported")
    return dt


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def device_int64(x) -> torch.Tensor:
    """A value as an int64 tensor: a Python scalar as a 0-d tensor on
    the session's device.  Where the reference computes with jnp on a
    constant, its value is a device array that its static trace cannot
    read back (a CAST to VARCHAR falls back there); the port keeps such
    values on the device too, so that both pick the same mode."""
    if _is_tensor(x):
        return x.to(torch.int64)
    return torch.full((), int(x), dtype=torch.int64,
                      device=session_ctx.device())


def _where(cond, a, b):
    """torch.where over a tensor condition, else a python select."""
    if _is_tensor(cond):
        return torch.where(cond, a, b)
    return a if cond else b


# ---------------------------------------------------------------------------
# calendar math (Howard Hinnant's civil-days algorithms; `//` is floor
# division on python ints and torch tensors alike)
# ---------------------------------------------------------------------------


def civil_from_days(z):
    z = z + 719468
    era = z // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = _where(mp < 10, mp + 3, mp - 9)
    y = _where(m <= 2, y + 1, y)
    return y, m, d


def days_from_civil(y, m, d):
    y = _where(m <= 2, y - 1, y)
    era = y // 400
    yoe = y - era * 400
    mp = _where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


_DIM = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def days_in_month(y, m):
    leap = ((y % 4 == 0) & (y % 100 != 0)) | (y % 400 == 0)
    if _is_tensor(m):
        dim = upload(np.asarray(_DIM, dtype=np.int64), m.device)[m - 1]
    else:
        dim = _DIM[m - 1]
    return _where((m == 2) & leap, 29, dim)


def add_months(days, months):
    """DATE (days since epoch) plus whole months, clamping the day of
    month (reference: presto_tpu/functions/scalar.py add_months)."""
    if _is_tensor(days):
        days = days.to(torch.int64)
    y, m, d = civil_from_days(days)
    mm = (y * 12 + (m - 1)) + months
    y2 = mm // 12
    m2 = mm - y2 * 12 + 1
    dim = days_in_month(y2, m2)
    d2 = torch.minimum(d, dim) if _is_tensor(d) or _is_tensor(dim) \
        else min(d, dim)
    out = days_from_civil(y2, m2, d2)
    return out.to(torch.int32) if _is_tensor(out) else int(out)


# ---------------------------------------------------------------------------
# function registry
# ---------------------------------------------------------------------------


class ScalarFn:
    def __init__(self, name: str, resolve: Callable, emit: Callable):
        self.name = name
        self.resolve = resolve  # (arg_types) -> Type | None
        self.emit = emit  # (args: List[ColVal]) -> ColVal


REGISTRY: Dict[str, ScalarFn] = {}


def register(name: str, resolve: Callable, emit: Callable) -> None:
    REGISTRY[name] = ScalarFn(name, resolve, emit)


def lookup(name: str) -> ScalarFn:
    fn = REGISTRY.get(name)
    if fn is None:
        raise NotImplementedError(
            f"function {name} is not ported to presto_tpu_torch")
    return fn


# ---- arithmetic -----------------------------------------------------------

_TEMPORAL = ("DATE", "TIMESTAMP", "TIMESTAMP_TZ", "TIME")
_INTERVALS = ("INTERVAL_DAY_TIME", "INTERVAL_YEAR_MONTH")
_US_PER_DAY = 86_400_000_000


def _resolve_arith(name):
    def resolve(args):
        if len(args) != 2:
            return None
        a, b = args
        # date/timestamp +- interval
        if name in ("add", "sub") and a.name in _TEMPORAL \
                and b.name in _INTERVALS:
            if a.name == "TIME" and b.name == "INTERVAL_YEAR_MONTH":
                return None
            return a
        if name == "add" and a.name in _INTERVALS \
                and b.name in ("DATE", "TIMESTAMP", "TIMESTAMP_TZ"):
            return b
        if a.is_numeric and b.is_numeric:
            ct = T.common_super_type(a, b)
            if ct is not None and ct.is_decimal:
                if name == "div":
                    return T.DOUBLE  # decimal division promotes
                return DEC.decimal_result_type(name, a, b)
            return ct
        return None

    return resolve


def _date_plus_interval(name, a: ColVal, b: ColVal, valid) -> ColVal:
    if a.type.name == "TIMESTAMP":
        return _timestamp_plus_interval(name, a, b, valid)
    if a.type.name == "TIMESTAMP_TZ":
        return _tstz_plus_interval(name, a, b, valid)
    if a.type.name == "TIME":  # a day-time interval, modulo one day
        r = _timestamp_plus_interval(name, a, b, valid)
        return ColVal(r.data % _US_PER_DAY, valid, T.TIME)
    x = a.data.to(torch.int64) if _is_tensor(a.data) else int(a.data)
    if b.type.name == "INTERVAL_DAY_TIME":
        delta = b.data if name == "add" else -b.data  # micros
        # whole result days (reference: joda plus + toDate)
        days = (x * _US_PER_DAY + delta) // _US_PER_DAY
        return ColVal(days.to(torch.int32) if _is_tensor(days) else int(days),
                      valid, T.DATE)
    months = b.data if name == "add" else -b.data
    return ColVal(add_months(x, months), valid, T.DATE)


def _timestamp_plus_interval(name, a: ColVal, b: ColVal, valid) -> ColVal:
    """TIMESTAMP +- INTERVAL: micros added for a day-time interval; for a
    year-month one the date part moves by months (add_months) and the
    time of day stays."""
    x = device_int64(a.data)  # on the device, as the reference's jnp is
    delta = b.data if name == "add" else -b.data
    if b.type.name == "INTERVAL_DAY_TIME":
        return ColVal(x + delta, valid, T.TIMESTAMP)
    days = x // _US_PER_DAY
    moved = add_months(days, delta).to(torch.int64)
    return ColVal(moved * _US_PER_DAY + (x - days * _US_PER_DAY), valid,
                  T.TIMESTAMP)


def _tstz_plus_interval(name, a: ColVal, b: ColVal, valid) -> ColVal:
    """TIMESTAMP WITH TIME ZONE +- INTERVAL: a day-time interval adds
    micros to the instant (reference DateTimeOperators: fixed millis,
    across a DST change too); a year-month one moves the wall clock's
    date (functions/datetime_tz.py) and resolves it in the zone again."""
    from presto_tpu_torch.functions import datetime_tz as DTZ

    if b.type.name == "INTERVAL_DAY_TIME":
        r = _timestamp_plus_interval(name, a, b, valid)
    else:
        r = DTZ._delocalize(
            _timestamp_plus_interval(name, DTZ._localize(a), b, valid),
            a.type.tz or "UTC")
    return ColVal(r.data, valid, a.type)


def _emit_arith(name):
    def emit(args):
        a, b = args
        valid = all_valid(a, b)
        if a.type.name in _INTERVALS and b.type.name in _TEMPORAL:
            a, b = b, a  # interval + temporal commutes (add only)
        if b.type.name in _INTERVALS and a.type.name in _TEMPORAL:
            return _date_plus_interval(name, a, b, valid)
        out_t = T.common_super_type(a.type, b.type)
        if out_t is not None and out_t.is_decimal:
            if name != "div":
                return DEC.emit_decimal_arith(
                    name, a, b, DEC.decimal_result_type(name, a.type, b.type),
                    valid)
            x, y = (DEC.decimal_to_double(v).data for v in (a, b))
            return ColVal(DEC.true_div(x, y), valid, T.DOUBLE)
        x, y = DEC.jax_float_promote(a.data, b.data)
        if name == "add":
            r = x + y
        elif name == "sub":
            r = x - y
        elif name == "mul":
            r = x * y
        elif name == "div":
            if out_t.is_integer:
                r = _int_div(x, y)
            else:
                # in jnp's result dtype: f32 under float32_compute
                r = DEC.true_div(x, y)
        else:
            raise AssertionError(name)
        return ColVal(r, valid, out_t)

    return emit


def _on_tensors(fn):
    """Run a binary integer tensor function on a python scalar operand
    too (as a tensor of the other operand's dtype and device), or on two
    python scalars (as int64 CPU tensors, returning a python int), so
    that columns and folded literals follow the same rules."""
    def run(x, y):
        if not (_is_tensor(x) or _is_tensor(y)):
            return fn(torch.tensor(x, dtype=torch.int64),
                      torch.tensor(y, dtype=torch.int64)).item()
        ref = x if _is_tensor(x) else y
        x, y = (v if _is_tensor(v) else torch.full(
            (), v, dtype=ref.dtype, device=ref.device) for v in (x, y))
        return fn(x, y)

    return run


def _xla_div_rem(a: torch.Tensor, b: torch.Tensor):
    """Integer division and remainder as XLA defines them, which the
    reference's values follow: truncating, a / 0 == -1 and a % 0 == a,
    MIN / -1 == MIN and MIN % -1 == 0.  torch raises (CPU) or returns
    undefined values (CUDA) for a zero divisor, and MIN / -1 traps on
    x86, so both divide by a safe divisor and select afterwards."""
    zero, neg1 = b == 0, b == -1
    safe = torch.where(zero | neg1, torch.ones_like(b), b)
    q = torch.div(a, safe, rounding_mode="trunc")
    r = torch.fmod(a, safe)
    q = torch.where(zero, torch.full_like(q, -1), torch.where(neg1, -a, q))
    r = torch.where(zero, a, torch.where(neg1, torch.zeros_like(r), r))
    return q, r


@_on_tensors
def _int_div(x, y):
    """SQL integer division truncating toward zero, on the reference's
    formula: floor(|x| / |y|) with the sign flipped when the signs
    differ (presto_tpu/functions/scalar.py _emit_arith).  A zero divisor
    does not raise: x / 0 is -2 for x != 0 before the sign flip, and
    0 / 0 is -1 (XLA's division by zero under jnp.floor_divide)."""
    ax, ay = x.abs(), y.abs()
    q, r = _xla_div_rem(ax, ay)
    floor = (torch.sign(ax) != torch.sign(ay)) & (r != 0)
    q = torch.where(floor, q - 1, q)
    return torch.where((x < 0) ^ (y < 0), -q, q)


@_on_tensors
def _int_mod(x, y):
    """Truncated integer remainder (the sign of x) from a floor modulo
    by a divisor with 0 replaced (presto_tpu/functions/scalar_ext.py
    _emit_mod); the caller makes a zero divisor's row NULL."""
    # x % 1 == x % -1 == 0, and -1 would trap on MIN
    safe = torch.where((y == 0) | (y == -1), torch.ones_like(y), y)
    r = torch.remainder(x, safe)
    return torch.where((r != 0) & ((r < 0) != (x < 0)), r - safe, r)


def _resolve_mod(args):
    if len(args) == 2 and all(a.is_numeric for a in args):
        if any(a.is_decimal for a in args) \
                and not any(a.is_floating for a in args):
            return DEC.mod_result_type(*args)
        if all(a.is_integer for a in args):
            return T.common_super_type(*args)
        return T.DOUBLE
    return None


def _emit_mod(args):
    a, b = args
    t = _resolve_mod([a.type, b.type])
    if t.is_decimal:
        return DEC.emit_mod(a, b)
    a, b = DEC.decimal_to_double(a), DEC.decimal_to_double(b)
    x, y = a.data, b.data
    if not t.is_integer:
        if _is_tensor(x) or _is_tensor(y):
            r = torch.fmod(torch.as_tensor(x, dtype=torch.float64),
                           torch.as_tensor(y, dtype=torch.float64))
        else:
            r = float(np.fmod(float(x), float(y)))
        return ColVal(r, all_valid(a, b), T.DOUBLE)
    r = _int_mod(x, y)
    if _is_tensor(r):
        r = r.to(torch_dtype(t))
    return ColVal(r, all_valid(a, b, y != 0), t)


for _n in ("add", "sub", "mul", "div"):
    register(_n, _resolve_arith(_n), _emit_arith(_n))
register("mod", _resolve_mod, _emit_mod)

register("neg",
         lambda args: args[0] if len(args) == 1 and args[0].is_numeric
         else None,
         lambda args: DEC.emit_neg(args[0]))


# ---- comparisons ----------------------------------------------------------

_PYOPS = {
    "eq": operator.eq,
    "ne": operator.ne,
    "lt": operator.lt,
    "le": operator.le,
    "gt": operator.gt,
    "ge": operator.ge,
}


def _resolve_cmp(args):
    if len(args) != 2:
        return None
    a, b = args
    if T.common_super_type(a, b) is not None or a == b:
        return T.BOOLEAN
    return None


def _gather_lut(col: ColVal, lut: np.ndarray) -> torch.Tensor:
    """lut[code] for each of a string column's codes, as one lookup on
    the device."""
    n = len(col.dictionary)
    if n == 0:
        return torch.zeros_like(col.data, dtype=torch.from_numpy(lut).dtype)
    return upload(lut, col.data.device)[col.data.clamp(0, n - 1).long()]


def _dictionary_lut(col: ColVal, fn) -> torch.Tensor:
    """Evaluate a predicate once per dictionary entry on the host, then
    gather it through the codes on the device."""
    return _gather_lut(col, np.fromiter(
        (bool(fn(v)) for v in col.dictionary.values), bool,
        len(col.dictionary)))


def _string_compare(op: str, a: ColVal, b: ColVal) -> ColVal:
    valid = all_valid(a, b)
    pyop = _PYOPS[op]
    sa = a.data if isinstance(a.data, str) else None
    sb = b.data if isinstance(b.data, str) else None
    if sa is not None and sb is not None:
        return ColVal(pyop(sa, sb), valid, T.BOOLEAN)
    if sb is not None:  # column OP literal -> per-entry host eval
        return ColVal(_dictionary_lut(a, lambda v: pyop(v, sb)), valid,
                      T.BOOLEAN)
    if sa is not None:
        return ColVal(_dictionary_lut(b, lambda v: pyop(sa, v)), valid,
                      T.BOOLEAN)
    if a.dictionary is b.dictionary:
        # codes are order-isomorphic within one sorted dictionary
        return ColVal(pyop(a.data, b.data), valid, T.BOOLEAN)
    if op in ("eq", "ne"):
        # a's codes in b's dictionary (-1: absent, equal to nothing)
        ta = _recode(a, b.dictionary).data
        eq = (ta == b.data) & (ta >= 0)
        return ColVal(eq if op == "eq" else ~eq, valid, T.BOOLEAN)
    # an order across dictionaries: both recoded into the merged one
    a, b = _unify_dictionaries(a, b)
    return ColVal(pyop(a.data, b.data), valid, T.BOOLEAN)


def _emit_cmp(name):
    def emit(args):
        a, b = args
        if a.type.is_string or b.type.is_string:
            return _string_compare(name, a, b)
        if DEC.is_long(a.type) or DEC.is_long(b.type):
            return DEC.emit_long_compare(name, a, b, _PYOPS[name],
                                         all_valid(a, b))
        return ColVal(_PYOPS[name](*DEC.jax_float_promote(a.data, b.data)),
                      all_valid(a, b), T.BOOLEAN)

    return emit


for _n in _PYOPS:
    register(_n, _resolve_cmp, _emit_cmp(_n))


# ---- boolean 3VL ----------------------------------------------------------


def _resolve_bool(args):
    return T.BOOLEAN if all(a.name in ("BOOLEAN", "UNKNOWN") for a in args) \
        else None


def _emit_and(args):
    a, b = args
    data = a.data & b.data
    if a.valid is None and b.valid is None:
        return ColVal(data, None, T.BOOLEAN)
    va = True if a.valid is None else a.valid
    vb = True if b.valid is None else b.valid
    # null unless the result is determined: false wins over null
    false_a = va & ~a.data if _is_tensor(a.data) else va & (not a.data)
    false_b = vb & ~b.data if _is_tensor(b.data) else vb & (not b.data)
    return ColVal(data, (va & vb) | false_a | false_b, T.BOOLEAN)


def _emit_or(args):
    a, b = args
    data = a.data | b.data
    if a.valid is None and b.valid is None:
        return ColVal(data, None, T.BOOLEAN)
    va = True if a.valid is None else a.valid
    vb = True if b.valid is None else b.valid
    true_a = va & a.data
    true_b = vb & b.data
    return ColVal(true_a | true_b, (va & vb) | true_a | true_b, T.BOOLEAN)


def _emit_not(args):
    v = args[0]
    data = ~v.data if _is_tensor(v.data) else not v.data
    return ColVal(data, v.valid, T.BOOLEAN)


register("and", _resolve_bool, _emit_and)
register("or", _resolve_bool, _emit_or)
register("not",
         lambda args: T.BOOLEAN if len(args) == 1
         and args[0].name in ("BOOLEAN", "UNKNOWN") else None,
         _emit_not)


# ---- null handling and conditionals ---------------------------------------


def _select(cond, x, y, t: T.Type):
    """cond ? x : y in t's physical dtype: a python select when cond is
    a python bool, else torch.where with python scalars made tensors on
    cond's device."""
    if not _is_tensor(cond):
        return x if cond else y
    dt = torch_dtype(t)

    def tensor(v):
        return v.to(dt) if _is_tensor(v) else torch.full(
            (), v, dtype=dt, device=cond.device)

    return torch.where(cond, tensor(x), tensor(y))


def _merge_valid(cond, a: ColVal, b: ColVal):
    if a.valid is None and b.valid is None:
        return None
    va = True if a.valid is None else a.valid
    vb = True if b.valid is None else b.valid
    if _is_tensor(cond) or _is_tensor(va) or _is_tensor(vb):
        dev = next(v.device for v in (cond, va, vb) if _is_tensor(v))

        def tensor(v):
            return v if _is_tensor(v) else torch.full(
                (), v, dtype=torch.bool, device=dev)

        return torch.where(tensor(cond), tensor(va), tensor(vb))
    return va if cond else vb


def _emit_is_null(args):
    v = args[0]
    if v.valid is None:
        return ColVal(False, None, T.BOOLEAN)
    return ColVal(~v.valid if _is_tensor(v.valid) else not v.valid, None,
                  T.BOOLEAN)


def _resolve_coalesce(args):
    t = args[0]
    for a in args[1:]:
        t = T.common_super_type(t, a) or t
    return t


def _emit_coalesce(args):
    out = args[-1]
    for v in reversed(args[:-1]):
        if v.valid is None:
            out = v
            continue
        if v.type.is_string or out.type.is_string:
            v, out = _unify_dictionaries(v, out)
        data = _select(v.valid, v.data, out.data, v.type)
        valid = None if out.valid is None else (v.valid | out.valid)
        out = ColVal(data, valid, v.type, v.dictionary)
    return out


def _emit_nullif(args):
    a, b = args
    eq = lookup("eq").emit([a, b])
    eq_true = eq.data if eq.valid is None else (eq.data & eq.valid)
    keep = ~eq_true if _is_tensor(eq_true) else not eq_true
    valid = keep if a.valid is None else (a.valid & keep)
    return ColVal(a.data, valid, a.type, a.dictionary)


def _literal_dictionary(v: ColVal) -> ColVal:
    """A string literal as code 0 of a one-entry dictionary."""
    if v.dictionary is not None or not isinstance(v.data, str):
        return v
    vals = np.empty(1, dtype=object)
    vals[0] = v.data
    return ColVal(0, v.valid, v.type, Dictionary(vals))


def _recode(v: ColVal, to: Dictionary) -> ColVal:
    """v's codes in dictionary `to` (-1 for an entry `to` lacks), the
    table reaching the device through `upload`."""
    lut = translate_codes(v.dictionary, to)
    hi = max(len(v.dictionary) - 1, 0)
    if _is_tensor(v.data):
        codes = upload(lut, v.data.device)[v.data.clamp(0, hi).long()]
    else:
        codes = int(lut[min(max(int(v.data), 0), hi)])
    return ColVal(codes, v.valid, v.type, to)


def _unify_dictionaries(a: ColVal, b: ColVal):
    """Two string values over one merged dictionary (a NULL arm without
    a dictionary takes the other arm's)."""
    a, b = _literal_dictionary(a), _literal_dictionary(b)
    if a.dictionary is None:
        return ColVal(0, a.valid, b.type, b.dictionary), b
    if b.dictionary is None:
        return a, ColVal(0, b.valid, a.type, a.dictionary)
    if a.dictionary is b.dictionary:
        return a, b
    merged = Dictionary(np.unique(np.concatenate(
        [a.dictionary.values, b.dictionary.values])))
    return _recode(a, merged), _recode(b, merged)


def _resolve_if(args):
    if len(args) == 3 and args[0].name == "BOOLEAN":
        return T.common_super_type(args[1], args[2])
    return None


def _emit_if(args):
    c, a, b = args
    cond = c.data if c.valid is None else (c.data & c.valid)
    if a.type.is_string or b.type.is_string:
        a, b = _unify_dictionaries(a, b)
    elif _is_collection(a.type) or _is_collection(b.type):
        a, b = _unify_tuple_dictionaries(a, b)
    t = a.type if a.type.name != "UNKNOWN" else b.type
    return ColVal(_select(cond, a.data, b.data, t), _merge_valid(cond, a, b),
                  t, a.dictionary)


def _resolve_case(args):
    # args: c1, v1, c2, v2, ..., [else]
    vals = [args[i] for i in range(1, len(args) - (len(args) % 2), 2)]
    if len(args) % 2 == 1:
        vals.append(args[-1])
    t = vals[0]
    for v in vals[1:]:
        t = T.common_super_type(t, v) or t
    return t


def _emit_case(args):
    has_else = len(args) % 2 == 1
    pairs = [(args[i], args[i + 1])
             for i in range(0, len(args) - (1 if has_else else 0), 2)]
    if has_else:
        out = args[-1]
    else:  # a NULL of the first arm's type
        v0 = pairs[0][1]
        lit = v0.type.is_string and v0.dictionary is None
        out = ColVal("" if lit else 0, False, v0.type, v0.dictionary)
    for c, v in reversed(pairs):
        out = _emit_if([c, v, out])
    return out


register("is_null", lambda args: T.BOOLEAN if len(args) == 1 else None,
         _emit_is_null)
register("coalesce", _resolve_coalesce, _emit_coalesce)
register("nullif", lambda args: args[0] if len(args) == 2 else None,
         _emit_nullif)
register("if", _resolve_if, _emit_if)
register("case", _resolve_case, _emit_case)


# ---- LIKE and string functions (host transforms over the dictionary) ------


def like_to_regex(pattern: str, escape: Optional[str] = None) -> str:
    out = []
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if escape and c == escape and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if c == "%":
            out.append(".*")
        elif c == "_":
            out.append(".")
        else:
            out.append(re.escape(c))
        i += 1
    return "^" + "".join(out) + "$"


def _like_lut(dictionary: Dictionary, pattern: str,
              escape: Optional[str]) -> np.ndarray:
    """LIKE over every entry of a dictionary, kept beside it for the
    next query over the same column (and a pattern repeated in one)."""
    def compute():
        rx = re.compile(like_to_regex(pattern, escape), re.DOTALL)
        return np.fromiter((rx.match(v) is not None
                            for v in dictionary.values), bool,
                           len(dictionary))

    return dictionary.derived(("like", pattern, escape), compute)


def _emit_like(args):
    col, pat = args[0], args[1]
    if not isinstance(pat.data, str):
        raise NotImplementedError("LIKE requires a literal pattern")
    esc = args[2].data if len(args) > 2 else None
    if isinstance(col.data, str):
        rx = re.compile(like_to_regex(pat.data, esc), re.DOTALL)
        return ColVal(rx.match(col.data) is not None, col.valid, T.BOOLEAN)
    return ColVal(_gather_lut(col, _like_lut(col.dictionary, pat.data, esc)),
                  col.valid, T.BOOLEAN)


register("like", lambda args: T.BOOLEAN if args[0].is_string else None,
         _emit_like)


def _transform_lut(dictionary: Dictionary, fn, extra: tuple):
    """fn over every entry of a dictionary, then the sorted, unique
    dictionary of the results and the code lookup into it (the
    reference's _host_string_transform with normalize_dictionary), kept
    beside the dictionary: TPC-H Q22 evaluates substring(c_phone, 1, 2)
    fifteen times a run."""
    def compute():
        vals = np.asarray([fn(v, *extra) for v in dictionary.values],
                          dtype=object)
        uniq, inverse = np.unique(vals.astype(str), return_inverse=True)
        return inverse.astype(np.int32), Dictionary(uniq)

    return dictionary.derived((fn, extra), compute)


def _value_lut(dictionary: Dictionary, fn, extra: tuple,
               out: T.Type) -> np.ndarray:
    """fn over every entry of a dictionary as a BOOLEAN predicate table
    or a numeric value table in out's dtype, kept beside the
    dictionary."""
    def compute():
        if out.name == "BOOLEAN":
            return np.fromiter((bool(fn(v, *extra))
                                for v in dictionary.values), bool,
                               len(dictionary))
        return np.asarray([fn(v, *extra) for v in dictionary.values],
                          dtype=out.numpy_dtype())

    return dictionary.derived(("value", fn, extra, out.name), compute)


def _constant(name: str, v: ColVal):
    """The python value of a constant argument."""
    if _is_tensor(v.data) and v.data.ndim > 0:
        raise NotImplementedError(
            f"{name} with non-constant arguments is not ported")
    return v.data.item() if _is_tensor(v.data) else v.data


def _str_transform(name, fn, out: T.Type = T.VARCHAR):
    """A function of a string and constant extra arguments, run once per
    dictionary entry on the host (reference: _str_transform): a VARCHAR
    or JSON result is a new dictionary and a code lookup, a BOOLEAN one
    a predicate table, a numeric one a value table, each gathered
    through the codes on the device."""
    def emit(args):
        col = args[0]
        extra = tuple(_constant(name, a) for a in args[1:])
        if isinstance(col.data, str):
            return ColVal(fn(col.data, *extra), col.valid, out)
        if out.is_string:
            lut, d = _transform_lut(col.dictionary, fn, extra)
            return ColVal(_gather_lut(col, lut), col.valid, out, d)
        return ColVal(_gather_lut(col, _value_lut(col.dictionary, fn,
                                                  extra, out)),
                      col.valid, out)

    return (lambda args: out if args[0].is_string else None), emit


def _substr(v, start, length=None):
    start = int(start)
    s = start - 1 if start > 0 else len(v) + start
    if length is None:
        return v[s:]
    return v[s:s + int(length)]


def _upper(v):
    return v.upper()


def _append(v, suffix):
    return v + suffix


def _prepend(v, prefix):
    return prefix + v


register("substring", *_str_transform("substring", _substr))
register("substr", *_str_transform("substr", _substr))
register("upper", *_str_transform("upper", _upper))

#: the most entries a dictionary-by-dictionary concat materializes (the
#: reference's cap)
CONCAT_PRODUCT_MAX = 1 << 20


def _concat_pair(a: ColVal, b: ColVal) -> ColVal:
    """a || b for two string values (reference: _emit_concat)."""
    valid = all_valid(a, b)
    la = a.data if isinstance(a.data, str) else None
    lb = b.data if isinstance(b.data, str) else None
    if la is not None and lb is not None:
        return ColVal(la + lb, valid, T.VARCHAR)
    if lb is not None:
        lut, out = _transform_lut(a.dictionary, _append, (lb,))
        return ColVal(_gather_lut(a, lut), valid, T.VARCHAR, out)
    if la is not None:
        lut, out = _transform_lut(b.dictionary, _prepend, (la,))
        return ColVal(_gather_lut(b, lut), valid, T.VARCHAR, out)
    if a.dictionary is None or b.dictionary is None:
        raise NotImplementedError("concat of non-dictionary string columns")
    na, nb = len(a.dictionary), len(b.dictionary)
    if na * nb > CONCAT_PRODUCT_MAX:
        raise NotImplementedError(
            "concat of string columns whose dictionary product "
            f"({na} x {nb}) exceeds the materialization cap")

    def product():
        # the value cross product, codes row-major, re-sorted so that
        # code order stays lexicographic order
        av = a.dictionary.values.astype(str)
        bv = b.dictionary.values.astype(str)
        prod = np.char.add(av[:, None], bv[None, :]).astype(object).ravel()
        uniq, inverse = np.unique(prod.astype(str), return_inverse=True)
        return inverse.astype(np.int32), Dictionary(uniq)

    # kept beside the left dictionary, keyed by the right one
    lut, out = a.dictionary.derived(("concat", b.dictionary), product)

    def clip(v, n):
        return v.clamp(0, n - 1).long() if _is_tensor(v) \
            else min(max(int(v), 0), n - 1)

    pair = clip(a.data, na) * nb + clip(b.data, nb)
    if _is_tensor(pair):
        codes = upload(lut, pair.device)[pair]
    else:
        codes = int(lut[pair])
    return ColVal(codes, valid, T.VARCHAR, out)


def _resolve_concat(args):
    if all(a.is_string for a in args):
        return T.VARCHAR
    if args and all(a.name == "ARRAY" for a in args):
        ct = args[0].params[0]
        for a in args[1:]:
            ct2 = T.common_super_type(ct, a.params[0])
            ct = ct2 if ct2 is not None else ct
        return T.array_of(ct)
    return None


def _emit_concat(args):
    if args and args[0].type.name == "ARRAY":
        return _emit_concat_arrays(args)
    out = args[0]
    for nxt in args[1:]:
        out = _concat_pair(out, nxt)
    return out


register("concat", _resolve_concat, _emit_concat)


# ---- EXTRACT and its shorthands --------------------------------------------


def _days_of(v: ColVal):
    """Days since the epoch of a DATE or TIMESTAMP value, as int64."""
    d = v.data
    if v.type.name == "TIMESTAMP":
        d = d // _US_PER_DAY
    return d.to(torch.int64) if _is_tensor(d) else int(d)


def _extract_emit(field):
    def emit(args):
        v = args[0]
        days = _days_of(v)
        y, m, d = civil_from_days(days)
        if field == "YEAR":
            r = y
        elif field == "MONTH":
            r = m
        elif field == "DAY":
            r = d
        elif field == "QUARTER":
            r = (m - 1) // 3 + 1
        elif field == "DOW":
            r = (days + 4) % 7  # 1970-01-01 = Thursday
        elif field == "DOY":
            r = days - days_from_civil(y, 1, 1) + 1
        else:  # WEEK
            r = (days - days_from_civil(y, 1, 1)) // 7 + 1
        return ColVal(r, v.valid, T.BIGINT)

    return emit


def _resolve_temporal(args):
    return T.BIGINT if args[0].is_temporal else None


for _f in ("YEAR", "MONTH", "DAY", "QUARTER", "DOW", "DOY", "WEEK"):
    register(f"extract_{_f.lower()}", _resolve_temporal, _extract_emit(_f))
for _f in ("YEAR", "MONTH", "DAY", "QUARTER"):
    register(_f.lower(), _resolve_temporal, _extract_emit(_f))


# ---- math -----------------------------------------------------------------


def _emit_abs(args):
    a = args[0]
    if a.type.is_decimal:
        return DEC.emit_abs(a)
    return ColVal(a.data.abs() if _is_tensor(a.data) else abs(a.data),
                  a.valid, a.type)


def _emit_round(args):
    """SQL round(x[, d]): half away from zero, sign(x) * floor(|x| *
    10^d + 0.5) / 10^d on the reference's formula (torch.round rounds
    half to even).  An integer argument comes back as it is."""
    a = args[0]
    if a.type.is_integer:
        return a
    d = int(args[1].data) if len(args) > 1 else 0
    if a.type.is_decimal:
        return DEC.emit_round(a, d)
    scale = 10.0 ** d
    x = a.data
    if _is_tensor(x):
        r = DEC.true_div(torch.sign(x) * torch.floor(x.abs() * scale + 0.5),
                         scale)
    else:
        x = float(x)
        r = float(np.sign(x) * np.floor(abs(x) * scale + 0.5) / scale)
    return ColVal(r, a.valid, a.type)


def _resolve_numeric1(args):
    return args[0] if args[0].is_numeric else None


register("abs",
         lambda args: _resolve_numeric1(args) if len(args) == 1 else None,
         _emit_abs)
register("round", _resolve_numeric1, _emit_round)


# ---- more string functions (host transforms over the dictionary) ----------


def _pad(v, n, p, left):
    n = int(n)
    if n < 0:
        raise ValueError(f"pad target length must be >= 0 (got {n})")
    p = str(p) or " "
    if len(v) >= n:
        return v[:n]
    fill = (p * ((n - len(v)) // len(p) + 1))[:n - len(v)]
    return fill + v if left else v + fill


def _lpad(v, n, p=" "):
    return _pad(v, n, p, True)


def _rpad(v, n, p=" "):
    return _pad(v, n, p, False)


def _split_part(v, delim, idx):
    parts = v.split(str(delim))
    i = int(idx)
    return parts[i - 1] if 1 <= i <= len(parts) else ""


def _find(v, sub):
    """1-based character position of sub in v, 0 when absent."""
    return v.find(str(sub)) + 1


for _n, _f, _t in (
        ("lower", lambda v: v.lower(), T.VARCHAR),
        ("trim", lambda v: v.strip(), T.VARCHAR),
        ("ltrim", lambda v: v.lstrip(), T.VARCHAR),
        ("rtrim", lambda v: v.rstrip(), T.VARCHAR),
        ("reverse", lambda v: v[::-1], T.VARCHAR),
        ("replace", lambda v, old, new="": v.replace(str(old), str(new)),
         T.VARCHAR),
        ("length", len, T.BIGINT),
        ("strpos", _find, T.BIGINT),
        ("position", _find, T.BIGINT),
        ("starts_with", lambda v, p: v.startswith(str(p)), T.BOOLEAN),
        ("ends_with", lambda v, p: v.endswith(str(p)), T.BOOLEAN),
        ("contains_str", lambda v, sub: str(sub) in v, T.BOOLEAN),
        ("lpad", _lpad, T.VARCHAR),
        ("rpad", _rpad, T.VARCHAR),
        ("repeat", lambda v, n: v * int(n), T.VARCHAR),
        ("split_part", _split_part, T.VARCHAR),
        ("codepoint", lambda v: ord(v[0]) if v else 0, T.BIGINT)):
    register(_n, *_str_transform(_n, _f, _t))


def _emit_chr(args):
    a = args[0]
    if _is_tensor(a.data) and a.data.ndim > 0:
        raise NotImplementedError("chr of non-constant")
    return ColVal(chr(int(_constant("chr", a))), a.valid, T.VARCHAR)


register("chr", lambda args: T.VARCHAR if args[0].is_integer else None,
         _emit_chr)


# ---- regular expressions (Python's re over the dictionary entries) --------


def _regexp_like(v, pattern):
    return re.search(str(pattern), v) is not None


def _regexp_extract(v, pattern, group=0):
    m = re.search(str(pattern), v)
    if m is None:
        return ""
    return m.group(int(group))


def _regexp_replace(v, pattern, repl=""):
    # $0..$9 are group references and every other character is literal:
    # backslashes are escaped first so that none forms a re escape
    py_repl = str(repl).replace("\\", "\\\\")
    py_repl = re.sub(r"\$(\d+)", r"\\g<\1>", py_repl)
    return re.sub(str(pattern), py_repl, v)


register("regexp_like",
         *_str_transform("regexp_like", _regexp_like, T.BOOLEAN))
register("regexp_extract",
         *_str_transform("regexp_extract", _regexp_extract))
register("regexp_replace",
         *_str_transform("regexp_replace", _regexp_replace))


# ---- JSON (JSON values ride VARCHAR or JSON dictionaries; path lookups are
# host transforms like the string functions) ----------------------------------


def _json_path_get(v, path):
    """The JsonPath subset $.a.b[0] of the reference (None where the
    document or the path does not parse, or nothing is there)."""
    try:
        doc = json.loads(v)
    except (ValueError, TypeError):
        return None
    p = str(path)
    if not p.startswith("$"):
        return None
    i = 1
    cur = doc
    while i < len(p) and cur is not None:
        if p[i] == ".":
            j = i + 1
            while j < len(p) and p[j] not in ".[":
                j += 1
            key = p[i + 1:j]
            cur = cur.get(key) if isinstance(cur, dict) else None
            i = j
        elif p[i] == "[":
            j = p.find("]", i)
            if j < 0:
                return None
            token = p[i + 1:j].strip("\"'")
            if isinstance(cur, list):
                try:
                    cur = cur[int(token)]
                except (ValueError, IndexError):
                    cur = None
            elif isinstance(cur, dict):
                cur = cur.get(token)
            else:
                cur = None
            i = j + 1
        else:
            return None
    return cur


def _json_compact(doc) -> str:
    return json.dumps(doc, separators=(",", ":"))


def _json_extract(v, path):
    r = _json_path_get(v, path)
    return "" if r is None else _json_compact(r)


def _json_extract_scalar(v, path):
    r = _json_path_get(v, path)
    if r is None or isinstance(r, (dict, list)):
        return ""
    if isinstance(r, bool):
        return "true" if r else "false"
    if isinstance(r, float) and math.isfinite(r) and r == int(r):
        return str(int(r))
    return str(r)


def _json_array_length(v):
    try:
        doc = json.loads(v)
    except (ValueError, TypeError):
        return 0
    return len(doc) if isinstance(doc, list) else 0


def _json_size(v, path):
    r = _json_path_get(v, path)
    return len(r) if isinstance(r, (dict, list)) else 0


def _is_json_scalar(v):
    try:
        doc = json.loads(v)
    except (ValueError, TypeError):
        return False
    return not isinstance(doc, (dict, list))  # JSON null is a scalar


def _json_canonical(v):
    """The document in compact form; text that is not JSON raises."""
    return _json_compact(json.loads(v))


for _n, _f, _t in (
        ("json_extract", _json_extract, T.VARCHAR),
        ("json_extract_scalar", _json_extract_scalar, T.VARCHAR),
        ("json_format", _json_canonical, T.VARCHAR),
        ("json_parse", _json_canonical, T.JSON),
        ("json_array_length", _json_array_length, T.BIGINT),
        ("json_size", _json_size, T.BIGINT),
        ("is_json_scalar", _is_json_scalar, T.BOOLEAN)):
    register(_n, *_str_transform(_n, _f, _t))


# ---- math -------------------------------------------------------------------


def _f64(x):
    """A value as float64: a tensor converted, a python number as
    np.float64 (whose math gives NaN and inf where python's raises)."""
    return x.to(torch.float64) if _is_tensor(x) else np.float64(x)


def _scalar(x):
    """A numpy scalar result back as a python number."""
    return x.item() if isinstance(x, np.generic) else x


def _f64_to_i64(x):
    """float64 -> int64 as XLA converts: truncating, NaN to 0, out of
    range saturating (torch leaves these undefined)."""
    if not _is_tensor(x):
        x = float(x)
        if math.isnan(x):
            return 0
        if x >= 2.0 ** 63:
            return I64_MAX
        return max(int(x), I64_MIN)
    big = x >= 2.0 ** 63
    safe = torch.where(torch.isnan(x) | big, 0.0, x.clamp_min(-2.0 ** 63))
    return torch.where(big, I64_MAX, safe.to(torch.int64))


I64_MAX = (1 << 63) - 1
I64_MIN = -(1 << 63)


def _double1(tfn, nfn):
    """numeric -> DOUBLE, elementwise."""
    def emit(args):
        x = _f64(args[0].data)
        if _is_tensor(x):
            return ColVal(tfn(x), args[0].valid, T.DOUBLE)
        with np.errstate(all="ignore"):
            return ColVal(float(nfn(x)), args[0].valid, T.DOUBLE)

    return (lambda args: T.DOUBLE if args[0].is_numeric else None), emit


register("sqrt", *_double1(torch.sqrt, np.sqrt))
register("exp", *_double1(torch.exp, np.exp))
register("ln", *_double1(torch.log, np.log))
# ln(x) times 1 / ln(10) rounded, as jnp.log10 computes it
_INV_LN10 = 0.4342944819032518
register("log10", *_double1(lambda x: torch.log(x) * _INV_LN10,
                            lambda x: np.log(x) * _INV_LN10))


def _same_type1(tfn, nfn, up):
    """numeric -> its own type; an integer argument comes back as it is
    (as jnp.floor and jnp.ceil leave integers), a decimal one is
    DEC.emit_floor_ceil's."""
    def emit(args):
        a = args[0]
        if a.type.is_integer:
            return a
        if a.type.is_decimal:
            return DEC.emit_floor_ceil(a, up)
        if _is_tensor(a.data):
            return ColVal(tfn(a.data), a.valid, a.type)
        with np.errstate(all="ignore"):
            return ColVal(float(nfn(np.float64(a.data))), a.valid, a.type)

    return (lambda args: args[0] if len(args) == 1 and args[0].is_numeric
            else None), emit


register("floor", *_same_type1(torch.floor, np.floor, False))
register("ceil", *_same_type1(torch.ceil, np.ceil, True))
register("ceiling", *_same_type1(torch.ceil, np.ceil, True))


def _emit_sign(args):
    """sign as XLA computes it: -1, 0 or 1 for integers; a float's sign
    as -1.0 or 1.0, a zero and NaN returned as they are (-0.0 stays)."""
    a = args[0]
    x = a.data
    if a.type.is_decimal:
        return DEC.emit_sign(a)
    if a.type.is_integer:
        r = torch.sign(x) if _is_tensor(x) else (x > 0) - (x < 0)
    elif _is_tensor(x):
        r = torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x)).to(x.dtype)
    else:
        x = float(x)
        r = x if x == 0 or x != x else (1.0 if x > 0 else -1.0)
    return ColVal(r, a.valid, a.type)


register("sign",
         lambda args: args[0] if len(args) == 1 and args[0].is_numeric
         else None,
         _emit_sign)


def _double2(tfn, nfn):
    """(numeric, numeric) -> DOUBLE, NULL where either is."""
    def emit(args):
        x, y = (_f64(a.data) for a in args)
        if _is_tensor(x) or _is_tensor(y):
            dev = (x if _is_tensor(x) else y).device
            x, y = (v if _is_tensor(v) else torch.full(
                (), float(v), dtype=torch.float64, device=dev) for v in (x, y))
            r = tfn(x, y)
        else:
            with np.errstate(all="ignore"):
                r = float(nfn(x, y))
        return ColVal(r, all_valid(*args), T.DOUBLE)

    return (lambda args: T.DOUBLE if len(args) == 2 else None), emit


register("power", *_double2(torch.pow, np.power))
register("pow", *_double2(torch.pow, np.power))
register("atan2", *_double2(torch.atan2, np.arctan2))
# log(base, value) = ln(value) / ln(base)
register("log", *_double2(lambda b, x: DEC.true_div(torch.log(x),
                                                     torch.log(b)),
                          lambda b, x: np.log(x) / np.log(b)))
register("pi", lambda args: T.DOUBLE if not args else None,
         lambda args: ColVal(float(np.pi), None, T.DOUBLE))
register("e", lambda args: T.DOUBLE if not args else None,
         lambda args: ColVal(float(np.e), None, T.DOUBLE))


def _emit_truncate(args):
    """truncate(x[, d]): toward zero at d decimal digits; an integer
    argument comes back as it is, a decimal keeps its scale."""
    a = args[0]
    if a.type.is_integer:
        return a
    d = int(_constant("truncate", args[1])) if len(args) > 1 else 0
    if a.type.is_decimal:
        return DEC.emit_truncate(a, d)
    scale = 10.0 ** d
    if _is_tensor(a.data):
        return ColVal(DEC.true_div(torch.trunc(a.data * scale), scale),
                      a.valid, a.type)
    return ColVal(float(np.trunc(float(a.data) * scale) / scale), a.valid,
                  a.type)


register("truncate", lambda args: args[0] if args[0].is_numeric else None,
         _emit_truncate)


def _emit_width_bucket(args):
    """width_bucket(x, lo, hi, n): floor((x - lo) / (hi - lo) * n) + 1
    clipped into [0, n + 1], NaN in bucket 0 (XLA's conversion)."""
    x = _f64(args[0].data)
    lo, hi, n = (a.data for a in args[1:])
    raw = DEC.true_div(x - lo, hi - lo) * n
    if _is_tensor(raw):
        r = (torch.floor(raw) + 1).clamp_min(0.0)
        r = torch.minimum(r, n.to(torch.float64) + 1) if _is_tensor(n) \
            else r.clamp_max(float(n) + 1)
    else:
        with np.errstate(all="ignore"):
            r = float(np.clip(np.floor(raw) + 1, 0.0, float(n) + 1))
    return ColVal(_f64_to_i64(r), all_valid(*args), T.BIGINT)


register("width_bucket", lambda args: T.BIGINT if len(args) == 4 else None,
         _emit_width_bucket)


def _fold(tfn, nfn):
    """greatest / least: the pairwise maximum or minimum, NaN winning,
    NULL where any argument is; typed as the first argument."""
    def emit(args):
        acc = args[0].data
        for a in args[1:]:
            x = a.data
            if _is_tensor(acc) or _is_tensor(x):
                dev = (acc if _is_tensor(acc) else x).device
                acc, x = (v if _is_tensor(v) else torch.full(
                    (), v, dtype=torch.float64 if isinstance(v, float)
                    else torch.int64, device=dev) for v in (acc, x))
                acc = tfn(acc, x)
            else:
                acc = _scalar(nfn(acc, x))
        return ColVal(acc, all_valid(*args), args[0].type)

    return emit


register("greatest", _resolve_coalesce, _fold(torch.maximum, np.maximum))
register("least", _resolve_coalesce, _fold(torch.minimum, np.minimum))


# ---- bitwise (BIGINT two's complement) --------------------------------------


def _i64(x):
    """An integer value as int64: a tensor converted, a python int
    wrapped into the signed 64-bit range."""
    if _is_tensor(x):
        return x.to(torch.int64)
    x = int(x) & ((1 << 64) - 1)
    return x - (1 << 64) if x >= 1 << 63 else x


def _int_tensors(x, y):
    """Two int64 operands as tensors on one device (a python one as a
    0-d tensor), when either is a tensor."""
    ref = x if _is_tensor(x) else y
    return tuple(v if _is_tensor(v) else torch.full(
        (), v, dtype=torch.int64, device=ref.device) for v in (x, y))


def _shift_left(x, s):
    """x << s as XLA shifts: 0 for a count outside [0, 63] (torch leaves
    such counts undefined)."""
    if not (_is_tensor(x) or _is_tensor(s)):
        return _i64(x << s) if 0 <= s < 64 else 0
    x, s = _int_tensors(x, s)
    return torch.where((s >= 0) & (s < 64), x << s.clamp(0, 63), 0)


def _shift_right_logical(x, s):
    """x >> s on the uint64 bits (Presto's bitwise_right_shift): 0 for a
    count outside [0, 63], a negative count being a huge unsigned one.
    torch's >> on int64 is arithmetic, so the copied sign bits are
    masked off."""
    if not (_is_tensor(x) or _is_tensor(s)):
        return _i64((x & ((1 << 64) - 1)) >> s) if 0 <= s < 64 else 0
    x, s = _int_tensors(x, s)
    sc = s.clamp(1, 63)
    r = torch.where(s == 0, x, (x >> sc) & ~(-1 << (64 - sc)))
    return torch.where((s >= 0) & (s < 64), r, 0)


def _bitwise2(fn):
    def emit(args):
        x, y = (_i64(a.data) for a in args)
        return ColVal(fn(x, y), all_valid(*args), T.BIGINT)

    return (lambda args: T.BIGINT if len(args) == 2
            and all(a.is_integer for a in args) else None), emit


def _wrap(op):
    def run(x, y):
        r = op(x, y)
        return r if _is_tensor(r) else _i64(r)

    return run


register("bitwise_and", *_bitwise2(_wrap(operator.and_)))
register("bitwise_or", *_bitwise2(_wrap(operator.or_)))
register("bitwise_xor", *_bitwise2(_wrap(operator.xor)))
register("bitwise_left_shift", *_bitwise2(_shift_left))
register("bitwise_right_shift", *_bitwise2(_shift_right_logical))
register("bitwise_not",
         lambda args: T.BIGINT if len(args) == 1 and args[0].is_integer
         else None,
         lambda args: ColVal(~_i64(args[0].data), args[0].valid, T.BIGINT))


# ---- dates ------------------------------------------------------------------


def _as_date(r):
    return r.to(torch.int32) if _is_tensor(r) else int(r)


def _to_days(s) -> int:
    return int((np.datetime64(str(s).strip(), "D")
                - np.datetime64("1970-01-01", "D")) / np.timedelta64(1, "D"))


register("date", *_str_transform("date", _to_days, T.DATE))


def _emit_date_add(args):
    """date_add(unit, n, date) for day, week, month and year."""
    unit = args[0].data if isinstance(args[0].data, str) else None
    n, d = args[1].data, args[2]
    x = _days_of(d)
    if _is_tensor(n) and not _is_tensor(x):
        x = torch.full_like(n, x, dtype=torch.int64)
    if unit in ("day", "DAY"):
        return ColVal(_as_date(x + n), d.valid, T.DATE)
    if unit in ("week", "WEEK"):
        return ColVal(_as_date(x + 7 * n), d.valid, T.DATE)
    if unit in ("month", "MONTH"):
        return ColVal(add_months(x, n), d.valid, T.DATE)
    if unit in ("year", "YEAR"):
        return ColVal(add_months(x, 12 * n), d.valid, T.DATE)
    raise NotImplementedError(f"date_add unit {unit}")


register("date_add",
         lambda args: T.DATE if len(args) == 3 and args[2].name == "DATE"
         else None,
         _emit_date_add)


def _sign(x):
    return torch.sign(x) if _is_tensor(x) else (x > 0) - (x < 0)


def _next_month_start(y, m):
    """Days since the epoch of the first day of the month after (y, m)."""
    return days_from_civil(_where(m == 12, y + 1, y),
                           _where(m == 12, 1, m + 1), 1)


def _month_length(y, m):
    return _next_month_start(y, m) - days_from_civil(y, m, 1)


def _minimum(a, b):
    if _is_tensor(a) or _is_tensor(b):
        return torch.minimum(torch.as_tensor(a), torch.as_tensor(b))
    return min(a, b)


def _emit_date_diff(args):
    """date_diff(unit, a, b): whole units from a to b; months, quarters
    and years count complete months only (the start day clamped to the
    end month's length)."""
    unit = args[0].data if isinstance(args[0].data, str) else None
    if unit is None:
        raise NotImplementedError("date_diff with non-constant unit")
    unit = unit.lower()
    a, b = args[1], args[2]
    da, db = _days_of(a), _days_of(b)
    if unit == "day":
        r = db - da
    elif unit == "week":
        r = (db - da) // 7
    elif unit in ("month", "quarter", "year"):
        ya, ma, dda = civil_from_days(da)
        yb, mb, ddb = civil_from_days(db)
        months = (yb - ya) * 12 + (mb - ma)
        fwd = ddb < _minimum(dda, _month_length(yb, mb))
        bwd = dda < _minimum(ddb, _month_length(ya, ma))
        months = months - ((months > 0) & fwd) * 1 + ((months < 0) & bwd) * 1
        k = {"month": 1, "quarter": 3, "year": 12}[unit]
        r = _sign(months) * (abs(months) // k)
    elif unit in ("hour", "minute", "second", "millisecond") and \
            a.type.name == "TIMESTAMP" and b.type.name == "TIMESTAMP":
        step = {"hour": 3_600_000_000, "minute": 60_000_000,
                "second": 1_000_000, "millisecond": 1_000}[unit]
        r = (b.data - a.data) // step
    else:
        raise NotImplementedError(f"date_diff({unit})")
    return ColVal(r.to(torch.int64) if _is_tensor(r) else int(r),
                  all_valid(a, b), T.BIGINT)


register("date_diff", lambda args: T.BIGINT if len(args) == 3 else None,
         _emit_date_diff)


def _emit_date_trunc(args):
    unit = args[0].data if isinstance(args[0].data, str) else None
    if unit is None:
        raise NotImplementedError("date_trunc with non-constant unit")
    unit = unit.lower()
    v = args[1]
    is_ts = v.type.name == "TIMESTAMP"
    days = _days_of(v)
    y, m, _ = civil_from_days(days)
    if unit == "day":
        r = days
    elif unit == "week":  # ISO weeks start on Monday
        r = days - (days + 3) % 7
    elif unit == "month":
        r = days_from_civil(y, m, 1)
    elif unit == "quarter":
        r = days_from_civil(y, ((m - 1) // 3) * 3 + 1, 1)
    elif unit == "year":
        r = days_from_civil(y, 1, 1)
    elif unit in ("hour", "minute", "second") and is_ts:
        step = {"hour": 3_600_000_000, "minute": 60_000_000,
                "second": 1_000_000}[unit]
        return ColVal(v.data // step * step, v.valid, v.type)
    else:
        raise NotImplementedError(f"date_trunc({unit}, {v.type})")
    if is_ts:
        return ColVal(r * _US_PER_DAY, v.valid, v.type)
    return ColVal(_as_date(r), v.valid, T.DATE)


register("date_trunc",
         lambda args: args[1] if len(args) == 2 and args[1].is_temporal
         else None,
         _emit_date_trunc)


def _emit_last_day_of_month(args):
    v = args[0]
    y, m, _ = civil_from_days(_days_of(v))
    return ColVal(_as_date(_next_month_start(y, m) - 1), v.valid, T.DATE)


register("last_day_of_month",
         lambda args: T.DATE if args[0].is_temporal else None,
         _emit_last_day_of_month)


def _iso_week(days):
    """ISO-8601 week number: the week holding this date's Thursday,
    counted within the Thursday's year."""
    thursday = days - (days + 3) % 7 + 3
    ty, _, _ = civil_from_days(thursday)
    return (thursday - days_from_civil(ty, 1, 1)) // 7 + 1


def _date_field(fn):
    return (lambda args: T.BIGINT if args and args[0].is_temporal else None,
            lambda args: ColVal(fn(_days_of(args[0])), args[0].valid,
                                T.BIGINT))


def _day_of_week(days):
    return (days + 3) % 7 + 1  # ISO: Monday 1 .. Sunday 7


def _day_of_year(days):
    return days - days_from_civil(civil_from_days(days)[0], 1, 1) + 1


for _names, _f in ((("day_of_week", "dow"), _day_of_week),
                   (("day_of_year", "doy"), _day_of_year),
                   (("week_of_year", "week"), _iso_week)):
    for _n in _names:
        register(_n, *_date_field(_f))


register("from_unixtime",
         lambda args: T.TIMESTAMP if args[0].is_numeric else None,
         lambda args: ColVal(_f64_to_i64(_f64(args[0].data) * 1e6),
                             args[0].valid, T.TIMESTAMP))
register("to_unixtime",
         lambda args: T.DOUBLE if args and args[0].name in (
             "TIMESTAMP", "TIMESTAMP_TZ") else None,
         lambda args: ColVal(DEC.true_div(_f64(args[0].data), 1e6),
                             args[0].valid, T.DOUBLE))


# ---- ARRAY, MAP and ROW values ---------------------------------------------
#
# Reference: presto_tpu/functions/scalar.py's ARRAY, lambda, MAP and ROW
# sections, with array_sort and array_join in the form
# presto_tpu/functions/scalar_ext2.py registers last.  A collection column
# is int32 codes into a host Dictionary of Python tuples (ARRAY: the
# elements; MAP: (key, value) pairs ordered by repr(key); ROW: the
# fields), in the canonical order of _tuple_dict_normalize.  Every
# function works once per dictionary entry on the host; its result
# reaches the device as one table looked up through the codes
# (`upload`).  A constant collection is code 0 (a Python int) of a
# one-entry dictionary.


def _is_array(t: T.Type) -> bool:
    return t.name == "ARRAY"


def _is_map(t: T.Type) -> bool:
    return t.name == "MAP"


def _is_collection(t: T.Type) -> bool:
    return t.name in ("ARRAY", "MAP", "ROW")


def _elem_type(t: T.Type) -> T.Type:
    return t.params[0] if t.params else T.UNKNOWN


def _is_function(t) -> bool:
    return t is not None and getattr(t, "name", None) == "FUNCTION"


def _fn_ret(t: T.Type) -> T.Type:
    return t.params[0]


def _host(v):
    """A Python value of an element: numpy scalars leave no trace in a
    tuple dictionary, whose canonical order reads repr()."""
    if isinstance(v, np.str_):
        return str(v)
    if isinstance(v, np.generic):
        return v.item()
    return v


def _lookup(codes, table: np.ndarray):
    """table[code]: one lookup on the device through `upload` for a code
    tensor, a host one (a Python value) for a constant code."""
    if len(table) == 0:  # an empty dictionary: every row is dead
        return torch.zeros_like(codes, dtype=torch.from_numpy(
            table).dtype) if _is_tensor(codes) else table.dtype.type(0).item()
    hi = len(table) - 1
    if _is_tensor(codes):
        return upload(table, codes.device)[codes.clamp(0, hi).long()]
    return table[min(max(int(codes), 0), hi)].item()


def _clip_codes(codes, n: int):
    hi = max(n - 1, 0)
    if _is_tensor(codes):
        return codes.clamp(0, hi)
    return min(max(int(codes), 0), hi)


def _and_not(valid, bad):
    """valid AND NOT bad, for tensors and Python bools alike."""
    ok = ~bad if _is_tensor(bad) else (not bad)
    if valid is None:
        return ok
    return valid & ok


def _tuple_cmp(a, b) -> int:
    """The reference's total order over dictionary tuples: elementwise
    lexicographic with prefix ordering, NULL elements last, nested tuples
    recursive, incomparable types by repr.  Code order is then semantic
    order, so ORDER BY, min and max read the codes."""
    for x, y in zip(a, b):
        if x is None and y is None:
            continue
        if x is None:
            return 1
        if y is None:
            return -1
        if isinstance(x, tuple) and isinstance(y, tuple):
            c = _tuple_cmp(x, y)
            if c:
                return c
            continue
        try:
            if x < y:
                return -1
            if y < x:
                return 1
        except TypeError:
            rx, ry = repr(x), repr(y)
            if rx != ry:
                return -1 if rx < ry else 1
    return (len(a) > len(b)) - (len(a) < len(b))


#: leaf types for which Python's own tuple order is _tuple_cmp's
#: (floats without NaN)
_NATIVE_ORDER = (str, int, float, bool)


def _natively_ordered(uniq: list) -> bool:
    """Whether Python's tuple order is _tuple_cmp's over these distinct
    tuples: at each nesting depth the elements are all tuples or all
    leaves of one type among _NATIVE_ORDER (no NULL, no NaN).  Then
    every comparison pairs two tuples or two leaves of one type, which
    both orders compare alike, and no two distinct entries compare
    equal."""
    level = uniq
    while True:
        flat = list(itertools.chain.from_iterable(level))
        kinds = set(map(type, flat))
        if len(kinds) != 1:
            return not kinds
        kind = kinds.pop()
        if kind is not tuple:
            return kind in _NATIVE_ORDER and not (
                kind is float and np.isnan(np.asarray(flat)).any())
        level = flat


def _canonical_order(uniq: list) -> list:
    """The reference's canonical order: a repr pre-sort (equal-comparing
    entries such as (1,) and (1.0,) in a fixed order), then a stable
    sort by _tuple_cmp.  Tuples that _natively_ordered admits sort the
    same under Python's own order, without a Python comparison per pair
    (split over p_name has 200,000 entries at SF1)."""
    if _natively_ordered(uniq):
        return sorted(uniq)
    return sorted(sorted(uniq, key=repr),
                  key=functools.cmp_to_key(_tuple_cmp))


def repr_order(uniq: list) -> list:
    """sorted(uniq, key=repr), the order of the reference's repr-keyed
    dictionaries (_tuples_to_dict_column, branch and union merges),
    without the repr of every whole tuple: the tuples sort first by the
    repr of their first element with the character that follows it in
    the tuple's repr (",", or ")" for the empty tuple), and only tuples
    that tie there by the whole repr.  Where one such key is a proper
    prefix of another, the whole repr decides everything."""
    def head(t):
        if not isinstance(t, tuple):
            return repr(t)
        return repr(t[0]) + "," if t else ")"

    keyed = sorted((head(t), i) for i, t in enumerate(uniq))
    heads = [k for k, _ in keyed]
    if any(b != a and b.startswith(a) for a, b in zip(heads, heads[1:])):
        return sorted(uniq, key=repr)
    out, lo = [], 0
    while lo < len(keyed):
        hi = lo + 1
        while hi < len(keyed) and heads[hi] == heads[lo]:
            hi += 1
        group = [uniq[i] for _, i in keyed[lo:hi]]
        out.extend(group if hi - lo == 1 else sorted(group, key=repr))
        lo = hi
    return out


def _tuple_dictionary(values) -> tuple:
    """(inverse codes, Dictionary) of host tuples in canonical order."""
    values = list(values)
    uniq = _canonical_order(list(set(values)))
    code_map = {v: i for i, v in enumerate(uniq)}
    inverse = np.fromiter((code_map[v] for v in values), np.int32,
                          len(values))
    u = np.empty(len(uniq), dtype=object)
    u[:] = uniq
    return inverse, Dictionary(u)


def _tuple_dict_normalize(values: np.ndarray, codes: ColVal,
                          out_type: T.Type) -> ColVal:
    """normalize_dictionary for tuple dictionaries (reference:
    _tuple_dict_normalize): the result of entry i is values[i]."""
    inverse, d = _tuple_dictionary(values.tolist())
    return ColVal(_lookup(codes.data, inverse), codes.valid, out_type, d)


def _string_dictionary(values: list) -> tuple:
    """(codes, Dictionary) of host strings: the sorted distinct values,
    as np.unique(np.asarray(values, dtype=object).astype(str)) gives
    them (numpy drops trailing NUL characters), through a Python dict
    rather than a sort of every value."""
    texts = [v.rstrip("\0") if v.endswith("\0") else v for v in
             (str(v) for v in values)]
    uniq = sorted(set(texts))
    index = {v: i for i, v in enumerate(uniq)}
    codes = np.fromiter((index[v] for v in texts), np.int32, len(texts))
    return codes, Dictionary(np.asarray(uniq, dtype=str)
                             if uniq else np.empty(0, dtype=str))


def _normalize_strings(values, codes: ColVal) -> ColVal:
    """normalize_dictionary for string results (reference:
    colval.normalize_dictionary): sorted unique values, codes through a
    table."""
    inverse, d = _string_dictionary(list(values))
    return ColVal(_lookup(codes.data, inverse), codes.valid, T.VARCHAR, d)


def _unify_tuple_dictionaries(a: ColVal, b: ColVal):
    """Two collection values over one dictionary (reference:
    _unify_tuple_dictionaries): a NULL arm takes the other arm's; two
    dictionaries merge into one ordered by repr, with code tables
    through `upload`."""
    if a.dictionary is None and b.dictionary is None:
        return a, b
    if a.dictionary is None:
        return ColVal(0, a.valid, b.type, b.dictionary), b
    if b.dictionary is None:
        return a, ColVal(0, b.valid, a.type, a.dictionary)
    if a.dictionary is b.dictionary:
        return a, b
    av, bv = a.dictionary.values.tolist(), b.dictionary.values.tolist()
    uniq = repr_order(list(set(av) | set(bv)))
    cmap = {v: i for i, v in enumerate(uniq)}
    u = np.empty(len(uniq), dtype=object)
    u[:] = uniq
    merged = Dictionary(u)
    la = np.fromiter((cmap[v] for v in av), np.int32, len(av))
    lb = np.fromiter((cmap[v] for v in bv), np.int32, len(bv))
    return (ColVal(_lookup(a.data, la), a.valid, a.type, merged),
            ColVal(_lookup(b.data, lb), b.valid, b.type, merged))


def _arr_entries(col: ColVal) -> np.ndarray:
    return col.dictionary.values if col.dictionary is not None \
        else np.empty(0, dtype=object)


def _const_arg(name: str, a: ColVal):
    """A constant extra argument as a Python value (a collection or
    string constant decoded from its dictionary)."""
    v = a.data
    if _is_tensor(v) and v.ndim > 0:
        raise NotImplementedError(f"{name} with non-constant arguments")
    if a.dictionary is not None:
        # the reference reads the code of a device-built constant
        refuse_host_read(name)
        return _host(a.dictionary.values[int(v)])
    if _is_tensor(v):
        refuse_host_read(name)
        return v.item()
    return _host(v)


_NULL_PLACEHOLDER = {"ARRAY": (), "VARCHAR": "", "BOOLEAN": False,
                     "BIGINT": 0, "INTEGER": 0, "DOUBLE": 0.0}


def _array_transform(name, fn, out_type=None):
    """A function of an array and constant arguments, once per entry (an
    entry whose call raises gives NULL, as in the reference).  out_type:
    None -> the array's own type (fn returns tuples); a Type -> that
    type; "elem" -> the element type.  The results, their dictionary and
    code table are kept beside the array's dictionary."""

    def resolve(args):
        if not _is_array(args[0]):
            return None
        if out_type is None:
            return args[0]
        if out_type == "elem":
            return _elem_type(args[0])
        return out_type

    def results(col: ColVal, extra: tuple) -> list:
        got = []
        for v in _arr_entries(col):
            try:
                got.append(fn(tuple(v), *extra))
            except (ValueError, IndexError, TypeError):
                got.append(None)
        return got

    def tables(col: ColVal, extra: tuple, rt: T.Type):
        got = results(col, extra)
        null = np.fromiter((r is None for r in got), bool, len(got))
        outs = np.empty(len(got), dtype=object)
        blank = _NULL_PLACEHOLDER.get(rt.name if rt is not None else "", 0)
        outs[:] = [blank if r is None else r for r in got]
        if rt is not None and rt.name == "ARRAY":
            return (*_tuple_dictionary(outs.tolist()), null)
        if rt is not None and rt.is_string:
            return (*_string_dictionary(outs.tolist()), null)
        return np.asarray(outs.tolist(), dtype=rt.numpy_dtype()), None, null

    def emit(args):
        col = args[0]
        extra = tuple(_const_arg(name, a) for a in args[1:])
        rt = resolve([a.type for a in args])
        if col.dictionary is None:
            lut, d, null = tables(col, extra, rt)
        else:
            lut, d, null = col.dictionary.derived(
                ("array_transform", name, extra, rt),
                lambda: tables(col, extra, rt))
        valid = col.valid
        if null.any():
            valid = _and_not(valid, _lookup(col.data, null))
        if rt is not None and rt.is_string:
            rt = T.VARCHAR
        return ColVal(_lookup(col.data, lut), valid, rt, d)

    return resolve, emit


def _resolve_array_ctor(args):
    if not args:
        return T.array_of(T.UNKNOWN)
    ct = args[0]
    for a in args[1:]:
        nxt = T.common_super_type(ct, a)
        if nxt is None:
            return None
        ct = nxt
    return T.array_of(ct)


def _scalar_is_null(a: ColVal) -> bool:
    v = a.valid
    if v is None:
        return False
    if _is_tensor(v):
        if v.ndim > 0:
            return False  # vector validity: not a scalar context
        refuse_host_read("a constructor")
    return not bool(v)


def _constant_element(a: ColVal, what: str):
    """The Python value of a constant constructor argument (None when
    NULL)."""
    if _is_tensor(a.data) and a.data.ndim > 0:
        raise NotImplementedError(
            f"{what}(...) over column values is not supported yet")
    if _scalar_is_null(a):
        return None
    v = a.data
    if _is_tensor(v) or a.dictionary is not None:
        # a device-built element (a nested array, a computed value): the
        # reference's static program reads it back
        refuse_host_read(f"{what}(...) of computed elements")
    if _is_tensor(v):
        v = v.item()
    if a.dictionary is not None:
        v = a.dictionary.values[int(v)]
    return _host(v)


def _one_entry(value: tuple, valid, t: T.Type) -> ColVal:
    d = np.empty(1, dtype=object)
    d[0] = value
    return ColVal(0, valid, t, Dictionary(d))


def _emit_array_ctor(args):
    vals = tuple(_constant_element(a, "ARRAY") for a in args)
    return _one_entry(vals, None,
                      _resolve_array_ctor([a.type for a in args]))


register("array_constructor", _resolve_array_ctor, _emit_array_ctor)


def _element_at(v, i):
    i = int(i)
    if i == 0:
        raise ValueError("SQL array indices are 1-based")
    if abs(i) > len(v):
        return None  # Presto: NULL beyond the array bounds
    return v[i - 1] if i > 0 else v[i]


def _array_sort(v):
    return tuple(sorted(e for e in v if e is not None)) \
        + tuple(e for e in v if e is None)  # NULLs last


def _fmt_join(e):
    if isinstance(e, bool):
        return "true" if e else "false"
    return str(e)


def _array_join(v, d, nr=None):
    parts = []
    for e in v:
        if e is None:
            if nr is not None:
                parts.append(str(nr))
        else:
            parts.append(_fmt_join(e))
    return str(d).join(parts)


def _contains(v, x):
    return any(e == x for e in v)


def _array_min(v):
    return min((e for e in v if e is not None), default=None)


def _array_max(v):
    return max((e for e in v if e is not None), default=None)


def _array_position(v, x):
    return next((i + 1 for i, e in enumerate(v) if e == x), 0)


def _array_distinct(v):
    return tuple(dict.fromkeys(v))


def _slice(v, start, length):
    return v[int(start) - 1:int(start) - 1 + int(length)]


def _flatten(v):
    return tuple(e for sub in v for e in (sub if sub is not None else ()))


def _array_remove(v, x):
    return tuple(e for e in v if e is None or e != x)


def _array_union(v, w):
    return tuple(dict.fromkeys(tuple(v) + tuple(w)))


def _array_intersect(v, w):
    return tuple(dict.fromkeys(e for e in v if e in set(w)))


def _array_except(v, w):
    return tuple(dict.fromkeys(e for e in v if e not in set(w)))


def _arrays_overlap(v, w):
    return any(e in set(w) for e in v if e is not None)


register("contains", *_array_transform("contains", _contains, T.BOOLEAN))
register("array_min", *_array_transform("array_min", _array_min, "elem"))
register("array_max", *_array_transform("array_max", _array_max, "elem"))
register("array_position",
         *_array_transform("array_position", _array_position, T.BIGINT))
register("array_distinct",
         *_array_transform("array_distinct", _array_distinct))
register("slice", *_array_transform("slice", _slice))
register("flatten", *_array_transform("flatten", _flatten, "elem"))
register("array_remove", *_array_transform("array_remove", _array_remove))
register("array_union", *_array_transform("array_union", _array_union))
register("array_intersect",
         *_array_transform("array_intersect", _array_intersect))
register("array_except", *_array_transform("array_except", _array_except))
register("arrays_overlap",
         *_array_transform("arrays_overlap", _arrays_overlap, T.BOOLEAN))
register("array_join",
         lambda args: T.VARCHAR if args and _is_array(args[0])
         and len(args) in (2, 3) else None,
         _array_transform("array_join", _array_join, T.VARCHAR)[1])


def _resolve_sequence(args):
    if len(args) in (2, 3) and all(a.is_integer for a in args):
        return T.array_of(T.BIGINT)
    return None


def _emit_sequence(args):
    vals = []
    for a in args:
        if _is_tensor(a.data):
            if a.data.ndim > 0:
                raise NotImplementedError("sequence over column bounds")
            refuse_host_read("sequence")
        vals.append(int(a.data))
    start, stop = vals[0], vals[1]
    step = vals[2] if len(vals) > 2 else (1 if stop >= start else -1)
    if step == 0:
        raise ValueError("sequence step cannot be zero")
    if (stop - start) * step < 0:
        raise ValueError(
            "sequence stop value should be " +
            ("greater than or equal to" if step > 0
             else "less than or equal to")
            + " start value" + (" if step is greater than zero"
                                if step > 0 else " if step is less than zero"))
    n = max(0, (stop - start) // step + 1)
    if n > 10_000_000:
        raise ValueError("sequence result is too large")
    return _one_entry(tuple(range(start, start + n * step, step)),
                      all_valid(*args), T.array_of(T.BIGINT))


register("sequence", _resolve_sequence, _emit_sequence)


def _resolve_split(args):
    if len(args) in (2, 3) and args[0].is_string and args[1].is_string:
        return T.array_of(T.VARCHAR)
    return None


def _emit_split(args):
    col = _literal_dictionary(args[0])
    delim = args[1].data if isinstance(args[1].data, str) else None
    if delim is None:
        raise NotImplementedError("split with a non-constant delimiter")
    limit = None
    if len(args) > 2:
        limit = int(_const_arg("split", args[2]))
    rt = T.array_of(T.VARCHAR)

    def compute():
        vals = col.dictionary.values
        outs = [()] * max(len(vals), 1)
        for i, v in enumerate(vals):
            outs[i] = tuple(str(v).split(delim) if limit is None
                            else str(v).split(delim, limit - 1))
        return _tuple_dictionary(outs)

    inverse, d = col.dictionary.derived(("split", delim, limit), compute)
    return ColVal(_lookup(col.data, inverse), col.valid, rt, d)


register("split", _resolve_split, _emit_split)


def _emit_concat_arrays(args):
    """ARRAY || ARRAY, once per distinct combination of codes (reference:
    _emit_concat_arrays; its static program reads the codes back)."""
    codes, inv, scalar = _pair_codes(args, "concat", mask_nulls=False)
    outs = np.empty(len(codes), dtype=object)
    for k, combo in enumerate(codes):
        t = ()
        for a, code in zip(args, combo):
            dv = _arr_entries(a)
            t = t + (tuple(dv[int(code)]) if 0 <= int(code) < len(dv)
                     else ())
        outs[k] = t
    rt = _resolve_concat([a.type for a in args])
    return _tuple_dict_normalize(
        outs, ColVal(_combo_codes(inv, scalar, args), all_valid(*args), rt),
        rt)


# ---- higher-order (lambda) functions ---------------------------------------
# Reference: the lambda section of presto_tpu/functions/scalar.py.  The
# body runs over the flattened elements of the dictionary entries
# (LambdaVal.apply), so the work is per distinct value, not per row;
# a capture of an enclosing row column would break that and is refused.


def _check_lambda(lam, name):
    if not isinstance(lam, LambdaVal):
        raise NotImplementedError(f"{name} expects a lambda argument")
    if lam.free_refs():
        raise NotImplementedError(
            f"{name}: lambda captures of enclosing columns are not supported")


def _colval_from_pylist(vals, t: T.Type) -> ColVal:
    """A column ColVal of host values (None == NULL) on the session's
    device."""
    n = len(vals)
    device = session_ctx.device()
    valid = np.asarray([v is not None for v in vals], dtype=bool)
    v_arg = None if valid.all() else upload(valid, device)
    positions = ColVal(torch.arange(n, dtype=torch.int32, device=device),
                       v_arg, t)
    if _is_collection(t):
        obj = np.empty(n, dtype=object)
        for i, v in enumerate(vals):
            obj[i] = tuple(v) if v is not None else ()
        return _tuple_dict_normalize(obj, positions, t)
    if t.is_string:
        return _normalize_strings(
            ["" if v is None else str(v) for v in vals],
            ColVal(positions.data, v_arg, T.VARCHAR))
    if t.name == "UNKNOWN":
        return ColVal(torch.zeros((n,), dtype=torch.int32, device=device),
                      torch.zeros((n,), dtype=torch.bool, device=device), t)
    data = np.asarray([(0 if v is None else v) for v in vals],
                      dtype=t.numpy_dtype())
    return ColVal(upload(data, device), v_arg, t)


def _pylist_from_colval(cv: ColVal, n: int) -> list:
    """Host decode of a ColVal to Python values, None == NULL."""
    data, valid = cv.data, cv.valid
    if _is_tensor(data) or _is_tensor(valid):
        refuse_host_read("a lambda's result")
    if _is_tensor(data) and data.ndim > 0:
        codes = data.cpu().numpy()
    else:
        codes = np.full(n, data.item() if _is_tensor(data) else data)
    if cv.dictionary is not None:
        dvals = cv.dictionary.values
        if len(dvals) == 0:
            out = [None] * n
        else:
            picked = dvals[np.clip(codes, 0, len(dvals) - 1)]
            out = picked.tolist() if picked.dtype.kind == "U" \
                else [_host(v) for v in picked]
    else:
        out = codes.tolist()
    if valid is None:
        return out
    if _is_tensor(valid) and valid.ndim > 0:
        valid = valid.cpu().numpy()
    else:
        valid = np.full(n, bool(valid))
    return [v if ok else None for v, ok in zip(out, valid)]


def _flat_apply(lam, entries):
    """A one-parameter lambda over every element of every entry:
    (lengths of the entries, the flat results)."""
    lens = [len(t) for t in entries]
    flat = [e for t in entries for e in t]
    if not flat:
        return lens, []
    elem = _colval_from_pylist(flat, lam.param_types[0])
    res = lam.apply({lam.params[0]: elem})
    return lens, _pylist_from_colval(res, len(flat))


def _result_tables(vals: list, rt: T.Type) -> tuple:
    """(table, dictionary, NULL flags) of host results, one per
    dictionary entry, None for NULL (reference: _dict_lut_result): a
    collection result is a tuple dictionary and its code table, a string
    one a sorted dictionary and its code table, any other a value
    table."""
    if len(vals) == 0:
        vals = [None]
    null = np.asarray([v is None for v in vals], dtype=bool)
    if _is_collection(rt):
        inverse, d = _tuple_dictionary([tuple(v) if v is not None else ()
                                        for v in vals])
        return inverse, d, null
    if rt.is_string:
        return (*_string_dictionary(["" if v is None else v for v in vals]),
                null)
    if rt.name in ("HLL", "P4HLL", "QDIGEST", "TDIGEST"):
        # serialized sketches: a dictionary of the entries' blobs
        obj = np.empty(len(vals), dtype=object)
        obj[:] = [b"" if v is None else bytes(v) for v in vals]
        return np.arange(len(vals), dtype=np.int32), Dictionary(obj), null
    return np.asarray([0 if v is None else v for v in vals],
                      dtype=rt.numpy_dtype()), None, null


def _entries_tables(outs: list) -> tuple:
    """(code table, dictionary, None) of one result tuple per dictionary
    entry (at least one entry, as in the reference)."""
    outs = list(outs) or [()]
    return (*_tuple_dictionary(outs), None)


def _from_tables(col: ColVal, rt: T.Type, tables) -> ColVal:
    """A per-entry result (_result_tables, _entries_tables) through the
    codes: one lookup on the device, NULL where the entry's result is."""
    lut, d, null = tables
    codes = _clip_codes(col.data, len(lut))
    valid = col.valid
    if null is not None and null.any():
        valid = _and_not(valid, _lookup(codes, null))
    return ColVal(_lookup(codes, lut), valid,
                  T.VARCHAR if rt.is_string else rt, d)


def _lambda_key(*lams):
    """What a lambda's results depend on besides the dictionary: its
    parameters and body (None when the body reads a scalar subquery,
    whose value lives in the query's context)."""
    key = tuple((lam.params, lam.param_types, repr(lam.body))
                for lam in lams)
    return None if any("ScalarSub(" in k[2] for k in key) else key


def _kept(col: ColVal, key, compute):
    """compute() kept beside col's dictionary under key, so that a
    lambda runs once per dictionary, not once per query.  The static
    pass computes afresh: there the reference's program reads the
    lambda's results on the host and falls back (_pylist_from_colval)."""
    if col.dictionary is None or None in key or in_static_pass():
        return compute()
    return col.dictionary.derived(key, compute)


def _split_runs(lens, flat) -> list:
    out, off = [], 0
    for n in lens:
        out.append(flat[off:off + n])
        off += n
    return out


def _emit_transform(args):
    col, lam = args
    _check_lambda(lam, "transform")

    def compute():
        lens, res = _flat_apply(lam, _arr_entries(col))
        return _entries_tables(tuple(r) for r in _split_runs(lens, res))

    return _from_tables(col, T.array_of(lam.ret_type), _kept(
        col, ("transform", _lambda_key(lam)), compute))


def _emit_filter(args):
    col, lam = args
    _check_lambda(lam, "filter")

    def compute():
        entries = _arr_entries(col)
        lens, res = _flat_apply(lam, entries)
        return _entries_tables(
            tuple(e for e, k in zip(t, r) if k is not None and bool(k))
            for t, r in zip(entries, _split_runs(lens, res)))

    return _from_tables(col, col.type, _kept(
        col, ("filter", _lambda_key(lam)), compute))


def _emit_match(name):
    def emit(args):
        col, lam = args
        _check_lambda(lam, name)

        def compute():
            lens, res = _flat_apply(lam, _arr_entries(col))
            # per entry: any element true, any false, any NULL
            null = np.fromiter((v is None for v in res), bool, len(res))
            true = np.fromiter((v is not None and bool(v) for v in res),
                               bool, len(res))
            ends = np.cumsum(lens, dtype=np.int64)

            def per_entry(flags):
                c = np.concatenate([[0], np.cumsum(flags, dtype=np.int64)])
                return (c[ends] - c[ends - lens]) > 0

            any_true, any_null = per_entry(true), per_entry(null)
            any_false = per_entry(~true & ~null)
            vals = []
            for t, f, u in zip(any_true.tolist(), any_false.tolist(),
                               any_null.tolist()):
                if name == "any_match":
                    r = True if t else (None if u else False)
                elif name == "all_match":
                    r = False if f else (None if u else True)
                else:  # none_match
                    r = False if t else (None if u else True)
                vals.append(r)
            return _result_tables(vals, T.BOOLEAN)

        return _from_tables(col, T.BOOLEAN, _kept(
            col, (name, _lambda_key(lam)), compute))

    return emit


def _emit_reduce(args):
    arr, init, merge, out = args
    _check_lambda(merge, "reduce")
    _check_lambda(out, "reduce")
    if _is_tensor(init.data) and init.data.ndim > 0:
        raise NotImplementedError("reduce with a non-constant initial state")
    init_null = init.valid is not None and not _is_tensor(init.valid) \
        and not bool(init.valid)
    iv = None
    if not init_null:
        iv = init.data
        if _is_tensor(iv):
            refuse_host_read("reduce")
            iv = iv.item()

    def compute():
        entries = _arr_entries(arr)
        ne = len(entries)
        states = [iv] * ne
        maxlen = max((len(t) for t in entries), default=0)
        # step-synchronous: one vectorized merge over every entry that
        # still has an element at this position
        for step in range(maxlen):
            idxs = [i for i in range(ne) if len(entries[i]) > step]
            sc = _colval_from_pylist([states[i] for i in idxs],
                                     merge.param_types[0])
            ec = _colval_from_pylist([entries[i][step] for i in idxs],
                                     merge.param_types[1])
            res = _pylist_from_colval(
                merge.apply({merge.params[0]: sc, merge.params[1]: ec}),
                len(idxs))
            for j, i in enumerate(idxs):
                states[i] = res[j]
        finals = []
        if ne:
            fc = _colval_from_pylist(states, out.param_types[0])
            finals = _pylist_from_colval(out.apply({out.params[0]: fc}), ne)
        return _result_tables(finals, out.ret_type)

    return _from_tables(arr, out.ret_type, _kept(
        arr, ("reduce", repr(iv), _lambda_key(merge, out)), compute))


def _code_array(a: ColVal, mask_nulls: bool) -> np.ndarray:
    c = a.data.cpu().numpy() if _is_tensor(a.data) else np.asarray(a.data)
    if mask_nulls and _is_tensor(a.valid) and a.valid.ndim > 0:
        c = np.where(a.valid.cpu().numpy(), np.atleast_1d(c), -1)
    return c


def _pair_codes(args, name: str, mask_nulls: bool = True):
    """Row-wise pairing of dictionary-coded arguments (reference:
    _pair_codes): (the distinct code combinations [k, N], each row's
    combination, all constant?).  NULL rows pair as code -1 when
    mask_nulls.  The codes are read on the host, which the reference's
    static program cannot do."""
    refuse_host_read(name)
    codes_list = [_code_array(a, mask_nulls) for a in args]
    scalar = all(c.ndim == 0 for c in codes_list)
    n = max((len(c) for c in codes_list if c.ndim > 0), default=1)
    cols = [np.broadcast_to(np.atleast_1d(c), (n,)) for c in codes_list]
    uniq, inv = np.unique(np.stack(cols, axis=1), axis=0,
                          return_inverse=True)
    return uniq, inv.reshape(-1), scalar


def _combo_codes(inv: np.ndarray, scalar: bool, args):
    if scalar:
        return int(inv[0])
    device = next(a.data.device for a in args if _is_tensor(a.data))
    return upload(inv.astype(np.int32), device)


def _emit_zip_with(args):
    a, b, lam = args
    _check_lambda(lam, "zip_with")
    av, bv = _arr_entries(a), _arr_entries(b)
    refuse_host_read("zip_with")
    ca, cb = _code_array(a, False), _code_array(b, False)
    scalar = ca.ndim == 0 and cb.ndim == 0
    ca1, cb1 = np.atleast_1d(ca), np.atleast_1d(cb)
    n = max(len(ca1), len(cb1))
    if len(ca1) == 1:
        ca1 = np.repeat(ca1, n)
    if len(cb1) == 1:
        cb1 = np.repeat(cb1, n)
    pairs = np.stack([np.clip(ca1, 0, max(len(av) - 1, 0)),
                      np.clip(cb1, 0, max(len(bv) - 1, 0))], axis=1)
    uniq, inv = np.unique(pairs, axis=0, return_inverse=True)

    def compute():
        e1t, e2t = lam.param_types
        flat1, flat2, lens = [], [], []
        for i, j in uniq:
            t1 = av[i] if len(av) else ()
            t2 = bv[j] if len(bv) else ()
            n_ = max(len(t1), len(t2))  # the shorter one padded with NULL
            lens.append(n_)
            flat1.extend(list(t1) + [None] * (n_ - len(t1)))
            flat2.extend(list(t2) + [None] * (n_ - len(t2)))
        res = []
        if flat1:
            r = lam.apply({lam.params[0]: _colval_from_pylist(flat1, e1t),
                           lam.params[1]: _colval_from_pylist(flat2, e2t)})
            res = _pylist_from_colval(r, len(flat1))
        return _entries_tables(tuple(t) for t in _split_runs(lens, res))

    lut, d, _ = _kept(a, ("zip_with", b.dictionary, _lambda_key(lam),
                          uniq.tobytes()), compute)
    inv = inv.reshape(-1)
    codes = int(inv[0]) if scalar else _combo_codes(inv, False, (a, b))
    return ColVal(_lookup(codes, lut), all_valid(a, b),
                  T.array_of(lam.ret_type), d)


_SORT_RESOLVE, _SORT_EMIT = _array_transform("array_sort", _array_sort)


def _emit_array_sort(args):
    """array_sort(a) with NULLs last, or array_sort(a, (x, y) -> cmp),
    whose comparisons of every pair within an entry run in one lambda
    application (reference: scalar_ext2.py's wrapper)."""
    if not (len(args) == 2 and isinstance(args[1], LambdaVal)):
        return _SORT_EMIT(args)
    col, lam = args
    _check_lambda(lam, "array_sort")

    def compute():
        entries = _arr_entries(col)
        xs, ys, owners = [], [], []
        for ei, t in enumerate(entries):
            for i in range(len(t)):
                for j in range(i + 1, len(t)):
                    xs.append(t[i])
                    ys.append(t[j])
                    owners.append((ei, i, j))
        res = []
        if xs:
            et = lam.param_types[0]
            res = _pylist_from_colval(
                lam.apply({lam.params[0]: _colval_from_pylist(xs, et),
                           lam.params[1]: _colval_from_pylist(ys, et)}),
                len(xs))
        cmps = {o: 0 if r is None else int(r) for o, r in zip(owners, res)}
        outs = []
        for ei, t in enumerate(entries):
            def cmp(i, j, _ei=ei):
                if i == j:
                    return 0
                if i < j:
                    return cmps.get((_ei, i, j), 0)
                return -cmps.get((_ei, j, i), 0)

            order = sorted(range(len(t)), key=functools.cmp_to_key(cmp))
            outs.append(tuple(t[i] for i in order))
        return _result_tables(outs, col.type)

    return _from_tables(col, col.type, _kept(
        col, ("array_sort", _lambda_key(lam)), compute))


register("array_sort",
         lambda args: args[0] if len(args) == 2 and _is_array(args[0])
         and _is_function(args[1]) else _SORT_RESOLVE(args),
         _emit_array_sort)
register("transform",
         lambda args: T.array_of(_fn_ret(args[1])) if len(args) == 2
         and _is_array(args[0]) and _is_function(args[1]) else None,
         _emit_transform)
register("filter",
         lambda args: args[0] if len(args) == 2 and _is_array(args[0])
         and _is_function(args[1]) else None,
         _emit_filter)
for _m in ("any_match", "all_match", "none_match"):
    register(_m,
             lambda args: T.BOOLEAN if len(args) == 2 and _is_array(args[0])
             and _is_function(args[1]) else None,
             _emit_match(_m))
register("zip_with",
         lambda args: T.array_of(_fn_ret(args[2])) if len(args) == 3
         and _is_array(args[0]) and _is_array(args[1])
         and _is_function(args[2]) else None,
         _emit_zip_with)
register("reduce",
         lambda args: _fn_ret(args[3]) if len(args) == 4
         and _is_array(args[0]) and _is_function(args[2])
         and _is_function(args[3]) else None,
         _emit_reduce)


# ---- MAP --------------------------------------------------------------------


def _map_sort(pairs) -> tuple:
    return tuple(sorted(pairs, key=lambda p: repr(p[0])))


def _map_build(keys, values) -> tuple:
    keys = list(keys)
    if any(k is None for k in keys):
        raise ValueError("map key cannot be null")
    if len(set(keys)) != len(keys):
        raise ValueError("duplicate map keys are not allowed")
    return _map_sort(zip(keys, values))


def _resolve_map_ctor(args):
    if len(args) == 0:
        return T.map_of(T.UNKNOWN, T.UNKNOWN)
    if len(args) == 2 and all(a.name == "ARRAY" for a in args):
        return T.map_of(args[0].params[0], args[1].params[0])
    return None


def _emit_map_ctor(args):
    rt = _resolve_map_ctor([a.type for a in args])
    if not args:
        return _one_entry((), None, rt)
    ka, va = args
    uniq, inv, scalar = _pair_codes(args, "map")
    kd, vd = _arr_entries(ka), _arr_entries(va)
    outs = np.empty(len(uniq), dtype=object)
    for i, (ck, cv) in enumerate(uniq):
        if int(ck) < 0 or int(cv) < 0:  # a NULL row: NULL through valid
            outs[i] = ()
            continue
        keys = kd[int(ck)] if int(ck) < len(kd) else ()
        vals = vd[int(cv)] if int(cv) < len(vd) else ()
        if len(keys) != len(vals):
            raise ValueError("map key and value arrays must match in length")
        outs[i] = _map_build(keys, vals)
    return _tuple_dict_normalize(
        outs, ColVal(_combo_codes(inv, scalar, args), all_valid(*args), rt),
        rt)


register("map", _resolve_map_ctor, _emit_map_ctor)


def _map_value_fn(name, fn, rt_fn):
    """A function of a map and constant arguments, once per entry."""

    def resolve(args):
        return rt_fn(args) if args and _is_map(args[0]) else None

    def emit(args):
        col = args[0]
        extra = tuple(_const_arg(name, a) for a in args[1:])
        rt = rt_fn([a.type for a in args])

        def compute():
            vals = []
            for t in _arr_entries(col):
                try:
                    vals.append(fn(t, *extra))
                except (ValueError, IndexError, TypeError, KeyError):
                    vals.append(None)
            return _result_tables(vals, rt)

        return _from_tables(col, rt, _kept(col, (name, fn, extra, rt),
                                           compute))

    return resolve, emit


def _map_keys(t):
    return tuple(k for k, _ in t)


def _map_values(t):
    return tuple(v for _, v in t)


def _map_entries(t):
    return tuple(tuple(p) for p in t)


register("map_keys", *_map_value_fn(
    "map_keys", _map_keys, lambda a: T.array_of(a[0].params[0])))
register("map_values", *_map_value_fn(
    "map_values", _map_values, lambda a: T.array_of(a[0].params[1])))
register("map_entries", *_map_value_fn(
    "map_entries", _map_entries,
    lambda a: T.array_of(T.row_of([(None, a[0].params[0]),
                                   (None, a[0].params[1])]))))


def _map_lookup(t, key):
    for k, v in t:
        if k == key:
            return v
    return None


def _resolve_element_at(args):
    if not args:
        return None
    if _is_array(args[0]):
        return _elem_type(args[0])
    if _is_map(args[0]):
        return args[0].params[1]
    return None


_MAP_ELEMENT_AT = _map_value_fn("element_at", _map_lookup,
                                lambda a: a[0].params[1])[1]
_ARRAY_ELEMENT_AT = _array_transform("element_at", _element_at, "elem")[1]


def _emit_element_at(args):
    """element_at(a, i) and a[i] / m[k]: NULL when missing (the
    reference's lenient subscript)."""
    if _is_map(args[0].type):
        return _MAP_ELEMENT_AT(args)
    return _ARRAY_ELEMENT_AT(args)


register("element_at", _resolve_element_at, _emit_element_at)
register("subscript", _resolve_element_at, _emit_element_at)


def _resolve_cardinality(args):
    return T.BIGINT if args and args[0].name in (
        "ARRAY", "MAP", "HLL", "P4HLL", "QDIGEST") else None


def _emit_cardinality(args):
    col = args[0]
    if col.type.name in ("HLL", "P4HLL", "QDIGEST"):
        return _sketch_cardinality(args)
    return _from_tables(col, T.BIGINT, _kept(
        col, ("cardinality",), lambda: _result_tables(
            [len(t) for t in _arr_entries(col)], T.BIGINT)))


register("cardinality", _resolve_cardinality, _emit_cardinality)


def _resolve_map_concat(args):
    if args and all(_is_map(a) for a in args):
        kt, vt = args[0].params
        for a in args[1:]:
            kt = T.common_super_type(kt, a.params[0]) or kt
            vt = T.common_super_type(vt, a.params[1]) or vt
        return T.map_of(kt, vt)
    return None


def _emit_map_concat(args):
    rt = _resolve_map_concat([a.type for a in args])
    uniq, inv, scalar = _pair_codes(args, "map_concat")
    dicts = [_arr_entries(a) for a in args]
    outs = np.empty(len(uniq), dtype=object)
    for i, combo in enumerate(uniq):
        merged = {}
        for dv, code in zip(dicts, combo):
            if 0 <= int(code) < len(dv):
                merged.update(dict(dv[int(code)]))  # later maps win
        outs[i] = _map_sort(merged.items())
    return _tuple_dict_normalize(
        outs, ColVal(_combo_codes(inv, scalar, args), all_valid(*args), rt),
        rt)


register("map_concat", _resolve_map_concat, _emit_map_concat)


def _resolve_map_from_entries(args):
    if args and _is_array(args[0]) and args[0].params[0].name == "ROW" \
            and len(args[0].params[0].params) == 2:
        return T.map_of(args[0].params[0].params[0][1],
                        args[0].params[0].params[1][1])
    return None


def _emit_map_from_entries(args):
    col = args[0]
    rt = _resolve_map_from_entries([a.type for a in args])

    def compute():
        vals = []
        for t in _arr_entries(col):
            try:
                vals.append(_map_build([p[0] for p in t],
                                       [p[1] for p in t]))
            except (ValueError, IndexError, TypeError):
                vals.append(None)
        return _result_tables(vals, rt)

    return _from_tables(col, rt, _kept(col, ("map_from_entries", rt),
                                       compute))


register("map_from_entries", _resolve_map_from_entries,
         _emit_map_from_entries)


def _emit_map_hof(name):
    def emit(args):
        col, lam = args
        _check_lambda(lam, name)
        if name == "map_filter":
            rt = col.type
        elif name == "transform_values":
            rt = T.map_of(col.type.params[0], lam.ret_type)
        else:
            rt = T.map_of(lam.ret_type, col.type.params[1])

        def compute():
            entries = _arr_entries(col)
            lens = [len(t) for t in entries]
            ks = [k for t in entries for k, _ in t]
            vs = [v for t in entries for _, v in t]
            res = []
            if ks:
                kc = _colval_from_pylist(ks, lam.param_types[0])
                vc = _colval_from_pylist(vs, lam.param_types[1])
                res = _pylist_from_colval(
                    lam.apply({lam.params[0]: kc, lam.params[1]: vc}),
                    len(ks))
            outs = []
            for pairs, window in zip(entries, _split_runs(lens, res)):
                if name == "map_filter":
                    outs.append(tuple(p for p, r in zip(pairs, window)
                                      if r is not None and bool(r)))
                elif name == "transform_values":
                    outs.append(tuple((k, r) for (k, _), r
                                      in zip(pairs, window)))
                else:  # transform_keys
                    if any(k is None for k in window):
                        raise ValueError("map key cannot be null")
                    if len(set(window)) != len(window):
                        raise ValueError(
                            "duplicate map keys from transform_keys")
                    outs.append(_map_sort((r, v) for (_, v), r
                                          in zip(pairs, window)))
            return _entries_tables(outs)

        return _from_tables(col, rt, _kept(
            col, (name, _lambda_key(lam)), compute))

    return emit


register("map_filter",
         lambda args: args[0] if len(args) == 2 and _is_map(args[0])
         and _is_function(args[1]) else None,
         _emit_map_hof("map_filter"))
register("transform_values",
         lambda args: T.map_of(args[0].params[0], _fn_ret(args[1]))
         if len(args) == 2 and _is_map(args[0]) and _is_function(args[1])
         else None,
         _emit_map_hof("transform_values"))
register("transform_keys",
         lambda args: T.map_of(_fn_ret(args[1]), args[0].params[1])
         if len(args) == 2 and _is_map(args[0]) and _is_function(args[1])
         else None,
         _emit_map_hof("transform_keys"))


# ---- ROW --------------------------------------------------------------------


def _resolve_row_ctor(args):
    return T.row_of([(None, a) for a in args])


def _emit_row_ctor(args):
    vals = tuple(_constant_element(a, "ROW") for a in args)
    return _one_entry(vals, None, _resolve_row_ctor([a.type for a in args]))


register("row", _resolve_row_ctor, _emit_row_ctor)


def _emit_row_field(args):
    col, idx_v = args
    idx = int(_const_arg("row_field", idx_v))
    ft = col.type.params[idx][1]
    return _from_tables(col, ft, _kept(
        col, ("row_field", idx, ft), lambda: _result_tables(
            [t[idx] if idx < len(t) else None for t in _arr_entries(col)],
            ft)))


register("row_field", lambda args: None, _emit_row_field)


# ---- collection casts -------------------------------------------------------


def _container_same_elements(a: T.Type, b: T.Type) -> bool:
    def same(x, y):
        return x == y or y.name == "UNKNOWN" or x.name == "UNKNOWN"

    if a.name == "ROW":
        return len(a.params) == len(b.params) and all(
            same(x[1], y[1]) for x, y in zip(a.params, b.params))
    return all(same(x, y) for x, y in zip(a.params, b.params))


def _render_varchar(x, frm: T.Type) -> str:
    """A value's text (reference: _render_varchar): booleans, numbers,
    decimals and dates."""
    if frm.name == "BOOLEAN":
        return "true" if x else "false"
    if frm.is_integer:
        return str(int(x))
    if frm.is_floating:
        f = float(x)
        if f != f:
            return "NaN"
        if f == float("inf"):
            return "Infinity"
        if f == float("-inf"):
            return "-Infinity"
        # Java Double.toString: plain decimal in [1e-3, 1e7), else
        # scientific
        if f == 0.0 or 1e-3 <= abs(f) < 1e7:
            if f == int(f):
                return f"{f:.1f}"
            return repr(f)
        mant, exp = f"{f:E}".split("E")
        mant = mant.rstrip("0").rstrip(".")
        if "." not in mant:
            mant += ".0"
        return f"{mant}E{int(exp)}"
    if frm.is_decimal:
        return DEC.render(int(x), frm.decimal_scale)
    if frm.name == "DATE":
        return (datetime.date(1970, 1, 1)
                + datetime.timedelta(days=int(x))).isoformat()
    if frm.name == "TIMESTAMP":  # int64 microseconds since epoch
        return _micros_text(int(x), "%Y-%m-%d %H:%M:%S.%f")
    if frm.name == "TIMESTAMP_TZ":  # UTC micros; zone in the type
        from presto_tpu_torch.functions import tzdb

        zone = frm.tz or session_ctx.current_zone()
        local = tzdb.rules(zone).utc_to_local_scalar(int(x))
        return _micros_text(local, "%Y-%m-%d %H:%M:%S.%f") + " " + zone
    if frm.name == "TIME":  # micros since midnight
        return _micros_text(int(x), "%H:%M:%S.%f")
    if frm.name == "TIME_TZ":
        off = int(frm.tz or 0)
        sign = "-" if off < 0 else "+"
        return (_micros_text(int(x), "%H:%M:%S.%f")
                + f"{sign}{abs(off) // 60:02d}:{abs(off) % 60:02d}")
    raise NotImplementedError(
        f"CAST of {frm} to VARCHAR is not ported to presto_tpu_torch")


def _micros_text(us: int, fmt: str) -> str:
    """Micros since the epoch (or midnight) as text, to milliseconds."""
    t = datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=us)
    return t.strftime(fmt)[:-3]


def _py_cast_scalar(x, ft: T.Type, tt: T.Type):
    if x is None:
        return None
    if ft == tt or tt.name == "UNKNOWN":
        return x
    if _is_collection(tt):
        return _py_cast_value(x, ft, tt)
    if tt.is_string:
        return x if ft.is_string else _render_varchar(x, ft)
    if tt.is_integer:
        return int(x)
    if tt.is_floating:
        return float(x)
    if tt.name == "BOOLEAN":
        return bool(x)
    raise NotImplementedError(f"CAST {ft} -> {tt} inside a container")


def _py_cast_value(t, frm: T.Type, to: T.Type):
    """One collection dictionary entry converted between element
    types."""
    if t is None:
        return None
    if frm.name == "ARRAY":
        return tuple(_py_cast_scalar(e, frm.params[0], to.params[0])
                     for e in t)
    if frm.name == "MAP":
        return _map_sort(
            (_py_cast_scalar(k, frm.params[0], to.params[0]),
             _py_cast_scalar(w, frm.params[1], to.params[1])) for k, w in t)
    return tuple(_py_cast_scalar(e, ft[1], tt[1])
                 for e, ft, tt in zip(t, frm.params, to.params))


def _cast_collection(v: ColVal, to: T.Type) -> ColVal:
    """CAST between two ARRAY, MAP or ROW types of one kind: a re-tag
    when the element types agree (ROW field renaming), else every
    dictionary entry converted on the host."""
    frm = v.type
    if frm.name == "ROW" and len(frm.params) != len(to.params):
        raise ValueError(f"cannot cast {frm} to {to}: field count mismatch")
    if _container_same_elements(frm, to):
        return ColVal(v.data, v.valid, to, v.dictionary)
    entries = _arr_entries(v)
    outs = np.empty(max(len(entries), 1), dtype=object)
    outs[:] = [()] * len(outs)
    for i, t in enumerate(entries):
        outs[i] = _py_cast_value(t, frm, to)
    return _tuple_dict_normalize(
        outs, ColVal(_clip_codes(v.data, len(outs)), v.valid, to), to)


# ---- casts ----------------------------------------------------------------


def _cast_to_varchar(v: ColVal) -> ColVal:
    """Every value's text (_render_varchar), rendered on the host: a
    column is read back (in the static pass that falls back, as the
    reference's trace does) and becomes a sorted dictionary."""
    frm = v.type
    if not _is_tensor(v.data):
        return ColVal(_render_varchar(v.data, frm), v.valid, T.VARCHAR)
    refuse_host_read("CAST to VARCHAR")
    if v.data.ndim == 0:
        return ColVal(_render_varchar(v.data.item(), frm), v.valid,
                      T.VARCHAR)
    vals = [_render_varchar(x, frm) for x in v.data.cpu().numpy().tolist()]
    uniq, inv = np.unique(np.asarray(vals, dtype=str), return_inverse=True)
    return ColVal(upload(inv.astype(np.int32), v.data.device), v.valid,
                  T.VARCHAR, Dictionary(uniq.astype(object)))


def _parse_number(x, to: T.Type, safe: bool):
    """A string's float value (None: a TRY_CAST failure), checked
    against a short decimal's int64 unscaled range."""
    try:
        f = float(x)
    except ValueError:
        if safe:
            return None
        raise
    if to.is_decimal and abs(f) * (10 ** to.decimal_scale) \
            >= T.DECIMAL_UNSCALED_LIMIT:
        if safe:
            return None
        raise ValueError(
            f"DECIMAL overflow: '{x}' exceeds 19 significant digits")
    return f


def _timestamp_micros(s: str) -> int:
    """A TIMESTAMP text ('2020-01-01 10:00:00[.fff]') as micros."""
    t = str(s).strip()
    if " " in t and "T" not in t:
        t = t.replace(" ", "T", 1)
    return int((np.datetime64(t) - np.datetime64("1970-01-01T00:00:00"))
               / np.timedelta64(1, "us"))


def _cast_from_string(v: ColVal, to: T.Type, safe: bool) -> ColVal:
    """VARCHAR -> a number (reference: emit_cast's parse through a
    dictionary table): a long decimal parses exactly into limbs, every
    other number through float64; an entry that does not parse is NULL
    under TRY_CAST and raises otherwise."""
    if to.name in ("DATE", "TIMESTAMP"):
        from presto_tpu_torch.functions import datetime_tz as DTZ

        parse = _to_days if to.name == "DATE" else _timestamp_micros
        return DTZ.host_parse_lut(v, parse, to, safe,
                                  np.int32 if to.name == "DATE"
                                  else np.int64)
    if not to.is_numeric:
        raise NotImplementedError(
            f"CAST({v.type} AS {to}) is not ported to presto_tpu_torch")
    null = ColVal(False, False, T.UNKNOWN)
    if isinstance(v.data, str):
        if DEC.is_long(to):
            unscaled = DEC.parse_dec128(v.data, to, safe)
            if unscaled is None:
                return emit_cast(null, to, safe)
            return ColVal(unscaled, v.valid, to)
        val = _parse_number(v.data, to, safe)
        if val is None:
            return emit_cast(null, to, safe)
        if to.is_integer:
            if val != val:  # CAST('NaN' AS INTEGER) has no value
                return emit_cast(null, to, safe)
            return ColVal(int(val), v.valid, to)
        if to.is_decimal:
            return DEC.emit_cast_decimal(ColVal(val, v.valid, T.DOUBLE), to,
                                         safe)
        return ColVal(val, v.valid, to)
    entries = v.dictionary.values
    bad = np.zeros(max(len(entries), 1), dtype=bool)
    parsed = []
    for i, x in enumerate(entries):
        r = DEC.parse_dec128(x, to, safe) if DEC.is_long(to) \
            else _parse_number(x, to, safe)
        if r is None:  # a failure, kept apart from a genuine NaN
            bad[i] = True
            r = 0
        parsed.append(r)
    valid = v.valid
    if bad.any():
        valid = _and_not(valid, _lookup(v.data, bad))
    if DEC.is_long(to):
        from presto_tpu_torch.exec import dec128 as D128

        table = D128.from_host_ints(parsed or [0])
        codes = _clip_codes(v.data, len(table))
        if not _is_tensor(codes):
            return ColVal(D128.to_host_ints(table[codes])[0], valid, to)
        return ColVal(upload(table, codes.device)[codes.long()], valid, to)
    data = _lookup(v.data, np.asarray(parsed or [0.0], dtype=np.float64))
    return emit_cast(ColVal(data, valid, T.DOUBLE), to, safe)



_ZONED = ("TIMESTAMP_TZ", "TIME", "TIME_TZ")
_SKETCHES = ("HLL", "P4HLL", "QDIGEST", "TDIGEST")


def _cast_sketch(v: ColVal, to: T.Type) -> Optional[ColVal]:
    """CASTs of serialized sketches (reference: emit_cast's sketch arms):
    an HLL and a P4HLL retag each other (the blobs are always dense), a
    sketch and VARBINARY retag each other (the raw bytes), a sketch
    renders to VARCHAR as base64 and parses from it (an entry that does
    not decode is NULL for its rows)."""
    frm = v.type
    if frm.name in ("HLL", "P4HLL") and to.name in ("HLL", "P4HLL"):
        return ColVal(v.data, v.valid, to, v.dictionary)
    if frm.name in _SKETCHES and to.name == "VARBINARY":
        return ColVal(v.data, v.valid, T.VARBINARY, v.dictionary)
    if frm.name == "VARBINARY" and to.name in _SKETCHES:
        return ColVal(v.data, v.valid, to, v.dictionary)
    if frm.name in _SKETCHES and to.is_string:
        vals = [base64.b64encode(b).decode("ascii")
                for b in _arr_entries(v)] or [""]
        return _from_tables(v, T.VARCHAR, (*_string_dictionary(vals), None))
    if frm.is_string and to.name in _SKETCHES:
        v = _literal_dictionary(v)
        out = []
        for x in v.dictionary.values:
            try:
                out.append(base64.b64decode(str(x), validate=True))
            except (binascii.Error, ValueError):
                out.append(None)
        return _from_tables(v, to, _result_tables(out, to))
    return None


def emit_cast(v: ColVal, to: T.Type, safe: bool = False) -> ColVal:
    frm = v.type
    if frm == to:
        return v
    if _is_collection(frm) and to.name == frm.name:
        return _cast_collection(v, to)
    if frm.name == "UNKNOWN":  # CAST(NULL AS anything) == typed NULL
        if to.name == "ARRAY":
            return _one_entry((), False, to)
        return ColVal("" if to.is_string else to.numpy_dtype().type(0).item(),
                      False, to)
    if frm.name in _ZONED or to.name in _ZONED:
        from presto_tpu_torch.functions import datetime_tz as DTZ

        r = DTZ.emit_cast_tz(v, to, safe)
        if r is not None:
            return r  # None: the generic arms below (a VARCHAR render)
    if frm.name in _SKETCHES or to.name in _SKETCHES:
        r = _cast_sketch(v, to)
        if r is not None:
            return r
    if to.is_string and not frm.is_string:
        return _cast_to_varchar(v)
    if frm.is_string and not to.is_string:
        return _cast_from_string(v, to, safe)
    if frm.name == "DATE" and to.name == "TIMESTAMP":
        d = v.data.to(torch.int64) if _is_tensor(v.data) else int(v.data)
        return ColVal(d * _US_PER_DAY, v.valid, T.TIMESTAMP)
    if frm.name == "TIMESTAMP" and to.name == "DATE":
        d = device_int64(v.data) // _US_PER_DAY  # as the reference's jnp
        return ColVal(d.to(torch.int32), v.valid, T.DATE)
    if to.is_decimal or frm.is_decimal:
        return DEC.emit_cast_decimal(v, to, safe)
    ok = (frm.is_numeric or frm.name == "BOOLEAN") \
        and (to.is_numeric or to.name == "BOOLEAN")
    if not ok:
        raise NotImplementedError(
            f"CAST({frm} AS {to}) is not ported to presto_tpu_torch")
    data = v.data
    if _is_tensor(data):
        if to.is_integer and frm.is_floating:
            data = torch.trunc(data)
        data = data.to(torch_dtype(to))
    elif to.is_integer:
        data = int(data)
    elif to.is_floating:
        data = float(data)
    else:
        data = bool(data)
    return ColVal(data, v.valid, to)


# ---- sketch functions (HLL / QDIGEST / TDIGEST) -----------------------------
# Reference: presto_tpu/functions/scalar.py `_register_sketch_fns` (after
# HyperLogLogFunctions.java and QuantileDigestFunctions.java).  A sketch
# column is codes into a dictionary of serialized blobs
# (functions/sketches.py, tdigest.py); each function runs once per
# dictionary entry on the host and its results reach the device as one
# table (`_from_tables`).


def _sketch_dict_fn(name, fn, rt_fn):
    """The emit of fn(blob, *constant arguments) once per dictionary
    entry; an entry whose blob does not parse gives NULL."""
    def emit(args):
        col = args[0]
        if col.dictionary is None and isinstance(col.data,
                                                 (bytes, bytearray)):
            # a scalar blob: the one-entry dictionary form
            col = _one_entry(bytes(col.data), col.valid, col.type)
        extra = [_const_arg(name, a) for a in args[1:]]
        vals = []
        for blob in _arr_entries(col):
            try:
                vals.append(fn(blob, *extra))
            except (ValueError, IndexError, TypeError, struct.error):
                vals.append(None)  # a malformed sketch: NULL for its rows
        rt = rt_fn([a.type for a in args])
        return _from_tables(col, rt, _result_tables(vals, rt))

    return emit


def _sketch_cardinality(args):
    from presto_tpu_torch.functions import sketches as SK

    if args[0].type.name == "QDIGEST":
        fn = lambda blob: int(SK.qd_parse(blob)[1])  # noqa: E731
    else:
        fn = SK.hll_cardinality
    return _sketch_dict_fn("cardinality", fn, lambda a: T.BIGINT)(args)


def _emit_empty_approx_set(args):
    from presto_tpu_torch.functions import sketches as SK

    return _one_entry(SK.hll_empty(), None, T.HLL)


register("empty_approx_set", lambda args: T.HLL if not args else None,
         _emit_empty_approx_set)

_DIGESTS = ("QDIGEST", "TDIGEST")


def _value_at(tname):
    """value_at_quantile of one blob of a TDIGEST or QDIGEST column."""
    from presto_tpu_torch.functions import sketches as SK
    from presto_tpu_torch.functions import tdigest as TD

    if tname == "TDIGEST":
        return lambda blob, q: TD.tdigest_value_at_quantile(blob, float(q))
    return lambda blob, q: SK.qdigest_value_at_quantile(blob, float(q))


def _resolve_value_at_quantile(args):
    if not args or args[0].name not in _DIGESTS:
        return None
    if not args[0].params or args[0].params[0].is_floating:
        return T.DOUBLE
    return args[0].params[0]


def _emit_value_at_quantile(args):
    return _sketch_dict_fn(
        "value_at_quantile", _value_at(args[0].type.name),
        lambda a: T.DOUBLE if a[0].params and a[0].params[0].is_floating
        else (a[0].params[0] if a[0].params else T.DOUBLE))(args)


def _emit_values_at_quantiles(args):
    one = _value_at(args[0].type.name)
    return _sketch_dict_fn(
        "values_at_quantiles", lambda blob, qs: tuple(one(blob, q)
                                                      for q in qs),
        lambda a: T.array_of(T.DOUBLE))(args)


def _emit_quantile_at_value(args):
    from presto_tpu_torch.functions import sketches as SK
    from presto_tpu_torch.functions import tdigest as TD

    if args[0].type.name == "TDIGEST":
        fn = lambda blob, v: TD.tdigest_quantile_at_value(  # noqa: E731
            blob, float(v))
    else:
        fn = lambda blob, v: SK.qdigest_quantile_at_value(  # noqa: E731
            blob, float(v))
    return _sketch_dict_fn("quantile_at_value", fn,
                           lambda a: T.DOUBLE)(args)


def _scale_tdigest(blob, f):
    from presto_tpu_torch.functions import tdigest as TD

    return TD.tdigest_scale(blob, float(f))


def _destructure_tdigest(blob):
    from presto_tpu_torch.functions import tdigest as TD

    return tuple(tuple(p) if isinstance(p, list) else p
                 for p in TD.tdigest_destructure(blob))


_TDIGEST_ROW = T.row_of([("means", T.array_of(T.DOUBLE)),
                         ("weights", T.array_of(T.DOUBLE)),
                         ("compression", T.DOUBLE), ("min", T.DOUBLE),
                         ("max", T.DOUBLE), ("sum", T.DOUBLE)])

register("value_at_quantile", _resolve_value_at_quantile,
         _emit_value_at_quantile)
register("values_at_quantiles",
         lambda args: (T.array_of(T.DOUBLE) if args
                       and args[0].name in _DIGESTS else None),
         _emit_values_at_quantiles)
register("quantile_at_value",
         lambda args: (T.DOUBLE if args and args[0].name in _DIGESTS
                       else None),
         _emit_quantile_at_value)
register("scale_tdigest",
         lambda args: args[0] if args and args[0].name == "TDIGEST"
         else None,
         _sketch_dict_fn("scale_tdigest", _scale_tdigest, lambda a: a[0]))
register("destructure_tdigest",
         lambda args: _TDIGEST_ROW if args and args[0].name == "TDIGEST"
         else None,
         _sketch_dict_fn("destructure_tdigest", _destructure_tdigest,
                         lambda a: _TDIGEST_ROW))


# the extended batches register last, as in the reference (scalar.py's
# closing imports), so that their registrations of a name win
from presto_tpu_torch.functions import scalar_ext as _scalar_ext  # noqa: E402,F401,E501
from presto_tpu_torch.functions import scalar_ext2 as _scalar_ext2  # noqa: E402,F401,E501
from presto_tpu_torch.functions import datetime_tz as _datetime_tz  # noqa: E402,F401,E501
from presto_tpu_torch.functions import geospatial as _geospatial  # noqa: E402,F401,E501
from presto_tpu_torch.functions import ml as _ml  # noqa: E402,F401,E501
