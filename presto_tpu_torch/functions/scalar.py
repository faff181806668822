"""Scalar function registry: SQL-level signature resolution + torch emission.

Reference: presto_tpu/functions/scalar.py (with the overrides of its
other modules that change what these names compute: the integer `mod` of
scalar_ext.py; day_of_week, day_of_year and week_of_year of
scalar_ext.py and from_unixtime and to_unixtime of datetime_tz.py agree
with scalar.py's for the types ported).  Ported, 103 names:
- arithmetic (add, sub, mul, div, mod, neg) over the non-decimal numeric
  types, DATE +- INTERVAL, the six comparisons (numeric and temporal;
  strings against a literal, within one dictionary or across two, whose
  dictionaries then merge), three-valued AND / OR / NOT, numeric CASTs,
  IS NULL, COALESCE, NULLIF, IF, CASE, LIKE;
- strings: SUBSTRING / SUBSTR, UPPER, LOWER, TRIM, LTRIM, RTRIM,
  REVERSE, REPLACE, LENGTH, STRPOS, POSITION, STARTS_WITH, ENDS_WITH,
  CONTAINS_STR, LPAD, RPAD, REPEAT, SPLIT_PART, CODEPOINT, CHR (of a
  constant), CONCAT and `||`; REGEXP_LIKE, REGEXP_EXTRACT and
  REGEXP_REPLACE (Python's re; `$n` group references);
- math: ABS, ROUND, TRUNCATE, FLOOR, CEIL / CEILING, SIGN, SQRT, EXP,
  LN, LOG10, LOG(base, x), POWER / POW, ATAN2, PI, E, WIDTH_BUCKET,
  GREATEST, LEAST; bitwise AND, OR, XOR, NOT and the shifts;
- dates: the EXTRACT family (year, month, day, quarter, day of week,
  day of year, week), DATE(text), DATE_ADD, DATE_DIFF, DATE_TRUNC,
  LAST_DAY_OF_MONTH, DAY_OF_WEEK / DOW, DAY_OF_YEAR / DOY, WEEK_OF_YEAR
  / WEEK, FROM_UNIXTIME (one argument), TO_UNIXTIME;
- JSON over VARCHAR or JSON dictionaries: JSON_EXTRACT,
  JSON_EXTRACT_SCALAR, JSON_FORMAT, JSON_PARSE, JSON_ARRAY_LENGTH,
  JSON_SIZE, IS_JSON_SCALAR.
Not ported: the names of scalar.py that build or read ARRAY, MAP or ROW
values or T-digest and HLL sketches, the $hll_reg and $hll_rho of
distributed approx_distinct, its trigonometric family (sin .. exp2,
which scalar_ext.py registers again), DECIMAL arithmetic, and the
modules scalar_ext.py, scalar_ext2.py, datetime_tz.py, geospatial.py
and ml.py.  The planner resolves only registered names, so any other
function raises NotImplementedError with its name (plan/planner.py
`_call`).

String functions are host transforms over the dictionary (one Python
call per dictionary entry, never per row), kept beside the dictionary
(`Dictionary.derived`), followed by one lookup on the device through
`batch.upload`: a string result is a new sorted dictionary and a code
table, a BOOLEAN one a predicate table, a numeric one a value table.

Null semantics as in the reference: strict null propagation, except
AND/OR/IS NULL/COALESCE/NULLIF/IF/CASE, which implement SQL
three-valued logic, and integer `mod`, whose result is NULL for a zero
divisor.  Where torch and XLA differ, the reference's values are kept:
shift counts outside [0, 63] give 0, float -> int conversions give 0
for NaN and saturate, sign keeps -0.0 and NaN, log10 is ln(x) / ln(10).
"""

from __future__ import annotations

import json
import math
import operator
import re
from typing import Callable, Dict, Optional

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Dictionary, upload
from presto_tpu_torch.exec.colval import ColVal, all_valid, translate_codes

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
                return None  # decimal arithmetic is not ported
            return ct
        return None

    return resolve


def _date_plus_interval(name, a: ColVal, b: ColVal, valid) -> ColVal:
    if a.type.name != "DATE":
        raise NotImplementedError(
            f"{a.type} +- INTERVAL is not ported to presto_tpu_torch")
    x = a.data.to(torch.int64) if _is_tensor(a.data) else int(a.data)
    if b.type.name == "INTERVAL_DAY_TIME":
        delta = b.data if name == "add" else -b.data  # micros
        # whole result days (reference: joda plus + toDate)
        days = (x * _US_PER_DAY + delta) // _US_PER_DAY
        return ColVal(days.to(torch.int32) if _is_tensor(days) else int(days),
                      valid, T.DATE)
    months = b.data if name == "add" else -b.data
    return ColVal(add_months(x, months), valid, T.DATE)


def _emit_arith(name):
    def emit(args):
        a, b = args
        valid = all_valid(a, b)
        if a.type.name in _INTERVALS and b.type.name in _TEMPORAL:
            a, b = b, a  # interval + temporal commutes (add only)
        if b.type.name in _INTERVALS and a.type.name in _TEMPORAL:
            return _date_plus_interval(name, a, b, valid)
        out_t = T.common_super_type(a.type, b.type)
        x, y = a.data, b.data
        if name == "add":
            r = x + y
        elif name == "sub":
            r = x - y
        elif name == "mul":
            r = x * y
        elif name == "div":
            r = _int_div(x, y) if out_t.is_integer else x / y
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
    if len(args) == 2 and all(a.is_numeric and not a.is_decimal
                              for a in args):
        if all(a.is_integer for a in args):
            return T.common_super_type(*args)
        return T.DOUBLE
    return None


def _emit_mod(args):
    a, b = args
    t = _resolve_mod([a.type, b.type])
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
         and not args[0].is_decimal else None,
         lambda args: ColVal(-args[0].data, args[0].valid, args[0].type))


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
        return ColVal(_PYOPS[name](a.data, b.data), all_valid(a, b),
                      T.BOOLEAN)

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


def _emit_concat(args):
    out = args[0]
    for nxt in args[1:]:
        out = _concat_pair(out, nxt)
    return out


register("concat",
         lambda args: T.VARCHAR if all(a.is_string for a in args) else None,
         _emit_concat)


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
    scale = 10.0 ** d
    x = a.data
    if _is_tensor(x):
        r = torch.sign(x) * torch.floor(x.abs() * scale + 0.5) / scale
    else:
        x = float(x)
        r = float(np.sign(x) * np.floor(abs(x) * scale + 0.5) / scale)
    return ColVal(r, a.valid, a.type)


def _resolve_numeric1(args):
    return args[0] if args[0].is_numeric and not args[0].is_decimal \
        else None


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
# ln(x) / ln(10), as jnp.log10 computes it
register("log10", *_double1(lambda x: torch.log(x) / math.log(10.0),
                            lambda x: np.log(x) / math.log(10.0)))


def _same_type1(tfn, nfn):
    """numeric -> its own type; an integer argument comes back as it is
    (as jnp.floor and jnp.ceil leave integers)."""
    def emit(args):
        a = args[0]
        if a.type.is_integer:
            return a
        if _is_tensor(a.data):
            return ColVal(tfn(a.data), a.valid, a.type)
        with np.errstate(all="ignore"):
            return ColVal(float(nfn(np.float64(a.data))), a.valid, a.type)

    return (lambda args: args[0] if len(args) == 1 and args[0].is_numeric
            and not args[0].is_decimal else None), emit


register("floor", *_same_type1(torch.floor, np.floor))
register("ceil", *_same_type1(torch.ceil, np.ceil))
register("ceiling", *_same_type1(torch.ceil, np.ceil))


def _emit_sign(args):
    """sign as XLA computes it: -1, 0 or 1 for integers; a float's sign
    as -1.0 or 1.0, a zero and NaN returned as they are (-0.0 stays)."""
    a = args[0]
    x = a.data
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
         and not args[0].is_decimal else None,
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
register("log", *_double2(lambda b, x: torch.log(x) / torch.log(b),
                          lambda b, x: np.log(x) / np.log(b)))
register("pi", lambda args: T.DOUBLE if not args else None,
         lambda args: ColVal(float(np.pi), None, T.DOUBLE))
register("e", lambda args: T.DOUBLE if not args else None,
         lambda args: ColVal(float(np.e), None, T.DOUBLE))


def _emit_truncate(args):
    """truncate(x[, d]): toward zero at d decimal digits; an integer
    argument comes back as it is."""
    a = args[0]
    if a.type.is_integer:
        return a
    d = int(_constant("truncate", args[1])) if len(args) > 1 else 0
    scale = 10.0 ** d
    if _is_tensor(a.data):
        return ColVal(torch.trunc(a.data * scale) / scale, a.valid, a.type)
    return ColVal(float(np.trunc(float(a.data) * scale) / scale), a.valid,
                  a.type)


register("truncate", _resolve_numeric1, _emit_truncate)


def _emit_width_bucket(args):
    """width_bucket(x, lo, hi, n): floor((x - lo) / (hi - lo) * n) + 1
    clipped into [0, n + 1], NaN in bucket 0 (XLA's conversion)."""
    x = _f64(args[0].data)
    lo, hi, n = (a.data for a in args[1:])
    raw = (x - lo) / (hi - lo) * n
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


def _resolve_from_unixtime(args):
    if len(args) > 1:
        raise NotImplementedError(
            "from_unixtime with a time zone is not ported to "
            "presto_tpu_torch")
    return T.TIMESTAMP if args[0].is_numeric else None


register("from_unixtime", _resolve_from_unixtime,
         lambda args: ColVal(_f64_to_i64(_f64(args[0].data) * 1e6),
                             args[0].valid, T.TIMESTAMP))
register("to_unixtime",
         lambda args: T.DOUBLE if args and args[0].name in (
             "TIMESTAMP", "TIMESTAMP_TZ") else None,
         lambda args: ColVal(_scalar(_f64(args[0].data) / 1e6),
                             args[0].valid, T.DOUBLE))


# ---- casts ----------------------------------------------------------------


def emit_cast(v: ColVal, to: T.Type, safe: bool = False) -> ColVal:
    frm = v.type
    if frm == to:
        return v
    if frm.name == "UNKNOWN":  # CAST(NULL AS anything) == typed NULL
        return ColVal("" if to.is_string else to.numpy_dtype().type(0).item(),
                      False, to)
    if frm.name == "DATE" and to.name == "TIMESTAMP":
        d = v.data.to(torch.int64) if _is_tensor(v.data) else int(v.data)
        return ColVal(d * _US_PER_DAY, v.valid, T.TIMESTAMP)
    if frm.name == "TIMESTAMP" and to.name == "DATE":
        d = v.data // _US_PER_DAY
        return ColVal(d.to(torch.int32) if _is_tensor(d) else int(d),
                      v.valid, T.DATE)
    ok = (frm.is_numeric or frm.name == "BOOLEAN") \
        and (to.is_numeric or to.name == "BOOLEAN") \
        and not frm.is_decimal and not to.is_decimal
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
