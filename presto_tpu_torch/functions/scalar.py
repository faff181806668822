"""Scalar function registry: SQL-level signature resolution + torch emission.

Reference: presto_tpu/functions/scalar.py (and the integer `mod` of
presto_tpu/functions/scalar_ext.py, which overrides it there). Ported so
far, the functions the 22 TPC-H and 99 TPC-DS queries reach: arithmetic
(add, sub, mul, div, mod, neg) over the non-decimal numeric types, ABS
and ROUND, DATE +- INTERVAL, the six comparisons (numeric and temporal;
strings against a literal, within one dictionary or across two, whose
dictionaries then merge), the three-valued AND / OR / NOT, numeric
CASTs, IS NULL, COALESCE, NULLIF, IF, CASE, LIKE, SUBSTRING / SUBSTR,
UPPER, CONCAT and `||` over strings, and the EXTRACT family (year,
month, day, quarter, day of week, day of year, week). The planner
resolves only registered names, so any other function raises
NotImplementedError with its name (plan/planner.py `_call`).

String functions are host transforms over the dictionary (one Python
call per dictionary entry, never per row) followed by one code lookup
on the device, as in the reference.

Null semantics as in the reference: strict null propagation, except
AND/OR/IS NULL/COALESCE/NULLIF/IF/CASE, which implement SQL
three-valued logic, and integer `mod`, whose result is NULL for a zero
divisor.
"""

from __future__ import annotations

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


def _str_transform(name, fn):
    """A VARCHAR -> VARCHAR function of constant extra arguments, run
    once per dictionary entry on the host."""
    def emit(args):
        col = args[0]
        extra = []
        for a in args[1:]:
            if _is_tensor(a.data) and a.data.ndim > 0:
                raise NotImplementedError(
                    f"{name} with non-constant arguments is not ported")
            extra.append(a.data.item() if _is_tensor(a.data) else a.data)
        if isinstance(col.data, str):
            return ColVal(fn(col.data, *extra), col.valid, T.VARCHAR)
        lut, out = _transform_lut(col.dictionary, fn, tuple(extra))
        return ColVal(_gather_lut(col, lut), col.valid, T.VARCHAR, out)

    return (lambda args: T.VARCHAR if args[0].is_string else None), emit


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


def _extract_emit(field):
    def emit(args):
        v = args[0]
        days = v.data
        if v.type.name == "TIMESTAMP":
            days = days // _US_PER_DAY
        days = days.to(torch.int64) if _is_tensor(days) else int(days)
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
