"""Scalar function registry: SQL-level signature resolution + torch emission.

Reference: presto_tpu/functions/scalar.py.  This slice ports the subset
TPC-H Q1 and Q6 reach: arithmetic (add, sub, mul, div, mod, neg) over
the non-decimal numeric types, DATE +- INTERVAL, the six comparisons
(numeric and temporal; strings against a literal or within one
dictionary), the three-valued AND / OR / NOT that BETWEEN and its
negation lower to, and numeric CASTs.  The planner resolves only
registered names, so any other function raises NotImplementedError with
its name (plan/planner.py `_call`).

Null semantics as in the reference: strict null propagation, except
AND/OR, which implement SQL three-valued logic.
"""

from __future__ import annotations

import operator
from typing import Callable, Dict

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.exec.colval import ColVal, all_valid

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
        dim = torch.tensor(_DIM, dtype=torch.int64, device=m.device)[m - 1]
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
            if out_t.is_integer:
                # SQL integer division truncates toward zero
                if _is_tensor(x) or _is_tensor(y):
                    r = torch.div(torch.as_tensor(x), torch.as_tensor(y),
                                  rounding_mode="trunc")
                else:
                    q = abs(x) // abs(y)
                    r = -q if (x < 0) != (y < 0) else q
            else:
                r = x / y
        elif name == "mod":
            if _is_tensor(x) or _is_tensor(y):
                r = torch.fmod(torch.as_tensor(x), torch.as_tensor(y))
            else:
                r = float(np.fmod(x, y)) if out_t.is_floating \
                    else int(np.fmod(x, y))
        else:
            raise AssertionError(name)
        return ColVal(r, valid, out_t)

    return emit


for _n in ("add", "sub", "mul", "div", "mod"):
    register(_n, _resolve_arith(_n), _emit_arith(_n))

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


def _dictionary_lut(col: ColVal, fn) -> torch.Tensor:
    """Evaluate a predicate once per dictionary entry on the host, then
    gather it through the codes on the device."""
    n = len(col.dictionary)
    if n == 0:
        return torch.zeros_like(col.data, dtype=torch.bool)
    lut = torch.from_numpy(np.asarray(
        [bool(fn(v)) for v in col.dictionary.values], dtype=bool))
    return lut.to(col.data.device)[col.data.clamp(0, n - 1).long()]


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
    raise NotImplementedError(
        "comparing string columns with different dictionaries is not ported")


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
