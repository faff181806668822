"""Extended scalar functions: math, probability, strings, VARBINARY, URL,
zone-less dates, JSON and the array long tail.

Reference: presto_tpu/functions/scalar_ext.py, with the factories of
presto_tpu/functions/scalar.py that it calls.  Same conventions as
functions/scalar.py: numeric functions are torch elementwise over
float64 (a constant argument is a 0-d tensor on the session's device,
as the reference's is a 0-d array), string and VARBINARY functions are
host transforms once per dictionary entry whose tables reach the
device through `batch.upload`, strict NULL propagation unless noted.

Where torch lacks the reference's special function, the port writes it
from torch ops: the regularized incomplete beta (`betainc`, the
reference's Lentz continued fraction at a fixed iteration count), the
cube root (a pow and one Newton step) and the population count
(`_popcount`, SWAR on int64).  A DECIMAL argument of a math function is
read as its value (the reference reads the unscaled integer).  `mod`,
whose last registration is this module's in the reference, is
functions/scalar.py's.  Functions that format or convert column values
through Python (`to_base`, `date_format`, `to_big_endian_64`, ...) read
the column back to the host, as the reference does, so their static
pass falls back (`colval.refuse_host_read`).  A TIMESTAMP WITH TIME
ZONE argument of the date functions reaches them on its zone's wall
clock through functions/datetime_tz.py's wrappers, which register last.
"""

from __future__ import annotations

import base64
import binascii
import datetime as _dt
import hashlib
import hmac as _hmac
import json as _json
import math
import re
import struct
import unicodedata
import urllib.parse as _url
import zlib

import numpy as np
import torch

from presto_tpu_torch import session_ctx
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Dictionary, upload
from presto_tpu_torch.exec.colval import ColVal, all_valid, refuse_host_read
from presto_tpu_torch.functions import decimals as DEC
from presto_tpu_torch.functions.scalar import (
    _arr_entries, _clip_codes, _const_arg, _constant, _days_of, _emit_concat,
    _from_tables, _i64, _is_array, _is_tensor, _kept, _lookup,
    _result_tables, _shift_right_logical, _str_transform, _string_dictionary,
    _tuple_dictionary, civil_from_days, register)

true_div = DEC.true_div

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _device(*vals):
    for v in vals:
        if _is_tensor(v):
            return v.device
    return session_ctx.device()


def _as_f64(v: ColVal):
    """A numeric argument's value as float64: a tensor converted, a
    decimal read as its value, a python number kept."""
    if v.type.is_decimal:
        v = DEC.decimal_to_double(v)
    x = v.data
    return x.to(torch.float64) if _is_tensor(x) else float(x)


def _tensors(xs, dev=None):
    """Python numbers as 0-d float64 tensors on the device of the first
    tensor among xs (or the session's), filled there."""
    dev = dev or _device(*xs)
    return [x.to(torch.float64) if _is_tensor(x) else torch.full(
        (), float(x), dtype=torch.float64, device=dev) for x in xs]


def _math1d(fn):
    """1-arg numeric -> DOUBLE."""
    return (lambda args: T.DOUBLE if args[0].is_numeric else None,
            lambda args: ColVal(fn(_tensors([_as_f64(args[0])])[0]),
                                args[0].valid, T.DOUBLE))


def _mathNd(n, fn, valid_fn=None):
    """n-arg numeric -> DOUBLE elementwise.  fn gets the arguments as
    float64 tensors and their python values (None for a column), from
    which the continued fractions take their iteration counts."""

    def resolve(args):
        if len(args) == n and all(a.is_numeric for a in args):
            return T.DOUBLE
        return None

    def emit(args):
        raw = [_as_f64(a) for a in args]
        hosts = [None if _is_tensor(x) else x for x in raw]
        xs = _tensors(raw)
        out = fn(*xs, hosts=hosts)
        valid = all_valid(*args)
        if valid_fn is not None:
            ok = valid_fn(*xs)
            valid = ok if valid is None else (valid & ok)
        return ColVal(out, valid, T.DOUBLE)

    return resolve, emit


def _pred1d(fn):
    """1-arg numeric -> BOOLEAN."""
    return (lambda args: T.BOOLEAN if args[0].is_numeric else None,
            lambda args: ColVal(fn(_tensors([_as_f64(args[0])])[0]),
                                args[0].valid, T.BOOLEAN))


def _const(value, typ=T.DOUBLE):
    return (lambda args: typ if not args else None,
            lambda args: ColVal(value, None, typ))


def _literal(col: ColVal):
    """A string or VARBINARY literal's python value, else None."""
    return col.data if isinstance(col.data, (str, bytes)) else None


def _bytes_dictionary(values: list) -> tuple:
    """(codes, Dictionary) of host bytes values: sorted distinct values
    (reference: _obj_dict_normalize), kept as bytes objects."""
    uniq = sorted(set(values))
    index = {v: i for i, v in enumerate(uniq)}
    codes = np.fromiter((index[v] for v in values), np.int32, len(values))
    u = np.empty(len(uniq), dtype=object)
    u[:] = uniq
    return codes, Dictionary(u)


def _typed_dictionary(values: list, out_type: T.Type) -> tuple:
    if out_type.name == "VARBINARY":
        return _bytes_dictionary(values)
    return _string_dictionary(values)


def _values_table(values: list, out_type: T.Type) -> np.ndarray:
    if out_type.name == "BOOLEAN":
        return np.fromiter((bool(v) for v in values), bool, len(values))
    return np.asarray(values, dtype=out_type.numpy_dtype())


def _entry_tables(col: ColVal, key, fn, out_type: T.Type):
    """fn over every dictionary entry as (table, dictionary or None),
    kept beside the dictionary."""
    def compute():
        vals = [fn(v) for v in col.dictionary.values]
        if out_type.is_string:
            return _typed_dictionary(vals, out_type)
        return _values_table(vals, out_type), None

    return col.dictionary.derived(key, compute)


def _through(col: ColVal, tables, out_type: T.Type, valid) -> ColVal:
    lut, d = tables
    return ColVal(_lookup(col.data, lut), valid, out_type, d)


def _str_fn(name, fn, out_type=T.VARCHAR, in_name=None):
    """1-string-arg function over dictionary values; literals fold."""

    def resolve(args):
        if len(args) != 1 or not args[0].is_string:
            return None
        if in_name is not None and args[0].name != in_name:
            return None
        return out_type

    def emit(args):
        col = args[0]
        lit = _literal(col)
        if lit is not None:
            return ColVal(fn(lit), col.valid, out_type)
        return _through(col, _entry_tables(col, ("ext", name), fn, out_type),
                        out_type, col.valid)

    return resolve, emit


#: the most value pairs a dictionary x dictionary string function
#: materializes (the reference's bound)
STR2_PRODUCT_MAX = 1 << 18


def _str2_fn(name, fn, out_type):
    """2-string-arg function: literal x literal, column x literal,
    literal x column, and dictionary x dictionary through the value cross
    product (at most STR2_PRODUCT_MAX pairs)."""

    def resolve(args):
        if len(args) == 2 and all(a.is_string for a in args):
            return out_type
        return None

    def emit(args):
        a, b = args
        la, lb = _literal(a), _literal(b)
        valid = all_valid(a, b)
        if la is not None and lb is not None:
            return ColVal(fn(la, lb), valid, out_type)
        if lb is not None:
            return _through(a, _entry_tables(
                a, ("ext2", name, "r", lb), lambda v: fn(v, lb), out_type),
                out_type, valid)
        if la is not None:
            return _through(b, _entry_tables(
                b, ("ext2", name, "l", la), lambda v: fn(la, v), out_type),
                out_type, valid)
        if a.dictionary is not None and b.dictionary is not None \
                and len(a.dictionary) * len(b.dictionary) <= STR2_PRODUCT_MAX:
            na, nb = len(a.dictionary), len(b.dictionary)

            def product():
                vals = [fn(x, y) for x in a.dictionary.values
                        for y in b.dictionary.values]
                if out_type.is_string:
                    return _typed_dictionary(vals, out_type)
                return _values_table(vals, out_type), None

            lut, d = a.dictionary.derived(("ext2", name, b.dictionary),
                                          product)
            pair = _clip_codes(a.data, na) * nb + _clip_codes(b.data, nb)
            return ColVal(_lookup(pair, lut), valid, out_type, d)
        raise NotImplementedError(
            f"{name} over non-dictionary string columns")

    return resolve, emit


# ---------------------------------------------------------------------------
# math: trig, hyperbolic, conversions
# ---------------------------------------------------------------------------


def _cbrt(x):
    """The real cube root: |x|^(1/3) with the sign, then one Newton step
    (torch has no cbrt; the pow alone is off by ulps)."""
    y = torch.sign(x) * x.abs().pow(1.0 / 3.0)
    fix = y - true_div(y * y * y - x, 3.0 * y * y)
    return torch.where((y == 0) | ~torch.isfinite(y), y, fix)


_LN2 = math.log(2.0)

for _n, _f in (("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan),
               ("asin", torch.asin), ("acos", torch.acos),
               ("atan", torch.atan), ("sinh", torch.sinh),
               ("cosh", torch.cosh), ("tanh", torch.tanh), ("cbrt", _cbrt),
               # jnp.degrees and jnp.radians multiply by the constant
               ("degrees", lambda x: x * (180.0 / math.pi)),
               ("radians", lambda x: x * (math.pi / 180.0)),
               # jnp.log2 is ln(x) / ln(2)
               ("log2", lambda x: true_div(torch.log(x), _LN2)),
               ("exp2", torch.exp2)):
    register(_n, *_math1d(_f))
register("is_nan", *_pred1d(torch.isnan))
register("is_finite", *_pred1d(torch.isfinite))
register("is_infinite", *_pred1d(torch.isinf))
register("infinity", *_const(float("inf")))
register("nan", *_const(float("nan")))


def _popcount(x):
    """Set bits of int64 values, SWAR: every shift is masked by a
    constant whose top bit is clear, so torch's arithmetic shift serves
    as the logical one."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F  # nonnegative from here
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def _emit_bit_count(args):
    x = _i64(args[0].data)
    bits = 64 if len(args) < 2 else int(_constant("bit_count", args[1]))
    if bits < 64:
        x = x & ((1 << bits) - 1)
    if not _is_tensor(x):
        return ColVal(bin(x & ((1 << 64) - 1)).count("1"), args[0].valid,
                      T.BIGINT)
    return ColVal(_popcount(x), args[0].valid, T.BIGINT)


def _arith_shift_right(x, s):
    """x >> s on int64 as XLA shifts arithmetically: a count outside
    [0, 63] fills with the sign bit."""
    if not (_is_tensor(x) or _is_tensor(s)):
        return x >> s if 0 <= s < 64 else (-1 if x < 0 else 0)
    dev = _device(x, s)
    x, s = (v if _is_tensor(v) else torch.full((), v, dtype=torch.int64,
                                               device=dev) for v in (x, s))
    return torch.where((s >= 0) & (s < 64), x >> s.clamp(0, 63), x >> 63)


register("bit_count",
         lambda args: T.BIGINT if args and args[0].is_integer else None,
         _emit_bit_count)
register("bitwise_logical_shift_right",
         lambda args: T.BIGINT if len(args) == 2 else None,
         lambda args: ColVal(_shift_right_logical(*(_i64(a.data)
                                                    for a in args)),
                             all_valid(*args), T.BIGINT))
register("bitwise_arithmetic_shift_right",
         lambda args: T.BIGINT if len(args) == 2 else None,
         lambda args: ColVal(_arith_shift_right(*(_i64(a.data)
                                                  for a in args)),
                             all_valid(*args), T.BIGINT))


# ---------------------------------------------------------------------------
# the regularized incomplete beta function
# ---------------------------------------------------------------------------

#: the continued fraction's iteration count when a parameter is a
#: column (the reference's bound on its loop)
BETAINC_MAX_ITERS = 600
_EPS2 = float(np.finfo(np.float64).eps) / 2
_TINY2 = float(np.finfo(np.float64).tiny) * 2


def betainc_iters(*params) -> int:
    """Iterations that make the continued fraction converge to double
    precision for parameters up to the given magnitudes: fewer than
    2 sqrt(max(a, b)) + 31 over a seeded grid of x in (0, 1) and a, b
    from 0.1 to 10^7, so 64 + 2 sqrt(max) leaves room; a column
    parameter (None) takes BETAINC_MAX_ITERS.  A converged step
    multiplies by a factor within 2^-53 of 1, so the value depends on the
    count by less than 1e-13 relative (as the reference's does on the
    batch, whose loop runs until every lane converges)."""
    if any(p is None for p in params):
        return BETAINC_MAX_ITERS
    top = max([abs(float(p)) for p in params] + [1.0])
    if not math.isfinite(top):
        return BETAINC_MAX_ITERS
    return min(BETAINC_MAX_ITERS, 64 + int(math.ceil(2 * math.sqrt(top))))


def betainc(a, b, x, iters: int = BETAINC_MAX_ITERS):
    """I_x(a, b) of float64 tensors, as jax.scipy.special.betainc
    computes it (jax/_src/lax/special.py, regularized_incomplete_beta_
    impl): the Lentz-Thompson-Barnett continued fraction of DLMF 8.17.22
    after the symmetry 8.17.4 where x >= (a + 1) / (a + b + 2), at a fixed
    iteration count instead of a loop until every lane converges."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    one = torch.ones_like(x)
    a_zero = (a == 0) | (b == math.inf)
    b_zero = (b == 0) | (a == math.inf)
    x_zero, x_one = x == 0, x == 1
    is_nan = torch.isnan(a) | torch.isnan(b) | torch.isnan(x)
    res_zero = (b_zero & ~x_one) | (a_zero & x_zero)
    res_one = (a_zero & ~x_zero) | (b_zero & x_one)
    res_nan = (a < 0) | (b < 0) | (x < 0) | (x > 1) | (a_zero & b_zero) \
        | is_nan
    fast = x < true_div(a + 1, a + b + 2)
    a, b = torch.where(fast, a, b), torch.where(fast, b, a)
    x = torch.where(fast, x, 1 - x)
    small = torch.full_like(x, _EPS2)
    h = small  # the zeroth partial denominator is 0
    c, d = h, torch.zeros_like(x)
    apb = a + b
    zero_num = true_div(-apb * x, a + one)
    for it in range(1, iters + 1):
        if it == 1:
            num = one
        else:
            m = float((it - 1) // 2)
            if it % 2 == 0:
                num = zero_num if m == 0 else true_div(
                    -(a + m) * (apb + m) * x,
                    (a + 2 * m) * (a + 2 * m + 1))
            else:
                num = true_div(m * (b - m) * x,
                               (a + 2 * m - 1) * (a + 2 * m))
        c = 1 + true_div(num, c)
        c = torch.where(c.abs() < _EPS2, small, c)
        d = 1 + num * d
        d = torch.where(d.abs() < _EPS2, small, d)
        d = torch.reciprocal(d)
        h = h * (c * d)
    lb_small = torch.lgamma(b) - torch.lgamma(apb)
    lb = torch.lgamma(a) + lb_small
    factor = torch.where(
        a < _TINY2, torch.exp(torch.log1p(-x) * b - lb_small),
        true_div(torch.exp(torch.log(x) * a + torch.log1p(-x) * b - lb), a))
    r = h * factor
    r = torch.where(fast, r, 1 - r)
    r = torch.where(res_zero, torch.zeros_like(r), r)
    r = torch.where(res_one, torch.ones_like(r), r)
    return torch.where(res_nan, torch.full_like(r, math.nan), r)


# ---------------------------------------------------------------------------
# probability CDFs (reference: MathFunctions.java's *_cdf family)
# ---------------------------------------------------------------------------

_SQRT2 = math.sqrt(2.0)
_erf = torch.special.erf
_gammainc = torch.special.gammainc
_gammaincc = torch.special.gammaincc


def _half(x):
    return true_div(x, 2.0)


def _normal_cdf(mean, sd, v, hosts):
    return 0.5 * (1.0 + _erf(true_div(v - mean, sd * _SQRT2)))


def _binomial_cdf(n, p, s, hosts):
    fs = torch.floor(s)
    it = betainc_iters(hosts[0], hosts[2])
    inner = betainc(torch.maximum(n - fs, torch.ones_like(fs)), fs + 1.0,
                    1.0 - p, it)
    return torch.where(s >= n, torch.ones_like(inner),
                       torch.where(s < 0, torch.zeros_like(inner), inner))


def _f_cdf(d1, d2, v, hosts):
    return betainc(_half(d1), _half(d2), true_div(d1 * v, d1 * v + d2),
                   betainc_iters(*hosts[:2]))


def _wilson(sign):
    def fn(s, n, z, hosts):
        root = torch.sqrt(torch.clamp_min(
            true_div(s * (n - s), n) + true_div(z * z, 4.0), 0.0))
        return true_div(s + _half(z * z) + sign * z * root, n + z * z)

    return fn


for _n, _k, _f, _ok in (
        ("normal_cdf", 3, _normal_cdf, lambda mean, sd, v: sd > 0),
        ("cauchy_cdf", 3,
         lambda med, sc, v, hosts: true_div(torch.atan(true_div(v - med, sc)),
                                            math.pi) + 0.5,
         lambda med, sc, v: sc > 0),
        ("laplace_cdf", 3,
         lambda mean, sc, v, hosts: torch.where(
             v < mean, 0.5 * torch.exp(true_div(v - mean, sc)),
             1.0 - 0.5 * torch.exp(true_div(-(v - mean), sc))),
         lambda mean, sc, v: sc > 0),
        ("logistic_cdf", 3,
         lambda mean, sc, v, hosts: true_div(
             1.0, 1.0 + torch.exp(true_div(-(v - mean), sc))),
         lambda mean, sc, v: sc > 0),
        ("weibull_cdf", 3,
         lambda a, b, v, hosts: 1.0 - torch.exp(-torch.pow(
             true_div(torch.clamp_min(v, 0.0), b), a)),
         lambda a, b, v: (a > 0) & (b > 0)),
        ("poisson_cdf", 2,
         lambda lam, k, hosts: _gammaincc(torch.floor(k) + 1.0, lam),
         lambda lam, k: (lam > 0) & (k >= 0)),
        ("chi_squared_cdf", 2,
         lambda df, v, hosts: _gammainc(_half(df), _half(v)),
         lambda df, v: (df > 0) & (v >= 0)),
        ("gamma_cdf", 3,
         lambda shape, scale, v, hosts: _gammainc(shape, true_div(v, scale)),
         lambda shape, scale, v: (shape > 0) & (scale > 0) & (v >= 0)),
        ("beta_cdf", 3,
         lambda a, b, v, hosts: betainc(a, b, torch.clamp(v, 0.0, 1.0),
                                        betainc_iters(*hosts[:2])),
         lambda a, b, v: (a > 0) & (b > 0) & (v >= 0) & (v <= 1)),
        ("binomial_cdf", 3, _binomial_cdf,
         lambda n, p, s: (n > 0) & (p >= 0) & (p <= 1)),
        ("f_cdf", 3, _f_cdf, lambda d1, d2, v: (d1 > 0) & (d2 > 0) & (v >= 0)),
        ("wilson_interval_lower", 3, _wilson(-1.0),
         lambda s, n, z: (n > 0) & (s >= 0) & (s <= n) & (z > 0)),
        ("wilson_interval_upper", 3, _wilson(1.0),
         lambda s, n, z: (n > 0) & (s >= 0) & (s <= n) & (z > 0)),
        ("inverse_normal_cdf", 3,
         lambda mean, sd, p, hosts: mean + sd * _SQRT2 * torch.erfinv(
             2 * p - 1),
         lambda mean, sd, p: (sd > 0) & (p > 0) & (p < 1)),
        ("inverse_cauchy_cdf", 3,
         lambda med, sc, p, hosts: med + sc * torch.tan(math.pi * (p - 0.5)),
         lambda med, sc, p: (sc > 0) & (p > 0) & (p < 1))):
    register(_n, *_mathNd(_k, _f, _ok))


# ---------------------------------------------------------------------------
# bases
# ---------------------------------------------------------------------------


def _from_base(v, radix):
    return int(str(v).strip(), int(radix))


def _to_base(x, radix):
    x = int(x)
    radix = int(radix)
    if x == 0:
        return "0"
    digs = "0123456789abcdefghijklmnopqrstuvwxyz"
    neg = x < 0
    x = abs(x)
    out = []
    while x:
        out.append(digs[x % radix])
        x //= radix
    return ("-" if neg else "") + "".join(reversed(out))


register("from_base", *_str_transform("from_base", _from_base, T.BIGINT))


def _host_distinct(name: str, v: ColVal):
    """A column's distinct values and each row's index among them, read
    on the host (the reference's np.unique over the column)."""
    refuse_host_read(name)
    uniq, inv = np.unique(v.data.cpu().numpy(), return_inverse=True)
    return uniq, upload(inv.reshape(-1).astype(np.int32), v.data.device)


def _per_value(name, conv, out_type):
    """conv over a numeric or temporal column's distinct values (host),
    the results a new dictionary (reference: np.unique + normalize)."""
    def emit(args):
        x = args[0]
        extra = tuple(_constant(name, a) for a in args[1:])
        if not _is_tensor(x.data) or x.data.ndim == 0:
            if _is_tensor(x.data):
                refuse_host_read(name)
                val = x.data.item()
            else:
                val = x.data
            return ColVal(conv(val, *extra), x.valid, out_type)
        uniq, codes = _host_distinct(name, x)
        vals = [conv(u.item(), *extra) for u in uniq]
        lut, d = _typed_dictionary(vals, out_type)
        return ColVal(_lookup(codes, lut), x.valid, out_type, d)

    return emit


register("to_base",
         lambda args: T.VARCHAR if len(args) == 2 and args[0].is_integer
         else None,
         _per_value("to_base", _to_base, T.VARCHAR))


# ---------------------------------------------------------------------------
# string distance and shaping
# ---------------------------------------------------------------------------


def _levenshtein(a, b):
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _hamming(a, b):
    if len(a) != len(b):
        raise ValueError("hamming_distance: equal lengths required")
    return sum(x != y for x, y in zip(a, b))


def _jaccard(a, b):
    return (len(set(a) & set(b)) / len(set(a) | set(b))) if (a or b) else 1.0


register("levenshtein_distance",
         *_str2_fn("levenshtein_distance", _levenshtein, T.BIGINT))
register("hamming_distance", *_str2_fn("hamming_distance", _hamming, T.BIGINT))
register("jaccard_index", *_str2_fn("jaccard_index", _jaccard, T.DOUBLE))


def _translate(v, frm, to):
    table = {}
    for i, c in enumerate(str(frm)):
        table[ord(c)] = str(to)[i] if i < len(str(to)) else None
    return v.translate(table)


def _normalize(v, form="NFC"):
    return unicodedata.normalize(str(form), v)


def _soundex(v):
    if not v:
        return ""
    v = v.upper()
    codes = {"B": "1", "F": "1", "P": "1", "V": "1",
             "C": "2", "G": "2", "J": "2", "K": "2", "Q": "2", "S": "2",
             "X": "2", "Z": "2", "D": "3", "T": "3", "L": "4",
             "M": "5", "N": "5", "R": "6"}
    out = [v[0]]
    last = codes.get(v[0], "")
    for c in v[1:]:
        code = codes.get(c, "")
        if code and code != last:
            out.append(code)
        if c not in "HW":
            last = code
    return ("".join(out) + "000")[:4]


register("translate", *_str_transform("translate", _translate))
register("normalize", *_str_transform("normalize", _normalize))
register("soundex", *_str_transform("soundex", _soundex))


def _from_utf8(v):
    return (v if isinstance(v, bytes) else str(v).encode()).decode(
        "utf-8", "replace")


def _to_utf8(v):
    return v.encode() if isinstance(v, str) else bytes(v)


register("from_utf8", *_str_fn("from_utf8", _from_utf8, T.VARCHAR))
register("to_utf8", *_str_fn("to_utf8", _to_utf8, T.VARBINARY))


# ---------------------------------------------------------------------------
# regular expressions, the long tail
# ---------------------------------------------------------------------------


def _regexp_count(v, pat):
    return len(re.compile(str(pat)).findall(v))


def _regexp_position(v, pat, start=1):
    m = re.compile(str(pat)).search(v, int(start) - 1)
    return -1 if m is None else m.start() + 1


register("regexp_count",
         *_str_transform("regexp_count", _regexp_count, T.BIGINT))
register("regexp_position",
         *_str_transform("regexp_position", _regexp_position, T.BIGINT))


def _regexp_array(name, per_value):
    rt = T.array_of(T.VARCHAR)

    def emit(args):
        col = args[0]
        extra = tuple(_constant(name, a) for a in args[1:])
        lit = _literal(col)
        if lit is not None:
            d = np.empty(1, dtype=object)
            d[0] = tuple(per_value(lit, *extra))
            return ColVal(0, col.valid, rt, Dictionary(d))

        def compute():
            return _tuple_dictionary(
                [tuple(per_value(v, *extra)) for v in col.dictionary.values]
                or [()])

        lut, d = col.dictionary.derived(("ext", name, extra), compute)
        return ColVal(_lookup(col.data, lut), col.valid, rt, d)

    return (lambda args: rt if args and args[0].is_string else None), emit


def _extract_all(v, pat, group=0):
    return [m.group(int(group)) for m in re.compile(str(pat)).finditer(v)]


def _split_rx(v, pat):
    return re.compile(str(pat)).split(v)


register("regexp_extract_all", *_regexp_array("regexp_extract_all",
                                               _extract_all))
register("regexp_split", *_regexp_array("regexp_split", _split_rx))


# ---------------------------------------------------------------------------
# VARBINARY codecs and hashes (VarbinaryFunctions, HmacFunctions)
# ---------------------------------------------------------------------------


def _as_bytes(v):
    return v if isinstance(v, bytes) else str(v).encode()


def _bin_fn(name, fn, out_type=T.VARBINARY):
    return _str_fn(name, lambda v: fn(_as_bytes(v)), out_type)


def _xxh64(data: bytes, seed: int = 0) -> int:
    """xxHash64 of a byte string (the public-domain algorithm)."""
    P1, P2, P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
    P4, P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
    M = (1 << 64) - 1

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M

    def round_(v, lane):
        return (rotl((v + lane * P2) & M, 31) * P1) & M

    n = len(data)
    i = 0
    if n >= 32:
        acc = [(seed + P1 + P2) & M, (seed + P2) & M, seed & M,
               (seed - P1) & M]
        while i <= n - 32:
            acc = [round_(v, int.from_bytes(data[i + 8 * k:i + 8 * k + 8],
                                            "little"))
                   for k, v in enumerate(acc)]
            i += 32
        h = (rotl(acc[0], 1) + rotl(acc[1], 7) + rotl(acc[2], 12)
             + rotl(acc[3], 18)) & M
        for v in acc:
            h = ((h ^ round_(0, v)) * P1 + P4) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while i <= n - 8:
        h ^= round_(0, int.from_bytes(data[i:i + 8], "little"))
        h = (rotl(h, 27) * P1 + P4) & M
        i += 8
    if i <= n - 4:
        h ^= (int.from_bytes(data[i:i + 4], "little") * P1) & M
        h = (rotl(h, 23) * P2 + P3) & M
        i += 4
    while i < n:
        h ^= (data[i] * P5) & M
        h = (rotl(h, 11) * P1) & M
        i += 1
    h ^= h >> 33
    h = (h * P2) & M
    h ^= h >> 29
    h = (h * P3) & M
    h ^= h >> 32
    return h


def _signed64(u):
    return u - (1 << 64) if u >= (1 << 63) else u


register("to_hex", *_bin_fn("to_hex", lambda b: b.hex().upper(), T.VARCHAR))
register("from_hex", *_str_fn(
    "from_hex", lambda v: binascii.unhexlify(
        v if isinstance(v, str) else v.decode()), T.VARBINARY))
register("to_base64", *_bin_fn(
    "to_base64", lambda b: base64.b64encode(b).decode(), T.VARCHAR))
register("from_base64", *_str_fn(
    "from_base64", lambda v: base64.b64decode(_as_bytes(v) + b"=="),
    T.VARBINARY))
register("to_base64url", *_bin_fn(
    "to_base64url", lambda b: base64.urlsafe_b64encode(b).decode(),
    T.VARCHAR))
register("from_base64url", *_str_fn(
    "from_base64url",
    lambda v: base64.urlsafe_b64decode(_as_bytes(v) + b"=="), T.VARBINARY))
for _alg in ("md5", "sha1", "sha256", "sha512"):
    register(_alg, *_bin_fn(
        _alg, (lambda alg: lambda b: hashlib.new(alg, b).digest())(_alg)))
    register(f"hmac_{_alg}", *_str2_fn(
        f"hmac_{_alg}", (lambda alg: lambda v, key: _hmac.new(
            _as_bytes(key), _as_bytes(v), alg).digest())(_alg),
        T.VARBINARY))
register("crc32", *_bin_fn("crc32", lambda b: zlib.crc32(b) & 0xFFFFFFFF,
                           T.BIGINT))
register("xxhash64", *_bin_fn(
    "xxhash64", lambda b: struct.pack(">q", _signed64(_xxh64(b)))))


def _pack(fmt):
    return lambda u: struct.pack(fmt, u)


for _n, _fmt, _kind in (("to_big_endian_64", ">q", "is_integer"),
                        ("to_big_endian_32", ">i", "is_integer"),
                        ("to_ieee754_64", ">d", "is_numeric"),
                        ("to_ieee754_32", ">f", "is_numeric")):
    register(_n,
             (lambda kind: lambda args: T.VARBINARY
              if args and getattr(args[0], kind) else None)(_kind),
             _per_value(_n, _pack(_fmt), T.VARBINARY))
for _n, _fmt, _t in (("from_big_endian_64", ">q", T.BIGINT),
                     ("from_big_endian_32", ">i", T.INTEGER),
                     ("from_ieee754_64", ">d", T.DOUBLE),
                     ("from_ieee754_32", ">f", T.REAL)):
    register(_n, *_str_fn(
        _n, (lambda fmt: lambda v: struct.unpack(fmt, _as_bytes(v))[0])(_fmt),
        _t, in_name="VARBINARY"))


# ---------------------------------------------------------------------------
# URL functions (UrlFunctions.java)
# ---------------------------------------------------------------------------


def _url_part(part):
    def fn(v):
        u = _url.urlparse(v)
        if part == "host":
            return u.hostname or ""
        return {"protocol": u.scheme, "path": u.path, "query": u.query,
                "fragment": u.fragment}[part]

    return fn


def _url_parameter(v, name):
    return _url.parse_qs(_url.urlparse(v).query).get(str(name), [""])[0]


for _p in ("protocol", "host", "path", "query", "fragment"):
    register(f"url_extract_{_p}",
             *_str_transform(f"url_extract_{_p}", _url_part(_p)))
register("url_extract_port", *_str_transform(
    "url_extract_port", lambda v: _url.urlparse(v).port or -1, T.BIGINT))
register("url_extract_parameter",
         *_str_transform("url_extract_parameter", _url_parameter))
register("url_encode", *_str_transform("url_encode", _url.quote_plus))
register("url_decode", *_str_transform("url_decode", _url.unquote_plus))


# ---------------------------------------------------------------------------
# zone-less dates (DateTimeFunctions.java)
# ---------------------------------------------------------------------------

_US_PER_DAY = 86_400_000_000


def _ts_micros(v: ColVal):
    """TIMESTAMP micros; a DATE widens to midnight."""
    d = v.data
    if _is_tensor(d):
        d = d.to(torch.int64)
    return d * _US_PER_DAY if v.type.name == "DATE" else d


def _time_field(name, div, mod):
    return (lambda args: T.BIGINT if args and args[0].is_temporal
            else None,
            lambda args: ColVal(_ts_micros(args[0]) // div % mod,
                                args[0].valid, T.BIGINT))


for _n, _div, _mod in (("hour", 3_600_000_000, 24), ("minute", 60_000_000, 60),
                       ("second", 1_000_000, 60), ("millisecond", 1_000, 1000)):
    register(_n, *_time_field(_n, _div, _mod))


def _days64(v: ColVal):
    d = _days_of(v)
    return d.to(torch.int64) if _is_tensor(d) else int(d)


def _iso_week_year(days):
    """ISO-8601 week-year: the year of the week's Thursday."""
    return civil_from_days(days - (days + 3) % 7 + 3)[0]


def _day_field(name, fn):
    return (lambda args: T.BIGINT if args and args[0].is_temporal
            else None,
            lambda args: ColVal(fn(_days64(args[0])), args[0].valid,
                                T.BIGINT))


register("day_of_month", *_day_field("day_of_month",
                                     lambda d: civil_from_days(d)[2]))
for _n in ("year_of_week", "yow"):
    register(_n, *_day_field(_n, _iso_week_year))

_MYSQL_FMT = {
    "%Y": "%Y", "%y": "%y", "%m": "%m", "%c": "%-m", "%d": "%d",
    "%e": "%-d", "%H": "%H", "%k": "%-H", "%i": "%M", "%s": "%S",
    "%f": "%f", "%p": "%p", "%h": "%I", "%I": "%I", "%j": "%j",
    "%a": "%a", "%W": "%A", "%M": "%B", "%b": "%b", "%T": "%H:%M:%S",
    "%%": "%%",
}


def _mysql_to_strftime(fmt):
    out = []
    i = 0
    while i < len(fmt):
        if fmt[i] == "%" and i + 1 < len(fmt):
            tok = fmt[i:i + 2]
            out.append(_MYSQL_FMT.get(tok, tok[1]))
            i += 2
        else:
            out.append(fmt[i])
            i += 1
    return "".join(out)


_JODA_FMT = [
    ("yyyy", "%Y"), ("yy", "%y"), ("MMMM", "%B"), ("MMM", "%b"),
    ("MM", "%m"), ("M", "%-m"), ("dd", "%d"), ("d", "%-d"),
    ("HH", "%H"), ("H", "%-H"), ("hh", "%I"), ("h", "%-I"),
    ("mm", "%M"), ("m", "%-M"), ("ss", "%S"), ("s", "%-S"),
    ("SSS", "%f"), ("a", "%p"), ("EEEE", "%A"), ("EEE", "%a"),
    ("DDD", "%j"), ("ZZ", "+00:00"), ("Z", "+0000"),
]


def _joda_to_strftime(fmt):
    out = []
    i = 0
    while i < len(fmt):
        if fmt[i] == "'":
            j = fmt.find("'", i + 1)
            if j == i + 1:
                out.append("'")
                i += 2
                continue
            out.append(fmt[i + 1:j if j > 0 else len(fmt)])
            i = (j if j > 0 else len(fmt)) + 1
            continue
        for tok, rep in _JODA_FMT:
            if fmt.startswith(tok, i):
                out.append(rep)
                i += len(tok)
                break
        else:
            out.append(fmt[i])
            i += 1
    return "".join(out)


def _dt_of_micros(us):
    return _dt.datetime(1970, 1, 1) + _dt.timedelta(microseconds=int(us))


def _strftime_portable(dtv, fmt):
    """strftime with the unpadded %-m style expanded by hand."""
    def sub(m):
        return str({"m": dtv.month, "d": dtv.day, "H": dtv.hour,
                    "I": (dtv.hour % 12) or 12, "M": dtv.minute,
                    "S": dtv.second}[m.group(1)])

    return dtv.strftime(re.sub(r"%-([mdHIMS])", sub, fmt))


def _temporal_text(name, to_strftime):
    def conv(us, fmt):
        return _strftime_portable(_dt_of_micros(us), to_strftime(str(fmt)))

    per = _per_value(name, conv, T.VARCHAR)

    def emit(args):
        v = args[0]
        return per([ColVal(_ts_micros(v), v.valid, T.TIMESTAMP), args[1]])

    return (lambda args: T.VARCHAR if len(args) == 2
            and args[0].is_temporal else None), emit


register("date_format", *_temporal_text("date_format", _mysql_to_strftime))
register("format_datetime",
         *_temporal_text("format_datetime", _joda_to_strftime))
register("to_char", *_temporal_text("to_char", _joda_to_strftime))


def _emit_to_iso8601(args):
    v = args[0]
    if v.type.name == "DATE":
        def conv(x):
            return (_dt.date(1970, 1, 1) + _dt.timedelta(days=int(x))) \
                .isoformat()
    else:
        def conv(x):
            return _dt_of_micros(x).isoformat() + "Z"
    return _per_value("to_iso8601", conv, T.VARCHAR)(args)


register("to_iso8601",
         lambda args: T.VARCHAR if args and args[0].is_temporal else None,
         _emit_to_iso8601)


def _parse_to_micros(v, fmt):
    d = _dt.datetime.strptime(str(v).strip(), fmt)
    return int((d - _dt.datetime(1970, 1, 1)).total_seconds() * 1e6)


def _date_parse(v, fmt):
    return _parse_to_micros(v, _mysql_to_strftime(str(fmt)))


def _parse_datetime(v, fmt):
    return _parse_to_micros(v, _joda_to_strftime(str(fmt))
                            .replace("+00:00", "%z").replace("+0000", "%z"))


def _from_iso8601_date(v):
    return (_dt.date.fromisoformat(str(v)) - _dt.date(1970, 1, 1)).days


def _from_iso8601_timestamp(v):
    return int((_dt.datetime.fromisoformat(str(v).replace("Z", "+00:00"))
                .replace(tzinfo=None) - _dt.datetime(1970, 1, 1))
               .total_seconds() * 1e6)


def _to_date(v, fmt):
    return _parse_to_micros(v, _joda_to_strftime(str(fmt))) // _US_PER_DAY


def _to_timestamp(v, fmt):
    return _parse_to_micros(v, _joda_to_strftime(str(fmt)))


def _parse_duration(v):
    m = re.fullmatch(r"\s*([\d.]+)\s*(ns|us|ms|s|m|h|d)\s*", str(v))
    if not m:
        raise ValueError(f"invalid duration: {v}")
    mult = {"ns": 1e-3, "us": 1.0, "ms": 1e3, "s": 1e6, "m": 6e7,
            "h": 3.6e9, "d": 8.64e10}[m.group(2)]
    return int(float(m.group(1)) * mult)


for _n, _f, _t in (("date_parse", _date_parse, T.TIMESTAMP),
                   ("parse_datetime", _parse_datetime, T.TIMESTAMP),
                   ("from_iso8601_date", _from_iso8601_date, T.DATE),
                   ("from_iso8601_timestamp", _from_iso8601_timestamp,
                    T.TIMESTAMP),
                   ("to_date", _to_date, T.DATE),
                   ("to_timestamp", _to_timestamp, T.TIMESTAMP),
                   ("parse_duration", _parse_duration, T.INTERVAL_DAY_TIME)):
    register(_n, *_str_transform(_n, _f, _t))
register("to_milliseconds",
         lambda args: T.BIGINT if args
         and args[0].name == "INTERVAL_DAY_TIME" else None,
         lambda args: ColVal(_i64(args[0].data) // 1000, args[0].valid,
                             T.BIGINT))


# ---------------------------------------------------------------------------
# JSON long tail
# ---------------------------------------------------------------------------


def _json_array_get(v, idx):
    try:
        arr = _json.loads(v)
        if not isinstance(arr, list):
            return None
        i = int(idx)
        if i < 0:
            i += len(arr)
        if not 0 <= i < len(arr):
            return None
        e = arr[i]
        return e if isinstance(e, str) else _json.dumps(e)
    except ValueError:
        return None


def _json_array_contains(v, needle):
    try:
        arr = _json.loads(v)
        return isinstance(arr, list) and needle in arr
    except ValueError:
        return False


register("json_array_get",
         *_str_transform("json_array_get", _json_array_get, T.JSON))


def _emit_json_array_contains(args):
    col, needle = args
    nv = _constant("json_array_contains", needle)
    if needle.type == T.BOOLEAN:
        nv = bool(nv)
    elif needle.type.is_integer:
        nv = int(nv)
    elif needle.type.is_floating:
        nv = float(nv)
    lit = _literal(col)
    if lit is not None:
        return ColVal(_json_array_contains(lit, nv), col.valid, T.BOOLEAN)
    return _through(col, _entry_tables(
        col, ("json_array_contains", nv, type(nv)),
        lambda v: _json_array_contains(v, nv), T.BOOLEAN), T.BOOLEAN,
        col.valid)


register("json_array_contains",
         lambda args: T.BOOLEAN if len(args) == 2 and args[0].is_string
         else None, _emit_json_array_contains)


# ---------------------------------------------------------------------------
# arrays long tail
# ---------------------------------------------------------------------------


def _array_fn(name, fn, rt_fn):
    """fn over every array entry with constant extra arguments, kept
    beside the dictionary; an entry whose call raises is NULL, and so is
    a None result (reference: _array_transform).  rt_fn gives the result
    type from the argument types."""
    def emit(args):
        col = args[0]
        extra = tuple(_const_arg(name, a) for a in args[1:])
        rt = rt_fn([a.type for a in args])

        def compute():
            outs = []
            for t in _arr_entries(col):
                try:
                    outs.append(fn(tuple(t), *extra))
                except (ValueError, IndexError, TypeError):
                    outs.append(None)
            return _result_tables(outs, rt)

        return _from_tables(col, rt, _kept(col, ("ext", name, extra, rt),
                                           compute))

    return emit


def _array_rt(rt_of_array):
    """The resolve of a one-array function: rt_of_array(array type)."""
    return lambda args: rt_of_array(args[0]) if args and _is_array(
        args[0]) else None


def _array_sum(t):
    return sum(x for x in t if x is not None and isinstance(x, (int, float)))


def _array_average(t):
    present = [x for x in t if x is not None]
    return float(np.mean(present)) if present else None


def _array_duplicates(t):
    return tuple(sorted({x for x in t if t.count(x) > 1}, key=repr))


for _n, _f, _rt in (
        ("array_sum", _array_sum,
         lambda at: T.DOUBLE if at.params[0].is_floating else T.BIGINT),
        ("array_average", _array_average, lambda at: T.DOUBLE),
        ("array_duplicates", _array_duplicates, lambda at: at),
        ("array_has_duplicates", lambda t: len(set(t)) != len(t),
         lambda at: T.BOOLEAN)):
    register(_n, _array_rt(_rt), _array_fn(_n, _f, _array_rt(_rt)))


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------

register("typeof", lambda args: T.VARCHAR if len(args) == 1 else None,
         lambda args: ColVal(str(args[0].type), None, T.VARCHAR))


def _emit_concat_ws(args):
    sep = args[0]
    s = sep.data if isinstance(sep.data, str) else None
    if s is None:
        raise NotImplementedError("concat_ws with non-constant separator")
    parts = []
    for i, a in enumerate(args[1:]):
        if i:
            parts.append(ColVal(s, None, T.VARCHAR))
        parts.append(a)
    return _emit_concat(parts)


register("concat_ws",
         lambda args: T.VARCHAR if len(args) >= 2
         and all(a.is_string for a in args) else None, _emit_concat_ws)
