"""DECIMAL arithmetic, negation, comparisons, casts and truncate.

Reference: presto_tpu/functions/scalar.py (`_decimal_result_type`,
`_emit_decimal_arith`, `_emit_decimal_arith_long`, `_check_dec38`,
`_rescale_dec`, `_emit_neg`, the long branch of `_emit_cmp`,
`_emit_cast_decimal`, `_emit_truncate`).  A short decimal (precision up
to 18) is a scaled int64, a long one (n, 2) Int128 limbs
(exec/dec128.py); a literal is a python int holding the unscaled value.
Literal operands fold on the host, exactly.

Where the reference checks a value on the host (the float64 shadow of an
int64 product or rescale, the 38-digit bound, the fit of a narrowing
cast), the port checks on the device (`colval.check_rows`): in the
static executor's pass the check becomes one of its guards, so a
compiled query that overflows reruns in the dynamic executor, which
reads the check back once and raises the reference's error.
"""

from __future__ import annotations

import decimal as _d
import math

import numpy as np
import torch

from presto_tpu_torch import types as T
from presto_tpu_torch.exec import dec128 as D128
from presto_tpu_torch.exec.colval import ColVal, check_rows

_PREC = 80  # decimal context precision: the default 28 cannot hold 38 digits


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def is_long(t: T.Type) -> bool:
    return t.is_decimal and t.is_long_decimal


def dec_scale(t: T.Type) -> int:
    return t.decimal_scale if t.is_decimal else 0


def decimal_result_type(name: str, at: T.Type, bt: T.Type) -> T.Type:
    """Presto decimal result typing: integers coerce as decimal(18,0);
    precision growth past 18 switches to two-limb Int128 storage."""
    da = at if at.is_decimal else T.decimal(18, 0)
    db = bt if bt.is_decimal else T.decimal(18, 0)
    return T.decimal_add_type(da, db) if name in ("add", "sub") \
        else T.decimal_mul_type(da, db)


def _sign(x):
    return torch.sign(x) if _is_tensor(x) else (x > 0) - (x < 0)


def _abs(x):
    return x.abs() if _is_tensor(x) else abs(x)


def _f64(x):
    return x.to(torch.float64) if _is_tensor(x) else float(x)


def strong_f64(v) -> bool:
    """Whether v is a float64 that the reference holds as a strongly
    typed value: an f64 tensor (a 0-d one too), or a numpy float64 (the
    port's host value of a constant the reference computes with jnp and
    an astype(float64)).  A Python float is weakly typed in both."""
    return (_is_tensor(v) and v.dtype == torch.float64) \
        or type(v) is np.float64


def jax_float_promote(x, y):
    """x and y with an f32 tensor widened to f64 where the other side is
    a strong f64 (see strong_f64), 0-d too: jnp promotes so, while
    torch keeps f32 when the f64 side is 0-d or a scalar.  It matters
    under float32_compute, whose DOUBLE columns are f32."""
    if _is_tensor(x) and x.dtype == torch.float32 and strong_f64(y):
        x = x.to(torch.float64)
    if _is_tensor(y) and y.dtype == torch.float32 and strong_f64(x):
        y = y.to(torch.float64)
    return x, y


def true_div(x, y):
    """x / y in IEEE division on every device, as XLA divides, in the
    dtype jnp's promotion gives: float32 where a side is an f32 tensor
    (a float32_compute DOUBLE column) and no side is a strong f64
    (strong_f64), else float64.  torch divides a CUDA tensor by a host
    scalar by multiplying with the scalar's reciprocal, and a scalar by a
    tensor through the tensor's reciprocal, either one ulp off at times
    (5.0 / 3 gives 1.6666666666666665 so), so a scalar side becomes a 0-d
    tensor on the other's device.  A 0-d CPU tensor beside a CUDA tensor
    is a host scalar to torch as well: it moves to the other's device."""
    if not _is_tensor(x) and not _is_tensor(y):
        with np.errstate(divide="ignore", invalid="ignore"):
            return (np.float64(x) / np.float64(y)).item()
    dev = next((v.device for v in (x, y)
                if _is_tensor(v) and v.device.type != "cpu"),
               (x if _is_tensor(x) else y).device)
    f32 = any(_is_tensor(v) and v.dtype == torch.float32 for v in (x, y)) \
        and not any(strong_f64(v) for v in (x, y))
    dt = torch.float32 if f32 else torch.float64
    x, y = (v.to(device=dev if v.ndim == 0 else v.device,
                 dtype=dt) if _is_tensor(v) else torch.full(
        (), float(v), dtype=dt, device=dev) for v in (x, y))
    return torch.div(x, y)


def _valid_mask(valid):
    """The rows an overflow check reads: None (all) unless valid is a
    mask."""
    return valid if _is_tensor(valid) and valid.ndim > 0 else None


def check_unscaled(shadow, valid, what: str) -> None:
    """The reference's float64-shadow guard of the int64 unscaled range
    (types.check_decimal_overflow) on the device; NULL lanes excluded."""
    msg = (f"DECIMAL overflow: {what} exceeds the int64 unscaled range "
           "(~19 significant digits)")
    if not _is_tensor(shadow):
        if valid is False:
            return
        if abs(shadow) >= T.DECIMAL_UNSCALED_LIMIT:
            raise ValueError(msg)
        return
    bad = shadow.abs() >= T.DECIMAL_UNSCALED_LIMIT  # NaN is never bad
    v = _valid_mask(valid)
    if v is not None:
        bad = bad & v
    elif valid is False:
        return
    check_rows(bad, msg)


def rescale_dec(data, frm_scale: int, to_scale: int, valid=None):
    """Rescale a scaled-int64 decimal; rounds half away from zero when
    reducing scale (Presto decimal rounding)."""
    if to_scale == frm_scale:
        return data
    if to_scale > frm_scale:
        factor = 10 ** (to_scale - frm_scale)
        check_unscaled(_f64(data) * factor, valid, "rescaled value")
        return data * factor
    f = 10 ** (frm_scale - to_scale)
    return _sign(data) * ((_abs(data) + f // 2) // f)


def check_dec38(r: torch.Tensor, what: str) -> None:
    """|value| >= 10^38 raises (the reference's DECIMAL overflow)."""
    check_rows(D128.exceeds_38_digits(r),
               f"DECIMAL overflow: {what} exceeds 38 digits")


def _const128(v: int, device) -> torch.Tensor:
    """One python int as (2,) limbs on `device`, filled there (no
    host-to-device copy, which a capture forbids)."""
    hi, lo = (int(x) for x in D128.from_host_int(v))
    return torch.stack([torch.full((), hi, dtype=torch.int64, device=device),
                        torch.full((), lo, dtype=torch.int64, device=device)])


def _device_of(*vals):
    for v in vals:
        if _is_tensor(v.data):
            return v.data.device
    return torch.device("cpu")


def lift128(v: ColVal, device) -> torch.Tensor:
    """A decimal or integer operand as (n, 2) limbs ((2,) for a
    literal), at its own scale."""
    if not _is_tensor(v.data):
        return _const128(int(v.data), device)
    if is_long(v.type):
        return v.data
    return D128.from_int64(v.data)


def _as_i64(v: ColVal, device):
    """An operand's unscaled int64: a tensor, or a 0-d one for a
    literal beside a column."""
    if _is_tensor(v.data):
        return v.data.to(torch.int64)
    return torch.full((), int(v.data), dtype=torch.int64, device=device)


def emit_decimal_arith(name, a: ColVal, b: ColVal, out_t: T.Type,
                       valid) -> ColVal:
    if is_long(out_t) or is_long(a.type) or is_long(b.type):
        return _emit_decimal_arith_long(name, a, b, out_t, valid)
    sa, sb = dec_scale(a.type), dec_scale(b.type)
    so = out_t.decimal_scale
    x = a.data.to(torch.int64) if _is_tensor(a.data) else int(a.data)
    y = b.data.to(torch.int64) if _is_tensor(b.data) else int(b.data)
    if name in ("add", "sub", "mod"):
        x = rescale_dec(x, sa, so, a.valid)
        y = rescale_dec(y, sb, so, b.valid)
        if name == "add":
            r = x + y
        elif name == "sub":
            r = x - y
        else:
            r = _sign(x) * (_abs(x) % _abs(y))
        return ColVal(r, valid, out_t)
    if name == "mul":
        # int64 unscaled products wrap silently: a float64 shadow detects
        # magnitudes past ~19 digits
        check_unscaled(_f64(x) * _f64(y), valid, "unscaled product")
        # the true product's scale is sa + sb
        return ColVal(rescale_dec(x * y, sa + sb, so), valid, out_t)
    raise AssertionError(name)


def _emit_decimal_arith_long(name, a, b, out_t, valid):
    """Two-limb Int128 path (the reference engine's
    UnscaledDecimal128Arithmetic.{add,subtract,multiply})."""
    sa, sb = dec_scale(a.type), dec_scale(b.type)
    so = out_t.decimal_scale
    if not _is_tensor(a.data) and not _is_tensor(b.data):
        # literal folding: exact host integer arithmetic
        x, y = int(a.data), int(b.data)
        if name == "add":
            r = x * 10 ** (so - sa) + y * 10 ** (so - sb)
        elif name == "sub":
            r = x * 10 ** (so - sa) - y * 10 ** (so - sb)
        elif name == "mul":
            r = x * y  # the scales add to so
        else:
            raise NotImplementedError(f"long decimal {name}")
        return ColVal(r, valid, out_t)
    device = _device_of(a, b)
    if name in ("add", "sub"):
        x = D128.scale_up(lift128(a, device), so - sa)
        y = D128.scale_up(lift128(b, device), so - sb)
        r = D128.add(x, y) if name == "add" else D128.sub(x, y)
        check_dec38(r, "decimal " + name)
        return ColVal(r, valid, out_t)
    if name == "mul":
        # sa + sb == so by construction (decimal_mul_type)
        if not is_long(a.type) and not is_long(b.type):
            return ColVal(D128.mul_int64(_as_i64(a, device),
                                         _as_i64(b, device)), valid, out_t)
        # long x small-int literal (sum * 2, say): exact by mul_small
        for big, small in ((a, b), (b, a)):
            if is_long(big.type) and not _is_tensor(small.data):
                c = int(small.data)
                if abs(c) < (1 << 31):
                    r = D128.mul_small(lift128(big, device), abs(c))
                    return ColVal(D128.neg(r) if c < 0 else r, valid, out_t)
        raise NotImplementedError(
            "long-decimal x long-decimal multiply (128x128) is not "
            "supported; cast one side down or to DOUBLE")
    raise NotImplementedError(f"long decimal {name}")


def decimal_to_double(v: ColVal) -> ColVal:
    if not v.type.is_decimal:
        return v
    s = v.type.decimal_scale
    if is_long(v.type) and _is_tensor(v.data):
        return ColVal(true_div(D128.to_float64(v.data), 10 ** s), v.valid,
                      T.DOUBLE)
    return ColVal(true_div(v.data, 10 ** s), v.valid, T.DOUBLE)


def emit_neg(v: ColVal) -> ColVal:
    if is_long(v.type) and _is_tensor(v.data):
        return ColVal(D128.neg(v.data), v.valid, v.type)
    return ColVal(-v.data, v.valid, v.type)


def emit_long_compare(name: str, a: ColVal, b: ColVal, pyop,
                      valid) -> ColVal:
    """A comparison with a long-decimal side: exact across scales
    (dec128.cmp_scaled), or in float64 against a floating side."""
    if a.type.is_floating or b.type.is_floating:
        return ColVal(pyop(decimal_to_double(a).data,
                           decimal_to_double(b).data), valid, T.BOOLEAN)
    sx, sy = dec_scale(a.type), dec_scale(b.type)
    if not _is_tensor(a.data) and not _is_tensor(b.data):
        s = max(sx, sy)
        return ColVal(pyop(int(a.data) * 10 ** (s - sx),
                           int(b.data) * 10 ** (s - sy)), valid, T.BOOLEAN)
    device = _device_of(a, b)
    x, y = lift128(a, device), lift128(b, device)
    less, equal = D128.cmp_scaled(x, sx, y, sy)
    r = {"eq": lambda: equal,
         "ne": lambda: ~equal,
         "lt": lambda: less,
         "le": lambda: less | equal,
         "gt": lambda: ~(less | equal),
         "ge": lambda: ~less}[name]()
    return ColVal(r, valid, T.BOOLEAN)


# ---- casts ------------------------------------------------------------------


def overflow_checked_valid(fits, v: ColVal, safe: bool, msg: str):
    """The CAST-overflow plumbing: under TRY_CAST the failing rows go
    NULL; otherwise the check raises (colval.check_rows).  Returns the
    result's validity."""
    if safe:
        return fits if v.valid is None else (v.valid & fits)
    if _is_tensor(fits):
        bad = ~fits if v.valid is None else (~fits & v.valid)
        check_rows(bad, msg)
    elif not fits and v.valid is not False:
        raise ValueError(msg)
    return v.valid


def _ctx():
    return _d.Context(prec=_PREC)


def _cast_long_literal(v: ColVal, to: T.Type, safe: bool) -> ColVal:
    frm = v.type
    hp = _ctx()
    d = hp.create_decimal(int(v.data)).scaleb(-frm.decimal_scale,
                                                context=hp)
    if to.is_decimal:
        unscaled = int(d.scaleb(to.decimal_scale, context=hp).quantize(
            _d.Decimal(1), rounding=_d.ROUND_HALF_UP, context=hp))
        limit = (1 << 63) if not to.is_long_decimal else 10 ** 38
        if abs(unscaled) >= limit:
            if safe:
                return ColVal(0, False, to)
            raise ValueError(
                f"DECIMAL overflow: CAST to {to} (reference raises on "
                "rescale overflow, UnscaledDecimal128Arithmetic.rescale)")
        return ColVal(unscaled, v.valid, to)
    if to.is_floating:
        return ColVal(float(d), v.valid, to)
    if to.is_integer:
        iv = int(d.quantize(_d.Decimal(1), rounding=_d.ROUND_HALF_UP,
                            context=hp))
        tmin, tmax = to.integer_bounds()
        if not tmin <= iv <= tmax:
            if safe:
                return ColVal(0, False, to)
            raise ValueError(f"DECIMAL overflow: CAST {frm} -> {to} value "
                             "does not fit an integer")
        return ColVal(iv, v.valid, to)
    raise NotImplementedError(f"CAST {frm} -> {to}")


def _cast_from_long(v: ColVal, to: T.Type, safe: bool) -> ColVal:
    frm = v.type
    s = frm.decimal_scale
    a = v.data
    if to.is_decimal and to.is_long_decimal:
        r = D128.scale_up(a, to.decimal_scale - s) \
            if to.decimal_scale >= s \
            else D128.scale_down_round(a, s - to.decimal_scale)
        if not safe:
            check_dec38(r, f"CAST {frm} -> {to}")
        return ColVal(r, v.valid, to)
    if to.is_decimal:  # long -> short: rescale, must fit int64
        r = D128.scale_down_round(a, s - to.decimal_scale) \
            if s >= to.decimal_scale \
            else D128.scale_up(a, to.decimal_scale - s)
        fits = r[..., D128.HI] == (r[..., D128.LO] >> 63)
        valid = overflow_checked_valid(
            fits, v, safe, f"DECIMAL overflow: CAST {frm} -> {to} value "
            "does not fit a short decimal")
        return ColVal(r[..., D128.LO], valid, to)
    if to.is_floating:
        r = true_div(D128.to_float64(a), 10 ** s)
        return ColVal(r.to(_torch_dtype(to)), v.valid, to)
    if to.is_integer:
        r = D128.scale_down_round(a, s)
        # the rounded value may not fit the TARGET integer type: the low
        # limb alone would wrap (the reference raises)
        lo = r[..., D128.LO]
        fits = r[..., D128.HI] == (lo >> 63)
        tmin, tmax = to.integer_bounds()
        if to.name != "BIGINT":
            fits = fits & (lo >= tmin) & (lo <= tmax)
        valid = overflow_checked_valid(
            fits, v, safe, f"DECIMAL overflow: CAST {frm} -> {to} value "
            "does not fit an integer")
        return ColVal(lo.to(_torch_dtype(to)), valid, to)
    raise NotImplementedError(f"CAST {frm} -> {to}")


def _f64_to_u64_bits(x: torch.Tensor) -> torch.Tensor:
    """f64 in [0, 2^64) -> the int64 whose unsigned value is round(x)."""
    from presto_tpu_torch.functions.scalar import _f64_to_i64

    return _f64_to_i64(torch.where(x >= 2.0 ** 63, x - 2.0 ** 64, x))


def _round_half_away(scaled):
    if _is_tensor(scaled):
        return torch.sign(scaled) * torch.floor(scaled.abs() + 0.5)
    return float(np.sign(scaled) * np.floor(abs(scaled) + 0.5))


def _cast_to_long(v: ColVal, to: T.Type, safe: bool) -> ColVal:
    frm = v.type
    s = to.decimal_scale
    x = v.data
    if not _is_tensor(x):
        if frm.is_decimal or frm.is_integer:
            s0 = frm.decimal_scale if frm.is_decimal else 0
            hp = _ctx()
            unscaled = int(hp.create_decimal(int(x)).scaleb(
                s - s0, context=hp).quantize(
                _d.Decimal(1), rounding=_d.ROUND_HALF_UP, context=hp))
            return ColVal(unscaled, v.valid, to)
        if frm.is_floating:
            # a literal stays a python int, so that literal arithmetic
            # after it stays exact (the reference's default context)
            unscaled = int(_d.Decimal(float(x)).scaleb(s).quantize(
                _d.Decimal(1), rounding=_d.ROUND_HALF_UP))
            return ColVal(unscaled, v.valid, to)
        raise NotImplementedError(f"CAST {frm} -> {to}")
    if frm.is_decimal:
        a = D128.from_int64(x)
        r = D128.scale_up(a, s - frm.decimal_scale) \
            if s >= frm.decimal_scale \
            else D128.scale_down_round(a, frm.decimal_scale - s)
        return ColVal(r, v.valid, to)
    if frm.is_integer:
        return ColVal(D128.scale_up(D128.from_int64(x), s), v.valid, to)
    if frm.is_floating:
        r = _round_half_away(x.to(torch.float64) * (10 ** s))
        hi = torch.floor(r / (2.0 ** 64))
        lo = _f64_to_u64_bits(r - hi * (2.0 ** 64))
        from presto_tpu_torch.functions.scalar import _f64_to_i64

        return ColVal(torch.stack([_f64_to_i64(hi), lo], dim=-1), v.valid,
                      to)
    raise NotImplementedError(f"CAST {frm} -> {to}")


def _cast_to_short(v: ColVal, to: T.Type) -> ColVal:
    frm = v.type
    s = to.decimal_scale
    x = v.data
    if frm.is_decimal:
        x = x.to(torch.int64) if _is_tensor(x) else int(x)
        return ColVal(rescale_dec(x, frm.decimal_scale, s, v.valid),
                      v.valid, to)
    if frm.is_integer:
        x = x.to(torch.int64) if _is_tensor(x) else int(x)
        return ColVal(x * (10 ** s), v.valid, to)
    if frm.is_floating:
        from presto_tpu_torch.functions.scalar import _f64_to_i64

        if not _is_tensor(x):
            r = _round_half_away(float(x) * (10 ** s))
            if math.isnan(r):  # a TRY_CAST parse failure, say
                return ColVal(0, False, to)
            return ColVal(int(_f64_to_i64(r)), v.valid, to)
        r = _round_half_away(x.to(torch.float64) * (10 ** s))
        nan = torch.isnan(r)
        r = torch.where(nan, 0.0, r)
        valid = ~nan if v.valid is None else (v.valid & ~nan)
        return ColVal(_f64_to_i64(r), valid, to)
    raise NotImplementedError(f"CAST {frm} -> {to}")


def _cast_from_short(v: ColVal, to: T.Type, safe: bool) -> ColVal:
    frm = v.type
    s = frm.decimal_scale
    x = v.data
    if to.is_floating:
        r = true_div(x, 10 ** s)
        return ColVal(r.to(_torch_dtype(to)) if _is_tensor(r) else r,
                      v.valid, to)
    if to.is_integer:
        # HALF_UP rounding (the reference engine's
        # DecimalCasts.shortDecimalToBigint) and a check of the target
        # type's range: a narrowing conversion alone would wrap
        x = x.to(torch.int64) if _is_tensor(x) else int(x)
        r = _sign(x) * ((_abs(x) + (10 ** s) // 2) // (10 ** s))
        tmin, tmax = to.integer_bounds()
        fits = (r >= tmin) & (r <= tmax) if _is_tensor(r) \
            else tmin <= r <= tmax
        valid = overflow_checked_valid(
            fits, v, safe, f"DECIMAL overflow: CAST {frm} -> {to} value "
            "does not fit the target integer type")
        if not _is_tensor(r):  # a narrowing conversion wraps, as XLA's
            r = np.asarray(r, np.int64).astype(to.numpy_dtype()).item()
        return ColVal(r.to(_torch_dtype(to)) if _is_tensor(r) else r,
                      valid, to)
    raise NotImplementedError(f"CAST {frm} -> {to}")


def _torch_dtype(t: T.Type) -> torch.dtype:
    from presto_tpu_torch.functions.scalar import torch_dtype

    return torch_dtype(t)


def emit_cast_decimal(v: ColVal, to: T.Type, safe: bool) -> ColVal:
    """CAST with a DECIMAL side (the reference's _emit_cast_decimal)."""
    frm = v.type
    if is_long(frm):
        if not _is_tensor(v.data):
            return _cast_long_literal(v, to, safe)
        return _cast_from_long(v, to, safe)
    if is_long(to):
        return _cast_to_long(v, to, safe)
    if to.is_decimal:
        return _cast_to_short(v, to)
    return _cast_from_short(v, to, safe)


def parse_dec128(x: str, to: T.Type, safe: bool):
    """The exact unscaled value of a decimal string at `to`'s scale
    (the reference engine's Decimals.parse), None for a TRY_CAST
    failure."""
    try:
        with _d.localcontext() as ctx:
            ctx.prec = _PREC
            unscaled = int(_d.Decimal(x).scaleb(to.decimal_scale).quantize(
                _d.Decimal(1), rounding=_d.ROUND_HALF_UP))
    except _d.InvalidOperation:
        if safe:
            return None
        raise ValueError(f"cannot CAST '{x}' to {to}")
    if abs(unscaled) >= 10 ** to.decimal_precision:
        if safe:
            return None
        raise ValueError(f"DECIMAL overflow: '{x}' exceeds {to}")
    return unscaled


def render(n: int, s: int) -> str:
    """A scaled integer's text at scale s."""
    sign = "-" if n < 0 else ""
    n = abs(n)
    if s == 0:
        return sign + str(n)
    return f"{sign}{n // 10 ** s}.{n % 10 ** s:0{s}d}"


def host_unscaled(v, s: int) -> int:
    """A decoded decimal (Decimal for long, float for short) back to its
    unscaled integer (ROUND_HALF_EVEN, as the reference's scalar
    subquery values are)."""
    with _d.localcontext() as ctx:
        ctx.prec = _PREC
        return int(_d.Decimal(str(v)).scaleb(s).quantize(
            _d.Decimal(1), rounding=_d.ROUND_HALF_EVEN))


def emit_truncate(a: ColVal, d: int) -> ColVal:
    """truncate(x, d) of a decimal: toward zero at d digits, the scale
    kept (the reference's _emit_truncate; a long value through its
    limbs)."""
    keep = max(a.type.decimal_scale - d, 0)
    s = 10 ** keep
    x = a.data
    if is_long(a.type) and _is_tensor(x):
        neg = x[..., D128.HI] < 0
        mag = torch.where(neg[..., None], D128.neg(x), x)
        k = keep
        while k > 0:
            step = min(k, 9)
            mag, _r = D128._divmod_small_nonneg(mag, 10 ** step)
            k -= step
        mag = D128.scale_up(mag, keep)
        return ColVal(torch.where(neg[..., None], D128.neg(mag), mag),
                      a.valid, a.type)
    if not _is_tensor(x):
        x = int(x)
    return ColVal(_sign(x) * (_abs(x) // s) * s, a.valid, a.type)


# ---- decimal math: abs, sign, floor, ceil, round, mod -------------------------
# The SQL values, held to Python's decimal in the tests.  The reference
# applies its integer kernels to the unscaled integers here (ROADMAP C,
# "Reference behaviours the port does not copy"); the result types are
# the reference's (the argument's type; mod's below).


def _pow10_limbs(like: torch.Tensor, s: int) -> torch.Tensor:
    return D128.scale_up(D128._one(like), s)


def emit_abs(a: ColVal) -> ColVal:
    x = a.data
    if is_long(a.type) and _is_tensor(x):
        neg = x[..., D128.HI] < 0
        return ColVal(torch.where(neg[..., None], D128.neg(x), x), a.valid,
                      a.type)
    return ColVal(_abs(x), a.valid, a.type)


def emit_sign(a: ColVal) -> ColVal:
    """-1, 0 or 1 at the argument's scale."""
    s, x = a.type.decimal_scale, a.data
    if is_long(a.type) and _is_tensor(x):
        sig = torch.where(x[..., D128.HI] < 0, -1,
                          (x != 0).any(-1).to(torch.int64))
        return ColVal(D128.scale_up(D128.from_int64(sig), s), a.valid,
                      a.type)
    return ColVal(_sign(x) * 10 ** s, a.valid, a.type)


def emit_floor_ceil(a: ColVal, up: bool) -> ColVal:
    """floor or ceil at the argument's scale: the truncation, moved one
    unit down (floor of a negative) or up (ceil of a positive) where a
    fraction was cut."""
    s, x = a.type.decimal_scale, a.data
    if s == 0:
        return a
    if is_long(a.type) and _is_tensor(x):
        t = emit_truncate(a, 0).data
        unit = _pow10_limbs(x, s)
        if up:
            r = torch.where(D128.lt(t, x)[..., None], D128.add(t, unit), t)
        else:
            r = torch.where(D128.lt(x, t)[..., None], D128.sub(t, unit), t)
        return ColVal(r, a.valid, a.type)
    f = 10 ** s
    if not _is_tensor(x):
        x = int(x)
    return ColVal((-((-x) // f) if up else x // f) * f, a.valid, a.type)


def emit_round(a: ColVal, d: int) -> ColVal:
    """round(x, d) half away from zero, the argument's scale kept."""
    s, x = a.type.decimal_scale, a.data
    keep = s - d
    if keep <= 0:
        return a
    if is_long(a.type) and _is_tensor(x):
        return ColVal(D128.scale_up(D128.scale_down_round(x, keep), keep),
                      a.valid, a.type)
    f = 10 ** keep
    if not _is_tensor(x):
        x = int(x)
    return ColVal(_sign(x) * ((_abs(x) + f // 2) // f) * f, a.valid, a.type)


def mod_result_type(at: T.Type, bt: T.Type) -> T.Type:
    """Presto's DECIMAL mod type: the smaller integral part and the
    larger scale (an integer operand as decimal(18, 0))."""
    da = at if at.is_decimal else T.decimal(18, 0)
    db = bt if bt.is_decimal else T.decimal(18, 0)
    sa, sb = da.decimal_scale, db.decimal_scale
    s = max(sa, sb)
    p = min(da.decimal_precision - sa, db.decimal_precision - sb) + s
    return T.decimal(min(p, 38), s)


def emit_mod(a: ColVal, b: ColVal) -> ColVal:
    """x mod y with the sign of x, exact on the unscaled integers at the
    larger scale; NULL for a zero divisor, as the integer mod."""
    if is_long(a.type) or is_long(b.type):
        raise NotImplementedError(
            "mod of long decimals is not ported to presto_tpu_torch")
    out_t = mod_result_type(a.type, b.type)
    so = out_t.decimal_scale
    x = rescale_dec(a.data.to(torch.int64) if _is_tensor(a.data)
                    else int(a.data), dec_scale(a.type), so, a.valid)
    y = rescale_dec(b.data.to(torch.int64) if _is_tensor(b.data)
                    else int(b.data), dec_scale(b.type), so, b.valid)
    zero = y == 0
    if _is_tensor(y):
        safe = torch.where(zero, torch.ones_like(y), y)
    else:
        safe = 1 if zero else y
    r = _sign(x) * (_abs(x) % _abs(safe))
    valid = a.valid
    for v in (b.valid, ~zero if _is_tensor(zero) else not zero):
        if v is not None:
            valid = v if valid is None else valid & v
    if is_long(out_t):
        r = D128.from_int64(r) if _is_tensor(r) else r
    return ColVal(r, valid, out_t)
