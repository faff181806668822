"""Two-limb Int128 decimal arithmetic on torch int64.

Reference: presto_tpu/exec/dec128.py (itself after the reference
engine's UnscaledDecimal128Arithmetic and Int128ArrayBlock).  A long
decimal column (precision 19..38) is an int64 tensor of shape (n, 2):
[..., 0] is the signed high limb, [..., 1] the low limb (the unsigned
low 64 bits, held in int64 with wrapping semantics); the value is
hi * 2^64 + u64(lo), two's complement.

The reference computes in uint64 for its carries, unsigned compares and
logical shifts.  torch's CPU kernels have no `>>` on unsigned integers,
so here every value stays an int64 bit pattern: an unsigned compare is a
signed compare of both sides XORed with the sign bit, a logical shift is
an arithmetic one masked (`_lsr`), and the 32x32-bit products and the
long division work on 32-bit halves held in int64.  int64 addition and
multiplication wrap exactly as uint64's do, so every function returns
the reference's bits.  No function reads a tensor back to the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

HI = 0
LO = 1

_M32 = (1 << 32) - 1
_SIGNBIT = -(1 << 63)  # int64 min: xor-bias turns unsigned order into signed


def _lsr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (uint64 `>>`)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b of int64 bit patterns."""
    return (a ^ _SIGNBIT) < (b ^ _SIGNBIT)


def _stack(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return torch.stack([hi, lo], dim=-1)


def from_int64(x: torch.Tensor) -> torch.Tensor:
    """Sign-extend int64 unscaled values to (n, 2) limbs."""
    x = x.to(torch.int64)
    return _stack(x >> 63, x)  # arithmetic shift: 0 or -1


def from_host_int(v: int) -> np.ndarray:
    """One python int (|v| < 2^127) to host [hi, lo] limbs."""
    m = v & ((1 << 128) - 1)  # two's complement mod 2^128
    lo = m & ((1 << 64) - 1)
    hi = m >> 64
    if hi >= 1 << 63:
        hi -= 1 << 64
    if lo >= 1 << 63:
        lo -= 1 << 64  # int64 wrap of the unsigned low limb
    return np.asarray([hi, lo], dtype=np.int64)


def from_host_ints(vals) -> np.ndarray:
    return np.stack([from_host_int(int(v)) for v in vals]) \
        if len(vals) else np.zeros((0, 2), np.int64)


def to_host_ints(limbs) -> list:
    """(n, 2) int64 limbs -> python ints."""
    limbs = np.asarray(limbs)
    return [(int(hi) << 64) + (int(lo) & ((1 << 64) - 1))
            for hi, lo in limbs.reshape(-1, 2)]


def limbs_on(limbs: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host limbs as a tensor on `like`'s device (through batch.upload,
    so that a compiled query's capture reads them from its log)."""
    from presto_tpu_torch.batch import upload

    return upload(np.asarray(limbs, dtype=np.int64), like.device)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    lo = a[..., LO] + b[..., LO]
    # unsigned overflow iff the result < either addend
    carry = _ult(lo, a[..., LO]).to(torch.int64)
    return _stack(a[..., HI] + b[..., HI] + carry, lo)


def neg(a: torch.Tensor) -> torch.Tensor:
    lo = ~a[..., LO] + 1
    carry = (lo == 0).to(torch.int64)
    return _stack(~a[..., HI] + carry, lo)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return add(a, neg(b))


def lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., HI] < b[..., HI]) | (
        (a[..., HI] == b[..., HI]) & _ult(a[..., LO], b[..., LO]))


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., HI] == b[..., HI]) & (a[..., LO] == b[..., LO])


def _lt_const(a: torch.Tensor, v: int) -> torch.Tensor:
    """a < v for one python int v, with no host-to-device copy."""
    hi, lo = (int(x) for x in from_host_int(v))
    return (a[..., HI] < hi) | ((a[..., HI] == hi) & _ult(a[..., LO], lo))


def mul_int64(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact int64 x int64 -> (n, 2) limbs: the unsigned 64x64 product
    from 32-bit halves, then the signed high limb by the sign
    corrections."""
    x = x.to(torch.int64)
    y = y.to(torch.int64)
    xl, xh = x & _M32, _lsr(x, 32)
    yl, yh = y & _M32, _lsr(y, 32)
    ll = xl * yl  # each product's bits are the uint64 product's
    lh = xl * yh
    hl = xh * yl
    hh = xh * yh
    mid = _lsr(ll, 32) + (lh & _M32) + (hl & _M32)
    lo = (ll & _M32) | (mid << 32)
    uhi = hh + _lsr(lh, 32) + _lsr(hl, 32) + _lsr(mid, 32)
    # unsigned -> signed mulhi: subtract (x<0)*y and (y<0)*x
    zero = torch.zeros_like(x)
    hi = uhi - torch.where(x < 0, y, zero) - torch.where(y < 0, x, zero)
    return _stack(hi, lo)


def mul_small(a: torch.Tensor, c: int) -> torch.Tensor:
    """128-bit x small positive int (< 2^31), wrapping mod 2^128."""
    assert 0 <= c < (1 << 31)
    lo_l = (a[..., LO] & _M32) * c
    lo_h = _lsr(a[..., LO], 32) * c + _lsr(lo_l, 32)
    lo = (lo_l & _M32) | (lo_h << 32)
    carry = _lsr(lo_h, 32)
    return _stack(a[..., HI] * c + carry, lo)


def scale_up(a: torch.Tensor, k: int) -> torch.Tensor:
    """a * 10^k (k >= 0) by repeated small multiplies (10^9 < 2^31)."""
    while k > 0:
        step = min(k, 9)
        a = mul_small(a, 10 ** step)
        k -= step
    return a


def _divmod_small_nonneg(a: torch.Tensor, c: int):
    """(a // c, a % c) for NON-NEGATIVE a and 0 < c < 2^31, by 32-bit
    long division over the four 32-bit limbs (the remainder < c keeps
    every intermediate inside int64)."""
    l3 = _lsr(a[..., HI], 32)
    l2 = a[..., HI] & _M32
    l1 = _lsr(a[..., LO], 32)
    l0 = a[..., LO] & _M32
    r = torch.zeros_like(l3)
    qs = []
    for limb in (l3, l2, l1, l0):
        cur = (r << 32) | limb
        qs.append(cur // c)
        r = cur % c
    q3, q2, q1, q0 = qs
    return _stack((q3 << 32) | q2, (q1 << 32) | q0), r


def _one(a: torch.Tensor) -> torch.Tensor:
    return from_int64(torch.ones_like(a[..., HI]))


def scale_down_round(a: torch.Tensor, k: int) -> torch.Tensor:
    """a / 10^k rounded half away from zero (Presto decimal rounding)."""
    if k <= 0:
        return scale_up(a, -k)
    sign_neg = a[..., HI] < 0
    mag = torch.where(sign_neg[..., None], neg(a), a)
    # the step chain discards the least significant digits first, so
    # half-away rounding needs only the last step's remainder
    r = torch.zeros_like(a[..., HI])
    c = 1
    while k > 0:
        step = min(k, 9)
        c = 10 ** step
        mag, r = _divmod_small_nonneg(mag, c)
        k -= step
    round_up = 2 * r >= c
    mag = torch.where(round_up[..., None], add(mag, _one(mag)), mag)
    return torch.where(sign_neg[..., None], neg(mag), mag)


def floor_divmod_pow10(a: torch.Tensor, k: int):
    """(a // 10^k, a mod 10^k) with FLOOR semantics (remainder in
    [0, 10^k) for any sign): exact, never overflows."""
    assert 0 <= k <= 18
    sign_neg = a[..., HI] < 0
    mag = torch.where(sign_neg[..., None], neg(a), a)
    q = mag
    rem = torch.zeros_like(a[..., HI])
    mult = 1
    kk = k
    while kk > 0:
        step = min(kk, 9)
        c = 10 ** step
        q, r = _divmod_small_nonneg(q, c)
        rem = rem + r * mult
        mult *= c
        kk -= step
    c_total = 10 ** k
    # negative a: floor division rounds away from zero when rem > 0
    q_neg = neg(q)
    adj = sign_neg & (rem > 0)
    q_final = torch.where(sign_neg[..., None],
                          torch.where(adj[..., None], sub(q_neg, _one(q)),
                                      q_neg),
                          q)
    r_final = torch.where(adj, c_total - rem,
                          torch.where(sign_neg, torch.zeros_like(rem), rem))
    return q_final, r_final


def cmp_scaled(a: torch.Tensor, sa: int, b: torch.Tensor, sb: int):
    """(lt, eq) between a at scale sa and b at scale sb: exact for the
    full 38-digit range (the larger-scale side scales DOWN with a floor
    remainder; scaling the smaller side up could wrap past 2^128)."""
    if sa == sb:
        return lt(a, b), eq(a, b)
    if sa > sb:
        less, equal = cmp_scaled(b, sb, a, sa)
        return ~less & ~equal, equal
    # sb > sa: b = bq * 10^k + br; a*10^k <=> b reduces to (a, 0) vs
    # (bq, br) lexicographically
    bq, br = floor_divmod_pow10(b, sb - sa)
    less = lt(a, bq) | (eq(a, bq) & (br > 0))
    equal = eq(a, bq) & (br == 0)
    return less, equal


def exceeds_38_digits(a: torch.Tensor) -> torch.Tensor:
    """|a| >= 10^38 (the reference's DECIMAL overflow boundary)."""
    return ~_lt_const(a, 10 ** 38) | _lt_const(a, -(10 ** 38))


def to_float64(a: torch.Tensor) -> torch.Tensor:
    """The value as float64: the high limb converted, times 2^64, plus
    the unsigned low limb converted with one rounding (its 32-bit halves
    are exact doubles, so their sum rounds once, as a uint64 -> f64
    conversion does)."""
    hi = a[..., HI].to(torch.float64)
    lo = a[..., LO]
    lo_f = _lsr(lo, 32).to(torch.float64) * (2.0 ** 32) \
        + (lo & _M32).to(torch.float64)
    return hi * (2.0 ** 64) + lo_f


def sort_operands(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(primary, secondary) int64 sort keys whose lexicographic order is
    the signed 128-bit order: the signed hi limb, then the lo limb
    xor-biased so that its unsigned order sorts as int64."""
    return a[..., HI], a[..., LO] ^ _SIGNBIT


def segment_sum128(a: torch.Tensor, valid, gid: torch.Tensor,
                   n_groups: int, order=None) -> torch.Tensor:
    """Exact segmented sum of (n, 2)-limb values: four unsigned 32-bit
    lanes segment-summed as int64 (lane sums < 2^63 for n < 2^31), then
    carry-recombined: mod-2^128 exact for any sign mix.  Integer sums
    are exact in any order, so the card repeats them bit for bit."""
    from presto_tpu_torch.exec import kernels as K

    if valid is not None:
        a = torch.where(valid[..., None], a, torch.zeros_like(a))
    lanes = [a[..., LO] & _M32, _lsr(a[..., LO], 32),
             a[..., HI] & _M32, _lsr(a[..., HI], 32)]
    sums = [K.segment_sum(x, gid, n_groups, order).to(torch.int64)
            for x in lanes]
    c0 = sums[0]
    c1 = sums[1] + _lsr(c0, 32)
    c2 = sums[2] + _lsr(c1, 32)
    c3 = sums[3] + _lsr(c2, 32)  # past 2^128 wraps (modular)
    lo = (c0 & _M32) | ((c1 & _M32) << 32)
    hi = (c2 & _M32) | ((c3 & _M32) << 32)
    return _stack(hi, lo)


def segment_minmax128(a: torch.Tensor, valid, gid: torch.Tensor,
                      n_groups: int, is_min: bool) -> torch.Tensor:
    """Exact segmented min/max: two passes (extremize the high limb,
    then the biased low limb among the rows that hold it)."""
    from presto_tpu_torch.exec import kernels as K

    if n_groups == 0:
        return torch.zeros((0, 2), dtype=torch.int64, device=a.device)
    f = K.segment_min if is_min else K.segment_max
    # sentinels dominate the FULL int64 range (biased low limbs span it)
    sent = (1 << 63) - 1 if is_min else -(1 << 63)
    hi = a[..., HI]
    lo_b = a[..., LO] ^ _SIGNBIT
    v = torch.ones_like(hi, dtype=torch.bool) if valid is None else valid
    hi_m = f(torch.where(v, hi, torch.full_like(hi, sent)), gid, n_groups)
    on_best = v & (hi == hi_m[gid.long().clamp(0, n_groups - 1)])
    lo_m = f(torch.where(on_best, lo_b, torch.full_like(lo_b, sent)), gid,
             n_groups)
    return _stack(hi_m, lo_m ^ _SIGNBIT)
