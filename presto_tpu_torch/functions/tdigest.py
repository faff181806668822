"""t-digest: mergeable quantile sketch (Dunning's merging variant).

Reference: presto_tpu/functions/tdigest.py (after presto's
operator/aggregation/tdigest/TDigest.java: tdigest_agg, merge(tdigest),
value_at_quantile, values_at_quantiles, quantile_at_value,
scale_tdigest, destructure_tdigest over TDigestType).  Every blob
equals the reference's byte for byte.

Format (little-endian):
  'PTD1' | compression f64 | total_weight f64 | min f64 | max f64 |
  k u32 | means f64[k] | weights f64[k]

Centroids are kept sorted by mean; their size follows the k1 scale
function: fine near q=0/1, coarse in the middle.

`_compress` makes the reference's decisions without its Python loop
over every value.  Within one centroid the test "merge the next value?"
reads x = (weight before the centroid + the centroid's weight) + the
value's weight through a function that never decreases in x, so it holds
exactly for x up to one threshold, found by bisection over the float64
bit patterns with the reference's own expression (`_k1`, math.asin).
The running weights are numpy's sequential cumsum, the same additions
in the same order, and a window of them is tested against the threshold
at once.  The centroid's mean still steps value by value through the
reference's update (only where the value differs from the mean so far:
an equal value leaves it as it is), so every float is the reference's.
"""

from __future__ import annotations

import math
import struct
from typing import List, Optional

import numpy as np

_MAGIC = b"PTD1"
DEFAULT_COMPRESSION = 100.0

#: the first window of values tested against a centroid's threshold; it
#: doubles while the centroid keeps growing
_WINDOW = 256

_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")


def _bits(x: float) -> int:
    return _I64.unpack(_F64.pack(x))[0]


def _float(b: int) -> float:
    return _F64.unpack(_I64.pack(b))[0]


def _k1(q: float, compression: float) -> float:
    # scale function k_1(q) = (δ / 2π) asin(2q - 1)
    return compression / (2 * math.pi) * math.asin(2 * q - 1)


def _serialize(compression: float, total: float, mn: float, mx: float,
               means: np.ndarray, weights: np.ndarray) -> bytes:
    k = len(means)
    return (_MAGIC + struct.pack("<ddddI", compression, total, mn, mx, k)
            + np.asarray(means, "<f8").tobytes()
            + np.asarray(weights, "<f8").tobytes())


def _parse(blob: bytes):
    if not blob or blob[:4] != _MAGIC:
        raise ValueError("not a t-digest")
    compression, total, mn, mx, k = struct.unpack_from("<ddddI", blob, 4)
    off = 4 + 8 * 4 + 4
    means = np.frombuffer(blob, "<f8", k, off)
    weights = np.frombuffer(blob, "<f8", k, off + 8 * k)
    return compression, total, mn, mx, means, weights


def _merge_limit(w_so_far: float, total: float, compression: float) -> float:
    """The largest x >= 0 with _k1(min(x / total, 1), c) - _k1(q0, c) <=
    1, q0 = w_so_far / total: the reference's merge test on x."""
    q0 = w_so_far / total
    k0 = _k1(q0, compression)

    def merges(x: float) -> bool:
        return _k1(min(x / total, 1.0), compression) - k0 <= 1.0

    if merges(math.inf):
        return math.inf
    # non-negative doubles order as their int64 bit patterns
    lo, hi = 0, _bits(math.inf)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if merges(_float(mid)):
            lo = mid
        else:
            hi = mid
    return _float(lo)


def _compress(means: np.ndarray, weights: np.ndarray,
              compression: float):
    """One merging pass over mean-sorted centroids, bounding centroid
    weight by the k1 scale function."""
    if len(means) == 0:
        return means, weights
    order = np.argsort(means, kind="stable")
    means = np.asarray(means, np.float64)[order]
    weights = np.asarray(weights, np.float64)[order]
    n = len(means)
    total = float(weights.sum())
    if n > 1 and total == 0.0:
        raise ZeroDivisionError("float division by zero")
    out_m: List[float] = []
    out_w: List[float] = []
    w_so_far = 0.0
    s = 0  # the current centroid's first value
    while s < n:
        limit = _merge_limit(w_so_far, total, compression) \
            if s + 1 < n else 0.0
        size = _WINDOW
        while True:
            hi = min(n, s + size)
            cw = np.cumsum(weights[s:hi])  # its weight after each value
            # value s+1+i merges when (w_so_far + cw[i]) + w <= limit
            x = (w_so_far + cw[:-1]) + weights[s + 1:hi]
            if (x < 0).any():  # asin of less than -1 in the reference
                raise ValueError("math domain error")
            bad = np.flatnonzero(~(x <= limit))
            if len(bad):
                end = s + 1 + int(bad[0])
                break
            if hi == n:
                end = n
                break
            size *= 2
        cw = cw[:end - s]
        out_m.append(_centroid_mean(means[s:end], weights[s:end], cw))
        out_w.append(float(cw[-1]))
        w_so_far += out_w[-1]
        s = end
    return np.asarray(out_m), np.asarray(out_w)


def _centroid_mean(m: np.ndarray, w: np.ndarray, cw: np.ndarray) -> float:
    """The reference's running mean over one centroid's values:
    mean += (value - mean) * weight / running weight, value by value."""
    mean = float(m[0])
    # a value equal to the mean so far, of finite weight, over a
    # positive running weight leaves the mean as it is (but -0.0, which
    # adding +0.0 turns into +0.0)
    still = (m[1:] == mean) & (cw[1:] > 0) & np.isfinite(w[1:]) \
        & (math.copysign(1.0, mean) > 0)
    moves = np.flatnonzero(~still)
    if not len(moves):
        return mean
    mm, ww, cc = m[1:].tolist(), w[1:].tolist(), cw[1:].tolist()
    for i in range(int(moves[0]), len(mm)):
        c = cc[i]
        if c == 0.0:  # numpy's float64 division: NaN, not an exception
            with np.errstate(all="ignore"):
                mean = float(np.float64(mean) + (np.float64(mm[i]) - mean)
                             * ww[i] / np.float64(c))
        else:
            mean += (mm[i] - mean) * ww[i] / c
    return mean


def tdigest_from_values(values, weights=None,
                        compression: float = DEFAULT_COMPRESSION) -> bytes:
    """A t-digest over the values (a sequence of numbers or a float64
    array, in the order the reference's list holds them) and their
    weights."""
    vals = np.asarray(values, np.float64) if isinstance(values, np.ndarray) \
        else np.asarray([float(v) for v in values], np.float64)
    if weights is not None:
        ws = np.asarray(weights, np.float64) \
            if isinstance(weights, np.ndarray) \
            else np.asarray([float(w) for w in weights], np.float64)
        if len(ws) != len(vals):
            raise ValueError("weights/values length mismatch")
    else:
        ws = np.ones(len(vals), np.float64)
    keep = ~np.isnan(vals)  # the same mask MUST filter both arrays
    vals, ws = vals[keep], ws[keep]
    if len(vals) == 0:
        return _serialize(compression, 0.0, math.inf, -math.inf,
                          np.empty(0), np.empty(0))
    # two-level build: a 2x-resolution pass first, then the final
    # compression — the buffered-merge trick the reference's
    # MergingDigest uses to keep tail centroids tight
    m, w = _compress(vals, ws, 2 * compression)
    m, w = _compress(m, w, compression)
    return _serialize(compression, float(w.sum()), float(vals.min()),
                      float(vals.max()), m, w)


def tdigest_merge(blobs) -> bytes:
    parts = [_parse(b) for b in blobs if b]
    if not parts:
        return tdigest_from_values([])
    compression = max(p[0] for p in parts)
    means = np.concatenate([p[4] for p in parts])
    weights = np.concatenate([p[5] for p in parts])
    if len(means) == 0:
        return tdigest_from_values([], compression=compression)
    mn = min(p[2] for p in parts)
    mx = max(p[3] for p in parts)
    m, w = _compress(means, weights, compression)
    return _serialize(compression, float(w.sum()), mn, mx, m, w)


def tdigest_value_at_quantile(blob: bytes, q: float) -> Optional[float]:
    """Quantile estimate with linear interpolation between centroid
    midpoints (the reference TDigest.valueAt approach)."""
    _c, total, mn, mx, means, weights = _parse(blob)
    if total <= 0 or len(means) == 0:
        return None
    q = min(max(q, 0.0), 1.0)
    target = q * total
    # cumulative weight up to each centroid's MIDPOINT
    cum = np.cumsum(weights) - weights / 2.0
    if target <= cum[0]:
        # below the first midpoint: interpolate from the true min
        if weights[0] >= 2 and target >= 1:
            frac = (target - 0.5) / max(cum[0] - 0.5, 1e-12)
            return mn + frac * (float(means[0]) - mn)
        return mn
    if target >= cum[-1]:
        if weights[-1] >= 2 and total - target >= 1:
            frac = (target - cum[-1]) / max(
                total - 0.5 - cum[-1], 1e-12)
            return float(means[-1]) + frac * (mx - float(means[-1]))
        return mx
    i = int(np.searchsorted(cum, target, side="right")) - 1
    span = cum[i + 1] - cum[i]
    frac = (target - cum[i]) / max(span, 1e-12)
    return float(means[i] + frac * (means[i + 1] - means[i]))


def tdigest_quantile_at_value(blob: bytes, value: float) -> Optional[float]:
    _c, total, mn, mx, means, weights = _parse(blob)
    if total <= 0 or len(means) == 0:
        return None
    if value <= mn:
        return 0.0
    if value >= mx:
        return 1.0
    cum = np.cumsum(weights) - weights / 2.0
    i = int(np.searchsorted(means, value, side="right"))
    if i == 0:
        frac = (value - mn) / max(float(means[0]) - mn, 1e-12)
        return float(frac * cum[0] / total)
    if i >= len(means):
        frac = (value - float(means[-1])) / max(mx - float(means[-1]),
                                                1e-12)
        return float((cum[-1] + frac * (total - cum[-1])) / total)
    span = float(means[i] - means[i - 1])
    frac = (value - float(means[i - 1])) / max(span, 1e-12)
    return float((cum[i - 1] + frac * (cum[i] - cum[i - 1])) / total)


def tdigest_scale(blob: bytes, factor: float) -> bytes:
    """Multiply every weight (reference: scale_tdigest)."""
    if factor <= 0:
        raise ValueError("scale factor must be positive")
    compression, total, mn, mx, means, weights = _parse(blob)
    return _serialize(compression, total * factor, mn, mx, means,
                      np.asarray(weights) * factor)


def tdigest_destructure(blob: bytes):
    """(means, weights, compression, min, max, total) — the reference's
    destructure_tdigest row."""
    compression, total, mn, mx, means, weights = _parse(blob)
    return (list(map(float, means)), list(map(float, weights)),
            compression, mn, mx, total)
