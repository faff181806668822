"""Serializable sketches: HyperLogLog and quantile digest.

Reference: presto_tpu/functions/sketches.py (after presto's HyperLogLog /
P4HyperLogLog types over airlift sketches, ApproximateSetAggregation,
MergeHyperLogLogAggregation, HyperLogLogFunctions.cardinality and
QuantileDigestAggregationFunction / QuantileDigestFunctions).

These are the EXPORTABLE forms: byte strings that round-trip through
query results, CAST to and from VARBINARY, and merge across queries.
The in-query approx_distinct / approx_percentile paths (exec/kernels.py)
stay separate; these host-side sketches serve the persist-and-merge-
later workflow.  Every blob equals the reference's byte for byte, the
value hash included (blake2b, not the port's XXH64: the reference's
native hash falls back to 32 bits on some hosts).

`_qd_compress` picks each merge by one numpy pass over the centroids
where the reference loops in Python: the same costs in the same float64
operations, and numpy's argmin takes the first minimum as the loop's
strict `<` does, so the centroids are the reference's.

Formats (little-endian):
  HLL:     'PTH1' | m u16 | registers u8[m]
  QDIGEST: 'PTQ1' | k u16 | n u64 | centroids (value f64, weight f64)[k]
"""

from __future__ import annotations

import hashlib
import struct
from typing import Iterable, List, Optional, Tuple

import numpy as np

HLL_M = 1024  # ~3.25% standard error (1.04/sqrt(m))
QDIGEST_K = 200  # centroid budget (t-digest-like accuracy in the tails)

_HLL_MAGIC = b"PTH1"
_QD_MAGIC = b"PTQ1"


# ---------------------------------------------------------------------------
# value hashing (stable across processes: blake2b of a canonical byte
# encoding per type family)
# ---------------------------------------------------------------------------


def hash_value(v) -> int:
    if isinstance(v, bool) or isinstance(v, np.bool_):
        enc = b"\x01" if v else b"\x00"
    elif isinstance(v, (int, np.integer)):
        enc = struct.pack("<q", int(v))
    elif isinstance(v, (float, np.floating)):
        enc = struct.pack("<d", float(v))
    elif isinstance(v, bytes):
        enc = v
    else:
        enc = str(v).encode("utf-8")
    return struct.unpack(
        "<Q", hashlib.blake2b(enc, digest_size=8).digest())[0]


# ---------------------------------------------------------------------------
# HyperLogLog
# ---------------------------------------------------------------------------


def hll_empty(m: int = HLL_M) -> bytes:
    return _HLL_MAGIC + struct.pack("<H", m) + b"\x00" * m


def hll_from_values(values: Iterable) -> bytes:
    """An HLL over the values (None skipped)."""
    return hll_from_hashes(hash_all([v for v in values if v is not None]))


def hash_all(values) -> np.ndarray:
    """hash_value of each value, as uint64."""
    return np.fromiter((hash_value(v) for v in values), np.uint64,
                       len(values))


def _bit_length(w: np.ndarray) -> np.ndarray:
    """int.bit_length of each uint64."""
    n = np.zeros(len(w), np.int64)
    x = w.copy()
    for s in (32, 16, 8, 4, 2, 1):
        big = x >= (np.uint64(1) << np.uint64(s))
        n[big] += s
        x[big] >>= np.uint64(s)
    return n + (x > 0)


def hll_from_hashes(h: np.ndarray) -> bytes:
    """An HLL over values of these hashes (hash_value): each register
    the largest rho that any hash puts there.  A register is a max, so
    each distinct value may come once or many times."""
    m = HLL_M
    log2m = m.bit_length() - 1
    h = np.asarray(h, np.uint64)
    reg = np.zeros(m, dtype=np.uint8)
    rho = (64 - log2m) - _bit_length(h >> np.uint64(log2m)) + 1
    np.maximum.at(reg, (h & np.uint64(m - 1)).astype(np.int64),
                  rho.astype(np.uint8))
    return _HLL_MAGIC + struct.pack("<H", m) + reg.tobytes()


def _hll_registers(blob: bytes) -> np.ndarray:
    if len(blob) < 6 or blob[:4] != _HLL_MAGIC:
        raise ValueError("not a serialized HyperLogLog")
    (m,) = struct.unpack("<H", blob[4:6])
    reg = np.frombuffer(blob[6:6 + m], dtype=np.uint8)
    if len(reg) != m:
        raise ValueError("truncated HyperLogLog")
    return reg


def hll_merge(blobs: Iterable[bytes]) -> bytes:
    out: Optional[np.ndarray] = None
    m = HLL_M
    for b in blobs:
        if b is None:
            continue
        reg = _hll_registers(b)
        if out is None:
            out = reg.copy()
            m = len(reg)
        else:
            if len(reg) != m:
                raise ValueError("cannot merge HLLs of different precisions")
            out = np.maximum(out, reg)
    if out is None:
        return hll_empty()
    return _HLL_MAGIC + struct.pack("<H", m) + out.tobytes()


def hll_cardinality(blob: bytes) -> int:
    reg = _hll_registers(blob).astype(np.float64)
    m = len(reg)
    alpha = 0.7213 / (1.0 + 1.079 / m)
    E = alpha * m * m / np.sum(2.0 ** (-reg))
    zeros = int(np.sum(reg == 0))
    if E <= 2.5 * m and zeros > 0:
        E = m * np.log(m / zeros)
    return int(round(E))


# ---------------------------------------------------------------------------
# quantile digest (t-digest-flavored: merge-by-size compression keeps the
# tails accurate)
# ---------------------------------------------------------------------------


def _qd_compress(cent: List[Tuple[float, float]],
                 k: int = QDIGEST_K) -> List[Tuple[float, float]]:
    """Merge adjacent centroids until k remain: each time the pair of the
    smallest combined weight, weighted toward the middle (keeps tail
    centroids sharp)."""
    cent = sorted(cent)
    if len(cent) <= k:
        return cent
    v = np.asarray([c[0] for c in cent], np.float64)
    w = np.asarray([c[1] for c in cent], np.float64)
    while len(v) > k:
        n = len(v)
        qmid = np.arange(1, n) / n - 0.5
        cost = (w[:-1] + w[1:]) * (1.0 + 8.0 * qmid * qmid)
        # the loop's strict `<` from +inf: the first minimum, and the
        # first pair when none is below +inf (NaN never wins)
        cost[np.isnan(cost)] = np.inf
        best = int(np.argmin(cost)) + 1
        v1, w1 = float(v[best - 1]), float(w[best - 1])
        v2, w2 = float(v[best]), float(w[best])
        v[best - 1] = (v1 * w1 + v2 * w2) / (w1 + w2)
        w[best - 1] = w1 + w2
        v = np.delete(v, best)
        w = np.delete(w, best)
    return list(zip(v.tolist(), w.tolist()))


def qdigest_from_values(values) -> bytes:
    """A q-digest over the values (None skipped): a sequence of Python
    numbers or a float64 array."""
    if isinstance(values, np.ndarray) and values.dtype == np.float64:
        vals = values.copy()
    else:
        vals = np.asarray([float(v) for v in values if v is not None],
                          dtype=np.float64)
    if len(vals) == 0:
        return _QD_MAGIC + struct.pack("<HQ", 0, 0)
    vals.sort()
    # bucket into ~4k evenly-populated runs first (bounds the merging)
    chunks = np.array_split(vals, min(len(vals), 20 * QDIGEST_K))
    cent = [(float(c.mean()), float(len(c))) for c in chunks if len(c)]
    cent = _qd_compress(cent)
    return _qd_serialize(cent, len(vals))


def _qd_serialize(cent: List[Tuple[float, float]], n: int) -> bytes:
    out = [_QD_MAGIC, struct.pack("<HQ", len(cent), n)]
    for v, w in cent:
        out.append(struct.pack("<dd", v, w))
    return b"".join(out)


def qd_parse(blob: bytes) -> Tuple[List[Tuple[float, float]], int]:
    """(centroids, value count) of a serialized q-digest."""
    if len(blob) < 14 or blob[:4] != _QD_MAGIC:
        raise ValueError("not a serialized qdigest")
    k, n = struct.unpack("<HQ", blob[4:14])
    if len(blob) < 14 + 16 * k:
        raise ValueError("truncated qdigest")
    cent = []
    off = 14
    for _ in range(k):
        v, w = struct.unpack("<dd", blob[off:off + 16])
        cent.append((v, w))
        off += 16
    return cent, n


def qdigest_merge(blobs: Iterable[bytes]) -> bytes:
    cent: List[Tuple[float, float]] = []
    n = 0
    for b in blobs:
        if b is None:
            continue
        c, cn = qd_parse(b)
        cent.extend(c)
        n += cn
    return _qd_serialize(_qd_compress(cent), n)


def qdigest_value_at_quantile(blob: bytes, q: float) -> Optional[float]:
    cent, n = qd_parse(blob)
    if not cent:
        return None
    q = min(max(float(q), 0.0), 1.0)
    total = sum(w for _, w in cent)
    target = q * total
    cum = 0.0
    for v, w in cent:
        cum += w
        if cum >= target:
            return v
    return cent[-1][0]


def qdigest_quantile_at_value(blob: bytes, value: float) -> Optional[float]:
    cent, n = qd_parse(blob)
    if not cent:
        return None
    total = sum(w for _, w in cent)
    cum = 0.0
    for v, w in cent:
        if v > value:
            break
        cum += w
    return min(cum / total, 1.0)
