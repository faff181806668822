"""XXH64 (seed 0 by default), bit for bit the reference's native
`pt_xxh64` (native/src/ptnative.cpp), in numpy.

`xxh64_values` hashes every entry of a string dictionary at once: the
UTF-8 encodings (`surrogatepass`) are grouped by byte length, and each
group runs the whole algorithm as uint64 lane arithmetic over an
(entries, length) byte matrix, so the work in Python is one pass per
distinct length, not one call per entry.  numpy's uint64 arithmetic
wraps as the C code's does.
"""

from __future__ import annotations

import numpy as np

_P1 = np.uint64(0x9E3779B185EBCA87)
_P2 = np.uint64(0xC2B2AE3D27D4EB4F)
_P3 = np.uint64(0x165667B19E3779F9)
_P4 = np.uint64(0x85EBCA77C2B2AE63)
_P5 = np.uint64(0x27D4EB2F165667C5)


def _rotl(x, r: int):
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _round(acc, lane):
    return _rotl(acc + lane * _P2, 31) * _P1


def _merge(acc, v):
    return (acc ^ _round(np.uint64(0), v)) * _P1 + _P4


def _words(block: np.ndarray, off: int, width: int) -> np.ndarray:
    """The little-endian `width`-byte words at byte `off` of each row."""
    return np.ascontiguousarray(block[:, off:off + width]).view(
        np.uint64 if width == 8 else np.uint32)[:, 0].astype(np.uint64)


def _hash_block(block: np.ndarray, seed: int) -> np.ndarray:
    """XXH64 of each row of an (n, L) uint8 matrix of equal-length
    inputs."""
    n, length = block.shape
    seed = np.uint64(seed)
    with np.errstate(over="ignore"):
        p = 0
        if length >= 32:
            v1 = np.full(n, seed + _P1 + _P2, np.uint64)
            v2 = np.full(n, seed + _P2, np.uint64)
            v3 = np.full(n, seed, np.uint64)
            v4 = np.full(n, seed - _P1, np.uint64)
            while p <= length - 32:
                v1 = _round(v1, _words(block, p, 8))
                v2 = _round(v2, _words(block, p + 8, 8))
                v3 = _round(v3, _words(block, p + 16, 8))
                v4 = _round(v4, _words(block, p + 24, 8))
                p += 32
            h = _rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)
            for v in (v1, v2, v3, v4):
                h = _merge(h, v)
        else:
            h = np.full(n, seed + _P5, np.uint64)
        h = h + np.uint64(length)
        while p + 8 <= length:
            h = h ^ _round(np.uint64(0), _words(block, p, 8))
            h = _rotl(h, 27) * _P1 + _P4
            p += 8
        if p + 4 <= length:
            h = h ^ (_words(block, p, 4) * _P1)
            h = _rotl(h, 23) * _P2 + _P3
            p += 4
        while p < length:
            h = h ^ (block[:, p].astype(np.uint64) * _P5)
            h = _rotl(h, 11) * _P1
            p += 1
        h = h ^ (h >> np.uint64(33))
        h = h * _P2
        h = h ^ (h >> np.uint64(29))
        h = h * _P3
        return h ^ (h >> np.uint64(32))


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of one byte string."""
    block = np.frombuffer(bytes(data), np.uint8).reshape(1, -1)
    return int(_hash_block(block, seed)[0])


def xxh64_values(values, seed: int = 0) -> np.ndarray:
    """uint64 XXH64 of str(v) encoded as UTF-8 (surrogatepass) for each
    entry of `values`, in order."""
    encoded = [str(v).encode("utf-8", "surrogatepass") for v in values]
    out = np.empty(len(encoded), np.uint64)
    if not encoded:
        return out
    lengths = np.fromiter((len(b) for b in encoded), np.int64, len(encoded))
    joined = np.frombuffer(b"".join(encoded), np.uint8)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    for length in np.unique(lengths):
        rows = np.flatnonzero(lengths == length)
        if length == 0:
            block = np.zeros((len(rows), 0), np.uint8)
        else:
            block = joined[starts[rows][:, None]
                           + np.arange(length)[None, :]]
        out[rows] = _hash_block(block, seed)
    return out
