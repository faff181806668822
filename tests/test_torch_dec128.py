"""presto_tpu_torch/exec/dec128.py against presto_tpu/exec/dec128.py,
bit for bit, on the CPU: every function over seeded random limbs and
the edges (0, +-1, +-(2^63 - 1) and -2^63 in each limb, +-(10^38 - 1)
and +-10^38, carries across the low limb, low-limb ties under one high
limb), scale_down_round at every k from 1 to 38, floor_divmod_pow10 at
every k from 0 to 18, and the segmented sum, min and max over seeded
groups with NULLs.  The reference computes in uint64, the port on int64
bit patterns (unsigned compares through the sign bit, masked logical
shifts), so equal bits here are the wraparound's equality too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.exec import dec128 as R
from presto_tpu_torch.exec import dec128 as D
from tests.torch_threads import torch_one_thread  # noqa: F401

_LIMB_EDGES = [0, 1, -1, 2, (1 << 63) - 1, -(1 << 63), -(1 << 63) + 1,
               (1 << 32) - 1, 1 << 32, -(1 << 32)]
_VALUE_EDGES = [10 ** 38 - 1, -(10 ** 38 - 1), 10 ** 38, -(10 ** 38),
                (3 << 64), (3 << 64) + 1, (3 << 64) - 1, (1 << 64) - 1,
                1 << 64, -(1 << 64), 10 ** 18, -(10 ** 18), 5, -5]


def _limbs(seed=0, n=400):
    """Edge limbs (every pair of limb edges, the value edges) then seeded
    random limbs, some with small high limbs."""
    rng = np.random.default_rng(seed)
    edges = [[h, lo] for h in _LIMB_EDGES for lo in _LIMB_EDGES]
    edges += [list(R.from_host_int(v)) for v in _VALUE_EDGES]
    rand = rng.integers(-(1 << 63), (1 << 63) - 1, size=(n, 2),
                        dtype=np.int64)
    rand[: n // 2, 0] = rng.integers(-3, 3, size=n // 2)
    return np.concatenate([np.asarray(edges, np.int64), rand])


A = _limbs(0)
B = np.roll(_limbs(1), 11, axis=0)


def _same(ref, port):
    ref = np.asarray(ref)
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert ref.shape == port.shape and ref.dtype == port.dtype
    if ref.dtype == np.float64:
        ref, port = ref.view(np.int64), port.view(np.int64)
    assert np.array_equal(ref, port)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("fn", ["add", "sub", "lt", "eq"])
def test_binary(fn):
    _same(getattr(R, fn)(_j(A), _j(B)), getattr(D, fn)(_t(A), _t(B)))
    _same(getattr(R, fn)(_j(A), _j(A)), getattr(D, fn)(_t(A), _t(A)))


@pytest.mark.parametrize("fn", ["neg", "exceeds_38_digits", "to_float64"])
def test_unary(fn):
    _same(getattr(R, fn)(_j(A)), getattr(D, fn)(_t(A)))


def test_sort_operands_and_from_int64():
    for r, p in zip(R.sort_operands(_j(A)), D.sort_operands(_t(A))):
        _same(r, p)
    for col in (0, 1):
        _same(R.from_int64(_j(A[:, col])), D.from_int64(_t(A[:, col])))


@pytest.mark.parametrize("pair", [(1, 0), (0, 1), (1, 1), (0, 0)])
def test_mul_int64(pair):
    x, y = A[:, pair[0]], B[:, pair[1]]
    _same(R.mul_int64(_j(x), _j(y)), D.mul_int64(_t(x), _t(y)))


@pytest.mark.parametrize("c", [0, 1, 7, 10, 10 ** 9, (1 << 31) - 1])
def test_mul_small(c):
    _same(R.mul_small(_j(A), c), D.mul_small(_t(A), c))


@pytest.mark.parametrize("k", [0, 1, 9, 10, 18, 19, 27, 37, 38])
def test_scale_up(k):
    _same(R.scale_up(_j(A), k), D.scale_up(_t(A), k))


def test_scale_down_round_every_k():
    # half-away ties at every k: v * 10^k + 5 * 10^(k-1) for small v
    ties = np.asarray([list(R.from_host_int(s * (v * 10 ** k
                                                + 5 * 10 ** (k - 1))))
                       for k in range(1, 38) for v in (0, 1, 7)
                       for s in (1, -1)], np.int64)
    a = np.concatenate([A, ties])
    for k in range(1, 39):
        _same(R.scale_down_round(_j(a), k), D.scale_down_round(_t(a), k))


def test_floor_divmod_pow10_every_k():
    for k in range(0, 19):
        qr, rr = R.floor_divmod_pow10(_j(A), k)
        qp, rp = D.floor_divmod_pow10(_t(A), k)
        _same(qr, qp)
        _same(rr, rp)


def test_divmod_small_nonneg():
    mag = np.abs(A[:, 0:1]).clip(0, (1 << 62))
    a = np.concatenate([mag, A[:, 1:2]], axis=1)
    for c in (1, 3, 10, 10 ** 9, (1 << 31) - 1):
        qr, rr = R._divmod_small_nonneg(_j(a), c)
        qp, rp = D._divmod_small_nonneg(_t(a), c)
        _same(qr, qp)
        _same(rr, rp)


@pytest.mark.parametrize("sa,sb", [(0, 0), (2, 2), (0, 3), (3, 0),
                                   (0, 18), (18, 2), (5, 12)])
def test_cmp_scaled(sa, sb):
    lr, er = R.cmp_scaled(_j(A), sa, _j(B), sb)
    lp, ep = D.cmp_scaled(_t(A), sa, _t(B), sb)
    _same(lr, lp)
    _same(er, ep)


def test_host_conversions():
    vals = [0, 1, -1, 10 ** 38 - 1, -(10 ** 38 - 1), (1 << 127) - 1,
            -(1 << 127), (3 << 64) + 1]
    assert np.array_equal(R.from_host_ints(vals), D.from_host_ints(vals))
    assert R.to_host_ints(A) == D.to_host_ints(A)
    assert D.to_host_ints(D.from_host_ints(vals)) == vals
    assert D.from_host_ints([]).shape == (0, 2)


@pytest.mark.parametrize("groups", [1, 5, 300])
def test_segment_sum128(groups):
    rng = np.random.default_rng(groups)
    gid = rng.integers(0, groups, size=len(A)).astype(np.int32)
    valid = rng.random(len(A)) < 0.85
    for v in (valid, None):
        _same(R.segment_sum128(_j(A), None if v is None else _j(v),
                               _j(gid), groups),
              D.segment_sum128(_t(A), None if v is None else _t(v),
                               _t(gid), groups))


@pytest.mark.parametrize("is_min", [True, False])
@pytest.mark.parametrize("groups", [1, 5, 300])
def test_segment_minmax128(is_min, groups):
    rng = np.random.default_rng(groups + 7)
    gid = rng.integers(0, groups, size=len(A)).astype(np.int32)
    valid = rng.random(len(A)) < 0.85
    _same(R.segment_minmax128(_j(A), _j(valid), _j(gid), groups, is_min),
          D.segment_minmax128(_t(A), _t(valid), _t(gid), groups, is_min))
