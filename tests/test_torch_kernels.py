"""presto_tpu_torch's kernels against presto_tpu's on the same inputs.

Inputs are made from a seed with numpy and handed to both packages; the
JAX side runs on the CPU (fused_group_sums through its Pallas
interpreter path).  These run the kernels' plain torch versions: the
CUDA kernel itself is held against its plain version on the card by
chip_smoke.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import types as RT
from presto_tpu.batch import Batch as RBatch
from presto_tpu.batch import Column as RColumn
from presto_tpu.exec import kernels as RK
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.exec import kernels as K
from tests.torch_threads import torch_one_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cols(specs):
    """[(data, valid)] numpy -> (reference Columns, port Columns)."""
    rcols, cols = [], []
    for data, valid in specs:
        t = {np.dtype(np.int64): "BIGINT", np.dtype(np.int32): "INTEGER",
             np.dtype(np.float64): "DOUBLE"}[data.dtype]
        rcols.append(RColumn(jnp.asarray(data), None if valid is None
                             else jnp.asarray(valid), RT.parse_type(t)))
        cols.append(Column(_t(data), None if valid is None else _t(valid),
                           T.parse_type(t)))
    return rcols, cols


# ---- batch upload and readback ----------------------------------------------


def test_batch_round_trip_matches_reference():
    from presto_tpu import batch as RB
    from presto_tpu_torch import batch as B

    rng = np.random.default_rng(31)
    n = 5_000  # above the size where the reference encodes natively
    arrays = {"i": rng.integers(-10**12, 10**12, n),
              "d": rng.standard_normal(n),
              "s": rng.choice(np.array(["b", "a", "cc", "", "ab"],
                                       dtype=object), n),
              "dt": rng.integers(0, 20_000, n).astype(np.int32)}
    types = {"i": "BIGINT", "d": "DOUBLE", "s": "VARCHAR", "dt": "DATE"}
    valids = {"d": rng.random(n) > 0.2, "s": rng.random(n) > 0.1}
    ref = RB.batch_from_numpy(
        arrays, {c: RT.parse_type(t) for c, t in types.items()}, valids)
    mine = B.batch_from_numpy(
        arrays, {c: T.parse_type(t) for c, t in types.items()},
        torch.device("cpu"), valids)
    for c in arrays:
        rc, pc = ref.columns[c], mine.columns[c]
        np.testing.assert_array_equal(pc.data.numpy(), np.asarray(rc.data))
        assert (pc.valid is None) == (rc.valid is None)
        if rc.dictionary is not None:
            np.testing.assert_array_equal(pc.dictionary.values,
                                          rc.dictionary.values)
    rarr, rsel = RB.to_numpy(ref)
    arr, sel = B.to_numpy(mine)
    np.testing.assert_array_equal(sel, np.asarray(rsel))
    for c in arrays:
        np.testing.assert_array_equal(np.ma.getmaskarray(arr[c]),
                                      np.ma.getmaskarray(rarr[c]))
        np.testing.assert_array_equal(np.ma.filled(arr[c], 0),
                                      np.ma.filled(rarr[c], 0))


# ---- fused_group_sums ------------------------------------------------------

FGS_CASES = {
    # name: (k, n, n_groups, dtype, rtol)
    "k6_n120000_g17": (6, 120_000, 17, np.float64, 1e-9),
    "f32_inputs": (2, 100_000, 8, np.float32, 1e-5),
    "n_not_multiple_of_8192": (3, 8192 * 3 + 77, 5, np.float64, 1e-9),
    "one_group": (4, 50_001, 1, np.float64, 1e-9),
    "g4096": (2, 9_000, 4096, np.float64, 1e-9),
    # Q1's k and G at an odd n, and G either side of 16, where the CUDA
    # kernel's launch plan changes path.  On the CPU these run the plain
    # version: the CUDA paths themselves (and their 16-byte pair loads)
    # are held only by chip_smoke.py on the card.
    "k15_n40001_g4": (15, 40_001, 4, np.float64, 1e-9),
    "k5_n40000_g16": (5, 40_000, 16, np.float64, 1e-9),
    "k5_n40000_g17": (5, 40_000, 17, np.float64, 1e-9),
}


@pytest.mark.parametrize("case", sorted(FGS_CASES))
def test_fused_group_sums_matches_reference(case):
    k, n, G, dt, rtol = FGS_CASES[case]
    rng = np.random.default_rng(sorted(FGS_CASES).index(case))
    vals = (rng.random((k, n)) * 1e4).astype(dt)
    gid = rng.integers(0, G, n).astype(np.int32)
    ref = np.asarray(RK.fused_group_sums(jnp.asarray(vals), jnp.asarray(gid),
                                         G), dtype=np.float64)
    out = K.fused_group_sums(_t(vals), _t(gid), G)
    assert out.dtype == torch.float64 and tuple(out.shape) == (k, G)
    np.testing.assert_allclose(out.numpy(), ref, rtol=rtol, atol=0)


def test_fused_group_sums_empty_input():
    out = K.fused_group_sums(torch.zeros((3, 0), dtype=torch.float64),
                             torch.zeros((0,), dtype=torch.int32), 4)
    assert tuple(out.shape) == (3, 4) and not out.any()


@pytest.mark.parametrize("skewed", [False, True])
def test_fused_group_sums_plain_near_correctly_rounded(skewed):
    # the plain version sums each 8,192-row block, then the blocks: its
    # sums stay within 1e-13 of the correctly rounded ones (math.fsum),
    # also with 90% of a million rows in one group
    import math

    rng = np.random.default_rng(41)
    k, n, G = 2, 1_000_003, 4
    vals = rng.random((k, n)) * 1e4
    gid = rng.integers(0, G, n).astype(np.int32)
    if skewed:
        gid[rng.random(n) < 0.9] = 0
    out = K.fused_group_sums_plain(_t(vals), _t(gid), G).numpy()
    exact = np.array([[math.fsum(vals[j][gid == g].tolist())
                       for g in range(G)] for j in range(k)])
    np.testing.assert_allclose(out, exact, rtol=1e-13, atol=0)


FGS_PLANS = {
    # name: ((n, k, G, SMs), expected plan fields)
    # Q1 at SF1: registers, 15 rows in two slices, two blocks a SM
    "q1_sf1": ((6_000_601, 15, 4, 132),
               dict(path="registers", group_slots=4, rows_per_slice=8,
                    slices=2, blocks=132)),
    # the executor gate's top: 64 KB tables of 2 rows, four slices, no
    # group tiles; three blocks of 64 KB a SM fill all 132 SMs
    "g4096": ((1_000_003, 8, 4096, 132),
              dict(path="shared_table", rows_per_slice=2, slices=4,
                   blocks=99, smem_bytes=65_536)),
    "g16_registers": ((1_000_000, 4, 16, 132),
                      dict(path="registers", group_slots=16,
                           rows_per_slice=2, slices=2)),
    "g17_shared_table": ((1_000_000, 4, 17, 132),
                         dict(path="shared_table", rows_per_slice=4,
                              slices=1, blocks=1056, smem_bytes=544)),
    "n0": ((0, 2, 1, 132), dict(path="registers", blocks=0)),
    # 4,095 pairs of rows: 16 blocks of 256 threads
    "n8191_g1": ((8_191, 2, 1, 132),
                 dict(path="registers", group_slots=1, rows_per_slice=2,
                      slices=1, blocks=16)),
    "g1": ((50_001, 20, 1, 132),
           dict(path="registers", group_slots=1, rows_per_slice=7,
                slices=3)),
    "n1": ((1, 3, 5, 132), dict(path="registers", group_slots=8, blocks=1)),
}


@pytest.mark.parametrize("case", sorted(FGS_PLANS))
def test_fused_group_sums_launch_shape(case):
    (n, k, G, sm), want = FGS_PLANS[case]
    plan = K.fused_group_sums_launch_shape(n, k, G, sm)
    assert {f: getattr(plan, f) for f in want} == want
    # every value row in exactly one slice, which reads gid once
    assert plan.rows_per_slice * plan.slices >= k
    assert plan.rows_per_slice * (plan.slices - 1) < k
    if plan.path == "registers":
        assert G <= plan.group_slots <= 16
        assert plan.group_slots * plan.rows_per_slice <= 32
        assert plan.rows_per_slice <= \
            K.fgs_register_slice_rows(plan.group_slots)
    else:
        # each block holds whole table rows: every group, no group tiles
        assert plan.smem_bytes == 8 * G * plan.rows_per_slice
        assert plan.smem_bytes <= 227 * 1024
    if n >= 1_000_000:  # the grid reaches every SM
        assert plan.blocks * plan.slices >= sm


def test_fused_group_sums_launch_shape_refuses_oversized_tables():
    with pytest.raises(ValueError, match="shared memory"):
        K.fused_group_sums_launch_shape(100_000, 2, 40_000, 132)


# ---- key packing and orderable floats ---------------------------------------


def _key_specs(rng, n):
    return {
        "int_with_nulls": [(rng.integers(-50, 50, n),
                            rng.random(n) > 0.2)],
        "two_ints": [(rng.integers(0, 7, n).astype(np.int32), None),
                     (rng.integers(1000, 5000, n), None)],
        "float_key": [(np.round(rng.standard_normal(n) * 1e3, 2), None)],
        "wide_hash": [(rng.integers(-2**40, 2**40, n), None),
                      (rng.integers(-2**40, 2**40, n), rng.random(n) > 0.1)],
    }


@pytest.mark.parametrize("case", ["int_with_nulls", "two_ints", "float_key",
                                  "wide_hash"])
def test_pack_keys_matches_reference(case):
    rng = np.random.default_rng(7)
    n = 5_000
    specs = _key_specs(rng, n)[case]
    sel = rng.random(n) > 0.3
    rcols, cols = _cols(specs)
    rkey, rlayout = RK.pack_keys(rcols, jnp.asarray(sel))
    key, layout = K.pack_keys(cols, _t(sel))
    assert layout == rlayout
    # orderable f64 keys span more than 62 bits: both hash, like wide ints
    assert (layout is None) == (case in ("float_key", "wide_hash"))
    np.testing.assert_array_equal(key.numpy(), np.asarray(rkey))
    assert K.key_sentinel(key) == RK.key_sentinel(rkey)


def test_group_ids_matches_reference():
    rng = np.random.default_rng(11)
    n = 20_000
    rcols, cols = _cols([(rng.integers(0, 300, n), rng.random(n) > 0.05),
                         (rng.integers(0, 3, n).astype(np.int32), None)])
    sel = rng.random(n) > 0.25
    rkey, _ = RK.pack_keys(rcols, jnp.asarray(sel))
    key, _ = K.pack_keys(cols, _t(sel))
    rgid, rrep, rng_ = RK.group_ids(rkey, jnp.asarray(sel))
    gid, rep, ng = K.group_ids(key, _t(sel))
    assert ng == rng_
    np.testing.assert_array_equal(gid.numpy(), np.asarray(rgid))
    np.testing.assert_array_equal(rep.numpy(), np.asarray(rrep))


@pytest.mark.parametrize("lied", [False, True])
def test_group_ids_presorted_matches_reference(lied):
    rng = np.random.default_rng(12)
    n = 10_000
    key = np.sort(rng.integers(0, 400, n))
    if lied:
        key[n // 2] = 1_000_000  # breaks the nondecreasing claim
    sel = rng.random(n) > 0.2
    key = np.where(sel, key, np.iinfo(np.int64).max)
    r = RK.group_ids_presorted(jnp.asarray(key), jnp.asarray(sel))
    p = K.group_ids_presorted(_t(key), _t(sel))
    assert bool(p[3]) == bool(r[3]) == lied
    np.testing.assert_array_equal(p[0].numpy(), np.asarray(r[0]))
    np.testing.assert_array_equal(p[1].numpy(), np.asarray(r[1]))
    assert int(p[2]) == int(r[2])


@pytest.mark.parametrize("size", [0, 7, 5_000, 20_000])
def test_nonzero_i32_matches_reference(size):
    rng = np.random.default_rng(13)
    mask = rng.random(10_000) > 0.6
    np.testing.assert_array_equal(
        K.nonzero_i32(_t(mask), size, 3).numpy(),
        np.asarray(RK.nonzero_i32(jnp.asarray(mask), size, 3)))


def _orderable_vals():
    rng = np.random.default_rng(3)
    return np.concatenate([
        rng.standard_normal(20_000) * 10.0 ** rng.integers(-300, 300, 20_000),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, 2.0, 0.5,
                  np.nextafter(1.0, 2.0), np.nextafter(1.0, 0.0),
                  8.98e307, 1.7976931348623157e308, 2.0 ** 1023,
                  -1.7976931348623157e308, 5e-324, -2.2250738585072014e-308]),
        np.round(rng.random(20_000) * 1e7) / 100.0,
    ])


@pytest.mark.parametrize("fn", ["_f64_orderable_arith",
                                "_f64_orderable_pair"])
def test_f64_orderable_matches_reference(fn):
    vals = _orderable_vals()
    ref = np.asarray(jax.jit(getattr(RK, fn))(jnp.asarray(vals)))
    out = getattr(K, fn)(_t(vals)).numpy()
    same = np.ones(len(vals), bool)
    if fn == "_f64_orderable_pair":
        # XLA's CPU backend flushes float32 subnormals to zero and torch
        # keeps them, so the pair's low half differs below ~1e-28
        same = ~np.isfinite(vals) | (vals == 0) | (np.abs(vals) > 1e-28)
    np.testing.assert_array_equal(out[same], ref[same])
    # the contracts of tests/test_pallas_kernels.py, on the port's keys
    finite = np.isfinite(vals)
    k = out[finite][np.argsort(vals[finite], kind="stable")]
    assert (k[1:] >= k[:-1]).all()
    imax = np.iinfo(np.int64).max
    assert out[np.isnan(vals)][0] == imax - 8
    z = getattr(K, fn)(torch.tensor([0.0, -0.0], dtype=torch.float64))
    assert z[0] == z[1] == 0
    if fn == "_f64_orderable_arith":
        assert out[np.isposinf(vals)][0] == imax - 16
        assert out[np.isneginf(vals)][0] == -(imax - 16)
        nz = finite & (np.abs(vals) >= 2.2250738585072014e-308)
        assert len(np.unique(vals[nz])) == len(np.unique(out[nz]))


# ---- segmented reductions ---------------------------------------------------


@pytest.mark.parametrize("case", ["int64_near_2_62", "int32", "float64",
                                  "bool", "one_group_int64"])
def test_segment_sum_matches_reference(case):
    rng = np.random.default_rng(17)
    n, G = 30_000, 9
    if case in ("int64_near_2_62", "one_group_int64"):
        x = rng.choice(np.array([2**62 - 1, -(2**62), 2**62 - 12345,
                                 -(2**62) + 7, 3, -5], dtype=np.int64), n)
    elif case == "int32":
        x = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    elif case == "float64":
        x = rng.standard_normal(n) * 1e6
    else:
        x = rng.random(n) > 0.5
    if case == "one_group_int64":
        G = 1
    gid = rng.integers(0, G + 1, n)  # gid == G is the dead slot
    ref = np.asarray(RK.segment_sum(jnp.asarray(x), jnp.asarray(gid), G))
    out = K.segment_sum(_t(x), _t(gid), G).numpy()
    if case == "one_group_int64":
        ref = np.asarray(RK.segment_sum(jnp.asarray(x), jnp.asarray(gid * 0),
                                        1))
        out = K.segment_sum(_t(x), _t(gid * 0), 1).numpy()
    assert out.dtype == ref.dtype
    if case == "float64":
        np.testing.assert_allclose(out, ref, rtol=1e-9)
    else:
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shared_order", [False, True])
def test_segment_sum_fixed_order_is_near_exact(shared_order):
    """Float segment_sum adds in GroupOrder's fixed order (chunks of
    _SEGMENT_CHUNK rows, then each group's chunk sums): the same bits on
    every call, and within 1e-13 relative of the correctly rounded sums
    (math.fsum), on a skewed input with masked rows: one group of ~180K
    rows (many chunks), thousands of groups of a few rows, and groups
    with no rows at all."""
    rng = np.random.default_rng(23)
    n, G = 300_000, 6_000
    gid = np.where(rng.random(n) < 0.6, 0, rng.integers(1, G // 2, n))
    gid[rng.random(n) < 0.1] = G  # masked: the dead slot
    x = rng.random(n) * 1e4
    tg, tx = _t(gid), _t(x)
    order = K.GroupOrder(tg, G) if shared_order else None
    out = K.segment_sum(tx, tg, G, order)
    assert torch.equal(out, K.segment_sum(tx, tg, G, order))
    srt = np.argsort(gid, kind="stable")
    xs = x[srt]
    bounds = np.searchsorted(gid[srt], np.arange(G + 1))
    exact = np.array([math.fsum(xs[bounds[g]:bounds[g + 1]])
                      for g in range(G)])
    assert (exact[G // 2:] == 0).all()
    assert out.dtype == torch.float64
    np.testing.assert_array_equal(out.numpy()[G // 2:], 0.0)
    err = np.abs(out.numpy() - exact)
    assert (err <= 1e-13 * np.abs(exact)).all(), err.max()


@pytest.mark.parametrize("fn", ["segment_min", "segment_max"])
def test_segment_min_max_match_reference(fn):
    rng = np.random.default_rng(19)
    n, G = 10_000, 13
    x = rng.standard_normal(n)
    gid = rng.integers(0, G + 1, n)
    ref = np.asarray(getattr(RK, fn)(jnp.asarray(x), jnp.asarray(gid), G))
    np.testing.assert_array_equal(
        getattr(K, fn)(_t(x), _t(gid), G).numpy(), ref)


# ---- ORDER BY permutation and gathers ---------------------------------------


def test_sort_perm_matches_reference():
    rng = np.random.default_rng(23)
    n = 4_000
    a = rng.integers(0, 5, n)
    b = np.round(rng.standard_normal(n), 1)
    bvalid = rng.random(n) > 0.1
    sel = rng.random(n) > 0.2
    rcols, cols = _cols([(a, None), (b, bvalid)])
    spec = [(True, None), (False, None)]
    rperm = RK.sort_perm(RBatch({}, jnp.asarray(sel)),
                         [(c, asc, nf) for c, (asc, nf) in zip(rcols, spec)])
    perm = K.sort_perm(Batch({}, _t(sel)),
                       [(c, asc, nf) for c, (asc, nf) in zip(cols, spec)])
    np.testing.assert_array_equal(perm.numpy(), np.asarray(rperm))


def test_gather_batch_matches_reference():
    rng = np.random.default_rng(29)
    n = 1_000
    data = rng.integers(0, 100, n)
    valid = rng.random(n) > 0.3
    sel = rng.random(n) > 0.5
    idx = rng.integers(-3, n + 3, 300).astype(np.int32)
    rb = RBatch({"x": RColumn(jnp.asarray(data), jnp.asarray(valid),
                              RT.BIGINT)}, jnp.asarray(sel))
    pb = Batch({"x": Column(_t(data), _t(valid), T.BIGINT)}, _t(sel))
    r = RK.gather_batch(rb, jnp.asarray(idx))
    p = K.gather_batch(pb, _t(idx))
    np.testing.assert_array_equal(p.sel.numpy(), np.asarray(r.sel))
    np.testing.assert_array_equal(p.columns["x"].data.numpy(),
                                  np.asarray(r.columns["x"].data))
    np.testing.assert_array_equal(p.columns["x"].valid.numpy(),
                                  np.asarray(r.columns["x"].valid))
