"""presto_tpu_torch's gather tier (exec/gather.py, kernels.take_rows) and
join probe against presto_tpu's on the same inputs.

Mirrors the reference's gather tests (tests/test_pallas_kernels.py) with
the same shrunken routing constants, staging forced on the CPU (the
reference's `force` mode; the port's `_staging_enabled` patched), so the
staged route runs at test sizes.  On the CPU the block_gather wrapper takes its
plain version; the reference runs its Pallas block-gather in interpret
mode.  Staged and flat gathers must agree byte for byte, with each
other and across the packages.  The CUDA kernel itself is held against
its plain version on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu.exec import gather as RG
from presto_tpu.exec import kernels as RK
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.exec import gather as G
from presto_tpu_torch.exec import kernels as K


@pytest.fixture
def tiny_gather(monkeypatch):
    """Shrink both packages' routing constants so the staged tier
    engages at test sizes, and stage on the CPU."""
    monkeypatch.setenv("PRESTO_TPU_GATHER", "force")
    monkeypatch.setattr(G, "_staging_enabled", lambda device: True)
    for mod in (G, RG):
        monkeypatch.setattr(mod, "_STAGED_MIN_INDICES", 1)
        monkeypatch.setattr(mod, "_IB", 64)
        monkeypatch.setattr(mod, "_MAX_WINDOW", 512)
    yield


def _dtype_arrays(n, rng):
    """One numpy array per dtype class take_rows packs differently."""
    return [
        rng.integers(-(1 << 30), 1 << 30, n).astype(np.int32),
        rng.random(n).astype(np.float32),
        rng.integers(-(1 << 60), 1 << 60, n),      # i64: two words
        rng.random(n),                             # f64: direct
        rng.integers(0, 2, n).astype(bool),
        rng.integers(-100, 100, n).astype(np.int16),
    ]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _flat(monkeypatch):
    monkeypatch.setattr(G, "_staging_enabled", lambda device: False)


def _take_both(arrays, idx, presorted=False):
    mine = K.take_rows([_t(a) for a in arrays], _t(idx), presorted=presorted)
    ref = RK.take_rows([jnp.asarray(a) for a in arrays], jnp.asarray(idx),
                       presorted=presorted)
    return [x.numpy() for x in mine], [np.asarray(x) for x in ref]


def test_staged_take_rows_matches_flat_and_reference(tiny_gather,
                                                     monkeypatch):
    rng = np.random.default_rng(7)
    n, m = 5000, 4096
    arrays = _dtype_arrays(n, rng)
    idx = rng.integers(0, n, m).astype(np.int32)
    assert G.gather_route(n, m, 8) == "staged"
    staged, ref_staged = _take_both(arrays, idx)
    _flat(monkeypatch)
    flat = [x.numpy() for x in K.take_rows([_t(a) for a in arrays], _t(idx))]
    for a, s, r in zip(flat, staged, ref_staged):
        _assert_bytes_equal(s, a)
        _assert_bytes_equal(s, r)


def test_staged_take_rows_presorted(tiny_gather, monkeypatch):
    rng = np.random.default_rng(8)
    n, m = 3000, 2048
    arrays = _dtype_arrays(n, rng)
    sidx = np.sort(rng.integers(0, n, m)).astype(np.int32)
    staged, ref_staged = _take_both(arrays, sidx, presorted=True)
    _flat(monkeypatch)
    flat = [x.numpy() for x in K.take_rows([_t(a) for a in arrays],
                                           _t(sidx))]
    for a, s, r in zip(flat, staged, ref_staged):
        _assert_bytes_equal(s, a)
        _assert_bytes_equal(s, r)


def test_packed_flat_gather_matches_reference(monkeypatch):
    """Above the packed-gather crossover the flat route stacks the words
    into one matrix; the bytes stay the reference's."""
    monkeypatch.setenv("PRESTO_TPU_GATHER", "flat")
    rng = np.random.default_rng(13)
    n, m = 1000, K._PACKED_MIN_INDICES
    arrays = _dtype_arrays(n, rng)
    mine, ref = _take_both(arrays, rng.integers(0, n, m).astype(np.int32))
    for a, b in zip(mine, ref):
        _assert_bytes_equal(a, b)


@pytest.mark.parametrize("presorted", [False, True])
def test_staged_gather_skew(tiny_gather, presorted):
    """Tiles whose span exceeds a stage of the kernel's ring read from
    device memory and still return exact rows, through take_rows in
    request order and presorted."""
    rng = np.random.default_rng(9)
    n, m = 8192, 1024
    src = rng.integers(-(1 << 31), 1 << 31, (n, 3)).astype(np.int32)
    skew = np.zeros(m, np.int32)
    skew[1::2] = n - 1
    if presorted:
        skew = np.sort(skew)
    out = K.take_rows([_t(src[:, j]) for j in range(3)], _t(skew),
                      presorted=presorted)
    for j in range(3):
        _assert_bytes_equal(out[j].numpy(), src[skew, j])


def test_staged_gather_dense(tiny_gather):
    rng = np.random.default_rng(10)
    n, m = 4096, 4096
    src = rng.integers(-(1 << 31), 1 << 31, (n, 2)).astype(np.int32)
    sidx = np.sort(rng.integers(0, n, m)).astype(np.int32)
    assert G.window_rows(n, m) is not None
    _assert_bytes_equal(G.block_gather(_t(src), _t(sidx)).numpy(),
                        src[sidx])


def test_gather_batch_staged_oob_and_validity(tiny_gather, monkeypatch):
    """gather_batch clips out-of-range indices and ANDs idx_valid the
    same way on both routes, across validity masks."""
    rng = np.random.default_rng(11)
    n, m = 2000, 2048
    cols = {
        "a": Column(_t(rng.integers(0, 99, n).astype(np.int32)),
                    _t(rng.integers(0, 2, n).astype(bool)), T.INTEGER),
        "b": Column(_t(rng.random(n)), None, T.DOUBLE),
        "c": Column(_t(rng.integers(-(1 << 40), 1 << 40, n)), None,
                    T.BIGINT),
    }
    b = Batch(cols, _t(rng.integers(0, 2, n).astype(bool)))
    idx = _t(rng.integers(-50, n + 50, m).astype(np.int32))
    iv = _t(rng.integers(0, 2, m).astype(bool))
    staged = K.gather_batch(b, idx, idx_valid=iv)
    _flat(monkeypatch)
    flat = K.gather_batch(b, idx, idx_valid=iv)
    assert torch.equal(staged.sel, flat.sel)
    for name in cols:
        sc, fc = staged.columns[name], flat.columns[name]
        assert torch.equal(sc.data, fc.data)
        assert torch.equal(sc.valid, fc.valid)


def test_staged_gather_empty_inputs(tiny_gather):
    out = G.block_gather(torch.zeros((16, 2), dtype=torch.int32),
                         torch.zeros((0,), dtype=torch.int32))
    assert out.shape == (0, 2)
    # an empty SOURCE goes through take_rows' zero-fill early return
    zero = K.take_rows([torch.zeros((0,), dtype=torch.int32)],
                       torch.tensor([0, 0], dtype=torch.int32))
    assert zero[0].shape == (2,)
    # no indices: every output is empty, on either route
    arrays = _dtype_arrays(10, np.random.default_rng(14))
    for a in K.take_rows([_t(x) for x in arrays],
                         torch.zeros((0,), dtype=torch.int32)):
        assert a.shape == (0,)


# ---- routing ---------------------------------------------------------------


def test_gather_route_crossovers():
    cuda = torch.device("cuda")
    M = G._STAGED_MIN_INDICES
    assert M == RG._STAGED_MIN_INDICES
    assert G._STAGED_MIN_WORDS == RG._STAGED_MIN_WORDS
    assert G.gather_route(1 << 23, M, 4, device=cuda) == "staged"
    assert G.gather_route(1 << 23, M, 4, True, cuda) == "staged"
    assert G.gather_route(1 << 23, M - 1, 8, device=cuda) == "flat"
    # narrow request-order gathers can't amortize the way home...
    assert G.gather_route(1 << 23, M, 1, device=cuda) == "flat"
    # ...but presorted ones skip it, so width 1 still stages
    assert G.gather_route(1 << 23, M, 1, True, cuda) == "staged"
    assert G.gather_route(0, M, 4, device=cuda) == "flat"
    assert G.gather_route(1 << 23, M, 0, device=cuda) == "flat"


@pytest.mark.parametrize("env", ["", "flat", "sorted", "force"])
@pytest.mark.parametrize("device,route", [("cpu", "flat"),
                                          ("cuda", "staged")])
def test_gather_route_from_device_alone(monkeypatch, env, device, route):
    """The route follows the tensors' device and the shape: staged on
    CUDA, flat on the CPU.  The reference's PRESTO_TPU_GATHER modes do
    not reach the port, so no setting moves a CUDA gather off the
    block_gather kernel."""
    monkeypatch.setenv("PRESTO_TPU_GATHER", env)
    args = (1 << 23, 1 << 22, 8)
    assert G.gather_route(*args, device=torch.device(device)) == route


def test_window_rows_density():
    IB = G._IB
    assert G.window_rows(1 << 23, 1 << 23) == 2 * IB
    assert G.window_rows(1 << 23, 1 << 22) == 4 * IB
    assert G.window_rows(1 << 23, 1 << 18) is None
    assert G.window_rows(0, 1 << 20) is None
    for n, m in ((1 << 23, 1 << 23), (1 << 23, 1 << 22), (1 << 23, 1 << 18),
                 (1_500_000, 6_000_601), (6_000_601, 1_500_000)):
        assert G.window_rows(n, m) == RG.window_rows(n, m)


# ---- the block_gather wrapper ----------------------------------------------


def test_block_gather_cpu_is_index_select():
    rng = np.random.default_rng(15)
    src = _t(rng.integers(-(1 << 31), 1 << 31, (300, 5)).astype(np.int32))
    sidx = _t(np.sort(rng.integers(0, 300, 1000)).astype(np.int32))
    assert torch.equal(G.block_gather(src, sidx), src[sidx.long()])


def test_block_gather_cuda_rejects_cpu_tensors():
    """The CUDA entry launches or raises; it never falls back."""
    before = G.block_gather_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        G.block_gather_cuda(torch.zeros((4, 2), dtype=torch.int32),
                            torch.zeros((3,), dtype=torch.int32))
    assert G.block_gather_cuda.launches == before


# ---- join probe --------------------------------------------------------------


@pytest.mark.parametrize("dtype,sentinel", [(np.int32, K.I32_MAX),
                                            (np.int64, K.I64_MAX)])
def test_build_probe_matches_reference(dtype, sentinel):
    rng = np.random.default_rng(16)
    build = rng.integers(0, 200, 1000).astype(dtype)
    probe = rng.integers(-20, 240, 1500).astype(dtype)
    build[rng.random(1000) < 0.1] = sentinel  # masked build rows
    probe[rng.random(1500) < 0.1] = sentinel  # masked probe rows
    order, lb, ub = K.build_probe(_t(build), _t(probe))
    rorder, rlb, rub = RK.build_probe(jnp.asarray(build),
                                      jnp.asarray(probe))
    np.testing.assert_array_equal(lb.numpy(), np.asarray(rlb))
    np.testing.assert_array_equal(ub.numpy(), np.asarray(rub))
    o, ro = order.numpy(), np.asarray(rorder)
    for i in range(len(probe)):
        mine = set(o[lb[i]:ub[i]].tolist())
        assert mine == set(ro[rlb[i]:rub[i]].tolist())
        # and the matches are exactly the build rows with this key
        live = probe[i] != sentinel
        want = set(np.flatnonzero(build == probe[i]).tolist()) if live \
            else set()
        assert mine == want


def test_build_probe_empty_sides():
    e = torch.zeros((0,), dtype=torch.int32)
    order, lb, ub = K.build_probe(e, torch.tensor([1, 2], dtype=torch.int32))
    assert order.shape == (0,) and lb.tolist() == [0, 0] and \
        ub.tolist() == [0, 0]
    order, lb, ub = K.build_probe(torch.tensor([3, 1], dtype=torch.int32), e)
    assert order.tolist() == [1, 0] and lb.shape == (0,)


def test_segment_any_matches_reference():
    rng = np.random.default_rng(17)
    mask = rng.random(1000) < 0.05
    gid = np.sort(rng.integers(0, 300, 1000))
    mine = K.segment_any(_t(mask), _t(gid), 300)
    ref = RK.segment_any(jnp.asarray(mask), jnp.asarray(gid), 300)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
