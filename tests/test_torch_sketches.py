"""The sketch kernels of presto_tpu_torch (exec/kernels.py: hll_hash64,
hll_registers_and_estimate, hll_m_for_error, hll_estimate,
sketch_sample_mask, group_percentile) and its XXH64 (exec/xxh64.py)
against presto_tpu's functions on the same numpy inputs, on the CPU.

The XXH64 is held bit for bit to presto_tpu.native.xxh64 (the C++
pt_xxh64) at every length from 0 to 100 bytes, over multibyte UTF-8 and
lone surrogates (encoded with surrogatepass), and at the known vectors.
The hashes compare as uint64 bits (the port keeps them as int64),
estimates and percentiles exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import native
from presto_tpu import types as RT
from presto_tpu.batch import Column as RColumn
from presto_tpu.batch import Dictionary as RDictionary
from presto_tpu.exec import kernels as RK
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Column, Dictionary
from presto_tpu_torch.exec import kernels as K
from presto_tpu_torch.exec.xxh64 import xxh64, xxh64_values
from tests.torch_threads import torch_one_thread  # noqa: F401


def test_xxh64_known_vectors():
    assert xxh64(b"") == 0xEF46DB3751D8E999
    assert xxh64(b"abc") == 4952883123889572249 == native.xxh64(b"abc")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_xxh64_every_length_to_100(seed):
    rng = np.random.default_rng(seed)
    for n in range(101):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert xxh64(data) == native.xxh64(data), n
        assert xxh64(data, seed=seed) == native.xxh64(data, seed), n


def test_xxh64_values_match_native_over_utf8():
    rng = np.random.default_rng(4)
    values = ["", "a", "héllo", "日本語テキスト", "\ud800lone", "x" * 33,
              "emoji \U0001F600 " * 5]
    values += ["".join(chr(int(c)) for c in rng.integers(32, 0x2FFF, n))
               for n in range(0, 70)]
    got = xxh64_values(values)
    want = [native.xxh64(v.encode("utf-8", "surrogatepass"))
            for v in values]
    assert got.dtype == np.uint64
    assert got.tolist() == want


def _pair(kind, n, rng):
    """The same column in both packages: (port Column, presto_tpu
    Column)."""
    valid = rng.random(n) > 0.2
    if kind == "string":
        words = np.array(sorted({f"w{int(v)}é" for v in
                                 rng.integers(0, 500, 300)}), dtype=object)
        codes = rng.integers(0, len(words), n).astype(np.int32)
        return (Column(torch.from_numpy(codes), torch.from_numpy(valid),
                       T.VARCHAR, Dictionary(words)),
                RColumn(jnp.asarray(codes), jnp.asarray(valid), RT.VARCHAR,
                        RDictionary(words)))
    if kind == "double":
        data = rng.normal(0, 1e6, n)
        data[:6] = [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324]
        t, rt = T.DOUBLE, RT.DOUBLE
    elif kind == "date":
        data = rng.integers(-5000, 20000, n).astype(np.int32)
        t, rt = T.DATE, RT.DATE
    else:
        data = rng.integers(-(1 << 62), 1 << 62, n)
        data[:3] = [0, -1, np.iinfo(np.int64).min]
        t, rt = T.BIGINT, RT.BIGINT
    return (Column(torch.from_numpy(data), torch.from_numpy(valid), t),
            RColumn(jnp.asarray(data), jnp.asarray(valid), rt))


KINDS = ["bigint", "double", "date", "string"]


@pytest.mark.parametrize("kind", KINDS)
def test_hll_hash64_and_sample_mask(kind):
    port, ref = _pair(kind, 3000, np.random.default_rng(9))
    h = K.hll_hash64(port)
    rh = RK.hll_hash64(ref)
    assert h.dtype == torch.int64
    assert np.array_equal(h.numpy().view(np.uint64), np.asarray(rh))
    assert np.array_equal(K.sketch_sample_mask(h).numpy(),
                          np.asarray(RK.sketch_sample_mask(rh)))


@pytest.mark.parametrize("e", [0.5, 0.13, 0.0651, 0.0325, 0.023, 0.01625,
                               0.0081, 0.0040625, 0.001, 1e-9])
def test_hll_m_for_error(e):
    assert K.hll_m_for_error(e) == RK.hll_m_for_error(e)


@pytest.mark.parametrize("m", [64, 1024, 65536])
def test_hll_estimate(m):
    rng = np.random.default_rng(m)
    M = rng.integers(0, 34, (6, m))
    M[0] = 0                      # empty: linear counting of 0
    M[1] = np.where(rng.random(m) < 0.98, 0, M[1])  # small range
    M[2] = rng.integers(20, 34, m)  # no zero register
    got = K.hll_estimate(torch.from_numpy(M))
    want = np.asarray(RK.hll_estimate(jnp.asarray(M)))
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_groups,m", [(1, 1024), (7, 64), (37, 65536),
                                        (9000, 1024), (300, 65536)])
def test_hll_registers_and_estimate(kind, n_groups, m):
    rng = np.random.default_rng(n_groups)
    n = 20_000
    port, ref = _pair(kind, n, rng)
    gid = rng.integers(0, n_groups, n)
    gid[::17] = n_groups  # masked rows carry the dead group id
    valid = port.valid & torch.from_numpy(gid < n_groups)
    got = K.hll_registers_and_estimate(
        K.hll_hash64(port), valid, torch.from_numpy(gid).to(torch.int32),
        n_groups, m)
    want = RK.hll_registers_and_estimate(
        RK.hll_hash64(ref), jnp.asarray(valid.numpy()),
        jnp.asarray(gid.astype(np.int32)), n_groups, m)
    assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("p", [0.0, 0.25, 0.5, 0.99, 1.0])
@pytest.mark.parametrize("kind", ["double", "bigint", "ties"])
def test_group_percentile(kind, p):
    rng = np.random.default_rng(int(p * 100))
    n, n_groups = 5000, 40
    if kind == "double":
        x = rng.normal(0, 10, n)
        x[:40] = [0.0, -0.0] * 20  # ties of +-0 keep their rows' order
        x[40:50] = np.nan
    elif kind == "ties":
        x = rng.integers(0, 4, n).astype(np.float64) - 1.5
    else:
        x = rng.integers(-1000, 1000, n)
    gid = rng.integers(0, n_groups, n)
    gid[gid == 5] = 6  # an empty group
    valid = rng.random(n) > 0.15
    valid[gid == 9] = False  # a group of NULLs only
    got, ok = K.group_percentile(torch.from_numpy(x), torch.from_numpy(valid),
                                 torch.from_numpy(gid).to(torch.int32),
                                 n_groups, p)
    want, rok = RK.group_percentile(jnp.asarray(x), jnp.asarray(valid),
                                    jnp.asarray(gid.astype(np.int32)),
                                    n_groups, p)
    assert ok.tolist() == np.asarray(rok).tolist()
    got, want = got.numpy()[ok.numpy()], np.asarray(want)[np.asarray(rok)]
    assert got.dtype == want.dtype
    assert np.array_equal(got.view(np.int64) if got.dtype == np.float64
                          else got, want.view(np.int64)
                          if want.dtype == np.float64 else want)
