"""float32_compute in presto_tpu_torch against presto_tpu on the CPU.

Under the session property DOUBLE columns scan as float32 (a second
per-table cache, exec/executor.py scan_batch), expressions follow jnp's
promotion (an f32 column stays f32 beside a Python number and widens
beside a strong f64, functions/decimals.py jax_float_promote), sums
accumulate as the reference's do (the fused prepass in f64 from f32
rows, the global and grouped segment sums in f32) and a write stores the
f32-rounded values.

- All 22 TPC-H queries at SF0.01 in "dynamic", "auto" and "compiled":
  the port's records against presto_tpu's, frozen in
  tests/torch_geo_ml_frozen.json (`JAX_PLATFORMS=cpu python -m
  tests.torch_geo_ml_common` rewrites it; presto_tpu's compiles of the
  66 runs take minutes): errors, types, execution mode, the seven
  counters and memo entries equal; floats within
  geo_ml_queries.f32_tolerance (two runs' bounds: the f32 operations of a
  value, u = 2^-24 each, and each sum's gamma_d, d the most additions a
  term passes in that sum's order, relative to the value, the sum of |x|
  for these sums of non-negative terms), and each float an f32 value
  exactly where presto_tpu's is.
- A CTAS and an INSERT under the property store presto_tpu's values bit
  for bit, in every mode.
- The fused prepass stacks f32 rows under the property (the kernel's
  f32-input entry on the card); the plain fused_group_sums over f32 rows
  equals presto_tpu's interpreter kernel over the same rows widened.
- segment_sum over f32 on its global and one-hot paths stays f32, as
  the reference's does, within gamma_d of the sum of |x| (the global
  sum in windows of 32, kernels.window_sum32, as XLA sums on the CPU).
- f32 keys order, group and join as presto_tpu's CPU path does (-0.0
  equal to 0.0, every NaN last); a strong f64 constant beside an f32
  column promotes it as jnp does.
"""

import json
import math

import numpy as np
import pytest
import torch

import presto_tpu
import presto_tpu_torch
from presto_tpu import types as RT
from presto_tpu.catalog import Catalog as RCatalog
from presto_tpu_torch import geo_ml_queries as GQ
from presto_tpu_torch import types as T
from presto_tpu_torch.catalog import Catalog, tpch_catalog
from presto_tpu_torch.exec import kernels as K
from tests import torch_geo_ml_common as C
from tests.torch_threads import torch_one_thread  # noqa: F401

MODES = ("dynamic", "auto", "compiled")


@pytest.fixture(scope="module")
def catalog():
    return tpch_catalog(0.01)


@pytest.fixture(scope="module")
def runs(catalog):
    """{mode: {Q<n>: record}} of the port, each mode's 22 queries in one
    session, run once on first use."""
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = C.f32_runs("port", catalog, C.TPCH_IDS,
                                     (mode,))[mode]
        return cache[mode]

    return get


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("qid", C.TPCH_IDS)
def test_query_matches_reference_under_float32_compute(qid, mode, runs,
                                                       catalog):
    mine = runs(mode)[f"Q{qid}"]
    theirs = C.frozen()["f32"][mode][f"Q{qid}"]
    assert GQ.mismatch(f"Q{qid}", {**mine, "rows": None},
                       {**theirs, "rows": None}) == ""
    n = catalog.get("lineitem").row_count()
    assert GQ.f32_mismatch(qid, mine["rows"], theirs["rows"], n) == ""


@pytest.mark.slow
def test_frozen_f32_records_are_presto_tpus():
    """The "f32" records of tests/torch_geo_ml_frozen.json are
    presto_tpu's: its 22 queries in the three modes, rerun live."""
    cat = C.tpch("ref", 0.01, "/tmp/presto_tpu_cache")
    got = C.f32_runs("ref", cat, C.TPCH_IDS, MODES)
    assert json.loads(json.dumps(got)) == C.frozen()["f32"]


def test_f32_tolerances_are_the_stated_bounds():
    u = 2.0 ** -24
    n = 60_175
    # Q1's sum_charge: four f32 operations a row, an f64 sum of n rows
    assert GQ.f32_tolerance(1, 5, n) == 2 * (4 * u + GQ.gamma(n, 2.0 ** -53))
    # Q6's revenue: one operation, a global f32 sum in windows of 32:
    # 60,175 -> 1,881 -> 59 -> 2 -> 1, four levels of at most 31
    assert GQ.sum_depth("window", n) == 4 * 31
    assert GQ.f32_tolerance(6, 0, n) == 2 * (u + 124 * u / (1 - 124 * u))
    # Q14's ratio of two global sums: six operations, two sums
    assert GQ.f32_tolerance(14, 0, n) == 2 * (6 * u + 2 * GQ.gamma(124, u))
    # Q3's revenue: an f32 sum of one order's lines, at most 7
    assert GQ.f32_tolerance(3, 1, n) == 2 * (2 * u + GQ.gamma(7, u))
    assert GQ.f32_tolerance(1, 0, n) is None  # l_returnflag: exact


def test_f32_bounds_at_sf1_are_far_below_one():
    """The chip's F32 queries at SF1: every bound under 2e-5 (the
    largest, Q6's, 1.86e-5: five levels of windows), so a wrong or f64
    revenue does not pass."""
    n = 6_001_215
    assert GQ.sum_depth("window", n) == 5 * 31
    bounds = {(q, c): GQ.f32_tolerance(q, c, n)
              for q in GQ.F32_QUERIES for c in GQ.F32_COLUMNS[q]}
    assert max(bounds.values()) == bounds[(6, 0)] < 2e-5
    # an f64 revenue within the bound of presto_tpu's f32 one is still
    # refused: it is no f32 value
    assert GQ.f32_mismatch(6, [(1234567.8910111213,)], [(1234567.875,)],
                           60_175) != ""


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 1025, 60_175])
def test_window_sum32_is_the_windowed_f32_sum(n):
    """kernels.window_sum32: f32 out, within gamma of 31 additions a
    level of the exact sum, as presto_tpu's jnp.sum; windows level by
    level."""
    import jax.numpy as jnp

    rng = np.random.default_rng(n)
    x = (rng.random(n) * 100).astype(np.float32)
    mine = K.window_sum32(torch.from_numpy(x))
    assert mine.dtype == torch.float32 and mine.shape == ()
    exact = math.fsum(x.astype(np.float64))
    bound = GQ.gamma(GQ.sum_depth("window", n), 2.0 ** -24) \
        * float(np.abs(x).sum(dtype=np.float64))
    for got in (float(mine), float(jnp.sum(jnp.asarray(x)))):
        assert abs(got - exact) <= bound


# ---------------------------------------------------------------------------
# writes
# ---------------------------------------------------------------------------

_WRITES = (
    "CREATE TABLE memory.default.t AS SELECT l_orderkey, l_extendedprice, "
    "l_extendedprice * (1 - l_discount) AS r FROM lineitem "
    "WHERE l_orderkey < 200",
    "INSERT INTO memory.default.t SELECT l_orderkey, l_extendedprice, "
    "l_discount FROM lineitem WHERE l_orderkey < 20")


@pytest.mark.parametrize("mode", MODES)
def test_writes_store_the_reference_f32_values(mode, tpch_catalog_tiny):
    from presto_tpu.catalog import tpch_catalog as ref_tpch

    ref_cat = ref_tpch(0.01, "/tmp/presto_tpu_cache")
    port_cat = tpch_catalog(0.01)
    stored = []
    for lib, cat, kw in ((presto_tpu, ref_cat, {}),
                         (presto_tpu_torch, port_cat, {"device": "cpu"})):
        s = lib.connect(cat, execution_mode=mode, float32_compute=True,
                        **kw)
        for sql in _WRITES:
            s.sql(sql)
        data = cat.get("memory.default.t").read(
            ["l_orderkey", "l_extendedprice", "r"])
        stored.append({c: np.asarray(v) for c, v in data.items()})
    mine, theirs = stored[1], stored[0]
    assert mine["l_orderkey"].tolist() == theirs["l_orderkey"].tolist()
    for c in ("l_extendedprice", "r"):
        assert mine[c].dtype == theirs[c].dtype == np.float64
        assert np.array_equal(mine[c].view(np.int64),
                              theirs[c].view(np.int64)), c
        # the f32-rounded values, widened
        assert np.array_equal(mine[c], mine[c].astype(np.float32)
                              .astype(np.float64)), c


# ---------------------------------------------------------------------------
# the fused prepass and the kernels' plain versions
# ---------------------------------------------------------------------------


def test_fused_prepass_stacks_f32_rows(catalog, monkeypatch):
    seen = []
    real = K.fused_group_sums

    def spy(vals, gid, n_groups):
        seen.append((vals.dtype, tuple(vals.shape), n_groups))
        return real(vals, gid, n_groups)

    monkeypatch.setattr(K, "fused_group_sums", spy)
    n = catalog.get("lineitem").row_count()
    for f32, dtype in ((True, torch.float32), (False, torch.float64)):
        seen.clear()
        presto_tpu_torch.connect(catalog, device="cpu",
                                 execution_mode="dynamic",
                                 float32_compute=f32).sql(
            "SELECT l_returnflag, sum(l_extendedprice * (1 - l_discount)) "
            "FROM lineitem GROUP BY 1")
        # one aggregate is enough under the property (two without)
        assert seen == ([(dtype, (2, n), 3)] if f32 else [])


@pytest.mark.parametrize("k,n,G", [(15, 60_175, 4), (3, 40_000, 100),
                                   (2, 8_191, 1)])
def test_plain_fused_group_sums_over_f32_rows(k, n, G):
    from presto_tpu.exec import kernels as RK

    rng = np.random.default_rng(k * n + G)
    vals = (rng.random((k, n)) * 1e4).astype(np.float32)
    gid = rng.integers(0, G, n).astype(np.int32)
    mine = K.fused_group_sums(torch.from_numpy(vals), torch.from_numpy(gid),
                              G)
    assert mine.dtype == torch.float64
    theirs = np.asarray(RK.fused_group_sums(
        RK.jnp.asarray(vals.astype(np.float64)), RK.jnp.asarray(gid), G))
    scale = np.zeros((k, G))
    for j in range(k):
        np.add.at(scale[j], gid, np.abs(vals[j].astype(np.float64)))
    assert np.all(np.abs(mine.numpy() - theirs) <= 1e-13 * scale)
    exact = np.asarray([[math.fsum(vals[j][gid == g].astype(np.float64))
                         for g in range(G)] for j in range(k)])
    assert np.all(np.abs(mine.numpy() - exact) <= 1e-13 * scale)


@pytest.mark.parametrize("n,G", [(50_000, 1), (50_000, 64), (50_000, 5000)])
def test_segment_sum_over_f32_keeps_f32(n, G):
    """The global sum (G = 1), the one-hot path (G <= 4096) and the
    scatter path: f32 in, f32 out, as the reference's."""
    from presto_tpu.exec import kernels as RK

    rng = np.random.default_rng(n + G)
    x = (rng.random(n) * 100).astype(np.float32)
    gid = rng.integers(0, G, n).astype(np.int32)
    mine = K.segment_sum(torch.from_numpy(x), torch.from_numpy(gid), G)
    theirs = np.asarray(RK.segment_sum(RK.jnp.asarray(x),
                                       RK.jnp.asarray(gid), G))
    assert mine.dtype == torch.float32 and theirs.dtype == np.float32
    scale = np.bincount(gid, weights=np.abs(x), minlength=G)
    counts = np.bincount(gid, minlength=G)
    # the global sum adds in windows of 32 in both packages
    depths = [GQ.sum_depth("window" if G == 1 else "f32", int(c))
              for c in counts]
    bound = np.asarray([GQ.gamma(d, 2.0 ** -24) for d in depths]) * scale
    exact = np.bincount(gid, weights=x.astype(np.float64), minlength=G)
    for got in (mine.numpy().astype(np.float64), theirs.astype(np.float64)):
        assert np.all(np.abs(got - exact) <= bound)


# ---------------------------------------------------------------------------
# f32 keys and promotion
# ---------------------------------------------------------------------------

_KEYS = np.asarray([1.5, -0.0, np.nan, 0.0, -2.25, 1.5, np.nan, 3.0e38,
                    -1e-30, 0.1])
_KEY_QUERIES = (
    "SELECT x, i FROM k ORDER BY x, i",
    "SELECT x, i FROM k ORDER BY x DESC, i",
    "SELECT x, count(*), sum(i) FROM k GROUP BY x ORDER BY 2, 3",
    "SELECT a.i, b.i FROM k a JOIN k b ON a.x = b.x ORDER BY 1, 2",
    "SELECT sum(x * sqrt(2.0)), sum(x / sqrt(3.0)), "
    "count_if(x < sqrt(2.0)), sum(x * 0.1) FROM k WHERE x < 1e30",
)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sql", _KEY_QUERIES)
def test_f32_keys_and_promotion_match_reference(sql, mode):
    cols = {"x": _KEYS, "i": np.arange(len(_KEYS), dtype=np.int64)}
    out = []
    for lib, cat, types, kw in (
            (presto_tpu, RCatalog(), RT, {}),
            (presto_tpu_torch, Catalog(), T, {"device": "cpu"})):
        cat.register_memory("k", {"x": types.DOUBLE, "i": types.BIGINT},
                            {c: v.copy() for c, v in cols.items()})
        s = lib.connect(cat, execution_mode=mode, float32_compute=True,
                        **kw)
        res = s.sql(sql)
        out.append((res.rows, res.stats.execution_mode,
                    GQ.memo_state(s, sql)))
    (theirs, tmode, tmemo), (mine, mmode, mmemo) = out
    assert (mmode, mmemo) == (tmode, tmemo)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        for x, y in zip(a, b):
            if isinstance(x, float) and isinstance(y, float):
                assert (math.isnan(x) and math.isnan(y)) or x == y \
                    or abs(x - y) <= 2 * GQ.gamma(len(_KEYS), 2.0 ** -24) \
                    * max(abs(x), abs(y)), (a, b)
            else:
                assert x == y, (a, b)


# ---------------------------------------------------------------------------
# the f32-input kernel's launch arithmetic (the CUDA paths run on the
# card alone: chip_smoke.py holds them against the plain version)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("elem_bytes", [8, 4])
@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 7, 8, 8191, 6_000_601])
def test_register_path_vectors_cover_every_row_once(n, elem_bytes):
    """csrc/fused_group_sums.cu's register path: every value row has
    `vecs` 16-byte vectors starting at its own offset h (the elements a
    row starts past a 16-byte boundary), thread 0 of block 0 adds the h
    before them and the tail; for every h the vectors, the head and the
    tail cover [0, n) once, and a thread's gid reads stay below n."""
    e = 16 // elem_bytes
    vecs = K.fgs_vectors(n, elem_bytes)
    assert vecs == ((n - e + 1) // e if n >= e else 0)
    for h in range(e) if vecs else (0,):
        starts = e * np.arange(vecs) + h
        covered = np.bincount((starts[:, None] + np.arange(e)).ravel(),
                              minlength=n)
        covered[:h] += 1  # the head, then the tail
        covered[e * vecs + h:] += 1
        assert len(covered) == n and np.all(covered == 1)
        if vecs:  # a thread's last gid read, i + 2E - 2
            assert e * (vecs - 1) + 2 * e - 2 < n


def test_launch_plan_counts_f32_vectors():
    sm = 132
    f64 = K.fused_group_sums_launch_shape(6_000_601, 15, 16, sm)
    f32 = K.fused_group_sums_launch_shape(6_000_601, 15, 16, sm, 4)
    assert (f64.path, f32.path) == ("registers", "registers")
    assert (f64.slices, f64.rows_per_slice) == (f32.slices, f32.rows_per_slice)
    # Q1's four groups: one block of 256 threads a 1,024 f32 values
    small = K.fused_group_sums_launch_shape(40_000, 15, 4, sm, 4)
    assert small.blocks == -(-K.fgs_vectors(40_000, 4) // 256) == 40
    assert K.fused_group_sums_launch_shape(50_000, 3, 17, sm, 4).path \
        == "shared_table"
