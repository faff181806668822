"""Dynamic filtering in presto_tpu_torch against presto_tpu's, on the CPU.

- The runtime-filter kernels (`rf_build`, `rf_probe`, `rf_domain`,
  `rf_bloom_bits`, `_rf_mix64`) on inputs made with numpy from a seed,
  over the cases of tests/test_dynamic_filters.py: key dtype int64,
  int32 or int16, structure exact or bloom, build plain, masked, empty
  or disjoint from the probe.  The exact keys, the bloom bits and the
  probe masks must equal presto_tpu's bit for bit: a bloom bit that
  differs shows as a different count of pruned rows.
- A join whose build capacity passes RF_EXACT_MAX, so the executor
  builds a bloom filter: its pruned rows equal presto_tpu's, in both
  executors, and its rows equal the unfiltered run's.
- The kill switches: the session property `dynamic_filtering` and the
  environment's PRESTO_TPU_DYNAMIC_FILTERS give zero filter counters and
  the same rows, in both executors, as they do in presto_tpu.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto_tpu
import presto_tpu_torch
from presto_tpu import types as RT
from presto_tpu.batch import Column as RColumn
from presto_tpu.catalog import Catalog as RCatalog
from presto_tpu.catalog import MemoryTable as RMemoryTable
from presto_tpu.exec import kernels as RK
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Column
from presto_tpu_torch.catalog import Catalog, MemoryTable, tpch_catalog
from presto_tpu_torch.exec import kernels as K
from presto_tpu_torch.plan import runtime_filters as RF
from presto_tpu_torch.tpch_queries import QUERIES
from tests.test_torch_tpch import _assert_rows_match
from tests.torch_threads import torch_one_thread  # noqa: F401

DF_KEYS = ("df_filters_produced", "df_filters_applied", "df_rows_pruned")

_TYPES = {np.int64: "BIGINT", np.int32: "INTEGER", np.int16: "SMALLINT"}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _col_pair(vals, valid=None):
    t = _TYPES[vals.dtype.type]
    return (RColumn(jnp.asarray(vals), None if valid is None
                    else jnp.asarray(valid), RT.parse_type(t)),
            Column(_t(vals), None if valid is None else _t(valid),
                   T.parse_type(t)))


def _membership_inputs(dtype, case):
    """tests/test_dynamic_filters.py's inputs: a 300-row build, a
    2,000-row probe with every seventh key NULL."""
    rng = np.random.default_rng(7)
    nb, npr = 300, 2000
    if case == "empty":
        bvals = np.zeros((0,), dtype)
        blive = np.zeros((0,), bool)
    else:
        bvals = rng.integers(0, 500, nb).astype(dtype)
        blive = np.ones(nb, bool)
        if case == "masked":
            blive[::3] = False
    if case == "all_pruned":
        pvals = rng.integers(600, 900, npr).astype(dtype)  # disjoint
    else:
        pvals = rng.integers(0, 700, npr).astype(dtype)
    pvalid = np.ones(npr, bool)
    pvalid[::7] = False
    return bvals, blive, pvals, pvalid


@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.int16])
@pytest.mark.parametrize("structure", ["exact", "bloom"])
@pytest.mark.parametrize("case", ["plain", "masked", "empty", "all_pruned"])
def test_rf_build_and_probe_match_reference(dtype, structure, case):
    bvals, blive, pvals, pvalid = _membership_inputs(dtype, case)
    rb, pb = _col_pair(bvals)
    rp, pp = _col_pair(pvals, pvalid)
    ref = RK.rf_build(rb, jnp.asarray(blive), structure=structure)
    mine = K.rf_build(pb, _t(blive), structure=structure)
    assert mine["kind"] == ref["kind"] == structure
    field = "keys" if structure == "exact" else "bits"
    assert mine[field].dtype == (torch.int64 if structure == "exact"
                                 else torch.bool)
    np.testing.assert_array_equal(mine[field].numpy(),
                                  np.asarray(ref[field]))
    mask = K.rf_probe(mine, pp).numpy()
    np.testing.assert_array_equal(mask, np.asarray(RK.rf_probe(ref, rp)))
    # the contract itself: exact is membership, bloom never drops a match
    keep = set(bvals[blive].tolist())
    member = np.array([bool(v) and x in keep
                       for x, v in zip(pvals.tolist(), pvalid.tolist())])
    if structure == "exact":
        np.testing.assert_array_equal(mask, member)
    else:
        assert (mask | ~member).all()
        if case == "all_pruned":
            assert mask.mean() < 0.10


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rf_mix64_matches_reference(seed):
    """The uint64 mixing, run on int64 bit patterns: negative keys, the
    int64 extremes and keys whose hashes pass 2^63."""
    rng = np.random.default_rng(seed)
    v = np.concatenate([rng.integers(-2**63, 2**63 - 1, 5_000,
                                     dtype=np.int64),
                        np.array([0, -1, 1, 2**63 - 1, -2**63], np.int64)])
    ref = np.asarray(RK._rf_mix64(jnp.asarray(v)))
    mine = K._rf_mix64(_t(v))
    assert mine.dtype == torch.int64
    np.testing.assert_array_equal(mine.numpy().view(np.uint64), ref)
    assert (ref >= np.uint64(1 << 63)).any()  # the sign bit is exercised
    nbits = K.rf_bloom_bits(len(v))
    for rpos, pos in zip(RK._rf_bloom_positions(jnp.asarray(ref), nbits),
                         K._rf_bloom_positions(mine, nbits)):
        np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))


@pytest.mark.parametrize("n", [0, 1, 64, 1_000, 131_072, 131_073, 6_000_000])
def test_rf_bloom_bits_matches_reference(n):
    assert K.rf_bloom_bits(n) == RK.rf_bloom_bits(n)


def test_rf_auto_structure_follows_capacity():
    """"auto" chooses by the build's capacity, not its live rows: one
    live row in a column of RF_EXACT_MAX + 1 rows builds a bloom."""
    assert K.RF_EXACT_MAX == RK.RF_EXACT_MAX
    for n, kind in ((K.RF_EXACT_MAX, "exact"), (K.RF_EXACT_MAX + 1, "bloom")):
        vals = np.arange(n, dtype=np.int64)
        live = np.zeros(n, bool)
        live[5] = True
        rc, pc = _col_pair(vals)
        ref = RK.rf_build(rc, jnp.asarray(live))
        mine = K.rf_build(pc, _t(live))
        assert mine["kind"] == ref["kind"] == kind
        field = "keys" if kind == "exact" else "bits"
        np.testing.assert_array_equal(mine[field].numpy(),
                                      np.asarray(ref[field]))


@pytest.mark.parametrize("case", ["plain", "masked", "nulls", "empty",
                                  "all_dead"])
def test_rf_domain_matches_reference(case):
    rng = np.random.default_rng(["plain", "masked", "nulls", "empty",
                                 "all_dead"].index(case))
    n = 0 if case == "empty" else 1_000
    vals = rng.integers(-10**12, 10**12, n).astype(np.int64)
    live = np.ones(n, bool) if case != "all_dead" else np.zeros(n, bool)
    if case == "masked":
        live = rng.random(n) < 0.3
    valid = rng.random(n) < 0.5 if case == "nulls" else None
    rc, pc = _col_pair(vals, valid)
    ref = RK.rf_domain(rc, jnp.asarray(live))
    mine = K.rf_domain(pc, _t(live))
    assert [int(x) for x in mine] == [int(x) for x in ref]


# ---- through the executors --------------------------------------------------

BLOOM_BUILD_ROWS = K.RF_EXACT_MAX + 8_869  # 140,941: a bloom build
BLOOM_PROBE_ROWS = 600_000
BLOOM_SQL = ("SELECT count(*), sum(p.v) FROM probe p, build b "
             "WHERE p.k = b.k AND b.w < 70000")


def _bloom_tables():
    """A build of unique keys and a probe four times wider whose keys
    mostly miss it, as {table: (schema, columns)}."""
    rng = np.random.default_rng(41)
    bk = rng.choice(1 << 40, BLOOM_BUILD_ROWS, replace=False).astype(np.int64)
    pk = rng.integers(0, 1 << 40, BLOOM_PROBE_ROWS).astype(np.int64)
    pk[::50] = bk[rng.integers(0, BLOOM_BUILD_ROWS, len(pk[::50]))]
    return {
        "build": ({"k": "BIGINT", "w": "BIGINT"},
                  {"k": bk, "w": rng.integers(0, 140_000, BLOOM_BUILD_ROWS)}),
        "probe": ({"k": "BIGINT", "v": "BIGINT"},
                  {"k": pk, "v": rng.integers(0, 1_000, BLOOM_PROBE_ROWS)}),
    }


def _catalogs(tables):
    ref, port = RCatalog(), Catalog()
    for name, (schema, cols) in tables.items():
        ref.register(RMemoryTable(name, {c: RT.parse_type(t)
                                         for c, t in schema.items()}, cols))
        port.register(MemoryTable(name, {c: T.parse_type(t)
                                         for c, t in schema.items()}, cols))
    return ref, port


def _df(stats):
    return [getattr(stats, k) for k in DF_KEYS]


@pytest.fixture(scope="module")
def bloom_catalogs():
    return _catalogs(_bloom_tables())


@pytest.mark.parametrize("mode", ["dynamic", "auto"])
def test_bloom_filter_prunes_what_the_reference_prunes(mode, bloom_catalogs):
    ref_cat, port_cat = bloom_catalogs
    ref = presto_tpu.connect(ref_cat, execution_mode=mode).sql(BLOOM_SQL)
    on = presto_tpu_torch.connect(port_cat, device="cpu",
                                  execution_mode=mode).sql(BLOOM_SQL)
    off = presto_tpu_torch.connect(port_cat, device="cpu",
                                   execution_mode=mode,
                                   dynamic_filtering=False).sql(BLOOM_SQL)
    assert _df(on.stats) == _df(ref.stats)
    assert on.stats.df_filters_applied == 1
    if mode == "dynamic":
        # the bloom prunes most of the probe; a false positive is kept
        assert 0.9 * BLOOM_PROBE_ROWS < on.stats.df_rows_pruned \
            < BLOOM_PROBE_ROWS
    assert on.rows == off.rows == ref.rows
    assert _df(off.stats) == [0, 0, 0]


@pytest.fixture(scope="module")
def q17_port_cat():
    return tpch_catalog(0.01)


@pytest.mark.parametrize("mode", ["dynamic", "auto"])
@pytest.mark.parametrize("switch", ["property", "env"])
def test_kill_switches_give_zero_counters_and_same_rows(
        switch, mode, q17_port_cat, tpch_catalog_tiny, monkeypatch):
    """Q17 prunes lineitem's rows with dynamic filtering on; either
    switch turns the filter off, as presto_tpu's do, with the same
    rows."""
    sql = QUERIES[17]
    on = presto_tpu_torch.connect(q17_port_cat, device="cpu",
                                  execution_mode=mode).sql(sql)
    props = {}
    if switch == "property":
        props["dynamic_filtering"] = False
    else:
        monkeypatch.setenv(RF.ENV_KILL, "off")
    off = presto_tpu_torch.connect(q17_port_cat, device="cpu",
                                   execution_mode=mode, **props).sql(sql)
    ref_off = presto_tpu.connect(tpch_catalog_tiny, execution_mode=mode,
                                 **props).sql(sql)
    assert on.stats.df_filters_applied == 1
    assert _df(off.stats) == _df(ref_off.stats) == [0, 0, 0]
    _assert_rows_match(off.rows, on.rows, ordered=True)
