"""The host aggregates of presto_tpu_torch/exec/host_aggs.py (approx_set,
merge, qdigest_agg, tdigest_agg, map_union_sum, approx_most_frequent,
min_by / max_by with a count, reduce_agg) and approx_percentile over an
ARRAY of percentiles or with a weight, on a seeded memory table with
NULLs, through both packages in "dynamic", "auto" and "compiled": every
statement's record equal to presto_tpu's (rows with blobs byte for byte
and floats within 1e-9, types, execution mode, the seven counters, the
memo entry, and in "compiled" the StaticFallback by type).  Then the
two reference behaviours the port copies (ROADMAP C), held to
presto_tpu's outcome: a sketch persisted by CREATE TABLE AS raises a
ValueError when read back, and a wall clock in New York's 2020 DST gap
resolves one hour back.
"""

import numpy as np
import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu import types as RT
from presto_tpu.catalog import Catalog as RefCatalog
from presto_tpu.catalog import MemoryTable as RefMemoryTable
from presto_tpu_torch import types as T
from presto_tpu_torch import zone_sketch_queries as ZQ
from presto_tpu_torch.catalog import Catalog, MemoryTable
from presto_tpu_torch.exec.executor import SORT_STATS_KEYS
from tests.torch_threads import torch_one_thread  # noqa: F401

MODES = ("dynamic", "auto", "compiled")
_N = 4000


def _columns():
    rng = np.random.default_rng(17)
    x = rng.normal(100, 30, _N).round(2)
    w = rng.integers(0, 6, _N).astype(np.float64)
    return {
        "g": rng.integers(0, 5, _N).astype(np.int64),
        "k": rng.integers(0, 300, _N).astype(np.int64),
        "x": np.ma.masked_array(x, mask=rng.random(_N) < 0.05),
        "w": w,
        "s": np.asarray([f"v{v:02d}" for v in rng.integers(0, 40, _N)],
                        dtype=object),
        "d": rng.integers(8000, 8400, _N).astype(np.int32),
    }


_SCHEMA = {"g": "BIGINT", "k": "BIGINT", "x": "DOUBLE", "w": "DOUBLE",
           "s": "VARCHAR", "d": "DATE"}


def _catalog(pkg):
    cols = _columns()
    if pkg == "port":
        cat = Catalog()
        cat.register(MemoryTable("h", {c: getattr(T, t)
                                       for c, t in _SCHEMA.items()}, cols))
    else:
        cat = RefCatalog()
        cat.register(RefMemoryTable("h", {c: getattr(RT, t)
                                          for c, t in _SCHEMA.items()},
                                    cols))
    return cat


@pytest.fixture(scope="module")
def catalogs():
    return {"port": _catalog("port"), "ref": _catalog("ref")}


QUERIES = {
    "approx_set": (
        "SELECT g, cardinality(approx_set(k)), approx_set(s), "
        "approx_set(x), approx_set(d) FROM h GROUP BY g ORDER BY g"),
    "merge": (
        "SELECT cardinality(merge(a)), value_at_quantile(merge(t), 0.5), "
        "value_at_quantile(merge(q), 0.5) FROM (SELECT g, approx_set(k) a, "
        "tdigest_agg(x) t, qdigest_agg(x) q FROM h GROUP BY g) u"),
    "digests": (
        "SELECT g, qdigest_agg(x), tdigest_agg(x), tdigest_agg(x, w), "
        "tdigest_agg(k, w, 40) FROM h GROUP BY g ORDER BY g"),
    "digests_filtered": (
        "SELECT g, tdigest_agg(x) FILTER (WHERE k > 150), "
        "qdigest_agg(k) FILTER (WHERE s < 'v20') FROM h "
        "GROUP BY g ORDER BY g"),
    "percentiles": (
        "SELECT g, approx_percentile(x, ARRAY[0.1, 0.5, 0.9]), "
        "approx_percentile(x, w, 0.5), approx_percentile(k, w, 0.25), "
        "approx_percentile(k, ARRAY[0.5, 0.75]), "
        "approx_percentile(x, w, ARRAY[0.2, 0.8]) "
        "FROM h GROUP BY g ORDER BY g"),
    "global_percentile": (
        "SELECT approx_percentile(x, ARRAY[0.01, 0.99]), "
        "approx_percentile(x, w, 0.5) FROM h WHERE g < 0"),
    "most_frequent": (
        "SELECT g, approx_most_frequent(3, s, 100), "
        "approx_most_frequent(2, k % 7, 50) FROM h GROUP BY g ORDER BY g"),
    "min_max_by_n": (
        "SELECT g, min_by(s, x, 3), max_by(k, d, 4), min_by(x, k, 2), "
        "max_by(s, s, 2) FROM h GROUP BY g ORDER BY g"),
    "reduce_agg": (
        "SELECT g, reduce_agg(x, 0.0, (a, v) -> a + v, (a, b) -> a + b), "
        "reduce_agg(k, 1, (a, v) -> a * 2 + v % 3, (a, b) -> a + b), "
        "count(*) FROM h GROUP BY g ORDER BY g"),
    "map_union_sum": (
        "SELECT map_union_sum(m) FROM (SELECT g, map_agg(s, c) m FROM "
        "(SELECT g, s, count(*) c FROM h WHERE k < 60 GROUP BY g, s) a "
        "GROUP BY g) b"),
}


def _record(catalogs, pkg, mode, sql):
    if pkg == "port":
        s = presto_tpu_torch.connect(catalogs["port"], device="cpu",
                                     execution_mode=mode)
    else:
        s = presto_tpu.connect(catalogs["ref"], execution_mode=mode)
    return ZQ.record(s, sql, SORT_STATS_KEYS)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(QUERIES))
def test_aggregate_matches_presto_tpu(name, mode, catalogs):
    mine = _record(catalogs, "port", mode, QUERIES[name])
    theirs = _record(catalogs, "ref", mode, QUERIES[name])
    assert ZQ.mismatch(name, mine, theirs) == ""
    if mode == "dynamic":
        assert mine["error"] is None
    else:  # dynamic-mode only, as in the reference
        assert mine["memo"] == []
        if mode == "compiled":
            assert mine["error"][0] == "StaticFallback"


def test_single_percentile_stays_on_the_device(catalogs):
    """One constant percentile without a weight is the device kernel's
    (kernels.group_percentile), in a graph."""
    sql = "SELECT g, approx_percentile(x, 0.5) FROM h GROUP BY g ORDER BY g"
    mine = _record(catalogs, "port", "auto", sql)
    assert mine["mode"] == "compiled" and mine["memo"] == ["executable"]
    assert ZQ.mismatch("p", mine, _record(catalogs, "ref", "auto", sql)) \
        == ""


_PERSIST = [
    "CREATE TABLE memory.default.s AS SELECT o_orderpriority p, "
    "approx_set(o_custkey) h, tdigest_agg(o_totalprice) t FROM orders "
    "GROUP BY 1",
    "SELECT cardinality(merge(h)), value_at_quantile(merge(t), 0.5) "
    "FROM memory.default.s",
    "SELECT p, cardinality(h) FROM memory.default.s ORDER BY p"]


@pytest.mark.parametrize("mode", MODES)
def test_persisted_sketch_raises_as_in_presto_tpu(mode):
    """CREATE TABLE AS writes the five rows; reading a sketch back raises
    presto_tpu's ValueError (the blob reaches an integer parse)."""
    from presto_tpu.catalog import tpch_catalog as ref_tpch

    from presto_tpu_torch.catalog import tpch_catalog

    mine = presto_tpu_torch.connect(tpch_catalog(0.01), device="cpu",
                                    execution_mode=mode)
    theirs = presto_tpu.connect(ref_tpch(0.01), execution_mode=mode)
    for i, sql in enumerate(_PERSIST):
        a = ZQ.record(mine, sql, SORT_STATS_KEYS)
        b = ZQ.record(theirs, sql, SORT_STATS_KEYS)
        assert ZQ.mismatch(f"persist[{i}]", a, b) == ""
        if i == 0:
            assert a["rows"] == [[5]]
        else:
            assert a["error"][0] == "ValueError"
            assert "invalid literal for int()" in a["error"][1]


@pytest.mark.parametrize("mode", MODES)
def test_dst_gap_resolves_backwards_as_in_presto_tpu(mode):
    sql = ("SELECT CAST(TIMESTAMP '2020-03-08 02:30:00 America/New_York' "
           "AS VARCHAR)")
    a = ZQ.record(presto_tpu_torch.connect(Catalog(), device="cpu",
                                           execution_mode=mode), sql,
                  SORT_STATS_KEYS)
    b = ZQ.record(presto_tpu.connect(RefCatalog(), execution_mode=mode),
                  sql, SORT_STATS_KEYS)
    assert ZQ.mismatch("gap", a, b) == ""
    # Presto (joda) gives '2020-03-08 03:30:00.000 America/New_York'
    assert a["rows"] == [["2020-03-08 01:30:00.000 America/New_York"]]
