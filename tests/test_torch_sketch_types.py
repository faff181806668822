"""presto_tpu_torch/functions/sketches.py and tdigest.py against
presto_tpu's on seeded inputs, byte for byte: HLLs of integers, floats
(-0.0, NaN), strings, bytes and booleans, their merges and
cardinalities; q-digests, their merges and readers; t-digests with and
without weights (zero weights among them), at several compressions,
their merges, scales, destructures and readers.  Then the SQL cases of
tests/test_functions_sketches.py and tests/test_tdigest.py through both
packages in "dynamic" and "auto": every statement's record equal (rows
with blobs byte for byte and floats within 1e-9, types, mode, the
seven counters and the memo entry).
"""

import numpy as np
import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu import types as RT
from presto_tpu.functions import sketches as RS
from presto_tpu.functions import tdigest as RTD
from presto_tpu_torch import types as T
from presto_tpu_torch import zone_sketch_queries as ZQ
from presto_tpu_torch.catalog import MemoryTable
from presto_tpu_torch.exec.executor import SORT_STATS_KEYS
from presto_tpu_torch.functions import sketches as PS
from presto_tpu_torch.functions import tdigest as PTD
from tests.torch_threads import torch_one_thread  # noqa: F401

MODES = ("dynamic", "auto")


def _hll_inputs():
    rng = np.random.default_rng(21)
    return {
        "ints": rng.integers(-10**12, 10**12, 3000).tolist(),
        "floats": rng.normal(size=2000).tolist() + [0.0, -0.0,
                                                    float("nan")],
        "strings": [f"s{v}" for v in rng.integers(0, 500, 1500)],
        "bytes": [bytes([int(v) % 256, 7]) for v in rng.integers(0, 900,
                                                                  800)],
        "bools": [True, False, True],
        "with_none": [1, None, 2, None],
        "empty": [],
    }


@pytest.mark.parametrize("name", sorted(_hll_inputs()))
def test_hll_bytes_equal(name):
    vals = _hll_inputs()[name]
    mine, theirs = PS.hll_from_values(vals), RS.hll_from_values(vals)
    assert mine == theirs
    assert PS.hll_cardinality(mine) == RS.hll_cardinality(theirs)
    half = len(vals) // 2
    parts = [PS.hll_from_values(vals[:half]),
             PS.hll_from_values(vals[half:]), None]
    assert PS.hll_merge(parts) == RS.hll_merge(parts)
    # the registers from the values' hashes, as the executor builds them
    assert PS.hll_from_hashes(PS.hash_all(
        [v for v in vals if v is not None])) == theirs
    # each distinct value once gives the same registers
    assert PS.hll_from_values(list(dict.fromkeys(
        v for v in vals if v == v or v is None))
        + [v for v in vals if v is not None and v != v]) == theirs


def test_hll_empty_and_errors():
    assert PS.hll_empty() == RS.hll_empty()
    assert PS.hll_merge([]) == RS.hll_merge([])
    for bad in (b"", b"PTQ1", b"PTH1\x00\x04\x01"):
        with pytest.raises(ValueError):
            PS.hll_cardinality(bad)


def _digest_inputs():
    rng = np.random.default_rng(5)
    n = 3000
    return {
        "normal": (rng.normal(50, 10, n), None),
        "few_values": (rng.integers(1, 51, n).astype(float), None),
        "lognormal_weighted": (rng.lognormal(size=n),
                               rng.integers(1, 9, n).astype(float)),
        "zero_weights": (rng.normal(size=n),
                         (rng.integers(0, 4, n) == 0).astype(float)),
        "fractional_weights": (np.round(rng.normal(size=n), 1),
                               rng.uniform(0.1, 3.0, n)),
        "nan_values": (np.where(rng.random(n) < 0.1, np.nan,
                                rng.normal(size=n)), None),
        "one": (np.asarray([3.5]), None),
        "empty": (np.empty(0), None),
    }


@pytest.mark.parametrize("compression", (100.0, 30.0))
@pytest.mark.parametrize("name", sorted(_digest_inputs()))
def test_tdigest_bytes_equal(name, compression):
    v, w = _digest_inputs()[name]
    mine = PTD.tdigest_from_values(v, w, compression)
    theirs = RTD.tdigest_from_values(
        list(v), None if w is None else list(w), compression)
    assert mine == theirs
    if len(v) == 0:
        return
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.999, 1.0):
        assert PTD.tdigest_value_at_quantile(mine, q) == \
            RTD.tdigest_value_at_quantile(theirs, q)
    for x in (float(np.nanmin(v)) - 1, 0.0, float(np.nanmedian(v)),
              float(np.nanmax(v)) + 1):
        assert PTD.tdigest_quantile_at_value(mine, x) == \
            RTD.tdigest_quantile_at_value(theirs, x)
    assert PTD.tdigest_scale(mine, 2.5) == RTD.tdigest_scale(theirs, 2.5)
    # repr: NaN means (zero weights) compare equal as text
    assert repr(PTD.tdigest_destructure(mine)) == \
        repr(RTD.tdigest_destructure(theirs))
    parts = [PTD.tdigest_from_values(c, None, compression)
             for c in np.array_split(v[~np.isnan(v)], 3)]
    assert PTD.tdigest_merge(parts + [b""]) == RTD.tdigest_merge(parts)


def test_tdigest_scale_refuses_a_nonpositive_factor():
    blob = PTD.tdigest_from_values(np.arange(10.0))
    with pytest.raises(ValueError):
        PTD.tdigest_scale(blob, 0.0)
    with pytest.raises(ValueError):
        PTD.tdigest_value_at_quantile(b"PTH1", 0.5)


@pytest.mark.parametrize("name", ("normal", "few_values", "one", "empty",
                                  "lognormal_weighted"))
def test_qdigest_bytes_equal(name):
    v = _digest_inputs()[name][0]
    mine, theirs = PS.qdigest_from_values(v), RS.qdigest_from_values(list(v))
    assert mine == theirs
    assert PS.qdigest_from_values(list(v) + [None]) == theirs
    for q in (0.0, 0.1, 0.5, 0.99, 1.0):
        assert PS.qdigest_value_at_quantile(mine, q) == \
            RS.qdigest_value_at_quantile(theirs, q)
    for x in (0.0, 1.0, 50.0):
        assert PS.qdigest_quantile_at_value(mine, x) == \
            RS.qdigest_quantile_at_value(theirs, x)
    parts = [PS.qdigest_from_values(c) for c in np.array_split(v, 4)]
    assert PS.qdigest_merge(parts + [None]) == RS.qdigest_merge(parts)
    assert PS.qd_parse(mine) == RS._qd_parse(theirs)


# ---------------------------------------------------------------------------
# the SQL cases of tests/test_functions_sketches.py and test_tdigest.py
# ---------------------------------------------------------------------------

_N = 20_000


def _t_columns():
    rng = np.random.RandomState(7)
    return {"g": np.arange(_N, dtype=np.int64) % 4,
            "x": rng.lognormal(0.0, 1.0, _N)}


@pytest.fixture(scope="module")
def catalogs():
    from presto_tpu.catalog import tpch_catalog as ref_tpch

    from presto_tpu_torch.catalog import tpch_catalog

    cols = _t_columns()
    mine = tpch_catalog(0.01)
    mine.register(MemoryTable("t", {"g": T.BIGINT, "x": T.DOUBLE},
                              {k: v.copy() for k, v in cols.items()}))
    theirs = ref_tpch(0.01)
    theirs.register_memory("t", {"g": RT.BIGINT, "x": RT.DOUBLE},
                           {k: v.copy() for k, v in cols.items()})
    return mine, theirs


SQL_CASES = {
    "hll_customer": [
        "SELECT cardinality(approx_set(c_custkey)), "
        "count(DISTINCT c_custkey) FROM customer",
        "SELECT cardinality(merge(h)) FROM (SELECT c_nationkey, "
        "approx_set(c_custkey) AS h FROM customer GROUP BY c_nationkey)",
        "SELECT cardinality(CAST(t AS HLL)) FROM (SELECT "
        "CAST(approx_set(c_custkey) AS VARCHAR) AS t FROM customer)",
        "SELECT cardinality(empty_approx_set())"],
    # the orders of the first 2,000 keys: the reference's q-digest
    # merges its 2,000 first centroids in Python
    "qdigest_orders": [
        "SELECT value_at_quantile(qdigest_agg(o_totalprice), 0.5), "
        "approx_percentile(o_totalprice, 0.5) FROM orders "
        "WHERE o_orderkey < 8000",
        "SELECT quantile_at_value(qdigest_agg(o_totalprice), 150000.0) "
        "FROM orders WHERE o_orderkey < 8000",
        "SELECT values_at_quantiles(qdigest_agg(o_totalprice), "
        "ARRAY[0.1, 0.9]) FROM orders WHERE o_orderkey < 8000",
        "SELECT value_at_quantile(merge(d), 0.5) FROM (SELECT "
        "o_orderpriority, qdigest_agg(o_totalprice) AS d FROM orders "
        "WHERE o_orderkey < 8000 GROUP BY o_orderpriority)"],
    "tdigest": [
        "SELECT value_at_quantile(tdigest_agg(x), 0.5), "
        "value_at_quantile(tdigest_agg(x), 0.99) FROM t",
        "SELECT g, values_at_quantiles(tdigest_agg(x), "
        "ARRAY[0.25, 0.5, 0.75]) FROM t GROUP BY g ORDER BY g",
        "SELECT value_at_quantile(merge(d), 0.5) FROM "
        "(SELECT tdigest_agg(x) d FROM t GROUP BY g)",
        "SELECT value_at_quantile(CAST(CAST(tdigest_agg(x) AS "
        "VARBINARY) AS TDIGEST(DOUBLE)), 0.5) FROM t",
        "SELECT value_at_quantile(tdigest_agg(x, CASE WHEN g = 0 THEN 1 "
        "ELSE 0 END), 0.5) FROM t",
        "SELECT value_at_quantile(d, 0.5), quantile_at_value(d, 1.0) "
        "FROM (SELECT tdigest_agg(x) d FROM t)",
        "SELECT value_at_quantile(scale_tdigest(tdigest_agg(x), 4.0), "
        "0.5) FROM t",
        "SELECT destructure_tdigest(tdigest_agg(x)) FROM t",
        "SELECT value_at_quantile(tdigest_agg(x, 1, 50), 0.5) FROM t"],
    "p4hll": [
        "SELECT cardinality(CAST(approx_set(g) AS P4HYPERLOGLOG)) FROM t",
        "SELECT cardinality(CAST(CAST(approx_set(x) AS VARBINARY) "
        "AS P4HYPERLOGLOG)) FROM t",
        "SELECT cardinality(merge(h)) FROM (SELECT CAST(approx_set(x) "
        "AS P4HYPERLOGLOG) h FROM t GROUP BY g)",
        "SELECT to_base64(CAST(approx_set(g) AS VARBINARY)) FROM t"],
    "empty_and_null": [
        "SELECT value_at_quantile(tdigest_agg(x), 0.5) FROM t "
        "WHERE x > 1e18",
        "SELECT value_at_quantile(tdigest_agg(y), 0.5) FROM "
        "(VALUES (1.0), (CAST(NULL AS DOUBLE)), (3.0)) v(y)",
        "SELECT approx_set(g), cardinality(approx_set(g)) FROM t "
        "WHERE g > 10"],
}


def _records(catalog, pkg, mode, stmts):
    if pkg == "port":
        s = presto_tpu_torch.connect(catalog, device="cpu",
                                     execution_mode=mode)
    else:
        s = presto_tpu.connect(catalog, execution_mode=mode)
    return [ZQ.record(s, q, SORT_STATS_KEYS) for q in stmts]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(SQL_CASES))
def test_sql_case_matches_presto_tpu(name, mode, catalogs):
    mine = _records(catalogs[0], "port", mode, SQL_CASES[name])
    theirs = _records(catalogs[1], "ref", mode, SQL_CASES[name])
    for i, (a, b) in enumerate(zip(mine, theirs)):
        assert ZQ.mismatch(f"{name}[{i}]", a, b) == ""
        assert a["error"] is None


def test_base64_export_reimports_across_queries(catalogs):
    s = presto_tpu_torch.connect(catalogs[0], device="cpu")
    blob = s.sql("SELECT to_base64(CAST(approx_set(g) AS VARBINARY)) "
                 "FROM t").rows[0][0]
    assert s.sql(f"SELECT cardinality(CAST(from_base64('{blob}') AS "
                 "P4HYPERLOGLOG))").rows == [(4,)]
    r = presto_tpu.connect(catalogs[1])
    assert r.sql("SELECT to_base64(CAST(approx_set(g) AS VARBINARY)) "
                 "FROM t").rows[0][0] == blob


def test_sketch_values_come_back_as_bytes(catalogs):
    s = presto_tpu_torch.connect(catalogs[0], device="cpu")
    (h, t), = s.sql("SELECT approx_set(g), tdigest_agg(x) FROM t").rows
    assert isinstance(h, bytes) and h[:4] == b"PTH1"
    assert isinstance(t, bytes) and t[:4] == b"PTD1"
    assert PTD.tdigest_from_values(_t_columns()["x"]) == t
