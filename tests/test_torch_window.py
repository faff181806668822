"""Window functions of presto_tpu_torch against presto_tpu and the sqlite
oracle, on the CPU at SF0.01.

- Every query of tests/test_window.py (WINDOW_QUERIES) in
  `execution_mode` "dynamic" and "auto": floats within rtol 1e-9 of
  presto_tpu's rows and everything else equal, the seven counters of
  ordering-aware execution and dynamic filtering and the compiled
  memo's entry equal to presto_tpu's, and the rows agreeing with sqlite
  under the reference's own comparison.
- The reference's IGNORE NULLS, RESPECT NULLS and rejection cases.
- The functions of exec/window.py against presto_tpu's on the same
  seeded numpy inputs: the partition, peer and frame bounds of
  `_FrameContext` (the port finds them without cummax/cummin, as the
  same integers), `_segmented_scan`, `_minmax_sliding`, `_ntile` and
  `_lag_lead`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto_tpu
import presto_tpu_torch
from presto_tpu import types as RT
from presto_tpu.batch import Batch as RBatch
from presto_tpu.batch import Column as RColumn
from presto_tpu.catalog import Catalog as RCatalog
from presto_tpu.exec import window as RW
from presto_tpu.plan import ir as rir
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.catalog import Catalog, tpch_catalog
from presto_tpu_torch.exec import window as W
from presto_tpu_torch.plan import ir
from presto_tpu_torch.plan.planner import SemanticError
from presto_tpu_torch.relational_queries import QUERIES as CORPUS
from tests.sqlite_oracle import assert_same_results, to_sqlite
from tests.test_torch_compiled import _memo_state
from tests.test_torch_tpch import _assert_rows_match, counters
from tests.test_window import NULLS_BASE, WINDOW_QUERIES

MODES = ("dynamic", "auto")


@pytest.fixture(scope="module")
def runs(tpch_catalog_tiny):
    """{(package, mode): run(name)}, each query run once on first use."""
    cat = tpch_catalog(0.01)
    sessions = {}
    for mode in MODES:
        sessions["port", mode] = presto_tpu_torch.connect(
            cat, device="cpu", execution_mode=mode)
        sessions["ref", mode] = presto_tpu.connect(tpch_catalog_tiny,
                                                   execution_mode=mode)
    cache = {}

    def run(package, mode, name):
        key = (package, mode, name)
        if key not in cache:
            s, sql = sessions[package, mode], WINDOW_QUERIES[name]
            cache[key] = (s.sql(sql), _memo_state(s, sql))
        return cache[key]

    return run


def test_corpus_holds_the_reference_window_tests_verbatim():
    for name, wid in (("running_sum", "W3"), ("rows_frame_minmax", "W4"),
                      ("lag_lead", "W5"), ("percent_cume", "W6")):
        assert CORPUS[wid] == WINDOW_QUERIES[name]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(WINDOW_QUERIES))
def test_window_query_matches_reference(name, mode, runs):
    mine, my_memo = runs("port", mode, name)
    ref, ref_memo = runs("ref", mode, name)
    _assert_rows_match(mine.rows, ref.rows, True)
    assert counters(mine.stats) == counters(ref.stats)
    assert mine.stats.execution_mode == ref.stats.execution_mode
    assert my_memo == ref_memo


@pytest.mark.parametrize("name", sorted(WINDOW_QUERIES))
def test_window_query_matches_oracle(name, runs, tpch_sqlite_tiny):
    expected = tpch_sqlite_tiny.execute(
        to_sqlite(WINDOW_QUERIES[name])).fetchall()
    for mode in MODES:
        assert_same_results(runs("port", mode, name)[0].rows, expected,
                            ordered=True)


# ---- IGNORE NULLS, RESPECT NULLS and the rejected forms ---------------------

NULLS_CASES = {
    "lag_ignore_nulls": (
        f"SELECT lag(v) IGNORE NULLS OVER (PARTITION BY g ORDER BY i) "
        f"FROM {NULLS_BASE} ORDER BY g, i",
        [None, 10, 10, 30, 30, None, None]),
    "lead_2_ignore_nulls": (
        f"SELECT lead(v, 2) IGNORE NULLS OVER (PARTITION BY g ORDER BY i) "
        f"FROM {NULLS_BASE} ORDER BY g, i",
        [50, 50, None, None, None, None, None]),
    "first_value_ignore_nulls": (
        f"SELECT first_value(v) IGNORE NULLS OVER "
        f"(PARTITION BY g ORDER BY i) FROM {NULLS_BASE} ORDER BY g, i",
        [10, 10, 10, 10, 10, None, 7]),
    "nth_value_ignore_nulls": (
        f"SELECT nth_value(v, 2) IGNORE NULLS OVER (PARTITION BY g "
        f"ORDER BY i ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED "
        f"FOLLOWING) FROM {NULLS_BASE} ORDER BY g, i",
        [30, 30, 30, 30, 30, None, None]),
    "lag_respect_nulls": (
        f"SELECT lag(v) RESPECT NULLS OVER (PARTITION BY g ORDER BY i) "
        f"FROM {NULLS_BASE} ORDER BY g, i",
        [None, 10, None, 30, None, None, None]),
    "lag_default": (
        f"SELECT lag(v) OVER (PARTITION BY g ORDER BY i) "
        f"FROM {NULLS_BASE} ORDER BY g, i",
        [None, 10, None, 30, None, None, None]),
    "last_value_ignore_nulls_sliding": (
        f"SELECT last_value(v) IGNORE NULLS OVER (PARTITION BY g ORDER BY i "
        f"ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING) FROM {NULLS_BASE} "
        f"ORDER BY g, i",
        [10, 30, 30, 50, 50, 7, 7]),
}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(NULLS_CASES))
def test_null_treatment_matches_reference(name, mode):
    sql, want = NULLS_CASES[name]
    mine = presto_tpu_torch.connect(Catalog(), device="cpu",
                                    execution_mode=mode).sql(sql)
    ref = presto_tpu.connect(RCatalog(), execution_mode=mode).sql(sql)
    assert [r[0] for r in mine.rows] == want
    assert mine.rows == ref.rows
    assert counters(mine.stats) == counters(ref.stats)


@pytest.mark.parametrize("sql,error,match", [
    ("SELECT count(DISTINCT o_orderpriority) OVER () FROM orders",
     SemanticError, None),
    ("SELECT count(*) FILTER (WHERE o_custkey > 5) OVER () FROM orders",
     SemanticError, None),
    ("SELECT abs(-1) IGNORE NULLS", Exception, "OVER"),
    (f"SELECT sum(v) IGNORE NULLS OVER () FROM {NULLS_BASE}", Exception,
     "value functions"),
])
def test_rejected_forms_raise_the_reference_error(sql, error, match,
                                                  tpch_catalog_tiny):
    with pytest.raises(Exception) as theirs:
        presto_tpu.connect(tpch_catalog_tiny).sql(sql)
    with pytest.raises(error, match=match) as mine:
        presto_tpu_torch.connect(tpch_catalog(0.01), device="cpu").sql(sql)
    assert type(mine.value).__name__ == type(theirs.value).__name__
    assert str(mine.value) == str(theirs.value)


# ---- the functions of exec/window.py against presto_tpu's -------------------

FRAMES = [None,
          ("ROWS", "UNBOUNDED PRECEDING", "CURRENT ROW"),
          ("ROWS", "CURRENT ROW", "UNBOUNDED FOLLOWING"),
          ("ROWS", "UNBOUNDED PRECEDING", "UNBOUNDED FOLLOWING"),
          ("ROWS", "CURRENT ROW", "CURRENT ROW"),
          ("RANGE", "CURRENT ROW", "CURRENT ROW"),
          ("RANGE", "UNBOUNDED PRECEDING", "CURRENT ROW"),
          ("ROWS", "3 PRECEDING", "2 FOLLOWING"),
          ("ROWS", "5 PRECEDING", "1 PRECEDING"),
          ("ROWS", "1 FOLLOWING", "4 FOLLOWING")]


def _rows(n, seed, null_share=0.2):
    """Seeded rows sorted as execute_window sorts them: live rows first,
    then by partition key p and order key o (NULLs of o last in each
    partition); v is a float column with NULLs."""
    rng = np.random.default_rng(seed)
    live = np.sort(rng.random(n) < 0.9)[::-1].copy()
    p = rng.integers(0, max(n // 9, 1), n)
    o = rng.integers(0, 6, n)
    ov = rng.random(n) >= 0.1
    order = np.lexsort((~ov, o * ov, p, ~live))
    v = rng.standard_normal(n) * 100
    vv = rng.random(n) >= null_share
    return {"live": live[order], "p": p[order], "o": (o * ov)[order],
            "ov": ov[order], "v": v, "vv": vv}


def _contexts(rows, frame, has_order=True):
    n = len(rows["p"])
    port_part = [Column(torch.from_numpy(rows["live"]), None, T.BOOLEAN),
                 Column(torch.from_numpy(rows["p"]), None, T.BIGINT)]
    ref_part = [RColumn(jnp.asarray(rows["live"]), None, RT.BOOLEAN),
                RColumn(jnp.asarray(rows["p"]), None, RT.BIGINT)]
    port_order = [Column(torch.from_numpy(rows["o"]),
                         torch.from_numpy(rows["ov"]), T.BIGINT)]
    ref_order = [RColumn(jnp.asarray(rows["o"]), jnp.asarray(rows["ov"]),
                         RT.BIGINT)]
    if not has_order:
        port_order, ref_order = [], []
    return (W._FrameContext(n, port_part, port_order, has_order, frame,
                            torch.device("cpu")),
            RW._FrameContext(n, ref_part, ref_order, has_order, frame))


def _same(port, ref):
    assert np.array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (257, 2), (4000, 3)])
@pytest.mark.parametrize("has_order", [True, False])
def test_frame_context_bounds_match_reference(n, seed, has_order):
    rows = _rows(n, seed)
    for frame in FRAMES:
        if frame is not None and frame[0] == "RANGE" and not has_order:
            continue
        mine, ref = _contexts(rows, frame, has_order)
        for attr in ("part_new", "peer_new", "part_start", "part_end",
                     "part_size", "peer_start", "peer_end", "rn"):
            _same(getattr(mine, attr), getattr(ref, attr))
        (fs, fe, shape), (rfs, rfe, rshape) = mine.frame_bounds(), \
            ref.frame_bounds()
        assert shape == rshape
        _same(fs, rfs)
        _same(fe, rfe)


def test_frame_bounds_take_no_running_max_or_min(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a cummax/cummin scan")

    monkeypatch.setattr(torch, "cummax", refuse)
    monkeypatch.setattr(torch, "cummin", refuse)
    mine, ref = _contexts(_rows(500, 9), None)
    _same(mine.peer_end, ref.peer_end)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("dtype", ["int64", "float64"])
@pytest.mark.parametrize("n,seed", [(1, 0), (100, 1), (3001, 2)])
def test_segmented_scan_matches_reference(op, dtype, n, seed):
    rng = np.random.default_rng(seed)
    vals = (rng.integers(-10**12, 10**12, n) if dtype == "int64"
            else rng.standard_normal(n))
    flags = rng.random(n) < 0.05
    flags[0] = True
    if dtype == "int64":
        ident = np.iinfo(np.int64).max if op == "min" \
            else np.iinfo(np.int64).min
    else:
        ident = np.inf if op == "min" else -np.inf
    mine = W._segmented_scan(torch.from_numpy(vals), torch.from_numpy(flags),
                             getattr(torch, f"{op}imum"), ident)
    ref = RW._segmented_scan(jnp.asarray(vals), jnp.asarray(flags),
                             getattr(jnp, f"{op}imum"), ident)
    _same(mine, ref)


@pytest.mark.parametrize("frame", [f for f in FRAMES
                                   if f and "PRECEDING" in f[1] + f[2]
                                   and "UNBOUNDED" not in f[1] + f[2]]
                         + [("ROWS", "1 FOLLOWING", "4 FOLLOWING")])
@pytest.mark.parametrize("op", ["min", "max"])
def test_minmax_sliding_matches_reference(frame, op):
    rows = _rows(2000, 4)
    mine, ref = _contexts(rows, frame)
    fs, fe, shape = mine.frame_bounds()
    rfs, rfe, _ = ref.frame_bounds()
    maxw = int(shape.split(":")[1])
    v = rows["v"]
    ident = np.inf if op == "min" else -np.inf
    got = W._minmax_sliding(torch.from_numpy(v), fs, fe,
                            getattr(torch, f"{op}imum"), ident, maxw)
    want = RW._minmax_sliding(jnp.asarray(v), rfs, rfe,
                              getattr(jnp, f"{op}imum"), ident, maxw)
    _same(got, want)


@pytest.mark.parametrize("k", [1, 2, 3, 7, 50])
def test_ntile_matches_reference(k):
    mine, ref = _contexts(_rows(3000, 5), None)
    _same(W._ntile(mine, k), RW._ntile(ref, k))


def _lag_lead_call(pkg_ir, types, fn, args, ignore_nulls):
    exprs = [pkg_ir.Ref("v", types.DOUBLE)]
    if args:
        exprs.append(pkg_ir.Lit(args[0], types.BIGINT))
    if len(args) > 1:
        exprs.append(pkg_ir.Lit(args[1], types.DOUBLE))
    return pkg_ir.AggCall(fn, tuple(exprs), types.DOUBLE,
                          ignore_nulls=ignore_nulls)


@pytest.mark.parametrize("fn", ["lag", "lead"])
@pytest.mark.parametrize("args", [(), (3,), (2, -1.5)])
@pytest.mark.parametrize("ignore_nulls", [False, True])
def test_lag_lead_matches_reference(fn, args, ignore_nulls):
    rows = _rows(1500, 6, null_share=0.4)
    mine_ctx, ref_ctx = _contexts(rows, None)
    b = Batch({"v": Column(torch.from_numpy(rows["v"]),
                           torch.from_numpy(rows["vv"]), T.DOUBLE)},
              torch.from_numpy(rows["live"]))
    rb = RBatch({"v": RColumn(jnp.asarray(rows["v"]),
                              jnp.asarray(rows["vv"]), RT.DOUBLE)},
                jnp.asarray(rows["live"]))
    got = W._lag_lead(mine_ctx, b, _lag_lead_call(ir, T, fn, args,
                                                  ignore_nulls))
    want = RW._lag_lead(ref_ctx, rb, _lag_lead_call(rir, RT, fn, args,
                                                    ignore_nulls))
    _same(got.valid, want.valid)
    _same(got.data, want.data)
