"""Ordering-aware execution in presto_tpu_torch against presto_tpu's, on
the CPU.

- The ordering kernels on inputs made with numpy from a seed, against
  presto_tpu's and exact: `monotone_guard`, `group_ids_presorted` and
  `group_ids_presorted_static` (against the sorting path too, where the
  key is in order), `group_ids_static` replaying a memoized sort, and
  `build_probe(build_order=identity)` on a sorted build, which must give
  the sorting path's (order, lb, ub).
- Queries through both executors, whose rows and seven counters
  (sorts_taken, sorts_elided, sort_memo_hits, ordering_guard_trips and
  the three dynamic-filter counters) must equal presto_tpu's: a
  GROUP BY k ORDER BY k whose Sort is elided, a connector that
  misdeclares its order (the guard trips and the sort path runs, for a
  grouping and for a join build), two groupings of one key that share
  one sort, and the session switch that turns it all off.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto_tpu
import presto_tpu_torch
from presto_tpu import types as RT
from presto_tpu.catalog import Catalog as RCatalog
from presto_tpu.catalog import MemoryTable as RMemoryTable
from presto_tpu.exec import kernels as RK
from presto_tpu_torch import types as T
from presto_tpu_torch.catalog import Catalog, MemoryTable, tpch_catalog
from presto_tpu_torch.exec import kernels as K
from presto_tpu_torch.exec.executor import SORT_STATS_KEYS
from presto_tpu_torch.tpch_queries import QUERIES
from tests.test_torch_tpch import _assert_rows_match, counters
from tests.torch_threads import torch_one_thread  # noqa: F401

SENT = K.I64_MAX


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _both(fn_ref, fn, *arrays, **kw):
    return (fn_ref(*[jnp.asarray(a) for a in arrays], **kw),
            fn(*[_t(a) for a in arrays], **kw))


def _equal(mine, ref):
    if isinstance(mine, (tuple, list)):
        assert len(mine) == len(ref)
        for m, r in zip(mine, ref):
            _equal(m, r)
    elif isinstance(mine, torch.Tensor):
        np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
    else:
        assert mine == ref


def _key(case, n=3_000, seed=0):
    """An int64 packed key: `sorted` nondecreasing with dead rows
    (sentinels) in a suffix, `holes` the same with dead rows anywhere,
    `lying` a key out of order."""
    rng = np.random.default_rng(seed)
    key = np.sort(rng.integers(0, 200, n)).astype(np.int64)
    if case == "sorted":
        key[-n // 5:] = SENT
    elif case == "holes":
        key[rng.random(n) < 0.3] = SENT
    elif case == "lying":
        key = rng.integers(0, 200, n).astype(np.int64)
    elif case == "empty":
        key = key[:0]
    elif case == "short":
        key = key[:1]
    return key


@pytest.mark.parametrize("case", ["sorted", "holes", "lying", "empty",
                                  "short"])
def test_monotone_guard_matches_reference(case):
    ref, mine = _both(RK.monotone_guard, K.monotone_guard, _key(case))
    assert mine.dtype == torch.bool and mine.shape == ()
    assert bool(mine) == bool(ref) == (case in ("holes", "lying"))


@pytest.mark.parametrize("case", ["sorted", "holes", "lying", "empty"])
def test_group_ids_presorted_matches_reference(case):
    key = _key(case)
    sel = key != SENT
    ref, mine = _both(RK.group_ids_presorted, K.group_ids_presorted, key, sel)
    _equal(mine, ref)
    assert bool(mine[3]) == (case == "lying")
    if case != "lying":
        # the run scan numbers the groups as the sorting path does
        gid, rep, n = K.group_ids(_t(key), _t(sel))
        assert int(mine[2]) == n
        np.testing.assert_array_equal(mine[0].numpy(), gid.numpy())
        got = K.nonzero_i32(mine[1], max(n, 1), 0)[:n]
        np.testing.assert_array_equal(key[got.numpy()], key[rep.numpy()])


@pytest.mark.parametrize("cap", [1, 7, 64, 5_000])
@pytest.mark.parametrize("case", ["sorted", "holes", "lying", "empty"])
def test_group_ids_presorted_static_matches_reference(cap, case):
    key = _key(case, seed=cap)
    ref, mine = _both(RK.group_ids_presorted_static,
                      K.group_ids_presorted_static, key, cap=cap)
    _equal(mine, ref)
    assert bool(mine[4]) == (case == "lying")
    if case in ("sorted", "holes"):
        static = K.group_ids_static(_t(key), cap)
        for m, s in zip(mine[:4], static):
            np.testing.assert_array_equal(
                m.numpy(), s.numpy())  # the sorting path's numbering


def test_group_ids_static_replays_a_sorted_pair():
    key = _t(_key("lying"))
    pair = K.sort_pair(key)
    _equal(K.group_ids_static(key, 300, sorted_pair=pair),
           [x.numpy() for x in K.group_ids_static(key, 300)])


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
@pytest.mark.parametrize("case", ["sorted", "no_dead_rows", "empty_probe"])
def test_build_probe_with_identity_order_matches_sort(dtype, case):
    """A presorted build: the identity build order gives the (order,
    lb, ub) of presto_tpu's build_probe with the same order, and of the
    sorting path."""
    rng = np.random.default_rng(3)
    sent = K.I32_MAX if dtype == np.int32 else SENT
    build = np.sort(rng.integers(0, 300, 2_000)).astype(dtype)
    if case != "no_dead_rows":
        build[-300:] = sent
    probe = rng.integers(-5, 320, 0 if case == "empty_probe" else 5_000)
    probe = probe.astype(dtype)
    probe[rng.random(probe.shape[0]) < 0.1] = sent
    ident = np.arange(build.shape[0], dtype=np.int32)
    assert not bool(K.monotone_guard(_t(build)))
    ref = RK.build_probe(jnp.asarray(build), jnp.asarray(probe),
                         build_order=jnp.asarray(ident))
    mine = K.build_probe(_t(build), _t(probe), build_order=_t(ident))
    _equal(mine, ref)
    _equal(K.build_probe(_t(build), _t(probe)),
           [x.numpy() for x in mine])


# ---- through the executors --------------------------------------------------


def _run_both(ref_cat, port_cat, sql, mode, **props):
    ref = presto_tpu.connect(ref_cat, execution_mode=mode, **props)
    port = presto_tpu_torch.connect(port_cat, device="cpu",
                                    execution_mode=mode, **props)
    return port.sql(sql), ref.sql(sql), port, ref


def _memo(session):
    return ["DYNAMIC" if v == "DYNAMIC" else "executable"
            for v in getattr(session, "_compiled_cache", {}).values()]


@pytest.fixture(scope="module")
def port_tpch():
    return tpch_catalog(0.01)


@pytest.mark.parametrize("mode", ["dynamic", "auto"])
def test_group_then_order_by_elides_the_sort(mode, port_tpch,
                                             tpch_catalog_tiny):
    """A grouped output is sorted on its group keys, so GROUP BY k ORDER
    BY k sorts nothing more, in both packages."""
    sql = ("SELECT l_orderkey, count(*) c FROM lineitem "
           "GROUP BY l_orderkey ORDER BY l_orderkey")
    mine, ref, _, _ = _run_both(tpch_catalog_tiny, port_tpch, sql, mode)
    keys = [r[0] for r in mine.rows]
    assert keys == sorted(keys) and len(keys) > 1_000
    assert mine.rows == ref.rows
    assert counters(mine.stats) == counters(ref.stats)
    assert mine.stats.sorts_elided >= 1


def _tables(tables):
    ref, port = RCatalog(), Catalog()
    for name, schema, cols, order in tables:
        class RTable(RMemoryTable):
            def ordering(self, _o=order):
                return _o

        class PTable(MemoryTable):
            def ordering(self, _o=order):
                return _o

        ref.register(RTable(name, {c: RT.parse_type(t)
                                   for c, t in schema.items()}, cols))
        port.register(PTable(name, {c: T.parse_type(t)
                                    for c, t in schema.items()}, cols))
    return ref, port


def _liar(n, seed):
    """A table whose connector claims an order on k that it lacks."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 97, n)
    v = rng.integers(0, 1000, n)
    return ("liar", {"k": "BIGINT", "v": "BIGINT"}, {"k": k, "v": v},
            [("k", True)])


@pytest.mark.parametrize("mode", ["dynamic", "auto"])
def test_misdeclared_order_trips_the_guard_as_in_reference(mode):
    """The presorted grouping's guard trips (on the host in the dynamic
    executor; in compiled mode a static guard, which reruns the query
    dynamically and memoizes "DYNAMIC") and the sort path gives the
    right rows."""
    liar = _liar(5_000, 11)
    ref_cat, port_cat = _tables([liar])
    k, v = liar[2]["k"], liar[2]["v"]
    sql = "SELECT k, count(*) c, sum(v) sv FROM liar GROUP BY k ORDER BY k"
    cnt = collections.Counter(k.tolist())
    sv = collections.defaultdict(int)
    for ki, vi in zip(k.tolist(), v.tolist()):
        sv[ki] += vi
    want = [(ki, cnt[ki], sv[ki]) for ki in sorted(cnt)]
    mine, ref, port, rsess = _run_both(ref_cat, port_cat, sql, mode)
    assert mine.rows == ref.rows == want
    assert counters(mine.stats) == counters(ref.stats)
    if mode == "dynamic":
        assert mine.stats.ordering_guard_trips >= 1
    assert _memo(port) == _memo(rsess)
    again, ref_again = port.sql(sql), rsess.sql(sql)
    assert again.rows == want
    assert counters(again.stats) == counters(ref_again.stats)


def test_misdeclared_order_of_a_join_build_trips_the_guard():
    liar = _liar(900, 5)
    rng = np.random.default_rng(6)
    probe = ("probe", {"pk": "BIGINT", "w": "BIGINT"},
             {"pk": rng.integers(0, 97, 400), "w": np.arange(400)}, [])
    ref_cat, port_cat = _tables([liar, probe])
    sql = "SELECT count(*) c FROM probe, liar WHERE pk = k"
    mine, ref, _, _ = _run_both(ref_cat, port_cat, sql, "dynamic")
    cnt = collections.Counter(liar[2]["k"].tolist())
    want = sum(cnt.get(int(x), 0) for x in probe[2]["pk"])
    assert mine.rows == ref.rows == [(want,)]
    assert counters(mine.stats) == counters(ref.stats)


@pytest.mark.parametrize("mode", ["dynamic", "auto"])
def test_two_groupings_of_one_key_share_one_sort(mode):
    """Two groupings of the same scan column sort its packed key once,
    and the join of the grouped outputs (both sorted on k) elides its
    build sort."""
    rng = np.random.default_rng(2)
    n = 4_000
    table = ("t", {"k": "BIGINT", "v": "BIGINT"},
             {"k": rng.integers(0, 500, n), "v": rng.integers(0, 9, n)}, [])
    ref_cat, port_cat = _tables([table])
    sql = ("SELECT a.k, a.s, b.c FROM "
           "(SELECT k, sum(v) s FROM t GROUP BY k) a, "
           "(SELECT k, count(*) c FROM t GROUP BY k) b "
           "WHERE a.k = b.k ORDER BY a.k")
    mine, ref, _, _ = _run_both(ref_cat, port_cat, sql, mode)
    assert mine.rows == ref.rows
    assert len(mine.rows) == len(set(table[2]["k"].tolist()))
    assert counters(mine.stats) == counters(ref.stats)
    if mode == "dynamic":
        assert mine.stats.sort_memo_hits >= 1
        assert mine.stats.sorts_elided >= 1


@pytest.mark.parametrize("mode", ["dynamic", "auto"])
@pytest.mark.parametrize("qid", [3, 18])
def test_both_switches_off_match_reference(qid, mode, port_tpch,
                                           tpch_catalog_tiny):
    """With ordering_aware_execution and dynamic_filtering off, nothing
    is elided, memoized or pruned (sorts_taken still counts the sorts
    run, as presto_tpu's does), and the rows are the same."""
    off = {"ordering_aware_execution": False, "dynamic_filtering": False}
    mine, ref, _, _ = _run_both(tpch_catalog_tiny, port_tpch, QUERIES[qid],
                                mode, **off)
    on = presto_tpu_torch.connect(port_tpch, device="cpu",
                                  execution_mode=mode).sql(QUERIES[qid])
    got = counters(mine.stats)
    assert got == counters(ref.stats)
    assert {k: v for k, v in got.items() if k != "sorts_taken"} \
        == dict.fromkeys(SORT_STATS_KEYS[1:], 0)
    assert on.stats.sorts_elided > 0
    _assert_rows_match(mine.rows, on.rows, ordered=True)
    _assert_rows_match(mine.rows, ref.rows, ordered=True)
