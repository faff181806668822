"""Compiled mode of presto_tpu_torch against presto_tpu's, on the CPU at
SF0.01.

- All 22 TPC-H queries through `connect(catalog, device="cpu")` in the
  default "auto" mode: the execution mode must be presto_tpu's
  ("compiled" for all 22), so must the memo's entry (an executable, not
  "DYNAMIC", for all 22), the seven counters of ordering-aware
  execution and dynamic filtering (on the first run and on a memo
  hit), and the rows presto_tpu's compiled rows (keys and counts equal,
  sums and averages within rtol 1e-9) and the sqlite oracle's (with
  the ORDERED set).
- The static kernels against presto_tpu's on seeded numpy inputs, exact
  for integers and bits.
- The static executor reads nothing back to the host before its packed
  fetch: each query's static pass runs with torch.Tensor.item,
  __bool__, __int__, __float__, __index__, tolist, numpy, cpu and
  torch.nonzero made to raise.  On the card torch's sync debug mode
  holds the same pass (compile_cache.build_graph), and catches what
  this patch cannot see (boolean-mask indexing, for one).
- The session memo: a second run builds nothing and replays the entry;
  distinct texts past its byte or entry bound evict the least recently
  used, and a tripped guard leaves "DYNAMIC" where presto_tpu's does.
- A violated static assumption, patched the same way into both
  packages: a group capacity too small trips a guard (both report
  "compiled", rerun in the dynamic executor and leave "DYNAMIC" in the
  memo, in "compiled" mode too); an unknown join fanout raises
  StaticFallback while building (both report "dynamic" in "auto" and
  memo nothing, and raise StaticFallback in "compiled").

On the CPU compile_cache.build_graph captures nothing: the executable
runs the static executor, the code a CUDA device captures.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import presto_tpu
import presto_tpu_torch
from presto_tpu import types as RT
from presto_tpu.batch import Batch as RBatch
from presto_tpu.batch import Column as RColumn
from presto_tpu.batch import Dictionary as RDictionary
from presto_tpu.exec import executor as RE
from presto_tpu.exec import kernels as RK
from presto_tpu.plan import stats as RS
from presto_tpu.plan.stats import ColStats as RColStats
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column, Dictionary
from presto_tpu_torch.catalog import tpch_catalog
from presto_tpu_torch.exec import compile_cache as CC
from presto_tpu_torch.exec import executor as E
from presto_tpu_torch.exec import kernels as K
from presto_tpu_torch.plan import stats as S
from presto_tpu_torch.plan.stats import ColStats
from presto_tpu_torch.tpch_queries import QUERIES
from tests.sqlite_oracle import assert_same_results, to_sqlite
from tests.test_torch_kernels import _cols, _t
from tests.test_torch_tpch import _assert_rows_match, counters
from tests.test_torch_tpch import oracle  # noqa: F401
from tests.test_tpch_correctness import ORDERED
from tests.torch_threads import torch_one_thread  # noqa: F401


@pytest.fixture(scope="module")
def port_cat():
    return tpch_catalog(0.01)


@pytest.fixture(scope="module")
def results(port_cat, tpch_catalog_tiny):
    """{qid: (port result, presto_tpu result)}, each query run once in
    "auto" in each package on first use."""
    port = presto_tpu_torch.connect(port_cat, device="cpu")
    ref = presto_tpu.connect(tpch_catalog_tiny)
    cache = {}

    def run(qid):
        if qid not in cache:
            sql = QUERIES[qid]
            mine, theirs = port.sql(sql), ref.sql(sql)
            cache[qid] = (mine, theirs, _memo_state(port, sql),
                          _memo_state(ref, sql))
        return cache[qid]

    run.sessions = (port, ref)
    return run


def _memo_state(session, sql):
    """The session memo's entries for `sql`: "DYNAMIC" or
    "executable"."""
    memo = getattr(session, "_compiled_cache", {})
    return ["DYNAMIC" if memo[k] == "DYNAMIC" else "executable"
            for k in memo if k[0] == sql]


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_query_matches_reference_in_compiled_mode(qid, results):
    mine, ref, my_memo, ref_memo = results(qid)
    assert mine.stats.execution_mode == ref.stats.execution_mode \
        == "compiled"
    # a tripped guard reports "compiled" too: the memo tells them apart
    assert my_memo == ref_memo == ["executable"]
    _assert_rows_match(mine.rows, ref.rows, qid in ORDERED)


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_compiled_counters_match_reference(qid, results):
    mine, ref, _, _ = results(qid)
    assert counters(mine.stats) == counters(ref.stats)


@pytest.mark.parametrize("qid", [3, 17, 18])
def test_memo_hit_counters_match_reference(qid, results):
    """A memo hit reports the counters of the build, in both packages:
    the decisions are the executable's (Q3 elides sorts, Q17 and Q18
    filter lineitem, Q18 replays a memoized sort)."""
    first, ref_first, _, _ = results(qid)
    port, ref = results.sessions
    again, ref_again = port.sql(QUERIES[qid]), ref.sql(QUERIES[qid])
    assert again.stats.compile_cache_hits == 1
    assert counters(again.stats) == counters(ref_again.stats) \
        == counters(first.stats)
    assert again.rows == first.rows


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_compiled_query_matches_oracle(qid, results, oracle):  # noqa: F811
    expected = oracle.execute(to_sqlite(QUERIES[qid])).fetchall()
    assert_same_results(results(qid)[0].rows, expected,
                        ordered=qid in ORDERED)


# ---- the static kernels against presto_tpu's --------------------------------


def _stats(lo, hi):
    return (RColStats(min=lo, max=hi), ColStats(min=lo, max=hi))


def _string_cols(rng, n):
    values = np.array(sorted({"a", "bb", "c", "dd", "e"}), dtype=object)
    codes = rng.integers(0, len(values), n).astype(np.int32)
    return (RColumn(jnp.asarray(codes), None, RT.VARCHAR,
                    RDictionary(values)),
            Column(_t(codes), None, T.VARCHAR, Dictionary(values)))


@pytest.mark.parametrize("case", ["ints", "string_and_int", "unknown_range",
                                  "too_wide", "bool_and_nulls"])
def test_static_layout_and_range_guard_match_reference(case):
    rng = np.random.default_rng(["ints", "string_and_int", "unknown_range",
                                 "too_wide", "bool_and_nulls"].index(case))
    n = 2_000
    a = rng.integers(-50, 900, n)
    valid = rng.random(n) < 0.8
    rcols, cols = _cols([(a, None), (rng.integers(0, 30, n).astype(np.int32),
                                     valid)])
    stats = [_stats(-50, 899), _stats(0, 29)]
    if case == "string_and_int":
        rs, ps = _string_cols(rng, n)
        rcols, cols = [rs, rcols[0]], [ps, cols[0]]
        stats = [(None, None), stats[0]]
    elif case == "unknown_range":
        stats[1] = (None, None)
    elif case == "too_wide":
        stats = [_stats(-2**40, 2**40)] * 2
        rcols, cols = rcols + rcols, cols + cols
        stats = stats * 2
    elif case == "bool_and_nulls":
        b = rng.random(n) < 0.5
        rcols.append(RColumn(jnp.asarray(b), jnp.asarray(valid), RT.BOOLEAN))
        cols.append(Column(_t(b), _t(valid), T.BOOLEAN))
        stats.append((None, None))
    ref = RK.static_layout(rcols, [s[0] for s in stats])
    mine = K.static_layout(cols, [s[1] for s in stats])
    assert mine == ref
    assert (mine is None) == (case in ("unknown_range", "too_wide"))
    if mine is None:
        return
    sel = rng.random(n) < 0.9
    for shift in (0, 1):  # in range; then one live value past the range
        if shift:
            a2 = a.copy()
            a2[np.flatnonzero(sel)[0]] = 2_000
            col0 = _cols([(a2, None)])
            i = 1 if case == "string_and_int" else 0
            rcols[i], cols[i] = col0[0][0], col0[1][0]
        rg = RK.layout_range_guard(rcols, jnp.asarray(sel), ref)
        g = K.layout_range_guard(cols, _t(sel), mine)
        assert bool(g) == bool(rg) == bool(shift)
        rkey = RK.pack_with_layout(rcols, jnp.asarray(sel), ref)
        key = K.pack_with_layout(cols, _t(sel), mine)
        np.testing.assert_array_equal(key.numpy(), np.asarray(rkey))


@pytest.mark.parametrize("cap", [1, 7, 64, 5_000])
def test_group_ids_static_matches_reference(cap):
    rng = np.random.default_rng(cap)
    n = 3_000
    key = rng.integers(0, 40, n).astype(np.int64)
    sel = rng.random(n) < 0.7
    key = np.where(sel, key, K.I64_MAX)
    ref = RK.group_ids_static(jnp.asarray(key), cap)
    mine = K.group_ids_static(_t(key), cap)
    for r, m in zip(ref, mine):
        np.testing.assert_array_equal(m.numpy(), np.asarray(r))
    assert bool(mine[3]) == (cap < 40)


def test_group_ids_static_on_an_empty_key():
    ref = RK.group_ids_static(jnp.zeros((0,), jnp.int64), 4)
    mine = K.group_ids_static(torch.zeros((0,), dtype=torch.int64), 4)
    for r, m in zip(ref, mine):
        np.testing.assert_array_equal(m.numpy(), np.asarray(r))


@pytest.mark.parametrize("n,size,fill,density", [
    (10_000, 100, 0, 0.3),      # the reference's top_k branch
    (10_000, 9_000, 5, 0.3),    # its sort branch, fewer set than size
    (1_000, 50, 3, 0.0),        # nothing set
    (0, 4, 0, 0.5),             # empty mask
    (64, 64, 0, 1.0)])          # every row set
def test_sync_free_nonzero_i32_matches_reference(n, size, fill, density):
    rng = np.random.default_rng(n + size)
    mask = rng.random(n) < density
    ref = RK.nonzero_i32(jnp.asarray(mask), size, fill)
    mine = K.nonzero_i32(_t(mask), size, fill)
    assert mine.dtype == torch.int32
    np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))


def _batch(rng, n):
    """The same batch in both packages: BIGINT with NULLs, INTEGER,
    DOUBLE, BOOLEAN and VARCHAR columns under a random sel."""
    i64 = rng.integers(-2**62, 2**62, n)
    i32 = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    f64 = rng.standard_normal(n)
    b = rng.random(n) < 0.5
    valid = rng.random(n) < 0.8
    sel = rng.random(n) < 0.6
    rs, ps = _string_cols(rng, n)
    rcols = {"i64": RColumn(jnp.asarray(i64), jnp.asarray(valid), RT.BIGINT),
             "i32": RColumn(jnp.asarray(i32), None, RT.INTEGER),
             "f64": RColumn(jnp.asarray(f64), None, RT.DOUBLE),
             "b": RColumn(jnp.asarray(b), None, RT.BOOLEAN), "s": rs}
    cols = {"i64": Column(_t(i64), _t(valid), T.BIGINT),
            "i32": Column(_t(i32), None, T.INTEGER),
            "f64": Column(_t(f64), None, T.DOUBLE),
            "b": Column(_t(b), None, T.BOOLEAN), "s": ps}
    return RBatch(rcols, jnp.asarray(sel)), Batch(cols, _t(sel))


@pytest.mark.parametrize("guard", [False, True])
def test_pack_fetch_then_unpack_matches_reference(guard):
    rbatch, batch = _batch(np.random.default_rng(12 + guard), 3_000)
    (rbuf, rside), rmeta = RK.pack_fetch(rbatch, jnp.asarray(guard))
    (buf, side), meta = K.pack_fetch(batch, torch.tensor(guard))
    # the reference's uint32 words, bit for bit; f64 columns beside them
    np.testing.assert_array_equal(buf.numpy().view(np.uint32),
                                  np.asarray(rbuf))
    assert len(side) == len(rside) == 1
    np.testing.assert_array_equal(side[0].numpy(), np.asarray(rside[0]))
    assert [c[:4] for c in meta["cols"]] == [c[:4] for c in rmeta["cols"]]
    # one flat copy to the host, split again
    flat = K.flat_fetch(buf, side).numpy()
    rdatas, rsel, rguard = RK.unpack_fetch(
        (np.asarray(rbuf), [np.asarray(a) for a in rside]), rmeta)
    datas, sel, g = K.unpack_fetch(K.split_flat_fetch(flat, meta), meta)
    assert g == rguard == guard
    np.testing.assert_array_equal(sel, rsel)
    for name, (rd, rv) in rdatas.items():
        d, v = datas[name]
        assert d.dtype == rd.dtype
        np.testing.assert_array_equal(d, rd)
        np.testing.assert_array_equal(v, rv)


# ---- no host read in the static pass ---------------------------------------


class HostRead(Exception):
    pass


_READS = ("item", "__bool__", "__int__", "__float__", "__index__", "tolist",
          "numpy", "cpu", "nonzero")


@contextlib.contextmanager
def no_host_reads():
    """Every way this package reads a tensor back to the host raises
    HostRead while the block runs."""
    def refuse(name):
        def read(*args, **kwargs):
            raise HostRead(name)
        return read

    saved = {name: getattr(torch.Tensor, name) for name in _READS}
    saved_nonzero = torch.nonzero
    try:
        for name in _READS:
            setattr(torch.Tensor, name, refuse(name))
        torch.nonzero = refuse("torch.nonzero")
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)
        torch.nonzero = saved_nonzero


@pytest.mark.parametrize("read", [
    lambda m: torch.nonzero(m), lambda m: m.nonzero(),
    lambda m: bool(m.any()), lambda m: int(m.sum()),
    lambda m: float(m.sum()), lambda m: [0, 1, 2][m.sum()],
    lambda m: m.sum().item(), lambda m: m.tolist(), lambda m: m.cpu()])
def test_the_patch_catches_a_host_read(read):
    mask = torch.tensor([True, False, True])
    with pytest.raises(HostRead), no_host_reads():
        read(mask)
    assert torch.nonzero(mask).flatten().tolist() == [0, 2]  # restored


@pytest.fixture(scope="module")
def static_passes(port_cat):
    """{qid: packed buffer}: each query's static pass, run under
    no_host_reads up to its packed fetch (build_graph wraps the static
    executor's program), in a session of its own."""
    real = CC.build_graph
    built = {}

    def build(fn, example, device=None):
        def program(*args):
            with no_host_reads():
                out = fn(*args)
            built["out"] = out
            return out

        return real(program, example, device)

    def run(qid):
        CC.build_graph = build
        try:
            session = presto_tpu_torch.connect(port_cat, device="cpu")
            session.sql(QUERIES[qid])
        finally:
            CC.build_graph = real
        return built.pop("out")

    return run


@pytest.mark.parametrize("qid", sorted(QUERIES))
def test_static_pass_reads_nothing_back(qid, static_passes):
    flat, guard = static_passes(qid)
    assert flat.dtype == torch.int32 and flat.ndim == 1
    assert not bool(guard)


# ---- the session memo -------------------------------------------------------


def test_second_run_replays_the_memo_entry(port_cat):
    session = presto_tpu_torch.connect(port_cat, device="cpu")
    sql = QUERIES[6]
    first = session.sql(sql)
    keys = [k for k in session._compiled_cache if k[0] == sql]
    assert len(keys) == 1
    exe = session._compiled_cache[keys[0]][1]
    assert isinstance(exe, CC.Executable)
    assert (first.stats.compiles, first.stats.compile_cache_hits) == (1, 0)
    second = session.sql(sql)
    assert session._compiled_cache[keys[0]][1] is exe
    assert (second.stats.compiles, second.stats.compile_ms,
            second.stats.compile_cache_hits) == (0, 0.0, 1)
    assert second.rows == first.rows


def test_execution_mode_dynamic_skips_compiled_mode(port_cat):
    session = presto_tpu_torch.connect(port_cat, device="cpu",
                                       execution_mode="dynamic")
    r = session.sql(QUERIES[6])
    assert r.stats.execution_mode == "dynamic" and r.stats.compiles == 0
    assert not getattr(session, "_compiled_cache", {})


def _q6(year, discount, quantity):
    """TPC-H Q6 with the parameters qgen draws for a stream."""
    return ("SELECT sum(l_extendedprice * l_discount) AS revenue "
            f"FROM lineitem WHERE l_shipdate >= DATE '{year}-01-01' "
            f"AND l_shipdate < DATE '{year + 1}-01-01' "
            f"AND l_discount BETWEEN {discount - 0.01:.2f} "
            f"AND {discount + 0.01:.2f} AND l_quantity < {quantity}")


@pytest.mark.parametrize("bound", ["bytes", "entries"])
def test_memo_evicts_the_least_recently_used_text(
        bound, port_cat, oracle, monkeypatch):  # noqa: F811
    """Distinct texts, as qgen's streams send them: the memo stays
    within its bound, keeps the most recently used texts, releases what
    it evicts, and an evicted text builds again with the same rows."""
    # each Q6 entry holds one selection over lineitem, a byte a row
    rows = port_cat.get("lineitem").row_count()
    props = {}
    if bound == "bytes":
        props["compiled_cache_max_bytes"] = 3 * rows + rows // 2
    else:
        monkeypatch.setattr(CC, "MEMO_MAX_ENTRIES", 3)
    session = presto_tpu_torch.connect(port_cat, device="cpu", **props)
    texts = [_q6(1993 + i % 5, 0.02 + i / 100, 24 + i % 2)
             for i in range(8)]

    def run(sql):
        r = session.sql(sql)
        memo = session._compiled_cache
        assert len(memo) <= 3 and memo.nbytes <= CC.memo_bound(session)
        assert_same_results(r.rows, oracle.execute(to_sqlite(sql)).fetchall(),
                            ordered=False)
        return r

    for sql in texts[:3]:
        assert run(sql).stats.compiles == 1
    first = session._compiled_cache[next(iter(session._compiled_cache))][1]
    assert run(texts[0]).stats.compile_cache_hits == 1  # now the newest
    run(texts[3])  # evicts texts[1], the least recently used
    assert [k[0] for k in session._compiled_cache] == [texts[2], texts[0],
                                                       texts[3]]
    for sql in texts[4:]:
        run(sql)
    memo = session._compiled_cache
    assert [k[0] for k in memo] == texts[5:] and memo.evictions == 5
    assert first.fn is None and first.example == ()  # released
    again = run(texts[0])
    assert (again.stats.compiles, again.stats.compile_cache_hits) == (1, 0)


class _Held:
    """An executable's stand-in that records its release."""

    pool_bytes = 0

    def __init__(self):
        self.released = False

    def release(self):
        self.released = True


@pytest.mark.parametrize("case", ["newest_over_the_bound_stays",
                                  "dynamic_marker_replaces_an_entry"])
def test_graph_memo_bounds(case):
    memo = CC.GraphMemo(max_bytes=100, max_entries=4)
    a, b = _Held(), _Held()
    memo.put("a", ("entry", a), 60, a)
    if case == "newest_over_the_bound_stays":
        memo.put("b", ("entry", b), 150, b)
        assert list(memo) == ["b"] and memo.nbytes == 150
        assert a.released and not b.released and memo.evictions == 1
    else:
        memo.put("a", ("entry", a), 60, a)  # a rerun stores it again
        assert not a.released
        memo.put("a", "DYNAMIC")
        assert a.released and memo.get("a") == "DYNAMIC"
        assert memo.nbytes == 0 and memo.evictions == 0


# ---- a violated static assumption, the same in both packages ----------------

GUARD_CASES = {
    # every grouping gets capacity 1: the overflow guard trips
    "group_capacity": (
        "SELECT o_orderkey, count(*) FROM orders GROUP BY o_orderkey "
        "ORDER BY 2 DESC, 1 LIMIT 3",
        {"capacity_for_groups": lambda node, src: 1}),
    # no fanout bound for a one-to-many build: StaticFallback
    "join_fanout": (
        "SELECT c_name, o_orderkey FROM customer LEFT JOIN orders "
        "ON c_custkey = o_custkey ORDER BY 1, 2 LIMIT 5",
        {"_best_fanout_key": lambda rs, keys: None,
         "speculative_fanout_bound": lambda rs, criteria: None}),
}


def _outcome(lib, catalog, sql, mode, fallback, **kw):
    session = lib.connect(catalog, execution_mode=mode, **kw)
    try:
        r = session.sql(sql)
    except fallback:
        return "StaticFallback", None, None
    memo = ["DYNAMIC" if v == "DYNAMIC" else "executable"
            for v in session._compiled_cache.values()]
    return r.stats.execution_mode, memo, r.rows


@pytest.mark.parametrize("case", sorted(GUARD_CASES))
def test_violated_static_assumption_matches_reference(
        case, monkeypatch, port_cat, tpch_catalog_tiny, tpch_sqlite_tiny):
    sql, patches = GUARD_CASES[case]
    for name, fn in patches.items():
        monkeypatch.setattr(RS, name, fn)
        monkeypatch.setattr(S, name, fn)
    expected = tpch_sqlite_tiny.execute(to_sqlite(sql)).fetchall()
    want = {"group_capacity": {"auto": ("compiled", ["DYNAMIC"]),
                               "compiled": ("compiled", ["DYNAMIC"])},
            "join_fanout": {"auto": ("dynamic", []),
                            "compiled": ("StaticFallback", None)}}[case]
    for mode in ("auto", "compiled"):
        ref = _outcome(presto_tpu, tpch_catalog_tiny, sql, mode,
                       RE.StaticFallback)
        mine = _outcome(presto_tpu_torch, port_cat, sql, mode,
                        E.StaticFallback, device="cpu")
        assert mine[:2] == ref[:2] == want[mode]
        if mine[2] is not None:
            assert mine[2] == ref[2]
            assert_same_results(mine[2], expected, ordered=True)


def sf_states(sf, qids, cache_dir=None):
    """{qid: {"memo": [presto_tpu's memo entry, the port's], "counters":
    [presto_tpu's, the port's]}} for each TPC-H query run on the CPU at
    scale factor `sf`, once in "auto" and once in "dynamic" in each
    package: where its guards trip ("DYNAMIC"), and its seven counters
    ({"compiled": [...], "dynamic": [...]}, in SORT_STATS_KEYS order;
    "compiled" is the "auto" run's, a tripped guard's dynamic rerun
    included)."""
    from presto_tpu.catalog import tpch_catalog as ref_catalog

    out = {qid: {"memo": [], "counters": []} for qid in qids}
    for lib, cat, kw in ((presto_tpu, ref_catalog(sf, cache_dir), {}),
                         (presto_tpu_torch, tpch_catalog(sf, cache_dir),
                          {"device": "cpu"})):
        auto = lib.connect(cat, **kw)
        dynamic = lib.connect(cat, execution_mode="dynamic", **kw)
        for qid in qids:
            got = {}
            for mode, session in (("compiled", auto), ("dynamic", dynamic)):
                stats = session.sql(QUERIES[qid]).stats
                got[mode] = [getattr(stats, k) for k in E.SORT_STATS_KEYS]
            out[qid]["memo"].append(_memo_state(auto, QUERIES[qid]))
            out[qid]["counters"].append(got)
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python -m tests.test_torch_compiled SF Q[,Q...]
    # [CACHE_DIR]: one JSON line of both packages' memo entries and
    # counters.  At SF1 presto_tpu's Q9 peaks near 14 GB of host memory:
    # run a few queries a process.
    import json
    import sys

    qids = [int(q) for q in sys.argv[2].split(",")]
    states = sf_states(float(sys.argv[1]), qids,
                       sys.argv[3] if len(sys.argv) > 3 else None)
    print(json.dumps({
        "sf": float(sys.argv[1]), "counters": list(E.SORT_STATS_KEYS),
        **{pkg: {f"Q{q}": {"memo": r["memo"][i],
                           "counters": r["counters"][i]}
                 for q, r in states.items()}
           for i, pkg in enumerate(("presto_tpu", "presto_tpu_torch"))}}))
