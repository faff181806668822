"""The volatile functions of presto_tpu_torch (random, rand, uuid,
shuffle, and TABLESAMPLE, which the planner lowers to random()) on the
CPU at SF0.01, in "dynamic", "auto" and "compiled": the properties of
E8 (presto_tpu_torch/function_ext_queries.py) and of
tests/test_functions_ext2.py's volatile cases.

- each group's TABLESAMPLE BERNOULLI (10) count lies within 6 sigma of
  the binomial mean over the table's rows;
- random() lies in [0, 1), random(10) in [0, 10) and is typed as its
  bound, the 25 uuids are distinct and well formed, shuffle gives a
  permutation;
- two runs of one text differ, in every mode: a volatile text keys the
  memo per execution, so every run builds anew;
- the execution mode, the seven counters, the memo entries and, outside
  "dynamic", the compile counters of a second run (one build, no memo
  hit) equal presto_tpu's: a first run of presto_tpu also counts the
  JAX helper programs it jits once a process, and "dynamic" counts only
  those, which the port has no counterpart for;
- 50 volatile texts leave the memo within its entry bound (GraphMemo
  evicts the least recently used);
- the build's draws replay in its capture (batch.volatile_draw).
"""

import math
import re

import numpy as np
import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu.catalog import tpch_catalog as ref_tpch_catalog
from presto_tpu_torch import batch as B
from presto_tpu_torch import function_ext_queries as FQ
from presto_tpu_torch.catalog import tpch_catalog
from presto_tpu_torch.exec import compile_cache as CC
from presto_tpu_torch.exec.executor import SORT_STATS_KEYS
from tests.torch_functions_common import static_pass_builds
from tests.torch_threads import torch_one_thread  # noqa: F401

MODES = ("dynamic", "auto", "compiled")
SF = 0.01
_UUID = re.compile(r"^[0-9a-f]{8}-[0-9a-f]{4}-4[0-9a-f]{3}-[89ab][0-9a-f]{3}"
                   r"-[0-9a-f]{12}$")


@pytest.fixture(scope="module")
def catalogs():
    return tpch_catalog(SF), ref_tpch_catalog(SF, None)


def _port(catalogs, mode):
    return presto_tpu_torch.connect(catalogs[0], device="cpu",
                                    execution_mode=mode)


def _within_6_sigma(count, n, p=0.1):
    return abs(count - n * p) <= 6 * math.sqrt(n * p * (1 - p))


@pytest.mark.parametrize("mode", MODES)
def test_tablesample_counts_lie_near_the_binomial_mean(mode, catalogs):
    s = _port(catalogs, mode)
    full = dict(s.sql("SELECT l_returnflag, count(*) FROM lineitem JOIN "
                      "orders ON l_orderkey = o_orderkey "
                      "GROUP BY l_returnflag").rows)
    a = s.sql(FQ.VOLATILE["E8a"]).rows
    b = s.sql(FQ.VOLATILE["E8a"]).rows
    assert [r[0] for r in a] == sorted(full)
    for flag, count in a + b:
        assert _within_6_sigma(count, full[flag]), (flag, count)
    assert a != b
    n = s.sql("SELECT count(*) FROM lineitem").rows[0][0]
    c1, c2 = (s.sql(FQ.VOLATILE["E8b"]).rows[0][0] for _ in range(2))
    assert _within_6_sigma(c1, n) and _within_6_sigma(c2, n) and c1 != c2


@pytest.mark.parametrize("mode", MODES)
def test_random_and_uuid_per_row(mode, catalogs):
    s = _port(catalogs, mode)
    a = s.sql(FQ.VOLATILE["E8c"]).rows
    b = s.sql(FQ.VOLATILE["E8c"]).rows
    for rows in (a, b):
        assert [r[0] for r in rows] == list(range(25))
        assert all(0.0 <= r[1] < 1.0 and isinstance(r[1], float)
                   for r in rows)
        assert all(0 <= r[2] < 10 and isinstance(r[2], int) for r in rows)
        assert len({r[1] for r in rows}) == 25
        uuids = [r[3] for r in rows]
        assert len(set(uuids)) == 25 and all(_UUID.match(u) for u in uuids)
    assert [r[1:] for r in a] != [r[1:] for r in b]
    assert not {r[3] for r in a} & {r[3] for r in b}


@pytest.mark.parametrize("mode", MODES)
def test_shuffle_is_a_fresh_permutation(mode, catalogs):
    s = _port(catalogs, mode)
    comments = dict(s.sql("SELECT r_regionkey, split(r_comment, ' ') "
                          "FROM region").rows)
    runs = [s.sql(FQ.VOLATILE["E8d"]).rows for _ in range(3)]
    for rows in runs:
        for key, perm, words in rows:
            assert sorted(perm) == list(range(1, 9))
            assert sorted(words) == sorted(comments[key])
    assert len({tuple(r[1] for r in rows) for rows in runs}) > 1


@pytest.mark.parametrize("sql", [
    "SELECT random() FROM (VALUES (1),(2),(3),(4)) AS t(x)",
    "SELECT random(10)", "SELECT rand()",
    "SELECT uuid() FROM (VALUES (1),(2),(3)) AS t(x)",
    "SELECT shuffle(ARRAY[1,2,3,4,5,6,7,8])"])
@pytest.mark.parametrize("mode", MODES)
def test_ext2_volatile_cases(sql, mode):
    """tests/test_functions_ext2.py's volatile cases, through the port."""
    from presto_tpu_torch.catalog import Catalog

    s = presto_tpu_torch.connect(Catalog(), device="cpu",
                                 execution_mode=mode)
    runs = [s.sql(sql).rows for _ in range(4)]
    vals = [r[0] for r in runs[0]]
    if "uuid" in sql:
        assert len(set(vals)) == len(vals) == 3
    elif "shuffle" in sql:
        assert sorted(vals[0]) == list(range(1, 9))
    elif "random(10)" in sql:
        assert all(0 <= v < 10 for rows in runs for v, in rows)
    else:
        assert all(0.0 <= v < 1.0 for rows in runs for v, in rows)
        assert len(set(vals)) == len(vals)
    assert len({repr(r) for r in runs}) > 1


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("qid", sorted(FQ.VOLATILE))
def test_modes_counters_and_memo_match_reference(qid, mode, catalogs):
    sql = FQ.VOLATILE[qid]
    got = {}
    for pkg, lib, cat, kw in (
            ("port", presto_tpu_torch, catalogs[0], {"device": "cpu"}),
            ("ref", presto_tpu, catalogs[1], {})):
        s = lib.connect(cat, execution_mode=mode, **kw)
        stats = [s.sql(sql).stats for _ in range(2)]
        got[pkg] = {
            "mode": [st.execution_mode for st in stats],
            "counters": [[int(getattr(st, k, 0)) for k in SORT_STATS_KEYS]
                         for st in stats],
            "compiles": [(st.compiles, st.compile_cache_hits)
                         for st in stats[1:]] if mode != "dynamic" else None,
            "memo": FQ.memo_state(s, sql)}
    assert got["port"] == got["ref"]


def test_memo_stays_bounded_under_volatile_texts(catalogs, monkeypatch):
    monkeypatch.setattr(CC, "MEMO_MAX_ENTRIES", 8)
    s = _port(catalogs, "auto")
    counts = [s.sql(FQ.VOLATILE["E8b"]).rows[0][0] for _ in range(50)]
    assert len(s._compiled_cache) == 8
    assert s._compiled_cache.evictions == 42
    assert len(set(counts)) > 1


def test_static_pass_reads_nothing_back(catalogs):
    for sql in (FQ.VOLATILE["E8a"], FQ.VOLATILE["E8b"]):
        result, built = static_pass_builds(sql, catalogs[0])
        assert result.stats.execution_mode == "compiled" and len(built) == 1


def test_draws_replay_in_the_capture():
    """Within one logged build, the capture takes the eager pass's draws
    in order; outside a build every draw is fresh."""
    log = B.UploadLog()
    rng = np.random.default_rng(1)
    with B.logged_uploads(log):
        first = [B.volatile_draw(lambda: rng.random(3)) for _ in range(2)]
    log.capturing = True
    with B.logged_uploads(log):
        again = [B.volatile_draw(lambda: rng.random(3)) for _ in range(2)]
    assert all(np.array_equal(a, b) for a, b in zip(first, again))
    assert not np.array_equal(B.volatile_draw(lambda: rng.random(3)),
                              first[0])
