"""The statement corpus (presto_tpu_torch/statement_queries.py: CREATE
TABLE AS, INSERT, DELETE, transactions, EXPLAIN, the SHOW family, SET
SESSION, DROP TABLE) through presto_tpu_torch on the CPU at SF0.01, in
execution_mode "dynamic" and "auto", against presto_tpu running the same
script on a fresh session of its own.  Each package runs the script once
a mode; every case reads those runs.  The port is held to:
- each statement's rows, in order: floats at rtol 1e-9 (presto_tpu's
  TPC-H connector computes l_extendedprice and o_totalprice on its
  device, one ulp away from the host values both packages write), all
  else exactly; EXPLAIN text exactly, EXPLAIN ANALYZE without its times,
  SHOW TABLES without presto_tpu's system tables, SHOW STATS but for the
  distinct count of those two columns;
- execution_mode, rows_written, bytes_written and write_files of every
  statement, and the seven counters of each query (SORT_STATS_KEYS);
- each written table after each write: its arrays in order (floats at
  rtol 1e-9), the pages the write appended (bucket, rows, sort-key
  sequence, rows as a multiset), write_properties() and ordering();
- D2 and D3 again under "compiled" (the writer's compiled source path).

`JAX_PLATFORMS=cpu python -m tests.test_torch_statements SF [CACHE_DIR]`
prints presto_tpu's values at scale factor SF as one JSON line, each
fact once (statement_queries.compact_reference; chip_smoke.py's
WRITE_REFERENCE_SF1 came from it at SF 1).
"""

import json
import sys

import numpy as np
import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu.connectors import AppendPageSink as RefSink
from presto_tpu_torch import statement_queries as SQ
from presto_tpu_torch.catalog import Catalog, tpch_catalog
from presto_tpu_torch.connectors import AppendPageSink as PortSink
from presto_tpu_torch.exec.executor import SORT_STATS_KEYS
from tests.torch_threads import torch_one_thread  # noqa: F401

RTOL = 1e-9
MODES = ("dynamic", "auto")
WRITE_STATS = ("execution_mode", "rows_written", "bytes_written",
               "write_files")
WRITES = [sid for sid, _s, t in SQ.SCRIPT if t is not None]


def _fresh(catalog_cls, tables):
    """A catalog of its own over shared generator tables: the script's
    writes register their tables there alone."""
    cat = catalog_cls()
    for t in tables:
        cat.register(t)
    return cat


def _run(connect, catalog_cls, tables, sink, mode, ids=None):
    session = connect(_fresh(catalog_cls, tables), mode)
    return SQ.run_script(session, sink, ids, keep_data=True)


@pytest.fixture(scope="module")
def runs(tpch_catalog_tiny):
    """{(package, mode): {id: (QueryResult, digest)}}, each run once on
    first use."""
    from presto_tpu.catalog import Catalog as RefCatalog

    port_tables = list(tpch_catalog(0.01).tables.values())
    ref_tables = [t for n, t in tpch_catalog_tiny.tables.items()
                  if "." not in n]
    cache = {}

    def get(pkg, mode, ids=None):
        key = (pkg, mode)
        if key not in cache:
            if pkg == "port":
                cache[key] = _run(
                    lambda c, m: presto_tpu_torch.connect(
                        c, device="cpu", execution_mode=m),
                    Catalog, port_tables, PortSink, mode, ids)
            else:
                cache[key] = _run(
                    lambda c, m: presto_tpu.connect(c, execution_mode=m),
                    RefCatalog, ref_tables, RefSink, mode, ids)
        return cache[key]

    return get


def _counters(stats):
    return [getattr(stats, k) for k in SORT_STATS_KEYS]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sid", [s for s, _q, _t in SQ.SCRIPT])
def test_statement_matches_reference(sid, mode, runs):
    mine = runs("port", mode)[sid][0]
    theirs = runs("ref", mode)[sid][0]
    assert [n for n, _t in mine.columns] == [n for n, _t in theirs.columns]
    assert [str(t) for _n, t in mine.columns] \
        == [str(t) for _n, t in theirs.columns]
    assert not SQ.rows_mismatch(
        sid, SQ.comparable(sid, mine.rows),
        SQ.comparable(sid, theirs.rows, reference=True), RTOL)
    for k in WRITE_STATS:
        assert getattr(mine.stats, k) == getattr(theirs.stats, k), k
    if sid in SQ.QUERY_IDS:
        assert _counters(mine.stats) == _counters(theirs.stats)


def _assert_tables_equal(mine, theirs):
    assert not SQ.digest_mismatch(
        {k: v for k, v in mine.items() if k != "data"},
        {k: v for k, v in theirs.items() if k != "data"}, RTOL)
    a, b = mine["data"], theirs["data"]
    assert list(a) == list(b)
    for c in b:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        assert x.dtype.kind == y.dtype.kind or {x.dtype.kind, y.dtype.kind} \
            <= {"U", "O"}, c
        if y.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=RTOL, atol=0)
        else:
            assert x.tolist() == y.tolist(), c


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sid", WRITES)
def test_written_table_matches_reference(sid, mode, runs):
    _assert_tables_equal(runs("port", mode)[sid][1],
                         runs("ref", mode)[sid][1])


def test_rollback_restores_the_table(runs):
    port = runs("port", "dynamic")
    rolled, before = port["D6c"][1], port["D2"][1]
    assert rolled["rows"] == before["rows"]
    assert rolled["sums"] == before["sums"]
    assert rolled["order"] == before["order"]


def test_replay_after_a_write_sees_the_write(runs):
    """In "auto" D5's text builds a new graph after each write (the memo
    key carries the catalog version), and reads the rows as they stand:
    the rolled-back insert leaves D5's rows as they were, the committed
    one doubles every count."""
    port = runs("port", "auto")
    d5, after_rollback, after_commit = (port[s][0] for s in
                                        ("D5", "D6d", "D6h"))
    assert after_rollback.rows == d5.rows
    assert [r[1] for r in after_commit.rows] == [2 * r[1] for r in d5.rows]
    for r in (d5, after_rollback, after_commit):
        assert r.stats.execution_mode == "compiled"
        assert r.stats.compile_cache_hits == 0


@pytest.mark.parametrize("sid", SQ.COMPILED_IDS)
def test_compiled_write_matches_reference(sid, runs):
    """D2 and D3 under "compiled": the source query runs through
    run_compiled and the table equals presto_tpu's and the dynamic
    write's."""
    mine = runs("port", "compiled", SQ.COMPILED_IDS)[sid]
    theirs = runs("ref", "compiled", SQ.COMPILED_IDS)[sid]
    assert mine[0].rows == theirs[0].rows
    for k in WRITE_STATS:
        assert getattr(mine[0].stats, k) == getattr(theirs[0].stats, k), k
    assert mine[0].stats.execution_mode == "compiled"
    _assert_tables_equal(mine[1], theirs[1])
    _assert_tables_equal(mine[1], runs("port", "dynamic")[sid][1])


# ---------------------------------------------------------------------------
# presto_tpu's values at a scale factor, for chip_smoke.py
# ---------------------------------------------------------------------------


def _reference_values(res) -> dict:
    """A run's {id: (QueryResult, digest)} as the frozen reference keeps
    it (JSON-able)."""
    return {sid: {"rows": [list(r) for r in SQ.comparable(
                      sid, r.rows, reference=True)],
                  "stats": [getattr(r.stats, k) for k in WRITE_STATS],
                  "counters": _counters(r.stats),
                  "digest": None if dig is None else
                  {k: v for k, v in dig.items() if k != "data"}}
            for sid, (r, dig) in res.items()}


def reference_at(sf: float, cache_dir=None) -> dict:
    """presto_tpu's rows, write stats, counters and table digests of the
    script at scale factor `sf`, in "auto" and "dynamic", and of D2 and
    D3 in "compiled", each fact once (SQ.compact_reference)."""
    from presto_tpu.catalog import tpch_catalog as ref_catalog

    out = {}
    for mode in MODES + ("compiled",):
        cat = ref_catalog(sf, cache_dir)
        session = presto_tpu.connect(
            cat, execution_mode=mode, query_max_memory_bytes=64 << 30)
        ids = SQ.COMPILED_IDS if mode == "compiled" else None
        out[mode] = _reference_values(SQ.run_script(session, RefSink, ids))
    return SQ.compact_reference(out)


def test_compact_reference_keeps_every_value(runs):
    """The frozen form (each fact once) gives each mode's values back
    exactly."""
    full = {mode: _reference_values(runs("ref", mode)) for mode in MODES}
    full["compiled"] = _reference_values(
        runs("ref", "compiled", SQ.COMPILED_IDS))
    compact = json.loads(json.dumps(SQ.compact_reference(full)))
    assert any(isinstance(v["digest"], str)
               for v in compact["dynamic"].values())
    for mode, want in full.items():
        got = SQ.expand_reference(compact, mode)
        assert list(got) == list(want)
        assert got == json.loads(json.dumps(want))


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python -m tests.test_torch_statements SF [CACHE_DIR]
    print(json.dumps({"sf": float(sys.argv[1]), **reference_at(
        float(sys.argv[1]), sys.argv[2] if len(sys.argv) > 2 else None)}))
