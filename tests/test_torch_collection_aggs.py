"""The eight aggregates of presto_tpu_torch that return collections
(array_agg, map_agg, multimap_agg, histogram, numeric_histogram,
map_union, set_agg, set_union) against presto_tpu on the CPU.

Both packages read one memory table made from seeded numpy columns with
NULL values, NULL keys, duplicate keys, empty strings, a group whose
values are all NULL and a group of one row.  Every probe runs grouped
and global in "dynamic" and "auto" (presto_tpu's static program refuses
these aggregates, so both fall back): rows, the seven counters, the
execution mode and the memo entry equal presto_tpu's, frozen in
tests/torch_collections_frozen.json (a slow test runs presto_tpu live
against them).  Rows compare
exactly, so the element order of array_agg, map_agg (first value wins),
multimap_agg and set_agg, which is the order of the aggregate's input
rows, and the order of every dictionary are presto_tpu's.  "compiled"
mode raises StaticFallback in both packages.  The port builds these with
numpy (exec/collections.py) where the reference loops over rows in
Python; a wider table (4,000 rows, 300 groups) holds the two to the same
values.
"""

import numpy as np
import pytest

import presto_tpu
import presto_tpu_torch
from presto_tpu import types as RT
from presto_tpu.catalog import Catalog as RCatalog
from presto_tpu.exec.executor import StaticFallback as RStaticFallback
from presto_tpu_torch import types as T
from presto_tpu_torch.catalog import Catalog
from presto_tpu_torch.exec.executor import COLLECTION_AGGS, StaticFallback
from tests.torch_collections_common import (MODES, assert_frozen,
                                            check_reference, frozen,
                                            tuplify, values_of)
from tests.torch_threads import torch_one_thread  # noqa: F401
SCHEMA = {"id": "BIGINT", "g": "BIGINT", "v": "BIGINT", "x": "DOUBLE",
          "s": "VARCHAR", "k": "VARCHAR", "b": "BOOLEAN"}


def _columns(n: int, n_groups: int, seed: int):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, n_groups, n)
    g[0] = n_groups  # a group of one row
    v = rng.integers(-5, 8, n)
    null_v = rng.random(n) < 0.15
    null_v[g == 3] = True  # a group whose values are all NULL
    x = np.round(rng.normal(0, 4, n), 3)

    def pick(values, null_share):
        a = np.array(values, dtype=object)[rng.integers(0, len(values), n)]
        return np.ma.masked_array(a, rng.random(n) < null_share)

    return {"id": np.arange(n, dtype=np.int64), "g": g.astype(np.int64),
            "v": np.ma.masked_array(v.astype(np.int64), null_v),
            "x": np.ma.masked_array(x, rng.random(n) < 0.1),
            "s": pick(["ab", "", "c", "de", "ab", "zz"], 0.1),
            "k": pick(["p", "q", "r", "s"], 0.1),
            "b": np.ma.masked_array(rng.random(n) < 0.5,
                                    rng.random(n) < 0.1)}


def _catalogs(n=160, n_groups=9, seed=41):
    cols = _columns(n, n_groups, seed)
    port, ref = Catalog(), RCatalog()
    port.register_memory("t", {c: T.parse_type(t) for c, t in SCHEMA.items()},
                         cols)
    ref.register_memory("t", {c: RT.parse_type(t)
                              for c, t in SCHEMA.items()}, cols)
    return port, ref


AGGS = {
    "array_agg": ("array_agg(v), array_agg(s), array_agg(x), array_agg(b), "
                  "array_agg(v) FILTER (WHERE v > 0)"),
    "array_agg_distinct": "array_agg(DISTINCT s), array_agg(DISTINCT v)",
    "map_agg": "map_agg(k, v), map_agg(v, s), map_agg(s, x)",
    "multimap_agg": "multimap_agg(k, v), multimap_agg(v, s)",
    "histogram": "histogram(s), histogram(v), histogram(b)",
    "numeric_histogram": ("numeric_histogram(3, x), numeric_histogram(1, v), "
                          "numeric_histogram(100, x)"),
    "set_agg": "set_agg(s), set_agg(v), set_agg(x)",
    "map_union": "map_union(h)",
    "set_union": "set_union(a)",
}

#: the inputs of map_union and set_union: maps and arrays of a subgroup
SUBGROUPS = ("(SELECT g, id % 3 AS sg, histogram(s) AS h, "
             "array_agg(v) AS a FROM t GROUP BY g, id % 3)")


def _probe(name: str, grouped: bool) -> str:
    src = SUBGROUPS if name in ("map_union", "set_union") else "t"
    if grouped:
        return (f"SELECT g, {AGGS[name]} FROM {src} GROUP BY g "
                f"ORDER BY g")
    return f"SELECT {AGGS[name]} FROM {src}"


@pytest.fixture(scope="module")
def sessions():
    port = _catalogs()[0]
    return {mode: presto_tpu_torch.connect(port, device="cpu",
                                           execution_mode=mode)
            for mode in MODES}


def _key(name: str, grouped: bool) -> str:
    return f"{name}:{'grouped' if grouped else 'global'}"


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(AGGS))
def test_matches_reference(name, mode, grouped, sessions):
    got = values_of(sessions[mode], _probe(name, grouped))
    assert_frozen(got, frozen(__name__, _key(name, grouped), mode))
    assert got["mode"] == "dynamic"


def test_every_aggregate_is_probed():
    probed = " ".join(AGGS.values())
    assert {a for a in COLLECTION_AGGS if f"{a}(" in probed} \
        == COLLECTION_AGGS
    assert len(COLLECTION_AGGS) == 8


@pytest.mark.parametrize("pkg,error", [("port", StaticFallback),
                                       ("ref", RStaticFallback)])
def test_compiled_mode_refuses(pkg, error):
    lib, cat = (presto_tpu_torch, _catalogs()[0]) if pkg == "port" \
        else (presto_tpu, _catalogs()[1])
    kw = {"device": "cpu"} if pkg == "port" else {}
    session = lib.connect(cat, execution_mode="compiled", **kw)
    for name in sorted(AGGS):
        with pytest.raises(error, match="dynamic-mode only"):
            session.sql(_probe(name, True))


#: rows of one group in scan order
ORDERED = ("SELECT array_agg(id), map_agg(k, id), multimap_agg(k, id), "
           "set_agg(v) FROM t WHERE g = 1")


def test_element_order_is_the_input_row_order(sessions):
    """array_agg, map_agg, multimap_agg and set_agg keep the rows' order:
    over a scan, id order."""
    got = values_of(sessions["dynamic"], ORDERED)
    assert_frozen(got, frozen(__name__, "ordered", "dynamic"))
    (arr, m, mm, st), = [tuple(tuplify(v) for v in r) for r in got["rows"]]
    assert list(arr) == sorted(arr)
    for _, ids in mm:
        assert list(ids) == sorted(ids)
    assert all(ids[0] == first for (_, ids), (_, first) in zip(mm, m))
    assert len(st) == len(set(st))


def _wide_sql(src: str) -> str:
    names = [n for n in sorted(AGGS)
             if (n in ("map_union", "set_union")) == (src == "subgroups")]
    return (f"SELECT g, {', '.join(AGGS[n] for n in names)} FROM "
            f"{SUBGROUPS if src == 'subgroups' else 't'} GROUP BY g "
            f"ORDER BY g")


#: the wider table: 4,000 rows in 300 groups
WIDE = (4000, 300, 7)


@pytest.mark.parametrize("src", ["rows", "subgroups"])
def test_wide_table_matches_reference(src):
    """Every aggregate in one query a source over the wider table: the
    numpy builders against the reference's row loops."""
    session = presto_tpu_torch.connect(_catalogs(*WIDE)[0], device="cpu",
                                       execution_mode="dynamic")
    assert_frozen(values_of(session, _wide_sql(src)),
                  frozen(__name__, f"wide:{src}", "dynamic"))


def frozen_cases():
    """{case: (presto_tpu's catalog, sql)} of the values frozen for this
    module (tests/torch_collections_common.py)."""
    ref, wide = _catalogs()[1], _catalogs(*WIDE)[1]
    cases = {_key(n, g): (ref, _probe(n, g)) for n in AGGS
             for g in (True, False)}
    cases["ordered"] = (ref, ORDERED)
    cases.update({f"wide:{src}": (wide, _wide_sql(src))
                  for src in ("rows", "subgroups")})
    return cases


@pytest.mark.slow
def test_frozen_values_are_presto_tpus():
    """presto_tpu, run live, gives the frozen values of every case."""
    check_reference(__name__)
