"""The plan node SpatialJoin in presto_tpu_torch against presto_tpu on the
CPU: every case of tests/test_spatial_join.py through both packages, on
its tables at a fifth of their size (20,000 points against 2,000 square
regions, and the distance join's 20,000 x 20,000 points at 4,000 each).

EXPLAIN prints `SpatialJoin GRID-INDEXED` in both packages and the same
text; rows are equal; the counts meet tests/test_spatial_join.py's numpy
brute force.  The node runs in the dynamic executor alone: "auto" runs
it dynamic and memoizes nothing, as presto_tpu does, and "compiled"
raises StaticFallback, as presto_tpu does.  Its matches gather both
sides through kernels.gather_batch (block_gather's path on a card).
"""

import numpy as np
import pytest

from presto_tpu_torch import geo_ml_queries as GQ
from presto_tpu_torch.exec.executor import SORT_STATS_KEYS
from tests import torch_geo_ml_common as C
from tests.torch_threads import torch_one_thread  # noqa: F401

MODES = ("dynamic", "auto", "compiled")
NP_, NG = 20_000, 2_000
_CONTAINS = "ST_Contains(ST_GeometryFromText(wkt), ST_Point(x, y))"


def _grid_tables(seed=0):
    """tests/test_spatial_join.py's _catalog at NP_ x NG."""
    rng = np.random.RandomState(seed)
    cx, cy = rng.uniform(0, 100, NG), rng.uniform(0, 100, NG)
    half = rng.uniform(0.1, 0.5, NG)
    wkts = np.asarray(
        [f"POLYGON (({x - h} {y - h}, {x + h} {y - h}, {x + h} {y + h}, "
         f"{x - h} {y + h}, {x - h} {y - h}))"
         for x, y, h in zip(cx, cy, half)], dtype=object)
    tables = {
        "pts": ({"id": "BIGINT", "x": "DOUBLE", "y": "DOUBLE"},
                {"id": np.arange(NP_, dtype=np.int64),
                 "x": rng.uniform(0, 100, NP_),
                 "y": rng.uniform(0, 100, NP_)}),
        "regions": ({"rid": "BIGINT", "wkt": "VARCHAR"},
                    {"rid": np.arange(NG, dtype=np.int64), "wkt": wkts})}
    return tables, (cx, cy, half)


def _distance_tables():
    rng = np.random.RandomState(5)
    n = 4000
    return {"a": ({"ax": "DOUBLE", "ay": "DOUBLE"},
                  {"ax": rng.uniform(0, 10, n), "ay": rng.uniform(0, 10, n)}),
            "b": ({"bx": "DOUBLE", "bv": "DOUBLE"},
                  {"bx": rng.uniform(0, 10, n), "bv": rng.uniform(0, 10, n)})}


def _shape_tables():
    """The small tables of the non-convex, NULL/EMPTY, low-cardinality
    and skew cases."""
    nonconvex = {
        "p": ({"x": "DOUBLE", "y": "DOUBLE"},
              {"x": np.asarray([1.0, 3.0, 5.0, 2.5]),
               "y": np.asarray([1.0, 3.0, 5.0, 2.5])}),
        "g": ({"gid": "BIGINT", "wkt": "VARCHAR"},
              {"gid": np.arange(2, dtype=np.int64),
               "wkt": np.asarray([
                   "POLYGON ((0 0, 4 0, 4 2, 2 2, 2 4, 0 4, 0 0))",
                   "POLYGON ((1 1, 4 1, 4 4, 1 4, 1 1), "
                   "(2 2, 3 2, 3 3, 2 3, 2 2))"], dtype=object)})}
    nulls = {
        "p2": ({"x": "DOUBLE", "y": "DOUBLE"},
               {"x": np.asarray([1.0, np.nan]), "y": np.asarray([1.0, 1.0])}),
        "g2": ({"gid": "BIGINT", "wkt": "VARCHAR"},
               {"gid": np.arange(3, dtype=np.int64),
                "wkt": np.ma.masked_array(
                    np.asarray(["POLYGON ((0 0, 2 0, 2 2, 0 2, 0 0))",
                                "POLYGON EMPTY", "placeholder"],
                               dtype=object), mask=[False, False, True])})}
    low = {
        "p3": ({"x": "DOUBLE", "y": "DOUBLE"},
               {"x": np.asarray([0.5]), "y": np.asarray([0.5])}),
        "g3": ({"rid": "BIGINT", "wkt": "VARCHAR"},
               {"rid": np.arange(1000, dtype=np.int64),
                "wkt": np.asarray(
                    [f"POLYGON (({i} 0, {i + 1} 0, {i + 1} 1, {i} 1, {i} 0))"
                     for i in range(4)], dtype=object)[np.arange(1000) % 4]})}
    rng = np.random.RandomState(9)
    n = 1_000
    tiny = [f"POLYGON (({x} {y}, {x + 0.01} {y}, {x + 0.01} {y + 0.01},"
            f" {x} {y + 0.01}, {x} {y}))"
            for x, y in zip(rng.uniform(0, 100, n), rng.uniform(0, 100, n))]
    skew = {
        "p4": ({"x": "DOUBLE", "y": "DOUBLE"},
               {"x": rng.uniform(1, 99, 2000), "y": rng.uniform(1, 99, 2000)}),
        "g4": ({"gid": "BIGINT", "wkt": "VARCHAR"},
               {"gid": np.arange(n + 1, dtype=np.int64),
                "wkt": np.asarray(
                    tiny + ["POLYGON ((0 0, 100 0, 100 100, 0 100, 0 0))"],
                    dtype=object)})}
    return {**nonconvex, **nulls, **low, **skew}


CASES = [
    f"EXPLAIN SELECT count(*) FROM pts, regions WHERE {_CONTAINS}",
    f"SELECT count(*) FROM pts, regions WHERE {_CONTAINS}",
    "SELECT count(*) FROM pts, regions WHERE ST_Within(ST_Point(x, y), "
    "ST_GeometryFromText(wkt))",
    f"SELECT count(*) FROM regions, pts WHERE {_CONTAINS}",
    f"SELECT count(*) FROM pts, regions WHERE {_CONTAINS} AND rid < 1000 "
    "AND id % 2 = 0",
    f"SELECT rid, count(*) FROM pts, regions WHERE {_CONTAINS} "
    "GROUP BY rid ORDER BY 2 DESC, rid LIMIT 10",
    "EXPLAIN SELECT count(*) FROM a, b WHERE ST_Distance(ST_Point(ax, ay), "
    "ST_Point(bx, bv)) < 0.02",
    "SELECT count(*) FROM a, b WHERE ST_Distance(ST_Point(ax, ay), "
    "ST_Point(bx, bv)) < 0.02",
    "SELECT count(*) FROM a, b WHERE ST_Distance(ST_Point(ax, ay), "
    "ST_Point(bx, bv)) <= 0.05",
    "SELECT gid, x, y FROM p, g WHERE ST_Contains(ST_GeometryFromText(wkt), "
    "ST_Point(x, y)) ORDER BY gid, x",
    "SELECT gid FROM p2, g2 WHERE ST_Contains(ST_GeometryFromText(wkt), "
    "ST_Point(x, y))",
    "SELECT count(*) FROM p3, g3 WHERE ST_Contains(ST_GeometryFromText(wkt), "
    "ST_Point(x, y))",
    "SELECT count(*) FROM p4, g4 WHERE ST_Contains(ST_GeometryFromText(wkt), "
    f"ST_Point(x, y)) AND gid = 1000",
]


@pytest.fixture(scope="module")
def sessions():
    tables = {**_grid_tables()[0], **_distance_tables(), **_shape_tables()}
    out = {}
    for pkg in ("port", "ref"):
        cat = C.register(pkg, C.empty_catalog(pkg), tables)
        for mode in MODES:
            out[pkg, mode] = C.connect(pkg, cat, mode)
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sql", CASES)
def test_case_matches_reference(sql, mode, sessions):
    mine = GQ.record(sessions["port", mode], sql, SORT_STATS_KEYS)
    theirs = GQ.record(sessions["ref", mode], sql, SORT_STATS_KEYS)
    assert GQ.mismatch("case", mine, theirs) == ""
    if sql.startswith("EXPLAIN"):  # the records hold the text's digest
        text = sessions["port", mode].sql(sql).rows[0][0]
        assert "SpatialJoin GRID-INDEXED" in text and "CROSS" not in text
    elif mode == "compiled":  # the node is dynamic-mode only
        assert mine["error"] == ["StaticFallback",
                                 "spatial join is dynamic-mode only"]
    elif mode == "auto":
        assert mine["mode"] == "dynamic" and mine["memo"] == []


def test_counts_meet_the_brute_force(sessions):
    """tests/test_spatial_join.py's numpy oracles: the contains join over
    the axis-aligned squares, and the distance join."""
    tables, (cx, cy, half) = _grid_tables()
    xs, ys = tables["pts"][1]["x"], tables["pts"][1]["y"]
    expect = 0
    for i in range(0, NP_, 5_000):
        sl = slice(i, i + 5_000)
        expect += int(((xs[sl, None] >= cx - half)
                       & (xs[sl, None] <= cx + half)
                       & (ys[sl, None] >= cy - half)
                       & (ys[sl, None] <= cy + half)).sum())
    s = sessions["port", "dynamic"]
    assert s.sql(CASES[1]).rows == [(expect,)]
    d = _distance_tables()
    ax, ay = d["a"][1]["ax"], d["a"][1]["ay"]
    bx, bv = d["b"][1]["bx"], d["b"][1]["bv"]
    d2 = (ax[:, None] - bx) ** 2 + (ay[:, None] - bv) ** 2
    assert s.sql(CASES[7]).rows == [(int((d2 < 0.02 ** 2).sum()),)]
    assert s.sql(CASES[8]).rows == [(int((d2 <= 0.05 ** 2).sum()),)]


def test_shape_cases_hold_the_reference_tests_facts(sessions):
    s = sessions["port", "dynamic"]
    r = s.sql(CASES[9]).rows
    assert (0, 1.0, 1.0) in r and (0, 3.0, 3.0) not in r
    assert (1, 3.0, 3.0) in r and (1, 2.5, 2.5) not in r
    assert s.sql(CASES[10]).rows == [(0,)]
    assert s.sql(CASES[11]).rows == [(250,)]
    assert s.sql(CASES[12]).rows == [(2000,)]
