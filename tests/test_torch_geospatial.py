"""functions/geospatial.py in presto_tpu_torch against presto_tpu on the
CPU: the scalar functions (every case of tests/test_geospatial.py) and
the G corpus of presto_tpu_torch/geo_ml_queries.py at its SMALL size;
the SpatialJoin cases of tests/test_spatial_join.py are
tests/test_torch_spatial_join.py's.

Each case runs through both packages in "dynamic", "auto" and
"compiled" over the same tables (made from the seeds those tests use):
the same rows (floats within rtol 1e-9: sums of distances add in another
order), or the same error (StaticFallback by its type alone, presto_tpu's
message being its trace's), and the same execution mode, counters and
memo entry.  A scalar ST_Point is a device pair in both packages, which
presto_tpu's trace cannot read back: queries that use one run dynamic in
"auto" and raise StaticFallback in "compiled"; a literal geometry against
the point column runs as a graph, its static pass reading nothing back
(test_literal_geometry_predicates_read_nothing_back).  G1 also meets an
independent brute-force count (geo_ml_queries.brute_force_contains).
"""

import numpy as np
import pytest
import torch

from presto_tpu_torch import geo_ml_queries as GQ
from presto_tpu_torch.exec.executor import SORT_STATS_KEYS
from tests import torch_geo_ml_common as C
from tests.torch_functions_common import static_pass_builds
from tests.torch_threads import torch_one_thread  # noqa: F401

MODES = ("dynamic", "auto", "compiled")


def _pts_tables():
    """tests/test_geospatial.py's table."""
    rng = np.random.default_rng(4)
    n = 2000
    return {"pts": ({"x": "DOUBLE", "y": "DOUBLE"},
                    {"x": rng.uniform(-2, 2, n), "y": rng.uniform(-2, 2, n)})}


_A = "'POLYGON ((0 0, 2 0, 2 2, 0 2, 0 0))'"
_HOLE = ("POLYGON ((-2 -2, 2 -2, 2 2, -2 2, -2 -2), "
         "(-1 -1, 1 -1, 1 1, -1 1, -1 -1))")
_DONUT = ("POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), "
          "(4 4, 6 4, 6 6, 4 6, 4 4))")
_U = "POLYGON ((0 0, 6 0, 6 5, 4 5, 4 2, 2 2, 2 5, 0 5, 0 0))"

#: tests/test_geospatial.py's SQL, in its order
CASES = [
    "SELECT ST_X(ST_Point(3.5, -1))", "SELECT ST_Y(ST_Point(3.5, -1))",
    "SELECT ST_AsText(ST_Point(2, 4))",
    f"SELECT ST_AsText(ST_GeometryFromText({_A}))",
    "SELECT count(*) FROM pts WHERE ST_Contains(ST_GeometryFromText("
    "'POLYGON ((-1 -1, 1 -1, 1 1, -1 1, -1 -1))'), ST_Point(x, y))",
    f"SELECT ST_Contains(ST_GeometryFromText('{_HOLE}'), ST_Point(1.5, 0))",
    f"SELECT ST_Contains(ST_GeometryFromText('{_HOLE}'), ST_Point(0, 0))",
    "SELECT ST_Distance(ST_Point(0, 0), ST_Point(3, 4))",
    "SELECT ST_Distance(ST_GeometryFromText('LINESTRING (0 0, 10 0)'), "
    "ST_Point(5, 2))",
    "SELECT ST_Distance(ST_GeometryFromText("
    "'POLYGON ((0 0, 2 0, 2 2, 0 2, 0 0))'), ST_Point(1, 1))",
    "SELECT sum(ST_Distance(ST_Point(x, y), ST_Point(0, 0))) FROM pts",
    "SELECT ST_Area(ST_GeometryFromText("
    "'POLYGON ((0 0, 4 0, 4 3, 0 3, 0 0))'))",
    "SELECT ST_AsText(ST_Envelope(ST_GeometryFromText("
    "'LINESTRING (0 1, 5 0, 3 4)')))",
    "SELECT ST_NPoints(ST_GeometryFromText("
    "'POLYGON ((0 0, 4 0, 4 3, 0 3, 0 0))'))",
    "SELECT ST_Length(ST_GeometryFromText('LINESTRING (0 0, 3 4, 3 10)'))",
    f"SELECT ST_Intersects(ST_GeometryFromText({_A}), ST_GeometryFromText("
    "'POLYGON ((1 1, 3 1, 3 3, 1 3, 1 1))'))",
    f"SELECT ST_Intersects(ST_GeometryFromText({_A}), ST_GeometryFromText("
    "'POLYGON ((5 5, 6 5, 6 6, 5 6, 5 5))'))",
    f"SELECT ST_Within(ST_Point(1, 1), ST_GeometryFromText({_A}))",
    "SELECT g.name, count(*) c FROM pts, (VALUES ('ne'), ('sw')) g(name) "
    "WHERE (g.name = 'ne' AND ST_Contains(ST_GeometryFromText("
    "'POLYGON ((0 0, 2 0, 2 2, 0 2, 0 0))'), ST_Point(x, y))) "
    "OR (g.name = 'sw' AND ST_Contains(ST_GeometryFromText("
    "'POLYGON ((-2 -2, 0 -2, 0 0, -2 0, -2 -2))'), ST_Point(x, y))) "
    "GROUP BY g.name ORDER BY g.name",
    "SELECT ST_Intersects(ST_GeometryFromText("
    "'POLYGON ((-5 -1, 5 -1, 5 1, -5 1, -5 -1))'), ST_GeometryFromText("
    "'POLYGON ((-1 -5, 1 -5, 1 5, -1 5, -1 -5))'))",
    f"SELECT ST_Distance(ST_GeometryFromText('{_DONUT}'), ST_Point(5, 5))",
    "SELECT ST_AsText(ST_Centroid(ST_GeometryFromText("
    "'POLYGON ((0 0, 4 0, 4 3, 0 3, 0 0))')))",
    "SELECT ST_AsText(ST_Centroid(ST_GeometryFromText("
    "'LINESTRING (0 0, 10 0)')))",
    f"SELECT ST_Contains(ST_GeometryFromText('{_U}'), "
    "ST_GeometryFromText('LINESTRING (1 4, 5 4)'))",
    f"SELECT ST_Contains(ST_GeometryFromText('{_U}'), "
    "ST_GeometryFromText('LINESTRING (1 1, 5 1)'))",
    f"SELECT ST_NPoints(ST_GeometryFromText('{_DONUT}'))",
    # the device predicates over the column, as graphs
    f"SELECT count_if(ST_Contains(ST_GeometryFromText('{_HOLE}'), "
    "ST_Point(x, y))), sum(ST_Distance(ST_Point(x, y), "
    f"ST_GeometryFromText('{_DONUT}'))) FROM pts",
    "SELECT count(*) FROM pts WHERE ST_Intersects(ST_GeometryFromText("
    "'POLYGON ((0 0, 4 0, 4 4, 0 4, 0 0))'), ST_Point(x, y))",
    "SELECT sum(ST_X(ST_Point(x, y)) - ST_Y(ST_Point(y, x))) FROM pts",
    # refused keys: presto_tpu's sort operand raises over point rows
    "SELECT x FROM pts ORDER BY ST_Point(x, y) LIMIT 2",
]


def _outcome(session, sql):
    return GQ.record(session, sql, SORT_STATS_KEYS)


@pytest.fixture(scope="module")
def sessions():
    tables = _pts_tables()
    out = {}
    for pkg in ("port", "ref"):
        cat = C.register(pkg, C.empty_catalog(pkg), tables)
        for mode in MODES:
            out[pkg, mode] = C.connect(pkg, cat, mode)
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sql", CASES)
def test_case_matches_reference(sql, mode, sessions):
    mine = _outcome(sessions["port", mode], sql)
    theirs = _outcome(sessions["ref", mode], sql)
    assert GQ.mismatch("case", mine, theirs) == ""


def test_contains_over_the_column_meets_numpy(sessions):
    """tests/test_geospatial.py's check of the device path, exact here:
    the ray cast's boundary rule (a point on the lower or left edge is
    in, on the upper or right one out) and no point on an edge."""
    x, y = _pts_tables()["pts"][1].values()
    want = int(((x >= -1) & (x < 1) & (y >= -1) & (y < 1)).sum())
    got = sessions["port", "dynamic"].sql(CASES[4]).rows[0][0]
    assert got == want


@pytest.mark.parametrize("sql", [CASES[4], CASES[-4], CASES[-3]])
def test_literal_geometry_predicates_read_nothing_back(sql):
    """A literal geometry against the point column: the static pass runs
    with every host read and Python scalar store made to raise, so the
    predicate captures as a CUDA graph on a card (the edges' coordinates
    are Python floats; no tensor is built from host data during it)."""
    cat = C.register("port", C.empty_catalog("port"), _pts_tables())
    result, built = static_pass_builds(sql, cat)
    assert result.stats.execution_mode == "compiled" and len(built) == 1


# ---------------------------------------------------------------------------
# the G corpus at SMALL
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    """The port's runs, and presto_tpu's frozen ones
    (tests/torch_geo_ml_frozen.json; its compiles of G take half a
    minute)."""
    return {"port": C.geo_runs("port", GQ.SMALL), "ref": C.frozen()["geo"]}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sid", ["G1", "G2", "G3", "G4", "G4b", "G5"])
def test_corpus_matches_reference(sid, mode, corpus):
    assert GQ.mismatch(sid, corpus["port"][mode][sid],
                       corpus["ref"][mode][sid]) == ""


@pytest.mark.slow
def test_frozen_corpus_is_presto_tpus():
    assert C.geo_runs("ref", GQ.SMALL) == C.frozen()["geo"]


def test_g1_meets_the_brute_force_count(corpus):
    tables = GQ.geo_tables(GQ.SMALL)
    x = np.ma.filled(tables["pts"][1]["x"], np.nan)
    xy = np.stack([x, tables["pts"][1]["y"]], axis=1)
    want = GQ.brute_force_contains(xy, GQ.square_boxes(tables),
                                   GQ.polygon_wkts(tables), 4096, torch,
                                   "cpu")
    assert corpus["port"]["dynamic"]["G1"]["rows"] == [[want]]
    # the regions of every kind matched (the big squares take the grid's
    # brute-force branch, the polygons the ray cast's holes)
    assert len(corpus["port"]["dynamic"]["G2"]["rows"]) == 100


def test_corpus_tables_have_the_stated_shape():
    tables = GQ.geo_tables(GQ.SMALL)
    wkts = tables["regions"][1]["wkt"]
    assert len(wkts) == GQ.SMALL["regions"]
    holes = [w for w in wkts if "), (" in w]
    assert len(holes) == GQ.N_POLYGONS
    verts = [w.split("), (")[0].count(",") for w in holes]
    assert 16 <= min(verts) and max(verts) <= 64
    boxes = GQ.square_boxes(tables)
    half = (boxes[:, 2] - boxes[:, 0]) / 2
    assert np.sum(half >= 10) == GQ.N_BIG
    assert np.all((half[:-GQ.N_BIG] >= 0.1) & (half[:-GQ.N_BIG] <= 0.5))
    assert 0 < np.ma.count_masked(tables["pts"][1]["x"]) < 60
