"""The geospatial, ML and float32_compute corpus (G, M and F32).

G: a geofencing workload over tables made from a seed with numpy
(geo_tables): `pts` (id BIGINT, x DOUBLE, y DOUBLE; 70% of the points
from 64 Gaussian clusters of sigma 1.5, 30% uniform on [0, 100)^2, 0.1%
of x NULL), `regions` (rid BIGINT, wkt VARCHAR: axis-aligned squares of
half-side U(0.1, 0.5), 100 non-convex star polygons with one square
hole, 16 to 64 vertices, and 10 squares of half-side 10 to 30 that span
more than 256 grid cells and take the spatial join's brute-force branch)
and `sites` (sid BIGINT, sx DOUBLE, sy DOUBLE, drawn as `pts` is).
FULL is chip_smoke.py's size, SMALL the CPU tests'.

  G1  the point-in-polygon join's count (SpatialJoin, contains)
  G2  the same grouped by region, the 100 fullest
  G3  a distance join: the first `probes` points against `sites`
  G4  the scalar functions over the regions column: presto_tpu builds an
      int32 table of parsed geometries there and raises ValueError, and
      the port raises it too
  G4b the same functions over literal WKTs of some regions (literals(),
      one SELECT a region, UNION ALL)
  G5  a literal polygon with a hole and a literal linestring against the
      point column (the device predicates; a graph in compiled mode)

M: the ML functions over TPC-H lineitem.  Features leave out
l_extendedprice and o_totalprice, which presto_tpu's device generator
makes one ulp off at SF1 (statement_queries.DEVICE_ROUNDED).

  M1  learn_classifier and learn_regressor over the rows with
      l_orderkey % 256 = 1 (one order in 64: TPC-H's order keys are
      sparse, the first 8 of every 32, so no key is 0 modulo 64)
  M2  classify and regress over every row through the CROSS JOIN model
      form, the models read from a memory table `models` (cm, rm
      VARBINARY) that holds presto_tpu's M1 blobs
  M3  classification_precision, recall and thresholds at 10 buckets and
      evaluate_classifier_predictions over every row

F32: TPC-H Q1, Q3, Q6 and Q18 under float32_compute, held within the
tolerances of f32_tolerance.
"""

from __future__ import annotations

import hashlib
import json
import math
from typing import Dict, List, Optional

import numpy as np

# presto_tpu's records {mode: {id: record}} with each fact once, and the
# session memo's entries of a text, as the decimal corpus keeps them
from presto_tpu_torch.decimal_queries import (  # noqa: F401
    compact_reference, expand_reference, memo_state)

SEED = 17
FULL = {"points": 4_000_000, "regions": 10_000, "sites": 10_000,
        "probes": 1_000_000}
SMALL = {"points": 20_000, "regions": 2_000, "sites": 2_000,
         "probes": 5_000}
N_POLYGONS = 100  # non-convex polygons with a hole
N_BIG = 10  # squares of half-side 10 to 30: the grid's skew branch
CLUSTERS = 64
SIGMA = 1.5
RADIUS = 0.05  # G3's distance

_CONTAINS = "ST_Contains(ST_GeometryFromText(wkt), ST_Point(x, y))"
_LINE = "LINESTRING (10 10, 50 60, 90 20)"

#: the features of M (no l_extendedprice: see the module docstring); the
#: ship date's day number makes l_returnflag learnable ('N' after the
#: TPC-H current date), so classify gives all three labels
CLASSIFIER_FEATURES = ("features(l_quantity, l_discount, l_tax, "
                       "date_diff('day', DATE '1992-01-01', l_shipdate))")
REGRESSOR_FEATURES = "features(l_discount, l_tax, l_linenumber)"

F32_QUERIES = (1, 3, 6, 18)
F32_MODES = ("dynamic", "compiled")
GEO_ML_MODES = ("dynamic", "auto", "compiled")

#: G and M ids whose runs must launch fused_group_sums / block_gather on
#: the card (chip_smoke.py's corpus_verdict)
FUSED_IDS = ()
GATHER_IDS = ("G1", "G2", "G3")

UNIT_ROUNDOFF_F32 = 2.0 ** -24
UNIT_ROUNDOFF_F64 = 2.0 ** -53


def _points(rng, n: int):
    centers = rng.uniform(5.0, 95.0, (CLUSTERS, 2))
    clustered = int(round(n * 0.7))
    which = rng.integers(0, CLUSTERS, clustered)
    xy = np.concatenate([
        centers[which] + rng.normal(0.0, SIGMA, (clustered, 2)),
        rng.uniform(0.0, 100.0, (n - clustered, 2))])
    return xy[rng.permutation(n)]


def _wkt_ring(pts) -> str:
    return "(" + ", ".join(f"{float(x)!r} {float(y)!r}" for x, y in pts) \
        + ")"


def _square(cx: float, cy: float, h: float) -> list:
    return [(cx - h, cy - h), (cx + h, cy - h), (cx + h, cy + h),
            (cx - h, cy + h), (cx - h, cy - h)]


def _star_with_hole(rng, cx: float, cy: float) -> str:
    """A non-convex star of 16 to 64 vertices (counter-clockwise) around
    (cx, cy), and a square hole (clockwise) at its center."""
    m = 2 * int(rng.integers(8, 33))
    r_out = float(rng.uniform(1.0, 3.0))
    ang = np.arange(m) * (2.0 * math.pi / m)
    rad = np.where(np.arange(m) % 2 == 0, r_out, 0.5 * r_out)
    outer = [(cx + r * math.cos(a), cy + r * math.sin(a))
             for r, a in zip(rad, ang)]
    outer.append(outer[0])
    h = 0.2 * 0.5 * r_out
    hole = _square(cx, cy, h)[::-1]
    return f"POLYGON ({_wkt_ring(outer)}, {_wkt_ring(hole)})"


def geo_tables(sizes: dict, seed: int = SEED) -> Dict[str, tuple]:
    """{table: (schema {column: type name}, columns)} of G at `sizes`."""
    rng = np.random.default_rng(seed)
    n = sizes["points"]
    xy = _points(rng, n)
    x = np.ma.masked_array(xy[:, 0], mask=rng.random(n) < 0.001)
    n_regions = sizes["regions"]
    n_small = n_regions - N_POLYGONS - N_BIG
    wkts = []
    for cx, cy, h in zip(rng.uniform(0.0, 100.0, n_small),
                         rng.uniform(0.0, 100.0, n_small),
                         rng.uniform(0.1, 0.5, n_small)):
        wkts.append(f"POLYGON ({_wkt_ring(_square(cx, cy, h))})")
    for cx, cy, h in zip(rng.uniform(0.0, 100.0, N_BIG),
                         rng.uniform(0.0, 100.0, N_BIG),
                         rng.uniform(10.0, 30.0, N_BIG)):
        wkts.append(f"POLYGON ({_wkt_ring(_square(cx, cy, h))})")
    for cx, cy in zip(rng.uniform(5.0, 95.0, N_POLYGONS),
                      rng.uniform(5.0, 95.0, N_POLYGONS)):
        wkts.append(_star_with_hole(rng, cx, cy))
    sxy = _points(rng, sizes["sites"])
    return {
        "pts": ({"id": "BIGINT", "x": "DOUBLE", "y": "DOUBLE"},
                {"id": np.arange(n, dtype=np.int64), "x": x,
                 "y": xy[:, 1].copy()}),
        "regions": ({"rid": "BIGINT", "wkt": "VARCHAR"},
                    {"rid": np.arange(n_regions, dtype=np.int64),
                     "wkt": np.asarray(wkts, dtype=object)}),
        "sites": ({"sid": "BIGINT", "sx": "DOUBLE", "sy": "DOUBLE"},
                  {"sid": np.arange(sizes["sites"], dtype=np.int64),
                   "sx": sxy[:, 0].copy(), "sy": sxy[:, 1].copy()}),
    }


def square_boxes(tables: Dict[str, tuple]) -> np.ndarray:
    """[(x0, y0, x1, y1)] of the square regions (the small and the big
    ones), parsed back from their WKT: the brute-force check's boxes."""
    boxes = []
    for w in tables["regions"][1]["wkt"][:-N_POLYGONS]:
        ring = w[len("POLYGON (("):-2].split(", ")
        xs = [float(p.split()[0]) for p in ring]
        ys = [float(p.split()[1]) for p in ring]
        boxes.append((min(xs), min(ys), max(xs), max(ys)))
    return np.asarray(boxes)


def polygon_wkts(tables: Dict[str, tuple]) -> List[str]:
    return list(tables["regions"][1]["wkt"][-N_POLYGONS:])


def literals(tables: Dict[str, tuple]) -> List[str]:
    """G4b's WKTs: two small squares, the big squares and two polygons
    with a hole."""
    w = tables["regions"][1]["wkt"]
    n_sq = len(w) - N_POLYGONS
    return [w[0], w[1], *w[n_sq - N_BIG:n_sq], w[n_sq], w[-1]]


def geo_queries(tables: Dict[str, tuple], sizes: dict) -> Dict[str, str]:
    one = ("st_area(st_geometryfromtext({g})), "
           "st_astext(st_centroid(st_geometryfromtext({g}))), "
           "st_astext(st_envelope(st_geometryfromtext({g}))), "
           "st_npoints(st_geometryfromtext({g})), "
           "st_length(st_geometryfromtext({g}))")
    g4b = " UNION ALL ".join(
        f"SELECT {i} AS k, " + one.format(g=f"'{w}'")
        for i, w in enumerate(literals(tables)))
    hole = polygon_wkts(tables)[0]
    return {
        "G1": f"SELECT count(*) FROM pts, regions WHERE {_CONTAINS}",
        "G2": (f"SELECT rid, count(*) AS c FROM pts, regions "
               f"WHERE {_CONTAINS} GROUP BY rid ORDER BY c DESC, rid "
               "LIMIT 100"),
        "G3": ("SELECT count(*), sum(b.sid), sum(a.id) FROM pts a, sites b "
               f"WHERE a.id < {sizes['probes']} AND ST_Distance("
               "ST_Point(a.x, a.y), ST_Point(b.sx, b.sy)) <= "
               f"{RADIUS}"),
        "G4": ("SELECT rid, " + one.format(g="wkt")
               + " FROM regions ORDER BY rid LIMIT 20"),
        "G4b": g4b + " ORDER BY k",
        "G5": (f"SELECT count_if(ST_Contains(ST_GeometryFromText('{hole}'), "
               "ST_Point(x, y))), sum(ST_Distance(ST_Point(x, y), "
               f"ST_GeometryFromText('{_LINE}'))) FROM pts"),
    }


M1 = (f"SELECT learn_classifier(l_returnflag, {CLASSIFIER_FEATURES}) AS cm, "
      f"learn_regressor(l_quantity, {REGRESSOR_FEATURES}) AS rm "
      "FROM lineitem WHERE l_orderkey % 256 = 1")
ML_QUERIES = {
    "M1": M1,
    "M2": (f"SELECT classify({CLASSIFIER_FEATURES}, m.cm) AS lab, count(*), "
           f"sum(regress({REGRESSOR_FEATURES}, m.rm)) "
           "FROM lineitem CROSS JOIN models m GROUP BY 1 ORDER BY 1"),
    "M3": ("SELECT classification_precision(10, l_returnflag = 'R', "
           "l_discount * 10), classification_recall(10, l_returnflag = 'R', "
           "l_discount * 10), classification_thresholds(10, "
           "l_returnflag = 'R', l_discount * 10), "
           "evaluate_classifier_predictions(l_returnflag, "
           f"classify({CLASSIFIER_FEATURES}, m.cm)) "
           "FROM lineitem CROSS JOIN models m"),
}


def models_table(blobs) -> tuple:
    """`models`' (schema, columns) holding one classifier and one
    regressor blob."""
    cols = {}
    for name, blob in zip(("cm", "rm"), blobs):
        a = np.empty(1, dtype=object)
        a[0] = bytes(blob)
        cols[name] = a
    return {"cm": "VARBINARY", "rm": "VARBINARY"}, cols


# ---------------------------------------------------------------------------
# float32_compute tolerances
# ---------------------------------------------------------------------------

#: how each package adds a sum's terms, and so how many additions one
#: term passes at most (the depth d of gamma_d):
#: "f64"     the fused prepass's f64 sums of f32 values (an order no
#:           package fixes: d = n, in f64's roundoff);
#: "window"  a global f32 sum: windows of 32 terms, level by level, in
#:           both packages (presto_tpu's jnp.sum on the CPU is rewritten
#:           so by XLA, reduce-window size 32 stride 32 in its compiled
#:           HLO; the port's kernels.window_sum32), at most 31 additions a
#:           level;
#: "f32"     a grouped f32 sum (a scatter or a library product in
#:           presto_tpu, segment reductions in the port): d = n.
SUM_ORDERS = ("f64", "window", "f32")

#: per TPC-H query: {column: (order, f32 operations, sums)}.  The
#: operations are the f32 ones along one path to the value: its terms'
#: (l_extendedprice * (1 - l_discount) * (1 + l_tax): four) and those
#: after the sums (Q14's 100.00 * A / B: two); sums counts the sums a
#: value is made of (Q14's ratio: two).  Every term of these sums is
#: non-negative, so a bound relative to the value is one relative to
#: the sum of |x|.
F32_COLUMNS = {
    1: {2: ("f64", 0, 1), 3: ("f64", 0, 1), 4: ("f64", 2, 1),
        5: ("f64", 4, 1), 6: ("f64", 1, 1), 7: ("f64", 1, 1),
        8: ("f64", 1, 1)},
    3: {1: ("f32", 2, 1)},
    6: {0: ("window", 1, 1)},
    8: {1: ("f32", 5, 2)},
    14: {0: ("window", 6, 2)},
    17: {0: ("window", 1, 1)},
    18: {4: ("f32", 0, 1), 5: ("f32", 0, 1)},
    19: {0: ("window", 2, 1)},
}

#: the rows a sum adds: every lineitem row (Q1's groups and the global
#: sums, dead rows adding zeros), or one order's lines (at most 7)
F32_SUM_ROWS = {1: "lineitem", 3: 7, 6: "lineitem", 8: "lineitem",
                14: "lineitem", 17: "lineitem", 18: 7, 19: "lineitem"}

#: every float column of the other TPC-H queries (the CPU tests run all
#: 22): one grouped f32 sum of up to every lineitem row, of values that
#: took up to eight f32 operations.  Its bound is loose (the order of
#: presto_tpu's grouped sums is a library's); f32_mismatch's float-type
#: check is what tells f32 compute from f64 compute there.
F32_DEFAULT = ("f32", 8, 1)


def gamma(n: int, u: float) -> float:
    """gamma_n = n u / (1 - n u): the bound of a sum whose terms each
    pass at most n additions in unit roundoff u, relative to the sum of
    their magnitudes."""
    nu = n * u
    return nu / (1.0 - nu) if nu < 1.0 else math.inf


def sum_depth(order: str, n: int) -> int:
    """The most additions one term of a sum of n terms passes, in the
    order of SUM_ORDERS."""
    if order != "window":
        return n
    levels = 0
    while n > 1:
        n = -(-n // 32)
        levels += 1
    return 31 * levels


def f32_tolerance(qid: int, col: int, n_lineitem: int) -> Optional[float]:
    """The relative bound (of the value's magnitude) between two correct
    runs of column `col` of TPC-H `qid` under float32_compute: each run's
    value carries its f32 operations' rounding (u each) and each of its
    sums' (gamma of the sum's depth in the accumulation's roundoff), and
    the two runs may differ by both bounds.  None: an exact column (a
    query of F32_COLUMNS that does not list it); a query outside
    F32_COLUMNS takes F32_DEFAULT for every float column."""
    if qid not in F32_COLUMNS:
        order, ops, sums = F32_DEFAULT
        n = n_lineitem
    else:
        spec = F32_COLUMNS[qid].get(col)
        if spec is None:
            return None
        order, ops, sums = spec
        n = n_lineitem if F32_SUM_ROWS[qid] == "lineitem" \
            else F32_SUM_ROWS[qid]
    u_acc = UNIT_ROUNDOFF_F64 if order == "f64" else UNIT_ROUNDOFF_F32
    return 2.0 * (ops * UNIT_ROUNDOFF_F32
                  + sums * gamma(sum_depth(order, n), u_acc))


def is_f32_value(x: float) -> bool:
    """Whether a float is a value of float32 (NaN is not)."""
    return float(np.float32(x)) == x


def f32_mismatch(qid: int, mine: list, theirs: list, n_lineitem: int,
                 rtol: float = 1e-9) -> str:
    """'' when rows agree: f32_tolerance's columns within their bound,
    other floats within rtol, everything else exactly; and every float
    an f32 value exactly where presto_tpu's is (an f32 sum gives one, an
    f64 sum or f64 compute almost never does)."""
    if len(mine) != len(theirs):
        return f"Q{qid}: {len(mine)} rows against {len(theirs)}"
    for i, (a, b) in enumerate(zip(mine, theirs)):
        if len(a) != len(b):
            return f"Q{qid} row {i}: {a} against {b}"
        for c, (x, y) in enumerate(zip(a, b)):
            tol = f32_tolerance(qid, c, n_lineitem)
            if isinstance(x, float) and isinstance(y, float):
                t = rtol if tol is None else tol
                if abs(x - y) > t * max(abs(x), abs(y)):
                    return f"Q{qid} row {i} col {c}: {x} against {y}"
                if is_f32_value(x) != is_f32_value(y):
                    return (f"Q{qid} row {i} col {c}: {x!r} against {y!r}"
                            ": one is an f32 value, the other not")
            elif x != y:
                return f"Q{qid} row {i} col {c}: {x} against {y}"
    return ""


def f32_differences(qid: int, mine: list, theirs: list,
                    n_lineitem: int) -> dict:
    """{column: [largest relative difference, its bound]} of the float
    columns of two runs' rows (the bound f32_tolerance's, None where the
    column must be exact)."""
    out: dict = {}
    for a, b in zip(mine, theirs):
        for c, (x, y) in enumerate(zip(a, b)):
            if isinstance(x, float) and isinstance(y, float) and x != y:
                d = abs(x - y) / max(abs(x), abs(y))
                prev = out.get(c, [0.0, None])[0]
                out[c] = [max(prev, d), f32_tolerance(qid, c, n_lineitem)]
    return out


def model_difference(mine: str, theirs: str) -> float:
    """The largest weight or bias difference of two model blobs, relative
    to the larger magnitude of the reference blob's weights."""
    a, b = json.loads(mine), json.loads(theirs)
    worst = 0.0
    for key in ("w", "b"):
        x = np.asarray(a[key], np.float64)
        y = np.asarray(b[key], np.float64)
        scale = max(float(np.abs(y).max(initial=0.0)), 1e-300)
        worst = max(worst, float(np.abs(x - y).max(initial=0.0)) / scale)
    return worst


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------

LONG = 96  # strings and blobs longer than this compare by their SHA-256


def value(v):
    """One result value in comparable, JSON-able form: bytes as
    "x:<hex>" or, when long, "sha256:<hex>"; a long string by its
    SHA-256; a tuple or an array as a list."""
    if isinstance(v, bytes):
        return "x:" + v.hex() if len(v) <= LONG \
            else "sha256:" + hashlib.sha256(v).hexdigest()
    if isinstance(v, str) and len(v) > LONG:
        return "sha256:" + hashlib.sha256(v.encode()).hexdigest()
    if isinstance(v, (tuple, list)):
        return [value(e) for e in v]
    if isinstance(v, np.ndarray):
        return [value(e) for e in v.tolist()]
    return v


def record(session, sql: str, keys) -> dict:
    """One query run: its rows (or its error's type and first line), the
    column types, execution mode, counters (`keys`) and memo entry; the
    model blobs of M1 whole, under "blobs"."""
    try:
        res = session.sql(sql)
    except Exception as e:  # noqa: BLE001 - an error is a result here
        return {"error": [type(e).__name__, str(e).split("\n")[0]],
                "rows": None, "types": None, "mode": None,
                "counters": None, "memo": memo_state(session, sql)}
    out = {"error": None, "rows": [[value(v) for v in r] for r in res.rows],
           "types": [str(t) for _n, t in res.columns],
           "mode": res.stats.execution_mode,
           "counters": [int(getattr(res.stats, k, 0)) for k in keys],
           "memo": memo_state(session, sql)}
    if sql == M1:
        out["blobs"] = [bytes(b).decode() for b in res.rows[0]]
    return out


def _close(a, b, rtol: float) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if a != a and b != b:
            return True
        return abs(a - b) <= rtol * max(abs(a), abs(b))
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_close(x, y, rtol)
                                        for x, y in zip(a, b))
    return a == b


def model_weights_differ(mine: str, theirs: str, rtol: float) -> str:
    """'' when two model blobs (JSON text) are of one kind and classes,
    with every weight and bias within rtol of the larger magnitude of
    its blob's weights (training's host BLAS may round otherwise on
    another machine); else the difference."""
    a, b = json.loads(mine), json.loads(theirs)
    if a["kind"] != b["kind"] or a["classes"] != b["classes"]:
        return f"model {a['kind']} {a['classes']} against " \
               f"{b['kind']} {b['classes']}"
    for key in ("w", "b"):
        x = np.asarray(a[key], np.float64)
        y = np.asarray(b[key], np.float64)
        scale = max(float(np.abs(y).max(initial=0.0)), 1e-300)
        if x.shape != y.shape or float(np.abs(x - y).max(initial=0.0)) \
                > rtol * scale:
            return f"model {a['kind']} {key}: {x.tolist()} against " \
                   f"{y.tolist()}"
    return ""


def mismatch(sid: str, mine: dict, theirs: dict, rtol: float = 1e-9,
             with_stats: bool = True, model_rtol: Optional[float] = None
             ) -> str:
    """'' when a record equals presto_tpu's: the same error (a
    StaticFallback by type alone), or the same rows (floats within rtol)
    and types, and with `with_stats` the execution mode, counters and
    memo entry.  With model_rtol, M1's blobs compare by their weights
    (model_weights_differ) instead of byte for byte."""
    ea, eb = mine["error"], theirs["error"]
    if ea != eb and not (ea and eb and ea[0] == eb[0] == "StaticFallback"):
        return f"{sid}: error {ea} against {eb}"
    if mine.get("types") != theirs.get("types"):
        return f"{sid}: types {mine.get('types')} against " \
               f"{theirs.get('types')}"
    if with_stats:
        for k in ("mode", "counters", "memo"):
            if k in theirs and mine.get(k) != theirs[k]:
                return f"{sid}: {k} {mine.get(k)} against {theirs[k]}"
    if theirs.get("blobs") is not None and theirs["error"] is None \
            and model_rtol is not None:
        for x, y in zip(mine["blobs"], theirs["blobs"]):
            miss = model_weights_differ(x, y, model_rtol)
            if miss:
                return f"{sid}: {miss}"
        return ""
    a, b = mine["rows"], theirs["rows"]
    if a is None or b is None:
        return "" if a is b else f"{sid}: rows {a} against {b}"
    if len(a) != len(b):
        return f"{sid}: {len(a)} rows against {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        if not _close(list(x), list(y), rtol):
            return f"{sid} row {i}: {x} against {y}"
    return ""


def brute_force_contains(xy, boxes, polygons, chunk: int, torch_mod,
                         device) -> int:
    """G1's count by brute force, independent of the SpatialJoin path:
    each square's points by its box (chunks of `chunk` points against
    every box), each polygon's by an even-odd crossing count over all its
    rings' edges on the points in its bounding box.  xy: [n, 2] float64
    host points (NaN rows match nothing)."""
    torch = torch_mod
    pts = torch.as_tensor(xy, dtype=torch.float64, device=device)
    b = torch.as_tensor(boxes, dtype=torch.float64, device=device)
    total = 0
    for i in range(0, pts.shape[0], chunk):
        p = pts[i:i + chunk]
        px, py = p[:, 0:1], p[:, 1:2]
        hit = (px >= b[:, 0]) & (px <= b[:, 2]) & (py >= b[:, 1]) \
            & (py <= b[:, 3])
        total += int(hit.sum())
    for wkt in polygons:
        body = wkt[len("POLYGON ("):-1]
        rings = [[tuple(float(c) for c in q.split()) for q in
                  r.strip("()").split(", ")]
                 for r in body.split("), (")]
        outer = np.asarray(rings[0])
        lo, hi = outer.min(0), outer.max(0)
        near = (pts[:, 0] >= lo[0]) & (pts[:, 0] <= hi[0]) \
            & (pts[:, 1] >= lo[1]) & (pts[:, 1] <= hi[1])
        p = pts[near]
        parity = torch.zeros(p.shape[0], dtype=torch.int64, device=device)
        for ring in rings:
            e = torch.as_tensor(
                np.asarray([(*ring[k], *ring[(k + 1) % len(ring)])
                            for k in range(len(ring))]),
                dtype=torch.float64, device=device)
            y = p[:, 1:2]
            crosses = (e[:, 1] > y) != (e[:, 3] > y)
            xint = (e[:, 2] - e[:, 0]) * (y - e[:, 1]) \
                / torch.where(e[:, 3] == e[:, 1], 1e-300, e[:, 3] - e[:, 1]) \
                + e[:, 0]
            parity += (crosses & (p[:, 0:1] < xint)).sum(1)
        total += int((parity % 2 == 1).sum())
    return total

