"""Geospatial functions (planar): the presto-geospatial core.

Reference: presto_tpu/functions/geospatial.py (after presto-geospatial's
GeoFunctions: ST_Point, ST_GeometryFromText, ST_Contains, ST_Distance,
ST_Area, ST_X/Y, ...).  A POINT column lives on the device as an (n, 2)
float64 tensor (the POINTS type) and containment and distance against a
constant geometry run as elementwise torch math over it: a ray cast or a
segment distance per edge of the geometry, each edge's coordinates
Python floats, so that nothing is uploaded and a compiled query
captures the predicate without a host sync.  Other geometries (POLYGON,
LINESTRING, MULTIPOINT) are WKT-parsed host tuples behind the dictionary
encoding, as ARRAY values are.

Every division of a tensor by a host number goes through
decimals.true_div, so the card divides as XLA does (torch multiplies by
the reciprocal there, one ulp off at times, which can move a boundary
point in or out of a polygon).

Spatial joins are extracted into the plan node SpatialJoin
(plan/optimizer._extract_spatial_joins) and run in
exec/executor.Executor._exec_spatialjoin through grid_contains_join and
grid_distance_join below: candidate pairs from a uniform grid on the
host, the exact predicate on the session's device.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from presto_tpu_torch import session_ctx
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import upload
from presto_tpu_torch.exec.colval import ColVal, all_valid, refuse_host_read
from presto_tpu_torch.functions.decimals import true_div
from presto_tpu_torch.functions.scalar import (_is_tensor, _lookup,
                                               _normalize_strings,
                                               _str_transform,
                                               _tuple_dict_normalize,
                                               register)

GEOMETRY = T.Type("GEOMETRY")  # dictionary-encoded parsed geometry
POINTS = T.Type("GEOMETRY", ("point",))  # device (n, 2) f64 columns
T._PHYSICAL.setdefault("GEOMETRY", np.int32)


# ---------------------------------------------------------------------------
# WKT parse/format (host; geometries are few and dictionary-encoded)
# ---------------------------------------------------------------------------


def parse_wkt(text: str):
    """WKT -> ('point', (x, y)) | ('linestring', ((x,y),...)) |
    ('polygon', (ring, ...)) | ('multipoint', ((x,y),...))."""
    s = text.strip()
    m = re.match(r"(?i)^(point|linestring|polygon|multipoint)\s*", s)
    if not m:
        raise ValueError(f"unsupported WKT: {text[:40]}")
    kind = m.group(1).lower()
    body = s[m.end():].strip()
    if body.upper() == "EMPTY":
        return (kind, ())

    def coords(seg: str):
        out = []
        for pair in seg.split(","):
            xy = pair.split()
            out.append((float(xy[0]), float(xy[1])))
        return tuple(out)

    inner = body.strip()
    assert inner.startswith("(") and inner.endswith(")")
    inner = inner[1:-1]
    if kind == "point":
        return ("point", coords(inner)[0])
    if kind in ("linestring", "multipoint"):
        inner = inner.replace("(", "").replace(")", "")
        return (kind, coords(inner))
    rings = re.findall(r"\(([^()]*)\)", inner)
    return ("polygon", tuple(coords(r) for r in rings))


def to_wkt(g) -> str:
    kind, data = g
    if not data:
        return f"{kind.upper()} EMPTY"
    if kind == "point":
        return f"POINT ({_num(data[0])} {_num(data[1])})"
    if kind in ("linestring", "multipoint"):
        return (kind.upper() + " ("
                + ", ".join(f"{_num(x)} {_num(y)}" for x, y in data) + ")")
    return ("POLYGON ("
            + ", ".join("(" + ", ".join(f"{_num(x)} {_num(y)}"
                                        for x, y in ring) + ")"
                        for ring in data) + ")")


def _num(v: float) -> str:
    return f"{int(v)}" if float(v).is_integer() else f"{v}"


# ---------------------------------------------------------------------------
# device predicates: a constant geometry (host floats) against point
# tensors px, py
# ---------------------------------------------------------------------------


def _ring_contains(ring, px, py):
    """Ray casting over one ring's edges: ring = host tuple of (x, y);
    px/py float64 tensors.  Boundary-inclusive within float tolerance."""
    n = len(ring)
    inside = torch.zeros(px.shape, dtype=torch.bool, device=px.device)
    for i in range(n):
        x1, y1 = ring[i]
        x2, y2 = ring[(i + 1) % n]
        crosses = (py < y1) != (py < y2)  # (y1 > py) != (y2 > py)
        xint = true_div((x2 - x1) * (py - y1), (y2 - y1) or 1e-300) + x1
        inside = inside ^ (crosses & (px < xint))
    return inside


def _seg_distance(ax, ay, bx, by, px, py):
    """Distance from point tensors to the host segment AB."""
    dx, dy = bx - ax, by - ay
    L2 = dx * dx + dy * dy
    t = true_div((px - ax) * dx + (py - ay) * dy, L2 or 1e-300) \
        .clamp(0.0, 1.0)
    cx, cy = ax + t * dx, ay + t * dy
    ex, ey = px - cx, py - cy
    return torch.sqrt(ex * ex + ey * ey)


def _point_distance(x, y, px, py):
    ex, ey = px - x, py - y
    return torch.sqrt(ex * ex + ey * ey)


def _poly_contains_points(g, px, py):
    kind, data = g
    if kind == "polygon":
        if not data:
            return torch.zeros(px.shape, dtype=torch.bool, device=px.device)
        inside = _ring_contains(data[0], px, py)
        for hole in data[1:]:
            inside = inside & ~_ring_contains(hole, px, py)
        return inside
    if kind == "point":
        return (px == data[0]) & (py == data[1])
    if kind == "multipoint":
        hit = torch.zeros(px.shape, dtype=torch.bool, device=px.device)
        for x, y in data:
            hit = hit | ((px == x) & (py == y))
        return hit
    raise NotImplementedError(f"ST_Contains over {kind}")


def _geom_distance_points(g, px, py):
    kind, data = g
    if kind == "point":
        return _point_distance(data[0], data[1], px, py)
    if kind == "multipoint":
        d = None
        for x, y in data:
            dd = _point_distance(x, y, px, py)
            d = dd if d is None else torch.minimum(d, dd)
        return d
    d = None
    for (ax, ay), (bx, by) in _geom_segments(g):
        # hole boundaries count too: a point in a hole is OUTSIDE, and
        # its nearest boundary may be the hole's ring
        dd = _seg_distance(ax, ay, bx, by, px, py)
        d = dd if d is None else torch.minimum(d, dd)
    if kind == "polygon":  # interior points are at distance 0
        d = torch.where(_poly_contains_points(g, px, py), 0.0, d)
    return d


def _host_points(pts):
    """(px, py) float64 tensors on the CPU for host coordinates: the
    predicates between two constant geometries run there.  The
    reference stages these arrays in its static trace and reads the
    predicate back, which falls back to the dynamic executor; the port's
    static pass refuses here likewise, so both pick the same mode."""
    refuse_host_read("a predicate between two constant geometries")
    a = torch.tensor([[float(q[0]), float(q[1])] for q in pts],
                     dtype=torch.float64).reshape(-1, 2)
    return a[:, 0], a[:, 1]


# ---------------------------------------------------------------------------
# host geometry
# ---------------------------------------------------------------------------


def _geom_segments(g):
    """Host segment list of a geometry's boundary (all rings)."""
    kind, data = g
    if kind == "linestring":
        return list(zip(data[:-1], data[1:]))
    if kind == "polygon":
        out = []
        for ring in data:
            out += [(ring[i], ring[(i + 1) % len(ring)])
                    for i in range(len(ring))]
        return out
    return []


def _segments_intersect(s1, s2) -> bool:
    """Proper/improper 2D segment intersection (orientation tests)."""
    (ax, ay), (bx, by) = s1
    (cx, cy), (dx, dy) = s2

    def orient(px, py, qx, qy, rx, ry):
        v = (qx - px) * (ry - py) - (qy - py) * (rx - px)
        return 0 if abs(v) < 1e-12 else (1 if v > 0 else -1)

    o1 = orient(ax, ay, bx, by, cx, cy)
    o2 = orient(ax, ay, bx, by, dx, dy)
    o3 = orient(cx, cy, dx, dy, ax, ay)
    o4 = orient(cx, cy, dx, dy, bx, by)
    if o1 != o2 and o3 != o4:
        return True

    def on(px, py, qx, qy, rx, ry):  # r collinear-on pq
        return (min(px, qx) - 1e-12 <= rx <= max(px, qx) + 1e-12
                and min(py, qy) - 1e-12 <= ry <= max(py, qy) + 1e-12)

    if o1 == 0 and on(ax, ay, bx, by, cx, cy):
        return True
    if o2 == 0 and on(ax, ay, bx, by, dx, dy):
        return True
    if o3 == 0 and on(cx, cy, dx, dy, ax, ay):
        return True
    return o4 == 0 and on(cx, cy, dx, dy, bx, by)


def _boundaries_cross(ga, gb) -> bool:
    return any(_segments_intersect(s1, s2)
               for s1 in _geom_segments(ga) for s2 in _geom_segments(gb))


def _shoelace(ring) -> float:
    s = 0.0
    n = len(ring)
    for i in range(n):
        x1, y1 = ring[i]
        x2, y2 = ring[(i + 1) % n]
        s += x1 * y2 - x2 * y1
    return abs(s) / 2.0


def _bbox(g):
    kind, data = g
    pts = [data] if kind == "point" else \
        (data[0] if kind == "polygon" else data)
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    return min(xs), min(ys), max(xs), max(ys)


def _area(g) -> float:
    if g[0] != "polygon" or not g[1]:
        return 0.0
    a = _shoelace(g[1][0])
    for hole in g[1][1:]:
        a -= _shoelace(hole)
    return a


def _envelope(g):
    x0, y0, x1, y1 = _bbox(g)
    return ("polygon", (((x0, y0), (x1, y0), (x1, y1), (x0, y1),
                         (x0, y0)),))


def _centroid(g):
    kind, data = g
    if kind == "point":
        return ("point", data)
    if kind == "multipoint":
        return ("point", (float(np.mean([p[0] for p in data])),
                          float(np.mean([p[1] for p in data]))))
    if kind == "linestring":
        # length-weighted segment midpoints (GeoFunctions semantics)
        tx = ty = tl = 0.0
        for (x1, y1), (x2, y2) in zip(data[:-1], data[1:]):
            ln = math.dist((x1, y1), (x2, y2))
            tx += (x1 + x2) / 2 * ln
            ty += (y1 + y2) / 2 * ln
            tl += ln
        if tl == 0:
            return ("point", data[0])
        return ("point", (tx / tl, ty / tl))
    # polygon: signed-area-weighted centroid over rings (holes subtract)
    ax = ay = asum = 0.0
    for ri, ring in enumerate(data):
        sx = sy = s = 0.0
        for i in range(len(ring)):
            x1, y1 = ring[i]
            x2, y2 = ring[(i + 1) % len(ring)]
            cross = x1 * y2 - x2 * y1
            sx += (x1 + x2) * cross
            sy += (y1 + y2) * cross
            s += cross
        sign = 1.0 if ri == 0 else -1.0
        ax += sign * abs(s) * (sx / (3.0 * s) if s else 0.0)
        ay += sign * abs(s) * (sy / (3.0 * s) if s else 0.0)
        asum += sign * abs(s)
    if asum == 0:
        return ("point", data[0][0])
    return ("point", (ax / asum, ay / asum))


def _npoints(g) -> int:
    if g[0] == "polygon":
        return sum(len(r) for r in g[1])
    return 1 if g[0] == "point" else len(g[1])


def _length(g) -> float:
    if g[0] != "linestring":
        return 0.0
    return float(sum(math.dist(a, b) for a, b in zip(g[1][:-1], g[1][1:])))


# ---------------------------------------------------------------------------
# value plumbing
# ---------------------------------------------------------------------------


def _is_scalar(v: ColVal) -> bool:
    return not _is_tensor(v.data) or v.data.ndim == 0


def _geom_of(v: ColVal):
    """Host geometry for a scalar/literal geometry ColVal, else None."""
    if v.type.is_string:
        if _is_scalar(v) and isinstance(v.data, str):
            return parse_wkt(v.data)
    if v.type.name == "GEOMETRY" and v.dictionary is not None \
            and _is_scalar(v):
        code = v.data
        if _is_tensor(code):
            refuse_host_read("a computed geometry code")
            code = code.item()
        return v.dictionary.values[int(code)]
    if v.type.name == "GEOMETRY" and isinstance(v.data, tuple):
        return v.data
    if v.type == POINTS and _is_tensor(v.data) and v.data.ndim == 1:
        # a scalar ST_Point(x, y): one pair on the device, read back to
        # route through the host-geometry paths (the reference's static
        # trace cannot read it and falls back)
        refuse_host_read("a scalar ST_Point")
        xy = v.data.cpu()
        return ("point", (float(xy[0]), float(xy[1])))
    return None


def _points_of(v: ColVal):
    """(px, py) tensors for a POINTS column, else None."""
    if v.type == POINTS and _is_tensor(v.data) and v.data.ndim == 2:
        return v.data[:, 0], v.data[:, 1]
    return None


def _geoms_apply(col: ColVal, fn, out_type: T.Type) -> ColVal:
    """Host map over a dictionary-encoded GEOMETRY column."""
    vals = [fn(g) for g in col.dictionary.values]
    if out_type.name == "GEOMETRY" or out_type.is_string:
        out = np.empty(len(vals), dtype=object)
        out[:] = vals
        return _tuple_dict_normalize(out, ColVal(col.data, col.valid,
                                                 out_type), out_type)
    return ColVal(_lookup(col.data, np.asarray(
        vals, dtype=out_type.numpy_dtype())), col.valid, out_type)


def _f64_arg(a: ColVal):
    d = a.data
    if _is_tensor(d):
        return d.to(torch.float64)
    return float(d)


def _emit_point(args) -> ColVal:
    x, y = (_f64_arg(a) for a in args)
    dev = next((v.device for v in (x, y) if _is_tensor(v)),
               session_ctx.device())
    x, y = (v if _is_tensor(v) else torch.full(
        (), v, dtype=torch.float64, device=dev) for v in (x, y))
    x, y = torch.broadcast_tensors(x, y)
    return ColVal(torch.stack([x, y], dim=-1), all_valid(*args), POINTS)


def _emit_astext(args) -> ColVal:
    v = args[0]
    g0 = _geom_of(v)
    if g0 is not None:  # scalar point / literal geometry
        return ColVal(to_wkt(g0), v.valid, T.VARCHAR)
    if v.type == POINTS:
        # device points render on the host: the dynamic executor alone
        refuse_host_read("ST_AsText of a point column")
        pts = v.data.cpu().numpy()
        vals = [to_wkt(("point", (float(x), float(y)))) for x, y in pts]
        codes = torch.arange(len(pts), dtype=torch.int32,
                             device=v.data.device)
        return _normalize_strings(vals, ColVal(codes, v.valid, T.VARCHAR))
    return _geoms_apply(v, to_wkt, T.VARCHAR)


def _xy_emit(idx):
    def emit(args):
        v = args[0]
        p = _points_of(v)
        if p is not None:
            return ColVal(p[idx], v.valid, T.DOUBLE)
        g = _geom_of(v)
        if g is not None and g[0] == "point":
            return ColVal(float(g[1][idx]), v.valid, T.DOUBLE)
        return _geoms_apply(
            v, lambda g2: float(g2[1][idx])
            if g2[0] == "point" else float("nan"), T.DOUBLE)

    return emit


def _resolve_geom_pair(out):
    def resolve(args):
        if len(args) == 2 and all(
                a.name == "GEOMETRY" or a.is_string for a in args):
            return out
        return None

    return resolve


def _emit_contains(args) -> ColVal:
    g = _geom_of(args[0])
    p = _points_of(args[1])
    if g is not None and p is not None:
        # the device path: a constant geometry, a point column
        return ColVal(_poly_contains_points(g, *p), all_valid(*args),
                      T.BOOLEAN)
    g2 = _geom_of(args[1])
    if g is not None and g2 is not None:
        if g2[0] == "point":
            hit = _poly_contains_points(g, *_host_points([g2[1]]))
            return ColVal(bool(hit[0]), all_valid(*args), T.BOOLEAN)
        if g2[0] in ("multipoint", "linestring", "polygon"):
            pts = g2[1] if g2[0] != "polygon" else g2[1][0]
            inside = bool(_poly_contains_points(g, *_host_points(pts))
                          .all())
            # vertex containment alone is wrong for non-convex
            # containers: the contained shape must also never cross the
            # container's boundary
            ok = inside and not _boundaries_cross(g, g2)
            return ColVal(ok, all_valid(*args), T.BOOLEAN)
    raise NotImplementedError(
        "ST_Contains needs a constant geometry on the left")


def _emit_distance(args) -> ColVal:
    a, b = args
    pa, pb = _points_of(a), _points_of(b)
    if pa is not None and pb is not None:
        return ColVal(_point_distance(pb[0], pb[1], pa[0], pa[1]),
                      all_valid(a, b), T.DOUBLE)
    for pts, other in ((pa, b), (pb, a)):
        if pts is not None:
            g = _geom_of(other)
            if g is None:
                break
            return ColVal(_geom_distance_points(g, *pts), all_valid(a, b),
                          T.DOUBLE)
    ga, gb = _geom_of(a), _geom_of(b)
    if ga is not None and gb is not None and gb[0] == "point":
        d = _geom_distance_points(ga, *_host_points([gb[1]]))
        return ColVal(float(d[0]), all_valid(a, b), T.DOUBLE)
    if ga is not None and gb is not None and ga[0] == "point":
        return _emit_distance([b, a])
    raise NotImplementedError("ST_Distance geometry pair")


def _emit_intersects(args) -> ColVal:
    # bbox prefilter, then containment or boundary crossing for the
    # supported kinds (reference: ST_Intersects via Esri relate)
    g = _geom_of(args[0])
    p = _points_of(args[1])
    if g is not None and p is not None:
        return _emit_contains(args)
    ga, gb = _geom_of(args[0]), _geom_of(args[1])
    if ga is not None and gb is not None:
        ax0, ay0, ax1, ay1 = _bbox(ga)
        bx0, by0, bx1, by1 = _bbox(gb)
        if ax1 < bx0 or bx1 < ax0 or ay1 < by0 or by1 < ay0:
            return ColVal(False, all_valid(*args), T.BOOLEAN)
        if gb[0] == "point":
            return _emit_contains(args)
        if ga[0] == "point":
            return _emit_contains([args[1], args[0]])
        # polygon/linestring pair: boundaries crossing, or one shape's
        # vertex inside the other (containment without crossing)
        hit = _boundaries_cross(ga, gb)
        if not hit and ga[0] == "polygon":
            pts = gb[1] if gb[0] != "polygon" else gb[1][0]
            hit = bool(_poly_contains_points(ga, *_host_points(pts)).any())
        if not hit and gb[0] == "polygon":
            qts = ga[1] if ga[0] != "polygon" else ga[1][0]
            hit = bool(_poly_contains_points(gb, *_host_points(qts)).any())
        return ColVal(hit, all_valid(*args), T.BOOLEAN)
    raise NotImplementedError("ST_Intersects geometry pair")


def _geom1(fn, out_type: T.Type):
    def emit(args):
        g = _geom_of(args[0])
        if g is not None:
            return ColVal(fn(g), args[0].valid,
                          GEOMETRY if out_type.name == "GEOMETRY"
                          else out_type)
        return _geoms_apply(args[0], fn, out_type)

    return (lambda args: out_type if len(args) == 1
            and args[0].name == "GEOMETRY" else None), emit


# ---------------------------------------------------------------------------
# registrations (the reference's order)
# ---------------------------------------------------------------------------

register("st_point",
         lambda args: POINTS if len(args) == 2
         and all(a.is_numeric for a in args) else None,
         _emit_point)
register("st_geometryfromtext",
         *_str_transform("st_geometryfromtext", parse_wkt, GEOMETRY))
register("st_astext",
         lambda args: T.VARCHAR if len(args) == 1
         and args[0].name == "GEOMETRY" else None,
         _emit_astext)
register("st_x", lambda args: T.DOUBLE if args
         and args[0].name == "GEOMETRY" else None, _xy_emit(0))
register("st_y", lambda args: T.DOUBLE if args
         and args[0].name == "GEOMETRY" else None, _xy_emit(1))
register("st_contains", _resolve_geom_pair(T.BOOLEAN), _emit_contains)
register("st_within", _resolve_geom_pair(T.BOOLEAN),
         lambda args: _emit_contains([args[1], args[0]]))
register("st_distance", _resolve_geom_pair(T.DOUBLE), _emit_distance)
register("st_intersects", _resolve_geom_pair(T.BOOLEAN), _emit_intersects)
register("st_area", *_geom1(_area, T.DOUBLE))
register("st_envelope", *_geom1(_envelope, GEOMETRY))
register("st_centroid", *_geom1(_centroid, GEOMETRY))
register("st_npoints", *_geom1(_npoints, T.BIGINT))
register("st_length", *_geom1(_length, T.DOUBLE))


# ---------------------------------------------------------------------------
# the grid-indexed spatial join (reference: SpatialJoinOperator +
# PagesRTreeIndex): a uniform grid replaces the R-tree; candidate pairs
# come from vectorized numpy over (cell, build) pairs, and the exact
# predicate runs on the session's device over padded edge arrays.
# ---------------------------------------------------------------------------


def _geom_rings(g):
    """All rings of a polygon as coordinate tuples (even-odd ray parity
    over every ring handles holes)."""
    kind, data = g
    if kind == "polygon":
        return [tuple(r) for r in data]
    raise NotImplementedError(f"spatial join build over {kind}")


def grid_contains_join(px, py, geoms, device=None):
    """Point-in-polygon join.  px/py: host float64 arrays (n probes);
    geoms: parsed polygons (the build side).  Returns (lidx, ridx) numpy
    index arrays of the matching pairs."""
    n = len(px)
    m = len(geoms)
    if n == 0 or m == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    boxes = np.empty((m, 4), np.float64)
    edge_lists = []
    for j, g in enumerate(geoms):
        rings = _geom_rings(g)
        pts = [p for r in rings for p in r]
        if not pts:  # POLYGON EMPTY: contains nothing
            boxes[j] = (np.inf, np.inf, -np.inf, -np.inf)
            edge_lists.append([])
            continue
        xs = np.asarray([p[0] for p in pts])
        ys = np.asarray([p[1] for p in pts])
        boxes[j] = (xs.min(), ys.min(), xs.max(), ys.max())
        segs = []
        for r in rings:
            k = len(r)
            for i in range(k):
                x1, y1 = r[i]
                x2, y2 = r[(i + 1) % k]
                segs.append((x1, y1, x2, y2))
        edge_lists.append(segs)

    lidx, ridx = _grid_candidates(px, py, boxes)
    if len(lidx) == 0:
        return lidx, ridx
    # the exact even-odd ray cast, bucketed by edge count (power-of-two
    # classes) so that one many-sided polygon does not pad every pair
    nedges = np.asarray([len(s) for s in edge_lists], np.int64)
    pair_edges = nedges[ridx]
    classes = np.maximum(
        1 << np.ceil(np.log2(np.maximum(pair_edges, 1))).astype(np.int64),
        4)
    out_l, out_r = [], []
    for cls in np.unique(classes):
        sel = np.flatnonzero(classes == cls)
        sl, sr = lidx[sel], ridx[sel]
        uniq_g, inv_g = np.unique(sr, return_inverse=True)
        E = np.full((len(uniq_g), int(cls), 4), np.nan)  # NaN never crosses
        for gi, j in enumerate(uniq_g):
            segs = edge_lists[j]
            if segs:
                E[gi, :len(segs)] = segs
        hit = _raycast_pairs(px[sl], py[sl], E, inv_g, device)
        out_l.append(sl[hit])
        out_r.append(sr[hit])
    return np.concatenate(out_l), np.concatenate(out_r)


def _raycast_pairs(cx, cy, E, gsel, device=None):
    """Even-odd ray parity for candidate pairs on `device` (the
    session's): cx/cy host points (C,), E (G, emax, 4) padded edges,
    gsel (C,) the geometry of each pair.  Returns a host bool array."""
    dev = device if device is not None else session_ctx.device()
    Et = upload(np.ascontiguousarray(E), dev)
    g = upload(np.asarray(gsel, np.int64), dev)
    ex1, ey1, ex2, ey2 = (Et[:, :, i][g] for i in range(4))
    pcx = upload(np.asarray(cx, np.float64), dev)[:, None]
    pcy = upload(np.asarray(cy, np.float64), dev)[:, None]
    crosses = (pcy < ey1) != (pcy < ey2)  # (ey1 > pcy) != (ey2 > pcy)
    denom = torch.where(ey2 == ey1, 1e-300, ey2 - ey1)
    xint = torch.div((ex2 - ex1) * (pcy - ey1), denom) + ex1
    parity = (crosses & (pcx < xint)).sum(dim=1) % 2 == 1
    return parity.cpu().numpy()


def grid_distance_join(px, py, bx, by, radius, strict=False, device=None):
    """Point-to-point distance join: |p - b| </<= radius.  Candidates
    from radius-sized cells on the host, exact distances on `device`
    (the session's)."""
    n, m = len(px), len(bx)
    if n == 0 or m == 0 or radius < 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    boxes = np.stack([bx - radius, by - radius,
                      bx + radius, by + radius], axis=1)
    lidx, ridx = _grid_candidates(px, py, boxes)
    if len(lidx) == 0:
        return lidx, ridx
    dev = device if device is not None else session_ctx.device()
    li = upload(lidx, dev)
    ri = upload(ridx, dev)
    ex = upload(np.asarray(px, np.float64), dev)[li] \
        - upload(np.asarray(bx, np.float64), dev)[ri]
    ey = upload(np.asarray(py, np.float64), dev)[li] \
        - upload(np.asarray(by, np.float64), dev)[ri]
    d2 = ex * ex + ey * ey
    r2 = float(radius) * float(radius)
    hit = (d2 < r2 if strict else d2 <= r2).cpu().numpy()
    return lidx[hit], ridx[hit]


def _grid_candidates(px, py, boxes):
    """(probe, build) candidate pairs whose probe point falls in the
    build bbox, through a uniform grid sized to the p95 bbox dimension:
    the (cell, build) relation is sorted once and probed with
    searchsorted.  Returns indices into the ORIGINAL boxes array."""
    # drop empty bboxes up front: they match nothing, and inf
    # coordinates would poison the cell arithmetic
    ok = np.isfinite(boxes).all(axis=1) & (boxes[:, 0] <= boxes[:, 2])
    build_map = np.flatnonzero(ok)
    boxes = boxes[ok]
    m = len(boxes)
    empty = (np.empty(0, np.int64), np.empty(0, np.int64))
    if m == 0 or len(px) == 0:
        return empty
    w = boxes[:, 2] - boxes[:, 0]
    h = boxes[:, 3] - boxes[:, 1]
    # p95 sizing bounds the skew of a few outsized bboxes; those still
    # spanning too many cells join brute-force below (the grid's analog
    # of an R-tree's root-level entry)
    cs = max(float(np.percentile(w, 95)), float(np.percentile(h, 95)),
             1e-9)
    x0 = float(min(boxes[:, 0].min(), px.min()))
    y0 = float(min(boxes[:, 1].min(), py.min()))
    jx0 = np.floor((boxes[:, 0] - x0) / cs).astype(np.int64)
    jy0 = np.floor((boxes[:, 1] - y0) / cs).astype(np.int64)
    jx1 = np.floor((boxes[:, 2] - x0) / cs).astype(np.int64)
    jy1 = np.floor((boxes[:, 3] - y0) / cs).astype(np.int64)
    ncx = int(jx1.max()) + 2
    spans = (jx1 - jx0 + 1) * (jy1 - jy0 + 1)
    small = np.flatnonzero(spans <= 256)
    big = np.flatnonzero(spans > 256)

    parts_l, parts_r = [], []
    if len(small):
        sx = jx1[small] - jx0[small] + 1
        sp = spans[small]
        total_cells = int(sp.sum())
        builds = np.repeat(small, sp)
        off0 = np.concatenate([[0], np.cumsum(sp)[:-1]])
        k = np.arange(total_cells, dtype=np.int64) - np.repeat(off0, sp)
        rsx = np.repeat(sx, sp)
        cells = ((np.repeat(jy0[small], sp) + k // rsx) * ncx
                 + np.repeat(jx0[small], sp) + k % rsx)
        order = np.argsort(cells, kind="stable")
        cells, builds = cells[order], builds[order]
        pgx = np.floor((px - x0) / cs).astype(np.int64)
        pgy = np.floor((py - y0) / cs).astype(np.int64)
        pcell = pgy * ncx + pgx
        lo = np.searchsorted(cells, pcell, side="left")
        counts = np.searchsorted(cells, pcell, side="right") - lo
        total = int(counts.sum())
        if total:
            lidx = np.repeat(np.arange(len(px), dtype=np.int64), counts)
            offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
            flat = np.arange(total, dtype=np.int64) \
                - np.repeat(offsets, counts) + np.repeat(lo, counts)
            parts_l.append(lidx)
            parts_r.append(builds[flat])
    for j in big:  # rare skew outliers: a bbox test against every probe
        inbox = np.flatnonzero(
            (px >= boxes[j, 0]) & (px <= boxes[j, 2])
            & (py >= boxes[j, 1]) & (py <= boxes[j, 3]))
        parts_l.append(inbox)
        parts_r.append(np.full(len(inbox), j, np.int64))
    if not parts_l:
        return empty
    lidx = np.concatenate(parts_l)
    ridx = np.concatenate(parts_r)
    # bbox refinement before the exact predicate
    keep = ((px[lidx] >= boxes[ridx, 0]) & (px[lidx] <= boxes[ridx, 2])
            & (py[lidx] >= boxes[ridx, 1]) & (py[lidx] <= boxes[ridx, 3]))
    return lidx[keep], build_map[ridx[keep]]
