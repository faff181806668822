"""The time-zone and sketch corpus over TPC-H: functions/datetime_tz.py
with tzdb.py, the serializable sketches (functions/sketches.py,
tdigest.py, their readers) and the host aggregates
(exec/host_aggs.py), each query run through `connect(catalog).sql(text)`.
chip_smoke.py runs these at SF1 and the tests at SF0.01, from these
strings.

- Z1: orders grouped by the Kolkata hour of a New York wall clock (a
  TIMESTAMP + INTERVAL resolved in America/New_York, AT TIME ZONE
  Asia/Kolkata): count, sum and avg of o_totalprice (a device
  searchsorted on every order, fused_group_sums on the card);
- Z2: lineitem's ship dates as Lord Howe wall clocks (a half-hour DST
  zone): year, day of week, date_format and timezone_hour keys, the last
  day by date_trunc('day', ...), count, sums (fused_group_sums);
- Z3: lineitem JOIN orders filtered by a Berlin wall clock against a
  UTC instant plus 30 days, by o_orderpriority (block_gather);
- Z4: scalars: zoned and fixed-offset TIMESTAMP literals, at_timezone,
  timezone_hour/minute, CASTs of TIMESTAMP WITH TIME ZONE to VARCHAR,
  DATE and TIME and of strings to it, TIME WITH TIME ZONE, to_unixtime,
  from_unixtime with a zone and with an offset, New York's 2020 DST gap
  (which resolves backwards in both packages, ROADMAP C) and overlap;
  Z4b the fixed offset '+05:45' over a column, which runs as a graph;
- Z5: one session's script: SET SESSION time_zone, current_timezone(),
  a plain TIMESTAMP cast to WITH TIME ZONE and compared with a zoned one
  (coerced through the session zone), over a literal and over a column;
- Z6: now(), current_timestamp, current_date, localtime and
  localtimestamp over nation, held to properties, not values;
- K1: approx_set(o_custkey) per o_orderpriority: its cardinality and
  its blob (hex, compared by SHA-256), the cardinality of the merge of
  the per-group sets, empty_approx_set();
- K2: tdigest_agg of l_quantity and of l_extendedprice weighted by
  l_quantity, per l_returnflag: every reader; at SF1 the weighted
  digest's columns are held to the digest of the generated columns
  (weighted_digest_rows): presto_tpu's SF1 scan gives some prices one
  ulp off, which reorders equal prices and moves its centroids
  (ROADMAP C);
- K3: qdigest_agg(l_discount) per l_linestatus with its readers;
- K4: approx_percentile over an ARRAY of percentiles and with a weight
  per l_returnflag, l_linestatus beside sum(l_quantity)
  (fused_group_sums);
- K5: lineitem JOIN orders by o_orderpriority: min_by / max_by with a
  count, approx_most_frequent (block_gather);
- K6: reduce_agg over o_totalprice and map_union_sum over maps that
  map_agg builds in a subquery.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List

# the records' bookkeeping is the decimal corpus's
from presto_tpu_torch.decimal_queries import (  # noqa: F401
    compact_reference, expand_reference, memo_state)
from presto_tpu_torch.function_ext_queries import mismatch  # noqa: F401

_LH = ("with_timezone(CAST(l_shipdate AS TIMESTAMP), "
       "'Australia/Lord_Howe')")

QUERIES = {
    "Z1": ("SELECT hour(with_timezone(CAST(o_orderdate AS TIMESTAMP) "
           "+ INTERVAL '13' HOUR, 'America/New_York') "
           "AT TIME ZONE 'Asia/Kolkata') h, count(*), sum(o_totalprice), "
           "avg(o_totalprice) FROM orders GROUP BY 1 ORDER BY 1"),
    "Z2": (f"SELECT year(z) y, day_of_week(z) d, date_format(z, '%Y') f, "
           f"timezone_hour(z) tzh, max(date_trunc('day', z)), count(*), "
           f"sum(l_extendedprice), avg(l_discount) "
           f"FROM (SELECT {_LH} z, l_extendedprice, l_discount "
           f"FROM lineitem) t GROUP BY 1, 2, 3, 4 ORDER BY 1, 2, 3, 4"),
    "Z3": ("SELECT o_orderpriority, count(*), sum(l_extendedprice) "
           "FROM lineitem JOIN orders ON l_orderkey = o_orderkey "
           "WHERE with_timezone(CAST(l_shipdate AS TIMESTAMP), "
           "'Europe/Berlin') < TIMESTAMP '1994-01-01 00:00:00 UTC' "
           "+ INTERVAL '30' DAY "
           "GROUP BY o_orderpriority ORDER BY o_orderpriority"),
    "Z4": ("SELECT TIMESTAMP '2020-06-01 12:00:00 Asia/Kathmandu', "
           "TIMESTAMP '2020-06-01 12:00:00 +05:45', "
           "TIMESTAMP '2020-06-01 12:00:00 -03:30', "
           "CAST(at_timezone(TIMESTAMP '2020-06-01 12:00:00 UTC', "
           "'Asia/Kolkata') AS VARCHAR), "
           "timezone_hour(TIMESTAMP '2020-06-01 12:00:00 -03:30'), "
           "timezone_minute(TIMESTAMP '2020-06-01 12:00:00 -03:30'), "
           "timezone_minute(TIMESTAMP '2020-01-01 12:00:00 "
           "Australia/Lord_Howe'), "
           "CAST(TIMESTAMP '2020-06-01 23:30:00 Europe/Berlin' AS DATE), "
           "CAST(TIMESTAMP '2020-06-01 23:30:00 Europe/Berlin' AS TIME), "
           "to_unixtime(CAST('2020-06-01 10:30:00.250 Europe/Berlin' "
           "AS TIMESTAMP WITH TIME ZONE)), "
           "CAST(TIME '10:00:00 +05:30' AS VARCHAR), "
           "CAST(from_unixtime(1591012800, 'Asia/Tokyo') AS VARCHAR), "
           "CAST(from_unixtime(0, -5, 30) AS VARCHAR), "
           "CAST(TIMESTAMP '2020-03-08 02:30:00 America/New_York' "
           "AS VARCHAR), "
           "to_unixtime(TIMESTAMP '2020-11-01 01:30:00 America/New_York'), "
           "CAST(TIMESTAMP '2020-03-08 01:30:00 America/New_York' "
           "+ INTERVAL '1' HOUR AS VARCHAR), "
           "CAST(TIMESTAMP '2020-01-31 12:00:00 America/New_York' "
           "+ INTERVAL '1' MONTH AS VARCHAR)"),
    "Z4b": ("SELECT hour(with_timezone(CAST(o_orderdate AS TIMESTAMP), "
            "'+05:45') AT TIME ZONE 'UTC') h, count(*), sum(o_totalprice) "
            "FROM orders GROUP BY 1 ORDER BY 1"),
    "K1a": ("SELECT o_orderpriority, cardinality(approx_set(o_custkey)), "
            "to_hex(CAST(approx_set(o_custkey) AS VARBINARY)) "
            "FROM orders GROUP BY o_orderpriority ORDER BY o_orderpriority"),
    "K1b": ("SELECT cardinality(merge(h)), cardinality(empty_approx_set()) "
            "FROM (SELECT o_orderpriority, approx_set(o_custkey) h "
            "FROM orders GROUP BY o_orderpriority) t"),
    "K2": ("SELECT l_returnflag, value_at_quantile(d, 0.5), "
           "values_at_quantiles(d, ARRAY[0.1, 0.9]), "
           "quantile_at_value(d, 25), "
           "value_at_quantile(scale_tdigest(d, 2), 0.25), "
           "destructure_tdigest(w), value_at_quantile(w, 0.75) "
           "FROM (SELECT l_returnflag, tdigest_agg(l_quantity) d, "
           "tdigest_agg(l_extendedprice, l_quantity) w "
           "FROM lineitem GROUP BY l_returnflag) t ORDER BY l_returnflag"),
    "K3": ("SELECT l_linestatus, value_at_quantile(q, 0.5), "
           "value_at_quantile(q, 0.99), quantile_at_value(q, 0.05), "
           "cardinality(q), to_hex(CAST(q AS VARBINARY)) "
           "FROM (SELECT l_linestatus, qdigest_agg(l_discount) q "
           "FROM lineitem GROUP BY l_linestatus) t ORDER BY l_linestatus"),
    "K4": ("SELECT l_returnflag, l_linestatus, "
           "approx_percentile(l_quantity, ARRAY[0.1, 0.5, 0.9]), "
           "approx_percentile(l_discount, l_quantity, 0.5), "
           "sum(l_quantity), count(*) FROM lineitem "
           "GROUP BY l_returnflag, l_linestatus "
           "ORDER BY l_returnflag, l_linestatus"),
    "K5": ("SELECT o_orderpriority, min_by(l_orderkey, l_extendedprice, 3), "
           "max_by(l_linenumber, l_orderkey, 2), "
           "approx_most_frequent(3, l_shipmode, 100) "
           "FROM lineitem JOIN orders ON l_orderkey = o_orderkey "
           "GROUP BY o_orderpriority ORDER BY o_orderpriority"),
    "K6": ("SELECT o_orderstatus, "
           "reduce_agg(o_totalprice, 0.0, (s, x) -> s + x, "
           "(a, b) -> a + b), count(*) FROM orders "
           "GROUP BY o_orderstatus ORDER BY o_orderstatus"),
    "K6b": ("SELECT map_union_sum(m) FROM (SELECT o_orderpriority, "
            "map_agg(o_orderstatus, c) m FROM (SELECT o_orderpriority, "
            "o_orderstatus, count(*) c FROM orders "
            "GROUP BY o_orderpriority, o_orderstatus) a "
            "GROUP BY o_orderpriority) b"),
}

#: Z5: one session's statements, in order
SCRIPT = [
    ("Z5a", "SET SESSION time_zone = 'Asia/Tokyo'"),
    ("Z5b", "SELECT current_timezone()"),
    ("Z5c", "SELECT CAST(CAST(TIMESTAMP '2020-06-01 12:00:00' "
            "AS TIMESTAMP WITH TIME ZONE) AS VARCHAR), "
            "TIMESTAMP '2020-06-01 12:00:00' "
            "= TIMESTAMP '2020-06-01 12:00:00 Asia/Tokyo'"),
    ("Z5d", "SELECT count(*), min(o_orderdate) FROM orders "
            "WHERE CAST(o_orderdate AS TIMESTAMP) "
            "< TIMESTAMP '1995-01-01 00:00:00 UTC'"),
]

#: Z6: the session constants, held to properties
VOLATILE = {
    "Z6": ("SELECT n_nationkey, to_unixtime(now()), "
           "to_unixtime(current_timestamp), current_date, localtime, "
           "localtimestamp FROM nation ORDER BY n_nationkey"),
}

#: the queries whose records are presto_tpu's
REFERENCE_IDS = tuple(QUERIES)
#: the queries that must launch each kernel on the card
FUSED_IDS = ("Z1", "Z2", "K4")
GATHER_IDS = ("Z3", "K5")
#: the named zones the corpus reads (chip_smoke.py's `zones` line)
ZONES = ("America/New_York", "Asia/Kolkata", "Australia/Lord_Howe",
         "Europe/Berlin", "Asia/Kathmandu", "Asia/Tokyo")

#: strings and blobs longer than this compare by their SHA-256
LONG = 96

#: K2's columns of the weighted digest: destructure_tdigest(w) and
#: value_at_quantile(w, 0.75)
K2_WEIGHTED_COLUMNS = (5, 6)


def value(v):
    """One result value in comparable, JSON-able form: bytes as
    "x:<hex>", a long string or blob as "sha256:<hex>" of its bytes, a
    collection as a list."""
    if isinstance(v, bytes):
        return "x:" + v.hex() if len(v) <= LONG \
            else "sha256:" + hashlib.sha256(v).hexdigest()
    if isinstance(v, str) and len(v) > LONG:
        return "sha256:" + hashlib.sha256(v.encode()).hexdigest()
    if isinstance(v, tuple):
        return [value(e) for e in v]
    return v


def values(rows) -> List[list]:
    return [[value(v) for v in r] for r in rows]


def record(session, sql: str, keys) -> dict:
    """One query run: its rows (or its error's type and first line), the
    column types, execution mode, seven counters (`keys`) and memo
    entry."""
    try:
        res = session.sql(sql)
    except Exception as e:  # noqa: BLE001 - an error is a result here
        return {"error": [type(e).__name__, str(e).split("\n")[0]],
                "rows": None, "types": None, "mode": None,
                "counters": None, "memo": memo_state(session, sql)}
    return {"error": None, "rows": values(res.rows),
            "types": [str(t) for _n, t in res.columns],
            "mode": res.stats.execution_mode,
            "counters": [int(getattr(res.stats, k, 0)) for k in keys],
            "memo": memo_state(session, sql)}


def run_script(session, keys) -> Dict[str, dict]:
    """SCRIPT in `session`, in order."""
    return {sid: record(session, sql, keys) for sid, sql in SCRIPT}


def volatile_faults(runs: List[list], before_us: int, after_us: int,
                    n_rows: int = 25) -> List[str]:
    """Z6's properties over the rows of several runs, each run between
    the host-clock instants before_us and after_us (micros): one value
    per column across a run's rows, the instant inside the window, the
    wall-clock columns at the session zone's (UTC) reading of it, and a
    new instant every run."""
    bad, seen = [], []
    for i, rows in enumerate(runs):
        if len(rows) != n_rows:
            bad.append(f"run {i}: {len(rows)} rows")
            continue
        firsts = rows[0][1:]
        if any(list(r[1:]) != list(firsts) for r in rows):
            bad.append(f"run {i}: values differ across rows")
        now_s, cur_s, date, ltime, lts = firsts
        if now_s != cur_s:
            bad.append(f"run {i}: now() {now_s} != current_timestamp")
        us = lts  # the query's start in micros (the session is at UTC)
        if not before_us <= us <= after_us:
            bad.append(f"run {i}: {us} outside [{before_us}, {after_us}]")
        if abs(now_s * 1e6 - us) > 1 or date != us // 86_400_000_000 \
                or ltime != us % 86_400_000_000:
            bad.append(f"run {i}: {now_s, date, ltime} != {us}")
        seen.append(us)
    if len(set(seen)) != len(seen):
        bad.append(f"runs repeat an instant: {seen}")
    return bad


def weighted_digest_rows(returnflag, extendedprice, quantity,
                         tdigest) -> List[list]:
    """K2's weighted-digest columns from the generated columns: per
    l_returnflag in order, [flag, destructure_tdigest, value_at_quantile
    at 0.75] of `tdigest` (a module with presto_tpu's t-digest) over the
    group's prices in row order, weighted by their quantities."""
    import numpy as np

    flags = np.asarray(returnflag).astype(str)
    out = []
    for flag in sorted(set(flags.tolist())):
        m = flags == flag
        blob = tdigest.tdigest_from_values(
            np.asarray(extendedprice, np.float64)[m],
            np.asarray(quantity, np.float64)[m])
        out.append([flag, value(tuple(
            tuple(p) if isinstance(p, list) else p
            for p in tdigest.tdigest_destructure(blob))),
            tdigest.tdigest_value_at_quantile(blob, 0.75)])
    return out
