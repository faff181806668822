"""The decimal corpus over TPC-H: an ordered script, N1 to N9, run in
one fresh session from the first statement to the last.  N1 writes the
TPC-H money columns as DECIMAL(12,2), as the TPC-H specification types
them (`l_quantity`, `l_extendedprice`, `l_discount`, `l_tax`,
`o_totalprice`); the rest read what it wrote.  chip_smoke.py runs it at
SF1 and the tests at SF0.01, from these strings.

- N1: CREATE TABLE AS, lineitem_dec and orders_dec;
- N2: Q1 in the form presto_tpu runs, `DECIMAL '1.00' - l_discount`
  (short decimal products summed exactly into DECIMAL(38,4));
- N3: Q1's text as the specification writes it, `(1 - l_discount) *
  (1 + l_tax)`: the product of two DECIMAL(13,2) values is DECIMAL(26,4),
  long, and a long by long-column multiply raises in presto_tpu;
- N4: Q6 with decimal range predicates against literals of other
  scales (a rescale of the column, checked for overflow);
- N5: Q3's join of lineitem_dec, orders_dec and customer, ordered by a
  long-decimal revenue DESC (the limb sort), its short-decimal payload
  carried through the joins' gathers (block_gather on the card);
- N6: Q18's HAVING sum(l_quantity) > 300, a long value against an
  integer;
- N7: casts: long -> DOUBLE and DECIMAL(38,6), min and max of long
  values, truncate, beside count(*), count_if and a DOUBLE sum
  (fused_group_sums); N7b: VARCHAR -> DECIMAL(30,4) and a short decimal
  -> VARCHAR; N7c: a long-decimal column -> VARCHAR, which raises in
  presto_tpu;
- NG: a query over short decimals alone, which runs as a graph in
  "auto" (fused_group_sums inside the graph);
- N8: INSERT of negative decimals (one rounded at a coarser scale),
  an INSERT of a NULL decimal (which presto_tpu's memory connector
  refuses), DELETE, then the table's totals and SHOW STATS;
- N9: a long -> short CAST that overflows, held to raise.

Rows are compared through `values`: a Decimal exactly (its text, scale
included), a float within a relative tolerance, all else exactly.
"""

from __future__ import annotations

from decimal import Decimal
from typing import Dict, List, Optional

#: (id, statement), in the order they run
SCRIPT = [
    ("N1a", "CREATE TABLE lineitem_dec AS SELECT l_orderkey, l_returnflag, "
            "l_linestatus, l_shipdate, "
            "CAST(l_quantity AS DECIMAL(12,2)) AS l_quantity, "
            "CAST(l_extendedprice AS DECIMAL(12,2)) AS l_extendedprice, "
            "CAST(l_discount AS DECIMAL(12,2)) AS l_discount, "
            "CAST(l_tax AS DECIMAL(12,2)) AS l_tax FROM lineitem"),
    ("N1b", "CREATE TABLE orders_dec AS SELECT o_orderkey, o_custkey, "
            "o_orderdate, o_shippriority, "
            "CAST(o_totalprice AS DECIMAL(12,2)) AS o_totalprice "
            "FROM orders"),
    ("N2", "SELECT l_returnflag, l_linestatus, sum(l_quantity) AS sum_qty, "
           "sum(l_extendedprice) AS sum_base_price, "
           "sum(l_extendedprice * (DECIMAL '1.00' - l_discount)) "
           "AS sum_disc_price, avg(l_quantity) AS avg_qty, "
           "avg(l_extendedprice) AS avg_price, avg(l_discount) AS avg_disc, "
           "count(*) AS count_order FROM lineitem_dec "
           "WHERE l_shipdate <= DATE '1998-09-02' "
           "GROUP BY l_returnflag, l_linestatus "
           "ORDER BY l_returnflag, l_linestatus"),
    ("N3", "SELECT l_returnflag, l_linestatus, "
           "sum(l_extendedprice * (1 - l_discount) * (1 + l_tax)) "
           "AS sum_charge FROM lineitem_dec "
           "GROUP BY l_returnflag, l_linestatus"),
    ("N4", "SELECT sum(l_extendedprice * l_discount) AS revenue "
           "FROM lineitem_dec WHERE l_shipdate >= DATE '1994-01-01' "
           "AND l_shipdate < DATE '1995-01-01' "
           "AND l_discount BETWEEN DECIMAL '0.050' AND DECIMAL '0.0700' "
           "AND l_quantity < 24"),
    ("N5", "SELECT l_orderkey, "
           "sum(l_extendedprice * (DECIMAL '1' - l_discount)) AS revenue, "
           "o_orderdate, o_shippriority, o_totalprice "
           "FROM customer, orders_dec, lineitem_dec "
           "WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey "
           "AND l_orderkey = o_orderkey AND o_orderdate < DATE '1995-03-15' "
           "AND l_shipdate > DATE '1995-03-15' "
           "GROUP BY l_orderkey, o_orderdate, o_shippriority, o_totalprice "
           "ORDER BY revenue DESC, o_orderdate, l_orderkey LIMIT 10"),
    ("N6", "SELECT c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice, "
           "sum(l_quantity) AS qty FROM customer, orders_dec, lineitem_dec "
           "WHERE o_orderkey IN (SELECT l_orderkey FROM lineitem_dec "
           "GROUP BY l_orderkey HAVING sum(l_quantity) > 300) "
           "AND c_custkey = o_custkey AND o_orderkey = l_orderkey "
           "GROUP BY c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice "
           "ORDER BY o_totalprice DESC, o_orderdate, o_orderkey LIMIT 100"),
    ("N7", "SELECT l_returnflag, l_linestatus, "
           "CAST(sum(l_extendedprice) AS DOUBLE) AS sum_d, "
           "CAST(sum(l_extendedprice) AS DECIMAL(38,6)) AS sum_6, "
           "min(CAST(l_extendedprice AS DECIMAL(30,2))) AS min_long, "
           "max(CAST(l_extendedprice AS DECIMAL(30,2)) "
           "+ CAST(l_tax AS DECIMAL(30,2))) AS max_long, "
           "sum(truncate(l_extendedprice)) AS sum_trunc, "
           "count(*) AS n, count_if(l_discount > DECIMAL '0.05') AS n_disc, "
           "sum(CAST(l_tax AS DOUBLE)) AS sum_tax FROM lineitem_dec "
           "GROUP BY l_returnflag, l_linestatus "
           "ORDER BY l_returnflag, l_linestatus"),
    ("N7b", "SELECT n_name, "
            "CAST(CAST(n_nationkey * 1.25 AS VARCHAR) AS DECIMAL(30,4)) "
            "AS from_text, "
            "CAST(CAST(n_nationkey AS DECIMAL(10,2)) / 3 AS VARCHAR) "
            "AS third, CAST(CAST(n_regionkey AS DECIMAL(10,2)) AS VARCHAR) "
            "AS as_text FROM nation ORDER BY n_name"),
    ("N7c", "SELECT CAST(CAST(n_nationkey AS DECIMAL(30,2)) AS VARCHAR) "
            "FROM nation"),
    ("NG", "SELECT l_returnflag, min(l_discount) AS min_disc, "
           "max(l_discount) AS max_disc, min(l_tax) AS min_tax, "
           "max(l_extendedprice) AS max_price, count(*) AS n, "
           "count_if(l_tax > DECIMAL '0.04') AS n_tax, "
           "sum(CAST(l_quantity AS DOUBLE)) AS qty FROM lineitem_dec "
           "WHERE l_discount BETWEEN DECIMAL '0.020' AND DECIMAL '0.0900' "
           "GROUP BY l_returnflag ORDER BY l_returnflag"),
    ("N8a", "INSERT INTO lineitem_dec VALUES "
            "(9000001, 'X', 'Y', DATE '1998-12-01', DECIMAL '-1.50', "
            "DECIMAL '-12345.67', DECIMAL '0.10', DECIMAL '-0.08'), "
            "(9000002, 'X', 'Y', DATE '1998-12-02', DECIMAL '7', "
            "DECIMAL '99999999.99', DECIMAL '0.00', DECIMAL '-0.005')"),
    ("N8n", "INSERT INTO lineitem_dec VALUES "
            "(9000003, 'X', 'Y', DATE '1998-12-03', NULL, "
            "DECIMAL '-0.01', DECIMAL '0.00', DECIMAL '0.01')"),
    ("N8b", "DELETE FROM lineitem_dec WHERE l_quantity < DECIMAL '2.5'"),
    ("N8c", "SELECT count(*), sum(l_quantity), min(l_quantity), "
            "max(l_extendedprice), min(l_extendedprice), sum(l_tax), "
            "count(l_discount) FROM lineitem_dec"),
    ("N8d", "SHOW STATS FOR lineitem_dec"),
    ("N9", "SELECT l_returnflag, CAST(sum(l_extendedprice) AS DECIMAL(18,10)) "
           "FROM lineitem_dec GROUP BY l_returnflag"),
]

#: the statements that raise in presto_tpu, with the error's type
RAISES = {"N3": "NotImplementedError", "N7c": "TypeError",
          "N8n": "ExecutionError", "N9": "ValueError"}

#: the short-decimal query that runs as a graph in "auto"
GRAPH_IDS = ("NG",)

#: the queries whose seven counters are compared
QUERY_IDS = ("N2", "N4", "N5", "N6", "N7", "N7b", "NG", "N8c")

#: the queries that must launch each kernel on the card
FUSED_IDS = ("N7", "NG")  # count(*), count_if and a DOUBLE sum
GATHER_IDS = ("N5", "N6")  # the joins' short-decimal payload


def statement(sid: str) -> str:
    return next(s for i, s in SCRIPT if i == sid)


def value(v):
    """One result value in comparable, JSON-able form: a Decimal as
    "d:<text>" (exact, scale included)."""
    if isinstance(v, Decimal):
        return "d:" + str(v)
    return v


def values(rows) -> List[list]:
    return [[value(v) for v in r] for r in rows]


def memo_state(session, sql) -> List[str]:
    """The session memo's entries for `sql`: "DYNAMIC" or
    "executable" (either package's memo)."""
    memo = getattr(session, "_compiled_cache", None) or {}
    return ["DYNAMIC" if memo[k] == "DYNAMIC" else "executable"
            for k in memo if k[0] == sql]


def record(session, sid: str, sql: str, keys) -> dict:
    """One statement run: its rows and column types (or its error's type
    and message), execution mode, seven counters (`keys`) and memo
    entry."""
    try:
        res = session.sql(sql)
    except Exception as e:  # noqa: BLE001 - an error is a result here
        # the first line: presto_tpu's trace errors go on with a path
        return {"error": [type(e).__name__, str(e).split("\n")[0]],
                "rows": None,
                "memo": memo_state(session, sql)}
    return {"error": None, "rows": values(res.rows),
            "types": [str(t) for _n, t in res.columns],
            "mode": res.stats.execution_mode,
            "counters": [int(getattr(res.stats, k, 0)) for k in keys],
            "memo": memo_state(session, sql)}


def run_script(session, keys, ids=None) -> Dict[str, dict]:
    """SCRIPT (or the statements `ids`) in `session`, in order."""
    return {sid: record(session, sid, sql, keys)
            for sid, sql in SCRIPT if ids is None or sid in ids}


def _close(a, b, rtol: float) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if a != a and b != b:
            return True
        return abs(a - b) <= rtol * max(abs(a), abs(b))
    return a == b


def mismatch(sid: str, mine: dict, theirs: dict, rtol: float = 1e-9,
             with_stats: bool = True) -> str:
    """'' when a statement's record equals presto_tpu's: the same error
    (type and message; a StaticFallback by type alone, as presto_tpu's
    message is its JAX trace's) or the same rows (floats within rtol,
    decimals and all else exactly) and column types, and with
    `with_stats` the execution mode, counters and memo entry; else the
    first difference."""
    ea, eb = mine["error"], theirs["error"]
    if ea != eb and not (ea and eb and ea[0] == eb[0] == "StaticFallback"):
        return f"{sid}: error {ea} against {eb}"
    if mine.get("types") != theirs.get("types"):
        return f"{sid}: types {mine.get('types')} against {theirs.get('types')}"
    if with_stats:
        for k in ("mode", "counters", "memo"):
            if k in theirs and mine.get(k) != theirs[k]:
                return f"{sid}: {k} {mine.get(k)} against {theirs[k]}"
    a, b = mine["rows"], theirs["rows"]
    if a is None or b is None:
        return "" if a is b else f"{sid}: rows {a} against {b}"
    if len(a) != len(b):
        return f"{sid}: {len(a)} rows against {len(b)}"
    for i, (x, y) in enumerate(zip(a, b)):
        if len(x) != len(y) or not all(_close(p, q, rtol)
                                       for p, q in zip(x, y)):
            return f"{sid} row {i}: {x} against {y}"
    return ""


def script_mismatches(mine: Dict[str, dict], theirs: Dict[str, dict],
                      rtol: float = 1e-9,
                      with_stats: bool = True) -> List[str]:
    return [m for sid in theirs
            for m in [mismatch(sid, mine[sid], theirs[sid], rtol,
                               with_stats)] if m]


def compact_reference(full: Dict[str, Dict[str, dict]]) -> Dict[str, dict]:
    """presto_tpu's records {mode: {id: record}} with each fact once:
    "dynamic" whole, every other mode only the keys where it differs."""
    base = full["dynamic"]
    out = {"dynamic": base}
    for mode, recs in full.items():
        if mode != "dynamic":
            out[mode] = {sid: {k: v for k, v in r.items()
                               if v != base[sid].get(k)}
                         for sid, r in recs.items()}
    return out


def expand_reference(compact: Dict[str, dict], mode: str,
                     ids: Optional[list] = None) -> Dict[str, dict]:
    base = compact["dynamic"]
    over = compact.get(mode, {}) if mode != "dynamic" else {}
    return {sid: {**base[sid], **over.get(sid, {})} for sid in base
            if ids is None or sid in ids}
