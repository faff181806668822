"""The statement corpus over TPC-H: an ordered script of statements other
than queries (CREATE TABLE AS, INSERT, DELETE, transactions, EXPLAIN,
the SHOW family, SET SESSION, DROP TABLE), with the queries that read
what they wrote, run in one fresh session from the first statement to
the last.  chip_smoke.py runs it at SF1 and the tests at SF0.01, from
these strings.

- D1 and D4 write an aggregate (fused_group_sums: four groups);
- D2 writes range buckets (bucketed_by = the leading ascending
  sorted_by column): the table records an ordering claim on l_orderkey;
- D3 writes a join's rows in hash buckets (kernels.write_bucket_ids)
  sorted descending within each bucket;
- D5 joins and groups the written tables, ordered by l_orderkey (the
  grouping and the ORDER BY ride D2's ordering claim; 16 groups, so
  fused_group_sums takes its register path at every scale);
- D6 inserts inside a transaction and rolls back, then inserts again and
  commits, re-reading D5's text after each (the memo key carries the
  catalog version, so no graph captured before a write replays);
- D7 deletes, D8 explains and shows, D9 drops.

Also the numpy helpers that digest a written table for the comparison
(`table_digest`, `PageLog`): they read a memory table's host arrays and
the pages a write appended, and work on either package's tables.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Optional

import numpy as np

D5 = ("SELECT l_orderkey, count(*) AS n, sum(l_extendedprice) AS revenue, "
      "avg(l_quantity) AS qty FROM li_range JOIN ord_hash "
      "ON l_orderkey = o_orderkey WHERE l_orderkey < 64 "
      "GROUP BY l_orderkey ORDER BY l_orderkey")

_LI_SMALL = ("SELECT l_orderkey, l_partkey, l_suppkey, l_quantity, "
             "l_extendedprice, l_shipdate FROM lineitem WHERE l_orderkey < 64")

#: (id, statement, the table it writes or None), in the order they run
SCRIPT = [
    ("D1", "CREATE TABLE rev AS SELECT l_returnflag, l_linestatus, "
           "sum(l_extendedprice * (1 - l_discount)) AS revenue, "
           "count(*) AS n FROM lineitem GROUP BY 1, 2", "rev"),
    ("D2", "CREATE TABLE li_range WITH (bucketed_by = ARRAY['l_orderkey'], "
           "bucket_count = 16, sorted_by = ARRAY['l_orderkey']) AS "
           "SELECT l_orderkey, l_partkey, l_suppkey, l_quantity, "
           "l_extendedprice, l_shipdate FROM lineitem", "li_range"),
    ("D3", "CREATE TABLE ord_hash WITH (bucketed_by = ARRAY['o_custkey'], "
           "bucket_count = 32, sorted_by = ARRAY['o_orderdate desc']) AS "
           "SELECT o_orderkey, o_custkey, o_orderdate, o_totalprice, "
           "c_mktsegment FROM orders JOIN customer ON o_custkey = c_custkey",
     "ord_hash"),
    ("D4", "INSERT INTO rev SELECT l_returnflag, l_linestatus, "
           "sum(l_extendedprice * (1 - l_discount)), count(*) FROM lineitem "
           "WHERE l_shipdate >= DATE '1998-09-01' GROUP BY 1, 2", "rev"),
    ("D5", D5, None),
    ("D6a", "START TRANSACTION", None),
    ("D6b", "INSERT INTO li_range " + _LI_SMALL, "li_range"),
    ("D6c", "ROLLBACK", "li_range"),
    ("D6d", D5, None),
    ("D6e", "START TRANSACTION", None),
    ("D6f", "INSERT INTO li_range " + _LI_SMALL, "li_range"),
    ("D6g", "COMMIT", None),
    ("D6h", D5, None),
    ("D7", "DELETE FROM ord_hash WHERE o_orderdate < DATE '1993-01-01'",
     "ord_hash"),
    ("D7b", "SELECT count(*), sum(o_totalprice), min(o_orderdate) "
            "FROM ord_hash", None),
    ("D8a", "EXPLAIN " + D5, None),
    ("D8b", "EXPLAIN ANALYZE SELECT l_returnflag, l_linestatus, "
            "revenue, n FROM rev ORDER BY l_returnflag, l_linestatus", None),
    ("D8c", "SHOW CREATE TABLE li_range", None),
    ("D8d", "SHOW COLUMNS FROM ord_hash", None),
    ("D8e", "SHOW STATS FOR li_range", None),
    ("D8f", "SHOW TABLES", None),
    ("D8g", "SET SESSION ordering_aware_execution = false", None),
    ("D9", "DROP TABLE rev", None),
    ("D9b", "SHOW TABLES", None),
]

#: the statements chip_smoke.py also runs under execution_mode "compiled"
#: (the writer's _compiled_arrays path)
COMPILED_IDS = ("D2", "D3")

#: the statements whose seven counters are compared (the queries)
QUERY_IDS = ("D5", "D6d", "D6h", "D7b")

#: tables that exist only in presto_tpu's sessions (its system tables),
#: left out of SHOW TABLES' comparison
SYSTEM_TABLE_PREFIXES = ("information_schema.", "system.")


def statement(sid: str) -> str:
    return next(s for i, s, _t in SCRIPT if i == sid)


# ---------------------------------------------------------------------------
# digests of written tables
# ---------------------------------------------------------------------------


class PageLog:
    """Records each page a write appends, (table name, bucket, rows), by
    wrapping `append_page` of a package's AppendPageSink class; use as a
    context manager."""

    def __init__(self, sink_cls):
        self.sink_cls = sink_cls
        self.pages: List[tuple] = []

    def __enter__(self):
        orig = self._orig = self.sink_cls.append_page
        log = self.pages

        def append_page(sink, arrays, bucket=None, partition=None,
                        key_ranges=None):
            n = orig(sink, arrays, bucket=bucket, partition=partition,
                     key_ranges=key_ranges)
            log.append((sink.table.name, bucket, int(n)))
            return n

        self.sink_cls.append_page = append_page
        return self

    def __exit__(self, *exc):
        self.sink_cls.append_page = self._orig
        return False

    def take(self) -> List[tuple]:
        out, self.pages[:] = list(self.pages), []
        return out


def _mix64(z: np.ndarray) -> np.ndarray:
    """splitmix64's finalizer in numpy uint64."""
    with np.errstate(over="ignore"):
        z = z + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return z ^ (z >> np.uint64(31))


def _exact_ints(a: np.ndarray) -> Optional[np.ndarray]:
    """A column as uint64 words when its values are exact (integers,
    dates, booleans, strings through crc32); None for floats."""
    a = np.ma.getdata(a)
    if a.dtype.kind in ("i", "u", "b"):
        return a.astype(np.int64).view(np.uint64)
    if a.dtype.kind in ("U", "S", "O"):
        u, inv = np.unique(a.astype(str), return_inverse=True)
        crc = np.asarray([zlib.crc32(s.encode()) for s in u], np.uint64)
        return crc[inv]
    return None


def _seq_hash(words: np.ndarray) -> int:
    """Order-sensitive hash of a uint64 sequence."""
    return zlib.crc32(np.ascontiguousarray(words).tobytes())


def _multiset_hash(cols: List[np.ndarray]) -> int:
    """Order-insensitive hash of rows (the sum of their row hashes)."""
    if not cols:
        return 0
    h = np.zeros(len(cols[0]), np.uint64)
    with np.errstate(over="ignore"):
        for c in cols:
            h = _mix64(h ^ c)
        return int(h.sum(dtype=np.uint64))


def table_digest(data: Dict[str, np.ndarray], pages: List[tuple],
                 sort_keys: List[str]) -> dict:
    """The written table's digest: its row count; per column the sum
    (integers and strings' crc32 exactly, floats as float64) and, for
    exact columns, a hash of the whole column in row order; and for each
    page this write appended (the table's last rows, in order): its
    bucket, rows, the hash of its sort-key sequence and the multiset
    hash of its exact columns (rows tied on the sort key may come in any
    order)."""
    cols = list(data)
    n = len(data[cols[0]]) if cols else 0
    out = {"rows": int(n), "sums": {}, "order": {}, "pages": []}
    words = {}
    for c in cols:
        w = _exact_ints(data[c])
        if w is None:
            out["sums"][c] = float(np.sum(np.ma.getdata(data[c]),
                                          dtype=np.float64))
        else:
            words[c] = w
            out["sums"][c] = int(w.sum(dtype=np.uint64))  # mod 2^64
            out["order"][c] = _seq_hash(w)
    start = n - sum(p[2] for p in pages)
    for _name, bucket, rows in pages:
        sl = slice(start, start + rows)
        key = [words[k][sl] for k in sort_keys if k in words]
        out["pages"].append((bucket, rows,
                             _seq_hash(np.stack(key, 1)) if key else 0,
                             _multiset_hash([w[sl] for w in words.values()])))
        start += rows
    return out


def run_script(session, sink_cls, ids=None,
               keep_data: bool = False) -> Dict[str, tuple]:
    """Run SCRIPT (or the statements `ids`) in `session`, in order:
    {id: (QueryResult, digest of the table it wrote or None)}.  A digest
    also holds the table's ordering() and write_properties(), and with
    keep_data a copy of its arrays ("data").  sink_cls is the session's
    package's AppendPageSink."""
    out: Dict[str, tuple] = {}
    with PageLog(sink_cls) as log:
        for sid, sql, table in SCRIPT:
            if ids is not None and sid not in ids:
                continue
            res = session.sql(sql)
            pages = log.take()
            dig = None
            if table is not None:
                t = session.catalog.get(table)
                wp = t.write_properties() or {}
                dig = table_digest(
                    t.data, [p for p in pages if p[0] == t.name],
                    [c for c, _a in wp.get("sorted_by", [])])
                dig["ordering"] = [[c, bool(a)] for c, a in t.ordering()]
                dig["write_properties"] = wp
                if keep_data:
                    dig["data"] = {c: np.array(v, copy=True)
                                   for c, v in t.data.items()}
            out[sid] = (res, dig)
    return out


# ---------------------------------------------------------------------------
# comparing a statement's rows with presto_tpu's
# ---------------------------------------------------------------------------

#: DOUBLE columns that presto_tpu's TPC-H connector computes on its
#: device, one ulp away from the host values here (28124.140000000003
#: against 28124.14): SHOW STATS' distinct count of such a column
#: differs, and is not compared
DEVICE_ROUNDED = ("l_extendedprice", "o_totalprice")


def comparable(sid: str, rows: list, reference: bool = False) -> list:
    """A statement's rows as they compare: EXPLAIN ANALYZE without its
    times, its phase line and presto_tpu's trace line, SHOW TABLES
    without presto_tpu's system tables."""
    import re

    if sid == "D8b":
        text = rows[0][0]
        lines = [re.sub(r"time=[0-9.]+ms", "time=?", ln)
                 for ln in text.split("\n")
                 if not ln.startswith(("Query ", "Trace: "))]
        return [("\n".join(lines).rstrip(),)]
    if reference and statement(sid) == "SHOW TABLES":
        return [r for r in rows if not r[0].startswith(SYSTEM_TABLE_PREFIXES)]
    return list(rows)


def _close(a, b, rtol: float) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        if a != a and b != b:  # NaN
            return True
        return abs(a - b) <= rtol * max(abs(a), abs(b))
    return a == b


def rows_mismatch(sid: str, mine: list, theirs: list,
                  rtol: float = 1e-9) -> str:
    """'' when the port's rows of `sid` equal presto_tpu's (already
    through `comparable`): in order, floats at rtol, everything else
    exactly; else the first difference."""
    if len(mine) != len(theirs):
        return f"{sid}: {len(mine)} rows against {len(theirs)}"
    for i, (a, b) in enumerate(zip(mine, theirs)):
        if len(a) != len(b):
            return f"{sid} row {i}: {a} against {b}"
        for j, (x, y) in enumerate(zip(a, b)):
            if sid == "D8e" and j == 1 and a[0] in DEVICE_ROUNDED:
                continue
            if not _close(x, y, rtol):
                return f"{sid} row {i}: {a} against {b}"
    return ""


def digest_mismatch(mine: dict, theirs: dict, rtol: float = 1e-9) -> str:
    """'' when two table digests agree: float sums at rtol, all else
    exactly."""
    for k in theirs:
        a, b = mine.get(k), theirs[k]
        if k == "sums":
            if set(a) != set(b):
                return f"columns {sorted(a)} against {sorted(b)}"
            for c in b:
                if not _close(a[c], b[c], rtol):
                    return f"sum of {c}: {a[c]} against {b[c]}"
        elif _listify(a) != _listify(b):
            return f"{k}: {str(a)[:200]} against {str(b)[:200]}"
    return ""


def _listify(v):
    """Tuples as lists, as they come back from JSON."""
    if isinstance(v, (list, tuple)):
        return [_listify(x) for x in v]
    if isinstance(v, dict):
        return {k: _listify(x) for k, x in v.items()}
    return v


# ---------------------------------------------------------------------------
# a frozen reference, each fact once
# ---------------------------------------------------------------------------


def compact_reference(full: Dict[str, dict]) -> Dict[str, dict]:
    """presto_tpu's values of the script, {mode: {id: {"rows", "stats",
    "counters", "digest"}}}, with each fact kept once: "dynamic" whole,
    where a digest equal to an earlier statement's is that statement's
    id; every other mode only the keys where it differs from "dynamic",
    a statement where none differs left out ({} where the mode runs
    only some statements, see expand_reference)."""
    base = full["dynamic"]
    dyn: Dict[str, dict] = {}
    seen: Dict[str, str] = {}
    for sid, got in base.items():
        dig = got["digest"]
        if dig is not None:
            dig = seen.setdefault(repr(_listify(dig)), sid)
            if dig == sid:
                dig = got["digest"]
        dyn[sid] = {**got, "digest": dig}
    out = {"dynamic": dyn}
    for mode, stmts in full.items():
        if mode == "dynamic":
            continue
        out[mode] = {}
        for sid, got in stmts.items():
            over = {k: v for k, v in got.items()
                    if _listify(v) != _listify(base[sid][k])}
            if over or mode == "compiled":
                out[mode][sid] = over
    return out


def expand_reference(compact: Dict[str, dict], mode: str) -> Dict[str, dict]:
    """One mode's values from compact_reference's form: "compiled" runs
    the statements it lists (COMPILED_IDS), every other mode the whole
    script."""
    base = compact["dynamic"]
    over = compact.get(mode, {}) if mode != "dynamic" else {}
    ids = list(over) if mode == "compiled" else list(base)
    out = {sid: {**base[sid], **over.get(sid, {})} for sid in ids}
    for got in out.values():
        if isinstance(got["digest"], str):
            got["digest"] = base[got["digest"]]["digest"]
    return out
