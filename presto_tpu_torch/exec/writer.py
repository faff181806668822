"""TableWriter subsystem: CREATE TABLE AS and INSERT through connector
PageSinks (reference: presto_tpu/exec/writer.py; TableWriterOperator and
TableFinishOperator over ConnectorPageSink), for memory tables.

    begin_write -> append_page(s) -> finish

- the plan grows TableWriter / TableFinish nodes (plan/nodes.py), so
  EXPLAIN shows the write and the dynamic executor runs it like any
  other operator (Executor._exec_tablewriter / _exec_tablefinish);
- execution_mode "compiled" runs the source query through run_compiled
  (on a CUDA device a captured graph) and feeds its fetched columns to
  the sink; "auto" and "dynamic" run the dynamic executor, as the
  reference does.

Write layout properties (`WITH (bucketed_by=..., bucket_count=...,
sorted_by=..., partitioned_by=...)`) are applied here: bucket ids
through kernels.write_bucket_ids (splitmix64, the runtime filters' mix),
sorts within a bucket through kernels.write_sort_perm.  They are then
recorded on the table (write_properties(), ordering()), so that
ordering-aware execution trusts an engine-written table as it trusts a
generator's declaration.  An ordering claim is recorded only when the
written page sequence verifies as globally nondecreasing on the sort
keys and the table was empty before the write; hash-bucketed layouts
keep their per-bucket sort without the table-level claim.

Not ported, and raising NotImplementedError: streaming writes (chunked
and distributed execution append one page a split; in "auto" they start
above DEFAULT_STREAM_THRESHOLD rows), and the hive, localfile, parquet,
orc and blackhole targets with their staged file sinks.
"""

from __future__ import annotations

import itertools
import operator
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from presto_tpu_torch import types as T
from presto_tpu_torch.batch import to_numpy
from presto_tpu_torch.connectors import AppendPageSink, open_sink
from presto_tpu_torch.exec import kernels as K
from presto_tpu_torch.plan import nodes as P
from presto_tpu_torch.session import QueryResult
from presto_tpu_torch.sql import ast


class WriteError(Exception):
    pass


#: rows above which "auto" streams a single-scan write chunk by chunk
#: (reference: presto_tpu/exec/chunked.py DEFAULT_STREAM_THRESHOLD)
DEFAULT_STREAM_THRESHOLD = 120_000_000

#: the write targets that need the file connectors
_FILE_CONNECTORS = ("hive", "localfile", "parquet", "orc", "blackhole")


# ---------------------------------------------------------------------------
# write properties
# ---------------------------------------------------------------------------


def _namelist(v) -> List[str]:
    """Property value -> column names: ARRAY['a','b'] parses to a list;
    'a,b' splits on commas."""
    if v is None:
        return []
    if isinstance(v, (list, tuple)):
        return [str(x).strip() for x in v if str(x).strip()]
    return [s.strip() for s in str(v).split(",") if s.strip()]


@dataclass
class WriteProperties:
    """Parsed physical-layout write properties (reference: the hive
    connector's bucketed_by/bucket_count/sorted_by table properties,
    HiveTableProperties.java)."""

    bucketed_by: List[str] = field(default_factory=list)
    bucket_count: int = 0
    sorted_by: List[Tuple[str, bool]] = field(default_factory=list)
    partitioned_by: List[str] = field(default_factory=list)
    # range: buckets are contiguous slices of the globally sorted rows
    #   (sorted_by leads with the bucket columns), so the whole-table
    #   scan order is a verifiable ordering claim;
    # hash: splitmix64 bucket ids (kernels.write_bucket_ids)
    bucketing: str = "hash"

    def empty(self) -> bool:
        return not (self.bucketed_by or self.sorted_by
                    or self.partitioned_by)

    @classmethod
    def parse(cls, props: dict, schema: Dict[str, T.Type],
              connector: str) -> Optional["WriteProperties"]:
        if not props:
            return None
        bby = _namelist(props.get("bucketed_by"))
        sby_raw = _namelist(props.get("sorted_by"))
        pby = _namelist(props.get("partitioned_by"))
        if not (bby or sby_raw or pby):
            return None
        sby: List[Tuple[str, bool]] = []
        for item in sby_raw:
            parts = item.split()
            col = parts[0]
            asc = True
            if len(parts) > 1:
                d = parts[1].lower()
                if d not in ("asc", "desc"):
                    raise WriteError(f"sorted_by entry '{item}': expected "
                                     "'col [asc|desc]'")
                asc = d == "asc"
            sby.append((col, asc))

        def canon(col: str) -> str:
            for c in schema:
                if c.lower() == col.lower():
                    return c
            raise WriteError(f"write property references unknown column "
                             f"'{col}' (have {list(schema)})")

        bby = [canon(c) for c in bby]
        sby = [(canon(c), a) for c, a in sby]
        pby = [canon(c) for c in pby]
        count = int(props.get("bucket_count", 8)) if bby else 0
        if bby and count <= 0:
            raise WriteError("bucket_count must be positive")
        # range bucketing iff the bucket columns are exactly the leading
        # ascending sorted_by prefix
        kind = "hash"
        if bby and len(sby) >= len(bby) and all(
                sby[i][0] == bby[i] and sby[i][1]
                for i in range(len(bby))):
            kind = "range"
        if kind == "hash":
            for c in bby:
                t = schema[c]
                if t.is_string or getattr(t, "is_decimal", False) \
                        or t.numpy_dtype().kind not in ("i", "u"):
                    raise WriteError(
                        f"hash bucketing needs an integer column; "
                        f"'{c}' is {t} (declare it as the leading "
                        "sorted_by prefix for range bucketing)")
        return cls(bucketed_by=bby, bucket_count=count, sorted_by=sby,
                   partitioned_by=pby, bucketing=kind)

    def to_dict(self) -> dict:
        return {"bucketed_by": list(self.bucketed_by),
                "bucket_count": self.bucket_count,
                "sorted_by": [[c, bool(a)] for c, a in self.sorted_by],
                "partitioned_by": list(self.partitioned_by),
                "bucketing": self.bucketing}

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> Optional["WriteProperties"]:
        if not d:
            return None
        return cls(bucketed_by=list(d.get("bucketed_by", [])),
                   bucket_count=int(d.get("bucket_count", 0)),
                   sorted_by=[(c, bool(a))
                              for c, a in d.get("sorted_by", [])],
                   partitioned_by=list(d.get("partitioned_by", [])),
                   bucketing=d.get("bucketing", "hash"))


# ---------------------------------------------------------------------------
# page layout: partition split -> bucket split -> sort within a bucket
# ---------------------------------------------------------------------------


def _orderable_host(a: np.ndarray) -> np.ndarray:
    """Host sort key of one column: strings become sorted-dictionary
    codes (order-exact within one page); masked rows get a nulls-last
    flag from the caller."""
    if isinstance(a, np.ma.MaskedArray):
        a = a.filled("" if a.dtype.kind in ("U", "S", "O") else 0)
    if a.dtype.kind in ("U", "S", "O"):
        _, codes = np.unique(a.astype(str), return_inverse=True)
        return codes.astype(np.int64)
    return np.asarray(a)


def _null_flags(a: np.ndarray) -> Optional[np.ndarray]:
    if isinstance(a, np.ma.MaskedArray) and a.mask is not np.ma.nomask \
            and np.any(a.mask):
        return np.ma.getmaskarray(a).astype(np.int8)  # 1 = null -> last
    return None


def _page_sort(arrays: Dict[str, np.ndarray],
               sorted_by: List[Tuple[str, bool]],
               device) -> Dict[str, np.ndarray]:
    keys: List[np.ndarray] = []
    asc: List[bool] = []
    for col, up in sorted_by:
        nf = _null_flags(arrays[col])
        if nf is not None:
            keys.append(nf)  # nulls last whatever the direction
            asc.append(True)
        keys.append(_orderable_host(arrays[col]))
        asc.append(up)
    if not keys:
        return arrays
    perm = K.write_sort_perm(keys, device, asc)
    return {c: a[perm] for c, a in arrays.items()}


def _key_ranges(arrays: Dict[str, np.ndarray],
                sorted_by: List[Tuple[str, bool]]) -> Optional[list]:
    """[first-row, last-row] sort-key tuples of a sorted page, or None
    (an empty page, NULL sort keys): a page without ranges never
    supports a table-level ordering claim."""
    first, last = [], []
    for col, _asc in sorted_by:
        a = arrays[col]
        if isinstance(a, np.ma.MaskedArray):
            if a.mask is not np.ma.nomask and np.any(a.mask):
                return None
            a = a.data
        if len(a) == 0:
            return None
        lo, hi = a[0], a[-1]
        first.append(str(lo) if a.dtype.kind in ("U", "S", "O")
                     else lo.item() if hasattr(lo, "item") else lo)
        last.append(str(hi) if a.dtype.kind in ("U", "S", "O")
                    else hi.item() if hasattr(hi, "item") else hi)
    return [first, last]


def pages_ordered(metas: list, sorted_by: List[Tuple[str, bool]]) -> bool:
    """True when the page sequence is globally nondecreasing on the sort
    keys: every page sorted by the writer and every boundary
    lexicographically monotone (connectors.files_ordered).  Descending
    keys never qualify: ordering() claims are ascending."""
    from presto_tpu_torch.connectors import files_ordered

    if not sorted_by or not all(a for _c, a in sorted_by):
        return False
    return files_ordered([m.key_ranges for m in metas])


class PageLayout:
    """Applies the write properties to one host page, yielding
    (bucket, partition, arrays, key_ranges) sub-pages in publish order
    (partition-major, then bucket)."""

    def __init__(self, props: Optional[WriteProperties], device):
        self.props = props
        self.device = device

    def split(self, arrays: Dict[str, np.ndarray]):
        wp = self.props
        n = len(next(iter(arrays.values()))) if arrays else 0
        if wp is None or wp.empty() or n == 0:
            yield None, None, arrays, None
            return
        for part, sub in self._partitions(arrays, n):
            if wp.bucketed_by:
                if wp.bucketing == "range":
                    yield from self._range_buckets(part, sub)
                else:
                    yield from self._hash_buckets(part, sub)
            else:
                page = _page_sort(sub, wp.sorted_by, self.device)
                yield None, part, page, _key_ranges(page, wp.sorted_by)

    def _partitions(self, arrays, n):
        wp = self.props
        if not wp.partitioned_by:
            yield None, arrays
            return
        code = np.zeros(n, dtype=np.int64)
        for c in wp.partitioned_by:
            vals = arrays[c]
            if isinstance(vals, np.ma.MaskedArray):
                raise WriteError(
                    f"NULL partition values in '{c}' are not supported")
            u, inv = np.unique(np.asarray(vals), return_inverse=True)
            code = code * (len(u) + 1) + inv
        for pc in np.unique(code):
            idx = np.flatnonzero(code == pc)
            sub = {c: a[idx] for c, a in arrays.items()}
            part = tuple((c, sub[c][0].item()
                          if hasattr(sub[c][0], "item") else sub[c][0])
                         for c in wp.partitioned_by)
            yield part, sub

    def _range_buckets(self, part, sub):
        wp = self.props
        page = _page_sort(sub, wp.sorted_by, self.device)
        n = len(next(iter(page.values())))
        edges = np.linspace(0, n, wp.bucket_count + 1).astype(int)
        for b, (lo, hi) in enumerate(zip(edges[:-1], edges[1:])):
            if lo >= hi:
                continue
            bp = {c: a[lo:hi] for c, a in page.items()}
            yield b, part, bp, _key_ranges(bp, wp.sorted_by)

    def _hash_buckets(self, part, sub):
        wp = self.props
        keys = [_mixable_int(sub[c], c) for c in wp.bucketed_by]
        bids = K.write_bucket_ids(keys, wp.bucket_count, self.device)
        for b in range(wp.bucket_count):
            idx = np.flatnonzero(bids == b)
            if len(idx) == 0:
                continue
            bp = {c: a[idx] for c, a in sub.items()}
            bp = _page_sort(bp, wp.sorted_by, self.device)
            yield b, part, bp, _key_ranges(bp, wp.sorted_by)


def _mixable_int(a: np.ndarray, col: str) -> np.ndarray:
    if isinstance(a, np.ma.MaskedArray):
        if a.mask is not np.ma.nomask and np.any(a.mask):
            raise WriteError(f"NULL bucket keys in '{col}' are not "
                             "supported")
        a = a.data
    a = np.asarray(a)
    if a.dtype.kind not in ("i", "u", "b"):
        raise WriteError(f"hash bucketing needs integer keys; '{col}' "
                         f"is {a.dtype}")
    return a.astype(np.int64, copy=False)


# ---------------------------------------------------------------------------
# column coercion
# ---------------------------------------------------------------------------


def coerce_insert_page(arrays: Dict[str, np.ndarray],
                       types: Dict[str, T.Type],
                       targets: List[str], table, sink) -> Dict[str, np.ndarray]:
    """Coerce a query-output page onto the target schema for INSERT:
    positional target mapping, type coercion checks, decimal rescale and
    NULL handling.  Memory tables carry no null channel, so a partial
    column list or a NULL value raises."""
    src_cols = list(arrays)
    if len(src_cols) != len(targets):
        raise WriteError(
            f"INSERT column count mismatch: query produces "
            f"{len(src_cols)}, target list has {len(targets)}")
    unknown = [c for c in targets if c not in table.schema]
    if unknown:
        raise WriteError(f"unknown INSERT columns: {unknown}")
    n = len(arrays[src_cols[0]]) if src_cols else 0
    missing = [c for c in table.schema if c not in targets]
    if missing and not sink.supports_null_append:
        raise WriteError(
            f"INSERT must cover all columns (missing {missing}); "
            "partial inserts with null fill are not supported by this "
            "connector")
    out: Dict[str, np.ndarray] = {}
    for tgt, src in zip(targets, src_cols):
        want = table.schema[tgt]
        a = arrays[src]
        if isinstance(a, np.ma.MaskedArray):
            if sink.supports_null_append:
                pass  # the sink writes a null channel
            elif a.mask is not np.ma.nomask and np.any(a.mask):
                raise WriteError(
                    f"INSERT of NULL values into column '{tgt}' is not "
                    "supported by this connector")
            else:
                a = a.data
        if not isinstance(a, np.ma.MaskedArray):
            a = np.asarray(a)
        have = types.get(src, want)
        if have != want and not T.can_coerce(have, want) \
                and not (have.is_numeric and want.is_numeric):
            raise WriteError(f"cannot insert {have} into {tgt} ({want})")
        if want.is_decimal and a.dtype.kind == "f":
            # decoded decimals arrive as unscaled floats: rescale, never
            # truncate or wrap
            scaled = a * (10 ** want.decimal_scale)
            T.check_decimal_overflow(scaled, what="inserted value")
            a = np.round(scaled).astype(np.int64)
        elif not want.is_string and a.dtype != want.numpy_dtype() \
                and a.dtype != object:
            a = a.astype(want.numpy_dtype())
        out[tgt] = a
    for c in missing:  # null fill: an all-masked column of the right dtype
        t = table.schema[c]
        fill = np.full(n, "", dtype=object) if t.is_string \
            else np.zeros(n, dtype=t.numpy_dtype())
        out[c] = np.ma.masked_array(fill, mask=np.ones(n, dtype=bool))
    return {c: out[c] for c in table.schema}


def clean_ctas_page(arrays: Dict[str, np.ndarray], sink,
                    what: str = "CTAS") -> Dict[str, np.ndarray]:
    """CTAS pages define the schema, so no type coercion: only the NULL
    rule (a sink without a null channel rejects actual NULLs)."""
    if sink.supports_null_append:
        return dict(arrays)
    clean = {}
    for c, a in arrays.items():
        if isinstance(a, np.ma.MaskedArray):
            if a.mask is not np.ma.nomask and np.any(a.mask):
                raise WriteError(
                    f"{what} with NULL values in column '{c}' is not "
                    "supported by this connector")
            a = a.data
        clean[c] = np.asarray(a)
    return clean


# ---------------------------------------------------------------------------
# WriteContext: the runtime state behind TableWriter/TableFinish
# ---------------------------------------------------------------------------


class WriteContext:
    """One write's state: the sink, the layout transform, the coercion
    rule, the counters and the commit/abort protocol."""

    def __init__(self, session, table, sink, props: Optional[WriteProperties],
                 targets: Optional[List[str]] = None, is_ctas: bool = True,
                 on_commit=None):
        self.session = session
        self.table = table
        self.sink = sink
        self.props = props
        self.layout = PageLayout(props, session.device)
        self.targets = targets
        self.is_ctas = is_ctas
        self.on_commit = on_commit  # callable(ctx) after the sink commit
        self.rows = 0
        self.bytes = 0
        self.write_ns = 0
        self._done = False
        self._aborted = False

    # -- page path -----------------------------------------------------
    def write_page(self, arrays: Dict[str, np.ndarray],
                   types: Dict[str, T.Type]) -> int:
        t0 = time.perf_counter_ns()
        if self.is_ctas:
            page = clean_ctas_page(arrays, self.sink)
        else:
            page = coerce_insert_page(arrays, types, self.targets,
                                      self.table, self.sink)
        n = len(next(iter(page.values()))) if page else 0
        if n == 0:
            return 0
        for bucket, part, sub, ranges in self.layout.split(page):
            self.sink.append_page(sub, bucket=bucket, partition=part,
                                  key_ranges=ranges)
        self.rows += n
        self.bytes += sum(int(getattr(a, "nbytes", 0)) for a in page.values())
        self.write_ns += time.perf_counter_ns() - t0
        return n

    # -- commit protocol ----------------------------------------------
    def finish(self):
        if self._done:
            return self.sink.finished
        t0 = time.perf_counter_ns()
        res = self.sink.finish()  # a memory table holds the pages after it
        if isinstance(self.sink, AppendPageSink):
            self._record_append_claim()
        if res.bytes:
            self.bytes = res.bytes
        if self.on_commit is not None:
            self.on_commit(self)
        self._done = True
        self.write_ns += time.perf_counter_ns() - t0
        return res

    def abort(self):
        if self._done or self._aborted:
            return
        self._aborted = True
        self.sink.abort()

    @property
    def files(self) -> int:
        res = self.sink.finished
        return len(res.files) if res is not None else 0

    def _record_append_claim(self):
        """Record the write properties, and a verified ordering claim, on
        a memory table: the claim holds when this write's page sequence
        is monotone and the table was empty before it."""
        wp = self.props
        table = self.table
        rec = getattr(table, "record_write_properties", None)
        if wp is None or wp.empty() or rec is None:
            return
        prior = getattr(table, "_rows", None)
        fresh = (prior == self.rows) if prior is not None else False
        ordered = bool(wp.sorted_by) and fresh \
            and pages_ordered(self.sink.pages, wp.sorted_by)
        rec(wp.to_dict(), ordered)


# ---------------------------------------------------------------------------
# target tables
# ---------------------------------------------------------------------------


def _require_memory(connector: str) -> None:
    if connector in _FILE_CONNECTORS:
        raise NotImplementedError(
            f"{connector} tables wait for the file connectors, which are "
            "not ported to presto_tpu_torch")
    if connector != "memory":
        raise WriteError(f"unknown connector '{connector}'")


def build_target_table(session, name: str, schema: Dict[str, T.Type],
                       properties: dict):
    """Construct (not register) the target table of the WITH-selected
    connector; registration is the TableFinish commit.  Returns (table,
    connector)."""
    connector = str(properties.get("connector", "memory")).lower()
    _require_memory(connector)
    from presto_tpu_torch.catalog import MemoryTable

    empty = {c: np.empty(0, t.numpy_dtype() if not t.is_string else object)
             for c, t in schema.items()}
    return MemoryTable(name, schema, empty), connector


def target_connector(properties: dict) -> str:
    return str(properties.get("connector", "memory")).lower()


def connector_kind(table) -> str:
    """The connector of a registered table: every table of this package
    is a memory or generator table, which the reference reports as
    memory."""
    return "memory"


# ---------------------------------------------------------------------------
# write planning (TableWriter/TableFinish over the optimized query plan)
# ---------------------------------------------------------------------------


def output_schema(out: P.Output) -> Tuple[Dict[str, T.Type], List[str]]:
    """The host-array schema a materialized Output produces: duplicate
    names take a suffix `_i`, as in executor.execute_plan_to_host."""
    types = dict(out.source.outputs())
    schema: Dict[str, T.Type] = {}
    order: List[str] = []
    used: Dict[str, int] = {}
    for name, sym in zip(out.names, out.symbols):
        n = name
        i = used.get(name, 0)
        used[name] = i + 1
        if i:
            n = f"{name}_{i}"
        schema[n] = types.get(sym, T.VARCHAR)
        order.append(n)
    return schema, order


def plan_write_statement(session, stmt) -> P.QueryPlan:
    """Plan a CTAS/INSERT as Output <- TableFinish <- TableWriter <-
    <optimized query plan> (reference: LogicalPlanner
    .createTableWriterPlan)."""
    from presto_tpu_torch.exec.executor import plan_statement
    from presto_tpu_torch.plan.planner import Planner

    inner = plan_statement(session, ast.QueryStatement(stmt.query))
    if isinstance(stmt, ast.CreateTableAs):
        target, props = stmt.name, (stmt.properties or {})
        schema, order = output_schema(inner.root)
        columns = order
        connector = target_connector(props)
        _require_memory(connector)
        wp = WriteProperties.parse(props, schema, connector)
    else:
        target = stmt.table
        table = session.catalog.get(target)
        columns = stmt.columns if stmt.columns is not None \
            else list(table.schema)
        connector = connector_kind(table)
        wp = WriteProperties.from_dict(
            table.write_properties()
            if hasattr(table, "write_properties") else None)
    return Planner.wrap_write(
        inner, target, connector, columns,
        wp.to_dict() if wp is not None else None)


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------


def _host_arrays(out: P.Output, batch) -> Tuple[Dict[str, np.ndarray],
                                                Dict[str, T.Type]]:
    arrays, sel = to_numpy(batch)
    schema, _order = output_schema(out)
    result = {}
    used: Dict[str, int] = {}
    for name, sym in zip(out.names, out.symbols):
        n = name
        i = used.get(name, 0)
        used[name] = i + 1
        if i:
            n = f"{name}_{i}"
        result[n] = host_column(arrays[sym][sel])
    return result, schema


def host_column(v) -> np.ndarray:
    """A decoded result column as a write page holds it: NULLs masked,
    strings an object array (the port's dictionaries hold fixed-width
    unicode arrays; presto_tpu's tables, and so its byte counts and
    statistics, hold objects)."""
    if isinstance(v, np.ma.MaskedArray):
        if v.dtype.kind == "U":
            return np.ma.masked_array(v.data.astype(object), mask=v.mask)
        return v
    v = np.asarray(v)
    return v.astype(object) if v.dtype.kind == "U" else v


def _stream_target(plan: P.QueryPlan):
    """The write's scan when its source is a single-scan pipeline
    (Output <- Project/Filter* <- TableScan, no subplans): the plans the
    reference's chunked and distributed writes stream split by split."""
    if plan.subplans:
        return None
    inner = plan.root.source.source.source  # Output <- TF <- TW <- inner
    node = inner.source
    while isinstance(node, (P.Project, P.Filter)):
        node = node.source
    if not isinstance(node, P.TableScan):
        return None
    scans: List[P.TableScan] = []

    def walk(n):
        if isinstance(n, P.TableScan):
            scans.append(n)
        for s in n.sources:
            walk(s)

    walk(inner)
    if len(scans) != 1 or scans[0] is not node:
        return None
    return node


def _refuse_streaming(session, plan: P.QueryPlan, mode: str) -> None:
    """Raise where the reference streams the write: a single-scan source
    under distributed execution, execution_mode "chunked", or "auto"
    above chunked_rows_threshold rows.  Other sources run the dynamic
    executor in every mode, as the reference's do."""
    scan = _stream_target(plan)
    if scan is None:
        return
    if session.properties.get("distributed", False):
        raise NotImplementedError(
            "distributed writes wait for distributed execution, which is "
            "not ported to presto_tpu_torch")
    if mode == "chunked":
        raise NotImplementedError(
            "chunked writes wait for chunked execution, which is not "
            "ported to presto_tpu_torch")
    threshold = int(session.properties.get("chunked_rows_threshold",
                                           DEFAULT_STREAM_THRESHOLD))
    if mode == "auto" \
            and session.catalog.get(scan.table).row_count() > threshold:
        raise NotImplementedError(
            f"a streamed write of '{scan.table}' (more than {threshold} "
            "rows) waits for chunked execution, which is not ported to "
            "presto_tpu_torch")


def _compiled_arrays(session, text: str, query: ast.Query, mon):
    """Compiled-mode source execution: the SELECT runs through
    run_compiled under a write-scoped memo key and its rows convert back
    to host columns.  None when the rows do not round-trip to arrays;
    the caller then runs the dynamic pipeline."""
    from presto_tpu_torch.exec.executor import run_compiled

    res = run_compiled(session, f"__write__:{text}",
                       ast.QueryStatement(query), mon=mon)
    arrays: Dict[str, np.ndarray] = {}
    types: Dict[str, T.Type] = {}
    used: Dict[str, int] = {}
    by_column = list(zip(*res.rows)) if res.rows \
        else [()] * len(res.columns)
    for i, (name, typ) in enumerate(res.columns):
        n = name
        k = used.get(name, 0)
        used[name] = k + 1
        if k:
            n = f"{name}_{k}"
        vals = by_column[i]
        is_null = list(map(operator.is_, vals, itertools.repeat(None)))
        has_null = any(is_null)
        if typ.is_string:
            a = np.asarray([("" if v is None else v) for v in vals]
                           if has_null else vals, dtype=object)
        else:
            dt = np.float64 if (typ.is_decimal
                                or typ.name == "DOUBLE") else None
            try:
                a = np.asarray([(0 if v is None else v) for v in vals]
                               if has_null else vals, dtype=dt)
            except (TypeError, ValueError):
                return None
            if a.dtype == object:
                return None
        if has_null:
            a = np.ma.masked_array(a, mask=np.asarray(is_null))
        arrays[n] = a
        types[n] = typ
    return arrays, types


def run_write(session, text: str, stmt, mon) -> QueryResult:
    """CTAS / INSERT: authorize -> plan (TableWriter) -> begin_write ->
    execute in the session's mode (appending pages) -> finish/commit ->
    the row count."""
    is_ctas = isinstance(stmt, ast.CreateTableAs)
    if is_ctas:
        session.access_control.check_can_create_table(session.user,
                                                      stmt.name)
        or_replace = bool(getattr(stmt, "or_replace", False))
        if stmt.name in session.catalog and not or_replace:
            if stmt.if_not_exists:
                return QueryResult([("rows", T.BIGINT)], [(0,)])
            raise WriteError(f"Table '{stmt.name}' already exists")
    else:
        session.access_control.check_can_insert(session.user, stmt.table)

    from presto_tpu_torch.exec.colval import StaticFallback
    from presto_tpu_torch.exec.executor import Executor, plan_statement

    with mon.phase("plan"):
        plan = plan_statement(session, stmt)
    tw: P.TableWriter = plan.root.source.source
    wp = WriteProperties.from_dict(tw.write_props)
    mode = session.properties.get("execution_mode", "auto")
    _refuse_streaming(session, plan, mode)

    ctx = _begin_write(session, stmt, tw, wp)
    try:
        with mon.phase("execute"):
            executed = False
            if mode == "compiled":
                try:
                    got = _compiled_arrays(session, text, stmt.query, mon)
                except StaticFallback:
                    got = None
                if got is not None:
                    mon.stats.execution_mode = "compiled"
                    arrays, types = got
                    ctx.write_page(arrays, types)
                    executed = True
            if not executed:
                # TableWriter/TableFinish run as plan nodes
                mon.stats.execution_mode = "dynamic"
                ex = Executor(session, monitor=mon)
                ex.write_ctx = ctx
                ex.run(plan)
            ctx.finish()  # idempotent (TableFinish commits inline)
    except BaseException:
        ctx.abort()
        raise
    mon.stats.rows_written = ctx.rows
    mon.stats.bytes_written = ctx.bytes
    mon.stats.write_files = ctx.files
    mon.stats.write_ms = ctx.write_ns / 1e6
    return QueryResult([("rows", T.BIGINT)], [(ctx.rows,)])


def _begin_write(session, stmt, tw: P.TableWriter,
                 wp: Optional[WriteProperties]) -> WriteContext:
    """Build the target table and its sink, and wire the commit callback
    (catalog registration and the transaction's undo records)."""
    if not isinstance(stmt, ast.CreateTableAs):
        table = session.catalog.get(stmt.table)
        if not (hasattr(table, "page_sink") or hasattr(table, "append")):
            raise WriteError(
                f"table '{stmt.table}' does not support INSERT")
        # the pre-image before the first page
        session.txn.record_table_write(table)
        sink = open_sink(table, wp)
        return WriteContext(session, table, sink, wp,
                            targets=list(tw.columns), is_ctas=False)

    schema, _order = output_schema(tw.source)
    props = stmt.properties or {}
    replacing = bool(getattr(stmt, "or_replace", False)) \
        and stmt.name in session.catalog
    old_table = session.catalog.get(stmt.name) if replacing else None
    session.txn.check_write_allowed()
    table, _ = build_target_table(session, stmt.name, schema, props)
    sink = open_sink(table, wp)

    def on_commit(ctx: WriteContext):
        if replacing:
            session.txn.record_replace(stmt.name, old_table)
        else:
            session.txn.record_create(stmt.name)
        session.catalog.register(ctx.table)

    return WriteContext(session, table, sink, wp, is_ctas=True,
                        on_commit=on_commit)


# ---------------------------------------------------------------------------
# SHOW CREATE TABLE and DESCRIBE
# ---------------------------------------------------------------------------


def render_create_table(table) -> str:
    """CREATE TABLE DDL with the recorded physical-layout properties:
    running it (under a fresh name) reproduces the layout (reference:
    ShowCreateTable)."""
    cols = ",\n".join(f"   {c} {str(t).lower()}"
                      for c, t in table.schema.items())
    props = [("connector", f"'{connector_kind(table)}'")]
    wp = WriteProperties.from_dict(
        table.write_properties()
        if hasattr(table, "write_properties") else None)
    if wp is not None and not wp.empty():
        if wp.bucketed_by:
            props.append(("bucketed_by", _render_array(wp.bucketed_by)))
            props.append(("bucket_count", str(wp.bucket_count)))
        if wp.sorted_by:
            props.append(("sorted_by", _render_array(
                [f"{c} {'asc' if a else 'desc'}" for c, a in wp.sorted_by])))
        if wp.partitioned_by:
            props.append(("partitioned_by",
                          _render_array(wp.partitioned_by)))
    with_clause = ",\n".join(f"   {k} = {v}" for k, v in props)
    return (f"CREATE TABLE {table.name} (\n{cols}\n)\n"
            f"WITH (\n{with_clause}\n)")


def _render_array(items: List[str]) -> str:
    return "ARRAY[" + ", ".join(f"'{i}'" for i in items) + "]"


def describe_extra_rows(table) -> List[tuple]:
    """The layout rows SHOW COLUMNS appends for a table with recorded
    write properties."""
    wp = WriteProperties.from_dict(
        table.write_properties()
        if hasattr(table, "write_properties") else None)
    if wp is None or wp.empty():
        return []
    rows = []
    if wp.sorted_by:
        rows.append(("# sorted_by", ", ".join(
            f"{c} {'ASC' if a else 'DESC'}" for c, a in wp.sorted_by)))
    if wp.bucketed_by:
        rows.append(("# bucketed_by",
                     f"{', '.join(wp.bucketed_by)} "
                     f"({wp.bucketing}, {wp.bucket_count} buckets)"))
    if wp.partitioned_by:
        rows.append(("# partitioned_by", ", ".join(wp.partitioned_by)))
    return rows
