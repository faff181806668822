"""Local query executor: logical plan -> torch kernels -> host result.

Reference: presto_tpu/exec/executor.py.  A SELECT runs as the
reference's does: in `execution_mode` "auto" (the default) and
"compiled", `run_compiled` runs the static executor, `Executor(static=
True)`: fixed capacities from the planner's statistics, every static
assumption kept as a device bool (a guard) and one packed fetch at the
end, with no host read before it.  On a CUDA device
`compile_cache.build_graph` captures it as one CUDA graph per query,
which later runs of the same text replay from the session's memo
(`compile_cache.GraphMemo`, bounded in device bytes and entries, least
recently used out).  A tripped guard or a
`StaticFallback` sends the query to the dynamic executor (`Executor`),
which materializes each node at its live size; "dynamic" selects it
directly.  Each node produces a whole-column Batch on the session's
device; filters AND into `sel`.  Joins run INNER, LEFT, RIGHT (the
mirrored LEFT), SEMI, ANTI and MARK, as index joins or sort joins
(`kernels.build_probe`), always resident; FULL runs as a LEFT join
followed by the build rows an ANTI join leaves, CROSS as two gathers.
Window (exec/window.py) and Union (UNION ALL; UNION DISTINCT, INTERSECT,
EXCEPT and GROUPING SETS/ROLLUP/CUBE are planned onto it and onto
aggregates and SEMI/ANTI joins) run in both executors.

Ordering-aware execution (plan/properties.py) and dynamic filtering
(plan/runtime_filters.py) run as the reference's do, in both executors:
sorts whose input is already ordered are elided (Sort, TopN, presorted
grouping and join builds, each under a guard where the order is only
claimed), a key sorted once in a query is not sorted again (the sort,
permutation and group-id memos), and a selective INNER or SEMI join
runs its build side first and prunes its probe scan's rows with the
build keys' summary (kernels.rf_build, rf_probe).  QueryStats counts
both in sorts_taken, sorts_elided, sort_memo_hits,
ordering_guard_trips, df_filters_produced, df_filters_applied and
df_rows_pruned.

Aggregates (`_agg_column`, PORTED_AGGS), each one scalar a group, in
both executors: count, count_if, sum, avg (over intervals too: an
interval's average truncates toward zero), min, max, the stddev/variance
family, approx_distinct (a HyperLogLog register matrix per grouping,
kernels.hll_registers_and_estimate; string values hashed by XXH64 of
their dictionary entries; the optional error argument sets m; DISTINCT
counts exactly), COUNT/SUM ... WITH ERROR (approx_count, approx_sum: a
1-in-8 value-hash sample scaled by 8), checksum, approx_percentile (one
constant percentile, no weight: kernels.group_percentile), min_by and
max_by (two arguments), arbitrary / any_value, geometric_mean, bool_and
/ every / bool_or, corr, covar_samp, covar_pop, regr_slope,
regr_intercept, skewness, kurtosis, entropy, bitwise_and_agg and
bitwise_or_agg; and the eight that return a collection a group
(COLLECTION_AGGS: array_agg, DISTINCT too, map_agg, multimap_agg,
histogram, numeric_histogram, map_union, set_agg, set_union), built on
the host from the rows (exec/collections.py), and those whose states
are sketches or other host values (HOST_AGGS: approx_set, merge,
qdigest_agg, tdigest_agg, map_union_sum, approx_most_frequent,
reduce_agg; min_by / max_by with a count; approx_percentile over an
ARRAY of percentiles or with a weight), built on the host from the rows
(exec/host_aggs.py), all in the dynamic executor alone: the static one
raises StaticFallback, as the reference's does.

DECIMAL values (functions/decimals.py, exec/dec128.py): a short decimal
is a scaled int64, a long one (precision over 18) (n, 2) Int128 limbs.
sum of a decimal is DECIMAL(38, s), summed exactly in four 32-bit lanes
(dec128.segment_sum128); min and max of limbs in two passes
(segment_minmax128); avg is a DOUBLE and the stddev/variance family
reads the unscaled values, as the reference's do.  A plan with a long
decimal anywhere runs in the dynamic executor and memoizes "DYNAMIC"
(`_plan_has_long_decimal`); one over short decimals alone runs as a
graph, its overflow checks guards (colval.check_rows).

ARRAY, MAP and ROW values are int32 codes into host dictionaries of
tuples (functions/scalar.py); VALUES folds their constructors, UNION
ALL merges their dictionaries, and UNNEST (`_exec_unnest`,
`_unnest_static`, WITH ORDINALITY) expands rows on the device in both
executors: the static one over the (entries x longest array) element
matrix of the dictionary, up to STATIC_UNNEST_MAX expanded rows.

Statements other than queries (`_dispatch_statement`): CREATE TABLE AS
and INSERT through exec/writer.py (the plan nodes TableWriter and
TableFinish, `_exec_tablewriter`, `_exec_tablefinish`), DELETE
(`_delete_from`), CREATE and DROP TABLE, the transaction statements
(transaction.py), SET SESSION, EXPLAIN (plain, TYPE VALIDATE, and
ANALYZE in "auto" and "dynamic"), SHOW CREATE TABLE and SHOW TABLES,
COLUMNS, FUNCTIONS, SESSION, CATALOGS, SCHEMAS and STATS, over memory
tables; every scanned table is checked against the session's access
control (security.py) when a statement is planned.

float32_compute (the session property): DOUBLE columns scan as float32
from a second per-table cache that holds them alone (scan_batch),
expressions follow jnp's promotion (functions/decimals.py
jax_float_promote, true_div), sums accumulate as the reference's do (the
fused prepass in f64 from rows stacked as f32, through
fused_group_sums' f32-input entry on the card, one fusable aggregate
enough; the global and grouped segment sums in f32), f32 keys order as
the reference's CPU path does, and writes store the f32-rounded values.

The plan node SpatialJoin (`_exec_spatialjoin`, dynamic executor alone:
the static one raises StaticFallback, as the reference's does): grid
candidates on the host and the exact predicate on the device
(functions/geospatial.py), the matches gathered through
kernels.gather_batch.  The aggregates of functions/ml.py (ML_AGGS:
learn_classifier, learn_regressor, evaluate_classifier_predictions and
classification_*), built on the host from the rows (exec/host_aggs.py),
dynamic executor alone.

Not ported yet, and raising NotImplementedError when reached: chunked
and distributed execution, batched compiled execution, PREPARE,
EXECUTE, DEALLOCATE and DESCRIBE INPUT/OUTPUT (the serving tier),
materialized views, EXPLAIN (TYPE DISTRIBUTED), EXPLAIN ANALYZE under
execution_mode "compiled", writes to file connectors and streamed
writes (exec/writer.py), and the $hll_* / $kll_* states of chunked and
distributed execution.  Not ported either, and changing no
result: sort-order materialization (it serves chunked
execution), runtime-domain stripe pruning (df_splits_pruned: its tables
are not ported), the host summaries of the cluster side channel, spill
degradation and adaptive partial aggregation.
"""

from __future__ import annotations

import dataclasses
import math
import re
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from presto_tpu_torch import session_ctx
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import (Batch, Column, Dictionary,
                                    batch_from_numpy, column_from_numpy,
                                    decode_host_column, to_numpy, upload)
from presto_tpu_torch.exec import collections as CL
from presto_tpu_torch.exec import compile_cache as CC
from presto_tpu_torch.exec import dec128 as D128
from presto_tpu_torch.exec import host_aggs as HA
from presto_tpu_torch.exec import kernels as K
from presto_tpu_torch.exec.colval import (LambdaVal, StaticFallback,
                                          static_pass, translate_codes)
from presto_tpu_torch.exec.compiler import (EvalContext, eval_expr,
                                            eval_predicate, python_value,
                                            to_column)
from presto_tpu_torch.exec.window import execute_window
from presto_tpu_torch.functions import decimals as DEC
from presto_tpu_torch.functions import tdigest as TD
from presto_tpu_torch.functions.scalar import (_colval_from_pylist,
                                               _pylist_from_colval,
                                               torch_dtype)
from presto_tpu_torch.plan import ir
from presto_tpu_torch.plan import nodes as P
from presto_tpu_torch.plan import runtime_filters as RF
from presto_tpu_torch.plan.optimizer import optimize
from presto_tpu_torch.plan.planner import Planner
from presto_tpu_torch.session import QueryResult
from presto_tpu_torch.sql import ast
from presto_tpu_torch.sql.parser import parse


class ExecutionError(Exception):
    pass


#: the QueryStats counters this executor fills (reference:
#: presto_tpu/exec/executor.py _merge_sort_stats)
SORT_STATS_KEYS = ("sorts_taken", "sorts_elided", "sort_memo_hits",
                   "ordering_guard_trips", "df_filters_produced",
                   "df_filters_applied", "df_rows_pruned")


#: the moment aggregates _agg_column computes from two grouped sums
_VARIANCE_AGGS = ("stddev", "stddev_samp", "stddev_pop", "variance",
                  "var_samp", "var_pop")

#: the bivariate aggregates, from five grouped co-moment sums; Presto's
#: argument order is (y, x)
_BIVARIATE_AGGS = ("corr", "covar_samp", "covar_pop", "regr_slope",
                   "regr_intercept")

#: the aggregates that return an ARRAY or a MAP a group, built on the
#: host from the rows (exec/collections.py) in the dynamic executor
#: alone: the static one raises StaticFallback, as the reference does
COLLECTION_AGGS = frozenset((
    "array_agg", "map_agg", "multimap_agg", "histogram",
    "numeric_histogram", "map_union", "set_agg", "set_union"))

#: the aggregates whose states are sketches (serialized blobs) or other
#: host values, built on the host from the rows (exec/host_aggs.py) in
#: the dynamic executor alone, as COLLECTION_AGGS are
HOST_AGGS = frozenset((
    "approx_set", "merge", "qdigest_agg", "tdigest_agg", "map_union_sum",
    "approx_most_frequent", "reduce_agg"))

#: the aggregates of functions/ml.py: a model trained per group, and the
#: evaluation summaries, built on the host from the rows
#: (exec/host_aggs.py) in the dynamic executor alone, as COLLECTION_AGGS
#: are
ML_AGGS = frozenset((
    "learn_classifier", "learn_regressor", "evaluate_classifier_predictions",
    "classification_miss_rate", "classification_fall_out",
    "classification_precision", "classification_recall",
    "classification_thresholds"))

#: every aggregate _agg_column computes
PORTED_AGGS = frozenset((
    "count", "count_if", "sum", "avg", "min", "max", *_VARIANCE_AGGS,
    "approx_distinct", "approx_count", "approx_sum", "checksum",
    "approx_percentile", "min_by", "max_by", "geometric_mean",
    "arbitrary", "any_value", "bool_and", "every", "bool_or",
    *_BIVARIATE_AGGS, "skewness", "kurtosis", "entropy",
    "bitwise_and_agg", "bitwise_or_agg", *COLLECTION_AGGS, *HOST_AGGS,
    *ML_AGGS))


def _merge_sort_stats(stats, counts: dict) -> None:
    """Add an executor's ordering and dynamic-filtering counters to a
    QueryStats."""
    for k in SORT_STATS_KEYS:
        setattr(stats, k, getattr(stats, k, 0) + int(counts.get(k, 0)))


def execute_query(session, text: str) -> QueryResult:
    """Query lifecycle wrapper: stats around the dispatch."""
    from presto_tpu_torch.observe.stats import QueryMonitor

    mon = QueryMonitor.begin(session, text)
    session_ctx.activate(session)
    try:
        with CC.recording(mon.stats):
            with mon.phase("parse"):
                stmt = parse(text)
            result = _dispatch_statement(session, text, stmt, mon)
        mon.finish(result)
        result.stats = mon.stats
        return result
    except BaseException as e:
        mon.fail(e)
        raise


#: the prefix of materialized views' backing tables, which SHOW TABLES
#: leaves out (reference: presto_tpu/exec/matview.py MV_PREFIX)
MV_PREFIX = "__mv__"

_OK = ([("result", T.BOOLEAN)], [(True,)])


def _dispatch_statement(session, text: str, stmt, mon) -> QueryResult:
    if isinstance(stmt, (ast.Prepare, ast.Execute, ast.Deallocate,
                         ast.DescribeInput, ast.DescribeOutput)):
        raise NotImplementedError(
            f"{type(stmt).__name__} goes through the serving tier "
            "(server/serving.py), which is not ported to presto_tpu_torch")
    if isinstance(stmt, (ast.CreateMaterializedView,
                         ast.RefreshMaterializedView,
                         ast.DropMaterializedView,
                         ast.ShowMaterializedViews)):
        raise NotImplementedError(
            f"{type(stmt).__name__} needs materialized views "
            "(exec/matview.py), which are not ported to presto_tpu_torch")
    if isinstance(stmt, ast.TransactionStatement):
        if stmt.action == "START":
            session.txn.begin(stmt.read_only)
        elif stmt.action == "COMMIT":
            session.txn.commit()
        else:
            session.txn.rollback()
        return QueryResult(*_OK)
    if isinstance(stmt, ast.SetSession):
        session.access_control.check_can_set_session_property(
            session.user, stmt.name)
        session.set(stmt.name, stmt.value)
        return QueryResult(*_OK)
    if isinstance(stmt, ast.ShowTables):
        rows = sorted((t,) for t in session.catalog.tables
                      if not t.startswith(MV_PREFIX))
        return QueryResult([("Table", T.VARCHAR)], rows)
    if isinstance(stmt, ast.ShowColumns):
        from presto_tpu_torch.exec.writer import describe_extra_rows

        t = session.catalog.get(stmt.table)
        rows = [(c, str(ty)) for c, ty in t.schema.items()]
        rows += describe_extra_rows(t)
        return QueryResult([("Column", T.VARCHAR), ("Type", T.VARCHAR)], rows)
    if isinstance(stmt, ast.ShowFunctions):
        from presto_tpu_torch.functions import aggregate as _agg
        from presto_tpu_torch.functions import scalar as _sc

        rows = sorted(
            [(n, "scalar") for n in _sc.REGISTRY if not n.startswith("$")]
            + [(n, "aggregate") for n in _agg.AGG_NAMES]
            + [(n, "window") for n in _agg.WINDOW_ONLY])
        return QueryResult(
            [("Function", T.VARCHAR), ("Type", T.VARCHAR)], rows)
    if isinstance(stmt, ast.ShowSession):
        rows = sorted((k, str(v)) for k, v in session.properties.items())
        return QueryResult(
            [("Name", T.VARCHAR), ("Value", T.VARCHAR)], rows)
    if isinstance(stmt, ast.ShowCatalogs):
        rows = sorted((q,) for q in session.catalog.known_qualifiers)
        return QueryResult([("Catalog", T.VARCHAR)], rows)
    if isinstance(stmt, ast.ShowSchemas):
        schemas = {"default"}
        for name in session.catalog.tables:
            parts = name.split(".")
            if len(parts) >= 2:
                schemas.add(parts[-2])
        return QueryResult([("Schema", T.VARCHAR)],
                           sorted((s,) for s in schemas))
    if isinstance(stmt, ast.ShowStats):
        # per-column connector statistics and the row-count summary row
        # (reference: ShowStatsRewrite)
        t = session.catalog.get(stmt.table)
        rows = []
        for c in t.schema:
            st = t.column_stats(c)
            rows.append((c,
                         float(st.ndv) if st is not None
                         and st.ndv is not None else None,
                         st.min if st is not None else None,
                         st.max if st is not None else None,
                         None))
        rows.append((None, None, None, None, float(t.row_count())))
        return QueryResult(
            [("column_name", T.VARCHAR),
             ("distinct_values_count", T.DOUBLE),
             ("low_value", T.DOUBLE), ("high_value", T.DOUBLE),
             ("row_count", T.DOUBLE)], rows)
    if isinstance(stmt, ast.Explain):
        if stmt.analyze:
            text_plan = explain_analyze_text(session, stmt.statement, mon)
        elif stmt.type_ == "VALIDATE":
            plan_statement(session, stmt.statement)  # analysis only
            return QueryResult([("Valid", T.BOOLEAN)], [(True,)])
        elif stmt.type_ == "DISTRIBUTED":
            raise NotImplementedError(
                "EXPLAIN (TYPE DISTRIBUTED) waits for distributed "
                "execution, which is not ported to presto_tpu_torch")
        else:
            text_plan = explain_text(session, stmt.statement)
        return QueryResult([("Query Plan", T.VARCHAR)], [(text_plan,)])
    if isinstance(stmt, (ast.CreateTableAs, ast.InsertInto)):
        # the PageSink write pipeline (exec/writer.py)
        from presto_tpu_torch.exec import writer as W

        return W.run_write(session, text, stmt, mon)
    if isinstance(stmt, ast.ShowCreateTable):
        from presto_tpu_torch.exec import writer as W

        t = session.catalog.get(stmt.table)
        return QueryResult([("Create Table", T.VARCHAR)],
                           [(W.render_create_table(t),)])
    if isinstance(stmt, ast.CreateTable):
        session.access_control.check_can_create_table(session.user, stmt.name)
        if stmt.name in session.catalog:
            if stmt.if_not_exists:
                return QueryResult(*_OK)
            raise ExecutionError(f"Table '{stmt.name}' already exists")
        schema = {c: T.parse_type(t) for c, t in stmt.columns}
        session.txn.record_create(stmt.name)
        _create_table(session, stmt.name, schema, stmt.properties)
        return QueryResult(*_OK)
    if isinstance(stmt, ast.DropTable):
        session.access_control.check_can_drop_table(session.user, stmt.name)
        if stmt.name in session.catalog:
            session.txn.record_drop(session.catalog.get(stmt.name))
        session.catalog.drop(stmt.name, stmt.if_exists)
        return QueryResult(*_OK)
    if isinstance(stmt, ast.Delete):
        n = _delete_from(session, stmt)
        return QueryResult([("rows", T.BIGINT)], [(n,)])
    if not isinstance(stmt, ast.QueryStatement):
        raise NotImplementedError(
            f"{type(stmt).__name__} statements are not ported to "
            "presto_tpu_torch")
    props = session.properties
    if props.get("distributed", False):
        raise NotImplementedError("distributed execution is not ported")
    mode = props.get("execution_mode", "auto")
    if mode == "chunked":
        raise NotImplementedError("execution_mode=chunked is not ported")
    if mode not in ("auto", "compiled", "dynamic"):
        raise ValueError(f"unknown execution_mode {mode!r}")
    if mode in ("auto", "compiled"):
        try:
            with mon.phase("execute"):
                mon.stats.execution_mode = "compiled"
                return run_compiled(session, text, stmt, mon=mon)
        except StaticFallback as e:
            if mode == "compiled":
                raise StaticFallback(str(e)) from e
    mon.stats.execution_mode = "dynamic"
    with mon.phase("plan"):
        plan = plan_statement(session, stmt)
    with mon.phase("execute"):
        return Executor(session, monitor=mon).run(plan)


def _create_table(session, name, schema, properties):
    """Create and register an empty memory table (reference:
    per-connector metadata.createTable; CTAS and INSERT go through
    exec/writer.py).  Declared layout properties record onto the empty
    table, so that later INSERTs apply and verify them."""
    from presto_tpu_torch.exec import writer as W

    connector = W.target_connector(properties)
    try:
        t, _ = W.build_target_table(session, name, schema, properties)
        wp = W.WriteProperties.parse(properties, schema, connector)
    except W.WriteError as e:
        raise ExecutionError(str(e)) from e
    if wp is not None:
        t.record_write_properties(wp.to_dict(), ordered=False)
    session.catalog.register(t)


def _delete_from(session, stmt: ast.Delete) -> int:
    """DELETE FROM t [WHERE pred]: evaluate the predicate over the whole
    table (a scan and project plan, row order kept) and hand the keep
    mask to the table (reference: MetadataDeleteOperator)."""
    session.access_control.check_can_delete(session.user, stmt.table)
    table = session.catalog.get(stmt.table)
    if not hasattr(table, "delete_where"):
        raise ExecutionError(f"table '{stmt.table}' does not support DELETE")
    session.txn.record_table_write(table)
    n = table.row_count()
    if stmt.where is None:
        return table.delete_where(np.zeros(n, dtype=bool))
    q = ast.Query(
        body=ast.QuerySpec(
            select=[ast.SelectItem(stmt.where, "__pred__")],
            from_=ast.Table(stmt.table)))
    arrays, _types = execute_plan_to_host(session, ast.QueryStatement(q))
    pred = next(iter(arrays.values()))
    if isinstance(pred, np.ma.MaskedArray):
        pred = pred.filled(False)
    keep = ~np.asarray(pred, dtype=bool)  # NULL predicate rows are kept
    return table.delete_where(keep)


def execute_plan_to_host(session, stmt):
    """Run a query in the dynamic executor and return its columns as
    host arrays (NULLs masked) with their types; duplicate names take a
    suffix `_i`."""
    from presto_tpu_torch.exec import writer as W

    plan = plan_statement(session, stmt)
    batch = Executor(session).evaluate(plan)
    out = plan.root
    arrays, sel = to_numpy(batch)
    out_types = dict(out.source.outputs())
    types = {}
    result = {}
    used = {}
    for name, sym in zip(out.names, out.symbols):
        n = name
        i = used.get(name, 0)
        used[name] = i + 1
        if i:
            n = f"{name}_{i}"
        # keep the mask: write sinks must see NULLs to reject them
        result[n] = W.host_column(arrays[sym][sel])
        types[n] = out_types.get(sym, T.VARCHAR)
    return result, types


def explain_text(session, stmt) -> str:
    """EXPLAIN: the optimized plan with estimated rows a node."""
    from presto_tpu_torch.plan import stats as S

    plan = plan_statement(session, stmt)
    memo = {}

    def ann(node):
        try:
            st = S.derive(node, session.catalog, memo)
            return f"  {{rows: {st.est_rows:,.0f}}}"
        except Exception:
            return ""

    lines = [P.plan_tree_str(plan.root, annotate=ann)]
    for pid, sub in sorted(plan.subplans.items()):
        lines.append(f"\nSubplan {pid}:")
        lines.append(P.plan_tree_str(sub, 1, annotate=ann))
    return "\n".join(lines)


def explain_analyze_text(session, stmt, mon) -> str:
    """EXPLAIN ANALYZE in "auto" and "dynamic": run the statement in the
    dynamic executor with per-node stats and render the plan with each
    node's rows and time (reference: ExplainAnalyzeOperator).  The
    reference's compiled form reads XLA's cost analysis off the
    executable, which has no CUDA-graph counterpart here yet."""
    from presto_tpu_torch.observe.stats import annotated_plan

    mode = str(session.properties.get("execution_mode", "auto"))
    if mode == "chunked":
        raise NotImplementedError("execution_mode=chunked is not ported")
    if mode == "compiled":
        raise NotImplementedError(
            "EXPLAIN ANALYZE under execution_mode='compiled' reads XLA's "
            "cost analysis in presto_tpu, which has no counterpart in "
            "presto_tpu_torch yet")
    mon.stats.execution_mode = "dynamic"
    mon.collect_node_stats = True  # ANALYZE implies per-node stats
    with mon.phase("plan"):
        plan = plan_statement(session, stmt)
    with mon.phase("execute"):
        result = Executor(session, monitor=mon).run(plan)
    mon.stats.output_rows = len(result)
    mon.rows_preset = True  # finish() must not count the plan text's row
    return annotated_plan(plan.root, plan.subplans, mon.stats)


def _collect_tablescans(node: P.PlanNode, out: list):
    if isinstance(node, P.TableScan):
        out.append(node)
    for s in node.sources:
        _collect_tablescans(s, out)


def _static_root_bound(node: P.PlanNode):
    """Row bound of the plan root when provable (TopN/Limit under
    Output/Project): the compiled query then compacts its output to that
    many rows on the device before the fetch."""
    while isinstance(node, (P.Output, P.Project)):
        node = node.source
    if isinstance(node, (P.TopN, P.Limit)) and node.count <= 1_000_000:
        return int(node.count)
    return None


def _compact_batch(out: Batch, bound: int) -> Batch:
    """Order-preserving compaction to a fixed capacity on the device: a
    top-k over a positional score finds the first `bound` live rows
    (torch.topk, the library call the reference makes as
    jax.lax.top_k).  The indices ascend, so the gather is presorted."""
    cap = out.capacity
    pos = torch.arange(cap, dtype=torch.int32, device=out.device)
    score = torch.where(out.sel, cap - pos, 0)  # earliest live = largest
    top = torch.topk(score, bound).values
    idx = (cap - top).clamp(0, cap - 1)
    count = out.sel.sum()
    raw, _ = K.take_columns(out.columns, idx, presorted=True)
    cols = {n: Column(data, valid, out.columns[n].type,
                      out.columns[n].dictionary)
            for n, (data, valid) in raw.items()}
    return Batch(cols, torch.arange(bound, device=out.device) < count)


# results larger than this skip pack_fetch for to_numpy's selective
# fetch (batch.py's _COMPACT_THRESHOLD)
_PACK_FETCH_MAX = 262_144

#: functions whose value must differ between executions of the same
#: text: a compiled query bakes them in, so such queries key the memo
#: per execution
_VOLATILE_RE = re.compile(
    r"\b(?:now|random|rand|uuid|shuffle)\s*\("
    r"|\bcurrent_(?:date|time|timestamp)\b|\blocaltime(?:stamp)?\b"
    r"|\btablesample\b",
    re.IGNORECASE)


def _volatile_nonce(text: str) -> int:
    """0 for deterministic queries (one executable for every run); the
    per-query sequence number otherwise (every run builds anew)."""
    if _VOLATILE_RE.search(text) is None:
        return 0
    return session_ctx.query_seq()


def query_cache_key(session, text: str) -> tuple:
    """The session memo's key: raw text x catalog version x the whole
    property map x the volatile nonce."""
    return (text, getattr(session.catalog, "version", 0),
            tuple(sorted((k, repr(v))
                         for k, v in session.properties.items())),
            _volatile_nonce(text))


def run_compiled(session, text: str, stmt, mon=None) -> QueryResult:
    """Compiled execution: the whole plan runs in the static executor
    (capacities from connector stats, guards for every static
    assumption, one packed fetch), built once per session and text by
    compile_cache.build_graph (on a CUDA device one captured CUDA graph,
    replayed on every later run).  Scalar subqueries run first in the
    dynamic executor and are baked in, as the reference's are.  A
    tripped guard reruns the query in the dynamic executor and marks the
    text "DYNAMIC", so that later runs go there directly; a
    StaticFallback while building propagates to the caller."""
    cache = getattr(session, "_compiled_cache", None)
    if cache is None:
        cache = session._compiled_cache = CC.GraphMemo(0, 0)
    cache.max_bytes = CC.memo_bound(session)
    cache.max_entries = CC.MEMO_MAX_ENTRIES
    key = query_cache_key(session, text)
    entry = cache.get(key)
    if entry == "DYNAMIC":  # static assumptions known to fail here
        return Executor(session, monitor=mon).run(
            plan_statement(session, stmt))
    if entry is None:
        plan = plan_statement(session, stmt)
        if _plan_has_long_decimal(plan.root):
            # long-decimal limbs do not pack through the compiled fetch:
            # the dynamic executor carries them exactly, as the
            # reference's does
            cache.put(key, "DYNAMIC")
            return Executor(session, monitor=mon).run(plan)
        # the build's counters (the scalar subqueries' dynamic runs and
        # the static program's decisions) go into every run's stats,
        # memo hits included, as the reference's do
        sort_counts: dict = {}
        ex0 = Executor(session, sort_stats=sort_counts)
        scalar_results = ex0.ctx.scalar_results
        for pid, sub in sorted(plan.subplans.items()):
            scalar_results[pid] = _single_value(ex0.exec_node(sub))
        scan_nodes: list = []
        _collect_tablescans(plan.root, scan_nodes)
        bound = _static_root_bound(plan.root)
        f32 = bool(session.properties.get("float32_compute", False))
        batches = [scan_batch(session.catalog.get(n.table), n,
                              session.device, f32) for n in scan_nodes]
        # the fetch layout and whether a root column has another length
        # than the root, set by every run
        meta_box: list = []
        counts_box: list = [sort_counts]  # the counters, set by every run

        def program(*batches):
            batches = [_leaf_views(b) for b in batches]
            counts = dict(sort_counts)
            counts_box[:] = [counts]
            ex = Executor(session, static=True,
                          scan_inputs={id(n): b for n, b
                                       in zip(scan_nodes, batches)},
                          sort_stats=counts)
            ex.ctx.scalar_results = scalar_results
            with static_pass(ex.guards):
                out = ex.exec_node(plan.root)
            if bound is not None and out.capacity > 4 * bound:
                out = _compact_batch(out, bound)
            guard = torch.stack([g.reshape(()) for g in ex.guards]).any() \
                if ex.guards else torch.zeros((), dtype=torch.bool,
                                              device=session.device)
            ragged = any(c.data.shape[0] != out.capacity
                         for c in out.columns.values())
            if out.capacity > _PACK_FETCH_MAX or ragged or any(
                    c.data.ndim > 1 for c in out.columns.values()):
                # a root over a scan-sized capacity: to_numpy's selective
                # fetch pulls only the live rows (and a column of another
                # length, a constant point or feature row, raises there
                # as the reference's fetch does)
                meta_box[:] = [None, ragged]
                return out, guard
            (buf, side), meta = K.pack_fetch(out, guard)
            meta_box[:] = [meta, False]
            flat = K.flat_fetch(buf, side)
            return flat, flat[buf.shape[0] - 1] != 0

        exe = CC.build_graph(program, tuple(batches), session.device)
        entry = (plan, exe, scan_nodes, meta_box, batches, counts_box)
    else:
        CC.note("compile_cache_hits")
    plan, exe, _scan_nodes, meta_box, _batches, counts_box = entry
    out, guard = exe()
    if mon is not None:
        _merge_sort_stats(mon.stats, counts_box[0])
    meta, ragged = meta_box
    ex = Executor(session)
    if meta is None:
        tripped = bool(guard)
        try:
            result = None if tripped else ex.run_batch(plan, out)
        except IndexError:
            if ragged:
                # the reference memoizes its executable before the fetch
                # that raises on a column of another length
                cache.put(key, entry, exe.pool_bytes, exe)
            raise
    else:
        datas, sel, tripped = K.unpack_fetch(
            K.split_flat_fetch(out.cpu().numpy(), meta), meta)
        result = None if tripped else ex.materialize_host(plan, meta,
                                                          datas, sel)
    if tripped:
        # the data is static, so the guard would trip again: go straight
        # to the dynamic executor from now on
        cache.put(key, "DYNAMIC")
        return Executor(session, monitor=mon).run(
            plan_statement(session, stmt))
    held = exe.pool_bytes + sum(b.sel.nbytes for b in entry[4]) + sum(
        t.nbytes for t in (exe.keep.tensors.values() if exe.keep else ()))
    cache.put(key, entry, held, exe)
    return result


def _plan_has_long_decimal(node) -> bool:
    """Whether any node of the plan outputs a long decimal (reference:
    _plan_has_long_decimal)."""
    for _s, t in node.outputs():
        if DEC.is_long(t):
            return True
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, P.PlanNode) and _plan_has_long_decimal(v):
            return True
        if isinstance(v, list) and any(
                isinstance(x, P.PlanNode) and _plan_has_long_decimal(x)
                for x in v):
            return True
    return False


def plan_statement(session, stmt) -> P.QueryPlan:
    """Plan, optimize and authorize: every table the plan scans is
    checked against the session's access control (reference:
    AccessControlManager.checkCanSelectFromColumns)."""
    if isinstance(stmt, (ast.CreateTableAs, ast.InsertInto)):
        # Output <- TableFinish <- TableWriter over the query's plan
        from presto_tpu_torch.exec import writer as W

        return W.plan_write_statement(session, stmt)
    plan = Planner(session).plan_statement(stmt)
    if session.properties.get("optimizer_enabled", True):
        plan = optimize(plan, session)
    scans: list = []
    _collect_tablescans(plan.root, scans)
    for sub in plan.subplans.values():
        _collect_tablescans(sub, scans)
    for t in {n.table for n in scans}:
        session.access_control.check_can_select(session.user, t)
    return plan


class Executor:
    def __init__(self, session, static: bool = False, scan_inputs=None,
                 monitor=None, sort_stats=None):
        self.session = session
        self.device = session.device
        # static: the compiled mode's executor -- capacities fixed by the
        # planner's statistics, no host read, every static assumption a
        # device bool in `guards` (True: rerun in the dynamic executor)
        self.static = static
        self.scan_inputs = scan_inputs  # {id(TableScan): Batch}
        self.guards: List[torch.Tensor] = []
        self.monitor = monitor  # QueryMonitor collecting per-node stats
        # a write's WriteContext, set by exec/writer.run_write: the sink
        # TableWriter appends to and TableFinish commits
        self.write_ctx = None
        self.ctx = EvalContext()
        # plan DAGs (transitive semi-join inference shares a filter
        # subquery between both join sides) run each shared node once
        self._shared_results: Dict[int, tuple] = {}
        # ordering-aware execution (plan/properties.py):
        # - the counters, merged into QueryStats (SORT_STATS_KEYS)
        # - the sort memo (packed key -> (skey, order)), the permutation
        #   memo (Sort/TopN keys -> perm) and the group-id memo (packed
        #   key -> (gid, rep_rows, n_groups)), each keyed by the
        #   identity of its source tensors (_key_fp) and holding them
        #   alive, so that a recycled id() never aliases a dead entry
        # - the orderings this executor built itself: id(Batch) ->
        #   (batch, ((symbol, asc), ...), tail_ok), the only claims that
        #   Sort and TopN elision trust without a guard
        self.sort_stats = sort_stats if sort_stats is not None else {}
        self._sort_memo: Dict[tuple, tuple] = {}
        self._perm_memo: Dict[tuple, tuple] = {}
        self._gid_memo: Dict[tuple, tuple] = {}
        self._batch_order: Dict[int, tuple] = {}
        # dynamic filtering (plan/runtime_filters.py): filter id -> the
        # build keys' device summary (kernels.rf_build), registered by a
        # producer join before its probe subtree runs
        self._rf: Dict[str, dict] = {}

    # ---- ordering-aware execution and dynamic filtering --------------
    def _count(self, key: str, n: int = 1) -> None:
        self.sort_stats[key] = self.sort_stats.get(key, 0) + n

    def _ordering_enabled(self) -> bool:
        return bool(self.session.properties.get(
            "ordering_aware_execution", True))

    def _df_enabled(self) -> bool:
        return RF.enabled(self.session)

    def _rf_build_complete(self, node) -> bool:
        """May this executor derive a filter from the join's build batch:
        is that batch the whole build key set?  Always, on one device (a
        sharded executor sees a part and must not)."""
        return True

    def _rf_register(self, specs, right: Batch) -> None:
        """Producer side: summarize and register one join's build keys.
        A key the kernels cannot summarize (dictionary codes, floats,
        matrix-shaped data) registers nothing, and its consumer scan
        then runs unfiltered."""
        for spec in specs:
            col = right.columns.get(spec["build_sym"])
            if col is None or col.dictionary is not None \
                    or col.data.ndim != 1 or col.data.is_floating_point():
                continue
            live = right.sel
            if col.valid is not None:
                live = live & col.valid
            self._rf[spec["fid"]] = K.rf_build(col, live)
            self._count("df_filters_produced")

    def _rf_apply(self, node: P.TableScan, b: Batch) -> Batch:
        """Consumer side: AND each registered filter's mask into the
        scan's sel.  An id nobody registered is skipped: dynamic
        filtering never changes a result.  The dynamic executor counts
        the pruned rows (one host read); the static executor reads
        nothing and counts the filters alone."""
        specs = getattr(node, "rf_consume", None)
        if not specs or not self._df_enabled():
            return b
        sel = b.sel
        applied = False
        for spec in specs:
            summary = self._rf.get(spec["fid"])
            if summary is None:
                continue
            col = b.columns.get(spec["sym"])
            if col is None or col.dictionary is not None \
                    or col.data.ndim != 1 or col.data.is_floating_point():
                continue
            mask = K.rf_probe(summary, col)
            if self.static:
                sel = sel & mask
            else:
                sel2 = sel & mask
                before, after = torch.stack([sel.sum(), sel2.sum()]).tolist()
                self._count("df_rows_pruned", before - after)
                sel = sel2
            self._count("df_filters_applied")
            applied = True
        if not applied:
            return b
        out = b.with_sel(sel)
        # masking moves no row, but punches holes
        self._copy_order(b, out, tail_ok=False)
        return out

    def _key_fp(self, cols, sel, layout):
        """(fingerprint, refs) of a packed key: the identity of its source
        tensors and its layout, the memos' key.  refs go into the memo
        entry to keep the tensors alive.  None: not fingerprintable
        (matrix-shaped data)."""
        parts = []
        refs = [sel]
        for c in cols:
            d = c.data
            if d.ndim != 1:
                return None, ()
            parts.append((id(d), None if c.valid is None else id(c.valid)))
            refs.append(d)
            if c.valid is not None:
                refs.append(c.valid)
        lay = None if layout is None else tuple(tuple(x) for x in layout)
        return (tuple(parts), id(sel), lay), tuple(refs)

    def _memo_pair(self, key, fp, refs):
        """(skey, order) of a packed key through the sort memo: a later
        grouping or join on the same key replays the permutation."""
        if not self._ordering_enabled():
            fp = None  # the switch turns the memo off too
        entry = self._sort_memo.get(fp) if fp is not None else None
        if entry is not None:
            self._count("sort_memo_hits")
            self._count("sorts_elided")
            return entry[1]
        self._count("sorts_taken")
        pair = K.sort_pair(key)
        if fp is not None:
            self._sort_memo[fp] = (refs, pair)
        return pair

    def _note_order(self, batch: Batch, keys, tail_ok: bool = True) -> None:
        """Record an ordering this executor built: the live rows of
        `batch` sorted on `keys` ((symbol, asc), ...).  tail_ok: masked
        rows sit in a suffix, so the whole packed key is nondecreasing
        (what a presorted join build needs); after a filter only the
        live rows are in order, which Sort and TopN elision need."""
        if keys:
            self._batch_order[id(batch)] = (batch, tuple(keys), tail_ok)

    def _copy_order(self, src: Batch, dst: Batch, tail_ok=None) -> None:
        e = self._batch_order.get(id(src))
        if e is not None and e[0] is src:
            self._note_order(dst, e[1],
                             e[2] if tail_ok is None else (e[2] and tail_ok))

    def _order_satisfies(self, b: Batch, want) -> bool:
        """Does the ordering this executor built for `b` satisfy the sort
        keys `want` ((symbol, asc, nulls_first), ...)?  They must be a
        prefix of it, over columns without NULLs (a packed order puts
        the NULL group first, which SQL's defaults need not)."""
        e = self._batch_order.get(id(b))
        if e is None or e[0] is not b:
            return False
        have = e[1]
        if len(want) > len(have):
            return False
        for (sym, asc, _nf), (hsym, hasc) in zip(want, have):
            if sym != hsym or bool(asc) != bool(hasc):
                return False
            col = b.columns.get(sym)
            if col is None or col.valid is not None:
                return False
        return True

    def _build_order_certain(self, node, right: Batch, rkeys) -> bool:
        """This executor built `right` sorted on the join key with its
        masked rows in a suffix (a grouped output joined on its leading
        group key, for one)."""
        if len(node.criteria) != 1 or rkeys[0].valid is not None:
            return False
        e = self._batch_order.get(id(right))
        if e is None or e[0] is not right or not e[2]:
            return False
        keys = e[1]
        return bool(keys) and keys[0] == (node.criteria[0][1], True)

    def _build_presorted(self, node, right: Batch, rkeys) -> bool:
        if len(node.criteria) != 1:
            return False
        return bool(getattr(node, "build_ordering_hint", False)) \
            or self._build_order_certain(node, right, rkeys)

    # ------------------------------------------------------------------
    def run(self, plan: P.QueryPlan) -> QueryResult:
        if self.monitor is not None:
            self.monitor.plan = plan
        try:
            return self.run_batch(plan, self.evaluate(plan))
        finally:
            if self.monitor is not None:
                _merge_sort_stats(self.monitor.stats, self.sort_stats)

    def run_batch(self, plan: P.QueryPlan, batch: Batch) -> QueryResult:
        """The plan's result from its root's batch on the device."""
        arrays, sel = to_numpy(batch)
        return self._format_result(plan, arrays, sel)

    def materialize_host(self, plan: P.QueryPlan, meta: dict,
                         datas: Dict[str, tuple], sel) -> QueryResult:
        """The plan's result from an unpack_fetch (host numpy arrays)."""
        arrays = {}
        for name, _dtype_s, _words, _has_valid, typ, dic in meta["cols"]:
            data, valid = datas[name]
            arrays[name] = decode_host_column(data, valid, typ, dic)
        return self._format_result(plan, arrays, sel)

    def _format_result(self, plan: P.QueryPlan, arrays, sel) -> QueryResult:
        out = plan.root
        cols = []
        rows_data = []
        out_types = dict(out.source.outputs())
        for name, sym in zip(out.names, out.symbols):
            cols.append((name, out_types.get(sym, T.VARCHAR)))
            rows_data.append(arrays[sym][sel])
        rows = list(zip(*(_python_values(a) for a in rows_data)))
        return QueryResult(cols, rows)

    def evaluate(self, plan: P.QueryPlan) -> Batch:
        # scalar subplans first (dependency order is registration order)
        for pid, sub in sorted(plan.subplans.items()):
            self.ctx.scalar_results[pid] = _single_value(self.exec_node(sub))
        return self.exec_node(plan.root)

    # ------------------------------------------------------------------
    def exec_node(self, node: P.PlanNode) -> Batch:
        if not getattr(node, "shared_subtree", False):
            return self._exec_node_inner(node)
        hit = self._shared_results.get(id(node))
        if hit is not None and hit[0] is node:
            return hit[1]
        b = self._exec_node_inner(node)
        self._shared_results[id(node)] = (node, b)
        return b

    def _exec_node_inner(self, node: P.PlanNode) -> Batch:
        name = type(node).__name__
        method = getattr(self, f"_exec_{name.lower()}", None)
        if method is None:
            raise NotImplementedError(
                f"plan node {name} is not ported to presto_tpu_torch")
        if self.monitor is None or not self.monitor.collect_node_stats:
            return method(node)
        # per-node stats: the row count forces a device sync, which is
        # why collection is opt-in (reference: OperationTimer)
        t0 = time.perf_counter_ns()
        b = method(node)
        rows = int(b.row_count())
        self.monitor.record_node(node, rows, time.perf_counter_ns() - t0)
        return b

    # ---- leaves ------------------------------------------------------
    def _exec_tablescan(self, node: P.TableScan) -> Batch:
        if self.scan_inputs is not None:
            return self._rf_apply(node, self.scan_inputs[id(node)])
        return self._rf_apply(node, scan_batch(
            self.session.catalog.get(node.table), node, self.device,
            bool(self.session.properties.get("float32_compute", False))))

    def _exec_values(self, node: P.Values) -> Batch:
        """Literal rows (a SELECT without FROM, VALUES lists) as a batch
        on the session's device (reference: _exec_values)."""
        arrays, valids, types = {}, {}, {}
        collection_cols = {}
        n = len(node.rows)
        for j, (sym, t) in enumerate(zip(node.symbols, node.types_)):
            vals = [r[j] for r in node.rows]
            if t.name in ("ARRAY", "MAP", "ROW"):
                # folded constructors: a tuple dictionary like any column
                collection_cols[sym] = to_column(
                    _colval_from_pylist(vals, t), n, self.device)
                continue
            mask = np.asarray([v is not None for v in vals], dtype=bool)
            if t.is_string:
                arr = np.asarray([v if v is not None else "" for v in vals],
                                 dtype=object)
            else:
                arr = np.asarray([v if v is not None else 0 for v in vals],
                                 dtype=t.numpy_dtype())
            arrays[sym], types[sym] = arr, t
            if not mask.all():
                valids[sym] = mask
        b = batch_from_numpy(arrays, types, self.device, valids) if arrays \
            else Batch({}, torch.ones((n,), dtype=torch.bool,
                                      device=self.device))
        if collection_cols:
            b = Batch({**b.columns, **collection_cols}, b.sel)
        return b

    # ---- row-wise ----------------------------------------------------
    def _exec_filter(self, node: P.Filter) -> Batch:
        b = self.exec_node(node.source)
        out = b.with_sel(b.sel & eval_predicate(node.predicate, b, self.ctx))
        # masking moves no row, but punches holes
        self._copy_order(b, out, tail_ok=False)
        return out

    def _exec_project(self, node: P.Project) -> Batch:
        b = self.exec_node(node.source)
        cols = {sym: to_column(eval_expr(e, b, self.ctx), b.capacity,
                               self.device)
                for sym, e in node.assignments.items()}
        out = Batch(cols, b.sel)
        src = self._batch_order.get(id(b))
        if src is not None and src[0] is b:
            # row-wise: an ordering survives renames (Refs) up to its
            # first key that is not one
            renames = {}
            for sym, e in node.assignments.items():
                if isinstance(e, ir.Ref):
                    renames.setdefault(e.name, sym)
            mapped = []
            for sym, asc in src[1]:
                if sym not in renames:
                    break
                mapped.append((renames[sym], asc))
            self._note_order(out, tuple(mapped), tail_ok=src[2])
        return out

    # ---- aggregation -------------------------------------------------
    def _exec_aggregate(self, node: P.Aggregate) -> Batch:
        b = self.exec_node(node.source)
        if any(a.distinct for a in node.aggs.values()):
            return self._aggregate_with_distinct(node, b)
        return self._aggregate(b, node.group_keys, node.aggs, node)

    def _aggregate_with_distinct(self, node: P.Aggregate, b: Batch) -> Batch:
        """DISTINCT aggregates: pre-group by the keys plus the distinct
        argument, then run the plain aggregate over the deduplicated
        groups; the non-distinct aggregates run in a pass of their own
        (reference: presto_tpu/exec/executor.py
        _exec_aggregate_with_distinct).  Every pass numbers the same
        final groups in the same ascending key order, so their outputs
        line up column by column without a join."""
        distinct_aggs = {s: a for s, a in node.aggs.items() if a.distinct}
        plain_aggs = {s: a for s, a in node.aggs.items() if not a.distinct}
        if plain_aggs:
            pb = self._aggregate(b, node.group_keys, plain_aggs)
            db = self._aggregate_with_distinct(
                P.Aggregate(node.source, node.group_keys, distinct_aggs,
                            node.step), b)
            if pb.capacity != db.capacity:
                raise ExecutionError("distinct/plain group alignment failed")
            cols = {k: c for k, c in db.columns.items() if k not in node.aggs}
            for s in node.aggs:
                cols[s] = (db if s in distinct_aggs else pb).columns[s]
            return Batch(cols, db.sel)
        for a in distinct_aggs.values():
            if a.filter is not None:
                # the filter must apply before deduplication, and the
                # pre-group no longer carries its columns
                raise ExecutionError(
                    "DISTINCT aggregates with FILTER are not supported yet")
        by_col: Dict[str, Dict[str, ir.AggCall]] = {}
        for s, a in distinct_aggs.items():
            by_col.setdefault(a.args[0].name, {})[s] = a
        result = None
        for darg in sorted(by_col):
            pre = self._aggregate(b, node.group_keys + [darg], {})
            aggs2 = {}
            for s, a in by_col[darg].items():
                if a.fn in ("count", "approx_distinct"):
                    # the deduplicated pre-group counts exactly
                    aggs2[s] = ir.AggCall("count", a.args, a.type, False,
                                          a.filter)
                elif a.fn in ("sum", "avg", "array_agg", "min", "max"):
                    # over the deduplicated pre-group these equal their
                    # DISTINCT forms (array_agg's elements in the
                    # pre-group's ascending key order)
                    aggs2[s] = ir.AggCall(a.fn, a.args, a.type, False,
                                          a.filter)
                else:
                    raise NotImplementedError(
                        f"DISTINCT {a.fn} is not ported to presto_tpu_torch")
            db = self._aggregate(pre, node.group_keys, aggs2)
            if result is None:
                result = db
                continue
            if result.capacity != db.capacity:
                raise ExecutionError("distinct group alignment failed")
            cols = dict(result.columns)
            for s in aggs2:
                cols[s] = db.columns[s]
            result = Batch(cols, result.sel)
        return result

    @staticmethod
    def _agg_pack_order(node, group_keys):
        """Key pack order: a presorted-input hint rotates the sorted key
        run to the front (most significant), so the packed key is
        monotone whenever the claim holds; the guard verifies it."""
        order = getattr(node, "ordering_pack_order", None) \
            if node is not None else None
        if order is not None and sorted(order) == sorted(group_keys):
            return list(order)
        hint = getattr(node, "ordering_hint", None) if node is not None \
            else None
        if hint is not None and hint in group_keys:
            return [hint] + [k for k in group_keys if k != hint]
        return list(group_keys)

    def _aggregate(self, b: Batch, group_keys: List[str],
                   aggs: Dict[str, ir.AggCall],
                   node: Optional[P.Aggregate] = None) -> Batch:
        if not group_keys:
            return self._global_aggregate(b, aggs)
        if self.static:
            return self._aggregate_static(b, group_keys, aggs, node)
        pack_order = self._agg_pack_order(node, group_keys)
        pack_cols = [b.columns[k] for k in pack_order]
        key, layout = K.pack_keys(pack_cols, b.sel)
        gid = None
        if layout is not None and self._ordering_enabled() \
                and getattr(node, "ordering_hint", None) == pack_order[0]:
            # presorted grouping: one run-boundary scan in place of the
            # grouping sort and the unpermute; the guard and the group
            # count come back in one read, and a claim that lied falls
            # back to the sort path
            g2, newgrp, ng_t, guard = K.group_ids_presorted(key, b.sel)
            tripped, n_groups = torch.stack(
                [guard.to(torch.int64), ng_t.to(torch.int64)]).tolist()
            if not tripped:
                gid = g2
                rep_rows = K.nonzero_i32(newgrp, max(n_groups, 1),
                                         0)[:n_groups]
                self._count("sorts_elided", 2)
            else:
                self._count("ordering_guard_trips")
        if gid is None:
            fp, refs = self._key_fp(pack_cols, b.sel, layout)
            hit = self._gid_memo.get(fp) if fp is not None \
                and self._ordering_enabled() else None
            if hit is not None:
                # a second grouping over the same key tensors (a
                # distinct pre-pass, say) replays the whole mapping: the
                # grouping sort and the unpermute are both elided
                gid, rep_rows, n_groups = hit[1]
                self._count("sort_memo_hits")
                self._count("sorts_elided", 2)
            else:
                pair = self._memo_pair(key, fp, refs)
                self._count("sorts_taken")  # the unpermute
                gid, rep_rows, n_groups = K.group_ids(key, b.sel,
                                                      sorted_pair=pair)
                if fp is not None:
                    self._gid_memo[fp] = (refs, (gid, rep_rows, n_groups))
        out_cols: Dict[str, Column] = {}
        raw, _ = K.take_columns({k: b.columns[k] for k in group_keys},
                                rep_rows)
        for k, (data, valid) in raw.items():
            c = b.columns[k]
            out_cols[k] = Column(data, valid, c.type, c.dictionary)
        fused = self._fused_sum_aggs(b, aggs, gid, n_groups)
        order = K.GroupOrder(gid, n_groups)  # shared by the sums below
        for sym, a in aggs.items():
            out_cols[sym] = fused.get(sym) or self._agg_column(b, a, order)
        sel = torch.ones((max(n_groups, 0),), dtype=torch.bool,
                         device=self.device)
        out = Batch(out_cols, sel)
        if layout is not None:
            # an exact packing numbers the groups in ascending packed-key
            # order, lexicographic on pack_order, on either path
            self._note_order(out, tuple((k, True) for k in pack_order))
        return out

    # layouts this narrow use the packed key as the group id (no sort);
    # the key columns come back from slot arithmetic
    _DIRECT_GID_BITS = 12

    def _aggregate_static(self, b: Batch, group_keys: List[str],
                          aggs: Dict[str, ir.AggCall],
                          node: Optional[P.Aggregate]) -> Batch:
        """Grouping at the planner's capacity (`capacity_hint`), with a
        guard for each assumption: the keys inside their static layout
        and no more groups than the capacity.  A small layout groups
        directly by the packed key; live rows far below the capacity
        are compacted first, under a guard on the estimate."""
        cap = getattr(node, "capacity_hint", None) if node is not None \
            else None
        if cap is None:
            cap = b.capacity
        cap = min(cap, b.capacity) or 1
        est = getattr(node, "input_est_hint", None) if node is not None \
            else None
        b2 = self._maybe_compact_static(b, est)
        if b2 is not b:
            b = b2
            cap = min(cap, b.capacity)
        key_stats = getattr(node, "key_stats", {}) if node is not None \
            else {}
        pack_order = self._agg_pack_order(node, group_keys)
        pack_cols = [b.columns[k] for k in pack_order]
        layout = K.static_layout(pack_cols,
                                 [key_stats.get(k) for k in pack_order])
        key = K.pack_with_layout(pack_cols, b.sel, layout)  # None: hash
        if layout is not None:
            self.guards.append(K.layout_range_guard(pack_cols, b.sel,
                                                    layout))
            total_bits = sum(w for _, _, w in layout)
            if total_bits <= self._DIRECT_GID_BITS and not any(
                    c.data.is_floating_point() for c in pack_cols):
                return self._aggregate_direct(b, pack_order, pack_cols,
                                              aggs, key, layout, total_bits)
        if layout is not None and self._ordering_enabled() \
                and getattr(node, "ordering_hint", None) == pack_order[0] \
                and getattr(node, "ordering_hint_safe", False):
            # presorted grouping under a guard, for safe hints alone (the
            # other keys provably constant within a leading run): a trip
            # costs the whole compiled query
            gid, rep_rows, exists, overflow, guard = \
                K.group_ids_presorted_static(key, cap)
            self.guards.append(guard)
            self._count("sorts_elided", 2)
        else:
            fp, refs = self._key_fp(pack_cols, b.sel, layout)
            pair = self._memo_pair(key, fp, refs)
            self._count("sorts_taken")  # the unpermute
            gid, rep_rows, exists, overflow = K.group_ids_static(
                key, cap, sorted_pair=pair)
        self.guards.append(overflow)
        out_cols: Dict[str, Column] = {}
        raw, _ = K.take_columns({k: b.columns[k] for k in group_keys},
                                rep_rows)
        for k, (data, valid) in raw.items():
            c = b.columns[k]
            out_cols[k] = Column(data, None if valid is None
                                 else (valid & exists), c.type, c.dictionary)
        fused = self._fused_sum_aggs(b, aggs, gid, cap)
        order = K.GroupOrder(gid, cap)
        for sym, a in aggs.items():
            out_cols[sym] = fused.get(sym) or self._agg_column(b, a, order)
        out = Batch(out_cols, exists)
        if layout is not None:
            # the live groups ascend in a prefix; the dead slots behind
            # them hold sentinels
            self._note_order(out, tuple((k, True) for k in pack_order))
        return out

    def _aggregate_direct(self, b: Batch, group_keys, key_cols, aggs,
                          key, layout, total_bits: int) -> Batch:
        """Sort-free grouping for small static layouts: the packed key is
        the group id, a slot in [0, 2^total_bits), and each key column
        comes back from its slot's bits.  TPC-H Q1's grouping becomes one
        elementwise pass and the fused sums."""
        cap = 1 << total_bits
        # masked rows carry the key sentinel; the clamp sends them to
        # the dead slot `cap`
        gid = key.clamp(0, cap).to(torch.int32)
        order = K.GroupOrder(gid, cap)
        exists = K.segment_sum(b.sel.to(torch.int32), gid, cap, order) > 0
        slots = torch.arange(cap, dtype=torch.int64, device=self.device)
        out_cols: Dict[str, Column] = {}
        for k, c, (lo, stride, width) in zip(group_keys, key_cols, layout):
            code = (slots // stride) & ((1 << width) - 1)
            data = (code - 1 + lo).to(c.data.dtype)
            valid = None if c.valid is None else ((code != 0) & exists)
            out_cols[k] = Column(data, valid, c.type, c.dictionary)
        fused = self._fused_sum_aggs(b, aggs, gid, cap)
        for sym, a in aggs.items():
            out_cols[sym] = fused.get(sym) or self._agg_column(b, a, order)
        out = Batch(out_cols, exists)
        # slot order is packed-key order, but empty slots lie between
        # the live ones: not tail-masked
        self._note_order(out, tuple((k, True) for k in group_keys),
                         tail_ok=False)
        return out

    def _maybe_compact_static(self, b: Batch, est) -> Batch:
        """Compaction to a power-of-two bound from the planner's row
        estimate, under a guard that the live rows fit it: dropping
        masked rows never changes a result, and a wrong estimate sends
        the query to the dynamic executor."""
        if not self.static or est is None or b.capacity < (1 << 19):
            return b
        bound = 1 << max(int(np.ceil(np.log2(max(est, 1) * 2))), 14)
        if bound > min(b.capacity // 4, 1 << 20):
            return b
        self.guards.append(b.sel.to(torch.int32).sum() > bound)
        out = _compact_batch(b, bound)
        e = self._batch_order.get(id(b))
        if e is not None and e[0] is b:
            # compaction keeps the live rows in order and moves them to
            # a prefix: the ordering becomes tail-masked
            self._note_order(out, e[1], tail_ok=True)
        return out

    def _fused_sum_aggs(self, b: Batch, aggs: Dict[str, ir.AggCall],
                        gid, n_groups: int) -> Dict[str, Column]:
        """Prepass: compute all sum-shaped aggregates (count/count_if/
        sum/avg over DOUBLE) in ONE pass over the rows
        (kernels.fused_group_sums) instead of one scatter-add per
        aggregate.  Returns {} when not worthwhile; callers fall through
        to _agg_column per aggregate.

        The gate is the reference's: under float32_compute one fusable
        aggregate is enough, and so is one f32 value row.  The kernel
        sums in f64 on every device, as the reference's interpreter
        does; under the property, when every value row is f32, the rows
        are stacked as f32 (a mask row's 0 and 1 are exact there) and go
        to the kernel's f32-input entry, so that nothing makes an f64
        copy of them."""
        if not self.session.properties.get("pallas_fused_agg", True):
            return {}
        n = b.capacity
        if n < 32_768 or not (1 <= n_groups <= 4096) or len(aggs) < 1:
            return {}

        def fusable(a):
            if a.fn == "count" and not a.args:
                return True
            if a.fn == "count_if":
                return True
            if a.fn in ("sum", "avg", "partial_sum_double") and a.args:
                t = getattr(a.args[0], "type", None)
                return t is not None and t.name in ("DOUBLE", "REAL")
            return False

        chosen = {sym: a for sym, a in aggs.items() if fusable(a)}
        f32_mode = bool(self.session.properties.get("float32_compute",
                                                    False))
        if len(chosen) < (1 if f32_mode else 2):
            return {}
        rows: List[torch.Tensor] = []
        plan: Dict[str, tuple] = {}
        value_dtypes = set()
        for sym, a in chosen.items():
            mask = b.sel
            if a.filter is not None:
                mask = mask & eval_predicate(a.filter, b, self.ctx)
            if a.fn == "count" and not a.args:
                plan[sym] = ("count", len(rows))
                rows.append(mask)
            elif a.fn == "count_if":
                v = to_column(eval_expr(a.args[0], b, self.ctx), n,
                              self.device)
                m = mask & v.data
                if v.valid is not None:
                    m = m & v.valid
                plan[sym] = ("count", len(rows))
                rows.append(m)
            else:
                col = to_column(eval_expr(a.args[0], b, self.ctx), n,
                                self.device)
                if col.data.dtype not in (torch.float64, torch.float32):
                    continue
                value_dtypes.add(col.data.dtype)
                valid = mask if col.valid is None else (mask & col.valid)
                vi = len(rows)
                rows.append(torch.where(valid, col.data, 0.0))
                ci = len(rows)
                rows.append(valid)
                plan[sym] = (a.fn, vi, ci, a.type)
        if len(plan) < (1 if torch.float32 in value_dtypes else 2):
            return {}
        stack_t = torch.float32 if value_dtypes == {torch.float32} \
            else torch.float64
        sums = K.fused_group_sums(
            torch.stack([r.to(stack_t) for r in rows]),
            gid.clamp(0, n_groups - 1).to(torch.int32).contiguous(),
            n_groups)
        out: Dict[str, Column] = {}
        for sym, p in plan.items():
            if p[0] == "count":
                # float counts are exact below 2^53
                out[sym] = Column(torch.round(sums[p[1]]).to(torch.int64),
                                  None, T.BIGINT)
                continue
            fn, vi, ci, out_t = p
            s = sums[vi]
            cnt = sums[ci]
            nonempty = cnt > 0.5
            if fn == "avg":
                out[sym] = Column(s / cnt.clamp_min(1.0), nonempty, T.DOUBLE)
            else:
                out[sym] = Column(s, nonempty, out_t)
        return out

    def _agg_column(self, b: Batch, a: ir.AggCall,
                    order: K.GroupOrder) -> Column:
        gid, n_groups = order.gid, order.n_groups
        mask = b.sel
        if a.filter is not None:
            mask = mask & eval_predicate(a.filter, b, self.ctx)
        if a.fn == "count" and not a.args:
            cnt = K.segment_sum(mask.to(torch.int32), gid, n_groups, order)
            return Column(cnt.to(torch.int64), None, T.BIGINT)
        if a.fn == "count_if":
            v = to_column(eval_expr(a.args[0], b, self.ctx), b.capacity,
                          self.device)
            m = mask & v.data
            if v.valid is not None:
                m = m & v.valid
            return Column(K.segment_sum(m.to(torch.int32), gid, n_groups,
                                        order).to(torch.int64),
                          None, T.BIGINT)
        if a.fn not in PORTED_AGGS:
            raise NotImplementedError(
                f"aggregate {a.fn} is not ported to presto_tpu_torch")
        col = to_column(eval_expr(a.args[0], b, self.ctx), b.capacity,
                        self.device)
        valid = mask if col.valid is None else (mask & col.valid)
        cnt = K.segment_sum(valid.to(torch.int32), gid, n_groups,
                            order).to(torch.int64)
        nonempty = cnt > 0

        def seg_sum(x):
            return K.segment_sum(x, gid, n_groups, order)

        if a.fn in COLLECTION_AGGS:
            if self.static:
                raise StaticFallback(f"{a.fn} is dynamic-mode only")
            return self._collection_agg(b, a, order, col, mask, valid,
                                        nonempty)
        if a.fn in HOST_AGGS or (a.fn in ("min_by", "max_by")
                                 and len(a.args) == 3):
            if self.static:
                raise StaticFallback(f"{a.fn} is dynamic-mode only")
            return self._host_agg(b, a, order, col, mask, valid, nonempty)
        if a.fn in ML_AGGS:
            if self.static:
                raise StaticFallback(f"{a.fn} is dynamic-mode only")
            return self._ml_agg(b, a, order, col, valid, nonempty)
        if a.fn == "count":
            return Column(cnt, None, T.BIGINT)
        if a.fn == "approx_distinct":
            est = K.hll_registers_and_estimate(K.hll_hash64(col), valid, gid,
                                               n_groups, m=_hll_m(a))
            return Column(est, None, T.BIGINT)
        if a.fn in ("approx_count", "approx_sum"):
            # COUNT/SUM ... WITH ERROR: the rows of a deterministic 1-in-8
            # value-hash sample, scaled by exactly 8
            keep = valid & K.sketch_sample_mask(K.hll_hash64(col))
            if a.fn == "approx_count":
                return Column(seg_sum(keep.to(torch.int32)).to(torch.int64)
                              * 8, None, T.BIGINT)
            s = seg_sum(torch.where(keep, col.data,
                                    torch.zeros_like(col.data)))
            if a.type.is_integer:
                s = s.to(torch.int64)
            return Column(s.to(torch_dtype(a.type)) * 8, nonempty, a.type)
        if a.fn == "checksum":
            # a wrapping sum of the rows' 64-bit key hashes (strings hash
            # their codes)
            h = K._hash_keys([col], valid)
            return Column(seg_sum(torch.where(valid, h, 0)), nonempty,
                          T.BIGINT)
        if a.fn == "approx_percentile":
            if a.type.name == "ARRAY" or len(a.args) >= 3:
                # an ARRAY of percentiles or a weight: exact, on the host
                if self.static:
                    raise StaticFallback(
                        "array/weighted approx_percentile is "
                        "dynamic-mode only")
                return self._approx_percentile_host(b, a, order, col,
                                                    valid, nonempty)
            p = eval_expr(a.args[1], b, self.ctx).data
            if isinstance(p, torch.Tensor):
                raise NotImplementedError(
                    "approx_percentile over a percentile column is not "
                    "ported")
            vals, ok = K.group_percentile(col.data, valid, gid, n_groups,
                                          float(p), order)
            return Column(vals.to(col.data.dtype), ok, a.type,
                          col.dictionary)
        if a.fn in ("min_by", "max_by"):
            # ranked by the key's validity alone: a NULL value at the
            # winning row comes back NULL; ties go to the last row
            yv = to_column(eval_expr(a.args[1], b, self.ctx), b.capacity,
                           self.device)
            yvalid = mask if yv.valid is None else (mask & yv.valid)
            is_min = a.fn == "min_by"
            ykey = torch.where(yvalid, K._orderable_int(yv),
                               K.I64_MAX if is_min else -K.I64_MAX)
            # the extreme key of each group through its rank in one
            # sort of the keys (ranks are exact in f64)
            by_key = K.argsort_stable(ykey)
            rank = K.unpermute(by_key, torch.arange(b.capacity,
                                                    device=self.device))
            best = K.segment_extreme_f64(rank, order, is_min)
            best = torch.where(torch.isfinite(best), best, 0.0).long()
            extremum = ykey[by_key[best.clamp(0, max(b.capacity - 1, 0))]]
            hit = yvalid & (ykey == _at_group(extremum, gid, n_groups))
            idx, ok = self._last_row(hit, order, b.capacity)
            val_valid = ok if col.valid is None else (ok & col.valid[idx])
            return Column(col.data[idx], val_valid, a.type, col.dictionary)
        if a.fn in ("arbitrary", "any_value"):
            idx, ok = self._last_row(valid, order, b.capacity)
            return Column(col.data[idx], nonempty & ok, a.type,
                          col.dictionary)
        if a.fn == "geometric_mean":
            x = torch.where(valid, col.data.to(torch.float64), 1.0)
            s = seg_sum(torch.log(x.clamp_min(1e-300)))
            return Column(torch.exp(s / cnt.clamp_min(1)), nonempty,
                          T.DOUBLE)
        if a.fn == "sum":
            if DEC.is_long(a.type):
                # sum(DECIMAL(p, s)) is DECIMAL(38, s): exact Int128
                # accumulation (dec128.segment_sum128)
                limbs = col.data if col.data.ndim == 2 \
                    else D128.from_int64(col.data)
                return Column(D128.segment_sum128(limbs, valid, gid,
                                                  n_groups, order),
                              nonempty, a.type)
            x = torch.where(valid, col.data, torch.zeros_like(col.data))
            s = seg_sum(x)
            if a.type.is_integer:
                s = s.to(torch.int64)
            return Column(s.to(torch_dtype(a.type)), nonempty, a.type)
        if a.fn == "avg":
            if a.type.name.startswith("INTERVAL"):
                # an interval's average stays an interval: the micros or
                # months sum divided truncating toward zero
                s = seg_sum(torch.where(valid, col.data,
                                        torch.zeros_like(col.data)))
                s = s.to(torch.int64)
                d = cnt.clamp_min(1)
                return Column(torch.sign(s) * (s.abs() // d), nonempty,
                              a.type)
            # a decimal's average is a DOUBLE, as the reference's is
            x = torch.where(valid, _f64_values(col), 0.0)
            return Column(seg_sum(x) / cnt.clamp_min(1), nonempty, T.DOUBLE)
        if a.fn in _VARIANCE_AGGS:
            # the reference's moments: var_pop = E[x^2] - E[x]^2 from two
            # grouped sums in segment_sum's fixed order, the sample
            # variants scaled by n / (n - 1) and NULL below two rows
            # over a decimal's unscaled values, as the reference's are
            x = torch.where(valid, _f64_values(col, scaled=False), 0.0)
            s1 = seg_sum(x)
            s2 = seg_sum(x * x)
            nf = cnt.clamp_min(1).to(torch.float64)
            var = (s2 / nf - (s1 / nf) ** 2).clamp_min(0.0)
            if a.fn in ("stddev_pop", "var_pop"):
                ok = nonempty
            else:
                var = var * nf / (cnt - 1).clamp_min(1).to(torch.float64)
                ok = nonempty & (cnt > 1)
            r = torch.sqrt(var) if a.fn.startswith("stddev") else var
            return Column(r, ok, T.DOUBLE)
        if a.fn in ("bool_and", "every", "bool_or"):
            x = torch.where(valid, col.data.to(torch.bool),
                            a.fn != "bool_or")
            r = K.segment_extreme_f64(x, order, a.fn != "bool_or")
            return Column(r > 0, nonempty, T.BOOLEAN)
        if a.fn in _BIVARIATE_AGGS:
            return self._bivariate(b, a, col, valid, seg_sum)
        if a.fn in ("skewness", "kurtosis"):
            return _central_moment(a.fn, col, valid, cnt, seg_sum)
        if a.fn == "entropy":
            # log2(S) - sum(c * log2 c) / S over the nonnegative counts
            c = torch.where(valid, col.data.to(torch.float64), 0.0)
            c = c.clamp_min(0.0)
            s = seg_sum(c)
            clogc = seg_sum(torch.where(
                c > 0, c * _log2(c.clamp_min(1e-300)), 0.0))
            sc = s.clamp_min(1e-300)
            r = torch.where(s > 0, _log2(sc) - clogc / sc, 0.0)
            return Column(r, nonempty, T.DOUBLE)
        if a.fn in ("bitwise_and_agg", "bitwise_or_agg"):
            return _bitwise_agg(a.fn, col, valid, gid, n_groups, nonempty)
        if col.data.ndim == 2:  # long-decimal limbs
            return Column(D128.segment_minmax128(col.data, valid, gid,
                                                 n_groups, a.fn == "min"),
                          nonempty, a.type)
        ext = K._reduce_identity(col.data.dtype, a.fn == "min")
        x = torch.where(valid, col.data,
                        torch.full_like(col.data, ext))
        f = K.segment_min if a.fn == "min" else K.segment_max
        return Column(f(x, gid, n_groups).to(col.data.dtype), nonempty,
                      a.type, col.dictionary)

    def _collection_agg(self, b: Batch, a: ir.AggCall, order: K.GroupOrder,
                        col: Column, mask, valid, nonempty) -> Column:
        """The aggregates that return a collection, from the rows read
        back to the host (reference: the array_agg, map_agg, histogram
        and set_* branches of _agg_column and _agg_column_host)."""
        n_groups = order.n_groups
        gid = order.gid.cpu().numpy()
        data = col.data.cpu().numpy()
        vh = valid.cpu().numpy()
        if a.fn == "array_agg":
            # a NULL input stays, as a NULL element
            tuples = CL.array_agg(gid, mask.cpu().numpy(), vh, data,
                                  col.dictionary, n_groups)
        elif a.fn in ("map_agg", "multimap_agg"):
            vcol = to_column(eval_expr(a.args[1], b, self.ctx), b.capacity,
                             self.device)
            vvalid = np.ones(b.capacity, bool) if vcol.valid is None \
                else vcol.valid.cpu().numpy()
            tuples = CL.map_agg(gid, vh, data, col.dictionary,
                                vcol.data.cpu().numpy(), vcol.dictionary,
                                vvalid, n_groups, a.fn == "multimap_agg")
        elif a.fn == "numeric_histogram":
            # numeric_histogram(buckets, value): the first argument is
            # the bucket count
            nb = eval_expr(a.args[0], b, self.ctx).data
            if isinstance(nb, torch.Tensor):  # a constant column
                nb = nb.reshape(-1)[0]
            nb = int(nb)
            vcol = to_column(eval_expr(a.args[1], b, self.ctx), b.capacity,
                             self.device)
            vvh = mask if vcol.valid is None else (mask & vcol.valid)
            tuples = CL.numeric_histogram(
                gid, vvh.cpu().numpy(),
                vcol.data.cpu().numpy().astype(np.float64), nb, n_groups)
        else:
            build = {"histogram": CL.histogram, "map_union": CL.map_union,
                     "set_agg": CL.set_agg, "set_union": CL.set_union}[a.fn]
            tuples = build(gid, vh, data, col.dictionary, n_groups)
        return CL.tuples_to_dict_column(tuples, nonempty, a.type,
                                        self.device)

    def _host_agg(self, b: Batch, a: ir.AggCall, order: K.GroupOrder,
                  col: Column, mask, valid, nonempty) -> Column:
        """The sketch-state and host aggregates, from the rows read back
        to the host (exec/host_aggs.py; reference: the sketch branch of
        _agg_column and _agg_column_host)."""
        n_groups = order.n_groups
        gid = order.gid.cpu().numpy()
        data = col.data.cpu().numpy()
        vh = valid.cpu().numpy()
        sel = b.sel.cpu().numpy()
        cap = b.capacity

        def const(e):
            # a constant argument: its first row where the planner
            # projected it into a column, as the reference reads it
            return python_value(eval_expr(e, b, self.ctx))

        def host_column(e):
            c = to_column(eval_expr(e, b, self.ctx), cap, self.device)
            ok = np.ones(cap, bool) if c.valid is None \
                else c.valid.cpu().numpy()
            return c, c.data.cpu().numpy(), ok

        if a.fn == "approx_set":
            out = HA.approx_set(gid, vh, data, col.dictionary, col.type,
                                n_groups)
        elif a.fn == "qdigest_agg":
            out = HA.qdigest_agg(gid, vh, data, col.type, n_groups)
        elif a.fn == "tdigest_agg":
            w = None
            if len(a.args) >= 2:  # a weight column; its NULLs are read
                w = host_column(a.args[1])[1].astype(np.float64)
            compression = TD.DEFAULT_COMPRESSION
            if len(a.args) >= 3:
                cv = eval_expr(a.args[2], b, self.ctx)
                if isinstance(cv.data, torch.Tensor) and cv.data.ndim > 0:
                    raise NotImplementedError(
                        "tdigest_agg compression must be a constant")
                compression = float(python_value(cv))
            out = HA.tdigest_agg(gid, vh, data, col.type, w, compression,
                                 n_groups)
        elif a.fn == "merge":
            out = HA.merge(gid, vh, data, col.dictionary, a.type, n_groups)
        elif a.fn == "map_union_sum":
            out = HA.map_union_sum(gid, vh, data, col.dictionary, n_groups)
        elif a.fn == "approx_most_frequent":
            # (buckets, value, capacity): the value's rows under the
            # batch's selection (the reference reads b.sel here)
            buckets = int(const(a.args[0]))
            vcol, vdata, vok = host_column(a.args[1])
            out, ok = HA.approx_most_frequent(
                gid, sel & vok, vdata, vcol.dictionary, buckets, n_groups)
            return CL.tuples_to_dict_column(out, upload(ok, self.device),
                                            a.type, self.device)
        elif a.fn in ("min_by", "max_by"):
            ycol, ydata, yok = host_column(a.args[1])
            n = int(const(a.args[2]))
            xok = np.ones(cap, bool) if col.valid is None \
                else col.valid.cpu().numpy()
            out = HA.min_max_by_n(gid, sel & vh & yok, data, col.dictionary,
                                  xok, ydata, ycol.dictionary, n,
                                  a.fn == "min_by", n_groups)
        else:  # reduce_agg(value, init, input_fn, combine_fn)
            _v, init_e, in_e, comb_e = a.args
            lam = [LambdaVal(e.params, e.param_types, e.body, self.ctx,
                             e.type) for e in (in_e, comb_e)]
            init = _pylist_from_colval(eval_expr(init_e, b, self.ctx), 1)[0]
            states = HA.reduce_agg(gid, vh, data, col.dictionary, col.type,
                                   init, lam[0], lam[1], a.type, n_groups)
            return to_column(_colval_from_pylist(states, a.type),
                             n_groups, self.device)
        return CL.tuples_to_dict_column(out, nonempty, a.type, self.device)

    def _ml_agg(self, b: Batch, a: ir.AggCall, order: K.GroupOrder,
                col: Column, valid, nonempty) -> Column:
        """learn_classifier, learn_regressor, evaluate_classifier_predictions
        and the classification_* family, from the rows read back to the
        host (exec/host_aggs.py; reference: their branches of
        _agg_column and _classification_host)."""
        n_groups = order.n_groups
        gid = order.gid.cpu().numpy()
        vh = valid.cpu().numpy()
        cap = b.capacity

        def host_column(e):
            return to_column(eval_expr(e, b, self.ctx), cap, self.device)

        if a.fn in ("learn_classifier", "learn_regressor"):
            fv = eval_expr(a.args[1], b, self.ctx)
            feats = fv.data.cpu().numpy()
            labels = col.data.cpu().numpy()
            if col.dictionary is not None:
                labels = col.dictionary.values[
                    np.clip(labels, 0, len(col.dictionary) - 1)]
            elif col.type.is_decimal:
                labels = labels.astype(np.float64) \
                    / (10 ** col.type.decimal_scale)
            if fv.valid is not None:  # rows with NULL features skip
                vh = vh & fv.valid.cpu().numpy()
            out = HA.learn(a.fn, gid, vh, labels, feats, n_groups)
        elif a.fn == "evaluate_classifier_predictions":
            pcol = host_column(a.args[1])
            if pcol.valid is not None:
                vh = vh & pcol.valid.cpu().numpy()
            out = HA.evaluate_predictions(
                gid, vh, col.data.cpu().numpy(), col.dictionary,
                pcol.data.cpu().numpy(), pcol.dictionary, n_groups)
        else:  # classification_*(buckets, truth, prediction[, weight])
            bk = eval_expr(a.args[0], b, self.ctx).data
            buckets = int(bk.reshape(-1)[0]) if isinstance(
                bk, torch.Tensor) else int(bk)
            if buckets < 2:
                raise ExecutionError(f"{a.fn}: buckets must be >= 2")
            tcol = host_column(a.args[1])
            pcol = host_column(a.args[2])
            truth = tcol.data.cpu().numpy().astype(bool)
            pred = pcol.data.cpu().numpy().astype(np.float64)
            wts = None  # unit weights
            if len(a.args) > 3:
                wts = host_column(a.args[3]).data.cpu().numpy() \
                    .astype(np.float64)
            vh = b.sel.cpu().numpy()
            for c in (tcol, pcol):
                if c.valid is not None:
                    vh = vh & c.valid.cpu().numpy()
            if np.any(vh & ((pred < 0) | (pred > 1))):
                raise ExecutionError(
                    f"{a.fn}: predictions must be in [0, 1]")
            out = HA.classification(a.fn, gid, vh, truth, pred, wts,
                                    buckets, n_groups)
        return CL.tuples_to_dict_column(out, nonempty, a.type, self.device)

    def _approx_percentile_host(self, b: Batch, a: ir.AggCall,
                                order: K.GroupOrder, col: Column, valid,
                                nonempty) -> Column:
        """approx_percentile over an ARRAY of percentiles or with a
        weight (reference: _approx_percentile_host): exact per group on
        the host."""
        has_weight = len(a.args) >= 3
        pv = eval_expr(a.args[2 if has_weight else 1], b, self.ctx)
        array_out = pv.dictionary is not None  # an ARRAY of percentiles
        ps = list(python_value(pv)) if array_out \
            else [float(python_value(pv))]
        w = np.ones(b.capacity)
        if has_weight:
            wcol = to_column(eval_expr(a.args[1], b, self.ctx), b.capacity,
                             self.device)
            w = wcol.data.cpu().numpy().astype(np.float64)
        outs = HA.approx_percentile(order.gid.cpu().numpy(),
                                    valid.cpu().numpy(),
                                    col.data.cpu().numpy(), col.type, w, ps,
                                    order.n_groups)
        return HA.percentile_column(outs, array_out, a.type, nonempty,
                                    self.device)

    @staticmethod
    def _last_row(hit, order: K.GroupOrder, capacity: int):
        """Each group's last row where `hit` is set: (a row index clipped
        into the batch, whether there is one)."""
        rows = torch.arange(capacity, dtype=torch.float64, device=hit.device)
        idx = K.segment_extreme_f64(torch.where(hit, rows, -1.0), order,
                                    False)
        ok = idx >= 0
        return idx.clamp(0, max(capacity - 1, 0)).long(), ok

    def _bivariate(self, b: Batch, a: ir.AggCall, col: Column, valid,
                   seg_sum) -> Column:
        """corr, covar_samp, covar_pop, regr_slope and regr_intercept of
        (y, x) from the grouped sums n, sx, sy, sxy, sxx and syy over the
        rows where both are valid."""
        xv = to_column(eval_expr(a.args[1], b, self.ctx), b.capacity,
                       self.device)
        both = valid if xv.valid is None else (valid & xv.valid)
        y = torch.where(both, _f64_values(col), 0.0)
        x = torch.where(both, _f64_values(xv), 0.0)
        n = seg_sum(both.to(torch.int32)).to(torch.float64)
        sx, sy = seg_sum(x), seg_sum(y)
        sxy, sxx, syy = seg_sum(x * y), seg_sum(x * x), seg_sum(y * y)
        n1 = n.clamp_min(1.0)
        covp = sxy / n1 - (sx / n1) * (sy / n1)
        varx = (sxx / n1 - (sx / n1) ** 2).clamp_min(0.0)
        vary = (syy / n1 - (sy / n1) ** 2).clamp_min(0.0)
        if a.fn == "covar_pop":
            return Column(covp, n > 0, T.DOUBLE)
        if a.fn == "covar_samp":
            return Column(covp * n / (n - 1.0).clamp_min(1.0), n > 1,
                          T.DOUBLE)
        if a.fn == "corr":
            denom = torch.sqrt(varx * vary)
            return Column(covp / denom.clamp_min(1e-300),
                          (n > 1) & (denom > 0), T.DOUBLE)
        slope = covp / varx.clamp_min(1e-300)
        ok = (n > 1) & (varx > 0)
        if a.fn == "regr_slope":
            return Column(slope, ok, T.DOUBLE)
        return Column(sy / n1 - slope * (sx / n1), ok, T.DOUBLE)

    def _global_aggregate(self, b: Batch,
                          aggs: Dict[str, ir.AggCall]) -> Batch:
        gid = torch.zeros((b.capacity,), dtype=torch.int64,
                          device=self.device)
        order = K.GroupOrder(gid, 1)
        out_cols = {sym: self._agg_column(b, a, order)
                    for sym, a in aggs.items()}
        return Batch(out_cols, torch.ones((1,), dtype=torch.bool,
                                          device=self.device))

    # ---- ordering ----------------------------------------------------
    def _sort_perm(self, b: Batch, key_spec) -> torch.Tensor:
        """sort_perm through the permutation memo: the same sort of the
        same batch (key columns, sel and directions) replays it."""
        keys = [(b.columns[s], asc, nf) for s, asc, nf in key_spec]
        fp, refs = self._key_fp([c for c, _, _ in keys], b.sel,
                                [("sort", s, bool(asc), nf)
                                 for s, asc, nf in key_spec])
        if not self._ordering_enabled():
            fp = None
        entry = self._perm_memo.get(fp) if fp is not None else None
        if entry is not None:
            self._count("sort_memo_hits")
            self._count("sorts_elided")
            return entry[1]
        self._count("sorts_taken")
        perm = K.sort_perm(b, keys)
        if fp is not None:
            self._perm_memo[fp] = (refs, perm)
        return perm

    def _exec_sort(self, node: P.Sort) -> Batch:
        b = self.exec_node(node.source)
        if self._ordering_enabled() and self._order_satisfies(b, node.keys):
            # the input is in order already (an ordering this executor
            # built): its live rows surface in order, masked rows hidden
            self._count("sorts_elided")
            return b
        out = K.gather_batch(b, self._sort_perm(b, node.keys))
        self._note_order(out, tuple((s, asc) for s, asc, _nf in node.keys))
        return out

    def _exec_topn(self, node: P.TopN) -> Batch:
        """TopN = key sort + k-row gather (reference: TopNOperator's
        bounded heap), without a full-capacity gather of every column."""
        b = self.exec_node(node.source)
        if self._ordering_enabled() and self._order_satisfies(b, node.keys):
            # in order already: TopN is a LIMIT
            self._count("sorts_elided")
            out = self._limit(b, node.count)
            self._copy_order(b, out)
            return out
        perm = self._sort_perm(b, node.keys)  # masked rows sort last
        sorted_keys = tuple((s, asc) for s, asc, _nf in node.keys)
        k = min(int(node.count), b.capacity)
        if k == b.capacity:
            out = K.gather_batch(b, perm)
        else:
            out = K.gather_batch(b, perm[:k])
            live = torch.arange(k, device=self.device) < b.sel.sum()
            out = out.with_sel(out.sel & live)
        self._note_order(out, sorted_keys)
        return out

    def _exec_limit(self, node: P.Limit) -> Batch:
        b = self.exec_node(node.source)
        out = self._limit(b, node.count)
        self._copy_order(b, out)  # a rank mask: no row moves
        return out

    @staticmethod
    def _limit(b: Batch, n: int) -> Batch:
        n = min(int(n), b.capacity)
        rank = torch.cumsum(b.sel.to(torch.int32), 0)
        return b.with_sel(b.sel & (rank <= n))

    # ---- joins -------------------------------------------------------
    def _exec_join(self, node: P.Join) -> Batch:
        produce = getattr(node, "rf_produce", None)
        if produce and node.join_type in ("INNER", "SEMI") \
                and self._df_enabled() and self._rf_build_complete(node):
            # dynamic filtering: the build side runs first and registers
            # its keys' summary, which the probe subtree's scans then
            # apply (the planner wires no filter into a shared subtree)
            right = self.exec_node(node.right)
            self._rf_register(produce, right)
            left = self.exec_node(node.left)
        else:
            left = self.exec_node(node.left)
            right = self.exec_node(node.right)
        left = self._maybe_compact_static(
            left, getattr(node, "left_est_hint", None))
        if getattr(node, "index_lookup", None) is None:
            # an index join needs the build's whole table in its natural
            # order: never compact it
            right = self._maybe_compact_static(
                right, getattr(node, "right_est_hint", None))
        if node.join_type == "RIGHT":
            # RIGHT = mirrored LEFT with output order left-cols-first
            node = P.Join(node.right, node.left, "LEFT",
                          [(rk, lk) for lk, rk in node.criteria], node.filter)
            left, right = right, left
        out = self._join_batches(left, right, node)
        if node.join_type in ("SEMI", "ANTI", "MARK"):
            # the probe masked in place: no row moved
            self._copy_order(left, out)
        return out

    def _join_batches(self, left: Batch, right: Batch, node: P.Join) -> Batch:
        jt = node.join_type
        if jt == "CROSS":
            return self._cross_join(left, right, node)
        if jt == "FULL":
            return self._full_join(left, right, node)
        if right.capacity == 0:
            return self._empty_build_join(left, right, node)
        lkeys = [left.columns[lk] for lk, _ in node.criteria]
        rkeys = [right.columns[rk] for _, rk in node.criteria]
        lkeys, rkeys = _unify_key_dictionaries(lkeys, rkeys)
        # SQL equi-join: NULL never matches NULL
        lsel = left.sel
        rsel = right.sel
        for c in lkeys:
            if c.valid is not None:
                lsel = lsel & c.valid
        for c in rkeys:
            if c.valid is not None:
                rsel = rsel & c.valid
        probe = self._index_probe(node, left, right, lkeys, rkeys, lsel,
                                  rsel)
        if probe is not None:
            index_ridx, counts = probe
        else:
            index_ridx = None
            if self.static:
                # layout from the planner's key ranges, shared by both
                # sides, under a guard on each; unknown ranges hash
                key_stats = getattr(node, "key_stats", {})
                layout = K.static_layout(rkeys, [
                    _merge_range(key_stats.get(lk), key_stats.get(rk))
                    for lk, rk in node.criteria])
                rkey = K.pack_with_layout(rkeys, rsel, layout)
                lkey = K.pack_with_layout(lkeys, lsel, layout)
                if layout is not None:
                    self.guards.append(
                        K.layout_range_guard(rkeys, rsel, layout))
                    self.guards.append(
                        K.layout_range_guard(lkeys, lsel, layout))
            else:
                rkey, layout = K.pack_keys(rkeys, rsel, extra_cols=lkeys)
                lkey = K.pack_with_layout(lkeys, lsel, layout)
            build_order = None
            if layout is not None and self._ordering_enabled() \
                    and self._build_presorted(node, right, rkeys):
                # presorted build: the packed build key is nondecreasing
                # end to end (masked rows' sentinels in a suffix), so its
                # sort is the identity.  An ordering this executor built
                # needs no check; a planner claim is checked on the host
                # here and guarded in the static executor
                if self.static:
                    self.guards.append(K.monotone_guard(rkey))
                    presorted = True
                else:
                    presorted = self._build_order_certain(
                        node, right, rkeys) or not bool(K.monotone_guard(rkey))
                if presorted:
                    build_order = torch.arange(
                        rkey.shape[0], dtype=torch.int32, device=self.device)
                    self._count("sorts_elided")
                else:
                    self._count("ordering_guard_trips")
            if build_order is None:
                # keyed on rsel's parts (the batch's sel and the keys'
                # validity), so two probes of one shared build match
                fp, refs = self._key_fp(rkeys, right.sel, layout)
                build_order = self._memo_pair(rkey, fp, refs)[1]
            order, lb, ub = K.build_probe(rkey, lkey, build_order=build_order)
            # the reference's composite sort and its way home; the port
            # sorts once, stably, for both
            self._count("sorts_taken", 2)
            counts = ub - lb

        if jt == "MARK":  # filter-free by construction (planner)
            return self._mark_join(left, right, node, lkeys, rkeys, counts)
        if jt in ("SEMI", "ANTI") and node.filter is None:
            found = counts > 0
            return left.with_sel(left.sel & (found if jt == "SEMI"
                                             else ~found))
        # a dense unique build has at most one match: no host sync
        if index_ridx is not None:
            max_matches = 1
        elif self.static:
            # the planner's fanout bound (1 for a unique build), guarded
            bound = 1 if getattr(node, "build_unique", False) \
                else getattr(node, "fanout_bound", None)
            if bound is None:
                raise StaticFallback(f"join fanout unbounded "
                                     f"({jt} on {node.criteria})")
            if counts.shape[0]:
                self.guards.append(counts.max() > bound)
            if bound > 1:
                return self._expanding_join_static(left, right, node, order,
                                                   lb, counts, bound)
            max_matches = 1
        else:
            max_matches = int(counts.max()) if counts.shape[0] else 0
        if max_matches > 1:
            return self._expanding_join(left, right, node, order, lb, counts)
        found = counts > 0
        if index_ridx is not None:
            ridx = index_ridx
        else:
            ridx = order[lb.clamp(0, max(order.shape[0] - 1, 0)).long()]
        rbatch = K.gather_batch(right, ridx, idx_valid=found)
        merged = dict(left.columns)
        merged.update(rbatch.columns)
        if node.filter is not None:
            found = found & eval_predicate(node.filter,
                                           Batch(merged, left.sel), self.ctx)
            # data is independent of the match mask: only the validity
            # tightens
            for name, c in rbatch.columns.items():
                v = found if c.valid is None else (c.valid & found)
                merged[name] = Column(c.data, v, c.type, c.dictionary)
        if jt == "SEMI":
            return left.with_sel(left.sel & found)
        if jt == "ANTI":
            return left.with_sel(left.sel & ~found)
        if jt == "INNER":
            return Batch(merged, left.sel & found)
        return Batch(merged, left.sel)  # LEFT

    def _empty_build_join(self, left: Batch, right: Batch,
                          node: P.Join) -> Batch:
        """Zero-capacity build: no row matches; emit the no-match result
        shape directly."""
        jt = node.join_type
        if jt == "SEMI":
            return left.with_sel(torch.zeros_like(left.sel))
        if jt == "ANTI":
            return left
        merged = dict(left.columns)
        never = torch.zeros((left.capacity,), dtype=torch.bool,
                            device=self.device)
        if jt == "MARK":
            # x IN (empty) is FALSE, never NULL, for every probe
            merged[node.mark] = Column(never, None, T.BOOLEAN, None)
            return Batch(merged, left.sel)
        for name, t in node.right.outputs():
            c = right.columns[name]
            shape = (left.capacity,) + tuple(c.data.shape[1:])
            merged[name] = Column(
                torch.zeros(shape, dtype=c.data.dtype, device=self.device),
                never, t, c.dictionary)
        return Batch(merged, never if jt == "INNER" else left.sel)

    def _index_probe(self, node, left, right, lkeys, rkeys, lsel, rsel):
        """Index join: a dense (or block-strided) unique build key puts
        the match of probe key k at a computed row, so the probe is ONE
        gather, no sorts (hint from plan/optimizer._index_lookup_info).
        Returns (ridx, counts), or None for the sort join: no hint, a
        probe much wider than a strided build, or (dynamic executor) a
        build whose rows do not hold the claimed layout, checked on the
        host; the static executor guards the layout instead."""
        il = getattr(node, "index_lookup", None)
        if il is None or len(lkeys) != 1 \
                or lkeys[0].dictionary is not None \
                or rkeys[0].dictionary is not None \
                or lkeys[0].data.ndim != 1:
            return None
        bk = il.get("block_keys", 1)
        br = il.get("block_rows", 1)
        strided = (bk, br) != (1, 1)
        full_build = right.capacity == il["rows"]
        if not (full_build or strided):
            return None
        if strided and lkeys[0].data.shape[0] > 2 * right.capacity:
            # the index gather runs at probe capacity, the sort join's
            # output at its own: gate to probes not much wider than the
            # build
            return None
        nrows = right.capacity
        rk = rkeys[0].data.to(torch.int64)
        ar = torch.arange(nrows, dtype=torch.int64, device=self.device)
        # row i holds key base + (i // br) * bk + i % br; dense layouts
        # are the bk == br == 1 case
        base = torch.full((), il["min"], dtype=torch.int64,
                          device=self.device) if full_build else rk[0]
        expect = base + (ar // br) * bk + ar % br if strided else base + ar
        layout_bad = (rsel & (rk != expect)).any()
        if self.static:
            self.guards.append(layout_bad)
        elif bool(layout_bad):
            return None
        lk = lkeys[0].data.to(torch.int64)
        off = lk - base
        if strided:
            pos_raw = (off // bk) * br + off % bk
            in_slot = (off % bk) < br  # keys between blocks miss
        else:
            pos_raw = off
            in_slot = torch.ones_like(off, dtype=torch.bool)
        pos = pos_raw.clamp(0, nrows - 1).to(torch.int32)
        in_range = (off >= 0) & (pos_raw < nrows) & in_slot
        p = pos.long()
        found = lsel & in_range & rsel[p] & (rk[p] == lk)
        return pos, found.to(torch.int32)

    def _mark_join(self, left, right, node, lkeys, rkeys, counts) -> Batch:
        """Presto semiJoinOutput NULL semantics: TRUE on match; without a
        match the mark is NULL (not FALSE) when the probe key is NULL or
        the build side holds any NULL key, so `x NOT IN (sub)` filters
        the row."""
        merged = dict(left.columns)
        found = counts > 0
        lvalid = None
        for c in lkeys:
            if c.valid is not None:
                lvalid = c.valid if lvalid is None else (lvalid & c.valid)
        rnull = None
        for c in rkeys:
            if c.valid is not None:
                has = (right.sel & ~c.valid).any()
                rnull = has if rnull is None else (rnull | has)
        mvalid = None  # keys can't be NULL: the mark is 2-valued
        if lvalid is not None or rnull is not None:
            ok = torch.ones_like(found) if lvalid is None else lvalid
            if rnull is not None:
                ok = ok & ~rnull
            # an empty subquery makes the mark FALSE whatever the probe
            # key; a build of only NULL keys is not empty (right.sel, not
            # the key-filtered build selection)
            mvalid = found | ok | ~right.sel.any()
        merged[node.mark] = Column(found, mvalid, T.BOOLEAN, None)
        return Batch(merged, left.sel)

    def _expanding_join_static(self, left: Batch, right: Batch,
                               node: P.Join, order, lb, counts,
                               bound: int) -> Batch:
        """One-to-many join in a static slot layout: probe row i owns
        output slots [i * bound, (i + 1) * bound), `bound` the planner's
        fanout bound (e.g. 7 lineitems an order).  Unmatched slots are
        masked, not skipped, so the shape is fixed."""
        jt = node.join_type
        n = left.capacity
        total = n * bound
        if total > 100_000_000:
            raise StaticFallback(
                f"static expansion too large: {n} x fanout {bound}")
        counts = torch.where(left.sel, counts, 0)
        slot = torch.arange(total, dtype=torch.int32, device=self.device)
        lidx = slot // bound  # nondecreasing
        k = slot % bound
        cnt_l, lb_l = K.take_rows(
            [counts.clamp(max=bound).to(torch.int32), lb.to(torch.int32)],
            lidx, presorted=True)
        slot_live = k < cnt_l
        rpos = (lb_l + k).clamp(0, max(order.shape[0] - 1, 0))
        lbatch = K.gather_batch(left, lidx, presorted=True)
        rbatch = K.gather_batch(right, order[rpos.long()],
                                idx_valid=slot_live)
        merged = dict(lbatch.columns)
        merged.update(rbatch.columns)
        out = Batch(merged, lbatch.sel & slot_live)
        match_ok = out.sel
        if node.filter is not None:
            match_ok = match_ok & eval_predicate(node.filter, out, self.ctx)
        if jt == "INNER":
            return out.with_sel(match_ok)
        if jt in ("SEMI", "ANTI"):
            hit = K.segment_any(match_ok, lidx, n)
            return left.with_sel(left.sel & (hit if jt == "SEMI" else ~hit))
        if jt == "LEFT":
            any_ok = K.segment_any(match_ok, lidx, n)
            keep = torch.where(any_ok[lidx.long()], match_ok,
                               (k == 0) & left.sel[lidx.long()])
            for name in rbatch.columns:
                c = merged[name]
                v = match_ok if c.valid is None else (c.valid & match_ok)
                merged[name] = Column(c.data, v, c.type, c.dictionary)
            return Batch(merged, keep)
        raise StaticFallback(f"static join type {jt} not supported")

    def _expanding_join(self, left: Batch, right: Batch, node: P.Join,
                        order, lb, counts) -> Batch:
        """One-to-many join: probe row i expands into counts[i] output
        rows (one for an unmatched LEFT row)."""
        jt = node.join_type
        counts = torch.where(left.sel, counts, 0)
        eff_counts = counts
        if jt == "LEFT":
            eff_counts = torch.where(left.sel & (counts == 0), 1, counts)
        total = int(eff_counts.sum())
        if total == 0:
            merged = dict(left.columns)
            merged.update(right.columns)
            empty = {n: Column(c.data[:0], None if c.valid is None
                               else c.valid[:0], c.type, c.dictionary)
                     for n, c in merged.items()}
            return Batch(empty, torch.zeros((0,), dtype=torch.bool,
                                            device=self.device))
        offsets = torch.cumsum(eff_counts, 0) - eff_counts
        lidx = torch.repeat_interleave(
            torch.arange(left.capacity, device=self.device), eff_counts,
            output_size=total)
        k = torch.arange(total, device=self.device) - offsets[lidx]
        has_match = counts[lidx] > 0
        rpos = (lb[lidx] + k).clamp(0, max(order.shape[0] - 1, 0))
        rbatch = K.gather_batch(right, order[rpos], idx_valid=has_match)
        # lidx is repeat(arange): nondecreasing by construction
        lbatch = K.gather_batch(left, lidx, presorted=True)
        merged = dict(lbatch.columns)
        merged.update(rbatch.columns)
        sel = lbatch.sel
        out = Batch(merged, sel)
        match_ok = has_match
        if node.filter is not None:
            match_ok = match_ok & eval_predicate(node.filter, out, self.ctx)
        if jt == "INNER":
            return out.with_sel(sel & match_ok)
        if jt in ("SEMI", "ANTI"):
            hit = K.segment_any(sel & match_ok, lidx, left.capacity)
            return left.with_sel(left.sel & (hit if jt == "SEMI" else ~hit))
        if jt == "LEFT":
            if node.filter is None:
                return out
            # a row whose every match fails the filter still appears
            # once, with its right side NULL
            any_ok = K.segment_any(sel & match_ok, lidx, left.capacity)
            keep = torch.where(any_ok[lidx], match_ok, k == 0)
            for name in rbatch.columns:
                c = merged[name]
                v = match_ok if c.valid is None else (c.valid & match_ok)
                merged[name] = Column(c.data, v, c.type, c.dictionary)
            return Batch(merged, sel & keep)
        raise ExecutionError(f"join type {jt} not implemented")

    def _full_join(self, left: Batch, right: Batch, node: P.Join) -> Batch:
        """FULL = LEFT(l, r) followed by the rows of r that match nothing,
        their left columns typed NULL: the anti pass swaps probe and
        build (reference: LookupOuterOperator).  The output capacity is
        the LEFT expansion's plus r's, with no host read of its own."""
        lnode = P.Join(node.left, node.right, "LEFT", node.criteria,
                       node.filter)
        for attr in ("build_unique", "fanout_bound", "key_stats"):
            if hasattr(node, attr):
                setattr(lnode, attr, getattr(node, attr))
        left_part = self._join_batches(left, right, lnode)
        anode = P.Join(node.right, node.left, "ANTI",
                       [(rk, lk) for lk, rk in node.criteria], node.filter)
        right_anti = self._join_batches(right, left, anode)
        cap = right_anti.capacity
        never = torch.zeros((cap,), dtype=torch.bool, device=self.device)
        # left columns first, as in left_part
        cols = {name: Column(torch.zeros((cap,), dtype=c.data.dtype,
                                         device=self.device),
                             never, c.type, c.dictionary)
                for name, c in left.columns.items()}
        cols.update(right_anti.columns)
        return K.concat_batches([left_part, Batch(cols, right_anti.sel)])

    def _cross_join(self, left: Batch, right: Batch, node: P.Join) -> Batch:
        if not self.static:  # compaction reads the live counts
            left = K.compact(left)
            right = K.compact(right)
        nl, nr = left.capacity, right.capacity
        if nl * nr > 50_000_000:
            if self.static:
                # the capacities before compaction can be far above the
                # live rows: let the dynamic executor try
                raise StaticFallback(
                    f"static cross join too large: {nl} x {nr}")
            raise ExecutionError(f"cross join too large: {nl} x {nr}")
        # output_size spares torch a host read of the total (and capture
        # forbids one)
        lidx = torch.repeat_interleave(
            torch.arange(nl, dtype=torch.int32, device=self.device), nr,
            output_size=nl * nr)
        ridx = torch.arange(nr, dtype=torch.int32,
                            device=self.device).repeat(nl)
        # lidx is repeat(arange): nondecreasing by construction
        lbatch = K.gather_batch(left, lidx, presorted=True)
        rbatch = K.gather_batch(right, ridx)
        merged = dict(lbatch.columns)
        merged.update(rbatch.columns)
        sel = lbatch.sel & rbatch.sel
        out = Batch(merged, sel)
        if node.filter is not None:
            out = out.with_sel(sel & eval_predicate(node.filter, out,
                                                    self.ctx))
        return out

    def _exec_spatialjoin(self, node: P.SpatialJoin) -> Batch:
        """Grid-indexed spatial inner join (reference: _exec_spatialjoin,
        after SpatialJoinOperator over PagesRTreeIndex).  The candidate
        pairs come from a uniform grid on the host and the exact
        predicate runs on the session's device (functions/geospatial.py);
        the matches gather both sides through kernels.gather_batch.  The
        dynamic executor alone: the match count is data-dependent."""
        if self.static:
            raise StaticFallback("spatial join is dynamic-mode only")
        from presto_tpu_torch.functions import geospatial as GEO

        left = self.exec_node(node.left)
        right = self.exec_node(node.right)
        lrows = np.flatnonzero(left.sel.cpu().numpy())
        rrows = np.flatnonzero(right.sel.cpu().numpy())

        def coords(batch, rows, sym):
            c = batch.columns[sym]
            v = c.data.cpu().numpy().astype(np.float64)[rows]
            if c.valid is not None:
                v = np.where(c.valid.cpu().numpy()[rows], v, np.nan)
            return v

        px = coords(left, lrows, node.probe_x)
        py = coords(left, lrows, node.probe_y)
        # NULL coordinates (NaN after masking) match nothing: drop them
        # before the grid, where a NaN would poison the cell arithmetic
        pkeep = np.isfinite(px) & np.isfinite(py)
        lrows, px, py = lrows[pkeep], px[pkeep], py[pkeep]
        if node.kind == "contains":
            gc = right.columns[node.build_geom]
            if gc.dictionary is None:
                raise ExecutionError("spatial join build side must be a "
                                     "geometry/varchar column")
            if gc.valid is not None:  # a NULL geometry matches nothing
                rrows = rrows[gc.valid.cpu().numpy()[rrows]]
            codes = np.clip(gc.data.cpu().numpy()[rrows], 0,
                            len(gc.dictionary) - 1)
            entries = gc.dictionary.values
            # parse and index each DISTINCT referenced entry once: a
            # low-cardinality geometry column must not replicate its edge
            # arrays per row, and unreferenced entries must not poison
            # the join
            uniq, inv = np.unique(codes, return_inverse=True)
            geoms = []
            for c in uniq:
                g = entries[int(c)]
                g = g if isinstance(g, tuple) else GEO.parse_wkt(str(g))
                if g[0] not in ("polygon",):
                    raise ExecutionError(
                        f"spatial join build over {g[0]} geometries is "
                        "not supported (polygons only)")
                geoms.append(g)
            li, gi = GEO.grid_contains_join(px, py, geoms, self.device)
            # expand each geometry's matches to the build ROWS sharing
            # its code
            order = np.argsort(inv, kind="stable")
            starts = np.searchsorted(inv[order], np.arange(len(uniq)))
            ends = np.searchsorted(inv[order], np.arange(len(uniq)),
                                   side="right")
            counts = ends[gi] - starts[gi]
            li = np.repeat(li, counts)
            flat = (np.arange(int(counts.sum()), dtype=np.int64)
                    - np.repeat(np.concatenate(
                        [[0], np.cumsum(counts)[:-1]]) if len(counts)
                        else np.empty(0, np.int64), counts)
                    + np.repeat(starts[gi], counts))
            ri = order[flat]
        else:
            bx = coords(right, rrows, node.build_x)
            by = coords(right, rrows, node.build_y)
            bkeep = np.isfinite(bx) & np.isfinite(by)
            rrows, bx, by = rrows[bkeep], bx[bkeep], by[bkeep]
            li, ri = GEO.grid_distance_join(px, py, bx, by, node.radius,
                                            node.strict, self.device)
        lb = K.gather_batch(left, upload(lrows[li].astype(np.int64),
                                         self.device))
        rb = K.gather_batch(right, upload(rrows[ri].astype(np.int64),
                                          self.device))
        merged = dict(lb.columns)
        merged.update(rb.columns)
        out = Batch(merged, torch.ones((len(li),), dtype=torch.bool,
                                       device=self.device))
        if node.filter is not None:
            out = Batch(merged, eval_predicate(node.filter, out, self.ctx))
        return out

    # ---- window and set operations -----------------------------------
    def _exec_window(self, node: P.Window) -> Batch:
        return execute_window(self, node)

    # ---- UNNEST ------------------------------------------------------
    #: the most rows a static UNNEST expands to (capacity x the longest
    #: array), the reference's bound
    STATIC_UNNEST_MAX = 50_000_000

    def _exec_unnest(self, node: P.Unnest) -> Batch:
        """Lateral explode (reference: _exec_unnest): each live row with
        a non-NULL array fans out to one row per element, in row order.
        The per-entry tables come from the array's dictionary on the
        host (exec/collections.py); the expansion and the gathers run
        on the device, with one read of the expanded size."""
        if self.static:
            return self._unnest_static(node)
        b = self.exec_node(node.source)
        col = to_column(eval_expr(node.array_expr, b, self.ctx), b.capacity,
                        self.device)
        elem_t = node.elem_type
        # a typed NULL without a dictionary expands to nothing
        tabs = CL.unnest_tables(col.dictionary or Dictionary(
            np.empty(0, dtype=object)), elem_t)
        live = b.sel if col.valid is None else (b.sel & col.valid)
        codes = col.data.clamp(0, max(len(tabs.lens) - 1, 0)).long()
        if len(tabs.lens):
            counts = torch.where(live, upload(tabs.lens, self.device)[codes],
                                 0)
        else:
            counts = torch.zeros((b.capacity,), dtype=torch.int64,
                                 device=self.device)
        total = int(counts.sum())
        rows = torch.arange(b.capacity, device=self.device)
        idx = torch.repeat_interleave(rows, counts, output_size=total)
        k = torch.arange(total, device=self.device) \
            - (torch.cumsum(counts, 0) - counts)[idx]
        pos = (upload(tabs.starts, self.device)[codes[idx]] + k) \
            if total else k
        out = K.gather_batch(b, idx, presorted=True)
        cols = dict(out.columns)
        cols[node.out_sym] = self._unnest_elements(tabs, elem_t, pos)
        if node.ordinality_sym:
            cols[node.ordinality_sym] = Column(k + 1, None, T.BIGINT)
        return Batch(cols, torch.ones((total,), dtype=torch.bool,
                                      device=self.device))

    def _unnest_elements(self, tabs, elem_t: T.Type, pos) -> Column:
        """The dynamic element column at flat positions `pos`, as the
        reference builds it from the live elements (see
        collections.UnnestTables)."""
        if pos.shape[0] == 0:
            dt = torch.int32 if tabs.coded else torch_dtype(elem_t)
            return Column(torch.zeros((0,), dtype=dt, device=self.device),
                          None, elem_t, Dictionary(np.empty(0, dtype=str))
                          if elem_t.is_string else tabs.edict)
        if elem_t.is_string:
            # the dictionary of the texts present (reference:
            # column_from_numpy), a NULL element as the text 'None'
            ecode = upload(tabs.text_codes, self.device)[pos].long()
            used = torch.zeros((len(tabs.texts),), dtype=torch.bool,
                               device=self.device)
            used[ecode] = torch.ones_like(ecode, dtype=torch.bool)
            remap = torch.cumsum(used.to(torch.int32), 0) - 1
            present = used.cpu().numpy()
            return Column(remap[ecode].to(torch.int32), None, elem_t,
                          Dictionary(tabs.texts[present]))
        vals = upload(tabs.values, self.device)[pos]
        if tabs.coded:  # nested elements: the static path's dictionary
            ok = upload(tabs.present, self.device)[pos]
            return Column(vals, ok, elem_t, tabs.edict)
        if not tabs.present.all():
            missing = ~upload(tabs.present, self.device)[pos]
            if tabs.dynamic_null is None:
                if bool(missing.any()):
                    raise TypeError(
                        "int() argument must be a string, a bytes-like "
                        "object or a real number, not 'NoneType'")
            else:
                vals = torch.where(missing, tabs.dynamic_null, vals)
        return Column(vals, None, elem_t)

    def _unnest_static(self, node: P.Unnest) -> Batch:
        """Static UNNEST (reference: _unnest_static): the dictionary is
        fixed before the program runs, so its (entries x maxlen) element
        matrix and lengths come from the host, and the program is two
        gathers under a slot-liveness mask at capacity x maxlen rows."""
        b = self.exec_node(node.source)
        col = to_column(eval_expr(node.array_expr, b, self.ctx), b.capacity,
                        self.device)
        if col.dictionary is None:
            raise StaticFallback("UNNEST over a non-dictionary array")
        elem_t = node.elem_type
        tabs = CL.unnest_tables(col.dictionary, elem_t)
        maxlen = tabs.maxlen
        n = b.capacity
        if n * max(maxlen, 1) > self.STATIC_UNNEST_MAX:
            raise StaticFallback(
                f"static UNNEST expansion too large: {n} x {maxlen}")
        dt = torch.int32 if tabs.coded else torch_dtype(elem_t)
        if maxlen == 0:
            out = K.gather_batch(b, torch.zeros((0,), dtype=torch.int32,
                                                device=self.device))
            cols = dict(out.columns)
            cols[node.out_sym] = Column(
                torch.zeros((0,), dtype=dt, device=self.device), None,
                elem_t, tabs.edict)
            if node.ordinality_sym:
                cols[node.ordinality_sym] = Column(
                    torch.zeros((0,), dtype=torch.int64, device=self.device),
                    None, T.BIGINT)
            return Batch(cols, torch.zeros((0,), dtype=torch.bool,
                                           device=self.device))
        mat, mat_ok = tabs.matrix()
        dsize = max(len(tabs.lens), 1)
        codes = col.data.clamp(0, dsize - 1).long()
        live = b.sel if col.valid is None else (b.sel & col.valid)
        lidx = torch.repeat_interleave(
            torch.arange(n, dtype=torch.int32, device=self.device), maxlen,
            output_size=n * maxlen)
        k = torch.arange(maxlen, device=self.device).repeat(n)
        code_l = codes[lidx.long()]
        lens = upload(tabs.lens if len(tabs.lens)
                      else np.zeros(1, np.int64), self.device)
        slot_live = live[lidx.long()] & (k < lens[code_l])
        cell = code_l * maxlen + k
        elem_data = upload(mat, self.device)[cell]
        elem_valid = slot_live & upload(mat_ok, self.device)[cell]
        out = K.gather_batch(b, lidx, idx_valid=slot_live, presorted=True)
        cols = dict(out.columns)
        cols[node.out_sym] = Column(elem_data, elem_valid, elem_t, tabs.edict)
        if node.ordinality_sym:
            cols[node.ordinality_sym] = Column(k + 1, None, T.BIGINT)
        return Batch(cols, out.sel)

    def _exec_union(self, node: P.Union) -> Batch:
        parts = []
        for src, mapping in zip(node.sources_, node.mappings):
            b = self.exec_node(src)
            parts.append(Batch({s: b.columns[mapping[s]]
                                for s in node.symbols}, b.sel))
        return K.concat_batches(parts)

    def _exec_output(self, node: P.Output) -> Batch:
        return self.exec_node(node.source).select(list(node.symbols))

    # ---- the write pipeline (exec/writer.py; reference:
    # TableWriterOperator and TableFinishOperator) ---------------------
    def _exec_tablewriter(self, node: P.TableWriter) -> Batch:
        if self.write_ctx is None:
            raise ExecutionError(
                "TableWriter requires a write context — write statements "
                "execute through exec/writer.run_write")
        from presto_tpu_torch.exec import writer as W

        inner = node.source  # the query's Output node
        b = self.exec_node(inner)
        arrays, types = W._host_arrays(inner, b)
        try:
            n = self.write_ctx.write_page(arrays, types)
        except W.WriteError as e:
            raise ExecutionError(str(e)) from e
        return batch_from_numpy({node.rows_symbol:
                                 np.asarray([n], dtype=np.int64)},
                                {node.rows_symbol: T.BIGINT}, self.device)

    def _exec_tablefinish(self, node: P.TableFinish) -> Batch:
        b = self.exec_node(node.source)
        if self.write_ctx is not None:
            from presto_tpu_torch.exec import writer as W

            try:
                self.write_ctx.finish()  # the commit
            except W.WriteError as e:
                raise ExecutionError(str(e)) from e
        return b


def _f64_values(col: Column, scaled: bool = True) -> torch.Tensor:
    """A numeric column's values as float64: a decimal's divided by
    10^scale unless `scaled` is False (long limbs through
    dec128.to_float64)."""
    x = D128.to_float64(col.data) if col.data.ndim == 2 \
        else col.data.to(torch.float64)
    if scaled and col.type.is_decimal:
        x = DEC.true_div(x, 10 ** col.type.decimal_scale)
    return x


def _python_values(a: np.ndarray) -> list:
    """A result column's values as Python objects, a masked one as None:
    tolist() in one pass over a 1-D column, whose numpy scalars (an
    object column may hold some) become Python values as .item() makes
    them."""
    if a.ndim != 1:
        return [None if np.ma.is_masked(v) else
                v.item() if isinstance(v, np.generic) else v for v in a]
    vals = a.tolist()
    if a.dtype == object:
        vals = [v.item() if isinstance(v, np.generic) else v for v in vals]
    return vals


def _hll_m(a: ir.AggCall) -> int:
    """Register count for an approx_distinct call: its optional second
    argument is a literal maximum standard error."""
    if len(a.args) >= 2 and isinstance(a.args[1], ir.Lit) \
            and a.args[1].value is not None:
        return K.hll_m_for_error(float(a.args[1].value))
    return 1024


def _log2(x: torch.Tensor) -> torch.Tensor:
    """log2 as jnp.log2 computes it, ln(x) / ln(2): entropy of one value
    cancels to exactly 0 this way, where torch.log2's rounding leaves an
    ulp."""
    return DEC.true_div(torch.log(x), math.log(2.0))


def _at_group(values: torch.Tensor, gid: torch.Tensor,
              n_groups: int) -> torch.Tensor:
    """values[gid] for per-group values, a masked row's gid (n_groups)
    clipped onto the last group (its results are masked anyway)."""
    if n_groups == 0:
        return torch.zeros(gid.shape, dtype=values.dtype,
                           device=values.device)
    return values[gid.clamp(0, n_groups - 1).long()]


def _central_moment(fn: str, col: Column, valid, cnt, seg_sum) -> Column:
    """skewness and kurtosis from the raw power sums (the sample
    estimators; NULL below 3 and 4 rows or without spread).  Powers are
    products in the order XLA's integer_pow multiplies them."""
    x = torch.where(valid, col.data.to(torch.float64), 0.0)
    n = cnt.clamp_min(1).to(torch.float64)
    x2 = x * x
    s1, s2, s3 = seg_sum(x), seg_sum(x2), seg_sum(x * x2)
    mu = s1 / n
    mu2 = mu * mu
    m2 = (s2 - n * mu * mu).clamp_min(0.0)
    sd2 = m2 / (n - 1.0).clamp_min(1.0)
    if fn == "skewness":
        m3 = s3 - 3 * mu * s2 + 2 * n * (mu * mu2)
        r = n / ((n - 1) * (n - 2)).clamp_min(1.0) \
            * m3 / (sd2 ** 1.5).clamp_min(1e-300)
        return Column(r, (cnt > 2) & (m2 > 0), T.DOUBLE)
    s4 = seg_sum(x2 * x2)
    m4 = s4 - 4 * mu * s3 + 6 * mu * mu * s2 - 3 * n * (mu2 * mu2)
    d = ((n - 1) * (n - 2) * (n - 3)).clamp_min(1.0)
    r = n * (n + 1) / d * m4 / (sd2 * sd2).clamp_min(1e-300) \
        - 3.0 * ((n - 1) * (n - 1)) / ((n - 2) * (n - 3)).clamp_min(1.0)
    return Column(r, (cnt > 3) & (m2 > 0), T.DOUBLE)


def _bitwise_agg(fn: str, col: Column, valid, gid, n_groups: int,
                 nonempty) -> Column:
    """bitwise_and_agg / bitwise_or_agg: a per-bit grouped min or max
    over the (rows, 64) bit plane, the bits then summed back into one
    int64 (bit 63 wraps into the sign)."""
    shifts = torch.arange(64, dtype=torch.int64, device=col.data.device)
    bits = ((col.data.to(torch.int64)[:, None] >> shifts[None, :]) & 1) \
        .to(torch.int32)
    is_and = fn == "bitwise_and_agg"
    bits = torch.where(valid[:, None], bits, int(is_and))
    red = torch.full((n_groups + 1, 64), int(is_and), dtype=torch.int32,
                     device=bits.device)
    red.scatter_reduce_(0, gid.long()[:, None].expand(-1, 64), bits,
                        "amin" if is_and else "amax")
    r = (red[:n_groups].to(torch.int64) << shifts[None, :]).sum(dim=1)
    return Column(r, nonempty, T.BIGINT)


def _leaf_views(b: Batch) -> Batch:
    """b with every tensor a view of its own (no copy).  Each argument
    of the reference's jitted program is a tracer of its own, so in its
    static executor two scans of one table, or two symbols of one
    column, share no memo entry keyed on identity (_key_fp); the
    dynamic executor's scans share tensors in both packages."""
    def view(t):
        return None if t is None else t.view(t.shape)

    return Batch({sym: Column(view(c.data), view(c.valid), c.type,
                              c.dictionary)
                  for sym, c in b.columns.items()}, view(b.sel))


def scan_batch(table, node: P.TableScan, device: torch.device,
               f32: bool = False) -> Batch:
    """Read + upload a table's columns, with a per-table, per-device
    column cache (upload and dictionary-encode once per process).
    f32=True hands out DOUBLE columns as float32 (the float32_compute
    session property) from a second cache that holds those columns
    alone, so no other column is uploaded twice (reference:
    scan_batch)."""
    caches = table.__dict__.setdefault("_device_cols", {})
    cache = caches.setdefault(str(device), {})
    f32cache = None
    if f32:
        f32cache = table.__dict__.setdefault("_device_cols_f32", {}) \
            .setdefault(str(device), {})

    def cache_for(colname):
        t = table.schema.get(colname)  # virtual pushdown: not in schema
        if f32 and t is not None and t.name == "DOUBLE":
            return f32cache
        return cache

    needed = [c for c in dict.fromkeys(node.assignments.values())
              if c not in cache_for(c)]
    if needed:
        data = table.read(needed)
        for c in needed:
            t = table.schema.get(c, T.BOOLEAN)  # virtual pushdown: BOOLEAN
            col = column_from_numpy(data[c], t, device)
            if f32 and t.name == "DOUBLE":
                col = Column(col.data.to(torch.float32), col.valid,
                             col.type, col.dictionary)
            cache_for(c)[c] = col
    cols = {}
    n = table.row_count() if not node.assignments else None
    for sym, src in node.assignments.items():
        c = cache_for(src)[src]
        cols[sym] = Column(c.data, c.valid, node.types[sym], c.dictionary)
        n = c.data.shape[0]
    # one all-live sel per table and capacity: two scans of a table hand
    # out the same (data, sel) tensors, so the sort memo sees a key of
    # both as one sort (reference: scan_batch)
    sel = cache.get(("__sel__", n))
    if sel is None:
        sel = cache[("__sel__", n)] = torch.ones((n,), dtype=torch.bool,
                                                  device=device)
    return Batch(cols, sel)


def _merge_range(a, b):
    """The union of two ColStats ranges (None when either is unknown):
    one packing layout for both sides of a join key."""
    from presto_tpu_torch.plan.stats import ColStats

    if a is None or b is None or a.min is None or b.min is None \
            or a.max is None or b.max is None:
        return None
    return ColStats(min=min(a.min, b.min), max=max(a.max, b.max))


def _unify_key_dictionaries(lkeys: List[Column], rkeys: List[Column]):
    """Join keys that are string columns with different dictionaries are
    re-encoded into a merged dictionary, so code equality is string
    equality."""
    lout, rout = [], []
    for lc, rc in zip(lkeys, rkeys):
        if not lc.type.is_string or lc.dictionary is rc.dictionary:
            lout.append(lc)
            rout.append(rc)
            continue
        merged = Dictionary(np.unique(np.concatenate(
            [lc.dictionary.values, rc.dictionary.values])))
        for c, out in ((lc, lout), (rc, rout)):
            lut = upload(translate_codes(c.dictionary, merged),
                         c.data.device)
            codes = c.data.clamp(0, len(c.dictionary) - 1).long()
            out.append(Column(lut[codes], c.valid, c.type, merged))
    return lout, rout


def _single_value(b: Batch):
    arrays, sel = to_numpy(b)
    sym = next(iter(arrays))
    vals = arrays[sym][sel]
    if len(vals) == 0:
        return 0, False
    if len(vals) > 1:
        raise ExecutionError("scalar subquery returned more than one row")
    v = vals[0]
    if np.ma.is_masked(v):
        return 0, False
    if isinstance(v, np.generic):
        v = v.item()
    return v, True
