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

Not ported yet, and raising NotImplementedError when reached: chunked
and distributed execution, batched compiled execution and prepared
statements, float32_compute, every statement other than a query (the
write nodes TableWriter and TableFinish with them), the plan nodes
Unnest and SpatialJoin, and the aggregates outside count, count_if,
sum, avg, min and max.  Not ported either, and changing no result: sort-order
materialization (it serves chunked execution), runtime-domain stripe
pruning (df_splits_pruned: its tables are not ported), the host
summaries of the cluster side channel, spill degradation and adaptive
partial aggregation.
"""

from __future__ import annotations

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
from presto_tpu_torch.exec import compile_cache as CC
from presto_tpu_torch.exec import kernels as K
from presto_tpu_torch.exec.colval import translate_codes
from presto_tpu_torch.exec.compiler import (EvalContext, eval_expr,
                                            eval_predicate, to_column)
from presto_tpu_torch.exec.window import execute_window
from presto_tpu_torch.functions.scalar import torch_dtype
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


def _merge_sort_stats(stats, counts: dict) -> None:
    """Add an executor's ordering and dynamic-filtering counters to a
    QueryStats."""
    for k in SORT_STATS_KEYS:
        setattr(stats, k, getattr(stats, k, 0) + int(counts.get(k, 0)))


class StaticFallback(Exception):
    """Raised when a plan cannot run in the static executor (an
    unbounded join fanout, a static expansion too large); "auto" mode
    then runs the dynamic executor."""


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


def _dispatch_statement(session, text: str, stmt, mon) -> QueryResult:
    if not isinstance(stmt, ast.QueryStatement):
        raise NotImplementedError(
            f"{type(stmt).__name__} statements are not ported to "
            "presto_tpu_torch")
    props = session.properties
    if props.get("distributed", False):
        raise NotImplementedError("distributed execution is not ported")
    if props.get("float32_compute", False):
        raise NotImplementedError("float32_compute is not ported")
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
        batches = [scan_batch(session.catalog.get(n.table), n,
                              session.device) for n in scan_nodes]
        meta_box: list = []  # the fetch layout, set by every run
        counts_box: list = [sort_counts]  # the counters, set by every run

        def program(*batches):
            counts = dict(sort_counts)
            counts_box[:] = [counts]
            ex = Executor(session, static=True,
                          scan_inputs={id(n): b for n, b
                                       in zip(scan_nodes, batches)},
                          sort_stats=counts)
            ex.ctx.scalar_results = scalar_results
            out = ex.exec_node(plan.root)
            if bound is not None and out.capacity > 4 * bound:
                out = _compact_batch(out, bound)
            guard = torch.stack([g.reshape(()) for g in ex.guards]).any() \
                if ex.guards else torch.zeros((), dtype=torch.bool,
                                              device=session.device)
            if out.capacity > _PACK_FETCH_MAX or any(
                    c.data.ndim > 1 for c in out.columns.values()):
                # a root over a scan-sized capacity: to_numpy's selective
                # fetch pulls only the live rows
                meta_box[:] = [None]
                return out, guard
            (buf, side), meta = K.pack_fetch(out, guard)
            meta_box[:] = [meta]
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
    meta = meta_box[0]
    ex = Executor(session)
    if meta is None:
        tripped = bool(guard)
        result = None if tripped else ex.run_batch(plan, out)
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


def plan_statement(session, stmt) -> P.QueryPlan:
    """Plan + optimize (the reference also authorizes every scanned table
    against the session's access control, which is not ported)."""
    plan = Planner(session).plan_statement(stmt)
    if session.properties.get("optimizer_enabled", True):
        plan = optimize(plan, session)
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
        rows = []
        n = len(rows_data[0]) if rows_data else 0
        for i in range(n):
            row = []
            for a in rows_data:
                v = a[i] if not np.ma.is_masked(a[i]) else None
                if isinstance(v, np.generic):
                    v = v.item()
                row.append(v)
            rows.append(tuple(row))
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
            self.session.catalog.get(node.table), node, self.device))

    def _exec_values(self, node: P.Values) -> Batch:
        """Literal rows (a SELECT without FROM, VALUES lists) as a batch
        on the session's device (reference: _exec_values)."""
        arrays, valids, types = {}, {}, {}
        for j, (sym, t) in enumerate(zip(node.symbols, node.types_)):
            if t.name in ("ARRAY", "MAP", "ROW"):
                raise NotImplementedError(
                    f"{t.name} values are not ported to presto_tpu_torch")
            vals = [r[j] for r in node.rows]
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
        if not arrays:
            return Batch({}, torch.ones((len(node.rows),), dtype=torch.bool,
                                        device=self.device))
        return batch_from_numpy(arrays, types, self.device, valids)

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
                if a.fn in ("count", "sum", "avg", "min", "max"):
                    # over the deduplicated pre-group these equal their
                    # DISTINCT forms
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

        The gate is the reference's interpreter-path gate: its Pallas
        interpreter keeps f64, as this package's kernel does on every
        device, so float32_compute plays no part here."""
        if not self.session.properties.get("pallas_fused_agg", True):
            return {}
        n = b.capacity
        if n < 32_768 or not (1 <= n_groups <= 4096) or len(aggs) < 2:
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
        if len(chosen) < 2:
            return {}
        rows: List[torch.Tensor] = []
        plan: Dict[str, tuple] = {}
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
                if not col.data.is_floating_point():
                    continue
                valid = mask if col.valid is None else (mask & col.valid)
                vi = len(rows)
                rows.append(torch.where(valid, col.data, 0.0))
                ci = len(rows)
                rows.append(valid)
                plan[sym] = (a.fn, vi, ci, a.type)
        if len(plan) < 2:
            return {}
        sums = K.fused_group_sums(
            torch.stack([r.to(torch.float64) for r in rows]),
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
        if a.fn not in ("count", "sum", "avg", "min", "max"):
            raise NotImplementedError(
                f"aggregate {a.fn} is not ported to presto_tpu_torch")
        col = to_column(eval_expr(a.args[0], b, self.ctx), b.capacity,
                        self.device)
        if col.type.is_decimal:
            raise NotImplementedError("DECIMAL aggregates are not ported")
        valid = mask if col.valid is None else (mask & col.valid)
        cnt = K.segment_sum(valid.to(torch.int32), gid, n_groups,
                            order).to(torch.int64)
        nonempty = cnt > 0
        if a.fn == "count":
            return Column(cnt, None, T.BIGINT)
        if a.fn == "sum":
            x = torch.where(valid, col.data, torch.zeros_like(col.data))
            s = K.segment_sum(x, gid, n_groups, order)
            if a.type.is_integer:
                s = s.to(torch.int64)
            return Column(s.to(torch_dtype(a.type)), nonempty, a.type)
        if a.fn == "avg":
            if a.type.name.startswith("INTERVAL"):
                raise NotImplementedError("avg over intervals is not ported")
            x = torch.where(valid, col.data.to(torch.float64), 0.0)
            s = K.segment_sum(x, gid, n_groups, order)
            return Column(s / cnt.clamp_min(1), nonempty, T.DOUBLE)
        ext = K._reduce_identity(col.data.dtype, a.fn == "min")
        x = torch.where(valid, col.data,
                        torch.full_like(col.data, ext))
        f = K.segment_min if a.fn == "min" else K.segment_max
        return Column(f(x, gid, n_groups).to(col.data.dtype), nonempty,
                      a.type, col.dictionary)

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

    # ---- window and set operations -----------------------------------
    def _exec_window(self, node: P.Window) -> Batch:
        return execute_window(self, node)

    def _exec_union(self, node: P.Union) -> Batch:
        parts = []
        for src, mapping in zip(node.sources_, node.mappings):
            b = self.exec_node(src)
            parts.append(Batch({s: b.columns[mapping[s]]
                                for s in node.symbols}, b.sel))
        return K.concat_batches(parts)

    def _exec_output(self, node: P.Output) -> Batch:
        return self.exec_node(node.source).select(list(node.symbols))


def scan_batch(table, node: P.TableScan, device: torch.device) -> Batch:
    """Read + upload a table's columns, with a per-table, per-device
    column cache (upload and dictionary-encode once per process)."""
    caches = table.__dict__.setdefault("_device_cols", {})
    cache = caches.setdefault(str(device), {})
    needed = [c for c in dict.fromkeys(node.assignments.values())
              if c not in cache]
    if needed:
        data = table.read(needed)
        for c in needed:
            t = table.schema.get(c, T.BOOLEAN)  # virtual pushdown: BOOLEAN
            cache[c] = column_from_numpy(data[c], t, device)
    cols = {}
    n = table.row_count() if not node.assignments else None
    for sym, src in node.assignments.items():
        c = cache[src]
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
