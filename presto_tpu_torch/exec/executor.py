"""Local query executor: logical plan -> torch kernels -> host result.

Reference: presto_tpu/exec/executor.py.  This slice ports the dynamic
executor for scan -> filter -> project -> aggregate -> sort/limit ->
output, the path of TPC-H Q1 and Q6.  Each node materializes a
whole-column Batch on the session's device; filters AND into `sel`.

Not ported yet, and raising NotImplementedError when reached: compiled
and chunked execution, distributed execution, float32_compute, every
statement other than a query, and every plan node outside the slice
(Join, Window, TopN, Union, ...).  Ordering-aware execution (sort
elision, the sort and group-id memos) is not ported either; it never
changes results, only which sorts run.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from presto_tpu_torch import session_ctx
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import Batch, Column, column_from_numpy, to_numpy
from presto_tpu_torch.exec import kernels as K
from presto_tpu_torch.exec.compiler import (EvalContext, eval_expr,
                                            eval_predicate, to_column)
from presto_tpu_torch.functions.scalar import torch_dtype
from presto_tpu_torch.plan import ir
from presto_tpu_torch.plan import nodes as P
from presto_tpu_torch.plan.optimizer import optimize
from presto_tpu_torch.plan.planner import Planner
from presto_tpu_torch.session import QueryResult
from presto_tpu_torch.sql import ast
from presto_tpu_torch.sql.parser import parse


class ExecutionError(Exception):
    pass


def execute_query(session, text: str) -> QueryResult:
    """Query lifecycle wrapper: stats around the dispatch."""
    from presto_tpu_torch.observe.stats import QueryMonitor

    mon = QueryMonitor.begin(session, text)
    session_ctx.activate(session)
    try:
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
    if mode in ("compiled", "chunked"):
        raise NotImplementedError(
            f"execution_mode={mode} is not ported; 'auto' and 'dynamic' "
            "run the dynamic executor")
    if mode not in ("auto", "dynamic"):
        raise ValueError(f"unknown execution_mode {mode!r}")
    # auto runs the dynamic executor, which is where the reference lands
    # after a StaticFallback
    mon.stats.execution_mode = "dynamic"
    with mon.phase("plan"):
        plan = plan_statement(session, stmt)
    with mon.phase("execute"):
        return Executor(session, monitor=mon).run(plan)


def plan_statement(session, stmt) -> P.QueryPlan:
    """Plan + optimize (the reference also authorizes every scanned table
    against the session's access control, which is not ported)."""
    plan = Planner(session).plan_statement(stmt)
    if session.properties.get("optimizer_enabled", True):
        plan = optimize(plan, session)
    return plan


class Executor:
    def __init__(self, session, monitor=None):
        self.session = session
        self.device = session.device
        self.monitor = monitor  # QueryMonitor collecting per-node stats
        self.ctx = EvalContext()

    # ------------------------------------------------------------------
    def run(self, plan: P.QueryPlan) -> QueryResult:
        if self.monitor is not None:
            self.monitor.plan = plan
        batch = self.evaluate(plan)
        arrays, sel = to_numpy(batch)
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
        return scan_batch(self.session.catalog.get(node.table), node,
                          self.device)

    # ---- row-wise ----------------------------------------------------
    def _exec_filter(self, node: P.Filter) -> Batch:
        b = self.exec_node(node.source)
        return b.with_sel(b.sel & eval_predicate(node.predicate, b, self.ctx))

    def _exec_project(self, node: P.Project) -> Batch:
        b = self.exec_node(node.source)
        cols = {sym: to_column(eval_expr(e, b, self.ctx), b.capacity,
                               self.device)
                for sym, e in node.assignments.items()}
        return Batch(cols, b.sel)

    # ---- aggregation -------------------------------------------------
    def _exec_aggregate(self, node: P.Aggregate) -> Batch:
        b = self.exec_node(node.source)
        if any(a.distinct for a in node.aggs.values()):
            raise NotImplementedError("DISTINCT aggregates are not ported")
        return self._aggregate(b, node.group_keys, node.aggs, node)

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
        pack_order = self._agg_pack_order(node, group_keys)
        pack_cols = [b.columns[k] for k in pack_order]
        key, layout = K.pack_keys(pack_cols, b.sel)
        gid = None
        if layout is not None and self.session.properties.get(
                "ordering_aware_execution", True) \
                and getattr(node, "ordering_hint", None) == pack_order[0]:
            # presorted grouping: run-boundary scan, no sort; falls back
            # to the sort path when the ordering claim lied
            g2, newgrp, ng_t, guard = K.group_ids_presorted(key, b.sel)
            if not bool(guard):
                n_groups = int(ng_t)
                gid = g2
                rep_rows = K.nonzero_i32(newgrp, max(n_groups, 1),
                                         0)[:n_groups]
        if gid is None:
            gid, rep_rows, n_groups = K.group_ids(key, b.sel)
        out_cols: Dict[str, Column] = {}
        raw, _ = K.take_columns({k: b.columns[k] for k in group_keys},
                                rep_rows)
        for k, (data, valid) in raw.items():
            c = b.columns[k]
            out_cols[k] = Column(data, valid, c.type, c.dictionary)
        fused = self._fused_sum_aggs(b, aggs, gid, n_groups)
        for sym, a in aggs.items():
            out_cols[sym] = fused.get(sym) or self._agg_column(b, a, gid,
                                                               n_groups)
        sel = torch.ones((max(n_groups, 0),), dtype=torch.bool,
                         device=self.device)
        return Batch(out_cols, sel)

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

    def _agg_column(self, b: Batch, a: ir.AggCall, gid, n_groups) -> Column:
        mask = b.sel
        if a.filter is not None:
            mask = mask & eval_predicate(a.filter, b, self.ctx)
        if a.fn == "count" and not a.args:
            cnt = K.segment_sum(mask.to(torch.int32), gid, n_groups)
            return Column(cnt.to(torch.int64), None, T.BIGINT)
        if a.fn == "count_if":
            v = to_column(eval_expr(a.args[0], b, self.ctx), b.capacity,
                          self.device)
            m = mask & v.data
            if v.valid is not None:
                m = m & v.valid
            return Column(K.segment_sum(m.to(torch.int32), gid,
                                        n_groups).to(torch.int64),
                          None, T.BIGINT)
        if a.fn not in ("count", "sum", "avg", "min", "max"):
            raise NotImplementedError(
                f"aggregate {a.fn} is not ported to presto_tpu_torch")
        col = to_column(eval_expr(a.args[0], b, self.ctx), b.capacity,
                        self.device)
        if col.type.is_decimal:
            raise NotImplementedError("DECIMAL aggregates are not ported")
        valid = mask if col.valid is None else (mask & col.valid)
        cnt = K.segment_sum(valid.to(torch.int32), gid,
                            n_groups).to(torch.int64)
        nonempty = cnt > 0
        if a.fn == "count":
            return Column(cnt, None, T.BIGINT)
        if a.fn == "sum":
            x = torch.where(valid, col.data, torch.zeros_like(col.data))
            s = K.segment_sum(x, gid, n_groups)
            if a.type.is_integer:
                s = s.to(torch.int64)
            return Column(s.to(torch_dtype(a.type)), nonempty, a.type)
        if a.fn == "avg":
            if a.type.name.startswith("INTERVAL"):
                raise NotImplementedError("avg over intervals is not ported")
            x = torch.where(valid, col.data.to(torch.float64), 0.0)
            s = K.segment_sum(x, gid, n_groups)
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
        out_cols = {sym: self._agg_column(b, a, gid, 1)
                    for sym, a in aggs.items()}
        return Batch(out_cols, torch.ones((1,), dtype=torch.bool,
                                          device=self.device))

    # ---- ordering ----------------------------------------------------
    def _exec_sort(self, node: P.Sort) -> Batch:
        b = self.exec_node(node.source)
        keys = [(b.columns[s], asc, nf) for s, asc, nf in node.keys]
        return K.gather_batch(b, K.sort_perm(b, keys))

    def _exec_limit(self, node: P.Limit) -> Batch:
        b = self.exec_node(node.source)
        n = min(int(node.count), b.capacity)
        rank = torch.cumsum(b.sel.to(torch.int32), 0)
        return b.with_sel(b.sel & (rank <= n))

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
    return Batch(cols, torch.ones((n,), dtype=torch.bool, device=device))


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
