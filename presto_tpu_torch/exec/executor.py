"""Local query executor: logical plan -> torch kernels -> host result.

Reference: presto_tpu/exec/executor.py.  This slice ports the dynamic
executor for values/scan -> filter -> project -> join -> aggregate
(DISTINCT aggregates included) -> sort/topn/limit -> output, the path of
all 22 TPC-H queries.  Each node materializes a whole-column Batch on
the session's device; filters AND into `sel`.  Joins run INNER, LEFT,
RIGHT (the mirrored LEFT), SEMI, ANTI and MARK, as index joins or sort
joins (`kernels.build_probe`), always resident.

Not ported yet, and raising NotImplementedError when reached: compiled
and chunked execution, distributed execution, float32_compute, every
statement other than a query, FULL and CROSS joins, and every plan node
outside the slice (Window, Union, ...).  Ordering-aware execution (sort
elision, the sort, group-id and build-order memos), dynamic filtering
and spill degradation are not ported either; none of them changes
results, only which sorts run and which rows are pruned early.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from presto_tpu_torch import session_ctx
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import (Batch, Column, Dictionary,
                                    batch_from_numpy, column_from_numpy,
                                    to_numpy)
from presto_tpu_torch.exec import kernels as K
from presto_tpu_torch.exec.colval import translate_codes
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
        # plan DAGs (transitive semi-join inference shares a filter
        # subquery between both join sides) run each shared node once
        self._shared_results: Dict[int, tuple] = {}

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
        return scan_batch(self.session.catalog.get(node.table), node,
                          self.device)

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
        order = K.GroupOrder(gid, n_groups)  # shared by the sums below
        for sym, a in aggs.items():
            out_cols[sym] = fused.get(sym) or self._agg_column(b, a, order)
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
    def _exec_sort(self, node: P.Sort) -> Batch:
        b = self.exec_node(node.source)
        keys = [(b.columns[s], asc, nf) for s, asc, nf in node.keys]
        return K.gather_batch(b, K.sort_perm(b, keys))

    def _exec_topn(self, node: P.TopN) -> Batch:
        """TopN = key sort + k-row gather (reference: TopNOperator's
        bounded heap), without a full-capacity gather of every column."""
        b = self.exec_node(node.source)
        keys = [(b.columns[s], asc, nf) for s, asc, nf in node.keys]
        perm = K.sort_perm(b, keys)  # masked rows sort last
        k = min(int(node.count), b.capacity)
        if k == b.capacity:
            return K.gather_batch(b, perm)
        out = K.gather_batch(b, perm[:k])
        live = torch.arange(k, device=self.device) < b.sel.sum()
        return out.with_sel(out.sel & live)

    def _exec_limit(self, node: P.Limit) -> Batch:
        return self._limit(self.exec_node(node.source), node.count)

    @staticmethod
    def _limit(b: Batch, n: int) -> Batch:
        n = min(int(n), b.capacity)
        rank = torch.cumsum(b.sel.to(torch.int32), 0)
        return b.with_sel(b.sel & (rank <= n))

    # ---- joins -------------------------------------------------------
    def _exec_join(self, node: P.Join) -> Batch:
        if node.join_type in ("FULL", "CROSS"):
            raise NotImplementedError(
                f"{node.join_type} joins are not ported to presto_tpu_torch")
        left = self.exec_node(node.left)
        right = self.exec_node(node.right)
        if node.join_type == "RIGHT":
            # RIGHT = mirrored LEFT with output order left-cols-first
            node = P.Join(node.right, node.left, "LEFT",
                          [(rk, lk) for lk, rk in node.criteria], node.filter)
            left, right = right, left
        return self._join_batches(left, right, node)

    def _join_batches(self, left: Batch, right: Batch, node: P.Join) -> Batch:
        jt = node.join_type
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
            rkey, layout = K.pack_keys(rkeys, rsel, extra_cols=lkeys)
            lkey = K.pack_with_layout(lkeys, lsel, layout)
            order, lb, ub = K.build_probe(rkey, lkey)
            counts = ub - lb

        if jt == "MARK":  # filter-free by construction (planner)
            return self._mark_join(left, right, node, lkeys, rkeys, counts)
        if jt in ("SEMI", "ANTI") and node.filter is None:
            found = counts > 0
            return left.with_sel(left.sel & (found if jt == "SEMI"
                                             else ~found))
        # a dense unique build has at most one match: no host sync
        max_matches = 1 if index_ridx is not None else \
            (int(counts.max()) if counts.shape[0] else 0)
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
        probe much wider than a strided build, or a build whose rows do
        not hold the claimed layout (checked on the host)."""
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
        base = torch.tensor(il["min"], dtype=torch.int64,
                            device=self.device) if full_build else rk[0]
        expect = base + (ar // br) * bk + ar % br if strided else base + ar
        if bool((rsel & (rk != expect)).any()):
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
            lut = torch.from_numpy(translate_codes(c.dictionary, merged)) \
                .to(c.data.device)
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
