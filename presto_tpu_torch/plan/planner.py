"""Analyzer + logical planner: AST -> typed logical plan.

Reference parity: sql/analyzer/StatementAnalyzer.java +
ExpressionAnalyzer.java (scopes, name resolution, type checking, coercions)
and sql/planner/{LogicalPlanner,RelationPlanner,QueryPlanner,SubqueryPlanner}.
Collapsed into one pass that emits typed IR directly (the reference's
separate Analysis object buys incremental re-analysis we don't need).

Subquery handling (reference: SubqueryPlanner + TransformCorrelated* rules):
- EXISTS / IN-subquery conjuncts  -> SEMI/ANTI join (+ residual filter)
- correlated scalar-aggregate subquery -> grouped aggregate joined on the
  correlation keys
- uncorrelated scalar subquery -> separately-planned subplan referenced by
  a ScalarSub IR leaf (evaluated first, like a gather-exchange stage)
"""

from __future__ import annotations

import itertools
import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from presto_tpu_torch import types as T
from presto_tpu_torch.functions import aggregate as agg_fns
from presto_tpu_torch.functions import scalar as scalar_fns
from presto_tpu_torch.plan import ir
from presto_tpu_torch.plan import nodes as P
from presto_tpu_torch.sql import ast


class SemanticError(Exception):
    pass


@dataclass
class Field_:
    qualifier: Optional[str]
    name: Optional[str]
    symbol: str
    type: T.Type


@dataclass
class Scope:
    fields: List[Field_] = field(default_factory=list)
    parent: Optional["Scope"] = None  # outer query scope (correlation)

    def resolve(self, parts: Tuple[str, ...]) -> Tuple[Field_, bool]:
        """Returns (field, is_outer)."""
        matches = self._match(parts)
        if len(matches) == 1:
            return matches[0], False
        if len(matches) > 1:
            raise SemanticError(f"Column '{'.'.join(parts)}' is ambiguous")
        if self.parent is not None:
            f, _ = self.parent.resolve(parts)
            return f, True
        raise SemanticError(f"Column '{'.'.join(parts)}' cannot be resolved")

    def _match(self, parts):
        if len(parts) == 1:
            return [f for f in self.fields if f.name == parts[0]]
        if len(parts) >= 2:
            q, n = parts[-2], parts[-1]
            return [f for f in self.fields if f.name == n and f.qualifier == q]
        return []

    def visible(self):
        return [f for f in self.fields if f.name is not None]


class SymbolAllocator:
    def __init__(self):
        self.counter = itertools.count()

    def new(self, hint: str) -> str:
        return f"{hint}${next(self.counter)}"


class Planner:
    def __init__(self, session):
        self.session = session
        self.catalog = session.catalog
        self.symbols = SymbolAllocator()
        self.subplans: Dict[int, P.PlanNode] = {}
        self.subplan_ids = itertools.count()
        self.cte_stack: List[Dict[str, tuple]] = []
        # id(ast.ScalarSubquery) -> decorrelated column Ref (see
        # _try_subquery_conjunct's general correlated form)
        self._scalar_sub_overrides: Dict[int, ir.RowExpr] = {}
        self._mark_overrides: Dict[int, str] = {}  # Exists/In -> mark sym

    # ------------------------------------------------------------------
    def plan_statement(self, stmt: ast.Statement) -> P.QueryPlan:
        if isinstance(stmt, ast.QueryStatement):
            node, scope, names = self.plan_query(stmt.query)
            out = P.Output(node, names, [f.symbol for f in scope.fields])
            return P.QueryPlan(out, self.subplans)
        raise SemanticError(f"unsupported statement: {type(stmt).__name__}")

    # ------------------------------------------------------------------
    @staticmethod
    def wrap_write(inner: P.QueryPlan, target: str, connector: str,
                   columns, write_props) -> P.QueryPlan:
        """Wrap an (already optimized) query plan as a write plan:
        Output <- TableFinish <- TableWriter <- inner (reference:
        LogicalPlanner.createTableWriterPlan).  The write metadata is
        plain data on the nodes; the runtime sink state lives in the
        executor's WriteContext (exec/writer.py)."""
        tw = P.TableWriter(source=inner.root, target=target,
                           connector=connector, columns=list(columns),
                           write_props=write_props)
        tf = P.TableFinish(source=tw)
        out = P.Output(source=tf, names=["rows"],
                       symbols=[tw.rows_symbol])
        return P.QueryPlan(root=out, subplans=inner.subplans)

    # ------------------------------------------------------------------
    def plan_query(self, q: ast.Query, outer: Optional[Scope] = None):
        """Returns (plan, scope, output names)."""
        if q.ctes:
            self.cte_stack.append({name.lower(): (query, cols) for name, query, cols in q.ctes})
        try:
            node, scope, names = self._plan_body(q.body, outer)
            if q.order_by:
                node, scope = self._plan_order_limit(node, scope, names, q.order_by, q.limit, outer)
            elif q.limit is not None:
                node = P.Limit(node, q.limit)
            return node, scope, names
        finally:
            if q.ctes:
                self.cte_stack.pop()

    def _plan_body(self, body, outer):
        if isinstance(body, ast.QuerySpec):
            return self.plan_query_spec(body, outer)
        if isinstance(body, ast.SetOp):
            return self._plan_set_op(body, outer)
        raise SemanticError(f"unsupported query body {type(body).__name__}")

    def _plan_set_op(self, op: ast.SetOp, outer):
        lnode, lscope, lnames = self._plan_body(op.left, outer)
        rnode, rscope, rnames = self._plan_body(op.right, outer)
        lf, rf = lscope.fields, rscope.fields
        if len(lf) != len(rf):
            raise SemanticError("set operation column count mismatch")
        if op.op == "UNION":
            out_syms, mappings_l, mappings_r = [], {}, {}
            out_fields = []
            for a, b in zip(lf, rf):
                ct = T.common_super_type(a.type, b.type)
                if ct is None:
                    raise SemanticError(f"UNION type mismatch {a.type} vs {b.type}")
                s = self.symbols.new(a.name or "col")
                out_syms.append(s)
                mappings_l[s] = a.symbol
                mappings_r[s] = b.symbol
                out_fields.append(Field_(None, a.name, s, ct))
            node = P.Union([lnode, rnode], out_syms, [mappings_l, mappings_r])
            scope = Scope(out_fields)
            if not op.all:
                node = P.Aggregate(node, out_syms, {}, "SINGLE")
            return node, scope, lnames
        # INTERSECT/EXCEPT via SEMI/ANTI join on all columns (distinct first)
        join_type = "SEMI" if op.op == "INTERSECT" else "ANTI"
        lnode = P.Aggregate(lnode, [f.symbol for f in lf], {}, "SINGLE")
        criteria = [(a.symbol, b.symbol) for a, b in zip(lf, rf)]
        node = P.Join(lnode, rnode, join_type, criteria)
        return node, lscope, lnames

    # ------------------------------------------------------------------
    def _expand_grouping_sets(self, spec: ast.QuerySpec):
        """GROUPING SETS/ROLLUP/CUBE -> UNION ALL of per-set aggregations
        (reference: GroupIdNode + GroupIdOperator, expressed as a set
        union instead of a group-id column).  Select items that are
        grouping keys excluded from a set become typed NULLs (UNION
        coercion settles the type)."""
        all_keys = set()
        for s in spec.grouping_sets:
            for e in s:
                all_keys.add(_ast_key(e))

        def name_of(item):
            if item.alias:
                return item.alias
            if isinstance(item.expr, ast.Identifier):
                return item.expr.parts[-1]
            return None

        def null_out(expr, excluded):
            """Replace references to rolled-up keys with NULL literals
            inside arbitrary select expressions (e.g. the lochierarchy
            CASE of TPC-DS q86 referencing a rolled-up column), and
            resolve grouping(e1..en) to its per-branch literal bitmask
            (reference: GroupingOperationRewriter — grouping() is a
            constant once the grouping set is fixed)."""
            if isinstance(expr, ast.FunctionCall) \
                    and expr.name.lower() == "grouping":
                bits = 0
                for a in expr.args:
                    bits = bits * 2 + (1 if _ast_key(a) in excluded else 0)
                return ast.Literal(bits)
            if isinstance(expr, ast.Expr) and _ast_key(expr) in excluded:
                return ast.Literal(None)
            if isinstance(expr, ast.FunctionCall) \
                    and agg_fns.is_aggregate(expr.name):
                return expr  # aggregate args see underlying rows, not NULLs
            if not isinstance(expr, ast.Node):
                return expr
            def sub(v):
                if isinstance(v, ast.Node):
                    return null_out(v, excluded)
                if isinstance(v, (list, tuple)):  # e.g. CASE whens pairs
                    return type(v)(sub(x) for x in v)
                return v

            changed = {}
            for f in dataclasses.fields(expr):
                v = getattr(expr, f.name)
                nv = sub(v)
                if nv is not v and nv != v:
                    changed[f.name] = nv
            return dataclasses.replace(expr, **changed) if changed else expr

        branches = []
        for s in spec.grouping_sets:
            in_set = {_ast_key(e) for e in s}
            excluded = all_keys - in_set
            items = []
            for item in spec.select:
                k = _ast_key(item.expr)
                if k in all_keys and k not in in_set:
                    items.append(ast.SelectItem(ast.Literal(None),
                                                name_of(item)))
                elif k not in all_keys:
                    # null_out with an empty exclusion set still resolves
                    # grouping() (all bits 0 in the finest branch)
                    items.append(ast.SelectItem(
                        null_out(item.expr, excluded), name_of(item)))
                else:
                    items.append(item)
            branches.append(ast.QuerySpec(
                items, spec.distinct, spec.from_, spec.where, list(s),
                spec.having))
        body = branches[0]
        for b in branches[1:]:
            body = ast.SetOp("UNION", True, body, b)
        return body

    def plan_query_spec(self, spec: ast.QuerySpec, outer):
        if getattr(spec, "grouping_sets", None):
            return self._plan_body(self._expand_grouping_sets(spec), outer)
        # FROM
        if spec.from_ is not None:
            node, scope = self.plan_relation(spec.from_, outer)
        else:
            sym = self.symbols.new("dual")
            node = P.Values([sym], [T.BIGINT], [[0]])
            scope = Scope([])
        scope.parent = outer

        # WHERE (with subquery conjuncts)
        if spec.where is not None:
            node = self._plan_where(node, scope, spec.where)

        # aggregation analysis
        agg_calls: List[Tuple[ast.FunctionCall, str]] = []  # (ast node, out symbol)
        # GROUP BY ordinals resolve to select-list expressions (reference:
        # StatementAnalyzer.analyzeGroupBy ordinal handling)
        group_by = []
        for ge in (spec.group_by or []):
            if isinstance(ge, ast.Literal) and isinstance(ge.value, int) \
                    and not isinstance(ge.value, bool):
                k = ge.value
                if not (1 <= k <= len(spec.select)) \
                        or isinstance(spec.select[k - 1].expr, ast.Star):
                    raise SemanticError(
                        f"GROUP BY position {k} is not in select list")
                group_by.append(spec.select[k - 1].expr)
            else:
                group_by.append(ge)
        has_group = bool(group_by)
        exprs_to_scan = [it.expr for it in spec.select if not isinstance(it.expr, ast.Star)]
        if spec.having is not None:
            exprs_to_scan.append(spec.having)
        for e in exprs_to_scan:
            self._collect_aggs(e, agg_calls)
        has_agg = bool(agg_calls) or has_group

        select_scope = scope
        if has_agg:
            node, select_scope, agg_map, group_map = self._plan_aggregation(
                node, scope, group_by, agg_calls, outer)
        else:
            agg_map, group_map = {}, {}

        # HAVING
        if spec.having is not None:
            node = self._plan_where(node, select_scope, spec.having,
                                    agg_map=agg_map, group_map=group_map)

        # window functions: plan one Window node per distinct
        # (partition, order, frame) spec, evaluated after aggregation
        # (reference: sql/planner/QueryPlanner.window + WindowNode)
        win_calls: List[ast.FunctionCall] = []
        for e in exprs_to_scan:
            self._collect_windows(e, win_calls)
        if win_calls:
            node, win_map = self._plan_windows(
                node, select_scope, win_calls, agg_map, group_map)
            agg_map = {**(agg_map or {}), **win_map}

        # SELECT projections
        assignments: Dict[str, ir.RowExpr] = {}
        out_fields: List[Field_] = []
        names: List[str] = []
        for item in spec.select:
            if isinstance(item.expr, ast.Star):
                for f in (select_scope.visible() if item.expr.qualifier is None else
                          [f for f in select_scope.fields if f.qualifier == item.expr.qualifier]):
                    s = self.symbols.new(f.name or "col")
                    assignments[s] = ir.Ref(f.symbol, f.type)
                    out_fields.append(Field_(None, f.name, s, f.type))
                    names.append(f.name or "_col")
                continue
            e = self.analyze(item.expr, select_scope, agg_map=agg_map, group_map=group_map)
            name = item.alias or self._derive_name(item.expr)
            s = self.symbols.new(name or "expr")
            assignments[s] = e
            out_fields.append(Field_(None, name, s, e.type))
            names.append(name or "_col")
        node = P.Project(node, assignments)
        scope_out = Scope(out_fields)

        if spec.distinct:
            node = P.Aggregate(node, [f.symbol for f in out_fields], {}, "SINGLE")

        # stash for ORDER BY resolution: keep pre-projection scope available
        scope_out.pre_projection = (select_scope, agg_map, group_map)  # type: ignore
        return node, scope_out, names

    def _derive_name(self, e: ast.Expr) -> Optional[str]:
        if isinstance(e, ast.Identifier):
            return e.name
        if isinstance(e, ast.FunctionCall):
            return e.name
        return None

    # ------------------------------------------------------------------
    def _plan_order_limit(self, node, scope, names, order_by, limit, outer):
        """Sort may reference select aliases, ordinals, or (for non-agg
        queries) underlying columns; extra sort keys are projected then
        trimmed (reference: QueryPlanner.planOrderBy)."""
        keys = []
        extra_assignments = {}
        pre = getattr(scope, "pre_projection", None)
        for si in order_by:
            e = si.expr
            sym = None
            if isinstance(e, ast.Literal) and isinstance(e.value, int):
                idx = e.value - 1
                if not (0 <= idx < len(scope.fields)):
                    raise SemanticError(f"ORDER BY position {e.value} out of range")
                sym = scope.fields[idx].symbol
            elif isinstance(e, ast.Identifier) and len(e.parts) == 1:
                matches = [f for f in scope.fields if f.name == e.name]
                if matches:
                    sym = matches[0].symbol
            if sym is None:
                if pre is not None:
                    sel_scope, agg_map, group_map = pre
                    rex = self.analyze(e, sel_scope, agg_map=agg_map, group_map=group_map)
                else:
                    rex = self.analyze(e, scope)
                s = self.symbols.new("sortkey")
                extra_assignments[s] = rex
                sym = s
            keys.append((sym, si.ascending, si.nulls_first))
        if extra_assignments:
            if isinstance(node, P.Project):
                node = P.Project(node.source,
                                 {**node.assignments, **extra_assignments})
            else:
                # non-projection source (e.g. the UNION of grouping-set
                # branches under a computed ORDER BY key, q36/q70):
                # wrap in an identity projection carrying the sort keys
                assigns = {f.symbol: ir.Ref(f.symbol, f.type)
                           for f in scope.fields}
                node = P.Project(node, {**assigns, **extra_assignments})
        if limit is not None:
            node = P.TopN(node, keys, limit)
        else:
            node = P.Sort(node, keys)
        if extra_assignments:
            # trim the extra sort keys after sorting
            keep = {f.symbol: ir.Ref(f.symbol, f.type) for f in scope.fields}
            node = P.Project(node, keep)
        return node, scope

    # ------------------------------------------------------------------
    # relations
    # ------------------------------------------------------------------
    def plan_relation(self, rel: ast.Relation, outer) -> Tuple[P.PlanNode, Scope]:
        if isinstance(rel, ast.Table):
            return self._plan_table(rel, outer)
        if isinstance(rel, ast.SubqueryRelation):
            node, scope, names = self.plan_query(rel.query, outer)
            q = rel.alias
            fields = []
            for i, f in enumerate(scope.fields):
                nm = (rel.column_aliases[i] if rel.column_aliases and i < len(rel.column_aliases)
                      else f.name)
                fields.append(Field_(q, nm, f.symbol, f.type))
            return node, Scope(fields)
        if isinstance(rel, ast.Join):
            return self._plan_join(rel, outer)
        if isinstance(rel, ast.ValuesRelation):
            return self._plan_values(rel)
        if isinstance(rel, ast.Unnest):
            # standalone FROM UNNEST(...): explode over a one-row source
            sym = self.symbols.new("dual")
            dual = P.Values([sym], [T.BIGINT], [[0]])
            return self._plan_unnest(dual, Scope([]), rel)
        raise SemanticError(f"unsupported relation {type(rel).__name__}")

    def _plan_unnest(self, lnode, lscope, rel: ast.Unnest):
        """Lateral UNNEST: the array expression may reference the left
        relation's columns (reference: UnnestNode planned from a lateral
        Join in RelationPlanner.visitUnnest)."""
        if len(rel.exprs) != 1:
            raise SemanticError("UNNEST of multiple arrays not supported yet")
        rex = self.analyze(rel.exprs[0], lscope)
        if rex.type.name != "ARRAY":
            raise SemanticError(f"UNNEST argument must be an ARRAY, got {rex.type}")
        elem = rex.type.params[0] if rex.type.params else T.UNKNOWN
        out_sym = self.symbols.new("unnest")
        ord_sym = self.symbols.new("ordinality") if rel.with_ordinality else None
        node = P.Unnest(lnode, rex, out_sym, elem, ord_sym)
        q = rel.alias
        aliases = getattr(rel, "column_aliases", None) or []
        fields = list(lscope.fields)
        fields.append(Field_(q, aliases[0] if aliases else (q or "col"),
                             out_sym, elem))
        if ord_sym:
            fields.append(Field_(q, aliases[1] if len(aliases) > 1
                                 else "ordinality", ord_sym, T.BIGINT))
        return node, Scope(fields)

    def _plan_table(self, rel: ast.Table, outer):
        name = rel.name.lower()
        for ctes in reversed(self.cte_stack):
            if name in ctes:
                query, col_aliases = ctes[name]
                node, scope, names = self.plan_query(query, None)
                q = rel.alias or rel.name
                fields = []
                for i, f in enumerate(scope.fields):
                    nm = (col_aliases[i] if col_aliases and i < len(col_aliases) else f.name)
                    fields.append(Field_(q, nm, f.symbol, f.type))
                return node, Scope(fields)
        table = self.catalog.get(name)
        assignments, types, fields = {}, {}, []
        # implicit qualifier is the bare table name (reference: a qualified
        # name's last part is the relation alias)
        q = rel.alias or rel.name.split(".")[-1]
        for i, (col, typ) in enumerate(table.schema.items()):
            nm = (rel.column_aliases[i] if rel.column_aliases and i < len(rel.column_aliases)
                  else col)
            s = self.symbols.new(col)
            assignments[s] = col
            types[s] = typ
            fields.append(Field_(q, nm, s, typ))
        node = P.TableScan(name, assignments, types)
        if getattr(rel, "sample", None):
            # TABLESAMPLE BERNOULLI(p): keep each row with probability
            # p% (reference: SampleNode; SYSTEM trims to the same
            # row-level bernoulli — this engine has no split-local
            # storage granularity worth sampling by)
            _method, pct = rel.sample
            pred = ir.Call(
                "lt", (ir.Call("random", (), T.DOUBLE),
                       ir.Lit(pct / 100.0, T.DOUBLE)), T.BOOLEAN)
            node = P.Filter(node, pred)
        return node, Scope(fields)

    def _plan_values(self, rel: ast.ValuesRelation):
        rows = []
        col_types: List[T.Type] = []
        for row in rel.rows:
            vals = []
            for j, e in enumerate(row):
                rex = self.analyze(e, Scope([]))
                # fold CAST(NULL AS t) — the idiomatic way to type a
                # NULL column in VALUES (reference VALUES accepts
                # arbitrary constant expressions)
                if isinstance(rex, ir.CastExpr) and \
                        isinstance(rex.arg, ir.Lit) and rex.arg.value is None:
                    rex = ir.Lit(None, rex.type)
                if not isinstance(rex, ir.Lit):
                    # constant expressions (ARRAY[..] / MAP(..) ctors,
                    # arithmetic over literals) fold at plan time —
                    # the reference's VALUES accepts any constant expr
                    folded = _fold_constant_expr(rex)
                    if folded is None:
                        raise SemanticError(
                            "VALUES requires constant expressions")
                    rex = folded
                vals.append(rex.value)
                if j >= len(col_types):
                    col_types.append(rex.type)
                else:
                    ct = T.common_super_type(col_types[j], rex.type)
                    if ct is None:
                        raise SemanticError("VALUES type mismatch")
                    col_types[j] = ct
            rows.append(vals)
        syms = [self.symbols.new(f"col{j}") for j in range(len(col_types))]
        aliases = rel.column_aliases or [f"_col{j}" for j in range(len(col_types))]
        fields = [Field_(rel.alias, aliases[j] if j < len(aliases) else f"_col{j}",
                         syms[j], col_types[j]) for j in range(len(col_types))]
        return P.Values(syms, col_types, rows), Scope(fields)

    def _plan_join(self, rel: ast.Join, outer):
        lnode, lscope = self.plan_relation(rel.left, outer)
        if isinstance(rel.right, ast.Unnest):
            if rel.join_type != "CROSS":
                raise SemanticError("UNNEST joins must be CROSS JOIN / comma")
            return self._plan_unnest(lnode, lscope, rel.right)
        rnode, rscope = self.plan_relation(rel.right, outer)
        combined = Scope(lscope.fields + rscope.fields)
        jt = rel.join_type
        if jt == "CROSS":
            return P.Join(lnode, rnode, "CROSS"), combined
        criteria: List[Tuple[str, str]] = []
        residual: List[ir.RowExpr] = []
        left_only: List[ir.RowExpr] = []
        right_only: List[ir.RowExpr] = []
        lsyms = {f.symbol for f in lscope.fields}
        rsyms = {f.symbol for f in rscope.fields}
        conjs: List[ast.Expr] = []
        if rel.using:
            for col in rel.using:
                conjs.append(ast.BinaryOp("=", ast.Identifier((col,)), ast.Identifier((col,))))
                # resolve each side explicitly below
        else:
            conjs = _ast_conjuncts(rel.on)
        for c in conjs:
            if rel.using and isinstance(c, ast.BinaryOp) and c.op == "=":
                colname = c.left.name  # type: ignore
                lf = [f for f in lscope.fields if f.name == colname]
                rf = [f for f in rscope.fields if f.name == colname]
                if not lf or not rf:
                    raise SemanticError(f"USING column {colname} missing")
                criteria.append((lf[0].symbol, rf[0].symbol))
                continue
            rex = self.analyze(c, combined)
            refs = rex.refs()
            if isinstance(rex, ir.Call) and rex.fn == "eq":
                a, b = rex.args
                ar, br = a.refs(), b.refs()
                if ar and br:
                    if ar <= lsyms and br <= rsyms:
                        criteria.append((self._as_symbol(a, "lk"), self._as_symbol(b, "rk")))
                        lnode, rnode = self._attach_key(lnode, a), self._attach_key(rnode, b)
                        continue
                    if ar <= rsyms and br <= lsyms:
                        criteria.append((self._as_symbol(b, "lk"), self._as_symbol(a, "rk")))
                        lnode, rnode = self._attach_key(lnode, b), self._attach_key(rnode, a)
                        continue
            if refs and refs <= lsyms:
                left_only.append(rex)
            elif refs and refs <= rsyms:
                right_only.append(rex)
            else:
                residual.append(rex)
        # push single-side conjuncts (semantics-preserving placement by join type)
        if jt == "INNER":
            if left_only:
                lnode = P.Filter(lnode, ir.combine_conjuncts(left_only))
            if right_only:
                rnode = P.Filter(rnode, ir.combine_conjuncts(right_only))
        else:
            if jt == "LEFT" and right_only:
                rnode = P.Filter(rnode, ir.combine_conjuncts(right_only))
            elif jt == "RIGHT" and left_only:
                lnode = P.Filter(lnode, ir.combine_conjuncts(left_only))
            else:
                residual.extend(left_only + right_only)
        node = P.Join(lnode, rnode, jt, criteria, ir.combine_conjuncts(residual))
        return node, combined

    def _as_symbol(self, e: ir.RowExpr, hint: str) -> str:
        if isinstance(e, ir.Ref):
            return e.name
        s = self.symbols.new(hint)
        # RowExprs are frozen dataclasses: attach the planning-only
        # symbol without tripping __setattr__ (a literal or computed
        # join key lands here, e.g. ON l.x = u.k after `1 AS x` inlines)
        object.__setattr__(e, "_planned_symbol", s)
        return s

    def _attach_key(self, node: P.PlanNode, e: ir.RowExpr) -> P.PlanNode:
        """If a join key is a computed expression, project it onto the input."""
        if isinstance(e, ir.Ref):
            return node
        sym = getattr(e, "_planned_symbol")
        assigns = {s: ir.Ref(s, t) for s, t in node.outputs()}
        assigns[sym] = e
        return P.Project(node, assigns)

    # ------------------------------------------------------------------
    # WHERE / HAVING with subquery conjunct handling
    # ------------------------------------------------------------------
    def _plan_where(self, node, scope, pred: ast.Expr, agg_map=None, group_map=None):
        plain: List[ir.RowExpr] = []
        for conj in _ast_conjuncts(pred):
            node, handled = self._try_subquery_conjunct(node, scope, conj, agg_map, group_map)
            if handled:
                continue
            plain.append(self.analyze(conj, scope, agg_map=agg_map, group_map=group_map))
        if plain:
            node = P.Filter(node, ir.combine_conjuncts(plain))
        return node

    def _try_subquery_conjunct(self, node, scope, conj, agg_map, group_map):
        neg = False
        inner = conj
        while isinstance(inner, ast.UnaryOp) and inner.op == "NOT":
            neg = not neg
            inner = inner.operand
        if isinstance(inner, ast.Exists):
            sub = inner.query
            negated = neg != inner.negated
            return self._plan_exists(node, scope, sub, negated), True
        if isinstance(inner, ast.InSubquery):
            negated = neg != inner.negated
            return self._plan_in_subquery(node, scope, inner.value, inner.query, negated,
                                          agg_map, group_map), True
        if isinstance(inner, ast.BinaryOp) and inner.op in ("=", "<>", "<", "<=", ">", ">=") and not neg:
            lhs, rhs = inner.left, inner.right
            if isinstance(rhs, ast.ScalarSubquery) or isinstance(lhs, ast.ScalarSubquery):
                if isinstance(lhs, ast.ScalarSubquery):
                    lhs, rhs = rhs, lhs
                    opmap = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}
                    inner = ast.BinaryOp(opmap.get(inner.op, inner.op), lhs, rhs)
                return self._plan_scalar_compare(node, scope, inner.op, lhs,
                                                 rhs.query, agg_map, group_map), True
        # EXISTS/IN under a boolean combination (q10/q35's
        # `EXISTS(...) OR EXISTS(...)`): plan each subquery as a MARK
        # join adding a boolean match column, then evaluate the
        # original expression over the marks (reference: SemiJoinNode's
        # semiJoinOutput consumed by a FilterNode)
        marked = self._try_mark_joins(node, scope, conj, agg_map, group_map)
        if marked is not None:
            return marked, True
        # general form: ONE correlated scalar subquery anywhere in the
        # conjunct (e.g. `price > 1.2 * (SELECT avg(...) WHERE corr)`) —
        # decorrelate to a joined column, substitute, analyze as usual
        subs: List[ast.ScalarSubquery] = []
        _collect_scalar_subqueries(conj, subs)
        if len(subs) == 1:
            sq = subs[0].query
            if isinstance(sq.body, ast.QuerySpec) and sq.body.from_ is not None \
                    and self._find_correlation(sq.body, scope):
                new_node, sref = self._decorrelate_scalar_to_column(
                    node, scope, sq.body)
                self._scalar_sub_overrides[id(subs[0])] = sref
                try:
                    rex = self.analyze(conj, scope, agg_map, group_map)
                finally:
                    self._scalar_sub_overrides.pop(id(subs[0]), None)
                return P.Filter(new_node, rex), True
        return node, False

    def _try_mark_joins(self, node, scope, conj, agg_map, group_map):
        """Plan a conjunct whose boolean expression CONTAINS subquery
        predicates (not as top-level conjuncts): each EXISTS/IN becomes
        a MARK join; the expression then filters on the mark columns.
        Returns the new plan node, or None if the shape doesn't apply."""
        subqs: List[ast.Expr] = []
        _collect_subquery_preds(conj, subqs)
        if not subqs:
            return None
        planned = []
        try:
            for sq in subqs:
                mark = self.symbols.new("mark")
                if isinstance(sq, ast.Exists):
                    spec = sq.query.body
                    if not isinstance(spec, ast.QuerySpec) or spec.group_by \
                            or spec.having:
                        return None
                    inner_node, inner_scope = self.plan_relation(spec.from_,
                                                                 None)
                    node = self._correlated_semi_join(
                        node, scope, inner_node, inner_scope, spec.where,
                        negated=False, mark=mark)
                else:  # InSubquery
                    val = self.analyze(sq.value, scope, agg_map=agg_map,
                                       group_map=group_map)
                    inner_node, inner_scope, _ = self.plan_query(sq.query,
                                                                 scope)
                    if len(inner_scope.fields) != 1:
                        return None
                    lsym = self._as_symbol(val, "inval")
                    if not isinstance(val, ir.Ref):
                        node = self._attach_key(node, val)
                    node = P.Join(node, inner_node, "MARK",
                                  [(lsym, inner_scope.fields[0].symbol)],
                                  mark=mark)
                # negation is applied where the expression references the
                # mark (analyze's Exists/InSubquery override)
                planned.append((id(sq), mark))
                self._mark_overrides[id(sq)] = mark
            rex = self.analyze(conj, scope, agg_map=agg_map,
                               group_map=group_map)
        except SemanticError:
            return None
        finally:
            for k, _m in planned:
                self._mark_overrides.pop(k, None)
        return P.Filter(node, rex)

    def _plan_exists(self, node, scope, sub: ast.Query, negated: bool):
        if not isinstance(sub.body, ast.QuerySpec) or sub.body.group_by or sub.body.having:
            raise SemanticError("EXISTS subquery too complex")
        spec = sub.body
        inner_node, inner_scope = self.plan_relation(spec.from_, None)
        return self._correlated_semi_join(
            node, scope, inner_node, inner_scope, spec.where, negated)

    def _correlated_semi_join(self, node, scope, inner_node, inner_scope,
                              where: Optional[ast.Expr], negated: bool,
                              extra_criteria: Optional[list] = None,
                              mark: Optional[str] = None):
        inner_syms = {f.symbol for f in inner_scope.fields}
        joint = Scope(inner_scope.fields, parent=scope)
        criteria: List[Tuple[str, str]] = list(extra_criteria or [])
        inner_only: List[ir.RowExpr] = []
        residual: List[ir.RowExpr] = []
        for c in _ast_conjuncts(where):
            rex = self.analyze(c, joint)
            refs = rex.refs()
            if refs <= inner_syms:
                inner_only.append(rex)
                continue
            if isinstance(rex, ir.Call) and rex.fn == "eq":
                a, b = rex.args
                if a.refs() <= inner_syms and isinstance(b, ir.Ref):
                    criteria.append((b.name, self._as_symbol(a, "ck")))
                    inner_node = self._attach_key(inner_node, a)
                    continue
                if b.refs() <= inner_syms and isinstance(a, ir.Ref):
                    criteria.append((a.name, self._as_symbol(b, "ck")))
                    inner_node = self._attach_key(inner_node, b)
                    continue
            residual.append(rex)
        if inner_only:
            inner_node = P.Filter(inner_node, ir.combine_conjuncts(inner_only))
        if not criteria and residual:
            raise SemanticError("unsupported correlated predicate (no equality)")
        if mark is not None:
            if residual:
                # the MARK executor path is filter-free; residual
                # correlation falls back to the caller's error path
                raise SemanticError("MARK join with residual predicate")
            return P.Join(node, inner_node, "MARK", criteria, mark=mark)
        jt = "ANTI" if negated else "SEMI"
        return P.Join(node, inner_node, jt, criteria, ir.combine_conjuncts(residual))

    def _plan_in_subquery(self, node, scope, value: ast.Expr, sub: ast.Query,
                          negated: bool, agg_map, group_map):
        val = self.analyze(value, scope, agg_map=agg_map, group_map=group_map)
        inner_node, inner_scope, _ = self.plan_query(sub, scope)
        if len(inner_scope.fields) != 1:
            raise SemanticError("IN subquery must return one column")
        inner_sym = inner_scope.fields[0].symbol
        lsym = self._as_symbol(val, "inval")
        if not isinstance(val, ir.Ref):
            node = self._attach_key(node, val)
        if negated:
            # null-aware NOT IN: with no match the predicate is NULL
            # (row filtered) when x is NULL or the build side contains
            # NULLs.  A plain ANTI join has EXISTS semantics and keeps
            # exactly those rows; the MARK join's 3-valued mark carries
            # the distinction (reference: SemiJoinNode semiJoinOutput
            # consumed by FilterNode(NOT mark))
            mark = self.symbols.new("mark")
            j = P.Join(node, inner_node, "MARK", [(lsym, inner_sym)],
                       mark=mark)
            return P.Filter(j, ir.Call("not", (ir.Ref(mark, T.BOOLEAN),),
                                       T.BOOLEAN))
        return P.Join(node, inner_node, "SEMI", [(lsym, inner_sym)])

    def _plan_scalar_compare(self, node, scope, op: str, lhs: ast.Expr,
                             sub: ast.Query, agg_map, group_map):
        """lhs OP (scalar subquery): correlated-agg decorrelation or
        uncorrelated subplan."""
        opn = {"=": "eq", "<>": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"}[op]
        lval = self.analyze(lhs, scope, agg_map=agg_map, group_map=group_map)
        # attempt correlated-aggregate decorrelation
        if isinstance(sub.body, ast.QuerySpec) and sub.body.from_ is not None:
            spec = sub.body
            correlated = self._find_correlation(spec, scope)
            if correlated:
                return self._decorrelate_scalar_agg(node, scope, opn, lval, spec)
        # uncorrelated: separate subplan
        sub_node, sub_scope, _ = self.plan_query(sub, None)
        if len(sub_scope.fields) != 1:
            raise SemanticError("scalar subquery must return one column")
        pid = next(self.subplan_ids)
        self.subplans[pid] = sub_node
        sref = ir.ScalarSub(pid, sub_scope.fields[0].type)
        a, b = self._coerce_pair(lval, sref)
        return P.Filter(node, ir.Call(opn, (a, b), T.BOOLEAN))

    def _find_correlation(self, spec: ast.QuerySpec, outer_scope: Scope) -> bool:
        """Cheap correlation test: try planning the FROM + analyzing WHERE
        with no outer scope; resolution error mentioning outer columns =>
        correlated."""
        saved_symbols = self.symbols
        saved_subplans = dict(self.subplans)
        try:
            inner_node, inner_scope = self.plan_relation(spec.from_, None)
            for c in _ast_conjuncts(spec.where):
                self.analyze(c, inner_scope)
            return False
        except SemanticError:
            return True
        finally:
            self.subplans.clear()
            self.subplans.update(saved_subplans)

    def _decorrelate_scalar_agg(self, node, scope, opn, lval, spec: ast.QuerySpec):
        join, sref = self._decorrelate_scalar_to_column(node, scope, spec)
        a, b = self._coerce_pair(lval, sref)
        return P.Filter(join, ir.Call(opn, (a, b), T.BOOLEAN))

    def _decorrelate_scalar_to_column(self, node, scope, spec: ast.QuerySpec):
        """`(SELECT f(aggs) FROM inner WHERE eqs AND rest)` correlated on
        eqs -> Aggregate(inner, group=correlation keys) JOIN outer ON eqs;
        returns (join node, Ref to the scalar column).
        (Reference: TransformCorrelatedScalarAggregationToJoin rule.)"""
        if len(spec.select) != 1 or spec.group_by or spec.having:
            raise SemanticError("unsupported correlated scalar subquery shape")
        inner_node, inner_scope = self.plan_relation(spec.from_, None)
        inner_syms = {f.symbol for f in inner_scope.fields}
        joint = Scope(inner_scope.fields, parent=scope)
        criteria: List[Tuple[str, str]] = []
        inner_only: List[ir.RowExpr] = []
        for c in _ast_conjuncts(spec.where):
            rex = self.analyze(c, joint)
            if rex.refs() <= inner_syms:
                inner_only.append(rex)
                continue
            if isinstance(rex, ir.Call) and rex.fn == "eq":
                a, b = rex.args
                if a.refs() <= inner_syms and isinstance(b, ir.Ref):
                    criteria.append((b.name, self._as_symbol(a, "ck")))
                    inner_node = self._attach_key(inner_node, a)
                    continue
                if b.refs() <= inner_syms and isinstance(a, ir.Ref):
                    criteria.append((a.name, self._as_symbol(b, "ck")))
                    inner_node = self._attach_key(inner_node, b)
                    continue
            raise SemanticError("unsupported correlated predicate in scalar subquery")
        if not criteria:
            raise SemanticError("correlated scalar subquery without equality correlation")
        if inner_only:
            inner_node = P.Filter(inner_node, ir.combine_conjuncts(inner_only))
        # aggregate over correlation keys
        agg_calls: List[Tuple[ast.FunctionCall, str]] = []
        self._collect_aggs(spec.select[0].expr, agg_calls)
        if not agg_calls:
            raise SemanticError("correlated scalar subquery must aggregate")
        group_keys = [rk for _, rk in criteria]
        pre_assigns = {s: ir.Ref(s, t) for s, t in inner_node.outputs()}
        aggs: Dict[str, ir.AggCall] = {}
        agg_map: Dict[int, Tuple[str, T.Type]] = {}
        for fc, _ in agg_calls:
            arg_exprs = tuple(self.analyze(a, inner_scope) for a in fc.args)
            arg_syms = []
            for ae in arg_exprs:
                if isinstance(ae, ir.Ref):
                    arg_syms.append(ae)
                else:
                    s2 = self.symbols.new("aggarg")
                    pre_assigns[s2] = ae
                    arg_syms.append(ir.Ref(s2, ae.type))
            rt = agg_fns.resolve(fc.name, [a.type for a in arg_syms], fc.distinct)
            s = self.symbols.new(fc.name)
            aggs[s] = ir.AggCall(fc.name.lower(), tuple(arg_syms), rt, fc.distinct)
            agg_map[id(fc)] = (s, rt)
        inner_node = P.Project(inner_node, pre_assigns)
        agg_node = P.Aggregate(inner_node, group_keys, aggs, "SINGLE")
        # the subquery's select expression over agg outputs
        agg_scope = Scope([Field_(None, None, s, t) for s, t in agg_node.outputs()])
        sel_expr = self.analyze(spec.select[0].expr, agg_scope, agg_map=agg_map,
                                group_map={})
        ssym = self.symbols.new("scalar")
        proj = {s: ir.Ref(s, t) for s, t in agg_node.outputs()}
        proj[ssym] = sel_expr
        sub_node = P.Project(agg_node, proj)
        # join outer to the grouped aggregate: LEFT, so outer rows with no
        # matching group survive with a NULL scalar (reference:
        # TransformCorrelatedScalarAggregationToJoin uses a left join —
        # matters under OR / coalesce / count(*)=0 shapes)
        jcriteria = [(lk, rk) for (lk, rk) in criteria]
        join = P.Join(node, sub_node, "LEFT", jcriteria)
        return join, ir.Ref(ssym, sel_expr.type)

    # ------------------------------------------------------------------
    # aggregation planning
    # ------------------------------------------------------------------
    def _collect_aggs(self, e: ast.Expr, out: List[Tuple[ast.FunctionCall, str]]):
        if isinstance(e, ast.FunctionCall) and agg_fns.is_aggregate(e.name) and e.window is None:
            out.append((e, ""))
            return  # no nested aggregates
        for child in e.children():
            if isinstance(child, (ast.Query, ast.QuerySpec)):
                continue  # subquery boundaries
            self._collect_aggs(child, out)

    def _collect_windows(self, e: ast.Expr, out: List[ast.FunctionCall]):
        if isinstance(e, ast.FunctionCall) and e.window is not None:
            out.append(e)
            return  # window functions cannot nest
        for child in e.children():
            if isinstance(child, (ast.Query, ast.QuerySpec)):
                continue
            self._collect_windows(child, out)

    def _plan_windows(self, node, scope, win_calls, agg_map, group_map):
        """Attach partition/order/arg columns below, then one P.Window per
        distinct spec; returns (node, {id(ast call) -> (symbol, type)})."""
        pre = {s: ir.Ref(s, t) for s, t in node.outputs()}

        def to_sym(e_ast):
            rex = self.analyze(e_ast, scope, agg_map=agg_map, group_map=group_map)
            if isinstance(rex, ir.Ref) and rex.name in pre:
                return rex.name, rex.type
            s = self.symbols.new("winkey")
            pre[s] = rex
            return s, rex.type

        planned = []
        for fc in win_calls:
            w = fc.window
            part = tuple(to_sym(p)[0] for p in w.partition_by)
            order = tuple((to_sym(si.expr)[0], si.ascending, si.nulls_first)
                          for si in w.order_by)
            args = []
            for a_ast in fc.args:
                rex = self.analyze(a_ast, scope, agg_map=agg_map, group_map=group_map)
                if isinstance(rex, ir.Lit):
                    args.append(rex)
                elif isinstance(rex, ir.Ref) and rex.name in pre:
                    args.append(rex)
                else:
                    s2 = self.symbols.new("winarg")
                    pre[s2] = rex
                    args.append(ir.Ref(s2, rex.type))
            planned.append((fc, part, order, w.frame, tuple(args)))

        node = P.Project(node, pre)
        win_map: Dict[int, Tuple[str, T.Type]] = {}
        groups: Dict[tuple, list] = {}
        for fc, part, order, frame, args in planned:
            groups.setdefault((part, order, frame), []).append((fc, args))
        for (part, order, frame), calls in groups.items():
            fns: Dict[str, ir.AggCall] = {}
            for fc, args in calls:
                if fc.distinct:
                    raise SemanticError(
                        f"DISTINCT not supported in window function {fc.name}")
                if fc.filter is not None:
                    raise SemanticError(
                        f"FILTER not supported in window function {fc.name}")
                try:
                    rt = agg_fns.resolve_window(fc.name, [a.type for a in args])
                except KeyError as e:
                    raise SemanticError(str(e.args[0])) from None
                ign = fc.null_treatment == "IGNORE"
                if ign and fc.name.lower() not in (
                        "lag", "lead", "first_value", "last_value",
                        "nth_value"):
                    raise SemanticError(
                        "IGNORE NULLS applies only to the window value "
                        "functions (lag/lead/first_value/last_value/"
                        "nth_value)")
                s = self.symbols.new(fc.name)
                fns[s] = ir.AggCall(fc.name.lower(), args, rt, fc.distinct,
                                    None, ignore_nulls=ign)
                win_map[id(fc)] = (s, rt)
            node = P.Window(node, list(part), list(order), fns, frame)
        return node, win_map

    def _plan_aggregation(self, node, scope, group_by, agg_calls, outer):
        pre_assigns = {s: ir.Ref(s, t) for s, t in node.outputs()}
        group_keys: List[str] = []
        group_map: Dict[str, str] = {}  # ast repr of group expr -> symbol
        group_fields: List[Field_] = []
        for ge in group_by:
            rex = self.analyze(ge, scope)
            if isinstance(rex, ir.Ref):
                sym = rex.name
            else:
                sym = self.symbols.new("groupkey")
                pre_assigns[sym] = rex
            group_keys.append(sym)
            group_map[_ast_key(ge)] = sym
            f = next((f for f in scope.fields if f.symbol == sym), None)
            group_fields.append(Field_(f.qualifier if f else None,
                                       f.name if f else None, sym, rex.type))
        aggs: Dict[str, ir.AggCall] = {}
        agg_map: Dict[int, Tuple[str, T.Type]] = {}
        def _agg_lambda(l, ptypes, name):
            """Type a lambda aggregate argument (reduce_agg) against the
            enclosing scope — same shape as the scalar-HOF `lam` helper."""
            if not isinstance(l, ast.Lambda):
                raise SemanticError(f"{name} expects a lambda argument")
            if len(l.params) != len(ptypes):
                raise SemanticError(
                    f"{name} lambda must take {len(ptypes)} argument(s)")
            syms = [self.symbols.new(f"lam_{p}") for p in l.params]
            inner = Scope([Field_(None, p, sy, t) for p, sy, t
                           in zip(l.params, syms, ptypes)], parent=scope)
            body = self.analyze(l.body, inner)
            return ir.LambdaExpr(tuple(syms), tuple(ptypes), body,
                                 T.function_type(body.type))

        for fc, _ in agg_calls:
            if fc.name.lower() == "reduce_agg":
                # reduce_agg(value, init, (s,v)->s, (s,s)->s) — the
                # lambdas ride the AggCall unevaluated (reference:
                # ReduceAggregationFunction)
                if len(fc.args) != 4:
                    raise SemanticError(
                        "reduce_agg(input, init, input_fn, combine_fn) "
                        "expected")
                arg_refs = []
                for a in fc.args[:2]:
                    ae = self.analyze(a, scope)
                    if isinstance(ae, ir.Ref):
                        arg_refs.append(ae)
                    else:
                        s2 = self.symbols.new("aggarg")
                        pre_assigns[s2] = ae
                        arg_refs.append(ir.Ref(s2, ae.type))
                st = arg_refs[1].type
                in_lam = _agg_lambda(fc.args[2], (st, arg_refs[0].type),
                                     "reduce_agg")
                if in_lam.body.type != st:
                    in_lam = ir.LambdaExpr(
                        in_lam.params, in_lam.param_types,
                        ir.CastExpr(in_lam.body, st), T.function_type(st))
                comb_lam = _agg_lambda(fc.args[3], (st, st), "reduce_agg")
                if comb_lam.body.type != st:
                    comb_lam = ir.LambdaExpr(
                        comb_lam.params, comb_lam.param_types,
                        ir.CastExpr(comb_lam.body, st),
                        T.function_type(st))
                s = self.symbols.new(fc.name)
                aggs[s] = ir.AggCall(
                    "reduce_agg",
                    (arg_refs[0], arg_refs[1], in_lam, comb_lam), st,
                    fc.distinct, None)
                agg_map[id(fc)] = (s, st)
                continue
            arg_refs = []
            for i, a in enumerate(fc.args):
                ae = self.analyze(a, scope)
                if isinstance(ae, ir.Ref) or (i > 0 and isinstance(ae, ir.Lit)):
                    # parameter-position literals (percentile fraction,
                    # approx_distinct max error, min_by n) stay literal:
                    # the distributed partial/final split needs their
                    # VALUES at plan time (sketch register/summary widths
                    # are static shapes), and a projected aggarg column
                    # would not survive to the FINAL aggregate's input
                    arg_refs.append(ae)
                else:
                    s2 = self.symbols.new("aggarg")
                    pre_assigns[s2] = ae
                    arg_refs.append(ir.Ref(s2, ae.type))
            filt = None
            if fc.filter is not None:
                fe = self.analyze(fc.filter, scope)
                filt = fe
            rt = agg_fns.resolve(fc.name, [a.type for a in arg_refs], fc.distinct)
            s = self.symbols.new(fc.name)
            aggs[s] = ir.AggCall(fc.name.lower(), tuple(arg_refs), rt, fc.distinct, filt)
            agg_map[id(fc)] = (s, rt)
        node = P.Project(node, pre_assigns)
        node = P.Aggregate(node, group_keys, aggs, "SINGLE")
        post_fields = group_fields + [Field_(None, None, s, a.type) for s, a in aggs.items()]
        post_scope = Scope(post_fields, parent=outer)
        return node, post_scope, agg_map, group_map

    # ------------------------------------------------------------------
    # expression analysis -> typed IR
    # ------------------------------------------------------------------
    def analyze(self, e: ast.Expr, scope: Scope, agg_map=None, group_map=None) -> ir.RowExpr:
        a = lambda x: self.analyze(x, scope, agg_map, group_map)
        if agg_map and isinstance(e, ast.FunctionCall) and id(e) in agg_map:
            sym, t = agg_map[id(e)]
            return ir.Ref(sym, t)
        if group_map and _ast_key(e) in (group_map or {}):
            sym = group_map[_ast_key(e)]
            # type from scope
            f = next((f for f in scope.fields if f.symbol == sym), None)
            if f is not None:
                return ir.Ref(sym, f.type)
        if isinstance(e, ast.Literal):
            return _literal_to_ir(e)
        if isinstance(e, ast.Parameter):
            # the serving tier (server/serving.py) binds `type_` from the
            # EXECUTE parameter values before planning; an unbound `?`
            # outside a prepared statement is a semantic error, like the
            # reference's "Incorrect number of parameters"
            if e.type_ is None:
                raise SemanticError(
                    "query parameter ? is only valid in a prepared "
                    "statement (PREPARE ... / EXECUTE ... USING)")
            return ir.Param(e.position, e.type_)
        if isinstance(e, ast.IntervalLiteral):
            # INTERVAL DAY TO SECOND carries MICROSECONDS (reference
            # stores millis, spi/type/IntervalDayTimeType; micros match
            # the TIMESTAMP lane)
            us = {"DAY": 86_400_000_000, "WEEK": 7 * 86_400_000_000,
                  "HOUR": 3_600_000_000, "MINUTE": 60_000_000,
                  "SECOND": 1_000_000}.get(e.unit)
            if us is not None:
                return ir.Lit(e.value * us, T.INTERVAL_DAY_TIME)
            if e.unit in ("MONTH", "YEAR"):
                return ir.Lit(e.value * (12 if e.unit == "YEAR" else 1), T.INTERVAL_YEAR_MONTH)
            raise SemanticError(f"unsupported interval unit {e.unit}")
        if isinstance(e, ast.Identifier):
            try:
                f, is_outer = scope.resolve(e.parts)
                return ir.Ref(f.symbol, f.type)
            except SemanticError:
                # r.field / t.r.field where r is a ROW-typed column
                # (reference: ExpressionAnalyzer DereferenceExpression
                # disambiguation between qualified names and row fields)
                if len(e.parts) >= 2:
                    try:
                        f, _ = scope.resolve(e.parts[:-1])
                    except SemanticError:
                        f = None
                    if f is not None and f.type.name == "ROW":
                        return self._row_field(ir.Ref(f.symbol, f.type),
                                               e.parts[-1])
                raise
        if isinstance(e, ast.BinaryOp):
            opn = {"+": "add", "-": "sub", "*": "mul", "/": "div", "%": "mod",
                   "=": "eq", "<>": "ne", "<": "lt", "<=": "le", ">": "gt",
                   ">=": "ge", "AND": "and", "OR": "or", "||": "concat"}[e.op]
            l, r = a(e.left), a(e.right)
            if opn in ("eq", "ne", "lt", "le", "gt", "ge", "add", "sub", "mul",
                       "div", "mod"):
                l, r = self._coerce_pair(l, r)
            return self._call(opn, [l, r])
        if isinstance(e, ast.UnaryOp):
            if e.op == "-":
                return self._call("neg", [a(e.operand)])
            return self._call("not", [a(e.operand)])
        if isinstance(e, ast.Between):
            v, lo, hi = a(e.value), a(e.low), a(e.high)
            v1, lo1 = self._coerce_pair(v, lo)
            v2, hi1 = self._coerce_pair(v, hi)
            rex = self._call("and", [self._call("ge", [v1, lo1]),
                                     self._call("le", [v2, hi1])])
            return self._call("not", [rex]) if e.negated else rex
        if isinstance(e, ast.InList):
            v = a(e.value)
            terms = []
            for item in e.items:
                it = a(item)
                x, y = self._coerce_pair(v, it)
                terms.append(self._call("eq", [x, y]))
            rex = terms[0]
            for t_ in terms[1:]:
                rex = self._call("or", [rex, t_])
            return self._call("not", [rex]) if e.negated else rex
        if isinstance(e, ast.Like):
            args = [a(e.value), a(e.pattern)] + ([a(e.escape)] if e.escape else [])
            rex = self._call("like", args)
            return self._call("not", [rex]) if e.negated else rex
        if isinstance(e, ast.IsNull):
            rex = self._call("is_null", [a(e.value)])
            return self._call("not", [rex]) if e.negated else rex
        if isinstance(e, ast.Case):
            args: List[ir.RowExpr] = []
            whens = e.whens
            if e.operand is not None:
                op_ir = a(e.operand)
                for c, v in whens:
                    cc = a(c)
                    x, y = self._coerce_pair(op_ir, cc)
                    args.append(self._call("eq", [x, y]))
                    args.append(a(v))
            else:
                for c, v in whens:
                    args.append(a(c))
                    args.append(a(v))
            if e.default is not None:
                args.append(a(e.default))
            # coerce all value arms to common type
            vals = [args[i] for i in range(1, len(args), 2)]
            if e.default is not None:
                vals.append(args[-1])
            ct = vals[0].type
            for v in vals[1:]:
                ct2 = T.common_super_type(ct, v.type)
                if ct2 is not None:
                    ct = ct2
            for i in range(1, len(args), 2):
                args[i] = self._coerce(args[i], ct)
            if e.default is not None:
                args[-1] = self._coerce(args[-1], ct)
            return self._call("case", args)
        if isinstance(e, ast.Cast):
            v = a(e.value)
            to = T.parse_type(e.type_name)
            return ir.CastExpr(v, to, e.safe)
        if isinstance(e, ast.Extract):
            return self._call(f"extract_{e.fld.lower()}", [a(e.value)])
        if isinstance(e, ast.FunctionCall):
            if agg_fns.is_aggregate(e.name) and e.window is None:
                raise SemanticError(f"aggregate {e.name} not allowed here")
            if e.null_treatment is not None and e.window is None:
                raise SemanticError(
                    "IGNORE/RESPECT NULLS requires an OVER clause")
            if any(isinstance(x, ast.Lambda) for x in e.args):
                return self._analyze_lambda_call(e, scope, agg_map, group_map)
            if e.name == "$dereference":
                base = a(e.args[0])
                if base.type.name != "ROW":
                    raise SemanticError(
                        f"cannot dereference a {base.type} value")
                return self._row_field(base, e.args[1].value)
            if e.name == "subscript" and e.args and \
                    isinstance(e.args[1], ast.Literal) and \
                    isinstance(e.args[1].value, int):
                base = a(e.args[0])
                if base.type.name == "ROW":  # r[i], 1-based
                    idx = int(e.args[1].value) - 1
                    if not (0 <= idx < len(base.type.params)):
                        raise SemanticError(f"ROW index {idx + 1} out of range")
                    ft = base.type.params[idx][1]
                    return ir.Call("row_field",
                                   (base, ir.Lit(idx, T.INTEGER)), ft)
                args = [base, a(e.args[1])]
                return self._call("subscript", args)
            args = [a(x) for x in e.args]
            return self._call(e.name.lower(), args)
        if isinstance(e, ast.Lambda):
            raise SemanticError("lambda is only valid as a function argument")
        if isinstance(e, ast.ScalarSubquery):
            override = self._scalar_sub_overrides.get(id(e))
            if override is not None:
                return override
            sub_node, sub_scope, _ = self.plan_query(e.query, None)
            if len(sub_scope.fields) != 1:
                raise SemanticError("scalar subquery must return one column")
            pid = next(self.subplan_ids)
            self.subplans[pid] = sub_node
            return ir.ScalarSub(pid, sub_scope.fields[0].type)
        if isinstance(e, (ast.Exists, ast.InSubquery)):
            mark = self._mark_overrides.get(id(e))
            if mark is not None:
                ref = ir.Ref(mark, T.BOOLEAN)
                if getattr(e, "negated", False):
                    return ir.Call("not", (ref,), T.BOOLEAN)
                return ref
            raise SemanticError(
                f"{type(e).__name__} only supported as a top-level WHERE/HAVING conjunct")
        raise SemanticError(f"unsupported expression {type(e).__name__}")

    def _analyze_lambda_call(self, e: ast.FunctionCall, scope, agg_map,
                             group_map) -> ir.RowExpr:
        """Higher-order functions (reference: analyzer lambda handling in
        ExpressionAnalyzer.visitLambdaExpression + function resolution of
        FunctionType arguments).  Lambda parameter types are driven by the
        array arguments, so each function shape is typed explicitly here."""
        name = e.name.lower()
        a = lambda x: self.analyze(x, scope, agg_map, group_map)

        def lam(l, ptypes):
            if not isinstance(l, ast.Lambda):
                raise SemanticError(f"{name} expects a lambda argument")
            if len(l.params) != len(ptypes):
                raise SemanticError(
                    f"{name} lambda must take {len(ptypes)} argument(s)")
            syms = [self.symbols.new(f"lam_{p}") for p in l.params]
            inner = Scope([Field_(None, p, s, t) for p, s, t
                           in zip(l.params, syms, ptypes)], parent=scope)
            body = self.analyze(l.body, inner, agg_map, group_map)
            return ir.LambdaExpr(tuple(syms), tuple(ptypes), body,
                                 T.function_type(body.type))

        def elem_of(v):
            if v.type.name != "ARRAY":
                raise SemanticError(
                    f"{name} expects an array argument, got {v.type}")
            return v.type.params[0]

        if name in ("transform", "filter", "any_match", "all_match",
                    "none_match"):
            if len(e.args) != 2:
                raise SemanticError(f"{name}(array, lambda) expected")
            arr = a(e.args[0])
            le = lam(e.args[1], (elem_of(arr),))
            if name != "transform" and le.body.type not in (T.BOOLEAN,
                                                            T.UNKNOWN):
                raise SemanticError(f"{name} lambda must return BOOLEAN")
            return self._call(name, [arr, le])
        if name in ("map_filter", "transform_values", "transform_keys"):
            if len(e.args) != 2:
                raise SemanticError(f"{name}(map, lambda) expected")
            m = a(e.args[0])
            if m.type.name != "MAP":
                raise SemanticError(f"{name} expects a MAP argument")
            kt, vt = m.type.params
            le = lam(e.args[1], (kt, vt))
            if name == "map_filter" and le.body.type not in (T.BOOLEAN,
                                                             T.UNKNOWN):
                raise SemanticError(f"{name} lambda must return BOOLEAN")
            return self._call(name, [m, le])
        if name in ("all_keys_match", "any_keys_match", "no_keys_match",
                    "any_values_match", "no_values_match"):
            if len(e.args) != 2:
                raise SemanticError(f"{name}(map, lambda) expected")
            m = a(e.args[0])
            if m.type.name != "MAP":
                raise SemanticError(f"{name} expects a MAP argument")
            kt, vt = m.type.params
            le = lam(e.args[1], (kt if "keys" in name else vt,))
            if le.body.type not in (T.BOOLEAN, T.UNKNOWN):
                raise SemanticError(f"{name} lambda must return BOOLEAN")
            return self._call(name, [m, le])
        if name == "array_sort" and len(e.args) == 2:
            arr = a(e.args[0])
            et = elem_of(arr)
            le = lam(e.args[1], (et, et))
            return self._call(name, [arr, le])
        if name == "regexp_replace" and len(e.args) == 3 \
                and isinstance(e.args[2], ast.Lambda):
            s_, p_ = a(e.args[0]), a(e.args[1])
            le = lam(e.args[2], (T.array_of(T.VARCHAR),))
            return self._call(name, [s_, p_, le])
        if name == "map_zip_with":
            if len(e.args) != 3:
                raise SemanticError(
                    "map_zip_with(map, map, lambda) expected")
            m1, m2 = a(e.args[0]), a(e.args[1])
            if m1.type.name != "MAP" or m2.type.name != "MAP":
                raise SemanticError("map_zip_with expects two MAP arguments")
            kt = T.common_super_type(m1.type.params[0], m2.type.params[0])
            if kt is None:
                raise SemanticError("map_zip_with key types are incompatible")
            le = lam(e.args[2], (kt, m1.type.params[1], m2.type.params[1]))
            return self._call(name, [m1, m2, le])
        if name == "zip_with":
            if len(e.args) != 3:
                raise SemanticError("zip_with(array, array, lambda) expected")
            arr1, arr2 = a(e.args[0]), a(e.args[1])
            le = lam(e.args[2], (elem_of(arr1), elem_of(arr2)))
            return self._call(name, [arr1, arr2, le])
        if name == "reduce":
            if len(e.args) not in (3, 4):
                raise SemanticError(
                    "reduce(array, init, merge_lambda[, output_lambda]) expected")
            arr, init = a(e.args[0]), a(e.args[1])
            merge = lam(e.args[2], (init.type, elem_of(arr)))
            if merge.body.type != init.type:
                # widen the state to cover the merge result (e.g. init 0 with
                # DOUBLE elements), re-typing the merge under the wider state
                ct = T.common_super_type(init.type, merge.body.type)
                if ct is not None and ct != init.type:
                    init = self._coerce(init, ct)
                    merge = lam(e.args[2], (ct, elem_of(arr)))
                if merge.body.type != init.type:
                    merge = ir.LambdaExpr(
                        merge.params, merge.param_types,
                        ir.CastExpr(merge.body, init.type),
                        T.function_type(init.type))
            if len(e.args) > 3:
                out = lam(e.args[3], (init.type,))
            else:
                s = self.symbols.new("lam_s")
                out = ir.LambdaExpr((s,), (init.type,),
                                    ir.Ref(s, init.type),
                                    T.function_type(init.type))
            return self._call("reduce", [arr, init, merge, out])
        raise SemanticError(f"function {name} does not take lambda arguments")

    def _row_field(self, base: ir.RowExpr, name: str) -> ir.RowExpr:
        idx = T.row_field_index(base.type, name)
        if idx is None:
            raise SemanticError(f"ROW has no field named '{name}'")
        ft = base.type.params[idx][1]
        return ir.Call("row_field", (base, ir.Lit(idx, T.INTEGER)), ft)

    def _call(self, name: str, args: List[ir.RowExpr]) -> ir.RowExpr:
        fn = scalar_fns.REGISTRY.get(name)
        if fn is None:
            # only the scalar functions of the ported slice are registered
            raise NotImplementedError(
                f"function {name} is not ported to presto_tpu_torch")
        rt = fn.resolve([x.type for x in args])
        if rt is None:
            raise SemanticError(
                f"no signature {name}({', '.join(str(x.type) for x in args)})")
        return ir.Call(name, tuple(args), rt)

    def _coerce(self, e: ir.RowExpr, to: T.Type) -> ir.RowExpr:
        if e.type == to:
            return e
        if isinstance(e, ir.Lit) and e.type == T.UNKNOWN:
            return ir.Lit(None, to)
        return ir.CastExpr(e, to)

    def _coerce_pair(self, l: ir.RowExpr, r: ir.RowExpr):
        if l.type == r.type:
            return l, r
        # TIMESTAMP_TZ vs plain temporal: lift the plain side onto the
        # instant lane via the session zone (reference coerces
        # TIMESTAMP -> TIMESTAMP WITH TIME ZONE the same way) — must
        # run BEFORE the keep-native branch below or the UTC lane would
        # compare raw against a wall-clock/days lane
        if {l.type.name, r.type.name} <= {"TIMESTAMP_TZ", "TIMESTAMP",
                                          "DATE"} \
                and "TIMESTAMP_TZ" in (l.type.name, r.type.name) \
                and l.type.name != r.type.name:
            tz = T.timestamp_tz()
            return (l if l.type.name == "TIMESTAMP_TZ"
                    else self._coerce(l, tz),
                    r if r.type.name == "TIMESTAMP_TZ"
                    else self._coerce(r, tz))
        if {l.type.name, r.type.name} == {"TIME", "TIME_TZ"}:
            tz = T.time_tz()
            return (l if l.type.name == "TIME_TZ" else self._coerce(l, tz),
                    r if r.type.name == "TIME_TZ" else self._coerce(r, tz))
        # temporal/interval arithmetic keeps native types
        if l.type.name in ("DATE", "TIMESTAMP", "INTERVAL_DAY_TIME", "INTERVAL_YEAR_MONTH") or \
           r.type.name in ("DATE", "TIMESTAMP", "INTERVAL_DAY_TIME", "INTERVAL_YEAR_MONTH"):
            return l, r
        ct = T.common_super_type(l.type, r.type)
        if ct is None:
            return l, r
        return self._coerce(l, ct), self._coerce(r, ct)


def _fold_constant_expr(rex: ir.RowExpr):
    """Evaluate a ref-free scalar expression at plan time to a typed
    literal (VALUES with ARRAY/MAP constructors; reference: VALUES rows
    are arbitrary constant expressions evaluated by the analyzer).
    Returns None when the expression isn't foldable."""
    if rex.refs():
        return None
    try:
        import torch

        from presto_tpu_torch.batch import Batch
        from presto_tpu_torch.exec.compiler import (EvalContext, eval_expr,
                                                    python_value)

        cv = eval_expr(rex, Batch({}, torch.ones((1,), dtype=torch.bool)),
                       EvalContext())
        v = python_value(cv)
        return ir.Lit(v, cv.type if cv.type is not None else rex.type)
    except Exception:
        return None


def _literal_to_ir(e: ast.Literal) -> ir.Lit:
    import numpy as np

    if e.value is None:
        return ir.Lit(None, T.UNKNOWN)
    if e.type_hint == "date":
        days = int((np.datetime64(e.value, "D") - np.datetime64("1970-01-01", "D"))
                   / np.timedelta64(1, "D"))
        return ir.Lit(days, T.DATE)
    if e.type_hint == "timestamp":
        text = str(e.value).strip()
        import re as _re

        m = _re.match(
            r"^(\d{4}-\d{2}-\d{2})"
            r"(?:[ T](\d{2}:\d{2}(?::\d{2}(?:\.\d{1,6})?)?))?"
            r"(?:\s+(\S.*))?$", text)
        if m is None:
            raise SemanticError(f"invalid TIMESTAMP literal {text!r}")
        civil = m.group(1) + ("T" + m.group(2) if m.group(2) else "")
        local_us = int((np.datetime64(civil)
                        - np.datetime64("1970-01-01T00:00:00"))
                       / np.timedelta64(1, "us"))
        zone = m.group(3)
        if zone is None:
            return ir.Lit(local_us, T.TIMESTAMP)
        # `TIMESTAMP '2020-01-01 00:00:00 America/New_York'` -> WITH
        # TIME ZONE, wall clock resolved via the zone's rules (DST
        # ambiguity picks the earlier offset, like java.time)
        from presto_tpu_torch.functions import tzdb

        try:
            r = tzdb.rules(zone)
        except ValueError:
            raise SemanticError(
                f"invalid TIMESTAMP literal {text!r}: unknown zone")
        return ir.Lit(r.local_to_utc_scalar(local_us), T.timestamp_tz(zone))
    if e.type_hint == "time":
        text = str(e.value).strip()
        import re as _re

        m = _re.match(
            r"^(\d{2}):(\d{2})(?::(\d{2})(?:\.(\d{1,6}))?)?"
            r"(?:\s*([+-]\d{2}:?\d{2}))?$", text)
        if m is None:
            raise SemanticError(f"invalid TIME literal {text!r}")
        frac = (m.group(4) or "").ljust(6, "0")
        us = ((int(m.group(1)) * 3600 + int(m.group(2)) * 60
               + int(m.group(3) or 0)) * 1_000_000 + int(frac or 0))
        if m.group(5) is None:
            return ir.Lit(us, T.TIME)
        off = m.group(5).replace(":", "")
        mins = int(off[1:3]) * 60 + int(off[3:5])
        if off[0] == "-":
            mins = -mins
        return ir.Lit(us, T.time_tz(mins))
    if e.type_hint == "decimal":
        # DECIMAL 'x.y' typed literal: precision/scale from the text
        # (reference DecimalParseResult / Decimals.parse)
        from decimal import Decimal, InvalidOperation

        import decimal as _dec

        try:
            d = Decimal(str(e.value).strip())
        except InvalidOperation:
            raise SemanticError(f"invalid DECIMAL literal {e.value!r}")
        if not d.is_finite():  # Decimal('NaN')/'Infinity' parse fine
            raise SemanticError(f"invalid DECIMAL literal {e.value!r}")
        exp = d.as_tuple().exponent
        scale = max(0, -exp)
        with _dec.localcontext() as ctx:
            ctx.prec = 80  # default 28 would round >28-digit literals
            unscaled = int(d.scaleb(scale))
        precision = max(len(str(abs(unscaled))), scale, 1)
        if precision > 38:
            raise SemanticError(
                f"DECIMAL literal {e.value!r} exceeds precision 38")
        return ir.Lit(unscaled, T.decimal(precision, scale))
    if isinstance(e.value, bool):
        return ir.Lit(e.value, T.BOOLEAN)
    if isinstance(e.value, int):
        return ir.Lit(e.value, T.BIGINT if abs(e.value) > 2**31 - 1 else T.INTEGER)
    if isinstance(e.value, float):
        return ir.Lit(e.value, T.DOUBLE)
    if isinstance(e.value, str):
        return ir.Lit(e.value, T.VARCHAR)
    raise SemanticError(f"bad literal {e.value!r}")


def _collect_scalar_subqueries(e: ast.Expr, out: list) -> None:
    if isinstance(e, ast.ScalarSubquery):
        out.append(e)
        return
    for child in e.children():
        if isinstance(child, (ast.Query, ast.QuerySpec)):
            continue
        _collect_scalar_subqueries(child, out)


def _collect_subquery_preds(e: ast.Expr, out: list) -> None:
    """EXISTS/IN-subquery predicate nodes inside a boolean expression
    (without descending into the subqueries themselves)."""
    if isinstance(e, (ast.Exists, ast.InSubquery)):
        out.append(e)
        return
    if isinstance(e, ast.ScalarSubquery):
        return
    for child in e.children():
        if isinstance(child, (ast.Query, ast.QuerySpec)):
            continue
        _collect_subquery_preds(child, out)


def _ast_conjuncts(e: Optional[ast.Expr]) -> List[ast.Expr]:
    if e is None:
        return []
    if isinstance(e, ast.BinaryOp) and e.op == "AND":
        return _ast_conjuncts(e.left) + _ast_conjuncts(e.right)
    return [e]


def _ast_key(e: ast.Expr) -> str:
    """Structural key for GROUP BY expression matching in SELECT/HAVING."""
    return repr(e)
