"""Logical plan optimizer.

Reference parity: sql/planner/PlanOptimizers.java (~40 passes, 87 iterative
rules).  Round-1 set, the ones correctness/feasibility actually require:

- predicate pushdown + cross-join elimination (reference: PredicatePushDown
  + EliminateCrossJoins): implicit-join queries arrive as CROSS-join trees
  under a Filter; we collect the join graph and greedily re-assemble
  equi-joins from equality conjuncts (a cross join of TPC-H lineitem x
  orders would otherwise materialize ~10^13 rows).
- column pruning (reference: PruneUnreferencedOutputs): scans read only
  referenced columns.
- projection inlining of trivial Ref-only projects.
"""

from __future__ import annotations

from typing import List, Set

from presto_tpu_torch import types as T
from presto_tpu_torch.plan import ir
from presto_tpu_torch.plan import nodes as P


def optimize(plan: P.QueryPlan, session) -> P.QueryPlan:
    root = plan.root
    if session.properties.get("prefer_approx_distinct", False):
        # opt-in approximation: count(DISTINCT x) -> approx_distinct(x)
        # (~3.25% std error at 1024 registers) trades exactness for the
        # sketch lane — no hash repartition, fixed-width mergeable
        # state.  Must run BEFORE _optimize_node lowers DISTINCT
        # aggregates into a pre-group.  Counted into
        # QueryStats.approx_rewrites through the compile-accounting
        # sink (planning runs inside CC.recording).
        # (the reference also counts the rewrites into QueryStats through
        # its compile-cache sink, which this package does not have)
        _approx_distinct_rewrites(root)
        for sub in plan.subplans.values():
            _approx_distinct_rewrites(sub)
    subplans = {k: _optimize_node(v, session) for k, v in plan.subplans.items()}
    new_root = _optimize_node(root, session)
    out = P.QueryPlan(new_root, subplans)
    annotate_static_hints(out, session)
    if session.properties.get("prune_fd_group_keys", False):
        # OFF by default: measured on chip (SF1 Q3 517->607ms, Q18
        # 647->687ms), each arbitrary() representative costs a
        # full-capacity reduction pass that outweighs the narrower
        # grouping sort in this executor.  The rewrite itself is
        # correct and tested; revisit if representatives ever ride the
        # grouping sort directly.
        # Needs build_unique from the annotation pass; re-annotate after
        # the rewrite so aggregate capacity hints match the new keys
        changed = _prune_fd_group_keys(out.root, set())
        for sub in out.subplans.values():
            changed |= _prune_fd_group_keys(sub, set())
        if changed:
            annotate_static_hints(out, session)
    if session.properties.get("ordering_aware_execution", True):
        # ordering-properties hints (plan/properties.py): advisory,
        # guard-verified at every exploitation site.  Runs LAST so the
        # hints see the final key lists (fd-pruning may drop keys).
        from presto_tpu_torch.plan import properties as OP

        OP.annotate(out, session)
    # dynamic filtering (plan/runtime_filters.py): wire build-side
    # runtime-filter producers to probe-side scan consumers.  After the
    # structural passes so the join tree and scan assignments are final;
    # the annotations are advisory and survive fragment serde.
    from presto_tpu_torch.plan import runtime_filters as RF

    RF.annotate(out, session)
    # aggregation strategy (plan/agg_strategy.py): one_pass / final_only
    # / two_phase per grouped Aggregate, from the ordering facts and NDV
    # estimates the passes above just attached.  distribute() and the
    # executor consume it; the string annotation rides fragment serde.
    from presto_tpu_torch.plan import agg_strategy as AS

    AS.annotate(out, session)
    return out


def _approx_distinct_rewrites(node: P.PlanNode) -> int:
    """Replace count(DISTINCT x) aggregates with approx_distinct(x),
    returning how many calls were rewritten.  Only hashable scalar
    types rewrite (hll_hash64's domain); everything else keeps the
    exact dedup path."""
    n = 0
    if isinstance(node, P.Aggregate):
        for s, a in list(node.aggs.items()):
            if a.fn == "count" and a.distinct and len(a.args) == 1:
                t = a.args[0].type
                if t.is_numeric or t.is_string or t.name in (
                        "DATE", "TIMESTAMP", "BOOLEAN"):
                    node.aggs[s] = ir.AggCall(
                        "approx_distinct", a.args, T.BIGINT, False,
                        a.filter)
                    n += 1
    for src in node.sources:
        n += _approx_distinct_rewrites(src)
    return n


def _prune_fd_group_keys(node: P.PlanNode, seen: set) -> bool:
    """Group keys functionally determined through a unique-build join
    collapse to arbitrary() aggregates: grouping by (l_orderkey,
    o_orderdate, o_shippriority) over lineitem JOIN orders-unique-on-
    orderkey sorts ONE key instead of three and gathers representatives
    at the group bound (reference: the unique-constraint-driven
    grouping-key pruning in newer optimizers; correctness is the FD
    through AggregationNode semantics — within a group of the join key
    the unique build row, and so every build column, is constant;
    LEFT-join groups are uniformly matched or uniformly null-extended).
    Mutates Aggregates in place; returns whether anything changed."""
    if id(node) in seen:
        return False
    seen.add(id(node))
    changed = False
    for s in node.sources:
        changed |= _prune_fd_group_keys(s, seen)
    if not isinstance(node, P.Aggregate) or node.step != "SINGLE" \
            or len(node.group_keys) < 2:
        return changed
    # walk identity projections down to the join, tracking renames
    maps = []
    cur = node.source
    while isinstance(cur, P.Project):
        maps.append({s: (e.name if isinstance(e, ir.Ref) else None)
                     for s, e in cur.assignments.items()})
        cur = cur.source
    if not isinstance(cur, P.Join) \
            or cur.join_type not in ("INNER", "LEFT") \
            or len(cur.criteria) != 1 or cur.filter is not None \
            or not getattr(cur, "build_unique", False):
        return changed
    lk, rk = cur.criteria[0]
    build_syms = {s for s, _ in cur.right.outputs()}

    def base(sym):
        s = sym
        for m in maps:
            s = m.get(s)
            if s is None:
                return None
        return s

    keys_base = {k: base(k) for k in node.group_keys}
    anchors = [k for k, b in keys_base.items()
               if b == lk or (cur.join_type == "INNER" and b == rk)]
    if not anchors:
        return changed
    anchor = anchors[0]
    fd = [k for k in node.group_keys
          if k != anchor and keys_base.get(k) in build_syms]
    if not fd:
        return changed
    types = dict(node.source.outputs())
    node.group_keys = [k for k in node.group_keys if k not in fd]
    for k in fd:
        node.aggs[k] = ir.AggCall("arbitrary", (ir.Ref(k, types[k]),),
                                  types[k])
    return True


def annotate_static_hints(plan: P.QueryPlan, session) -> None:
    """Attach stats-derived static-shape hints used by the compiled
    executor: group capacities, key ranges, join build-uniqueness and
    fanout bounds (plan/stats.py docstring explains why)."""
    from presto_tpu_torch.plan import stats as S

    catalog = getattr(session, "catalog", None)
    if catalog is None:
        return
    memo = {}

    def annotate(node):
        for s in node.sources:
            annotate(s)
        try:
            if isinstance(node, P.Aggregate):
                src = S.derive(node.source, catalog, memo)
                node.capacity_hint = S.capacity_for_groups(node, src)
                node.key_stats = {k: src.cols.get(k) for k in node.group_keys}
                # selectivity ESTIMATE of the input (not the sound upper
                # bound): drives the guarded pre-aggregation compaction
                # in the static executor
                node.input_est_hint = int(src.est_rows)
            elif isinstance(node, P.Join) and node.join_type not in ("CROSS",):
                ls = S.derive(node.left, catalog, memo)
                rs = S.derive(node.right, catalog, memo)
                # estimate hints for guarded join-input compaction
                node.left_est_hint = int(ls.est_rows)
                node.right_est_hint = int(rs.est_rows)
                rkeys = frozenset(rk for _, rk in node.criteria)
                node.build_unique = any(u <= rkeys for u in rs.unique)
                best = S._best_fanout_key(rs, rkeys)
                node.fanout_bound = rs.fanout.get(best) if best else None
                if node.fanout_bound is None:
                    node.fanout_bound = \
                        S.speculative_fanout_bound(rs, node.criteria)
                node.key_stats = {}
                for lk, rk in node.criteria:
                    node.key_stats[lk] = ls.cols.get(lk)
                    node.key_stats[rk] = rs.cols.get(rk)
                node.index_lookup = _index_lookup_info(node, catalog)
        except Exception:
            pass  # hints are optional; executor falls back to dynamic mode

    annotate(plan.root)
    for sub in plan.subplans.values():
        annotate(sub)


def _index_lookup_info(node: P.Join, catalog):
    """P10 index joins, TPU-native: when the build (right) side is a
    resident table whose single join key is a DENSE unique integer key
    (surrogate keys: tpch nation/part/customer, tpcds date_dim/item...),
    the probe lowers to ONE gather — position = key - key_min — instead
    of the three sorts of build_probe.  Reference:
    sql/planner/optimizations/IndexJoinOptimizer.java planning
    IndexJoinNode probes against a connector index (operator/index/
    IndexLoader); here the "index" is the identity layout of a dense
    surrogate key, the natural connector index on TPU.

    Returns {"min", "rows"} or None.  Sound preconditions: the build
    subtree is Filter/Project-over-TableScan ONLY (row positions reach
    the join unchanged — filters mask sel, never compact), the key is an
    identity Ref of the scan's dense unique column, and the executor
    additionally verifies gathered key == probe key in-trace, so stale
    stats degrade to no-match on rows a sort join would also not match.
    """
    if len(node.criteria) != 1:
        return None
    if node.join_type not in ("INNER", "LEFT", "SEMI", "ANTI", "MARK"):
        return None
    if node.filter is not None and node.join_type not in ("INNER", "LEFT"):
        return None  # filtered SEMI/ANTI take the expanding path
    sym = node.criteria[0][1]
    cur = node.right
    while True:
        if isinstance(cur, P.Filter):
            cur = cur.source
        elif isinstance(cur, P.Project):
            e = cur.assignments.get(sym)
            if not isinstance(e, ir.Ref):
                return None
            sym = e.name
            cur = cur.source
        elif isinstance(cur, P.Join) and sym in {
                s for s, _ in cur.left.outputs()} and (
                cur.join_type in ("SEMI", "ANTI", "MARK")
                or (cur.join_type in ("INNER", "LEFT")
                    and getattr(cur, "index_lookup", None) is not None)):
            # probe-layout-preserving joins (this executor masks the
            # probe in place for SEMI/ANTI/MARK and for index joins):
            # the key column still sits at its natural scan positions.
            # Runtime layout verification in the executor guards the
            # cases where the inner join takes a re-ordering fallback.
            cur = cur.left
        else:
            break
    if not isinstance(cur, P.TableScan):
        return None
    col = cur.assignments.get(sym)
    if col is None:
        return None
    try:
        t = catalog.get(cur.table)
    except KeyError:
        return None
    if not hasattr(t, "unique_keys") or (col,) not in \
            [tuple(k) for k in t.unique_keys()]:
        return None
    typ = cur.types.get(sym)
    if typ is None or not typ.is_integer:
        return None
    cs = t.column_stats(col) if hasattr(t, "column_stats") else None
    rows = t.row_count()
    if rows == 0:
        return None
    if cs is not None and cs.min is not None and cs.max is not None \
            and cs.ndv == rows and int(cs.max) - int(cs.min) + 1 == rows:
        # dense surrogate key: identity layout
        return {"min": int(cs.min), "rows": int(rows),
                "block_keys": 1, "block_rows": 1}
    # sparse-but-invertible generator layouts (dbgen orderkey: 8 keys
    # per 32-key block) — the connector declares the closed form
    layout = t.key_layout(col) if hasattr(t, "key_layout") else None
    if layout is not None:
        base, bk, br = layout
        return {"min": int(base), "rows": int(rows),
                "block_keys": int(bk), "block_rows": int(br)}
    return None


def _optimize_node(node: P.PlanNode, session) -> P.PlanNode:
    node = _rewrite(node, session)
    node = prune_columns(node, set(n for n, _ in node.outputs()))
    if session.properties.get("iterative_optimizer_enabled", True):
        from presto_tpu_torch.plan.iterative import (DEFAULT_RULES,
                                               IterativeOptimizer,
                                               ReorderJoins)

        rules = list(DEFAULT_RULES)
        if session.properties.get("reorder_joins", True):
            # cost-based join enumeration inside the memo (reference:
            # rule/ReorderJoins.java replacing the greedy order)
            rules.append(ReorderJoins(session))
        node = IterativeOptimizer(rules).optimize(node)
    node = _pushdown_connector_predicates(node, session)
    node = _extract_spatial_joins(node)
    # re-prune: a pushed-down predicate leaves its original string column
    # unreferenced in the scan — dropping it is the whole point (the
    # column never materializes)
    node = prune_columns(node, set(n for n, _ in node.outputs()))
    # AFTER pruning: the inferred semi join shares its subquery subtree
    # with the original (a DAG prune_columns would split back into two).
    # Chunked execution plans with this OFF: per-chunk capacities dwarf
    # whole-table estimates, so the extra probe-side semi never enables
    # compaction there and is pure added work per chunk program.
    if session.properties.get("transitive_semijoin_inference", True):
        node = infer_transitive_semijoins(node)
    return node


def _pushdown_connector_predicates(node: P.PlanNode, session) -> P.PlanNode:
    """Rewrite connector-evaluable predicates into virtual scan columns
    (reference: predicate pushdown into the connector via TupleDomain /
    PickTableLayout + ConnectorMetadata).  A conjunct like
    `p_name LIKE '%green%'` over a generator connector becomes a BOOLEAN
    column the connector computes natively on device — the string column
    itself never materializes."""
    catalog = getattr(session, "catalog", None)
    if catalog is None:
        return node
    for attr in ("source", "left", "right"):
        if hasattr(node, attr):
            setattr(node, attr, _pushdown_connector_predicates(
                getattr(node, attr), session))
    if isinstance(node, P.Union):
        node.sources_ = [_pushdown_connector_predicates(s, session)
                         for s in node.sources_]
    if not (isinstance(node, P.Filter)
            and isinstance(node.source, P.TableScan)):
        return node
    scan = node.source
    try:
        table = catalog.get(scan.table)
    except KeyError:
        return node
    if getattr(table, "supports_domain_pushdown", False):
        # TupleDomain-style stats pruning: attach per-column domains to
        # the scan for the reader to prune stripes/row groups (advisory
        # — the Filter stays; reference: PickTableLayout pushing the
        # TupleDomain into the connector's table layout)
        from presto_tpu_torch.plan.domains import (
            domains_from_conjuncts,
            domains_pickle_safe,
        )

        doms = domains_from_conjuncts(
            ir.conjuncts(node.predicate), scan.assignments)
        if doms:
            scan.scan_domains = domains_pickle_safe(doms)
    hook = getattr(table, "pushdown_like", None)
    if hook is None:
        return node
    conjs = list(ir.conjuncts(node.predicate))
    changed = False
    for i, c in enumerate(conjs):
        if not (isinstance(c, ir.Call) and c.fn == "like"
                and len(c.args) == 2 and isinstance(c.args[0], ir.Ref)
                and isinstance(c.args[1], ir.Lit)):
            continue
        col = scan.assignments.get(c.args[0].name)
        if col is None:
            continue
        vcol = hook(col, str(c.args[1].value))
        if vcol is None:
            continue
        vsym = f"{c.args[0].name}$pushed{i}"
        scan.assignments[vsym] = vcol
        scan.types[vsym] = T.BOOLEAN
        conjs[i] = ir.Ref(vsym, T.BOOLEAN)
        changed = True
    if changed:
        return P.Filter(scan, ir.combine_conjuncts(conjs))
    return node


def _rewrite(node: P.PlanNode, session) -> P.PlanNode:
    # bottom-up
    if isinstance(node, P.Filter):
        src = _rewrite(node.source, session)
        return push_filter(src, ir.conjuncts(node.predicate), session)
    for attr in ("source", "left", "right"):
        if hasattr(node, attr):
            setattr(node, attr, _rewrite(getattr(node, attr), session))
    if isinstance(node, P.Union):
        node.sources_ = [_rewrite(s, session) for s in node.sources_]
    if isinstance(node, P.Join) and node.join_type == "CROSS":
        # cross join with no predicates above — leave as-is
        pass
    return node


def _extract_common_or_conjuncts(conjs: List[ir.RowExpr]) -> List[ir.RowExpr]:
    """`(A and X) or (A and Y)` -> `A and (X or Y)` per conjunct (reference:
    ExtractCommonPredicatesExpressionRewriter).  This is what surfaces the
    join equality in TPC-H Q19's three-armed OR predicate."""
    out: List[ir.RowExpr] = []
    for c in conjs:
        if not (isinstance(c, ir.Call) and c.fn == "or"):
            out.append(c)
            continue
        branches: List[List[ir.RowExpr]] = []

        def collect_or(e):
            if isinstance(e, ir.Call) and e.fn == "or":
                collect_or(e.args[0])
                collect_or(e.args[1])
            else:
                branches.append(ir.conjuncts(e))

        collect_or(c)
        common = [x for x in branches[0]
                  if all(any(x == y for y in b) for b in branches[1:])]
        if not common:
            out.append(c)
            continue
        out.extend(common)
        rest_branches = []
        for b in branches:
            rest = [x for x in b if not any(x == y for y in common)]
            rest_branches.append(ir.combine_conjuncts(rest))
        if any(r is None for r in rest_branches):
            continue  # one branch was exactly the common set -> OR is true given common
        from presto_tpu_torch.types import BOOLEAN

        disj = rest_branches[0]
        for r in rest_branches[1:]:
            disj = ir.Call("or", (disj, r), BOOLEAN)
        out.append(disj)
    return out


def push_filter(node: P.PlanNode, conjs: List[ir.RowExpr], session) -> P.PlanNode:
    """Push filter conjuncts down; turn cross joins + equalities into
    equi-joins (join-graph reassembly)."""
    conjs = _extract_common_or_conjuncts(conjs)
    if not conjs:
        return node
    if isinstance(node, P.Filter):
        return push_filter(node.source, conjs + ir.conjuncts(node.predicate), session)
    if isinstance(node, P.Project):
        if all(isinstance(e, ir.Ref) for e in node.assignments.values()):
            mapping = {s: e for s, e in node.assignments.items()}
            rewritten = [ir.substitute(c, mapping) for c in conjs]
            return P.Project(push_filter(node.source, rewritten, session),
                             node.assignments)
        pushable, kept = [], []
        mapping = {s: e for s, e in node.assignments.items() if isinstance(e, ir.Ref)}
        for c in conjs:
            if c.refs() <= set(mapping):
                pushable.append(ir.substitute(c, mapping))
            else:
                kept.append(c)
        src = push_filter(node.source, pushable, session) if pushable else node.source
        out: P.PlanNode = P.Project(src, node.assignments)
        if kept:
            out = P.Filter(out, ir.combine_conjuncts(kept))
        return out
    if isinstance(node, P.Join) and node.join_type in ("CROSS", "INNER"):
        return _reassemble_join(node, conjs, session)
    if isinstance(node, P.Join) and node.join_type in ("SEMI", "ANTI",
                                                       "LEFT", "MARK"):
        # left rows pass through 1:1 (MARK adds only its bool column),
        # so left-only conjuncts commute with the join
        lsyms = {s for s, _ in node.left.outputs()}
        pushable = [c for c in conjs if c.refs() <= lsyms]
        kept = [c for c in conjs if not (c.refs() <= lsyms)]
        if pushable:
            node.left = push_filter(node.left, pushable, session)
        if kept:
            return P.Filter(node, ir.combine_conjuncts(kept))
        return node
    if isinstance(node, P.Aggregate):
        # push conjuncts that only reference group keys below the agg
        keys = set(node.group_keys)
        pushable = [c for c in conjs if c.refs() <= keys]
        kept = [c for c in conjs if not (c.refs() <= keys)]
        if pushable:
            node.source = push_filter(node.source, pushable, session)
        if kept:
            return P.Filter(node, ir.combine_conjuncts(kept))
        return node
    return P.Filter(node, ir.combine_conjuncts(conjs))


def _flatten_inner_join_tree(node: P.PlanNode, sources: List[P.PlanNode],
                             conjs: List[ir.RowExpr]):
    if isinstance(node, P.Join) and node.join_type in ("CROSS", "INNER") and not node.filter:
        for lk, rk in node.criteria:
            lt = dict(node.left.outputs()).get(lk) or dict(node.right.outputs()).get(lk)
            conjs.append(ir.Call("eq", (ir.Ref(lk, lt), ir.Ref(rk, lt)), None))
        _flatten_inner_join_tree(node.left, sources, conjs)
        _flatten_inner_join_tree(node.right, sources, conjs)
    else:
        sources.append(node)


def _reassemble_join(root: P.Join, conjs: List[ir.RowExpr], session) -> P.PlanNode:
    """Collect the flat source set + all conjuncts, then greedily build a
    left-deep equi-join tree, joining a connected relation each step
    (reference: EliminateCrossJoins; CBO join reordering comes later)."""
    sources: List[P.PlanNode] = []
    all_conjs: List[ir.RowExpr] = list(conjs)
    _flatten_inner_join_tree(root, sources, all_conjs)
    # fix up eq conjuncts created from criteria (type filled from outputs)
    fixed: List[ir.RowExpr] = []
    for c in all_conjs:
        if isinstance(c, ir.Call) and c.type is None:
            from presto_tpu_torch.types import BOOLEAN

            fixed.append(ir.Call(c.fn, c.args, BOOLEAN))
        else:
            fixed.append(c)
    all_conjs = fixed

    src_syms: List[Set[str]] = [{s for s, _ in n.outputs()} for n in sources]

    # push single-source conjuncts into their source
    remaining: List[ir.RowExpr] = []
    for c in all_conjs:
        refs = c.refs()
        placed = False
        for i, syms in enumerate(src_syms):
            if refs <= syms:
                sources[i] = P.Filter(sources[i], c)
                placed = True
                break
        if not placed:
            remaining.append(c)

    # cost-based greedy join order (reference: ReorderJoins — ours is the
    # greedy variant over the selectivity-aware estimates in plan/stats.py):
    # start from the largest-estimate source (the fact table becomes the
    # probe side so hash builds stay small), then repeatedly join the
    # connected source minimizing the estimated output cardinality,
    # tie-breaking toward unique-key builds (FK joins lower to pure
    # gathers on TPU) and then smaller build sides.
    from presto_tpu_torch.plan import stats as S

    catalog = getattr(session, "catalog", None)

    def src_stats(i):
        try:
            return S.derive(sources[i], catalog)
        except Exception:
            return None

    stats_list = [src_stats(i) for i in range(len(sources))]
    rows = [s.rows if s else 1 << 30 for s in stats_list]
    ests = [s.est_rows if s else float(1 << 30) for s in stats_list]
    start = max(range(len(sources)), key=lambda i: ests[i])

    current = sources[start]
    cur_stats = stats_list[start]
    cur_syms = set(src_syms[start])
    todo = [i for i in range(len(sources)) if i != start]
    while todo:
        candidates = []
        for i in todo:
            crits = []
            for c in remaining:
                pair = _equi_pair(c, cur_syms, src_syms[i])
                if pair is not None:
                    crits.append((c, pair))
            if crits:
                rkeys = frozenset(pair[1] for _, pair in crits)
                st = stats_list[i]
                unique_build = bool(st and any(u <= rkeys for u in st.unique))
                if cur_stats is not None and st is not None:
                    out_est = S.join_cardinality(
                        cur_stats, st, [pair for _, pair in crits])
                else:
                    out_est = float(1 << 30)
                candidates.append((out_est, not unique_build, rows[i], i, crits))
        if not candidates:
            i = todo[0]
            current = P.Join(current, sources[i], "CROSS")
            cur_syms |= src_syms[i]
            cur_stats = None
            todo.remove(i)
            continue
        candidates.sort(key=lambda t: (t[0], t[1], t[2]))
        _, _, _, i, crits = candidates[0]
        criteria = [pair for _, pair in crits]
        used = {id(c) for c, _ in crits}
        remaining = [c for c in remaining if id(c) not in used]
        current = P.Join(current, sources[i], "INNER", criteria)
        cur_syms |= src_syms[i]
        todo.remove(i)
        # attach any now-evaluable residual conjuncts as filters right away
        now, remaining = _split(remaining, cur_syms)
        if now:
            current = P.Filter(current, ir.combine_conjuncts(now))
        try:
            cur_stats = S.derive(current, catalog)
        except Exception:
            cur_stats = None
    if remaining:
        current = P.Filter(current, ir.combine_conjuncts(remaining))
    return current


def _split(conjs, syms):
    now = [c for c in conjs if c.refs() <= syms]
    later = [c for c in conjs if not (c.refs() <= syms)]
    return now, later


def _equi_pair(c: ir.RowExpr, lsyms: Set[str], rsyms: Set[str]):
    if not (isinstance(c, ir.Call) and c.fn == "eq"):
        return None
    a, b = c.args
    if not (isinstance(a, ir.Ref) and isinstance(b, ir.Ref)):
        return None
    if a.name in lsyms and b.name in rsyms:
        return (a.name, b.name)
    if b.name in lsyms and a.name in rsyms:
        return (b.name, a.name)
    return None


# ---------------------------------------------------------------------------
# column pruning
# ---------------------------------------------------------------------------


def prune_columns(node: P.PlanNode, required: Set[str]) -> P.PlanNode:
    if isinstance(node, P.TableScan):
        keep = {s: c for s, c in node.assignments.items() if s in required}
        if not keep:  # keep at least one column for row counting
            first = next(iter(node.assignments))
            keep = {first: node.assignments[first]}
        out = P.TableScan(node.table, keep,
                          {s: node.types[s] for s in keep})
        for extra in ("scan_domains", "index_lookup", "build_unique"):
            if hasattr(node, extra):  # dynamic pushdown annotations
                setattr(out, extra, getattr(node, extra))
        return out
    if isinstance(node, P.Values):
        return node
    if isinstance(node, P.Filter):
        need = required | node.predicate.refs()
        return P.Filter(prune_columns(node.source, need), node.predicate)
    if isinstance(node, P.Project):
        keep = {s: e for s, e in node.assignments.items() if s in required}
        if not keep and node.assignments:
            s0 = next(iter(node.assignments))
            keep = {s0: node.assignments[s0]}
        need = set()
        for e in keep.values():
            need |= e.refs()
        return P.Project(prune_columns(node.source, need), keep)
    if isinstance(node, P.Aggregate):
        keep_aggs = {s: a for s, a in node.aggs.items() if s in required}
        need = set(node.group_keys)
        for a in keep_aggs.values():
            for arg in a.args:
                need |= arg.refs()
            if a.filter is not None:
                need |= a.filter.refs()
        return P.Aggregate(prune_columns(node.source, need), node.group_keys,
                           keep_aggs, node.step)
    if isinstance(node, P.Join):
        need_l = set()
        need_r = set()
        lsyms = {s for s, _ in node.left.outputs()}
        rsyms = {s for s, _ in node.right.outputs()}
        for lk, rk in node.criteria:
            need_l.add(lk)
            need_r.add(rk)
        if node.filter is not None:
            for r in node.filter.refs():
                (need_l if r in lsyms else need_r).add(r)
        for r in required:
            if r in lsyms:
                need_l.add(r)
            elif r in rsyms:
                need_r.add(r)
        left = prune_columns(node.left, need_l)
        right = prune_columns(node.right, need_r)
        return P.Join(left, right, node.join_type, node.criteria, node.filter,
                      node.distribution, node.mark)
    if isinstance(node, P.SpatialJoin):
        lsyms = {s for s, _ in node.left.outputs()}
        rsyms = {s for s, _ in node.right.outputs()}
        need_l = {node.probe_x, node.probe_y} & lsyms
        need_r = ({node.build_geom, node.build_x, node.build_y}
                  - {""}) & rsyms
        extra = set(required)
        if node.filter is not None:
            extra |= node.filter.refs()
        for r in extra:
            (need_l if r in lsyms else need_r if r in rsyms
             else set()).add(r)
        import dataclasses as _dc

        # fresh node, like every sibling branch (in-place child swaps
        # would narrow plans shared with a retained pre-prune tree)
        return _dc.replace(node,
                           left=prune_columns(node.left, need_l),
                           right=prune_columns(node.right, need_r))
    if isinstance(node, (P.Sort, P.TopN)):
        need = required | {k for k, _, _ in node.keys}
        src = prune_columns(node.source, need)
        if isinstance(node, P.Sort):
            return P.Sort(src, node.keys)
        return P.TopN(src, node.keys, node.count)
    if isinstance(node, P.Limit):
        return P.Limit(prune_columns(node.source, required), node.count)
    if isinstance(node, P.Union):
        new_sources = []
        keep_syms = [s for s in node.symbols if s in required] or node.symbols[:1]
        new_mappings = []
        for src, mapping in zip(node.sources_, node.mappings):
            need = {mapping[s] for s in keep_syms}
            new_sources.append(prune_columns(src, need))
            new_mappings.append({s: mapping[s] for s in keep_syms})
        return P.Union(new_sources, keep_syms, new_mappings, node.distinct)
    if isinstance(node, P.Window):
        need = required | set(node.partition_by) | {k for k, _, _ in node.order_by}
        for c in node.functions.values():
            for arg in c.args:
                need |= arg.refs()
        return P.Window(prune_columns(node.source, need), node.partition_by,
                        node.order_by, node.functions, node.frame)
    if isinstance(node, P.Output):
        return P.Output(prune_columns(node.source, set(node.symbols)),
                        node.names, node.symbols)
    return node


# ---------------------------------------------------------------------------
# spatial join extraction (reference: ExtractSpatialJoins +
# SpatialJoinOperator/PagesRTreeIndex in presto-main; here the runtime
# index is a uniform grid — see P.SpatialJoin)
# ---------------------------------------------------------------------------


def _point_refs(e):
    """st_point(Ref x, Ref y) -> (x, y) symbol names, else None."""
    if isinstance(e, ir.Call) and e.fn == "st_point" \
            and len(e.args) == 2 \
            and all(isinstance(a, ir.Ref) for a in e.args):
        return e.args[0].name, e.args[1].name
    return None


def _match_spatial_conjunct(c, lsyms, rsyms):
    """One conjunct -> SpatialJoin fields, or None.  Shapes:
    st_contains(g, p) / st_within(p, g) with g a Ref and p an
    st_point over Refs; st_distance(p1, p2) < lit / <= lit."""
    if not isinstance(c, ir.Call):
        return None
    if c.fn in ("st_contains", "st_within", "st_intersects") \
            and len(c.args) == 2:
        # a point probe makes st_intersects == st_contains (interior
        # test; boundary points follow the same ray-cast tolerance)
        if c.fn == "st_intersects" and _point_refs(c.args[0]) is not None:
            g, p = c.args[1], c.args[0]
        elif c.fn == "st_within":
            g, p = c.args[1], c.args[0]
        else:
            g, p = c.args
        if isinstance(g, ir.Call) and g.fn == "st_geometryfromtext" \
                and len(g.args) == 1 and isinstance(g.args[0], ir.Ref):
            g = g.args[0]  # WKT column: the executor parses per entry
        pt = _point_refs(p)
        if not isinstance(g, ir.Ref) or pt is None:
            return None
        if g.name in rsyms and pt[0] in lsyms and pt[1] in lsyms:
            return {"kind": "contains", "probe_x": pt[0],
                    "probe_y": pt[1], "build_geom": g.name}
        if g.name in lsyms and pt[0] in rsyms and pt[1] in rsyms:
            return {"kind": "contains", "probe_x": pt[0],
                    "probe_y": pt[1], "build_geom": g.name,
                    "swap": True}
        return None
    if c.fn in ("lt", "le") and len(c.args) == 2 \
            and isinstance(c.args[0], ir.Call) \
            and c.args[0].fn == "st_distance" \
            and isinstance(c.args[1], ir.Lit) \
            and isinstance(c.args[1].value, (int, float)):
        p1 = _point_refs(c.args[0].args[0])
        p2 = _point_refs(c.args[0].args[1])
        if p1 is None or p2 is None:
            return None
        r = float(c.args[1].value)
        # either argument order: the PROBE is whichever point reads the
        # left child's symbols, so the join sides never swap here
        for probe, build in ((p1, p2), (p2, p1)):
            if probe[0] in lsyms and probe[1] in lsyms \
                    and build[0] in rsyms and build[1] in rsyms:
                return {"kind": "distance", "probe_x": probe[0],
                        "probe_y": probe[1], "build_x": build[0],
                        "build_y": build[1], "radius": r,
                        "strict": c.fn == "lt"}
    return None


def _extract_spatial_joins(node: P.PlanNode) -> P.PlanNode:
    for attr in ("source", "left", "right"):
        if hasattr(node, attr):
            setattr(node, attr, _extract_spatial_joins(getattr(node, attr)))
    if isinstance(node, P.Union):
        node.sources_ = [_extract_spatial_joins(s) for s in node.sources_]
    # pattern A: Filter over a filter-free CROSS join
    # pattern B: the CROSS join carries the predicate itself
    filt_node = None
    join = node
    if isinstance(node, P.Filter) and isinstance(node.source, P.Join):
        filt_node, join = node, node.source
    if not (isinstance(join, P.Join) and join.join_type == "CROSS"
            and not join.criteria):
        return node
    pred = filt_node.predicate if filt_node is not None else join.filter
    if filt_node is not None and join.filter is not None:
        pred = ir.combine_conjuncts(
            list(ir.conjuncts(pred)) + list(ir.conjuncts(join.filter)))
    if pred is None:
        return node
    lsyms = {s for s, _ in join.left.outputs()}
    rsyms = {s for s, _ in join.right.outputs()}
    conjs = list(ir.conjuncts(pred))
    for i, c in enumerate(conjs):
        m = _match_spatial_conjunct(c, lsyms, rsyms)
        if m is None:
            continue
        swap = m.pop("swap", False)
        left, right = (join.right, join.left) if swap \
            else (join.left, join.right)
        rest = conjs[:i] + conjs[i + 1:]
        sj = P.SpatialJoin(left=left, right=right,
                           filter=ir.combine_conjuncts(rest)
                           if rest else None, **m)
        return sj
    return node


# ---------------------------------------------------------------------------
# transitive semi-join inference (reference: PredicatePushDown's
# equality inference deriving `l.k IN S` from `l.k = r.k AND r.k IN S`;
# also the static analog of dynamic filtering)
# ---------------------------------------------------------------------------


def infer_transitive_semijoins(node: P.PlanNode) -> P.PlanNode:
    """INNER join whose build side is SEMI-filtered on the join key gets
    the same SEMI filter on the probe side, sharing the filter subquery
    SUBTREE (the executor memoizes shared nodes, so it runs once).  On
    the mask-not-compact executor this is the difference between probing
    6M rows and probing the handful the subquery admits (TPC-H Q18)."""
    for attr in ("source", "left", "right"):
        if hasattr(node, attr):
            setattr(node, attr, infer_transitive_semijoins(
                getattr(node, attr)))
    if isinstance(node, P.Union):
        node.sources_ = [infer_transitive_semijoins(s)
                         for s in node.sources_]
    if not (isinstance(node, P.Join) and node.join_type == "SEMI"
            and len(node.criteria) == 1 and node.filter is None
            and isinstance(node.left, P.Join)
            and node.left.join_type == "INNER" and node.left.criteria):
        return node
    k, sk = node.criteria[0]
    j = node.left
    for lk, rk in j.criteria:
        if k not in (lk, rk):
            continue
        sub = node.right  # SHARED subtree, not a copy
        setattr(sub, "shared_subtree", True)
        # recurse: each pushed SEMI may sit over another inner join in a
        # chain, so the filter keeps descending toward the scans
        lsemi = infer_transitive_semijoins(
            P.Join(j.left, sub, "SEMI", [(lk, sk)], None))
        rsemi = infer_transitive_semijoins(
            P.Join(j.right, sub, "SEMI", [(rk, sk)], None))
        # both inner-join inputs filter on the (equal) key, so the top
        # SEMI is subsumed and the expensive sides compact early
        return P.Join(lsemi, rsemi, "INNER", j.criteria, j.filter,
                      j.distribution, j.mark)
    return node
