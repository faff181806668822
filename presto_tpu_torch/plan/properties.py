"""Ordering properties: derive, propagate, and exploit sortedness.

Reference parity: LocalProperties + StreamPropertyDerivations feeding
AddLocalExchanges (sql/planner/optimizations/), which elide redundant
local sorts/repartitions when an ordering or grouping is already
satisfied.  The TPU engine's version serves the sort economics of the
kernel layer: every heavyweight operator bottoms out in a full-length
`lax.sort` (~170ms per 6M rows measured), and the connectors' device
generators emit their tables ALREADY ordered by primary key — so
knowing (and re-deriving through the plan) what is sorted lets the
executor route to sort-free kernel variants (exec/kernels.py
group_ids_presorted / build_probe with an identity order).

Derived per node:

- ``sorted_on``: a tuple of (symbol, ascending) — the output rows are
  lexicographically nondecreasing on this key prefix over LIVE rows
  (masked rows may sit anywhere; the mask-not-compact executor never
  moves rows, it only hides them).
- ``grouped_on``: a tuple of symbols whose equal-value rows are
  contiguous among live rows (sortedness implies groupedness; grouping
  survives some transforms that break global order).

Claims seeded from connector metadata (``ConnectorTable.ordering()``)
are CLAIMS, not facts: every consumption site verifies them with a
traced monotonicity guard over the actual packed key (the same pattern
as ``layout_range_guard``), so a wrong declaration degrades to the
dynamic sort path and can never corrupt results.  Operator-produced
orderings (a sort-based group-by emits rows ascending on its packed
group key) are exact by construction but still flow through the same
guarded routing — certainty lives in the executor's runtime channel,
not here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from presto_tpu_torch.plan import ir
from presto_tpu_torch.plan import nodes as P


@dataclasses.dataclass(frozen=True)
class OrderingProps:
    """Per-node ordering claims (see module docstring).

    ``all_live_or_tail``: structurally, masked rows can only form a
    SUFFIX of this node's output (scans emit all-live; a static
    aggregate's exists mask is a prefix of live groups) — required by
    consumers that need the FULL array nondecreasing (a presorted join
    build, where masked-row sentinels must sort last by position).
    Filters and joins mask interior rows and clear it.

    ``fd_leading``: symbols functionally determined by the leading
    sorted symbol (constant within each of its equal-value runs) —
    derived from unique keys and unique-build joins.  What makes a
    multi-key GROUP BY packed key provably monotone when only the
    leading key is sorted (TPC-H q3: o_orderdate/o_shippriority ride
    the unique orders join, so they are constant per l_orderkey)."""

    sorted_on: Tuple[Tuple[str, bool], ...] = ()
    grouped_on: Tuple[str, ...] = ()
    all_live_or_tail: bool = False
    fd_leading: frozenset = frozenset()

    @property
    def leading(self) -> Optional[str]:
        return self.sorted_on[0][0] if self.sorted_on else None


EMPTY = OrderingProps()


def _scan_props(node: P.TableScan, catalog) -> OrderingProps:
    """Seed from connector metadata: the longest prefix of the table's
    declared ordering whose columns the scan projects.  A missing
    prefix column breaks the claim there (sortedness of (k1, k2) says
    nothing about k2 alone)."""
    if catalog is None:
        return EMPTY
    try:
        table = catalog.get(node.table)
    except KeyError:
        return EMPTY
    decl = []
    if hasattr(table, "ordering"):
        try:
            decl = list(table.ordering() or [])
        except Exception:
            decl = []
    if not decl:
        return EMPTY
    col_to_sym: Dict[str, str] = {}
    for sym, col in node.assignments.items():
        col_to_sym.setdefault(col, sym)
    out = []
    for col, asc in decl:
        sym = col_to_sym.get(col)
        if sym is None:
            break
        out.append((sym, bool(asc)))
    sorted_on = tuple(out)
    if not sorted_on:
        return EMPTY
    # leading column unique => every row's value is distinct => every
    # projected symbol is trivially constant within its (1-row) runs
    fd = {sorted_on[0][0]}
    try:
        uniq = [tuple(k) for k in table.unique_keys()] \
            if hasattr(table, "unique_keys") else []
    except Exception:
        uniq = []
    lead_col = decl[0][0]
    if (lead_col,) in uniq:
        fd |= set(node.assignments)
    return OrderingProps(sorted_on, tuple(s for s, _ in sorted_on),
                         all_live_or_tail=True, fd_leading=frozenset(fd))


def _project_props(node: P.Project, src: OrderingProps) -> OrderingProps:
    """Row-wise: order passes through identity (Ref) assignments under
    their new names; the prefix cuts at the first key that is not
    re-exposed as a plain Ref.  An output is FD-of-leading when every
    input it reads is (a pure row-wise function of constants is
    constant)."""
    out_of: Dict[str, str] = {}
    for sym, e in node.assignments.items():
        if isinstance(e, ir.Ref):
            out_of.setdefault(e.name, sym)
    sorted_on = []
    for sym, asc in src.sorted_on:
        mapped = out_of.get(sym)
        if mapped is None:
            break
        sorted_on.append((mapped, asc))
    if not sorted_on:
        return OrderingProps(all_live_or_tail=src.all_live_or_tail)
    grouped = []
    for sym in src.grouped_on:
        mapped = out_of.get(sym)
        if mapped is None:
            break
        grouped.append(mapped)
    fd = set()
    for sym, e in node.assignments.items():
        try:
            if e.refs() <= src.fd_leading:
                fd.add(sym)
        except Exception:
            pass
    fd.add(sorted_on[0][0])
    return OrderingProps(tuple(sorted_on), tuple(grouped),
                         all_live_or_tail=src.all_live_or_tail,
                         fd_leading=frozenset(fd))


def _aggregate_props(node: P.Aggregate) -> OrderingProps:
    """Sort-based grouping emits one row per group in ascending packed-
    key order, and kernels pack with the FIRST key most significant —
    so the output is sorted on the group keys in pack order.  Exact
    packing only: the 62-bit hash fallback is order-destroying, which
    is one of the reasons consumers must guard.  all_live_or_tail stays
    False: the small-layout direct path (packed key as slot id) leaves
    dead slots INTERSPERSED; the executor's runtime channel knows which
    path actually ran and upgrades certainty there."""
    if not node.group_keys:
        return EMPTY  # single global row: trivially sorted, nothing usable
    keys = list(getattr(node, "ordering_pack_order", None)
                or node.group_keys)
    fd = {keys[0]}
    if len(keys) == 1:
        # unique on the single key: every output symbol constant per row
        fd |= {keys[0]} | set(node.aggs)
    return OrderingProps(tuple((k, True) for k in keys), tuple(keys),
                         all_live_or_tail=False, fd_leading=frozenset(fd))


def _join_props(node: P.Join, left: OrderingProps,
                right: OrderingProps) -> OrderingProps:
    """Probe (left) order survives every probe-layout-preserving join in
    this executor: SEMI/ANTI/MARK mask the probe in place; unique-build
    INNER/LEFT and index joins gather the build at probe positions; the
    expanding join emits probe rows in nondecreasing probe-row order
    (lidx = repeat(arange)).  Sort-order materialization re-permutes an
    expansion ONLY when every consumer is order-insensitive, and the
    executor turns that off below ordering-exploiting aggregates — the
    claim and the exploitation are kept consistent there.  FULL appends
    unmatched build rows (order destroyed); CROSS repeats the probe
    rows in order (preserved).

    FD transfer: a single-criterion unique-build INNER/LEFT join whose
    probe key is FD-of-leading makes EVERY build output constant within
    a leading run (the unique build row per key value — the FD that
    lets q3 group by (l_orderkey, o_orderdate, o_shippriority) with
    only l_orderkey sorted)."""
    if node.join_type == "FULL":
        return EMPTY
    if node.join_type == "RIGHT":
        # executed as the mirrored LEFT: build (left operand) rows
        # gathered at probe positions — the RIGHT side's order survives
        base = right
    else:
        base = left
    if not base.sorted_on:
        return EMPTY
    fd = set(base.fd_leading)
    if node.join_type in ("INNER", "LEFT") and len(node.criteria) == 1 \
            and getattr(node, "build_unique", False):
        lk, _rk = node.criteria[0]
        if lk in fd:
            fd |= {s for s, _ in node.right.outputs()}
    # INNER/SEMI/ANTI/expanding joins mask or repeat interior rows
    return OrderingProps(base.sorted_on, base.grouped_on,
                         all_live_or_tail=False,
                         fd_leading=frozenset(fd))


def _window_props() -> OrderingProps:
    # execute_window sorts by (partition, order) and leaves the batch
    # there; claiming that ordering needs partition-key prefix
    # semantics we don't exploit yet — stay conservative
    return EMPTY


def derive(node: P.PlanNode, catalog, memo=None) -> OrderingProps:
    """Bottom-up ordering derivation (identity-checked memo, same shape
    as plan/stats.derive)."""
    if memo is None:
        memo = {}
    hit = memo.get(id(node))
    if hit is not None and hit[0] is node:
        return hit[1]
    p = _derive(node, catalog, memo)
    memo[id(node)] = (node, p)
    return p


def _derive(node, catalog, memo) -> OrderingProps:
    d = lambda n: derive(n, catalog, memo)
    if isinstance(node, P.TableScan):
        return _scan_props(node, catalog)
    if isinstance(node, P.Filter):
        # masking never moves rows, but it punches interior holes
        return dataclasses.replace(d(node.source), all_live_or_tail=False)
    if isinstance(node, P.Limit):
        # rank-cut: live rows keep their positions; newly-masked rows
        # extend whatever tail the input already had
        return d(node.source)
    if isinstance(node, P.Project):
        return _project_props(node, d(node.source))
    if isinstance(node, P.Output):
        return d(node.source)
    if isinstance(node, P.Aggregate):
        d(node.source)  # populate memo for annotate()
        return _aggregate_props(node)
    if isinstance(node, (P.Sort, P.TopN)):
        d(node.source)
        sorted_on = tuple((s, asc) for s, asc, _nf in node.keys)
        # sort_perm sends masked rows last => suffix masking
        return OrderingProps(sorted_on, tuple(s for s, _ in sorted_on),
                             all_live_or_tail=True,
                             fd_leading=frozenset({sorted_on[0][0]})
                             if sorted_on else frozenset())
    if isinstance(node, P.Join):
        return _join_props(node, d(node.left), d(node.right))
    if isinstance(node, P.SpatialJoin):
        d(node.left)
        d(node.right)
        return EMPTY
    if isinstance(node, P.Window):
        d(node.source)
        return _window_props()
    if isinstance(node, P.Exchange):
        d(node.source)
        return EMPTY  # repartition/broadcast/gather interleave rows
    if isinstance(node, P.Union):
        for s in node.sources_:
            d(s)
        return EMPTY  # concatenation of sorted runs is not sorted
    if isinstance(node, P.Unnest):
        # probe rows expand in nondecreasing source order; dead slots
        # land interior
        return dataclasses.replace(d(node.source), all_live_or_tail=False)
    if isinstance(node, P.Values):
        return EMPTY
    for s in getattr(node, "sources", []):
        d(s)
    return EMPTY


def annotate(plan: P.QueryPlan, session) -> None:
    """Attach ordering hints the executor's guarded routing consults:

    - ``Aggregate.ordering_hint`` + ``ordering_pack_order`` (+
      ``ordering_hint_safe``): the input is claimed sorted on a leading
      group key — pack it most significant and route to the
      run-boundary scan (no grouping sort, no unpermute) behind a
      monotonicity guard.  ``safe`` means every remaining key is
      provably constant within leading-key runs (sorted-prefix-covered
      or FD-of-leading), so the guard cannot trip for structural
      reasons — the compiled path only exploits safe hints, because a
      tripped static guard costs a whole-query dynamic re-run, while
      the dynamic path host-checks cheaply and exploits all hints.
    - ``Join.build_ordering_hint``: the single-criterion build side is
      claimed sorted on the join key with masked rows structurally
      confined to a suffix — elides the build argsort behind a
      full-array monotone guard.

    Hints are advisory; every exploitation is guard-verified at
    runtime, so stale or wrong metadata degrades, never corrupts."""
    catalog = getattr(session, "catalog", None)
    memo: dict = {}
    seen: set = set()

    def walk(node):
        if id(node) in seen:
            return
        seen.add(id(node))
        for s in node.sources:
            walk(s)
        if isinstance(node, P.Aggregate) and node.group_keys:
            src = derive(node.source, catalog, memo)
            lead = src.leading
            if lead not in node.group_keys or not src.sorted_on[0][1]:
                return
            # pack the sorted-covered run first (in sorted order), then
            # the remaining keys: monotone iff the remainder is
            # constant within leading runs
            prefix = []
            for s, asc in src.sorted_on:
                if not asc or s not in node.group_keys or s in prefix:
                    break
                prefix.append(s)
            rest = [k for k in node.group_keys if k not in prefix]
            node.ordering_hint = lead
            node.ordering_pack_order = prefix + rest
            node.ordering_hint_safe = all(k in src.fd_leading
                                          for k in rest)
        elif isinstance(node, P.Join) and len(node.criteria) == 1 \
                and node.join_type not in ("CROSS",):
            rk = node.criteria[0][1]
            rp = derive(node.right, catalog, memo)
            if rp.leading == rk and rp.sorted_on[0][1] \
                    and rp.all_live_or_tail:
                node.build_ordering_hint = True

    walk(plan.root)
    for sub in plan.subplans.values():
        walk(sub)
