"""Logical plan nodes.

Reference parity: sql/planner/plan/ (41 node classes) trimmed to the set
the engine executes; symbols are unique strings (reference: Symbol +
SymbolAllocator), every node knows its output symbols and types.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from presto_tpu_torch.plan.ir import AggCall, RowExpr
from presto_tpu_torch.types import Type


class PlanNode:
    id_counter = itertools.count()

    def outputs(self) -> List[Tuple[str, Type]]:
        raise NotImplementedError

    @property
    def sources(self) -> list:
        return []

    def output_names(self):
        return [n for n, _ in self.outputs()]

    def output_types(self) -> Dict[str, Type]:
        return dict(self.outputs())


@dataclass
class TableScan(PlanNode):
    table: str
    # symbol -> source column name (projection pushdown unit)
    assignments: Dict[str, str] = field(default_factory=dict)
    types: Dict[str, Type] = field(default_factory=dict)

    def outputs(self):
        return [(s, self.types[s]) for s in self.assignments]


@dataclass
class Values(PlanNode):
    symbols: List[str] = field(default_factory=list)
    types_: List[Type] = field(default_factory=list)
    rows: List[list] = field(default_factory=list)  # python literal values

    def outputs(self):
        return list(zip(self.symbols, self.types_))


@dataclass
class Filter(PlanNode):
    source: PlanNode
    predicate: RowExpr

    def outputs(self):
        return self.source.outputs()

    @property
    def sources(self):
        return [self.source]


@dataclass
class Project(PlanNode):
    source: PlanNode
    assignments: Dict[str, RowExpr] = field(default_factory=dict)

    def outputs(self):
        return [(s, e.type) for s, e in self.assignments.items()]

    @property
    def sources(self):
        return [self.source]


@dataclass
class Aggregate(PlanNode):
    source: PlanNode
    group_keys: List[str] = field(default_factory=list)
    aggs: Dict[str, AggCall] = field(default_factory=dict)
    # step: SINGLE | PARTIAL | FINAL (reference: AggregationNode.Step)
    step: str = "SINGLE"

    def outputs(self):
        src_types = self.source.output_types()
        out = [(k, src_types[k]) for k in self.group_keys]
        out += [(s, a.type) for s, a in self.aggs.items()]
        return out

    @property
    def sources(self):
        return [self.source]


@dataclass
class SpatialJoin(PlanNode):
    """Grid-indexed spatial inner join (reference: SpatialJoinOperator +
    PagesRTreeIndex).  TPU-native redesign: instead of a pointer-chasing
    R-tree, the build side bins into a uniform grid sized so each
    geometry bbox spans O(1) cells; probes hash to their cell, candidate
    pairs expand vectorized, and the exact predicate (even-odd ray cast
    / distance) evaluates on device over padded edge arrays."""

    left: PlanNode  # probe side: point coordinates
    right: PlanNode  # build side: geometries (or points for distance)
    kind: str  # "contains" | "distance"
    probe_x: str = ""
    probe_y: str = ""
    build_geom: str = ""  # contains: right WKT/GEOMETRY symbol
    build_x: str = ""  # distance: right point coords
    build_y: str = ""
    radius: float = 0.0  # distance joins: st_distance(..) <= radius
    strict: bool = False  # True: < radius, False: <= radius
    filter: Optional[RowExpr] = None  # residual conjuncts

    def outputs(self):
        return list(self.left.outputs()) + list(self.right.outputs())

    @property
    def sources(self):
        return [self.left, self.right]


@dataclass
class Join(PlanNode):
    """INNER/LEFT/RIGHT/FULL/CROSS equi-join (+ residual filter), or
    SEMI/ANTI (left row kept iff [no] right match passes the filter —
    reference: SemiJoinNode, with the filtered-EXISTS generalization),
    or MARK (every left row kept, match-ness exposed as a BOOLEAN
    column `mark` — reference: SemiJoinNode's semiJoinOutput symbol,
    what EXISTS compiles to when it is NOT a top-level conjunct)."""

    left: PlanNode
    right: PlanNode
    join_type: str  # INNER LEFT RIGHT FULL CROSS SEMI ANTI MARK
    criteria: List[Tuple[str, str]] = field(default_factory=list)  # (lsym, rsym)
    filter: Optional[RowExpr] = None
    # execution hints filled by the optimizer
    distribution: str = "AUTOMATIC"  # PARTITIONED | BROADCAST | AUTOMATIC
    mark: Optional[str] = None  # MARK only: output symbol for match-ness
    reordered: bool = False  # ReorderJoins already explored this tree

    def outputs(self):
        if self.join_type == "MARK":
            from presto_tpu_torch import types as _T

            return self.left.outputs() + [(self.mark, _T.BOOLEAN)]
        if self.join_type in ("SEMI", "ANTI"):
            return self.left.outputs()
        lout = self.left.outputs()
        rout = self.right.outputs()
        if self.join_type in ("LEFT", "FULL"):
            rout = [(s, t) for s, t in rout]
        return lout + rout

    @property
    def sources(self):
        return [self.left, self.right]


@dataclass
class Sort(PlanNode):
    source: PlanNode
    keys: List[Tuple[str, bool, Optional[bool]]] = field(default_factory=list)
    # (symbol, ascending, nulls_first)

    def outputs(self):
        return self.source.outputs()

    @property
    def sources(self):
        return [self.source]


@dataclass
class Limit(PlanNode):
    source: PlanNode
    count: int = 0

    def outputs(self):
        return self.source.outputs()

    @property
    def sources(self):
        return [self.source]


@dataclass
class TopN(PlanNode):
    source: PlanNode
    keys: List[Tuple[str, bool, Optional[bool]]] = field(default_factory=list)
    count: int = 0

    def outputs(self):
        return self.source.outputs()

    @property
    def sources(self):
        return [self.source]


@dataclass
class Union(PlanNode):
    sources_: List[PlanNode] = field(default_factory=list)
    symbols: List[str] = field(default_factory=list)
    # per-source mapping: output symbol -> source symbol
    mappings: List[Dict[str, str]] = field(default_factory=list)
    distinct: bool = False

    def outputs(self):
        t0 = self.sources_[0].output_types()
        return [(s, t0[self.mappings[0][s]]) for s in self.symbols]

    @property
    def sources(self):
        return list(self.sources_)


@dataclass
class Window(PlanNode):
    source: PlanNode
    partition_by: List[str] = field(default_factory=list)
    order_by: List[Tuple[str, bool, Optional[bool]]] = field(default_factory=list)
    functions: Dict[str, AggCall] = field(default_factory=dict)  # symbol -> call
    frame: Optional[Tuple[str, str, str]] = None

    def outputs(self):
        return self.source.outputs() + [(s, c.type) for s, c in self.functions.items()]

    @property
    def sources(self):
        return [self.source]


@dataclass
class Unnest(PlanNode):
    """Lateral array explode (reference: UnnestNode + operator/unnest/):
    each source row fans out to one row per element of its array value."""

    source: PlanNode
    array_expr: object  # RowExpr yielding an ARRAY column
    out_sym: str = ""
    elem_type: Type = None
    ordinality_sym: Optional[str] = None

    def outputs(self):
        out = list(self.source.outputs())
        out.append((self.out_sym, self.elem_type))
        if self.ordinality_sym:
            from presto_tpu_torch.types import BIGINT

            out.append((self.ordinality_sym, BIGINT))
        return out

    @property
    def sources(self):
        return [self.source]


@dataclass
class Exchange(PlanNode):
    """Data-movement boundary between distributions (reference:
    sql/planner/plan/ExchangeNode.java — REPARTITION/REPLICATE/GATHER
    over REMOTE_STREAMING scope).  On TPU these lower to collectives
    inside one shard_mapped program instead of HTTP shuffles:
    repartition -> lax.all_to_all on row-hash buckets (P1),
    broadcast   -> lax.all_gather (P2),
    gather      -> lax.all_gather to full replication (P5),
    scatter     -> replicated input masked to one shard (inverse of P2,
                   used to feed replicated rows into a sharded union)."""

    source: PlanNode
    kind: str = "gather"  # repartition | broadcast | gather | scatter
    keys: List[str] = field(default_factory=list)  # hash keys (repartition)

    def outputs(self):
        return self.source.outputs()

    @property
    def sources(self):
        return [self.source]


@dataclass
class TableWriter(PlanNode):
    """Streams the source relation into a connector PageSink
    (reference: sql/planner/plan/TableWriterNode + TableWriterOperator).
    The sink handle itself is runtime state carried by the executor's
    WriteContext (exec/writer.py) — the node holds only the write's
    metadata so plans stay data-only and EXPLAIN can render the target.
    Output: one row with the appended row count."""

    source: PlanNode
    target: str = ""            # table name being written
    connector: str = ""         # memory | localfile | parquet | orc | ...
    columns: List[str] = field(default_factory=list)  # target column order
    write_props: Optional[dict] = None  # bucketed_by/sorted_by/... summary
    rows_symbol: str = "rows$w"

    def outputs(self):
        from presto_tpu_torch import types as _T

        return [(self.rows_symbol, _T.BIGINT)]

    @property
    def sources(self):
        return [self.source]


@dataclass
class TableFinish(PlanNode):
    """Commit point of a write plan (reference: TableFinishNode +
    TableFinishOperator): runs ONCE on the coordinator after every
    TableWriter page landed, publishing the staged output atomically
    (manifest rewrite / catalog registration) and emitting the final
    row count."""

    source: PlanNode  # the TableWriter

    def outputs(self):
        return self.source.outputs()

    @property
    def sources(self):
        return [self.source]


@dataclass
class Output(PlanNode):
    source: PlanNode
    names: List[str] = field(default_factory=list)  # user-visible column names
    symbols: List[str] = field(default_factory=list)

    def outputs(self):
        t = self.source.output_types()
        return [(s, t[s]) for s in self.symbols]

    @property
    def sources(self):
        return [self.source]


# ---------------------------------------------------------------------------


@dataclass
class QueryPlan:
    """Root plan + uncorrelated scalar subplans it references.
    Subplans are evaluated first (reference: uncorrelated Apply lowered to
    an exchange from a separate stage)."""

    root: Output
    subplans: Dict[int, PlanNode] = field(default_factory=dict)


def plan_tree_str(node: PlanNode, indent: int = 0, annotate=None) -> str:
    """EXPLAIN-style textual plan (reference: textLogicalPlan in
    sql/planner/planPrinter/PlanPrinter.java); annotate(node) -> suffix
    string appends runtime stats for EXPLAIN ANALYZE."""
    pad = "  " * indent
    name = type(node).__name__
    detail = ""
    if isinstance(node, TableScan):
        detail = f" {node.table} {list(node.assignments.values())}"
    elif isinstance(node, Filter):
        detail = f" [{node.predicate}]"
    elif isinstance(node, Project):
        detail = " {" + ", ".join(f"{s} := {e}" for s, e in node.assignments.items()) + "}"
    elif isinstance(node, Aggregate):
        detail = (f" {node.step} keys={node.group_keys} "
                  + "{" + ", ".join(f"{s} := {a}" for s, a in node.aggs.items()) + "}")
    elif isinstance(node, Join):
        detail = f" {node.join_type} {node.criteria}" + (
            f" filter=[{node.filter}]" if node.filter is not None else "") + (
            " INDEX" if getattr(node, "index_lookup", None) else "")
    elif isinstance(node, SpatialJoin):
        pred = (f"ST_Contains({node.build_geom}, "
                f"point({node.probe_x}, {node.probe_y}))"
                if node.kind == "contains" else
                f"ST_Distance(({node.probe_x}, {node.probe_y}), "
                f"({node.build_x}, {node.build_y})) "
                f"{'<' if node.strict else '<='} {node.radius}")
        detail = f" GRID-INDEXED [{pred}]" + (
            f" filter=[{node.filter}]" if node.filter is not None else "")
    elif isinstance(node, (Sort, TopN)):
        detail = f" {node.keys}" + (
            f" limit={node.count}" if isinstance(node, TopN) else "")
    elif isinstance(node, Limit):
        detail = f" {node.count}"
    elif isinstance(node, Output):
        detail = f" {list(zip(node.names, node.symbols))}"
    elif isinstance(node, Values):
        detail = f" {len(node.rows)} rows"
    elif isinstance(node, Window):
        detail = f" partition={node.partition_by} order={node.order_by}"
    elif isinstance(node, Exchange):
        detail = f" {node.kind}" + (f" keys={node.keys}" if node.keys else "")
    elif isinstance(node, TableWriter):
        props = {k: v for k, v in (node.write_props or {}).items() if v}
        detail = f" {node.target} [{node.connector}]" + (
            f" {props}" if props else "")
    lines = [pad + name + detail + (annotate(node) if annotate else "")]
    for s in node.sources:
        lines.append(plan_tree_str(s, indent + 1, annotate))
    return "\n".join(lines)
