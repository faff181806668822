"""SQL abstract syntax tree.

Reference parity: presto-parser/src/main/java/com/facebook/presto/sql/tree/
(160 node classes).  Trimmed to the query language subset the engine
executes (full TPC-H + general analytic SQL); dataclasses instead of the
reference's visitor hierarchy — tree walks are plain pattern matches.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union


class Node:
    def children(self):
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, Node):
                yield v
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, Node):
                        yield x


# ---- expressions ----------------------------------------------------------


@dataclass
class Expr(Node):
    pass


@dataclass
class Literal(Expr):
    value: object  # python int/float/str/bool/None
    type_hint: Optional[str] = None  # 'date' | 'timestamp' | 'decimal' | None


@dataclass
class Parameter(Expr):
    """A `?` placeholder in a prepared statement (reference:
    sql/tree/Parameter).  `type_` is bound by the serving tier at
    EXECUTE time (server/serving.py) from the parameter values'
    engine types, so the SAME template plans once per type signature
    and the plan/executable are value-free (ir.Param)."""

    position: int  # 0-based, textual order == EXECUTE ... USING order
    type_: object = None  # presto_tpu.types.Type once bound


@dataclass
class IntervalLiteral(Expr):
    value: int
    unit: str  # DAY | MONTH | YEAR


@dataclass
class Identifier(Expr):
    parts: Tuple[str, ...]  # possibly qualified: (table, column) or (column,)

    @property
    def name(self) -> str:
        return self.parts[-1]


@dataclass
class Star(Expr):
    qualifier: Optional[str] = None  # t.* or *


@dataclass
class BinaryOp(Expr):
    op: str  # + - * / % || = <> < <= > >= AND OR
    left: Expr
    right: Expr


@dataclass
class UnaryOp(Expr):
    op: str  # - NOT
    operand: Expr


@dataclass
class Between(Expr):
    value: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass
class InList(Expr):
    value: Expr
    items: List[Expr]
    negated: bool = False


@dataclass
class InSubquery(Expr):
    value: Expr
    query: "Query"
    negated: bool = False


@dataclass
class Exists(Expr):
    query: "Query"
    negated: bool = False


@dataclass
class ScalarSubquery(Expr):
    query: "Query"


@dataclass
class Like(Expr):
    value: Expr
    pattern: Expr
    escape: Optional[Expr] = None
    negated: bool = False


@dataclass
class IsNull(Expr):
    value: Expr
    negated: bool = False


@dataclass
class Case(Expr):
    operand: Optional[Expr]  # CASE x WHEN ... vs CASE WHEN ...
    whens: List[Tuple[Expr, Expr]]
    default: Optional[Expr]


@dataclass
class Cast(Expr):
    value: Expr
    type_name: str
    safe: bool = False  # TRY_CAST


@dataclass
class FunctionCall(Expr):
    name: str
    args: List[Expr]
    distinct: bool = False
    filter: Optional[Expr] = None
    window: Optional["WindowSpec"] = None
    # "IGNORE" | "RESPECT" | None (reference: nullTreatment)
    null_treatment: Optional[str] = None


@dataclass
class Lambda(Expr):
    """`x -> body` / `(x, y) -> body` — only valid as a function argument
    (reference: sql/tree/LambdaExpression.java)."""
    params: List[str]
    body: Expr


@dataclass
class Extract(Expr):
    fld: str  # YEAR MONTH DAY ...
    value: Expr


@dataclass
class WindowSpec(Node):
    partition_by: List[Expr] = field(default_factory=list)
    order_by: List["SortItem"] = field(default_factory=list)
    # frame support: (type, start, end) — ROWS/RANGE; None = default frame
    frame: Optional[Tuple[str, str, str]] = None


# ---- relations ------------------------------------------------------------


@dataclass
class Relation(Node):
    pass


@dataclass
class Table(Relation):
    name: str
    alias: Optional[str] = None
    column_aliases: Optional[List[str]] = None
    # TABLESAMPLE: ("BERNOULLI" | "SYSTEM", percentage) — reference:
    # SqlBase.g4 sampledRelation
    sample: Optional[tuple] = None


@dataclass
class SubqueryRelation(Relation):
    query: "Query"
    alias: Optional[str] = None
    column_aliases: Optional[List[str]] = None


@dataclass
class Join(Relation):
    join_type: str  # INNER LEFT RIGHT FULL CROSS
    left: Relation
    right: Relation
    on: Optional[Expr] = None
    using: Optional[List[str]] = None


@dataclass
class Unnest(Relation):
    exprs: List[Expr]
    alias: Optional[str] = None
    with_ordinality: bool = False


@dataclass
class ValuesRelation(Relation):
    rows: List[List[Expr]]
    alias: Optional[str] = None
    column_aliases: Optional[List[str]] = None


# ---- query structure ------------------------------------------------------


@dataclass
class SelectItem(Node):
    expr: Expr
    alias: Optional[str] = None


@dataclass
class SortItem(Node):
    expr: Expr
    ascending: bool = True
    nulls_first: Optional[bool] = None  # None = default (last for asc, first for desc)


@dataclass
class QuerySpec(Node):
    select: List[SelectItem]
    distinct: bool = False
    from_: Optional[Relation] = None
    where: Optional[Expr] = None
    group_by: List[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    # GROUPING SETS/ROLLUP/CUBE: list of grouping-key subsets; the
    # planner expands to a UNION ALL of per-set aggregations
    # (reference: GroupIdNode + GroupIdOperator)
    grouping_sets: Optional[List[List[Expr]]] = None


@dataclass
class SetOp(Node):
    op: str  # UNION | INTERSECT | EXCEPT
    all: bool
    left: Union["QuerySpec", "SetOp"]
    right: Union["QuerySpec", "SetOp"]


@dataclass
class Query(Node):
    body: Union[QuerySpec, SetOp]
    order_by: List[SortItem] = field(default_factory=list)
    limit: Optional[int] = None
    ctes: List[Tuple[str, "Query", Optional[List[str]]]] = field(default_factory=list)


# ---- statements -----------------------------------------------------------


@dataclass
class Statement(Node):
    pass


@dataclass
class QueryStatement(Statement):
    query: Query


@dataclass
class Explain(Statement):
    statement: Statement
    analyze: bool = False
    # EXPLAIN (TYPE LOGICAL | DISTRIBUTED | VALIDATE) — reference:
    # SqlBase.g4 explainOption / ExplainType
    type_: str = "LOGICAL"


@dataclass
class DescribeInput(Statement):
    name: str


@dataclass
class DescribeOutput(Statement):
    name: str


@dataclass
class ShowTables(Statement):
    pass


@dataclass
class ShowColumns(Statement):
    table: str


@dataclass
class ShowFunctions(Statement):
    pass


@dataclass
class ShowSession(Statement):
    pass


@dataclass
class ShowCatalogs(Statement):
    pass


@dataclass
class ShowSchemas(Statement):
    pass


@dataclass
class ShowStats(Statement):
    table: str


@dataclass
class CreateTableAs(Statement):
    """CREATE [OR REPLACE] TABLE t [WITH (...)] AS query.  OR REPLACE is
    the refresh-and-serve cut-over: the new snapshot stages invisibly
    and publishes atomically while concurrent readers keep the previous
    one (exec/writer.py, docs/WRITES.md)."""

    name: str
    query: Query
    properties: dict = field(default_factory=dict)
    if_not_exists: bool = False
    or_replace: bool = False


@dataclass
class ShowCreateTable(Statement):
    """SHOW CREATE TABLE t — renders DDL including the recorded
    physical-layout write properties (reference: ShowQueriesRewrite's
    SHOW CREATE handling)."""

    table: str


@dataclass
class InsertInto(Statement):
    table: str
    columns: Optional[List[str]]
    query: Query


@dataclass
class CreateTable(Statement):
    """CREATE TABLE t (col type, ...) [WITH (k = v, ...)] — reference:
    SqlBase.g4 createTable; WITH properties select the connector
    (connector = 'memory' | 'localfile' | 'blackhole')."""

    name: str
    columns: List[tuple]  # (name, type_text)
    properties: dict
    if_not_exists: bool = False


@dataclass
class DropTable(Statement):
    name: str
    if_exists: bool = False


@dataclass
class CreateMaterializedView(Statement):
    """CREATE [OR REPLACE] MATERIALIZED VIEW v [WITH (...)] AS query.
    The backing table stores the rollup state (exact aggregate partials
    plus sketch register/summary columns) so REFRESH can fold a source
    delta in without rescanning history (exec/matview.py)."""

    name: str
    query: Query
    properties: dict = field(default_factory=dict)
    if_not_exists: bool = False
    or_replace: bool = False


@dataclass
class RefreshMaterializedView(Statement):
    name: str


@dataclass
class DropMaterializedView(Statement):
    name: str
    if_exists: bool = False


@dataclass
class ShowMaterializedViews(Statement):
    pass


@dataclass
class Delete(Statement):
    """DELETE FROM t [WHERE pred] — reference: SqlBase.g4 delete,
    executed as a keep-mask rewrite (MetadataDeleteOperator analog)."""

    table: str
    where: Optional[Expr]


@dataclass
class Prepare(Statement):
    """PREPARE name FROM statement (reference: SqlBase.g4 prepare;
    parameters are `?` placeholders substituted at EXECUTE)."""

    name: str
    statement_text: str


@dataclass
class Execute(Statement):
    name: str
    parameters: List[Expr]


@dataclass
class Deallocate(Statement):
    name: str


@dataclass
class TransactionStatement(Statement):
    """START TRANSACTION [READ ONLY] | COMMIT | ROLLBACK (reference:
    SqlBase.g4 startTransaction/commit/rollback)."""

    action: str  # START | COMMIT | ROLLBACK
    read_only: bool = False


@dataclass
class SetSession(Statement):
    name: str
    value: object
