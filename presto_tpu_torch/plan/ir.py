"""Typed row-expression IR.

Reference parity: presto-spi/.../spi/relation/ (RowExpression: CallExpression,
ConstantExpression, InputReferenceExpression, SpecialFormExpression) plus the
translator sql/relational/SqlToRowExpressionTranslator.java.  The analyzer
emits this IR; the executor traces it straight into jaxprs (the role the
reference fills with JVM bytecode generation, sql/gen/ExpressionCompiler).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

from presto_tpu_torch.types import Type


class RowExpr:
    type: Type

    def walk(self):
        yield self
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, RowExpr):
                yield from v.walk()
            elif isinstance(v, tuple):
                for x in v:
                    if isinstance(x, RowExpr):
                        yield from x.walk()

    def refs(self) -> set:
        """Free column references (lambda-bound params excluded)."""
        out = set()

        def visit(e):
            if isinstance(e, Ref):
                out.add(e.name)
                return
            if isinstance(e, LambdaExpr):
                out.update(e.body.refs() - set(e.params))
                return
            for f in dataclasses.fields(e):
                v = getattr(e, f.name)
                if isinstance(v, RowExpr):
                    visit(v)
                elif isinstance(v, tuple):
                    for x in v:
                        if isinstance(x, RowExpr):
                            visit(x)

        visit(self)
        return out


@dataclass(frozen=True)
class Ref(RowExpr):
    name: str  # symbol name in the containing plan node's input
    type: Type

    def __str__(self):
        return self.name


@dataclass(frozen=True)
class Lit(RowExpr):
    value: object
    type: Type

    def __str__(self):
        return repr(self.value)


@dataclass(frozen=True)
class Call(RowExpr):
    fn: str  # function registry key, e.g. 'add', 'eq', 'like', 'substring'
    args: Tuple[RowExpr, ...]
    type: Type

    def __str__(self):
        return f"{self.fn}({', '.join(str(a) for a in self.args)})"


@dataclass(frozen=True)
class CastExpr(RowExpr):
    arg: RowExpr
    type: Type
    safe: bool = False

    def __str__(self):
        return f"CAST({self.arg} AS {self.type})"


@dataclass(frozen=True)
class Param(RowExpr):
    """A bound prepared-statement parameter (reference: spi/relation has
    no analog — the reference rewrites parameters to constants at
    analysis; we keep them SYMBOLIC so the plan and its compiled
    executable are value-free).  Evaluation reads
    `EvalContext.params[position]`: a host scalar in dynamic mode, a
    traced 0-d device scalar in compiled mode (the same channel
    ScalarSub uses for distributed subquery values) — so parameter
    binding is a dict lookup plus device transfer, never a retrace."""

    position: int
    type: Type

    def __str__(self):
        return f"$param_{self.position}"


@dataclass(frozen=True)
class ScalarSub(RowExpr):
    """Uncorrelated scalar subquery, referencing a pre-evaluated subplan.
    (Reference: EnforceSingleRowNode + uncorrelated Apply — here the
    executor evaluates subplan DAG nodes before the fragments that use
    them, which is exactly a REMOTE gather exchange in the reference.)"""

    plan_id: int
    type: Type

    def __str__(self):
        return f"$subquery_{self.plan_id}"


@dataclass(frozen=True)
class LambdaExpr(RowExpr):
    """A typed lambda passed to a higher-order function (reference:
    spi/relation LambdaDefinitionExpression).  `params` are fresh symbols
    bound over `body`; free refs beyond them are captures of the enclosing
    row."""

    params: Tuple[str, ...]
    param_types: Tuple[Type, ...]
    body: RowExpr
    type: Type  # FUNCTION(body.type)

    def __str__(self):
        return f"({', '.join(self.params)}) -> {self.body}"


@dataclass(frozen=True)
class AggCall:
    fn: str
    args: Tuple[RowExpr, ...]
    type: Type
    distinct: bool = False
    filter: Optional[RowExpr] = None
    # window value functions only (lag/lead/first/last/nth_value):
    # IGNORE NULLS (reference: sql/tree/FunctionCall nullTreatment)
    ignore_nulls: bool = False

    def __str__(self):
        d = "DISTINCT " if self.distinct else ""
        return f"{self.fn}({d}{', '.join(str(a) for a in self.args)})"


def substitute(expr: RowExpr, mapping: dict) -> RowExpr:
    """Replace Refs by name -> RowExpr."""
    if isinstance(expr, Ref):
        return mapping.get(expr.name, expr)
    if isinstance(expr, Call):
        return Call(expr.fn, tuple(substitute(a, mapping) for a in expr.args), expr.type)
    if isinstance(expr, CastExpr):
        return CastExpr(substitute(expr.arg, mapping), expr.type, expr.safe)
    if isinstance(expr, LambdaExpr):
        # params are allocator-fresh symbols, so they can't collide with keys
        return LambdaExpr(expr.params, expr.param_types,
                          substitute(expr.body, mapping), expr.type)
    return expr


def conjuncts(expr: Optional[RowExpr]) -> list:
    """Flatten nested ANDs."""
    if expr is None:
        return []
    if isinstance(expr, Call) and expr.fn == "and":
        out = []
        for a in expr.args:
            out.extend(conjuncts(a))
        return out
    return [expr]


def combine_conjuncts(exprs) -> Optional[RowExpr]:
    from presto_tpu_torch.types import BOOLEAN

    exprs = [e for e in exprs if e is not None]
    if not exprs:
        return None
    out = exprs[0]
    for e in exprs[1:]:
        out = Call("and", (out, e), BOOLEAN)
    return out
