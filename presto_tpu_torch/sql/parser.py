"""SQL lexer + recursive-descent/Pratt parser.

Reference parity: presto-parser's ANTLR4 grammar SqlBase.g4 (785 lines) +
SqlParser.java.  Hand-rolled (no parser generator in the image) covering
the query-language subset the engine executes: full TPC-H, joins of all
types, subqueries (scalar/IN/EXISTS), CTEs, set operations, window
functions, CASE/CAST/EXTRACT/INTERVAL, EXPLAIN [ANALYZE], SHOW,
CREATE TABLE AS, INSERT, SET SESSION.
"""

from __future__ import annotations

import re
from typing import List

from presto_tpu_torch.sql import ast


class ParseError(Exception):
    pass


_TOKEN_RE = re.compile(
    r"""
      (?P<ws>\s+|--[^\n]*|/\*.*?\*/)
    | (?P<number>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
    | (?P<string>'(?:[^']|'')*')
    | (?P<qident>"(?:[^"]|"")*")
    | (?P<ident>[A-Za-z_][A-Za-z0-9_$]*)
    | (?P<op><>|!=|>=|<=|\|\||=>|->|[-+*/%(),.;=<>\[\]?])
    """,
    re.VERBOSE | re.DOTALL,
)

KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "HAVING", "ORDER", "LIMIT",
    "AS", "AND", "OR", "NOT", "IN", "EXISTS", "BETWEEN", "LIKE", "ESCAPE",
    "IS", "NULL", "TRUE", "FALSE", "CASE", "WHEN", "THEN", "ELSE", "END",
    "CAST", "TRY_CAST", "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER",
    "CROSS", "ON", "USING", "UNION", "INTERSECT", "EXCEPT", "ALL", "DISTINCT",
    "WITH", "ASC", "DESC", "NULLS", "FIRST", "LAST", "DATE", "TIME",
    "TIMESTAMP", "INTERVAL", "EXTRACT", "SUBSTRING", "FOR", "VALUES",
    "EXPLAIN", "ANALYZE", "SHOW", "TABLES", "COLUMNS", "CREATE", "TABLE",
    "INSERT", "INTO", "SET", "SESSION", "OVER", "PARTITION", "ROWS", "RANGE",
    "UNBOUNDED", "PRECEDING", "FOLLOWING", "CURRENT", "ROW", "UNNEST",
    "ORDINALITY", "FILTER", "DROP", "DELETE", "IF", "START", "TRANSACTION",
    "COMMIT", "ROLLBACK", "READ", "ONLY", "WRITE", "PREPARE", "EXECUTE",
    "DEALLOCATE", "USING", "ROLLUP", "CUBE",
}


class Token:
    __slots__ = ("kind", "value", "pos")

    def __init__(self, kind, value, pos):
        self.kind = kind  # 'number' | 'string' | 'ident' | 'kw' | 'op' | 'eof'
        self.value = value
        self.pos = pos

    def __repr__(self):
        return f"Token({self.kind},{self.value!r})"


def tokenize(text: str) -> List[Token]:
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise ParseError(f"lex error at {pos}: {text[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        val = m.group()
        if kind == "ident":
            up = val.upper()
            if up in KEYWORDS:
                out.append(Token("kw", up, m.start()))
            else:
                out.append(Token("ident", val.lower(), m.start()))
        elif kind == "qident":
            out.append(Token("ident", val[1:-1].replace('""', '"'), m.start()))
        elif kind == "string":
            out.append(Token("string", val[1:-1].replace("''", "'"), m.start()))
        else:
            out.append(Token(kind, val, m.start()))
    out.append(Token("eof", None, len(text)))
    return out


class Parser:
    def __init__(self, text: str):
        self.text = text
        self.toks = tokenize(text)
        self.i = 0
        self._n_params = 0  # `?` placeholders seen, in textual order

    # ---- token helpers ----------------------------------------------
    def peek(self, ahead=0) -> Token:
        return self.toks[min(self.i + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in kws

    def at_op(self, *ops) -> bool:
        t = self.peek()
        return t.kind == "op" and t.value in ops

    def accept_kw(self, *kws) -> bool:
        if self.at_kw(*kws):
            self.i += 1
            return True
        return False

    def accept_op(self, *ops) -> bool:
        if self.at_op(*ops):
            self.i += 1
            return True
        return False

    def expect_kw(self, kw) -> None:
        if not self.accept_kw(kw):
            self.err(f"expected {kw}")

    def expect_op(self, op) -> None:
        if not self.accept_op(op):
            self.err(f"expected '{op}'")

    def err(self, msg):
        t = self.peek()
        ctx = self.text[max(0, t.pos - 30): t.pos + 30]
        raise ParseError(f"{msg} at position {t.pos} near {ctx!r} (got {t!r})")

    def ident(self) -> str:
        t = self.peek()
        if t.kind == "ident":
            self.i += 1
            return t.value
        # keywords usable as identifiers in non-reserved positions
        if t.kind == "kw" and t.value in ("DATE", "TIME", "TIMESTAMP", "VALUES",
                                          "FILTER", "ROW", "ANALYZE", "SESSION",
                                          "TABLES", "COLUMNS", "FIRST", "LAST",
                                          "ALL", "SET", "SHOW", "IF",
                                          # txn words are only consumed at
                                          # statement starts — non-reserved
                                          "START", "TRANSACTION", "COMMIT",
                                          "ROLLBACK", "READ", "ONLY", "WRITE"):
            self.i += 1
            return t.value.lower()
        self.err("expected identifier")

    def dotted_name(self) -> str:
        """catalog.schema.table target names in DDL/DML (reference:
        qualifiedName in SqlBase.g4 used by CREATE/DROP/INSERT/DELETE)."""
        name = self.ident()
        while self.accept_op("."):
            name += "." + self.ident()
        return name

    # ---- statements -------------------------------------------------
    def parse_statement(self) -> ast.Statement:
        stmt = self._statement()
        self.accept_op(";")
        if self.peek().kind != "eof":
            self.err("unexpected trailing input")
        return stmt

    def _statement(self) -> ast.Statement:
        if self.accept_kw("EXPLAIN"):
            analyze = False
            etype = "LOGICAL"
            if self.accept_op("("):  # (TYPE ..., FORMAT ...) options
                while True:
                    if self._accept_word("TYPE"):
                        etype = str(self.ident()).upper()
                        if etype not in ("LOGICAL", "DISTRIBUTED",
                                         "VALIDATE", "IO"):
                            self.err(f"unknown EXPLAIN type {etype}")
                    elif self._accept_word("FORMAT"):
                        self.ident()  # TEXT only; accepted and ignored
                    else:
                        self.err("expected TYPE or FORMAT")
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            if self.accept_kw("ANALYZE"):
                analyze = True
            return ast.Explain(self._statement(), analyze=analyze,
                               type_=etype)
        if self.accept_kw("SHOW"):
            if self.accept_kw("TABLES"):
                return ast.ShowTables()
            if self.accept_kw("COLUMNS"):
                self.expect_kw("FROM")
                return ast.ShowColumns(self.dotted_name())
            if self.accept_kw("CREATE"):
                self.expect_kw("TABLE")
                return ast.ShowCreateTable(self.dotted_name())
            if self._accept_word("FUNCTIONS"):
                return ast.ShowFunctions()
            if self.accept_kw("SESSION"):
                return ast.ShowSession()
            if self._accept_word("CATALOGS"):
                return ast.ShowCatalogs()
            if self._accept_word("SCHEMAS"):
                return ast.ShowSchemas()
            if self._accept_word("STATS"):
                self.expect_kw("FOR")
                return ast.ShowStats(self.dotted_name())
            if self._accept_word("MATERIALIZED"):
                if not self._accept_word("VIEWS"):
                    self.err("expected VIEWS after SHOW MATERIALIZED")
                return ast.ShowMaterializedViews()
            self.err("expected TABLES, COLUMNS, CREATE TABLE, FUNCTIONS, "
                     "SESSION, CATALOGS, SCHEMAS, STATS or MATERIALIZED "
                     "VIEWS")
        if self._accept_word("DESCRIBE") or self.accept_kw("DESC"):
            # DESCRIBE INPUT/OUTPUT <prepared>; DESCRIBE t == SHOW
            # COLUMNS FROM t (reference: SqlBase.g4)
            if self._accept_word("INPUT"):
                return ast.DescribeInput(self.ident())
            if self._accept_word("OUTPUT"):
                return ast.DescribeOutput(self.ident())
            return ast.ShowColumns(self.dotted_name())
        if self.accept_kw("CREATE"):
            or_replace = False
            if self.accept_kw("OR"):
                # CREATE OR REPLACE TABLE ... AS: atomic refresh cut-over
                if not self._accept_word("REPLACE"):
                    self.err("expected REPLACE after CREATE OR")
                or_replace = True
            if self._accept_word("MATERIALIZED"):
                if not self._accept_word("VIEW"):
                    self.err("expected VIEW after CREATE MATERIALIZED")
                if_not_exists = False
                if self.accept_kw("IF"):
                    self.expect_kw("NOT")
                    self.expect_kw("EXISTS")
                    if_not_exists = True
                name = self.dotted_name()
                props = self._with_properties()
                self.expect_kw("AS")
                return ast.CreateMaterializedView(
                    name, self.parse_query(), properties=props,
                    if_not_exists=if_not_exists, or_replace=or_replace)
            self.expect_kw("TABLE")
            if_not_exists = False
            if self.accept_kw("IF"):
                self.expect_kw("NOT")
                self.expect_kw("EXISTS")
                if_not_exists = True
            name = self.dotted_name()
            if self.accept_op("("):  # CREATE TABLE t (col type, ...)
                if or_replace:
                    self.err("CREATE OR REPLACE requires AS <query>")
                columns = []
                while True:
                    cname = self.ident()
                    columns.append((cname, self._type_name()))
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                props = self._with_properties()
                return ast.CreateTable(name, columns, props, if_not_exists)
            props = self._with_properties()
            self.expect_kw("AS")
            stmt = ast.CreateTableAs(name, self.parse_query())
            stmt.properties = props  # connector choice rides WITH(...)
            stmt.if_not_exists = if_not_exists
            stmt.or_replace = or_replace
            return stmt
        if self.accept_kw("DROP"):
            if self._accept_word("MATERIALIZED"):
                if not self._accept_word("VIEW"):
                    self.err("expected VIEW after DROP MATERIALIZED")
                if_exists = False
                if self.accept_kw("IF"):
                    self.expect_kw("EXISTS")
                    if_exists = True
                return ast.DropMaterializedView(self.dotted_name(),
                                                if_exists)
            self.expect_kw("TABLE")
            if_exists = False
            if self.accept_kw("IF"):
                self.expect_kw("EXISTS")
                if_exists = True
            return ast.DropTable(self.dotted_name(), if_exists)
        if self.accept_kw("DELETE"):
            self.expect_kw("FROM")
            name = self.dotted_name()
            where = None
            if self.accept_kw("WHERE"):
                where = self.expr()
            return ast.Delete(name, where)
        if self.accept_kw("PREPARE"):
            name = self.ident()
            self.expect_kw("FROM")
            # the remaining raw text IS the statement (parameters are `?`
            # placeholders, substituted at EXECUTE — reference:
            # QueryPreparer.prepare)
            start = self.peek().pos
            self.i = len(self.toks) - 1  # consume everything
            return ast.Prepare(name, self.text[start:].rstrip(" ;"))
        if self.accept_kw("EXECUTE"):
            name = self.ident()
            params = []
            if self.accept_kw("USING"):
                params.append(self.expr())
                while self.accept_op(","):
                    params.append(self.expr())
            return ast.Execute(name, params)
        if self.accept_kw("DEALLOCATE"):
            self.accept_kw("PREPARE")
            return ast.Deallocate(self.ident())
        if self.accept_kw("START"):
            self.expect_kw("TRANSACTION")
            read_only = False
            if self.accept_kw("READ"):
                if self.accept_kw("ONLY"):
                    read_only = True
                else:
                    self.expect_kw("WRITE")
            return ast.TransactionStatement("START", read_only)
        if self.accept_kw("COMMIT"):
            return ast.TransactionStatement("COMMIT")
        if self.accept_kw("ROLLBACK"):
            return ast.TransactionStatement("ROLLBACK")
        if self.accept_kw("INSERT"):
            self.expect_kw("INTO")
            name = self.dotted_name()
            cols = None
            if self.accept_op("("):
                cols = [self.ident()]
                while self.accept_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
            return ast.InsertInto(name, cols, self.parse_query())
        if self.at_kw("SET") and self.peek(1).kind == "kw" and self.peek(1).value == "SESSION":
            self.next(), self.next()
            name = self.dotted_name()
            self.expect_op("=")
            v = self.next()
            value = v.value
            if v.kind == "number":
                value = float(v.value) if "." in v.value else int(v.value)
            elif v.kind == "kw" and v.value in ("TRUE", "FALSE"):
                value = v.value == "TRUE"
            return ast.SetSession(name, value)
        if self._accept_word("REFRESH"):
            if not self._accept_word("MATERIALIZED"):
                self.err("expected MATERIALIZED VIEW after REFRESH")
            if not self._accept_word("VIEW"):
                self.err("expected VIEW after REFRESH MATERIALIZED")
            return ast.RefreshMaterializedView(self.dotted_name())
        return ast.QueryStatement(self.parse_query())

    # ---- queries ----------------------------------------------------
    def parse_query(self) -> ast.Query:
        ctes = []
        if self.accept_kw("WITH"):
            while True:
                name = self.ident()
                col_aliases = None
                if self.accept_op("("):
                    col_aliases = [self.ident()]
                    while self.accept_op(","):
                        col_aliases.append(self.ident())
                    self.expect_op(")")
                self.expect_kw("AS")
                self.expect_op("(")
                q = self.parse_query()
                self.expect_op(")")
                ctes.append((name, q, col_aliases))
                if not self.accept_op(","):
                    break
        body = self._set_op_body()
        order_by, limit = self._order_limit()
        return ast.Query(body, order_by, limit, ctes)

    def _set_op_body(self):
        left = self._query_term()
        while self.at_kw("UNION", "INTERSECT", "EXCEPT"):
            op = self.next().value
            all_ = self.accept_kw("ALL")
            self.accept_kw("DISTINCT")
            right = self._query_term()
            left = ast.SetOp(op, all_, left, right)
        return left

    def _query_term(self):
        if self.accept_op("("):
            body = self._set_op_body()
            self.expect_op(")")
            return body
        if self.at_kw("VALUES"):
            self.next()
            rows = [self._values_row()]
            while self.accept_op(","):
                rows.append(self._values_row())
            return ast.QuerySpec(
                [ast.SelectItem(ast.Star())], from_=ast.ValuesRelation(rows)
            )
        return self._query_spec()

    def _order_limit(self):
        order_by = []
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            order_by.append(self._sort_item())
            while self.accept_op(","):
                order_by.append(self._sort_item())
        limit = None
        if self.accept_kw("LIMIT"):
            t = self.next()
            if t.kind == "number":
                limit = int(t.value)
            elif t.kind == "kw" and t.value == "ALL":
                limit = None
            else:
                self.err("expected LIMIT count")
        return order_by, limit

    def _sort_item(self) -> ast.SortItem:
        e = self.expr()
        asc = True
        if self.accept_kw("ASC"):
            asc = True
        elif self.accept_kw("DESC"):
            asc = False
        nulls_first = None
        if self.accept_kw("NULLS"):
            if self.accept_kw("FIRST"):
                nulls_first = True
            else:
                self.expect_kw("LAST")
                nulls_first = False
        return ast.SortItem(e, asc, nulls_first)

    def _query_spec(self) -> ast.QuerySpec:
        self.expect_kw("SELECT")
        distinct = False
        if self.accept_kw("DISTINCT"):
            distinct = True
        else:
            self.accept_kw("ALL")
        items = [self._select_item()]
        while self.accept_op(","):
            items.append(self._select_item())
        from_ = None
        if self.accept_kw("FROM"):
            from_ = self._relation()
            while self.accept_op(","):
                right = self._relation()
                from_ = ast.Join("CROSS", from_, right)
        where = self.expr() if self.accept_kw("WHERE") else None
        group_by = []
        grouping_sets = None
        if self.accept_kw("GROUP"):
            self.expect_kw("BY")
            if (self.peek().kind == "ident"
                    and self.peek().value == "grouping"
                    and self.peek(1).kind == "ident"
                    and self.peek(1).value == "sets"):
                # contextual keywords: GROUPING/SETS stay usable as
                # identifiers (non-reserved in the reference grammar)
                self.next(), self.next()
                grouping_sets = self._grouping_sets()
            elif self.at_kw("ROLLUP", "CUBE"):
                kind = self.next().value
                exprs = self._paren_expr_list()
                if kind == "ROLLUP":
                    grouping_sets = [exprs[:k] for k in
                                     range(len(exprs), -1, -1)]
                else:  # CUBE: all subsets, preserving expr order
                    grouping_sets = []
                    for mask in range((1 << len(exprs)) - 1, -1, -1):
                        grouping_sets.append(
                            [e for i, e in enumerate(exprs)
                             if mask & (1 << i)])
                group_by = list(exprs)
            else:
                group_by.append(self.expr())
                while self.accept_op(","):
                    group_by.append(self.expr())
        having = self.expr() if self.accept_kw("HAVING") else None
        spec = ast.QuerySpec(items, distinct, from_, where, group_by, having)
        spec.grouping_sets = grouping_sets
        return spec

    def _quantified(self, op: str, left):
        """`expr op ANY|SOME|ALL (subquery)` rewritten to the engine's
        existing subquery forms (reference: QuantifiedComparisonExpression,
        lowered by TransformQuantifiedComparisonApplyToLateralJoin):
          = ANY  -> IN          <> ALL -> NOT IN
          everything else -> a three-valued CASE over min/max/count
          scalar aggregates of the subquery (TRUE/FALSE/NULL exactly per
          SQL:2016 8.9, so NOT(...)/IS NULL stay correct)
        """
        t = self.peek()
        if not (t.kind == "ident" and t.value in ("any", "some")
                or t.kind == "kw" and t.value == "ALL"):
            return None
        # commit only on the full `ANY (SELECT ...` shape — any/some are
        # non-reserved and must keep working as column names on the RHS
        if not (self.peek(1).kind == "op" and self.peek(1).value == "("
                and self.peek(2).kind == "kw"
                and self.peek(2).value in ("SELECT", "WITH")):
            return None
        quant = "ANY" if t.value in ("any", "some") else "ALL"
        self.next()
        self.expect_op("(")
        q = self.parse_query()
        self.expect_op(")")
        # NB: the scalar rewrites below embed the subquery more than once
        # (so it plans/executes per reference) — correctness-first v1; the
        # reference lowers to one lateral join instead.

        def scalar_agg(agg, star=False):
            return ast.ScalarSubquery(ast.Query(body=ast.QuerySpec(
                select=[ast.SelectItem(ast.FunctionCall(
                    agg, [] if star else [ast.Identifier(("q_", "v_"))]))],
                from_=ast.SubqueryRelation(q, "q_", ["v_"]))))

        # Three-valued CASE lowering (SQL:2016 8.9): the result must be
        # NULL — not FALSE — when no definite answer exists, so it stays
        # correct under NOT / IS NULL.  Branch order encodes the decision
        # table; a NULL WHEN condition falls through to the next branch.
        null_lit = ast.Literal(None)
        true_l, false_l = ast.Literal(True), ast.Literal(False)
        left_null = ast.IsNull(left)
        empty = ast.BinaryOp("=", scalar_agg("count", star=True),
                             ast.Literal(0))
        # count(*) <> count(v_): NULL values present among the rows
        has_nulls = ast.BinaryOp("<>", scalar_agg("count", star=True),
                                 scalar_agg("count"))
        minv = lambda: scalar_agg("min")
        maxv = lambda: scalar_agg("max")

        def some_differs():  # TRUE iff a non-NULL element <> left
            return ast.BinaryOp(
                "OR", ast.BinaryOp("<>", minv(), left),
                ast.BinaryOp("<>", maxv(), left))

        if quant == "ANY":
            if op == "=":
                return ast.InSubquery(left, q, False)
            if op == "<>":
                return ast.Case(None, [(empty, false_l),
                                       (left_null, null_lit),
                                       (some_differs(), true_l),
                                       (has_nulls, null_lit)], false_l)
            # loosest bound: <: max, >: min (over non-NULL elements)
            ext = maxv() if op in ("<", "<=") else minv()
            return ast.Case(None, [(empty, false_l),
                                   (left_null, null_lit),
                                   (ast.BinaryOp(op, left, ext), true_l),
                                   (has_nulls, null_lit)], false_l)
        # ALL
        if op == "<>":
            return ast.InSubquery(left, q, True)  # <> ALL == NOT IN
        if op == "=":
            return ast.Case(None, [(empty, true_l),
                                   (left_null, null_lit),
                                   (some_differs(), false_l),
                                   (has_nulls, null_lit)], true_l)
        # tightest bound: <: min, >: max (over non-NULL elements)
        ext = minv() if op in ("<", "<=") else maxv()
        failed = ast.UnaryOp("NOT", ast.BinaryOp(op, left, ext))
        return ast.Case(None, [(empty, true_l),
                               (left_null, null_lit),
                               (failed, false_l),
                               (has_nulls, null_lit)], true_l)

    def _grouping_sets(self):
        """((a, b), (a), ()) — each set is a parenthesized expr list."""
        self.expect_op("(")
        sets = []
        while True:
            if self.at_op("("):
                sets.append(self._paren_expr_list())
            else:
                sets.append([self.expr()])  # bare expr = singleton set
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return sets

    def _paren_expr_list(self):
        self.expect_op("(")
        out = []
        if not self.at_op(")"):
            out.append(self.expr())
            while self.accept_op(","):
                out.append(self.expr())
        self.expect_op(")")
        return out

    def _select_item(self) -> ast.SelectItem:
        if self.at_op("*"):
            self.next()
            return ast.SelectItem(ast.Star())
        # t.* form
        if (self.peek().kind == "ident" and self.peek(1).kind == "op"
                and self.peek(1).value == "." and self.peek(2).kind == "op"
                and self.peek(2).value == "*"):
            q = self.next().value
            self.next(), self.next()
            return ast.SelectItem(ast.Star(qualifier=q))
        e = self.expr()
        alias = None
        if self.accept_kw("AS"):
            alias = self.ident()
        elif self.peek().kind == "ident" \
                and str(self.peek().value).upper() != "TABLESAMPLE":
            # TABLESAMPLE is a sample clause, never an implicit alias
            # (reference: SqlBase.g4 reserves it)
            alias = self.next().value
        return ast.SelectItem(e, alias)

    # ---- relations --------------------------------------------------
    def _relation(self) -> ast.Relation:
        rel = self._relation_primary()
        while True:
            if self.accept_kw("CROSS"):
                self.expect_kw("JOIN")
                right = self._relation_primary()
                rel = ast.Join("CROSS", rel, right)
                continue
            jt = None
            if self.at_kw("JOIN"):
                jt = "INNER"
            elif self.at_kw("INNER") and self.peek(1).value == "JOIN":
                self.next()
                jt = "INNER"
            elif self.at_kw("LEFT", "RIGHT", "FULL"):
                jt = self.peek().value
                nxt = self.peek(1)
                if nxt.kind == "kw" and nxt.value in ("JOIN", "OUTER"):
                    self.next()
                    self.accept_kw("OUTER")
                else:
                    jt = None
            if jt is None:
                break
            self.expect_kw("JOIN")
            right = self._relation_primary()
            if self.accept_kw("ON"):
                rel = ast.Join(jt, rel, right, on=self.expr())
            elif self.accept_kw("USING"):
                self.expect_op("(")
                cols = [self.ident()]
                while self.accept_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
                rel = ast.Join(jt, rel, right, using=cols)
            else:
                self.err("expected ON or USING")
        return rel

    def _relation_primary(self) -> ast.Relation:
        if self.accept_kw("UNNEST"):
            self.expect_op("(")
            exprs = [self.expr()]
            while self.accept_op(","):
                exprs.append(self.expr())
            self.expect_op(")")
            with_ord = False
            if self.accept_kw("WITH"):
                self.expect_kw("ORDINALITY")
                with_ord = True
            alias, col_aliases = self._alias()
            u = ast.Unnest(exprs, alias, with_ord)
            u.column_aliases = col_aliases
            return u
        if self.at_kw("VALUES"):
            self.next()
            rows = [self._values_row()]
            while self.accept_op(","):
                rows.append(self._values_row())
            alias, col_aliases = self._alias()
            return ast.ValuesRelation(rows, alias, col_aliases)
        if self.accept_op("("):
            # subquery or parenthesized join
            if self.at_kw("SELECT", "WITH") or (self.at_op("(")):
                q = self.parse_query()
                self.expect_op(")")
                alias, col_aliases = self._alias()
                return ast.SubqueryRelation(q, alias, col_aliases)
            rel = self._relation()
            self.expect_op(")")
            alias, col_aliases = self._alias()
            if alias is not None and hasattr(rel, "alias"):
                rel.alias = alias
                if col_aliases and hasattr(rel, "column_aliases"):
                    rel.column_aliases = col_aliases
            return rel
        name = self.dotted_name()  # catalog.schema.table — full dotted name
        alias, col_aliases = self._alias()
        t = ast.Table(name, alias, col_aliases)
        if self._accept_word("TABLESAMPLE"):
            # reference: SqlBase.g4 sampledRelation — alias precedes the
            # sample clause; accept one after too when none came before
            method = str(self.ident()).upper()
            if method not in ("BERNOULLI", "SYSTEM"):
                self.err("expected BERNOULLI or SYSTEM")
            self.expect_op("(")
            tok = self.next()
            if tok.kind != "number":
                self.err("expected a sample percentage")
            self.expect_op(")")
            t.sample = (method, float(tok.value))
            if t.alias is None:
                t.alias, t.column_aliases = self._alias()
        return t

    def _accept_word(self, word: str) -> bool:
        """Match a non-reserved word (parsed as an identifier) without
        growing the KEYWORDS set — SHOW FUNCTIONS must not reserve
        'functions' as a column name."""
        tok = self.peek()
        if tok.kind == "ident" and str(tok.value).upper() == word:
            self.next()
            return True
        return False


    def _values_row(self):
        if self.accept_op("("):
            row = [self.expr()]
            while self.accept_op(","):
                row.append(self.expr())
            self.expect_op(")")
            return row
        return [self.expr()]

    def _alias(self):
        alias = None
        col_aliases = None
        if self.accept_kw("AS"):
            alias = self.ident()
        elif self.peek().kind == "ident" \
                and str(self.peek().value).upper() != "TABLESAMPLE":
            # TABLESAMPLE is a sample clause, never an implicit alias
            # (reference: SqlBase.g4 reserves it)
            alias = self.next().value
        if alias and self.at_op("(") and self._looks_like_column_aliases():
            self.next()
            col_aliases = [self.ident()]
            while self.accept_op(","):
                col_aliases.append(self.ident())
            self.expect_op(")")
        return alias, col_aliases

    def _looks_like_column_aliases(self) -> bool:
        # after alias: "(ident [, ident]* )" not followed by an operator
        j = self.i + 1
        if self.toks[j].kind != "ident":
            return False
        while self.toks[j].kind == "ident":
            j += 1
            if self.toks[j].kind == "op" and self.toks[j].value == ",":
                j += 1
                continue
            break
        return self.toks[j].kind == "op" and self.toks[j].value == ")"

    # ---- expressions (Pratt) ----------------------------------------
    def expr(self) -> ast.Expr:
        return self._or_expr()

    def _or_expr(self):
        left = self._and_expr()
        while self.accept_kw("OR"):
            left = ast.BinaryOp("OR", left, self._and_expr())
        return left

    def _and_expr(self):
        left = self._not_expr()
        while self.accept_kw("AND"):
            left = ast.BinaryOp("AND", left, self._not_expr())
        return left

    def _not_expr(self):
        if self.accept_kw("NOT"):
            return ast.UnaryOp("NOT", self._not_expr())
        return self._predicate()

    def _at_time_zone(self, left):
        # postfix `AT TIME ZONE 'zone'` (AT/ZONE are unreserved idents,
        # TIME lexes as a keyword) -> at_timezone(expr, zone)
        while (self.peek().kind == "ident"
               and str(self.peek().value).upper() == "AT"
               and self.peek(1).kind == "kw" and self.peek(1).value == "TIME"
               and self.peek(2).kind == "ident"
               and str(self.peek(2).value).upper() == "ZONE"):
            self.i += 3
            # the zone operand is a primary (string literal / column),
            # NOT an additive — `x AT TIME ZONE 'z' + INTERVAL ...`
            # must apply + to the converted value (reference grammar:
            # timeZoneSpecifier is a string or interval literal)
            zone = self._unary()
            left = ast.FunctionCall("at_timezone", [left, zone])
        return left

    def _predicate(self):
        left = self._additive()
        while True:
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.next().value
                if op == "!=":
                    op = "<>"
                q = self._quantified(op, left)
                if q is not None:
                    left = q
                    continue
                right = self._additive()
                left = ast.BinaryOp(op, left, right)
                continue
            negated = False
            save = self.i
            if self.accept_kw("NOT"):
                negated = True
            if self.accept_kw("BETWEEN"):
                low = self._additive()
                self.expect_kw("AND")
                high = self._additive()
                left = ast.Between(left, low, high, negated)
                continue
            if self.accept_kw("IN"):
                self.expect_op("(")
                if self.at_kw("SELECT", "WITH"):
                    q = self.parse_query()
                    self.expect_op(")")
                    left = ast.InSubquery(left, q, negated)
                else:
                    items = [self.expr()]
                    while self.accept_op(","):
                        items.append(self.expr())
                    self.expect_op(")")
                    left = ast.InList(left, items, negated)
                continue
            if self.accept_kw("LIKE"):
                pattern = self._additive()
                escape = None
                if self.accept_kw("ESCAPE"):
                    escape = self._additive()
                left = ast.Like(left, pattern, escape, negated)
                continue
            if negated:
                self.i = save
                break
            if self.accept_kw("IS"):
                neg = self.accept_kw("NOT")
                if self.accept_kw("DISTINCT"):
                    # IS [NOT] DISTINCT FROM: null-safe comparison
                    # (reference: SqlBase.g4 DISTINCT FROM predicate)
                    self.expect_kw("FROM")
                    rhs = self._additive()
                    call = ast.FunctionCall("is_distinct_from",
                                            [left, rhs])
                    left = ast.UnaryOp("NOT", call) if neg else call
                    continue
                self.expect_kw("NULL")
                left = ast.IsNull(left, neg)
                continue
            break
        return left

    def _additive(self):
        left = self._multiplicative()
        while True:
            if self.at_op("+", "-"):
                op = self.next().value
                left = ast.BinaryOp(op, left, self._multiplicative())
            elif self.at_op("||"):
                self.next()
                left = ast.BinaryOp("||", left, self._multiplicative())
            else:
                return left

    def _multiplicative(self):
        left = self._at_time_zone(self._unary())
        while self.at_op("*", "/", "%"):
            op = self.next().value
            left = ast.BinaryOp(op, left, self._at_time_zone(self._unary()))
        return left

    def _unary(self):
        if self.accept_op("-"):
            return ast.UnaryOp("-", self._unary())
        if self.accept_op("+"):
            return self._unary()
        e = self._primary()
        # postfix: subscript a[i] / m['k'], and .field on non-identifier
        # bases (identifier dot-chains are consumed by _primary itself)
        while True:
            if self.at_op("["):
                self.next()
                idx = self.expr()
                self.expect_op("]")
                e = ast.FunctionCall("subscript", [e, idx])
                continue
            if self.at_op(".") and self.peek(1).kind == "ident" \
                    and not isinstance(e, ast.Identifier):
                self.next()
                e = ast.FunctionCall("$dereference",
                                     [e, ast.Literal(self.ident())])
                continue
            break
        return e

    def _primary(self) -> ast.Expr:
        t = self.peek()
        if t.kind == "op" and t.value == "?":
            # prepared-statement parameter (reference: SqlBase.g4
            # parameter); positions follow textual order, which is the
            # EXECUTE ... USING binding order
            self.next()
            p = ast.Parameter(self._n_params)
            self._n_params += 1
            return p
        if t.kind == "number":
            self.next()
            if "." in t.value or "e" in t.value.lower():
                return ast.Literal(float(t.value))
            return ast.Literal(int(t.value))
        if t.kind == "string":
            self.next()
            return ast.Literal(t.value)
        if self.accept_kw("TRUE"):
            return ast.Literal(True)
        if self.accept_kw("FALSE"):
            return ast.Literal(False)
        if self.accept_kw("NULL"):
            return ast.Literal(None)
        if self.at_kw("DATE") and self.peek(1).kind == "string":
            self.next()
            return ast.Literal(self.next().value, type_hint="date")
        if self.at_kw("TIMESTAMP") and self.peek(1).kind == "string":
            self.next()
            return ast.Literal(self.next().value, type_hint="timestamp")
        if self.at_kw("TIME") and self.peek(1).kind == "string":
            self.next()
            return ast.Literal(self.next().value, type_hint="time")
        if (self.peek().kind == "ident"
                and str(self.peek().value).upper() == "DECIMAL"
                and self.peek(1).kind == "string"):
            self.next()  # DECIMAL is not reserved, so it lexes as ident
            return ast.Literal(self.next().value, type_hint="decimal")
        if self.accept_kw("INTERVAL"):
            sign = -1 if self.accept_op("-") else 1
            v = self.next()
            if v.kind not in ("string", "number"):
                self.err("expected interval value")
            unit_tok = self.next()
            unit = (unit_tok.value or "").upper().rstrip("S") if unit_tok.kind in ("ident", "kw") else None
            if unit not in ("DAY", "MONTH", "YEAR", "HOUR", "MINUTE", "SECOND", "WEEK"):
                self.err(f"unsupported interval unit {unit}")
            return ast.IntervalLiteral(sign * int(str(v.value).strip("'")), unit)
        if self.accept_kw("CASE"):
            operand = None
            if not self.at_kw("WHEN"):
                operand = self.expr()
            whens = []
            while self.accept_kw("WHEN"):
                c = self.expr()
                self.expect_kw("THEN")
                whens.append((c, self.expr()))
            default = self.expr() if self.accept_kw("ELSE") else None
            self.expect_kw("END")
            return ast.Case(operand, whens, default)
        if self.at_kw("CAST", "TRY_CAST"):
            safe = self.next().value == "TRY_CAST"
            self.expect_op("(")
            v = self.expr()
            self.expect_kw("AS")
            type_name = self._type_name()
            self.expect_op(")")
            return ast.Cast(v, type_name, safe)
        if self.accept_kw("EXTRACT"):
            self.expect_op("(")
            fld = self.next().value
            self.expect_kw("FROM")
            v = self.expr()
            self.expect_op(")")
            return ast.Extract(str(fld).upper(), v)
        if self.accept_kw("SUBSTRING"):
            self.expect_op("(")
            v = self.expr()
            if self.accept_kw("FROM"):
                start = self.expr()
                length = self.expr() if self.accept_kw("FOR") else None
            else:
                self.expect_op(",")
                start = self.expr()
                length = self.expr() if self.accept_op(",") else None
            self.expect_op(")")
            args = [v, start] + ([length] if length is not None else [])
            return ast.FunctionCall("substring", args)
        if self.accept_kw("EXISTS"):
            self.expect_op("(")
            q = self.parse_query()
            self.expect_op(")")
            return ast.Exists(q)
        if self.accept_op("("):
            if self.at_kw("SELECT", "WITH"):
                q = self.parse_query()
                self.expect_op(")")
                return ast.ScalarSubquery(q)
            e = self.expr()
            self.expect_op(")")
            return e
        if t.kind == "ident" and t.value == "array" \
                and self.peek(1).kind == "op" and self.peek(1).value == "[":
            self.next(), self.next()
            elems = []
            if not self.at_op("]"):
                elems.append(self.expr())
                while self.accept_op(","):
                    elems.append(self.expr())
            self.expect_op("]")
            return ast.FunctionCall("array_constructor", elems)
        if t.kind == "ident" or (t.kind == "kw" and t.value in (
                "DATE", "TIME", "TIMESTAMP", "FILTER", "ROW", "FIRST", "LAST",
                "SET", "VALUES", "IF", "START", "READ", "ONLY", "WRITE",
                "COMMIT", "ROLLBACK", "TRANSACTION")):
            name = self.ident()
            if self.at_op("("):
                return self._function_call(name)
            if name in ("current_date", "current_timestamp", "current_time",
                        "localtime", "localtimestamp", "current_user") \
                    and not self.at_op("."):
                # SQL-spec niladic functions take no parentheses
                return ast.FunctionCall(name, [])
            parts = [name]
            while self.at_op(".") and self.peek(1).kind in ("ident", "kw"):
                self.next()
                parts.append(self.ident())
            return ast.Identifier(tuple(parts))
        self.err("expected expression")

    def _with_properties(self) -> dict:
        """WITH (k = v, ...) table properties (reference: SqlBase.g4
        `properties`; e.g. WITH (connector = 'localfile')).  ARRAY['a',
        'b'] values parse to python lists — the write-layout properties
        (bucketed_by/sorted_by/partitioned_by) use them, matching the
        hive connector's table-property shapes."""
        props: dict = {}
        if not (self.at_kw("WITH") and self.peek(1).kind == "op"
                and self.peek(1).value == "("):
            return props
        self.next()
        self.expect_op("(")
        while True:
            key = self.ident()
            self.expect_op("=")
            if (self.peek().kind in ("ident", "kw")
                    and str(self.peek().value).upper() == "ARRAY"
                    and self.peek(1).kind == "op"
                    and self.peek(1).value == "["):
                self.next()
                self.expect_op("[")
                items = []
                if not self.accept_op("]"):
                    while True:
                        items.append(self.next().value)
                        if not self.accept_op(","):
                            break
                    self.expect_op("]")
                props[key] = items
                if not self.accept_op(","):
                    break
                continue
            t = self.next()
            if t.kind == "number":
                props[key] = float(t.value) if "." in t.value else int(t.value)
            elif t.kind == "kw" and t.value in ("TRUE", "FALSE"):
                props[key] = t.value == "TRUE"
            else:
                props[key] = t.value
            if not self.accept_op(","):
                break
        self.expect_op(")")
        return props

    def _type_name(self) -> str:
        name = self.next()
        if name.kind not in ("ident", "kw"):
            self.err("expected type name")
        tn = str(name.value)
        if tn.upper() == "DOUBLE" and self.peek().kind == "ident" and self.peek().value == "precision":
            self.next()
        if tn.upper() in ("TIMESTAMP", "TIME") and self.at_kw("WITH"):
            # TIMESTAMP/TIME WITH TIME ZONE (TIME is a kw, ZONE an ident)
            save = self.i
            self.next()
            if self.accept_kw("TIME") and self.peek().kind == "ident" \
                    and str(self.peek().value).upper() == "ZONE":
                self.next()
                tn += " WITH TIME ZONE"
            else:
                self.i = save
        if self.accept_op("("):
            # capture the balanced-paren argument list verbatim so nested
            # types (MAP(VARCHAR, ARRAY(BIGINT)), ROW(x BIGINT, ...)) pass
            # through to types.parse_type
            depth = 1
            parts = []
            while True:
                t = self.next()
                if t.kind == "eof":
                    self.err("unterminated type arguments")
                if t.kind == "op" and t.value == "(":
                    depth += 1
                elif t.kind == "op" and t.value == ")":
                    depth -= 1
                    if depth == 0:
                        break
                parts.append(str(t.value))
            tn += "(" + " ".join(parts) + ")"
        return tn

    def _function_call(self, name: str) -> ast.Expr:
        self.expect_op("(")
        distinct = False
        args: List[ast.Expr] = []
        if self.at_op("*"):
            self.next()
            args = []  # count(*)
        elif not self.at_op(")"):
            if self.accept_kw("DISTINCT"):
                distinct = True
            else:
                self.accept_kw("ALL")
            args.append(self._lambda_or_expr())
            while self.accept_op(","):
                args.append(self._lambda_or_expr())
        self.expect_op(")")
        if self.at_kw("WITH") and self.peek(1).kind == "ident" \
                and str(self.peek(1).value).upper() == "ERROR":
            # COUNT(x) WITH ERROR / SUM(x) WITH ERROR: the approximate
            # forms over a seeded 1-in-8 hash sample (value-hash-gated,
            # so the estimate is partition-independent).  Lookahead is
            # two tokens — a bare WITH after an aggregate otherwise
            # stays untouched (CTE WITH never appears here).
            self.next()
            self.next()
            if name.lower() not in ("count", "sum") or not args or distinct:
                self.err("WITH ERROR is only supported on "
                         "COUNT(x) and SUM(x)")
            name = "approx_" + name.lower()
        filt = None
        if self.at_kw("FILTER"):
            self.next()
            self.expect_op("(")
            self.expect_kw("WHERE")
            filt = self.expr()
            self.expect_op(")")
        nt = None
        if self._accept_word("IGNORE"):
            self.expect_kw("NULLS")
            nt = "IGNORE"
        elif self._accept_word("RESPECT"):
            self.expect_kw("NULLS")
            nt = "RESPECT"
        window = None
        if self.accept_kw("OVER"):
            window = self._window_spec()
        return ast.FunctionCall(name.lower(), args, distinct, filt, window,
                                nt)

    def _lambda_or_expr(self) -> ast.Expr:
        """Function argument: `x -> body`, `(x, y) -> body`, or an expression
        (reference: SqlBase.g4 `lambda` primaryExpression alternative)."""
        t = self.peek()
        if t.kind == "ident" and self.peek(1).kind == "op" \
                and self.peek(1).value == "->":
            name = self.next().value
            self.next()  # ->
            return ast.Lambda([name], self.expr())
        if t.kind == "op" and t.value == "(":
            # lookahead for  ( ident [, ident]* ) ->
            j = self.i + 1
            params: List[str] = []
            while True:
                tk = self.toks[j]
                if tk.kind != "ident":
                    params = []
                    break
                params.append(tk.value)
                j += 1
                tk = self.toks[j]
                if tk.kind == "op" and tk.value == ",":
                    j += 1
                    continue
                if tk.kind == "op" and tk.value == ")":
                    j += 1
                    break
                params = []
                break
            if params and self.toks[j].kind == "op" \
                    and self.toks[j].value == "->":
                self.i = j + 1
                return ast.Lambda(params, self.expr())
        return self.expr()

    def _window_spec(self) -> ast.WindowSpec:
        self.expect_op("(")
        partition_by: List[ast.Expr] = []
        order_by: List[ast.SortItem] = []
        frame = None
        if self.accept_kw("PARTITION"):
            self.expect_kw("BY")
            partition_by.append(self.expr())
            while self.accept_op(","):
                partition_by.append(self.expr())
        if self.accept_kw("ORDER"):
            self.expect_kw("BY")
            order_by.append(self._sort_item())
            while self.accept_op(","):
                order_by.append(self._sort_item())
        if self.at_kw("ROWS", "RANGE"):
            ftype = self.next().value
            if self.accept_kw("BETWEEN"):
                start = self._frame_bound()
                self.expect_kw("AND")
                end = self._frame_bound()
            else:
                start = self._frame_bound()
                end = "CURRENT ROW"
            frame = (ftype, start, end)
        self.expect_op(")")
        return ast.WindowSpec(partition_by, order_by, frame)

    def _frame_bound(self) -> str:
        if self.accept_kw("UNBOUNDED"):
            if self.accept_kw("PRECEDING"):
                return "UNBOUNDED PRECEDING"
            self.expect_kw("FOLLOWING")
            return "UNBOUNDED FOLLOWING"
        if self.accept_kw("CURRENT"):
            self.expect_kw("ROW")
            return "CURRENT ROW"
        t = self.next()
        if t.kind != "number":
            self.err("expected frame bound")
        if self.accept_kw("PRECEDING"):
            return f"{t.value} PRECEDING"
        self.expect_kw("FOLLOWING")
        return f"{t.value} FOLLOWING"


def parse(text: str) -> ast.Statement:
    return Parser(text).parse_statement()


def parse_query(text: str) -> ast.Query:
    stmt = parse(text)
    if not isinstance(stmt, ast.QueryStatement):
        raise ParseError("expected a query")
    return stmt.query
