"""Recursive-descent SQL parser (reference: presto-parser SqlBase.g4
statement/queryTerm/booleanExpression/valueExpression productions).

Statement coverage grows with the engine; currently: SELECT queries with
CTEs, joins, subqueries (IN/EXISTS/scalar/derived tables), set
operations, VALUES, EXPLAIN [ANALYZE], SHOW *, SET SESSION,
CREATE TABLE AS, INSERT INTO, DROP TABLE.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from presto_tpu_torch.parser import tree as T
from presto_tpu_torch.parser.lexer import Token, tokenize


class ParseError(Exception):
    pass


def parse_statement(sql: str) -> T.Node:
    p = _Parser(tokenize(sql))
    stmt = p.statement()
    p.expect_op(";", optional=True)
    p.expect_eof()
    return stmt


class _Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0
        #: `?` placeholders seen so far (prepared statements)
        self.param_count = 0

    # -- token helpers -----------------------------------------------------

    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def advance(self) -> Token:
        t = self.cur
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        return self.cur.kind == "keyword" and self.cur.value in kws

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.i += 1
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise ParseError(f"expected {kw.upper()} but found "
                             f"{self.cur.value!r} at {self.cur.pos}")

    def at_op(self, op: str) -> bool:
        return self.cur.kind == "op" and self.cur.value == op

    def accept_op(self, op: str) -> bool:
        if self.at_op(op):
            self.i += 1
            return True
        return False

    def expect_op(self, op: str, optional: bool = False) -> None:
        if not self.accept_op(op) and not optional:
            raise ParseError(f"expected {op!r} but found "
                             f"{self.cur.value!r} at {self.cur.pos}")

    def expect_eof(self) -> None:
        if self.cur.kind != "eof":
            raise ParseError(f"unexpected trailing input "
                             f"{self.cur.value!r} at {self.cur.pos}")

    def ident(self) -> str:
        t = self.cur
        if t.kind in ("ident", "qident"):
            self.advance()
            return t.value
        # soft keywords usable as identifiers
        if t.kind == "keyword" and t.value in (
                "year", "month", "day", "hour", "minute", "second",
                "date", "time", "timestamp", "tables", "schemas",
                "catalogs", "columns", "row", "rows", "first", "last",
                "session", "values", "range", "current", "no",
                # prepared-statement words stay usable as identifiers
                # (the reference keeps them non-reserved)
                "prepare", "execute", "deallocate", "input", "output"):
            self.advance()
            return t.value
        raise ParseError(f"expected identifier, found {t.value!r} "
                         f"at {t.pos}")

    def qualified_name(self) -> Tuple[str, ...]:
        parts = [self.ident()]
        while self.accept_op("."):
            parts.append(self.ident())
        return tuple(parts)

    def _property_value(self):
        """Table-property literal: string/number/boolean or
        ARRAY['a', 'b'] (the shapes CREATE TABLE ... WITH uses)."""
        t = self.cur
        if t.kind == "string":
            self.advance()
            return t.value
        if self.accept_op("-"):
            v = self._property_value()
            if not isinstance(v, (int, float)):
                raise ParseError(f"cannot negate property value {v!r}")
            return -v
        if t.kind == "number":
            self.advance()
            return int(t.value) if t.value.isdigit() else float(t.value)
        if self.accept_kw("true"):
            return True
        if self.accept_kw("false"):
            return False
        if self.accept_kw("array") or (
                t.kind == "ident" and t.value.lower() == "array"
                and self.advance()):
            self.expect_op("[")
            vals = []
            if not self.at_op("]"):
                vals.append(self._property_value())
                while self.accept_op(","):
                    vals.append(self._property_value())
            self.expect_op("]")
            return vals
        raise ParseError(f"expected a property literal, found "
                         f"{t.value!r} at {t.pos}")

    # -- statements --------------------------------------------------------

    def statement(self) -> T.Node:
        if self.accept_kw("explain"):
            analyze = self.accept_kw("analyze")
            return T.Explain(self.statement(), analyze)
        if self.accept_kw("show"):
            return self._show()
        if self.accept_kw("set"):
            self.expect_kw("session")
            name = ".".join(self.qualified_name())
            self.expect_op("=")
            return T.SetSession(name, self.expr())
        if self.accept_kw("reset"):
            self.expect_kw("session")
            return T.ResetSession(".".join(self.qualified_name()))
        if self.accept_kw("create"):
            self.expect_kw("table")
            if_not = False
            if self.accept_kw("if"):
                self.expect_kw("not")
                self.expect_kw("exists")
                if_not = True
            name = self.qualified_name()
            props = None
            if self.accept_kw("with"):
                # WITH (format = 'orc', partitioned_by = ARRAY['c'])
                self.expect_op("(")
                props = {}
                while True:
                    key = self.ident().lower()
                    self.expect_op("=")
                    props[key] = self._property_value()
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            self.expect_kw("as")
            return T.CreateTableAs(name, self.query(), if_not, props)
        if self.accept_kw("insert"):
            self.expect_kw("into")
            name = self.qualified_name()
            columns = None
            if self.at_op("(") and self._peek_is_column_list():
                self.expect_op("(")
                columns = [self.ident()]
                while self.accept_op(","):
                    columns.append(self.ident())
                self.expect_op(")")
            return T.InsertInto(name, self.query(), columns)
        if self.accept_kw("drop"):
            self.expect_kw("table")
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return T.DropTable(self.qualified_name(), if_exists)
        if self.accept_kw("describe"):
            # DESCRIBE INPUT/OUTPUT <prepared>; plain DESCRIBE <table>
            # stays the SHOW COLUMNS shorthand. Lookahead: a table
            # NAMED input/output (non-reserved) is still describable —
            # only `DESCRIBE INPUT <name>` takes the prepared form
            nxt = self.toks[self.i + 1]
            if self.at_kw("input", "output") \
                    and nxt.kind in ("ident", "qident", "keyword"):
                if self.accept_kw("input"):
                    return T.DescribeInput(self.ident())
                self.expect_kw("output")
                return T.DescribeOutput(self.ident())
            return T.ShowColumns(self.qualified_name())
        if self.accept_kw("prepare"):
            name = self.ident()
            self.expect_kw("from")
            return T.Prepare(name, self.statement())
        if self.accept_kw("execute"):
            name = self.ident()
            using: list = []
            if self.accept_kw("using"):
                using.append(self.expr())
                while self.accept_op(","):
                    using.append(self.expr())
            return T.ExecutePrepared(name, using)
        if self.accept_kw("deallocate"):
            self.expect_kw("prepare")
            return T.Deallocate(self.ident())
        return self.query()

    def _peek_is_column_list(self) -> bool:
        # distinguish INSERT INTO t (a, b) SELECT ... from
        # INSERT INTO t (SELECT ...)
        j = self.i + 1
        return not (self.toks[j].kind == "keyword"
                    and self.toks[j].value in ("select", "with", "values"))

    def _show(self) -> T.Node:
        if self.accept_kw("tables"):
            schema = None
            if self.accept_kw("from") or self.accept_kw("in"):
                schema = self.qualified_name()
            return T.ShowTables(schema)
        if self.accept_kw("schemas"):
            catalog = None
            if self.accept_kw("from") or self.accept_kw("in"):
                catalog = self.ident()
            return T.ShowSchemas(catalog)
        if self.accept_kw("catalogs"):
            return T.ShowCatalogs()
        if self.accept_kw("columns"):
            self.expect_kw("from")
            return T.ShowColumns(self.qualified_name())
        if self.accept_kw("session"):
            return T.ShowSession()
        if self.accept_kw("functions"):
            return T.ShowFunctions()
        raise ParseError(f"unsupported SHOW at {self.cur.pos}")

    # -- queries -----------------------------------------------------------

    def query(self) -> T.Query:
        ctes: List[T.WithQuery] = []
        if self.accept_kw("with"):
            while True:
                name = self.ident()
                col_names = None
                if self.accept_op("("):
                    col_names = [self.ident()]
                    while self.accept_op(","):
                        col_names.append(self.ident())
                    self.expect_op(")")
                self.expect_kw("as")
                self.expect_op("(")
                q = self.query()
                self.expect_op(")")
                ctes.append(T.WithQuery(name, q, col_names))
                if not self.accept_op(","):
                    break
        body = self.query_term()
        order_by: List[T.SortItem] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by = self.sort_items()
        limit = None
        offset = None
        if self.accept_kw("offset"):
            offset = int(self.advance().value)
            self.accept_kw("rows") or self.accept_kw("row")
        if self.accept_kw("limit"):
            t = self.advance()
            if t.value == "?":
                raise ParseError(
                    "parameterized LIMIT (`LIMIT ?`) is not "
                    "supported yet — inline the value")
            limit = None if t.value == "all" else int(t.value)
        elif self.accept_kw("fetch"):
            self.accept_kw("first") or self.accept_kw("next")
            limit = int(self.advance().value)
            self.accept_kw("rows") or self.accept_kw("row")
            self.expect_kw("only")
        return T.Query(body, order_by, limit, ctes, offset)

    def query_term(self) -> T.Node:
        # INTERSECT binds tighter than UNION/EXCEPT (SqlBase.g4
        # queryTerm precedence)
        left = self.intersect_term()
        while self.at_kw("union", "except"):
            op = self.advance().value
            distinct = not self.accept_kw("all")
            self.accept_kw("distinct")
            right = self.intersect_term()
            left = T.SetOperation(op, distinct, left, right)
        return left

    def intersect_term(self) -> T.Node:
        left = self.query_primary()
        while self.at_kw("intersect"):
            self.advance()
            distinct = not self.accept_kw("all")
            self.accept_kw("distinct")
            right = self.query_primary()
            left = T.SetOperation("intersect", distinct, left, right)
        return left

    def query_primary(self) -> T.Node:
        if self.accept_kw("select"):
            return self.query_spec()
        if self.accept_kw("values"):
            rows = []
            while True:
                self.expect_op("(")
                row = [self.expr()]
                while self.accept_op(","):
                    row.append(self.expr())
                self.expect_op(")")
                rows.append(row)
                if not self.accept_op(","):
                    break
            return T.ValuesRelation(rows)
        if self.accept_op("("):
            q = self.query()
            self.expect_op(")")
            return q
        raise ParseError(f"expected query, found {self.cur.value!r} "
                         f"at {self.cur.pos}")

    def query_spec(self) -> T.QuerySpec:
        distinct = False
        if self.accept_kw("distinct"):
            distinct = True
        else:
            self.accept_kw("all")
        select: List[T.Node] = []
        while True:
            if self.at_op("*"):
                self.advance()
                select.append(T.Star())
            elif (star_len := self._qualified_star_length()) > 0:
                parts = []
                for _ in range(star_len):
                    parts.append(self.ident())
                    self.expect_op(".")
                self.expect_op("*")
                select.append(T.Star(tuple(parts)))
            else:
                e = self.expr()
                alias = None
                if self.accept_kw("as"):
                    alias = self.ident()
                elif self.cur.kind in ("ident", "qident"):
                    alias = self.ident()
                select.append(T.SelectItem(e, alias))
            if not self.accept_op(","):
                break
        from_ = None
        if self.accept_kw("from"):
            from_ = self.table_refs()
        where = self.expr() if self.accept_kw("where") else None
        group_by: List[T.Node] = []
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by.append(self.grouping_element())
            while self.accept_op(","):
                group_by.append(self.grouping_element())
        having = self.expr() if self.accept_kw("having") else None
        return T.QuerySpec(select, distinct, from_, where, group_by,
                           having)

    def _qualified_star_length(self) -> int:
        """Raw lookahead for `ident (. ident)* . *`; returns the number
        of leading identifiers, or 0 if this is not a qualified star."""
        j = self.i
        count = 0
        while self.toks[j].kind in ("ident", "qident"):
            if not (self.toks[j + 1].kind == "op"
                    and self.toks[j + 1].value == "."):
                return 0
            count += 1
            nxt = self.toks[j + 2]
            if nxt.kind == "op" and nxt.value == "*":
                return count
            j += 2
        return 0

    def sort_items(self) -> List[T.SortItem]:
        items = [self.sort_item()]
        while self.accept_op(","):
            items.append(self.sort_item())
        return items

    def sort_item(self) -> T.SortItem:
        e = self.expr()
        desc = False
        if self.accept_kw("asc"):
            pass
        elif self.accept_kw("desc"):
            desc = True
        nulls_first = None
        if self.accept_kw("nulls"):
            if self.accept_kw("first"):
                nulls_first = True
            else:
                self.expect_kw("last")
                nulls_first = False
        return T.SortItem(e, desc, nulls_first)

    # -- relations ---------------------------------------------------------

    def _at_ident(self, name: str, offset: int = 0) -> bool:
        t = self.toks[min(self.i + offset, len(self.toks) - 1)]
        return t.kind == "ident" and t.value.lower() == name

    def grouping_element(self) -> T.Node:
        """GROUP BY element: plain expression, ROLLUP(...), CUBE(...),
        or GROUPING SETS ((...), ...) (reference: SqlBase.g4
        groupingElement). rollup/cube/grouping are contextual — plain
        identifiers elsewhere (grouping(...) stays a function call)."""
        for kind in ("rollup", "cube"):
            if self._at_ident(kind) and self.toks[self.i + 1].kind \
                    == "op" and self.toks[self.i + 1].value == "(":
                self.advance()
                self.expect_op("(")
                items = [self.expr()]
                while self.accept_op(","):
                    items.append(self.expr())
                self.expect_op(")")
                return T.GroupingSetsSpec(kind, items)
        if self._at_ident("grouping") and self._at_ident("sets", 1):
            self.advance()
            self.advance()
            self.expect_op("(")
            sets: List[List[T.Node]] = []
            while True:
                if self.accept_op("("):
                    s: List[T.Node] = []
                    if not self.accept_op(")"):
                        s.append(self.expr())
                        while self.accept_op(","):
                            s.append(self.expr())
                        self.expect_op(")")
                    sets.append(s)
                else:
                    sets.append([self.expr()])
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            return T.GroupingSetsSpec("sets", sets)
        return self.expr()

    def table_refs(self) -> T.Node:
        left = self.joined_table()
        while self.accept_op(","):
            right = self.joined_table()
            left = T.Join("cross", left, right)
        return left

    def joined_table(self) -> T.Node:
        left = self.aliased_relation()
        while True:
            if self.accept_kw("cross"):
                self.expect_kw("join")
                right = self.aliased_relation()
                left = T.Join("cross", left, right)
                continue
            jt = None
            if self.accept_kw("inner"):
                jt = "inner"
            elif self.accept_kw("left"):
                self.accept_kw("outer")
                jt = "left"
            elif self.accept_kw("right"):
                self.accept_kw("outer")
                jt = "right"
            elif self.accept_kw("full"):
                self.accept_kw("outer")
                jt = "full"
            elif self.at_kw("join"):
                jt = "inner"
            if jt is None:
                return left
            self.expect_kw("join")
            right = self.aliased_relation()
            if self.accept_kw("on"):
                left = T.Join(jt, left, right, on=self.expr())
            elif self.accept_kw("using"):
                self.expect_op("(")
                cols = [self.ident()]
                while self.accept_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
                left = T.Join(jt, left, right, using=cols)
            else:
                raise ParseError(f"JOIN requires ON/USING at "
                                 f"{self.cur.pos}")

    def aliased_relation(self) -> T.Node:
        rel = self.relation_primary()
        alias = None
        col_aliases = None
        if self.accept_kw("as"):
            alias = self.ident()
        elif self.cur.kind in ("ident", "qident"):
            alias = self.ident()
        if alias and self.at_op("(")\
                and isinstance(rel, (T.SubqueryRelation, T.Table,
                                     T.Unnest)):
            self.expect_op("(")
            col_aliases = [self.ident()]
            while self.accept_op(","):
                col_aliases.append(self.ident())
            self.expect_op(")")
        if alias:
            return T.AliasedRelation(rel, alias, col_aliases)
        return rel

    def relation_primary(self) -> T.Node:
        if self._at_ident("unnest") and self.toks[self.i + 1].kind \
                == "op" and self.toks[self.i + 1].value == "(":
            self.advance()
            self.expect_op("(")
            args = [self.expr()]
            while self.accept_op(","):
                args.append(self.expr())
            self.expect_op(")")
            ordinality = False
            if self.at_kw("with"):
                # WITH ORDINALITY (contextual second word)
                save = self.i
                self.advance()
                if self._at_ident("ordinality"):
                    self.advance()
                    ordinality = True
                else:
                    self.i = save
            return T.Unnest(args, ordinality)
        if self.accept_op("("):
            # subquery or parenthesized join
            if self.at_kw("select", "with", "values"):
                q = self.query()
                self.expect_op(")")
                return T.SubqueryRelation(q)
            rel = self.table_refs()
            self.expect_op(")")
            return rel
        if self.at_kw("values"):
            self.advance()
            rows = []
            while True:
                self.expect_op("(")
                row = [self.expr()]
                while self.accept_op(","):
                    row.append(self.expr())
                self.expect_op(")")
                rows.append(row)
                if not self.accept_op(","):
                    break
            return T.SubqueryRelation(T.Query(T.ValuesRelation(rows),
                                              [], None, []))
        return T.Table(self.qualified_name())

    # -- expressions (Pratt) ----------------------------------------------

    def expr(self) -> T.Node:
        lam = self._try_lambda()
        if lam is not None:
            return lam
        return self.or_expr()

    def _try_lambda(self) -> Optional[T.Node]:
        """`x -> body` or `(a, b) -> body`; lookahead-based so `(x)`
        as a parenthesized expression stays untouched."""
        t = self.cur
        if t.kind == "ident" \
                and self.toks[self.i + 1].kind == "op" \
                and self.toks[self.i + 1].value == "->":
            name = self.advance().value
            self.advance()  # ->
            return T.Lambda([name], self.expr())
        if t.kind == "op" and t.value == "(":
            j = self.i + 1
            params = []
            while True:
                if self.toks[j].kind != "ident":
                    return None
                params.append(self.toks[j].value)
                j += 1
                if self.toks[j].kind == "op" \
                        and self.toks[j].value == ",":
                    j += 1
                    continue
                break
            if not (self.toks[j].kind == "op"
                    and self.toks[j].value == ")"):
                return None
            if not (self.toks[j + 1].kind == "op"
                    and self.toks[j + 1].value == "->"):
                return None
            self.i = j + 2
            return T.Lambda(params, self.expr())
        return None

    def or_expr(self) -> T.Node:
        left = self.and_expr()
        while self.accept_kw("or"):
            left = T.BinaryOp("or", left, self.and_expr())
        return left

    def and_expr(self) -> T.Node:
        left = self.not_expr()
        while self.accept_kw("and"):
            left = T.BinaryOp("and", left, self.not_expr())
        return left

    def not_expr(self) -> T.Node:
        if self.accept_kw("not"):
            return T.UnaryOp("not", self.not_expr())
        return self.predicate()

    def predicate(self) -> T.Node:
        left = self.additive()
        while True:
            if self.cur.kind == "op" and self.cur.value in (
                    "=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.advance().value
                if op == "!=":
                    op = "<>"
                right = self.additive()
                left = T.BinaryOp(op, left, right)
                continue
            negated = False
            mark = self.i
            if self.accept_kw("not"):
                negated = True
            if self.accept_kw("between"):
                low = self.additive()
                self.expect_kw("and")
                high = self.additive()
                left = T.Between(left, low, high, negated)
                continue
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.at_kw("select", "with"):
                    q = self.query()
                    self.expect_op(")")
                    left = T.InSubquery(left, q, negated)
                else:
                    items = [self.expr()]
                    while self.accept_op(","):
                        items.append(self.expr())
                    self.expect_op(")")
                    left = T.InList(left, items, negated)
                continue
            if self.accept_kw("like"):
                pattern = self.additive()
                escape = None
                if self.accept_kw("escape"):
                    escape = self.additive()
                left = T.Like(left, pattern, escape, negated)
                continue
            if negated:
                self.i = mark
                break
            if self.accept_kw("is"):
                neg = self.accept_kw("not")
                if self.accept_kw("null"):
                    left = T.IsNull(left, neg)
                    continue
                if self.accept_kw("distinct"):
                    self.expect_kw("from")
                    right = self.additive()
                    eq = T.BinaryOp("is_distinct", left, right)
                    left = T.UnaryOp("not", eq) if neg else eq
                    continue
                raise ParseError(f"expected NULL after IS at "
                                 f"{self.cur.pos}")
            break
        return left

    def additive(self) -> T.Node:
        left = self.multiplicative()
        while True:
            if self.cur.kind == "op" and self.cur.value in ("+", "-", "||"):
                op = self.advance().value
                left = T.BinaryOp(op, left, self.multiplicative())
            else:
                return left

    def multiplicative(self) -> T.Node:
        left = self.unary()
        while True:
            if self.cur.kind == "op" and self.cur.value in ("*", "/", "%"):
                op = self.advance().value
                left = T.BinaryOp(op, left, self.unary())
            else:
                return left

    def unary(self) -> T.Node:
        if self.accept_op("-"):
            return T.UnaryOp("-", self.unary())
        if self.accept_op("+"):
            return self.unary()
        e = self.primary()
        # postfix subscript: expr[index] (array element access)
        while self.cur.kind == "op" and self.cur.value == "[":
            self.advance()
            idx = self.expr()
            self.expect_op("]")
            e = T.Subscript(e, idx)
        return e

    def primary(self) -> T.Node:
        t = self.cur
        # ROW(...) constructor: "row" is a reserved word (frame
        # grammar), so the generic ident-"(" call path misses it
        if t.kind == "keyword" and t.value == "row" \
                and self.toks[self.i + 1].kind == "op" \
                and self.toks[self.i + 1].value == "(":
            self.advance()
            self.expect_op("(")
            args = [self.expr()]
            while self.accept_op(","):
                args.append(self.expr())
            self.expect_op(")")
            return T.FunctionCall("row", args)
        if t.kind == "ident" and t.value.lower() == "array" \
                and self.toks[self.i + 1].kind == "op" \
                and self.toks[self.i + 1].value == "[":
            self.advance()
            self.expect_op("[")
            items: List[T.Node] = []
            if not self.accept_op("]"):
                items.append(self.expr())
                while self.accept_op(","):
                    items.append(self.expr())
                self.expect_op("]")
            return T.ArrayConstructor(items)
        if t.kind == "op" and t.value == "?":
            self.advance()
            self.param_count += 1
            return T.Parameter(self.param_count - 1)
        if t.kind == "number":
            self.advance()
            return T.NumberLit(t.value)
        if t.kind == "string":
            self.advance()
            return T.StringLit(t.value)
        if self.at_kw("true"):
            self.advance()
            return T.BoolLit(True)
        if self.at_kw("false"):
            self.advance()
            return T.BoolLit(False)
        if self.at_kw("null"):
            self.advance()
            return T.NullLit()
        if self.at_kw("date") and self.toks[self.i + 1].kind == "string":
            self.advance()
            return T.DateLit(self.advance().value)
        if self.at_kw("timestamp") \
                and self.toks[self.i + 1].kind == "string":
            self.advance()
            return T.TimestampLit(self.advance().value)
        if self.at_kw("interval"):
            self.advance()
            negative = self.accept_op("-")
            val = self.advance().value
            unit = self.advance().value
            return T.IntervalLit(val, unit.rstrip("s"), negative)
        if self.at_kw("case"):
            return self.case_expr()
        if self.at_kw("cast"):
            self.advance()
            self.expect_op("(")
            operand = self.expr()
            self.expect_kw("as")
            type_name = self.type_name()
            self.expect_op(")")
            return T.Cast(operand, type_name)
        if t.kind == "ident" and t.value == "try_cast":
            self.advance()
            self.expect_op("(")
            operand = self.expr()
            self.expect_kw("as")
            type_name = self.type_name()
            self.expect_op(")")
            return T.Cast(operand, type_name, safe=True)
        if self.at_kw("exists"):
            self.advance()
            self.expect_op("(")
            q = self.query()
            self.expect_op(")")
            return T.Exists(q)
        if self.at_kw("extract"):
            self.advance()
            self.expect_op("(")
            field = self.advance().value
            self.expect_kw("from")
            value = self.expr()
            self.expect_op(")")
            return T.Extract(field, value)
        if self.at_kw("substring"):
            self.advance()
            self.expect_op("(")
            value = self.expr()
            if self.accept_kw("from"):
                start = self.expr()
                length = self.expr() if self.accept_kw("for") else None
            else:
                self.expect_op(",")
                start = self.expr()
                length = self.expr() if self.accept_op(",") else None
            self.expect_op(")")
            args = [value, start] + ([length] if length else [])
            return T.FunctionCall("substr", args)
        if self.accept_op("("):
            if self.at_kw("select", "with"):
                q = self.query()
                self.expect_op(")")
                return T.ScalarSubquery(q)
            e = self.expr()
            self.expect_op(")")
            return e
        if t.kind in ("ident", "qident") or (
                t.kind == "keyword" and t.value in (
                    "year", "month", "day", "hour", "minute", "second",
                    "left", "right", "if", "quarter",
                    "prepare", "execute", "deallocate", "input",
                    "output")):
            name = self.ident() if t.kind != "keyword" else \
                self.advance().value
            if self.at_op("("):
                return self.function_call(name)
            parts = [name]
            while self.accept_op("."):
                if self.at_op("*"):
                    raise ParseError("qualified star outside SELECT")
                parts.append(self.ident())
            return T.Identifier(tuple(parts))
        raise ParseError(f"unexpected token {t.value!r} at {t.pos}")

    def case_expr(self) -> T.Node:
        self.expect_kw("case")
        operand = None
        if not self.at_kw("when"):
            operand = self.expr()
        whens = []
        while self.accept_kw("when"):
            cond = self.expr()
            self.expect_kw("then")
            whens.append((cond, self.expr()))
        default = self.expr() if self.accept_kw("else") else None
        self.expect_kw("end")
        return T.Case(operand, whens, default)

    def function_call(self, name: str) -> T.Node:
        self.expect_op("(")
        distinct = False
        is_star = False
        args: List[T.Node] = []
        if self.accept_op("*"):
            is_star = True
        elif not self.at_op(")"):
            distinct = self.accept_kw("distinct")
            args.append(self.expr())
            while self.accept_op(","):
                args.append(self.expr())
        self.expect_op(")")
        filter_ = None
        if self.cur.kind == "ident" and self.cur.value == "filter":
            self.advance()
            self.expect_op("(")
            self.expect_kw("where")
            filter_ = self.expr()
            self.expect_op(")")
        window = None
        if self.accept_kw("over"):
            window = self.window_spec()
        return T.FunctionCall(name, args, distinct, is_star, window,
                              filter_)

    def window_spec(self) -> T.WindowSpec:
        self.expect_op("(")
        partition: List[T.Node] = []
        order: List[T.SortItem] = []
        frame = None
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition.append(self.expr())
            while self.accept_op(","):
                partition.append(self.expr())
        if self.accept_kw("order"):
            self.expect_kw("by")
            order = self.sort_items()
        if self.at_kw("rows", "range"):
            ftype = self.advance().value
            if self.accept_kw("between"):
                start = self._frame_bound()
                self.expect_kw("and")
                end = self._frame_bound()
            else:
                start = self._frame_bound()
                end = "current row"
            frame = (ftype, start, end)
        self.expect_op(")")
        return T.WindowSpec(partition, order, frame)

    def _frame_bound(self) -> str:
        if self.accept_kw("unbounded"):
            if self.accept_kw("preceding"):
                return "unbounded preceding"
            self.expect_kw("following")
            return "unbounded following"
        if self.accept_kw("current"):
            self.expect_kw("row")
            return "current row"
        n = self.advance().value
        if self.accept_kw("preceding"):
            return f"{n} preceding"
        self.expect_kw("following")
        return f"{n} following"

    def type_name(self) -> str:
        base = self.advance().value
        if self.accept_op("("):
            params = [self.advance().value]
            while self.accept_op(","):
                params.append(self.advance().value)
            self.expect_op(")")
            return f"{base}({','.join(params)})"
        if base == "double" and self.cur.kind == "ident" \
                and self.cur.value == "precision":
            self.advance()
        return base
