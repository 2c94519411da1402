"""Untyped AST (reference: presto-parser sql/tree/ — 171 node classes;
we build the subset the analyzer consumes, growing toward parity)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


class Node:
    pass


# -- expressions ------------------------------------------------------------

@dataclasses.dataclass
class NumberLit(Node):
    text: str


@dataclasses.dataclass
class StringLit(Node):
    value: str


@dataclasses.dataclass
class BoolLit(Node):
    value: bool


@dataclasses.dataclass
class NullLit(Node):
    pass


@dataclasses.dataclass
class DateLit(Node):
    text: str


@dataclasses.dataclass
class TimestampLit(Node):
    text: str


@dataclasses.dataclass
class IntervalLit(Node):
    value: str
    unit: str       # day | month | year | hour | minute | second
    negative: bool = False


@dataclasses.dataclass
class Identifier(Node):
    parts: Tuple[str, ...]  # a.b.c

    @property
    def name(self):
        return self.parts[-1]


@dataclasses.dataclass
class Star(Node):
    qualifier: Optional[Tuple[str, ...]] = None  # t.* qualifier


@dataclasses.dataclass
class BinaryOp(Node):
    op: str
    left: Node
    right: Node


@dataclasses.dataclass
class UnaryOp(Node):
    op: str   # - | + | not
    operand: Node


@dataclasses.dataclass
class FunctionCall(Node):
    name: str
    args: List[Node]
    distinct: bool = False
    is_star: bool = False         # count(*)
    window: Optional["WindowSpec"] = None
    filter: Optional[Node] = None


@dataclasses.dataclass
class WindowSpec(Node):
    partition_by: List[Node]
    order_by: List["SortItem"]
    frame: Optional[Tuple[str, str, str]] = None  # (type, start, end)


@dataclasses.dataclass
class Cast(Node):
    operand: Node
    type_name: str
    safe: bool = False  # try_cast


@dataclasses.dataclass
class Case(Node):
    operand: Optional[Node]           # simple CASE x WHEN ...
    whens: List[Tuple[Node, Node]]
    default: Optional[Node]


@dataclasses.dataclass
class Between(Node):
    value: Node
    low: Node
    high: Node
    negated: bool = False


@dataclasses.dataclass
class InList(Node):
    value: Node
    items: List[Node]
    negated: bool = False


@dataclasses.dataclass
class InSubquery(Node):
    value: Node
    query: "Query"
    negated: bool = False


@dataclasses.dataclass
class Exists(Node):
    query: "Query"
    negated: bool = False


@dataclasses.dataclass
class ScalarSubquery(Node):
    query: "Query"


@dataclasses.dataclass
class Like(Node):
    value: Node
    pattern: Node
    escape: Optional[Node] = None
    negated: bool = False


@dataclasses.dataclass
class IsNull(Node):
    value: Node
    negated: bool = False


@dataclasses.dataclass
class Extract(Node):
    field: str
    value: Node


# -- relations --------------------------------------------------------------

@dataclasses.dataclass
class Table(Node):
    name: Tuple[str, ...]


@dataclasses.dataclass
class AliasedRelation(Node):
    relation: Node
    alias: str
    column_aliases: Optional[List[str]] = None


@dataclasses.dataclass
class SubqueryRelation(Node):
    query: "Query"


@dataclasses.dataclass
class Join(Node):
    join_type: str  # inner | left | right | full | cross
    left: Node
    right: Node
    on: Optional[Node] = None
    using: Optional[List[str]] = None


@dataclasses.dataclass
class Unnest(Node):
    expressions: List[Node]
    with_ordinality: bool = False


# -- query structure --------------------------------------------------------

@dataclasses.dataclass
class SelectItem(Node):
    expr: Node
    alias: Optional[str] = None


@dataclasses.dataclass
class SortItem(Node):
    expr: Node
    descending: bool = False
    nulls_first: Optional[bool] = None  # None = default (last for asc)


@dataclasses.dataclass
class GroupingSetsSpec(Node):
    """One GROUP BY element of the grouping-sets family (reference:
    SqlBase.g4 groupingElement: rollup/cube/groupingSet).
    rollup/cube: items is List[Node]; sets: items is List[List[Node]]."""
    kind: str                    # rollup | cube | sets
    items: List


@dataclasses.dataclass
class QuerySpec(Node):
    select: List[Node]           # SelectItem | Star
    distinct: bool
    from_: Optional[Node]
    where: Optional[Node]
    group_by: List[Node]
    having: Optional[Node]


@dataclasses.dataclass
class Subscript(Node):
    base: "Node" = None
    index: "Node" = None


@dataclasses.dataclass
class Lambda(Node):
    """x -> body / (a, b) -> body — valid only as an argument of the
    lambda-taking array functions (reference: SqlBase.g4 lambda)."""
    params: List[str] = None
    body: "Node" = None


@dataclasses.dataclass
class ArrayConstructor(Node):
    items: List[Node]


@dataclasses.dataclass
class Unnest(Node):
    """UNNEST(expr, ...) [WITH ORDINALITY] as a FROM relation."""
    args: List[Node]
    ordinality: bool = False


@dataclasses.dataclass
class ValuesRelation(Node):
    rows: List[List[Node]]


@dataclasses.dataclass
class SetOperation(Node):
    op: str                      # union | intersect | except
    distinct: bool
    left: Node
    right: Node


@dataclasses.dataclass
class WithQuery(Node):
    name: str
    query: "Query"
    column_names: Optional[List[str]] = None


@dataclasses.dataclass
class Query(Node):
    body: Node                   # QuerySpec | SetOperation | ValuesRelation
    order_by: List[SortItem]
    limit: Optional[int]
    ctes: List[WithQuery]
    offset: Optional[int] = None


# -- statements -------------------------------------------------------------

@dataclasses.dataclass
class Explain(Node):
    statement: Node
    analyze: bool = False


@dataclasses.dataclass
class ShowTables(Node):
    schema: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass
class ShowSchemas(Node):
    catalog: Optional[str] = None


@dataclasses.dataclass
class ShowCatalogs(Node):
    pass


@dataclasses.dataclass
class ShowColumns(Node):
    table: Tuple[str, ...]


@dataclasses.dataclass
class ShowSession(Node):
    pass


@dataclasses.dataclass
class ShowFunctions(Node):
    pass


@dataclasses.dataclass
class SetSession(Node):
    name: str
    value: Node


@dataclasses.dataclass
class ResetSession(Node):
    name: str


@dataclasses.dataclass
class CreateTableAs(Node):
    name: Tuple[str, ...]
    query: Query
    if_not_exists: bool = False
    #: WITH (key = literal, ...) table properties (format,
    #: partitioned_by, ...), keys lowercased
    properties: Optional[Dict[str, object]] = None


@dataclasses.dataclass
class InsertInto(Node):
    name: Tuple[str, ...]
    query: Query
    columns: Optional[List[str]] = None


@dataclasses.dataclass
class DropTable(Node):
    name: Tuple[str, ...]
    if_exists: bool = False


@dataclasses.dataclass
class Parameter(Node):
    """A `?` placeholder in a prepared statement (reference:
    sql/tree/Parameter.java); EXECUTE ... USING substitutes the k-th
    argument expression for the k-th placeholder."""
    index: int


@dataclasses.dataclass
class Prepare(Node):
    name: str
    statement: Node      # the prepared statement's AST


@dataclasses.dataclass
class ExecutePrepared(Node):
    name: str
    using: List[Node]    # argument expression ASTs


@dataclasses.dataclass
class Deallocate(Node):
    name: str


@dataclasses.dataclass
class DescribeInput(Node):
    name: str


@dataclasses.dataclass
class DescribeOutput(Node):
    name: str
