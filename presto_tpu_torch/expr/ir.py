"""RowExpression IR (reference: presto-spi
`com.facebook.presto.spi.relation.RowExpression` and friends:
CallExpression, ConstantExpression, InputReferenceExpression,
SpecialFormExpression — SURVEY.md L2).

Expressions are produced by the analyzer fully typed; the compiler
(expr/compile.py) never infers types.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

from presto_tpu_torch.types import Type, BOOLEAN


class RowExpression:
    type: Type

    def children(self) -> Tuple["RowExpression", ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class Literal(RowExpression):
    """A constant. For string types, `value` is the python string; for
    decimals, the *unscaled* int; for dates, days since epoch."""
    value: Any  # None means typed NULL
    type: Type


@dataclasses.dataclass(frozen=True)
class InputRef(RowExpression):
    """Reference to a named input column of the operator's schema."""
    name: str
    type: Type


@dataclasses.dataclass(frozen=True)
class Call(RowExpression):
    """A resolved scalar function call: `name` is the registry key."""
    name: str
    args: Tuple[RowExpression, ...]
    type: Type

    def children(self):
        return self.args


#: comparison call name under operand swap: a OP b == b FLIP[OP] a —
#: the ONE copy every rewrite that normalizes literal-first
#: comparisons uses
FLIP_COMPARISON = {
    "less_than": "greater_than",
    "greater_than": "less_than",
    "less_than_or_equal": "greater_than_or_equal",
    "greater_than_or_equal": "less_than_or_equal",
    "equal": "equal",
    "not_equal": "not_equal",
}


@dataclasses.dataclass(frozen=True)
class ArrayValue(RowExpression):
    """ANALYSIS-TIME-ONLY fixed-width array value: element expressions
    plus an optional dynamic length expression (None = the static
    element count). Every consumer (subscript, cardinality, contains,
    UNNEST, ...) lowers it to scalar IR during analysis — it never
    reaches the expression compiler, which keeps the device
    representation fully static-shape (the TPU answer to ragged
    arrays; reference: common/type/ArrayType's offsets+child block)."""
    elements: tuple
    length: Optional["RowExpression"]
    type: "Type"
    #: provenance for consumer rewrites, e.g. ("split", s, delim) lets
    #: array_join lower to one host-side string function
    origin: Optional[tuple] = None


@dataclasses.dataclass(frozen=True)
class MapValue(RowExpression):
    """ANALYSIS-TIME-ONLY fixed-width map value: parallel key/value
    expression lists plus an optional dynamic entry count (None = the
    static list length). Consumers (subscript, element_at,
    cardinality, map_keys/values, lambdas) lower it to scalar IR —
    like ArrayValue, it never reaches the compiler (reference:
    common/type/MapType's key/value blocks, static-shaped)."""
    keys: tuple
    values: tuple
    length: Optional["RowExpression"]
    type: "Type"


@dataclasses.dataclass(frozen=True)
class RowValue(RowExpression):
    """ANALYSIS-TIME-ONLY row value: named field expressions consumed
    by field access (reference: common/type/RowType)."""
    fields: tuple  # ((name|None, RowExpression), ...)
    type: "Type"


@dataclasses.dataclass(frozen=True)
class SpecialForm(RowExpression):
    """Non-function forms with their own evaluation/null rules
    (reference: spi SpecialFormExpression.Form): AND OR NOT IF COALESCE
    IN BETWEEN IS_NULL CAST SWITCH (searched case as nested IFs)."""
    form: str
    args: Tuple[RowExpression, ...]
    type: Type

    def children(self):
        return self.args


def lit(value: Any, typ: Type) -> Literal:
    return Literal(value, typ)


def ref(name: str, typ: Type) -> InputRef:
    return InputRef(name, typ)


def call(name: str, typ: Type, *args: RowExpression) -> Call:
    return Call(name, tuple(args), typ)


def and_(*args: RowExpression) -> SpecialForm:
    return SpecialForm("and", tuple(args), BOOLEAN)


def or_(*args: RowExpression) -> SpecialForm:
    return SpecialForm("or", tuple(args), BOOLEAN)


def not_(arg: RowExpression) -> SpecialForm:
    return SpecialForm("not", (arg,), BOOLEAN)


def fingerprint(expr: RowExpression, _memo: Optional[dict] = None
                ) -> bytes:
    """Memoized 128-bit structural digest of an expression DAG, for
    kernel-cache KEYS. The frozen dataclasses' own __hash__/__eq__
    recurse by value, which is exponential on self-similar DAGs (a
    lambda reduce() references its accumulator twice per step — a
    26-wide reduce would hash 2^26 paths); the digest visits each
    node once. Collisions are cryptographically negligible and a
    collision's worst case is reusing a compiled kernel for the wrong
    expression within one process."""
    import hashlib
    if _memo is None:
        _memo = {}
    hit = _memo.get(id(expr))
    if hit is not None:
        return hit
    h = hashlib.blake2b(digest_size=16)
    h.update(type(expr).__name__.encode())
    if isinstance(expr, Literal):
        h.update(repr((expr.value, expr.type)).encode())
    elif isinstance(expr, InputRef):
        h.update(repr((expr.name, expr.type)).encode())
    elif isinstance(expr, Call):
        h.update(repr((expr.name, expr.type)).encode())
    elif isinstance(expr, SpecialForm):
        h.update(repr((expr.form, expr.type)).encode())
    else:
        h.update(repr(expr.type).encode())
    for c in expr.children():
        h.update(fingerprint(c, _memo))
    d = h.digest()
    _memo[id(expr)] = d
    return d


def walk(expr: RowExpression, _seen: Optional[set] = None):
    """DFS over the expression DAG, each node yielded ONCE: analyzer
    output shares subtrees (lambda reduce() chains reference the
    accumulator twice per step), and an unshared walk would revisit
    them exponentially."""
    if _seen is None:
        _seen = set()
    if id(expr) in _seen:
        return
    _seen.add(id(expr))
    yield expr
    for c in expr.children():
        yield from walk(c, _seen)


def referenced_inputs(expr: RowExpression):
    """Names of input columns an expression reads (for column pruning)."""
    return {e.name for e in walk(expr) if isinstance(e, InputRef)}
