"""Static type/null-propagation checker for expr/ir.py trees.

The analyzer emits FULLY TYPED RowExpressions and the compiler
(expr/compile.py) trusts those types — it never re-infers. A planner
pass that rewrites expressions (predicate pushdown, constant folding,
history-driven rewrites) and gets a type wrong therefore fails INSIDE
a kernel trace, attributed to nothing. This pass names the ill-typed
node at PLAN time instead: planner/validation.py runs it over every
node expression as a PlanChecker rule (`expr-type` violations).

Deliberately LENIENT: it flags only definite contract breaches —
boolean forms over non-boolean operands, comparisons between types
with no common supertype, arithmetic over non-numeric operands,
mis-typed special forms. Anything the compiler's coercion machinery
legitimately absorbs (UNKNOWN nulls, integer widening, decimal
rescaling, date/interval arithmetic) passes silently, because a false
positive here would reject a working plan."""

from __future__ import annotations

from typing import List, Optional

from presto_tpu_torch.expr.ir import (
    ArrayValue, Call, Literal, MapValue, RowExpression, RowValue,
    SpecialForm, walk,
)
from presto_tpu_torch.types import (
    BOOLEAN, UNKNOWN, Type, common_super_type,
)

_COMPARISONS = frozenset({
    "equal", "not_equal", "less_than", "greater_than",
    "less_than_or_equal", "greater_than_or_equal",
})
_ARITHMETIC = frozenset({
    "add", "subtract", "multiply", "divide", "modulus",
})
#: interval/date arithmetic the compiler handles specially — exempt
#: from the numeric-operand rule
_TEMPORAL = frozenset({
    "date", "timestamp", "interval_day", "interval_year",
})


def _boolish(t: Type) -> bool:
    return t == BOOLEAN or t == UNKNOWN


def _comparable(a: Type, b: Type) -> bool:
    if UNKNOWN in (a, b):
        return True
    return common_super_type(a, b) is not None


def _numericish(t: Type) -> bool:
    return t.is_numeric or t == UNKNOWN or t.name in _TEMPORAL


def _node_errors(e: RowExpression) -> List[str]:
    errs: List[str] = []

    def bad(msg: str) -> None:
        errs.append(msg)

    if isinstance(e, SpecialForm):
        form, args = e.form, e.args
        if form in ("and", "or", "not"):
            for a in args:
                if not _boolish(a.type):
                    bad(f"{form.upper()} operand has type {a.type!r}"
                        " (boolean context requires boolean)")
            if e.type != BOOLEAN:
                bad(f"{form.upper()} produces {e.type!r}, must be "
                    "boolean")
        elif form in ("is_null", "is_not_null"):
            if e.type != BOOLEAN:
                bad(f"{form} produces {e.type!r}, must be boolean")
        elif form == "if":
            if args and not _boolish(args[0].type):
                bad(f"IF condition has type {args[0].type!r} "
                    "(boolean required)")
            for branch in args[1:]:
                if branch.type != UNKNOWN and e.type != UNKNOWN \
                        and common_super_type(branch.type,
                                              e.type) is None:
                    bad(f"IF branch type {branch.type!r} cannot "
                        f"coerce to result type {e.type!r}")
        elif form == "between":
            if len(args) == 3:
                v, lo, hi = args
                for side in (lo, hi):
                    if not _comparable(v.type, side.type):
                        bad(f"BETWEEN bound type {side.type!r} not "
                            f"comparable with value {v.type!r}")
            if e.type != BOOLEAN:
                bad(f"BETWEEN produces {e.type!r}, must be boolean")
        elif form == "in":
            if args:
                v = args[0]
                for cand in args[1:]:
                    if not _comparable(v.type, cand.type):
                        bad(f"IN list element type {cand.type!r} not "
                            f"comparable with value {v.type!r}")
            if e.type != BOOLEAN:
                bad(f"IN produces {e.type!r}, must be boolean")
        elif form == "coalesce":
            for a in args:
                if a.type != UNKNOWN and e.type != UNKNOWN \
                        and common_super_type(a.type, e.type) is None:
                    bad(f"COALESCE argument type {a.type!r} cannot "
                        f"coerce to result type {e.type!r}")
    elif isinstance(e, Call):
        name, args = e.name, e.args
        if name in _COMPARISONS:
            if len(args) == 2 \
                    and not _comparable(args[0].type, args[1].type):
                bad(f"comparison {name!r} between incomparable types "
                    f"{args[0].type!r} and {args[1].type!r}")
            if e.type != BOOLEAN:
                bad(f"comparison {name!r} produces {e.type!r}, must "
                    "be boolean")
        elif name in _ARITHMETIC:
            for a in args:
                if not _numericish(a.type) \
                        and not (a.type.is_string
                                 and name == "add"):
                    bad(f"arithmetic {name!r} over non-numeric "
                        f"operand type {a.type!r}")
            if len(args) == 2 and args[0].type.is_numeric \
                    and args[1].type.is_numeric \
                    and not e.type.is_numeric \
                    and e.type != UNKNOWN:
                bad(f"numeric {name!r} produces non-numeric "
                    f"{e.type!r}")
        elif name == "negate":
            if args and not _numericish(args[0].type):
                bad(f"negate over non-numeric type {args[0].type!r}")
    return errs


def check_expression(e: Optional[RowExpression],
                     limit: int = 8) -> List[str]:
    """Type errors anywhere in the expression DAG (each shared node
    visited once; at most `limit` messages — one broken subtree tends
    to cascade)."""
    if e is None:
        return []
    out: List[str] = []
    try:
        for node in walk(e):
            if isinstance(node, (ArrayValue, MapValue, RowValue)):
                continue  # analysis-time value forms: lowered before
                #           the compiler, their own consumers check
            out.extend(_node_errors(node))
            if len(out) >= limit:
                break
    except Exception as exc:  # noqa: BLE001 — a malformed tree IS
        #                       the finding, not a checker crash
        out.append(f"expression tree is malformed: "
                   f"{type(exc).__name__}: {exc}")
    return out[:limit]
