"""Compile RowExpressions into functions over torch tensors (reference:
presto_tpu/expr/compile.py; sql/gen/PageFunctionCompiler.java:118).

A fully-typed RowExpression tree becomes a closure `env -> (data, mask)`
over `{name: (data, mask)}` column environments. Every closure runs
eagerly, one PyTorch op per node.

Null semantics: every value is a (data, mask) pair, mask True =
present. Functions default to "null if any input null"; AND/OR
implement Kleene three-valued logic; IF/CASE treat NULL conditions as
false.

Strings: VARCHAR data is dictionary codes. String predicates and
string functions are evaluated host-side over the (static) dictionary
at compile time, becoming lookup tables the device gathers from.

Lowering: beside its closure, every compiled expression carries
`lowering`, the (data, mask) pair of typed element-wise DAGs the
closure computes (`expr/lowering.py`, recorded by running the closure
once over symbolic columns). The fragment kernel generator
(`expr/codegen.py`) emits its Triton source from it. Every subtree the
compiler evaluates as a lookup table (LIKE, string IN lists and
comparisons, substr and the other string functions, dictionary remaps)
lowers as a clamped gather from that table. An expression whose closure
applies an operation with no lowering has `lowering` None and names the
function in `not_lowered`.

Where the port differs from the JAX reference:

* Constants (literals, lookup tables) are tensors made ONCE, at
  compile time, on the compile `device` — the device of the batches
  the expression will see. Each compiled expression therefore belongs
  to one device.
* jnp under x64 promotes a float32 array with a float64 0-d array to
  float64, and an int32 array with an int64 0-d array to int64; torch
  lets a 0-d tensor keep the dimensioned operand's dtype. Every binary
  op here promotes both operands explicitly (`_promote`) so results
  keep the reference's dtypes.
* Functions that no TPC-H query reaches raise "not yet ported"
  (`NOT_YET_PORTED`).
"""

from __future__ import annotations

import dataclasses
import re
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from presto_tpu_torch.expr import dates as D
from presto_tpu_torch.expr.lowering import (
    LNode, Unlowerable, lower_fn,
)
from presto_tpu_torch.expr.ir import (
    Call, InputRef, Literal, RowExpression, SpecialForm,
)
from presto_tpu_torch.schema import ColumnSchema
from presto_tpu_torch.types import (
    BIGINT, BOOLEAN, DATE, DOUBLE, INTERVAL_DAY, INTERVAL_YEAR,
    TIMESTAMP, Type, VARCHAR,
)

CVal = Tuple[torch.Tensor, torch.Tensor]  # (data, mask)
Env = Dict[str, CVal]

_CPU = torch.device("cpu")

#: scalar functions of the reference compiler that the port does not
#: compile yet (none is reached by TPC-H Q1-Q22); listed in ROADMAP.md
NOT_YET_PORTED = frozenset({
    "hash_code", "regexp_extract", "regexp_replace", "regexp_like",
    "json_extract", "json_extract_scalar", "json_array_length",
    "is_json_scalar", "url_extract_host", "url_extract_protocol",
    "url_extract_path", "url_extract_query", "url_extract_fragment",
    "bit_count",
})


@dataclasses.dataclass
class CompiledExpr:
    """fn(env) -> (data, mask); `dictionary` set when type is a string.
    `ir` is the source RowExpression. `lowering` is what `fn` computes
    as (data, mask) LNodes over its input columns (set by
    compile_expression); `not_lowered` names the function that has no
    lowering when `lowering` is None."""
    fn: Callable[[Env], CVal]
    type: Type
    dictionary: Optional[Tuple[str, ...]] = None
    ir: Optional[RowExpression] = None
    lowering: Optional[Tuple[LNode, LNode]] = None
    not_lowered: Optional[str] = None
    device: Optional[torch.device] = None


class ExpressionCompileError(Exception):
    pass


def compile_expression(expr: RowExpression,
                       schema: Dict[str, ColumnSchema],
                       device: torch.device = _CPU) -> CompiledExpr:
    """Compile `expr` for batches on `device`, with its lowering."""
    ce = _Compiler(schema, torch.device(device)).compile(expr)
    ce.ir = expr
    ce.device = torch.device(device)
    lower_expression(ce, {n: cs.type.torch_dtype
                          for n, cs in schema.items()})
    return ce


def compile_column(name: str, columns, device: torch.device = _CPU,
                   remap_to: Optional[Tuple[str, ...]] = None
                   ) -> CompiledExpr:
    """A column reference over `columns` [(name, type, dictionary)] —
    re-encoded onto the sorted superset dictionary `remap_to` (a
    lookup) when given and different from the column's own."""
    schema = {n: ColumnSchema(n, t, d) for n, t, d in columns}
    ref = InputRef(name, schema[name].type)
    comp = _Compiler(schema, torch.device(device))
    ce = comp.compile(ref)
    if remap_to is not None and ce.dictionary != remap_to:
        ce = comp._remap_to(ce, tuple(remap_to))
    ce = CompiledExpr(ce.fn, ce.type, ce.dictionary, ref,
                      device=torch.device(device))
    return lower_expression(ce, {n: cs.type.torch_dtype
                                 for n, cs in schema.items()})


def lower_expression(ce: CompiledExpr,
                     dtypes: Dict[str, torch.dtype]) -> CompiledExpr:
    """Set `ce.lowering` (or `ce.not_lowered`) from its closure, over
    input columns of the given data dtypes."""
    try:
        ce.lowering, ce.not_lowered = lower_fn(ce.fn, dtypes), None
    except Unlowerable as e:
        ce.lowering, ce.not_lowered = None, e.function or e.op
    return ce


# ---------------------------------------------------------------------------


def _promote(a: torch.Tensor, b: torch.Tensor):
    """Both operands in their common dtype, 0-d or not (jnp's
    strongly-typed promotion)."""
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t), b.to(t)


def _like_to_regex(pattern: str, escape: Optional[str] = None) -> str:
    out = []
    i = 0
    esc = escape
    while i < len(pattern):
        ch = pattern[i]
        if esc and ch == esc and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 2
            continue
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
        i += 1
    return "^" + "".join(out) + "$"


#: per-evaluation memo for SHARED IR subtrees (the analyzer emits
#: DAGs); thread-local because compiled closures may evaluate
#: concurrently across drivers
_EVAL_MEMO = threading.local()


def _share(fn, key: int, label: str):
    """Wrap a compiled closure so one EVALUATION of a shared node runs
    once per env. `label` (the node's function or form) names the
    innermost node of a closure that cannot be lowered."""
    def wrapped(env):
        memo = getattr(_EVAL_MEMO, "m", None)
        top = memo is None
        if top:
            memo = {}
            _EVAL_MEMO.m = memo
        try:
            k = (id(env), key)
            hit = memo.get(k)
            if hit is None:
                try:
                    hit = fn(env)
                except Unlowerable as e:
                    if e.function is None:
                        e.function = label
                    raise
                memo[k] = hit
            return hit
        finally:
            if top:
                _EVAL_MEMO.m = None
    return wrapped


class _Compiler:
    def __init__(self, schema: Dict[str, ColumnSchema],
                 device: torch.device):
        self.schema = schema
        self.device = device
        #: id(node) -> CompiledExpr (the root keeps children alive)
        self._memo: Dict[int, CompiledExpr] = {}

    # -- constants on the compile device -----------------------------------

    def const(self, value, dtype: torch.dtype) -> torch.Tensor:
        return torch.tensor(value, dtype=dtype, device=self.device)

    def table(self, values: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(values)) \
            .to(self.device)

    def scalar(self, value, typ: Type) -> CVal:
        if value is None:
            return (self.const(0, typ.torch_dtype),
                    self.const(False, torch.bool))
        return (self.const(value, typ.torch_dtype),
                self.const(True, torch.bool))

    # -- dispatch ------------------------------------------------------------

    def compile(self, expr: RowExpression) -> CompiledExpr:
        hit = self._memo.get(id(expr))
        if hit is not None:
            return hit
        if isinstance(expr, Literal):
            out = self._literal(expr)
        elif isinstance(expr, InputRef):
            out = self._input(expr)
        elif isinstance(expr, SpecialForm):
            out = self._special(expr)
        elif isinstance(expr, Call):
            out = self._call(expr)
        else:
            raise ExpressionCompileError(
                f"unknown expression node: {expr!r}")
        label = expr.name if isinstance(expr, Call) else \
            expr.form if isinstance(expr, SpecialForm) else \
            type(expr).__name__.lower()
        out = CompiledExpr(_share(out.fn, id(expr), label), out.type,
                           out.dictionary, out.ir)
        self._memo[id(expr)] = out
        return out

    # -- leaves ------------------------------------------------------------

    def _literal(self, e: Literal) -> CompiledExpr:
        if e.type.is_string:
            # a bare string literal materializes only through a parent
            # that consumes it: a 1-value dictionary
            if e.value is None:
                v = self.scalar(None, e.type)
                return CompiledExpr(lambda env: v, e.type, ())
            v = self.scalar(0, e.type)
            return CompiledExpr(lambda env: v, e.type, (e.value,))
        v = self.scalar(e.value, e.type)
        return CompiledExpr(lambda env: v, e.type)

    def _input(self, e: InputRef) -> CompiledExpr:
        cs = self.schema.get(e.name)
        if cs is None:
            raise ExpressionCompileError(f"unknown input column {e.name!r}")
        name = e.name
        return CompiledExpr(lambda env: env[name], cs.type, cs.dictionary)

    # -- special forms -----------------------------------------------------

    def _special(self, e: SpecialForm) -> CompiledExpr:
        form = e.form
        true = self.const(True, torch.bool)
        false = self.const(False, torch.bool)
        if form == "and":
            parts = [self.compile(a) for a in e.args]

            def f_and(env):
                d, m = true, true
                for p in parts:
                    pd, pm = p.fn(env)
                    # Kleene: false wins over null
                    d, m = d & pd, (m & pm) | (m & ~d) | (pm & ~pd)
                return d, m
            return CompiledExpr(f_and, BOOLEAN)
        if form == "or":
            parts = [self.compile(a) for a in e.args]

            def f_or(env):
                d, m = false, true
                for p in parts:
                    pd, pm = p.fn(env)
                    d, m = d | pd, (m & pm) | (m & d) | (pm & pd)
                return d, m
            return CompiledExpr(f_or, BOOLEAN)
        if form == "not":
            a = self.compile(e.args[0])

            def f_not(env):
                d, m = a.fn(env)
                return ~d, m
            return CompiledExpr(f_not, BOOLEAN)
        if form == "is_null":
            a = self.compile(e.args[0])
            return CompiledExpr(lambda env: (~a.fn(env)[1], true), BOOLEAN)
        if form == "is_not_null":
            a = self.compile(e.args[0])
            return CompiledExpr(lambda env: (a.fn(env)[1], true), BOOLEAN)
        if form == "if":
            cond = self.compile(e.args[0])
            then = self.compile(e.args[1])
            els = self.compile(e.args[2])
            dic = _merge_result_dicts(e.type, then, els)
            if dic is not None:
                then = self._remap_to(then, dic)
                els = self._remap_to(els, dic)

            def f_if(env):
                cd, cm = cond.fn(env)
                take_then = cd & cm  # NULL condition -> false branch
                td, tm = then.fn(env)
                ed, em = els.fn(env)
                td, ed = _promote(td, ed)
                return (torch.where(take_then, td, ed),
                        torch.where(take_then, tm, em))
            return CompiledExpr(f_if, e.type, dic)
        if form == "coalesce":
            parts = [self.compile(a) for a in e.args]
            dic = _merge_result_dicts(e.type, *parts)
            if dic is not None:
                parts = [self._remap_to(p, dic) for p in parts]

            def f_coalesce(env):
                d, m = parts[0].fn(env)
                for p in parts[1:]:
                    pd, pm = p.fn(env)
                    d, pd = _promote(d, pd)
                    d = torch.where(m, d, pd)
                    m = m | pm
                return d, m
            return CompiledExpr(f_coalesce, e.type, dic)
        if form == "between":
            lo = Call("greater_than_or_equal", (e.args[0], e.args[1]),
                      BOOLEAN)
            hi = Call("less_than_or_equal", (e.args[0], e.args[2]),
                      BOOLEAN)
            return self._special(SpecialForm("and", (lo, hi), BOOLEAN))
        if form == "in":
            return self._in(e)
        if form == "cast":
            return self._cast(e)
        raise ExpressionCompileError(f"unsupported special form {form!r}")

    def _lookup(self, col: CompiledExpr, values: np.ndarray, typ: Type,
                dictionary=None) -> CompiledExpr:
        tbl = self.table(values)
        fn = col.fn
        return CompiledExpr(lambda env: _apply_lookup(fn, tbl, env), typ,
                            dictionary)

    def _in(self, e: SpecialForm) -> CompiledExpr:
        value = self.compile(e.args[0])
        items = e.args[1:]
        if value.type.is_string:
            if not all(isinstance(i, Literal) for i in items):
                raise ExpressionCompileError(
                    "IN over varchar requires literal list")
            wanted = {i.value for i in items}
            table = np.array([v in wanted for v in value.dictionary or ()]
                             or [False], bool)
            return self._lookup(value, table, BOOLEAN)
        parts = [self.compile(i) for i in items]

        def f_in(env):
            vd, vm = value.fn(env)
            hit = torch.zeros_like(vd, dtype=torch.bool)
            any_null = torch.zeros_like(vd, dtype=torch.bool)
            for p in parts:
                pd, pm = p.fn(env)
                a, b = _promote(vd, pd)
                hit = hit | ((a == b) & pm)
                any_null = any_null | ~pm
            # x IN (...) is NULL if no hit and some item was NULL
            return hit, vm & (hit | ~any_null)
        return CompiledExpr(f_in, BOOLEAN)

    def _cast(self, e: SpecialForm) -> CompiledExpr:
        src = self.compile(e.args[0])
        to = e.type
        frm = src.type
        if frm == to:
            return src
        if to.is_string and frm.is_string:
            return CompiledExpr(src.fn, to, src.dictionary)
        if frm.is_string:
            # cast(varchar as T): parse the dictionary host-side
            dic = src.dictionary or ()
            if to == DATE:
                vals = np.array([D.parse_date_literal(v) for v in dic]
                                or [0], np.int32)
            elif to.is_decimal:
                from presto_tpu_torch.batch import _to_unscaled
                vals = np.array([_to_unscaled(float(v), to.scale)
                                 for v in dic] or [0], np.int64)
            elif to.is_numeric:
                vals = np.array([float(v) for v in dic] or [0],
                                to.np_dtype)
            else:
                raise ExpressionCompileError(f"cast varchar -> {to}")
            return self._lookup(src, vals, to)
        if to.is_string:
            raise ExpressionCompileError(
                f"cast {frm} -> varchar not yet supported")

        def f_cast(env):
            d, m = src.fn(env)
            return _cast_data(d, frm, to), m
        return CompiledExpr(f_cast, to)

    def _remap_to(self, p: CompiledExpr, dic: Tuple[str, ...]
                  ) -> CompiledExpr:
        if p.dictionary == dic:
            return p
        index = {v: i for i, v in enumerate(dic)}
        remap = np.array([index[v] for v in (p.dictionary or ())] or [0],
                         np.int32)
        return self._lookup(p, remap, p.type, dic)

    # -- calls -------------------------------------------------------------

    def _call(self, e: Call) -> CompiledExpr:
        name = e.name
        if name in NOT_YET_PORTED:
            raise ExpressionCompileError(
                f"{name}: not yet ported to presto_tpu_torch")
        args = [self.compile(a) for a in e.args]

        if name in _COMPARISONS:
            return self._comparison(name, e, args)
        if name == "like":
            return self._like(e, args)
        if name in _STRING_TO_STRING or name in _STRING_TO_INT \
                or name in _STRING_TO_BOOL \
                or name in _STRING_TO_STRING_NULL \
                or name in _STRING_TO_INT_NULL:
            return self._string_fn(name, e, args)
        if name == "concat":
            return self._concat(e, args)
        if name == "date_trunc":
            return self._date_trunc(e, args)
        if name in ("add", "subtract", "multiply", "divide", "modulus"):
            return self._arith(name, e, args)
        if name == "negate":
            a = args[0]

            def f_neg(env):
                d, m = a.fn(env)
                return -d, m
            return CompiledExpr(f_neg, e.type)
        if name in _MATH_FNS:
            impl = _MATH_FNS[name]
            typed = _numeric_prep(args)
            to_float = name in _FLOAT_MATH

            def f_math(env, impl=impl, typed=typed):
                vals = [t(env) for t in typed]
                m = vals[0][1]
                for _, pm in vals[1:]:
                    m = m & pm
                ds = [v for v, _ in vals]
                if to_float:
                    ds = [d if d.is_floating_point() else
                          d.to(torch.float64) for d in ds]
                return impl(*ds), m
            return CompiledExpr(f_math, e.type)
        if name in _DATE_EXTRACT:
            impl = _DATE_EXTRACT[name]
            a = args[0]

            def f_date(env, impl=impl, a=a):
                d, m = a.fn(env)
                return impl(d).to(torch.int64), m
            return CompiledExpr(f_date, BIGINT)
        if name == "nullif":
            a, b = args

            def f_nullif(env):
                ad, am = a.fn(env)
                bd, bm = b.fn(env)
                x, y = _promote(ad, bd)
                eq = (x == y) & am & bm
                return ad, am & ~eq
            return CompiledExpr(f_nullif, e.type, a.dictionary)
        if name in ("greatest", "least"):
            cmpf = torch.maximum if name == "greatest" else torch.minimum

            def f_gl(env):
                vals = [a.fn(env) for a in args]
                d, m = vals[0]
                for vd, vm in vals[1:]:
                    d = cmpf(*_promote(d, vd))
                    m = m & vm
                return d, m
            return CompiledExpr(f_gl, e.type)
        if name in ("second", "minute", "hour", "millisecond"):
            a = args[0]
            div, mod = {"millisecond": (1, 1000),
                        "second": (1000, 60),
                        "minute": (60_000, 60),
                        "hour": (3_600_000, 24)}[name]

            def f_time(env, div=div, mod=mod):
                d, m = a.fn(env)
                return (d.to(torch.int64) // div) % mod, m
            return CompiledExpr(f_time, BIGINT)
        if name in ("date_add", "date_diff"):
            return self._date_arith(name, e, args)
        if name == "last_day_of_month":
            a = args[0]

            def f_ldom(env):
                d, m = a.fn(env)
                return D.last_day_of_month(d), m
            return CompiledExpr(f_ldom, DATE)
        if name == "from_unixtime":
            a = args[0]

            def f_fut(env):
                d, m = a.fn(env)
                return torch.round(d.to(torch.float64) * 1000.0) \
                    .to(torch.int64), m
            return CompiledExpr(f_fut, TIMESTAMP)
        if name == "to_unixtime":
            a = args[0]

            def f_tut(env):
                d, m = a.fn(env)
                return _div_scalar(d.to(torch.float64), 1000.0), m
            return CompiledExpr(f_tut, DOUBLE)
        if name in ("is_nan", "is_finite", "is_infinite"):
            (a,) = args
            test = {"is_nan": torch.isnan, "is_finite": torch.isfinite,
                    "is_infinite": torch.isinf}[name]

            def f_ieee(env):
                d, m = a.fn(env)
                return test(d.to(torch.float64)), m
            return CompiledExpr(f_ieee, BOOLEAN)
        raise ExpressionCompileError(f"unknown scalar function {name!r}")

    def _date_arith(self, name: str, e: Call, args) -> CompiledExpr:
        """date_add(unit, n, x) / date_diff(unit, a, b) over DATE
        (days) or TIMESTAMP (ms) physical values."""
        unit_lit = e.args[0]
        if not isinstance(unit_lit, Literal):
            raise ExpressionCompileError(f"{name} unit must be a "
                                         "literal")
        unit = str(unit_lit.value).lower()
        is_ts = e.args[1 if name == "date_diff" else 2].type.name \
            == "timestamp"
        a1, a2 = args[1], args[2]

        DAY_MS = 86_400_000
        if name == "date_add":
            if unit in _MONTH_UNITS:
                k = _MONTH_UNITS[unit]

                def f(env):
                    nd, nm = a1.fn(env)
                    xd, xm = a2.fn(env)
                    n = nd.to(torch.int64) * k
                    if is_ts:
                        x = xd.to(torch.int64)
                        days = x // DAY_MS
                        tod = x - days * DAY_MS
                        out = D.add_months(days, n) * DAY_MS + tod
                    else:
                        out = D.add_months(xd, n)
                    return out, nm & xm
            else:
                units = _MS_UNITS if is_ts else _DAY_UNITS
                if unit not in units:
                    raise ExpressionCompileError(
                        f"date_add unit {unit!r} unsupported for "
                        f"{'timestamp' if is_ts else 'date'}")
                mult = units[unit]

                def f(env):
                    nd, nm = a1.fn(env)
                    xd, xm = a2.fn(env)
                    x, n = _promote(xd, nd)
                    return x + n * mult, nm & xm
            return CompiledExpr(f, e.type)

        # date_diff(unit, a, b) = b - a in unit, truncated toward zero
        if unit in _MONTH_UNITS:
            k = _MONTH_UNITS[unit]

            def f(env):
                ad, am = a1.fn(env)
                bd, bm = a2.fn(env)
                if is_ts:
                    ad, bd = ad.to(torch.int64), bd.to(torch.int64)
                    a_days = ad // DAY_MS
                    b_days = bd // DAY_MS
                    months = D.months_between(
                        a_days, b_days,
                        a_tie=ad - a_days * DAY_MS,
                        b_tie=bd - b_days * DAY_MS)
                else:
                    months = D.months_between(ad, bd)
                return torch.trunc(_div_scalar(months, k)) \
                    .to(torch.int64), am & bm
        else:
            units = _MS_UNITS if is_ts else _DAY_UNITS
            if unit not in units:
                raise ExpressionCompileError(
                    f"date_diff unit {unit!r} unsupported for "
                    f"{'timestamp' if is_ts else 'date'}")
            mult = units[unit]

            def f(env):
                ad, am = a1.fn(env)
                bd, bm = a2.fn(env)
                x, y = _promote(bd, ad)
                return torch.trunc(_div_scalar(x - y, mult)) \
                    .to(torch.int64), \
                    am & bm
        return CompiledExpr(f, BIGINT)

    def _comparison(self, name: str, e: Call, args) -> CompiledExpr:
        a, b = args
        if a.type.is_string or b.type.is_string:
            return self._string_comparison(name, a, b)
        op = _COMPARISONS[name]
        fa, fb = _coerce_pair(a, b)

        def f_cmp(env):
            ad, am = fa(env)
            bd, bm = fb(env)
            return op(*_promote(ad, bd)), am & bm
        return CompiledExpr(f_cmp, BOOLEAN)

    def _string_comparison(self, name: str, a: CompiledExpr,
                           b: CompiledExpr) -> CompiledExpr:
        # literal vs column: compare codes against the literal's rank
        # in the (sorted) dictionary — no device strings ever
        op = _COMPARISONS[name]
        a_lit = a.dictionary is not None and len(a.dictionary) == 1
        b_lit = b.dictionary is not None and len(b.dictionary) == 1
        if a_lit and b_lit:
            va, vb = a.dictionary[0], b.dictionary[0]
            result = self.const({
                "equal": va == vb, "not_equal": va != vb,
                "less_than": va < vb, "less_than_or_equal": va <= vb,
                "greater_than": va > vb,
                "greater_than_or_equal": va >= vb}[name], torch.bool)
            fa, fb = a.fn, b.fn

            def f_const(env):
                _, am = fa(env)
                _, bm = fb(env)
                return result, am & bm
            return CompiledExpr(f_const, BOOLEAN)
        if b_lit and a.dictionary is not None:
            lit_val = b.dictionary[0]
            dic = a.dictionary
            import bisect
            pos = bisect.bisect_left(dic, lit_val)
            present = pos < len(dic) and dic[pos] == lit_val
            fn = a.fn
            if name in ("equal", "not_equal"):
                if not present:
                    const = name == "not_equal"

                    def f_absent(env):
                        d, m = fn(env)
                        return torch.full_like(d, const,
                                               dtype=torch.bool), m
                    return CompiledExpr(f_absent, BOOLEAN)

                def f_eq(env):
                    d, m = fn(env)
                    r = d == pos
                    return (r if name == "equal" else ~r), m
                return CompiledExpr(f_eq, BOOLEAN)

            def f_range(env):
                # codes order == collation order
                d, m = fn(env)
                if present:
                    return op(d, pos), m
                # literal not in dict: d < pos <=> value < literal
                if name in ("less_than", "less_than_or_equal"):
                    return d < pos, m
                return d >= pos, m
            return CompiledExpr(f_range, BOOLEAN)
        if a_lit:
            from presto_tpu_torch.expr.ir import FLIP_COMPARISON
            return self._string_comparison(FLIP_COMPARISON[name], b, a)
        if a.dictionary is not None and a.dictionary == b.dictionary:
            fa, fb = a.fn, b.fn

            def f_cc(env):
                ad, am = fa(env)
                bd, bm = fb(env)
                return op(ad, bd), am & bm
            return CompiledExpr(f_cc, BOOLEAN)
        raise ExpressionCompileError(
            "varchar comparison requires a shared dictionary "
            "(planner must unify dictionaries first)")

    def _like(self, e: Call, args) -> CompiledExpr:
        col = args[0]
        pat = e.args[1]
        esc = None
        if len(e.args) > 2:
            if not isinstance(e.args[2], Literal):
                raise ExpressionCompileError("LIKE escape must be literal")
            esc = e.args[2].value
        if not isinstance(pat, Literal):
            raise ExpressionCompileError("LIKE pattern must be literal")
        rx = re.compile(_like_to_regex(pat.value, esc))
        table = np.array([rx.match(v) is not None
                          for v in col.dictionary or ()] or [False], bool)
        return self._lookup(col, table, BOOLEAN)

    def _string_fn(self, name: str, e: Call, args) -> CompiledExpr:
        col = args[0]
        dic = col.dictionary or ()
        lit_args = []
        for a in e.args[1:]:
            if not isinstance(a, Literal):
                raise ExpressionCompileError(
                    f"{name}: non-leading arguments must be literals")
            lit_args.append(a.value)
        if name in _STRING_TO_INT:
            impl = _STRING_TO_INT[name]
            vals = np.array([impl(v, *lit_args) for v in dic] or [0],
                            np.int64)
            return self._lookup(col, vals, BIGINT)
        if name in _STRING_TO_BOOL:
            impl = _STRING_TO_BOOL[name]
            vals = np.array([impl(v, *lit_args) for v in dic] or [False],
                            bool)
            return self._lookup(col, vals, BOOLEAN)
        if name in _STRING_TO_INT_NULL or name in _STRING_TO_STRING_NULL:
            # per-dictionary-value SQL NULLs: a null table rides next to
            # the value table and narrows the result mask
            impl = _STRING_TO_INT_NULL.get(name) \
                or _STRING_TO_STRING_NULL[name]
            mapped = [impl(v, *lit_args) for v in dic]
            if name in _STRING_TO_INT_NULL:
                new_dic = None
                vals = np.array([0 if v is None else v for v in mapped]
                                or [0], np.int64)
                typ = BIGINT
            else:
                new_dic = tuple(sorted({m for m in mapped
                                        if m is not None}))
                index = {v: i for i, v in enumerate(new_dic)}
                vals = np.array([0 if v is None else index[v]
                                 for v in mapped] or [0], np.int32)
                typ = VARCHAR
            tbl = self.table(vals)
            ntbl = self.table(np.array([v is None for v in mapped]
                                       or [True], bool))
            fn = col.fn

            def f_nullable(env):
                d, m = fn(env)
                idx = d.clamp(0, tbl.shape[0] - 1).long()
                return tbl[idx], m & ~ntbl[idx]
            return CompiledExpr(f_nullable, typ, new_dic)
        impl = _STRING_TO_STRING[name]
        mapped = [impl(v, *lit_args) for v in dic]
        new_dic = tuple(sorted(set(mapped)))
        index = {v: i for i, v in enumerate(new_dic)}
        remap = np.array([index[v] for v in mapped] or [0], np.int32)
        return self._lookup(col, remap, VARCHAR, new_dic)

    #: safety cap on the product dictionary a multi-column concat builds
    _CONCAT_DICT_MAX = 1 << 16

    def _concat(self, e: Call, args) -> CompiledExpr:
        """N-ary string concatenation over dictionary-coded inputs: the
        result dictionary is the sorted cross product of the input
        dictionaries; the kernel is one table lookup on the mixed-radix
        combination of input codes."""
        import itertools
        dics = []
        for a in args:
            if a.dictionary is None:
                raise ExpressionCompileError(
                    "concat argument has no dictionary (only varchar "
                    "inputs are supported)")
            dics.append(a.dictionary or ("",))
        total = 1
        for d in dics:
            total *= max(len(d), 1)
        if total > self._CONCAT_DICT_MAX:
            raise ExpressionCompileError(
                f"concat product dictionary too large ({total} > "
                f"{self._CONCAT_DICT_MAX}); reduce input cardinality")
        combos = ["".join(parts) for parts in itertools.product(*dics)]
        new_dic = tuple(sorted(set(combos)))
        index = {v: i for i, v in enumerate(new_dic)}
        tbl = self.table(np.array([index[v] for v in combos] or [0],
                                  np.int32))
        fns = [a.fn for a in args]
        strides = []
        s = 1
        for d in reversed(dics):
            strides.append(s)
            s *= max(len(d), 1)
        strides = list(reversed(strides))

        def f_concat(env):
            code = None
            mask = None
            for fn, stride in zip(fns, strides):
                d, m = fn(env)
                c = d.to(torch.int64) * stride
                code = c if code is None else code + c
                mask = m if mask is None else mask & m
            return tbl[code.clamp(0, tbl.shape[0] - 1)], mask
        return CompiledExpr(f_concat, VARCHAR, new_dic)

    def _date_trunc(self, e: Call, args) -> CompiledExpr:
        if len(e.args) != 2:
            raise ExpressionCompileError("date_trunc takes (unit, date)")
        unit_e = e.args[0]
        if not isinstance(unit_e, Literal):
            raise ExpressionCompileError("date_trunc unit must be a "
                                         "literal")
        unit = str(unit_e.value).lower()
        if unit not in ("day", "week", "month", "quarter", "year"):
            raise ExpressionCompileError(
                f"date_trunc: unsupported unit {unit!r}")
        fn = args[1].fn

        def f_trunc(env):
            d, m = fn(env)
            days = d.to(torch.int64)
            if unit == "day":
                out = days
            elif unit == "week":  # ISO week starts Monday
                out = days - (D.extract_dow(days) - 1)
            else:
                y, mo, _ = D.civil_from_days(days)
                if unit == "month":
                    out = D.days_from_civil(y, mo, 1)
                elif unit == "quarter":
                    out = D.days_from_civil(y, ((mo - 1) // 3) * 3 + 1, 1)
                else:
                    out = D.days_from_civil(y, 1, 1)
            return out.to(torch.int32), m
        return CompiledExpr(f_trunc, DATE)

    def _arith(self, name: str, e: Call, args) -> CompiledExpr:
        a, b = args
        out = e.type
        if out.is_decimal or a.type.is_decimal or b.type.is_decimal:
            return self._decimal_arith(name, e, a, b)
        fa, fb = _coerce_pair(a, b)
        odt = out.torch_dtype
        if name == "divide" and out.is_integer:
            # truncating integer division (SQL), x / 0 -> NULL
            def f_idiv(env):
                ad, am = fa(env)
                bd, bm = fb(env)
                ad, bd = _promote(ad, bd)
                safe = torch.where(bd == 0, torch.ones_like(bd), bd)
                q = torch.sign(ad) * torch.sign(bd) \
                    * (ad.abs() // safe.abs())
                return q.to(odt), am & bm & (bd != 0)
            return CompiledExpr(f_idiv, out)
        if name == "modulus" and out.is_integer:
            # remainder takes the dividend's sign (SQL), x % 0 -> NULL
            def f_imod(env):
                ad, am = fa(env)
                bd, bm = fb(env)
                ad, bd = _promote(ad, bd)
                safe = torch.where(bd == 0, torch.ones_like(bd), bd)
                r = torch.sign(ad) * (ad.abs() % safe.abs())
                return r.to(odt), am & bm & (bd != 0)
            return CompiledExpr(f_imod, out)
        op = {"add": torch.add, "subtract": torch.sub,
              "multiply": torch.mul, "divide": torch.div,
              "modulus": torch.remainder}[name]
        # date +/- interval day stays a date
        if a.type == DATE and b.type == INTERVAL_DAY:
            fa2, fb2 = a.fn, b.fn
            sign = 1 if name == "add" else -1

            def f_dint(env):
                ad, am = fa2(env)
                bd, bm = fb2(env)
                return (ad.to(torch.int64) + sign
                        * (bd.to(torch.int64) // 86_400_000)) \
                    .to(torch.int32), am & bm
            return CompiledExpr(f_dint, DATE)
        if a.type == DATE and b.type == INTERVAL_YEAR:
            fa2, fb2 = a.fn, b.fn
            sign = 1 if name == "add" else -1

            def f_dy(env):
                ad, am = fa2(env)
                bd, bm = fb2(env)
                y, m_, d_ = D.civil_from_days(ad)
                months = y * 12 + (m_ - 1) + sign * bd.to(torch.int64)
                ny = months // 12
                nm = months - ny * 12 + 1
                # clamp day to the target month's last day (Presto rule)
                next_m = torch.where(nm == 12, torch.ones_like(nm), nm + 1)
                next_y = torch.where(nm == 12, ny + 1, ny)
                dim = (D.days_from_civil(next_y, next_m, 1)
                       - D.days_from_civil(ny, nm, 1))
                return D.days_from_civil(ny, nm, torch.minimum(d_, dim)) \
                    .to(torch.int32), am & bm
            return CompiledExpr(f_dy, DATE)

        def f_arith(env):
            ad, am = fa(env)
            bd, bm = fb(env)
            ad, bd = _promote(ad, bd)
            m = am & bm
            if name in ("divide", "modulus") and out.is_integer:
                bd = torch.where(bd == 0, torch.ones_like(bd), bd)
            elif name == "divide" and not ad.is_floating_point():
                # torch divides integers into float32, jnp into float64
                ad, bd = ad.to(odt), bd.to(odt)
            return op(ad, bd).to(odt), m
        return CompiledExpr(f_arith, out)

    def _decimal_arith(self, name, e, a, b) -> CompiledExpr:
        out = e.type
        if not out.is_decimal:
            # decimal op double -> double
            fa, fb = _coerce_pair(a, b)
            op = {"add": torch.add, "subtract": torch.sub,
                  "multiply": torch.mul, "divide": torch.div,
                  "modulus": torch.remainder}[name]
            odt = out.torch_dtype

            def f_dd(env):
                ad, am = fa(env)
                bd, bm = fb(env)
                return op(*_promote(ad, bd)).to(odt), am & bm
            return CompiledExpr(f_dd, out)
        sa = a.type.scale if a.type.is_decimal else 0
        sb = b.type.scale if b.type.is_decimal else 0
        so = out.scale
        fa, fb = a.fn, b.fn

        def to_unscaled(d, typ, target_scale):
            shift = target_scale - (typ.scale if typ.is_decimal else 0)
            d = d.to(torch.int64)
            return d * (10 ** shift) if shift > 0 else d

        if name in ("add", "subtract"):
            s = max(sa, sb)
            op = torch.add if name == "add" else torch.sub

            def f_as(env):
                ad, am = fa(env)
                bd, bm = fb(env)
                r = op(to_unscaled(ad, a.type, s),
                       to_unscaled(bd, b.type, s))
                return _rescale(r, s, so), am & bm
            return CompiledExpr(f_as, out)
        if name == "multiply":
            s = sa + sb

            def f_mul(env):
                ad, am = fa(env)
                bd, bm = fb(env)
                r = ad.to(torch.int64) * bd.to(torch.int64)
                return _rescale(r, s, so), am & bm
            return CompiledExpr(f_mul, out)
        if name == "divide":
            # result = a / b at scale so, HALF_UP
            shift = so + sb - sa

            def f_div(env):
                ad, am = fa(env)
                bd, bm = fb(env)
                num = ad.to(torch.int64) * (10 ** max(shift, 0))
                den = bd.to(torch.int64) * (10 ** max(-shift, 0))
                ok = den != 0
                den_s = torch.where(ok, den, torch.ones_like(den))
                return _div_half_up(num, den_s), am & bm & ok
            return CompiledExpr(f_div, out)
        if name == "modulus":
            s = max(sa, sb)

            def f_mod(env):
                ad, am = fa(env)
                bd, bm = fb(env)
                an = to_unscaled(ad, a.type, s)
                bn = to_unscaled(bd, b.type, s)
                ok = bn != 0
                bs = torch.where(ok, bn, torch.ones_like(bn))
                r = torch.sign(an) * (an.abs() % bs.abs())
                return _rescale(r, s, so), am & bm & ok
            return CompiledExpr(f_mod, out)
        raise ExpressionCompileError(f"decimal op {name}")


# -- helpers ----------------------------------------------------------------

def _apply_lookup(fn, tbl: torch.Tensor, env) -> CVal:
    d, m = fn(env)
    return tbl[d.clamp(0, tbl.shape[0] - 1).long()], m


def _div_scalar(d: torch.Tensor, k) -> torch.Tensor:
    """`d / k` for a Python number `k`, divided as IEEE division on
    every device: torch's CUDA kernels multiply by the reciprocal of a
    Python-number divisor (one bit off the quotient, and a truncation
    after it can then be off by one), so the divisor becomes a 0-d
    tensor of the same promotion category on `d`'s device."""
    dt = torch.float64 if isinstance(k, float) else torch.int64
    return d / torch.full((), k, dtype=dt, device=d.device)


def _rescale(unscaled: torch.Tensor, from_scale: int, to_scale: int):
    if to_scale == from_scale:
        return unscaled
    if to_scale > from_scale:
        return unscaled * (10 ** (to_scale - from_scale))
    return _div_half_up(unscaled, 10 ** (from_scale - to_scale))


def _div_half_up(num: torch.Tensor, den) -> torch.Tensor:
    """Integer division rounding half away from zero (SQL DECIMAL)."""
    num = num.to(torch.int64)
    if isinstance(den, int):
        den = torch.tensor(den, dtype=torch.int64, device=num.device)
    sign = torch.sign(num) * torch.sign(den)
    return sign * ((2 * num.abs() + den.abs()) // (2 * den.abs()))


def _cast_data(d: torch.Tensor, frm: Type, to: Type) -> torch.Tensor:
    if frm.is_decimal and to.is_decimal:
        return _rescale(d, frm.scale, to.scale)
    if frm.is_decimal and to.is_floating:
        return _div_scalar(d.to(to.torch_dtype), 10 ** frm.scale)
    if frm.is_decimal and to.is_integer:
        return _div_half_up(d, 10 ** frm.scale).to(to.torch_dtype)
    if to.is_decimal:
        if frm.is_integer or frm.name == "boolean":
            return d.to(torch.int64) * (10 ** to.scale)
        # float -> decimal: round half to even like jnp.round
        return torch.round(d.to(torch.float64) * (10 ** to.scale)) \
            .to(torch.int64)
    if to.is_integer and frm.is_floating:
        return torch.round(d).to(to.torch_dtype)
    return d.to(to.torch_dtype)


def _coerce_pair(a: CompiledExpr, b: CompiledExpr):
    """Coerce both sides to a common numeric representation lazily
    (a decimal compared with a float is unscaled to float64)."""
    def conv(x: CompiledExpr, other: Type):
        if x.type.is_decimal and other.is_floating:
            scale = x.type.scale

            def f(env):
                d, m = x.fn(env)
                return _div_scalar(d.to(torch.float64), 10 ** scale), m
            return f
        return x.fn
    return conv(a, b.type), conv(b, a.type)


def _numeric_prep(args):
    out = []
    for a in args:
        if a.type.is_decimal:
            scale = a.type.scale

            def f(env, a=a, scale=scale):
                d, m = a.fn(env)
                return _div_scalar(d.to(torch.float64), 10 ** scale), m
            out.append(f)
        else:
            out.append(a.fn)
    return out


def _merge_result_dicts(typ: Type, *parts) -> Optional[Tuple[str, ...]]:
    if not typ.is_string:
        return None
    return tuple(sorted(set().union(*[set(p.dictionary or ())
                                      for p in parts])))


_COMPARISONS = {
    "equal": lambda a, b: a == b,
    "not_equal": lambda a, b: a != b,
    "less_than": lambda a, b: a < b,
    "less_than_or_equal": lambda a, b: a <= b,
    "greater_than": lambda a, b: a > b,
    "greater_than_or_equal": lambda a, b: a >= b,
}


def _scaled(op, x, d):
    """`op(x * 10.0 ** d) / 10.0 ** d` (the reference's round and
    truncate with decimals) in float64, as the reference's x64
    promotion computes it whatever `x` is: torch would keep a REAL `x`
    in float32 against a 0-d scale, and give `10.0 ** int64_tensor` as
    float32. A column `d` scales elementwise, and both divisions are by
    a tensor, IEEE on every device."""
    x = x.to(torch.float64)
    if isinstance(d, (int, float)):
        scale = float(10.0 ** d)
        return _div_scalar(op(x * scale), scale)
    scale = 10.0 ** d.to(torch.float64)  # libdevice pow on the card
    return op(x * scale) / scale


def _round(x, d=None):
    return torch.round(x) if d is None else _scaled(torch.round, x, d)


def _truncate(x, d=None):
    return torch.trunc(x) if d is None else _scaled(torch.trunc, x, d)


def _width_bucket(x, lo, hi, n):
    """Ascending OR descending bounds (reference: MathFunctions
    widthBucket supports bound1 > bound2)."""
    span_up = torch.where(hi != lo, hi - lo, torch.ones_like(hi))
    span_dn = torch.where(hi != lo, lo - hi, torch.ones_like(hi))
    up = torch.clamp(torch.floor((x - lo) / span_up * n) + 1, 0, None)
    dn = torch.clamp(torch.floor((lo - x) / span_dn * n) + 1, 0, None)
    r = torch.where(hi >= lo, up, dn)
    return torch.minimum(r, n + 1).to(torch.int64)


_MATH_FNS = {
    "abs": torch.abs,
    "ceiling": torch.ceil,
    "floor": torch.floor,
    "sqrt": torch.sqrt,
    "cbrt": lambda x: torch.sign(x) * torch.abs(x) ** (1.0 / 3.0),
    "exp": torch.exp,
    "ln": torch.log,
    "log2": torch.log2,
    "log10": torch.log10,
    "power": lambda a, b: torch.pow(*_promote(a, b)),
    "sign": torch.sign,
    "round": _round,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "atan2": lambda a, b: torch.atan2(*_promote(a, b)),
    "mod": lambda a, b: torch.remainder(*_promote(a, b)),
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "log": lambda b, x: torch.log(x) / torch.log(b),
    "truncate": _truncate,
    "width_bucket": _width_bucket,
    "bitwise_and": lambda a, b: torch.bitwise_and(*_promote(a, b)),
    "bitwise_or": lambda a, b: torch.bitwise_or(*_promote(a, b)),
    "bitwise_xor": lambda a, b: torch.bitwise_xor(*_promote(a, b)),
    "bitwise_not": torch.bitwise_not,
    "bitwise_left_shift": lambda a, b: torch.bitwise_left_shift(
        *_promote(a, b)),
    "bitwise_right_shift": lambda a, b: torch.bitwise_right_shift(
        *_promote(a, b)),
    "cot": lambda x: 1.0 / torch.tan(x),
    "log1p": torch.log1p, "expm1": torch.expm1,
}

#: math functions whose jnp form returns float64 for integer input
#: (torch would return float32): integer arguments are cast first
_FLOAT_MATH = frozenset({
    "sqrt", "cbrt", "exp", "ln", "log2", "log10", "power", "sin", "cos",
    "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh",
    "degrees", "radians", "log", "cot", "log1p", "expm1",
    "width_bucket",
})

_DATE_EXTRACT = {
    "year": D.extract_year,
    "month": D.extract_month,
    "day": D.extract_day,
    "quarter": D.extract_quarter,
    "day_of_week": D.extract_dow,
    "day_of_year": D.extract_doy,
    "week": D.extract_week,
    "week_of_year": D.extract_week,
    "day_of_month": D.extract_day,
    "year_of_week": D.extract_year_of_week,
}

#: date_add/date_diff unit multipliers on the DATE (days) axis
_DAY_UNITS = {"day": 1, "week": 7}
#: ... and on the TIMESTAMP (milliseconds) axis
_MS_UNITS = {"millisecond": 1, "second": 1000, "minute": 60_000,
             "hour": 3_600_000, "day": 86_400_000,
             "week": 7 * 86_400_000}
_MONTH_UNITS = {"month": 1, "quarter": 3, "year": 12}


def _pad(v: str, n, pad: str, left: bool) -> str:
    """Presto lpad/rpad: truncate to n when longer; multi-character pad
    strings repeat."""
    n = int(n)
    if len(v) >= n:
        return v[:n]
    if not pad:
        raise ExpressionCompileError("pad string must not be empty")
    fill = (pad * n)[:n - len(v)]
    return fill + v if left else v + fill


def _substr(v: str, start, length=None) -> str:
    """Presto substr: 1-based; negative start counts from the end;
    start 0 yields ''."""
    start = int(start)
    if start == 0:
        return ""
    idx = start - 1 if start > 0 else len(v) + start
    if idx < 0:
        return ""
    if length is None:
        return v[idx:]
    return v[idx:idx + int(length)]


def _split_part(v: str, delim: str, index: int):
    if not delim:
        return None
    parts = v.split(delim)
    i = int(index)
    if i < 1 or i > len(parts):
        return None
    return parts[i - 1]


#: string -> string-or-NULL functions
_STRING_TO_STRING_NULL: Dict[str, Any] = {
    "split_part": _split_part,
}

_STRING_TO_STRING: Dict[str, Any] = {
    "substr": _substr,
    "upper": lambda v: v.upper(),
    "lower": lambda v: v.lower(),
    "trim": lambda v: v.strip(),
    "ltrim": lambda v: v.lstrip(),
    "rtrim": lambda v: v.rstrip(),
    "reverse": lambda v: v[::-1],
    "concat_lit": lambda v, suffix: v + suffix,
    "translate": lambda v, frm, to: v.translate(
        {ord(f): (to[i] if i < len(to) else None)
         for i, f in enumerate(frm)}),
    "normalize": lambda v: __import__("unicodedata").normalize(
        "NFC", v),
    "split_join": lambda v, d, sep: sep.join(v.split(d)),
    "replace": lambda v, find, repl="": v.replace(find, repl),
    "lpad": lambda v, n, pad=" ": _pad(v, n, pad, left=True),
    "rpad": lambda v, n, pad=" ": _pad(v, n, pad, left=False),
}


def _levenshtein(a: str, b: str) -> int:
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def _from_base(v: str, radix: int):
    try:
        return int(v, int(radix))
    except ValueError:
        return None  # deviation: Presto raises; we yield SQL NULL


_STRING_TO_INT: Dict[str, Any] = {
    "length": lambda v: len(v),
    "strpos": lambda v, sub: v.find(sub) + 1,
    "codepoint": lambda v: ord(v[0]) if v else 0,
    "levenshtein_distance": lambda v, other: _levenshtein(v, other),
    "split_count": lambda v, d: len(v.split(d)),
    "bit_length": lambda v: len(v.encode()) * 8,
    "octet_length": lambda v: len(v.encode()),
    "crc32": lambda v: __import__("zlib").crc32(v.encode()),
}

#: string -> bigint-or-NULL (invalid input yields SQL NULL)
_STRING_TO_INT_NULL: Dict[str, Any] = {
    "from_base": _from_base,
    # deviation: Presto raises on unequal lengths; we yield NULL
    "hamming_distance": lambda v, other: sum(
        x != y for x, y in zip(v, other)) if len(v) == len(other)
        else None,
}

_STRING_TO_BOOL: Dict[str, Any] = {
    "starts_with": lambda v, prefix: v.startswith(prefix),
    "ends_with": lambda v, suffix: v.endswith(suffix),
    "contains_str": lambda v, sub: sub in v,
}


def fold_constants(expr: RowExpression,
                   _memo: Optional[dict] = None) -> RowExpression:
    """Evaluate literal-only subtrees host-side, on the CPU. E.g.
    `date '1998-12-01' - interval '90' day` becomes a DATE literal.
    Memoized by node identity (analyzer output is a DAG)."""
    if isinstance(expr, (Literal, InputRef)):
        return expr
    if _memo is None:
        _memo = {}
    hit = _memo.get(id(expr))
    if hit is not None:
        return hit
    original = expr
    kids = tuple(fold_constants(c, _memo) for c in expr.children())
    if isinstance(expr, Call):
        expr = Call(expr.name, kids, expr.type)
    elif isinstance(expr, SpecialForm):
        expr = SpecialForm(expr.form, kids, expr.type)
    out = expr
    if all(isinstance(k, Literal) for k in kids) and kids \
            and not any(k.value is None for k in kids) \
            and not expr.type.is_string:
        try:
            d, m = compile_expression(expr, {}).fn({})
            out = Literal(d.item() if bool(m) else None, expr.type)
        except ExpressionCompileError:
            out = expr
    _memo[id(original)] = out
    return out
