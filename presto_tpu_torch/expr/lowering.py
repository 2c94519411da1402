"""Typed lowering of compiled expressions: what each closure computes,
as a small DAG of element-wise operations (the input of the fragment
kernel generator, `expr/codegen.py`).

A `CompiledExpr.fn` closure is written once, over torch tensors. To
describe it, the closure is run once more over symbolic values (`Sym`)
that stand for its input columns. Every torch operation the closure
applies to a `Sym` — an operator, a method or a `torch.*` function —
reaches `Sym.__torch_function__`, which records one `LNode` (op, result
dtype, operands, constant, lookup table) and runs the same operation on
meta tensors to learn the result's dtype. The promotion rules
(`compile._promote`), the NULL rules and torch's own 0-d-versus-column
promotion therefore live only in the closures: the generator never
re-derives them from the IR.

An operation outside `OPS` (or one the generator cannot reproduce
exactly, such as floor division of floats) makes the closure
unlowerable: `Unlowerable.function` names the innermost IR function or
special form that applied it (`compile._share` attaches the name). Any
other exception raised while a closure runs over symbolic values is a
fault and propagates.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch


class Unlowerable(Exception):
    """A closure applied an operation with no lowering. `function` is
    the IR function (or special form) whose closure did."""

    def __init__(self, op: str, function: Optional[str] = None):
        super().__init__(f"no lowering for {op!r}"
                         + (f" in {function}" if function else ""))
        self.op = op
        self.function = function


class LNode:
    """One value of a lowered expression DAG.

    op:    "col" / "mask" (input column data / mask; `value` = name),
           "rv" (the batch's row_valid), "const" (`value` = Python
           scalar), "table" (`value` = a 1-D lookup tensor), or an
           element-wise operation of `OPS` over `args`.
    dtype: the torch dtype of the result.
    cdt:   the dtype the operation computes in (its operands are cast
           to it first); equal to `dtype` except for comparisons.
    """

    __slots__ = ("op", "dtype", "args", "value", "cdt")

    def __init__(self, op: str, dtype: torch.dtype, args: tuple = (),
                 value: Any = None, cdt: Optional[torch.dtype] = None):
        self.op = op
        self.dtype = dtype
        self.args = args
        self.value = value
        self.cdt = cdt if cdt is not None else dtype

    def __repr__(self) -> str:
        v = "" if self.value is None or self.op == "table" \
            else f" {self.value!r}"
        return f"<{self.op}{v} {self.dtype}>"


#: element-wise operations a lowering may hold (codegen implements
#: every one; tests hold the two lists equal)
OPS = frozenset({
    "and", "or", "xor", "not", "invert",
    "eq", "ne", "lt", "le", "gt", "ge",
    "add", "sub", "mul", "div", "floordiv", "truncdiv", "mod",
    "neg", "abs", "sign", "minimum", "maximum", "clamp",
    "trunc", "floor", "ceil", "round", "isnan", "isinf", "isfinite",
    "sqrt", "shl", "shr", "libm",
    "cast", "where", "gather",
})

#: float64 functions of the CUDA math library (libdevice), which both
#: PyTorch's CUDA kernels and a generated kernel call: an op "libm"
#: whose `value` is the function's name
LIBM = frozenset({
    "exp", "log", "log2", "log10", "log1p", "expm1", "sin", "cos", "tan",
    "asin", "acos", "atan", "sinh", "cosh", "tanh", "atan2", "pow",
})
_LIBM_BINARY = frozenset({"atan2", "pow"})

#: the operators, methods and torch functions the compiled closures
#: apply, by name, -> the op they record
_BINARY = {
    "and": "and", "bitwise_and": "and", "or": "or", "bitwise_or": "or",
    "xor": "xor", "bitwise_xor": "xor",
    "eq": "eq", "ne": "ne", "lt": "lt", "le": "le", "gt": "gt",
    "ge": "ge", "add": "add", "sub": "sub", "mul": "mul",
    "truediv": "div", "div": "div", "floordiv": "floordiv",
    "mod": "mod", "remainder": "mod",
    "minimum": "minimum", "maximum": "maximum",
    "lshift": "shl", "bitwise_left_shift": "shl",
    "rshift": "shr", "bitwise_right_shift": "shr",
}
_REFLECTED = {"radd": "add", "rsub": "sub", "rmul": "mul",
              "rtruediv": "div", "rfloordiv": "floordiv", "rmod": "mod",
              "rand": "and", "ror": "or", "rxor": "xor",
              "rlshift": "shl", "rrshift": "shr"}
_UNARY = {"neg": "neg", "abs": "abs", "sign": "sign", "invert": "not",
          "bitwise_not": "not", "trunc": "trunc", "floor": "floor",
          "ceil": "ceil", "round": "round", "isnan": "isnan",
          "isinf": "isinf", "isfinite": "isfinite", "sqrt": "sqrt"}
#: element-wise products by a constant: torch multiplies by the C
#: constant, which these values are exactly
_SCALE = {"rad2deg": 180.0 / math.pi, "deg2rad": math.pi / 180.0}
_CASTS = frozenset({"to", "long", "int", "float", "double", "bool"})
_IDENTITY = frozenset({"expand", "contiguous"})
_CONST_LIKE = {"zeros_like": 0, "ones_like": 1}
_COMPARE = frozenset({"eq", "ne", "lt", "le", "gt", "ge"})

_META = torch.device("meta")


def _norm(name: str) -> str:
    return name.strip("_")


class Sym:
    """A symbolic tensor: an `LNode` and a meta tensor of its dtype
    (0-d for constants, 1-D for per-row values)."""

    __slots__ = ("node", "meta")

    def __init__(self, node: LNode, meta: torch.Tensor):
        self.node = node
        self.meta = meta

    @property
    def dtype(self) -> torch.dtype:
        return self.meta.dtype

    @property
    def shape(self):
        return self.meta.shape

    @property
    def device(self) -> torch.device:
        # constants a closure makes "on the device of" a symbolic value
        # are made on the CPU, where they become LNode constants
        return torch.device("cpu")

    def dim(self) -> int:
        return self.meta.dim()

    def is_floating_point(self) -> bool:
        return self.meta.is_floating_point()

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return _apply(getattr(func, "__name__", str(func)), func, args,
                      kwargs or {})

    def __bool__(self):
        raise Unlowerable("bool()")

    def __int__(self):
        raise Unlowerable("int()")

    def __float__(self):
        raise Unlowerable("float()")

    def __index__(self):
        raise Unlowerable("index()")

    def item(self):
        raise Unlowerable("item()")


def _method(name):
    func = getattr(torch.Tensor, name)

    def m(self, *args, **kwargs):
        return _apply(name, func, (self,) + args, kwargs)
    m.__name__ = name
    return m


for _n in ("__and__", "__or__", "__xor__", "__invert__", "__eq__",
           "__ne__", "__lt__", "__le__", "__gt__", "__ge__", "__add__",
           "__sub__", "__mul__", "__truediv__", "__floordiv__",
           "__mod__", "__neg__", "__abs__", "__radd__", "__rsub__",
           "__rmul__", "__rtruediv__", "__rfloordiv__", "__rmod__",
           "__rand__", "__ror__", "__rxor__", "__pow__", "__rpow__",
           "__lshift__", "__rshift__", "__rlshift__", "__rrshift__",
           "__matmul__", "__rmatmul__", "to", "long", "int",
           "float", "double", "bool", "abs", "clamp", "expand",
           "contiguous", "sign", "neg", "trunc", "floor", "ceil",
           "round", "isnan", "bitwise_not", "__getitem__"):
    setattr(Sym, _n, _method(_n))
Sym.__hash__ = object.__hash__


def _to_meta(x):
    if isinstance(x, Sym):
        return x.meta
    if isinstance(x, torch.Tensor):
        return x.to(_META)
    if isinstance(x, (list, tuple)):
        return type(x)(_to_meta(v) for v in x)
    return x


def node_of(x) -> LNode:
    """The LNode of a closure value: a Sym's node, a 0-d tensor or a
    Python scalar as a constant, a 1-D tensor as a lookup table."""
    if isinstance(x, Sym):
        return x.node
    if isinstance(x, torch.Tensor):
        if x.dim() == 0:
            return LNode("const", x.dtype, value=x.item())
        if x.dim() == 1:
            return LNode("table", x.dtype, value=x)
        raise Unlowerable("tensor constant")
    if isinstance(x, bool):
        return LNode("const", torch.bool, value=x)
    if isinstance(x, int):
        return LNode("const", torch.int64, value=x)
    if isinstance(x, float):
        return LNode("const", torch.float64, value=x)
    raise Unlowerable(type(x).__name__)


def _operand(x) -> LNode:
    n = node_of(x)
    if n.op == "table":
        raise Unlowerable("table operand")
    return n


def _apply(name: str, func, args, kwargs) -> Sym:
    key = _norm(name)
    try:
        meta = func(*_to_meta(args), **_to_meta(kwargs))
    except Unlowerable:
        raise
    except Exception:  # noqa: BLE001 — not expressible over meta
        raise Unlowerable(key) from None
    if not isinstance(meta, torch.Tensor):
        raise Unlowerable(key)
    node = _build(key, args, kwargs, meta)
    return Sym(node, meta)


def _result_type(a, b) -> torch.dtype:
    return torch.result_type(_to_meta(a), _to_meta(b))


def _build(key: str, args, kwargs, meta: torch.Tensor) -> LNode:
    dt = meta.dtype
    if key in _CASTS:
        src = _operand(args[0])
        return src if src.dtype == dt else LNode("cast", dt, (src,))
    if key in _IDENTITY:
        return _operand(args[0])
    if key in _CONST_LIKE or key == "full_like":
        val = _CONST_LIKE[key] if key in _CONST_LIKE \
            else (args[1] if len(args) > 1 else kwargs["fill_value"])
        if isinstance(val, (Sym, torch.Tensor)):
            raise Unlowerable(key)
        val = bool(val) if dt == torch.bool else (
            float(val) if dt.is_floating_point else int(val))
        return LNode("const", dt, value=val)
    if key == "getitem":
        table, idx = args
        if not isinstance(table, torch.Tensor) or table.dim() != 1 \
                or not isinstance(idx, Sym) or idx.dtype == torch.bool:
            raise Unlowerable("getitem")
        return LNode("gather", dt, (node_of(table), idx.node))
    if key == "where":
        if kwargs or len(args) != 3:
            raise Unlowerable(key)
        c, a, b = (_operand(x) for x in args)
        return LNode("where", dt, (c, a, b))
    if key == "clamp":
        x = args[0]
        lo = args[1] if len(args) > 1 else kwargs.get("min")
        hi = args[2] if len(args) > 2 else kwargs.get("max")
        return LNode("clamp", dt, (_operand(x),
                                   None if lo is None else _operand(lo),
                                   None if hi is None else _operand(hi)))
    if key == "rpow":  # `number ** column`
        key, args = "pow", (args[1], args[0])
    if key in LIBM:
        if dt not in (torch.float32, torch.float64):
            raise Unlowerable(f"{key} of {dt}")
        arity = 2 if key in _LIBM_BINARY else 1
        if kwargs or len(args) != arity:
            raise Unlowerable(key)
        if dt == torch.float64:
            return LNode("libm", dt, tuple(_operand(x) for x in args),
                         value=key)
        # REAL: the float64 libdevice function of the widened operands,
        # rounded to float32 (Triton's float32 libdevice forms flush
        # denormals)
        return _widened("libm", args, key)
    if key in _SCALE:
        x = _operand(args[0])
        if x.dtype != dt:
            x = LNode("cast", dt, (x,))
        return LNode("mul", dt, (x, LNode("const", dt, value=_SCALE[key])))
    if key in _UNARY:
        if key == "round" and (kwargs.get("decimals", 0) or len(args) > 1):
            raise Unlowerable("round(decimals)")
        op = _UNARY[key]
        a = _operand(args[0])
        if op == "not" and a.dtype != torch.bool:
            op = "invert"
        return LNode(op, dt, (a,))
    reflected = key in _REFLECTED
    if key in _BINARY or reflected:
        op = _REFLECTED[key] if reflected else _BINARY[key]
        if len(args) != 2:
            raise Unlowerable(key)
        a, b = (args[1], args[0]) if reflected else args
        if op == "div":
            mode = kwargs.get("rounding_mode")
            if mode == "floor":
                op = "floordiv"
            elif mode == "trunc":
                op = "truncdiv"
            elif mode is not None:
                raise Unlowerable(key)
        elif kwargs:
            raise Unlowerable(key)  # e.g. add(alpha=)
        na, nb = _operand(a), _operand(b)
        cdt = _result_type(a, b) if op in _COMPARE \
            or op in ("and", "or", "xor") else dt
        if op == "floordiv" and cdt.is_floating_point:
            raise Unlowerable(f"{op} of {cdt}")
        if op == "mod" and cdt == torch.float32:
            # REAL remainder in float64 (fmod is exact, so its float32
            # rounding is PyTorch's float32 result)
            return _widened("mod", (na, nb), None)
        return LNode(op, dt, (na, nb), cdt=cdt)
    raise Unlowerable(key)


def _widened(op: str, args, value) -> LNode:
    """A float32 `op` computed in float64 and rounded to float32."""
    wide = tuple(LNode("cast", torch.float64, (x,))
                 if x.dtype != torch.float64 else x
                 for x in (_operand(a) if not isinstance(a, LNode) else a
                           for a in args))
    return LNode("cast", torch.float32,
                 (LNode(op, torch.float64, wide, value=value,
                        cdt=torch.float64),))


class LeafEnv(dict):
    """A closure environment whose columns are symbolic leaves, made on
    first use: `schema` maps a column name to its data dtype."""

    def __init__(self, dtypes: Dict[str, torch.dtype]):
        super().__init__()
        self._dtypes = dtypes

    def __missing__(self, name):
        dt = self._dtypes.get(name)
        if dt is None:
            raise KeyError(name)
        val = (Sym(LNode("col", dt, value=name),
                   torch.empty(1, dtype=dt, device=_META)),
               Sym(LNode("mask", torch.bool, value=name),
                   torch.empty(1, dtype=torch.bool, device=_META)))
        self[name] = val
        return val


def lower_fn(fn, dtypes: Dict[str, torch.dtype]) -> Tuple[LNode, LNode]:
    """(data, mask) LNodes of `fn(env)` over symbolic input columns.
    Raises Unlowerable."""
    d, m = fn(LeafEnv(dtypes))
    return _operand(d), _operand(m)


def walk(nodes):
    """Every LNode reachable from `nodes`, operands first, once each."""
    out, seen = [], set()
    stack = [(n, False) for n in reversed(list(nodes)) if n is not None]
    while stack:
        n, done = stack.pop()
        if id(n) in seen:
            continue
        if done:
            seen.add(id(n))
            out.append(n)
            continue
        stack.append((n, True))
        for a in reversed(n.args):
            if a is not None and id(a) not in seen:
                stack.append((a, False))
    return out


def substitute(node: LNode, env: Dict[str, Tuple[LNode, LNode]],
               memo: Dict[int, LNode]) -> LNode:
    """`node` with its "col"/"mask" leaves replaced by `env`'s (data,
    mask) nodes — one chain stage's expressions over the previous
    stage's outputs."""
    for n in walk([node]):
        if id(n) in memo:
            continue
        if n.op == "col":
            memo[id(n)] = env[n.value][0]
        elif n.op == "mask":
            memo[id(n)] = env[n.value][1]
        elif not n.args:
            memo[id(n)] = n
        else:
            args = tuple(None if a is None else memo[id(a)]
                         for a in n.args)
            memo[id(n)] = n if all(x is y for x, y in zip(args, n.args)) \
                else LNode(n.op, n.dtype, args, n.value, n.cdt)
    return memo[id(node)]
