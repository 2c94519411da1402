"""A stand-in for `triton` / `triton.language` that runs a generated
fragment kernel (presto_tpu_torch/expr/codegen.py) block by block over
CPU tensors, with Triton's semantics where they differ from PyTorch's:
integer `//` truncates toward zero and `%` takes the dividend's sign;
`int1` values are booleans and loads of uint8-viewed booleans yield the
stored bytes; a masked load yields `other` on cleared lanes and a
masked store leaves them untouched. It covers exactly the part of the
language the generator emits."""

from __future__ import annotations

import types

import torch


class T:
    """A block value: a 1-D torch tensor with Triton's operators."""

    __slots__ = ("t",)

    def __init__(self, t):
        self.t = t

    @staticmethod
    def _v(x):
        return x.t if isinstance(x, T) else x

    def _bin(self, other, fn):
        return T(fn(self.t, T._v(other)))

    def _rbin(self, other, fn):
        return T(fn(T._v(other), self.t))

    def __add__(self, o): return self._bin(o, lambda a, b: a + b)
    def __radd__(self, o): return self._rbin(o, lambda a, b: a + b)
    def __sub__(self, o): return self._bin(o, lambda a, b: a - b)
    def __rsub__(self, o): return self._rbin(o, lambda a, b: a - b)
    def __mul__(self, o): return self._bin(o, lambda a, b: a * b)
    def __rmul__(self, o): return self._rbin(o, lambda a, b: a * b)

    def __truediv__(self, o):
        return self._bin(o, lambda a, b: a / b)

    def __floordiv__(self, o):
        return self._bin(o, lambda a, b: torch.div(
            a, _nonzero(b), rounding_mode="trunc"))

    def __mod__(self, o):
        return self._bin(o, lambda a, b: torch.fmod(a, _nonzero(b)))

    def __neg__(self): return T(-self.t)

    def __invert__(self):
        return T(~self.t)

    def __lshift__(self, o):
        return self._bin(o, lambda a, b: a << b)

    def __rshift__(self, o):
        return self._bin(o, lambda a, b: a >> b)

    def __and__(self, o): return self._bin(o, lambda a, b: a & b)
    def __or__(self, o): return self._bin(o, lambda a, b: a | b)
    def __xor__(self, o): return self._bin(o, lambda a, b: a ^ b)

    def _cmp(self, o, fn):
        b = T._v(o)
        a = self.t
        if a.dtype == torch.bool and not isinstance(b, torch.Tensor):
            a = a.to(torch.int32)
        return T(fn(a, b))

    def __eq__(self, o): return self._cmp(o, lambda a, b: a == b)
    def __ne__(self, o): return self._cmp(o, lambda a, b: a != b)
    def __lt__(self, o): return self._cmp(o, lambda a, b: a < b)
    def __le__(self, o): return self._cmp(o, lambda a, b: a <= b)
    def __gt__(self, o): return self._cmp(o, lambda a, b: a > b)
    def __ge__(self, o): return self._cmp(o, lambda a, b: a >= b)

    __hash__ = None

    def to(self, dtype):
        return T(self.t.to(dtype))


def _nonzero(b):
    """An integer divisor with zeros replaced: the card's integer
    division does not trap, and lanes dividing by zero (padding lanes
    load 0) hold unspecified values that no mask exposes."""
    if isinstance(b, torch.Tensor) and not b.is_floating_point():
        return torch.where(b == 0, torch.ones_like(b), b)
    return b


class Ptr:
    """A pointer: a base tensor plus element offsets."""

    def __init__(self, base, offs=None):
        self.base = base
        self.offs = offs

    def __add__(self, offs):
        return Ptr(self.base, T._v(offs).to(torch.int64))


def _load(ptr, mask=None, other=None):
    idx = ptr.offs
    if mask is None:
        return T(ptr.base[idx])
    m = T._v(mask)
    safe = torch.where(m, idx, torch.zeros_like(idx))
    vals = ptr.base[safe]
    fill = torch.full_like(vals, other if other is not None else 0)
    return T(torch.where(m, vals, fill))


def _store(ptr, val, mask=None):
    v = T._v(val)
    if not isinstance(v, torch.Tensor):
        v = torch.full(ptr.offs.shape, v)
    v = v.to(ptr.base.dtype)
    m = T._v(mask) if mask is not None else \
        torch.ones_like(ptr.offs, dtype=torch.bool)
    ptr.base[ptr.offs[m]] = v[m]


def _full(shape, value, dtype):
    return T(torch.full(tuple(shape), value, dtype=dtype))


def _where(c, a, b):
    c, a, b = T._v(c), T._v(a), T._v(b)
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        # Triton's integer constants are int32
        a = torch.full_like(c, a, dtype=torch.int32)
    return T(torch.where(c, a, b))


def _div_rn(a, b):
    return T(T._v(a) / T._v(b))


class _Pid:
    def __init__(self, v):
        self.v = v

    def to(self, dtype):
        return torch.tensor(self.v, dtype=dtype)


_STATE = {"pid": 0}

tl = types.SimpleNamespace(
    int1=torch.bool, int8=torch.int8, uint8=torch.uint8,
    int16=torch.int16, int32=torch.int32, int64=torch.int64,
    float32=torch.float32, float64=torch.float64,
    constexpr=int,
    program_id=lambda axis: _Pid(_STATE["pid"]),
    arange=lambda a, b: T(torch.arange(a, b, dtype=torch.int32)),
    load=_load, store=_store, full=_full, where=_where,
    abs=lambda x: T(torch.abs(T._v(x))),
    floor=lambda x: T(torch.floor(T._v(x))),
    sqrt=lambda x: T(torch.sqrt(T._v(x))),
    ceil=lambda x: T(torch.ceil(T._v(x))),
    minimum=lambda a, b: T(torch.minimum(T._v(a), T._v(b))),
    maximum=lambda a, b: T(torch.maximum(T._v(a), T._v(b))),
    math=types.SimpleNamespace(
        div_rn=_div_rn, sqrt_rn=lambda x: T(torch.sqrt(T._v(x)))),
)


class _Jit:
    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def __getitem__(self, grid):
        def launch(*args, BLOCK, num_warps=4, enable_fp_fusion=True):
            conv = [Ptr(a) if isinstance(a, torch.Tensor) else a
                    for a in args]
            for pid in range(grid[0]):
                _STATE["pid"] = pid
                self.fn(*conv, BLOCK=BLOCK)
        return launch


def _jit(fn=None, **kwargs):
    if fn is None:
        return _Jit
    return _Jit(fn)


triton = types.SimpleNamespace(jit=_jit,
                               cdiv=lambda a, b: (a + b - 1) // b)


#: libdevice's functions, as PyTorch's CPU kernels compute them (on the
#: card both sides call the CUDA math library)
libdevice = types.SimpleNamespace(**{
    name: (lambda f: lambda *xs: T(f(*(T._v(x) for x in xs))))(
        getattr(torch, name))
    for name in ("exp", "log", "log2", "log10", "log1p", "expm1", "sin",
                 "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
                 "tanh", "atan2", "pow", "fmod")})


def load_source(source: str):
    """The `fragment_kernel` of a generated source, with `triton`, `tl`
    and `libdevice` bound to the stand-ins (its import lines
    dropped)."""
    from presto_tpu_torch.expr.codegen import LIBDEVICE_IMPORT
    body = "\n".join(line for line in
                     source.replace(LIBDEVICE_IMPORT, "").splitlines()
                     if not line.startswith("import triton"))
    g = {"triton": triton, "tl": tl, "libdevice": libdevice}
    exec(compile(body, "<fragment>", "exec"), g)
    return g["fragment_kernel"]


def run(kernel, batch, block: int = 1024):
    """Run a codegen.FragmentKernel's generated source over a CPU
    batch with the stand-in; returns the output batch."""
    fn = load_source(kernel.source)
    n, args, outs = kernel.prepare(batch)
    if n > 0 and outs:
        fn[(triton.cdiv(n, block),)](*args, BLOCK=block)
    return kernel.assemble(batch, outs)
