"""K12 `fragment`: the generated Triton kernel of a filter/project
chain (replaces the reference's traced chain programs:
presto_tpu/operators/fused_fragment.py:187 `make_chain_body` and its
one-stage form, presto_tpu/operators/core.py:141
`make_filter_project_kernel`, both compiled by XLA).

From a list of chain stages — each (filter, projection forest, input
dictionaries) — the generator emits the source of ONE `@triton.jit`
kernel: a 1-D grid over the batch capacity in BLOCK rows; each
referenced input column's data and mask is loaded once; every stage is
evaluated in registers, its outputs feeding the next stage without a
store; the kernel stores `row_valid`, then the data and mask of every
output that is not a plain pass-through (a pass-through output aliases
its input tensors, as the composed form does). It reads and writes
each column once, so its bound is bytes: the columns read plus the
columns written, over the card's memory rate.

The expressions come from each `CompiledExpr.lowering` (expr/
lowering.py), so the promotion and NULL rules are the closures' own.
Where Triton's arithmetic differs from PyTorch's eager ops, the source
spells PyTorch's out: integer `//` and `%` floor (Triton truncates),
float32 division rounds to nearest (`div_rn`), booleans travel as
uint8 0/1, float constants are written so they round-trip, float32
square roots round to nearest (`sqrt_rn`), shifts by a negative count
or one past the width give PyTorch's 0 or sign fill, and the kernel is
compiled with FMA contraction off. Transcendental float64 functions
and the float64 remainder call the CUDA math library (libdevice), as
PyTorch's CUDA kernels do.

The source is written to `presto_tpu_torch/_build/fragments/
<fingerprint>.py` (Triton's `jit` reads its function's source file)
and imported from there; Triton caches its builds under
`presto_tpu_torch/_build/triton/`. `triton` is imported only when a
kernel is first launched, so this module imports on machines without
it. A kernel that fails to generate, compile or launch raises: there
is no fallback to the composed form on the card.
"""

from __future__ import annotations

import hashlib
import importlib.util
import math
import os
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from presto_tpu_torch.expr.lowering import LNode, substitute, walk
from presto_tpu_torch.telemetry.kernels import LaunchCounter

_PKG = Path(__file__).resolve().parent.parent
FRAGMENT_DIR = _PKG / "_build" / "fragments"
TRITON_CACHE = _PKG / "_build" / "triton"

#: rows per program and warps per program of every generated kernel
BLOCK = 1024
NUM_WARPS = 4

COUNTER = LaunchCounter("fragment", family="fragment")

#: first launches of generated kernels (each compiles its kernel, or
#: loads Triton's cached build): count and host seconds
COMPILES = {"count": 0, "seconds": 0.0}

#: when a dict, every launch records its inputs here, keeping the
#: largest call (by capacity) of each distinct kernel:
#: fingerprint -> (capacity, FragmentKernel, Batch); a call with nothing
#: to store launches nothing and records nothing
CAPTURE: Optional[dict] = None

_TL = {
    torch.bool: "tl.int1", torch.int8: "tl.int8", torch.uint8: "tl.uint8",
    torch.int16: "tl.int16", torch.int32: "tl.int32",
    torch.int64: "tl.int64", torch.float32: "tl.float32",
    torch.float64: "tl.float64",
}

#: ops the emitter implements (tests hold it equal to lowering.OPS)
EMITTED_OPS = frozenset({
    "and", "or", "xor", "not", "invert", "eq", "ne", "lt", "le", "gt",
    "ge", "add", "sub", "mul", "div", "floordiv", "truncdiv", "mod",
    "neg", "abs", "sign", "minimum", "maximum", "clamp", "trunc",
    "floor", "ceil", "round", "isnan", "isinf", "isfinite", "sqrt",
    "shl", "shr", "libm", "cast", "where", "gather",
})

#: the import of Triton's libdevice bindings, emitted into a kernel
#: that calls the CUDA math library
LIBDEVICE_IMPORT = """\
try:
    from triton.language.extra import libdevice
except ImportError:
    from triton.language.extra.cuda import libdevice
"""

_HEADER = '''\
import triton
import triton.language as tl


@triton.jit
def _floordiv(a, b):
    q = a // b
    return tl.where((q * b != a) & ((a < 0) != (b < 0)), q - 1, q)


@triton.jit
def _floormod(a, b):
    r = a % b
    return tl.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


@triton.jit
def _trunc(x):
    return tl.where(x < 0, tl.ceil(x), tl.floor(x))


@triton.jit
def _rint(x):
    f = tl.floor(x)
    d = x - f
    h = f * 0.5
    odd = tl.floor(h) != h
    return tl.where(d > 0.5, f + 1.0,
                    tl.where(d < 0.5, f, tl.where(odd, f + 1.0, f)))


@triton.jit
def _fmin(a, b):
    return tl.where(a != a, a, tl.where(b != b, b, tl.where(b < a, b, a)))


@triton.jit
def _fmax(a, b):
    return tl.where(a != a, a, tl.where(b != b, b, tl.where(b > a, b, a)))
'''


class FragmentError(Exception):
    """A chain cannot be generated (an expression has no lowering) or
    the kernel was given a batch it does not take."""


# -- the chain as one DAG -------------------------------------------------


class ChainPlan:
    """The lowered chain: input leaves, the final row_valid node and
    the outputs [(name, data node, mask node, type, dictionary)]."""

    def __init__(self, stages):
        for st in stages:
            for ce in stage_exprs(st):
                if ce.lowering is None:
                    raise FragmentError(
                        f"no lowering for {ce.not_lowered!r}")
        # the first stage's column leaves: data read at one dtype, the
        # mask as bool (a column may be read for its mask alone)
        inputs: Dict[str, list] = {}
        for ce in stage_exprs(stages[0]):
            for n in walk(ce.lowering):
                if n.op not in ("col", "mask"):
                    continue
                leaves = inputs.setdefault(
                    n.value, [None, LNode("mask", torch.bool,
                                          value=n.value)])
                if n.op == "col":
                    if leaves[0] is not None \
                            and leaves[0].dtype != n.dtype:
                        raise FragmentError(
                            f"column {n.value!r} read as "
                            f"{leaves[0].dtype} and {n.dtype}")
                    leaves[0] = LNode("col", n.dtype, value=n.value)
        inputs = {k: tuple(v) for k, v in inputs.items()}
        env = dict(inputs)
        rv = LNode("rv", torch.bool)
        outputs = []
        for st in stages:
            memo: Dict[int, LNode] = {}
            if st.filter_expr is not None:
                d, m = (substitute(x, env, memo)
                        for x in st.filter_expr.lowering)
                keep = LNode("and", torch.bool, (d, m))
                rv = LNode("and", torch.bool, (rv, keep))
            outputs = []
            for name, ce in st.projections:
                d, m = (substitute(x, env, memo) for x in ce.lowering)
                dt = d.dtype if st.raw else ce.type.torch_dtype
                if d.dtype != dt:
                    d = LNode("cast", dt, (d,))
                outputs.append((name, d, m, ce.type, ce.dictionary))
            env = {name: (d, m) for name, d, m, _, _ in outputs}
        self.inputs = inputs
        self.rv = rv
        self.outputs = outputs


def stage_exprs(st):
    """A chain stage's expressions: its filter, then its projections."""
    return ([st.filter_expr] if st.filter_expr is not None else []) \
        + [ce for _, ce in st.projections]


# -- source emission ------------------------------------------------------


def _lit(value, dt: torch.dtype) -> str:
    """A Triton block constant of `value` in dtype `dt`."""
    if dt == torch.bool:
        return f"(tl.full([BLOCK], {1 if value else 0}, tl.int8) != 0)"
    if dt.is_floating_point:
        v = float(value)
        text = repr(v) if math.isfinite(v) else f"float('{v!r}')"
        return f"tl.full([BLOCK], {text}, {_TL[dt]})"
    return f"tl.full([BLOCK], {int(value)}, {_TL[dt]})"


def _conv(expr: str, frm: torch.dtype, to: torch.dtype) -> str:
    if frm == to:
        return expr
    if to == torch.bool:
        return f"({expr} != 0)"
    if frm == torch.bool:
        return f"tl.where({expr}, 1, 0).to({_TL[to]})"
    return f"{expr}.to({_TL[to]})"


class _Emitter:
    def __init__(self, plan: ChainPlan):
        self.plan = plan
        self.lines: List[str] = []
        self.vars: Dict[int, str] = {}
        self.params: List[str] = ["n", "rv_in"]
        #: (kind, key) of every pointer parameter after n, in order
        self.args: List[tuple] = [("rv", None)]
        self.tables: List[torch.Tensor] = []
        self._table_ix: Dict[int, int] = {}
        self._col_ix: Dict[Tuple[str, str], str] = {}
        #: whether the kernel loads row_valid (a chain with no filter
        #: passes it through)
        self.reads_rv = False

    def operand(self, n: LNode, dt: torch.dtype) -> str:
        if n.op == "const":
            return _lit(n.value, dt)
        return _conv(self.vars[id(n)], n.dtype, dt)

    def _pointer(self, kind: str, name: str) -> str:
        key = (kind, name)
        p = self._col_ix.get(key)
        if p is None:
            p = f"in{len(self._col_ix)}_{'d' if kind == 'col' else 'm'}"
            self._col_ix[key] = p
            self.params.append(p)
            self.args.append((kind, name))
        return p

    def _table(self, t: torch.Tensor) -> str:
        ix = self._table_ix.get(id(t))
        if ix is None:
            ix = len(self.tables)
            self._table_ix[id(t)] = ix
            self.tables.append(t)
            self.params.append(f"t{ix}")
            self.args.append(("table", ix))
        return f"t{ix}"

    def emit(self, n: LNode) -> None:
        if id(n) in self.vars or n.op in ("const", "table"):
            return
        op, dt, cdt = n.op, n.dtype, n.cdt
        a = n.args
        if op in ("col", "mask", "rv"):
            self.reads_rv |= op == "rv"
            ptr = "rv_in" if op == "rv" else self._pointer(op, n.value)
            load = f"tl.load({ptr} + offs, mask=inb, other=0)"
            expr = f"({load} != 0)" if dt == torch.bool else load
        elif op == "cast":
            expr = self.operand(a[0], dt)
        elif op in ("and", "or", "xor"):
            sym = {"and": "&", "or": "|", "xor": "^"}[op]
            expr = f"({self.operand(a[0], cdt)} {sym} " \
                   f"{self.operand(a[1], cdt)})"
            expr = _conv(expr, cdt, dt)
        elif op == "not":
            expr = f"({self.operand(a[0], torch.bool)} == 0)"
        elif op == "invert":
            expr = f"(~{self.operand(a[0], dt)})"
        elif op in ("eq", "ne", "lt", "le", "gt", "ge"):
            sym = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=",
                   "gt": ">", "ge": ">="}[op]
            expr = f"({self.operand(a[0], cdt)} {sym} " \
                   f"{self.operand(a[1], cdt)})"
        elif op in ("add", "sub", "mul"):
            sym = {"add": "+", "sub": "-", "mul": "*"}[op]
            expr = f"({self.operand(a[0], dt)} {sym} " \
                   f"{self.operand(a[1], dt)})"
        elif op == "div":
            x, y = self.operand(a[0], dt), self.operand(a[1], dt)
            expr = f"tl.math.div_rn({x}, {y})" if dt == torch.float32 \
                else f"({x} / {y})"
        elif op == "mod" and dt.is_floating_point:
            # PyTorch's remainder: fmod, moved to the divisor's sign
            x, y = self.operand(a[0], dt), self.operand(a[1], dt)
            y = self._temp(y)
            r = self._temp(f"libdevice.fmod({x}, {y})")
            expr = f"tl.where(({r} != 0) & (({r} < 0) != ({y} < 0)), " \
                   f"{r} + {y}, {r})"
        elif op == "libm":
            expr = f"libdevice.{n.value}(" + ", ".join(
                self.operand(x, dt) for x in a) + ")"
        elif op in ("floordiv", "mod"):
            fn = "_floordiv" if op == "floordiv" else "_floormod"
            expr = f"{fn}({self.operand(a[0], dt)}, " \
                   f"{self.operand(a[1], dt)})"
        elif op == "truncdiv":
            x, y = self.operand(a[0], dt), self.operand(a[1], dt)
            if dt.is_floating_point:
                q = f"tl.math.div_rn({x}, {y})" if dt == torch.float32 \
                    else f"({x} / {y})"
                expr = f"_trunc({q})"
            else:
                expr = f"({x} // {y})"
        elif op == "neg":
            expr = f"(-{self.operand(a[0], dt)})"
        elif op == "abs":
            expr = f"tl.abs({self.operand(a[0], dt)})"
        elif op == "sign":
            x = self.operand(a[0], a[0].dtype)
            expr = f"(tl.where({x} > 0, 1, 0) - tl.where({x} < 0, 1, 0))" \
                   f".to({_TL[dt]})"
        elif op in ("minimum", "maximum"):
            x, y = self.operand(a[0], dt), self.operand(a[1], dt)
            if dt.is_floating_point:
                expr = f"{'_fmin' if op == 'minimum' else '_fmax'}({x}, {y})"
            else:
                expr = f"tl.{op}({x}, {y})"
        elif op == "clamp":
            expr = self.operand(a[0], dt)
            if a[1] is not None:
                lo = self.operand(a[1], dt)
                expr = self._temp(f"tl.where({expr} < {lo}, {lo}, {expr})")
            if a[2] is not None:
                hi = self.operand(a[2], dt)
                expr = f"tl.where({expr} > {hi}, {hi}, {expr})"
        elif op in ("trunc", "floor", "ceil", "round"):
            x = self.operand(a[0], dt)
            if not dt.is_floating_point:
                expr = x
            else:
                expr = {"trunc": f"_trunc({x})", "floor": f"tl.floor({x})",
                        "ceil": f"tl.ceil({x})",
                        "round": f"_rint({x})"}[op]
        elif op == "isnan":
            x = self.operand(a[0], a[0].dtype)
            expr = f"({x} != {x})"
        elif op in ("isinf", "isfinite"):
            x = self.operand(a[0], a[0].dtype)
            inf = _lit(math.inf, a[0].dtype)
            expr = f"(tl.abs({x}) == {inf})" if op == "isinf" \
                else f"(({x} == {x}) & (tl.abs({x}) != {inf}))"
        elif op == "sqrt":
            x = self.operand(a[0], dt)
            # tl.sqrt is approximate on float32; float64's is IEEE
            expr = f"tl.math.sqrt_rn({x})" if dt == torch.float32 \
                else f"tl.sqrt({x})"
        elif op in ("shl", "shr"):
            x, y = self.operand(a[0], dt), self.operand(a[1], dt)
            y = self._temp(y)
            bits = 8 * torch.empty((), dtype=dt).element_size()
            if op == "shl":
                # PyTorch: a count < 0 or >= the width gives 0
                bad = self._temp(f"({y} < 0) | ({y} >= {bits})")
                s = self._temp(f"tl.where({bad}, 0, {y})")
                expr = f"tl.where({bad}, {_lit(0, dt)}, {x} << {s})"
            else:
                # PyTorch: a count < 0 or >= width - 1 fills the sign
                top = bits - 1
                expr = f"({x} >> tl.where(({y} < 0) | ({y} > {top}), " \
                       f"{top}, {y}))"
        elif op == "where":
            expr = f"tl.where({self.operand(a[0], torch.bool)}, " \
                   f"{self.operand(a[1], dt)}, {self.operand(a[2], dt)})"
        elif op == "gather":
            t = self._table(a[0].value)
            idx = self.operand(a[1], torch.int64)
            load = f"tl.load({t} + {idx})"
            expr = f"({load} != 0)" if dt == torch.bool else load
        else:
            raise FragmentError(f"no emitter for {op!r}")
        self._assign(n, expr)

    def _temp(self, expr: str) -> str:
        v = f"v{len(self.lines)}"
        self.lines.append(f"    {v} = {expr}")
        return v

    def _assign(self, n: LNode, expr: str) -> None:
        self.vars[id(n)] = self._temp(expr)

    def source(self) -> Tuple[str, List[tuple]]:
        """(kernel source, stored outputs [(param, name, kind,
        dtype)]). A chain with nothing to store (every output a
        pass-through) is not launched."""
        plan = self.plan
        # a pass-through aliases its input tensor: only the outputs
        # that compute something are stored, and only what they read
        # is loaded
        todo = [(plan.rv, None, "rv")]
        for name, d, m, _, _ in plan.outputs:
            todo += [(d, name, "data"), (m, name, "mask")]
        todo = [t for t in todo if t[0].op not in ("col", "mask", "rv")]
        for n in walk([node for node, _, _ in todo]):
            self.emit(n)
        stores: List[tuple] = []
        out_lines: List[str] = []
        for node, name, kind in todo:
            p = f"out{len(stores)}"
            self.params.append(p)
            stores.append((p, name, kind, node.dtype))
            val = self.operand(node, node.dtype)
            if node.dtype == torch.bool:
                val = f"tl.where({val}, 1, 0).to(tl.uint8)"
            out_lines.append(f"    tl.store({p} + offs, {val}, mask=inb)")
        body = self.lines + out_lines
        sig = ", ".join(self.params)
        libm = any("libdevice." in line for line in body)
        src = (_HEADER + (LIBDEVICE_IMPORT if libm else "") + "\n\n"
               + "@triton.jit(do_not_specialize=[\"n\"])\n"
               + f"def fragment_kernel({sig}, BLOCK: tl.constexpr):\n"
               + "    pid = tl.program_id(0)\n"
               + "    offs = pid.to(tl.int64) * BLOCK "
               + "+ tl.arange(0, BLOCK)\n"
               + "    inb = offs < n\n"
               + "\n".join(body) + "\n")
        return src, stores


def generate(stages) -> Tuple[str, "ChainPlan", _Emitter, List[tuple]]:
    """(source, plan, emitter, stores) of the kernel of `stages`."""
    plan = ChainPlan(stages)
    em = _Emitter(plan)
    src, stores = em.source()
    labels = " | ".join(_stage_label(st) for st in stages)
    src = f"# fragment kernel of: {labels}\n" + src
    return src, plan, em, stores


def _stage_label(st) -> str:
    return ("filter+" if st.filter_expr is not None else "") \
        + f"{len(st.projections)} projections"


def fingerprint(source: str) -> str:
    return hashlib.blake2b(source.encode(), digest_size=12).hexdigest()


# -- loading --------------------------------------------------------------

_LOCK = threading.Lock()
#: fingerprint -> the imported @triton.jit function
_LOADED: Dict[str, object] = {}
#: fingerprints of the kernels launched at least once in this process
LAUNCHED: set = set()


_TRITON = None


def _import_triton():
    """`triton`, imported at the first launch with its cache pointed
    into the package's build directory."""
    global _TRITON
    if _TRITON is None:
        os.environ["TRITON_CACHE_DIR"] = str(TRITON_CACHE)
        TRITON_CACHE.mkdir(parents=True, exist_ok=True)
        import triton  # noqa: F401 — on the card only
        _TRITON = triton
    return _TRITON


def load(source: str, name: str = "fragment_kernel"):
    """The @triton.jit function `name` of a source, written under
    _build/fragments/ and imported from there (once per process)."""
    fp = fingerprint(source)
    with _LOCK:
        mod = _LOADED.get(fp)
        if mod is None:
            _import_triton()
            FRAGMENT_DIR.mkdir(parents=True, exist_ok=True)
            path = FRAGMENT_DIR / f"{fp}.py"
            if not path.exists() or path.read_text() != source:
                tmp = path.with_suffix(f".{os.getpid()}.tmp")
                tmp.write_text(source)
                os.replace(tmp, path)
            spec = importlib.util.spec_from_file_location(
                f"presto_fragment_{fp}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _LOADED[fp] = mod
        return getattr(mod, name)


# -- the kernel -----------------------------------------------------------


class FragmentKernel:
    """K12 for one chain: `kernel(batch) -> batch` on a CUDA batch.
    Generation happens at the first call; the launch checks devices,
    dtypes and contiguity, allocates the outputs with torch.empty and
    counts on `COUNTER`."""

    def __init__(self, stages):
        self.stages = tuple(stages)
        self._gen = None
        self._fn = None   # the loaded @triton.jit function
        #: (table index, device) -> the lookup table on that device
        self._tables: Dict[tuple, torch.Tensor] = {}

    def _generated(self):
        if self._gen is None:
            src, plan, em, stores = generate(self.stages)
            self._gen = (src, plan, em, stores, fingerprint(src))
        return self._gen

    @property
    def source(self) -> str:
        return self._generated()[0]

    @property
    def fingerprint(self) -> str:
        return self._generated()[4]

    def io_bytes(self, batch) -> int:
        """Bytes the kernel must move for `batch`: each column it loads
        and each column it stores, once."""
        src, plan, em, stores, _ = self._generated()
        n = batch.capacity
        total = n if em.reads_rv else 0
        for kind, key in em.args[1:]:
            if kind == "col":
                total += n * batch.columns[key].data.element_size()
            elif kind == "mask":
                total += n
            else:
                t = em.tables[key]
                total += t.numel() * t.element_size()
        for _, _, _, dt in stores:
            total += n * torch.empty((), dtype=dt).element_size()
        return total

    def prepare(self, batch):
        """(capacity, kernel arguments, output tensors) for `batch`,
        after checking that every column the kernel reads is there, of
        the dtype it reads, contiguous and on the batch's device.
        Outputs are allocated with torch.empty; booleans travel as
        uint8 views."""
        src, plan, em, stores, fp = self._generated()
        dev = batch.device
        n = batch.capacity
        args = [n]
        for kind, key in em.args:
            if kind == "rv":
                t = batch.row_valid
            elif kind == "table":
                t = self._table_on(em.tables, key, dev)
            else:
                col = batch.columns.get(key)
                if col is None:
                    raise FragmentError(f"fragment kernel: no column "
                                        f"{key!r}")
                t = col.data if kind == "col" else col.mask
                want = plan.inputs[key][0 if kind == "col" else 1].dtype
                if t.dtype != want:
                    raise FragmentError(
                        f"fragment kernel: column {key!r} is {t.dtype}, "
                        f"the kernel reads {want}")
            if t.device != dev:
                raise FragmentError(
                    f"fragment kernel: {kind} {key!r} on {t.device}, "
                    f"the batch on {dev}")
            if not t.is_contiguous():
                raise FragmentError(
                    f"fragment kernel: {kind} {key!r} is not contiguous")
            args.append(t.view(torch.uint8) if t.dtype == torch.bool
                        else t)
        outs = {}
        for p, name, kind, dt in stores:
            t = torch.empty(n, dtype=dt, device=dev)
            outs[(name, kind)] = t
            args.append(t.view(torch.uint8) if dt == torch.bool else t)
        return n, args, outs

    def _table_on(self, tables, ix: int, dev) -> torch.Tensor:
        """Lookup table `ix` on `dev`. A table a closure made while it
        ran over symbolic columns lies on the CPU (the date helpers'
        month lengths); it is a constant, copied to the card once."""
        key = (ix, str(dev))
        t = self._tables.get(key)
        if t is None:
            t = tables[ix]
            t = t if t.device == dev else t.to(dev)
            self._tables[key] = t
        return t

    def assemble(self, batch, outs):
        """The output batch: stored outputs, pass-throughs aliased to
        the input tensors."""
        from presto_tpu_torch.batch import Batch, Column
        plan = self._generated()[1]

        def result(node, name, kind):
            t = outs.get((name, kind))
            if t is not None:
                return t
            if node.op == "rv":
                return batch.row_valid
            col = batch.columns[node.value]
            return col.data if node.op == "col" else col.mask

        cols = {name: Column(result(d, name, "data"),
                             result(m, name, "mask"), typ, dic)
                for name, d, m, typ, dic in plan.outputs}
        return Batch(cols, result(plan.rv, None, "rv"))

    def __call__(self, batch):
        if batch.device.type != "cuda":
            raise FragmentError(f"fragment kernel: batch on "
                                f"{batch.device}, not a CUDA device")
        src, fp = self._generated()[0], self._generated()[4]
        n, args, outs = self.prepare(batch)
        if n > 0 and outs:
            if CAPTURE is not None:
                prev = CAPTURE.get(fp)
                if prev is None or prev[0] < n:
                    CAPTURE[fp] = (n, self, batch)
            if self._fn is None:
                self._fn = load(src)
            fn = self._fn
            first = fp not in LAUNCHED
            t0 = time.perf_counter()
            fn[((n + BLOCK - 1) // BLOCK,)](
                *args, BLOCK=BLOCK, num_warps=NUM_WARPS,
                enable_fp_fusion=False)
            if first:
                # the first launch of a generated kernel compiles it
                # (or loads Triton's cached build)
                LAUNCHED.add(fp)
                COMPILES["count"] += 1
                COMPILES["seconds"] += time.perf_counter() - t0
            COUNTER.launches += 1
        return self.assemble(batch, outs)
