"""K12's generator (presto_tpu_torch/expr/lowering.py and
expr/codegen.py) on the CPU, where no Triton exists:

(a) every chain (lone FilterProjects, collapsed chains, chains fused
    into a terminal, the join's pre-chain and tail) and every
    aggregation expression set that TPC-H Q1-Q22 plan lowers fully;
(b) every generated source parses and imports only `triton`;
(c) a stand-in for `triton.language` (tests/triton_standin.py, with
    Triton's truncating integer `//` and `%` and uint8-borne booleans)
    runs the generated kernel block by block over CPU tensors, and the
    result equals the composed form exactly, per lowered operation over
    seeded inputs with NULLs, pre-1970 dates, zero divisors and a NULL
    in an IN list, for every scalar function the compiler knows, and
    for every distinct kernel Q1-Q22 launch;
(d) a function with no lowering is named, and a chain holding one
    raises on a CUDA batch instead of running the composed form."""

import ast

import pytest
import torch

from tpch_queries import QUERIES

import triton_standin as standin
from torch_fragment_cases import (
    CASES, assert_batches_equal, function_calls, function_stage,
    port_batch, port_body,
)

from presto_tpu_torch import types as PT
from presto_tpu_torch.expr import codegen, lowering
from presto_tpu_torch.expr import ir as PIR
from presto_tpu_torch.operators.fused_fragment import (
    make_chain_body as port_body_of,
)

# one intra-op thread: see tests/test_torch_tpch.py
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runner():
    from presto_tpu_torch.runner import LocalRunner
    return LocalRunner("tpch", "tiny", device="cpu")


def _plan(runner, qn):
    from presto_tpu_torch.parser import parse_statement
    from presto_tpu_torch.planner.local_planner import LocalExecutionPlanner
    plan = runner._plan_query(parse_statement(QUERIES[qn]))
    return LocalExecutionPlanner(runner.catalogs, runner.session,
                                 runner.device).plan(plan).pipelines


def _chain_bodies(pipelines):
    """(label, ChainBody) of every chain kernel a plan runs."""
    from presto_tpu_torch.operators import fused_fragment as ff
    from presto_tpu_torch.operators.aggregation import (
        AggregationOperatorFactory, StreamingAggregationOperatorFactory,
    )
    from presto_tpu_torch.operators.core import FilterProjectOperatorFactory
    from presto_tpu_torch.operators.join_ops import LookupJoinOperatorFactory
    out = []
    for pipe in pipelines:
        for f in pipe:
            if isinstance(f, (FilterProjectOperatorFactory,
                              ff.FusedChainOperatorFactory)):
                out.append((f.name, f._kernel))
            elif isinstance(f, (ff.FusedLimitOperatorFactory,
                                ff.FusedTopNOperatorFactory,
                                ff.FusedDistinctOperatorFactory)):
                out.append((f.name, f._body))
            elif isinstance(f, (AggregationOperatorFactory,
                                StreamingAggregationOperatorFactory)):
                if f._step_kernel.body is not None:
                    out.append((f.name, f._step_kernel.body))
            elif isinstance(f, LookupJoinOperatorFactory):
                probe, _ = f._build_kernels()
                for body in (probe.pre, probe.tail):
                    if body is not None:
                        out.append((f.name, body))
    return out


def _agg_exprs(pipelines):
    from presto_tpu_torch.operators.aggregation import (
        AggregationOperatorFactory, StreamingAggregationOperatorFactory,
    )
    for pipe in pipelines:
        for f in pipe:
            if isinstance(f, (AggregationOperatorFactory,
                              StreamingAggregationOperatorFactory)):
                yield from f.key_exprs
                for s in f.specs:
                    yield from (e for e in (s.input, s.mask)
                                if e is not None)


@pytest.mark.parametrize("qn", sorted(QUERIES))
def test_tpch_chains_lower_fully(runner, qn):
    pipelines = _plan(runner, qn)
    bodies = _chain_bodies(pipelines)
    assert bodies
    for label, body in bodies:
        assert body.not_lowered is None, (label, body.not_lowered)
        codegen.ChainPlan(body.stages)
    for ce in _agg_exprs(pipelines):
        assert ce.lowering is not None, ce.not_lowered


@pytest.mark.parametrize("qn", sorted(QUERIES))
def test_tpch_sources_parse_and_import_only_triton(runner, qn):
    for label, body in _chain_bodies(_plan(runner, qn)):
        src = body.kernel.source
        tree = ast.parse(src)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert all(n == "triton" or n.startswith("triton.")
                       for n in names), (label, names)
        assert "def fragment_kernel(" in src


def test_emitter_covers_every_lowered_op():
    assert codegen.EMITTED_OPS == lowering.OPS


@pytest.mark.parametrize("cap", [1, 3000])
@pytest.mark.parametrize("case", sorted(CASES))
def test_standin_kernel_matches_composed(case, cap):
    body = port_body(case)
    assert body.not_lowered is None
    batch = port_batch(cap, 7)
    assert_batches_equal(standin.run(body.kernel, batch),
                         body.plain(batch))


@pytest.mark.parametrize("case", sorted(CASES))
def test_lowering_keeps_the_closure_dtypes(case):
    """Every expression's lowered result dtype is the dtype its closure
    returns on a real batch."""
    batch = port_batch(64, 3)
    env = {n: (c.data, c.mask) for n, c in batch.columns.items()}
    for st in port_body(case).stages[:1]:
        exprs = ([st.filter_expr] if st.filter_expr is not None else []) \
            + [ce for _, ce in st.projections]
        for ce in exprs:
            d, m = ce.fn(env)
            assert ce.lowering[0].dtype == d.dtype
            assert ce.lowering[1].dtype == m.dtype == torch.bool


@pytest.mark.parametrize("qn", sorted(QUERIES))
def test_tpch_kernels_match_composed_through_standin(runner, qn,
                                                     monkeypatch):
    """The largest call of every distinct kernel a query launches, run
    through the stand-in, equals its composed form."""
    from presto_tpu_torch.operators import fused_fragment as ff
    seen = {}
    orig = ff.ChainBody.__call__

    def capture(self, batch):
        fp = self.kernel.fingerprint
        if fp not in seen or seen[fp][1].capacity < batch.capacity:
            seen[fp] = (self, batch)
        return orig(self, batch)
    monkeypatch.setattr(ff.ChainBody, "__call__", capture)
    runner.execute(QUERIES[qn])
    assert seen
    for body, batch in seen.values():
        assert_batches_equal(standin.run(body.kernel, batch),
                             body.plain(batch))


def _round_by_column():
    """round(x, d) with the digits in a column: its closure scales by
    a per-row power of ten, which has no lowering."""
    from presto_tpu_torch.expr import ir
    from presto_tpu_torch.expr.compile import compile_expression
    from presto_tpu_torch.schema import ColumnSchema
    from presto_tpu_torch.types import BIGINT, DOUBLE
    schema = {"d": ColumnSchema("d", BIGINT), "x": ColumnSchema("x", DOUBLE)}
    return schema, compile_expression(
        ir.call("round", DOUBLE, ir.ref("x", DOUBLE), ir.ref("d", BIGINT)),
        schema)


def test_unlowered_function_is_named():
    from presto_tpu_torch.expr import ir
    from presto_tpu_torch.expr.compile import compile_expression
    from presto_tpu_torch.types import DOUBLE
    schema, ce = _round_by_column()
    assert ce.lowering is None and ce.not_lowered == "round"
    ok = compile_expression(
        ir.call("round", DOUBLE, ir.ref("x", DOUBLE)), schema)
    assert ok.lowering is not None


class _CudaBatch:
    """A CPU batch that reports a CUDA device: what K12's wrapper checks
    before it generates anything."""

    def __init__(self, batch):
        self._b = batch

    def __getattr__(self, name):
        return getattr(self._b, name)

    @property
    def device(self):
        return torch.device("cuda")


def test_chain_with_unlowered_function_raises_on_the_card(monkeypatch):
    """A chain holding an unlowered function runs composed on the CPU;
    on a CUDA batch K12's wrapper raises, naming the function, and the
    composed form does not run. (exp is made unlowerable here by
    computing it through erf, which has no lowering: every scalar
    function the compiler knows now lowers.)"""
    from presto_tpu_torch.batch import Batch, Column
    from presto_tpu_torch.expr import compile as C
    from presto_tpu_torch.expr import ir
    from presto_tpu_torch.operators.fused_fragment import (
        ChainStage, make_chain_body,
    )
    from presto_tpu_torch.schema import ColumnSchema
    from presto_tpu_torch.types import DOUBLE
    monkeypatch.setitem(C._MATH_FNS, "exp", torch.special.erf)
    ce = C.compile_expression(ir.call("exp", DOUBLE, ir.ref("x", DOUBLE)),
                              {"x": ColumnSchema("x", DOUBLE)})
    body = make_chain_body([ChainStage(None, (("o", ce),), None)])
    assert body.not_lowered == "exp"
    n = 8
    batch = Batch({"x": Column(torch.arange(n, dtype=torch.float64) / 7,
                               torch.ones(n, dtype=torch.bool), DOUBLE)},
                  torch.ones(n, dtype=torch.bool))
    out = body(batch)
    assert torch.equal(out.columns["o"].data,
                       torch.special.erf(batch.columns["x"].data))
    with pytest.raises(codegen.FragmentError, match="exp"):
        body(_CudaBatch(batch))
    with pytest.raises(codegen.FragmentError, match="exp"):
        body.kernel.source


def test_a_closure_fault_is_not_a_missing_lowering(monkeypatch):
    """An exception other than Unlowerable, raised while a closure runs
    over symbolic columns, is a fault: it propagates out of the
    compiler instead of marking the expression unlowered."""
    from presto_tpu_torch.expr import compile as C
    from presto_tpu_torch.expr import ir
    from presto_tpu_torch.schema import ColumnSchema
    from presto_tpu_torch.types import DOUBLE

    def broken(x):
        raise ZeroDivisionError("a fault")
    monkeypatch.setitem(C._MATH_FNS, "sqrt", broken)
    with pytest.raises(ZeroDivisionError):
        C.compile_expression(ir.call("sqrt", DOUBLE, ir.ref("x", DOUBLE)),
                             {"x": ColumnSchema("x", DOUBLE)})


_FUNCTIONS = function_calls(PIR, PT)


@pytest.mark.parametrize("label", sorted(_FUNCTIONS))
def test_every_scalar_function_lowers(label):
    """Every scalar function the compiler knows lowers over the case
    columns, and the stand-in equals the composed form. Exactly, except
    for the CUDA math library's functions (op "libm"): on the CPU
    PyTorch's own result for them depends on where a value sits (its
    vectorized loop and its scalar tail differ in the last bit), so the
    stand-in is held to 1 ulp there. On the card both sides call
    libdevice and tests/test_torch_cuda.py holds them exactly."""
    st = function_stage(_FUNCTIONS[label])
    ce = st.projections[0][1]
    assert ce.lowering is not None, ce.not_lowered
    body = port_body_of([st])
    batch = port_batch(3000, 5)
    got, want = standin.run(body.kernel, batch), body.plain(batch)
    if any(n.op == "libm" for n in lowering.walk(ce.lowering)):
        g, w = got.columns["o"], want.columns["o"]
        assert torch.equal(got.row_valid, want.row_valid)
        assert torch.equal(g.mask, w.mask)
        torch.testing.assert_close(g.data[w.mask], w.data[w.mask],
                                   rtol=2.0 ** -52, atol=0.0,
                                   equal_nan=True)
    else:
        assert_batches_equal(got, want)
