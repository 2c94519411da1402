"""Whole-fragment kernel composition (reference:
presto_tpu/operators/fused_fragment.py; the engine's
PageFunctionCompiler / AccumulatorCompiler).

A maximal leaf-fragment chain — scan -> filter -> project -> [join
probe] -> aggregation step / top-N / limit / distinct — runs as ONE
generated kernel per batch (K12, `expr/codegen.py`) ahead of the
terminal's own kernels, so the driver loop degenerates to

    scan batch -> fused kernel(batch) -> emit / fold

Per batch this removes one launch per FilterProject stage, the
intermediate materialization of each stage's output, and the deferred
count/compact round between a selective filter and its consumer. The
terminal's own machinery (overflow retries, partial merging, top-N
state, LIMIT early exit) is untouched: fusion composes the chain in
front of the terminal's step, it does not reimplement the operator
protocol.

Correctness bar: identical rows with fusion off. The chain preserves
row positions (filters only narrow row_valid, exactly like the unfused
FilterProject), dead rows contribute reduce identities, and every
downstream sort or group kernel orders rows stably — so skipping the
intermediate compaction changes shapes, never values or order.
Eligibility is decided by planner/fusion.py, which records a reason for
every chain it declines.

`make_chain_body` is K12 on a CUDA batch and the composed form (the
stages' `CompiledExpr.fn` closures applied in turn) on a CPU batch. The
history-sized compacting form (`compact_ratio`,
`make_compacting_chain_body`, `FusedChainCompactOverflow`) comes with
the history slice (ROADMAP A11): it acts only on measured
selectivities, and the port has no history store yet.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Sequence, Tuple

from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.expr import codegen
from presto_tpu_torch.operators.base import (
    DriverContext, Operator, OperatorContext, OperatorFactory,
)
from presto_tpu_torch.operators.core import (
    FilterProjectOperator, LimitOperator,
)
from presto_tpu_torch.operators.sort_ops import (
    DistinctOperator, TopNOperator,
)
from presto_tpu_torch.ops import sort as sort_kernels
from presto_tpu_torch.telemetry import kernels as _tk


# -- chain stages ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChainStage:
    """One FilterProject link of a fused chain: the (filter, projection
    forest, input-dictionary token) triple the standalone operator
    compiles. `raw` keeps each projection in its closure's own dtype
    (an aggregation's key, input and FILTER expressions evaluated as a
    chain's last stage); a FilterProject casts to the declared type."""
    filter_expr: object  # Optional[CompiledExpr]
    projections: Tuple[Tuple[str, object], ...]
    input_dicts: object
    raw: bool = False


def stages_from_factory(f) -> Optional[Tuple[ChainStage, ...]]:
    """ChainStage of a FilterProjectOperatorFactory, or None when the
    factory carries no expressions."""
    filter_expr = getattr(f, "filter_expr", "missing")
    projections = getattr(f, "projections", None)
    if filter_expr == "missing" or projections is None:
        return None
    return (ChainStage(filter_expr, tuple(projections),
                       getattr(f, "input_dicts", None)),)


def chain_fingerprint(stages: Sequence[ChainStage]):
    """Hashable structural fingerprint of a chain (the kernel-cache key
    component), or None when any expression lacks its IR."""
    from presto_tpu_torch.expr.ir import fingerprint
    out = []
    for st in stages:
        exprs = ([st.filter_expr] if st.filter_expr is not None
                 else []) + [ce for _, ce in st.projections]
        if any(ce.ir is None for ce in exprs):
            return None
        try:
            out.append((
                fingerprint(st.filter_expr.ir)
                if st.filter_expr is not None else None,
                tuple((n, fingerprint(ce.ir), ce.dictionary)
                      for n, ce in st.projections),
                st.input_dicts, st.raw))
        except TypeError:
            return None
    key = tuple(out)
    try:
        hash(key)
    except TypeError:
        return None
    return key


def chain_selective(stages: Sequence[ChainStage]) -> bool:
    return any(st.filter_expr is not None for st in stages)


def chain_not_lowered(stages: Sequence[ChainStage]) -> Optional[str]:
    """The first function of the chain with no lowering, or None."""
    for st in stages:
        for ce in codegen.stage_exprs(st):
            if ce.lowering is None:
                return ce.not_lowered or "?"
    return None


def compose_chain(stages: Sequence[ChainStage], batch: Batch) -> Batch:
    """The composed chain: each stage's filter ANDed into row_valid
    (NULL is false) and its projection forest, one PyTorch op per
    expression node — K12's plain version."""
    for st in stages:
        env = {n: (c.data, c.mask) for n, c in batch.columns.items()}
        cap = batch.capacity
        rv = batch.row_valid
        if st.filter_expr is not None:
            d, m = st.filter_expr.fn(env)
            rv = rv & (d & m).expand(cap)
        cols = {}
        for name, ce in st.projections:
            d, m = ce.fn(env)
            if not st.raw:
                d = d.to(ce.type.torch_dtype)
            # constants come back 0-d: materialize them at full width
            # (no-op views for full-size results)
            cols[name] = Column(d.expand(cap).contiguous(),
                                m.expand(cap).contiguous(), ce.type,
                                ce.dictionary)
        batch = Batch(cols, rv)
    return batch


class ChainBody:
    """batch -> batch over a chain of stages: K12 on a CUDA batch, the
    composed form on a CPU batch (any other device raises in K12's
    wrapper). `family` is the reference kernel family a call counts
    under (`filter_project` for a lone FilterProject, `fragment` for a
    fused chain), or None when the terminal counts.

    A chain holding a function with no lowering (`not_lowered`) is
    never fused (planner/fusion.py records `not_lowered:<fn>`). As a
    lone FilterProject it runs composed on the CPU, and on the card
    K12's wrapper raises FragmentError naming the function: nothing
    runs the composed form on the card."""

    def __init__(self, stages: Sequence[ChainStage],
                 family: Optional[str] = "fragment"):
        self.stages = tuple(stages)
        self.family = family
        self.not_lowered = chain_not_lowered(self.stages)
        self.kernel = codegen.FragmentKernel(self.stages)

    def plain(self, batch: Batch) -> Batch:
        return compose_chain(self.stages, batch)

    def __call__(self, batch: Batch) -> Batch:
        if self.family is not None:
            _tk.count(self.family)
        if batch.device.type == "cpu":
            return self.plain(batch)
        return self.kernel(batch)


def make_chain_body(stages: Sequence[ChainStage],
                    family: Optional[str] = "fragment") -> ChainBody:
    """The chain as one callable: semantically identical to running
    the standalone FilterProject kernels back to back, minus the
    per-stage materialization."""
    return ChainBody(stages, family)


# -- fused-kernel LRU --------------------------------------------------
#
# A re-planned query (or another query with the same chain) reuses the
# chain body, and with it the generated kernel. Compiled expressions
# hold constants on their compile device, so the device is part of the
# key.

_FUSED_KERNEL_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_FUSED_KERNEL_CACHE_MAX = 256


def _cached_fragment_kernel(key, builder):
    if key is not None:
        cached = _FUSED_KERNEL_CACHE.get(key)
        if cached is not None:
            _FUSED_KERNEL_CACHE.move_to_end(key)
            return cached
    kernel = builder()
    if key is not None:
        _FUSED_KERNEL_CACHE[key] = kernel
        while len(_FUSED_KERNEL_CACHE) > _FUSED_KERNEL_CACHE_MAX:
            _FUSED_KERNEL_CACHE.popitem(last=False)
    return kernel


def cached_chain_body(stages: Sequence[ChainStage], chain_key,
                      family: Optional[str] = "fragment") -> ChainBody:
    """make_chain_body through the LRU (uncached when chain_key is
    None). The expressions' compile device is part of the key: their
    constants live there."""
    device = next((ce.device for st in stages
                   for ce in codegen.stage_exprs(st)), None)
    return _cached_fragment_kernel(
        (family, chain_key, str(device)) if chain_key is not None
        else None, lambda: make_chain_body(stages, family))


def clear_fused_kernel_cache() -> None:
    _FUSED_KERNEL_CACHE.clear()


# -- terminal-less chain: N FilterProjects -> one kernel ---------------

class FusedChainOperatorFactory(OperatorFactory):
    """A run of >= 2 adjacent FilterProjects with no fusable terminal
    collapses into ONE FilterProjectOperator driving the chain kernel
    (the deferred-compact protocol runs once, at the chain's tail,
    instead of once per stage)."""

    def __init__(self, operator_id: int, name: str,
                 stages: Sequence[ChainStage], chain_key):
        super().__init__(operator_id, name)
        self.stages = tuple(stages)
        self.chain_key = chain_key
        self._kernel = cached_chain_body(
            stages, ("chain", chain_key) if chain_key is not None
            else None)
        self._selective = chain_selective(stages)

    def create(self, driver_context: DriverContext) -> Operator:
        return FilterProjectOperator(
            OperatorContext(self.operator_id, self.name,
                            driver_context),
            self._kernel, self._selective)


# -- chain -> LIMIT ----------------------------------------------------

class FusedLimitOperator(LimitOperator):
    """chain + LIMIT: only the step differs — the inherited early
    termination protocol (the limit-reached flag read only once its
    copy has landed, so a fused fragment still stops pulling scan
    batches within a couple of driver rounds) is core.LimitOperator's."""

    def __init__(self, ctx: OperatorContext, body: ChainBody, n: int):
        super().__init__(ctx, n)
        self._body = body

    def _step(self, batch: Batch):
        return sort_kernels.limit_batch(self._body(batch), self._n,
                                        self._emitted)


class FusedLimitOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, name: str,
                 stages: Sequence[ChainStage], chain_key, n: int):
        super().__init__(operator_id, name)
        self.n = n
        self._body = cached_chain_body(
            stages, ("limit", chain_key) if chain_key is not None
            else None)

    def create(self, driver_context: DriverContext) -> Operator:
        return FusedLimitOperator(
            OperatorContext(self.operator_id, self.name,
                            driver_context),
            self._body, self.n)


# -- chain -> TopN -----------------------------------------------------

class FusedTopNOperator(TopNOperator):
    """chain + bounded top-N fold: the inherited sort_ops.TopNOperator
    protocol is untouched, only the fold step runs the chain first."""

    def __init__(self, ctx: OperatorContext, body: ChainBody, n: int,
                 key_names: Sequence[str], descending: Sequence[bool],
                 nulls_first: Sequence[bool],
                 schema_cols: Sequence[tuple]):
        super().__init__(ctx, n, tuple(key_names), tuple(descending),
                         tuple(nulls_first), schema_cols)
        self._body = body

    def _step(self, batch: Batch) -> Batch:
        return sort_kernels.topn_step(
            self._state, self._body(batch), self.n, self.key_names,
            self.descending, self.nulls_first)


class FusedTopNOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, name: str,
                 stages: Sequence[ChainStage], chain_key, n: int,
                 key_names: Sequence[str], descending: Sequence[bool],
                 nulls_first: Sequence[bool],
                 schema_cols: Sequence[tuple]):
        super().__init__(operator_id, name)
        self.n = n
        self.schema_cols = schema_cols
        self.key_names = tuple(key_names)
        self.descending = tuple(descending)
        self.nulls_first = tuple(nulls_first)
        self._body = cached_chain_body(
            stages, ("topn", chain_key) if chain_key is not None
            else None)

    def create(self, driver_context: DriverContext) -> Operator:
        return FusedTopNOperator(
            OperatorContext(self.operator_id, self.name,
                            driver_context),
            self._body, self.n, self.key_names, self.descending,
            self.nulls_first, self.schema_cols)


# -- chain -> DISTINCT -------------------------------------------------

class FusedDistinctOperator(DistinctOperator):
    """chain + dedup fold: only the batch-incorporating step runs the
    chain, so it applies to each incoming batch exactly once; the
    inherited grow-on-full protocol re-merges the OLD STATE through the
    unfused step (`distinct_step`), which appends its rows into the
    larger state where they lay."""

    def __init__(self, ctx: OperatorContext, body: ChainBody,
                 schema_cols: Sequence[tuple], capacity: int = 4096):
        super().__init__(ctx, schema_cols, capacity)
        self._body = body

    def _step(self, batch: Batch) -> Batch:
        return sort_kernels.distinct_step(self._state, self._body(batch))


class FusedDistinctOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, name: str,
                 stages: Sequence[ChainStage], chain_key,
                 schema_cols: Sequence[tuple], capacity: int = 4096):
        super().__init__(operator_id, name)
        self.schema_cols = schema_cols
        self.capacity = capacity
        self._body = cached_chain_body(
            stages, ("distinct", chain_key) if chain_key is not None
            else None)

    def create(self, driver_context: DriverContext) -> Operator:
        return FusedDistinctOperator(
            OperatorContext(self.operator_id, self.name,
                            driver_context),
            self._body, self.schema_cols, self.capacity)
