"""Aggregation operator, direct slot-table path (reference:
presto_tpu/operators/aggregation.py; HashAggregationOperator.java:47,
AggregationOperator for global aggregates).

Every batch goes through one step: evaluate the key expressions and
aggregate inputs, then reduce the whole batch into the slot table
(kernel K1 on CUDA, `ops/hashagg.direct_step`). The table stays on the
device until the operator drains; finalize decodes the slots into one
output batch. Only the SINGLE step runs locally in this slice; the
PARTIAL/FINAL split belongs to the distributed slice, and key sets that
are not small dictionary/boolean domains need the sort-based path of
the Q3/Q18 slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.expr.compile import CompiledExpr
from presto_tpu_torch.operators.base import (
    DriverContext, Operator, OperatorContext, OperatorFactory,
)
from presto_tpu_torch.ops import hashagg
from presto_tpu_torch.telemetry import kernels as _tk


@dataclasses.dataclass
class AggSpec:
    """One aggregate in the operator's output."""
    out_name: str
    function: hashagg.AggFunction
    input: Optional[CompiledExpr]       # None for count(*)
    mask: Optional[CompiledExpr] = None  # FILTER (WHERE ...)


def _direct_domains(key_exprs) -> Optional[Tuple[int, ...]]:
    """Per-key code domain when every key is dictionary-encoded or
    boolean and the slot table fits DIRECT_SLOTS_MAX; None otherwise."""
    doms = []
    for ke in key_exprs:
        if ke.dictionary is not None:
            doms.append(len(ke.dictionary))
        elif ke.type.name == "boolean":
            doms.append(2)
        else:
            return None
    slots = 1
    for d in doms:
        slots *= d + 1
    return tuple(doms) if slots <= hashagg.DIRECT_SLOTS_MAX else None


def make_agg_step_kernel(key_exprs: Sequence[CompiledExpr],
                         specs: Sequence[AggSpec],
                         domains: Tuple[int, ...]):
    """The (state, batch) -> state fold step of the direct path (the
    reference's `make_agg_step_kernel` direct branch)."""
    aggs = tuple(s.function for s in specs)

    def kernel(state: hashagg.DirectState, batch: Batch):
        _tk.count("agg_step")
        env = {n: (c.data, c.mask) for n, c in batch.columns.items()}
        cap = batch.capacity
        key_cols = []
        for ke in key_exprs:
            d, m = ke.fn(env)
            key_cols.append((d.expand(cap), m.expand(cap)))
        agg_inputs, agg_weights = [], []
        for s in specs:
            if s.input is None:
                agg_inputs.append(None)
                w = batch.row_valid
            else:
                d, m = s.input.fn(env)
                agg_inputs.append(d.expand(cap))
                w = batch.row_valid & m.expand(cap)
            if s.mask is not None:
                # FILTER (WHERE ...): NULL counts as excluded; groups
                # still form from row_valid — only contributions gate
                fd, fm = s.mask.fn(env)
                w = w & (fd & fm).expand(cap)
            agg_weights.append(w)
        return hashagg.direct_step(state, batch.row_valid, key_cols,
                                   domains, agg_inputs, agg_weights, aggs)
    return kernel


def make_agg_finalize_kernel(key_names, key_types, key_dicts, domains,
                             out_names, aggs):
    """slot table -> output batch."""
    def fin(state: hashagg.DirectState) -> Batch:
        _tk.count("agg_finalize")
        return hashagg.direct_finalize(state, key_names, key_types,
                                       key_dicts, domains, out_names,
                                       aggs)
    return fin


class AggregationOperator(Operator):
    def __init__(self, ctx: OperatorContext, key_names: Sequence[str],
                 key_exprs: Sequence[CompiledExpr],
                 specs: Sequence[AggSpec], domains: Tuple[int, ...]):
        super().__init__(ctx)
        self.key_names = list(key_names)
        self.key_exprs = list(key_exprs)
        self.specs = list(specs)
        self._domains = domains
        self._kernel = make_agg_step_kernel(key_exprs, specs, domains)
        slots = 1
        for d in domains:
            slots *= d + 1
        self._state = hashagg.direct_init(
            [s.function for s in self.specs], slots,
            ctx.driver_context.device)
        self._finishing = False
        self._emitted = False

    def needs_input(self) -> bool:
        return not self._finishing

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        self._state = self._kernel(self._state, batch)

    def get_output(self) -> Optional[Batch]:
        if not self._finishing or self._emitted:
            return None
        self._emitted = True
        fin = make_agg_finalize_kernel(
            tuple(self.key_names),
            tuple(k.type for k in self.key_exprs),
            tuple(k.dictionary for k in self.key_exprs), self._domains,
            tuple(s.out_name for s in self.specs),
            tuple(s.function for s in self.specs))
        # (a global aggregation over zero rows still yields one live
        #  row: _decode_slots pins it, so count(*) = 0 works)
        return self._count_out(fin(self._state))

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing and self._emitted

    def close(self) -> None:
        self._state = None


class AggregationOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, key_names: Sequence[str],
                 key_exprs: Sequence[CompiledExpr],
                 specs: Sequence[AggSpec], mode: str):
        super().__init__(operator_id, "aggregation")
        if mode != "single":
            raise hashagg.HighCardinalityGrouping(
                f"{mode} aggregation step: the partial/final split is "
                "a later slice of the port")
        domains = _direct_domains(key_exprs)
        if domains is None:
            raise hashagg.HighCardinalityGrouping(
                "high-cardinality grouping: later slice of the port "
                "(the sort-based aggregation path, ROADMAP B4)")
        self.args = (list(key_names), list(key_exprs), list(specs),
                     domains)

    def create(self, driver_context: DriverContext) -> Operator:
        return AggregationOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            *self.args)
