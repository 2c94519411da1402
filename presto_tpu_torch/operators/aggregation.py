"""Aggregation operator (reference: presto_tpu/operators/aggregation.py;
HashAggregationOperator.java:47 with InMemoryHashAggregationBuilder,
AggregationOperator for global aggregates).

Two paths, chosen from the key expressions:

- direct slot table (every key dictionary-coded or boolean, the table
  within DIRECT_SLOTS_MAX): every batch is reduced into the table in
  place (kernel K1, `ops/hashagg.direct_step`); finalize decodes the
  slots.
- streaming, when the planner knows the input arrives sorted by the
  group keys (`StreamingAggregationOperator`): every batch is grouped
  without a sort and folded with the group carried from the batch
  before (K8, `hashagg.stream_aggregate`); completed groups are emitted
  as the stream passes them, in key order, in O(batch) memory.
- sort-based (any other key set): every batch is compacted to its
  distinct groups (`hashagg.batch_aggregate`: K3 + sort + K6) into a
  partial sized by the batch, and partials are tree-merged
  (`merge_states`, FANIN at a time). A partial's live-group count is
  copied to the host when it is made and read one driver round later
  (`agg_count`), to shrink it to its live bucket (`agg_shrink`) and to
  size the merges from observed counts. When the groups outgrow
  `max_groups` the state's overflow flag is set on the device; the one
  host read at the end raises GroupLimitExceeded and the runner re-runs
  the query with four times the groups.

Only the SINGLE step runs locally in this slice; the PARTIAL/FINAL
split belongs to the distributed slice. Memory revocation (spilling
partials to the host) comes with the memory slice (ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.batch import (
    Batch, bucket_capacity, end_deferred_compact, operator_capacity,
    quantized_capacity,
)
from presto_tpu_torch.expr.compile import CompiledExpr
from presto_tpu_torch.native.pages import PendingScalar
from presto_tpu_torch.operators.base import (
    DriverContext, Operator, OperatorContext, OperatorFactory,
)
from presto_tpu_torch.ops import hashagg
from presto_tpu_torch.telemetry import kernels as _tk


class GroupLimitExceeded(Exception):
    """Distinct groups exceeded max_groups. Carries the suggested retry
    size; the runner re-executes the query with max_groups raised."""

    def __init__(self, suggested: int):
        super().__init__(f"group-by overflow; retry with {suggested}")
        self.suggested = suggested


@dataclasses.dataclass
class AggSpec:
    """One aggregate in the operator's output."""
    out_name: str
    function: hashagg.AggFunction
    input: Optional[CompiledExpr]       # None for count(*)
    mask: Optional[CompiledExpr] = None  # FILTER (WHERE ...)


#: buffered partials per merge round
_MERGE_FANIN = 8


def merge_states(states, aggs, out_cap: int) -> hashagg.GroupByState:
    """One merge of packed partials (`hashagg_merge`)."""
    _tk.count("hashagg_merge")
    return hashagg.merge_partials(list(states), aggs, out_cap)


def _count_live(valid: torch.Tensor) -> PendingScalar:
    """A partial's live-group count, copied to the host now and read
    one driver round later (`agg_count`)."""
    _tk.count("agg_count")
    return PendingScalar(valid.sum())


def _shrink_state(st: hashagg.GroupByState, cap: int
                  ) -> hashagg.GroupByState:
    """Slice a PACKED sort-path state down to `cap` slots (live groups
    sit at the front; callers guarantee cap >= live)."""
    _tk.count("agg_shrink")
    return hashagg.GroupByState(
        [(d[:cap], m[:cap]) for d, m in st.keys],
        [tuple(a[:cap] for a in t) for t in st.states],
        st.valid[:cap], st.overflow)


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
                         domains: Optional[Tuple[int, ...]],
                         presorted: bool = False):
    """The fold step. Direct path: (state, batch) -> state. Sort path:
    (out_cap, batch) -> the batch's packed partial state. `presorted`
    (the streaming operator, rows arriving in key order) swaps the sort
    for K8: (out_cap, batch, carry) -> one streaming round
    (`hashagg.stream_aggregate`)."""
    aggs = tuple(s.function for s in specs)

    def batch_parts(batch: Batch):
        env = {n: (c.data, c.mask) for n, c in batch.columns.items()}
        cap = batch.capacity
        key_cols = []
        for ke in key_exprs:
            d, m = ke.fn(env)
            key_cols.append((d.to(ke.type.torch_dtype).expand(cap),
                             m.expand(cap)))
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
        return key_cols, agg_inputs, agg_weights

    if domains is not None:
        def kernel(state: hashagg.DirectState, batch: Batch):
            _tk.count("agg_step")
            key_cols, agg_inputs, agg_weights = batch_parts(batch)
            return hashagg.direct_step(state, batch.row_valid, key_cols,
                                       domains, agg_inputs, agg_weights,
                                       aggs)
        return kernel

    if presorted:
        def presorted_kernel(out_cap: int, batch: Batch, carry):
            _tk.count("agg_step")
            key_cols, agg_inputs, agg_weights = batch_parts(batch)
            return hashagg.stream_aggregate(
                carry, batch.row_valid, key_cols, agg_inputs, agg_weights,
                aggs, out_cap)
        return presorted_kernel

    def sort_kernel(out_cap: int, batch: Batch):
        _tk.count("agg_step")
        key_cols, agg_inputs, agg_weights = batch_parts(batch)
        return hashagg.batch_aggregate(batch.row_valid, key_cols,
                                       agg_inputs, agg_weights, aggs,
                                       out_cap)
    return sort_kernel


def make_agg_finalize_kernel(key_names, key_types, key_dicts, domains,
                             out_names, aggs):
    """state -> output batch (slot decode on the direct path)."""
    def fin(state) -> Batch:
        _tk.count("agg_finalize")
        if domains is not None:
            return hashagg.direct_finalize(state, key_names, key_types,
                                           key_dicts, domains, out_names,
                                           aggs)
        return hashagg.finalize(state, key_names, key_types, key_dicts,
                                out_names, aggs)
    return fin


class AggregationOperator(Operator):
    def __init__(self, ctx: OperatorContext, key_names: Sequence[str],
                 key_exprs: Sequence[CompiledExpr],
                 specs: Sequence[AggSpec],
                 domains: Optional[Tuple[int, ...]], max_groups: int):
        super().__init__(ctx)
        self.key_names = list(key_names)
        self.key_exprs = list(key_exprs)
        self.specs = list(specs)
        self.max_groups = max_groups
        self._domains = domains
        self._kernel = make_agg_step_kernel(key_exprs, specs, domains)
        self._device = ctx.driver_context.device
        if domains is not None:
            slots = 1
            for d in domains:
                slots *= d + 1
            self._state = hashagg.direct_init(
                [s.function for s in self.specs], slots, self._device)
        else:
            # per-batch packed partials sized by the batch, shrunk to
            # their observed live bucket one driver round later and
            # merged at capacities derived from live counts
            self._state = None
            self._cap = bucket_capacity(max_groups)
            #: cap -> [(state, live)]
            self._levels: Dict[int, list] = {}
            #: states awaiting their live count: [(state, PendingScalar)]
            self._pending: list = []
        self._finishing = False
        self._emitted = False

    def needs_input(self) -> bool:
        return not self._finishing

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        if self._domains is not None:
            self._state = self._kernel(self._state, batch)
            return
        c0 = min(self._cap, bucket_capacity(batch.capacity))
        self._enqueue(self._kernel(c0, batch))
        self._drain_pending(keep=1)

    # -- sort-path partial management ---------------------------------

    def _aggs(self):
        return tuple(s.function for s in self.specs)

    def _live_cap(self, lives: int) -> int:
        """Capacity for a merge of states holding `lives` live groups in
        all: distinct(union) <= the sum, so this overflows only when
        max_groups truly does."""
        return min(self._cap, operator_capacity(lives))

    def _enqueue(self, st) -> None:
        self._pending.append((st, _count_live(st.valid)))

    def _drain_pending(self, keep: int) -> None:
        while len(self._pending) > keep:
            if keep and len(self._pending) <= keep + 2:
                # a fixed backlog of overlap time for the newest counts;
                # which states merge together must not depend on when a
                # copy lands (merge grouping changes float rounding)
                break
            st, cnt = self._pending.pop(0)
            live = cnt.get()
            cap = st.valid.shape[0]
            tgt = min(cap, self._live_cap(live))
            if tgt < cap:
                st = _shrink_state(st, tgt)
            self._push(st, live)

    def _push(self, st, live: int) -> None:
        """Buffer a counted partial by capacity; FANIN equal-capacity
        partials merge, and the merge re-enters the pending queue."""
        cap = st.valid.shape[0]
        buf = self._levels.setdefault(cap, [])
        buf.append((st, live))
        if len(buf) >= _MERGE_FANIN:
            lives = sum(l for _, l in buf)
            merged = merge_states([s for s, _ in buf], self._aggs(),
                                  self._live_cap(lives))
            self._levels[cap] = []
            self._enqueue(merged)

    def _merge_mixed(self, entries):
        """Merge leftover (state, live) pairs of assorted capacities:
        equal-capacity groups first, then pairwise up the capacities,
        every output sized from live counts."""
        aggs = self._aggs()
        by_cap: Dict[int, list] = {}
        for s, l in entries:
            by_cap.setdefault(s.valid.shape[0], []).append((s, l))
        level: List = []
        for cap in sorted(by_cap):
            group = by_cap[cap]
            if len(group) == 1:
                level.append(group[0])
                continue
            lives = sum(l for _, l in group)
            level.append((merge_states([s for s, _ in group], aggs,
                                       self._live_cap(lives)), lives))
        level.sort(key=lambda e: e[0].valid.shape[0])
        while len(level) > 1:
            (sa, la), (sb, lb) = level.pop(0), level.pop(0)
            level.append((merge_states([sa, sb], aggs,
                                       self._live_cap(la + lb)), la + lb))
            level.sort(key=lambda e: e[0].valid.shape[0])
        return level[0][0]

    def _final_state(self):
        self._drain_pending(keep=0)
        entries = [e for buf in self._levels.values() for e in buf]
        self._levels = {}
        if not entries:
            return hashagg.init_state([k.type for k in self.key_exprs],
                                      self._aggs(), self._cap,
                                      self._device)
        if len(entries) > 1:
            return self._merge_mixed(entries)
        return entries[0][0]

    def get_output(self) -> Optional[Batch]:
        if not self._finishing or self._emitted:
            return None
        live = None
        if self._domains is None:
            self._state = self._final_state()
            # ONE host read serves the overflow check and the live count
            overflow, live = torch.stack([
                self._state.overflow.to(torch.int64),
                self._state.valid.sum()]).tolist()
            if overflow:
                raise GroupLimitExceeded(self.max_groups * 4)
        self._emitted = True
        fin = make_agg_finalize_kernel(
            tuple(self.key_names),
            tuple(k.type for k in self.key_exprs),
            tuple(k.dictionary for k in self.key_exprs), self._domains,
            tuple(s.out_name for s in self.specs), self._aggs())
        # (a global aggregation over zero rows still yields one live
        #  row: _decode_slots pins it, so count(*) = 0 works)
        out = fin(self._state)
        if live is not None:
            cap = quantized_capacity(live)
            if cap < out.capacity:
                # groups are packed at the front of the state
                out = out.compact(cap, known_valid=live)
        return self._count_out(out)

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing and self._emitted

    def close(self) -> None:
        self._state = None
        if self._domains is None:
            self._levels = {}
            self._pending = []


class StreamingAggregationOperator(Operator):
    """Aggregation over an input already sorted by the group keys
    (ascending, nulls last), emitting each group as soon as the stream
    has passed it (reference: operator/StreamingAggregationOperator.java;
    presto_tpu/operators/aggregation.py:722). Memory is O(batch): no
    max_groups table and no overflow retry. Output batches hold groups
    in key order.

    Per batch one K8 round: the batch's groups, the carried group folded
    into the first of them when the keys match (else emitted on its
    own, ahead of the batch's), and the last group carried on. Emitted
    states go out one driver round later, shrunk to their live count
    (the one-round-delayed compaction protocol); the carry goes out at
    the end."""

    def __init__(self, ctx: OperatorContext, key_names: Sequence[str],
                 key_exprs: Sequence[CompiledExpr],
                 specs: Sequence[AggSpec]):
        super().__init__(ctx)
        self.key_names = list(key_names)
        self.key_exprs = list(key_exprs)
        self.specs = list(specs)
        self._kernel = make_agg_step_kernel(key_exprs, specs, None,
                                            presorted=True)
        self._device = ctx.driver_context.device
        self._carry = None
        #: [(state to emit, PendingScalar of its live groups or None)]
        self._pending: list = []
        self._finishing = False
        self._emitted_tail = False

    def _aggs(self):
        return tuple(s.function for s in self.specs)

    def _finalize(self, state) -> Batch:
        return make_agg_finalize_kernel(
            tuple(self.key_names), tuple(k.type for k in self.key_exprs),
            tuple(k.dictionary for k in self.key_exprs), None,
            tuple(s.out_name for s in self.specs), self._aggs())(state)

    def needs_input(self) -> bool:
        return not self._finishing and len(self._pending) < 4

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        if self._carry is None:
            self._carry = hashagg.init_state(
                [k.type for k in self.key_exprs], self._aggs(), 1,
                self._device)
        carry_emit, emit, self._carry, live = self._kernel(
            bucket_capacity(batch.capacity), batch, self._carry)
        # a completed carry (key change at the batch border) precedes
        # this batch's groups in key order: its own 1-row batch first
        self._pending.append((carry_emit, None))
        self._pending.append((emit, PendingScalar(live)))

    def get_output(self) -> Optional[Batch]:
        if self._pending and (len(self._pending) > 1 or self._finishing):
            state, live = self._pending.pop(0)
            return self._count_out(end_deferred_compact(
                self._finalize(state), live))
        if self._pending or not self._finishing or self._emitted_tail:
            return None
        self._emitted_tail = True
        if self._carry is None:
            return None  # no input batch: a grouped aggregation of nothing
        return self._count_out(self._finalize(self._carry))

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing and not self._pending and self._emitted_tail

    def close(self) -> None:
        self._carry = None
        self._pending = []


class StreamingAggregationOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, key_names: Sequence[str],
                 key_exprs: Sequence[CompiledExpr],
                 specs: Sequence[AggSpec]):
        super().__init__(operator_id, "aggregation(streaming)")
        self.args = (list(key_names), list(key_exprs), list(specs))

    def create(self, driver_context: DriverContext) -> Operator:
        return StreamingAggregationOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            *self.args)


class AggregationOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, key_names: Sequence[str],
                 key_exprs: Sequence[CompiledExpr],
                 specs: Sequence[AggSpec], mode: str,
                 max_groups: int = 4096):
        super().__init__(operator_id, "aggregation")
        if mode != "single":
            raise ValueError(
                f"{mode} aggregation step: the partial/final split is "
                "a later slice of the port (ROADMAP A12)")
        self.args = (list(key_names), list(key_exprs), list(specs),
                     _direct_domains(key_exprs), int(max_groups))

    def create(self, driver_context: DriverContext) -> Operator:
        return AggregationOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            *self.args)
