"""Ordering and dedup operators (reference:
presto_tpu/operators/sort_ops.py; OrderByOperator.java:44,
TopNOperator.java:35, MergeOperator.java:44, the DISTINCT fold)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from presto_tpu_torch.batch import Batch, operator_capacity
from presto_tpu_torch.operators.base import (
    DriverContext, Operator, OperatorContext, OperatorFactory,
)
from presto_tpu_torch.ops import sort as sort_kernels


class OrderByOperator(Operator):
    """Full sort: accumulate, one device lex-sort on finish."""

    def __init__(self, ctx: OperatorContext, key_names: Tuple[str, ...],
                 descending: Tuple[bool, ...],
                 nulls_first: Tuple[bool, ...]):
        super().__init__(ctx)
        self.key_names = key_names
        self.descending = descending
        self.nulls_first = nulls_first
        self._batches: List[Batch] = []
        self._finishing = False
        self._emitted = False

    def needs_input(self) -> bool:
        return not self._finishing

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        self._batches.append(batch)

    def get_output(self) -> Optional[Batch]:
        if not self._finishing or self._emitted:
            return None
        self._emitted = True
        if not self._batches:
            return None
        # one count for ALL batches (a single host read), so selective
        # queries sort only live rows, not the full padded capacity
        total = int(sum(b.row_valid.sum() for b in self._batches))
        merged = Batch.concat(self._batches, operator_capacity(total),
                              live_rows=total)
        self._batches = []
        out = sort_kernels.sort_batch(merged, self.key_names,
                                      self.descending, self.nulls_first)
        return self._count_out(out)

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing and self._emitted


class MergeOperator(Operator):
    """k-way merge of sorted runs (reference: MergeOperator.java:44):
    each input batch is one task's sorted run arriving through a gather
    exchange; at finish the runs fold through the pairwise rank-
    arithmetic merge (ops/merge.py, K19), never a re-sort of the
    union."""

    def __init__(self, ctx: OperatorContext, key_names: Tuple[str, ...],
                 descending: Tuple[bool, ...],
                 nulls_first: Tuple[bool, ...]):
        super().__init__(ctx)
        self.key_names = key_names
        self.descending = descending
        self.nulls_first = nulls_first
        self._runs: List[Batch] = []
        self._finishing = False
        self._emitted = False

    def needs_input(self) -> bool:
        return not self._finishing

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        self._runs.append(batch)

    def get_output(self) -> Optional[Batch]:
        if not self._finishing or self._emitted:
            return None
        self._emitted = True
        if not self._runs:
            return None
        from presto_tpu_torch.ops.merge import merge_runs
        out = merge_runs(self._runs, self.key_names, self.descending,
                         self.nulls_first)
        self._runs = []
        return self._count_out(out)

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing and self._emitted


class TopNOperator(Operator):
    """Bounded running top-N fold (constant memory)."""

    def __init__(self, ctx: OperatorContext, n: int,
                 key_names: Tuple[str, ...], descending: Tuple[bool, ...],
                 nulls_first: Tuple[bool, ...],
                 schema_cols: Sequence[tuple]):
        super().__init__(ctx)
        self.n = n
        self.key_names = key_names
        self.descending = descending
        self.nulls_first = nulls_first
        self._state = sort_kernels.topn_state(
            schema_cols, operator_capacity(n), ctx.driver_context.device)
        self._finishing = False
        self._emitted = False

    def needs_input(self) -> bool:
        return not self._finishing

    def _step(self, batch: Batch) -> Batch:
        """The fold of one batch into the state — the whole-fragment
        compiler runs the upstream chain first
        (operators/fused_fragment.py); the protocol around it is
        shared."""
        return sort_kernels.topn_step(
            self._state, batch, self.n, self.key_names, self.descending,
            self.nulls_first)

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        self._state = self._step(batch)

    def get_output(self) -> Optional[Batch]:
        if not self._finishing or self._emitted:
            return None
        self._emitted = True
        # state rows are already sorted by topn_step's internal sort
        return self._count_out(self._state)

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing and self._emitted


class DistinctOperator(Operator):
    """SELECT DISTINCT / UNION dedup fold (reference:
    presto_tpu/operators/sort_ops.py:165). The state starts at
    `capacity` rows and doubles whenever a merged state fills it: a full
    state cannot tell kept rows from dropped ones, so the old state is
    re-merged into one of twice the size before the batch is taken
    again. One host read of the live count per batch."""

    def __init__(self, ctx: OperatorContext, schema_cols: Sequence[tuple],
                 capacity: int = 4096):
        super().__init__(ctx)
        self._schema_cols = list(schema_cols)
        self._device = ctx.driver_context.device
        self._state = sort_kernels.distinct_state(schema_cols, capacity,
                                                  self._device)
        self._finishing = False
        self._emitted = False

    def needs_input(self) -> bool:
        return not self._finishing

    def _step(self, batch: Batch) -> Batch:
        """The merge of one batch into the state — the whole-fragment
        compiler runs the upstream chain first
        (operators/fused_fragment.py); the growth below re-merges the
        old state through the plain step."""
        return sort_kernels.distinct_step(self._state, batch)

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        while True:
            new_state = self._step(batch)
            if new_state.num_valid() < new_state.capacity:
                self._state = new_state
                return
            bigger = sort_kernels.distinct_state(
                self._schema_cols, self._state.capacity * 2, self._device)
            self._state = sort_kernels.distinct_step(bigger, self._state)

    def get_output(self) -> Optional[Batch]:
        if not self._finishing or self._emitted:
            return None
        self._emitted = True
        return self._count_out(self._state)

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing and self._emitted


class OrderByOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, key_names: Sequence[str],
                 descending: Sequence[bool], nulls_first: Sequence[bool]):
        super().__init__(operator_id, "order_by")
        self.args = (tuple(key_names), tuple(descending),
                     tuple(nulls_first))

    def create(self, driver_context: DriverContext) -> Operator:
        return OrderByOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            *self.args)


class MergeOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, key_names: Sequence[str],
                 descending: Sequence[bool], nulls_first: Sequence[bool]):
        super().__init__(operator_id, "merge")
        self.args = (tuple(key_names), tuple(descending),
                     tuple(nulls_first))

    def create(self, driver_context: DriverContext) -> Operator:
        return MergeOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            *self.args)


class TopNOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, n: int, key_names: Sequence[str],
                 descending: Sequence[bool], nulls_first: Sequence[bool],
                 schema_cols: Sequence[tuple]):
        super().__init__(operator_id, "topn")
        # read by the fusion pass (planner/fusion.py)
        self.args = (n, tuple(key_names), tuple(descending),
                     tuple(nulls_first), schema_cols)
        self.schema_cols = schema_cols

    def create(self, driver_context: DriverContext) -> Operator:
        return TopNOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            *self.args)


class DistinctOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, schema_cols: Sequence[tuple],
                 capacity: int = 4096):
        super().__init__(operator_id, "distinct")
        self.schema_cols = schema_cols
        self.capacity = capacity

    def create(self, driver_context: DriverContext) -> Operator:
        return DistinctOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            self.schema_cols, self.capacity)
