"""Window operator (reference: presto_tpu/operators/window_ops.py;
WindowOperator.java:62): accumulates its whole input (windows need
their full partitions), then runs the whole-relation window pass
(ops/window.py: the sort, then K13-K16 on the card) and emits one batch
holding the input columns, in input order, plus the window outputs."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from presto_tpu_torch.batch import Batch, operator_capacity
from presto_tpu_torch.operators.base import (
    DriverContext, Operator, OperatorContext, OperatorFactory,
)
from presto_tpu_torch.ops.window import WindowCallSpec, window_kernel


class WindowOperator(Operator):
    def __init__(self, ctx: OperatorContext,
                 part_names: Tuple[str, ...],
                 order_names: Tuple[str, ...],
                 descending: Tuple[bool, ...],
                 nulls_first: Tuple[bool, ...],
                 calls: Tuple[WindowCallSpec, ...]):
        super().__init__(ctx)
        self.part_names = part_names
        self.order_names = order_names
        self.descending = descending
        self.nulls_first = nulls_first
        self.calls = calls
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
        # one host read of the live count for the whole input
        total = int(sum(b.row_valid.sum() for b in self._batches))
        merged = Batch.concat(self._batches, operator_capacity(total),
                              live_rows=total)
        self._batches = []
        out = window_kernel(merged, self.part_names, self.order_names,
                            self.descending, self.nulls_first, self.calls)
        return self._count_out(out)

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing and self._emitted


class WindowOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, part_names: Sequence[str],
                 order_names: Sequence[str], descending: Sequence[bool],
                 nulls_first: Sequence[bool],
                 calls: Sequence[WindowCallSpec]):
        super().__init__(operator_id, "window")
        self.args = (tuple(part_names), tuple(order_names),
                     tuple(descending), tuple(nulls_first), tuple(calls))

    def create(self, driver_context: DriverContext) -> Operator:
        return WindowOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            *self.args)
