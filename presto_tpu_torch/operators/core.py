"""Core operators: Values, TableScan, FilterAndProject, Limit, Output
(reference: presto_tpu/operators/core.py; ScanFilterAndProjectOperator.java:58,
FilterAndProjectOperator.java:32, LimitOperator).
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.batch import (
    Batch, Column, begin_deferred_compact, end_deferred_compact,
)
from presto_tpu_torch.expr.compile import CompiledExpr
from presto_tpu_torch.native.pages import PendingScalar
from presto_tpu_torch.operators.base import (
    DriverContext, Operator, OperatorContext, OperatorFactory,
)
from presto_tpu_torch.ops import sort as sort_ops
from presto_tpu_torch.telemetry import kernels as _tk


class SourceOperator(Operator):
    """Base for operators that originate data (no input)."""

    def needs_input(self) -> bool:
        return False

    def add_input(self, batch: Batch) -> None:
        raise RuntimeError(f"{self.ctx.name} takes no input")


class ValuesOperator(SourceOperator):
    def __init__(self, ctx: OperatorContext, batches: List[Batch]):
        super().__init__(ctx)
        self._batches = list(batches)
        self._finished = False

    def get_output(self) -> Optional[Batch]:
        if self._batches:
            return self._count_out(self._batches.pop(0))
        self._finished = True
        return None

    def finish(self) -> None:
        pass

    def is_finished(self) -> bool:
        return self._finished and not self._batches


class ValuesOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, batches: List[Batch]):
        super().__init__(operator_id, "values")
        self.batches = batches

    def create(self, driver_context: DriverContext) -> Operator:
        return ValuesOperator(
            OperatorContext(self.operator_id, "values", driver_context),
            self.batches)


class TableScanOperator(SourceOperator):
    """Pulls batches from a connector page source (reference:
    TableScanOperator.java:43)."""

    def __init__(self, ctx: OperatorContext,
                 batch_iter: Iterator[Batch]):
        super().__init__(ctx)
        self._iter = batch_iter
        self._finished = False

    def get_output(self) -> Optional[Batch]:
        if self._finished:
            return None
        b = next(self._iter, None)
        if b is None:
            self._finished = True
            return None
        return self._count_out(b)

    def finish(self) -> None:
        pass

    def is_finished(self) -> bool:
        return self._finished


class TableScanOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, name: str,
                 batch_iter_factory: Callable[[], Iterator[Batch]]):
        super().__init__(operator_id, name)
        self._factory = batch_iter_factory

    def create(self, driver_context: DriverContext) -> Operator:
        return TableScanOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            self._factory())


def make_filter_project_kernel(
        filter_expr: Optional[CompiledExpr],
        projections: Sequence[Tuple[str, CompiledExpr]]):
    """The batch -> batch body of a FilterProject (the reference's
    one-stage `fused_fragment.make_chain_body`): the predicate ANDed
    into row_valid (NULL is false) and the projection forest, each
    result broadcast to the batch capacity in its declared dtype."""
    projections = tuple(projections)

    def kernel(batch: Batch) -> Batch:
        _tk.count("filter_project")
        env = {n: (c.data, c.mask) for n, c in batch.columns.items()}
        cap = batch.capacity
        rv = batch.row_valid
        if filter_expr is not None:
            d, m = filter_expr.fn(env)
            rv = rv & (d & m).expand(cap)
        cols = {}
        for name, ce in projections:
            d, m = ce.fn(env)
            # constants come back 0-d: materialize them at full width
            # (no-op views for full-size results)
            cols[name] = Column(
                d.to(ce.type.torch_dtype).expand(cap).contiguous(),
                m.expand(cap).contiguous(), ce.type, ce.dictionary)
        return Batch(cols, rv)
    return kernel


class FilterProjectOperator(Operator):
    """`selective` (a filter is present) enables the one-round-delayed
    count/compact protocol on outputs: the live count's copy to the
    host starts when a batch is produced and is read when the batch is
    emitted one driver round later, to shrink it (kernel K2) without a
    blocking round trip. Pure projections skip the count."""

    def __init__(self, ctx: OperatorContext, kernel,
                 selective: bool = False):
        super().__init__(ctx)
        self._kernel = kernel
        self._selective = selective
        self._pending: List = []
        self._finishing = False

    def needs_input(self) -> bool:
        return len(self._pending) < (2 if self._selective else 1) \
            and not self._finishing

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        out = self._kernel(batch)
        if self._selective:
            self._pending.append(begin_deferred_compact(out))
        else:
            self._pending.append((out, None))

    def get_output(self) -> Optional[Batch]:
        emit_at = 1 if self._selective and not self._finishing else 0
        if len(self._pending) > emit_at:
            out, total = self._pending.pop(0)
            return self._count_out(end_deferred_compact(out, total))
        return None

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing and not self._pending


class FilterProjectOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int,
                 filter_expr: Optional[CompiledExpr],
                 projections: Sequence[Tuple[str, CompiledExpr]]):
        super().__init__(operator_id, "filter_project")
        self._kernel = make_filter_project_kernel(filter_expr, projections)
        self._selective = filter_expr is not None

    def create(self, driver_context: DriverContext) -> Operator:
        return FilterProjectOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            self._kernel, self._selective)


class LimitOperator(Operator):
    """LIMIT n (reference: LimitOperator). The emitted count stays on
    the device; early termination reads the limit-reached flag only
    once its asynchronous copy has landed (an event query), so the loop
    never blocks on it — at worst a couple of extra batches are pulled,
    each still truncated by limit_batch."""

    def __init__(self, ctx: OperatorContext, n: int):
        super().__init__(ctx)
        self._n = n
        self._emitted = torch.zeros((), dtype=torch.int64,
                                    device=ctx.driver_context.device)
        self._flag: Optional[PendingScalar] = None  # emitted >= n
        self._pending: Optional[Batch] = None
        self._finishing = False
        self._done = False

    def needs_input(self) -> bool:
        if not self._done and self._flag is not None \
                and self._flag.ready() and self._flag.get():
            self._done = True  # stop pulling input
        return self._pending is None and not self._finishing \
            and not self._done

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        out = sort_ops.limit_batch(batch, self._n, self._emitted)
        self._emitted = self._emitted + out.row_valid.sum()
        self._flag = PendingScalar(self._emitted >= self._n)
        self._pending = out

    def get_output(self) -> Optional[Batch]:
        out, self._pending = self._pending, None
        return self._count_out(out)

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return (self._finishing or self._done) and self._pending is None


class LimitOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, n: int):
        super().__init__(operator_id, "limit")
        self.n = n

    def create(self, driver_context: DriverContext) -> Operator:
        return LimitOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            self.n)


class OutputCollectorOperator(Operator):
    """Terminal sink gathering result batches."""

    def __init__(self, ctx: OperatorContext, sink: List[Batch]):
        super().__init__(ctx)
        self.sink = sink
        self._finishing = False

    def needs_input(self) -> bool:
        return not self._finishing

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        self.sink.append(batch)

    def get_output(self) -> Optional[Batch]:
        return None

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing


class OutputCollectorOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, sink: List[Batch]):
        super().__init__(operator_id, "output")
        self.sink = sink

    def create(self, driver_context: DriverContext) -> Operator:
        return OutputCollectorOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            self.sink)
