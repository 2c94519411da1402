"""Core operators: Values, TableScan, FilterAndProject, Limit, Output
(reference: presto_tpu/operators/core.py; ScanFilterAndProjectOperator.java:58,
FilterAndProjectOperator.java:32, LimitOperator).
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.batch import (
    Batch, begin_deferred_compact, end_deferred_compact,
)
from presto_tpu_torch.expr.compile import CompiledExpr
from presto_tpu_torch.native.pages import PendingScalar
from presto_tpu_torch.operators.base import (
    DriverContext, Operator, OperatorContext, OperatorFactory,
)
from presto_tpu_torch.ops import sort as sort_ops


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
    TableScanOperator.java:43).

    `df_specs` [(column, df_id, registry)] wires dynamic filtering:
    once the join build has published its key filter, every batch
    narrows row_valid by it (execution/dynamic_filters.py). A
    cross-fragment filter that is armed but incomplete holds the scan
    back until every build task published it."""

    def __init__(self, ctx: OperatorContext,
                 batch_iter: Iterator[Batch], df_specs=None):
        super().__init__(ctx)
        self._iter = batch_iter
        self._df_specs = df_specs or []
        self._finished = False

    def get_output(self) -> Optional[Batch]:
        if self._finished:
            return None
        if any(getattr(reg, "pending", None) and reg.pending(df_id)
               for _, df_id, reg in self._df_specs):
            return None  # a cross-fragment filter is still being built
        b = next(self._iter, None)
        if b is None:
            self._finished = True
            return None
        for col, df_id, reg in self._df_specs:
            f = reg.get(df_id)
            if f is not None:
                from presto_tpu_torch.execution.dynamic_filters import (
                    apply,
                )
                b = apply(b, col, f)
        return self._count_out(b)

    def finish(self) -> None:
        pass

    def is_finished(self) -> bool:
        return self._finished


class TableScanOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, name: str,
                 batch_iter_factory: Callable[[], Iterator[Batch]],
                 df_specs=None):
        super().__init__(operator_id, name)
        self._factory = batch_iter_factory
        self._df_specs = df_specs

    def create(self, driver_context: DriverContext) -> Operator:
        return TableScanOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            self._factory(), self._df_specs)


def make_filter_project_kernel(
        filter_expr: Optional[CompiledExpr],
        projections: Sequence[Tuple[str, CompiledExpr]],
        input_dicts: Optional[Tuple[Tuple[str, tuple], ...]] = None):
    """The batch -> batch body of a FilterProject: the predicate ANDed
    into row_valid (NULL is false) and the projection forest, each
    result in its declared dtype at the batch capacity. It is the
    whole-fragment compiler's one-stage chain
    (operators/fused_fragment.py) — one definition of the
    filter/project semantics, so fused and unfused results cannot
    drift: K12 on a CUDA batch, the composed closures on the CPU.

    Bodies are shared through the fragment LRU, keyed by the
    expressions' fingerprints and `input_dicts` (the dict-encoded input
    columns they were compiled against: lookup tables bake those
    dictionaries in)."""
    from presto_tpu_torch.operators.fused_fragment import (
        ChainStage, cached_chain_body, chain_fingerprint,
    )
    stages = [ChainStage(filter_expr, tuple(projections), input_dicts)]
    key = chain_fingerprint(stages)
    return cached_chain_body(
        stages, ("filter_project", key) if key is not None else None,
        family="filter_project")


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
                 projections: Sequence[Tuple[str, CompiledExpr]],
                 input_dicts: Optional[Tuple[Tuple[str, tuple], ...]] = None,
                 selectivity: Optional[float] = None,
                 sel_provenance: str = "static"):
        super().__init__(operator_id, "filter_project")
        self._kernel = make_filter_project_kernel(filter_expr, projections,
                                                  input_dicts)
        self._selective = filter_expr is not None
        # kept for the whole-fragment fusion pass (planner/fusion.py):
        # adjacent FilterProjects collapse into the downstream
        # terminal's kernel, which needs the expression forest, plus
        # the planner's estimated fraction of surviving rows (None =
        # unknown), which gates fold-terminal fusion: a highly
        # selective chain keeps its deferred compaction instead of
        # handing the fold full-width dead rows
        self.filter_expr = filter_expr
        self.projections = tuple(projections)
        self.input_dicts = input_dicts
        self.selectivity = selectivity
        #: "static" (derived estimate); "history" (measured) comes
        #: with the history slice (ROADMAP A11)
        self.sel_provenance = sel_provenance

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

    def _step(self, batch: Batch):
        """(truncated batch, new emitted count) — the whole-fragment
        compiler runs the upstream chain first
        (operators/fused_fragment.py); the early-termination protocol
        around it is shared."""
        return sort_ops.limit_batch(batch, self._n, self._emitted)

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        out, self._emitted = self._step(batch)
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
