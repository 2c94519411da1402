"""Table write operators (reference: presto_tpu/operators/write_ops.py;
operator/TableWriterOperator.java + operator/TableFinishOperator.java).

The writer appends each batch, renamed onto the target's stored
columns, to the connector's page sink and counts its live rows on the
device; the finish operator sums the writers' counts into the
statement's one-row result. Neither commits: the runner calls the sink's
`finish` only after the drive loop's deferred overflow checks passed
(`LocalRunner._run_write`), so a retried statement never duplicates
committed rows. Column moves and one sum per batch: no kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from presto_tpu_torch.batch import MIN_CAPACITY, Batch, Column
from presto_tpu_torch.operators.base import (
    DriverContext, Operator, OperatorContext, OperatorFactory,
)
from presto_tpu_torch.types import BIGINT


class _CountRowOperator(Operator):
    """Consumes batches, counting rows on the device, and emits the
    count as one BIGINT row at finish."""

    def __init__(self, ctx: OperatorContext, out_symbol: str):
        super().__init__(ctx)
        self.out_symbol = out_symbol
        self._rows: Optional[torch.Tensor] = None
        self._finishing = False
        self._emitted = False

    def _add_rows(self, n: torch.Tensor) -> None:
        n = n.to(torch.int64)
        self._rows = n if self._rows is None else self._rows + n

    def needs_input(self) -> bool:
        return not self._finishing

    def get_output(self) -> Optional[Batch]:
        if not self._finishing or self._emitted:
            return None
        self._emitted = True
        dev = self.ctx.driver_context.device
        data = torch.zeros(MIN_CAPACITY, dtype=torch.int64, device=dev)
        if self._rows is not None:
            data[0] = self._rows
        rv = torch.zeros(MIN_CAPACITY, dtype=torch.bool, device=dev)
        rv[0] = True
        return self._count_out(
            Batch({self.out_symbol: Column(data, rv, BIGINT)}, rv))

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing and self._emitted


class TableWriterOperator(_CountRowOperator):
    def __init__(self, ctx: OperatorContext, sink, handle,
                 column_sources: Dict[str, Optional[str]],
                 schema_cols: Sequence[tuple], out_symbol: str):
        super().__init__(ctx, out_symbol)
        self.sink = sink
        self.handle = handle
        self.column_sources = column_sources
        self.schema_cols = schema_cols

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        cols = {}
        for name, typ, _dic in self.schema_cols:
            src = self.column_sources.get(name)
            if src is not None:
                cols[name] = batch.columns[src]
            else:   # a target column the statement does not set: NULLs
                cols[name] = Column(
                    torch.zeros(batch.capacity, dtype=typ.torch_dtype,
                                device=batch.device),
                    torch.zeros(batch.capacity, dtype=torch.bool,
                                device=batch.device),
                    typ, () if typ.is_string else None)
        self.sink.append(self.handle, Batch(cols, batch.row_valid))
        self._add_rows(batch.row_valid.sum())


class TableFinishOperator(_CountRowOperator):
    """Sums the writers' count rows (the commit is the runner's)."""

    def __init__(self, ctx: OperatorContext, count_symbol: str,
                 out_symbol: str):
        super().__init__(ctx, out_symbol)
        self.count_symbol = count_symbol

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        c = batch.columns[self.count_symbol]
        self._add_rows(torch.where(batch.row_valid & c.mask, c.data,
                                   torch.zeros_like(c.data)).sum())


class TableWriterOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, sink, handle, column_sources,
                 schema_cols, out_symbol: str):
        super().__init__(operator_id, "table_writer")
        self.args = (sink, handle, dict(column_sources), list(schema_cols),
                     out_symbol)

    def create(self, driver_context: DriverContext) -> Operator:
        return TableWriterOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            *self.args)


class TableFinishOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, count_symbol: str,
                 out_symbol: str):
        super().__init__(operator_id, "table_finish")
        self.args = (count_symbol, out_symbol)

    def create(self, driver_context: DriverContext) -> Operator:
        return TableFinishOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            *self.args)
