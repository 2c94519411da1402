"""Operator protocol (reference: presto_tpu/operators/base.py;
operator/Operator.java:20 — needsInput/addInput/getOutput/finish —
and OperatorContext / DriverContext).

The port keeps the protocol and the per-operator batch counters; row
counters, memory accounting, spill and the deferred device-flag checks
arrive with the slices that need them.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any, Optional

import torch

from presto_tpu_torch.batch import Batch


@dataclasses.dataclass
class OperatorStats:
    """Per-operator counters (reference: operator/OperatorStats.java)."""
    input_batches: int = 0
    output_batches: int = 0


@dataclasses.dataclass
class DriverContext:
    """Execution context shared by the operators of one driver."""
    session: Any = None
    device: torch.device = torch.device("cpu")


class OperatorContext:
    def __init__(self, operator_id: int, name: str,
                 driver_context: DriverContext):
        self.operator_id = operator_id
        self.name = name
        self.driver_context = driver_context
        self.stats = OperatorStats()


class Operator(abc.ABC):
    """One stage of a pipeline. Contract (Operator.java:20):

    - `needs_input()` true iff `add_input` may be called
    - `add_input(batch)` accepts one batch (only when needs_input)
    - `get_output()` returns a batch or None (no output ready)
    - `finish()` signals no more input will arrive
    - `is_finished()` true when no more output will be produced
    """

    def __init__(self, ctx: OperatorContext):
        self.ctx = ctx

    @abc.abstractmethod
    def needs_input(self) -> bool: ...

    @abc.abstractmethod
    def add_input(self, batch: Batch) -> None: ...

    @abc.abstractmethod
    def get_output(self) -> Optional[Batch]: ...

    @abc.abstractmethod
    def finish(self) -> None: ...

    @abc.abstractmethod
    def is_finished(self) -> bool: ...

    def close(self) -> None:
        pass

    def _count_in(self, batch: Batch) -> None:
        self.ctx.stats.input_batches += 1

    def _count_out(self, batch: Optional[Batch]) -> Optional[Batch]:
        if batch is not None:
            self.ctx.stats.output_batches += 1
        return batch


class OperatorFactory(abc.ABC):
    """Creates one Operator per driver (reference: OperatorFactory)."""

    def __init__(self, operator_id: int, name: str):
        self.operator_id = operator_id
        self.name = name

    @abc.abstractmethod
    def create(self, driver_context: DriverContext) -> Operator: ...
