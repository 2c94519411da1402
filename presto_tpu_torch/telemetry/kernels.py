"""Kernel-family call counts and CUDA launch counters (a small
counterpart of presto_tpu/telemetry/kernels.py, whose compile/execute
attribution and metrics export come with the telemetry slice).

`CALLS[family]` counts every call into a kernel family on any device,
under the family names of the JAX package's kernel contracts
(`agg_step`, `compact`, `filter_project`, ...): the same numbers as the
reference's `presto_tpu_kernel_calls_total`. A `LaunchCounter` belongs
to one hand-written CUDA kernel's wrapper and counts only the launches
of that kernel, so a run can show that the main path went through it.
"""

from __future__ import annotations

import collections

#: family -> calls, on any device
CALLS: "collections.Counter[str]" = collections.Counter()


def count(family: str) -> None:
    CALLS[family] += 1


class LaunchCounter:
    """Launches of one CUDA kernel, incremented by its wrapper where it
    launches the kernel and nowhere else."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0

    def __repr__(self) -> str:
        return f"LaunchCounter({self.name!r}, launches={self.launches})"
