"""Kernel-family call counts and CUDA launch counters (a small
counterpart of presto_tpu/telemetry/kernels.py, whose compile/execute
attribution and metrics export come with the telemetry slice).

`CALLS[family]` counts every call into a kernel family on any device,
under the family names of the JAX package's kernel contracts
(`agg_step`, `compact`, `filter_project`, ...): the same numbers as the
reference's `presto_tpu_kernel_calls_total`. A `LaunchCounter` belongs
to one hand-written CUDA kernel's wrapper and counts only the launches
of that kernel, so a run can show that the main path went through it;
it names the reference family the kernel computes, and `COUNTERS` holds
every counter by kernel name. K24-K26 (`sort_encode`, `radix_sort`,
`gather_rows`) count under `sort`, though every sort of the port runs
them (topn, distinct, join_build, agg_step by sort, hashagg_merge,
window, array_agg: those families' calls count under their own names
in `CALLS`); K27 (`limit_rank`) counts under `limit`. The `fragment`
kernel (K12, `expr/codegen.py`) serves two reference families:
`filter_project` (a lone FilterProject) and `fragment` (a fused chain).

`FUSED_FRAGMENTS[(status, reason)]` counts the fusion pass's decisions
(planner/fusion.py; the counterpart of
`presto_tpu_fused_fragments_total{status,reason}`). A call
of a fused step counts under both `fragment` (its K12 launch) and the
terminal's own family (its fold), where the reference counts one
`fragment` call for the one program it traces.
"""

from __future__ import annotations

import collections

#: family -> calls, on any device
CALLS: "collections.Counter[str]" = collections.Counter()


def count(family: str) -> None:
    CALLS[family] += 1


#: (status, reason) -> chains; status is fused / partial / fallback
FUSED_FRAGMENTS: "collections.Counter[tuple]" = collections.Counter()


class LaunchCounter:
    """Launches of one CUDA kernel, incremented by its wrapper where it
    launches the kernel and nowhere else. `family` is the reference
    kernel family it computes (the kernel's own name by default)."""

    def __init__(self, name: str, family: str = ""):
        self.name = name
        self.family = family or name
        self.launches = 0
        COUNTERS[name] = self

    def __repr__(self) -> str:
        return (f"LaunchCounter({self.name!r}, family={self.family!r}, "
                f"launches={self.launches})")


#: kernel name -> its LaunchCounter
COUNTERS: "dict[str, LaunchCounter]" = {}
