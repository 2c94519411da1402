"""The Driver loop (reference: presto_tpu/operators/driver.py;
operator/Driver.java:68, hot loop processInternal:371 — for each
adjacent (current, next) pair, move one batch current.getOutput() ->
next.addInput()).

The host loop only moves tensor handles between operators; CUDA work
is queued asynchronously, so the device stays busy while the host
walks the chain: while split N's kernels run, the next pass already
pulls split N+1 from the source. The reference's batch pump (a second
loop that double-buffers a fused `scan -> kernel` pipeline) adds no
overlap this loop lacks here, so the port has the pair loop only
(ROADMAP A7).
"""

from __future__ import annotations

from typing import List

from presto_tpu_torch.operators.base import Operator


class Driver:
    def __init__(self, operators: List[Operator]):
        if not operators:
            raise ValueError("driver needs at least one operator")
        self.operators = operators
        self._closed = False

    def is_finished(self) -> bool:
        return self._closed or self.operators[-1].is_finished()

    def process(self) -> bool:
        """One pass over the operator chain; True if a batch moved."""
        ops = self.operators
        moved = False
        for i in range(len(ops) - 1):
            current, nxt = ops[i], ops[i + 1]
            cur_finished = current.is_finished()
            if nxt.needs_input() and not cur_finished:
                batch = current.get_output()
                if batch is not None:
                    nxt.add_input(batch)
                    moved = True
            # unwind finished prefix (Driver.java:438-447)
            if cur_finished:
                nxt.finish()
        tail = ops[-1]
        if not tail.is_finished() and tail.get_output() is not None:
            moved = True
        return moved

    def describe(self) -> str:
        """The chain with each operator's batch counts (for a livelock
        report)."""
        return " -> ".join(
            f"{op.ctx.name}[{op.ctx.stats.input_batches} in/"
            f"{op.ctx.stats.output_batches} out]" for op in self.operators)

    def close(self) -> None:
        if not self._closed:
            for op in self.operators:
                op.close()
            self._closed = True
