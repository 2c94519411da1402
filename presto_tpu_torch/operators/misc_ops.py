"""Cross join, EnforceSingleRow, AssignUniqueId, GroupId, the local
union queue and the spool (reference: presto_tpu/operators/misc_ops.py;
NestedLoopBuildOperator / NestedLoopJoinOperator,
EnforceSingleRowOperator, AssignUniqueIdOperator, GroupIdOperator and
operator/exchange/LocalExchange.java:64 for the union queue).

The cross product is kernel K10 `cross_product` (csrc/cross_product.cu)
on CUDA tensors and `cross_product_plain` on CPU tensors. The other
operators move batches between pipelines and carry no kernel. The port's
runner drives a plan's pipelines in order, so a union's producers and a
spool's filler have finished before their consumer starts; the queue and
the spool keep the reference's protocol all the same.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.batch import (
    Batch, Column, bucket_capacity, empty_batch, remap_column,
)
from presto_tpu_torch.operators.base import (
    DriverContext, Operator, OperatorContext, OperatorFactory,
)
from presto_tpu_torch.ops import common
from presto_tpu_torch.telemetry import kernels as _tk
from presto_tpu_torch.types import BIGINT

#: a cross join that would materialize more output slots than this
#: raises (the reference's guard, misc_ops.py:97-101)
CROSS_MAX_SLOTS = 1 << 24


class NestedLoopBridge:
    """Materialized build side for cross joins."""

    def __init__(self):
        self.batch: Optional[Batch] = None

    @property
    def ready(self) -> bool:
        return self.batch is not None


class NestedLoopBuildOperator(Operator):
    def __init__(self, ctx: OperatorContext, bridge: NestedLoopBridge,
                 schema_cols: Optional[Sequence[tuple]] = None):
        super().__init__(ctx)
        self.bridge = bridge
        self.schema_cols = schema_cols
        self._batches: List[Batch] = []
        self._finished = False

    def needs_input(self) -> bool:
        return not self._finished

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        self._batches.append(batch)

    def get_output(self) -> Optional[Batch]:
        return None

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        if not self._batches:
            if self.schema_cols is None:
                raise RuntimeError("empty cross-join build needs its schema")
            self.bridge.batch = empty_batch(self.schema_cols,
                                            self.ctx.driver_context.device)
            return
        total = int(sum(b.row_valid.sum() for b in self._batches))
        self.bridge.batch = Batch.concat(
            self._batches, bucket_capacity(max(total, 1)), live_rows=total)
        self._batches = []

    def is_finished(self) -> bool:
        return self._finished

    def close(self) -> None:
        # the build outlives this driver: the probe's driver releases it
        self._batches = []


class NestedLoopJoinOperator(Operator):
    """Cross product; build sides here are small by construction (scalar
    subqueries, EXISTS counts, tiny dimension tables). Both sides are
    compacted (K2) before the product, and a product past
    CROSS_MAX_SLOTS output slots raises, as in the reference."""

    def __init__(self, ctx: OperatorContext, bridge: NestedLoopBridge):
        super().__init__(ctx)
        self.bridge = bridge
        self._pending: Optional[Batch] = None
        self._finishing = False

    def needs_input(self) -> bool:
        return self._pending is None and not self._finishing

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        if not self.bridge.ready:
            raise RuntimeError(f"{self.ctx.name}: probe before its build "
                               "finished (build pipelines run first)")
        build = self.bridge.batch
        nb = build.num_valid()
        np_rows = batch.num_valid()
        out_cap = bucket_capacity(max(nb * np_rows, 1))
        if out_cap > CROSS_MAX_SLOTS:
            raise RuntimeError(
                f"cross join would materialize {nb * np_rows} rows; "
                "add a join condition")
        self._pending = cross_product(batch.compact(), build.compact(),
                                      np_rows, nb, out_cap)

    def get_output(self) -> Optional[Batch]:
        out, self._pending = self._pending, None
        return self._count_out(out)

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing and self._pending is None

    def close(self) -> None:
        self._pending = None
        self.bridge.batch = None


# -- K10: the cross product ---------------------------------------------------


#: launches of the CUDA cross-product kernel (csrc/cross_product.cu)
CROSS_PRODUCT_KERNEL = _tk.LaunchCounter("cross_product", "nested_loop")


def cross_product_plain(probe: Batch, build: Batch, np_rows: int, nb: int,
                        out_cap: int) -> Batch:
    """Plain version of K10 (the reference's `_cross_product`): slot s
    pairs probe row s // nb with build row s % nb, live below nb * np,
    the live-row counts of the two (compacted) sides."""
    div = max(nb, 1)
    slots = torch.arange(out_cap, device=probe.device)
    live = slots < nb * np_rows
    pid = torch.clamp(slots // div, 0, probe.capacity - 1)
    bid = torch.clamp(slots % div, 0, build.capacity - 1)
    cols: Dict[str, Column] = {}
    for side, rows in ((probe, pid), (build, bid)):
        for name, c in side.columns.items():
            cols[name] = Column(c.data[rows], c.mask[rows] & live, c.type,
                                c.dictionary)
    return Batch(cols, live)


def _cross_product_cuda(probe: Batch, build: Batch, np_rows: int, nb: int,
                        out_cap: int) -> Batch:
    from presto_tpu_torch.native import cuda
    dev = probe.device
    if not 1 <= out_cap <= CROSS_MAX_SLOTS:
        raise ValueError(f"cross_product: {out_cap} output slots")
    cols: Dict[str, Column] = {}
    spec = []
    for side, batch in ((0, probe), (1, build)):
        n = batch.capacity
        common.check_rows(batch.row_valid, n, dev, (torch.bool,),
                          "cross_product: row_valid")
        for name, c in batch.columns.items():
            common.check_rows(c.data, n, dev, (c.data.dtype,),
                              f"cross_product: column {name}")
            common.check_rows(c.mask, n, dev, (torch.bool,),
                              f"cross_product: mask of {name}")
            data = torch.empty(out_cap, dtype=c.data.dtype, device=dev)
            mask = torch.empty(out_cap, dtype=torch.bool, device=dev)
            cols[name] = Column(data, mask, c.type, c.dictionary)
            spec.append((c.data.data_ptr(), c.mask.data_ptr(),
                         data.data_ptr(), mask.data_ptr(),
                         c.data.element_size(), side))
    live = torch.empty(out_cap, dtype=torch.bool, device=dev)
    lib = cuda.library("cross_product")
    for table_args in common.gather_chunks(spec, "cross_product"):
        status = lib.presto_cross_product(
            ctypes.c_int64(np_rows), ctypes.c_int64(probe.capacity),
            ctypes.c_int64(nb), ctypes.c_int64(build.capacity),
            *table_args, ctypes.c_void_p(live.data_ptr()),
            ctypes.c_int64(out_cap), ctypes.c_void_p(cuda.stream_ptr(dev)))
        cuda.check(lib, status, "cross_product")
        CROSS_PRODUCT_KERNEL.launches += 1
    return Batch(cols, live)


def cross_product(probe: Batch, build: Batch, np_rows: int, nb: int,
                  out_cap: int) -> Batch:
    """K10: every probe row against every build row into `out_cap`
    output slots (see `cross_product_plain`); `np_rows` and `nb` are the
    live-row counts of the compacted probe and build. The CUDA kernel on
    CUDA tensors, the plain version on CPU tensors."""
    _tk.count("nested_loop")
    if probe.device.type == "cpu":
        return cross_product_plain(probe, build, np_rows, nb, out_cap)
    return _cross_product_cuda(probe, build, np_rows, nb, out_cap)


# -- the operators without a kernel -----------------------------------------


class AssignUniqueIdOperator(Operator):
    """Appends a unique BIGINT row-id column (reference:
    AssignUniqueIdOperator): id = start + stride * (batch offset +
    position). Padding rows get ids too (their row_valid is False)."""

    def __init__(self, ctx: OperatorContext, symbol: str,
                 start: int = 0, stride: int = 1):
        super().__init__(ctx)
        self.symbol = symbol
        self._start = start
        self._stride = stride
        self._offset = 0
        self._pending: Optional[Batch] = None
        self._finishing = False

    def needs_input(self) -> bool:
        return self._pending is None and not self._finishing

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        dev = batch.device
        ids = self._start + self._stride * (
            self._offset + torch.arange(batch.capacity, dtype=torch.int64,
                                        device=dev))
        self._offset += batch.capacity
        cols = dict(batch.columns)
        cols[self.symbol] = Column(
            ids, torch.ones(batch.capacity, dtype=torch.bool, device=dev),
            BIGINT, None)
        self._pending = Batch(cols, batch.row_valid)

    def get_output(self) -> Optional[Batch]:
        out, self._pending = self._pending, None
        return self._count_out(out)

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing and self._pending is None


class AssignUniqueIdOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, symbol: str,
                 start: int = 0, stride: int = 1):
        super().__init__(operator_id, "assign_unique_id")
        self.symbol = symbol
        self.start = start
        self.stride = stride

    def create(self, driver_context: DriverContext) -> Operator:
        return AssignUniqueIdOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            self.symbol, self.start, self.stride)


class GroupIdOperator(Operator):
    """GROUPING SETS replication (reference: GroupIdOperator.java):
    each input batch is emitted once per grouping set with the key
    columns not in that set masked NULL, plus a constant group-id
    column and one constant column per grouping(...) call. Aggregation
    arguments flow through unchanged; only the materialized key copies
    are masked. Constant columns and masks are fills, no kernel."""

    def __init__(self, ctx: OperatorContext,
                 groupings: Sequence[Tuple[str, ...]],
                 gid_symbol: str,
                 grouping_outputs: Sequence[Tuple[str, Tuple[int, ...]]]):
        super().__init__(ctx)
        self.groupings = list(groupings)
        self.gid_symbol = gid_symbol
        self.grouping_outputs = list(grouping_outputs)
        self._all_keys = set().union(*map(set, self.groupings)) \
            if self.groupings else set()
        # constant gid/grouping columns per batch capacity
        self._consts: Dict[int, List[Dict[str, Column]]] = {}
        self._pending: List[Batch] = []
        self._finishing = False

    def needs_input(self) -> bool:
        return not self._pending and not self._finishing

    def _const_cols(self, cap: int, dev: torch.device
                    ) -> List[Dict[str, Column]]:
        cached = self._consts.get(cap)
        if cached is None:
            true_mask = torch.ones(cap, dtype=torch.bool, device=dev)
            cached = []
            for g in range(len(self.groupings)):
                cols = {self.gid_symbol: Column(
                    torch.full((cap,), g, dtype=torch.int64, device=dev),
                    true_mask, BIGINT, None)}
                for sym, vals in self.grouping_outputs:
                    cols[sym] = Column(
                        torch.full((cap,), vals[g], dtype=torch.int64,
                                   device=dev), true_mask, BIGINT, None)
                cached.append(cols)
            self._consts[cap] = cached
        return cached

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        cap = batch.capacity
        consts = self._const_cols(cap, batch.device)
        null_mask = torch.zeros(cap, dtype=torch.bool, device=batch.device)
        for g, present in enumerate(self.groupings):
            cols = dict(batch.columns)
            for name in self._all_keys:
                if name not in present:
                    col = batch.columns[name]
                    cols[name] = Column(col.data, null_mask, col.type,
                                        col.dictionary)
            cols.update(consts[g])
            self._pending.append(Batch(cols, batch.row_valid))

    def get_output(self) -> Optional[Batch]:
        if not self._pending:
            return None
        return self._count_out(self._pending.pop(0))

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing and not self._pending


class GroupIdOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int,
                 groupings: Sequence[Tuple[str, ...]],
                 gid_symbol: str,
                 grouping_outputs: Sequence[Tuple[str, Tuple[int, ...]]]):
        super().__init__(operator_id, "group_id")
        self.groupings = groupings
        self.gid_symbol = gid_symbol
        self.grouping_outputs = grouping_outputs

    def create(self, driver_context: DriverContext) -> Operator:
        return GroupIdOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            self.groupings, self.gid_symbol, self.grouping_outputs)


class EnforceSingleRowOperator(Operator):
    """Scalar subquery contract (reference: EnforceSingleRowOperator):
    an error on more than one row; no row yields one all-NULL row. Where
    the source yields no batch at all (a scan its constraint pruned),
    the NULL row takes `schema_cols`, where the reference's operator
    fails on its missing first batch."""

    def __init__(self, ctx: OperatorContext,
                 schema_cols: Optional[Sequence[tuple]] = None):
        super().__init__(ctx)
        self.schema_cols = schema_cols
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
            if self.schema_cols is None:
                raise RuntimeError("EnforceSingleRow of no batch needs "
                                   "its schema")
            self._batches = [empty_batch(self.schema_cols,
                                         self.ctx.driver_context.device)]
        total = int(sum(b.row_valid.sum() for b in self._batches))
        if total > 1:
            raise RuntimeError("Scalar sub-query has returned multiple rows")
        if total == 1:
            merged = Batch.concat(self._batches, 16, live_rows=total)
            self._batches = []
            return self._count_out(merged)
        # no rows: one row of NULLs
        proto = self._batches[0]
        dev = proto.device
        cols = {name: Column(torch.zeros(16, dtype=c.data.dtype, device=dev),
                             torch.zeros(16, dtype=torch.bool, device=dev),
                             c.type, c.dictionary)
                for name, c in proto.columns.items()}
        rv = torch.zeros(16, dtype=torch.bool, device=dev)
        rv[0] = True
        self._batches = []
        return self._count_out(Batch(cols, rv))

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing and self._emitted


class LocalQueue:
    """In-process exchange between pipelines (LocalExchange.java:64)."""

    def __init__(self, producers: int):
        self.items: List[Batch] = []
        self.open_producers = producers

    def push(self, batch: Batch) -> None:
        self.items.append(batch)

    def producer_done(self) -> None:
        self.open_producers -= 1

    @property
    def finished(self) -> bool:
        return self.open_producers <= 0 and not self.items


class LocalQueueSinkOperator(Operator):
    """Tail of a producer pipeline; renames symbols to the consumer's and
    re-encodes string columns onto the consumer's dictionaries (`dicts`,
    by consumer symbol: a UNION's output dictionary is the union of its
    inputs', and its consumers decode every batch with it)."""

    def __init__(self, ctx: OperatorContext, queue: LocalQueue,
                 rename: Dict[str, str],
                 dicts: Optional[Dict[str, tuple]] = None):
        super().__init__(ctx)
        self.queue = queue
        self.rename = rename
        self.dicts = dicts or {}
        self._finished = False

    def needs_input(self) -> bool:
        return not self._finished

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        if self.rename:
            batch = batch.rename(self.rename)
        cols = dict(batch.columns)
        for name, dic in self.dicts.items():
            if cols[name].dictionary is not None:
                cols[name] = remap_column(cols[name], dic)
        self.queue.push(Batch(cols, batch.row_valid) if self.dicts
                        else batch)

    def get_output(self) -> Optional[Batch]:
        return None

    def finish(self) -> None:
        if not self._finished:
            self._finished = True
            self.queue.producer_done()

    def is_finished(self) -> bool:
        return self._finished

    def close(self) -> None:
        self.finish()


class LocalQueueSourceOperator(Operator):
    def __init__(self, ctx: OperatorContext, queue: LocalQueue):
        super().__init__(ctx)
        self.queue = queue

    def needs_input(self) -> bool:
        return False

    def add_input(self, batch: Batch) -> None:
        raise RuntimeError("source takes no input")

    def get_output(self) -> Optional[Batch]:
        if self.queue.items:
            return self._count_out(self.queue.items.pop(0))
        return None

    def finish(self) -> None:
        pass

    def is_finished(self) -> bool:
        return self.queue.finished


class Spool:
    """Materialized output of a subtree shared by several plan parents.
    Filled once by a SpoolSinkOperator pipeline and replayed to every
    consumer, so a DAG-shaped plan (the probe side of a unique-id EXISTS
    decorrelation feeding both a join and a semi join) runs the shared
    subtree exactly once. A batch is released once every registered
    consumer's cursor has passed it."""

    def __init__(self):
        self.batches: List[Optional[Batch]] = []
        self.done = False
        self._cursors: List[int] = []

    def register_consumer(self) -> int:
        self._cursors.append(0)
        return len(self._cursors) - 1

    def advance(self, consumer: int, position: int) -> None:
        self._cursors[consumer] = position
        for i in range(min(self._cursors)):
            self.batches[i] = None


class SpoolSinkOperator(Operator):
    def __init__(self, ctx: OperatorContext, spool: Spool):
        super().__init__(ctx)
        self.spool = spool
        self._finished = False

    def needs_input(self) -> bool:
        return not self._finished

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        self.spool.batches.append(batch)

    def get_output(self) -> Optional[Batch]:
        return None

    def finish(self) -> None:
        if not self._finished:
            self._finished = True
            self.spool.done = True

    def is_finished(self) -> bool:
        return self._finished

    def close(self) -> None:
        self.finish()


class SpoolSourceOperator(Operator):
    """Replays a finished spool; each consumer has its own cursor."""

    def __init__(self, ctx: OperatorContext, spool: Spool, consumer: int):
        super().__init__(ctx)
        self.spool = spool
        self._consumer = consumer
        self._i = 0

    def needs_input(self) -> bool:
        return False

    def add_input(self, batch: Batch) -> None:
        raise RuntimeError("source takes no input")

    def get_output(self) -> Optional[Batch]:
        if not self.spool.done:
            raise RuntimeError(f"{self.ctx.name}: spool read before it "
                               "was filled (its pipeline runs first)")
        if self._i < len(self.spool.batches):
            b = self.spool.batches[self._i]
            if b is None:
                raise RuntimeError("spool batch released before replay")
            self._i += 1
            self.spool.advance(self._consumer, self._i)
            return self._count_out(b)
        return None

    def finish(self) -> None:
        pass

    def is_finished(self) -> bool:
        return self.spool.done and self._i >= len(self.spool.batches)


class _SimpleFactory(OperatorFactory):
    def __init__(self, operator_id: int, name: str, fn):
        super().__init__(operator_id, name)
        self._fn = fn

    def create(self, driver_context: DriverContext) -> Operator:
        return self._fn(OperatorContext(self.operator_id, self.name,
                                        driver_context))


def nested_loop_build_factory(op_id: int, bridge: NestedLoopBridge,
                              schema_cols=None):
    return _SimpleFactory(
        op_id, "nl_build",
        lambda ctx: NestedLoopBuildOperator(ctx, bridge, schema_cols))


def nested_loop_join_factory(op_id: int, bridge: NestedLoopBridge):
    return _SimpleFactory(op_id, "nl_join",
                          lambda ctx: NestedLoopJoinOperator(ctx, bridge))


def enforce_single_row_factory(op_id: int, schema_cols=None):
    return _SimpleFactory(
        op_id, "enforce_single_row",
        lambda ctx: EnforceSingleRowOperator(ctx, schema_cols))


def queue_sink_factory(op_id: int, queue: LocalQueue,
                       rename: Dict[str, str],
                       dicts: Optional[Dict[str, tuple]] = None):
    return _SimpleFactory(op_id, "local_sink",
                          lambda ctx: LocalQueueSinkOperator(ctx, queue,
                                                             rename, dicts))


def queue_source_factory(op_id: int, queue: LocalQueue):
    return _SimpleFactory(op_id, "local_source",
                          lambda ctx: LocalQueueSourceOperator(ctx, queue))


def spool_sink_factory(op_id: int, spool: Spool):
    return _SimpleFactory(op_id, "spool_sink",
                          lambda ctx: SpoolSinkOperator(ctx, spool))


def spool_source_factory(op_id: int, spool: Spool):
    consumer = spool.register_consumer()
    return _SimpleFactory(
        op_id, "spool_source",
        lambda ctx: SpoolSourceOperator(ctx, spool, consumer))
