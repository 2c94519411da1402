"""array_agg / map_agg collection operator (reference:
presto_tpu/operators/array_agg.py; operator/aggregation/
ArrayAggregationFunction.java + MapAggregationFunction).

Each group's collected elements land in a fixed-width [groups, W] block,
emitted as W scalar slot columns plus a length column under the
`<out>__a{j}` / `<out>__len` convention (map_agg: `<out>__k{j}` /
`<out>__v{j}` / `<out>__len`) that the planner's value forms read (see
nodes.Field.form). W is the session's `array_agg_width`.

Single step only. The operator evaluates its keys, values, map values
and FILTER masks per input batch through the expression path (K12 on
the card, like every other projection), buffers the results, and at
finish collects them in one pass (`collect`): the rows sorted by their
group keys with arrival order kept (`common.sort_rows`), the group ids
and first rows from K13 (`ops/window.window_segments`, the keys as
partition keys and no order key), and K17 (`csrc/array_collect.cu`),
which writes each group's contributors in order into its row of the
block. Arrival order inside a group is kept, so parallel array_agg /
map_agg calls see pairwise-consistent orders (what makes the map_agg
key/value zip correct).

A group collecting more than W elements raises a device flag read once
at finish; ArrayAggWidthExceeded then makes the runner re-plan and
re-run the query with `array_agg_width` x4 (the width is fixed in the
plan's value forms).
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.batch import Batch, Column, bucket_capacity
from presto_tpu_torch.expr.compile import CompiledExpr
from presto_tpu_torch.operators.base import (
    DriverContext, Operator, OperatorContext, OperatorFactory,
)
from presto_tpu_torch.ops import common
from presto_tpu_torch.telemetry import kernels as _tk
from presto_tpu_torch.types import BIGINT

#: launches of the CUDA collect kernel (csrc/array_collect.cu)
ARRAY_COLLECT_KERNEL = _tk.LaunchCounter("array_collect", "array_agg")


class ArrayAggWidthExceeded(Exception):
    """A group collected more than array_agg_width elements; the runner
    retries with the suggested width."""

    def __init__(self, suggested: int):
        super().__init__(
            f"array_agg exceeded its element capacity; retry with "
            f"array_agg_width {suggested}")
        self.suggested = suggested


class CollectSpec:
    """One collection call: array_agg (value only) or map_agg (`value`
    is the KEY expression, `map_value` the value expression)."""

    def __init__(self, out_name: str, value: CompiledExpr,
                 map_value: Optional[CompiledExpr] = None,
                 mask: Optional[CompiledExpr] = None):
        self.out_name = out_name
        self.value = value
        self.map_value = map_value
        self.mask = mask            # FILTER (WHERE ...)


#: one spec's input columns: (value, map value or None, FILTER or None),
#: each a (data, mask) pair in input row order
SpecCols = Tuple[common.CVal, Optional[common.CVal], Optional[common.CVal]]


def collect_plain(order: torch.Tensor, pid: torch.Tensor, nlive: int,
                  groups: int, specs: Sequence[SpecCols], width: int,
                  out_rows: int):
    """Plain version of K17: the reference's arithmetic (:98-147) over
    rows sorted by group (`order`: sorted row -> input row; `pid`: the
    group of each sorted row, the `nlive` live rows first, `groups`
    groups). Per spec the [out_rows, width] block(s) and lengths; then
    the first row of each group and the overflow flag (a length past
    `width`). Rows of groups at or past `out_rows`, and non-contributing
    rows, are dropped from the scatter rather than clipped onto a live
    slot."""
    n = order.shape[0]
    dev = order.device
    pos_n = torch.arange(n, device=dev)
    svalid = pos_n < nlive
    gid = torch.where(svalid, pid, torch.full_like(pid, out_rows))
    prev = torch.roll(pid, 1)
    bnd = svalid & ((pos_n == 0) | (pid != prev))
    outputs = []
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    gidx = torch.clamp(gid, max=out_rows)
    for (vd, vm), mcol, fcol in specs:
        contributing = svalid.clone()
        if fcol is not None:
            contributing &= fcol[0][order].to(torch.bool) & fcol[1][order]
        if mcol is not None:
            contributing &= vm[order]   # map_agg drops NULL keys
        ci = contributing.to(torch.int64)
        c = torch.cumsum(ci, 0)
        seg_first = torch.where(bnd, c - ci, torch.full_like(c, -1))
        seg_base = torch.full((out_rows + 1,), -1, dtype=torch.int64,
                              device=dev)
        seg_base.scatter_reduce_(0, gidx, seg_first, "amax")
        pos = c - 1 - seg_base[gidx]
        lens = torch.zeros(out_rows + 1, dtype=torch.int64, device=dev)
        lens.index_add_(0, gidx, ci)
        lens = lens[:out_rows]
        overflow = overflow | (lens > width).any()
        put = contributing & (pos < width) & (gid < out_rows)
        rows, slots = gid[put], pos[put]
        src = order[put]

        def scatter(d, m):
            block = torch.zeros((out_rows, width), dtype=d.dtype,
                                device=dev)
            bmask = torch.zeros((out_rows, width), dtype=torch.bool,
                                device=dev)
            block[rows, slots] = d[src]
            bmask[rows, slots] = m[src]
            return block, bmask
        vb, vmask = scatter(vd, vm)
        if mcol is not None:
            mb, mmask = scatter(*mcol)
            outputs.append((vb, vmask, mb, mmask, lens))
        else:
            outputs.append((vb, vmask, None, None, lens))
    first = torch.full((out_rows + 1,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, gidx, torch.where(bnd, pos_n,
                                               torch.full_like(pos_n, n)),
                          "amin")
    first_row = torch.clamp(first[:out_rows], max=n - 1)
    return outputs, first_row, overflow


_SLOTS = ("val", "val_mask", "mval", "mval_mask", "filt", "filt_mask",
          "block", "bmask", "mblock", "mmask", "lens")


def _collect_cuda(order, pid, nlive, groups, specs, width, out_rows):
    from presto_tpu_torch.native import cuda
    dev = order.device
    n = order.shape[0]
    for t, what in ((order, "order"), (pid, "pid")):
        common.check_rows(t, n, dev, (torch.int64,), f"array_collect: {what}")
    lib = cuda.library("array_collect")
    first_row = torch.empty(out_rows, dtype=torch.int64, device=dev)
    flag = torch.zeros(1, dtype=torch.int32, device=dev)
    starts = torch.empty(max(groups, 1), dtype=torch.int64, device=dev)

    def block(dtype):
        return torch.empty((out_rows, width), dtype=dtype, device=dev)
    outputs = []
    max_specs = lib.presto_collect_max_specs()
    for lo in range(0, len(specs), max_specs):
        run = specs[lo:lo + max_specs]
        cols = {k: [] for k in _SLOTS + ("size", "msize")}
        for (vd, vm), mcol, fcol in run:
            inputs = (("val", vd, vd.dtype), ("val_mask", vm, torch.bool),
                      ("mval", mcol and mcol[0], mcol and mcol[0].dtype),
                      ("mval_mask", mcol and mcol[1], torch.bool),
                      ("filt", fcol and fcol[0], torch.bool),
                      ("filt_mask", fcol and fcol[1], torch.bool))
            for what, t, dt in inputs:
                if t is not None:
                    common.check_rows(t, n, dev, (dt,),
                                      f"array_collect: {what}")
            out = (block(vd.dtype), block(torch.bool),
                   None if mcol is None else block(mcol[0].dtype),
                   None if mcol is None else block(torch.bool),
                   torch.empty(out_rows, dtype=torch.int64, device=dev))
            for k, t in zip(_SLOTS, [t for _, t, _ in inputs] + list(out)):
                cols[k].append(0 if t is None else t.data_ptr())
            cols["size"].append(vd.element_size())
            cols["msize"].append(mcol[0].element_size() if mcol else 1)
            outputs.append(out)
        k = len(run)
        P, I = ctypes.c_int64 * k, ctypes.c_int32 * k
        ptrs = [P(*cols[name]) for name in _SLOTS]
        status = lib.presto_array_collect(
            *ptrs, I(*cols["size"]), I(*cols["msize"]), ctypes.c_int32(k),
            ctypes.c_void_p(order.data_ptr()),
            ctypes.c_void_p(pid.data_ptr()), ctypes.c_int64(n),
            ctypes.c_int64(nlive), ctypes.c_int64(groups),
            ctypes.c_int64(out_rows), ctypes.c_int32(width),
            ctypes.c_void_p(first_row.data_ptr()),
            ctypes.c_void_p(flag.data_ptr()),
            ctypes.c_void_p(starts.data_ptr()),
            ctypes.c_void_p(cuda.stream_ptr(dev)))
        cuda.check(lib, status, "array_collect")
        ARRAY_COLLECT_KERNEL.launches += 1
    return outputs, first_row, flag[0] != 0


def array_collect(order: torch.Tensor, pid: torch.Tensor, nlive: int,
                  groups: int, specs: Sequence[SpecCols], width: int,
                  out_rows: int):
    """K17 (see `collect_plain`): one launch per COLLECT_MAX_SPECS specs.
    The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if order.device.type == "cpu":
        return collect_plain(order, pid, nlive, groups, specs, width,
                             out_rows)
    return _collect_cuda(order, pid, nlive, groups, specs, width, out_rows)


def collect(batch: Batch, key_syms: Sequence[str],
            specs_meta: Sequence[Tuple[str, Optional[str], Optional[str]]],
            out_cap: int, width: int):
    """The reference's `_collect_kernel` (:66): (group keys, group
    validity, per spec (block, mask, map block, map mask, lengths),
    overflow). specs_meta: per spec (value column, map-value column or
    None, FILTER column or None) of `batch`.

    The blocks have min(out_cap, bucket_capacity(groups)) rows rather
    than the reference's out_cap: the group count is read to the host
    first (the reference reads it at drain anyway), so a block is never
    larger than its live groups need; rows past the groups are zero, as
    in the reference. Overflow: more groups than out_cap, or a length
    past `width`."""
    _tk.count("array_agg")
    n = batch.capacity
    dev = batch.device
    keys = [batch.columns[s].astuple() for s in key_syms]
    skeys, svalid, (order,) = common.sort_rows(
        keys, valid=batch.row_valid,
        payloads=[torch.arange(n, device=dev)])
    from presto_tpu_torch.ops.window import window_segments
    pid = window_segments(skeys, [], svalid).pid
    nlive, last = torch.stack([svalid.sum(), pid[-1] + 1]).tolist()
    groups = last if nlive else 0
    out_rows = min(out_cap, bucket_capacity(max(groups, 1)))
    specs = []
    for vsym, msym, fsym in specs_meta:
        specs.append((batch.columns[vsym].astuple(),
                      None if msym is None else batch.columns[msym].astuple(),
                      None if fsym is None
                      else batch.columns[fsym].astuple()))
    outputs, first_row, overflow = array_collect(
        order, pid, nlive, groups, specs, width, out_rows)
    gvalid = torch.arange(out_rows, device=dev) < groups
    gkeys = [(d[first_row], m[first_row] & gvalid) for d, m in skeys]
    return gkeys, gvalid, outputs, overflow | (groups > out_cap)


class ArrayAggOperator(Operator):
    def __init__(self, ctx: OperatorContext, key_names: Sequence[str],
                 key_exprs: Sequence[CompiledExpr],
                 specs: Sequence[CollectSpec], width: int, eval_body):
        super().__init__(ctx)
        self.key_names = list(key_names)
        self.key_exprs = list(key_exprs)
        self.specs = list(specs)
        self.width = width
        self._eval = eval_body
        self._batches: List[Batch] = []
        self._finishing = False
        self._emitted = False

    def needs_input(self) -> bool:
        return not self._finishing

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        # evaluate keys and arguments now, so the buffer holds only the
        # columns the collection reads
        self._batches.append(self._eval(batch))

    def get_output(self) -> Optional[Batch]:
        if not self._finishing or self._emitted:
            return None
        self._emitted = True
        if not self._batches:
            return self._count_out(self._empty_output())
        cap = bucket_capacity(max(sum(b.capacity for b in self._batches),
                                  1))
        big = Batch.concat(self._batches, cap)
        self._batches = []
        key_syms = [f"__k{i}" for i in range(len(self.key_exprs))]
        specs_meta = [(f"__v{i}",
                       f"__m{i}" if s.map_value is not None else None,
                       f"__f{i}" if s.mask is not None else None)
                      for i, s in enumerate(self.specs)]
        gkeys, gvalid, outputs, overflow = collect(
            big, key_syms, specs_meta, cap, self.width)
        live, over = torch.stack([gvalid.sum(),
                                  overflow.to(torch.int64)]).tolist()
        if over:
            raise ArrayAggWidthExceeded(self.width * 4)
        rows = bucket_capacity(max(live, 1))
        cols = {}
        for name, ke, (kd, km) in zip(self.key_names, self.key_exprs,
                                      gkeys):
            cols[name] = Column(kd[:rows], km[:rows], ke.type, ke.dictionary)
        for s, (vb, vm, mb, mm, lens) in zip(self.specs, outputs):
            # slot-major copies, so every slot column is a contiguous
            # tensor (the reference slices a copy of each slot too)
            cols.update(self._slot_columns(
                s, *[None if b is None else b[:rows].t().contiguous()
                     for b in (vb, vm, mb, mm)]))
            cols[f"{s.out_name}__len"] = Column(lens[:rows], gvalid[:rows],
                                                BIGINT, None)
        return self._count_out(Batch(cols, gvalid[:rows]))

    def _slot_columns(self, s: CollectSpec, vb, vm, mb, mm):
        """The W slot columns of one spec from its slot-major [W, rows]
        block(s) (for map_agg, its key and value slots)."""
        cols = {}
        for j in range(self.width):
            if s.map_value is not None:
                cols[f"{s.out_name}__k{j}"] = Column(
                    vb[j], vm[j], s.value.type, s.value.dictionary)
                cols[f"{s.out_name}__v{j}"] = Column(
                    mb[j], mm[j], s.map_value.type, s.map_value.dictionary)
            else:
                cols[f"{s.out_name}__a{j}"] = Column(
                    vb[j], vm[j], s.value.type, s.value.dictionary)
        return cols

    def _empty_output(self) -> Batch:
        dev = self.ctx.driver_context.device
        cap = bucket_capacity(1)

        def zeros(t, *shape):
            return torch.zeros(*shape, cap, dtype=t.torch_dtype, device=dev)
        no = torch.zeros(cap, dtype=torch.bool, device=dev)
        cols = {name: Column(zeros(ke.type), no, ke.type, ke.dictionary)
                for name, ke in zip(self.key_names, self.key_exprs)}
        for s in self.specs:
            none = torch.zeros(self.width, cap, dtype=torch.bool, device=dev)
            mb = None if s.map_value is None \
                else zeros(s.map_value.type, self.width)
            cols.update(self._slot_columns(
                s, zeros(s.value.type, self.width), none, mb, none))
            cols[f"{s.out_name}__len"] = Column(zeros(BIGINT), no, BIGINT,
                                                None)
        return Batch(cols, no)

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing and self._emitted

    def close(self) -> None:
        self._batches = []


class ArrayAggOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, key_names: Sequence[str],
                 key_exprs: Sequence[CompiledExpr],
                 specs: Sequence[CollectSpec], width: int, input_dicts):
        super().__init__(operator_id, "array_agg")
        self.key_names = list(key_names)
        self.key_exprs = list(key_exprs)
        self.specs = list(specs)
        self.width = width
        from presto_tpu_torch.operators.core import (
            make_filter_project_kernel,
        )
        projections = [(f"__k{i}", ke) for i, ke in enumerate(key_exprs)]
        for i, s in enumerate(specs):
            projections.append((f"__v{i}", s.value))
            if s.map_value is not None:
                projections.append((f"__m{i}", s.map_value))
            if s.mask is not None:
                projections.append((f"__f{i}", s.mask))
        # one projection of every key and argument (K12 on the card)
        self._eval = make_filter_project_kernel(None, projections,
                                                input_dicts)

    def create(self, driver_context: DriverContext) -> Operator:
        return ArrayAggOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            self.key_names, self.key_exprs, self.specs, self.width,
            self._eval)
