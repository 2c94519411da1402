"""Grouped aggregation, direct slot-table path (reference:
presto_tpu/ops/hashagg.py; HashAggregationOperator.java:47 with the
BigintGroupByHash-style small-domain specialization).

When every group key is dictionary-coded or boolean, the combined code
domain is known statically and the group id IS the table slot: one
reduction per state component into a fixed [G] table, no sort. That
reduction, for all components of a step at once, is kernel K1
(csrc/slot_reduce.cu) on CUDA; `slot_reduce_plain` is its plain
version and the CPU path.

The sort-based path for high-cardinality keys (`batch_aggregate`,
`_group_reduce`, `merge_partials`) comes with the Q3/Q18 slice.

Unlike the JAX reference, whose fold is functional, `direct_step`
updates the slot table IN PLACE: the table is the operator's private
accumulator, and in-place atomics are what the kernel does.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column, bucket_capacity, pad_batch
from presto_tpu_torch.telemetry import kernels as _tk
from presto_tpu_torch.types import BIGINT, BOOLEAN, DOUBLE, Type

CVal = Tuple[torch.Tensor, torch.Tensor]


class HighCardinalityGrouping(Exception):
    """The group keys are not all dictionary-coded or boolean, or their
    slot table would exceed DIRECT_SLOTS_MAX: the sort-based path is
    needed, and it is not ported yet."""


@dataclasses.dataclass(frozen=True)
class AggFunction:
    """One aggregate: state layout + per-row contribution + final.

    `init(value, weight)` maps a row's input to state contributions,
    one tensor per state component, each reduced into the slot table
    with its entry of `reduces` (sum/min/max)."""

    name: str
    state_dtypes: Tuple  # np.dtype per component
    reduces: Tuple[str, ...]
    init: Callable[[Optional[torch.Tensor], torch.Tensor],
                   Tuple[torch.Tensor, ...]]
    final: Callable[[Tuple[torch.Tensor, ...]], CVal]
    output_type: Type = BIGINT
    intermediate_types: Tuple[Type, ...] = ()


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


def _ident_for(reduce: str, dtype: torch.dtype):
    """The reduction's identity as a Python number of `dtype`'s range
    (the reference's `_ident_for`: the type's max for min, min for
    max, never an infinity)."""
    if reduce == "sum":
        return 0
    info = torch.finfo(dtype) if dtype.is_floating_point \
        else torch.iinfo(dtype)
    return info.max if reduce == "min" else info.min


def _where0(w: torch.Tensor, value: torch.Tensor, fill, dtype):
    return torch.where(w, value, torch.full_like(value, fill)).to(dtype)


@functools.lru_cache(maxsize=None)
def make_sum(input_type: Type, output_type: Type) -> AggFunction:
    dt = output_type.torch_dtype

    def init(value, w):
        return (_where0(w, value, 0, dt), w.to(torch.int64))

    def final(state):
        total, cnt = state
        return total, cnt > 0  # SUM of an empty/all-null group is NULL
    return AggFunction("sum", (output_type.np_dtype, np.dtype(np.int64)),
                       ("sum", "sum"), init, final, output_type,
                       (output_type, BIGINT))


@functools.lru_cache(maxsize=None)
def make_count(input_type: Optional[Type]) -> AggFunction:
    def init(value, w):
        return (w.to(torch.int64),)

    def final(state):
        return state[0], torch.ones_like(state[0], dtype=torch.bool)
    return AggFunction("count", (np.dtype(np.int64),), ("sum",),
                       init, final, BIGINT, (BIGINT,))


@functools.lru_cache(maxsize=None)
def make_avg(input_type: Type) -> AggFunction:
    def init(value, w):
        return (_where0(w, value.to(torch.float64), 0, torch.float64),
                w.to(torch.int64))

    def final(state):
        total, cnt = state
        return total / torch.clamp(cnt, min=1), cnt > 0
    return AggFunction("avg", (np.dtype(np.float64), np.dtype(np.int64)),
                       ("sum", "sum"), init, final, DOUBLE,
                       (DOUBLE, BIGINT))


def _make_minmax(input_type: Type, reduce: str) -> AggFunction:
    dt = input_type.torch_dtype
    ident = _ident_for(reduce, dt)

    def init(value, w):
        return (_where0(w, value.to(dt), ident, dt), w.to(torch.int64))

    def final(state):
        return state[0], state[1] > 0
    return AggFunction(reduce, (input_type.np_dtype, np.dtype(np.int64)),
                       (reduce, "sum"), init, final, input_type,
                       (input_type, BIGINT))


@functools.lru_cache(maxsize=None)
def make_min(input_type: Type) -> AggFunction:
    return _make_minmax(input_type, "min")


@functools.lru_cache(maxsize=None)
def make_max(input_type: Type) -> AggFunction:
    return _make_minmax(input_type, "max")


@functools.lru_cache(maxsize=None)
def make_variance(kind: str) -> AggFunction:
    """var_samp/var_pop/stddev/stddev_pop via the sum-mergeable
    (n, sum, sum of squares) state."""
    pop = kind.endswith("_pop")
    sqrt = kind.startswith("stddev")

    def init(value, w):
        v = _where0(w, value.to(torch.float64), 0, torch.float64)
        return (w.to(torch.int64), v, v * v)

    def final(state):
        n, s, ss = state
        nf = torch.clamp(n, min=1).to(torch.float64)
        m2 = ss - (s * s) / nf
        denom = nf if pop else torch.clamp(nf - 1, min=1)
        v = torch.clamp(m2, min=0.0) / denom
        if sqrt:
            v = torch.sqrt(v)
        return v, (n > 0) if pop else (n > 1)
    return AggFunction(kind, (np.dtype(np.int64), np.dtype(np.float64),
                              np.dtype(np.float64)),
                       ("sum", "sum", "sum"), init, final, DOUBLE,
                       (BIGINT, DOUBLE, DOUBLE))


@functools.lru_cache(maxsize=None)
def make_count_if() -> AggFunction:
    def init(value, w):
        return ((w & value.to(torch.bool)).to(torch.int64),)

    def final(state):
        return state[0], torch.ones_like(state[0], dtype=torch.bool)
    return AggFunction("count_if", (np.dtype(np.int64),), ("sum",),
                       init, final, BIGINT, (BIGINT,))


@functools.lru_cache(maxsize=None)
def make_bool_and(is_or: bool) -> AggFunction:
    def init(value, w):
        b = value.to(torch.bool)
        v = (w & b) if is_or else torch.where(w, b, torch.ones_like(b))
        return (v.to(torch.int64), w.to(torch.int64))

    def final(state):
        v, cnt = state
        return v > 0, cnt > 0
    return AggFunction("bool_or" if is_or else "bool_and",
                       (np.dtype(np.int64), np.dtype(np.int64)),
                       ("max" if is_or else "min", "sum"),
                       init, final, BOOLEAN, (BOOLEAN, BIGINT))


@functools.lru_cache(maxsize=None)
def make_geometric_mean() -> AggFunction:
    def init(value, w):
        v = _where0(w, value.to(torch.float64), 1, torch.float64)
        return (torch.log(v), w.to(torch.int64))

    def final(state):
        slog, cnt = state
        return torch.exp(slog / torch.clamp(cnt, min=1)), cnt > 0
    return AggFunction("geometric_mean",
                       (np.dtype(np.float64), np.dtype(np.int64)),
                       ("sum", "sum"), init, final, DOUBLE,
                       (DOUBLE, BIGINT))


@functools.lru_cache(maxsize=None)
def make_moments(kind: str) -> AggFunction:
    """skewness / kurtosis via sum-mergeable raw moments."""
    def init(value, w):
        v = _where0(w, value.to(torch.float64), 0, torch.float64)
        return (w.to(torch.int64), v, v * v, v ** 3, v ** 4)

    def final(state):
        n_i, s1, s2, s3, s4 = state
        n = torch.clamp(n_i, min=1).to(torch.float64)
        m = s1 / n
        m2 = s2 / n - m * m
        m3 = s3 / n - 3 * m * s2 / n + 2 * m ** 3
        m4 = s4 / n - 4 * m * s3 / n + 6 * m * m * s2 / n - 3 * m ** 4
        if kind == "skewness":
            v = m3 / torch.clamp(m2, min=1e-300) ** 1.5
            return v, n_i > 2
        g2 = m4 / torch.clamp(m2 * m2, min=1e-300) - 3.0
        v = ((n - 1) / torch.clamp((n - 2) * (n - 3), min=1)
             * ((n + 1) * g2 + 6))
        return v, n_i > 3
    return AggFunction(kind, (np.dtype(np.int64),) + (np.dtype(
        np.float64),) * 4, ("sum",) * 5, init, final, DOUBLE,
        (BIGINT,) + (DOUBLE,) * 4)


@functools.lru_cache(maxsize=None)
def make_entropy() -> AggFunction:
    def init(value, w):
        v = _where0(w, torch.clamp(value, min=0).to(torch.float64), 0,
                    torch.float64)
        clogc = torch.where(v > 0, v * torch.log(v), torch.zeros_like(v))
        return (v, clogc)

    def final(state):
        total, sclogc = state
        t = torch.clamp(total, min=1e-300)
        ent = (torch.log(t) - sclogc / t) / float(np.log(2.0))
        return torch.clamp(ent, min=0.0), total > 0
    return AggFunction("entropy", (np.dtype(np.float64),) * 2,
                       ("sum", "sum"), init, final, DOUBLE,
                       (DOUBLE, DOUBLE))


#: approx_distinct's error bounds, kept here for the analyzer's checks;
#: the HLL aggregate itself (a vector state) is a later slice.
HLL_DEFAULT_ERROR = 0.023
HLL_MIN_ERROR, HLL_MAX_ERROR = 0.0040625, 0.26
HLL_HONORED_MIN_ERROR = 1.04 / (1 << 7)

#: Max slot-table size for the direct-indexing (sort-free) path.
DIRECT_SLOTS_MAX = 1 << 16


# -- the slot table ----------------------------------------------------


@dataclasses.dataclass
class DirectState:
    """Slot-indexed accumulator: slot = mixed-radix key code."""
    states: List[Tuple[torch.Tensor, ...]]
    present: torch.Tensor  # bool [G] — slot has seen a live row


def direct_init(aggs: Sequence[AggFunction], num_slots: int,
                device: torch.device) -> DirectState:
    states = []
    for a in aggs:
        comps = []
        for dt, r in zip(a.state_dtypes, a.reduces):
            tdt = _torch_dtype(dt)
            comps.append(torch.full((num_slots,), _ident_for(r, tdt),
                                    dtype=tdt, device=device))
        states.append(tuple(comps))
    return DirectState(states, torch.zeros(num_slots, dtype=torch.bool,
                                           device=device))


def slot_ids(row_valid: torch.Tensor, key_codes: Sequence[CVal],
             domains: Tuple[int, ...], num_slots: int) -> torch.Tensor:
    """Mixed-radix slot per row (most significant key first); a NULL
    key takes code == domain; dead rows go to the drop slot
    `num_slots`."""
    gid = torch.zeros(row_valid.shape[0], dtype=torch.int64,
                      device=row_valid.device)
    for (code, mask), dom in zip(key_codes, domains):
        c = torch.where(mask, code.to(torch.int64),
                        torch.full_like(gid, dom))
        gid = gid * (dom + 1) + c
    return torch.where(row_valid, gid, torch.full_like(gid, num_slots))


def slot_reduce_plain(row_valid: torch.Tensor, key_codes: Sequence[CVal],
                      domains: Tuple[int, ...],
                      comps: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                            str]],
                      present: torch.Tensor) -> None:
    """Plain version of K1 (the reference's `_slot_reduce` per
    component, plus the `present` max): reduce each (contribution,
    state, op) into its state in place, through a table of
    num_slots + 1 entries whose last one takes the dead rows."""
    num_slots = present.shape[0]
    gid = slot_ids(row_valid, key_codes, domains, num_slots)
    for contrib, arr, r in comps:
        red = torch.full((num_slots + 1,), _ident_for(r, arr.dtype),
                         dtype=arr.dtype, device=arr.device)
        if r == "sum":
            red.index_add_(0, gid, contrib)
            arr.add_(red[:num_slots])
        else:
            red.scatter_reduce_(0, gid, contrib,
                                reduce="amin" if r == "min" else "amax")
            merge = torch.minimum if r == "min" else torch.maximum
            arr.copy_(merge(arr, red[:num_slots]))
    seen = torch.zeros(num_slots + 1, dtype=torch.int64,
                       device=present.device)
    seen.index_add_(0, gid, row_valid.to(torch.int64))
    present |= seen[:num_slots] > 0


#: launches of the CUDA slot-reduce kernel (csrc/slot_reduce.cu)
SLOT_REDUCE_KERNEL = _tk.LaunchCounter("direct_slot_reduce")

_KERNEL_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
                  torch.float64: 3}
_KERNEL_OPS = {"sum": 0, "min": 1, "max": 2}


def _slot_reduce_cuda(row_valid, key_codes, domains, comps,
                      present) -> None:
    """Launch csrc/slot_reduce.cu. Takes contiguous 1-D tensors on
    one device: int32 key codes, bool key masks and row_valid, and
    per component a contribution of the state's dtype (int32, int64,
    float32 or float64); anything else raises."""
    from presto_tpu_torch.native import cuda
    dev = row_valid.device
    n = row_valid.shape[0]
    num_slots = present.shape[0]

    def need(t: torch.Tensor, rows: int, dtypes, what: str) -> None:
        if t.device != dev or t.dim() != 1 or t.shape[0] != rows \
                or not t.is_contiguous() or t.dtype not in dtypes:
            raise ValueError(
                f"direct_slot_reduce: {what} must be a contiguous 1-D "
                f"{'/'.join(str(d) for d in dtypes)} tensor of {rows} "
                f"rows on {dev}; got {t.dtype} {tuple(t.shape)} "
                f"stride {t.stride()} on {t.device}")
    need(row_valid, n, (torch.bool,), "row_valid")
    need(present, num_slots, (torch.bool,), "present")
    if len(key_codes) > 8 or len(comps) > 64:
        raise ValueError("direct_slot_reduce: at most 8 keys and 64 "
                         "state components")
    for code, mask in key_codes:
        need(code, n, (torch.int32,), "key codes")
        need(mask, n, (torch.bool,), "key mask")
    for contrib, arr, r in comps:
        need(arr, num_slots, tuple(_KERNEL_DTYPES), "state component")
        need(contrib, n, (arr.dtype,), "contribution")
        if r not in _KERNEL_OPS:
            raise ValueError(f"direct_slot_reduce: reduce {r!r}")
    lib = cuda.library("slot_reduce")
    K, C = max(len(key_codes), 1), max(len(comps), 1)
    P = ctypes.c_int64
    status = lib.presto_direct_slot_reduce(
        (P * K)(*[c.data_ptr() for c, _ in key_codes]),
        (P * K)(*[m.data_ptr() for _, m in key_codes]),
        (ctypes.c_int32 * K)(*domains),
        ctypes.c_int32(len(key_codes)),
        ctypes.c_void_p(row_valid.data_ptr()), ctypes.c_int64(n),
        (P * C)(*[c.data_ptr() for c, _, _ in comps]),
        (P * C)(*[a.data_ptr() for _, a, _ in comps]),
        (ctypes.c_int32 * C)(*[_KERNEL_DTYPES[a.dtype]
                               for _, a, _ in comps]),
        (ctypes.c_int32 * C)(*[_KERNEL_OPS[r] for _, _, r in comps]),
        ctypes.c_int32(len(comps)), ctypes.c_void_p(present.data_ptr()),
        ctypes.c_int32(num_slots), ctypes.c_void_p(cuda.stream_ptr(dev)))
    cuda.check(lib, status, "direct_slot_reduce")
    SLOT_REDUCE_KERNEL.launches += 1


def direct_slot_reduce(row_valid: torch.Tensor, key_codes: Sequence[CVal],
                       domains: Tuple[int, ...],
                       comps: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                             str]],
                       present: torch.Tensor) -> None:
    """K1: reduce every (contribution, state, op) of one batch into the
    slot table in place, and mark the slots live rows reached. The
    CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if row_valid.device.type == "cpu":
        slot_reduce_plain(row_valid, key_codes, domains, comps, present)
    else:
        _slot_reduce_cuda(row_valid, key_codes, domains, comps, present)


def direct_step(state: DirectState,
                row_valid: torch.Tensor,
                key_codes: Sequence[CVal],
                domains: Tuple[int, ...],
                agg_inputs: Sequence,
                agg_weights: Sequence[torch.Tensor],
                aggs: Sequence[AggFunction]) -> DirectState:
    """Accumulate one batch into the slot table (in place). NULL keys
    get their own slot (code == domain), mirroring SQL's
    NULL-is-a-group semantics."""
    keys = [(code.to(torch.int32).contiguous(), mask.contiguous())
            for code, mask in key_codes]
    comps = []
    for agg, st, inp, w in zip(aggs, state.states, agg_inputs,
                               agg_weights):
        for arr, c, r in zip(st, agg.init(inp, w), agg.reduces):
            comps.append((c.to(arr.dtype).contiguous(), arr, r))
    direct_slot_reduce(row_valid.contiguous(), keys, domains, comps,
                       state.present)
    return state


def _decode_slots(state: DirectState, key_names: Sequence[str],
                  key_types: Sequence[Type],
                  key_dicts: Sequence[Optional[tuple]],
                  domains: Tuple[int, ...]
                  ) -> Tuple[Dict[str, Column], torch.Tensor]:
    """Key columns decoded from the slot index (mixed radix, most-
    significant key first) plus the output row_valid. A global
    aggregation (no keys) emits exactly one row even over zero input
    rows (count(*) = 0)."""
    num_slots = state.present.shape[0]
    slot = torch.arange(num_slots, device=state.present.device)
    cols: Dict[str, Column] = {}
    stride = num_slots
    for name, typ, dic, dom in zip(key_names, key_types, key_dicts,
                                   domains):
        stride //= (dom + 1)
        code = (slot // stride) % (dom + 1)
        mask = (code < dom) & state.present
        cols[name] = Column(code.to(typ.torch_dtype), mask, typ, dic)
    rv = state.present if key_names else torch.ones_like(state.present)
    return cols, rv


def direct_finalize(state: DirectState, key_names: Sequence[str],
                    key_types: Sequence[Type],
                    key_dicts: Sequence[Optional[tuple]],
                    domains: Tuple[int, ...],
                    out_names: Sequence[str],
                    aggs: Sequence[AggFunction]) -> Batch:
    """One output row per present slot."""
    cols, rv = _decode_slots(state, key_names, key_types, key_dicts,
                             domains)
    for name, agg, st in zip(out_names, aggs, state.states):
        d, m = agg.final(st)
        cols[name] = Column(d.to(agg.output_type.torch_dtype), m & rv,
                            agg.output_type, None)
    # pad the slot table up to its power-of-two capacity bucket
    out = Batch(cols, rv)
    return pad_batch(out, bucket_capacity(out.capacity) - out.capacity)
