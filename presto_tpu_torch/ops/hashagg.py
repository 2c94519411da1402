"""Grouped aggregation (reference: presto_tpu/ops/hashagg.py;
HashAggregationOperator.java:47), on two paths.

Direct slot table. When every group key is dictionary-coded or
boolean, the combined code domain is known statically and the group id
IS the table slot: one reduction per state component into a fixed [G]
table, no sort. That reduction, for all components of a step at once,
is kernel K1 (csrc/slot_reduce.cu) on CUDA; `slot_reduce_plain` is its
plain version and the CPU path. Unlike the JAX reference, whose fold
is functional, `direct_step` updates the slot table IN PLACE: the
table is the operator's private accumulator, and in-place atomics are
what the kernel does.

Sort-based, for every other key set (`batch_aggregate`,
`merge_partials`, `_group_reduce`). Grouping needs equal keys adjacent,
not a total key order, so rows are sorted by their two row hashes
(h1, h2): K3 (csrc/row_hash.cu) hashes the keys, K25
(csrc/radix_sort.cu) orders the rows by the two hashes and K26
(csrc/gather_rows.cu) moves them, and K6 (csrc/segment_reduce.cu) finds the
group boundaries (hash or key change), assigns packed group ids and
reduces every state component per group into `out_cap` slots, with an
overflow flag when there are more groups. The reference takes this
hash-radix form on its CPU branch (:619-637); the port takes it on both
devices. Groups land in hash order, which differs between devices and
from the reference's TPU key order: no caller may rely on group order
(the final ORDER BY or merge regroups by key).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column, bucket_capacity, pad_batch
from presto_tpu_torch.ops import common
from presto_tpu_torch.telemetry import kernels as _tk
from presto_tpu_torch.types import BIGINT, BOOLEAN, DOUBLE, Type

CVal = Tuple[torch.Tensor, torch.Tensor]


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
SLOT_REDUCE_KERNEL = _tk.LaunchCounter("direct_slot_reduce", "agg_step")

_KERNEL_DTYPES = {torch.int32: 0, torch.int64: 1, torch.float32: 2,
                  torch.float64: 3}
_KERNEL_OPS = {"sum": 0, "min": 1, "max": 2}


#: most keys and state components one launch of K1, K6 or K8 takes
#: (csrc/slot_reduce.cu MAX_KEYS, csrc/segment.cuh PRESTO_MAX_COMPS)
KERNEL_MAX_KEYS = 8
KERNEL_MAX_COMPS = 64


def comp_chunks(n: int) -> List[Tuple[int, int]]:
    """[lo, hi) runs of at most KERNEL_MAX_COMPS components (one run
    when there are none): K1 and K6 take more over several launches."""
    return [(lo, min(lo + KERNEL_MAX_COMPS, n))
            for lo in range(0, n, KERNEL_MAX_COMPS)] or [(0, 0)]


def agg_chunks(aggs: Sequence[AggFunction]) -> List[Tuple[int, int]]:
    """[lo, hi) runs of whole aggregates whose state components fit one
    launch of K8 (one run when there are none)."""
    runs, lo, held = [], 0, 0
    for i, agg in enumerate(aggs):
        k = len(agg.reduces)
        if held + k > KERNEL_MAX_COMPS and i > lo:
            runs.append((lo, i))
            lo, held = i, 0
        held += k
    runs.append((lo, len(aggs)))
    return runs


def fold_key_codes(key_codes: Sequence[CVal], domains: Tuple[int, ...]
                   ) -> Tuple[List[CVal], Tuple[int, ...]]:
    """At most KERNEL_MAX_KEYS (code, mask) keys for K1: the leading
    keys beyond that fold into one always-present code, their
    mixed-radix slot id (NULL = domain), whose domain is the product of
    theirs. K1 then computes the same slot ids as `slot_ids`."""
    if len(key_codes) <= KERNEL_MAX_KEYS:
        return list(key_codes), tuple(domains)
    m = len(key_codes) - KERNEL_MAX_KEYS + 1
    gid = None
    dom = 1
    for (code, mask), d in zip(key_codes[:m], domains[:m]):
        c = torch.where(mask, code.to(torch.int64),
                        torch.full_like(code, d, dtype=torch.int64))
        gid = c if gid is None else gid * (d + 1) + c
        dom *= d + 1
    lead = (gid.to(torch.int32), torch.ones_like(key_codes[0][1]))
    return [lead] + list(key_codes[m:]), (dom - 1,) + tuple(domains[m:])


def _slot_reduce_cuda(row_valid, key_codes, domains, comps,
                      present) -> None:
    """K1 over any number of keys and components: see fold_key_codes
    and comp_chunks (every launch marks the same present slots)."""
    key_codes, domains = fold_key_codes(key_codes, domains)
    for lo, hi in comp_chunks(len(comps)):
        _slot_reduce_launch(row_valid, key_codes, domains, comps[lo:hi],
                            present)


def _slot_reduce_launch(row_valid, key_codes, domains, comps,
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
    if len(key_codes) > KERNEL_MAX_KEYS or len(comps) > KERNEL_MAX_COMPS:
        raise ValueError(f"direct_slot_reduce: at most {KERNEL_MAX_KEYS} "
                         f"keys and {KERNEL_MAX_COMPS} state components "
                         "per launch")
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
                aggs: Sequence[AggFunction],
                merge: Optional[Sequence[bool]] = None) -> DirectState:
    """Accumulate one batch into the slot table (in place). NULL keys
    get their own slot (code == domain), mirroring SQL's
    NULL-is-a-group semantics. Where `merge[i]`, the FINAL step's
    input i is a tuple of partial state columns, folded with the same
    reductions (K1)."""
    keys = [(code.to(torch.int32).contiguous(), mask.contiguous())
            for code, mask in key_codes]
    merge = merge or [False] * len(aggs)
    contribs = _make_contribs(aggs, agg_inputs, agg_weights, merge)
    comps = []
    for agg, st, cb in zip(aggs, state.states, contribs):
        for arr, c, r in zip(st, cb, agg.reduces):
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


def direct_intermediate(state: DirectState, key_names: Sequence[str],
                        key_types: Sequence[Type],
                        key_dicts: Sequence[Optional[tuple]],
                        domains: Tuple[int, ...],
                        out_names: Sequence[str],
                        aggs: Sequence[AggFunction]) -> Batch:
    """The PARTIAL step's output on the direct path: keys decoded as in
    direct_finalize, every state array as a column <out>__s{i}
    (reference: presto_tpu/ops/hashagg.py:1021)."""
    cols, rv = _decode_slots(state, key_names, key_types, key_dicts,
                             domains)
    for name, agg, st in zip(out_names, aggs, state.states):
        for i, (arr, it) in enumerate(zip(st, agg.intermediate_types)):
            cols[f"{name}__s{i}"] = Column(arr.to(it.torch_dtype), rv,
                                           it, None)
    out = Batch(cols, rv)
    return pad_batch(out, bucket_capacity(out.capacity) - out.capacity)


# -- the sort-based path -----------------------------------------------


@dataclasses.dataclass
class GroupByState:
    """Running accumulator of the sort path: key columns + per-agg
    state arrays, packed: `valid[g]` is True for the first live groups
    and False after them."""
    keys: List[CVal]
    states: List[Tuple[torch.Tensor, ...]]
    valid: torch.Tensor
    overflow: torch.Tensor  # bool scalar


def _full_state(n: int, np_dtype, reduce: str,
                device: torch.device) -> torch.Tensor:
    dt = _torch_dtype(np_dtype)
    return torch.full((n,), _ident_for(reduce, dt), dtype=dt,
                      device=device)


def _gate(w: torch.Tensor, contrib: torch.Tensor, ident) -> torch.Tensor:
    return torch.where(w, contrib, torch.full_like(contrib, ident))


def init_state(key_types: Sequence[Type], aggs: Sequence[AggFunction],
               max_groups: int, device: torch.device) -> GroupByState:
    keys = [(torch.zeros(max_groups, dtype=t.torch_dtype, device=device),
             torch.zeros(max_groups, dtype=torch.bool, device=device))
            for t in key_types]
    states = [tuple(_full_state(max_groups, dt, r, device)
                    for dt, r in zip(a.state_dtypes, a.reduces))
              for a in aggs]
    return GroupByState(keys, states,
                        torch.zeros(max_groups, dtype=torch.bool,
                                    device=device),
                        torch.zeros((), dtype=torch.bool, device=device))


def _first_rows(bnd: torch.Tensor, gid: torch.Tensor,
                out_cap: int) -> torch.Tensor:
    """Index of the first row of each packed group (segment min of the
    boundary rows' indices); empty slots take row n - 1."""
    n = gid.shape[0]
    idx = torch.where(bnd, torch.arange(n, device=gid.device),
                      torch.full_like(gid, n))
    first = torch.full((out_cap + 1,), n, dtype=torch.int64,
                       device=gid.device)
    first.scatter_reduce_(0, torch.clamp(gid, 0, out_cap), idx, "amin")
    return torch.clamp(first[:out_cap], 0, n - 1)


def _sorted_reduce(sarr: torch.Tensor, gid: torch.Tensor, out_cap: int,
                   reduce: str) -> torch.Tensor:
    """Reduce a contribution array sorted by group id into `out_cap`
    packed slots (dead rows carry gid == out_cap and are dropped); an
    empty slot holds the reduction's identity."""
    red = torch.full((out_cap + 1,), _ident_for(reduce, sarr.dtype),
                     dtype=sarr.dtype, device=sarr.device)
    if reduce == "sum":
        red.index_add_(0, gid, sarr)
    else:
        red.scatter_reduce_(0, gid, sarr,
                            "amin" if reduce == "min" else "amax")
    return red[:out_cap]


def segment_reduce_plain(h1: torch.Tensor, h2: torch.Tensor,
                         keys: Sequence[CVal], valid: torch.Tensor,
                         comps: Sequence[Tuple[torch.Tensor, str]],
                         out_cap: int):
    """Plain version of K6, over rows sorted by (h1, h2): every
    (contribution, op) reduced into out_cap packed group slots, each
    group's first row, the group count and the overflow flag.
    Returns (reduced, first_row, groups, overflow)."""
    bnd, gid, groups = segment_ids(h1, h2, keys, valid, out_cap)
    reduced = [_sorted_reduce(c, gid, out_cap, r) for c, r in comps]
    return (reduced, _first_rows(bnd, gid, out_cap), groups,
            groups > out_cap)


def segment_ids(h1: torch.Tensor, h2: torch.Tensor, keys: Sequence[CVal],
                valid: torch.Tensor, out_cap: int):
    """Over rows sorted by (h1, h2): the group boundaries, the packed
    group id of every row (dead rows and groups past out_cap go to
    out_cap) and the group count."""
    bnd = common.boundaries(keys, valid, hashes=(h1, h2))
    cum = torch.cumsum(bnd.to(torch.int64), 0)
    gid = torch.where(valid, torch.clamp(cum - 1, max=out_cap),
                      torch.full_like(cum, out_cap))
    return bnd, gid, cum[-1]


#: launches of the CUDA segment-reduce kernel (csrc/segment_reduce.cu)
SEGMENT_REDUCE_KERNEL = _tk.LaunchCounter("segment_reduce", "agg_step")


def _segment_key_changes(keys, n, dev):
    """K6's keys past its first group of MAX_KEYS: a byte per row, 1
    where any of them differs from the row before (NULL equal to NULL),
    ORed by one launch per group; None when there are none."""
    from presto_tpu_torch.native import cuda
    rest = common.key_groups(keys)[1:]
    if not rest:
        return None
    changes = torch.zeros(n, dtype=torch.uint8, device=dev)
    lib = cuda.library("segment_reduce")
    for group in rest:
        kd, km, kt, nk = common.key_args(group, n, dev, "segment_reduce")
        cuda.check(lib, lib.presto_segment_key_changes(
            kd, km, kt, nk, ctypes.c_int64(n),
            ctypes.c_void_p(changes.data_ptr()),
            ctypes.c_void_p(cuda.stream_ptr(dev))), "segment_reduce")
    return changes


def _segment_reduce_cuda(h1, h2, keys, valid, comps, out_cap):
    """K6 over any number of components (comp_chunks) and key columns
    (the first MAX_KEYS compared in the kernel, the rest folded into a
    per-row change flag first): every launch finds the same groups,
    first rows and count."""
    reduced = []
    for lo, hi in comp_chunks(len(comps)):
        outs, first_row, groups, overflow = _segment_reduce_launch(
            h1, h2, keys, valid, comps[lo:hi], out_cap)
        reduced.extend(outs)
    return reduced, first_row, groups, overflow


def _segment_reduce_launch(h1, h2, keys, valid, comps, out_cap):
    from presto_tpu_torch.native import cuda
    dev = valid.device
    n = valid.shape[0]
    common.check_rows(valid, n, dev, (torch.bool,),
                      "segment_reduce: valid")
    common.check_rows(h1, n, dev, (torch.int64,), "segment_reduce: h1")
    common.check_rows(h2, n, dev, (torch.int64,), "segment_reduce: h2")
    changes = _segment_key_changes(keys, n, dev)
    kd, km, kt, nk = common.key_args(keys[:common.MAX_KEYS], n, dev,
                                     "segment_reduce")
    if len(comps) > KERNEL_MAX_COMPS or n < 1 or out_cap < 1:
        raise ValueError(f"segment_reduce: at most {KERNEL_MAX_COMPS} "
                         "components per launch, at least one row and "
                         "one output slot")
    for c, r in comps:
        common.check_rows(c, n, dev, tuple(_KERNEL_DTYPES),
                          "segment_reduce: contribution")
        if r not in _KERNEL_OPS:
            raise ValueError(f"segment_reduce: reduce {r!r}")
    lib = cuda.library("segment_reduce")
    tile = lib.presto_segment_tile()
    outs = [torch.empty(out_cap, dtype=c.dtype, device=dev)
            for c, _ in comps]
    first_row = torch.empty(out_cap, dtype=torch.int64, device=dev)
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    tiles = torch.empty((n + tile - 1) // tile, dtype=torch.int64,
                        device=dev)
    starts = torch.empty(out_cap + 1, dtype=torch.int64, device=dev)
    C = max(len(comps), 1)
    P = ctypes.c_int64 * C
    status = lib.presto_segment_reduce(
        ctypes.c_void_p(h1.data_ptr()), ctypes.c_void_p(h2.data_ptr()),
        kd, km, kt, nk,
        ctypes.c_void_p(None if changes is None else changes.data_ptr()),
        ctypes.c_void_p(valid.data_ptr()),
        ctypes.c_int64(n), P(*[c.data_ptr() for c, _ in comps]),
        P(*[o.data_ptr() for o in outs]),
        (ctypes.c_int32 * C)(*[_KERNEL_DTYPES[c.dtype] for c, _ in comps]),
        (ctypes.c_int32 * C)(*[_KERNEL_OPS[r] for _, r in comps]),
        ctypes.c_int32(len(comps)), ctypes.c_int64(out_cap),
        ctypes.c_void_p(first_row.data_ptr()),
        ctypes.c_void_p(stats.data_ptr()),
        ctypes.c_void_p(flags.data_ptr()),
        ctypes.c_void_p(tiles.data_ptr()),
        ctypes.c_void_p(starts.data_ptr()),
        ctypes.c_void_p(cuda.stream_ptr(dev)))
    cuda.check(lib, status, "segment_reduce")
    SEGMENT_REDUCE_KERNEL.launches += 1
    return outs, first_row, stats[0], stats[1] > 0


def segment_reduce(h1: torch.Tensor, h2: torch.Tensor,
                   keys: Sequence[CVal], valid: torch.Tensor,
                   comps: Sequence[Tuple[torch.Tensor, str]],
                   out_cap: int):
    """K6 (see `segment_reduce_plain`). The CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if valid.device.type == "cpu":
        return segment_reduce_plain(h1, h2, keys, valid, comps, out_cap)
    return _segment_reduce_cuda(h1, h2, keys, valid, comps, out_cap)


def _group_reduce(keys: Sequence[CVal], valid: torch.Tensor,
                  contribs: Sequence[Tuple[torch.Tensor, ...]],
                  aggs: Sequence[AggFunction],
                  out_cap: int, plain: bool = False) -> GroupByState:
    """The sort-based grouping core: K3 hashes, K25's stable sort of
    (h1, h2), K26's move of the keys, contributions and hashes, K6, and
    K26 again for each group's first row (with `plain`, the plain
    versions of K3, K25, K26 and K6 on any device: the card's yardstick
    for the composition). Boundaries
    compare the actual keys as well, so a double hash collision between
    distinct keys can only split a group (the next merge level rejoins
    it), never merge two keys. Groups
    beyond out_cap are dropped and the overflow flag set (the caller's
    retry protocol). Group order is backend-dependent: callers must
    not rely on it."""
    dev = valid.device
    slots = torch.arange(out_cap, device=dev)
    if not keys:
        # global aggregation: one group, a straight reduction per
        # component (non-contributing rows already hold the identity)
        states = []
        for st, agg in zip(contribs, aggs):
            red = []
            for arr, r, dt in zip(st, agg.reduces, agg.state_dtypes):
                v = arr.sum() if r == "sum" else (
                    arr.min() if r == "min" else arr.max())
                full = _full_state(out_cap, dt, r, dev)
                full[0] = v.to(full.dtype)
                red.append(full)
            states.append(tuple(red))
        return GroupByState([], states, slots == 0,
                            torch.zeros((), dtype=torch.bool, device=dev))
    keys = [(d.contiguous(), m.contiguous()) for d, m in keys]
    hash_pair = common.row_hash_pair_plain if plain \
        else common.row_hash_pair
    lex_perm = common.lex_perm_plain if plain else common.lex_perm
    gather = common.gather_rows_plain if plain else common.gather_rows
    h1, h2 = hash_pair(keys, valid.contiguous(), False)
    perm = lex_perm([h1, h2])
    flat = [(arr, r) for st, agg in zip(contribs, aggs)
            for arr, r in zip(st, agg.reduces)]
    # one K26 launch moves the keys, contributions and hashes
    moved, svalid = gather(
        [(keys + [(arr, None) for arr, _ in flat] + [(h1, None),
                                                      (h2, None)], valid)],
        perm)
    skeys = moved[:len(keys)]
    comps = [(d, r) for (d, _), (_, r) in zip(moved[len(keys):-2], flat)]
    reduced, first_row, groups, overflow = \
        (segment_reduce_plain if plain else segment_reduce)(
            moved[-2][0], moved[-1][0], skeys, svalid, comps, out_cap)
    it = iter(reduced)
    states = [tuple(next(it) for _ in st) for st in contribs]
    new_valid = slots < groups
    new_keys, _ = gather([(skeys, None)], first_row, limit=groups)
    return GroupByState(new_keys, states, new_valid, overflow)


def _make_contribs(aggs, agg_inputs, agg_weights, merge):
    contribs: List[Tuple[torch.Tensor, ...]] = []
    for agg, inp, w, is_merge in zip(aggs, agg_inputs, agg_weights,
                                     merge):
        if is_merge:
            # inp is a tuple of partial state arrays; w gates validity
            contribs.append(tuple(
                _gate(w, p, _ident_for(r, _torch_dtype(dt))).to(
                    _torch_dtype(dt))
                for p, dt, r in zip(inp, agg.state_dtypes, agg.reduces)))
        else:
            contribs.append(tuple(
                c.to(_torch_dtype(dt))
                for c, dt in zip(agg.init(inp, w), agg.state_dtypes)))
    return contribs


def agg_step(state: GroupByState, row_valid: torch.Tensor,
             key_cols: Sequence[CVal], agg_inputs: Sequence,
             agg_weights: Sequence[torch.Tensor],
             aggs: Sequence[AggFunction],
             merge: Optional[Sequence[bool]] = None) -> GroupByState:
    """One functional fold step: regroup [state ++ batch rows]. The
    operator uses batch_aggregate + merge_partials instead (re-sorting
    a large state every batch is the slow way); agg_step stays the
    semantic reference and the path for small accumulators."""
    max_groups = state.valid.shape[0]
    merge = merge or [False] * len(aggs)
    contribs = _make_contribs(aggs, agg_inputs, agg_weights, merge)
    all_keys = [(torch.cat([sk[0], kc[0].to(sk[0].dtype)]),
                 torch.cat([sk[1], kc[1]]))
                for sk, kc in zip(state.keys, key_cols)]
    all_valid = torch.cat([state.valid, row_valid])
    all_states = [tuple(torch.cat([s, c.to(s.dtype)])
                        for s, c in zip(st, cb))
                  for st, cb in zip(state.states, contribs)]
    out = _group_reduce(all_keys, all_valid, all_states, aggs, max_groups)
    return GroupByState(out.keys, out.states, out.valid,
                        state.overflow | out.overflow)


def batch_aggregate(row_valid: torch.Tensor, key_cols: Sequence[CVal],
                    agg_inputs: Sequence,
                    agg_weights: Sequence[torch.Tensor],
                    aggs: Sequence[AggFunction], out_cap: int,
                    merge: Optional[Sequence[bool]] = None
                    ) -> GroupByState:
    """Compact ONE batch to its distinct groups (<= out_cap slots); the
    operator buffers these partials and merges them with
    merge_partials."""
    merge = merge or [False] * len(aggs)
    contribs = _make_contribs(aggs, agg_inputs, agg_weights, merge)
    return _group_reduce(key_cols, row_valid, contribs, aggs, out_cap)


def merge_partials(states: Sequence[GroupByState],
                   aggs: Sequence[AggFunction],
                   out_cap: int) -> GroupByState:
    """Regroup several packed partial states into one of `out_cap`
    slots; overflow flags OR through."""
    keys = [(torch.cat([s.keys[i][0] for s in states]),
             torch.cat([s.keys[i][1] for s in states]))
            for i in range(len(states[0].keys))]
    valid = torch.cat([s.valid for s in states])
    contribs = [tuple(torch.cat([s.states[ai][ci] for s in states])
                      for ci in range(len(states[0].states[ai])))
                for ai in range(len(aggs))]
    out = _group_reduce(keys, valid, contribs, aggs, out_cap)
    ovf = out.overflow
    for s in states:
        ovf = ovf | s.overflow
    return GroupByState(out.keys, out.states, out.valid, ovf)


# -- the presorted path: grouping without a sort (K8) ---------------------


def presorted_aggregate(row_valid: torch.Tensor, key_cols: Sequence[CVal],
                        agg_inputs: Sequence,
                        agg_weights: Sequence[torch.Tensor],
                        aggs: Sequence[AggFunction], out_cap: int,
                        merge: Optional[Sequence[bool]] = None
                        ) -> GroupByState:
    """Group ONE batch whose rows already arrive sorted by the group
    keys (ascending, nulls last): the streaming aggregation's input
    contract. No sort: group boundaries against the previous LIVE row,
    group ids from a scan, states from per-group reductions (K8). Groups
    land packed in key order."""
    merge = merge or [False] * len(aggs)
    contribs = _make_contribs(aggs, agg_inputs, agg_weights, merge)
    return presorted_reduce(row_valid, key_cols, contribs, aggs, out_cap)


def stream_aggregate(carry: GroupByState, row_valid: torch.Tensor,
                     key_cols: Sequence[CVal], agg_inputs: Sequence,
                     agg_weights: Sequence[torch.Tensor],
                     aggs: Sequence[AggFunction], out_cap: int):
    """`presorted_aggregate` and the streaming fold of `carry` in one
    round (`stream_step`)."""
    contribs = _make_contribs(aggs, agg_inputs, agg_weights,
                              [False] * len(aggs))
    return stream_step(carry, row_valid, key_cols, contribs, aggs, out_cap)


def presorted_reduce_plain(row_valid: torch.Tensor,
                           key_cols: Sequence[CVal],
                           contribs: Sequence[Tuple[torch.Tensor, ...]],
                           aggs: Sequence[AggFunction],
                           out_cap: int) -> GroupByState:
    """Plain version of K8 without a carry (the reference's
    `presorted_reduce`): the previous live row of every row from a
    cummax of live indices, both-NULL keys equal, group ids from a
    cumsum. Dead rows take the enclosing group's id; their
    contributions are the reduction's identity."""
    if not key_cols:
        return _group_reduce([], row_valid, contribs, aggs, out_cap)
    bnd, gid, num_groups = presorted_ids(row_valid, key_cols, out_cap)
    states = [tuple(_sorted_reduce(arr, gid, out_cap, r)
                    for arr, r in zip(st, agg.reduces))
              for st, agg in zip(contribs, aggs)]
    slots = torch.arange(out_cap, device=row_valid.device)
    first_row = _first_rows(bnd, gid, out_cap)
    new_valid = slots < num_groups
    keys = [(d[first_row], m[first_row] & new_valid) for d, m in key_cols]
    return GroupByState(keys, states, new_valid, num_groups > out_cap)


def presorted_ids(row_valid: torch.Tensor, key_cols: Sequence[CVal],
                  out_cap: int):
    """Over rows in key order: the group starts (a live row whose keys
    differ from the previous LIVE row's; two NULLs are equal), the group
    id of every row in [0, out_cap] (dead rows take the enclosing
    group's) and the group count."""
    n = row_valid.shape[0]
    idx = torch.arange(n, device=row_valid.device)
    lastv = torch.cummax(torch.where(row_valid, idx,
                                     torch.full_like(idx, -1)), 0).values
    prev = torch.roll(lastv, 1)
    prev[0] = -1
    pidx = torch.clamp(prev, min=0)
    differs = prev < 0  # the first live row always starts a group
    for data, mask in key_cols:
        pd, pm = data[pidx], mask[pidx]
        d = (data != pd) | (mask != pm)
        # both-NULL rows group together (SQL GROUP BY semantics)
        differs = differs | (d & (mask | pm))
    bnd = row_valid & differs
    gid = torch.clamp(torch.cumsum(bnd.to(torch.int64), 0) - 1, 0, out_cap)
    return bnd, gid, bnd.sum()


def stream_fold_plain(carry: GroupByState, partial: GroupByState,
                      aggs: Sequence[AggFunction]):
    """Plain version of K8's carry fold (the reference's
    `_stream_step_jit`). The stream is key-sorted, so the carried group
    can only meet the batch's FIRST group: same keys fold the carry into
    slot 0; different keys complete the carry, which is emitted on its
    own ahead of the batch. Every group but the last is emitted; the
    last becomes the new carry (a batch with no group passes the carry
    through). Returns (carry_emit [1], emit [cap], carry_out [1], emitted
    groups)."""
    ng = partial.valid.sum()
    has_groups = ng > 0
    has_carry = carry.valid[0]
    same = has_carry & has_groups
    for (cd, cm), (pd, pm) in zip(carry.keys, partial.keys):
        eq = torch.where(cm[0] & pm[0], cd[0] == pd[0], ~cm[0] & ~pm[0])
        same = same & eq
    new_states = []
    for cst, pst, agg in zip(carry.states, partial.states, aggs):
        comps = []
        for ca, pa, r in zip(cst, pst, agg.reduces):
            c0 = torch.where(same, ca[0], torch.full_like(
                ca[0], _ident_for(r, ca.dtype))).to(pa.dtype)
            pa = pa.clone()
            if r == "sum":
                pa[0] = pa[0] + c0
            else:
                pa[0] = torch.minimum(pa[0], c0) if r == "min" \
                    else torch.maximum(pa[0], c0)
            comps.append(pa)
        new_states.append(tuple(comps))
    carry_emit = GroupByState(
        carry.keys, carry.states, carry.valid & (has_groups & ~same),
        torch.zeros((), dtype=torch.bool, device=ng.device))
    last = torch.clamp(ng - 1, min=0)
    cap = partial.valid.shape[0]
    emit_valid = partial.valid \
        & (torch.arange(cap, device=ng.device) < last)
    emit = GroupByState(partial.keys, new_states, emit_valid,
                        partial.overflow | carry.overflow)
    at = torch.clamp(last, max=cap - 1).reshape(1)

    def keep1(new, old):
        return torch.where(has_groups, new.index_select(0, at), old)
    carry_out = GroupByState(
        [(keep1(d, od), keep1(m, om))
         for (d, m), (od, om) in zip(partial.keys, carry.keys)],
        [tuple(keep1(a, oa) for a, oa in zip(st, ost))
         for st, ost in zip(new_states, carry.states)],
        keep1(partial.valid, carry.valid),
        torch.zeros((), dtype=torch.bool, device=ng.device))
    return carry_emit, emit, carry_out, last


#: launches of the CUDA stream-reduce kernel (csrc/stream_reduce.cu)
STREAM_REDUCE_KERNEL = _tk.LaunchCounter("stream_reduce", "agg_stream")


def _stream_reduce_cuda(row_valid, key_cols, contribs, aggs, out_cap,
                        carry: Optional[GroupByState]):
    """K8 over any number of state components: whole aggregates in
    runs that fit one launch (agg_chunks); every launch finds the same
    groups, first rows, carry keys and counts, so only the states are
    gathered from each."""
    runs = agg_chunks(aggs)
    if len(runs) == 1:
        return _stream_reduce_launch(row_valid, key_cols, contribs, aggs,
                                     out_cap, carry)
    parts = [_stream_reduce_launch(
        row_valid, key_cols, contribs[lo:hi], aggs[lo:hi], out_cap,
        None if carry is None
        else dataclasses.replace(carry, states=carry.states[lo:hi]))
        for lo, hi in runs]
    if carry is None:
        return dataclasses.replace(
            parts[0], states=[st for p in parts for st in p.states])
    carry_emit, emit, carry_out, count = parts[0]
    return (dataclasses.replace(carry_emit, states=carry.states),
            dataclasses.replace(emit, states=[
                st for p in parts for st in p[1].states]),
            dataclasses.replace(carry_out, states=[
                st for p in parts for st in p[2].states]), count)


def _stream_reduce_launch(row_valid, key_cols, contribs, aggs, out_cap,
                          carry: Optional[GroupByState]):
    from presto_tpu_torch.native import cuda
    dev = row_valid.device
    n = row_valid.shape[0]
    common.check_rows(row_valid, n, dev, (torch.bool,),
                      "stream_reduce: row_valid")
    key_cols = [(d.contiguous(), m.contiguous()) for d, m in key_cols]
    kd, km, kt, nk = common.key_group_args(key_cols, n, dev,
                                           "stream_reduce")
    comps = [(arr.contiguous(), r) for st, agg in zip(contribs, aggs)
             for arr, r in zip(st, agg.reduces)]
    if len(comps) > KERNEL_MAX_COMPS or out_cap < 1:
        raise ValueError(f"stream_reduce: at most {KERNEL_MAX_COMPS} "
                         "components per launch and at least one output "
                         "slot")
    for c, r in comps:
        common.check_rows(c, n, dev, tuple(_KERNEL_DTYPES),
                          "stream_reduce: contribution")
        if r not in _KERNEL_OPS:
            raise ValueError(f"stream_reduce: reduce {r!r}")
    lib = cuda.library("stream_reduce")
    tile = lib.presto_stream_tile()
    outs = [torch.empty(out_cap, dtype=c.dtype, device=dev)
            for c, _ in comps]
    first_row = torch.empty(out_cap, dtype=torch.int64, device=dev)
    slot_valid = torch.empty(out_cap, dtype=torch.bool, device=dev)
    stats = torch.empty(4, dtype=torch.int64, device=dev)
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    tiles = torch.empty(3 * ((n + tile - 1) // tile), dtype=torch.int64,
                        device=dev)
    starts = torch.empty(out_cap + 1, dtype=torch.int64, device=dev)
    C = max(len(comps), 1)
    P = ctypes.c_int64 * C
    K = ctypes.c_int64 * (common.MAX_KEYS * common.MAX_KEY_GROUPS)
    if carry is not None:
        ckeys = [(d.contiguous(), m.contiguous()) for d, m in carry.keys]
        ccomps = [a.contiguous() for st in carry.states for a in st]
        for (d, m), (kcol, _) in zip(ckeys, key_cols):
            common.check_rows(d, 1, dev, (kcol.dtype,),
                              "stream_reduce: carry key")
            common.check_rows(m, 1, dev, (torch.bool,),
                              "stream_reduce: carry key mask")
        for a, (c, _) in zip(ccomps, comps):
            common.check_rows(a, 1, dev, (c.dtype,),
                              "stream_reduce: carry state")
        common.check_rows(carry.valid, 1, dev, (torch.bool,),
                          "stream_reduce: carry valid")
        okeys = [(torch.empty(1, dtype=d.dtype, device=dev),
                  torch.empty(1, dtype=torch.bool, device=dev))
                 for d, _ in ckeys]
        ocomps = [torch.empty(1, dtype=a.dtype, device=dev)
                  for a in ccomps]
        ovalid = torch.empty(1, dtype=torch.bool, device=dev)
        emit_carry = torch.empty(1, dtype=torch.bool, device=dev)
        carry_args = (
            ctypes.c_int32(1), K(*[d.data_ptr() for d, _ in ckeys]),
            K(*[m.data_ptr() for _, m in ckeys]),
            ctypes.c_void_p(carry.valid.data_ptr()),
            P(*[a.data_ptr() for a in ccomps]),
            K(*[d.data_ptr() for d, _ in okeys]),
            K(*[m.data_ptr() for _, m in okeys]),
            P(*[a.data_ptr() for a in ocomps]),
            ctypes.c_void_p(ovalid.data_ptr()),
            ctypes.c_void_p(emit_carry.data_ptr()))
    else:
        carry_args = (ctypes.c_int32(0), None, None, None, None, None,
                      None, None, None, None)
    status = lib.presto_stream_reduce(
        kd, km, kt, nk, ctypes.c_void_p(row_valid.data_ptr()),
        ctypes.c_int64(n), P(*[c.data_ptr() for c, _ in comps]),
        P(*[o.data_ptr() for o in outs]),
        (ctypes.c_int32 * C)(*[_KERNEL_DTYPES[c.dtype] for c, _ in comps]),
        (ctypes.c_int32 * C)(*[_KERNEL_OPS[r] for _, r in comps]),
        ctypes.c_int32(len(comps)), ctypes.c_int64(out_cap), *carry_args,
        ctypes.c_void_p(first_row.data_ptr()),
        ctypes.c_void_p(slot_valid.data_ptr()),
        ctypes.c_void_p(stats.data_ptr()),
        ctypes.c_void_p(flags.data_ptr()),
        ctypes.c_void_p(tiles.data_ptr()),
        ctypes.c_void_p(starts.data_ptr()),
        ctypes.c_void_p(cuda.stream_ptr(dev)))
    cuda.check(lib, status, "stream_reduce")
    STREAM_REDUCE_KERNEL.launches += 1
    it = iter(outs)
    states = [tuple(next(it) for _ in st) for st in contribs]
    keys = [(d[first_row], m[first_row] & slot_valid) for d, m in key_cols]
    overflow = stats[1] > 0
    if carry is None:
        return GroupByState(keys, states, slot_valid, overflow)
    it = iter(ocomps)
    carry_out = GroupByState(
        okeys, [tuple(next(it) for _ in st) for st in carry.states],
        ovalid, torch.zeros((), dtype=torch.bool, device=dev))
    carry_emit = GroupByState(carry.keys, carry.states, emit_carry,
                              torch.zeros((), dtype=torch.bool,
                                          device=dev))
    emit = GroupByState(keys, states, slot_valid, overflow | carry.overflow)
    return carry_emit, emit, carry_out, torch.clamp(stats[0] - 1, min=0)


def presorted_reduce(row_valid: torch.Tensor, key_cols: Sequence[CVal],
                     contribs: Sequence[Tuple[torch.Tensor, ...]],
                     aggs: Sequence[AggFunction],
                     out_cap: int) -> GroupByState:
    """K8 without a carry (see `presorted_reduce_plain`). The CUDA kernel
    on CUDA tensors, the plain version on CPU tensors."""
    if row_valid.device.type == "cpu" or not key_cols:
        return presorted_reduce_plain(row_valid, key_cols, contribs, aggs,
                                      out_cap)
    return _stream_reduce_cuda(row_valid, key_cols, contribs, aggs,
                               out_cap, None)


def stream_step(carry: GroupByState, row_valid: torch.Tensor,
                key_cols: Sequence[CVal],
                contribs: Sequence[Tuple[torch.Tensor, ...]],
                aggs: Sequence[AggFunction], out_cap: int):
    """K8 with the carry: one streaming-aggregation round (the
    reference's `presorted_reduce` then `_stream_step_jit`), in one
    kernel call on CUDA. Returns (carry_emit, emit, carry_out, emitted
    groups), see `stream_fold_plain`."""
    _tk.count("agg_stream")
    if row_valid.device.type == "cpu":
        return stream_fold_plain(
            carry, presorted_reduce_plain(row_valid, key_cols, contribs,
                                          aggs, out_cap), aggs)
    return _stream_reduce_cuda(row_valid, key_cols, contribs, aggs,
                               out_cap, carry)


def finalize(state: GroupByState, key_names: Sequence[str],
             key_types: Sequence[Type],
             key_dicts: Sequence[Optional[tuple]],
             out_names: Sequence[str],
             aggs: Sequence[AggFunction]) -> Batch:
    """The output batch: one group per row."""
    cols: Dict[str, Column] = {}
    for name, typ, dic, (d, m) in zip(key_names, key_types, key_dicts,
                                      state.keys):
        cols[name] = Column(d.to(typ.torch_dtype), m, typ, dic)
    for name, agg, st in zip(out_names, aggs, state.states):
        d, m = agg.final(st)
        cols[name] = Column(d.to(agg.output_type.torch_dtype),
                            m & state.valid, agg.output_type, None)
    return Batch(cols, state.valid)


def intermediate_batch(state: GroupByState, key_names: Sequence[str],
                       key_types: Sequence[Type],
                       key_dicts: Sequence[Optional[tuple]],
                       out_names: Sequence[str],
                       aggs: Sequence[AggFunction]) -> Batch:
    """Partial states as columns (<out>__s0, <out>__s1, ...), the shape
    of the partial/final shuffle of the distributed slice."""
    cols: Dict[str, Column] = {}
    for name, typ, dic, (d, m) in zip(key_names, key_types, key_dicts,
                                      state.keys):
        cols[name] = Column(d.to(typ.torch_dtype), m, typ, dic)
    for name, agg, st in zip(out_names, aggs, state.states):
        for i, (arr, it) in enumerate(zip(st, agg.intermediate_types)):
            cols[f"{name}__s{i}"] = Column(arr.to(it.torch_dtype),
                                           state.valid, it, None)
    return Batch(cols, state.valid)
