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
(the final ORDER BY or merge regroups by key). A merge of partial
states (`merge_partials`) reads them where they lie: K3 and K26 take
up to eight states as sources. A state carries its live group count
(`GroupByState.live`, K6's), which agg_count reads.

Vector state components (approx_percentile's bucket histogram,
approx_distinct's HyperLogLog registers) hold K values per group. A row
contributes one (index, value) pair (`Sparse`), the reference's one-hot
row; K30 (csrc/vector_reduce.cu, ops/agg_kernels.py) folds the pairs
into the slot table or the groups, and a merge's K-wide rows. Every
drain (`direct_finalize`, `direct_intermediate`, `finalize`,
`intermediate_batch`) is one K29 launch (csrc/agg_finalize.cu) on the
card; the `*_plain` drains are its plain versions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column, bucket_capacity, pad_batch
from presto_tpu_torch.ops import agg_kernels as ak
from presto_tpu_torch.ops import common
from presto_tpu_torch.telemetry import kernels as _tk
from presto_tpu_torch.types import BIGINT, BOOLEAN, DOUBLE, Type

CVal = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AggFunction:
    """One aggregate: state layout + per-row contribution + final.

    `init(value, weight)` maps a row's input to state contributions,
    one per state component, each reduced into the slot table with its
    entry of `reduces` (sum/min/max). A VECTOR component is declared as
    (np.dtype, K) in `state_dtypes`: its state is [groups, K] and its
    contribution a `Sparse` pair per row (the reference's [rows, K]
    one-hot row, presto_tpu/ops/hashagg.py:54-60, never materialised).
    `fin` names the final function for K29 (csrc/agg_finalize.cu); the
    `final` callable is its plain version."""

    name: str
    state_dtypes: Tuple  # np.dtype | (np.dtype, K) per component
    reduces: Tuple[str, ...]
    init: Callable[[Optional[torch.Tensor], torch.Tensor],
                   Tuple[torch.Tensor, ...]]
    final: Callable[[Tuple[torch.Tensor, ...]], CVal]
    output_type: Type = BIGINT
    intermediate_types: Tuple[Type, ...] = ()
    fin: Tuple = ()


class Sparse:
    """A vector component's contribution: row r stands for the dense
    row holding value[r] at index[r] and 0 everywhere else (the
    reference's one-hot row). Folded into a group, a dense row of
    zeros still counts: under "max" every register of a group that
    received any row is at least 0."""

    def __init__(self, index: torch.Tensor, value: torch.Tensor):
        self.index = index
        self.value = value

    def to(self, dtype: torch.dtype) -> "Sparse":
        return Sparse(self.index, self.value.to(dtype))

    def contiguous(self) -> "Sparse":
        return Sparse(self.index.contiguous(), self.value.contiguous())


def comp_spec(comp) -> Tuple[np.dtype, Optional[int]]:
    """A `state_dtypes` entry as (dtype, K for a vector component or
    None)."""
    if isinstance(comp, tuple):
        return np.dtype(comp[0]), int(comp[1])
    return np.dtype(comp), None


def has_vector_state(aggs: Sequence["AggFunction"]) -> bool:
    return any(comp_spec(c)[1] is not None
               for a in aggs for c in a.state_dtypes)


def _torch_dtype(comp) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, comp_spec(comp)[0])).dtype


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
                       (output_type, BIGINT), ("value",))


@functools.lru_cache(maxsize=None)
def make_count(input_type: Optional[Type]) -> AggFunction:
    def init(value, w):
        return (w.to(torch.int64),)

    def final(state):
        return state[0], torch.ones_like(state[0], dtype=torch.bool)
    return AggFunction("count", (np.dtype(np.int64),), ("sum",),
                       init, final, BIGINT, (BIGINT,), ("count",))


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
                       (DOUBLE, BIGINT), ("avg",))


def _make_minmax(input_type: Type, reduce: str) -> AggFunction:
    dt = input_type.torch_dtype
    ident = _ident_for(reduce, dt)

    def init(value, w):
        return (_where0(w, value.to(dt), ident, dt), w.to(torch.int64))

    def final(state):
        return state[0], state[1] > 0
    return AggFunction(reduce, (input_type.np_dtype, np.dtype(np.int64)),
                       (reduce, "sum"), init, final, input_type,
                       (input_type, BIGINT), ("value",))


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
                       (BIGINT, DOUBLE, DOUBLE), ("var", pop, sqrt))


@functools.lru_cache(maxsize=None)
def make_count_if() -> AggFunction:
    def init(value, w):
        return ((w & value.to(torch.bool)).to(torch.int64),)

    def final(state):
        return state[0], torch.ones_like(state[0], dtype=torch.bool)
    return AggFunction("count_if", (np.dtype(np.int64),), ("sum",),
                       init, final, BIGINT, (BIGINT,), ("count",))


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
                       init, final, BOOLEAN, (BOOLEAN, BIGINT),
                       ("bool",))


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
                       (DOUBLE, BIGINT), ("geomean",))


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
        (BIGINT,) + (DOUBLE,) * 4, (kind,))


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
                       (DOUBLE, DOUBLE), ("entropy", float(np.log(2.0))))


@functools.lru_cache(maxsize=None)
def make_checksum(input_type: Type) -> AggFunction:
    """Order-independent content hash (the reference's make_checksum):
    a wrapping int64 sum of `hash64` over the non-NULL values."""
    def init(value, w):
        h = common.hash64(value, w)
        return (torch.where(w, h, torch.zeros_like(h)),)

    def final(state):
        return state[0], torch.ones_like(state[0], dtype=torch.bool)
    return AggFunction("checksum", (np.dtype(np.int64),), ("sum",),
                       init, final, BIGINT, (BIGINT,), ("count",))


#: approx_percentile's sketch (the reference's, presto_tpu/ops/
#: hashagg.py:257-296): log-spaced buckets of ratio GAMMA; [0, HALF-2]
#: negatives (most negative first), HALF-1 zero, [HALF, K-1] positives.
PCTL_BUCKETS = 1024
_PCTL_GAMMA = 1.06
_PCTL_HALF = PCTL_BUCKETS // 2
_PCTL_EXP0 = _PCTL_HALF // 2


def _pctl_bucket(value: torch.Tensor) -> torch.Tensor:
    """Bucket of each value (int32). A float's conversion to int32
    saturates, NaN going to 0, as XLA's does."""
    lng = float(np.log(_PCTL_GAMMA))
    mag = torch.abs(value.to(torch.float64))
    tiny = mag < 1e-12
    r = torch.round(torch.log(torch.clamp(mag, min=1e-12)) / lng)
    r = torch.clamp(torch.nan_to_num(r, nan=0.0), -2.0 ** 31,
                    2.0 ** 31 - 1)
    li = torch.clamp(r.to(torch.int32) + _PCTL_EXP0, 0, _PCTL_HALF - 2)
    b = torch.where(value >= 0, _PCTL_HALF + li, _PCTL_HALF - 2 - li)
    return torch.where(tiny, torch.full_like(b, _PCTL_HALF - 1),
                       b).to(torch.int32)


def _pctl_values() -> np.ndarray:
    """Representative value per bucket (its geometric midpoint)."""
    li = np.arange(_PCTL_HALF - 1)
    mags = _PCTL_GAMMA ** (li.astype(np.float64) - _PCTL_EXP0)
    out = np.zeros(PCTL_BUCKETS)
    out[_PCTL_HALF:2 * _PCTL_HALF - 1] = mags
    out[_PCTL_HALF - 2::-1] = -mags
    return out


_PCTL_VALUES: Dict[torch.device, torch.Tensor] = {}


def pctl_values(device: torch.device) -> torch.Tensor:
    """`_pctl_values()` as a float64 tensor on `device` (made once)."""
    t = _PCTL_VALUES.get(device)
    if t is None:
        t = _PCTL_VALUES[device] = torch.from_numpy(
            _pctl_values()).to(device)
    return t


@functools.lru_cache(maxsize=None)
def make_approx_percentile(fraction: float) -> AggFunction:
    """Mergeable log-histogram percentile sketch: an int32 count vector
    of PCTL_BUCKETS per group; a row adds 1 to its value's bucket."""
    K = PCTL_BUCKETS

    def init(value, w):
        return (Sparse(_pctl_bucket(value), w.to(torch.int32)),)

    def final(state):
        counts = state[0].to(torch.float64)
        total = counts.sum(dim=1)
        cdf = torch.cumsum(counts, dim=1)
        target = torch.clamp(torch.ceil(fraction * total), min=1.0)
        idx = torch.argmax((cdf >= target[:, None]).to(torch.uint8),
                           dim=1)
        return pctl_values(counts.device)[idx], total > 0
    return AggFunction(f"approx_percentile[{fraction}]",
                       ((np.int32, K),), ("sum",), init, final, DOUBLE,
                       (), ("pctl", float(fraction)))


#: approx_distinct's error bounds (the reference's): the default, the
#: accepted range, and the tightest error the 2^14-register cap honours
HLL_DEFAULT_ERROR = 0.023
HLL_MIN_ERROR, HLL_MAX_ERROR = 0.0040625, 0.26
HLL_HONORED_MIN_ERROR = 1.04 / (1 << 7)


def hll_registers_for_error(e: float) -> int:
    """Register count m (a power of two) with 1.04/sqrt(m) <= e, capped
    at 2^14 (the reference's rule)."""
    m = 16
    while 1.04 / np.sqrt(m) > e and m < (1 << 14):
        m *= 2
    return m


#: alpha_m bias constant per b = log2(m) (Flajolet et al. 2007)
_HLL_ALPHA = {
    4: 0.673, 5: 0.697, 6: 0.709,
    **{bb: 0.7213 / (1 + 1.079 / (1 << bb)) for bb in range(7, 17)},
}


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bit length of each non-negative int64 (0 for 0), by halving."""
    n = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        t = x >> s
        big = t != 0
        n = n + torch.where(big, s, 0)
        x = torch.where(big, t, x)
    return n + (x != 0).to(torch.int64)


@functools.lru_cache(maxsize=None)
def make_approx_distinct(input_type: Type,
                         max_error: float = HLL_DEFAULT_ERROR
                         ) -> AggFunction:
    """Dense HyperLogLog (the reference's make_approx_distinct): m int8
    registers per group, merged by max. A row's hash picks register
    `h & (m - 1)` by its low bits and offers the leading-zero count of
    the rest plus one."""
    m = hll_registers_for_error(max_error)
    b = int(np.log2(m))

    def init(value, w):
        h = common.hash64(value, w)
        reg = (h & (m - 1)).to(torch.int32)
        # clz(h >>> b) - (b - 1), with clz(x) = 64 - bit length
        rho = (65 - b) - _bit_length(common._lshr(h, b))
        return (Sparse(reg, torch.where(w, rho, 0).to(torch.int8)),)

    def final(state):
        regs = torch.clamp(state[0], min=0).to(torch.float64)
        est = _HLL_ALPHA[b] * m * m / torch.sum(torch.exp2(-regs), dim=1)
        zeros = torch.sum(state[0] <= 0, dim=1).to(torch.float64)
        small = m * torch.log(m / torch.clamp(zeros, min=1.0))
        est = torch.where((est <= 2.5 * m) & (zeros > 0), small, est)
        return torch.round(est).to(torch.int64), \
            torch.ones(est.shape[0], dtype=torch.bool, device=est.device)
    return AggFunction(f"approx_distinct[{m}]", ((np.int8, m),),
                       ("max",), init, final, BIGINT, (),
                       ("hll", m, _HLL_ALPHA[b] * m * m))

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
    states = [tuple(_full_state(num_slots, dt, r, device)
                    for dt, r in zip(a.state_dtypes, a.reduces))
              for a in aggs]
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
    comps, vectors = [], []
    for agg, st, cb in zip(aggs, state.states, contribs):
        for arr, c, r in zip(st, cb, agg.reduces):
            if not isinstance(c, Sparse):
                comps.append((c.to(arr.dtype).contiguous(), arr, r))
            elif arr.dim() == 2:
                vectors.append((c.to(arr.dtype).contiguous(), arr, r))
            else:
                raise ValueError(f"{agg.name}: a sparse contribution to a "
                                 "scalar state component")
    row_valid = row_valid.contiguous()
    direct_slot_reduce(row_valid, keys, domains, comps, state.present)
    if vectors:
        # K30 (K1's vector mode) over the same slots
        vkeys, vdoms = fold_key_codes(keys, domains)
        for c, arr, r in vectors:
            ak.vector_direct(row_valid, vkeys, vdoms, c.index, c.value, arr,
                             r, slot_ids)
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


def direct_finalize_plain(state: DirectState, key_names: Sequence[str],
                          key_types: Sequence[Type],
                          key_dicts: Sequence[Optional[tuple]],
                          domains: Tuple[int, ...],
                          out_names: Sequence[str],
                          aggs: Sequence[AggFunction]) -> Batch:
    """Plain version of K29 on the direct path: one output row per
    present slot, padded up to the slot table's capacity bucket."""
    cols, rv = _decode_slots(state, key_names, key_types, key_dicts,
                             domains)
    for name, agg, st in zip(out_names, aggs, state.states):
        d, m = agg.final(st)
        cols[name] = Column(d.to(agg.output_type.torch_dtype), m & rv,
                            agg.output_type, None)
    out = Batch(cols, rv)
    return pad_batch(out, bucket_capacity(out.capacity) - out.capacity)


def direct_intermediate_plain(state: DirectState,
                              key_names: Sequence[str],
                              key_types: Sequence[Type],
                              key_dicts: Sequence[Optional[tuple]],
                              domains: Tuple[int, ...],
                              out_names: Sequence[str],
                              aggs: Sequence[AggFunction]) -> Batch:
    """Plain version of K29 for the PARTIAL step on the direct path:
    keys decoded as in direct_finalize, every state array as a column
    <out>__s{i} (reference: presto_tpu/ops/hashagg.py:1021)."""
    cols, rv = _decode_slots(state, key_names, key_types, key_dicts,
                             domains)
    for name, agg, st in zip(out_names, aggs, state.states):
        for i, (arr, it) in enumerate(zip(st, agg.intermediate_types)):
            cols[f"{name}__s{i}"] = Column(arr.to(it.torch_dtype), rv,
                                           it, None)
    out = Batch(cols, rv)
    return pad_batch(out, bucket_capacity(out.capacity) - out.capacity)


def _fin_agg_column(agg: AggFunction, st, cap: int,
                    dev: torch.device) -> Tuple[Column, ak.FinColumn]:
    """The output column of one aggregate and its K29 descriptor: the
    op of `agg.fin` (csrc/agg_finalize.cu) over the state `st`."""
    typ = agg.output_type
    data = torch.empty(cap, dtype=typ.torch_dtype, device=dev)
    mask = torch.empty(cap, dtype=torch.bool, device=dev)
    kind = agg.fin[0] if agg.fin else None
    st = [a.contiguous() for a in st]
    if kind == "value":  # sum, min, max: the value, NULL on no input
        fc = ak.FinColumn("convert", data, mask, ak.MASK_CNT_GT, st[:1],
                          aux=st[1], thr=0)
    elif kind == "count":
        fc = ak.FinColumn("convert", data, mask, ak.MASK_RV, st[:1])
    elif kind in ("avg", "geomean"):
        fc = ak.FinColumn(kind, data, mask, ak.MASK_CNT_GT, st,
                          aux=st[1], thr=0)
    elif kind == "bool":
        fc = ak.FinColumn("bool", data, mask, ak.MASK_CNT_GT, st,
                          aux=st[1], thr=0)
    elif kind == "var":
        _, pop, sqrt = agg.fin
        fc = ak.FinColumn("var", data, mask, ak.MASK_CNT_GT, st,
                          ia=int(pop), ib=int(sqrt), aux=st[0],
                          thr=0 if pop else 1)
    elif kind in ("skewness", "kurtosis"):
        fc = ak.FinColumn(kind, data, mask, ak.MASK_CNT_GT, st, aux=st[0],
                          thr=2 if kind == "skewness" else 3)
    elif kind == "entropy":
        fc = ak.FinColumn("entropy", data, mask, ak.MASK_F64_POS, st,
                          f=agg.fin[1], aux=st[0])
    elif kind == "pctl":
        fc = ak.FinColumn("pctl", data, mask, ak.MASK_OP, st,
                          ia=st[0].shape[1], f=agg.fin[1],
                          aux=pctl_values(dev))
    elif kind == "hll":
        fc = ak.FinColumn("hll", data, mask, ak.MASK_RV, st,
                          ia=agg.fin[1], f=agg.fin[2])
    else:
        raise ValueError(f"agg_finalize: no K29 final for {agg.name}")
    return Column(data, mask, typ, None), fc


def _fin_convert(arr: torch.Tensor, typ: Type, cap: int,
                 mask_kind: int, mask: Optional[torch.Tensor] = None
                 ) -> Tuple[Column, ak.FinColumn]:
    """An array converted to `typ` as a K29 column (its mask the row's
    liveness, or a key's own mask with MASK_PTR)."""
    dev = arr.device
    data = torch.empty(cap, dtype=typ.torch_dtype, device=dev)
    om = torch.empty(cap, dtype=torch.bool, device=dev)
    return Column(data, om, typ, None), ak.FinColumn(
        "convert", data, om, mask_kind, [arr.contiguous()],
        aux=None if mask is None else mask.contiguous())


def _direct_k29(state: DirectState, key_names, key_types, key_dicts,
                domains, out_names, aggs, partial: bool) -> Batch:
    """K29 on the direct path: the decoded keys, every aggregate (or,
    for the PARTIAL step, every state array) and row_valid, written
    padded to the slot table's capacity bucket in one launch."""
    slots = state.present.shape[0]
    cap = bucket_capacity(slots)
    dev = state.present.device
    rv_src = state.present if key_names else None
    cols: Dict[str, Column] = {}
    fin: List[ak.FinColumn] = []
    stride = slots
    for name, typ, dic, dom in zip(key_names, key_types, key_dicts,
                                   domains):
        stride //= (dom + 1)
        data = torch.empty(cap, dtype=typ.torch_dtype, device=dev)
        mask = torch.empty(cap, dtype=torch.bool, device=dev)
        cols[name] = Column(data, mask, typ, dic)
        fin.append(ak.FinColumn("key", data, mask, ak.MASK_OP, ia=dom,
                                ib=stride))
    for name, agg, st in zip(out_names, aggs, state.states):
        if partial:
            for i, (arr, it) in enumerate(zip(st, agg.intermediate_types)):
                cols[f"{name}__s{i}"], fc = _fin_convert(arr, it, cap,
                                                         ak.MASK_RV)
                fin.append(fc)
        else:
            cols[name], fc = _fin_agg_column(agg, st, cap, dev)
            fin.append(fc)
    rv = torch.empty(cap, dtype=torch.bool, device=dev)
    fin.append(ak.FinColumn("rv", rv, None, ak.MASK_NONE))
    ak.finalize_columns(fin, slots, cap, rv_src)
    return Batch(cols, rv)


def direct_finalize(state: DirectState, key_names: Sequence[str],
                    key_types: Sequence[Type],
                    key_dicts: Sequence[Optional[tuple]],
                    domains: Tuple[int, ...],
                    out_names: Sequence[str],
                    aggs: Sequence[AggFunction]) -> Batch:
    """One output row per present slot, padded to the capacity bucket:
    K29 on CUDA tensors, `direct_finalize_plain` on CPU tensors."""
    if state.present.device.type == "cpu":
        return direct_finalize_plain(state, key_names, key_types,
                                     key_dicts, domains, out_names, aggs)
    return _direct_k29(state, key_names, key_types, key_dicts, domains,
                       out_names, aggs, partial=False)


def direct_intermediate(state: DirectState, key_names: Sequence[str],
                        key_types: Sequence[Type],
                        key_dicts: Sequence[Optional[tuple]],
                        domains: Tuple[int, ...],
                        out_names: Sequence[str],
                        aggs: Sequence[AggFunction]) -> Batch:
    """The PARTIAL step's output on the direct path: K29 on CUDA
    tensors, `direct_intermediate_plain` on CPU tensors."""
    if state.present.device.type == "cpu":
        return direct_intermediate_plain(state, key_names, key_types,
                                         key_dicts, domains, out_names,
                                         aggs)
    return _direct_k29(state, key_names, key_types, key_dicts, domains,
                       out_names, aggs, partial=True)


# -- the sort-based path -----------------------------------------------


@dataclasses.dataclass
class GroupByState:
    """Running accumulator of the sort path: key columns + per-agg
    state arrays, packed: `valid[g]` is True for the first live groups
    and False after them. `live` is that count (a 0-d int64 tensor, the
    count K6 computes; `agg_count` reads it with no reduction of its
    own), or None for a state made elsewhere (a stream carry)."""
    keys: List[CVal]
    states: List[Tuple[torch.Tensor, ...]]
    valid: torch.Tensor
    overflow: torch.Tensor  # bool scalar
    live: Optional[torch.Tensor] = None


def _full_state(n: int, comp, reduce: str,
                device: torch.device) -> torch.Tensor:
    """n rows of a component's identity ([n, K] for a vector one)."""
    dt = _torch_dtype(comp)
    k = comp_spec(comp)[1]
    return torch.full((n,) if k is None else (n, k), _ident_for(reduce, dt),
                      dtype=dt, device=device)


def _gate(w: torch.Tensor, contrib: torch.Tensor, ident) -> torch.Tensor:
    """where(w, contrib, ident), broadcast over a vector component."""
    if contrib.dim() == 2:
        w = w[:, None]
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
                        torch.zeros((), dtype=torch.bool, device=device),
                        torch.zeros((), dtype=torch.int64, device=device))


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
                         out_cap: int, seg_out: Optional[list] = None):
    """Plain version of K6, over rows sorted by (h1, h2): every
    (contribution, op) reduced into out_cap packed group slots, each
    group's first row, the group count and the overflow flag.
    Returns (reduced, first_row, groups, overflow); with `seg_out`, also
    appends the groups' `Segments` (each row's group id) to it."""
    bnd, gid, groups = segment_ids(h1, h2, keys, valid, out_cap)
    reduced = [_sorted_reduce(c, gid, out_cap, r) for c, r in comps]
    if seg_out is not None:
        seg_out.append(_segments_plain(bnd, valid, groups, out_cap))
    return (reduced, _first_rows(bnd, gid, out_cap), groups,
            groups > out_cap)


def _segments_plain(bnd: torch.Tensor, valid: torch.Tensor,
                    groups: torch.Tensor, out_cap: int) -> ak.Segments:
    """K6's segments from the group boundaries: each group's first row
    (groups past out_cap + 1 dropped) and the stats {groups, overflow,
    end of the last live row, live}."""
    n = bnd.shape[0]
    pos = torch.arange(n, device=bnd.device)
    g = torch.cumsum(bnd.to(torch.int64), 0) - 1
    at = torch.where(bnd & (g <= out_cap), g,
                     torch.full_like(g, out_cap + 1))
    starts = torch.zeros(out_cap + 2, dtype=torch.int64, device=bnd.device)
    starts.scatter_(0, at, pos)
    live_end = torch.where(valid, pos + 1, torch.zeros_like(pos)).max()
    stats = torch.stack([groups, (groups > out_cap).to(torch.int64),
                         live_end, torch.clamp(groups, max=out_cap)])
    return ak.Segments(starts[:out_cap + 1], stats)


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


def _segment_reduce_cuda(h1, h2, keys, valid, comps, out_cap,
                         seg_out: Optional[list] = None):
    """K6 over any number of components (comp_chunks) and key columns
    (the first MAX_KEYS compared in the kernel, the rest folded into a
    per-row change flag first): every launch finds the same groups,
    first rows and count (and, into `seg_out`, the same segments)."""
    reduced = []
    for lo, hi in comp_chunks(len(comps)):
        outs, first_row, groups, overflow = _segment_reduce_launch(
            h1, h2, keys, valid, comps[lo:hi], out_cap,
            **({} if seg_out is None or hi < len(comps)
               else {"seg_out": seg_out}))
        reduced.extend(outs)
    return reduced, first_row, groups, overflow


def _segment_reduce_launch(h1, h2, keys, valid, comps, out_cap,
                           seg_out: Optional[list] = None):
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
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
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
    if seg_out is not None:
        seg_out.append(ak.Segments(starts, stats))
    return outs, first_row, stats[0], stats[1] > 0


def segment_reduce(h1: torch.Tensor, h2: torch.Tensor,
                   keys: Sequence[CVal], valid: torch.Tensor,
                   comps: Sequence[Tuple[torch.Tensor, str]],
                   out_cap: int, seg_out: Optional[list] = None):
    """K6 (see `segment_reduce_plain`). The CUDA kernel on CUDA
    tensors, the plain version on CPU tensors."""
    if valid.device.type == "cpu":
        return segment_reduce_plain(h1, h2, keys, valid, comps, out_cap,
                                    seg_out)
    return _segment_reduce_cuda(h1, h2, keys, valid, comps, out_cap,
                                seg_out)


def _group_reduce(keys: Sequence[CVal], valid: torch.Tensor,
                  contribs: Sequence[Tuple[torch.Tensor, ...]],
                  aggs: Sequence[AggFunction],
                  out_cap: int, plain: bool = False) -> GroupByState:
    """`_group_reduce_parts` over one source of rows."""
    return _group_reduce_parts([(keys, valid, contribs)], aggs, out_cap,
                               plain)


def _comp_kind(c) -> str:
    if isinstance(c, Sparse):
        return "sparse"
    return "dense" if c.dim() == 2 else "scalar"


def _group_reduce_parts(parts, aggs: Sequence[AggFunction], out_cap: int,
                        plain: bool = False) -> GroupByState:
    """The sort-based grouping core over the rows of up to MAX_SOURCES
    sources, each (keys, valid, contributions) (one batch, or a merge's
    partial states): K3 hashes them all, K25 sorts (h1, h2) stably, K26
    moves the keys, the 1-D contributions and the hashes from every
    source, K6 reduces the scalar components, K30 the vector ones (a
    batch's sparse pairs in group order; a merge's K-wide partial rows
    read through the permutation), and K26 again gathers each group's
    first row. Nothing is concatenated on the card. With `plain`, the
    plain versions on any device (the card's yardstick for the
    composition, which concatenates). Boundaries compare the actual keys
    as well, so a double hash collision between distinct keys can only
    split a group (the next merge level rejoins it), never merge two
    keys. Groups beyond out_cap are dropped and the overflow flag set
    (the caller's retry protocol). Group order is backend-dependent:
    callers must not rely on it."""
    keys0, valid0, contribs0 = parts[0]
    dev = valid0.device
    slots = torch.arange(out_cap, device=dev)
    vseg = ak.vector_segments_plain if plain else ak.vector_segments
    kinds = [[_comp_kind(c) for c in st] for st in contribs0]
    if not keys0:
        return _global_reduce(parts, aggs, out_cap, kinds, vseg)
    parts = [([(d.contiguous(), m.contiguous()) for d, m in keys],
              valid.contiguous(), contribs)
             for keys, valid, contribs in parts]
    hash_pair = common.row_hash_sources_plain if plain \
        else common.row_hash_sources
    lex_perm = common.lex_perm_plain if plain else common.lex_perm
    gather = common.gather_rows_plain if plain else common.gather_rows
    h1, h2 = hash_pair([(k, v) for k, v, _ in parts], False)
    perm = lex_perm([h1, h2])
    # per source: its keys, its 1-D contributions (a sparse pair as two
    # arrays) and its rows of the hashes, all moved by K26
    cols, lo = [], 0
    for keys, valid, contribs in parts:
        flat = []
        for st, ks in zip(contribs, kinds):
            for c, kind in zip(st, ks):
                if kind == "scalar":
                    flat.append(c)
                elif kind == "sparse":
                    flat += [c.index, c.value]
        hi = lo + valid.shape[0]
        cols.append((keys + [(a, None) for a in flat]
                     + [(h1[lo:hi], None), (h2[lo:hi], None)], valid))
        lo = hi
    moved, svalid = gather(cols, perm)
    nk = len(keys0)
    skeys = moved[:nk]
    it = iter(d for d, _ in moved[nk:-2])
    comps, sparse = [], []
    for st, ks, agg in zip(contribs0, kinds, aggs):
        for c, kind, r in zip(st, ks, agg.reduces):
            if kind == "scalar":
                comps.append((next(it), r))
            elif kind == "sparse":
                sparse.append((next(it), next(it)))
    seg_out: list = []
    reduced, first_row, groups, overflow = \
        (segment_reduce_plain if plain else segment_reduce)(
            moved[-2][0], moved[-1][0], skeys, svalid, comps, out_cap,
            seg_out)
    seg = seg_out[0]
    red, sp = iter(reduced), iter(sparse)
    states = []
    for ai, (st, ks, agg) in enumerate(zip(contribs0, kinds, aggs)):
        out = []
        for ci, (c, kind, r, comp) in enumerate(zip(
                st, ks, agg.reduces, agg.state_dtypes)):
            dt, K = _torch_dtype(comp), comp_spec(comp)[1]
            if kind == "scalar":
                out.append(next(red))
            elif kind == "sparse":
                out.append(vseg(seg, svalid, out_cap, K, dt, r,
                                sparse=next(sp)))
            else:
                out.append(vseg(seg, svalid, out_cap, K, dt, r,
                                dense=[p[2][ai][ci] for p in parts],
                                perm=perm))
        states.append(tuple(out))
    new_valid = slots < groups
    new_keys, _ = gather([(skeys, None)], first_row, limit=groups)
    return GroupByState(new_keys, states, new_valid, overflow, seg.live)


def _global_reduce(parts, aggs, out_cap: int, kinds, vseg) -> GroupByState:
    """A global aggregation: one group, a straight reduction of every
    component over all rows of every source (rows that contribute
    nothing already hold the identity, or a zero sparse value)."""
    dev = parts[0][1].device
    states = []
    for ai, (ks, agg) in enumerate(zip(kinds, aggs)):
        red = []
        for ci, (kind, r, comp) in enumerate(zip(ks, agg.reduces,
                                                 agg.state_dtypes)):
            arrs = [p[2][ai][ci] for p in parts]
            dt, K = _torch_dtype(comp), comp_spec(comp)[1]
            if kind == "sparse":
                c = arrs[0]
                red.append(vseg(None, None, out_cap, K, dt, r,
                                sparse=(c.index, c.value)))
                continue
            if kind == "dense":
                red.append(vseg(None, None, out_cap, K, dt, r, dense=arrs))
                continue
            v = None
            for a in arrs:
                x = a.sum() if r == "sum" else (
                    a.min() if r == "min" else a.max())
                v = x if v is None else (
                    v + x if r == "sum" else
                    torch.minimum(v, x) if r == "min" else
                    torch.maximum(v, x))
            full = _full_state(out_cap, comp, r, dev)
            full[0] = v.to(full.dtype)
            red.append(full)
        states.append(tuple(red))
    slots = torch.arange(out_cap, device=dev)
    return GroupByState([], states, slots == 0,
                        torch.zeros((), dtype=torch.bool, device=dev),
                        torch.ones((), dtype=torch.int64, device=dev))


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
    if has_vector_state(aggs):
        raise ValueError("agg_step folds scalar states; vector states go "
                         "through batch_aggregate and merge_partials")
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
                        state.overflow | out.overflow, out.live)


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
                   out_cap: int, plain: bool = False) -> GroupByState:
    """Regroup up to MAX_SOURCES packed partial states into one of
    `out_cap` slots (hashagg_merge), each read where it lies: K3 and K26
    take the states as sources, K30 reads their vector rows through the
    permutation; overflow flags OR through. With `plain`, the plain
    versions, which concatenate (the card's yardstick)."""
    if len(states) > common.MAX_SOURCES:
        raise ValueError(f"merge_partials: at most {common.MAX_SOURCES} "
                         f"states, got {len(states)}")
    out = _group_reduce_parts([(s.keys, s.valid, s.states) for s in states],
                              aggs, out_cap, plain)
    ovf = out.overflow
    for s in states:
        ovf = ovf | s.overflow
    return GroupByState(out.keys, out.states, out.valid, ovf, out.live)


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
    seg = _segments_plain(bnd, row_valid, num_groups, out_cap)

    def reduce(arr, r, comp):
        if not isinstance(arr, Sparse):
            return _sorted_reduce(arr, gid, out_cap, r)
        return ak.vector_segments_plain(
            seg, row_valid, out_cap, comp_spec(comp)[1], _torch_dtype(comp),
            r, sparse=(arr.index, arr.value))
    states = [tuple(reduce(arr, r, comp) for arr, r, comp in zip(
                  st, agg.reduces, agg.state_dtypes))
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
    """K8 over the scalar state components, K30 over the vector ones
    (approx_percentile's histogram, approx_distinct's registers) on
    K8's segments, the carried group's rows folded as K8 folds its
    scalars."""
    vec = [[isinstance(c, Sparse) for c in st] for st in contribs]
    if not any(v for vs in vec for v in vs):
        return _stream_scalar_cuda(row_valid, key_cols, contribs, aggs,
                                   out_cap, carry)

    def scalars(st, vs):
        return tuple(c for c, v in zip(st, vs) if not v)
    s_aggs = [dataclasses.replace(a, reduces=scalars(a.reduces, vs),
                                  state_dtypes=scalars(a.state_dtypes, vs))
              for a, vs in zip(aggs, vec)]
    s_carry = None if carry is None else dataclasses.replace(
        carry, states=[scalars(st, vs) for st, vs in zip(carry.states, vec)])
    seg_out: list = []
    got = _stream_scalar_cuda(row_valid, key_cols,
                              [scalars(st, vs) for st, vs in zip(contribs,
                                                                 vec)],
                              s_aggs, out_cap, s_carry, seg_out)
    seg, same = seg_out[0]
    states, new_carry = [], []
    for ai, (st, vs, agg) in enumerate(zip(contribs, vec, aggs)):
        it = iter((got if carry is None else got[1]).states[ai])
        cit = iter([] if carry is None else got[2].states[ai])
        out, cout = [], []
        for ci, (c, v, r, comp) in enumerate(zip(st, vs, agg.reduces,
                                                 agg.state_dtypes)):
            if not v:
                out.append(next(it))
                cout.append(next(cit, None))
                continue
            K, dt = comp_spec(comp)[1], _torch_dtype(comp)
            cy = None if carry is None else ak.Carry(
                carry.states[ai][ci].contiguous(), same,
                torch.empty((1, K), dtype=dt, device=row_valid.device))
            out.append(ak.vector_segments(
                seg, row_valid, out_cap, K, dt, r,
                sparse=(c.index.contiguous(), c.value.contiguous()),
                carry=cy))
            cout.append(None if cy is None else cy.out)
        states.append(tuple(out))
        new_carry.append(tuple(cout))
    if carry is None:
        return dataclasses.replace(got, states=states)
    carry_emit, emit, carry_out, count = got
    return (dataclasses.replace(carry_emit, states=carry.states),
            dataclasses.replace(emit, states=states),
            dataclasses.replace(carry_out, states=new_carry), count)


def _stream_scalar_cuda(row_valid, key_cols, contribs, aggs, out_cap,
                        carry: Optional[GroupByState],
                        seg_out: Optional[list] = None):
    """K8 over any number of scalar state components: whole aggregates
    in runs that fit one launch (agg_chunks); every launch finds the
    same groups, first rows, carry keys and counts, so only the states
    are gathered from each (and, into `seg_out`, the first launch's
    segments)."""
    runs = agg_chunks(aggs)
    seg_kw = {} if seg_out is None else {"seg_out": seg_out}
    if len(runs) == 1:
        return _stream_reduce_launch(row_valid, key_cols, contribs, aggs,
                                     out_cap, carry, **seg_kw)
    parts = [_stream_reduce_launch(
        row_valid, key_cols, contribs[lo:hi], aggs[lo:hi], out_cap,
        None if carry is None
        else dataclasses.replace(carry, states=carry.states[lo:hi]),
        **(seg_kw if lo == 0 else {}))
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
                          carry: Optional[GroupByState],
                          seg_out: Optional[list] = None):
    from presto_tpu_torch.native import cuda
    dev = row_valid.device
    n = row_valid.shape[0]
    common.check_rows(row_valid, n, dev, (torch.bool,),
                      "stream_reduce: row_valid")
    key_cols = [(d.contiguous(), m.contiguous()) for d, m in key_cols]
    kd, km, kt, nk, _desc = common.key_group_args(key_cols, n, dev,
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
    stats = torch.empty(5, dtype=torch.int64, device=dev)
    flags = torch.empty(n, dtype=torch.uint8, device=dev)
    tiles = torch.empty(3 * ((n + tile - 1) // tile), dtype=torch.int64,
                        device=dev)
    starts = torch.empty(out_cap + 1, dtype=torch.int64, device=dev)
    C = max(len(comps), 1)
    P = ctypes.c_int64 * C
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
        # the carry's keys and the new carry's, one row each, laid out
        # as the batch's keys are (past 24 keys with their descriptors)
        cd, cm, _, _, _cdesc = common.key_group_args(
            ckeys, 1, dev, "stream_reduce: carry keys")
        od, om, _, _, _odesc = common.key_group_args(
            okeys, 1, dev, "stream_reduce: new carry keys")
        carry_args = (
            ctypes.c_int32(1), cd, cm,
            ctypes.c_void_p(carry.valid.data_ptr()),
            P(*[a.data_ptr() for a in ccomps]), od, om,
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
    if seg_out is not None:
        # K6's layout in stats[:4]; stats[4] the carry's `same`
        seg_out.append((ak.Segments(starts, stats[:4]), stats[4:]))
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


def finalize_plain(state: GroupByState, key_names: Sequence[str],
                   key_types: Sequence[Type],
                   key_dicts: Sequence[Optional[tuple]],
                   out_names: Sequence[str],
                   aggs: Sequence[AggFunction]) -> Batch:
    """Plain version of K29 on the sort path: the output batch, one
    group per row."""
    cols: Dict[str, Column] = {}
    for name, typ, dic, (d, m) in zip(key_names, key_types, key_dicts,
                                      state.keys):
        cols[name] = Column(d.to(typ.torch_dtype), m, typ, dic)
    for name, agg, st in zip(out_names, aggs, state.states):
        d, m = agg.final(st)
        cols[name] = Column(d.to(agg.output_type.torch_dtype),
                            m & state.valid, agg.output_type, None)
    return Batch(cols, state.valid)


def intermediate_batch_plain(state: GroupByState,
                             key_names: Sequence[str],
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


def _sorted_k29(state: GroupByState, key_names, key_types, key_dicts,
                out_names, aggs, partial: bool) -> Batch:
    """K29 on the sort path: every column that needs work (an aggregate's
    final, a cast) in one launch over the state's rows; a key or state
    array already of its column's type is the column itself, as in the
    plain version, and a drain with nothing to compute launches
    nothing."""
    cap = state.valid.shape[0]
    dev = state.valid.device
    cols: Dict[str, Column] = {}
    fin: List[ak.FinColumn] = []
    for name, typ, dic, (d, m) in zip(key_names, key_types, key_dicts,
                                      state.keys):
        if d.dtype == typ.torch_dtype:
            cols[name] = Column(d, m, typ, dic)
        else:
            col, fc = _fin_convert(d, typ, cap, ak.MASK_PTR, m)
            cols[name] = Column(col.data, col.mask, typ, dic)
            fin.append(fc)
    for name, agg, st in zip(out_names, aggs, state.states):
        if not partial:
            cols[name], fc = _fin_agg_column(agg, st, cap, dev)
            fin.append(fc)
            continue
        for i, (arr, it) in enumerate(zip(st, agg.intermediate_types)):
            if arr.dtype == it.torch_dtype:
                cols[f"{name}__s{i}"] = Column(arr, state.valid, it, None)
            else:
                cols[f"{name}__s{i}"], fc = _fin_convert(arr, it, cap,
                                                         ak.MASK_RV)
                fin.append(fc)
    ak.finalize_columns(fin, cap, cap, state.valid.contiguous())
    return Batch(cols, state.valid)


def finalize(state: GroupByState, key_names: Sequence[str],
             key_types: Sequence[Type],
             key_dicts: Sequence[Optional[tuple]],
             out_names: Sequence[str],
             aggs: Sequence[AggFunction]) -> Batch:
    """The output batch, one group per row: K29 on CUDA tensors,
    `finalize_plain` on CPU tensors."""
    if state.valid.device.type == "cpu":
        return finalize_plain(state, key_names, key_types, key_dicts,
                              out_names, aggs)
    return _sorted_k29(state, key_names, key_types, key_dicts, out_names,
                       aggs, partial=False)


def intermediate_batch(state: GroupByState, key_names: Sequence[str],
                       key_types: Sequence[Type],
                       key_dicts: Sequence[Optional[tuple]],
                       out_names: Sequence[str],
                       aggs: Sequence[AggFunction]) -> Batch:
    """Partial states as columns: K29 for the columns that need a cast
    on CUDA tensors, `intermediate_batch_plain` on CPU tensors."""
    if state.valid.device.type == "cpu":
        return intermediate_batch_plain(state, key_names, key_types,
                                        key_dicts, out_names, aggs)
    return _sorted_k29(state, key_names, key_types, key_dicts, out_names,
                       aggs, partial=True)
