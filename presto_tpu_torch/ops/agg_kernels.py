"""The aggregation state's own kernels: K28 (csrc/state_shrink.cu), the
shrink of a packed partial (agg_shrink); K29 (csrc/agg_finalize.cu),
the drain of a state into its output columns (agg_finalize); K30
(csrc/vector_reduce.cu), the folds of vector state components
(approx_percentile's histogram, approx_distinct's registers) on the
direct path, the sort path and the merge.

Each wrapper runs its kernel on CUDA tensors and its plain version on
CPU tensors; the plain versions are the composed torch forms the port
ran before these kernels, and the card's yardstick for them.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.ops import common
from presto_tpu_torch.telemetry import kernels as _tk

#: launches of K28, K29 and K30
STATE_SHRINK_KERNEL = _tk.LaunchCounter("state_shrink", "agg_shrink")
AGG_FINALIZE_KERNEL = _tk.LaunchCounter("agg_finalize")
VECTOR_REDUCE_KERNEL = _tk.LaunchCounter("vector_reduce", "agg_step")

#: most arrays one K28 launch copies (csrc/state_shrink.cu MAX_ARRAYS)
SHRINK_MAX_ARRAYS = 96


# -- K28: the shrink ----------------------------------------------------


def shrink_arrays_plain(arrays: Sequence[torch.Tensor],
                        rows: int) -> List[torch.Tensor]:
    """Plain version of K28: a new tensor holding the first `rows` rows
    of each array (the reference's jitted `d[:cap]`)."""
    return [a[:rows].clone() for a in arrays]


def _shrink_cuda(arrays, rows):
    from presto_tpu_torch.native import cuda
    dev = arrays[0].device
    outs = []
    spec = []
    for a in arrays:
        if a.device != dev or not a.is_contiguous() or a.shape[0] < rows:
            raise ValueError(f"state_shrink: arrays must be contiguous on "
                             f"{dev} with at least {rows} rows; got "
                             f"{a.dtype} {tuple(a.shape)} on {a.device}")
        out = torch.empty((rows,) + tuple(a.shape[1:]), dtype=a.dtype,
                          device=dev)
        outs.append(out)
        spec.append((a.data_ptr(), out.data_ptr(),
                     out.numel() * out.element_size()))
    lib = cuda.library("state_shrink")
    for lo in range(0, len(spec), SHRINK_MAX_ARRAYS):
        run = spec[lo:lo + SHRINK_MAX_ARRAYS]
        P = ctypes.c_int64 * len(run)
        status = lib.presto_state_shrink(
            P(*[r[0] for r in run]), P(*[r[1] for r in run]),
            P(*[r[2] for r in run]), ctypes.c_int32(len(run)),
            ctypes.c_void_p(cuda.stream_ptr(dev)))
        cuda.check(lib, status, "state_shrink")
        STATE_SHRINK_KERNEL.launches += 1
    return outs


def shrink_arrays(arrays: Sequence[torch.Tensor],
                  rows: int) -> List[torch.Tensor]:
    """K28: the first `rows` rows (a vector component's rows K wide) of
    every array, in new allocations of that size, so the full-capacity
    storage can be freed. The CUDA kernel on CUDA tensors (one launch
    for up to SHRINK_MAX_ARRAYS arrays), the plain version on CPU
    tensors."""
    if not arrays:
        return []
    if arrays[0].device.type == "cpu":
        return shrink_arrays_plain(arrays, rows)
    return _shrink_cuda(list(arrays), rows)


# -- K29: the finalize ---------------------------------------------------

#: K29 data ops and mask kinds (csrc/agg_finalize.cu DataOp, MaskKind)
FIN_OPS = {"convert": 0, "avg": 1, "var": 2, "bool": 3, "geomean": 4,
           "skewness": 5, "kurtosis": 6, "entropy": 7, "key": 8, "rv": 9,
           "pctl": 10, "hll": 11}
MASK_RV, MASK_CNT_GT, MASK_F64_POS, MASK_PTR, MASK_OP, MASK_NONE = range(6)
#: dtype codes of K29 (csrc/agg_finalize.cu Dtype)
FIN_DTYPES = {torch.bool: 0, torch.int8: 1, torch.int16: 2, torch.int32: 3,
              torch.int64: 4, torch.float32: 5, torch.float64: 6}


class FinColumn:
    """One output column of K29: its op, output tensors (data, mask or
    None), up to five state arrays, and the op's parameters; `aux` is
    the count array of a count mask, the float array of a positive
    mask, a key's own mask, or approx_percentile's bucket values."""

    def __init__(self, op: str, out: torch.Tensor,
                 out_mask: Optional[torch.Tensor], mask_kind: int,
                 states: Sequence[torch.Tensor] = (), ia: int = 0,
                 ib: int = 0, f: float = 0.0,
                 aux: Optional[torch.Tensor] = None, thr: int = 0):
        self.op, self.out, self.out_mask = op, out, out_mask
        self.mask_kind, self.states = mask_kind, list(states)
        self.ia, self.ib, self.f, self.aux, self.thr = ia, ib, f, aux, thr

    def words(self) -> List[int]:
        s = [t.data_ptr() for t in self.states] + [0] * (5 - len(self.states))
        s0_dt = FIN_DTYPES[self.states[0].dtype] if self.states else 0
        f_bits = struct.unpack("<q", struct.pack("<d", float(self.f)))[0]
        return [FIN_OPS[self.op], self.mask_kind, self.out.data_ptr(),
                0 if self.out_mask is None else self.out_mask.data_ptr(),
                FIN_DTYPES[self.out.dtype], *s, s0_dt, int(self.ia),
                int(self.ib), f_bits,
                0 if self.aux is None else self.aux.data_ptr(),
                int(self.thr)]


def finalize_columns(cols: Sequence[FinColumn], rows: int, cap: int,
                     rv: Optional[torch.Tensor]) -> None:
    """K29: write every column of `cols` (cap rows each; rows past `rows`
    zero with a false mask) in one launch. `rv` (bool[rows] or None for
    every row live) is the state's row validity the masks are ANDed
    with. CUDA tensors only (callers take the plain version, the composed
    drain of ops/hashagg.py, on CPU tensors)."""
    from presto_tpu_torch.native import cuda
    if not cols:
        return
    dev = cols[0].out.device
    lib = cuda.library("agg_finalize")
    for c in cols:
        for t in [c.out, c.out_mask, c.aux] + c.states:
            if t is not None and (t.device != dev or not t.is_contiguous()):
                raise ValueError(f"agg_finalize: {c.op} column's tensors "
                                 f"must be contiguous on {dev}")
        if c.out.shape[0] != cap or c.out.dtype not in FIN_DTYPES:
            raise ValueError(f"agg_finalize: {c.op} output must be {cap} "
                             f"rows of {sorted(map(str, FIN_DTYPES))}")
    table = torch.tensor([c.words() for c in cols], dtype=torch.int64)
    desc = table.pin_memory().to(dev, non_blocking=True)
    status = lib.presto_agg_finalize(
        ctypes.c_void_p(desc.data_ptr()), ctypes.c_int32(len(cols)),
        ctypes.c_int64(rows), ctypes.c_int64(cap),
        ctypes.c_void_p(0 if rv is None else rv.data_ptr()),
        ctypes.c_void_p(cuda.stream_ptr(dev)))
    cuda.check(lib, status, "agg_finalize")
    AGG_FINALIZE_KERNEL.launches += 1


# -- K30: the vector folds -------------------------------------------------

_VEC_DTYPES = {torch.int8: 1, torch.int32: 3}
_VEC_OPS = {"sum": 0, "max": 2}


def _vec_kind(reduce: str, dtype: torch.dtype) -> Tuple[int, int]:
    if (reduce, dtype) not in (("sum", torch.int32), ("max", torch.int8),
                               ("max", torch.int32)):
        raise ValueError(f"vector_reduce: a {reduce} of {dtype} vector "
                         "state (sum of int32 and max of int8 / int32 "
                         "are the kernel's)")
    return _VEC_OPS[reduce], _VEC_DTYPES[dtype]


def vector_ident(reduce: str, dtype: torch.dtype) -> int:
    return 0 if reduce == "sum" else torch.iinfo(dtype).min


def vector_direct_plain(gid: torch.Tensor, index: torch.Tensor,
                        value: torch.Tensor, table: torch.Tensor,
                        reduce: str) -> None:
    """Plain version of K30's direct mode: fold each row's pair into
    table[gid, index] in place (gid == slots: a dead row, dropped); under
    "max" every register of a slot a row reached is first raised to at
    least 0 (the zero entries of the reference's one-hot row)."""
    slots, K = table.shape
    flat = gid * K + index.to(torch.int64)
    red = torch.full(((slots + 1) * K,), vector_ident(reduce, table.dtype),
                     dtype=table.dtype, device=table.device)
    if reduce == "sum":
        red.index_add_(0, flat, value.to(table.dtype))
        table += red[:slots * K].view(slots, K)
        return
    touched = torch.zeros(slots + 1, dtype=torch.bool, device=table.device)
    touched[gid] = True
    hit = touched[:slots]
    table[hit] = torch.clamp(table[hit], min=0)
    red.scatter_reduce_(0, flat, value.to(table.dtype), "amax")
    table.copy_(torch.maximum(table, red[:slots * K].view(slots, K)))


def vector_direct(row_valid: torch.Tensor, key_codes, domains,
                  index: torch.Tensor, value: torch.Tensor,
                  table: torch.Tensor, reduce: str, slot_ids) -> None:
    """K30 on the direct path (K1's vector mode): fold every live row's
    (index, value) pair into table[slot, index] in place, the slot being
    K1's mixed-radix code of the row's keys (`key_codes`: at most
    KERNEL_MAX_KEYS (int32 code, bool mask), folded as for K1). The CUDA
    kernel on CUDA tensors; on CPU tensors the plain version, with the
    slots from `slot_ids` (ops/hashagg.py)."""
    if row_valid.device.type == "cpu":
        gid = slot_ids(row_valid, key_codes, domains, table.shape[0])
        vector_direct_plain(gid, index, value, table, reduce)
        return
    from presto_tpu_torch.native import cuda
    dev = row_valid.device
    n = row_valid.shape[0]
    slots, K = table.shape
    op, dt = _vec_kind(reduce, table.dtype)
    common.check_rows(row_valid, n, dev, (torch.bool,),
                      "vector_reduce: row_valid")
    common.check_rows(index, n, dev, (torch.int32,), "vector_reduce: index")
    common.check_rows(value, n, dev, (table.dtype,), "vector_reduce: value")
    if not table.is_contiguous() or table.device != dev:
        raise ValueError("vector_reduce: the table must be contiguous on "
                         f"{dev}")
    for code, mask in key_codes:
        common.check_rows(code, n, dev, (torch.int32,),
                          "vector_reduce: key codes")
        common.check_rows(mask, n, dev, (torch.bool,),
                          "vector_reduce: key mask")
    nk = len(key_codes)
    touched = torch.zeros(slots + 1, dtype=torch.uint8, device=dev)
    lib = cuda.library("vector_reduce")
    status = lib.presto_vector_direct(
        common._ptrs([c for c, _ in key_codes]),
        common._ptrs([m for _, m in key_codes]), common._i32s(list(domains)),
        ctypes.c_int32(nk), ctypes.c_void_p(row_valid.data_ptr()),
        ctypes.c_int64(n), ctypes.c_void_p(index.data_ptr()),
        ctypes.c_void_p(value.data_ptr()), ctypes.c_void_p(table.data_ptr()),
        ctypes.c_int32(slots), ctypes.c_int32(K), ctypes.c_int32(op),
        ctypes.c_int32(dt), ctypes.c_void_p(touched.data_ptr()),
        ctypes.c_void_p(cuda.stream_ptr(dev)))
    cuda.check(lib, status, "vector_reduce")
    VECTOR_REDUCE_KERNEL.launches += 1


class Segments:
    """Where each output group's rows lie among rows in group order, as
    K6 writes them and its plain version too: `starts` (int64[out_cap +
    1], the first row of each group g <= out_cap, g < groups) and
    `stats` (int64[4]: the group count, the overflow flag, the end of
    the last live row, and `live` = min(groups, out_cap)). None for a
    global aggregation: one group of all rows."""

    def __init__(self, starts: torch.Tensor, stats: torch.Tensor):
        self.starts, self.stats = starts, stats

    @property
    def groups(self) -> torch.Tensor:
        return self.stats[0]

    @property
    def live(self) -> torch.Tensor:
        return self.stats[3]


def segment_ids_of(seg: Segments, n: int, out_cap: int) -> torch.Tensor:
    """The group of each of `n` rows in group order: g for the rows from
    starts[g] up to the next group's start (the last live group's up to
    the end of the last live row), out_cap for the rows of no live
    group."""
    dev = seg.starts.device
    live = seg.live
    slot = torch.arange(out_cap + 1, device=dev)
    at = torch.where(slot < live, seg.starts, torch.full_like(slot, n))
    mark = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    mark.scatter_add_(0, at, torch.ones_like(at))
    gid = torch.cumsum(mark[:n], 0) - 1
    end = torch.where(seg.groups > live,
                      seg.starts[torch.clamp(live, max=out_cap)],
                      seg.stats[2])
    pos = torch.arange(n, device=dev)
    return torch.where((gid >= 0) & (pos < end), gid,
                       torch.full_like(gid, out_cap))


class Carry:
    """The streaming aggregation's carried group for one vector
    component: its [1, K] `row`, K8's `same` flag (int64[1] on the
    device: the batch's first group has the carry's keys) and the
    [1, K] tensor the new carry is written to."""

    def __init__(self, row: torch.Tensor, same: torch.Tensor,
                 out: torch.Tensor):
        self.row, self.same, self.out = row, same, out


def vector_segments_plain(seg: Optional[Segments],
                          valid: Optional[torch.Tensor], out_cap: int,
                          K: int, dtype: torch.dtype, reduce: str,
                          sparse: Optional[Tuple[torch.Tensor,
                                                 torch.Tensor]] = None,
                          dense: Optional[Sequence[torch.Tensor]] = None,
                          perm: Optional[torch.Tensor] = None,
                          carry: Optional[Carry] = None) -> torch.Tensor:
    """Plain version of K30's segment mode: [out_cap, K] of the groups'
    folds (see `vector_segments`)."""
    out = _segments_fold_plain(seg, valid, out_cap, K, dtype, reduce,
                               sparse, dense, perm)
    if carry is not None:
        live = seg.live
        row0 = torch.where(carry.same.bool(), _fold(
            reduce, out[0], carry.row[0].to(dtype)), out[0])
        out[0] = torch.where(live > 0, row0, out[0])
        last = torch.clamp(live - 1, min=0).reshape(1)
        carry.out.copy_(torch.where(live > 0, out.index_select(0, last),
                                    carry.row))
    return out


def _fold(reduce: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a + b if reduce == "sum" else torch.maximum(a, b)


def _segments_fold_plain(seg, valid, out_cap, K, dtype, reduce, sparse,
                         dense, perm) -> torch.Tensor:
    ident = vector_ident(reduce, dtype)
    if sparse is not None:
        index, value = sparse
        dev = index.device
        n = index.shape[0]
    else:
        rows = dense[0] if len(dense) == 1 else torch.cat(list(dense))
        if perm is not None:
            rows = rows[perm]
        dev = rows.device
        n = rows.shape[0]
    if seg is None:
        gid = torch.zeros(n, dtype=torch.int64, device=dev)
        live = 1
    else:
        gid = segment_ids_of(seg, n, out_cap)
        live = seg.live
    keep = torch.ones(n, dtype=torch.bool, device=dev) if valid is None \
        else valid
    gid = torch.where(keep, gid, torch.full_like(gid, out_cap))
    slot = torch.arange(out_cap + 1, device=dev)
    if sparse is not None:
        # a live group starts at 0: it holds at least one row, whose
        # dense row is 0 away from its index
        init = torch.where(slot < live, 0, ident).to(dtype)
        flat = init[:, None].expand(out_cap + 1, K).reshape(-1).clone()
        at = gid * K + index.to(torch.int64)
        if reduce == "sum":
            flat.index_add_(0, at, value.to(dtype))
        else:
            flat.scatter_reduce_(0, at, value.to(dtype), "amax")
        return flat.view(out_cap + 1, K)[:out_cap].contiguous()
    out = torch.full((out_cap + 1, K), ident, dtype=dtype, device=dev)
    if reduce == "sum":
        out.index_add_(0, gid, rows)
    else:
        out.scatter_reduce_(0, gid[:, None].expand(n, K), rows, "amax")
    return out[:out_cap].contiguous()


def vector_segments(seg: Optional[Segments], valid: Optional[torch.Tensor],
                    out_cap: int, K: int, dtype: torch.dtype, reduce: str,
                    sparse: Optional[Tuple[torch.Tensor,
                                           torch.Tensor]] = None,
                    dense: Optional[Sequence[torch.Tensor]] = None,
                    perm: Optional[torch.Tensor] = None,
                    carry: Optional[Carry] = None) -> torch.Tensor:
    """K30 over rows in group order: each output group's fold into
    [out_cap, K], groups past the live count the identity. `sparse`: one
    (index, value) pair per row in group order, a live group starting
    at 0. `dense`: the [rows, K] states of up to MAX_SOURCES partials,
    row p being row perm[p] of their concatenation, a live group
    starting at the identity. `valid` (per row in group order, or None
    for every row) drops dead rows; `seg` None folds all rows into group
    0. With `carry` (over K8's segments): the carried row folded into
    group 0 when `carry.same`, and the last live group's row (the
    carried row when there is no group) written to `carry.out`. The
    CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    dev = (sparse[0] if sparse is not None else dense[0]).device
    if dev.type == "cpu":
        return vector_segments_plain(seg, valid, out_cap, K, dtype, reduce,
                                     sparse, dense, perm, carry)
    from presto_tpu_torch.native import cuda
    op, dt = _vec_kind(reduce, dtype)
    out = torch.empty((out_cap, K), dtype=dtype, device=dev)
    if sparse is not None:
        index, value = sparse
        n = index.shape[0]
        common.check_rows(index, n, dev, (torch.int32,),
                          "vector_reduce: index")
        common.check_rows(value, n, dev, (dtype,), "vector_reduce: value")
        src, offs, nsrc, live_init = [], [0], 0, 0
    else:
        if not 1 <= len(dense) <= common.MAX_SOURCES:
            raise ValueError(f"vector_reduce: 1 to {common.MAX_SOURCES} "
                             f"sources, got {len(dense)}")
        src, offs = [], [0]
        for d in dense:
            if d.device != dev or d.dtype != dtype or d.dim() != 2 \
                    or d.shape[1] != K or not d.is_contiguous():
                raise ValueError(f"vector_reduce: sources must be "
                                 f"contiguous [rows, {K}] {dtype} on {dev}")
            src.append(d)
            offs.append(offs[-1] + d.shape[0])
        n = perm.shape[0] if perm is not None else offs[-1]
        nsrc, live_init, index, value = len(dense), vector_ident(
            reduce, dtype), None, None
    if perm is not None:
        common.check_rows(perm, n, dev, (torch.int64,),
                          "vector_reduce: permutation")
    if valid is not None:
        common.check_rows(valid, n, dev, (torch.bool,),
                          "vector_reduce: valid")
    if carry is not None:
        if seg is None:
            raise ValueError("vector_reduce: a carry needs K8's segments")
        for t, what in ((carry.row, "carry"), (carry.out, "new carry")):
            if t.device != dev or t.dtype != dtype \
                    or tuple(t.shape) != (1, K) or not t.is_contiguous():
                raise ValueError(f"vector_reduce: the {what} must be a "
                                 f"contiguous [1, {K}] {dtype} on {dev}")
        common.check_rows(carry.same, 1, dev, (torch.int64,),
                          "vector_reduce: carry flag")
    carry_ptrs = [ctypes.c_void_p(0)] * 3 if carry is None else [
        ctypes.c_void_p(t.data_ptr())
        for t in (carry.row, carry.same, carry.out)]
    lib = cuda.library("vector_reduce")
    status = lib.presto_vector_segments(
        ctypes.c_void_p(0 if index is None else index.data_ptr()),
        ctypes.c_void_p(0 if value is None else value.data_ptr()),
        common._ptrs(src), common._ptrs_raw(offs), ctypes.c_int32(nsrc),
        ctypes.c_void_p(0 if perm is None else perm.data_ptr()),
        ctypes.c_void_p(0 if valid is None else valid.data_ptr()),
        ctypes.c_void_p(0 if seg is None else seg.starts.data_ptr()),
        ctypes.c_void_p(0 if seg is None else seg.stats.data_ptr()),
        ctypes.c_int64(n), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_int64(out_cap), ctypes.c_int32(K), ctypes.c_int32(op),
        ctypes.c_int32(dt), ctypes.c_int32(vector_ident(reduce, dtype)),
        ctypes.c_int32(live_init), *carry_ptrs,
        ctypes.c_void_p(cuda.stream_ptr(dev)))
    cuda.check(lib, status, "vector_reduce")
    VECTOR_REDUCE_KERNEL.launches += 1
    return out
