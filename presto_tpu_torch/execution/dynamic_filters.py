"""Dynamic filtering, co-fragment tier (reference:
presto_tpu/execution/dynamic_filters.py;
operator/DynamicFilterSourceOperator and the dynamic-filter planner
rules).

The join BUILD operator keeps running per-key min/max as device
scalars (`bounds_step`, no host sync) and, at finish, a bounded
DISTINCT SET of its keys (`distinct_set`). Probe-side scans of the
same plan consult the registry per batch and narrow `row_valid`
(`apply_filter`). The port runs a plan's pipelines in order, build
before probe, so the filter is published before the probe's scan
yields its first batch.

The three steps are the `dynamic_filter` family's kernels on a CUDA
tensor: K21 `bounds_step` (one min/max launch), K22 `distinct_set`
and K23 `apply_filter`, all in csrc/dynamic_filter.cu. On
a CPU tensor each runs its plain version (`*_plain`), the reference's
arithmetic in torch.

On the distributed path a join's build and the scan it prunes can lie
in different fragments: `DynamicFilterService` is the query-wide
meeting point (reference: :77, DynamicFilterService.java). The runner
arms each filter with its publisher count (the build fragment's tasks);
`get` returns the merged filter once every task published, and
`pending` tells a scan to wait for it, so the pruning does not depend
on which task the drive loop runs first.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import ctypes
import threading

import torch

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.telemetry import kernels as _tk

#: launches of K21, K22 and K23
BOUNDS_KERNEL = _tk.LaunchCounter("df_bounds", "dynamic_filter")
SET_KERNEL = _tk.LaunchCounter("df_distinct_set", "dynamic_filter")
APPLY_KERNEL = _tk.LaunchCounter("df_apply", "dynamic_filter")

#: Max distinct build keys carried as a set; more degrades to bounds
#: only (reference: dynamic-filtering.max-distinct-values-per-driver).
DF_SET_MAX = 4096


class DynamicFilterRegistry:
    """Per-plan handoff: df_id -> published filter, one publisher per
    id."""

    def __init__(self):
        self._filters: Dict[int, "DFilter"] = {}
        self._seq = 0

    def new_id(self) -> int:
        self._seq += 1
        return self._seq

    def publish(self, df_id: int, mn, mx, dset=None) -> None:
        self._filters[df_id] = DFilter(mn, mx, dset)

    def get(self, df_id: int) -> Optional["DFilter"]:
        return self._filters.get(df_id)


class DynamicFilterService:
    """Cross-fragment filters of one query: `expect(df_id, n)` arms an
    id with its publisher count; `get` merges the n partial filters
    (bounds by min / max, sets by union while it fits DF_SET_MAX) once
    all arrived. Publishers are keyed by token, so a task publishing
    twice replaces its part instead of counting twice."""

    def __init__(self):
        self._expected: Dict[int, int] = {}
        self._parts: Dict[int, Dict] = {}
        self._merged: Dict[int, DFilter] = {}

    def expect(self, df_id: int, publishers: int) -> None:
        self._expected[df_id] = publishers

    def publish(self, df_id: int, mn, mx, dset=None, token=None) -> None:
        d = self._parts.setdefault(df_id, {})
        d[("anon", len(d)) if token is None else token] = \
            DFilter(mn, mx, dset)

    def pending(self, df_id: int) -> bool:
        """Armed and not every publisher has published yet."""
        expected = self._expected.get(df_id)
        return expected is not None and df_id not in self._merged \
            and len(self._parts.get(df_id, {})) < expected

    def get(self, df_id: int) -> Optional["DFilter"]:
        hit = self._merged.get(df_id)
        if hit is not None or self.pending(df_id) \
                or df_id not in self._expected:
            return hit
        parts = list(self._parts.get(df_id, {}).values())
        mn = torch.stack([p.mn for p in parts]).min()
        mx = torch.stack([p.mx for p in parts]).max()
        dset = None
        if parts and all(p.dset is not None for p in parts):
            vals = torch.cat([p.dset[0][:int(p.dset[1])] for p in parts])
            u = torch.unique(vals)
            if u.shape[0] <= DF_SET_MAX:
                info = _ident(u.dtype)
                padded = torch.full((DF_SET_MAX,), info.max, dtype=u.dtype,
                                    device=u.device)
                padded[:u.shape[0]] = u
                dset = (padded, torch.tensor(u.shape[0], device=u.device))
        merged = DFilter(mn, mx, dset)
        self._merged[df_id] = merged
        return merged


class BoundPublisher:
    """The service seen from one build task: its publications carry the
    task's token."""

    def __init__(self, svc: DynamicFilterService, token):
        self._svc = svc
        self._token = token

    def publish(self, df_id: int, mn, mx, dset=None) -> None:
        self._svc.publish(df_id, mn, mx, dset, token=self._token)


class DFilter:
    """One published filter: bounds + optional (values, count) set."""

    def __init__(self, mn, mx, dset=None):
        self.mn = mn
        self.mx = mx
        self.dset = dset  # (sorted values [DF_SET_MAX], count) | None


def _ident(dtype: torch.dtype):
    return torch.finfo(dtype) if dtype.is_floating_point \
        else torch.iinfo(dtype)


def bounds_init(dtype: torch.dtype, device: torch.device):
    """(max, min) of `dtype`: the empty bounds."""
    info = _ident(dtype)
    return (torch.tensor(info.max, dtype=dtype, device=device),
            torch.tensor(info.min, dtype=dtype, device=device))


def bounds_step(state, data: torch.Tensor, mask: torch.Tensor):
    """Fold one batch's key column into running (min, max) in the key's
    own dtype (reference: presto_tpu/execution/dynamic_filters.py:177).
    NULL and dead rows contribute identity; NaN keys are masked out
    (they never equi-match, and one would poison the bounds). K21 on a
    CUDA tensor: the new state stays on the device."""
    _tk.count("dynamic_filter")
    if data.device.type == "cpu":
        return bounds_step_plain(state, data, mask)
    return _bounds_cuda(state, data, mask)


def bounds_step_plain(state, data: torch.Tensor, mask: torch.Tensor):
    """K21's plain version. Here it departs from the reference's
    arithmetic on one point: every zero comes out as +0.0 (a float
    key's -0.0 and the running bounds' alike), as K21 has it. The
    reference's min / max reductions leave the sign of a zero bound to
    the order in which they meet -0.0 and +0.0, which no kernel can
    reproduce; with one sign, K21 and this version agree bit for bit.
    A bound filter compares by value (-0.0 == +0.0), so no row
    changes."""
    mn, mx = state
    if data.dtype.is_floating_point:
        mask = mask & ~torch.isnan(data)
        data, mn, mx = (torch.where(t == 0, torch.zeros_like(t), t)
                        for t in (data, mn, mx))
    info = _ident(data.dtype)
    if data.shape[0] == 0:
        return mn, mx
    lo = torch.where(mask, data, torch.full_like(data, info.max)).min()
    hi = torch.where(mask, data, torch.full_like(data, info.min)).max()
    return torch.minimum(mn, lo), torch.maximum(mx, hi)


#: every key dtype the planner gives a filter (INTEGER and DATE,
#: BIGINT and the other int64 types, REAL, DOUBLE, SMALLINT, TINYINT),
#: in the order of csrc/dynamic_filter.cu's dtype codes
_KEY_DTYPES = (torch.int32, torch.int64, torch.float32, torch.float64,
               torch.int16, torch.int8)
#: K21's partials and ticket per (device, stream), zeroed once (the
#: kernel leaves the ticket at 0)
_BOUNDS_SCRATCH: Dict[tuple, torch.Tensor] = {}


def _bounds_cuda(state, data: torch.Tensor, mask: torch.Tensor):
    from presto_tpu_torch.native import cuda
    from presto_tpu_torch.ops.common import check_rows
    dev, n = data.device, data.shape[0]
    code = _dtype_code(data.dtype, "df_bounds")
    check_rows(data, n, dev, _KEY_DTYPES, "df_bounds: keys")
    check_rows(mask, n, dev, (torch.bool,), "df_bounds: mask")
    mn, mx = state
    for t in state:
        if t.device != dev or t.dtype != data.dtype or t.dim():
            raise ValueError("df_bounds: the state must be two 0-d "
                             f"{data.dtype} tensors on {dev}")
    lib = cuda.library("dynamic_filter")
    stream = cuda.stream_ptr(dev)
    scratch = _BOUNDS_SCRATCH.get((dev, stream))
    if scratch is None:
        scratch = torch.zeros(lib.presto_df_bounds_scratch(),
                              dtype=torch.uint8, device=dev)
        _BOUNDS_SCRATCH[(dev, stream)] = scratch
    out = torch.empty(2, dtype=data.dtype, device=dev)
    status = lib.presto_df_bounds(
        ctypes.c_void_p(data.data_ptr()), ctypes.c_void_p(mask.data_ptr()),
        ctypes.c_int64(n), ctypes.c_int32(code),
        ctypes.c_void_p(mn.data_ptr()), ctypes.c_void_p(mx.data_ptr()),
        ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(scratch.data_ptr()),
        ctypes.c_void_p(stream))
    cuda.check(lib, status, "df_bounds")
    BOUNDS_KERNEL.launches += 1
    return out[0], out[1]


def distinct_set(data: torch.Tensor, mask: torch.Tensor):
    """Bounded distinct set of a (merged) build key column (reference:
    presto_tpu/execution/dynamic_filters.py:210). Returns (sorted values
    [DF_SET_MAX], count, overflow); unused slots hold the dtype max.
    K22 on a CUDA tensor (where on overflow the count saturates at
    DF_SET_MAX + 1 and the values are unspecified: no caller reads
    either then)."""
    _tk.count("dynamic_filter")
    if data.device.type == "cpu":
        return distinct_set_plain(data, mask)
    return _distinct_set_cuda(data, mask)


def distinct_set_plain(data: torch.Tensor, mask: torch.Tensor):
    """K22's plain version: one sort (dead lanes after live ones) +
    boundary dedupe, packed into DF_SET_MAX slots."""
    from presto_tpu_torch.ops.common import lex_perm_plain, partition_perm
    info = _ident(data.dtype)
    if data.dtype.is_floating_point:
        mask = mask & ~torch.isnan(data)
    perm = lex_perm_plain([~mask, data])
    sk, sv = data[perm], mask[perm]
    first = torch.ones_like(sv)
    first[1:] = (sk[1:] != sk[:-1]) | (sv[1:] != sv[:-1])
    keep = first & sv
    n = keep.sum()
    pk = sk[partition_perm(keep)]
    if pk.shape[0] >= DF_SET_MAX:
        pk = pk[:DF_SET_MAX]
    else:
        pk = torch.cat([pk, torch.full((DF_SET_MAX - pk.shape[0],),
                                       info.max, dtype=pk.dtype,
                                       device=pk.device)])
    slots = torch.arange(DF_SET_MAX, device=data.device)
    out = torch.where(slots < n, pk, torch.full_like(pk, info.max))
    return out, n, n > DF_SET_MAX


def _dtype_code(dtype: torch.dtype, what: str) -> int:
    if dtype not in _KEY_DTYPES:
        raise ValueError(f"{what}: key dtype {dtype} is not one of "
                         f"{_KEY_DTYPES}")
    return _KEY_DTYPES.index(dtype)


#: K22's hash table and state per (device, stream): the table's
#: 2 x DF_SET_MAX slots EMPTY (all ones) and the four state words 0
#: when made; each call's last block leaves them so
_SET_SCRATCH: Dict[tuple, torch.Tensor] = {}
#: held around a call's two launches: host threads that share a stream
#: would otherwise interleave two calls' launches over one table
_SET_LOCK = threading.Lock()


def _set_scratch(lib, dev, stream: int) -> torch.Tensor:
    scratch = _SET_SCRATCH.get((dev, stream))
    if scratch is None:
        words = lib.presto_df_set_scratch_words()
        scratch = torch.zeros(words, dtype=torch.int64, device=dev)
        scratch[:2 * DF_SET_MAX] = -1
        _SET_SCRATCH[(dev, stream)] = scratch
    return scratch


def set_outputs(dtype: torch.dtype, dev) -> Tuple[torch.Tensor, ...]:
    """K22's outputs as views of one allocation of DF_SET_MAX + 2 int64
    words: the values [DF_SET_MAX] of `dtype` at its head, then the
    int64 count and the overflow flag (0-d each)."""
    buf = torch.empty(DF_SET_MAX + 2, dtype=torch.int64, device=dev)
    return (buf.view(dtype)[:DF_SET_MAX],
            buf.as_strided((), (), DF_SET_MAX),
            buf.view(torch.bool).as_strided((), (), 8 * (DF_SET_MAX + 1)))


def _distinct_set_cuda(data: torch.Tensor, mask: torch.Tensor):
    from presto_tpu_torch.native import cuda
    from presto_tpu_torch.ops.common import check_rows
    lib = cuda.library("dynamic_filter")
    dev, n = data.device, data.shape[0]
    code = _dtype_code(data.dtype, "df_distinct_set")
    check_rows(data, n, dev, _KEY_DTYPES, "df_distinct_set: keys")
    check_rows(mask, n, dev, (torch.bool,), "df_distinct_set: mask")
    stream = cuda.stream_ptr(dev)
    vals, count, ovf = set_outputs(data.dtype, dev)
    with _SET_LOCK:
        scratch = _set_scratch(lib, dev, stream)
        status = lib.presto_distinct_set(
            ctypes.c_void_p(data.data_ptr()), ctypes.c_void_p(mask.data_ptr()),
            ctypes.c_int64(n), ctypes.c_int32(code),
            ctypes.c_void_p(scratch.data_ptr()),
            ctypes.c_void_p(vals.data_ptr()), ctypes.c_void_p(count.data_ptr()),
            ctypes.c_void_p(ovf.data_ptr()), ctypes.c_void_p(stream))
    cuda.check(lib, status, "df_distinct_set")
    SET_KERNEL.launches += 1
    return vals, count, ovf


def apply_filter(batch: Batch, col: str, mn, mx, has_set: bool,
                 dset_vals=None, dset_count=None) -> Batch:
    """Narrow row_valid to rows whose key can match the build side:
    bounds always, set membership when a set survived (inner-join
    semantics: NULL keys never match, so they drop too; reference:
    presto_tpu/execution/dynamic_filters.py:242). K23 on a CUDA
    batch."""
    _tk.count("dynamic_filter")
    if batch.device.type == "cpu":
        return apply_filter_plain(batch, col, mn, mx, has_set, dset_vals,
                                  dset_count)
    return _apply_cuda(batch, col, mn, mx, has_set, dset_vals, dset_count)


def apply_filter_plain(batch: Batch, col: str, mn, mx, has_set: bool,
                       dset_vals=None, dset_count=None) -> Batch:
    """K23's plain version."""
    c = batch.columns[col]
    # compare in the wider of the two key types, so that a build bound
    # never wraps into the probe column's narrower type
    wide = torch.promote_types(c.data.dtype, mn.dtype)
    d = c.data.to(wide)
    keep = (d >= mn.to(wide)) & (d <= mx.to(wide)) & c.mask
    if has_set:
        vals = dset_vals.to(wide)
        idx = torch.clamp(torch.searchsorted(vals, d), 0,
                          vals.shape[0] - 1)
        keep = keep & (vals[idx] == d) & (idx < dset_count)
    return Batch(batch.columns, batch.row_valid & keep)


def _apply_cuda(batch: Batch, col: str, mn, mx, has_set: bool,
                dset_vals, dset_count) -> Batch:
    from presto_tpu_torch.native import cuda
    from presto_tpu_torch.ops.common import check_rows
    lib = cuda.library("dynamic_filter")
    c = batch.columns[col]
    dev, n = batch.device, batch.capacity
    pt = _dtype_code(c.data.dtype, "df_apply")
    bt = _dtype_code(mn.dtype, "df_apply")
    key, mask = c.data.contiguous(), c.mask.contiguous()
    rv = batch.row_valid.contiguous()
    check_rows(key, n, dev, _KEY_DTYPES, "df_apply: keys")
    check_rows(mask, n, dev, (torch.bool,), "df_apply: mask")
    check_rows(rv, n, dev, (torch.bool,), "df_apply: row_valid")
    scalars = [mn, mx] + ([dset_count] if has_set else [])
    if any(t.device != dev or t.dim() for t in scalars) \
            or mx.dtype != mn.dtype \
            or (has_set and dset_count.dtype != torch.int64):
        raise ValueError("df_apply: mn, mx and the set count must be 0-d "
                         f"tensors on {dev} (mn, mx of one dtype, the "
                         "count int64)")
    if has_set:
        check_rows(dset_vals, DF_SET_MAX, dev, (mn.dtype,),
                   "df_apply: set values")
    out = torch.empty(n, dtype=torch.bool, device=dev)
    status = lib.presto_apply_filter(
        ctypes.c_void_p(key.data_ptr()), ctypes.c_void_p(mask.data_ptr()),
        ctypes.c_void_p(rv.data_ptr()), ctypes.c_int64(n),
        ctypes.c_int32(pt), ctypes.c_int32(bt),
        ctypes.c_void_p(mn.data_ptr()), ctypes.c_void_p(mx.data_ptr()),
        ctypes.c_void_p(dset_vals.data_ptr() if has_set else 0),
        ctypes.c_void_p(dset_count.data_ptr() if has_set else 0),
        ctypes.c_int32(int(has_set)), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(cuda.stream_ptr(dev)))
    cuda.check(lib, status, "df_apply")
    if n > 0:
        APPLY_KERNEL.launches += 1
    return Batch(batch.columns, out)


def apply(batch: Batch, col: str, f: DFilter) -> Batch:
    if f.dset is not None:
        return apply_filter(batch, col, f.mn, f.mx, True, f.dset[0],
                            f.dset[1])
    return apply_filter(batch, col, f.mn, f.mx, False)
