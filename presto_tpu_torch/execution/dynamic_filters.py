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

All three steps are composed torch (the `dynamic_filter` family); a
hand-written kernel is queued in ROADMAP B9. The cross-fragment
service of the mesh runner comes with the distributed slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.telemetry import kernels as _tk

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
    own dtype. NULL and dead rows contribute identity; NaN keys are
    masked out (they never equi-match, and one would poison the
    bounds)."""
    _tk.count("dynamic_filter")
    mn, mx = state
    if data.dtype.is_floating_point:
        mask = mask & ~torch.isnan(data)
    info = _ident(data.dtype)
    lo = torch.where(mask, data, torch.full_like(data, info.max)).min()
    hi = torch.where(mask, data, torch.full_like(data, info.min)).max()
    return torch.minimum(mn, lo), torch.maximum(mx, hi)


def distinct_set(data: torch.Tensor, mask: torch.Tensor):
    """Bounded distinct set of a (merged) build key column: one sort
    (dead lanes after live ones) + boundary dedupe, packed into
    DF_SET_MAX slots. Returns (sorted values [DF_SET_MAX], count,
    overflow); unused slots hold the dtype max."""
    _tk.count("dynamic_filter")
    from presto_tpu_torch.ops.common import lex_perm, partition_perm
    info = _ident(data.dtype)
    if data.dtype.is_floating_point:
        mask = mask & ~torch.isnan(data)
    perm = lex_perm([~mask, data])
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


def apply_filter(batch: Batch, col: str, mn, mx, has_set: bool,
                 dset_vals=None, dset_count=None) -> Batch:
    """Narrow row_valid to rows whose key can match the build side:
    bounds always, set membership when a set survived (inner-join
    semantics: NULL keys never match, so they drop too)."""
    _tk.count("dynamic_filter")
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


def apply(batch: Batch, col: str, f: DFilter) -> Batch:
    if f.dset is not None:
        return apply_filter(batch, col, f.mn, f.mx, True, f.dset[0],
                            f.dset[1])
    return apply_filter(batch, col, f.mn, f.mx, False)
