"""Merge of sorted runs (reference: presto_tpu/ops/merge.py;
operator/MergeOperator.java:44 merging pre-sorted remote shards).

Two sorted runs A and B merge by rank arithmetic: A's row i goes to
slot i + #(B rows strictly below it), B's row j to j + #(A rows at or
below it), so ties keep A first, and one scatter places every column.
k runs fold pairwise in a log-depth tree.

The rows must be compared exactly as they were sorted, or two rows
land in one slot. The runs come from the port's `common.sort_rows`
(torch.sort), so `canonical_ops` takes its operands
(`common.key_sort_ops`): ~row_valid, then per key the null rank and
the canonical value (negated under DESC, 0 for NULL, every NaN one
value after every number, -0.0 equal to +0.0). The reference's
totalOrder bitcast (:31) orders floats as lax.sort does, which is
neither torch.sort's order nor the reference's own CPU sort's.

`merge_pair` is kernel K19 (csrc/merge_pair.cu) on CUDA batches and
`merge_pair_plain` on CPU batches.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.ops import common
from presto_tpu_torch.telemetry import kernels as _tk

#: launches of the merge kernel (csrc/merge_pair.cu)
MERGE_KERNEL = _tk.LaunchCounter("merge_pair", "merge")

#: key dtype -> code of csrc/merge_pair.cu's dtype enum
MERGE_DTYPES = {torch.bool: 0, torch.int8: 1, torch.int16: 2,
                torch.int32: 3, torch.int64: 4, torch.float32: 5,
                torch.float64: 6}


def canonical_ops(batch: Batch, key_names: Sequence[str],
                  descending: Sequence[bool],
                  nulls_first: Sequence[bool]) -> List[torch.Tensor]:
    """Sort operands in significance order, each an int64 or float64
    tensor: ~row_valid, then per key `common.key_sort_ops`' null rank
    and canonical value (a float value as (is NaN, value with NaN as
    0), so that NaN compares above every number and equal to NaN)."""
    ops = [(~batch.row_valid).to(torch.int64)]
    for name, d, nfirst in zip(key_names, descending, nulls_first):
        c = batch.columns[name]
        rank, value = common.key_sort_ops(c.data, c.mask, d, nfirst)
        ops.append(rank.to(torch.int64))
        if value.is_floating_point():
            nan = torch.isnan(value)
            ops.append(nan.to(torch.int64))
            ops.append(torch.where(nan, torch.zeros_like(value), value)
                       .to(torch.float64))
        else:
            ops.append(value.to(torch.int64))
    return ops


def lex_count_below(b_ops: Sequence[torch.Tensor],
                    a_ops: Sequence[torch.Tensor],
                    strict: bool) -> torch.Tensor:
    """For every row of A, how many rows of the sorted run B order
    before it: strictly (<) or at-or-below (<=). A vectorized binary
    search of ceil(log2(nB)) + 1 rounds."""
    n_b = b_ops[0].shape[0]
    n_a = a_ops[0].shape[0]
    dev = a_ops[0].device
    lo = torch.zeros(n_a, dtype=torch.int64, device=dev)
    hi = torch.full((n_a,), n_b, dtype=torch.int64, device=dev)
    for _ in range(common.search_iters(n_b)):
        mid = (lo + hi) // 2
        midc = torch.clamp(mid, max=max(n_b - 1, 0))
        lt = torch.zeros(n_a, dtype=torch.bool, device=dev)
        eq = torch.ones(n_a, dtype=torch.bool, device=dev)
        for bo, ao in zip(b_ops, a_ops):
            bv = bo[midc]
            lt = lt | (eq & (bv < ao))
            eq = eq & (bv == ao)
        advance = (lt | eq) if not strict else lt
        lo = torch.where(advance, mid + 1, lo)
        hi = torch.where(advance, hi, mid)
        # a finished search stays put
        lo = torch.clamp(lo, max=n_b)
    return lo


def merge_pair_plain(a: Batch, b: Batch, key_names: Sequence[str],
                     descending: Sequence[bool],
                     nulls_first: Sequence[bool]) -> Batch:
    """K19's plain version: the rank arithmetic in torch."""
    a_ops = canonical_ops(a, key_names, descending, nulls_first)
    b_ops = canonical_ops(b, key_names, descending, nulls_first)
    dev = a.device
    pos_a = torch.arange(a.capacity, device=dev) \
        + lex_count_below(b_ops, a_ops, strict=True)
    pos_b = torch.arange(b.capacity, device=dev) \
        + lex_count_below(a_ops, b_ops, strict=False)
    out_cap = a.capacity + b.capacity
    cols = {}
    for name in a.names:
        ca, cb = a.columns[name], b.columns[name]
        data = torch.zeros(out_cap, dtype=ca.data.dtype, device=dev)
        data[pos_a] = ca.data
        data[pos_b] = cb.data
        mask = torch.zeros(out_cap, dtype=torch.bool, device=dev)
        mask[pos_a] = ca.mask
        mask[pos_b] = cb.mask
        cols[name] = Column(data, mask, ca.type, ca.dictionary)
    rv = torch.zeros(out_cap, dtype=torch.bool, device=dev)
    rv[pos_a] = a.row_valid
    rv[pos_b] = b.row_valid
    return Batch(cols, rv)


def _merge_cuda(a: Batch, b: Batch, key_names, descending, nulls_first
                ) -> Batch:
    from presto_tpu_torch.native import cuda
    lib = cuda.library("merge_pair")
    dev = a.device
    na, nb = a.capacity, b.capacity
    nk = len(key_names)
    if nk > lib.presto_merge_max_keys():
        raise ValueError(f"merge_pair: at most "
                         f"{lib.presto_merge_max_keys()} sort keys, got {nk}")
    for run, n, what in ((a, na, "A"), (b, nb, "B")):
        common.check_rows(run.row_valid, n, dev, (torch.bool,),
                          f"merge_pair: run {what} row_valid")
        for name in run.names:
            c = run.columns[name]
            common.check_rows(c.data, n, dev, (a.columns[name].data.dtype,),
                              f"merge_pair: run {what} column {name}")
            common.check_rows(c.mask, n, dev, (torch.bool,),
                              f"merge_pair: run {what} mask {name}")
    for name in key_names:
        if a.columns[name].data.dtype not in MERGE_DTYPES:
            raise ValueError(f"merge_pair: key {name} of dtype "
                             f"{a.columns[name].data.dtype}")
    P = ctypes.c_int64 * max(nk, 1)
    I = ctypes.c_int32 * max(nk, 1)
    keys = (P(*[a.columns[k].data.data_ptr() for k in key_names]),
            P(*[a.columns[k].mask.data_ptr() for k in key_names]),
            P(*[b.columns[k].data.data_ptr() for k in key_names]),
            P(*[b.columns[k].mask.data_ptr() for k in key_names]),
            I(*[MERGE_DTYPES[a.columns[k].data.dtype] for k in key_names]),
            I(*[int(bool(x)) for x in descending]),
            I(*[int(bool(x)) for x in nulls_first]))
    out_cap = na + nb
    names = a.names
    cols = {n: Column(torch.empty(out_cap, dtype=a.columns[n].data.dtype,
                                  device=dev),
                      torch.empty(out_cap, dtype=torch.bool, device=dev),
                      a.columns[n].type, a.columns[n].dictionary)
            for n in names}
    rv = torch.empty(out_cap, dtype=torch.bool, device=dev)
    max_cols = lib.presto_merge_max_cols()
    runs = [names[lo:lo + max_cols]
            for lo in range(0, len(names), max_cols)] or [[]]
    stream = ctypes.c_void_p(cuda.stream_ptr(dev))
    for i, run in enumerate(runs):
        k = max(len(run), 1)
        C, S = ctypes.c_int64 * k, ctypes.c_int32 * k
        status = lib.presto_merge_pair(
            *keys, ctypes.c_int32(nk),
            ctypes.c_void_p(a.row_valid.data_ptr()), ctypes.c_int64(na),
            ctypes.c_void_p(b.row_valid.data_ptr()), ctypes.c_int64(nb),
            C(*[a.columns[n].data.data_ptr() for n in run]),
            C(*[a.columns[n].mask.data_ptr() for n in run]),
            C(*[b.columns[n].data.data_ptr() for n in run]),
            C(*[b.columns[n].mask.data_ptr() for n in run]),
            C(*[cols[n].data.data_ptr() for n in run]),
            C(*[cols[n].mask.data_ptr() for n in run]),
            S(*[cols[n].data.element_size() for n in run]),
            ctypes.c_int32(len(run)), ctypes.c_void_p(rv.data_ptr()),
            ctypes.c_int32(int(i == 0)), stream)
        cuda.check(lib, status, "merge_pair")
        MERGE_KERNEL.launches += 1
    return Batch(cols, rv)


def merge_pair(a: Batch, b: Batch, key_names: Sequence[str],
               descending: Sequence[bool],
               nulls_first: Sequence[bool]) -> Batch:
    """K19: merge two sorted batches into one sorted batch of capacity
    |A| + |B| (dead rows sort last in both, so they land last). The
    CUDA kernel on CUDA batches, the plain version on CPU batches."""
    _tk.count("merge")
    if a.device.type == "cpu":
        return merge_pair_plain(a, b, key_names, descending, nulls_first)
    return _merge_cuda(a, b, key_names, descending, nulls_first)


def merge_runs(runs: Sequence[Batch], key_names: Sequence[str],
               descending: Sequence[bool],
               nulls_first: Sequence[bool]) -> Batch:
    """Pairwise log-depth tree fold of k sorted runs."""
    key_names: Tuple[str, ...] = tuple(key_names)
    level = list(runs)
    while len(level) > 1:
        nxt = [merge_pair(level[i], level[i + 1], key_names, descending,
                          nulls_first)
               for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]
