"""Merge of sorted runs (reference: presto_tpu/ops/merge.py;
operator/MergeOperator.java:44 merging pre-sorted remote shards).

Two sorted runs A and B merge stably, ties taking A first: A's row i
goes to slot i + #(B rows strictly below it), B's row j to j + #(A rows
at or below it). k runs fold pairwise in a log-depth tree.

The runs are each task's ORDER BY output, which the card sorts through
K24 -> K25 -> K26 (`common.sort_rows`): by the unsigned key words of
csrc/sort_code.cuh. K19 compares rows by the same words, encoded from
the same pack plan (`common.sort_pack_plan`), so it orders them exactly
as they were sorted. `canonical_ops` gives the plain version that order
as operands: ~row_valid, then per key the null rank and the canonical
value (negated under DESC, 0 for NULL, every NaN one value after every
number, -0.0 equal to +0.0). The reference's totalOrder bitcast (:31)
orders floats as lax.sort does, which is neither the port's order nor
the reference's own CPU sort's.

`merge_pair` is kernel K19 (csrc/merge_pair.cu: one launch per merge at
any column count, a merge path through shared memory, bound by the
latency of its split search and copy) on CUDA batches and
`merge_pair_plain` on CPU batches.
"""

from __future__ import annotations

import array
import functools
from typing import List, Sequence, Tuple

import torch

from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.ops import common
from presto_tpu_torch.telemetry import kernels as _tk

#: launches of the merge kernel (csrc/merge_pair.cu)
MERGE_KERNEL = _tk.LaunchCounter("merge_pair", "merge")

#: most sort keys one K19 launch compares, and columns it carries by value
#: (csrc/merge_pair.cu MAX_KEYS, INLINE_COLS; later columns go in a
#: device table, in the same launch)
MERGE_MAX_KEYS = 24
MERGE_INLINE_COLS = 24


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
    if n_b == 0:
        return lo
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


@functools.lru_cache(maxsize=256)
def merge_pack_plan(dtypes: Tuple[torch.dtype, ...]):
    """K19's pack plan for keys of these dtypes, each with a mask, after
    ~row_valid: the one K24 encodes the runs' sort with
    (`common._sort_layout`): (bit of ~row_valid, per key (bit of its
    null rank, bit of its value, value bits), words)."""
    return common._sort_layout(True, [(dt, True) for dt in dtypes])


def _merge_cuda(a: Batch, b: Batch, key_names, descending, nulls_first
                ) -> Batch:
    from presto_tpu_torch.native import cuda
    lib = cuda.library("merge_pair")
    dev = a.device
    na, nb = a.capacity, b.capacity
    nk = len(key_names)
    if nk > MERGE_MAX_KEYS:
        raise ValueError(f"merge_pair: at most {MERGE_MAX_KEYS} sort keys, "
                         f"got {nk}")
    names = a.names
    dtypes = [a.columns[n].data.dtype for n in names]
    for run, n, what in ((a, na, "A"), (b, nb, "B")):
        common.check_rows(run.row_valid, n, dev, (torch.bool,),
                          f"merge_pair: run {what} row_valid")
        for name, dt in zip(names, dtypes):
            c = run.columns[name]
            common.check_rows(c.data, n, dev, (dt,),
                              f"merge_pair: run {what} column {name}")
            common.check_rows(c.mask, n, dev, (torch.bool,),
                              f"merge_pair: run {what} mask {name}")
    key_dtypes = tuple(a.columns[k].data.dtype for k in key_names)
    try:
        pos_valid, layout, nwords = merge_pack_plan(key_dtypes)
    except ValueError as e:
        raise ValueError(f"merge_pair: {e}") from None
    out_cap = na + nb
    cols = {n: Column(torch.empty(out_cap, dtype=dt, device=dev),
                      torch.empty(out_cap, dtype=torch.bool, device=dev),
                      a.columns[n].type, a.columns[n].dictionary)
            for n, dt in zip(names, dtypes)}
    rv = torch.empty(out_cap, dtype=torch.bool, device=dev)
    if out_cap == 0:
        return Batch(cols, rv)
    desc = [nk, nwords, pos_valid, len(names), na, nb,
            a.row_valid.data_ptr(), b.row_valid.data_ptr(), rv.data_ptr()]
    for name, dt, d, nf, (rank, vpos, width) in zip(
            key_names, key_dtypes, descending, nulls_first, layout):
        ca, cb = a.columns[name], b.columns[name]
        desc += (ca.data.data_ptr(), cb.data.data_ptr(),
                 ca.mask.data_ptr(), cb.mask.data_ptr(),
                 common.SORT_DTYPES[dt][0], int(bool(d)), int(bool(nf)),
                 rank, vpos, width)
    entries = []
    for name in names:
        ca, cb, co = a.columns[name], b.columns[name], cols[name]
        entries.append((ca.data.data_ptr(), cb.data.data_ptr(),
                        ca.mask.data_ptr(), cb.mask.data_ptr(),
                        co.data.data_ptr(), co.mask.data_ptr(),
                        co.data.element_size()))
    for e in entries[:MERGE_INLINE_COLS]:
        desc += e
    # the columns past the inline ones: a device table the kernel reads
    # (held until the launch is queued)
    extra = None
    if len(entries) > MERGE_INLINE_COLS:
        extra = torch.tensor(entries[MERGE_INLINE_COLS:], dtype=torch.int64
                             ).pin_memory().to(dev, non_blocking=True)
    desc = array.array("q", desc)
    status = lib.presto_merge_pair(
        desc.buffer_info()[0], None if extra is None else extra.data_ptr(),
        cuda.stream_ptr(dev))
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
