"""Ordering kernels (reference: presto_tpu/ops/sort.py; OrderByOperator.java:44,
TopNOperator.java:35, LimitOperator).

Full sort runs one lexicographic sort over an accumulated batch; TopN
keeps a bounded running state (state ++ batch -> sort -> first N);
LIMIT keeps the first rows of each batch against a running count that
stays on the device. On CUDA tensors a sort is K24 (csrc/sort_encode.cu:
the operands as key words), K25 (csrc/radix_sort.cu: the stable
permutation) and K26 (csrc/gather_rows.cu: every column moved in one
launch), through `common.sort_rows`; topn runs the same three kernels
over state and batch as two sources, with no concatenation, and keeps
the first `cap` rows (on CPU tensors through their plain versions);
LIMIT is K27 (csrc/limit_rank.cu), which also carries the emitted count
on the device. DISTINCT folds state ++ batch
through the sort-based grouping with no aggregates: K3's row hashes,
K25 over (h1, h2), K26 and K6's group boundaries and first rows, the
arrangement the sort-based aggregation runs. On CPU tensors every step
is its plain version.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.ops import common
from presto_tpu_torch.telemetry import kernels as _tk


def sort_batch(batch: Batch, key_names: Tuple[str, ...],
               descending: Tuple[bool, ...],
               nulls_first: Tuple[bool, ...]) -> Batch:
    """Reorder rows into key order, invalid rows compacted to the end
    (the reference's `_sort_batch_impl`)."""
    _tk.count("sort")
    keys = [batch.columns[k].astuple() for k in key_names]
    other = [n for n in batch.names if n not in key_names]
    payloads: list = []
    for n in other:
        payloads.extend(batch.columns[n].astuple())
    skeys, svalid, spay = common.sort_rows(
        keys, list(descending), list(nulls_first),
        valid=batch.row_valid, payloads=payloads)
    cols = {}
    for name, (d, m) in zip(key_names, skeys):
        c = batch.columns[name]
        cols[name] = Column(d, m, c.type, c.dictionary)
    for i, name in enumerate(other):
        c = batch.columns[name]
        cols[name] = Column(spay[2 * i], spay[2 * i + 1], c.type,
                            c.dictionary)
    return Batch({n: cols[n] for n in batch.names}, svalid)


def topn_state(schema_cols: Sequence[tuple], capacity: int,
               device: torch.device) -> Batch:
    cols = {name: Column(torch.zeros(capacity, dtype=typ.torch_dtype,
                                     device=device),
                         torch.zeros(capacity, dtype=torch.bool,
                                     device=device), typ, dic)
            for name, typ, dic in schema_cols}
    return Batch(cols, torch.zeros(capacity, dtype=torch.bool,
                                   device=device))


def topn_step(state: Batch, batch: Batch, n: int,
              key_names: Tuple[str, ...], descending: Tuple[bool, ...],
              nulls_first: Tuple[bool, ...]) -> Batch:
    """Fold step: keep the N smallest (per ordering) of state ++ batch
    (the reference's `_topn_step_impl`). `state` has capacity >= n; the
    output reuses that capacity, rows past `n` dead with their masks
    cleared. `n` is a runtime value. K24, K25 and K26 read state and
    batch as two sources, so nothing is concatenated; on CPU tensors
    their plain versions."""
    _tk.count("topn")
    parts = [([state.columns[nm].astuple() for nm in state.names],
              state.row_valid),
             ([batch.columns[nm].astuple() for nm in state.names],
              batch.row_valid)]
    kidx = [state.names.index(k) for k in key_names]
    words, digits = common.sort_encode(
        [([cols[i] for i in kidx], valid) for cols, valid in parts],
        descending, nulls_first)
    perm, _ = common.radix_sort(words, digits)
    out, live = common.gather_rows(parts, perm, rows=state.capacity,
                                   limit=n)
    return Batch({nm: Column(d, m, state.columns[nm].type,
                             state.columns[nm].dictionary)
                  for nm, (d, m) in zip(state.names, out)}, live)


#: launches of the CUDA LIMIT kernel (csrc/limit_rank.cu)
LIMIT_RANK_KERNEL = _tk.LaunchCounter("limit_rank", "limit")


def limit_rank_plain(row_valid: torch.Tensor, n: int,
                     emitted: torch.Tensor):
    """Plain version of K27: (keep, emitted + kept) with keep =
    row_valid & (rank among live rows < n - emitted)."""
    rank = torch.cumsum(row_valid.to(torch.int64), 0) - 1
    keep = row_valid & (rank < (n - emitted))
    return keep, emitted + keep.sum()


def _limit_rank_cuda(row_valid: torch.Tensor, n: int,
                     emitted: torch.Tensor):
    from presto_tpu_torch.native import cuda
    dev = row_valid.device
    rows = row_valid.shape[0]
    common.check_rows(row_valid, rows, dev, (torch.bool,),
                      "limit_rank: row_valid")
    if emitted.device != dev or emitted.dtype != torch.int64 \
            or emitted.numel() != 1:
        raise ValueError("limit_rank: the emitted count must be one int64 "
                         f"on {dev}; got {emitted.dtype} "
                         f"{tuple(emitted.shape)} on {emitted.device}")
    keep = torch.empty(rows, dtype=torch.bool, device=dev)
    out = torch.empty((), dtype=torch.int64, device=dev)
    if rows == 0:
        out.copy_(emitted.reshape(()))
        return keep, out
    lib = cuda.library("limit_rank")
    tiles = lib.presto_limit_tiles(ctypes.c_int64(rows))
    counts = torch.empty(tiles, dtype=torch.int32, device=dev)
    offsets = torch.empty(tiles, dtype=torch.int64, device=dev)
    status = lib.presto_limit_rank(
        ctypes.c_void_p(row_valid.data_ptr()), ctypes.c_int64(rows),
        ctypes.c_int64(int(n)),
        ctypes.c_void_p(emitted.data_ptr()),
        ctypes.c_void_p(keep.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        ctypes.c_void_p(counts.data_ptr()),
        ctypes.c_void_p(offsets.data_ptr()),
        ctypes.c_void_p(cuda.stream_ptr(dev)))
    cuda.check(lib, status, "limit_rank")
    LIMIT_RANK_KERNEL.launches += 1
    return keep, out


def limit_rank(row_valid: torch.Tensor, n: int, emitted: torch.Tensor):
    """K27: LIMIT's keep mask over one batch and the new emitted count,
    both on the device (`emitted` is a device int64 the kernel reads).
    The CUDA kernel on CUDA tensors, the plain version on CPU tensors."""
    if row_valid.device.type == "cpu":
        return limit_rank_plain(row_valid, n, emitted)
    return _limit_rank_cuda(row_valid, n, emitted)


def limit_batch(batch: Batch, n: int, already_emitted: torch.Tensor):
    """Keep the first (n - already_emitted) live rows of this batch.
    Returns (the batch with that keep mask as row_valid, the new emitted
    count): `already_emitted` and the count are device scalars, so no
    host read."""
    _tk.count("limit")
    keep, emitted = limit_rank(batch.row_valid.contiguous(), n,
                               already_emitted)
    return Batch(batch.columns, keep), emitted


def distinct_state(schema_cols: Sequence[tuple], capacity: int,
                   device: torch.device) -> Batch:
    """An empty DISTINCT state of `capacity` rows."""
    return topn_state(schema_cols, capacity, device)


def distinct_step(state: Batch, batch: Batch) -> Batch:
    """Fold step for SELECT DISTINCT and the dedup of UNION: regroup
    state ++ batch by all columns and keep one representative per group
    (the reference's `_distinct_step_impl`, presto_tpu/ops/sort.py:106:
    `hashagg._group_reduce` with zero aggregates, here K3 + K25 + K26 +
    K6, which read the state and the batch as two sources: nothing is
    concatenated on the card). Groups beyond the state's capacity are
    dropped; the operator grows the state before that can happen."""
    _tk.count("distinct")
    return _distinct_fold(state, batch, plain=False)


def distinct_step_plain(state: Batch, batch: Batch) -> Batch:
    """`distinct_step` through the plain versions of K3, K25, K26 and
    K6, on any device (the yardstick the card's composition is held
    against)."""
    return _distinct_fold(state, batch, plain=True)


def _distinct_fold(state: Batch, batch: Batch, plain: bool) -> Batch:
    from presto_tpu_torch.ops import hashagg
    keys = [state.columns[n].astuple() for n in state.names]
    batch_keys = [(batch.columns[n].data.to(d.dtype), batch.columns[n].mask)
                  for n, (d, _) in zip(state.names, keys)]
    gr = hashagg._group_reduce_parts(
        [(keys, state.row_valid, []), (batch_keys, batch.row_valid, [])],
        [], state.capacity, plain)
    cols = {name: Column(d, m, state.columns[name].type,
                         state.columns[name].dictionary)
            for name, (d, m) in zip(state.names, gr.keys)}
    return Batch(cols, gr.valid)
