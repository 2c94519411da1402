"""Ordering kernels (reference: presto_tpu/ops/sort.py; OrderByOperator.java:44,
TopNOperator.java:35, LimitOperator).

Full sort runs one lexicographic sort over an accumulated batch; TopN
keeps a bounded running state (state ++ batch -> sort -> first N);
LIMIT keeps the first rows of each batch against a running count that
stays on the device. On CUDA tensors a sort is K24 (csrc/sort_encode.cu:
the operands as key words), K25 (csrc/radix_sort.cu: the stable
permutation) and K26 (csrc/gather_rows.cu: every column moved in one
launch), through `common.sort_rows`; topn codes state and batch as two
sources with K24 (no concatenation), selects the candidates for its
first `cap` rows with K31 and sorts only those with K32
(csrc/topn_select.cu) before K26 (on CPU tensors the plain versions);
LIMIT is K27 (csrc/limit_rank.cu), which also carries the emitted count
on the device. DISTINCT folds state ++ batch
through the sort-based grouping with no aggregates: K3's row hashes,
K25 over (h1, h2), K26 and K6's group boundaries and first rows, the
arrangement the sort-based aggregation runs. On CPU tensors every step
is its plain version.
"""

from __future__ import annotations

import threading
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


def _topn_parts(state: Batch, batch: Batch, key_names, descending,
                nulls_first):
    """state and batch as two sources of K24 / K26, and their key
    words and digit masks."""
    parts = [([state.columns[nm].astuple() for nm in state.names],
              state.row_valid),
             ([batch.columns[nm].astuple() for nm in state.names],
              batch.row_valid)]
    kidx = [state.names.index(k) for k in key_names]
    words, digits = common.sort_encode(
        [([cols[i] for i in kidx], valid) for cols, valid in parts],
        descending, nulls_first)
    return parts, words, digits


def _topn_batch(state: Batch, parts, perm, n) -> Batch:
    out, live = common.gather_rows(parts, perm, rows=state.capacity,
                                   limit=n)
    return Batch({nm: Column(d, m, state.columns[nm].type,
                             state.columns[nm].dictionary)
                  for nm, (d, m) in zip(state.names, out)}, live)


def topn_step(state: Batch, batch: Batch, n: int,
              key_names: Tuple[str, ...], descending: Tuple[bool, ...],
              nulls_first: Tuple[bool, ...]) -> Batch:
    """Fold step: keep the N smallest (per ordering) of state ++ batch
    (the reference's `_topn_step_impl`). `state` has capacity >= n; the
    output reuses that capacity, rows past `n` dead with their masks
    cleared. `n` is a runtime value. Its slots are the first
    `state.capacity` entries of the stable order of state ++ batch: K24
    codes the keys of both sources (nothing is concatenated), K31
    selects the candidates that hold those entries and K32 sorts only
    them (`common.topn_order`), K26 moves the rows; on CPU tensors the
    plain versions."""
    _tk.count("topn")
    parts, words, digits = _topn_parts(state, batch, key_names, descending,
                                       nulls_first)
    perm = common.topn_order(words, digits, state.capacity)
    return _topn_batch(state, parts, perm, n)


def topn_step_full_sort(state: Batch, batch: Batch, n: int,
                        key_names: Tuple[str, ...],
                        descending: Tuple[bool, ...],
                        nulls_first: Tuple[bool, ...]) -> Batch:
    """`topn_step` by ordering every row of state ++ batch: K24, K25 over
    all N rows, K26. The same slots; no caller on the main path (the
    yardstick the select is timed against)."""
    parts, words, _ = _topn_parts(state, batch, key_names, descending,
                                  nulls_first)
    perm, _ = common.radix_sort(words)
    return _topn_batch(state, parts, perm, n)


#: launches of the CUDA LIMIT kernel (csrc/limit_rank.cu)
LIMIT_RANK_KERNEL = _tk.LaunchCounter("limit_rank", "limit")


def limit_rank_plain(row_valid: torch.Tensor, n: int,
                     emitted: torch.Tensor):
    """Plain version of K27: (keep, emitted + kept) with keep =
    row_valid & (rank among live rows < n - emitted)."""
    rank = torch.cumsum(row_valid.to(torch.int64), 0) - 1
    keep = row_valid & (rank < (n - emitted))
    return keep, emitted + keep.sum()


#: rows of one K27 tile (csrc/limit_rank.cu TILE: 256 threads x 16)
LIMIT_TILE = 4096
#: most rows K27 takes: its status words hold 31-bit counts
LIMIT_MAX_ROWS = (1 << 31) - 1
#: K27's look-back epochs are 30 bits; 0 is the zeroed words' epoch
_LIMIT_EPOCHS = 1 << 30
#: K27's scratch per (device, stream): [its ticket counter (the
#: kernel leaves it at 0), the status words of as many tiles as the
#: largest call had so far, the last epoch handed out]
_LIMIT_SCRATCH: dict = {}
#: held around a call's epoch and launch: host threads that share a
#: stream (a worker's tasks) would otherwise race on the epoch
_LIMIT_LOCK = threading.Lock()


def limit_tiles(rows: int) -> int:
    """K27's tiles (one block each) for `rows` rows."""
    return -(-rows // LIMIT_TILE)


def _limit_scratch(dev, stream: int, tiles: int):
    """K27's scratch for a call of `tiles` tiles on `stream`, with the
    call's epoch taken: [ticket, status, epoch]. A larger status array
    replaces a smaller one (zeroed words carry epoch 0, which no call
    takes); when the epochs wrap the words are zeroed again."""
    hit = _LIMIT_SCRATCH.get((dev, stream))
    if hit is None:
        hit = [torch.zeros(1, dtype=torch.int64, device=dev), None, 0]
        _LIMIT_SCRATCH[(dev, stream)] = hit
    if hit[1] is None or hit[1].shape[0] < tiles:
        hit[1] = torch.zeros(tiles, dtype=torch.int64, device=dev)
    hit[2] += 1
    if hit[2] == _LIMIT_EPOCHS:
        hit[1].zero_()
        hit[2] = 1
    return hit


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
    if rows > LIMIT_MAX_ROWS:
        raise ValueError(f"limit_rank: {rows} rows; its counts hold at most "
                         f"{LIMIT_MAX_ROWS}")
    # one allocation: the count in word 0, keep from byte 16 (16-byte
    # aligned)
    buf = torch.empty(2 + -(-rows // 8), dtype=torch.int64, device=dev)
    out = buf[0]
    keep = buf.view(torch.bool)[16:16 + rows]
    if rows == 0:
        out.copy_(emitted.reshape(()))
        return keep, out
    lib = cuda.library("limit_rank")
    stream = cuda.stream_ptr(dev)
    with _LIMIT_LOCK:
        ticket, status, epoch = _limit_scratch(dev, stream,
                                               limit_tiles(rows))
        code = lib.presto_limit_rank(
            row_valid.data_ptr(), rows, int(n), emitted.data_ptr(),
            keep.data_ptr(), out.data_ptr(), ticket.data_ptr(),
            status.data_ptr(), epoch, stream)
    cuda.check(lib, code, "limit_rank")
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
