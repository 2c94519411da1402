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
on the device. DISTINCT folds state ++ batch through K33
(csrc/distinct_set.cu): one hash-set insert of every live row and an
append of each group's first row, so the state's rows stay where they
lie and no row is sorted. On CPU tensors every step is its plain
version.
"""

from __future__ import annotations

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
def limit_tiles(rows: int) -> int:
    """K27's tiles (one block each) for `rows` rows."""
    return -(-rows // LIMIT_TILE)


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
    with common.LOOKBACK_LOCK:
        ticket, status, epoch = common.lookback_scratch(dev, stream,
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


#: launches of K33, DISTINCT's hash-set fold (csrc/distinct_set.cu)
DISTINCT_SET_KERNEL = _tk.LaunchCounter("distinct_set", "distinct")
#: most rows of state ++ batch K33 takes: its row ids are 32-bit
DISTINCT_MAX_ROWS = (1 << 31) - 1
#: rows (and output slots) of one K33 tile (csrc/distinct_set.cu TILE)
DISTINCT_TILE = 1024
#: K33's tables per (device, stream): [the words, as many as the
#: largest call so far, all empty between calls (each word's owner
#: empties it); each row's word]
_DISTINCT_SCRATCH: dict = {}


def distinct_table_words(rows: int) -> int:
    """K33's table words for `rows` rows of state ++ batch: the power of
    two at least twice the rows (at least 1024)."""
    return max(1024, 1 << max(0, 2 * rows - 1).bit_length())


def _distinct_keys(state: Batch, batch: Batch):
    """The key columns of state and batch (every column; the batch's
    data in the state's dtypes)."""
    keys = [(state.columns[n].data.contiguous(),
             state.columns[n].mask.contiguous()) for n in state.names]
    bkeys = [(batch.columns[n].data.to(d.dtype).contiguous(),
              batch.columns[n].mask.contiguous())
             for n, (d, _) in zip(state.names, keys)]
    return keys, bkeys


def distinct_layout(state: Batch, cap: int):
    """The output allocation of K33 (csrc/distinct_set.cu): each
    column's data in key order at a 16-byte aligned offset, then each
    column's mask, then row_valid. Returns (bytes, [(data offset, mask
    offset)] per column, row_valid's offset)."""
    r16 = lambda x: (x + 15) & ~15
    offs, off = [], 0
    for n in state.names:
        offs.append(off)
        off += r16(cap * state.columns[n].data.element_size())
    step = r16(cap)
    cols = [(d, off + i * step) for i, d in enumerate(offs)]
    return off + (len(offs) + 1) * step, cols, off + len(offs) * step


def _distinct_scratch(dev, stream: int, words: int, rows: int):
    hit = _DISTINCT_SCRATCH.get((dev, stream))
    if hit is None:
        hit = [None, None]
        _DISTINCT_SCRATCH[(dev, stream)] = hit
    if hit[0] is None or hit[0].shape[0] < words:
        hit[0] = torch.full((words,), -1, dtype=torch.int64, device=dev)
    if hit[1] is None or hit[1].shape[0] < rows:
        hit[1] = torch.empty(max(rows, 1), dtype=torch.int64, device=dev)
    return hit


def _distinct_set_cuda(state: Batch, batch: Batch) -> Batch:
    """K33 on the card: the kernel hashes the keys and each word's owner
    empties it again, so the cached table is empty between calls."""
    from presto_tpu_torch.native import cuda
    S, B, cap = state.capacity, batch.capacity, state.capacity
    rows = S + B
    if rows > DISTINCT_MAX_ROWS:
        raise ValueError(f"distinct_set: {rows} rows of state ++ batch; its "
                         f"row ids hold at most {DISTINCT_MAX_ROWS}")
    dev = state.row_valid.device
    keys, bkeys = _distinct_keys(state, batch)
    sk = common.key_group_args(keys, S, dev, "distinct_set: state keys")
    bk = common.key_group_args(bkeys, B, dev, "distinct_set: batch keys")
    common.check_rows(state.row_valid, S, dev, (torch.bool,),
                      "distinct_set: the state's row_valid")
    common.check_rows(batch.row_valid, B, dev, (torch.bool,),
                      "distinct_set: the batch's row_valid")
    size, col_offs, valid_off = distinct_layout(state, cap)
    buf = torch.empty(size, dtype=torch.uint8, device=dev)
    lib = cuda.library("distinct_set")
    stream = cuda.stream_ptr(dev)
    words = distinct_table_words(rows)
    tiles = -(-rows // DISTINCT_TILE) + -(-cap // DISTINCT_TILE)
    with common.LOOKBACK_LOCK:
        table, slots = _distinct_scratch(dev, stream, words, rows)
        ticket, status, epoch = common.lookback_scratch(dev, stream, tiles)
        code = lib.presto_distinct_set(
            sk[0], sk[1], bk[0], bk[1], sk[2], sk[3],
            state.row_valid.data_ptr(), S, batch.row_valid.data_ptr(), B,
            table.data_ptr(), words, slots.data_ptr(), buf.data_ptr(), cap,
            ticket.data_ptr(), status.data_ptr(), epoch, stream)
    cuda.check(lib, code, "distinct_set")
    DISTINCT_SET_KERNEL.launches += 1
    cols = {}
    for name, (doff, moff) in zip(state.names, col_offs):
        c = state.columns[name]
        dt = c.data.dtype
        w = c.data.element_size()
        cols[name] = Column(buf[doff:doff + cap * w].view(dt),
                            buf[moff:moff + cap].view(torch.bool), c.type,
                            c.dictionary)
    return Batch(cols, buf[valid_off:valid_off + cap].view(torch.bool))


def distinct_step(state: Batch, batch: Batch) -> Batch:
    """Fold step for SELECT DISTINCT and the dedup of UNION (the
    reference's `_distinct_step_impl`, presto_tpu/ops/sort.py:106):
    keep the first row of every group of state ++ batch, in that order,
    in a state of `state.capacity` slots. The state's live rows are a
    prefix of its slots and stay where they lie; the batch's new rows
    follow in batch order. Groups beyond the capacity are dropped (the
    state reads full and the operator grows it). K33 on CUDA tensors
    (one hash-set insert and an append, no sort), the plain version on
    CPU tensors."""
    _tk.count("distinct")
    if state.row_valid.device.type == "cpu":
        return distinct_step_plain(state, batch)
    return _distinct_set_cuda(state, batch)


def distinct_owners_plain(keys, valid: torch.Tensor) -> torch.Tensor:
    """Per row of `keys`: live and the first of its group in row order
    (K33's kept rows). Groups are the sort-based grouping's: equal
    (h1, h2) and keys equal under K6's rule (NULL equals NULL, NaN equals
    nothing); rows with a NaN key are groups of their own."""
    n = valid.shape[0]
    h1, h2 = common.row_hash_pair_plain(keys, valid, False)
    perm = common.lex_perm_plain([h1, h2])
    start = torch.ones(n, dtype=torch.bool, device=valid.device)
    if n > 1:
        sv = valid[perm]
        differ = (sv[1:] != sv[:-1]) | (h1[perm][1:] != h1[perm][:-1]) \
            | (h2[perm][1:] != h2[perm][:-1])
        for d, m in keys:
            sd, sm = d[perm], m[perm]
            differ |= (sm[1:] != sm[:-1]) | (sm[1:] & (sd[1:] != sd[:-1]))
        start[1:] = differ
    owner = torch.empty_like(start)
    owner[perm] = start
    return owner & valid


def distinct_step_plain(state: Batch, batch: Batch) -> Batch:
    """Plain version of K33, on any device: the same slots (the first
    row of every group of state ++ batch, in that order, up to the
    state's capacity; dead slots zero with their masks clear)."""
    cap = state.capacity
    keys, bkeys = _distinct_keys(state, batch)
    cat = [(torch.cat([d, bd]), torch.cat([m, bm]))
           for (d, m), (bd, bm) in zip(keys, bkeys)]
    valid = torch.cat([state.row_valid, batch.row_valid])
    owner = distinct_owners_plain(cat, valid)
    pos = torch.cumsum(owner.to(torch.int64), 0) - 1
    keep = owner & (pos < cap)
    dst = pos[keep]
    cols = {}
    for name, (d, m) in zip(state.names, cat):
        data = torch.zeros(cap, dtype=d.dtype, device=d.device)
        mask = torch.zeros(cap, dtype=torch.bool, device=d.device)
        data[dst] = d[keep]
        mask[dst] = m[keep]
        c = state.columns[name]
        cols[name] = Column(data, mask, c.type, c.dictionary)
    out_valid = torch.zeros(cap, dtype=torch.bool, device=valid.device)
    out_valid[dst] = True
    return Batch(cols, out_valid)
