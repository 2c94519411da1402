"""Ordering kernels (reference: presto_tpu/ops/sort.py; OrderByOperator.java:44,
TopNOperator.java:35, LimitOperator).

Full sort runs one lexicographic sort over an accumulated batch; TopN
keeps a bounded running state (state ++ batch -> sort -> first N);
LIMIT keeps the first rows of each batch against a running count that
stays on the device. All three are composed torch ops (stable sort
passes, gathers, a cumsum), as the ROADMAP plans for them.
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
    """Reorder rows into key order, invalid rows compacted to the end."""
    _tk.count("sort")
    return _sort_batch_impl(batch, key_names, descending, nulls_first)


def _sort_batch_impl(batch: Batch, key_names: Tuple[str, ...],
                     descending: Tuple[bool, ...],
                     nulls_first: Tuple[bool, ...]) -> Batch:
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
    """Fold step: keep the N smallest (per ordering) of state ++ batch.
    `state` has capacity >= n; the output reuses that capacity."""
    _tk.count("topn")
    cap = state.capacity
    merged_cols = {}
    for name, sc in state.columns.items():
        bc = batch.columns[name]
        merged_cols[name] = Column(
            torch.cat([sc.data, bc.data.to(sc.data.dtype)]),
            torch.cat([sc.mask, bc.mask]), sc.type, sc.dictionary)
    merged = Batch(merged_cols,
                   torch.cat([state.row_valid, batch.row_valid]))
    s = _sort_batch_impl(merged, key_names, descending, nulls_first)
    keep = torch.arange(merged.capacity, device=merged.device) < n
    live = s.row_valid & keep
    cols = {n_: Column(c.data[:cap], c.mask[:cap] & live[:cap], c.type,
                       c.dictionary)
            for n_, c in s.columns.items()}
    return Batch(cols, live[:cap])


def limit_batch(batch: Batch, n: int, already_emitted: torch.Tensor
                ) -> Batch:
    """Keep the first (n - already_emitted) live rows of this batch;
    `already_emitted` is a device scalar, so no host read."""
    _tk.count("limit")
    rank = torch.cumsum(batch.row_valid.to(torch.int64), 0) - 1
    keep = batch.row_valid & (rank < (n - already_emitted))
    return Batch(batch.columns, keep)
