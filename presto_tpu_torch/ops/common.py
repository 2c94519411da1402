"""Shared kernel utilities (reference: presto_tpu/ops/common.py):
null-aware multi-key ordering and group boundaries. The row hashes
(`hash64`, `row_hash`) come with the join slice of the port.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

CVal = Tuple[torch.Tensor, torch.Tensor]


def partition_perm(valid: torch.Tensor) -> torch.Tensor:
    """Stable valid-rows-first permutation (argsort(~valid, stable)),
    built from two cumsums and one scatter."""
    n = valid.shape[0]
    v = valid.to(torch.int64)
    nv = v.sum()
    pos = torch.where(valid, torch.cumsum(v, 0) - 1,
                      nv + torch.cumsum(1 - v, 0) - 1)
    perm = torch.empty(n, dtype=torch.int64, device=valid.device)
    perm[pos] = torch.arange(n, device=valid.device)
    return perm


def _negate_for_desc(key: torch.Tensor) -> torch.Tensor:
    if key.dtype == torch.bool:
        return ~key
    if key.dtype == torch.float32:
        return -key.to(torch.float64)
    return -key


def _stable_order(sort_ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic permutation over `sort_ops` (most
    significant first): stable passes from the least significant key
    up, as ops/common.lex_order does in the reference."""
    n = sort_ops[0].shape[0]
    perm = torch.arange(n, device=sort_ops[0].device)
    for key in reversed(list(sort_ops)):
        k = key[perm]
        if k.dtype == torch.bool:
            k = k.to(torch.uint8)
        order = torch.sort(k, stable=True).indices
        perm = perm[order]
    return perm


def sort_rows(keys: Sequence[CVal],
              descending: Optional[Sequence[bool]] = None,
              nulls_first: Optional[Sequence[bool]] = None,
              valid: Optional[torch.Tensor] = None,
              payloads: Sequence[torch.Tensor] = ()):
    """Lexicographic sort carrying payloads. Sort operands per key are
    (null_rank, canonical_value) so SQL null ordering and NULL==NULL
    grouping hold; `valid=False` rows sort to the end. Returns
    (sorted_keys, sorted_valid, sorted_payloads)."""
    desc = descending or [False] * len(keys)
    nf = nulls_first or [False] * len(keys)
    sort_ops: List[torch.Tensor] = []
    if valid is not None:
        sort_ops.append(~valid)
    for (data, mask), d, nfirst in zip(keys, desc, nf):
        sort_ops.append(mask if nfirst else ~mask)
        sv = _negate_for_desc(data) if d else data
        sort_ops.append(torch.where(mask, sv, torch.zeros_like(sv)))
    if not sort_ops:
        return list(keys), valid, list(payloads)
    perm = _stable_order(sort_ops)
    skeys = [(d[perm], m[perm]) for d, m in keys]
    svalid = None if valid is None else valid[perm]
    return skeys, svalid, [p[perm] for p in payloads]


def boundaries(sorted_keys: Sequence[CVal],
               sorted_valid: torch.Tensor) -> torch.Tensor:
    """True where a new group starts (first valid row or key change),
    over rows already in group order. NULLs compare equal for
    grouping."""
    n = sorted_valid.shape[0]
    change = torch.zeros(n, dtype=torch.bool, device=sorted_valid.device)
    change[0] = True
    for data, mask in sorted_keys:
        prev_d = torch.roll(data, 1)
        prev_m = torch.roll(mask, 1)
        differs = (data != prev_d) | (mask != prev_m)
        differs = differs & ~(~mask & ~prev_m)
        change = change | differs
    prev_valid = torch.roll(sorted_valid, 1)
    prev_valid[0] = False
    return sorted_valid & (change | ~prev_valid)
