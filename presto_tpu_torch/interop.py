"""Build the port's data structures from plain numpy arrays.

The JAX package's batches and aggregation states reach the port only
as numpy arrays (a test converts them; this package never touches a JAX
object), so the two packages can be fed the same inputs and their
outputs compared.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.ops.hashagg import DirectState, GroupByState
from presto_tpu_torch.types import parse_type


def batch_from_numpy(columns: Dict[str, Tuple[np.ndarray, np.ndarray, str,
                                               Optional[Tuple[str, ...]]]],
                     row_valid: np.ndarray,
                     device: torch.device) -> Batch:
    """`columns`: name -> (data, mask, type name, dictionary), every
    array of the batch's capacity. Arrays are copied as they are,
    dead lanes included."""
    cols = {}
    for name, (data, mask, type_name, dictionary) in columns.items():
        typ = parse_type(type_name)
        cols[name] = Column(
            torch.from_numpy(np.array(data, dtype=typ.np_dtype)).to(device),
            torch.from_numpy(np.array(mask, dtype=bool)).to(device),
            typ, dictionary)
    return Batch(cols, torch.from_numpy(np.array(row_valid, dtype=bool))
                 .to(device))


def direct_state_from_numpy(states: Sequence[Sequence[np.ndarray]],
                            present: np.ndarray,
                            device: torch.device) -> DirectState:
    """`states`: per aggregate, its state component arrays (one entry
    per slot); `present`: bool per slot."""
    return DirectState(
        [tuple(torch.from_numpy(np.array(a)).to(device) for a in st)
         for st in states],
        torch.from_numpy(np.array(present, dtype=bool)).to(device))


def group_state_from_numpy(keys: Sequence[Tuple[np.ndarray, np.ndarray]],
                           states: Sequence[Sequence[np.ndarray]],
                           valid: np.ndarray, overflow: bool,
                           device: torch.device) -> GroupByState:
    """A packed sort-path state: `keys` as (data, mask) per key column,
    `states` per aggregate its state component arrays (a vector
    component [slots, K]), `valid` bool per slot (live slots first).
    The live count it carries is valid's count."""
    def t(a, dtype=None):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(device)
    v = np.array(valid, dtype=bool)
    return GroupByState(
        [(t(d), t(m, bool)) for d, m in keys],
        [tuple(t(a) for a in st) for st in states], t(v),
        torch.tensor(bool(overflow), device=device),
        torch.tensor(int(v.sum()), dtype=torch.int64, device=device))
