"""The CUDA wrappers' host path on the CPU: `common.key_group_args` and
`common.key_args` build the key tables every hashing kernel takes (K3,
K5-K9, K12, K20) with the dtype codes shared per key signature, and a
`BuildTable` checks its arrays once, when it is made, so K5 and K7 do
not check them on every probe."""

import ctypes

import numpy as np
import pytest
import torch

from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.ops import common as tc
from presto_tpu_torch.ops import join as tj
from presto_tpu_torch.types import BIGINT

CPU = torch.device("cpu")
DTYPES = [torch.int64, torch.float64, torch.int32, torch.int16, torch.int8,
          torch.float32, torch.bool]


def _keys(n, count, seed=0):
    rng = np.random.default_rng(seed)
    keys = []
    for j in range(count):
        dt = DTYPES[j % len(DTYPES)]
        d = torch.from_numpy(rng.integers(-50, 50, n)).to(dt)
        keys.append((d, torch.from_numpy(rng.random(n) > 0.1)))
    return keys


@pytest.mark.parametrize("count", [1, 3, 6, tc.MAX_KEYS, tc.MAX_KEYS + 1,
                                   2 * tc.MAX_KEYS + 3])
def test_key_group_args_pass_the_keys_flat(count):
    """Pointers, masks and dtype codes flat in key order, with the
    count; no descriptor below MAX_KEY_GROUPS groups."""
    n = 97
    keys = _keys(n, count)
    kd, km, kt, nk, desc = tc.key_group_args(keys, n, CPU, "probe")
    assert list(kd) == [d.data_ptr() for d, _ in keys]
    assert list(km) == [m.data_ptr() for _, m in keys]
    assert list(kt) == [tc.KEY_DTYPES[d.dtype] for d, _ in keys]
    assert nk.value == count and desc is None


def test_key_group_args_share_the_codes_of_a_signature():
    """Two batches with the keys' dtypes in common share one dtype-code
    array (built once); their pointers are each batch's own."""
    a, b = _keys(64, 3, 1), _keys(64, 3, 2)
    ga, gb = (tc.key_group_args(k, 64, CPU, "probe") for k in (a, b))
    assert ga[2] is gb[2]
    assert list(ga[0]) == [d.data_ptr() for d, _ in a]
    assert list(gb[0]) == [d.data_ptr() for d, _ in b]
    other = tc.key_group_args(_keys(64, 2, 3), 64, CPU, "probe")
    assert other[2] is not ga[2]


def test_key_args_share_the_codes_of_a_signature():
    """`key_args` pads its tables to MAX_KEYS and shares the padded
    codes the same way."""
    a, b = _keys(50, 4, 5), _keys(50, 4, 6)
    ka, kb = (tc.key_args(k, 50, CPU, "row_hash") for k in (a, b))
    assert ka[2] is kb[2] and len(ka[2]) == tc.MAX_KEYS
    assert list(ka[2]) == [tc.KEY_DTYPES[d.dtype] for d, _ in a] + [0] * 4
    assert list(kb[0])[:4] == [d.data_ptr() for d, _ in b]
    assert ka[3].value == 4


@pytest.mark.parametrize("bad", ["strided", "short", "mask_dtype",
                                 "key_dtype"])
def test_key_group_args_reject_a_key_the_kernel_cannot_read(bad):
    """A key the kernel cannot read raises, before any table is built,
    in one group and past it."""
    n = 40
    d, m = _keys(n, 1)[0]
    if bad == "strided":
        d = torch.arange(2 * n)[::2]
    elif bad == "short":
        d = d[:-1]
    elif bad == "mask_dtype":
        m = m.to(torch.int8)
    else:
        d = d.to(torch.complex64)
    with pytest.raises(ValueError, match="probe"):
        tc.key_group_args([(d, m)], n, CPU, "probe")
    with pytest.raises(ValueError, match="probe"):
        tc.key_group_args(_keys(n, tc.MAX_KEYS) + [(d, m)], n, CPU, "probe")


def _table(nb=64, k=4, **bad):
    arrays = {"sorted_hash": torch.zeros(nb, dtype=torch.int64),
              "hash2": torch.zeros(nb, dtype=torch.int64),
              "part_starts": torch.zeros((1 << k) + 1 if k else 2,
                                         dtype=torch.int64),
              "run_len": torch.zeros(nb, dtype=torch.int64)}
    arrays.update(bad)
    b = Batch({"k": Column(torch.zeros(nb, dtype=torch.int64),
                           torch.ones(nb, dtype=torch.bool), BIGINT)},
              torch.ones(nb, dtype=torch.bool))
    return tj.BuildTable(arrays["sorted_hash"], arrays["hash2"],
                         arrays["part_starts"], arrays["run_len"],
                         torch.tensor(nb), b, radix_bits=k)


@pytest.mark.parametrize("bad", [
    {"hash2": torch.zeros(63, dtype=torch.int64)},
    {"run_len": torch.zeros(64, dtype=torch.int32)},
    {"part_starts": torch.zeros(16, dtype=torch.int64)},
    {"sorted_hash": torch.zeros(128, dtype=torch.int64)[::2]},
], ids=["hash2_rows", "run_len_dtype", "part_starts_for_k", "strided"])
def test_build_table_checks_its_arrays_once_made(bad):
    """The arrays K5 and K7 read as they lie are checked when the table
    is made, so no probe checks them again."""
    _table()
    _table(k=0)
    with pytest.raises(ValueError, match="BuildTable"):
        _table(**bad)


def test_probe_search_plain_and_wrapper_agree_without_table_checks():
    """A table made by build_for_backend passes its own check, and the
    probe's plain version runs on it as before."""
    n = 300
    rng = np.random.default_rng(4)
    keys = torch.from_numpy(rng.integers(0, 50, n))
    b = Batch({"k": Column(keys, torch.ones(n, dtype=torch.bool), BIGINT)},
              torch.ones(n, dtype=torch.bool))
    table = tj.build_for_backend(b, ("k",))
    lo, h2 = tj.probe_search(table, b, ("k",), "full")
    assert bool((lo >= 0).all()) and h2 is not None
    assert isinstance(tc._dtype_codes((torch.int64,), 1), ctypes.Array)
