"""K20's plain version (`partition_sort_plain`, reached through
`partition_segments`) against the reference's `partition_segments`
(presto_tpu/operators/exchange_ops.py:79, JAX on the CPU): the same
bounds and, segment by segment, the same live rows in the same order.
Everything is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import batch as rbatch
from presto_tpu import types as rtypes
from presto_tpu.operators import exchange_ops as rex
from presto_tpu_torch import batch as pbatch
from presto_tpu_torch import types as ptypes
from presto_tpu_torch.operators import exchange_ops as pex

WORDS = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")


def _data(n, seed, nulls=False, live=0.8):
    rng = np.random.default_rng(seed)
    arrays = {
        "k1": rng.integers(0, 50, n).astype(np.int64),
        "k2": rng.integers(-3, 3, n).astype(np.int32),
        "k3": rng.normal(0, 10, n).round(1),
        "s": rng.integers(0, 4, n).astype(np.int32),
        "v": rng.integers(0, 10 ** 6, n).astype(np.int64),
    }
    types = {"k1": "bigint", "k2": "integer", "k3": "double",
             "s": "varchar", "v": "bigint"}
    masks = {k: (rng.random(n) > 0.2) if nulls else np.ones(n, bool)
             for k in arrays}
    # the batch's dictionary is a subset of the unified hash dictionary
    dicts = {"s": ("FOB", "MAIL", "SHIP", "TRUCK")}
    rv = rng.random(n) < live
    return arrays, types, masks, dicts, rv


def _pair(arrays, types, masks, dicts, rv):
    ref = rbatch.Batch.from_numpy(
        arrays, {k: rtypes.parse_type(t) for k, t in types.items()},
        masks, dicts)
    port = pbatch.Batch.from_numpy(
        arrays, {k: ptypes.parse_type(t) for k, t in types.items()},
        masks, dicts)
    cap = ref.capacity
    full = np.zeros(cap, bool)
    full[:len(rv)] = rv
    ref = rbatch.Batch(ref.columns, jnp.asarray(full))
    port = pbatch.Batch(port.columns, torch.from_numpy(full))
    return ref, port


def _compare(ref_out, port_out, w):
    rs, rb = ref_out
    ps, pb = port_out
    rb = np.asarray(rb)
    assert pb.dtype == torch.int32
    assert pb.tolist() == rb.tolist()
    live = int(rb[w])
    assert np.asarray(rs.row_valid)[:live].all()
    assert ps.row_valid[:live].all() and not ps.row_valid[live:].any()
    for name in rs.names:
        for part in ("data", "mask"):
            a = np.asarray(getattr(rs.columns[name], part))[:live]
            b = getattr(ps.columns[name], part)[:live].numpy()
            assert np.array_equal(a, b), (name, part)


@pytest.mark.parametrize("w", [1, 2, 3, 8])
@pytest.mark.parametrize("keys", [("k1",), ("k1", "k2", "k3")])
@pytest.mark.parametrize("nulls", [False, True])
def test_matches_reference(w, keys, nulls):
    args = _data(3000, seed=w * 7 + len(keys), nulls=nulls)
    ref, port = _pair(*args)
    _compare(rex.partition_segments(ref, keys, None, w),
             pex.partition_segments(port, keys, None, w), w)


@pytest.mark.parametrize("w", [2, 3, 8])
def test_varchar_keys_through_remaps(w):
    arrays, types, masks, dicts, rv = _data(2000, seed=w, nulls=True)
    ref, port = _pair(arrays, types, masks, dicts, rv)
    hash_dicts = [WORDS, None]
    key_dicts = [dicts["s"], None]
    rr = rex.build_remap_tables(hash_dicts, key_dicts)
    pr = pex.build_remap_tables(hash_dicts, key_dicts, torch.device("cpu"))
    _compare(rex.partition_segments(ref, ("s", "k2"), rr, w),
             pex.partition_segments(port, ("s", "k2"), pr, w), w)


@pytest.mark.parametrize("w", [1, 3, 8])
def test_injected_int64_min_hashes(monkeypatch, w):
    """|INT64_MIN| is INT64_MIN and the remainder is floored: the rows
    hashed to INT64_MIN land where the reference puts them."""
    arrays, types, masks, dicts, rv = _data(1500, seed=11)
    ref, port = _pair(arrays, types, masks, dicts, rv)
    rng = np.random.default_rng(5)
    h = rng.integers(-2 ** 63, 2 ** 63 - 1, ref.capacity, dtype=np.int64)
    h[::7] = np.iinfo(np.int64).min
    h[1::9] = np.iinfo(np.int64).max
    h[2::11] = -1
    monkeypatch.setattr(rex, "partition_key_hash",
                        lambda b, k, r: jnp.abs(jnp.asarray(h)))
    _compare(rex.partition_segments(ref, ("inj%d" % w,), None, w),
             pex.partition_sort(port, torch.from_numpy(h), w), w)


@pytest.mark.parametrize("w", [1, 4])
def test_all_dead_batch(w):
    arrays, types, masks, dicts, rv = _data(700, seed=3, live=0.0)
    ref, port = _pair(arrays, types, masks, dicts, rv)
    _compare(rex.partition_segments(ref, ("k1",), None, w),
             pex.partition_segments(port, ("k1",), None, w), w)
    assert pex.partition_segments(port, ("k1",), None, w)[1].tolist() \
        == [0] * (w + 1)


def test_host_pad_quantized_matches_reference():
    arrays, types, masks, dicts, rv = _data(5000, seed=2)
    ref, port = _pair(arrays, types, masks, dicts, rv)
    import jax
    rh = rex._host_pad_quantized(jax.device_get(ref))
    ph = pex.host_pad_quantized(port)
    assert ph.capacity == rh.capacity == 16384
    assert ph.to_pylist() == rh.to_pylist()
