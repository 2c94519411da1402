"""The port's hash-repartition wave against the JAX package's, over the
same seeded numpy inputs.

The reference's `wave_repartition` runs its shard_map program (hash,
bucketize, tiled all_to_all, pack) on the 8-virtual-device CPU mesh;
the port's runs K18's plain version on the CPU. Each consumer's batch
must match exactly and in row order: capacity, row_valid, every
column's data and mask, dead padding included. The cases cover NULL
keys, VARCHAR keys re-encoded for routing only, 9 and 17 key columns,
a producer with no batch (the reference pads it with an all-dead
batch, the port passes None), waves whose rows are all dead, W = 3 and
W = 8, every column type, the destination of an INT64_MIN hash, and a
wave with an absorbed filter/project chain. The kernel itself is held
against the plain version in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu import batch as jb
from presto_tpu import types as jt
from presto_tpu.parallel import make_mesh as j_make_mesh
from presto_tpu.parallel import shuffle as jsh

from presto_tpu_torch import batch as tb
from presto_tpu_torch import types as tt
from presto_tpu_torch.parallel import make_mesh
from presto_tpu_torch.parallel.shuffle import (
    broadcast_batch, hash_repartition, shard_batch, unshard_batch,
)
from presto_tpu_torch.parallel import shuffle as tsh

torch.set_num_threads(1)

INT64_MIN = np.iinfo(np.int64).min

#: (name, type name, numpy dtype) of the payload columns
_COLS = [("b", "bigint", np.int64), ("i", "integer", np.int32),
         ("s", "smallint", np.int16), ("t", "tinyint", np.int8),
         ("d", "double", np.float64), ("r", "real", np.float32),
         ("f", "boolean", np.bool_), ("dt", "date", np.int32)]
_WORDS = ("asia", "europe", "africa", "america", "oceania")


def _col_values(rng, dtype, n):
    if dtype == np.bool_:
        return rng.random(n) < 0.5
    if np.issubdtype(dtype, np.floating):
        return rng.normal(size=n).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -1000), min(info.max, 1000), n,
                        dtype=dtype)


def _producer(rng, n, cap, nkeys, dead=0.2, null=0.1, varchar_dic=None):
    """Numpy columns of one producer batch: `nkeys` int64 keys (a
    VARCHAR key of dictionary `varchar_dic` first when given), every
    payload type, NULLs and dead rows."""
    cols = {}
    if varchar_dic is not None:
        codes = np.zeros(cap, np.int32)
        codes[:n] = rng.integers(0, len(varchar_dic), n)
        cols["v"] = ("varchar", codes, rng.random(cap) >= null,
                     varchar_dic)
    for j in range(nkeys):
        d = np.zeros(cap, np.int64)
        d[:n] = rng.integers(-50, 50, n)
        cols[f"k{j}"] = ("bigint", d, rng.random(cap) >= null, None)
    for name, typ, dtype in _COLS:
        d = np.zeros(cap, dtype)
        d[:n] = _col_values(rng, dtype, n)
        cols[name] = (typ, d, rng.random(cap) >= null, None)
    rv = np.zeros(cap, bool)
    rv[:n] = rng.random(n) >= dead
    return cols, rv


def _jax_batch(cols, rv):
    return jb.Batch({
        n: jb.Column(jnp.asarray(d), jnp.asarray(m), jt.Type(t), dic)
        for n, (t, d, m, dic) in cols.items()}, jnp.asarray(rv))


def _torch_batch(cols, rv):
    return tb.Batch({
        n: tb.Column(torch.from_numpy(d.copy()), torch.from_numpy(m.copy()),
                     tt.Type(t), dic)
        for n, (t, d, m, dic) in cols.items()}, torch.from_numpy(rv.copy()))


def _dead_like(cols, cap):
    return ({n: (t, np.zeros(cap, d.dtype), np.zeros(cap, bool), dic)
             for n, (t, d, m, dic) in cols.items()}, np.zeros(cap, bool))


def _assert_same_consumers(got, want):
    assert len(got) == len(want)
    for c, (g, w) in enumerate(zip(got, want)):
        assert g.capacity == w.capacity, c
        assert g.names == w.names
        np.testing.assert_array_equal(g.row_valid.numpy(),
                                      np.asarray(w.row_valid))
        for n in w.names:
            np.testing.assert_array_equal(
                g.columns[n].data.numpy(),
                np.asarray(w.columns[n].data), err_msg=f"{c}/{n}")
            np.testing.assert_array_equal(
                g.columns[n].mask.numpy(),
                np.asarray(w.columns[n].mask), err_msg=f"{c}/{n} mask")
            assert g.columns[n].dictionary == w.columns[n].dictionary


def _run_both(w, producers, key_names, remap=None):
    """producers: (cols, rv) or None per worker."""
    cap = max(rv.shape[0] for p in producers if p is not None
              for rv in [p[1]])
    template = next(p for p in producers if p is not None)[0]
    jbatches, tbatches = [], []
    for p in producers:
        if p is None:
            jbatches.append(_jax_batch(*_dead_like(template, cap)))
            tbatches.append(None)
        else:
            jbatches.append(_jax_batch(*p))
            tbatches.append(_torch_batch(*p))
    jremaps = tremaps = None
    if remap is not None:
        jremaps = [jnp.asarray(r) if r is not None else None for r in remap]
        tremaps = [torch.from_numpy(r) if r is not None else None
                   for r in remap]
    want, wcounts = jsh.wave_repartition(j_make_mesh(w), jbatches,
                                         key_names, key_remaps=jremaps,
                                         return_counts=True)
    got, gcounts = tsh.wave_repartition(make_mesh(w, "cpu"), tbatches,
                                        key_names, key_remaps=tremaps,
                                        return_counts=True)
    assert list(gcounts) == [int(x) for x in np.asarray(wcounts)]
    _assert_same_consumers(got, want)
    return got


@pytest.mark.parametrize("w", [3, 8])
@pytest.mark.parametrize("nkeys", [1, 2, 9, 17])
def test_plain_wave_matches_reference(eight_devices, w, nkeys):
    rng = np.random.default_rng(100 + 10 * w + nkeys)
    producers = [_producer(rng, int(rng.integers(100, 4000)), 4096, nkeys)
                 for _ in range(w)]
    got = _run_both(w, producers, [f"k{j}" for j in range(nkeys)])
    assert sum(int(b.row_valid.sum()) for b in got) == \
        sum(int(rv.sum()) for _, rv in producers)


@pytest.mark.parametrize("w", [3, 8])
def test_wave_with_a_producer_without_batch(eight_devices, w):
    rng = np.random.default_rng(7 + w)
    producers = [_producer(rng, 3000, 4096, 2) for _ in range(w)]
    producers[1] = None
    producers[w - 1] = None
    _run_both(w, producers, ["k0", "k1"])


def test_wave_of_dead_rows(eight_devices):
    rng = np.random.default_rng(11)
    producers = [_producer(rng, 500, 4096, 1, dead=1.0) for _ in range(8)]
    got = _run_both(8, producers, ["k0"])
    assert all(int(b.row_valid.sum()) == 0 for b in got)


def test_wave_with_mixed_capacities_and_larger_batches(eight_devices):
    rng = np.random.default_rng(12)
    producers = [_producer(rng, 9000, 16384, 1),
                 _producer(rng, 100, 4096, 1), None]
    _run_both(3, producers, ["k0"])


@pytest.mark.parametrize("w", [3, 8])
def test_wave_with_varchar_key_remap(eight_devices, w):
    """Producers carry different dictionaries; the remap onto the
    unified one routes equal strings alike, and the payload keeps each
    producer's codes."""
    rng = np.random.default_rng(21 + w)
    unified = tuple(sorted(_WORDS))
    dic = _WORDS[:4]
    remap = [np.array([unified.index(x) for x in dic], np.int32), None]
    producers = [_producer(rng, 2000, 4096, 1, varchar_dic=dic)
                 for _ in range(w)]
    _run_both(w, producers, ["v", "k0"], remap=remap)


def test_dest_of_int64_min_hash():
    """|INT64_MIN| is INT64_MIN; the floored remainder still lands it in
    [0, W), as jnp's `%` does."""
    h = np.array([INT64_MIN, INT64_MIN + 1, -1, 0, 7, np.iinfo(np.int64).max],
                 np.int64)
    for w in (3, 5, 8):
        want = np.asarray(jnp.abs(jnp.asarray(h)) % w)
        got = tsh.partition_dest(torch.from_numpy(h), w).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0 and got.max() < w


def test_plain_shuffle_routes_an_injected_int64_min_hash():
    """K18's plain version given raw hashes (as the kernel is): an
    INT64_MIN hash goes to floored(INT64_MIN mod W)."""
    h = torch.tensor([INT64_MIN, 5, INT64_MIN, -4], dtype=torch.int64)
    rv = torch.tensor([True, True, True, False])
    data = torch.arange(4, dtype=torch.int64)
    outs, counts = tsh.wave_shuffle_plain(
        [(h, rv, [(data, rv.clone())])], 3, 4096, [torch.int64])
    dest = int(np.asarray(jnp.abs(jnp.int64(INT64_MIN)) % 3))
    assert dest == INT64_MIN % 3 == 1
    assert counts == [0, 2, 1]
    (data_out, _), = outs[dest][0]
    assert data_out[:2].tolist() == [0, 2]
    assert outs[2][0][0][0][:1].tolist() == [1]


def _chain_stages(pkg):
    """`x < 0.5`-filtered projection (x, y * 2) in each package."""
    if pkg == "jax":
        from presto_tpu.expr import ir
        from presto_tpu.expr.compile import compile_expression
        from presto_tpu.operators.fused_fragment import ChainStage
        from presto_tpu.schema import ColumnSchema
        T = jt
        comp = compile_expression
        extra = ()
    else:
        from presto_tpu_torch.expr import ir
        from presto_tpu_torch.expr.compile import compile_expression
        from presto_tpu_torch.operators.fused_fragment import ChainStage
        from presto_tpu_torch.schema import ColumnSchema
        T = tt

        def comp(e, s):
            return compile_expression(e, s, torch.device("cpu"))
    schema = {"k": ColumnSchema("k", T.BIGINT),
              "x": ColumnSchema("x", T.DOUBLE)}
    filt = comp(ir.call("less_than", T.BOOLEAN, ir.ref("x", T.DOUBLE),
                        ir.lit(0.5, T.DOUBLE)), schema)
    proj = (("k", comp(ir.ref("k", T.BIGINT), schema)),
            ("x2", comp(ir.call("multiply", T.DOUBLE,
                                ir.ref("x", T.DOUBLE),
                                ir.lit(2.0, T.DOUBLE)), schema)))
    return (ChainStage(filt, proj, None),)


@pytest.mark.parametrize("w", [3, 8])
def test_chained_wave_matches_reference(eight_devices, w):
    from presto_tpu.operators.fused_fragment import chain_fingerprint as jfp
    from presto_tpu_torch.operators.fused_fragment import (
        chain_fingerprint as tfp,
    )
    rng = np.random.default_rng(31 + w)
    producers = []
    for p in range(w):
        n = int(rng.integers(200, 3000))
        k = np.zeros(4096, np.int64)
        k[:n] = rng.integers(-30, 30, n)
        x = np.zeros(4096, np.float64)
        x[:n] = rng.random(n)
        rv = np.zeros(4096, bool)
        rv[:n] = rng.random(n) > 0.1
        cols = {"k": ("bigint", k, rng.random(4096) > 0.1, None),
                "x": ("double", x, np.ones(4096, bool), None)}
        producers.append((cols, rv) if p != 1 else None)
    js, ts = _chain_stages("jax"), _chain_stages("torch")
    jchain = jsh.WaveChain(js, jfp(js), "fused[filter_project+all_to_all]")
    tchain = tsh.WaveChain(ts, tfp(ts), "fused[filter_project+all_to_all]")
    template = producers[0][0]
    jbatches = [_jax_batch(*p) if p is not None
                else _jax_batch(*_dead_like(template, 4096))
                for p in producers]
    tbatches = [_torch_batch(*p) if p is not None else None
                for p in producers]
    want, wc = jsh.wave_repartition(j_make_mesh(w), jbatches, ["k"],
                                    chain=jchain, return_counts=True)
    got, gc = tsh.wave_repartition(make_mesh(w, "cpu"), tbatches, ["k"],
                                   chain=tchain, return_counts=True)
    assert list(gc) == [int(x) for x in np.asarray(wc)]
    _assert_same_consumers(got, want)


def test_whole_batch_helpers():
    mesh = make_mesh(8, "cpu")
    rng = np.random.default_rng(3)
    cols, rv = _producer(rng, 300, 512, 1, dead=0.0)
    b = _torch_batch(cols, rv)
    sb = shard_batch(b, mesh)
    assert len(sb.batches) == 8
    back = unshard_batch(sb)
    key = str
    assert sorted(back.to_pylist(), key=key) == sorted(b.to_pylist(), key=key)
    out = hash_repartition(sb, ["k0"])
    assert sorted(unshard_batch(out).to_pylist(), key=key) == \
        sorted(b.to_pylist(), key=key)
    owners = {}
    for wi, part in enumerate(out.batches):
        d = part.to_pydict()
        for k in d["k0"]:
            assert owners.setdefault(k, wi) == wi
    assert all(x is b for x in broadcast_batch(b, mesh))


def test_batch_row_bytes_matches_reference():
    rng = np.random.default_rng(4)
    cols, rv = _producer(rng, 10, 4096, 2)
    assert tsh.batch_row_bytes(_torch_batch(cols, rv)) == \
        jsh.batch_row_bytes(_jax_batch(cols, rv))
