"""K6 (the sort-based grouping's segment reduce) and K2 (compaction)
on the CPU, at the edge shapes the card tests take at full size.

1. The port's plain `segment_reduce` against the JAX package's pieces
   of `_group_reduce` over the same seeded numpy inputs (its (h1, h2)
   sort, `common.boundaries`, `_sorted_reduce`, `_first_rows`): first
   rows, group count, overflow and integer components exactly, floats
   to a relative 1e-9 (`index_add_` and `segment_sum` may add in
   another order). The port's plain `compact_full` / `compact_shrink`
   against `_compact_jit` / `_compact_shrink_jit` exactly (the order
   is the result).
2. The CUDA wrappers' host side: `_segment_reduce_launch` and
   `_compact_cuda` run against Python twins of their C entry points,
   which read the wrapper's descriptor from host memory, the inputs
   through its pointers, compute the plain version and write through
   its output pointers; the wrapper's views of its one allocation must
   then equal the plain version. So the descriptor layout, the output
   offsets and the scratch a call takes are checked here; the kernels
   themselves are held against the plain versions in
   tests/test_torch_cuda.py on an sm_90 card.
"""

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from presto_tpu import batch as jb
from presto_tpu.ops import common as jc
from presto_tpu.ops import hashagg as jh

from presto_tpu_torch import batch as tb
from presto_tpu_torch import interop
from presto_tpu_torch.native import cuda
from presto_tpu_torch.ops import common as tc
from presto_tpu_torch.ops import hashagg as th

FLOAT_RTOL = 1e-9
N = 3000

torch.set_num_threads(1)


# -- K6 inputs ---------------------------------------------------------

def _k6_keys(rng, n, shape):
    """Key columns (numpy data, mask) of one edge shape."""
    nulls = rng.random(n) < 0.95
    kv = rng.integers(0, 200, n)
    if shape == "one_group":
        kv, nulls = np.zeros(n, np.int64), np.ones(n, bool)
    elif shape == "long_among_singletons":
        kv = rng.permutation(n).astype(np.int64) + 1
        kv[rng.permutation(n)[:n // 2]] = 0
        nulls = np.ones(n, bool)
    elif shape in ("groups_eq_out_cap", "one_past_out_cap"):
        g = 256 if shape == "groups_eq_out_cap" else 257
        kv, nulls = np.arange(n, dtype=np.int64) % g, np.ones(n, bool)
    keys = [(kv, nulls), ((kv % 7).astype(np.int32), np.ones(n, bool))]
    if shape == "nan_keys":
        keys[1] = (rng.choice(np.array([np.nan, -0.0, 0.0, 1.5]), n),
                   np.ones(n, bool))
    if shape == "nine_keys":
        keys += [((kv % (j + 3)).astype(np.int16), rng.random(n) < 0.9)
                 for j in range(7)]
        # the ninth key alone splits some groups
        keys[8] = (np.where(np.arange(n) % 2 == 0, keys[8][0], -1)
                   .astype(np.int16), keys[8][1])
    return keys


def _k6_comps(rng, n, shape):
    """Contributions (numpy, reduction) of one edge shape."""
    if shape == "wrapping_sums":
        return [(rng.integers(1 << 61, 1 << 62, n), "sum"),
                (rng.integers(1 << 29, 1 << 30, n).astype(np.int32), "sum"),
                (rng.normal(0, 100, n), "sum")]
    if shape == "many_components":
        return [(rng.integers(-99, 99, n), ("sum", "min", "max")[j % 3])
                for j in range(65)]
    return [(rng.normal(0, 100, n), "sum"), (rng.integers(-5, 5, n), "sum"),
            (rng.integers(-9, 9, n).astype(np.int32), "min"),
            (rng.normal(0, 1, n), "max"),
            (rng.normal(0, 1, n).astype(np.float32), "min")]


K6_SHAPES = {  # shape -> (out_cap, live fraction)
    "random": (512, 0.8), "overflow": (64, 0.8), "all_dead": (128, 0.0),
    "one_group": (16, 1.0), "long_among_singletons": (2048, 1.0),
    "groups_eq_out_cap": (256, 1.0), "one_past_out_cap": (256, 1.0),
    "nan_keys": (2048, 0.9), "nine_keys": (2048, 0.9),
    "wrapping_sums": (512, 0.9), "many_components": (512, 0.9)}


def _k6_case(shape, seed=17):
    rng = np.random.default_rng(seed)
    out_cap, live = K6_SHAPES[shape]
    keys = _k6_keys(rng, N, shape)
    valid = rng.random(N) < live
    return keys, valid, _k6_comps(rng, N, shape), out_cap


def _reference_k6(keys, valid, comps, out_cap):
    """The JAX package's sort-based grouping over the rows, up to the
    slots: (perm, reduced, first rows, group count)."""
    jkeys = [(jnp.asarray(d), jnp.asarray(m)) for d, m in keys]
    jvalid = jnp.asarray(valid)
    h1 = jnp.where(jvalid, jc.row_hash(jkeys), jnp.iinfo(jnp.int64).max)
    h2 = jc.row_hash2(jkeys)
    perm = jc.lex_perm([h1, h2])
    skeys = [(d[perm], m[perm]) for d, m in jkeys]
    svalid = jvalid[perm]
    bnd = jc.boundaries(skeys, svalid, hashes=(h1[perm], h2[perm]))
    gid = jnp.cumsum(bnd) - 1
    groups = int(jnp.sum(bnd))
    gid = jnp.where(svalid, jnp.minimum(gid, out_cap), out_cap)
    red = [np.asarray(jh._sorted_reduce(jnp.asarray(c)[perm], gid, out_cap,
                                        r)) for c, r in comps]
    return (np.asarray(perm), red, np.asarray(jh._first_rows(bnd, gid,
                                                             out_cap)),
            groups)


def _port_args(keys, valid, comps, out_cap):
    tkeys = [(torch.from_numpy(d), torch.from_numpy(m)) for d, m in keys]
    tvalid = torch.from_numpy(valid)
    h1, h2 = tc.row_hash_pair_plain(tkeys, tvalid, False)
    perm = tc.lex_perm_plain([h1, h2])
    return perm, (h1[perm], h2[perm], [(d[perm], m[perm]) for d, m in tkeys],
                  tvalid[perm],
                  [(torch.from_numpy(np.ascontiguousarray(c))[perm], r)
                   for c, r in comps], out_cap)


def _assert_slots(got, want, groups, out_cap):
    """The live slots of every component: floats to FLOAT_RTOL, the
    rest exactly (an empty slot's identity differs: the reference's
    segment_min of no rows is an infinity, the port's never is)."""
    live = min(groups, out_cap)
    for g, w in zip(got, want):
        g = g.numpy()[:live]
        w = w[:live]
        assert g.dtype == w.dtype
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=FLOAT_RTOL)
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shape", list(K6_SHAPES))
def test_k6_plain_matches_reference(shape):
    keys, valid, comps, out_cap = _k6_case(shape)
    rperm, rred, rfirst, groups = _reference_k6(keys, valid, comps, out_cap)
    perm, args = _port_args(keys, valid, comps, out_cap)
    np.testing.assert_array_equal(perm.numpy(), rperm)
    red, first, g, overflow = th.segment_reduce_plain(*args)
    assert int(g) == groups and bool(overflow) == (groups > out_cap)
    np.testing.assert_array_equal(first.numpy(), rfirst)
    _assert_slots(red, rred, groups, out_cap)
    expect = {"one_group": 1, "groups_eq_out_cap": 256,
              "one_past_out_cap": 257, "all_dead": 0,
              "long_among_singletons": N - N // 2 + 1}
    if shape in expect:
        assert groups == expect[shape]


# -- K2 inputs ---------------------------------------------------------

def _k2_batches(cap, live, seed=23):
    rng = np.random.default_rng(seed)
    cols = {
        "a": (rng.integers(-1 << 40, 1 << 40, cap), rng.random(cap) < 0.9,
              "bigint", None),
        "b": (rng.normal(0, 1, cap), rng.random(cap) < 0.9, "double", None),
        "c": (rng.integers(0, 1 << 20, cap).astype(np.int32),
              rng.random(cap) < 0.9, "integer", None),
        "f": (rng.random(cap) < 0.5, rng.random(cap) < 0.9, "boolean", None),
        "s": (rng.integers(-99, 99, cap).astype(np.int16),
              rng.random(cap) < 0.9, "smallint", None),
    }
    if live == "one":
        valid = np.zeros(cap, bool)
        valid[cap // 2 + 3] = True
    else:
        valid = rng.random(cap) < live
    tbatch = interop.batch_from_numpy(cols, valid, torch.device("cpu"))
    jcols = {n: jb.Column(jnp.asarray(c.data.numpy()),
                          jnp.asarray(c.mask.numpy()), None, None)
             for n, c in tbatch.columns.items()}
    return jb.Batch(jcols, jnp.asarray(valid)), tbatch


def _assert_same(jbatch, tbatch):
    np.testing.assert_array_equal(np.asarray(jbatch.row_valid),
                                  tbatch.row_valid.numpy())
    for n, c in tbatch.columns.items():
        np.testing.assert_array_equal(np.asarray(jbatch.columns[n].data),
                                      c.data.numpy())
        np.testing.assert_array_equal(np.asarray(jbatch.columns[n].mask),
                                      c.mask.numpy())


def _shrink_cap(tbatch):
    return max(int(tbatch.row_valid.sum()), 16)


# a partial tile, one tile (2,048 rows), several tiles
@pytest.mark.parametrize("cap", [1000, 2048, 5000])
@pytest.mark.parametrize("live", [0.0, 1.0, "one"])
@pytest.mark.parametrize("mode", ["full", "shrink"])
def test_k2_plain_matches_reference(cap, live, mode):
    jbatch, tbatch = _k2_batches(cap, live)
    if mode == "full":
        _assert_same(jb._compact_jit(jbatch), tb.compact_full_plain(tbatch))
    else:
        out_cap = _shrink_cap(tbatch)
        _assert_same(jb._compact_shrink_jit(jbatch, out_cap),
                     tb.compact_shrink_plain(tbatch, out_cap))


# -- the wrappers against twins of their C entry points -----------------

_BY_CODE = {0: torch.int32, 1: torch.int64, 2: torch.float32,
            3: torch.float64}
_OPS = {0: "sum", 1: "min", 2: "max"}
_KEY_BY_CODE = {2: torch.int32, 3: torch.int64, 5: torch.float64,
                1: torch.int16, 4: torch.float32, 0: torch.int8}
_RAW = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _at(addr, count, dtype):
    """`count` elements of `dtype` at host address `addr`, shared."""
    if count == 0:
        return torch.empty(0, dtype=dtype)
    size = count * torch.empty((), dtype=dtype).element_size()
    return torch.frombuffer((ctypes.c_ubyte * size).from_address(addr),
                            dtype=dtype)


class _SegmentTwin:
    """`presto_segment_reduce` in Python: reads the descriptor and the
    key tables as the C entry point does, runs the plain version and
    writes stats, starts, first rows and every component's slots where
    the descriptor points."""

    TILE = 1024

    def __init__(self):
        self.calls = []

    def presto_segment_tile(self):
        return self.TILE

    def presto_segment_reduce(self, desc, kd, km, kt, nk, ticket, status,
                              words, epoch, stream):
        n, out_cap, ncomp = (ctypes.c_int64 * 3).from_address(desc)
        d = list((ctypes.c_int64 * (10 + 3 * ncomp)).from_address(desc))
        nk = nk.value
        keys = [(_at(kd[j], n, _KEY_BY_CODE[kt[j]]), _at(km[j], n, torch.bool))
                for j in range(nk)]
        comps = [(_at(d[10 + 3 * j], n, _BY_CODE[d[12 + 3 * j] & 0xff]),
                  _OPS[d[12 + 3 * j] >> 8]) for j in range(ncomp)]
        seg = []
        red, first, _, _ = th.segment_reduce_plain(
            _at(d[3], n, torch.int64), _at(d[4], n, torch.int64), keys,
            _at(d[5], n, torch.bool), comps, out_cap, seg)
        _at(d[6], 4, torch.int64).copy_(seg[0].stats)
        _at(d[7], out_cap + 1, torch.int64).copy_(seg[0].starts)
        _at(d[8], out_cap, torch.int64).copy_(first)
        for j, r in enumerate(red):
            _at(d[11 + 3 * j], out_cap, r.dtype).copy_(r)
        self.calls.append({"n": n, "nkeys": nk, "words": words,
                           "epoch": epoch, "ncomp": ncomp})
        return 0


class _CompactTwin:
    """`presto_compact` in Python: reads the descriptor as the C entry
    point does and runs the plain version over the raw element bits."""

    TILE = 2048

    def __init__(self):
        self.calls = []

    def presto_compact_tile(self):
        return self.TILE

    def presto_compact(self, desc, ncols, n, out_cap, shrink, ticket,
                       status, words, epoch, stream):
        d = list((ctypes.c_int64 * (2 + 5 * ncols)).from_address(desc))
        rv = _at(d[0], n, torch.bool)
        cols, outs = {}, []
        for c in range(ncols):
            data, mask, odata, omask, w = d[2 + 5 * c:7 + 5 * c]
            cols[f"c{c}"] = tb.Column(_at(data, n, _RAW[w]),
                                      _at(mask, n, torch.bool), None)
            outs.append((_at(odata, out_cap, _RAW[w]),
                         _at(omask, out_cap, torch.bool)))
        b = tb.Batch(cols, rv)
        got = tb.compact_shrink_plain(b, out_cap) if shrink \
            else tb.compact_full_plain(b)
        for (od, om), c in zip(outs, got.columns.values()):
            od.copy_(c.data)
            om.copy_(c.mask)
        if d[1]:
            _at(d[1], out_cap, torch.bool).copy_(got.row_valid)
        self.calls.append({"ncols": ncols, "n": n, "shrink": shrink,
                           "words": words, "epoch": epoch,
                           "row_valid": bool(d[1])})
        return 0


@pytest.fixture
def twins(monkeypatch):
    libs = {"segment_reduce": _SegmentTwin(), "compact": _CompactTwin()}
    monkeypatch.setattr(cuda, "library", lambda name: libs[name])
    monkeypatch.setattr(cuda, "stream_ptr", lambda dev: 0)
    return libs


@pytest.mark.parametrize("shape", ["random", "overflow", "all_dead",
                                   "nine_keys", "many_components"])
def test_k6_wrapper_views_equal_the_plain_version(twins, shape):
    """The wrapper's outputs (views of its one allocation) equal the
    plain version's, the segments too; each call takes two look-back
    words a tile and a new epoch; 65 components take two calls."""
    keys, valid, comps, out_cap = _k6_case(shape)
    _, args = _port_args(keys, valid, comps, out_cap)
    seg_got, seg_want = [], []
    got = th._segment_reduce_cuda(*args, seg_out=seg_got)
    want = th.segment_reduce_plain(*args, seg_out=seg_want)
    for g, w in zip(got[0] + [got[1]], want[0] + [want[1]]):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert int(got[2]) == int(want[2])
    assert got[3].dtype == torch.bool and bool(got[3]) == bool(want[3])
    assert torch.equal(seg_got[0].stats, seg_want[0].stats)
    known = min(int(want[2]), out_cap) + 1
    assert torch.equal(seg_got[0].starts[:known], seg_want[0].starts[:known])
    calls = twins["segment_reduce"].calls
    assert len(calls) == (2 if len(comps) > th.KERNEL_MAX_COMPS else 1)
    tile = _SegmentTwin.TILE
    assert all(c["words"] >= 2 * -(-N // tile) and c["nkeys"] == len(keys)
               for c in calls)
    assert len({c["epoch"] for c in calls}) == len(calls)


@pytest.mark.parametrize("cap", [1000, 5000])
@pytest.mark.parametrize("live", [0.0, 0.3, 1.0, "one"])
@pytest.mark.parametrize("mode", ["full", "shrink"])
def test_k2_wrapper_views_equal_the_plain_version(twins, cap, live, mode):
    """One call of K2's wrapper: its columns, masks and row_valid (views
    of one allocation) equal the plain version's; a look-back word a
    tile and a flag a tail; row_valid written by the launch."""
    _, b = _k2_batches(cap, live)
    if mode == "full":
        got, want = tb._compact_cuda(b, cap, False), tb.compact_full_plain(b)
    else:
        out_cap = _shrink_cap(b)
        got = tb._compact_cuda(b, out_cap, True)
        want = tb.compact_shrink_plain(b, out_cap)
    assert torch.equal(got.row_valid, want.row_valid)
    for n, c in want.columns.items():
        assert got.columns[n].data.dtype == c.data.dtype
        assert torch.equal(got.columns[n].data, c.data)
        assert torch.equal(got.columns[n].mask, c.mask)
    (call,) = twins["compact"].calls
    tile = _CompactTwin.TILE
    tiles = -(-cap // tile)
    tails = tiles if mode == "full" else -(-out_cap // tile)
    assert call["words"] >= tiles + tails
    assert call["row_valid"] and call["ncols"] == 5


def test_k2_wrapper_takes_more_than_64_columns(twins):
    """131 columns: three launches over the same rows, row_valid written
    by the first only, each with its own epoch."""
    rng = np.random.default_rng(9)
    cap = 2000
    cols = {f"c{i}": (rng.integers(-99, 99, cap).astype(
        (np.int64, np.int32, np.int16)[i % 3]), rng.random(cap) < 0.8,
        ("bigint", "integer", "smallint")[i % 3], None) for i in range(131)}
    b = interop.batch_from_numpy(cols, rng.random(cap) < 0.3,
                                 torch.device("cpu"))
    got, want = tb._compact_cuda(b, cap, False), tb.compact_full_plain(b)
    assert torch.equal(got.row_valid, want.row_valid)
    for n, c in want.columns.items():
        assert torch.equal(got.columns[n].data, c.data)
        assert torch.equal(got.columns[n].mask, c.mask)
    calls = twins["compact"].calls
    assert [c["ncols"] for c in calls] == [64, 64, 3]
    assert [c["row_valid"] for c in calls] == [True, False, False]
    assert len({c["epoch"] for c in calls}) == 3


def test_k2_wrapper_rejects_what_the_kernel_does_not_take(twins):
    _, b = _k2_batches(1000, 0.5)
    a = b.columns["a"]
    strided = tb.Batch({"a": tb.Column(a.data[::2], a.mask[::2], a.type)},
                       b.row_valid[::2])
    with pytest.raises(ValueError, match="contiguous"):
        tb._compact_cuda(strided, 500, False)
    wrong = tb.Batch({"a": tb.Column(a.data, a.mask.to(torch.uint8),
                                     a.type)}, b.row_valid)
    with pytest.raises(ValueError, match="bool"):
        tb._compact_cuda(wrong, 1000, False)
    assert twins["compact"].calls == []


def test_k6_wrapper_rejects_what_the_kernel_does_not_take(twins):
    keys, valid, comps, out_cap = _k6_case("random")
    _, args = _port_args(keys, valid, comps, out_cap)
    h1, h2, skeys, svalid, scomps, _ = args
    with pytest.raises(ValueError, match="contiguous"):
        th._segment_reduce_cuda(h1, h2, skeys, svalid,
                                [(torch.zeros(2 * N)[::2], "sum")], out_cap)
    with pytest.raises(ValueError, match="takes"):
        th._segment_reduce_cuda(h1, h2, skeys, svalid,
                                [(scomps[0][0], "avg")], out_cap)
    with pytest.raises(ValueError, match="h1"):
        th._segment_reduce_cuda(h1.to(torch.int32), h2, skeys, svalid,
                                scomps, out_cap)
    assert twins["segment_reduce"].calls == []
