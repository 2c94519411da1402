"""The port's streaming aggregation against the JAX package's, over the
same seeded numpy inputs: `presorted_aggregate` (grouping rows that
arrive in key order, with no sort), the streaming round that folds the
carried group (`stream_aggregate` against the reference's
`presorted_aggregate` + `_stream_step_jit`) and the streaming operator
through both LocalRunners.

On the CPU the port runs K8's plain version; the CUDA kernel is held
against it in tests/test_torch_cuda.py. Groups arrive in key order in
both packages, so they are compared in order: keys and integer states
exactly, float64 states to a relative 1e-9 (both reduce in row order).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu.operators.aggregation import _stream_step_jit
from presto_tpu.ops import hashagg as jh
from presto_tpu.types import BIGINT, DOUBLE, INTEGER

from presto_tpu_torch import types as tt
from presto_tpu_torch.ops import hashagg as th

from test_torch_hashagg_sort import _aggs, _inputs, _np, _t
from test_tpch_suite import assert_rows_equal

# one intra-op thread: see tests/test_torch_tpch.py
torch.set_num_threads(1)

FLOAT_RTOL = 1e-9
CPU = torch.device("cpu")

#: key types of the up-to-three key columns `_sorted_keys` makes
_JTYPES = [BIGINT, INTEGER, DOUBLE]
_TTYPES = [tt.BIGINT, tt.INTEGER, tt.DOUBLE]


def _sorted_keys(base, nkeys):
    """Key columns sorted ascending, nulls last, from sorted group ids
    `base`: (base // 6, base % 6 as int32, base % 2 / 4 as double);
    the last group of the stream has a NULL first key, and every sixth
    second key is NULL (the last of its first-key group)."""
    k0 = (base // 6).astype(np.int64)
    m0 = base < base.max()
    k1 = (base % 6).astype(np.int32)
    m1 = k1 != 5
    k2 = (base % 2).astype(np.float64) / 4
    m2 = np.ones(len(base), bool)
    return [(k0, m0), (k1, m1), (k2, m2)][:nkeys]


def _stream(rng, nbatches, n, nkeys, dead):
    """`nbatches` batches of `n` rows of one key-sorted stream. Group
    sizes vary from 1 to 40 rows and one group spans three batches.
    dead: "random" (15% dead rows anywhere), "borders" (dead runs
    across the 1024-row tile borders), "all" (the middle batch all
    dead)."""
    total = nbatches * n
    sizes = rng.integers(1, 40, total)
    base = np.repeat(np.arange(total), sizes)[:total]
    # one group from the last rows of batch 0 to the first of batch 2
    lo, hi = n - 50, 2 * n + 50
    base[lo:hi] = base[lo]
    base[hi:] = np.maximum(base[hi:], base[lo] + 1)
    rv = rng.random(total) < 0.85
    if dead == "borders":
        for t in range(1024, total, 1024):
            rv[t - 30:t + 30] = False
    elif dead == "all":
        rv[n:2 * n] = False
    keys = _sorted_keys(base, nkeys)
    inputs = _inputs(rng, total)
    weights = [rv & (rng.random(total) < 0.9) for _ in range(5)]
    batches = []
    for b in range(nbatches):
        s = slice(b * n, (b + 1) * n)
        batches.append((rv[s], [(d[s], m[s]) for d, m in keys],
                        [None if x is None else x[s] for x in inputs],
                        [w[s] for w in weights]))
    return batches


def _jargs(rv, keys, inputs, weights):
    return (jnp.asarray(rv), [(jnp.asarray(d), jnp.asarray(m))
                              for d, m in keys],
            [None if x is None else jnp.asarray(x) for x in inputs],
            [jnp.asarray(w) for w in weights])


def _targs(rv, keys, inputs, weights):
    return (_t(rv), [(_t(d), _t(m)) for d, m in keys],
            [None if x is None else _t(x) for x in inputs],
            [_t(w) for w in weights])


def _rows(state, valid=None):
    """The live groups of a state in slot order: (key tuple, states)."""
    valid = _np(state.valid) if valid is None else valid
    out = []
    for i in np.flatnonzero(valid):
        key = tuple(_np(d)[i].item() if _np(m)[i] else None
                    for d, m in state.keys)
        out.append((key, tuple(_np(a)[i].item() for st in state.states
                               for a in st)))
    return out


def _assert_rows_equal(got, want):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, g), (_, w) in zip(got, want):
        for gv, wv in zip(g, w):
            if isinstance(wv, float):
                assert math.isclose(gv, wv, rel_tol=FLOAT_RTOL,
                                    abs_tol=1e-12), (k, gv, wv)
            else:
                assert gv == wv, (k, gv, wv)


@pytest.mark.parametrize("dead", ["random", "borders"])
@pytest.mark.parametrize("nkeys", [1, 2, 3])
def test_presorted_aggregate_matches_reference(nkeys, dead):
    """One key-sorted batch: the same groups, in the same (key) order,
    with the same states; dead rows between live rows and across tile
    borders belong to no group; NULL keys group together."""
    rng = np.random.default_rng(nkeys * 10 + len(dead))
    jaggs, taggs = _aggs()
    batch = _stream(rng, 3, 5000, nkeys, dead)[0]
    js = jh.presorted_aggregate(*_jargs(*batch), jaggs, 8192)
    ts = th.presorted_aggregate(*_targs(*batch), taggs, 8192)
    _assert_rows_equal(_rows(ts), _rows(js))
    assert bool(ts.overflow) == bool(js.overflow) is False
    np.testing.assert_array_equal(ts.valid.numpy(), _np(js.valid))


def test_presorted_aggregate_overflow_matches_reference():
    """More groups than slots: both flag the overflow and keep the
    first out_cap groups."""
    rng = np.random.default_rng(7)
    jaggs, taggs = _aggs()
    batch = _stream(rng, 3, 4096, 2, "random")[0]
    js = jh.presorted_aggregate(*_jargs(*batch), jaggs, 64)
    ts = th.presorted_aggregate(*_targs(*batch), taggs, 64)
    assert bool(js.overflow) and bool(ts.overflow)
    _assert_rows_equal(_rows(ts), _rows(js))


def _run_reference(batches, jaggs, nkeys, out_cap):
    carry = jh.init_state(_JTYPES[:nkeys], jaggs, 1)
    emitted = []
    for b in batches:
        partial = jh.presorted_aggregate(*_jargs(*b), jaggs, out_cap)
        carry_emit, emit, carry, _ = _stream_step_jit(carry, partial,
                                                      tuple(jaggs))
        emitted += _rows(carry_emit) + _rows(emit)
    return emitted + _rows(carry)


def _run_port(batches, taggs, nkeys, out_cap):
    carry = th.init_state(_TTYPES[:nkeys], taggs, 1, CPU)
    emitted = []
    for b in batches:
        rv, keys, inputs, weights = _targs(*b)
        carry_emit, emit, carry, live = th.stream_aggregate(
            carry, rv, keys, inputs, weights, taggs, out_cap)
        rows = _rows(emit)
        assert int(live) == len(rows)
        emitted += _rows(carry_emit) + rows
    return emitted + _rows(carry)


@pytest.mark.parametrize("dead", ["random", "borders", "all"])
@pytest.mark.parametrize("nkeys", [1, 3])
def test_stream_rounds_match_reference(nkeys, dead):
    """Four batches of one stream through the streaming round: the
    carried group folds into the next batch's first group (one group
    spans three batches), completes when the keys change at a border,
    passes an all-dead batch untouched, and goes out last. Every group
    is emitted once, in key order."""
    rng = np.random.default_rng(nkeys * 31 + len(dead))
    jaggs, taggs = _aggs()
    batches = _stream(rng, 4, 3000, nkeys, dead)
    want = _run_reference(batches, jaggs, nkeys, 4096)
    got = _run_port(batches, taggs, nkeys, 4096)
    _assert_rows_equal(got, want)
    keys = [k for k, _ in got]
    assert len(set(keys)) == len(keys)


# -- the streaming operator in SQL --------------------------------------

_RUNNERS = {}


def _runners(batch_rows):
    if batch_rows not in _RUNNERS:
        from presto_tpu.runner import LocalRunner as JaxRunner
        from presto_tpu_torch.runner import LocalRunner as TorchRunner
        props = {"batch_rows": batch_rows}
        _RUNNERS[batch_rows] = (
            JaxRunner("tpch", "tiny", properties=props),
            TorchRunner("tpch", "tiny", properties=props, device="cpu"))
    return _RUNNERS[batch_rows]


#: groupings over lineitem's declared sort order (orderkey): raw scan
#: batches, a filter that leaves dead rows between live ones, a two-key
#: grouping on the sort prefix, and Q18's HAVING subquery at a lower
#: threshold
STREAM_SHAPES = [
    ("raw", "select orderkey, sum(quantity), count(*), min(linenumber), "
            "max(extendedprice) from lineitem group by orderkey"),
    ("filtered", "select orderkey, count(*), avg(discount) from lineitem "
                 "where quantity < 20 group by orderkey"),
    ("two_keys", "select orderkey, linenumber, sum(tax) from lineitem "
                 "group by orderkey, linenumber"),
    ("having", "select orderkey, sum(quantity) from lineitem "
               "group by orderkey having sum(quantity) > 150"),
]


@pytest.mark.parametrize("batch_rows", [256, 1 << 20])
@pytest.mark.parametrize("name,sql", STREAM_SHAPES,
                         ids=[s[0] for s in STREAM_SHAPES])
def test_streaming_shapes_match_reference(name, sql, batch_rows,
                                          monkeypatch):
    """The port streams these groupings (small batches carry groups
    across many borders) and returns the reference's rows."""
    from presto_tpu_torch.operators import aggregation as tagg
    made = []
    orig = tagg.StreamingAggregationOperator.__init__

    def spy(self, *args, **kwargs):
        made.append(self)
        orig(self, *args, **kwargs)
    monkeypatch.setattr(tagg.StreamingAggregationOperator, "__init__", spy)
    ref, port = _runners(batch_rows)
    got = port.execute(sql).rows()
    assert made, "the port did not plan a streaming aggregation"
    assert_rows_equal(got, ref.execute(sql).rows(), name, False)
    assert got
