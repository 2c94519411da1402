"""The port's sort-based aggregation (K3 row hash + sort + K6 segment
reduce, here their plain versions on the CPU) against the JAX
package's, over the same seeded numpy inputs, and the query-level
retries on a group-table or join-capacity overflow.

Group order is backend-dependent (hash order), so groups are compared
as multisets keyed by their key values. Integer state components must
match exactly; float64 components to a relative 1e-9 (the two packages
reduce in the same row order here, with `segment_sum` and
`index_add_`).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu.ops import hashagg as jh
from presto_tpu.types import BIGINT, DOUBLE, INTEGER

from presto_tpu_torch.ops import common as tc
from presto_tpu_torch.ops import hashagg as th
from presto_tpu_torch import types as tt

# one intra-op thread: see tests/test_torch_tpch.py
torch.set_num_threads(1)

FLOAT_RTOL = 1e-9


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _aggs():
    return ([jh.make_sum(DOUBLE, DOUBLE), jh.make_count(None),
             jh.make_min(INTEGER), jh.make_max(BIGINT),
             jh.make_avg(DOUBLE)],
            [th.make_sum(tt.DOUBLE, tt.DOUBLE), th.make_count(None),
             th.make_min(tt.INTEGER), th.make_max(tt.BIGINT),
             th.make_avg(tt.DOUBLE)])


def _inputs(rng, n):
    return [rng.normal(10, 5, n), None,
            rng.integers(-1000, 1000, n).astype(np.int32),
            rng.integers(-(1 << 40), 1 << 40, n), rng.normal(0, 1, n)]


def _keys(rng, n, nkeys, ngroups):
    """Up to three key columns (bigint, integer, double) drawn from
    about `ngroups` combinations, with NULLs."""
    base = rng.integers(0, ngroups, n)
    cols = [base.astype(np.int64), (base % 13).astype(np.int32),
            (base % 7).astype(np.float64) / 4]
    return [(c, rng.random(n) < 0.93) for c in cols[:nkeys]]


def _groups(state, valid=None):
    """{key tuple: state tuple} of the live slots (NULL key -> None)."""
    valid = _np(state.valid) if valid is None else valid
    out = {}
    for i in np.flatnonzero(valid):
        key = tuple(_np(d)[i].item() if _np(m)[i] else None
                    for d, m in state.keys)
        assert key not in out, f"group {key} appears twice"
        out[key] = tuple(_np(a)[i].item() for st in state.states
                         for a in st)
    return out


def _assert_groups_equal(jstate, tstate):
    want, got = _groups(jstate), _groups(tstate)
    assert got.keys() == want.keys()
    for k, w in want.items():
        for gv, wv in zip(got[k], w):
            if isinstance(wv, float):
                assert math.isclose(gv, wv, rel_tol=FLOAT_RTOL,
                                    abs_tol=1e-12), (k, gv, wv)
            else:
                assert gv == wv, (k, gv, wv)
    assert bool(tstate.overflow) == bool(jstate.overflow)


def _batch_args(rng, n, nkeys, ngroups, jaggs):
    rv = rng.random(n) < 0.85
    keys = _keys(rng, n, nkeys, ngroups)
    inputs = _inputs(rng, n)
    weights = [rv & (rng.random(n) < 0.9) for _ in jaggs]
    jargs = (jnp.asarray(rv), [(jnp.asarray(d), jnp.asarray(m))
                               for d, m in keys],
             [None if x is None else jnp.asarray(x) for x in inputs],
             [jnp.asarray(w) for w in weights])
    targs = (_t(rv), [(_t(d), _t(m)) for d, m in keys],
             [None if x is None else _t(x) for x in inputs],
             [_t(w) for w in weights])
    return jargs, targs


@pytest.mark.parametrize("nkeys", [1, 2, 3])
@pytest.mark.parametrize("ngroups,out_cap", [(50, 256), (3000, 4096),
                                             (3000, 512)],
                         ids=["few", "many", "overflow"])
def test_batch_aggregate_matches_reference(nkeys, ngroups, out_cap):
    """`_group_reduce` through batch_aggregate: the same groups and
    states, and the overflow flag when groups exceed out_cap (then
    the kept groups are compared where both packages kept them)."""
    rng = np.random.default_rng(nkeys * 100 + ngroups)
    jaggs, taggs = _aggs()
    jargs, targs = _batch_args(rng, 8192, nkeys, ngroups, jaggs)
    js = jh.batch_aggregate(*jargs, jaggs, out_cap)
    ts = th.batch_aggregate(*targs, taggs, out_cap)
    if ngroups <= out_cap:
        _assert_groups_equal(js, ts)
        return
    assert bool(js.overflow) and bool(ts.overflow)
    assert int(ts.valid.sum()) == int(_np(js.valid).sum()) == out_cap
    # both keep the first out_cap groups in (h1, h2) order: the same set
    assert _groups(ts).keys() == _groups(js).keys()


def test_merge_partials_matches_reference():
    """Three batches aggregated separately, then merged (the operator's
    tree merge), equal the reference's merge."""
    rng = np.random.default_rng(41)
    jaggs, taggs = _aggs()
    jparts, tparts = [], []
    for _ in range(3):
        jargs, targs = _batch_args(rng, 4096, 2, 2000, jaggs)
        jparts.append(jh.batch_aggregate(*jargs, jaggs, 4096))
        tparts.append(th.batch_aggregate(*targs, taggs, 4096))
    _assert_groups_equal(jh.merge_partials(jparts, jaggs, 8192),
                         th.merge_partials(tparts, taggs, 8192))
    # merged into too few slots: both flag the overflow
    assert bool(jh.merge_partials(jparts, jaggs, 256).overflow)
    assert bool(th.merge_partials(tparts, taggs, 256).overflow)


def test_agg_step_and_finalize_match_reference():
    """The functional fold over two batches, then finalize and the
    intermediate (partial-state) batch."""
    rng = np.random.default_rng(43)
    jaggs, taggs = _aggs()
    jstate = jh.init_state([BIGINT, INTEGER], jaggs, 4096)
    tstate = th.init_state([tt.BIGINT, tt.INTEGER], taggs, 4096,
                           torch.device("cpu"))
    for _ in range(2):
        jargs, targs = _batch_args(rng, 2048, 2, 1500, jaggs)
        jstate = jh.agg_step(jstate, *jargs, jaggs)
        tstate = th.agg_step(tstate, *targs, taggs)
    _assert_groups_equal(jstate, tstate)
    names = ["s", "c", "mn", "mx", "a"]
    jb = jh.finalize(jstate, ["k0", "k1"], [BIGINT, INTEGER],
                     [None, None], names, jaggs)
    tb = th.finalize(tstate, ["k0", "k1"], [tt.BIGINT, tt.INTEGER],
                     [None, None], names, taggs)
    _assert_batches_close(jb, tb)
    # the partial states as columns (the partial/final shuffle's shape)
    args = (["k0", "k1"], [None, None], names)
    _assert_batches_close(
        jh.intermediate_batch(jstate, args[0], [BIGINT, INTEGER],
                              *args[1:], jaggs),
        th.intermediate_batch(tstate, args[0], [tt.BIGINT, tt.INTEGER],
                              *args[1:], taggs))


def _assert_batches_close(jb, tb):
    """Live rows of a reference and a port batch, as multisets keyed by
    the two group-key columns."""
    assert tb.names == jb.names
    want = sorted(zip(*[jb.columns[n].to_pylist(_np(jb.row_valid))
                        for n in jb.names]), key=lambda r: str(r[:2]))
    got = sorted(tb.to_pylist(), key=lambda r: str(r[:2]))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for gv, wv in zip(g, w):
            if isinstance(wv, float):
                assert math.isclose(gv, wv, rel_tol=FLOAT_RTOL)
            else:
                assert gv == wv


def test_hash_boundaries_match_reference():
    """boundaries(..., hashes=) over hash-sorted rows, and the lex
    permutation of (h1, h2)."""
    rng = np.random.default_rng(47)
    n = 4096
    keys = _keys(rng, n, 2, 300)
    valid = rng.random(n) < 0.9
    h1 = np.where(valid, _np(tc.row_hash([(_t(d), _t(m))
                                          for d, m in keys])),
                  np.iinfo(np.int64).max)
    h2 = tc.row_hash2([(_t(d), _t(m)) for d, m in keys]).numpy()
    from presto_tpu.ops import common as jc
    jperm = _np(jc.lex_perm([jnp.asarray(h1), jnp.asarray(h2)]))
    tperm = tc.lex_perm([_t(h1), _t(h2)]).numpy()
    np.testing.assert_array_equal(tperm, jperm)
    sk = [(d[tperm], m[tperm]) for d, m in keys]
    jb = jc.boundaries([(jnp.asarray(d), jnp.asarray(m)) for d, m in sk],
                       jnp.asarray(valid[tperm]),
                       hashes=(jnp.asarray(h1[tperm]),
                               jnp.asarray(h2[tperm])))
    tb = tc.boundaries([(_t(d), _t(m)) for d, m in sk], _t(valid[tperm]),
                       hashes=(_t(h1[tperm]), _t(h2[tperm])))
    np.testing.assert_array_equal(tb.numpy(), _np(jb))


def test_bounded_searchsorted_matches_reference():
    rng = np.random.default_rng(53)
    a = np.sort(rng.integers(-1000, 1000, 512))
    v = rng.integers(-1100, 1100, 2048)
    lo = rng.integers(0, 256, 2048)
    hi = lo + rng.integers(0, 256, 2048)
    from presto_tpu.ops import common as jc
    iters = tc.search_iters(256)
    assert jc.search_iters(256) == iters
    for side in ("left", "right"):
        want = _np(jc.bounded_searchsorted(
            jnp.asarray(a), jnp.asarray(v), jnp.asarray(lo),
            jnp.asarray(hi), iters, side))
        got = tc.bounded_searchsorted(_t(a), _t(v), _t(lo), _t(hi),
                                      iters, side).numpy()
        np.testing.assert_array_equal(got, want)


# -- the query-level retries ----------------------------------------------


def _port_runner(**props):
    from presto_tpu_torch.runner import LocalRunner
    return LocalRunner("tpch", "tiny", properties=props, device="cpu")


def test_group_limit_retry(monkeypatch):
    """A grouping that outgrows max_groups (and no stats estimate to
    seed it) raises GroupLimitExceeded inside the drive; the runner
    re-runs with 4x the groups until it fits, and the rows equal the
    reference's."""
    from presto_tpu.runner import LocalRunner as JaxRunner
    from presto_tpu_torch.operators import aggregation as agg
    from presto_tpu_torch.planner.local_planner import (
        LocalExecutionPlanner,
    )
    monkeypatch.setattr(LocalExecutionPlanner, "_estimated_groups",
                        lambda self, node: None)
    seen = []
    orig = agg.AggregationOperator.__init__

    def spy(self, ctx, *args):
        seen.append(args[-1])
        orig(self, ctx, *args)
    monkeypatch.setattr(agg.AggregationOperator, "__init__", spy)
    sql = ("select orderkey, count(*), sum(quantity) from lineitem "
           "group by orderkey")
    # lineitem arrives sorted by orderkey, which would stream this
    # grouping (no group table, no retry): keep it on the sort path
    got = _port_runner(max_groups=16,
                       streaming_aggregation=False).execute(sql).rows()
    want = JaxRunner("tpch", "tiny").execute(sql).rows()
    assert sorted(got) == sorted(want)
    assert seen[:4] == [16, 64, 256, 1024] and len(seen) >= 5


def test_join_capacity_retry(monkeypatch):
    """A many-to-many join probed with expansion factor 1 (no stats
    seed) overflows on the device; the one deferred read after the
    drive raises JoinCapacityExceeded and the runner re-runs with a 4x
    factor."""
    from presto_tpu.runner import LocalRunner as JaxRunner
    from presto_tpu_torch.operators import join_ops
    from presto_tpu_torch.planner.local_planner import (
        LocalExecutionPlanner,
    )
    monkeypatch.setattr(LocalExecutionPlanner, "_estimated_expansion",
                        lambda self, node, probe: 1)
    seen = []
    orig = join_ops.LookupJoinOperator.__init__

    def spy(self, *args):
        seen.append(args[-1])
        orig(self, *args)
    monkeypatch.setattr(join_ops.LookupJoinOperator, "__init__", spy)
    # output capacity = the probe batch's kernel-ladder capacity (4096
    # at least, as the reference's padded batch) x the factor: the
    # half the orders joined to every order of the same customer
    # overflow 4096 slots and fit 16384
    sql = ("select a.orderkey, b.orderkey from orders a join orders b "
           "on a.custkey = b.custkey where a.orderkey % 2 = 0")
    got = _port_runner().execute(sql).rows()
    want = JaxRunner("tpch", "tiny").execute(sql).rows()
    assert sorted(got) == sorted(want) and 4096 < len(got) <= 16384
    assert seen == [1, 4]
