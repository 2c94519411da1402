"""The aggregation state's families in the port against the reference on
the CPU, fed identical states (`interop.group_state_from_numpy`,
`direct_state_from_numpy`) built from the same numpy inputs:
hashagg_merge (`merge_partials` over 2-8 partials, vector components
included), agg_count (the count a state carries against the
reference's `jnp.sum(valid)`), agg_shrink (`_shrink_state`, in new
storage of its size: ROADMAP C10) and agg_finalize (every final op
through `direct_finalize`, `direct_intermediate`, `finalize` and
`intermediate_batch`). On CPU tensors the wrappers of K3, K26, K28,
K29 and K30 run their plain versions, which these tests hold against
the reference; the kernels are held against the plain versions on the
card (tests/test_torch_cuda.py).

Tolerances: integer and vector states exactly; float64 states and
outputs to a relative 1e-9 (the same operations; XLA's and torch's
`exp`, `log` and `pow` on the CPU may differ in the last place).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu import types as JT
from presto_tpu.operators import aggregation as jagg
from presto_tpu.ops import hashagg as jh
from presto_tpu_torch import interop
from presto_tpu_torch import types as TT
from presto_tpu_torch.operators import aggregation as tagg
from presto_tpu_torch.ops import hashagg as th

torch.set_num_threads(1)
CPU = torch.device("cpu")

# (port maker, reference maker, input kind) of every final op
_FINALS = [
    (lambda m: m.make_sum(_t(m, "DOUBLE"), _t(m, "DOUBLE")), "f"),
    (lambda m: m.make_sum(_t(m, "BIGINT"), _t(m, "BIGINT")), "i"),
    (lambda m: m.make_count(None), None),
    (lambda m: m.make_avg(_t(m, "DOUBLE")), "f"),
    (lambda m: m.make_min(_t(m, "INTEGER")), "i32"),
    (lambda m: m.make_max(_t(m, "DOUBLE")), "f"),
    (lambda m: m.make_variance("var_samp"), "f"),
    (lambda m: m.make_variance("var_pop"), "f"),
    (lambda m: m.make_variance("stddev"), "f"),
    (lambda m: m.make_variance("stddev_pop"), "f"),
    (lambda m: m.make_count_if(), "b"),
    (lambda m: m.make_bool_and(False), "b"),
    (lambda m: m.make_bool_and(True), "b"),
    (lambda m: m.make_geometric_mean(), "f"),
    (lambda m: m.make_moments("skewness"), "f"),
    (lambda m: m.make_moments("kurtosis"), "f"),
    (lambda m: m.make_entropy(), "f"),
    (lambda m: m.make_checksum(_t(m, "BIGINT")), "i"),
    (lambda m: m.make_approx_percentile(0.9), "f"),
    (lambda m: m.make_approx_distinct(_t(m, "BIGINT")), "i"),
]


def _t(mod, name):
    return getattr(JT if mod is jh else TT, name)


def _aggs(which=None):
    sel = _FINALS if which is None else [_FINALS[i] for i in which]
    return ([mk(th) for mk, _ in sel], [mk(jh) for mk, _ in sel],
            [kind for _, kind in sel])


def _inputs(rng, n, kinds):
    out = []
    for kind in kinds:
        if kind is None:
            out.append(None)
        elif kind == "f":
            out.append(rng.lognormal(2.0, 1.0, n))
        elif kind == "i":
            out.append(rng.integers(-1 << 40, 1 << 40, n))
        elif kind == "i32":
            out.append(rng.integers(-1000, 1000, n).astype(np.int32))
        else:
            out.append(rng.random(n) < 0.6)
    return out


def _both(rng, n, kinds, nkeys_dom=None, groups=300):
    """One batch as (port args, reference args): row_valid, keys,
    inputs, weights."""
    rv = rng.random(n) < 0.9
    if nkeys_dom is None:
        keys = [(rng.integers(0, groups, n), rng.random(n) < 0.97)]
    else:
        keys = [(rng.integers(0, d, n).astype(np.int32),
                 rng.random(n) < 0.9) for d in nkeys_dom]
    inputs = _inputs(rng, n, kinds)
    w = [rv & (rng.random(n) < 0.9) for _ in kinds]

    def conv(f):
        return (f(rv), [(f(d), f(m)) for d, m in keys],
                [None if x is None else f(x) for x in inputs],
                [f(x) for x in w])
    return conv(torch.from_numpy), conv(jnp.asarray)


def _np(x):
    return np.asarray(x)


def _port_state_of(jstate):
    return interop.group_state_from_numpy(
        [(_np(d), _np(m)) for d, m in jstate.keys],
        [[_np(a) for a in st] for st in jstate.states], _np(jstate.valid),
        bool(jstate.overflow), CPU)


def _by_key(keys, states, valid):
    """{key tuple: [component arrays' rows]} of a packed state."""
    live = np.flatnonzero(np.asarray(valid))
    out = {}
    for g in live:
        k = tuple((bool(m[g]), d[g].item() if m[g] else None)
                  for d, m in keys)
        out[k] = [a[g] for st in states for a in st]
    return out


def _assert_states_equal(tstate, jstate):
    tk = [(d.numpy(), m.numpy()) for d, m in tstate.keys]
    jk = [(_np(d), _np(m)) for d, m in jstate.keys]
    got = _by_key(tk, [[a.numpy() for a in st] for st in tstate.states],
                  tstate.valid.numpy())
    want = _by_key(jk, [[_np(a) for a in st] for st in jstate.states],
                   _np(jstate.valid))
    assert got.keys() == want.keys()
    for k in want:
        for g, w in zip(got[k], want[k]):
            if np.issubdtype(np.asarray(w).dtype, np.floating):
                np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9)
            else:
                np.testing.assert_array_equal(g, w)
    assert bool(tstate.overflow) == bool(jstate.overflow)
    assert int(tstate.live) == int(jnp.sum(jstate.valid))


_VECTOR = [0, 1, 2, 17, 18, 19]  # sum, sum, count, checksum, pctl, hll


def test_batch_aggregate_with_vector_states_matches_reference():
    rng = np.random.default_rng(1)
    taggs, jaggs, kinds = _aggs(_VECTOR)
    targs, jargs = _both(rng, 3000, kinds)
    tst = th.batch_aggregate(*targs, taggs, 512)
    jst = jh.batch_aggregate(*jargs, jaggs, 512)
    _assert_states_equal(tst, jst)


@pytest.mark.parametrize("nparts", [2, 3, 5, 8])
def test_merge_partials_matches_reference(nparts):
    """hashagg_merge over identical partial states from the reference,
    vector components included; the merged state carries its count."""
    rng = np.random.default_rng(10 + nparts)
    taggs, jaggs, kinds = _aggs(_VECTOR)
    jparts = []
    for _ in range(nparts):
        _, jargs = _both(rng, 1500, kinds)
        jparts.append(jh.batch_aggregate(*jargs, jaggs, 512))
    tparts = [_port_state_of(s) for s in jparts]
    for cap in (1024, 128):  # the second overflows
        tm = th.merge_partials(tparts, taggs, cap)
        jm = jh.merge_partials(jparts, jaggs, cap)
        if cap == 1024:
            _assert_states_equal(tm, jm)
        else:
            assert bool(tm.overflow) and bool(jm.overflow)
            assert int(tm.live) == int(jnp.sum(jm.valid)) == cap


def test_merge_partials_plain_flag_concatenates_to_the_same_state():
    rng = np.random.default_rng(30)
    taggs, _, kinds = _aggs(_VECTOR)
    parts = [th.batch_aggregate(*_both(rng, 1000, kinds)[0], taggs, 512)
             for _ in range(4)]
    a = th.merge_partials(parts, taggs, 1024)
    b = th.merge_partials(parts, taggs, 1024, plain=True)
    assert torch.equal(a.valid, b.valid) and int(a.live) == int(b.live)
    for x, y in zip([t for st in a.states for t in st],
                    [t for st in b.states for t in st]):
        assert torch.equal(x, y)


def test_carried_count_equals_the_reference_sum():
    """agg_count reads the count the state carries: it equals the
    reference's jnp.sum(valid) for a batch's partial, a merge, an
    overflowing merge and an empty state."""
    rng = np.random.default_rng(2)
    taggs, jaggs, kinds = _aggs(_VECTOR[:3])
    targs, jargs = _both(rng, 2000, kinds)
    pairs = [(th.batch_aggregate(*targs, taggs, 512),
              jh.batch_aggregate(*jargs, jaggs, 512))]
    pairs.append((th.merge_partials([pairs[0][0]] * 3, taggs, 1024),
                  jh.merge_partials([pairs[0][1]] * 3, jaggs, 1024)))
    pairs.append((th.merge_partials([pairs[0][0]] * 2, taggs, 64),
                  jh.merge_partials([pairs[0][1]] * 2, jaggs, 64)))
    pairs.append((th.init_state([TT.BIGINT], taggs, 64, CPU),
                  jh.init_state([JT.BIGINT], jaggs, 64)))
    for tst, jst in pairs:
        assert tagg._count_live(tst).get() == int(jagg._jit_count(jst.valid))
        assert int(tagg.count_live_plain(tst.valid)) == int(tst.live)


def test_shrink_state_matches_reference_in_new_storage():
    """agg_shrink on identical states: the reference's jitted slice and
    the port's copy hold the same rows, and every port array owns
    storage of exactly its size (ROADMAP C10)."""
    rng = np.random.default_rng(3)
    taggs, jaggs, kinds = _aggs(_VECTOR)
    _, jargs = _both(rng, 3000, kinds)
    jst = jh.batch_aggregate(*jargs, jaggs, 1024)
    tst = _port_state_of(jst)
    cap = 512
    assert int(jnp.sum(jst.valid)) <= cap
    got = tagg._shrink_state(tst, cap)
    want = jagg._shrink_state(jst, cap)
    arrays = [a for d, m in got.keys for a in (d, m)] \
        + [a for st in got.states for a in st] + [got.valid]
    wants = [a for d, m in want.keys for a in (d, m)] \
        + [a for st in want.states for a in st] + [want.valid]
    for a, w in zip(arrays, wants):
        np.testing.assert_array_equal(a.numpy(), _np(w))
        assert a.shape[0] == cap
        assert a.untyped_storage().nbytes() == a.numel() * a.element_size()
    assert int(got.live) == int(jnp.sum(want.valid))


def _assert_batches_equal(tb, jb):
    assert list(tb.columns) == list(jb.columns)
    np.testing.assert_array_equal(tb.row_valid.numpy(), _np(jb.row_valid))
    for name, jc in jb.columns.items():
        tc = tb.columns[name]
        jm = _np(jc.mask)
        np.testing.assert_array_equal(tc.mask.numpy(), jm, err_msg=name)
        g, w = tc.data.numpy()[jm], _np(jc.data)[jm]
        assert g.dtype == w.dtype, name
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-9, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
        assert tc.dictionary == jc.dictionary


@pytest.mark.parametrize("partial", [False, True],
                         ids=["finalize", "intermediate"])
@pytest.mark.parametrize("domains", [(), (3, 2)], ids=["global", "keys"])
def test_direct_drains_match_reference(partial, domains):
    """direct_finalize / direct_intermediate (K29's plain version) on
    identical slot tables, every final op."""
    rng = np.random.default_rng(4)
    taggs, jaggs, kinds = _aggs()
    if partial:
        keep = [i for i, a in enumerate(taggs) if a.intermediate_types]
        taggs = [taggs[i] for i in keep]
        jaggs = [jaggs[i] for i in keep]
        kinds = [kinds[i] for i in keep]
    slots = int(np.prod([d + 1 for d in domains])) if domains else 1
    _, jargs = _both(rng, 4000, kinds, nkeys_dom=domains)
    jst = jh.direct_step(jh.direct_init(jaggs, slots), jargs[0], jargs[1],
                         domains, jargs[2], jargs[3], jaggs)
    tst = interop.direct_state_from_numpy(
        [[_np(a) for a in st] for st in jst.states], _np(jst.present), CPU)
    names = [f"k{i}" for i in range(len(domains))]
    dicts = [tuple(f"v{j}" for j in range(d)) for d in domains]
    outs = [f"a{i}" for i in range(len(taggs))]
    tf = th.direct_intermediate if partial else th.direct_finalize
    jf = jh.direct_intermediate if partial else jh.direct_finalize
    got = tf(tst, names, [TT.VARCHAR] * len(domains), dicts, domains, outs,
             taggs)
    want = jf(jst, names, [JT.VARCHAR] * len(domains), dicts, domains, outs,
              jaggs)
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("partial", [False, True],
                         ids=["finalize", "intermediate"])
def test_sorted_drains_match_reference(partial):
    """finalize / intermediate_batch on identical sort-path states,
    every final op."""
    rng = np.random.default_rng(8)
    taggs, jaggs, kinds = _aggs()
    if partial:
        keep = [i for i, a in enumerate(taggs) if a.intermediate_types]
        taggs = [taggs[i] for i in keep]
        jaggs = [jaggs[i] for i in keep]
        kinds = [kinds[i] for i in keep]
    _, jargs = _both(rng, 4000, kinds)
    jst = jh.batch_aggregate(*jargs, jaggs, 512)
    tst = _port_state_of(jst)
    outs = [f"a{i}" for i in range(len(taggs))]
    tf = th.intermediate_batch if partial else th.finalize
    jf = jh.intermediate_batch if partial else jh.finalize
    got = tf(tst, ["k"], [TT.BIGINT], [None], outs, taggs)
    want = jf(jst, ["k"], [JT.BIGINT], [None], outs, jaggs)
    _assert_batches_equal(got, want)


def test_direct_step_with_vector_states_matches_reference():
    """The direct path's fold (K1 and K30's plain versions) over two
    batches equals the reference's, vector registers and histograms
    included."""
    rng = np.random.default_rng(9)
    taggs, jaggs, kinds = _aggs(_VECTOR)
    domains = (4, 3)
    slots = 5 * 4
    tst = th.direct_init(taggs, slots, CPU)
    jst = jh.direct_init(jaggs, slots)
    for _ in range(2):
        targs, jargs = _both(rng, 2500, kinds, nkeys_dom=domains)
        th.direct_step(tst, targs[0], targs[1], domains, targs[2],
                       targs[3], taggs)
        jst = jh.direct_step(jst, jargs[0], jargs[1], domains, jargs[2],
                             jargs[3], jaggs)
    np.testing.assert_array_equal(tst.present.numpy(), _np(jst.present))
    for ts, js in zip(tst.states, jst.states):
        for a, w in zip(ts, js):
            if np.issubdtype(_np(w).dtype, np.floating):
                np.testing.assert_allclose(a.numpy(), _np(w), rtol=1e-9)
            else:
                np.testing.assert_array_equal(a.numpy(), _np(w))


@pytest.mark.parametrize("groups,out_cap,live", [(40, 64, 0.8),
                                                 (300, 64, 0.8),
                                                 (40, 64, 0.0),
                                                 (5, 8, 1.0)],
                         ids=["fits", "overflow", "all_dead", "all_live"])
def test_segments_give_the_plain_group_ids(groups, out_cap, live):
    """K30's plain version reads K6's segments (first rows and stats),
    as the kernel does: the group ids it derives from them are the plain
    K6's ids of every live row."""
    from presto_tpu_torch.ops import agg_kernels as ak
    from presto_tpu_torch.ops import common as tc
    rng = np.random.default_rng(17)
    n = 4096
    keys = [(torch.from_numpy(rng.integers(0, groups, n)),
             torch.from_numpy(rng.random(n) < 0.95))]
    valid = torch.from_numpy(rng.random(n) < live)
    h1, h2 = tc.row_hash_pair(keys, valid, False)
    perm = tc.lex_perm([h1, h2])
    skeys = [(d[perm], m[perm]) for d, m in keys]
    sh1, sh2, svalid = h1[perm], h2[perm], valid[perm]
    seg = []
    th.segment_reduce_plain(sh1, sh2, skeys, svalid, [], out_cap, seg)
    _, want, ngroups = th.segment_ids(sh1, sh2, skeys, svalid, out_cap)
    got = ak.segment_ids_of(seg[0], n, out_cap)
    got = torch.where(svalid, got, torch.full_like(got, out_cap))
    assert torch.equal(got, want)
    assert int(seg[0].groups) == int(ngroups)
    assert int(seg[0].live) == min(int(ngroups), out_cap)


@pytest.mark.parametrize("carry_kind", ["same", "differs", "none"])
def test_stream_step_splits_vector_states_as_the_plain_fold(monkeypatch,
                                                           carry_kind):
    """The streaming round on the card runs K8 over the scalar
    components and K30 over the vector ones on K8's segments, with the
    carried group's rows folded into group 0 when K8 finds the same
    keys. Here K8 is its plain version (plus the segments and `same`
    flag it hands K30) and K30 runs its plain version on CPU tensors:
    the split and reassembly give the plain fold's states exactly."""
    from presto_tpu_torch.ops import agg_kernels as ak
    rng = np.random.default_rng(18)
    n = 3000
    aggs = [th.make_approx_percentile(0.5), th.make_sum(TT.DOUBLE,
                                                        TT.DOUBLE),
            th.make_approx_distinct(TT.BIGINT), th.make_count(None)]
    rv = torch.from_numpy(rng.random(n) < 0.9)
    keys = [(torch.from_numpy(np.sort(rng.integers(0, 200, n))),
             torch.ones(n, dtype=torch.bool))]
    x = torch.from_numpy(rng.lognormal(2.0, 1.0, n))
    inputs = [x, x, torch.from_numpy(rng.integers(0, 1 << 40, n)), None]
    w = [rv & torch.from_numpy(rng.random(n) < 0.9) for _ in aggs]
    contribs = th._make_contribs(aggs, inputs, w, [False] * len(aggs))
    carry = th.init_state([TT.BIGINT], aggs, 1, CPU)
    if carry_kind != "none":
        first = int(torch.nonzero(rv)[0])
        carry.keys[0][0][0] = keys[0][0][first] \
            - (1 if carry_kind == "differs" else 0)
        carry.keys[0][1][0] = True
        for st in carry.states:
            for a in st:
                a[0] = 2.5 if a.is_floating_point() else torch.from_numpy(
                    rng.integers(0, 9, a[0].shape)).to(a.dtype)
        carry.valid[0] = True
    launches = []

    def one_launch(row_valid, kc, cs, ags, out_cap, cy, seg_out=None):
        assert not any(isinstance(c, th.Sparse) for st in cs for c in st)
        launches.append(len(ags))
        part = th.presorted_reduce_plain(row_valid, kc, cs, ags, out_cap)
        out = th.stream_fold_plain(cy, part, ags)
        if seg_out is not None:
            bnd, _, groups = th.presorted_ids(row_valid, kc, out_cap)
            same = cy.valid[0] & (groups > 0) & ~out[0].valid[0]
            seg_out.append((th._segments_plain(bnd, row_valid, groups,
                                               out_cap),
                            same.to(torch.int64).reshape(1)))
        return out
    monkeypatch.setattr(th, "_stream_reduce_launch", one_launch)
    folds = []
    real = ak.vector_segments

    def counting(*a, **kw):
        folds.append(kw.get("carry") is not None)
        return real(*a, **kw)
    monkeypatch.setattr(ak, "vector_segments", counting)
    got = th._stream_reduce_cuda(rv, keys, contribs, aggs, n, carry)
    want = th.stream_fold_plain(
        carry, th.presorted_reduce_plain(rv, keys, contribs, aggs, n), aggs)
    assert launches == [4] and folds == [True, True]
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g.valid, w.valid)
        for gs, ws in zip(g.states, w.states):
            for ga, wa in zip(gs, ws):
                assert ga.shape == wa.shape
                assert torch.equal(ga[g.valid], wa[w.valid])
    assert int(got[3]) == int(want[3])
