"""The port's direct aggregation (K1) and compaction (K2) against the JAX
package's, over the same seeded numpy inputs.

On the CPU the port runs the kernels' plain versions: they must match
the reference's `_slot_reduce` / `direct_step` (integers exactly,
float64 to rel 1e-9: the port reduces with `index_add_`, the reference
with `segment_sum`, in possibly different orders) and its
`_compact_jit` / `_compact_shrink_jit` exactly (the output row order is
the result). The CUDA kernels are held against the plain versions in
tests/test_torch_cuda.py, which runs only on an sm_90 card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu import batch as jb
from presto_tpu.ops import hashagg as jh
from presto_tpu.types import BIGINT, DOUBLE, INTEGER, VARCHAR

from presto_tpu_torch import batch as tb
from presto_tpu_torch import interop
from presto_tpu_torch.ops import hashagg as th
from presto_tpu_torch import types as tt

CPU = torch.device("cpu")
FLOAT_RTOL = 1e-9

# one intra-op thread: see tests/test_torch_tpch.py
torch.set_num_threads(1)


def _np(x):
    return np.asarray(x)


def _t(x, device=CPU):
    return torch.from_numpy(np.array(x)).to(device)


# -- K1: direct aggregation -------------------------------------------

#: (name, reference factory, port factory, input dtype)
AGG_CASES = [
    ("sum_double", lambda: jh.make_sum(DOUBLE, DOUBLE),
     lambda: th.make_sum(tt.DOUBLE, tt.DOUBLE), np.float64),
    ("sum_bigint", lambda: jh.make_sum(BIGINT, BIGINT),
     lambda: th.make_sum(tt.BIGINT, tt.BIGINT), np.int64),
    ("min_double", lambda: jh.make_min(DOUBLE),
     lambda: th.make_min(tt.DOUBLE), np.float64),
    ("max_bigint", lambda: jh.make_max(BIGINT),
     lambda: th.make_max(tt.BIGINT), np.int64),
    ("min_integer", lambda: jh.make_min(INTEGER),
     lambda: th.make_min(tt.INTEGER), np.int32),
    ("avg_double", lambda: jh.make_avg(DOUBLE),
     lambda: th.make_avg(tt.DOUBLE), np.float64),
    ("count_star", lambda: jh.make_count(None),
     lambda: th.make_count(None), None),
]


def _agg_inputs(rng, n, dtype):
    if dtype is None:
        return None
    if dtype == np.float64:
        return rng.normal(100.0, 50.0, n)
    return rng.integers(-10_000, 10_000, n).astype(dtype)


def _assert_state_equal(jstate, tstate):
    np.testing.assert_array_equal(_np(jstate.present),
                                  tstate.present.numpy())
    for jcomps, tcomps in zip(jstate.states, tstate.states):
        for ja, ta in zip(jcomps, tcomps):
            ja, ta = _np(ja), ta.numpy()
            assert ja.dtype == ta.dtype
            if ja.dtype.kind == "f":
                np.testing.assert_allclose(ta, ja, rtol=FLOAT_RTOL)
            else:
                np.testing.assert_array_equal(ta, ja)


@pytest.mark.parametrize("domains", [(), (3,), (3, 2), (4, 1, 2)],
                         ids=lambda d: "keys" + "x".join(map(str, d)))
def test_direct_step_matches_reference(domains):
    """Two direct_step folds over seeded batches with NULL keys, NULL
    inputs and dead rows: same slot tables, same finalized batch."""
    rng = np.random.default_rng(len(domains) * 7 + 1)
    n = 2048
    num_slots = int(np.prod([d + 1 for d in domains])) if domains else 1
    jaggs = [c[1]() for c in AGG_CASES]
    taggs = [c[2]() for c in AGG_CASES]
    jstate = jh.direct_init(jaggs, num_slots)
    # the port starts from the reference's initial table, carried over
    # as numpy; it must equal the port's own initial table
    tstate = interop.direct_state_from_numpy(
        [[_np(a) for a in st] for st in jstate.states],
        _np(jstate.present), CPU)
    _assert_state_equal(jh.direct_init(jaggs, num_slots),
                        th.direct_init(taggs, num_slots, CPU))
    for _ in range(2):
        row_valid = rng.random(n) < 0.8
        keys = [(rng.integers(0, d, n).astype(np.int32),
                 rng.random(n) < 0.9) for d in domains]
        inputs = [_agg_inputs(rng, n, c[3]) for c in AGG_CASES]
        in_masks = [rng.random(n) < 0.85 for _ in AGG_CASES]
        weights = [row_valid & m for m in in_masks]
        jstate = jh.direct_step(
            jstate, jnp.asarray(row_valid),
            [(jnp.asarray(c), jnp.asarray(m)) for c, m in keys],
            domains, [None if x is None else jnp.asarray(x)
                      for x in inputs],
            [jnp.asarray(w) for w in weights], jaggs)
        tstate = th.direct_step(
            tstate, _t(row_valid), [(_t(c), _t(m)) for c, m in keys],
            domains, [None if x is None else _t(x) for x in inputs],
            [_t(w) for w in weights], taggs)
        _assert_state_equal(jstate, tstate)
    names = [f"k{i}" for i in range(len(domains))]
    dicts = [tuple(f"v{j}" for j in range(d)) for d in domains]
    out_names = [c[0] for c in AGG_CASES]
    jout = jh.direct_finalize(jstate, names, [VARCHAR] * len(domains),
                              dicts, domains, out_names, jaggs)
    tout = th.direct_finalize(tstate, names, [tt.VARCHAR] * len(domains),
                              dicts, domains, out_names, taggs)
    jrows, trows = jout.to_pylist(), tout.to_pylist()
    assert len(jrows) == len(trows)
    for jr, tr in zip(jrows, trows):
        for jv, tv in zip(jr, tr):
            if isinstance(jv, float):
                assert tv == pytest.approx(jv, rel=FLOAT_RTOL)
            else:
                assert jv == tv


@pytest.mark.parametrize("reduce", ["sum", "min", "max"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.float64])
def test_slot_reduce_matches_reference(reduce, dtype):
    """One component through the reference's `_slot_reduce` and the
    port's plain K1 (dead rows in the drop slot)."""
    rng = np.random.default_rng(11)
    n, num_slots = 4096, 12
    gid = rng.integers(0, num_slots + 1, n).astype(np.int32)
    contrib = (rng.normal(0.0, 1e3, n) if dtype == np.float64
               else rng.integers(-1 << 20, 1 << 20, n)).astype(dtype)
    ref = _np(jh._slot_reduce(jnp.asarray(contrib), jnp.asarray(gid),
                              num_slots, reduce, dtype))
    # the port reduces into an identity-initialized state in place
    tdt = torch.from_numpy(np.zeros(0, dtype)).dtype
    state = torch.full((num_slots,), th._ident_for(reduce, tdt),
                       dtype=tdt)
    row_valid = gid < num_slots
    codes = np.where(row_valid, gid, 0).astype(np.int32)
    present = torch.zeros(num_slots, dtype=torch.bool)
    th.slot_reduce_plain(_t(row_valid), [(_t(codes), _t(row_valid))],
                         (num_slots,), [(_t(contrib), state, reduce)],
                         present)
    if dtype == np.float64:
        np.testing.assert_allclose(state.numpy(), ref, rtol=FLOAT_RTOL)
    else:
        np.testing.assert_array_equal(state.numpy(), ref)
    np.testing.assert_array_equal(present.numpy(),
                                  np.bincount(gid, minlength=num_slots + 1)
                                  [:num_slots] > 0)


# -- K2: compaction ---------------------------------------------------

def _batch_pair(live_frac, cap=4096, seed=5):
    """The same seeded batch as a reference Batch and a port Batch:
    BIGINT, DOUBLE, INTEGER and dictionary VARCHAR columns with NULLs
    and dead rows."""
    rng = np.random.default_rng(seed)
    row_valid = rng.random(cap) < live_frac
    spec = {
        "a": (rng.integers(-1 << 40, 1 << 40, cap), "bigint", None),
        "b": (rng.normal(0, 1, cap), "double", None),
        "c": (rng.integers(0, 1 << 20, cap).astype(np.int32), "integer",
              None),
        "s": (rng.integers(0, 3, cap).astype(np.int32), "varchar",
              ("x", "y", "z")),
    }
    cols = {n: (d, rng.random(cap) < 0.9, t, dic)
            for n, (d, t, dic) in spec.items()}
    jtypes = {"bigint": BIGINT, "double": DOUBLE, "integer": INTEGER,
              "varchar": VARCHAR}
    jbatch = jb.Batch(
        {n: jb.Column(jnp.asarray(d), jnp.asarray(m), jtypes[t], dic)
         for n, (d, m, t, dic) in cols.items()}, jnp.asarray(row_valid))
    tbatch = interop.batch_from_numpy(cols, row_valid, CPU)
    return jbatch, tbatch


def _assert_batches_identical(jbatch, tbatch):
    np.testing.assert_array_equal(_np(jbatch.row_valid),
                                  tbatch.row_valid.numpy())
    assert jbatch.names == tbatch.names
    for n in jbatch.names:
        jc, tc = jbatch.columns[n], tbatch.columns[n]
        np.testing.assert_array_equal(_np(jc.data), tc.data.numpy())
        np.testing.assert_array_equal(_np(jc.mask), tc.mask.numpy())
        assert jc.dictionary == tc.dictionary


@pytest.mark.parametrize("live_frac", [0.0, 0.02, 0.5, 0.98, 1.0])
def test_compact_full_matches_reference(live_frac):
    jbatch, tbatch = _batch_pair(live_frac)
    _assert_batches_identical(jb._compact_jit(jbatch),
                              tb.compact_full(tbatch))


@pytest.mark.parametrize("live_frac,out_cap",
                         [(0.0, 1024), (0.02, 1024), (0.2, 1024),
                          (0.5, 2048), (0.98, 4096)])
def test_compact_shrink_matches_reference(live_frac, out_cap):
    jbatch, tbatch = _batch_pair(live_frac)
    _assert_batches_identical(jb._compact_shrink_jit(jbatch, out_cap),
                              tb.compact_shrink(tbatch, out_cap))


def test_compact_counts_its_family():
    from presto_tpu_torch.telemetry import kernels as tk
    _, tbatch = _batch_pair(0.5, cap=256)
    before = tk.CALLS["compact"]
    tbatch.compact()
    tbatch.compact(192, known_valid=int(tbatch.row_valid.sum()))
    assert tk.CALLS["compact"] == before + 2


# -- ops/common: ordering helpers ---------------------------------------

@pytest.mark.parametrize("desc,nulls_first",
                         [((False, False), (False, False)),
                          ((True, False), (False, True)),
                          ((False, True), (True, False))])
def test_sort_rows_and_boundaries_match_reference(desc, nulls_first):
    from presto_tpu.ops import common as jc
    from presto_tpu_torch.ops import common as tc
    rng = np.random.default_rng(9)
    n = 512
    keys = [(rng.integers(0, 5, n).astype(np.int32), rng.random(n) < 0.8),
            (rng.normal(0, 1, n).round(1), rng.random(n) < 0.9)]
    valid = rng.random(n) < 0.7
    payload = np.arange(n, dtype=np.int64)
    jk, jv, jp = jc.sort_rows(
        [(jnp.asarray(d), jnp.asarray(m)) for d, m in keys], list(desc),
        list(nulls_first), valid=jnp.asarray(valid),
        payloads=[jnp.asarray(payload)])
    tk_, tv, tp = tc.sort_rows(
        [(_t(d), _t(m)) for d, m in keys], list(desc), list(nulls_first),
        valid=_t(valid), payloads=[_t(payload)])
    np.testing.assert_array_equal(_np(jp[0]), tp[0].numpy())
    np.testing.assert_array_equal(_np(jv), tv.numpy())
    np.testing.assert_array_equal(
        _np(jc.boundaries(jk, jv)), tc.boundaries(tk_, tv).numpy())
    np.testing.assert_array_equal(
        _np(jc.partition_perm(jnp.asarray(valid))),
        tc.partition_perm(_t(valid)).numpy())
