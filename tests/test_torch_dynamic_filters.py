"""The dynamic-filter family's plain versions (K21 `bounds_step_plain`,
K22 `distinct_set_plain`, K23 `apply_filter_plain`) against the
reference's `bounds_step`, `distinct_set` and `apply_filter`
(presto_tpu/execution/dynamic_filters.py:177, :210, :242; JAX on the
CPU), over every key dtype with NaN, both zeros, NULL and dead rows,
the dtype max as a real key, 4096 and 4097 distinct values; K21's
plain version also over an empty batch, an all-NaN batch and zero
bounds (each zero as +0.0, bitwise, as K21 writes it). Everything is
exact (floats compared with ==, so -0.0 equals +0.0 as the reference's
dedupe has it). K21-K23 are held against these plain versions on the
card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from presto_tpu import batch as rbatch
from presto_tpu import types as rtypes
from presto_tpu.execution import dynamic_filters as rdf
from presto_tpu_torch import batch as pbatch
from presto_tpu_torch import types as ptypes
from presto_tpu_torch.execution import dynamic_filters as pdf

DTYPES = {"int32": np.int32, "int64": np.int64, "float32": np.float32,
          "float64": np.float64, "date": np.int32, "int16": np.int16,
          "int8": np.int8}
SQL_TYPES = {"int32": "integer", "int64": "bigint", "float32": "real",
             "float64": "double", "date": "date", "int16": "smallint",
             "int8": "tinyint"}


def _keys(dt, n, distinct, seed, special=True):
    """n keys of `dt` drawn from `distinct` values, with the dtype's max
    (and for floats NaN, -0.0 and +0.0) among them; a mask with NULLs
    and dead rows folded in."""
    rng = np.random.default_rng(seed)
    npdt = DTYPES[dt]
    if np.issubdtype(npdt, np.floating):
        pool = rng.permutation(np.arange(distinct) * 1.5 - 40)
    else:
        pool = rng.permutation(np.arange(distinct) * 3 - 17)
    # every pool value once, live, then random draws
    x = np.concatenate([pool, pool[rng.integers(0, distinct,
                                                n - distinct)]])
    x = x[rng.permutation(n)].astype(npdt)
    if special:
        info = np.finfo(npdt) if np.issubdtype(npdt, np.floating) \
            else np.iinfo(npdt)
        x[1] = info.max
        x[2] = info.min
        if np.issubdtype(npdt, np.floating):
            x[3], x[4], x[5] = np.nan, -0.0, 0.0
    mask = rng.random(n) > 0.1
    # NULL or dead draws never hide a value: re-add the masked ones
    lost = np.setdiff1d(pool.astype(npdt), x[mask])
    idx = np.nonzero(~mask)[0][:len(lost)]
    x[idx] = lost
    mask[idx] = True
    return x, mask


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and bool(np.all((a == b) | (np.isnan(a) & np.isnan(b))
                        if np.issubdtype(a.dtype, np.floating)
                        else a == b))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_bounds_step_matches_reference(dt):
    rstate = rdf.bounds_init(jnp.dtype(DTYPES[dt]))
    pstate = pdf.bounds_init(torch.from_numpy(np.zeros(1, DTYPES[dt]))
                             .dtype, torch.device("cpu"))
    for step in range(3):
        x, m = _keys(dt, 2500 + 700 * step, 300, seed=step)
        if step == 2:
            m[:] = False  # a batch of NULL or dead keys: identity
        rstate = rdf.bounds_step(rstate, jnp.asarray(x), jnp.asarray(m))
        pstate = pdf.bounds_step(pstate, torch.from_numpy(x),
                                 torch.from_numpy(m))
        for r, p in zip(rstate, pstate):
            assert _eq(r, p.numpy())


def _bits(t):
    return t.reshape(1).view(torch.uint8).tolist()


@pytest.mark.parametrize("dt", list(DTYPES))
def test_bounds_step_plain_edge_cases(dt):
    """An empty batch leaves the state as it was; an all-NaN (or
    all-NULL) batch too; a bound at zero is +0.0 bitwise, whether the
    keys held -0.0, +0.0 or both, and whether the running state did."""
    npdt = DTYPES[dt]
    tdt = torch.from_numpy(np.zeros(1, npdt)).dtype
    init = pdf.bounds_init(tdt, torch.device("cpu"))
    empty = torch.zeros(0, dtype=tdt)
    got = pdf.bounds_step_plain(init, empty, torch.zeros(0, dtype=torch.bool))
    assert all(_bits(g) == _bits(w) for g, w in zip(got, init))
    x = np.full(50, np.nan if "float" in dt else 5, npdt)
    m = np.ones(50, bool) if "float" in dt else np.zeros(50, bool)
    got = pdf.bounds_step_plain(init, torch.from_numpy(x),
                                torch.from_numpy(m))
    assert all(_bits(g) == _bits(w) for g, w in zip(got, init))
    want = rdf.bounds_step(rdf.bounds_init(jnp.dtype(npdt)), jnp.asarray(x),
                           jnp.asarray(m))
    assert all(_eq(r, g.numpy()) for r, g in zip(want, got))
    zero = torch.zeros((), dtype=tdt)
    for vals in ([-0.0, -0.0], [0.0, -0.0], [-0.0, 0.0, 3.0],
                 [-2.0, -0.0]):
        x = np.array(vals, npdt)
        got = pdf.bounds_step_plain(init, torch.from_numpy(x),
                                    torch.ones(len(x), dtype=torch.bool))
        want = rdf.bounds_step(rdf.bounds_init(jnp.dtype(npdt)),
                               jnp.asarray(x), jnp.ones(len(x), bool))
        assert all(_eq(r, g.numpy()) for r, g in zip(want, got))
        if "float" in dt:
            lo, hi = got
            assert _bits(lo) == _bits(zero) or float(lo) < 0
            assert _bits(hi) == _bits(zero) or float(hi) > 0
    if "float" in dt:
        # a running state at -0.0 comes out as +0.0
        neg = torch.tensor(-0.0, dtype=tdt)
        for keys in (empty, torch.tensor([np.nan], dtype=tdt)):
            got = pdf.bounds_step_plain(
                (neg, neg), keys, torch.ones(len(keys), dtype=torch.bool))
            assert all(_bits(g) == _bits(zero) for g in got)


@pytest.mark.parametrize("dt,size", [
    (dt, size) for dt in DTYPES
    for size in ("one", "few", "full", "over", "far")
    # TINYINT holds 256 values: never a full set
    if dt != "int8" or size not in ("full", "over")])
def test_distinct_set_matches_reference(dt, size):
    """The dtype's max and min (and for floats the zero, written as
    -0.0 and +0.0) join the drawn values: "full" is exactly DF_SET_MAX
    distinct keys, "over" one more (overflow)."""
    extra = 3 if "float" in dt else 2
    distinct = {"one": 1, "few": 25, "full": 4096 - extra,
                "over": 4097 - extra, "far": 5000}[size]
    x, m = _keys(dt, 12000, distinct, seed=distinct)
    rv, rn, ro = rdf.distinct_set(jnp.asarray(x), jnp.asarray(m))
    pv, pn, po = pdf.distinct_set(torch.from_numpy(x), torch.from_numpy(m))
    assert int(pn) == int(rn) and bool(po) == bool(ro)
    assert _eq(rv, pv.numpy())
    assert pn.dtype == torch.int64 and po.dtype == torch.bool
    if size == "full":
        assert int(pn) == pdf.DF_SET_MAX and not bool(po)
    if size == "over":
        assert int(pn) == pdf.DF_SET_MAX + 1 and bool(po)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("with_set", [False, True])
def test_apply_filter_matches_reference(dt, with_set):
    bx, bm = _keys(dt, 3000, 40, seed=1, special=False)
    px, pm = _keys(dt, 5000, 60, seed=2)
    rng = np.random.default_rng(9)
    rvalid = rng.random(5000) > 0.2
    typ = SQL_TYPES[dt]
    rstate = rdf.bounds_step(rdf.bounds_init(jnp.dtype(DTYPES[dt])),
                             jnp.asarray(bx), jnp.asarray(bm))
    pstate = pdf.bounds_step(
        pdf.bounds_init(torch.from_numpy(bx).dtype, torch.device("cpu")),
        torch.from_numpy(bx), torch.from_numpy(bm))
    rb = rbatch.Batch.from_numpy({"k": px}, {"k": rtypes.parse_type(typ)},
                                 {"k": pm}, capacity=5000)
    rb = rbatch.Batch(rb.columns, jnp.asarray(rvalid))
    pb = pbatch.Batch.from_numpy({"k": px}, {"k": ptypes.parse_type(typ)},
                                 {"k": pm}, capacity=5000)
    pb = pbatch.Batch(pb.columns, torch.from_numpy(rvalid))
    if with_set:
        rset = rdf.distinct_set(jnp.asarray(bx), jnp.asarray(bm))
        pset = pdf.distinct_set(torch.from_numpy(bx), torch.from_numpy(bm))
        rout = rdf.apply_filter(rb, "k", *rstate, True, rset[0], rset[1])
        pout = pdf.apply_filter(pb, "k", *pstate, True, pset[0], pset[1])
    else:
        rout = rdf.apply_filter(rb, "k", *rstate, False)
        pout = pdf.apply_filter(pb, "k", *pstate, False)
    assert np.array_equal(np.asarray(rout.row_valid), pout.row_valid.numpy())
    assert pout.row_valid.sum() > 0


def test_narrow_key_join_matches_reference():
    """A join on SMALLINT, and one on TINYINT, keys runs its dynamic
    filter (the family is called) and returns the reference's rows
    (DOUBLE rel_tol 1e-6, everything else exact)."""
    from presto_tpu.runner import LocalRunner as RefRunner
    from presto_tpu_torch.runner import LocalRunner
    from presto_tpu_torch.telemetry import kernels as tk
    from test_tpch_suite import assert_rows_equal
    from test_torch_cuda import NARROW_KEY_QUERIES, narrow_key_rows
    before = tk.CALLS["dynamic_filter"]
    got = narrow_key_rows(LocalRunner("tpch", "tiny", device="cpu"))
    assert tk.CALLS["dynamic_filter"] > before
    want = narrow_key_rows(RefRunner("tpch", "tiny"))
    for sql, g, w in zip(NARROW_KEY_QUERIES, got, want):
        assert g, sql
        assert_rows_equal(g, w, sql, True)


@pytest.mark.parametrize("dt", [torch.int32, torch.int64, torch.float32,
                                torch.float64, torch.int16, torch.int8])
def test_set_outputs_are_views_of_one_buffer(dt):
    """K22's values, count and flag: one allocation, three views that
    do not overlap."""
    vals, count, ovf = pdf.set_outputs(dt, torch.device("cpu"))
    assert vals.shape == (pdf.DF_SET_MAX,) and vals.dtype == dt
    assert vals.is_contiguous()
    assert count.shape == () and count.dtype == torch.int64
    assert ovf.shape == () and ovf.dtype == torch.bool
    base = vals.untyped_storage().data_ptr()
    assert count.untyped_storage().data_ptr() == base
    assert ovf.untyped_storage().data_ptr() == base
    assert count.data_ptr() % 8 == 0
    vals.fill_(0)
    count.fill_(-1)
    ovf.fill_(True)
    assert not vals.ne(0).any() and int(count) == -1 and bool(ovf)


def test_set_scratch_starts_empty_and_is_kept(monkeypatch):
    """K22's table starts EMPTY (all ones) and its four state words at
    0, once per (device, stream)."""
    class Lib:
        @staticmethod
        def presto_df_set_scratch_words():
            return 2 * pdf.DF_SET_MAX + 4
    monkeypatch.setattr(pdf, "_SET_SCRATCH", {})
    dev = torch.device("cpu")
    s = pdf._set_scratch(Lib(), dev, 3)
    assert s.dtype == torch.int64 and s.shape == (2 * pdf.DF_SET_MAX + 4,)
    assert bool((s[:2 * pdf.DF_SET_MAX] == -1).all())
    assert not s[2 * pdf.DF_SET_MAX:].any()
    assert pdf._set_scratch(Lib(), dev, 3) is s
    assert pdf._set_scratch(Lib(), dev, 4) is not s
