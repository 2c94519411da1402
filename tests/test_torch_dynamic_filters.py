"""The dynamic-filter family's plain versions (K21 `bounds_step_plain`,
K22 `distinct_set_plain`, K23 `apply_filter_plain`) against the
reference's `bounds_step`, `distinct_set` and `apply_filter`
(presto_tpu/execution/dynamic_filters.py:177, :210, :242; JAX on the
CPU), over every key dtype with NaN, both zeros, NULL and dead rows,
the dtype max as a real key, 4096 and 4097 distinct values. K21's
Triton source runs through tests/triton_standin.py (extended here by
the reductions and scalar pointers it uses). Everything is
exact (floats compared with ==, so -0.0 equals +0.0 as the reference's
dedupe has it)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import triton_standin as standin
from presto_tpu import batch as rbatch
from presto_tpu import types as rtypes
from presto_tpu.execution import dynamic_filters as rdf
from presto_tpu_torch import batch as pbatch
from presto_tpu_torch import types as ptypes
from presto_tpu_torch.execution import dynamic_filters as pdf

@pytest.fixture
def k21_standin(monkeypatch):
    """tests/triton_standin.py extended by what K21's source uses beyond
    the fragment kernels: block reductions (tl.min / tl.max), a block
    value's dtype, and scalar pointers (a 0-d tensor argument loaded or
    stored whole, and a pointer plus an integer)."""
    T, Ptr, tl = standin.T, standin.Ptr, standin.tl
    load, store = tl.load, tl.store

    def add(self, offs):
        o = torch.as_tensor(T._v(offs)).to(torch.int64)
        return Ptr(self.base, o if self.offs is None else self.offs + o)

    def scalar_load(ptr, mask=None, other=None):
        if ptr.offs is None:
            return T(ptr.base.reshape(-1)[0])
        return load(ptr, mask=mask, other=other)

    def scalar_store(ptr, val, mask=None):
        if ptr.offs is None:
            ptr.base.reshape(-1)[0] = T._v(val)
            return
        store(ptr, val, mask=mask)

    monkeypatch.setattr(Ptr, "__add__", add)
    monkeypatch.setattr(T, "dtype", property(lambda self: self.t.dtype),
                        raising=False)
    monkeypatch.setattr(tl, "load", scalar_load)
    monkeypatch.setattr(tl, "store", scalar_store)
    monkeypatch.setattr(tl, "min", lambda x, axis=0: T(T._v(x).min()),
                        raising=False)
    monkeypatch.setattr(tl, "max", lambda x, axis=0: T(T._v(x).max()),
                        raising=False)

    def load_fn(name):
        body = "\n".join(line for line in pdf.BOUNDS_SOURCE.splitlines()
                         if not line.startswith("import triton"))
        g = {"triton": standin.triton, "tl": tl}
        exec(compile(body, "<k21>", "exec"), g)
        return g[name]
    return load_fn


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
def test_bounds_step_matches_reference(dt, k21_standin):
    rstate = rdf.bounds_init(jnp.dtype(DTYPES[dt]))
    pstate = pdf.bounds_init(torch.from_numpy(np.zeros(1, DTYPES[dt]))
                             .dtype, torch.device("cpu"))
    sstate = pstate
    partial = k21_standin("bounds_partial")
    fold = k21_standin("bounds_fold")
    for step in range(3):
        x, m = _keys(dt, 2500 + 700 * step, 300, seed=step)
        if step == 2:
            m[:] = False  # a batch of NULL or dead keys: identity
        rstate = rdf.bounds_step(rstate, jnp.asarray(x), jnp.asarray(m))
        tx, tm = torch.from_numpy(x), torch.from_numpy(m)
        pstate = pdf.bounds_step(pstate, tx, tm)
        sstate = pdf.bounds_launch(partial, fold, sstate, tx, tm)
        for r, p, s in zip(rstate, pstate, sstate):
            assert _eq(r, p.numpy()) and _eq(r, s.numpy())


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


def test_k21_source_declares_two_stages(k21_standin):
    assert "def bounds_partial" in pdf.BOUNDS_SOURCE
    assert "def bounds_fold" in pdf.BOUNDS_SOURCE
    # bounds_launch allocates one partial per BOUNDS_BLOCK rows
    x = torch.arange(3 * pdf.BOUNDS_BLOCK + 5, dtype=torch.int64)
    m = torch.ones_like(x, dtype=torch.bool)
    calls = []

    class Rec:
        def __init__(self, fn):
            self.fn = fn

        def __getitem__(self, grid):
            calls.append(grid)
            return self.fn[grid]

    out = pdf.bounds_launch(
        Rec(k21_standin("bounds_partial")),
        Rec(k21_standin("bounds_fold")),
        pdf.bounds_init(torch.int64, torch.device("cpu")), x, m)
    assert calls == [(4,), (1,)]
    assert [int(t) for t in out] == [0, 3 * pdf.BOUNDS_BLOCK + 4]


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
