"""DISTINCT's fold on the CPU: the plain version of K33
(`distinct_step_plain`, csrc/distinct_set.cu's twin) against the JAX
package's `_distinct_step_impl` (presto_tpu/ops/sort.py:106).

- Over several batches, the live rows of both states are the same set
  (compared sorted, data bitwise, so NaN equals NaN): NULLs with other
  data under the mask, NaN keys (never merged) and -0.0 against +0.0,
  a batch of duplicates only and one of new rows only, a VARCHAR key on
  its dictionary, BOOLEAN to BIGINT, REAL, DATE, ten keys (two of K33's
  key groups), and a state that fills exactly.
- The layout, slot for slot, against a Python model of the fold: the
  state's live rows where they lie, the batch's new rows after them in
  batch order, each group's first row kept, dead slots zero with their
  masks clear; a state that overflows keeps the first `capacity`
  groups and reads full, as the reference's does.
- DistinctOperator's growth protocol and the fused distinct terminal
  through `LocalRunner("tpch", "tiny", device="cpu")` on DISTINCT and
  UNION queries, against the reference's LocalRunner.

The CUDA kernel is held against this plain version slot for slot in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_tpch_suite import assert_rows_equal
from test_tpch_suite import runner  # noqa: F401 (fixture)

from presto_tpu import batch as jb
from presto_tpu import types as jt
from presto_tpu.ops import sort as js

from presto_tpu_torch import batch as tb
from presto_tpu_torch import types as tt
from presto_tpu_torch.ops import sort as ts

# one intra-op thread: see tests/test_torch_tpch.py
torch.set_num_threads(1)

FLOATS = np.array([np.nan, -0.0, 0.0, -np.inf, np.inf, 1.5, -2.25])


def _col(kind, data, mask, dictionary=None):
    return (kind, np.asarray(data, jt.Type(kind).np_dtype),
            np.asarray(mask, bool), dictionary)


def _case(name, rng, step, cap):
    """Batch `step` of case `name`: {column: (kind, data, mask,
    dictionary)} and row_valid, of `cap` rows."""
    if name == "nulls_under_mask":
        mask = rng.random(cap) < 0.5
        # data under a NULL varies: it must not split the NULL group
        data = np.where(mask, rng.integers(0, 6, cap),
                        rng.integers(-10**9, 10**9, cap))
        cols = {"a": _col("bigint", data, mask),
                "b": _col("integer", rng.integers(0, 2, cap),
                          rng.random(cap) < 0.7)}
    elif name == "nan_and_signed_zeros":
        cols = {"x": _col("double", rng.choice(FLOATS, cap),
                          rng.random(cap) < 0.9),
                "y": _col("real", rng.choice(FLOATS[:3], cap),
                          np.ones(cap, bool))}
    elif name == "all_duplicates":
        # every batch holds the same 40 rows in another order
        base = np.random.default_rng(0).integers(0, 40, cap) % 40
        cols = {"a": _col("integer", rng.permutation(base),
                          np.ones(cap, bool))}
    elif name == "all_new":
        cols = {"a": _col("bigint", step * 10**6 + np.arange(cap),
                          np.ones(cap, bool)),
                "b": _col("double", np.arange(cap) * 0.5,
                          np.ones(cap, bool))}
    elif name == "varchar":
        words = ("AIR", "FOB", "MAIL", "RAIL", "SHIP", "TRUCK")
        cols = {"s": _col("varchar", rng.integers(0, 6, cap),
                          rng.random(cap) < 0.85, words),
                "k": _col("integer", rng.integers(0, 3, cap),
                          np.ones(cap, bool))}
    elif name == "narrow_types":
        cols = {"f": _col("boolean", rng.random(cap) < 0.5,
                          rng.random(cap) < 0.9),
                "t": _col("tinyint", rng.integers(-128, 128, cap) % 3,
                          np.ones(cap, bool)),
                "s": _col("smallint", rng.integers(-2, 2, cap),
                          rng.random(cap) < 0.9),
                "d": _col("date", rng.integers(8000, 8003, cap),
                          np.ones(cap, bool))}
    elif name == "ten_keys":
        cols = {f"k{j}": _col("integer" if j % 2 else "bigint",
                              rng.integers(0, 2 if j < 9 else 3, cap),
                              rng.random(cap) < 0.97)
                for j in range(10)}
    elif name == "fills_exactly":
        # 64 groups in all across the batches, into 64 slots
        cols = {"a": _col("bigint", rng.integers(0, 64, cap),
                          np.ones(cap, bool))}
        if step == 0:
            cols["a"][1][:64] = np.arange(64)
    else:
        raise KeyError(name)
    rv = rng.random(cap) < 0.9
    if name == "fills_exactly" and step == 0:
        rv[:64] = True
    return cols, rv


#: case -> (batch rows, state capacity)
CASES = {"nulls_under_mask": (256, 256), "nan_and_signed_zeros": (512, 2048),
         "all_duplicates": (256, 64), "all_new": (128, 512),
         "varchar": (256, 64), "narrow_types": (512, 256),
         "ten_keys": (2048, 8192), "fills_exactly": (64, 64)}


def _torch(cols, rv):
    return tb.Batch({n: tb.Column(torch.from_numpy(d.copy()),
                                  torch.from_numpy(m.copy()), tt.Type(k), dic)
                     for n, (k, d, m, dic) in cols.items()},
                    torch.from_numpy(rv.copy()))


def _jax(cols, rv):
    return jb.Batch({n: jb.Column(jnp.asarray(d), jnp.asarray(m), jt.Type(k),
                                  dic)
                     for n, (k, d, m, dic) in cols.items()}, jnp.asarray(rv))


def _bits(x):
    x = np.asarray(x)
    if x.dtype.kind == "f":
        return x.astype(np.float64).view(np.int64)
    return x.astype(np.int64)


def _live_rows(batch):
    """The live rows as tuples: None for NULL, else the value's bits."""
    rv = np.asarray(batch.row_valid)
    cols = [(_bits(batch.columns[n].data), np.asarray(batch.columns[n].mask))
            for n in batch.names]
    return [tuple(int(d[i]) if m[i] else None for d, m in cols)
            for i in np.nonzero(rv)[0]]


def _schema(cols, pkg):
    return [(n, pkg.Type(k), dic) for n, (k, _, _, dic) in cols.items()]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_fold_keeps_the_reference_rows(name):
    rng = np.random.default_rng(sorted(CASES).index(name))
    rows, cap = CASES[name]
    cols, rv = _case(name, rng, 0, rows)
    tstate = ts.distinct_state(_schema(cols, tt), cap, torch.device("cpu"))
    jstate = js.distinct_state(_schema(cols, jt), cap)
    for step in range(3):
        if step:
            cols, rv = _case(name, rng, step, rows)
        tstate = ts.distinct_step_plain(tstate, _torch(cols, rv))
        jstate = js._distinct_step_impl(jstate, _jax(cols, rv))
        got, want = _live_rows(tstate), _live_rows(jstate)
        assert sorted(got, key=repr) == sorted(want, key=repr)
        assert len(got) == len(set(got)) or name == "nan_and_signed_zeros"
    if name == "fills_exactly":
        assert len(got) == cap
    if name == "all_new":
        assert len(got) > 2 * rows


def _row_key(row, kinds):
    """The fold's group of one row: NULL equals NULL, values by their
    bits, a NaN equals nothing (a fresh object)."""
    out = []
    for v, k in zip(row, kinds):
        if v is not None and k in ("double", "real") \
                and np.isnan(np.int64(v).view(np.float64)):
            return object()
        out.append(v)
    return tuple(out)


def _model(state_rows, batch_rows, kinds, cap):
    seen, kept = set(), []
    for row in state_rows + batch_rows:
        key = _row_key(row, kinds)
        if key not in seen:
            seen.add(key)
            kept.append(row)
    return kept[:cap]


@pytest.mark.parametrize("name", ["nulls_under_mask", "nan_and_signed_zeros",
                                  "varchar", "ten_keys", "overflow"])
def test_plain_fold_layout_is_state_then_new_batch_rows(name):
    """Slot for slot: the state's rows where they lie, then the batch's
    new rows in batch order (each group's first row), dead slots zero
    with clear masks. "overflow" folds more groups than the capacity:
    the first `capacity` groups are kept and the state reads full, like
    the reference's (whose kept groups follow its hash order)."""
    rng = np.random.default_rng(5 + len(name))
    over = name == "overflow"
    case = "nulls_under_mask" if over else name
    rows, cap = CASES[case]
    cap = 64 if over else cap
    cols, rv = _case(case, rng, 0, rows)
    kinds = [k for k, _, _, _ in cols.values()]
    state = ts.distinct_state(_schema(cols, tt), cap, torch.device("cpu"))
    jstate = js.distinct_state(_schema(cols, jt), cap)
    for step in range(3):
        if step:
            cols, rv = _case(case, rng, step, rows)
        if over:
            # 300 groups across the batches
            cols["a"] = _col("bigint", rng.integers(0, 300, rows),
                             np.ones(rows, bool))
        batch = _torch(cols, rv)
        want = _model(_live_rows(state), _live_rows(batch), kinds, cap)
        state = ts.distinct_step_plain(state, batch)
        jstate = js._distinct_step_impl(jstate, _jax(cols, rv))
        live = int(state.row_valid.sum())
        assert state.row_valid[:live].all()
        assert _live_rows(state) == want
        for n in state.names:
            c = state.columns[n]
            assert not c.mask[live:].any() and not c.data[live:].any()
        if over:
            assert live == cap == int(np.asarray(jstate.row_valid).sum())


@pytest.mark.parametrize("name", ["all_new", "varchar"])
def test_growth_re_merge_is_an_append(name):
    """DistinctOperator's growth re-merges the old state into an empty
    one of twice its capacity: every live row lands where it lay."""
    rng = np.random.default_rng(3)
    rows, cap = CASES[name]
    cols, rv = _case(name, rng, 0, rows)
    state = ts.distinct_step_plain(
        ts.distinct_state(_schema(cols, tt), cap, torch.device("cpu")),
        _torch(cols, rv))
    bigger = ts.distinct_step(
        ts.distinct_state(_schema(cols, tt), 2 * cap, torch.device("cpu")),
        state)
    live = int(state.row_valid.sum())
    assert int(bigger.row_valid.sum()) == live
    for n in state.names:
        a, b = state.columns[n], bigger.columns[n]
        assert torch.equal(a.mask[:live], b.mask[:live])
        assert torch.equal(a.data[:live], b.data[:live])


_PORT = {}


def _port(fused: bool):
    if fused not in _PORT:
        from presto_tpu_torch.runner import LocalRunner
        _PORT[fused] = LocalRunner(
            "tpch", "tiny", device="cpu",
            properties={"fragment_fusion_enabled": fused})
    return _PORT[fused]


#: DISTINCT and UNION at tiny: the first grows DISTINCT's state (4,096
#: slots) several times
RUNNER_QUERIES = {
    "distinct_pairs": "select distinct partkey, suppkey from lineitem "
                      "where shipdate >= date '1995-01-01'",
    "distinct_nullable": "select distinct o.orderpriority, c.mktsegment "
                         "from orders o left join customer c "
                         "on o.custkey = c.custkey and c.acctbal > 5000",
    "union": "select custkey from orders where orderpriority = '1-URGENT' "
             "union select custkey from customer where acctbal > 9000",
}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("label", sorted(RUNNER_QUERIES))
def test_runner_distinct_matches_reference(label, fused, runner):  # noqa: F811
    sql = RUNNER_QUERIES[label]
    got = _port(fused).execute(sql)
    want = runner.execute(sql)
    assert got.names == want.names
    assert_rows_equal(got.rows(), want.rows(), label, False)
    assert len(got.rows()) > 0
