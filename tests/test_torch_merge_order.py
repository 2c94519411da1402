"""The order K19 (csrc/merge_pair.cu) merges by, on the CPU.

K19 compares the rows of two sorted runs by the unsigned key words of
csrc/sort_code.cuh, the words K24 encodes and K25 sorts the runs by.
These tests hold the invariant it rests on, through the plain versions:

- comparing two rows by their plain K24 words (`sort_encode_plain`,
  packed at the bit positions `sort_pack_plan` gives, the plan K19's
  wrapper takes from `merge_pack_plan`) orders them exactly as
  `canonical_ops` (the plain merge's operands) does, pair by pair, over
  NaN, -0.0 / +0.0, INT64_MIN, BOOLEAN, REAL, NULLs, DESC and NULLS
  FIRST, one to three keys and dead rows;
- `merge_pair_plain` of two runs sorted by `sort_rows` is the stable
  order of their words over the union, A's rows first on ties;
- and it equals the reference's `merge_pair` where the reference's is a
  permutation of its inputs (it is not where -0.0 and +0.0 meet, C8):
  row for row on integer and BOOLEAN keys, up to the ties SQL leaves
  unordered on float keys.

Inputs come from seeded numpy; everything compares exactly.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu import batch as jb
from presto_tpu import types as jt
from presto_tpu.ops import merge as jm
from presto_tpu.ops.sort import sort_batch as j_sort_batch

from presto_tpu_torch import batch as tb
from presto_tpu_torch import types as tt
from presto_tpu_torch.ops import common as tc
from presto_tpu_torch.ops import merge as tm
from presto_tpu_torch.ops.sort import sort_batch as t_sort_batch

INT64_MIN = np.iinfo(np.int64).min
INT64_MAX = np.iinfo(np.int64).max

KEY_SETS = {
    "double": ["double"],
    "real": ["real"],
    "bigint": ["bigint"],
    "boolean": ["boolean"],
    "integer_double": ["integer", "double"],
    "boolean_real_bigint": ["boolean", "real", "bigint"],
}
ORDERS = [(False, False), (True, False), (False, True), (True, True)]
ORDER_IDS = ["asc", "desc", "asc_nulls_first", "desc_nulls_first"]


def _key_values(rng, kind, n):
    if kind == "bigint":
        pool = np.array([INT64_MIN, INT64_MIN + 1, -7, -1, 0, 1, 5,
                         INT64_MAX], np.int64)
        return rng.choice(pool, n)
    if kind == "double":
        pool = np.array([np.nan, -np.nan, -0.0, 0.0, -np.inf, np.inf, -2.5,
                         1.0], np.float64)
        return rng.choice(pool, n)
    if kind == "real":
        pool = np.array([np.nan, -0.0, 0.0, -np.inf, -1.5, 2.0],
                        np.float32)
        return rng.choice(pool, n)
    if kind == "integer":
        return rng.integers(-4, 4, n).astype(np.int32)
    return rng.random(n) < 0.5  # boolean


def _run(rng, kinds, n, cap, ids):
    """Numpy columns of one run: keys k0.. of `kinds` (NULLs among
    them), an id payload, dead rows past `n` and among the first n."""
    cols = {}
    for j, kind in enumerate(kinds):
        d = _key_values(rng, kind, cap)
        cols[f"k{j}"] = (kind, d, rng.random(cap) > 0.15)
    pid = np.zeros(cap, np.int64)
    pid[:n] = ids
    cols["id"] = ("bigint", pid, np.ones(cap, bool))
    rv = np.zeros(cap, bool)
    rv[:n] = rng.random(n) > 0.1
    return cols, rv


def _torch(cols, rv):
    return tb.Batch({n: tb.Column(torch.from_numpy(d.copy()),
                                  torch.from_numpy(m.copy()), tt.Type(t))
                     for n, (t, d, m) in cols.items()},
                    torch.from_numpy(rv.copy()))


def _jax(cols, rv):
    return jb.Batch({n: jb.Column(jnp.asarray(d), jnp.asarray(m),
                                  jt.Type(t))
                     for n, (t, d, m) in cols.items()}, jnp.asarray(rv))


def _words(batch, keys, desc, nf):
    """Plain K24 words [W, n] of the batch's rows (~row_valid, then each
    key with its mask), as int64 bits."""
    words, _ = tc.sort_encode_plain(
        [([batch.columns[k].astuple() for k in keys], batch.row_valid)],
        desc, nf)
    return words


def _pair_order(ops, unsigned):
    """[n, n] (row i before row j, rows i and j tie) by lexicographic
    comparison of `ops`, int64 words compared unsigned where asked."""
    n = ops[0].shape[0]
    lt = torch.zeros((n, n), dtype=torch.bool)
    eq = torch.ones((n, n), dtype=torch.bool)
    for op in ops:
        x = op ^ INT64_MIN if unsigned else op
        a, b = x[:, None], x[None, :]
        lt |= eq & (a < b)
        eq &= a == b
    return lt, eq


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 \
        else t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("desc,nf", ORDERS, ids=ORDER_IDS)
@pytest.mark.parametrize("case", sorted(KEY_SETS))
def test_word_order_is_the_canonical_order(case, desc, nf):
    """Every pair of rows orders, and ties, the same by the packed K24
    words as by `canonical_ops`, and the words sit where K19's pack plan
    puts them."""
    kinds = KEY_SETS[case]
    rng = np.random.default_rng(100 + 10 * sorted(KEY_SETS).index(case)
                                + 2 * desc + nf)
    keys = tuple(f"k{j}" for j in range(len(kinds)))
    d, n = (desc,) * len(kinds), (nf,) * len(kinds)
    batch = _torch(*_run(rng, kinds, 150, 170, np.arange(150)))
    words = _words(batch, keys, d, n)
    dtypes = tuple(batch.columns[k].data.dtype for k in keys)
    pos_valid, layout, nwords = tm.merge_pack_plan(dtypes)
    widths = [1] + [w for dt in dtypes for w in (1, tc.SORT_DTYPES[dt][1])]
    pos, want_words = tc.sort_pack_plan(widths)
    assert words.shape[0] == nwords == want_words
    assert [pos_valid] + [p for r, v, _ in layout for p in (r, v)] == pos
    canon = tm.canonical_ops(batch, keys, d, n)
    w_lt, w_eq = _pair_order(list(words), True)
    c_lt, c_eq = _pair_order(canon, False)
    assert torch.equal(w_lt, c_lt)
    assert torch.equal(w_eq, c_eq)
    # the edge values meet: dead rows, NULLs and live rows all present
    assert bool(batch.row_valid.any()) and not bool(batch.row_valid.all())


@pytest.mark.parametrize("desc,nf", ORDERS, ids=ORDER_IDS)
@pytest.mark.parametrize("case", sorted(KEY_SETS))
def test_plain_merge_is_the_stable_word_order(case, desc, nf):
    """`merge_pair_plain` of two runs sorted by `sort_rows` equals their
    union (A's rows first) in the stable order of its words: every
    column, mask and row_valid bit for bit."""
    kinds = KEY_SETS[case]
    rng = np.random.default_rng(200 + 10 * sorted(KEY_SETS).index(case)
                                + 2 * desc + nf)
    keys = tuple(f"k{j}" for j in range(len(kinds)))
    d, n = (desc,) * len(kinds), (nf,) * len(kinds)
    a = t_sort_batch(_torch(*_run(rng, kinds, 230, 256, np.arange(230))),
                     keys, d, n)
    b = t_sort_batch(_torch(*_run(rng, kinds, 100, 128,
                                  np.arange(230, 330))), keys, d, n)
    got = tm.merge_pair_plain(a, b, keys, d, n)
    union = tb.Batch({k: tb.Column(torch.cat([a.columns[k].data,
                                              b.columns[k].data]),
                                   torch.cat([a.columns[k].mask,
                                              b.columns[k].mask]),
                                   a.columns[k].type)
                      for k in a.names},
                     torch.cat([a.row_valid, b.row_valid]))
    perm, _ = tc.radix_sort_plain(_words(union, keys, d, n))
    assert torch.equal(got.row_valid, union.row_valid[perm])
    for k in a.names:
        g, u = got.columns[k], union.columns[k]
        assert torch.equal(g.mask, u.mask[perm]), k
        assert torch.equal(_bits(g.data), _bits(u.data[perm])), k


def _live_rows(batch, names):
    """(key tuple with NULL as None, id) per live row, in order."""
    d = batch.to_pydict()
    return [(tuple(d[k][i] for k in names), d["id"][i])
            for i in range(len(d["id"]))]


def _sql_key(key):
    """SQL equality of a key tuple: NaN equals NaN, -0.0 equals 0.0."""
    return tuple("nan" if isinstance(v, float) and math.isnan(v)
                 else (0.0 if v == 0 and isinstance(v, float) else v)
                 for v in key)


def _tie_runs(rows):
    """[(sql key, sorted ids)] per run of equal keys."""
    out = []
    for key, i in rows:
        k = _sql_key(key)
        if out and out[-1][0] == k:
            out[-1][1].append(i)
        else:
            out.append((k, [i]))
    return [(k, sorted(ids)) for k, ids in out]


@pytest.mark.parametrize("desc,nf", ORDERS, ids=ORDER_IDS)
@pytest.mark.parametrize("case", sorted(KEY_SETS))
def test_plain_merge_matches_the_reference(case, desc, nf):
    """The plain merge against the reference's `merge_pair` on runs each
    package sorted from the same numpy inputs: where the reference's
    output is a permutation of its live input rows, the port's equals it
    row for row on integer and BOOLEAN keys and up to SQL's ties on
    float keys; where it is not (its totalOrder bitcast sorts -0.0 below
    +0.0, C8), a float key is there."""
    kinds = KEY_SETS[case]
    rng = np.random.default_rng(300 + 10 * sorted(KEY_SETS).index(case)
                                + 2 * desc + nf)
    keys = tuple(f"k{j}" for j in range(len(kinds)))
    d, n = (desc,) * len(kinds), (nf,) * len(kinds)
    a_np = _run(rng, kinds, 200, 256, np.arange(200))
    b_np = _run(rng, kinds, 90, 128, np.arange(200, 290))
    ja, jb_ = (j_sort_batch(_jax(*x), keys, d, n) for x in (a_np, b_np))
    ta, tb_ = (t_sort_batch(_torch(*x), keys, d, n) for x in (a_np, b_np))
    want = _live_rows(jm.merge_pair(ja, jb_, keys, d, n), keys)
    got = _live_rows(tm.merge_pair_plain(ta, tb_, keys, d, n), keys)
    live_ids = sorted(int(i) for x in (a_np, b_np)
                      for i in x[0]["id"][1][x[1]])
    assert sorted(i for _, i in got) == live_ids
    floats = any(k in ("double", "real") for k in kinds)
    if sorted(i for _, i in want) == live_ids:
        if floats:
            assert _tie_runs(got) == _tie_runs(want)
        else:
            assert got == want
    else:
        assert floats
