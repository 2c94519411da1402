"""topn's select-then-sort (K31 `topn_select`, K32 `topn_sort`) on the
CPU, through their plain versions.

- `topn_select_plain` against a full stable sort of the same key words
  (K24's, from keys with heavy ties, all-equal keys, NULLs, NaN, -0.0
  and +0.0, DESC and mixed NULLS FIRST, dead rows, fewer live rows than
  C): its candidates are in index order, number at most M, hold the
  first C rows of the stable order (exactly those C when the digits ran
  out and the ties were cut by index), and `topn_sort_plain` orders them
  into those C rows.
- `topn_step` (now K24 -> K31 -> K32 -> K26) bit-identical in every
  slot (data, masks, row_valid) to `topn_step_full_sort` (K24 -> K25 ->
  K26 over every row) and to the reference's `_topn_step_impl` on the
  same numpy inputs, over several steps of a tie-heavy batch stream, for
  n = 0, a few, C and a varying n, and with C + B <= M (no select).

Everything compares exactly (integers, data bitwise). The CUDA kernels
are held against these plain versions in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

from presto_tpu import types as jt
from presto_tpu.ops import sort as js
from presto_tpu_torch import types as tt
from presto_tpu_torch.ops import common as tc
from presto_tpu_torch.ops import sort as ts
from test_torch_sort_kernels import SCHEMA, _jax, _same, _torch, _values

# one intra-op thread: see tests/test_torch_tpch.py
torch.set_num_threads(1)


def _parts(rng, n, kinds, split, live=1.0, domain=None):
    """Two sources (state, batch) of `n` rows of keys of `kinds`; a key
    draws from `domain` values of its edge-case pool when given (ties);
    about `live` of the rows are live."""
    keys = []
    for kind in kinds:
        d = _values(rng, kind, n)
        if domain is not None:
            d = rng.choice(np.unique(d)[:domain], n).astype(d.dtype)
        keys.append((torch.from_numpy(d), torch.from_numpy(rng.random(n)
                                                            < 0.85)))
    valid = torch.from_numpy(rng.random(n) < live)
    return [([(d[a:b], m[a:b]) for d, m in keys], valid[a:b])
            for a, b in ((0, split), (split, n))]


def _check_select(words, digits, cap, most):
    n = words.shape[1]
    full, _ = tc.radix_sort_plain(words)
    first = full[:cap]
    cand, info, cwords = tc.topn_select_plain(words, digits, cap, most)
    count, passes, ran_out, below = (int(x) for x in info)
    assert cand.dtype == torch.int64 and cand.shape == (most,)
    assert cap <= count <= most and 0 <= below < cap
    got = cand[:count]
    assert bool((got[1:] > got[:-1]).all()) and int(got[0]) >= 0 \
        and int(got[-1]) < n
    assert bool((cand[count:] == -1).all())
    assert set(first.tolist()) <= set(got.tolist())
    if ran_out:
        assert sorted(first.tolist()) == got.tolist()
    assert torch.equal(cwords[:, :count], words[:, got])
    assert bool((cwords[:, count:] == -1).all())
    assert torch.equal(tc.topn_sort_plain(cwords, cand, info, cap), first)
    return count, passes, bool(ran_out)


@pytest.mark.parametrize("case", [
    "distinct", "ties", "all_equal", "specials", "desc_mixed_nulls",
    "dead_rows", "few_live"])
def test_select_holds_the_first_c_of_a_stable_sort(case):
    rng = np.random.default_rng(len(case))
    n, cap, most = 3000, 64, 160
    kinds, desc, nf = ["integer", "double"], [False, False], [False, False]
    live, domain = 0.9, None
    if case == "ties":
        domain = 3
    elif case == "all_equal":
        domain, kinds, desc, nf, live = 1, ["integer"], [False], [False], 1.0
    elif case == "specials":
        kinds, desc, nf = ["double", "real"], [False, True], [True, False]
    elif case == "desc_mixed_nulls":
        kinds, desc, nf = ["bigint", "varchar", "smallint"], \
            [True, False, True], [True, False, False]
    elif case == "dead_rows":
        live = 0.3
    elif case == "few_live":
        live = 0.01
    parts = _parts(rng, n, kinds, cap, live, domain)
    words, digits = tc.sort_encode_plain(parts, desc, nf)
    count, passes, ran_out = _check_select(words, digits, cap, most)
    if case in ("ties", "all_equal"):
        # the full key ties across more than M rows
        assert ran_out and count == cap
    if case == "all_equal":
        # no digit varies among the live rows' words but the valid bit's
        assert passes <= 1
    if case == "distinct":
        assert not ran_out and passes >= 1


def test_select_over_raw_words_with_every_digit():
    """Random 64-bit words (every digit varying, the top bit too), two
    words, and a cap that leaves one row of slack."""
    rng = np.random.default_rng(7)
    n = 5000
    w = torch.from_numpy(rng.integers(-(1 << 63), (1 << 63) - 1, (2, n),
                                      dtype=np.int64))
    w[1] = torch.from_numpy(rng.integers(0, 4, n))  # ties in word 0's tail
    w[0] = w[0] & ~0xFFFF  # the low digits of word 0 are constant
    digits = tc._vary_digits(w)
    for cap, most in ((1, 1), (100, 101), (100, 400), (4000, 4999)):
        _check_select(w, digits, cap, most)


def test_topn_order_skips_the_select_when_everything_fits(monkeypatch):
    """C + B <= M: no select, the sort takes every row."""
    rng = np.random.default_rng(9)
    parts = _parts(rng, 90, ["integer", "double"], 64, 0.9, 4)
    words, digits = tc.sort_encode_plain(parts, [False, True], [True, True])
    calls = []
    orig = tc.topn_select_plain
    monkeypatch.setattr(tc, "topn_select_plain",
                        lambda *a, **k: calls.append(a) or orig(*a, **k))
    assert tc.topn_plan(64, words.shape[0])[0] >= 90
    perm = tc.topn_order(words, digits, 64)
    assert not calls
    assert torch.equal(perm, tc.radix_sort_plain(words)[0][:64])


@pytest.mark.parametrize("cap,nwords,shared", [
    (64, 1, True), (4096, 3, True), (4096, 30, False), (16384, 1, False),
    (16384, 3, False)])
def test_topn_plan(cap, nwords, shared):
    """M >= C always; K32's shared memory holds M x (8W + 4) bytes and
    its scratch, at most 2C candidates (K25 takes 2C where they do not
    fit)."""
    most, fits = tc.topn_plan(cap, nwords)
    assert fits == shared and most >= cap
    if fits:
        assert most <= min(2 * cap, tc.TOPN_SORT_MAX_ROWS)
        assert most * (8 * nwords + 4) + tc.TOPN_SORT_SCRATCH \
            <= tc.TOPN_SMEM_BYTES
    else:
        assert most == 2 * cap


def _tie_batch(rng, cap, live):
    """A batch whose keys draw from two or three values each (every step
    ties across more rows than the select's cap)."""
    cols = {}
    for name, kind in SCHEMA:
        d = _values(rng, kind, cap)
        d = rng.choice(np.unique(d)[:2 + (kind == "integer")],
                       cap).astype(d.dtype)
        cols[name] = (kind, d, rng.random(cap) < 0.9)
    rv = np.zeros(cap, bool)
    rv[:live] = rng.random(live) < 0.9
    return cols, rv


@pytest.mark.parametrize("n", [0, 3, 64, "varying"])
@pytest.mark.parametrize("keys,desc,nf", [
    (("k", "s"), (False, True), (True, False)),
    (("b", "v", "k"), (True, False, False), (False, True, True)),
])
def test_topn_step_ties_matches_full_sort_and_reference(n, keys, desc, nf):
    rng = np.random.default_rng(31)
    cap = 64
    schema = [(name, tt.Type(kind), None) for name, kind in SCHEMA]
    tstate = ts.topn_state(schema, cap, torch.device("cpu"))
    fstate = tstate
    jstate = js.distinct_state(
        [(name, jt.Type(kind), None) for name, kind in SCHEMA], cap)
    selected = tc.TOPN_SELECT_KERNEL.launches
    for step in range(5):
        x = _tie_batch(rng, 256, (256, 200, 30, 256, 0)[step])
        nn = (7, 64, 1, 33, 64)[step] if n == "varying" else n
        tstate = ts.topn_step(tstate, _torch(*x), nn, keys, desc, nf)
        fstate = ts.topn_step_full_sort(fstate, _torch(*x), nn, keys, desc,
                                        nf)
        jstate = js._topn_step_impl(jstate, _jax(*x), np.int64(nn), keys,
                                    desc, nf)
        _same(tstate, jstate)
        _same(fstate, jstate)
    # the CPU path runs the plain versions: no launch
    assert tc.TOPN_SELECT_KERNEL.launches == selected


def test_topn_step_small_batch_matches_reference():
    """C + B <= M: the step sorts every row (no select) and still equals
    the reference in every slot."""
    rng = np.random.default_rng(33)
    cap = 64
    schema = [(name, tt.Type(kind), None) for name, kind in SCHEMA]
    tstate = ts.topn_state(schema, cap, torch.device("cpu"))
    jstate = js.distinct_state(
        [(name, jt.Type(kind), None) for name, kind in SCHEMA], cap)
    keys, desc, nf = ("v", "k"), (True, False), (False, True)
    for step in range(3):
        x = _tie_batch(rng, 48, 40)
        tstate = ts.topn_step(tstate, _torch(*x), 50, keys, desc, nf)
        jstate = js._topn_step_impl(jstate, _jax(*x), np.int64(50), keys,
                                    desc, nf)
        _same(tstate, jstate)
