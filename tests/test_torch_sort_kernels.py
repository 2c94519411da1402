"""The port's sort family and shared sort against the JAX package's, on
the CPU.

- The plain versions of K24 (`sort_encode_plain`), K25
  (`radix_sort_plain`) and K26 (`gather_rows_plain`) together give the
  reference's `sort_rows` permutation exactly, dead rows included, for
  every key type (BOOLEAN, TINYINT to BIGINT, REAL, DOUBLE, DATE,
  dictionary VARCHAR), ASC and DESC, NULLS FIRST and LAST, NaN, -0.0 /
  +0.0, +-inf, each width's minimum under DESC, 1 to 10 keys and 0 to
  70,000 rows; K25 over raw int64 words gives the reference's
  `lex_perm` of (h1, h2).
- The word packing and the digit-skip planner, in pure Python.
- `sort_batch`, `topn_step`, `limit_batch` and `distinct_step` against
  the reference's `_sort_batch_impl`, `_topn_step_impl`,
  `_limit_batch_impl` and `_distinct_step_impl`.
- ORDER BY, TopN, LIMIT, DISTINCT and window queries through the port's
  `LocalRunner("tpch", "tiny", device="cpu")` against the reference's
  LocalRunner, by tests/test_tpch_suite.py's `assert_rows_equal`
  (DOUBLE rel_tol 1e-6, everything else exact).

Permutations, rows and masks compare exactly. The CUDA kernels are held
against these plain versions in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_tpch_suite import assert_rows_equal
from test_tpch_suite import runner  # noqa: F401 (fixture)

from presto_tpu import batch as jb
from presto_tpu import types as jt
from presto_tpu.ops import common as jc
from presto_tpu.ops import sort as js

from presto_tpu_torch import batch as tb
from presto_tpu_torch import types as tt
from presto_tpu_torch.ops import common as tc
from presto_tpu_torch.ops import sort as ts

# one intra-op thread: see tests/test_torch_tpch.py
torch.set_num_threads(1)

#: SQL type -> numpy dtype of its data
KINDS = {"boolean": np.bool_, "tinyint": np.int8, "smallint": np.int16,
         "integer": np.int32, "bigint": np.int64, "real": np.float32,
         "double": np.float64, "date": np.int32, "varchar": np.int32}


def _values(rng, kind, n):
    """Values of one key with the edge cases of its type."""
    dt = KINDS[kind]
    if kind == "boolean":
        return rng.random(n) < 0.5
    if kind in ("real", "double"):
        pool = np.array([np.nan, -0.0, 0.0, -np.inf, np.inf, -2.5, 1.0,
                         3.25, 7.0], dt)
        return rng.choice(pool, n)
    if kind == "varchar":
        return rng.integers(0, 6, n).astype(dt)  # dictionary codes
    if kind == "date":
        return rng.integers(8000, 8010, n).astype(dt)
    ii = np.iinfo(dt)
    pool = np.array([ii.min, ii.min + 1, -3, -1, 0, 1, 4, ii.max], dt)
    return rng.choice(pool, n)


def _keys(rng, kinds, n):
    return [(_values(rng, k, n), rng.random(n) < 0.8) for k in kinds]


def _ref_perm(keys, desc, nf, valid):
    _, _, (perm,) = jc.sort_rows(
        [(jnp.asarray(d), jnp.asarray(m)) for d, m in keys], list(desc),
        list(nf), valid=jnp.asarray(valid),
        payloads=[jnp.arange(len(valid))])
    return np.asarray(perm)


def _plain_sort(keys, desc, nf, valid):
    """K24, K25 and K26's plain versions in the card's order."""
    tkeys = [(torch.from_numpy(d.copy()), torch.from_numpy(m.copy()))
             for d, m in keys]
    tvalid = torch.from_numpy(valid.copy())
    words, digits = tc.sort_encode_plain([(tkeys, tvalid)], desc, nf)
    perm, _ = tc.radix_sort_plain(words, digits)
    n = len(valid)
    out, svalid = tc.gather_rows_plain(
        [(tkeys + [(torch.arange(n), None)], tvalid)], perm)
    return perm.numpy(), out, svalid


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("desc,nf", [(False, False), (True, False),
                                     (False, True), (True, True)])
def test_plain_sort_matches_reference(kind, desc, nf):
    rng = np.random.default_rng(sorted(KINDS).index(kind) * 4
                                + 2 * desc + nf)
    n = 700
    keys = _keys(rng, [kind, "integer"], n)
    valid = rng.random(n) < 0.85
    want = _ref_perm(keys, (desc, False), (nf, False), valid)
    perm, out, svalid = _plain_sort(keys, [desc, False], [nf, False], valid)
    np.testing.assert_array_equal(perm, want)
    np.testing.assert_array_equal(out[-1][0].numpy(), want)
    np.testing.assert_array_equal(svalid.numpy(), valid[want])
    for (d, m), (od, om) in zip(keys, out):
        np.testing.assert_array_equal(om.numpy(), m[want])
        np.testing.assert_array_equal(od.numpy().view(np.uint8),
                                      d[want].view(np.uint8))


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 70_000])
def test_plain_sort_sizes(n):
    rng = np.random.default_rng(n)
    kinds = ["double", "bigint", "varchar"]
    keys = _keys(rng, kinds, n)
    valid = rng.random(n) < 0.9
    desc, nf = [True, False, True], [False, True, True]
    perm, _, svalid = _plain_sort(keys, desc, nf, valid)
    if n:
        np.testing.assert_array_equal(perm, _ref_perm(keys, desc, nf,
                                                      valid))
    assert perm.shape == (n,) and svalid.shape == (n,)


@pytest.mark.parametrize("nkeys", [1, 2, 3, 5, 8, 10])
def test_plain_sort_many_keys(nkeys):
    rng = np.random.default_rng(100 + nkeys)
    kinds = list(rng.choice(sorted(KINDS), nkeys))
    n = 2_000
    keys = _keys(rng, kinds, n)
    valid = rng.random(n) < 0.9
    desc = list(rng.random(nkeys) < 0.5)
    nf = list(rng.random(nkeys) < 0.5)
    perm, _, _ = _plain_sort(keys, desc, nf, valid)
    np.testing.assert_array_equal(perm, _ref_perm(keys, desc, nf, valid))


@pytest.mark.parametrize("kind", ["tinyint", "smallint", "integer",
                                  "bigint"])
def test_int_min_sorts_first_under_desc_in_both_packages(kind):
    """DESC negates with a wrap, so -MIN == MIN and each width's minimum
    sorts first under DESC, before the maximum, in the reference and in
    the port alike (SQL would put it last: ROADMAP C9)."""
    ii = np.iinfo(KINDS[kind])
    d = np.array([5, ii.min, ii.max, -1, 0, ii.min + 1], KINDS[kind])
    keys = [(d, np.ones(len(d), bool))]
    valid = np.ones(len(d), bool)
    want = _ref_perm(keys, (True,), (False,), valid)
    perm, _, _ = _plain_sort(keys, [True], [False], valid)
    np.testing.assert_array_equal(perm, want)
    assert list(d[perm]) == [ii.min, ii.max, 5, 0, -1, ii.min + 1]


@pytest.mark.parametrize("kind", ["real", "double"])
@pytest.mark.parametrize("desc", [False, True])
def test_nan_last_and_signed_zeros_tie(kind, desc):
    """Every NaN sorts after every number under ASC and DESC, and -0.0
    ties with +0.0 (input order kept), in both packages."""
    d = np.array([1.0, np.nan, -0.0, 0.0, np.inf, -np.inf, -np.nan, 2.0,
                  0.0, -0.0], KINDS[kind])
    keys = [(d, np.ones(len(d), bool))]
    valid = np.ones(len(d), bool)
    want = _ref_perm(keys, (desc,), (False,), valid)
    perm, _, _ = _plain_sort(keys, [desc], [False], valid)
    np.testing.assert_array_equal(perm, want)
    assert np.isnan(d[perm[-2:]]).all()
    zeros = [i for i in perm if d[i] == 0]
    assert zeros == [2, 3, 8, 9]


def test_lex_perm_of_hash_words_matches_reference():
    rng = np.random.default_rng(7)
    n = 5_000
    h1 = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    h1[rng.random(n) < 0.2] = np.iinfo(np.int64).max
    h1[:50] = h1[50:100]
    h2 = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    want = np.asarray(jc.lex_perm([jnp.asarray(h1), jnp.asarray(h2)]))
    perm, _ = tc.radix_sort_plain([torch.from_numpy(h1),
                                   torch.from_numpy(h2)], flip=True)
    np.testing.assert_array_equal(perm.numpy(), want)
    perm = tc.lex_perm([torch.from_numpy(h1), torch.from_numpy(h2)])
    np.testing.assert_array_equal(perm.numpy(), want)
    with pytest.raises(ValueError, match="int64"):
        tc.lex_perm([torch.from_numpy(h1 > 0), torch.from_numpy(h2)])
    perm, sh = tc.radix_sort([torch.from_numpy(h1)], flip=True,
                             sorted_first=True)
    np.testing.assert_array_equal(sh.numpy(), np.sort(h1, kind="stable"))
    np.testing.assert_array_equal(perm.numpy(),
                                  np.argsort(h1, kind="stable"))


# -- the planner, in pure Python ------------------------------------------

def test_pack_plan_is_back_to_back():
    assert tc.sort_pack_plan([]) == ([], 1)
    assert tc.sort_pack_plan([1, 1, 64]) == ([0, 1, 2], 2)
    assert tc.sort_pack_plan([1, 1, 64, 1, 64]) == ([0, 1, 2, 66, 67], 3)
    assert tc.sort_pack_plan([64, 64]) == ([0, 64], 2)
    assert tc.sort_pack_plan([1] * 64) == (list(range(64)), 1)
    assert tc.sort_pack_plan([1] * 65)[1] == 2


def test_radix_passes_skip_constant_digits():
    # word 0 varies in bytes 0 and 7, word 1 in none, word 2 in byte 3
    digits = [0b1000_0001, 0, 0b0000_1000]
    assert tc.radix_passes(digits) == [(2, 24), (0, 0), (0, 56)]
    every = tc.radix_passes([0xFF] * len(digits))
    assert len(every) == 24
    assert every[:8] == [(2, 8 * d) for d in range(8)]
    assert every[-8:] == [(0, 8 * d) for d in range(8)]
    assert tc.radix_passes([0, 0]) == []


class _FakeRadixLib:
    """The scratch size K25's library reports (csrc/radix_sort.cu
    SCRATCH_BYTES is of this order), for the wrapper's host logic."""

    @staticmethod
    def presto_radix_scratch_bytes():
        return 1 << 20


@pytest.mark.parametrize("n,tiles", [(1, 1), (4095, 1), (4096, 1),
                                     (4097, 2), (1 << 24, 4096)])
def test_radix_tiles(n, tiles):
    assert tc.radix_tiles(n, 4096) == tiles


def test_radix_scratch_is_kept_per_stream_and_grows(monkeypatch):
    """K25's scratch per (device, stream): made zeroed once, reused by
    a call of fewer tiles, its status words replaced (zeroed, so every
    word carries epoch 0, which no pass takes) by a call of more; the
    pass table stays."""
    monkeypatch.setattr(tc, "_RADIX_SCRATCH", {})
    dev, lib = torch.device("cpu"), _FakeRadixLib()
    fixed, status = tc._radix_scratch(lib, dev, 7, 4)
    assert fixed.numel() * 8 >= lib.presto_radix_scratch_bytes()
    assert status.shape == (256 * 4,)
    assert not fixed.any() and not status.any()
    status.fill_(5)
    again = tc._radix_scratch(lib, dev, 7, 2)
    assert again[0] is fixed and again[1] is status
    grown = tc._radix_scratch(lib, dev, 7, 9)
    assert grown[0] is fixed and grown[1].shape == (256 * 9,)
    assert not grown[1].any()
    other = tc._radix_scratch(lib, dev, 8, 1)
    assert other[0] is not fixed


def test_radix_last_passes_reads_the_pass_table(monkeypatch):
    """The pass table's layout (csrc/radix_sort.cu `Plan`): npasses, the
    epoch, the ticket, a pad, then word[] and shift[] of
    RADIX_MAX_PASSES entries each, int32."""
    from presto_tpu_torch.native import cuda
    monkeypatch.setattr(tc, "_RADIX_SCRATCH", {})
    monkeypatch.setattr(cuda, "stream_ptr", lambda dev: 7)
    fixed, _ = tc._radix_scratch(_FakeRadixLib(), torch.device("cpu"), 7, 1)
    table = fixed.view(torch.int32)
    table[0] = 3
    m = tc.RADIX_MAX_PASSES
    table[4:7] = torch.tensor([2, 0, 0], dtype=torch.int32)
    table[4 + m:7 + m] = torch.tensor([24, 0, 56], dtype=torch.int32)
    assert tc.radix_last_passes(torch.device("cpu")) == \
        tc.radix_passes([0b1000_0001, 0, 0b0000_1000])


def test_words_are_the_codes_back_to_back():
    """The plain words hold each operand's code at its planned position:
    read back from the concatenated words as one big integer, in pure
    Python, the codes come out again, and so do the varying digits."""
    rng = np.random.default_rng(11)
    n = 300
    kinds = ["bigint", "boolean", "real", "smallint", "double", "tinyint"]
    keys = _keys(rng, kinds, n)
    valid = rng.random(n) < 0.7
    tkeys = [(torch.from_numpy(d), torch.from_numpy(m)) for d, m in keys]
    desc = [True, False, True, False, False, True]
    nf = [False, True, True, False, True, False]
    words, digits = tc.sort_encode_plain(
        [(tkeys, torch.from_numpy(valid))], desc, nf)
    widths = [1] + [w for k in kinds
                    for w in (1, tc.SORT_DTYPES[tt.Type(k).torch_dtype][1])]
    pos, nwords = tc.sort_pack_plan(widths)
    assert words.shape == (nwords, n) and sum(widths) <= 64 * nwords
    w = words.numpy().view(np.uint64)
    for r in range(0, n, 37):
        big = 0
        for j in range(nwords):
            big = (big << 64) | int(w[j, r])
        fields = [(big >> (64 * nwords - p - b)) & ((1 << b) - 1)
                  for p, b in zip(pos, widths)]
        assert fields[0] == int(not valid[r])
        for i, ((d, m), de, f) in enumerate(zip(keys, desc, nf)):
            rank, code = fields[1 + 2 * i], fields[2 + 2 * i]
            assert rank == (int(m[r]) if f else int(not m[r]))
            want = int(tc._value_code(torch.from_numpy(d[r:r + 1]),
                                      torch.from_numpy(m[r:r + 1]), de)[0])
            assert code == want & ((1 << widths[2 + 2 * i]) - 1)
    for j in range(nwords):
        vary = sum(1 << b for b in range(8)
                   if len(set(int(x) >> (8 * b) & 0xFF for x in w[j])) > 1)
        assert int(digits[j]) == vary


def test_value_codes_order_like_the_values():
    """Codes of a key sort as its canonical values do (integers wrap
    under DESC, floats put NaN last and tie -0.0 with +0.0)."""
    for kind in ("tinyint", "integer", "bigint", "real", "double"):
        d = _values(np.random.default_rng(3), kind, 400)
        m = np.ones(len(d), bool)
        for desc in (False, True):
            code = tc._value_code(torch.from_numpy(d), torch.from_numpy(m),
                                  desc).numpy().view(np.uint64)
            order = np.argsort(code, kind="stable")
            want = _ref_perm([(d, m)], (desc,), (False,), m)
            np.testing.assert_array_equal(order, want)


# -- the sort family's ops against the reference's -------------------------

SCHEMA = [("k", "integer"), ("v", "double"), ("s", "varchar"),
          ("b", "boolean")]


def _batch_np(rng, cap, live):
    cols = {}
    for name, kind in SCHEMA:
        cols[name] = (kind, _values(rng, kind, cap), rng.random(cap) < 0.85)
    rv = np.zeros(cap, bool)
    rv[:live] = rng.random(live) < 0.9
    return cols, rv


def _jax(cols, rv):
    return jb.Batch({n: jb.Column(jnp.asarray(d), jnp.asarray(m),
                                  jt.Type(t))
                     for n, (t, d, m) in cols.items()}, jnp.asarray(rv))


def _torch(cols, rv):
    return tb.Batch({n: tb.Column(torch.from_numpy(d.copy()),
                                  torch.from_numpy(m.copy()), tt.Type(t))
                     for n, (t, d, m) in cols.items()},
                    torch.from_numpy(rv.copy()))


def _same(got, want):
    """Port batch == reference batch: row_valid, masks and data exactly
    (data bitwise, so NaN equals NaN)."""
    np.testing.assert_array_equal(got.row_valid.numpy(),
                                  np.asarray(want.row_valid))
    for n in want.names:
        g, w = got.columns[n], want.columns[n]
        np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
        gd, wd = g.data.numpy(), np.asarray(w.data)
        np.testing.assert_array_equal(gd.view(np.uint8), wd.view(np.uint8))


@pytest.mark.parametrize("keys,desc,nf", [
    (("k",), (False,), (False,)),
    (("v", "k"), (True, False), (False, True)),
    (("s", "b", "v"), (False, True, True), (True, False, False)),
])
def test_sort_batch_matches_reference(keys, desc, nf):
    rng = np.random.default_rng(len(keys))
    x = _batch_np(rng, 1024, 900)
    _same(ts.sort_batch(_torch(*x), keys, desc, nf),
          js._sort_batch_impl(_jax(*x), keys, desc, nf))


@pytest.mark.parametrize("n", [0, 1, 64, "varying"])
def test_topn_step_matches_reference(n):
    rng = np.random.default_rng(21)
    cap = 64
    keys, desc, nf = ("v", "k"), (True, False), (False, True)
    schema = [(name, tt.Type(kind), None) for name, kind in SCHEMA]
    tstate = ts.topn_state(schema, cap, torch.device("cpu"))
    jstate = js.distinct_state(
        [(name, jt.Type(kind), None) for name, kind in SCHEMA], cap)
    for step in range(4):
        x = _batch_np(rng, 256, 200)
        nn = (7, 64, 1, 33)[step] if n == "varying" else n
        tstate = ts.topn_step(tstate, _torch(*x), nn, keys, desc, nf)
        jstate = js._topn_step_impl(jstate, _jax(*x), np.int64(nn), keys,
                                    desc, nf)
        _same(tstate, jstate)
    assert int(tstate.row_valid.sum()) == (33 if n == "varying" else n)


def test_limit_batch_over_batches_matches_reference():
    rng = np.random.default_rng(5)
    emitted = torch.zeros((), dtype=torch.int64)
    jemitted = np.int64(0)
    total = 0
    for _ in range(6):
        x = _batch_np(rng, 512, 512)
        got, emitted = ts.limit_batch(_torch(*x), 1000, emitted)
        want = js._limit_batch_impl(_jax(*x), np.int64(1000), jemitted)
        _same(got, want)
        jemitted = jemitted + int(np.asarray(want.row_valid).sum())
        total += int(got.row_valid.sum())
        assert int(emitted) == total == int(jemitted)
    assert total == 1000


def test_distinct_step_matches_reference():
    rng = np.random.default_rng(8)
    schema = [(name, tt.Type(kind), None) for name, kind in SCHEMA[:3]]
    jschema = [(name, jt.Type(kind), None) for name, kind in SCHEMA[:3]]
    tstate = ts.distinct_state(schema, 512, torch.device("cpu"))
    jstate = js.distinct_state(jschema, 512)
    for _ in range(3):
        cols, rv = _batch_np(rng, 256, 256)
        # at most 4 x 10 x 3 groups: the state never fills
        cols = {"k": ("integer", cols["k"][1] % 3, cols["k"][2]),
                "v": cols["v"],
                "s": ("varchar", cols["s"][1] % 2, cols["s"][2])}
        tstate = ts.distinct_step(tstate, _torch(cols, rv))
        jstate = js._distinct_step_impl(jstate, _jax(cols, rv))
        got = sorted(map(repr, tstate.to_pylist()))
        want = sorted(map(repr, _live_ref_rows(jstate)))
        assert got == want


def _live_ref_rows(batch):
    rv = np.asarray(batch.row_valid)
    out = []
    for i in np.nonzero(rv)[0]:
        row = []
        for n in batch.names:
            c = batch.columns[n]
            row.append(np.asarray(c.data)[i].item()
                       if np.asarray(c.mask)[i] else None)
        out.append(tuple(row))
    return out


# -- the slice through both LocalRunners ------------------------------------

SLICE_QUERIES = {
    "order_by": ("select orderkey, linenumber, extendedprice from lineitem "
                 "where orderkey < 400 order by extendedprice desc, "
                 "orderkey, linenumber", True),
    "order_by_nulls": ("select custkey, nullif(nationkey, 3) nk from "
                       "customer order by nk desc nulls first, custkey",
                       True),
    "topn": ("select orderkey, linenumber, extendedprice from lineitem "
             "order by extendedprice desc, orderkey, linenumber limit 25",
             True),
    "limit_count": ("select count(*) from (select orderkey from lineitem "
                    "limit 5000)", True),
    "distinct": ("select distinct returnflag, linestatus, shipmode from "
                 "lineitem", False),
    "window": ("select orderkey, linenumber, row_number() over (partition "
               "by orderkey order by quantity desc, linenumber) rn from "
               "lineitem where orderkey < 200 order by orderkey, rn", True),
}

_PORT = {}


def _port():
    if "r" not in _PORT:
        from presto_tpu_torch.runner import LocalRunner
        _PORT["r"] = LocalRunner("tpch", "tiny", device="cpu")
    return _PORT["r"]


@pytest.mark.parametrize("name", sorted(SLICE_QUERIES))
def test_slice_query_matches_reference(name, runner):  # noqa: F811
    sql, ordered = SLICE_QUERIES[name]
    got = _port().execute(sql)
    want = runner.execute(sql)
    assert got.names == want.names
    assert_rows_equal(got.rows(), want.rows(), name, ordered)
    assert got.rows()


def test_array_columns_reach_the_sort_as_slot_columns(runner,  # noqa: F811
                                                      monkeypatch):
    """An ORDER BY over array_agg results sorts the arrays' slot columns,
    each 1-D (what K24-K26 take), and gives the reference's rows."""
    from presto_tpu_torch.ops import common as tcommon
    seen = []
    orig = tcommon.sort_rows

    def record(keys, descending=None, nulls_first=None, valid=None,
               payloads=()):
        seen.extend(t.dim() for d, m in keys for t in (d, m))
        seen.extend(p.dim() for p in payloads)
        return orig(keys, descending, nulls_first, valid, payloads)
    monkeypatch.setattr(tcommon, "sort_rows", record)
    sql = ("select regionkey, array_agg(nationkey) a, array_agg(name) n "
           "from nation group by regionkey order by regionkey desc")
    got = _port().execute(sql).rows()
    assert seen and set(seen) == {1}
    assert_rows_equal(got, runner.execute(sql).rows(), "array_order",
                      True)
