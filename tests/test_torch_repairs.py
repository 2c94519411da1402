"""The port's repaired faults, on the CPU.

- NaN in min / max: the plain versions of K1 (`slot_reduce_plain`), K6
  (`segment_reduce_plain`) and K8 (`presorted_reduce_plain` and the
  streaming fold) let a NaN win, as the reference's
  `jax.ops.segment_min` / `segment_max` do, exactly; and whole queries
  with a NaN group through both runners (direct and sort-based
  grouping) agree (assert_rows_equal: DOUBLE rel_tol 1e-6, NaN equal
  to NaN).
- Width caps: the wrappers of K1, K3, K6, K8 and K9-K11 split more
  keys, state components or output columns than one launch takes
  across launches; here each launch is replaced by its plain version
  behind a check of the one-launch cap, and the split result equals
  the plain version over everything, exactly.
- REAL math: exp, ln, trig, power, remainder ... over REAL columns now
  lower (float64 libdevice of the widened operands, rounded to
  float32); the generated kernel, run through tests/triton_standin.py,
  agrees with the composed float32 closure to a relative 2**-20
  (~8 float32 ulp: the composed CPU form evaluates in float32, the
  kernel in float64 rounded once).
"""

import math

import numpy as np
import pytest
import torch

from test_tpch_suite import assert_rows_equal

import triton_standin as standin
from torch_fragment_cases import port_batch, real_function_calls, real_stage

from presto_tpu_torch import types as tt
from presto_tpu_torch.expr import ir as pir
from presto_tpu_torch.ops import common
from presto_tpu_torch.ops import hashagg as th

torch.set_num_threads(1)

NAN = math.nan


def _segment_ref(vals, ids, num, fn):
    import jax
    import jax.numpy as jnp
    op = jax.ops.segment_min if fn == "min" else jax.ops.segment_max
    return np.asarray(op(jnp.asarray(vals), jnp.asarray(ids),
                         num_segments=num))


def _nan_groups():
    """Values of four groups: NaN first, NaN last, NaN alone, none."""
    vals = np.array([NAN, 1.0, 2.0, 3.0, -4.0, NAN, NAN, 5.0, 6.0, -1.0])
    ids = np.array([0, 0, 0, 1, 1, 1, 2, 3, 3, 3])
    return vals, ids


@pytest.mark.parametrize("fn", ["min", "max"])
def test_k1_plain_lets_nan_win(fn):
    vals, ids = _nan_groups()
    n = len(vals)
    # four key codes and the NULL code: five slots
    state = torch.full((5,), th._ident_for(fn, torch.float64),
                       dtype=torch.float64)
    th.slot_reduce_plain(
        torch.ones(n, dtype=torch.bool),
        [(torch.from_numpy(ids.astype(np.int32)),
          torch.ones(n, dtype=torch.bool))], (4,),
        [(torch.from_numpy(vals), state, fn)],
        torch.zeros(5, dtype=torch.bool))
    want = _segment_ref(vals, ids, 4, fn)
    np.testing.assert_array_equal(state.numpy()[:4], want)
    assert np.isnan(want[:3]).all() and not np.isnan(want[3])


@pytest.mark.parametrize("fn", ["min", "max"])
def test_k6_plain_lets_nan_win(fn):
    vals, ids = _nan_groups()
    n = len(vals)
    keys = [(torch.from_numpy(ids), torch.ones(n, dtype=torch.bool))]
    valid = torch.ones(n, dtype=torch.bool)
    h1, h2 = common.row_hash_pair_plain(keys, valid, False)
    perm = common.lex_perm([h1, h2])
    reduced, first, groups, _ = th.segment_reduce_plain(
        h1[perm], h2[perm], [(d[perm], m[perm]) for d, m in keys],
        valid[perm], [(torch.from_numpy(vals)[perm], fn)], 8)
    got = {int(ids[perm[int(first[g])]]): float(reduced[0][g])
           for g in range(int(groups))}
    want = _segment_ref(vals, ids, 4, fn)
    for k in range(4):
        assert (math.isnan(got[k]) and math.isnan(want[k])) \
            or got[k] == want[k], (k, got[k], want[k])


@pytest.mark.parametrize("fn", ["min", "max"])
def test_k8_plain_and_fold_let_nan_win(fn):
    """The streaming reduction over key-sorted rows, and the fold of a
    NaN carry into the next batch's first group."""
    vals, ids = _nan_groups()
    n = len(vals)
    agg = th.make_min(tt.DOUBLE) if fn == "min" else th.make_max(tt.DOUBLE)
    keys = [(torch.from_numpy(ids), torch.ones(n, dtype=torch.bool))]
    rv = torch.ones(n, dtype=torch.bool)
    contrib = agg.init(torch.from_numpy(vals), rv)
    st = th.presorted_reduce_plain(rv, keys, [contrib], [agg], 8)
    want = _segment_ref(vals, ids, 4, fn)
    got = st.states[0][0][:4].numpy()
    np.testing.assert_array_equal(got, want)
    # carry = group 0 (NaN); the next batch continues group 0 with 7.0
    carry = th.GroupByState([(st.keys[0][0][:1], st.keys[0][1][:1])],
                            [tuple(a[:1] for a in st.states[0])],
                            torch.ones(1, dtype=torch.bool),
                            torch.zeros((), dtype=torch.bool))
    nxt = [(torch.zeros(2, dtype=torch.int64),
            torch.ones(2, dtype=torch.bool))]
    rv2 = torch.ones(2, dtype=torch.bool)
    part = th.presorted_reduce_plain(
        rv2, nxt, [agg.init(torch.tensor([7.0, -7.0]), rv2)], [agg], 8)
    _, _, carry_out, _ = th.stream_fold_plain(carry, part, [agg])
    assert math.isnan(float(carry_out.states[0][0][0]))


NAN_QUERIES = {
    "direct_varchar_key": """
        select s, min(v), max(v), count(*) from (values
          ('a', 1.0), ('a', nan()), ('a', 2.0), ('b', 3.0), ('b', -1.0),
          ('c', nan())) t(s, v) group by s""",
    "sort_bigint_key": """
        select k, min(v), max(v) from (values
          (1, 1.0), (1, nan()), (2, nan()), (2, 5.0), (3, 4.0),
          (3, 2.0)) t(k, v) group by k""",
    "global": """
        select min(v), max(v) from (values (1.0), (nan()), (3.0)) t(v)""",
}


def _nan_rows(rows):
    return [tuple("nan" if isinstance(x, float) and math.isnan(x) else x
                  for x in r) for r in rows]


@pytest.mark.parametrize("name", sorted(NAN_QUERIES))
def test_nan_min_max_queries_match_reference(name):
    from presto_tpu.runner import LocalRunner as JaxRunner
    from presto_tpu_torch.runner import LocalRunner
    sql = NAN_QUERIES[name]
    got = LocalRunner("tpch", "tiny", device="cpu").execute(sql).rows()
    want = JaxRunner("tpch", "tiny").execute(sql).rows()
    assert_rows_equal(_nan_rows(got), _nan_rows(want), name, False)
    assert any("nan" in r for r in _nan_rows(got))


# -- width caps -----------------------------------------------------------


def test_chunk_helpers():
    assert th.comp_chunks(0) == [(0, 0)]
    assert th.comp_chunks(64) == [(0, 64)]
    assert th.comp_chunks(65) == [(0, 64), (64, 65)]
    aggs = [th.make_avg(tt.DOUBLE)] * 40      # 2 components each
    assert th.agg_chunks(aggs) == [(0, 32), (32, 40)]
    assert th.agg_chunks([]) == [(0, 0)]
    spec = [(1, 2, 3, 4, 8, 0)] * 65
    runs = common.gather_chunks(spec, "t")
    assert [int(r[-1].value) for r in runs] == [64, 1]
    assert [int(r[-1].value) for r in common.gather_chunks([], "t")] == [0]
    with pytest.raises(ValueError, match="at most 64"):
        common.gather_table(spec, "t")


def test_k1_split_over_nine_keys_and_65_components(monkeypatch):
    rng = np.random.default_rng(5)
    n = 4000
    domains = (2, 1, 3, 1, 2, 1, 1, 2, 1)
    keys = [(torch.from_numpy(rng.integers(0, d, n).astype(np.int32)),
             torch.from_numpy(rng.random(n) < 0.9)) for d in domains]
    rv = torch.from_numpy(rng.random(n) < 0.9)
    slots = int(np.prod([d + 1 for d in domains]))
    ops = ["sum", "min", "max"] * 22
    contribs = [torch.from_numpy(rng.normal(0, 10, n)) for _ in ops[:65]]

    def run(fn):
        states = [torch.full((slots,), th._ident_for(o, torch.float64),
                             dtype=torch.float64) for o in ops[:65]]
        present = torch.zeros(slots, dtype=torch.bool)
        fn(rv, keys, domains,
           [(c, s, o) for c, s, o in zip(contribs, states, ops)], present)
        return states, present

    launches = []

    def one_launch(row_valid, key_codes, doms, comps, present):
        assert len(key_codes) <= th.KERNEL_MAX_KEYS
        assert len(comps) <= th.KERNEL_MAX_COMPS
        launches.append(len(comps))
        th.slot_reduce_plain(row_valid, key_codes, doms, comps, present)
    monkeypatch.setattr(th, "_slot_reduce_launch", one_launch)
    got, gp = run(th._slot_reduce_cuda)
    want, wp = run(th.slot_reduce_plain)
    assert launches == [64, 1]
    assert torch.equal(gp, wp)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k3_chained_hash_over_eleven_keys_equals_reference(monkeypatch):
    """Eleven keys hashed as 8 + 3 and chained equal the plain
    row_hash / row_hash2 over all eleven (and so the reference's)."""
    rng = np.random.default_rng(9)
    n = 3000
    keys = []
    for j in range(11):
        d = rng.integers(-5, 5, n)
        keys.append((torch.from_numpy(d.astype(np.float64) if j % 3 == 0
                                      else d),
                     torch.from_numpy(rng.random(n) < 0.85)))
    rv = torch.from_numpy(rng.random(n) < 0.9)
    launches = []

    def one_launch(parts, nulls_invalid):
        (k, row_valid), = parts
        assert len(k) <= common.MAX_KEYS
        launches.append(len(k))
        return common.row_hash_pair_plain(k, row_valid, nulls_invalid)
    monkeypatch.setattr(common, "_row_hash_launch", one_launch)
    for ni in (False, True):
        got = common._row_hash_cuda([(keys, rv)], ni)
        want = common.row_hash_pair_plain(keys, rv, ni)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert launches == [8, 3, 8, 3]
    from presto_tpu.ops import common as rc
    import jax.numpy as jnp
    ref = np.asarray(rc.row_hash([(jnp.asarray(d.numpy()),
                                   jnp.asarray(m.numpy()))
                                  for d, m in keys])).view(np.int64)
    np.testing.assert_array_equal(
        common.row_hash([(d, m) for d, m in keys]).numpy(), ref)


def test_k6_split_over_65_components(monkeypatch):
    rng = np.random.default_rng(2)
    n = 5000
    keys = [(torch.from_numpy(rng.integers(0, 300, n)),
             torch.ones(n, dtype=torch.bool))]
    valid = torch.from_numpy(rng.random(n) < 0.9)
    h1, h2 = common.row_hash_pair_plain(keys, valid, False)
    perm = common.lex_perm([h1, h2])
    sk = [(d[perm], m[perm]) for d, m in keys]
    comps = [(torch.from_numpy(rng.normal(0, 1, n))[perm],
              ["sum", "min", "max"][j % 3]) for j in range(65)]
    launches = []

    def one_launch(a, b, k, v, c, cap):
        assert len(c) <= th.KERNEL_MAX_COMPS
        launches.append(len(c))
        return th.segment_reduce_plain(a, b, k, v, c, cap)
    monkeypatch.setattr(th, "_segment_reduce_launch", one_launch)
    args = (h1[perm], h2[perm], sk, valid[perm], comps, 512)
    got = th._segment_reduce_cuda(*args)
    want = th.segment_reduce_plain(*args)
    assert launches == [64, 1]
    assert len(got[0]) == 65
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g, w)
    assert torch.equal(got[1], want[1]) and int(got[2]) == int(want[2])


@pytest.mark.parametrize("with_carry", [False, True])
def test_k8_split_over_66_components(monkeypatch, with_carry):
    rng = np.random.default_rng(4)
    n = 3000
    ids = np.sort(rng.integers(0, 200, n))
    keys = [(torch.from_numpy(ids), torch.ones(n, dtype=torch.bool))]
    rv = torch.from_numpy(rng.random(n) < 0.9)
    aggs = [th.make_avg(tt.DOUBLE), th.make_min(tt.DOUBLE),
            th.make_max(tt.BIGINT)] * 11         # 66 components
    contribs = []
    for a in aggs:
        x = torch.from_numpy(rng.normal(0, 5, n))
        if a.output_type == tt.BIGINT:
            x = torch.from_numpy(rng.integers(-9, 9, n))
        contribs.append(a.init(x, rv))
    carry = None
    if with_carry:
        first = th.presorted_reduce_plain(rv, keys, contribs, aggs, 512)
        carry = th.GroupByState(
            [(keys[0][0][:1], keys[0][1][:1])],
            [tuple(s[:1] for s in st) for st in first.states],
            torch.ones(1, dtype=torch.bool),
            torch.zeros((), dtype=torch.bool))
    launches = []

    def one_launch(row_valid, kc, cs, ags, out_cap, cy):
        assert sum(len(a.reduces) for a in ags) <= th.KERNEL_MAX_COMPS
        launches.append(len(ags))
        part = th.presorted_reduce_plain(row_valid, kc, cs, ags, out_cap)
        return part if cy is None else th.stream_fold_plain(cy, part, ags)
    monkeypatch.setattr(th, "_stream_reduce_launch", one_launch)
    got = th._stream_reduce_cuda(rv, keys, contribs, aggs, 512, carry)
    part = th.presorted_reduce_plain(rv, keys, contribs, aggs, 512)
    want = part if carry is None else th.stream_fold_plain(carry, part,
                                                           aggs)
    assert launches == [32, 1]   # two components per aggregate
    pairs = [(got, want)] if carry is None else list(zip(got[:3],
                                                         want[:3]))
    for g, w in pairs:
        assert torch.equal(g.valid, w.valid)
        assert len(g.states) == len(w.states) == len(aggs)
        for gs, ws in zip(g.states, w.states):
            for a, b in zip(gs, ws):
                assert torch.equal(a, b)


# -- REAL math --------------------------------------------------------------


@pytest.mark.parametrize("label", sorted(real_function_calls(pir, tt)))
def test_real_math_lowers_and_matches_composed(label):
    from presto_tpu_torch.expr import lowering
    from presto_tpu_torch.operators.fused_fragment import make_chain_body
    st = real_stage(label)
    ce = st.projections[0][1]
    assert ce.lowering is not None, ce.not_lowered
    # the float32 operation is computed in float64 and rounded once
    ops = [n.op for n in lowering.walk(ce.lowering)]
    assert "libm" in ops or "mod" in ops
    body = make_chain_body([st])
    batch = port_batch(3000, 5)
    got, want = standin.run(body.kernel, batch), body.plain(batch)
    g, w = got.columns["o"], want.columns["o"]
    assert g.data.dtype == torch.float32
    assert torch.equal(got.row_valid, want.row_valid)
    assert torch.equal(g.mask, w.mask)
    torch.testing.assert_close(g.data[w.mask], w.data[w.mask],
                               rtol=2.0 ** -20, atol=1e-37,
                               equal_nan=True)


# -- C6: key columns past 8 on K5-K8 -----------------------------------------


def test_key_group_args_pass_groups_of_eight_flat():
    """K5, K7, K8 and K9 take key columns as successive groups of 8
    (csrc/row_hash.cuh KeyGroups); the tables are passed flat, every
    column checked as key_args checks it. Past 24 keys (ROADMAP C6r)
    the groups after the third also go as a descriptor of one KeyCols
    (21 int64 words: 8 data and 8 mask addresses, 8 int32 dtype codes,
    the count) each, whose address follows the last key's."""
    n = 7
    keys = [(torch.arange(n, dtype=dt), torch.ones(n, dtype=torch.bool))
            for dt in [torch.int64, torch.int32, torch.float64,
                       torch.int16] * 5][:17]
    dev = torch.device("cpu")
    kd, km, kt, nk, desc = common.key_group_args(keys, n, dev, "probe")
    assert nk.value == 17 and len(kd) == len(km) == len(kt) == 17
    assert desc is None
    assert list(kd) == [d.data_ptr() for d, _ in keys]
    assert list(kt) == [common.KEY_DTYPES[d.dtype] for d, _ in keys]
    assert [len(g) for g in common.key_groups(keys)] == [8, 8, 1]
    wide = keys * 2
    kd, km, kt, nk, desc = common.key_group_args(wide, n, dev, "probe")
    assert nk.value == 34 and len(kd) == 35 and len(km) == len(kt) == 34
    assert list(kd)[:34] == [d.data_ptr() for d, _ in wide]
    assert kd[34] == desc.data_ptr() and desc.shape == (2, 21)
    assert desc[0, :8].tolist() == [d.data_ptr() for d, _ in wide[24:32]]
    assert desc[0, 8:16].tolist() == [m.data_ptr() for _, m in wide[24:32]]
    assert desc[0, 16:20].numpy().view(np.int32).tolist() == [
        common.KEY_DTYPES[d.dtype] for d, _ in wide[24:32]]
    assert desc[0, 20] == 8 and desc[1, 20] == 2
    assert desc[1, :2].tolist() == [d.data_ptr() for d, _ in wide[32:]]
    assert desc[1, 2:8].tolist() == [0] * 6
    with pytest.raises(ValueError, match="contiguous"):
        common.key_group_args(keys[:8] + [(keys[8][0][::2], keys[8][1])],
                              n, dev, "probe")


def test_k6_folds_keys_past_eight_into_change_flags(monkeypatch):
    """K6's wrapper compares the first 8 keys in the kernel and folds
    the rest into a per-row change byte, one launch per further group:
    here the launches are replaced by the plain compare behind a check
    of the 8-key cap, and the groups equal the plain version's."""
    rng = np.random.default_rng(21)
    n = 4000
    base = rng.integers(0, 40, n)
    keys = [(torch.from_numpy(base % (j + 2)),
             torch.from_numpy(rng.random(n) < 0.95)) for j in range(17)]
    valid = torch.from_numpy(rng.random(n) < 0.9)
    h1, h2 = common.row_hash_pair_plain(keys, valid, False)
    perm = common.lex_perm([h1, h2])
    sk = [(d[perm], m[perm]) for d, m in keys]
    comps = [(torch.from_numpy(rng.normal(0, 1, n))[perm], "sum")]
    seen = []

    def changes(keys_, n_, dev):
        groups = common.key_groups(keys_)[1:]
        seen.append([len(g) for g in groups])
        out = torch.zeros(n_, dtype=torch.uint8)
        for g in groups:
            b = common.boundaries(g, torch.ones(n_, dtype=torch.bool))
            b[0] = False
            out |= b.to(torch.uint8)
        return out

    def one_launch(a, b, k, v, c, cap):
        ch = th._segment_key_changes(k, v.shape[0], v.device)
        first = k[:common.MAX_KEYS]
        assert len(first) <= 8
        bnd = common.boundaries(first, v, hashes=(a, b)) | (
            v & (ch != 0))
        cum = torch.cumsum(bnd.to(torch.int64), 0)
        gid = torch.where(v, torch.clamp(cum - 1, max=cap),
                          torch.full_like(cum, cap))
        red = [th._sorted_reduce(x, gid, cap, r) for x, r in c]
        return red, th._first_rows(bnd, gid, cap), cum[-1], cum[-1] > cap
    monkeypatch.setattr(th, "_segment_key_changes", changes)
    monkeypatch.setattr(th, "_segment_reduce_launch", one_launch)
    args = (h1[perm], h2[perm], sk, valid[perm], comps, 4096)
    got = th._segment_reduce_cuda(*args)
    want = th.segment_reduce_plain(*args)
    assert seen == [[8, 1]]
    assert torch.equal(got[0][0], want[0][0])
    assert torch.equal(got[1], want[1]) and int(got[2]) == int(want[2])


def test_streaming_declines_past_k8_key_groups():
    """A streaming-eligible GROUP BY past 24 keys plans the sort-based
    path (K6 takes any number of keys)."""
    from presto_tpu_torch.operators.aggregation import (
        AggregationOperatorFactory, StreamingAggregationOperatorFactory,
    )
    from presto_tpu_torch.runner import LocalRunner
    r = LocalRunner("tpch", "tiny", device="cpu")

    def kinds(nk):
        cols = ", ".join(["orderkey"] + [f"orderkey + {j} k{j}"
                                         for j in range(nk - 1)])
        by = ", ".join(str(i + 1) for i in range(nk))
        sql = (f"select {cols}, count(*) from (select * from orders order "
               f"by orderkey) group by {by}")
        from presto_tpu_torch.planner.local_planner import (
            LocalExecutionPlanner,
        )
        from presto_tpu_torch.parser import parse_statement
        plan = r._plan_query(parse_statement(sql))
        lp = LocalExecutionPlanner(r.catalogs, r.session, r.device).plan(plan)
        return {type(f).__name__ for p in lp.pipelines for f in p
                if isinstance(f, (AggregationOperatorFactory,
                                  StreamingAggregationOperatorFactory))}
    assert kinds(25) == {"AggregationOperatorFactory"}


#: 9- and 17-key joins and groupings (sort-based and streaming), as SQL
#: over lineitem (SQL reaches a semi join with one key only; its 9- and
#: 17-key marks are compared below at the kernel level)
_K9 = ["orderkey", "partkey", "suppkey", "linenumber", "quantity",
       "returnflag", "linestatus", "shipdate", "shipmode"]
_K17 = _K9 + ["commitdate", "receiptdate", "shipinstruct", "tax",
              "discount", "extendedprice", "orderkey + 1", "partkey + 1"]
WIDE_KEY_QUERIES = {
    f"{kind}{len(keys)}": sql
    for keys in (_K9, _K17)
    for kind, sql in (
        ("join", "select count(*), sum(a.extendedprice) from lineitem a "
         "join lineitem b on " + " and ".join(
             f"a.{k} = b.{k}" if "+" not in k else
             f"a.{k.split()[0]} + 1 = b.{k.split()[0]} + 1" for k in keys)
         + " where a.orderkey < 3000"),
        ("group", "select " + ", ".join(f"{k} g{i}" for i, k in
                                        enumerate(keys))
         + ", count(*), sum(extendedprice) from lineitem where orderkey "
         "< 2000 group by " + ", ".join(str(i + 1) for i in
                                        range(len(keys)))),
        ("stream", "select " + ", ".join(f"{k} g{i}" for i, k in
                                         enumerate(keys[:1] + keys[3:4]
                                                   + keys[1:]))
         + ", count(*) from (select * from lineitem where orderkey < 2000 "
         "order by orderkey, linenumber) group by "
         + ", ".join(str(i + 1) for i in range(len(keys) + 1))))
}


@pytest.mark.parametrize("name", sorted(WIDE_KEY_QUERIES))
def test_wide_key_queries_match_reference(name):
    from presto_tpu.runner import LocalRunner as RefRunner
    from presto_tpu_torch.runner import LocalRunner
    sql = WIDE_KEY_QUERIES[name]
    want = RefRunner("tpch", "tiny").execute(sql).rows()
    got = LocalRunner("tpch", "tiny", device="cpu").execute(sql).rows()
    assert_rows_equal(got, want, name, False)


# -- C7: round / truncate with a column d -----------------------------------


ROUND_QUERIES = {
    f"{fn}_{label}": f"select custkey, {fn}({arg}, nationkey % 3) r, "
                     f"{fn}({arg}, 1 - nationkey % 4) s, {fn}({arg}, 1) c "
                     "from customer"
    for fn in ("round", "truncate")
    for label, arg in (("double", "acctbal"),
                       ("real", "cast(acctbal as real)"),
                       ("bigint", "custkey * 7"))
}


@pytest.mark.parametrize("name", sorted(ROUND_QUERIES))
def test_round_with_column_decimals_matches_reference(name):
    """round(x, d) / truncate(x, d) with a column d: the reference's
    float64 arithmetic, its result types and values (DOUBLE rel_tol
    1e-6), DOUBLE, REAL and BIGINT x, a constant d beside it."""
    from presto_tpu.runner import LocalRunner as RefRunner
    from presto_tpu_torch.runner import LocalRunner
    sql = ROUND_QUERIES[name]
    want = RefRunner("tpch", "tiny").execute(sql)
    got = LocalRunner("tpch", "tiny", device="cpu").execute(sql)
    assert [repr(f.type) for f in got.fields] \
        == [repr(f.type) for f in want.fields]
    assert_rows_equal(got.rows(), want.rows(), name, False)


@pytest.mark.parametrize("fn", ["round", "truncate"])
@pytest.mark.parametrize("arg", ["x", "real"])
def test_round_with_column_decimals_lowers_to_k12(fn, arg):
    """The column-d form lowers (libm pow for 10 ** d), and the
    generated kernel, run through tests/triton_standin.py, equals the
    composed closure exactly."""
    from presto_tpu_torch.expr import lowering
    from presto_tpu_torch.operators.fused_fragment import make_chain_body
    from torch_fragment_cases import function_stage
    x = pir.ref("x", tt.DOUBLE)
    if arg == "real":
        x = pir.SpecialForm("cast", (x,), tt.REAL)
    d = pir.call("modulus", tt.BIGINT, pir.ref("a", tt.BIGINT),
                 pir.Literal(3, tt.BIGINT))
    st = function_stage(pir.call(fn, tt.DOUBLE, x, d))
    ce = st.projections[0][1]
    assert ce.lowering is not None, ce.not_lowered
    assert "libm" in [n.op for n in lowering.walk(ce.lowering)]
    body = make_chain_body([st])
    batch = port_batch(3000, 9)
    got, want = standin.run(body.kernel, batch), body.plain(batch)
    g, w = got.columns["o"], want.columns["o"]
    assert g.data.dtype == w.data.dtype == torch.float64
    assert torch.equal(g.mask, w.mask)
    torch.testing.assert_close(g.data[w.mask], w.data[w.mask], rtol=0,
                               atol=0, equal_nan=True)


def _wide_numpy(rng, base, nkeys):
    """Key columns derived from one int64 base (equal bases, equal
    keys), cycling bigint / integer / double / smallint, with NULLs."""
    kinds = [("bigint", np.int64), ("integer", np.int32),
             ("double", np.float64), ("smallint", np.int16)]
    cols = {}
    for j in range(nkeys):
        tname, dt = kinds[j % 4]
        cols[f"k{j}"] = (((base * (j + 3)) % 20011).astype(dt),
                         rng.random(base.shape[0]) >= 0.03, tname, None)
    return cols, rng.random(base.shape[0]) < 0.9


@pytest.mark.parametrize("nkeys", [9, 17])
@pytest.mark.parametrize("verify", ["hash", "full"])
def test_wide_key_semi_mark_matches_reference(nkeys, verify):
    """K7's plain version at 9 and 17 key columns against the
    reference's `semi_mark` on one numpy build and probe (duplicate
    keys, NULLs in every group of keys), exactly."""
    import jax.numpy as jnp
    from presto_tpu import types as rt
    from presto_tpu.batch import Batch as RBatch, Column as RColumn
    from presto_tpu.ops import join as rj
    from presto_tpu_torch import interop
    from presto_tpu_torch.ops import join as pj
    rng = np.random.default_rng(30 + nkeys)
    nb, npr = 4096, 8192
    bbase = rng.integers(0, 1500, nb)
    pbase = np.where(rng.random(npr) < 0.5, bbase[rng.integers(0, nb, npr)],
                     rng.integers(0, 1 << 40, npr))
    names = tuple(f"k{j}" for j in range(nkeys))
    marks = []
    for base in (bbase, pbase):
        marks.append(_wide_numpy(rng, base, nkeys))
    (bcols, brv), (pcols, prv) = marks

    def ref_batch(cols, rv):
        return RBatch({n: RColumn(jnp.asarray(d), jnp.asarray(m),
                                  rt.parse_type(t), dic)
                       for n, (d, m, t, dic) in cols.items()},
                      jnp.asarray(rv))
    cpu = torch.device("cpu")
    found, valid = (np.asarray(x) for x in rj.semi_mark(
        rj.build_for_backend(ref_batch(bcols, brv), names),
        ref_batch(pcols, prv), names, verify=verify))
    table = pj.build_for_backend(
        interop.batch_from_numpy(bcols, brv, cpu), names)
    probe = interop.batch_from_numpy(pcols, prv, cpu)
    for negate, want in ((False, found), (True, valid & ~found)):
        got = pj.semi_mark(table, probe, names, verify=verify,
                           negate=negate)
        np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < found.sum() < valid.sum() < npr
