"""The port's distributed path against the JAX package's, on the CPU.

- Merge of sorted runs (ops/merge.py, K19's plain version): each
  package sorts its own runs from the same seeded numpy inputs and
  merges them; the port's output must be a permutation of its inputs,
  agree with its own re-sort, and equal the reference's merge up to the
  ties SQL leaves unordered (NaN, -0.0 / +0.0 and INT64_MIN keys under
  ASC, DESC and NULLS FIRST, dead rows, two keys).
- The PARTIAL and FINAL aggregation states: `direct_intermediate`,
  `intermediate_batch`, the FINAL step's merge of state columns and
  `merge_partials` against the reference's.
- Planning: add_exchanges + fragment_plan give the reference's
  fragments for Q1-Q22, and the exchange-sink fusion the reference's
  `fused[...+all_to_all]` labels.
- Whole queries through `MeshRunner(n_workers=8, device="cpu")` on the
  reference's fast mesh cases: Q3 and Q6 at the mixed broadcast
  threshold and Q3 all-partitioned against the sqlite oracle, Q6 and
  the wave collision query against the reference's MeshRunner, the
  cross-fragment pruning of tests/test_phased_execution.py and a mesh
  CTAS / INSERT round trip; the other TPC-H queries ride the slow tier,
  where the reference keeps its own.
- The named errors of grouped execution and of a mesh across cards.

DOUBLE values compare at rel_tol 1e-6 (the PARTIAL/FINAL split
reassociates float sums), everything else exactly.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpch_queries import QUERIES
from test_tpch_suite import (
    FULLY_ORDERED, SCHEMA, assert_rows_equal, normalize, to_sqlite,
)
from test_tpch_suite import oracle, runner  # noqa: F401 (fixtures)

from presto_tpu import batch as jb
from presto_tpu import types as jt
from presto_tpu.ops import hashagg as jh
from presto_tpu.ops import merge as jm
from presto_tpu.ops.sort import sort_batch as j_sort_batch

from presto_tpu_torch import batch as tb
from presto_tpu_torch import types as tt
from presto_tpu_torch.ops import hashagg as th
from presto_tpu_torch.ops import merge as tm
from presto_tpu_torch.ops.sort import sort_batch as t_sort_batch

torch.set_num_threads(1)

CPU = torch.device("cpu")
INT64_MIN = np.iinfo(np.int64).min
INT64_MAX = np.iinfo(np.int64).max

#: all-integer output; nationkey 0 is a real join key (the reference's
#: wave pad fill collides with it), and `suppkey >= 0` leaves a
#: FilterProject tail that the wave absorbs
#: (tests/test_mesh_parity.py:33-38)
COLLISION_SQL = (
    "SELECT n.nationkey, count(*) AS c "
    "FROM supplier s, nation n "
    "WHERE s.nationkey = n.nationkey AND s.suppkey >= 0 "
    "GROUP BY n.nationkey ORDER BY n.nationkey")


# ---------------------------------------------------------------------------
# merge


def _key_values(rng, kind, n):
    if kind == "bigint":
        pool = np.array([INT64_MIN, INT64_MIN + 1, -7, -1, 0, 1, 5, 9,
                         INT64_MAX], np.int64)
        return rng.choice(pool, n)
    if kind == "double":
        pool = np.array([np.nan, -0.0, 0.0, -np.inf, np.inf, -2.5, 1.0,
                         3.25], np.float64)
        return rng.choice(pool, n)
    if kind == "real":
        pool = np.array([np.nan, -0.0, 0.0, -1.5, 2.0], np.float32)
        return rng.choice(pool, n)
    if kind == "integer":
        return rng.integers(-4, 4, n).astype(np.int32)
    return rng.random(n) < 0.5  # boolean


def _run(rng, kinds, n, cap, ids):
    """Numpy columns of one run: keys k0.. of `kinds`, an id payload,
    NULL keys and dead rows."""
    cols = {}
    for j, kind in enumerate(kinds):
        d = np.zeros(cap, _key_values(rng, kind, 1).dtype)
        d[:n] = _key_values(rng, kind, n)
        cols[f"k{j}"] = (kind, d, rng.random(cap) > 0.15)
    pid = np.zeros(cap, np.int64)
    pid[:n] = ids
    cols["id"] = ("bigint", pid, np.ones(cap, bool))
    rv = np.zeros(cap, bool)
    rv[:n] = rng.random(n) > 0.1
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


MERGE_CASES = {
    "int64_min": ["bigint"],
    "float_nan_zero": ["double"],
    "real": ["real"],
    "two_keys": ["integer", "double"],
    "bool_bigint": ["boolean", "bigint"],
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
@pytest.mark.parametrize("desc,nf", [(False, False), (True, False),
                                     (False, True), (True, True)])
def test_merge_pair_matches_reference(case, desc, nf):
    kinds = MERGE_CASES[case]
    rng = np.random.default_rng(10 * sorted(MERGE_CASES).index(case)
                                + 2 * desc + nf)
    keys = tuple(f"k{j}" for j in range(len(kinds)))
    d, n = (desc,) * len(kinds), (nf,) * len(kinds)
    a_np = _run(rng, kinds, 300, 512, np.arange(300))
    b_np = _run(rng, kinds, 200, 256, np.arange(300, 500))
    ja, jb_ = (j_sort_batch(_jax(*x), keys, d, n) for x in (a_np, b_np))
    ta, tb_ = (t_sort_batch(_torch(*x), keys, d, n) for x in (a_np, b_np))
    want = jm.merge_pair(ja, jb_, keys, d, n)
    got = tm.merge_pair(ta, tb_, keys, d, n)
    assert got.capacity == want.capacity == 768
    g = _live_rows(got, keys)
    # a permutation of the live input rows: every id exactly once
    live_ids = sorted(int(i) for x in (a_np, b_np)
                      for i in x[0]["id"][1][x[1]])
    assert sorted(i for _, i in g) == live_ids
    assert int(got.row_valid.sum()) == len(live_ids)
    assert not got.row_valid[len(live_ids):].any()
    # sorted as the port sorts: equal to its own re-sort of the union
    union = tb.Batch.concat([ta, tb_], 1024)
    resort = _live_rows(t_sort_batch(union, keys, d, n), keys)
    assert _tie_runs(g) == _tie_runs(resort)
    # the reference's rows, up to ties SQL leaves unordered: its
    # ORDER BY of the union
    jun = jb.Batch.concat([ja, jb_], 1024)
    assert _tie_runs(g) == _tie_runs(_live_rows(
        j_sort_batch(jun, keys, d, n), keys))
    # and its merge, where that is a permutation: on the CPU the
    # reference sorts -0.0 and +0.0 as equal but merges them through a
    # totalOrder bitcast, and then drops rows (ROADMAP C8)
    w = _live_rows(want, keys)
    if len(w) == len(live_ids):
        assert _tie_runs(g) == _tie_runs(w)
    else:
        assert any(k == "double" or k == "real" for k in kinds)


def test_merge_runs_matches_reference():
    """A tree of merges over 7 runs with NaN, signed zeros and NULLs
    (DESC) equals the reference's ORDER BY of their union, up to ties."""
    rng = np.random.default_rng(17)
    keys, d, n = ("k0",), (True,), (False,)
    runs, lo = [], 0
    for _ in range(7):
        cnt = int(rng.integers(5, 120))
        runs.append(_run(rng, ["double"], cnt, 128, np.arange(lo, lo + cnt)))
        lo += cnt
    want = jm.merge_runs([j_sort_batch(_jax(*r), keys, d, n) for r in runs],
                         keys, d, n)
    truns = [t_sort_batch(_torch(*r), keys, d, n) for r in runs]
    got = tm.merge_runs(truns, keys, d, n)
    assert got.capacity == want.capacity
    g = _live_rows(got, keys)
    assert sorted(i for _, i in g) == sorted(
        int(i) for r in runs for i in r[0]["id"][1][r[1]])
    jun = jb.Batch.concat([_jax(*r) for r in runs], 1024)
    assert _tie_runs(g) == _tie_runs(_live_rows(
        j_sort_batch(jun, keys, d, n), keys))
    assert _tie_runs(g) == _tie_runs(_live_rows(
        t_sort_batch(tb.Batch.concat(truns, 1024), keys, d, n), keys))


def test_sort_order_of_nan_and_signed_zero():
    """NaN after every number under ASC and DESC alike and -0.0 tied
    with +0.0 (ties keep input order): the order of torch.sort on the
    CPU, and of the reference's sort on the CPU, which the merge's
    compare follows."""
    vals = np.array([1.0, np.nan, -0.0, 0.0, -np.inf, -np.nan], np.float64)
    cols = {"k0": ("double", vals, np.ones(6, bool)),
            "id": ("bigint", np.arange(6), np.ones(6, bool))}
    b = _torch(cols, np.ones(6, bool))
    asc = t_sort_batch(b, ("k0",), (False,), (False,)).to_pydict()["id"]
    dsc = t_sort_batch(b, ("k0",), (True,), (False,)).to_pydict()["id"]
    assert asc == [4, 2, 3, 0, 1, 5]
    assert dsc == [0, 2, 3, 4, 1, 5]
    jb_ = _jax(cols, np.ones(6, bool))
    assert j_sort_batch(jb_, ("k0",), (False,), (False,)) \
        .to_pydict()["id"] == asc
    assert j_sort_batch(jb_, ("k0",), (True,), (False,)) \
        .to_pydict()["id"] == dsc


# ---------------------------------------------------------------------------
# PARTIAL / FINAL aggregation states


def _agg_pair():
    return ([jh.make_sum(jt.DOUBLE, jt.DOUBLE), jh.make_count(None),
             jh.make_min(jt.INTEGER), jh.make_max(jt.BIGINT),
             jh.make_avg(jt.DOUBLE)],
            [th.make_sum(tt.DOUBLE, tt.DOUBLE), th.make_count(None),
             th.make_min(tt.INTEGER), th.make_max(tt.BIGINT),
             th.make_avg(tt.DOUBLE)])


def _agg_inputs(rng, n):
    return [rng.normal(10, 5, n), None,
            rng.integers(-1000, 1000, n).astype(np.int32),
            rng.integers(-(1 << 40), 1 << 40, n), rng.normal(0, 1, n)]


def _assert_batches_close(got, want, names, ordered=True):
    def rows(b, conv):
        d = b.to_pydict()
        return list(zip(*[d[n] for n in names]))
    g, w = rows(got, None), rows(want, None)
    if not ordered:
        g, w = sorted(g, key=str), sorted(w, key=str)
    assert len(g) == len(w)
    for rg, rw in zip(g, w):
        for x, y in zip(rg, rw):
            if isinstance(x, float) or isinstance(y, float):
                assert math.isclose(x, y, rel_tol=1e-9, abs_tol=1e-9), (x, y)
            else:
                assert x == y


def test_direct_partial_and_final_states_match_reference():
    """Direct path: PARTIAL folds raw rows and emits its states as
    columns (direct_intermediate); FINAL folds two such batches' state
    columns with K1's reductions (merge rows) and finalizes."""
    rng = np.random.default_rng(5)
    jaggs, taggs = _agg_pair()
    dom = (5, 2)
    slots = (dom[0] + 1) * (dom[1] + 1)
    out_names = [f"a{i}" for i in range(len(jaggs))]
    jparts, tparts = [], []
    for part in range(2):
        n = 2000
        k0 = rng.integers(0, 5, n).astype(np.int32)
        m0 = rng.random(n) > 0.1
        k1 = rng.integers(0, 2, n).astype(np.int32)
        m1 = np.ones(n, bool)
        rv = rng.random(n) > 0.05
        inputs = _agg_inputs(rng, n)
        w = [rv & (rng.random(n) > 0.1) for _ in inputs]
        js = jh.direct_step(
            jh.direct_init(jaggs, slots), jnp.asarray(rv),
            [(jnp.asarray(k0), jnp.asarray(m0)),
             (jnp.asarray(k1), jnp.asarray(m1))], dom,
            [None if x is None else jnp.asarray(x) for x in inputs],
            [jnp.asarray(x) for x in w], jaggs)
        ts = th.direct_step(
            th.direct_init(taggs, slots, CPU), torch.from_numpy(rv),
            [(torch.from_numpy(k0), torch.from_numpy(m0)),
             (torch.from_numpy(k1), torch.from_numpy(m1))], dom,
            [None if x is None else torch.from_numpy(x) for x in inputs],
            [torch.from_numpy(x) for x in w], taggs)
        kn, ktj, ktt = ["k0", "k1"], [jt.INTEGER] * 2, [tt.INTEGER] * 2
        jparts.append(jh.direct_intermediate(js, kn, ktj, [None, None], dom,
                                             out_names, jaggs))
        tparts.append(th.direct_intermediate(ts, kn, ktt, [None, None], dom,
                                             out_names, taggs))
    state_cols = [f"{o}__s{i}" for o, a in zip(out_names, taggs)
                  for i in range(len(a.state_dtypes))]
    for jp, tp in zip(jparts, tparts):
        assert tp.capacity == jp.capacity
        assert tp.names == jp.names
        _assert_batches_close(tp, jp, ["k0", "k1"] + state_cols)
    # FINAL: both partial batches' states folded into one table
    jfin = jh.direct_init(jaggs, slots)
    tfin = th.direct_init(taggs, slots, CPU)
    for jp, tp in zip(jparts, tparts):
        def parts(b, conv):
            return [tuple(conv(b.columns[f"{o}__s{i}"].data)
                          for i in range(len(a.state_dtypes)))
                    for o, a in zip(out_names, taggs)]
        jfin = jh.direct_step(
            jfin, jp.row_valid,
            [(jp.columns[k].data, jp.columns[k].mask) for k in ("k0", "k1")],
            dom, parts(jp, lambda x: x), [jp.row_valid] * len(jaggs),
            jaggs, [True] * len(jaggs))
        tfin = th.direct_step(
            tfin, tp.row_valid,
            [(tp.columns[k].data, tp.columns[k].mask) for k in ("k0", "k1")],
            dom, parts(tp, lambda x: x), [tp.row_valid] * len(taggs),
            taggs, [True] * len(taggs))
    want = jh.direct_finalize(jfin, ["k0", "k1"], [jt.INTEGER] * 2,
                              [None, None], dom, out_names, jaggs)
    got = th.direct_finalize(tfin, ["k0", "k1"], [tt.INTEGER] * 2,
                             [None, None], dom, out_names, taggs)
    _assert_batches_close(got, want, ["k0", "k1"] + out_names)


def test_sort_partial_and_final_states_match_reference():
    """Sort path: batch_aggregate partials exposed as columns
    (intermediate_batch), merge_partials across partials, then the
    FINAL step's regrouping of state columns; groups compared as sets
    (the port's group order is not the reference's)."""
    rng = np.random.default_rng(9)
    jaggs, taggs = _agg_pair()
    out_names = [f"a{i}" for i in range(len(jaggs))]
    kn = ["k0", "k1"]
    jstates, tstates, jinter, tinter = [], [], [], []
    for part in range(3):
        n = 1500
        k0 = rng.integers(0, 40, n)
        m0 = rng.random(n) > 0.1
        k1 = rng.normal(size=n).round(0)
        m1 = rng.random(n) > 0.05
        rv = rng.random(n) > 0.05
        inputs = _agg_inputs(rng, n)
        w = [rv & (rng.random(n) > 0.1) for _ in inputs]
        js = jh.batch_aggregate(
            jnp.asarray(rv), [(jnp.asarray(k0), jnp.asarray(m0)),
                              (jnp.asarray(k1), jnp.asarray(m1))],
            [None if x is None else jnp.asarray(x) for x in inputs],
            [jnp.asarray(x) for x in w], jaggs, 2048)
        ts = th.batch_aggregate(
            torch.from_numpy(rv), [(torch.from_numpy(k0),
                                    torch.from_numpy(m0)),
                                   (torch.from_numpy(k1),
                                    torch.from_numpy(m1))],
            [None if x is None else torch.from_numpy(x) for x in inputs],
            [torch.from_numpy(x) for x in w], taggs, 2048)
        jstates.append(js)
        tstates.append(ts)
        jinter.append(jh.intermediate_batch(
            js, kn, [jt.BIGINT, jt.DOUBLE], [None, None], out_names, jaggs))
        tinter.append(th.intermediate_batch(
            ts, kn, [tt.BIGINT, tt.DOUBLE], [None, None], out_names, taggs))
    state_cols = [f"{o}__s{i}" for o, a in zip(out_names, taggs)
                  for i in range(len(a.state_dtypes))]
    for jp, tp in zip(jinter, tinter):
        assert tp.names == jp.names
        _assert_batches_close(tp, jp, kn + state_cols, ordered=False)
    jm_ = jh.merge_partials(jstates, jaggs, 4096)
    tm_ = th.merge_partials(tstates, taggs, 4096)
    _assert_batches_close(
        th.finalize(tm_, kn, [tt.BIGINT, tt.DOUBLE], [None, None],
                    out_names, taggs),
        jh.finalize(jm_, kn, [jt.BIGINT, jt.DOUBLE], [None, None],
                    out_names, jaggs), kn + out_names, ordered=False)
    # FINAL over the state columns of all three partials, concatenated
    tcat = tb.Batch.concat(tinter, 8192)
    jcat = jb.Batch.concat(jinter, 8192)

    def final(h, cat, aggs, conv):
        return h.batch_aggregate(
            cat.row_valid, [(cat.columns[k].data, cat.columns[k].mask)
                            for k in kn],
            [tuple(cat.columns[f"{o}__s{i}"].data
                   for i in range(len(a.state_dtypes)))
             for o, a in zip(out_names, aggs)],
            [cat.row_valid] * len(aggs), aggs, 4096, [True] * len(aggs))
    tf = final(th, tcat, taggs, None)
    jf = final(jh, jcat, jaggs, None)
    _assert_batches_close(
        th.finalize(tf, kn, [tt.BIGINT, tt.DOUBLE], [None, None],
                    out_names, taggs),
        jh.finalize(jf, kn, [jt.BIGINT, jt.DOUBLE], [None, None],
                    out_names, jaggs), kn + out_names, ordered=False)


# ---------------------------------------------------------------------------
# planning


def _fragments_and_labels(pkg, sql, props):
    """(fragment text, sorted fused[...+all_to_all] labels) of the
    optimized plan of `sql` in one package: add_exchanges,
    fragment_plan, then task 0 of every non-root fragment planned over
    8-worker exchanges."""
    if pkg == "jax":
        from presto_tpu.operators.exchange_ops import (
            MeshExchange, edge_key_dicts,
        )
        from presto_tpu.parallel import make_mesh
        from presto_tpu.planner.exchanges import add_exchanges, fragment_plan
        from presto_tpu.planner.local_planner import (
            LocalExecutionPlanner, TaskContext, prune_unused_columns,
        )
        from presto_tpu.planner.optimizer import optimize
        from presto_tpu.runner import LocalRunner
        r = LocalRunner("tpch", SCHEMA, props)
        mesh = make_mesh(8)

        def planner(exchanges):
            return LocalExecutionPlanner(r.catalogs, r.session,
                                         task=TaskContext(
                                             index=0, count=8,
                                             exchanges=exchanges))
    else:
        from presto_tpu_torch.operators.exchange_ops import (
            MeshExchange, edge_key_dicts,
        )
        from presto_tpu_torch.parallel import make_mesh
        from presto_tpu_torch.planner.exchanges import (
            add_exchanges, fragment_plan,
        )
        from presto_tpu_torch.planner.local_planner import (
            LocalExecutionPlanner, TaskContext, prune_unused_columns,
        )
        from presto_tpu_torch.planner.optimizer import optimize
        from presto_tpu_torch.runner import LocalRunner
        r = LocalRunner("tpch", SCHEMA, props, device="cpu")
        mesh = make_mesh(8, "cpu")

        def planner(exchanges):
            return LocalExecutionPlanner(r.catalogs, r.session, CPU,
                                         task=TaskContext(
                                             index=0, count=8,
                                             exchanges=exchanges))
    plan = optimize(r.create_plan(sql), r.catalogs, session=r.session)
    prune_unused_columns(plan)
    fplan = fragment_plan(add_exchanges(plan, r.catalogs, r.session))

    def tasks(f):
        return 1 if f.partitioning == "single" else 8
    exchanges = {
        xid: MeshExchange(xid, e.scheme, e.partition_keys, e.hash_dicts,
                          edge_key_dicts(e), mesh,
                          n_producers=tasks(fplan.fragments[e.producer]),
                          n_consumers=tasks(fplan.fragments[e.consumer]))
        for xid, e in fplan.edges.items()}
    labels = []
    for fid, frag in sorted(fplan.fragments.items()):
        if fid == fplan.root_id:
            continue
        p = planner(exchanges)
        p.plan_fragment(frag.root, [exchanges[e.exchange_id]
                                    for e in fplan.producer_edges(fid)])
        labels += [e["fused"] for e in (p.fusion_report or {}).get(
            "fragments", []) if e["fused"]
            and e["fused"].endswith("+all_to_all]")]
    return fplan.text(), sorted(labels)


@pytest.mark.parametrize("qn", sorted(QUERIES))
def test_fragments_and_sink_fusion_match_reference(eight_devices, qn):
    props = {"broadcast_join_threshold_rows": 0}
    jtext, jlabels = _fragments_and_labels("jax", QUERIES[qn], props)
    ttext, tlabels = _fragments_and_labels("torch", QUERIES[qn], props)
    assert ttext == jtext
    assert tlabels == jlabels


# ---------------------------------------------------------------------------
# whole queries

_MESH = {}


def _mesh(props, n_workers=8):
    from presto_tpu_torch.runner import MeshRunner
    key = (tuple(sorted(props.items())), n_workers)
    if key not in _MESH:
        _MESH[key] = MeshRunner("tpch", SCHEMA, props, n_workers=n_workers,
                                device="cpu")
    return _MESH[key]


def _check_oracle(res, qn, oracle):  # noqa: F811
    types = [f.type.name for f in res.fields]
    got = normalize(res.rows(), types)
    exp = [tuple(r) for r in oracle.execute(to_sqlite(QUERIES[qn]))]
    assert_rows_equal(got, exp, qn, qn in FULLY_ORDERED)


#: the reference's fast mesh battery (tests/test_mesh_tpch.py:62)
MESH_SMOKE = {3, 6}


@pytest.mark.parametrize("qn", [
    qn if qn in MESH_SMOKE else pytest.param(qn, marks=pytest.mark.slow)
    for qn in sorted(QUERIES)])
def test_mesh_tpch_query(qn, oracle):  # noqa: F811
    """Mixed broadcast threshold: nation / region / supplier broadcast,
    the larger tables repartition through the wave."""
    _check_oracle(_mesh({"broadcast_join_threshold_rows": 500})
                  .execute(QUERIES[qn]), qn, oracle)


@pytest.mark.parametrize("qn", [
    3] + [pytest.param(q, marks=pytest.mark.slow) for q in (5, 10, 18)])
def test_mesh_tpch_all_partitioned(qn, oracle):  # noqa: F811
    _check_oracle(_mesh({"broadcast_join_threshold_rows": 0})
                  .execute(QUERIES[qn]), qn, oracle)


@pytest.fixture(scope="module")
def reference_mesh(eight_devices):
    from presto_tpu.runner import MeshRunner
    return MeshRunner("tpch", SCHEMA, {"broadcast_join_threshold_rows": 0},
                      n_workers=8)


@pytest.mark.parametrize("what", ["q6", "collision"])
def test_mesh_matches_reference_mesh(what, reference_mesh):
    sql = QUERIES[6] if what == "q6" else COLLISION_SQL
    want = reference_mesh.execute(sql)
    got = _mesh({"broadcast_join_threshold_rows": 0}).execute(sql)
    assert got.names == want.names
    # all-integer collision rows compare exactly, in order
    assert_rows_equal(got.rows(), want.rows(), what, True)
    if what == "collision":
        labels = [e["fused"] for e in got.fusion_report["fragments"]
                  if e["fused"]]
        assert "fused[filter_project+all_to_all]" in labels


def test_mesh_order_by_merges_sorted_runs():
    """A distributed ORDER BY: every task sorts its shard, the single
    consumer merges the runs (MergeNode, K19's plain version). At
    sf0_1 orders spans 7 splits, so 7 tasks send a run: 6 merges."""
    from presto_tpu_torch.runner import LocalRunner, MeshRunner
    from presto_tpu_torch.telemetry import kernels as tk
    sql = ("select orderkey, custkey, totalprice from orders "
           "order by totalprice desc, orderkey")
    mesh = MeshRunner("tpch", "sf0_1", {}, n_workers=8, device="cpu")
    text = mesh.explain_text(sql)
    assert "Merge[" in text and "Fragment 1 [distributed]" in text
    before = tk.CALLS["merge"]
    got = mesh.execute(sql).rows()
    assert tk.CALLS["merge"] - before == 6
    assert got == LocalRunner("tpch", "sf0_1", device="cpu") \
        .execute(sql).rows()


def test_width_three_mesh_matches_local(runner):  # noqa: F811
    for qn in (3, 13):
        got = _mesh({}, n_workers=3).execute(QUERIES[qn])
        want = runner.execute(QUERIES[qn])
        assert_rows_equal(got.rows(), want.rows(), qn, qn in FULLY_ORDERED)


def test_cross_fragment_pruning(monkeypatch):
    """The repartitioned join's build (supplier, nationkey 3) publishes
    a dynamic filter to the lineitem scans of another fragment; every
    lineitem batch is pruned by it, to under half of the table (the
    reference's test_phased_execution.py:80)."""
    from presto_tpu_torch.execution import dynamic_filters as df
    seen = []
    orig = df.apply

    def spy(batch, col, f):
        out = orig(batch, col, f)
        seen.append((col, int(batch.row_valid.sum()),
                     int(out.row_valid.sum())))
        return out
    monkeypatch.setattr(df, "apply", spy)
    from presto_tpu_torch.runner import MeshRunner
    mesh = MeshRunner("tpch", SCHEMA,
                      {"target_splits": 8,
                       "broadcast_join_threshold_rows": 0},
                      n_workers=8, device="cpu")
    sql = ("select count(*) from lineitem l join supplier s "
           "on l.suppkey = s.suppkey where s.nationkey = 3")
    got = mesh.execute(sql).rows()
    from presto_tpu.runner import LocalRunner
    assert got == LocalRunner("tpch", SCHEMA).execute(sql).rows()
    total = mesh.execute("select count(*) from lineitem").rows()[0][0]
    pruned = [(b, a) for col, b, a in seen if col.startswith("suppkey")]
    assert pruned, seen
    assert sum(b for b, _ in pruned) == total
    assert sum(a for _, a in pruned) < total / 2


def test_mesh_ctas_roundtrip():
    """Scaled writers: CTAS and INSERT through the memory connector run
    their writers as mesh tasks (tests/test_scaled_writers.py:72)."""
    from presto_tpu_torch.runner import MeshRunner
    m = MeshRunner("tpch", SCHEMA, {"target_splits": 8}, n_workers=8,
                   device="cpu")
    m.execute("create table memory.default.sw1 as "
              "select orderkey, custkey, totalprice from orders")
    assert m.execute("select count(*) from memory.default.sw1").rows() \
        == m.execute("select count(*) from orders").rows()
    m.execute("insert into memory.default.sw1 "
              "select orderkey + 1000000, custkey, totalprice "
              "from orders where orderkey < 100")
    a = m.execute("select count(*), sum(totalprice) "
                  "from memory.default.sw1").rows()
    base = m.execute("select count(*), sum(totalprice) from orders").rows()
    extra = m.execute("select count(*), sum(totalprice) from orders "
                      "where orderkey < 100").rows()
    assert a[0][0] == base[0][0] + extra[0][0]
    assert abs(a[0][1] - (base[0][1] + extra[0][1])) < 1e-5


# ---------------------------------------------------------------------------
# named errors


def test_grouped_execution_raises_naming_a10():
    from presto_tpu_torch.operators.exchange_ops import (
        GroupedExecutionError,
    )
    m = _mesh({"broadcast_join_threshold_rows": 0, "lifespans": 4})
    with pytest.raises(GroupedExecutionError, match="A10"):
        m.execute("select custkey, count(*) from orders group by custkey")


def test_mesh_across_cards_raises_naming_a17(monkeypatch):
    from presto_tpu_torch.parallel import MeshSpansCardsError, make_mesh
    from presto_tpu_torch.runner import MeshRunner
    # two visible cards: the default mesh (one worker per card) spans them
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(MeshSpansCardsError, match="A17"):
        make_mesh()
    with pytest.raises(MeshSpansCardsError, match="A17"):
        MeshRunner("tpch", SCHEMA)


def test_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from presto_tpu_torch.runner import MeshRunner
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshRunner("tpch", SCHEMA, n_workers=8)
