"""approx_percentile, approx_distinct and checksum in the port against
the reference (presto_tpu) on the CPU: the same sketches, so the same
rows exactly. The cases are those of tests/test_approx_percentile.py
and tests/test_approx_distinct.py, run as SQL through both packages'
LocalRunner at `tiny`, plus the sketches' per-row contributions (the
port's sparse pair against the reference's one-hot row) and checksum
over each column type.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu.ops import hashagg as jh
from presto_tpu.types import BIGINT as JBIGINT
from presto_tpu_torch.ops import hashagg as th
from presto_tpu_torch.types import BIGINT, DOUBLE

# one intra-op thread: see tests/test_torch_tpch.py
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runners():
    from presto_tpu.runner import LocalRunner as JaxRunner
    from presto_tpu_torch.runner import LocalRunner
    return JaxRunner("tpch", "tiny"), LocalRunner("tpch", "tiny",
                                                  device="cpu")


def _same(runners, sql, ordered=False):
    ref, port = runners
    want = ref.execute(sql).rows()
    got = port.execute(sql).rows()
    if not ordered:
        want, got = sorted(want, key=repr), sorted(got, key=repr)
    assert got == want, (sql, got[:5], want[:5])
    return got


PERCENTILE_SQL = {
    **{f"global_p{p}": f"select approx_percentile(extendedprice, {p}) "
                       "from lineitem" for p in (0.1, 0.5, 0.9, 0.99)},
    "grouped": "select returnflag, approx_percentile(quantity, 0.5) p "
               "from lineitem group by returnflag order by returnflag",
    "negative_and_zero": "select approx_percentile(v, 0.5), "
                         "approx_percentile(v, 0.1) from (values "
                         "(-100.0), (-10.0), (0.0), (10.0), (100.0)) "
                         "as t(v)",
    "mixed": "select count(*), approx_percentile(quantity, 0.9), "
             "sum(quantity) from lineitem",
    "many_groups": "select orderkey, approx_percentile(extendedprice, "
                   "0.75) from lineitem group by orderkey",
    "with_nulls": "select custkey % 7, approx_percentile(nullif(totalprice"
                  ", totalprice), 0.5), approx_percentile(totalprice, 0.3)"
                  " from orders group by custkey % 7",
}


@pytest.mark.parametrize("name", sorted(PERCENTILE_SQL))
def test_approx_percentile_rows_equal_reference(runners, name):
    _same(runners, PERCENTILE_SQL[name], "order by" in PERCENTILE_SQL[name])


DISTINCT_SQL = {
    "global": "select approx_distinct(custkey) from orders",
    "grouped": "select orderstatus, approx_distinct(custkey) from orders "
               "group by orderstatus order by orderstatus",
    "varchar": "select approx_distinct(mktsegment) from customer",
    "explicit_error": "select approx_distinct(orderkey, 0.01) from orders",
    "with_filter": "select approx_distinct(custkey) filter (where "
                   "totalprice > 100000) from orders",
    "all_null": "select approx_distinct(nullif(custkey, custkey)) "
                "from orders",
    "double_and_date": "select approx_distinct(extendedprice), "
                       "approx_distinct(shipdate, 0.26) from lineitem",
    "many_groups": "select partkey, approx_distinct(suppkey) from "
                   "lineitem group by partkey",
}


@pytest.mark.parametrize("name", sorted(DISTINCT_SQL))
def test_approx_distinct_rows_equal_reference(runners, name):
    rows = _same(runners, DISTINCT_SQL[name],
                 "order by" in DISTINCT_SQL[name])
    if name == "all_null":
        assert rows == [(0,)]


CHECKSUM_SQL = {
    "bigint": "select checksum(orderkey) from lineitem",
    "double": "select checksum(extendedprice) from lineitem",
    "varchar": "select checksum(comment) from lineitem",
    "date": "select checksum(shipdate) from lineitem",
    "grouped": "select returnflag, linestatus, checksum(partkey), "
               "count(*) from lineitem group by 1, 2",
    "sort_path": "select custkey, checksum(orderkey) from orders "
                 "group by custkey",
    "with_nulls": "select checksum(nullif(orderkey % 5, 0)) from orders",
    "empty": "select checksum(orderkey) from orders where orderkey < 0",
}


@pytest.mark.parametrize("name", sorted(CHECKSUM_SQL))
def test_checksum_rows_equal_reference(runners, name):
    _same(runners, CHECKSUM_SQL[name])


def test_all_three_in_one_grouping(runners):
    """The three aggregates with the scalar ones in one direct-path
    GROUP BY and one sort-path GROUP BY (K1 / K3-K6 with K30)."""
    for keys in ("returnflag, linestatus", "suppkey"):
        _same(runners, f"select {keys}, approx_percentile(quantity, 0.5), "
                       "approx_distinct(orderkey), checksum(linenumber), "
                       f"avg(discount), count(*) from lineitem group by "
                       f"{keys}")


def test_presorted_input_is_grouped_by_the_hash_path(runners):
    """Rows arriving sorted by the group key would take the streaming
    fold (K8), which folds scalar states only: an aggregation with a
    vector state is grouped by the hash path, with the same rows."""
    _same(runners, "select orderkey, approx_percentile(quantity, 0.5), "
                   "approx_distinct(partkey), sum(quantity) from (select * "
                   "from lineitem order by orderkey) group by orderkey")


def test_validation_matches_reference(runners):
    from presto_tpu_torch.runner.local import QueryError
    _, port = runners
    with pytest.raises(QueryError, match="percentile"):
        port.execute("select approx_percentile(quantity, 1.5) from lineitem")
    with pytest.raises(QueryError, match="constant"):
        port.execute("select approx_percentile(quantity, quantity) "
                     "from lineitem")
    with pytest.raises(QueryError):
        port.execute("select approx_distinct(custkey, 0.5) from orders")


def test_distinct_merge_order_independent():
    """Register max-merge: any chunking into partials gives the same
    sketch (the reference's test_merge_order_independent), through the
    port's batch_aggregate and merge_partials."""
    fn = th.make_approx_distinct(BIGINT)

    def sketch(chunks):
        parts = []
        for c in chunks:
            x = torch.from_numpy(c.astype(np.int64))
            ones = torch.ones(len(c), dtype=torch.bool)
            parts.append(th.batch_aggregate(ones, [], [x], [ones], [fn], 1))
        return th.merge_partials(parts, [fn], 1).states[0][0]
    vals = np.arange(50_000)
    a = sketch([vals])
    b = sketch([vals[30_000:], vals[:30_000], vals[::2]])
    assert torch.equal(a, b)
    assert a.shape == (1, th.hll_registers_for_error(th.HLL_DEFAULT_ERROR))


def test_percentile_buckets_equal_reference():
    """Each value's bucket, the port's `_pctl_bucket` against the
    reference's (its `log` on the CPU beside XLA's), and the bucket
    values table."""
    rng = np.random.default_rng(5)
    v = np.concatenate([
        rng.lognormal(0.0, 6.0, 20_000) * rng.choice([-1, 1], 20_000),
        [0.0, -0.0, 1e-13, -1e-13, 1e-12, 1.0, -1.0, 3e6, -3e6, 1e300,
         -1e300], 1.06 ** (np.arange(-300, 300) + 0.5)])
    got = th._pctl_bucket(torch.from_numpy(v)).numpy()
    want = np.asarray(jh._pctl_bucket(jnp.asarray(v)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(th._pctl_values(), jh._pctl_values())


@pytest.mark.parametrize("err", [0.26, 0.023, 0.01])
def test_distinct_contribution_is_the_one_hot_row(err):
    """The port's sparse (register, value) pair per row stands for the
    reference's one-hot [rows, m] contribution row."""
    rng = np.random.default_rng(6)
    n = 4000
    x = rng.integers(-1 << 62, 1 << 62, n)
    w = rng.random(n) < 0.9
    jfn = jh.make_approx_distinct(JBIGINT, err)
    tfn = th.make_approx_distinct(BIGINT, err)
    dense = np.asarray(jfn.init(jnp.asarray(x), jnp.asarray(w))[0])
    sp = tfn.init(torch.from_numpy(x), torch.from_numpy(w))[0]
    m = dense.shape[1]
    assert tfn.state_dtypes == ((np.int8, m),) and m == \
        jh.hll_registers_for_error(err)
    rebuilt = np.zeros((n, m), dtype=np.int8)
    rebuilt[np.arange(n), sp.index.numpy()] = sp.value.numpy()
    np.testing.assert_array_equal(rebuilt, dense)


def test_percentile_contribution_is_the_one_hot_row():
    rng = np.random.default_rng(7)
    n = 3000
    x = rng.normal(0, 1e3, n)
    w = rng.random(n) < 0.8
    dense = np.asarray(jh.make_approx_percentile(0.5).init(
        jnp.asarray(x), jnp.asarray(w))[0])
    sp = th.make_approx_percentile(0.5).init(torch.from_numpy(x),
                                             torch.from_numpy(w))[0]
    rebuilt = np.zeros_like(dense)
    rebuilt[np.arange(n), sp.index.numpy()] = sp.value.numpy()
    np.testing.assert_array_equal(rebuilt, dense)


def test_mesh_colocates_the_sketches(runners):
    """On the port's mesh the sketches are never split PARTIAL / FINAL
    (NO_SPLIT_AGGS): the rows equal the single-device run's."""
    from presto_tpu_torch.runner import MeshRunner
    sql = ("select returnflag, approx_percentile(extendedprice, 0.5), "
           "approx_distinct(orderkey), checksum(partkey) from lineitem "
           "group by returnflag")
    _, port = runners
    got = MeshRunner("tpch", "tiny", n_workers=2, device="cpu") \
        .execute(sql).rows()
    assert sorted(got) == sorted(port.execute(sql).rows())


def test_double_percentile_state_is_never_dense():
    """A batch's histogram contribution is one (bucket, 1) pair per row,
    never a [rows, 1024] one-hot."""
    fn = th.make_approx_percentile(0.5)
    x = torch.linspace(1.0, 100.0, 1 << 16, dtype=torch.float64)
    c = fn.init(x, torch.ones(x.shape[0], dtype=torch.bool))[0]
    assert isinstance(c, th.Sparse)
    assert c.index.shape == c.value.shape == x.shape
    assert fn.output_type == DOUBLE
