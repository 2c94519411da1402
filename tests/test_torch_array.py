"""Array, map and row columns, array_agg / map_agg and UNNEST through the
port on the CPU, against the JAX package.

- Every non-mesh query of tests/test_array_columns.py and
  tests/test_unnest.py through both LocalRunners at `tiny`: rows equal
  (assert_rows_equal: DOUBLE rel_tol 1e-6, the rest exact, array
  elements in the reference's order), the reference's rejections
  rejected, the x4 width retry with the session untouched.
- The collection itself: `operators/array_agg.collect` (sort, K13's
  plain version, `collect_plain`, the plain version of K17) against the
  reference's `_collect_kernel` on batches built from one numpy seed,
  every output exact (data where the mask is set, masks and lengths
  everywhere, the overflow flag).
"""

import numpy as np
import pytest
import torch

from test_tpch_suite import assert_rows_equal

torch.set_num_threads(1)

_R = {}


def _runners():
    if not _R:
        from presto_tpu.runner import LocalRunner as RefRunner
        from presto_tpu_torch.runner import LocalRunner
        _R["ref"] = RefRunner("tpch", "tiny")
        _R["port"] = LocalRunner("tpch", "tiny", device="cpu")
    return _R["ref"], _R["port"]


#: the reference's own queries (tests/test_array_columns.py and
#: tests/test_unnest.py), by the test they come from
QUERIES = {
    "project_array_literal": "select array[1, 2, 3] a, 7 x",
    "project_map": "select map(array['a','b'], array[1,2]) m",
    "project_row": "select row(1, 'x') r",
    "array_through_subquery":
        "select cardinality(a), a[2] from (select array[10,20,30] a) t",
    "unnest_subquery_array":
        "select x from (select array[1,2] a) t cross join unnest(t.a) u(x) "
        "order by x",
    "array_agg_oracle":
        "select regionkey, array_agg(nationkey) a from nation "
        "group by regionkey order by regionkey",
    "array_agg_varchar":
        "select regionkey, array_agg(name) nm from nation "
        "where nationkey < 4 group by regionkey order by regionkey",
    "map_agg":
        "select regionkey, map_agg(nationkey, name) m from nation "
        "where nationkey < 6 group by regionkey order by regionkey",
    "array_agg_filter":
        "select regionkey, array_agg(nationkey) filter (where nationkey > 10)"
        " a from nation group by regionkey order by regionkey",
    "excluded_row_after_contributor":
        "select g, array_agg(v) filter (where keep) a from (values "
        "(1, 10, true), (1, 11, false), (1, 12, true), (1, 13, false), "
        "(2, 20, false), (2, 21, true)) t(g, v, keep) group by g order by g",
    "map_agg_null_key_after_contributor":
        "select g, map_agg(nullif(k, 0), v) m from (values (1, 7, 70), "
        "(1, 0, 99), (1, 8, 80)) t(g, k, v) group by g",
    "consume_array_agg_inline":
        "select regionkey, cardinality(array_agg(nationkey)) c from nation "
        "group by regionkey order by regionkey",
    "unnest_standalone": "select * from unnest(array[10, 20, 30]) t(x)",
    "unnest_zip_ordinality":
        "select * from unnest(array[1,2,3], array[4,5]) "
        "with ordinality t(a, b, o)",
    "unnest_strings":
        "select s from unnest(array['z', 'x', 'y']) u(s) order by s",
    "unnest_lateral":
        "select r.name, v from region r, "
        "unnest(array[r.regionkey, r.regionkey * 10]) u(v) "
        "where r.regionkey < 2 order by r.name, v",
    "unnest_aggregation":
        "select sum(x), count(*) from unnest(array[1,2,3,4]) t(x)",
    "unnest_join_output":
        "select u.v, count(*) c from lineitem l, "
        "unnest(array[l.quantity, l.discount]) u(v) "
        "group by u.v order by c desc, u.v limit 1",
    "unnest_orders_mixed":
        "select u.v, count(*) c from orders o, "
        "unnest(array[o.custkey, o.orderkey]) u(v) "
        "group by u.v order by c desc, u.v limit 5",
    "split_and_array_functions":
        "select split('a,b,c', ',')[2] as s2, "
        "cardinality(split('a,b,c', ',')) as n, "
        "element_at(split('x:y', ':'), -1) as last_e, "
        "element_at(split('x:y', ':'), 9) as missing, "
        "cardinality(array[10, 20, 30]) as cn, "
        "array[10, 20, 30][1] as first_e, "
        "contains(array[1, 2, 3], 2) as has2, "
        "contains(array[1, 2, 3], 9) as has9, "
        "array_position(array[5, 6, 7], 6) as pos, "
        "array_min(array[5, 2, 9]) as lo, "
        "array_max(array[5, 2, 9]) as hi, "
        "array_join(array['x', 'y'], '-') as joined",
    "width_bucket_descending":
        "select width_bucket(5.0, 10.0, 0.0, 4) a, "
        "width_bucket(5.0, 0.0, 10.0, 4) b",
    "unnest_all_null_array": "select * from unnest(array[null])",
    "unnest_null_then_value":
        "select x from unnest(array[null, 3]) as t(x)",
    "array_agg_of_unnest":
        "select k, array_agg(x) a from (select x, x % 3 k from "
        "unnest(array[5, 1, 4, 2, 3, 6]) t(x)) group by k order by k",
    "array_agg_global":
        "select array_agg(name) a from region",
    "array_agg_two_keys_double":
        "select returnflag, linestatus, array_agg(extendedprice) "
        "filter (where quantity < 2) a from lineitem "
        "group by returnflag, linestatus order by 1, 2",
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_reference(name):
    ref, port = _runners()
    sql = QUERIES[name]
    want = ref.execute(sql)
    got = port.execute(sql)
    assert got.names == want.names
    assert [repr(f.type) for f in got.fields] \
        == [repr(f.type) for f in want.fields]
    assert_rows_equal(got.rows(), want.rows(), name, True)


def test_width_overflow_replans_with_session_untouched():
    from presto_tpu_torch.operators import array_agg as aa
    from presto_tpu_torch.runner import LocalRunner
    from presto_tpu.runner import LocalRunner as RefRunner
    sql = ("select regionkey, array_agg(nationkey) a from nation "
           "group by regionkey order by regionkey")
    small = LocalRunner("tpch", "tiny", {"array_agg_width": 2},
                        device="cpu")
    before = aa.ARRAY_COLLECT_KERNEL.launches
    got = small.execute(sql).rows()
    assert all(len(a) == 5 for _, a in got)
    assert small.session.properties["array_agg_width"] == 2
    assert aa.ARRAY_COLLECT_KERNEL.launches == before  # the CPU twin ran
    want = RefRunner("tpch", "tiny", {"array_agg_width": 2}).execute(sql)
    assert got == want.rows()


def test_width_retry_gives_up_past_the_limit(monkeypatch):
    from presto_tpu_torch.operators import array_agg as aa
    from presto_tpu_torch.runner import LocalRunner, QueryError
    r = LocalRunner("tpch", "tiny", device="cpu")

    def always(self):   # as a width of 8192 would overflow
        raise aa.ArrayAggWidthExceeded(1 << 15)
    monkeypatch.setattr(aa.ArrayAggOperator, "get_output", always)
    with pytest.raises(QueryError, match="element count"):
        r.execute("select regionkey, array_agg(nationkey) from nation "
                  "group by regionkey")
    assert "array_agg_width" not in r.session.properties


@pytest.mark.parametrize("sql,match", [
    ("select array_agg(nationkey) a from nation group by regionkey "
     "order by a", None),
    ("select regionkey, array_agg(nationkey), count(*) from nation "
     "group by regionkey", "combined"),
    ("select * from unnest(1) t(x)", "ARRAY"),
    ("select * from unnest(array[1,2]) t(a, b)", "column names"),
])
def test_rejections(sql, match):
    from presto_tpu_torch.runner import QueryError
    ref, port = _runners()
    with pytest.raises(Exception):
        ref.execute(sql)
    with pytest.raises(QueryError, match=match):
        port.execute(sql)


def test_to_pandas_with_array_column():
    _, port = _runners()
    df = port.execute(
        "select regionkey, array_agg(nationkey) a from nation "
        "group by regionkey order by regionkey").to_pandas()
    assert list(df.columns) == ["regionkey", "a"]
    assert sorted(df["a"][0]) == [0, 5, 14, 15, 16]


# -- the collection against the reference's _collect_kernel -----------------


def _case(seed, n, ngroups, *, dead=0.1, width=4, filt=True, maps=True,
          strings=False, null_keys=0.0):
    """Columns of one collect call from a numpy seed: a BIGINT group key
    (NULLs too), an int8 / float64 / dictionary-coded value, a FILTER,
    and a map key with NULLs."""
    rng = np.random.default_rng(seed)
    cols = {
        "g": (rng.integers(0, ngroups, n).astype(np.int64),
              rng.random(n) >= null_keys, "bigint"),
        "v8": (rng.integers(-100, 100, n).astype(np.int8),
               rng.random(n) < 0.9, "tinyint"),
        "vd": (np.where(rng.random(n) < 0.1, np.nan,
                        rng.normal(0, 10, n)),
               rng.random(n) < 0.9, "double"),
    }
    if strings:
        cols["vs"] = (rng.integers(0, 5, n).astype(np.int32),
                      rng.random(n) < 0.9, "varchar")
    if filt:
        cols["f"] = (rng.random(n) < 0.7, rng.random(n) < 0.9, "boolean")
    if maps:
        cols["mk"] = (rng.integers(0, 50, n).astype(np.int64),
                      rng.random(n) < 0.8, "bigint")
    valid = rng.random(n) >= dead
    specs = [("v8", None, "f" if filt else None), ("vd", None, None)]
    if maps:
        specs.append(("mk", "vd", "f" if filt else None))
    if strings:
        specs.append(("vs", None, None))
    return cols, valid, tuple(specs), width


_DICT = ("a", "b", "c", "d", "e")


def _ref_batch(cols, valid):
    import jax.numpy as jnp
    from presto_tpu import types as rt
    from presto_tpu.batch import Batch, Column
    out = {}
    for name, (d, m, t) in cols.items():
        typ = {"bigint": rt.BIGINT, "tinyint": rt.TINYINT,
               "double": rt.DOUBLE, "varchar": rt.VARCHAR,
               "boolean": rt.BOOLEAN}[t]
        out[name] = Column(jnp.asarray(d), jnp.asarray(m), typ,
                           _DICT if t == "varchar" else None)
    return Batch(out, jnp.asarray(valid))


def _port_batch(cols, valid):
    from presto_tpu_torch import interop
    return interop.batch_from_numpy(
        {name: (d, m, t, _DICT if t == "varchar" else None)
         for name, (d, m, t) in cols.items()}, valid, torch.device("cpu"))


def _assert_cols_equal(got_d, got_m, want_d, want_m, what):
    got_d, got_m = np.asarray(got_d), np.asarray(got_m)
    want_d, want_m = np.asarray(want_d), np.asarray(want_m)
    np.testing.assert_array_equal(got_m, want_m, err_msg=f"{what} mask")
    np.testing.assert_array_equal(got_d[got_m], want_d[want_m],
                                  err_msg=f"{what} data")


CASES = {
    # name: (case kwargs, out_cap or None for the capacity)
    "several_specs_filter_maps": (dict(seed=1, n=3000, ngroups=300), None),
    "exactly_w": (dict(seed=2, n=64, ngroups=16, dead=0.0, width=4,
                       filt=False, maps=False), None),
    "w_plus_one": (dict(seed=3, n=65, ngroups=13, dead=0.0, width=4,
                        filt=False, maps=False), None),
    "out_cap_plus_one_groups": (dict(seed=4, n=200, ngroups=200, width=8),
                                16),
    "all_dead": (dict(seed=5, n=256, ngroups=10, dead=1.0), None),
    "varchar_and_null_keys": (dict(seed=6, n=2000, ngroups=50,
                                   strings=True, null_keys=0.2, width=64),
                              None),
    "no_keys_one_group": (dict(seed=7, n=40, ngroups=1, width=64), None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_collect_matches_reference_kernel(name):
    from presto_tpu.operators.array_agg import _collect_kernel
    from presto_tpu_torch.operators.array_agg import collect
    kwargs, out_cap = CASES[name]
    cols, valid, specs, width = _case(**kwargs)
    n = len(valid)
    if name == "exactly_w":
        cols["g"] = (np.repeat(np.arange(16), 4), np.ones(n, bool),
                     "bigint")
    if name == "w_plus_one":
        g = np.repeat(np.arange(13), 5)
        cols["g"] = (g, np.ones(n, bool), "bigint")
    keys = () if name == "no_keys_one_group" else ("g",)
    out_cap = out_cap or n
    rk, rvalid, routs, rover = _collect_kernel(
        _ref_batch(cols, valid), keys, specs, out_cap, width)
    pk, pvalid, pouts, pover = collect(_port_batch(cols, valid), keys,
                                       specs, out_cap, width)
    rows = pvalid.shape[0]
    assert rows <= out_cap
    # past out_cap groups the reference clips the surplus groups' rows
    # onto its last slot (:126); the flag makes the caller discard the
    # blocks, so that slot is not compared
    cmp = rows - 1 if name == "out_cap_plus_one_groups" else rows
    rvalid = np.asarray(rvalid)
    assert not rvalid[rows:].any()
    np.testing.assert_array_equal(pvalid.numpy(), rvalid[:rows])
    assert bool(pover) == bool(rover)
    for (rd, rm), (pd, pm) in zip(rk, pk):
        _assert_cols_equal(pd, pm, np.asarray(rd)[:rows],
                           np.asarray(rm)[:rows], "key")
    for ro, po in zip(routs, pouts):
        np.testing.assert_array_equal(po[4].numpy(),
                                      np.asarray(ro[4])[:rows])
        for j in (0, 2):
            if ro[j] is None:
                assert po[j] is None
                continue
            rd, rm = np.asarray(ro[j]), np.asarray(ro[j + 1])
            assert not rm[rows:].any()
            _assert_cols_equal(po[j].numpy()[:cmp], po[j + 1].numpy()[:cmp],
                               rd[:cmp], rm[:cmp], f"block {j}")
    if name == "w_plus_one":
        assert bool(pover)
    if name == "exactly_w":
        assert not bool(pover)
    if name == "out_cap_plus_one_groups":
        assert bool(pover) and rows == out_cap


def test_collect_each_slot_has_one_writer():
    """The scatter-collision case at the kernel level: excluded rows
    following contributors never land on a live slot, so the blocks
    hold exactly the contributors in arrival order."""
    from presto_tpu_torch.operators.array_agg import collect_plain
    order = torch.arange(6)
    pid = torch.tensor([0, 0, 0, 0, 1, 1])
    keep = torch.tensor([True, False, True, False, False, True])
    vals = torch.tensor([10, 11, 12, 13, 20, 21])
    ones = torch.ones(6, dtype=torch.bool)
    outs, first, over = collect_plain(order, pid, 6, 2,
                                      [((vals, ones), None, (keep, ones))],
                                      4, 2)
    blk, msk, _, _, lens = outs[0]
    assert lens.tolist() == [2, 1]
    assert blk[msk].tolist() == [10, 12, 21]
    assert first.tolist() == [0, 4] and not bool(over)
