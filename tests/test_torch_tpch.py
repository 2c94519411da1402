"""TPC-H through both LocalRunners: the port on the CPU (plain versions
of its kernels) against the JAX package, compared by assert_rows_equal's
rule (DOUBLE rel_tol 1e-6, everything else exact, Q1 in order). The
shapes the port does not plan yet must name the ROADMAP item that
brings them, and every tpch table must reach the port as it reaches
the reference. The join queries are in tests/test_torch_tpch_joins.py.
"""

import numpy as np
import pytest
import torch

from tpch_queries import QUERIES
from test_tpch_suite import FULLY_ORDERED, assert_rows_equal

from presto_tpu_torch.telemetry import kernels as tk

# one intra-op thread: the suite runs several pytest workers side by
# side, and torch's default pool of one thread per core would crowd
# out the timing-sensitive tests of the other workers
torch.set_num_threads(1)

_RUNNERS = {}


def _runners(schema, props):
    key = (schema, tuple(sorted(props.items())))
    if key not in _RUNNERS:
        from presto_tpu.runner import LocalRunner as JaxRunner
        from presto_tpu_torch.runner import LocalRunner as TorchRunner
        _RUNNERS[key] = (JaxRunner("tpch", schema, properties=props),
                         TorchRunner("tpch", schema, properties=props,
                                     device="cpu"))
    return _RUNNERS[key]


def _check(qn, schema, props):
    ref, port = _runners(schema, props)
    want = ref.execute(QUERIES[qn])
    got = port.execute(QUERIES[qn])
    assert got.names == want.names
    assert [repr(f.type) for f in got.fields] \
        == [repr(f.type) for f in want.fields]
    assert_rows_equal(got.rows(), want.rows(), qn, qn in FULLY_ORDERED)
    return got


@pytest.mark.parametrize("schema", ["tiny", "sf0_01"])
@pytest.mark.parametrize("qn", [1, 6])
def test_query_matches_reference(qn, schema):
    before = dict(tk.CALLS)
    _check(qn, schema, {})
    # both queries aggregate through the direct slot table
    assert tk.CALLS["agg_step"] > before.get("agg_step", 0)


def test_q6_compacts_with_large_batches():
    """Q6 keeps ~2% of lineitem: with 1M-row batches its filter output
    is shrunk by the deferred compaction (K2's path). At sf0_01 the
    scan's pushed-down shipdate domain already leaves every batch under
    COMPACT_FLOOR in both packages, so sf0_1 is the smallest scale
    where the shrink runs."""
    before = tk.CALLS["compact"]
    _check(6, "sf0_1", {"batch_rows": 1 << 20})
    assert tk.CALLS["compact"] > before


#: single-pipeline shapes beyond Q1/Q6 that the slice plans: TopN,
#: LIMIT, DESC order, boolean and dictionary keys, string predicates
#: (IN, LIKE, comparisons), CASE, date and decimal arithmetic
EXTRA = [
    ("topn", "select orderkey, linenumber, extendedprice from lineitem "
             "order by extendedprice desc, orderkey limit 7", True),
    ("limit", "select count(*) from (select orderkey from lineitem "
              "where quantity > 45 limit 10) t", True),
    ("bool_key", "select quantity > 25 as big, shipmode, count(*), "
                 "min(shipdate), max(discount) from lineitem "
                 "group by quantity > 25, shipmode", False),
    ("strings", "select returnflag, sum(quantity) from lineitem "
                "where shipmode in ('AIR', 'MAIL') "
                "and shipinstruct like '%BACK%' and linestatus <> 'F' "
                "group by returnflag", False),
    ("case_dates", "select sum(case when extract(year from shipdate) "
                   "= 1995 then extendedprice else 0 end), "
                   "count(*) from lineitem "
                   "where shipdate between date '1995-01-01' "
                   "and date '1995-01-01' + interval '1' year", False),
    ("decimal", "select linestatus, sum(cast(tax as decimal(12,2)) * 2), "
                "avg(cast(discount as decimal(12,2))) from lineitem "
                "group by linestatus order by linestatus", True),
    ("arith", "select sum(cast(linenumber as double) / 3), "
              "sum(linenumber / 2), sum(linenumber % 3), "
              "max(quantity / 7), sum(round(extendedprice, 1)), "
              "sum(abs(linenumber - 4)), sum(sqrt(linenumber)), "
              "sum(floor(discount * 100)) from lineitem", False),
    ("values", "select x * 2, y from (values (1, 'a'), (2, 'b'), "
               "(3, null)) t(x, y) order by x desc", True),
]


@pytest.mark.parametrize("name,sql,ordered", EXTRA,
                         ids=[e[0] for e in EXTRA])
def test_other_shapes_match_reference(name, sql, ordered):
    ref, port = _runners("tiny", {})
    want = ref.execute(sql).rows()
    got = port.execute(sql).rows()
    assert_rows_equal(got, want, name, ordered)


def test_set_session_batch_rows():
    _, port = _runners("tiny", {})
    from presto_tpu_torch.runner import LocalRunner
    r = LocalRunner("tpch", "tiny", device="cpu")
    r.execute("SET SESSION batch_rows = 1024")
    assert r.session.properties["batch_rows"] == 1024
    assert r.execute(QUERIES[6]).rows() == port.execute(QUERIES[6]).rows()


# -- what the port does not plan yet, and the tables ---------------------

#: shapes the port does not plan yet -> the ROADMAP item their error
#: names (every TPC-H query plans since the fourth slice)
LATER_SHAPES = {}
#: shapes that named their item here until the slice that planned them
#: (windows and grouping sets: the sixth; unnest: the seventh); they
#: now match the reference
PLANNED_SINCE = {
    "approx_distinct": "select approx_distinct(nationkey) from customer",
    "unnest": "select x from unnest(array[1, 2]) t(x)",
    "window": "select name, rank() over (order by acctbal) "
              "from customer",
    "grouping_sets": "select nationkey, regionkey, count(*) from nation "
                     "group by grouping sets ((nationkey), (regionkey))",
}

_TABLES = ["lineitem", "orders", "customer", "supplier", "nation",
           "region", "part", "partsupp"]


@pytest.mark.parametrize("name", sorted({**LATER_SHAPES, **PLANNED_SINCE}))
def test_later_shapes_name_their_roadmap_item(name):
    from presto_tpu_torch.runner.local import QueryError
    ref, port = _runners("tiny", {})
    if name in PLANNED_SINCE:
        sql = PLANNED_SINCE[name]
        assert_rows_equal(port.execute(sql).rows(),
                          ref.execute(sql).rows(), name, False)
        return
    sql, item = LATER_SHAPES[name]
    with pytest.raises(QueryError, match=r"later slice of the port "
                       r"\(ROADMAP " + item):
        port.execute(sql)


@pytest.mark.parametrize("table", _TABLES)
def test_tpch_table_matches_reference(table):
    """Every tpch table at tiny through the port's connector: the
    reference's column names, types and dictionaries, and the same
    rows of its first split."""
    from presto_tpu.connectors.spi import TableHandle as JHandle
    from presto_tpu.connectors.tpch import TpchConnector as JConn
    from presto_tpu_torch.connectors.spi import TableHandle as THandle
    from presto_tpu_torch.connectors.tpch import TpchConnector as TConn
    jc, tcn = JConn(), TConn()
    jh, th_ = JHandle("tpch", "tiny", table), THandle("tpch", "tiny",
                                                      table)
    js = jc.metadata.get_table_schema(jh)
    ts = tcn.metadata.get_table_schema(th_)
    assert ts.names == js.names
    for a, b in zip(ts.columns, js.columns):
        assert (repr(a.type), a.dictionary) == (repr(b.type), b.dictionary)
    cols = ts.names
    jsplit = jc.split_manager.get_splits(jh, 4)[0]
    tsplit = tcn.split_manager.get_splits(th_, 4)[0]
    jb = next(iter(jc.page_source.batches(jsplit, cols, 1 << 14)))
    tb_ = next(iter(tcn.page_source.batches(tsplit, cols, 1 << 14)))
    np.testing.assert_array_equal(tb_.row_valid.numpy(),
                                  np.asarray(jb.row_valid))
    for c in cols:
        np.testing.assert_array_equal(tb_.columns[c].data.numpy(),
                                      np.asarray(jb.columns[c].data))
        np.testing.assert_array_equal(tb_.columns[c].mask.numpy(),
                                      np.asarray(jb.columns[c].mask))
