"""The TPC-H queries the join slices of the port bring (inner, left and
right hash joins, dynamic filters, sort-based grouping; semi joins and
streaming aggregation; cross joins, scalar subqueries and spools),
through both LocalRunners at `tiny`: the port on the CPU (plain versions
of its kernels) against the JAX package AND against sqlite, compared by
assert_rows_equal's rule (DOUBLE rel_tol 1e-6, everything else exact,
fully ordered queries in order); plus join shapes TPC-H lacks."""

import datetime
import sqlite3

import pytest
import torch

from tpch_queries import QUERIES
from test_tpch_suite import (
    DATE_COLS, EPOCH, FULLY_ORDERED, assert_rows_equal, normalize,
    to_sqlite,
)

from presto_tpu_torch.telemetry import kernels as tk

# one intra-op thread: see tests/test_torch_tpch.py
torch.set_num_threads(1)

_RUNNERS = {}


def _runners(schema):
    if schema not in _RUNNERS:
        from presto_tpu.runner import LocalRunner as JaxRunner
        from presto_tpu_torch.runner import LocalRunner as TorchRunner
        _RUNNERS[schema] = (JaxRunner("tpch", schema),
                            TorchRunner("tpch", schema, device="cpu"))
    return _RUNNERS[schema]


def _check(qn, schema):
    ref, port = _runners(schema)
    want = ref.execute(QUERIES[qn])
    got = port.execute(QUERIES[qn])
    assert got.names == want.names
    assert [repr(f.type) for f in got.fields] \
        == [repr(f.type) for f in want.fields]
    assert_rows_equal(got.rows(), want.rows(), qn, qn in FULLY_ORDERED)
    return got


# -- joins and sort-based grouping ----------------------------------------

#: plannable since the join slice
JOIN_QUERIES = [2, 3, 5, 7, 8, 9, 10, 12, 13, 14, 17]

_TABLES = ["lineitem", "orders", "customer", "supplier", "nation",
           "region", "part", "partsupp"]


@pytest.fixture(scope="module")
def sqlite_tiny():
    ref, _ = _runners("tiny")
    conn = ref.catalogs.connector("tpch")
    db = sqlite3.connect(":memory:")
    for table in _TABLES:
        df = conn.table_pandas("tiny", table)
        for c in DATE_COLS.get(table, []):
            df[c] = [(EPOCH + datetime.timedelta(days=int(d))).isoformat()
                     for d in df[c]]
        df.to_sql(table, db, index=False)
    return db


@pytest.mark.parametrize("qn", JOIN_QUERIES)
def test_join_query_matches_reference_and_sqlite(qn, sqlite_tiny):
    before = dict(tk.CALLS)
    got = _check(qn, "tiny")
    types = [f.type.name for f in got.fields]
    exp = [tuple(r) for r in
           sqlite_tiny.execute(to_sqlite(QUERIES[qn])).fetchall()]
    assert_rows_equal(normalize(got.rows(), types), exp, qn,
                      qn in FULLY_ORDERED)
    assert tk.CALLS["join_build"] > before.get("join_build", 0)
    assert tk.CALLS["join_probe"] > before.get("join_probe", 0)


def test_joins_run_their_families():
    """Q3 takes dynamic filters and the sort-based grouping (with its
    live counts); Q13 takes the left join into a duplicate-key build
    and groups twice by the sort path."""
    for qn, families in ((3, ("dynamic_filter", "agg_step",
                              "agg_count", "agg_finalize")),
                         (13, ("agg_step", "agg_count"))):
        before = dict(tk.CALLS)
        _check(qn, "sf0_01")
        for f in families:
            assert tk.CALLS[f] > before.get(f, 0), (qn, f)


#: join shapes beyond TPC-H's: a right join (planned as a flipped left
#: join), string keys with the same and with different dictionaries
#: (the unified-dictionary remap), a join filter, a double key, and a
#: high-cardinality grouping on string keys
JOIN_SHAPES = [
    ("right", "select n.name, r.name from region r right join nation n "
              "on n.regionkey = r.regionkey and r.name = 'ASIA'"),
    ("string_key", "select r.name, count(n.nationkey) from region r "
                   "left join nation n on r.name = n.name group by r.name"),
    ("string_key_dicts", "select count(*) from lineitem l join orders o "
                         "on l.shipmode = o.orderpriority"),
    ("join_filter", "select count(*), sum(l.quantity) from lineitem l "
                    "join orders o on l.orderkey = o.orderkey "
                    "and l.quantity > o.shippriority + 40"),
    ("double_key", "select count(*) from part p join part q "
                   "on p.retailprice = q.retailprice"),
    ("string_groups", "select c.name, c.phone, sum(o.totalprice) "
                      "from customer c join orders o "
                      "on c.custkey = o.custkey group by c.name, c.phone"),
]


@pytest.mark.parametrize("name,sql", JOIN_SHAPES,
                         ids=[s[0] for s in JOIN_SHAPES])
def test_join_shapes_match_reference(name, sql):
    ref, port = _runners("tiny")
    assert_rows_equal(port.execute(sql).rows(), ref.execute(sql).rows(),
                      name, False)


# -- semi joins and streaming aggregation ---------------------------------

#: plannable since the semi-join slice
SEMI_QUERIES = [4, 16, 18, 20]


@pytest.mark.parametrize("qn", SEMI_QUERIES)
def test_semi_query_matches_reference_and_sqlite(qn, sqlite_tiny):
    before = dict(tk.CALLS)
    got = _check(qn, "tiny")
    types = [f.type.name for f in got.fields]
    exp = [tuple(r) for r in
           sqlite_tiny.execute(to_sqlite(QUERIES[qn])).fetchall()]
    assert_rows_equal(normalize(got.rows(), types), exp, qn,
                      qn in FULLY_ORDERED)
    assert tk.CALLS["semi_join"] > before.get("semi_join", 0)


@pytest.mark.parametrize("qn", SEMI_QUERIES)
def test_semi_query_matches_reference_at_sf0_01(qn):
    """At sf0_01 the builds hold duplicate runs (Q4's lineitem by
    orderkey, Q20's partsupp by suppkey) and Q18's grouping streams
    over several scan batches."""
    _check(qn, "sf0_01")


def _streaming_factories(pipelines):
    return [f for pipe in pipelines for f in pipe
            if type(f).__name__ == "StreamingAggregationOperatorFactory"]


def test_q18_inner_aggregation_streams_in_both_packages():
    """Q18's subquery groups lineitem by orderkey, the order the tpch
    connector declares lineitem sorted by: both planners choose the
    streaming aggregation for it, and only for it."""
    from presto_tpu.planner.local_planner import (
        LocalExecutionPlanner as JPlanner,
    )
    from presto_tpu_torch.parser import parse_statement as tparse
    from presto_tpu_torch.planner.local_planner import (
        LocalExecutionPlanner as TPlanner,
    )
    from presto_tpu.runner import LocalRunner as JaxRunner
    _, port = _runners("tiny")
    # no fragment result cache: a replayed build fragment hides its plan
    ref = JaxRunner("tpch", "tiny", properties={
        "fragment_result_cache_enabled": False})
    jplan = JPlanner(ref.catalogs, ref.session).plan(
        ref._plan_query(None, QUERIES[18]))
    tplan = TPlanner(port.catalogs, port.session, port.device).plan(
        port._plan_query(tparse(QUERIES[18])))
    jstream = _streaming_factories(jplan.pipelines)
    tstream = _streaming_factories(tplan.pipelines)
    assert len(jstream) == len(tstream) == 1
    assert [k for k in tstream[0].args[0]] == list(jstream[0].key_names)
    before = dict(tk.CALLS)
    _check(18, "tiny")
    assert tk.CALLS["agg_stream"] > before.get("agg_stream", 0)



# -- cross joins, scalar subqueries and spools ---------------------------

#: plannable since the fourth slice: Q11 and Q22 cross-join a one-row
#: EnforceSingleRow, Q15 joins against one, Q19 is a cross join with the
#: OR-predicate above it, Q21 shares two subtrees through spools
SLICE4_QUERIES = [11, 15, 19, 21, 22]


@pytest.mark.parametrize("qn", SLICE4_QUERIES)
def test_slice4_query_matches_reference_and_sqlite(qn, sqlite_tiny):
    got = _check(qn, "tiny")
    types = [f.type.name for f in got.fields]
    exp = [tuple(r) for r in
           sqlite_tiny.execute(to_sqlite(QUERIES[qn])).fetchall()]
    assert_rows_equal(normalize(got.rows(), types), exp, qn,
                      qn in FULLY_ORDERED)


@pytest.mark.parametrize("qn", SLICE4_QUERIES)
def test_slice4_query_matches_reference_at_sf0_01(qn):
    """At sf0_01 Q19's cross product (lineitem x part) passes 2^24 slots:
    both packages raise the reference's guard instead of materializing
    it."""
    if qn != 19:
        _check(qn, "sf0_01")
        return
    ref, port = _runners("sf0_01")
    with pytest.raises(Exception) as jerr:
        ref.execute(QUERIES[19])
    with pytest.raises(RuntimeError) as terr:
        port.execute(QUERIES[19])
    assert str(terr.value) == str(jerr.value) == (
        "cross join would materialize 65490000 rows; add a join condition")


def test_slice4_queries_run_their_families():
    """Q11, Q19 and Q22 take the cross product (nested_loop)."""
    for qn in (11, 19, 22):
        before = tk.CALLS["nested_loop"]
        _check(qn, "tiny")
        assert tk.CALLS["nested_loop"] > before, qn


#: cross joins whose product keeps rows: Q19 keeps no line at `tiny` (one
#: NULL) and Q22 no customer at SF1. These keep Q19's plan (a cross join
#: under an OR-predicate) with wider branches, and Q22's with EXISTS.
LIVE_CROSS = {
    "q19_live": """select sum(l.extendedprice * (1 - l.discount)) as revenue,
       count(*) as lines
from lineitem l, part p
where (
        p.partkey = l.partkey
    and p.size between 1 and 25
    and l.quantity <= 25
) or (
        p.partkey = l.partkey
    and p.brand in ('Brand#12', 'Brand#23', 'Brand#34')
    and l.shipinstruct = 'DELIVER IN PERSON'
)""",
    "q22_exists": QUERIES[22].replace("not exists", "exists"),
}


@pytest.mark.parametrize("name", sorted(LIVE_CROSS))
def test_live_cross_variant_matches_reference_and_sqlite(name, sqlite_tiny):
    """The cross product with live rows, through the port against the
    JAX package and sqlite at `tiny`; the result is not empty."""
    sql = LIVE_CROSS[name]
    ref, port = _runners("tiny")
    before = tk.CALLS["nested_loop"]
    got = port.execute(sql)
    assert tk.CALLS["nested_loop"] > before
    want = ref.execute(sql)
    assert got.names == want.names
    assert_rows_equal(got.rows(), want.rows(), name, True)
    rows = normalize(got.rows(), [f.type.name for f in got.fields])
    assert rows and all(v is not None for r in rows for v in r)
    exp = [tuple(r) for r in sqlite_tiny.execute(to_sqlite(sql)).fetchall()]
    assert_rows_equal(rows, exp, name, True)
