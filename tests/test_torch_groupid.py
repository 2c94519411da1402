"""Grouping sets through the port on the CPU (GroupIdNode planned as
`operators/misc_ops.py` GroupIdOperator): rollups, cubes, explicit
grouping sets, grouping() and the TPC-DS rollup shapes of
tests/test_tpcds_rollup.py (q27, q67 spine), against the reference's
LocalRunner (assert_rows_equal: DOUBLE rel_tol 1e-6, the rest exact;
as multisets where the query has no ORDER BY).
"""

import pytest
import torch

from test_tpch_suite import assert_rows_equal

torch.set_num_threads(1)

TPCH = {
    "rollup": "select returnflag, linestatus, count(*) c, "
              "sum(quantity) q from lineitem "
              "group by rollup(returnflag, linestatus)",
    "cube": "select returnflag, linestatus, count(*) c from lineitem "
            "group by cube(returnflag, linestatus)",
    "explicit_sets": "select returnflag, linestatus, count(*) c "
                     "from lineitem group by grouping sets "
                     "((returnflag), (linestatus), ())",
    "plain_with_rollup": "select returnflag, linestatus, count(*) c "
                         "from lineitem group by returnflag, "
                         "rollup(linestatus)",
    "grouping_fn": "select returnflag, linestatus, "
                   "grouping(returnflag, linestatus) g, count(*) c "
                   "from lineitem group by rollup(returnflag, linestatus) "
                   "order by returnflag, linestatus",
    "aggregated_key": "select returnflag, count(returnflag) c "
                      "from lineitem group by rollup(returnflag)",
    "single_set": "select returnflag, grouping(returnflag) from lineitem "
                  "group by grouping sets ((returnflag)) "
                  "order by returnflag",
    "mixed_distinct": "select returnflag, grouping(returnflag) g, "
                      "count(distinct linestatus) dl, count(quantity) cq "
                      "from lineitem group by rollup(returnflag)",
    "bigint_keys_having": "select nationkey, mktsegment, "
                          "grouping(nationkey, mktsegment) g, "
                          "sum(acctbal) s from customer "
                          "group by cube(nationkey, mktsegment) "
                          "having count(*) > 2",
}

_BASE27 = """
    from store_sales, customer_demographics, date_dim, store, item
    where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
      and ss_store_sk = s_store_sk and ss_cdemo_sk = cd_demo_sk
      and cd_gender = 'M' and d_year = 2000"""
TPCDS = {
    "q27_shape": f"""
        select i_item_id, s_state, grouping(i_item_id, s_state) g,
               avg(ss_quantity) agg1, avg(ss_list_price) agg2 {_BASE27}
        group by rollup(i_item_id, s_state)
        order by i_item_id, s_state
        limit 200""",
    "q67_shape": """
        select i_category, i_class, i_brand,
               sum(ss_ext_sales_price) s
        from store_sales, date_dim, item
        where ss_sold_date_sk = d_date_sk and ss_item_sk = i_item_sk
          and d_moy = 11
        group by rollup(i_category, i_class, i_brand)
        order by i_category, i_class, i_brand
        limit 100""",
    "q36_cube": """
        select i_category, i_class, grouping(i_category, i_class) g,
               sum(ss_net_profit) / sum(ss_ext_sales_price) gm
        from store_sales, date_dim, item
        where d_date_sk = ss_sold_date_sk and i_item_sk = ss_item_sk
          and d_year = 2000
        group by cube(i_category, i_class)""",
}

_RUNNERS = {}


def _runners(catalog):
    if catalog not in _RUNNERS:
        from presto_tpu.runner import LocalRunner as JaxRunner
        from presto_tpu_torch.runner import LocalRunner as TorchRunner
        _RUNNERS[catalog] = (JaxRunner(catalog, "tiny"),
                             TorchRunner(catalog, "tiny", device="cpu"))
    return _RUNNERS[catalog]


def _check(catalog, name, sql):
    ref, port = _runners(catalog)
    got = port.execute(sql)
    want = ref.execute(sql)
    assert got.names == want.names
    assert [repr(f.type) for f in got.fields] \
        == [repr(f.type) for f in want.fields]
    ordered = "order by" in sql
    assert_rows_equal(got.rows(), want.rows(), name, ordered)
    return got.rows()


@pytest.mark.parametrize("name", sorted(TPCH))
def test_grouping_sets_match_reference(name):
    rows = _check("tpch", name, TPCH[name])
    if name == "grouping_fn":
        for rf, ls, g, _ in rows:
            assert g == (0 if rf is not None else 2) \
                + (0 if ls is not None else 1)


@pytest.mark.parametrize("name", sorted(TPCDS))
def test_tpcds_rollup_shapes_match_reference(name):
    _check("tpcds", name, TPCDS[name])


def test_group_id_operator_masks_absent_keys():
    """The operator alone: one batch in, one batch per grouping set out,
    the absent keys NULL (their data untouched), a constant group id
    and the grouping() bitmask columns; aggregation arguments pass
    through."""
    from presto_tpu_torch.batch import Batch
    from presto_tpu_torch.operators.base import (
        DriverContext, OperatorContext,
    )
    from presto_tpu_torch.operators.misc_ops import GroupIdOperator
    from presto_tpu_torch.types import BIGINT, DOUBLE
    b = Batch.from_pydict({"a": ([1, 2, None], BIGINT),
                           "b": ([4, 5, 6], BIGINT),
                           "v": ([0.5, 1.5, 2.5], DOUBLE)})
    ctx = OperatorContext(1, "group_id",
                          DriverContext(device=torch.device("cpu")))
    op = GroupIdOperator(ctx, [("a", "b"), ("a",), ()], "gid",
                         [("g", (0, 1, 3))])
    op.add_input(b)
    op.finish()
    outs = []
    while (o := op.get_output()) is not None:
        outs.append(o)
    assert op.is_finished() and len(outs) == 3
    n = 3
    for g, (o, present) in enumerate(zip(outs, ("ab", "a", ""))):
        for k in "ab":
            m = o.columns[k].mask[:n].tolist()
            if k in present:
                assert m == b.columns[k].mask[:n].tolist()
            else:
                assert m == [False] * n
            assert torch.equal(o.columns[k].data, b.columns[k].data)
        assert o.columns["gid"].data[:n].tolist() == [g] * n
        assert o.columns["g"].data[:n].tolist() == [(0, 1, 3)[g]] * n
        assert o.columns["v"] is b.columns["v"]
