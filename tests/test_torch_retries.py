"""Overflow re-runs (ROADMAP C5): the port re-runs a query after a join
overflowing its output capacity or a grouping overflowing its table as
often as the reference does, at `sf0_1`.

A LookupJoin's output capacity is its probe batch's capacity times the
expansion factor. The reference pads every probe batch up to the kernel
ladder (its `pad_for_kernel`, a power of four from 4096) before it
sizes that capacity; the port sizes it from the same ladder
(`operator_capacity`), so a join overflows, and the query re-runs, in
the one exactly when it does in the other. Q13's LEFT join of 8,192
customers to their orders needs about 84,000 slots: 8 x 16,384 in
both packages, where the port once took 8 x 8,192 and re-ran. Q16 re-runs
once in both (its grouping overflows), Q21 in neither.
"""

import pytest
import torch

from test_tpch_suite import assert_rows_equal
from tpch_queries import QUERIES

# one intra-op thread: see tests/test_torch_tpch.py
torch.set_num_threads(1)


def _retries(runner, sql):
    """Rows of `sql` and the re-runs `runner._run_plan` made for it."""
    count = [0]
    run_plan = runner._run_plan

    def counting(plan, *args, **kw):
        outer = kw.get("on_retry")

        def on_retry():
            count[0] += 1
            if outer is not None:
                outer()
        kw["on_retry"] = on_retry
        return run_plan(plan, *args, **kw)
    runner._run_plan = counting
    try:
        return runner.execute(sql).rows(), count[0]
    finally:
        del runner._run_plan


def _compare(q, schema, props, expected):
    from presto_tpu.runner import LocalRunner as JaxRunner
    from presto_tpu_torch.runner import LocalRunner
    want, ref = _retries(JaxRunner("tpch", schema, properties=props),
                         QUERIES[q])
    got, port = _retries(LocalRunner("tpch", schema, properties=props,
                                     device="cpu"), QUERIES[q])
    assert port == ref, f"Q{q}: the port re-ran {port} times, the " \
                        f"reference {ref}"
    assert ref == expected
    assert_rows_equal(got, want, f"q{q}", "order by" in QUERIES[q].lower())


@pytest.mark.parametrize("q", [13, 16, 21])
def test_port_reruns_as_often_as_the_reference(q):
    _compare(q, "sf0_1", None, {13: 0, 16: 1, 21: 0}[q])


@pytest.mark.slow
@pytest.mark.parametrize("q", [13, 16, 21])
def test_port_reruns_as_often_as_the_reference_at_sf1(q):
    """SF1 at chip_smoke.py's batch size (about 90 s for the three on
    the CPU): the re-runs the card's runs show as a query's `plans`."""
    _compare(q, "sf1", {"batch_rows": 1 << 20}, {13: 0, 16: 3, 21: 1}[q])


def test_sorted_approx_aggregation_streams_as_the_reference():
    """approx_percentile / approx_distinct grouped by lineitem's sort key
    stream in both packages (O(batch) memory, no group table to
    overflow): the same re-runs (none) and rows, over several batches."""
    from presto_tpu.runner import LocalRunner as JaxRunner
    from presto_tpu_torch.ops import hashagg as th
    from presto_tpu_torch.runner import LocalRunner
    sql = ("select orderkey, approx_percentile(extendedprice, 0.75), "
           "approx_distinct(suppkey), checksum(partkey), count(*) "
           "from lineitem group by orderkey")
    props = {"batch_rows": 8192}
    steps = [0]
    real = th.stream_step

    def counting(*a, **kw):
        steps[0] += 1
        return real(*a, **kw)
    th.stream_step = counting
    try:
        got, port = _retries(LocalRunner("tpch", "sf0_01", properties=props,
                                         device="cpu"), sql)
    finally:
        th.stream_step = real
    want, ref = _retries(JaxRunner("tpch", "sf0_01", properties=props), sql)
    assert steps[0] > 1
    assert port == ref == 0
    assert sorted(got) == sorted(want)
