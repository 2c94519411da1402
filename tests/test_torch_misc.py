"""The port's cross join, EnforceSingleRow, AssignUniqueId and spool
against the JAX package's.

The cross product runs on the CPU as K10's plain version; the CUDA
kernel is held against it in tests/test_torch_cuda.py. Rows, ids and
masks are integers or copied values, so every comparison is exact;
query results use assert_rows_equal's rule (DOUBLE rel_tol 1e-6,
everything else exact).
"""

import numpy as np
import pytest
import torch

from test_tpch_suite import assert_rows_equal
from test_tpch_suite import oracle, runner  # noqa: F401 (fixtures)
from test_torch_join import _both, _live_rows, _np

from presto_tpu.operators import misc_ops as jm

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.operators import misc_ops as tm
from presto_tpu_torch.operators.base import DriverContext, OperatorContext
from presto_tpu_torch.planner.local_planner import _trace_scan_column
from presto_tpu_torch.telemetry import kernels as tk

# one intra-op thread: see tests/test_torch_tpch.py
torch.set_num_threads(1)

CPU = torch.device("cpu")

_RUNNERS = {}


def _runners():
    if not _RUNNERS:
        from presto_tpu.runner import LocalRunner as JaxRunner
        from presto_tpu_torch.runner import LocalRunner as TorchRunner
        _RUNNERS["r"] = (JaxRunner("tpch", "tiny"),
                         TorchRunner("tpch", "tiny", device="cpu"))
    return _RUNNERS["r"]


def _side(rng, n, live, prefix):
    """Columns of one compacted cross-join side: `live` rows first."""
    cols = {f"{prefix}a": (rng.integers(-1 << 40, 1 << 40, n),
                           rng.random(n) < 0.9, "bigint"),
            f"{prefix}b": (rng.normal(0, 1, n), rng.random(n) < 0.8,
                           "double"),
            f"{prefix}c": (rng.integers(-5, 5, n).astype(np.int32),
                           np.ones(n, bool), "integer")}
    rv = np.zeros(n, bool)
    rv[:live] = True
    return cols, rv


@pytest.mark.parametrize("np_rows,probe_live,nb_rows,build_live,out_cap", [
    (1024, 700, 64, 40, 32768), (4096, 3000, 16, 1, 4096),
    (512, 300, 16, 0, 16), (512, 0, 16, 5, 16), (256, 100, 16, 7, 2048)],
    ids=["many_by_many", "nb_1", "empty_build", "empty_probe",
         "out_cap_larger"])
def test_cross_product_matches_reference(np_rows, probe_live, nb_rows,
                                         build_live, out_cap):
    """Every output slot, dead ones included, against the reference's
    `_cross_product` (pid = s // nb, bid = s % nb, clipped)."""
    rng = np.random.default_rng(np_rows + nb_rows + build_live)
    pcols, prv = _side(rng, np_rows, probe_live, "p_")
    bcols, brv = _side(rng, nb_rows, build_live, "b_")
    jprobe, tprobe = _both(pcols, prv)
    jbuild, tbuild = _both(bcols, brv)
    want = jm._cross_product(jprobe, jbuild, out_cap)
    before = tk.CALLS["nested_loop"]
    got = tm.cross_product(tprobe, tbuild, probe_live, build_live, out_cap)
    assert tk.CALLS["nested_loop"] == before + 1
    np.testing.assert_array_equal(got.row_valid.numpy(),
                                  _np(want.row_valid))
    assert got.names == list(want.columns)
    for n in got.names:
        g, w = got.columns[n], want.columns[n]
        np.testing.assert_array_equal(g.mask.numpy(), _np(w.mask))
        np.testing.assert_array_equal(g.data.numpy(), _np(w.data))
    assert int(got.row_valid.sum()) == min(probe_live * build_live,
                                           out_cap)


def _ctx():
    return OperatorContext(1, "op", DriverContext(device=CPU))


@pytest.mark.parametrize("live", [0, 1, 2])
def test_enforce_single_row_matches_reference(live):
    """The operator over two batches holding `live` rows in all: one row
    passes, no row becomes one all-NULL row, two rows raise the
    reference's error."""
    from presto_tpu.operators.base import DriverContext as JDctx
    from presto_tpu.operators.base import OperatorContext as JOctx
    rng = np.random.default_rng(11 + live)
    jop = jm.EnforceSingleRowOperator(JOctx(1, "op", JDctx()))
    top = tm.EnforceSingleRowOperator(_ctx())
    for part in (live // 2, live - live // 2):
        cols, rv = _side(rng, 16, part, "e_")
        jb, tb = _both(cols, rv)
        jop.add_input(jb)
        top.add_input(tb)
    jop.finish()
    top.finish()
    if live > 1:
        with pytest.raises(RuntimeError, match="multiple rows") as jerr:
            jop.get_output()
        with pytest.raises(RuntimeError) as terr:
            top.get_output()
        assert str(terr.value) == str(jerr.value)
        return
    names = ["e_a", "e_b", "e_c"]
    got = _live_rows(top.get_output(), names)
    assert got == _live_rows(jop.get_output(), names)
    assert len(got) == 1 and (got[0] == (None,) * 3) == (live == 0)
    assert top.is_finished()


def test_scalar_subquery_matches_reference():
    """A scalar subquery of one row through both packages, and one of
    two rows raising the reference's error in both."""
    ref, port = _runners()
    sql = ("select name from nation where nationkey < 4 and regionkey "
           "<> (select regionkey from region where regionkey = {})")
    assert_rows_equal(port.execute(sql.format(1)).rows(),
                      ref.execute(sql.format(1)).rows(), "one_row", False)
    two = sql.replace("= {}", "< 2")
    with pytest.raises(Exception, match="multiple rows"):
        ref.execute(two)
    with pytest.raises(RuntimeError, match="Scalar sub-query has "
                       "returned multiple rows"):
        port.execute(two)


def test_scalar_subquery_of_no_batch_is_null(oracle):  # noqa: F811
    """A scalar subquery whose scan the constraint prunes to no batch at
    all is NULL, as in sqlite. The reference's operator indexes its
    first batch there and fails (ROADMAP C); the port's carries
    the node's schema for its NULL row."""
    _, port = _runners()
    sql = ("select name from nation where nationkey < 4 and coalesce("
           "(select regionkey from region where regionkey > 9), 7) = 7")
    got = port.execute(sql).rows()
    assert_rows_equal(got, [tuple(r) for r in oracle.execute(sql)],
                      "no_batch", False)
    assert len(got) == 4


def test_assign_unique_id_matches_reference():
    """Ids run on across batches of different capacities, padding rows
    included, and equal the reference operator's."""
    from presto_tpu.operators.base import DriverContext as JDctx
    from presto_tpu.operators.base import OperatorContext as JOctx
    rng = np.random.default_rng(3)
    jop = jm.AssignUniqueIdOperator(JOctx(1, "op", JDctx()), "uid")
    top = tm.AssignUniqueIdOperator(_ctx(), "uid")
    for n in (16, 64, 32):
        cols, rv = _side(rng, n, n // 2, "x_")
        jb, tb = _both(cols, rv)
        jop.add_input(jb)
        top.add_input(tb)
        jout, tout = jop.get_output(), top.get_output()
        np.testing.assert_array_equal(tout.columns["uid"].data.numpy(),
                                      _np(jout.columns["uid"].data))
        assert bool(tout.columns["uid"].mask.all())
        assert _live_rows(tout, ["x_a", "uid"]) \
            == _live_rows(jout, ["x_a", "uid"])
    assert top.get_output() is None
    top.finish()
    assert top.is_finished()


def test_spool_replays_to_two_consumers():
    """One filling, two replays: each consumer reads every batch in
    order, and a batch is released only after both have passed it."""
    spool = tm.Spool()
    sink = tm.spool_sink_factory(1, spool).create(DriverContext())
    sources = [tm.spool_source_factory(2 + i, spool)
               .create(DriverContext()) for i in range(2)]
    rng = np.random.default_rng(5)
    batches = [_both(*_side(rng, 16, 9, "s_"))[1] for _ in range(3)]
    for b in batches:
        sink.add_input(b)
    assert not sources[0].is_finished()
    sink.finish()
    seen = [[], []]
    for i, src in enumerate(sources):
        while not src.is_finished():
            b = src.get_output()
            assert b is batches[len(seen[i])]
            seen[i].append(b)
            # the first consumer's progress releases nothing
            assert spool.batches[0] is (batches[0] if i == 0 else None)
    assert [len(s) for s in seen] == [3, 3]
    assert spool.batches == [None, None, None]


_SHARED_SQL = (
    "with j as (select o.orderkey k, o.totalprice p"
    "  from orders o join customer c on o.custkey = c.custkey) "
    "select 0 tag, count(*) c from j where k < 100 "
    "union all "
    "select 1, count(*) from j")


def test_shared_subtree_query_matches_reference():
    """tests/test_optimizer_dag.py's shared-subtree query through both
    packages: the WITH subquery feeds two consumers through one spool,
    and the filtered consumer does not starve the other."""
    from presto_tpu_torch.parser import parse_statement
    from presto_tpu_torch.planner.local_planner import LocalExecutionPlanner
    ref, port = _runners()
    got = sorted(port.execute(_SHARED_SQL).rows())
    assert got == sorted(ref.execute(_SHARED_SQL).rows())
    assert 0 < got[0][1] < got[1][1]


def test_q21_plans_the_reference_spools():
    """TPC-H Q21's decorrelated EXISTS / NOT EXISTS share two subtrees:
    each is planned once into a spool that two consumers replay, in
    both packages."""
    from presto_tpu.planner.local_planner import (
        LocalExecutionPlanner as JPlanner,
    )
    from presto_tpu.runner import LocalRunner as JaxRunner
    from presto_tpu_torch.parser import parse_statement
    from presto_tpu_torch.planner.local_planner import LocalExecutionPlanner
    from tpch_queries import QUERIES
    _, port = _runners()
    # no fragment result cache: a replayed fragment hides its plan
    ref = JaxRunner("tpch", "tiny", properties={
        "fragment_result_cache_enabled": False})
    jplan = JPlanner(ref.catalogs, ref.session).plan(
        ref._plan_query(None, QUERIES[21]))
    tplan = LocalExecutionPlanner(port.catalogs, port.session, CPU).plan(
        port._plan_query(parse_statement(QUERIES[21])))

    def spools(plan):
        return [f.name for pipe in plan.pipelines for f in pipe
                if f.name.startswith("spool")]
    assert spools(tplan) == spools(jplan)
    assert spools(tplan).count("spool_sink") == 2
    assert spools(tplan).count("spool_source") == 4


def test_no_dynamic_filter_lands_in_a_shared_subtree():
    """`_trace_scan_column` stops at a shared node, as the reference's
    does: a join's dynamic filter must not narrow a scan that another
    consumer of a spooled subtree reads."""
    from presto_tpu_torch.parser import parse_statement
    _, port = _runners()
    plan = port._plan_query(parse_statement(
        "select count(*) from orders o where o.orderkey < 10"))
    scan = plan
    while scan.sources():
        scan = scan.sources()[0]
    sym = next(iter(scan.assignments))
    assert _trace_scan_column(scan, sym) == (scan, sym)
    assert _trace_scan_column(scan, sym, {id(scan)}) is None


def test_cross_join_guard_matches_reference():
    """A cross product past 2^24 output slots raises the reference's
    message before anything is materialized."""
    ref, port = _runners()
    sql = "select count(*) from lineitem a, lineitem b"
    with pytest.raises(Exception) as jerr:
        ref.execute(sql)
    with pytest.raises(RuntimeError) as terr:
        port.execute(sql)
    assert str(terr.value) == str(jerr.value)
    assert "add a join condition" in str(terr.value)


def test_nested_loop_build_of_no_batch_is_empty():
    """An empty build pipeline leaves an all-dead build of its schema,
    and the product of anything with it has no live row."""
    from presto_tpu_torch.types import BIGINT
    bridge = tm.NestedLoopBridge()
    op = tm.nested_loop_build_factory(1, bridge, [("b", BIGINT, None)]) \
        .create(DriverContext(device=CPU))
    op.finish()
    assert bridge.ready and bridge.batch.num_valid() == 0
    join = tm.nested_loop_join_factory(2, bridge).create(
        DriverContext(device=CPU))
    rng = np.random.default_rng(7)
    join.add_input(_both(*_side(rng, 32, 20, "p_"))[1])
    out = join.get_output()
    assert isinstance(out, Batch) and out.num_valid() == 0
    assert "b" in out.names
