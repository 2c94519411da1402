"""Mesh per worker: two port worker PROCESSES started with `--devices 4
--device cpu` and a port Coordinator (the cases of
tests/test_mesh_per_worker.py). Each worker announces 4 devices; the
coordinator expands every fragment task into 4 subtasks per worker (8
global tasks) and routes rows by h % 8. Rows equal the port's and the
reference's LocalRunner: DOUBLE at rel_tol=1e-6, the rest exact."""

import pytest

from presto_tpu_torch.server.node import spawn_workers, stop_workers
from test_tpch_suite import assert_rows_equal


@pytest.fixture(scope="module")
def mesh_cluster():
    from presto_tpu_torch.server.coordinator import Coordinator
    procs, urls = spawn_workers(2, ["--devices", "4", "--device", "cpu"],
                                timeout_s=120)
    try:
        coord = Coordinator(urls, "tpch", "tiny",
                            {"broadcast_join_threshold_rows": 500},
                            device="cpu")
        coord.start()
        try:
            coord.check_workers(require_all=True)
            yield coord
        finally:
            coord.stop()
    finally:
        stop_workers(procs)


@pytest.fixture(scope="module")
def rows_of():
    from presto_tpu.runner import LocalRunner as RefRunner
    from presto_tpu_torch.runner import LocalRunner
    port = LocalRunner("tpch", "tiny", device="cpu")
    ref = RefRunner("tpch", "tiny")
    return lambda sql: (port.execute(sql).rows(), ref.execute(sql).rows())


def _check(cluster, rows_of, sql, ordered=True):
    got = cluster.execute(sql).rows()
    want_port, want_ref = rows_of(sql)
    assert_rows_equal(got, want_port, "port", ordered)
    assert_rows_equal(got, want_ref, "reference", ordered)


def test_workers_announce_devices(mesh_cluster):
    assert mesh_cluster._worker_devices(mesh_cluster.worker_urls) == [4, 4]


def test_repartitioned_join_across_worker_devices(mesh_cluster, rows_of):
    # the repartition path (no broadcast): equal keys meet on the same
    # (worker, device) of the 8 global tasks
    _check(mesh_cluster, rows_of,
           "select o.orderpriority, count(*) c, sum(l.quantity) q "
           "from orders o join lineitem l on l.orderkey = o.orderkey "
           "group by o.orderpriority order by o.orderpriority")


@pytest.mark.slow
def test_q1_partial_final_over_8_global_tasks(mesh_cluster, rows_of):
    from tpch_queries import QUERIES
    _check(mesh_cluster, rows_of, QUERIES[1])


@pytest.mark.slow
def test_broadcast_join_and_topn(mesh_cluster, rows_of):
    _check(mesh_cluster, rows_of,
           "select n.name, count(*) c from customer c "
           "join nation n on c.nationkey = n.nationkey "
           "group by n.name order by c desc, n.name limit 5")


@pytest.mark.slow
def test_semi_join_and_order_by(mesh_cluster, rows_of):
    _check(mesh_cluster, rows_of,
           "select custkey, acctbal from customer "
           "where custkey in (select custkey from orders "
           "                  where totalprice > 250000) "
           "order by acctbal desc, custkey limit 10")
