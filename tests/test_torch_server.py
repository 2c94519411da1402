"""A port cluster: two worker PROCESSES (`--device cpu`, refusing to
import JAX or the JAX package) and a port Coordinator on the CPU, over
the HTTP task RPC and page pushes (the non-slow cases of
tests/test_distributed.py, plus the port's own: device defaults, the
endpoints of later slices, query deadlines, single-node serving).
Rows equal both the port's and the reference's LocalRunner: DOUBLE at
rel_tol=1e-6 (tests/test_tpch_suite.py assert_rows_equal), the rest
exact."""

import json
import pathlib
import subprocess
import sys
import time
import urllib.error

import pytest
import torch

from presto_tpu_torch.server.node import spawn_workers, stop_workers
from test_tpch_suite import assert_rows_equal

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: a worker whose process refuses to import JAX or the JAX package: a
#: query that would need either fails
GUARDED_WORKER = (
    "import sys\n"
    "class _Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('jax', 'jaxlib', 'presto_tpu'):\n"
    "            raise ImportError('the port imported ' + name)\n"
    "sys.meta_path.insert(0, _Block())\n"
    "from presto_tpu_torch.server.node import worker_main\n"
    "worker_main(sys.argv[1:])\n")

JOIN_SQL = ("select n.name, count(*) c from customer c "
            "join nation n on c.nationkey = n.nationkey "
            "group by n.name order by c desc, n.name limit 5")


@pytest.fixture(scope="module")
def cluster():
    from presto_tpu_torch.server.coordinator import Coordinator
    procs, urls = spawn_workers(
        2, ["--device", "cpu"], timeout_s=120,
        launcher=[sys.executable, "-c", GUARDED_WORKER])
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
def port_rows():
    from presto_tpu_torch.runner import LocalRunner
    r = LocalRunner("tpch", "tiny", device="cpu")
    return lambda sql: r.execute(sql).rows()


@pytest.fixture(scope="module")
def ref_rows():
    from presto_tpu.runner import LocalRunner
    r = LocalRunner("tpch", "tiny")
    return lambda sql: r.execute(sql).rows()


@pytest.mark.parametrize("sql", [
    JOIN_SQL,
    "select o.orderpriority, count(*) c, sum(l.quantity) q "
    "from orders o join lineitem l on l.orderkey = o.orderkey "
    "group by o.orderpriority order by o.orderpriority",
    "select returnflag, linestatus, sum(extendedprice * (1 - discount)) "
    "s, avg(quantity) a from lineitem group by returnflag, linestatus "
    "order by returnflag, linestatus",
], ids=["broadcast_join", "repartitioned_join", "agg_double"])
def test_rows_through_cluster(cluster, port_rows, ref_rows, sql):
    got = cluster.execute(sql).rows()
    assert_rows_equal(got, port_rows(sql), "port", True)
    assert_rows_equal(got, ref_rows(sql), "reference", True)


def test_client_protocol(cluster):
    from presto_tpu_torch.server.coordinator import StatementClient
    columns, data = StatementClient(cluster.url).execute(
        "select returnflag, count(*) c from lineitem "
        "group by returnflag order by returnflag")
    assert [c["name"] for c in columns] == ["returnflag", "c"]
    assert [c["type"] for c in columns] == ["varchar", "bigint"]
    assert [row[0] for row in data] == ["A", "N", "R"]


def test_client_protocol_failure(cluster):
    from presto_tpu_torch.server.coordinator import (
        QueryFailed, StatementClient,
    )
    with pytest.raises(QueryFailed, match="does not exist"):
        StatementClient(cluster.url).execute("select * from no_such_table")


def test_cli_against_cluster(cluster):
    out = subprocess.run(
        [sys.executable, "-m", "presto_tpu_torch.cli", "--server",
         cluster.url, "-e", "select count(*) n from orders"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "1500" in out.stdout


def test_query_resources_released(cluster):
    """The query's exchange state is dropped from the coordinator and
    every worker task reached a terminal state; the workers' status
    carries the task stats."""
    from presto_tpu_torch.server.node import http_get
    result = cluster.execute("select returnflag, count(*) from lineitem "
                             "group by returnflag")
    assert not cluster.registry._queues and not cluster.registry._eos \
        and not cluster.registry._expected
    seen = 0
    for wurl in cluster.worker_urls:
        for tid, t in json.loads(http_get(f"{wurl}/v1/tasks")).items():
            assert t["state"] != "running", (tid, t)
            seen += 1
    assert seen > 0
    tasks = result.query_stats["tasks"]
    assert tasks and all("wall_s" in t and "kernels" in t for t in tasks)


def test_zero_workers_rejected():
    from presto_tpu_torch.server.coordinator import Coordinator
    coord = Coordinator([], "tpch", "tiny", device="cpu")
    try:
        with pytest.raises(RuntimeError, match="no workers"):
            coord.execute("select count(*) from orders")
    finally:
        coord.httpd.server_close()


def test_result_paging_and_early_columns(cluster):
    """Results page at PAGE_ROWS per nextUri token and the columns
    arrive before the last page."""
    from presto_tpu_torch.server.coordinator import StatementClient
    from presto_tpu_torch.server.node import http_get, http_post
    resp = json.loads(http_post(f"{cluster.url}/v1/statement",
                                b"select orderkey from lineitem"))
    pages = got_rows = 0
    next_uri = resp["nextUri"]
    saw_columns_with_next = False
    while next_uri is not None:
        st = json.loads(http_get(next_uri))
        if st["stats"]["state"] == "FAILED":
            raise AssertionError(st["error"])
        if st["stats"]["state"] == "FINISHED":
            got_rows += len(st.get("data", []))
            pages += 1 if st.get("data") else 0
            if "columns" in st and st.get("nextUri"):
                saw_columns_with_next = True
        next_uri = st.get("nextUri")
    assert got_rows == 5990 and pages >= 2 and saw_columns_with_next
    cols, data = StatementClient(cluster.url).execute(
        "select orderkey from lineitem")
    assert len(data) == 5990 and cols[0]["name"] == "orderkey"


def test_admission_queue(cluster):
    """Queries past the concurrency cap queue; the queue cap rejects."""
    from presto_tpu_torch.server.coordinator import Coordinator
    from presto_tpu_torch.server.node import http_get, http_post
    c = Coordinator(cluster.worker_urls, "tpch", "tiny",
                    max_concurrent_queries=1, max_queued_queries=2,
                    device="cpu")
    c.start()
    try:
        resps = [json.loads(http_post(f"{c.url}/v1/statement",
                                      b"select count(*) from lineitem"))
                 for _ in range(3)]
        r4 = json.loads(http_post(f"{c.url}/v1/statement", b"select 1"))
        st4 = json.loads(http_get(r4["nextUri"]))
        deadline = time.time() + 300
        while time.time() < deadline:
            sts = [json.loads(http_get(r["nextUri"])) for r in resps]
            if all(s["stats"]["state"] == "FINISHED" for s in sts):
                break
            time.sleep(0.1)
        assert all(s["stats"]["state"] == "FINISHED" for s in sts)
        assert st4["stats"]["state"] == "FAILED"
        assert "queue" in st4["error"]["message"]
        assert st4["error"]["errorKind"] == "queue_full"
    finally:
        c.stop()


def test_later_slices_answer_501_or_fail_by_name(cluster):
    from presto_tpu_torch.server.node import http_get, http_post
    for call in (lambda: http_get(f"{cluster.url}/v1/metrics"),
                 lambda: http_post(f"{cluster.worker_urls[0]}/v1/prewarm",
                                   b"{}")):
        with pytest.raises(urllib.error.HTTPError) as ei:
            call()
        assert ei.value.code == 501
        assert b"ROADMAP" in ei.value.read()
    from presto_tpu_torch.server.coordinator import Coordinator
    c = Coordinator(cluster.worker_urls, "tpch", "tiny",
                    {"task_retries": 1}, device="cpu")
    try:
        with pytest.raises(NotImplementedError, match="A13's rest"):
            c.execute("select count(*) from orders")
    finally:
        c.httpd.server_close()


def test_deadline_and_kill(cluster):
    """query_max_run_time_ms fails a query as deadline_exceeded; a
    client DELETE kills a running one as cancelled."""
    from presto_tpu_torch.server.coordinator import (
        Coordinator, QueryCancelled, QueryTimedOut, StatementClient,
    )
    c = Coordinator(cluster.worker_urls, "tpch", "tiny",
                    {"query_max_run_time_ms": 1}, device="cpu")
    c.start()
    try:
        with pytest.raises(QueryTimedOut) as ei:
            StatementClient(c.url).execute("select count(*) from lineitem")
        assert ei.value.kind == "deadline_exceeded"
    finally:
        c.stop()
    client = StatementClient(cluster.url)
    import threading
    err = []

    def run():
        try:
            client.execute("select count(*) from lineitem l1, lineitem l2 "
                           "where l1.orderkey = l2.orderkey")
        except Exception as e:  # noqa: BLE001
            err.append(e)
    t = threading.Thread(target=run)
    t.start()
    deadline = time.time() + 30
    while not client._inflight and time.time() < deadline:
        time.sleep(0.01)
    assert client.cancel()
    t.join(timeout=120)
    assert err and isinstance(err[0], QueryCancelled), err


def test_single_node_serving():
    from presto_tpu_torch.server.coordinator import (
        Coordinator, QueryFailed, StatementClient,
    )
    c = Coordinator([], "tpch", "tiny", single_node=True, device="cpu")
    c.start()
    try:
        cols, data = StatementClient(c.url).execute(
            "select count(*) c from nation")
        assert data == [[25]] and cols[0]["name"] == "c"
        with pytest.raises(QueryFailed, match="SET SESSION"):
            StatementClient(c.url).execute("set session max_groups = 10")
    finally:
        c.stop()


def test_runs_on_cuda_unless_told(monkeypatch):
    """Without a card, the node and the coordinator raise unless asked
    for the CPU, and a worker process exits without printing a url."""
    from presto_tpu_torch.server.coordinator import Coordinator
    from presto_tpu_torch.server.node import Node
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Node()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Coordinator([])
    out = subprocess.run(
        [sys.executable, "-m", "presto_tpu_torch.server.node", "--port",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr


@pytest.mark.slow
def test_q1_through_cluster(cluster, port_rows, ref_rows):
    from tpch_queries import QUERIES
    got = cluster.execute(QUERIES[1]).rows()
    assert_rows_equal(got, port_rows(QUERIES[1]), 1, True)
    assert_rows_equal(got, ref_rows(QUERIES[1]), 1, True)


@pytest.mark.slow
def test_query_retries_on_dead_worker(port_rows):
    """A worker dying fails the attempt; the coordinator probes the
    membership again and re-runs the query on the survivor."""
    from presto_tpu_torch.server.coordinator import Coordinator
    procs, urls = spawn_workers(2, ["--device", "cpu"], timeout_s=120)
    try:
        coord = Coordinator(urls, "tpch", "tiny", device="cpu")
        coord.start()
        try:
            coord.check_workers()
            procs[1].kill()
            procs[1].wait(timeout=10)
            sql = ("select returnflag, count(*) c from lineitem "
                   "group by returnflag order by returnflag")
            assert coord.execute(sql).rows() == port_rows(sql)
        finally:
            coord.stop()
    finally:
        stop_workers(procs)
