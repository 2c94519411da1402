"""Coordinator: dispatch, scheduling and the client protocol
(reference: presto_tpu/server/coordinator.py; DispatchManager.java:143,
SqlQueryScheduler.java:114, QueuedStatementResource.java:156 /
ExecutingStatementResource.java:73 and presto-client's
StatementClientV1 in Presto).

The coordinator plans and fragments a query, POSTs one task per worker
per distributed fragment (the task spec is the SQL, the session and the
fragment id: the worker re-derives the deterministic plan), runs the
single-partition fragments itself (the root's output lands here) and
serves the two-phase queued/executing client protocol. Admission goes
through the resource groups (execution/resource_groups.py); a
heartbeat monitor keeps the live membership (server/scheduler.py).

A query whose worker died re-runs on the survivors (`query_retries`);
an overflow (join capacity, group limit) anywhere re-runs the whole
query with the suggested setting. `query_max_run_time_ms` and
`admission_queue_timeout_ms` bound a query's life and its queue wait.

The coordinator runs its fragments on CUDA unless `device="cpu"`, and
refuses to start without a card otherwise. Out of this slice, each with
a named error: `task_retries` > 0 (the fault-tolerant StageScheduler and
TaskOutputSpool, ROADMAP "A13's rest"), `access_control` and
`fleet_memory_bytes` (A10), history (A11), tracing, EXPLAIN ANALYZE
across the cluster, `/ui` and the sentinel (A14).
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Dict, List, Optional

from presto_tpu_torch.server.node import (
    TRANSPORT_RETRIES, Node, NotInThisSlice, _retry_transient,
    build_http_exchanges, derive_fragments, http_delete, http_get,
    http_post,
)
from presto_tpu_torch.server.scheduler import HeartbeatMonitor
from presto_tpu_torch.session_properties import get_property


class TaskFailed(RuntimeError):
    """A remote task failed. Carries the structured retry hint when the
    failure is an overflow, and the worker url when the failure
    implicates the WORKER (unreachable) rather than the query."""

    def __init__(self, message: str, kind: Optional[str] = None,
                 suggested: Optional[int] = None,
                 worker: Optional[str] = None):
        super().__init__(message)
        self.kind = kind
        self.suggested = suggested
        self.worker = worker


class QueryFailed(RuntimeError):
    """Client-side structured failure: `kind` is the failure taxonomy
    ("cancelled", "deadline_exceeded", "abandoned", "client_timeout",
    "queue_full", "rejected", or None)."""

    def __init__(self, message: str, kind: Optional[str] = None,
                 query_id: Optional[str] = None):
        super().__init__(message)
        self.kind = kind
        self.query_id = query_id


class QueryCancelled(QueryFailed):
    """The query was killed (client DELETE or abandonment)."""


class QueryTimedOut(QueryFailed):
    """Client-side poll timeout (the client issues the kill first) or
    the server-side deadline."""


class QueryLifecycle:
    """Per-query control surface from the client protocol down to every
    drive loop: the cooperative cancel event, the monotonic deadline,
    the live attempt's remote tasks (a kill DELETEs them at once) and
    the attempt counter."""

    def __init__(self, cancel: Optional[threading.Event] = None,
                 deadline: Optional[float] = None):
        self.cancel = cancel if cancel is not None else threading.Event()
        self.deadline = deadline
        #: (task_id, worker_url) of the current attempt
        self.remote: List[tuple] = []
        self.attempts = 0
        #: why the cancel event was set ("cancelled" or "abandoned")
        self.kill_kind: Optional[str] = None

    def abort_remote(self) -> None:
        """Best-effort DELETE of the live attempt's worker tasks."""
        for task_id, wurl in list(self.remote):
            try:
                http_delete(f"{wurl}/v1/task/{task_id}", timeout=5)
            except Exception:  # noqa: BLE001 — best-effort abort
                pass


def _retry_hint(e: Exception):
    """(property, suggested) when the error asks for a re-run with a
    raised setting; (None, None) otherwise."""
    from presto_tpu_torch.operators.aggregation import GroupLimitExceeded
    from presto_tpu_torch.operators.join_ops import JoinCapacityExceeded
    if isinstance(e, JoinCapacityExceeded) or (
            isinstance(e, TaskFailed) and e.kind == "join_capacity"):
        return "join_expansion_factor", e.suggested
    if isinstance(e, GroupLimitExceeded) or (
            isinstance(e, TaskFailed) and e.kind == "group_limit"):
        return "max_groups", e.suggested
    return None, None


class _Query:
    def __init__(self, sql: str):
        self.id = uuid.uuid4().hex[:16]
        self.sql = sql
        self.state = "QUEUED"
        self.error: Optional[str] = None
        self.error_kind: Optional[str] = None
        self.columns: Optional[List[dict]] = None
        self.data: Optional[List[list]] = None
        self.done_at: Optional[float] = None  # set at terminal state
        self.user = ""
        self.source = ""
        self.group = "root"
        self.dispatch = None  # the resource group's dispatch callback
        self.last_poll = time.monotonic()
        self.created_at = time.monotonic()
        self.run_started_at: Optional[float] = None  # leaves QUEUED
        #: queue-wait deadline and the kind an expiry sheds with
        self.queue_deadline: Optional[float] = None
        self.queue_shed_kind: Optional[str] = None
        self.lifecycle = QueryLifecycle()
        #: {"wall_ms", "queued_ms", "tasks"}: served by /v1/query/<id>
        self.stats: Optional[dict] = None


#: result rows per client page
PAGE_ROWS = 4096


def _columns_of(names, fields) -> List[dict]:
    return [{"name": n, "type": f.type.display()}
            for n, f in zip(names, fields)]


class Coordinator(Node):
    """Admission runs through hierarchical resource groups: the client's
    X-Presto-User / X-Presto-Source headers route each query to a leaf
    group through the selectors. Without a `resource_groups` argument
    there is one root group sized by max_concurrent_queries /
    max_queued_queries. `single_node` serves every query from one
    embedded LocalRunner instead of workers."""

    def __init__(self, worker_urls: List[str], catalog: str = "tpch",
                 schema: str = "tiny", properties: Optional[dict] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 max_concurrent_queries: int = 4,
                 max_queued_queries: int = 100, resource_groups=None,
                 selectors=None, access_control=None,
                 single_node: bool = False,
                 heartbeat_interval_s: float = 1.0, device=None):
        from presto_tpu_torch.execution.resource_groups import (
            GroupSpec, ResourceGroupManager,
        )
        if access_control is not None:
            raise NotInThisSlice("access control comes with a later slice "
                                 "of the port (ROADMAP A10)")
        self.properties = dict(properties or {})
        if get_property(self.properties, "fleet_memory_bytes"):
            raise NotInThisSlice("fleet_memory_bytes (the fleet memory "
                                 "gate) comes with a later slice of the "
                                 "port (ROADMAP A10)")
        super().__init__(host, port, n_devices=1, device=device)
        self.worker_urls = list(worker_urls)
        self.single_node = single_node
        self._embedded_runner = None
        self._embedded_lock = threading.Lock()
        self.catalog = catalog
        self.schema = schema
        self.queries: Dict[str, _Query] = {}
        if resource_groups is None:
            resource_groups = GroupSpec(
                "root", hard_concurrency=max_concurrent_queries,
                max_queued=max_queued_queries)
        self.resource_groups = ResourceGroupManager(resource_groups,
                                                    selectors)
        #: callables receiving {"event": "query_created" |
        #: "query_completed", ...}; a listener's error never fails a
        #: query
        self.event_listeners: List = []
        #: the periodic pruner: abandonment and queue deadlines fire on
        #: an otherwise idle coordinator too
        self._pruner_stop = threading.Event()
        self._pruner = threading.Thread(target=self._prune_loop,
                                        daemon=True,
                                        name="coordinator-pruner")
        #: live membership over the workers (None without workers)
        self.membership: Optional[HeartbeatMonitor] = None
        if self.worker_urls and not self.single_node:
            self.membership = HeartbeatMonitor(
                self.worker_urls, interval_s=heartbeat_interval_s)

    def start(self) -> None:
        super().start()
        self._pruner.start()
        if self.membership is not None:
            self.membership.start()

    def stop(self) -> None:
        self._pruner_stop.set()
        if self.membership is not None:
            self.membership.stop()
        super().stop()
        if self._pruner.is_alive():
            self._pruner.join(timeout=5)

    def _prune_loop(self, period_s: float = 15.0) -> None:
        while not self._pruner_stop.wait(period_s):
            try:
                self._prune_queries()
            except Exception:  # noqa: BLE001 — the sweep must outlive
                pass           # any one bad query entry

    def _fire_event(self, payload: dict) -> None:
        for listener in self.event_listeners:
            try:
                listener(payload)
            except Exception:  # noqa: BLE001 — observers cannot fail
                pass           # the query

    # -- health / membership -----------------------------------------------

    def check_workers(self, require_all: bool = False,
                      timeout: float = 5.0) -> Dict[str, str]:
        """Probe every worker concurrently and return {url: state}, dead
        ones as "unreachable: ...". Raises only when NO worker is active
        (or, with `require_all`, when any is not)."""
        from concurrent.futures import ThreadPoolExecutor

        def probe(url):
            try:
                info = json.loads(http_get(f"{url}/v1/info",
                                           timeout=timeout))
                return url, info.get("state", "unknown")
            except Exception as e:  # noqa: BLE001 — reported below
                return url, f"unreachable: {e}"
        if not self.worker_urls:
            return {}
        with ThreadPoolExecutor(max_workers=len(self.worker_urls)) as pool:
            report = dict(pool.map(probe, self.worker_urls))
        dead = {u: s for u, s in report.items() if s != "active"}
        if dead and require_all:
            raise RuntimeError(f"workers not active: {dead}")
        if len(dead) == len(report):
            raise RuntimeError(f"no active workers: {dead}")
        return report

    # -- client protocol -----------------------------------------------------

    def handle_post(self, path: str, body: bytes,
                    headers: Optional[dict] = None) -> bytes:
        if path == "/v1/statement":
            return self._submit(body.decode(), headers or {})
        if path.startswith("/v1/spool/"):
            raise NotInThisSlice("the task output spool comes with a "
                                 "later slice of the port (ROADMAP "
                                 "A13's rest)")
        return super().handle_post(path, body, headers)

    def _submit(self, sql: str, headers: dict) -> bytes:
        """Admission is decided at submit: the resource groups grant a
        slot, park the dispatch callback, or shed with a structured
        kind."""
        from presto_tpu_torch.execution.resource_groups import (
            QueryRejected,
        )
        self._prune_queries()
        h = {k.lower(): v for k, v in headers.items()}
        q = _Query(sql)
        q.user = h.get("x-presto-user", "")
        q.source = h.get("x-presto-source", "")
        dispatched = threading.Event()
        q.dispatch = dispatched.set
        self._stamp_queue_deadline(q)
        try:
            state, q.group = self.resource_groups.submit(
                q.user, q.source, self._query_memory(),
                on_dispatch=q.dispatch, deadline=q.queue_deadline,
                on_expire=lambda: self._expire_queued_query(q))
        except QueryRejected as e:
            q.state = "FAILED"
            q.error = str(e)
            q.error_kind = e.kind
            q.done_at = time.monotonic()
            state = None
        self.queries[q.id] = q
        if state is not None:
            self._fire_event({"event": "query_created", "id": q.id,
                              "user": q.user, "source": q.source,
                              "group": q.group, "sql": q.sql})
            threading.Thread(target=self._run_query,
                             args=(q, state == "run", dispatched),
                             daemon=True, name=f"query-{q.id}").start()
        return json.dumps({
            "id": q.id,
            "nextUri": f"{self.url}/v1/statement/executing/{q.id}/0",
        }).encode()

    def _stamp_queue_deadline(self, q: _Query) -> None:
        """The instant after which a QUEUED query is dead:
        query_max_run_time_ms (queue time counts; kind
        deadline_exceeded) and/or admission_queue_timeout_ms (load
        shedding; kind rejected), whichever is earlier."""
        q.queue_deadline = None
        q.queue_shed_kind = None
        limit_ms = get_property(self.properties, "query_max_run_time_ms")
        if limit_ms:
            q.queue_deadline = q.created_at + float(limit_ms) / 1000.0
            q.queue_shed_kind = "deadline_exceeded"
        qt_ms = get_property(self.properties, "admission_queue_timeout_ms")
        if qt_ms:
            qd = q.created_at + float(qt_ms) / 1000.0
            if q.queue_deadline is None or qd < q.queue_deadline:
                q.queue_deadline = qd
                q.queue_shed_kind = "rejected"

    def _expire_queued_query(self, q: _Query) -> bool:
        """A queued query's deadline passed before it was scheduled:
        fail it with the structured kind and release its waiting
        thread. Idempotent."""
        if q.done_at is not None or q.state != "QUEUED":
            return False
        kind = q.queue_shed_kind or "rejected"
        q.state = "FAILED"
        q.error = ("query exceeded query_max_run_time_ms while queued"
                   if kind == "deadline_exceeded" else
                   "query shed: queue wait exceeded "
                   "admission_queue_timeout_ms")
        q.error_kind = kind
        q.done_at = time.monotonic()
        q.lifecycle.kill_kind = kind
        q.lifecycle.cancel.set()
        if q.dispatch is not None:
            q.dispatch()  # unblock the waiting runner thread
        return True

    def _query_memory(self) -> int:
        """The declared per-query reservation charged against the
        resource groups' memory caps."""
        return int(get_property(self.properties, "query_memory_bytes")
                   or 0)

    def _query_rows(self) -> List[dict]:
        now = time.monotonic()
        out = []
        for q in list(self.queries.values()):
            elapsed = (q.done_at or now) - q.created_at
            out.append({
                "id": q.id, "state": q.state, "user": q.user,
                "source": q.source, "group": q.group,
                "elapsed_ms": round(elapsed * 1000, 1),
                "rows": len(q.data) if q.data is not None else 0,
                "error": q.error, "error_kind": q.error_kind,
                "sql": q.sql[:500],
            })
        return sorted(out, key=lambda r: -r["elapsed_ms"])

    def info(self) -> dict:
        info = super().info()
        if self.membership is not None:
            info["workers"] = self.membership.snapshot()
            info["membership"] = self.membership.counts()
        return info

    def handle_get(self, path: str) -> bytes:
        if path == "/v1/query":
            return json.dumps(self._query_rows()).encode()
        if path in ("/v1/sentinel",) or (path.startswith("/v1/query/")
                                         and path.endswith("/trace")):
            raise NotInThisSlice(f"{path} comes with a later slice of the "
                                 "port (ROADMAP A14)")
        if path.startswith("/v1/query/"):
            qid = path.rsplit("/", 1)[1]
            for row in self._query_rows():
                if row["id"] == qid:
                    q = self.queries[qid]
                    row["sql"] = q.sql
                    row["columns"] = q.columns
                    row["stats"] = q.stats
                    return json.dumps(row).encode()
            raise KeyError(qid)
        if path == "/v1/resourceGroups":
            return json.dumps(self.resource_groups.snapshot()).encode()
        if path.startswith("/v1/statement/executing/"):
            return self._executing(path)
        return super().handle_get(path)

    def _executing(self, path: str) -> bytes:
        """One poll of the executing protocol: the state, the columns as
        soon as planning knows them, and FINISHED results in pages of
        PAGE_ROWS rows (the last page has no nextUri)."""
        parts = path.split("/")
        qid = parts[4]
        token = int(parts[5]) if len(parts) > 5 else 0
        q = self.queries[qid]
        q.last_poll = time.monotonic()
        out = {"id": q.id, "stats": {"state": q.state}}
        if q.columns is not None:
            out["columns"] = q.columns
        if q.state == "FINISHED":
            lo = token * PAGE_ROWS
            hi = lo + PAGE_ROWS
            out["data"] = q.data[lo:hi]
            if hi < len(q.data):
                out["nextUri"] = (f"{self.url}/v1/statement/executing/"
                                  f"{qid}/{token + 1}")
        elif q.state == "FAILED":
            out["error"] = {"message": q.error, "errorKind": q.error_kind}
        else:
            out["nextUri"] = (f"{self.url}/v1/statement/executing/"
                              f"{qid}/{token}")
        return json.dumps(out).encode()

    # -- query execution -----------------------------------------------------

    def _prune_queries(self, ttl_s: float = 600.0,
                       queued_abandon_s: float = 60.0,
                       running_abandon_s: float = 300.0) -> None:
        """Evict terminal queries `ttl_s` after they ended; cancel QUEUED
        ones whose client stopped polling for `queued_abandon_s` and
        kill RUNNING ones silent for `running_abandon_s`."""
        now = time.monotonic()
        self.resource_groups.expire_queued()
        for q in list(self.queries.values()):
            if q.done_at is not None:
                continue
            if q.state == "QUEUED" and now - q.last_poll > queued_abandon_s:
                self._kill_query(q, "query abandoned while queued",
                                 kind="abandoned")
            elif q.state == "RUNNING" \
                    and now - q.last_poll > running_abandon_s:
                self._kill_query(q, "query abandoned while running",
                                 kind="abandoned")
        for qid in [qid for qid, q in list(self.queries.items())
                    if q.done_at is not None and now - q.done_at > ttl_s]:
            self.queries.pop(qid, None)

    def _kill_query(self, q: _Query, message: str,
                    kind: str = "cancelled") -> bool:
        """Stop a query in any non-terminal state (a no-op on a terminal
        one). QUEUED: it leaves its group's queue. RUNNING: the cancel
        event is set (every drive loop polls it) and the live attempt's
        remote tasks are DELETEd at once."""
        if q.done_at is not None:
            return False
        q.lifecycle.kill_kind = kind
        q.lifecycle.cancel.set()
        if q.state == "QUEUED" and q.dispatch is not None \
                and self.resource_groups.cancel_queued(q.group,
                                                       q.dispatch):
            q.state = "FAILED"
            q.error = message
            q.error_kind = kind
            q.done_at = time.monotonic()
            q.dispatch()  # unblock the waiting runner thread
            return True
        q.lifecycle.abort_remote()
        return True

    def handle_delete(self, path: str) -> bytes:
        if path.startswith("/v1/statement/"):
            # client kill: the submit URI or the executing nextUri form
            parts = [p for p in path.split("/") if p]
            qid = parts[3] if len(parts) > 3 and parts[2] == "executing" \
                else parts[2]
            q = self.queries[qid]
            self._kill_query(q, "query cancelled by client request",
                             kind="cancelled")
            return json.dumps({"id": q.id, "state": q.state}).encode()
        return super().handle_delete(path)

    def _run_query(self, q: _Query, has_slot: bool = True,
                   dispatched: Optional[threading.Event] = None) -> None:
        if not has_slot:
            # QUEUED until the group dispatches it; a queue deadline
            # expires here without the query ever being scheduled
            while not dispatched.wait(
                    0.25 if q.queue_deadline is not None else None):
                if time.monotonic() > q.queue_deadline:
                    self.resource_groups.expire_queued()
            if q.state == "FAILED":  # cancelled or expired while queued
                return
        q.state = "RUNNING"
        q.run_started_at = time.monotonic()
        try:
            # the deadline is anchored at SUBMIT: queue time counts
            limit_ms = get_property(self.properties,
                                    "query_max_run_time_ms")
            if limit_ms:
                q.lifecycle.deadline = q.created_at + float(limit_ms) / 1e3
            if q.lifecycle.cancel.is_set():
                raise QueryFailed("query cancelled before execution",
                                  kind="cancelled")
            result = self.execute(
                q.sql, on_columns=lambda cols: setattr(q, "columns", cols),
                user=q.user, lifecycle=q.lifecycle)
            q.columns = _columns_of(result.names, result.fields)
            q.data = [list(r) for r in result.rows()]
            q.stats = getattr(result, "query_stats", None)
            q.state = "FINISHED"
        except Exception as e:  # noqa: BLE001 — the client sees it
            q.error = f"{type(e).__name__}: {e}"
            # the killer knows why (abandoned vs cancelled); the drive
            # loop only knows it was told to stop
            q.error_kind = q.lifecycle.kill_kind or getattr(e, "kind",
                                                            None)
            q.state = "FAILED"
        finally:
            q.done_at = time.monotonic()
            q.stats = {**(q.stats or {}),
                       "wall_ms": round((q.done_at - q.created_at) * 1e3,
                                        3),
                       "queued_ms": round(((q.run_started_at or q.done_at)
                                           - q.created_at) * 1e3, 3)}
            self.resource_groups.finish(q.group, self._query_memory())
            self._fire_event({
                "event": "query_completed", "id": q.id, "state": q.state,
                "user": q.user, "group": q.group,
                "elapsed_ms": round((q.done_at - q.created_at) * 1e3, 1),
                "rows": len(q.data) if q.data is not None else 0,
                "error": q.error, "stats": q.stats})

    def execute(self, sql: str, on_columns=None, user: str = "",
                lifecycle: Optional[QueryLifecycle] = None):
        """Run one query with the elastic retry: a failed or dead worker
        fails the attempt, the membership is probed again, and the query
        re-runs on the survivors (splits regenerate identically
        anywhere), at most `query_retries` times. An overflow re-runs
        the query with the suggested setting (at most 8 bumps).
        `on_columns` fires once the output schema is known, before any
        row exists."""
        if lifecycle is None:
            lifecycle = QueryLifecycle()
        if self.single_node:
            lifecycle.attempts += 1
            result = self._runner().execute_as(
                sql, user, cancel=lifecycle.cancel.is_set,
                deadline=lifecycle.deadline)
            if on_columns is not None:
                on_columns(_columns_of(result.names, result.fields))
            return result
        retries = int(get_property(self.properties, "query_retries"))
        workers = list(self.worker_urls)
        props = dict(self.properties)
        #: workers implicated in a connection failure: never re-picked
        #: by a later attempt of this query
        blacklist: set = set()
        attempt = bumps = 0
        while True:
            try:
                return self._execute_attempt(sql, workers, props,
                                             on_columns, lifecycle)
            except Exception as e:  # noqa: BLE001 — inspect and retry
                # a killed or expired query must not burn the retry
                # budget re-running work nobody wants
                if getattr(e, "kind", None) in ("cancelled",
                                                "deadline_exceeded"):
                    raise
                prop, suggested = _retry_hint(e)
                if prop is not None and bumps < 8:
                    bumps += 1
                    props[prop] = max(suggested, props.get(prop, 0) or 0)
                    continue
                attempt += 1
                if attempt > retries:
                    raise
                bad = getattr(e, "worker", None)
                if bad:
                    blacklist.add(bad)
                    if self.membership is not None:
                        self.membership.report_failure(bad)
                alive = []
                for url in workers:
                    if url in blacklist:
                        continue
                    try:
                        st = json.loads(http_get(f"{url}/v1/info",
                                                 timeout=5))
                        if st.get("state") == "active":
                            alive.append(url)
                    except Exception:  # noqa: BLE001 — a dead worker
                        pass
                # nothing died and no worker was implicated: the
                # failure is the query's own, not masked by a retry
                if not alive or len(alive) == len(workers):
                    raise
                workers = alive

    def _runner(self):
        """The shared single-node runner (lazy)."""
        with self._embedded_lock:
            if self._embedded_runner is None:
                from presto_tpu_torch.runner.local import LocalRunner
                self._embedded_runner = LocalRunner(
                    self.catalog, self.schema, dict(self.properties),
                    device=self.device)
            return self._embedded_runner

    def _worker_devices(self, worker_urls: List[str]) -> List[int]:
        """Per-worker device counts (a mesh-per-worker node's tasks
        expand to one subtask per device)."""
        ks = []
        for url in worker_urls:
            try:
                info = json.loads(http_get(f"{url}/v1/info", timeout=10))
                ks.append(max(1, int(info.get("devices", 1))))
            except Exception:  # noqa: BLE001 — the dispatch then fails
                ks.append(1)
        return ks

    def _execute_attempt(self, sql: str, worker_urls: List[str],
                         properties: dict, on_columns,
                         lifecycle: QueryLifecycle):
        """One scheduling attempt over a fixed worker set. Plain EXPLAIN
        renders the fragmented plan without running it."""
        from presto_tpu_torch.operators.base import DriverContext
        from presto_tpu_torch.parser import parse_statement
        from presto_tpu_torch.parser import tree as T
        from presto_tpu_torch.planner.local_planner import (
            LocalExecutionPlanner, TaskContext,
        )
        from presto_tpu_torch.runner.local import (
            LocalRunner, MaterializedResult, _text_result,
        )
        lifecycle.attempts += 1
        runner = LocalRunner(self.catalog, self.schema, properties,
                             device=self.device)
        stmt = parse_statement(sql)
        if isinstance(stmt, T.Explain) and stmt.analyze:
            raise NotInThisSlice("EXPLAIN ANALYZE across the cluster comes "
                                 "with a later slice of the port "
                                 "(ROADMAP A14)")
        fplan = derive_fragments(runner, sql, stmt=stmt)
        if isinstance(stmt, T.Explain):
            if on_columns is not None:
                on_columns([{"name": "Query Plan", "type": "varchar"}])
            return _text_result("Query Plan", fplan.text().split("\n"))
        if int(get_property(properties, "task_retries")) > 0:
            raise NotInThisSlice(
                "task_retries > 0 (fault-tolerant execution: the stage "
                "scheduler and the task output spool) comes with a later "
                "slice of the port (ROADMAP A13's rest)")
        if not worker_urls and any(f.partitioning == "distributed"
                                   for f in fplan.fragments.values()):
            raise RuntimeError("query requires distributed fragments but "
                               "the coordinator has no workers")
        query_id = uuid.uuid4().hex[:12]
        # the global consumer-task space: one slot per (worker, device);
        # a row goes to h % total, so a key lands on one device of one
        # worker
        ks = self._worker_devices(worker_urls)
        offsets = [0]
        for k in ks:
            offsets.append(offsets[-1] + k)
        total_tasks = max(offsets[-1], 1)
        distributed_urls: List[str] = []
        for url, k in zip(worker_urls, ks):
            distributed_urls.extend([url] * k)
        consumer_urls_by_edge = {}
        n_producers_by_edge = {}
        for xid, edge in fplan.edges.items():
            single_c = fplan.fragments[edge.consumer].partitioning \
                == "single"
            single_p = fplan.fragments[edge.producer].partitioning \
                == "single"
            consumer_urls_by_edge[xid] = [self.url] if single_c \
                else list(distributed_urls)
            n_producers_by_edge[xid] = 1 if single_p else total_tasks
        exchanges = build_http_exchanges(
            query_id, fplan, consumer_urls_by_edge, worker_urls, self.url,
            self.registry, n_producers_by_edge=n_producers_by_edge,
            self_url=self.url, device=self.device)
        # from the first dispatch on, one release guard: a failure at
        # any point aborts the attempt's remote tasks and drops its
        # exchange state before a retry starts the next attempt
        remote: List[tuple] = []
        lifecycle.remote = remote
        stop = threading.Event()
        failure: List[TaskFailed] = []
        try:
            for fid, fragment in fplan.fragments.items():
                if fragment.partitioning != "distributed":
                    continue
                for w, wurl in enumerate(worker_urls):
                    task_id = f"{query_id}.{fid}.{w}"
                    body = json.dumps({
                        "task_id": task_id, "query_id": query_id,
                        "sql": sql,
                        "session": {"catalog": self.catalog,
                                    "schema": self.schema,
                                    "properties": properties},
                        "fragment_id": fid, "task_index": offsets[w],
                        "local_base": offsets[w], "local_count": ks[w],
                        "n_tasks": total_tasks, "worker_urls": worker_urls,
                        "consumer_urls_by_edge": consumer_urls_by_edge,
                        "n_producers_by_edge": n_producers_by_edge,
                        "coordinator_url": self.url,
                    }).encode()
                    try:
                        # a lost response re-POSTs; the worker's create
                        # is idempotent
                        _retry_transient(
                            lambda u=wurl, b=body: http_post(
                                f"{u}/v1/task", b, timeout=30),
                            TRANSPORT_RETRIES)
                    except Exception as e:  # noqa: BLE001
                        raise TaskFailed(
                            f"task dispatch to {wurl} failed: {e}",
                            worker=wurl) from e
                    remote.append((task_id, wurl))

            # the single-partition fragments run here, the root last
            tasks, result = [], None
            for fid, fragment in fplan.fragments.items():
                if fragment.partitioning != "single":
                    continue
                planner = LocalExecutionPlanner(
                    runner.catalogs, runner.session, self.device,
                    task=TaskContext(index=0, count=1, exchanges=exchanges))
                if fid == fplan.root_id:
                    result = planner.plan(fragment.root)
                    tasks.append(result.pipelines)
                else:
                    sinks = [exchanges[e.exchange_id]
                             for e in fplan.producer_edges(fid)]
                    tasks.append(planner.plan_fragment(fragment.root,
                                                       sinks))
            if on_columns is not None:
                on_columns(_columns_of(result.result_names,
                                       result.result_fields))

            def watch():
                # failure detection: a failed task fails the query; a
                # worker that stays unreachable through the retries is
                # implicated (and not re-picked by a retry)
                while not stop.is_set():
                    for task_id, wurl in list(remote):
                        try:
                            st = json.loads(_retry_transient(
                                lambda t=task_id, u=wurl: http_get(
                                    f"{u}/v1/task/{t}", timeout=10), 2))
                        except Exception as e:  # noqa: BLE001
                            failure.append(TaskFailed(
                                f"worker {wurl} unreachable: {e}",
                                worker=wurl))
                            return
                        if st["state"] == "failed":
                            failure.append(TaskFailed(
                                f"task {task_id} failed: {st['error']}",
                                kind=st.get("error_kind"),
                                suggested=st.get("suggested")))
                            return
                    stop.wait(0.2)

            watcher = threading.Thread(target=watch, daemon=True,
                                       name=f"watch-{query_id}")
            watcher.start()
            t0 = time.perf_counter()
            from presto_tpu_torch.runner.local import drive_pipelines
            drive_pipelines(
                tasks, DriverContext(session=runner.session,
                                     device=self.device),
                cancel=lifecycle.cancel.is_set, deadline=lifecycle.deadline,
                abort_check=lambda: failure[0] if failure else None)
            wall_s = time.perf_counter() - t0
            task_stats = [] if failure else self._await_tasks(remote,
                                                              failure)
        finally:
            stop.set()
            lifecycle.remote = []
            self._release_everywhere(query_id, worker_urls)
        if failure:
            raise failure[0]
        out = MaterializedResult(result.result_names, result.result_sink,
                                 result.result_fields)
        out.query_stats = {"execute_ms": round(wall_s * 1e3, 3),
                           "tasks": task_stats}
        return out

    def _await_tasks(self, remote: List[tuple], failure: List,
                     timeout_s: float = 120.0) -> List[dict]:
        """Wait for every remote task to reach a terminal state and
        collect its stats. The root draining means every producer sent
        its end of stream, but a task checks its deferred overflow flags
        after that: a task that then failed (join capacity, group limit)
        must fail the attempt, not leave its partial rows in the
        result, so the rows are trusted only after every task reported
        "finished"."""
        from concurrent.futures import ThreadPoolExecutor

        def fetch(task):
            task_id, wurl = task
            deadline = time.monotonic() + timeout_s
            while True:
                try:
                    st = json.loads(_retry_transient(
                        lambda: http_get(f"{wurl}/v1/task/{task_id}",
                                         timeout=10), 2))
                except Exception as e:  # noqa: BLE001
                    return TaskFailed(f"worker {wurl} unreachable: {e}",
                                      worker=wurl)
                if st["state"] == "failed":
                    return TaskFailed(
                        f"task {task_id} failed: {st['error']}",
                        kind=st.get("error_kind"),
                        suggested=st.get("suggested"))
                if st["state"] != "running":
                    return {"task_id": task_id, "worker": wurl,
                            **(st.get("stats") or {})}
                if time.monotonic() > deadline:
                    return TaskFailed(f"task {task_id} on {wurl} did not "
                                      f"finish within {timeout_s:g}s of "
                                      "the root", worker=wurl)
                time.sleep(0.01)

        if not remote:
            return []
        with ThreadPoolExecutor(max_workers=min(len(remote), 16)) as pool:
            out = list(pool.map(fetch, remote))
        failed = [t for t in out if isinstance(t, TaskFailed)]
        if failed and not failure:
            failure.append(failed[0])
        return [t for t in out if not isinstance(t, TaskFailed)]

    def _release_everywhere(self, query_id: str,
                            worker_urls: List[str]) -> None:
        self.release_query(query_id)
        for wurl in worker_urls:
            try:
                http_post(f"{wurl}/v1/query/{query_id}/release", b"",
                          timeout=10)
            except Exception:  # noqa: BLE001 — best-effort cleanup
                pass


class StatementClient:
    """The client protocol (reference: presto_tpu/server/coordinator.py
    :1794; presto-client StatementClientV1.advance following nextUri).
    `user` / `source` travel as X-Presto-User / X-Presto-Source and
    select the resource group. As a context manager it cancels any
    query still in flight on exit."""

    def __init__(self, server: str, user: str = "", source: str = ""):
        self.server = server.rstrip("/")
        self.user = user
        self.source = source
        self._inflight: set = set()
        self._inflight_lock = threading.Lock()

    def __enter__(self) -> "StatementClient":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.cancel()

    def cancel(self, query_id: Optional[str] = None) -> bool:
        """Kill `query_id`, or every query this client has in flight;
        False when no kill reached the server."""
        if query_id is not None:
            qids = [query_id]
        else:
            with self._inflight_lock:
                qids = list(self._inflight)
        ok = False
        for qid in qids:
            try:
                http_delete(f"{self.server}/v1/statement/{qid}", timeout=10)
                ok = True
            except Exception:  # noqa: BLE001 — best-effort kill
                pass
        return ok

    def execute(self, sql: str, timeout: float = 600.0):
        """(columns, rows) of one statement; raises QueryFailed (or
        QueryCancelled / QueryTimedOut) with the server's message."""
        headers = {}
        if self.user:
            headers["X-Presto-User"] = self.user
        if self.source:
            headers["X-Presto-Source"] = self.source
        resp = json.loads(http_post(f"{self.server}/v1/statement",
                                    sql.encode(), timeout=timeout,
                                    headers=headers))
        deadline = time.time() + timeout
        qid = resp["id"]
        with self._inflight_lock:
            self._inflight.add(qid)
        try:
            next_uri = resp["nextUri"]
            columns = None
            data: list = []
            while True:
                if time.time() > deadline:
                    # kill server-side first: a client that walks away
                    # must not leave the query running
                    self.cancel(qid)
                    raise QueryTimedOut(
                        f"query {qid} exceeded the client timeout "
                        f"({timeout:g}s); kill issued",
                        kind="client_timeout", query_id=qid)
                state = json.loads(http_get(next_uri, timeout=timeout))
                s = state["stats"]["state"]
                if "columns" in state and columns is None:
                    columns = state["columns"]
                if s == "FAILED":
                    err = state.get("error") or {}
                    kind = err.get("errorKind")
                    cls = QueryCancelled \
                        if kind in ("cancelled", "abandoned") \
                        else QueryTimedOut if kind == "deadline_exceeded" \
                        else QueryFailed
                    raise cls(err.get("message", "query failed"),
                              kind=kind, query_id=qid)
                if s == "FINISHED":
                    data.extend(state.get("data", []))
                    nxt = state.get("nextUri")
                    if nxt is None:
                        return columns, data
                    next_uri = nxt
                    continue
                next_uri = state["nextUri"]
                time.sleep(0.05)
        finally:
            with self._inflight_lock:
                self._inflight.discard(qid)
