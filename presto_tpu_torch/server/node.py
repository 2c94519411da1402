"""Worker/coordinator HTTP node: the task RPC and the exchange data
plane (reference: presto_tpu/server/node.py; TaskResource.java:93,
HttpRemoteTask.java:128 and AsyncPageTransportServlet.java:68 in
Presto).

  - One worker process per card. Batches that cross processes travel
    as compacted, codec-framed pages (server/serde.py) over HTTP,
    pushed to the consuming node.
  - Plans are not serialized: a task spec carries the SQL and the
    session, and the worker re-derives the (deterministic) fragmented
    plan and runs only its fragment.
  - A worker started with `--devices k` runs each fragment as k
    subtasks, logical devices on its one card as MeshRunner's workers
    are; the exchange consumer space is global over every worker's
    devices. A worker whose devices would span cards raises
    `MeshSpansCardsError` (ROADMAP A17).

The node runs its fragments on CUDA unless told `device="cpu"`
(`--device cpu`), and refuses to start without a card otherwise.
HTTP handler threads decode pages on the host only; a task's drive
thread places them on its device. Out of this slice (HTTP 501, or a
named error): `/v1/prewarm` and the compile cache (ROADMAP A10), and
`/v1/metrics`, `/v1/flight`, `/v1/latency`, tracing and `/ui` (A14).
"""

from __future__ import annotations

import collections
import json
import random
import sys
import threading
import time
import traceback
import urllib.error
import urllib.parse
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import torch

from presto_tpu_torch.batch import Batch, Column, bucket_capacity
from presto_tpu_torch.operators.exchange_ops import edge_key_dicts
from presto_tpu_torch.server.serde import (
    batch_from_bytes, batch_to_bytes, to_host_batch,
)

#: transport retries of a page push, a task dispatch or a status poll:
#: the tier below the coordinator's whole-query retry
TRANSPORT_RETRIES = 4
_BACKOFF_BASE_S = 0.05
_BACKOFF_CAP_S = 1.0


class NotInThisSlice(NotImplementedError):
    """An endpoint of a later ROADMAP item: answered with HTTP 501."""


def _retry_transient(fn, retries: int, base_s: float = _BACKOFF_BASE_S,
                     cap_s: float = _BACKOFF_CAP_S):
    """Run `fn` with bounded exponential backoff and jitter on
    transport failures (refused, reset, timeout). An HTTP error
    response is the server's answer and is never retried."""
    attempt = 0
    while True:
        try:
            return fn()
        except urllib.error.HTTPError:
            raise
        except (urllib.error.URLError, ConnectionError, TimeoutError,
                OSError):
            attempt += 1
            if attempt > retries:
                raise
            delay = min(base_s * (2 ** (attempt - 1)), cap_s)
            time.sleep(delay * (0.5 + random.random() * 0.5))


def http_post(url: str, body: bytes, timeout: float = 60.0,
              headers: Optional[dict] = None, retries: int = 0) -> bytes:
    def send():
        req = urllib.request.Request(url, data=body, method="POST")
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read()
    return _retry_transient(send, retries) if retries else send()


def http_get(url: str, timeout: float = 60.0, retries: int = 0) -> bytes:
    def send():
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.read()
    return _retry_transient(send, retries) if retries else send()


def http_delete(url: str, timeout: float = 60.0,
                retries: int = 0) -> bytes:
    def send():
        req = urllib.request.Request(url, method="DELETE")
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.read()
    return _retry_transient(send, retries) if retries else send()


class ExchangeRegistry:
    """Incoming side of every exchange this node consumes: queues per
    (exchange key, consumer task) plus end-of-stream accounting. Keys
    are "<query_id>:<exchange_id>"."""

    _RELEASED_MAX = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self._queues: Dict[Tuple[str, int], collections.deque] = \
            collections.defaultdict(collections.deque)
        self._eos: Dict[Tuple[str, int], set] = \
            collections.defaultdict(set)
        self._expected: Dict[str, int] = {}
        #: released query ids: straggler pages are dropped (bounded)
        self._released: "collections.OrderedDict[str, None]" = \
            collections.OrderedDict()
        #: highest sequence number accepted per (key, consumer,
        #: producer): a retried push that had landed is dropped here
        self._last_seq: Dict[Tuple[str, int, int], int] = {}

    def _is_released(self, key: str) -> bool:
        return key.split(":", 1)[0] in self._released

    def expect_producers(self, key: str, count: int) -> None:
        with self._lock:
            self._expected[key] = count

    def receive(self, key: str, consumer: int, payload: bytes,
                producer: Optional[int] = None,
                seq: Optional[int] = None) -> None:
        with self._lock:
            if self._is_released(key):
                return
            if producer is not None and seq is not None:
                sk = (key, consumer, producer)
                if self._last_seq.get(sk, -1) >= seq:
                    return  # the duplicate of a retried push
                # pushes per (producer, consumer) are sequential, so
                # marking before the decode cannot skip a gap
                self._last_seq[sk] = seq
        batch = batch_from_bytes(payload)
        with self._lock:
            if not self._is_released(key):
                self._queues[(key, consumer)].append(batch)

    def receive_eos(self, key: str, consumer: int, producer: int) -> None:
        with self._lock:
            if not self._is_released(key):
                self._eos[(key, consumer)].add(producer)

    def receive_local(self, key: str, consumer: int, batch: Batch) -> None:
        """Same-process delivery: the host batch itself, no serde and no
        HTTP (the self-delivery short circuit)."""
        with self._lock:
            if not self._is_released(key):
                self._queues[(key, consumer)].append(batch)

    def pop(self, key: str, consumer: int) -> Optional[Batch]:
        with self._lock:
            q = self._queues[(key, consumer)]
            return q.popleft() if q else None

    def has_output(self, key: str, consumer: int) -> bool:
        with self._lock:
            return bool(self._queues[(key, consumer)])

    def finished(self, key: str, consumer: int) -> bool:
        with self._lock:
            done = len(self._eos[(key, consumer)]) \
                >= self._expected.get(key, 1 << 30)
            return done and not self._queues[(key, consumer)]

    def drop_query(self, query_id: str) -> None:
        """Release every queue, end-of-stream set and expectation of a
        finished or failed query, and remember the id so pages still in
        flight are dropped on arrival."""
        prefix = f"{query_id}:"
        with self._lock:
            self._released[query_id] = None
            while len(self._released) > self._RELEASED_MAX:
                self._released.popitem(last=False)
            for d in (self._queues, self._eos):
                for k in [k for k in d if k[0].startswith(prefix)]:
                    del d[k]
            for k in [k for k in self._expected if k.startswith(prefix)]:
                del self._expected[k]
            for k in [k for k in self._last_seq
                      if k[0].startswith(prefix)]:
                del self._last_seq[k]


def _host_segment(host: Batch, lo: int, hi: int) -> Batch:
    """Rows [lo, hi) of a host batch whose live rows are a prefix, as a
    host batch padded to the power-of-two capacity bucket (reference:
    presto_tpu/server/node.py:247)."""
    n = hi - lo
    pad = bucket_capacity(max(n, 1)) - n

    def seg(t):
        return torch.cat([t[lo:hi], t.new_zeros(pad)])

    cols = {name: Column(seg(c.data), seg(c.mask), c.type, c.dictionary)
            for name, c in host.columns.items()}
    return Batch(cols, seg(host.row_valid))


#: this process's exchange traffic, by kind: "pages" and "bytes" pushed
#: over HTTP, "local" deliveries, "keyed" pushes (one K20 call each)
TRAFFIC: "collections.Counter[str]" = collections.Counter()


class HttpExchange:
    """The MeshExchange interface over the HTTP data plane: pushes route
    batches to consumer NODES; pops read this node's registry queues
    (filled by the HTTP handler threads) and place each page on the
    consumer task's device.

    A hash repartition is ONE K20 call (the destination-sorted batch and
    its bounds), ONE device->host read of the live prefix into pinned
    memory, then host slices per consumer, not a mask, compaction and
    serialization per consumer. Consumers in this process (self_url)
    get the host batch through the registry directly: no serde, no
    localhost HTTP. `device` is the consumer tasks' device, where pop()
    places each page."""

    def __init__(self, exchange_key: str, scheme: str, partition_keys,
                 hash_dicts, key_dictionaries, consumer_urls: List[str],
                 n_producers: int, registry: ExchangeRegistry,
                 self_url: Optional[str] = None, *,
                 device: torch.device):
        from presto_tpu_torch.operators.exchange_ops import (
            build_remap_tables,
        )
        self.exchange_id = exchange_key
        self.scheme = scheme
        self.partition_keys = list(partition_keys)
        self.consumer_urls = consumer_urls
        self.n_consumers = len(consumer_urls)
        self.registry = registry
        self.self_url = self_url
        self.device = device
        registry.expect_producers(exchange_key, n_producers)
        self._rr = 0
        self._remaps = build_remap_tables(hash_dicts, key_dictionaries,
                                          self.device)
        #: outgoing page sequence per (producer, consumer): rides the
        #: push URL so the receiver drops a retried duplicate
        self._seq: Dict[Tuple[int, int], int] = {}

    # -- producer side (outgoing HTTP) -----------------------------------

    def _is_local(self, consumer: int) -> bool:
        return self.self_url is not None \
            and self.consumer_urls[consumer] == self.self_url

    def _post(self, consumer: int, payload: bytes, producer: int) -> None:
        """One page push, sequence-numbered and retried with backoff."""
        sk = (producer, consumer)
        seq = self._seq.get(sk, -1) + 1
        self._seq[sk] = seq
        url = (f"{self.consumer_urls[consumer]}/v1/exchange/"
               f"{self.exchange_id}/{consumer}"
               f"?producer={producer}&seq={seq}")
        TRAFFIC["pages"] += 1
        TRAFFIC["bytes"] += len(payload)
        _retry_transient(lambda: http_post(url, payload), TRANSPORT_RETRIES)

    def _deliver_whole(self, consumers: List[int], batch: Batch,
                       producer: int) -> None:
        """One un-split batch to each listed consumer: local ones share
        the compacted host batch, remote ones one serialization."""
        local = [c for c in consumers if self._is_local(c)]
        remote = [c for c in consumers if not self._is_local(c)]
        payload = None
        if local:
            n = batch.num_valid()
            host = to_host_batch(batch.compact(bucket_capacity(max(n, 1)),
                                               known_valid=n))
            for c in local:
                TRAFFIC["local"] += 1
                self.registry.receive_local(self.exchange_id, c, host)
            if remote:
                payload = batch_to_bytes(host, assume_compact=True)
        elif remote:
            payload = batch_to_bytes(batch)
        for c in remote:
            self._post(c, payload, producer)

    def push(self, producer: int, batch: Batch) -> None:
        if self.scheme == "gather":
            self._deliver_whole([0], batch, producer)
        elif self.scheme == "broadcast":
            self._deliver_whole(list(range(self.n_consumers)), batch,
                                producer)
        elif self.scheme == "passthrough":
            self._deliver_whole([producer], batch, producer)
        elif self.scheme == "repartition" and not self.partition_keys:
            c = self._rr % self.n_consumers
            self._rr += 1
            self._deliver_whole([c], batch, producer)
        else:
            self._push_keyed(producer, batch)

    def _push_keyed(self, producer: int, batch: Batch) -> None:
        from presto_tpu_torch.native.pages import read_to_host
        from presto_tpu_torch.operators.exchange_ops import (
            partition_segments,
        )
        TRAFFIC["keyed"] += 1
        dev_sorted, bounds = partition_segments(
            batch, self.partition_keys, self._remaps, self.n_consumers)
        hb = read_to_host([bounds])[0].tolist()
        live = hb[-1]
        # only the live prefix crosses to the host; the dead tail's
        # payload was never written
        host_batch = to_host_batch(Batch(
            {n: Column(c.data[:live], c.mask[:live], c.type, c.dictionary)
             for n, c in dev_sorted.columns.items()},
            dev_sorted.row_valid[:live]))
        for c in range(self.n_consumers):
            lo, hi = hb[c], hb[c + 1]
            if lo == hi:
                continue  # nothing for this consumer
            seg = _host_segment(host_batch, lo, hi)
            if self._is_local(c):
                TRAFFIC["local"] += 1
                self.registry.receive_local(self.exchange_id, c, seg)
            else:
                self._post(c, batch_to_bytes(seg, assume_compact=True),
                           producer)

    def producer_done(self, producer: int) -> None:
        # end-of-stream is idempotent (a producer-set union), so the
        # retried POST needs no sequence number
        for c in range(self.n_consumers):
            if self._is_local(c):
                self.registry.receive_eos(self.exchange_id, c, producer)
                continue
            http_post(f"{self.consumer_urls[c]}/v1/exchange/"
                      f"{self.exchange_id}/{c}/eos?producer={producer}",
                      b"", retries=TRANSPORT_RETRIES)

    # -- consumer side (local registry) ----------------------------------

    def pop(self, consumer: int) -> Optional[Batch]:
        """The next page for `consumer`, padded to the quantized
        capacity ladder and placed on this exchange's device (pinned
        host->device copies) in the calling drive thread."""
        from presto_tpu_torch.native.pages import to_device
        from presto_tpu_torch.operators.exchange_ops import (
            host_pad_quantized,
        )
        b = self.registry.pop(self.exchange_id, consumer)
        if b is None:
            return None
        b = host_pad_quantized(b)
        if self.device.type == "cpu":
            return b

        def put(t):
            return to_device(t.numpy(), self.device)

        return Batch({n: Column(put(c.data), put(c.mask), c.type,
                                c.dictionary)
                      for n, c in b.columns.items()}, put(b.row_valid))

    def has_output(self, consumer: int) -> bool:
        return self.registry.has_output(self.exchange_id, consumer)

    def finished(self, consumer: int) -> bool:
        return self.registry.finished(self.exchange_id, consumer)

    # -- the mesh's fused-chain hooks (planner/fusion.py) ------------------

    def chain_eligible(self) -> bool:
        """A page push absorbs no chain: only the mesh's collective
        wave does."""
        return False

    def attach_chain(self, stages, chain_key, label: str) -> bool:
        return False


class TaskState:
    def __init__(self):
        self.state = "running"
        self.error: Optional[str] = None
        #: {"wall_s", "kernels", "traffic"} of the finished task
        self.stats: Optional[dict] = None
        #: the structured retry protocol: an overflow (join capacity,
        #: group limit) asks the COORDINATOR to re-run the query with
        #: the suggested setting
        self.error_kind: Optional[str] = None
        self.suggested: Optional[int] = None
        self.cancel = threading.Event()
        self.done_at: Optional[float] = None  # set at terminal state


class NodeHandler(BaseHTTPRequestHandler):
    node: "Node" = None  # bound per node

    def log_message(self, fmt, *args):  # quiet
        pass

    def _reply(self, code: int, body: bytes = b"") -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _serve(self, fn) -> None:
        try:
            body = fn()
        except KeyError:
            self._reply(404, b'{"error": "not found"}')
            return
        except NotInThisSlice as e:
            self._reply(501, json.dumps({"error": str(e)}).encode())
            return
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            self._reply(500, json.dumps(
                {"error": f"{type(e).__name__}: {e}",
                 "trace": traceback.format_exc(limit=5)}).encode())
            return
        self._reply(200, body)

    def do_GET(self):
        self._serve(lambda: self.node.handle_get(self.path))

    def do_POST(self):
        n = int(self.headers.get("Content-Length", "0"))
        body = self.rfile.read(n)
        self._serve(lambda: self.node.handle_post(self.path, body,
                                                  dict(self.headers)))

    def do_DELETE(self):
        self._serve(lambda: self.node.handle_delete(self.path))


_LATER = {"/v1/prewarm": "A10 (the compile cache and prewarm)",
          "/v1/metrics": "A14", "/v1/flight": "A14", "/v1/latency": "A14",
          "/ui": "A14", "/ui/": "A14"}


def _later(path: str) -> None:
    base = path.split("?", 1)[0]
    item = _LATER.get(base)
    if item is None and base.startswith("/v1/task/") \
            and base.endswith("/trace"):
        item = "A14 (tracing)"
    if item is not None:
        raise NotInThisSlice(f"{base} comes with a later slice of the "
                             f"port (ROADMAP {item})")


class Node:
    """Shared HTTP node: exchange receipt + task RPC. The coordinator
    subclass adds the client protocol. `n_devices` > 1 makes it a
    mesh-per-worker node: each fragment task expands into one subtask
    per logical device of its card."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 n_devices: Optional[int] = 1, device=None):
        from presto_tpu_torch.parallel.mesh import make_mesh
        self.mesh = make_mesh(n_devices, device)
        self.device = self.mesh.device
        self.n_devices = self.mesh.size
        self.registry = ExchangeRegistry()
        self.tasks: Dict[str, TaskState] = {}
        handler = type("BoundHandler", (NodeHandler,), {"node": self})

        class _Server(ThreadingHTTPServer):
            # a deep listen backlog: admission control, not the kernel's
            # SYN queue, is what turns clients away
            request_queue_size = 1024
            daemon_threads = True

        self.httpd = _Server((host, port), handler)
        self.port = self.httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True, name="http-server")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        # shutdown() waits for serve_forever, so only a started server
        # is shut down
        if self._thread.is_alive():
            self.httpd.shutdown()
            self._thread.join(timeout=5)
        self.httpd.server_close()

    # -- routing -----------------------------------------------------------

    def info(self) -> dict:
        from presto_tpu_torch.telemetry.kernels import CALLS, COUNTERS
        return {"state": "active", "devices": self.n_devices,
                "device": str(self.device),
                "clock_ns": time.perf_counter_ns(),
                "load": {"tasks_running": sum(
                    1 for t in list(self.tasks.values())
                    if t.state == "running")},
                "kernels": {k: c.launches for k, c in COUNTERS.items()},
                "calls": dict(CALLS), "traffic": dict(TRAFFIC)}

    def handle_get(self, path: str) -> bytes:
        _later(path)
        if path == "/v1/info":
            return json.dumps(self.info()).encode()
        if path == "/v1/tasks":
            return json.dumps({
                tid: {"state": t.state, "error": t.error}
                for tid, t in list(self.tasks.items())}).encode()
        if path.startswith("/v1/task/"):
            tid = path.rsplit("/", 1)[1]
            t = self.tasks[tid]
            return json.dumps({"state": t.state, "error": t.error,
                               "error_kind": t.error_kind,
                               "suggested": t.suggested,
                               "stats": t.stats}).encode()
        raise KeyError(path)

    def handle_post(self, path: str, body: bytes,
                    headers: Optional[dict] = None) -> bytes:
        _later(path)
        if path.startswith("/v1/exchange/"):
            rest = path[len("/v1/exchange/"):]
            params: Dict[str, str] = {}
            if "?" in rest:
                rest, qs = rest.split("?", 1)
                params = dict(urllib.parse.parse_qsl(qs))
            if rest.endswith("/eos"):
                xid, consumer = rest[:-len("/eos")].rsplit("/", 1)
                self.registry.receive_eos(xid, int(consumer),
                                          int(params["producer"]))
                return b"{}"
            xid, consumer = rest.rsplit("/", 1)
            producer = params.get("producer")
            seq = params.get("seq")
            self.registry.receive(
                xid, int(consumer), body,
                producer=int(producer) if producer is not None else None,
                seq=int(seq) if seq is not None else None)
            return b"{}"
        if path == "/v1/task":
            spec = json.loads(body.decode())
            self.create_task(spec)
            return json.dumps({"taskId": spec["task_id"]}).encode()
        if path.startswith("/v1/query/") and path.endswith("/release"):
            self.release_query(path.split("/")[3])
            return b"{}"
        raise KeyError(path)

    def handle_delete(self, path: str) -> bytes:
        if path.startswith("/v1/task/"):
            # task abort: the drive loop polls the cancel flag each
            # round; idempotent
            tid = path.rsplit("/", 1)[1]
            t = self.tasks[tid]
            t.cancel.set()
            return json.dumps({"taskId": tid, "state": t.state}).encode()
        raise KeyError(path)

    # -- task execution ----------------------------------------------------

    def create_task(self, spec: dict) -> None:
        self._prune_tasks()
        tid = spec["task_id"]
        state = TaskState()
        # idempotent create: a dispatch whose response was lost is
        # retried, and the task must not run twice
        if self.tasks.setdefault(tid, state) is not state:
            return
        threading.Thread(target=self._run_task, args=(spec, state),
                         daemon=True, name=f"task-{tid}").start()

    def _prune_tasks(self, ttl_s: float = 600.0) -> None:
        """Evict tasks `ttl_s` after they reached a terminal state."""
        now = time.monotonic()
        for tid in [tid for tid, t in list(self.tasks.items())
                    if t.done_at is not None and now - t.done_at > ttl_s]:
            self.tasks.pop(tid, None)

    def release_query(self, query_id: str) -> None:
        for tid, t in list(self.tasks.items()):
            if tid.startswith(f"{query_id}."):
                t.cancel.set()
        self.registry.drop_query(query_id)

    def _run_task(self, spec: dict, state: TaskState) -> None:
        from presto_tpu_torch.operators.aggregation import (
            GroupLimitExceeded,
        )
        from presto_tpu_torch.operators.join_ops import (
            JoinCapacityExceeded,
        )
        try:
            state.stats = self.execute_fragment(spec, state.cancel)
            state.state = "finished"
        except Exception as e:  # noqa: BLE001 — reported over the RPC
            if state.cancel.is_set():
                state.state = "aborted"
            else:
                if isinstance(e, JoinCapacityExceeded):
                    state.error_kind = "join_capacity"
                    state.suggested = e.suggested
                elif isinstance(e, GroupLimitExceeded):
                    state.error_kind = "group_limit"
                    state.suggested = e.suggested
                state.error = (f"{type(e).__name__}: {e}\n"
                               f"{traceback.format_exc(limit=8)}")
                state.state = "failed"
        finally:
            state.done_at = time.monotonic()

    def execute_fragment(self, spec: dict,
                         cancel: Optional[threading.Event] = None) -> dict:
        """Re-derive the fragmented plan from the SQL and run this
        node's task(s) of fragment `fragment_id`: one subtask per local
        device when the spec carries `local_count` > 1, all driven in
        one round-robin loop. Returns {"wall_s", "kernels": launches of
        each hand-written kernel in this process during the task (other
        tasks running at the same time count too), "traffic": the same
        for the exchange counters}."""
        from presto_tpu_torch.operators.base import DriverContext
        from presto_tpu_torch.planner.local_planner import (
            LocalExecutionPlanner, TaskContext,
        )
        from presto_tpu_torch.runner.local import (
            LocalRunner, drive_pipelines,
        )
        from presto_tpu_torch.telemetry.kernels import COUNTERS
        before = {k: c.launches for k, c in COUNTERS.items()}
        traffic0 = dict(TRAFFIC)
        t0 = time.perf_counter()
        session = spec["session"]
        runner = LocalRunner(session["catalog"], session["schema"],
                             session["properties"], device=self.device)
        fplan = derive_fragments(runner, spec["sql"])
        fid = spec["fragment_id"]
        fragment = fplan.fragments[fid]
        exchanges = build_http_exchanges(
            spec["query_id"], fplan, spec.get("consumer_urls_by_edge"),
            spec["worker_urls"], spec["coordinator_url"], self.registry,
            n_producers_by_edge=spec.get("n_producers_by_edge"),
            self_url=self.url, device=self.device)
        k = int(spec.get("local_count", 1))
        if k > self.n_devices:
            raise RuntimeError(f"task wants {k} local devices, node has "
                               f"{self.n_devices}")
        base = int(spec.get("local_base", spec.get("task_index", 0)))
        sinks = [exchanges[e.exchange_id]
                 for e in fplan.producer_edges(fid)]
        tasks = []
        for local in range(k):
            planner = LocalExecutionPlanner(
                runner.catalogs, runner.session, self.device,
                task=TaskContext(index=base + local,
                                 count=int(spec["n_tasks"]),
                                 exchanges=exchanges))
            tasks.append(planner.plan_fragment(fragment.root, sinks))
        dctx = DriverContext(session=runner.session, device=self.device)
        drive_pipelines(tasks, dctx,
                        cancel=cancel.is_set if cancel is not None
                        else None)
        return {"wall_s": round(time.perf_counter() - t0, 6),
                "kernels": {n: c.launches - before.get(n, 0)
                            for n, c in COUNTERS.items()
                            if c.launches - before.get(n, 0)},
                "traffic": {n: v - traffic0.get(n, 0)
                            for n, v in TRAFFIC.items()}}


def derive_fragments(runner, sql: str, stmt=None):
    """SQL -> the same FragmentedPlan on every node (symbol allocation
    and fragment numbering are deterministic; reference:
    presto_tpu/server/node.py:1011). An EXPLAIN wrapper is unwrapped."""
    from presto_tpu_torch.parser import parse_statement
    from presto_tpu_torch.parser import tree as T
    from presto_tpu_torch.planner.analyzer import plan_statement
    from presto_tpu_torch.planner.exchanges import (
        add_exchanges, fragment_plan,
    )
    from presto_tpu_torch.planner.local_planner import prune_unused_columns
    from presto_tpu_torch.planner.optimizer import optimize
    from presto_tpu_torch.planner.validation import (
        validate, validate_fragments,
    )
    from presto_tpu_torch.runner.local import QueryError
    if stmt is None:
        stmt = parse_statement(sql)
    if isinstance(stmt, T.Explain):
        stmt = stmt.statement
    if not isinstance(stmt, T.Query):
        raise QueryError(f"the cluster runs queries only, not "
                         f"{type(stmt).__name__}")
    from presto_tpu_torch.planner.analyzer import AnalysisError
    try:
        plan = plan_statement(stmt, runner.catalogs, runner.session)
    except AnalysisError as e:
        raise QueryError(str(e)) from e
    validate(plan, "analysis", session=runner.session)
    plan = optimize(plan, runner.catalogs, session=runner.session)
    validate(plan, "optimizer", session=runner.session)
    prune_unused_columns(plan)
    plan = add_exchanges(plan, runner.catalogs, runner.session)
    validate(plan, "exchanges", session=runner.session)
    fplan = fragment_plan(plan)
    validate_fragments(fplan, "exchanges", session=runner.session)
    return fplan


def build_http_exchanges(query_id: str, fplan, consumer_urls_by_edge,
                         worker_urls: List[str], coordinator_url: str,
                         registry: ExchangeRegistry,
                         n_producers_by_edge=None,
                         self_url: Optional[str] = None, *,
                         device: torch.device
                         ) -> Dict[int, HttpExchange]:
    """One HttpExchange per edge. The coordinator computes a GLOBAL
    consumer URL table per edge (one slot per consumer TASK: a
    mesh-per-worker node's URL appears once per device) and the global
    producer count, and ships both in the task spec so every node
    agrees; without them the table is one slot per worker."""
    out: Dict[int, HttpExchange] = {}

    def lookup(table, xid):
        return table[str(xid) if str(xid) in table else xid]

    for xid, edge in fplan.edges.items():
        consumer = fplan.fragments[edge.consumer]
        producer = fplan.fragments[edge.producer]
        if consumer_urls_by_edge is not None:
            consumer_urls = lookup(consumer_urls_by_edge, xid)
        else:
            consumer_urls = [coordinator_url] \
                if consumer.partitioning == "single" else list(worker_urls)
        if n_producers_by_edge is not None:
            n_producers = lookup(n_producers_by_edge, xid)
        else:
            n_producers = 1 if producer.partitioning == "single" \
                else len(worker_urls)
        out[xid] = HttpExchange(
            f"{query_id}:{xid}", edge.scheme, edge.partition_keys,
            edge.hash_dicts, edge_key_dicts(edge), consumer_urls,
            n_producers, registry, self_url=self_url, device=device)
    return out


def spawn_workers(n: int, args=(), timeout_s: float = 240.0,
                  log_dir=None, launcher=None):
    """Start n worker processes of this checkout (`python -m
    presto_tpu_torch.server.node --port 0 *args`, or `launcher` + the
    same arguments) together, and return (processes, urls) once each
    printed its url. A worker that has not within `timeout_s` is
    killed, and then all are stopped and the call raises. Their stderr
    goes to `log_dir`/worker-<i>.log, or nowhere."""
    import pathlib
    import subprocess
    root = pathlib.Path(__file__).resolve().parents[2]
    head = list(launcher or [sys.executable, "-m",
                             "presto_tpu_torch.server.node"])
    procs = []
    try:
        for i in range(n):
            err = subprocess.DEVNULL
            if log_dir is not None:
                pathlib.Path(log_dir).mkdir(parents=True, exist_ok=True)
                err = open(pathlib.Path(log_dir) / f"worker-{i}.log", "w")
            procs.append(subprocess.Popen(
                head + ["--port", "0", *args], cwd=root,
                stdout=subprocess.PIPE, stderr=err, text=True))
            if err is not subprocess.DEVNULL:
                err.close()  # the child holds its own descriptor
        urls = []
        for p in procs:
            timer = threading.Timer(timeout_s, p.kill)
            timer.start()
            try:
                line = p.stdout.readline()
            finally:
                timer.cancel()
            if not line:
                raise RuntimeError(f"a worker exited ({p.wait()}) before "
                                   "printing its url")
            urls.append(json.loads(line)["url"])
        return procs, urls
    except BaseException:
        stop_workers(procs)
        raise


def stop_workers(procs, timeout_s: float = 15.0) -> None:
    """SIGTERM each worker process, then kill what has not exited."""
    import signal
    import subprocess
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=timeout_s)


def worker_main(argv=None) -> None:
    """A worker process:
    python -m presto_tpu_torch.server.node --port 0 [--devices k]
    [--device cpu]. Prints {"url": ...} as its first stdout line."""
    import argparse
    p = argparse.ArgumentParser(prog="presto_tpu_torch.server.node")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--devices", default="1",
                   help="logical devices (subtasks per fragment task) on "
                        "this worker's card; 'auto' = one per visible "
                        "card, which must be one")
    p.add_argument("--device", default=None,
                   help="torch device (default: CUDA; 'cpu' runs the "
                        "plain versions of the kernels)")
    args = p.parse_args(argv)
    n_devices = None if args.devices == "auto" else int(args.devices)
    node = Node(args.host, args.port, n_devices=n_devices,
                device=args.device)
    node.start()
    print(json.dumps({"url": node.url}), flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        node.stop()


if __name__ == "__main__":
    sys.exit(worker_main())
