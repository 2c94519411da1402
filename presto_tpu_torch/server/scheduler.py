"""Live worker membership of the coordinator (reference:
presto_tpu/server/scheduler.py:83-352; HeartbeatFailureDetector.java:93
in Presto).

`HeartbeatMonitor` probes every worker's `/v1/info` in the background:
a worker missing `suspect_after` consecutive probes is SUSPECTED (still
schedulable: one blip must not drain it), missing `remove_after` is
REMOVED, and a removed worker whose probe answers again is re-admitted
with its flap count raised. `report_failure` is the fast path for a
connection failure the coordinator saw inline. The fault-tolerant
`StageScheduler` and `TaskOutputSpool` of the same reference module
(session property `task_retries` > 0) are ROADMAP "A13's rest"; the
fleet memory gate is A10.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

from presto_tpu_torch.server.node import http_get


class WorkerState:
    """One member's live view: the membership state machine and the
    load its last heartbeat carried."""

    __slots__ = ("url", "state", "consecutive_failures", "devices",
                 "last_seen", "rtt_ms", "load", "flaps", "last_error",
                 "clock_offset_ns", "offset_rtt_ms")

    def __init__(self, url: str):
        self.url = url
        self.state = "active"          # active | suspected | removed
        self.consecutive_failures = 0
        self.devices = 1
        self.last_seen: Optional[float] = None
        self.rtt_ms: Optional[float] = None
        self.load: dict = {}
        self.flaps = 0                 # re-admissions after removal
        self.last_error: Optional[str] = None
        #: coordinator perf_counter ns minus the worker's clock_ns at
        #: the probe midpoint, from the smallest-RTT probe
        self.clock_offset_ns: Optional[int] = None
        self.offset_rtt_ms: Optional[float] = None


class HeartbeatMonitor:
    """Background membership view (see the module text)."""

    def __init__(self, worker_urls: List[str], interval_s: float = 1.0,
                 timeout_s: float = 2.0, suspect_after: int = 1,
                 remove_after: int = 3):
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.suspect_after = max(1, int(suspect_after))
        self.remove_after = max(self.suspect_after, int(remove_after))
        self._lock = threading.Lock()
        self._workers: Dict[str, WorkerState] = {
            u: WorkerState(u) for u in worker_urls}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="heartbeat-monitor")
        self._pool = None

    def start(self) -> None:
        from concurrent.futures import ThreadPoolExecutor
        if self._pool is None and self._workers:
            self._pool = ThreadPoolExecutor(
                max_workers=len(self._workers),
                thread_name_prefix="heartbeat-probe")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5)
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.probe_now()
            except Exception:  # noqa: BLE001 — the detector must
                pass           # outlive any single bad probe round

    # -- probing -----------------------------------------------------------

    def probe_now(self) -> None:
        """One probe round over every member: concurrent on the pool
        when the monitor runs, serial otherwise."""
        urls = list(self._workers)
        pool = self._pool
        if pool is not None:
            try:
                list(pool.map(self._probe, urls))
                return
            except RuntimeError:
                pass  # the pool shut down under a racing caller
        for url in urls:
            self._probe(url)

    def _probe(self, url: str) -> None:
        t0_ns = time.perf_counter_ns()
        try:
            info = json.loads(http_get(f"{url}/v1/info",
                                       timeout=self.timeout_s))
            t1_ns = time.perf_counter_ns()
            if info.get("state") != "active":
                raise RuntimeError(f"worker state {info.get('state')}")
        except Exception as e:  # noqa: BLE001 — every failure mode
            self._record_failure(url, f"{type(e).__name__}: {e}")
            return
        self._record_success(url, info, (t1_ns - t0_ns) / 1e6,
                             mid_ns=(t0_ns + t1_ns) // 2)

    def _record_success(self, url: str, info: dict, rtt_ms: float,
                        mid_ns: Optional[int] = None) -> None:
        with self._lock:
            w = self._workers.get(url)
            if w is None:
                return
            was = w.state
            w.consecutive_failures = 0
            w.last_seen = time.monotonic()
            w.rtt_ms = rtt_ms
            w.devices = max(1, int(info.get("devices", 1)))
            w.load = info.get("load") or {}
            w.last_error = None
            w.state = "active"
            if was == "removed":
                # a re-admitted worker is a new process with a new clock
                w.offset_rtt_ms = None
                w.flaps += 1
            remote_clock = info.get("clock_ns")
            if mid_ns is not None and remote_clock is not None \
                    and (w.offset_rtt_ms is None
                         or rtt_ms < w.offset_rtt_ms):
                w.clock_offset_ns = mid_ns - int(remote_clock)
                w.offset_rtt_ms = rtt_ms

    def _record_failure(self, url: str, error: str) -> None:
        with self._lock:
            w = self._workers.get(url)
            if w is None:
                return
            w.consecutive_failures += 1
            w.last_error = error
            if w.consecutive_failures >= self.remove_after:
                w.state = "removed"
            elif w.consecutive_failures >= self.suspect_after \
                    and w.state == "active":
                w.state = "suspected"

    def report_failure(self, url: str) -> None:
        """Inline failure evidence (a dispatch or status poll that stayed
        unreachable through its retries): counts as a failed probe."""
        self._record_failure(url, "reported by scheduler")

    # -- views -------------------------------------------------------------

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [{
                "url": w.url, "state": w.state, "devices": w.devices,
                "consecutive_failures": w.consecutive_failures,
                "flaps": w.flaps,
                "rtt_ms": round(w.rtt_ms, 2)
                if w.rtt_ms is not None else None,
                "load": dict(w.load),
                "clock_offset_ns": w.clock_offset_ns,
                "last_error": w.last_error,
            } for w in self._workers.values()]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for w in self._workers.values():
                out[w.state] = out.get(w.state, 0) + 1
            return out
