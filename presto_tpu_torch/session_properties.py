"""Session property registry (reference: SystemSessionProperties.java
— the typed, defaulted, per-query flag system behind SET SESSION and
client session headers; its 110 keys gate every engine experiment).

Each property declares a type, default, and description; SET SESSION
validates the name and coerces the value, and SHOW SESSION lists every
known property with its effective value — unknown keys are rejected at
SET time rather than silently ignored at read time (the reference's
strict-config discipline)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

from presto_tpu_torch.batch import DEFAULT_BATCH_ROWS


@dataclasses.dataclass(frozen=True)
class PropertyDef:
    name: str
    type_name: str                 # bigint | boolean | varchar
    default: Any
    description: str
    validate: Optional[Callable[[Any], Optional[str]]] = None


def _positive(v) -> Optional[str]:
    return None if v > 0 else "must be positive"


def _non_negative(v) -> Optional[str]:
    return None if v >= 0 else "must be >= 0"


def _power_of_two(v) -> Optional[str]:
    if v > 0 and (v & (v - 1)) == 0:
        return None
    return "must be a power of two"


SESSION_PROPERTIES: Dict[str, PropertyDef] = {p.name: p for p in [
    PropertyDef(
        "batch_rows", "bigint", DEFAULT_BATCH_ROWS,
        "Rows per scan batch (power of two; larger batches amortize "
        "dispatch, smaller ones bound HBM)", _power_of_two),
    PropertyDef(
        "max_groups", "bigint", 4096,
        "Initial group-by table capacity; overflow retries the query "
        "with 4x (reference: MultiChannelGroupByHash rehash)",
        _positive),
    PropertyDef(
        "recoverable_grouped_execution", "boolean", False,
        "Retain each lifespan bucket's materialized exchange pages "
        "and stage generation outputs until the bucket completes, so "
        "a TRANSIENT failure re-runs only that bucket (reference: "
        "recoverable grouped execution). Costs host RAM + per-bucket "
        "latency; bucket 0 streams unmaterialized and keeps "
        "whole-query retry"),
    PropertyDef(
        "phased_execution", "boolean", True,
        "Gate probe-producer fragments until their join's "
        "build-producer fragments finish (reference: "
        "PhasedExecutionSchedule): bounds peak memory and makes "
        "cross-fragment dynamic filters deterministic"),
    PropertyDef(
        "query_memory_bytes", "bigint", 0,
        "Declared per-query memory reservation charged against "
        "resource-group memory caps at admission (0 = unaccounted; "
        "reference: query_max_memory against resource-group "
        "softMemoryLimit)", _non_negative),
    PropertyDef(
        "streaming_aggregation", "boolean", True,
        "Aggregate key-sorted inputs (declared-sorted scans, sorted "
        "subqueries) with the streaming operator: O(batch) memory, "
        "groups emitted in key order (reference: "
        "streaming-for-partial-aggregation-enabled)"),
    PropertyDef(
        "dynamic_filtering", "boolean", True,
        "Inner-join build-side key bounds prune probe-side scans in "
        "the same fragment (reference: enable-dynamic-filtering)"),
    PropertyDef(
        "spill_enabled", "boolean", True,
        "Allow memory revocation: join builds and buffered aggregation "
        "partials spill to host RAM under HBM pressure instead of "
        "failing or retrying bucket-wise (reference: "
        "experimental.spill-enabled)"),
    PropertyDef(
        "join_expansion_factor", "bigint", 1,
        "Join output capacity as a multiple of probe batch capacity "
        "(1 is exact for FK->PK joins); on-device overflow detection "
        "retries the query with 4x (sync-free, like max_groups)",
        _positive),
    PropertyDef(
        "broadcast_join_threshold_rows", "bigint", 100_000,
        "Estimated build rows at or below which a join broadcasts "
        "instead of repartitioning (reference: join-distribution "
        "choice in AddExchanges)", _non_negative),
    PropertyDef(
        "hbm_budget_bytes", "bigint", None,
        "Per-query device memory budget; exceeding it fails locally "
        "or triggers bucket-wise execution on a mesh (reference: "
        "query_max_memory_per_node)", _positive),
    PropertyDef(
        "lifespans", "bigint", 1,
        "Grouped (bucket-wise) execution split of the hash space "
        "(reference: Lifespan driver groups)", _positive),
    PropertyDef(
        "host_spool_bytes", "bigint", 8 << 30,
        "Host-RAM budget for spooled lifespan buckets before they "
        "spill to disk (reference: spiller thresholds)",
        _non_negative),
    PropertyDef(
        "query_retries", "bigint", 1,
        "Distributed-query retry budget after worker failures "
        "(reference: per-section retries, max_stage_retries)",
        _non_negative),
    PropertyDef(
        "task_retries", "bigint", 0,
        "Per-task retry budget of the fault-tolerant stage scheduler "
        "(server/scheduler.py): > 0 schedules each distributed "
        "fragment as independently retryable tasks whose outputs "
        "spool at the coordinator, so a dead worker re-runs only its "
        "unfinished tasks and every finished task's spooled pages "
        "are reused; 0 = the streaming path with whole-query elastic "
        "retry only (reference: Trino fault-tolerant execution / "
        "Project Tardigrade task retries)", _non_negative),
    PropertyDef(
        "task_partitions", "bigint", 0,
        "Fixed partition (task) count per distributed fragment under "
        "fault-tolerant execution; 0 derives one task per live "
        "worker device at query start. A fixed count keeps hash "
        "routing — and therefore results — byte-identical across "
        "membership changes (reference: fault-tolerant-execution-"
        "partition-count)", _non_negative),
    PropertyDef(
        "task_dispatch_stagger_ms", "bigint", 0,
        "Artificial delay between consecutive task dispatches of the "
        "stage scheduler (0 = none). A chaos/test knob: widens the "
        "window in which a worker death lands mid-stage so recovery "
        "tests are deterministic instead of racing dispatch",
        _non_negative),
    PropertyDef(
        "fleet_memory_bytes", "bigint", None,
        "Cluster-wide memory budget over the WORKER FLEET: per-worker "
        "reserved bytes ride the heartbeat into the coordinator's "
        "FleetMemoryEnforcer, and a query whose dispatch would "
        "exceed the budget is SHED with the structured "
        "cluster_memory kind instead of OOMing a worker (reference: "
        "ClusterMemoryManager's cluster-wide limit)", _positive),
    PropertyDef(
        "cluster_memory_bytes", "bigint", None,
        "Shared memory budget across ALL concurrently running queries "
        "of this runner/coordinator; on exhaustion the largest "
        "reservation is killed with a structured error (reference: "
        "ClusterMemoryManager + TotalReservationLowMemoryKiller)",
        _positive),
    PropertyDef(
        "array_agg_width", "bigint", 64,
        "Static element capacity of array_agg/map_agg results (the "
        "TPU build's fixed-width array representation); a group "
        "collecting more elements retries the query with 4x "
        "(deviation: Presto arrays are unbounded)", _positive),
    PropertyDef(
        "target_splits", "bigint", 4,
        "Scan splits requested per table (parallel scan fan-out; "
        "reference: initial-splits-per-node)", _positive),
    PropertyDef(
        "plan_cache_enabled", "boolean", True,
        "Serve repeat statements from the process-wide logical-plan "
        "cache (normalized SQL + session fingerprint + table versions "
        "-> optimized plan), skipping parse/analyze/optimize "
        "(reference: the metadata/plan reuse of the Presto papers)"),
    PropertyDef(
        "fragment_result_cache_enabled", "boolean", True,
        "Serve deterministic leaf plan fragments (scan/filter/project/"
        "aggregation chains) from cached output batches, keyed on a "
        "canonical fragment fingerprint + table versions (reference: "
        "FragmentResultCacheManager)"),
    PropertyDef(
        "page_source_cache_enabled", "boolean", True,
        "Cache connector scan output per (table version, split, "
        "columns, constraint) so repeat scans skip the read/generate "
        "+ decode path (reference: the hive connector's data cache)"),
    PropertyDef(
        "query_max_run_time_ms", "bigint", 0,
        "Per-query wall-clock budget enforced at every drive-loop "
        "checkpoint (coordinator root drive, local runner, mesh "
        "phases); 0 = unlimited. Tripping fails the query with the "
        "structured deadline_exceeded kind, releasing its resource-"
        "group slot and aborting remote tasks (reference: "
        "query_max_run_time)", _non_negative),
    PropertyDef(
        "fault_injection", "varchar", "",
        "Deterministic fault-injection spec armed at execute time: "
        "'site:trigger[:arg][:seed]' entries separated by ';' (e.g. "
        "'exchange.push:nth:3'; sites/triggers in execution/"
        "faults.py). Empty = disarmed, zero overhead. Applying the "
        "SAME spec repeatedly does not reset trigger counters"),
    PropertyDef(
        "query_trace_enabled", "boolean", False,
        "Record hierarchical trace spans (query -> driver -> operator "
        "plus exchange/cache/backoff events) for this query; exported "
        "as Chrome trace_event JSON via GET /v1/query/{id}/trace and "
        "tools/trace_viewer.py. Off = zero recording overhead "
        "(telemetry/trace.py)"),
    PropertyDef(
        "kernel_shape_buckets", "boolean", True,
        "Pad every batch entering an operator kernel up to the coarse "
        "power-of-four capacity ladder (floor 4096) so splits, scale "
        "factors, and LIMIT constants reuse one compiled XLA kernel "
        "per bucket instead of minting a trace per exact shape; "
        "results are byte-identical (dead pad lanes = filtered rows). "
        "Off = exact power-of-two shapes, the pre-bucketing behavior "
        "(docs/COMPILATION.md)"),
    PropertyDef(
        "fragment_fusion_enabled", "boolean", True,
        "Whole-fragment XLA compilation (planner/fusion.py): trace "
        "each maximal scan->filter->project->[probe]->agg/topn/limit/"
        "distinct leaf chain into ONE jitted program, collapsing the "
        "per-operator driver hand-offs and deferred count/compact "
        "host rounds. Results are byte-identical with fusion off "
        "(the hard correctness bar); fallback reasons per declined "
        "chain via tools/fusion_report.py "
        "(docs/FRAGMENT_COMPILATION.md)"),
    PropertyDef(
        "plan_validation_enabled", "boolean", True,
        "Run the PlanChecker (planner/validation.py) after analysis "
        "and after every planner pass (optimizer, exchanges, fusion, "
        "local planning handoff): schema/symbol resolution, exchange "
        "partitioning consistency, fused-chain barrier legality, "
        "cache-determinism cross-checks. Violations fail the query "
        "with a structured PlanValidationError naming the pass that "
        "broke the plan (reference: sql/planner/sanity/"
        "PlanSanityChecker). Tree walks are cheap next to XLA "
        "compiles; off = zero checking (docs/STATIC_ANALYSIS.md)"),
    PropertyDef(
        "task_executor_enabled", "boolean", True,
        "Drive this statement's pipelines on the process-wide "
        "time-sliced TaskExecutor (worker pool + multilevel feedback "
        "queue, execution/task_executor.py) instead of a private "
        "serial round-robin loop: many queries interleave in bounded "
        "quanta, cancellation/deadlines fire at quantum boundaries, "
        "and blocked drivers yield their worker "
        "(docs/CONCURRENCY.md)"),
    PropertyDef(
        "task_executor_quantum_ms", "bigint", 25,
        "Time slice one driver may hold an executor worker before "
        "yielding (reference: TaskExecutor's split run quanta). "
        "Smaller = tighter lifecycle latency and fairer interleave, "
        "larger = less scheduling overhead per batch", _positive),
    PropertyDef(
        "admission_queue_timeout_ms", "bigint", 0,
        "Maximum wall time a query may wait in its resource-group "
        "queue before being SHED with the structured rejected kind "
        "(0 = wait forever). Distinct from query_max_run_time_ms, "
        "which also counts queue time but fails with "
        "deadline_exceeded — this is pure load shedding: under "
        "overload, old queued work is dropped before it wastes a "
        "slot on an answer nobody is still waiting for",
        _non_negative),
    PropertyDef(
        "history_based_optimization", "boolean", True,
        "Close the measure->remember->replan loop (presto_tpu/"
        "history): clean executions record measured per-node "
        "cardinalities/selectivities keyed on structural plan "
        "fingerprints + table versions, and the planner's stats "
        "estimator serves them back (provenance-tagged `history`) to "
        "the fusion selectivity gate, join order/build-side choice, "
        "broadcast-vs-partitioned exchanges, and dynamic-filter "
        "planning. Off = static estimates only, nothing recorded "
        "(reference: history-based optimization; docs/ADAPTIVE.md)"),
    PropertyDef(
        "history_driven_fusion", "boolean", True,
        "Allow MEASURED (history-provenance) chain selectivity to "
        "upgrade a gated selective chain to FULL fusion with an "
        "in-trace compaction sized by the measurement "
        "(planner/fusion.py); an in-trace compaction overflow "
        "retries the query once with this off. Requires "
        "history_based_optimization"),
    PropertyDef(
        "cache_memory_bytes", "bigint", 4 << 30,
        "Shared byte budget of the fragment-result + page-source "
        "caches, charged to the cache manager's tagged MemoryPool; "
        "LRU entries evict when a new insert would exceed it",
        _positive),
]}


def validate_set(name: str, value: Any) -> Any:
    """SET SESSION gate: known name, coercible type, valid value.
    NULL resets to the property's default; dotted names (catalog.key)
    are connector-private and pass through unvalidated (reference:
    per-connector session properties)."""
    if "." in name:
        return value
    p = SESSION_PROPERTIES.get(name)
    if p is None:
        known = ", ".join(sorted(SESSION_PROPERTIES))
        raise ValueError(
            f"unknown session property {name!r} (known: {known})")
    if value is None:
        return p.default
    if p.type_name == "bigint":
        if isinstance(value, bool) or not isinstance(value, int):
            raise ValueError(f"{name} expects an integer")
    elif p.type_name == "boolean" and not isinstance(value, bool):
        raise ValueError(f"{name} expects a boolean")
    if p.validate is not None:
        err = p.validate(value)
        if err:
            raise ValueError(f"{name}: {err}")
    return value


def get_property(properties: Dict[str, Any], name: str) -> Any:
    """The ONE effective-value accessor: session override or the
    registry default — every engine consumer reads through here so
    SHOW SESSION can never diverge from behavior."""
    p = SESSION_PROPERTIES[name]
    return properties.get(name, p.default)


def effective(properties: Dict[str, Any]) -> Dict[str, Any]:
    """Every known property with its session-or-default value, plus
    any extra keys the session carries (connector-private settings)."""
    out = {name: properties.get(name, p.default)
           for name, p in SESSION_PROPERTIES.items()}
    for k, v in properties.items():
        out.setdefault(k, v)
    return out
