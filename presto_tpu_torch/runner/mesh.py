"""MeshRunner: distributed SQL execution over the mesh's workers
(reference: presto_tpu/runner/mesh.py; DistributedQueryRunner.java:85).

parse -> plan -> optimize -> add_exchanges -> fragment -> one task per
worker per distributed fragment (one task for a single fragment, fewer
for a scaled writer) -> one round-robin drive over every task, with the
exchanges moving batches between them (operators/exchange_ops.py, K18
for hash repartitions, K19 for the merge of sorted runs).

The W workers live in this process. `MeshRunner(..., n_workers=8)`
puts eight logical workers on one card (`cuda:0` by default,
`device="cpu"` for the plain versions); without `n_workers` the mesh
has one worker per visible card, and a mesh across cards raises
`MeshSpansCardsError` (ROADMAP A17). A task runs its pipelines in plan
order, as LocalRunner does (every join build before its probe); the
tasks and fragments interleave, one driver step at a time. With
`phased_execution` a fragment feeding a join's probe side starts only
after the fragments feeding its build side finished, and a scan pruned
by a cross-fragment dynamic filter waits until every build task
published it. Overflows (GroupLimitExceeded, JoinCapacityExceeded)
re-run the query at four times the setting, as the local runner does.
Grouped execution (`lifespans` > 1) needs ROADMAP A10 and raises; the
reference's history-fusion retry waits for A11.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Union

import torch

from presto_tpu_torch.operators.aggregation import GroupLimitExceeded
from presto_tpu_torch.operators.base import (
    DriverContext, run_deferred_checks,
)
from presto_tpu_torch.operators.driver import Driver
from presto_tpu_torch.operators.exchange_ops import (
    MeshExchange, edge_key_dicts,
)
from presto_tpu_torch.operators.join_ops import JoinCapacityExceeded
from presto_tpu_torch.parallel.mesh import make_mesh
from presto_tpu_torch.planner import nodes as N
from presto_tpu_torch.planner.exchanges import (
    FragmentedPlan, add_exchanges, fragment_plan,
)
from presto_tpu_torch.planner.local_planner import (
    LocalExecutionPlanner, LocalPlanningError, TaskContext,
    prune_unused_columns,
)
from presto_tpu_torch.runner.local import (
    MAX_IDLE_ROUNDS, LocalRunner, MaterializedResult, QueryError,
    drive_drivers,
)
from presto_tpu_torch.session_properties import get_property


class MeshRunner(LocalRunner):
    def __init__(self, catalog: str = "tpch", schema: str = "tiny",
                 properties: Optional[Dict[str, Any]] = None,
                 n_workers: Optional[int] = None,
                 device: Union[None, str, torch.device] = None):
        self.mesh = make_mesh(n_workers, device)
        super().__init__(catalog, schema, properties,
                         device=self.mesh.device)
        self.n_workers = self.mesh.size
        #: the last query's exchanges (waves, rows and bytes moved)
        self.last_exchanges: Dict[int, MeshExchange] = {}

    def _run_plan(self, plan: N.OutputNode,
                  on_retry=None) -> MaterializedResult:
        prune_unused_columns(plan)
        plan = add_exchanges(plan, self.catalogs, self.session)
        from presto_tpu_torch.planner.validation import (
            validate, validate_fragments,
        )
        validate(plan, "exchanges", session=self.session)
        fplan = fragment_plan(plan)
        validate_fragments(fplan, "exchanges", session=self.session)
        session = self.session
        while True:
            try:
                return self._run_fragments(fplan, session)
            except GroupLimitExceeded as e:
                if e.suggested > 1 << 26:
                    raise QueryError(
                        "group-by exceeds max supported groups") from e
                session = dataclasses.replace(session, properties={
                    **session.properties, "max_groups": e.suggested})
            except JoinCapacityExceeded as e:
                if e.suggested > 1 << 10:
                    raise QueryError(
                        "join expansion exceeds supported factor") from e
                session = dataclasses.replace(session, properties={
                    **session.properties,
                    "join_expansion_factor": e.suggested})
            if on_retry is not None:
                on_retry()

    def _task_count(self, fragment) -> int:
        if fragment.partitioning == "single":
            return 1
        if fragment.max_tasks:
            # scaled writers: the fragment's width sized by data volume
            return max(1, min(self.n_workers, fragment.max_tasks))
        return self.n_workers

    @staticmethod
    def _grouped_eligible(fplan: FragmentedPlan, fragment) -> bool:
        """A fragment could run bucket-wise iff every input is a keyed
        repartition and it holds no scan and no unique-id generator
        (reference: presto_tpu/runner/mesh.py:196)."""
        if fragment.partitioning != "distributed":
            return False
        edges = [fplan.edges[x] for x in fragment.source_edges]
        if not edges or any(e.scheme != "repartition"
                            or not e.partition_keys for e in edges):
            return False
        stack = [fragment.root]
        while stack:
            n = stack.pop()
            if isinstance(n, (N.TableScanNode, N.AssignUniqueIdNode)):
                return False
            stack.extend(n.sources())
        return True

    def _run_fragments(self, fplan: FragmentedPlan,
                       session) -> MaterializedResult:
        G = int(get_property(session.properties, "lifespans"))
        lifespans_of = {
            fid: (G if G > 1 and self._grouped_eligible(fplan, frag)
                  else 1)
            for fid, frag in fplan.fragments.items()}
        exchanges: Dict[int, MeshExchange] = {}
        for xid, edge in fplan.edges.items():
            exchanges[xid] = MeshExchange(
                xid, edge.scheme, edge.partition_keys, edge.hash_dicts,
                edge_key_dicts(edge), self.mesh,
                n_producers=self._task_count(
                    fplan.fragments[edge.producer]),
                n_consumers=self._task_count(
                    fplan.fragments[edge.consumer]),
                lifespans=lifespans_of[edge.consumer])
        self.last_exchanges = exchanges

        # cross-fragment dynamic filters: one service per query; each
        # filter expects one publication per task of its build fragment
        df_service = cross_df = None
        if bool(get_property(session.properties, "dynamic_filtering")):
            from presto_tpu_torch.execution.dynamic_filters import (
                DynamicFilterService,
            )
            from presto_tpu_torch.planner.exchanges import (
                plan_cross_fragment_filters,
            )
            cdf = plan_cross_fragment_filters(fplan)
            if cdf.build_fragment:
                df_service, cross_df = DynamicFilterService(), cdf
                for df_id, fid in cdf.build_fragment.items():
                    df_service.expect(
                        df_id, self._task_count(fplan.fragments[fid]))

        dctx = DriverContext(session=session, device=self.device)
        reports: List[dict] = []
        result = None

        def spawn(fid: int) -> List[List[Driver]]:
            """One driver list per task of fragment `fid`, in pipeline
            order."""
            nonlocal result
            fragment = fplan.fragments[fid]
            n_tasks = self._task_count(fragment)
            sinks = [exchanges[e.exchange_id]
                     for e in fplan.producer_edges(fid)]
            tasks = []
            for t in range(n_tasks):
                planner = LocalExecutionPlanner(
                    self.catalogs, session, self.device,
                    task=TaskContext(index=t, count=n_tasks,
                                     exchanges=exchanges,
                                     df_service=df_service,
                                     cross_df=cross_df))
                try:
                    if fid == fplan.root_id:
                        lplan = planner.plan(fragment.root)
                        pipelines, result = lplan.pipelines, lplan
                    else:
                        pipelines = planner.plan_fragment(fragment.root,
                                                          sinks)
                except LocalPlanningError as e:
                    raise QueryError(str(e)) from e
                if t == 0 and planner.fusion_report is not None:
                    reports.append(planner.fusion_report)
                tasks.append([Driver([f.create(dctx) for f in pipe])
                              for pipe in pipelines])
            return tasks

        phase_deps: Dict[int, List[int]] = {fid: []
                                            for fid in fplan.fragments}
        if bool(get_property(session.properties, "phased_execution")):
            from presto_tpu_torch.planner.exchanges import plan_phases
            phase_deps = plan_phases(fplan)
        tasks_of: Dict[int, List[List[Driver]]] = {}
        for fid in fplan.fragments:
            if not phase_deps[fid]:
                tasks_of[fid] = spawn(fid)
        try:
            self._drive(tasks_of, phase_deps, spawn)
            run_deferred_checks(dctx)
        finally:
            for tasks in tasks_of.values():
                for drivers in tasks:
                    for d in drivers:
                        d.close()
        out = MaterializedResult(result.result_names, result.result_sink,
                                 result.result_fields)
        out.fusion_report = _merge_reports(reports) if reports else None
        return out

    @staticmethod
    def _drive(tasks_of: Dict[int, List[List[Driver]]],
               phase_deps: Dict[int, List[int]], spawn) -> None:
        """`drive_drivers` over every fragment's tasks; a deferred
        fragment spawns once the fragments it waits for finished."""
        def complete(fid: int) -> bool:
            return fid in tasks_of and all(
                d.is_finished() for drivers in tasks_of[fid]
                for d in drivers)

        def spawn_ready():
            waiting = [f for f in phase_deps if f not in tasks_of]
            if not waiting:
                return None
            new = []
            for fid in waiting:
                if all(complete(b) for b in phase_deps[fid]):
                    tasks_of[fid] = spawn(fid)
                    new.extend(tasks_of[fid])
            return new

        drive_drivers([t for tasks in tasks_of.values() for t in tasks],
                      spawn=spawn_ready, max_idle_rounds=MAX_IDLE_ROUNDS)

    def explain_text(self, sql: str) -> str:
        """The fragmented plan (reference: the fragment view of
        EXPLAIN)."""
        from presto_tpu_torch.planner.optimizer import optimize
        plan = optimize(self.create_plan(sql), self.catalogs,
                        session=self.session)
        prune_unused_columns(plan)
        plan = add_exchanges(plan, self.catalogs, self.session)
        return fragment_plan(plan).text()


def _merge_reports(reports: List[dict]) -> dict:
    """One fusion report for the query: every fragment's (task 0's)."""
    entries = [e for r in reports for e in r.get("fragments", [])]
    fallback: Dict[str, int] = {}
    for e in entries:
        if e["fused"] is None:
            r = e["reason"] or "?"
            fallback[r] = fallback.get(r, 0) + 1
    return {"fragments": entries,
            "fused": sum(1 for e in entries if e["fused"] is not None),
            "fallback": fallback}
