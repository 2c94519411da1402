"""Single-process SQL runner (reference: presto_tpu/runner/local.py;
testing/LocalQueryRunner.java:236).

`LocalRunner(catalog, schema, properties, device).execute(sql)` parses,
analyzes, optimizes and plans the statement, drives its pipeline on
`device` and returns a `MaterializedResult`. The device defaults to
CUDA and the runner refuses to start without it: it never falls back
to the CPU on its own. Pass `device="cpu"` to run the plain versions
of the kernels on the CPU (the tests do).

The port runs queries and SET SESSION. A query whose grouping outgrew
`max_groups` (GroupLimitExceeded) or whose join outgrew its output
capacity (JoinCapacityExceeded, read once after the drive) is re-run
with four times the setting, as the reference's runner does. Caches,
query history, resource groups, fault injection, sanitizers,
telemetry, EXPLAIN and DDL/DML come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.connectors.spi import Connector, TableHandle
from presto_tpu_torch.operators.aggregation import GroupLimitExceeded
from presto_tpu_torch.operators.base import (
    DriverContext, run_deferred_checks,
)
from presto_tpu_torch.operators.driver import Driver
from presto_tpu_torch.operators.join_ops import JoinCapacityExceeded
from presto_tpu_torch.parser import parse_statement, tree as T
from presto_tpu_torch.planner import nodes as N
from presto_tpu_torch.planner.analyzer import AnalysisError, plan_statement
from presto_tpu_torch.planner.local_planner import (
    LocalExecutionPlanner, LocalPlanningError,
)
from presto_tpu_torch.schema import RelationSchema


class QueryError(Exception):
    """A query failed (analysis, planning or execution)."""


@dataclasses.dataclass
class Session:
    catalog: str = "tpch"
    schema: str = "tiny"
    properties: Dict[str, Any] = dataclasses.field(default_factory=dict)


class CatalogManager:
    """Reference: metadata/CatalogManager + MetadataManager.java:124."""

    def __init__(self):
        self._connectors: Dict[str, Connector] = {}

    def register(self, name: str, connector: Connector) -> None:
        self._connectors[name] = connector

    def connector(self, name: str) -> Connector:
        if name not in self._connectors:
            raise QueryError(f"catalog {name!r} does not exist")
        return self._connectors[name]

    def catalogs(self) -> List[str]:
        return sorted(self._connectors)

    @staticmethod
    def handle_for(parts: Tuple[str, ...],
                   session: Session) -> TableHandle:
        """Qualified name -> TableHandle with session defaults."""
        if len(parts) == 1:
            return TableHandle(session.catalog, session.schema, parts[0])
        if len(parts) == 2:
            return TableHandle(session.catalog, parts[0], parts[1])
        if len(parts) == 3:
            return TableHandle(parts[0], parts[1], parts[2])
        raise QueryError(f"invalid table name {'.'.join(parts)}")

    def resolve_table(self, parts: Tuple[str, ...], session: Session
                      ) -> Tuple[TableHandle, RelationSchema]:
        handle = self.handle_for(parts, session)
        conn = self.connector(handle.catalog)
        try:
            schema = conn.metadata.get_table_schema(handle)
        except KeyError:
            raise QueryError(f"table {handle} does not exist") from None
        return handle, schema


class MaterializedResult:
    def __init__(self, names: List[str], batches: List[Batch],
                 fields: Tuple[N.Field, ...]):
        self.names = names
        self.batches = batches
        self.fields = fields
        #: the whole-fragment fusion report of the query's plan
        #: (planner/fusion.py), None when fusion was off
        self.fusion_report = None

    @property
    def row_count(self) -> int:
        return sum(b.num_valid() for b in self.batches)

    def rows(self) -> List[Tuple]:
        out: List[Tuple] = []
        for b in self.batches:
            out.extend(b.to_pylist())
        return out

    def __repr__(self):
        return f"MaterializedResult({self.row_count} rows: {self.names})"


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """The runner's device: CUDA unless the caller names another. A
    missing CUDA device is an error, never a silent move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "presto_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain CPU versions explicitly")
    return dev


class LocalRunner:
    def __init__(self, catalog: str = "tpch", schema: str = "tiny",
                 properties: Optional[Dict[str, Any]] = None,
                 device: Union[None, str, torch.device] = None):
        from presto_tpu_torch.connectors.tpcds import TpcdsConnector
        from presto_tpu_torch.connectors.tpch import TpchConnector
        self.device = resolve_device(device)
        self.catalogs = CatalogManager()
        self.catalogs.register("tpch", TpchConnector())
        self.catalogs.register("tpcds", TpcdsConnector())
        self.session = Session(catalog, schema, dict(properties or {}))

    def execute(self, sql: str) -> MaterializedResult:
        stmt = parse_statement(sql)
        if isinstance(stmt, T.SetSession):
            return self._set_session(stmt)
        if not isinstance(stmt, T.Query):
            raise QueryError(
                f"unsupported statement {type(stmt).__name__} "
                "(this slice of the port runs queries and SET SESSION)")
        return self._run_plan(self._plan_query(stmt))

    def create_plan(self, sql: str) -> N.OutputNode:
        """The analyzed (not yet optimized) plan of a query."""
        stmt = parse_statement(sql)
        if not isinstance(stmt, T.Query):
            raise QueryError("create_plan expects a query")
        return plan_statement(stmt, self.catalogs, self.session)

    def _plan_query(self, stmt: T.Query) -> N.OutputNode:
        try:
            plan = plan_statement(stmt, self.catalogs, self.session)
        except AnalysisError as e:
            raise QueryError(str(e)) from e
        from presto_tpu_torch.planner.optimizer import optimize
        from presto_tpu_torch.planner.validation import validate
        validate(plan, "analysis", session=self.session)
        plan = optimize(plan, self.catalogs, session=self.session)
        validate(plan, "optimizer", session=self.session)
        return plan

    def _run_plan(self, plan: N.OutputNode) -> MaterializedResult:
        """Plan and drive the query; on a group-table or join-capacity
        overflow re-run it with the setting raised 4x (a query-level
        retry keeps the per-batch hot loop free of host reads)."""
        session = self.session
        while True:
            try:
                planner = LocalExecutionPlanner(self.catalogs, session,
                                                self.device)
                lplan = planner.plan(plan)
            except LocalPlanningError as e:
                raise QueryError(str(e)) from e
            dctx = DriverContext(session=session, device=self.device)
            try:
                # pipelines in list order: every join build before the
                # pipeline holding its probe
                for pipe in lplan.pipelines:
                    Driver([f.create(dctx) for f in pipe]) \
                        .run_to_completion()
                run_deferred_checks(dctx)
            except GroupLimitExceeded as e:
                if e.suggested > 1 << 26:
                    raise QueryError(
                        "group-by exceeds max supported groups") from e
                session = dataclasses.replace(session, properties={
                    **session.properties, "max_groups": e.suggested})
                continue
            except JoinCapacityExceeded as e:
                if e.suggested > 1 << 10:
                    raise QueryError(
                        "join expansion exceeds supported factor") from e
                session = dataclasses.replace(session, properties={
                    **session.properties,
                    "join_expansion_factor": e.suggested})
                continue
            result = MaterializedResult(lplan.result_names,
                                        lplan.result_sink,
                                        lplan.result_fields)
            result.fusion_report = planner.fusion_report
            return result

    def _set_session(self, stmt: T.SetSession) -> MaterializedResult:
        from presto_tpu_torch.expr.ir import Literal
        from presto_tpu_torch.planner.analyzer import (
            PlannerContext, Scope, _Analyzer,
        )
        from presto_tpu_torch.session_properties import validate_set
        an = _Analyzer(Scope([]), PlannerContext(self.catalogs,
                                                  self.session))
        e = an.analyze(stmt.value)
        if not isinstance(e, Literal):
            raise QueryError("SET SESSION value must be a constant")
        try:
            value = validate_set(stmt.name, e.value)
        except ValueError as err:
            raise QueryError(str(err)) from None
        self.session.properties[stmt.name] = value
        from presto_tpu_torch.types import VARCHAR
        b = Batch.from_pydict({"result": (["SET SESSION"], VARCHAR)})
        return MaterializedResult(["result"], [b],
                                  (N.Field("result", VARCHAR),))
