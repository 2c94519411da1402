"""Single-process SQL runner (reference: presto_tpu/runner/local.py;
testing/LocalQueryRunner.java:236).

`LocalRunner(catalog, schema, properties, device).execute(sql)` parses,
analyzes, optimizes and plans the statement, drives its pipeline on
`device` and returns a `MaterializedResult`. The device defaults to
CUDA and the runner refuses to start without it: it never falls back
to the CPU on its own. Pass `device="cpu"` to run the plain versions
of the kernels on the CPU (the tests do).

The port runs queries, SET SESSION, and CREATE TABLE AS / INSERT INTO
/ DROP TABLE on the `memory` catalog (and the `blackhole` sink). A
query whose grouping outgrew `max_groups` (GroupLimitExceeded) or whose
join outgrew its output capacity (JoinCapacityExceeded, read once after
the drive) is re-run with four times the setting, as the reference's
runner does; a collection past `array_agg_width`
(ArrayAggWidthExceeded) re-plans the statement at four times the width,
with the runner's own session left as it was. Array, map and row
columns come back from `rows()` as Python lists, dicts and tuples.
Caches, query history, resource groups, fault injection, sanitizers,
telemetry, EXPLAIN and the other statements come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.connectors.spi import Connector, TableHandle
from presto_tpu_torch.operators.aggregation import GroupLimitExceeded
from presto_tpu_torch.operators.array_agg import ArrayAggWidthExceeded
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
from presto_tpu_torch.schema import ColumnSchema, RelationSchema


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


def _rename_form_slots(form, plan_sym: str, stored_name: str):
    """A plan symbol's value form rebuilt over STORED column names (the
    `<stored_name>__suffix` convention): (stored form, {stored name ->
    plan slot symbol}) (reference: presto_tpu/runner/local.py:147)."""
    from presto_tpu_torch.expr.ir import ArrayValue, InputRef, MapValue
    src_map: Dict[str, Optional[str]] = {}

    def ren(x):
        if not isinstance(x, InputRef) \
                or not x.name.startswith(plan_sym + "__"):
            raise QueryError("cannot write a complex column whose form "
                             "is not slot-backed")
        stored = stored_name + x.name[len(plan_sym):]
        src_map[stored] = x.name
        return InputRef(stored, x.type)

    length = None if form.length is None else ren(form.length)
    if isinstance(form, ArrayValue):
        out = ArrayValue(tuple(ren(e) for e in form.elements), length,
                         form.type)
    elif isinstance(form, MapValue):
        out = MapValue(tuple(ren(e) for e in form.keys),
                       tuple(ren(e) for e in form.values), length,
                       form.type)
    else:
        raise QueryError("cannot write row-typed columns yet")
    return out, src_map


def _assemble_form(form, cols: Dict[str, list], nrows: int) -> list:
    """Per-row Python values of a complex field from its slot columns'
    lists (reference: presto_tpu/runner/local.py:233). Leaves are
    InputRefs into `cols` or Literals."""
    from presto_tpu_torch.expr.ir import (
        ArrayValue, InputRef, Literal, MapValue, RowValue,
    )

    def leaf(e) -> list:
        if isinstance(e, InputRef):
            return cols[e.name]
        if isinstance(e, Literal):
            return [e.value] * nrows
        raise QueryError("complex output columns must be slot references "
                         f"(got {type(e).__name__})")

    if isinstance(form, RowValue):
        fc = [leaf(x) for _, x in form.fields]
        return [tuple(c[i] for c in fc) for i in range(nrows)]
    if isinstance(form, ArrayValue):
        parts = [[leaf(x) for x in form.elements]]
    elif isinstance(form, MapValue):
        parts = [[leaf(x) for x in form.keys],
                 [leaf(x) for x in form.values]]
    else:
        raise QueryError(f"unsupported output form {type(form).__name__}")
    lens = leaf(form.length) if form.length is not None \
        else [len(parts[0])] * nrows
    out = []
    for i in range(nrows):
        if lens[i] is None:
            out.append(None)
            continue
        k = int(lens[i])
        if len(parts) == 1:
            out.append([c[i] for c in parts[0][:k]])
        else:
            out.append({kc[i]: vc[i] for kc, vc in
                        zip(parts[0][:k], parts[1][:k])})
    return out


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
        forms = [getattr(f, "form", None) for f in self.fields or ()]
        out: List[Tuple] = []
        if not any(f is not None for f in forms):
            for b in self.batches:
                out.extend(b.to_pylist())
            return out
        # complex-typed outputs: Python values assembled from their
        # slot columns (see nodes.Field.form)
        for b in self.batches:
            cols = b.to_pydict()
            nrows = len(next(iter(cols.values()))) if cols else 0
            out.extend(zip(*[
                cols[f.symbol] if form is None
                else _assemble_form(form, cols, nrows)
                for f, form in zip(self.fields, forms)]))
        return out

    def to_pandas(self):
        import pandas as pd
        return pd.DataFrame(self.rows(), columns=self.names)

    def __repr__(self):
        return f"MaterializedResult({self.row_count} rows: {self.names})"


def _text_result(name: str, lines: List[str]) -> MaterializedResult:
    from presto_tpu_torch.types import VARCHAR
    b = Batch.from_pydict({name: (lines, VARCHAR)})
    return MaterializedResult([name], [b], (N.Field(name, VARCHAR),))


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
        from presto_tpu_torch.connectors.memory import (
            BlackholeConnector, MemoryConnector,
        )
        from presto_tpu_torch.connectors.tpcds import TpcdsConnector
        from presto_tpu_torch.connectors.tpch import TpchConnector
        self.device = resolve_device(device)
        self.catalogs = CatalogManager()
        self.catalogs.register("tpch", TpchConnector())
        self.catalogs.register("tpcds", TpcdsConnector())
        self.catalogs.register("memory", MemoryConnector())
        self.catalogs.register("blackhole", BlackholeConnector())
        self.session = Session(catalog, schema, dict(properties or {}))
        #: the session of a statement re-planned at a larger
        #: array_agg_width (`_with_width_retry`); None otherwise
        self._override: Optional[Session] = None

    @property
    def session(self) -> Session:
        """The session a statement plans with: the width retry's
        override while one is active, else the runner's own."""
        return self._override if self._override is not None \
            else self._session

    @session.setter
    def session(self, value: Session) -> None:
        self._session = value

    def execute(self, sql: str) -> MaterializedResult:
        stmt = parse_statement(sql)
        if isinstance(stmt, T.SetSession):
            return self._set_session(stmt)
        if isinstance(stmt, T.CreateTableAs):
            return self._with_width_retry(
                lambda: self._create_table_as(stmt))
        if isinstance(stmt, T.InsertInto):
            return self._with_width_retry(lambda: self._insert_into(stmt))
        if isinstance(stmt, T.DropTable):
            return self._drop_table(stmt)
        if not isinstance(stmt, T.Query):
            raise QueryError(
                f"unsupported statement {type(stmt).__name__} (this slice "
                "of the port runs queries, SET SESSION, CREATE TABLE AS, "
                "INSERT and DROP TABLE)")
        return self._with_width_retry(
            lambda: self._run_plan(self._plan_query(stmt)))

    def _with_width_retry(self, fn):
        """Run `fn` (which plans and runs one statement); on
        ArrayAggWidthExceeded re-run it with array_agg_width x4 in an
        override session (reference: presto_tpu/runner/local.py:500).
        The width is fixed in the plan's value forms at analysis time,
        so the retry re-plans; the runner's own session is untouched."""
        try:
            while True:
                try:
                    return fn()
                except ArrayAggWidthExceeded as e:
                    if e.suggested > 1 << 14:
                        raise QueryError("array_agg exceeds the supported "
                                         "element count") from e
                    self._override = dataclasses.replace(
                        self.session, properties={
                            **self.session.properties,
                            "array_agg_width": e.suggested})
        finally:
            self._override = None

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

    def _run_plan(self, plan: N.OutputNode,
                  on_retry=None) -> MaterializedResult:
        """Plan and drive the query; on a group-table or join-capacity
        overflow re-run it with the setting raised 4x (a query-level
        retry keeps the per-batch hot loop free of host reads).
        `on_retry` runs before each re-run (a write drops its
        uncommitted appends)."""
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
            except JoinCapacityExceeded as e:
                if e.suggested > 1 << 10:
                    raise QueryError(
                        "join expansion exceeds supported factor") from e
                session = dataclasses.replace(session, properties={
                    **session.properties,
                    "join_expansion_factor": e.suggested})
            else:
                result = MaterializedResult(lplan.result_names,
                                            lplan.result_sink,
                                            lplan.result_fields)
                result.fusion_report = planner.fusion_report
                return result
            if on_retry is not None:
                on_retry()

    # -- DDL / DML (reference: presto_tpu/runner/local.py:1575-1770) ------

    def _handle_for(self, parts: Tuple[str, ...]) -> TableHandle:
        return CatalogManager.handle_for(parts, self.session)

    def _sink_for(self, handle: TableHandle):
        sink = self.catalogs.connector(handle.catalog).page_sink
        if sink is None:
            raise QueryError(
                f"catalog {handle.catalog!r} does not support writes")
        return sink

    def _table_exists(self, handle: TableHandle) -> bool:
        try:
            self.catalogs.connector(handle.catalog).metadata \
                .get_table_schema(handle)
            return True
        except KeyError:
            return False

    def _run_write(self, qplan: N.OutputNode, handle, sink,
                   schema: RelationSchema,
                   column_sources: Dict[str, Optional[str]]) -> int:
        """Wrap a SELECT plan with TableWriter -> TableFinish and run it.
        The commit (`sink.finish`) happens only after the drive and its
        deferred overflow checks passed; an overflow re-run, or a
        failure, drops the uncommitted appends first."""
        from presto_tpu_torch.types import BIGINT
        schema_cols = [p for c in schema.columns for p in c.physical()]
        wsym, fsym = "__write_rows__", "__commit_rows__"
        writer = N.TableWriterNode(qplan.source, handle,
                                   dict(column_sources), schema_cols,
                                   (N.Field(wsym, BIGINT),))
        finish = N.TableFinishNode(writer, handle,
                                   (N.Field(fsym, BIGINT),))
        out = N.OutputNode(finish, ["rows"], [fsym], finish.output)
        try:
            result = self._run_plan(out, on_retry=lambda: sink.abort(handle))
        except Exception:
            sink.abort(handle)
            raise
        n = int(result.rows()[0][0])
        sink.finish(handle)   # the commit point
        return n

    def _create_table_as(self, stmt: T.CreateTableAs) -> MaterializedResult:
        handle = self._handle_for(stmt.name)
        sink = self._sink_for(handle)
        if self._table_exists(handle):
            if stmt.if_not_exists:
                return _text_result("result", ["CREATE TABLE skipped"])
            raise QueryError(f"table {handle} already exists")
        qplan = self._plan_query(stmt.query)
        if len(set(qplan.names)) != len(qplan.names):
            raise QueryError("CREATE TABLE AS query has duplicate column "
                             "names; alias them")
        fields = [next(f for f in qplan.output if f.symbol == s)
                  for s in qplan.source_symbols]
        cols = []
        column_sources: Dict[str, Optional[str]] = {}
        for name, f in zip(qplan.names, fields):
            form = getattr(f, "form", None)
            if form is None:
                cols.append(ColumnSchema(name, f.type, f.dictionary))
                column_sources[name] = f.symbol
                continue
            # a complex column is stored as its slot columns under
            # <name>__a{j} / <name>__len, with the stored-name form
            stored, src_map = _rename_form_slots(form, f.symbol, name)
            cols.append(ColumnSchema(name, f.type, f.dictionary,
                                     form=stored))
            column_sources.update(src_map)
        schema = RelationSchema(cols)
        sink.create_table(handle, schema, dict(stmt.properties or {}))
        try:
            n = self._run_write(qplan, handle, sink, schema,
                                column_sources)
        except Exception:
            # the width retry re-runs the whole CTAS (the stored forms
            # depend on the width): un-create first
            sink.drop_table(handle)
            raise
        return _text_result("result", [f"CREATE TABLE: {n} rows"])

    def _insert_into(self, stmt: T.InsertInto) -> MaterializedResult:
        handle = self._handle_for(stmt.name)
        sink = self._sink_for(handle)
        conn = self.catalogs.connector(handle.catalog)
        try:
            schema = conn.metadata.get_table_schema(handle)
        except KeyError:
            raise QueryError(f"table {handle} does not exist") from None
        target_cols = stmt.columns or [c.name for c in schema.columns]
        unknown = [c for c in target_cols
                   if c not in {cs.name for cs in schema.columns}]
        if unknown:
            raise QueryError(f"INSERT target column(s) {unknown} do not "
                             f"exist in {handle}")
        if len(set(target_cols)) != len(target_cols):
            raise QueryError("INSERT target columns must be distinct")
        qplan = self._plan_query(stmt.query)
        fields = [next(f for f in qplan.output if f.symbol == s)
                  for s in qplan.source_symbols]
        if len(fields) != len(target_cols):
            raise QueryError(f"INSERT has {len(fields)} columns but "
                             f"{len(target_cols)} targets")
        # INSERT matches by position: target column name -> source field
        by_target = dict(zip(target_cols, fields))
        column_sources: Dict[str, Optional[str]] = {}
        for cs in schema.columns:
            ft = by_target.get(cs.name)
            if ft is None:
                for pname, _t, _d in cs.physical():
                    column_sources[pname] = None
                continue
            if ft.type.name != cs.type.name:
                raise QueryError(
                    f"INSERT type mismatch on {cs.name}: "
                    f"{ft.type.display()} vs {cs.type.display()}")
            if cs.form is None:
                column_sources[cs.name] = ft.symbol
                continue
            # a complex target: each stored slot from the source's slot
            # (the stored width is fixed)
            sform = getattr(ft, "form", None)
            if sform is None:
                raise QueryError(f"INSERT into complex column {cs.name} "
                                 "requires a matching array/map value")
            stored = [p[0] for p in cs.physical()]
            src_slots = N.form_slot_symbols(sform)
            if len(stored) != len(src_slots):
                raise QueryError(
                    f"INSERT into {cs.name}: stored element capacity "
                    f"{len(stored)} != query value's {len(src_slots)} "
                    "(set array_agg_width to the table's width)")
            column_sources.update(zip(stored, src_slots))
        n = self._run_write(qplan, handle, sink, schema, column_sources)
        return _text_result("result", [f"INSERT: {n} rows"])

    def _drop_table(self, stmt: T.DropTable) -> MaterializedResult:
        handle = self._handle_for(stmt.name)
        sink = self._sink_for(handle)
        if not self._table_exists(handle):
            if stmt.if_exists:
                return _text_result("result", ["DROP skipped"])
            raise QueryError(f"table {handle} does not exist")
        sink.drop_table(handle)
        return _text_result("result", ["DROP TABLE"])

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
        return _text_result("result", ["SET SESSION"])
