"""Local execution planner: PlanNode tree -> operator pipelines
(reference: presto_tpu/planner/local_planner.py;
sql/planner/LocalExecutionPlanner.java:549).

The port plans TableScan, Values, Filter, Project, Aggregation
(direct slot-table, streaming and sort-based paths), inner/left/right/
full hash Join (a right join becomes a flipped left join), the cross
join (nested loop), SemiJoin (IN, EXISTS, NOT IN), Window,
TopNRowNumber (a window plus a `rank <= N` filter), GroupId (grouping
sets), Sort, TopN, Limit, Distinct, Union (through a local queue),
EnforceSingleRow, AssignUniqueId, Unnest, the array_agg / map_agg
collection (operators/array_agg.py), TableWriter / TableFinish and
Output. An array, map or row column travels as scalar slot columns
(`Field.form`; `_schema_of`). A join spawns a build
pipeline that runs before the pipeline holding its probe, as in the reference; inner joins
and IN/EXISTS semi joins also wire dynamic filters from the build keys
to probe-side scans. A subtree with several plan parents is planned
once into a spool that each parent replays, and no dynamic filter
lands on a scan inside it. Every other node raises
`LocalPlanningError` naming the ROADMAP item that ports it.

A FilterProject that directly follows a lookup join is fused into the
probe (`_append_filter_project`, whatever the session says, as in the
reference). After every visitor, the whole-fragment fusion pass
(planner/fusion.py) folds each run of adjacent FilterProjects into the
operator that consumes it, gated by `fragment_fusion_enabled` (default
on); its report is `fusion_report`, and `node_ops` / `id_remap` map
plan nodes onto the operators that survived it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from presto_tpu_torch.batch import Batch, Column, bucket_capacity
from presto_tpu_torch.expr.compile import CompiledExpr, compile_expression
from presto_tpu_torch.expr.ir import InputRef, RowExpression, SpecialForm, walk
from presto_tpu_torch.operators.aggregation import (
    AggregationOperatorFactory, AggSpec, StreamingAggregationOperatorFactory,
    _direct_domains,
)
from presto_tpu_torch.operators.core import (
    FilterProjectOperatorFactory, LimitOperatorFactory,
    OutputCollectorOperatorFactory, TableScanOperatorFactory,
    ValuesOperatorFactory,
)
from presto_tpu_torch.operators import misc_ops
from presto_tpu_torch.operators.join_ops import (
    HashBuildOperatorFactory, JoinBridge, LookupJoinOperatorFactory,
    SemiJoinOperatorFactory,
)
from presto_tpu_torch.operators.sort_ops import (
    DistinctOperatorFactory, OrderByOperatorFactory, TopNOperatorFactory,
)
from presto_tpu_torch.ops import common, hashagg
from presto_tpu_torch.planner import nodes as N
from presto_tpu_torch.schema import ColumnSchema
from presto_tpu_torch.session_properties import get_property
from presto_tpu_torch.types import DOUBLE, Type


@dataclasses.dataclass
class LocalExecutionPlan:
    pipelines: List[List]              # of OperatorFactory
    result_sink: List[Batch]
    result_names: List[str]
    result_fields: Tuple[N.Field, ...]


class LocalPlanningError(Exception):
    pass


#: plan nodes of later slices -> the ROADMAP item that ports them
_LATER = {
    "MergeNode": "A12 (merge, made by the exchange planner)",
    "RemoteSourceNode": "A12 (distributed path)",
    "ExchangeNode": "A12 (distributed path)",
}


def _schema_dicts(schema: Dict[str, ColumnSchema]
                  ) -> Tuple[Tuple[str, tuple], ...]:
    """Hashable (name, dictionary) token of a compile schema's
    dict-encoded columns — part of the chain-kernel cache key, because
    compiled expressions bake input dictionaries into lookup tables."""
    return tuple(sorted((n, cs.dictionary) for n, cs in schema.items()
                        if cs.dictionary is not None))


def _schema_of(node: N.PlanNode) -> Dict[str, ColumnSchema]:
    """Compile schema of a node's output. A complex-typed field (array,
    map, row: `Field.form`) has no column of its own and exposes its
    SLOT columns instead (reference:
    presto_tpu/planner/local_planner.py:88-109)."""
    out = {}
    for f in node.output:
        form = getattr(f, "form", None)
        if form is None:
            out[f.symbol] = ColumnSchema(f.symbol, f.type, f.dictionary)
            continue
        form_dicts = getattr(f, "form_dicts", None) or {}
        leaf_types = {x.name: x.type for x in N.form_leaves(form)
                      if isinstance(x, InputRef)}
        for leaf_sym in N.form_slot_symbols(form):
            t = leaf_types.get(leaf_sym, f.type)
            dic = form_dicts.get(leaf_sym) if t.is_string else None
            if dic is None and t.is_string:
                dic = f.dictionary
            out[leaf_sym] = ColumnSchema(leaf_sym, t, dic)
    return out


class LocalExecutionPlanner:
    def __init__(self, catalog_manager, session, device: torch.device):
        self.catalogs = catalog_manager
        self.session = session
        self.device = device
        self._pipelines: List[List] = []
        self._op_id = 0
        # dynamic filtering: per-plan registry + scan-node id ->
        # [(scan symbol, df_id, registry)] found while planning joins
        from presto_tpu_torch.execution.dynamic_filters import (
            DynamicFilterRegistry,
        )
        self._df_registry = DynamicFilterRegistry()
        self._df_scans: Dict[int, List] = {}
        self._stats = None
        #: plan nodes with several parents, each planned once into a
        #: spool (node id -> Spool)
        self._shared: set = set()
        self._spools: Dict[int, misc_ops.Spool] = {}
        #: plan-node id() -> operator ids minted while that node was
        #: being dispatched (rewritten by the fusion pass onto the
        #: operators that survive it)
        self.node_ops: Dict[int, List[int]] = {}
        #: node -> operator ids before the fusion pass remapped them
        self.node_ops_prefusion: Dict[int, List[int]] = {}
        self._node_stack: List[int] = []
        #: whole-fragment fusion report (planner/fusion.py); None when
        #: the pass is disabled
        self.fusion_report = None

    def _next_id(self) -> int:
        self._op_id += 1
        if self._node_stack:
            self.node_ops.setdefault(
                self._node_stack[-1], []).append(self._op_id)
        return self._op_id

    def _compile(self, expr: RowExpression,
                 schema: Dict[str, ColumnSchema]) -> CompiledExpr:
        return compile_expression(expr, schema, self.device)

    def plan(self, root: N.OutputNode) -> LocalExecutionPlan:
        prune_unused_columns(root)
        from presto_tpu_torch.planner.validation import validate
        validate(root, "local_planner", session=self.session)
        self._shared = _shared_nodes(root)
        sink: List[Batch] = []
        pipeline: List = []
        self._visit(root.source, pipeline)
        # final projection to output order; a complex-typed field
        # projects its slot columns (the named symbol has no column)
        src_schema = _schema_of(root.source)
        projections = [
            (sym, self._compile(InputRef(sym, src_schema[sym].type),
                                src_schema))
            for f in root.output for sym in field_symbols(f)]
        pipeline.append(FilterProjectOperatorFactory(
            self._next_id(), None, projections, _schema_dicts(src_schema)))
        pipeline.append(OutputCollectorOperatorFactory(
            self._next_id(), sink))
        self._pipelines.append(pipeline)
        self._fuse()
        return LocalExecutionPlan(self._pipelines, sink, root.names,
                                  root.output)

    def _fuse(self) -> None:
        """Whole-fragment fusion (planner/fusion.py): collapse adjacent
        FilterProject runs into their consumer. Runs LAST — after
        spools, queues and the sink are placed — so every barrier is
        visible and falling back is keeping the unfused chain. Gated by
        the session's `fragment_fusion_enabled`."""
        self.node_ops_prefusion = {k: list(v)
                                   for k, v in self.node_ops.items()}
        from presto_tpu_torch.planner.fusion import fuse_pipelines
        if not get_property(self.session.properties,
                            "fragment_fusion_enabled"):
            return
        from presto_tpu_torch.planner import validation as _validation
        check = _validation.validation_enabled(self.session)
        snapshot = _validation.CHECKER.snapshot_pipelines(
            self._pipelines) if check else None
        # builds stay resident until the memory slice (ROADMAP A10), so
        # no probe can be handed a host-partitioned table; measured
        # selectivities come with the history slice (A11)
        self.fusion_report = fuse_pipelines(
            self._pipelines, self.node_ops, spill_enabled=False)
        if check:
            _validation.CHECKER.check_fusion(
                snapshot, self._pipelines,
                self.fusion_report.get("id_remap", {}))

    def _visit(self, node: N.PlanNode, pipe: List) -> None:
        """A node with several plan parents (a DAG) is computed once into
        a Spool and replayed to each consumer (reference:
        presto_tpu/planner/local_planner.py:318-345): the spool's
        pipeline is appended before any consumer's, so it has run by the
        time they read it."""
        nid = id(node)
        if nid in self._shared:
            spool = self._spools.get(nid)
            if spool is None:
                spool = misc_ops.Spool()
                self._spools[nid] = spool
                sp: List = []
                self._dispatch(node, sp)
                sp.append(misc_ops.spool_sink_factory(self._next_id(),
                                                      spool))
                self._pipelines.append(sp)
            pipe.append(misc_ops.spool_source_factory(self._next_id(),
                                                      spool))
            return
        self._dispatch(node, pipe)

    def _dispatch(self, node: N.PlanNode, pipe: List) -> None:
        name = type(node).__name__
        m = getattr(self, f"_visit_{name}", None)
        if m is None:
            later = _LATER.get(name)
            raise LocalPlanningError(
                f"no local planning for {name}"
                + (f": later slice of the port (ROADMAP {later})"
                   if later else ""))
        # operator ids minted while this node is on top of the stack
        # belong to it (children push their own frame)
        self._node_stack.append(id(node))
        try:
            m(node, pipe)
        finally:
            self._node_stack.pop()

    def _visit_TableScanNode(self, node: N.TableScanNode, pipe: List):
        conn = self.catalogs.connector(node.handle.catalog)
        symbols = list(node.assignments.keys())
        columns = [node.assignments[s] for s in symbols]
        rename = dict(zip(columns, symbols))
        batch_rows = int(get_property(self.session.properties,
                                      "batch_rows"))
        target_splits = int(get_property(self.session.properties,
                                         "target_splits"))
        handle = node.handle
        constraint = node.constraint
        device = self.device

        def batch_iter():
            splits = conn.split_manager.get_splits(
                handle, target_splits, constraint)
            for s in splits:
                for b in conn.page_source.batches(
                        s, columns, batch_rows, constraint, device):
                    yield b.rename(rename)
        pipe.append(TableScanOperatorFactory(
            self._next_id(), f"scan:{handle.table}", batch_iter,
            df_specs=list(self._df_scans.get(id(node), [])) or None))

    def _visit_ValuesNode(self, node: N.ValuesNode, pipe: List):
        cap = bucket_capacity(max(len(node.rows), 1))
        cols = {}
        for i, f in enumerate(node.output):
            vals = [row[i] for row in node.rows]
            if f.type.is_string:
                # rows already hold dictionary codes
                arr = np.array([v if v is not None else 0 for v in vals],
                               f.type.np_dtype)
                mask = np.array([v is not None for v in vals], bool)
                cols[f.symbol] = Column.from_numpy(
                    arr, mask, f.type, cap, f.dictionary, self.device)
            else:
                cols[f.symbol] = Column.from_pylist(vals, f.type, cap,
                                                    self.device)
        rv = torch.zeros(cap, dtype=torch.bool, device=self.device)
        rv[:len(node.rows)] = True
        pipe.append(ValuesOperatorFactory(self._next_id(),
                                          [Batch(cols, rv)]))

    def _append_filter_project(self, pipe: List, filter_expr,
                               projections, input_dicts,
                               selectivity=None,
                               sel_provenance: str = "static") -> None:
        """Append a FilterProject — or fuse it into a lookup join it
        directly follows, so its expressions run over the probe's
        output in the same operator (probe-tail fusion; whatever
        `fragment_fusion_enabled` says, as in the reference).
        `selectivity` is the estimated surviving-row fraction the
        fusion pass gates fold-terminal fusion on (None = unknown)."""
        tail = pipe[-1] if pipe else None
        if isinstance(tail, LookupJoinOperatorFactory) and not tail.fused:
            # the probe keeps the estimate: a chain it later feeds into
            # a fold terminal inherits this fraction
            tail.fuse(filter_expr, projections, input_dicts,
                      selectivity=selectivity,
                      sel_provenance=sel_provenance)
            return
        pipe.append(FilterProjectOperatorFactory(
            self._next_id(), filter_expr, projections, input_dicts,
            selectivity=selectivity, sel_provenance=sel_provenance))

    def _est_selectivity(self, node: N.FilterNode):
        """(estimated fraction of source rows surviving `node`,
        provenance), or (None, "static") when nothing can be said. The
        port has no history store yet (ROADMAP A11): every estimate is
        derived, "static"."""
        try:
            est = self._estimator()
            inner = est.estimate(node.source).rows
            if inner <= 0:
                return None, "static"
            return min(1.0, est.estimate(node).rows / inner), "static"
        except Exception:  # noqa: BLE001 — stats are advisory
            return None, "static"

    def _est_predicate_selectivity(self, source_node, predicate):
        """Estimated surviving fraction of a join's residual predicate
        over `source_node`'s rows (the join-filter analog of
        _est_selectivity)."""
        try:
            est = self._estimator()
            inner = est.estimate(source_node)
            if inner.rows <= 0:
                return None
            from presto_tpu_torch.planner.stats import (
                predicate_selectivity,
            )
            return min(1.0, max(0.0, predicate_selectivity(
                predicate, inner)))
        except Exception:  # noqa: BLE001 — stats are advisory
            return None

    def _visit_FilterNode(self, node: N.FilterNode, pipe: List):
        self._visit(node.source, pipe)
        schema = _schema_of(node.source)
        pred = self._compile(node.predicate, schema)
        projections = [
            (f.symbol, self._compile(InputRef(f.symbol, f.type), schema))
            for f in node.output]
        sel, prov = self._est_selectivity(node)
        self._append_filter_project(pipe, pred, projections,
                                    _schema_dicts(schema),
                                    selectivity=sel, sel_provenance=prov)

    def _visit_ProjectNode(self, node: N.ProjectNode, pipe: List):
        self._visit(node.source, pipe)
        schema = _schema_of(node.source)
        projections = [(sym, self._compile(e, schema))
                       for sym, e in node.assignments]
        self._append_filter_project(pipe, None, projections,
                                    _schema_dicts(schema))

    def _visit_AggregationNode(self, node: N.AggregationNode, pipe: List):
        self._visit(node.source, pipe)
        schema = _schema_of(node.source)
        key_names = [s for s, _ in node.keys]
        key_exprs = [self._compile(e, schema) for _, e in node.keys]
        collecting = [a for a in node.aggregates
                      if a.function in ("array_agg", "map_agg")]
        if collecting:
            self._plan_collect(node, collecting, schema, key_names,
                               key_exprs, pipe)
            return
        specs = []
        for a in node.aggregates:
            arg_ce = None
            if a.argument is not None:
                arg = a.argument
                if a.function in DOUBLE_INPUT_AGGS \
                        and arg.type.is_decimal:
                    arg = SpecialForm("cast", (arg,), DOUBLE)
                arg_ce = self._compile(arg, schema)
            mask_ce = self._compile(a.filter, schema) \
                if a.filter is not None else None
            t = a.input_type or (arg_ce.type if arg_ce else None)
            fn = agg_function_for(a.function, t, a.output_type, a.params)
            specs.append(AggSpec(a.out_symbol, fn, arg_ce, mask_ce))
        if node.step != "single":
            raise LocalPlanningError(
                f"{node.step} aggregation step: later slice of the port "
                "(ROADMAP A12)")
        if self._streaming_agg_eligible(node, key_exprs):
            pipe.append(StreamingAggregationOperatorFactory(
                self._next_id(), key_names, key_exprs, specs))
            return
        # stats-driven sizing: a grouping estimated past the session
        # value starts big enough instead of paying x4 retries; never
        # below the session value, which the retry protocol raises
        max_groups = int(get_property(self.session.properties,
                                      "max_groups"))
        est = self._estimated_groups(node)
        if est is not None:
            max_groups = max(max_groups, min(int(est * 2), 1 << 22))
        pipe.append(AggregationOperatorFactory(
            self._next_id(), key_names, key_exprs, specs, node.step,
            max_groups))

    def _plan_collect(self, node: N.AggregationNode, collecting,
                      schema, key_names, key_exprs, pipe: List) -> None:
        """array_agg / map_agg (reference:
        presto_tpu/planner/local_planner.py:691-725): one collecting
        operator per GROUP BY, at the session's `array_agg_width`, which
        the analyzer also fixed in the output's value forms."""
        if len(collecting) != len(node.aggregates):
            raise LocalPlanningError(
                "array_agg/map_agg cannot be combined with other "
                "aggregates in one GROUP BY yet — split the query")
        if node.step != "single":
            raise LocalPlanningError(
                f"{node.step} aggregation step: later slice of the port "
                "(ROADMAP A12)")
        from presto_tpu_torch.operators.array_agg import (
            ArrayAggOperatorFactory, CollectSpec,
        )
        cspecs = [CollectSpec(
            a.out_symbol, self._compile(a.argument, schema),
            self._compile(a.argument2, schema)
            if a.argument2 is not None else None,
            self._compile(a.filter, schema)
            if a.filter is not None else None) for a in collecting]
        width = int(get_property(self.session.properties,
                                 "array_agg_width"))
        pipe.append(ArrayAggOperatorFactory(
            self._next_id(), key_names, key_exprs, cspecs, width,
            self.device))

    def _streaming_agg_eligible(self, node: N.AggregationNode,
                                key_exprs) -> bool:
        """True when the aggregation's input arrives sorted by its group
        keys (ascending, nulls last): a sort below it, or a scan whose
        connector declares a physical sort order (reference:
        presto_tpu/planner/local_planner.py:761). The streaming
        operator then runs in O(batch) memory with no overflow retry.
        Gated by the `streaming_aggregation` session property."""
        if not node.keys or not bool(get_property(
                self.session.properties, "streaming_aggregation")):
            return False
        if _direct_domains(key_exprs) is not None:
            return False  # the slot-table path is already bounded
        if len(node.keys) > common.MAX_KEYS * common.MAX_KEY_GROUPS:
            return False  # past K8's key groups; K6 takes any number
        # group-key symbols in kernel key order (bare columns only)
        syms = []
        for _, e in node.keys:
            if not isinstance(e, InputRef):
                return False
            syms.append(e.name)
        cur = node.source
        while True:
            if isinstance(cur, N.ProjectNode):
                asg = dict(cur.assignments)
                mapped = []
                for s in syms:
                    e = asg.get(s)
                    if not isinstance(e, InputRef):
                        return False
                    mapped.append(e.name)
                syms = mapped
                cur = cur.source
            elif isinstance(cur, N.FilterNode):
                cur = cur.source
            elif isinstance(cur, (N.SortNode, N.MergeNode)):
                k = len(syms)
                if list(cur.keys[:k]) != syms:
                    return False
                return not any(cur.descending[:k]) \
                    and not any(cur.nulls_first[:k])
            elif isinstance(cur, N.TableScanNode):
                try:
                    conn = self.catalogs.connector(cur.handle.catalog)
                    order = conn.metadata.sorted_by(cur.handle)
                except Exception:
                    return False
                if not order:
                    return False
                cols = [cur.assignments.get(s) for s in syms]
                return order[:len(cols)] == cols
            else:
                return False

    def _estimator(self):
        if self._stats is None:
            from presto_tpu_torch.planner.stats import StatsEstimator
            self._stats = StatsEstimator(self.catalogs)
        return self._stats

    def _estimated_groups(self, node: N.AggregationNode):
        """Estimated distinct groups, or None when unknowable."""
        from presto_tpu_torch.planner.stats import UNKNOWN_ROWS
        est = self._estimator().estimate(node).rows
        return est if est < UNKNOWN_ROWS * 0.99 else None

    def _estimated_expansion(self, node: N.JoinNode, probe) -> int:
        """Estimated join output rows per probe row, rounded up to a
        power of two and capped at 16; 1 when stats cannot say (the
        FK->PK case). A real underestimate trips the overflow retry."""
        from presto_tpu_torch.planner.stats import UNKNOWN_ROWS
        est = self._estimator()
        out_rows = est.estimate(node).rows
        probe_rows = est.estimate(probe).rows
        if out_rows >= UNKNOWN_ROWS * 0.99 \
                or probe_rows >= UNKNOWN_ROWS * 0.99 or probe_rows <= 0:
            return 1
        ratio = out_rows / probe_rows
        factor = 1
        while factor < ratio and factor < 16:
            factor *= 2
        return factor

    def _visit_JoinNode(self, node: N.JoinNode, pipe: List):
        if node.join_type == "cross":
            self._plan_cross_join(node, pipe)
        elif node.join_type in ("inner", "left", "right", "full"):
            self._plan_hash_join(node, pipe)
        else:
            raise LocalPlanningError(
                f"{node.join_type} join not supported")
        if node.filter is not None:
            schema = _schema_of(node)
            pred = self._compile(node.filter, schema)
            projections = [
                (f.symbol, self._compile(InputRef(f.symbol, f.type),
                                         schema))
                for f in node.output]
            self._append_filter_project(
                pipe, pred, projections, _schema_dicts(schema),
                selectivity=self._est_predicate_selectivity(
                    node, node.filter))

    def _plan_cross_join(self, node: N.JoinNode, pipe: List):
        """Nested loop: the right side is materialized by a build
        pipeline, the left side streams through the cross product
        (K10)."""
        bridge = misc_ops.NestedLoopBridge()
        build_pipe: List = []
        self._visit(node.right, build_pipe)
        build_pipe.append(misc_ops.nested_loop_build_factory(
            self._next_id(), bridge,
            [(f.symbol, f.type, f.dictionary) for f in node.right.output]))
        self._pipelines.append(build_pipe)
        self._visit(node.left, pipe)
        pipe.append(misc_ops.nested_loop_join_factory(self._next_id(),
                                                      bridge))

    def _plan_hash_join(self, node: N.JoinNode, pipe: List):
        probe, build = node.left, node.right
        criteria = node.criteria
        jt = node.join_type
        if jt == "right":
            probe, build = build, probe
            criteria = [(r, l) for l, r in criteria]
            jt = "left"
        bridge = JoinBridge()
        key_dicts = _unified_key_dicts(probe, build, criteria)
        df_publish = self._plan_dynamic_filters(probe, build, criteria) \
            if jt == "inner" else None
        build_pipe: List = []
        self._visit(build, build_pipe)
        build_pipe.append(HashBuildOperatorFactory(
            self._next_id(), bridge, [r for _, r in criteria], key_dicts,
            schema_cols=[(f.symbol, f.type, f.dictionary)
                         for f in build.output],
            df_publish=df_publish))
        # the build pipeline runs before the one holding the probe
        self._pipelines.append(build_pipe)
        self._visit(probe, pipe)
        # stats-seeded output capacity; never below the session value,
        # which the overflow retry raises
        factor = max(int(get_property(self.session.properties,
                                      "join_expansion_factor")),
                     self._estimated_expansion(node, probe))
        pipe.append(LookupJoinOperatorFactory(
            self._next_id(), bridge, [l for l, _ in criteria], jt,
            probe_output=[f.symbol for f in probe.output],
            build_output=[f.symbol for f in build.output],
            build_keys=[r for _, r in criteria], key_dicts=key_dicts,
            expansion_factor=factor,
            probe_schema=[(f.symbol, f.type, f.dictionary)
                          for f in probe.output] if jt == "full" else None))

    def _plan_dynamic_filters(self, probe, build, criteria):
        """For an INNER join, wire build-key bounds (and distinct sets)
        to the probe-side scans that produce the probe keys."""
        if not bool(get_property(self.session.properties,
                                 "dynamic_filtering")):
            return None
        build_fields = {f.symbol: f for f in build.output}
        publish = []
        for l, r in criteria:
            bf = build_fields.get(r)
            # numeric and date keys only (not strings, not booleans)
            if bf is None or bf.dictionary is not None \
                    or bf.type.name == "boolean":
                continue
            traced = _trace_scan_column(probe, l, self._shared)
            if traced is None:
                continue
            scan_node, scan_sym = traced
            df_id = self._df_registry.new_id()
            publish.append((r, df_id, self._df_registry))
            self._df_scans.setdefault(id(scan_node), []).append(
                (scan_sym, df_id, self._df_registry))
        return publish or None

    def _visit_SemiJoinNode(self, node: N.SemiJoinNode, pipe: List):
        """The filtering side builds, the source side probes with K7's
        mark. IN/EXISTS keep only source rows whose key the build holds,
        the pruning contract of an inner join, so the build publishes
        dynamic filters too; NOT IN must not (pruning would drop exactly
        the rows it keeps). The reference's cross-fragment filters
        (`_cross_df_publish`) belong to the distributed path (A12)."""
        bridge = JoinBridge()
        criteria = [(node.source_key, node.filtering_key)]
        key_dicts = _unified_key_dicts(node.source, node.filtering_source,
                                       criteria)
        df_publish = None if node.negate else self._plan_dynamic_filters(
            node.source, node.filtering_source, criteria)
        build_pipe: List = []
        self._visit(node.filtering_source, build_pipe)
        build_pipe.append(HashBuildOperatorFactory(
            self._next_id(), bridge, [node.filtering_key], key_dicts,
            schema_cols=[(f.symbol, f.type, f.dictionary)
                         for f in node.filtering_source.output],
            df_publish=df_publish))
        self._pipelines.append(build_pipe)
        self._visit(node.source, pipe)
        pipe.append(SemiJoinOperatorFactory(
            self._next_id(), bridge, [node.source_key], node.negate,
            build_keys=[node.filtering_key], key_dicts=key_dicts))

    def _visit_TopNRowNumberNode(self, node: N.TopNRowNumberNode,
                                 pipe: List):
        """Window (single rank call) + a `rank <= N` FilterProject."""
        from presto_tpu_torch.expr.ir import Call, Literal
        from presto_tpu_torch.operators.window_ops import (
            WindowOperatorFactory,
        )
        from presto_tpu_torch.ops.window import WindowCallSpec
        from presto_tpu_torch.types import BIGINT, BOOLEAN
        self._visit(node.source, pipe)
        pipe.append(WindowOperatorFactory(
            self._next_id(), node.partition_by, node.order_by,
            node.descending, node.nulls_first,
            [WindowCallSpec(node.row_number_symbol, node.function,
                            None, "FULL", BIGINT, None, 1)]))
        schema = {f.symbol: ColumnSchema(f.symbol, f.type, f.dictionary)
                  for f in node.source.output}
        schema[node.row_number_symbol] = ColumnSchema(
            node.row_number_symbol, BIGINT, None)
        pred = self._compile(
            Call("less_than_or_equal",
                 (InputRef(node.row_number_symbol, BIGINT),
                  Literal(node.max_rank, BIGINT)), BOOLEAN), schema)
        projections = [
            (f.symbol, self._compile(InputRef(f.symbol, f.type), schema))
            for f in node.output]
        pipe.append(FilterProjectOperatorFactory(
            self._next_id(), pred, projections, _schema_dicts(schema)))

    def _visit_WindowNode(self, node: N.WindowNode, pipe: List):
        from presto_tpu_torch.operators.window_ops import (
            WindowOperatorFactory,
        )
        from presto_tpu_torch.ops.window import WindowCallSpec
        self._visit(node.source, pipe)
        out_fields = {f.symbol: f for f in node.output}
        calls = []
        for c in node.calls:
            out_dict = None
            default = c.default
            if c.argument is not None and c.output_type is not None \
                    and c.output_type.is_string:
                # the call's OUTPUT field carries the (possibly
                # default-extended) dictionary the analyzer chose
                out_dict = out_fields[c.out_symbol].dictionary
                if isinstance(default, str) and out_dict is not None:
                    default = out_dict.index(default)
            calls.append(WindowCallSpec(
                c.out_symbol, c.function, c.argument, c.frame,
                c.output_type, out_dict, c.offset,
                fstart=c.frame_start, fend=c.frame_end,
                filter_arg=c.filter, default=default))
        pipe.append(WindowOperatorFactory(
            self._next_id(), node.partition_by, node.order_by,
            node.descending, node.nulls_first, calls))

    def _visit_UnnestNode(self, node: N.UnnestNode, pipe: List):
        self._visit(node.source, pipe)
        out_dicts = {s: node.field(s).dictionary for s, _, _ in node.items}
        pipe.append(misc_ops.UnnestOperatorFactory(
            self._next_id(), node.items, node.ordinality_symbol,
            out_dicts))

    def _visit_TableWriterNode(self, node: N.TableWriterNode, pipe: List):
        from presto_tpu_torch.operators.write_ops import (
            TableWriterOperatorFactory,
        )
        self._visit(node.source, pipe)
        conn = self.catalogs.connector(node.handle.catalog)
        pipe.append(TableWriterOperatorFactory(
            self._next_id(), conn.page_sink, node.handle,
            node.column_sources, node.schema_cols,
            node.output[0].symbol))

    def _visit_TableFinishNode(self, node: N.TableFinishNode, pipe: List):
        from presto_tpu_torch.operators.write_ops import (
            TableFinishOperatorFactory,
        )
        self._visit(node.source, pipe)
        pipe.append(TableFinishOperatorFactory(
            self._next_id(), node.source.output[0].symbol,
            node.output[0].symbol))

    def _visit_GroupIdNode(self, node: N.GroupIdNode, pipe: List):
        self._visit(node.source, pipe)
        pipe.append(misc_ops.GroupIdOperatorFactory(
            self._next_id(), node.groupings, node.gid_symbol,
            node.grouping_outputs))

    def _visit_SortNode(self, node: N.SortNode, pipe: List):
        self._visit(node.source, pipe)
        pipe.append(OrderByOperatorFactory(
            self._next_id(), node.keys, node.descending,
            node.nulls_first))

    def _visit_TopNNode(self, node: N.TopNNode, pipe: List):
        self._visit(node.source, pipe)
        schema_cols = [(f.symbol, f.type, f.dictionary)
                       for f in node.output]
        pipe.append(TopNOperatorFactory(
            self._next_id(), node.n, node.keys, node.descending,
            node.nulls_first, schema_cols))

    def _visit_LimitNode(self, node: N.LimitNode, pipe: List):
        self._visit(node.source, pipe)
        pipe.append(LimitOperatorFactory(self._next_id(), node.n))

    def _visit_DistinctNode(self, node: N.DistinctNode, pipe: List):
        self._visit(node.source, pipe)
        pipe.append(DistinctOperatorFactory(
            self._next_id(), [(f.symbol, f.type, f.dictionary)
                              for f in node.output]))

    def _visit_EnforceSingleRowNode(self, node: N.EnforceSingleRowNode,
                                    pipe: List):
        self._visit(node.source, pipe)
        pipe.append(misc_ops.enforce_single_row_factory(
            self._next_id(), [(f.symbol, f.type, f.dictionary)
                              for f in node.output]))

    def _visit_AssignUniqueIdNode(self, node: N.AssignUniqueIdNode,
                                  pipe: List):
        # one local task: ids start at 0 with stride 1 (the reference
        # strides them by task on the distributed path)
        self._visit(node.source, pipe)
        pipe.append(misc_ops.AssignUniqueIdOperatorFactory(
            self._next_id(), node.symbol, start=0, stride=1))

    def _visit_UnionNode(self, node: N.UnionNode, pipe: List):
        """Each input is a producer pipeline whose tail renames its
        symbols to the union's, re-encodes its string columns onto the
        union's dictionaries (the union of its inputs') and pushes into
        one local queue; the consumer pipeline starts from the queue."""
        queue = misc_ops.LocalQueue(len(node.inputs))
        dicts = {f.symbol: f.dictionary for f in node.output
                 if f.dictionary}
        for inp, symmap in zip(node.inputs, node.symbol_maps):
            p: List = []
            self._visit(inp, p)
            rename = {src: out for out, src in symmap.items()}
            p.append(misc_ops.queue_sink_factory(self._next_id(), queue,
                                                 rename, dicts))
            self._pipelines.append(p)
        pipe.append(misc_ops.queue_source_factory(self._next_id(), queue))

    def _visit_OutputNode(self, node: N.OutputNode, pipe: List):
        self._visit(node.source, pipe)


# ---------------------------------------------------------------------------

#: aggregates whose DECIMAL argument is pre-cast to DOUBLE (the kernel
#: state is float64)
DOUBLE_INPUT_AGGS = frozenset({
    "avg", "var_samp", "var_pop", "variance", "stddev", "stddev_samp",
    "stddev_pop", "geometric_mean",
})

_VARIANCE_CANON = {"variance": "var_samp", "stddev_samp": "stddev"}


def agg_function_for(name: str, input_type: Optional[Type],
                     output_type: Optional[Type],
                     params: tuple = ()) -> hashagg.AggFunction:
    """Resolve an aggregate name + argument type to its state machine."""
    if name == "count":
        return hashagg.make_count(input_type)
    if name == "sum":
        return hashagg.make_sum(input_type, output_type)
    if name == "avg":
        return hashagg.make_avg(input_type)
    if name in ("min", "max", "arbitrary", "any_value"):
        fn = hashagg.make_min if name != "max" else hashagg.make_max
        return fn(input_type)
    if name in ("var_samp", "var_pop", "variance", "stddev",
                "stddev_samp", "stddev_pop"):
        return hashagg.make_variance(_VARIANCE_CANON.get(name, name))
    if name == "count_if":
        return hashagg.make_count_if()
    if name in ("bool_and", "bool_or", "every"):
        return hashagg.make_bool_and(name == "bool_or")
    if name == "geometric_mean":
        return hashagg.make_geometric_mean()
    if name in ("skewness", "kurtosis"):
        return hashagg.make_moments(name)
    if name == "entropy":
        return hashagg.make_entropy()
    if name in ("approx_percentile", "approx_distinct", "checksum"):
        raise LocalPlanningError(
            f"aggregate {name}: later slice of the port (ROADMAP A5)")
    raise LocalPlanningError(f"unknown aggregate {name}")


def _trace_scan_column(node: N.PlanNode, symbol: str, shared=frozenset()):
    """Follow `symbol` down through filters and identity projections to
    the TableScanNode that produces it: (scan node, scan symbol), or
    None when anything else (a join, an aggregation) intervenes, or when
    any node on the path is in `shared` (a spooled subtree also feeds
    other consumers: a join's filter there would drop their rows)."""
    while True:
        if id(node) in shared:
            return None
        if isinstance(node, N.TableScanNode):
            return (node, symbol) if symbol in node.assignments else None
        if isinstance(node, N.FilterNode):
            node = node.source
            continue
        if isinstance(node, N.ProjectNode):
            expr = dict(node.assignments).get(symbol)
            if isinstance(expr, InputRef):
                symbol = expr.name
                node = node.source
                continue
        return None


def _unified_key_dicts(probe: N.PlanNode, build: N.PlanNode,
                       criteria) -> Optional[List[Optional[tuple]]]:
    """For string join keys, the union dictionary both sides re-encode
    onto, so code equality is string equality (batch.remap_column)."""
    from presto_tpu_torch.batch import union_dictionary
    out: List[Optional[tuple]] = []
    any_string = False
    for l, r in criteria:
        lf = probe.field(l)
        rf = build.field(r)
        if lf.type.is_string or rf.type.is_string:
            any_string = True
            out.append(union_dictionary(lf.dictionary, rf.dictionary))
        else:
            out.append(None)
    return out if any_string else None


def _parent_counts(root: N.PlanNode) -> Dict[int, int]:
    """Parent-edge count per node id over the plan DAG."""
    counts: Dict[int, int] = {}
    seen: set = set()

    def walk(n: N.PlanNode) -> None:
        for s in n.sources():
            counts[id(s)] = counts.get(id(s), 0) + 1
            if id(s) not in seen:
                seen.add(id(s))
                walk(s)
    walk(root)
    return counts


def _shared_nodes(root: N.PlanNode) -> set:
    """ids of plan nodes with more than one parent (DAG sharing)."""
    return {nid for nid, c in _parent_counts(root).items() if c > 1}


def field_symbols(f: "N.Field") -> List[str]:
    """Physical column symbols of an output field: the symbol itself,
    or — for complex-typed fields — the slot symbols its form
    references (the named symbol has no column)."""
    form = getattr(f, "form", None)
    if form is None:
        return [f.symbol]
    return N.form_slot_symbols(form)


def prune_unused_columns(root: N.PlanNode) -> None:
    """Demand-driven column pruning, top-down (reference:
    PruneUnreferencedOutputs): each node narrows its output to what its
    consumer demands and propagates its own input needs to its sources.
    Mutates the plan in place; symbols are globally unique.

    DAG-aware: a subtree shared by several parents (e.g. the probe side
    of a unique-id decorrelation feeds both a join and a semi join)
    accumulates demand from ALL parents before being narrowed — the
    naive recursive narrowing would let the first parent's prune hide
    columns the second parent still needs."""
    # pass 0: count parent edges (Kahn topological order over the DAG)
    pending = _parent_counts(root)

    # pass 1: propagate demand top-down, processing a node only once all
    # of its parents have contributed
    demands: Dict[int, set] = {id(root): {
        s for f in root.output for s in field_symbols(f)}}
    order: List[N.PlanNode] = []
    queue: List[N.PlanNode] = [root]
    while queue:
        node = queue.pop()
        order.append(node)
        for child, d in _child_demand(node, demands[id(node)]):
            demands.setdefault(id(child), set()).update(d)
            pending[id(child)] -= 1
            if pending[id(child)] == 0:
                queue.append(child)

    # pass 2: narrow each node once, with its final accumulated demand
    for node in order:
        _apply_prune(node, demands[id(node)])


def _child_demand(node: N.PlanNode, demand: set
                  ) -> List[Tuple[N.PlanNode, set]]:
    if isinstance(node, (N.TableScanNode, N.ValuesNode,
                         N.RemoteSourceNode)):
        return []
    if isinstance(node, N.FilterNode):
        child = set(demand)
        _refs(node.predicate, child)
        return [(node.source, child)]
    if isinstance(node, N.TableWriterNode):
        return [(node.source,
                 {s for s in node.column_sources.values()
                  if s is not None})]
    if isinstance(node, N.TableFinishNode):
        return [(node.source,
                 {f.symbol for f in node.source.output})]
    if isinstance(node, N.ProjectNode):
        child: set = set()
        for s, e in node.assignments:
            if s in demand:
                _refs(e, child)
        return [(node.source, child)]
    if isinstance(node, N.AggregationNode):
        child = set()
        for _, e in node.keys:
            _refs(e, child)
        for a in node.aggregates:
            if _agg_demanded(a, demand):
                if a.argument is not None:
                    _refs(a.argument, child)
                if a.argument2 is not None:
                    _refs(a.argument2, child)
                if a.filter is not None:
                    _refs(a.filter, child)
        return [(node.source, child)]
    if isinstance(node, N.JoinNode):
        extra: set = set()
        for l, r in node.criteria:
            extra.add(l)
            extra.add(r)
        if node.filter is not None:
            _refs(node.filter, extra)
        want = demand | extra
        left_syms = {f.symbol for f in node.left.output}
        right_syms = {f.symbol for f in node.right.output}
        return [(node.left, want & left_syms),
                (node.right, want & right_syms)]
    if isinstance(node, N.SemiJoinNode):
        return [(node.source, demand | {node.source_key}),
                (node.filtering_source, {node.filtering_key})]
    if isinstance(node, (N.SortNode, N.TopNNode, N.MergeNode)):
        return [(node.source, demand | set(node.keys))]
    if isinstance(node, N.WindowNode):
        child = (demand - {c.out_symbol for c in node.calls}) \
            | set(node.partition_by) | set(node.order_by) \
            | {c.argument for c in node.calls if c.argument} \
            | {c.filter for c in node.calls if c.filter}
        return [(node.source, child)]
    if isinstance(node, N.TopNRowNumberNode):
        child = (demand - {node.row_number_symbol}) \
            | set(node.partition_by) | set(node.order_by)
        return [(node.source, child)]
    if isinstance(node, N.DistinctNode):
        # DISTINCT is defined over exactly its output columns
        return [(node.source, {f.symbol for f in node.output})]
    if isinstance(node, (N.LimitNode, N.EnforceSingleRowNode,
                         N.ExchangeNode)):
        return [(node.source, set(demand))]
    if isinstance(node, N.AssignUniqueIdNode):
        return [(node.source, demand - {node.symbol})]
    if isinstance(node, N.GroupIdNode):
        drop = {node.gid_symbol} | {s for s, _ in node.grouping_outputs}
        return [(node.source, (demand - drop) | set(node.all_keys))]
    if isinstance(node, N.UnnestNode):
        drop = {s for s, _, _ in node.items}
        if node.ordinality_symbol:
            drop.add(node.ordinality_symbol)
        elem = {e for _, syms, _ in node.items for e in syms}
        elem |= {ls for _, _, ls in node.items if ls}
        return [(node.source, (demand - drop) | elem)]
    if isinstance(node, N.UnionNode):
        out = []
        for inp, m in zip(node.inputs, node.symbol_maps):
            m2 = {o: src for o, src in m.items() if o in demand}
            out.append((inp, set(m2.values())))
        return out
    if isinstance(node, N.OutputNode):
        # complex-typed outputs demand their SLOT columns, not the
        # (column-less) named symbol
        return [(node.source,
                 {s for f in node.output for s in field_symbols(f)})]
    raise LocalPlanningError(
        f"prune: unhandled node {type(node).__name__}")


def _agg_demanded(a: "N.AggCall", demand: set) -> bool:
    """A collection aggregate (array_agg/map_agg) is demanded through
    its SLOT symbols (<out>__a0, <out>__len, ...), never the
    column-less out symbol itself."""
    if a.out_symbol in demand:
        return True
    prefix = a.out_symbol + "__"
    return any(d.startswith(prefix) for d in demand)


def _apply_prune(node: N.PlanNode, demand: set) -> None:
    def narrowed(extra: set = frozenset()):
        want = demand | extra
        return tuple(f for f in node.output if f.symbol in want)

    if isinstance(node, N.TableScanNode):
        keep = {s: c for s, c in node.assignments.items() if s in demand}
        if not keep:  # keep one column so the scan still yields rows
            first = next(iter(node.assignments.items()))
            keep = {first[0]: first[1]}
        node.assignments = keep
        node.output = tuple(f for f in node.output if f.symbol in keep)
    elif isinstance(node, (N.ValuesNode, N.OutputNode, N.DistinctNode,
                           N.RemoteSourceNode)):
        # a remote source's schema is fixed by its producer fragment;
        # extra columns in received batches are simply ignored
        pass
    elif isinstance(node, N.ProjectNode):
        node.assignments = [(s, e) for s, e in node.assignments
                            if s in demand]
        node.output = narrowed()
    elif isinstance(node, N.AggregationNode):
        node.aggregates = [a for a in node.aggregates
                           if _agg_demanded(a, demand)]
        keep = {s for s, _ in node.keys} | \
            {a.out_symbol for a in node.aggregates}
        node.output = tuple(f for f in node.output if f.symbol in keep)
    elif isinstance(node, N.JoinNode):
        extra: set = set()
        for l, r in node.criteria:
            extra.add(l)
            extra.add(r)
        if node.filter is not None:
            _refs(node.filter, extra)
        node.output = narrowed(extra)
    elif isinstance(node, N.SemiJoinNode):
        node.output = narrowed({node.source_key})
    elif isinstance(node, (N.SortNode, N.TopNNode, N.MergeNode)):
        node.output = narrowed(set(node.keys))
    elif isinstance(node, N.WindowNode):
        node.calls = [c for c in node.calls if c.out_symbol in demand]
        node.output = narrowed(
            set(node.partition_by) | set(node.order_by)
            | {c.argument for c in node.calls if c.argument})
    elif isinstance(node, N.TopNRowNumberNode):
        node.output = narrowed(
            set(node.partition_by) | set(node.order_by))
    elif isinstance(node, N.AssignUniqueIdNode):
        node.output = narrowed({node.symbol})
    elif isinstance(node, N.GroupIdNode):
        node.output = narrowed(
            set(node.all_keys) | {node.gid_symbol}
            | {s for s, _ in node.grouping_outputs})
    elif isinstance(node, N.UnnestNode):
        keep = {s for s, _, _ in node.items}
        if node.ordinality_symbol:
            keep.add(node.ordinality_symbol)
        node.output = narrowed(keep)
    elif isinstance(node, N.UnionNode):
        node.output = narrowed()
        keep_syms = {f.symbol for f in node.output}
        node.symbol_maps = [
            {o: src for o, src in m.items() if o in keep_syms}
            for m in node.symbol_maps]
    else:
        node.output = narrowed()


def _refs(e: RowExpression, out: set) -> None:
    for x in walk(e):
        if isinstance(x, InputRef):
            out.add(x.name)
