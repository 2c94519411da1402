"""Local execution planner: PlanNode tree -> operator pipelines
(reference: presto_tpu/planner/local_planner.py;
sql/planner/LocalExecutionPlanner.java:549).

This slice plans single-pipeline queries: TableScan, Values, Filter,
Project, Aggregation (direct slot-table path), Sort, TopN, Limit and
Output. Every other node raises `LocalPlanningError` naming the
ROADMAP item that ports it. `fragment_fusion_enabled` is accepted and
has no effect yet: whole-fragment fusion is a later slice (A7).
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
    AggregationOperatorFactory, AggSpec,
)
from presto_tpu_torch.operators.core import (
    FilterProjectOperatorFactory, LimitOperatorFactory,
    OutputCollectorOperatorFactory, TableScanOperatorFactory,
    ValuesOperatorFactory,
)
from presto_tpu_torch.operators.sort_ops import (
    OrderByOperatorFactory, TopNOperatorFactory,
)
from presto_tpu_torch.ops import hashagg
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
    "JoinNode": "A6 (joins)",
    "SemiJoinNode": "A6 (semi join)",
    "DistinctNode": "A6 (distinct)",
    "WindowNode": "A8 (windows)",
    "TopNRowNumberNode": "A8 (windows)",
    "MergeNode": "A8 (merge)",
    "UnionNode": "A8 (set operations)",
    "EnforceSingleRowNode": "A8 (misc operators)",
    "AssignUniqueIdNode": "A8 (misc operators)",
    "UnnestNode": "A8 (misc operators)",
    "GroupIdNode": "A8 (misc operators)",
    "TableWriterNode": "A9 (storage)",
    "TableFinishNode": "A9 (storage)",
    "RemoteSourceNode": "A12 (distributed path)",
    "ExchangeNode": "A12 (distributed path)",
}


def _schema_of(node: N.PlanNode) -> Dict[str, ColumnSchema]:
    out = {}
    for f in node.output:
        if getattr(f, "form", None) is not None:
            raise LocalPlanningError(
                "array/map/row-typed columns: later slice of the port "
                "(ROADMAP A8)")
        out[f.symbol] = ColumnSchema(f.symbol, f.type, f.dictionary)
    return out


class LocalExecutionPlanner:
    def __init__(self, catalog_manager, session, device: torch.device):
        self.catalogs = catalog_manager
        self.session = session
        self.device = device
        self._pipelines: List[List] = []
        self._op_id = 0

    def _next_id(self) -> int:
        self._op_id += 1
        return self._op_id

    def _compile(self, expr: RowExpression,
                 schema: Dict[str, ColumnSchema]) -> CompiledExpr:
        return compile_expression(expr, schema, self.device)

    def plan(self, root: N.OutputNode) -> LocalExecutionPlan:
        prune_unused_columns(root)
        from presto_tpu_torch.planner.validation import validate
        validate(root, "local_planner", session=self.session)
        if _shared_nodes(root):
            raise LocalPlanningError(
                "shared plan subtrees (spools): later slice of the port "
                "(ROADMAP A8)")
        sink: List[Batch] = []
        pipeline: List = []
        self._visit(root.source, pipeline)
        # final projection to output order
        src_schema = _schema_of(root.source)
        projections = [
            (f.symbol, self._compile(InputRef(f.symbol,
                                              src_schema[f.symbol].type),
                                     src_schema))
            for f in root.output]
        pipeline.append(FilterProjectOperatorFactory(
            self._next_id(), None, projections))
        pipeline.append(OutputCollectorOperatorFactory(
            self._next_id(), sink))
        self._pipelines.append(pipeline)
        return LocalExecutionPlan(self._pipelines, sink, root.names,
                                  root.output)

    def _visit(self, node: N.PlanNode, pipe: List) -> None:
        name = type(node).__name__
        m = getattr(self, f"_visit_{name}", None)
        if m is None:
            later = _LATER.get(name)
            raise LocalPlanningError(
                f"no local planning for {name}"
                + (f": later slice of the port (ROADMAP {later})"
                   if later else ""))
        m(node, pipe)

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
            self._next_id(), f"scan:{handle.table}", batch_iter))

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

    def _visit_FilterNode(self, node: N.FilterNode, pipe: List):
        self._visit(node.source, pipe)
        schema = _schema_of(node.source)
        pred = self._compile(node.predicate, schema)
        projections = [
            (f.symbol, self._compile(InputRef(f.symbol, f.type), schema))
            for f in node.output]
        pipe.append(FilterProjectOperatorFactory(
            self._next_id(), pred, projections))

    def _visit_ProjectNode(self, node: N.ProjectNode, pipe: List):
        self._visit(node.source, pipe)
        schema = _schema_of(node.source)
        projections = [(sym, self._compile(e, schema))
                       for sym, e in node.assignments]
        pipe.append(FilterProjectOperatorFactory(
            self._next_id(), None, projections))

    def _visit_AggregationNode(self, node: N.AggregationNode, pipe: List):
        self._visit(node.source, pipe)
        schema = _schema_of(node.source)
        key_names = [s for s, _ in node.keys]
        key_exprs = [self._compile(e, schema) for _, e in node.keys]
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
        pipe.append(AggregationOperatorFactory(
            self._next_id(), key_names, key_exprs, specs, node.step))

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
    if name in ("approx_percentile", "approx_distinct", "checksum",
                "array_agg", "map_agg"):
        raise LocalPlanningError(
            f"aggregate {name}: later slice of the port (ROADMAP B4)")
    raise LocalPlanningError(f"unknown aggregate {name}")


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
