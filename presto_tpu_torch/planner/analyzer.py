"""Combined analyzer + logical planner: AST -> typed PlanNode tree.

Reference surface: sql/analyzer/StatementAnalyzer.java:239 (scopes, name
resolution, aggregation analysis) + sql/planner/LogicalPlanner.java:114
+ RelationPlanner/QueryPlanner. Collapsed into one pass for round 1
(documented in planner/__init__.py).

Handles: FROM planning (tables, CTEs, derived tables, joins with
equi-criteria extraction), WHERE with IN/EXISTS/scalar subqueries
(uncorrelated, plus equality-correlated decorrelation into semi/agg
joins — the classic rewrite TPC-H Q4/Q17/Q20/Q21/Q22 need), GROUP
BY/HAVING with agg-call rewriting, SELECT projection with star
expansion, ORDER BY over hidden sort columns, DISTINCT, LIMIT/TopN,
UNION, VALUES.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple

from presto_tpu_torch.expr import dates as dt
from presto_tpu_torch.expr.compile import fold_constants
from presto_tpu_torch.expr.ir import (
    Call, InputRef, Literal, RowExpression, SpecialForm, walk,
)
from presto_tpu_torch.parser import tree as T
from presto_tpu_torch.planner import nodes as N
from presto_tpu_torch.types import (
    BIGINT, BOOLEAN, DATE, DOUBLE, INTEGER, INTERVAL_DAY, INTERVAL_YEAR,
    Type, UNKNOWN, VARCHAR, common_super_type, decimal_type, parse_type,
)

AGG_FUNCTIONS = {
    "sum", "count", "avg", "min", "max",
    "var_samp", "var_pop", "variance", "stddev", "stddev_samp",
    "stddev_pop", "count_if", "bool_and", "bool_or", "every",
    "geometric_mean", "checksum", "arbitrary", "any_value",
    "approx_distinct", "approx_percentile", "skewness", "kurtosis",
    "entropy", "array_agg", "map_agg",
}


def _agg_arg_and_params(c, an):
    """Argument expression + static parameters of an aggregate call.
    approx_percentile(x, p) takes a constant percentile as its second
    argument; everything else is single-argument."""
    if c.name == "approx_percentile":
        if len(c.args) != 2:
            raise AnalysisError(
                "approx_percentile takes (value, percentile)")
        p = fold_constants(an.analyze(c.args[1]))
        if not isinstance(p, Literal) or p.value is None:
            raise AnalysisError(
                "approx_percentile's percentile must be a constant")
        frac = float(p.value) if not p.type.is_decimal \
            else p.value / 10 ** p.type.scale
        if not 0 < frac < 1:
            raise AnalysisError("percentile must be in (0, 1)")
        return fold_constants(an.analyze(c.args[0])), (frac,)
    if c.name == "approx_distinct":
        from presto_tpu_torch.ops.hashagg import (
            HLL_DEFAULT_ERROR, HLL_MAX_ERROR, HLL_MIN_ERROR,
        )
        if len(c.args) not in (1, 2):
            raise AnalysisError("approx_distinct takes (value[, e])")
        err = HLL_DEFAULT_ERROR
        if len(c.args) == 2:
            e = fold_constants(an.analyze(c.args[1]))
            if not isinstance(e, Literal) or e.value is None:
                raise AnalysisError(
                    "approx_distinct's error bound must be a constant")
            err = float(e.value) if not e.type.is_decimal \
                else e.value / 10 ** e.type.scale
            if not HLL_MIN_ERROR <= err <= HLL_MAX_ERROR:
                raise AnalysisError(
                    f"approx_distinct error bound must be in "
                    f"[{HLL_MIN_ERROR}, {HLL_MAX_ERROR}]")
            from presto_tpu_torch.ops.hashagg import (
                HLL_HONORED_MIN_ERROR,
            )
            if err < HLL_HONORED_MIN_ERROR:
                # accepted-but-not-honored precision is a silent lie
                # (advisor r4): the register table caps at 2^14 (the
                # per-row one-hot contribution is [rows, m] — 2^16
                # registers would put a multi-GB intermediate in every
                # batch step), so bounds below ~0.82% are rejected
                # with the deviation spelled out rather than clamped
                raise AnalysisError(
                    f"approx_distinct error bound {err} is below this "
                    f"engine's honored minimum "
                    f"{HLL_HONORED_MIN_ERROR:.6f} (register table "
                    f"capped at 2^14; Presto accepts "
                    f"{HLL_MIN_ERROR} but we refuse rather than "
                    f"silently deliver less precision)")
        return fold_constants(an.analyze(c.args[0])), (err,)
    if len(c.args) != 1:
        raise AnalysisError(f"{c.name} takes one argument")
    arg = fold_constants(an.analyze(c.args[0]))
    if c.name in ("count_if", "bool_and", "bool_or", "every"):
        arg = _coerce_to(arg, BOOLEAN)
    return arg, ()


class AnalysisError(Exception):
    pass


@dataclasses.dataclass
class ScopeField:
    qualifier: Optional[str]
    name: str
    symbol: str
    type: Type
    dictionary: Optional[tuple] = None
    #: complex-typed fields: the ArrayValue/MapValue/RowValue over the
    #: exploded slot columns (see nodes.Field.form)
    form: Optional[object] = None
    #: per-slot string dictionaries ({slot symbol -> dictionary})
    form_dicts: Optional[dict] = None


class Scope:
    def __init__(self, fields: List[ScopeField],
                 parent: Optional["Scope"] = None):
        self.fields = fields
        self.parent = parent

    def resolve(self, parts: Tuple[str, ...]) -> Tuple[ScopeField, bool]:
        """Returns (field, is_outer). Raises on ambiguity/missing."""
        matches = self._match(parts)
        if len(matches) == 1:
            return matches[0], False
        if len(matches) > 1:
            raise AnalysisError(f"ambiguous column {'.'.join(parts)!r}")
        if self.parent is not None:
            f, _ = self.parent.resolve(parts)
            return f, True
        raise AnalysisError(f"column {'.'.join(parts)!r} cannot be "
                            f"resolved")

    def _match(self, parts: Tuple[str, ...]) -> List[ScopeField]:
        if len(parts) == 1:
            return [f for f in self.fields if f.name == parts[0]]
        if len(parts) >= 2:
            q, n = parts[-2], parts[-1]
            return [f for f in self.fields
                    if f.name == n and f.qualifier == q]
        return []


class SymbolAllocator:
    def __init__(self):
        self._n = itertools.count()

    def new(self, hint: str) -> str:
        return f"{hint}_{next(self._n)}"


@dataclasses.dataclass
class RelationPlan:
    node: N.PlanNode
    scope: Scope


class PlannerContext:
    def __init__(self, metadata, session):
        self.metadata = metadata      # CatalogManager-like
        self.session = session        # has .catalog, .schema
        self.symbols = SymbolAllocator()
        self.ctes: Dict[str, T.Query] = {}


def plan_statement(stmt: T.Node, metadata, session) -> N.PlanNode:
    ctx = PlannerContext(metadata, session)
    if isinstance(stmt, T.Query):
        return plan_query_output(stmt, ctx)
    raise AnalysisError(f"unsupported statement {type(stmt).__name__}")


def plan_query_output(q: T.Query, ctx: PlannerContext) -> N.OutputNode:
    rp, names = plan_query(q, ctx, outer=None)
    out_fields = tuple(N.Field(f.symbol, f.type, f.dictionary,
                               form=f.form)
                       for f in rp.scope.fields)
    return N.OutputNode(rp.node, names,
                        [f.symbol for f in rp.scope.fields], out_fields)


# ---------------------------------------------------------------------------
# query planning
# ---------------------------------------------------------------------------

def plan_query(q: T.Query, ctx: PlannerContext,
               outer: Optional[Scope]) -> Tuple[RelationPlan, List[str]]:
    """Returns the plan plus user-visible output names."""
    saved_ctes = dict(ctx.ctes)
    for cte in q.ctes:
        ctx.ctes[cte.name] = cte
    try:
        if isinstance(q.body, T.QuerySpec):
            rp, names = _plan_query_spec(q.body, q, ctx, outer)
        elif isinstance(q.body, T.SetOperation):
            rp, names = _plan_set_op(q.body, ctx, outer)
            rp, names = _apply_order_limit(rp, names, q, ctx)
        elif isinstance(q.body, T.ValuesRelation):
            rp, names = _plan_values(q.body, ctx)
            rp, names = _apply_order_limit(rp, names, q, ctx)
        elif isinstance(q.body, T.Query):
            rp, names = plan_query(q.body, ctx, outer)
            rp, names = _apply_order_limit(rp, names, q, ctx)
        else:
            raise AnalysisError(f"unsupported query body "
                                f"{type(q.body).__name__}")
        return rp, names
    finally:
        ctx.ctes = saved_ctes


def _apply_order_limit(rp: RelationPlan, names: List[str], q: T.Query,
                       ctx: PlannerContext):
    if q.order_by:
        keys, desc, nf = [], [], []
        an = _Analyzer(rp.scope, ctx)
        for item in q.order_by:
            e = an.analyze(item.expr)
            sym = _as_symbol(e)
            if sym is None:
                raise AnalysisError("ORDER BY over set operations must "
                                    "reference output columns")
            keys.append(sym)
            desc.append(item.descending)
            nf.append(item.nulls_first if item.nulls_first is not None
                      else item.descending)
        out = _physical_fields(rp.scope.fields, rp.node)
        if q.limit is not None:
            rp = RelationPlan(N.TopNNode(rp.node, q.limit, keys, desc, nf,
                                         out), rp.scope)
            return rp, names
        rp = RelationPlan(N.SortNode(rp.node, keys, desc, nf, out),
                          rp.scope)
    if q.limit is not None:
        out = _physical_fields(rp.scope.fields, rp.node)
        rp = RelationPlan(N.LimitNode(rp.node, q.limit, out), rp.scope)
    return rp, names


def _as_symbol(e: RowExpression) -> Optional[str]:
    return e.name if isinstance(e, InputRef) else None


def _physical_fields(scope_fields, *sources: N.PlanNode):
    """Pass-through node output schema: scope fields expanded to their
    PHYSICAL columns — a complex-typed field contributes its slot
    columns (looked up on the source(s) for type/dictionary), never
    its column-less named symbol."""
    by_sym = {f.symbol: f for src in sources for f in src.output}
    out = []
    for f in scope_fields:
        if f.form is None:
            out.append(N.Field(f.symbol, f.type, f.dictionary))
        else:
            for s in N.form_slot_symbols(f.form):
                sf = by_sym[s]
                out.append(N.Field(sf.symbol, sf.type, sf.dictionary))
    return tuple(out)


def _plan_values(v: T.ValuesRelation, ctx: PlannerContext):
    # analyze literal rows; infer per-column common types
    n_cols = len(v.rows[0])
    analyzed = []
    an = _Analyzer(Scope([]), ctx)
    for row in v.rows:
        if len(row) != n_cols:
            raise AnalysisError("VALUES rows must be the same width")
        analyzed.append([fold_constants(an.analyze(e)) for e in row])
    fields = []
    for i in range(n_cols):
        typ = UNKNOWN
        for row in analyzed:
            t = common_super_type(typ, row[i].type)
            if t is None:
                raise AnalysisError("VALUES column types incompatible")
            typ = t
        fields.append(ScopeField(None, f"_col{i}",
                                 ctx.symbols.new(f"_col{i}"), typ))
    rows = []
    for row in analyzed:
        vals = []
        for i, e in enumerate(row):
            if not isinstance(e, Literal):
                raise AnalysisError("VALUES must contain constants")
            vals.append(_coerce_literal_value(e, fields[i].type))
        rows.append(vals)
    # string columns: build dictionaries
    out_fields = []
    for i, f in enumerate(fields):
        dic = None
        if f.type.is_string:
            dic = tuple(sorted({r[i] for r in rows if r[i] is not None}))
            index = {s: j for j, s in enumerate(dic)}
            for r in rows:
                r[i] = index[r[i]] if r[i] is not None else None
        out_fields.append(N.Field(f.symbol, f.type, dic))
        fields[i] = dataclasses.replace(f, dictionary=dic)
    node = N.ValuesNode(rows, tuple(out_fields))
    scope = Scope(fields)
    return RelationPlan(node, scope), [f.name for f in fields]


def _coerce_literal_value(e: Literal, typ: Type):
    if e.value is None:
        return None
    if typ.is_string or e.type == typ:
        return e.value
    if typ.is_decimal:
        if e.type.is_decimal:
            return e.value * 10 ** (typ.scale - e.type.scale)
        if e.type.is_integer:
            return e.value * 10 ** typ.scale
        return int(round(float(e.value) * 10 ** typ.scale))
    if typ.is_floating:
        if e.type.is_decimal:
            return e.value / 10 ** e.type.scale
        return float(e.value)
    return e.value


def _plan_set_op(s: T.SetOperation, ctx: PlannerContext,
                 outer: Optional[Scope]):
    if s.op in ("intersect", "except"):
        return _plan_intersect_except(s, ctx, outer)
    if s.op != "union":
        raise AnalysisError(f"{s.op.upper()} not yet supported")
    parts: List[Tuple[RelationPlan, List[str]]] = []

    def flatten(node):
        if isinstance(node, T.SetOperation) and node.op == "union" \
                and node.distinct == s.distinct:
            flatten(node.left)
            flatten(node.right)
        else:
            parts.append(_plan_query_body(node, ctx, outer))
    flatten(s.left)
    flatten(s.right)
    rp, first_names = _plan_union_parts(parts, ctx)
    if s.distinct:
        rp = RelationPlan(
            N.DistinctNode(rp.node,
                           tuple(N.Field(f.symbol, f.type, f.dictionary)
                                 for f in rp.scope.fields)),
            rp.scope)
    return rp, first_names


def _plan_union_parts(parts: List[Tuple[RelationPlan, List[str]]],
                      ctx: PlannerContext):
    """UNION ALL of pre-planned inputs: common row type, per-input
    casts, unified string dictionaries."""
    first_rp, first_names = parts[0]
    width = len(first_rp.scope.fields)
    for rp, _ in parts[1:]:
        if len(rp.scope.fields) != width:
            raise AnalysisError("UNION inputs must have the same width")
    # common types per position
    fields = []
    for i in range(width):
        typ = UNKNOWN
        for rp, _ in parts:
            t = common_super_type(typ, rp.scope.fields[i].type)
            if t is None:
                raise AnalysisError("UNION input types incompatible")
            typ = t
        name = first_rp.scope.fields[i].name
        fields.append(ScopeField(None, name, ctx.symbols.new(name), typ))
    inputs, maps = [], []
    for rp, _ in parts:
        # cast each input to the common row type where needed
        assigns, symbols = [], []
        need_cast = False
        for i, f in enumerate(rp.scope.fields):
            if f.type != fields[i].type:
                need_cast = True
        if need_cast:
            out_fields = []
            for i, f in enumerate(rp.scope.fields):
                sym = ctx.symbols.new(f.name)
                e: RowExpression = InputRef(f.symbol, f.type)
                if f.type != fields[i].type:
                    e = SpecialForm("cast", (e,), fields[i].type)
                assigns.append((sym, e))
                out_fields.append(N.Field(sym, fields[i].type,
                                          f.dictionary))
                symbols.append(sym)
            node = N.ProjectNode(rp.node, assigns, tuple(out_fields))
        else:
            node = rp.node
            symbols = [f.symbol for f in rp.scope.fields]
        inputs.append(node)
        maps.append({fields[i].symbol: symbols[i] for i in range(width)})
    # unify dictionaries for string outputs
    out_fields = []
    for i, f in enumerate(fields):
        dic = None
        if f.type.is_string:
            merged = set()
            for rp, _ in parts:
                merged |= set(rp.scope.fields[i].dictionary or ())
            dic = tuple(sorted(merged))
        out_fields.append(N.Field(f.symbol, f.type, dic))
        fields[i] = dataclasses.replace(f, dictionary=dic)
    node = N.UnionNode(inputs, maps, tuple(out_fields))
    return RelationPlan(node, Scope(fields)), first_names


def _plan_intersect_except(s: T.SetOperation, ctx: PlannerContext,
                           outer: Optional[Scope]):
    """INTERSECT/EXCEPT [DISTINCT] via the marker-count scheme the
    reference's optimizer uses (ImplementIntersectAndExceptAsUnion.java):
    UNION ALL both sides with a side-marker column, GROUP BY the row,
    keep rows seen on the required sides. GROUP BY treats NULLs as
    equal, which is exactly the set-operation NULL semantics (a join
    formulation would drop NULL rows)."""
    if not s.distinct:
        raise AnalysisError(
            f"{s.op.upper()} ALL is not supported")
    parts = [_plan_query_body(s.left, ctx, outer),
             _plan_query_body(s.right, ctx, outer)]
    marked = []
    for side, (rp, names) in enumerate(parts):
        msym = ctx.symbols.new("setop_side")
        assigns = [(f.symbol, InputRef(f.symbol, f.type))
                   for f in rp.scope.fields]
        assigns.append((msym, Literal(side, BIGINT)))
        out = tuple([N.Field(f.symbol, f.type, f.dictionary)
                     for f in rp.scope.fields]
                    + [N.Field(msym, BIGINT)])
        node = N.ProjectNode(rp.node, assigns, out)
        scope = Scope(list(rp.scope.fields)
                      + [ScopeField(None, msym, msym, BIGINT)])
        marked.append((RelationPlan(node, scope), names))

    union_rp, first_names = _plan_union_parts(marked, ctx)
    fields = union_rp.scope.fields
    data_fields, marker = fields[:-1], fields[-1]
    mref = InputRef(marker.symbol, BIGINT)

    def side_count(side: int, hint: str) -> N.AggCall:
        cond = Call("equal", (mref, Literal(side, BIGINT)), BOOLEAN)
        return N.AggCall(ctx.symbols.new(hint), "count_if", cond,
                         False, BIGINT)
    lc, rc = side_count(0, "lcount"), side_count(1, "rcount")
    keys = [(f.symbol, InputRef(f.symbol, f.type)) for f in data_fields]
    agg_out = tuple(
        [N.Field(f.symbol, f.type, f.dictionary) for f in data_fields]
        + [N.Field(lc.out_symbol, BIGINT), N.Field(rc.out_symbol,
                                                   BIGINT)])
    agg = N.AggregationNode(union_rp.node, keys, [lc, rc], "single",
                            agg_out)

    lref = InputRef(lc.out_symbol, BIGINT)
    rref = InputRef(rc.out_symbol, BIGINT)
    on_left = Call("greater_than", (lref, Literal(0, BIGINT)), BOOLEAN)
    if s.op == "intersect":
        on_right = Call("greater_than", (rref, Literal(0, BIGINT)),
                        BOOLEAN)
    else:  # except
        on_right = Call("equal", (rref, Literal(0, BIGINT)), BOOLEAN)
    filt = N.FilterNode(agg, SpecialForm("and", (on_left, on_right),
                                         BOOLEAN), agg_out)
    proj_fields = tuple(N.Field(f.symbol, f.type, f.dictionary)
                        for f in data_fields)
    proj = N.ProjectNode(
        filt, [(f.symbol, InputRef(f.symbol, f.type))
               for f in data_fields], proj_fields)
    return RelationPlan(proj, Scope(list(data_fields))), first_names


def _plan_query_body(body: T.Node, ctx: PlannerContext,
                     outer: Optional[Scope]):
    if isinstance(body, T.QuerySpec):
        return _plan_query_spec(body, None, ctx, outer)
    if isinstance(body, T.Query):
        return plan_query(body, ctx, outer)
    if isinstance(body, T.ValuesRelation):
        return _plan_values(body, ctx)
    if isinstance(body, T.SetOperation):
        return _plan_set_op(body, ctx, outer)
    raise AnalysisError(f"unsupported body {type(body).__name__}")


def _ast_key(node) -> tuple:
    """Structural key for AST equality (GROUP BY / ORDER BY matching)."""
    if isinstance(node, T.Node):
        vals = []
        for f in dataclasses.fields(node):
            vals.append(_ast_key(getattr(node, f.name)))
        return (type(node).__name__, tuple(vals))
    if isinstance(node, (list, tuple)):
        return tuple(_ast_key(v) for v in node)
    return node


def _plan_query_spec(spec: T.QuerySpec, q: Optional[T.Query],
                     ctx: PlannerContext, outer: Optional[Scope]):
    # 1. FROM
    if spec.from_ is not None:
        rp = _plan_relation(spec.from_, ctx, outer)
    else:
        # SELECT without FROM: single-row dummy
        sym = ctx.symbols.new("dummy")
        rp = RelationPlan(
            N.ValuesNode([[0]], (N.Field(sym, BIGINT),)),
            Scope([ScopeField(None, "dummy", sym, BIGINT)], outer))
    # thread outer scope for correlated subqueries
    rp.scope.parent = outer

    # 2. WHERE (with subquery conjunct planning)
    if spec.where is not None:
        rp = _plan_where(spec.where, rp, ctx)

    # 3. aggregation analysis
    select_items: List[T.SelectItem] = []
    for item in spec.select:
        if isinstance(item, T.Star):
            for f in rp.scope.fields:
                if item.qualifier and f.qualifier != item.qualifier[-1]:
                    continue
                select_items.append(
                    T.SelectItem(T.Identifier((f.name,))
                                 if f.qualifier is None else
                                 T.Identifier((f.qualifier, f.name)),
                                 f.name))
        else:
            select_items.append(item)

    has_aggs = bool(spec.group_by) or any(
        _contains_agg(i.expr) for i in select_items) or (
        spec.having is not None and _contains_agg(spec.having))

    order_items = list(q.order_by) if q is not None else []

    if has_aggs:
        rp, rewrites = _plan_aggregation(spec, select_items, order_items,
                                         rp, ctx)
    else:
        rewrites = {}

    # 4. HAVING (scalar subqueries allowed, e.g. Q11's threshold)
    if spec.having is not None:
        having_ast = spec.having
        if _contains_subquery(having_ast):
            rp, having_ast = _plan_scalar_subqueries(having_ast, rp, ctx)
        an = _Analyzer(rp.scope, ctx, rewrites)
        pred = _coerce_to(an.analyze(having_ast), BOOLEAN)
        out = tuple(N.Field(f.symbol, f.type, f.dictionary)
                    for f in rp.scope.fields)
        rp = RelationPlan(N.FilterNode(rp.node, fold_constants(pred), out),
                          rp.scope)

    # 4.5 window functions (evaluated after aggregation/HAVING, before
    # the SELECT projection — reference: StatementAnalyzer's
    # analyzeWindowFunctions + LogicalPlanner window planning)
    window_calls: List[T.FunctionCall] = []
    for item in select_items:
        _collect_window_calls(item.expr, window_calls)
    for item in order_items:
        _collect_window_calls(item.expr, window_calls)
    if window_calls:
        rp, win_rewrites = _plan_windows(window_calls, rp, ctx, rewrites)
        rewrites = {**rewrites, **win_rewrites}

    # 5. SELECT projection (+ hidden sort columns)
    an = _Analyzer(rp.scope, ctx, rewrites)
    assignments: List[Tuple[str, RowExpression]] = []
    #: N.Field per ASSIGNMENT (complex values explode to several slot
    #: assignments, so this is not 1:1 with scope fields)
    assign_fields: List[N.Field] = []
    fields: List[ScopeField] = []
    names: List[str] = []
    alias_to_symbol: Dict[str, str] = {}
    item_key_to_symbol: Dict[tuple, str] = {}
    for item in select_items:
        e = fold_constants(an.analyze(item.expr))
        from presto_tpu_torch.expr.ir import ArrayValue, MapValue, RowValue
        name = item.alias or _derive_name(item.expr)
        sym = ctx.symbols.new(name)
        if isinstance(e, (ArrayValue, MapValue, RowValue)):
            # project the complex value by EXPLODING it into scalar
            # slot columns; the scope field carries the reassembled
            # form over InputRefs (see nodes.Field.form)
            form = _lower_complex_projection(
                e, sym, an, assignments, assign_fields)
            fields.append(ScopeField(None, name, sym, e.type, None,
                                     form=form))
        else:
            assignments.append((sym, e))
            dic = an.dictionary_of(e)
            assign_fields.append(N.Field(sym, e.type, dic))
            fields.append(ScopeField(None, name, sym, e.type, dic))
        names.append(name)
        if item.alias:
            alias_to_symbol[item.alias] = sym
        item_key_to_symbol[_ast_key(item.expr)] = sym

    # ORDER BY keys: reuse select outputs or add hidden columns
    sort_keys, sort_desc, sort_nf = [], [], []
    hidden: List[Tuple[str, RowExpression, Optional[tuple]]] = []
    for item in order_items:
        desc = item.descending
        nf = item.nulls_first if item.nulls_first is not None else desc
        e_ast = item.expr
        if isinstance(e_ast, T.NumberLit):  # ordinal
            idx = int(e_ast.text) - 1
            if not (0 <= idx < len(fields)):
                raise AnalysisError("ORDER BY ordinal out of range")
            if fields[idx].form is not None:
                raise AnalysisError(
                    "ORDER BY on array/map/row values is not "
                    "supported")
            sort_keys.append(fields[idx].symbol)
        elif isinstance(e_ast, T.Identifier) and len(e_ast.parts) == 1 \
                and e_ast.parts[0] in alias_to_symbol:
            sort_keys.append(alias_to_symbol[e_ast.parts[0]])
        elif _ast_key(e_ast) in item_key_to_symbol:
            sort_keys.append(item_key_to_symbol[_ast_key(e_ast)])
        else:
            e = fold_constants(an.analyze(e_ast))
            sym = ctx.symbols.new("sortkey")
            hidden.append((sym, e, an.dictionary_of(e)))
            sort_keys.append(sym)
        sort_desc.append(desc)
        sort_nf.append(nf)

    form_syms = {f.symbol for f in fields if f.form is not None}
    if form_syms & set(sort_keys):
        raise AnalysisError(
            "ORDER BY on array/map/row values is not supported")

    proj_assigns = assignments + [(s, e) for s, e, _ in hidden]
    proj_fields = tuple(
        assign_fields + [N.Field(s, e.type, d) for s, e, d in hidden])
    node = N.ProjectNode(rp.node, proj_assigns, proj_fields)
    scope = Scope(fields + [ScopeField(None, s, s, e.type, d)
                            for s, e, d in hidden])
    rp = RelationPlan(node, scope)

    # 6. DISTINCT
    if spec.distinct:
        if hidden:
            raise AnalysisError("SELECT DISTINCT with ORDER BY over "
                                "non-output columns is not supported")
        if form_syms:
            raise AnalysisError(
                "SELECT DISTINCT over array/map/row values is not "
                "supported")
        rp = RelationPlan(N.DistinctNode(rp.node, proj_fields), rp.scope)

    # 7. ORDER BY / LIMIT
    limit = q.limit if q is not None else None
    offset = q.offset if q is not None else None
    if offset:
        raise AnalysisError("OFFSET not yet supported")
    out = _physical_fields(rp.scope.fields, rp.node)
    if sort_keys and limit is not None:
        rp = RelationPlan(N.TopNNode(rp.node, limit, sort_keys, sort_desc,
                                     sort_nf, out), rp.scope)
    elif sort_keys:
        rp = RelationPlan(N.SortNode(rp.node, sort_keys, sort_desc,
                                     sort_nf, out), rp.scope)
    elif limit is not None:
        rp = RelationPlan(N.LimitNode(rp.node, limit, out), rp.scope)

    # 8. drop hidden sort columns
    if hidden:
        select_syms = {a[0] for a in assignments} \
            | {f.symbol for f in fields if f.form is not None}
        keep = [f for f in rp.scope.fields if f.symbol in select_syms]
        out2 = _physical_fields(keep, rp.node)
        node = N.ProjectNode(
            rp.node, [(f.symbol, InputRef(f.symbol, f.type))
                      for f in out2], out2)
        rp = RelationPlan(node, Scope(keep))
    return rp, names


def _derive_name(e: T.Node) -> str:
    if isinstance(e, T.Identifier):
        return e.parts[-1]
    if isinstance(e, T.FunctionCall):
        return e.name
    return "_col"


def _contains_agg(node) -> bool:
    if isinstance(node, T.FunctionCall):
        if node.name in AGG_FUNCTIONS and node.window is None:
            return True
    if isinstance(node, (T.ScalarSubquery, T.InSubquery, T.Exists)):
        return False  # aggs inside subqueries don't count
    if isinstance(node, T.Node):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, T.Node) and _contains_agg(v):
                return True
            if isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, T.Node) and _contains_agg(x):
                        return True
                    if isinstance(x, tuple):
                        for y in x:
                            if isinstance(y, T.Node) \
                                    and _contains_agg(y):
                                return True
    return False


def _collect_agg_calls(node, out: List[T.FunctionCall]):
    if isinstance(node, T.FunctionCall) and node.name in AGG_FUNCTIONS \
            and node.window is None:
        out.append(node)
        return  # no nested aggs
    if isinstance(node, (T.ScalarSubquery, T.InSubquery, T.Exists)):
        return
    if isinstance(node, T.Node):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, T.Node):
                _collect_agg_calls(v, out)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, T.Node):
                        _collect_agg_calls(x, out)
                    elif isinstance(x, tuple):
                        for y in x:
                            if isinstance(y, T.Node):
                                _collect_agg_calls(y, out)


def _agg_output_type(fn: str, arg_type: Optional[Type]) -> Type:
    if fn == "array_agg":
        from presto_tpu_torch.types import array_type
        if arg_type is None:
            raise AnalysisError("array_agg requires an argument")
        return array_type(arg_type)
    if fn in ("count", "count_if", "checksum", "approx_distinct"):
        return BIGINT
    if fn in ("avg", "var_samp", "var_pop", "variance", "stddev",
              "stddev_samp", "stddev_pop", "geometric_mean",
              "approx_percentile", "skewness", "kurtosis", "entropy"):
        return DOUBLE
    if fn in ("bool_and", "bool_or", "every"):
        return BOOLEAN
    if fn == "sum":
        if arg_type is None:
            raise AnalysisError("sum requires an argument")
        if arg_type.is_decimal:
            return decimal_type(18, arg_type.scale)
        if arg_type.is_integer:
            return BIGINT
        return DOUBLE
    # min/max/arbitrary/any_value preserve type
    if arg_type is None:
        raise AnalysisError(f"{fn} requires an argument")
    return arg_type


#: ranking / positional window functions (aggregates also allowed OVER)
WINDOW_FUNCTIONS = {"rank", "dense_rank", "row_number", "lag", "lead",
                    "first_value", "last_value", "ntile",
                    "percent_rank", "cume_dist", "nth_value"}


def _collect_window_calls(node, out: List[T.FunctionCall]):
    if isinstance(node, T.FunctionCall) and node.window is not None:
        if not any(_ast_key(node) == _ast_key(o) for o in out):
            out.append(node)
        return  # no windows nested inside window arguments
    if isinstance(node, (T.ScalarSubquery, T.InSubquery, T.Exists)):
        return
    if isinstance(node, T.Node):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, T.Node):
                _collect_window_calls(v, out)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, T.Node):
                        _collect_window_calls(x, out)


def _parse_frame_bound(s: str, is_start: bool):
    """Parser bound string -> kernel encoding ("u" | "c" | signed
    offset; PRECEDING is negative)."""
    if s == "unbounded preceding":
        if not is_start:
            raise AnalysisError(
                "frame end cannot be UNBOUNDED PRECEDING")
        return "u"
    if s == "unbounded following":
        if is_start:
            raise AnalysisError(
                "frame start cannot be UNBOUNDED FOLLOWING")
        return "u"
    if s == "current row":
        return "c"
    n_str, _, kind = s.rpartition(" ")
    try:
        n = float(n_str)
        n = int(n) if n == int(n) else n
    except ValueError:
        raise AnalysisError(f"invalid frame bound {s!r}") from None
    if n < 0:
        raise AnalysisError("frame offset must be non-negative")
    return -n if kind == "preceding" else n


def _window_frame(w: T.WindowSpec):
    """Frame clause -> (mode, start, end) for the kernel (reference:
    WindowFrame defaults in SqlBase.g4 / StatementAnalyzer: RANGE
    UNBOUNDED PRECEDING..CURRENT ROW when ORDER BY is present)."""
    if not w.order_by:
        return ("rows", "u", "u")
    if w.frame is None:
        return ("range", "u", "c")
    ftype, start, end = w.frame
    fs = _parse_frame_bound(start, True)
    fe = _parse_frame_bound(end, False)
    if ftype == "rows":
        if any(isinstance(b, float) for b in (fs, fe)):
            raise AnalysisError("ROWS frame offsets must be integers")
    return (ftype, fs, fe)


def _plan_windows(calls: List[T.FunctionCall], rp: RelationPlan,
                  ctx: PlannerContext, rewrites):
    """Plan one WindowNode per distinct OVER() spec, chained; returns
    the new relation plan plus rewrites mapping each call's AST to its
    output symbol (consumed by the SELECT/ORDER BY analyzers)."""
    from presto_tpu_torch.ops import window as wk

    groups: Dict[tuple, List[T.FunctionCall]] = {}
    for c in calls:
        groups.setdefault(_ast_key(c.window), []).append(c)

    node = rp.node
    scope_fields = list(rp.scope.fields)
    out_rewrites: Dict[tuple, Tuple[str, Type, Optional[tuple]]] = {}

    for group in groups.values():
        w = group[0].window
        an = _Analyzer(Scope(scope_fields, rp.scope.parent), ctx,
                       rewrites)
        assignments = [(f.symbol, InputRef(f.symbol, f.type))
                       for f in scope_fields]
        proj_fields = [N.Field(f.symbol, f.type, f.dictionary)
                       for f in scope_fields]
        added: Dict[tuple, str] = {}

        def to_symbol(ast: T.Node, hint: str) -> str:
            e = fold_constants(an.analyze(ast))
            if isinstance(e, InputRef):
                return e.name
            key = _ast_key(ast)
            if key in added:
                return added[key]
            sym = ctx.symbols.new(hint)
            assignments.append((sym, e))
            proj_fields.append(N.Field(sym, e.type,
                                       an.dictionary_of(e)))
            added[key] = sym
            return sym

        part_syms = [to_symbol(p, "wpart") for p in w.partition_by]
        order_syms, desc, nf = [], [], []
        for item in w.order_by:
            order_syms.append(to_symbol(item.expr, "worder"))
            d = item.descending
            desc.append(d)
            nf.append(item.nulls_first if item.nulls_first is not None
                      else d)
        fmode, fstart, fend = _window_frame(w)

        def field_of(sym: str) -> N.Field:
            # proj_fields grows as to_symbol projects helper columns —
            # resolve at call time, not from a snapshot
            return next(f for f in proj_fields if f.symbol == sym)

        if fmode == "range" and (isinstance(fstart, (int, float))
                                 or isinstance(fend, (int, float))):
            # value-based RANGE offsets: SQL requires exactly one
            # numeric/date order key
            if len(order_syms) != 1:
                raise AnalysisError(
                    "RANGE with an offset requires exactly one ORDER "
                    "BY key")
            okt = field_of(order_syms[0])
            if okt.dictionary is not None or okt.type.is_string:
                raise AnalysisError(
                    "RANGE offsets require a numeric or date ORDER BY "
                    "key")

        def const_arg(ast, what: str):
            e = fold_constants(an.analyze(ast))
            if not isinstance(e, Literal):
                raise AnalysisError(f"{what} must be a constant")
            return e.value

        wcalls: List[N.WindowCall] = []
        call_fields: List[N.Field] = []
        for c in group:
            name = c.name
            if c.distinct:
                raise AnalysisError(
                    f"DISTINCT is not supported in window {name}")
            if name not in WINDOW_FUNCTIONS and \
                    name not in AGG_FUNCTIONS:
                raise AnalysisError(f"unknown window function {name}")
            offset = 1
            arg_sym = None
            filter_sym = None
            default = None
            is_agg = name in ("sum", "avg", "count", "min", "max")
            if c.filter is not None:
                if not is_agg:
                    raise AnalysisError(
                        "FILTER is only supported on aggregate window "
                        "functions")
                filter_sym = to_symbol(c.filter, "wfilter")
            if name in ("rank", "dense_rank", "row_number",
                        "percent_rank", "cume_dist"):
                if c.args:
                    raise AnalysisError(f"{name}() takes no arguments")
                out_type: Type = DOUBLE \
                    if name in ("percent_rank", "cume_dist") else BIGINT
                if name != "row_number" and not w.order_by:
                    raise AnalysisError(f"{name} requires ORDER BY")
            elif name == "ntile":
                if len(c.args) != 1:
                    raise AnalysisError("ntile(n) takes one argument")
                n_val = const_arg(c.args[0], "ntile bucket count")
                if not isinstance(n_val, int) or n_val <= 0:
                    raise AnalysisError(
                        "ntile bucket count must be a positive integer")
                offset = n_val
                out_type = BIGINT
            elif name in ("lag", "lead", "first_value", "last_value",
                          "nth_value"):
                if not c.args:
                    raise AnalysisError(f"{name} requires an argument")
                if not w.order_by:
                    raise AnalysisError(f"{name} requires ORDER BY")
                arg_sym = to_symbol(c.args[0], name)
                if name == "nth_value":
                    if len(c.args) != 2:
                        raise AnalysisError(
                            "nth_value(x, n) takes two arguments")
                    n_val = const_arg(c.args[1], "nth_value position")
                    if not isinstance(n_val, int) or n_val <= 0:
                        raise AnalysisError(
                            "nth_value position must be a positive "
                            "integer")
                    offset = n_val
                if name in ("lag", "lead") and len(c.args) > 1:
                    offset = const_arg(c.args[1], f"{name} offset")
                    if not isinstance(offset, int):
                        raise AnalysisError(
                            f"{name} offset must be an integer")
                if name in ("lag", "lead") and len(c.args) > 2:
                    default = const_arg(c.args[2],
                                        f"{name} default value")
                    af = field_of(arg_sym)
                    if default is not None:
                        if af.dictionary is not None:
                            if not isinstance(default, str):
                                raise AnalysisError(
                                    f"{name} default must be a string "
                                    "for a varchar argument")
                        elif isinstance(default, str):
                            raise AnalysisError(
                                f"{name} default type does not match "
                                "the argument")
                        elif isinstance(default, float) \
                                and af.type.np_dtype.kind in "iu":
                            if default != int(default):
                                raise AnalysisError(
                                    f"{name} default must be integral "
                                    "for an integer argument")
                            default = int(default)
                out_type = field_of(arg_sym).type
            else:  # aggregate OVER
                if not is_agg:
                    raise AnalysisError(
                        f"{name} is not supported as a window function")
                if c.is_star or not c.args:
                    arg_type = None
                    if name != "count":
                        raise AnalysisError(f"{name} requires an "
                                            "argument")
                else:
                    a_ast = c.args[0]
                    e = fold_constants(an.analyze(a_ast))
                    if name == "avg" and e.type.is_decimal:
                        a_ast = T.Cast(a_ast, "double")
                    arg_sym = to_symbol(a_ast, name)
                    arg_type = field_of(arg_sym).type
                out_type = _agg_output_type(name, arg_type)
            sym = ctx.symbols.new(name)
            dic = field_of(arg_sym).dictionary \
                if arg_sym and out_type.is_string else None
            if isinstance(default, str) and dic is not None \
                    and default not in dic:
                # the output dictionary grows to hold the default;
                # input codes stay valid under suffix extension
                dic = tuple(dic) + (default,)
            wcalls.append(N.WindowCall(
                sym, name, arg_sym, fmode, out_type, offset,
                frame_start=fstart, frame_end=fend, filter=filter_sym,
                default=default))
            call_fields.append(N.Field(sym, out_type, dic))
            out_rewrites[_ast_key(c)] = (sym, out_type, dic)

        node = N.ProjectNode(node, assignments, tuple(proj_fields))
        node = N.WindowNode(node, part_syms, order_syms, desc, nf,
                            wcalls, tuple(proj_fields)
                            + tuple(call_fields))
        # call outputs join the scope (resolved only through rewrites);
        # projected helper symbols stay hidden but remain addressable
        # through the WindowNode's output until pruned
        scope_fields = scope_fields + [
            ScopeField(None, f.symbol, f.symbol, f.type, f.dictionary)
            for f in call_fields]

    return RelationPlan(node, Scope(scope_fields, rp.scope.parent)), \
        out_rewrites


def _resolve_group_item(g, select_items, rp: RelationPlan):
    """A GROUP BY item may be an ordinal, a select alias, or an
    expression over the source scope."""
    if isinstance(g, T.NumberLit):
        idx = int(g.text) - 1
        if not (0 <= idx < len(select_items)):
            raise AnalysisError("GROUP BY ordinal out of range")
        return select_items[idx].expr
    if isinstance(g, T.Identifier) and len(g.parts) == 1:
        # select alias or input column; alias wins only if not a col
        try:
            rp.scope.resolve(g.parts)
        except AnalysisError:
            match = [i for i in select_items if i.alias == g.parts[0]]
            if match:
                return match[0].expr
    return g


def _expand_grouping_sets(group_by) -> List[List]:
    """GROUP BY elements -> the list of grouping sets (each a list of
    item ASTs): the cross-product concatenation of each element's sets
    per the SQL spec (plain expr = one single-item set; ROLLUP(e1..en) =
    prefixes longest-first; CUBE = power set; GROUPING SETS as given)."""
    per_elem: List[List[List]] = []
    for g in group_by:
        if not isinstance(g, T.GroupingSetsSpec):
            per_elem.append([[g]])
        elif g.kind == "rollup":
            per_elem.append([list(g.items[:i])
                             for i in range(len(g.items), -1, -1)])
        elif g.kind == "cube":
            n = len(g.items)
            if n > 10:
                raise AnalysisError("CUBE over more than 10 columns")
            per_elem.append([
                [e for i, e in enumerate(g.items) if mask >> i & 1]
                for mask in range((1 << n) - 1, -1, -1)])
        else:
            per_elem.append([list(s) for s in g.items])
    sets: List[List] = [[]]
    for elem in per_elem:
        # cap checked per accumulation step: materializing the full
        # cross product first would let CUBE x CUBE build millions of
        # lists before a rejection
        if len(sets) * len(elem) > 64:
            raise AnalysisError("too many grouping sets (max 64)")
        sets = [s + e for s in sets for e in elem]
    return sets


def _collect_grouping_calls(node, out: List[T.FunctionCall]):
    if isinstance(node, T.FunctionCall):
        if node.name == "grouping" and node.window is None:
            out.append(node)
            return
        if node.name in AGG_FUNCTIONS and node.window is None:
            return  # grouping() never nests inside aggregates
    if isinstance(node, (T.ScalarSubquery, T.InSubquery, T.Exists)):
        return
    if isinstance(node, T.Node):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, T.Node):
                _collect_grouping_calls(v, out)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, T.Node):
                        _collect_grouping_calls(x, out)


def _collected_array_form(sym: str, atype, w: int):
    """The value form of an array_agg output: W element slots plus a
    length column, all produced by the ArrayAggOperator under the
    <sym>__a{j}/<sym>__len naming convention."""
    from presto_tpu_torch.expr.ir import ArrayValue
    elems = tuple(InputRef(f"{sym}__a{j}", atype.element)
                  for j in range(w))
    return ArrayValue(elems, InputRef(f"{sym}__len", BIGINT), atype)


def _collected_map_form(sym: str, mtype, w: int,
                        key_dic: Optional[tuple],
                        val_dic: Optional[tuple]):
    from presto_tpu_torch.expr.ir import MapValue
    keys = tuple(InputRef(f"{sym}__k{j}", mtype.key) for j in range(w))
    vals = tuple(InputRef(f"{sym}__v{j}", mtype.value)
                 for j in range(w))
    form = MapValue(keys, vals, InputRef(f"{sym}__len", BIGINT), mtype)
    dicts = {}
    if key_dic is not None:
        dicts.update({f"{sym}__k{j}": key_dic for j in range(w)})
    if val_dic is not None:
        dicts.update({f"{sym}__v{j}": val_dic for j in range(w)})
    return form, dicts


def _lower_complex_projection(e, sym: str, an, assignments,
                              assign_fields):
    """Explode an analysis-time complex value into scalar slot
    assignments (<sym>__a0.., <sym>__len, ...) and return the same
    value form rebuilt over InputRefs to those slots — the projected
    column representation of ARRAY/MAP/ROW (see nodes.Field.form)."""
    from presto_tpu_torch.expr.ir import ArrayValue, MapValue, RowValue

    def slot(sub, tag: str):
        if isinstance(sub, (ArrayValue, MapValue, RowValue)):
            raise AnalysisError(
                "nested array/map/row projection is not supported")
        ssym = f"{sym}__{tag}"
        assignments.append((ssym, sub))
        assign_fields.append(
            N.Field(ssym, sub.type, an.dictionary_of(sub)))
        return InputRef(ssym, sub.type)

    def length_ref(length):
        if length is None:
            return None
        return slot(_coerce_to(length, BIGINT), "len")

    if isinstance(e, ArrayValue):
        elems = tuple(slot(x, f"a{j}") for j, x in
                      enumerate(e.elements))
        return ArrayValue(elems, length_ref(e.length), e.type)
    if isinstance(e, MapValue):
        keys = tuple(slot(x, f"k{j}") for j, x in enumerate(e.keys))
        vals = tuple(slot(x, f"v{j}") for j, x in enumerate(e.values))
        return MapValue(keys, vals, length_ref(e.length), e.type)
    flds = tuple((fname, slot(x, f"f{j}")) for j, (fname, x)
                 in enumerate(e.fields))
    return RowValue(flds, e.type)


def _plan_aggregation(spec: T.QuerySpec, select_items, order_items,
                      rp: RelationPlan, ctx: PlannerContext):
    an = _Analyzer(rp.scope, ctx)
    # expand GROUPING SETS/ROLLUP/CUBE; the unique key expressions
    # across all sets (first-appearance order) become the key columns
    sets = _expand_grouping_sets(spec.group_by)
    multi = len(sets) > 1
    key_asts: List = []
    seen_keys: set = set()
    set_keys: List[List[tuple]] = []  # per set: ast keys present
    for s in sets:
        present = []
        for g in s:
            g_ast = _resolve_group_item(g, select_items, rp)
            k = _ast_key(g_ast)
            if k not in seen_keys:
                seen_keys.add(k)
                key_asts.append(g_ast)
            if k not in present:
                present.append(k)
        set_keys.append(present)

    keys: List[Tuple[str, RowExpression, Optional[tuple], tuple]] = []
    for g_ast in key_asts:
        e = fold_constants(an.analyze(g_ast))
        sym = ctx.symbols.new(_derive_name(g_ast))
        keys.append((sym, e, an.dictionary_of(e), _ast_key(g_ast)))

    extra_rewrites: Dict[tuple, Tuple[str, Type, Optional[tuple]]] = {}
    if multi:
        rp, an, keys, extra_rewrites = _plan_group_id(
            spec, select_items, order_items, rp, ctx, keys, set_keys)
    else:
        # grouping() over a single grouping set is the constant 0
        # (nothing is ever rolled up); plan it as a constant key so the
        # ordinary rewrite machinery applies
        gcalls: List[T.FunctionCall] = []
        for i in select_items:
            _collect_grouping_calls(i.expr, gcalls)
        if spec.having is not None:
            _collect_grouping_calls(spec.having, gcalls)
        for o in order_items:
            _collect_grouping_calls(o.expr, gcalls)
        for c in gcalls:
            ck = _ast_key(c)
            if ck in extra_rewrites:
                continue
            sym = ctx.symbols.new("grouping")
            keys.append((sym, Literal(0, BIGINT), None,
                         ("#grouping", sym)))
            extra_rewrites[ck] = (sym, BIGINT, None)

    # aggregate calls from select + having + order by
    calls: List[T.FunctionCall] = []
    for i in select_items:
        _collect_agg_calls(i.expr, calls)
    if spec.having is not None:
        _collect_agg_calls(spec.having, calls)
    for o in order_items:
        _collect_agg_calls(o.expr, calls)

    # DISTINCT aggregates (e.g. Q16's count(distinct suppkey)): insert a
    # pre-aggregation producing the distinct (group keys, arg) rows, then
    # aggregate plainly on top (the reference reaches the same shape via
    # MarkDistinctOperator; a grouped pre-distinct is the streaming-
    # kernel-friendly equivalent).
    distinct_calls = [c for c in calls if c.distinct]
    dsym = d_t = d_dic = None
    if distinct_calls:
        if any(c.is_star or not c.args for c in distinct_calls):
            raise AnalysisError("DISTINCT aggregate requires an "
                                "argument")
        if any(c.name == "approx_percentile" for c in distinct_calls):
            # the distinct-planning branches carry only the first
            # argument — a sketch over DISTINCT values is also not a
            # meaningful percentile
            raise AnalysisError(
                "approx_percentile does not support DISTINCT")
        if any(c.filter is not None for c in distinct_calls):
            raise AnalysisError(
                "FILTER with DISTINCT aggregates is not supported")
        argkeys = {_ast_key(c.args[0]) for c in distinct_calls}
        if any(not c.distinct for c in calls) or len(argkeys) != 1:
            rp_md, rw_md = _plan_mixed_distinct(keys, calls, rp, ctx, an)
            # grouping()/gid columns were planned as keys; the branch
            # join renamed every key, so route each grouping() AST to
            # the renamed symbol via its sentinel key
            for ck, (sym, t, d) in extra_rewrites.items():
                repl = rw_md.get(("#grouping", sym))
                rw_md[ck] = repl if repl is not None else (sym, t, d)
            return rp_md, rw_md
        arg0 = fold_constants(an.analyze(distinct_calls[0].args[0]))
        d_t, d_dic = arg0.type, an.dictionary_of(arg0)
        dsym = ctx.symbols.new("distinct_arg")
        pre_fields = tuple(
            [N.Field(s, e.type, d) for s, e, d, _ in keys]
            + [N.Field(dsym, d_t, d_dic)])
        pre = N.AggregationNode(
            rp.node, [(s, e) for s, e, _, _ in keys] + [(dsym, arg0)],
            [], "single", pre_fields)
        pre_scope = Scope(
            [ScopeField(None, s, s, e.type, d) for s, e, d, _ in keys]
            + [ScopeField(None, dsym, dsym, d_t, d_dic)],
            rp.scope.parent)
        rp = RelationPlan(pre, pre_scope)
        an = _Analyzer(rp.scope, ctx)
        # the outer aggregation re-groups the pre-distinct rows by the
        # (already computed) key columns
        keys = [(s, InputRef(s, e.type), d, k) for s, e, d, k in keys]

    agg_nodes: List[N.AggCall] = []
    rewrites: Dict[tuple, Tuple[str, Type, Optional[tuple]]] = {}
    agg_forms: Dict[str, object] = {}  # out symbol -> value form
    for c in calls:
        key = _ast_key(c)
        if key in rewrites:
            continue
        filt = None
        if c.filter is not None:
            if c.distinct:
                raise AnalysisError(
                    "FILTER with DISTINCT aggregates is not supported")
            filt = _coerce_to(fold_constants(an.analyze(c.filter)),
                              BOOLEAN)
        params: tuple = ()
        arg2 = None
        if c.name == "map_agg":
            if c.distinct or len(c.args) != 2:
                raise AnalysisError("map_agg takes (key, value)")
            arg = fold_constants(an.analyze(c.args[0]))
            arg2 = fold_constants(an.analyze(c.args[1]))
            arg_t, dic = arg.type, an.dictionary_of(arg)
        elif c.distinct:
            arg, arg_t, dic = InputRef(dsym, d_t), d_t, d_dic
        elif c.is_star or not c.args:
            arg, arg_t, dic = None, None, None
        else:
            arg, params = _agg_arg_and_params(c, an)
            arg_t, dic = arg.type, an.dictionary_of(arg)
        if c.name == "map_agg":
            from presto_tpu_torch.types import map_type
            out_t = map_type(arg_t, arg2.type)
        else:
            out_t = _agg_output_type(c.name, arg_t)
        sym = ctx.symbols.new(c.name)
        agg_nodes.append(N.AggCall(sym, c.name, arg, False, out_t,
                                   params=params, filter=filt,
                                   argument2=arg2))
        out_dic = dic if c.name in ("min", "max", "arbitrary",
                                    "any_value") else None
        if c.name in ("array_agg", "map_agg"):
            from presto_tpu_torch.session_properties import get_property
            w = int(get_property(ctx.session.properties,
                                 "array_agg_width"))
            if c.name == "array_agg":
                agg_forms[sym] = (
                    _collected_array_form(sym, out_t, w), None)
                out_dic = dic  # slot columns share the element dict
            else:
                agg_forms[sym] = _collected_map_form(
                    sym, out_t, w, dic, an.dictionary_of(arg2))
                out_dic = dic
        rewrites[key] = (sym, out_t, out_dic)

    out_fields = tuple(
        [N.Field(s, e.type, d) for s, e, d, _ in keys]
        + [N.Field(a.out_symbol, a.output_type,
                   rewrites[_ast_key_for_sym(rewrites, a.out_symbol)][2]
                   if _ast_key_for_sym(rewrites, a.out_symbol) else None,
                   form=agg_forms.get(a.out_symbol, (None,))[0],
                   form_dicts=agg_forms.get(a.out_symbol,
                                            (None, None))[1])
           for a in agg_nodes])
    node = N.AggregationNode(
        rp.node, [(s, e) for s, e, _, _ in keys], agg_nodes, "single",
        out_fields)
    # new scope: key symbols keep their source name; agg outputs
    fields = [ScopeField(None, s, s, e.type, d)
              for s, e, d, _ in keys]
    for a, f in zip(agg_nodes, out_fields[len(keys):]):
        fields.append(ScopeField(
            None, a.out_symbol, a.out_symbol, a.output_type,
            f.dictionary,
            form=agg_forms.get(a.out_symbol, (None,))[0],
            form_dicts=agg_forms.get(a.out_symbol, (None, None))[1]))
    new_scope = Scope(fields, rp.scope.parent)
    # rewrites for outer expressions: group-key ASTs and agg-call ASTs
    final_rewrites: Dict[tuple, Tuple[str, Type, Optional[tuple]]] = {}
    for s, e, d, k in keys:
        final_rewrites[k] = (s, e.type, d)
    final_rewrites.update(rewrites)
    final_rewrites.update(extra_rewrites)  # grouping(...) -> gid column
    return RelationPlan(node, new_scope), final_rewrites


def _plan_group_id(spec, select_items, order_items, rp: RelationPlan,
                   ctx: PlannerContext, keys, set_keys):
    """Insert Project (materialize key columns) + GroupIdNode below the
    aggregation for multi-set grouping. Returns the updated relation,
    analyzer, key list (key copies + gid + grouping() columns — all
    ordinary aggregation keys), and the grouping()-call rewrites."""
    src_fields = tuple(rp.node.output)
    proj_assign = [(f.symbol, InputRef(f.symbol, f.type))
                   for f in src_fields] \
        + [(s, e) for s, e, _, _ in keys]
    proj_fields = src_fields + tuple(
        N.Field(s, e.type, d) for s, e, d, _ in keys)
    proj = N.ProjectNode(rp.node, proj_assign, proj_fields)

    keymap = {k: s for s, _, _, k in keys}
    groupings = [tuple(keymap[k] for k in present)
                 for present in set_keys]
    gid_sym = ctx.symbols.new("groupid")

    # grouping(...) calls -> per-set constant bitmask columns
    gcalls: List[T.FunctionCall] = []
    for i in select_items:
        _collect_grouping_calls(i.expr, gcalls)
    if spec.having is not None:
        _collect_grouping_calls(spec.having, gcalls)
    for o in order_items:
        _collect_grouping_calls(o.expr, gcalls)
    grouping_outputs: List[Tuple[str, Tuple[int, ...]]] = []
    extra_rewrites: Dict[tuple, Tuple[str, Type, Optional[tuple]]] = {}
    for c in gcalls:
        ck = _ast_key(c)
        if ck in extra_rewrites:
            continue
        arg_syms = []
        for a in c.args:
            ak = _ast_key(_resolve_group_item(a, select_items, rp))
            if ak not in keymap:
                raise AnalysisError(
                    "grouping() arguments must be grouping columns")
            arg_syms.append(keymap[ak])
        vals = []
        for present in groupings:
            v = 0
            for a_sym in arg_syms:
                v = (v << 1) | (0 if a_sym in present else 1)
            vals.append(v)
        gsym = ctx.symbols.new("grouping")
        grouping_outputs.append((gsym, tuple(vals)))
        extra_rewrites[ck] = (gsym, BIGINT, None)

    out_fields = proj_fields + tuple(
        [N.Field(gid_sym, BIGINT, None)]
        + [N.Field(gs, BIGINT, None) for gs, _ in grouping_outputs])
    gnode = N.GroupIdNode(proj, groupings,
                          tuple(s for s, _, _, _ in keys), gid_sym,
                          grouping_outputs, out_fields)
    rp2 = RelationPlan(gnode, rp.scope)
    an2 = _Analyzer(rp2.scope, ctx)
    # key copies (now materialized input columns) + gid + grouping()
    # columns all become ordinary aggregation keys; the sentinel ast
    # keys can never collide with a real expression's key
    new_keys = [(s, InputRef(s, e.type), d, k) for s, e, d, k in keys]
    new_keys.append((gid_sym, InputRef(gid_sym, BIGINT), None,
                     ("#groupid", gid_sym)))
    for gs, _v in grouping_outputs:
        new_keys.append((gs, InputRef(gs, BIGINT), None,
                         ("#grouping", gs)))
    return rp2, an2, new_keys, extra_rewrites


def _ast_key_for_sym(rewrites, sym):
    for k, (s, _, _) in rewrites.items():
        if s == sym:
            return k
    return None


def _default_literal(t: Type) -> Literal:
    if t.is_string:
        return Literal("", t)
    if t.name == "boolean":
        return Literal(False, t)
    if t.is_floating:
        return Literal(0.0, t)
    return Literal(0, t)


def _plan_mixed_distinct(keys, calls, rp: RelationPlan,
                         ctx: PlannerContext, an: "_Analyzer"):
    """Mixed plain + DISTINCT aggregates, and/or several different
    DISTINCT arguments: plan one aggregation branch per input stream —
    the plain branch over raw rows, one pre-distinct branch per distinct
    argument — and join the per-group results back on the group keys.
    Joins compare keys null-safely through (is_null, coalesce) pairs so
    NULL key groups survive (GROUP BY treats NULL as a group; a plain
    equi-join would drop it). The reference reaches the same result with
    MarkDistinctOperator masks (operator/MarkDistinctOperator.java); the
    branch-join shape keeps every branch on the streaming agg kernels,
    and the shared source subtree executes once (planner CSE spools it
    locally; the fragmenter gives it one producer fragment on a mesh)."""
    source_node = rp.node
    rewrites: Dict[tuple, Tuple[str, Type, Optional[tuple]]] = {}
    branches: List[Tuple[N.PlanNode, List[str]]] = []

    def key_fields(syms):
        return [N.Field(s2, e.type, d) for s2, (_, e, d, _)
                in zip(syms, keys)]

    # -- plain branch ------------------------------------------------------
    plain_aggs: List[N.AggCall] = []
    agg_fields: List[N.Field] = []
    for c in calls:
        if c.distinct or _ast_key(c) in rewrites:
            continue
        filt = None
        if c.filter is not None:
            filt = _coerce_to(fold_constants(an.analyze(c.filter)),
                              BOOLEAN)
        params: tuple = ()
        if c.is_star or not c.args:
            arg, arg_t, dic = None, None, None
        else:
            arg, params = _agg_arg_and_params(c, an)
            arg_t, dic = arg.type, an.dictionary_of(arg)
        out_t = _agg_output_type(c.name, arg_t)
        sym = ctx.symbols.new(c.name)
        plain_aggs.append(N.AggCall(sym, c.name, arg, False, out_t,
                                    params=params, filter=filt))
        out_dic = dic if c.name in ("min", "max", "arbitrary",
                                    "any_value") else None
        agg_fields.append(N.Field(sym, out_t, out_dic))
        rewrites[_ast_key(c)] = (sym, out_t, out_dic)
    if plain_aggs:
        ksyms = [ctx.symbols.new("k") for _ in keys]
        node = N.AggregationNode(
            source_node,
            [(s2, e) for s2, (_, e, _, _) in zip(ksyms, keys)],
            plain_aggs, "single",
            tuple(key_fields(ksyms)) + tuple(agg_fields))
        branches.append((node, ksyms))

    # -- one pre-distinct branch per distinct argument ---------------------
    dgroups: Dict[tuple, List[T.FunctionCall]] = {}
    for c in calls:
        if c.distinct:
            dgroups.setdefault(_ast_key(c.args[0]), []).append(c)
    for group in dgroups.values():
        arg0 = fold_constants(an.analyze(group[0].args[0]))
        d_t, d_dic = arg0.type, an.dictionary_of(arg0)
        ds = ctx.symbols.new("distinct_arg")
        ksyms = [ctx.symbols.new("k") for _ in keys]
        pre_fields = tuple(key_fields(ksyms)) + (N.Field(ds, d_t,
                                                         d_dic),)
        pre = N.AggregationNode(
            source_node,
            [(s2, e) for s2, (_, e, _, _) in zip(ksyms, keys)]
            + [(ds, arg0)], [], "single", pre_fields)
        aggs, afields = [], []
        for c in group:
            if _ast_key(c) in rewrites:
                continue
            out_t = _agg_output_type(c.name, d_t)
            sym = ctx.symbols.new(c.name)
            aggs.append(N.AggCall(sym, c.name, InputRef(ds, d_t),
                                  False, out_t))
            out_dic = d_dic if c.name in ("min", "max", "arbitrary",
                                          "any_value") else None
            afields.append(N.Field(sym, out_t, out_dic))
            rewrites[_ast_key(c)] = (sym, out_t, out_dic)
        outer = N.AggregationNode(
            pre,
            [(s2, InputRef(s2, e.type))
             for s2, (_, e, _, _) in zip(ksyms, keys)],
            aggs, "single", tuple(key_fields(ksyms)) + tuple(afields))
        branches.append((outer, ksyms))

    # -- join the branches on null-safe group keys -------------------------
    def null_safe(node: N.PlanNode, ksyms):
        assigns = [(f.symbol, InputRef(f.symbol, f.type))
                   for f in node.output]
        out = list(node.output)
        scope2 = Scope([ScopeField(None, f.symbol, f.symbol, f.type,
                                   f.dictionary) for f in node.output])
        an2 = _Analyzer(scope2, ctx)
        flags, vals = [], []
        for s2 in ksyms:
            f = node.field(s2)
            fs = ctx.symbols.new("knull")
            assigns.append((fs, SpecialForm(
                "is_null", (InputRef(s2, f.type),), BOOLEAN)))
            out.append(N.Field(fs, BOOLEAN))
            flags.append(fs)
            vs = ctx.symbols.new("kval")
            e = SpecialForm("coalesce", (InputRef(s2, f.type),
                                         _default_literal(f.type)),
                            f.type)
            assigns.append((vs, e))
            out.append(N.Field(vs, f.type, an2.dictionary_of(e)))
            vals.append(vs)
        return N.ProjectNode(node, assigns, tuple(out)), flags, vals

    node, key_syms = branches[0]
    for bnode, bkeys in branches[1:]:
        if keys:
            left, lf, lv = null_safe(node, key_syms)
            right, rf, rv = null_safe(bnode, bkeys)
            criteria = list(zip(lf, rf)) + list(zip(lv, rv))
            node = N.JoinNode("inner", left, right, criteria,
                              tuple(left.output) + tuple(right.output))
        else:
            node = N.JoinNode("cross", node, bnode, [],
                              tuple(node.output) + tuple(bnode.output))

    # -- scope + rewrites --------------------------------------------------
    fields = [ScopeField(None, s, s2, e.type, d)
              for s2, (s, e, d, _) in zip(key_syms, keys)]
    for k_ast, (sym, t, dic) in rewrites.items():
        fields.append(ScopeField(None, sym, sym, t, dic))
    final_rewrites: Dict[tuple, Tuple[str, Type, Optional[tuple]]] = {}
    for s2, (_, e, d, k_ast) in zip(key_syms, keys):
        final_rewrites[k_ast] = (s2, e.type, d)
    final_rewrites.update(rewrites)
    return RelationPlan(node, Scope(fields, rp.scope.parent)), \
        final_rewrites


# ---------------------------------------------------------------------------
# FROM planning
# ---------------------------------------------------------------------------

def _plan_relation(rel: T.Node, ctx: PlannerContext,
                   outer: Optional[Scope]) -> RelationPlan:
    if isinstance(rel, T.Table):
        return _plan_table(rel, ctx, outer)
    un, un_alias, un_cols = _unwrap_unnest(rel)
    if un is not None:
        # standalone UNNEST (aliased or not); the alias names only the
        # unnested columns, unlike a subquery alias
        return _plan_unnest(un, None, ctx, outer, un_alias, un_cols)
    if isinstance(rel, T.AliasedRelation):
        inner = _plan_relation(rel.relation, ctx, outer)
        fields = []
        for i, f in enumerate(inner.scope.fields):
            name = f.name
            if rel.column_aliases:
                if i >= len(rel.column_aliases):
                    raise AnalysisError("too few column aliases")
                name = rel.column_aliases[i]
            fields.append(ScopeField(
                rel.alias, name, f.symbol, f.type, f.dictionary,
                form=f.form,
                form_dicts=getattr(f, "form_dicts", None)))
        return RelationPlan(inner.node, Scope(fields, outer))
    if isinstance(rel, T.SubqueryRelation):
        rp, names = plan_query(rel.query, ctx, outer)
        fields = [ScopeField(None, n, f.symbol, f.type, f.dictionary,
                             form=f.form,
                             form_dicts=getattr(f, "form_dicts", None))
                  for n, f in zip(names, rp.scope.fields)]
        return RelationPlan(rp.node, Scope(fields, outer))
    if isinstance(rel, T.Join):
        return _plan_join(rel, ctx, outer)
    if isinstance(rel, T.Unnest):
        return _plan_unnest(rel, None, ctx, outer, None, None)
    raise AnalysisError(f"unsupported relation {type(rel).__name__}")


def _unwrap_unnest(rel):
    """(unnest, alias, column_aliases) when `rel` is an UNNEST relation
    (possibly aliased), else (None, None, None)."""
    if isinstance(rel, T.Unnest):
        return rel, None, None
    if isinstance(rel, T.AliasedRelation) \
            and isinstance(rel.relation, T.Unnest):
        return rel.relation, rel.alias, rel.column_aliases
    return None, None, None


def _plan_unnest(un: T.Unnest, source: Optional[RelationPlan],
                 ctx: PlannerContext, outer: Optional[Scope],
                 alias: Optional[str],
                 col_aliases: Optional[List[str]]) -> RelationPlan:
    """UNNEST(ARRAY[...], ...) — lateral over `source` (the left side
    of the enclosing cross join; element expressions may reference its
    columns) or standalone over a one-row relation. Static array
    lengths make this pure replication (UnnestNode); zip semantics pad
    shorter arrays with NULL."""
    standalone = source is None
    if standalone:
        # a single synthetic row to replicate; its column stays out of
        # the visible scope (SELECT * shows only unnested columns)
        source, _ = _plan_values(
            T.ValuesRelation([[T.NumberLit("0")]]), ctx)
    from presto_tpu_torch.expr.ir import ArrayValue
    an = _Analyzer(source.scope, ctx)
    arrays: List[List[RowExpression]] = []
    lengths: List[Optional[RowExpression]] = []
    for a in un.args:
        av = an.analyze(a)
        if not isinstance(av, ArrayValue):
            raise AnalysisError(
                "UNNEST requires an array value (ARRAY[...] or an "
                "array-producing function like split)")
        if not av.elements:
            raise AnalysisError("cannot UNNEST an empty array")
        # (an all-NULL array's element type is coerced to BIGINT by
        #  _an_ArrayConstructor, so UNNEST(ARRAY[NULL]) emits one NULL
        #  row — Presto's behavior; pinned by tests/test_unnest.py)
        arrays.append(list(av.elements))
        lengths.append(av.length)

    src_fields = tuple(source.node.output)
    assigns = [(f.symbol, InputRef(f.symbol, f.type))
               for f in src_fields]
    proj_fields = list(src_fields)
    items: List[Tuple[str, List[str], Optional[str]]] = []
    new_fields: List[N.Field] = []
    for j, elems in enumerate(arrays):
        t = elems[0].type
        union_dict = None
        if t.is_string:
            vals: set = set()
            for e in elems:
                vals |= set(an.dictionary_of(e) or ())
            union_dict = tuple(sorted(vals))
        elem_syms = []
        for i, e in enumerate(elems):
            s = ctx.symbols.new(f"unnest_elem")
            assigns.append((s, e))
            proj_fields.append(N.Field(s, e.type,
                                       an.dictionary_of(e)))
            elem_syms.append(s)
        len_sym = None
        if lengths[j] is not None:
            # dynamic length (e.g. split): rows emit only their true
            # element count, not the static width
            len_sym = ctx.symbols.new("unnest_len")
            assigns.append((len_sym, lengths[j]))
            proj_fields.append(N.Field(len_sym, BIGINT, None))
        out_sym = ctx.symbols.new("unnest")
        items.append((out_sym, elem_syms, len_sym))
        new_fields.append(N.Field(out_sym, t, union_dict))
    ord_sym = None
    if un.ordinality:
        ord_sym = ctx.symbols.new("ordinality")
        new_fields.append(N.Field(ord_sym, BIGINT, None))
    proj = N.ProjectNode(source.node, assigns, tuple(proj_fields))
    out_fields = src_fields + tuple(new_fields)
    node = N.UnnestNode(proj, items, ord_sym, out_fields)

    n_named = len(arrays) + (1 if un.ordinality else 0)
    if col_aliases is not None and len(col_aliases) != n_named:
        raise AnalysisError(
            f"UNNEST alias needs {n_named} column names")
    names = col_aliases or (
        [f"col{j + 1}" for j in range(len(arrays))]
        + (["ordinality"] if un.ordinality else []))
    fields = [] if standalone else list(source.scope.fields)
    for f, name in zip(new_fields, names):
        fields.append(ScopeField(alias, name, f.symbol, f.type,
                                 f.dictionary))
    return RelationPlan(node, Scope(fields, outer))


def _plan_table(rel: T.Table, ctx: PlannerContext,
                outer: Optional[Scope]) -> RelationPlan:
    parts = rel.name
    if len(parts) == 1 and parts[0] in ctx.ctes:
        cte = ctx.ctes[parts[0]]
        # plan the CTE body fresh (no dedup/materialization yet)
        saved = dict(ctx.ctes)
        del ctx.ctes[parts[0]]  # no self-recursion
        try:
            rp, names = plan_query(cte.query, ctx, None)
        finally:
            ctx.ctes = saved
        col_names = cte.column_names or names
        fields = [ScopeField(parts[0], n, f.symbol, f.type, f.dictionary)
                  for n, f in zip(col_names, rp.scope.fields)]
        return RelationPlan(rp.node, Scope(fields, outer))
    handle, schema = ctx.metadata.resolve_table(parts, ctx.session)
    fields, assigns, out_fields = [], {}, []
    for col in schema.columns:
        if getattr(col, "form", None) is not None:
            # complex stored column: scan its physical slots under
            # fresh symbols and rebuild the value form over them
            slot_syms = {}
            form_dicts = {}
            for pname, ptype, pdic in col.physical():
                s = ctx.symbols.new(pname)
                assigns[s] = pname
                out_fields.append(N.Field(s, ptype, pdic))
                slot_syms[pname] = s
                if pdic is not None:
                    form_dicts[s] = pdic
            vsym = ctx.symbols.new(col.name)
            fields.append(ScopeField(
                parts[-1], col.name, vsym, col.type, col.dictionary,
                form=_rebind_form(col.form, slot_syms),
                form_dicts=form_dicts))
            continue
        sym = ctx.symbols.new(col.name)
        assigns[sym] = col.name
        fields.append(ScopeField(parts[-1], col.name, sym, col.type,
                                 col.dictionary))
        out_fields.append(N.Field(sym, col.type, col.dictionary))
    node = N.TableScanNode(handle, assigns, tuple(out_fields))
    return RelationPlan(node, Scope(fields, outer))


def _rebind_form(form, name_map: Dict[str, str]):
    """Rebuild a value form with its InputRef leaves renamed through
    `name_map` (stored column name -> scan symbol)."""
    from presto_tpu_torch.expr.ir import ArrayValue, MapValue

    def ren(x):
        return InputRef(name_map[x.name], x.type)

    if isinstance(form, ArrayValue):
        return ArrayValue(tuple(ren(e) for e in form.elements),
                          ren(form.length)
                          if form.length is not None else None,
                          form.type)
    if isinstance(form, MapValue):
        return MapValue(tuple(ren(e) for e in form.keys),
                        tuple(ren(e) for e in form.values),
                        ren(form.length)
                        if form.length is not None else None,
                        form.type)
    raise AnalysisError("row-typed stored columns are not supported")


def _split_conjuncts(e: T.Node) -> List[T.Node]:
    if isinstance(e, T.BinaryOp) and e.op == "and":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _plan_join(rel: T.Join, ctx: PlannerContext,
               outer: Optional[Scope]) -> RelationPlan:
    left = _plan_relation(rel.left, ctx, outer)
    un, un_alias, un_cols = _unwrap_unnest(rel.right)
    if un is not None:
        # lateral: element expressions see the left relation's columns
        if rel.join_type != "cross" or rel.on is not None or rel.using:
            raise AnalysisError(
                "UNNEST joins must be CROSS JOIN (comma) form")
        return _plan_unnest(un, left, ctx, outer, un_alias, un_cols)
    right = _plan_relation(rel.right, ctx, outer)
    combined = Scope(left.scope.fields + right.scope.fields, outer)
    out_fields = _physical_fields(combined.fields, left.node,
                                  right.node)
    jt = rel.join_type
    if jt == "cross" and rel.on is None and rel.using is None:
        node = N.JoinNode("cross", left.node, right.node, [], out_fields)
        return RelationPlan(node, combined)

    criteria: List[Tuple[str, str]] = []
    residual: List[T.Node] = []
    left_syms = {f.symbol for f in left.scope.fields}
    right_syms = {f.symbol for f in right.scope.fields}
    an = _Analyzer(combined, ctx)
    if rel.using:
        for col in rel.using:
            lf, _ = Scope(left.scope.fields).resolve((col,))
            rf, _ = Scope(right.scope.fields).resolve((col,))
            criteria.append((lf.symbol, rf.symbol))
    elif rel.on is not None:
        for conj in _split_conjuncts(rel.on):
            pair = _equi_pair(conj, an, left_syms, right_syms)
            if pair:
                criteria.append(pair)
            else:
                residual.append(conj)
    # classify residual ON-conjuncts: single-side ones filter that side
    # *before* the join (required for OUTER join semantics — a build-side
    # ON condition must not erase unmatched probe rows), mixed ones stay
    # as a post-join filter (inner joins only).
    left_pre: List[RowExpression] = []
    right_pre: List[RowExpression] = []
    mixed: List[RowExpression] = []
    from presto_tpu_torch.expr.ir import referenced_inputs
    for conj in residual:
        e = _coerce_to(an.analyze(conj), BOOLEAN)
        refs = referenced_inputs(e)
        if refs <= left_syms:
            left_pre.append(e)
        elif refs <= right_syms:
            right_pre.append(e)
        else:
            mixed.append(e)
    # prefiltering is only safe on the NON-preserved side: an ON
    # condition on the preserved side of an outer join must not drop
    # the preserved row, only suppress its matches
    ln, rn = left.node, right.node
    if left_pre and jt in ("inner", "cross", "right"):
        pred = left_pre[0]
        for p in left_pre[1:]:
            pred = SpecialForm("and", (pred, p), BOOLEAN)
        ln = N.FilterNode(ln, fold_constants(pred),
                          _physical_fields(left.scope.fields, ln))
    elif left_pre:
        mixed.extend(left_pre)  # preserved-side condition
    if right_pre and jt in ("inner", "cross", "left"):
        pred = right_pre[0]
        for p in right_pre[1:]:
            pred = SpecialForm("and", (pred, p), BOOLEAN)
        rn = N.FilterNode(rn, fold_constants(pred),
                          _physical_fields(right.scope.fields, rn))
    elif right_pre:
        mixed.extend(right_pre)
    res_expr = None
    if mixed:
        if jt != "inner" and jt != "cross":
            raise AnalysisError(
                "non-equi conditions across both sides of an outer "
                "join are not supported yet")
        pred = mixed[0]
        for p in mixed[1:]:
            pred = SpecialForm("and", (pred, p), BOOLEAN)
        res_expr = fold_constants(pred)
    if not criteria:
        if jt != "inner":
            raise AnalysisError("non-equi outer joins not supported yet")
        node = N.JoinNode("cross", ln, rn, [], out_fields, res_expr)
        return RelationPlan(node, combined)
    # string equi-keys: the executor re-encodes BOTH sides onto the
    # union dictionary before building/probing, so the join's output
    # key columns carry union-coded data — the output FIELD metadata
    # must say so too, or a downstream projection re-tags them with
    # the stale per-side dictionary and decodes garbage
    from presto_tpu_torch.batch import union_dictionary
    merged_dicts = {}
    for l, r in criteria:
        lf = combined.fields[[f.symbol for f in combined.fields]
                             .index(l)]
        rf = combined.fields[[f.symbol for f in combined.fields]
                             .index(r)]
        if lf.type.is_string or rf.type.is_string:
            merged_dicts[l] = merged_dicts[r] = union_dictionary(
                lf.dictionary, rf.dictionary)
    if merged_dicts:
        out_fields = tuple(
            N.Field(f.symbol, f.type,
                    merged_dicts.get(f.symbol, f.dictionary))
            for f in out_fields)
        # the scope drives select-list analysis — its dictionary
        # metadata must match the union-coded runtime columns too
        combined = Scope(
            [ScopeField(f.qualifier, f.name, f.symbol, f.type,
                        merged_dicts.get(f.symbol, f.dictionary))
             for f in combined.fields], outer)
    node = N.JoinNode(jt, ln, rn, criteria, out_fields, res_expr)
    return RelationPlan(node, combined)


def _equi_pair(conj: T.Node, an: "_Analyzer", left_syms, right_syms):
    if not (isinstance(conj, T.BinaryOp) and conj.op == "="):
        return None
    try:
        le = an.analyze(conj.left)
        re_ = an.analyze(conj.right)
    except AnalysisError:
        return None
    ls, rs = _as_symbol(le), _as_symbol(re_)
    if ls is None or rs is None:
        return None
    if ls in left_syms and rs in right_syms:
        return (ls, rs)
    if ls in right_syms and rs in left_syms:
        return (rs, ls)
    return None


# ---------------------------------------------------------------------------
# WHERE with subqueries
# ---------------------------------------------------------------------------

def _contains_subquery(node) -> bool:
    if isinstance(node, (T.ScalarSubquery, T.InSubquery, T.Exists)):
        return True
    if isinstance(node, T.Node):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, T.Node) and _contains_subquery(v):
                return True
            if isinstance(v, (list, tuple)):
                if any(isinstance(x, T.Node) and _contains_subquery(x)
                       for x in v):
                    return True
    return False


def _filter_on(rp: RelationPlan, conjs: List[T.Node],
               ctx: PlannerContext) -> RelationPlan:
    pred_ast = conjs[0]
    for c in conjs[1:]:
        pred_ast = T.BinaryOp("and", pred_ast, c)
    an = _Analyzer(rp.scope, ctx)
    pred = _coerce_to(an.analyze(pred_ast), BOOLEAN)
    out = _physical_fields(rp.scope.fields, rp.node)
    return RelationPlan(
        N.FilterNode(rp.node, fold_constants(pred), out), rp.scope)


def _plan_where(where: T.Node, rp: RelationPlan,
                ctx: PlannerContext) -> RelationPlan:
    """Plan conjuncts in three tiers: (1) subquery-free conjuncts as a
    Filter directly over the FROM tree — this keeps Filter(cross-join
    tree) adjacent so the optimizer's equi-join rewrite can see it
    (Q2/Q18 would otherwise cross-join the whole FROM list); then (2)
    IN/EXISTS conjuncts as semi joins; then (3) conjuncts containing
    scalar subqueries, filtered above the joined-in subquery values."""
    conjuncts = _split_conjuncts(where)
    plain = [c for c in conjuncts if not _contains_subquery(c)]
    rest = [c for c in conjuncts if _contains_subquery(c)]
    if plain:
        rp = _filter_on(rp, plain, ctx)
    scalar: List[T.Node] = []
    for conj in rest:
        rp, handled = _plan_subquery_conjunct(conj, rp, ctx)
        if not handled:
            scalar.append(conj)
    if scalar:
        pred_ast = scalar[0]
        for c in scalar[1:]:
            pred_ast = T.BinaryOp("and", pred_ast, c)
        rp, pred_ast = _plan_scalar_subqueries(pred_ast, rp, ctx)
        an = _Analyzer(rp.scope, ctx)
        pred = _coerce_to(an.analyze(pred_ast), BOOLEAN)
        out = tuple(N.Field(f.symbol, f.type, f.dictionary)
                    for f in rp.scope.fields)
        rp = RelationPlan(
            N.FilterNode(rp.node, fold_constants(pred), out), rp.scope)
    return rp


def _plan_subquery_conjunct(conj: T.Node, rp: RelationPlan,
                            ctx: PlannerContext):
    """Handle IN (subquery) / EXISTS conjuncts via semi joins.
    Returns (new rp, handled)."""
    negated = False
    node = conj
    if isinstance(node, T.UnaryOp) and node.op == "not":
        inner = node.operand
        if isinstance(inner, (T.InSubquery, T.Exists)):
            negated = True
            node = inner
    if isinstance(node, T.InSubquery):
        negated = negated != node.negated
        an = _Analyzer(rp.scope, ctx)
        value = an.analyze(node.value)
        vsym = _as_symbol(value)
        if vsym is None:
            raise AnalysisError("IN value must be a column for now")
        sub_rp, extra_keys, residual = _plan_correlated_query(
            node.query, ctx, rp.scope)
        if residual:
            raise AnalysisError("correlated IN with non-equality "
                                "correlation not yet supported")
        if len(sub_rp.scope.fields) != 1:
            raise AnalysisError("IN subquery must return one column")
        fsym = sub_rp.scope.fields[0].symbol
        out = tuple(N.Field(f.symbol, f.type, f.dictionary)
                    for f in rp.scope.fields)
        if extra_keys:
            # correlated IN: semi join on (value, corr...) multi-key
            raise AnalysisError(
                "correlated IN subqueries not yet supported")
        sj = N.SemiJoinNode(rp.node, sub_rp.node, vsym, fsym, negated,
                            out)
        return RelationPlan(sj, rp.scope), True
    if isinstance(node, T.Exists):
        negated = negated != node.negated
        sub_rp, corr, residual = _plan_correlated_query(
            node.query, ctx, rp.scope)
        out = tuple(N.Field(f.symbol, f.type, f.dictionary)
                    for f in rp.scope.fields)
        if residual:
            # general decorrelation (Q21's `l2.suppkey <> l1.suppkey`):
            # tag probe rows with unique ids, join on the equality keys,
            # filter the residual over the joined pairs, then semi join
            # the surviving ids back (reference: AssignUniqueIdOperator
            # + TransformCorrelatedExistsApply-style rewrite)
            rp2 = _plan_exists_general(rp, sub_rp, corr, residual,
                                       negated, ctx)
            return rp2, True
        if corr:
            # correlated EXISTS -> semi join on the correlation keys
            if len(corr) != 1:
                raise AnalysisError("multi-key correlated EXISTS not "
                                    "yet supported")
            outer_sym, inner_sym = corr[0]
            sj = N.SemiJoinNode(rp.node, sub_rp.node, outer_sym,
                                inner_sym, negated, out)
            return RelationPlan(sj, rp.scope), True
        # uncorrelated EXISTS: count(subquery limit 1) > 0, broadcast
        cnt_sym = ctx.symbols.new("exists_count")
        agg = N.AggregationNode(
            N.LimitNode(sub_rp.node, 1,
                        tuple(N.Field(f.symbol, f.type, f.dictionary)
                              for f in sub_rp.scope.fields)),
            [], [N.AggCall(cnt_sym, "count", None, False, BIGINT)],
            "single", (N.Field(cnt_sym, BIGINT),))
        joined_out = out + (N.Field(cnt_sym, BIGINT),)
        cj = N.JoinNode("cross", rp.node, agg, [], joined_out)
        op = "greater_than" if not negated else "equal"
        pred = Call(op, (InputRef(cnt_sym, BIGINT), Literal(0, BIGINT)),
                    BOOLEAN)
        flt = N.FilterNode(cj, pred, joined_out)
        scope = Scope(rp.scope.fields + [
            ScopeField(None, cnt_sym, cnt_sym, BIGINT)],
            rp.scope.parent)
        return RelationPlan(flt, scope), True
    return rp, False


def _plan_correlated_query(q: T.Query, ctx: PlannerContext,
                           outer_scope: Scope):
    """Plan a subquery that may reference the outer scope through
    top-level conjuncts. Returns (plan, corr, residual): `corr` is
    [(outer_sym, inner_sym)] equality pairs stripped into join keys
    (classic decorrelation); `residual` is the conjunct ASTs that
    reference the outer scope non-equally (handled by the caller via
    unique-id decorrelation)."""
    if not isinstance(q.body, T.QuerySpec) or q.ctes:
        rp, _ = plan_query(q, ctx, None)
        return rp, [], []
    spec = q.body
    inner_rp = _plan_relation(spec.from_, ctx, None) \
        if spec.from_ is not None else None
    if inner_rp is None:
        rp, _ = plan_query(q, ctx, None)
        return rp, [], []
    corr: List[Tuple[str, str]] = []
    remaining: List[T.Node] = []
    residual: List[T.Node] = []
    if spec.where is not None:
        inner_an = _Analyzer(inner_rp.scope, ctx)
        outer_an = _Analyzer(outer_scope, ctx)
        for conj in _split_conjuncts(spec.where):
            pair = _correlation_pair(conj, inner_an, outer_an)
            if pair:
                corr.append(pair)
                continue
            if _contains_subquery(conj):
                # nested subqueries are planned by _plan_where against
                # the inner scope (they may correlate to it)
                remaining.append(conj)
            elif _references_outer(conj, inner_rp.scope, outer_scope):
                residual.append(conj)
            else:
                remaining.append(conj)
    if not corr and not residual:
        rp, _ = plan_query(q, ctx, None)
        return rp, [], []
    # rebuild the subquery without the correlated conjuncts; keep the
    # correlation columns in its select so the semi join can key on them
    new_where = None
    for c in remaining:
        new_where = c if new_where is None else \
            T.BinaryOp("and", new_where, c)
    inner_syms = [p[1] for p in corr]
    # plan: FROM + remaining WHERE, then project select + corr columns
    rp2 = inner_rp
    if new_where is not None:
        rp2 = _plan_where(new_where, rp2, ctx)
    if spec.group_by or any(_contains_agg(i.expr)
                            for i in spec.select
                            if isinstance(i, T.SelectItem)):
        raise AnalysisError("correlated subquery with aggregation "
                            "requires scalar decorrelation (use the "
                            "scalar subquery path)")
    # EXISTS doesn't care about select list; IN needs the one column
    sel_fields = []
    if spec.select and not (len(spec.select) == 1
                            and isinstance(spec.select[0], T.Star)):
        an2 = _Analyzer(rp2.scope, ctx)
        for item in spec.select:
            if isinstance(item, T.Star):
                continue
            e = an2.analyze(item.expr)
            s = _as_symbol(e)
            if s is not None:
                sel_fields.append(next(
                    f for f in rp2.scope.fields if f.symbol == s))
    if residual:
        # the caller's residual filter may reference any inner column —
        # expose the full inner scope (qualifiers intact)
        scope = Scope(list(rp2.scope.fields))
    else:
        fields = sel_fields + [
            f for f in rp2.scope.fields if f.symbol in inner_syms
            and all(f.symbol != g.symbol for g in sel_fields)]
        scope = Scope(fields)
    return RelationPlan(rp2.node, scope), corr, residual


def _references_outer(node, inner_scope: Scope,
                      outer_scope: Scope) -> bool:
    """True if any identifier in `node` (no nested subqueries) resolves
    only against the outer scope."""
    if isinstance(node, T.Identifier):
        try:
            inner_scope.resolve(node.parts)
            return False
        except AnalysisError:
            try:
                outer_scope.resolve(node.parts)
                return True
            except AnalysisError:
                return False
    if isinstance(node, T.Node):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, T.Node) and \
                    _references_outer(v, inner_scope, outer_scope):
                return True
            if isinstance(v, (list, tuple)):
                if any(isinstance(x, T.Node) and
                       _references_outer(x, inner_scope, outer_scope)
                       for x in v):
                    return True
    return False


def _plan_exists_general(rp: RelationPlan, sub_rp: RelationPlan,
                         corr: List[Tuple[str, str]],
                         residual: List[T.Node], negated: bool,
                         ctx: PlannerContext) -> RelationPlan:
    """EXISTS with non-equality correlation: assign each probe row a
    unique id, inner-join probe x subquery on the equality keys, filter
    the residual predicate over the joined pairs, and semi join the
    surviving ids back onto the probe."""
    idsym = ctx.symbols.new("unique")
    probe_out = tuple(N.Field(f.symbol, f.type, f.dictionary)
                      for f in rp.scope.fields) + (N.Field(idsym, BIGINT),)
    probe = N.AssignUniqueIdNode(rp.node, idsym, probe_out)
    sub_out = tuple(N.Field(f.symbol, f.type, f.dictionary)
                    for f in sub_rp.scope.fields)
    join_out = probe_out + sub_out
    criteria = [(osym, isym) for osym, isym in corr]
    joined = N.JoinNode("inner", probe, sub_rp.node, criteria, join_out)
    comb_scope = Scope(list(rp.scope.fields) + list(sub_rp.scope.fields),
                       rp.scope.parent)
    an = _Analyzer(comb_scope, ctx)
    pred_ast = residual[0]
    for c in residual[1:]:
        pred_ast = T.BinaryOp("and", pred_ast, c)
    pred = _coerce_to(an.analyze(pred_ast), BOOLEAN)
    filtered = N.FilterNode(joined, fold_constants(pred), join_out)
    fid = ctx.symbols.new("unique")
    ids = N.ProjectNode(filtered, [(fid, InputRef(idsym, BIGINT))],
                        (N.Field(fid, BIGINT),))
    sj_out = tuple(N.Field(f.symbol, f.type, f.dictionary)
                   for f in rp.scope.fields)
    sj = N.SemiJoinNode(probe, ids, idsym, fid, negated, sj_out)
    return RelationPlan(sj, rp.scope)


def _correlation_pair(conj: T.Node, inner_an: "_Analyzer",
                      outer_an: "_Analyzer"):
    """conj of form inner.col = outer.col -> (outer_sym, inner_sym)."""
    if not (isinstance(conj, T.BinaryOp) and conj.op == "="):
        return None

    def try_resolve(an, ast):
        if not isinstance(ast, T.Identifier):
            return None
        try:
            f, is_outer = an.scope.resolve(ast.parts)
            return None if is_outer else f.symbol
        except AnalysisError:
            return None
    li, lo = try_resolve(inner_an, conj.left), \
        try_resolve(outer_an, conj.left)
    ri, ro = try_resolve(inner_an, conj.right), \
        try_resolve(outer_an, conj.right)
    if li and ro and not lo:
        return (ro, li)
    if ri and lo and not li:
        return (lo, ri)
    return None


def _plan_scalar_subqueries(ast: T.Node, rp: RelationPlan,
                            ctx: PlannerContext):
    """Replace ScalarSubquery nodes with joined-in symbols."""
    subs: List[T.ScalarSubquery] = []

    def find(node):
        if isinstance(node, T.ScalarSubquery):
            subs.append(node)
            return
        if isinstance(node, T.Node):
            for f in dataclasses.fields(node):
                v = getattr(node, f.name)
                if isinstance(v, T.Node):
                    find(v)
                elif isinstance(v, (list, tuple)):
                    for x in v:
                        if isinstance(x, T.Node):
                            find(x)
    find(ast)
    replacements: Dict[int, T.Identifier] = {}
    for sub in subs:
        rp, sym = _plan_one_scalar_subquery(sub, rp, ctx)
        replacements[id(sub)] = T.Identifier((sym,))
    if not replacements:
        return rp, ast

    def rewrite(node):
        if isinstance(node, T.Node) and id(node) in replacements:
            return replacements[id(node)]
        if isinstance(node, T.Node):
            kwargs = {}
            for f in dataclasses.fields(node):
                v = getattr(node, f.name)
                if isinstance(v, T.Node):
                    kwargs[f.name] = rewrite(v)
                elif isinstance(v, list):
                    kwargs[f.name] = [rewrite(x) if isinstance(x, T.Node)
                                      else x for x in v]
                else:
                    kwargs[f.name] = v
            return type(node)(**kwargs)
        return node
    return rp, rewrite(ast)


def _plan_one_scalar_subquery(sub: T.ScalarSubquery, rp: RelationPlan,
                              ctx: PlannerContext):
    """Uncorrelated: EnforceSingleRow + cross join. Correlated (equality
    + aggregation): group the subquery by its correlation keys and LEFT
    JOIN — TPC-H Q17's avg-per-partkey shape."""
    q = sub.query
    corr_info = _try_scalar_decorrelation(q, rp, ctx)
    if corr_info is not None:
        return corr_info
    sub_rp, _ = plan_query(q, ctx, None)
    if len(sub_rp.scope.fields) != 1:
        raise AnalysisError("scalar subquery must return one column")
    f = sub_rp.scope.fields[0]
    out1 = (N.Field(f.symbol, f.type, f.dictionary),)
    enforced = N.EnforceSingleRowNode(sub_rp.node, out1)
    joined_out = tuple(N.Field(g.symbol, g.type, g.dictionary)
                       for g in rp.scope.fields) + out1
    cj = N.JoinNode("cross", rp.node, enforced, [], joined_out)
    scope = Scope(rp.scope.fields + [
        ScopeField(None, f.symbol, f.symbol, f.type, f.dictionary)],
        rp.scope.parent)
    return RelationPlan(cj, scope), f.symbol


def _try_scalar_decorrelation(q: T.Query, rp: RelationPlan,
                              ctx: PlannerContext):
    """(SELECT agg(e) FROM S WHERE S.k = outer.k AND rest) ->
    LEFT JOIN (SELECT S.k, agg(e) FROM S WHERE rest GROUP BY S.k)."""
    if not isinstance(q.body, T.QuerySpec) or q.ctes or q.order_by:
        return None
    spec = q.body
    if spec.group_by or spec.having or spec.from_ is None:
        return None
    if len(spec.select) != 1 or isinstance(spec.select[0], T.Star):
        return None
    item = spec.select[0]
    if not _contains_agg(item.expr):
        return None
    inner_rp = _plan_relation(spec.from_, ctx, None)
    corr, remaining = [], []
    if spec.where is None:
        return None
    inner_an = _Analyzer(inner_rp.scope, ctx)
    outer_an = _Analyzer(rp.scope, ctx)
    for conj in _split_conjuncts(spec.where):
        pair = _correlation_pair(conj, inner_an, outer_an)
        if pair:
            corr.append(pair)
        else:
            remaining.append(conj)
    if not corr:
        return None
    rp2 = inner_rp
    if remaining:
        w = remaining[0]
        for c in remaining[1:]:
            w = T.BinaryOp("and", w, c)
        rp2 = _plan_where(w, rp2, ctx)
    # aggregation grouped by the inner correlation keys
    an2 = _Analyzer(rp2.scope, ctx)
    calls: List[T.FunctionCall] = []
    _collect_agg_calls(item.expr, calls)
    agg_nodes, rewrites = [], {}
    for c in calls:
        key = _ast_key(c)
        if key in rewrites:
            continue
        arg = fold_constants(an2.analyze(c.args[0])) \
            if (c.args and not c.is_star) else None
        filt = _coerce_to(fold_constants(an2.analyze(c.filter)),
                          BOOLEAN) if c.filter is not None else None
        out_t = _agg_output_type(c.name, arg.type if arg else None)
        sym = ctx.symbols.new(c.name)
        agg_nodes.append(N.AggCall(sym, c.name, arg, False, out_t,
                                   filter=filt))
        rewrites[key] = (sym, out_t, None)
    inner_keys = [p[1] for p in corr]
    key_exprs = []
    for ik in inner_keys:
        f = next(f for f in rp2.scope.fields if f.symbol == ik)
        key_exprs.append((ik, InputRef(ik, f.type)))
    agg_out = tuple(
        [N.Field(s, next(f for f in rp2.scope.fields
                         if f.symbol == s).type,
                 next(f for f in rp2.scope.fields
                      if f.symbol == s).dictionary) for s in inner_keys]
        + [N.Field(a.out_symbol, a.output_type) for a in agg_nodes])
    agg_node = N.AggregationNode(rp2.node, key_exprs, agg_nodes,
                                 "single", agg_out)
    # value projection over agg outputs
    agg_scope = Scope(
        [ScopeField(None, s, s,
                    next(f for f in rp2.scope.fields
                         if f.symbol == s).type) for s in inner_keys]
        + [ScopeField(None, a.out_symbol, a.out_symbol, a.output_type)
           for a in agg_nodes])
    an3 = _Analyzer(agg_scope, ctx, rewrites)
    value_expr = fold_constants(an3.analyze(item.expr))
    vsym = ctx.symbols.new("scalar")
    proj_out = tuple([N.Field(s, agg_scope.fields[i].type)
                      for i, s in enumerate(inner_keys)]
                     + [N.Field(vsym, value_expr.type)])
    proj_assigns = [(s, InputRef(s, agg_scope.fields[i].type))
                    for i, s in enumerate(inner_keys)] \
        + [(vsym, value_expr)]
    proj = N.ProjectNode(agg_node, proj_assigns, proj_out)
    # LEFT JOIN outer on correlation keys
    joined_out = tuple(N.Field(g.symbol, g.type, g.dictionary)
                       for g in rp.scope.fields) + proj_out
    criteria = [(outer_sym, inner_sym)
                for (outer_sym, inner_sym) in corr]
    jn = N.JoinNode("left", rp.node, proj, criteria, joined_out)
    scope = Scope(rp.scope.fields + [
        ScopeField(None, vsym, vsym, value_expr.type)], rp.scope.parent)
    return RelationPlan(jn, scope), vsym


# ---------------------------------------------------------------------------
# expression analysis
# ---------------------------------------------------------------------------

def _coerce_to(e: RowExpression, typ: Type) -> RowExpression:
    if e.type == typ:
        return e
    if e.type == UNKNOWN:
        return Literal(None, typ)
    return SpecialForm("cast", (e,), typ)


class _Analyzer:
    """AST expression -> typed RowExpression over a scope."""

    def __init__(self, scope: Scope, ctx: PlannerContext,
                 rewrites: Optional[Dict[tuple, Tuple[str, Type,
                                                      Optional[tuple]]]]
                 = None):
        self.scope = scope
        self.ctx = ctx
        self.rewrites = rewrites or {}
        self._dicts: Dict[str, Optional[tuple]] = {
            f.symbol: f.dictionary for f in scope.fields}

    def dictionary_of(self, e: RowExpression) -> Optional[tuple]:
        from presto_tpu_torch.expr.compile import compile_expression
        if not e.type.is_string:
            return None
        if isinstance(e, InputRef):
            return self._dicts.get(e.name)
        if isinstance(e, Literal):
            return (e.value,) if e.value is not None else ()
        # derive via a dry compile (cheap: dictionaries are host-side)
        from presto_tpu_torch.schema import ColumnSchema
        schema = {f.symbol: ColumnSchema(f.symbol, f.type, f.dictionary)
                  for f in self.scope.fields}
        try:
            return compile_expression(e, schema).dictionary
        except Exception:
            return None

    def analyze(self, ast: T.Node) -> RowExpression:
        key = _ast_key(ast)
        if key in self.rewrites:
            sym, typ, dic = self.rewrites[key]
            self._dicts.setdefault(sym, dic)
            form = self._form_by_symbol(sym)
            if form is not None:
                return form
            return InputRef(sym, typ)
        meth = getattr(self, f"_an_{type(ast).__name__}", None)
        if meth is None:
            raise AnalysisError(f"unsupported expression "
                                f"{type(ast).__name__}")
        return meth(ast)

    # -- leaves ------------------------------------------------------------

    def _an_NumberLit(self, a: T.NumberLit):
        t = a.text
        if "." not in t and "e" not in t.lower():
            return Literal(int(t), BIGINT)
        return Literal(float(t), DOUBLE)

    def _an_StringLit(self, a: T.StringLit):
        return Literal(a.value, VARCHAR)

    def _an_BoolLit(self, a: T.BoolLit):
        return Literal(a.value, BOOLEAN)

    def _an_Parameter(self, a: T.Parameter):
        raise AnalysisError(
            f"unbound parameter ?{a.index + 1}: `?` placeholders are "
            "only valid inside PREPARE, bound by EXECUTE ... USING")

    def _an_NullLit(self, a: T.NullLit):
        return Literal(None, UNKNOWN)

    def _an_DateLit(self, a: T.DateLit):
        return Literal(dt.parse_date_literal(a.text), DATE)

    def _an_TimestampLit(self, a: T.TimestampLit):
        import datetime
        d = datetime.datetime.fromisoformat(a.text)
        ms = int(d.timestamp() * 1000)
        from presto_tpu_torch.types import TIMESTAMP
        return Literal(ms, TIMESTAMP)

    def _an_IntervalLit(self, a: T.IntervalLit):
        v = int(a.value) * (-1 if a.negative else 1)
        unit = a.unit
        if unit in ("year", "month"):
            months = v * 12 if unit == "year" else v
            return Literal(months, INTERVAL_YEAR)
        ms = {"day": 86_400_000, "hour": 3_600_000, "minute": 60_000,
              "second": 1000}[unit] * v
        return Literal(ms, INTERVAL_DAY)

    def _form_by_symbol(self, sym: str):
        """The complex value form of a scope field, or None. A form
        field's named symbol has no physical column; referencing it
        yields the ArrayValue/MapValue/RowValue over its slots."""
        sc = self.scope
        while sc is not None:
            for f in sc.fields:
                if f.symbol == sym and f.form is not None:
                    self._register_form_dicts(f)
                    return f.form
            sc = sc.parent
        return None

    def _register_form_dicts(self, f) -> None:
        """Make a form field's slot dictionaries resolvable through
        dictionary_of(InputRef(slot)) — the field's own dictionary
        attr covers array element slots, form_dicts covers per-slot
        maps (map keys and values differ)."""
        for s, d in (getattr(f, "form_dicts", None) or {}).items():
            self._dicts.setdefault(s, d)
        if f.dictionary is not None and f.form is not None:
            from presto_tpu_torch.expr.ir import ArrayValue
            if isinstance(f.form, ArrayValue):
                for x in f.form.elements:
                    if isinstance(x, InputRef):
                        self._dicts.setdefault(x.name, f.dictionary)

    def _an_Identifier(self, a: T.Identifier):
        if len(a.parts) == 1 and a.parts[0] in self._lambda_bindings:
            return self._lambda_bindings[a.parts[0]]
        f, is_outer = self.scope.resolve(a.parts)
        if is_outer:
            raise AnalysisError(
                f"correlated reference {'.'.join(a.parts)!r} is not "
                f"supported in this position")
        if f.form is not None:
            self._register_form_dicts(f)
            return f.form
        self._dicts.setdefault(f.symbol, f.dictionary)
        return InputRef(f.symbol, f.type)

    # -- operators ---------------------------------------------------------

    def _an_UnaryOp(self, a: T.UnaryOp):
        if a.op == "not":
            e = _coerce_to(self.analyze(a.operand), BOOLEAN)
            return SpecialForm("not", (e,), BOOLEAN)
        e = self.analyze(a.operand)
        if a.op == "-":
            return Call("negate", (e,), e.type)
        return e

    def _an_BinaryOp(self, a: T.BinaryOp):
        if a.op in ("and", "or"):
            l = _coerce_to(self.analyze(a.left), BOOLEAN)
            r = _coerce_to(self.analyze(a.right), BOOLEAN)
            return SpecialForm(a.op, (l, r), BOOLEAN)
        l = self.analyze(a.left)
        r = self.analyze(a.right)
        if a.op in ("=", "<>", "<", "<=", ">", ">="):
            name = {"=": "equal", "<>": "not_equal", "<": "less_than",
                    "<=": "less_than_or_equal", ">": "greater_than",
                    ">=": "greater_than_or_equal"}[a.op]
            l, r = self._coerce_comparison(l, r)
            return Call(name, (l, r), BOOLEAN)
        if a.op in ("+", "-", "*", "/", "%"):
            return self._arith(a.op, l, r)
        if a.op == "||":
            if not (l.type.is_string and r.type.is_string):
                raise AnalysisError("|| requires varchar operands")
            return Call("concat", (l, r), VARCHAR)
        raise AnalysisError(f"unsupported operator {a.op!r}")

    def _coerce_comparison(self, l, r):
        if l.type.is_string and r.type.is_string:
            return l, r
        ct = common_super_type(l.type, r.type)
        if ct is None:
            raise AnalysisError(
                f"cannot compare {l.type} and {r.type}")
        return _coerce_to(l, ct), _coerce_to(r, ct)

    def _arith(self, op: str, l: RowExpression, r: RowExpression):
        name = {"+": "add", "-": "subtract", "*": "multiply",
                "/": "divide", "%": "modulus"}[op]
        lt, rt = l.type, r.type
        # date/interval arithmetic
        if lt == DATE and rt in (INTERVAL_DAY, INTERVAL_YEAR):
            return Call(name, (l, r), DATE)
        if lt in (INTERVAL_DAY, INTERVAL_YEAR) and rt == DATE \
                and op == "+":
            return Call("add", (r, l), DATE)
        if lt == DATE and rt == DATE and op == "-":
            # date difference in days -> bigint
            l64 = SpecialForm("cast", (l,), BIGINT)
            r64 = SpecialForm("cast", (r,), BIGINT)
            return Call("subtract", (l64, r64), BIGINT)
        if not (lt.is_numeric and rt.is_numeric):
            raise AnalysisError(f"cannot apply {op!r} to {lt} and {rt}")
        if lt.is_decimal or rt.is_decimal:
            if lt.is_floating or rt.is_floating:
                return Call(name, (l, r), DOUBLE)
            ld = lt if lt.is_decimal else decimal_type(18, 0)
            rd = rt if rt.is_decimal else decimal_type(18, 0)
            out = self._decimal_result(op, ld, rd)
            return Call(name, (l, r), out)
        if lt.is_floating or rt.is_floating:
            return Call(name, (l, r), DOUBLE)
        out = common_super_type(lt, rt)
        return Call(name, (l, r), out)

    @staticmethod
    def _decimal_result(op, a, b):
        if op in ("+", "-"):
            s = max(a.scale, b.scale)
            p = max(a.precision - a.scale, b.precision - b.scale) + s + 1
            return decimal_type(p, s)
        if op == "*":
            return decimal_type(a.precision + b.precision,
                                a.scale + b.scale)
        if op == "/":
            s = max(a.scale, b.scale)
            return decimal_type(a.precision - a.scale + b.scale + s, s)
        s = max(a.scale, b.scale)
        return decimal_type(min(a.precision, b.precision) + s, s)

    # -- predicates --------------------------------------------------------

    def _an_Between(self, a: T.Between):
        v = self.analyze(a.value)
        lo = self.analyze(a.low)
        hi = self.analyze(a.high)
        v1, lo = self._coerce_comparison(v, lo)
        v2, hi = self._coerce_comparison(v, hi)
        e = SpecialForm("between", (v1, lo, hi), BOOLEAN)
        if a.negated:
            return SpecialForm("not", (e,), BOOLEAN)
        return e

    def _an_InList(self, a: T.InList):
        v = self.analyze(a.value)
        items = []
        for i in a.items:
            e = self.analyze(i)
            _, e = self._coerce_comparison(v, e)
            items.append(e)
        node = SpecialForm("in", tuple([v] + items), BOOLEAN)
        if a.negated:
            return SpecialForm("not", (node,), BOOLEAN)
        return node

    def _an_Like(self, a: T.Like):
        v = self.analyze(a.value)
        p = self.analyze(a.pattern)
        if not isinstance(p, Literal):
            raise AnalysisError("LIKE pattern must be a literal")
        args = [v, p]
        if a.escape is not None:
            esc = self.analyze(a.escape)
            if not isinstance(esc, Literal):
                raise AnalysisError("LIKE escape must be a literal")
            args.append(esc)
        e = Call("like", tuple(args), BOOLEAN)
        if a.negated:
            return SpecialForm("not", (e,), BOOLEAN)
        return e

    def _an_IsNull(self, a: T.IsNull):
        v = self.analyze(a.value)
        form = "is_not_null" if a.negated else "is_null"
        return SpecialForm(form, (v,), BOOLEAN)

    def _an_Case(self, a: T.Case):
        whens = []
        if a.operand is not None:
            op = self.analyze(a.operand)
            for cond_ast, res_ast in a.whens:
                c = self.analyze(cond_ast)
                opc, c = self._coerce_comparison(op, c)
                whens.append((Call("equal", (opc, c), BOOLEAN),
                              self.analyze(res_ast)))
        else:
            for cond_ast, res_ast in a.whens:
                whens.append((_coerce_to(self.analyze(cond_ast), BOOLEAN),
                              self.analyze(res_ast)))
        default = self.analyze(a.default) if a.default is not None \
            else Literal(None, UNKNOWN)
        # result type: common super type of all branches
        rt = default.type
        for _, res in whens:
            t = common_super_type(rt, res.type)
            if t is None:
                raise AnalysisError("CASE branch types incompatible")
            rt = t
        expr: RowExpression = _coerce_to(default, rt)
        for cond, res in reversed(whens):
            expr = SpecialForm("if", (cond, _coerce_to(res, rt), expr),
                               rt)
        return expr

    def _an_Cast(self, a: T.Cast):
        e = self.analyze(a.operand)
        typ = parse_type(a.type_name)
        return SpecialForm("cast", (e,), typ)

    def _an_Extract(self, a: T.Extract):
        e = self.analyze(a.value)
        field = a.field.lower()
        if field not in ("year", "month", "day", "quarter"):
            raise AnalysisError(f"EXTRACT({field}) not supported")
        return Call(field, (e,), BIGINT)

    def _an_ArrayConstructor(self, a: T.ArrayConstructor):
        """ARRAY[...] as an EXPRESSION: a fixed-width analysis-time
        value; consumers (subscript, cardinality, UNNEST, ...) lower it
        to scalar IR (see ir.ArrayValue)."""
        from presto_tpu_torch.types import array_type
        if not a.items:
            raise AnalysisError("empty ARRAY[] needs a type context")
        elems = [fold_constants(self.analyze(x)) for x in a.items]
        t = UNKNOWN
        for e in elems:
            st = common_super_type(t, e.type)
            if st is None:
                raise AnalysisError(
                    "ARRAY element types are incompatible")
            t = st
        if t == UNKNOWN:
            t = BIGINT
        elems = [e if e.type == t else _coerce_to(e, t) for e in elems]
        from presto_tpu_torch.expr.ir import ArrayValue
        return ArrayValue(tuple(elems), None, array_type(t))

    def _array_element_switch(self, arr, idx: RowExpression):
        """element_at / subscript over a fixed-width array: constant
        index picks the element expression (negative counts from the
        ROW's end — a length switch when the array is dynamic); a
        dynamic index lowers to an if-chain over the static width
        (1-based positive; dynamic NEGATIVE indexes are unsupported
        and yield NULL)."""
        elems = arr.elements
        et = arr.type.element
        if isinstance(idx, Literal):
            i = int(idx.value)
            if i < 0 and arr.length is not None:
                # element len+1+i, switching on the dynamic length
                out: RowExpression = Literal(None, et)
                for ln in range(len(elems), 0, -1):
                    pos = ln + 1 + i
                    if 1 <= pos <= ln:
                        out = SpecialForm(
                            "if",
                            (Call("equal",
                                  (arr.length, Literal(ln, BIGINT)),
                                  BOOLEAN), elems[pos - 1], out), et)
                return out
            if i < 0:  # static: count from the static end
                i = len(elems) + 1 + i
            if 1 <= i <= len(elems):
                return elems[i - 1]
            return Literal(None, et)
        out = Literal(None, et)
        for i in range(len(elems), 0, -1):
            out = SpecialForm(
                "if", (Call("equal", (idx, Literal(i, BIGINT)),
                            BOOLEAN), elems[i - 1], out), et)
        return out

    def _array_guard(self, arr, i: int) -> Optional[RowExpression]:
        """True iff slot i (1-based) is a REAL element of the row's
        array (None when statically guaranteed)."""
        if arr.length is None:
            return None
        return Call("less_than_or_equal",
                    (Literal(i, BIGINT), arr.length), BOOLEAN)

    def _an_Subscript(self, a: T.Subscript):
        from presto_tpu_torch.expr.ir import ArrayValue, MapValue, RowValue
        base = self.analyze(a.base)
        if isinstance(base, MapValue):
            return self._map_lookup(
                base, fold_constants(self.analyze(a.index)))
        if isinstance(base, RowValue):
            idx = fold_constants(self.analyze(a.index))
            if not isinstance(idx, Literal) or idx.value is None \
                    or not idx.type.is_integer:
                raise AnalysisError(
                    "row field access needs a constant integer index")
            i = int(idx.value)
            if not 1 <= i <= len(base.fields):
                raise AnalysisError(
                    f"row has {len(base.fields)} fields; "
                    f"index {i} is out of range")
            return base.fields[i - 1][1]
        if not isinstance(base, ArrayValue):
            raise AnalysisError(
                "subscript requires an array, map or row value")
        return self._array_element_switch(
            base, fold_constants(self.analyze(a.index)))

    #: immutable by convention: rebinding replaces the whole dict
    _lambda_bindings: dict = {}

    def _an_Lambda(self, a: T.Lambda):
        raise AnalysisError(
            "a lambda is only valid as an argument of "
            "transform/reduce/any_match/all_match/none_match/zip_with")

    def _bind_lambda(self, lam: T.Lambda,
                     values: List[RowExpression]) -> RowExpression:
        """Analyze a lambda body with its parameters bound to concrete
        element expressions — lambdas lower by SUBSTITUTION at
        analysis time (reference: LambdaBytecodeGenerator compiles a
        method per lambda; our fixed-width arrays make inlining per
        element slot the natural form)."""
        if len(lam.params) != len(values):
            raise AnalysisError(
                f"lambda takes {len(lam.params)} parameters, "
                f"{len(values)} given")
        old = self._lambda_bindings
        self._lambda_bindings = {**old,
                                 **dict(zip(lam.params, values))}
        try:
            return self.analyze(lam.body)
        finally:
            self._lambda_bindings = old

    def _an_FunctionCall(self, a: T.FunctionCall):
        name = a.name
        if name in AGG_FUNCTIONS and a.window is None:
            raise AnalysisError(
                f"aggregate {name} not allowed in this context")
        if a.window is not None:
            raise AnalysisError("window functions not yet supported "
                                "in this position")
        if any(isinstance(x, T.Lambda) for x in a.args):
            return self._resolve_lambda_fn(name, a.args)
        args = [self.analyze(x) for x in a.args]
        # map resolver first: it owns map()/row() constructors, whose
        # args are ArrayValues the array resolver would reject
        mp = self._resolve_map_fn(name, args)
        if mp is not None:
            return mp
        arr = self._resolve_array_fn(name, args)
        if arr is not None:
            return arr
        return self._resolve_scalar(name, args)

    def _resolve_lambda_fn(self, name: str, raw_args):
        """Lambda-taking array functions (reference: operator/scalar/
        ArrayTransformFunction, ReduceFunction, ArrayAnyMatchFunction,
        ZipWithFunction), lowered to scalar IR over the fixed-width
        elements with the usual (i <= length) padding guards."""
        from presto_tpu_torch.expr.ir import ArrayValue, and_, or_
        from presto_tpu_torch.types import array_type

        def arr_arg(i):
            v = self.analyze(raw_args[i])
            if not isinstance(v, ArrayValue):
                raise AnalysisError(
                    f"{name}: argument {i + 1} must be an array")
            return v

        def lam_arg(i, nparams):
            lam = raw_args[i]
            if not isinstance(lam, T.Lambda) \
                    or len(lam.params) != nparams:
                raise AnalysisError(
                    f"{name}: argument {i + 1} must be a "
                    f"{nparams}-parameter lambda")
            return lam

        if name == "transform":
            if len(raw_args) != 2:
                raise AnalysisError("transform(array, x -> f(x))")
            arr = arr_arg(0)
            lam = lam_arg(1, 1)
            elems = [self._bind_lambda(lam, [e])
                     for e in arr.elements]
            t0 = elems[0].type
            elems = tuple(_coerce_to(e, t0) for e in elems)
            return ArrayValue(elems, arr.length, array_type(t0))

        if name == "reduce":
            if len(raw_args) not in (3, 4):
                raise AnalysisError(
                    "reduce(array, init, (acc, x) -> f, "
                    "[acc -> final])")
            arr = arr_arg(0)
            acc = self.analyze(raw_args[1])
            comb = lam_arg(2, 2)
            first = self._bind_lambda(comb, [acc, arr.elements[0]])
            state_t = first.type
            acc = _coerce_to(acc, state_t)
            for i, e in enumerate(arr.elements, 1):
                step = _coerce_to(
                    self._bind_lambda(comb, [acc, e]), state_t)
                g = self._array_guard(arr, i)
                acc = step if g is None else \
                    SpecialForm("if", (g, step, acc), state_t)
            if len(raw_args) == 4:
                acc = self._bind_lambda(lam_arg(3, 1), [acc])
            return acc

        if name in ("any_match", "all_match", "none_match"):
            if len(raw_args) != 2:
                raise AnalysisError(f"{name}(array, x -> pred)")
            arr = arr_arg(0)
            lam = lam_arg(1, 1)
            terms = []
            for i, e in enumerate(arr.elements, 1):
                p = _coerce_to(self._bind_lambda(lam, [e]), BOOLEAN)
                g = self._array_guard(arr, i)
                if name == "all_match":
                    # padding slots must not fail the conjunction:
                    # (NOT in-array) OR pred
                    terms.append(p if g is None else or_(
                        SpecialForm("not", (g,), BOOLEAN), p))
                else:
                    terms.append(p if g is None else and_(g, p))
            if name == "all_match":
                out = and_(*terms) if len(terms) > 1 else terms[0]
            else:
                out = or_(*terms) if len(terms) > 1 else terms[0]
            if name == "none_match":
                out = SpecialForm("not", (out,), BOOLEAN)
            return out

        if name == "transform_values":
            from presto_tpu_torch.expr.ir import MapValue
            from presto_tpu_torch.types import map_type
            if len(raw_args) != 2:
                raise AnalysisError(
                    "transform_values(map, (k, v) -> f)")
            m = self.analyze(raw_args[0])
            if not isinstance(m, MapValue):
                raise AnalysisError(
                    "transform_values: first argument must be a map")
            lam = lam_arg(1, 2)
            vals = [self._bind_lambda(lam, [k, v])
                    for k, v in zip(m.keys, m.values)]
            t0 = vals[0].type
            vals = tuple(_coerce_to(v, t0) for v in vals)
            return MapValue(m.keys, vals, m.length,
                            map_type(m.type.key, t0))

        if name == "zip_with":
            if len(raw_args) != 3:
                raise AnalysisError(
                    "zip_with(array, array, (x, y) -> f)")
            a1, a2 = arr_arg(0), arr_arg(1)
            lam = lam_arg(2, 2)
            w = max(len(a1.elements), len(a2.elements))

            def slot(arr, i):
                """Element i (1-based) or typed NULL (Presto pads the
                shorter array with NULLs)."""
                et = arr.type.element
                if i <= len(arr.elements):
                    e = arr.elements[i - 1]
                    g = self._array_guard(arr, i)
                    if g is None:
                        return e
                    return SpecialForm(
                        "if", (g, e, Literal(None, et)), e.type)
                return Literal(None, et)
            elems = [self._bind_lambda(lam, [slot(a1, i), slot(a2, i)])
                     for i in range(1, w + 1)]
            t0 = elems[0].type
            elems = tuple(_coerce_to(e, t0) for e in elems)
            l1 = a1.length if a1.length is not None \
                else Literal(len(a1.elements), BIGINT)
            l2 = a2.length if a2.length is not None \
                else Literal(len(a2.elements), BIGINT)
            length = None
            if a1.length is not None or a2.length is not None \
                    or len(a1.elements) != len(a2.elements):
                length = Call("greatest", (l1, l2), BIGINT)
            return ArrayValue(elems, length, array_type(t0))

        if name == "filter":
            # filter compacts passing elements to the front: result
            # slot j takes element i where (count of passes among
            # elements 1..i) == j+1 and element i passes. The CASE
            # chains are O(W^2) IR with SHARED predicate/count
            # subtrees (the DAG the compiler memoizes), so width stays
            # cheap to compile; capped anyway to keep lowered
            # expressions reviewable (reference:
            # operator/scalar/ArrayFilterFunction).
            if len(raw_args) != 2:
                raise AnalysisError("filter(array, x -> pred)")
            arr = arr_arg(0)
            lam = lam_arg(1, 1)
            w = len(arr.elements)
            if w > 16:
                raise AnalysisError(
                    "filter over arrays wider than 16 is not "
                    "supported — use UNNEST + WHERE")
            et = arr.type.element
            passes = []
            for i, e in enumerate(arr.elements, 1):
                p = _coerce_to(self._bind_lambda(lam, [e]), BOOLEAN)
                g = self._array_guard(arr, i)
                # padding slots and NULL predicates both exclude
                p = SpecialForm(
                    "if", (p if g is None else and_(g, p),
                           Literal(True, BOOLEAN),
                           Literal(False, BOOLEAN)), BOOLEAN)
                passes.append(p)
            # running pass counts (shared subtrees)
            counts: List[RowExpression] = []
            run: RowExpression = Literal(0, BIGINT)
            for p in passes:
                run = Call("add", (run, SpecialForm(
                    "cast", (p,), BIGINT)), BIGINT)
                counts.append(run)
            elems = []
            for j in range(w):
                out: RowExpression = Literal(None, et)
                for i in range(w, 0, -1):
                    cond = and_(passes[i - 1],
                                Call("equal",
                                     (counts[i - 1],
                                      Literal(j + 1, BIGINT)),
                                     BOOLEAN))
                    out = SpecialForm(
                        "if", (cond, arr.elements[i - 1], out), et)
                elems.append(out)
            return ArrayValue(tuple(elems), counts[-1] if w else None,
                              array_type(et))
        raise AnalysisError(
            f"{name} does not take lambda arguments")

    def _resolve_map_fn(self, name: str, args):
        """Map/row functions over the analysis-time MapValue/RowValue
        forms (reference: operator/scalar/MapFunctions + RowType) —
        same lowering discipline as the array functions."""
        from presto_tpu_torch.expr.ir import ArrayValue, MapValue, RowValue
        from presto_tpu_torch.types import array_type, map_type, row_type

        if name == "map":
            if len(args) != 2 \
                    or not isinstance(args[0], ArrayValue) \
                    or not isinstance(args[1], ArrayValue):
                return None
            ka, va = args
            n = min(len(ka.elements), len(va.elements))
            if ka.length is None and va.length is None:
                # both static: a size mismatch is knowable NOW
                # (Presto raises the same complaint at runtime)
                if len(ka.elements) != len(va.elements):
                    raise AnalysisError(
                        "map(): key and value arrays differ in size")
                length = None
            else:
                # entry i is real only if BOTH arrays reach it —
                # deviation from the reference (which raises on a
                # runtime size mismatch): extra slots of the longer
                # array are dropped
                kl = ka.length if ka.length is not None \
                    else Literal(len(ka.elements), BIGINT)
                vl = va.length if va.length is not None \
                    else Literal(len(va.elements), BIGINT)
                length = Call("least", (kl, vl), BIGINT)
            return MapValue(tuple(ka.elements[:n]),
                            tuple(va.elements[:n]), length,
                            map_type(ka.type.element, va.type.element))

        if name == "row":
            if not args:
                raise AnalysisError("row() needs at least one field")
            return RowValue(
                tuple((None, a) for a in args),
                row_type([(f"field{i}", a.type)
                          for i, a in enumerate(args)]))

        if not args or not isinstance(args[0], MapValue):
            return None
        m = args[0]
        if name == "cardinality":
            return m.length if m.length is not None \
                else Literal(len(m.keys), BIGINT)
        if name == "map_keys":
            return ArrayValue(m.keys, m.length,
                              array_type(m.type.key))
        if name == "map_values":
            return ArrayValue(m.values, m.length,
                              array_type(m.type.value))
        if name == "element_at":
            if len(args) != 2:
                raise AnalysisError("element_at(map, key)")
            return self._map_lookup(m, args[1])
        return None

    def _map_lookup(self, m, probe: RowExpression) -> RowExpression:
        """m[k]: reverse if-chain over the entries; missing keys (and
        padding slots via the (i <= length) guard) yield NULL."""
        from presto_tpu_torch.expr.ir import and_
        probe = _coerce_to(probe, m.type.key)
        vt = m.type.value
        out: RowExpression = Literal(None, vt)
        for i in range(len(m.keys), 0, -1):
            eq = Call("equal", (m.keys[i - 1], probe), BOOLEAN)
            g = self._array_guard(m, i)
            cond = eq if g is None else and_(g, eq)
            out = SpecialForm("if", (cond,
                                     _coerce_to(m.values[i - 1], vt),
                                     out), vt)
        return out

    def _resolve_array_fn(self, name: str, args):
        """Array functions lower to scalar IR over the fixed-width
        elements (reference: operator/scalar/ArrayFunctions et al,
        re-expressed as static expression forms)."""
        from presto_tpu_torch.expr.ir import ArrayValue
        from presto_tpu_torch.types import array_type

        if name == "split":
            # split(s, delim): W = max parts over s's DICTIONARY (the
            # dictionary is host-side and static at analysis time), so
            # a data-dependent array still has a static device width
            if len(args) != 2:
                raise AnalysisError("split(s, delimiter) takes two "
                                    "arguments")
            s, d = args
            if not isinstance(d, Literal) or not isinstance(
                    d.value, str) or d.value == "":
                raise AnalysisError(
                    "split delimiter must be a non-empty string "
                    "constant")
            dic = self.dictionary_of(s) or ()
            w = max([len(v.split(d.value)) for v in dic] or [1])
            elems = tuple(
                Call("split_part", (s, d, Literal(i, BIGINT)), VARCHAR)
                for i in range(1, w + 1))
            length = Call("split_count", (s, d), BIGINT)
            return ArrayValue(elems, length, array_type(VARCHAR),
                              origin=("split", s, d))

        has_array = args and isinstance(args[0], ArrayValue)
        if not has_array:
            return None
        arr = args[0]
        elems = arr.elements
        et = arr.type.element
        if name == "cardinality":
            return arr.length if arr.length is not None \
                else Literal(len(elems), BIGINT)
        if name == "element_at":
            return self._array_element_switch(
                arr, fold_constants(args[1]))
        if name == "contains":
            x = _coerce_to(args[1], et)
            from presto_tpu_torch.expr.ir import and_, or_
            terms = []
            for i, e in enumerate(elems, 1):
                eq = Call("equal", (e, x), BOOLEAN)
                g = self._array_guard(arr, i)
                # guard padding slots: (i <= len) AND eq — Kleene AND
                # turns the structural-NULL slot into false, so a
                # missing value yields false, not NULL
                terms.append(eq if g is None else and_(g, eq))
            return or_(*terms) if len(terms) > 1 else terms[0]
        if name == "array_position":
            x = _coerce_to(args[1], et)
            from presto_tpu_torch.expr.ir import and_
            out: RowExpression = Literal(0, BIGINT)
            for i in range(len(elems), 0, -1):
                eq = Call("equal", (elems[i - 1], x), BOOLEAN)
                g = self._array_guard(arr, i)
                cond = eq if g is None else and_(g, eq)
                out = SpecialForm(
                    "if", (cond, Literal(i, BIGINT), out), BIGINT)
            return out
        if name in ("array_min", "array_max"):
            if et.is_string:
                raise AnalysisError(
                    f"{name} over varchar arrays is not supported "
                    "(element dictionaries are per-slot)")
            fn = "least" if name == "array_min" else "greatest"
            if arr.length is None:
                return Call(fn, elems, et) if len(elems) > 1 \
                    else elems[0]
            # dynamic length: fold with per-slot guards so padding
            # slots never poison the result
            acc: RowExpression = elems[0]
            for i in range(2, len(elems) + 1):
                g = self._array_guard(arr, i)
                acc = SpecialForm(
                    "if", (g, Call(fn, (acc, elems[i - 1]), et), acc),
                    et)
            return acc
        if name == "array_join":
            sep = args[1]
            if not isinstance(sep, Literal):
                raise AnalysisError(
                    "array_join separator must be a constant")
            if not et.is_string:
                raise AnalysisError(
                    "array_join requires varchar elements")
            if arr.origin is not None and arr.origin[0] == "split":
                # split->join collapses to one host string function
                _, s, d = arr.origin
                return Call("split_join", (s, d, sep), VARCHAR)
            if arr.length is not None:
                raise AnalysisError(
                    "array_join over this dynamic array is not "
                    "supported")
            parts: List[RowExpression] = []
            for i, e in enumerate(elems):
                if i:
                    parts.append(sep)
                parts.append(e)
            return Call("concat", tuple(parts), VARCHAR) \
                if len(parts) > 1 else parts[0]
        raise AnalysisError(
            f"{name} over array values is not supported")

    def _resolve_scalar(self, name: str, args: List[RowExpression]):
        if name in ("if",):
            cond = _coerce_to(args[0], BOOLEAN)
            rt = common_super_type(args[1].type, args[2].type) \
                if len(args) > 2 else args[1].type
            els = _coerce_to(args[2], rt) if len(args) > 2 \
                else Literal(None, rt)
            return SpecialForm("if", (cond, _coerce_to(args[1], rt),
                                      els), rt)
        if name == "coalesce":
            rt = UNKNOWN
            for x in args:
                t = common_super_type(rt, x.type)
                if t is None:
                    raise AnalysisError("COALESCE types incompatible")
                rt = t
            return SpecialForm(
                "coalesce", tuple(_coerce_to(x, rt) for x in args), rt)
        if name == "nullif":
            return Call("nullif", tuple(args), args[0].type)
        if name in ("greatest", "least"):
            rt = UNKNOWN
            for x in args:
                rt = common_super_type(rt, x.type) or rt
            return Call(name, tuple(_coerce_to(x, rt) for x in args), rt)
        if name in ("year", "month", "day", "quarter", "day_of_week",
                    "day_of_year"):
            return Call(name, tuple(args), BIGINT)
        if name in ("abs", "sign"):
            return Call(name, tuple(args), args[0].type
                        if not args[0].type.is_decimal else args[0].type)
        if name in ("ceil", "ceiling", "floor"):
            n = "ceiling" if name == "ceil" else name
            return Call(n, tuple(args), args[0].type if
                        args[0].type.is_integer else DOUBLE)
        if name in ("sqrt", "cbrt", "exp", "ln", "log2", "log10", "sin",
                    "cos", "tan", "asin", "acos", "atan", "sinh",
                    "cosh", "tanh", "degrees", "radians", "cot",
                    "log1p", "expm1"):
            return Call(name, tuple(args), DOUBLE)
        if name == "log" and len(args) == 2:
            return Call("log", tuple(args), DOUBLE)
        if name == "truncate":
            return Call("truncate", tuple(args), DOUBLE)
        if name == "width_bucket":
            return Call("width_bucket", tuple(args), BIGINT)
        if name in ("bitwise_and", "bitwise_or", "bitwise_xor",
                    "bitwise_not", "bitwise_left_shift",
                    "bitwise_right_shift"):
            return Call(name, tuple(args), BIGINT)
        if name == "bit_count":
            # reference: MathFunctions.bitCount requires bits in
            # [2, 64]. Deviation: values not representable in `bits`
            # bits are masked to their low bits, not rejected (a
            # per-row data-dependent error has no sync-free channel)
            if len(args) != 2:
                raise AnalysisError("bit_count(x, bits) takes two "
                                    "arguments")
            b = fold_constants(args[1])
            if not isinstance(b, Literal) or b.value is None \
                    or not b.type.is_integer \
                    or not 2 <= int(b.value) <= 64:
                raise AnalysisError(
                    "bit_count's bits must be a constant in [2, 64]")
            return Call(name, tuple(args), BIGINT)
        if name == "pi" and not args:
            import math as _math
            return Literal(_math.pi, DOUBLE)
        if name == "e" and not args:
            import math as _math
            return Literal(_math.e, DOUBLE)
        if name in ("regexp_like", "is_json_scalar"):
            return Call(name, tuple(args), BOOLEAN)
        if name in ("regexp_extract", "regexp_replace",
                    "json_extract_scalar", "json_extract",
                    "split_part", "translate", "normalize",
                    "url_extract_host", "url_extract_protocol",
                    "url_extract_path", "url_extract_query",
                    "url_extract_fragment"):
            return Call(name, tuple(args), VARCHAR)
        if name in ("levenshtein_distance", "hamming_distance",
                    "from_base", "json_array_length", "bit_length",
                    "octet_length", "crc32"):
            return Call(name, tuple(args), BIGINT)
        if name in ("week", "week_of_year", "day_of_month",
                    "year_of_week"):
            return Call(name, tuple(args), BIGINT)
        if name in ("second", "minute", "hour", "millisecond"):
            return Call(name, tuple(args), BIGINT)
        if name == "typeof":
            if len(args) != 1:
                raise AnalysisError("typeof takes one argument")
            return Literal(args[0].type.display(), VARCHAR)
        if name == "substring":
            return Call("substr", tuple(args), VARCHAR)
        if name in ("char_length", "character_length"):
            return Call("length", tuple(args), BIGINT)
        if name == "last_day_of_month":
            return Call(name, tuple(args), DATE)
        if name == "date_add":
            if len(args) != 3:
                raise AnalysisError("date_add(unit, n, x) takes three "
                                    "arguments")
            return Call("date_add", tuple(args), args[2].type)
        if name == "date_diff":
            if len(args) != 3:
                raise AnalysisError("date_diff(unit, a, b) takes "
                                    "three arguments")
            return Call("date_diff", tuple(args), BIGINT)
        if name == "from_unixtime":
            from presto_tpu_torch.types import TIMESTAMP as _TS
            return Call("from_unixtime", tuple(args), _TS)
        if name == "to_unixtime":
            return Call("to_unixtime", tuple(args), DOUBLE)
        if name in ("power", "pow", "atan2", "mod"):
            n = "power" if name == "pow" else name
            if n == "mod" and all(a.type.is_integer for a in args):
                return Call("modulus", tuple(args), args[0].type)
            return Call(n, tuple(args), DOUBLE)
        if name == "round":
            if args[0].type.is_integer:
                return args[0]
            return Call("round", tuple(args), DOUBLE)
        if name in ("substr", "upper", "lower", "trim", "ltrim",
                    "rtrim", "reverse", "replace", "lpad", "rpad"):
            return Call(name, tuple(args), VARCHAR)
        if name in ("length", "strpos", "codepoint"):
            return Call(name, tuple(args), BIGINT)
        if name in ("starts_with", "ends_with"):
            return Call(name, tuple(args), BOOLEAN)
        if name == "concat":
            return Call("concat", tuple(args), VARCHAR)
        if name == "date_trunc":
            return Call("date_trunc", tuple(args), DATE)
        if name == "hash_code":
            return Call("hash_code", tuple(args), BIGINT)
        if name in ("nan", "infinity") and not args:
            # zero-arg IEEE constants (reference: MathFunctions.java)
            return Literal(float("nan") if name == "nan"
                           else float("inf"), DOUBLE)
        if name == "is_nan":
            return Call("is_nan", tuple(args), BOOLEAN)
        if name in ("is_finite", "is_infinite"):
            return Call(name, tuple(args), BOOLEAN)
        raise AnalysisError(f"unknown function {name!r}")

    def _an_InSubquery(self, a):
        raise AnalysisError("IN (subquery) is only supported as a "
                            "top-level WHERE conjunct")

    def _an_Exists(self, a):
        raise AnalysisError("EXISTS is only supported as a top-level "
                            "WHERE conjunct")

    def _an_ScalarSubquery(self, a):
        raise AnalysisError("scalar subqueries are only supported in "
                            "WHERE conjuncts for now")
