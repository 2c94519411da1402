"""Logical plan optimizer rules (reference: sql/planner/PlanOptimizers
— we implement the load-bearing subset: PredicatePushDown.java:112 +
EliminateCrossJoins + PruneUnreferencedOutputs (in local_planner)).

`rewrite_cross_joins` turns Filter-over-cross-join-trees (comma-join SQL
like TPC-H Q3/Q5) into left-deep equi-join trees, pushing single-side
conjuncts down to their source relation so filters run before joins."""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from presto_tpu_torch.expr.ir import (
    Call, InputRef, RowExpression, SpecialForm, walk,
)
from presto_tpu_torch.planner import nodes as N
from presto_tpu_torch.types import BOOLEAN


def optimize(root: N.PlanNode, catalogs=None,
             session=None) -> N.PlanNode:
    """`catalogs` enables the cost-based join-order choice (reference:
    ReorderJoins + CostCalculatorUsingExchanges); without it ordering
    falls back to the connectivity heuristic. Estimates are analytic,
    so distributed nodes re-deriving the plan stay deterministic.

    `session` additionally arms history-based feedback: measured
    cardinalities from prior executions of structurally identical
    subtrees replace the analytics (presto_tpu/history; still
    deterministic across nodes — every node of one cluster shares one
    store generation through the plan-cache key)."""
    estimator = None
    if catalogs is not None:
        from presto_tpu_torch.planner.stats import StatsEstimator
        # history-based feedback (presto_tpu/history) is not ported
        # yet: estimates stay analytic
        estimator = StatsEstimator(catalogs)
    # Plans are DAGs (decorrelation shares subtrees), and several rules
    # below rewrite IN PLACE. A node with more than one parent must not
    # be mutated on behalf of one parent — the other consumer would
    # silently see filtered rows. Parent counts are computed once here
    # and consulted by every mutating rule.
    shared, pin = _shared_nodes(root)
    root = _rewrite(root, estimator, shared)
    _push_scan_constraints(root, shared=shared)
    del pin  # keeps every pre-rewrite node alive so the id()s in
    #          `shared` can't be recycled onto freshly built nodes
    return root


def _shared_nodes(root: N.PlanNode) -> Tuple[Set[int], list]:
    """(ids of nodes reachable through MORE than one parent edge,
    strong references to every visited node). The caller must hold the
    reference list as long as it consults the id set — a rewritten-away
    node's address could otherwise be reused by a new node, which would
    then falsely test as shared."""
    counts: Dict[int, int] = {}
    seen: Set[int] = set()
    nodes: list = []

    def visit(n: N.PlanNode) -> None:
        if id(n) in seen:
            return
        seen.add(id(n))
        nodes.append(n)
        for s in n.sources():
            counts[id(s)] = counts.get(id(s), 0) + 1
            visit(s)

    visit(root)
    return {i for i, c in counts.items() if c > 1}, nodes


def _push_scan_constraints(node: N.PlanNode,
                           _seen: Optional[set] = None,
                           shared: Optional[Set[int]] = None) -> None:
    """Derive TupleDomains from Filter-over-TableScan conjuncts and
    attach them to the scan (reference: PickTableLayout /
    PredicatePushDown into ConnectorPageSourceProvider). The filter
    stays in the plan — pushdown is advisory; connectors that honor it
    shrink generation/decode/transfer work. A scan with another parent
    besides this filter is left alone: narrowing it would drop rows the
    other consumer needs."""
    seen = _seen if _seen is not None else set()
    if id(node) in seen:
        return
    seen.add(id(node))
    if isinstance(node, N.FilterNode) and \
            isinstance(node.source, N.TableScanNode) \
            and (shared is None or id(node.source) not in shared):
        dom = _extract_domains(node.predicate, node.source)
        if dom:
            node.source.constraint = dom
    for s in node.sources():
        _push_scan_constraints(s, seen, shared)


def _extract_domains(pred: RowExpression, scan: N.TableScanNode):
    from presto_tpu_torch.connectors.spi import Domain, TupleDomain
    sym_to_col = dict(scan.assignments)
    ok_types = {"bigint", "integer", "double", "date", "boolean"}
    # varchar comparisons push down as CODES into the scan's TABLE
    # dictionary (stable at plan time — the per-batch instability only
    # affects expression-derived strings); an equality literal absent
    # from the dictionary prunes everything via an empty IN-set
    dict_of = {f.symbol: f.dictionary for f in scan.output
               if f.dictionary is not None}

    def encode(sym: str, value):
        """string literal -> dictionary code; None = not encodable,
        () = provably matches nothing."""
        dic = dict_of.get(sym)
        if dic is None:
            return None
        try:
            return dic.index(value)
        except ValueError:
            return ()
    doms: Dict[str, Dict[str, object]] = {}

    def note(sym: str, kind: str, value):
        col = sym_to_col.get(sym)
        if col is None:
            return
        d = doms.setdefault(col, {})
        if kind == "low":
            d["low"] = value if "low" not in d else max(d["low"], value)
        elif kind == "high":
            d["high"] = value if "high" not in d \
                else min(d["high"], value)
        else:  # in-set intersection
            vs = set(value)
            d["values"] = tuple(sorted(vs & set(d["values"]))) \
                if "values" in d else tuple(sorted(vs))

    from presto_tpu_torch.expr.ir import Literal
    for c in _split_conjuncts(pred):
        if isinstance(c, SpecialForm) and c.form == "in":
            v, *items = c.args
            if not (isinstance(v, InputRef)
                    and all(isinstance(i, Literal)
                            and i.value is not None for i in items)):
                continue
            if v.type.name in ok_types:
                note(v.name, "in", [i.value for i in items])
            elif v.type.is_string and v.name in dict_of:
                codes = [encode(v.name, i.value) for i in items]
                note(v.name, "in",
                     [x for x in codes if x not in (None, ())])
            continue
        if isinstance(c, Call) and len(c.args) == 2:
            from presto_tpu_torch.expr.ir import FLIP_COMPARISON
            a, b = c.args
            if isinstance(b, InputRef) and not isinstance(a, InputRef):
                a, b = b, a
                if c.name not in FLIP_COMPARISON \
                        or c.name == "not_equal":
                    continue
                name = FLIP_COMPARISON[c.name]
            else:
                name = c.name
            if not (isinstance(a, InputRef) and isinstance(b, Literal)
                    and b.value is not None):
                continue
            if a.type.is_string and a.name in dict_of:
                # equality only: enough for partition pruning and
                # remote-SQL pushdown (ranges would also be sound —
                # dictionaries sort ascending — just not needed yet)
                if name != "equal":
                    continue
                code = encode(a.name, b.value)
                if code == ():
                    note(a.name, "in", [])
                elif code is not None:
                    note(a.name, "in", [code])
                continue
            if a.type.name not in ok_types:
                continue
            v = b.value
            if name == "equal":
                note(a.name, "low", v)
                note(a.name, "high", v)
            elif name in ("less_than", "less_than_or_equal"):
                note(a.name, "high", v)  # open bounds kept closed:
                # the engine's filter still enforces strictness
            elif name in ("greater_than", "greater_than_or_equal"):
                note(a.name, "low", v)
    if not doms:
        return None
    return TupleDomain(tuple(
        (col, Domain(d.get("low"), d.get("high"), d.get("values")))
        for col, d in sorted(doms.items())))


def _rewrite(node: N.PlanNode, estimator=None,
             shared: Optional[Set[int]] = None,
             memo: Optional[Dict[int, N.PlanNode]] = None) -> N.PlanNode:
    shared = shared if shared is not None else set()
    # Memoized by id: a DAG-shared node is rewritten ONCE and every
    # parent receives the SAME result object — re-running the rewrite
    # per parent would both stack duplicate pushed filters onto a
    # shared join input and hand each parent a distinct copy, breaking
    # the local planner's id-based CSE/spool sharing.
    memo = memo if memo is not None else {}
    hit = memo.get(id(node))
    if hit is not None:
        return hit
    orig_id = id(node)
    # rewrite children first
    for attr in ("source", "left", "right", "filtering_source"):
        if hasattr(node, attr):
            setattr(node, attr,
                    _rewrite(getattr(node, attr), estimator, shared,
                             memo))
    if isinstance(node, N.UnionNode):
        node.inputs = [_rewrite(x, estimator, shared, memo)
                       for x in node.inputs]
    out = node
    if isinstance(node, N.FilterNode):
        fused = _fuse_topn_row_number(node, shared)
        pushed = None if fused is not None else \
            _push_filter_through_join(node, estimator, shared)
        if fused is not None:
            out = fused
        elif pushed is not None:
            out = pushed
        else:
            out = _rewrite_filter(node, estimator)
    memo[orig_id] = out
    return out


def _push_filter_through_join(node: N.FilterNode, estimator=None,
                              shared: Optional[Set[int]] = None
                              ) -> Optional[N.PlanNode]:
    """Filter over an explicit JOIN: push single-side conjuncts below
    the join (reference: PredicatePushDown.java's visitJoin). Inner
    joins push to both inputs; LEFT joins only to the preserved (left)
    input — filtering the nullable side above vs below an outer join
    differs. The pushed filters re-enter _rewrite so they keep sinking
    through nested joins and onto scan constraints.

    The rewrite MUTATES the JoinNode (src.left/right/output), so it is
    skipped when the join or either input has another parent — pushing
    one consumer's predicate into a shared subtree would filter the
    other consumer's rows."""
    src = node.source
    if not isinstance(src, N.JoinNode) \
            or src.join_type not in ("inner", "left"):
        return None
    if shared and (id(src) in shared or id(src.left) in shared
                   or id(src.right) in shared):
        return None
    left_syms = {f.symbol for f in src.left.output}
    right_syms = {f.symbol for f in src.right.output}
    push_left: List[RowExpression] = []
    push_right: List[RowExpression] = []
    remaining: List[RowExpression] = []
    for c in _split_conjuncts(node.predicate):
        refs = _refs(c)
        if refs and refs <= left_syms:
            push_left.append(c)
        elif refs and refs <= right_syms and src.join_type == "inner":
            push_right.append(c)
        else:
            remaining.append(c)
    if not push_left and not push_right:
        return None
    if push_left:
        src.left = _rewrite(
            N.FilterNode(src.left, _combine_conjuncts(push_left),
                         tuple(src.left.output)), estimator, shared)
    if push_right:
        src.right = _rewrite(
            N.FilterNode(src.right, _combine_conjuncts(push_right),
                         tuple(src.right.output)), estimator, shared)
    if remaining:
        return N.FilterNode(src, _combine_conjuncts(remaining),
                            node.output)
    keep = {f.symbol for f in node.output}
    src.output = tuple(f for f in src.output if f.symbol in keep)
    return src


_RANK_FUNCTIONS = ("row_number", "rank", "dense_rank")


def _rank_bound(conj: RowExpression,
                rn_sym: str) -> Optional[Tuple[int, bool]]:
    """(N, subsumed) such that `conj` implies rank <= N; `subsumed`
    means the TopN cut fully enforces the conjunct (pure upper bound,
    in either literal position) so no residual filter is needed."""
    from presto_tpu_torch.expr.ir import FLIP_COMPARISON, Literal
    if not (isinstance(conj, Call) and len(conj.args) == 2):
        return None
    a, b = conj.args
    name = conj.name
    if isinstance(b, InputRef) and isinstance(a, Literal):
        a, b = b, a
        name = FLIP_COMPARISON.get(name)
    if not (isinstance(a, InputRef) and a.name == rn_sym
            and isinstance(b, Literal)
            and isinstance(b.value, int)):
        return None
    if name == "less_than_or_equal":
        return b.value, True
    if name == "less_than":
        return b.value - 1, True
    if name == "equal":
        return b.value, False
    return None


def _fuse_topn_row_number(node: N.FilterNode,
                          shared: Optional[Set[int]] = None
                          ) -> Optional[N.PlanNode]:
    """Filter(Window[single rank-family call]) with a rank <= N
    conjunct -> TopNRowNumberNode (+ residual Filter), peeling one
    rename-only Project (the subquery-projection shape). Reference:
    PushdownFilterIntoWindow / TopNRowNumberOperator. The only in-place
    mutation is `proj.source = topn`, so the fusion is skipped exactly
    when that peeled Project has another parent (a shared Window input
    is fine — the new TopN node only READS it)."""
    win = node.source
    proj: Optional[N.ProjectNode] = None
    rename_to_src: Dict[str, str] = {}
    if isinstance(win, N.ProjectNode) \
            and all(isinstance(e, InputRef)
                    for _, e in win.assignments):
        if shared and id(win) in shared:
            return None
        proj = win
        rename_to_src = {s: e.name for s, e in win.assignments}
        win = win.source
    if not (isinstance(win, N.WindowNode) and len(win.calls) == 1):
        return None
    call = win.calls[0]
    if call.function not in _RANK_FUNCTIONS or not win.order_by:
        return None
    rn = call.out_symbol
    # the predicate sees the (possibly renamed) rank symbol
    rn_outs = {rn} if proj is None else {
        o for o, src in rename_to_src.items() if src == rn}
    conjs = _split_conjuncts(node.predicate)
    bound = None
    residual: List[RowExpression] = []
    for c in conjs:
        hit = None
        for rn_out in rn_outs:
            hit = _rank_bound(c, rn_out)
            if hit is not None:
                break
        if hit is not None:
            b, subsumed = hit
            bound = b if bound is None else min(bound, b)
            if not subsumed:
                residual.append(c)  # e.g. rank = N still filters
        else:
            residual.append(c)
    if bound is None or bound > 100_000 or bound < 1:
        return None
    topn = N.TopNRowNumberNode(
        win.source, list(win.partition_by), list(win.order_by),
        list(win.descending), list(win.nulls_first), call.function,
        rn, bound, tuple(win.output))
    inner: N.PlanNode = topn
    if proj is not None:
        proj.source = topn
        inner = proj
    if residual:
        return N.FilterNode(inner, _combine_conjuncts(residual),
                            node.output)
    return inner


def _split_conjuncts(e: RowExpression) -> List[RowExpression]:
    if isinstance(e, SpecialForm) and e.form == "and":
        out: List[RowExpression] = []
        for a in e.args:
            out.extend(_split_conjuncts(a))
        return out
    return [e]


def _combine_conjuncts(parts: List[RowExpression]) -> RowExpression:
    assert parts
    e = parts[0]
    for p in parts[1:]:
        e = SpecialForm("and", (e, p), BOOLEAN)
    return e


def _refs(e: RowExpression) -> Set[str]:
    return {x.name for x in walk(e) if isinstance(x, InputRef)}


def _flatten_cross(node: N.PlanNode, leaves: List[N.PlanNode]) -> bool:
    """Collect the leaves of a maximal cross-join subtree."""
    if isinstance(node, N.JoinNode) and node.join_type == "cross" \
            and node.filter is None and not node.criteria:
        _flatten_cross(node.left, leaves)
        _flatten_cross(node.right, leaves)
        return True
    leaves.append(node)
    return False


def _rewrite_filter(node: N.FilterNode, estimator=None) -> N.PlanNode:
    leaves: List[N.PlanNode] = []
    if not _flatten_cross(node.source, leaves) or len(leaves) < 2:
        return node
    conjuncts = _split_conjuncts(node.predicate)
    leaf_syms = [{f.symbol for f in leaf.output} for leaf in leaves]

    # 1. push single-side conjuncts down onto their leaf
    pushed: List[List[RowExpression]] = [[] for _ in leaves]
    remaining: List[RowExpression] = []
    join_preds: List[Tuple[RowExpression, str, str]] = []
    for c in conjuncts:
        refs = _refs(c)
        homes = [i for i, syms in enumerate(leaf_syms) if refs & syms]
        if len(homes) == 1 and refs <= leaf_syms[homes[0]]:
            pushed[homes[0]].append(c)
            continue
        pair = _equi_symbols(c)
        if pair is not None:
            l, r = pair
            li = next((i for i, s in enumerate(leaf_syms) if l in s), None)
            ri = next((i for i, s in enumerate(leaf_syms) if r in s), None)
            if li is not None and ri is not None and li != ri:
                join_preds.append((c, l, r))
                continue
        remaining.append(c)

    new_leaves: List[N.PlanNode] = []
    for leaf, preds in zip(leaves, pushed):
        if preds:
            out = tuple(leaf.output)
            new_leaves.append(
                N.FilterNode(leaf, _combine_conjuncts(preds), out))
        else:
            new_leaves.append(leaf)

    # 2. greedy left-deep join tree over the predicate graph,
    # cost-based when stats are available (reference: ReorderJoins —
    # at each step take the connected leaf minimizing the estimated
    # intermediate size; probes accumulate left, builds join right)
    used = [False] * len(new_leaves)
    order = _initial_leaf(join_preds, leaf_syms, new_leaves, estimator)
    current = new_leaves[order]
    used[order] = True
    current_syms = set(leaf_syms[order])
    unused_preds = list(join_preds)

    def criteria_for(i):
        crit = []
        for (c, l, r) in unused_preds:
            if l in current_syms and r in leaf_syms[i]:
                crit.append(((l, r), c))
            elif r in current_syms and l in leaf_syms[i]:
                crit.append(((r, l), c))
        return crit

    while not all(used):
        connected = [i for i in range(len(new_leaves))
                     if not used[i] and criteria_for(i)]
        if not connected:  # disconnected: true cross join
            best = next(i for i, u in enumerate(used) if not u)
            criteria: List[Tuple[str, str]] = []
            taken: List[RowExpression] = []
        else:
            if estimator is not None and len(connected) > 1:
                def joined_rows(i):
                    probe = N.JoinNode(
                        "inner", current, new_leaves[i],
                        [p for p, _ in criteria_for(i)],
                        tuple(current.output)
                        + tuple(new_leaves[i].output))
                    return estimator.estimate(probe).rows
                best = min(connected, key=joined_rows)
            else:
                best = connected[0]
            pairs = criteria_for(best)
            criteria = [p for p, _ in pairs]
            taken = [c for _, c in pairs]
        unused_preds = [p for p in unused_preds if p[0] not in
                        [t for t in taken]]
        leaf = new_leaves[best]
        out = tuple(list(current.output) + list(leaf.output))
        jt = "inner" if criteria else "cross"
        current = N.JoinNode(jt, current, leaf, criteria, out)
        current_syms |= leaf_syms[best]
        used[best] = True

    # leftover join preds (e.g. third-table equalities) become filters
    remaining.extend(p[0] for p in unused_preds)
    if remaining:
        return N.FilterNode(current, _combine_conjuncts(remaining),
                            node.output)
    # preserve the original filter's (possibly narrower) output
    if [f.symbol for f in current.output] != \
            [f.symbol for f in node.output]:
        keep = {f.symbol for f in node.output}
        current.output = tuple(f for f in current.output
                               if f.symbol in keep)
    return current


def _initial_leaf(join_preds, leaf_syms, leaves, estimator=None) -> int:
    """Start from the largest relation so it stays on the probe side
    (builds should be the smaller inputs). With stats: the leaf with
    the most estimated rows; without: the most-connected leaf is
    usually the fact table."""
    if estimator is not None:
        return max(range(len(leaves)),
                   key=lambda i: estimator.estimate(leaves[i]).rows)
    degree = [0] * len(leaves)
    for (_, l, r) in join_preds:
        for i, syms in enumerate(leaf_syms):
            if l in syms or r in syms:
                degree[i] += 1
    return max(range(len(leaves)), key=lambda i: degree[i])


def _equi_symbols(c: RowExpression) -> Optional[Tuple[str, str]]:
    if isinstance(c, Call) and c.name == "equal":
        a, b = c.args
        if isinstance(a, InputRef) and isinstance(b, InputRef):
            return (a.name, b.name)
    return None
