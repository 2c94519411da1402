"""Plan sanity checking between planner passes (reference:
presto-main sql/planner/sanity/PlanSanityChecker — the
ValidateDependenciesChecker / NoDuplicatePlanNodeIdsChecker /
TypeValidator battery run after analysis and after every optimizer
pass, so a pass that corrupts the plan fails AT the pass, not three
layers later as a wrong answer or an operator crash).

Our planning pipeline has four mutating passes — optimizer.py (in-place
predicate pushdown / join reordering), exchanges.py (AddExchanges +
fragmentation), fusion.py (pipeline-level chain collapse), and the
local_planner handoff (prune_unused_columns mutates output tuples) —
whose invariants were previously enforced only by byte-identity oracles
after the fact.  The `PlanChecker` here makes them machine-checked:

  * per-node symbol resolution: every symbol a node references must be
    produced by its children (`dangling-symbol`), and no node may emit
    the same physical column symbol twice (`duplicate-output-symbol`)
  * graph shape: the plan is a DAG — in-place rewrites must never
    create a cycle (`plan-cycle`)
  * exchange legality: schemes are known, partition keys resolve in
    the exchange's input, non-repartition schemes carry no keys, and
    an exchange preserves its source schema (`exchange-*`)
  * fragment consistency: unique fragment/exchange ids, every
    RemoteSourceNode resolves to an edge of ITS fragment with a
    matching scheme and schema, repartition edges' keys resolve in the
    producer's output, gather edges feed single fragments — the
    precondition for sharding-preserving stage boundaries
    (`duplicate-fragment-id`, `duplicate-exchange-id`,
    `dangling-remote-source`, `edge-partitioning`)
  * expression typing: every RowExpression a node evaluates passes
    the static type/null checker (analysis/expr_types.py) — boolean
    contexts, comparison/arithmetic promotion, special-form result
    types (`expr-type`)
  * determinism: `expr_deterministic` / `plan_deterministic` are
    kept for the fragment cache of a later slice of the port (the
    reference cross-checks them against cache/fingerprint.py)

Violations raise `PlanValidationError` naming the PASS that introduced
the breakage.  Gated by the `plan_validation_enabled` session property
(default ON — tree walks are cheap next to XLA compiles).  The checker
NEVER mutates the plan: results with validation on are byte-identical
to validation off (asserted by tests/test_plan_validation.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Set, Tuple

from presto_tpu_torch.expr.ir import Call, InputRef, walk
from presto_tpu_torch.planner import nodes as N

#: functions whose result depends on more than their arguments; a
#: fragment containing one must never be served from cache. THE one
#: audited list — cache/fingerprint.py and the fused-chain fingerprint
#: both classify through it (previously scattered ad-hoc copies).
NONDETERMINISTIC_FUNCTIONS = frozenset({
    "random", "rand", "uuid", "now", "current_timestamp", "shuffle",
})

#: exchange schemes the engine defines (nodes.ExchangeNode docstring)
EXCHANGE_SCHEMES = frozenset(
    {"repartition", "gather", "broadcast", "passthrough"})


@dataclasses.dataclass(frozen=True)
class Violation:
    """One invariant breach. `rule` is a stable id (tests and the
    corruption battery match on it), `where` names the node or
    fragment, `detail` is the human rendering."""
    rule: str
    where: str
    detail: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.where}: {self.detail}"


class PlanValidationError(Exception):
    """A planner pass broke a plan invariant. `pass_name` names the
    pass that ran immediately before the failing check — the pass
    that INTRODUCED the breakage, since every pass boundary is
    checked."""

    def __init__(self, pass_name: str,
                 violations: Sequence[Violation]):
        self.pass_name = pass_name
        self.violations = list(violations)
        lines = "\n  ".join(str(v) for v in self.violations)
        super().__init__(
            f"plan validation failed after pass {pass_name!r} "
            f"({len(self.violations)} violation"
            f"{'s' if len(self.violations) != 1 else ''}):\n  {lines}")


def validation_enabled(session) -> bool:
    """The `plan_validation_enabled` gate (default ON)."""
    from presto_tpu_torch.session_properties import get_property
    props = getattr(session, "properties", None)
    if props is None:
        props = session if isinstance(session, dict) else {}
    return bool(get_property(props, "plan_validation_enabled"))


# ---------------------------------------------------------------------------
# determinism classification (the ONE audited analysis)


def expr_deterministic(e) -> bool:
    """True when `e` contains no call to a nondeterministic function.
    None (absent expression) is deterministic."""
    if e is None:
        return True
    for x in walk(e):
        if isinstance(x, Call) and x.name in NONDETERMINISTIC_FUNCTIONS:
            return False
    return True


def node_expressions(node: N.PlanNode) -> List:
    """Every RowExpression a plan node evaluates — the shared
    enumeration behind symbol resolution AND determinism
    classification (one analysis, several consumers)."""
    out: List = []
    if isinstance(node, N.FilterNode):
        out.append(node.predicate)
    elif isinstance(node, N.ProjectNode):
        out.extend(e for _, e in node.assignments)
    elif isinstance(node, N.AggregationNode):
        out.extend(e for _, e in node.keys)
        for a in node.aggregates:
            out.extend(x for x in (a.argument, a.argument2, a.filter)
                       if x is not None)
    elif isinstance(node, N.JoinNode):
        if node.filter is not None:
            out.append(node.filter)
    return out


def plan_deterministic(node: N.PlanNode) -> bool:
    """True when no expression anywhere in the subtree calls a
    nondeterministic function — the audited classification behind
    fragment-cache eligibility."""
    seen: Set[int] = set()
    stack = [node]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        for e in node_expressions(n):
            if not expr_deterministic(e):
                return False
        stack.extend(n.sources())
    return True


# ---------------------------------------------------------------------------
# plan-tree checks


def _field_symbols(f: N.Field) -> List[str]:
    """Physical column symbols of an output field (complex-typed
    fields expose their slot columns; the named symbol has no physical
    column but stays referencable at plan level)."""
    form = getattr(f, "form", None)
    if form is None:
        return [f.symbol]
    return N.form_slot_symbols(form)


def _produced(node: N.PlanNode) -> Set[str]:
    """Symbols a node's output makes available to its consumer: every
    field's physical slot symbols plus its named symbol."""
    out: Set[str] = set()
    for f in node.output:
        out.add(f.symbol)
        out.update(_field_symbols(f))
    return out


def _available(node: N.PlanNode) -> Set[str]:
    avail: Set[str] = set()
    for s in node.sources():
        avail |= _produced(s)
    return avail


def _slot_bases(avail: Set[str]) -> Set[str]:
    """Base names of slot-convention columns (`x__a0`, `x__len`,
    `x__s1` -> `x`): a consumer may reference a complex/state symbol
    by its NAME while the child carries only its exploded slots."""
    return {a.split("__", 1)[0] for a in avail if "__" in a}


def _resolves(sym: str, avail: Set[str], bases: Set[str]) -> bool:
    return sym in avail or sym in bases


def _refs(e) -> Set[str]:
    return {x.name for x in walk(e) if isinstance(x, InputRef)}


class PlanChecker:
    """Walks a plan (or fragmented plan, or fused pipelines) and
    collects violations; raises `PlanValidationError` attributed to
    the given pass. Stateless between calls — safe to share."""

    # -- entry points --------------------------------------------------

    def check_plan(self, root: N.PlanNode, pass_name: str,
                   catalogs=None) -> None:
        # `catalogs` armed the fragment-cache determinism cross-check
        # in the reference; the port has no fragment cache yet
        violations: List[Violation] = []
        order = self._walk_acyclic(root, violations)
        for node in order:
            self._check_node(node, violations)
        if violations:
            raise PlanValidationError(pass_name, violations)

    def check_fragments(self, fplan, pass_name: str) -> None:
        """Producer/consumer consistency of a FragmentedPlan
        (exchanges.fragment_plan output)."""
        violations: List[Violation] = []
        self._check_fragments(fplan, violations)
        if violations:
            raise PlanValidationError(pass_name, violations)

    @staticmethod
    def snapshot_pipelines(pipelines: Sequence[Sequence]) -> List[List]:
        """Pre-fusion snapshot: per pipeline, (operator_id, fusible,
        name) per factory — `fusible` marks the FilterProject stages
        fusion is ALLOWED to absorb; everything else is a barrier."""
        from presto_tpu_torch.operators import fused_fragment as ff
        snap: List[List] = []
        for pipe in pipelines:
            snap.append([
                (f.operator_id,
                 ff.stages_from_factory(f) is not None,
                 getattr(f, "name", type(f).__name__))
                for f in pipe])
        return snap

    def check_fusion(self, snapshot: Sequence[Sequence],
                     pipelines: Sequence[Sequence],
                     id_remap: Dict[int, int],
                     pass_name: str = "fusion") -> None:
        """Fused-chain barrier legality: fusion may only absorb
        adjacent fusible (FilterProject) factories; every barrier
        operator of the pre-fusion pipelines must survive."""
        violations: List[Violation] = []
        surviving = {f.operator_id for pipe in pipelines for f in pipe}
        fusible: Dict[int, bool] = {}
        name_of: Dict[int, str] = {}
        index_of: Dict[int, Tuple[int, int]] = {}
        for pi, pipe in enumerate(snapshot):
            for i, (op_id, fus, name) in enumerate(pipe):
                fusible[op_id] = fus
                name_of[op_id] = name
                index_of[op_id] = (pi, i)
        absorbed_by: Dict[int, List[int]] = {}
        for src, dst in id_remap.items():
            absorbed_by.setdefault(dst, []).append(src)
        for op_id, fus in fusible.items():
            if op_id in surviving or op_id in id_remap:
                continue
            violations.append(Violation(
                "fusion-dropped-operator", name_of[op_id],
                f"operator {op_id} vanished during fusion without "
                "being absorbed into a fused kernel"))
        for src, dst in id_remap.items():
            if not fusible.get(src, False):
                violations.append(Violation(
                    "fusion-barrier", name_of.get(src, f"op {src}"),
                    f"fusion absorbed barrier operator {src} "
                    f"({name_of.get(src, '?')}) into {dst} — chains "
                    "must not span record/replay/spool/exchange "
                    "barriers"))
        for dst, srcs in absorbed_by.items():
            if dst not in index_of:
                violations.append(Violation(
                    "fusion-nonadjacent", f"op {dst}",
                    f"fused target {dst} absent from the pre-fusion "
                    "pipelines"))
                continue
            dpi, di = index_of[dst]
            idxs = []
            bad = False
            for src in srcs:
                if src not in index_of or index_of[src][0] != dpi:
                    violations.append(Violation(
                        "fusion-nonadjacent", name_of.get(
                            src, f"op {src}"),
                        f"operator {src} fused into {dst} from a "
                        "different pipeline"))
                    bad = True
                    continue
                idxs.append(index_of[src][1])
            if bad or not idxs:
                continue
            run = sorted(idxs + [di])
            if run != list(range(run[0], run[0] + len(run))):
                violations.append(Violation(
                    "fusion-nonadjacent", name_of[dst],
                    f"operators {sorted(idxs)} fused into {dst} were "
                    "not adjacent in the pre-fusion pipeline"))
        if violations:
            raise PlanValidationError(pass_name, violations)

    # -- plan-tree internals -------------------------------------------

    @staticmethod
    def _walk_acyclic(root: N.PlanNode,
                      violations: List[Violation]) -> List[N.PlanNode]:
        """DFS collecting each node once; a back edge (a node reached
        again while still on the current path) is a cycle — in-place
        rewrites must never create one. Iterative: corrupt plans must
        not blow the recursion limit before they are diagnosed."""
        order: List[N.PlanNode] = []
        seen: Set[int] = set()
        on_path: Set[int] = set()
        stack: List[Tuple[N.PlanNode, bool]] = [(root, False)]
        while stack:
            node, leaving = stack.pop()
            if leaving:
                on_path.discard(id(node))
                continue
            if id(node) in on_path:
                violations.append(Violation(
                    "plan-cycle", type(node).__name__,
                    "plan graph contains a cycle (a rewrite linked a "
                    "node to its own ancestor)"))
                continue
            if id(node) in seen:
                continue
            seen.add(id(node))
            on_path.add(id(node))
            order.append(node)
            stack.append((node, True))
            for s in node.sources():
                stack.append((s, False))
        return order

    def _check_node(self, node: N.PlanNode,
                    violations: List[Violation]) -> None:
        name = type(node).__name__

        def bad(rule: str, detail: str) -> None:
            violations.append(Violation(rule, name, detail))

        # static expression typing (analysis/expr_types): a planner
        # pass that builds an ill-typed expression is named HERE, at
        # the pass boundary, instead of failing inside a kernel trace
        from presto_tpu_torch.analysis.expr_types import check_expression
        for e in node_expressions(node):
            for msg in check_expression(e):
                bad("expr-type", msg)

        # duplicate physical output columns
        seen_syms: Set[str] = set()
        for f in node.output:
            for sym in _field_symbols(f):
                if sym in seen_syms:
                    bad("duplicate-output-symbol",
                        f"output emits column {sym!r} twice")
                seen_syms.add(sym)

        avail = _available(node)
        bases = _slot_bases(avail)

        def resolve(sym: str, what: str) -> None:
            if not _resolves(sym, avail, bases):
                bad("dangling-symbol",
                    f"{what} references {sym!r}, which no child "
                    "produces")

        def resolve_expr(e, what: str) -> None:
            for sym in _refs(e):
                resolve(sym, what)

        if isinstance(node, N.TableScanNode):
            for f in node.output:
                for sym in _field_symbols(f):
                    if sym not in node.assignments:
                        bad("dangling-symbol",
                            f"scan output {sym!r} has no connector "
                            "column assignment")
        elif isinstance(node, N.FilterNode):
            resolve_expr(node.predicate, "filter predicate")
            self._check_passthrough(node, avail, bad)
        elif isinstance(node, N.ProjectNode):
            targets: Set[str] = set()
            for sym, e in node.assignments:
                targets.add(sym)
                resolve_expr(e, f"projection {sym!r}")
            for f in node.output:
                for sym in _field_symbols(f):
                    if sym not in targets \
                            and not _resolves(sym, avail, bases):
                        bad("dangling-symbol",
                            f"project output {sym!r} is neither "
                            "assigned nor passed through")
        elif isinstance(node, N.AggregationNode):
            for sym, e in node.keys:
                resolve_expr(e, f"group key {sym!r}")
            for a in node.aggregates:
                for e in (a.argument, a.argument2, a.filter):
                    if e is not None:
                        resolve_expr(
                            e, f"aggregate {a.out_symbol!r}")
            mine = {s for s, _ in node.keys} \
                | {a.out_symbol for a in node.aggregates}
            for f in node.output:
                sym = f.symbol
                base = sym.split("__s")[0]
                if sym not in mine and base not in mine:
                    bad("dangling-symbol",
                        f"aggregation output {sym!r} is neither a "
                        "group key nor an aggregate")
        elif isinstance(node, N.JoinNode):
            left = _produced(node.left)
            right = _produced(node.right)
            for l, r in node.criteria:
                if l not in left:
                    bad("dangling-symbol",
                        f"join criterion left symbol {l!r} not in "
                        "probe output")
                if r not in right:
                    bad("dangling-symbol",
                        f"join criterion right symbol {r!r} not in "
                        "build output")
            if node.filter is not None:
                resolve_expr(node.filter, "join filter")
            self._check_passthrough(node, avail, bad)
        elif isinstance(node, N.SemiJoinNode):
            if node.source_key not in _produced(node.source):
                bad("dangling-symbol",
                    f"semijoin source key {node.source_key!r} not in "
                    "source output")
            if node.filtering_key not in _produced(
                    node.filtering_source):
                bad("dangling-symbol",
                    f"semijoin filtering key {node.filtering_key!r} "
                    "not in filtering source output")
            src = _produced(node.source)
            srcb = _slot_bases(src)
            fresh = [f.symbol for f in node.output
                     if not _resolves(f.symbol, src, srcb)]
            if len(fresh) > 1:
                bad("dangling-symbol",
                    f"semijoin output invents symbols {fresh!r} "
                    "beyond its match marker")
        elif isinstance(node, (N.SortNode, N.MergeNode, N.TopNNode)):
            for k in node.keys:
                resolve(k, "sort key")
            self._check_passthrough(node, avail, bad)
        elif isinstance(node, N.TopNRowNumberNode):
            for k in list(node.partition_by) + list(node.order_by):
                resolve(k, "topn-row-number key")
            extra = avail | {node.row_number_symbol}
            for f in node.output:
                for sym in _field_symbols(f):
                    if not _resolves(sym, extra, bases):
                        bad("dangling-symbol",
                            f"output {sym!r} not produced by child or "
                            "rank column")
        elif isinstance(node, N.WindowNode):
            for k in list(node.partition_by) + list(node.order_by):
                resolve(k, "window key")
            call_outs = set()
            for c in node.calls:
                call_outs.add(c.out_symbol)
                if c.argument is not None:
                    resolve(c.argument,
                            f"window call {c.out_symbol!r}")
                if c.filter is not None:
                    resolve(c.filter,
                            f"window filter {c.out_symbol!r}")
            for f in node.output:
                for sym in _field_symbols(f):
                    if sym not in call_outs \
                            and not _resolves(sym, avail, bases):
                        bad("dangling-symbol",
                            f"window output {sym!r} not produced by "
                            "child or any call")
        elif isinstance(node, N.UnionNode):
            if len(node.inputs) != len(node.symbol_maps):
                bad("dangling-symbol",
                    "union symbol_maps do not match its inputs")
            else:
                for inp, smap in zip(node.inputs, node.symbol_maps):
                    produced = _produced(inp)
                    pbases = _slot_bases(produced)
                    for f in node.output:
                        src = smap.get(f.symbol)
                        if src is None:
                            bad("dangling-symbol",
                                f"union output {f.symbol!r} unmapped "
                                "for one input")
                        elif not _resolves(src, produced, pbases):
                            bad("dangling-symbol",
                                f"union maps {f.symbol!r} to {src!r}, "
                                "which that input does not produce")
        elif isinstance(node, N.AssignUniqueIdNode):
            extra = avail | {node.symbol}
            for f in node.output:
                if not _resolves(f.symbol, extra, bases):
                    bad("dangling-symbol",
                        f"output {f.symbol!r} not produced by child "
                        "or the unique-id column")
        elif isinstance(node, N.GroupIdNode):
            for k in node.all_keys:
                resolve(k, "grouping key")
        elif isinstance(node, N.OutputNode):
            if len(node.names) != len(node.source_symbols):
                bad("dangling-symbol",
                    "output names and source_symbols differ in length")
            for sym in node.source_symbols:
                resolve(sym, "output column")
        elif isinstance(node, N.ExchangeNode):
            self._check_exchange(node, avail, bad)
        elif isinstance(node, N.ValuesNode):
            for i, row in enumerate(node.rows):
                if len(row) != len(node.output):
                    bad("dangling-symbol",
                        f"VALUES row {i} has {len(row)} values for "
                        f"{len(node.output)} columns")
        elif isinstance(node, N.TableWriterNode):
            src = _produced(node.source)
            for col, sym in dict(node.column_sources).items():
                if sym is not None and sym not in src:
                    bad("dangling-symbol",
                        f"writer column {col!r} reads {sym!r}, which "
                        "the source does not produce")
        elif isinstance(node, (N.LimitNode, N.DistinctNode,
                               N.EnforceSingleRowNode,
                               N.TableFinishNode)):
            if not isinstance(node, N.TableFinishNode):
                self._check_passthrough(node, avail, bad)

    @staticmethod
    def _check_passthrough(node: N.PlanNode, avail: Set[str],
                           bad) -> None:
        """Schema-preserving nodes: every output column must come from
        a child."""
        bases = _slot_bases(avail)
        for f in node.output:
            for sym in _field_symbols(f):
                if not _resolves(sym, avail, bases):
                    bad("dangling-symbol",
                        f"output {sym!r} not produced by any child")

    @staticmethod
    def _check_exchange(node: N.ExchangeNode, avail: Set[str],
                        bad) -> None:
        if node.scheme not in EXCHANGE_SCHEMES:
            bad("unknown-exchange-scheme",
                f"scheme {node.scheme!r} is not one of "
                f"{sorted(EXCHANGE_SCHEMES)}")
        if node.scheme != "repartition" and node.partition_keys:
            bad("exchange-keys",
                f"{node.scheme} exchange carries partition keys "
                f"{node.partition_keys!r}")
        for k in node.partition_keys:
            if k not in avail:
                bad("exchange-keys",
                    f"partition key {k!r} not produced by the "
                    "exchange input")
        if node.hash_dicts is not None \
                and len(node.hash_dicts) != len(node.partition_keys):
            bad("exchange-keys",
                f"{len(node.hash_dicts)} hash dicts for "
                f"{len(node.partition_keys)} partition keys")
        # an exchange moves rows, it never changes their schema
        out = [f.symbol for f in node.output]
        src = [f.symbol for f in node.source.output]
        if out != src:
            bad("exchange-schema",
                f"exchange output {out!r} differs from its source "
                f"output {src!r}")

    # -- fragment internals --------------------------------------------

    def _check_fragments(self, fplan,
                         violations: List[Violation]) -> None:
        def bad(rule: str, where: str, detail: str) -> None:
            violations.append(Violation(rule, where, detail))

        for fid, frag in fplan.fragments.items():
            if frag.id != fid:
                bad("duplicate-fragment-id", f"fragment {fid}",
                    f"fragment registered under id {fid} claims id "
                    f"{frag.id}")
        for xid, edge in fplan.edges.items():
            if edge.exchange_id != xid:
                bad("duplicate-exchange-id", f"exchange {xid}",
                    f"edge registered under id {xid} claims id "
                    f"{edge.exchange_id}")
            for role, fid in (("producer", edge.producer),
                              ("consumer", edge.consumer)):
                if fid not in fplan.fragments:
                    bad("dangling-remote-source", f"exchange {xid}",
                        f"{role} fragment {fid} does not exist")
            if edge.producer in fplan.fragments:
                prod_syms = _produced(
                    fplan.fragments[edge.producer].root)
                for f in edge.fields:
                    if f.symbol not in prod_syms:
                        bad("edge-partitioning", f"exchange {xid}",
                            f"edge field {f.symbol!r} not produced by "
                            "producer fragment "
                            f"{edge.producer}'s root")
                if edge.scheme == "repartition":
                    for k in edge.partition_keys:
                        if k not in prod_syms:
                            bad("edge-partitioning",
                                f"exchange {xid}",
                                f"partition key {k!r} not produced "
                                "by producer fragment "
                                f"{edge.producer}")
                elif edge.partition_keys:
                    bad("edge-partitioning", f"exchange {xid}",
                        f"{edge.scheme} edge carries partition keys "
                        f"{edge.partition_keys!r}")
            if edge.scheme == "gather" \
                    and edge.consumer in fplan.fragments \
                    and fplan.fragments[edge.consumer].partitioning \
                    != "single":
                bad("edge-partitioning", f"exchange {xid}",
                    f"gather edge feeds fragment {edge.consumer}, "
                    "whose partitioning is "
                    f"{fplan.fragments[edge.consumer].partitioning!r}"
                    " (must be single)")

        # RemoteSourceNodes: each resolves to an edge of ITS fragment
        claimed: Dict[int, int] = {}
        for fid, frag in fplan.fragments.items():
            for node in self._walk_acyclic(frag.root, violations):
                if not isinstance(node, N.RemoteSourceNode):
                    continue
                xid = node.exchange_id
                edge = fplan.edges.get(xid)
                if edge is None:
                    bad("dangling-remote-source",
                        f"fragment {fid}",
                        f"RemoteSource references unknown exchange "
                        f"{xid}")
                    continue
                prev = claimed.get(xid)
                if prev is not None and prev != id(node):
                    bad("duplicate-exchange-id", f"exchange {xid}",
                        "two RemoteSource nodes claim the same "
                        "exchange id")
                claimed[xid] = id(node)
                if edge.consumer != fid:
                    bad("dangling-remote-source",
                        f"fragment {fid}",
                        f"RemoteSource reads exchange {xid}, whose "
                        f"consumer is fragment {edge.consumer}")
                if edge.producer != node.fragment_id:
                    bad("dangling-remote-source",
                        f"fragment {fid}",
                        f"RemoteSource claims producer fragment "
                        f"{node.fragment_id}; edge {xid} records "
                        f"{edge.producer}")
                if edge.scheme != node.scheme:
                    bad("edge-partitioning", f"fragment {fid}",
                        f"RemoteSource scheme {node.scheme!r} != "
                        f"edge scheme {edge.scheme!r}")
                nsym = [f.symbol for f in node.output]
                esym = [f.symbol for f in edge.fields]
                if nsym != esym:
                    bad("edge-partitioning", f"fragment {fid}",
                        f"RemoteSource schema {nsym!r} != edge "
                        f"schema {esym!r}")


def expr_all_deterministic(node: N.PlanNode) -> bool:
    """Determinism of THIS node's own expressions only (the walk over
    the subtree is plan_deterministic)."""
    return all(expr_deterministic(e) for e in node_expressions(node))


#: the shared checker instance (stateless)
CHECKER = PlanChecker()


def validate(root: N.PlanNode, pass_name: str, session=None,
             catalogs=None) -> None:
    """Convenience gate: run check_plan when the session enables
    validation (or unconditionally when no session is given)."""
    if session is not None and not validation_enabled(session):
        return
    CHECKER.check_plan(root, pass_name, catalogs=catalogs)


def validate_fragments(fplan, pass_name: str, session=None) -> None:
    if session is not None and not validation_enabled(session):
        return
    CHECKER.check_fragments(fplan, pass_name)
