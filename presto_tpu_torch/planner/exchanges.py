"""Distributed planning: exchange insertion + plan fragmentation
(reference: presto_tpu/planner/exchanges.py, whose rules this module
keeps unchanged; the port's stats have no history feedback yet, ROADMAP
A11).

The AddExchanges analog (reference:
sql/planner/optimizations/AddExchanges.java:145) walks the optimized
logical plan bottom-up tracking each subtree's partitioning property
(SystemPartitioningHandle.java:59-67 — SINGLE / SOURCE / FIXED_HASH)
and inserts ExchangeNodes where the consumer's required distribution
differs:

  - aggregation: PARTIAL per worker -> hash repartition on group keys
    (or gather when no keys) -> FINAL merge, via the operator's
    partial/final state-column protocol
  - joins / semijoins: broadcast the build side when its estimated
    cardinality is under `broadcast_join_threshold_rows`, else hash
    repartition both sides on the join keys (equal strings must land on
    equal workers, so repartition hashes through a unified dictionary)
  - distinct: hash repartition on the distinct columns
  - sort / limit / topN / enforce-single-row / output: gather, with
    per-worker partial limit/topN before the gather
  - shared DAG subtrees (planner CSE) are forced into their own
    fragment so they execute exactly once, feeding every consumer
    through its own exchange (the reference materializes shared
    subtrees through output buffers with several buffer ids)

The fragmenter (reference: sql/planner/PlanFragmenter.java:144) then
cuts the plan at ExchangeNodes into Fragments whose leaves are
RemoteSourceNodes; the MeshRunner maps each fragment onto mesh tasks
(single -> 1 task, distributed -> one task per mesh device).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from presto_tpu_torch.expr.ir import InputRef
from presto_tpu_torch.planner import nodes as N
from presto_tpu_torch.planner.local_planner import (
    _shared_nodes, agg_function_for,
)
from presto_tpu_torch.types import DOUBLE, Type


# ---------------------------------------------------------------------------
# Partitioning properties

P_SINGLE = "single"
P_SOURCE = "source"
P_HASH = "hashed"


@dataclasses.dataclass(frozen=True)
class Props:
    """Distribution of a subtree's output rows across workers."""
    kind: str
    keys: Tuple[str, ...] = ()
    dicts: Tuple[Optional[Tuple[str, ...]], ...] = ()


SINGLE = Props(P_SINGLE)
SOURCE = Props(P_SOURCE)


def add_exchanges(root: N.OutputNode, catalogs, session) -> N.OutputNode:
    """Insert ExchangeNodes; mutates the plan in place and returns it."""
    return _Exchanger(catalogs, session).run(root)


class _Exchanger:
    def __init__(self, catalogs, session):
        self.catalogs = catalogs
        from presto_tpu_torch.session_properties import get_property
        self.threshold = int(get_property(
            session.properties, "broadcast_join_threshold_rows"))
        self._memo: Dict[int, Tuple[N.PlanNode, Props]] = {}
        self._shared: set = set()
        from presto_tpu_torch.planner.stats import StatsEstimator
        self._estimator = StatsEstimator(catalogs)

    def run(self, root: N.OutputNode) -> N.OutputNode:
        self._shared = _shared_nodes(root)
        src, props = self._rw(root.source)
        root.source = self._to_single(src, props)
        return root

    # -- helpers -----------------------------------------------------------

    def _exchange(self, node: N.PlanNode, scheme: str,
                  keys: Tuple[str, ...] = (),
                  hash_dicts=None) -> N.ExchangeNode:
        # replace rather than stack a passthrough cut point
        if isinstance(node, N.ExchangeNode) and \
                node.scheme == "passthrough":
            node = node.source
        return N.ExchangeNode(node, scheme, list(keys),
                              tuple(node.output),
                              list(hash_dicts) if hash_dicts else None)

    def _to_single(self, node: N.PlanNode, props: Props) -> N.PlanNode:
        if props.kind == P_SINGLE:
            return node
        return self._exchange(node, "gather")

    def _ensure_hashed(self, node: N.PlanNode, props: Props,
                       keys: Tuple[str, ...], hash_dicts) -> N.PlanNode:
        dicts = tuple(hash_dicts) if hash_dicts \
            else (None,) * len(keys)
        if props.kind == P_HASH and props.keys == keys \
                and props.dicts == dicts:
            return node
        return self._exchange(node, "repartition", keys, dicts)

    def _est(self, node: N.PlanNode) -> float:
        return self._estimator.rows(node)

    # -- the walk ----------------------------------------------------------

    def _rw(self, node: N.PlanNode) -> Tuple[N.PlanNode, Props]:
        if id(node) in self._memo:
            new, props = self._memo[id(node)]
            return self._cut(new, props)
        shared = id(node) in self._shared
        new, props = self._dispatch(node)
        if shared:
            self._memo[id(node)] = (new, props)
            return self._cut(new, props)
        return new, props

    def _cut(self, node: N.PlanNode, props: Props):
        """Force a fragment boundary above a shared subtree; the
        fragmenter maps every exchange over the same source to ONE
        producer fragment with several consumer edges."""
        return (N.ExchangeNode(node, "passthrough", [],
                               tuple(node.output)), props)

    def _dispatch(self, node: N.PlanNode) -> Tuple[N.PlanNode, Props]:
        m = getattr(self, f"_rw_{type(node).__name__}", None)
        if m is not None:
            return m(node)
        # default: single-source node preserving its child distribution
        src, props = self._rw(node.source)
        node.source = src
        return node, props

    def _rw_TableScanNode(self, node):
        return node, SOURCE

    def _rw_ValuesNode(self, node):
        return node, SINGLE

    #: target rows per writer task for the scaled-writer exchange
    #: (reference: ScaledWriterScheduler's per-writer throughput goal,
    #: made static from stats — writers are sized by estimated data
    #: volume instead of growing dynamically)
    ROWS_PER_WRITER = 1 << 18

    def _rw_TableWriterNode(self, node):
        src, props = self._rw(node.source)
        if props.kind == P_SINGLE:
            node.source = src
            return node, SINGLE
        # scaled writers: a round-robin exchange whose consumer
        # fragment runs ceil(rows / ROWS_PER_WRITER) tasks (>= 1),
        # capped by the mesh width at runtime
        est = self._est(src)
        writers = None
        from presto_tpu_torch.planner.stats import UNKNOWN_ROWS
        if est < UNKNOWN_ROWS * 0.99:
            writers = max(1, int(math.ceil(est
                                           / self.ROWS_PER_WRITER)))
        ex = self._exchange(src, "repartition")
        ex.consumer_max_tasks = writers
        node.source = ex
        return node, Props(P_SOURCE)

    def _rw_TableFinishNode(self, node):
        src, props = self._rw(node.source)
        node.source = self._to_single(src, props)
        return node, SINGLE

    def _rw_SortNode(self, node):
        src, props = self._rw(node.source)
        if props.kind == P_SINGLE:
            node.source = src
            return node, SINGLE
        # P11 sorted-merge exchange: each task sorts its shard, the
        # single consumer MERGES the pre-sorted runs (rank-arithmetic
        # pairwise merge) instead of re-sorting the union (reference:
        # MergeOperator.java:44 + SystemPartitioningHandle's
        # FIXED_PASSTHROUGH merge exchanges)
        partial = N.SortNode(src, list(node.keys),
                             list(node.descending),
                             list(node.nulls_first), tuple(src.output))
        gather = self._exchange(partial, "gather")
        return N.MergeNode(gather, node.keys, node.descending,
                           node.nulls_first, node.output), SINGLE

    def _rw_EnforceSingleRowNode(self, node):
        src, props = self._rw(node.source)
        node.source = self._to_single(src, props)
        return node, SINGLE

    def _rw_LimitNode(self, node):
        src, props = self._rw(node.source)
        if props.kind == P_SINGLE:
            node.source = src
            return node, SINGLE
        partial = N.LimitNode(src, node.n, tuple(src.output))
        gather = self._exchange(partial, "gather")
        return N.LimitNode(gather, node.n, node.output), SINGLE

    def _rw_TopNNode(self, node):
        src, props = self._rw(node.source)
        if props.kind == P_SINGLE:
            node.source = src
            return node, SINGLE
        partial = N.TopNNode(src, node.n, list(node.keys),
                             list(node.descending),
                             list(node.nulls_first), tuple(src.output))
        gather = self._exchange(partial, "gather")
        return N.TopNNode(gather, node.n, node.keys, node.descending,
                          node.nulls_first, node.output), SINGLE

    def _rw_DistinctNode(self, node):
        src, props = self._rw(node.source)
        if props.kind == P_SINGLE:
            node.source = src
            return node, SINGLE
        keys = tuple(f.symbol for f in node.output)
        node.source = self._ensure_hashed(src, props, keys, None)
        return node, Props(P_HASH, keys, (None,) * len(keys))

    def _rw_WindowNode(self, node):
        src, props = self._rw(node.source)
        if props.kind == P_SINGLE:
            node.source = src
            return node, SINGLE
        if not node.partition_by:
            # a window over the whole relation needs every row
            node.source = self._to_single(src, props)
            return node, SINGLE
        keys = tuple(node.partition_by)
        node.source = self._ensure_hashed(src, props, keys, None)
        return node, Props(P_HASH, keys, (None,) * len(keys))

    def _rw_TopNRowNumberNode(self, node):
        src, props = self._rw(node.source)
        if props.kind == P_SINGLE:
            node.source = src
            return node, SINGLE
        keys0 = tuple(node.partition_by)
        if keys0 and props.kind == P_HASH and props.keys == keys0 \
                and props.dicts == (None,) * len(keys0):
            # already partitioned on the keys — no exchange will be
            # inserted, so a partial copy would just rank twice
            node.source = src
            return node, props
        # partial pre-filter on every worker: a row's global rank is
        # >= its local rank, so local rank <= N keeps a superset
        partial = N.TopNRowNumberNode(
            src, list(node.partition_by), list(node.order_by),
            list(node.descending), list(node.nulls_first),
            node.function, node.row_number_symbol, node.max_rank,
            tuple(node.output))
        if not node.partition_by:
            node.source = self._exchange(partial, "gather")
            return node, SINGLE
        keys = tuple(node.partition_by)
        node.source = self._ensure_hashed(partial, props, keys, None)
        return node, Props(P_HASH, keys, (None,) * len(keys))

    def _rw_UnionNode(self, node):
        rewritten = [self._rw(x) for x in node.inputs]
        if all(p.kind == P_SINGLE for _, p in rewritten):
            node.inputs = [n for n, _ in rewritten]
            return node, SINGLE
        inputs = []
        for n, p in rewritten:
            if p.kind == P_SINGLE:
                # spread a single-task input over the workers so its
                # subtree is not duplicated in a distributed fragment
                n = self._exchange(n, "repartition", ())
            inputs.append(n)
        node.inputs = inputs
        return node, SOURCE

    # -- aggregation -------------------------------------------------------

    def _rw_AggregationNode(self, node: N.AggregationNode):
        src, props = self._rw(node.source)
        if props.kind == P_SINGLE:
            node.source = src
            return node, SINGLE
        from presto_tpu_torch.planner.local_planner import NO_SPLIT_AGGS
        key_syms = tuple(s for s, _ in node.keys)
        if any(a.distinct or a.function in NO_SPLIT_AGGS
               for a in node.aggregates):
            # distinct aggs (and sketch aggs whose state has no
            # intermediate-column form) cannot split partial/final:
            # co-locate whole groups, then run a SINGLE-step
            # aggregation per worker
            if not key_syms:
                node.source = self._to_single(src, props)
                return node, SINGLE
            src = self._materialize_keys(node, src)
            node.source = self._ensure_hashed(
                src, props, key_syms, None)
            return node, Props(P_HASH, key_syms,
                               (None,) * len(key_syms))
        return self._split_aggregation(node, src, props)

    def _materialize_keys(self, node: N.AggregationNode,
                          src: N.PlanNode) -> N.PlanNode:
        """Project group-key expressions to their output symbols below
        the exchange, rewriting node.keys to bare InputRefs."""
        if all(isinstance(e, InputRef) and e.name == s
               for s, e in node.keys):
            return src
        assignments = [(f.symbol, InputRef(f.symbol, f.type))
                       for f in src.output]
        out_fields = list(src.output)
        for s, e in node.keys:
            assignments.append((s, e))
            out_fields.append(node.field(s))
        proj = N.ProjectNode(src, assignments, tuple(out_fields))
        node.keys = [(s, InputRef(s, node.field(s).type))
                     for s, _ in node.keys]
        return proj

    def _split_aggregation(self, node: N.AggregationNode,
                           src: N.PlanNode, props: Props):
        key_syms = tuple(s for s, _ in node.keys)
        partial_calls: List[N.AggCall] = []
        final_calls: List[N.AggCall] = []
        state_fields: List[N.Field] = []
        for a in node.aggregates:
            eff_in = self._effective_input_type(a)
            # the FILTER gates contributions at the PARTIAL step; the
            # FINAL step merges already-filtered states
            partial_calls.append(N.AggCall(
                a.out_symbol, a.function, a.argument, False,
                a.output_type, eff_in, filter=a.filter))
            final_calls.append(N.AggCall(
                a.out_symbol, a.function, None, False,
                a.output_type, eff_in))
            fn = agg_function_for(a.function, eff_in, a.output_type)
            state_dict = self._arg_dictionary(node, a)
            for i, st in enumerate(fn.intermediate_types):
                d = state_dict if (st.is_string and i == 0) else None
                state_fields.append(
                    N.Field(f"{a.out_symbol}__s{i}", st, d))
        key_fields = [node.field(s) for s in key_syms]
        partial = N.AggregationNode(
            src, list(node.keys), partial_calls, "partial",
            tuple(key_fields) + tuple(state_fields))
        if key_syms:
            ex = self._exchange(partial, "repartition", key_syms,
                                None)
            final_props = Props(P_HASH, key_syms,
                                (None,) * len(key_syms))
        else:
            ex = self._exchange(partial, "gather")
            final_props = SINGLE
        final_keys = [(s, InputRef(s, node.field(s).type))
                      for s in key_syms]
        final = N.AggregationNode(ex, final_keys, final_calls, "final",
                                  node.output)
        return final, final_props

    @staticmethod
    def _effective_input_type(a: N.AggCall) -> Optional[Type]:
        from presto_tpu_torch.planner.local_planner import DOUBLE_INPUT_AGGS
        if a.argument is None:
            return None
        t = a.argument.type
        if a.function in DOUBLE_INPUT_AGGS and t.is_decimal:
            return DOUBLE  # matches the local planner's pre-agg cast
        return t

    @staticmethod
    def _arg_dictionary(node: N.AggregationNode, a: N.AggCall):
        if a.function in ("min", "max"):
            try:
                return node.field(a.out_symbol).dictionary
            except KeyError:
                return None
        return None

    # -- joins -------------------------------------------------------------

    def _rw_JoinNode(self, node: N.JoinNode):
        left, lp = self._rw(node.left)
        right, rp = self._rw(node.right)
        if lp.kind == P_SINGLE and rp.kind == P_SINGLE:
            node.left, node.right = left, right
            return node, SINGLE
        if node.join_type == "cross" or not node.criteria:
            # nested-loop: replicate the build (right) side; a SINGLE
            # probe instead pulls the build to its one task — a single
            # subtree embedded in a distributed fragment would be
            # re-executed (duplicated) by every task
            node.left = left
            if lp.kind == P_SINGLE:
                node.right = self._to_single(right, rp)
                return node, SINGLE
            node.right = self._exchange(right, "broadcast")
            return node, lp
        # the local planner probes with the row-preserving side: for a
        # RIGHT join it swaps, making the LEFT child the build side
        build_attr = "left" if node.join_type == "right" else "right"
        build_node = left if build_attr == "left" else right
        build_props = lp if build_attr == "left" else rp
        probe_props = rp if build_attr == "left" else lp
        # a FULL join's build side must never be broadcast: every task
        # would re-emit the replicated unmatched build rows. Hash both
        # sides so each task owns its build partition (the reference
        # forbids REPLICATED full joins the same way). Pulling the
        # build to a SINGLE probe task is still fine — one owner.
        small_build_ok = self._est(build_node) <= self.threshold \
            and (node.join_type != "full"
                 or probe_props.kind == P_SINGLE)
        if small_build_ok:
            if probe_props.kind == P_SINGLE:
                # keep the whole join on the probe's single task
                bc = self._to_single(build_node, build_props)
            else:
                bc = self._exchange(build_node, "broadcast")
            if build_attr == "left":
                node.left, node.right = bc, right
            else:
                node.left, node.right = left, bc
            return node, probe_props
        lkeys = tuple(l for l, _ in node.criteria)
        rkeys = tuple(r for _, r in node.criteria)
        dicts = tuple(
            _pair_dict(_field(left, l), _field(right, r))
            for (l, r) in node.criteria)
        node.left = self._ensure_hashed(left, lp, lkeys, dicts)
        node.right = self._ensure_hashed(right, rp, rkeys, dicts)
        # the declared keys must be NON-NULL-extended in the output:
        # a RIGHT join NULL-extends the left side (unmatched right
        # rows land by hash(rkey) with lkey NULL on many tasks), and a
        # FULL join NULL-extends both — claiming P_HASH there would
        # let a downstream _ensure_hashed skip a needed re-exchange
        # and emit per-task NULL groups
        if node.join_type == "full":
            return node, SOURCE
        if node.join_type == "right":
            return node, Props(P_HASH, rkeys, dicts)
        return node, Props(P_HASH, lkeys, dicts)

    def _rw_SemiJoinNode(self, node: N.SemiJoinNode):
        src, sp = self._rw(node.source)
        filt, fp = self._rw(node.filtering_source)
        if sp.kind == P_SINGLE and fp.kind == P_SINGLE:
            node.source, node.filtering_source = src, filt
            return node, SINGLE
        if self._est(filt) <= self.threshold:
            node.source = src
            if sp.kind == P_SINGLE:
                node.filtering_source = self._to_single(filt, fp)
            else:
                node.filtering_source = self._exchange(filt, "broadcast")
            return node, sp
        d = (_pair_dict(_field(src, node.source_key),
                        _field(filt, node.filtering_key)),)
        node.source = self._ensure_hashed(
            src, sp, (node.source_key,), d)
        node.filtering_source = self._ensure_hashed(
            filt, fp, (node.filtering_key,), d)
        return node, Props(P_HASH, (node.source_key,), d)


def _field(node: N.PlanNode, symbol: str) -> N.Field:
    return node.field(symbol)


def _pair_dict(lf: N.Field, rf: N.Field):
    from presto_tpu_torch.batch import union_dictionary
    if lf.dictionary is None and rf.dictionary is None:
        return None
    return union_dictionary(lf.dictionary, rf.dictionary)


# ---------------------------------------------------------------------------
# Fragmentation (reference: PlanFragmenter.java:144, createSubPlans:168)


@dataclasses.dataclass
class ExchangeEdge:
    """One consumer's view of a producer fragment's output (the analog
    of an OutputBuffer id on the producer + a RemoteSourceNode on the
    consumer)."""
    exchange_id: int
    producer: int                # fragment id
    consumer: int                # fragment id
    scheme: str
    partition_keys: List[str]
    hash_dicts: Optional[List[Optional[Tuple[str, ...]]]]
    fields: Tuple[N.Field, ...]


@dataclasses.dataclass
class Fragment:
    id: int
    root: N.PlanNode
    partitioning: str            # "single" | "distributed"
    source_edges: List[int]      # exchange ids feeding this fragment
    #: scaled-writer cap on this fragment's task count (None = width)
    max_tasks: Optional[int] = None


@dataclasses.dataclass
class FragmentedPlan:
    root_id: int                 # the OutputNode fragment
    fragments: Dict[int, Fragment]
    edges: Dict[int, ExchangeEdge]

    def producer_edges(self, fragment_id: int) -> List[ExchangeEdge]:
        return [e for e in self.edges.values()
                if e.producer == fragment_id]

    def text(self) -> str:
        lines = []
        for fid in sorted(self.fragments):
            f = self.fragments[fid]
            lines.append(f"Fragment {fid} [{f.partitioning}]")
            lines.append(N.plan_text(f.root, indent=1))
        return "\n".join(lines)


def fragment_plan(root: N.OutputNode) -> FragmentedPlan:
    """Cut the exchanged plan into fragments. A shared producer subtree
    (reached through several ExchangeNodes over the same source) becomes
    ONE fragment with several consumer edges."""
    f = _Fragmenter()
    root_id = f.build(root)
    return FragmentedPlan(root_id, f.fragments, f.edges)


def plan_phases(fplan: FragmentedPlan) -> Dict[int, List[int]]:
    """Phased execution policy (reference: execution/scheduler/
    PhasedExecutionSchedule.java): fragments that produce a join's
    PROBE side wait for the fragments producing its BUILD side to
    finish. Gains: the build table exists before probe pages flood
    its exchange (peak memory), and cross-fragment dynamic filters
    are complete before probe scans run (pruning becomes
    deterministic, not a race).

    Returns {fragment_id: [fragment ids that must FINISH first]}.
    Consumer fragments themselves are never gated — they must run to
    drain their build edges. Dependency edges that would create a
    cycle (e.g. a shared spooled subtree feeding both sides) are
    dropped; the policy is an optimization, all-at-once is always
    correct."""
    deps: Dict[int, set] = {fid: set() for fid in fplan.fragments}

    def remote_edges(node: N.PlanNode) -> List[int]:
        out, stack = [], [node]
        while stack:
            n = stack.pop()
            if isinstance(n, N.RemoteSourceNode):
                out.append(n.exchange_id)
                continue
            stack.extend(n.sources())
        return out

    def upstream(fid: int, acc: set) -> set:
        """fid's producer fragments, transitively."""
        for e in fplan.edges.values():
            if e.consumer == fid and e.producer not in acc:
                acc.add(e.producer)
                upstream(e.producer, acc)
        return acc

    data_succ: Dict[int, set] = {}
    for e in fplan.edges.values():
        data_succ.setdefault(e.producer, set()).add(e.consumer)

    def precedes(a: int, b: int, seen: set) -> bool:
        """True if a must complete before b can (combined graph:
        data edges — a consumer completes only after its producers —
        plus already-added dependency edges). Adding 'b before p' is
        safe only if p does NOT already precede b, else deadlock (the
        Q21 shape: a shared lineitem fragment feeds the join, the
        semi AND the anti side)."""
        if a == b:
            return True
        succ = set(data_succ.get(a, ()))
        succ |= {q for q, ds in deps.items() if a in ds}
        for s in succ:
            if s not in seen:
                seen.add(s)
                if precedes(s, b, seen):
                    return True
        return False

    for fid, frag in fplan.fragments.items():
        stack = [frag.root]
        while stack:
            n = stack.pop()
            stack.extend(n.sources())
            if isinstance(n, N.JoinNode) and n.join_type != "cross":
                build, probe = n.right, n.left
                if n.join_type == "right":
                    build, probe = n.left, n.right
            elif isinstance(n, N.SemiJoinNode):
                build, probe = n.filtering_source, n.source
            else:
                continue
            build_frags: set = set()
            for xid in remote_edges(build):
                b = fplan.edges[xid].producer
                build_frags.add(b)
                upstream(b, build_frags)
            for xid in remote_edges(probe):
                p = fplan.edges[xid].producer
                for b in build_frags:
                    if p == b or precedes(p, b, set()):
                        continue
                    deps[p].add(b)
    return {fid: sorted(d) for fid, d in deps.items()}


@dataclasses.dataclass
class CrossFragmentFilters:
    """Wiring for cross-fragment dynamic filters (the in-process
    analog of the reference's coordinator-side DynamicFilterService
    collection plan): build-side publications keyed by join node
    identity, scan-side applications keyed by scan node identity, and
    the fragment whose tasks publish each filter (so the runner can
    arm the service with the right expected-publisher count)."""
    joins: Dict[int, List[Tuple[str, int]]]
    scans: Dict[int, List[Tuple[str, int]]]
    build_fragment: Dict[int, int]  # df_id -> join's fragment id


def plan_cross_fragment_filters(fplan: FragmentedPlan
                                ) -> CrossFragmentFilters:
    """Find inner/semi joins whose probe key traces through one or
    more exchanges to a scan column in ANOTHER fragment, and allocate
    a df_id for each such (join build key, scan column) pair. The
    trace crosses a RemoteSourceNode only when its producer fragment
    feeds exactly one consumer edge (pruning a shared producer's scan
    would starve its other consumers), and skips DAG-shared nodes
    inside each fragment for the same reason. Co-fragment joins are
    left to the registry fast path (trace that never crosses an
    exchange -> not registered here)."""
    from presto_tpu_torch.expr.ir import InputRef
    from presto_tpu_torch.planner.local_planner import _parent_counts

    consumers_of: Dict[int, int] = {}
    for e in fplan.edges.values():
        consumers_of[e.producer] = consumers_of.get(e.producer, 0) + 1
    frag_of_edge = {xid: e.producer for xid, e in fplan.edges.items()}
    shared_by_frag = {
        fid: frozenset(nid for nid, c
                       in _parent_counts(f.root).items() if c > 1)
        for fid, f in fplan.fragments.items()
    }

    def trace(fid: int, node: N.PlanNode, symbol: str):
        """-> (scan_node, scan_symbol, crossed_exchange) or None."""
        crossed = False
        while True:
            if id(node) in shared_by_frag[fid]:
                return None
            if isinstance(node, N.TableScanNode):
                return (node, symbol, crossed) \
                    if symbol in node.assignments else None
            if isinstance(node, N.FilterNode):
                node = node.source
            elif isinstance(node, N.ProjectNode):
                expr = dict(node.assignments).get(symbol)
                if not isinstance(expr, InputRef):
                    return None
                symbol = expr.name
                node = node.source
            elif isinstance(node, N.RemoteSourceNode):
                pfid = frag_of_edge[node.exchange_id]
                if consumers_of.get(pfid, 0) != 1:
                    return None
                fid = pfid
                node = fplan.fragments[pfid].root
                crossed = True
            else:
                return None

    out = CrossFragmentFilters({}, {}, {})
    seq = 0
    for fid, frag in fplan.fragments.items():
        stack = [frag.root]
        seen = set()
        while stack:
            n = stack.pop()
            if id(n) in seen:
                continue
            seen.add(id(n))
            stack.extend(n.sources())
            if isinstance(n, N.JoinNode) and n.join_type == "inner" \
                    and n.criteria:
                pairs = [(l, r, n.right.field(r)) for l, r in n.criteria]
                probe = n.left
            elif isinstance(n, N.SemiJoinNode) and not n.negate:
                pairs = [(n.source_key, n.filtering_key,
                          n.filtering_source.field(n.filtering_key))]
                probe = n.source
            else:
                continue
            for l, r, bf in pairs:
                if bf.dictionary is not None or bf.type.name == "boolean":
                    # numeric and date keys only, as the port's
                    # co-fragment filters (local_planner.py)
                    continue
                t = trace(fid, probe, l)
                if t is None or not t[2]:
                    continue  # unreachable or co-fragment (registry)
                scan_node, scan_sym, _ = t
                seq += 1
                out.joins.setdefault(id(n), []).append((r, seq))
                out.scans.setdefault(id(scan_node), []).append(
                    (scan_sym, seq))
                out.build_fragment[seq] = fid
    return out


class _Fragmenter:
    def __init__(self):
        self.fragments: Dict[int, Fragment] = {}
        self.edges: Dict[int, ExchangeEdge] = {}
        self._frag_by_source: Dict[int, int] = {}
        self._next_fragment = 0
        self._next_exchange = 0

    def build(self, root: N.PlanNode) -> int:
        fid = self._next_fragment
        self._next_fragment += 1
        info = {"has_scan": False, "gather_in": False,
                "source_edges": [], "passthrough_producers": [],
                "max_tasks": None}
        new_root = self._cut(root, fid, info)
        if info["gather_in"]:
            assert not info["has_scan"], \
                "fragment mixes a gather input with a parallel scan"
            part = "single"
        elif info["has_scan"]:
            part = "distributed"
        elif info["passthrough_producers"]:
            parts = {self.fragments[p].partitioning
                     for p in info["passthrough_producers"]}
            assert len(parts) == 1, \
                "passthrough inputs with mixed partitioning"
            part = parts.pop()
        elif info["source_edges"]:
            part = "distributed"
        else:
            part = "single"  # values / constants only
        self.fragments[fid] = Fragment(fid, new_root, part,
                                       info["source_edges"],
                                       max_tasks=info["max_tasks"])
        return fid

    def _cut(self, node: N.PlanNode, fid: int, info) -> N.PlanNode:
        if isinstance(node, N.ExchangeNode):
            src_key = id(node.source)
            producer = self._frag_by_source.get(src_key)
            if producer is None:
                producer = self.build(node.source)
                self._frag_by_source[src_key] = producer
            xid = self._next_exchange
            self._next_exchange += 1
            edge = ExchangeEdge(
                xid, producer, fid, node.scheme,
                list(node.partition_keys), node.hash_dicts,
                tuple(node.output))
            self.edges[xid] = edge
            info["source_edges"].append(xid)
            if node.consumer_max_tasks is not None:
                m = info["max_tasks"]
                info["max_tasks"] = node.consumer_max_tasks if m is None \
                    else min(m, node.consumer_max_tasks)
            if node.scheme == "gather":
                info["gather_in"] = True
            if node.scheme == "passthrough":
                info["passthrough_producers"].append(producer)
            return N.RemoteSourceNode(producer, xid, node.scheme,
                                      tuple(node.output))
        if isinstance(node, N.TableScanNode):
            info["has_scan"] = True
            return node
        for attr in ("source", "left", "right", "filtering_source"):
            if hasattr(node, attr):
                setattr(node, attr,
                        self._cut(getattr(node, attr), fid, info))
        if isinstance(node, N.UnionNode):
            node.inputs = [self._cut(x, fid, info)
                           for x in node.inputs]
        return node
