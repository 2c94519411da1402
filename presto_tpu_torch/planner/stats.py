"""Plan statistics + cost estimation (reference: presto-main cost/ —
StatsCalculator rules like FilterStatsCalculator/JoinStatsRule feeding
CostCalculatorUsingExchanges; collapsed here into one recursive
estimator over the typed PlanNode tree).

Estimates drive two load-bearing decisions:
  - join distribution (broadcast vs repartitioned) in AddExchanges
  - join order (greedy smallest-intermediate) in the optimizer

Column-level stats (NDV, null fraction, min/max) come from the
connector when it knows them (ConnectorMetadata.column_stats) and are
derived from dictionaries otherwise; selectivities follow the
reference's standard formulas (1/NDV equality, range interpolation,
0.9 cap on conjunction shrink, independence across conjuncts)."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from presto_tpu_torch.expr.ir import Call, InputRef, Literal, SpecialForm
from presto_tpu_torch.planner import nodes as N

UNKNOWN_ROWS = 1e9
_DEFAULT_SELECTIVITY = 0.33
_COMPARISONS = {"less_than", "less_than_or_equal", "greater_than",
                "greater_than_or_equal"}


@dataclasses.dataclass(frozen=True)
class ColStats:
    ndv: Optional[float] = None
    null_frac: Optional[float] = None  # None = unknown (0.0 = known 0)
    low: Optional[float] = None   # numeric/physical (dates = days)
    high: Optional[float] = None


@dataclasses.dataclass
class PlanStats:
    rows: float
    columns: Dict[str, ColStats] = dataclasses.field(
        default_factory=dict)

    def col(self, sym: str) -> ColStats:
        return self.columns.get(sym, ColStats())


class StatsEstimator:
    """`history` is an optional presto_tpu_torch.history.HistoryView: when a
    node's structural fingerprint has a measured prior execution, the
    MEASURED cardinality replaces the derived one (reference:
    history-based optimization), and `provenance[id(node)]` records
    "history" so EXPLAIN and the fusion gate can tell truth from
    heuristic. Column-level stats stay derived — history measures row
    counts, not per-column NDV."""

    def __init__(self, catalogs, history=None):
        self.catalogs = catalogs
        self.history = history
        #: id(node) -> "history" for every overridden estimate
        self.provenance: Dict[int, str] = {}
        # memo holds (node, stats): keeping the node referenced pins
        # its id() for the estimator's lifetime, so a GC'd throwaway
        # node (join-order probes) can never alias a later allocation
        self._memo: Dict[int, Tuple[N.PlanNode, PlanStats]] = {}

    def estimate(self, node: N.PlanNode) -> PlanStats:
        hit = self._memo.get(id(node))
        if hit is not None:
            return hit[1]
        m = getattr(self, f"_est_{type(node).__name__}", None)
        st = m(node) if m is not None else self._default(node)
        if self.history is not None:
            try:
                e = self.history.lookup(node)
            except Exception:  # noqa: BLE001 — stats are advisory
                e = None
            if e is not None:
                st = PlanStats(max(1.0, float(e["rows"])), st.columns)
                self.provenance[id(node)] = "history"
        self._memo[id(node)] = (node, st)
        return st

    def provenance_of(self, node: N.PlanNode) -> str:
        """"history" when this node's estimate came from a measured
        prior execution, else "static". Only meaningful after
        estimate(node)."""
        return self.provenance.get(id(node), "static")

    def rows(self, node: N.PlanNode) -> float:
        return self.estimate(node).rows

    # -- per-node rules ----------------------------------------------------

    def _default(self, node: N.PlanNode) -> PlanStats:
        srcs = node.sources()
        if not srcs:
            return PlanStats(UNKNOWN_ROWS)
        inner = self.estimate(srcs[0])
        return PlanStats(inner.rows, dict(inner.columns))

    def _est_TableScanNode(self, node: N.TableScanNode) -> PlanStats:
        try:
            conn = self.catalogs.connector(node.handle.catalog)
            n = conn.metadata.estimate_row_count(node.handle)
        except Exception:  # noqa: BLE001 — stats are advisory
            return PlanStats(UNKNOWN_ROWS)
        if n is None:
            return PlanStats(UNKNOWN_ROWS)
        try:
            raw = conn.metadata.column_stats(node.handle)
        except Exception:  # noqa: BLE001 — keep the row count
            raw = {}
        cols: Dict[str, ColStats] = {}
        try:
            schema = conn.metadata.get_table_schema(node.handle)
        except Exception:  # noqa: BLE001
            schema = None
        for sym, source_col in node.assignments.items():
            cs = raw.get(source_col)
            if cs is None and schema is not None \
                    and source_col in schema:
                dic = schema.column(source_col).dictionary
                if dic is not None:
                    cs = ColStats(ndv=len(dic))
            cols[sym] = cs or ColStats()
        return PlanStats(float(n), cols)

    def _est_ValuesNode(self, node: N.ValuesNode) -> PlanStats:
        return PlanStats(float(len(node.rows)))

    def _est_FilterNode(self, node: N.FilterNode) -> PlanStats:
        inner = self.estimate(node.source)
        sel, cols = _selectivity(node.predicate, inner)
        return PlanStats(max(1.0, inner.rows * sel), cols)

    def _est_ProjectNode(self, node: N.ProjectNode) -> PlanStats:
        inner = self.estimate(node.source)
        cols = {}
        for sym, e in node.assignments:
            if isinstance(e, InputRef):
                cols[sym] = inner.col(e.name)
        return PlanStats(inner.rows, cols)

    def _est_AggregationNode(self, node: N.AggregationNode) -> PlanStats:
        inner = self.estimate(node.source)
        if not node.keys:
            return PlanStats(1.0)
        groups = 1.0
        cols = {}
        for sym, e in node.keys:
            nd = None
            if isinstance(e, InputRef):
                nd = inner.col(e.name).ndv
                cols[sym] = inner.col(e.name)
            groups *= nd if nd is not None else \
                max(1.0, 0.1 * inner.rows) ** (1.0 / len(node.keys))
        return PlanStats(max(1.0, min(groups, inner.rows)), cols)

    def _est_DistinctNode(self, node: N.DistinctNode) -> PlanStats:
        inner = self.estimate(node.source)
        nd = 1.0
        known = True
        for f in node.output:
            c = inner.col(f.symbol).ndv
            if c is None:
                known = False
                break
            nd *= c
        rows = min(nd, inner.rows) if known \
            else max(1.0, 0.3 * inner.rows)
        return PlanStats(max(1.0, rows), dict(inner.columns))

    def _est_JoinNode(self, node: N.JoinNode) -> PlanStats:
        ls = self.estimate(node.left)
        rs = self.estimate(node.right)
        cols = {**ls.columns, **rs.columns}
        if node.join_type == "cross" or not node.criteria:
            return PlanStats(ls.rows * rs.rows, cols)
        rows = ls.rows * rs.rows
        for l, r in node.criteria:
            nd = max(ls.col(l).ndv or 0, rs.col(r).ndv or 0)
            if nd <= 0:
                nd = max(1.0, min(ls.rows, rs.rows))
            rows /= nd
        if node.join_type in ("left", "full"):
            rows = max(rows, ls.rows)
        if node.join_type in ("right", "full"):
            rows = max(rows, rs.rows)
        return PlanStats(max(1.0, rows), cols)

    def _est_SemiJoinNode(self, node: N.SemiJoinNode) -> PlanStats:
        src = self.estimate(node.source)
        filt = self.estimate(node.filtering_source)
        s_ndv = src.col(node.source_key).ndv
        f_ndv = filt.col(node.filtering_key).ndv
        if s_ndv and f_ndv:
            sel = min(1.0, f_ndv / s_ndv)
        else:
            sel = 0.5
        if node.negate:  # anti join keeps the complement
            sel = 1.0 - sel
        return PlanStats(max(1.0, src.rows * sel), dict(src.columns))

    def _est_GroupIdNode(self, node: N.GroupIdNode) -> PlanStats:
        inner = self.estimate(node.source)
        return PlanStats(len(node.groupings) * inner.rows,
                         dict(inner.columns))

    def _est_TopNRowNumberNode(self, node) -> PlanStats:
        inner = self.estimate(node.source)
        parts = 1.0
        for p in node.partition_by:
            nd = inner.col(p).ndv
            parts *= nd if nd else 100.0
        rows = min(inner.rows, node.max_rank * parts)
        return PlanStats(max(1.0, rows), dict(inner.columns))

    def _est_UnnestNode(self, node: N.UnnestNode) -> PlanStats:
        inner = self.estimate(node.source)
        depth = max(len(s) for _, s, _ in node.items)
        return PlanStats(depth * inner.rows, dict(inner.columns))

    def _est_UnionNode(self, node: N.UnionNode) -> PlanStats:
        return PlanStats(sum(self.rows(x) for x in node.inputs))

    def _est_LimitNode(self, node: N.LimitNode) -> PlanStats:
        inner = self.estimate(node.source)
        return PlanStats(min(float(node.n), inner.rows),
                         dict(inner.columns))

    def _est_TopNNode(self, node: N.TopNNode) -> PlanStats:
        inner = self.estimate(node.source)
        return PlanStats(min(float(node.n), inner.rows),
                         dict(inner.columns))

    def _est_EnforceSingleRowNode(self, node) -> PlanStats:
        return PlanStats(1.0)

    def _est_RemoteSourceNode(self, node) -> PlanStats:
        return PlanStats(UNKNOWN_ROWS)


def _literal_value(e) -> Optional[float]:
    if isinstance(e, Literal) and e.value is not None \
            and not isinstance(e.value, str):
        try:
            return float(e.value)
        except (TypeError, ValueError):
            return None
    return None


def _selectivity(pred, inner: PlanStats
                 ) -> Tuple[float, Dict[str, ColStats]]:
    """(selectivity, updated column stats) of a predicate over rows
    with `inner` stats. Follows the reference's FilterStatsCalculator
    shapes: 1/NDV equality, range interpolation against [low, high],
    independence across AND conjuncts, capped unions for OR."""
    cols = dict(inner.columns)

    def sel(e, conjunctive: bool = True) -> float:
        """`conjunctive` is True only along a pure top-level AND path —
        the only context where an equality may narrow the column's
        post-filter NDV (an equality under OR/NOT doesn't pin the
        surviving values)."""
        if isinstance(e, SpecialForm):
            if e.form == "and":
                s = 1.0
                for a in e.args:
                    s *= sel(a, conjunctive)
                return s
            if e.form == "or":
                s = 0.0
                for a in e.args:
                    sa = sel(a, False)
                    s = s + sa - s * sa
                return min(1.0, s)
            if e.form == "not":
                return max(0.0, 1.0 - sel(e.args[0], False))
            if e.form == "in":
                v = e.args[0]
                if isinstance(v, InputRef):
                    nd = inner.col(v.name).ndv
                    k = len(e.args) - 1
                    if nd:
                        return min(1.0, k / nd)
                return _DEFAULT_SELECTIVITY
            if e.form == "is_null":
                v = e.args[0]
                if isinstance(v, InputRef):
                    nf = inner.col(v.name).null_frac
                    # a KNOWN 0.0 means the column provably has no
                    # NULLs — don't mistake it for unknown
                    return nf if nf is not None else 0.05
                return 0.05
            return _DEFAULT_SELECTIVITY
        if isinstance(e, Call):
            if e.name == "equal" and len(e.args) == 2:
                a, b = e.args
                if isinstance(b, InputRef) and not isinstance(a,
                                                             InputRef):
                    a, b = b, a
                if isinstance(a, InputRef) and isinstance(b, Literal):
                    nd = inner.col(a.name).ndv
                    if nd:
                        if conjunctive:
                            cols[a.name] = dataclasses.replace(
                                cols.get(a.name, ColStats()), ndv=1.0)
                        return 1.0 / nd
                if isinstance(a, InputRef) and isinstance(b, InputRef):
                    nd = max(inner.col(a.name).ndv or 0,
                             inner.col(b.name).ndv or 0)
                    if nd:
                        return 1.0 / nd
                return _DEFAULT_SELECTIVITY
            if e.name == "not_equal":
                return 0.9
            if e.name in _COMPARISONS and len(e.args) == 2:
                a, b = e.args
                flip = False
                if isinstance(b, InputRef) and not isinstance(a,
                                                              InputRef):
                    a, b = b, a
                    flip = True
                lit = _literal_value(b)
                if isinstance(a, InputRef) and lit is not None:
                    cs = inner.col(a.name)
                    if cs.low is not None and cs.high is not None \
                            and cs.high > cs.low:
                        frac = (lit - cs.low) / (cs.high - cs.low)
                        frac = min(1.0, max(0.0, frac))
                        less = e.name.startswith("less")
                        if flip:
                            less = not less
                        return frac if less else 1.0 - frac
                return _DEFAULT_SELECTIVITY
            if e.name in ("like",):
                return 0.25
        return _DEFAULT_SELECTIVITY

    s = sel(pred)
    return max(min(s, 1.0), 1e-9), cols


def predicate_selectivity(pred, inner: PlanStats) -> float:
    """Public face of _selectivity for callers holding a bare
    predicate over an already-estimated input (the planner's
    join-filter FilterProjects, whose predicate never lives in a
    FilterNode): the estimated surviving-row fraction, same
    reference FilterStatsCalculator heuristics — including the 0.33
    per-conjunct default when column stats are absent."""
    return _selectivity(pred, inner)[0]
