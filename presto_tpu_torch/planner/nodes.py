"""Logical plan nodes (reference: presto-spi spi/plan/PlanNode +
presto-main sql/planner/plan/ — TableScanNode, FilterNode, ProjectNode,
AggregationNode, JoinNode, SemiJoinNode, SortNode, TopNNode, LimitNode,
ValuesNode, OutputNode, ExchangeNode).

Every node carries its output schema as a tuple of Fields (symbol name,
type, optional string dictionary). Symbols are globally unique per query
(Presto's Symbol allocation), so joins never collide."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from presto_tpu_torch.connectors.spi import TableHandle
from presto_tpu_torch.expr.ir import RowExpression
from presto_tpu_torch.types import Type


@dataclasses.dataclass(frozen=True)
class Field:
    symbol: str
    type: Type
    dictionary: Optional[Tuple[str, ...]] = None
    #: complex-typed fields (array/map/row) carry their VALUE FORM: an
    #: ir.ArrayValue/MapValue/RowValue whose leaves are InputRefs to
    #: the exploded slot columns actually present in batches (arrays
    #: live as <sym>__a0..<sym>__a{W-1} + <sym>__len scalar columns —
    #: reference: common/type/ArrayType's offsets+child block,
    #: re-shaped static for XLA). The named symbol itself has no
    #: physical column.
    form: Optional[object] = None
    #: per-slot string dictionaries for form fields ({slot symbol ->
    #: dictionary}; map keys and values may differ)
    form_dicts: Optional[Dict[str, Tuple[str, ...]]] = None


def form_leaves(form) -> List[Any]:
    """The leaf expressions of a complex value form, in canonical
    order (elements/keys+values/fields, then the length expression).
    THE one enumeration every consumer shares — slot symbols, schema
    expansion, renames all derive from this order."""
    from presto_tpu_torch.expr.ir import ArrayValue, MapValue
    if isinstance(form, ArrayValue):
        leaves = list(form.elements)
        if form.length is not None:
            leaves.append(form.length)
        return leaves
    if isinstance(form, MapValue):
        leaves = list(form.keys + form.values)
        if form.length is not None:
            leaves.append(form.length)
        return leaves
    return [x for _, x in form.fields]  # RowValue


def form_slot_symbols(form) -> List[str]:
    """InputRef slot symbols referenced by a complex value form (the
    physical columns behind an array/map/row field)."""
    from presto_tpu_torch.expr.ir import InputRef
    return [x.name for x in form_leaves(form)
            if isinstance(x, InputRef)]


class PlanNode:
    output: Tuple[Field, ...]

    def sources(self) -> Tuple["PlanNode", ...]:
        return ()

    @property
    def symbols(self) -> List[str]:
        return [f.symbol for f in self.output]

    def field(self, symbol: str) -> Field:
        for f in self.output:
            if f.symbol == symbol:
                return f
        raise KeyError(symbol)


@dataclasses.dataclass
class TableScanNode(PlanNode):
    handle: TableHandle
    # output symbol -> connector column name
    assignments: Dict[str, str]
    output: Tuple[Field, ...]
    # pushed-down (unenforced) per-column constraint; the planner keeps
    # the originating filter (reference: TableScanNode's enforced/
    # unenforced TupleDomain split)
    constraint: Any = None


@dataclasses.dataclass
class FilterNode(PlanNode):
    source: PlanNode
    predicate: RowExpression
    output: Tuple[Field, ...]

    def sources(self):
        return (self.source,)


@dataclasses.dataclass
class ProjectNode(PlanNode):
    source: PlanNode
    # ordered (symbol -> expression over source symbols)
    assignments: List[Tuple[str, RowExpression]]
    output: Tuple[Field, ...]

    def sources(self):
        return (self.source,)


@dataclasses.dataclass(frozen=True)
class AggCall:
    out_symbol: str
    function: str                      # sum | count | avg | min | max
    argument: Optional[RowExpression]  # None for count(*)
    distinct: bool = False
    output_type: Optional[Type] = None
    # effective input type, set on FINAL-step calls (argument is None
    # there — the operator merges <out>__s{i} state columns instead) so
    # the state layout matches the partial side exactly
    input_type: Optional[Type] = None
    # static call parameters (e.g. approx_percentile's fraction)
    params: Tuple = ()
    # FILTER (WHERE ...) predicate gating contributions; applied at
    # the PARTIAL step only under a distributed split
    filter: Optional[RowExpression] = None
    # map_agg's VALUE expression (argument carries the key)
    argument2: Optional[RowExpression] = None


@dataclasses.dataclass
class AggregationNode(PlanNode):
    source: PlanNode
    # group keys: (out symbol, expression over source)
    keys: List[Tuple[str, RowExpression]]
    aggregates: List[AggCall]
    step: str  # single | partial | final
    output: Tuple[Field, ...]

    def sources(self):
        return (self.source,)


@dataclasses.dataclass
class JoinNode(PlanNode):
    join_type: str  # inner | left | right | full | cross
    left: PlanNode   # probe
    right: PlanNode  # build
    # equi-join criteria: (left symbol, right symbol)
    criteria: List[Tuple[str, str]]
    output: Tuple[Field, ...]
    # residual non-equi condition applied post-join
    filter: Optional[RowExpression] = None

    def sources(self):
        return (self.left, self.right)


@dataclasses.dataclass
class SemiJoinNode(PlanNode):
    source: PlanNode
    filtering_source: PlanNode
    source_key: str
    filtering_key: str
    negate: bool
    output: Tuple[Field, ...]

    def sources(self):
        return (self.source, self.filtering_source)


@dataclasses.dataclass
class SortNode(PlanNode):
    source: PlanNode
    keys: List[str]
    descending: List[bool]
    nulls_first: List[bool]
    output: Tuple[Field, ...]

    def sources(self):
        return (self.source,)


@dataclasses.dataclass
class MergeNode(PlanNode):
    """k-way merge of PRE-SORTED inputs (reference:
    operator/MergeOperator.java:44): the root of a distributed ORDER
    BY merges its tasks' sorted shards instead of re-sorting their
    union. Fields mirror SortNode; the input batches must each be
    sorted by the same keys."""
    source: PlanNode
    keys: List[str]
    descending: List[bool]
    nulls_first: List[bool]
    output: Tuple[Field, ...]

    def sources(self):
        return (self.source,)


@dataclasses.dataclass
class TopNNode(PlanNode):
    source: PlanNode
    n: int
    keys: List[str]
    descending: List[bool]
    nulls_first: List[bool]
    output: Tuple[Field, ...]

    def sources(self):
        return (self.source,)


@dataclasses.dataclass
class LimitNode(PlanNode):
    source: PlanNode
    n: int
    output: Tuple[Field, ...]

    def sources(self):
        return (self.source,)


@dataclasses.dataclass
class DistinctNode(PlanNode):
    source: PlanNode
    output: Tuple[Field, ...]

    def sources(self):
        return (self.source,)


@dataclasses.dataclass
class ValuesNode(PlanNode):
    # rows of typed literal values (python values per Field type)
    rows: List[List[Any]]
    output: Tuple[Field, ...]


@dataclasses.dataclass
class UnionNode(PlanNode):
    inputs: List[PlanNode]
    # per input: mapping output symbol -> that input's symbol
    symbol_maps: List[Dict[str, str]]
    output: Tuple[Field, ...]

    def sources(self):
        return tuple(self.inputs)


@dataclasses.dataclass
class EnforceSingleRowNode(PlanNode):
    source: PlanNode
    output: Tuple[Field, ...]

    def sources(self):
        return (self.source,)


@dataclasses.dataclass
class AssignUniqueIdNode(PlanNode):
    """Appends a unique BIGINT row id column (reference:
    AssignUniqueIdOperator) — used by general subquery decorrelation to
    re-identify probe rows after a join."""
    source: PlanNode
    symbol: str
    output: Tuple[Field, ...]

    def sources(self):
        return (self.source,)


@dataclasses.dataclass
class UnnestNode(PlanNode):
    """UNNEST over ARRAY[...] constructors (reference:
    operator/unnest/UnnestOperator.java + plan/UnnestNode). Arrays are
    syntactically fixed-length, so unnesting is static replication:
    replica i of each input row selects every array's i-th element
    column (pre-projected below this node); shorter arrays pad NULL
    (zip semantics), plus an optional 1-based ordinality column."""
    source: PlanNode
    # per unnested array: (output symbol, element symbol per slot,
    # optional dynamic-length symbol — None means the static width)
    items: List[Tuple[str, List[str], Optional[str]]]
    ordinality_symbol: Optional[str]
    output: Tuple[Field, ...]

    def sources(self):
        return (self.source,)


@dataclasses.dataclass
class GroupIdNode(PlanNode):
    """Replicates its input once per grouping set, NULLing the key
    columns excluded from each set and appending a literal group-id
    column (reference: operator/GroupIdOperator.java + the planner's
    GroupIdNode for GROUPING SETS/ROLLUP/CUBE). `grouping_outputs` are
    grouping(...)-call columns: a per-set constant bitmask."""
    source: PlanNode
    groupings: List[Tuple[str, ...]]   # key symbols PRESENT per set
    all_keys: Tuple[str, ...]          # union of keys, stable order
    gid_symbol: str
    grouping_outputs: List[Tuple[str, Tuple[int, ...]]]
    output: Tuple[Field, ...]

    def sources(self):
        return (self.source,)


@dataclasses.dataclass(frozen=True)
class WindowCall:
    """One window function call (reference: WindowNode.Function)."""
    out_symbol: str
    function: str                  # rank|dense_rank|row_number|lag|...
    argument: Optional[str]        # source symbol (pre-projected)
    frame: str                     # ops.window mode ("rows"/"range"/legacy)
    output_type: Optional[Type] = None
    offset: int = 1                # lag/lead distance; ntile/nth_value N
    frame_start: object = "u"      # "u" | "c" | signed offset
    frame_end: object = "c"
    filter: Optional[str] = None   # FILTER (WHERE ...) bool symbol
    default: object = None         # lag/lead constant default


@dataclasses.dataclass
class TopNRowNumberNode(PlanNode):
    """Filter(rank-family window <= N) fused (reference:
    TopNRowNumberOperator + the PushdownFilterIntoWindow family of
    rules). The win is distributed: a PARTIAL copy runs on every worker
    before the exchange — a row's global rank is >= its local rank, so
    pre-filtering local rank <= N is a safe row reduction — and the
    FINAL copy recomputes exact ranks on co-located partitions."""
    source: PlanNode
    partition_by: List[str]
    order_by: List[str]
    descending: List[bool]
    nulls_first: List[bool]
    function: str            # row_number | rank | dense_rank
    row_number_symbol: str
    max_rank: int
    output: Tuple[Field, ...]

    def sources(self):
        return (self.source,)


@dataclasses.dataclass
class WindowNode(PlanNode):
    """OVER(...) evaluation appending one column per call (reference:
    sql/planner/plan/WindowNode + WindowOperator.java:62). Partition and
    order keys are bare symbols — the analyzer pre-projects
    expressions."""
    source: PlanNode
    partition_by: List[str]
    order_by: List[str]
    descending: List[bool]
    nulls_first: List[bool]
    calls: List[WindowCall]
    output: Tuple[Field, ...]      # source fields + one per call

    def sources(self):
        return (self.source,)


@dataclasses.dataclass
class OutputNode(PlanNode):
    source: PlanNode
    # user-visible column names, in order, referencing source symbols
    names: List[str]
    source_symbols: List[str]
    output: Tuple[Field, ...]

    def sources(self):
        return (self.source,)


@dataclasses.dataclass
class ExchangeNode(PlanNode):
    """Marks a data redistribution point (reference:
    sql/planner/plan/ExchangeNode; SystemPartitioningHandle.java:59-67).

    scheme:
      - "repartition": hash rows by `partition_keys` across workers
        (FIXED_HASH_DISTRIBUTION); empty keys = batch round-robin
        (FIXED_ARBITRARY_DISTRIBUTION)
      - "gather": all rows to the single consumer task (SINGLE)
      - "broadcast": replicate to all consumer tasks (FIXED_BROADCAST)
      - "passthrough": task i -> task i, no movement (used to cut a
        shared DAG subtree into its own fragment)

    `hash_dicts` (repartition only): per partition key, an optional
    unified string dictionary used ONLY for hashing — both sides of a
    partitioned join must hash equal strings to equal workers even
    though their columns carry different per-side dictionaries. The
    emitted columns keep their original codes."""
    source: PlanNode
    scheme: str
    partition_keys: List[str]
    output: Tuple[Field, ...]
    hash_dicts: Optional[List[Optional[Tuple[str, ...]]]] = None
    #: cap on the CONSUMER fragment's task count (the scaled-writer
    #: exchange: writer fragments size by data volume, not mesh width)
    consumer_max_tasks: Optional[int] = None

    def sources(self):
        return (self.source,)


@dataclasses.dataclass
class TableWriterNode(PlanNode):
    """Writes its input to a connector sink, one writer per task
    (reference: operator/TableWriterOperator.java + the scaled-writer
    exchange in front of it); emits one row carrying this writer's
    written-row count."""
    source: PlanNode
    handle: Any                       # connectors.spi.TableHandle
    #: target column name -> source symbol (None = fill NULLs)
    column_sources: Any
    #: target schema columns [(name, type, dictionary)]
    schema_cols: Any
    output: Tuple[Field, ...]

    def sources(self):
        return (self.source,)


@dataclasses.dataclass
class TableFinishNode(PlanNode):
    """Commits the write after all writers finished and sums their
    row counts (reference: operator/TableFinishOperator.java — the
    single commit point of a distributed write)."""
    source: PlanNode
    handle: Any
    output: Tuple[Field, ...]

    def sources(self):
        return (self.source,)


@dataclasses.dataclass
class RemoteSourceNode(PlanNode):
    """Stands in for a cut child fragment inside a fragment's plan
    (reference: sql/planner/plan/RemoteSourceNode — the consumer end of
    an exchange after PlanFragmenter.java:144 splits the plan)."""
    fragment_id: int
    exchange_id: int
    scheme: str
    output: Tuple[Field, ...]


def plan_text(node: PlanNode, indent: int = 0, annotate=None) -> str:
    """EXPLAIN-style tree rendering (reference: planPrinter/).

    `annotate`, when given, maps a PlanNode to extra per-node lines
    (EXPLAIN ANALYZE joins operator stats back onto the tree through
    it — rows/wall/compile/cache under each node)."""
    pad = "  " * indent
    name = type(node).__name__.replace("Node", "")
    details = ""
    if isinstance(node, TableScanNode):
        details = f"[{node.handle}]"
    elif isinstance(node, FilterNode):
        details = f"[{node.predicate}]"
    elif isinstance(node, AggregationNode):
        details = f"[keys={[k for k, _ in node.keys]} " \
                  f"aggs={[a.function for a in node.aggregates]} " \
                  f"step={node.step}]"
    elif isinstance(node, JoinNode):
        details = f"[{node.join_type} on {node.criteria}]"
    elif isinstance(node, (SortNode, TopNNode, MergeNode)):
        details = f"[{node.keys}]"
    elif isinstance(node, LimitNode):
        details = f"[{node.n}]"
    elif isinstance(node, ExchangeNode):
        details = f"[{node.scheme} keys={node.partition_keys}]"
    elif isinstance(node, RemoteSourceNode):
        details = f"[fragment={node.fragment_id} {node.scheme}]"
    elif isinstance(node, WindowNode):
        details = f"[partition={node.partition_by} " \
                  f"order={node.order_by} " \
                  f"calls={[c.function for c in node.calls]}]"
    elif isinstance(node, OutputNode):
        details = f"[{node.names}]"
    lines = [f"{pad}{name}{details} => {[f.symbol for f in node.output]}"]
    if annotate is not None:
        for extra in annotate(node):
            lines.append(f"{pad}  | {extra}")
    for s in node.sources():
        lines.append(plan_text(s, indent + 1, annotate))
    return "\n".join(lines)
