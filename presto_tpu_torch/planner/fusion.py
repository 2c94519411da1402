"""Whole-fragment fusion pass (reference: presto_tpu/planner/fusion.py;
the planner half of the fragment compiler, operators/fused_fragment.py
is the kernel half).

Runs over the freshly planned operator-factory pipelines and collapses
every maximal run of adjacent FilterProject factories into the operator
that consumes it:

    scan -> fp -> fp -> aggregation   =>  scan -> fused[fp*2+aggregation]
    scan -> fp -> topn|limit|distinct =>  scan -> fused[fp+<terminal>]
    scan -> fp -> lookup_join(probe)  =>  scan -> fused[fp+lookup_join]
    ... -> fp -> fp -> <barrier>      =>  ... -> fused[fp*2] -> <barrier>

A fused chain runs as one generated kernel (K12, expr/codegen.py) per
batch, ahead of its terminal's own kernels.

The pass is a PIPELINE rewrite, not a plan-tree rewrite: it runs after
every visitor (so spools, local queues and the output sink are already
in place and act as barriers), and falling back is simply not
rewriting — the unfused operator chain is the fallback path.

Every declined candidate records a reason, reported per query
(`result.fusion_report`) and process-wide in
`telemetry.kernels.FUSED_FRAGMENTS`. The port adds one reason the
reference lacks, `not_lowered:<fn>`: a chain holding a function with no
lowering (expr/lowering.py) is declined and stays as unfused
FilterProjects, which run composed on the CPU and raise on the card
(K12 has no kernel for them, and there is no fallback). The decision
reads only the IR, so the plans are the same on the CPU and on the
card. The reference's thread-local fusion gate is not ported: the port
plans on the thread that runs the statement, so the planner reads the
session's `fragment_fusion_enabled` itself.

The history-driven upgrade (the reference's `history_fusion`, which
folds a measured selective chain with an in-kernel compaction) waits
for a history store (ROADMAP A11). On the distributed path a second
pass (`fuse_exchange_sinks`) absorbs a producer's tail chain into its
exchange's wave.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from presto_tpu_torch.operators import fused_fragment as ff
from presto_tpu_torch.operators.aggregation import (
    AggregationOperatorFactory, StreamingAggregationOperatorFactory,
)
from presto_tpu_torch.operators.core import (
    FilterProjectOperatorFactory, LimitOperatorFactory,
)
from presto_tpu_torch.operators.join_ops import LookupJoinOperatorFactory
from presto_tpu_torch.operators.sort_ops import (
    DistinctOperatorFactory, TopNOperatorFactory,
)
from presto_tpu_torch.telemetry import kernels as _tk

#: fallback reasons (stable strings, as in the reference)
R_UNCACHEABLE = "uncacheable_expr"
R_NO_TERMINAL = "single_stage_no_terminal"
R_FULL_JOIN = "full_join_probe"
R_SPILLABLE = "spillable_build"
R_ALREADY_PRE = "probe_already_prefused"
R_SELECTIVE = "selective_chain"
#: the port's own: a function of the chain has no lowering
R_NOT_LOWERED = "not_lowered"

#: fold-terminal gate: a chain estimated to keep under a quarter of its
#: rows does not fold into its terminal — compacting first drops the
#: fold's working width at least one power-of-four bucket, which beats
#: saving the compact round. The estimate is planner/stats.py's (its
#: default per-conjunct selectivities when column stats are absent);
#: only a filter with no estimate at all leaves fusion on.
SELECTIVE_CHAIN_THRESHOLD = 0.25


def _constituent_label(names: Sequence[str]) -> str:
    """fused[filter_project*2+aggregation(single)] — consecutive
    duplicates compress."""
    parts: List[str] = []
    for n in names:
        if parts and parts[-1].split("*")[0] == n:
            base, _, cnt = parts[-1].partition("*")
            parts[-1] = f"{base}*{int(cnt or 1) + 1}"
        else:
            parts.append(n)
    return "fused[" + "+".join(parts) + "]"


@dataclasses.dataclass
class _Candidate:
    pipeline: int
    start: int              # index of the first FP of the run
    stages: list            # ChainStage per FP
    names: List[str]        # FP factory names
    ids: List[int]          # FP operator ids
    #: estimated surviving-row fraction: product over stages carrying an
    #: estimate; a stage with none contributes 1.0
    sel: float = 1.0
    #: the factory feeding this chain is a probe whose fused tail filter
    #: carries an estimate: its dead rows ride into the chain
    #: uncompacted, so the gate treats the chain as selective
    pre_selective: bool = False
    #: provenance of every selectivity in `sel`
    sel_provs: List[str] = dataclasses.field(default_factory=list)

    @property
    def measured(self) -> bool:
        return bool(self.sel_provs) \
            and all(p == "history" for p in self.sel_provs)


def fuse_pipelines(pipelines: List[List], node_ops=None,
                   spill_enabled: bool = False) -> Dict:
    """Mutates `pipelines` (and the planner's node -> operator-id map)
    in place; returns the fusion report.

    `spill_enabled` mirrors the planner's build-side spill decision (a
    spilled build's partitioner reads probe keys on the host, so no
    chain may disappear into the probe then); the port's builds stay
    resident until ROADMAP A10, so the planner passes False. The
    reference's `history_fusion` (folding a measured selective chain
    with an in-kernel compaction) comes with the history slice (A11)."""
    entries: List[Dict] = []
    id_remap: Dict[int, int] = {}

    def record(cand: _Candidate, terminal: Optional[str],
               fused_name: Optional[str], reason: Optional[str]) -> None:
        entries.append({
            "pipeline": cand.pipeline,
            "source": pipelines[cand.pipeline][0].name
            if pipelines[cand.pipeline] else "?",
            "chain": list(cand.names),
            "terminal": terminal,
            "fused": fused_name,
            "reason": reason,
            "selectivity": round(cand.sel, 6),
            "sel_provenance": "history" if cand.measured else "static",
        })
        if fused_name is not None:
            # a fused entry MAY carry a reason: the chain collapsed but
            # its fold terminal was kept out (selective_chain)
            _tk.FUSED_FRAGMENTS["partial" if reason else "fused",
                                reason or ""] += 1
        else:
            _tk.FUSED_FRAGMENTS["fallback", reason or ""] += 1

    for pi, pipe in enumerate(pipelines):
        i = 0
        while i < len(pipe):
            f = pipe[i]
            stages = ff.stages_from_factory(f) \
                if isinstance(f, FilterProjectOperatorFactory) else None
            if stages is None:
                i += 1
                continue
            cand = _Candidate(pi, i, list(stages), [f.name],
                              [f.operator_id])
            if getattr(f, "selectivity", None) is not None:
                cand.sel *= f.selectivity
                cand.sel_provs.append(getattr(f, "sel_provenance",
                                              "static"))
            prev = pipe[i - 1] if i > 0 else None
            if isinstance(prev, LookupJoinOperatorFactory):
                pre_sel = getattr(prev, "fused_selectivity", None)
                if pre_sel is not None:
                    cand.sel *= pre_sel
                    cand.pre_selective = True
                    cand.sel_provs.append(getattr(
                        prev, "fused_sel_provenance", "static"))
            j = i + 1
            while j < len(pipe):
                nxt = pipe[j]
                more = ff.stages_from_factory(nxt) \
                    if isinstance(nxt, FilterProjectOperatorFactory) \
                    else None
                if more is None:
                    break
                cand.stages.extend(more)
                cand.names.append(nxt.name)
                cand.ids.append(nxt.operator_id)
                if getattr(nxt, "selectivity", None) is not None:
                    cand.sel *= nxt.selectivity
                    cand.sel_provs.append(getattr(nxt, "sel_provenance",
                                                  "static"))
                j += 1
            terminal = pipe[j] if j < len(pipe) else None
            i = _apply(pipe, cand, terminal, j, record, id_remap,
                       spill_enabled)

    if node_ops is not None and id_remap:
        for nid, ids in node_ops.items():
            seen = set()
            out = []
            for op_id in ids:
                mapped = id_remap.get(op_id, op_id)
                if mapped not in seen:
                    seen.add(mapped)
                    out.append(mapped)
            node_ops[nid] = out

    fallback: Dict[str, int] = {}
    for e in entries:
        if e["fused"] is None:
            r = e["reason"] or "?"
            fallback[r] = fallback.get(r, 0) + 1
    return {
        "fragments": entries,
        "fused": sum(1 for e in entries if e["fused"] is not None),
        "fallback": fallback,
        # absorbed operator id -> surviving fused operator id (the
        # evidence validation.check_fusion reads)
        "id_remap": dict(id_remap),
    }


def _collapse_chain(pipe: List, cand: _Candidate, end: int,
                    chain_key, id_remap: Dict[int, int]) -> str:
    """Collapse a multi-stage run into one FusedChainOperatorFactory
    (the deferred-compact protocol runs once, at the chain's tail).
    Returns the fused label."""
    name = _constituent_label(cand.names)
    fused = ff.FusedChainOperatorFactory(cand.ids[0], name, cand.stages,
                                         chain_key)
    for rid in cand.ids[1:]:
        id_remap[rid] = cand.ids[0]
    pipe[cand.start:end] = [fused]
    return name


_FOLD_TERMINALS = (AggregationOperatorFactory,
                   StreamingAggregationOperatorFactory,
                   LookupJoinOperatorFactory, TopNOperatorFactory,
                   DistinctOperatorFactory, LimitOperatorFactory)


def _apply(pipe: List, cand: _Candidate, terminal, end: int, record,
           id_remap: Dict[int, int], spill_enabled: bool) -> int:
    """Fuse one candidate run (or record why not). Returns the pipeline
    index to resume scanning at."""
    tname = getattr(terminal, "name", None)
    missing = ff.chain_not_lowered(cand.stages)
    if missing is not None:
        record(cand, tname, None, f"{R_NOT_LOWERED}:{missing}")
        return end
    chain_key = ff.chain_fingerprint(cand.stages)
    if chain_key is None:
        record(cand, tname, None, R_UNCACHEABLE)
        return end

    # -- selectivity gate: a chain estimated to keep < 1/4 of its rows
    # does NOT fold into its terminal; the chain itself still
    # collapses (compaction runs once, at its tail) --------------------
    if isinstance(terminal, _FOLD_TERMINALS) \
            and (ff.chain_selective(cand.stages) or cand.pre_selective) \
            and cand.sel < SELECTIVE_CHAIN_THRESHOLD:
        if len(cand.names) >= 2:
            name = _collapse_chain(pipe, cand, end, chain_key, id_remap)
            record(cand, tname, name, R_SELECTIVE)
            return cand.start + 1
        record(cand, tname, None, R_SELECTIVE)
        return end

    # -- fold terminals: the chain runs inside the terminal's step -----
    if isinstance(terminal, (AggregationOperatorFactory,
                             StreamingAggregationOperatorFactory)):
        name = _constituent_label(cand.names + [terminal.name])
        terminal.fuse_pre(cand.stages, chain_key, name)
        for rid in cand.ids:
            id_remap[rid] = terminal.operator_id
        del pipe[cand.start:end]
        record(cand, tname, name, None)
        return cand.start + 1

    if isinstance(terminal, LookupJoinOperatorFactory):
        if terminal.join_type == "full":
            reason = R_FULL_JOIN
        elif spill_enabled:
            reason = R_SPILLABLE
        elif terminal.pre_fused:
            reason = R_ALREADY_PRE
        else:
            name = _constituent_label(cand.names + [terminal.name])
            terminal.fuse_pre(cand.stages, chain_key, name)
            for rid in cand.ids:
                id_remap[rid] = terminal.operator_id
            del pipe[cand.start:end]
            record(cand, tname, name, None)
            return cand.start + 1
        record(cand, tname, None, reason)
        return end

    if isinstance(terminal, TopNOperatorFactory):
        n, keys, desc, nf, schema_cols = terminal.args
        name = _constituent_label(cand.names + [terminal.name])
        fused = ff.FusedTopNOperatorFactory(
            terminal.operator_id, name, cand.stages, chain_key, n, keys,
            desc, nf, schema_cols)
        for rid in cand.ids:
            id_remap[rid] = terminal.operator_id
        pipe[cand.start:end + 1] = [fused]
        record(cand, tname, name, None)
        return cand.start + 1

    if isinstance(terminal, DistinctOperatorFactory):
        name = _constituent_label(cand.names + [terminal.name])
        fused = ff.FusedDistinctOperatorFactory(
            terminal.operator_id, name, cand.stages, chain_key,
            terminal.schema_cols, terminal.capacity)
        for rid in cand.ids:
            id_remap[rid] = terminal.operator_id
        pipe[cand.start:end + 1] = [fused]
        record(cand, tname, name, None)
        return cand.start + 1

    if isinstance(terminal, LimitOperatorFactory):
        name = _constituent_label(cand.names + [terminal.name])
        fused = ff.FusedLimitOperatorFactory(
            terminal.operator_id, name, cand.stages, chain_key,
            terminal.n)
        for rid in cand.ids:
            id_remap[rid] = terminal.operator_id
        pipe[cand.start:end + 1] = [fused]
        record(cand, tname, name, None)
        return cand.start + 1

    # -- no fold terminal: collapse multi-stage runs into one chain
    # kernel; a lone FilterProject is already a single kernel ----------
    if len(cand.names) >= 2:
        name = _collapse_chain(pipe, cand, end, chain_key, id_remap)
        record(cand, tname, name, None)
        return cand.start + 1

    record(cand, tname, None,
           R_NO_TERMINAL if terminal is None else f"barrier:{tname}")
    return end


def fuse_exchange_sinks(pipelines: List[List], report: Dict,
                        node_ops=None) -> int:
    """Second fusion pass, after fuse_pipelines (reference:
    presto_tpu/planner/fusion.py:424): absorb a producer pipeline's tail
    chain into its collective exchange, so every wave runs the chain on
    each producer batch (K12) and shuffles its output (K18) without the
    chain's own operator and deferred compaction in between; dead rows
    never cross the exchange.

    Eligible tails look like `[..., <chain>, exchange_sink]` where the
    sink feeds exactly one chain-eligible MeshExchange (a collective
    hash repartition) and the chain is the FusedChainOperatorFactory the
    first pass left behind `barrier:exchange_sink`, or a lone
    FilterProject. A chain with no lowering stays where it is, as in
    the first pass. Mutates pipelines, report and node_ops in place;
    returns the number of chains absorbed."""
    from presto_tpu_torch.operators.exchange_ops import (
        ExchangeSinkOperatorFactory,
    )
    id_remap = report.setdefault("id_remap", {})
    absorbed = 0
    for pi, pipe in enumerate(pipelines):
        if len(pipe) < 2:
            continue
        sink = pipe[-1]
        if not isinstance(sink, ExchangeSinkOperatorFactory) \
                or len(sink.exchanges) != 1 \
                or not sink.exchanges[0].chain_eligible():
            continue
        f = pipe[-2]
        if isinstance(f, ff.FusedChainOperatorFactory):
            stages, chain_key = f.stages, f.chain_key
        elif isinstance(f, FilterProjectOperatorFactory):
            stages = ff.stages_from_factory(f)
            chain_key = ff.chain_fingerprint(stages) \
                if stages is not None else None
        else:
            continue
        if stages is None or chain_key is None \
                or ff.chain_not_lowered(stages) is not None:
            continue
        inner = f.name[len("fused["):-1] \
            if f.name.startswith("fused[") else f.name
        label = f"fused[{inner}+all_to_all]"
        if not sink.exchanges[0].attach_chain(stages, chain_key, label):
            continue
        del pipe[-2]
        id_remap[f.operator_id] = sink.operator_id
        sink.name = label
        report.setdefault("fragments", []).append({
            "pipeline": pi,
            "source": pipe[0].name if pipe else "?",
            "chain": [inner],
            "terminal": "all_to_all",
            "fused": label,
            "reason": None,
            "selectivity": 1.0,
            "sel_provenance": "static",
        })
        report["fused"] = report.get("fused", 0) + 1
        _tk.FUSED_FRAGMENTS["fused", ""] += 1
        absorbed += 1
    if node_ops is not None and absorbed:
        for nid, ids in node_ops.items():
            seen = set()
            out = []
            for op_id in ids:
                mapped = id_remap.get(op_id, op_id)
                if mapped not in seen:
                    seen.add(mapped)
                    out.append(mapped)
            node_ops[nid] = out
    return absorbed
