"""Join operators (reference: presto_tpu/operators/join_ops.py;
HashBuilderOperator.java:51 / LookupJoinOperator.java:53, bridged like
the reference's LookupSourceFactory).

The build pipeline fills a JoinBridge; the probe pipeline streams its
batches through the probe kernel (`make_probe_kernel`: K5's search,
then K9's expand), or, for a semi join, through K7's mark
(`SemiJoinOperator`). A FULL join also keeps per-build-row matched
flags across the probe batches (K9's full mode) and emits the build rows
no probe row matched after the last one (K11). The port's runner drives
a plan's pipelines in order, build before probe, so the bridge is ready
before the first probe batch arrives.

The build side stays resident on the device: spilling it to the host
in hash partitions (the reference's `SpilledBuild` and `_revoke`)
comes with the memory slice (ROADMAP A10).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.batch import (
    Batch, begin_deferred_compact, bucket_capacity, empty_batch,
    end_deferred_compact, operator_capacity, remap_column,
)
from presto_tpu_torch.execution import dynamic_filters as df
from presto_tpu_torch.operators.base import (
    DriverContext, Operator, OperatorContext, OperatorFactory,
)
from presto_tpu_torch.ops import join as join_ops


class JoinCapacityExceeded(Exception):
    """A probe batch's join output exceeded the output capacity (probe
    capacity x expansion factor). Detected on the device and raised
    once per query through DriverContext.deferred_checks; the runner
    retries with the suggested larger factor."""

    def __init__(self, suggested: int):
        super().__init__(
            f"join output overflowed; retry with expansion factor "
            f"{suggested}")
        self.suggested = suggested


class JoinBridge:
    """Build-side handoff (reference: LookupSourceFactory): `table` is
    set once the build finishes."""

    def __init__(self):
        self.table: Optional[join_ops.BuildTable] = None

    @property
    def ready(self) -> bool:
        return self.table is not None


class HashBuildOperator(Operator):
    """Sink of the build pipeline: accumulates batches, indexes them on
    finish (reference: HashBuilderOperator.java:51).

    `key_dicts` (parallel to key_names; None for non-string keys) are
    the planner's unified dictionaries: both join sides re-encode string
    keys onto them, so code equality is string equality.
    `df_publish` [(key, df_id, registry)] names the keys whose dynamic
    filters this build publishes."""

    def __init__(self, ctx: OperatorContext, bridge: JoinBridge,
                 key_names: Tuple[str, ...],
                 key_dicts: Optional[List[Optional[tuple]]] = None,
                 schema_cols: Optional[Sequence[tuple]] = None,
                 df_publish: Optional[List[tuple]] = None):
        super().__init__(ctx)
        self.bridge = bridge
        self.key_names = key_names
        self.key_dicts = key_dicts
        self.schema_cols = schema_cols
        self._batches: List[Batch] = []
        self._total = None
        self._finished = False
        self._df_publish = df_publish or []
        self._df_state: dict = {}

    def needs_input(self) -> bool:
        return not self._finished

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        batch = _remap_keys(batch, self.key_names, self.key_dicts)
        for key, df_id, _ in self._df_publish:
            c = batch.columns[key]
            st = self._df_state.get(df_id)
            if st is None:
                st = df.bounds_init(c.data.dtype, batch.device)
            self._df_state[df_id] = df.bounds_step(
                st, c.data, c.mask & batch.row_valid)
        self._batches.append(batch)
        # running live-row total on the device: finish() reads it once
        t = batch.row_valid.sum()
        self._total = t if self._total is None else self._total + t

    def get_output(self) -> Optional[Batch]:
        return None

    def _publish_df(self, merged: Batch) -> None:
        """Publish per-key dynamic filters: the running bounds, plus the
        distinct set when it fits DF_SET_MAX (one host read of its
        overflow flag, beside the build's own)."""
        for key, df_id, reg in self._df_publish:
            if df_id in self._df_state:
                mn, mx = self._df_state[df_id]
                c = merged.columns[key]
                vals, n, ovf = df.distinct_set(c.data,
                                               c.mask & merged.row_valid)
                reg.publish(df_id, mn, mx,
                            None if bool(ovf) else (vals, n))
            else:
                # empty build side: the impossible range prunes every
                # probe row of an inner join
                c = merged.columns[key]
                mn, mx = df.bounds_init(c.data.dtype, merged.device)
                reg.publish(df_id, mn, mx)

    def finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        # one host read for the whole build side (not one per batch)
        total = int(self._total) if self._total is not None else 0
        if self._batches:
            merged = Batch.concat(self._batches, operator_capacity(total),
                                  live_rows=total)
        else:
            if self.schema_cols is None:
                raise RuntimeError("empty build side needs its schema")
            merged = _remap_keys(
                empty_batch(self.schema_cols, self.ctx.driver_context.device),
                self.key_names, self.key_dicts)
        self._publish_df(merged)
        self.bridge.table = join_ops.build_for_backend(merged,
                                                       self.key_names)
        self._batches = []

    def is_finished(self) -> bool:
        return self._finished

    def close(self) -> None:
        # the built table outlives this driver: the probe's driver
        # releases it (LookupJoinOperator.close)
        self._batches = []


def make_probe_kernel(key_names: Tuple[str, ...], join_type: str,
                      probe_output: Tuple[str, ...],
                      build_output: Tuple[str, ...],
                      build_keys: Tuple[str, ...],
                      fused_filter=None, fused_projections=None,
                      input_dicts=None, pre=None):
    """The probe step: kernel(table, batch, matched, out_capacity) ->
    (batch, overflow flag, live rows or None); `matched` is the full
    join's running flags (updated in place), None otherwise.

    `pre` (a chain body, operators/fused_fragment.py) is the upstream
    filter/project chain fused ahead of the probe, with the
    unified-dictionary key remap as a gather in its last stage: one
    K12 launch, then K5's search. `fused_filter`/`fused_projections`
    are the FilterProject that followed the join (probe-tail fusion,
    the planner's `_append_filter_project`): one K12 launch over K9's
    output, so the join's rows go through the expression forest before
    the deferred compaction, without an operator between them."""
    tail = make_tail_kernel(fused_filter, fused_projections, input_dicts)

    def kernel(table, batch: Batch, matched, out_capacity: int):
        if pre is not None:
            batch = pre(batch)
        if join_type == "full":
            out, ovf, live = join_ops.probe_join_full(
                table, batch, key_names, matched, out_capacity,
                probe_output, build_output, build_keys)
        else:
            out, ovf, live = join_ops.probe_join(
                table, batch, key_names, out_capacity, join_type,
                probe_output, build_output, build_keys)
        if tail is not None:
            out, live = tail(out), None
        return out, ovf, live
    # the fused chain bodies (None when nothing is fused)
    kernel.pre, kernel.tail = pre, tail
    return kernel


def make_tail_kernel(fused_filter, fused_projections, input_dicts=None):
    """The FilterProject fused onto a join's output (probe rows and the
    FULL join's outer tail alike), or None when nothing was fused."""
    if fused_filter is None and not fused_projections:
        return None
    from presto_tpu_torch.operators.core import make_filter_project_kernel
    return make_filter_project_kernel(fused_filter,
                                      list(fused_projections or ()),
                                      input_dicts)


class LookupJoinOperator(Operator):
    """Probe side (reference: LookupJoinOperator.java:53, :392).

    Per probe batch: K5's search and the expand, with no host sync. The
    output capacity is probe capacity x `expansion_factor` (1 is exact
    for every FK->PK join); the on-device overflow flag accumulates
    across batches and is read once per query, and a tripped flag
    retries the query with a 4x factor (JoinCapacityExceeded).

    A FULL join (reference: presto_tpu/operators/join_ops.py:567-681)
    folds every probe batch's verified matches into one `_matched` flag
    per build row, and after the last probe batch emits the build rows
    never matched with a NULL probe side (`probe_schema`): the operator
    is finished only once that outer tail is out."""

    def __init__(self, ctx: OperatorContext, bridge: JoinBridge,
                 key_names: Tuple[str, ...], join_type: str,
                 probe_output: Sequence[str], build_output: Sequence[str],
                 build_keys: Optional[Tuple[str, ...]] = None,
                 key_dicts: Optional[List[Optional[tuple]]] = None,
                 probe_schema: Optional[Sequence[tuple]] = None,
                 expansion_factor: int = 1):
        super().__init__(ctx)
        self.bridge = bridge
        self.key_names = key_names
        self.key_dicts = key_dicts
        self.join_type = join_type
        self.build_output = tuple(build_output)
        if join_type == "full" and probe_schema is None:
            raise ValueError("a full join needs the probe schema for its "
                             "NULL side")
        if probe_schema is not None and key_dicts:
            # key columns take the planner's unified dictionary: probe
            # batches are remapped onto it (_remap_keys), and the outer
            # tail must concat with them
            fix = {k: d for k, d in zip(key_names, key_dicts)
                   if d is not None}
            probe_schema = [(n, t, fix.get(n, dic))
                            for n, t, dic in probe_schema]
        self.probe_schema = tuple(probe_schema) if probe_schema else None
        self._matched = None
        self._outer_emitted = False
        self.expansion_factor = max(1, int(expansion_factor))
        self._kernel = make_probe_kernel(
            tuple(key_names), join_type, tuple(probe_output),
            tuple(build_output),
            tuple(build_keys) if build_keys else tuple(key_names))
        self._tail_kernel = None
        #: the upstream chain (and the key remap) run inside the probe
        #: kernel: the host-side remap must not run twice
        self.pre_fused = False
        self._overflow = None
        # two-slot output queue: a probed batch is emitted one driver
        # pass after its probe, so its live count's copy to the host
        # overlaps the next probe
        self._pending: List = []
        self._finishing = False
        ctx.driver_context.deferred_checks.append(self._deferred_check)

    def use_kernels(self, probe_kernel, tail_kernel,
                    pre_fused: bool) -> None:
        """Install the factory's fused probe kernel and the FULL join's
        tail FilterProject (None = identity)."""
        self._kernel = probe_kernel
        self._tail_kernel = tail_kernel
        self.pre_fused = pre_fused

    def _deferred_check(self):
        return self._overflow, \
            lambda: JoinCapacityExceeded(self.expansion_factor * 4)

    def needs_input(self) -> bool:
        return len(self._pending) < 2 and not self._finishing

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        if not self.bridge.ready:
            raise RuntimeError(f"{self.ctx.name}: probe before its build "
                               "finished (build pipelines run first)")
        if not self.pre_fused:
            batch = _remap_keys(batch, self.key_names, self.key_dicts)
        table = self.bridge.table
        # the output capacity of the reference's probe, whose batch
        # arrives padded to the kernel ladder (its pad_for_kernel):
        # sized alike, a join overflows, and re-runs, when the
        # reference's does (ROADMAP C5)
        cap = bucket_capacity(operator_capacity(batch.capacity)
                              * self.expansion_factor)
        if self.join_type == "full" and self._matched is None:
            self._matched = torch.zeros(table.sorted_hash.shape[0],
                                        dtype=torch.bool,
                                        device=batch.device)
        out, ovf, _ = self._kernel(table, batch, self._matched, cap)
        self._overflow = ovf if self._overflow is None \
            else self._overflow | ovf
        self._pending.append(begin_deferred_compact(out))

    def _emit_outer(self) -> Batch:
        """FULL OUTER tail: the never-matched build rows with a NULL
        probe side (K11), compacted once per query after the last probe
        batch, when there is nothing left to overlap the count with."""
        table = self.bridge.table
        matched = self._matched if self._matched is not None else \
            torch.zeros(table.sorted_hash.shape[0], dtype=torch.bool,
                        device=table.sorted_hash.device)
        out, total = join_ops.unmatched_build(
            table, matched, self.probe_schema, self.build_output)
        if self._tail_kernel is not None:
            # the filter/projections the probe kernel fused apply to
            # the outer tail too
            out, total = self._tail_kernel(out), None
        self._outer_emitted = True
        return end_deferred_compact(*begin_deferred_compact(out, total))

    def get_output(self) -> Optional[Batch]:
        if self._pending and (len(self._pending) > 1 or self._finishing):
            out, total = self._pending.pop(0)
            return self._count_out(end_deferred_compact(out, total))
        if self._finishing and not self._pending \
                and self.join_type == "full" and not self._outer_emitted:
            return self._count_out(self._emit_outer())
        return None

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing and not self._pending \
            and (self.join_type != "full" or self._outer_emitted)

    def close(self) -> None:
        self._pending = []
        self._matched = None
        self.bridge.table = None


class SemiJoinOperator(Operator):
    """WHERE x IN (subquery) / EXISTS: keeps the probe rows whose key
    the build side holds (reference: HashSemiJoinOperator;
    presto_tpu/operators/join_ops.py:684). `negate` gives NOT IN / NOT
    EXISTS anti-join semantics for non-NULL keys: keep =
    ~found & valid, so a NULL probe key is dropped either way.

    Semi joins are usually selective, so outputs go through the
    one-round-delayed count/compact protocol, as lookup-join outputs
    do. The probe's driver releases the build table when it closes."""

    def __init__(self, ctx: OperatorContext, bridge: JoinBridge,
                 key_names: Tuple[str, ...], negate: bool,
                 build_keys: Optional[Tuple[str, ...]] = None,
                 key_dicts: Optional[List[Optional[tuple]]] = None):
        super().__init__(ctx)
        self.bridge = bridge
        self.key_names = key_names
        self.build_keys = build_keys
        self.key_dicts = key_dicts
        self.negate = negate
        # two-slot queue: a batch is emitted one driver pass after its
        # mark, so its live count's copy overlaps the next mark
        self._pending: List = []
        self._finishing = False

    def needs_input(self) -> bool:
        return len(self._pending) < 2 and not self._finishing

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        if not self.bridge.ready:
            raise RuntimeError(f"{self.ctx.name}: probe before its build "
                               "finished (build pipelines run first)")
        probe = _remap_keys(batch, self.key_names, self.key_dicts)
        keep = join_ops.semi_mark(self.bridge.table, probe, self.key_names,
                                  self.build_keys, "hash", self.negate)
        self._pending.append(begin_deferred_compact(batch.filter(keep)))

    def get_output(self) -> Optional[Batch]:
        if self._pending and (len(self._pending) > 1 or self._finishing):
            out, total = self._pending.pop(0)
            return self._count_out(end_deferred_compact(out, total))
        return None

    def finish(self) -> None:
        self._finishing = True

    def is_finished(self) -> bool:
        return self._finishing and not self._pending

    def close(self) -> None:
        self._pending = []
        self.bridge.table = None


def _remap_keys(batch: Batch, key_names, key_dicts) -> Batch:
    """Align string key columns to the planner's unified dictionaries."""
    if not key_dicts:
        return batch
    cols = dict(batch.columns)
    for name, dic in zip(key_names, key_dicts):
        if dic is not None and cols[name].dictionary != dic:
            cols[name] = remap_column(cols[name], dic)
    return Batch(cols, batch.row_valid)


class HashBuildOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, bridge: JoinBridge,
                 key_names: Sequence[str],
                 key_dicts: Optional[List[Optional[tuple]]] = None,
                 schema_cols: Optional[Sequence[tuple]] = None,
                 df_publish: Optional[List[tuple]] = None):
        super().__init__(operator_id, "hash_build")
        self.bridge = bridge
        self.key_names = tuple(key_names)
        self.key_dicts = key_dicts
        self.schema_cols = schema_cols
        self.df_publish = df_publish

    def create(self, driver_context: DriverContext) -> Operator:
        return HashBuildOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            self.bridge, self.key_names, self.key_dicts,
            self.schema_cols, self.df_publish)


class LookupJoinOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, bridge: JoinBridge,
                 key_names: Sequence[str], join_type: str,
                 probe_output: Sequence[str], build_output: Sequence[str],
                 build_keys: Optional[Sequence[str]] = None,
                 key_dicts: Optional[List[Optional[tuple]]] = None,
                 expansion_factor: int = 1,
                 probe_schema: Optional[Sequence[tuple]] = None):
        super().__init__(operator_id, f"lookup_join({join_type})")
        if join_type not in join_ops.JOIN_TYPES:
            raise ValueError(f"lookup join: join type {join_type!r}")
        self.bridge = bridge
        self.key_names = tuple(key_names)
        self.join_type = join_type
        self.probe_output = list(probe_output)
        self.build_output = list(build_output)
        self.build_keys = tuple(build_keys) if build_keys else None
        self.key_dicts = key_dicts
        self.expansion_factor = expansion_factor
        self.probe_schema = probe_schema
        self._fused_filter = None
        self._fused_projections = None
        self._fused_dicts = None
        #: estimated surviving fraction of the fused tail filter (None =
        #: no filter / unknown), read by planner/fusion.py: chains this
        #: probe feeds into fold terminals inherit the sparsity its
        #: filter leaves behind
        self.fused_selectivity = None
        self.fused_sel_provenance = "static"
        self._pre = None        # (stages, chain_key) upstream chain
        self._kernels = None

    @property
    def args(self):
        return (self.key_names, self.join_type, self.probe_output,
                self.build_output, self.build_keys, self.key_dicts,
                self.probe_schema, self.expansion_factor)

    @property
    def fused(self) -> bool:
        return self._fused_filter is not None \
            or self._fused_projections is not None

    @property
    def pre_fused(self) -> bool:
        return self._pre is not None

    def fuse(self, filter_expr, projections, input_dicts=None,
             selectivity=None, sel_provenance: str = "static") -> None:
        """Planner peephole: absorb the FilterProject that would follow
        this join, so its expressions run over the probe's output in
        the same operator (one K12 launch after K9). `selectivity` is
        the absorbed filter's estimated surviving fraction. Only legal
        before the first create()."""
        assert self._kernels is None, "fuse() after create()"
        assert not self.fused, "join already fused a projection"
        self._fused_filter = filter_expr
        self._fused_projections = list(projections) if projections \
            else None
        self._fused_dicts = input_dicts
        if filter_expr is not None:
            self.fused_selectivity = selectivity
            self.fused_sel_provenance = sel_provenance

    def fuse_pre(self, pre, pre_key, name: str) -> None:
        """Whole-fragment fusion (planner/fusion.py): absorb the
        UPSTREAM filter/project chain, so scan -> chain -> key remap
        runs as one K12 launch ahead of the probe. Only legal before the
        first create(); the pass excludes full joins."""
        assert self._kernels is None, "fuse_pre() after create()"
        assert self._pre is None, "join already fused an upstream chain"
        assert self.join_type != "full", \
            "full-join probes keep the host-side remap (outer tail)"
        self._pre = (tuple(pre), pre_key)
        self.name = name

    def _pre_body(self):
        """The upstream chain plus a last stage that re-encodes the
        string keys onto the planner's unified dictionaries (a gather
        in K12, where the unfused operator remaps on its own)."""
        from presto_tpu_torch.expr.compile import compile_column
        from presto_tpu_torch.operators.fused_fragment import (
            ChainStage, cached_chain_body,
        )
        stages, chain_key = self._pre
        last = stages[-1]
        targets = {k: d for k, d in zip(self.key_names,
                                        self.key_dicts or ())
                   if d is not None}
        remapped = [(n, ce) for n, ce in last.projections
                    if n in targets and ce.dictionary != targets[n]]
        if remapped:
            out_schema = [(n, ce.type, ce.dictionary)
                          for n, ce in last.projections]
            device = last.projections[0][1].device
            stages = stages + (ChainStage(None, tuple(
                (n, compile_column(n, out_schema, device,
                                   remap_to=targets.get(n)))
                for n, _, _ in out_schema), None),)
        key = ("probe", chain_key, tuple(
            (n, targets[n]) for n, _ in remapped)) \
            if chain_key is not None else None
        return cached_chain_body(stages, key)

    def _build_kernels(self):
        pre = self._pre_body() if self._pre is not None else None
        probe_kernel = make_probe_kernel(
            self.key_names, self.join_type, tuple(self.probe_output),
            tuple(self.build_output),
            self.build_keys if self.build_keys else self.key_names,
            self._fused_filter, self._fused_projections,
            self._fused_dicts, pre=pre)
        tail_kernel = make_tail_kernel(
            self._fused_filter, self._fused_projections,
            self._fused_dicts) if self.join_type == "full" else None
        return probe_kernel, tail_kernel

    def create(self, driver_context: DriverContext) -> Operator:
        if self._kernels is None:
            self._kernels = self._build_kernels()
        op = LookupJoinOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            self.bridge, *self.args)
        op.use_kernels(*self._kernels, pre_fused=self.pre_fused)
        return op


class SemiJoinOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, bridge: JoinBridge,
                 key_names: Sequence[str], negate: bool = False,
                 build_keys: Optional[Sequence[str]] = None,
                 key_dicts: Optional[List[Optional[tuple]]] = None):
        super().__init__(operator_id, "semi_join")
        self.bridge = bridge
        self.args = (tuple(key_names), negate,
                     tuple(build_keys) if build_keys else None, key_dicts)

    def create(self, driver_context: DriverContext) -> Operator:
        return SemiJoinOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            self.bridge, *self.args)
