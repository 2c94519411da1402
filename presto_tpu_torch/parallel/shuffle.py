"""Hash repartition between the mesh's workers (reference:
presto_tpu/parallel/shuffle.py; PartitionedOutputOperator.java:360 and
ExchangeClient.java:81 in Presto).

One wave is one batch per producer worker (a producer with nothing to
send passes None). Every live row goes to consumer floored `|row_hash(
keys)| mod W`; consumer c receives producer 0's rows for c in input
order, then producer 1's, and so on, packed at the front of a batch of
`quantized_capacity(count)` rows (at most W times the wave's quantized
producer capacity) whose other slots are dead and zero — the
reference's rows in the reference's order, which it gets from a
bucketize sort, a tiled all_to_all and a pack sort.

`wave_shuffle` is kernel K18 (csrc/exchange_shuffle.cu) on CUDA tensors
and `wave_shuffle_plain` on CPU tensors: the hashes come from K3
(`common.row_hash_pair`), VARCHAR keys re-encoded onto the unified
dictionary for routing only (the payload keeps the producer's codes).
With an absorbed chain (`WaveChain`, planner/fusion.py
`fuse_exchange_sinks`) each producer's batch first runs the chain (K12
on the card) and the keys are read from its output: the reference's
`spmd_fragment`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.batch import (
    Batch, Column, bucket_capacity, pad_batch, quantized_capacity,
)
from presto_tpu_torch.ops import common
from presto_tpu_torch.parallel.mesh import Mesh
from presto_tpu_torch.telemetry import kernels as _tk

#: launches of the wave kernel (csrc/exchange_shuffle.cu): one per wave
WAVE_KERNEL = _tk.LaunchCounter("exchange_shuffle", "spmd_shuffle")

#: one producer's part of a wave: (key hashes, row_valid, [(data, mask)]
#: per column), or None for a producer with no batch
Producer = Optional[Tuple[torch.Tensor, torch.Tensor,
                          Sequence[Tuple[torch.Tensor, torch.Tensor]]]]
#: one consumer's part: ([(data, mask)] per column, row_valid)
Received = Tuple[List[Tuple[torch.Tensor, torch.Tensor]], torch.Tensor]


def partition_dest(h: torch.Tensor, w: int) -> torch.Tensor:
    """Consumer of each row: floored `|h| mod w` (the reference's
    `jnp.abs(h) % w`). |INT64_MIN| is INT64_MIN, and the floored
    remainder still lands it in [0, w)."""
    return torch.remainder(torch.abs(h), w)


def _consumer_cap(count: int, shard_len: int) -> int:
    return min(quantized_capacity(count), shard_len)


def wave_shuffle_plain(producers: Sequence[Producer], w: int,
                       shard_len: int, template) -> Tuple[List[Received],
                                                          List[int]]:
    """K18's plain version: the reference's arithmetic in torch (stable
    argsort of each producer's rows by destination, counts, then one
    concat per consumer). `template` lists each column's (data dtype)
    for consumers that receive nothing."""
    dev = next(p[1].device for p in producers if p is not None)
    parts = [[[] for _ in range(w)] for _ in range(len(template))]
    rv_parts: List[List[torch.Tensor]] = [[] for _ in range(w)]
    for prod in producers:
        if prod is None:
            continue
        h, rv, cols = prod
        dest = torch.where(rv, partition_dest(h, w),
                           torch.full_like(h, w))
        order = torch.sort(dest, stable=True).indices
        counts = torch.bincount(dest, minlength=w + 1).tolist()
        lo = 0
        for c in range(w):
            idx = order[lo:lo + counts[c]]
            lo += counts[c]
            for k, (d, m) in enumerate(cols):
                parts[k][c].append((d[idx], m[idx]))
            rv_parts[c].append(rv[idx])
    outs: List[Received] = []
    totals = []
    for c in range(w):
        count = sum(int(t.shape[0]) for t in rv_parts[c])
        cap = _consumer_cap(count, shard_len)
        cols = []
        for k, dtype in enumerate(template):
            data = torch.zeros(cap, dtype=dtype, device=dev)
            mask = torch.zeros(cap, dtype=torch.bool, device=dev)
            if count:
                data[:count] = torch.cat([d for d, _ in parts[k][c]])
                mask[:count] = torch.cat([m for _, m in parts[k][c]])
            cols.append((data, mask))
        rv = torch.zeros(cap, dtype=torch.bool, device=dev)
        rv[:count] = True
        outs.append((cols, rv))
        totals.append(count)
    return outs, totals


def _wave_cuda(producers: Sequence[Producer], w: int, shard_len: int,
               template) -> Tuple[List[Received], List[int]]:
    from presto_tpu_torch.native import cuda
    lib = cuda.library("exchange_shuffle")
    if w > lib.presto_wave_max_workers():
        raise ValueError(f"exchange_shuffle: at most "
                         f"{lib.presto_wave_max_workers()} workers, got {w}")
    dev = next(p[1].device for p in producers if p is not None)
    ncols = len(template)
    block_rows = lib.presto_wave_block_rows()
    hptr, vptr, ns, base = [], [], [], [0]
    for prod in producers:
        if prod is None:
            hptr.append(0)
            vptr.append(0)
            ns.append(0)
        else:
            h, rv, cols = prod
            n = rv.shape[0]
            common.check_rows(h, n, dev, (torch.int64,),
                              "exchange_shuffle: hashes")
            common.check_rows(rv, n, dev, (torch.bool,),
                              "exchange_shuffle: row_valid")
            for (d, m), dtype in zip(cols, template):
                common.check_rows(d, n, dev, (dtype,),
                                  "exchange_shuffle: column data")
                common.check_rows(m, n, dev, (torch.bool,),
                                  "exchange_shuffle: column mask")
            hptr.append(h.data_ptr())
            vptr.append(rv.data_ptr())
            ns.append(n)
        base.append(base[-1] + -(-ns[-1] // block_rows))
    blocks = base[-1]
    stream = ctypes.c_void_p(cuda.stream_ptr(dev))
    if blocks == 0:
        counts = [0] * w
    else:
        tab = torch.tensor(hptr + vptr + ns + base, dtype=torch.int64) \
            .to(dev)
        hist = torch.empty(w * blocks, dtype=torch.int32, device=dev)
        offs = torch.empty(w * blocks, dtype=torch.int64, device=dev)
        dcounts = torch.empty(w, dtype=torch.int64, device=dev)
        status = lib.presto_wave_count(
            ctypes.c_void_p(tab.data_ptr()), ctypes.c_int32(w),
            ctypes.c_int64(blocks), ctypes.c_void_p(hist.data_ptr()),
            ctypes.c_void_p(offs.data_ptr()),
            ctypes.c_void_p(dcounts.data_ptr()), stream)
        cuda.check(lib, status, "exchange_shuffle")
        counts = dcounts.tolist()  # the wave's one host read
    caps = [_consumer_cap(c, shard_len) for c in counts]
    outs: List[Received] = []
    for cap in caps:
        cols = [(torch.empty(cap, dtype=dt, device=dev),
                 torch.empty(cap, dtype=torch.bool, device=dev))
                for dt in template]
        outs.append((cols, torch.empty(cap, dtype=torch.bool, device=dev)))
    if blocks == 0:
        for cols, rv in outs:
            rv.zero_()
            for d, m in cols:
                d.zero_()
                m.zero_()
        return outs, counts
    src = [[0] * ncols for _ in range(w)]
    src_m = [[0] * ncols for _ in range(w)]
    for p, prod in enumerate(producers):
        if prod is not None:
            for k, (d, m) in enumerate(prod[2]):
                src[p][k] = d.data_ptr()
                src_m[p][k] = m.data_ptr()
    flat = [x for row in src for x in row] + [x for row in src_m for x in row]
    flat += [d.data_ptr() for cols, _ in outs for d, _ in cols]
    flat += [m.data_ptr() for cols, _ in outs for _, m in cols]
    flat += [torch.empty(0, dtype=dt).element_size() for dt in template]
    flat += [rv.data_ptr() for _, rv in outs] + caps
    ctab = torch.tensor(flat, dtype=torch.int64).to(dev)
    max_cols = lib.presto_wave_max_cols()
    runs = [(lo, min(lo + max_cols, ncols))
            for lo in range(0, ncols, max_cols)] or [(0, 0)]
    for i, (lo, hi) in enumerate(runs):
        status = lib.presto_wave_scatter(
            ctypes.c_void_p(tab.data_ptr()), ctypes.c_void_p(ctab.data_ptr()),
            ctypes.c_int32(w), ctypes.c_int32(ncols), ctypes.c_int64(blocks),
            ctypes.c_void_p(offs.data_ptr()),
            ctypes.c_void_p(dcounts.data_ptr()), ctypes.c_int32(lo),
            ctypes.c_int32(hi), ctypes.c_int32(int(i == 0)),
            ctypes.c_int64(max(caps)), stream)
        cuda.check(lib, status, "exchange_shuffle")
    WAVE_KERNEL.launches += 1
    return outs, counts


def wave_shuffle(producers: Sequence[Producer], w: int, shard_len: int,
                 template) -> Tuple[List[Received], List[int]]:
    """K18: one wave's rows to their consumers (see the module text).
    The CUDA kernel on CUDA tensors, the plain version on CPU tensors.
    Returns the consumers' (columns, row_valid) and live counts."""
    dev = next((p[1].device for p in producers if p is not None), None)
    if dev is None:
        raise ValueError("exchange_shuffle: a wave with no producer batch")
    if dev.type == "cpu":
        return wave_shuffle_plain(producers, w, shard_len, template)
    return _wave_cuda(producers, w, shard_len, template)


# ---------------------------------------------------------------------------
# The wave: the exchange operator's entry point


@dataclasses.dataclass(frozen=True)
class WaveChain:
    """A fused filter/project chain absorbed into a wave
    (planner/fusion.py `fuse_exchange_sinks`): `stages` are
    operators/fused_fragment ChainStages, `key` their fingerprint,
    `label` the fusion report's `fused[...+all_to_all]`."""
    stages: tuple
    key: object
    label: str

    def body(self):
        from presto_tpu_torch.operators.fused_fragment import (
            cached_chain_body,
        )
        return cached_chain_body(self.stages, self.key, family=None)


def batch_row_bytes(batch: Batch) -> int:
    """Bytes per row of a wave for this schema: column payloads, one
    mask byte per column and the row_valid byte (the exchange's bytes
    accounting, as the reference counts them)."""
    return sum(c.data.element_size() + 1
               for c in batch.columns.values()) + 1


def partition_key_hash(batch: Batch, key_names: Sequence[str],
                       key_remaps) -> torch.Tensor:
    """row_hash of the partition keys (K3 on the card), string keys
    re-encoded through `key_remaps` onto the unified dictionary for
    routing only: the one place the exchange's partition hash is
    computed (reference: presto_tpu/operators/exchange_ops.py:63)."""
    keys = []
    for i, k in enumerate(key_names):
        c = batch.columns[k]
        d = c.data
        if key_remaps is not None and key_remaps[i] is not None:
            d = key_remaps[i][d.to(torch.int64)]
        keys.append((d.contiguous(), c.mask.contiguous()))
    h, _ = common.row_hash_pair(keys, batch.row_valid.contiguous(), False)
    return h


def wave_repartition(mesh: Mesh, batches: Sequence[Optional[Batch]],
                     key_names: Sequence[str], key_remaps=None,
                     chain: Optional[WaveChain] = None,
                     return_counts: bool = False):
    """Hash-repartition one wave: `batches[p]` is producer p's batch or
    None. Returns the W consumer batches (and their live counts with
    `return_counts`). `key_remaps[i]`, when set, re-encodes string key
    i's codes onto the unified hash dictionary; `chain` runs on every
    producer batch first and the keys are read from its output."""
    w = len(batches)
    if w != mesh.size:
        raise ValueError(f"a wave of {w} batches on a mesh of {mesh.size}")
    present = [b for b in batches if b is not None]
    if not present:
        raise ValueError("a wave with no producer batch")
    _tk.count("spmd_fragment" if chain is not None else "spmd_shuffle")
    if chain is not None:
        body = chain.body()
        batches = [None if b is None else body(b) for b in batches]
        present = [b for b in batches if b is not None]
    cap = quantized_capacity(max(b.capacity for b in present))
    tmpl = present[0]
    names = tmpl.names
    producers: List[Producer] = []
    for b in batches:
        if b is None:
            producers.append(None)
            continue
        producers.append((
            partition_key_hash(b, key_names, key_remaps),
            b.row_valid.contiguous(),
            [(b.columns[n].data.contiguous(), b.columns[n].mask.contiguous())
             for n in names]))
    outs, counts = wave_shuffle(producers, w, w * cap,
                                [tmpl.columns[n].data.dtype for n in names])
    result = []
    for cols, rv in outs:
        result.append(Batch(
            {n: Column(d, m, tmpl.columns[n].type,
                       tmpl.columns[n].dictionary)
             for n, (d, m) in zip(names, cols)}, rv))
    if return_counts:
        return result, counts
    return result


# ---------------------------------------------------------------------------
# Whole-batch helpers (reference: shard_batch, unshard_batch,
# hash_repartition, broadcast_batch)


@dataclasses.dataclass
class ShardedBatch:
    """A relation spread over the mesh: one batch per worker."""
    batches: List[Batch]
    mesh: Mesh

    @property
    def n_workers(self) -> int:
        return self.mesh.size


def shard_batch(batch: Batch, mesh: Mesh) -> ShardedBatch:
    """Split a batch row-wise into W equal slices (the capacity padded
    up so it divides evenly)."""
    w = mesh.size
    per = bucket_capacity(-(-batch.capacity // w))
    if per * w != batch.capacity:
        batch = pad_batch(batch, per * w - batch.capacity)
    parts = []
    for i in range(w):
        sl = slice(i * per, (i + 1) * per)
        parts.append(Batch(
            {n: Column(c.data[sl], c.mask[sl], c.type, c.dictionary)
             for n, c in batch.columns.items()}, batch.row_valid[sl]))
    return ShardedBatch(parts, mesh)


def unshard_batch(sb: ShardedBatch) -> Batch:
    """Every worker's live rows in one batch (the root stage's input)."""
    cap = bucket_capacity(sum(b.capacity for b in sb.batches))
    return Batch.concat(sb.batches, cap)


def hash_repartition(sb: ShardedBatch, key_names: Sequence[str]
                     ) -> ShardedBatch:
    """Repartition so that rows with equal keys land on one worker."""
    return ShardedBatch(wave_repartition(sb.mesh, sb.batches, key_names),
                        sb.mesh)


def broadcast_batch(batch: Batch, mesh: Mesh) -> List[Batch]:
    """The batch for every worker (all workers share the card, so every
    worker reads the same tensors)."""
    return [batch] * mesh.size
