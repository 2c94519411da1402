"""The mesh exchange: the data plane between plan fragments (reference:
presto_tpu/operators/exchange_ops.py; PartitionedOutputBuffer.java:48
and ExchangeClient.java:81 in Presto).

Every fragment task of a query lives in one process, so an exchange is
an in-process object that routes device batches from producer tasks to
consumer task queues:

  - repartition on keys, as many producers and consumers as workers
    (the collective case): a "wave" of one pending batch per producer
    runs K18 (parallel/shuffle.py `wave_repartition`, the reference's
    all_to_all wave), and each consumer receives one batch sized to its
    live rows;
  - repartition on keys otherwise (`_hash_split`, e.g. a single VALUES
    task spreading over the workers): each batch split by the same
    destination function into one masked batch per consumer;
  - repartition without keys: whole batches round-robin;
  - gather: every batch to the single consumer;
  - broadcast: every batch to every consumer;
  - passthrough: producer i to consumer i.

All workers of the port's mesh share one card, so gather, broadcast and
round-robin move no bytes: a consumer reads the producer's tensors.

`partition_segments` is the HTTP data plane's split of one producer
batch (server/node.py `HttpExchange.push`): kernel K20
(csrc/exchange_partition.cu) on a CUDA batch, `partition_sort_plain` on
a CPU batch. Grouped execution (lifespans > 1, host and disk spools, recoverable
buckets) needs the memory pool of ROADMAP A10; an exchange asked for it
raises.
"""

from __future__ import annotations

import collections
import ctypes
from typing import List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.batch import (
    Batch, Column, pad_batch, quantized_capacity,
)
from presto_tpu_torch.operators.base import (
    DriverContext, Operator, OperatorContext, OperatorFactory,
)
from presto_tpu_torch.parallel.shuffle import (
    WaveChain, batch_row_bytes, partition_dest, partition_key_hash,
    wave_repartition,
)
from presto_tpu_torch.telemetry import kernels as _tk

#: launches of K20 (csrc/exchange_partition.cu): one per keyed push
PARTITION_KERNEL = _tk.LaunchCounter("exchange_partition",
                                     "exchange_partition")


class GroupedExecutionError(NotImplementedError):
    """Grouped (bucket-wise) execution was asked for: it needs the
    memory pool and spools of ROADMAP A10."""


def build_remap_tables(hash_dicts, key_dictionaries, device):
    """Per key, the table re-encoding its dictionary codes onto the
    unified hash dictionary (None for a key without one)."""
    if hash_dicts is None:
        return None
    remaps = []
    for dic, hd in zip(key_dictionaries, hash_dicts):
        if hd is None or dic is None:
            remaps.append(None)
        else:
            index = {v: i for i, v in enumerate(hd)}
            remaps.append(torch.tensor([index[v] for v in dic] or [0],
                                       dtype=torch.int32, device=device))
    return remaps


def partition_segments(batch: Batch, partition_keys: Sequence[str],
                       remaps, n_consumers: int
                       ) -> Tuple[Batch, torch.Tensor]:
    """The batch's rows sorted by destination (floored `|row_hash(keys)|
    mod n_consumers`, dead rows last) and the int32 segment bounds
    [n_consumers + 1]: consumer c's rows are [bounds[c], bounds[c+1])
    (reference: presto_tpu/operators/exchange_ops.py:79). The hash is
    K3's on the card; K20 sorts on a CUDA batch, the plain version on a
    CPU batch."""
    _tk.count("exchange_partition")
    h = partition_key_hash(batch, partition_keys, remaps)
    return partition_sort(batch, h, n_consumers)


def partition_sort(batch: Batch, h: torch.Tensor, w: int
                   ) -> Tuple[Batch, torch.Tensor]:
    """`partition_segments` from given row hashes `h` (int64)."""
    if batch.device.type == "cpu":
        return partition_sort_plain(batch, h, w)
    return _partition_cuda(batch, h, w)


def partition_sort_plain(batch: Batch, h: torch.Tensor, w: int
                         ) -> Tuple[Batch, torch.Tensor]:
    """K20's plain version, the reference's arithmetic: a stable argsort
    by destination, every column permuted, then `searchsorted` of the
    sorted destinations for the bounds."""
    dest = torch.where(batch.row_valid, partition_dest(h, w),
                       torch.full_like(h, w))
    sd, perm = torch.sort(dest, stable=True)
    cols = {n: Column(c.data[perm], c.mask[perm], c.type, c.dictionary)
            for n, c in batch.columns.items()}
    bounds = torch.searchsorted(
        sd, torch.arange(w + 1, dtype=sd.dtype, device=sd.device),
        side="left").to(torch.int32)
    return Batch(cols, batch.row_valid[perm]), bounds


def _partition_cuda(batch: Batch, h: torch.Tensor, w: int
                    ) -> Tuple[Batch, torch.Tensor]:
    from presto_tpu_torch.native import cuda
    from presto_tpu_torch.ops import common
    lib = cuda.library("exchange_partition")
    if w < 1 or w > lib.presto_partition_max_consumers():
        raise ValueError(f"exchange_partition: 1 to "
                         f"{lib.presto_partition_max_consumers()} "
                         f"consumers, got {w}")
    dev = batch.device
    n = batch.capacity
    rv = batch.row_valid.contiguous()
    common.check_rows(h, n, dev, (torch.int64,),
                      "exchange_partition: hashes")
    common.check_rows(rv, n, dev, (torch.bool,),
                      "exchange_partition: row_valid")
    bounds = torch.zeros(w + 1, dtype=torch.int32, device=dev)
    out_rv = torch.empty(n, dtype=torch.bool, device=dev)
    names = batch.names
    srcs = [(batch.columns[k].data.contiguous(),
             batch.columns[k].mask.contiguous()) for k in names]
    outs = [(torch.empty_like(d), torch.empty_like(m)) for d, m in srcs]
    if n > 0:
        for d, m in srcs:
            common.check_rows(d, n, dev, (d.dtype,),
                              "exchange_partition: column data")
            common.check_rows(m, n, dev, (torch.bool,),
                              "exchange_partition: column mask")
        block_rows = lib.presto_partition_block_rows()
        blocks = -(-n // block_rows)
        hist = torch.empty((w + 1) * blocks, dtype=torch.int32, device=dev)
        offs = torch.empty_like(hist)
        tab = [d.data_ptr() for d, _ in srcs] \
            + [m.data_ptr() for _, m in srcs] \
            + [d.data_ptr() for d, _ in outs] \
            + [m.data_ptr() for _, m in outs] \
            + [d.element_size() for d, _ in srcs]
        ctab = torch.tensor(tab or [0], dtype=torch.int64).to(dev)
        status = lib.presto_exchange_partition(
            ctypes.c_void_p(h.data_ptr()), ctypes.c_void_p(rv.data_ptr()),
            ctypes.c_int64(n), ctypes.c_int32(w), ctypes.c_int64(blocks),
            ctypes.c_void_p(hist.data_ptr()),
            ctypes.c_void_p(offs.data_ptr()),
            ctypes.c_void_p(bounds.data_ptr()),
            ctypes.c_void_p(ctab.data_ptr()), ctypes.c_int32(len(names)),
            ctypes.c_void_p(out_rv.data_ptr()),
            ctypes.c_void_p(cuda.stream_ptr(dev)))
        cuda.check(lib, status, "exchange_partition")
        PARTITION_KERNEL.launches += 1
    cols = {k: Column(d, m, batch.columns[k].type,
                      batch.columns[k].dictionary)
            for k, (d, m) in zip(names, outs)}
    return Batch(cols, out_rv), bounds


def host_pad_quantized(batch: Batch) -> Batch:
    """Pad a host (CPU) batch up to the quantized capacity ladder before
    it goes to the device (reference:
    presto_tpu/operators/exchange_ops.py:564 `_host_pad_quantized`)."""
    return pad_batch(batch, quantized_capacity(batch.capacity)
                     - batch.capacity)


def edge_key_dicts(edge) -> List:
    """Dictionaries of an edge's partition-key fields, in key order."""
    return [next((f.dictionary for f in edge.fields if f.symbol == k),
                 None)
            for k in edge.partition_keys]


class MeshExchange:
    """One exchange edge: N producer tasks -> M consumer task queues."""

    def __init__(self, exchange_id: int, scheme: str,
                 partition_keys: Sequence[str], hash_dicts,
                 key_dictionaries, mesh, n_producers: int,
                 n_consumers: int, lifespans: int = 1):
        if lifespans > 1:
            raise GroupedExecutionError(
                f"exchange {exchange_id}: lifespans={lifespans} asks for "
                "grouped (bucket-wise) execution, which needs the memory "
                "pool and spools of ROADMAP A10")
        if scheme not in ("repartition", "gather", "broadcast",
                          "passthrough"):
            raise ValueError(f"unknown exchange scheme {scheme}")
        self.exchange_id = exchange_id
        self.scheme = scheme
        self.partition_keys = list(partition_keys)
        self.mesh = mesh
        self.n_producers = n_producers
        self.n_consumers = n_consumers
        self.queues: List[collections.deque] = [
            collections.deque() for _ in range(n_consumers)]
        self._pending: List[collections.deque] = [
            collections.deque() for _ in range(n_producers)]
        self._done = [False] * n_producers
        self._rr = 0
        #: fused chain absorbed into the wave (fuse_exchange_sinks):
        #: producers then push the chain's INPUT batches
        self._chain: Optional[WaveChain] = None
        #: waves, live rows and their bytes across the exchange
        self.wave_count = 0
        self.wave_rows = 0
        self.wave_bytes = 0
        self._remaps = build_remap_tables(hash_dicts, key_dictionaries,
                                          mesh.device)

    # -- producer side -------------------------------------------------

    def push(self, producer: int, batch: Batch) -> None:
        scheme = self.scheme
        if scheme == "gather":
            self.queues[0].append(batch)
        elif scheme == "broadcast":
            for q in self.queues:
                q.append(batch)
        elif scheme == "passthrough":
            self.queues[producer].append(batch)
        elif not self.partition_keys:
            self.queues[self._rr % self.n_consumers].append(batch)
            self._rr += 1
        elif self.n_consumers == 1 and self.n_producers == 1:
            self.queues[0].append(batch)
        elif self._collective:
            self._pending[producer].append(batch)
            self._try_wave()
        else:
            self._hash_split(batch)

    def producer_done(self, producer: int) -> None:
        if not self._done[producer]:
            self._done[producer] = True
            if self.scheme == "repartition" and self.partition_keys \
                    and self._collective:
                self._try_wave()

    # -- consumer side -------------------------------------------------

    def pop(self, consumer: int) -> Optional[Batch]:
        q = self.queues[consumer]
        return q.popleft() if q else None

    def has_output(self, consumer: int) -> bool:
        return bool(self.queues[consumer])

    def finished(self, consumer: int) -> bool:
        return (all(self._done) and not self.queues[consumer]
                and not any(self._pending))

    # -- fused-chain absorption ----------------------------------------

    def chain_eligible(self) -> bool:
        """A collective hash repartition can absorb a producer chain."""
        return (self.scheme == "repartition" and bool(self.partition_keys)
                and self._collective)

    def attach_chain(self, stages, chain_key, label: str) -> bool:
        """Absorb a fused chain into the wave. Idempotent across the W
        producer tasks planning the same fragment: the first attach
        wins and later ones must carry the same key."""
        if not self.chain_eligible() or chain_key is None:
            return False
        if self._chain is not None:
            if self._chain.key != chain_key:
                raise AssertionError(
                    f"exchange {self.exchange_id}: conflicting fused "
                    f"chains {self._chain.key!r} vs {chain_key!r}")
            return True
        self._chain = WaveChain(tuple(stages), chain_key, label)
        return True

    # -- internals -----------------------------------------------------

    @property
    def _collective(self) -> bool:
        w = self.mesh.size
        return self.n_producers == w and self.n_consumers == w and w > 1

    def _hash_split(self, batch: Batch) -> None:
        """Non-collective keyed repartition: one masked copy of the
        batch's row_valid per consumer."""
        h = partition_key_hash(batch, self.partition_keys, self._remaps)
        dest = partition_dest(h, self.n_consumers)
        for c in range(self.n_consumers):
            self.queues[c].append(
                Batch(batch.columns, batch.row_valid & (dest == c)))

    def _try_wave(self) -> None:
        """Fire waves while every producer has a batch pending or is
        done (a done producer adds nothing to the wave)."""
        while True:
            have = [bool(p) for p in self._pending]
            if not any(have) or not all(
                    h or d for h, d in zip(have, self._done)):
                return
            wave = [p.popleft() if p else None for p in self._pending]
            outs, counts = wave_repartition(
                self.mesh, wave, self.partition_keys,
                key_remaps=self._remaps, chain=self._chain,
                return_counts=True)
            rows = int(sum(counts))
            self.wave_count += 1
            self.wave_rows += rows
            self.wave_bytes += rows * batch_row_bytes(outs[0])
            for c, b in enumerate(outs):
                self.queues[c].append(b)


class ExchangeSinkOperator(Operator):
    """Tail of a producer task's pipeline: tees every batch into each
    consumer edge of the fragment's output."""

    def __init__(self, ctx: OperatorContext,
                 exchanges: Sequence[MeshExchange], producer: int):
        super().__init__(ctx)
        self.exchanges = list(exchanges)
        self.producer = producer
        self._finished = False

    def needs_input(self) -> bool:
        return not self._finished

    def add_input(self, batch: Batch) -> None:
        self._count_in(batch)
        for ex in self.exchanges:
            ex.push(self.producer, batch)

    def get_output(self) -> Optional[Batch]:
        return None

    def finish(self) -> None:
        if not self._finished:
            self._finished = True
            for ex in self.exchanges:
                ex.producer_done(self.producer)

    def is_finished(self) -> bool:
        return self._finished


class ExchangeSourceOperator(Operator):
    """Head of a consumer task's pipeline (reference:
    ExchangeOperator.java:35)."""

    def __init__(self, ctx: OperatorContext, exchange: MeshExchange,
                 consumer: int):
        super().__init__(ctx)
        self.exchange = exchange
        self.consumer = consumer

    def needs_input(self) -> bool:
        return False

    def add_input(self, batch: Batch) -> None:
        raise RuntimeError("exchange source takes no input")

    def get_output(self) -> Optional[Batch]:
        b = self.exchange.pop(self.consumer)
        return self._count_out(b) if b is not None else None

    def finish(self) -> None:
        pass

    def is_finished(self) -> bool:
        return self.exchange.finished(self.consumer)


class ExchangeSinkOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int,
                 exchanges: Sequence[MeshExchange], producer: int):
        super().__init__(operator_id, "exchange_sink")
        self.exchanges = exchanges
        self.producer = producer

    def create(self, driver_context: DriverContext) -> Operator:
        return ExchangeSinkOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            self.exchanges, self.producer)


class ExchangeSourceOperatorFactory(OperatorFactory):
    def __init__(self, operator_id: int, exchange: MeshExchange,
                 consumer: int):
        super().__init__(operator_id, "exchange_source")
        self.exchange = exchange
        self.consumer = consumer

    def create(self, driver_context: DriverContext) -> Operator:
        return ExchangeSourceOperator(
            OperatorContext(self.operator_id, self.name, driver_context),
            self.exchange, self.consumer)
