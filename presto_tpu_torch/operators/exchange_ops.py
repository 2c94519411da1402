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
Grouped execution (lifespans > 1, host and disk spools, recoverable
buckets) needs the memory pool of ROADMAP A10; an exchange asked for it
raises.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence

import torch

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.operators.base import (
    DriverContext, Operator, OperatorContext, OperatorFactory,
)
from presto_tpu_torch.parallel.shuffle import (
    WaveChain, batch_row_bytes, partition_dest, partition_key_hash,
    wave_repartition,
)


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
