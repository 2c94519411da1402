"""In-memory and blackhole connectors (reference:
presto_tpu/connectors/memory.py; presto-memory — the writable
test/staging connector CTAS and INSERT land in — and presto-blackhole,
the perf sink that discards writes and serves empty scans).

Memory tables hold device batches as written (on the writer's device:
the card, unless the runner was asked for the CPU); string columns,
array and map slots included, are re-encoded onto a per-table
dictionary at commit, so later scans and joins see one code space.
Table versions come from one process-wide mint.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from presto_tpu_torch.batch import Batch, remap_column
from presto_tpu_torch.connectors.spi import (
    Connector, ConnectorMetadata, ConnectorPageSink, ConnectorPageSource,
    ConnectorSplitManager, Split, TableHandle, TupleDomain,
)
from presto_tpu_torch.schema import ColumnSchema, RelationSchema


#: process-wide version mint: versions must stay MONOTONIC across a
#: DROP + recreate under one connector cache token — a fresh table
#: restarting at 0 would revive the dropped table's cache keys
_VERSION_MINT = itertools.count(1)


class _Table:
    def __init__(self, schema: RelationSchema):
        self.schema = schema
        self.batches: List[Batch] = []
        self.row_count = 0
        #: data version for the engine's cache hierarchy; reassigned
        #: from the mint at every committed write (spi
        #: ConnectorMetadata.table_version)
        self.version = next(_VERSION_MINT)


class _MemoryMetadata(ConnectorMetadata):
    def __init__(self, tables: Dict[Tuple[str, str], _Table]):
        self._tables = tables

    def list_schemas(self) -> List[str]:
        return sorted({s for s, _ in self._tables} | {"default"})

    def list_tables(self, schema: str) -> List[str]:
        return sorted(t for s, t in self._tables if s == schema)

    def get_table_schema(self, handle: TableHandle) -> RelationSchema:
        return self._tables[(handle.schema, handle.table)].schema

    def estimate_row_count(self, handle: TableHandle) -> Optional[int]:
        t = self._tables.get((handle.schema, handle.table))
        return t.row_count if t is not None else None

    def table_version(self, handle: TableHandle) -> Optional[int]:
        t = self._tables.get((handle.schema, handle.table))
        return t.version if t is not None else None


class _MemorySplitManager(ConnectorSplitManager):
    def __init__(self, tables: Dict[Tuple[str, str], _Table]):
        self._tables = tables

    def get_splits(self, handle: TableHandle,
                   target_splits: int,
                   constraint=None) -> List[Split]:
        t = self._tables[(handle.schema, handle.table)]
        n = max(len(t.batches), 1)
        # one split per stored-batch range so scans parallelize
        per = math.ceil(n / max(target_splits, 1))
        return [Split(handle, (lo, min(lo + per, len(t.batches))),
                      partition=i)
                for i, lo in enumerate(range(0, len(t.batches), per))] \
            or [Split(handle, (0, 0), partition=0)]


class _MemoryPageSource(ConnectorPageSource):
    def __init__(self, tables: Dict[Tuple[str, str], _Table]):
        self._tables = tables

    def batches(self, split: Split, columns: Sequence[str],
                batch_rows: int,
                constraint: Optional[TupleDomain] = None,
                device: torch.device = torch.device("cpu")
                ) -> Iterator[Batch]:
        t = self._tables[(split.table.schema, split.table.table)]
        lo, hi = split.info
        for b in t.batches[lo:hi]:   # stored on the writer's device
            yield Batch({n: b.columns[n] for n in columns}, b.row_valid)


class _MemoryPageSink(ConnectorPageSink):
    """Appends buffer; dictionary unification happens ONCE at finish()
    (per-append re-encoding of already-stored batches would make an
    n-batch string write O(n^2) in device remaps)."""

    def __init__(self, tables: Dict[Tuple[str, str], _Table]):
        self._tables = tables
        self._pending: Dict[Tuple[str, str], List[Batch]] = {}

    def create_table(self, handle: TableHandle,
                     schema: RelationSchema,
                     properties=None) -> None:
        if properties:
            raise ValueError(
                f"memory connector supports no table properties, "
                f"got {sorted(properties)}")
        key = (handle.schema, handle.table)
        if key in self._tables:
            raise ValueError(f"table {handle} already exists")
        self._tables[key] = _Table(schema)

    def append(self, handle: TableHandle, batch: Batch) -> None:
        t = self._tables[(handle.schema, handle.table)]
        key = (handle.schema, handle.table)
        names = [p[0] for cs in t.schema.columns
                 for p in cs.physical()]
        self._pending.setdefault(key, []).append(
            Batch({n: batch.columns[n] for n in names},
                  batch.row_valid))

    def finish(self, handle: TableHandle) -> None:
        key = (handle.schema, handle.table)
        pending = self._pending.pop(key, [])
        if not pending:
            return
        t = self._tables[key]
        new_schema_cols = []
        for cs in t.schema.columns:
            # string slots of a complex column (or the column itself)
            # unify onto ONE merged dictionary
            snames = [p[0] for p in cs.physical() if p[1].is_string]
            if not snames or (cs.dictionary is None and all(
                    b.columns[n].dictionary is None
                    for b in pending for n in snames)):
                new_schema_cols.append(cs)
                continue
            merged = set(cs.dictionary or ())
            for b in pending:
                for n in snames:
                    merged |= set(b.columns[n].dictionary or ())
            merged = tuple(sorted(merged))
            if merged != cs.dictionary:
                # one re-encode pass over stored + pending batches
                for store in (t.batches, pending):
                    for i, old in enumerate(store):
                        oc = dict(old.columns)
                        for n in snames:
                            oc[n] = remap_column(oc[n], merged)
                        store[i] = Batch(oc, old.row_valid)
                cs = ColumnSchema(cs.name, cs.type, merged,
                                  form=cs.form)
            new_schema_cols.append(cs)
        t.schema = RelationSchema(new_schema_cols)
        for b in pending:
            t.batches.append(b)
            t.row_count += b.num_valid()
        # version moves LAST: a concurrent scan racing this commit may
        # cache the old contents, but only under the old version —
        # bumping before the mutation would let pre-commit data be
        # cached under the post-commit version (permanently stale)
        t.version = next(_VERSION_MINT)

    def abort(self, handle: TableHandle) -> None:
        # the created table (schema registration) survives; only the
        # uncommitted appends drop
        self._pending.pop((handle.schema, handle.table), None)

    def drop_table(self, handle: TableHandle) -> None:
        self._pending.pop((handle.schema, handle.table), None)
        del self._tables[(handle.schema, handle.table)]


class MemoryConnector(Connector):
    """Reference: presto-memory (MemoryMetadata, MemoryPagesStore,
    MemoryPageSinkProvider)."""

    name = "memory"

    def __init__(self):
        self._tables: Dict[Tuple[str, str], _Table] = {}
        self._metadata = _MemoryMetadata(self._tables)
        self._splits = _MemorySplitManager(self._tables)
        self._source = _MemoryPageSource(self._tables)
        self._sink = _MemoryPageSink(self._tables)

    @property
    def metadata(self):
        return self._metadata

    @property
    def split_manager(self):
        return self._splits

    @property
    def page_source(self):
        return self._source

    @property
    def page_sink(self):
        return self._sink


class _BlackholeSink(ConnectorPageSink):
    def __init__(self, tables: Dict[Tuple[str, str], _Table]):
        self._tables = tables

    def create_table(self, handle: TableHandle,
                     schema: RelationSchema,
                     properties=None) -> None:
        if properties:
            raise ValueError(
                f"blackhole connector supports no table properties, "
                f"got {sorted(properties)}")
        self._tables[(handle.schema, handle.table)] = _Table(schema)

    def append(self, handle: TableHandle, batch: Batch) -> None:
        # count, then discard (the write-throughput sink)
        t = self._tables[(handle.schema, handle.table)]
        t.row_count += batch.num_valid()

    def drop_table(self, handle: TableHandle) -> None:
        del self._tables[(handle.schema, handle.table)]


class _BlackholeSource(ConnectorPageSource):
    def batches(self, split: Split, columns: Sequence[str],
                batch_rows: int,
                constraint: Optional[TupleDomain] = None,
                device: torch.device = torch.device("cpu")
                ) -> Iterator[Batch]:
        return iter(())


class BlackholeConnector(Connector):
    """Reference: presto-blackhole — writes are swallowed (row count
    kept), reads are empty."""

    name = "blackhole"

    def __init__(self):
        self._tables: Dict[Tuple[str, str], _Table] = {}
        self._metadata = _MemoryMetadata(self._tables)
        self._splits = _MemorySplitManager(self._tables)
        self._source = _BlackholeSource()
        self._sink = _BlackholeSink(self._tables)

    @property
    def metadata(self):
        return self._metadata

    @property
    def split_manager(self):
        return self._splits

    @property
    def page_source(self):
        return self._source

    @property
    def page_sink(self):
        return self._sink

    def written_rows(self, schema: str, table: str) -> int:
        return self._tables[(schema, table)].row_count
