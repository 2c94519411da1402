"""Connector SPI (reference: presto-spi spi/connector/ —
ConnectorMetadata.java:65, ConnectorSplitManager.java:23,
ConnectorPageSourceProvider.java:25, Plugin.java:32).

A Connector provides: metadata (tables/schemas), splits (units of
parallel scan), and page sources (split -> stream of Batches). The
scheduler assigns splits to workers/devices; page sources generate or
read data directly into device arrays.
"""

from __future__ import annotations

import abc
import dataclasses
import itertools
from typing import Any, Dict, Iterator, List, Optional, Sequence

import torch

from presto_tpu_torch.batch import Batch
from presto_tpu_torch.schema import RelationSchema


@dataclasses.dataclass(frozen=True)
class TableHandle:
    catalog: str
    schema: str
    table: str

    def __str__(self):
        return f"{self.catalog}.{self.schema}.{self.table}"


@dataclasses.dataclass(frozen=True)
class Split:
    """A unit of scan parallelism (reference: spi ConnectorSplit).
    `info` is connector-private (e.g. a row range)."""
    table: TableHandle
    info: Any
    # hint for placement on a mesh axis (connector bucketing, P10)
    partition: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Domain:
    """Allowed values of one column: an optional closed range and/or a
    discrete IN-set, in the column's PHYSICAL representation (dates as
    epoch days, decimals as unscaled ints). None bound = unbounded.
    (Reference: presto-common common/predicate/Domain + Range.)"""
    low: Any = None
    high: Any = None
    values: Optional[Tuple[Any, ...]] = None

    def test(self, arr) -> "Any":
        """Vectorized membership over a host numpy array."""
        import numpy as np
        keep = np.ones(len(arr), bool)
        if self.low is not None:
            keep &= arr >= self.low
        if self.high is not None:
            keep &= arr <= self.high
        if self.values is not None:
            keep &= np.isin(arr, np.asarray(self.values))
        return keep


@dataclasses.dataclass(frozen=True)
class TupleDomain:
    """Per-column constraint conjunction pushed into a scan (reference:
    presto-common common/predicate/TupleDomain, threaded through
    ConnectorPageSourceProvider). Hashable so page-source caches can key
    on it. Pushdown is UNENFORCED: the engine keeps its filter, the
    connector may use the constraint to skip or shrink work."""
    domains: Tuple[Tuple[str, Domain], ...] = ()

    def domain(self, column: str) -> Optional[Domain]:
        for name, d in self.domains:
            if name == column:
                return d
        return None

    def __bool__(self):
        return bool(self.domains)


class ConnectorMetadata(abc.ABC):
    @abc.abstractmethod
    def list_schemas(self) -> List[str]: ...

    @abc.abstractmethod
    def list_tables(self, schema: str) -> List[str]: ...

    @abc.abstractmethod
    def get_table_schema(self, handle: TableHandle) -> RelationSchema: ...

    def estimate_row_count(self, handle: TableHandle) -> Optional[int]:
        """Optional table cardinality estimate feeding the optimizer's
        cost decisions (reference: ConnectorMetadata.getTableStatistics /
        presto-main cost/StatsCalculator). None = unknown."""
        return None

    def column_stats(self, handle: TableHandle) -> Dict[str, Any]:
        """Optional per-column statistics: {column: planner.stats
        .ColStats} (NDV, null fraction, min/max in physical units).
        Missing columns fall back to dictionary-derived NDVs."""
        return {}

    def table_version(self, handle: TableHandle) -> Optional[int]:
        """Monotonic data version of the table, bumped at every commit
        that changes its contents or schema (INSERT/CTAS/DROP). The
        engine's cache hierarchy keys plans, fragment results, and
        scanned pages on (cache token, version) — see presto_tpu/cache.
        None (the default) marks the table VOLATILE or unversioned:
        nothing derived from it is ever cached."""
        return None

    def sorted_by(self, handle: TableHandle) -> Optional[List[str]]:
        """Physical sort order of the table's rows, as column names in
        significance order (ascending, nulls last), or None. A declared
        order promises that every split's batches arrive sorted AND
        that split ranges are ascending — the engine then plans
        StreamingAggregationOperator over the scan (reference:
        ConnectorMetadata local-property declarations feeding
        StreamingAggregationOperator)."""
        return None


class ConnectorSplitManager(abc.ABC):
    """`constraint` is the scan's pushed-down TupleDomain,
    available BEFORE any split exists so connectors can prune whole
    partitions/files (reference: HiveSplitManager partition pruning
    ahead of split enumeration)."""

    @abc.abstractmethod
    def get_splits(self, handle: TableHandle, target_splits: int,
                   constraint: Optional["TupleDomain"] = None
                   ) -> List[Split]: ...


class ConnectorPageSource(abc.ABC):
    """Produces batches for one split (reference:
    spi ConnectorPageSource.java:22). `constraint` is the pushed-down
    TupleDomain (may be ignored — the engine re-applies its filter)."""

    @abc.abstractmethod
    def batches(self, split: Split, columns: Sequence[str],
                batch_rows: int,
                constraint: Optional[TupleDomain] = None,
                device: torch.device = torch.device("cpu")
                ) -> Iterator[Batch]:
        """Batches of the split's rows, on `device`."""


class ConnectorPageSink(abc.ABC):
    """Accepts written batches for one table (reference:
    spi ConnectorPageSink + ConnectorPageSinkProvider; commit protocol
    collapsed to create/append/finish for in-process connectors).
    `abort` drops UNCOMMITTED appends (a write-query retry must not
    duplicate rows — the reference's ConnectorPageSink.abort)."""

    def abort(self, handle: "TableHandle") -> None:
        """Drop buffered UNCOMMITTED appends for the table, keeping
        any created-table marker so a retried write can append again.
        Default no-op suits sinks that do not buffer; every buffering
        sink must override (a missing override would let a write
        retry duplicate rows)."""

    @abc.abstractmethod
    def create_table(self, handle: TableHandle,
                     schema: RelationSchema,
                     properties: Optional[dict] = None) -> None:
        """Stage a new table. `properties` carries the CREATE TABLE
        WITH (...) clause (reference: ConnectorMetadata
        createTable's ConnectorTableMetadata.getProperties) — e.g.
        the file connector's format='orc'/'parquet' and
        partitioned_by=ARRAY['col']. Connectors must REJECT
        properties they do not support (silent drops hide typos)."""

    @abc.abstractmethod
    def append(self, handle: TableHandle, batch: Batch) -> None: ...

    def finish(self, handle: TableHandle) -> None:
        """Commit point (no-op for in-memory connectors)."""

    def drop_table(self, handle: TableHandle) -> None:
        raise NotImplementedError


#: process-wide mint for per-instance cache tokens (never reused,
#: unlike id(); a GC'd connector's token must not alias a new one)
_CACHE_TOKENS = itertools.count()


class Connector(abc.ABC):
    name: str

    def cache_token(self) -> Any:
        """Identity under which this connector's data may be cached
        across runners. The default is a UNIQUE per-instance token, so
        two connector instances never share cache entries even when
        their catalog/schema/table names collide (every LocalRunner
        builds its own MemoryConnector). Connectors whose data is a
        pure function of their configuration (tpch/tpcds generators)
        override this with a stable token to share warmed caches."""
        t = getattr(self, "_cache_token", None)
        if t is None:
            t = self._cache_token = ("conn", next(_CACHE_TOKENS))
        return t

    @property
    @abc.abstractmethod
    def metadata(self) -> ConnectorMetadata: ...

    @property
    @abc.abstractmethod
    def split_manager(self) -> ConnectorSplitManager: ...

    @property
    @abc.abstractmethod
    def page_source(self) -> ConnectorPageSource: ...

    @property
    def page_sink(self) -> Optional[ConnectorPageSink]:
        """None = read-only connector (writes are rejected)."""
        return None
