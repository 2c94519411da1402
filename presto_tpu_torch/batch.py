"""Columnar batch data model (reference: presto_tpu/batch.py; presto-common
Page.java:33, block/Block.java:24).

A `Batch` is the unit of data flow between operators: every column is
a fixed-`capacity` tensor plus a validity mask, and row liveness is a
separate `row_valid` mask, so a filter just ANDs into it. VARCHAR
columns hold int32 dictionary codes; the sorted dictionary lives on
the host in the column's static metadata.

All tensors of a batch live on one device (`Batch.device`). The
capacity ladder is kept from the reference so operators size their
shapes the same way, although eager PyTorch has no compile cache to
protect: the JAX package pads every kernel input up to the coarse
ladder (`pad_for_kernel`) only to bound XLA recompiles, and the port
does not pad.

`compact` is kernel K2 (csrc/compact.cu): on a CUDA batch it launches
the hand-written kernel, on a CPU batch it runs the plain version
below. There is no fallback from one to the other.
"""

from __future__ import annotations

import array
import dataclasses
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from presto_tpu_torch.native import pages
from presto_tpu_torch.telemetry import kernels as _tk
from presto_tpu_torch.types import Type

MIN_CAPACITY = 16
#: Default target rows per batch fed to kernels (like Presto's ~1MB pages).
DEFAULT_BATCH_ROWS = 64 * 1024

#: Outputs at or under this capacity skip the deferred count/compact
#: round entirely — the padding is too small to matter downstream.
COMPACT_FLOOR = 8192


def quantized_capacity(n: int) -> int:
    """Power-of-FOUR capacity ladder with a 4096 floor."""
    cap = 4096
    while cap < n:
        cap *= 4
    return cap


def bucket_capacity(n: int) -> int:
    """Round up to a power of two (>= MIN_CAPACITY)."""
    cap = MIN_CAPACITY
    while cap < n:
        cap *= 2
    return cap


def operator_capacity(n: int) -> int:
    """Capacity for operator-built shapes (sort concats, compaction
    targets): the power-of-four ladder, the reference's default
    (`kernel_shape_buckets` on)."""
    return quantized_capacity(max(int(n), 1))


@dataclasses.dataclass
class Column:
    """One column: data + validity mask, plus static type/dictionary
    metadata. `dictionary` is set only for string types: a sorted tuple
    of distinct values such that `data` holds indices into it."""

    data: torch.Tensor
    mask: torch.Tensor  # bool, True = value present (not NULL)
    type: Type
    dictionary: Optional[Tuple[str, ...]] = None

    @property
    def capacity(self) -> int:
        return int(self.data.shape[0])

    def astuple(self):
        return (self.data, self.mask)

    @classmethod
    def from_numpy(cls, values: np.ndarray, mask: Optional[np.ndarray],
                   typ: Type, capacity: int,
                   dictionary: Optional[Tuple[str, ...]] = None,
                   device: torch.device = torch.device("cpu")) -> "Column":
        data, m = pages.pad_to_capacity(values, mask, capacity,
                                        typ.np_dtype)
        return cls(pages.to_device(data, device),
                   pages.to_device(m, device), typ, dictionary)

    @classmethod
    def from_pylist(cls, values: Sequence[Any], typ: Type,
                    capacity: Optional[int] = None,
                    device: torch.device = torch.device("cpu")
                    ) -> "Column":
        """Build from python values; None means NULL. Strings are
        dictionary-encoded here (sorted so codes preserve collation)."""
        n = len(values)
        capacity = capacity or bucket_capacity(n)
        mask = np.array([v is not None for v in values], dtype=bool)
        if typ.is_string:
            present = sorted({v for v in values if v is not None})
            index = {v: i for i, v in enumerate(present)}
            data = np.array([index[v] if v is not None else 0
                             for v in values], dtype=np.int32)
            return cls.from_numpy(data, mask, typ, capacity,
                                  tuple(present), device)
        if typ.is_decimal:
            data = np.array(
                [_to_unscaled(v, typ.scale) if v is not None else 0
                 for v in values], dtype=np.int64)
            return cls.from_numpy(data, mask, typ, capacity,
                                  device=device)
        data = np.array([v if v is not None else 0 for v in values],
                        dtype=typ.np_dtype)
        return cls.from_numpy(data, mask, typ, capacity, device=device)

    def to_pylist(self, row_valid: Optional[np.ndarray] = None,
                  _data: Optional[np.ndarray] = None,
                  _mask: Optional[np.ndarray] = None) -> List[Any]:
        data = pages.to_host(self.data) if _data is None else _data
        mask = pages.to_host(self.mask) if _mask is None else _mask
        rows = range(self.capacity) if row_valid is None \
            else np.nonzero(row_valid)[0]
        out: List[Any] = []
        for i in rows:
            if not mask[i]:
                out.append(None)
            elif self.dictionary is not None:
                out.append(self.dictionary[int(data[i])])
            elif self.type.is_decimal:
                out.append(int(data[i]) / (10 ** self.type.scale))
            elif self.type.name == "boolean":
                out.append(bool(data[i]))
            elif self.type.is_floating:
                out.append(float(data[i]))
            else:
                out.append(int(data[i]))
        return out


@dataclasses.dataclass
class Batch:
    """An ordered set of named columns sharing `row_valid` (cf.
    Page.java:33). All columns and row_valid share one capacity and
    one device; column order is the dict insertion order."""

    columns: Dict[str, Column]
    row_valid: torch.Tensor  # bool[capacity]

    @property
    def capacity(self) -> int:
        return int(self.row_valid.shape[0])

    @property
    def device(self) -> torch.device:
        return self.row_valid.device

    @property
    def names(self) -> List[str]:
        return list(self.columns.keys())

    def column(self, name: str) -> Column:
        return self.columns[name]

    def num_valid(self) -> int:
        """Host-syncing count of live rows (Presto's positionCount)."""
        return int(self.row_valid.sum())

    # -- construction ------------------------------------------------------

    @classmethod
    def from_pydict(cls, data: Dict[str, Tuple[Sequence[Any], Type]],
                    capacity: Optional[int] = None,
                    device: torch.device = torch.device("cpu")
                    ) -> "Batch":
        lengths = {len(v) for v, _ in data.values()}
        if len(lengths) != 1:
            raise ValueError("all columns must have equal length")
        n = lengths.pop()
        capacity = capacity or bucket_capacity(n)
        cols = {name: Column.from_pylist(vals, typ, capacity, device)
                for name, (vals, typ) in data.items()}
        rv = np.zeros(capacity, dtype=bool)
        rv[:n] = True
        return cls(cols, pages.to_device(rv, device))

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray],
                   types: Dict[str, Type],
                   masks: Optional[Dict[str, np.ndarray]] = None,
                   dictionaries: Optional[Dict[str, Tuple[str, ...]]] = None,
                   capacity: Optional[int] = None,
                   device: torch.device = torch.device("cpu")) -> "Batch":
        n = len(next(iter(arrays.values())))
        capacity = capacity or bucket_capacity(n)
        cols = {}
        for name, arr in arrays.items():
            mask = masks.get(name) if masks else None
            dic = dictionaries.get(name) if dictionaries else None
            cols[name] = Column.from_numpy(arr, mask, types[name],
                                           capacity, dic, device)
        rv = np.zeros(capacity, dtype=bool)
        rv[:n] = True
        return cls(cols, pages.to_device(rv, device))

    # -- host-side materialization ----------------------------------------

    def to_pydict(self) -> Dict[str, List[Any]]:
        host = [(pages.to_host(c.data), pages.to_host(c.mask))
                for c in self.columns.values()]
        rv = pages.to_host(self.row_valid)
        return {name: col.to_pylist(rv, _data=d, _mask=m)
                for (name, col), (d, m) in zip(self.columns.items(),
                                               host)}

    def to_pylist(self) -> List[Tuple[Any, ...]]:
        d = self.to_pydict()
        if not d:
            return [()] * self.num_valid()
        return list(zip(*d.values()))

    # -- transformations ---------------------------------------------------

    def with_columns(self, columns: Dict[str, Column]) -> "Batch":
        return Batch(columns, self.row_valid)

    def select(self, names: Sequence[str]) -> "Batch":
        return Batch({n: self.columns[n] for n in names}, self.row_valid)

    def rename(self, mapping: Dict[str, str]) -> "Batch":
        return Batch({mapping.get(n, n): c for n, c in self.columns.items()},
                     self.row_valid)

    def filter(self, keep: torch.Tensor) -> "Batch":
        """Selection-vector filter: just narrows row_valid."""
        return Batch(self.columns, self.row_valid & keep)

    def compact(self, capacity: Optional[int] = None,
                known_valid: Optional[int] = None) -> "Batch":
        """Pack live rows to the front; optionally resize to `capacity`.
        Shrinking needs the live count on the host — pass `known_valid`
        when the caller already has it to avoid a blocking read."""
        if capacity is not None and capacity < self.capacity:
            n = known_valid if known_valid is not None \
                else self.num_valid()
            if n > capacity:
                raise ValueError(f"compact overflow: {n} > {capacity}")
            return compact_shrink(self, capacity)
        out = compact_full(self)
        if capacity is None or capacity == self.capacity:
            return out
        return pad_batch(out, capacity - self.capacity)

    @staticmethod
    def concat(batches: Sequence["Batch"], capacity: int,
               live_rows: Optional[int] = None) -> "Batch":
        """Concatenate live rows of compatible batches into one batch,
        device-side: concat every (padded) batch, then compact live rows
        to the front."""
        if not batches:
            raise ValueError("concat of no batches")
        names = batches[0].names
        first = batches[0]
        dics = {n: first.columns[n].dictionary for n in names}
        for b in batches:
            for n in names:
                if b.columns[n].dictionary != dics[n]:
                    raise ValueError(
                        f"concat with mismatched dictionaries on {n!r}; "
                        "unify dictionaries first")
        total_cap = sum(b.capacity for b in batches)
        cols: Dict[str, Column] = {}
        for n in names:
            cols[n] = Column(
                torch.cat([b.columns[n].data for b in batches]),
                torch.cat([b.columns[n].mask for b in batches]),
                first.columns[n].type, dics[n])
        big = Batch(cols, torch.cat([b.row_valid for b in batches]))
        if total_cap == capacity:
            return compact_full(big)
        return big.compact(capacity, known_valid=live_rows)


def empty_batch(schema_cols: Sequence[Tuple], device: torch.device,
                capacity: int = MIN_CAPACITY) -> Batch:
    """An all-dead batch of a (name, type, dictionary) schema: the
    stand-in when a source yields no batch (an empty join build)."""
    cols = {name: Column(torch.zeros(capacity, dtype=t.torch_dtype,
                                     device=device),
                         torch.zeros(capacity, dtype=torch.bool,
                                     device=device), t, dic)
            for name, t, dic in schema_cols}
    return Batch(cols, torch.zeros(capacity, dtype=torch.bool,
                                   device=device))


def pad_batch(batch: Batch, pad: int) -> Batch:
    """Append `pad` dead lanes (mask False, row_valid False, data 0)."""
    if pad == 0:
        return batch

    def ext(t):
        return torch.cat([t, t.new_zeros(pad)])
    cols = {n: Column(ext(c.data), ext(c.mask), c.type, c.dictionary)
            for n, c in batch.columns.items()}
    return Batch(cols, ext(batch.row_valid))


# -- K2: compaction ----------------------------------------------------


#: launches of the CUDA compaction kernel (csrc/compact.cu)
COMPACT_KERNEL = _tk.LaunchCounter("compact")


def compact_full_plain(batch: Batch) -> Batch:
    """Plain version of the full compaction: the stable live-rows-first
    permutation (ops/common.partition_perm) gathered into every column
    (the reference's `_compact_jit`)."""
    from presto_tpu_torch.ops.common import partition_perm
    order = partition_perm(batch.row_valid)
    rv = batch.row_valid[order]
    cols = {n: Column(c.data[order], c.mask[order] & rv, c.type,
                      c.dictionary)
            for n, c in batch.columns.items()}
    return Batch(cols, rv)


def compact_shrink_plain(batch: Batch, capacity: int) -> Batch:
    """Plain version of the shrink: the first `capacity` live rows; the
    slots past the live count take the last input row, masked off (the
    reference's `_compact_shrink_jit`: nonzero(size=capacity,
    fill_value=cap-1))."""
    idx = torch.nonzero(batch.row_valid).flatten()[:capacity]
    nlive = int(idx.shape[0])
    fill = idx.new_full((capacity - nlive,), batch.capacity - 1)
    idx = torch.cat([idx, fill])
    live = torch.arange(capacity, device=batch.device) < nlive
    cols = {n: Column(c.data[idx], c.mask[idx] & live, c.type,
                      c.dictionary)
            for n, c in batch.columns.items()}
    return Batch(cols, live)


#: most columns one K2 launch moves (csrc/compact.cu MAX_COLS)
COMPACT_MAX_COLS = 64
#: most rows one K2 call takes: its look-back counts are 32-bit
COMPACT_MAX_ROWS = (1 << 31) - 1


@functools.lru_cache(maxsize=4)
def _compact_tile(lib) -> int:
    """Rows of a K2 tile (the loaded library's TILE), read once."""
    return lib.presto_compact_tile()


@functools.lru_cache(maxsize=256)
def compact_layout(widths: Tuple[int, ...], cap: int):
    """K2's one output allocation for columns of element sizes
    `widths`: every column's data, then every column's mask, then
    row_valid, each at a 16-byte aligned offset. Returns (bytes, data
    offsets, mask offsets, row_valid's offset)."""
    at, data = 0, []
    for w in widths:
        data.append(at)
        at += 16 * -(-(w * cap) // 16)
    step = 16 * -(-cap // 16)
    masks = tuple(at + i * step for i in range(len(widths)))
    at += step * len(widths)
    return at + step, tuple(data), masks, at


def _compact_cuda(batch: Batch, out_cap: int, shrink: bool) -> Batch:
    """Launch csrc/compact.cu: one launch for up to COMPACT_MAX_COLS
    columns (an array's slot columns past them take further launches,
    each computing the same destinations); every output column, mask
    and row_valid a view of one allocation. Contiguous 1-D columns of
    1/2/4/8-byte dtypes with bool masks only; anything else raises."""
    from presto_tpu_torch.native import cuda
    from presto_tpu_torch.ops import common
    rv = batch.row_valid
    n = rv.numel()
    cols = list(batch.columns.items())
    if not 1 <= n <= COMPACT_MAX_ROWS:
        raise ValueError(f"compact kernel: {n} rows; it takes 1 to "
                         f"{COMPACT_MAX_ROWS}")
    widths = tuple(c.data.element_size() for _, c in cols)
    dev = rv.get_device()
    ok = rv.dtype is torch.bool and rv.dim() == 1 and rv.is_contiguous() \
        and all(w in (1, 2, 4, 8) for w in widths)
    for _, c in cols:
        d, m = c.data, c.mask
        ok = ok and d.dim() == 1 and d.numel() == n and d.is_contiguous() \
            and d.get_device() == dev and m.dtype is torch.bool \
            and m.dim() == 1 and m.numel() == n and m.is_contiguous() \
            and m.get_device() == dev
    if not ok:
        raise ValueError(
            "compact kernel: every column and mask must be a contiguous "
            f"1-D tensor of {n} rows on {rv.device} (1/2/4/8-byte data, "
            "bool masks)")
    size, doffs, moffs, voff = compact_layout(widths, out_cap)
    buf = torch.empty(size, dtype=torch.uint8, device=rv.device)
    base = buf.data_ptr()
    lib = cuda.library("compact")
    stream = cuda.stream_ptr(rv.device)
    tile = _compact_tile(lib)
    tiles = -(-n // tile)
    # a look-back word a row tile and a flag a tail (a row tile's dead
    # rows, or a tile of fill slots)
    words = tiles + (-(-out_cap // tile) if shrink else tiles)
    for lo in range(0, max(len(cols), 1), COMPACT_MAX_COLS):
        run = range(lo, min(lo + COMPACT_MAX_COLS, len(cols)))
        desc = array.array("q", (rv.data_ptr(),
                                 base + voff if lo == 0 else 0))
        for i in run:
            c = cols[i][1]
            desc.extend((c.data.data_ptr(), c.mask.data_ptr(),
                         base + doffs[i], base + moffs[i], widths[i]))
        with common.LOOKBACK_LOCK:
            ticket, status, epoch = common.lookback_scratch(
                rv.device, stream, words)
            code = lib.presto_compact(
                desc.buffer_info()[0], len(run), n, out_cap, int(shrink),
                ticket.data_ptr(), status.data_ptr(), status.shape[0],
                epoch, stream)
        cuda.check(lib, code, "compact")
        COMPACT_KERNEL.launches += 1
    # one view of the allocation a dtype, sliced a column
    typed = {torch.bool: buf.view(torch.bool)}
    bools = typed[torch.bool]
    out = {}
    for (name, c), w, doff, moff in zip(cols, widths, doffs, moffs):
        dt = c.data.dtype
        whole = typed.get(dt)
        if whole is None:
            whole = typed[dt] = buf.view(dt)
        out[name] = Column(whole[doff // w:doff // w + out_cap],
                           bools[moff:moff + out_cap], c.type,
                           c.dictionary)
    return Batch(out, bools[voff:voff + out_cap])


def compact_full(batch: Batch) -> Batch:
    """Live rows first, in order, then dead rows in order (same
    capacity). K2 on CUDA, the plain version on the CPU."""
    _tk.count("compact")
    if batch.device.type == "cpu":
        return compact_full_plain(batch)
    return _compact_cuda(batch, batch.capacity, shrink=False)


def compact_shrink(batch: Batch, capacity: int) -> Batch:
    """The first `capacity` live rows (the caller guarantees the live
    count fits). K2 on CUDA, the plain version on the CPU."""
    _tk.count("compact")
    if batch.device.type == "cpu":
        return compact_shrink_plain(batch, capacity)
    return _compact_cuda(batch, capacity, shrink=True)


# -- the one-round-delayed compaction protocol -------------------------


def begin_deferred_compact(batch: Batch,
                           total: Optional[torch.Tensor] = None):
    """Start the one-round-delayed compaction protocol on a selective
    operator's output: start the copy of the live count to the host
    NOW, so that when the batch is emitted one driver round later
    `end_deferred_compact` shrinks it without a blocking round trip.
    `total` is the live count when a kernel already computed it on the
    device. Returns (batch, pending count) — None when the batch is
    already small."""
    if batch.capacity <= COMPACT_FLOOR:
        return batch, None
    return batch, pages.PendingScalar(
        batch.row_valid.sum() if total is None else total)


def end_deferred_compact(batch: Batch, total) -> Batch:
    """Consume the count started by begin_deferred_compact and pack the
    batch down to its live bucket."""
    if total is None:
        return batch
    n = total.get()
    cap = operator_capacity(n)
    if cap < batch.capacity:
        return batch.compact(cap, known_valid=n)
    return batch


# -- dictionaries --------------------------------------------------------


def _remap(col: Column, dic: Tuple[str, ...]) -> Column:
    index = {v: i for i, v in enumerate(dic)}
    remap = torch.tensor([index[v] for v in col.dictionary] or [0],
                         dtype=torch.int32, device=col.data.device)
    return Column(remap[col.data.long()], col.mask, col.type, dic)


def unify_dictionaries(cols: Sequence[Column]) -> List[Column]:
    """Re-encode string columns onto a shared sorted dictionary so their
    codes are directly comparable. Host-side dictionary work plus one
    device gather per column."""
    for c in cols:
        if c.dictionary is None:
            raise ValueError(
                "unify_dictionaries: string column without a dictionary")
    dic = tuple(sorted(set().union(*[set(c.dictionary) for c in cols])))
    return [Column(c.data, c.mask, c.type, dic) if c.dictionary == dic
            else _remap(c, dic) for c in cols]


def union_dictionary(a: Optional[Tuple[str, ...]],
                     b: Optional[Tuple[str, ...]]) -> Tuple[str, ...]:
    """The union dictionary two string join-key sides re-encode onto
    (sorted, so code order = string order)."""
    return tuple(sorted(set(a or ()) | set(b or ())))


def remap_column(col: Column, target: Tuple[str, ...]) -> Column:
    """Re-encode a string column onto `target` (a superset dictionary,
    sorted)."""
    if col.dictionary == target:
        return col
    if col.dictionary is None:
        raise ValueError("remap_column: column has no dictionary")
    return _remap(col, target)


def _to_unscaled(v, scale: int) -> int:
    """Exact decimal encoding: ints and Decimals never pass through float."""
    import decimal as _dec
    if isinstance(v, bool):
        raise TypeError("boolean is not a decimal value")
    if isinstance(v, int):
        return v * (10 ** scale)
    if isinstance(v, _dec.Decimal):
        return int((v * (10 ** scale)).to_integral_value(
            rounding=_dec.ROUND_HALF_UP))
    return int(round(float(v) * (10 ** scale)))
