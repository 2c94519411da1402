"""Batch wire format of the HTTP data plane (reference:
presto_tpu/server/serde.py; PagesSerde in Presto).

Only live rows travel: a batch is compacted (K2 on the card) and read
to pinned host memory once before it is framed.

Layout, byte-identical to the reference's: a 4-byte big-endian header
length, a JSON header (column name, type display name and dictionary
per column, then the array table: numpy dtype string, length, byte
offset), then ONE codec frame holding every column's raw bytes
concatenated (data + mask per column, then row_valid). Each package
decodes the other's pages."""

from __future__ import annotations

import json

import numpy as np

from presto_tpu_torch.batch import Batch, bucket_capacity
from presto_tpu_torch.native import codec
from presto_tpu_torch.native.pages import HostColumn, HostPage, read_to_host


def batch_to_bytes(batch: Batch, assume_compact: bool = False) -> bytes:
    """Frame a batch. `assume_compact`: the caller already packed the
    live rows into a prefix (a host segment), so no count and no
    second compaction."""
    if not assume_compact:
        n = batch.num_valid()
        batch = batch.compact(bucket_capacity(max(n, 1)), known_valid=n)
    return page_to_bytes(HostPage.from_host_batch(to_host_batch(batch)))


def to_host_batch(batch: Batch) -> Batch:
    """The batch with every tensor on the CPU, read with one wait."""
    if batch.device.type == "cpu":
        return batch
    import torch
    names = batch.names
    flat = [t for n in names for t in batch.columns[n].astuple()]
    host = read_to_host(flat + [batch.row_valid])
    from presto_tpu_torch.batch import Column
    cols = {}
    for i, n in enumerate(names):
        c = batch.columns[n]
        cols[n] = Column(torch.from_numpy(host[2 * i]),
                         torch.from_numpy(host[2 * i + 1]), c.type,
                         c.dictionary)
    return Batch(cols, torch.from_numpy(host[-1]))


def page_to_bytes(page: HostPage) -> bytes:
    """Frame one host page: header + ONE codec frame of the
    concatenated column buffers (data + mask per column, then
    row_valid)."""
    parts = []
    columns = []
    arrays = []
    offset = 0

    def add(arr: np.ndarray):
        nonlocal offset
        raw = arr.tobytes()
        arrays.append({"dtype": arr.dtype.str, "n": int(arr.shape[0]),
                       "off": offset})
        parts.append(raw)
        offset += len(raw)

    for name, c in page.columns.items():
        columns.append({
            "name": name, "type": c.type_name,
            "dictionary": list(c.dictionary)
            if c.dictionary is not None else None,
        })
        add(c.data)
        add(c.mask)
    add(page.row_valid)
    header = json.dumps({"columns": columns, "arrays": arrays}).encode()
    frame = codec.encode(b"".join(parts))
    return len(header).to_bytes(4, "big") + header + frame


def batch_from_bytes(data: bytes) -> Batch:
    """Wire frame -> a Batch on the CPU: the consumer's drive thread
    owns the placement on its device."""
    return page_from_bytes(data).to_host_batch()


def page_from_bytes(data: bytes) -> HostPage:
    """Decode one wire frame into a host page (no device I/O)."""
    hlen = int.from_bytes(data[:4], "big")
    header = json.loads(data[4:4 + hlen].decode())
    body = codec.decode(data[4 + hlen:])

    def arr(i: int) -> np.ndarray:
        meta = header["arrays"][i]
        return np.frombuffer(body, np.dtype(meta["dtype"]),
                             count=meta["n"], offset=meta["off"]).copy()

    cols = {}
    for i, meta in enumerate(header["columns"]):
        dic = tuple(meta["dictionary"]) \
            if meta["dictionary"] is not None else None
        cols[meta["name"]] = HostColumn(arr(2 * i), arr(2 * i + 1),
                                        meta["type"], dic)
    return HostPage(cols, arr(2 * len(header["columns"])))
