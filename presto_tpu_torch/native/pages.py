"""The host<->device doorway and the host page (reference:
presto_tpu/native/pages.py; the Arrow half comes with ROADMAP A9).

Host->device copies go through pinned staging buffers with
`non_blocking=True`, so a scan's next batch uploads while the device
still runs the previous one. `to_host` is the engine's one blocking
read; `PendingScalar` is the one-round-delayed read of a device scalar
(the reference's `start_async_copy` + later `to_host`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch


def pad_to_capacity(values: np.ndarray, mask: Optional[np.ndarray],
                    capacity: int, dtype) -> Tuple[np.ndarray,
                                                   np.ndarray]:
    """The one place host lanes are padded to a capacity bucket: value
    lanes zero-filled past n, mask False past n."""
    n = len(values)
    if n > capacity:
        raise ValueError(f"pad_to_capacity: {n} rows > capacity "
                         f"{capacity}")
    data = np.zeros(capacity, dtype=dtype)
    data[:n] = values
    m = np.zeros(capacity, dtype=bool)
    m[:n] = True if mask is None else mask
    return data, m


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host buffer -> tensor on `device`. On a CUDA device the buffer
    is staged in pinned memory and copied without blocking the host;
    the pinned stage stays alive until the copy finishes because the
    caching host allocator records the copy's stream."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cpu":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def to_host(x: torch.Tensor) -> np.ndarray:
    """Tensor -> host numpy buffer; blocks until the device has
    produced it."""
    return x.detach().cpu().numpy()


class PendingScalar:
    """A device scalar whose copy to the host starts now and is read
    later. On a CUDA tensor: a pinned host tensor, a `non_blocking`
    copy on the current stream and an event recorded after it; `get`
    waits on that event only, so when the driver reads it one round
    later the value is normally already there and the read does not
    drain the stream. On a CPU tensor the value is read directly."""

    def __init__(self, x: torch.Tensor):
        if x.device.type == "cpu":
            self._host = x
            self._event = None
            return
        self._host = torch.empty((), dtype=x.dtype, pin_memory=True)
        self._host.copy_(x, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record()

    def ready(self) -> bool:
        """True once the copy has landed (never blocks)."""
        return self._event is None or self._event.query()

    def get(self) -> int:
        if self._event is not None:
            self._event.synchronize()
        return int(self._host)


def read_to_host(tensors) -> list:
    """Device tensors -> host numpy arrays with ONE wait: every copy
    lands in pinned memory without blocking the host, then the stream
    is synchronized once. CPU tensors come back as views."""
    out, dev = [], None
    for t in tensors:
        if t.device.type == "cpu":
            out.append(t)
            continue
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        out.append(h)
        dev = t.device
    if dev is not None:
        torch.cuda.current_stream(dev).synchronize()
    return [t.numpy() for t in out]


# -- the page ----------------------------------------------------------------


@dataclasses.dataclass
class HostColumn:
    """One column's host buffers (reference: presto_tpu/native/pages.py
    :141): `data` (numeric lanes or int32 dictionary codes), `mask`
    (True = present), the type's display name and, for varchar, the
    sorted dictionary."""

    data: np.ndarray
    mask: np.ndarray
    type_name: str
    dictionary: Optional[Tuple[str, ...]] = None

    @property
    def nbytes(self) -> int:
        return int(self.data.nbytes + self.mask.nbytes)


@dataclasses.dataclass
class HostPage:
    """Named host columns + the shared row_valid lane mask (reference:
    presto_tpu/native/pages.py:157). The Arrow and dlpack halves wait
    for ROADMAP A9."""

    columns: Dict[str, HostColumn]
    row_valid: np.ndarray

    @property
    def capacity(self) -> int:
        return int(self.row_valid.shape[0])

    @property
    def nbytes(self) -> int:
        return int(sum(c.nbytes for c in self.columns.values())
                   + self.row_valid.nbytes)

    @classmethod
    def from_host_batch(cls, host) -> "HostPage":
        """From a Batch whose tensors lie on the CPU (the serde encode
        side). Buffers are shared, not copied."""
        cols = {}
        for name, c in host.columns.items():
            cols[name] = HostColumn(
                np.ascontiguousarray(_np(c.data)),
                np.ascontiguousarray(_np(c.mask)),
                c.type.display(), c.dictionary)
        return cls(cols, np.ascontiguousarray(_np(host.row_valid)))

    def to_host_batch(self):
        """The engine Batch over the page's buffers, on the CPU: the
        exchange consumer path, where the task's drive thread places it
        on its device."""
        from presto_tpu_torch.batch import Batch, Column
        from presto_tpu_torch.types import parse_type
        cols = {}
        for name, c in self.columns.items():
            cols[name] = Column(torch.from_numpy(c.data),
                                torch.from_numpy(c.mask),
                                parse_type(c.type_name), c.dictionary)
        return Batch(cols, torch.from_numpy(self.row_valid))


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
