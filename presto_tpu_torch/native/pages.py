"""The host<->device doorway (the transfer half of
presto_tpu/native/pages.py; the wire/Arrow host page comes with the
exchange slice of the port).

Host->device copies go through pinned staging buffers with
`non_blocking=True`, so a scan's next batch uploads while the device
still runs the previous one. `to_host` is the engine's one blocking
read; `PendingScalar` is the one-round-delayed read of a device scalar
(the reference's `start_async_copy` + later `to_host`).
"""

from __future__ import annotations

from typing import Optional, Tuple

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
