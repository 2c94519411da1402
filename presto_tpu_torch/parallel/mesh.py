"""The worker set of the distributed path (reference:
presto_tpu/parallel/mesh.py, where the "cluster" is a
jax.sharding.Mesh over TPU chips).

The port's `Mesh` is a list of W worker devices, one per logical
worker, all driven by one process. The default width is one worker per
visible card, the reference's "all devices". Several workers may share
one card (`make_mesh(8)` puts eight on `cuda:0`): the exchange between
them is then K18, which writes every row straight into its consumer's
batch on that card. A mesh whose workers span several cards needs a
transport between cards (one process per card and NCCL
`all_to_all_single`, ROADMAP A17); until it exists such a mesh raises
`MeshSpansCardsError` and never falls back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

#: name of the worker axis (the reference's mesh axis)
worker_axis = "workers"

DeviceLike = Union[None, str, torch.device]


class MeshSpansCardsError(RuntimeError):
    """The mesh's workers lie on more than one card."""


@dataclasses.dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The one device every worker of the mesh runs on."""
        return self.devices[0]


def make_mesh(n_workers: Optional[int] = None,
              device: DeviceLike = None) -> Mesh:
    """A mesh of `n_workers` workers on `device` (CUDA when None; the
    tests pass "cpu"). Without `n_workers` on CUDA, one worker per
    visible card."""
    if n_workers is not None and n_workers < 1:
        raise ValueError("a mesh needs at least one worker")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and n_workers is None \
            and torch.cuda.is_available():
        devices = tuple(torch.device("cuda", i)
                        for i in range(torch.cuda.device_count()))
    else:
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        devices = (dev,) * (n_workers or 1)
    if len(set(devices)) > 1:
        raise MeshSpansCardsError(
            f"the mesh's workers span {len(set(devices))} devices "
            f"({', '.join(sorted(map(str, set(devices))))}); the port "
            "moves rows only between workers of one card. A mesh across "
            "cards needs the cross-card transport (one process per card "
            "with NCCL all_to_all_single), ROADMAP A17")
    if devices[0].type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "presto_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain CPU versions explicitly")
    return Mesh(devices)
