"""Mesh-parallel execution (reference: presto_tpu/parallel/): the
worker set of the distributed path and the hash repartition between
its workers. The port's mesh is W logical workers in one process; all
of them on one card move rows between each other with K18
(csrc/exchange_shuffle.cu) instead of an all_to_all."""

from presto_tpu_torch.parallel.mesh import (
    Mesh, MeshSpansCardsError, make_mesh,
)
