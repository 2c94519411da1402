"""Query runners (reference: presto_tpu/runner; testing/LocalQueryRunner.java:236,
DistributedQueryRunner.java:85)."""

from presto_tpu_torch.runner.local import (  # noqa: F401
    LocalRunner, MaterializedResult, QueryError, Session,
)
from presto_tpu_torch.runner.mesh import MeshRunner  # noqa: F401
