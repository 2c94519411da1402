"""Query runners (reference: presto_tpu/runner; testing/LocalQueryRunner.java:236)."""

from presto_tpu_torch.runner.local import (  # noqa: F401
    LocalRunner, MaterializedResult, QueryError, Session,
)
