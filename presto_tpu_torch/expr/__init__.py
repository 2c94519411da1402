"""Expression layer: RowExpression IR compiled to functions over torch
tensors (reference: presto_tpu/expr)."""

from presto_tpu_torch.expr.ir import (  # noqa: F401
    RowExpression, Literal, InputRef, Call, SpecialForm, lit, ref, call,
)
from presto_tpu_torch.expr.compile import (  # noqa: F401
    compile_expression, fold_constants,
)
