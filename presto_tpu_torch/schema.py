"""Relation schemas: the static (compile-time) metadata about columns.

Dictionaries for VARCHAR columns are part of the static schema: connectors
declare them at plan time (tpch data is generated from known value sets),
and projections propagate/derive them, so every compiled kernel knows the
code<->string mapping without touching device data.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from presto_tpu_torch.types import Type


@dataclasses.dataclass(frozen=True)
class ColumnSchema:
    name: str
    type: Type
    dictionary: Optional[Tuple[str, ...]] = None  # sorted, for string types
    #: complex-typed columns (array/map): the value form over
    #: InputRefs to the STORED physical column names
    #: (<name>__a{j} + <name>__len — see nodes.Field.form); such a
    #: column has no single physical column of its own
    form: Optional[object] = None

    def physical(self) -> list:
        """[(stored name, type, dictionary)] — one entry for plain
        columns, the slot columns for form columns."""
        if self.form is None:
            return [(self.name, self.type, self.dictionary)]
        from presto_tpu_torch.planner.nodes import form_leaves
        from presto_tpu_torch.expr.ir import InputRef
        return [(x.name, x.type,
                 self.dictionary if x.type.is_string else None)
                for x in form_leaves(self.form)
                if isinstance(x, InputRef)]


@dataclasses.dataclass(frozen=True)
class RelationSchema:
    columns: Tuple[ColumnSchema, ...]

    @property
    def names(self):
        return [c.name for c in self.columns]

    def column(self, name: str) -> ColumnSchema:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)

    def __contains__(self, name: str) -> bool:
        return any(c.name == name for c in self.columns)

    @staticmethod
    def of(*cols: ColumnSchema) -> "RelationSchema":
        return RelationSchema(tuple(cols))
