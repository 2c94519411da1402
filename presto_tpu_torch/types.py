"""SQL type system.

Reference surface: presto-common `common/type/` (71 type files; SURVEY.md L0).
We keep the same logical types but map each onto a fixed-width device dtype:

- BIGINT/INTEGER/SMALLINT/TINYINT -> int64/int32/int16/int8
- DOUBLE/REAL                     -> float64/float32
- BOOLEAN                         -> bool
- DATE                            -> int32 (days since 1970-01-01)
- TIMESTAMP                       -> int64 (milliseconds since epoch)
- DECIMAL(p<=18, s)               -> int64 scaled by 10**s (exact arithmetic)
- VARCHAR/CHAR                    -> int32 dictionary codes; the dictionary
                                     (tuple of python strings) lives host-side
                                     on `batch.Column.dictionary` — the device
                                     only ever sees integer codes.

NULL is carried out-of-band as a validity mask per column (True = valid),
mirroring Presto's per-Block null flags (block/Block.java:24) but as a
separate mask array so kernels stay branch-free.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Type:
    """A SQL logical type. Immutable and hashable (used as static jit aux)."""

    name: str

    @property
    def np_dtype(self) -> np.dtype:
        return _NP_DTYPES[self.name]

    @property
    def torch_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.np_dtype]

    @property
    def is_string(self) -> bool:
        return self.name in ("varchar", "char")

    @property
    def is_integer(self) -> bool:
        return self.name in ("bigint", "integer", "smallint", "tinyint")

    @property
    def is_floating(self) -> bool:
        return self.name in ("double", "real")

    @property
    def is_decimal(self) -> bool:
        return isinstance(self, DecimalType)

    @property
    def is_array(self) -> bool:
        return False

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_floating or self.is_decimal

    @property
    def is_orderable(self) -> bool:
        return self.name != "unknown"

    def __repr__(self) -> str:
        return self.name

    def display(self) -> str:
        return self.name


@dataclasses.dataclass(frozen=True, repr=False)
class DecimalType(Type):
    """DECIMAL(precision, scale) stored as int64 scaled by 10**scale.

    Exact for precision <= 18 (reference: common/type/DecimalType; long
    decimals >18 digits are not yet supported — gated at analysis time).
    """

    precision: int = 38
    scale: int = 0

    def __repr__(self) -> str:
        return f"decimal({self.precision},{self.scale})"

    def display(self) -> str:
        return repr(self)


@dataclasses.dataclass(frozen=True, repr=False)
class ArrayType(Type):
    """ARRAY(element) stored FIXED-WIDTH on device: data [cap, W],
    per-element mask [cap, W] (False past each row's length), where W
    is a per-batch static width — the array analog of the power-of-two
    capacity bucket. Dense 2-D blocks are the TPU-native layout (no
    ragged offsets on device); W is chosen statically at construction
    (constructor arity, dictionary-derived split width, or the bounded
    array_agg cap). Reference: common/type/ArrayType.java (offsets +
    child block) re-shaped for static-shape XLA."""

    element: Type = None

    @property
    def np_dtype(self) -> np.dtype:
        return self.element.np_dtype

    @property
    def is_array(self) -> bool:
        return True

    def __repr__(self) -> str:
        return f"array({self.element!r})"

    def display(self) -> str:
        return f"array({self.element.display()})"


def array_type(element: Type) -> ArrayType:
    return ArrayType("array", element)


@dataclasses.dataclass(frozen=True, repr=False)
class MapType(Type):
    """MAP(key, value) as an ANALYSIS-TIME value form: parallel
    fixed-width key/value expression lists (expr/ir.MapValue), lowered
    to scalar IR by every consumer — the map analog of the fixed-width
    ArrayType. Reference: common/type/MapType.java."""

    key: Type = None
    value: Type = None

    def __repr__(self) -> str:
        return f"map({self.key!r}, {self.value!r})"

    def display(self) -> str:
        return f"map({self.key.display()}, {self.value.display()})"


def map_type(key: Type, value: Type) -> MapType:
    return MapType("map", key, value)


@dataclasses.dataclass(frozen=True, repr=False)
class RowType(Type):
    """ROW(name type, ...) as an ANALYSIS-TIME value form
    (expr/ir.RowValue): named field expressions, consumed by field
    subscripts. Reference: common/type/RowType.java."""

    field_names: tuple = ()
    field_types: tuple = ()

    def __repr__(self) -> str:
        inner = ", ".join(f"{n} {t!r}" for n, t in
                          zip(self.field_names, self.field_types))
        return f"row({inner})"

    def display(self) -> str:
        return repr(self)


def row_type(fields) -> RowType:
    names = tuple(n for n, _ in fields)
    types = tuple(t for _, t in fields)
    return RowType("row", names, types)


def decimal_type(precision: int, scale: int) -> DecimalType:
    """We carry at most 18 digits exactly in int64. When a derived type
    (e.g. from common_super_type) exceeds that, preserve integer digits by
    dropping scale — the standard overflow behavior — rather than silently
    shrinking the integer range."""
    if precision > 18:
        excess = precision - 18
        scale = max(0, scale - excess)
        precision = 18
    return DecimalType("decimal", precision, scale)


BIGINT = Type("bigint")
INTEGER = Type("integer")
SMALLINT = Type("smallint")
TINYINT = Type("tinyint")
DOUBLE = Type("double")
REAL = Type("real")
BOOLEAN = Type("boolean")
VARCHAR = Type("varchar")
CHAR = Type("char")
DATE = Type("date")
TIMESTAMP = Type("timestamp")
INTERVAL_DAY = Type("interval_day")  # stored as int64 milliseconds
INTERVAL_YEAR = Type("interval_year")  # stored as int64 months
UNKNOWN = Type("unknown")  # the type of a bare NULL literal

_NP_DTYPES = {
    "bigint": np.dtype(np.int64),
    "integer": np.dtype(np.int32),
    "smallint": np.dtype(np.int16),
    "tinyint": np.dtype(np.int8),
    "double": np.dtype(np.float64),
    "real": np.dtype(np.float32),
    "boolean": np.dtype(np.bool_),
    "varchar": np.dtype(np.int32),
    "char": np.dtype(np.int32),
    "date": np.dtype(np.int32),
    "timestamp": np.dtype(np.int64),
    "interval_day": np.dtype(np.int64),
    "interval_year": np.dtype(np.int64),
    "decimal": np.dtype(np.int64),
    "unknown": np.dtype(np.int8),
}

_TORCH_DTYPES = {
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.bool_): torch.bool,
}

_BY_NAME = {
    t.name: t
    for t in (BIGINT, INTEGER, SMALLINT, TINYINT, DOUBLE, REAL, BOOLEAN,
              VARCHAR, CHAR, DATE, TIMESTAMP, UNKNOWN)
}


def parse_type(text: str) -> Type:
    """Parse a type name as it appears in SQL (`CAST(x AS type)` etc.)."""
    t = text.strip().lower()
    if t.startswith("decimal"):
        inner = t[len("decimal"):].strip()
        if inner.startswith("(") and inner.endswith(")"):
            parts = [p.strip() for p in inner[1:-1].split(",")]
            prec = int(parts[0])
            scale = int(parts[1]) if len(parts) > 1 else 0
            return decimal_type(prec, scale)
        return decimal_type(38, 0)
    if t.startswith("varchar"):
        return VARCHAR
    if t.startswith("char"):
        return CHAR
    if t in ("int", "integer"):
        return INTEGER
    if t in ("float", "real"):
        return REAL
    if t in ("double", "double precision", "float8"):
        return DOUBLE
    if t in _BY_NAME:
        return _BY_NAME[t]
    raise ValueError(f"Unknown type: {text!r}")


def common_super_type(a: Type, b: Type) -> Optional[Type]:
    """Least common type for implicit coercion (reference:
    FunctionAndTypeManager getCommonSuperType semantics, simplified)."""
    if a == b:
        return a
    if a == UNKNOWN:
        return b
    if b == UNKNOWN:
        return a
    order = {"tinyint": 0, "smallint": 1, "integer": 2, "bigint": 3}
    if a.name in order and b.name in order:
        return a if order[a.name] >= order[b.name] else b
    if a.is_decimal and b.is_decimal:
        scale = max(a.scale, b.scale)
        intd = max(a.precision - a.scale, b.precision - b.scale)
        return decimal_type(intd + scale, scale)
    if a.is_decimal and b.name in order:
        return common_super_type(a, decimal_type(18, 0))
    if b.is_decimal and a.name in order:
        return common_super_type(decimal_type(18, 0), b)
    float_like = {"real", "double"}
    if a.name in float_like or b.name in float_like:
        if a.is_numeric and b.is_numeric:
            if "double" in (a.name, b.name) or a.is_decimal or b.is_decimal \
                    or "bigint" in (a.name, b.name) or "integer" in (a.name, b.name):
                return DOUBLE
            return REAL
    if a.is_string and b.is_string:
        return VARCHAR
    if {a.name, b.name} == {"date", "timestamp"}:
        return TIMESTAMP
    return None


def can_coerce(frm: Type, to: Type) -> bool:
    if frm == to or frm == UNKNOWN:
        return True
    c = common_super_type(frm, to)
    return c == to
