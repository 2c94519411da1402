"""Function registry listing (reference: metadata/
BuiltInFunctionNamespaceManager listFunctions backing SHOW FUNCTIONS).

The engine's functions live in three places — the expression compiler's
kernel tables (`expr/compile.py`), the analyzer's typing dispatch, and
the aggregate/window sets — so the listing assembles from those plus a
hand-kept list of the analyzer-special forms (guarded by tests that
every listed name actually resolves and the total stays >= 150)."""

from __future__ import annotations

from typing import List, Tuple

#: analyzer-special scalar forms not present in a compiler table
_ANALYZER_SCALARS = (
    "abs", "ceil", "ceiling", "floor", "round", "sign", "mod", "pow",
    "power", "sqrt", "cbrt", "exp", "ln", "log", "log2", "log10",
    "log1p", "expm1", "sin", "cos", "tan", "asin", "acos", "atan",
    "atan2", "sinh", "cosh", "tanh", "cot", "degrees", "radians",
    "truncate", "width_bucket", "pi", "e", "nan", "infinity",
    "is_nan", "is_finite", "is_infinite",
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "bitwise_left_shift", "bitwise_right_shift",
    "greatest", "least", "coalesce", "nullif", "if", "boolean",
    "concat", "hash_code", "typeof",
    "year", "month", "day", "quarter", "day_of_week", "day_of_year",
    "day_of_month", "week", "week_of_year", "year_of_week",
    "second", "minute", "hour", "millisecond",
    "date_trunc", "date_add", "date_diff", "last_day_of_month",
    "from_unixtime", "to_unixtime",
    "length", "char_length", "character_length", "substring",
    "grouping",
    # array / map / row value forms (analysis-time lowering; arrays
    # construct via the ARRAY[...] syntax form, not a function name)
    "split", "cardinality", "element_at",
    "contains", "array_position", "array_min", "array_max",
    "array_join", "map", "row", "map_keys", "map_values",
    # lambda-taking functions
    "transform", "filter", "reduce", "any_match", "all_match",
    "none_match", "zip_with", "transform_values",
)


def registered_functions() -> List[Tuple[str, str]]:
    """Sorted (name, kind) for every registered function; kind is one
    of scalar | aggregate | window."""
    from presto_tpu_torch.expr import compile as C
    from presto_tpu_torch.planner import analyzer as A

    scalars = set(_ANALYZER_SCALARS)
    scalars |= set(C._MATH_FNS) | set(C._STRING_TO_STRING)
    scalars |= set(C._STRING_TO_INT) | set(C._STRING_TO_BOOL)
    scalars |= set(C._STRING_TO_STRING_NULL)
    scalars |= set(C._STRING_TO_INT_NULL)
    scalars.discard("concat_lit")   # internal form
    scalars.discard("contains_str")  # internal form
    aggs = set(A.AGG_FUNCTIONS)
    wins = set(A.WINDOW_FUNCTIONS)
    out = [(n, "scalar") for n in scalars - aggs - wins]
    out += [(n, "aggregate") for n in aggs]
    out += [(n, "window") for n in wins - aggs]
    return sorted(out)
