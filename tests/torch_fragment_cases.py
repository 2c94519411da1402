"""Expression cases for the fragment kernel (K12) tests: one chain per
lowered operation, built as IR in either package (the port's or the
JAX reference's), and seeded numpy input columns with NULLs, zero
divisors, negative numbers, pre-1970 dates and string codes; plus the
port's compiled chains and batches of them.

`CASES[name](ir, T)` returns a list of stages, each (filter IR or
None, [(output name, projection IR)]); a later stage reads the earlier
stage's outputs. `T` is the package's types module."""

from __future__ import annotations

import numpy as np
import torch

from presto_tpu_torch import types as PT
from presto_tpu_torch.batch import Batch, Column
from presto_tpu_torch.expr import ir as PIR
from presto_tpu_torch.expr.compile import compile_expression
from presto_tpu_torch.operators.fused_fragment import (
    ChainStage, make_chain_body,
)
from presto_tpu_torch.schema import ColumnSchema

#: the VARCHAR column's (sorted) dictionary
DICT = ("AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK")


def columns(T):
    """[(name, type, dictionary)] of the input batch."""
    dec = T.decimal_type(12, 2)
    return [("a", T.BIGINT, None), ("b", T.BIGINT, None),
            ("i", T.INTEGER, None), ("x", T.DOUBLE, None),
            ("y", T.DOUBLE, None), ("d", T.DATE, None),
            ("s", T.VARCHAR, DICT), ("f", T.BOOLEAN, None),
            ("m", dec, None),
            ("nz", T.BIGINT, None)]


def make_data(n: int, seed: int):
    """{name: (values, mask)} plus row_valid, as numpy arrays."""
    rng = np.random.default_rng(seed)

    def nulls(p=0.12):
        return rng.random(n) >= p

    a = rng.integers(-50, 50, n).astype(np.int64)
    b = rng.integers(-6, 7, n).astype(np.int64)       # zero divisors
    nz = rng.integers(1, 9, n).astype(np.int64) * rng.choice([-1, 1], n)
    x = np.round(rng.normal(0, 2, n), 3)
    x[rng.random(n) < 0.05] = 0.0
    y = np.round(rng.normal(0, 2, n), 2)
    y[rng.random(n) < 0.1] = 0.0                        # x / 0
    d = rng.integers(-40000, 25000, n).astype(np.int32)  # pre-1970 too
    data = {
        "a": (a, nulls()), "b": (b, nulls()),
        "i": (rng.integers(-1000, 1000, n).astype(np.int32), nulls()),
        "x": (x, nulls()), "y": (y, nulls()), "d": (d, nulls()),
        "s": (rng.integers(0, len(DICT), n).astype(np.int32), nulls()),
        "f": (rng.random(n) < 0.5, nulls()),
        "m": (rng.integers(-10**6, 10**6, n).astype(np.int64), nulls()),
        "nz": (nz, nulls(0.05)),
    }
    return data, rng.random(n) < 0.9


def _cases():
    def one(build):
        return lambda ir, T: [(None, build(ir, T))]

    def filt(build):
        return lambda ir, T: [(build(ir, T), [("a", ir.ref("a", T.BIGINT))])]

    def r(ir, T, name):
        t = dict((n, t) for n, t, _ in columns(T))[name]
        return ir.ref(name, t)

    def call(ir, name, typ, *args):
        return ir.call(name, typ, *args)

    def sf(ir, form, typ, *args):
        return ir.SpecialForm(form, tuple(args), typ)

    C = {}
    # arithmetic
    C["add"] = one(lambda ir, T: [
        ("o1", call(ir, "add", T.BIGINT, r(ir, T, "a"), r(ir, T, "b"))),
        ("o2", call(ir, "add", T.DOUBLE, r(ir, T, "x"), r(ir, T, "y"))),
        ("o3", call(ir, "add", T.BIGINT, r(ir, T, "i"), r(ir, T, "a")))])
    C["subtract"] = one(lambda ir, T: [
        ("o1", call(ir, "subtract", T.BIGINT, r(ir, T, "a"),
                    ir.lit(7, T.BIGINT))),
        ("o2", call(ir, "subtract", T.DOUBLE, ir.lit(1.5, T.DOUBLE),
                    r(ir, T, "x")))])
    C["multiply"] = one(lambda ir, T: [
        ("o1", call(ir, "multiply", T.BIGINT, r(ir, T, "a"),
                    r(ir, T, "b"))),
        ("o2", call(ir, "multiply", T.DOUBLE, r(ir, T, "x"),
                    ir.lit(0.1, T.DOUBLE)))])
    C["divide"] = one(lambda ir, T: [
        ("o1", call(ir, "divide", T.BIGINT, r(ir, T, "a"), r(ir, T, "b"))),
        ("o2", call(ir, "divide", T.DOUBLE, r(ir, T, "x"), r(ir, T, "y")))])
    C["modulus"] = one(lambda ir, T: [
        ("o1", call(ir, "modulus", T.BIGINT, r(ir, T, "a"),
                    r(ir, T, "b")))])
    C["mod"] = one(lambda ir, T: [
        ("o1", call(ir, "mod", T.BIGINT, r(ir, T, "a"), r(ir, T, "nz")))])
    C["negate"] = one(lambda ir, T: [
        ("o1", call(ir, "negate", T.BIGINT, r(ir, T, "a"))),
        ("o2", call(ir, "negate", T.DOUBLE, r(ir, T, "x")))])
    C["decimal"] = one(lambda ir, T: [
        ("o1", call(ir, "multiply", T.decimal_type(18, 4),
                    r(ir, T, "m"), r(ir, T, "m"))),
        ("o2", call(ir, "add", T.decimal_type(13, 2), r(ir, T, "m"),
                    ir.lit(125, T.decimal_type(12, 2))))])
    # comparisons, over numbers, dates and strings
    for op in ("equal", "not_equal", "less_than", "less_than_or_equal",
               "greater_than", "greater_than_or_equal"):
        C[op] = (lambda op: lambda ir, T: [(None, [
            ("o1", call(ir, op, T.BOOLEAN, r(ir, T, "a"), r(ir, T, "b"))),
            ("o2", call(ir, op, T.BOOLEAN, r(ir, T, "x"),
                        ir.lit(0.5, T.DOUBLE))),
            ("o3", call(ir, op, T.BOOLEAN, r(ir, T, "d"),
                        ir.lit(-365, T.DATE))),
            ("o4", call(ir, op, T.BOOLEAN, r(ir, T, "s"),
                        ir.lit("MAIL", T.VARCHAR))),
            ("o5", call(ir, op, T.BOOLEAN, r(ir, T, "i"),
                        r(ir, T, "a")))])])(op)
    # strings
    C["like"] = filt(lambda ir, T: call(
        ir, "like", T.BOOLEAN, r(ir, T, "s"), ir.lit("%AI%", T.VARCHAR)))
    C["substr"] = one(lambda ir, T: [
        ("o1", call(ir, "substr", T.VARCHAR, r(ir, T, "s"),
                    ir.lit(1, T.BIGINT), ir.lit(3, T.BIGINT))),
        ("o2", r(ir, T, "s"))])
    C["varchar_literal"] = one(lambda ir, T: [
        ("o1", call(ir, "equal", T.BOOLEAN, r(ir, T, "s"),
                    ir.lit("PIGEON", T.VARCHAR))),
        ("o2", call(ir, "less_than", T.BOOLEAN, r(ir, T, "s"),
                    ir.lit("B", T.VARCHAR)))])
    # dates
    for fn in ("year", "month", "day", "quarter", "day_of_week",
               "day_of_year", "week", "year_of_week"):
        C[fn] = (lambda fn: lambda ir, T: [(None, [
            ("o1", call(ir, fn, T.BIGINT, r(ir, T, "d")))])])(fn)
    # logic and special forms
    C["and"] = filt(lambda ir, T: ir.SpecialForm("and", (
        call(ir, "greater_than", T.BOOLEAN, r(ir, T, "a"), r(ir, T, "b")),
        call(ir, "less_than", T.BOOLEAN, r(ir, T, "x"), r(ir, T, "y"))),
        T.BOOLEAN))
    C["or"] = one(lambda ir, T: [("o1", ir.SpecialForm("or", (
        call(ir, "greater_than", T.BOOLEAN, r(ir, T, "a"), r(ir, T, "b")),
        r(ir, T, "f")), T.BOOLEAN))])
    C["not"] = one(lambda ir, T: [
        ("o1", sf(ir, "not", T.BOOLEAN, r(ir, T, "f")))])
    C["between"] = filt(lambda ir, T: sf(
        ir, "between", T.BOOLEAN, r(ir, T, "x"), ir.lit(-0.5, T.DOUBLE),
        ir.lit(1.5, T.DOUBLE)))
    C["in"] = one(lambda ir, T: [
        ("o1", sf(ir, "in", T.BOOLEAN, r(ir, T, "a"), ir.lit(1, T.BIGINT),
                  ir.lit(2, T.BIGINT), ir.lit(-3, T.BIGINT))),
        ("o2", sf(ir, "in", T.BOOLEAN, r(ir, T, "s"),
                  ir.lit("AIR", T.VARCHAR), ir.lit("MAIL", T.VARCHAR)))])
    C["in_null"] = one(lambda ir, T: [
        ("o1", sf(ir, "in", T.BOOLEAN, r(ir, T, "a"), ir.lit(1, T.BIGINT),
                  ir.lit(None, T.BIGINT)))])
    C["cast"] = one(lambda ir, T: [
        ("o1", sf(ir, "cast", T.DOUBLE, r(ir, T, "a"))),
        ("o2", sf(ir, "cast", T.BIGINT, r(ir, T, "x"))),
        ("o3", sf(ir, "cast", T.BIGINT, r(ir, T, "i"))),
        ("o4", sf(ir, "cast", T.DOUBLE, r(ir, T, "m")))])
    C["if"] = one(lambda ir, T: [("o1", sf(
        ir, "if", T.DOUBLE,
        call(ir, "greater_than", T.BOOLEAN, r(ir, T, "a"),
             ir.lit(0, T.BIGINT)),
        r(ir, T, "x"), r(ir, T, "y")))])
    C["switch"] = one(lambda ir, T: [("o1", sf(
        ir, "if", T.BIGINT,
        call(ir, "less_than", T.BOOLEAN, r(ir, T, "a"),
             ir.lit(-10, T.BIGINT)), ir.lit(1, T.BIGINT),
        sf(ir, "if", T.BIGINT,
           call(ir, "less_than", T.BOOLEAN, r(ir, T, "a"),
                ir.lit(10, T.BIGINT)), ir.lit(2, T.BIGINT),
           ir.lit(None, T.BIGINT))))])
    C["coalesce"] = one(lambda ir, T: [("o1", sf(
        ir, "coalesce", T.BIGINT, r(ir, T, "a"), r(ir, T, "b"),
        ir.lit(0, T.BIGINT)))])
    C["is_null"] = one(lambda ir, T: [
        ("o1", sf(ir, "is_null", T.BOOLEAN, r(ir, T, "a"))),
        ("o2", sf(ir, "is_not_null", T.BOOLEAN, r(ir, T, "x")))])
    C["literals"] = one(lambda ir, T: [
        ("o1", ir.lit(42, T.BIGINT)), ("o2", ir.lit(2.25, T.DOUBLE)),
        ("o3", ir.lit(-3650, T.DATE)), ("o4", ir.lit(None, T.DOUBLE))])
    # a two-stage chain: the second stage reads the first's outputs
    C["two_stages"] = lambda ir, T: [
        (call(ir, "greater_than", T.BOOLEAN, r(ir, T, "x"),
              ir.lit(-1.0, T.DOUBLE)),
         [("p", call(ir, "multiply", T.DOUBLE, r(ir, T, "x"),
                     r(ir, T, "y"))),
          ("a", r(ir, T, "a")), ("d", r(ir, T, "d"))]),
        (call(ir, "less_than", T.BOOLEAN, ir.ref("a", T.BIGINT),
              ir.lit(40, T.BIGINT)),
         [("q", call(ir, "subtract", T.DOUBLE, ir.ref("p", T.DOUBLE),
                     ir.lit(1.0, T.DOUBLE))),
          ("yr", call(ir, "year", T.BIGINT, ir.ref("d", T.DATE)))]),
    ]
    return C


CASES = _cases()


# -- the cases in the port --------------------------------------------

def port_stages(name: str, device="cpu"):
    """The case's chain as the port's ChainStages, compiled for
    `device`."""
    schema = {n: ColumnSchema(n, t, d) for n, t, d in columns(PT)}
    stages = []
    for filt, projs in CASES[name](PIR, PT):
        f = compile_expression(filt, schema, device) \
            if filt is not None else None
        ps = tuple((n, compile_expression(e, schema, device))
                   for n, e in projs)
        dicts = tuple(sorted((n, cs.dictionary) for n, cs in schema.items()
                             if cs.dictionary is not None))
        stages.append(ChainStage(f, ps, dicts))
        schema = {n: ColumnSchema(n, ce.type, ce.dictionary)
                  for n, ce in ps}
    return stages


def port_body(name: str, device="cpu"):
    return make_chain_body(port_stages(name, device))


def port_batch(n: int, seed: int, device="cpu") -> Batch:
    data, rv = make_data(n, seed)
    cols = {}
    for c, t, d in columns(PT):
        vals, mask = data[c]
        cols[c] = Column.from_numpy(vals, mask, t, n, d,
                                    torch.device(device))
    return Batch(cols, torch.from_numpy(rv).to(device))


def assert_batches_equal(got: Batch, want: Batch) -> int:
    """row_valid and every mask exactly, every value under a set mask
    exactly (NaN equal to NaN); returns the values compared."""
    assert torch.equal(got.row_valid.cpu(), want.row_valid.cpu())
    assert list(got.columns) == list(want.columns)
    compared = 0
    for name, w in want.columns.items():
        g = got.columns[name]
        assert g.data.dtype == w.data.dtype, name
        assert g.dictionary == w.dictionary, name
        gm, wm = g.mask.cpu(), w.mask.cpu()
        assert torch.equal(gm, wm), name
        a, b = g.data.cpu()[wm], w.data.cpu()[wm]
        if a.is_floating_point():
            assert torch.equal(torch.isnan(a), torch.isnan(b)), name
            a, b = a[~torch.isnan(a)], b[~torch.isnan(b)]
        assert torch.equal(a, b), (name, a[a != b][:5], b[a != b][:5])
        compared += int(wm.sum())
    return compared


# -- every scalar function of the compiler -----------------------------

def function_calls(ir, T):
    """{label: IR call} covering every scalar function the port's
    compiler knows, over the case columns (several argument shapes for
    some: integer and float arguments, shift counts past the width)."""
    cols = {n: t for n, t, _ in columns(T)}

    def r(name):
        return ir.ref(name, cols[name])

    def lit(v, t):
        return ir.lit(v, t)

    S = T.VARCHAR
    out = {}
    from presto_tpu_torch.expr import compile as C
    for name in C._MATH_FNS:
        if name in ("power", "atan2", "mod", "log"):
            out[f"{name}/double"] = (T.DOUBLE, [r("x"), r("y")])
            out[f"{name}/bigint"] = (T.DOUBLE if name != "mod"
                                     else T.BIGINT, [r("a"), r("nz")])
        elif name.startswith("bitwise_") and name != "bitwise_not":
            out[f"{name}/cols"] = (T.BIGINT, [r("a"), r("b")])
            out[f"{name}/wide"] = (T.BIGINT, [r("nz"), lit(70, T.BIGINT)])
            out[f"{name}/edge"] = (T.BIGINT, [r("a"), lit(63, T.BIGINT)])
            out[f"{name}/neg"] = (T.BIGINT, [r("a"), lit(-3, T.BIGINT)])
        elif name == "bitwise_not":
            out[name] = (T.BIGINT, [r("a")])
        elif name in ("round", "truncate"):
            out[f"{name}/1"] = (T.DOUBLE, [r("x")])
            out[f"{name}/2"] = (T.DOUBLE, [r("x"), lit(1, T.BIGINT)])
        elif name == "width_bucket":
            out[name] = (T.BIGINT, [r("x"), lit(-1.0, T.DOUBLE),
                                    lit(2.0, T.DOUBLE), lit(5, T.BIGINT)])
        elif name in ("abs", "sign", "ceiling", "floor"):
            out[f"{name}/double"] = (T.DOUBLE, [r("x")])
            out[f"{name}/bigint"] = (T.BIGINT, [r("a")])
        else:
            out[f"{name}/double"] = (T.DOUBLE, [r("x")])
            out[f"{name}/bigint"] = (T.DOUBLE, [r("a")])
    # float32: the rounded-to-nearest square root
    out["sqrt/real"] = (T.REAL, [ir.SpecialForm("cast", (r("x"),), T.REAL)])
    for name in C._DATE_EXTRACT:
        out[name] = (T.BIGINT, [r("d")])
    strings = {
        "substr": [lit(2, T.BIGINT), lit(3, T.BIGINT)],
        "upper": [], "lower": [], "trim": [], "ltrim": [], "rtrim": [],
        "reverse": [], "normalize": [],
        "concat_lit": [lit("-x", S)],
        "translate": [lit("AI", S), lit("ai", S)],
        "split_join": [lit(" ", S), lit("_", S)],
        "replace": [lit("AI", S), lit("*", S)],
        "lpad": [lit(6, T.BIGINT), lit("#", S)],
        "rpad": [lit(6, T.BIGINT), lit("#", S)],
        "split_part": [lit(" ", S), lit(2, T.BIGINT)],
        "length": [], "codepoint": [], "bit_length": [],
        "octet_length": [], "crc32": [],
        "strpos": [lit("A", S)], "levenshtein_distance": [lit("MAIL", S)],
        "split_count": [lit(" ", S)], "from_base": [lit(36, T.BIGINT)],
        "hamming_distance": [lit("MAIL", S)],
        "starts_with": [lit("R", S)], "ends_with": [lit("L", S)],
        "contains_str": [lit("AI", S)],
    }
    for tab, typ in ((C._STRING_TO_STRING, S), (C._STRING_TO_STRING_NULL, S),
                     (C._STRING_TO_INT, T.BIGINT),
                     (C._STRING_TO_INT_NULL, T.BIGINT),
                     (C._STRING_TO_BOOL, T.BOOLEAN)):
        for name in tab:
            out[name] = (typ, [r("s")] + strings[name])
    out["concat"] = (S, [r("s"), lit("/", S), r("s")])
    out["like"] = (T.BOOLEAN, [r("s"), lit("%A_L%", S)])
    out["negate"] = (T.BIGINT, [r("a")])
    out["nullif"] = (T.BIGINT, [r("a"), r("b")])
    out["greatest"] = (T.DOUBLE, [r("x"), r("y"), lit(0.5, T.DOUBLE)])
    out["least"] = (T.BIGINT, [r("a"), r("b")])
    for name in ("second", "minute", "hour", "millisecond"):
        out[name] = (T.BIGINT, [ir.ref("m", T.TIMESTAMP)])
    for unit in ("day", "week", "month", "quarter", "year"):
        out[f"date_add/{unit}"] = (T.DATE, [lit(unit, S), r("b"), r("d")])
        out[f"date_diff/{unit}"] = (T.BIGINT, [
            lit(unit, S), r("d"), lit(-400, T.DATE)])
        out[f"date_trunc/{unit}"] = (T.DATE, [lit(unit, S), r("d")])
    out["last_day_of_month"] = (T.DATE, [r("d")])
    out["from_unixtime"] = (T.TIMESTAMP, [r("x")])
    out["to_unixtime"] = (T.DOUBLE, [ir.ref("m", T.TIMESTAMP)])
    for name in ("is_nan", "is_finite", "is_infinite"):
        out[f"{name}/double"] = (T.BOOLEAN, [r("x")])
        out[f"{name}/ratio"] = (T.BOOLEAN, [
            ir.call("divide", T.DOUBLE, r("x"), r("y"))])
    return {k: ir.call(k.split("/")[0], typ, *args)
            for k, (typ, args) in out.items()}


def function_stage(expr, device="cpu"):
    """One port ChainStage projecting the compiled `expr` as "o"."""
    schema = {n: ColumnSchema(n, t, d) for n, t, d in columns(PT)}
    return ChainStage(None, (("o", compile_expression(expr, schema,
                                                      device)),), None)


def real_function_calls(ir, T):
    """{label: (result type, args)}: the CUDA math library's functions
    and the remainder over REAL arguments (the float32 column is the
    case batch's DOUBLE column cast to REAL)."""
    cols = {n: t for n, t, _ in columns(T)}

    def real(name):
        return ir.SpecialForm("cast", (ir.ref(name, cols[name]),), T.REAL)
    out = {}
    for name in ("exp", "ln", "log2", "log10", "sin", "cos", "tan", "asin",
                 "acos", "atan", "sinh", "cosh", "tanh", "cbrt"):
        out[f"{name}/real"] = (T.REAL, [real("x")])
    for name in ("power", "atan2", "mod"):
        out[f"{name}/real"] = (T.REAL, [real("x"), real("y")])
    return out


def real_stage(label, device="cpu"):
    rt, args = real_function_calls(PIR, PT)[label]
    return function_stage(PIR.call(label.split("/")[0], rt, *args), device)
