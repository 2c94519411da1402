"""Window functions through the port on the CPU (the plain versions of
K13-K16), against the JAX package and the sqlite oracle.

Two levels, each with its tolerance stated: every query of
tests/test_window.py's WINDOW_QUERIES through both LocalRunners at
`tiny` and through sqlite (assert_rows_equal: DOUBLE rel_tol 1e-6, the
rest exact); and the whole-relation window pass `ops/window.py`
`window_kernel` against the reference's `_window_kernel_jit` on
batches built from one numpy seed (the same rule per output column:
float64 rel_tol 1e-6 where both masks are set, everything else exact,
masks exact). The NaN / +-Inf and huge-early-value cases, which the
reference checks through the memory connector and CTAS, are fed here
as batches.
"""

import math

import numpy as np
import pytest
import torch

from test_tpch_suite import assert_rows_equal, normalize, to_sqlite
from test_tpch_suite import oracle, runner  # noqa: F401 (fixtures)
from test_window import WINDOW_QUERIES

torch.set_num_threads(1)

_PORT = {}


def _port():
    if "r" not in _PORT:
        from presto_tpu_torch.runner import LocalRunner
        _PORT["r"] = LocalRunner("tpch", "tiny", device="cpu")
    return _PORT["r"]


@pytest.mark.parametrize("name", sorted(WINDOW_QUERIES))
def test_window_query_matches_reference_and_sqlite(name, runner, oracle):  # noqa: F811
    from presto_tpu_torch.telemetry import kernels as tk
    sql = WINDOW_QUERIES[name]
    before = tk.CALLS["window"]
    got = _port().execute(sql)
    assert tk.CALLS["window"] > before
    want = runner.execute(sql)
    assert got.names == want.names
    assert [repr(f.type) for f in got.fields] \
        == [repr(f.type) for f in want.fields]
    assert_rows_equal(got.rows(), want.rows(), name, True)
    types = [f.type.name for f in got.fields]
    exp = [tuple(r) for r in oracle.execute(to_sqlite(sql)).fetchall()]
    assert_rows_equal(normalize(got.rows(), types), exp, name, True)


def test_lag_default_string_and_analysis_errors():
    """A string default extends the output dictionary; mismatched
    defaults and fractional ROWS offsets are refused at analysis, as in
    the reference."""
    from presto_tpu_torch.runner import QueryError
    r = _port()
    rows = r.execute("""
        select nationkey,
               lag(name, 1, 'FIRST!') over (order by nationkey) p
        from nation where nationkey < 3 order by nationkey""").rows()
    assert rows[0][1] == "FIRST!"
    assert rows[1][1] == "ALGERIA"
    with pytest.raises(QueryError, match="default"):
        r.execute("select lag(name, 1, 7) over (order by nationkey) "
                  "from nation")
    with pytest.raises(QueryError, match="integral"):
        r.execute("select lag(nationkey, 1, 1.5) over (order by "
                  "nationkey) from nation")
    with pytest.raises(QueryError, match="integers"):
        r.execute("select sum(acctbal) over (order by custkey rows "
                  "between 1.5 preceding and current row) from customer")


def test_values_cancellation_through_runner():
    """The reference's huge-early-value query, through the port's
    runner: 1e18 first must not erase 1.0 + 2.0 later."""
    rows = _port().execute(
        "select x, sum(v) over (order by x rows between 1 preceding "
        "and current row) from (values "
        "(1, 1e18), (2, 1.0), (3, 2.0), (4, 3.0)) as t(x, v) "
        "order by x").rows()
    by_x = {x: s for x, s in rows}
    assert by_x[3] == 3.0
    assert by_x[4] == 5.0


# -- ops/window.py against the reference's kernel -------------------------

CAP = 96
LIVE = 83


def _columns(seed, special=None):
    """name -> (data, mask, type, dictionary) arrays of CAP rows from one
    numpy seed: two partition keys (one with NULLs), integer / double /
    string / date order keys (NULLs, ties), values with NULLs and a
    FILTER column. Rows past LIVE are padding."""
    rng = np.random.default_rng(seed)
    words = tuple(sorted({"ash", "birch", "cedar", "elm", "fir", "oak"}))

    def nulls(frac):
        return rng.random(CAP) >= frac
    v = rng.normal(0, 100, CAP)
    if special is not None:
        v[:len(special)] = special
    cols = {
        "p": (rng.integers(0, 4, CAP), np.ones(CAP, bool), "bigint", None),
        "q": (rng.integers(0, 3, CAP), nulls(0.15), "integer", None),
        "oi": (rng.integers(0, 12, CAP), nulls(0.1), "bigint", None),
        "od": (np.round(rng.normal(0, 10, CAP), 1), nulls(0.1), "double",
               None),
        "ot": (rng.integers(9000, 9040, CAP), nulls(0.1), "date", None),
        "v": (v, nulls(0.2) if special is None else np.ones(CAP, bool),
              "double", None),
        "iv": (rng.integers(-50, 50, CAP), nulls(0.2), "bigint", None),
        "s": (rng.integers(0, len(words), CAP), nulls(0.2), "varchar",
              words),
        "f": (rng.random(CAP) < 0.6, np.ones(CAP, bool), "boolean", None),
    }
    rv = np.zeros(CAP, bool)
    rv[:LIVE] = True
    return cols, rv


def _frames():
    return [("rows", "u", "c"), ("rows", "u", "u"), ("rows", -2, 1),
            ("rows", 1, 3), ("rows", "c", "u"), ("rows", -3, -1),
            ("range", "u", "c"), ("range", "c", "u"), ("range", "c", "c"),
            ("range", -2, 2), ("range", -5, "c"), ("range", 1, 4)]


def _calls(frames, with_range_offsets):
    from presto_tpu.types import BIGINT, DOUBLE, VARCHAR
    words = tuple(sorted({"ash", "birch", "cedar", "elm", "fir", "oak"}))
    out = [("row_number", None, 1, None, None),
           ("rank", None, 1, None, None),
           ("dense_rank", None, 1, None, None),
           ("ntile", None, 3, None, None),
           ("ntile", None, 7, None, None),
           ("percent_rank", None, 1, None, None),
           ("cume_dist", None, 1, None, None),
           ("lag", "v", 1, None, None), ("lead", "v", 2, None, None),
           ("lag", "iv", 3, -1, None), ("lead", "s", 1, 2, None)]
    for fr in frames:
        if not with_range_offsets and fr[0] == "range" and any(
                isinstance(b, int) for b in fr[1:]):
            continue
        out += [("sum", "v", 1, None, fr), ("avg", "iv", 1, None, fr),
                ("sum", "iv", 1, None, fr), ("count", None, 1, None, fr),
                ("count", "v", 1, None, fr), ("min", "v", 1, None, fr),
                ("max", "iv", 1, None, fr), ("min", "s", 1, None, fr),
                ("first_value", "v", 1, None, fr),
                ("last_value", "s", 1, None, fr),
                ("nth_value", "iv", 2, None, fr)]
    types = {"v": DOUBLE, "iv": BIGINT, "s": VARCHAR}
    specs = []
    for i, (fn, arg, off, default, fr) in enumerate(out):
        if fn in ("percent_rank", "cume_dist", "avg"):
            t = DOUBLE
        elif fn in ("row_number", "rank", "dense_rank", "ntile", "count"):
            t = BIGINT
        elif fn == "sum":
            t = BIGINT if arg == "iv" else DOUBLE
        else:
            t = types[arg]
        mode, fs, fe = fr if fr else ("full", "u", "c")
        specs.append(dict(out_name=f"w{i}", function=fn, arg=arg,
                          frame=mode, out_type=t,
                          out_dict=words if t is VARCHAR else None,
                          offset=off, fstart=fs, fend=fe,
                          filter_arg="f" if fn in ("sum", "count")
                          and i % 2 else None,
                          default=default))
    return specs


def _run_both(cols, rv, part, order, desc, nf, specs):
    import jax.numpy as jnp
    from presto_tpu.batch import Batch as JBatch, Column as JColumn
    from presto_tpu.ops import window as jw
    from presto_tpu.types import parse_type as jparse
    from presto_tpu_torch import interop
    from presto_tpu_torch.ops import window as tw
    from presto_tpu_torch.types import parse_type as tparse

    jb = JBatch({n: JColumn(jnp.asarray(np.array(d, dtype=jparse(t)
                                                 .np_dtype)),
                            jnp.asarray(m), jparse(t), dic)
                 for n, (d, m, t, dic) in cols.items()},
                jnp.asarray(rv))
    tb = interop.batch_from_numpy(cols, rv, torch.device("cpu"))

    def spec(mod, parse, s):
        return mod.WindowCallSpec(**{**s, "out_type": parse(
            s["out_type"].name)})
    jcalls = tuple(spec(jw, jparse, s) for s in specs)
    tcalls = tuple(spec(tw, tparse, s) for s in specs)
    want = jw._window_kernel_jit(jb, part_names=tuple(part),
                                 order_names=tuple(order),
                                 descending=tuple(desc),
                                 nulls_first=tuple(nf), calls=jcalls)
    got = tw.window_kernel(tb, tuple(part), tuple(order), tuple(desc),
                           tuple(nf), tcalls)
    return want, got


def _compare(want, got, specs, rv):
    for s in specs:
        n = s["out_name"]
        wd = np.asarray(want.columns[n].data)
        wm = np.asarray(want.columns[n].mask) & rv
        gd = got.columns[n].data.numpy()
        gm = got.columns[n].mask.numpy() & rv
        what = f"{n} {s['function']}({s['arg']}) {s['frame']} " \
               f"{s['fstart']}..{s['fend']}"
        np.testing.assert_array_equal(gm, wm, err_msg=what)
        assert gd.dtype == wd.dtype, what
        if np.issubdtype(wd.dtype, np.floating):
            np.testing.assert_allclose(gd[wm], wd[wm], rtol=1e-6,
                                       atol=0, equal_nan=True,
                                       err_msg=what)
        else:
            np.testing.assert_array_equal(gd[wm], wd[wm], err_msg=what)


#: (partition keys, order keys, descending, nulls_first, RANGE offsets)
LAYOUTS = {
    "part_order_int": (["p"], ["oi"], [False], [False], True),
    "two_parts_desc_nulls_first": (["p", "q"], ["oi"], [True], [True],
                                   True),
    "double_order_desc": (["q"], ["od"], [True], [False], True),
    "date_order": (["p"], ["ot"], [False], [True], True),
    "string_order_two_keys": (["p"], ["s", "oi"], [False, True],
                              [False, False], False),
    "no_partition": ([], ["oi"], [False], [False], True),
    "no_order": (["q"], [], [], [], False),
    "neither": ([], [], [], [], False),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_window_kernel_matches_reference(layout):
    part, order, desc, nf, offsets = LAYOUTS[layout]
    cols, rv = _columns(7 + len(layout))
    # every layout runs a third of the frames (the reference compiles
    # one program per layout, its size growing with the calls); each
    # frame runs under at least two layouts
    k = sorted(LAYOUTS).index(layout)
    specs = _calls(_frames()[k % 3::3], offsets and bool(order))
    if not order:
        specs = [s for s in specs if s["function"] not in (
            "rank", "dense_rank", "percent_rank", "cume_dist", "lag",
            "lead", "first_value", "last_value", "nth_value")]
    want, got = _run_both(cols, rv, part, order, desc, nf, specs)
    _compare(want, got, specs, rv)
    # input columns come back untouched, in input order
    for n, (d, m, t, _) in cols.items():
        np.testing.assert_array_equal(got.columns[n].mask.numpy(), m)


def test_window_kernel_special_values_and_cancellation():
    """NaN and +-Inf poison only the frames that hold them; a huge
    early value does not erase later frames' low bits; min/max let NaN
    win."""
    special = [math.nan, 1.0, math.inf, 2.0, -math.inf, 3.0, 1e18, 1.0,
               2.0, 3.0, math.inf, math.inf, 5.0]
    cols, rv = _columns(3, special)
    cols["p"] = (np.zeros(CAP, np.int64), np.ones(CAP, bool), "bigint",
                 None)
    cols["oi"] = (np.arange(CAP), np.ones(CAP, bool), "bigint", None)
    from presto_tpu.types import DOUBLE
    specs = []
    for i, fr in enumerate([("rows", -1, 0), ("rows", -2, 2),
                            ("rows", "u", "c"), ("rows", 0, 3)]):
        for fn in ("sum", "avg", "min", "max"):
            specs.append(dict(out_name=f"x{fn}{i}", function=fn, arg="v",
                              frame=fr[0], out_type=DOUBLE, offset=1,
                              fstart=fr[1], fend=fr[2]))
    want, got = _run_both(cols, rv, ["p"], ["oi"], [False], [False], specs)
    _compare(want, got, specs, rv)
    s = got.columns["xsum0"].data.numpy()
    assert math.isnan(s[0]) and math.isnan(s[1])
    assert s[2] == math.inf and s[3] == math.inf
    assert s[4] == -math.inf and s[5] == -math.inf
    assert s[8] == 3.0 and s[9] == 5.0     # 1e18 two rows back
    assert math.isnan(got.columns["xmin1"].data.numpy()[0])


def test_segments_plain_matches_reference_arithmetic():
    """K13's plain version on a layout with NULL keys, ties and padding
    equals the reference's boundary arithmetic row for row (padding
    rows carry the final group's ids and ends)."""
    from presto_tpu_torch.ops import common
    from presto_tpu_torch.ops import window as tw
    cols, rv = _columns(11)
    t = {n: (torch.from_numpy(np.asarray(d)), torch.from_numpy(m))
         for n, (d, m, _, _) in cols.items()}
    skeys, svalid, _ = common.sort_rows(
        [t["q"], t["oi"]], [False, False], [False, True],
        valid=torch.from_numpy(rv))
    seg = tw.segments_plain(skeys[:1], skeys[1:], svalid)
    nv = int(rv.sum())
    sv = svalid.numpy()
    assert sv[:nv].all() and not sv[nv:].any()
    pid, ps, pe = seg.pid.numpy(), seg.pstart.numpy(), seg.part_end.numpy()
    for i in range(nv):
        same = np.flatnonzero((pid == pid[i]) & sv)
        assert ps[i] == same.min() and pe[i] == same.max()
    assert (pid[nv:] == pid[nv - 1]).all() and (pe[nv:] == pe[nv - 1]).all()
    assert seg.dense.numpy()[-1] == seg.dense.numpy()[nv - 1]


def test_emit_chunks_split_every_column():
    from presto_tpu_torch.ops import window as tw
    assert tw.emit_chunks(0) == []
    assert tw.emit_chunks(tw.EMIT_MAX) == [(0, tw.EMIT_MAX)]
    assert tw.emit_chunks(tw.EMIT_MAX + 1) == [
        (0, tw.EMIT_MAX), (tw.EMIT_MAX, tw.EMIT_MAX + 1)]
    leaves, levels = tw.minmax_table_levels(8_388_608)
    assert leaves == 262_144 and levels == 19
