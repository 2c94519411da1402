"""Set operations and DISTINCT through both LocalRunners: the DISTINCT,
UNION, INTERSECT and EXCEPT cases of tests/test_queries_battery.py run
on the port (CPU, plain versions of its kernels) and are compared with
the JAX package's rows and the sqlite oracle's by assert_rows_equal's
rule (DOUBLE rel_tol 1e-6, everything else exact, cases with ORDER BY in
order). Plus the DISTINCT operator's state growth against the
reference's fold.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_queries_battery import CASES as BATTERY
from test_tpch_suite import assert_rows_equal, normalize, to_sqlite
from test_tpch_suite import oracle, runner  # noqa: F401 (fixtures)

from presto_tpu import batch as jb
from presto_tpu import types as jtypes
from presto_tpu.operators.base import DriverContext as JDriverContext
from presto_tpu.operators.sort_ops import DistinctOperatorFactory as JDistinct

from presto_tpu_torch import interop
from presto_tpu_torch import types as ttypes
from presto_tpu_torch.operators.base import DriverContext as TDriverContext
from presto_tpu_torch.operators.sort_ops import (
    DistinctOperatorFactory as TDistinct,
)
from presto_tpu_torch.telemetry import kernels as tk

# one intra-op thread: see tests/test_torch_tpch.py
torch.set_num_threads(1)

#: the battery's set-operation and DISTINCT cases (with
#: approx_distinct, whose name says distinct)
SET_CASES = sorted(n for n in BATTERY
                   if any(w in n for w in ("union", "intersect", "except",
                                           "distinct")))

_PORT = {}


def _port():
    if "r" not in _PORT:
        from presto_tpu_torch.runner import LocalRunner
        _PORT["r"] = LocalRunner("tpch", "tiny", device="cpu")
    return _PORT["r"]


@pytest.mark.parametrize("name", SET_CASES)
def test_set_case_matches_reference_and_sqlite(
        name, runner, oracle):  # noqa: F811
    engine_sql, sqlite_sql = BATTERY[name]
    ordered = "order by" in engine_sql.lower()
    got = _port().execute(engine_sql)
    want = runner.execute(engine_sql)
    assert got.names == want.names
    assert_rows_equal(got.rows(), want.rows(), name, ordered)
    exp = [tuple(r) for r in
           oracle.execute(to_sqlite(sqlite_sql or engine_sql)).fetchall()]
    assert_rows_equal(normalize(got.rows(), [f.type.name
                                             for f in got.fields]),
                      exp, name, ordered)


#: set operations whose inputs' VARCHAR columns carry different
#: dictionaries: the union's output dictionary is the union of its
#: inputs', and each input is re-encoded onto it. Checked against sqlite
#: only: the JAX package decodes every input with the union's dictionary
#: without re-encoding, and returns other strings.
STRING_SET_CASES = {
    "union_all_tables": (
        "select name from nation where nationkey < 2 union all "
        "select name from region where regionkey < 2", None),
    "union_literal": (
        "select s from (values ('aa'), ('bb')) as t(s) union all "
        "select 'zz'",
        "select column1 from (values ('aa'), ('bb')) union all "
        "select 'zz'"),
    "union_distinct_ordered": (
        "select name from nation where nationkey < 3 union "
        "select name from region order by name", None),
    "intersect_literal": (
        "select name from nation intersect select s from "
        "(values ('BRAZIL'), ('ASIA'), ('CHINA')) as t(s)",
        "select name from nation intersect select column1 from "
        "(values ('BRAZIL'), ('ASIA'), ('CHINA'))"),
    "except_tables": (
        "select name from nation where nationkey < 5 except "
        "select name from nation where nationkey between 1 and 2", None),
}


@pytest.mark.parametrize("name", sorted(STRING_SET_CASES))
def test_string_set_case_matches_sqlite(name, oracle):  # noqa: F811
    engine_sql, sqlite_sql = STRING_SET_CASES[name]
    ordered = "order by" in engine_sql
    got = _port().execute(engine_sql)
    rows = normalize(got.rows(), [f.type.name for f in got.fields])
    assert rows
    exp = [tuple(r) for r in
           oracle.execute(to_sqlite(sqlite_sql or engine_sql)).fetchall()]
    assert_rows_equal(rows, exp, name, ordered)


def test_set_operations_run_their_operators():
    """UNION goes through the local queue into DISTINCT's fold (the
    distinct family); UNION ALL through the queue alone."""
    before = tk.CALLS["distinct"]
    _port().execute("select nationkey from customer union "
                    "select nationkey from supplier")
    assert tk.CALLS["distinct"] > before
    before = tk.CALLS["distinct"]
    rows = _port().execute("select nationkey from nation union all "
                           "select nationkey from nation").rows()
    assert len(rows) == 50 and tk.CALLS["distinct"] == before


@pytest.mark.parametrize("rows,capacity", [(100, 4096), (5000, 64),
                                           (20000, 16)],
                         ids=["fits", "grows_from_64", "grows_from_16"])
def test_distinct_operator_grows_like_the_reference(rows, capacity):
    """The DISTINCT fold over three batches from a state far too small:
    the port doubles and re-merges until the set fits, and keeps the
    same distinct rows as the reference's operator."""
    rng = np.random.default_rng(rows)
    jop = JDistinct(1, [("a", jtypes.BIGINT, None),
                        ("b", jtypes.INTEGER, None)],
                    capacity).create(JDriverContext())
    top = TDistinct(1, [("a", ttypes.BIGINT, None),
                        ("b", ttypes.INTEGER, None)],
                    capacity).create(TDriverContext())
    for _ in range(3):
        a = rng.integers(0, rows, 8192)
        b = rng.integers(0, 2, 8192).astype(np.int32)
        am, bm = rng.random(8192) < 0.95, np.ones(8192, bool)
        rv = rng.random(8192) < 0.9
        jop.add_input(jb.Batch(
            {"a": jb.Column(jnp.asarray(a), jnp.asarray(am), jtypes.BIGINT),
             "b": jb.Column(jnp.asarray(b), jnp.asarray(bm),
                            jtypes.INTEGER)}, jnp.asarray(rv)))
        top.add_input(interop.batch_from_numpy(
            {"a": (a, am, "bigint", None), "b": (b, bm, "integer", None)},
            rv, torch.device("cpu")))
    jop.finish()
    top.finish()
    want = sorted(jop.get_output().to_pylist(), key=repr)
    state = top.get_output()
    got = sorted(state.to_pylist(), key=repr)
    assert got == want
    # the state never fills: a full one could not tell kept rows from
    # dropped ones
    assert len(got) < state.capacity
