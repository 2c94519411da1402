"""The FULL OUTER join through both packages: the port's probe step
(`probe_join_full`, K9's full mode) and outer tail (`unmatched_build`,
K11) against the JAX package's on the same seeded numpy inputs, and
every case of tests/test_full_join.py through both LocalRunners and
sqlite.

On the CPU the port runs the plain versions of K9 and K11; the CUDA
kernels are held against those in tests/test_torch_cuda.py. Joined rows,
matched flags and live counts are integers or copied values, so every
comparison is exact; query results use assert_rows_equal's rule (DOUBLE
rel_tol 1e-6, everything else exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_full_join import CASES as FULL_CASES
from test_tpch_suite import assert_rows_equal, normalize, to_sqlite
from test_tpch_suite import oracle, runner  # noqa: F401 (fixtures)
from test_torch_join import _both, _build_cols, _live_rows, _np, _probe_cols

from presto_tpu.ops import join as jj
from presto_tpu.types import parse_type as jparse

from presto_tpu_torch.ops import join as tj
from presto_tpu_torch.telemetry import kernels as tk
from presto_tpu_torch.types import parse_type as tparse

# one intra-op thread: see tests/test_torch_tpch.py
torch.set_num_threads(1)

_PROBE_OUT, _BUILD_OUT = ("pk", "pv"), ("bk", "bv")


def _full_step_both(kind, verify, cap=None, seed=61):
    """One FULL probe step on both packages over the same inputs:
    (reference (table, out, overflow, total, matched), port (table, out,
    overflow, total, matched), the capacity the probe needs)."""
    rng = np.random.default_rng(seed + len(kind))
    bcols, brv = _build_cols(rng, 2048, kind)
    pcols, prv = _probe_cols(rng, 4096, bcols)
    jbuild, tbuild = _both(bcols, brv)
    jprobe, tprobe = _both(pcols, prv)
    jt = jj.build_for_backend(jbuild, ("bk",))
    tt = tj.build_for_backend(tbuild, ("bk",))
    need = _slots_needed(tt, tprobe, verify)
    cap = need if cap is None else cap(need)
    jm = jnp.zeros(jt.sorted_hash.shape[0], dtype=bool)
    tm = torch.zeros(tt.sorted_hash.shape[0], dtype=torch.bool)
    args = (cap, _PROBE_OUT, _BUILD_OUT, ("bk",), verify)
    jout, jovf, jtot, jm = jj.probe_join_full(jt, jprobe, ("pk",), jm,
                                              *args)
    tout, tovf, ttot = tj.probe_join_full(tt, tprobe, ("pk",), tm, *args)
    return (jt, jout, jovf, jtot, jm), (tt, tout, tovf, ttot, tm), need


def _slots_needed(table, probe, verify):
    """Output slots a left/full probe of `probe` fills: the candidate
    run per live probe row, at least one."""
    lo_enc, _ = tj.probe_search(table, probe, ("pk",), verify)
    counts = torch.where(lo_enc >= 0,
                         table.run_len[torch.clamp(lo_enc, min=0)],
                         torch.zeros_like(lo_enc))
    return int(torch.where(probe.row_valid, torch.clamp(counts, min=1),
                           torch.zeros_like(counts)).sum())


@pytest.mark.parametrize("verify", ["hash", "full"])
@pytest.mark.parametrize("kind", ["unique", "dup", "half_dead",
                                  "all_null"])
def test_probe_join_full_matches_reference(kind, verify):
    """The FULL step's rows (the left join's: unmatched probe rows keep
    a NULL build side), overflow flag, live count and matched flags; a
    unique build takes the aligned layout at the probe's capacity."""
    cap = None if kind == "dup" else (lambda need: 4096)
    (_, jout, jovf, jtot, jm), (_, tout, tovf, ttot, tm), _ = \
        _full_step_both(kind, verify, cap)
    assert bool(tovf) == bool(jovf) is False
    assert int(ttot) == int(jtot)
    names = _PROBE_OUT + _BUILD_OUT
    assert _live_rows(tout, names) == _live_rows(jout, names)
    np.testing.assert_array_equal(tm.numpy(), _np(jm))
    assert bool(tm.any()) == (kind != "all_null")


@pytest.mark.parametrize("below", [0, 1], ids=["at_limit", "one_below"])
@pytest.mark.parametrize("verify", ["hash", "full"])
def test_probe_join_full_at_the_capacity_limit(verify, below):
    """A duplicate-key FULL probe into exactly the slots it needs, and
    one slot fewer: the overflow flag, the rows kept inside the capacity
    and the matched flags of those rows agree with the reference."""
    (_, jout, jovf, jtot, jm), (_, tout, tovf, ttot, tm), need = \
        _full_step_both("dup", verify, lambda need: need - below)
    assert bool(tovf) == bool(jovf) == bool(below)
    assert int(ttot) == int(jtot)
    names = _PROBE_OUT + _BUILD_OUT
    assert _live_rows(tout, names) == _live_rows(jout, names)
    np.testing.assert_array_equal(tm.numpy(), _np(jm))


@pytest.mark.parametrize("verify", ["hash", "full"])
@pytest.mark.parametrize("kind", ["unique", "dup", "half_dead",
                                  "all_null"])
def test_unmatched_build_matches_reference(kind, verify):
    """The outer tail after the probe step: the never-matched live build
    rows with a NULL probe side, and the live count."""
    (jt, _, _, _, jm), (tt, _, _, _, tm), _ = _full_step_both(
        kind, verify, None if kind == "dup" else (lambda need: 4096))
    schema = (("pk", "bigint", None), ("pv", "bigint", None),
              ("ps", "varchar", ("a", "b")))
    jout, jlive = jj.unmatched_build(
        jt, jm, tuple((n, jparse(t), d) for n, t, d in schema), _BUILD_OUT)
    before = tk.CALLS["join_outer"]
    tout, tlive = tj.unmatched_build(
        tt, tm, tuple((n, tparse(t), d) for n, t, d in schema), _BUILD_OUT)
    assert tk.CALLS["join_outer"] == before + 1
    assert int(tlive) == int(jlive) == int(tout.row_valid.sum())
    names = ("pk", "pv", "ps") + _BUILD_OUT
    rows = _live_rows(tout, names)
    assert rows == _live_rows(jout, names)
    assert all(r[:3] == (None, None, None) for r in rows)
    if kind != "all_null":
        assert 0 < len(rows) < int(tt.valid_count)


# FULL joins whose result goes through Batch.concat: the outer tail's
# NULL probe side must carry the unified key dictionaries that the probe
# batches were remapped onto
_CONCAT_CASES = {
    "varchar_keys_ordered": (
        "select l.s, r.s2 from (values ('aa'), ('bb'), ('bb')) as l(s) "
        "full join (values ('bb'), ('cc')) as r(s2) on l.s = r.s2 "
        "order by l.s nulls last, r.s2 nulls last",
        "select l.s, r.s2 from (select column1 as s from "
        "(values ('aa'), ('bb'), ('bb'))) as l full join "
        "(select column1 as s2 from (values ('bb'), ('cc'))) as r "
        "on l.s = r.s2 order by l.s nulls last, r.s2 nulls last"),
    # the FULL join's output is the cross join's build, concatenated
    # with no projection in between
    "varchar_keys_cross_build": (
        "select * from (select 1 as one) as y cross join "
        "((values ('aa'), ('bb'), ('bb')) as l(s) full join "
        "(values ('bb'), ('cc')) as r(s2) on l.s = r.s2)",
        "select * from (select 1 as one) as y cross join "
        "((select column1 as s from (values ('aa'), ('bb'), ('bb'))) as l "
        "full join (select column1 as s2 from (values ('bb'), ('cc'))) "
        "as r on l.s = r.s2)"),
}
_ALL_CASES = {**FULL_CASES, **_CONCAT_CASES}


@pytest.mark.parametrize("name", sorted(_ALL_CASES))
def test_full_join_case_matches_reference_and_sqlite(
        name, runner, oracle):  # noqa: F811
    """Every FULL OUTER JOIN case of tests/test_full_join.py, and the
    ordered VARCHAR-key case, through the port (CPU) against the JAX
    package and the sqlite oracle."""
    from conftest import require_sqlite_full_join
    from presto_tpu_torch.runner import LocalRunner
    engine_sql, sqlite_sql = _ALL_CASES[name]
    require_sqlite_full_join(to_sqlite(sqlite_sql or engine_sql))
    port = LocalRunner("tpch", "tiny", device="cpu")
    ordered = "order by" in engine_sql
    got = port.execute(engine_sql)
    want = runner.execute(engine_sql)
    assert got.names == want.names
    assert_rows_equal(got.rows(), want.rows(), name, ordered)
    exp = [tuple(r) for r in
           oracle.execute(to_sqlite(sqlite_sql or engine_sql)).fetchall()]
    assert_rows_equal(normalize(got.rows(), [f.type.name
                                             for f in got.fields]),
                      exp, name, ordered)


def test_full_join_plans_its_outer_tail():
    """A FULL join runs the probe's full step and the outer tail, and no
    dynamic filter (the reference's inner-only guard): both sides keep
    their unmatched rows."""
    from presto_tpu_torch.runner import LocalRunner
    port = LocalRunner("tpch", "tiny", device="cpu")
    before = dict(tk.CALLS)
    rows = port.execute(
        "select count(*), count(c.custkey), count(o.orderkey) from "
        "(select custkey from customer where nationkey < 5) c full join "
        "(select orderkey, custkey from orders where orderpriority = "
        "'1-URGENT') o on c.custkey = o.custkey").rows()
    total, cust, orders = rows[0]
    assert cust < total and orders < total
    assert tk.CALLS["join_outer"] == before.get("join_outer", 0) + 1
    assert tk.CALLS["dynamic_filter"] == before.get("dynamic_filter", 0)
