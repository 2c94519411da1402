"""Whole-fragment fusion in the port (planner/fusion.py,
operators/fused_fragment.py) against the JAX reference, over TPC-H
Q1-Q22 at `tiny` on the CPU (the composed form of every chain):

- fused and unfused runs of the port give the same rows in the same
  order;
- the fused port matches the reference (assert_rows_equal's rule:
  DOUBLE rel_tol 1e-6, everything else exact);
- the port's fusion report equals the reference's, entry by entry
  (chain, terminal, fused label, reason, selectivity, provenance), with
  the reference's fragment-result cache and history off (the port has
  neither): 26 fused chains of 93;
- the port's composed chain equals the reference's (JAX on the CPU) on
  the same numpy batch, for a chain of every lowered operation;
- the session property, the selectivity gate's boundary, filtered-out
  rows never forming groups, and a fused LIMIT abandoning its scan."""

import re

import pytest
import torch

from tpch_queries import QUERIES
from test_tpch_suite import FULLY_ORDERED, assert_rows_equal

from torch_fragment_cases import (
    CASES, columns, make_data, port_batch, port_body,
)

# one intra-op thread: see tests/test_torch_tpch.py
torch.set_num_threads(1)

_REF_PROPS = {"fragment_result_cache_enabled": False,
              "history_based_optimization": False}
_KEYS = ("pipeline", "source", "chain", "terminal", "fused", "reason",
         "selectivity", "sel_provenance")


@pytest.fixture(scope="module")
def runners():
    from presto_tpu.runner import LocalRunner as JaxRunner
    from presto_tpu_torch.runner import LocalRunner as TorchRunner
    return (JaxRunner("tpch", "tiny", properties=dict(_REF_PROPS)),
            TorchRunner("tpch", "tiny", device="cpu"),
            TorchRunner("tpch", "tiny", device="cpu",
                        properties={"fragment_fusion_enabled": False}))


_RESULTS = {}


def _results(runners, qn):
    """(reference result, port fused result, port unfused rows), each
    query run once per module."""
    if qn not in _RESULTS:
        ref, on, off = runners
        _RESULTS[qn] = (ref.execute(QUERIES[qn]), on.execute(QUERIES[qn]),
                        off.execute(QUERIES[qn]).rows())
    return _RESULTS[qn]


def _entries(report):
    return [{k: e[k] for k in _KEYS} for e in report["fragments"]]


@pytest.mark.parametrize("qn", sorted(QUERIES))
def test_fused_and_unfused_rows_identical(runners, qn):
    _, on, off_rows = _results(runners, qn)
    assert on.rows() == off_rows


@pytest.mark.parametrize("qn", sorted(QUERIES))
def test_fused_port_matches_reference(runners, qn):
    ref, on, _ = _results(runners, qn)
    assert on.names == ref.names
    assert_rows_equal(on.rows(), ref.rows(), qn, qn in FULLY_ORDERED)


@pytest.mark.parametrize("qn", sorted(QUERIES))
def test_fusion_report_equals_reference(runners, qn):
    ref, on, _ = _results(runners, qn)
    assert _entries(on.fusion_report) == _entries(ref.fusion_report)
    assert on.fusion_report["fused"] == ref.fusion_report["fused"]
    assert on.fusion_report["fallback"] == ref.fusion_report["fallback"]
    assert not any(str(e["reason"]).startswith("not_lowered")
                   for e in on.fusion_report["fragments"])


def test_fusion_report_totals(runners):
    """26 of the 93 chain candidates of Q1-Q22 fuse, in both packages."""
    total = fused = 0
    for qn in sorted(QUERIES):
        ref, on, _ = _results(runners, qn)
        total += len(on.fusion_report["fragments"])
        fused += on.fusion_report["fused"]
        assert len(ref.fusion_report["fragments"]) \
            == len(on.fusion_report["fragments"])
    assert (fused, total) == (26, 93)


# -- the composed chain against the reference's -------------------------

def _ref_body_and_batch(name, n, seed):
    import jax.numpy as jnp
    from presto_tpu import types as RT
    from presto_tpu.batch import Batch, Column
    from presto_tpu.expr import ir as RIR
    from presto_tpu.expr.compile import compile_expression
    from presto_tpu.operators.fused_fragment import (
        ChainStage, make_chain_body,
    )
    from presto_tpu.schema import ColumnSchema
    schema = {c: ColumnSchema(c, t, d) for c, t, d in columns(RT)}
    stages = []
    for filt, projs in CASES[name](RIR, RT):
        f = compile_expression(filt, schema) if filt is not None else None
        ps = tuple((p, compile_expression(e, schema)) for p, e in projs)
        stages.append(ChainStage(f, ps, None))
        schema = {p: ColumnSchema(p, ce.type, ce.dictionary)
                  for p, ce in ps}
    data, rv = make_data(n, seed)
    cols = {c: Column.from_numpy(data[c][0], data[c][1], t, n, d)
            for c, t, d in columns(RT)}
    return make_chain_body(stages), Batch(cols, jnp.asarray(rv))


@pytest.mark.parametrize("case", sorted(CASES))
def test_composed_chain_matches_reference(case):
    """Exact on row_valid, masks and every value under a set mask
    (DOUBLE too: the same IEEE operations in the same order)."""
    import numpy as np
    n, seed = 3000, 5
    ref_body, ref_batch = _ref_body_and_batch(case, n, seed)
    want = ref_body(ref_batch)
    got = port_body(case).plain(port_batch(n, seed))
    assert np.array_equal(np.asarray(want.row_valid),
                          got.row_valid.numpy())
    assert list(want.columns) == list(got.columns)
    for c, w in want.columns.items():
        g = got.columns[c]
        wm = np.asarray(w.mask)
        assert np.array_equal(wm, g.mask.numpy()), c
        assert g.dictionary == w.dictionary, c
        np.testing.assert_array_equal(g.data.numpy()[wm],
                                      np.asarray(w.data)[wm], err_msg=c)


# -- the session property and the gates ---------------------------------

def test_session_property_default_and_off(runners):
    from presto_tpu_torch.operators.core import FilterProjectOperatorFactory
    from presto_tpu_torch.parser import parse_statement
    from presto_tpu_torch.planner.local_planner import LocalExecutionPlanner
    from presto_tpu_torch.session_properties import (
        get_property, validate_set,
    )
    _, on, off = runners
    assert get_property({}, "fragment_fusion_enabled") is True
    assert validate_set("fragment_fusion_enabled", False) is False
    with pytest.raises(ValueError):
        validate_set("fragment_fusion_enabled", "yes")
    sql = QUERIES[1]
    assert on.execute(sql).fusion_report["fused"] == 1
    assert off.execute(sql).fusion_report is None
    lp = LocalExecutionPlanner(off.catalogs, off.session, off.device) \
        .plan(off._plan_query(parse_statement(sql)))
    assert any(isinstance(f, FilterProjectOperatorFactory)
               for pipe in lp.pipelines for f in pipe)


def test_selectivity_gate_boundary(runners):
    """1/NDV equality selectivities straddle the quarter threshold:
    shipmode (7 values, 1/7 < 1/4) trips the gate; returnflag (3 values,
    1/3 >= 1/4) folds into the aggregation."""
    _, on, off = runners
    low_sql = "select count(*) from lineitem where shipmode = 'AIR'"
    hi_sql = "select count(*) from lineitem where returnflag = 'A'"
    low = on.execute(low_sql).fusion_report
    assert any(e["reason"] == "selective_chain" for e in low["fragments"])
    hi = on.execute(hi_sql).fusion_report
    assert any(e["fused"] and "aggregation" in e["fused"]
               for e in hi["fragments"]), hi
    for sql in (low_sql, hi_sql):
        assert on.execute(sql).rows() == off.execute(sql).rows()


def test_filtered_out_rows_never_form_groups(runners):
    """The fused aggregation groups on the CHAIN's row_valid: a group
    value that exists only among filtered-out rows (99) must not
    surface as an empty group."""
    _, on, off = runners
    sql = ("select case when custkey % 3 = 0 then 99 else custkey % 3 "
           "end g, count(*) c from customer where "
           "(case when custkey % 3 = 0 then -1.0 else acctbal end) > 0 "
           "group by 1 order by 1")
    a = on.execute(sql)
    assert any(e["fused"] and "aggregation" in e["fused"]
               for e in a.fusion_report["fragments"]), a.fusion_report
    assert a.rows() == off.execute(sql).rows()
    assert a.rows() and all(g != 99 for g, _ in a.rows())


def test_fused_limit_abandons_scan(monkeypatch):
    """LIMIT early termination survives fusion: with small batches the
    fused[filter_project+limit] operator stops pulling scan batches
    within a couple of driver rounds (tiny lineitem, 5,990 rows, is 12
    batches of 512 rows)."""
    from presto_tpu_torch.operators import core
    from presto_tpu_torch.runner import LocalRunner
    pulled = []
    orig = core.TableScanOperator.get_output

    def spy(self):
        b = orig(self)
        if b is not None:
            pulled.append(self.ctx.name)
        return b
    monkeypatch.setattr(core.TableScanOperator, "get_output", spy)
    r = LocalRunner("tpch", "tiny", device="cpu",
                    properties={"batch_rows": 512})
    res = r.execute("select orderkey from lineitem where quantity > 0 "
                    "limit 3")
    assert len(res.rows()) == 3
    assert any(re.fullmatch(r"fused\[filter_project(\*\d+)?\+limit\]",
                            e["fused"] or "")
               for e in res.fusion_report["fragments"]), \
        res.fusion_report
    assert 0 < pulled.count("scan:lineitem") < 6


def test_not_lowered_chain_is_declined(runners, monkeypatch):
    """A chain holding a function with no lowering is declined with
    `not_lowered:<fn>` and runs as unfused FilterProjects (composed, on
    the CPU), with the reference's rows. Every scalar function the
    compiler knows lowers since REAL math did (C2), so exp is given a
    closure with an operation that has no lowering (nan_to_num, which
    leaves these finite values as they are)."""
    from presto_tpu_torch.expr import compile as C
    monkeypatch.setitem(C._MATH_FNS, "exp",
                        lambda x: torch.nan_to_num(torch.exp(x)))
    ref, on, _ = runners
    sql = ("select returnflag, count(*) from lineitem "
           "where exp(discount) > 1.05 group by returnflag")
    got = on.execute(sql)
    reasons = [e["reason"] for e in got.fusion_report["fragments"]]
    assert "not_lowered:exp" in reasons, reasons
    assert sorted(got.rows()) == sorted(ref.execute(sql).rows())


def test_fused_fragments_counter_follows_the_report(runners):
    """`telemetry.kernels.FUSED_FRAGMENTS` counts each decision of the
    fusion pass once, by (status, reason), as the query's report lists
    them."""
    import collections
    from presto_tpu_torch.telemetry import kernels as tk
    _, on, _ = runners
    before = collections.Counter(tk.FUSED_FRAGMENTS)
    report = on.execute(QUERIES[3]).fusion_report
    delta = collections.Counter(tk.FUSED_FRAGMENTS)
    delta.subtract(before)
    want = collections.Counter(
        (("partial" if e["reason"] else "fused") if e["fused"]
         else "fallback", e["reason"] or "")
        for e in report["fragments"])
    assert +delta == want
    assert sum(n for (status, _), n in want.items()
               if status != "fallback") == report["fused"]
