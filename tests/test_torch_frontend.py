"""The port's front end (parser, analyzer, optimizer) is a copy of the
reference's with its imports pointed at the port: the same SQL must
give the same parse tree and the same optimized plan text."""

import pytest

from tpch_queries import QUERIES

from presto_tpu.parser import parse_statement as jax_parse
from presto_tpu.planner import nodes as jax_nodes
from presto_tpu.planner.optimizer import optimize as jax_optimize
from presto_tpu.runner import LocalRunner as JaxRunner

from presto_tpu_torch.parser import parse_statement as torch_parse
from presto_tpu_torch.planner import nodes as torch_nodes
from presto_tpu_torch.planner.optimizer import optimize as torch_optimize
from presto_tpu_torch.runner import LocalRunner as TorchRunner


@pytest.fixture(scope="module")
def runners():
    return (JaxRunner("tpch", "tiny"),
            TorchRunner("tpch", "tiny", device="cpu"))


@pytest.mark.parametrize("qn", sorted(QUERIES))
def test_parse_tree_matches_reference(qn):
    assert repr(torch_parse(QUERIES[qn])) == repr(jax_parse(QUERIES[qn]))


@pytest.mark.parametrize("qn", sorted(QUERIES))
def test_plan_text_matches_reference(qn, runners):
    ref, port = runners
    want = jax_nodes.plan_text(jax_optimize(
        ref.create_plan(QUERIES[qn]), ref.catalogs, session=ref.session))
    got = torch_nodes.plan_text(torch_optimize(
        port.create_plan(QUERIES[qn]), port.catalogs,
        session=port.session))
    assert got == want
