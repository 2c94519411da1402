"""The TPC-DS connector and battery through the port on the CPU.

- The port's connector (`presto_tpu_torch/connectors/tpcds.py`) equals
  the reference's column for column, exactly, for all 24 tables at
  `tiny` and for the fact tables at `sf0_01`; a projected scan equals
  the same columns of a full one; its numpy hash equals the
  reference's C++ datagen loop bit for bit.
- All 41 queries of tests/tpcds_queries.py at `tiny`: the port's rows
  match the reference's LocalRunner and the sqlite oracle
  (assert_rows_equal: DOUBLE rel_tol 1e-6, the rest exact), and the
  port's fusion report equals the reference's entry by entry. The
  window, rollup and smoke queries run in tier 1 (as
  tests/test_tpcds_suite.py runs its smoke set); the rest carry `slow`.
"""

import numpy as np
import pytest
import torch

from test_tpch_suite import assert_rows_equal, normalize, to_sqlite
from test_tpcds_suite import FULLY_ORDERED, TABLES
from test_tpcds_suite import oracle, runner  # noqa: F401 (fixtures)
from tpcds_queries import ORACLE_OVERRIDES, QUERIES

torch.set_num_threads(1)

#: windows (12, 20, 98, 104), rollups (18, 27, 36) and the reference's
#: smoke set
TIER1 = {12, 20, 98, 104, 18, 27, 36, 7, 19, 42, 52, 55, 96}
_REF_PROPS = {"fragment_result_cache_enabled": False,
              "history_based_optimization": False}
_KEYS = ("pipeline", "source", "chain", "terminal", "fused", "reason",
         "selectivity", "sel_provenance")
FACTS = ["store_sales", "store_returns", "catalog_sales",
         "catalog_returns", "web_sales", "web_returns", "inventory"]


@pytest.fixture(scope="module")
def runners():
    from presto_tpu.runner import LocalRunner as JaxRunner
    from presto_tpu_torch.runner import LocalRunner as TorchRunner
    return (JaxRunner("tpcds", "tiny", properties=dict(_REF_PROPS)),
            TorchRunner("tpcds", "tiny", device="cpu"))


_ran = [0]


@pytest.fixture(autouse=True)
def _periodic_cache_clear():
    """The reference's XLA:CPU crashes once a process holds too many
    compiled executables; clear every few queries, as
    tests/test_tpcds_suite.py does."""
    yield
    _ran[0] += 1
    if _ran[0] % 6 == 0:
        import jax
        jax.clear_caches()


def _entries(report):
    return [tuple(e.get(k) for k in _KEYS) for e in report["fragments"]]


@pytest.mark.parametrize("qn", [
    qn if qn in TIER1 else pytest.param(qn, marks=pytest.mark.slow)
    for qn in sorted(QUERIES)])
def test_tpcds_query_matches_reference_and_sqlite(qn, runners, oracle):  # noqa: F811
    from conftest import require_sqlite_full_join
    osql = to_sqlite(ORACLE_OVERRIDES.get(qn, QUERIES[qn]))
    require_sqlite_full_join(osql)
    ref, port = runners
    got = port.execute(QUERIES[qn])
    want = ref.execute(QUERIES[qn])
    assert got.names == want.names
    ordered = qn in FULLY_ORDERED
    assert_rows_equal(got.rows(), want.rows(), qn, ordered)
    types = [f.type.name for f in got.fields]
    exp = [tuple(r) for r in oracle.execute(osql).fetchall()]
    assert_rows_equal(normalize(got.rows(), types), exp, qn, ordered)
    assert _entries(got.fusion_report) == _entries(want.fusion_report)
    assert got.fusion_report["fused"] == want.fusion_report["fused"]


def _gens():
    from presto_tpu.connectors.tpcds import TpcdsConnector as Ref
    from presto_tpu_torch.connectors.tpcds import TpcdsConnector as Port
    return Ref()._gens, Port()._gens


def _assert_same(ref, port, schema, table, lo, hi, columns=None):
    rd, rm = ref[schema].generate(table, lo, hi)
    pd_, pm = port[schema].generate(table, lo, hi, columns)
    names = list(rd) if columns is None else list(columns)
    for c in names:
        np.testing.assert_array_equal(pd_[c], rd[c], err_msg=f"{table}.{c}")
        assert pd_[c].dtype == rd[c].dtype, f"{table}.{c}"
        np.testing.assert_array_equal(
            pm.get(c, np.ones(hi - lo, bool)),
            rm.get(c, np.ones(hi - lo, bool)), err_msg=f"{table}.{c} mask")
    if columns is None:
        assert set(pd_) == set(rd) and set(pm) == set(rm), table
    assert port[schema].schema(table) == ref[schema].schema(table) \
        or repr(port[schema].schema(table)) \
        == repr(ref[schema].schema(table))


@pytest.mark.parametrize("table", TABLES)
def test_connector_table_equals_reference_tiny(table):
    ref, port = _gens()
    _assert_same(ref, port, "tiny", table, 0, ref["tiny"].rows(table))


@pytest.mark.parametrize("table", FACTS)
def test_connector_fact_table_equals_reference_sf0_01(table):
    ref, port = _gens()
    n = ref["sf0_01"].rows(table)
    assert n == port["sf0_01"].rows(table)
    _assert_same(ref, port, "sf0_01", table, 0, n)


@pytest.mark.parametrize("table,columns", [
    ("store_sales", ["ss_item_sk", "ss_ext_sales_price"]),
    ("store_sales", ["ss_sold_date_sk", "ss_store_sk"]),
    ("catalog_sales", ["cs_item_sk", "cs_ext_sales_price",
                       "cs_sold_date_sk"]),
    ("item", ["i_item_id", "i_class", "i_category"]),
    ("item", ["i_current_price"]),
])
def test_projected_scan_equals_full_columns(table, columns):
    ref, port = _gens()
    _assert_same(ref, port, "tiny", table, 3, ref["tiny"].rows(table),
                 columns)


def test_numpy_hash_equals_reference_datagen_loop():
    """The port hashes with numpy's splitmix64 (`_mix64`); the
    reference may use its C++ loop (presto_tpu/native/datagen.cpp).
    Both give the same 64-bit values."""
    import ctypes
    from presto_tpu.native import load_datagen
    from presto_tpu_torch.connectors import tpcds as pt
    idx = np.arange(0, 200_000, 7, dtype=np.uint64) \
        + np.uint64(1 << 40)
    salt = 0x1234_5678_9ABC
    with np.errstate(over="ignore"):
        mine = pt._mix64(idx + np.uint64(salt)
                         * np.uint64(0x632be59bd9b4e019))
    lib = load_datagen()
    if lib is not None:
        out = np.empty(len(idx), np.uint64)
        p = ctypes.POINTER(ctypes.c_uint64)
        lib.pt_gen_hash_idx(idx.ctypes.data_as(p), len(idx), salt,
                            out.ctypes.data_as(p))
        np.testing.assert_array_equal(mine, out)
    from presto_tpu.connectors import tpcds as rt
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(
            mine, rt._mix64(idx + np.uint64(salt)
                            * np.uint64(0x632be59bd9b4e019)))


def test_scan_lands_on_the_runner_device_and_uses_the_catalog():
    from presto_tpu_torch.runner import LocalRunner
    r = LocalRunner("tpcds", "tiny", device="cpu")
    got = r.execute("select count(*), sum(ss_quantity) from store_sales")
    ref, _ = _gens()
    d, m = ref["tiny"].generate("store_sales", 0,
                                ref["tiny"].rows("store_sales"))
    q = d["ss_quantity"][m.get("ss_quantity", np.ones(len(d["ss_quantity"]),
                                                      bool))]
    assert got.rows() == [(ref["tiny"].rows("store_sales"), int(q.sum()))]
