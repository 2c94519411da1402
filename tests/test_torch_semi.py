"""The port's semi join against the JAX package's, over the same seeded
numpy inputs: the keep mask of `semi_mark` (IN / EXISTS, and NOT IN
with `negate`), and semi-join SQL shapes through both LocalRunners.

On the CPU the port runs K7's plain version (K5's search, then a walk
over each candidate run); the CUDA kernel is held against it in
tests/test_torch_cuda.py. Every comparison is of booleans or copied
values, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu.ops import join as jj

from presto_tpu_torch.ops import join as tj

from test_torch_join import _both, _build_cols, _np, _probe_cols
from test_tpch_suite import assert_rows_equal

# one intra-op thread: see tests/test_torch_tpch.py
torch.set_num_threads(1)


def _semi_build(rng, n, kind):
    """Build-side columns: the join tests' kinds, plus runs of 80 rows
    per key (Q20's partsupp by suppkey) and an all-dead build."""
    if kind == "runs80":
        cols, rv = _build_cols(rng, n, "unique")
        k0 = np.repeat(rng.permutation(n // 80 + 1)[: n // 80 + 1],
                       80)[:n].astype(np.int64)
        cols["bk"] = (k0, np.ones(n, bool), "bigint")
        return cols, rv
    if kind == "empty":
        cols, rv = _build_cols(rng, n, "unique")
        return cols, np.zeros(n, bool)
    return _build_cols(rng, n, kind)


def _collide(jt, tt, verify):
    """Make the first row of every duplicate run a false candidate in
    both packages' tables: a different hash2 (verify="hash") or a
    different key (verify="full"), so a match must be found deeper in
    the run, as after a 64-bit hash collision."""
    starts = np.flatnonzero(_np(tt.run_len) > 1)
    if verify == "hash":
        h2 = _np(tt.hash2).copy()
        h2[starts] ^= 0x5DEECE66D
        tt.hash2 = torch.from_numpy(h2)
        jt.hash2 = jnp.asarray(h2)
    else:
        c = tt.batch.columns["bk"]
        d = c.data.numpy().copy()
        d[starts] += 1 << 50
        c.data = torch.from_numpy(d)
        jc = jt.batch.columns["bk"]
        jt.batch.columns["bk"] = type(jc)(jnp.asarray(d), jc.mask, jc.type,
                                          jc.dictionary)
    return len(starts)


@pytest.mark.parametrize("negate", [False, True], ids=["in", "not_in"])
@pytest.mark.parametrize("verify", ["hash", "full"])
@pytest.mark.parametrize("kind", ["unique", "dup", "half_dead", "all_null",
                                  "runs80", "empty", "collide"])
def test_semi_mark_matches_reference(kind, verify, negate):
    """The keep mask of every probe row: unique-run and duplicate-run
    builds (runs of up to 80 rows), both verify modes, NULL probe and
    build keys, NOT IN, an all-dead build, and runs whose first row is
    a false candidate (the walk goes on to the end of the run)."""
    rng = np.random.default_rng(101 + len(kind) * 7 + len(verify))
    bcols, brv = _semi_build(rng, 2048, "dup" if kind == "collide"
                             else kind)
    pcols, prv = _probe_cols(rng, 4096, bcols)
    jbuild, tbuild = _both(bcols, brv)
    jprobe, tprobe = _both(pcols, prv)
    jt = jj.build_for_backend(jbuild, ("bk",))
    tt = tj.build_for_backend(tbuild, ("bk",))
    if kind == "collide":
        assert _collide(jt, tt, verify) > 100
    found, valid = jj.semi_mark(jt, jprobe, ("pk",), ("bk",), verify)
    want = (~_np(found) & _np(valid)) if negate else _np(found)
    got = tj.semi_mark(tt, tprobe, ("pk",), ("bk",), verify, negate)
    np.testing.assert_array_equal(got.numpy(), want)
    if kind in ("empty", "all_null"):
        assert not want.any() if not negate else want.any()
    elif not negate:
        assert 0 < want.sum() < want.size


def test_two_key_semi_mark_matches_reference():
    rng = np.random.default_rng(131)
    bcols, brv = _build_cols(rng, 2048, "dup", two_keys=True)
    pcols, prv = _probe_cols(rng, 4096, bcols, two_keys=True)
    jbuild, tbuild = _both(bcols, brv)
    jprobe, tprobe = _both(pcols, prv)
    keys, bkeys = ("pk", "pk2"), ("bk", "bk2")
    jt = jj.build_for_backend(jbuild, bkeys)
    tt = tj.build_for_backend(tbuild, bkeys)
    for verify in ("hash", "full"):
        found, _ = jj.semi_mark(jt, jprobe, keys, bkeys, verify)
        got = tj.semi_mark(tt, tprobe, keys, bkeys, verify)
        np.testing.assert_array_equal(got.numpy(), _np(found))


def test_semi_mark_rejects_mismatched_keys():
    rng = np.random.default_rng(137)
    bcols, brv = _build_cols(rng, 64, "unique")
    _, tbuild = _both(bcols, brv)
    tt = tj.build_for_backend(tbuild, ("bk",))
    with pytest.raises(ValueError, match="differ in length"):
        tj.semi_mark(tt, tbuild, ("bk",), ("bk", "bv"))
    with pytest.raises(ValueError, match="verify mode"):
        tj.semi_mark(tt, tbuild, ("bk",), verify="exact")


# -- semi joins in SQL ------------------------------------------------------

_RUNNERS = {}


def _runners():
    if not _RUNNERS:
        from presto_tpu.runner import LocalRunner as JaxRunner
        from presto_tpu_torch.runner import LocalRunner as TorchRunner
        _RUNNERS["tiny"] = (JaxRunner("tpch", "tiny"),
                            TorchRunner("tpch", "tiny", device="cpu"))
    return _RUNNERS["tiny"]


#: semi-join shapes beyond TPC-H's four: IN and NOT IN over a
#: duplicate-key build, string keys with different dictionaries, NOT IN
#: over a build holding NULLs, EXISTS / NOT EXISTS, and a semi join
#: above a streaming aggregation with a lower threshold than Q18's
SEMI_SHAPES = [
    ("in_dup", "select count(*), sum(o.totalprice) from orders o "
               "where o.custkey in (select custkey from orders "
               "where orderpriority = '1-URGENT')"),
    ("not_in_dup", "select count(*) from customer c where c.custkey "
                   "not in (select custkey from orders "
                   "where orderpriority = '1-URGENT')"),
    ("in_strings", "select count(*) from lineitem l where l.linestatus "
                   "in (select orderstatus from orders "
                   "where totalprice < 100000)"),
    ("not_in_nulls", "select count(*) from nation n where n.regionkey "
                     "not in (select case when r.regionkey = 1 then null "
                     "else r.regionkey end from region r "
                     "where r.regionkey < 3)"),
    ("exists", "select count(*) from customer c where exists (select * "
               "from orders o where o.custkey = c.custkey "
               "and o.totalprice > 300000)"),
    ("not_exists", "select count(*) from customer c where not exists "
                   "(select * from orders o where o.custkey = c.custkey "
                   "and o.orderpriority = '1-URGENT')"),
    ("q18_low", "select o.orderkey, o.totalprice from orders o "
                "where o.orderkey in (select orderkey from lineitem "
                "group by orderkey having sum(quantity) > 200) "
                "order by o.orderkey"),
]


@pytest.mark.parametrize("name,sql", SEMI_SHAPES,
                         ids=[s[0] for s in SEMI_SHAPES])
def test_semi_shapes_match_reference(name, sql):
    ref, port = _runners()
    got = port.execute(sql).rows()
    assert_rows_equal(got, ref.execute(sql).rows(), name,
                      "order by" in sql)
    assert got and any(v for row in got for v in row)
