"""K9's plain version (`expand_plain`) against the JAX package's
expansion (`_expand_from_enc`: `_expand_aligned` and `_expand_general`,
presto_tpu/ops/join.py:578, :609), on the CPU, for inner, left and full
joins under both verify modes.

Both packages build the same table and search it; each expansion gets
the same candidates (`lo_enc`) and the same probe hash2, and every
output slot must agree: row_valid, masks, every value under a set mask,
the overflow flag, the live count and (full joins) the matched flags.
The cases hold what K9's general layout on the card splits into blocks
of 1,024 rows and slots: a run of 3,000 build rows (several blocks for
one probe row), a capacity that ends inside such a run, and hash2
disagreeing for a third of the probe rows, so a left join keeps
NULL-build slots for rows whose candidates all fail. The CUDA kernel is
held against this plain version in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu import batch as jb
from presto_tpu.ops import join as jj
from presto_tpu.types import parse_type as jparse

from presto_tpu_torch import interop
from presto_tpu_torch.ops import join as tj

CPU = torch.device("cpu")

# one intra-op thread: see tests/test_torch_tpch.py
torch.set_num_threads(1)

#: probe rows and build rows of every case
NPROBE, NBUILD = 2048, 4096
#: build rows of the long run (key 7)
LONG_RUN = 3000


def _both(cols, row_valid):
    jbatch = jb.Batch(
        {n: jb.Column(jnp.asarray(d), jnp.asarray(m), jparse(t), None)
         for n, (d, m, t) in cols.items()}, jnp.asarray(row_valid))
    tbatch = interop.batch_from_numpy(
        {n: (d, m, t, None) for n, (d, m, t) in cols.items()}, row_valid,
        CPU)
    return jbatch, tbatch


def _inputs(case, rng):
    """Build and probe columns: a unique-key build for "aligned", else
    duplicate keys with one LONG_RUN-row run whose key ten probe rows
    carry."""
    if case == "aligned":
        bk = rng.permutation(NBUILD * 3)[:NBUILD].astype(np.int64)
    else:
        bk = rng.integers(100, 100 + NBUILD // 4, NBUILD)
        bk[:LONG_RUN] = 7
        bk = rng.permutation(bk)
    bm = rng.random(NBUILD) < 0.98
    bcols = {"bk": (bk, bm, "bigint"),
             "bv": (rng.normal(0, 1, NBUILD), rng.random(NBUILD) < 0.9,
                    "double")}
    pick = rng.integers(0, NBUILD, NPROBE)
    take = rng.random(NPROBE) < 0.6
    pk = np.where(take, bk[pick], rng.integers(-(1 << 40), 1 << 40, NPROBE))
    pm = np.where(take, bm[pick], rng.random(NPROBE) < 0.9)
    if case != "aligned":
        pk[100:140:4], pm[100:140:4] = 7, True
    pcols = {"pk": (pk, pm, "bigint"),
             "pv": (rng.integers(0, 100, NPROBE), rng.random(NPROBE) < 0.9,
                    "bigint")}
    brv = rng.random(NBUILD) < 0.97
    prv = rng.random(NPROBE) < 0.9
    prv[100:140:4] = True
    return _both(bcols, brv), _both(pcols, prv)


def _slots_equal(tout, jout, names):
    rv = np.asarray(jout.row_valid)
    np.testing.assert_array_equal(tout.row_valid.numpy(), rv)
    for n in names:
        tm, jm = tout.columns[n].mask.numpy(), np.asarray(jout.columns[n].mask)
        np.testing.assert_array_equal(tm, jm, err_msg=n)
        td = tout.columns[n].data.numpy()[jm]
        jd = np.asarray(jout.columns[n].data)[jm]
        np.testing.assert_array_equal(td.view(np.uint8), jd.view(np.uint8),
                                      err_msg=n)


@pytest.mark.parametrize("verify", ["hash", "full"])
@pytest.mark.parametrize("join_type", ["inner", "left", "full"])
@pytest.mark.parametrize("case", ["aligned", "long_run", "cut_run",
                                  "bad_h2"])
def test_expand_plain_matches_reference(case, join_type, verify):
    rng = np.random.default_rng(["aligned", "long_run", "cut_run",
                                 "bad_h2"].index(case))
    (jbuild, tbuild), (jprobe, tprobe) = _inputs(case, rng)
    jt = jj.build_for_backend(jbuild, ("bk",))
    tt = tj.build_for_backend(tbuild, ("bk",))
    assert tt.unique_runs == (case == "aligned")
    h, h2 = jj._hash_jit(jprobe, ("pk",))
    jlo = jj._search_jit(jt, h, h2, verify)
    tlo, _ = tj.probe_search(tt, tprobe, ("pk",), verify)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    h2 = np.array(h2)
    if case == "bad_h2":
        h2[rng.random(NPROBE) < 0.33] ^= 1
    counts = torch.where(tlo >= 0, tt.run_len[tlo.clamp(min=0)],
                         torch.zeros_like(tlo))
    emit = counts if join_type == "inner" else torch.where(
        tprobe.row_valid, counts.clamp(min=1), torch.zeros_like(counts))
    cum = torch.cumsum(emit, 0) - emit
    need = int(emit.sum())
    long_rows = [p for p in range(100, 140, 4) if int(counts[p]) > 1024]
    if case != "aligned":
        assert long_rows  # runs longer than a write block
    if case == "aligned":
        cap = NPROBE
    elif case == "cut_run":
        # the capacity ends inside the third long-run row's run
        cap = int(cum[long_rows[2]]) + 1500
    else:
        cap = need
    jmatched = jnp.zeros(NBUILD, bool) if join_type == "full" else None
    tmatched = torch.zeros(NBUILD, dtype=torch.bool) \
        if join_type == "full" else None
    names = ("pk", "pv", "bk", "bv")
    jout, jovf, jtot, jmatched = jj._expand_from_enc(
        jt, jprobe, ("pk",), jlo, jmatched, cap, join_type, ("pk", "pv"),
        ("bk", "bv"), ("bk",), verify, h2=jnp.asarray(h2))
    tout, tovf, ttot = tj.expand_plain(
        tt, tprobe, ("pk",), tlo, cap, join_type, ("pk", "pv"),
        ("bk", "bv"), ("bk",), verify, torch.from_numpy(h2), tmatched)
    assert bool(tovf) == bool(jovf) == (need > cap)
    assert int(ttot) == int(jtot)
    _slots_equal(tout, jout, names)
    if join_type == "full":
        np.testing.assert_array_equal(tmatched.numpy(), np.asarray(jmatched))
    if case == "bad_h2" and join_type != "inner" and verify == "hash":
        # rows whose candidates all failed kept one NULL-build slot
        live = tout.row_valid & ~tout.columns["bk"].mask
        assert int(live.sum()) > 0
