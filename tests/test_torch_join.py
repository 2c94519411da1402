"""The port's row hashes, hash-join build and probe, and dynamic filters
against the JAX package's, over the same seeded numpy inputs.

On the CPU the port runs the plain versions of K3 (row hash), K4 (join
build) and K5 (probe search); the CUDA kernels are held against those
in tests/test_torch_cuda.py. Everything compared here is an integer, a
hash, an offset or a copied value, so every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from presto_tpu import batch as jb
from presto_tpu.execution import dynamic_filters as jdf
from presto_tpu.ops import common as jc
from presto_tpu.ops import join as jj
from presto_tpu.types import parse_type as jparse

from presto_tpu_torch import interop
from presto_tpu_torch.execution import dynamic_filters as tdf
from presto_tpu_torch.ops import common as tc
from presto_tpu_torch.ops import join as tj

CPU = torch.device("cpu")

# one intra-op thread: see tests/test_torch_tpch.py
torch.set_num_threads(1)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _values(rng, n, kind):
    """Seeded key values of one dtype, with the edge cases first."""
    if kind == "int64":
        v = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                         n, dtype=np.int64)
        v[:4] = [np.iinfo(np.int64).min, -1, 0, np.iinfo(np.int64).max]
    elif kind == "float64":
        v = rng.normal(0, 1e9, n)
        v[:5] = [-0.0, 0.0, np.nan, -np.inf, 1e-310]
    elif kind == "int32":
        v = rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
    elif kind == "bool":
        v = rng.random(n) < 0.5
    else:
        raise ValueError(kind)
    return v


KEY_SETS = [("int64",), ("float64",), ("int32",), ("bool",),
            ("int64", "float64"), ("int32", "int64", "bool"),
            ("float64", "int32", "int64")]


@pytest.mark.parametrize("kinds", KEY_SETS, ids="-".join)
def test_row_hashes_bit_exact(kinds):
    """hash64 / hash64b / row_hash / row_hash2 equal the reference bit
    for bit: negative values, INT64_MIN, -0.0, NaN, NULL lanes."""
    rng = np.random.default_rng(len(kinds) * 31 + len(kinds[0]))
    n = 4096
    cols = [(_values(rng, n, k), rng.random(n) < 0.8) for k in kinds]
    jcols = [(jnp.asarray(d), jnp.asarray(m)) for d, m in cols]
    tcols = [(_t(d), _t(m)) for d, m in cols]
    for (jd, jm), (td, tm) in zip(jcols, tcols):
        np.testing.assert_array_equal(tc.hash64(td, tm).numpy(),
                                      _np(jc.hash64(jd, jm)))
        np.testing.assert_array_equal(tc.hash64b(td, tm).numpy(),
                                      _np(jc.hash64b(jd, jm)))
    np.testing.assert_array_equal(tc.row_hash(tcols).numpy(),
                                  _np(jc.row_hash(jcols)))
    np.testing.assert_array_equal(tc.row_hash2(tcols).numpy(),
                                  _np(jc.row_hash2(jcols)))


# -- batches of both packages ------------------------------------------


def _both(cols, row_valid):
    """(reference Batch, port Batch) of `cols`: name -> (data, mask,
    type name)."""
    jbatch = jb.Batch(
        {n: jb.Column(jnp.asarray(d), jnp.asarray(m), jparse(t), None)
         for n, (d, m, t) in cols.items()}, jnp.asarray(row_valid))
    tbatch = interop.batch_from_numpy(
        {n: (d, m, t, None) for n, (d, m, t) in cols.items()}, row_valid,
        CPU)
    return jbatch, tbatch


def _build_cols(rng, n, kind, two_keys=False):
    """Build-side columns. kind: unique | dup | half_dead | all_null."""
    if kind == "dup":
        k0 = rng.integers(0, max(n // 8, 2), n)
    else:
        k0 = rng.permutation(n * 3)[:n].astype(np.int64) - n
    m0 = np.ones(n, bool) if kind != "all_null" else np.zeros(n, bool)
    if kind == "dup":
        m0[::37] = False  # a few NULL keys in the dup build
    cols = {"bk": (k0, m0, "bigint"),
            "bv": (rng.normal(0, 1, n), rng.random(n) < 0.9, "double")}
    if two_keys:
        cols["bk2"] = (rng.integers(0, 5, n).astype(np.int32),
                       rng.random(n) < 0.95, "integer")
    rv = np.ones(n, bool)
    if kind == "half_dead":
        rv[n // 2:] = False
    return cols, rv


def _assert_table_equal(jt, tt):
    for f in ("sorted_hash", "hash2", "part_starts", "run_len"):
        np.testing.assert_array_equal(getattr(tt, f).numpy(),
                                      _np(getattr(jt, f)), err_msg=f)
    assert int(tt.valid_count) == int(jt.valid_count)
    assert tt.radix_bits == jt.radix_bits
    assert tt.unique_runs == jt.unique_runs
    span = int(torch.diff(tt.part_starts).max())
    assert tt.search_depth == tc.search_iters(span) <= jt.search_depth
    np.testing.assert_array_equal(tt.batch.row_valid.numpy(),
                                  _np(jt.batch.row_valid))
    for n, c in tt.batch.columns.items():
        jcol = jt.batch.columns[n]
        np.testing.assert_array_equal(c.data.numpy(), _np(jcol.data))
        np.testing.assert_array_equal(c.mask.numpy(), _np(jcol.mask))


@pytest.mark.parametrize("radix_bits", [None, 0, 6])
@pytest.mark.parametrize("kind", ["unique", "dup", "half_dead",
                                  "all_null"])
@pytest.mark.parametrize("n", [512, 4096])
def test_build_table_matches_reference(kind, radix_bits, n):
    """Every BuildTable field: sorted hashes, second hashes, bucket
    offsets clipped at the first dead row, run lengths, the live count,
    the layout flag and the permuted build rows; k = 0 and k > 0."""
    rng = np.random.default_rng(n + len(kind))
    cols, rv = _build_cols(rng, n, kind)
    jbatch, tbatch = _both(cols, rv)
    jt = jj.build_for_backend(jbatch, ("bk",), radix_bits)
    tt = tj.build_for_backend(tbatch, ("bk",), radix_bits)
    _assert_table_equal(jt, tt)
    assert tt.unique_runs == (kind != "dup")


@pytest.mark.parametrize("k", [1, 6, 12])
def test_bucket_starts_are_lower_bounds_of_bucket_bounds(k):
    """K4 computes each bucket's start as the lower bound of the
    bucket's smallest hash (`_partition_bounds_np`) in the sorted
    hashes; the plain version (the reference's CPU branch) as the
    prefix sum of the bucket histogram. Over sorted hashes with a dead
    tail both give the same offsets."""
    rng = np.random.default_rng(k)
    cols, rv = _build_cols(rng, 4096, "half_dead")
    _, tbatch = _both(cols, rv)
    h, _, _ = tj._hash_batch(tbatch, ("bk",))
    sh = torch.sort(h, stable=True).values
    part_starts, _, stats = tj.build_meta_plain(sh, k)
    bounds = torch.from_numpy(tj._partition_bounds_np(k))
    lb = torch.clamp(torch.searchsorted(sh, bounds), max=int(stats[0]))
    assert torch.equal(lb, part_starts[:-1])
    assert int(part_starts[-1]) == int(stats[0]) == 2048


def test_two_key_build_matches_reference():
    """Q5's two-key build shape: (custkey, nationkey)."""
    rng = np.random.default_rng(5)
    cols, rv = _build_cols(rng, 2048, "dup", two_keys=True)
    jbatch, tbatch = _both(cols, rv)
    _assert_table_equal(jj.build_for_backend(jbatch, ("bk", "bk2")),
                        tj.build_for_backend(tbatch, ("bk", "bk2")))


def _probe_cols(rng, n, build_cols, two_keys=False):
    """Probe keys: about half drawn from the build's keys, the rest
    fresh, with NULLs and dead rows."""
    bk, bm, _ = build_cols["bk"]
    pick = rng.integers(0, len(bk), n)
    fresh = rng.integers(-(1 << 40), 1 << 40, n)
    take = rng.random(n) < 0.6
    cols = {"pk": (np.where(take, bk[pick], fresh),
                   np.where(take, bm[pick], rng.random(n) < 0.9),
                   "bigint"),
            "pv": (rng.integers(0, 100, n), rng.random(n) < 0.9,
                   "bigint")}
    if two_keys:
        b2, m2, _ = build_cols["bk2"]
        cols["pk2"] = (np.where(take, b2[pick], 1).astype(np.int32),
                       np.where(take, m2[pick], True), "integer")
    return cols, rng.random(n) < 0.9


def _live_rows(batch, names):
    rv = _np(batch.row_valid)
    out = []
    for i in np.flatnonzero(rv):
        row = []
        for n in names:
            c = batch.columns[n]
            m = bool(_np(c.mask)[i])
            row.append(_np(c.data)[i].item() if m else None)
        out.append(tuple(row))
    return out


@pytest.mark.parametrize("verify", ["hash", "full"])
@pytest.mark.parametrize("join_type", ["inner", "left"])
@pytest.mark.parametrize("kind", ["unique", "dup", "half_dead"])
def test_probe_join_matches_reference(kind, join_type, verify):
    """The candidate search (lo_enc) and the joined rows, aligned
    layout for unique builds and general layout for duplicate ones, in
    the reference's row order."""
    rng = np.random.default_rng(17 + len(kind))
    bcols, brv = _build_cols(rng, 2048, kind)
    pcols, prv = _probe_cols(rng, 4096, bcols)
    jbuild, tbuild = _both(bcols, brv)
    jprobe, tprobe = _both(pcols, prv)
    jt = jj.build_for_backend(jbuild, ("bk",))
    tt = tj.build_for_backend(tbuild, ("bk",))
    h, h2 = jj._hash_jit(jprobe, ("pk",))
    jlo = jj._search_jit(jt, h, h2, verify)
    tlo, th2 = tj.probe_search(tt, tprobe, ("pk",), verify)
    np.testing.assert_array_equal(tlo.numpy(), _np(jlo))
    if tt.unique_runs and verify == "hash":
        assert th2 is None  # the search already held hash2
    else:
        np.testing.assert_array_equal(th2.numpy(), _np(h2))
    cap = 4096 if kind != "dup" else 4096 * 16
    args = (("pk",), cap, join_type, ("pk", "pv"), ("bk", "bv"), ("bk",),
            verify)
    jout, jovf, jtot = jj.probe_join(jt, jprobe, *args)
    tout, tovf, ttot = tj.probe_join(tt, tprobe, *args)
    assert bool(tovf) == bool(jovf) and int(ttot) == int(jtot)
    names = ("pk", "pv", "bk", "bv")
    assert _live_rows(tout, names) == _live_rows(jout, names)


def test_probe_overflow_flag_matches_reference():
    """A duplicate-key probe into too small a capacity: both flag the
    overflow on the device."""
    rng = np.random.default_rng(23)
    bcols, brv = _build_cols(rng, 2048, "dup")
    pcols, prv = _probe_cols(rng, 1024, bcols)
    jbuild, tbuild = _both(bcols, brv)
    jprobe, tprobe = _both(pcols, prv)
    args = (("pk",), 1024, "inner", ("pk",), ("bv",), ("bk",), "hash")
    _, jovf, _ = jj.probe_join(jj.build_for_backend(jbuild, ("bk",)),
                               jprobe, *args)
    _, tovf, _ = tj.probe_join(tj.build_for_backend(tbuild, ("bk",)),
                               tprobe, *args)
    assert bool(jovf) and bool(tovf)


def test_two_key_probe_and_counts_match_reference():
    rng = np.random.default_rng(29)
    bcols, brv = _build_cols(rng, 2048, "dup", two_keys=True)
    pcols, prv = _probe_cols(rng, 2048, bcols, two_keys=True)
    jbuild, tbuild = _both(bcols, brv)
    jprobe, tprobe = _both(pcols, prv)
    jt = jj.build_for_backend(jbuild, ("bk", "bk2"))
    tt = tj.build_for_backend(tbuild, ("bk", "bk2"))
    for j, t in zip(jj.probe_counts(jt, jprobe, ("pk", "pk2")),
                    tj.probe_counts(tt, tprobe, ("pk", "pk2"))):
        np.testing.assert_array_equal(t.numpy(), _np(j))


# -- dynamic filters ------------------------------------------------------


@pytest.mark.parametrize("dtype,distinct", [(np.int64, 100),
                                            (np.int64, 6000),
                                            (np.int32, 50),
                                            (np.float64, 300)])
def test_dynamic_filter_matches_reference(dtype, distinct):
    """bounds_step over two batches, distinct_set (fits / overflows
    DF_SET_MAX) and apply_filter on a probe batch."""
    rng = np.random.default_rng(distinct)
    n = 8192
    state_j = jdf.bounds_init(np.dtype(dtype))
    state_t = tdf.bounds_init(_t(np.zeros(1, dtype)).dtype, CPU)
    parts = []
    for _ in range(2):
        d = rng.integers(-distinct, distinct, n).astype(dtype)
        if dtype == np.float64:
            d[:3] = [np.nan, -0.0, 0.0]
        m = rng.random(n) < 0.9
        parts.append((d, m))
        state_j = jdf.bounds_step(state_j, jnp.asarray(d), jnp.asarray(m))
        state_t = tdf.bounds_step(state_t, _t(d), _t(m))
    for a, b in zip(state_t, state_j):
        assert a.item() == _np(b).item()
    d = np.concatenate([p[0] for p in parts])
    m = np.concatenate([p[1] for p in parts])
    jv, jn, jo = jdf.distinct_set(jnp.asarray(d), jnp.asarray(m))
    tv, tn, to = tdf.distinct_set(_t(d), _t(m))
    assert int(tn) == int(jn) and bool(to) == bool(jo)
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    probe = rng.integers(-2 * distinct, 2 * distinct, n).astype(dtype)
    pm = rng.random(n) < 0.9
    pcols = {"k": (probe, pm, {np.int64: "bigint", np.int32: "integer",
                               np.float64: "double"}[dtype])}
    jbatch, tbatch = _both(pcols, np.ones(n, bool))
    jf = jdf.DFilter(state_j[0], state_j[1], None if bool(jo)
                     else (jv, jn))
    tf = tdf.DFilter(state_t[0], state_t[1], None if bool(to)
                     else (tv, tn))
    np.testing.assert_array_equal(
        tdf.apply(tbatch, "k", tf).row_valid.numpy(),
        _np(jdf.apply(jbatch, "k", jf).row_valid))


def _skewed_build(rng, n):
    """A duplicate-key build with Q13's skew: one key holds a fifth of
    the rows, a few dozen keys hold 20-60 rows each, the rest 1-3."""
    k0 = np.concatenate([np.zeros(n // 5, np.int64),
                         np.repeat(np.arange(1, 41), rng.integers(20, 60, 40)),
                         rng.integers(100, 100 + n, n)])[:n]
    cols = {"bk": (rng.permutation(k0), rng.random(n) < 0.97, "bigint"),
            "bv": (rng.normal(0, 1, n), rng.random(n) < 0.9, "double")}
    return cols, np.ones(n, bool)


@pytest.mark.parametrize("verify", ["hash", "full"])
@pytest.mark.parametrize("join_type", ["inner", "left"])
@pytest.mark.parametrize("kind", ["dup", "skewed"])
def test_expand_at_the_capacity_limit_matches_reference(kind, join_type,
                                                        verify):
    """The plain general expand on duplicate and skewed builds, at the
    exact capacity the probe needs (no overflow) and one slot below it
    (overflow): the same rows, flag and live count as the reference."""
    rng = np.random.default_rng(43 + len(kind) + len(join_type))
    if kind == "skewed":
        bcols, brv = _skewed_build(rng, 2048)
    else:
        bcols, brv = _build_cols(rng, 2048, "dup")
    pcols, prv = _probe_cols(rng, 1024, bcols)
    jbuild, tbuild = _both(bcols, brv)
    jprobe, tprobe = _both(pcols, prv)
    jt = jj.build_for_backend(jbuild, ("bk",))
    tt = tj.build_for_backend(tbuild, ("bk",))
    _, _, counts, _ = tj.probe_counts(tt, tprobe, ("pk",))
    emit = counts if join_type == "inner" else torch.where(
        tprobe.row_valid, torch.clamp(counts, min=1), torch.zeros_like(counts))
    need = int(emit.sum())
    assert need > 2 * 1024
    names = ("pk", "pv", "bk", "bv")
    for cap, overflows in ((need, False), (need - 1, True)):
        args = (("pk",), cap, join_type, ("pk", "pv"), ("bk", "bv"),
                ("bk",), verify)
        jout, jovf, jtot = jj.probe_join(jt, jprobe, *args)
        tout, tovf, ttot = tj.probe_join(tt, tprobe, *args)
        assert bool(tovf) == bool(jovf) == overflows
        assert int(ttot) == int(jtot)
        assert _live_rows(tout, names) == _live_rows(jout, names)
