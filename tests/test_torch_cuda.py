"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here is marked `cuda` and skips
unless an NVIDIA GPU of compute capability >= 9.0 is present; this file
imports no JAX, so on a machine without it run

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(tests/conftest.py sets up the JAX reference and imports jax).

Tolerances: compact (K2) exactly — the row order is the result;
direct_slot_reduce (K1) integers exactly and float64 to a relative
1e-9, because atomics add in a run-dependent order.
"""

import numpy as np
import pytest
import torch

from presto_tpu_torch import batch as tb
from presto_tpu_torch import interop
from presto_tpu_torch import types as tt
from presto_tpu_torch.ops import hashagg as th
from torch_fragment_cases import CASES as FRAGMENT_CASES

pytestmark = pytest.mark.cuda


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() \
            or torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs an NVIDIA GPU of compute capability >= 9.0 "
                    "(the CUDA kernels do not run on the CPU)")
    return torch.device("cuda")


def _aggs():
    return [th.make_sum(tt.DOUBLE, tt.DOUBLE), th.make_sum(tt.BIGINT,
                                                           tt.BIGINT),
            th.make_min(tt.DOUBLE), th.make_max(tt.BIGINT),
            th.make_min(tt.INTEGER), th.make_avg(tt.DOUBLE),
            th.make_count(None)]


_INPUT_DTYPES = [np.float64, np.int64, np.float64, np.int64, np.int32,
                 np.float64, None]


@pytest.mark.parametrize("domains", [(), (3, 2), (255, 255)],
                         ids=["global", "q1_keys", "global_atomics"])
def test_k1_matches_plain(hopper, domains):
    """(255, 255) = 65,536 slots: too large for the shared-memory
    table, so the kernel updates the state with global atomics."""
    rng = np.random.default_rng(3)
    n = 1 << 20
    num_slots = int(np.prod([d + 1 for d in domains])) if domains else 1
    aggs = _aggs()
    row_valid = rng.random(n) < 0.8
    keys = [(rng.integers(0, d, n).astype(np.int32), rng.random(n) < 0.9)
            for d in domains]
    inputs = [None if dt is None else
              (rng.normal(100.0, 50.0, n) if dt == np.float64
               else rng.integers(-10_000, 10_000, n).astype(dt))
              for dt in _INPUT_DTYPES]
    weights = [row_valid & (rng.random(n) < 0.85) for _ in aggs]
    states = {}
    for dev in (torch.device("cpu"), hopper):
        def t(x):
            return torch.from_numpy(np.array(x)).to(dev)
        st = th.direct_init(aggs, num_slots, dev)
        th.direct_step(st, t(row_valid), [(t(c), t(m)) for c, m in keys],
                       domains, [None if x is None else t(x)
                                 for x in inputs],
                       [t(w) for w in weights], aggs)
        states[dev.type] = st
    torch.cuda.synchronize()
    cpu, gpu = states["cpu"], states["cuda"]
    assert torch.equal(cpu.present, gpu.present.cpu())
    for cc, gc in zip(cpu.states, gpu.states):
        for a, b in zip(cc, gc):
            if a.is_floating_point():
                torch.testing.assert_close(b.cpu(), a, rtol=1e-9, atol=0)
            else:
                assert torch.equal(a, b.cpu())


def _batch(live_frac, cap, device):
    rng = np.random.default_rng(5)
    cols = {
        "a": (rng.integers(-1 << 40, 1 << 40, cap), rng.random(cap) < 0.9,
              "bigint", None),
        "b": (rng.normal(0, 1, cap), rng.random(cap) < 0.9, "double",
              None),
        "c": (rng.integers(0, 1 << 20, cap).astype(np.int32),
              rng.random(cap) < 0.9, "integer", None),
        "s": (rng.integers(0, 3, cap).astype(np.int32),
              rng.random(cap) < 0.9, "varchar", ("x", "y", "z")),
        "f": (rng.random(cap) < 0.5, rng.random(cap) < 0.9, "boolean",
              None),
    }
    return interop.batch_from_numpy(cols, rng.random(cap) < live_frac,
                                    device)


@pytest.mark.parametrize("cap", [1000, 1 << 20])
@pytest.mark.parametrize("live_frac", [0.0, 0.02, 0.98, 1.0])
def test_k2_matches_plain(hopper, live_frac, cap):
    gpu = _batch(live_frac, cap, hopper)
    cpu = _batch(live_frac, cap, torch.device("cpu"))
    out_cap = tb.operator_capacity(int(cpu.row_valid.sum()))
    cases = [(tb.compact_full(gpu), tb.compact_full_plain(cpu))]
    if out_cap < cap:
        cases.append((tb.compact_shrink(gpu, out_cap),
                      tb.compact_shrink_plain(cpu, out_cap)))
    for got, want in cases:
        assert torch.equal(got.row_valid.cpu(), want.row_valid)
        for n in want.names:
            assert torch.equal(got.columns[n].data.cpu(),
                               want.columns[n].data)
            assert torch.equal(got.columns[n].mask.cpu(),
                               want.columns[n].mask)


@pytest.mark.parametrize("ncols", [64, 65, 131])
def test_k2_takes_more_than_64_columns(hopper, ncols):
    """A batch wider than one launch's 64 columns (an array's slot
    columns) compacts over several launches, equal to the plain
    version, full and shrunk."""
    rng = np.random.default_rng(ncols)
    cap = 5000
    cols = {f"c{i}": (rng.integers(-99, 99, cap).astype(
        (np.int64, np.int32, np.int16)[i % 3]), rng.random(cap) < 0.8,
        ("bigint", "integer", "smallint")[i % 3], None)
        for i in range(ncols)}
    valid = rng.random(cap) < 0.3
    gpu = interop.batch_from_numpy(cols, valid, hopper)
    cpu = interop.batch_from_numpy(cols, valid, torch.device("cpu"))
    out_cap = tb.operator_capacity(int(valid.sum()))
    before = tb.COMPACT_KERNEL.launches
    cases = [(tb.compact_full(gpu), tb.compact_full_plain(cpu)),
             (tb.compact_shrink(gpu, out_cap),
              tb.compact_shrink_plain(cpu, out_cap))]
    assert tb.COMPACT_KERNEL.launches == before + 2 * -(-ncols // 64)
    for got, want in cases:
        assert torch.equal(got.row_valid.cpu(), want.row_valid)
        for n in want.names:
            assert torch.equal(got.columns[n].data.cpu(),
                               want.columns[n].data)
            assert torch.equal(got.columns[n].mask.cpu(),
                               want.columns[n].mask)


def test_kernels_count_their_launches(hopper):
    b = _batch(0.5, 4096, hopper)
    before = tb.COMPACT_KERNEL.launches
    tb.compact_full(b)
    assert tb.COMPACT_KERNEL.launches == before + 1
    before = th.SLOT_REDUCE_KERNEL.launches
    st = th.direct_init([th.make_count(None)], 1, hopper)
    th.direct_step(st, b.row_valid, [], (), [None], [b.row_valid],
                   [th.make_count(None)])
    assert th.SLOT_REDUCE_KERNEL.launches == before + 1
    assert int(st.states[0][0][0]) == int(b.row_valid.sum())


def test_wrappers_reject_strided_input(hopper):
    b = _batch(0.5, 4096, hopper)
    strided = tb.Batch({"a": tb.Column(b.columns["a"].data[::2],
                                       b.columns["a"].mask[::2],
                                       b.columns["a"].type)},
                       b.row_valid[::2])
    with pytest.raises(ValueError):
        tb.compact_full(strided)


# -- K3-K6: the join and sort-aggregation kernels ----------------------
#
# Tolerances: K3, K4 and K5 exactly (hashes, offsets and slots are
# integers); K6 exactly for first rows, group counts, overflow and integer
# components, float64 components to a relative 1e-9 (the kernel sums a
# group in a lane-strided tree order, the plain version in row order).

from presto_tpu_torch.ops import common as tc  # noqa: E402
from presto_tpu_torch.ops import join as tj  # noqa: E402


def _key_columns(rng, n, dev, nkeys, dup=None):
    """Key columns of several dtypes with NULLs, negative values,
    INT64_MIN, -0.0 and NaN; `dup` draws the first key from that many
    values, for duplicate-key builds."""
    i64 = rng.integers(-(1 << 62), 1 << 62, n) if dup is None \
        else rng.integers(-dup, dup, n)
    i64[:4] = [np.iinfo(np.int64).min, -1, 0, 1]
    f64 = rng.normal(0, 1e6, n)
    f64[:4] = [-0.0, 0.0, np.nan, np.inf]
    cols = [i64.astype(np.int64), f64, rng.integers(-1000, 1000, n)
            .astype(np.int32), rng.random(n) < 0.5,
            rng.integers(-300, 300, n).astype(np.int16)]
    keys = []
    for d in cols[:nkeys]:
        keys.append((torch.from_numpy(d).to(dev),
                     torch.from_numpy(rng.random(n) < 0.9).to(dev)))
    return keys


@pytest.mark.parametrize("nkeys", [1, 2, 3, 5])
@pytest.mark.parametrize("nulls_invalid", [True, False])
def test_k3_row_hash_matches_plain(hopper, nkeys, nulls_invalid):
    rng = np.random.default_rng(11)
    n = (1 << 20) + 3
    keys = _key_columns(rng, n, hopper, nkeys)
    rv = torch.from_numpy(rng.random(n) < 0.7).to(hopper)
    before = tc.ROW_HASH_KERNEL.launches
    h, h2 = tc.row_hash_pair(keys, rv, nulls_invalid)
    assert tc.ROW_HASH_KERNEL.launches == before + 1
    ph, ph2 = tc.row_hash_pair_plain(keys, rv, nulls_invalid)
    torch.cuda.synchronize()
    assert torch.equal(h, ph) and torch.equal(h2, ph2)


def _build_batch(rng, n, live, dev, dup=None, nkeys=1):
    keys = _key_columns(rng, n, dev, nkeys, dup)
    cols = {f"k{i}": tb.Column(d, m, tt.BIGINT if d.dtype == torch.int64
                               else tt.DOUBLE if d.dtype == torch.float64
                               else tt.INTEGER, None)
            for i, (d, m) in enumerate(keys[:2])}
    cols["v"] = tb.Column(torch.arange(n, device=dev),
                          torch.ones(n, dtype=torch.bool, device=dev),
                          tt.BIGINT, None)
    rv = torch.zeros(n, dtype=torch.bool, device=dev)
    rv[:live] = True
    return tb.Batch(cols, rv)


@pytest.mark.parametrize("k", [0, 5, 18])
@pytest.mark.parametrize("dup,live_frac", [(None, 1.0), (None, 0.5),
                                           (5000, 0.37), (3, 1.0),
                                           (None, 0.0)],
                         ids=["unique", "half_dead", "dup", "few_keys",
                              "all_dead"])
def test_k4_join_build_matches_plain(hopper, k, dup, live_frac):
    rng = np.random.default_rng(12)
    n = 1 << 20
    b = _build_batch(rng, n, int(n * live_frac), hopper, dup)
    h, _, _ = tj._hash_batch(b, ("k0",))
    sh, _ = torch.sort(h, stable=True)
    before = tj.JOIN_BUILD_KERNEL.launches
    got = tj.build_meta(sh, k)
    assert tj.JOIN_BUILD_KERNEL.launches == before + 1
    want = tj.build_meta_plain(sh, k)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("verify", ["hash", "full"])
@pytest.mark.parametrize("dup,nkeys,live", [(None, 1, 0.6), (2000, 1, 0.6),
                                            (None, 2, 0.6), (50, 2, 0.6),
                                            (None, 1, 0.0)],
                         ids=["unique", "dup", "two_keys", "two_keys_dup",
                              "empty_build"])
def test_k5_join_probe_matches_plain(hopper, verify, dup, nkeys, live):
    rng = np.random.default_rng(13)
    nb, npr = 1 << 18, 1 << 20
    build = _build_batch(rng, nb, int(nb * live), hopper, dup, nkeys)
    names = tuple(f"k{i}" for i in range(nkeys))
    table = tj.build_for_backend(build, names)
    # probe keys: half drawn from the build's, half fresh
    probe = _build_batch(rng, npr, int(npr * 0.9), hopper, dup, nkeys)
    pick = torch.from_numpy(rng.integers(0, nb, npr)).to(hopper)
    take = torch.from_numpy(rng.random(npr) < 0.5).to(hopper)
    for nm in names:
        pc, bc = probe.columns[nm], build.columns[nm]
        pc.data = torch.where(take, bc.data[pick], pc.data)
        pc.mask = torch.where(take, bc.mask[pick], pc.mask)
    before = tj.JOIN_PROBE_KERNEL.launches
    lo, h2 = tj.probe_search(table, probe, names, verify)
    assert tj.JOIN_PROBE_KERNEL.launches == before + 1
    plo, ph2 = tj.probe_search_plain(table, probe, names, verify)
    torch.cuda.synchronize()
    assert torch.equal(lo, plo)
    # hash2 comes back only where the search did not already check it
    assert (h2 is None) == (ph2 is None) == (table.unique_runs
                                            and verify == "hash")
    assert h2 is None or torch.equal(h2, ph2)
    matches = int((lo >= 0).sum())
    assert matches > npr // 8 if live else matches == 0


@pytest.mark.parametrize("ngroups,out_cap,live", [(150_000, 1 << 18, 0.8),
                                                  (40, 64, 0.8),
                                                  (5000, 1024, 0.8),
                                                  (3, 16, 0.8),
                                                  (100, 128, 0.0)],
                         ids=["q13_like", "few_groups", "overflow",
                              "long_segments", "all_dead"])
def test_k6_segment_reduce_matches_plain(hopper, ngroups, out_cap, live):
    rng = np.random.default_rng(14)
    n = 1 << 21
    kv = rng.integers(0, ngroups, n)
    keys = [(torch.from_numpy(kv).to(hopper),
             torch.from_numpy(rng.random(n) < 0.95).to(hopper)),
            (torch.from_numpy((kv % 7).astype(np.int32)).to(hopper),
             torch.ones(n, dtype=torch.bool, device=hopper))]
    valid = torch.from_numpy(rng.random(n) < live).to(hopper)
    h1, h2 = tc.row_hash_pair(keys, valid, False)
    perm = tc.lex_perm([h1, h2])
    skeys = [(d[perm], m[perm]) for d, m in keys]
    comps = [(torch.from_numpy(rng.normal(0, 100, n)).to(hopper), "sum"),
             (torch.from_numpy(rng.integers(-5, 5, n)).to(hopper), "sum"),
             (torch.from_numpy(rng.integers(-9, 9, n).astype(np.int32))
              .to(hopper), "min"),
             (torch.from_numpy(rng.normal(0, 1, n)).to(hopper), "max")]
    scomps = [(c[perm], r) for c, r in comps]
    args = (h1[perm], h2[perm], skeys, valid[perm], scomps, out_cap)
    before = th.SEGMENT_REDUCE_KERNEL.launches
    got = th.segment_reduce(*args)
    assert th.SEGMENT_REDUCE_KERNEL.launches == before + 1
    want = th.segment_reduce_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    for (g, (c, _)), w in zip(zip(got[0], comps), want[0]):
        if g.is_floating_point():
            torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-9)
        else:
            assert torch.equal(g, w)
    assert bool(got[3]) == (int(want[2]) > out_cap)


@pytest.mark.parametrize("ngroups,out_cap,live", [(150_000, 1 << 18, 0.8),
                                                  (5000, 1024, 0.8),
                                                  (100, 128, 0.0)],
                         ids=["q13_like", "overflow", "all_dead"])
def test_k6_segments_match_plain(hopper, ngroups, out_cap, live):
    """K6's segments (each group's first row, the stats) equal those of
    its plain version, which K30's plain version reads."""
    rng = np.random.default_rng(16)
    n = 1 << 20
    keys = [(torch.from_numpy(rng.integers(0, ngroups, n)).to(hopper),
             torch.from_numpy(rng.random(n) < 0.95).to(hopper))]
    valid = torch.from_numpy(rng.random(n) < live).to(hopper)
    h1, h2 = tc.row_hash_pair(keys, valid, False)
    perm = tc.lex_perm([h1, h2])
    args = (h1[perm], h2[perm], [(d[perm], m[perm]) for d, m in keys],
            valid[perm], [], out_cap)
    got, want = [], []
    th.segment_reduce(*args, seg_out=got)
    th.segment_reduce_plain(*args, seg_out=want)
    torch.cuda.synchronize()
    assert torch.equal(got[0].stats, want[0].stats)
    known = min(int(want[0].groups), out_cap + 1)
    assert torch.equal(got[0].starts[:known], want[0].starts[:known])


def test_sort_aggregation_matches_cpu(hopper):
    """batch_aggregate (K3 + K25 + K26 + K6) on the card against the same
    inputs on the CPU, as group multisets."""
    rng = np.random.default_rng(15)
    n = 1 << 18
    aggs = [th.make_sum(tt.DOUBLE, tt.DOUBLE), th.make_count(None),
            th.make_min(tt.BIGINT)]
    kv = rng.integers(0, 20_000, n)
    val = rng.normal(0, 10, n)
    iv = rng.integers(-100, 100, n)
    rv = rng.random(n) < 0.9
    out = {}
    for dev in (torch.device("cpu"), hopper):
        def t(x):
            return torch.from_numpy(np.array(x)).to(dev)
        st = th.batch_aggregate(t(rv), [(t(kv), t(rv))],
                                [t(val), None, t(iv)], [t(rv)] * 3,
                                aggs, 1 << 15)
        v = st.valid.cpu().numpy()
        rows = sorted(zip(st.keys[0][0].cpu().numpy()[v].tolist(),
                          st.states[0][0].cpu().numpy()[v].tolist(),
                          st.states[1][0].cpu().numpy()[v].tolist(),
                          st.states[2][0].cpu().numpy()[v].tolist()))
        out[dev.type] = rows
    assert len(out["cpu"]) == len(out["cuda"])
    for a, b in zip(out["cpu"], out["cuda"]):
        assert a[0] == b[0] and a[2:] == b[2:]
        assert abs(a[1] - b[1]) <= 1e-9 * max(1.0, abs(a[1]))


# -- K7 semi_join, K8 stream_reduce, K9 join_expand --------------------------
#
# Tolerances: K7's keep mask exactly; K8's group counts, first rows, slot
# validity, keys, carry flags and integer components exactly, float64
# components to a relative 1e-9 (lane-strided tree order against row
# order); K9's liveness, masks, every value under a set mask, the
# overflow flag and the live count exactly.


def _probe_like(rng, build, names, npr, dev, dup, nkeys, take_frac=0.5):
    """A probe batch whose keys are half drawn from the build's."""
    probe = _build_batch(rng, npr, int(npr * 0.9), dev, dup, nkeys)
    nb = build.capacity
    pick = torch.from_numpy(rng.integers(0, nb, npr)).to(dev)
    take = torch.from_numpy(rng.random(npr) < take_frac).to(dev)
    for nm in names:
        pc, bc = probe.columns[nm], build.columns[nm]
        pc.data = torch.where(take, bc.data[pick], pc.data)
        pc.mask = torch.where(take, bc.mask[pick], pc.mask)
    return probe


@pytest.mark.parametrize("negate", [False, True], ids=["in", "not_in"])
@pytest.mark.parametrize("verify", ["hash", "full"])
@pytest.mark.parametrize("dup,nkeys,live", [(None, 1, 0.6), (2000, 1, 0.6),
                                            (3300, 1, 1.0), (50, 2, 0.6),
                                            (None, 1, 0.0), (2000, 1, 0.7)],
                         ids=["unique", "dup", "runs80", "two_keys_dup",
                              "empty_build", "collide"])
def test_k7_semi_join_matches_plain(hopper, verify, negate, dup, nkeys,
                                    live):
    rng = np.random.default_rng(16)
    nb, npr = 1 << 18, 1 << 20
    build = _build_batch(rng, nb, int(nb * live), hopper, dup, nkeys)
    names = tuple(f"k{i}" for i in range(nkeys))
    table = tj.build_for_backend(build, names)
    probe = _probe_like(rng, build, names, npr, hopper, dup, nkeys)
    if live == 0.7:
        # every duplicate run's first row a false candidate: the match
        # lies deeper in the run (as after a 64-bit collision)
        starts = table.run_len > 1
        table.hash2 = torch.where(starts, table.hash2 ^ 0x5DEECE66D,
                                  table.hash2)
        c = table.batch.columns["k0"]
        c.data = torch.where(starts, c.data + 7919, c.data)
    before = tj.SEMI_JOIN_KERNEL.launches
    got = tj.semi_mark(table, probe, names, names, verify, negate)
    assert tj.SEMI_JOIN_KERNEL.launches == before + 1
    want = tj.semi_mark_plain(table, probe, names, names, verify, negate)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    kept = int(want.sum())
    if not negate:
        assert 0 < kept < npr if live else kept == 0


def _stream_batch(rng, n, dev, dead, nkeys=2):
    """n rows in key order (nulls last), groups of 1-7 rows like
    lineitem by orderkey; dead rows at random, or in runs across the
    1024-row tile borders, or everywhere."""
    base = np.repeat(np.arange(n), rng.integers(1, 8, n))[:n]
    k0 = (base // 5).astype(np.int64)
    m0 = base < base.max()
    k1 = (base % 5).astype(np.int32)
    m1 = k1 != 4
    rv = rng.random(n) < 0.85
    if dead == "borders":
        for t in range(1024, n, 1024):
            rv[t - 40:t + 40] = False
    elif dead == "all":
        rv[:] = False

    def t(x):
        return torch.from_numpy(x).to(dev)
    keys = [(t(k0), t(m0)), (t(k1), t(m1))][:nkeys]
    aggs = [th.make_sum(tt.DOUBLE, tt.DOUBLE), th.make_min(tt.INTEGER),
            th.make_max(tt.DOUBLE)]
    inputs = [t(rng.normal(10, 5, n)),
              t(rng.integers(-50, 50, n).astype(np.int32)),
              t(rng.normal(0, 1, n))]
    weights = [t(rv & (rng.random(n) < 0.9)) for _ in aggs]
    contribs = th._make_contribs(aggs, inputs, weights, [False] * 3)
    return t(rv), keys, contribs, aggs


def _assert_states_close(got, want, live):
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            if g.is_floating_point():
                torch.testing.assert_close(g[live], w[live], rtol=1e-9,
                                           atol=1e-9)
            else:
                assert torch.equal(g[live], w[live])


@pytest.mark.parametrize("dead,nkeys,out_cap", [
    ("random", 2, 1 << 20), ("borders", 2, 1 << 20), ("all", 2, 1 << 20),
    ("random", 1, 1 << 20), ("random", 2, 4096)],
    ids=["q18_like", "tile_borders", "all_dead", "one_key", "overflow"])
def test_k8_presorted_reduce_matches_plain(hopper, dead, nkeys, out_cap):
    rng = np.random.default_rng(17)
    n = 1 << 20
    rv, keys, contribs, aggs = _stream_batch(rng, n, hopper, dead, nkeys)
    before = th.STREAM_REDUCE_KERNEL.launches
    got = th.presorted_reduce(rv, keys, contribs, aggs, out_cap)
    assert th.STREAM_REDUCE_KERNEL.launches == before + 1
    want = th.presorted_reduce_plain(rv, keys, contribs, aggs, out_cap)
    torch.cuda.synchronize()
    assert torch.equal(got.valid, want.valid)
    assert bool(got.overflow) == bool(want.overflow) \
        == (out_cap < 1 << 20 and dead != "all")
    for (gd, gm), (wd, wm) in zip(got.keys, want.keys):
        assert torch.equal(gm, wm) and torch.equal(gd, wd)
    _assert_states_close(got.states, want.states,
                         torch.ones_like(want.valid))


@pytest.mark.parametrize("carry_kind", ["same", "differs", "none", "null"])
@pytest.mark.parametrize("dead", ["random", "all"])
def test_k8_stream_step_matches_plain(hopper, carry_kind, dead):
    """One streaming round on the card: the carry folds into slot 0
    (same keys), is emitted on its own (different keys), is absent, or
    has NULL keys; an all-dead batch passes the carry through."""
    rng = np.random.default_rng(18)
    n = 1 << 20
    rv, keys, contribs, aggs = _stream_batch(rng, n, hopper, dead)
    carry = th.init_state([tt.BIGINT, tt.INTEGER], aggs, 1, hopper)
    if carry_kind != "none":
        first = int(torch.nonzero(rv)[0]) if dead != "all" else 0
        for (cd, cm), (d, m) in zip(carry.keys, keys):
            cd[0] = d[first] - (1 if carry_kind == "differs" else 0)
            cm[0] = carry_kind != "null"
        for st in carry.states:
            for a in st:
                a[0] = 3 if not a.is_floating_point() else 2.5
        carry.valid[0] = True
    before = th.STREAM_REDUCE_KERNEL.launches
    got = th.stream_step(carry, rv, keys, contribs, aggs, 1 << 20)
    assert th.STREAM_REDUCE_KERNEL.launches == before + 1
    want = th.stream_fold_plain(
        carry, th.presorted_reduce_plain(rv, keys, contribs, aggs, 1 << 20),
        aggs)
    torch.cuda.synchronize()
    (g_ce, g_em, g_co, g_last), (w_ce, w_em, w_co, w_last) = got, want
    assert torch.equal(g_ce.valid, w_ce.valid)
    assert int(g_last) == int(w_last)
    assert torch.equal(g_em.valid, w_em.valid)
    live = w_em.valid
    for (gd, gm), (wd, wm) in zip(g_em.keys, w_em.keys):
        assert torch.equal(gm[live], wm[live]) and torch.equal(gd[live],
                                                               wd[live])
    _assert_states_close(g_em.states, w_em.states, live)
    assert torch.equal(g_co.valid, w_co.valid)
    for (gd, gm), (wd, wm) in zip(g_co.keys, w_co.keys):
        assert torch.equal(gm, wm) and torch.equal(gd, wd)
    _assert_states_close(g_co.states, w_co.states,
                         torch.ones(1, dtype=torch.bool, device=hopper))
    if dead != "all" and carry_kind != "none":
        assert bool(w_ce.valid[0]) == (carry_kind != "same")


def _assert_expand_equal(got, want, names):
    (gb, govf, glive), (wb, wovf, wlive) = got, want
    assert bool(govf) == bool(wovf)
    assert int(glive) == int(wlive) == int(wb.row_valid.sum())
    assert torch.equal(gb.row_valid, wb.row_valid)
    for nm in names:
        g, w = gb.columns[nm], wb.columns[nm]
        assert torch.equal(g.mask, w.mask), nm
        assert torch.equal(g.data[w.mask], w.data[w.mask]), nm


@pytest.mark.parametrize("join_type", ["inner", "left", "full"])
@pytest.mark.parametrize("verify", ["hash", "full"])
@pytest.mark.parametrize("layout", ["aligned", "general_dup",
                                    "general_skewed", "general_unique",
                                    "overflow", "q13_shape"])
def test_k9_join_expand_matches_plain(hopper, layout, verify, join_type):
    """Both layouts against the plain expand: the rows, the overflow
    flag (at the exact capacity the probe needs and one slot below) and
    the live count. q13_shape: 65,536 probe rows into 2,097,152 slots
    over a skewed duplicate-key build. A full join also sets the
    matched flags, compared exactly."""
    rng = np.random.default_rng(19)
    nb, npr = 1 << 18, 1 << 20
    dup = {"aligned": None, "general_unique": None,
           "general_dup": 20_000, "general_skewed": 3000,
           "overflow": 20_000, "q13_shape": 30_000}[layout]
    if layout == "q13_shape":
        nb, npr = 1 << 21, 1 << 16
    build = _build_batch(rng, nb, int(nb * 0.7), hopper, dup)
    if layout == "general_skewed":
        # one key holds a 500-row run
        c = build.columns["k0"]
        c.data[:500] = 7
    names = ("k0",)
    table = tj.build_for_backend(build, names)
    probe = _probe_like(rng, build, names, npr, hopper, dup, 1,
                        take_frac=0.9 if layout == "q13_shape" else 0.5)
    lo_enc, h2 = tj.probe_search(table, probe, names, verify)
    probe_out, build_out = ("k0", "v"), ("k0", "v")
    build_out_names = tuple(f"b_{x}" for x in build_out)
    table.batch = tb.Batch({**table.batch.columns,
                            **{f"b_{x}": table.batch.columns[x]
                               for x in build_out}}, table.batch.row_valid)
    found = lo_enc >= 0
    counts = torch.where(found, table.run_len[torch.clamp(lo_enc, min=0)],
                         torch.zeros_like(lo_enc))
    emit = counts if join_type == "inner" else torch.where(
        probe.row_valid, torch.clamp(counts, min=1), torch.zeros_like(counts))
    need = max(int(emit.sum()), 1)
    if layout == "aligned":
        caps = [npr]
    elif layout == "general_unique":
        caps = [2 * npr]
    elif layout == "q13_shape":
        caps = [1 << 21]
    else:
        caps = [need, need - 1] if layout == "overflow" else [need]
    for cap in caps:
        args = (table, probe, names, lo_enc, cap, join_type, probe_out,
                build_out_names, names, verify, h2)
        g_matched = w_matched = None
        if join_type == "full":
            g_matched = torch.zeros(nb, dtype=torch.bool, device=hopper)
            w_matched = torch.zeros(nb, dtype=torch.bool, device=hopper)
        before = tj.JOIN_EXPAND_KERNEL.launches
        got = tj._expand_from_enc(*args, g_matched)
        assert tj.JOIN_EXPAND_KERNEL.launches == before + 1
        want = tj.expand_plain(*args, w_matched)
        torch.cuda.synchronize()
        _assert_expand_equal(got, want, probe_out + build_out_names)
        if join_type == "full":
            assert torch.equal(g_matched, w_matched)
            assert 0 < int(w_matched.sum()) < nb
        if layout == "overflow":
            assert bool(got[1]) == (cap < need)


# -- K10 cross product, K11 outer tail, K6 with no aggregate -------------


def _side(rng, n, live, dev, prefix):
    """A compacted batch of `n` rows (the first `live` live) with a
    BIGINT, a DOUBLE, an INTEGER and a BOOLEAN column."""
    cols = {
        f"{prefix}a": tb.Column(
            torch.from_numpy(rng.integers(-1 << 40, 1 << 40, n)).to(dev),
            torch.from_numpy(rng.random(n) < 0.9).to(dev), tt.BIGINT),
        f"{prefix}b": tb.Column(
            torch.from_numpy(rng.normal(0, 1e6, n)).to(dev),
            torch.from_numpy(rng.random(n) < 0.8).to(dev), tt.DOUBLE),
        f"{prefix}c": tb.Column(
            torch.from_numpy(rng.integers(-9, 9, n).astype(np.int32))
            .to(dev), torch.ones(n, dtype=torch.bool, device=dev),
            tt.INTEGER),
        f"{prefix}d": tb.Column(
            torch.from_numpy(rng.random(n) < 0.5).to(dev),
            torch.from_numpy(rng.random(n) < 0.7).to(dev), tt.BOOLEAN)}
    rv = torch.zeros(n, dtype=torch.bool, device=dev)
    rv[:live] = True
    return tb.Batch(cols, rv)


def _assert_batches_equal(got, want):
    assert torch.equal(got.row_valid, want.row_valid)
    assert got.names == want.names
    for nm in want.names:
        g, w = got.columns[nm], want.columns[nm]
        assert torch.equal(g.mask, w.mask), nm
        assert torch.equal(g.data[w.mask], w.data[w.mask]), nm


@pytest.mark.parametrize("np_rows,probe_live,nb_rows,build_live,slots", [
    (8192, 6005, 256, 200, None), (65536, 50000, 16, 1, None),
    (4096, 3000, 16, 0, 16), (4096, 0, 16, 5, 16),
    (1024, 700, 64, 40, 1 << 16), (1 << 20, 1 << 20, 16, 16, 1 << 24)],
    ids=["q19_tiny", "nb_1", "empty_build", "empty_probe",
         "out_cap_larger", "full_capacity"])
def test_k10_cross_product_matches_plain(hopper, np_rows, probe_live,
                                         nb_rows, build_live, slots):
    """Every slot, live or not, against the plain cross product: Q19's
    shape at tiny (~1.2M live slots), a one-row build (Q11/Q22), empty
    sides, an output capacity past nb * np, and 2^24 slots."""
    from presto_tpu_torch.operators import misc_ops
    rng = np.random.default_rng(41)
    probe = _side(rng, np_rows, probe_live, hopper, "p_")
    build = _side(rng, nb_rows, build_live, hopper, "b_")
    out_cap = slots or tb.bucket_capacity(max(probe_live * build_live, 1))
    before = misc_ops.CROSS_PRODUCT_KERNEL.launches
    args = (probe, build, probe_live, build_live, out_cap)
    got = misc_ops.cross_product(*args)
    assert misc_ops.CROSS_PRODUCT_KERNEL.launches == before + 1
    want = misc_ops.cross_product_plain(*args)
    torch.cuda.synchronize()
    _assert_batches_equal(got, want)
    assert int(got.row_valid.sum()) == min(probe_live * build_live, out_cap)


@pytest.mark.parametrize("verify", ["hash", "full"])
@pytest.mark.parametrize("dup,live", [(None, 0.6), (2000, 0.6), (None, 0.0)],
                         ids=["unique", "dup", "all_dead"])
def test_k11_join_outer_matches_plain(hopper, dup, live, verify):
    """The FULL join's tail after a probe whose matched flags came from
    K9's full mode: liveness, the build masks, the NULL probe side and
    the device live count."""
    rng = np.random.default_rng(43)
    nb, npr = 1 << 18, 1 << 18
    build = _build_batch(rng, nb, int(nb * live), hopper, dup)
    names = ("k0",)
    table = tj.build_for_backend(build, names)
    probe = _probe_like(rng, build, names, npr, hopper, dup, 1)
    matched = torch.zeros(nb, dtype=torch.bool, device=hopper)
    tj.probe_join_full(table, probe, names, matched, 4 * npr, ("k0", "v"),
                       ("v",), names, verify)
    schema = (("p_k0", tt.BIGINT, None), ("p_v", tt.DOUBLE, None),
              ("p_s", tt.VARCHAR, ("a", "b")))
    before = tj.JOIN_OUTER_KERNEL.launches
    got, gcount = tj.unmatched_build(table, matched, schema, ("v",))
    assert tj.JOIN_OUTER_KERNEL.launches == before + 1
    want, wcount = tj.unmatched_build_plain(table, matched, schema, ("v",))
    torch.cuda.synchronize()
    _assert_batches_equal(got, want)
    for nm, _, _ in schema:
        assert not bool(got.columns[nm].mask.any())
        assert not bool(got.columns[nm].data.bool().any())
    assert int(gcount) == int(wcount) == int(want.row_valid.sum())
    if live:
        assert 0 < int(wcount) < int(nb * live)


@pytest.mark.parametrize("nkeys", [1, 2], ids=["fits", "overflows"])
def test_k6_with_no_aggregate_matches_plain(hopper, nkeys):
    """The DISTINCT step reaches K6 with zero state components: group
    count, first rows and overflow against the plain version (a second,
    nearly unique DOUBLE key overflows the slots)."""
    rng = np.random.default_rng(47)
    n, out_cap = 1 << 20, 1 << 19
    b = _build_batch(rng, n, int(n * 0.8), hopper, 200_000, nkeys)
    keys = [b.columns[f"k{i}"].astuple() for i in range(nkeys)]
    h1, h2 = tc.row_hash_pair(keys, b.row_valid, False)
    perm = tc.lex_perm([h1, h2])
    args = (h1[perm], h2[perm], [(d[perm], m[perm]) for d, m in keys],
            b.row_valid[perm], [], out_cap)
    before = th.SEGMENT_REDUCE_KERNEL.launches
    got = th.segment_reduce(*args)
    assert th.SEGMENT_REDUCE_KERNEL.launches == before + 1
    want = th.segment_reduce_plain(*args)
    torch.cuda.synchronize()
    assert got[0] == want[0] == []
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    assert bool(want[3]) == (nkeys == 2) == (int(want[2]) > out_cap)


def test_distinct_step_matches_plain(hopper):
    """DISTINCT's fold on the card (K3 + K25 + K26 + K6) against the same
    fold on the CPU: the same set of kept rows."""
    from presto_tpu_torch.ops import sort as tsort
    rng = np.random.default_rng(53)
    n = 1 << 20
    b = _build_batch(rng, n, int(n * 0.9), hopper, 30_000)
    k1 = torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)).to(hopper)
    b = tb.Batch({"k0": b.columns["k0"],
                  "k1": tb.Column(k1, k1 != 2, tt.INTEGER)}, b.row_valid)
    schema = [(k, c.type, None) for k, c in b.columns.items()]
    results = []
    for dev in (hopper, torch.device("cpu")):
        state = tsort.distinct_state(schema, 1 << 18, dev)
        batch = tb.Batch({k: tb.Column(c.data.to(dev), c.mask.to(dev),
                                       c.type) for k, c in
                          b.columns.items()}, b.row_valid.to(dev))
        out = tsort.distinct_step(state, batch)
        results.append(sorted(out.to_pylist(), key=repr))
    assert results[0] == results[1]
    assert 0 < len(results[0]) < 1 << 18


# -- K12: the generated fragment kernel --------------------------------

@pytest.mark.parametrize("cap", [1, 1023, 1024, 1025, (1 << 20) + 3])
@pytest.mark.parametrize("case", sorted(FRAGMENT_CASES))
def test_k12_fragment_matches_composed(hopper, case, cap):
    """One generated Triton kernel per lowered operation against the
    composed closures on the same CUDA batch: row_valid and masks
    exactly, every value under a set mask exactly (FMA contraction is
    off, float32 division rounds to nearest, integer // and % floor)."""
    from presto_tpu_torch.expr import codegen
    from torch_fragment_cases import (
        assert_batches_equal, port_batch, port_body,
    )
    body = port_body(case, hopper)
    batch = port_batch(cap, 11, hopper)
    before = codegen.COUNTER.launches
    got = body.kernel(batch)
    torch.cuda.synchronize()
    assert_batches_equal(got, body.plain(batch))
    assert codegen.COUNTER.launches == before + 1


from presto_tpu_torch.expr import ir as tir  # noqa: E402
from torch_fragment_cases import function_calls  # noqa: E402


@pytest.mark.parametrize("label", sorted(function_calls(tir, tt)))
def test_k12_every_function_matches_composed(hopper, label):
    """Every scalar function the compiler knows, as a one-stage K12,
    against its composed closure on the same CUDA batch, exactly: the
    CUDA math library's functions included, which PyTorch's CUDA
    kernels call too."""
    from presto_tpu_torch.operators.fused_fragment import make_chain_body
    from torch_fragment_cases import (
        assert_batches_equal, function_stage, port_batch,
    )
    body = make_chain_body([function_stage(
        function_calls(tir, tt)[label], hopper)])
    assert body.not_lowered is None
    batch = port_batch((1 << 16) + 3, 13, hopper)
    got = body.kernel(batch)
    torch.cuda.synchronize()
    assert_batches_equal(got, body.plain(batch))


# -- repairs: NaN in min / max (K1, K6, K8), width caps, REAL math -------
#
# Tolerances: min / max exactly (NaN equal to NaN); the splits past one
# launch's cap as the tests above (integers exactly, float64 sums to a
# relative 1e-9); REAL math to a relative 2**-20 (~8 float32 ulp), since
# K12 computes the float64 function and rounds once while PyTorch's
# float32 CUDA kernels call the float32 functions; the test also counts
# how many values agree bit for bit.


def _nan_data(rng, n, groups):
    ids = np.sort(rng.integers(0, groups, n))
    vals = rng.normal(0, 100, n)
    vals[rng.random(n) < 0.001] = np.nan
    vals[np.isin(ids, [3, 4])] = np.nan       # whole NaN groups
    return ids, vals


def _same_or_nan(a, b):
    a, b = a.cpu(), b.cpu()
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.equal(a[~torch.isnan(a)], b[~torch.isnan(b)])


@pytest.mark.parametrize("fn", ["min", "max"])
def test_nan_wins_in_k1_k6_k8(hopper, fn):
    rng = np.random.default_rng(61)
    n, groups = 1 << 18, 200
    ids, vals = _nan_data(rng, n, groups)
    agg = th.make_min(tt.DOUBLE) if fn == "min" else th.make_max(tt.DOUBLE)
    res = {}
    for dev in (torch.device("cpu"), hopper):
        rv = torch.ones(n, dtype=torch.bool, device=dev)
        x = torch.from_numpy(vals).to(dev)
        # K1: one dictionary-coded key of `groups` codes
        st = th.direct_init([agg], groups + 1, dev)
        th.direct_step(st, rv, [(torch.from_numpy(ids.astype(np.int32))
                                 .to(dev), rv)], (groups,), [x], [rv],
                       [agg])
        k1 = st.states[0][0][:groups]
        # K8: rows already sorted by the key
        keys = [(torch.from_numpy(ids).to(dev), rv)]
        k8 = th.presorted_reduce(rv, keys, [agg.init(x, rv)], [agg],
                                 1 << 10).states[0][0][:groups]
        # K6: hash-sorted grouping, back to key order
        gst = th._group_reduce(keys, rv, [agg.init(x, rv)], [agg], 1 << 10)
        order = torch.argsort(gst.keys[0][0][:groups])
        k6 = gst.states[0][0][:groups][order]
        res[dev.type] = (k1, k8, k6)
    torch.cuda.synchronize()
    for got, want in zip(res["cuda"], res["cpu"]):
        _same_or_nan(got, want)
        assert bool(torch.isnan(want[3])) and bool(torch.isnan(want[4]))


def test_k1_past_its_key_and_component_caps(hopper):
    """9 keys (the leading two folded into one code) and 65 components
    (two launches) against the plain version over all of them."""
    rng = np.random.default_rng(62)
    n = 1 << 18
    domains = (2, 1, 3, 1, 2, 1, 1, 2, 1)
    slots = int(np.prod([d + 1 for d in domains]))
    keys_np = [(rng.integers(0, d, n).astype(np.int32), rng.random(n) < 0.9)
               for d in domains]
    rv_np = rng.random(n) < 0.9
    ops = (["sum", "min", "max"] * 22)[:65]
    xs = [rng.normal(0, 10, n) for _ in ops]
    out = {}
    for dev in (torch.device("cpu"), hopper):
        def t(a):
            return torch.from_numpy(np.array(a)).to(dev)
        states = [torch.full((slots,), th._ident_for(o, torch.float64),
                             dtype=torch.float64, device=dev) for o in ops]
        present = torch.zeros(slots, dtype=torch.bool, device=dev)
        before = th.SLOT_REDUCE_KERNEL.launches
        th.direct_slot_reduce(t(rv_np), [(t(c), t(m)) for c, m in keys_np],
                              domains, [(t(x), s, o) for x, s, o in
                                        zip(xs, states, ops)], present)
        if dev.type == "cuda":
            assert th.SLOT_REDUCE_KERNEL.launches == before + 2
        out[dev.type] = (states, present)
    torch.cuda.synchronize()
    assert torch.equal(out["cuda"][1].cpu(), out["cpu"][1])
    for g, w, o in zip(out["cuda"][0], out["cpu"][0], ops):
        if o == "sum":
            torch.testing.assert_close(g.cpu(), w, rtol=1e-9, atol=1e-9)
        else:
            assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("nulls_invalid", [True, False])
def test_k3_past_its_key_cap(hopper, nulls_invalid):
    rng = np.random.default_rng(63)
    n = 1 << 18
    keys = _key_columns(rng, n, hopper, 5) + _key_columns(rng, n, hopper, 4)
    rv = torch.from_numpy(rng.random(n) < 0.9).to(hopper)
    before = tc.ROW_HASH_KERNEL.launches
    got = tc.row_hash_pair(keys, rv, nulls_invalid)
    assert tc.ROW_HASH_KERNEL.launches == before + 2
    want = tc.row_hash_pair_plain(keys, rv, nulls_invalid)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k6_past_its_component_cap(hopper):
    rng = np.random.default_rng(64)
    n = 1 << 18
    keys = [(torch.from_numpy(rng.integers(0, 5000, n)).to(hopper),
             torch.ones(n, dtype=torch.bool, device=hopper))]
    valid = torch.from_numpy(rng.random(n) < 0.9).to(hopper)
    h1, h2 = tc.row_hash_pair(keys, valid, False)
    perm = tc.lex_perm([h1, h2])
    sk = [(d[perm], m[perm]) for d, m in keys]
    comps = [(torch.from_numpy(rng.integers(-99, 99, n)).to(hopper)[perm],
              ["sum", "min", "max"][j % 3]) for j in range(65)]
    args = (h1[perm], h2[perm], sk, valid[perm], comps, 1 << 13)
    before = th.SEGMENT_REDUCE_KERNEL.launches
    got = th.segment_reduce(*args)
    assert th.SEGMENT_REDUCE_KERNEL.launches == before + 2
    want = th.segment_reduce_plain(*args)
    torch.cuda.synchronize()
    assert int(got[2]) == int(want[2])
    live = torch.arange(1 << 13, device=hopper) < want[2]
    assert torch.equal(got[1][live], want[1][live])
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g[live], w[live])


def test_k8_past_its_component_cap(hopper):
    rng = np.random.default_rng(65)
    rv, keys, _, _ = _stream_batch(rng, 1 << 18, hopper, "random", 2)
    aggs = [th.make_min(tt.BIGINT), th.make_max(tt.BIGINT),
            th.make_sum(tt.BIGINT, tt.BIGINT)] * 11          # 66 components
    contribs = [a.init(torch.from_numpy(rng.integers(-9, 9, 1 << 18))
                       .to(hopper), rv) for a in aggs]
    before = th.STREAM_REDUCE_KERNEL.launches
    got = th.presorted_reduce(rv, keys, contribs, aggs, 1 << 18)
    assert th.STREAM_REDUCE_KERNEL.launches == before + 2
    want = th.presorted_reduce_plain(rv, keys, contribs, aggs, 1 << 18)
    torch.cuda.synchronize()
    assert torch.equal(got.valid, want.valid)
    for gs, ws in zip(got.states, want.states):
        for g, w in zip(gs, ws):
            assert torch.equal(g[want.valid], w[want.valid])


def _wide(batch, name, k, prefix):
    """`batch` plus k aliases of column `name`."""
    cols = dict(batch.columns)
    for j in range(k):
        cols[f"{prefix}{j}"] = batch.columns[name]
    return tb.Batch(cols, batch.row_valid)


@pytest.mark.parametrize("join_type", ["inner", "full"])
def test_k9_past_its_column_cap(hopper, join_type):
    rng = np.random.default_rng(66)
    nb, npr = 1 << 14, 1 << 15
    build = _build_batch(rng, nb, int(nb * 0.7), hopper, 3000)
    names = ("k0",)
    table = tj.build_for_backend(build, names)
    table.batch = _wide(table.batch, "v", 64, "b_v")
    probe = _probe_like(rng, build, names, npr, hopper, 3000, 1)
    lo_enc, h2 = tj.probe_search(table, probe, names, "hash")
    build_out = tuple(f"b_v{j}" for j in range(64))
    args = (table, probe, names, lo_enc, 1 << 18, join_type, ("k0",),
            build_out, names, "hash", h2)
    gm = wm = None
    if join_type == "full":
        gm = torch.zeros(nb, dtype=torch.bool, device=hopper)
        wm = torch.zeros(nb, dtype=torch.bool, device=hopper)
    before = tj.JOIN_EXPAND_KERNEL.launches
    got = tj._expand_from_enc(*args, gm)
    assert tj.JOIN_EXPAND_KERNEL.launches == before + 2
    want = tj.expand_plain(*args, wm)
    torch.cuda.synchronize()
    _assert_expand_equal(got, want, ("k0",) + build_out)
    if join_type == "full":
        assert torch.equal(gm, wm)


def test_k10_past_its_column_cap(hopper):
    from presto_tpu_torch.operators import misc_ops
    rng = np.random.default_rng(67)
    probe = _wide(_side(rng, 4096, 3000, hopper, "p_"), "p_b", 30, "p_x")
    build = _wide(_side(rng, 16, 12, hopper, "b_"), "b_a", 30, "b_x")
    args = (probe, build, 3000, 12, 1 << 16)
    before = misc_ops.CROSS_PRODUCT_KERNEL.launches
    got = misc_ops.cross_product(*args)
    assert misc_ops.CROSS_PRODUCT_KERNEL.launches == before + 2
    want = misc_ops.cross_product_plain(*args)
    torch.cuda.synchronize()
    _assert_batches_equal(got, want)


def test_k11_past_its_column_cap(hopper):
    rng = np.random.default_rng(68)
    nb = 1 << 14
    build = _build_batch(rng, nb, int(nb * 0.6), hopper, None)
    names = ("k0",)
    table = tj.build_for_backend(build, names)
    probe = _probe_like(rng, build, names, nb, hopper, None, 1)
    matched = torch.zeros(nb, dtype=torch.bool, device=hopper)
    tj.probe_join_full(table, probe, names, matched, 4 * nb, ("k0", "v"),
                       ("v",), names, "hash")
    schema = tuple((f"p_{j}", tt.DOUBLE, None) for j in range(64))
    before = tj.JOIN_OUTER_KERNEL.launches
    got, gcount = tj.unmatched_build(table, matched, schema, ("v",))
    assert tj.JOIN_OUTER_KERNEL.launches == before + 2
    want, wcount = tj.unmatched_build_plain(table, matched, schema, ("v",))
    torch.cuda.synchronize()
    _assert_batches_equal(got, want)
    assert int(gcount) == int(wcount)


from torch_fragment_cases import real_function_calls  # noqa: E402


@pytest.mark.parametrize("label", sorted(real_function_calls(tir, tt)))
def test_k12_real_function_matches_composed(hopper, label):
    """REAL math as a one-stage K12 against the composed float32
    closure on the same CUDA batch (PyTorch's float32 CUDA kernels)."""
    from presto_tpu_torch.operators.fused_fragment import make_chain_body
    from torch_fragment_cases import port_batch, real_stage
    body = make_chain_body([real_stage(label, hopper)])
    assert body.not_lowered is None
    batch = port_batch((1 << 16) + 3, 13, hopper)
    got = body.kernel(batch)
    want = body.plain(batch)
    torch.cuda.synchronize()
    g, w = got.columns["o"], want.columns["o"]
    assert torch.equal(g.mask, w.mask)
    a, b = g.data[w.mask].cpu(), w.data[w.mask].cpu()
    exact = int(((a == b) | (torch.isnan(a) & torch.isnan(b))).sum())
    print(f"REAL {label}: {exact} of {a.numel()} bit-equal")
    torch.testing.assert_close(a, b, rtol=2.0 ** -20, atol=1e-37,
                               equal_nan=True)


# -- K13-K16: the window kernels -----------------------------------------
#
# Tolerances: K13, K15 and K16 exactly (positions, ranks, gathered
# values, min / max with NaN equal to NaN, masks); K14's counts and
# integer sums exactly, its float sums and averages to a relative 1e-9
# (both sides keep double-double prefixes, combined in another order).

from presto_tpu_torch.ops import window as tw  # noqa: E402

_FRAMES = [tw.Frame("rows", "u", "c"), tw.Frame("rows", "u", "u"),
           tw.Frame("rows", -5, 5), tw.Frame("rows", 1, 3),
           tw.Frame("rows", "c", "u"), tw.Frame("rows", -3, -1),
           tw.Frame("range", "u", "c"), tw.Frame("range", "c", "u"),
           tw.Frame("range", "c", "c"), tw.Frame("range", -2, 2),
           tw.Frame("range", -50, "c"), tw.Frame("range", 1, 40)]


def _window_input(rng, n, live, dev, nparts=300, order="int", desc=False,
                  nkeys=1):
    """Sorted window input: `nkeys` partition keys (a few values each,
    NULLs), one order key (ties, NULLs), values with NULLs, NaN and
    +-Inf, a FILTER column; rows past `live` are padding."""
    rv = torch.zeros(n, dtype=torch.bool)
    rv[:live] = True
    part = [(torch.from_numpy(rng.integers(0, max(nparts >> (2 * j), 2), n)),
             torch.from_numpy(rng.random(n) < 0.95)) for j in range(nkeys)]
    if order == "int":
        od = torch.from_numpy(rng.integers(0, 1000, n))
    else:
        od = torch.from_numpy(np.round(rng.normal(0, 100, n), 1))
    om = torch.from_numpy(rng.random(n) < 0.97)
    keys = part + [(od, om)]
    skeys, svalid, spay = tc.sort_rows(
        keys, [False] * nkeys + [desc], [False] * nkeys + [False], rv,
        [torch.arange(n)])
    f = rng.normal(0, 100, n)
    f[rng.random(n) < 0.002] = np.nan
    f[rng.random(n) < 0.001] = np.inf
    f[rng.random(n) < 0.001] = -np.inf
    vals = {
        "f64": torch.from_numpy(f), "f32": torch.from_numpy(f.astype(np.float32)),
        "i64": torch.from_numpy(rng.integers(-1 << 40, 1 << 40, n)),
        "i32": torch.from_numpy(rng.integers(-999, 999, n).astype(np.int32)),
    }
    vm = torch.from_numpy(rng.random(n) < 0.9)
    filt = (torch.from_numpy(rng.random(n) < 0.7),
            torch.ones(n, dtype=torch.bool))

    def to(x):
        return x.to(dev).contiguous()
    skeys = [(to(d), to(m)) for d, m in skeys]
    order_key = tw.OrderKey(skeys[-1][0], skeys[-1][1], desc, False)
    return (skeys[:nkeys], skeys[nkeys:], to(svalid), to(spay[0]),
            order_key, {k: (to(v), to(vm)) for k, v in vals.items()},
            (to(filt[0]), to(filt[1])))


def _seg_equal(a, b):
    for name in ("pid", "pstart", "part_end", "peer_start", "peer_end",
                 "dense"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("layout", ["part_order", "no_part", "no_order",
                                    "nine_part_keys", "all_dead", "tiny"])
def test_k13_window_segments_matches_plain(hopper, layout):
    rng = np.random.default_rng(71)
    n = 5000 if layout == "tiny" else (1 << 18) + 5
    live = 0 if layout == "all_dead" else n - 777
    spart, sorder, svalid, _, _, _, _ = _window_input(
        rng, n, live, hopper, nkeys=9 if layout == "nine_part_keys" else 1)
    if layout == "no_part":
        spart = []
    if layout == "no_order":
        sorder = []
    before = tw.SEGMENTS_KERNEL.launches
    got = tw.window_segments(spart, sorder, svalid)
    assert tw.SEGMENTS_KERNEL.launches == before + 1
    want = tw.segments_plain(spart, sorder, svalid)
    torch.cuda.synchronize()
    _seg_equal(got, want)


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("order", ["int", "double"])
def test_k14_window_frame_sum_matches_plain(hopper, order, desc):
    rng = np.random.default_rng(72)
    n = (1 << 18) + 5
    spart, sorder, svalid, _, ok, vals, filt = _window_input(
        rng, n, n - 1000, hopper, order=order, desc=desc)
    seg = tw.segments_plain(spart, sorder, svalid)
    for frame in _FRAMES:
        for fn, arg, dt, fl in [("count", None, torch.int64, None),
                                ("count", "f64", torch.int64, filt),
                                ("sum", "i64", torch.int64, filt),
                                ("sum", "f64", torch.float64, None),
                                ("sum", "f32", torch.float64, filt),
                                ("avg", "i32", torch.float64, None),
                                ("avg", "f64", torch.float64, filt)]:
            v = None if arg is None else vals[arg]
            before = tw.FRAME_SUM_KERNEL.launches
            gd, gm = tw.window_frame_sum(seg, ok, fn, v, fl, svalid, frame,
                                         dt)
            assert tw.FRAME_SUM_KERNEL.launches == before + 1
            wd, wm = tw.frame_sum_plain(seg, ok, fn, v, fl, svalid, frame,
                                        dt)
            torch.cuda.synchronize()
            what = f"{fn}({arg}) {frame}"
            assert torch.equal(gm, wm), what
            if dt == torch.int64:
                assert torch.equal(gd[wm], wd[wm]), what
            else:
                torch.testing.assert_close(gd[wm], wd[wm], rtol=1e-9,
                                           atol=1e-9, equal_nan=True,
                                           msg=what)


@pytest.mark.parametrize("arg", ["f64", "f32", "i64", "i32"])
def test_k15_window_frame_minmax_matches_plain(hopper, arg):
    rng = np.random.default_rng(73)
    n = (1 << 18) + 5
    spart, sorder, svalid, _, ok, vals, filt = _window_input(
        rng, n, n - 1000, hopper, nparts=40)
    seg = tw.segments_plain(spart, sorder, svalid)
    for frame in _FRAMES:
        for fn in ("min", "max"):
            for fl in (None, filt):
                before = tw.FRAME_MINMAX_KERNEL.launches
                gd, gm = tw.window_frame_minmax(seg, ok, fn, vals[arg], fl,
                                                svalid, frame)
                assert tw.FRAME_MINMAX_KERNEL.launches == before + 1
                wd, wm = tw.frame_minmax_plain(seg, ok, fn, vals[arg], fl,
                                               svalid, frame)
                torch.cuda.synchronize()
                what = f"{fn}({arg}) {frame}"
                assert torch.equal(gm, wm), what
                _same_or_nan(gd[wm], wd[wm])


def test_k16_window_emit_matches_plain(hopper):
    rng = np.random.default_rng(74)
    n = (1 << 18) + 5
    spart, sorder, svalid, iota, ok, vals, _ = _window_input(
        rng, n, n - 1000, hopper)
    seg = tw.segments_plain(spart, sorder, svalid)
    s32 = (vals["i32"][0].to(torch.int32), vals["i32"][1])
    emits = [tw.Emit(k, out_dtype=torch.int64) for k in
             ("row_number", "rank", "dense_rank")]
    emits += [tw.Emit("ntile", offset=k) for k in (1, 4, 7)]
    emits += [tw.Emit(k, out_dtype=torch.float64)
              for k in ("percent_rank", "cume_dist")]
    emits += [tw.Emit("lag", vals["f64"], offset=1),
              tw.Emit("lead", vals["i64"], offset=3),
              tw.Emit("lag", s32, offset=2, default=-5),
              tw.Emit("lead", vals["f64"], offset=1, default=-1.5)]
    for frame in _FRAMES[:8]:
        emits += [tw.Emit("first_value", vals["f32"], frame=frame),
                  tw.Emit("last_value", s32, frame=frame),
                  tw.Emit("nth_value", vals["i64"], offset=3, frame=frame)]
    emits.append(tw.Emit("copy", vals["f64"]))
    assert len(emits) > tw.EMIT_MAX
    before = tw.EMIT_KERNEL.launches
    got = tw.window_emit(seg, ok, svalid, iota, emits)
    assert tw.EMIT_KERNEL.launches == before + len(tw.emit_chunks(
        len(emits)))
    want = tw.emit_plain(seg, ok, svalid, iota, emits)
    torch.cuda.synchronize()
    for e, (gd, gm), (wd, wm) in zip(emits, got, want):
        assert gd.dtype == wd.dtype, e.kind
        assert torch.equal(gm, wm), e.kind
        _same_or_nan(gd[wm], wd[wm])


def test_window_pass_matches_cpu(hopper):
    """The whole window pass (sort, K13-K16) on the card against the
    plain versions on the CPU, over a batch of every call shape."""
    from presto_tpu_torch.ops.window import WindowCallSpec as W
    rng = np.random.default_rng(75)
    n = 1 << 16
    cols = {
        "p": (rng.integers(0, 50, n), rng.random(n) < 0.95, "bigint", None),
        "o": (rng.integers(0, 500, n), rng.random(n) < 0.97, "bigint", None),
        "v": (rng.normal(0, 10, n), rng.random(n) < 0.9, "double", None),
        "s": (rng.integers(0, 3, n).astype(np.int32), rng.random(n) < 0.9,
              "varchar", ("a", "b", "c")),
    }
    rv = rng.random(n) < 0.95
    calls = (W("rn", "row_number", None, "full", tt.BIGINT),
             W("rk", "rank", None, "full", tt.BIGINT),
             W("nt", "ntile", None, "full", tt.BIGINT, offset=4),
             W("cd", "cume_dist", None, "full", tt.DOUBLE),
             W("sm", "sum", "v", "rows", tt.DOUBLE, fstart=-5, fend=5),
             W("c", "count", None, "range", tt.BIGINT, fstart=-20, fend=20),
             W("mn", "min", "s", "rows", tt.VARCHAR, ("a", "b", "c"),
               fstart="u", fend="c"),
             W("mx", "max", "v", "range", tt.DOUBLE, fstart="c", fend="u"),
             W("lg", "lag", "s", "full", tt.VARCHAR, ("a", "b", "c"),
               offset=2, default=0),
             W("fv", "first_value", "v", "rows", tt.DOUBLE, fstart=-3,
               fend=0))
    out = {}
    for dev in (torch.device("cpu"), hopper):
        b = interop.batch_from_numpy(cols, rv, dev)
        out[dev.type] = tw.window_kernel(b, ("p",), ("o",), (True,),
                                         (False,), calls)
    torch.cuda.synchronize()
    for c in calls:
        g, w = out["cuda"].columns[c.out_name], out["cpu"].columns[c.out_name]
        assert torch.equal(g.mask.cpu(), w.mask), c.out_name
        if g.data.is_floating_point():
            torch.testing.assert_close(g.data.cpu()[w.mask], w.data[w.mask],
                                       rtol=1e-9, atol=1e-9)
        else:
            assert torch.equal(g.data.cpu()[w.mask], w.data[w.mask])


# -- C6: K5-K9 past 8 key columns --------------------------------------------


_WIDE_DTYPES = (np.int64, np.int32, np.float64, np.int16)


def _wide_key_batch(rng, base, nkeys, dev, null_frac=0.03):
    """A batch whose `nkeys` key columns all derive from one int64 base
    (so equal bases are equal keys), cycling int64 / int32 / float64 /
    int16, with NULLs; plus a payload column `v`."""
    n = base.shape[0]
    cols = {}
    for j in range(nkeys):
        dt = _WIDE_DTYPES[j % 4]
        d = ((base * (j + 3)) % 20011).astype(dt)
        m = rng.random(n) >= null_frac
        typ = {np.int64: tt.BIGINT, np.int32: tt.INTEGER,
               np.float64: tt.DOUBLE, np.int16: tt.SMALLINT}[dt]
        cols[f"k{j}"] = tb.Column(torch.from_numpy(d).to(dev),
                                  torch.from_numpy(m).to(dev), typ)
    cols["v"] = tb.Column(torch.arange(n, device=dev),
                          torch.ones(n, dtype=torch.bool, device=dev),
                          tt.BIGINT)
    rv = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    return tb.Batch(cols, rv)


def _wide_join(rng, nkeys, dev, nb=1 << 16, npr=1 << 18, dup=None):
    bbase = rng.integers(0, dup or 1 << 40, nb)
    build = _wide_key_batch(rng, bbase, nkeys, dev)
    take = rng.random(npr) < 0.5
    pbase = np.where(take, bbase[rng.integers(0, nb, npr)],
                     rng.integers(0, 1 << 40, npr))
    probe = _wide_key_batch(rng, pbase, nkeys, dev)
    names = tuple(f"k{j}" for j in range(nkeys))
    return build, probe, names, tj.build_for_backend(build, names)


@pytest.mark.parametrize("nkeys", [9, 17, 25])
@pytest.mark.parametrize("verify", ["hash", "full"])
@pytest.mark.parametrize("dup", [None, 3000], ids=["unique", "dup"])
def test_k5_past_eight_keys(hopper, nkeys, verify, dup):
    rng = np.random.default_rng(70 + nkeys)
    build, probe, names, table = _wide_join(rng, nkeys, hopper, dup=dup)
    before = tj.JOIN_PROBE_KERNEL.launches
    lo, h2 = tj.probe_search(table, probe, names, verify)
    assert tj.JOIN_PROBE_KERNEL.launches == before + 1
    plo, ph2 = tj.probe_search_plain(table, probe, names, verify)
    torch.cuda.synchronize()
    assert torch.equal(lo, plo)
    assert (h2 is None) == (ph2 is None)
    assert h2 is None or torch.equal(h2, ph2)
    assert int((lo >= 0).sum()) > probe.capacity // 8


@pytest.mark.parametrize("nkeys", [9, 17, 25])
@pytest.mark.parametrize("verify", ["hash", "full"])
@pytest.mark.parametrize("negate", [False, True], ids=["in", "not_in"])
def test_k7_past_eight_keys(hopper, nkeys, verify, negate):
    rng = np.random.default_rng(80 + nkeys)
    build, probe, names, table = _wide_join(rng, nkeys, hopper, dup=3000)
    before = tj.SEMI_JOIN_KERNEL.launches
    got = tj.semi_mark(table, probe, names, names, verify, negate)
    assert tj.SEMI_JOIN_KERNEL.launches == before + 1
    want = tj.semi_mark_plain(table, probe, names, names, verify, negate)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert 0 < int(want.sum()) < probe.capacity


@pytest.mark.parametrize("nkeys", [9, 17, 25])
@pytest.mark.parametrize("join_type", ["inner", "left"])
def test_k9_full_verify_past_eight_keys(hopper, nkeys, join_type):
    rng = np.random.default_rng(90 + nkeys)
    build, probe, names, table = _wide_join(rng, nkeys, hopper, dup=3000)
    lo_enc, h2 = tj.probe_search(table, probe, names, "full")
    table.batch = tb.Batch({**table.batch.columns,
                            "b_v": table.batch.columns["v"]},
                           table.batch.row_valid)
    found = lo_enc >= 0
    counts = torch.where(found, table.run_len[torch.clamp(lo_enc, min=0)],
                         torch.zeros_like(lo_enc))
    emit = counts if join_type == "inner" else torch.where(
        probe.row_valid, torch.clamp(counts, min=1), torch.zeros_like(counts))
    args = (table, probe, names, lo_enc, max(int(emit.sum()), 1), join_type,
            ("k0", "v"), ("b_v",), names, "full", h2)
    before = tj.JOIN_EXPAND_KERNEL.launches
    got = tj._expand_from_enc(*args)
    assert tj.JOIN_EXPAND_KERNEL.launches == before + 1
    want = tj.expand_plain(*args)
    torch.cuda.synchronize()
    _assert_expand_equal(got, want, ("k0", "v", "b_v"))
    assert int(want[2]) > 0


def _wide_group_keys(rng, n, nkeys, ngroups, dev):
    base = rng.integers(0, ngroups, n)
    b = _wide_key_batch(rng, base, nkeys, dev, null_frac=0.02)
    return [b.columns[f"k{j}"].astuple() for j in range(nkeys)], base


@pytest.mark.parametrize("nkeys", [9, 17, 25])
def test_k6_past_eight_keys(hopper, nkeys):
    """Groups split by a key past the eighth only (the first eight
    agree) still split: K6's change flags of the later groups."""
    rng = np.random.default_rng(100 + nkeys)
    n = 1 << 20
    keys, _ = _wide_group_keys(rng, n, nkeys, 5000, hopper)
    # the last key alone distinguishes rows 0/1 of each pair
    d, m = keys[-1]
    keys[-1] = (torch.where(torch.arange(n, device=hopper) % 2 == 0, d,
                            d + 1), m)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(hopper)
    h1, h2 = tc.row_hash_pair(keys, valid, False)
    perm = tc.lex_perm([h1, h2])
    skeys = [(kd[perm], km[perm]) for kd, km in keys]
    comps = [(torch.from_numpy(rng.integers(-5, 5, n)).to(hopper)[perm],
              "sum"),
             (torch.from_numpy(rng.normal(0, 1, n)).to(hopper)[perm], "max")]
    args = (h1[perm], h2[perm], skeys, valid[perm], comps, 1 << 20)
    before = th.SEGMENT_REDUCE_KERNEL.launches
    got = th.segment_reduce(*args)
    assert th.SEGMENT_REDUCE_KERNEL.launches == before + 1
    want = th.segment_reduce_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got[0] + list(got[1:]), want[0] + list(want[1:])):
        assert torch.equal(g, w)
    # the same hashes with the later keys equal would merge the pairs
    assert int(want[2]) > 5000


@pytest.mark.parametrize("nkeys", [9, 17, 25])
@pytest.mark.parametrize("carry_kind", ["none", "same", "differs"])
def test_k8_past_eight_keys(hopper, nkeys, carry_kind):
    rng = np.random.default_rng(110 + nkeys)
    n = 1 << 20
    rv, keys2, contribs, aggs = _stream_batch(rng, n, hopper, "random")
    # nkeys keys in key order: the two stream keys, then copies of the
    # second; the last differs inside some groups of the first two
    k0, k1 = keys2
    keys = [k0] + [k1] * (nkeys - 2)
    split = (torch.arange(n, device=hopper) // 3) % 2
    keys.append((k1[0] * 2 + split.to(torch.int32), k1[1]))
    carry = None
    if carry_kind != "none":
        carry = th.init_state([tt.BIGINT] + [tt.INTEGER] * (nkeys - 1),
                              aggs, 1, hopper)
        first = int(torch.nonzero(rv)[0])
        for (cd, cm), (d, m) in zip(carry.keys, keys):
            cd[0] = d[first]
            cm[0] = m[first]
        if carry_kind == "differs":
            carry.keys[-1][0][0] += 1
        for st in carry.states:
            for a in st:
                a[0] = 3 if not a.is_floating_point() else 2.5
        carry.valid[0] = True
    before = th.STREAM_REDUCE_KERNEL.launches
    if carry is None:
        got = th.presorted_reduce(rv, keys, contribs, aggs, 1 << 20)
        want = th.presorted_reduce_plain(rv, keys, contribs, aggs, 1 << 20)
        pairs = [(got, want)]
    else:
        got = th.stream_step(carry, rv, keys, contribs, aggs, 1 << 20)
        want = th.stream_fold_plain(carry, th.presorted_reduce_plain(
            rv, keys, contribs, aggs, 1 << 20), aggs)
        assert int(got[3]) == int(want[3])
        pairs = list(zip(got[:3], want[:3]))
    assert th.STREAM_REDUCE_KERNEL.launches == before + 1
    torch.cuda.synchronize()
    for g, w in pairs:
        assert torch.equal(g.valid, w.valid)
        live = w.valid
        for (gd, gm), (wd, wm) in zip(g.keys, w.keys):
            assert torch.equal(gm[live], wm[live])
            assert torch.equal(gd[live], wd[live])
        _assert_states_close(g.states, w.states, live)


def test_wide_key_queries_match_cpu(hopper):
    """A 9-key GROUP BY (sort-based: K3, K6) and a 9-key join (K3-K5,
    K9) through the runner on the card equal the CPU runner's rows."""
    from presto_tpu_torch.runner import LocalRunner
    keys9 = ("l_orderkey, l_partkey, l_suppkey, l_linenumber, l_quantity, "
             "l_returnflag, l_linestatus, l_shipdate, l_shipmode")
    q_group = (f"select {keys9}, count(*) c, sum(l_extendedprice) s from "
               "(select orderkey l_orderkey, partkey l_partkey, suppkey "
               "l_suppkey, linenumber % 2 l_linenumber, quantity "
               "l_quantity, returnflag l_returnflag, linestatus "
               "l_linestatus, shipdate l_shipdate, shipmode l_shipmode, "
               "extendedprice l_extendedprice from lineitem) "
               f"group by {keys9}")
    q_join = ("select count(*), sum(a.extendedprice) from lineitem a join "
              "lineitem b on a.orderkey = b.orderkey and a.partkey = "
              "b.partkey and a.suppkey = b.suppkey and a.linenumber = "
              "b.linenumber and a.quantity = b.quantity and a.returnflag = "
              "b.returnflag and a.linestatus = b.linestatus and a.shipdate "
              "= b.shipdate and a.shipmode = b.shipmode")
    gpu = LocalRunner("tpch", "tiny", device=hopper)
    cpu = LocalRunner("tpch", "tiny", device="cpu")
    for q in (q_group, q_join):
        before = th.SEGMENT_REDUCE_KERNEL.launches + \
            tj.JOIN_PROBE_KERNEL.launches
        got = sorted(gpu.execute(q).rows(), key=str)
        assert th.SEGMENT_REDUCE_KERNEL.launches + \
            tj.JOIN_PROBE_KERNEL.launches > before
        want = sorted(cpu.execute(q).rows(), key=str)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a == b or abs(a - b) <= 1e-6 * abs(b)


# -- C7: round / truncate with a column d through K12 -------------------------


@pytest.mark.parametrize("fn", ["round", "truncate"])
@pytest.mark.parametrize("arg", ["acctbal", "cast(acctbal as real)"])
def test_round_with_column_decimals_through_k12(hopper, fn, arg):
    from presto_tpu_torch.expr import codegen
    from presto_tpu_torch.runner import LocalRunner
    q = (f"select custkey, {fn}({arg}, nationkey % 3) r, "
         f"{fn}({arg}, 1 - nationkey % 4) s from customer")
    before = codegen.COUNTER.launches
    got = dict((k, (r, s)) for k, r, s in
               LocalRunner("tpch", "tiny", device=hopper).execute(q).rows())
    assert codegen.COUNTER.launches > before
    want = LocalRunner("tpch", "tiny", device="cpu").execute(q).rows()
    assert len(got) == len(want)
    for k, r, s in want:
        for a, b in zip(got[k], (r, s)):
            assert a == b or abs(a - b) <= 1e-6 * abs(b)


# -- K17 array_collect -----------------------------------------------------


from presto_tpu_torch.operators import array_agg as taa  # noqa: E402


def _collect_inputs(rng, n, ngroups, width, dev, dtypes, dead=0.1,
                    sizes=None):
    """Sorted collect inputs: order, pid (groups of random sizes, or of
    the given `sizes`), the live count, and one spec per dtype (every
    other one with a FILTER, the last a map_agg with NULL keys)."""
    if sizes is None:
        g = np.sort(rng.integers(0, ngroups, n))
    else:
        g = np.repeat(np.arange(len(sizes)), sizes)
        n = len(g)
    nlive = int(n * (1 - dead))
    pid = np.concatenate([np.unique(g[:nlive], return_inverse=True)[1],
                          np.zeros(n - nlive, np.int64)])
    if nlive:
        pid[nlive:] = pid[nlive - 1]
    groups = int(pid[nlive - 1] + 1) if nlive else 0
    order = rng.permutation(n)
    specs = []
    for i, dt in enumerate(dtypes):
        if np.issubdtype(dt, np.floating):
            v = rng.normal(0, 100, n).astype(dt)
            v[rng.random(n) < 0.05] = np.nan
        elif dt == np.bool_:
            v = rng.random(n) < 0.5
        else:
            v = rng.integers(-100, 100, n).astype(dt)

        def col(x, frac=0.9):
            return (torch.from_numpy(np.ascontiguousarray(x)).to(dev),
                    torch.from_numpy(rng.random(n) < frac).to(dev))
        filt = col(rng.random(n) < 0.7) if i % 2 else None
        mval = col(rng.normal(0, 1, n)) if i == len(dtypes) - 1 else None
        specs.append((col(v), mval, filt))
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return t(order.astype(np.int64)), t(pid.astype(np.int64)), nlive, \
        groups, specs


def _assert_collect_equal(got, want):
    """Every output of K17 equal to the plain version's, the whole block
    (NaN equal to NaN; empty slots zero in both)."""
    (gouts, gfirst, gover), (wouts, wfirst, wover) = got, want
    assert bool(gover) == bool(wover)
    assert torch.equal(gfirst, wfirst)
    for go, wo in zip(gouts, wouts):
        assert torch.equal(go[4], wo[4])
        for g, w in zip(go[:4], wo[:4]):
            assert (g is None) == (w is None)
            if g is not None and g.is_floating_point():
                torch.testing.assert_close(g, w, rtol=0, atol=0,
                                           equal_nan=True)
            elif g is not None:
                assert torch.equal(g, w)


_ALL_DTYPES = (np.int8, np.int16, np.int32, np.int64, np.float32,
               np.float64, np.bool_)


@pytest.mark.parametrize("case", ["random", "exactly_w", "w_plus_one",
                                  "out_rows_plus_one", "all_dead",
                                  "many_specs"])
def test_k17_array_collect_matches_plain(hopper, case):
    rng = np.random.default_rng(120)
    width = 64
    kw = {}
    dtypes = _ALL_DTYPES
    n, ngroups = 1 << 20, 150_000
    if case == "exactly_w":
        kw = dict(sizes=[width] * 1000 + [3] * 1000, dead=0.0)
    elif case == "w_plus_one":
        kw = dict(sizes=[width + 1] + [5] * 1000, dead=0.0)
    elif case == "all_dead":
        kw = dict(dead=1.0)
    elif case == "many_specs":
        dtypes = _ALL_DTYPES * 3   # 21 specs: two launches
    order, pid, nlive, groups, specs = _collect_inputs(
        rng, n, ngroups, width, hopper, dtypes, **kw)
    out_rows = tb.bucket_capacity(max(groups, 1))
    if case == "out_rows_plus_one":
        out_rows = groups - 1
    before = taa.ARRAY_COLLECT_KERNEL.launches
    got = taa.array_collect(order, pid, nlive, groups, specs, width,
                            out_rows)
    assert taa.ARRAY_COLLECT_KERNEL.launches == before + (
        2 if case == "many_specs" else 1)
    want = taa.collect_plain(order, pid, nlive, groups, specs, width,
                             out_rows)
    torch.cuda.synchronize()
    _assert_collect_equal(got, want)
    if case == "w_plus_one":
        assert bool(got[2])
    if case == "exactly_w":
        assert not bool(got[2])


def test_array_agg_queries_match_cpu(hopper):
    """array_agg (two specs, FILTER), map_agg and an UNNEST of the
    arrays through the runner on the card equal the CPU runner's rows,
    element order included, with K17 launched."""
    from presto_tpu_torch.runner import LocalRunner
    qs = ["select orderkey, array_agg(partkey) p, array_agg(quantity) "
          "filter (where returnflag = 'R') rq from lineitem group by orderkey",
          "select orderkey, map_agg(linenumber, extendedprice) m from "
          "lineitem where shipdate >= date '1995-01-01' group by orderkey",
          "select count(*), sum(x) from (select array_agg(partkey) p from "
          "lineitem group by orderkey) t cross join unnest(t.p) u(x)"]
    gpu = LocalRunner("tpch", "tiny", device=hopper)
    cpu = LocalRunner("tpch", "tiny", device="cpu")
    for q in qs:
        before = taa.ARRAY_COLLECT_KERNEL.launches
        got = sorted(gpu.execute(q).rows(), key=str)
        assert taa.ARRAY_COLLECT_KERNEL.launches > before
        assert got == sorted(cpu.execute(q).rows(), key=str)


# -- K18 exchange_shuffle, K19 merge_pair, the mesh (distributed path) --

_WAVE_DTYPES = [torch.int64, torch.int32, torch.int16, torch.int8,
                torch.float64, torch.float32, torch.bool]


def _wave_producers(rng, w, dev, nkeys, inject_min):
    """W producers (one without a batch), every column dtype, NULLs,
    dead rows, `nkeys` key columns hashed by K3 and, with `inject_min`,
    some hashes replaced by INT64_MIN."""
    from presto_tpu_torch.ops import common
    out = []
    for p in range(w):
        if p == 1:
            out.append(None)
            continue
        n = int(rng.integers(1000, 70000))
        rv = torch.from_numpy(rng.random(n) > 0.2).to(dev)
        keys = [(torch.from_numpy(rng.integers(-40, 40, n)).to(dev),
                 torch.from_numpy(rng.random(n) > 0.1).to(dev))
                for _ in range(nkeys)]
        h, _ = common.row_hash_pair(keys, rv, False)
        if inject_min:
            h[::7] = np.iinfo(np.int64).min
        cols = []
        for dt in _WAVE_DTYPES:
            if dt == torch.bool:
                d = torch.from_numpy(rng.random(n) < 0.5)
            elif dt.is_floating_point:
                d = torch.from_numpy(rng.normal(size=n)).to(dt)
            else:
                d = torch.from_numpy(rng.integers(-100, 100, n)).to(dt)
            cols.append((d.to(dev), torch.from_numpy(rng.random(n) > 0.1)
                         .to(dev)))
        out.append((h, rv, cols))
    return out


@pytest.mark.parametrize("w", [3, 8])
@pytest.mark.parametrize("nkeys", [1, 9, 17])
@pytest.mark.parametrize("inject_min", [False, True])
def test_k18_exchange_shuffle_matches_plain(hopper, w, nkeys, inject_min):
    """K18 against its plain version on the same CUDA inputs: every
    consumer's count, row_valid, columns and masks exactly, in order."""
    from presto_tpu_torch.parallel import shuffle as tsh
    rng = np.random.default_rng(40 + w + nkeys + inject_min)
    producers = _wave_producers(rng, w, hopper, nkeys, inject_min)
    args = (producers, w, w * 65536, _WAVE_DTYPES)
    before = tsh.WAVE_KERNEL.launches
    got, gc = tsh.wave_shuffle(*args)
    want, wc = tsh.wave_shuffle_plain(*args)
    torch.cuda.synchronize()
    assert tsh.WAVE_KERNEL.launches == before + 1
    assert gc == wc
    for (gcols, grv), (wcols, wrv) in zip(got, want):
        assert torch.equal(grv, wrv)
        for (gd, gm), (wd, wm) in zip(gcols, wcols):
            assert torch.equal(gd, wd) and torch.equal(gm, wm)


def test_k18_all_dead_wave(hopper):
    from presto_tpu_torch.parallel import shuffle as tsh
    h = torch.arange(5000, device=hopper, dtype=torch.int64)
    rv = torch.zeros(5000, dtype=torch.bool, device=hopper)
    d = torch.ones(5000, dtype=torch.int64, device=hopper)
    args = ([(h, rv, [(d, rv.clone())])] * 3, 3, 3 * 16384, [torch.int64])
    got, counts = tsh.wave_shuffle(*args)
    want, _ = tsh.wave_shuffle_plain(*args)
    assert counts == [0, 0, 0]
    for (gc, grv), (wc, wrv) in zip(got, want):
        assert torch.equal(grv, wrv) and torch.equal(gc[0][0], wc[0][0])


def _merge_runs(rng, dev, kind, desc, nf):
    from presto_tpu_torch.ops.sort import sort_batch
    pools = {"double": np.array([np.nan, -0.0, 0.0, -np.inf, np.inf, 1.5,
                                 -2.0]),
             "bigint": np.array([np.iinfo(np.int64).min, -1, 0, 3,
                                 np.iinfo(np.int64).max]),
             "real": np.array([np.nan, -0.0, 0.0, 2.5], np.float32)}
    runs = []
    for n, cap in ((300000, 524288), (200000, 262144)):
        vals = np.zeros(cap, pools[kind].dtype)
        vals[:n] = rng.choice(pools[kind], n)
        rv = np.zeros(cap, bool)
        rv[:n] = rng.random(n) > 0.05
        ids = np.arange(cap, dtype=np.int64) + (0 if cap == 524288
                                                else 1 << 40)
        b = tb.Batch({
            "k": tb.Column(torch.from_numpy(vals).to(dev),
                           torch.from_numpy(rng.random(cap) > 0.1).to(dev),
                           tt.Type(kind)),
            "k2": tb.Column(torch.from_numpy(rng.integers(0, 5, cap))
                            .to(dev), torch.ones(cap, dtype=torch.bool,
                                                 device=dev), tt.BIGINT),
            "id": tb.Column(torch.from_numpy(ids).to(dev),
                            torch.ones(cap, dtype=torch.bool, device=dev),
                            tt.BIGINT)}, torch.from_numpy(rv).to(dev))
        runs.append(sort_batch(b, ("k", "k2"), (desc, False), (nf, False)))
    return runs


@pytest.mark.parametrize("kind", ["double", "bigint", "real"])
@pytest.mark.parametrize("desc,nf", [(False, False), (True, False),
                                     (False, True), (True, True)])
def test_k19_merge_pair_matches_plain(hopper, kind, desc, nf):
    """K19 against its plain version on runs the card sorted (NaN,
    -0.0 / +0.0, INT64_MIN, DESC and NULLS FIRST): every column exactly,
    and the ids a permutation of the live input rows."""
    from presto_tpu_torch.ops import merge as tm
    rng = np.random.default_rng(7 + 2 * desc + nf)
    a, b = _merge_runs(rng, hopper, kind, desc, nf)
    args = (a, b, ("k", "k2"), (desc, False), (nf, False))
    before = tm.MERGE_KERNEL.launches
    got = tm.merge_pair(*args)
    want = tm.merge_pair_plain(*args)
    torch.cuda.synchronize()
    assert tm.MERGE_KERNEL.launches == before + 1
    assert torch.equal(got.row_valid, want.row_valid)
    for n in a.names:
        g, w = got.columns[n], want.columns[n]
        assert torch.equal(g.mask, w.mask)
        same = (g.data == w.data)
        if g.data.is_floating_point():
            same = same | (torch.isnan(g.data) & torch.isnan(w.data))
        assert bool(same.all()), n
    live = got.columns["id"].data[got.row_valid]
    want_ids = torch.cat([a.columns["id"].data[a.row_valid],
                          b.columns["id"].data[b.row_valid]])
    assert torch.equal(torch.sort(live).values, torch.sort(want_ids).values)


def test_mesh_queries_match_cpu(hopper):
    """MeshRunner on the card (eight workers on one device) against the
    CPU MeshRunner for the queries of the CPU tests."""
    import math
    from presto_tpu_torch.runner import MeshRunner
    from tpch_queries import QUERIES
    sqls = [QUERIES[3], QUERIES[6], QUERIES[13],
            "SELECT n.nationkey, count(*) AS c FROM supplier s, nation n "
            "WHERE s.nationkey = n.nationkey AND s.suppkey >= 0 "
            "GROUP BY n.nationkey ORDER BY n.nationkey",
            "select orderkey, custkey, totalprice from orders "
            "order by totalprice desc, orderkey"]
    for props in ({"broadcast_join_threshold_rows": 0},
                  {"broadcast_join_threshold_rows": 500}):
        gpu = MeshRunner("tpch", "tiny", props, n_workers=8)
        cpu = MeshRunner("tpch", "tiny", props, n_workers=8, device="cpu")
        for sql in sqls:
            g, c = gpu.execute(sql).rows(), cpu.execute(sql).rows()
            assert len(g) == len(c)
            for rg, rc in zip(sorted(g, key=str), sorted(c, key=str)):
                for x, y in zip(rg, rc):
                    if isinstance(x, float):
                        assert math.isclose(x, y, rel_tol=1e-6,
                                            abs_tol=1e-6)
                    else:
                        assert x == y


# -- K20 exchange_partition, K21-K23 dynamic_filter (the control plane) ----

def _k20_batch(dev, n, live, seed, dtypes=("int64", "float64", "int32",
                                          "bool", "int16")):
    rng = np.random.default_rng(seed)
    cols = {}
    for i, dt in enumerate(dtypes):
        d = rng.integers(-1000, 1000, n).astype(dt)
        cols[f"c{i}"] = tb.Column(torch.from_numpy(d).to(dev),
                                  torch.from_numpy(rng.random(n) < 0.9)
                                  .to(dev), tt.BIGINT)
    rv = torch.from_numpy(rng.random(n) < live).to(dev)
    return tb.Batch(cols, rv)


def _k20_same(got, want):
    from presto_tpu_torch.operators import exchange_ops as ex  # noqa: F401
    (gb, gbounds), (wb, wbounds) = got, want
    assert torch.equal(gbounds.cpu(), wbounds.cpu())
    live = int(wbounds[-1])
    assert torch.equal(gb.row_valid.cpu(), wb.row_valid.cpu())
    for n in wb.names:
        assert torch.equal(gb.columns[n].data[:live].cpu(),
                           wb.columns[n].data[:live].cpu()), n
        assert torch.equal(gb.columns[n].mask[:live].cpu(),
                           wb.columns[n].mask[:live].cpu()), n


@pytest.mark.parametrize("w", [1, 2, 3, 8, 64])
@pytest.mark.parametrize("n", [1 << 20, 777])
@pytest.mark.parametrize("inject_min", [False, True])
def test_k20_exchange_partition_matches_plain(hopper, w, n, inject_min):
    """K20 against its plain version on the same CUDA inputs, exactly:
    bounds, row_valid, and every column over the live prefix."""
    from presto_tpu_torch.operators import exchange_ops as ex
    b = _k20_batch(hopper, n, 0.7, seed=w + n)
    rng = np.random.default_rng(w)
    h = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, n,
                                      dtype=np.int64)).to(hopper)
    if inject_min:
        h[::5] = -2 ** 63
    _k20_same(ex.partition_sort(b, h, w), ex.partition_sort_plain(b, h, w))


@pytest.mark.parametrize("keys", [("c0",), ("c0", "c2", "c1")])
def test_k20_through_k3_and_edges(hopper, keys):
    """The whole partition_segments (K3's hash first), an all-dead
    batch, and the cap on consumers."""
    from presto_tpu_torch.operators import exchange_ops as ex
    b = _k20_batch(hopper, 1 << 16, 0.5, seed=len(keys))
    cpu = tb.Batch({k: tb.Column(c.data.cpu(), c.mask.cpu(), c.type)
                    for k, c in b.columns.items()}, b.row_valid.cpu())
    _k20_same(ex.partition_segments(b, keys, None, 8),
              ex.partition_segments(cpu, keys, None, 8))
    dead = tb.Batch(b.columns, torch.zeros_like(b.row_valid))
    sb, bounds = ex.partition_segments(dead, keys, None, 5)
    assert bounds.tolist() == [0] * 6 and not sb.row_valid.any()
    with pytest.raises(ValueError, match="consumers"):
        ex.partition_sort(b, torch.zeros(b.capacity, dtype=torch.int64,
                                         device=hopper), 65)


_DF_DTYPES = [torch.int32, torch.int64, torch.float32, torch.float64,
              torch.int16, torch.int8]


def _df_keys(dt, n, distinct, seed):
    rng = np.random.default_rng(seed)
    pool = torch.from_numpy(rng.permutation(distinct) * 3 - 7).to(dt)
    x = pool[torch.from_numpy(rng.integers(0, distinct, n))]
    x[:distinct] = pool
    m = torch.from_numpy(rng.random(n) < 0.9)
    m[:distinct] = True
    if dt.is_floating_point:
        x[distinct:distinct + 3] = torch.tensor([float("nan"), -0.0, 0.0],
                                                dtype=dt)
    x[-1] = torch.finfo(dt).max if dt.is_floating_point \
        else torch.iinfo(dt).max
    return x, m


@pytest.mark.parametrize("dt", _DF_DTYPES)
def test_k21_bounds_matches_plain(hopper, dt):
    from presto_tpu_torch.execution import dynamic_filters as df
    x, m = _df_keys(dt, 1 << 20, 1000, seed=1)
    st = df.bounds_init(dt, torch.device("cpu"))
    want = df.bounds_step_plain(st, x, m)
    got = df.bounds_step(df.bounds_init(dt, hopper), x.to(hopper),
                         m.to(hopper))
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    # an all-NULL batch leaves the state as it was
    got2 = df.bounds_step(got, x.to(hopper),
                          torch.zeros_like(m).to(hopper))
    assert all(torch.equal(a, b) for a, b in zip(got, got2))


@pytest.mark.parametrize("dt", _DF_DTYPES)
@pytest.mark.parametrize("distinct", [1, 25, 4095, 4096, 4097, 20000])
def test_k22_distinct_set_matches_plain(hopper, dt, distinct):
    """Without overflow the count and every value exactly (the dtype max
    a real key, -0.0 and +0.0 one key); with overflow the flag, and the
    count saturated at DF_SET_MAX + 1."""
    from presto_tpu_torch.execution import dynamic_filters as df
    x, m = _df_keys(dt, 1 << 19, distinct, seed=distinct)
    wv, wn, wo = df.distinct_set_plain(x, m)
    gv, gn, go = df.distinct_set(x.to(hopper), m.to(hopper))
    assert bool(go) == bool(wo)
    if bool(wo):
        assert int(gn) == df.DF_SET_MAX + 1
    else:
        assert int(gn) == int(wn)
        assert torch.equal(gv.cpu(), wv)


@pytest.mark.parametrize("pt", _DF_DTYPES)
@pytest.mark.parametrize("bt", _DF_DTYPES)
@pytest.mark.parametrize("with_set", [False, True])
def test_k23_apply_matches_plain(hopper, pt, bt, with_set):
    """Every probe/build dtype pair, compared in the wider type."""
    from presto_tpu_torch.execution import dynamic_filters as df
    bx, bm = _df_keys(bt, 5000, 300, seed=3)
    st = df.bounds_step_plain(df.bounds_init(bt, torch.device("cpu")),
                              bx, bm)
    vals, cnt, ovf = df.distinct_set_plain(bx, bm)
    px, pm = _df_keys(pt, 1 << 18, 600, seed=4)
    rv = torch.from_numpy(np.random.default_rng(5).random(1 << 18) < 0.8)
    pb = tb.Batch({"k": tb.Column(px, pm, tt.BIGINT)}, rv)
    gb = tb.Batch({"k": tb.Column(px.to(hopper), pm.to(hopper),
                                  tt.BIGINT)}, rv.to(hopper))
    extra = (vals, cnt) if with_set else ()
    want = df.apply_filter_plain(pb, "k", *st, with_set, *extra)
    got = df.apply_filter(gb, "k", *(s.to(hopper) for s in st), with_set,
                          *(e.to(hopper) for e in extra))
    assert torch.equal(got.row_valid.cpu(), want.row_valid)


#: SMALLINT and TINYINT join keys over memory tables: the planner gives
#: each inner join a dynamic filter on the probe table's scan (shared
#: with tests/test_torch_dynamic_filters.py, which runs them on the CPU
#: against the reference)
NARROW_KEY_SETUP = [
    "create table memory.default.dfb as select cast(nationkey as smallint)"
    " k16, cast(regionkey as tinyint) k8, name from nation "
    "where nationkey < 9",
    "create table memory.default.dfp as select cast(custkey % 25 as "
    "smallint) k16, cast(custkey % 7 as tinyint) k8, acctbal from customer",
]
NARROW_KEY_QUERIES = [
    "select b.name, count(*), sum(p.acctbal) from memory.default.dfp p "
    "join memory.default.dfb b on p.k16 = b.k16 group by b.name "
    "order by b.name",
    "select p.k8, count(*) from memory.default.dfp p join "
    "memory.default.dfb b on p.k8 = b.k8 group by p.k8 order by p.k8",
]


def narrow_key_rows(runner):
    """NARROW_KEY_QUERIES' results on a runner after NARROW_KEY_SETUP."""
    for sql in NARROW_KEY_SETUP:
        runner.execute(sql)
    return [runner.execute(sql).rows() for sql in NARROW_KEY_QUERIES]


def test_narrow_key_join_on_the_card_matches_cpu(hopper):
    """Joins on SMALLINT and TINYINT keys of memory tables go through
    K21-K23 on the card and return the CPU LocalRunner's rows (DOUBLE
    to a relative 1e-6, everything else exactly)."""
    import math
    from presto_tpu_torch.execution import dynamic_filters as df
    from presto_tpu_torch.runner import LocalRunner
    counters = (df.BOUNDS_KERNEL, df.SET_KERNEL, df.APPLY_KERNEL)
    before = [c.launches for c in counters]
    got = narrow_key_rows(LocalRunner("tpch", "tiny", device=hopper))
    assert all(c.launches > b for c, b in zip(counters, before))
    want = narrow_key_rows(LocalRunner("tpch", "tiny", device="cpu"))
    for sql, g, w in zip(NARROW_KEY_QUERIES, got, want):
        assert g and len(g) == len(w), sql
        for rg, rw in zip(g, w):
            for x, y in zip(rg, rw):
                assert x == y or (isinstance(x, float) and math.isclose(
                    x, y, rel_tol=1e-6)), sql


def test_cluster_on_the_card_matches_cpu(hopper):
    """Two worker processes on the card and a coordinator on the card
    return the CPU LocalRunner's rows, launching K20-K23."""
    import json
    from presto_tpu_torch.runner import LocalRunner
    from presto_tpu_torch.server.coordinator import Coordinator
    from presto_tpu_torch.server.node import http_get
    from presto_tpu_torch.server.node import spawn_workers, stop_workers
    procs, urls = spawn_workers(2, timeout_s=240)
    try:
        coord = Coordinator(urls, "tpch", "sf0_01",
                            {"broadcast_join_threshold_rows": 2000},
                            device=hopper)
        coord.start()
        try:
            cpu = LocalRunner("tpch", "sf0_01", device="cpu")
            for sql in (
                    "select o.orderpriority, count(*) c, sum(l.quantity) q "
                    "from orders o join lineitem l on l.orderkey = "
                    "o.orderkey group by o.orderpriority "
                    "order by o.orderpriority",
                    "select n.name, count(*) c from customer c join nation "
                    "n on c.nationkey = n.nationkey group by n.name "
                    "order by c desc, n.name limit 5"):
                got = coord.execute(sql).rows()
                want = cpu.execute(sql).rows()
                assert len(got) == len(want)
                for g, w in zip(got, want):
                    for a, b in zip(g, w):
                        assert a == b or abs(a - b) <= 1e-6 * abs(b)
            kernels = [json.loads(http_get(f"{u}/v1/info"))["kernels"]
                       for u in urls]
            for k in ("exchange_partition", "df_bounds", "df_distinct_set",
                      "df_apply"):
                assert sum(kk.get(k, 0) for kk in kernels) > 0, k
        finally:
            coord.stop()
    finally:
        stop_workers(procs)


# -- K24 sort_encode, K25 radix_sort, K26 gather_rows, K27 limit_rank --------

_SORT_DTYPES = [torch.bool, torch.int8, torch.int16, torch.int32, torch.int64,
                torch.float32, torch.float64]


def _sort_key(rng, dt, n):
    """Values of one key with its type's edge cases (NaN, -0.0, +-inf,
    the width's minimum and maximum)."""
    if dt == torch.bool:
        return torch.from_numpy(rng.random(n) < 0.5)
    if dt.is_floating_point:
        pool = np.array([np.nan, -0.0, 0.0, -np.inf, np.inf, -2.5, 1.0, 3.25])
        return torch.from_numpy(rng.choice(pool, n)).to(dt)
    ii = torch.iinfo(dt)
    pool = np.array([ii.min, ii.min + 1, -3, -1, 0, 1, 4, ii.max])
    return torch.from_numpy(rng.choice(pool, n)).to(dt)


def _sort_parts(rng, n, dts, dev, split=None):
    keys = [(_sort_key(rng, dt, n), torch.from_numpy(rng.random(n) < 0.8))
            for dt in dts]
    valid = torch.from_numpy(rng.random(n) < 0.9)
    cuts = [(0, n)] if split is None else [(0, split), (split, n)]
    return [([(d[a:b].to(dev), m[a:b].to(dev)) for d, m in keys],
             valid[a:b].to(dev)) for a, b in cuts]


@pytest.mark.parametrize("dt", _SORT_DTYPES, ids=str)
@pytest.mark.parametrize("desc,nf", [(False, False), (True, True)])
@pytest.mark.parametrize("split", [None, 700], ids=["one", "two_sources"])
def test_k24_words_match_plain(hopper, dt, desc, nf, split):
    """K24's words and digit masks equal the plain version's bit for bit
    (a key of `dt`, then an INTEGER and a DOUBLE key; one source, or the
    rows split over two as topn passes state and batch)."""
    rng = np.random.default_rng(61)
    parts = _sort_parts(rng, 2000, [dt, torch.int32, torch.float64], hopper,
                        split)
    desc_, nf_ = [desc, False, True], [nf, True, False]
    before = tc.SORT_ENCODE_KERNEL.launches
    got = tc.sort_encode(parts, desc_, nf_)
    assert tc.SORT_ENCODE_KERNEL.launches == before + 1
    cpu = [([(d.cpu(), m.cpu()) for d, m in k], v.cpu()) for k, v in parts]
    want = tc.sort_encode_plain(cpu, desc_, nf_)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1 << 20, 1 << 24])
@pytest.mark.parametrize("skip", [True, False], ids=["skip", "every_digit"])
def test_k25_perm_matches_plain(hopper, n, skip):
    """K25's permutation of K24's words equals the plain version's, with
    constant digits skipped (K24's digit masks passed) and with every
    digit sorted (no masks)."""
    rng = np.random.default_rng(n)
    parts = _sort_parts(rng, n, [torch.float64, torch.int32], hopper)
    words, digits = tc.sort_encode(parts, [True, False], [False, True])
    before = tc.RADIX_SORT_KERNEL.launches
    perm, _ = tc.radix_sort(words, digits if skip else None)
    assert tc.RADIX_SORT_KERNEL.launches == before + 1
    want, _ = tc.radix_sort_plain(words, digits)
    torch.cuda.synchronize()
    assert torch.equal(perm, want)


def test_k25_build_hashes_equal_torch_sort(hopper):
    """At a join build K25's sorted hashes equal torch.sort's, the dead
    rows' sentinels included, and so does its permutation (stable)."""
    rng = np.random.default_rng(62)
    n = 1 << 22
    b = _build_batch(rng, n, int(n * 0.4), hopper, 100_000)
    h, h2, _ = tj._hash_batch(b, ("k0",))
    before = tc.RADIX_SORT_KERNEL.launches
    table = tj.build_for_backend(b, ("k0",))
    assert tc.RADIX_SORT_KERNEL.launches == before + 1
    sh, perm = torch.sort(h, stable=True)
    assert torch.equal(table.sorted_hash, sh)
    assert torch.equal(table.hash2, h2[perm])
    assert torch.equal(table.batch.row_valid, b.row_valid[perm])
    for name, c in b.columns.items():
        assert torch.equal(table.batch.columns[name].data, c.data[perm])
        assert torch.equal(table.batch.columns[name].mask, c.mask[perm])


@pytest.mark.parametrize("rows,limit", [(None, None), (1000, 17),
                                        (1000, "device")])
@pytest.mark.parametrize("split", [None, 3000], ids=["one", "two_sources"])
def test_k26_matches_indexing(hopper, rows, limit, split):
    """K26 equals indexing every column (and row_valid) by the
    permutation, the first `rows`, masks ANDed with the liveness under a
    limit (an int or a device scalar)."""
    rng = np.random.default_rng(63)
    n = 5000
    parts = _sort_parts(rng, n, _SORT_DTYPES, hopper, split)
    parts = [(cols + [(torch.arange(len(v), device=hopper), None)], v)
             for cols, v in parts]
    perm = torch.from_numpy(rng.permutation(n)).to(hopper)
    lim = torch.tensor(23, device=hopper) if limit == "device" else limit
    before = tc.GATHER_ROWS_KERNEL.launches
    got, gv = tc.gather_rows(parts, perm, rows, lim)
    assert tc.GATHER_ROWS_KERNEL.launches == before + 1
    want, wv = tc.gather_rows_plain(parts, perm, rows, lim)
    torch.cuda.synchronize()
    assert torch.equal(gv, wv)
    for (gd, gm), (wd, wm) in zip(got, want):
        assert torch.equal(gd.view(torch.uint8) if gd.is_floating_point()
                           else gd, wd.view(torch.uint8)
                           if wd.is_floating_point() else wd)
        assert (gm is None and wm is None) or torch.equal(gm, wm)


def test_k27_limit_over_batches_without_host_sync(hopper):
    """K27 over a multi-batch LIMIT equals the plain version, batch by
    batch, with no host synchronisation inside the calls."""
    from presto_tpu_torch.ops import sort as tsort
    rng = np.random.default_rng(64)
    valids = [torch.from_numpy(rng.random(1 << 20) < 0.6).to(hopper)
              for _ in range(5)]
    tsort.limit_rank(valids[0], 1, torch.zeros((), dtype=torch.int64,
                                                device=hopper))  # build
    emitted = torch.zeros((), dtype=torch.int64, device=hopper)
    outs = []
    before = tsort.LIMIT_RANK_KERNEL.launches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for v in valids:
            keep, emitted = tsort.limit_rank(v, 2_000_000, emitted)
            outs.append((keep, emitted))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tsort.LIMIT_RANK_KERNEL.launches == before + 5
    pe = torch.zeros((), dtype=torch.int64, device=hopper)
    for v, (keep, em) in zip(valids, outs):
        pk, pe = tsort.limit_rank_plain(v, 2_000_000, pe)
        assert torch.equal(keep, pk) and int(em) == int(pe)
    assert int(emitted) == 2_000_000


def test_sort_family_runs_k24_to_k27_and_no_library_sort(hopper,
                                                          monkeypatch):
    """sort_batch, topn_step, limit_batch, distinct_step, the join build,
    the sort-based grouping and lex_perm on the card launch K24-K27 and
    never torch.sort, torch.argsort or torch.topk."""
    from presto_tpu_torch.ops import sort as tsort

    def refuse(*a, **k):
        raise AssertionError("a library sort ran on the card path")
    rng = np.random.default_rng(65)
    b = _build_batch(rng, 1 << 16, 50_000, hopper, 3000, nkeys=2)
    schema = [(k, c.type, None) for k, c in b.columns.items()]
    counters = (tc.SORT_ENCODE_KERNEL, tc.RADIX_SORT_KERNEL,
                tc.GATHER_ROWS_KERNEL, tsort.LIMIT_RANK_KERNEL)
    before = [c.launches for c in counters]
    for name in ("sort", "argsort", "topk"):
        monkeypatch.setattr(torch, name, refuse)
    s = tsort.sort_batch(b, ("k0", "k1"), (True, False), (False, True))
    st = tsort.topn_step(tsort.topn_state(schema, 128, hopper), b, 100,
                         ("k1",), (False,), (False,))
    lim, _ = tsort.limit_batch(b, 10, torch.zeros((), dtype=torch.int64,
                                                  device=hopper))
    d = tsort.distinct_step(tsort.distinct_state(schema[:1], 1 << 16,
                                                 hopper),
                            tb.Batch({"k0": b.columns["k0"]}, b.row_valid))
    tj.build_for_backend(b, ("k0",))
    th.batch_aggregate(b.row_valid, [b.columns["k0"].astuple()],
                       [None], [b.row_valid], [th.make_count(None)], 1 << 16)
    h1, h2 = tc.row_hash_pair([b.columns["k1"].astuple()], b.row_valid,
                              False)
    tc.lex_perm([h1, h2])
    monkeypatch.undo()
    torch.cuda.synchronize()
    grown = [c.launches - x for c, x in zip(counters, before)]
    assert all(g > 0 for g in grown), grown
    assert int(s.row_valid.sum()) == 50_000 and int(st.row_valid.sum()) == 100
    assert int(lim.row_valid.sum()) == 10 and int(d.row_valid.sum()) > 0


#: test_torch_array's queries with an ORDER BY over array_agg results
ARRAY_ORDER_BY = [
    "select regionkey, array_agg(nationkey) a from nation "
    "group by regionkey order by regionkey",
    "select regionkey, array_agg(name) nm from nation "
    "where nationkey < 4 group by regionkey order by regionkey",
    "select regionkey, map_agg(nationkey, name) m from nation "
    "where nationkey < 6 group by regionkey order by regionkey",
    "select regionkey, array_agg(nationkey) filter (where nationkey > 10)"
    " a from nation group by regionkey order by regionkey",
    "select g, array_agg(v) filter (where keep) a from (values "
    "(1, 10, true), (1, 11, false), (1, 12, true), (1, 13, false), "
    "(2, 20, false), (2, 21, true)) t(g, v, keep) group by g order by g",
]


def test_array_columns_sort_on_the_card_as_on_cpu(hopper):
    """ORDER BY over array_agg / map_agg results on the card (K24-K26
    carrying the arrays' slot columns) equals the CPU runner's rows, in
    order."""
    from presto_tpu_torch.runner import LocalRunner
    gpu = LocalRunner("tpch", "tiny", device=hopper)
    cpu = LocalRunner("tpch", "tiny", device="cpu")
    for q in ARRAY_ORDER_BY:
        before = tc.GATHER_ROWS_KERNEL.launches
        got = gpu.execute(q).rows()
        assert tc.GATHER_ROWS_KERNEL.launches > before
        assert got == cpu.execute(q).rows(), q


def test_array_carrying_join_matches_cpu(hopper):
    """A join whose build side carries array_agg results (its slot
    columns, through K25 and K26 at the build) on the card equals the
    CPU runner's rows."""
    from presto_tpu_torch.runner import LocalRunner
    q = ("select n.name, a.ks from nation n join (select regionkey, "
         "array_agg(nationkey) ks from nation group by regionkey) a "
         "on n.regionkey = a.regionkey order by n.name")
    gpu = LocalRunner("tpch", "tiny", device=hopper)
    before = tc.RADIX_SORT_KERNEL.launches
    got = gpu.execute(q).rows()
    assert tc.RADIX_SORT_KERNEL.launches > before
    assert got == LocalRunner("tpch", "tiny", device="cpu").execute(q).rows()


# -- ROADMAP C6r: K5, K7, K8 and K9 past 24 key columns; K24 past 32 keys ----


def test_wide_join_and_order_by_on_the_card_match_cpu(hopper):
    """A 25-key join (K3-K5, K9 with the key groups past the third in a
    device descriptor) and a 33-key ORDER BY (K24 in two runs of keys)
    through the runner on the card give the CPU runner's rows."""
    from presto_tpu_torch.runner import LocalRunner
    cols = ["orderkey", "partkey", "suppkey", "linenumber", "quantity",
            "returnflag", "linestatus", "shipdate", "shipmode"]
    keys = cols + [f"linenumber + {i}" for i in range(16)] \
        + [f"partkey * {i + 2}" for i in range(8)]
    sel = ", ".join(f"{k} k{i}" for i, k in enumerate(keys))
    on = " and ".join(f"a.k{i} = b.k{i}" for i in range(25))
    q_join = (f"select count(*), sum(a.k0) from (select {sel} from lineitem)"
              f" a join (select {sel} from lineitem) b on {on}")
    order = ", ".join(f"k{i}" + (" desc" if i % 3 == 1 else "")
                      for i in range(33))
    q_order = (f"select k0, k3, k30 from (select {sel} from lineitem) "
               f"order by {order}")
    gpu = LocalRunner("tpch", "tiny", device=hopper)
    cpu = LocalRunner("tpch", "tiny", device="cpu")
    before = tj.JOIN_PROBE_KERNEL.launches
    assert gpu.execute(q_join).rows() == cpu.execute(q_join).rows()
    assert tj.JOIN_PROBE_KERNEL.launches > before
    before = tc.SORT_ENCODE_KERNEL.launches
    assert gpu.execute(q_order).rows() == cpu.execute(q_order).rows()
    assert tc.SORT_ENCODE_KERNEL.launches >= before + 2


@pytest.mark.parametrize("nkeys", [33, 40])
def test_k24_past_32_keys_matches_plain(hopper, nkeys):
    rng = np.random.default_rng(62)
    dts = [torch.int64, torch.int32, torch.float64, torch.int16] * 10
    parts = _sort_parts(rng, 3000, dts[:nkeys], hopper, None)
    desc = [bool(i % 3 == 1) for i in range(nkeys)]
    nf = [bool(i % 2) for i in range(nkeys)]
    before = tc.SORT_ENCODE_KERNEL.launches
    got = tc.sort_encode(parts, desc, nf)
    assert tc.SORT_ENCODE_KERNEL.launches == before + 2
    cpu = [([(d.cpu(), m.cpu()) for d, m in k], v.cpu()) for k, v in parts]
    want = tc.sort_encode_plain(cpu, desc, nf)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# -- ROADMAP B4: hashagg_merge, agg_shrink, agg_count, agg_finalize; A5 -----

from presto_tpu_torch.ops import agg_kernels as tak  # noqa: E402
from presto_tpu_torch.operators import aggregation as tagg  # noqa: E402


def _approx_aggs():
    return [th.make_approx_percentile(0.5), th.make_approx_distinct(
        tt.BIGINT), th.make_checksum(tt.BIGINT), th.make_sum(tt.DOUBLE,
                                                              tt.DOUBLE),
            th.make_count(None), th.make_approx_distinct(tt.DOUBLE, 0.01)]


def _approx_batch(rng, n, dev, groups=5000):
    rv = rng.random(n) < 0.9
    keys = [(rng.integers(0, groups, n).astype(np.int64),
             rng.random(n) < 0.98)]
    x = rng.lognormal(3.0, 2.0, n) * np.where(rng.random(n) < 0.2, -1, 1)
    inputs = [x, rng.integers(0, 1 << 40, n), rng.integers(-1 << 40, 1 << 40,
                                                           n),
              x, None, x]
    w = [rv & (rng.random(n) < 0.95) for _ in inputs]

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)
    return (t(rv), [(t(d), t(m)) for d, m in keys],
            [None if a is None else t(a) for a in inputs], [t(a) for a in w])


def _assert_group_states_equal(got, want):
    live = want.valid
    assert torch.equal(got.valid, live)
    assert int(got.live) == int(want.live) == int(live.sum())
    for (gd, gm), (wd, wm) in zip(got.keys, want.keys):
        assert torch.equal(gm[live], wm[live])
        assert torch.equal(gd[live], wd[live])
    _assert_states_close(got.states, want.states, live)


def test_batch_aggregate_with_vector_states_matches_plain(hopper):
    """K3 + K25 + K26 + K6 + K30's sparse mode against the plain
    composition: vector states exact, the live count K6's."""
    rng = np.random.default_rng(201)
    aggs = _approx_aggs()
    rv, keys, inputs, w = _approx_batch(rng, 1 << 20, hopper)
    contribs = th._make_contribs(aggs, inputs, w, [False] * len(aggs))
    before = tak.VECTOR_REDUCE_KERNEL.launches
    got = th._group_reduce(keys, rv, contribs, aggs, 1 << 13)
    assert tak.VECTOR_REDUCE_KERNEL.launches == before + 3
    want = th._group_reduce(keys, rv, contribs, aggs, 1 << 13, plain=True)
    torch.cuda.synchronize()
    _assert_group_states_equal(got, want)


def _sorted_approx_batch(rng, n, dev, groups=5000):
    """A batch in key order (ascending, the NULL keys last) for the
    streaming aggregation, with _approx_aggs' inputs."""
    rv, keys, inputs, w = _approx_batch(rng, n, dev, groups)
    d = np.sort(rng.integers(0, groups, n).astype(np.int64))
    m = np.arange(n) < n - 100
    return rv, [(torch.from_numpy(d).to(dev), torch.from_numpy(m).to(dev))], \
        inputs, w


@pytest.mark.parametrize("carry_kind", ["same", "differs", "none"])
def test_k8_k30_stream_step_with_vector_states_matches_plain(hopper,
                                                            carry_kind):
    """A streaming round with vector states: K8 over the scalar
    components, K30 over the vector ones on K8's segments, the carried
    group's rows folded into group 0 when K8 finds the same keys;
    vector states exact against the plain fold."""
    rng = np.random.default_rng(206)
    n = 1 << 18
    aggs = _approx_aggs()
    rv, keys, inputs, w = _sorted_approx_batch(rng, n, hopper)
    contribs = th._make_contribs(aggs, inputs, w, [False] * len(aggs))
    carry = th.init_state([tt.BIGINT], aggs, 1, hopper)
    if carry_kind != "none":
        first = int(torch.nonzero(rv)[0])
        carry.keys[0][0][0] = keys[0][0][first] \
            - (1 if carry_kind == "differs" else 0)
        carry.keys[0][1][0] = True
        for st in carry.states:
            for a in st:
                a[0] = 2.5 if a.is_floating_point() else torch.from_numpy(
                    rng.integers(0, 9, a[0].shape)).to(a.dtype)
        carry.valid[0] = True
    before = (th.STREAM_REDUCE_KERNEL.launches,
              tak.VECTOR_REDUCE_KERNEL.launches)
    got = th.stream_step(carry, rv, keys, contribs, aggs, n)
    assert th.STREAM_REDUCE_KERNEL.launches == before[0] + 1
    assert tak.VECTOR_REDUCE_KERNEL.launches == before[1] + 3
    want = th.stream_fold_plain(
        carry, th.presorted_reduce_plain(rv, keys, contribs, aggs, n), aggs)
    torch.cuda.synchronize()
    (g_ce, g_em, g_co, g_last), (w_ce, w_em, w_co, w_last) = got, want
    assert torch.equal(g_ce.valid, w_ce.valid)
    assert int(g_last) == int(w_last)
    assert torch.equal(g_em.valid, w_em.valid)
    _assert_states_close(g_em.states, w_em.states, w_em.valid)
    assert torch.equal(g_co.valid, w_co.valid)
    _assert_states_close(g_co.states, w_co.states,
                         torch.ones(1, dtype=torch.bool, device=hopper))
    if carry_kind != "none":
        assert bool(w_ce.valid[0]) == (carry_kind != "same")


@pytest.mark.parametrize("nstates", [2, 5, 8])
def test_merge_partials_reads_its_sources_without_a_concat(hopper,
                                                           nstates,
                                                           monkeypatch):
    """hashagg_merge on the card: K3 and K26 read the states as sources
    and K30 their vector rows through the permutation; no torch.cat."""
    rng = np.random.default_rng(202 + nstates)
    aggs = _approx_aggs()
    states = []
    for i in range(nstates):
        rv, keys, inputs, w = _approx_batch(rng, 1 << 16, hopper)
        contribs = th._make_contribs(aggs, inputs, w, [False] * len(aggs))
        states.append(th._group_reduce(keys, rv, contribs, aggs, 1 << 13))
    want = th.merge_partials(states, aggs, 1 << 13, plain=True)
    torch.cuda.synchronize()
    before = (tc.ROW_HASH_SOURCES_KERNEL.launches,
              tc.GATHER_ROWS_KERNEL.launches,
              tc.GATHER_SOURCES_KERNEL.launches)

    def no_cat(*a, **k):
        raise AssertionError("torch.cat in merge_partials on the card")
    monkeypatch.setattr(torch, "cat", no_cat)
    got = th.merge_partials(states, aggs, 1 << 13)
    monkeypatch.undo()
    assert tc.ROW_HASH_SOURCES_KERNEL.launches == before[0] + 1
    assert tc.GATHER_ROWS_KERNEL.launches > before[1]
    assert tc.GATHER_SOURCES_KERNEL.launches > before[2] or nstates <= 2
    torch.cuda.synchronize()
    _assert_group_states_equal(got, want)


@pytest.mark.parametrize("domains", [(), (3, 2), (255, 255)],
                         ids=["global", "q1_keys", "global_atomics"])
def test_k30_direct_matches_plain(hopper, domains):
    rng = np.random.default_rng(203)
    n = 1 << 20
    aggs = _approx_aggs()
    slots = int(np.prod([d + 1 for d in domains])) if domains else 1
    rv, _, inputs, w = _approx_batch(rng, n, hopper)
    keys = [(torch.from_numpy(rng.integers(0, d, n).astype(np.int32)).to(
        hopper), torch.from_numpy(rng.random(n) < 0.9).to(hopper))
        for d in domains]
    got = th.direct_init(aggs, slots, hopper)
    before = tak.VECTOR_REDUCE_KERNEL.launches
    th.direct_step(got, rv, keys, domains, inputs, w, aggs)
    th.direct_step(got, rv, keys, domains, inputs, w, aggs)
    assert tak.VECTOR_REDUCE_KERNEL.launches == before + 6
    cpu = th.direct_init(aggs, slots, torch.device("cpu"))
    for _ in range(2):
        th.direct_step(cpu, rv.cpu(), [(c.cpu(), m.cpu()) for c, m in keys],
                       domains, [None if x is None else x.cpu()
                                 for x in inputs], [x.cpu() for x in w],
                       aggs)
    torch.cuda.synchronize()
    assert torch.equal(got.present.cpu(), cpu.present)
    for gs, cs in zip(got.states, cpu.states):
        for g, c in zip(gs, cs):
            if g.is_floating_point():
                torch.testing.assert_close(g.cpu(), c, rtol=1e-9, atol=1e-6)
            else:
                assert torch.equal(g.cpu(), c)


def _fin_aggs():
    return [th.make_sum(tt.DOUBLE, tt.DOUBLE), th.make_sum(tt.BIGINT,
                                                           tt.BIGINT),
            th.make_count(None), th.make_avg(tt.DOUBLE),
            th.make_min(tt.INTEGER), th.make_max(tt.DOUBLE)] + [
        th.make_variance(k) for k in ("var_samp", "var_pop", "stddev",
                                      "stddev_pop")] + [
        th.make_count_if(), th.make_bool_and(False), th.make_bool_and(True),
        th.make_geometric_mean(), th.make_moments("skewness"),
        th.make_moments("kurtosis"), th.make_entropy(),
        th.make_checksum(tt.BIGINT), th.make_approx_percentile(0.9),
        th.make_approx_distinct(tt.BIGINT)]


def _fin_inputs(rng, n, aggs, dev):
    out = []
    for a in aggs:
        if a.name == "count":
            out.append(None)
        elif a.name in ("count_if", "bool_and", "bool_or"):
            out.append(torch.from_numpy(rng.random(n) < 0.7).to(dev))
        elif a.name in ("min",):
            out.append(torch.from_numpy(rng.integers(-1000, 1000, n).astype(
                np.int32)).to(dev))
        elif a.name in ("sum",) and a.output_type == tt.BIGINT:
            out.append(torch.from_numpy(rng.integers(-1000, 1000, n)).to(dev))
        elif a.name.startswith("approx_distinct") or a.name == "checksum":
            out.append(torch.from_numpy(rng.integers(0, 1 << 30, n)).to(dev))
        else:
            out.append(torch.from_numpy(rng.lognormal(2.0, 1.0, n)).to(dev))
    return out


def _assert_batches_equal(got, want, float_rtol=1e-12):
    assert got.capacity == want.capacity
    assert torch.equal(got.row_valid.cpu(), want.row_valid.cpu())
    assert list(got.columns) == list(want.columns)
    for name in want.columns:
        g, w = got.columns[name], want.columns[name]
        assert g.data.dtype == w.data.dtype, name
        gm, wm = g.mask.cpu(), w.mask.cpu()
        assert torch.equal(gm, wm), name
        gd, wd = g.data.cpu()[wm], w.data.cpu()[wm]
        if gd.is_floating_point():
            torch.testing.assert_close(gd, wd, rtol=float_rtol, atol=0,
                                       equal_nan=True, msg=name)
        else:
            assert torch.equal(gd, wd), name


@pytest.mark.parametrize("domains", [(), (3, 2)], ids=["global", "keys"])
@pytest.mark.parametrize("partial", [False, True],
                         ids=["final", "intermediate"])
def test_k29_direct_matches_plain(hopper, domains, partial):
    """One K29 launch per drain of the direct path against the composed
    drain on the same (card) state, every final op: integers exactly,
    floats to 1e-12 relative (the same IEEE operations, in one kernel)."""
    rng = np.random.default_rng(204)
    n = 1 << 18
    aggs = _fin_aggs()
    if partial:
        aggs = [a for a in aggs if a.intermediate_types]
    slots = int(np.prod([d + 1 for d in domains])) if domains else 1
    rv = torch.from_numpy(rng.random(n) < 0.9).to(hopper)
    keys = [(torch.from_numpy(rng.integers(0, d, n).astype(np.int32)).to(
        hopper), torch.from_numpy(rng.random(n) < 0.9).to(hopper))
        for d in domains]
    inputs = _fin_inputs(rng, n, aggs, hopper)
    w = [rv & torch.from_numpy(rng.random(n) < 0.9).to(hopper)
         for _ in aggs]
    st = th.direct_init(aggs, slots, hopper)
    th.direct_step(st, rv, keys, domains, inputs, w, aggs)
    names = [f"k{i}" for i in range(len(domains))]
    ktypes = [tt.INTEGER] * len(domains)
    dicts = [None] * len(domains)
    outs = [f"a{i}" for i in range(len(aggs))]
    fn = th.direct_intermediate if partial else th.direct_finalize
    plain = th.direct_intermediate_plain if partial \
        else th.direct_finalize_plain
    before = tak.AGG_FINALIZE_KERNEL.launches
    got = fn(st, names, ktypes, dicts, domains, outs, aggs)
    assert tak.AGG_FINALIZE_KERNEL.launches == before + 1
    want = plain(st, names, ktypes, dicts, domains, outs, aggs)
    torch.cuda.synchronize()
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("partial", [False, True],
                         ids=["final", "intermediate"])
def test_k29_sorted_matches_plain(hopper, partial):
    rng = np.random.default_rng(205)
    n = 1 << 18
    aggs = _fin_aggs()
    if partial:
        aggs = [a for a in aggs if a.intermediate_types]
    rv = torch.from_numpy(rng.random(n) < 0.9).to(hopper)
    keys = [(torch.from_numpy(rng.integers(0, 3000, n)).to(hopper),
             torch.from_numpy(rng.random(n) < 0.95).to(hopper))]
    inputs = _fin_inputs(rng, n, aggs, hopper)
    w = [rv & torch.from_numpy(rng.random(n) < 0.9).to(hopper)
         for _ in aggs]
    st = th.batch_aggregate(rv, keys, inputs, w, aggs, 4096)
    outs = [f"a{i}" for i in range(len(aggs))]
    fn = th.intermediate_batch if partial else th.finalize
    plain = th.intermediate_batch_plain if partial else th.finalize_plain
    before = tak.AGG_FINALIZE_KERNEL.launches
    got = fn(st, ["k"], [tt.BIGINT], [None], outs, aggs)
    # an intermediate drain whose arrays are already of their columns'
    # types aliases them and launches nothing (bool_and's BOOLEAN
    # intermediate needs a cast: one launch)
    assert tak.AGG_FINALIZE_KERNEL.launches == before + 1
    want = plain(st, ["k"], [tt.BIGINT], [None], outs, aggs)
    torch.cuda.synchronize()
    _assert_batches_equal(got, want)


def test_k28_shrink_copies_into_new_storage(hopper):
    """K28 against the plain copy; every shrunk array owns storage of its
    own size (ROADMAP C10), vector components included."""
    rng = np.random.default_rng(206)
    aggs = _approx_aggs()
    rv, keys, inputs, w = _approx_batch(rng, 1 << 18, hopper, groups=3000)
    contribs = th._make_contribs(aggs, inputs, w, [False] * len(aggs))
    st = th._group_reduce(keys, rv, contribs, aggs, 1 << 16)
    cap = 4096
    before = tak.STATE_SHRINK_KERNEL.launches
    got = tagg._shrink_state(st, cap)
    assert tak.STATE_SHRINK_KERNEL.launches == before + 1
    torch.cuda.synchronize()
    arrays = [a for d, m in got.keys for a in (d, m)] \
        + [a for t in got.states for a in t] + [got.valid]
    olds = [a for d, m in st.keys for a in (d, m)] \
        + [a for t in st.states for a in t] + [st.valid]
    for a, o in zip(arrays, olds):
        assert a.shape[0] == cap
        assert a.untyped_storage().nbytes() == a.numel() * a.element_size()
        assert torch.equal(a, o[:cap])
    assert got.live is st.live


def test_agg_count_reads_the_carried_count(hopper):
    """agg_count launches no reduction: the count is K6's."""
    rng = np.random.default_rng(207)
    aggs = _approx_aggs()[:3]
    rv, keys, inputs, w = _approx_batch(rng, 1 << 18, hopper)
    st = th.batch_aggregate(rv, keys, inputs[:3], w[:3], aggs, 1 << 13)
    torch.cuda.synchronize()
    seen = []
    real_sum = torch.Tensor.sum

    def counting_sum(self, *a, **k):
        seen.append(self.shape)
        return real_sum(self, *a, **k)
    torch.Tensor.sum = counting_sum
    try:
        pending = tagg._count_live(st)
    finally:
        torch.Tensor.sum = real_sum
    assert not seen
    assert pending.get() == int(tagg.count_live_plain(st.valid))


_APPROX_QUERIES = [
    "select returnflag, linestatus, approx_percentile(extendedprice, 0.5), "
    "approx_distinct(partkey), checksum(orderkey) from lineitem group by 1, 2",
    "select suppkey, approx_percentile(quantity, 0.9), "
    "approx_distinct(orderkey) from lineitem group by suppkey",
    "select approx_distinct(orderkey) from lineitem",
    "select custkey, approx_percentile(totalprice, 0.25), "
    "approx_distinct(orderdate, 0.01), checksum(comment) from orders "
    "group by custkey",
]


@pytest.mark.parametrize("q", range(len(_APPROX_QUERIES)))
def test_approx_queries_on_the_card_match_cpu(hopper, q):
    from presto_tpu_torch.runner import LocalRunner
    sql = _APPROX_QUERIES[q]
    before = (tak.VECTOR_REDUCE_KERNEL.launches,
              tak.AGG_FINALIZE_KERNEL.launches)
    got = sorted(LocalRunner("tpch", "sf0_01", device=hopper).execute(sql)
                 .rows(), key=repr)
    assert tak.VECTOR_REDUCE_KERNEL.launches > before[0]
    assert tak.AGG_FINALIZE_KERNEL.launches > before[1]
    want = sorted(LocalRunner("tpch", "sf0_01", device="cpu").execute(sql)
                  .rows(), key=repr)
    assert got == want
