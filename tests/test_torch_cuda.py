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


def test_sort_aggregation_matches_cpu(hopper):
    """batch_aggregate (K3 + sort + K6) on the card against the same
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
    """DISTINCT's fold on the card (K3 + sort + K6) against the same
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
