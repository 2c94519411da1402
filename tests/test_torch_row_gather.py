"""The host logic of K26 (`gather_rows`) and K27 (`limit_rank`), on the
CPU: how a K26 launch packs its arrays into records (each element
aligned, the bools one bit each) and from how many far pairs of the
permutation's probe it stages them, the probe's twin, the launches of
a call with many arrays, the descriptor the wrapper hands the kernel,
and K27's tiles and cached status words. The kernels themselves are
held against their plain versions on the card in
tests/test_torch_cuda.py.
"""

import ctypes
import math

import numpy as np
import pytest
import torch

from presto_tpu_torch.native import cuda
from presto_tpu_torch.ops import common as tc
from presto_tpu_torch.ops import sort as ts

#: (element bytes, bool) of the arrays of a few launches: ORDER_LINES'
#: three columns with masks; a join build's columns and its second hash;
#: every width; no bool; one bool; many bools
LAYOUTS = {
    "order_lines": [(8, False), (1, True), (4, False), (1, True), (8, False),
                    (1, True)],
    "build": [(8, False), (1, True), (4, False), (1, True), (8, False)],
    "widths": [(1, True), (1, False), (2, False), (4, False), (8, False),
               (1, True), (2, False), (8, False), (4, False), (1, False)],
    "no_bool": [(8, False), (4, False), (2, False)],
    "one_bool": [(8, False), (1, True)],
    "many_bools": [(1, True)] * 40 + [(8, False)] * 3,
}


def _check_plan(layout, groups):
    """Every array in one group once, the staged groups first; a staged
    group's members (two or more) fit its record without overlap, each
    element aligned to its width, the bools one bit each after them; a
    group read where it lies holds one array."""
    placed = [c for _, members in groups for c, _, _ in members]
    assert sorted(placed) == list(range(len(layout)))
    strides = [g[0] for g in groups]
    assert strides == sorted(strides, reverse=True)
    for stride, members in groups:
        if stride == 0:
            assert len(members) == 1 and members[0][1:] == (0, -1)
            continue
        assert stride in (16, 32) and len(members) >= 2
        bits = [(at, bit) for c, at, bit in members if bit >= 0]
        used = 0
        for c, at, bit in members:
            size, is_bool = layout[c]
            if bit >= 0:
                assert is_bool and size == 1
                continue
            assert not is_bool and at == used and at % size == 0
            used += size
        assert len(set(bits)) == len(bits)
        assert all(used <= at < stride and 0 <= bit < 8 for at, bit in bits)
        top = max([used] + [at + 1 for at, _ in bits])
        assert top <= stride and (stride == 16 or top > 16)


def _need(sizes, valid_read, rows, src_rows, groups):
    """The far samples from which `groups` pay, by gather_plan's model:
    far rows x the reads they save x a random read's bytes x the share
    of the sources beyond the L2 reach the pre-pass's bytes."""
    staged = [g for g in groups if g[0]]
    cost = src_rows * (sum(sizes[c] for _, m in staged for c, _, _ in m)
                       + sum(g[0] for g in staged))
    src_bytes = src_rows * (sum(sizes) + int(valid_read))
    miss = (src_bytes - tc.GATHER_L2_BYTES) / src_bytes
    gain = rows * (len(sizes) + int(valid_read) - len(groups)) \
        * tc.GATHER_RANDOM_BYTES * miss
    return math.ceil(cost * tc.GATHER_PROBE / gain)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
@pytest.mark.parametrize("valid_read", [False, True])
@pytest.mark.parametrize("rows,src_rows", [(1 << 24, 1 << 24),
                                           (4096, 2_101_248), (7, 7)])
def test_gather_plan_places_every_array_once(name, valid_read, rows,
                                             src_rows):
    layout = LAYOUTS[name]
    sizes = [s for s, _ in layout]
    for stage in (None, True, False):
        groups, need = tc.gather_plan(sizes, [b for _, b in layout],
                                      valid_read, rows, src_rows, stage)
        _check_plan(layout, groups)
        staged = any(g[0] for g in groups)
        if stage is False:
            assert not staged
        if stage is True:
            assert need == 0
        if stage is None:
            assert 0 < need <= tc.GATHER_PROBE if staged else need == 0
            if staged:
                assert need == _need(sizes, valid_read, rows, src_rows,
                                     groups)


def test_gather_plan_stages_where_it_pays():
    sizes = [s for s, _ in LAYOUTS["order_lines"]]
    bools = [b for _, b in LAYOUTS["order_lines"]]
    # ORDER_LINES: every slot moves; one 32-byte record a row: the
    # BIGINT, the DOUBLE, the INTEGER, then the three masks as bits 0-2
    # of byte 20; the kernel runs it from the need's far samples on
    record = [(32, [(0, 0, -1), (4, 8, -1), (2, 16, -1), (1, 20, 0),
                    (3, 20, 1), (5, 20, 2)])]
    groups, need = tc.gather_plan(sizes, bools, True, 1 << 24, 1 << 24)
    assert groups == record
    assert need == _need(sizes, True, 1 << 24, 1 << 24, record)
    assert 0 < need < tc.GATHER_PROBE
    assert tc.gather_plan(sizes, bools, True, 1 << 24, 1 << 24,
                          True) == (record, 0)
    # 13 bytes a row: 16-byte records
    assert tc.gather_plan([8, 1, 4], [False, True, False], False, 1 << 24,
                          1 << 24, True) == ([(16, [(0, 0, -1), (2, 8, -1),
                                                    (1, 12, 0)])], 0)
    # a topn state's 4,096 rows out of state ++ batch: the pre-pass over
    # two million rows would cost more than it saves
    direct = ([(0, [(c, 0, -1)]) for c in range(6)], 0)
    assert tc.gather_plan(sizes, bools, True, 4096, 2_101_248) == direct
    assert tc.gather_plan(sizes, bools, True, 1 << 24, 1 << 24,
                          False) == direct
    # sources that fit the L2 are read where they lie; the closer they
    # are to it, the more far rows the records need
    n = tc.GATHER_L2_BYTES // 24
    assert tc.gather_plan(sizes, bools, True, n, n) == direct
    needs = [tc.gather_plan(sizes, bools, True, k * n, k * n)
             for k in (2, 4, 8)]
    assert all(g == record for g, _ in needs)
    assert needs[0][1] > needs[1][1] > needs[2][1] > 0
    # one array, with or without row_valid: nothing to stage
    assert tc.gather_plan([8], [False], True, 1 << 24, 1 << 24) == (
        [(0, [(0, 0, -1)])], 0)
    assert tc.gather_plan([8], [False], True, 1 << 24, 1 << 24, True) == (
        [(0, [(0, 0, -1)])], 0)


def test_gather_plan_splits_wide_rows():
    """A join build's row of 3 BIGINTs and 2 INTEGERs with masks and its
    second hash: a full record of the BIGINTs and a 16-byte one of the
    INTEGERs and the bools; five BIGINTs: a record of four, and one
    read where it lies."""
    sizes = [8, 1, 8, 1, 8, 1, 4, 1, 4, 1, 8]
    bools = [s == 1 for s in sizes]
    groups, need = tc.gather_plan(sizes, bools, True, 1 << 24, 1 << 24)
    assert [g[0] for g in groups] == [32, 16]
    assert need == _need(sizes, True, 1 << 24, 1 << 24, groups)
    assert groups[1][1] == [(6, 0, -1), (8, 4, -1), (1, 8, 0), (3, 8, 1),
                            (5, 8, 2), (7, 8, 3), (9, 8, 4)]
    _check_plan(list(zip(sizes, bools)), groups)
    five = tc.gather_plan([8] * 5, [False] * 5, False, 1 << 24, 1 << 24,
                          True)
    assert five == ([(32, [(0, 0, -1), (1, 8, -1), (2, 16, -1),
                           (3, 24, -1)]), (0, [(4, 0, -1)])], 0)


def test_gather_plan_needs_more_far_rows_as_the_pre_pass_grows():
    """The fewer rows a launch moves out of its sources, the more of
    them must be far for the records to pay, until none can."""
    sizes = [s for s, _ in LAYOUTS["order_lines"]]
    bools = [b for _, b in LAYOUTS["order_lines"]]
    src = 1 << 24
    needs = [tc.gather_plan(sizes, bools, True, rows, src)[1]
             for rows in (src, src // 2, src // 4, src // 64)]
    staged = [n for n in needs if n]
    assert staged == sorted(staged) and len(set(staged)) == len(staged)
    assert needs[-1] == 0


def _far_twin(perm, rows):
    """The probe of csrc/gather_rows.cu `stage_runs` in plain Python,
    its 64-bit hash wrapping as the kernel's does."""
    far = 0
    seg = (rows - 1) // tc.GATHER_PROBE
    for t in range(tc.GATHER_PROBE if rows > 1 else 0):
        h = ctypes.c_uint64((t + 1) * 0x9E3779B97F4A7C15).value
        j = t * seg + (h >> 11) % seg if seg else \
            t * (rows - 1) // tc.GATHER_PROBE
        assert 0 <= j < rows - 1
        far += abs(int(perm[j + 1]) - int(perm[j])) > tc.GATHER_NEAR
    return far


@pytest.mark.parametrize("rows", [1, 2, 255, 256, 257, 10_000, 65_537])
def test_gather_far_counts_the_probe_pairs(rows):
    """`gather_far` counts what the kernel's probe counts: none over the
    identity or rows at most GATHER_NEAR apart, every pair over a
    reversal by steps beyond it, about the live share over K24's shape
    of a value order, and the same as a plain loop over any order."""
    rng = np.random.default_rng(rows)
    ident = torch.arange(rows)
    assert tc.gather_far(ident, rows) == 0
    assert tc.gather_far(ident * tc.GATHER_NEAR, rows) == 0
    if rows > 1:
        assert tc.gather_far(ident.flip(0) * (tc.GATHER_NEAR + 1), rows) \
            == tc.GATHER_PROBE
    valid = torch.from_numpy(rng.random(rows) < 0.4)
    idx = torch.arange(rows)
    live = idx[valid][torch.from_numpy(rng.permutation(int(valid.sum())))]
    k24 = torch.cat([live, idx[~valid]])
    rand = torch.from_numpy(rng.permutation(rows))
    for perm in (k24, rand):
        assert tc.gather_far(perm, rows) == _far_twin(perm, rows)
    assert tc.gather_far(k24, rows // 2) == _far_twin(k24, rows // 2)
    if rows >= 10_000:
        assert abs(tc.gather_far(k24, rows) / tc.GATHER_PROBE - 0.4) < 0.1


@pytest.mark.parametrize("rows", [1 << 16, 1 << 20, 1 << 22])
def test_gather_far_sees_runs_of_four(rows):
    """Runs of four consecutive rows in random order (a key's rows
    after a hash sort) at power-of-two sizes: about a quarter of the
    pairs are far, not every sampled one (the probe's offsets do not
    fall on the runs' phase)."""
    gen = torch.Generator().manual_seed(rows)
    runs = torch.randperm(rows // 4, generator=gen) * 4
    perm = (runs[:, None] + torch.arange(4)).reshape(-1)
    far = tc.gather_far(perm, rows)
    assert far == _far_twin(perm, rows)
    assert abs(far / tc.GATHER_PROBE - 0.25) < 0.1


def test_gather_launch_plans_read_row_valid_where_it_is_used():
    """Per launch: its arrays, its plan, and whether it reads row_valid
    (the first launch, which writes the output row_valid, and every
    launch whose masks are ANDed with liveness under a limit)."""
    cols = [(torch.zeros(1, dtype=torch.int64),
             torch.zeros(1, dtype=torch.bool)) for _ in range(40)]
    cols.append((torch.zeros(1, dtype=torch.int16), None))
    for has_valid in (True, False):
        for limit in (True, False):
            plans = tc.gather_launch_plans(cols, has_valid, limit, 1 << 20,
                                           1 << 20, 3, None)
            assert [p[0] for p in plans] == tc.gather_launches(81, 3)
            assert [p[2] for p in plans] == [
                has_valid and (i == 0 or limit) for i in range(len(plans))]
            for (lo, hi), (groups, need), valid_read in plans:
                sizes = [8 if (lo + k) % 2 == 0 and lo + k < 80 else
                         2 if lo + k == 80 else 1 for k in range(hi - lo)]
                bools = [(lo + k) % 2 == 1 and lo + k < 80
                         for k in range(hi - lo)]
                assert (groups, need) == tc.gather_plan(
                    sizes, bools, valid_read, 1 << 20, 1 << 20)


@pytest.mark.parametrize("count", [0, 1, 63, 64, 65, 128, 130])
@pytest.mark.parametrize("nsrc", [1, 2, 3, 8])
def test_gather_launches_cover_every_array(count, nsrc):
    chunks = tc.gather_launches(count, nsrc)
    assert chunks[0][0] == 0 and chunks[-1][1] == count
    for (lo, hi), (lo2, _) in zip(chunks, chunks[1:]):
        assert hi == lo2
    for lo, hi in chunks:
        assert hi - lo <= tc.GATHER_MAX_ARRAYS
        assert (hi - lo) * nsrc <= tc.GATHER_MAX_SLOTS
        assert hi > lo or count == 0
    assert len(chunks) == max(1, -(-count // min(
        tc.GATHER_MAX_ARRAYS, tc.GATHER_MAX_SLOTS // nsrc)))


class _FakeGatherLib:
    """csrc/gather_rows.cu's C contract read back in Python: decodes the
    descriptor, checks its layout, and moves the rows of the CPU tensors
    whose addresses it holds (a staged group's members as the record
    would carry them), so the wrapper's host logic meets the kernel's
    layout without a card."""

    def __init__(self):
        self.at = {}
        self.calls = []

    def _t(self, ptr):
        return self.at[ptr]

    @staticmethod
    def presto_error_string(status):
        return b"invalid argument"

    def presto_gather_rows(self, desc, perm, rows, out_valid, limit, stream):
        nsrc, ngroups, _, count = (ctypes.c_int64 * 4).from_address(desc)
        d = list((ctypes.c_int64 * (7 + 2 * nsrc + 3 * ngroups
                                    + count * (5 + nsrc))).from_address(desc))
        nsrc, ngroups, nstaged, count, live_bits, need = d[:6]
        assert 0 <= need <= tc.GATHER_PROBE and (need == 0 or nstaged)
        off = d[6:7 + nsrc]
        valid = [self._t(v) if v else None for v in d[7 + nsrc:7 + 2 * nsrc]]
        i = 7 + 2 * nsrc
        groups = [tuple(d[i + 3 * g:i + 3 * g + 3]) for g in range(ngroups)]
        i += 3 * ngroups
        arrays = [d[i + k * (5 + nsrc):i + (k + 1) * (5 + nsrc)]
                  for k in range(count)]
        starts = [g[1] for g in groups] + [count]
        assert starts[0] == 0 and starts == sorted(set(starts))
        assert all(g[0] in (16, 32) and g[2] % 16 == 0 for g in
                   groups[:nstaged])
        assert all(g[0] == 0 and g[2] == 0 for g in groups[nstaged:])
        if nstaged:
            recs = sum(g[0] for g in groups)
            buf = next(t for t in self.at.values()
                       if t.dtype == torch.uint8
                       and t.data_ptr() == groups[0][2])
            words = -(-off[-1] // 32) if valid[0] is not None else 0
            assert buf.numel() == off[-1] * recs + 4 * words
            assert live_bits == (buf.data_ptr() + off[-1] * recs
                                 if words else 0)
        else:
            assert live_bits == 0
        self.calls.append((ngroups, nstaged, count, need))
        p = self._t(perm)[:rows]
        live = torch.arange(rows) < (int(self._t(limit)) if limit else rows)
        if valid[0] is not None:
            live &= torch.cat(valid)[p]
        for g, (stride, lo, _) in enumerate(groups):
            members = arrays[lo:starts[g + 1]]
            assert stride or len(members) == 1
            for dst, width, at, bit, and_live, *srcs in members:
                out = self._t(dst)
                assert out.element_size() == width and at % width == 0
                assert (bit >= 0) <= (stride > 0)
                v = torch.cat([self._t(x) for x in srcs])[p]
                if and_live:
                    v = v & live
                out.copy_(v)
        if out_valid:
            self._t(out_valid).copy_(live)
        return 0


def _parts(rng, n, nsrc, dts):
    cuts = sorted(rng.choice(np.arange(1, n), nsrc - 1,
                             replace=False).tolist()) if nsrc > 1 else []
    bounds = [0] + cuts + [n]
    cols = [(torch.from_numpy(rng.integers(0, 2, n)).to(dt),
             torch.from_numpy(rng.random(n) < 0.8)) for dt in dts]
    valid = torch.from_numpy(rng.random(n) < 0.6)
    return [([(d[a:b].clone(), m[a:b].clone()) for d, m in cols],
             valid[a:b].clone()) for a, b in zip(bounds, bounds[1:])]


@pytest.mark.parametrize("nsrc", [1, 2, 8])
@pytest.mark.parametrize("limit", [None, 11])
@pytest.mark.parametrize("stage", [True, False, None],
                         ids=["staged", "direct", "probed"])
@pytest.mark.parametrize("ncols", [3, 40])
def test_gather_wrapper_descriptor_moves_rows_like_plain(
        monkeypatch, nsrc, limit, stage, ncols):
    """`_gather_rows_cuda`'s descriptors, read back by the C contract's
    Python twin, give `gather_rows_plain`'s rows: every launch, every
    array placed once, the records staged where `gather_plan` says
    (always, never, or from its need's far samples on)."""
    rng = np.random.default_rng(nsrc * 7 + ncols)
    dts = [torch.bool, torch.int16, torch.float64, torch.int32,
           torch.int8] * (ncols // 5 + 1)
    parts = _parts(rng, 300, nsrc, dts[:ncols])
    perm = torch.from_numpy(rng.permutation(300))
    made = []
    empty = torch.empty

    def tracked(*a, **k):
        t = empty(*a, **k)
        made.append(t)
        return t
    fake = _FakeGatherLib()
    monkeypatch.setattr(tc, "GATHER_L2_BYTES", 0)
    monkeypatch.setattr(cuda, "library", lambda name: fake)
    monkeypatch.setattr(cuda, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(tc, "_LIMITS", {})
    inputs = [t for cols, v in parts for d, m in cols for t in (d, m)] + \
        [v for _, v in parts] + [perm]
    real = fake.presto_gather_rows

    def run(*a):
        fake.at = {t.data_ptr(): t for t in inputs + made
                   + [v[1] for v in tc._LIMITS.values()]}
        return real(*a)
    fake.presto_gather_rows = run
    before = tc.GATHER_ROWS_KERNEL.launches
    monkeypatch.setattr(torch, "empty", tracked)
    got, gv = tc._gather_rows_cuda(parts, perm, 290, limit, stage)
    monkeypatch.setattr(torch, "empty", empty)
    want, wv = tc.gather_rows_plain(parts, perm, 290, limit)
    launches = len(tc.gather_launches(2 * ncols, nsrc))
    assert tc.GATHER_ROWS_KERNEL.launches == before + launches
    assert len(fake.calls) == launches
    assert torch.equal(gv, wv)
    for (gd, gm), (wd, wm) in zip(got, want):
        assert torch.equal(gd, wd) and torch.equal(gm, wm)
    assert all(bool(nstaged) == (stage is not False)
               and (need == 0) == (stage is not None)
               for _, nstaged, _, need in fake.calls)


@pytest.mark.parametrize("rows,tiles", [(1, 1), (4095, 1), (4096, 1),
                                        (4097, 2), (1 << 21, 512)])
def test_limit_tiles(rows, tiles):
    assert ts.limit_tiles(rows) == tiles


def test_limit_scratch_is_kept_per_stream_and_takes_new_epochs(monkeypatch):
    """K27's look-back scratch per (device, stream), shared with K33 and
    K9 (`common.lookback_scratch`): the ticket made zeroed once, the
    status words zeroed and grown with the tile count (zeroed words
    carry epoch 0, which no call takes), a new epoch every call, and
    the words zeroed again when the epochs wrap."""
    monkeypatch.setattr(tc, "_LOOKBACK_SCRATCH", {})
    monkeypatch.setattr(tc, "LOOKBACK_EPOCHS", 4)
    dev = torch.device("cpu")
    ticket, status, epoch = tc.lookback_scratch(dev, 7, 3)
    assert ticket.shape == (1,) and not ticket.any()
    assert status.shape == (3,) and not status.any() and epoch == 1
    status.fill_(5)
    t2, s2, e2 = tc.lookback_scratch(dev, 7, 2)
    assert t2 is ticket and s2 is status and e2 == 2
    t3, s3, e3 = tc.lookback_scratch(dev, 7, 9)
    assert t3 is ticket and s3.shape == (9,) and not s3.any() and e3 == 3
    s3.fill_(5)
    _, s4, e4 = tc.lookback_scratch(dev, 7, 1)
    assert s4 is s3 and e4 == 1 and not s4.any()
    other = tc.lookback_scratch(dev, 8, 1)
    assert other[0] is not ticket and other[2] == 1
