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
