"""The port stands alone: it imports neither JAX nor the JAX package, and
it runs on CUDA unless told otherwise."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "presto_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "presto_tpu")


def test_import_loads_no_jax_module():
    code = (
        "import sys\n"
        "import presto_tpu_torch.runner, presto_tpu_torch.interop\n"
        "import presto_tpu_torch.native.cuda\n"
        "import presto_tpu_torch.expr.codegen\n"
        "import presto_tpu_torch.ops.window\n"
        "import presto_tpu_torch.operators.window_ops\n"
        "import presto_tpu_torch.connectors.tpcds\n"
        "import presto_tpu_torch.connectors.memory\n"
        "import presto_tpu_torch.operators.array_agg\n"
        "import presto_tpu_torch.operators.write_ops\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'presto_tpu')]\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert not _forbidden(name), \
                f"{path.name}:{node.lineno} imports {name}"


def test_runner_without_cuda_raises(monkeypatch):
    from presto_tpu_torch.runner import LocalRunner
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalRunner()
    assert LocalRunner(device="cpu").device.type == "cpu"


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """A wrapper given a CUDA tensor launches its kernel or raises:
    here the build is made to fail, and the error must surface."""
    from presto_tpu_torch import batch as tb
    from presto_tpu_torch.native import cuda

    def no_build(name):
        raise cuda.KernelError("no nvcc here")
    monkeypatch.setattr(cuda, "library", no_build)

    class FakeCuda:
        type = "cuda"
    monkeypatch.setattr(tb.Batch, "device", property(lambda s: FakeCuda()))
    b = tb.Batch.from_pydict({"x": ([1, 2, 3], tb.Type("bigint"))})
    with pytest.raises((cuda.KernelError, ValueError)):
        tb.compact_full(b)


def _meta(n, dtype):
    return torch.zeros(n, dtype=dtype, device="meta")


def _k3(common, join, hashagg):
    keys = [(_meta(64, torch.int64), _meta(64, torch.bool))]
    common.row_hash_pair(keys, _meta(64, torch.bool), True)


def _k4(common, join, hashagg):
    join.build_meta(_meta(64, torch.int64), 4)


def _k5(common, join, hashagg):
    from presto_tpu_torch.batch import Batch, Column
    from presto_tpu_torch.types import BIGINT
    b = Batch({"k": Column(_meta(64, torch.int64), _meta(64, torch.bool),
                           BIGINT)}, _meta(64, torch.bool))
    table = join.BuildTable(_meta(64, torch.int64), _meta(64, torch.int64),
                            _meta(17, torch.int64), _meta(64, torch.int64),
                            _meta(1, torch.int64), b, radix_bits=4)
    join.probe_search(table, b, ("k",))


def _k6(common, join, hashagg):
    keys = [(_meta(64, torch.int64), _meta(64, torch.bool))]
    hashagg.segment_reduce(_meta(64, torch.int64), _meta(64, torch.int64),
                           keys, _meta(64, torch.bool),
                           [(_meta(64, torch.float64), "sum")], 16)


def _meta_table(join):
    from presto_tpu_torch.batch import Batch, Column
    from presto_tpu_torch.types import BIGINT
    b = Batch({"k": Column(_meta(64, torch.int64), _meta(64, torch.bool),
                           BIGINT)}, _meta(64, torch.bool))
    return join.BuildTable(_meta(64, torch.int64), _meta(64, torch.int64),
                           _meta(17, torch.int64), _meta(64, torch.int64),
                           _meta(1, torch.int64), b, radix_bits=4), b


def _k7(common, join, hashagg):
    table, b = _meta_table(join)
    join.semi_mark(table, b, ("k",))


def _k8(common, join, hashagg):
    from presto_tpu_torch.types import DOUBLE
    keys = [(_meta(64, torch.int64), _meta(64, torch.bool))]
    hashagg.presorted_reduce(_meta(64, torch.bool), keys,
                             [(_meta(64, torch.float64),
                               _meta(64, torch.int64))],
                             [hashagg.make_sum(DOUBLE, DOUBLE)], 16)


def _k9(common, join, hashagg):
    table, b = _meta_table(join)
    join._expand_from_enc(table, b, ("k",), _meta(64, torch.int64), 128,
                          "inner", ("k",), ("k",), ("k",), "hash",
                          _meta(64, torch.int64))


def _k9_full(common, join, hashagg):
    table, b = _meta_table(join)
    join.probe_join_full(table, b, ("k",), _meta(64, torch.bool), 128,
                         ("k",), ("k",), ("k",))


def _k10(common, join, hashagg):
    from presto_tpu_torch.operators import misc_ops
    _, b = _meta_table(join)
    misc_ops.cross_product(b, b, 64, 64, 4096)


def _k11(common, join, hashagg):
    from presto_tpu_torch.types import BIGINT
    table, _ = _meta_table(join)
    join.unmatched_build(table, _meta(64, torch.bool),
                         (("p", BIGINT, None),), ("k",))


def _meta_window():
    from presto_tpu_torch.ops import window
    seg = window.Segments(*[_meta(64, torch.int64) for _ in range(6)])
    return window, seg, _meta(64, torch.bool)


def _k13(common, join, hashagg):
    window, _, valid = _meta_window()
    keys = [(_meta(64, torch.int64), _meta(64, torch.bool))]
    window.window_segments(keys, keys, valid)


def _k14(common, join, hashagg):
    window, seg, valid = _meta_window()
    window.window_frame_sum(seg, None, "sum",
                            (_meta(64, torch.float64), valid), None, valid,
                            window.Frame("rows", -2, 2), torch.float64)


def _k15(common, join, hashagg):
    window, seg, valid = _meta_window()
    window.window_frame_minmax(seg, None, "min",
                               (_meta(64, torch.int64), valid), None, valid,
                               window.Frame("rows", "u", "c"))


def _k16(common, join, hashagg):
    window, seg, valid = _meta_window()
    window.window_emit(seg, None, valid, _meta(64, torch.int64),
                       [window.Emit("row_number")])


@pytest.mark.parametrize("call", [_k3, _k4, _k5, _k6, _k7, _k8, _k9,
                                  _k9_full, _k10, _k11, _k13, _k14, _k15,
                                  _k16],
                         ids=["row_hash", "join_build", "join_probe",
                              "segment_reduce", "semi_join",
                              "stream_reduce", "join_expand",
                              "join_expand_full", "cross_product",
                              "join_outer", "window_segments",
                              "window_frame_sum", "window_frame_minmax",
                              "window_emit"])
def test_device_tensor_never_takes_the_plain_version(monkeypatch, call):
    """K3-K11 and K13-K16 on tensors that are not on the CPU (meta
    tensors here) go to the kernel or raise: with the build made to
    fail, the error surfaces. The plain versions would compute meta
    results silently."""
    from presto_tpu_torch.native import cuda
    from presto_tpu_torch.ops import common, hashagg, join

    def no_build(name):
        raise cuda.KernelError("no nvcc here")
    monkeypatch.setattr(cuda, "library", no_build)
    with pytest.raises(cuda.KernelError):
        call(common, join, hashagg)


def test_chip_smoke_checks_every_built_kernel():
    """chip_smoke.py's kernels line names every source native/cuda.py
    builds (route cuda), the generated fragment kernel (route triton)
    and every launch counter of the package, so no built kernel goes
    unchecked on the card."""
    import importlib.util
    from presto_tpu_torch import batch  # noqa: F401  (registers K2)
    from presto_tpu_torch.expr import codegen  # noqa: F401  (K12)
    from presto_tpu_torch.native import cuda
    from presto_tpu_torch.operators import misc_ops  # noqa: F401  (K10)
    from presto_tpu_torch.operators import array_agg  # noqa: F401  (K17)
    from presto_tpu_torch.ops import common, hashagg, join  # noqa: F401
    from presto_tpu_torch.ops import window  # noqa: F401  (K13-K16)
    from presto_tpu_torch.telemetry import kernels as tk
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert {src for route, src, _ in smoke.KERNELS.values()
            if route == "cuda"} \
        == {"presto_tpu_torch/csrc/" + s for s in cuda.SOURCES.values()}
    assert set(smoke.KERNELS) == set(tk.COUNTERS)
    for k, (route, src, replaces) in smoke.KERNELS.items():
        assert route in ("cuda", "triton"), k
        assert (ROOT / src).exists(), k
        path, line = replaces.split(":")
        assert (ROOT / path).exists() and int(line) > 0, k
    assert smoke.KERNELS["fragment"][0] == "triton"
    assert set(smoke.MUST) == set(smoke.QUERIES)
    assert all("fragment" in names for names in smoke.MUST.values())
    assert set(smoke.WIN_MUST) == set(smoke.WIN_QUERIES) \
        | set(smoke.DS_QUERIES)
    assert all(isinstance(names, tuple) and set(names) <= set(tk.COUNTERS)
               for names in smoke.WIN_MUST.values())
    assert set(smoke.WINDOW_KERNELS) == {
        k for k, c in tk.COUNTERS.items() if c.family == "window"}
    assert set(smoke.ARRAY_MUST) == set(smoke.ARRAY_QUERIES)
    assert all(set(names) <= set(tk.COUNTERS)
               for names in smoke.ARRAY_MUST.values())
    assert {k for k, c in tk.COUNTERS.items() if c.family == "array_agg"} \
        == {"array_collect"}


def _case_sources():
    """Generated sources of every lowered-operation case and of every
    scalar function (those calling libdevice import it)."""
    from presto_tpu_torch import types as PT
    from presto_tpu_torch.expr import ir as PIR
    from presto_tpu_torch.operators.fused_fragment import make_chain_body
    from torch_fragment_cases import (
        CASES, function_calls, function_stage, port_body,
    )
    out = {name: port_body(name).kernel.source for name in sorted(CASES)}
    for label, expr in function_calls(PIR, PT).items():
        out[label] = make_chain_body([function_stage(expr)]).kernel.source
    assert any("libdevice" in src for src in out.values())
    return out


def test_generated_sources_import_only_triton():
    """A generated fragment kernel imports `triton` and nothing else:
    no JAX, no JAX package, not even torch."""
    for name, src in _case_sources().items():
        tree = ast.parse(src)
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] \
                    if isinstance(node, ast.Import) else [node.module]
                assert all(n.split(".")[0] == "triton" for n in names), \
                    (name, names)


def test_fragment_kernel_never_takes_the_composed_form(monkeypatch):
    """K12 on tensors that are not on the CPU launches or raises: on a
    meta batch its wrapper refuses, and with CUDA faked but no Triton
    installed the import error surfaces; the chain body hands such a
    batch to K12, never to the composed form."""
    from presto_tpu_torch.batch import Batch, Column
    from presto_tpu_torch.expr import codegen
    from torch_fragment_cases import port_batch, port_body
    body = port_body("add")
    meta = Batch({n: Column(_meta(64, c.data.dtype), _meta(64, torch.bool),
                            c.type, c.dictionary)
                  for n, c in port_batch(64, 1).columns.items()},
                 _meta(64, torch.bool))
    with pytest.raises(codegen.FragmentError, match="not a CUDA device"):
        body(meta)

    class FakeCuda:
        type = "cuda"
    monkeypatch.setattr(Batch, "device", property(lambda s: FakeCuda()))
    monkeypatch.setattr(codegen.FragmentKernel, "prepare",
                        lambda self, b: (64, [64], {("o1", "data"): None}))
    monkeypatch.setitem(sys.modules, "triton", None)
    with pytest.raises(ImportError):
        body(meta)
