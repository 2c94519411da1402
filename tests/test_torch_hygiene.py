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
