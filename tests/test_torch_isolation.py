"""The port stands alone: `repro_torch` and `chip_smoke.py` import
neither jax nor anything of the JAX package `repro`, the package works
with jax made unimportable, and the entry points compute on CUDA unless
the CPU is asked for — never falling back to it."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_imports_and_runs_with_jax_blocked():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import repro_torch
from repro_torch.core import LineageRuntime, input_tensor
from repro_torch.lifecycle import lmDS, steplm
from repro_torch.kernels.gram import ops
from repro_torch import interop
rng = np.random.default_rng(0)
xn = rng.normal(size=(200, 5)); yn = xn @ np.arange(1.0, 6.0)[:, None]
beta = lmDS(input_tensor("X", xn), input_tensor("y", yn), reg=1e-9,
            runtime=LineageRuntime(device="cpu"))
assert np.allclose(beta.ravel(), np.arange(1.0, 6.0), atol=1e-6)
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m, v in sys.modules.items() if v is not None)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_default_device_is_cuda():
    from repro_torch.core import LineageRuntime, runtime
    if torch.cuda.is_available():
        assert LineageRuntime().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LineageRuntime()
    saved = runtime._default_runtime
    runtime._default_runtime = None
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runtime.get_runtime()
    finally:
        runtime._default_runtime = saved
    assert LineageRuntime(device="cpu").device == torch.device("cpu")


def test_cuda_wrappers_never_fall_back():
    """On a CPU tensor the wrappers take the plain version; the CUDA entry
    points refuse anything but a CUDA tensor rather than computing it."""
    from repro_torch.kernels.gram import ops
    x = torch.ones(4, 3, dtype=torch.float64)
    before = dict(ops.LAUNCHES)
    assert torch.equal(ops.gram(x), torch.full((3, 3), 4.0,
                                                 dtype=torch.float64))
    assert ops.LAUNCHES == before
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ops.gram_cuda(x)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        ops.xtv_cuda(x, x[:, :1])
