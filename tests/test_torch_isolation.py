"""The port stands alone: `repro_torch` and `chip_smoke.py` import
neither jax nor anything of the JAX package `repro` (nor `ml_dtypes`,
which only `core/backend.py`'s `to_numpy` takes where it is installed),
the package works with jax made unimportable, and the entry points
compute on CUDA unless the CPU is asked for — never falling back to
it."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
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


# the one optional import of ml_dtypes: to_numpy hands a bfloat16 result
# back as ml_dtypes.bfloat16 where that package is installed, and raises
# a clear error where it is not
OPTIONAL = {PORT / "core" / "backend.py": {"ml_dtypes"}}


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax_or_reference_imports(path):
    forbidden = {"jax", "jaxlib", "repro", "ml_dtypes"} - OPTIONAL.get(
        path, set())
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in forbidden, (path, name)


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
from repro_torch.kernels.spmm import ops as sops
from repro_torch import interop
rng = np.random.default_rng(0)
xn = rng.normal(size=(200, 5)); yn = xn @ np.arange(1.0, 6.0)[:, None]
beta = lmDS(input_tensor("X", xn), input_tensor("y", yn), reg=1e-9,
            runtime=LineageRuntime(device="cpu"))
assert np.allclose(beta.ravel(), np.arange(1.0, 6.0), atol=1e-6)
xs = xn * (rng.random(xn.shape) < 0.1)
X = input_tensor("Xs", np.vstack([xs] * 5), sparsity=0.1)
Y = input_tensor("ys", np.vstack([yn] * 5))
rt = LineageRuntime(device="cpu", sparse_inputs=True)
assert np.isfinite(lmDS(X, Y, reg=1e-3, runtime=rt)).all()
from repro_torch.core import ops
from repro_torch.lifecycle import grid_search_lm, pca, winsorize
cpu = LineageRuntime(device="cpu")
betas, _ = grid_search_lm(input_tensor("Xg", xn), input_tensor("yg", yn),
                          [0.1, 1.0, 10.0], runtime=cpu, mode="vmap")
assert betas.shape == (5, 3) and cpu.stats.batched_segments > 0
comps, proj = pca(input_tensor("Xp", xn), 2, runtime=cpu)
assert comps.shape == (5, 2) and proj.shape == (200, 2)
assert np.isfinite(winsorize(input_tensor("Xw", xn), runtime=cpu)).all()
r = cpu.evaluate([ops.rand((4, 3), seed=1, dist="normal", sparsity=0.5)])[0]
assert r.shape == (4, 3)
import os, tempfile, threading
import torch
from repro_torch.core import PreparedScript, faults, hetero
from repro_torch.data import csv_io, gen_regression
from repro_torch.checkpoint import restore, save
from repro_torch.serving import ModelServer
from repro_torch.distributed import fault
d = tempfile.mkdtemp()
xr, yr, _ = gen_regression(300, 4, seed=1)
csv_io.write_csv(os.path.join(d, "x.csv"), np.hstack([xr, yr]), fmt="%.17g")
flog = faults.FaultLog()
with faults.inject("seed=1;chunk_io@0"):
    parts = [c for _, c in csv_io.read_csv_chunks(
        os.path.join(d, "x.csv"), 128, chunk_bytes=4096, fault_log=flog)]
data = np.vstack(parts)
assert (data == np.hstack([xr, yr])).all() and flog.retries == 1
beta = lmDS(input_tensor("Xc", data[:, :4]), input_tensor("yc", data[:, 4:]),
            reg=1e-9, runtime=cpu)
save(os.path.join(d, "ck"), 0, {"beta": torch.from_numpy(beta)})
back, _ = restore(os.path.join(d, "ck"), {"beta": torch.zeros(4, 1,
                                                              dtype=torch.float64)})
assert torch.equal(back["beta"], torch.from_numpy(beta))
B = input_tensor("B", beta)
script = PreparedScript(lambda x: ops.matmul(x, B), [(1, 4)], runtime=cpu)
with ModelServer(script, max_batch=4, max_wait_us=500.0) as srv:
    got, = srv.score(xr[:1], timeout=30.0)
assert (got == script(xr[:1])[0]).all() and cpu.stats.serving.retraces == 0
x, meta = hetero.transformencode(hetero.DataTensor.from_dict(
    {"c": np.array(["a", "b"], object)}, types={"c": "str"}), {"c": "dummycode"})
assert x.shape == (2, 2)
assert not any(m in ("jax", "ml_dtypes") or m.startswith(
    ("jax.", "repro.", "ml_dtypes.")) for m, v in sys.modules.items()
    if v is not None)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_serves_reduced_qwen3_with_jax_and_ml_dtypes_blocked():
    """The LM path builds and generates on the CPU with jax, `repro` and
    `ml_dtypes` unimportable; a bfloat16 `to_numpy` then raises a clear
    RuntimeError naming the missing package."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["ml_dtypes"] = None
import numpy as np
import torch
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.launch.serve import generate
from repro_torch.core.backend import to_numpy
cfg = get_config("qwen3-0.6b").reduced().with_(dtype="bfloat16")
model = build_model(cfg, device="cpu").init(seed=0)
prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
toks = generate(model, prompts, max_new=4, max_len=16)
assert toks.shape == (2, 4) and toks.dtype == np.int32
assert 0 <= toks.min() and toks.max() < cfg.vocab_size
try:
    to_numpy(torch.ones(2, dtype=torch.bfloat16))
except RuntimeError as e:
    assert "ml_dtypes" in str(e)
else:
    raise AssertionError("to_numpy returned a bfloat16 array")
assert not any(m in ("jax", "ml_dtypes") or m.startswith(
    ("jax.", "repro.", "ml_dtypes.")) for m, v in sys.modules.items()
    if v is not None)
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_to_numpy_keeps_bfloat16_where_ml_dtypes_is_installed():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    from repro_torch.core.backend import to_numpy
    got = to_numpy(torch.tensor([1.5, -2.0], dtype=torch.bfloat16))
    assert got.dtype == ml_dtypes.bfloat16
    assert got.astype(np.float32).tolist() == [1.5, -2.0]


def test_flash_wrapper_never_falls_back():
    from repro_torch.kernels.flash_attention import ops as fops
    q = torch.zeros(1, 4, 2, 32)
    before = dict(fops.LAUNCHES)
    assert fops.flash_attention(q, q, q).shape == q.shape
    assert fops.LAUNCHES == before
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        fops.flash_attention_cuda(q, q, q)


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
    from repro_torch.core.backend import sparsify
    from repro_torch.kernels.spmm import ops as sops
    xs = sparsify(np.ones((4, 3)))
    before = dict(sops.LAUNCHES)
    assert torch.equal(sops.gram_bcoo(xs), torch.full((3, 3), 4.0,
                                                      dtype=torch.float64))
    assert torch.equal(sops.matmul_bcoo(xs, x[:3, :1]),
                       torch.full((4, 1), 3.0, dtype=torch.float64))
    assert sops.LAUNCHES == before
    mask = sops.block_mask_from_indices(xs)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        sops.gram_bs_cuda(x, mask)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        sops.xtv_bs_cuda(x, x[:, :1], mask)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        sops.spmm_cuda(x, x[:1, :].mT, mask)
