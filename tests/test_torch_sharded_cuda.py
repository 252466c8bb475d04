"""The sharded placement on the card (`cuda`-marked; skipped without a
GPU). The file imports no jax: it runs on the card's machine with
`python -m pytest -m cuda`.

A plan compiled under `use_mesh(data=8)` with 8 logical devices laid
over the card runs each shard's gram and xtv as one launch of the
hand-written kernels (8 + 8), agrees with the same plan on the CPU and
with numpy's float64 solve within 1e-9, and is bitwise across two runs
and across pipeline depths 1 and 2; with the card's own device count
the same plan runs the unshard closures (1 + 1 launches, the same
values within 1e-9); the bucket axis of an 8-λ grid splits over
`config=8` within 1e-9 of plain vmap.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import LineageRuntime, input_tensor
from repro_torch.distributed import logical_devices, use_mesh
from repro_torch.kernels.gram import ops as gops
from repro_torch.lifecycle import grid_search_lm, lmDS

M, N = 40_000, 64   # 2.5 MB of X: sharded at data=8 (5,000 rows a shard)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def data():
    rng = np.random.default_rng(0)
    xn = rng.standard_normal((M, N))
    yn = xn @ rng.standard_normal((N, 1)) + 0.1 * rng.standard_normal((M, 1))
    return xn, yn


def _fit(xn, yn, devices, device):
    with logical_devices(devices), use_mesh(data=8):
        gops.reset_launches()
        rt = LineageRuntime(device=device)
        beta = lmDS(input_tensor("X", xn), input_tensor("y", yn), reg=1e-7,
                    runtime=rt)
    return beta, rt, dict(gops.LAUNCHES)


@pytest.mark.cuda
def test_sharded_lmds_launches_each_shard(cuda_device, data, monkeypatch):
    xn, yn = data
    want = np.linalg.solve(xn.T @ xn + 1e-7 * np.eye(N), xn.T @ yn)
    cpu, _, _ = _fit(xn, yn, 8, "cpu")
    runs = []
    for depth in ("1", "2", "1"):
        monkeypatch.setenv("REPRO_PIPELINE_DEPTH", depth)
        beta, rt, launches = _fit(xn, yn, 8, cuda_device)
        assert launches["gram"] == launches["xtv"] == 8
        assert rt.stats.shard.sharded_segments == 2
        runs.append(beta)
    for b in runs[1:]:
        assert np.array_equal(b, runs[0])
    np.testing.assert_allclose(runs[0], want, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(runs[0], cpu, rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
def test_unresolved_mesh_runs_the_unshard_closures(cuda_device, data):
    xn, yn = data
    sharded, _, _ = _fit(xn, yn, 8, cuda_device)
    beta, rt, launches = _fit(xn, yn, 1, cuda_device)
    assert rt.stats.shard.total == 0
    assert launches["gram"] == launches["xtv"] == 1
    np.testing.assert_allclose(beta, sharded, rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
def test_config_sharded_grid(cuda_device, data):
    xn, yn = data
    lams = [0.1 * (i + 1) for i in range(8)]
    out = {}
    with logical_devices(8), use_mesh(config=8):
        for mode in ("shard", "vmap"):
            rt = LineageRuntime(device=cuda_device)
            out[mode] = grid_search_lm(input_tensor("X", xn),
                                       input_tensor("y", yn), lams,
                                       runtime=rt, mode=mode)
            assert (rt.stats.shard.config_sharded_segments > 0) == (
                mode == "shard")
    np.testing.assert_allclose(out["shard"][0], out["vmap"][0], rtol=1e-9)
    np.testing.assert_allclose(out["shard"][1], out["vmap"][1], rtol=1e-9)
