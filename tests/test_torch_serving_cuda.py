"""Plan serving on the card (`cuda`-marked; skipped without a GPU). The
file imports no jax: it runs on the card's machine with `python -m pytest
-m cuda`. The fixed-order one-row product gives the same bits at every
vmap bucket on the card as on the CPU, and a server on the card scores
each request bitwise as the same row scored alone, with 0 retraces."""
import numpy as np
import pytest
import torch

from repro_torch.core import LineageRuntime, PreparedScript, input_tensor, ops
from repro_torch.core import backend
from repro_torch.serving import ModelServer


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(16, 1), (1000, 1), (999, 3)])
def test_row_product_bitwise_at_every_bucket(cuda_device, n, c):
    rng = np.random.default_rng(n)
    beta = torch.from_numpy(rng.normal(size=(n, c))).to(cuda_device)
    xs = torch.from_numpy(rng.normal(size=(16, 1, n))).to(cuda_device)
    solo = torch.stack([backend._matmul(xs[i], beta) for i in range(16)])
    for b in (2, 4, 8, 16):
        got = torch.func.vmap(lambda x: backend._matmul(x, beta))(xs[:b])
        assert torch.equal(got, solo[:b])
    cpu = torch.stack([backend._matmul(xs[i].cpu(), beta.cpu())
                       for i in range(16)])
    assert torch.equal(solo.cpu(), cpu)


@pytest.mark.cuda
def test_served_scores_bitwise_solo(cuda_device):
    rng = np.random.default_rng(0)
    n = 1000
    rt = LineageRuntime(device=cuda_device)
    B = input_tensor("beta", rng.normal(size=(n, 1)))
    script = PreparedScript(
        lambda x: (ops.matmul(x, B), ops.sigmoid(ops.matmul(x, B))),
        [(1, n)], runtime=rt)
    rows = rng.normal(size=(24, 1, n))
    with ModelServer(script, max_batch=16, max_wait_us=2000.0) as srv:
        futs = [srv.submit(r) for r in rows]
        srv.flush()
        got = [f.result(timeout=60.0) for f in futs]
    for r, g in zip(rows, got):
        for a, b in zip(g, script(r), strict=True):
            assert np.array_equal(a, b)
    assert rt.stats.serving.retraces == 0
    assert rt.stats.serving.max_coalesce > 1
