"""The asynchronous pipeline and the federated lane on the card
(`cuda`-marked; skipped without a GPU). The file imports no jax: it runs
on the card's machine with `python -m pytest -m cuda`.

On the card a depth-2 dispatch returns before its kernels ran, buckets
upload from page-locked staging on a copy stream and their partials come
back on another, so the bits depth 2 gives are only proven there: a
streamed lmDS (dense and bcoo buckets) and the served scores at depth 2
are held bitwise to depth 1, with the same kernel launches; a federated
lmDS launches one gram and one xtv per site and exchanges the eager
oracle's bytes.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import (LineageRuntime, PreparedScript, ReuseCache,
                              costmodel, input_tensor, ops)
from repro_torch.core.federated import FederatedTensor, federated_lmds
from repro_torch.kernels.gram import ops as gops
from repro_torch.kernels.spmm import ops as sops
from repro_torch.lifecycle import lmDS, lmDS_federated
from repro_torch.serving import ModelServer


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fit(xn, yn, depth, monkeypatch, **kw):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", depth)
    gops.reset_launches()
    sops.reset_launches()
    rt = LineageRuntime(cache=ReuseCache(), **kw)
    beta = lmDS(input_tensor("X", xn), input_tensor("y", yn), reg=1e-3,
                runtime=rt)
    return beta, rt, dict(gops.LAUNCHES), dict(sops.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(65536, 64), (20000, 300)])
def test_streamed_lmds_bitwise_across_depths(cuda_device, monkeypatch, m, n):
    monkeypatch.setattr(costmodel, "CHUNK_MEM_BUDGET", 1 << 22)
    rng = np.random.default_rng(m)
    xn, yn = rng.normal(size=(m, n)), rng.normal(size=(m, 1))
    b1, rt1, l1, _ = _fit(xn, yn, "1", monkeypatch)
    b2, rt2, l2, _ = _fit(xn, yn, "2", monkeypatch)
    assert rt1.stats.streaming.chunks > 2
    assert rt2.stats.pipeline.prefetch_hits == rt2.stats.streaming.chunks
    assert np.array_equal(b1, b2)
    assert l1 == l2 and l2["gram"] == rt2.stats.streaming.chunks
    want = np.linalg.solve(xn.T @ xn + 1e-3 * np.eye(n), xn.T @ yn)
    assert np.abs(b2 - want).max() <= 1e-9 * np.abs(want).max()


@pytest.mark.cuda
def test_sparse_stream_bitwise_across_depths(cuda_device, monkeypatch):
    monkeypatch.setattr(costmodel, "CHUNK_MEM_BUDGET", 1 << 20)
    rng = np.random.default_rng(7)
    m, n = 32768, 128
    xn = rng.normal(size=(m, n)) * (rng.random((m, n)) < 0.05)
    yn = rng.normal(size=(m, 1))
    b1, rt1, _, s1 = _fit(xn, yn, "1", monkeypatch, sparse_inputs=True)
    b2, rt2, _, s2 = _fit(xn, yn, "2", monkeypatch, sparse_inputs=True)
    assert rt2.stats.streaming.chunks > 2
    assert np.array_equal(b1, b2)
    assert s1 == s2 and s2["gram_bs"] == rt2.stats.streaming.chunks


@pytest.mark.cuda
@pytest.mark.parametrize("depth", ["1", "2"])
def test_federated_lmds_on_the_card(cuda_device, monkeypatch, depth):
    monkeypatch.setenv("REPRO_PIPELINE_DEPTH", depth)
    rng = np.random.default_rng(3)
    xn, yn = rng.normal(size=(8000, 40)), rng.normal(size=(8000, 1))
    oracle = FederatedTensor.partition_rows(xn, 4)
    want = federated_lmds(oracle, yn, reg=1e-6, intercept=True)
    gops.reset_launches()
    rt = LineageRuntime()
    beta = lmDS_federated(FederatedTensor.partition_rows(xn, 4), yn,
                          reg=1e-6, intercept=True, runtime=rt)
    assert gops.LAUNCHES["gram"] == gops.LAUNCHES["xtv"] == 4
    assert rt.stats.exchange.as_dict() == oracle.log.as_dict()
    assert np.abs(beta - want).max() <= 1e-9 * np.abs(want).max()


@pytest.mark.cuda
def test_served_scores_bitwise_across_depths(cuda_device, monkeypatch):
    rng = np.random.default_rng(1)
    n = 256
    W = input_tensor("pipeW", rng.normal(size=(n, 1)))
    xs = [rng.normal(size=(1, n)) for _ in range(24)]
    got = {}
    for depth in ("1", "2"):
        monkeypatch.setenv("REPRO_PIPELINE_DEPTH", depth)
        rt = LineageRuntime()
        script = PreparedScript(lambda x: ops.matmul(x, W), [(1, n)],
                                runtime=rt)
        with ModelServer(script, max_batch=8, max_wait_us=2000.0) as srv:
            futs = [srv.submit(x) for x in xs]
            got[depth] = [f.result(timeout=30.0)[0] for f in futs]
        assert rt.stats.serving.retraces == 0
        for x, g in zip(xs, got[depth]):
            assert (g == script(x)[0]).all()
    for a, b in zip(got["1"], got["2"]):
        assert (a == b).all()
