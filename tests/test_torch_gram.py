"""The port's gram/xtv kernel family against the reference.

Same inputs (numpy, from a seed) through `repro.kernels.gram` — the
Pallas kernels in interpret mode and the jnp oracle — and through
`repro_torch.kernels.gram.ops` on the CPU, where it takes its plain
torch version. Tolerances: float64 rel 1e-12 (both sides compute in
float64; only the summation order differs), float32 2e-4 and bfloat16
2e-2 (those of tests/test_kernels.py). The CUDA kernels themselves run
only on the card: the `cuda`-marked case holds them against the plain
version there, each entry within `KERNEL_RTOL` of the product of the
norms of the two columns it combines (the Cauchy-Schwarz bound of the
entry; both sides accumulate float32/bfloat16 in float32, so 1e-5 is
far above their rounding and far below any wrong entry). This module
imports jax only inside the `reference` fixture, so that case also
runs where jax is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.interop import from_reference
from repro_torch.kernels.gram import ops as tops
from repro_torch.kernels.gram import ref as tref

RTOL = {"float64": 1e-12, "float32": 2e-4, "bfloat16": 2e-2}
KERNEL_RTOL = {"float64": 1e-12, "float32": 1e-5, "bfloat16": 1e-5}
TORCH_DTYPE = {"float64": torch.float64, "float32": torch.float32,
               "bfloat16": torch.bfloat16}


def _data(m, n, dtype, seed=0):
    """Host data from a seed; bfloat16 is numpy's (`ml_dtypes`), the type
    the reference binds."""
    a = np.random.default_rng(seed).normal(size=(m, n))
    if dtype == "bfloat16":
        import ml_dtypes
        return a.astype(ml_dtypes.bfloat16)
    return a.astype(dtype)


@pytest.fixture
def reference():
    """(jax.numpy, the reference's gram ops, its oracle), with x64 on as
    the lifecycle path runs."""
    jnp = pytest.importorskip("jax.numpy")
    import repro.core  # noqa: F401  (turns on jax x64)
    from repro.kernels.gram import ops, ref
    return jnp, ops, ref


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("m,n", [(300, 12), (1696, 1000), (1000, 1)])
def test_gram_matches_reference_oracle(reference, m, n, dtype):
    jnp, gops, gref = reference
    xh = _data(m, n, dtype)
    got = tops.gram(from_reference({"x": xh}, "cpu")["x"])
    want = np.asarray(gref.gram(jnp.asarray(xh)))
    assert got.dtype == (torch.float64 if dtype == "float64"
                         else torch.float32)
    assert str(want.dtype) == str(got.dtype).replace("torch.", "")
    assert _rel(got.numpy(), want) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n,bm,bn", [(300, 12, 64, 32), (250, 70, 64, 32),
                                       (1000, 1, 128, 32)])
def test_gram_matches_pallas_interpret(reference, m, n, bm, bn, dtype):
    jnp, gops, gref = reference
    xh = _data(m, n, dtype, seed=1)
    got = tops.gram(from_reference({"x": xh}, "cpu")["x"])
    want = gops.gram(jnp.asarray(xh), interpret=True, bm=bm, bn=bn)
    assert _rel(got.numpy(), np.asarray(want)) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("m,n,c", [(300, 12, 1), (300, 12, 3),
                                   (1696, 1000, 1), (1000, 1, 3)])
def test_xtv_matches_reference_oracle(reference, m, n, c, dtype):
    jnp, gops, gref = reference
    xh = _data(m, n, dtype)
    vh = _data(m, c, dtype, seed=2)
    t = from_reference({"x": xh, "v": vh}, "cpu")
    got = tops.xtv(t["x"], t["v"])
    want = np.asarray(gref.xtv(jnp.asarray(xh), jnp.asarray(vh)))
    assert tuple(got.shape) == want.shape == (n, c)
    assert _rel(got.numpy(), want) <= RTOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [1, 3])
def test_xtv_matches_pallas_interpret(reference, c, dtype):
    jnp, gops, gref = reference
    xh = _data(256, 96, dtype, seed=3)
    vh = _data(256, c, dtype, seed=4)
    t = from_reference({"x": xh, "v": vh}, "cpu")
    got = tops.xtv(t["x"], t["v"])
    want = gops.xtv(jnp.asarray(xh), jnp.asarray(vh), interpret=True,
                    bm=128, bn=32)
    assert _rel(got.numpy(), np.asarray(want)) <= RTOL[dtype]


def test_xtv_squeezes_1d_v(reference):
    jnp, gops, gref = reference
    xh = _data(300, 12, "float64")
    vh = np.random.default_rng(5).normal(size=300)
    t = from_reference({"x": xh, "v": vh}, "cpu")
    got = tops.xtv(t["x"], t["v"])
    want = np.asarray(gops.xtv(jnp.asarray(xh), jnp.asarray(vh)))
    assert got.shape == (12,) and want.shape == (12,)
    assert _rel(got.numpy(), want) <= RTOL["float64"]


@pytest.mark.parametrize("m,n", [(300, 12), (1696, 1000)])
def test_gram_is_bitwise_symmetric(m, n):
    g = tops.gram(torch.from_numpy(_data(m, n, "float64", seed=6)))
    assert torch.equal(g, g.mT)


def test_interop_keeps_dtype_and_strides():
    a = np.asfortranarray(_data(5, 3, "float64"))
    b = _data(4, 2, "bfloat16")
    t = from_reference({"a": a, "b": b}, "cpu")
    assert t["a"].dtype == torch.float64 and not t["a"].is_contiguous()
    assert t["a"].stride() == (1, 5)
    assert np.array_equal(t["a"].numpy(), a)
    assert t["b"].dtype == torch.bfloat16 and t["b"].is_contiguous()
    assert np.array_equal(t["b"].float().numpy(), b.astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_tolerance_passes_reordering_and_fails_a_wrong_entry(dtype):
    """The on-card limit holds a float32-accumulated gram against float64
    arithmetic on the same inputs, and rejects one entry that is wrong by
    a typical off-diagonal value."""
    x = torch.from_numpy(_data(2048, 200, "float64", seed=8)).to(
        TORCH_DTYPE[dtype])
    g, exact = tref.gram(x), x.double().mT @ x.double()
    assert tref.scaled_err(g, exact, x, x) <= KERNEL_RTOL[dtype]
    bad = g.clone()
    bad[3, 7] += exact[0, 1:].abs().mean().item()
    assert tref.scaled_err(bad, g, x, x) > 100 * KERNEL_RTOL[dtype]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("m,n,c", [(8192, 1000, 1), (1696, 1000, 3),
                                   (5000, 64, 1), (300, 12, 1)])
def test_cuda_kernels_match_plain_version(cuda_device, m, n, c, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    t = {k: torch.from_numpy(_data(*shape, "float64", seed)).to(
        cuda_device, TORCH_DTYPE[dtype])
        for k, shape, seed in (("x", (m, n), 0), ("v", (m, c), 7))}
    before = dict(tops.LAUNCHES)
    g = tops.gram(t["x"])
    xv = tops.xtv(t["x"], t["v"])
    torch.cuda.synchronize()
    assert tops.LAUNCHES["gram"] == before["gram"] + 1
    assert tops.LAUNCHES["xtv"] == before["xtv"] + 1
    assert torch.equal(g, g.mT)
    assert tref.scaled_err(g, tref.gram(t["x"]), t["x"], t["x"]) \
        <= KERNEL_RTOL[dtype]
    assert tref.scaled_err(xv, tref.xtv(t["x"], t["v"]), t["x"], t["v"]) \
        <= KERNEL_RTOL[dtype]
    # fixed-order reduction: bitwise reproducible from call to call
    assert torch.equal(g, tops.gram(t["x"]))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_float16(cuda_device):
    """gram.cu has no float16 instantiation: the card refuses it rather
    than computing it unchecked (the CPU's plain version serves it)."""
    x = torch.ones(8, 4, dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError, match="unsupported dtype"):
        tops.gram(x)
    with pytest.raises(TypeError, match="unsupported dtype"):
        tops.xtv(x, x[:, :1])
