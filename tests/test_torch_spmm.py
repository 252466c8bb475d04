"""The port's block-sparse kernel family against the reference.

`repro_torch.kernels.spmm.ref` and `.ops` on CPU tensors (where the ops
take the plain version) against `repro.kernels.spmm.ops.*_dense_masked`
with the Pallas kernels interpreted, at the reference test's sizes
(64 x 32, 16 x 16 blocks) in float32 within 1e-4 (tests/test_formats.py),
and against numpy in float64 within 1e-12 relative (both sides compute in
float64; only the summation order differs). Also: the mask counted from
BCOO indices equals the reference's `block_mask` of the densified matrix
(ragged edges and a padded nse included), masked blocks contribute exact
zeros, and densifying accumulates duplicate indices.

The `cuda`-marked cases hold each CUDA kernel against its plain version
on the card, each entry within 1e-12 (float64) or 1e-5 (float32,
bfloat16) of the product of the norms of the two columns it combines
(`kernels/gram/ref.py::scaled_err`), and bitwise against the same kernel
run with an all-ones mask. They skip where there is no GPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import backend as tb
from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.spmm import ops as tops
from repro_torch.kernels.spmm import ref as tref

F32_TOL = 1e-4
F64_RTOL = 1e-12
KERNEL_TOL = {torch.float64: 1e-12, torch.float32: 1e-5,
              torch.bfloat16: 1e-5}


@pytest.fixture
def reference():
    """The reference's block-sparse ops and oracle (imports jax)."""
    pytest.importorskip("jax")
    import repro.core  # noqa: F401  (turns on jax x64)
    from repro.kernels.spmm import ops, ref
    return ops, ref


def _sparse_mat(rng, m, n, density):
    return rng.normal(size=(m, n)) * (rng.random((m, n)) < density)


def _blocky(rng, m, n, rb, cb, p_block, p_in):
    """Row groups of `rb` and column groups of `cb`, each block populated
    with probability `p_block`, an entry of a populated block nonzero with
    probability `p_in`."""
    keep = rng.random((-(-m // rb), -(-n // cb))) < p_block
    dense = np.kron(keep, np.ones((rb, cb)))[:m, :n]
    return rng.normal(size=(m, n)) * (rng.random((m, n)) < p_in) * dense


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


# ---------------------------------------------------------------------------
# block masks
# ---------------------------------------------------------------------------

def test_block_mask(reference):
    sops, sref = reference
    x = np.zeros((32, 32))
    x[0, 0] = 1.0
    x[20, 30] = 2.0
    got = tref.block_mask(torch.from_numpy(x), 16, 16).numpy()
    np.testing.assert_array_equal(got, sref.block_mask(x, 16, 16))
    np.testing.assert_array_equal(got, np.asarray(sops.block_mask(x, 16, 16)))
    assert got[0, 0] == 1 and got[1, 1] == 1
    assert got[0, 1] == 0 and got[1, 0] == 0


@pytest.mark.parametrize("m,n,bm,bn,density", [
    (64, 32, 16, 16, 0.1), (70, 45, 16, 16, 0.05), (300, 130, 256, 64, 0.02),
    (1000, 70, 256, 64, 0.3), (40, 40, 16, 16, 0.0)])
def test_mask_from_indices_matches_reference(reference, rng, m, n, bm, bn,
                                             density):
    _, sref = reference
    xn = _sparse_mat(rng, m, n, density)
    bcoo = tb.sparsify(xn)
    assert bcoo.nse > np.count_nonzero(xn) or bcoo.nse == xn.size  # padded
    got = tops.block_mask_from_indices(bcoo, bm, bn)
    assert got.dtype == torch.int32
    padded = np.zeros((-(-m // bm) * bm, -(-n // bn) * bn))
    padded[:m, :n] = xn
    want = sref.block_mask(padded, bm, bn)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tref.block_mask(torch.from_numpy(xn), bm, bn).numpy(), want)
    # the transposed value counts the transposed blocks
    np.testing.assert_array_equal(
        tops.block_mask_from_indices(bcoo.T, bn, bm).numpy(), want.T)


# ---------------------------------------------------------------------------
# plain versions against the reference's Pallas kernels (interpreted)
# ---------------------------------------------------------------------------

def test_gram_block_sparse_matches_reference(reference, rng):
    sops, sref = reference
    x = _sparse_mat(rng, 64, 32, 0.1).astype(np.float32)
    got = tops.gram_dense_masked(torch.from_numpy(x), bm=16, bn=16)
    want = np.asarray(sops.gram_dense_masked(x, bm=16, bn=16,
                                             interpret=True))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), sref.gram(x), rtol=F32_TOL,
                               atol=F32_TOL)
    assert torch.equal(got, got.mT)


def test_spmm_block_sparse_matches_reference(reference, rng):
    sops, sref = reference
    x = _sparse_mat(rng, 64, 32, 0.1).astype(np.float32)
    w = rng.normal(size=(32, 8)).astype(np.float32)
    got = tops.spmm_dense_masked(torch.from_numpy(x), torch.from_numpy(w),
                                 bm=16, bk=16)
    want = np.asarray(sops.spmm_dense_masked(x, w, bm=16, bk=16,
                                             interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), sref.spmm(x, w), rtol=F32_TOL,
                               atol=F32_TOL)


def test_xtv_block_sparse_matches_reference(reference, rng):
    sops, sref = reference
    x = _sparse_mat(rng, 64, 32, 0.1).astype(np.float32)
    v = rng.normal(size=(64, 1)).astype(np.float32)
    got = tops.xtv_dense_masked(torch.from_numpy(x), torch.from_numpy(v),
                                bm=16, bn=16)
    want = np.asarray(sops.xtv_dense_masked(x, v, bm=16, bn=16,
                                            interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), sref.xtv(x, v), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("m,n,c", [(64, 32, 1), (1000, 130, 3),
                                   (6784, 100, 1)])
def test_float64_against_numpy(rng, m, n, c):
    xn = _blocky(rng, m, n, 1024, 128, 0.3, 0.2)
    vn = rng.normal(size=(m, c))
    wn = rng.normal(size=(n, c))
    x = torch.from_numpy(xn)
    assert _rel(tops.gram_dense_masked(x), xn.T @ xn) <= F64_RTOL
    assert _rel(tops.xtv_dense_masked(x, torch.from_numpy(vn)),
                xn.T @ vn) <= F64_RTOL
    assert _rel(tops.spmm_dense_masked(x, torch.from_numpy(wn)),
                xn @ wn) <= F64_RTOL


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_bcoo_entry_points_match_reference(reference, rng, dtype):
    sops, _ = reference
    from repro.core import backend as rb
    xn = _sparse_mat(rng, 300, 70, 0.05).astype(dtype)
    vn = rng.normal(size=(300,)).astype(dtype)
    wn = rng.normal(size=(70, 2)).astype(dtype)
    xr, xt = rb.sparsify(xn), tb.sparsify(xn)
    tol = F64_RTOL if dtype == np.float64 else F32_TOL
    pairs = [(tops.gram_bcoo(xt), sops.gram_bcoo(xr)),
             (tops.xtv_bcoo(xt, torch.from_numpy(vn)),
              sops.xtv_bcoo(xr, vn)),
             (tops.xtv_bcoo(xt, torch.from_numpy(vn[:, None])),
              sops.xtv_bcoo(xr, vn[:, None])),
             (tops.matmul_bcoo(xt, torch.from_numpy(wn)),
              sops.matmul_bcoo(xr, wn)),
             (tops.matmul_bcoo(xt, torch.from_numpy(wn[:, 0])),
              sops.matmul_bcoo(xr, wn[:, 0]))]
    for got, want in pairs:
        want = np.asarray(want)
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        assert _rel(got.numpy(), want) <= tol


# ---------------------------------------------------------------------------
# the mask is used, and a skipped block adds an exact zero
# ---------------------------------------------------------------------------

def test_zero_blocks_are_skipped_exactly(reference, rng):
    sops, _ = reference
    x = np.zeros((64, 32), dtype=np.float32)
    x[:, :16] = rng.normal(size=(64, 16)).astype(np.float32)
    got = tops.gram_dense_masked(torch.from_numpy(x), bm=16, bn=16).numpy()
    np.testing.assert_allclose(got, x.T @ x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(sops.gram_dense_masked(x, bm=16, bn=16,
                                               interpret=True)),
        rtol=1e-4, atol=1e-4)
    assert np.all(got[16:, 16:] == 0.0) and np.all(got[:16, 16:] == 0.0)


def test_masked_blocks_are_left_out(rng):
    """A block whose count is 0 is not read: zeroing one populated block's
    count gives the product of X with that block zeroed, entry for entry."""
    xn = rng.normal(size=(64, 48))
    x = torch.from_numpy(xn)
    mask = tref.block_mask(x, 16, 16)
    mask[1, 2] = 0
    cut = xn.copy()
    cut[16:32, 32:48] = 0.0
    v, w = rng.normal(size=(64, 2)), rng.normal(size=(48, 3))
    assert np.array_equal(tref.skip_masked(x, mask, 16, 16).numpy(), cut)
    assert _rel(tops.gram_dense_masked(x, mask, 16, 16), cut.T @ cut) \
        <= F64_RTOL
    assert _rel(tops.xtv_dense_masked(x, torch.from_numpy(v), mask, 16, 16),
                cut.T @ v) <= F64_RTOL
    assert _rel(tops.spmm_dense_masked(x, torch.from_numpy(w), mask, 16, 16),
                cut @ w) <= F64_RTOL
    with pytest.raises(ValueError, match="does not tile"):
        tref.gram(x, mask[:, :2], 16, 16)


def test_densify_accumulates_duplicates():
    from repro_torch.core.sparse import BCOO
    idx = torch.tensor([[0, 1], [2, 0], [2, 0], [2, 0]], dtype=torch.int32)
    data = torch.tensor([1.5, 2.0, 0.0, 0.0], dtype=torch.float64)
    b = BCOO(data, idx, (3, 2), indices_sorted=True)
    want = np.array([[0.0, 1.5], [0.0, 0.0], [2.0, 0.0]])
    assert np.array_equal(b.todense().numpy(), want)
    dup = BCOO(torch.tensor([1.0, 2.0, 0.0]), idx[1:], (3, 2))
    assert dup.todense()[2, 0].item() == 3.0
    # the padding of sparsify repeats the last real index with zeros
    xn = np.zeros((20, 300))
    xn[19, 299] = 7.0
    sp = tb.sparsify(xn)
    assert sp.nse == 256 and sp.indices[-1].tolist() == [19, 299]
    assert np.array_equal(sp.todense().numpy(), xn)
    assert tops.block_mask_from_indices(sp, 16, 64).sum().item() == 1


def test_scaled_tolerance_rejects_one_wrong_entry(rng):
    """The on-card limit passes float32 accumulation against float64
    arithmetic on the same inputs and rejects one entry wrong by a typical
    off-diagonal value, at a blocky gram."""
    xn = _blocky(rng, 4096, 256, 1024, 128, 0.5, 0.2)
    x = torch.from_numpy(xn)
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    exact = tref.gram(x, mask, tops.ROWS, tops.TILE)
    x32 = x.float()
    g = tref.gram(x32, mask, tops.ROWS, tops.TILE)
    assert gram_ref.scaled_err(g, exact, x32, x32) <= KERNEL_TOL[torch.float32]
    bad = g.clone()
    bad[3, 7] += exact[0, 1:].abs().mean().item()
    assert gram_ref.scaled_err(bad, g, x32, x32) \
        > 100 * KERNEL_TOL[torch.float32]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("m,n,c", [(20_000, 1000, 1), (6784, 1000, 3),
                                   (1000, 130, 2), (300, 12, 1)])
def test_cuda_kernels_match_plain_version(cuda_device, m, n, c, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    x = torch.from_numpy(_blocky(rng, m, n, 1024, 128, 0.25, 0.2)).to(
        cuda_device, dtype)
    v = torch.from_numpy(rng.normal(size=(m, c))).to(cuda_device, dtype)
    w = torch.from_numpy(rng.normal(size=(n, c))).to(cuda_device, dtype)
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    ones = torch.ones_like(mask)
    before = dict(tops.LAUNCHES)
    g = tops.gram_bs_cuda(x, mask)
    xv = tops.xtv_bs_cuda(x, v, mask)
    y = tops.spmm_cuda(x, w, mask)
    torch.cuda.synchronize()
    for k in ("gram_bs", "gram_bs_reduce", "xtv_bs", "xtv_bs_reduce",
              "spmm"):
        assert tops.LAUNCHES[k] == before[k] + 1
    tol = KERNEL_TOL[dtype]
    args = (mask, tops.ROWS, tops.TILE)
    assert gram_ref.scaled_err(g, tref.gram(x, *args), x, x) <= tol
    assert gram_ref.scaled_err(xv, tref.xtv(x, v, *args), x, v) <= tol
    assert gram_ref.scaled_err(y, tref.spmm(x, w, *args), x.mT, w) <= tol
    assert torch.equal(g, g.mT)
    assert torch.equal(g, tops.gram_bs_cuda(x, ones))
    assert torch.equal(xv, tops.xtv_bs_cuda(x, v, ones))
    assert torch.equal(y, tops.spmm_cuda(x, w, ones))
    assert torch.equal(g, tops.gram_bs_cuda(x, mask))


@pytest.mark.cuda
def test_cuda_bcoo_path_launches_the_kernels(cuda_device):
    rng = np.random.default_rng(1)
    xn = _blocky(rng, 5000, 300, 1024, 128, 0.3, 0.2)
    x = tb.to_device(tb.sparsify(xn), cuda_device)
    vn = rng.normal(size=(5000,))
    before = dict(tops.LAUNCHES)
    g = tops.gram_bcoo(x)
    xv = tops.xtv_bcoo(x, torch.from_numpy(vn).to(cuda_device))
    y = tops.matmul_bcoo(x, torch.from_numpy(vn[:300]).to(cuda_device))
    assert tops.LAUNCHES["gram_bs"] == before["gram_bs"] + 1
    assert tops.LAUNCHES["xtv_bs"] == before["xtv_bs"] + 1
    assert tops.LAUNCHES["spmm"] == before["spmm"] + 1
    assert _rel(g.cpu(), xn.T @ xn) <= F64_RTOL
    assert _rel(xv.cpu(), xn.T @ vn) <= F64_RTOL
    assert xv.shape == (300,) and y.shape == (5000,)
    assert _rel(y.cpu(), xn @ vn[:300]) <= F64_RTOL


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_they_do_not_take(cuda_device):
    x = torch.ones(300, 70, dtype=torch.float64, device=cuda_device)
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    with pytest.raises(ValueError, match="mask must be"):
        tops.gram_bs_cuda(x, mask[:, :1].contiguous())
    with pytest.raises(ValueError, match="mask must be"):
        tops.gram_bs_cuda(x, mask.long())
    with pytest.raises(ValueError, match="blocks"):
        tops.gram_dense_masked(x, bm=16, bn=16)
    with pytest.raises(TypeError, match="unsupported dtype"):
        tops.gram_bs_cuda(x.half(), mask)
