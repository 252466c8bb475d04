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


def _sparse_splits(m, tiles, sms, items_per_block):
    """(splits, rows per split) of gram_bs's plan, stated apart from
    `kernels/spmm/ops.py`: ~`items_per_block` (tile, split) items per SM
    over `tiles` output tiles, in whole 256-row chunks, at most 8,192
    chunks a split."""
    want = -(-items_per_block * sms // tiles)
    rows = 256 * min(-(-m // (256 * want)), 8192)
    return -(-m // rows), rows


@pytest.mark.parametrize("m", [1, 63, 64, 1000, 8192, 100_000, 400_000])
@pytest.mark.parametrize("blocks", [1, 36, 136, 528])
def test_splits_rule_is_kept_for_the_sparse_kernels(m, blocks):
    """The block-sparse kernels' split rules: gram_bs's plan over `blocks`
    upper output tiles of 128 x 128 (n = 128 T, T (T + 1) / 2 = blocks)
    on a card of 132 SMs, 24 items per SM in float64 and float32 and 8 in
    bfloat16 (each split covers whole chunks and none is empty); xtv_bs's
    strided splits, at most one a chunk."""
    from repro_torch.kernels.spmm import ops as sops
    t = int(round(((8 * blocks + 1) ** 0.5 - 1) / 2))
    n = 128 * t
    assert tops.gram_tiles(n) == blocks
    for dtype, per in ((torch.float64, 24), (torch.float32, 24),
                       (torch.bfloat16, 8)):
        tile_n, splits, rows = sops.gram_bs_plan(m, n, dtype, 132)
        assert tile_n == 128
        assert (splits, rows) == _sparse_splits(m, blocks, 132, per)
        assert rows % 256 == 0 and (splits - 1) * rows < m <= splits * rows
        assert 1 <= sops.xtv_bs_plan(m, n, 1, dtype, 132) <= -(-m // 256)


def _upper_tiles(n, tile_n):
    """(i0, j0) of every output tile gram computes, in launch order (the
    `upper_tile` walk of gram.cu)."""
    ti_n, tj_n = -(-n // 128), -(-n // tile_n)
    r = 128 // tile_n
    return [(ti * 128, tj * tile_n) for ti in range(ti_n)
            for tj in range(ti * r, tj_n)]


@pytest.mark.parametrize("tile_n", [128, 64])
@pytest.mark.parametrize("n", [1, 12, 64, 65, 127, 128, 129, 300, 1000, 1001])
def test_gram_tiles_cover_the_upper_triangle_once(n, tile_n):
    """The tiles the workspace is sized for cover each element with i <= j
    exactly once (the reduce pass writes those and their mirrors)."""
    tiles = _upper_tiles(n, tile_n)
    assert tops.gram_tiles(n, tile_n) == len(tiles)
    seen = np.zeros((n, n), dtype=int)
    for i0, j0 in tiles:
        blk = seen[i0:i0 + 128, j0:j0 + tile_n]
        ii = np.arange(i0, i0 + blk.shape[0])[:, None]
        jj = np.arange(j0, j0 + blk.shape[1])[None, :]
        blk += ii <= jj
    assert np.array_equal(seen, np.triu(np.ones((n, n), dtype=int)))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("m,n", [(1, 5), (7, 130), (1696, 1000),
                                 (8192, 1000), (5000, 64), (20000, 34),
                                 (100_000, 1000)])
@pytest.mark.parametrize("sms", [132, 114])
def test_gram_and_xtv_plans(m, n, dtype, sms):
    """Both plans cover the rows once with no empty split, depend only on
    the shape, dtype and card, and give each xtv block hundreds of KB to
    read where the rows allow it."""
    tile_n, splits, rows = tops.gram_plan(m, n, dtype, sms, 128)
    assert tile_n == (64 if n <= 64 else 128)
    assert (splits - 1) * rows < m <= splits * rows
    assert splits <= -(-m // 64)  # never finer than 64 rows a split
    assert tops.gram_plan(m, n, dtype, sms, 128) == (tile_n, splits, rows)
    for c in (1, 3):
        xs, xr = tops.xtv_plan(m, n, c, dtype, sms)
        assert (xs - 1) * xr < m <= xs * xr
        assert xs <= -(-m // 256)
        # never more blocks than fit on the card at once
        slabs = -(-n // (512 // dtype.itemsize))
        assert xs == 1 or xs * slabs <= tops._XTV_BLOCKS_PER_SM[
            1 if c == 1 else 4] * sms


def test_gram_plan_at_the_lmds_bucket():
    """The float64 split plans at lmDS's 8,192 x 1,000 bucket on 132 SMs
    (PERF.md: the fastest in the measured sweeps): gram's 36 tiles
    x 7 splits (1.9 waves), xtv's 16 slabs x 16 splits of 512 rows (one
    wave at 2 blocks a SM)."""
    assert tops.gram_plan(8192, 1000, torch.float64, 132, 128) == \
        (128, 7, 1171)
    assert tops.xtv_plan(8192, 1000, 1, torch.float64, 132) == (16, 512)


@pytest.mark.parametrize("shape,cols,want", [
    ((20000, 34), slice(None), True),      # 272-byte rows
    ((20000, 35), slice(1, None), False),  # offset base, 280-byte rows
    ((20000, 36), slice(1, None), False),  # offset base by 8 bytes
    ((20000, 36), slice(2, None), True),   # offset by 16, 288-byte rows
    ((300, 13), slice(None), False),       # odd width: 104-byte rows
])
def test_copy_width_follows_base_and_leading_dimension(shape, cols, want):
    """16-byte copies where X's base and leading dimension are 16-byte
    aligned, element copies elsewhere: a column slice keeps its parent's
    leading dimension and is not copied."""
    x = torch.zeros(shape, dtype=torch.float64)[:, cols]
    assert tops.aligned16(x) is want


def _cuda_case(m, n, c, offset, dtype, device):
    """X (a column slice at `offset` of a wider parent when offset > 0) and
    v on the card, from a seed."""
    parent = torch.from_numpy(_data(m, n + offset, "float64", 0)).to(
        device, TORCH_DTYPE[dtype])
    v = torch.from_numpy(_data(m, c, "float64", 7)).to(device,
                                                       TORCH_DTYPE[dtype])
    return parent[:, offset:], v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("m,n,c,offset", [
    pytest.param(8192, 1000, 1, 0, id="8192-1000-1"),
    pytest.param(1696, 1000, 3, 0, id="1696-1000-3"),
    pytest.param(5000, 64, 1, 0, id="5000-64-1"),
    pytest.param(300, 12, 1, 0, id="300-12-1"),
    pytest.param(20000, 34, 1, 1, id="offset-slice-20000-34"),
    pytest.param(3000, 1001, 1, 0, id="odd-n-3000-1001"),
    pytest.param(700, 100, 3, 2, id="n-below-a-tile-700-100"),
    pytest.param(7, 130, 1, 0, id="m-below-a-stage-7-130"),
    pytest.param(1, 257, 3, 1, id="m-1-257"),
    pytest.param(2048, 300, 3, 0, id="c-3-2048-300"),
])
def test_cuda_kernels_match_plain_version(cuda_device, m, n, c, offset,
                                          dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    x, v = _cuda_case(m, n, c, offset, dtype, cuda_device)
    before = dict(tops.LAUNCHES)
    g = tops.gram(x)
    xv = tops.xtv(x, v)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["gram"] == before["gram"] + 1
    assert tops.LAUNCHES["xtv"] == before["xtv"] + 1
    assert torch.equal(g, g.mT)
    assert tref.scaled_err(g, tref.gram(x), x, x) <= KERNEL_RTOL[dtype]
    assert tref.scaled_err(xv, tref.xtv(x, v), x, v) <= KERNEL_RTOL[dtype]
    # fixed-order reduction: bitwise reproducible from call to call
    assert torch.equal(g, tops.gram(x))
    assert torch.equal(xv, tops.xtv(x, v))


@pytest.mark.cuda
def test_cuda_wrappers_refuse_float16(cuda_device):
    """gram.cu has no float16 instantiation: the card refuses it rather
    than computing it unchecked (the CPU's plain version serves it)."""
    x = torch.ones(8, 4, dtype=torch.float16, device=cuda_device)
    with pytest.raises(TypeError, match="unsupported dtype"):
        tops.gram(x)
    with pytest.raises(TypeError, match="unsupported dtype"):
        tops.xtv(x, x[:, :1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("k,m,n,c", [
    pytest.param(8, 12_500, 1000, 1, id="cv-fold-8-12500-1000"),
    pytest.param(3, 777, 130, 3, id="3-777-130-3"),
    pytest.param(2, 1, 5, 1, id="m-1"),
    pytest.param(5, 3000, 1001, 2, id="odd-n-5-3000-1001"),
])
def test_cuda_batched_kernels_match_lone_calls(cuda_device, k, m, n, c,
                                               dtype):
    """gram and xtv under torch.func.vmap on the card: one batched launch
    (and its reduce) per call, each element within the kernel limit of a
    lone call and of the plain version computed in float64 from the same
    inputs, bitwise repeatable; xtv also with one v for the batch (batch
    stride 0) and with one X (the batch folded into v's columns)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = TORCH_DTYPE[dtype]
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(k, m, n))).to(cuda_device, dt)
    v = torch.from_numpy(np.random.default_rng(4).normal(
        size=(k, m, c))).to(cuda_device, dt)
    tol = KERNEL_RTOL[dtype]
    before = dict(tops.LAUNCHES)
    g = torch.func.vmap(tops.gram_op)(x)
    xv = torch.func.vmap(tops.xtv_op)(x, v)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["gram_batched"] == before["gram_batched"] + 1
    assert tops.LAUNCHES["xtv_batched"] == before["xtv_batched"] + 1
    assert tops.LAUNCHES["gram"] == before["gram"]
    assert torch.equal(g, g.mT)
    for i in range(k):
        xi, vi = x[i], v[i]
        assert tref.scaled_err(g[i], tops.gram_cuda(xi), xi, xi) <= tol
        assert tref.scaled_err(g[i], tref.gram(xi.double()), xi, xi) <= tol
        assert tref.scaled_err(xv[i], tops.xtv_cuda(xi, vi), xi, vi) <= tol
        assert tref.scaled_err(xv[i], tref.xtv(xi.double(), vi.double()),
                               xi, vi) <= tol
    assert torch.equal(g, torch.func.vmap(tops.gram_op)(x))
    assert torch.equal(xv, torch.func.vmap(tops.xtv_op)(x, v))
    shared_v = torch.func.vmap(tops.xtv_op, in_dims=(0, None))(x, v[0])
    folded = torch.func.vmap(tops.xtv_op, in_dims=(None, 0))(x[0], v)
    for i in range(k):
        assert tref.scaled_err(shared_v[i], tref.xtv(x[i].double(),
                                                     v[0].double()),
                               x[i], v[0]) <= tol
        assert tref.scaled_err(folded[i], tref.xtv(x[0].double(),
                                                   v[i].double()),
                               x[0], v[i]) <= tol
