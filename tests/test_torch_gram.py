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
        assert xs == 1 or xs * slabs <= tops._XTV_BLOCKS_PER_SM * sms


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
    key = "xtv" if c == 1 else "xtv_tile"
    assert tops.LAUNCHES[key] == before[key] + 1
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
    key = "xtv_batched" if c == 1 else "xtv_tile_batched"
    assert tops.LAUNCHES[key] == before[key] + 1
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


# -- the xtv tile product (two or more columns of v) and the bf16 wgmma gram --

# (m, n, c) of the paths' wide xtv launches and the odd shapes the card's
# cases run: kmeans' per-cluster sums AᵀX (A one-hot, 8 columns), mlogreg's
# gradient (10 classes), the CV fold's 8 v's folded into columns, ragged c
# on an odd width and on steplm's 34 columns, tiny and wide-by-wide cases
TILE_SHAPES = [(100_000, 8, 1000), (100_000, 1000, 10), (12_500, 1000, 8),
               (3000, 1001, 9), (3000, 1001, 129), (20_000, 34, 9),
               (20_000, 34, 129), (7, 130, 3), (1, 257, 3), (300, 12, 3),
               (4096, 64, 2), (2048, 300, 300)]


def _tile_cover(n, c, bn, trans):
    """How many output tiles of the tile product cover each entry of the
    (n, c) output: the wider side (c when trans) in tiles of 128, the
    narrower in tiles of bn."""
    wide, narrow = (c, n) if trans else (n, c)
    seen = np.zeros((wide, narrow), dtype=int)
    for i0 in range(0, wide, 128):
        for j0 in range(0, narrow, bn):
            seen[i0:i0 + 128, j0:j0 + bn] += 1
    return seen


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("m,n,c", TILE_SHAPES)
def test_xtv_tile_plan(m, n, c, dtype, sms, batch):
    """The tile plan covers every output entry with one tile and every row
    with one split (no empty split, at most 65,535), orients the wider
    operand into the 128-wide tiles, pads the narrow side to the next of
    8, 16, 32 and 64 only, fills the card's resident slots at most once
    unless one split a tile already exceeds them, splits no finer than
    64 rows, and is a pure function of its arguments."""
    bn, trans, splits, rows = tops.xtv_tile_plan(m, n, c, dtype, sms, batch)
    assert trans == (n < c)
    narrow = min(n, c)
    assert bn == next((b for b in (8, 16, 32) if narrow <= b), 64)
    assert (splits - 1) * rows < m <= splits * rows
    assert 1 <= splits <= 65535
    tiles = batch * -(-max(n, c) // 128) * -(-narrow // bn)
    assert splits == 1 or tiles * splits <= 2 * sms
    assert splits <= -(-m // 64)  # never finer than 64 rows a split
    assert np.array_equal(_tile_cover(n, c, bn, trans),
                          np.ones((max(n, c), narrow), dtype=int))
    assert tops.xtv_tile_plan.__wrapped__(m, n, c, dtype, sms, batch) == \
        (bn, trans, splits, rows)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("m,n,c", TILE_SHAPES + [(8192, 1000, 1),
                                                 (100_000, 1000, 1)])
def test_xtv_route_by_columns(m, n, c, dtype):
    """One column of v takes the slab kernel under its own plan; two or
    more, the tile product under its plan; the route is a pure function of
    the shape, dtype, card and batch."""
    for batch in (1, 8):
        route = tops.xtv_route(m, n, c, dtype, 132, batch)
        if c == 1:
            assert route == ("slab",) + tops.xtv_plan(m, n, c, dtype, 132,
                                                      batch)
        else:
            assert route == ("tile",) + tops.xtv_tile_plan(
                m, n, c, dtype, 132, batch)
        assert tops.xtv_route.__wrapped__(m, n, c, dtype, 132, batch) == \
            route
        assert route[0] == ("slab" if c == 1 else "tile")


@pytest.mark.parametrize("m", [1, 63, 64, 65, 12_500, 100_000])
@pytest.mark.parametrize("n", [12, 64, 1000, 1001])
def test_bf16_gram_splits_are_whole_stages(m, n):
    """The bfloat16 gram's TMA ring loads 64 rows a stage: every split but
    the last holds whole stages, so no stage reads into the next split."""
    for batch in (1, 8):
        tile_n, splits, rows = tops.gram_plan(m, n, torch.bfloat16, 132,
                                              128, batch)
        assert rows % 64 == 0
        assert (splits - 1) * rows < m <= splits * rows


@pytest.mark.parametrize("route", ["fold", "shared_v", "batched"])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vmapped_xtv_op_matches_reference(reference, route, c, dtype):
    """`xtv_op` under torch.func.vmap on the CPU (one X with a batch of v,
    a batch of X with one v, both batched) against the reference's
    `ops.xtv` under jax.vmap, its jnp oracle and its Pallas kernel in
    interpret mode."""
    import functools
    import jax
    jnp, gops, gref = reference
    k, m, n = 4, 256, 96
    x3 = _data(k * m, n, dtype, seed=11).reshape(k, m, n)
    v3 = _data(k * m, c, dtype, seed=12).reshape(k, m, c)
    xs, vs = {"fold": (x3[0], v3), "shared_v": (x3, v3[0]),
              "batched": (x3, v3)}[route]
    axes = (None if xs.ndim == 2 else 0, None if vs.ndim == 2 else 0)
    t = from_reference({"x": xs, "v": vs}, "cpu")
    got = torch.func.vmap(tops.xtv_op, in_dims=axes)(t["x"], t["v"])
    assert tuple(got.shape) == (k, n, c)
    with jax.enable_x64(False):
        oracle = jax.vmap(gref.xtv, in_axes=axes)(jnp.asarray(xs),
                                                  jnp.asarray(vs))
        pallas = jax.vmap(functools.partial(gops.xtv, interpret=True, bm=128,
                                            bn=32), in_axes=axes)(
            jnp.asarray(xs), jnp.asarray(vs))
    for want in (oracle, pallas):
        assert _rel(got.numpy(), np.asarray(want)) <= RTOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("m,n,c,offset", [
    pytest.param(4096, 8, 1000, 0, id="kmeans-like-4096-8-1000"),
    pytest.param(8192, 1000, 10, 0, id="mlogreg-like-8192-1000-10"),
    pytest.param(12_500, 1000, 8, 0, id="fold-12500-1000-8"),
    pytest.param(3000, 1001, 9, 0, id="ragged-c9-3000-1001"),
    pytest.param(3000, 1001, 129, 0, id="ragged-c129-3000-1001"),
    pytest.param(20000, 34, 9, 1, id="offset-slice-c9-20000-34"),
    pytest.param(20000, 34, 129, 1, id="offset-slice-c129-20000-34"),
    pytest.param(7, 130, 3, 0, id="m-below-a-stage-7-130-3"),
    pytest.param(2048, 300, 300, 3, id="wide-by-wide-2048-300-300"),
])
def test_cuda_xtv_tile_matches_plain_version(cuda_device, m, n, c, offset,
                                             dtype):
    """Every xtv of two or more columns launches the tile product once
    (and its reduce), within KERNEL_RTOL of the plain version, bitwise on
    a second call; for a narrow X the wider v takes the 128-wide tiles."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, v = _cuda_case(m, n, c, offset, dtype, cuda_device)
    before = dict(tops.LAUNCHES)
    got = tops.xtv(x, v)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["xtv_tile"] == before["xtv_tile"] + 1
    assert tops.LAUNCHES["xtv"] == before["xtv"]
    assert got.dtype == tref.acc_dtype(x.dtype) and got.shape == (n, c)
    assert tref.scaled_err(got, tref.xtv(x, v), x, v) <= KERNEL_RTOL[dtype]
    assert tref.scaled_err(got, tref.xtv(x.double(), v.double()), x, v) \
        <= KERNEL_RTOL[dtype]
    assert torch.equal(got, tops.xtv(x, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("k,m,n,c", [
    pytest.param(8, 12_500, 1000, 1, id="cv-fold-8-12500-1000-1"),
    pytest.param(4, 3000, 1001, 3, id="odd-n-4-3000-1001-3"),
    pytest.param(3, 777, 8, 40, id="narrow-x-3-777-8-40"),
    pytest.param(2, 100, 5, 2, id="tiny-2-100-5-2"),
])
def test_cuda_xtv_tile_batched_and_folded(cuda_device, k, m, n, c, dtype):
    """Batched xtv of two or more columns with X and v batched, with one v
    (batch stride 0) and with one X (the batch read in place as k·c
    columns: one lone tile launch, no copy of v), each element within
    KERNEL_RTOL of the plain version in float64, bitwise on repeat."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dt = TORCH_DTYPE[dtype]
    x = torch.from_numpy(np.random.default_rng(5).normal(
        size=(k, m, n))).to(cuda_device, dt)
    v = torch.from_numpy(np.random.default_rng(6).normal(
        size=(k, m, c))).to(cuda_device, dt)
    tol = KERNEL_RTOL[dtype]
    runs = {"batched": ((0, 0), x, v), "shared_v": ((0, None), x, v[0]),
            "fold": ((None, 0), x[0], v)}
    for name, (axes, xs, vs) in runs.items():
        fn = torch.func.vmap(tops.xtv_op, in_dims=axes)
        before = dict(tops.LAUNCHES)
        got = fn(xs, vs)
        torch.cuda.synchronize()
        cols = k * c if name == "fold" else c
        tile = cols >= 2
        key = {("fold", True): "xtv_tile", ("fold", False): "xtv"}.get(
            (name, tile), "xtv_tile_batched" if tile else "xtv_batched")
        assert tops.LAUNCHES[key] == before[key] + 1, name
        assert got.shape == (k, n, c)
        for i in range(k):
            xi = xs if axes[0] is None else xs[i]
            vi = vs if axes[1] is None else vs[i]
            want = tref.xtv(xi.double(), vi.double())
            assert tref.scaled_err(got[i], want, xi, vi) <= tol, name
        assert torch.equal(got, fn(xs, vs)), name


@pytest.mark.cuda
@pytest.mark.parametrize("n", [12, 64, 1000, 1001])
@pytest.mark.parametrize("m", [100, 12_500])
def test_cuda_bf16_gram_on_wgmma(cuda_device, m, n):
    """The bfloat16 gram (lone and batched; a misaligned width through an
    aligned copy) within KERNEL_RTOL of the plain version in float64,
    bitwise symmetric and bitwise on repeat."""
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(3, m, n))).to(cuda_device, torch.bfloat16)
    tol = KERNEL_RTOL["bfloat16"]
    before = dict(tops.LAUNCHES)
    g = tops.gram(x[1])
    gb = torch.func.vmap(tops.gram_op)(x)
    torch.cuda.synchronize()
    assert tops.LAUNCHES["gram"] == before["gram"] + 1
    assert tops.LAUNCHES["gram_batched"] == before["gram_batched"] + 1
    assert g.dtype == gb.dtype == torch.float32
    assert torch.equal(g, g.mT) and torch.equal(gb, gb.mT)
    assert tref.scaled_err(g, tref.gram(x[1].double()), x[1], x[1]) <= tol
    for i in range(3):
        assert tref.scaled_err(gb[i], tref.gram(x[i].double()), x[i],
                               x[i]) <= tol
    assert torch.equal(g, tops.gram(x[1]))
    assert torch.equal(gb, torch.func.vmap(tops.gram_op)(x))


# -- the cost counter: a count on "meta" is the card's, op for op -------------

def _meta(shape, dtype, offset=0):
    """A "meta" tensor of `shape` whose last axis starts `offset` columns
    into wider rows (a column slice at an offset), as `_strided` on the
    host."""
    *lead, n = shape
    return torch.empty((*lead, n + offset), dtype=dtype,
                       device="meta")[..., offset:]


def _strided(shape, dtype, offset=0, device="cpu"):
    *lead, n = shape
    return torch.zeros((*lead, n + offset), dtype=dtype,
                       device=device)[..., offset:]


@pytest.mark.parametrize("k,c", [(8, 1), (3, 4), (1, 1), (1, 3)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_folded_xtv_counts_on_meta_as_on_the_card(k, c, dtype):
    """vmap of `xtv_op` over a batch of v with one X, on "meta": the
    kernel's work for k·c columns and no other op, as on the card (the
    tile product reads the v's in place; a one-column fold's v is a
    view), and the card's output shape and dtype."""
    from repro_torch.launch import hlocost, kernel_model
    m, n = 300, 20
    x, v = _meta((m, n), dtype), _meta((k, m, c), dtype)
    fn = torch.func.vmap(tops.xtv_op, in_dims=(None, 0))
    t = hlocost.count(fn, x, v)
    assert (t.flops, t.bytes) == kernel_model.xtv_work(m, n, k * c, dtype)
    assert set(t.by_op) == {"xtv"} and t.by_op["xtv"][0] == 1
    out = fn(x, v)
    assert out.shape == (k, n, c) and out.dtype == tref.acc_dtype(dtype)


@pytest.mark.parametrize("k", [None, 3])
@pytest.mark.parametrize("n,offset", [(13, 0), (16, 0), (16, 1), (64, 0)])
def test_bf16_gram_counts_its_aligned_copy_on_meta(n, offset, k):
    """The bfloat16 gram on "meta" (lone, and a vmapped stack) charges the
    copy that the card makes of an X whose base or row stride is not
    16-byte aligned (`_tma_ready`, counted on the host) beside the
    kernel's work, and nothing more where X is aligned."""
    from repro_torch.launch import hlocost, kernel_model
    m, dt = 100, torch.bfloat16
    shape = (m, n) if k is None else (k, m, n)
    host = _strided(shape, dt, offset)
    copy = hlocost.count(tops._tma_ready, host)
    aligned = offset == 0 and n % 8 == 0
    assert (copy.bytes == 0) == aligned
    if k is None:
        t = hlocost.count(tops.gram, _meta(shape, dt, offset))
        work = kernel_model.gram_work(m, n, dt)
    else:
        t = hlocost.count(torch.func.vmap(tops.gram_op),
                          _meta(shape, dt, offset))
        work = kernel_model.gram_batched_work(k, m, n, dt)
    assert (t.flops, t.bytes) == (copy.flops + work[0],
                                  copy.bytes + work[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fold", "fold_c1", "batched",
                                  "gram_bf16_odd", "gram_bf16_odd_stack",
                                  "gram_bf16_slice"])
def test_cuda_count_equals_meta(cuda_device, case):
    """The cost counter's totals of a gram/xtv call on the card equal those
    of the same call on "meta" (FLOPs, bytes and ops)."""
    from repro_torch.launch import hlocost
    f64, bf16 = torch.float64, torch.bfloat16
    fold = torch.func.vmap(tops.xtv_op, in_dims=(None, 0))
    calls = {
        "fold": (fold, [((3000, 40), f64, 0), ((8, 3000, 2), f64, 0)]),
        "fold_c1": (fold, [((3000, 40), f64, 0), ((8, 3000, 1), f64, 0)]),
        "batched": (torch.func.vmap(tops.xtv_op),
                    [((4, 3000, 40), f64, 0), ((4, 3000, 3), f64, 0)]),
        "gram_bf16_odd": (tops.gram, [((3000, 13), bf16, 0)]),
        "gram_bf16_odd_stack": (torch.func.vmap(tops.gram_op),
                                [((4, 3000, 13), bf16, 0)]),
        "gram_bf16_slice": (tops.gram, [((3000, 64), bf16, 1)]),
    }
    fn, specs = calls[case]
    card_args = [_strided(s, d, o, cuda_device) for s, d, o in specs]
    meta_args = [_meta(s, d, o) for s, d, o in specs]
    card = hlocost.count(fn, *card_args)
    meta = hlocost.count(fn, *meta_args)
    assert card.flops == meta.flops > 0
    assert card.bytes == meta.bytes
    assert dict(card.by_op) == dict(meta.by_op)
