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
# gram_bs's plan and schedule (csrc/spmm.cu's gram_bs_partial_kernel)
# ---------------------------------------------------------------------------

def test_gram_bs_plan_takes_no_mask():
    """The split plan is a function of (m, n, dtype, SM count) alone: a
    run with the true mask and one with an all-ones mask sum the same
    partials in the same order."""
    import inspect
    assert list(inspect.signature(tops.gram_bs_plan).parameters) == [
        "m", "n", "dtype", "sms"]
    # the card's SM count is part of the key
    assert tops.gram_bs_plan(100_000, 1000, torch.float64, 132) \
        != tops.gram_bs_plan(100_000, 1000, torch.float64, 114)


@pytest.mark.parametrize("m", [1, 255, 256, 6784, 30_770, 100_000, 400_000,
                               5_000_000])
@pytest.mark.parametrize("n,dtype", [(1, torch.float64), (64, torch.float32),
                                     (1000, torch.float64),
                                     (2000, torch.bfloat16)])
def test_gram_bs_plan_cuts_whole_chunks(m, n, dtype):
    plan = tops.gram_bs_plan(m, n, dtype, 132)
    tops.gram_bs_plan.cache_clear()
    assert tops.gram_bs_plan(m, n, dtype, 132) == plan  # shape-only
    tile_n, splits, rows = plan
    assert tile_n == (64 if n <= 64 else 128)
    assert rows % tops.ROWS == 0 and 1 <= rows // tops.ROWS \
        <= tops._BS_MAX_CHUNKS
    assert splits * rows >= m > (splits - 1) * rows
    want = -(-tops._BS_WAVES[dtype] * 132 // gram_ref_tiles(n, tile_n))
    if rows > tops.ROWS:  # a split of one chunk is the finest there is
        # as many items as asked for, never more; at least half as many
        assert want // 2 < splits <= want


def gram_ref_tiles(n, tile_n):
    from repro_torch.kernels.gram.ops import gram_tiles
    return gram_tiles(n, tile_n)


def _upper(n, tile_n):
    """(i0, j0) of every upper tile in gram's linear order."""
    ti_n, tj_n, r = -(-n // 128), -(-n // tile_n), 128 // tile_n
    return [(ti * 128, tj * tile_n) for ti in range(ti_n)
            for tj in range(ti * r, tj_n)]


def _item_tile(item, splits, n, tile_n):
    """spmm.cu's item_tile: every diagonal tile's items, then the rest."""
    r = 128 // tile_n
    ti_n, tj_n = -(-n // 128), -(-n // tile_n)
    off = len(_upper(n, tile_n)) - ti_n
    if item < ti_n * splits:
        d = item % ti_n
        return d * tj_n - r * d * (d - 1) // 2, item // ti_n
    item -= ti_n * splits
    k, ti, split = item % off, 0, item // off
    while k >= tj_n - ti * r - 1:
        k -= tj_n - ti * r - 1
        ti += 1
    return ti * tj_n - r * ti * (ti - 1) // 2 + 1 + k, split


@pytest.mark.parametrize("n,tile_n", [(1, 64), (64, 64), (200, 64),
                                      (65, 128), (128, 128), (200, 128),
                                      (1000, 128), (1001, 128)])
@pytest.mark.parametrize("splits", [1, 7])
def test_gram_bs_items_cover_every_tile_and_split_diagonal_first(n, tile_n,
                                                                 splits):
    tiles = _upper(n, tile_n)
    items = [_item_tile(i, splits, n, tile_n)
             for i in range(len(tiles) * splits)]
    assert sorted(items) == [(t, s) for t in range(len(tiles))
                             for s in range(splits)]
    ti_n = -(-n // 128)
    head = items[:ti_n * splits]
    assert all(tiles[t][0] == tiles[t][1] for t, _ in head)
    assert not any(tiles[t][0] == tiles[t][1] for t, _ in
                   items[ti_n * splits:])


def _gram_split(x, mask, tile_n, rows):
    """The CUDA gram_bs's algebra on the CPU, in float64: per item (tile,
    split) the tile's product summed over the split's chunks in row
    order, a chunk skipped when every mask tile under the tile's i
    columns, or under its j columns, has count 0; an item with no
    populated chunk is not filled; each tile sums its filled partials in
    split order from +0, and writes the upper triangle and its mirror
    from one sum."""
    m, n = x.shape
    bm, bn = tops.ROWS, tops.TILE
    g = torch.zeros((n, n), dtype=torch.float64)
    for i0, j0 in _upper(n, tile_n):
        i1, j1 = min(i0 + 128, n), min(j0 + tile_n, n)
        mi = slice(i0 // bn, (i1 - 1) // bn + 1)
        mj = slice(j0 // bn, (j1 - 1) // bn + 1)
        s = torch.zeros((i1 - i0, j1 - j0), dtype=torch.float64)
        for r0 in range(0, m, rows):
            part = None
            for c in range(r0 // bm, -(-min(m, r0 + rows) // bm)):
                if not (mask[c, mi].any() and mask[c, mj].any()):
                    continue
                xc = x[c * bm:(c + 1) * bm].double()
                p = xc[:, i0:i1].T @ xc[:, j0:j1]
                part = p if part is None else part + p
            if part is not None:
                s = s + part
        g[i0:i1, j0:j1] = s
    upper = torch.triu(torch.ones((n, n), dtype=torch.bool))
    return torch.where(upper, g, g.T)


def _blocky_card(rng, m, n, p_block, diagonal=False):
    """A matrix in the card's blocks (256 rows x 64 columns): blocks
    populated with probability `p_block`, or (`diagonal`) row chunk r
    populated in column tile r mod tiles only, so every chunk feeds one
    diagonal output tile and no off-diagonal one."""
    kr, kc = -(-m // tops.ROWS), -(-n // tops.TILE)
    if diagonal:
        keep = np.zeros((kr, kc), dtype=bool)
        keep[np.arange(kr), np.arange(kr) % kc] = True
    else:
        keep = rng.random((kr, kc)) < p_block
    dense = np.kron(keep, np.ones((tops.ROWS, tops.TILE)))[:m, :n]
    return rng.normal(size=(m, n)) * (rng.random((m, n)) < 0.3) * dense


@pytest.mark.parametrize("diagonal", [False, True])
@pytest.mark.parametrize("tile_n,rows", [(128, 256), (128, 512), (64, 768)])
def test_gram_bs_emulation_is_bitwise_under_an_all_ones_mask(rng, diagonal,
                                                             tile_n, rows):
    xn = _blocky_card(rng, 1700, 200, 0.4, diagonal)
    x = torch.from_numpy(xn)
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    got = _gram_split(x, mask, tile_n, rows)
    assert torch.equal(got, _gram_split(x, torch.ones_like(mask), tile_n,
                                        rows))
    assert torch.equal(got, got.mT)
    assert _rel(got, xn.T @ xn) <= F64_RTOL


@pytest.mark.parametrize("diagonal", [False, True])
def test_gram_bs_emulation_matches_reference_kernel(reference, rng,
                                                    diagonal):
    sops, _ = reference
    xn = _blocky_card(rng, 1024, 200, 0.4, diagonal).astype(np.float32)
    x = torch.from_numpy(xn)
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    got = _gram_split(x, mask, 128, 512)
    want = np.asarray(sops.gram_dense_masked(xn, bm=256, bn=64,
                                             interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# xtv_bs's plan and the summation orders of xtv_bs and spmm (csrc/spmm.cu)
# ---------------------------------------------------------------------------

def test_xtv_bs_plan_takes_no_mask():
    """The split plan is a function of (m, n, c, dtype, SM count) alone."""
    import inspect
    assert list(inspect.signature(tops.xtv_bs_plan).parameters) == [
        "m", "n", "c", "dtype", "sms"]
    assert tops.xtv_bs_plan(100_000, 1000, 1, torch.float64, 132) \
        != tops.xtv_bs_plan(100_000, 1000, 1, torch.float64, 16)


@pytest.mark.parametrize("m", [1, 255, 256, 6784, 32_768, 100_000, 400_000])
@pytest.mark.parametrize("n,c,dtype", [(1, 1, torch.float64),
                                       (64, 3, torch.float32),
                                       (1000, 1, torch.float64),
                                       (2000, 1, torch.bfloat16),
                                       (1000, 5, torch.float64)])
def test_xtv_bs_plan_covers_every_chunk_once(m, n, c, dtype):
    """Split s takes the 256-row chunks s, s + splits, ...: every chunk
    once, no split empty (at most one a chunk), within the grid's 65,535,
    as many as `_XTV_BS_WAVES` (mask tile, split) blocks per SM ask for
    where the rows allow it."""
    splits = tops.xtv_bs_plan(m, n, c, dtype, 132)
    tops.xtv_bs_plan.cache_clear()
    assert tops.xtv_bs_plan(m, n, c, dtype, 132) == splits  # shape-only
    chunks = -(-m // tops.ROWS)
    assert 1 <= splits <= min(chunks, 65_535)
    owner = [ch % splits for ch in range(chunks)]
    assert sorted(set(owner)) == list(range(splits))
    tiles = -(-n // tops.TILE)
    want = -(-tops._XTV_BS_WAVES * 132 // tiles)
    assert splits == min(chunks, want)


def _merge(parts):
    """The kernels' shuffle tree over a power-of-two list of lane sums:
    lane i adds lane i + off, off halving from len / 2; lane 0's sum."""
    parts = list(parts)
    off = len(parts) // 2
    while off:
        parts = [parts[i] + parts[i + off] for i in range(off)]
        off //= 2
    return parts[0]


def _xtv_bs_order(x, v, mask, splits, rpw):
    """The CUDA xtv_bs's summation order on the CPU, in float64: per split
    s (row chunks s, s + splits, ...), warp w and row slot `sub` (row
    group g of a chunk, RPW rows, to warp g % 8) accumulate their rows in
    ascending order, leaving out every (chunk, tile) block whose count is
    0; the RPW slots merge by the shuffle tree, the 8 warps in warp order,
    the splits by the xtv reduce's order (one split: its partial is the
    result)."""
    m, n = x.shape
    bm, bn = tops.ROWS, tops.TILE
    x, v = x.double(), v.double()
    keep = (mask > 0).repeat_interleave(bn, 1)[:, :n]  # (chunks, n)
    parts = []
    for s in range(splits):
        warps = []
        for w in range(8):
            subs = []
            for sub in range(rpw):
                acc = torch.zeros((n, v.shape[1]), dtype=torch.float64)
                for ch in range(s, -(-m // bm), splits):
                    for i in range(bm // (8 * rpw)):
                        r = ch * bm + (w + 8 * i) * rpw + sub
                        if r < m:
                            acc = torch.where(keep[ch][:, None],
                                              acc + x[r][:, None] * v[r],
                                              acc)
                subs.append(acc)
            warps.append(_merge(subs))
        part = warps[0]
        for w in warps[1:]:
            part = part + w
        parts.append(part)
    return _xtv_reduce_order(parts)


def _xtv_reduce_order(parts, group=16):
    """gram_mainloop.cuh's xtv reduce: groups of 16 consecutive splits,
    each summed in split order; warp w (of 8) adds groups w, w + 8, ... in
    order; the warps' sums in warp order."""
    groups = []
    for g0 in range(0, len(parts), group):
        gs = parts[g0]
        for p in parts[g0 + 1:g0 + group]:
            gs = gs + p
        groups.append(gs)
    warps = []
    for w in range(min(8, len(groups))):
        ws = groups[w]
        for g in groups[w + 8::8]:
            ws = ws + g
        warps.append(ws)
    total = warps[0]
    for ws in warps[1:]:
        total = total + ws
    return total


def _spmm_order(x, w, mask, p):
    """The CUDA spmm's summation order on the CPU, in float64, for P
    elements a 16-byte lane load (LPR = 64 / P lanes a 64-column tile):
    lane l of a row sums columns t * 64 + l P + e over the chunk's
    populated tiles t in ascending order and e = 0 .. P - 1; the LPR lanes
    merge by the shuffle tree."""
    m, k = x.shape
    bm, bn, lpr = tops.ROWS, tops.TILE, tops.TILE // p
    x, w = x.double(), w.double()
    y = torch.zeros((m, w.shape[1]), dtype=torch.float64)
    for ch in range(-(-m // bm)):
        xs = x[ch * bm:(ch + 1) * bm]
        lanes = torch.zeros((xs.shape[0], lpr, w.shape[1]),
                            dtype=torch.float64)
        for t in torch.nonzero(mask[ch] > 0).flatten().tolist():
            for e in range(p):
                cols = t * bn + torch.arange(lpr) * p + e
                ok = cols < k
                term = torch.zeros_like(lanes)
                term[:, ok] = xs[:, cols[ok], None] * w[cols[ok]]
                lanes = lanes + term
        y[ch * bm:(ch + 1) * bm] = _merge(lanes.unbind(1))
    return y


@pytest.mark.parametrize("rpw", [1, 2, 4])
@pytest.mark.parametrize("splits,c", [(1, 1), (3, 3), (7, 1)])
def test_xtv_bs_emulation_is_bitwise_under_an_all_ones_mask(rng, rpw, splits,
                                                            c):
    xn = _blocky_card(rng, 1700, 200, 0.4)
    x = torch.from_numpy(xn)
    v = torch.from_numpy(rng.normal(size=(1700, c)))
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    got = _xtv_bs_order(x, v, mask, splits, rpw)
    assert torch.equal(got, _xtv_bs_order(x, v, torch.ones_like(mask),
                                          splits, rpw))
    assert _rel(got, xn.T @ v.numpy()) <= F64_RTOL


@pytest.mark.parametrize("splits", [1, 5, 16, 17, 40, 200])
def test_xtv_reduce_order_is_split_order_within_a_group(rng, splits):
    """The xtv reduce sums up to 16 splits in split order (the order dense
    xtv's plans of at most 16 splits had), and any count within the limit
    of a float64 sum of the same partials."""
    parts = [torch.from_numpy(rng.normal(size=(5, 2))) for _ in range(splits)]
    got = _xtv_reduce_order(parts)
    seq = parts[0]
    for p in parts[1:]:
        seq = seq + p
    if splits <= 16:
        assert torch.equal(got, seq)
    assert _rel(got, sum(p.numpy() for p in parts)) <= F64_RTOL


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("c", [1, 3])
def test_spmm_emulation_is_bitwise_under_an_all_ones_mask(rng, p, c):
    xn = _blocky_card(rng, 1100, 230, 0.4)
    x = torch.from_numpy(xn)
    w = torch.from_numpy(rng.normal(size=(230, c)))
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    got = _spmm_order(x, w, mask, p)
    assert torch.equal(got, _spmm_order(x, w, torch.ones_like(mask), p))
    assert _rel(got, xn @ w.numpy()) <= F64_RTOL


def test_xtv_bs_and_spmm_emulations_match_reference_kernels(reference, rng):
    sops, _ = reference
    xn = _blocky_card(rng, 1024, 200, 0.4).astype(np.float32)
    vn = rng.normal(size=(1024, 1)).astype(np.float32)
    wn = rng.normal(size=(200, 2)).astype(np.float32)
    x = torch.from_numpy(xn)
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    got = _xtv_bs_order(x, torch.from_numpy(vn), mask, 2, 2)
    want = np.asarray(sops.xtv_dense_masked(xn, vn, bm=256, bn=64,
                                            interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    got = _spmm_order(x, torch.from_numpy(wn), mask, 4)
    want = np.asarray(sops.spmm_dense_masked(xn, wn, bm=256, bk=64,
                                             interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# two or more columns: the tile products (csrc/spmm.cu's xtv_bs_tile_kernel
# and spmm_tile_kernel), their plans and routes, the vmapped fold
# ---------------------------------------------------------------------------

def _xtv_bs_tile_order(x, v, mask, bn, splits, bk=16):
    """The CUDA xtv_bs_tile's algebra on the CPU, in float64: per output
    tile (128 columns of X, two mask tiles, against `bn` columns of v) and
    split s (row chunks s, s + splits, ...), the split's chunks in
    ascending order, a chunk skipped when both of the tile's mask tiles
    count 0 and a mask tile's columns of X read as zeros when its own
    does, each stage of `bk` rows added into the tile's sum as one
    product; the splits then summed in the xtv reduce's order."""
    um = 128
    m, n = x.shape
    c = v.shape[1]
    x, v = x.double(), v.double()
    parts = []
    for s in range(splits):
        part = torch.zeros((n, c), dtype=torch.float64)
        for c0 in range(0, n, um):
            t = c0 // tops.TILE
            for q0 in range(0, c, bn):
                acc = torch.zeros((min(um, n - c0), min(bn, c - q0)),
                                  dtype=torch.float64)
                for ch in range(s, -(-m // tops.ROWS), splits):
                    on = [t + q < mask.shape[1] and bool(mask[ch, t + q] > 0)
                          for q in range(um // tops.TILE)]
                    if not any(on):
                        continue
                    for r0 in range(ch * tops.ROWS,
                                    min(m, (ch + 1) * tops.ROWS), bk):
                        xs = x[r0:r0 + bk, c0:c0 + um].clone()
                        for q, q_on in enumerate(on):
                            if not q_on:
                                xs[:, 64 * q:64 * q + 64] = 0.0
                        acc = acc + xs.T @ v[r0:r0 + bk, q0:q0 + bn]
                part[c0:c0 + um, q0:q0 + bn] = acc
        parts.append(part)
    return _xtv_reduce_order(parts)


def _spmm_tile_order(x, w, mask, bk=16):
    """The CUDA spmm_tile's algebra on the CPU, in float64: per 128 rows
    of X (half a row chunk), the chunk's populated mask tiles in ascending
    order, each stage of `bk` of a tile's columns added into the rows' sum
    as one product; no split."""
    m, k = x.shape
    x, w = x.double(), w.double()
    y = torch.zeros((m, w.shape[1]), dtype=torch.float64)
    for r0 in range(0, m, 128):
        rows = slice(r0, min(m, r0 + 128))
        acc = torch.zeros((rows.stop - r0, w.shape[1]), dtype=torch.float64)
        for t in torch.nonzero(mask[r0 // tops.ROWS] > 0).flatten().tolist():
            for c0 in range(t * tops.TILE, min(k, (t + 1) * tops.TILE), bk):
                acc = acc + x[rows, c0:c0 + bk] @ w[c0:c0 + bk]
        y[rows] = acc
    return y


@pytest.mark.parametrize("bn,splits,c", [(16, 1, 2), (16, 3, 10), (80, 7, 40),
                                         (80, 2, 70), (128, 2, 70),
                                         (128, 4, 130)])
def test_xtv_bs_tile_emulation_is_bitwise_under_an_all_ones_mask(rng, bn,
                                                                 splits, c):
    xn = _blocky_card(rng, 1700, 300, 0.4)
    x = torch.from_numpy(xn)
    v = torch.from_numpy(rng.normal(size=(1700, c)))
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    got = _xtv_bs_tile_order(x, v, mask, bn, splits)
    assert torch.equal(got, _xtv_bs_tile_order(x, v, torch.ones_like(mask),
                                               bn, splits))
    assert _rel(got, xn.T @ v.numpy()) <= F64_RTOL


@pytest.mark.parametrize("bk", [16, 32, 64])
@pytest.mark.parametrize("c", [2, 10, 70])
def test_spmm_tile_emulation_is_bitwise_under_an_all_ones_mask(rng, bk, c):
    xn = _blocky_card(rng, 1100, 230, 0.4)
    x = torch.from_numpy(xn)
    w = torch.from_numpy(rng.normal(size=(230, c)))
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    got = _spmm_tile_order(x, w, mask, bk)
    assert torch.equal(got, _spmm_tile_order(x, w, torch.ones_like(mask), bk))
    assert _rel(got, xn @ w.numpy()) <= F64_RTOL


def test_tile_emulations_leave_out_a_block_whose_count_is_0(rng):
    """A populated block whose count is set to 0 is read as zeros (the
    kernels zero-fill its half of an X tile, or skip its stages): the
    product of X with that block zeroed, as the plain version gives."""
    xn = _blocky_card(rng, 1100, 230, 0.6)
    x = torch.from_numpy(xn)
    v, w = (torch.from_numpy(rng.normal(size=s)) for s in ((1100, 5),
                                                          (230, 5)))
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    nz = torch.nonzero(mask)
    cut = mask.clone()
    cut[tuple(nz[len(nz) // 2].tolist())] = 0
    args = (cut, tops.ROWS, tops.TILE)
    assert _rel(_xtv_bs_tile_order(x, v, cut, 16, 3),
                tref.xtv(x, v, *args)) <= F64_RTOL
    assert _rel(_spmm_tile_order(x, w, cut), tref.spmm(x, w, *args)) \
        <= F64_RTOL
    assert _rel(tref.xtv(x, v, *args), tref.xtv(x, v, mask, tops.ROWS,
                                                tops.TILE)) > 1e-6


@pytest.mark.parametrize("c", [2, 9])
def test_tile_emulations_match_reference_kernels(reference, rng, c):
    """The tile products' algebra against the reference's Pallas kernels
    (interpret mode) with v and W of two or more columns."""
    sops, _ = reference
    xn = _blocky_card(rng, 1024, 200, 0.4).astype(np.float32)
    vn = rng.normal(size=(1024, c)).astype(np.float32)
    wn = rng.normal(size=(200, c)).astype(np.float32)
    x = torch.from_numpy(xn)
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    got = _xtv_bs_tile_order(x, torch.from_numpy(vn), mask,
                             tops.tile_bn(c, torch.float32), 3)
    want = np.asarray(sops.xtv_dense_masked(xn, vn, bm=256, bn=64,
                                            interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    got = _spmm_tile_order(x, torch.from_numpy(wn), mask)
    want = np.asarray(sops.spmm_dense_masked(xn, wn, bm=256, bk=64,
                                             interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_tile_plans_take_no_mask():
    import inspect
    for fn in (tops.xtv_bs_tile_plan, tops.xtv_bs_route, tops.spmm_route):
        assert list(inspect.signature(fn).parameters) == [
            "m", *(["k"] if fn is tops.spmm_route else ["n"]), "c", "dtype",
            "sms"]


# (m, n, c) of the paths' multi-column launches and the card cases' odd
# shapes: mlogreg's 10 classes and the sparse grid's 70 λs at the lmds
# point, ragged c on the stream's 6,784-row tail, an offset slice, a long
# X whose splits hold many chunks
TILE_SHAPES = [(100_000, 1000, 10), (100_000, 1000, 70), (6784, 1000, 9),
               (6784, 1000, 129), (3000, 301, 5), (300, 12, 2),
               (1, 64, 3), (5_000_000, 40, 2), (2_000_000_000, 64, 16)]


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("m,n,c", TILE_SHAPES)
def test_xtv_bs_tile_plan(m, n, c, dtype, sms):
    """Every row chunk falls in exactly one split (strided: chunk ch in
    split ch % splits), no split is empty or holds more than the kernel's
    bitmap (`_BS_MAX_CHUNKS` chunks), splits stay within the grid's
    65,535; v's tiles are the least of 16, 80 (float64) and 128 that
    hold c, so X is read once for c up to 128; the plan asks for as many
    (tile, split) blocks as `_XTV_BS_TILE_WAVES` resident blocks an SM
    where the rows allow, and is a pure function of its arguments."""
    bn, splits = tops.xtv_bs_tile_plan(m, n, c, dtype, sms)
    assert tops.xtv_bs_tile_plan.__wrapped__(m, n, c, dtype, sms) == \
        (bn, splits)
    chunks = -(-m // tops.ROWS)
    assert 1 <= splits <= min(chunks, 65_535)
    assert -(-chunks // splits) <= tops._BS_MAX_CHUNKS
    if chunks < 1000:
        owner = [ch % splits for ch in range(chunks)]
        assert sorted(set(owner)) == list(range(splits))
    widths = (16, 80, 128) if dtype == torch.float64 else (16, 128)
    assert bn == next(b for b in widths if min(c, 128) <= b)
    assert (-(-c // bn) == 1) == (c <= 128)  # X read once up to 128
    tiles = -(-n // 128) * -(-c // bn)
    slots = tops._XTV_BS_TILE_WAVES * sms * tops.xtv_bs_blocks_per_sm(bn,
                                                                      dtype)
    if chunks <= 65_535 * 8 and splits < chunks:
        assert splits == max(-(-slots // tiles),
                             -(-chunks // tops._BS_MAX_CHUNKS))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("m,n,c", TILE_SHAPES + [(100_000, 1000, 1),
                                                 (6784, 1000, 1)])
def test_sparse_routes_by_columns(m, n, c, dtype):
    """One column takes the GEMV kernels under their plan; from
    `_TILE_CUT` (2) columns the tile products under theirs."""
    xr = tops.xtv_bs_route(m, n, c, dtype, 132)
    sr = tops.spmm_route(m, n, c, dtype, 132)
    assert tops._TILE_CUT == 2
    if c == 1:
        assert xr == ("gemv", tops.xtv_bs_plan(m, n, c, dtype, 132))
        assert sr == ("gemv",)
    else:
        assert xr == ("tile",) + tops.xtv_bs_tile_plan(m, n, c, dtype, 132)
        assert sr == ("tile", tops.tile_bn(c, dtype))
    assert tops.xtv_bs_route.__wrapped__(m, n, c, dtype, 132) == xr
    assert tops.spmm_route.__wrapped__(m, n, c, dtype, 132) == sr


@pytest.mark.parametrize("kind", ["spmm", "xtv_bs"])
@pytest.mark.parametrize("c", [1, 2])
def test_vmapped_masked_ops_match_reference(reference, rng, kind, c):
    """`spmm_masked_op` / `xtv_masked_op` under torch.func.vmap over a
    batch of w with one sparse X (a λ grid's fold) on the CPU against the
    reference's masked products under jax.vmap with the Pallas kernels in
    interpret mode, float32."""
    import functools
    import jax
    import jax.numpy as jnp
    sops, _ = reference
    k, m, n = 3, 512, 130
    xn = _blocky_card(rng, m, n, 0.5).astype(np.float32)
    wn = rng.normal(size=(k, n if kind == "spmm" else m, c)).astype(
        np.float32)
    x = torch.from_numpy(xn)
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    op = tops.spmm_masked_op if kind == "spmm" else tops.xtv_masked_op
    got = torch.func.vmap(op, in_dims=(None, 0, None))(
        x, torch.from_numpy(wn), mask)
    ref_fn = sops.spmm_dense_masked if kind == "spmm" else \
        sops.xtv_dense_masked
    kw = dict(bm=256, bk=64) if kind == "spmm" else dict(bm=256, bn=64)
    want = jax.vmap(functools.partial(ref_fn, interpret=True, **kw),
                    in_axes=(None, 0))(jnp.asarray(xn), jnp.asarray(wn))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("kind", ["spmm", "xtv_bs"])
@pytest.mark.parametrize("k,c", [(70, 1), (3, 4), (1, 1)])
def test_folded_masked_ops_count_on_meta_as_on_the_card(kind, k, c):
    """The masked ops under vmap on "meta": the kernel's work for k·c
    columns and no other op (the tile products read the batch in place;
    a one-column fold's w is a view), and the card's output shape."""
    from repro_torch.launch import hlocost, kernel_model
    m, n, dt = 600, 130, torch.float64
    x = torch.empty((m, n), dtype=dt, device="meta")
    w = torch.empty((k, n if kind == "spmm" else m, c), dtype=dt,
                    device="meta")
    mask = torch.empty((-(-m // tops.ROWS), -(-n // tops.TILE)),
                       dtype=torch.int32, device="meta")
    op = tops.spmm_masked_op if kind == "spmm" else tops.xtv_masked_op
    fn = torch.func.vmap(op, in_dims=(None, 0, None))
    t = hlocost.count(fn, x, w, mask)
    work = (kernel_model.spmm_work if kind == "spmm" else
            kernel_model.xtv_bs_work)(mask, m, n, k * c, dt)
    assert (t.flops, t.bytes) == work
    assert set(t.by_op) == {kind} and t.by_op[kind][0] == 1
    out = fn(x, w, mask)
    assert out.shape == (k, m if kind == "spmm" else n, c)


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
    # one column: the GEMV kernels; two or more: the tile products
    xk, sk = ("xtv_bs", "spmm") if c == 1 else ("xtv_bs_tile", "spmm_tile")
    for k in ("gram_bs", "gram_bs_reduce", xk, sk):
        assert tops.LAUNCHES[k] == before[k] + 1
    route = tops.xtv_bs_route(m, n, c, dtype, tops._sm_count(x.device))
    assert tops.LAUNCHES[f"{xk}_reduce"] == before[f"{xk}_reduce"] \
        + (route[-1] > 1)
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
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("case", ["diagonal", "slice", "narrow", "tall"])
def test_cuda_gram_bs_paths_match_plain_version(cuda_device, monkeypatch,
                                               dtype, case):
    """gram_bs's redesigned paths: every chunk feeding one diagonal tile
    only, a column slice at an odd offset (element copies), 128 x 64 tiles
    (n <= 64), and splits of 66 chunks (more than one 32-chunk word of
    populated bits: the plan asked for one item per resident block)."""
    rng = np.random.default_rng(2)
    if case == "diagonal":
        xn = _blocky_card(rng, 20_000, 1000, 0.0, diagonal=True)
    elif case == "slice":
        xn = _blocky(rng, 6000, 302, 1024, 128, 0.3, 0.2)
    elif case == "narrow":
        xn = _blocky(rng, 9000, 50, 1024, 16, 0.3, 0.2)
    else:
        monkeypatch.setattr(tops, "_BS_WAVES", dict.fromkeys(
            tops._BS_WAVES, 1))
        tops.gram_bs_plan.cache_clear()
        xn = _blocky(rng, 150_000, 640, 1024, 64, 0.3, 0.2)
    x = torch.from_numpy(xn).to(cuda_device, dtype)
    if case == "slice":
        x = x[:, 1:]
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    g = tops.gram_bs_cuda(x, mask)
    want = tref.gram(x, mask, tops.ROWS, tops.TILE)
    assert gram_ref.scaled_err(g, want, x, x) <= KERNEL_TOL[dtype]
    assert torch.equal(g, g.mT)
    assert torch.equal(g, tops.gram_bs_cuda(x, torch.ones_like(mask)))
    if case == "tall":
        assert tops.gram_bs_plan(*x.shape, x.dtype, tops._sm_count(
            x.device))[2] == 66 * tops.ROWS
        tops.gram_bs_plan.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("case,c", [("tail", 1), ("tail", 3), ("tail", 5),
                                    ("slice", 1), ("slice", 3), ("odd", 1),
                                    ("odd", 5)])
def test_cuda_xtv_bs_and_spmm_paths_match_plain_version(cuda_device, dtype,
                                                       case, c):
    """xtv_bs and spmm at c = 1 (the GEMV kernels), 3 and 5 (the tile
    products), on the 6,784-row stream tail (a 128-row last chunk, a
    40-column last tile), a column slice at offset 1 and an odd width
    (element loads: 8-byte-aligned rows); each within the limit of its
    plain version, bitwise against an all-ones mask and a second call,
    and with one populated block's count set to 0, against the plain
    version with that block left out."""
    rng = np.random.default_rng(3)
    if case == "tail":
        xn = _blocky(rng, 6784, 1000, 1024, 128, 0.25, 0.2)
    elif case == "slice":
        xn = _blocky(rng, 3000, 302, 1024, 128, 0.3, 0.2)
    else:
        xn = _blocky(rng, 3000, 1001, 1024, 128, 0.3, 0.2)
    x = torch.from_numpy(xn).to(cuda_device, dtype)
    if case == "slice":
        x = x[:, 1:]
    m, n = x.shape
    assert tops.aligned16(x) == (case == "tail")
    v = torch.from_numpy(rng.normal(size=(m, c))).to(cuda_device, dtype)
    w = torch.from_numpy(rng.normal(size=(n, c))).to(cuda_device, dtype)
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    cut = mask.clone()
    nz = torch.nonzero(mask)
    cut[tuple(nz[len(nz) // 2].tolist())] = 0  # a populated block left out
    tol = KERNEL_TOL[dtype]
    args = (tops.ROWS, tops.TILE)
    for mk in (mask, cut):
        xv = tops.xtv_bs_cuda(x, v, mk)
        y = tops.spmm_cuda(x, w, mk)
        assert gram_ref.scaled_err(xv, tref.xtv(x, v, mk, *args), x, v) <= tol
        assert gram_ref.scaled_err(y, tref.spmm(x, w, mk, *args), x.mT,
                                   w) <= tol
    xv, y = tops.xtv_bs_cuda(x, v, mask), tops.spmm_cuda(x, w, mask)
    ones = torch.ones_like(mask)
    assert torch.equal(xv, tops.xtv_bs_cuda(x, v, ones))
    assert torch.equal(xv, tops.xtv_bs_cuda(x, v, mask))
    assert torch.equal(y, tops.spmm_cuda(x, w, ones))
    assert torch.equal(y, tops.spmm_cuda(x, w, mask))


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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["spmm", "xtv_bs"])
def test_cuda_sparse_fold_rules_launch_once(cuda_device, kind):
    """The masked ops under torch.func.vmap on the card (a sparse grid's
    X @ β over 70 λs): one launch of the tile product over the folded
    k·c columns (each β read in place), each element within the kernel
    limit of a lone call and of the plain version computed in float64,
    bitwise repeatable."""
    rng = np.random.default_rng(5)
    k, m, n = 70, 20_000, 1000
    x = torch.from_numpy(_blocky(rng, m, n, 1024, 128, 0.25, 0.2)).to(
        cuda_device)
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    rows = n if kind == "spmm" else m
    w = torch.from_numpy(rng.normal(size=(k, rows, 1))).to(cuda_device)
    op, lone, plain = ((tops.spmm_masked_op, tops.spmm_cuda, tref.spmm)
                       if kind == "spmm" else
                       (tops.xtv_masked_op, tops.xtv_bs_cuda, tref.xtv))
    fn = torch.func.vmap(op, in_dims=(None, 0, None))
    before = dict(tops.LAUNCHES)
    got = fn(x, w, mask)
    torch.cuda.synchronize()
    assert tops.LAUNCHES[f"{kind}_tile"] == before[f"{kind}_tile"] + 1
    assert tops.LAUNCHES[kind] == before[kind]
    a = x.mT if kind == "spmm" else x
    tol = KERNEL_TOL[torch.float64]
    for b in range(k):
        assert gram_ref.scaled_err(got[b], lone(x, w[b], mask), a,
                                   w[b]) <= tol
        assert gram_ref.scaled_err(got[b], plain(x, w[b], mask, tops.ROWS,
                                                 tops.TILE), a, w[b]) <= tol
    assert torch.equal(got, fn(x, w, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("m,n,c,offset", [
    pytest.param(20_000, 1000, 10, 0, id="mlogreg-like-20000-1000-10"),
    pytest.param(20_000, 1000, 70, 0, id="fold-width-20000-1000-70"),
    pytest.param(6784, 1000, 9, 0, id="tail-c9"),
    pytest.param(6784, 1000, 129, 0, id="tail-c129"),
    pytest.param(6784, 1000, 9, 1, id="tail-offset1-c9"),
    pytest.param(3001, 301, 2, 3, id="ragged-offset3-c2"),
    pytest.param(100, 70, 17, 0, id="one-chunk-c17"),
    pytest.param(513, 64, 64, 0, id="one-tile-c64"),
])
def test_cuda_tile_products_match_plain_version(cuda_device, m, n, c, offset,
                                                dtype):
    """Two or more columns on the tile products: ragged m, n and c, column
    slices at odd offsets (element copies of X), every dtype; each within
    the kernel limit of the plain version (the same dtype's, and float64's),
    bitwise against an all-ones mask and on repeat, one launch of the tile
    product (and its reduce past one split) and none of the GEMV kernels."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(7)
    xn = _blocky(rng, m, n + offset, 1024, 128, 0.3, 0.2)
    x = torch.from_numpy(xn).to(cuda_device, dtype)[:, offset:]
    v = torch.from_numpy(rng.normal(size=(m, c))).to(cuda_device, dtype)
    w = torch.from_numpy(rng.normal(size=(n, c))).to(cuda_device, dtype)
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    ones = torch.ones_like(mask)
    args = (mask, tops.ROWS, tops.TILE)
    tol = KERNEL_TOL[dtype]
    before = dict(tops.LAUNCHES)
    xv, y = tops.xtv_bs_cuda(x, v, mask), tops.spmm_cuda(x, w, mask)
    torch.cuda.synchronize()
    route = tops.xtv_bs_route(m, n, c, dtype, tops._sm_count(x.device))
    assert route[0] == "tile"
    assert tops.LAUNCHES["xtv_bs_tile"] == before["xtv_bs_tile"] + 1
    assert tops.LAUNCHES["xtv_bs_tile_reduce"] == \
        before["xtv_bs_tile_reduce"] + (route[-1] > 1)
    assert tops.LAUNCHES["spmm_tile"] == before["spmm_tile"] + 1
    assert tops.LAUNCHES["xtv_bs"] == before["xtv_bs"]
    assert tops.LAUNCHES["spmm"] == before["spmm"]
    assert xv.dtype == gram_ref.acc_dtype(dtype) and xv.shape == (n, c)
    assert y.dtype == gram_ref.acc_dtype(dtype) and y.shape == (m, c)
    for want_x, want_y in ((tref.xtv(x, v, *args), tref.spmm(x, w, *args)),
                           (tref.xtv(x.double(), v.double(), *args),
                            tref.spmm(x.double(), w.double(), *args))):
        assert gram_ref.scaled_err(xv, want_x, x, v) <= tol
        assert gram_ref.scaled_err(y, want_y, x.mT, w) <= tol
    assert torch.equal(xv, tops.xtv_bs_cuda(x, v, ones))
    assert torch.equal(xv, tops.xtv_bs_cuda(x, v, mask))
    assert torch.equal(y, tops.spmm_cuda(x, w, ones))
    assert torch.equal(y, tops.spmm_cuda(x, w, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["spmm", "xtv_bs"])
@pytest.mark.parametrize("k,c", [(3, 4), (8, 10)])
def test_cuda_folds_of_several_columns(cuda_device, kind, k, c):
    """The vmapped fold with c >= 2 columns an element (v's groups read in
    place by 16-byte copies): one tile launch, each element within the
    kernel limit of a lone call, bitwise on repeat."""
    rng = np.random.default_rng(8)
    m, n = 5000, 300
    x = torch.from_numpy(_blocky(rng, m, n, 1024, 128, 0.3, 0.2)).to(
        cuda_device)
    mask = tref.block_mask(x, tops.ROWS, tops.TILE)
    w = torch.from_numpy(rng.normal(size=(k, n if kind == "spmm" else m,
                                          c))).to(cuda_device)
    op, lone = ((tops.spmm_masked_op, tops.spmm_cuda) if kind == "spmm" else
                (tops.xtv_masked_op, tops.xtv_bs_cuda))
    fn = torch.func.vmap(op, in_dims=(None, 0, None))
    before = dict(tops.LAUNCHES)
    got = fn(x, w, mask)
    torch.cuda.synchronize()
    assert tops.LAUNCHES[f"{kind}_tile"] == before[f"{kind}_tile"] + 1
    a = x.mT if kind == "spmm" else x
    for b in range(k):
        assert gram_ref.scaled_err(got[b], lone(x, w[b], mask), a, w[b]) \
            <= KERNEL_TOL[torch.float64]
    assert torch.equal(got, fn(x, w, mask))
