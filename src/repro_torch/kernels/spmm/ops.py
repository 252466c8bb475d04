"""Dispatching wrappers for the block-sparse gram / SpMM / xtv family.

These are the kernels behind the `bcoo` physical format in
`repro_torch.core.backend` (port of `repro.kernels.spmm.ops`):

  * `gram_bcoo`, `xtv_bcoo`, `matmul_bcoo` take a `BCOO` X: each densifies
    it on its device, counts the nonzeros of every (row chunk, column tile)
    block from the indices (`block_mask_from_indices`) and runs the masked
    product over the dense layout;
  * `*_dense_masked` run that product: on a CUDA tensor the hand-written
    sm_90a kernels of `repro_torch/csrc/spmm.cu` (through the `*_cuda`
    entry points, raising on anything they do not take; there is no
    fallback), on a CPU tensor the plain torch version in `ref`.

The blocks are the card's (`ROWS` x `TILE`, the kernels' row chunk and
gram tile edge), not the TPU's (512, 256), and nothing is padded. Each
CUDA wrapper counts its launches in `LAUNCHES`, one count per kernel pass
it launches (the reduce passes apart).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch

from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.gram.ops import (_DTYPE_CODE, _MAX_SPLITS, _BM,
                                          _check_matrix, _check_rc, _on,
                                          _raw_stream, _sm_count, _workspace,
                                          aligned16, gram_tiles)

from . import ref

# One count per launched kernel pass; reset with `reset_launches()`.
LAUNCHES = {"gram_bs": 0, "gram_bs_reduce": 0, "spmm": 0, "xtv_bs": 0,
            "xtv_bs_reduce": 0}

ROWS = 256   # rows per mask chunk (RC in spmm.cu)
TILE = 64    # columns per mask tile (TILE in spmm.cu)
_lib = None

# gram_bs's plan: (tile, split) items to aim for per resident block (one a
# SM), by dtype, so that the card's in-order hand-out of items, longest
# class first, balances the populated work (a bf16 item is ~4x shorter,
# so its per-item costs weigh more: fewer items; PERF.md §6 sweeps);
# the most row chunks a split may hold (MAX_CHUNKS in spmm.cu)
_BS_WAVES = {torch.float64: 24, torch.float32: 24, torch.bfloat16: 8}
_BS_MAX_CHUNKS = 8192

# xtv_bs's plan: the (mask tile, split) blocks to aim for per SM (PERF.md
# §6 sweeps 4-32)
_XTV_BS_WAVES = 16


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import library
        lib = library("spmm")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_gram_bs.argtypes = [i32, i32, i32, p, i64, i64, i64, p,
                                      i64, i64, i32, p, p, p, p]
        lib.repro_xtv_bs.argtypes = [i32, i32, p, p, i64, i64, i64, i64, i64,
                                     p, i64, i32, p, p, p]
        lib.repro_spmm.argtypes = [i32, i32, p, p, i64, i64, i64, i64, i64,
                                   p, i64, p, p]
        lib.repro_spmm_row_chunk.argtypes = []
        lib.repro_spmm_col_tile.argtypes = []
        lib.repro_spmm_max_chunks.argtypes = []
        for fn in (lib.repro_gram_bs, lib.repro_xtv_bs, lib.repro_spmm,
                   lib.repro_spmm_row_chunk,
                   lib.repro_spmm_col_tile, lib.repro_spmm_max_chunks):
            fn.restype = ctypes.c_int
        if (lib.repro_spmm_row_chunk(), lib.repro_spmm_col_tile(),
                lib.repro_spmm_max_chunks()) \
                != (ROWS, TILE, _BS_MAX_CHUNKS):
            raise RuntimeError("spmm.cu's mask blocks differ from ops.py's")
        _lib = lib
    return _lib


def block_mask_from_indices(x, bm: int = ROWS,
                            bn: int = TILE) -> torch.Tensor:
    """int32 (ceil(m/bm), ceil(n/bn)) count of the nonzeros of BCOO `x` in
    each block, from its indices on its device. Entries whose value is 0
    (the nse padding) are not counted, so the mask equals the dense
    matrix's block counts exactly."""
    m, n = x.shape
    kr, kc = -(-m // bm), -(-n // bn)
    idx = x.indices[x.data != 0].long()
    flat = (idx[:, 0] // bm) * kc + idx[:, 1] // bn
    return torch.bincount(flat, minlength=kr * kc).view(kr, kc).to(
        torch.int32)


def _check_mask(mask: torch.Tensor, m: int, n: int, x: torch.Tensor,
                what: str) -> None:
    want = (-(-m // ROWS), -(-n // TILE))
    if mask.dtype != torch.int32 or tuple(mask.shape) != want \
            or mask.device != x.device or not mask.is_contiguous():
        raise ValueError(f"{what}: mask must be a contiguous int32 {want} "
                         f"tensor on {x.device}, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")


def _check_pair(x: torch.Tensor, v: torch.Tensor, what: str) -> None:
    _check_matrix(v, what)
    if v.dtype != x.dtype or v.device != x.device:
        raise TypeError(f"{what}: x is {x.dtype} on {x.device}, the other "
                        f"operand {v.dtype} on {v.device}")


@lru_cache(maxsize=1024)
def gram_bs_plan(m: int, n: int, dtype: torch.dtype,
                 sms: int) -> tuple[int, int, int]:
    """(tile_n, splits, rows per split) of gram_bs on a card with `sms`
    SMs: a function of the shape, the dtype and the card, never of the
    mask, so a run with the true mask and one with an all-ones mask sum
    the same partials in the same order. 128 x 128 tiles (128 x 64 at
    n <= 64, as gram's); enough splits of whole row chunks for
    `_BS_WAVES[dtype]` items (tile, split) per resident block, each split
    at most `_BS_MAX_CHUNKS` chunks. Many short items balance the uneven populated work: the card
    hands them out diagonal tiles first, and an item none of whose chunks
    is populated ends after its mask reads and writes no partial."""
    tile_n = 64 if n <= 64 else gram_ops.GRAM_TILE_N
    want = -(-_BS_WAVES[dtype] * sms // gram_tiles(n, tile_n))
    chunks = min(-(-m // (ROWS * want)), _BS_MAX_CHUNKS)
    rows = chunks * ROWS
    return tile_n, -(-m // rows), rows


@lru_cache(maxsize=1024)
def xtv_bs_plan(m: int, n: int, c: int, dtype: torch.dtype, sms: int) -> int:
    """Splits of xtv_bs on a card with `sms` SMs: a function of the
    shape, the dtype and the card, never of the mask, so a run with the
    true mask and one with an all-ones mask sum the same partials in the
    same order. Split s takes row chunks s, s + splits, s + 2 splits, ...
    (strided, so every split samples the whole of X and the blocks'
    populated work evens out); enough splits for `_XTV_BS_WAVES` (mask
    tile, split) blocks per SM, at most one a chunk and the grid's 65,535.
    (v's width `c` and the dtype are part of the key; a block covers one
    mask tile in every dtype and the XC-column passes `c` sets do not
    change the split count.)"""
    chunks = -(-m // ROWS)
    want = -(-_XTV_BS_WAVES * sms // -(-n // TILE))
    return max(1, min(chunks, want, _MAX_SPLITS))


def gram_bs_cuda(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """G = XᵀX on the card, skipping masked blocks (replaces
    `gram_block_sparse`): the partial pass over the plan's items and the
    reduce pass of the filled partials, one host call."""
    _check_matrix(x, "gram_bs")
    m, n = x.shape
    _check_mask(mask, m, n, x, "gram_bs")
    dev = x.device
    acc = gram_ref.acc_dtype(x.dtype)
    out = x.new_empty((n, n), dtype=acc)
    if m == 0 or n == 0:
        return out.zero_()
    tile_n, splits, rows = gram_bs_plan(m, n, x.dtype, _sm_count(dev))
    tiles = gram_tiles(n, tile_n)
    part = splits * tiles * _BM * tile_n * acc.itemsize
    lib = _library()
    with _on(dev):
        st = _raw_stream(dev)
        # the partials, then filled ([tiles, splits] int32)
        ws = _workspace(dev, st, part + 4 * tiles * splits)
        _check_rc(lib.repro_gram_bs(
            _DTYPE_CODE[x.dtype], tile_n, aligned16(x), x.data_ptr(), m, n,
            x.stride(0), mask.data_ptr(), mask.shape[1], rows, splits,
            ws.data_ptr(), ws.data_ptr() + part, out.data_ptr(), st),
            "gram_bs")
    LAUNCHES["gram_bs"] += 1
    LAUNCHES["gram_bs_reduce"] += 1
    return out


def xtv_bs_cuda(x: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Xᵀv on the card for a 2-D v, skipping masked blocks of X (replaces
    `xtv_block_sparse`): the partial pass over the plan's splits and, past
    one split, the reduce pass, one host call."""
    _check_matrix(x, "xtv_bs")
    _check_pair(x, v, "xtv_bs")
    m, n = x.shape
    if v.shape[0] != m:
        raise ValueError(f"xtv_bs: rows differ, {tuple(x.shape)} vs "
                         f"{tuple(v.shape)}")
    _check_mask(mask, m, n, x, "xtv_bs")
    c = v.shape[1]
    dev = x.device
    acc = gram_ref.acc_dtype(x.dtype)
    out = x.new_empty((n, c), dtype=acc)
    if m == 0 or n == 0 or c == 0:
        return out.zero_()
    splits = xtv_bs_plan(m, n, c, x.dtype, _sm_count(dev))
    lib = _library()
    with _on(dev):
        st = _raw_stream(dev)
        # one split writes the output itself: no reduce pass
        ws = out if splits == 1 else \
            _workspace(dev, st, splits * n * c * acc.itemsize)
        _check_rc(lib.repro_xtv_bs(
            _DTYPE_CODE[x.dtype], aligned16(x), x.data_ptr(), v.data_ptr(),
            m, n, c, x.stride(0), v.stride(0), mask.data_ptr(),
            mask.shape[1], splits, ws.data_ptr(), out.data_ptr(), st),
            "xtv_bs")
    LAUNCHES["xtv_bs"] += 1
    if splits > 1:
        LAUNCHES["xtv_bs_reduce"] += 1
    return out


def spmm_cuda(x: torch.Tensor, w: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Y = X @ W on the card for a 2-D W, skipping masked blocks of X
    (replaces `spmm_block_sparse`)."""
    _check_matrix(x, "spmm")
    _check_pair(x, w, "spmm")
    m, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"spmm: inner sizes differ, {tuple(x.shape)} @ "
                         f"{tuple(w.shape)}")
    _check_mask(mask, m, k, x, "spmm")
    c = w.shape[1]
    dev = x.device
    acc = gram_ref.acc_dtype(x.dtype)
    out = x.new_empty((m, c), dtype=acc)
    if m == 0 or c == 0:
        return out
    if k == 0:
        return out.zero_()
    lib = _library()
    with _on(dev):
        _check_rc(lib.repro_spmm(
            _DTYPE_CODE[x.dtype], aligned16(x), x.data_ptr(), w.data_ptr(),
            m, k, c, x.stride(0), w.stride(0), mask.data_ptr(),
            mask.shape[1], out.data_ptr(), _raw_stream(dev)), "spmm")
    LAUNCHES["spmm"] += 1
    return out


# -- dense layout + mask -----------------------------------------------------

def _cuda_blocks(bm: int, bn: int, what: str) -> None:
    if (bm, bn) != (ROWS, TILE):
        raise ValueError(f"{what}: the CUDA kernels take {ROWS} x {TILE} "
                         f"blocks, not {bm} x {bn}")


def gram_dense_masked(xd: torch.Tensor, mask: Optional[torch.Tensor] = None,
                      bm: int = ROWS, bn: int = TILE) -> torch.Tensor:
    """Block-masked XᵀX over a dense-layout X (mask from the dense values
    when not given)."""
    if mask is None:
        mask = ref.block_mask(xd, bm, bn)
    if xd.device.type == "cpu":
        return ref.gram(xd, mask, bm, bn)
    _cuda_blocks(bm, bn, "gram_bs")
    return gram_bs_cuda(xd, mask)


def spmm_dense_masked(xd: torch.Tensor, w: torch.Tensor,
                      mask: Optional[torch.Tensor] = None, bm: int = ROWS,
                      bk: int = TILE) -> torch.Tensor:
    """Block-masked X @ W over a dense-layout X."""
    if mask is None:
        mask = ref.block_mask(xd, bm, bk)
    if xd.device.type == "cpu":
        return ref.spmm(xd, w, mask, bm, bk)
    _cuda_blocks(bm, bk, "spmm")
    return spmm_cuda(xd, w, mask)


def xtv_dense_masked(xd: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, bm: int = ROWS,
                     bn: int = TILE) -> torch.Tensor:
    """Block-masked Xᵀv over a dense-layout X."""
    if mask is None:
        mask = ref.block_mask(xd, bm, bn)
    if xd.device.type == "cpu":
        return ref.xtv(xd, v, mask, bm, bn)
    _cuda_blocks(bm, bn, "xtv_bs")
    return xtv_bs_cuda(xd, v, mask)


# -- BCOO entry points (the backend's bcoo-format kernels) -------------------

def _operand(x: torch.Tensor, v: torch.Tensor):
    """`v` in X's promoted dtype, 2-D (a 1-D v as one column) with
    contiguous rows; returns (x, v, squeeze)."""
    dt = torch.promote_types(x.dtype, v.dtype)
    x, v = x.to(dt), v.to(dt)
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    elif v.shape[1] > 1 and v.stride(1) != 1:
        v = v.contiguous()
    return x, v, squeeze


def gram_bcoo(x) -> torch.Tensor:
    """G = XᵀX for a BCOO X."""
    return gram_dense_masked(x.todense(), block_mask_from_indices(x))


def xtv_bcoo(x, v: torch.Tensor) -> torch.Tensor:
    """Xᵀv for a BCOO X and dense v; a 1-D v gives a 1-D result."""
    xd, v, squeeze = _operand(x.todense(), v)
    out = xtv_dense_masked(xd, v, block_mask_from_indices(x))
    return out[:, 0] if squeeze else out


def matmul_bcoo(a, b: torch.Tensor) -> torch.Tensor:
    """A @ B for a BCOO A and dense B; a 1-D B gives a 1-D result."""
    ad, b, squeeze = _operand(a.todense(), b)
    out = spmm_dense_masked(ad, b, block_mask_from_indices(a))
    return out[:, 0] if squeeze else out
