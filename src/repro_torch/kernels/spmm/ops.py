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
    fallback), on a CPU tensor the plain torch version in `ref`, on a
    "meta" tensor the kernel's output shape with its work charged
    (`*_meta`).

Which kernel takes a product of X with v or W of c columns is a pure
function of the shape, the dtype and the card (`xtv_bs_route`,
`spmm_route`): one column (the lmCG and lmDS paths) takes the GEMV
kernels (`xtv_bs_partial_kernel`, `spmm_kernel`); two or more (a λ
grid's fold, mlogreg's classes) the tile products on the tensor cores
(`xtv_bs_tile_kernel`, `spmm_tile_kernel`), which read X once for c up
to 128.

The blocks are the card's (`ROWS` x `TILE`, the kernels' row chunk and
gram tile edge), not the TPU's (512, 256), and nothing is padded. Each
CUDA wrapper counts its launches in `LAUNCHES`, one count per kernel pass
it launches, under the kernel's name (`spmm` and `xtv_bs` the GEMV
kernels, `spmm_tile` and `xtv_bs_tile` the tile products; the reduce
passes apart). The CUDA wrappers and the meta
implementations charge the kernel's work over the populated blocks
(`launch.kernel_model`) to an active `launch.hlocost` counter, which
cannot see a `ctypes` launch (a meta mask holds no data: every block
counts).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional

import torch

from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.launch import hlocost, kernel_model
from repro_torch.kernels.gram import ref as gram_ref
from repro_torch.kernels.gram.ops import (_DTYPE_CODE, _MAX_SPLITS, _BM,
                                          _check_matrix, _check_rc, _on,
                                          _raw_stream, _sm_count, _vec16,
                                          _workspace, aligned16, gram_tiles)

from . import ref

# One count per launched kernel pass; reset with `reset_launches()`.
LAUNCHES = {"gram_bs": 0, "gram_bs_reduce": 0, "spmm": 0, "spmm_tile": 0,
            "xtv_bs": 0, "xtv_bs_reduce": 0, "xtv_bs_tile": 0,
            "xtv_bs_tile_reduce": 0}

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

# the tile products (two or more columns): the least c they take (the GEMV
# kernels take one column only), the narrow operand's tile widths by dtype
# (a tile computes no fragment past its columns; spmm.cu's `f64_wide` says
# how float64's 80-column tiles differ), X's 128-column tiles in
# xtv_bs_tile, and its (tile, split) blocks to aim for per resident block
_TILE_CUT = 2
_TILE_BN = {torch.float64: (16, 80, 128), torch.float32: (16, 128),
            torch.bfloat16: (16, 128)}
_XT_BM = 128
_XTV_BS_TILE_WAVES = 4


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
        lib.repro_xtv_bs.argtypes = [i32, i32, p, p, i64, i64, i64, i64, p,
                                     i64, i32, p, p, p]
        lib.repro_spmm.argtypes = [i32, i32, p, p, i64, i64, i64, i64, p,
                                   i64, p, p]
        lib.repro_xtv_bs_tile.argtypes = [i32, i32, p, i64, i64, i64, i32, p,
                                          i64, i64, i64, i32, i64, p, i64,
                                          i32, p, p, p]
        lib.repro_spmm_tile.argtypes = [i32, i32, p, i64, i64, i64, i32, p,
                                        i64, i64, i64, i32, i64, p, i64, p,
                                        p]
        lib.repro_spmm_row_chunk.argtypes = []
        lib.repro_spmm_col_tile.argtypes = []
        lib.repro_spmm_max_chunks.argtypes = []
        for fn in (lib.repro_gram_bs, lib.repro_xtv_bs, lib.repro_spmm,
                   lib.repro_xtv_bs_tile, lib.repro_spmm_tile,
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
    """Splits of the one-column xtv_bs kernel on a card with `sms` SMs: a
    function of the shape, the dtype and the card, never of the mask, so
    a run with the true mask and one with an all-ones mask sum the same
    partials in the same order. Split s takes row chunks s, s + splits,
    s + 2 splits, ... (strided, so every split samples the whole of X and
    the blocks' populated work evens out); enough splits for
    `_XTV_BS_WAVES` (mask tile, split) blocks per SM, at most one a chunk
    and the grid's 65,535. (v's width `c` and the dtype are part of the
    key; a block covers one mask tile in every dtype.)"""
    chunks = -(-m // ROWS)
    want = -(-_XTV_BS_WAVES * sms // -(-n // TILE))
    return max(1, min(chunks, want, _MAX_SPLITS))


def tile_bn(c: int, dtype: torch.dtype) -> int:
    """The narrow operand's tile width in the tile products: the least of
    `_TILE_BN[dtype]` that holds its `c` columns (128 tiles beyond 128)."""
    widths = _TILE_BN[dtype]
    return next((b for b in widths if c <= b), widths[-1])


def xtv_bs_blocks_per_sm(bn: int, dtype: torch.dtype) -> int:
    """Resident blocks an SM of xtv_bs_tile (`tile_min_blocks` in
    spmm.cu): one at bn 128, else two (float64's 80 columns: blocks of 4
    warps)."""
    return 1 if bn == 128 else 2


@lru_cache(maxsize=1024)
def xtv_bs_tile_plan(m: int, n: int, c: int, dtype: torch.dtype,
                     sms: int) -> tuple[int, int]:
    """(bn, splits) of xtv_bs_tile on a card with `sms` SMs, a function of
    the shape, the dtype and the card, never of the mask: X in tiles of
    128 columns (two mask tiles) against `tile_bn(c)` columns of v, so X
    is read once for c up to 128; split s takes row chunks s, s + splits,
    ... as xtv_bs's, enough splits for `_XTV_BS_TILE_WAVES` (tile, split)
    blocks per resident block, at most one a chunk and the grid's 65,535,
    at least enough that no split holds more than `_BS_MAX_CHUNKS`
    chunks (its bitmap in shared memory)."""
    bn = tile_bn(c, dtype)
    tiles = -(-n // _XT_BM) * -(-c // bn)
    chunks = -(-m // ROWS)
    slots = _XTV_BS_TILE_WAVES * sms * xtv_bs_blocks_per_sm(bn, dtype)
    want = min(chunks, -(-slots // tiles), _MAX_SPLITS)
    return bn, max(1, -(-chunks // _BS_MAX_CHUNKS), want)


@lru_cache(maxsize=1024)
def xtv_bs_route(m: int, n: int, c: int, dtype: torch.dtype,
                 sms: int) -> tuple:
    """Which kernel takes Xᵀv of c columns, with its plan: ("gemv",
    splits) for one column (`xtv_bs_plan`), ("tile", bn, splits) from
    `_TILE_CUT` columns (`xtv_bs_tile_plan`)."""
    if c < _TILE_CUT:
        return ("gemv", xtv_bs_plan(m, n, c, dtype, sms))
    return ("tile",) + xtv_bs_tile_plan(m, n, c, dtype, sms)


@lru_cache(maxsize=1024)
def spmm_route(m: int, k: int, c: int, dtype: torch.dtype,
               sms: int) -> tuple:
    """Which kernel takes X @ W of c columns: ("gemv",) for one column,
    ("tile", bn) from `_TILE_CUT` (`spmm_tile_kernel`: 128 rows of X
    against `tile_bn(c)` columns of W, no split)."""
    if c < _TILE_CUT:
        return ("gemv",)
    return ("tile", tile_bn(c, dtype))


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
    hlocost.charge(kernel_model.gram_bs_work, mask, m, n, x.dtype)
    return out


def _narrow(v: torch.Tensor, c: int, gw: int | None, gs: int):
    """The narrow operand's row stride, column group (gw: c for a plain
    matrix), group stride and copy width: 1 for 16-byte copies, 2 for
    4-byte copies of bfloat16 pairs (an odd c's rows are 4-byte aligned,
    not 16), else 0 (element copies)."""
    gw = c if gw is None else gw
    ld = v.stride(-2)
    if _vec16(v, ld, gs) and gw % (16 // v.element_size()) == 0:
        return ld, gw, gs, 1
    pairs = v.dtype == torch.bfloat16 and v.data_ptr() % 4 == 0 \
        and ld % 2 == 0 and gs % 2 == 0 and gw % 2 == 0
    return ld, gw, gs, 2 if pairs else 0


def _xtv_bs_tile(x: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                 out: torch.Tensor, plan: tuple, gw: int | None = None,
                 gs: int = 0) -> torch.Tensor:
    """Launch xtv_bs_tile (`repro_xtv_bs_tile`) under `plan` (bn, splits)
    into `out` ((n, c), contiguous): v's column j at (j // gw) * gs + j %
    gw of a row (gw None: a plain (m, c) matrix)."""
    bn, splits = plan
    m, n = x.shape
    c = out.shape[1]
    ld, gw, gs, vec = _narrow(v, c, gw, gs)
    dev = x.device
    lib = _library()
    with _on(dev):
        st = _raw_stream(dev)
        ws = out if splits == 1 else _workspace(
            dev, st, splits * n * c * out.element_size())
        _check_rc(lib.repro_xtv_bs_tile(
            _DTYPE_CODE[x.dtype], bn, x.data_ptr(), m, n, x.stride(0),
            aligned16(x), v.data_ptr(), ld, gw, gs, vec, c, mask.data_ptr(),
            mask.shape[1], splits, ws.data_ptr(), out.data_ptr(), st),
            "xtv_bs")
    LAUNCHES["xtv_bs_tile"] += 1
    if splits > 1:
        LAUNCHES["xtv_bs_tile_reduce"] += 1
    return out


def _spmm_tile(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor,
               out: torch.Tensor, bn: int, gw: int | None = None,
               gs: int = 0) -> torch.Tensor:
    """Launch spmm_tile (`repro_spmm_tile`) with W's tiles `bn` wide into
    `out` ((m, c), contiguous); W's columns as v's in `_xtv_bs_tile`."""
    m, k = x.shape
    c = out.shape[1]
    ld, gw, gs, vec = _narrow(w, c, gw, gs)
    dev = x.device
    lib = _library()
    with _on(dev):
        _check_rc(lib.repro_spmm_tile(
            _DTYPE_CODE[x.dtype], bn, x.data_ptr(), m, k, x.stride(0),
            aligned16(x), w.data_ptr(), ld, gw, gs, vec, c, mask.data_ptr(),
            mask.shape[1], out.data_ptr(), _raw_stream(dev)), "spmm")
    LAUNCHES["spmm_tile"] += 1
    return out


def xtv_bs_cuda(x: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Xᵀv on the card for a 2-D v, skipping masked blocks of X (replaces
    `xtv_block_sparse`): one column through the GEMV kernel's partial
    pass over the plan's splits and, past one split, the reduce pass; two
    or more through the tile product and its reduce (`xtv_bs_route`); one
    host call."""
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
    route = xtv_bs_route(m, n, c, x.dtype, _sm_count(dev))
    hlocost.charge(kernel_model.xtv_bs_work, mask, m, n, c, x.dtype)
    if route[0] == "tile":
        return _xtv_bs_tile(x, v, mask, out, route[1:])
    splits = route[1]
    lib = _library()
    with _on(dev):
        st = _raw_stream(dev)
        # one split writes the output itself: no reduce pass
        ws = out if splits == 1 else \
            _workspace(dev, st, splits * n * acc.itemsize)
        _check_rc(lib.repro_xtv_bs(
            _DTYPE_CODE[x.dtype], aligned16(x), x.data_ptr(), v.data_ptr(),
            m, n, x.stride(0), v.stride(0), mask.data_ptr(), mask.shape[1],
            splits, ws.data_ptr(), out.data_ptr(), st), "xtv_bs")
    LAUNCHES["xtv_bs"] += 1
    if splits > 1:
        LAUNCHES["xtv_bs_reduce"] += 1
    return out


def spmm_cuda(x: torch.Tensor, w: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Y = X @ W on the card for a 2-D W, skipping masked blocks of X
    (replaces `spmm_block_sparse`): the GEMV kernel for one column of W,
    the tile product for two or more (`spmm_route`)."""
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
    route = spmm_route(m, k, c, x.dtype, _sm_count(dev))
    hlocost.charge(kernel_model.spmm_work, mask, m, k, c, x.dtype)
    if route[0] == "tile":
        return _spmm_tile(x, w, mask, out, route[1])
    lib = _library()
    with _on(dev):
        _check_rc(lib.repro_spmm(
            _DTYPE_CODE[x.dtype], aligned16(x), x.data_ptr(), w.data_ptr(),
            m, k, x.stride(0), w.stride(0), mask.data_ptr(), mask.shape[1],
            out.data_ptr(), _raw_stream(dev)), "spmm")
    LAUNCHES["spmm"] += 1
    return out


def _masked_meta(kind: str, xd: torch.Tensor, mask: torch.Tensor,
                 c: int = 0) -> torch.Tensor:
    """gram_bs's, xtv_bs's or spmm's output for a "meta" X (v or W of `c`
    columns), charged as a launch's over every block."""
    m, n = xd.shape
    acc = gram_ref.acc_dtype(xd.dtype)
    if kind == "gram_bs":
        hlocost.charge(kernel_model.gram_bs_work, mask, m, n, xd.dtype)
        return xd.new_empty((n, n), dtype=acc)
    if kind == "xtv_bs":
        hlocost.charge(kernel_model.xtv_bs_work, mask, m, n, c, xd.dtype)
        return xd.new_empty((n, c), dtype=acc)
    hlocost.charge(kernel_model.spmm_work, mask, m, n, c, xd.dtype)
    return xd.new_empty((m, c), dtype=acc)


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
    if xd.device.type == "meta":
        return _masked_meta("gram_bs", xd, mask)
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
    if xd.device.type == "meta":
        return _masked_meta("spmm", xd, mask, w.shape[1])
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
    if xd.device.type == "meta":
        return _masked_meta("xtv_bs", xd, mask, v.shape[1])
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
    fn = xtv_masked_op if gram_ops.vmapped(v) else xtv_dense_masked
    out = fn(xd, v, block_mask_from_indices(x))
    return out[:, 0] if squeeze else out


def matmul_bcoo(a, b: torch.Tensor) -> torch.Tensor:
    """A @ B for a BCOO A and dense B; a 1-D B gives a 1-D result."""
    ad, b, squeeze = _operand(a.todense(), b)
    fn = spmm_masked_op if gram_ops.vmapped(b) else spmm_dense_masked
    out = fn(ad, b, block_mask_from_indices(a))
    return out[:, 0] if squeeze else out


# -- under torch.func.vmap ----------------------------------------------------
#
# A parfor grid keeps a sparse X in its config-invariant prefix (a batched
# value is never bcoo: `batching.choose_mode`), but its variant suffix may
# multiply that X with a batched dense operand (X @ beta over a λ grid).
# These custom ops carry the vmap rule for that case: the batch folds into
# the dense operand's columns, one masked launch of k·c columns. On the
# card (and on "meta", which charges the same launch) the tile products
# read each element of the batch where it lies, through a group stride
# (column j of the fold at w[j // c][:, j % c]): no copy of the batch. One
# column in all, and the CPU, take `fold_columns`.

def _fold(kind: str, xd, w, mask, in_dims):
    bx, bw, bm = in_dims
    if bx is not None or bm is not None:
        raise NotImplementedError(
            "a batched sparse operand has no batched lane (choose_mode "
            "sends such grids to the sequential loop)")
    w = gram_ops.rows(w.movedim(bw, 0))
    k, r, c = w.shape
    m, n = xd.shape
    plain = spmm_dense_masked if kind == "spmm" else xtv_dense_masked
    if xd.device.type == "cpu" or k * c < _TILE_CUT or m == 0 or n == 0:
        return gram_ops.fold_columns(lambda x, v: plain(x, v, mask), xd, w,
                                     0)
    cols = k * c
    if xd.device.type == "meta":
        out = _masked_meta(kind, xd, mask, cols)
    else:
        _check_matrix(xd, kind)
        if w.dtype != xd.dtype or w.device != xd.device:
            raise TypeError(f"{kind}: x is {xd.dtype} on {xd.device}, the "
                            f"other operand {w.dtype} on {w.device}")
        if r != (n if kind == "spmm" else m):
            raise ValueError(f"{kind}: shapes differ, {tuple(xd.shape)} "
                             f"and a batch of {tuple(w.shape[1:])}")
        _check_mask(mask, m, n, xd, kind)
        acc = gram_ref.acc_dtype(xd.dtype)
        sms = _sm_count(xd.device)
        if kind == "spmm":
            hlocost.charge(kernel_model.spmm_work, mask, m, n, cols, xd.dtype)
            out = _spmm_tile(xd, w, mask, xd.new_empty((m, cols), dtype=acc),
                             spmm_route(m, n, cols, xd.dtype, sms)[1], c,
                             w.stride(0))
        else:
            hlocost.charge(kernel_model.xtv_bs_work, mask, m, n, cols,
                           xd.dtype)
            out = _xtv_bs_tile(xd, w, mask,
                               xd.new_empty((n, cols), dtype=acc),
                               xtv_bs_route(m, n, cols, xd.dtype, sms)[1:],
                               c, w.stride(0))
    return out.reshape(out.shape[0], k, c).permute(1, 0, 2), 0


@torch.library.custom_op("repro_torch::spmm_masked", mutates_args=())
def spmm_masked_op(xd: torch.Tensor, w: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    return spmm_dense_masked(xd, w, mask)


@spmm_masked_op.register_fake
def _(xd, w, mask):
    return xd.new_empty((xd.shape[0], w.shape[1]),
                        dtype=gram_ref.acc_dtype(xd.dtype))


@spmm_masked_op.register_vmap
def _(info, in_dims, xd, w, mask):
    return _fold("spmm", xd, w, mask, in_dims)


@torch.library.custom_op("repro_torch::xtv_masked", mutates_args=())
def xtv_masked_op(xd: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    return xtv_dense_masked(xd, v, mask)


@xtv_masked_op.register_fake
def _(xd, v, mask):
    return xd.new_empty((xd.shape[1], v.shape[1]),
                        dtype=gram_ref.acc_dtype(xd.dtype))


@xtv_masked_op.register_vmap
def _(info, in_dims, xd, v, mask):
    return _fold("xtv_bs", xd, v, mask, in_dims)
