"""Dispatching wrappers for the gram/tsmm kernel family.

`gram(x)` / `xtv(x, v)` pick the execution path from the tensor's device:
  * CUDA — the hand-written sm_90a kernels of `repro_torch/csrc/gram.cu`
           (a split-K partial pass plus a fixed-order reduce pass), or an
           exception; there is no fallback to the plain version. xtv takes
           one of two kernels by `xtv_route`: the slab kernel for one
           column of v, the tile product for two or more
  * CPU  — the plain torch version in `ref`
  * meta — the kernel's output shape, nothing computed (`gram_meta`,
           `xtv_meta` and their batched forms)

Port of `repro.kernels.gram.ops`. Each CUDA wrapper counts its launches
in `LAUNCHES` (the partial pass under its kernel's name — `xtv` the slab,
`xtv_tile` the tile product — the reduce pass apart), so a run can show
that its main path went through the kernels.
The CUDA wrappers and the meta implementations charge the kernel's work
(`launch.kernel_model`) to an active `launch.hlocost` counter, which
cannot see a `ctypes` launch; so do the custom ops `gram_op` and
`xtv_op` on the CPU, whose plain body runs below the counter.

Under `torch.func.vmap` (the parfor lane's config-variant segments),
`gram_op` and `xtv_op` — `torch.library` custom ops with a vmap rule —
batch the call into ONE launch over the vmapped axis
(`gram_batched_cuda`, `xtv_batched_cuda`: the C entries
`repro_gram_batched` / `repro_xtv_batched` / `repro_xtv_tile`, counted
under `gram_batched`/`xtv_batched`/`xtv_tile_batched`); an x shared by
the batch with a batched v folds the batch into v's columns
(`xtv_fold`: one lone tile launch of k·c columns that reads each v where
it lies, through its batch stride). On the CPU the rule computes the
plain version batched.

The launch plans (`gram_plan`, `xtv_plan`) are pure functions of the
shape, the batch, the dtype and the card's SM count, so a call is
reproducible bit for bit; each is computed once per shape and card. A
batched call's plan covers the whole batch (batch x tiles x splits), and
its elements' results are those of lone calls under that plan. The host path of a
call is kept short (it sets the small kernels' time): the SM count and
the plans are cached, the device is switched only when the tensor is not
on the current one, the stream is read as a raw handle, and the split
workspace is kept per device and stream (`_workspace`).
"""
from __future__ import annotations

import contextlib
import ctypes
from functools import lru_cache

import torch

from ...launch import hlocost, kernel_model
from . import ref

# One count per launched kernel pass; reset with `reset_launches()`.
LAUNCHES = {"gram": 0, "gram_reduce": 0, "xtv": 0, "xtv_reduce": 0,
            "gram_batched": 0, "gram_batched_reduce": 0, "xtv_batched": 0,
            "xtv_batched_reduce": 0, "xtv_tile": 0, "xtv_tile_reduce": 0,
            "xtv_tile_batched": 0, "xtv_tile_batched_reduce": 0}

# the instantiations of gram.cu; float16 has none and is refused on the card
_DTYPE_CODE = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}
_MAX_SPLITS = 65535    # grid.y limit
_lib = None

# gram.cu's gram: 128 x GRAM_TILE_N output tiles (128, or 64 for n <= 64;
# chosen by measurement, PERF.md), one resident block a SM (150-220
# registers a thread), and the rates the split plan weighs: seconds a
# block takes per row of X on one tile, and the bytes/s of the split
# partials' round trip through device memory. bfloat16's splits are whole
# stages of its TMA ring (`_WG_BK` rows)
_BM = 128
GRAM_TILE_N = 128
_SM_FLOPS = {torch.float64: 67e12 / 132 * 0.6,   # FP64 tensor cores
             torch.float32: 67e12 / 132 * 0.6,   # FMA pipes
             torch.bfloat16: 989e12 / 132 * 0.43}  # wgmma, L2-bound
_WG_BK = 64
_WS_BYTES_PER_S = 3.35e12 * 0.8
_REDUCE_S_PER_SPLIT = 1.25e-7  # a load latency per 8 splits in the reduce
_MIN_GRAM_ROWS = 64

# gram.cu's xtv slab kernel (one column of v; `xtv_plan`): a block covers
# 32 lanes x 16 bytes of every row it reads; blocks resident per SM (~120
# registers a thread), never more blocks than fit at once (a second wave
# of a few blocks costs a whole block's time)
_XTV_BLOCKS_PER_SM = 2
_XTV_MIN_ROWS = 256

# gram.cu's xtv tile product (`xtv_tile_plan`), for two or more columns of
# v (faster from c = 2 at the paths' shapes than a slab kernel taking v
# four columns a pass, PERF.md): an output tile is 128 columns of the
# wider operand against 8, 16, 32 or 64 of the narrower (no narrow side
# padded to 128); two resident blocks a SM (4 ring stages of 16 KB of the
# wide operand each), one wave, each block at least `_XT_MIN_ROWS` rows
_XT_BM = 128
_XT_BLOCKS_PER_SM = 2
_XT_MIN_ROWS = 64

# split workspaces kept per (device, stream) up to this size; larger ones
# are allocated per call
_WS_KEEP_BYTES = 64 << 20
_WS: dict[tuple[int, int], torch.Tensor] = {}
_SMS: dict[int, int] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import library
        lib = library("gram")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_gram.argtypes = [i32, i32, i32, p, i64, i64, i64, i64, i32,
                                   p, p, p]
        lib.repro_xtv.argtypes = [i32, i32, p, p, i64, i64, i64, i64, i64,
                                  i32, p, p, p]
        lib.repro_gram_batched.argtypes = [i32, i32, i32, p, i32, i64, i64,
                                           i64, i64, i64, i32, p, p, p]
        lib.repro_xtv_batched.argtypes = [i32, i32, p, p, i32, i64, i64, i64,
                                          i64, i64, i64, i64, i32, p, p, p]
        lib.repro_xtv_tile.argtypes = [i32, i32, i32, i32, p, i64, i64, i32,
                                       p, i64, i64, i64, i64, i32, i64, i64,
                                       i64, i64, i32, p, p, p]
        for fn in (lib.repro_gram, lib.repro_xtv, lib.repro_gram_batched,
                   lib.repro_xtv_batched, lib.repro_xtv_tile):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def _check_matrix(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"{what}: expected a matrix, got shape "
                         f"{tuple(x.shape)}")
    if x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"{what}: rows must be contiguous (stride "
                         f"{tuple(x.stride())})")


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _sm_count(device) -> int:
    idx = _index(torch.device(device))
    sms = _SMS.get(idx)
    if sms is None:
        sms = _SMS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return sms


def gram_tiles(n: int, tile_n: int = GRAM_TILE_N) -> int:
    """Upper-triangle output tiles of 128 x `tile_n` that gram computes
    (`upper_tiles` in gram.cu): tile row ti holds column tiles tj >=
    ti * 128 / tile_n."""
    r = _BM // tile_n
    ti, tj = -(-n // _BM), -(-n // tile_n)
    return ti * tj - r * ti * (ti - 1) // 2


@lru_cache(maxsize=1024)
def gram_plan(m: int, n: int, dtype: torch.dtype, sms: int,
              tile_n: int, batch: int = 1) -> tuple[int, int, int]:
    """(tile_n, splits, rows per split) of gram on a card with `sms` SMs,
    for one X or a batch of `batch` of them in one launch (bfloat16: rows
    per split a multiple of `_WG_BK`, the TMA ring's stage).

    Splitting the rows fills the card but writes each split's partial
    tiles to device memory and reads them back. The plan takes the split
    count with the least estimated time: the waves of blocks (batch x
    tiles x splits over the resident slots) times a block's rows, plus
    the workspace's round trip (the first on a tie)."""
    if n <= 64:
        tile_n = 64  # half the idle columns of a 128-wide tile
    tiles = batch * gram_tiles(n, tile_n)
    slots = sms  # one block a SM
    row_s = 2.0 * _BM * tile_n / _SM_FLOPS[dtype]
    ws_s = max(2.0 * tiles * _BM * tile_n * ref.acc_dtype(dtype).itemsize
               / _WS_BYTES_PER_S, _REDUCE_S_PER_SPLIT)
    most = max(1, min(-(-m // _MIN_GRAM_ROWS), _MAX_SPLITS, 8 * slots))
    unit = _WG_BK if dtype == torch.bfloat16 else 1
    best = None
    for s in range(1, most + 1):
        rows = -(-m // (s * unit)) * unit
        s = -(-m // rows)
        t = -(-tiles * s // slots) * rows * row_s + s * ws_s
        if best is None or t < best[0]:
            best = (t, s, rows)
    return tile_n, best[1], best[2]


@lru_cache(maxsize=1024)
def xtv_plan(m: int, n: int, c: int, dtype: torch.dtype,
             sms: int, batch: int = 1) -> tuple[int, int]:
    """(splits, rows per split) of the xtv slab kernel on a card with `sms`
    SMs, for one X or a batch of `batch` in one launch: as many splits of
    the column slabs (32 lanes x 16 bytes of a row each, per batch
    element) as fit on the card at once, each at least `_XTV_MIN_ROWS`
    rows, so a block reads hundreds of KB and the partials stay few. The
    kernel takes one column of v (`xtv_route`); the plan does not depend
    on `c`."""
    slabs = batch * -(-n // (32 * 16 // dtype.itemsize))
    want = max(1, _XTV_BLOCKS_PER_SM * sms // slabs)
    most = max(1, -(-m // _XTV_MIN_ROWS))
    splits = max(1, min(want, most, _MAX_SPLITS))
    rows = -(-m // splits)
    return -(-m // rows), rows


@lru_cache(maxsize=1024)
def xtv_tile_plan(m: int, n: int, c: int, dtype: torch.dtype, sms: int,
                  batch: int = 1) -> tuple[int, bool, int, int]:
    """(bn, trans, splits, rows per split) of the xtv tile product on a
    card with `sms` SMs, for an (m, n) X against an (m, c) v, one or a
    batch of `batch` in one launch. The wider of X and v is tiled 128
    columns at a time (trans: v is the wider), the narrower `bn` columns
    (8, 16, 32, or 64 and more tiles), so the wide one is read once; the
    rows split so that the batch x tiles x splits blocks fill the card's
    resident slots once, each split at least `_XT_MIN_ROWS` rows."""
    trans = n < c
    wide, narrow = (c, n) if trans else (n, c)
    bn = next((b for b in (8, 16, 32) if narrow <= b), 64)
    tiles = batch * -(-wide // _XT_BM) * -(-narrow // bn)
    want = max(1, _XT_BLOCKS_PER_SM * sms // tiles)
    most = max(1, -(-m // _XT_MIN_ROWS))
    splits = max(1, min(want, most, _MAX_SPLITS))
    rows = -(-m // splits)
    return bn, trans, -(-m // rows), rows


@lru_cache(maxsize=1024)
def xtv_route(m: int, n: int, c: int, dtype: torch.dtype, sms: int,
              batch: int = 1) -> tuple:
    """Which xtv kernel takes a call, and its plan: ("slab", splits, rows)
    for one column of v (`xtv_plan`), else ("tile", bn, trans, splits,
    rows) (`xtv_tile_plan`)."""
    if c == 1:
        return ("slab",) + xtv_plan(m, n, c, dtype, sms, batch)
    return ("tile",) + xtv_tile_plan(m, n, c, dtype, sms, batch)


def aligned16(x: torch.Tensor) -> bool:
    """The kernels' 16-byte copies need X's base and its leading
    dimension 16-byte aligned; a column slice keeps its parent's leading
    dimension, and odd float64 widths give 8-byte-aligned rows."""
    return x.data_ptr() % 16 == 0 \
        and (x.stride(0) * x.element_size()) % 16 == 0


def _on(device: torch.device):
    """The device's context, entered only when it is not the current one."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _raw_stream(device: torch.device) -> int:
    return torch._C._cuda_getCurrentRawStream(_index(device))


def _stream(x: torch.Tensor):
    return ctypes.c_void_p(_raw_stream(x.device))


def _workspace(device: torch.device, stream: int,
               nbytes: int) -> torch.Tensor:
    """At least `nbytes` of scratch for the split partials. Kept per
    (device, stream) and grown on demand: work on one stream runs in
    order, so a call's reduce pass has read the buffer before the next
    call's partial pass writes it. Larger than `_WS_KEEP_BYTES`, it is
    allocated for the call (the caller holds it until its launches are
    enqueued; the caching allocator reuses it in stream order)."""
    if nbytes > _WS_KEEP_BYTES:
        return torch.empty(nbytes, dtype=torch.uint8, device=device)
    key = (_index(device), stream)
    buf = _WS.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _WS[key] = torch.empty(max(nbytes, 1 << 20), dtype=torch.uint8,
                                     device=device)
    return buf


def _vec16(t: torch.Tensor, *strides: int) -> bool:
    """16-byte copies of `t` (its base and every element stride of
    `strides` 16-byte aligned)."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(s * size % 16 == 0
                                          for s in strides)


def _tma_ready(x: torch.Tensor) -> torch.Tensor:
    """X for the bfloat16 gram's TMA loads: X itself where its base, row
    stride and (a stack's) batch stride are 16-byte aligned, else a copy
    whose rows are padded to a multiple of 8 elements (a view of its
    first n columns; the loads zero-fill past n). A "meta" X makes the
    same copy, so a count on "meta" charges it as the card's does (its
    base is taken as aligned where its storage offset is: allocations
    are)."""
    base = x.data_ptr() if x.device.type == "cuda" else \
        x.storage_offset() * x.element_size()
    if base % 16 == 0 and all(s * x.element_size() % 16 == 0
                              for s in x.stride()[:-1]):
        return x
    n = x.shape[-1]
    buf = x.new_empty((*x.shape[:-1], -(-n // 8) * 8))
    buf[..., :n].copy_(x)
    return buf[..., :n]


def _xtv_tile(x: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
              plan: tuple, key: str, batch: int = 1, xbatch: int = 0,
              vbatch: int = 0, vgw: int | None = None,
              vgs: int = 0) -> torch.Tensor:
    """Launch the xtv tile product (`repro_xtv_tile`) under `plan` (bn,
    trans, splits, rows) into `out` ((n, c) or (batch, n, c), contiguous)
    and count it under `key`: X (m, n) and v (m, c) by their row strides,
    batch elements xbatch and vbatch apart, v's column j at (j // vgw) *
    vgs + j % vgw (vgw None: a plain matrix)."""
    bn, trans, splits, rows = plan
    m, n = x.shape[-2:]
    c = out.shape[-1]
    vgw = c if vgw is None else vgw
    ldx, ldv = x.stride(-2), v.stride(-2)
    xvec = _vec16(x, ldx, xbatch)
    vvec = _vec16(v, ldv, vbatch, vgs) \
        and vgw % (16 // v.element_size()) == 0
    dev = x.device
    lib = _library()
    with _on(dev):
        st = _raw_stream(dev)
        ws = out if splits == 1 else _workspace(
            dev, st, batch * splits * n * c * out.element_size())
        _check_rc(lib.repro_xtv_tile(
            _DTYPE_CODE[x.dtype], bn, trans, batch, x.data_ptr(), ldx, xbatch,
            xvec, v.data_ptr(), ldv, vgw, vgs, vbatch, vvec, m, n, c, rows,
            splits, ws.data_ptr(), out.data_ptr(), st), key)
    LAUNCHES[key] += 1
    if splits > 1:
        LAUNCHES[f"{key}_reduce"] += 1
    return out


def gram_cuda(x: torch.Tensor) -> torch.Tensor:
    """G = X^T X on the card (replaces `gram_pallas`)."""
    _check_matrix(x, "gram")
    if x.dtype == torch.bfloat16:
        x = _tma_ready(x)
    m, n = x.shape
    dev = x.device
    acc = ref.acc_dtype(x.dtype)
    out = x.new_empty((n, n), dtype=acc)
    if m == 0 or n == 0:
        return out.zero_()
    tile_n, splits, rows = gram_plan(m, n, x.dtype, _sm_count(dev),
                                     GRAM_TILE_N)
    nbytes = splits * gram_tiles(n, tile_n) * _BM * tile_n * acc.itemsize
    lib = _library()
    with _on(dev):
        st = _raw_stream(dev)
        ws = _workspace(dev, st, nbytes)
        _check_rc(lib.repro_gram(
            _DTYPE_CODE[x.dtype], tile_n, aligned16(x), x.data_ptr(), m, n,
            x.stride(0), rows, splits, ws.data_ptr(), out.data_ptr(), st),
            "gram")
    LAUNCHES["gram"] += 1
    LAUNCHES["gram_reduce"] += 1
    hlocost.charge(kernel_model.gram_work, m, n, x.dtype)
    return out


def xtv_cuda(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X^T v on the card for a 2-D v (replaces `xtv_pallas`)."""
    _check_matrix(x, "xtv")
    _check_matrix(v, "xtv")
    if v.dtype != x.dtype or v.device != x.device:
        raise TypeError(f"xtv: x is {x.dtype} on {x.device}, v is "
                        f"{v.dtype} on {v.device}")
    m, n = x.shape
    if v.shape[0] != m:
        raise ValueError(f"xtv: rows differ, {tuple(x.shape)} vs "
                         f"{tuple(v.shape)}")
    c = v.shape[1]
    dev = x.device
    acc = ref.acc_dtype(x.dtype)
    out = x.new_empty((n, c), dtype=acc)
    if m == 0 or n == 0 or c == 0:
        return out.zero_()
    route = xtv_route(m, n, c, x.dtype, _sm_count(dev))
    hlocost.charge(kernel_model.xtv_work, m, n, c, x.dtype)
    if route[0] == "tile":
        return _xtv_tile(x, v, out, route[1:], "xtv_tile")
    _, splits, rows = route
    lib = _library()
    with _on(dev):
        st = _raw_stream(dev)
        # one split writes the output itself: no reduce pass
        ws = out if splits == 1 else \
            _workspace(dev, st, splits * n * c * acc.itemsize)
        _check_rc(lib.repro_xtv(
            _DTYPE_CODE[x.dtype], aligned16(x), x.data_ptr(), v.data_ptr(),
            m, n, x.stride(0), v.stride(0), rows, splits, ws.data_ptr(),
            out.data_ptr(), st), "xtv")
    LAUNCHES["xtv"] += 1
    if splits > 1:
        LAUNCHES["xtv_reduce"] += 1
    return out


def gram_meta(x: torch.Tensor) -> torch.Tensor:
    """gram's output for a "meta" X, its work charged as a launch's."""
    if x.dtype == torch.bfloat16:
        x = _tma_ready(x)
    m, n = x.shape
    hlocost.charge(kernel_model.gram_work, m, n, x.dtype)
    return x.new_empty((n, n), dtype=ref.acc_dtype(x.dtype))


def xtv_meta(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """xtv's output for a "meta" X and a 2-D v, charged as a launch's."""
    m, n = x.shape
    hlocost.charge(kernel_model.xtv_work, m, n, v.shape[1], x.dtype)
    return x.new_empty((n, v.shape[1]), dtype=ref.acc_dtype(x.dtype))


def gram(x: torch.Tensor) -> torch.Tensor:
    """G = X^T X (bfloat16 accumulates and returns float32)."""
    if x.device.type == "cpu":
        return ref.gram(x)
    if x.device.type == "meta":
        return gram_meta(x)
    return gram_cuda(x)


def xtv(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X^T v without forming t(X); a 1-D v gives a 1-D result."""
    if x.device.type == "cpu":
        return ref.xtv(x, v)
    squeeze = v.ndim == 1
    fn = xtv_meta if x.device.type == "meta" else xtv_cuda
    out = fn(x, v[:, None] if squeeze else v)
    return out[:, 0] if squeeze else out


def gram_aug(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """One-pass sufficient statistics for lmDS: gram([X | y]) = [[XᵀX,
    Xᵀy], [yᵀX, yᵀy]], one gram launch over the augmented matrix (a 1-D
    y is one column)."""
    if y.ndim == 1:
        y = y[:, None]
    return gram(torch.cat([x, y.to(x.dtype)], dim=1))


def rows(x: torch.Tensor) -> torch.Tensor:
    """`x` with contiguous rows, as the kernels read it: a matrix or a
    (batch, rows, cols) stack whose last stride is 1 (a column slice keeps
    its other strides and is not copied; a vector is returned as is)."""
    if x.ndim >= 2 and x.shape[-1] > 1 and x.stride(-1) != 1:
        return x.contiguous()
    return x


def vmapped(*xs) -> bool:
    """Any of `xs` is a tensor batched by an enclosing torch.func.vmap
    (a config-variant segment of the parfor lane)."""
    return any(torch._C._functorch.is_batchedtensor(x) for x in xs)


def fold_columns(fn, x: torch.Tensor, v: torch.Tensor, bv: int):
    """A vmap rule's answer for one X and a batch of v (batch axis `bv`):
    the batch folds into v's columns, one call `fn(x, v)` of k·c columns.
    Returns the (batch, rows, c) result and its batch axis, 0."""
    v = v.movedim(bv, 0)
    k, r, c = v.shape
    out = fn(x, rows(v.permute(1, 0, 2).reshape(r, k * c)))
    return out.reshape(out.shape[0], k, c).permute(1, 0, 2), 0


# -- the batch axis: one launch for a whole vmapped batch --------------------

def _check_batched(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    if x.ndim != 3:
        raise ValueError(f"{what}: expected a (batch, rows, cols) stack, "
                         f"got shape {tuple(x.shape)}")
    if x.shape[2] > 1 and x.stride(2) != 1:
        raise ValueError(f"{what}: rows must be contiguous (stride "
                         f"{tuple(x.stride())})")


def _aligned16_batched(x: torch.Tensor) -> bool:
    return aligned16(x[0]) and (x.stride(0) * x.element_size()) % 16 == 0


def gram_batched_cuda(x: torch.Tensor) -> torch.Tensor:
    """G_b = X_bᵀ X_b for a (batch, m, n) stack on the card: one partial
    and one reduce launch over the whole batch."""
    _check_batched(x, "gram_batched")
    if x.dtype == torch.bfloat16:
        x = _tma_ready(x)
    k, m, n = x.shape
    dev = x.device
    acc = ref.acc_dtype(x.dtype)
    out = x.new_empty((k, n, n), dtype=acc)
    if k == 0 or m == 0 or n == 0:
        return out.zero_()
    tile_n, splits, rows = gram_plan(m, n, x.dtype, _sm_count(dev),
                                     GRAM_TILE_N, k)
    nbytes = k * splits * gram_tiles(n, tile_n) * _BM * tile_n \
        * acc.itemsize
    lib = _library()
    with _on(dev):
        st = _raw_stream(dev)
        ws = _workspace(dev, st, nbytes)
        _check_rc(lib.repro_gram_batched(
            _DTYPE_CODE[x.dtype], tile_n, _aligned16_batched(x),
            x.data_ptr(), k, x.stride(0), m, n, x.stride(1), rows, splits,
            ws.data_ptr(), out.data_ptr(), st), "gram_batched")
    LAUNCHES["gram_batched"] += 1
    LAUNCHES["gram_batched_reduce"] += 1
    hlocost.charge(kernel_model.gram_batched_work, k, m, n, x.dtype)
    return out


def xtv_batched_cuda(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X_bᵀ v_b for a (batch, m, n) stack on the card, v a (batch, m, c)
    stack or one (m, c) matrix for every element (batch stride 0): one
    partial launch over the batch and, with more than one split, one
    reduce launch."""
    _check_batched(x, "xtv_batched")
    k, m, n = x.shape
    if v.ndim == 2:
        v = v.expand(k, *v.shape)
    _check_batched(v, "xtv_batched")
    if v.dtype != x.dtype or v.device != x.device:
        raise TypeError(f"xtv_batched: x is {x.dtype} on {x.device}, v is "
                        f"{v.dtype} on {v.device}")
    if v.shape[:2] != (k, m):
        raise ValueError(f"xtv_batched: shapes differ, {tuple(x.shape)} vs "
                         f"{tuple(v.shape)}")
    c = v.shape[2]
    dev = x.device
    acc = ref.acc_dtype(x.dtype)
    out = x.new_empty((k, n, c), dtype=acc)
    if k == 0 or m == 0 or n == 0 or c == 0:
        return out.zero_()
    route = xtv_route(m, n, c, x.dtype, _sm_count(dev), k)
    hlocost.charge(kernel_model.xtv_batched_work, k, m, n, c, x.dtype,
                   v.stride(0) != 0)
    if route[0] == "tile":
        return _xtv_tile(x, v, out, route[1:], "xtv_tile_batched", k,
                         x.stride(0), v.stride(0))
    _, splits, rows = route
    lib = _library()
    with _on(dev):
        st = _raw_stream(dev)
        ws = out if splits == 1 else \
            _workspace(dev, st, k * splits * n * c * acc.itemsize)
        _check_rc(lib.repro_xtv_batched(
            _DTYPE_CODE[x.dtype], _aligned16_batched(x), x.data_ptr(),
            v.data_ptr(), k, x.stride(0), v.stride(0), m, n, x.stride(1),
            v.stride(1), rows, splits, ws.data_ptr(), out.data_ptr(), st),
            "xtv_batched")
    LAUNCHES["xtv_batched"] += 1
    if splits > 1:
        LAUNCHES["xtv_batched_reduce"] += 1
    return out


def xtv_fold(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X^T v_b for one (m, n) X and a (batch, m, c) stack v: the batch
    folded into v's columns, one xtv of k·c columns, returned as (batch,
    n, c). Two or more columns take the tile product, which reads each v_b
    where it lies (column j of the fold at v[j // c][:, j % c]); "meta"
    charges and shapes that launch alike, so a count on "meta" is the
    card's. One column and the CPU take `fold_columns`."""
    k, m, c = v.shape
    n = x.shape[1]
    if x.device.type == "cpu" or k * c < 2 or m == 0 or n == 0:
        return fold_columns(xtv, x, v, 0)[0]
    if x.device.type == "cuda":
        _check_matrix(x, "xtv")
        _check_batched(v, "xtv")
        if v.dtype != x.dtype or v.device != x.device:
            raise TypeError(f"xtv: x is {x.dtype} on {x.device}, v is "
                            f"{v.dtype} on {v.device}")
        if m != x.shape[0]:
            raise ValueError(f"xtv: rows differ, {tuple(x.shape)} vs "
                             f"{tuple(v.shape)}")
    out = x.new_empty((n, k * c), dtype=ref.acc_dtype(x.dtype))
    hlocost.charge(kernel_model.xtv_work, m, n, k * c, x.dtype)
    if x.device.type == "cuda":
        route = xtv_route(m, n, k * c, x.dtype, _sm_count(x.device))
        _xtv_tile(x, v, out, route[1:], "xtv_tile", vgw=c,
                  vgs=v.stride(0))
    return out.reshape(n, k, c).permute(1, 0, 2)


def _batched_meta(x: torch.Tensor, v=None) -> torch.Tensor:
    """gram_batched's (v None) or xtv_batched's output for "meta"
    stacks, charged as a launch's."""
    if v is None and x.dtype == torch.bfloat16:
        x = _tma_ready(x)
    k, m, n = x.shape
    acc = ref.acc_dtype(x.dtype)
    if v is None:
        hlocost.charge(kernel_model.gram_batched_work, k, m, n, x.dtype)
        return x.new_empty((k, n, n), dtype=acc)
    c = v.shape[-1]
    hlocost.charge(kernel_model.xtv_batched_work, k, m, n, c, x.dtype,
                   v.ndim == 3)
    return x.new_empty((k, n, c), dtype=acc)


def gram_batched(x: torch.Tensor) -> torch.Tensor:
    """G_b = X_bᵀ X_b over a (batch, m, n) stack."""
    if x.device.type == "cpu":
        return ref.gram_batched(x)
    if x.device.type == "meta":
        return _batched_meta(rows(x))
    return gram_batched_cuda(rows(x))


def xtv_batched(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X_bᵀ v_b over a (batch, m, n) stack; v a (batch, m, c) stack or
    one (m, c) matrix for every element."""
    if x.device.type == "cpu":
        return ref.xtv_batched(x, v)
    if x.device.type == "meta":
        return _batched_meta(rows(x), rows(v))
    return xtv_batched_cuda(rows(x), rows(v))


# The custom ops the backend's gram/xtv take under torch.func.vmap: a
# ctypes launch is opaque to vmap, so each op carries a vmap rule that
# launches the batched kernel once over the vmapped axis. Outside vmap
# the backend calls `gram`/`xtv` directly: the dispatcher would add its
# host time to every unbatched call (chip_smoke's kernel rows measure it,
# `op_host_us` beside the wrapper's `host_us`; PERF.md §6).

@torch.library.custom_op("repro_torch::gram", mutates_args=())
def gram_op(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":  # the plain body, unseen by a counter
        hlocost.charge(kernel_model.gram_work, *x.shape, x.dtype)
    return gram(rows(x))


@gram_op.register_fake
def _(x):
    return gram_meta(x)


@gram_op.register_vmap
def _(info, in_dims, x):
    (bx,) = in_dims
    return gram_batched(x.movedim(bx, 0)), 0


@torch.library.custom_op("repro_torch::xtv", mutates_args=())
def xtv_op(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X^T v for a 2-D v (the backend gives a 1-D v one column)."""
    if x.device.type == "cpu":  # the plain body, unseen by a counter
        hlocost.charge(kernel_model.xtv_work, *x.shape, v.shape[1],
                       x.dtype)
    return xtv(rows(x), rows(v))


@xtv_op.register_fake
def _(x, v):
    return xtv_meta(x, v)


@xtv_op.register_vmap
def _(info, in_dims, x, v):
    bx, bv = in_dims
    if bx is None:  # one X, a batch of v: one lone xtv of k·c columns
        return xtv_fold(rows(x), rows(v.movedim(bv, 0))), 0
    x = x.movedim(bx, 0)
    v = v if bv is None else v.movedim(bv, 0)
    return xtv_batched(x, v), 0
