"""Dispatching wrappers for the gram/tsmm kernel family.

`gram(x)` / `xtv(x, v)` pick the execution path from the tensor's device:
  * CUDA — the hand-written sm_90a kernels of `repro_torch/csrc/gram.cu`
           (a split-K partial pass plus a fixed-order reduce pass), or an
           exception; there is no fallback to the plain version
  * CPU  — the plain torch version in `ref`

Port of `repro.kernels.gram.ops`. Each CUDA wrapper counts its launches
in `LAUNCHES` (the partial pass under the op's name, the reduce pass
apart), so a run can show that its main path went through the kernels.

The launch plans (`gram_plan`, `xtv_plan`) are pure functions of the
shape, the dtype and the card's SM count, so a call is reproducible bit
for bit; each is computed once per shape and card. The host path of a
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

from . import ref

# One count per launched kernel pass; reset with `reset_launches()`.
LAUNCHES = {"gram": 0, "gram_reduce": 0, "xtv": 0, "xtv_reduce": 0}

# the instantiations of gram.cu; float16 has none and is refused on the card
_DTYPE_CODE = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}
_MIN_SPLIT_ROWS = 64   # never split the rows finer than this
_BLOCKS_PER_SM = 4     # blocks to aim for per SM when splitting rows
_MAX_SPLITS = 65535    # grid.y limit
_lib = None

# gram.cu's gram: 128 x GRAM_TILE_N output tiles (128, or 64 for n <= 64;
# chosen by measurement, PERF.md), one resident block a SM (150-220
# registers a thread), and the rates the split plan weighs: seconds a
# block takes per row of X on one tile, and the bytes/s of the split
# partials' round trip through device memory
_BM = 128
GRAM_TILE_N = 128
_SM_FLOPS = {torch.float64: 67e12 / 132 * 0.6,   # FP64 tensor cores
             torch.float32: 67e12 / 132 * 0.6,   # FMA pipes
             torch.bfloat16: 989e12 / 132 * 0.15}  # mma.sync, L2-fed
_WS_BYTES_PER_S = 3.35e12 * 0.8
_REDUCE_S_PER_SPLIT = 1.25e-7  # a load latency per 8 splits in the reduce
_MIN_GRAM_ROWS = 64

# gram.cu's xtv: a block covers 32 lanes x 16 bytes of every row it reads;
# blocks resident per SM (registers: ~120 a thread for one column of v,
# ~170 for four), never more blocks than fit at once (a second wave of a
# few blocks costs a whole block's time)
_XTV_BLOCKS_PER_SM = {1: 2, 4: 1}
_XTV_MIN_ROWS = 256

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
        lib.repro_gram_reduce.argtypes = [i32, p, i32, i64, p, p]
        lib.repro_xtv.argtypes = [i32, i32, p, p, i64, i64, i64, i64, i64,
                                  i64, i32, p, p, p]
        lib.repro_xtv_reduce.argtypes = [i32, p, i32, i64, p, p]
        for fn in (lib.repro_gram, lib.repro_gram_reduce, lib.repro_xtv,
                   lib.repro_xtv_reduce):
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


def _splits(m: int, blocks_per_split: int, device) -> tuple[int, int]:
    """(splits, rows per split) for a row reduction over `m` rows: enough
    splits to put ~`_BLOCKS_PER_SM` blocks on every SM, never fewer than
    `_MIN_SPLIT_ROWS` rows each. Depends only on the shape and the card,
    so a given call is reproducible bit for bit. (The block-sparse
    kernels' plan; gram and xtv have their own.)"""
    sms = _sm_count(device)
    want = -(-_BLOCKS_PER_SM * sms // max(blocks_per_split, 1))
    most = max(1, -(-m // _MIN_SPLIT_ROWS))
    splits = max(1, min(want, most, _MAX_SPLITS))
    rows = -(-m // splits)
    return -(-m // rows), rows


def gram_tiles(n: int, tile_n: int = GRAM_TILE_N) -> int:
    """Upper-triangle output tiles of 128 x `tile_n` that gram computes
    (`upper_tiles` in gram.cu): tile row ti holds column tiles tj >=
    ti * 128 / tile_n."""
    r = _BM // tile_n
    ti, tj = -(-n // _BM), -(-n // tile_n)
    return ti * tj - r * ti * (ti - 1) // 2


@lru_cache(maxsize=1024)
def gram_plan(m: int, n: int, dtype: torch.dtype, sms: int,
              tile_n: int) -> tuple[int, int, int]:
    """(tile_n, splits, rows per split) of gram on a card with `sms` SMs.

    Splitting the rows fills the card but writes each split's partial
    tiles to device memory and reads them back. The plan takes the split
    count with the least estimated time: the waves of blocks (tiles x
    splits over the resident slots) times a block's rows, plus the
    workspace's round trip (the first on a tie)."""
    if n <= 64:
        tile_n = 64  # half the idle columns of a 128-wide tile
    tiles = gram_tiles(n, tile_n)
    slots = sms  # one block a SM
    row_s = 2.0 * _BM * tile_n / _SM_FLOPS[dtype]
    ws_s = max(2.0 * tiles * _BM * tile_n * ref.acc_dtype(dtype).itemsize
               / _WS_BYTES_PER_S, _REDUCE_S_PER_SPLIT)
    most = max(1, min(-(-m // _MIN_GRAM_ROWS), _MAX_SPLITS, 8 * slots))
    best = None
    for s in range(1, most + 1):
        rows = -(-m // s)
        s = -(-m // rows)
        t = -(-tiles * s // slots) * rows * row_s + s * ws_s
        if best is None or t < best[0]:
            best = (t, s, rows)
    return tile_n, best[1], best[2]


@lru_cache(maxsize=1024)
def xtv_plan(m: int, n: int, c: int, dtype: torch.dtype,
             sms: int) -> tuple[int, int]:
    """(splits, rows per split) of xtv on a card with `sms` SMs: as many
    splits of the column slabs (32 lanes x 16 bytes of a row each) as fit
    on the card at once, each at least `_XTV_MIN_ROWS` rows, so a block
    reads hundreds of KB and the partials stay few."""
    slabs = -(-n // (32 * 16 // dtype.itemsize))
    want = max(1, _XTV_BLOCKS_PER_SM[1 if c == 1 else 4] * sms // slabs)
    most = max(1, -(-m // _XTV_MIN_ROWS))
    splits = max(1, min(want, most, _MAX_SPLITS))
    rows = -(-m // splits)
    return -(-m // rows), rows


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


def gram_cuda(x: torch.Tensor) -> torch.Tensor:
    """G = X^T X on the card (replaces `gram_pallas`)."""
    _check_matrix(x, "gram")
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
    splits, rows = xtv_plan(m, n, c, x.dtype, _sm_count(dev))
    lib = _library()
    with _on(dev):
        st = _raw_stream(dev)
        # one split writes the output itself: no reduce pass
        ws = out if splits == 1 else \
            _workspace(dev, st, splits * n * c * acc.itemsize)
        _check_rc(lib.repro_xtv(
            _DTYPE_CODE[x.dtype], aligned16(x), x.data_ptr(), v.data_ptr(),
            m, n, c, x.stride(0), v.stride(0), rows, splits, ws.data_ptr(),
            out.data_ptr(), st), "xtv")
    LAUNCHES["xtv"] += 1
    if splits > 1:
        LAUNCHES["xtv_reduce"] += 1
    return out


def gram(x: torch.Tensor) -> torch.Tensor:
    """G = X^T X (bfloat16 accumulates and returns float32)."""
    if x.device.type == "cpu":
        return ref.gram(x)
    return gram_cuda(x)


def xtv(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X^T v without forming t(X); a 1-D v gives a 1-D result."""
    if x.device.type == "cpu":
        return ref.xtv(x, v)
    squeeze = v.ndim == 1
    out = xtv_cuda(x, v[:, None] if squeeze else v)
    return out[:, 0] if squeeze else out
