"""Dispatching wrappers for the gram/tsmm kernel family.

`gram(x)` / `xtv(x, v)` pick the execution path from the tensor's device:
  * CUDA — the hand-written sm_90a kernels of `repro_torch/csrc/gram.cu`
           (a split-K partial pass plus a fixed-order reduce pass), or an
           exception; there is no fallback to the plain version
  * CPU  — the plain torch version in `ref`

Port of `repro.kernels.gram.ops`. Each CUDA wrapper counts its launches
in `LAUNCHES` (the partial pass under the op's name, the reduce pass
apart), so a run can show that its main path went through the kernels.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref

# One count per launched kernel pass; reset with `reset_launches()`.
LAUNCHES = {"gram": 0, "gram_reduce": 0, "xtv": 0, "xtv_reduce": 0}

# the instantiations of gram.cu; float16 has none and is refused on the card
_DTYPE_CODE = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}
_TILE = 64             # gram output tile edge (BN in gram.cu)
_XTV_COLS = 256        # xtv columns per block (XTV_THREADS in gram.cu)
_MIN_SPLIT_ROWS = 64   # never split the rows finer than this
_BLOCKS_PER_SM = 4     # blocks to aim for per SM when splitting rows
_MAX_SPLITS = 65535    # grid.y limit
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import library
        lib = library("gram")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_gram_partial.argtypes = [i32, p, i64, i64, i64, i64, i32,
                                           p, p]
        lib.repro_gram_reduce.argtypes = [i32, p, i32, i64, p, p]
        lib.repro_xtv_partial.argtypes = [i32, p, p, i64, i64, i64, i64,
                                          i64, i64, i32, p, p]
        lib.repro_xtv_reduce.argtypes = [i32, p, i32, i64, p, p]
        for fn in (lib.repro_gram_partial, lib.repro_gram_reduce,
                   lib.repro_xtv_partial, lib.repro_xtv_reduce):
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


def _splits(m: int, blocks_per_split: int, device) -> tuple[int, int]:
    """(splits, rows per split) for a row reduction over `m` rows: enough
    splits to put ~`_BLOCKS_PER_SM` blocks on every SM, never fewer than
    `_MIN_SPLIT_ROWS` rows each. Depends only on the shape and the card,
    so a given call is reproducible bit for bit."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = -(-_BLOCKS_PER_SM * sms // max(blocks_per_split, 1))
    most = max(1, -(-m // _MIN_SPLIT_ROWS))
    splits = max(1, min(want, most, _MAX_SPLITS))
    rows = -(-m // splits)
    return -(-m // rows), rows


def _stream(x: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def gram_cuda(x: torch.Tensor) -> torch.Tensor:
    """G = X^T X on the card (replaces `gram_pallas`)."""
    _check_matrix(x, "gram")
    m, n = x.shape
    acc = ref.acc_dtype(x.dtype)
    out = torch.empty((n, n), dtype=acc, device=x.device)
    if m == 0 or n == 0:
        return out.zero_()
    tiles = -(-n // _TILE)
    splits, rows = _splits(m, tiles * (tiles + 1) // 2, x.device)
    ws = torch.empty((splits, n, n), dtype=acc, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        st = _stream(x)
        _check_rc(lib.repro_gram_partial(
            _DTYPE_CODE[x.dtype], x.data_ptr(), m, n, x.stride(0), rows,
            splits, ws.data_ptr(), st), "gram")
        LAUNCHES["gram"] += 1
        _check_rc(lib.repro_gram_reduce(
            _DTYPE_CODE[acc], ws.data_ptr(), splits, n, out.data_ptr(), st),
            "gram_reduce")
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
    acc = ref.acc_dtype(x.dtype)
    out = torch.empty((n, c), dtype=acc, device=x.device)
    if m == 0 or n == 0 or c == 0:
        return out.zero_()
    splits, rows = _splits(m, -(-n // _XTV_COLS), x.device)
    ws = torch.empty((splits, n, c), dtype=acc, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        st = _stream(x)
        _check_rc(lib.repro_xtv_partial(
            _DTYPE_CODE[x.dtype], x.data_ptr(), v.data_ptr(), m, n, c,
            x.stride(0), v.stride(0), rows, splits, ws.data_ptr(), st),
            "xtv")
        LAUNCHES["xtv"] += 1
        _check_rc(lib.repro_xtv_reduce(
            _DTYPE_CODE[acc], ws.data_ptr(), splits, n * c, out.data_ptr(),
            st), "xtv_reduce")
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
