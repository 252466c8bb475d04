"""Dispatching wrapper for flash attention.

`flash_attention(q, k, v)` takes model-layout tensors (B, S, H, hd) with
GQA kv heads and picks the path from the tensors' device:
  * CUDA — the hand-written sm_90a kernel of `repro_torch/csrc/flash.cu`
           (bfloat16 on tensor cores, float32 on FMA pipes), or an
           exception; there is no fallback to the plain version
  * CPU  — the plain torch version in `ref`

Port of `repro.kernels.flash_attention.ops`. The kernel reads q, k, v
and writes the output through their (B, S, H, hd) strides, so the
reference's transpose to (B·H, S, hd) is skipped, and it masks ragged
sequence lengths itself, so any S ≥ 1 runs without padding. The CUDA
wrapper counts its launches in `LAUNCHES`, so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import ref

# One count per kernel launch; reset with `reset_launches()`.
LAUNCHES = {"flash": 0}

# the instantiations of flash.cu; float16 has none and is refused on the card
_DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2}
_HEAD_DIMS = (32, 64, 128)
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import library
        lib = library("flash")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_flash_fwd.argtypes = (
            [i32, p, p, p, p, i32, i32, i32, i32, i32, i32]
            + [i64] * 12 + [i32, ctypes.c_float, p])
        lib.repro_flash_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: expected a CUDA tensor for "
                             f"{name}, got {t.device}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"flash_attention: unsupported dtype {t.dtype}")
        if t.ndim != 4:
            raise ValueError(f"flash_attention: {name} must be (B, S, H, "
                             f"hd), got shape {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             f"contiguous (strides {tuple(t.stride())})")
        elem = t.element_size()
        if t.data_ptr() % 16 or any(s * elem % 16 for s in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned in every row (strides "
                             f"{tuple(t.stride())})")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device \
            or v.device != q.device:
        raise TypeError("flash_attention: q, k, v must share dtype and "
                        "device")
    B, Sq, Hq, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"flash_attention: shapes differ, q {tuple(q.shape)}"
                         f" k {tuple(k.shape)} v {tuple(v.shape)}")
    if hd not in _HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{_HEAD_DIMS}")
    if Hq % k.shape[2]:
        raise ValueError(f"flash_attention: {Hq} q heads do not group over "
                         f"{k.shape[2]} kv heads")
    if causal and Sq != k.shape[1]:
        raise ValueError(f"flash_attention: causal needs Sq == Sk, got "
                         f"{Sq} and {k.shape[1]}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """softmax(QKᵀ/√hd + mask) V on the card (replaces `flash_pallas`)."""
    _check(q, k, v, causal)
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype, device=q.device)
    if B == 0 or Sq == 0 or Hq == 0:
        return out
    if Sk == 0:
        raise ValueError("flash_attention: no keys to attend to")
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_flash_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, Sq, Sk, Hq, Hkv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *out.stride()[:3], int(causal),
            float(1.0 / math.sqrt(hd)), stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention: CUDA launch failed with "
                               f"error {rc}")
        LAUNCHES["flash"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k/v: (B, Sk, Hkv, hd) -> (B, Sq, Hq, hd)."""
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal)
    return flash_attention_cuda(q, k, v, causal=causal)
