"""Dispatching wrapper for the WKV6 kernel (RWKV-6 time-mix recurrence).

`wkv6(r, k, v, logw, u, state, chunk=)` takes the model layout: r, k, v,
logw (B, S, H, dh), u (H, dh), state (B, H, dh, dh). It picks the path
from the tensors' device:
  * CUDA — the hand-written sm_90a kernel of `repro_torch/csrc/wkv6.cu`,
           or an exception; there is no fallback to the plain version
  * CPU  — `ref.wkv_chunked`, the reference's own off-TPU route

Port of `repro.kernels.rwkv6.ops`. The kernel reads and writes the
model layout through its strides, so the reference's transpose to
(B·H, S, dh) and broadcast of u to (B·H, dh) are skipped; it takes any
S ≥ 1, treating rows past S as wkv_chunked's zero padding. One call
launches two kernels (the state pass, then the output pass) through one
C call; the state entering every chunk goes through a float32 workspace
of B·H·ceil(S/C)·dh² entries, allocated per call from PyTorch's caching
allocator (which reuses it in stream order). The CUDA wrapper counts its
calls in `LAUNCHES`, so a run can show that its main path went through
the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import SUB, chunk_rows, wkv_chunked

# One count per call (each call launches both passes); reset with
# `reset_launches()`.
LAUNCHES = {"wkv6": 0}

MAX_CHUNK = 128
# the instantiations of wkv6.cu (r, k, v and y); logw, u, state are float32
_DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2}
_HEAD_DIMS = (32, 64)
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import library
        lib = library("wkv6")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_wkv6_fwd.argtypes = (
            [i32] + [p] * 9 + [i32] * 5 + [i64] * 15 + [p])
        lib.repro_wkv6_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(r, k, v, logw, u, state, chunk: int) -> None:
    named = (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u),
             ("state", state))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"wkv6: expected a CUDA tensor for {name}, got "
                             f"{t.device}")
        if t.device != r.device:
            raise ValueError("wkv6: every tensor must lie on one card")
    for name, t in named[:3]:
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"wkv6: unsupported dtype {t.dtype} for {name}")
        if t.dtype != r.dtype:
            raise TypeError("wkv6: r, k, v must share one dtype")
    for name, t in named[3:]:
        if t.dtype != torch.float32:
            raise TypeError(f"wkv6: {name} must be float32, got {t.dtype}")
    if r.ndim != 4:
        raise ValueError(f"wkv6: r must be (B, S, H, dh), got shape "
                         f"{tuple(r.shape)}")
    B, S, H, dh = r.shape
    for name, t in named[1:4]:
        if t.shape != r.shape:
            raise ValueError(f"wkv6: {name} has shape {tuple(t.shape)}, "
                             f"r {tuple(r.shape)}")
    if tuple(u.shape) != (H, dh) or tuple(state.shape) != (B, H, dh, dh):
        raise ValueError(f"wkv6: u {tuple(u.shape)} and state "
                         f"{tuple(state.shape)} do not fit r "
                         f"{tuple(r.shape)}")
    if dh not in _HEAD_DIMS:
        raise ValueError(f"wkv6: head dim {dh} not in {_HEAD_DIMS}")
    for name, t in named[:4]:
        if t.stride(-1) != 1:
            raise ValueError(f"wkv6: {name}'s head dim must be contiguous "
                             f"(strides {tuple(t.stride())})")
        elem = t.element_size()
        if t.data_ptr() % 16 or any(s * elem % 16 for s in t.stride()[:3]):
            raise ValueError(f"wkv6: {name} must be 16-byte aligned in "
                             f"every row (strides {tuple(t.stride())})")
    if chunk % SUB or chunk < SUB:
        raise ValueError(f"wkv6: chunk {chunk} is not a multiple of {SUB}")
    if chunk_rows(S, chunk) > MAX_CHUNK:
        raise ValueError(f"wkv6: chunk {chunk} runs more than {MAX_CHUNK} "
                         f"rows")


def wkv6_cuda(r, k, v, logw, u, state, *, chunk: int = 128):
    """The WKV6 recurrence on the card (replaces `wkv6_pallas`). Returns
    (y (B, S, H, dh) in r's dtype, state' (B, H, dh, dh) float32)."""
    _check(r, k, v, logw, u, state, chunk)
    B, S, H, dh = r.shape
    y = torch.empty((B, S, H, dh), dtype=r.dtype, device=r.device)
    s_out = torch.empty((B, H, dh, dh), dtype=torch.float32, device=r.device)
    if B == 0 or H == 0:
        return y, s_out
    if S == 0:
        return y, s_out.copy_(state)
    u, state = u.contiguous(), state.contiguous()
    lib = _library()
    C = chunk_rows(S, chunk)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        ws = torch.empty(B * H * -(-S // C) * dh * dh, dtype=torch.float32,
                         device=r.device)
        rc = lib.repro_wkv6_fwd(
            _DTYPE_CODE[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
            logw.data_ptr(), u.data_ptr(), state.data_ptr(), y.data_ptr(),
            s_out.data_ptr(), ws.data_ptr(), B, S, H, dh, C,
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *logw.stride()[:3], *y.stride()[:3], stream)
        if rc != 0:
            raise RuntimeError(f"wkv6: CUDA launch failed with error {rc}")
        LAUNCHES["wkv6"] += 1
    return y, s_out


def wkv6(r, k, v, logw, u, state, *, chunk: int = 128):
    """Model layout: r,k,v,logw (B, S, H, dh); u (H, dh); state (B, H, dh,
    dh). Returns (y (B,S,H,dh), state')."""
    if r.device.type == "cpu":
        return wkv_chunked(r, k, v, logw, u, state, chunk)
    return wkv6_cuda(r, k, v, logw, u, state, chunk=chunk)
