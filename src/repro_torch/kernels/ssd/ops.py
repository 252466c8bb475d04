"""Dispatching wrapper for the Mamba selective-scan kernel.

`ssm_scan(x, dt, A, B, C, D_skip, h0)` takes the model layout: x, dt
(Bt, S, di); A (di, ds); B, C (Bt, S, ds); D_skip (di,); h0 (Bt, di, ds).
It picks the path from the tensors' device:
  * CUDA — the hand-written sm_90a kernel of `repro_torch/csrc/ssd.cu`,
           or an exception; there is no fallback to the plain version
  * CPU  — `ref.ssm_scan`, the reference's oracle (its own off-TPU route)

Port of `repro.kernels.ssd.ops`. The kernel reads x, dt, B and C through
their (batch, sequence) strides, so B and C may be the column views that
`split` cuts from the model's `dbc`; it takes any S ≥ 1 and any di (the
Pallas kernel wants S and di divisible by its blocks). Its exps are
2^(dt · A log2 e + 1) / 2 on the MUFU, which `ref.kernel_decay`
emulates around the MUFU itself. The CUDA wrapper counts its launches in `LAUNCHES`, so a run can show that
its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import ssm_scan as ssm_scan_plain

# One count per kernel launch; reset with `reset_launches()`.
LAUNCHES = {"ssm_scan": 0}

# the instantiations of ssd.cu (x, B and C); dt, A, D_skip, h0 are float32
_DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2}
D_STATES = (4, 8, 16)
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels.build import library
        lib = library("ssd")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.repro_ssm_scan_fwd.argtypes = (
            [i32, i32] + [p] * 9 + [i32] * 4 + [i64] * 10 + [p])
        lib.repro_ssm_scan_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, dt, A, B, C, D_skip, h0) -> None:
    named = (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C),
             ("D_skip", D_skip), ("h0", h0))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"ssm_scan: expected a CUDA tensor for {name}, "
                             f"got {t.device}")
        if t.device != x.device:
            raise ValueError("ssm_scan: every tensor must lie on one card")
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"ssm_scan: unsupported dtype {t.dtype} for "
                            f"{name}")
        if t.dtype != x.dtype:
            raise TypeError("ssm_scan: x, B, C must share one dtype")
    for name, t in (("dt", dt), ("A", A), ("D_skip", D_skip), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssm_scan: {name} must be float32, got "
                            f"{t.dtype}")
    if x.ndim != 3:
        raise ValueError(f"ssm_scan: x must be (Bt, S, di), got shape "
                         f"{tuple(x.shape)}")
    Bt, S, di = x.shape
    ds = A.shape[-1] if A.ndim == 2 else -1
    want = {"dt": (Bt, S, di), "A": (di, ds), "B": (Bt, S, ds),
            "C": (Bt, S, ds), "D_skip": (di,), "h0": (Bt, di, ds)}
    for name, t in named[1:]:
        if tuple(t.shape) != want[name]:
            raise ValueError(f"ssm_scan: {name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]} for x "
                             f"{tuple(x.shape)}")
    if ds not in D_STATES:
        raise ValueError(f"ssm_scan: d_state {ds} not in {D_STATES}")
    for name, t in (("x", x), ("dt", dt), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssm_scan: {name}'s last dim must be "
                             f"contiguous (strides {tuple(t.stride())})")


def _aligned16(*tensors) -> bool:
    """The kernel's 16-byte copies of x and dt need their base pointers
    and their (batch, sequence) strides 16-byte aligned."""
    return all(t.data_ptr() % 16 == 0
               and all(st * t.element_size() % 16 == 0
                       for st in t.stride()[:2])
               for t in tensors)


def ssm_scan_cuda(x, dt, A, B, C, D_skip, h0):
    """The selective scan on the card (replaces `ssm_scan_pallas`).
    Returns (y (Bt, S, di) float32, h (Bt, di, ds) float32)."""
    _check(x, dt, A, B, C, D_skip, h0)
    Bt, S, di = x.shape
    ds = A.shape[1]
    y = torch.empty((Bt, S, di), dtype=torch.float32, device=x.device)
    h_out = torch.empty((Bt, di, ds), dtype=torch.float32, device=x.device)
    if Bt == 0 or di == 0:
        return y, h_out
    if S == 0:
        return y, h_out.copy_(h0)
    # A, D_skip and h0 are read once per channel: contiguous copies cost
    # nothing on the path (they are contiguous there already)
    A, D_skip, h0 = A.contiguous(), D_skip.contiguous(), h0.contiguous()
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.repro_ssm_scan_fwd(
            _DTYPE_CODE[x.dtype], _aligned16(x, dt), x.data_ptr(),
            dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), D_skip.data_ptr(), h0.data_ptr(),
            y.data_ptr(), h_out.data_ptr(), Bt, S, di, ds,
            *x.stride()[:2], *dt.stride()[:2], *B.stride()[:2],
            *C.stride()[:2], *y.stride()[:2], stream)
        if rc != 0:
            raise RuntimeError(f"ssm_scan: CUDA launch failed with error "
                               f"{rc}")
        LAUNCHES["ssm_scan"] += 1
    return y, h_out


def ssm_scan(x, dt, A, B, C, D_skip, h0):
    """x, dt: (Bt, S, di); A: (di, ds); B, C: (Bt, S, ds); D_skip: (di,);
    h0: (Bt, di, ds). Returns (y (Bt, S, di) float32, h_final float32)."""
    if x.device.type == "cpu":
        return ssm_scan_plain(x, dt, A, B, C, D_skip, h0)
    return ssm_scan_cuda(x, dt, A, B, C, D_skip, h0)
