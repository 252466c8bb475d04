"""Plain torch versions of the gram (tsmm) kernel family.

Port of `repro.kernels.gram.ref` with the same dtype rule: float64 and
float32 compute and return in their own dtype; bfloat16/float16 inputs
accumulate and return float32. The CPU path of the runtime runs these,
and `chip_smoke.py` holds the CUDA kernels against them on the card,
entry by entry with `scaled_err`.
"""
from __future__ import annotations

import torch

_LOW = (torch.bfloat16, torch.float16)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation and output dtype for inputs of `dtype`."""
    return torch.float32 if dtype in _LOW else dtype


def gram(x: torch.Tensor) -> torch.Tensor:
    """X^T X, mirrored from its upper triangle so that the result is
    bitwise symmetric, as the CUDA kernel's is."""
    xa = x.to(acc_dtype(x.dtype))
    g = torch.matmul(xa.mT, xa)
    return torch.triu(g) + torch.triu(g, 1).mT


def xtv(x: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """X^T v (v may be 1-D or have several columns)."""
    acc = acc_dtype(x.dtype)
    return torch.matmul(x.to(acc).mT, v.to(acc))


def scaled_err(got: torch.Tensor, want: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> float:
    """max |got - want| of a product aᵀb, each entry over |a_i| |b_j|, the
    column norms of its two factors (its Cauchy-Schwarz bound), in
    float64. Two sums of the same products in another order differ by a
    few rounding units of this scale; a wrong entry by far more."""
    na = torch.linalg.vector_norm(a.double(), dim=0)
    nb = torch.linalg.vector_norm(b.double(), dim=0)
    scale = (na[:, None] * nb[None, :]).clamp_min(1e-300)
    return ((got.double() - want.double()).abs() / scale).max().item()
