"""Plain torch versions of the block-sparse kernel family: XᵀX, X @ W and
Xᵀv over a dense layout of a sparse X and a mask of its nonzero blocks.

Port of `repro.kernels.spmm.ref`, with the mask the kernels take:
`mask[r, t]` is the int32 count of nonzeros in the block of X at row chunk
r (`bm` rows) and column tile t (`bn` columns); the last chunk and tile may
be ragged. Each function visits the kernel's own blocks: it first zeroes
every block whose count is 0, the blocks the CUDA kernels skip, so a
skipped term is exactly zero here too and a wrong mask gives a wrong
result. The dtype rule is `kernels/gram/ref.py`'s: float64 and float32
compute and return in their own dtype, bfloat16 accumulates and returns
float32. The CPU path of the runtime runs these, and `chip_smoke.py` holds
the CUDA kernels against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gram import ref as gram_ref


def _blocks(m: int, n: int, bm: int, bn: int) -> tuple[int, int]:
    return -(-m // bm), -(-n // bn)


def block_mask(x: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """int32 per-block nonzero counts of a dense matrix, ragged edges
    allowed (the reference's `block_mask` wants padded shapes)."""
    m, n = x.shape
    kr, kc = _blocks(m, n, bm, bn)
    nz = torch.zeros((kr * bm, kc * bn), dtype=torch.int32, device=x.device)
    nz[:m, :n] = (x != 0).to(torch.int32)
    return nz.view(kr, bm, kc, bn).sum(dim=(1, 3), dtype=torch.int32)


def skip_masked(x: torch.Tensor, mask: torch.Tensor, bm: int,
                bn: int) -> torch.Tensor:
    """`x` with every block whose mask count is 0 set to zero."""
    m, n = x.shape
    if tuple(mask.shape) != _blocks(m, n, bm, bn):
        raise ValueError(f"mask {tuple(mask.shape)} does not tile "
                         f"{tuple(x.shape)} in {bm} x {bn} blocks")
    keep = (mask > 0).repeat_interleave(bm, 0)[:m].repeat_interleave(
        bn, 1)[:, :n]
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def gram(x: torch.Tensor, mask: torch.Tensor, bm: int,
         bn: int) -> torch.Tensor:
    """XᵀX over the unmasked blocks, bitwise symmetric."""
    return gram_ref.gram(skip_masked(x, mask, bm, bn))


def spmm(x: torch.Tensor, w: torch.Tensor, mask: torch.Tensor, bm: int,
         bk: int) -> torch.Tensor:
    """X @ W over the unmasked blocks of X."""
    acc = gram_ref.acc_dtype(x.dtype)
    return torch.matmul(skip_masked(x, mask, bm, bk).to(acc), w.to(acc))


def xtv(x: torch.Tensor, v: torch.Tensor, mask: torch.Tensor, bm: int,
        bn: int) -> torch.Tensor:
    """Xᵀv over the unmasked blocks of X."""
    return gram_ref.xtv(skip_masked(x, mask, bm, bn), v)
