"""Plain torch version of flash attention (GQA, causal or full).

Port of `repro.kernels.flash_attention.ref`, line for line: q is scaled
in its own dtype before the score product, the scores are taken to
float32 and masked with NEG_INF, the softmax runs in float32 and the
probabilities are cast to q's dtype before the product with v. The CPU
path of `ops.flash_attention` and the card's plain comparison use it.
`scaled_err` is the per-entry measure the kernel is held to.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k: (B, Sk, Hkv, hd); v: (B, Sk, Hkv, dv);
    Hq % Hkv == 0. The scale is 1/√hd, q's width, whatever v's."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd) * float(1.0 / math.sqrt(hd))
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).float()
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(k.shape[1], device=q.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v)
    return out.reshape(B, Sq, Hq, v.shape[-1])



def scaled_err(got: torch.Tensor, want: torch.Tensor, q: torch.Tensor,
               k: torch.Tensor, v: torch.Tensor, *,
               causal: bool = True) -> float:
    """max |got - want| per entry over its envelope Σ_j p_j |v_j| (the
    attention of the same q, k over |v|), in float32. An output entry is
    Σ_j p_j v_j, so a relative rounding ≤ u of each p_j moves it by at
    most u times the envelope, and the output's own rounding by at most
    u more: a bfloat16 kernel (u = 2⁻⁸) whose only roundings beyond
    float32 are these two reads ≤ 2⁻⁷ plus float32's share. The envelope
    is of the entry's own size in every row, where max|v| is not: a late
    causal row averages ~S values of v, ~S^-½ max|v| in size, so a fault
    that moves only late rows can hide under a bound in max|v|."""
    env = attention(q.float(), k.float(), v.float().abs(), causal=causal)
    err = (got.float() - want.float()).abs() / env.clamp_min(1e-30)
    return err.max().item()
