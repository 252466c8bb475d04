"""Plain torch version of flash attention (GQA, causal or full).

Port of `repro.kernels.flash_attention.ref`, line for line: q is scaled
in its own dtype before the score product, the scores are taken to
float32 and masked with NEG_INF, the softmax runs in float32 and the
probabilities are cast to q's dtype before the product with v. The CPU
path of `ops.flash_attention` and the card's plain comparison use it.
`scaled_err` is the per-entry measure the kernel is held to.

`attention_tf32x3` emulates the float32 CUDA kernel on the CPU, for the
tests only: its kv tiles, its online-softmax rescale order and its
operands' TF32 hi/lo rounding (3xTF32), so the tests can show that these
roundings meet the float32 limit and that one TF32 rounding would not.
It does not model the tensor cores' own float32 accumulation (each
product here is a CPU float32 matmul), whose truncating sums along a
chain set most of the card's error; the kernel's split accumulators and
PV groups, which shorten those chains, are checked only on the card (the
`cuda` tests and chip_smoke.py).
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


# kv rows per tile of the float32 CUDA kernel (flash.cu's FTile::BN), by
# (q/k head dim, v head dim)
F32_KV_TILE = {(32, 32): 64, (64, 64): 64, (128, 128): 32, (192, 128): 32}
LOG2E = 1.4426950408889634


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """float32 `x` as a TF32 mma operand reads it: its low 13 bits
    cleared (truncated toward zero)."""
    bits = x.contiguous().view(torch.int32)
    return (bits & -0x2000).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ b in float32 as the kernel's mma steps take it: with `split`,
    each operand's hi = tf32_truncate(x) (x handed to the mma as it is)
    and lo = tf32_truncate(x - hi) (x - hi exact, truncated by the mma),
    and lo·hi + hi·lo + hi·hi (3xTF32); without, hi·hi alone (one TF32
    rounding)."""
    ah, bh = tf32_truncate(a), tf32_truncate(b)
    if not split:
        return ah @ bh
    al, bl = tf32_truncate(a - ah), tf32_truncate(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def attention_tf32x3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, split: bool = True
                     ) -> torch.Tensor:
    """The float32 kernel's operand roundings and tile order, in float32
    on any device (the tensor cores' accumulation not modelled): kv tiles
    of F32_KV_TILE[(hd, dv)] keys; per tile S = Q Kᵀ, x = S·(scale·log2 e)
    masked with NEG_INF, m' = max(m, rowmax x), α = 2^(m − m'),
    p = 2^(x − m'), l = l·α + Σ p, O = O·α + P V; the output
    O · (1 / max(l, 1e-30)). Both products with `split` as 3xTF32 (Q, K,
    P and V each hi + lo), without it with one TF32 rounding of each
    operand (`_product`). Shapes as `attention`'s; returns float32."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    bn = F32_KV_TILE[(hd, dv)]
    G = Hq // Hkv
    qg = q.float().reshape(B, Sq, Hkv, G, hd).permute(0, 2, 3, 1, 4)
    kt = k.float().permute(0, 2, 1, 3)[:, :, None]  # (B, Hkv, 1, Sk, hd)
    vt = v.float().permute(0, 2, 1, 3)[:, :, None]
    # the kernel's float32 scale (a C float) times log2 e in float32
    sc = (torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
          * torch.tensor(LOG2E, dtype=torch.float32)).item()
    rows = torch.arange(Sq, device=q.device)[:, None]
    m = torch.full((B, Hkv, G, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    o = torch.zeros((B, Hkv, G, Sq, dv), device=q.device)
    for n0 in range(0, Sk, bn):
        x = _product(qg, kt[..., n0:n0 + bn, :].transpose(-1, -2),
                     split) * sc
        if causal:
            cols = torch.arange(n0, min(n0 + bn, Sk), device=q.device)
            x = torch.where(cols[None, :] <= rows, x, NEG_INF)
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        m = m_new
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + _product(p, vt[..., n0:n0 + bn, :], split)
    out = o * (1.0 / l.clamp_min(1e-30))  # one division a row
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, dv)
