"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

Port of `repro.models.mla`. KV states are compressed into a rank
`kv_lora_rank` latent c_kv plus one RoPE key shared by every head.
Prefill expands per-head K/V from the latent and runs the core attention
with q/k of width head_dim + rope_head_dim (192 at DeepSeek-V2's widths)
and v of width v_head_dim (128), unpadded: on the card that is the flash
kernel's (192, 128) instantiation, on the CPU the plain attention, both
reading v at its own width. The reference pads v to q's width and slices
the output back; the two routes agree to float32 rounding
(tests/test_torch_mla.py).
Decode runs in the *absorbed* form, as in the reference: scores and
context are computed against the compressed cache in plain torch (no
kernel backs it in the reference), so the per-token cache is
kv_lora_rank + rope_head_dim values. The cache is updated in place at
`cur_len`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from . import attention as attn_mod
from .layers import (RMSNorm, _normal, apply_rope, cdtype, dense_init, frozen,
                     load_, rmsnorm)


def mla_init(gen: torch.Generator, cfg) -> dict:
    """Float32 values with the reference's distributions and scales (the
    norms are drawn by their own modules)."""
    d = cfg.d_model
    nh, dn, dr, dv = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim, cfg.vdim
    L, qL = cfg.kv_lora_rank, cfg.q_lora_rank
    p = {}
    if qL:
        p["wq_a"] = dense_init(gen, d, qL)
        p["wq_b"] = dense_init(gen, qL, nh * (dn + dr))
    else:
        p["wq"] = dense_init(gen, d, nh * (dn + dr))
    p["wkv_a"] = dense_init(gen, d, L + dr)
    p["wkv_b_k"] = _normal(gen, (L, nh, dn), 1.0 / math.sqrt(L))
    p["wkv_b_v"] = _normal(gen, (L, nh, dv), 1.0 / math.sqrt(L))
    p["wo"] = dense_init(gen, nh * dv, d)
    return p


class MLA(nn.Module):
    """Parameters of one MLA layer, with the reference's leaf names:
    wq_a, q_norm, wq_b (or wq when q_lora_rank is 0), wkv_a, kv_norm,
    wkv_b_k (L, H, dn), wkv_b_v (L, H, dv) and wo, the matrices in the
    compute dtype (float32 in a training model)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, dt = cfg.d_model, cdtype(cfg)
        nh, dn, dr, dv = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim, cfg.vdim
        L, qL = cfg.kv_lora_rank, cfg.q_lora_rank
        shapes = {"wkv_a": (d, L + dr), "wkv_b_k": (L, nh, dn),
                  "wkv_b_v": (L, nh, dv), "wo": (nh * dv, d)}
        if qL:
            shapes.update(wq_a=(d, qL), wq_b=(qL, nh * (dn + dr)))
            self.q_norm = RMSNorm(qL, device)
        else:
            shapes["wq"] = (d, nh * (dn + dr))
        for name, shape in shapes.items():
            setattr(self, name, frozen(torch.zeros(shape, dtype=dt,
                                                   device=device)))
        self.kv_norm = RMSNorm(L, device)

    def reset_parameters(self, gen: torch.Generator, cfg) -> None:
        load_(self, mla_init(gen, cfg))
        if cfg.q_lora_rank:
            self.q_norm.reset_parameters(gen)
        self.kv_norm.reset_parameters(gen)


def _queries(p: MLA, cfg, x, positions):
    """(q_nope (B, S, H, dn), q_rope (B, S, H, dr)), RoPE on the latter."""
    B, S, _ = x.shape
    nh, dn, dr = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim
    dt = x.dtype
    if cfg.q_lora_rank:
        q = rmsnorm(p.q_norm.scale, x @ p.wq_a.to(dt)) @ p.wq_b.to(dt)
    else:
        q = x @ p.wq.to(dt)
    q = q.reshape(B, S, nh, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)


def _latents(p: MLA, cfg, x, positions):
    """(c_kv (B, S, L) normed, k_rope (B, S, dr)), the one RoPE key."""
    L = cfg.kv_lora_rank
    ckv_full = x @ p.wkv_a.to(x.dtype)                   # (B, S, L + dr)
    c_kv = rmsnorm(p.kv_norm.scale, ckv_full[..., :L])
    k_rope = apply_rope(ckv_full[..., L:][:, :, None, :], positions,
                        cfg.rope_theta)
    return c_kv, k_rope[:, :, 0, :]


def mla_forward(p: MLA, cfg, x, positions, impl: Optional[str] = None):
    """Prefill: expand per-head K/V from the latent; returns (out,
    (c_kv, k_rope)) for the cache."""
    B, S, _ = x.shape
    dt = x.dtype
    nh, dn, dr, dv = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim, cfg.vdim
    q_nope, q_rope = _queries(p, cfg, x, positions)
    c_kv, k_rope = _latents(p, cfg, x, positions)
    k_nope = torch.einsum("bsl,lhd->bshd", c_kv, p.wkv_b_k.to(dt))
    v = torch.einsum("bsl,lhd->bshd", c_kv, p.wkv_b_v.to(dt))
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, nh, dr)],
                  dim=-1)
    out = attn_mod.attention_core(q, k, v, causal=True, cfg=cfg, impl=impl)
    out = out.reshape(B, S, nh * dv)
    return out @ p.wo.to(dt), (c_kv, k_rope)


def mla_decode(p: MLA, cfg, x, cache, cur_len: int):
    """Absorbed decode, x: (B, 1, D): attention directly over the
    compressed cache (c_kv (B, S, L), k_rope (B, S, dr)), which is updated
    in place at `cur_len`; returns (out, cache)."""
    B = x.shape[0]
    nh, dn, dr, dv = cfg.n_heads, cfg.head_dim, cfg.rope_head_dim, cfg.vdim
    dt = x.dtype
    positions = torch.full((B, 1), cur_len, dtype=torch.int32,
                           device=x.device)
    q_nope, q_rope = _queries(p, cfg, x, positions)     # (B, 1, H, ·)
    c_new, kr_new = _latents(p, cfg, x, positions)      # (B, 1, L), (B, 1, dr)
    ckv_cache, kr_cache = cache
    ckv_cache[:, cur_len] = c_new[:, 0]
    kr_cache[:, cur_len] = kr_new[:, 0]

    # absorb wkv_b_k into the query: (B, 1, H, dn)·(L, H, dn) -> (B, 1, H, L)
    q_abs = torch.einsum("bqhd,lhd->bqhl", q_nope, p.wkv_b_k.to(dt))
    ck = ckv_cache.to(dt)
    scores = (torch.einsum("bqhl,bsl->bhqs", q_abs, ck)
              + torch.einsum("bqhd,bsd->bhqs", q_rope, kr_cache.to(dt)))
    scores = scores.float() / float(math.sqrt(dn + dr))
    kpos = torch.arange(ck.shape[1], device=x.device)
    scores = torch.where(kpos < cur_len + 1, scores, attn_mod.NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(dt)
    ctx = torch.einsum("bhqs,bsl->bqhl", probs, ck)     # (B, 1, H, L)
    out = torch.einsum("bqhl,lhd->bqhd", ctx, p.wkv_b_v.to(dt))
    return out.reshape(B, 1, nh * dv) @ p.wo.to(dt), cache


def mla_cache_spec(cfg, batch: int, max_len: int):
    """((shape, dtype), (shape, dtype)) of one layer's latent cache
    (B, max_len, kv_lora_rank) and RoPE-key cache (B, max_len, dr)."""
    return (((batch, max_len, cfg.kv_lora_rank), cdtype(cfg)),
            ((batch, max_len, cfg.rope_head_dim), cdtype(cfg)))
