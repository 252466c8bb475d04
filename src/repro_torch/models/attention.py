"""GQA attention with memory-safe chunked softmax + KV-cache decode.

Port of `repro.models.attention`: GQA self-attention and the
cross-attention layer of the vision model. Execution paths for the core
attention:
  * "flash"   — `kernels.flash_attention.ops`: on CUDA the hand-written
    Hopper kernel (`csrc/flash.cu`), on the CPU its plain version; the
    counterpart of the reference's "pallas"
  * "chunked" — q-chunk / kv-chunk online softmax in plain torch, the
    reference's CPU path for S > cfg.attn_chunk
  * "ref"     — full S² materialisation (small shapes / oracle)
On CUDA and on "meta" (the dry run's count, which takes the card's
route: `flash_attention_meta` gives the kernel's output shape and charges
its work), prefill runs "flash" unless the caller names another path. On
the CPU the reference's own choice stands: "flash" (its plain version)
when `cfg.use_pallas`, else "chunked" for S > cfg.attn_chunk and "ref"
otherwise, so the CPU parity tests compare like with like. Training
(`Model.loss`) names "chunked" on every device: the reference trains on
that route (`use_pallas` is off by default) and the flash kernel has no
backward in either package. Every path takes a v whose head dim differs
from q's (MLA) and returns v's.

Decode attends over the padded KV cache with position masking in plain
torch (no Pallas kernel backs it in the reference). The cache is
updated in place at `cur_len` (the reference's functional
`dynamic_update_slice_in_dim` returns a new cache; the port writes the
one slot instead of copying the cache). The reference's `shard_hint`s
are dropped: on the port's logical devices every value is whole on the
runtime's device (`distributed.hints.shard_hint` returns its input).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..kernels.flash_attention import ops as fops
from .layers import (RMSNorm, apply_rope, cdtype, dense_init, frozen, load_,
                     rmsnorm)

NEG_INF = -1e30
# the route training names (`Model.loss`): the reference's with use_pallas
# off, "chunked" for S > cfg.attn_chunk and "ref" otherwise
PLAIN = "chunked"


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------

def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, Hq, hd), k: (B, Sk, Hkv, hd) -> (B, Hkv, G, Sq, Sk)."""
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, hd)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg, k)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B, Hkv, G, Sq, Sk), v: (B, Sk, Hkv, vd) -> (B, Sq, Hq, vd)."""
    B, Hkv, G, Sq, Sk = probs.shape
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, Hkv * G, v.shape[-1])


def _scaled(q: torch.Tensor) -> torch.Tensor:
    """q · 1/√hd in q's dtype, the scale rounded to that dtype first, as
    jax rounds a Python float against a bf16 array (torch would multiply
    by the float32 scale and round once)."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype,
                         device=q.device)
    return q * scale


def ref_attention(q, k, v, *, causal: bool = True,
                  q_offset: int = 0) -> torch.Tensor:
    s = _gqa_scores(_scaled(q), k).float()
    if causal:
        qpos = torch.arange(q.shape[1], device=q.device) + q_offset
        kpos = torch.arange(k.shape[1], device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return _gqa_out(p, v)


def chunked_attention(q, k, v, *, causal: bool = True, q_chunk: int = 1024,
                      k_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax blockwise attention (the flash algorithm in plain
    torch). Each q block walks only its causally visible kv blocks; the
    accumulator is kept in q's dtype, as in the reference."""
    B, Sq, Hq, hd = q.shape
    Sk, Hkv, vd = k.shape[1], k.shape[2], v.shape[-1]
    G = Hq // Hkv
    qc, kc = min(q_chunk, Sq), min(k_chunk, Sk)
    assert Sq % qc == 0 and Sk % kc == 0
    nq, nk = Sq // qc, Sk // kc
    outs = []
    for i in range(nq):
        qg = _scaled(q[:, i * qc:(i + 1) * qc]).reshape(B, qc, Hkv, G, hd)
        n_vis = min(((i + 1) * qc + kc - 1) // kc, nk) if causal else nk
        qpos = torch.arange(i * qc, (i + 1) * qc, device=q.device)
        m = torch.full((B, Hkv, G, qc), NEG_INF, dtype=torch.float32,
                       device=q.device)
        denom = torch.zeros((B, Hkv, G, qc), dtype=torch.float32,
                            device=q.device)
        acc = torch.zeros((B, Hkv, G, qc, vd), dtype=q.dtype, device=q.device)
        for j in range(n_vis):
            kb, vb = k[:, j * kc:(j + 1) * kc], v[:, j * kc:(j + 1) * kc]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb).float()
            if causal:
                kpos = torch.arange(j * kc, (j + 1) * kc, device=q.device)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            denom = denom * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(q.dtype), vb)
            acc = acc * alpha[..., None].to(q.dtype) + pv
            m = m_new
        out = acc / denom[..., None].to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, qc, Hq, vd))
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, cur_len: int) -> torch.Tensor:
    """q: (B, 1, Hq, hd); caches: (B, S, Hkv, ·); attends to the cache
    slots at positions < cur_len."""
    s = _gqa_scores(_scaled(q), k_cache).float()
    kpos = torch.arange(k_cache.shape[1], device=q.device)
    s = torch.where(kpos < cur_len, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return _gqa_out(p, v_cache)


def attention_core(q, k, v, *, causal: bool, cfg, impl: Optional[str] = None,
                   q_offset: int = 0) -> torch.Tensor:
    if impl is None:
        impl = "flash" if q.device.type in ("cuda", "meta") \
            or cfg.use_pallas else "chunked"
    if impl == "flash":
        return fops.flash_attention(q, k, v, causal=causal)
    if impl == "chunked" and q.shape[1] > cfg.attn_chunk:
        return chunked_attention(q, k, v, causal=causal,
                                 q_chunk=cfg.attn_chunk,
                                 k_chunk=cfg.attn_chunk)
    return ref_attention(q, k, v, causal=causal, q_offset=q_offset)


# ---------------------------------------------------------------------------
# GQA attention layer (llama/phi/qwen)
# ---------------------------------------------------------------------------

def gqa_init(gen: torch.Generator, cfg) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    return {"wq": dense_init(gen, d, cfg.n_heads * hd),
            "wk": dense_init(gen, d, cfg.kv_heads * hd),
            "wv": dense_init(gen, d, cfg.kv_heads * hd),
            "wo": dense_init(gen, cfg.n_heads * hd, d)}


class GQA(nn.Module):
    """Parameters of one GQA layer: wq/wk/wv/wo (d_in, d_out) in the
    compute dtype (float32 in a training model), and q_norm/k_norm when
    `cfg.qk_norm`."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.head_dim, cdtype(cfg)
        for name, shape in (("wq", (d, cfg.n_heads * hd)),
                            ("wk", (d, cfg.kv_heads * hd)),
                            ("wv", (d, cfg.kv_heads * hd)),
                            ("wo", (cfg.n_heads * hd, d))):
            setattr(self, name, frozen(torch.zeros(shape, dtype=dt,
                                                   device=device)))
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, device)
            self.k_norm = RMSNorm(hd, device)

    def reset_parameters(self, gen: torch.Generator, cfg) -> None:
        load_(self, gqa_init(gen, cfg))
        if cfg.qk_norm:
            self.q_norm.reset_parameters(gen)
            self.k_norm.reset_parameters(gen)


def _qkv(p: GQA, cfg, x, positions):
    B, S, D = x.shape
    hd, dt = cfg.head_dim, x.dtype
    q = (x @ p.wq.to(dt)).reshape(B, S, cfg.n_heads, hd)
    k = (x @ p.wk.to(dt)).reshape(B, S, cfg.kv_heads, hd)
    v = (x @ p.wv.to(dt)).reshape(B, S, cfg.kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm.scale, q)
        k = rmsnorm(p.k_norm.scale, k)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_forward(p: GQA, cfg, x, positions, impl: Optional[str] = None):
    """Prefill: returns (out, (k, v)) for cache construction."""
    q, k, v = _qkv(p, cfg, x, positions)
    out = attention_core(q, k, v, causal=True, cfg=cfg, impl=impl)
    return out.reshape(x.shape[0], x.shape[1], -1) @ p.wo.to(x.dtype), \
        (k, v)


def gqa_decode(p: GQA, cfg, x, cache: tuple, cur_len: int):
    """x: (B, 1, D); cache: (k (B, S, Hkv, hd), v), updated in place at
    `cur_len`; returns (out, cache)."""
    B = x.shape[0]
    positions = torch.full((B, 1), cur_len, dtype=torch.int32,
                           device=x.device)
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    k_cache, v_cache = cache
    k_cache[:, cur_len] = k_new[:, 0]
    v_cache[:, cur_len] = v_new[:, 0]
    out = decode_attention(q, k_cache, v_cache, cur_len + 1)
    return out.reshape(B, 1, -1) @ p.wo.to(x.dtype), cache


def gqa_cache_spec(cfg, batch: int, max_len: int):
    """((shape, dtype), (shape, dtype)) of one layer's K and V cache."""
    shape = (batch, max_len, cfg.kv_heads, cfg.head_dim)
    return ((shape, cdtype(cfg)), (shape, cdtype(cfg)))


# ---------------------------------------------------------------------------
# Cross-attention layer (llama-3.2-vision image layers)
# ---------------------------------------------------------------------------

def xattn_init(gen: torch.Generator, cfg) -> dict:
    """The reference's values: `gate` starts at 0 (tanh(0) = 0 keeps a
    fresh model's image layers closed)."""
    d, hd = cfg.d_model, cfg.head_dim
    return {"wq": dense_init(gen, d, cfg.n_heads * hd),
            "wk": dense_init(gen, d, cfg.kv_heads * hd),
            "wv": dense_init(gen, d, cfg.kv_heads * hd),
            "wo": dense_init(gen, cfg.n_heads * hd, d),
            "gate": torch.zeros((1,), dtype=torch.float32,
                                device=gen.device)}


class XAttn(nn.Module):
    """Parameters of one cross-attention layer: wq/wk/wv/wo in the compute
    dtype and the tanh `gate` (1,), which the reference uses in float32."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, hd, dt = cfg.d_model, cfg.head_dim, cdtype(cfg)
        for name, shape in (("wq", (d, cfg.n_heads * hd)),
                            ("wk", (d, cfg.kv_heads * hd)),
                            ("wv", (d, cfg.kv_heads * hd)),
                            ("wo", (cfg.n_heads * hd, d))):
            setattr(self, name, frozen(torch.zeros(shape, dtype=dt,
                                                   device=device)))
        self.gate = frozen(torch.zeros(1, dtype=torch.float32, device=device))

    def reset_parameters(self, gen: torch.Generator, cfg) -> None:
        load_(self, xattn_init(gen, cfg))


def xattn_forward(p: XAttn, cfg, x, image_embeds, impl: Optional[str] = None):
    """Cross-attend text states (B, S, D) to the image embeddings (B,
    n_img, D), non-causal; returns (tanh(gate) · out, (k, v)), the image's
    K/V (B, n_img, Hkv, hd) for the cache."""
    B, S, _ = x.shape
    dt = x.dtype
    kv_shape = (B, image_embeds.shape[1], cfg.kv_heads, cfg.head_dim)
    q = (x @ p.wq.to(dt)).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = (image_embeds @ p.wk.to(dt)).reshape(kv_shape)
    v = (image_embeds @ p.wv.to(dt)).reshape(kv_shape)
    out = attention_core(q, k, v, causal=False, cfg=cfg, impl=impl)
    out = out.reshape(B, S, -1) @ p.wo.to(dt)
    return torch.tanh(p.gate).to(dt) * out, (k, v)


def xattn_decode(p: XAttn, cfg, x, cache: tuple):
    """x: (B, 1, D) against the cached image K/V through the plain
    attention (as the reference's decode); returns tanh(gate) · out."""
    B, dt = x.shape[0], x.dtype
    k_img, v_img = cache
    q = (x @ p.wq.to(dt)).reshape(B, 1, cfg.n_heads, cfg.head_dim)
    out = ref_attention(q, k_img.to(dt), v_img.to(dt), causal=False)
    return torch.tanh(p.gate).to(dt) * (out.reshape(B, 1, -1) @ p.wo.to(dt))


def xattn_cache_spec(cfg, batch: int):
    """((shape, dtype), (shape, dtype)) of one layer's image K and V (no
    sequence axis: allocated at `cfg.n_image_tokens`)."""
    shape = (batch, cfg.n_image_tokens, cfg.kv_heads, cfg.head_dim)
    return ((shape, cdtype(cfg)), (shape, cdtype(cfg)))
