"""Layer blocks: per-kind init / prefill forward / decode step.

Port of `repro.models.blocks`. A kind names one residual layer's
composition:
  "attn"            self-attention + dense MLP  (dense/audio/vlm self;
                    jamba's attention layer)
  "attn+moe"        self-attention + MoE FFN    (deepseek, jamba-attn)
  "attn+mlp_first"  the dense first layers of the deepseek models
                    (self-attention + a dense MLP of d_ff)
  "xattn"           cross-attention (image) + MLP (llama-vision)
  "mamba"           mamba mixer + dense MLP     (jamba)
  "mamba+moe"       mamba mixer + MoE FFN       (jamba)
  "rwkv6"           rwkv6 time-mix + channel-mix (the ssm family, Finch)
all pre-norm residual. The attention of the "attn" kinds is MLA where
`cfg.attn_type` is "mla" (deepseek-v2), GQA otherwise. Decode carries a
per-layer cache whose structure is fixed per kind (see `cache_spec`) and
updates it in place; the xattn cache (the image's K/V, written at
prefill) is only read. `block_forward(..., plain=True)` (training) runs
every mixer on the reference's plain route ("chunked" attention,
`wkv_chunked`, `selective_scan`) on any device: no kernel has a
backward.
"""
from __future__ import annotations

import torch
from torch import nn

from . import attention as attn_mod
from . import mamba as mamba_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import rwkv6 as rwkv_mod
from .layers import MLP, RMSNorm, cdtype


class Block(nn.Module):
    """One layer: norm1, norm2 and, by kind, a mixer (attn: GQA or MLA;
    xattn; mamba; rwkv: time-mix + channel-mix, "rwkv6", which needs no
    FFN) and an FFN (moe for "+moe" kinds, else mlp: SwiGLU)."""

    def __init__(self, cfg, kind: str, device=None):
        super().__init__()
        self.norm1 = RMSNorm(cfg.d_model, device)
        self.norm2 = RMSNorm(cfg.d_model, device)
        if kind == "rwkv6":
            self.rwkv = rwkv_mod.RWKV6(cfg, device)
            return
        if kind.startswith("attn"):
            self.attn = (mla_mod.MLA(cfg, device) if cfg.attn_type == "mla"
                         else attn_mod.GQA(cfg, device))
        elif kind == "xattn":
            self.xattn = attn_mod.XAttn(cfg, device)
        elif kind.startswith("mamba"):
            self.mamba = mamba_mod.Mamba(cfg, device)
        else:
            raise ValueError(f"unknown layer kind {kind!r}")
        if kind.endswith("+moe"):
            self.moe = moe_mod.MoE(cfg, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cdtype(cfg), device)

    def reset_parameters(self, gen: torch.Generator, cfg) -> None:
        self.norm1.reset_parameters(gen)
        self.norm2.reset_parameters(gen)
        for name in ("rwkv", "attn", "xattn", "mamba", "moe"):
            if hasattr(self, name):
                getattr(self, name).reset_parameters(gen, cfg)
        if hasattr(self, "mlp"):
            self.mlp.reset_parameters(gen)


def block_init(gen: torch.Generator, cfg, kind: str, device=None) -> Block:
    blk = Block(cfg, kind, device)
    blk.reset_parameters(gen, cfg)
    return blk


def _ffn(p: Block, cfg, kind: str, x, aux):
    """x + the layer's FFN of norm2(x); returns (x, the MoE's aux loss, or
    `aux` for a dense MLP)."""
    if kind.endswith("+moe"):
        y, aux = moe_mod.moe_forward(p.moe, cfg, p.norm2(x))
        return x + y, aux
    return x + p.mlp(p.norm2(x)), aux


def block_forward(p: Block, cfg, kind: str, x, positions,
                  image_embeds=None, collect_cache: bool = False,
                  plain: bool = False):
    """Returns (x, aux_loss, the layer's cache or None). `plain` takes the
    reference's plain routes, whatever the device (training)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cache = None
    impl = attn_mod.PLAIN if plain else None
    if kind == "rwkv6":
        # a fresh sequence: zero float32 WKV state, zero token shifts
        dh = cfg.rwkv_head_dim
        state = torch.zeros((x.shape[0], cfg.d_model // dh, dh, dh),
                            dtype=torch.float32, device=x.device)
        y, shift_tm, state = rwkv_mod.time_mix(p.rwkv, cfg, p.norm1(x), None,
                                               state, plain=plain)
        x = x + y
        y, shift_cm = rwkv_mod.channel_mix(p.rwkv, p.norm2(x), None)
        x = x + y
        if collect_cache:
            cache = {"wkv": state, "shift_tm": shift_tm.to(cdtype(cfg)),
                     "shift_cm": shift_cm.to(cdtype(cfg))}
        return x, aux, cache
    if kind.startswith("attn") or kind == "xattn":
        h = p.norm1(x)
        if kind == "xattn":  # the image's K/V, so decode never re-encodes it
            y, kv = attn_mod.xattn_forward(p.xattn, cfg, h, image_embeds,
                                           impl)
        elif cfg.attn_type == "mla":  # the latent and RoPE-key caches
            y, kv = mla_mod.mla_forward(p.attn, cfg, h, positions, impl)
        else:
            y, kv = attn_mod.gqa_forward(p.attn, cfg, h, positions, impl)
        if collect_cache:
            cache = tuple(t.to(cdtype(cfg)) for t in kv)
    else:
        y, state = mamba_mod.mamba_forward(p.mamba, cfg, p.norm1(x),
                                           plain=plain)
        if collect_cache:
            cache = {"h": state["h"], "conv": state["conv"].to(cdtype(cfg))}
    x, aux = _ffn(p, cfg, kind, x + y, aux)
    return x, aux, cache


def block_decode(p: Block, cfg, kind: str, x, cache, cur_len: int):
    """x: (B, 1, D); returns (x, cache), the cache updated in place."""
    if kind == "rwkv6":
        y, shift_tm, state = rwkv_mod.time_mix(
            p.rwkv, cfg, p.norm1(x), cache["shift_tm"].to(x.dtype),
            cache["wkv"], decode=True)
        x = x + y
        y, shift_cm = rwkv_mod.channel_mix(p.rwkv, p.norm2(x),
                                           cache["shift_cm"].to(x.dtype))
        cache["wkv"].copy_(state)
        cache["shift_tm"].copy_(shift_tm)
        cache["shift_cm"].copy_(shift_cm)
        return x + y, cache
    if kind == "xattn":
        y = attn_mod.xattn_decode(p.xattn, cfg, p.norm1(x), cache)
    elif kind.startswith("attn") and cfg.attn_type == "mla":
        y, cache = mla_mod.mla_decode(p.attn, cfg, p.norm1(x), cache,
                                      cur_len)
    elif kind.startswith("attn"):
        y, cache = attn_mod.gqa_decode(p.attn, cfg, p.norm1(x), cache,
                                       cur_len)
    else:
        state = {"h": cache["h"], "conv": cache["conv"].to(x.dtype)}
        y, state = mamba_mod.mamba_forward(p.mamba, cfg, p.norm1(x), state,
                                           decode=True)
        cache["h"].copy_(state["h"])
        cache["conv"].copy_(state["conv"])
    return _ffn(p, cfg, kind, x + y, None)[0], cache


def cache_spec(cfg, kind: str, batch: int, max_len: int):
    """One layer's cache as (shape, dtype) leaves: (K, V) for the attn
    kinds, (c_kv, k_rope) under MLA (sequence on axis 1); the image's
    (K, V) for "xattn"; {"wkv", "shift_tm", "shift_cm"} for "rwkv6" and
    {"h", "conv"} for the mamba kinds (no sequence axis: `max_len`
    allocates nothing)."""
    if kind == "rwkv6":
        return rwkv_mod.rwkv6_state_spec(cfg, batch)
    if kind.startswith("mamba"):
        return mamba_mod.mamba_state_spec(cfg, batch)
    if kind == "xattn":
        return attn_mod.xattn_cache_spec(cfg, batch)
    if cfg.attn_type == "mla":
        return mla_mod.mla_cache_spec(cfg, batch, max_len)
    return attn_mod.gqa_cache_spec(cfg, batch, max_len)
