"""Layer blocks: per-kind init / prefill forward / decode step.

Port of `repro.models.blocks` for the kinds
  "attn"   self-attention + dense MLP     (the dense family)
  "rwkv6"  rwkv6 time-mix + channel-mix   (the ssm family, Finch)
all pre-norm residual. Every other kind raises `NotImplementedError`
naming the ROADMAP item it waits for. Decode carries a per-layer cache
whose structure is fixed per kind (see `cache_spec`) and updates it in
place.
"""
from __future__ import annotations

import torch
from torch import nn

from . import attention as attn_mod
from . import rwkv6 as rwkv_mod
from .layers import MLP, RMSNorm, cdtype

_LATER = {
    "attn+moe": "MoE FFN (ROADMAP Queue 1 item 14)",
    "attn+mlp_first": "the dense first layers of the MoE models (ROADMAP "
                      "Queue 1 item 14)",
    "xattn": "cross-attention (ROADMAP Queue 1 item 14)",
    "mamba": "the Mamba mixer on ssm_scan_pallas (ROADMAP Queue 2 item 8)",
    "mamba+moe": "the Mamba mixer on ssm_scan_pallas (ROADMAP Queue 2 "
                 "item 8)",
}


def _supported(cfg, kind: str) -> None:
    if kind == "rwkv6":
        return
    if kind != "attn":
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet: "
            f"{_LATER.get(kind, 'ROADMAP Queue 1 item 14')}")
    if cfg.attn_type != "gqa":
        raise NotImplementedError(f"attention type {cfg.attn_type!r} (MLA) "
                                  "is not ported yet (ROADMAP Queue 1 "
                                  "item 14)")


class Block(nn.Module):
    """One layer: norm1, norm2 and, by kind, attn (GQA) + mlp (SwiGLU)
    ("attn") or rwkv (time-mix + channel-mix, "rwkv6")."""

    def __init__(self, cfg, kind: str, device=None):
        super().__init__()
        _supported(cfg, kind)
        self.norm1 = RMSNorm(cfg.d_model, device)
        self.norm2 = RMSNorm(cfg.d_model, device)
        if kind == "rwkv6":
            self.rwkv = rwkv_mod.RWKV6(cfg, device)
            return
        self.attn = attn_mod.GQA(cfg, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cdtype(cfg), device)

    def reset_parameters(self, gen: torch.Generator, cfg) -> None:
        self.norm1.reset_parameters(gen)
        self.norm2.reset_parameters(gen)
        if hasattr(self, "rwkv"):
            self.rwkv.reset_parameters(gen, cfg)
            return
        self.attn.reset_parameters(gen, cfg)
        self.mlp.reset_parameters(gen)


def block_init(gen: torch.Generator, cfg, kind: str, device=None) -> Block:
    blk = Block(cfg, kind, device)
    blk.reset_parameters(gen, cfg)
    return blk


def block_forward(p: Block, cfg, kind: str, x, positions,
                  collect_cache: bool = False):
    """Returns (x, aux_loss, the layer's cache or None)."""
    _supported(cfg, kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "rwkv6":
        # a fresh sequence: zero float32 WKV state, zero token shifts
        dh = cfg.rwkv_head_dim
        state = torch.zeros((x.shape[0], cfg.d_model // dh, dh, dh),
                            dtype=torch.float32, device=x.device)
        y, shift_tm, state = rwkv_mod.time_mix(p.rwkv, cfg, p.norm1(x), None,
                                               state)
        x = x + y
        y, shift_cm = rwkv_mod.channel_mix(p.rwkv, p.norm2(x), None)
        x = x + y
        cache = None
        if collect_cache:
            cache = {"wkv": state, "shift_tm": shift_tm.to(cdtype(cfg)),
                     "shift_cm": shift_cm.to(cdtype(cfg))}
        return x, aux, cache
    y, kv = attn_mod.gqa_forward(p.attn, cfg, p.norm1(x), positions)
    x = x + y
    cache = tuple(t.to(cdtype(cfg)) for t in kv) if collect_cache else None
    return x + p.mlp(p.norm2(x)), aux, cache


def block_decode(p: Block, cfg, kind: str, x, cache, cur_len: int):
    """x: (B, 1, D); returns (x, cache), the cache updated in place."""
    _supported(cfg, kind)
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
    y, cache = attn_mod.gqa_decode(p.attn, cfg, p.norm1(x), cache, cur_len)
    x = x + y
    return x + p.mlp(p.norm2(x)), cache


def cache_spec(cfg, kind: str, batch: int, max_len: int):
    """One layer's cache as (shape, dtype) leaves: (K, V) for "attn"
    (sequence on axis 1), {"wkv", "shift_tm", "shift_cm"} for "rwkv6"
    (no sequence axis: `max_len` allocates nothing)."""
    _supported(cfg, kind)
    if kind == "rwkv6":
        return rwkv_mod.rwkv6_state_spec(cfg, batch)
    return attn_mod.gqa_cache_spec(cfg, batch, max_len)
