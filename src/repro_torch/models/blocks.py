"""Layer blocks: per-kind init / prefill forward / decode step.

Port of `repro.models.blocks` for kind "attn" (self-attention + dense
MLP, pre-norm residual): the dense family. Every other kind raises
`NotImplementedError` naming the ROADMAP item it waits for.
"""
from __future__ import annotations

import torch
from torch import nn

from . import attention as attn_mod
from .layers import MLP, RMSNorm, cdtype

_LATER = {
    "attn+moe": "MoE FFN (ROADMAP Queue 1 item 14)",
    "attn+mlp_first": "the dense first layers of the MoE models (ROADMAP "
                      "Queue 1 item 14)",
    "xattn": "cross-attention (ROADMAP Queue 1 item 14)",
    "mamba": "the Mamba mixer on ssm_scan_pallas (ROADMAP Queue 2 item 8)",
    "mamba+moe": "the Mamba mixer on ssm_scan_pallas (ROADMAP Queue 2 "
                 "item 8)",
    "rwkv6": "RWKV-6 on wkv6_pallas (ROADMAP Queue 2 item 7)",
}


def _supported(cfg, kind: str) -> None:
    if kind != "attn":
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet: "
            f"{_LATER.get(kind, 'ROADMAP Queue 1 item 14')}")
    if cfg.attn_type != "gqa":
        raise NotImplementedError(f"attention type {cfg.attn_type!r} (MLA) "
                                  "is not ported yet (ROADMAP Queue 1 "
                                  "item 14)")


class Block(nn.Module):
    """One "attn" layer: norm1, attn (GQA), norm2, mlp (SwiGLU)."""

    def __init__(self, cfg, kind: str, device=None):
        super().__init__()
        _supported(cfg, kind)
        self.norm1 = RMSNorm(cfg.d_model, device)
        self.norm2 = RMSNorm(cfg.d_model, device)
        self.attn = attn_mod.GQA(cfg, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cdtype(cfg), device)

    def reset_parameters(self, gen: torch.Generator, cfg) -> None:
        self.norm1.reset_parameters(gen)
        self.norm2.reset_parameters(gen)
        self.attn.reset_parameters(gen, cfg)
        self.mlp.reset_parameters(gen)


def block_init(gen: torch.Generator, cfg, kind: str, device=None) -> Block:
    blk = Block(cfg, kind, device)
    blk.reset_parameters(gen, cfg)
    return blk


def block_forward(p: Block, cfg, kind: str, x, positions,
                  collect_cache: bool = False):
    """Returns (x, aux_loss, (k, v) or None)."""
    _supported(cfg, kind)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    y, kv = attn_mod.gqa_forward(p.attn, cfg, p.norm1(x), positions)
    x = x + y
    cache = tuple(t.to(cdtype(cfg)) for t in kv) if collect_cache else None
    return x + p.mlp(p.norm2(x)), aux, cache


def block_decode(p: Block, cfg, kind: str, x, cache, cur_len: int):
    """x: (B, 1, D); returns (x, cache), the cache updated in place."""
    _supported(cfg, kind)
    y, cache = attn_mod.gqa_decode(p.attn, cfg, p.norm1(x), cache, cur_len)
    x = x + y
    return x + p.mlp(p.norm2(x)), cache


def cache_spec(cfg, kind: str, batch: int, max_len: int):
    _supported(cfg, kind)
    return attn_mod.gqa_cache_spec(cfg, batch, max_len)
