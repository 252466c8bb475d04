"""Shared transformer layers, the serving half: norms, RoPE, SwiGLU,
embeddings and the last-position head.

Port of `repro.models.layers`. Conventions kept from the reference:
  * activations are (B, S, D); attention heads (B, S, H, hd);
  * weights are laid out (d_in, d_out) and applied as `x @ w`;
  * compute runs in `cdtype(cfg)`; norms and RoPE compute in float32 and
    cast back.
The reference keeps float32 master weights and casts them at every
product (`x @ w.astype(dt)`); the port's modules hold each matrix once
in the compute dtype, which is bit for bit the same cast made once. The
init helpers draw float32 from an explicit `torch.Generator` with the
reference's distributions and scales (the values cannot equal
jax.random's). `chunked_cross_entropy` waits for the training slice.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

def cdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter that serving never differentiates."""
    return nn.Parameter(t, requires_grad=False)


# -- init helpers -------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * scale


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: Optional[float] = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return _normal(gen, (d_in, d_out), scale)


def embed_init(gen: torch.Generator, vocab: int, d: int) -> torch.Tensor:
    return _normal(gen, (vocab, d), 0.02)


def rmsnorm_init(d: int, device=None) -> dict:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def mlp_init(gen: torch.Generator, d: int, d_ff: int) -> dict:
    return {"w_gate": dense_init(gen, d, d_ff),
            "w_up": dense_init(gen, d, d_ff),
            "w_down": dense_init(gen, d_ff, d)}


def embedding_init(gen: torch.Generator, cfg) -> dict:
    if cfg.n_codebooks:  # musicgen: one table per codebook, summed
        return {"books": torch.stack([
            embed_init(gen, cfg.vocab_size, cfg.d_model)
            for _ in range(cfg.n_codebooks)])}
    return {"tok": embed_init(gen, cfg.vocab_size, cfg.d_model)}


def head_init(gen: torch.Generator, cfg) -> dict:
    if cfg.n_codebooks:
        return {"w": torch.stack([
            dense_init(gen, cfg.d_model, cfg.vocab_size, scale=0.02)
            for _ in range(cfg.n_codebooks)])}
    return {"w": dense_init(gen, cfg.d_model, cfg.vocab_size, scale=0.02)}


def load_(module: nn.Module, values: dict) -> None:
    """Copy `values` (name -> tensor) into the module's own parameters,
    cast to each parameter's dtype."""
    with torch.no_grad():
        for name, t in values.items():
            getattr(module, name).copy_(t)


# -- RMSNorm -------------------------------------------------------------------

def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(dt)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = frozen(torch.ones(d, dtype=torch.float32,
                                       device=device))

    def reset_parameters(self, gen: torch.Generator) -> None:
        load_(self, rmsnorm_init(self.scale.shape[0], self.scale.device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(self.scale, x)


# -- RoPE ---------------------------------------------------------------------

def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int. Half-split convention,
    angles in float32."""
    dim = x.shape[-1]
    freqs = rope_freqs(dim, theta, x.device)                 # (hd/2,)
    angles = positions[..., None].float() * freqs           # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -- SwiGLU MLP ----------------------------------------------------------------

class MLP(nn.Module):
    def __init__(self, d: int, d_ff: int, dtype, device=None):
        super().__init__()
        self.w_gate = frozen(torch.zeros(d, d_ff, dtype=dtype, device=device))
        self.w_up = frozen(torch.zeros(d, d_ff, dtype=dtype, device=device))
        self.w_down = frozen(torch.zeros(d_ff, d, dtype=dtype, device=device))

    def reset_parameters(self, gen: torch.Generator) -> None:
        load_(self, mlp_init(gen, *self.w_gate.shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self, x)


def mlp(p, x: torch.Tensor) -> torch.Tensor:
    return (silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu` as the reference computes it: x * (1 / (1 + exp(-x))),
    each step rounded in bf16, bit for bit with jax's CPU lowering
    (`F.silu` rounds once, `x * torch.sigmoid(x)` twice; both differ from
    it in a quarter or more of the entries)."""
    return x * (1 / (1 + torch.exp(-x)))


# -- Embedding + last-position head ----------------------------------------------

class Embedding(nn.Module):
    """`tok` (V, D) in the compute dtype, or for multi-codebook audio
    `books` (K, V, D) in float32: the reference sums the K rows in float32
    and casts once, and rows rounded before the sum would give other
    bits."""

    def __init__(self, cfg, device=None):
        super().__init__()
        V, D = cfg.vocab_size, cfg.d_model
        self.dtype = cdtype(cfg)
        if cfg.n_codebooks:
            self.books = frozen(torch.zeros(cfg.n_codebooks, V, D,
                                            dtype=torch.float32,
                                            device=device))
        else:
            self.tok = frozen(torch.zeros(V, D, dtype=self.dtype,
                                          device=device))

    def reset_parameters(self, gen: torch.Generator, cfg) -> None:
        load_(self, embedding_init(gen, cfg))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return embed_tokens(self, tokens)


def embed_tokens(p, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) int, or (B, S, K) for K codebooks. The reference
    gathers the float32 table and casts; gathering the table held in the
    compute dtype is the same. Codebooks: book k's row for k = 0, ..., K-1
    summed in float32, then cast."""
    tokens = tokens.long()
    if hasattr(p, "books"):
        out = p.books[0][tokens[..., 0]]
        for k in range(1, p.books.shape[0]):
            out = out + p.books[k][tokens[..., k]]
        return out.to(p.dtype)
    return p.tok[tokens]


class Head(nn.Module):
    """`w` (D, V), or (K, D, V) for K codebooks, in the compute dtype."""

    def __init__(self, cfg, device=None):
        super().__init__()
        shape = (cfg.d_model, cfg.vocab_size)
        if cfg.n_codebooks:
            shape = (cfg.n_codebooks,) + shape
        self.w = frozen(torch.zeros(shape, dtype=cdtype(cfg), device=device))

    def reset_parameters(self, gen: torch.Generator, cfg) -> None:
        load_(self, head_init(gen, cfg))

    def forward(self, h_last: torch.Tensor) -> torch.Tensor:
        return logits_last(self, h_last)


def logits_last(p, h_last: torch.Tensor) -> torch.Tensor:
    """h_last: (B, D) -> logits (B, V), or (B, K, V) for K codebooks, in
    the compute dtype."""
    if p.w.ndim == 3:
        return torch.einsum("bd,kdv->bkv", h_last, p.w)
    return h_last @ p.w
