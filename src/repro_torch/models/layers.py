"""Shared transformer layers: norms, RoPE, SwiGLU, embeddings, the
last-position head and the chunked cross-entropy.

Port of `repro.models.layers`. Conventions kept from the reference:
  * activations are (B, S, D); attention heads (B, S, H, hd);
  * weights are laid out (d_in, d_out) and applied as `x @ w`;
  * compute runs in `cdtype(cfg)`; norms and RoPE compute in float32 and
    cast back;
  * the loss is chunked over the sequence, so the (B, S, V) logits never
    materialise (V up to 152k).
The reference keeps float32 master weights and casts them at every use
(`x @ w.astype(dt)`), and so does every use site here (`x @ w.to(dt)`).
A serving model (`build_model(cfg)`) holds each matrix in the compute
dtype, where that cast returns the same tensor: its forward gives the
bits of the float32 masters cast, but it cannot train (an update would
round into the compute dtype). A training model (`build_model(cfg,
train=True)`) holds every leaf in float32, as the reference's pytree,
so the updates and the gradients' sums (the embedding's scatter-add
among them) stay in float32. The init helpers draw float32 from an
explicit `torch.Generator` with the reference's distributions and
scales (the values cannot equal jax.random's).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

def cdtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter created without `requires_grad`: serving never
    differentiates. `Model.as_trainable` turns it on for every leaf (and
    casts every leaf to float32) for training."""
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
    dt = x.dtype
    return (silu(x @ p.w_gate.to(dt)) * (x @ p.w_up.to(dt))) \
        @ p.w_down.to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.silu` as the reference computes it: x * (1 / (1 + exp(-x))),
    each step rounded in bf16, bit for bit with jax's CPU lowering
    (`F.silu` rounds once, `x * torch.sigmoid(x)` twice; both differ from
    it in a quarter or more of the entries)."""
    return x * (1 / (1 + torch.exp(-x)))


# -- Embedding + last-position head ----------------------------------------------

class Embedding(nn.Module):
    """`tok` (V, D) in the compute dtype (float32 in a training model), or
    for multi-codebook audio `books` (K, V, D) in float32: the reference
    sums the K rows in float32 and casts once, and rows rounded before the
    sum would give other bits."""

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
    """tokens: (B, S) int, or (B, S, K) for K codebooks. The table's rows
    gathered, then cast to the compute dtype, as the reference's
    `take(tok, ids).astype(dt)`: the backward scatter-adds the cotangent
    into a float32 table's gradient in float32. Codebooks: book k's row
    for k = 0, ..., K-1 summed in float32, then cast. The gather is
    `F.embedding`, whose backward sums each row's cotangents in a fixed
    order on the CPU (indexing's `index_put_` does not), so that a step
    gives the same bits every time."""
    tokens = tokens.long()
    if hasattr(p, "books"):
        out = F.embedding(tokens[..., 0], p.books[0])
        for k in range(1, p.books.shape[0]):
            out = out + F.embedding(tokens[..., k], p.books[k])
        return out.to(p.dtype)
    return F.embedding(tokens, p.tok).to(p.dtype)


class Head(nn.Module):
    """`w` (D, V), or (K, D, V) for K codebooks, in the compute dtype
    (float32 in a training model)."""

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
    w = p.w.to(h_last.dtype)
    if w.ndim == 3:
        return torch.einsum("bd,kdv->bkv", h_last, w)
    return h_last @ w


def chunked_cross_entropy(p, cfg, h: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE without materialising (B, S, V).

    h: (B, S, D) final hidden states; labels: (B, S) int (or (B, S, K)
    for K codebooks); `p` the head. Walks the sequence in chunks of
    min(cfg.loss_chunk, S) (S must be a multiple): each chunk's logits in
    the compute dtype, then in float32 their logsumexp and the label's
    log-probability, summed in float32 and divided by the number of
    labels. Each chunk runs under a non-reentrant checkpoint, so the
    backward recomputes its (B, c, V) logits rather than keeping them, as
    the reference's `jax.checkpoint` does. The head's matrix is cast once,
    as in the reference, so in bf16 its gradient sums over the chunks in
    bf16 before it reaches the float32 leaf."""
    B, S, D = h.shape
    c = min(cfg.loss_chunk, S)
    if S % c:
        raise ValueError(f"chunked_cross_entropy: sequence {S} is not a "
                         f"multiple of the loss chunk {c}")
    w = p.w.to(h.dtype)

    def chunk_loss(h_c, y_c, w):
        if w.ndim == 3:
            logits = torch.einsum("bsd,kdv->bskv", h_c, w)
        else:
            logits = h_c @ w                           # (B, c, V)
        logits = logits.float()
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, y_c[..., None].long())[..., 0]
        return torch.sum(lse - ll)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(S // c):
        # the forward draws no random numbers: no RNG state to keep
        total = total + checkpoint(chunk_loss, h[:, i * c:(i + 1) * c],
                                   labels[:, i * c:(i + 1) * c], w,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total / labels.numel()
