"""Fine-grained Mixture-of-Experts (Jamba; DeepSeekMoE's shared experts).

Port of `repro.models.moe`, the single-device half. Dropless sort-based
dispatch:
  1. router top-k per token (`route`),
  2. token replicas sorted by expert id (a stable sort, as `jnp.argsort`),
  3. each expert's contiguous slice through its three products (the
     reference's `jax.lax.ragged_dot`, a plain product that XLA computes:
     here one `torch.matmul` per populated expert),
  4. the weighted replicas summed back in token order in the compute
     dtype, each token's in ascending expert id (the reference's
     scatter-add order).
The group sizes slice the sorted replicas on the host, so each MoE layer
synchronises with the card once per call (once per token in decode).
Shared experts (DeepSeek) run as a dense MLP on every token. The
expert-parallel `moe_forward_ep` waits for the sharded placement.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .layers import (MLP, _normal, cdtype, dense_init, frozen, load_, mlp,
                     silu)


def moe_init(gen: torch.Generator, cfg) -> dict:
    """Float32 values with the reference's distributions and scales."""
    d = cfg.d_model
    de = cfg.d_expert or cfg.d_ff
    E = cfg.n_experts
    scale = 1.0 / math.sqrt(d)
    return {
        "router": dense_init(gen, d, E, scale=0.02),
        "w_gate": _normal(gen, (E, d, de), scale),
        "w_up": _normal(gen, (E, d, de), scale),
        "w_down": _normal(gen, (E, de, d), 1.0 / math.sqrt(de)),
    }


class MoE(nn.Module):
    """Parameters of one MoE FFN: router (d, E) and the experts' w_gate,
    w_up (E, d, de) and w_down (E, de, d) in the compute dtype; `shared`
    (an MLP of n_shared_experts · de) where the config has shared
    experts."""

    def __init__(self, cfg, device=None):
        super().__init__()
        d, E, dt = cfg.d_model, cfg.n_experts, cdtype(cfg)
        de = cfg.d_expert or cfg.d_ff
        for name, shape in (("router", (d, E)), ("w_gate", (E, d, de)),
                            ("w_up", (E, d, de)), ("w_down", (E, de, d))):
            setattr(self, name, frozen(torch.zeros(shape, dtype=dt,
                                                   device=device)))
        if cfg.n_shared_experts:
            self.shared = MLP(d, cfg.n_shared_experts * de, dt, device)

    def reset_parameters(self, gen: torch.Generator, cfg) -> None:
        load_(self, moe_init(gen, cfg))
        if cfg.n_shared_experts:
            self.shared.reset_parameters(gen)


def top_k(probs: torch.Tensor, k: int):
    """`jax.lax.top_k` along the last axis: the k largest, ties to the
    lower index (a stable descending sort; `torch.topk` promises no order
    among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: MoE, cfg, xf: torch.Tensor):
    """Router of the tokens xf (T, D): (probs (T, E) float32, top_vals,
    top_idx (T, k)). The logits are rounded to the compute dtype before
    the float32 softmax, as in the reference."""
    logits = (xf @ p.router).float()
    probs = torch.softmax(logits, dim=-1)
    top_vals, top_idx = top_k(probs, cfg.moe_top_k)
    return probs, top_vals, top_idx


def _aux_loss(probs, top_idx, E: int, k: int) -> torch.Tensor:
    """Switch-style load-balance loss E · Σ_e f_e · p̄_e."""
    T = probs.shape[0]
    f = torch.zeros((E,), dtype=torch.float32, device=probs.device)
    f = f.index_add(0, top_idx.reshape(-1),
                    torch.ones(top_idx.numel(), device=probs.device)) \
        / (T * k)
    return E * torch.sum(f * probs.mean(dim=0))


def moe_forward(p: MoE, cfg, x: torch.Tensor):
    """x: (B, S, D) -> (out, aux_loss). The single-device path; the
    reference's expert-parallel dispatch (`moe_forward_ep`) needs a mesh
    the port does not have yet."""
    return moe_forward_local(p, cfg, x)


def moe_forward_local(p: MoE, cfg, x: torch.Tensor):
    """Single-device dropless path (sort + per-expert products)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    dt = x.dtype
    T = B * S
    xf = x.reshape(T, D)

    probs, top_vals, top_idx = route(p, cfg, xf)
    weights = top_vals / torch.clamp_min(top_vals.sum(-1, keepdim=True),
                                         1e-9)
    aux = _aux_loss(probs, top_idx, E, k)

    # sort token replicas by expert
    flat_expert = top_idx.reshape(T * k)
    sort_idx = torch.argsort(flat_expert, stable=True)
    token_of = sort_idx // k
    xs = xf[token_of]                                          # (T·k, D)
    sizes = torch.bincount(flat_expert, minlength=E).tolist()  # host sync

    eo = torch.empty_like(xs)
    start = 0
    for e, n in enumerate(sizes):
        if n:
            rows = slice(start, start + n)
            h = silu(xs[rows] @ p.w_gate[e]) * (xs[rows] @ p.w_up[e])
            eo[rows] = h @ p.w_down[e]
        start += n

    # the weighted replicas back in token order, each token's k replicas
    # summed in the compute dtype in ascending expert id (0 + r_e1 + r_e2
    # + ... with e1 < e2 < ...): the order in which the reference's
    # scatter-add applies them, replica by replica in the expert-sorted
    # order (at k = 2 any order gives the same bits)
    w_sorted = weights.reshape(T * k)[sort_idx].to(dt)
    contrib = torch.empty_like(eo)
    contrib[sort_idx] = eo * w_sorted[:, None]
    by_expert = torch.argsort(top_idx, dim=-1, stable=True)      # (T, k)
    contrib = contrib.reshape(T, k, D)[
        torch.arange(T, device=x.device)[:, None], by_expert]
    out = torch.zeros((T, D), dtype=dt, device=x.device)
    for j in range(k):
        out = out + contrib[:, j]

    if cfg.n_shared_experts:
        out = out + mlp(p.shared, xf)
    return out.reshape(B, S, D), aux


def moe_forward_ep(p: MoE, cfg, x: torch.Tensor):
    raise NotImplementedError(
        "moe_forward_ep: the expert-parallel MoE needs the sharded "
        "placement (ROADMAP Queue 1 item 12); moe_forward runs the local "
        "path")


def moe_forward_dense_fallback(p: MoE, cfg, x: torch.Tensor):
    """Oracle: every expert computed densely, combined by the router's
    weights. O(E) compute — tests only."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    dt = x.dtype
    xf = x.reshape(B * S, D)
    probs, top_vals, top_idx = route(p, cfg, xf)
    weights = top_vals / torch.clamp_min(top_vals.sum(-1, keepdim=True),
                                         1e-9)
    dense_w = torch.zeros_like(probs).scatter(1, top_idx, weights)
    g = torch.einsum("td,edf->tef", xf, p.w_gate)
    u = torch.einsum("td,edf->tef", xf, p.w_up)
    eo = torch.einsum("tef,efd->ted", silu(g) * u, p.w_down)
    out = torch.einsum("ted,te->td", eo, dense_w.to(dt))
    aux = _aux_loss(probs, top_idx, E, k)
    if cfg.n_shared_experts:
        out = out + mlp(p.shared, xf)
    return out.reshape(B, S, D), aux
