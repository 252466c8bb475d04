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
synchronises with the card once per call (once per token in decode). On
"meta" (the dry run's count) there are no values to read: the T·k
replicas are split evenly over the experts (`even_sizes`), which gives
every routing's FLOPs exactly (each product's are linear in its rows,
and the rows sum to T·k) and its bytes wherever every expert is chosen.
Shared experts (DeepSeek) run as a dense MLP on every token.

On the launch layer's (data, model) mesh with hints enabled
(`repro_torch.distributed.hints`), `moe_forward` takes the reference's
expert-parallel path, `moe_forward_ep`: capacity-bounded per-expert
buffers on each (data, model) rank of the logical mesh, static shapes,
no host read.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..distributed.hints import _STATE, axis_size, hints_enabled
from ..launch import hlocost
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
    w_up (E, d, de) and w_down (E, de, d) in the compute dtype (float32
    in a training model); `shared`
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
    logits = (xf @ p.router.to(xf.dtype)).float()
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


def _dp_size() -> int:
    """Data ranks of the hints' mesh (the product of its data axes)."""
    return math.prod(_STATE["sizes"].get(a, 1) for a in _STATE["data_axes"])


def moe_forward(p: MoE, cfg, x: torch.Tensor):
    """x: (B, S, D) -> (out, aux_loss). The expert-parallel path when
    hints are enabled on a mesh whose `model` axis has more than one rank
    and divides the experts, and whose data ranks divide the tokens (the
    reference's rule); else the local sort path."""
    tokens = x.shape[0] * x.shape[1]
    if hints_enabled() and axis_size("model") > 1 and \
            cfg.n_experts % axis_size("model") == 0 and \
            tokens % max(_dp_size(), 1) == 0:
        return moe_forward_ep(p, cfg, x)
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
    # index_select, not xf[token_of]: its backward (index_add) sums each
    # token's k replicas in a fixed order on the CPU, where indexing's
    # index_put_ does not
    xs = xf.index_select(0, token_of)                          # (T·k, D)
    # each expert's group size by a count of static shape (the ops a count
    # on "meta" runs too), then read to the host
    counts = torch.zeros((E,), dtype=torch.int64, device=x.device) \
        .index_add_(0, flat_expert, torch.ones_like(flat_expert))
    if x.device.type == "meta":
        sizes = even_sizes(T * k, E)
    else:
        sizes = counts.tolist()  # host sync

    w_gate, w_up, w_down = (w.to(dt) for w in (p.w_gate, p.w_up, p.w_down))
    eo = torch.empty_like(xs)
    start = 0
    for e, n in enumerate(sizes):
        if n:
            rows = slice(start, start + n)
            h = silu(xs[rows] @ w_gate[e]) * (xs[rows] @ w_up[e])
            eo[rows] = h @ w_down[e]
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


def even_sizes(replicas: int, n_experts: int) -> list[int]:
    """`replicas` split over `n_experts` groups as evenly as whole rows
    allow (the first groups one row more): the group sizes a count on
    "meta" takes for the host read it cannot make."""
    base, extra = divmod(replicas, n_experts)
    return [base + (e < extra) for e in range(n_experts)]


def capacity(tokens_k: int, n_experts: int, capacity_factor: float) -> int:
    """Slots per expert on a rank that routes `tokens_k` token replicas:
    the reference's Switch-style capacity, a multiple of 8 and at least 8,
    computed in Python floats as it is."""
    return max(int(tokens_k / n_experts * capacity_factor + 7) // 8 * 8, 8)


def _rank_slots(flat_e: torch.Tensor, rank: int, e_local: int, ce: int):
    """(keep, local_e, pos_slot) of the replicas `flat_e` (T·k expert ids,
    token-major) on model rank `rank`, which holds experts [rank·e_local,
    (rank+1)·e_local): a replica is kept when its expert is the rank's
    and fewer than `ce` earlier replicas (in this token-major order) chose
    the same expert."""
    mine = torch.div(flat_e, e_local, rounding_mode="floor") == rank
    local_e = torch.clamp(flat_e - rank * e_local, 0, e_local - 1)
    # the one-hot laid out (e_local, T·k), so the running count is a scan
    # along the last axis (CUDA scans an outer axis one row at a time)
    onehot = (local_e[None] == torch.arange(
        e_local, device=flat_e.device)[:, None]) & mine[None]
    pos = torch.cumsum(onehot.to(torch.int32), dim=1) - 1
    pos_slot = torch.gather(pos, 0, local_e[None])[0]
    return mine & (pos_slot < ce), local_e, pos_slot


def _rank_partial(xf, weights, top_idx, by_expert, w_gate, w_up, w_down,
                  rank: int, e_local: int, ce: int) -> torch.Tensor:
    """The reference's `rank_fn` body after routing: the (T_loc, D) output
    of model rank `rank`'s experts (`w_*` its e_local slices) on the data
    rank's tokens `xf`, each replica weighted by its router weight;
    dropped replicas and other ranks' contribute nothing.

    The replicas fill (e_local, ce + 1) buffers of token ids and weights by
    scatter: the sentinel slot e_local·(ce + 1) takes every replica that is
    not kept, and the trailing pad token T_loc (a zero row) every empty
    slot; both are discarded. The slots go through the three products as
    batched matmuls. Each token's weighted rows are then summed from 0 in
    expert-major, then slot order (a token holds at most one slot of an
    expert), the order of the reference's scatter-add."""
    T_loc, D = xf.shape
    k = top_idx.shape[1]
    Tk = T_loc * k
    dev, dt = xf.device, xf.dtype
    flat_e = top_idx.reshape(Tk)
    tok_of = torch.div(torch.arange(Tk, dtype=torch.int64, device=dev), k,
                       rounding_mode="floor")
    keep, local_e, pos_slot = _rank_slots(flat_e, rank, e_local, ce)
    flat_idx = torch.where(keep, local_e * (ce + 1) + pos_slot,
                           e_local * (ce + 1))
    n_buf = e_local * (ce + 1) + 1
    buf_tok = torch.full((n_buf,), T_loc, dtype=torch.int64, device=dev)
    buf_tok.scatter_(0, flat_idx, torch.where(keep, tok_of, T_loc))
    buf_w = torch.zeros((n_buf,), dtype=torch.float32, device=dev)
    buf_w.scatter_(0, flat_idx, torch.where(keep, weights.reshape(Tk), 0.0))
    buf_tok = buf_tok[:-1].reshape(e_local, ce + 1)[:, :ce]
    buf_w = buf_w[:-1].reshape(e_local, ce + 1)[:, :ce]

    xpad = torch.cat([xf, torch.zeros((1, D), dtype=dt, device=dev)])
    xs = xpad.index_select(0, buf_tok.reshape(-1)).reshape(e_local, ce, D)
    h = silu(torch.bmm(xs, w_gate)) * torch.bmm(xs, w_up)
    eo = torch.bmm(h, w_down)
    contrib = (eo * buf_w[..., None].to(dt)).reshape(e_local * ce, D)
    contrib = torch.cat([contrib, torch.zeros((1, D), dtype=dt,
                                              device=dev)])
    # each token's kept slots in ascending expert id; the rest read the
    # zero row e_local·ce
    slot = torch.where(keep, local_e * ce + pos_slot, e_local * ce)
    slot = slot.reshape(T_loc, k).gather(1, by_expert)
    out = torch.zeros((T_loc, D), dtype=dt, device=dev)
    for j in range(k):
        out = out + contrib.index_select(0, slot[:, j])
    return out


def _model_sum(parts: list) -> torch.Tensor:
    """The reference's psum over `model`: the ranks' partial outputs
    summed in rank order."""
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


def moe_forward_ep(p: MoE, cfg, x: torch.Tensor):
    """Expert-parallel MoE over the hints' (data, model) mesh: x (B, S, D)
    -> (out, aux_loss).

    The reference's shard_map, run on the logical mesh in lockstep on the
    runtime's device: data rank d takes the contiguous block d of T/dp
    tokens and routes it (each model rank of the reference routes the
    same block alike, so it is routed once); model rank r holds experts
    [r·e_local, (r+1)·e_local) and computes its capacity-bounded partial
    output (`_rank_partial`; Switch-style dropping at cfg.capacity_factor,
    the capacity from T/dp · k replicas). The psum over `model` is a sum
    over r = 0..n-1 in order (`_model_sum`); the load-balance aux sums the
    expert counts and the router probabilities over the data ranks in
    rank order before the nonlinear f·p̄ product, so it is the global
    one. Shared experts run on every token outside the ranks. Shapes are
    static: no value is read back to the host."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    dt = x.dtype
    n_ranks = axis_size("model")
    e_local = E // n_ranks
    dp_size = _dp_size()
    T = B * S
    T_loc = T // dp_size
    xf = x.reshape(T, D)
    w_gate, w_up, w_down = (w.to(dt) for w in (p.w_gate, p.w_up, p.w_down))
    ce = capacity(T_loc * k, E, cfg.capacity_factor)

    counts = torch.zeros((E,), dtype=torch.float32, device=x.device)
    probs_sum = torch.zeros((E,), dtype=torch.float32, device=x.device)
    outs = []
    for d in range(dp_size):
        xd = xf[d * T_loc:(d + 1) * T_loc]
        probs, top_vals, top_idx = route(p, cfg, xd)
        weights = top_vals / torch.clamp_min(
            top_vals.sum(-1, keepdim=True), 1e-9)
        counts = counts.index_add(  # whole numbers: exact in any order
            0, top_idx.reshape(-1),
            torch.ones(top_idx.numel(), device=x.device))
        probs_sum = probs_sum + probs.sum(dim=0)
        by_expert = torch.argsort(top_idx, dim=-1, stable=True)
        outs.append(_model_sum([
            _rank_partial(xd, weights, top_idx, by_expert,
                          w_gate[r * e_local:(r + 1) * e_local],
                          w_up[r * e_local:(r + 1) * e_local],
                          w_down[r * e_local:(r + 1) * e_local],
                          r, e_local, ce)
            for r in range(n_ranks)]))
    aux = E * torch.sum((counts / (T * k)) * (probs_sum / T))
    # a device's view of the model sum: its (T_loc, D) partial all-reduced
    # over the model ranks (a cost counter's collective)
    hlocost.collective("all-reduce", T_loc * D * xf.element_size(), n_ranks)

    out = torch.cat(outs)
    if cfg.n_shared_experts:
        out = out + mlp(p.shared, xf)
    return out.reshape(B, S, D), aux


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
    g = torch.einsum("td,edf->tef", xf, p.w_gate.to(dt))
    u = torch.einsum("td,edf->tef", xf, p.w_up.to(dt))
    eo = torch.einsum("tef,efd->ted", silu(g) * u, p.w_down.to(dt))
    out = torch.einsum("ted,te->td", eo, dense_w.to(dt))
    aux = _aux_loss(probs, top_idx, E, k)
    if cfg.n_shared_experts:
        out = out + mlp(p.shared, xf)
    return out.reshape(B, S, D), aux
