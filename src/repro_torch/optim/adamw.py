"""AdamW on named tensors, with global-norm clipping and microbatch
gradient accumulation.

Port of `repro.optim.adamw`, as plain functions. Parameters, gradients
and the moments are dicts keyed by the model's parameter names (the
state dict's); the moments are float32 whatever the parameter's dtype,
and every step of the update runs in float32 as in the reference: bias
corrections 1 - b**step in float32, delta = m̂ / (√v̂ + eps) + wd · p, the
result cast back to the parameter's dtype.

A port choice: `adamw_update` writes the new parameters and moments in
place, under `torch.no_grad()` (the parameters are the model's own
leaves, which an `nn.Module` keeps), where the reference returns new
pytrees. `AdamWState` is still returned anew, with its step advanced.
`torch.optim.AdamW` is not used: it keeps bf16 moments for bf16
parameters and rounds in another order.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import nn

Params = dict  # name -> tensor


class AdamWState(NamedTuple):
    step: torch.Tensor   # () int32, on the parameters' device
    m: Params            # first moment (float32, keyed as the params)
    v: Params            # second moment (float32, keyed as the params)


def trainable_params(model: nn.Module) -> Params:
    """The model's parameters that require grad, by name (the leaves that
    `jax.value_and_grad` differentiates in the reference)."""
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def adamw_init(params: Params) -> AdamWState:
    dev = next(iter(params.values())).device if params else None
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=zeros, v={n: z.clone() for n, z in zeros.items()})


def global_norm(tree: Params) -> torch.Tensor:
    leaves = [torch.sum(torch.square(t.float())) for t in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return {n: g * scale for n, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(grads: Params, state: AdamWState, params: Params, *,
                 lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1,
                 max_grad_norm: Optional[float] = 1.0
                 ) -> tuple[Params, AdamWState, dict]:
    """One AdamW step: `params` and the moments updated in place; returns
    (params, the state with its step advanced, {"grad_norm"} (before
    clipping)). `lr` is a float or a 0-d tensor (a schedule's value at
    the state's step)."""
    if max_grad_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    b1c = 1.0 - b1 ** step.to(torch.float32)
    b2c = 1.0 - b2 ** step.to(torch.float32)
    for name, p in params.items():
        g = grads[name].to(torch.float32)
        m = state.m[name].mul_(b1).add_((1 - b1) * g)
        v = state.v[name].mul_(b2).add_((1 - b2) * torch.square(g))
        mhat = m / b1c
        vhat = v / b2c
        pf = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * pf
        p.copy_(pf - lr * delta)
    return params, AdamWState(step=step, m=state.m, v=state.v), \
        {"grad_norm": gnorm}


def accumulate_grads(loss_fn: Callable, model: nn.Module, microbatches: dict
                     ) -> tuple[torch.Tensor, Params]:
    """Loss and gradients averaged over microbatches: `microbatches` is a
    dict whose values have a leading (n_micro, ...) axis, and
    `loss_fn(model, mb)` returns (loss, aux). Gradients are summed in
    float32, microbatch by microbatch, then divided by n, as the
    reference's scan."""
    params = trainable_params(model)
    n = next(iter(microbatches.values())).shape[0]
    dev = next(iter(params.values())).device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()}
    for i in range(n):
        loss, _ = loss_fn(model, {k: v[i] for k, v in microbatches.items()})
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for k, g in zip(params, grads):
                acc[k] += g
            total = total + loss.detach()
    return total / n, {k: g / n for k, g in acc.items()}
