"""Step functions: train_step / prefill_step / decode_step.

Port of `repro.launch.steps`. The port's model is an `nn.Module` that
holds its weights, so the step functions take no `params` argument: the
train step updates the model's float32 leaves (and the optimizer's
moments) in place and returns the optimizer state with its step
advanced. Training needs a model built with `build_model(cfg,
train=True)` (`init_train_state` makes one trainable in place).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.model import Model, build_model
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     trainable_params)


def make_train_step(model: Model, *, lr: float | Callable = 3e-4,
                    weight_decay: float = 0.1,
                    max_grad_norm: float = 1.0) -> Callable:
    """`train_step(opt_state, batch) -> (opt_state, metrics)`: the loss
    and its gradients over every trainable leaf, then one AdamW update at
    `lr` (a float, or a schedule called with the optimizer's step
    tensor). metrics {"loss", "ce", "aux", "grad_norm"} are 0-d tensors
    on the model's device: the step reads nothing back to the host."""
    if not model.trainable:
        raise ValueError("make_train_step: the model holds serving weights; "
                         "build it with build_model(cfg, train=True)")
    params = trainable_params(model)

    def train_step(opt_state: AdamWState, batch: dict):
        with torch.enable_grad():
            loss, metrics = model.loss(batch)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        materialize_grads=True)
        step_lr = lr(opt_state.step) if callable(lr) else lr
        _, new_opt, om = adamw_update(
            dict(zip(params, grads)), opt_state, params, lr=step_lr,
            weight_decay=weight_decay, max_grad_norm=max_grad_norm)
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}, **om}
        return new_opt, out

    return train_step


def make_prefill_step(model: Model, *, max_len: int) -> Callable:
    def prefill_step(tokens, image_embeds=None):
        return model.prefill(tokens, max_len=max_len,
                             image_embeds=image_embeds)

    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def decode_step(token, caches, cur_len):
        return model.decode_step(token, caches, cur_len)

    return decode_step


def init_train_state(model: Model, generator: Optional[torch.Generator]
                     = None, seed: int = 0) -> tuple[dict, AdamWState]:
    """Make `model` trainable in place (`Model.as_trainable`), draw its
    weights from `generator` (or a fresh one seeded with `seed`) and
    return (its trainable parameters by name, a fresh AdamW state)."""
    model.as_trainable().init(generator, seed=seed)
    params = trainable_params(model)
    return params, adamw_init(params)


def train_state_shapes(model: Model) -> tuple[dict, AdamWState]:
    """(shape, dtype) leaves of (params, opt_state) of `model`'s config,
    from a model on the "meta" device: nothing is allocated."""
    meta = build_model(model.cfg, "meta", train=True)
    params = {n: (tuple(p.shape), p.dtype)
              for n, p in trainable_params(meta).items()}
    moments = {n: (s, torch.float32) for n, (s, _) in params.items()}
    return params, AdamWState(step=((), torch.int32), m=moments,
                              v=dict(moments))
