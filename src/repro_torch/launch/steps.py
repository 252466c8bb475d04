"""Step-function builders: prefill_step / decode_step.

Port of `repro.launch.steps` (serving half; `make_train_step` and
`init_train_state` wait for the training slice). The port's model is an
`nn.Module` that holds its weights, so the step functions take no
`params` argument.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.models.model import Model


def make_prefill_step(model: Model, *, max_len: int) -> Callable:
    def prefill_step(tokens, image_embeds=None):
        return model.prefill(tokens, max_len=max_len,
                             image_embeds=image_embeds)

    return prefill_step


def make_decode_step(model: Model) -> Callable:
    def decode_step(token, caches, cur_len):
        return model.decode_step(token, caches, cur_len)

    return decode_step
