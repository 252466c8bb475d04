"""Assigned input shapes × per-arch input specs: (shape, dtype) stand-ins
for the inputs of a step, allocating nothing.

Port of `repro.launch.shapes`. Shapes (LM family, seq_len × global
batch):
  train_4k     seq 4,096  batch 256   (training)
  prefill_32k  seq 32,768 batch 32    (inference prefill)
  decode_32k   seq 32,768 batch 128   (one token, KV cache of 32k)
  long_500k    seq 524,288 batch 1    (long-context decode; only for
                                       sub-quadratic archs: ssm/hybrid)

``decode_*``/``long_*`` describe `decode_step`'s inputs, not the train
step's. A spec leaf is (shape tuple, torch dtype), as `Model.cache_shapes`
gives; the decode step's `cur_len` is a Python int in the port (the
reference's is a () int32 array), so its spec is `int`.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cdtype
from repro_torch.models.model import Model

SHAPES = {
    "train_4k": dict(kind="train", seq_len=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq_len=32768, batch=32),
    "decode_32k": dict(kind="decode", seq_len=32768, batch=128),
    "long_500k": dict(kind="decode", seq_len=524288, batch=1),
}

# pure full-attention archs skip long_500k (no sub-quadratic path);
# ssm / hybrid run it (recurrent state decode / tiny KV slice).
LONG_OK_FAMILIES = ("ssm", "hybrid")


def cell_supported(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and cfg.family not in LONG_OK_FAMILIES:
        return False, (f"{cfg.name} is pure full-attention; long_500k "
                       "needs sub-quadratic attention")
    return True, ""


def _tokens_spec(cfg: ModelConfig, batch: int, seq: int):
    shape = (batch, seq, cfg.n_codebooks) if cfg.n_codebooks \
        else (batch, seq)
    return (shape, torch.int32)


def _image_spec(cfg: ModelConfig, batch: int):
    return ((batch, cfg.n_image_tokens, cfg.d_model), cdtype(cfg))


def input_specs(cfg: ModelConfig, shape_name: str, model: Model) -> dict:
    """{'kind', the step's inputs as (shape, dtype) leaves, 'B', 'S'}:
    'batch' for training, 'tokens' for prefill, 'token', 'caches' and
    'cur_len' for decode."""
    info = SHAPES[shape_name]
    B, S = info["batch"], info["seq_len"]
    kind = info["kind"]
    if kind == "train":
        batch = {"tokens": _tokens_spec(cfg, B, S),
                 "labels": _tokens_spec(cfg, B, S)}
        if cfg.family == "vlm":
            batch["image_embeds"] = _image_spec(cfg, B)
        return {"kind": kind, "batch": batch, "B": B, "S": S}
    if kind == "prefill":
        out = {"kind": kind, "tokens": _tokens_spec(cfg, B, S),
               "B": B, "S": S}
        if cfg.family == "vlm":
            out["image_embeds"] = _image_spec(cfg, B)
        return out
    # decode: one new token against a cache of length S
    return {"kind": kind, "token": _tokens_spec(cfg, B, 1),
            "caches": model.cache_shapes(B, S), "cur_len": int,
            "B": B, "S": S}
