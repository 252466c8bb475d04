"""Carry state across from the reference package.

The lifecycle path has no learned weights: its state is the bound data
(and the fitted `beta` it returns). `from_reference` turns the numpy
arrays a caller binds to `repro` into tensors for `repro_torch`, so the
tests and `chip_smoke.py` feed both packages the same bytes;
`bcoo_from_reference` carries a reference BCOO (its numpy buffers) over.
`params_from_reference` turns the reference's LM parameter pytree into
the state dict of the port's `Model`; `train_state_from_reference` and
`train_state_to_reference` carry a training state (parameters and AdamW
moments) across in both directions, so that either package's trainer
resumes the other's checkpoint.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.backend import to_device
from .core.sparse import BCOO
from .optim.adamw import AdamWState


def from_reference(arrays: Mapping[str, np.ndarray],
                   device) -> dict[str, torch.Tensor]:
    """Tensors on `device` holding the same values, dtypes and strides as
    `arrays` (float64 stays float64; `ml_dtypes` bfloat16 becomes
    `torch.bfloat16`; a C-contiguous array gives a contiguous tensor)."""
    dev = torch.device(device)
    return {name: to_device(np.asarray(a), dev) for name, a in arrays.items()}


def bcoo_from_reference(data: np.ndarray, indices: np.ndarray, shape,
                        device, indices_sorted: bool = True,
                        unique_indices: bool = False) -> BCOO:
    """The port's `BCOO` on `device` holding a reference BCOO's `data` and
    int32 `indices` as they are (flags default to those of `sparsify`)."""
    dev = torch.device(device)
    return BCOO(to_device(np.asarray(data), dev),
                to_device(np.asarray(indices), dev), shape,
                indices_sorted=indices_sorted,
                unique_indices=unique_indices)


def params_from_reference(params: Mapping[str, Any], cfg,
                          device) -> dict[str, torch.Tensor]:
    """The state dict of `repro_torch.models.Model(cfg)` holding the
    values of the reference's `Model.init` pytree `params` (nested dicts
    of numpy arrays, `periods` stacked on axis 0 under keys "{i}:{kind}",
    `prefix` a list of the first dense layers' dicts, weights laid out
    (d_in, d_out), which the port keeps; nested leaves such as rwkv6's
    `ln_x.scale` or MLA's `q_norm.scale` become dotted names, list items
    their index: `prefix.0.attn.wkv_b_k`; the multi-codebook `embed.books`
    (K, V, D) and `head.w` (K, D, V) keep their shapes). The float32
    values are copied exactly; `load_state_dict` casts each to its
    parameter's dtype, the reference's `astype(cfg.dtype)`, and keeps the
    leaves the port holds in float32 (rwkv6's `w0`, `u`, `ln_x`; mamba's
    `dt_bias`, `A_log`, `D_skip`; the xattn `gate`; the codebooks' tables)
    in float32."""
    flat = dict(_flatten({k: v for k, v in params.items()
                          if k != "periods"}))
    n = cfg.n_periods()
    for key, stacked in _flatten(params["periods"]):
        if stacked.shape[0] != n:
            raise ValueError(f"periods.{key}: {stacked.shape[0]} stacked "
                             f"periods, expected {n}")
        for i in range(n):
            flat[f"periods.{i}.{key}"] = stacked[i]
    dev = torch.device(device)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)).to(dev)
            for k, v in flat.items()}


def train_state_from_reference(params: Mapping[str, Any], opt_state, cfg,
                               device):
    """(state dict, `AdamWState`) of the port holding the reference's
    training state: `params` its `Model.init` pytree, `opt_state` its
    `AdamWState(step, m, v)` (or a (step, m, v) tuple) with the moments
    shaped as `params`; numpy or jax leaves, as `store.restore` returns
    them. The periods are unstacked as in `params_from_reference`; every
    leaf is float32, the step a 0-d int32 tensor."""
    step, m, v = opt_state
    dev = torch.device(device)
    return params_from_reference(params, cfg, dev), AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev),
        m=params_from_reference(m, cfg, dev),
        v=params_from_reference(v, cfg, dev))


def train_state_to_reference(params: Mapping[str, torch.Tensor], opt_state,
                             cfg):
    """The inverse of `train_state_from_reference`: (params, AdamWState)
    in the reference's layout (nested dicts in sorted key order, `prefix`
    a list, each period's leaves stacked on axis 0), the leaves detached
    tensors on their device. `checkpoint.store.save` of {"params",
    "opt_state"} then writes the files `repro.launch.train` writes."""
    return _nest(params, cfg), AdamWState(
        step=opt_state.step.detach(), m=_nest(opt_state.m, cfg),
        v=_nest(opt_state.v, cfg))


def _nest(flat: Mapping[str, torch.Tensor], cfg) -> dict:
    """Dotted state-dict names back into the reference's pytree."""
    periods: dict = {}
    rest = {}
    for name, t in flat.items():
        if name.startswith("periods."):
            _, i, key = name.split(".", 2)
            periods.setdefault(key, {})[int(i)] = t.detach()
        else:
            rest[name] = t.detach()
    tree = _nested(rest)
    if "prefix" in tree:
        tree["prefix"] = [tree["prefix"][str(i)]
                          for i in range(len(tree["prefix"]))]
    tree["periods"] = _nested({
        key: torch.stack([by_period[i] for i in range(cfg.n_periods())])
        for key, by_period in periods.items()})
    return _sorted(tree)


def _nested(flat: Mapping[str, Any]) -> dict:
    tree: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return tree


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [_sorted(v) for v in tree]
    return tree


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    """(dotted path, leaf) pairs of nested dicts and lists."""
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    for key, sub in items:
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(sub, (Mapping, list, tuple)):
            yield from _flatten(sub, path)
        else:
            yield path, np.asarray(sub)
