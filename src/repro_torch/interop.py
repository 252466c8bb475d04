"""Carry state across from the reference package.

The lifecycle path has no learned weights: its state is the bound data
(and the fitted `beta` it returns). `from_reference` turns the numpy
arrays a caller binds to `repro` into tensors for `repro_torch`, so the
tests and `chip_smoke.py` feed both packages the same bytes;
`bcoo_from_reference` carries a reference BCOO (its numpy buffers) over.
`params_from_reference` turns the reference's LM parameter pytree into
the state dict of the port's `Model`.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .core.backend import to_device
from .core.sparse import BCOO


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
    weights laid out (d_in, d_out), which the port keeps; nested leaves
    such as rwkv6's `ln_x.scale` become dotted names). The float32 values
    are copied exactly; `load_state_dict` casts each to its parameter's
    dtype, the reference's `astype(cfg.dtype)`, and keeps the leaves the
    port holds in float32 (rwkv6's `w0`, `u`, `ln_x`; mamba's `dt_bias`,
    `A_log`, `D_skip`) in float32."""
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


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    """(dotted path, leaf) pairs of a nested dict."""
    for key, sub in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(sub, Mapping):
            yield from _flatten(sub, path)
        else:
            yield path, np.asarray(sub)
