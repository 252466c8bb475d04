"""The transformer-era sharding rule tables of the launch layer's dry run.

Port of `repro.distributed.legacy_rules`: the regex-driven spec policy
for the model zoo's parameters (embed/attn/moe/rwkv/mamba paths), kept out
of the DSL's placement (`repro_torch.core.compiler.lower_distributed`)
and read by the dry run (`repro_torch.launch.dryrun`), which sizes each
device's shard of a model, its optimizer state, its batch and its caches
with these builders. `repro_torch.distributed.sharding` re-exports them.

A spec is the port's tuple (one entry per dimension: an axis name, a
tuple of names or None) and `safe_spec` drops any axis that does not
divide its dimension. The rules match the port's parameter names (the
dotted `Model.named_parameters()` names, "periods.{i}.{key}.attn.wq").
The port keeps one module per period where the reference stacks the
periods on a leading axis, so a period's leaf takes the reference's spec
without the leading None the reference adds (`legacy_rules.py:98-100`);
cache leaves keep their leading (n_periods,) axis in both packages, so
`cache_specs` keeps that offset.

Do not extend this table; new placement logic belongs in the compiler
passes.
"""
from __future__ import annotations

import math
import re
from typing import Any

import torch

from ..optim.adamw import AdamWState
from .sharding import safe_spec

# (name-regex, spec builder) — first match wins. `dp` = data axes.
_RULES: list[tuple[str, Any]] = [
    # embeddings / head
    (r"embed\.tok$",         lambda dp: ("model", dp)),
    (r"embed\.books$",       lambda dp: (None, "model", dp)),
    (r"head\.w$",            lambda dp: (dp, "model")),
    # gqa attention
    (r"attn\.w[qkv]$",       lambda dp: (dp, "model")),
    (r"attn\.wo$",           lambda dp: ("model", dp)),
    (r"xattn\.w[qkv]$",      lambda dp: (dp, "model")),
    (r"xattn\.wo$",          lambda dp: ("model", dp)),
    # mla
    (r"attn\.wq_a$",         lambda dp: (dp, None)),
    (r"attn\.wq_b$",         lambda dp: (None, "model")),
    (r"attn\.wkv_a$",        lambda dp: (dp, None)),
    (r"attn\.wkv_b_[kv]$",   lambda dp: (None, "model", None)),
    # dense mlp
    (r"mlp\.w_(gate|up)$",   lambda dp: (dp, "model")),
    (r"mlp\.w_down$",        lambda dp: ("model", dp)),
    (r"(moe|rwkv)\.shared\.w_(gate|up)$", lambda dp: (dp, "model")),
    (r"moe\.shared\.w_down$", lambda dp: ("model", dp)),
    # moe experts (EP on model)
    (r"moe\.router$",        lambda dp: (dp, None)),
    (r"moe\.w_(gate|up)$",   lambda dp: ("model", dp, None)),
    (r"moe\.w_down$",        lambda dp: ("model", None, dp)),
    # rwkv6
    (r"rwkv\.w[rkvg]$",      lambda dp: (dp, "model")),
    (r"rwkv\.wo$",           lambda dp: ("model", dp)),
    (r"rwkv\.w[rk]_c$",      lambda dp: (dp, "model")),
    (r"rwkv\.wv_c$",         lambda dp: ("model", dp)),
    (r"rwkv\.tm_w1$",        lambda dp: (dp, None)),
    (r"rwkv\.wA$",           lambda dp: (dp, None)),
    (r"rwkv\.u$",            lambda dp: ("model", None)),
    # mamba
    (r"mamba\.in_proj$",     lambda dp: (dp, "model")),
    (r"mamba\.conv_w$",      lambda dp: ("model", None, None)),
    (r"mamba\.x_proj$",      lambda dp: ("model", None)),
    (r"mamba\.dt_proj$",     lambda dp: (None, "model")),
    (r"mamba\.A_log$",       lambda dp: ("model", None)),
    (r"mamba\.out_proj$",    lambda dp: ("model", dp)),
]


def _shape(leaf) -> tuple:
    """A leaf's shape: a tensor's, or a (shape, dtype) spec's."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape)
    return tuple(leaf[0])


def _is_leaf(x) -> bool:
    return isinstance(x, torch.Tensor) or (
        isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], tuple)
        and isinstance(x[1], (torch.dtype, type)))


def _map(fn, tree, path: str = ""):
    """`fn(path, leaf)` over a tree of dicts, lists, tuples and
    `AdamWState`s whose leaves are tensors or (shape, dtype) specs; dict
    keys (dotted parameter names) and list indices join the path with
    "."."""
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, AdamWState):
        return AdamWState(*(_map(fn, v, path) for v in tree))
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{path}.{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{path}.{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(param_shapes: Any, mesh, data_axes=("data",),
                fsdp: bool = True) -> Any:
    """Spec tree matching a parameter (or optimizer-state) tree keyed by
    the port's parameter names."""
    dp = data_axes if len(data_axes) > 1 else data_axes[0]
    dp = dp if fsdp else None

    def assign(path, leaf):
        shape = _shape(leaf) if _is_leaf(leaf) else ()
        spec: tuple = ()
        for pat, builder in _RULES:
            if re.search(pat, path):
                spec = builder(dp)
                break
        return safe_spec(shape, spec, mesh)

    return _map(assign, param_shapes)


def batch_specs(batch: Any, mesh, data_axes=("pod", "data")) -> Any:
    """Shard the leading (batch) dim of every leaf on the data axes."""
    dp = tuple(a for a in data_axes if a in mesh.shape)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)

    def assign(_, leaf):
        shape = _shape(leaf)
        return safe_spec(shape, (dp,) + (None,) * (len(shape) - 1), mesh)

    return _map(assign, batch)


def cache_specs(cache_shapes: Any, mesh, batch: int,
                data_axes=("pod", "data"), seq_axis_name="model") -> Any:
    """Decode-cache sharding: batch on data, sequence on `model`.

    For batch=1 (long-context) the batch axis is unshardable, so the
    sequence axis takes every available device instead."""
    dp = tuple(a for a in data_axes if a in mesh.shape)
    dp_size = math.prod(int(mesh.shape[a]) for a in dp)
    long_context = batch % max(dp_size, 1) != 0
    dpa = dp if len(dp) > 1 else (dp[0] if dp else None)

    def assign(path, leaf):
        shape = _shape(leaf)
        ndim = len(shape)
        if ndim == 0:
            return ()
        off = 1 if path.startswith("periods") else 0  # stacked periods
        spec = [None] * ndim
        if ndim > off:
            # batch axis
            if not long_context:
                spec[off] = dpa
            # sequence axis for kv/latent caches (large 2nd dim)
            if ndim > off + 1 and shape[off + 1] >= 4096:
                spec[off + 1] = (dp + (seq_axis_name,)) if long_context \
                    else seq_axis_name
            elif ndim > off + 1 and long_context and \
                    shape[off + 1] % 2 == 0 and shape[off + 1] >= 1024:
                spec[off + 1] = seq_axis_name
        return safe_spec(shape, tuple(spec), mesh)

    return _map(assign, cache_shapes)
