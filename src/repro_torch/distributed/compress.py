"""Gradient compression with error feedback (cross-site sync traffic).

Port of `repro.distributed.compress`, with `torch.utils._pytree` in place
of `jax.tree_util`. int8 quantization with a per-leaf scale and an
error-feedback residual: the exchange moves 1 byte a parameter instead of
4, and the residual carried to the next round keeps the long-run update
unbiased.

Bits: `torch.round` rounds half to even, as `jnp.round` does, and every
step runs in float32 (the division gf / scale included), so `q`, `scale`
and the residual are bitwise the reference's on the same float32 inputs.
The scale divides by 127 held in a tensor on the values' device: CUDA
divides by a host scalar as a product with its reciprocal, which is an
ulp off the quotient for some maxima.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils import _pytree as pytree


def quantize_int8(g: torch.Tensor, err: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale f32 scalar, new_err)."""
    gf = g.to(torch.float32) + err
    scale = torch.clamp_min(torch.max(torch.abs(gf)), 1e-12) \
        / torch.full((), 127.0, device=gf.device)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    new_err = gf - q.to(torch.float32) * scale
    return q, scale, new_err


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads: Any, err_state: Any) -> tuple[Any, Any, Any]:
    """Quantize every leaf; returns (q_tree, scale_tree, new_err_state)."""
    flat, spec = pytree.tree_flatten(grads)
    # err_state's leaves in grads' order (dicts are matched by key)
    errs = pytree.tree_leaves(pytree.tree_map(lambda g, e: e, grads,
                                              err_state))
    qs, scales, new_errs = zip(*(quantize_int8(g, e)
                                 for g, e in zip(flat, errs))) \
        if flat else ((), (), ())
    return tuple(pytree.tree_unflatten(list(t), spec)
                 for t in (qs, scales, new_errs))


def init_error_state(grads_like: Any) -> Any:
    return pytree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like)


def crosspod_mean_int8(q_trees: list, scale_trees: list) -> Any:
    """The dequantized mean of the sites' (q, scale) trees, one tree a
    site: the reference's all-gather of int8 over the site axis is a stack
    on one device. Wire bytes = 1/4 of a float32 all-reduce."""
    def combine(*qs_and_ss):
        n = len(qs_and_ss) // 2
        qs = torch.stack(qs_and_ss[:n])
        ss = torch.stack(qs_and_ss[n:])
        deq = qs.to(torch.float32) * ss.reshape((-1,) + (1,) * (qs.ndim - 1))
        return deq.mean(dim=0)

    return pytree.tree_map(combine, *q_trees, *scale_trees)


def compressed_bytes(grads: Any) -> tuple[int, int]:
    """(int8 wire bytes, f32 wire bytes) for reporting."""
    leaves = pytree.tree_leaves(grads)
    n = sum(int(leaf.numel()) for leaf in leaves)
    return n + 4 * len(leaves), 4 * n
