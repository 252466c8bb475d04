"""Model validation / selection builtins (paper §5 workloads).

Port of `repro.lifecycle.validation`.

`grid_search_lm` is the HPO workload of Fig. 5/6: train k lmDS models
with different regularization λ over the same X — X^T X and X^T y are
λ-independent, so a reuse-enabled runtime computes them once.

`cross_validate_lm` is the CV workload of Fig. 7: k-fold cross
validation where X_train = rbind(folds ∖ i); the compensation-plan
rewrite decomposes gram/xtv over the rbind so per-fold partial products
are computed once and summed per configuration ("multiplications of the
individual folds and element-wise addition", §5.4).

Both are built on `parfor` — the §5 task-parallel loop over independent
configurations. The declarative contract is that the *system* chooses
the parallelization: `parfor` merges the k per-config plans into one
batched template (`repro_torch.core.batching`), and the cost model picks
between executing the whole grid as ONE vmapped segment stack
(config-invariant prefix computed once, config-variant suffix mapped
over the batch axis by `torch.func.vmap`, its gram/xtv one batched
kernel launch each) or the sequential per-config loop with lineage
reuse — structurally divergent configs always take the sequential path.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core import ops
from repro_torch.core.batching import (BatchingError, choose_mode,
                                       compile_batched)
from repro_torch.core.dag import LTensor, input_tensor
from repro_torch.core.runtime import LineageRuntime, get_runtime


def parfor(configs: Sequence, build_fn: Callable,
           runtime: Optional[LineageRuntime] = None,
           mode: str = "auto") -> list[list[np.ndarray]]:
    """Task-parallel loop over independent configurations (§5 `parfor`).

    `build_fn(config)` declares one configuration's outputs (an
    `LTensor` or a sequence of them); `parfor` returns one list of
    numpy outputs per configuration, in order.

    `mode` selects the execution strategy:
      * ``'auto'`` (default) — merge the k plans into one batched
        template and let `repro_torch.core.batching.choose_mode` arbitrate
        vmapped-batched vs sequential-reuse execution; plans that
        cannot merge (structural divergence, unstackable leaves) fall
        back to the sequential loop;
      * ``'vmap'`` — force the batched path (raises `BatchingError`
        when no template exists);
      * ``'shard'`` — force the batched path AND split the bucket axis
        over the device mesh's `config` axis (one slice of the grid per
        logical device, vmapped; `repro_torch.distributed.use_mesh`);
        degrades to plain vmap at run time when no realizable mesh is
        attached or the bucket does not divide;
      * ``'sequential'`` — force the per-config loop (the sequential path:
        one plan per config, lineage reuse across them).
    """
    if mode not in ("auto", "vmap", "shard", "sequential"):
        raise ValueError(
            f"parfor mode {mode!r} not in auto|vmap|shard|sequential")
    rt = runtime or get_runtime()
    config_outputs: list[list[LTensor]] = []
    for cfg in configs:
        out = build_fn(cfg)
        config_outputs.append([out] if isinstance(out, LTensor)
                              else list(out))
    k = len(config_outputs)
    if k == 0:
        return []
    if mode in ("vmap", "shard") and k < 2:
        raise BatchingError("batching needs >= 2 configurations")
    if mode != "sequential" and k >= 2:
        try:
            bplan = compile_batched(
                config_outputs, reuse_enabled=rt.cache is not None,
                opt_level=rt.opt_level)
        except BatchingError:
            if mode in ("vmap", "shard"):
                raise
            bplan = None
        if bplan is not None:
            roots_list = [[o.node for o in outs]
                          for outs in config_outputs]
            bplan.mode = (mode if mode in ("vmap", "shard")
                          else choose_mode(
                bplan, roots_list, rt.cache is not None,
                rt.sparse_inputs))
            try:
                if bplan.mode in ("vmap", "shard"):
                    return rt.evaluate_batch(bplan)
            finally:
                # the hoisted (k, ...) stacks are parfor-internal:
                # unbind them so repeated calls don't grow the global
                # leaf registry without bound
                bplan.release_leaves()
    return [rt.evaluate(outs) for outs in config_outputs]


def grid_search_lm(X: LTensor, y: LTensor, lambdas: Sequence[float],
                   runtime: Optional[LineageRuntime] = None,
                   mode: str = "auto"
                   ) -> tuple[np.ndarray, list[float]]:
    """Train one lmDS model per λ; returns (betas [n, k], training losses).

    Declared once per λ through `parfor`: gram(X)/xtv(X, y) are
    λ-invariant, so the batched path computes them once and vmaps only
    the solve + loss suffix over the λ axis; the sequential fallback
    recovers them through the lineage reuse cache instead.
    """
    n = X.shape[1]

    def model(lam: float):
        A = ops.gram(X) + float(lam) * ops.eye(n)
        b = ops.xtv(X, y)
        beta_t = ops.solve(A, b)
        resid = y - X @ beta_t
        loss_t = ops.sum_(resid * resid)
        return beta_t, loss_t

    results = parfor(list(lambdas), model, runtime=runtime, mode=mode)
    betas = [beta for beta, _ in results]
    losses = [float(loss) for _, loss in results]
    return np.concatenate(betas, axis=1), losses


def make_folds(x: np.ndarray, y: np.ndarray, k: int, seed: int = 42
               ) -> tuple[list[LTensor], list[LTensor]]:
    """Split into k folds ONCE as leaf tensors — stable leaves are what
    make per-fold intermediates reusable across fold iterations."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(x.shape[0])
    idxs = np.array_split(perm, k)
    fx = [input_tensor(f"foldX{i}", x[idx]) for i, idx in enumerate(idxs)]
    fy = [input_tensor(f"foldY{i}", y[idx]) for i, idx in enumerate(idxs)]
    return fx, fy


def cross_validate_lm(folds_x: list[LTensor], folds_y: list[LTensor],
                      reg: float = 1e-7,
                      runtime: Optional[LineageRuntime] = None,
                      mode: str = "auto"
                      ) -> tuple[np.ndarray, list[float]]:
    """k-fold CV for lmDS; returns (betas [n, k], held-out MSEs).

    Fold i's training leaves differ per configuration, so the batched
    template stacks them into batched leaves (equal fold sizes
    permitting — `np.array_split` remainders force the sequential
    path, where the reuse rewrites still share per-fold grams).
    """
    k = len(folds_x)
    n = folds_x[0].shape[1]

    def model(i: int):
        tx = [f for j, f in enumerate(folds_x) if j != i]
        ty = [f for j, f in enumerate(folds_y) if j != i]
        X = ops.rbind(*tx)
        y = ops.rbind(*ty)
        A = ops.gram(X) + reg * ops.eye(n)
        b = ops.xtv(X, y)
        beta_t = ops.solve(A, b)
        resid = folds_y[i] - folds_x[i] @ beta_t
        mse_t = ops.mean_(resid * resid)
        return beta_t, mse_t

    results = parfor(list(range(k)), model, runtime=runtime, mode=mode)
    betas = [beta for beta, _ in results]
    errors = [float(mse) for _, mse in results]
    return np.concatenate(betas, axis=1), errors
