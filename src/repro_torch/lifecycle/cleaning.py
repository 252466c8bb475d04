"""Data cleaning / preparation builtins (SystemDS §4.2).

Port of `repro.lifecycle.cleaning`: the same DSL programs, on the port's
runtime (the card unless the runtime was built with `device="cpu"`).
Vectorized implementations over the DSL: masking turns missing-value
imputation and outlier handling into sequences of full matrix operations
("masking allows data slicing and missing value imputation ... via
sequences of full matrix operations", §4.2), which keeps them inside the
compiler's optimization scope and trivially distributable.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import ops
from repro_torch.core.dag import LTensor, input_tensor
from repro_torch.core.runtime import LineageRuntime, get_runtime


def _rt(runtime):
    return runtime or get_runtime()


def isnan_mask(X: LTensor) -> LTensor:
    """1.0 where NaN (NaN != NaN)."""
    return X._bin(X, "ne")


def scale_matrix(X: LTensor, center: bool = True, scale: bool = True,
                 runtime: Optional[LineageRuntime] = None) -> np.ndarray:
    """z-score standardization (DML `scale`)."""
    out = X
    if center:
        out = out - ops.colMeans(out)
    if scale:
        out = out / ops.sqrt(ops.colVars(X))
    return _rt(runtime).evaluate([out])[0]


def impute_by_mean(X: LTensor, runtime: Optional[LineageRuntime] = None
                   ) -> np.ndarray:
    """Replace NaNs by per-column means of observed values (mask algebra)."""
    mask = isnan_mask(X)                      # 1 where missing
    x0 = ops.replace_nan(X, 0.0)
    obs = X.shape[0] - ops.colSums(mask)      # observed count per column
    mu = ops.colSums(x0) / ops.maximum(obs, 1.0)
    out = x0 + mask * mu
    return _rt(runtime).evaluate([out])[0]


def impute_by_median(X: LTensor, runtime: Optional[LineageRuntime] = None
                     ) -> np.ndarray:
    """Median imputation. The median is an `ops.quantile` *host-op
    node* (sort-based order statistics run in the control program, like
    SystemDS's quantiles) rather than an `evaluate()` round trip — the
    whole pipeline stays one plan, so lineage (and therefore downstream
    reuse) flows through it."""
    med = ops.quantile(X, 0.5)
    out = ops.where(isnan_mask(X), med, X)
    return _rt(runtime).evaluate([out])[0]


def mice_lite(X: LTensor, n_iter: int = 3, reg: float = 1e-3,
              runtime: Optional[LineageRuntime] = None) -> np.ndarray:
    """Chained-equation imputation (mice, §4.2 ref [71]) via mask algebra.

    Each round regresses every incomplete column on the others over the
    *observed* rows (row mask folded into the normal equations:
    gram(M⊙X) and (M⊙X)^T y — full matrix ops, no gather/scatter), then
    rewrites only the missing entries.
    """
    rt = _rt(runtime)
    x_np = rt.evaluate([X])[0] if isinstance(X, LTensor) else np.asarray(X)
    miss = np.isnan(x_np)
    # init: mean imputation
    mu = np.nanmean(x_np, axis=0, keepdims=True)
    cur = np.where(miss, mu, x_np)
    n, d = cur.shape
    for _ in range(n_iter):
        for j in range(d):
            mj = miss[:, j]
            if not mj.any() or mj.all():
                continue
            others = [k for k in range(d) if k != j]
            Xo = input_tensor("miceX", cur[:, others])
            yj = input_tensor("micey", cur[:, j:j + 1])
            w = input_tensor("micew", (~mj).astype(np.float64)[:, None])
            Xw = Xo * w                      # zero out unobserved rows
            yw = yj * w
            A = ops.gram(Xw) + reg * ops.eye(d - 1)
            b = ops.xtv(Xw, yw)
            beta_t = ops.solve(A, b)
            pred_t = Xo @ beta_t
            pred = rt.evaluate([pred_t])[0]
            cur[mj, j] = pred[mj, 0]
    return cur


def outlier_by_iqr(X: LTensor, k: float = 1.5, repair: str = "nan",
                   runtime: Optional[LineageRuntime] = None) -> np.ndarray:
    """Flag/repair values outside [Q1 - k·IQR, Q3 + k·IQR] per column.

    Quantiles are host-op nodes; the mask algebra stays in the DSL, so
    the whole repair is one plan with unbroken lineage."""
    X = X if isinstance(X, LTensor) else input_tensor("iqrX", np.asarray(X))
    q1 = ops.quantile(X, 0.25)
    q3 = ops.quantile(X, 0.75)
    iqr = q3 - q1
    lo, hi = q1 - k * iqr, q3 + k * iqr
    bad = (X < lo)._bin(X > hi, "or")
    if repair == "nan":
        out = ops.where(bad, float("nan"), X)
    elif repair == "clip":
        out = ops.minimum(ops.maximum(X, lo), hi)
    else:  # repair == "flag"
        out = bad
    # comparison kernels produce 0/1 f32 matrices; callers of this
    # builtin always got f64 back
    return np.asarray(_rt(runtime).evaluate([out])[0], dtype=np.float64)


def outlier_by_sd(X: LTensor, k: float = 3.0, repair: str = "nan",
                  runtime: Optional[LineageRuntime] = None) -> np.ndarray:
    """Flag/repair values beyond k standard deviations (DSL mask algebra)."""
    rt = _rt(runtime)
    mu = ops.colMeans(X)
    sd = ops.sqrt(ops.colVars(X))
    dev = ops.abs_(X - mu)
    bad = dev > (k * sd)
    x_np, bad_np = rt.evaluate([X, bad])
    if repair == "nan":
        return np.where(bad_np != 0, np.nan, x_np)
    if repair == "clip":
        mu_np, sd_np = rt.evaluate([mu, sd])
        return np.clip(x_np, mu_np - k * sd_np, mu_np + k * sd_np)
    return bad_np


def winsorize(X: LTensor, lower: float = 0.05, upper: float = 0.95,
              runtime: Optional[LineageRuntime] = None) -> np.ndarray:
    """Clamp each column to its [lower, upper] quantiles.

    One plan, one evaluation: both quantiles are host-op nodes feeding
    the clamp directly (previously this evaluated X, re-entered the DSL
    with fresh leaves, and evaluated again — severing lineage and
    computing X twice)."""
    X = X if isinstance(X, LTensor) else input_tensor("winsX", np.asarray(X))
    out = ops.minimum(ops.maximum(X, ops.quantile(X, lower)),
                      ops.quantile(X, upper))
    return _rt(runtime).evaluate([out])[0]
