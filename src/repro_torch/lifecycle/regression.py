"""Regression builtins: lm / lmDS / lmCG / steplm (paper Fig. 2).

Port of `repro.lifecycle.regression`: the same DSL programs, on the
port's runtime. `steplm` is Example 1: stepwise forward feature
selection by AIC, whose what-if `lm` calls expose the fine-grained
redundancy that lineage-based partial reuse eliminates
(gram(cbind(X_sel, c)) decomposes into a cached gram(X_sel) + fringe).

All builtins here are *placement-neutral* (§3.3): pass a
`federated_input` leaf as X and the same DSL programs compile to
federated plans — the optimizer lowers `gram`/`xtv` to `fed_gram`/
`fed_xtv`, per-site work runs as cached closures (one gram and one xtv
launch per site on the card), and only aggregates cross the exchange
boundary. `lmDS_federated` / `steplm_federated` are thin wrappers that
bind a `FederatedTensor` and call the ordinary builtins — there is no
second federated code path.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import ops
from repro_torch.core.dag import LTensor, input_tensor
from repro_torch.core.federated import FederatedTensor, federated_input
from repro_torch.core.runtime import LineageRuntime, get_runtime


def _rt(runtime: Optional[LineageRuntime]) -> LineageRuntime:
    return runtime or get_runtime()


def lmDS(X: LTensor, y: LTensor, reg: float = 1e-7, intercept: bool = False,
         runtime: Optional[LineageRuntime] = None) -> np.ndarray:
    """Closed-form ("direct solve") linear regression.

    beta = solve(t(X) %*% X + reg*I, t(X) %*% y) — the X^T X / X^T y pair
    is the paper's reusable intermediate (100.2 GFLOP per model at
    100K×1K, independent of reg)."""
    if intercept:
        X = ops.cbind(X, ops.ones((X.shape[0], 1)))
    n = X.shape[1]
    A = X.T @ X + reg * ops.eye(n)
    b = X.T @ y
    beta = ops.solve(A, b)
    return _rt(runtime).evaluate([beta])[0]


def lmCG(X: LTensor, y: LTensor, reg: float = 1e-7, tol: float = 1e-9,
         max_iter: int = 100,
         runtime: Optional[LineageRuntime] = None) -> np.ndarray:
    """Conjugate gradient on the normal equations (never forms t(X)%*%X).

    Mirrors DML lmCG: the hot ops are MV/VM against X; control flow runs
    in the control program (host), per SystemDS's hybrid plans."""
    rt = _rt(runtime)
    m, n = X.shape
    beta = np.zeros((n, 1))
    r_t = X.T @ y                       # initial residual = X^T y - A*0
    r = rt.evaluate([r_t])[0]
    p = r.copy()
    rs_old = float((r * r).sum())
    for _ in range(max_iter):
        pt = input_tensor("p", p)
        q_t = X.T @ (X @ pt) + reg * pt
        q = rt.evaluate([q_t])[0]
        alpha = rs_old / float((p * q).sum())
        beta = beta + alpha * p
        r = r - alpha * q
        rs_new = float((r * r).sum())
        if rs_new < tol * max(rs_old, 1e-30):
            break
        p = r + (rs_new / rs_old) * p
        rs_old = rs_new
    return beta


def lm(X: LTensor, y: LTensor, reg: float = 1e-7, intercept: bool = False,
       runtime: Optional[LineageRuntime] = None) -> np.ndarray:
    """DML `lm` dispatch: direct solve for narrow X, CG otherwise."""
    if X.shape[1] <= 1024:
        return lmDS(X, y, reg=reg, intercept=intercept, runtime=runtime)
    return lmCG(X, y, reg=reg, runtime=runtime)


def lmDS_federated(fx: FederatedTensor, y, reg: float = 1e-7,
                   intercept: bool = False,
                   runtime: Optional[LineageRuntime] = None) -> np.ndarray:
    """Federated lmDS *through the compiler* (§4.3 Example 2).

    Expressed in the DSL — the identical `lmDS` program over a
    federated leaf. The placement pass emits `fed_gram`/`fed_xtv`
    (intercept: the ones column is generated per site by the lowered
    `fed_map` cbind, exactly like the eager oracle), so exchange bytes
    match `repro_torch.core.federated.federated_lmds` while per-site
    work runs on the runtime's kernels and federated intermediates take
    part in lineage reuse. Exchange is metered in
    `runtime.stats.exchange`.
    """
    X = federated_input("fedX", fx)
    yt = y if isinstance(y, LTensor) else input_tensor("fedy", np.asarray(y))
    return lmDS(X, yt, reg=reg, intercept=intercept, runtime=runtime)


def steplm_federated(fx: FederatedTensor, y, reg: float = 1e-7,
                     max_features: Optional[int] = None,
                     intercept: bool = True,
                     runtime: Optional[LineageRuntime] = None
                     ) -> tuple[np.ndarray, list[int]]:
    """Federated stepwise regression (Example 1 over Example 2's data).

    The ordinary `steplm` DSL program over a federated leaf: candidate
    columns stay on their sites (`fed_map` slice/cbind), every
    candidate gram/xtv lowers to `fed_gram`/`fed_xtv`, and with a reuse
    cache attached the compensation-plan rewrite caches `fed_gram` of
    the selected block across candidates — federated partial reuse.
    """
    X = federated_input("fedX", fx)
    yt = y if isinstance(y, LTensor) else input_tensor("fedy", np.asarray(y))
    return steplm(X, yt, reg=reg, max_features=max_features,
                  intercept=intercept, runtime=runtime)


def _aic(n: int, rss: float, k: int) -> float:
    return n * float(np.log(max(rss, 1e-300) / n)) + 2.0 * k


def steplm(X: LTensor, y: LTensor, reg: float = 1e-7, max_features:
           Optional[int] = None, intercept: bool = True,
           runtime: Optional[LineageRuntime] = None
           ) -> tuple[np.ndarray, list[int]]:
    """Stepwise linear regression (Example 1, Fig. 2).

    Greedy forward selection on AIC. Each candidate model is lm() over
    cbind(X_selected, X[:, c]); with a reuse cache attached to the
    runtime, the compensation-plan rewrite turns gram(cbind(S, c)) into
    [[gram(S), xtv(S,c)], [t(xtv(S,c)), gram(c)]] so gram(S) — the bulk
    of the work — is computed once per outer iteration.
    """
    rt = _rt(runtime)
    m, ncol = X.shape
    y_np = rt.evaluate([y])[0] if not isinstance(y, np.ndarray) else y

    selected: list[int] = []
    # intercept-only baseline
    mean_y = float(y_np.mean())
    rss = float(((y_np - mean_y) ** 2).sum())
    best_aic = _aic(m, rss, 1)
    limit = max_features if max_features is not None else ncol
    best_beta = np.array([[mean_y]])

    cols = {c: X[:, c:c + 1] for c in range(ncol)}
    icpt = ops.ones((m, 1)) if intercept else None

    while len(selected) < limit:
        base_cols = ([icpt] if intercept else []) \
            + [cols[c] for c in selected]
        base = ops.cbind(*base_cols) if base_cols else None
        best_c, best_c_aic, best_c_beta = -1, best_aic, None
        for c in range(ncol):
            if c in selected:
                continue
            Xc = ops.cbind(base, cols[c]) if base is not None else cols[c]
            k = len(selected) + 1 + int(intercept)
            A = ops.gram(Xc) + reg * ops.eye(k)
            b = ops.xtv(Xc, y)
            beta_t = ops.solve(A, b)
            resid = y - Xc @ beta_t
            rss_t = ops.sum_(resid * resid)
            beta_v, rss_v = rt.evaluate([beta_t, rss_t])
            aic = _aic(m, float(rss_v), k + 1)
            if aic < best_c_aic:
                best_c, best_c_aic, best_c_beta = c, aic, beta_v
        if best_c < 0:
            break  # AIC no longer improves
        selected.append(best_c)
        best_aic = best_c_aic
        best_beta = best_c_beta
    return best_beta, selected
