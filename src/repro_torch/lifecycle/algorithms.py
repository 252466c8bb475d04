"""Classical ML algorithm builtins (SystemDS algorithm-library breadth, L3).

Port of `repro.lifecycle.algorithms`. Batch 1st/2nd-order algorithms
written on the DSL — the hot linear algebra runs through the lineage
runtime (and thus the hand-written gram/xtv kernels + reuse cache);
light control flow stays in the host control program, with the
reference's host steps (`np.linalg.eigh` for pca, `np.random.default_rng`
for kmeans' initial centers). Every iteration of kmeans, l2svm and
mlogreg is one or two `evaluate` calls, each binding (and uploading) X
anew, as in the reference. The programs are placement-neutral: `pca`
over a `federated_input` X compiles to fed_colsums / fed_map / fed_gram /
fed_mv instructions, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import ops
from repro_torch.core.dag import LTensor, input_tensor
from repro_torch.core.runtime import LineageRuntime, get_runtime


def _rt(runtime):
    return runtime or get_runtime()


def pca(X: LTensor, k: int, runtime: Optional[LineageRuntime] = None
        ) -> tuple[np.ndarray, np.ndarray]:
    """PCA via eigen-decomposition of the covariance (gram of centered X).

    Returns (components [d, k], projected [n, k])."""
    rt = _rt(runtime)
    n = X.shape[0]
    Xc = X - ops.colMeans(X)
    cov_t = ops.gram(Xc) * (1.0 / (n - 1))
    cov = rt.evaluate([cov_t])[0]
    evals, evecs = np.linalg.eigh(cov)
    order = np.argsort(evals)[::-1][:k]
    comps = evecs[:, order]
    proj_t = Xc @ input_tensor("pca_comps", comps)
    return comps, rt.evaluate([proj_t])[0]


def kmeans(X: LTensor, k: int, max_iter: int = 50, seed: int = 0,
           tol: float = 1e-6, runtime: Optional[LineageRuntime] = None
           ) -> tuple[np.ndarray, np.ndarray]:
    """Lloyd's algorithm; distance algebra in the DSL, argmin in CP.

    dist(i,j) = ||x_i||² - 2 x_i·c_j + ||c_j||² — the cross term is a
    matmul, reusing the distributed backend for large n."""
    rt = _rt(runtime)
    n, d = X.shape
    x_sq = ops.rowSums(X * X)
    rng = np.random.default_rng(seed)
    x_np = rt.evaluate([X])[0]
    centers = x_np[rng.choice(n, size=k, replace=False)]
    assign = np.zeros(n, dtype=np.int64)
    for _ in range(max_iter):
        C = input_tensor("kmC", centers)
        cross_t = X @ C.T
        c_sq_t = ops.rowSums(C * C)
        cross, c_sq, xs = rt.evaluate([cross_t, c_sq_t, x_sq])
        dist = xs + c_sq.T - 2.0 * cross
        new_assign = dist.argmin(axis=1)
        onehot = np.zeros((n, k))
        onehot[np.arange(n), new_assign] = 1.0
        A = input_tensor("kmA", onehot)
        sums_t = ops.xtv(A, X)                 # A^T X: per-cluster sums
        counts_t = ops.colSums(A)
        sums, counts = rt.evaluate([sums_t, counts_t])
        counts = np.maximum(counts.T, 1.0)
        new_centers = sums / counts
        shift = float(np.abs(new_centers - centers).max())
        centers, assign = new_centers, new_assign
        if shift < tol:
            break
    return centers, assign


def l2svm(X: LTensor, y: LTensor, reg: float = 1.0, max_iter: int = 100,
          tol: float = 1e-9, runtime: Optional[LineageRuntime] = None
          ) -> np.ndarray:
    """L2-regularized squared-hinge SVM (DML l2svm): Newton-ish steps with
    line search; labels in {-1, +1}."""
    rt = _rt(runtime)
    n, d = X.shape
    w = np.zeros((d, 1))
    g_old = None
    s = None
    for it in range(max_iter):
        wt = input_tensor("svm_w", w)
        out_t = y * (X @ wt)
        hinge_t = ops.maximum(1.0 - out_t, 0.0)
        grad_t = reg * wt - ops.xtv(X, y * hinge_t)
        grad = rt.evaluate([grad_t])[0]
        gnorm = float((grad * grad).sum())
        if gnorm < tol:
            break
        if s is None:
            s = -grad
        else:
            beta_fr = gnorm / max(g_old, 1e-30)
            s = -grad + beta_fr * s
        g_old = gnorm
        # exact line search on the quadratic upper bound
        st = input_tensor("svm_s", s)
        Xs_t = X @ st
        hinge_v, Xs_v, out_v = rt.evaluate([hinge_t, Xs_t, out_t])
        active = (hinge_v > 0).astype(np.float64)
        denom = reg * float((s * s).sum()) + float(
            (active * (y_np_cache(y, rt) * Xs_v) ** 2).sum())
        num = -float((grad * s).sum())
        step = num / max(denom, 1e-30)
        w = w + step * s
    return w


_y_cache: dict[int, np.ndarray] = {}


def y_np_cache(y: LTensor, rt: LineageRuntime) -> np.ndarray:
    got = _y_cache.get(y.node.uid)
    if got is None:
        got = rt.evaluate([y])[0]
        _y_cache[y.node.uid] = got
    return got


def mlogreg(X: LTensor, y_onehot: LTensor, reg: float = 1e-4,
            lr: float = 0.5, max_iter: int = 200,
            runtime: Optional[LineageRuntime] = None) -> np.ndarray:
    """Multinomial logistic regression via gradient descent in the DSL."""
    rt = _rt(runtime)
    n, d = X.shape
    k = y_onehot.shape[1]
    W = np.zeros((d, k))
    for _ in range(max_iter):
        Wt = input_tensor("mlr_W", W)
        logits = X @ Wt
        emax = ops.colMaxs(logits.T).T          # rowMaxs via transpose
        ex = ops.exp(logits - emax)
        p = ex / ops.rowSums(ex)
        grad_t = ops.xtv(X, p - y_onehot) * (1.0 / n) + reg * Wt
        grad = rt.evaluate([grad_t])[0]
        W = W - lr * grad
        if float(np.abs(grad).max()) < 1e-7:
            break
    return W
