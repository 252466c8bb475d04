"""Functional surface of the declarative DSL (DML-flavoured builtins).

These functions build HOP DAG nodes; nothing executes until
`repro_torch.core.runtime.evaluate` is called. Port of `repro.core.ops`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .dag import LTensor, as_ltensor, batch_input, make_node

__all__ = [
    "t", "matmul", "gram", "xtv", "rbind", "cbind", "solve", "cholesky",
    "inv", "diag", "diag_matrix", "sum_", "mean_", "min_", "max_", "trace",
    "colSums", "rowSums", "colMeans", "rowMeans", "colVars", "colMaxs",
    "colMins", "nnz", "exp", "log", "sqrt", "abs_", "sign", "sigmoid",
    "round_", "minimum", "maximum", "where", "ones", "zeros", "full", "eye",
    "rand", "seq", "replace_nan", "cumsum", "quantile", "batch_input",
]

# `batch_input` (re-exported from `dag`) is the §5 task-parallel config
# axis: a leaf whose node has the per-config element shape while the
# binding is the stacked (k, ...) array — the batching pass
# (`repro_torch.core.batching`) hoists varying literals/leaves into these,
# and `LineageRuntime.evaluate_batch` vmaps their consumers.


# -- structural -------------------------------------------------------------

def t(x: LTensor) -> LTensor:
    return as_ltensor(x).T


def matmul(a: LTensor, b: LTensor) -> LTensor:
    return as_ltensor(a) @ as_ltensor(b)


def gram(x: LTensor) -> LTensor:
    """tsmm: X^T X — SystemDS's dedicated fused operator (maps to the
    hand-written CUDA `gram` kernel on the GPU)."""
    x = as_ltensor(x)
    n = x.shape[1]
    s = min(max(x.node.sparsity, 0.0), 1.0)
    base = min(max(1.0 - s * s, 0.0), 1.0)
    sp = min(1.0, max(1e-6, 1.0 - base ** min(x.shape[0], 1024)))
    return LTensor(make_node("gram", (x.node,), (n, n), x.dtype, sp))


def xtv(x: LTensor, v: LTensor) -> LTensor:
    """Fused X^T v (MV over the transpose without materializing t(X))."""
    x, v = as_ltensor(x), as_ltensor(v)
    assert x.shape[0] == v.shape[0], (x.shape, v.shape)
    shape = (x.shape[1],) + v.shape[1:]
    return LTensor(make_node("xtv", (x.node, v.node), shape,
                             np.result_type(x.dtype, v.dtype), 1.0))


def _concat(xs: Sequence[LTensor], axis: int, op: str) -> LTensor:
    xs = [as_ltensor(x) for x in xs]
    if len(xs) == 1:
        return xs[0]
    base = list(xs[0].shape)
    tot = 0
    for x in xs:
        for ax in range(len(base)):
            if ax != axis and x.shape[ax] != base[ax]:
                raise ValueError(f"{op}: shape mismatch {x.shape} vs {base}")
        tot += x.shape[axis]
    base[axis] = tot
    sp = float(np.average([x.node.sparsity for x in xs],
                          weights=[x.node.numel or 1 for x in xs]))
    dtype = np.result_type(*[x.dtype for x in xs])
    return LTensor(make_node(op, tuple(x.node for x in xs), tuple(base),
                             dtype, sp, axis=axis))


def rbind(*xs) -> LTensor:
    if len(xs) == 1 and isinstance(xs[0], (list, tuple)):
        xs = tuple(xs[0])
    return _concat(xs, 0, "rbind")


def cbind(*xs) -> LTensor:
    if len(xs) == 1 and isinstance(xs[0], (list, tuple)):
        xs = tuple(xs[0])
    return _concat(xs, 1, "cbind")


# -- linear solvers ----------------------------------------------------------

def solve(a: LTensor, b: LTensor) -> LTensor:
    a, b = as_ltensor(a), as_ltensor(b)
    assert a.shape[0] == a.shape[1] == b.shape[0]
    return LTensor(make_node("solve", (a.node, b.node), b.shape,
                             np.result_type(a.dtype, b.dtype, np.float64), 1.0))


def cholesky(a: LTensor) -> LTensor:
    a = as_ltensor(a)
    return LTensor(make_node("cholesky", (a.node,), a.shape, a.dtype, 0.5))


def inv(a: LTensor) -> LTensor:
    a = as_ltensor(a)
    return LTensor(make_node("inv", (a.node,), a.shape, a.dtype, 1.0))


def diag(x: LTensor) -> LTensor:
    """Extract diagonal of a matrix as a column vector."""
    x = as_ltensor(x)
    n = min(x.shape)
    return LTensor(make_node("diag", (x.node,), (n, 1), x.dtype, 1.0))


def diag_matrix(v: LTensor) -> LTensor:
    """Column vector -> diagonal matrix."""
    v = as_ltensor(v)
    n = v.shape[0]
    return LTensor(make_node("diagm", (v.node,), (n, n), v.dtype,
                             max(1.0 / n, 1e-6)))


# -- aggregates ---------------------------------------------------------------

def _agg(x, op, shape, keep_sparsity=False):
    x = as_ltensor(x)
    sp = x.node.sparsity if keep_sparsity else 1.0
    dtype = x.dtype if np.issubdtype(x.dtype, np.floating) else np.float64
    return LTensor(make_node(op, (x.node,), shape, dtype, sp))


def sum_(x): return _agg(x, "sum", ())
def mean_(x): return _agg(x, "mean", ())
def min_(x): return _agg(x, "min", ())
def max_(x): return _agg(x, "max", ())
def trace(x): return _agg(x, "trace", ())
def nnz(x): return _agg(x, "nnz", ())


def colSums(x):
    x = as_ltensor(x)
    return _agg(x, "colSums", (1, x.shape[1]))


def rowSums(x):
    x = as_ltensor(x)
    return _agg(x, "rowSums", (x.shape[0], 1))


def colMeans(x):
    x = as_ltensor(x)
    return _agg(x, "colMeans", (1, x.shape[1]))


def rowMeans(x):
    x = as_ltensor(x)
    return _agg(x, "rowMeans", (x.shape[0], 1))


def colVars(x):
    x = as_ltensor(x)
    return _agg(x, "colVars", (1, x.shape[1]))


def colMaxs(x):
    x = as_ltensor(x)
    return _agg(x, "colMaxs", (1, x.shape[1]))


def colMins(x):
    x = as_ltensor(x)
    return _agg(x, "colMins", (1, x.shape[1]))


def cumsum(x):
    x = as_ltensor(x)
    return LTensor(make_node("cumsum", (x.node,), x.shape, x.dtype, 1.0))


def quantile(x, q: float):
    """Per-column nan-aware quantile as a *host-op node* (SystemDS runs
    sort-based order statistics in the control program).

    Unlike an `evaluate()` round trip, this keeps quantile-based
    cleaning (impute_by_median, outlier_by_iqr, winsorize) inside one
    plan: lineage is preserved through the quantile, so downstream
    reuse sees the whole pipeline. The op is in
    `backend.NON_TRACEABLE_OPS` — the segmenter isolates it and the
    runtime executes it eagerly on the host.
    """
    x = as_ltensor(x)
    if x.ndim != 2:
        raise ValueError(f"quantile requires a matrix, got shape {x.shape}")
    if not 0.0 <= float(q) <= 1.0:
        raise ValueError(f"quantile q must be in [0, 1], got {q}")
    return LTensor(make_node("quantile", (x.node,), (1, x.shape[1]),
                             np.float64, 1.0, q=float(q)))


# -- elementwise ---------------------------------------------------------------

def _unary(x, op, sparsity_preserving=False):
    x = as_ltensor(x)
    sp = x.node.sparsity if sparsity_preserving else 1.0
    return LTensor(make_node(op, (x.node,), x.shape, x.dtype, sp))


def exp(x): return _unary(x, "exp")
def log(x): return _unary(x, "log")
def sqrt(x): return _unary(x, "sqrt", True)
def abs_(x): return _unary(x, "abs", True)
def sign(x): return _unary(x, "sign", True)
def sigmoid(x): return _unary(x, "sigmoid")
def round_(x): return _unary(x, "round", True)


def minimum(a, b):
    return as_ltensor(a)._bin(b, "min2")


def maximum(a, b):
    return as_ltensor(a)._bin(b, "max2")


def where(cond: LTensor, a, b) -> LTensor:
    cond = as_ltensor(cond)
    a, b = as_ltensor(a, like=cond), as_ltensor(b, like=cond)
    shape = np.broadcast_shapes(cond.shape, a.shape, b.shape)
    dtype = np.result_type(a.dtype, b.dtype)
    return LTensor(make_node("where", (cond.node, a.node, b.node),
                             tuple(shape), dtype, 1.0))


def replace_nan(x: LTensor, value: float) -> LTensor:
    x = as_ltensor(x)
    return LTensor(make_node("replace_nan", (x.node,), x.shape, x.dtype, 1.0,
                             value=float(value)))


# -- generators ------------------------------------------------------------------

def full(shape, value, dtype=np.float64) -> LTensor:
    shape = tuple(int(s) for s in shape)
    return LTensor(make_node("full", (), shape, dtype,
                             0.0 if value == 0 else 1.0, value=float(value)))


def ones(shape, dtype=np.float64):
    return full(shape, 1.0, dtype)


def zeros(shape, dtype=np.float64):
    return full(shape, 0.0, dtype)


def eye(n, dtype=np.float64) -> LTensor:
    return LTensor(make_node("eye", (), (n, n), dtype, max(1.0 / n, 1e-6)))


def seq(start, stop, step=1, dtype=np.float64) -> LTensor:
    n = int(max(0, np.floor((stop - start) / step) + 1))
    return LTensor(make_node("seq", (), (n, 1), dtype, 1.0,
                             start=float(start), stop=float(stop),
                             step=float(step)))


def rand(shape, seed: int, dist: str = "uniform", sparsity: float = 1.0,
         dtype=np.float64) -> LTensor:
    """Random generator. The seed is part of the lineage (SystemDS traces
    "non-determinism like system-generated seeds")."""
    shape = tuple(int(s) for s in shape)
    return LTensor(make_node("rand", (), shape, dtype, sparsity,
                             seed=int(seed), dist=dist,
                             sparsity_gen=float(sparsity)))
