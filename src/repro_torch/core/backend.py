"""Runtime operation library (the TensorBlock operation layer, §3.2/§3.3).

Port of `repro.core.backend`, dense lane. Every HOP is implemented as a
*kernel builder*: `attrs -> fn(*inputs)`, registered in
`_KERNEL_BUILDERS`. The returned kernels are plain functions on torch
tensors, so the same registry serves both execution modes:

  * standalone — `execute_op` builds and calls one kernel eagerly (the
                 per-instruction interpreter / `fuse=False` path)
  * fused      — `repro_torch.core.segments.build_segment_fn` chains the
                 kernels of a segment into one closure (cached by
                 `repro_torch.core.jit_cache`)

Kernels take device tensors and return device tensors; generators
(`literal`, `full`, `eye`, `seq`) are built for an explicit device and
take their dtype from the node, never from torch's default dtype.
`gram`/`xtv` (and their `chunk_*` forms) route through
`repro_torch.kernels.gram.ops`: the hand-written CUDA kernels on a CUDA
tensor, the plain torch version on a CPU tensor.

Dtype rules follow the reference's observable behaviour: comparison
and logical ops return float32 (SystemDS 0/1 matrices), `nnz` returns
float64, `solve`/`cholesky`/`inv` compute in float64, and binary ops
promote both operands to their common dtype first (torch would let a
0-d operand lose to a dimensioned one; jax does not).

Format metadata (`leaf_format`, `infer_format`, `HAS_SPARSE`) is carried
unchanged so the compiler and cost model make the reference's decisions;
the `bcoo` kernel variants are not ported yet (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, Optional

import numpy as np
import torch

from .dag import SPARSE_THRESHOLD, Node

# The sparse format exists in the plan vocabulary (the compiler and cost
# model read it exactly like the reference); executing it is refused by
# the runtime until the bcoo kernels are ported.
HAS_SPARSE = True

# physical format names used across compiler/segments/runtime
DENSE = "dense"
BCOO = "bcoo"

# Minimum element count before a leaf is worth converting to BCOO.
SPARSE_MIN_NUMEL = 1 << 12

# Unary ops with f(0) == 0: the sparsity structure survives them.
ZERO_PRESERVING_UNARY = frozenset({
    "neg", "abs", "sqrt", "sign", "round", "floor", "ceil",
})


def leaf_format(node: Node) -> str:
    """Physical format for an input leaf, from propagated estimates."""
    if node.placement != "local":
        return DENSE
    if node.attr("batch") is not None:
        return DENSE
    if (HAS_SPARSE and len(node.shape) == 2
            and node.sparsity < SPARSE_THRESHOLD
            and node.numel >= SPARSE_MIN_NUMEL):
        return BCOO
    return DENSE


def bcoo_passthrough_arg(node: Node) -> Optional[int]:
    """Index of the input whose BCOO structure passes through `node`
    unchanged, or None for dense-producing ops."""
    if node.op == "t" or node.op in ZERO_PRESERVING_UNARY:
        return 0
    if node.op == "mul" and len(node.inputs) == 2:
        a, b = node.inputs
        if b.shape == ():  # matrix * scalar keeps the sparse structure
            return 0
        if a.shape == ():
            return 1
    return None


def infer_format(node: Node, in_fmts: tuple[str, ...]) -> str:
    """Output format of one HOP given its input formats."""
    if not HAS_SPARSE or BCOO not in in_fmts:
        return DENSE
    i = bcoo_passthrough_arg(node)
    if i is not None and in_fmts[i] == BCOO:
        return BCOO
    return DENSE


# ---------------------------------------------------------------------------
# host <-> device
# ---------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """The device an entry point computes on: `cuda` (the current card)
    unless another is asked for. Raises when CUDA is requested but absent
    — never falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a numpy dtype (bfloat16 from `ml_dtypes` included)."""
    dtype = np.dtype(dtype)
    if dtype.name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def to_device(arr, device: torch.device) -> torch.Tensor:
    """Upload a host value (numpy array or scalar) to `device`, keeping
    its dtype and strides; tensors pass through (moved if elsewhere)."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        if not a.flags.writeable:
            a = a.copy()  # torch.from_numpy wants a writable buffer
        t = torch.from_numpy(a)
    return t.to(device)


def to_numpy(x) -> np.ndarray:
    """Host numpy copy of a runtime value (never a view of runtime or
    cache state, so callers may mutate results)."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16, only needed for bf16 results
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def synchronize(device: torch.device) -> None:
    """Wait for the device's current stream (a no-op on the CPU): the
    synchronous lane's equivalent of the reference's block_until_ready."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _promote(*xs: torch.Tensor) -> list[torch.Tensor]:
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


# ---------------------------------------------------------------------------
# op implementations
# ---------------------------------------------------------------------------

def _rows(x: torch.Tensor) -> torch.Tensor:
    """`x` with contiguous rows, as the gram kernels read it (a column
    slice keeps its leading dimension and is not copied)."""
    if x.ndim == 2 and x.shape[1] > 1 and x.stride(1) != 1:
        return x.contiguous()
    return x


def _gram(x):
    from repro_torch.kernels.gram import ops as gram_ops
    return gram_ops.gram(_rows(x))


def _xtv(x, v):
    from repro_torch.kernels.gram import ops as gram_ops
    x, v = _promote(x, v)
    return gram_ops.xtv(_rows(x), _rows(v))


def _matmul(a, b):
    # a plain product the reference leaves to XLA: torch.matmul here
    a, b = _promote(a, b)
    return torch.matmul(a, b)


def _nan_where(ok: torch.Tensor, x: torch.Tensor,
               lower: bool = False) -> torch.Tensor:
    """`x` where the factorization succeeded, else NaN — the value jax's
    Cholesky-based routines return for a non-positive-definite input
    (torch would raise); `lower` keeps a factor's zero upper triangle, as
    jax's `cholesky` does. No host sync: the check stays on device."""
    nan = torch.full_like(x, float("nan"))
    return torch.where(ok, x, nan.tril() if lower else nan)


def _solve(a, b):
    a = a.to(torch.float64)
    b = b.to(torch.float64)
    vec = b.ndim == 1
    if vec:
        b = b[:, None]
    if a.shape[0] == a.shape[1]:
        # SPD fast path (normal equations): Cholesky solve, NaN if not PD
        # (jax.scipy.linalg.solve(assume_a="pos"))
        low, info = torch.linalg.cholesky_ex(a)
        out = _nan_where(info == 0, torch.cholesky_solve(b, low))
    else:
        # minimum-norm least squares through the SVD with jnp.linalg.lstsq's
        # default cutoff (torch's CUDA lstsq offers only full-rank gels)
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        rcond = torch.finfo(a.dtype).eps * max(a.shape)
        keep = s > rcond * s[0]
        s_inv = torch.where(keep, 1.0 / s, torch.zeros_like(s))
        out = vh.mT @ (s_inv[:, None] * (u.mT @ b))
    return out[:, 0] if vec else out


def _cholesky(x):
    low, info = torch.linalg.cholesky_ex(x.to(torch.float64))
    return _nan_where(info == 0, low, lower=True)


def _inv(x):
    # a singular input gives all-NaN; jax's LU leaves a mix of NaN and
    # inf there (ROADMAP Queue 3 records the difference)
    out, info = torch.linalg.inv_ex(x.to(torch.float64))
    return _nan_where(info == 0, out)


def _slice(x, index):
    idx = []
    for (start, stop, kind) in index:
        idx.append(start if kind == 1 else slice(start, stop))
    return x[tuple(idx)]


def _transpose(x):
    return x.permute(*reversed(range(x.ndim)))


def _f32(mask: torch.Tensor) -> torch.Tensor:
    return mask.to(torch.float32)


def _bin(fn):
    return lambda a, b: fn(*_promote(a, b))


_BINARY = {
    "add": _bin(torch.add), "sub": _bin(torch.sub), "mul": _bin(torch.mul),
    "div": _bin(torch.true_divide), "pow": _bin(torch.pow),
    "min2": _bin(torch.minimum), "max2": _bin(torch.maximum),
    "gt": _bin(lambda a, b: _f32(a > b)),
    "lt": _bin(lambda a, b: _f32(a < b)),
    "ge": _bin(lambda a, b: _f32(a >= b)),
    "le": _bin(lambda a, b: _f32(a <= b)),
    "eq": _bin(lambda a, b: _f32(a == b)),
    "ne": _bin(lambda a, b: _f32(a != b)),
    "and": lambda a, b: _f32(torch.logical_and(a != 0, b != 0)),
    "or": lambda a, b: _f32(torch.logical_or(a != 0, b != 0)),
}

_UNARY = {
    "neg": torch.neg, "exp": torch.exp, "log": torch.log,
    "sqrt": torch.sqrt, "abs": torch.abs, "sign": torch.sign,
    "round": torch.round, "floor": torch.floor, "ceil": torch.ceil,
    "sigmoid": torch.sigmoid,
    "not": lambda x: _f32(x == 0),
}

_AGG = {
    "sum": torch.sum, "mean": torch.mean,
    "max": torch.amax, "min": torch.amin,
    "trace": torch.trace,
    "nnz": lambda x: torch.count_nonzero(x).to(torch.float64),
    "colSums": lambda x: torch.sum(x, dim=0, keepdim=True),
    "rowSums": lambda x: torch.sum(x, dim=1, keepdim=True),
    "colMeans": lambda x: torch.mean(x, dim=0, keepdim=True),
    "rowMeans": lambda x: torch.mean(x, dim=1, keepdim=True),
    "colMaxs": lambda x: torch.amax(x, dim=0, keepdim=True),
    "colMins": lambda x: torch.amin(x, dim=0, keepdim=True),
    "colVars": lambda x: torch.var(x, dim=0, keepdim=True, correction=1),
}


# ---------------------------------------------------------------------------
# Kernel registry: op name -> (attrs -> fn(*inputs))
# ---------------------------------------------------------------------------

KernelFn = Any  # Callable[..., torch.Tensor]

_KERNEL_BUILDERS: dict[str, Any] = {}

# Chunked instructions (out-of-core streaming): a `chunk_*` op is a
# *partial* aggregate — its kernel is exactly the base op over whatever
# rows it is handed (one bucket on the streaming path, all rows on the
# interpreter); `combine` is the accumulator handoff, an identity.
COMBINE_OP = "combine"
CHUNK_BASE_OPS: dict[str, Optional[str]] = {
    "chunk_gram": "gram", "chunk_xtv": "xtv",
    "chunk_colsums": "colSums", "chunk_sum": "sum", COMBINE_OP: None,
}

# Ops the segmenter isolates and the runtime executes eagerly on the host
# path: `quantile` (sort-based order statistics in numpy). The reference
# also lists its federated ops here; they are not ported yet.
NON_TRACEABLE_OPS: frozenset[str] = frozenset({"quantile"})


def register_kernel(op: str):
    """Register `builder(attrs) -> fn(*inputs)` for an op."""
    def deco(builder):
        _KERNEL_BUILDERS[op] = builder
        return builder
    return deco


def get_kernel(op: str, attrs: dict[str, Any]) -> KernelFn:
    """Build the kernel for one instruction. `attrs` is the node's
    attribute dict plus `_shape` (output shape), `_dtype` (output numpy
    dtype) and `_device` (torch device) for generator ops."""
    builder = _KERNEL_BUILDERS.get(op)
    if builder is None:
        raise NotImplementedError(f"op {op!r}")
    return builder(attrs)


def _register_table(table: dict[str, Any]) -> None:
    for op, fn in table.items():
        _KERNEL_BUILDERS[op] = (lambda f: lambda attrs: f)(fn)


_register_table(_BINARY)
_register_table(_UNARY)
_register_table(_AGG)

register_kernel("matmul")(lambda attrs: _matmul)
register_kernel("gram")(lambda attrs: _gram)
register_kernel("xtv")(lambda attrs: _xtv)
register_kernel("t")(lambda attrs: _transpose)
register_kernel("solve")(lambda attrs: _solve)
register_kernel("cholesky")(lambda attrs: _cholesky)
register_kernel("inv")(lambda attrs: _inv)
register_kernel("diag")(lambda attrs: lambda x: torch.diagonal(x)[:, None])
register_kernel("diagm")(lambda attrs: lambda x: torch.diag(x[:, 0]))
register_kernel("cumsum")(lambda attrs: lambda x: torch.cumsum(x, dim=0))


@register_kernel("slice")
def _build_slice(attrs):
    index = attrs["index"]
    return lambda x: _slice(x, index)


@register_kernel("reshape")
def _build_reshape(attrs):
    newshape = attrs["newshape"]
    return lambda x: torch.reshape(x, newshape)


def _build_concat(attrs):
    axis = attrs["axis"]
    return lambda *xs: torch.cat(_promote(*xs), dim=axis)


_KERNEL_BUILDERS["rbind"] = _build_concat
_KERNEL_BUILDERS["cbind"] = _build_concat


@register_kernel("where")
def _build_where(attrs):
    def run(c, a, b):
        a, b = _promote(a, b)
        return torch.where(c != 0, a, b)
    return run


@register_kernel("replace_nan")
def _build_replace_nan(attrs):
    value = attrs["value"]
    return lambda x: torch.nan_to_num(x, nan=value)


@register_kernel("quantile")
def _build_quantile(attrs):
    """Host op (in NON_TRACEABLE_OPS): per-column nan-aware quantile via
    numpy's sort-based implementation, as in the reference."""
    q = attrs["q"]

    def run(x):
        arr = to_numpy(x).astype(np.float64, copy=False)
        out = np.nanquantile(arr, q, axis=0, keepdims=True)
        return to_device(out, x.device)
    return run


@register_kernel("literal")
def _build_literal(attrs):
    # built once per (value, dtype, device); kernels never write in place
    t = torch.tensor(attrs["value"], dtype=torch_dtype(attrs["_dtype"]),
                     device=attrs["_device"])
    return lambda: t


@register_kernel("full")
def _build_full(attrs):
    shape, value = attrs.get("_shape", ()), attrs["value"]
    dtype, device = torch_dtype(attrs["_dtype"]), attrs["_device"]
    return lambda: torch.full(shape, value, dtype=dtype, device=device)


@register_kernel("eye")
def _build_eye(attrs):
    n = attrs["_shape"][0]
    dtype, device = torch_dtype(attrs["_dtype"]), attrs["_device"]
    return lambda: torch.eye(n, dtype=dtype, device=device)


@register_kernel("seq")
def _build_seq(attrs):
    n = attrs["_shape"][0]
    start, step = attrs["start"], attrs["step"]
    dtype, device = torch_dtype(attrs["_dtype"]), attrs["_device"]
    return lambda: (start + step * torch.arange(
        n, dtype=torch.float64, device=device))[:, None].to(dtype)


@register_kernel("rand")
def _build_rand(attrs):
    raise NotImplementedError(
        "rand draws JAX threefry bits in the reference; the port's "
        "bit-exact generator is not written yet (ROADMAP Queue 1 item 2)")


@lru_cache(maxsize=4096)
def _kernel_cached(op: str, attrs: tuple, shape: tuple, dtype: np.dtype,
                   device: torch.device) -> KernelFn:
    if op in CHUNK_BASE_OPS:
        # chunk partials ARE the base op over the rows they are handed
        base = CHUNK_BASE_OPS[op]
        if base is None:  # combine: the accumulator handoff
            return lambda x: x
        op = base
    d = dict(attrs)
    d.update(_shape=shape, _dtype=dtype, _device=device)
    return get_kernel(op, d)


def kernel_for_node(node: Node, device: torch.device) -> KernelFn:
    """Memoized kernel lookup for a HOP node on `device` — kernels depend
    only on (op, attrs, shape, dtype, device), so repeated plan
    executions reuse one closure instead of rebuilding."""
    return _kernel_cached(node.op, node.attrs, node.shape, node.dtype,
                          torch.device(device))


def execute_op(op: str, attrs: dict[str, Any], inputs: list,
               dtype=np.float64, device=None) -> Any:
    """Execute one instruction eagerly on tensors (the reference's
    `execute_op`; `dtype`/`device` only matter for generators, which are
    built on `cuda` unless another device is asked for)."""
    d = dict(attrs)
    d.setdefault("_dtype", np.dtype(dtype))
    d.setdefault("_device", resolve_device(device))
    return get_kernel(op, d)(*inputs)
