"""Runtime operation library (the TensorBlock operation layer, §3.2/§3.3).

Port of `repro.core.backend`. Every HOP is implemented as a *kernel
builder*: `attrs -> fn(*inputs)`, registered in `_KERNEL_BUILDERS`. The
returned kernels are plain functions on torch tensors, so the same
registry serves both execution modes:

  * standalone — `execute_op` builds and calls one kernel eagerly (the
                 per-instruction interpreter / `fuse=False` path)
  * fused      — `repro_torch.core.segments.build_segment_fn` chains the
                 kernels of a segment into one closure (cached by
                 `repro_torch.core.jit_cache`)

Two physical representations, as in the reference:

  * dense — torch tensors (float64 on the lifecycle path)
  * bcoo  — `sparse.BCOO`, the port's own copy of jax's BCOO value:
            int32 row-major (nse, 2) indices beside an (nse,) data
            tensor, for 2-D matrices below `dag.SPARSE_THRESHOLD`

Formats are assigned at compile time (`compiler.assign_formats`) and
kernels are selected per (op, input formats) when a closure is built
(`register_sparse_kernel`, `get_kernel`): ops without a sparse variant
get the dense kernel behind a densify boundary. `gram`/`xtv` route
through `repro_torch.kernels.gram.ops` on dense operands and through
`repro_torch.kernels.spmm.ops` (with `matmul`) on bcoo ones: the
hand-written CUDA kernels on a CUDA tensor, the plain torch versions on a
CPU tensor. Every kernel also runs inside `torch.func.vmap` (the parfor
lane's config-variant segments): gram and xtv take their custom ops'
vmap rules there, one batched launch over the whole batch.

Kernels take device tensors and return device tensors; generators
(`literal`, `full`, `eye`, `seq`) are built for an explicit device and
take their dtype from the node, never from torch's default dtype.

Dtype rules follow the reference's observable behaviour: comparison
and logical ops return float32 (SystemDS 0/1 matrices), `nnz` returns
float64, `solve`/`cholesky`/`inv` compute in float64, and binary ops
promote both operands to their common dtype first (torch would let a
0-d operand lose to a dimensioned one; jax does not).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, Optional

import numpy as np
import torch

from .dag import SPARSE_THRESHOLD, Node
from .sparse import BCOO as SparseMatrix  # the value; BCOO below is the name

# The bcoo lane is ported: `sparse.BCOO` values, their kernels in
# `repro_torch.kernels.spmm`.
HAS_SPARSE = True

# physical format names used across compiler/segments/runtime
DENSE = "dense"
BCOO = "bcoo"

# Minimum element count before a leaf is worth converting to BCOO.
SPARSE_MIN_NUMEL = 1 << 12

# Unary ops with f(0) == 0: applying them to BCOO data preserves the
# sparsity structure exactly. Single source for both the format rule
# (infer_format) and the sparse kernel registrations below.
_ZERO_PRESERVING_FNS = {
    "neg": torch.neg, "abs": torch.abs, "sqrt": torch.sqrt,
    "sign": torch.sign, "round": torch.round, "floor": torch.floor,
    "ceil": torch.ceil,
}
ZERO_PRESERVING_UNARY = frozenset(_ZERO_PRESERVING_FNS)


def is_sparse(x) -> bool:
    return isinstance(x, SparseMatrix)


def densify(x):
    return x.todense() if isinstance(x, SparseMatrix) else x


def block_ready(x) -> None:
    """Wait for the device work that produces `x` (dense or BCOO)."""
    buf = x.data if isinstance(x, SparseMatrix) else x
    if isinstance(buf, torch.Tensor) and buf.device.type == "cuda":
        torch.cuda.current_stream(buf.device).synchronize()


def _bucket_nse(nse: int) -> int:
    """Round a buffer size up to its power-of-two bucket (min 256)."""
    return 256 if nse <= 256 else 1 << (nse - 1).bit_length()


def sparsify(arr):
    """Host dense -> BCOO conversion (leaf binding on the bcoo format),
    the reference's `sparsify` in numpy: row-major sorted int32 indices,
    nse padded up to its power-of-two bucket with zero-valued duplicates
    of the last index (nse is part of every closure's signature, so
    batches of similar density share warm closures), `unique_indices`
    always False. The result holds CPU tensors; `to_device` uploads it.
    A non-matrix stays dense."""
    a = np.asarray(arr)
    if a.ndim != 2:
        return a
    rows, cols = np.nonzero(a)
    indices = np.ascontiguousarray(
        np.stack([rows, cols], axis=1).astype(np.int32))
    data = a[rows, cols]
    nse = len(data)
    pad = min(_bucket_nse(nse), a.size) - nse
    if pad > 0:
        tail = indices[-1:] if nse else np.zeros((1, 2), dtype=np.int32)
        indices = np.concatenate([indices, np.repeat(tail, pad, axis=0)])
        data = np.concatenate([data, np.zeros(pad, dtype=data.dtype)])
    cpu = torch.device("cpu")
    return SparseMatrix(to_device(data, cpu), torch.from_numpy(indices),
                        a.shape, indices_sorted=True, unique_indices=False)


def maybe_sparsify(arr, sparsity_est: float):
    """Convert a 2-D array to BCOO when the estimate says it pays off: below
    `SPARSE_THRESHOLD` and with at least `SPARSE_MIN_NUMEL` elements;
    anything else is returned unchanged.

    The reference's legacy eager heuristic (plans take their formats from
    `compiler.assign_formats`), for standalone array-level callers. Like
    `jsparse.BCOO.fromdense` it does not pad: nse is the number of
    nonzeros, indices are int32 and row-major sorted. A numpy array gives
    CPU tensors; a tensor keeps its device. The reference also checks
    `HAS_SPARSE`; the port always has its own `BCOO` (`core/sparse.py`),
    so no such check is needed."""
    if isinstance(arr, torch.Tensor):
        numel = arr.numel()
    else:
        numel = int(np.size(arr)) if hasattr(arr, "ndim") else 0
    if not (sparsity_est < SPARSE_THRESHOLD and getattr(arr, "ndim", 0) == 2
            and numel >= SPARSE_MIN_NUMEL):
        return arr
    t = arr if isinstance(arr, torch.Tensor) else \
        to_device(arr, torch.device("cpu"))
    idx = torch.nonzero(t)  # row-major order
    return SparseMatrix(t[idx[:, 0], idx[:, 1]], idx.to(torch.int32),
                        t.shape, indices_sorted=True, unique_indices=True)


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


def to_device(arr, device: torch.device):
    """Upload a host value (numpy array or scalar) to `device`, keeping
    its dtype and strides; tensors and BCOO values pass through (moved if
    elsewhere)."""
    if isinstance(arr, (torch.Tensor, SparseMatrix)):
        return arr.to(device)
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        if not a.flags.writeable or any(s % a.itemsize for s in a.strides):
            # torch.from_numpy wants a writable buffer whose strides are
            # whole elements (a field of a packed record array is not)
            a = a.copy()
        t = torch.from_numpy(a)
    return t.to(device)


def to_numpy(x) -> np.ndarray:
    """Host numpy copy of a runtime value (never a view of runtime or
    cache state, so callers may mutate results); a BCOO densifies."""
    if isinstance(x, SparseMatrix):
        x = x.todense()
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    t = x.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        # numpy has no bfloat16 of its own: a bf16 result comes back as
        # `ml_dtypes.bfloat16` (the reference's type) where that package
        # is installed, and raises where it is not. Nothing else of the
        # port needs it: the serving path returns int tokens.
        try:
            import ml_dtypes
        except ImportError as e:
            raise RuntimeError(
                "to_numpy: a bfloat16 result needs the `ml_dtypes` package "
                "for numpy's bfloat16, and it is not installed; cast the "
                "value to float32 first") from e
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

def _gram(x):
    from repro_torch.kernels.gram import ops as gram_ops
    if gram_ops.vmapped(x):
        # the custom op's vmap rule: one batched launch over the batch
        return gram_ops.gram_op(x)
    return gram_ops.gram(gram_ops.rows(x))


def _xtv(x, v):
    from repro_torch.kernels.gram import ops as gram_ops
    x, v = _promote(x, v)
    if gram_ops.vmapped(x, v):
        if v.ndim == 1:
            return gram_ops.xtv_op(x, v[:, None])[:, 0]
        return gram_ops.xtv_op(x, v)
    return gram_ops.xtv(gram_ops.rows(x), gram_ops.rows(v))


# Largest n * c for which a one-row product takes the fixed-order route.
ROW_PRODUCT_MAX_ELEMS = 1 << 20


def _row_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(1, n) @ (n, c) summed in a fixed pairwise order: the products in
    one elementwise pass, then halves added until one row is left. Every
    step is elementwise, so the bits of a row do not depend on how many
    rows run beside it (under `torch.func.vmap` the serving lane stacks
    1, 2, 4, ... requests); torch.matmul does not keep that: on the CPU
    and under cuBLAS a single row and a stack of rows go to different
    kernels, which sum in different orders."""
    p = a.mT * b                      # (n, c): row i scaled by a[0, i]
    while p.shape[-2] > 1:
        h = p.shape[-2] // 2
        s = p[..., :h, :] + p[..., h:2 * h, :]
        p = torch.cat([s, p[..., 2 * h:, :]], dim=-2) \
            if p.shape[-2] % 2 else s
    return p


def _matmul(a, b):
    # a plain product the reference leaves to XLA: torch.matmul, but a
    # one-row left operand (a served request's x @ beta) is summed in a
    # fixed order, so a coalesced score is bitwise the solo one
    a, b = _promote(a, b)
    if (a.dim() == 2 and b.dim() == 2 and a.shape[0] == 1 and a.shape[1]
            and a.shape[1] * b.shape[1] <= ROW_PRODUCT_MAX_ELEMS):
        return _row_product(a, b)
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


# Sparse kernel variants, keyed by (op, input format tuple) and mapping
# to (builder, output format). A variant is only picked when its output
# format matches the one the compiler assigned (`mul(bcoo, scalar)`
# keeps BCOO, `mul(bcoo, matrix)` takes the dense kernel behind a
# densify boundary).
_SPARSE_KERNEL_BUILDERS: dict[tuple[str, tuple[str, ...]],
                              tuple[Any, str]] = {}


def register_kernel(op: str):
    """Register `builder(attrs) -> fn(*inputs)` for an op."""
    def deco(builder):
        _KERNEL_BUILDERS[op] = builder
        return builder
    return deco


def register_sparse_kernel(op: str, in_fmts: tuple[str, ...],
                           out_fmt: str = DENSE):
    """Register a sparse variant for (op, input formats) -> out_fmt."""
    def deco(builder):
        _SPARSE_KERNEL_BUILDERS[(op, tuple(in_fmts))] = (builder, out_fmt)
        return builder
    return deco


def _densifying(kern: KernelFn) -> KernelFn:
    return lambda *xs: kern(*[densify(x) for x in xs])


def get_kernel(op: str, attrs: dict[str, Any],
               in_fmts: Optional[tuple[str, ...]] = None,
               out_fmt: str = DENSE) -> KernelFn:
    """Build the kernel for one instruction. `attrs` is the node's
    attribute dict plus `_shape` (output shape), `_dtype` (output numpy
    dtype) and `_device` (torch device) for generator ops; `in_fmts` /
    `out_fmt` are the compile-time formats (an all-dense tuple for dense
    operands; None when unknown, as for `execute_op`). A BCOO input with a
    registered variant producing `out_fmt` selects it here, when the
    closure is built; otherwise the dense kernel densifies its inputs."""
    if in_fmts and BCOO in in_fmts:
        entry = _SPARSE_KERNEL_BUILDERS.get((op, tuple(in_fmts)))
        if entry is not None and entry[1] == out_fmt:
            return entry[0](attrs)
    builder = _KERNEL_BUILDERS.get(op)
    if builder is None:
        raise NotImplementedError(f"op {op!r}")
    kern = builder(attrs)
    if in_fmts is None or BCOO in in_fmts:
        return _densifying(kern)
    return kern


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
    """JAX's threefry draw, bit for bit (`core/random.py`): float64
    uniform or normal, zeroed outside the sparsity mask, then cast to
    the node's dtype."""
    from . import random
    shape, seed = attrs["_shape"], attrs["seed"]
    dist, sp = attrs.get("dist"), attrs.get("sparsity_gen", 1.0)
    dtype, device = torch_dtype(attrs["_dtype"]), attrs["_device"]
    return lambda: random.rand(shape, seed, dist, sp, device).to(dtype)


# -- sparse (bcoo) kernel variants -------------------------------------------

def _spmm_ops():
    from repro_torch.kernels.spmm import ops as spmm_ops
    return spmm_ops


register_sparse_kernel("gram", (BCOO,))(
    lambda attrs: _spmm_ops().gram_bcoo)
register_sparse_kernel("xtv", (BCOO, DENSE))(
    lambda attrs: _spmm_ops().xtv_bcoo)
register_sparse_kernel("matmul", (BCOO, DENSE))(
    lambda attrs: _spmm_ops().matmul_bcoo)
# (DENSE, BCOO) needs no entry: the dense kernel's densify boundary
# computes the same dense @ todense(b)
register_sparse_kernel("matmul", (BCOO, BCOO))(
    lambda attrs: lambda a, b: _spmm_ops().matmul_bcoo(a, b.todense()))
register_sparse_kernel("t", (BCOO,), BCOO)(lambda attrs: lambda x: x.T)

for _op, _fn in _ZERO_PRESERVING_FNS.items():
    register_sparse_kernel(_op, (BCOO,), BCOO)(
        (lambda fn: lambda attrs: lambda x: x.with_data(fn(x.data)))(_fn))

# only selected when the compiler assigned a BCOO output, i.e. the dense
# operand is a scalar (see infer_format)
register_sparse_kernel("mul", (BCOO, DENSE), BCOO)(
    lambda attrs: lambda x, s: x.with_data(torch.mul(*_promote(x.data, s))))
register_sparse_kernel("mul", (DENSE, BCOO), BCOO)(
    lambda attrs: lambda s, x: x.with_data(torch.mul(*_promote(s, x.data))))


@lru_cache(maxsize=4096)
def _kernel_cached(op: str, attrs: tuple, shape: tuple, dtype: np.dtype,
                   device: torch.device, in_fmts: Optional[tuple],
                   out_fmt: str) -> KernelFn:
    if op in CHUNK_BASE_OPS:
        # chunk partials ARE the base op over the rows they are handed
        # (sparse variants included)
        base = CHUNK_BASE_OPS[op]
        if base is None:  # combine: the accumulator handoff
            return densify
        op = base
    d = dict(attrs)
    d.update(_shape=shape, _dtype=dtype, _device=device)
    return get_kernel(op, d, in_fmts=in_fmts, out_fmt=out_fmt)


def kernel_for_node(node: Node, device: torch.device,
                    in_fmts: Optional[tuple[str, ...]] = None,
                    out_fmt: str = DENSE) -> KernelFn:
    """Memoized kernel lookup for a HOP node on `device` — kernels depend
    only on (op, attrs, shape, dtype, device, formats), so repeated plan
    executions reuse one closure instead of rebuilding. `in_fmts` None
    means all-dense operands."""
    if in_fmts is None:
        in_fmts = (DENSE,) * len(node.inputs)
    return _kernel_cached(node.op, node.attrs, node.shape, node.dtype,
                          torch.device(device), tuple(in_fmts), out_fmt)


def execute_op(op: str, attrs: dict[str, Any], inputs: list,
               dtype=np.float64, device=None) -> Any:
    """Execute one instruction eagerly on tensors (the reference's
    `execute_op`: the dense kernel, which densifies BCOO inputs;
    `dtype`/`device` only matter for generators, which are built on
    `cuda` unless another device is asked for)."""
    d = dict(attrs)
    d.setdefault("_dtype", np.dtype(dtype))
    d.setdefault("_device", resolve_device(device))
    return get_kernel(op, d)(*inputs)
