"""HOP DAG: the declarative linear-algebra IR (SystemDS §3.2).

Every user-level operation builds a `Node` in a high-level-operator DAG.
Nodes carry shape/dtype/sparsity estimates (size propagation) and a
structural *lineage hash* (SystemDS §4.1) that identifies the value a node
computes, given the lineage of its leaf inputs.

The DAG is lazy: `LTensor` wraps a node; evaluation happens through
`repro_torch.core.compiler.compile_plan` +
`repro_torch.core.runtime.LineageRuntime`.

Port of `repro.core.dag`: the DAG is device-neutral metadata, so node
dtypes stay numpy dtypes and bound leaves stay host numpy arrays; the
runtime uploads them to its device at dispatch.
"""
from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np

# --------------------------------------------------------------------------
# Node
# --------------------------------------------------------------------------

_counter = itertools.count()

# Density below which a 2D matrix is worth a sparse physical
# representation. Single source of truth shared by the cost model
# (`Node.est_bytes`, `repro_torch.core.costmodel`), the compile-time
# format assignment pass (`repro_torch.core.compiler.assign_formats`),
# and the executor (`repro_torch.core.backend`), so the compiler and the runtime
# always agree on when sparse pays off.
SPARSE_THRESHOLD = 0.3

# opcodes with their arity class; used for validation only
ELEMENTWISE_BINARY = {
    "add", "sub", "mul", "div", "pow", "min2", "max2",
    "gt", "lt", "ge", "le", "eq", "ne", "and", "or",
}
ELEMENTWISE_UNARY = {
    "neg", "exp", "log", "sqrt", "abs", "sign", "round", "floor", "ceil",
    "sigmoid", "not",
}
AGGREGATES = {"sum", "mean", "max", "min", "colSums", "rowSums", "colMeans",
              "rowMeans", "colMaxs", "colMins", "colVars", "trace", "nnz"}


@dataclass(frozen=True)
class Node:
    """One high-level operator (HOP)."""

    op: str
    inputs: tuple["Node", ...]
    attrs: tuple[tuple[str, Any], ...]  # sorted key/value pairs, hashable
    shape: tuple[int, ...]
    dtype: Any
    sparsity: float  # estimated nnz / numel in [0, 1]
    # Where the *value* lives: 'local' (device memory), 'federated'
    # (row-partitioned across sites, never materialized at the master),
    # 'sharded' (row-split over the device mesh's `data` axis: row
    # blocks of one global tensor, one per logical device) or 'chunked'
    # (row-chunked on host, streamed through device memory one bucket
    # at a time — only partial aggregates are ever resident).
    # Set on federated input leaves at construction and propagated by
    # the compiler's placement passes (`lower_federated` /
    # `lower_distributed` / `lower_chunked` in
    # `repro_torch.core.compiler`). Deliberately not part of the lineage
    # hash — placement describes a physical location, not a value.
    placement: str = "local"
    uid: int = field(default_factory=lambda: next(_counter))

    # -- helpers ----------------------------------------------------------
    def attr(self, key: str, default: Any = None) -> Any:
        for k, v in self.attrs:
            if k == key:
                return v
        return default

    @property
    def numel(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def est_bytes(self) -> int:
        """Memory estimate in bytes (dense; sparse gets a CSR-like discount)."""
        itemsize = np.dtype(self.dtype).itemsize
        dense = self.numel * itemsize
        if self.sparsity < SPARSE_THRESHOLD and len(self.shape) == 2:
            # values + column idx + row ptr, MCSR-style estimate
            nnz = int(self.numel * self.sparsity)
            return nnz * (itemsize + 4) + 4 * (self.shape[0] + 1)
        return dense

    # -- lineage hash ------------------------------------------------------
    def lhash(self, leaf_lineage: dict[int, str]) -> str:
        """Lineage hash given leaf lineage ids (uid -> stable id).

        Matches SystemDS's lineage DAG semantics: the hash identifies the
        *value*, i.e. two structurally identical computations over inputs
        with identical lineage collide (enabling reuse), while different
        input data or literals produce different hashes.

        Uncached by design: a per-node memo keyed on id(environment) can
        alias a dead environment after GC and return a stale hash, and a
        content key costs O(env) to build per call. Batch callers (the
        runtime) share one memo across a whole plan via `_lhash_rec`.
        """
        return _lhash_rec(self, leaf_lineage, {})

    def __repr__(self) -> str:  # concise
        return f"Node#{self.uid}:{self.op}{self.shape}"


def _lhash_rec(node: Node, leaf_lineage: dict[int, str], memo: dict[int, str]) -> str:
    got = memo.get(node.uid)
    if got is not None:
        return got
    if node.op == "input":
        base = leaf_lineage.get(node.uid)
        if base is None:
            base = f"input:{node.attr('name')}:{node.uid}"
        payload = f"leaf|{base}|{node.shape}"
    elif node.op == "literal":
        payload = f"lit|{node.attr('value')!r}|{node.dtype}"
    else:
        child = ",".join(_lhash_rec(i, leaf_lineage, memo) for i in node.inputs)
        payload = f"{node.op}|{node.attrs!r}|{node.shape}|{node.dtype}|{child}"
    h = hashlib.sha1(payload.encode()).hexdigest()
    memo[node.uid] = h
    return h


def structural_key(node: Node, memo: dict[int, str]) -> str:
    """Structural hash used by CSE: identical subgraphs (same leaves by uid)."""
    got = memo.get(node.uid)
    if got is not None:
        return got
    if node.op in ("input",):
        key = f"leaf{node.uid}"
    else:
        child = ",".join(structural_key(i, memo) for i in node.inputs)
        key = hashlib.sha1(
            f"{node.op}|{node.attrs!r}|{node.shape}|{node.dtype}|{child}"
            .encode()).hexdigest()
    memo[node.uid] = key
    return key


# --------------------------------------------------------------------------
# Shape / sparsity propagation (SystemDS §3.2 size propagation)
# --------------------------------------------------------------------------

def _bshape(a: tuple[int, ...], b: tuple[int, ...]) -> tuple[int, ...]:
    try:
        return tuple(np.broadcast_shapes(a, b))
    except ValueError as e:
        raise ValueError(f"incompatible shapes {a} vs {b}") from e


def _sp_mult(a: float, b: float) -> float:
    a, b = min(max(a, 0.0), 1.0), min(max(b, 0.0), 1.0)
    return max(a * b, 1e-6)  # independence assumption


def _sp_add(a: float, b: float) -> float:
    return min(1.0, a + b - a * b)


def make_node(op: str, inputs: Sequence[Node], shape, dtype, sparsity,
              placement: str = "local", **attrs) -> Node:
    return Node(op=op, inputs=tuple(inputs),
                attrs=tuple(sorted(attrs.items())),
                shape=tuple(int(d) for d in shape), dtype=np.dtype(dtype),
                sparsity=min(max(float(sparsity), 0.0), 1.0),
                placement=placement)


# --------------------------------------------------------------------------
# LTensor: the user-facing lazy tensor
# --------------------------------------------------------------------------

class LTensor:
    """Lazy tensor handle over a HOP DAG node.

    Supports numpy-flavoured operator overloading; `repro_torch.core.ops` provides
    the functional surface (t, matmul, rbind, ...).
    """

    __slots__ = ("node",)
    __array_priority__ = 100  # beat numpy operator dispatch

    def __init__(self, node: Node):
        self.node = node

    # -- metadata ----------------------------------------------------------
    @property
    def shape(self) -> tuple[int, ...]:
        return self.node.shape

    @property
    def ndim(self) -> int:
        return len(self.node.shape)

    @property
    def dtype(self):
        return self.node.dtype

    # -- arithmetic --------------------------------------------------------
    def _bin(self, other, op, reverse=False):
        other = as_ltensor(other, like=self)
        a, b = (other, self) if reverse else (self, other)
        shape = _bshape(a.shape, b.shape)
        dtype = np.result_type(a.dtype, b.dtype)
        if op in ("mul",):
            sp = _sp_mult(a.node.sparsity, b.node.sparsity)
        elif op in ("add", "sub"):
            sp = _sp_add(a.node.sparsity, b.node.sparsity)
        else:
            sp = 1.0
        if op in ("gt", "lt", "ge", "le", "eq", "ne", "and", "or"):
            dtype = np.dtype(np.float32)  # SystemDS semantics: 0/1 matrices
        return LTensor(make_node(op, (a.node, b.node), shape, dtype, sp))

    def __add__(self, o): return self._bin(o, "add")
    def __radd__(self, o): return self._bin(o, "add", True)
    def __sub__(self, o): return self._bin(o, "sub")
    def __rsub__(self, o): return self._bin(o, "sub", True)
    def __mul__(self, o): return self._bin(o, "mul")
    def __rmul__(self, o): return self._bin(o, "mul", True)
    def __truediv__(self, o): return self._bin(o, "div")
    def __rtruediv__(self, o): return self._bin(o, "div", True)
    def __pow__(self, o): return self._bin(o, "pow")
    def __gt__(self, o): return self._bin(o, "gt")
    def __lt__(self, o): return self._bin(o, "lt")
    def __ge__(self, o): return self._bin(o, "ge")
    def __le__(self, o): return self._bin(o, "le")
    def __neg__(self):
        return LTensor(make_node("neg", (self.node,), self.shape, self.dtype,
                                 self.node.sparsity))

    def __matmul__(self, other):
        other = as_ltensor(other, like=self)
        a, b = self.node, other.node
        if a.shape[-1] != b.shape[0]:
            raise ValueError(f"matmul shape mismatch {a.shape} @ {b.shape}")
        shape = a.shape[:-1] + b.shape[1:]
        # sparsity of product: 1 - (1 - sa*sb)^k, capped
        k = a.shape[-1]
        base = min(max(1.0 - _sp_mult(a.sparsity, b.sparsity), 0.0), 1.0)
        sp = min(1.0, max(1e-6, 1.0 - base ** min(k, 1024)))
        return LTensor(make_node("matmul", (a, b), shape,
                                 np.result_type(a.dtype, b.dtype), sp))

    # -- indexing ----------------------------------------------------------
    def __getitem__(self, idx):
        """Static (python int / slice) indexing only — keeps sizes known."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        norm: list[tuple[int, int, int]] = []  # (start, stop, kind) kind:0=slice,1=int
        shape = []
        for axis, it in enumerate(idx):
            dim = self.shape[axis]
            if isinstance(it, int):
                it = dim + it if it < 0 else it
                norm.append((it, it + 1, 1))
            elif isinstance(it, slice):
                start, stop, step = it.indices(dim)
                if step != 1:
                    raise ValueError("only unit-step slices supported")
                norm.append((start, stop, 0))
                shape.append(stop - start)
            else:
                raise TypeError(f"unsupported index {it!r}")
        for axis in range(len(idx), self.ndim):
            norm.append((0, self.shape[axis], 0))
            shape.append(self.shape[axis])
        return LTensor(make_node("slice", (self.node,), tuple(shape),
                                 self.dtype, self.node.sparsity,
                                 index=tuple(norm)))

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = tuple(int(s) for s in shape)
        if -1 in shape:
            known = -int(np.prod([s for s in shape if s != -1]))
            shape = tuple(self.node.numel // known if s == -1 else s
                          for s in shape)
        if int(np.prod(shape)) != self.node.numel:
            raise ValueError(f"cannot reshape {self.shape} -> {shape}")
        return LTensor(make_node("reshape", (self.node,), shape, self.dtype,
                                 self.node.sparsity, newshape=shape))

    @property
    def T(self):
        if self.ndim != 2:
            raise ValueError("T requires a matrix")
        return LTensor(make_node("t", (self.node,),
                                 (self.shape[1], self.shape[0]),
                                 self.dtype, self.node.sparsity))

    def __repr__(self):
        return f"LTensor({self.node.op}, shape={self.shape}, dtype={self.dtype})"


def as_ltensor(x, like: Optional[LTensor] = None) -> LTensor:
    if isinstance(x, LTensor):
        return x
    if isinstance(x, (int, float, bool, np.integer, np.floating)):
        dtype = like.dtype if like is not None else np.dtype(np.float32)
        if isinstance(x, bool):
            dtype = np.dtype(np.float32)
        node = make_node("literal", (), (), dtype,
                         0.0 if x == 0 else 1.0, value=float(x))
        return LTensor(node)
    if isinstance(x, np.ndarray) or hasattr(x, "__array__"):
        return input_tensor(None, np.asarray(x))
    raise TypeError(f"cannot convert {type(x)} to LTensor")


# --------------------------------------------------------------------------
# Leaf construction & data binding
# --------------------------------------------------------------------------

class _LeafRegistry:
    """Maps leaf node uid -> (bound array, lineage id)."""

    def __init__(self):
        self.values: dict[int, Any] = {}
        self.lineage: dict[int, str] = {}
        # per-leaf 4 KiB block-sum tables retained from the bind-time
        # content fingerprint (~0.2% of the leaf) — the streaming
        # executor's prefetch path DERIVES aligned slice fingerprints
        # from them instead of re-scanning the slices (see
        # `_slice_fingerprint`). Same soundness contract as `lineage`:
        # valid until the leaf is re-bound.
        self.fp_tables: dict[int, np.ndarray] = {}

    def bind(self, node: Node, value, lineage_id: str):
        self.values[node.uid] = value
        self.lineage[node.uid] = lineage_id
        self.fp_tables.pop(node.uid, None)


LEAVES = _LeafRegistry()
_input_counter = itertools.count()


_FP_WEIGHTS: dict[int, np.ndarray] = {}


def _fp_weights(n: int) -> np.ndarray:
    """Deterministic odd uint64 multipliers for the content checksum,
    memoized per length (lengths are few: the streaming executor's
    power-of-two chunk buckets plus whole-leaf sizes)."""
    w = _FP_WEIGHTS.get(n)
    if w is None:
        w = np.random.default_rng(0x5EED).integers(
            0, 1 << 63, size=n, dtype=np.uint64) | np.uint64(1)
        _FP_WEIGHTS[n] = w
    return w


_FP_BLOCK = 512  # uint64 words per checksum block (4 KiB)


def _fingerprint_and_table(arr: np.ndarray
                           ) -> tuple[str, Optional[np.ndarray]]:
    """`_fingerprint` that also returns the per-4 KiB block-sum table
    the large-buffer path reduces over (None on the small/raw path).
    The table is a free by-product of the scan the fingerprint already
    does; retaining it at leaf-bind time lets aligned slice
    fingerprints be *derived* later without touching the slice payload
    again (`_slice_fingerprint` — the streaming prefetch fast path)."""
    a = np.ascontiguousarray(arr)
    h = hashlib.sha1()
    h.update(str(a.shape).encode())
    h.update(str(a.dtype).encode())
    raw = a.view(np.uint8).reshape(-1)
    if raw.size <= 65536:
        h.update(raw.tobytes())
        return h.hexdigest(), None
    head = raw.size - (raw.size % 8)
    u = raw[:head].view(np.uint64)
    nb = u.size // _FP_BLOCK
    table = None
    if nb:
        blocks = u[: nb * _FP_BLOCK].reshape(nb, _FP_BLOCK)
        table = blocks.sum(axis=1, dtype=np.uint64)
        acc = (table * _fp_weights(nb)).sum(dtype=np.uint64)
        h.update(int(acc).to_bytes(8, "little"))
        u = u[nb * _FP_BLOCK:]
    h.update(u.tobytes())
    h.update(raw[head:].tobytes())
    return h.hexdigest(), table


def _fingerprint(arr: np.ndarray) -> str:
    """Cheap, deterministic content fingerprint for input lineage.

    Large buffers reduce to position-weighted 4 KiB-block sums mod
    2**64 (odd multipliers): any SINGLE word change is guaranteed to
    alter the checksum (its block sum shifts by delta, and delta * odd
    is never 0 mod 2**64), so one corrected cell always re-keys its
    chunk on the streaming executor's reuse path — no sampling blind
    spots. The whole buffer is read but the hot loop is a SIMD block
    sum (~0.2ms / 2 MB). Known insensitivity: permuting words WITHIN
    one 4 KiB block preserves its sum — far below the granularity of
    any chunk or leaf this keys."""
    return _fingerprint_and_table(arr)[0]


_FP_BLOCK_BYTES = _FP_BLOCK * 8  # 4 KiB


def _slice_fingerprint(sl: np.ndarray, table: np.ndarray,
                       byte_offset: int) -> Optional[str]:
    """Derive `_fingerprint(sl)` from the parent buffer's block-sum
    table without re-scanning the slice's full 4 KiB blocks.

    `sl` must be a contiguous slice of the table's parent starting
    `byte_offset` bytes in. Derivation is exact — bitwise the same hex
    digest `_fingerprint(sl)` computes — because the weight sequence is
    prefix-stable across lengths (`_fp_weights(n)` draws the same
    stream for every n) and the slice's own 4 KiB blocking coincides
    with the parent's whenever `byte_offset` is 4 KiB-aligned. Returns
    None when not derivable (unaligned offset, or the slice takes the
    small raw-bytes path): callers fall back to `_fingerprint`.

    Only the residual words past the last full block (< 4 KiB) are
    read from the slice itself, so deriving a bucket fingerprint is
    O(table slice) instead of O(bucket bytes) — the host-prep scan the
    streaming pipeline removes.
    """
    if byte_offset % _FP_BLOCK_BYTES:
        return None
    raw_n = sl.nbytes
    if raw_n <= 65536:
        return None  # raw path hashes actual bytes — nothing to derive
    head = raw_n - (raw_n % 8)
    nb = (head // 8) // _FP_BLOCK
    first = byte_offset // _FP_BLOCK_BYTES
    if first + nb > table.size:
        return None  # slice's full blocks overrun the parent's table
    h = hashlib.sha1()
    h.update(str(sl.shape).encode())
    h.update(str(sl.dtype).encode())
    if nb:
        acc = (table[first:first + nb]
               * _fp_weights(nb)).sum(dtype=np.uint64)
        h.update(int(acc).to_bytes(8, "little"))
    raw = np.ascontiguousarray(sl).view(np.uint8).reshape(-1)
    h.update(raw[nb * _FP_BLOCK_BYTES:head].tobytes())
    h.update(raw[head:].tobytes())
    return h.hexdigest()


def batch_input(name: Optional[str], stacked,
                sparsity: Optional[float] = None,
                lineage_id: Optional[str] = None) -> LTensor:
    """Create a *batched* leaf: one template node standing for k
    per-configuration values (the `parfor` config axis, §5).

    The node's shape/dtype/sparsity describe ONE element — size
    propagation, rewrites, and the cost model see the per-config plan —
    while the bound value is the stacked ``(k,) + elem_shape`` array.
    The batch axis exists only in the execution layer: the batched
    compiler (`repro_torch.core.batching`) marks every transitive
    consumer as config-variant and the runtime maps those segments over
    axis 0 with `torch.func.vmap`. Leaves carry ``batch=k`` in their
    attrs (still ``op == 'input'`` so leaf binding/lineage/rewrites need
    no special cases); `is_batched_leaf` is the single detection helper.
    """
    arr = np.asarray(stacked)
    if arr.ndim < 1 or arr.shape[0] < 1:
        raise ValueError(
            f"batch_input needs a stacked (k, ...) array, got {arr.shape}")
    k = int(arr.shape[0])
    if sparsity is None:
        if arr.size and np.issubdtype(arr.dtype, np.floating):
            sample = arr.ravel()[: 4096]
            sparsity = float(np.count_nonzero(sample)) / sample.size
        else:
            sparsity = 1.0
    name = name or f"cfg{next(_input_counter)}"
    node = make_node("input", (), arr.shape[1:], arr.dtype, sparsity,
                     name=name, batch=k)
    # lineage is content-only (no auto-generated name): re-hoisting the
    # same grid in a later parfor call yields the same lineage id, so
    # repeated identical grids hit the reuse cache across calls
    lid = lineage_id or f"batch:{_fingerprint(arr)}"
    LEAVES.bind(node, arr, lid)
    return LTensor(node)


def is_batched_leaf(node: Node) -> bool:
    """True for leaves created by `batch_input` (the hoisted config axis)."""
    return node.op == "input" and node.attr("batch") is not None


def input_tensor(name: Optional[str], value, sparsity: Optional[float] = None,
                 lineage_id: Optional[str] = None) -> LTensor:
    """Create a leaf bound to concrete data.

    Lineage of an input is its name + content fingerprint (SystemDS traces
    inputs "by name"; we add a fingerprint so re-bound different data never
    aliases in the reuse cache).
    """
    arr = np.asarray(value)
    if sparsity is None:
        if arr.size and np.issubdtype(arr.dtype, np.floating):
            sample = arr.ravel()[: 4096]
            sparsity = float(np.count_nonzero(sample)) / sample.size
        else:
            sparsity = 1.0
    name = name or f"in{next(_input_counter)}"
    node = make_node("input", (), arr.shape, arr.dtype, sparsity, name=name)
    table = None
    if lineage_id is None:
        fp, table = _fingerprint_and_table(arr)
        lid = f"{name}:{fp}"
    else:
        lid = lineage_id
    LEAVES.bind(node, arr, lid)
    if table is not None:
        # retained for slice-fingerprint derivation on the streaming
        # prefetch path — a free by-product of the scan above
        LEAVES.fp_tables[node.uid] = table
    return LTensor(node)
