"""Cost counting over torch's dispatch: FLOPs, bytes, transcendentals and
collective bytes of one call.

Port of `repro.launch.hlocost`. The reference re-derives per-device costs
from XLA's optimized HLO text, walking while-loops by their trip counts.
The port has no HLO: PyTorch runs eagerly, so the counter sees every ATen
op a call executes. `CostTotals` is a `TorchDispatchMode` with the
reference's fields; inside `with CostTotals() as t:` each op is charged:

  * products and convolutions: `torch.utils.flop_counter`'s registered
    formulas (2·|out|·K for a product; `product_flops` keeps their sum
    apart, `FlopCounterMode`'s figure);
  * elementwise ops: one per output element; exp, log, tanh, rsqrt,
    sqrt, sigmoid, pow, cos, sin and erf also one transcendental each; a
    cast one per element;
  * reductions: the input's elements (a softmax: its reduction and its
    exps, two per element and one transcendental);
  * bytes: operand plus output bytes of each op that computes (a
    broadcast operand counts the elements it holds, not those it
    shows); views, reshapes, metadata ops and allocations are free, as
    the reference's `_FREE`;
  * copies between the host and a device: nothing (the reference's
    program has none; its inputs are on the device already);
  * writes into a window of a larger buffer (`copy_`, `index_put_`,
    `slice_scatter`, the scatter family): read and write of the window
    only, and gathers (`embedding`, `index_select`, `gather`, indexing)
    read only the gathered window of their table: the reference's
    `_WINDOWED` cap (`hlocost.py:264-271`, `:384-389`).

The counter charges unfused ATen ops, where XLA's figure is per fusion
(a fusion's intermediates never touch memory): its `bytes` are therefore
a different, larger quantity than the reference's for the same program,
while its FLOPs agree. `unknown_trip_counts` stays 0: every executed op
is seen, so no loop trip count is guessed.

What the mode cannot see charges itself through `charge`: the hand
kernels launched through `ctypes` (flash, wkv6, the scan) and the
`repro_torch::` custom ops, each with its kernel's own work
(`repro_torch.launch.kernel_model`), on the card and in their meta
implementations alike, so a count on the "meta" device equals one on the
card op for op. Collectives are charged by `collective` under the
reference's ring model (`hlocost.py:311-323`): the port's lockstep
collectives call it, and the dry run for the placement the rule tables
give (`product_collective`). A collective is charged as one device of
its group sees it, and its memory traffic is not added to `bytes`.

On "meta" an op seen before with the same arguments' shapes is not run
again: its charge and its outputs' shapes are replayed, which is what
makes a dry run's thousands of identical tiles cheap to count.

The counter holds no reference to any tensor: the live bytes of the
storages that ops make inside it are tracked through weak references
(`peak_bytes`), so counting a step does not keep its activations alive.

`count(fn, *args)` returns the `CostTotals` of one call (the reference's
`analyze`).
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from collections import defaultdict
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten
# the autograd node a backward op runs for, and the next node's sequence
# number on this thread (a region's backward ops are known by them)
_current_node = torch._C._current_autograd_node
_sequence_nr = getattr(torch._C._autograd, "_get_sequence_nr", None)

# the counters charged now, innermost last: kernel wrappers and
# collectives, which the dispatch mode cannot see, charge every one
_ACTIVE: list["CostTotals"] = []

_TRANSCENDENTAL = {"exp", "log", "tanh", "rsqrt", "sqrt", "sigmoid", "pow",
                   "cos", "sin", "erf"}
# allocations and metadata: no data is read or written
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten.detach, aten.alias, aten._unsafe_view,
         aten.lift_fresh, aten._local_scalar_dense, aten.resize_,
         aten.set_, aten.scalar_tensor, aten.sym_size, aten.sym_stride,
         aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
         aten._has_compatible_shallow_copy_type}
_ALLOCS = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
           aten.new_empty_strided, aten.scalar_tensor}
# fills: the output written, nothing read
_FILLS = {aten.zeros, aten.ones, aten.full, aten.zeros_like, aten.ones_like,
          aten.full_like, aten.fill_, aten.zero_, aten.arange, aten.new_zeros,
          aten.new_ones, aten.new_full}
# writes of a window into a larger buffer: (the window's operand index)
_WINDOW_WRITES = {aten.copy_: 1, aten.index_put_: 2, aten.index_put: 2,
                  aten.slice_scatter: 1, aten.select_scatter: 1,
                  aten.index_copy_: 3, aten.index_copy: 3, aten.scatter_: 3,
                  aten.scatter: 3, aten.scatter_add_: 3, aten.scatter_add: 3,
                  aten.index_add_: 3, aten.index_add: 3,
                  aten.masked_scatter_: 2, aten.diagonal_scatter: 1,
                  aten.as_strided_scatter: 1}
# reads of a window of a larger table: operands capped at the output
_GATHERS = {aten.embedding, aten.index_select, aten.gather, aten.index,
            aten.take_along_dim, aten._unsafe_index}
_SOFTMAX = {aten._softmax, aten._log_softmax, aten._softmax_backward_data,
            aten._log_softmax_backward_data}
_CASTS = {aten._to_copy, aten.clone}
# copies that may cross between the host and a device: not charged (the
# reference's program holds none, and a count on "meta" cannot make one)
_TRANSFERS = {aten._to_copy, aten.copy_}


def _packet(func):
    return func.overloadpacket


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the elements `t` holds: a broadcast (stride-0) axis
    counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _flat(tree) -> list:
    """The leaves of nested tuples, lists and dicts (an op's arguments)."""
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, (tuple, list)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
        else:
            out.append(x)
    return out


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [x for x in _flat(tree) if isinstance(x, torch.Tensor)]


def _desc(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        return tuple(_desc(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _desc(v)) for k, v in x.items())
    return x


def _meta_form(func, flat, args, out):
    """How to make `out` again without running `func`, where every tensor
    argument lies on "meta" (no data, so the op's result is its shapes):
    "self" for an op that returns its mutated first argument, else
    (tree spec, leaves with each tensor as (shape, stride, dtype)) when
    every output is fresh; None otherwise (the op runs every time). Meta
    kernels of elementwise ops run Python shape logic, tens of µs an op
    on the CPU, and a counted step repeats few distinct ops many times
    (the chunked attention's tiles)."""
    tensors = [x for x in flat if isinstance(x, torch.Tensor)]
    if not tensors or any(t.device.type != "meta" for t in tensors):
        return None
    if args and out is args[0]:
        return "self"
    if func._schema.is_mutable:
        return None
    leaves, spec = tree_flatten(out)
    ins = {t.untyped_storage()._cdata for t in tensors}
    form = []
    for x in leaves:
        if isinstance(x, torch.Tensor):
            if x.device.type != "meta" or x.untyped_storage()._cdata in ins:
                return None
            form.append((tuple(x.shape), x.stride(), x.dtype))
        else:
            form.append(("value", x))
    return spec, form


def _replay(form, args):
    if form == "self":
        return args[0]
    spec, leaves = form
    return tree_unflatten(
        [x[1] if x[0] == "value" else
         torch.empty_strided(x[0], x[1], dtype=x[2], device="meta")
         for x in leaves], spec)


class CostTotals(TorchDispatchMode):
    """Counts of the ops run inside the mode (the reference's
    `CostTotals`, hlocost.py:111-132), plus `product_flops` (the
    products' and convolutions' FLOPs alone), `by_op` ([calls, FLOPs,
    bytes] by ATen op, or by kernel for a hand kernel's charge),
    `regions` (bytes charged inside each named `region`) and
    `peak_bytes` (the most bytes of storages made inside the mode alive
    at once)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.collective_wire_bytes = 0.0     # ring-model per-device bytes
        self.collective_raw_bytes = 0.0      # Σ payload bytes
        self.per_collective = defaultdict(float)
        self.by_group_size = defaultdict(float)
        self.unknown_trip_counts = 0
        self.product_flops = 0.0
        self.by_op = defaultdict(lambda: [0, 0.0, 0.0])  # calls, flops, bytes
        self.regions = defaultdict(float)
        self.region: Optional[str] = None
        self._spans: list = []    # (region, first, end) autograd sequence
        self.live_bytes = 0
        self.peak_bytes = 0
        self._memo: dict = {}
        self._live: dict = {}     # storage -> [tracked tensors, nbytes]
        self._tracked: dict = {}  # id(tensor) -> its weak reference
        self._dead: list = []     # (id, storage) of tensors since freed
        self._lock = threading.Lock()

    # -- entering and leaving -----------------------------------------------
    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        with self._lock:
            self._drain()
        return super().__exit__(*exc)

    # -- charging ------------------------------------------------------------
    def add(self, other: "CostTotals", mult: float = 1.0) -> None:
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.transcendentals += other.transcendentals * mult
        self.collective_wire_bytes += other.collective_wire_bytes * mult
        self.collective_raw_bytes += other.collective_raw_bytes * mult
        for k, v in other.per_collective.items():
            self.per_collective[k] += v * mult
        for k, v in other.by_group_size.items():
            self.by_group_size[k] += v * mult
        self.unknown_trip_counts += other.unknown_trip_counts
        self.product_flops += other.product_flops * mult
        for k, v in other.regions.items():
            self.regions[k] += v * mult
        for k, (n, f, b) in other.by_op.items():
            ent = self.by_op[k]
            ent[0] += n * mult
            ent[1] += f * mult
            ent[2] += b * mult

    def _charge(self, name: str, flops: float, nbytes: float,
                trans: float = 0.0, products: float = 0.0) -> None:
        ent = self.by_op[name]
        ent[0] += 1
        ent[1] += flops
        ent[2] += nbytes
        self.flops += flops
        self.bytes += nbytes
        self.transcendentals += trans
        self.product_flops += products
        name = self.region
        if name is None and self._spans:  # a backward op of a region's?
            node = _current_node()
            if node is not None:
                seq = node._sequence_nr()
                name = next((n for n, lo, hi in self._spans
                             if lo <= seq < hi), None)
        if name is not None:
            self.regions[name] += nbytes

    def _collective(self, kind: str, payload: float, n: int,
                    wire: float) -> None:
        self.collective_raw_bytes += payload
        self.collective_wire_bytes += wire
        self.per_collective[kind] += wire
        self.by_group_size[n] += wire

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind = _KIND.get(func)
        if kind is None:
            kind = _KIND[func] = _kind(func)
        if kind != "count":
            out = func(*args, **kwargs)
            for t in _tensors(out):
                self._track(t, fresh=kind == "fresh")
            return out
        flat = _flat((args, kwargs))
        key = (func, tuple(_desc(x) for x in flat))
        try:
            hit = self._memo.get(key)
        except TypeError:  # an unhashable argument: no memo
            key = hit = None
        if hit is not None and hit[1] is not None:
            cost, form = hit
            out = _replay(form, args)
        else:
            out = func(*args, **kwargs)
            cost = _op_cost(func, args, kwargs, out, _tensors(out))
            if key is not None:
                self._memo[key] = (cost, _meta_form(func, flat, args, out))
        self._charge(func.__name__, *cost)
        fresh = not (args and out is args[0])
        for t in _tensors(out):
            self._track(t, fresh)
        return out

    # -- live bytes, through weak references only ----------------------------
    def _track(self, t: torch.Tensor, fresh: bool) -> None:
        """Count `t`'s storage live while a tensor made inside the mode
        holds it: a fresh storage from a computing op, or one of those
        seen again through a view."""
        try:
            storage = t.untyped_storage()
        except (NotImplementedError, RuntimeError):  # no storage to count
            return
        key = storage._cdata
        with self._lock:
            self._drain()
            tid = id(t)
            if tid in self._tracked:
                return
            ent = self._live.get(key)
            if ent is None:
                if not fresh:
                    return  # an argument or a view of one: no temporary
                ent = self._live[key] = [0, storage.nbytes()]
                self.live_bytes += ent[1]
                if self.live_bytes > self.peak_bytes:
                    self.peak_bytes = self.live_bytes
            ent[0] += 1
            dead = self._dead
            self._tracked[tid] = weakref.ref(
                t, lambda _, tid=tid, key=key: dead.append((tid, key)))

    def _drain(self) -> None:
        """Release the storages of the tensors that died since the last
        call (under `_lock`). A weak reference's callback only appends to
        `_dead`: it may run in any thread, at any allocation, the
        garbage collector's included, so it takes no lock."""
        while self._dead:
            tid, key = self._dead.pop()
            self._tracked.pop(tid, None)
            ent = self._live.get(key)
            if ent is None:
                continue
            ent[0] -= 1
            if ent[0] == 0:
                del self._live[key]
                self.live_bytes -= ent[1]

# how the mode treats each op: "count" (charged), "fresh" (free, its
# outputs new storages: allocations), "view" (free, its outputs views),
# "other" (free: metadata, or a custom op that charges itself)
_KIND: dict = {}


def _kind(func) -> str:
    if func.is_view:
        return "view"
    if func.namespace != "aten":
        return "fresh"
    if _packet(func) in _FREE:
        return "fresh" if _packet(func) in _ALLOCS else "other"
    return "count"


def _op_cost(func, args, kwargs, out, outs) -> tuple:
    """(flops, bytes, transcendentals, product flops) of one ATen op."""
    pk = _packet(func)
    ins = _tensors((args, kwargs))
    if pk in _TRANSFERS and len({t.device for t in ins + outs}) > 1:
        return (0.0, 0.0, 0.0, 0.0)  # a copy between host and device
    out_bytes = sum(_nbytes(t) for t in outs)
    out_numel = sum(t.numel() for t in outs)
    if pk in flop_registry:
        f = float(flop_registry[pk](*args, **kwargs, out_val=out))
        return (f, sum(_nbytes(t) for t in ins) + out_bytes, 0.0, f)
    if pk in _FILLS:
        return (0.0, float(out_bytes), 0.0, 0.0)
    if pk in _WINDOW_WRITES:
        i = _WINDOW_WRITES[pk]
        src = args[i] if i < len(args) else None
        if isinstance(src, torch.Tensor):
            win = _nbytes(src)
        else:  # a scalar source: the window is the written view
            win = _nbytes(args[0])
        idx = sum(_nbytes(t) for t in ins[1:] if t is not src
                  and not t.is_floating_point())
        convert = isinstance(src, torch.Tensor) and src.dtype != args[0].dtype
        numel = src.numel() if isinstance(src, torch.Tensor) else 0
        return (float(numel if convert else 0), 2.0 * win + idx, 0.0, 0.0)
    if pk in _GATHERS:
        return (0.0, out_bytes + sum(min(_nbytes(t), out_bytes)
                                     for t in ins), 0.0, 0.0)
    nbytes = float(sum(_nbytes(t) for t in ins) + out_bytes)
    if pk in _SOFTMAX:
        return (2.0 * out_numel, nbytes, float(out_numel), 0.0)
    if pk in _CASTS:
        convert = ins and outs and ins[0].dtype != outs[0].dtype
        return (float(out_numel if convert else 0), nbytes, 0.0, 0.0)
    if torch.Tag.reduction in func.tags:
        return (float(ins[0].numel() if ins else out_numel), nbytes, 0.0,
                0.0)
    if torch.Tag.pointwise in func.tags:
        name = pk.__name__.rstrip("_")
        trans = float(out_numel) if name in _TRANSCENDENTAL else 0.0
        return (float(out_numel), nbytes, trans, 0.0)
    return (0.0, nbytes, 0.0, 0.0)  # any other op: its bytes only


# ---------------------------------------------------------------------------
# what the mode cannot see
# ---------------------------------------------------------------------------

def active() -> bool:
    """True inside at least one counter."""
    return bool(_ACTIVE)


def charge(work, *args, transcendentals: float = 0.0) -> None:
    """Charge `work(*args)` -> (operations, bytes) to every active counter
    (a hand kernel's own work, `repro_torch.launch.kernel_model`); `work`
    is not called when no counter is active."""
    if not _ACTIVE:
        return
    ops, nbytes = work(*args)
    name = work.__name__.removesuffix("_work")
    for c in _ACTIVE:
        c._charge(name, float(ops), float(nbytes), transcendentals)


@contextlib.contextmanager
def region(name: str):
    """Charge the bytes of the ops inside to `regions[name]` of every
    active counter as well (the plain recurrences mark theirs "scan"),
    and those of their backward: the autograd nodes made inside are
    known by their sequence numbers (the reference counts a scan's
    backward loop in its region too)."""
    if not _ACTIVE:
        yield
        return
    counters = list(_ACTIVE)
    prev = [c.region for c in counters]
    for c in counters:
        c.region = name
    first = _sequence_nr() if _sequence_nr else None
    try:
        yield
    finally:
        for c, p in zip(counters, prev):
            c.region = p
            if first is not None and _sequence_nr() > first:
                c._spans.append((name, first, _sequence_nr()))


def collective(kind: str, payload_bytes: float, group: int) -> float:
    """Charge one collective of `payload_bytes` (its output, per device)
    over a group of `group` devices to every active counter, under the
    reference's ring model: an all-reduce moves 2·(n−1)/n of its payload
    a device, an all-gather, reduce-scatter or all-to-all (n−1)/n, a
    collective-permute all of it. Returns the wire bytes."""
    n = max(int(group), 1)
    payload = float(payload_bytes)
    if kind == "all-reduce":
        wire = 2.0 * (n - 1) / n * payload
    elif kind in ("all-gather", "reduce-scatter"):
        wire = (n - 1) / n * payload
    elif kind == "all-to-all":
        wire = (n - 1) / n * payload
    elif kind == "collective-permute":
        wire = payload
    else:
        raise ValueError(f"collective: unknown kind {kind!r}")
    for c in _ACTIVE:
        c._collective(kind, payload, n, wire)
    return wire


def _axes(names) -> tuple:
    if names is None:
        return ()
    return names if isinstance(names, tuple) else (names,)


def product_collective(lhs_spec: tuple, rhs_spec: tuple, out_spec: tuple,
                       mesh, out_shape: tuple, dtype) -> list:
    """The collectives a product lhs @ rhs needs under its placement, each
    charged to the active counters: the mesh axes that split the
    contraction (lhs's last dimension, rhs's second to last) leave every
    device a partial sum of its output block, reduced over their group:
    an all-reduce where the output is not split on them, a reduce-scatter
    where it is. Specs are the port's tuples (an axis name, a tuple of
    names or None per dimension); the payload is the collective's output
    per device. Returns [(kind, payload bytes, group size)]."""
    contract = set(_axes(lhs_spec[-1] if lhs_spec else None)) \
        | set(_axes(rhs_spec[-2] if len(rhs_spec) >= 2 else
                    (rhs_spec[0] if rhs_spec else None)))
    if not contract:
        return []
    size = dtype.itemsize
    numel = 1
    for d in out_shape:
        numel *= int(d)
    out_axes = [a for names in out_spec for a in _axes(names)]
    # the output block a device holds before the reduction: split by the
    # output's own axes that do not reduce
    block = numel * size
    for a in out_axes:
        if a not in contract:
            block /= mesh.shape[a]
    done = []
    reduce_axes = sorted(a for a in contract if a not in out_axes)
    scatter_axes = sorted(a for a in contract if a in out_axes)
    if reduce_axes:
        n = 1
        for a in reduce_axes:
            n *= mesh.shape[a]
        collective("all-reduce", block, n)
        done.append(("all-reduce", block, n))
    if scatter_axes:
        n = 1
        for a in scatter_axes:
            n *= mesh.shape[a]
        collective("reduce-scatter", block / n, n)
        done.append(("reduce-scatter", block / n, n))
    return done


def count(fn, *args, **kwargs) -> CostTotals:
    """The `CostTotals` of one call `fn(*args, **kwargs)` (the reference's
    `analyze`)."""
    with CostTotals() as totals:
        fn(*args, **kwargs)
    return totals
