"""Sharding helpers of the DSL's mesh placement and the launch layer.

Port of `repro.distributed.sharding`. The graceful-degradation contract:

  * `safe_spec` — drop any spec axis that does not divide the
    corresponding dimension (replicate instead of erroring);
  * `rows_shardable` — the compile-time form of the same rule used by
    `repro_torch.core.compiler.lower_distributed` to decide whether a
    leaf's row count divides the ``data`` axis (a non-dividing leaf stays
    local/replicated).

The launch layer's placement of values on a named mesh
(`repro_torch.launch.mesh`):

  * `NamedSharding(mesh, spec)` — which slice of a value each logical
    device of the mesh holds, as `jax.sharding.NamedSharding` says;
  * `named` — a tree of specs made a tree of `NamedSharding`s;
  * `device_put` — a tensor placed on a sharding (`Placed`): the whole
    tensor on the runtime's device and each logical device's shard as a
    view of it. A spec axis that does not divide its dimension raises,
    as the reference's `jax.device_put` does.

A spec is a tuple with one entry per dimension: an axis name, a tuple of
axis names, or None (replicated); the mesh is anything with a `shape`
mapping of axis name to size. The transformer-era rule tables of the
dry-run tooling (`param_specs`, `batch_specs`, `cache_specs`) live in
`repro_torch.distributed.legacy_rules` and are re-exported below, as in
the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Union

import torch

Axis = Optional[Union[str, tuple]]


def safe_spec(shape: tuple, spec: tuple[Axis, ...], mesh: Any
              ) -> tuple[Axis, ...]:
    """Drop spec axes that don't divide the dim (graceful degradation)."""
    out = []
    for i, names in enumerate(spec):
        if names is None or i >= len(shape):
            out.append(None)
            continue
        group = names if isinstance(names, tuple) else (names,)
        size = 1
        for n in group:
            size *= int(mesh.shape[n])
        out.append(names if shape[i] % size == 0 else None)
    return tuple(out)


def rows_shardable(shape: tuple, d: int) -> bool:
    """Compile-time `safe_spec` for the row axis: True iff sharding
    axis 0 over `d` devices divides evenly. A False answer means the
    value replicates (stays local) — it never errors."""
    return d > 1 and len(shape) >= 1 and shape[0] % d == 0 \
        and shape[0] >= d


@dataclass(frozen=True)
class NamedSharding:
    """A value laid over `mesh` by `spec`: dimension i is split into
    contiguous equal blocks over the axes spec[i] names (major first),
    and replicated over the mesh axes the spec does not name."""

    mesh: Any
    spec: tuple

    def __post_init__(self):
        seen = [a for names in self.spec if names is not None
                for a in (names if isinstance(names, tuple) else (names,))]
        for a in seen:
            if a not in self.mesh.shape:
                raise ValueError(f"spec {self.spec} names axis {a!r}, not "
                                 f"in the mesh {tuple(self.mesh.shape)}")
        if len(set(seen)) != len(seen):
            raise ValueError(f"spec {self.spec} names an axis twice")

    def _check(self, shape: tuple) -> None:
        if len(self.spec) > len(shape):
            raise ValueError(f"spec {self.spec} has more entries than a "
                             f"value of shape {tuple(shape)} has dimensions")
        for d, names in zip(shape, self.spec):
            n = _pieces(names, self.mesh)
            if d % n:
                raise ValueError(
                    f"spec {self.spec} splits a dimension of {d} into {n} "
                    f"blocks (shape {tuple(shape)} on mesh "
                    f"{dict(self.mesh.shape)})")

    def index(self, shape: tuple, device: int) -> tuple[slice, ...]:
        """The slices of a value of `shape` that logical `device` holds
        (jax's `addressable_devices_indices_map` entry)."""
        self._check(shape)
        at = self.mesh.coords(device)
        out = []
        for i, d in enumerate(shape):
            names = self.spec[i] if i < len(self.spec) else None
            if names is None:
                out.append(slice(None))
                continue
            block, n = 0, 1
            for a in (names if isinstance(names, tuple) else (names,)):
                block = block * self.mesh.shape[a] + at[a]
                n *= self.mesh.shape[a]
            size = d // n
            out.append(slice(block * size, (block + 1) * size))
        return tuple(out)


def _pieces(names: Axis, mesh: Any) -> int:
    if names is None:
        return 1
    group = names if isinstance(names, tuple) else (names,)
    return math.prod(int(mesh.shape[a]) for a in group)


def named(mesh: Any, spec_tree: Any) -> Any:
    """`NamedSharding(mesh, spec)` for every spec of `spec_tree`: dicts
    and lists are walked, every tuple is a spec."""
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [named(mesh, v) for v in spec_tree]
    return NamedSharding(mesh, tuple(spec_tree))


@dataclass(frozen=True)
class Placed:
    """A tensor placed on a `NamedSharding`: `value` is the whole tensor
    on the runtime's device, and `shards[i]` the view of it that logical
    device i holds."""

    value: torch.Tensor
    sharding: NamedSharding
    shards: tuple

    def __array__(self, dtype=None, copy=None):
        arr = self.value.detach().cpu().numpy()
        return arr if dtype is None else arr.astype(dtype)


def device_put(value: torch.Tensor, sharding: NamedSharding) -> Placed:
    """`value` placed on `sharding`; raises where a spec axis does not
    divide its dimension."""
    shape = tuple(value.shape)
    return Placed(value=value, sharding=sharding, shards=tuple(
        value[sharding.index(shape, i)]
        for i in range(sharding.mesh.size)))


# The transformer-era builders of the dry-run tooling (consumed by
# repro_torch.launch.dryrun), re-exported as the reference does.
from .legacy_rules import (batch_specs, cache_specs,  # noqa: E402,F401
                           param_specs)
