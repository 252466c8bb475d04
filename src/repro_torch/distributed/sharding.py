"""Sharding helpers of the DSL's mesh placement.

Port of `repro.distributed.sharding`'s graceful-degradation contract:

  * `safe_spec` — drop any spec axis that does not divide the
    corresponding dimension (replicate instead of erroring);
  * `rows_shardable` — the compile-time form of the same rule used by
    `repro_torch.core.compiler.lower_distributed` to decide whether a
    leaf's row count divides the ``data`` axis (a non-dividing leaf stays
    local/replicated).

A spec is a tuple with one entry per dimension: an axis name, a tuple of
axis names, or None (replicated); the mesh is anything with a `shape`
mapping of axis name to size. The launch layer's named shardings and
its rule tables come with its named (data, model) mesh.
"""
from __future__ import annotations

from typing import Any, Optional, Union

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
