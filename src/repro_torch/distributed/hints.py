"""Sharding hints: the launch layer's mesh, as the model code reads it.

Port of `repro.distributed.hints`. The reference pins intermediate
shardings with `with_sharding_constraint` when the launcher enables
hints on a mesh; disabled (the default) `shard_hint` is a no-op. The
state also tells the model code the mesh it runs on: `moe_forward`
takes the expert-parallel path by the sizes kept here (`_STATE["sizes"]`,
`_STATE["data_axes"]`).

Spec tokens: mesh axis names, plus "dp" which expands to the configured
data axes ("data" or ("pod", "data")).

On logical devices (`repro_torch.launch.mesh`) every value lives whole
on the runtime's device, so there is nothing to pin: `shard_hint`
expands its spec by the reference's rule (`hint_spec`) and returns `x`
unchanged. The reference's call sites in attention, MLA, the model and
the head stay dropped (`models/attention.py`).
"""
from __future__ import annotations

from typing import Optional

_STATE = {"enabled": False, "data_axes": ("data",), "axes": set(),
          "sizes": {}, "mesh": None}


def enable_hints(mesh) -> None:
    _STATE["enabled"] = True
    _STATE["axes"] = set(mesh.shape.keys())
    _STATE["sizes"] = dict(mesh.shape)
    _STATE["mesh"] = mesh
    _STATE["data_axes"] = tuple(a for a in ("pod", "data")
                                if a in mesh.shape)


def current_mesh():
    return _STATE["mesh"]


def disable_hints() -> None:
    _STATE["enabled"] = False


def hints_enabled() -> bool:
    return _STATE["enabled"]


def axis_size(name: str) -> int:
    return int(_STATE["sizes"].get(name, 1))


def _expand(token):
    if token == "dp":
        dp = _STATE["data_axes"]
        return dp if len(dp) > 1 else (dp[0] if dp else None)
    if token is None or token in _STATE["axes"]:
        return token
    if isinstance(token, tuple):
        kept = tuple(t for t in token if t in _STATE["axes"])
        return kept if kept else None
    return None


def hint_spec(shape: tuple, *spec) -> Optional[tuple]:
    """The spec `shard_hint` pins on a value of `shape` (the port's tuple
    form, one entry per listed dimension), or None when hints are
    disabled: each token expanded, and every axis that does not divide its
    dimension dropped (graceful degradation)."""
    if not _STATE["enabled"]:
        return None
    expanded = [_expand(s) for s in spec]
    for i, (s, d) in enumerate(zip(expanded, shape)):
        if s is None:
            continue
        names = s if isinstance(s, tuple) else (s,)
        size = 1
        for n in names:
            size *= _STATE["sizes"].get(n, 1)
        if d % max(size, 1) != 0:
            expanded[i] = None
    return tuple(expanded)


def shard_hint(x, *spec):
    """`x` itself: on logical devices every value is whole on the
    runtime's device (`hint_spec(x.shape, *spec)` is the spec the
    reference pins)."""
    return x
