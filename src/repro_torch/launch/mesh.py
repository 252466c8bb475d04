"""Named device meshes of the launch layer.

Port of `repro.launch.mesh`. A `Mesh` names the axes of a grid of
logical devices, as `jax.sharding.Mesh` does: the production mesh is
(`data`, `model`) within a pod, (`pod`, `data`, `model`) across pods.

Devices are the logical devices of `repro_torch.distributed.mesh`: a
mesh is laid over the runtime's one device, whose count
`logical_devices(n)` raises for a block, and `devices` holds their ids
0..size-1 in mesh order (row-major over `shape`). A mesh never counts
the cards the process sees, and nothing is placed on ``cuda:i``: the
work of every logical device runs on the runtime's device, in turn.

Functions, not module-level constants, so importing this module builds
no mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from repro_torch.distributed.mesh import device_count


@dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of logical devices with named axes.

    `shape` maps each axis name to its size in axis order (as
    `jax.sharding.Mesh.shape`); `devices` is the `np.ndarray` of logical
    device ids laid out in that shape."""

    shape: dict
    devices: np.ndarray = field(repr=False)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, device: int) -> dict:
        """{axis: index} of logical device `device` in the grid."""
        at = np.argwhere(self.devices == device)
        if len(at) != 1:
            raise ValueError(f"device {device} is not in the mesh")
        return dict(zip(self.axis_names, (int(i) for i in at[0])))


def _mk(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axis names {axes} differ "
                         f"in length")
    if len(set(axes)) != len(axes):
        raise ValueError(f"mesh axis names repeat: {axes}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    n = math.prod(shape)
    if n > device_count():
        raise ValueError(
            f"a mesh of shape {shape} needs {n} devices, but "
            f"{device_count()} are laid out (raise the count with "
            f"repro_torch.distributed.logical_devices)")
    return Mesh(shape=dict(zip(axes, shape)),
                devices=np.arange(n).reshape(shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16×16 = 256 devices per pod; 2 pods = 512 devices multi-pod (under
    `logical_devices(256)` or `logical_devices(512)`)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """A mesh of `shape` with axis names `axes`; raises when fewer logical
    devices are laid out than the mesh holds."""
    return _mk(shape, axes)


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)
