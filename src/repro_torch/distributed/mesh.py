"""Device mesh for the sharded execution backend (SystemDS's distributed
runtime as a compiler placement).

Port of `repro.distributed.mesh`. A `MeshSpec` names the two logical
axes the compiler shards over:

  * ``data``   — rows of X: the paper's distributed (Spark-analogue)
    backend. `compiler.lower_distributed` propagates a row-sharded
    placement over the DAG and lowers partial reductions (gram/xtv/
    colSums/sum) to per-shard compute + a fixed-order sum on this axis.
  * ``config`` — the `parfor` bucket axis: `batching.choose_mode` may
    shard the k-configuration batch across devices instead of (on top
    of) vmapping it on one.

The spec is pure compile-time metadata (two ints) so plans can be
compiled, explained and cost-tested without any devices. The runtime
resolves it once per run (`MeshSpec.resolve`): to itself, or to None
when fewer than ``data * config`` logical devices are laid out (or the
mesh has fewer than 2); sharded segments then run their
local-equivalent (unshard) closures, as the reference does on one
device.

Devices: a mesh resolves against one device — the runtime's own —
unless `logical_devices(n)` raises the count for a block (the
counterpart of the reference's ``--xla_force_host_platform_device_count``).
It lays n logical devices over the runtime's one device, which runs
every shard in turn, in shard order. Shards are never placed on
``cuda:i``, so the count does not follow the cards the process sees: a
host with 8 cards still resolves `MeshSpec(data=8)` to None, and the
collective bytes the meter counts never cross a link.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

DATA_AXIS = "data"
CONFIG_AXIS = "config"


@dataclass(frozen=True)
class MeshSpec:
    """Compile-time mesh description: axis sizes for (data, config)."""

    data: int = 1
    config: int = 1

    def __post_init__(self):
        if self.data < 1 or self.config < 1:
            raise ValueError(
                f"mesh axes must be >= 1, got data={self.data} "
                f"config={self.config}")

    @property
    def ndev(self) -> int:
        return self.data * self.config

    @property
    def shape(self) -> tuple[int, int]:
        return (self.data, self.config)

    def key_tag(self) -> str:
        """Stable identity for closure-cache keys: sharded and local
        closures of one segment body must never collide, nor two mesh
        shapes with each other."""
        return f"d{self.data}xc{self.config}"

    def resolve(self) -> Optional["MeshSpec"]:
        """The mesh the runtime runs on (this spec), or None when fewer
        logical devices are laid out than it needs (graceful degradation
        — the caller falls back to local-equivalent execution)."""
        if self.ndev > device_count() or self.ndev < 2:
            return None
        return self


# ---------------------------------------------------------------------------
# Device count: the devices a mesh may be laid over
# ---------------------------------------------------------------------------

_logical: Optional[int] = None


def device_count() -> int:
    """Devices a mesh resolves against: the count set by
    `logical_devices`, else 1 (the runtime's own device)."""
    return 1 if _logical is None else _logical


@contextmanager
def logical_devices(n: int):
    """Lay `n` logical devices over the runtime's device for a block, and
    restore the previous count after it:

        with logical_devices(8), use_mesh(data=8):
            beta = lmDS(X, y)
    """
    global _logical
    if n < 1:
        raise ValueError(f"logical device count must be >= 1, got {n}")
    prev = _logical
    _logical = int(n)
    try:
        yield n
    finally:
        _logical = prev


# ---------------------------------------------------------------------------
# Active-mesh context: compile_plan picks this up, like SystemDS attaching
# a cluster to the compiler session
# ---------------------------------------------------------------------------

_active: Optional[MeshSpec] = None


def set_mesh(spec: Optional[MeshSpec]) -> None:
    global _active
    _active = spec


def get_mesh() -> Optional[MeshSpec]:
    return _active


@contextmanager
def use_mesh(data: int = 1, config: int = 1):
    """Attach a mesh to subsequently compiled plans:

        with use_mesh(data=8):
            betas, losses = grid_search_lm(X, y, lambdas)
    """
    prev = get_mesh()
    set_mesh(MeshSpec(data=data, config=config))
    try:
        yield get_mesh()
    finally:
        set_mesh(prev)


def auto_mesh(config: int = 1) -> MeshSpec:
    """A data-axis mesh over every logical device (config axis fixed)."""
    data = max(1, device_count() // max(config, 1))
    return MeshSpec(data=data, config=config)
