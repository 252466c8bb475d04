"""repro_torch.distributed — the host-side control plane of the port.

  * `mesh` — the sharded placement's `MeshSpec` (``data`` rows, ``config``
    parfor buckets), the active-mesh context (`use_mesh`, `get_mesh`,
    `set_mesh`, `auto_mesh`) and the device count a mesh resolves
    against (`device_count`, raised for a block by `logical_devices`);
  * `sharding` — `safe_spec` and `rows_shardable`;
  * `fault` — `StepMonitor`, `HeartbeatTracker`, `simulate_failures`.

The launch layer's named (data, model) mesh, the sharding hints the
expert-parallel MoE reads, the rule tables, compression and FedAvg are
not ported yet (ROADMAP Queue 1 items 15 and 16).
"""
from .mesh import (CONFIG_AXIS, DATA_AXIS, MeshSpec,  # noqa: F401
                   auto_mesh, device_count, get_mesh,
                   logical_devices, set_mesh, use_mesh)
from .sharding import rows_shardable, safe_spec  # noqa: F401
