"""repro_torch.distributed — the host-side control plane of the port.

  * `mesh` — the sharded placement's `MeshSpec` (``data`` rows, ``config``
    parfor buckets), the active-mesh context (`use_mesh`, `get_mesh`,
    `set_mesh`, `auto_mesh`) and the device count a mesh resolves
    against (`device_count`, raised for a block by `logical_devices`);
  * `sharding` — `safe_spec` and `rows_shardable`; the launch layer's
    `NamedSharding`, `named` and `device_put` (a `Placed` tensor); the
    dry run's rule tables (`param_specs`, `batch_specs`, `cache_specs`,
    from `legacy_rules`);
  * `hints` — the launch layer's (data, model) mesh as the model code
    reads it (`enable_hints`, `axis_size`, `current_mesh`; the
    expert-parallel MoE dispatches on it);
  * `compress` — int8 quantization with error feedback;
  * `fedavg` — `FedAvgTrainer`, relaxed-sync federated training;
  * `fault` — `StepMonitor`, `HeartbeatTracker`, `simulate_failures`.
"""
from .compress import (compress_tree, compressed_bytes,  # noqa: F401
                       crosspod_mean_int8, dequantize, init_error_state,
                       quantize_int8)
from .fedavg import FedAvgTrainer, SiteState  # noqa: F401
from .hints import (axis_size, current_mesh, disable_hints,  # noqa: F401
                    enable_hints, hint_spec, hints_enabled, shard_hint)
from .mesh import (CONFIG_AXIS, DATA_AXIS, MeshSpec,  # noqa: F401
                   auto_mesh, device_count, get_mesh,
                   logical_devices, set_mesh, use_mesh)
from .sharding import (NamedSharding, Placed, batch_specs,  # noqa: F401
                       cache_specs, device_put, named, param_specs,
                       rows_shardable, safe_spec)
