"""repro_torch.distributed — the host-side control plane of the port.

Only `fault` (`StepMonitor`, `HeartbeatTracker`, `simulate_failures`) is
ported; the mesh and sharding modules of `repro.distributed` come with
sharded placement (ROADMAP Queue 1 item 12).
"""
