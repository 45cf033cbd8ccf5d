"""Checkpoints and fault tolerance of the port (``repro.checkpoint``
counterpart): atomic per-leaf checkpoints with a crc32 manifest, tenant
directories, the restart manager, fault plans, the retry backoff and the
straggler monitor."""
from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    gc_incomplete, latest_step, latest_tenant_step, list_tenants,
    prune_checkpoints, prune_tenant_checkpoints, restore_checkpoint,
    restore_tenant_checkpoint, save_checkpoint, save_tenant_checkpoint,
    tenant_dir)
from repro_torch.checkpoint.fault_tolerance import (  # noqa: F401
    ExponentialBackoff, FaultPlan, RestartManager, SimulatedFailure,
    StragglerMonitor)
