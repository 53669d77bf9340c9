"""Device meshes of the serving tier, the stream hand-offs between their
slots, the LM's sharding rules and fault tolerance (counterpart of
``repro.distributed``)."""

from repro_torch.distributed.fault import StepWatchdog, TransientError, run_with_retries
from repro_torch.distributed.sharding import (
    DeviceMesh,
    Slot,
    batch_specs,
    cache_specs,
    param_spec,
    partition_mesh,
    replica_mesh,
    row_slices,
    send,
    shard_params,
    visible_devices,
)

__all__ = [
    "DeviceMesh",
    "Slot",
    "StepWatchdog",
    "TransientError",
    "batch_specs",
    "cache_specs",
    "param_spec",
    "partition_mesh",
    "replica_mesh",
    "row_slices",
    "run_with_retries",
    "send",
    "shard_params",
    "visible_devices",
]
