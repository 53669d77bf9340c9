"""Device meshes of the serving tier and the stream hand-offs between their
slots (counterpart of the mesh half of ``repro.distributed``)."""

from repro_torch.distributed.sharding import (
    DeviceMesh,
    Slot,
    partition_mesh,
    replica_mesh,
    row_slices,
    send,
    visible_devices,
)

__all__ = [
    "DeviceMesh",
    "Slot",
    "partition_mesh",
    "replica_mesh",
    "row_slices",
    "send",
    "visible_devices",
]
