"""Partition -> device placement over a ``("data", "model")`` mesh
(counterpart of ``repro.index.placement``).

Each partition is pinned to one **model column** of the mesh; a column's
``n_data`` device slots are data-parallel replicas of everything placed
there (batch rows split over ``"data"``), so ``ServeConfig(partitions=P,
shards=N)`` is model-parallel x data-parallel behind one micro-batching
front end.

More partitions than columns is normal: partitions are packed onto columns
by longest-processing-time greedy bin packing over the manifest's
``memory_bytes`` (or observed occupancy).

Where the reference keeps ``NamedSharding``s, a :class:`Placement` keeps,
per partition, its column's device slots (a device and a CUDA stream each,
the stream shared by the partitions of one column) and the coordinator's
slot, which runs the router and every merge on a stream of its own.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.distributed.sharding import DeviceMesh, Slot, resolve_devices, partition_mesh
from repro_torch.index.partition import PartitionedIndex, PartitionManifest


def assign_partitions(
    memory_bytes: Sequence[int], n_bins: int
) -> List[int]:
    """LPT greedy: heaviest partition first onto the lightest bin. Returns
    the bin (mesh model column) of each partition."""
    if n_bins < 1:
        raise ValueError(f"n_bins must be >= 1; got {n_bins}")
    order = np.argsort(-np.asarray(memory_bytes, dtype=np.int64), kind="stable")
    load = np.zeros(n_bins, dtype=np.int64)
    out = [0] * len(memory_bytes)
    for pid in order:
        bin_ = int(np.argmin(load))
        out[int(pid)] = bin_
        load[bin_] += int(memory_bytes[pid])
    return out


@dataclasses.dataclass
class Placement:
    """Resolved device plan for a partitioned index."""

    mesh: DeviceMesh                 # ("data", "model"), (n_data, n_model)
    assignments: List[int]           # partition -> model column
    slots: List[List[Slot]]          # per partition: its column, one per data row
    coordinator: Slot                # router, merges and selects

    @property
    def n_data(self) -> int:
        return self.mesh.shape["data"]

    @property
    def n_model(self) -> int:
        return self.mesh.shape["model"]

    def column_loads(self, manifest: PartitionManifest) -> List[int]:
        """Resident model bytes per mesh column (balance diagnostics)."""
        load = [0] * self.n_model
        for info, col in zip(manifest.partitions, self.assignments):
            load[col] += info.memory_bytes
        return load


def place(
    index: PartitionedIndex,
    *,
    shards: int = 1,
    devices: Optional[Sequence] = None,
    occupancy: Optional[Sequence[float]] = None,
) -> Placement:
    """Map ``index``'s partitions onto device slots (every visible card
    unless ``devices`` names them; a device may repeat).

    ``shards`` is the data-parallel width; the model width is ``min(P,
    n_slots // shards)``. Columns are balanced by resident ``memory_bytes``,
    or by observed per-partition ``occupancy`` shares when given.
    """
    devices = resolve_devices(devices)
    if shards < 1:
        raise ValueError(f"shards must be >= 1; got {shards}")
    if shards > len(devices):
        raise ValueError(
            f"shards={shards}: only {len(devices)} device slots "
            "(pass devices=; a device may be named more than once)"
        )
    n_model = max(1, min(index.n_partitions, len(devices) // shards))
    mesh = partition_mesh(shards, n_model, devices=devices)
    if occupancy is not None:
        occ = np.asarray(occupancy, dtype=np.float64)
        if occ.shape != (index.n_partitions,) or np.any(occ < 0):
            raise ValueError(
                f"occupancy must hold {index.n_partitions} non-negative "
                f"shares; got {occupancy!r}"
            )
        # Integerize for the LPT packer; resolution of 1e-6 of total load.
        load = [int(round(o * 1_000_000)) for o in occ]
    else:
        load = [p.memory_bytes for p in index.manifest.partitions]
    assignments = assign_partitions(load, n_model)
    grid = [[Slot.new(dev) for dev in row] for row in mesh.devices]
    slots = [[grid[r][col] for r in range(shards)] for col in assignments]
    # The coordinator prefers a device outside the mesh when one is left
    # over; it has a stream of its own either way, so its merges never queue
    # behind a partition's products.
    n_used = shards * n_model
    coordinator = Slot.new(devices[n_used] if n_used < len(devices) else devices[0])
    return Placement(mesh=mesh, assignments=assignments, slots=slots,
                     coordinator=coordinator)
