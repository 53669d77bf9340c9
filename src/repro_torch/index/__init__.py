"""Label-partitioned scatter-gather index: serve trees bigger than one device
(counterpart of ``repro.index``).

``partition`` splits an :class:`~repro_torch.core.tree.XMRTree` into a
replicated router head plus P label-contiguous sub-trees, with a manifest
whose JSON is the reference's; ``placement`` packs the partitions onto a
``("data", "model")`` mesh of device slots, each with its own CUDA stream;
``planner`` runs the scatter-gather query path, bitwise the unpartitioned
tree in its ``level`` and ``pipelined`` sync modes; ``cache`` skips
partitions that own no row of a hot router beam.
"""

from repro_torch.index.cache import HotBeamCache
from repro_torch.index.partition import (
    PartitionedIndex,
    PartitionInfo,
    PartitionManifest,
    default_split_level,
    partition_tree,
    rebalance,
    rebalance_bounds,
)
from repro_torch.index.placement import Placement, assign_partitions, place
from repro_torch.index.planner import (
    SYNC_MODES,
    BeamTransport,
    ScatterGatherPlanner,
    TransportDegraded,
    merge_topk,
    reference_topk_width,
)

# The reference's Public API v1. ``HotBeamCache``, ``merge_topk``,
# ``assign_partitions``, ``rebalance_bounds`` and ``reference_topk_width``
# stay importable for tests and benchmarks, as internal plumbing.
__all__ = [
    "BeamTransport",
    "PartitionInfo",
    "PartitionManifest",
    "PartitionedIndex",
    "Placement",
    "SYNC_MODES",
    "ScatterGatherPlanner",
    "TransportDegraded",
    "default_split_level",
    "partition_tree",
    "place",
    "rebalance",
]
