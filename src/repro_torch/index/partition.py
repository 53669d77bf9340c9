"""Label-space partitioning of an :class:`~repro_torch.core.tree.XMRTree`
(counterpart of ``repro.index.partition``).

The enterprise regime (paper §6: 100M labels, d = 4M) does not fit one
device: the leaf ranker layer dominates model memory and grows linearly in
L. :func:`partition_tree` splits the tree at a chosen level into P disjoint
sub-trees, each owning a **contiguous label range** (labels are laid out in
tree order, so a contiguous chunk range at any level induces a contiguous
leaf range), plus a small **router head** (the levels above the split,
replicated everywhere).

Every sub-tree layer is a slice of the parent tree's tensors with the ELL
pad widths kept, so a column scores the same through a partition as through
the whole tree, plus one all-sentinel **phantom chunk** where beam entries
the partition does not own are parked (see :meth:`XMRTree.extract`).

A :class:`PartitionManifest` records, per partition, the chunk range at the
split level, the owned label range, resident ``memory_bytes`` and a content
hash of the sliced weights. Its JSON is the reference's, character for
character, on the same tree (schema v2; v1 is still read).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tree import XMRTree

# v2 adds the compressed-storage columns ``tier``/``dtype``; v1 manifests
# are still readable, the new columns defaulting to the exact tier.
MANIFEST_VERSION = 2


@dataclasses.dataclass(frozen=True)
class PartitionInfo:
    """One partition's row in the manifest."""

    pid: int
    chunk_start: int      # chunk range at the split level (disjoint, sorted)
    chunk_end: int
    label_start: int      # owned leaf-label range [label_start, label_end)
    label_end: int
    memory_bytes: int     # resident chunked-weight bytes (incl. phantom pad)
    content_hash: str     # sha256 over the sliced layer tensors
    tier: str = "exact"   # storage tier (a repro_torch.quant tier or exact)
    dtype: str = "float32"  # chunk_vals storage dtype actually resident

    @property
    def n_labels(self) -> int:
        return self.label_end - self.label_start


@dataclasses.dataclass
class PartitionManifest:
    """Serializable description of a label-partitioned index."""

    level: int                      # split level (index into stored layers)
    n_partitions: int
    n_labels: int                   # global leaf count
    d: int
    branching: Tuple[int, ...]
    router_memory_bytes: int        # replicated head layers
    total_memory_bytes: int         # unpartitioned tree, for shrink ratios
    partitions: List[PartitionInfo]
    version: int = MANIFEST_VERSION

    def max_partition_bytes(self) -> int:
        return max(p.memory_bytes for p in self.partitions)

    def shrink_ratio(self) -> float:
        """Unpartitioned bytes over the largest per-device resident slice."""
        resident = self.max_partition_bytes() + self.router_memory_bytes
        return self.total_memory_bytes / max(resident, 1)

    def to_json(self) -> str:
        doc = dataclasses.asdict(self)
        doc["branching"] = list(self.branching)
        return json.dumps(doc, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "PartitionManifest":
        doc = json.loads(text)
        version = doc.get("version")
        if version not in (1, MANIFEST_VERSION):
            raise ValueError(
                f"manifest version {version} not in (1, {MANIFEST_VERSION})"
            )
        # v1 rows predate the storage-tier columns; the defaults (exact f32)
        # describe every v1 partition. Re-serialized at the current version.
        parts = [PartitionInfo(**p) for p in doc.pop("partitions")]
        doc["branching"] = tuple(doc["branching"])
        doc["version"] = MANIFEST_VERSION
        return cls(partitions=parts, **doc)


def _host_array(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A tensor's values on the host and the numpy name of its dtype. fp8
    has no numpy type here: its uint8 bit pattern stands in, under the name
    the reference's numpy gives the type."""
    if t.dtype == torch.float8_e4m3fn:
        return t.detach().view(torch.uint8).cpu().numpy(), "float8_e4m3fn"
    a = t.detach().cpu().numpy()
    return a, str(a.dtype)


def _content_hash(tree: XMRTree) -> str:
    h = hashlib.sha256()
    for lay in tree.layers:
        tensors = [lay.chunk_rows, lay.chunk_vals]
        scales = getattr(lay, "chunk_scales", None)  # quantized layers
        if scales is not None:
            tensors.append(scales)
        for t in tensors:
            a, dtype = _host_array(t)
            # dtype is part of the hashed header, so an int8 cut of the same
            # weights can never collide with its f32 original.
            h.update(str((tuple(a.shape), dtype)).encode())
            h.update(a.tobytes())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class PartitionedIndex:
    """A router head + P label-partitioned sub-trees, ready to serve."""

    head: XMRTree                 # levels [0, level): replicated router
    parts: List[XMRTree]          # P disjoint sub-trees, label-contiguous
    manifest: PartitionManifest
    n_cols: Tuple[int, ...]       # global per-level column counts
    branching: Tuple[int, ...]

    @property
    def n_partitions(self) -> int:
        return len(self.parts)

    @property
    def level(self) -> int:
        return self.manifest.level

    @property
    def n_labels(self) -> int:
        return self.manifest.n_labels

    @property
    def d(self) -> int:
        return self.manifest.d

    def label_ranges(self) -> List[Tuple[int, int]]:
        return [(p.label_start, p.label_end) for p in self.manifest.partitions]

    def hit_counts(self, labels: np.ndarray) -> np.ndarray:
        """Per-partition count of result labels (occupancy accounting)."""
        labels = np.asarray(labels).reshape(-1)
        edges = [p.label_start for p in self.manifest.partitions]
        edges.append(self.manifest.partitions[-1].label_end)
        valid = labels[(labels >= 0) & (labels < self.n_labels)]
        hist, _ = np.histogram(valid, bins=np.asarray(edges))
        return hist.astype(np.int64)


def default_split_level(tree: XMRTree, n_partitions: int) -> int:
    """Smallest level whose chunk count can host P contiguous partitions:
    splitting as high as possible slices the most layers 1/P and keeps the
    replicated router head small."""
    for level in range(1, tree.depth):
        if tree.n_cols[level - 1] >= n_partitions:
            return level
    raise ValueError(
        f"tree has no level with >= {n_partitions} chunks "
        f"(n_cols={tree.n_cols}); reduce partitions"
    )


def partition_tree(
    tree: XMRTree,
    n_partitions: int,
    *,
    level: int | None = None,
    bounds: Sequence[int] | None = None,
) -> PartitionedIndex:
    """Split ``tree`` into a router head + ``n_partitions`` sub-trees, on the
    tree's device.

    Chunks of layer ``level`` (the nodes of level ``level - 1``) are divided
    into contiguous, near-equal ranges; the global ragged tail lands in the
    last partition. Explicit ``bounds`` (``n_partitions + 1`` strictly
    increasing chunk boundaries covering ``[0, n_chunks]``) cut uneven
    ranges on purpose, as :func:`rebalance` does.
    """
    if n_partitions < 1:
        raise ValueError(f"n_partitions must be >= 1; got {n_partitions}")
    if level is None:
        level = default_split_level(tree, n_partitions)
    n_chunks = tree.n_cols[level - 1]
    if n_partitions > n_chunks:
        raise ValueError(
            f"partitions={n_partitions} exceeds the {n_chunks} chunks of "
            f"level {level}"
        )
    if bounds is None:
        bounds = np.linspace(0, n_chunks, n_partitions + 1).round().astype(int)
    else:
        bounds = np.asarray(list(bounds), dtype=int)
        if (
            len(bounds) != n_partitions + 1
            or bounds[0] != 0
            or bounds[-1] != n_chunks
            or np.any(np.diff(bounds) < 1)
        ):
            raise ValueError(
                f"bounds must be {n_partitions + 1} strictly increasing "
                f"chunk boundaries covering [0, {n_chunks}]; got "
                f"{bounds.tolist()}"
            )
    leaf_span = int(np.prod(tree.branching[level:]))

    head = tree.head(level)
    parts, infos = [], []
    for pid in range(n_partitions):
        c0, c1 = int(bounds[pid]), int(bounds[pid + 1])
        sub = tree.extract(level, c0, c1)
        parts.append(sub)
        label_start = c0 * leaf_span
        infos.append(
            PartitionInfo(
                pid=pid,
                chunk_start=c0,
                chunk_end=c1,
                label_start=label_start,
                label_end=label_start + sub.n_labels,
                memory_bytes=sub.memory_bytes(),
                content_hash=_content_hash(sub),
            )
        )
    if infos[-1].label_end != tree.n_labels:
        raise AssertionError(
            f"partitions cover {infos[-1].label_end} of {tree.n_labels} labels"
        )
    manifest = PartitionManifest(
        level=level,
        n_partitions=n_partitions,
        n_labels=tree.n_labels,
        d=tree.d,
        branching=tree.branching,
        router_memory_bytes=head.memory_bytes(),
        total_memory_bytes=tree.memory_bytes(),
        partitions=infos,
    )
    return PartitionedIndex(
        head=head,
        parts=parts,
        manifest=manifest,
        n_cols=tree.n_cols,
        branching=tree.branching,
    )


def rebalance_bounds(
    manifest: PartitionManifest, occupancy: Sequence[float]
) -> List[int]:
    """Re-cut split-level chunk boundaries from observed occupancy skew.

    ``occupancy`` is the per-partition share of observed traffic under the
    current cut (``ServerMetrics.partition_occupancy`` or
    :meth:`~repro_torch.index.cache.HotBeamCache.occupancy`). Each chunk
    gets the uniform slice of its partition's share, and boundary ``k``
    moves to the chunk whose weight prefix is closest to ``k/P`` of the
    total; every partition keeps at least one chunk.
    """
    P = manifest.n_partitions
    occ = np.asarray(occupancy, dtype=np.float64)
    if occ.shape != (P,):
        raise ValueError(
            f"occupancy must hold {P} shares; got shape {occ.shape}"
        )
    if np.any(occ < 0) or occ.sum() <= 0:
        raise ValueError(f"occupancy shares must be >= 0 and sum > 0; got {occ}")
    n_chunks = manifest.partitions[-1].chunk_end
    weight = np.empty(n_chunks, dtype=np.float64)
    for p, info in zip(occ, manifest.partitions):
        width = info.chunk_end - info.chunk_start
        weight[info.chunk_start:info.chunk_end] = p / width
    prefix = np.concatenate([[0.0], np.cumsum(weight)])  # [n_chunks + 1]
    bounds = [0]
    for k in range(1, P):
        target = prefix[-1] * k / P
        cut = int(np.argmin(np.abs(prefix - target)))
        # Strictly increasing, and leave room for the partitions after us.
        cut = min(max(cut, bounds[-1] + 1), n_chunks - (P - k))
        bounds.append(cut)
    bounds.append(n_chunks)
    return bounds


def rebalance(
    tree: XMRTree,
    manifest: PartitionManifest,
    occupancy: Sequence[float],
) -> PartitionedIndex:
    """Offline re-partition of ``tree`` from observed ``occupancy`` skew, at
    the manifest's split level with :func:`rebalance_bounds`' ranges. The
    schema version stays; the content hashes tell the cuts apart."""
    return partition_tree(
        tree,
        manifest.n_partitions,
        level=manifest.level,
        bounds=rebalance_bounds(manifest, occupancy),
    )
