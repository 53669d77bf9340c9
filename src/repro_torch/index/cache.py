"""Partition-local hot-beam cache for the scatter-gather planner
(counterpart of ``repro.index.cache``; host numpy, line for line).

After the router runs, the partitioned levels need only one thing from the
beam to plan the exchange: **which partitions own any surviving row**, a
function of the beam's chunk-id set alone, because ownership is nested: a
partition owning no row of the router handoff owns none at any deeper level
(children of an owned chunk stay in the owner's contiguous range), so it
contributes only ``NEG_INF`` and can be skipped without changing a bit.

:class:`HotBeamCache` memoizes that signature -> owner-set mapping in an LRU
over **beam signatures** (the sorted chunk-id multiset of one query's router
beam). It also accumulates ``owner_counts``, how many routed beam rows each
partition owned: the occupancy feed of
:func:`repro_torch.index.partition.rebalance`.

The cache is consulted on the host (one small ``[n, beam]`` device-to-host
copy per batch), so it is opt-in: ``ScatterGatherPlanner(...,
cache_entries=0)`` (the default) never synchronises.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence

import numpy as np


class HotBeamCache:
    """LRU of router-beam signatures → the partitions that own any row.

    ``chunk_bounds`` are the split-level chunk boundaries from the manifest
    (``[p.chunk_start for p] + [last.chunk_end]``); a beam id ``c`` is owned
    by partition ``searchsorted(bounds, c, "right") - 1``.
    """

    def __init__(self, capacity: int, chunk_bounds: Sequence[int]) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1; got {capacity}")
        self.capacity = capacity
        self._bounds = np.asarray(chunk_bounds, dtype=np.int64)
        if self._bounds.ndim != 1 or len(self._bounds) < 2:
            raise ValueError("chunk_bounds must hold >= 2 boundaries")
        # Each entry maps a beam signature to {pid: owned-row count} — the
        # counts (not just the owner set) are what keep the occupancy feed
        # faithful to per-partition *load*, not mere participation.
        self._lru: "OrderedDict[bytes, Dict[int, int]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # Router-level occupancy: beam rows owned per partition — the feed
        # for offline rebalancing (repro_torch.index.partition.rebalance).
        self.owner_counts = np.zeros(len(self._bounds) - 1, dtype=np.int64)

    @property
    def n_partitions(self) -> int:
        return len(self._bounds) - 1

    def __len__(self) -> int:
        return len(self._lru)

    # ------------------------------------------------------------------
    def _owners(self, row: np.ndarray) -> Dict[int, int]:
        """{pid: number of this row's beam entries the partition owns}."""
        valid = row[(row >= self._bounds[0]) & (row < self._bounds[-1])]
        pids = np.searchsorted(self._bounds, valid, side="right") - 1
        uniq, counts = np.unique(pids, return_counts=True)
        return {int(p): int(c) for p, c in zip(uniq, counts)}

    def active_partitions(self, beam_ids: np.ndarray) -> List[int]:
        """Partitions owning ≥ 1 row of any query's router beam.

        ``beam_ids`` is the routed ``[n, b]`` handoff. Per-row signatures
        hit the LRU; the batch's active set is the union. Falls back to
        *every* partition when no row is owned (a degenerate all-phantom
        beam) so the planner's gather always has at least one operand.
        """
        beam_ids = np.asarray(beam_ids, dtype=np.int64)
        if beam_ids.ndim == 1:
            beam_ids = beam_ids[None, :]
        active: set = set()
        for row in beam_ids:
            key = np.sort(row).tobytes()
            owners = self._lru.get(key)
            if owners is None:
                self.misses += 1
                owners = self._owners(row)
                self._lru[key] = owners
                if len(self._lru) > self.capacity:
                    self._lru.popitem(last=False)
                    self.evictions += 1
            else:
                self.hits += 1
                self._lru.move_to_end(key)
            for p, count in owners.items():
                self.owner_counts[p] += count
            active |= owners.keys()
        if not active:
            return list(range(self.n_partitions))
        return sorted(active)

    # ------------------------------------------------------------------
    def occupancy(self) -> np.ndarray:
        """Per-partition share of routed beam rows (sums to 1; uniform when
        nothing has been routed yet) — rebalance's input format."""
        total = self.owner_counts.sum()
        if total == 0:
            return np.full(self.n_partitions, 1.0 / self.n_partitions)
        return self.owner_counts / total

    def stats(self) -> dict:
        lookups = self.hits + self.misses
        return {
            "hits": int(self.hits),
            "misses": int(self.misses),
            "hit_rate": float(self.hits / lookups) if lookups else 0.0,
            "evictions": int(self.evictions),
            "entries": len(self._lru),
            "capacity": self.capacity,
            "owner_counts": [int(c) for c in self.owner_counts],
        }
