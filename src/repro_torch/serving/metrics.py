"""Serving-side metrics (counterpart of ``repro.serving.metrics``).

:class:`LatencyStats` is the per-query wall-clock recorder: per-query
samples (the online setting) and amortized batch-call averages (the batch
setting, where overlapped chunks make individual per-query times
meaningless) are kept in separate series, so percentiles stay percentiles
over individual queries.

:class:`ServerMetrics` is the micro-batching server's: each request splits
into queue wait (enqueue to batch formed) and compute (dispatch to results
on the host), plus throughput (QPS, which is goodput: only completed
requests count), coalescing triggers, bucket occupancy, overload accounting
(shed and deadline-miss rates) and the beam-tier mix. Its summary keys are
the reference's. A partitioned engine adds the partition occupancy (share
of results per label partition), the pipeline stall (the worker's wall
blocked on a dispatched batch's results, after dispatch returned) and the
hot-beam cache's counters; a sharded one, the occupancy of each replica.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List

import numpy as np


def _percentiles(arr: np.ndarray) -> Dict[str, float]:
    return {
        "avg_ms": float(arr.mean()),
        "p50_ms": float(np.percentile(arr, 50)),
        "p95_ms": float(np.percentile(arr, 95)),
        "p99_ms": float(np.percentile(arr, 99)),
    }


@dataclasses.dataclass
class LatencyStats:
    """Latency recorder with per-query and amortized series kept distinct."""

    per_query_ms: List[float] = dataclasses.field(default_factory=list)
    amortized_ms: List[float] = dataclasses.field(default_factory=list)
    amortized_queries: int = 0

    def record(self, query_s: float, n_queries: int = 1) -> None:
        """Record a per-query sample; ``n_queries > 1`` is an amortized call
        average and goes to the amortized series."""
        if n_queries > 1:
            self.record_amortized(query_s, n_queries)
        else:
            self.per_query_ms.append(1e3 * query_s)

    def record_amortized(self, total_s: float, n_queries: int) -> None:
        """Record one batch call: total wall time over ``n_queries``."""
        self.amortized_ms.append(1e3 * total_s / max(n_queries, 1))
        self.amortized_queries += n_queries

    def summary(self) -> dict:
        out: dict = {"count": len(self.per_query_ms)}
        if self.per_query_ms:
            out.update(_percentiles(np.asarray(self.per_query_ms)))
        if self.amortized_ms:
            arr = np.asarray(self.amortized_ms)
            out["amortized"] = {
                "calls": len(arr),
                "queries": self.amortized_queries,
                "avg_ms_per_query": float(arr.mean()),
            }
        return out


def _replica_rows(count: int, bucket: int, shards: int) -> List[int]:
    """Real (non-padding) rows each replica holds for one dispatched bucket.

    The bucket splits evenly over the mesh's data axis; real rows occupy the
    bucket head, so padding concentrates on the trailing replicas.
    """
    per = bucket // max(shards, 1)
    return [int(np.clip(count - r * per, 0, per)) for r in range(shards)]


@dataclasses.dataclass
class ServerMetrics:
    """End-to-end request accounting for the micro-batching server.

    Thread-safe: the batcher worker records batches while client threads
    submit (shed/deadline counters) and read summaries.
    """

    queue_wait_ms: List[float] = dataclasses.field(default_factory=list)
    compute_ms: List[float] = dataclasses.field(default_factory=list)
    e2e_ms: List[float] = dataclasses.field(default_factory=list)
    batch_sizes: List[int] = dataclasses.field(default_factory=list)
    bucket_sizes: List[int] = dataclasses.field(default_factory=list)
    triggers: List[str] = dataclasses.field(default_factory=list)
    batch_shards: List[int] = dataclasses.field(default_factory=list)
    partition_hits: List[np.ndarray] = dataclasses.field(default_factory=list)
    pipeline_stall_ms: List[float] = dataclasses.field(default_factory=list)
    beam_cache: Dict[str, float] = dataclasses.field(default_factory=dict)
    offered: int = 0
    shed: int = 0
    shed_by_priority: Dict[int, int] = dataclasses.field(default_factory=dict)
    deadline_missed: int = 0
    degraded_served: int = 0  # successful queries answered from a partial fleet
    # Per-beam-tier completed-query counts (tier 0 = full beam); populated
    # only by engines with an SLO ladder, so legacy summaries are unchanged.
    tier_queries: Dict[int, int] = dataclasses.field(default_factory=dict)
    _t_first: float | None = None
    _t_last: float | None = None
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False
    )

    # -- overload accounting (client/worker threads) ------------------------
    def record_offered(self) -> None:
        with self._lock:
            self.offered += 1

    def record_shed(self, priority: int = 0) -> None:
        with self._lock:
            self.shed += 1
            self.shed_by_priority[priority] = (
                self.shed_by_priority.get(priority, 0) + 1
            )

    def record_deadline_miss(self) -> None:
        with self._lock:
            self.deadline_missed += 1

    def record_degraded(self, n_queries: int) -> None:
        """Count queries served degraded (partial fleet, survivor-exact)."""
        with self._lock:
            self.degraded_served += n_queries

    # -- batch accounting (worker thread) -----------------------------------
    def record_batch(
        self,
        *,
        t_enqueue: List[float],
        t_dequeue: float,
        t_done: float,
        bucket: int,
        trigger: str,
        shards: int = 1,
        partition_hits=None,
        stall_ms: float | None = None,
        cache_stats: dict | None = None,
        tier: int = 0,
    ) -> None:
        """Record one dispatched micro-batch of len(t_enqueue) requests.

        ``partition_hits`` (per-partition result counts from the engine's
        label-partitioned planner) feeds the partition-occupancy panel;
        ``stall_ms`` is the worker's blocked-on-device wall for this batch
        (partitioned dispatch only) and ``cache_stats`` the planner's
        *cumulative* hot-beam cache counters (latest snapshot wins).
        ``tier`` is the beam tier the batch was dispatched at (0 = full).
        """
        compute = 1e3 * (t_done - t_dequeue)
        with self._lock:
            self.tier_queries[tier] = (
                self.tier_queries.get(tier, 0) + len(t_enqueue)
            )
            if partition_hits is not None:
                self.partition_hits.append(np.asarray(partition_hits))
            if stall_ms is not None:
                self.pipeline_stall_ms.append(stall_ms)
            if cache_stats is not None:
                self.beam_cache = dict(cache_stats)
            for te in t_enqueue:
                self.queue_wait_ms.append(1e3 * (t_dequeue - te))
                self.e2e_ms.append(1e3 * (t_done - te))
            self.compute_ms.append(compute)
            self.batch_sizes.append(len(t_enqueue))
            self.bucket_sizes.append(bucket)
            self.triggers.append(trigger)
            self.batch_shards.append(shards)
            first = min(t_enqueue)
            if self._t_first is None or first < self._t_first:
                self._t_first = first
            if self._t_last is None or t_done > self._t_last:
                self._t_last = t_done

    @property
    def count(self) -> int:
        with self._lock:
            return len(self.e2e_ms)

    def summary(self) -> dict:
        with self._lock:
            if not self.e2e_ms:
                out = {"count": 0}
                if self.offered:
                    out["offered"] = self.offered
                    out["shed"] = self.shed
                    out["shed_rate"] = self.shed / self.offered
                    if self.shed_by_priority:
                        out["shed_by_priority"] = dict(
                            sorted(self.shed_by_priority.items())
                        )
                    out["deadline_missed"] = self.deadline_missed
                    out["deadline_miss_rate"] = self.deadline_missed / self.offered
                if self.degraded_served:
                    out["degraded_served"] = self.degraded_served
                return out
            e2e = np.asarray(self.e2e_ms)
            wait = np.asarray(self.queue_wait_ms)
            comp = np.asarray(self.compute_ms)
            sizes = np.asarray(self.batch_sizes)
            wall_s = max(self._t_last - self._t_first, 1e-9)
            trig = {
                t: self.triggers.count(t) for t in sorted(set(self.triggers))
            }
            out = {
                "count": len(e2e),
                **_percentiles(e2e),
                "queue_wait_avg_ms": float(wait.mean()),
                "compute_avg_ms": float(comp.mean()),
                "compute_per_query_avg_ms": float(
                    comp.sum() / max(sizes.sum(), 1)
                ),
                # e2e_ms only holds completed requests, so qps IS goodput
                "qps": float(len(e2e) / wall_s),
                "batches": len(sizes),
                "avg_batch": float(sizes.mean()),
                "triggers": trig,
            }
            offered = max(self.offered, len(e2e))
            out["offered"] = offered
            out["shed"] = self.shed
            out["shed_rate"] = self.shed / offered
            if self.shed_by_priority:
                out["shed_by_priority"] = dict(
                    sorted(self.shed_by_priority.items())
                )
            out["deadline_missed"] = self.deadline_missed
            out["deadline_miss_rate"] = self.deadline_missed / offered
            if self.degraded_served:
                out["degraded_served"] = self.degraded_served
                out["degraded_rate"] = self.degraded_served / offered
            if any(t > 0 for t in self.tier_queries):
                # Adaptive-SLO panel: how traffic split across the beam
                # ladder, and what fraction was degraded below full beam
                # (served, not shed — the knob the tier policy trades).
                out["beam_tiers"] = {
                    str(t): int(n)
                    for t, n in sorted(self.tier_queries.items())
                }
                to_tier = sum(
                    n for t, n in self.tier_queries.items() if t > 0
                )
                out["degraded_to_tier"] = int(to_tier)
                out["degraded_to_tier_rate"] = to_tier / max(len(e2e), 1)
            if self.partition_hits:
                hits = np.sum(self.partition_hits, axis=0).astype(float)
                total = max(hits.sum(), 1.0)
                out["partition_occupancy"] = [
                    round(float(h / total), 4) for h in hits
                ]
            if self.pipeline_stall_ms:
                stall = np.asarray(self.pipeline_stall_ms)
                out["pipeline_stall_avg_ms"] = float(stall.mean())
                out["pipeline_stall_p99_ms"] = float(np.percentile(stall, 99))
            if self.beam_cache:
                out["beam_cache"] = dict(self.beam_cache)
            max_shards = max(self.batch_shards, default=1)
            if max_shards > 1:
                occ = np.zeros(max_shards)
                for count, bucket, shards in zip(
                    self.batch_sizes, self.bucket_sizes, self.batch_shards
                ):
                    rows = _replica_rows(count, bucket, shards)
                    per = bucket // shards
                    for r in range(max_shards):
                        occ[r] += (rows[r] / per) if r < shards else 0.0
                out["replica_occupancy"] = [
                    round(float(o / len(self.batch_sizes)), 4) for o in occ
                ]
            return out

    def table4_row(self, name: str) -> str:
        """One line in the paper's Table-4 latency panel format."""
        s = self.summary()
        if not s["count"]:
            return f"{name:24s} (no requests)"
        return (
            f"{name:24s} avg {s['avg_ms']:7.3f} ms/q   "
            f"p50 {s['p50_ms']:7.3f}   p95 {s['p95_ms']:7.3f}   "
            f"p99 {s['p99_ms']:7.3f}   "
            f"wait {s['queue_wait_avg_ms']:6.3f}   "
            f"compute {s['compute_per_query_avg_ms']:6.3f}   "
            f"{s['qps']:8.1f} QPS   "
            f"shed {100 * s['shed_rate']:5.1f}%   "
            f"miss {100 * s['deadline_miss_rate']:5.1f}%"
        )
