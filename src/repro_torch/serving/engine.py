"""Batched XMR serving engine (counterpart of ``repro.serving.engine``).

The paper's two production settings (§3.2): **batch**, a matrix of queries
served in bucketed chunks, and **online**, one query at a time. Batch sizes
are bucketed to powers of two and query nnz padded to a fixed ELL width, as
in the reference, so both packages see the same shapes.

``serve_batch`` double-buffers: the host marshals chunk *i+1* while the GPU
runs chunk *i*. That relies on CUDA's asynchronous launches, as the
reference relies on JAX's asynchronous dispatch: the traversal reads
nothing back to the host, queries go to the device through pinned memory
with ``non_blocking=True``, and the engine waits only when it copies a
finished chunk's results back.

A quantized tier (``ServeConfig(quant=QuantConfig(tier=...))`` other than
``exact``) quantizes the tree once, on its device, when the engine is built,
and serves it through ``method="mscm_pallas_grouped_q"``, as the reference
does.

With ``ServeConfig(slo=SLOConfig(target_p99_ms=...))`` the engine carries a
ladder of beam tiers (:mod:`repro_torch.serving.slo`): ``_run(xi, xv,
tier)`` serves at that tier's ``(beam, qt)``, tier 0 exactly as an engine
without the group. The async micro-batching front end over this engine is
:mod:`repro_torch.serving.batcher`.

Sharded dispatch (``ServeConfig(shards=N)``): the tree is replicated over a
``("data",)`` mesh of N device slots (:func:`repro_torch.distributed.
sharding.replica_mesh`; one copy per distinct device) and every bucket's
rows split over them, each slot on its own CUDA stream. Per-query arithmetic
is unchanged, so on the card results are bitwise those of one slot.

Partitioned dispatch (``ServeConfig(partition=PartitionConfig(partitions=
P))``): the tree is cut into P label-contiguous sub-trees
(:func:`~repro_torch.index.partition.partition_tree`; quantized per
partition under a tier), placed over a ``("data", "model")`` mesh of device
slots (:func:`~repro_torch.index.placement.place`) and served by the
scatter-gather planner, bitwise the unpartitioned tree in the ``level`` and
``pipelined`` sync modes. Composes with ``shards=N``. The engine then holds
the head and the parts on the card, not a copy of the whole tree.

``devices=`` names the device slots of either mesh (every visible card by
default on a GPU, the engine's device on the CPU); a device may repeat, so
one card, or the CPU, can stand in for a mesh.

CUDA graphs: where the whole traversal is enqueued on the caller's stream
(a CUDA device, no replicas, and no planner placement, beam cache or
transport: ``XMRServingEngine._graphable``), a dispatch key's first
``_run`` runs eagerly, its second records the same traversal as one CUDA
graph on static input buffers, and every later ``_run`` of the key copies
its queries into them and replays the graph: one ``cudaGraphLaunch`` for the
~400 launches a traversal issues, and counts again the launches its capture
counted (``obs``' ``launches.*``). All the keys' graphs share one memory
pool, so they replay only on the stream the first was recorded from.
Elsewhere, and on any other stream, every ``_run`` runs eagerly.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.tree import XMRTree, check_method, resolve_device
from repro_torch.distributed.sharding import (
    Slot, replica_mesh, resolve_devices, row_slices, send, visible_devices)
from repro_torch.index import ScatterGatherPlanner, partition_tree, place
from repro_torch.index.planner import reference_topk_width
from repro_torch.quant.storage import QuantizedTree, quantize_index, quantize_tree
from repro_torch.serving.config import (
    AdmissionConfig, PartitionConfig, QuantConfig, ServeConfig)
from repro_torch.serving.metrics import LatencyStats
from repro_torch.serving.slo import BeamTier, resolve_tiers
from repro_torch.sparse.csr import CSR, rows_to_ell

__all__ = [
    "AdmissionConfig",
    "PartitionConfig",
    "QuantConfig",
    "ServeConfig",
    "XMRServingEngine",
    "resolve_method",
]


def resolve_method(method: str, device: str | torch.device | None = None) -> str:
    """Resolve ``"auto"`` to the best batch method for the device: the
    grouped CUDA kernel on a GPU, the dense-lookup einsum elsewhere.
    ``device=None`` means the GPU when one is present."""
    if method != "auto":
        return method
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return "mscm_pallas_grouped" if torch.device(device).type == "cuda" else "mscm_dense"


#: Serial numbers of engines, for the ``engine`` attribute of their root spans.
_SERIALS = itertools.count(1)


class _Graph(NamedTuple):
    """One dispatch key's recorded traversal: the graph, the static inputs
    it reads, the outputs it writes, and the ``obs`` counts (the kernels'
    launches) its capture made, which each replay counts again."""

    graph: "torch.cuda.CUDAGraph"
    xi: torch.Tensor
    xv: torch.Tensor
    out: Tuple[torch.Tensor, torch.Tensor]
    counts: Dict[str, int]


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


class XMRServingEngine:
    def __init__(self, tree: XMRTree, config: ServeConfig | None = None,
                 label_perm: Optional[np.ndarray] = None, *,
                 device: str | torch.device | None = None,
                 devices: Optional[Sequence] = None):
        self.config = config or ServeConfig()
        if device is None and devices:
            device = devices[0]
        self.device = resolve_device(device)
        self.method = resolve_method(self.config.method, self.device)
        check_method(self.method)
        qc = self.config.quant
        if qc.tier != "exact":
            # Only the quantized grouped kernel reads int8/fp8 tiles: "auto"
            # resolves there, and an explicit exact method contradicts the tier.
            if self.config.method not in ("auto", "mscm_pallas_grouped_q"):
                raise ValueError(
                    f"quant tier {qc.tier!r} serves via method='mscm_pallas_grouped_q'; "
                    f"got explicit method={self.config.method!r}"
                )
            self.method = "mscm_pallas_grouped_q"
        elif self.method == "mscm_pallas_grouped_q" and not isinstance(tree, QuantizedTree):
            raise ValueError(
                "method='mscm_pallas_grouped_q' serves a quantized tree: set "
                "ServeConfig(quant=QuantConfig(tier=...)) or pass a QuantizedTree"
            )
        # The beam-tier ladder (tier 0 = the configured beam; one tier unless
        # slo.target_p99_ms is set). A degraded tier must give the full
        # beam's result width, or result shapes would change per batch.
        self.tiers: Tuple[BeamTier, ...] = resolve_tiers(self.config)
        if len(self.tiers) > 1:
            c = self.config
            full_w = reference_topk_width(tree.n_cols, tree.branching, c.beam, c.topk)
            for t in self.tiers[1:]:
                w = reference_topk_width(tree.n_cols, tree.branching, t.beam, c.topk)
                if w != full_w:
                    raise ValueError(
                        f"beam tier {t.beam} yields top-k width {w} != full-beam width "
                        f"{full_w}; widen the tier or raise slo min_beam"
                    )
        self.label_perm = label_perm  # leaf position -> original label id
        self.stats = LatencyStats()
        self.serial = next(_SERIALS)
        self.mesh = None
        self.index = None
        self.placement = None
        self.planner = None
        self._replicas = None
        # CUDA graphs by dispatch key, the keys run once eagerly, and the
        # pool, capture stream and replay stream every key shares (set at the
        # first capture: graphs that share a pool must never run at once).
        self._graphs = {}
        self._warm_keys = set()
        self._graph_pool = None
        self._capture_stream = None
        self._graph_stream = None
        self._graph_lock = threading.Lock()
        c, pc = self.config, self.config.partition
        shards = c.shards
        if shards < 1 or shards & (shards - 1):
            raise ValueError(f"shards={shards} must be a power of two (buckets are)")
        if shards > c.max_batch:
            raise ValueError(f"shards={shards} exceeds max_batch={c.max_batch}")
        if devices is None:
            devices = visible_devices() if self.device.type == "cuda" else [self.device]
        devices = resolve_devices(devices)
        if pc.partitions > 1:
            # Label-partitioned dispatch: cut the tree where it lies, quantize
            # each part after the cut (the router head stays f32), place the
            # parts over a ("data", "model") mesh; every _run goes through the
            # scatter-gather planner.
            self.index = partition_tree(tree, pc.partitions, level=pc.partition_level)
            if qc.tier != "exact":
                self.index = quantize_index(self.index, tier=qc.tier,
                                            prune_keep=qc.prune_keep)
            self.placement = place(self.index, shards=shards, devices=devices)
            self.planner = ScatterGatherPlanner(
                self.index, beam=c.beam, topk=c.topk, method=self.method,
                score_mode=c.score_mode, qt=c.qt, sync=pc.partition_sync,
                placement=self.placement, cache_entries=pc.beam_cache,
            )
            self.mesh = self.placement.mesh
            self.tree = tree  # for its geometry; the planner holds the weights
            return
        self.tree = tree.to(self.device)
        if qc.tier != "exact":
            self.tree = quantize_tree(self.tree, tier=qc.tier, prune_keep=qc.prune_keep)
        if shards > 1:
            # One replica per device slot (one copy per distinct device);
            # every bucket's rows split over the slots.
            self.mesh = replica_mesh(shards, devices=devices)
            self._replicas = [(Slot.new(dev), self.tree.to(dev)) for dev in self.mesh.devices]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            # Pinned source + non_blocking: the copy is enqueued without
            # waiting for the chunk the GPU is still running.
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # -- query marshalling --------------------------------------------------
    def marshal_rows(self, queries: CSR, rows: np.ndarray, bucket: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Vectorized ELL marshalling padded up to a bucket; padding rows
        are empty queries (sentinel index ``d``, value 0)."""
        w = self.config.ell_width
        d = queries.shape[1]
        with obs.span("serve.marshal"):
            idx, val = rows_to_ell(queries, rows, w)
            if bucket > len(rows):
                pad = bucket - len(rows)
                idx = np.concatenate([idx, np.full((pad, w), d, np.int32)])
                val = np.concatenate([val, np.zeros((pad, w), np.float32)])
            return self._to_device(idx), self._to_device(val)

    def bucket_for(self, n: int) -> int:
        """Power-of-two bucket for ``n`` queries, never below ``shards`` so
        that a sharded dispatch always splits evenly."""
        return max(_bucket(n, self.config.max_batch), self.config.shards)

    def bucket_key(self, n: int, tier: int = 0) -> Tuple[int, int]:
        """The dispatch key ``(bucket, beam_tier)``: both coordinates are
        bounded static sets, so ``warmup_buckets`` can enumerate every key."""
        return (self.bucket_for(n), int(tier))

    def _graphable(self) -> bool:
        """Whether ``_run`` enqueues the whole traversal on the caller's
        stream and reads nothing back to the host, so that a CUDA graph can
        record it: no replicas (each on a stream of its own), and a planner,
        if any, without a placement (streams per slot), a beam cache (which
        reads the router's beam back) or a transport (which copies to numpy).
        The graphs engage only where this holds on a CUDA device."""
        if self._replicas is not None:
            return False
        p = self.planner
        return p is None or (p.placement is None and p.cache is None and p.transport is None)

    def _traverse(self, xi: torch.Tensor, xv: torch.Tensor, tier: int):
        """The traversal of one bucket at ``tier``, enqueued eagerly."""
        c, t = self.config, self.tiers[tier]
        if self.planner is not None:
            # The tier's beam/qt ride as per-call overrides only when degraded.
            if tier:
                return self.planner.infer(xi, xv, beam=t.beam, qt=t.qt)
            return self.planner.infer(xi, xv)
        kw = dict(beam=t.beam, topk=c.topk, method=self.method, score_mode=c.score_mode,
                  qt=t.qt)
        if self._replicas is None:
            return self.tree.infer(xi, xv, **kw)
        # Each slot serves its run of rows on its own stream; the caller's
        # stream waits for every slot before the results are handed back.
        caller = Slot.current(xi.device)
        out_s, out_l = [], []
        for (slot, tree), (r0, r1) in zip(self._replicas,
                                          row_slices(xi.shape[0], len(self._replicas))):
            xi_r, xv_r = send((xi[r0:r1], xv[r0:r1]), caller, slot)
            with slot.enter():
                s, l = tree.infer(xi_r, xv_r, **kw)
            s, l = send((s, l), slot, caller)
            out_s.append(s)
            out_l.append(l)
        return torch.cat(out_s), torch.cat(out_l)

    def _run(self, xi: torch.Tensor, xv: torch.Tensor, tier: int = 0):
        with obs.span("serve.run"):
            out = self._replay(xi, xv, tier)
            return self._traverse(xi, xv, tier) if out is None else out

    def _replay(self, xi: torch.Tensor, xv: torch.Tensor, tier: int):
        """``_run``'s outputs from its dispatch key's CUDA graph, recorded at
        the key's second run; None where the run is eager: off a CUDA device,
        where :meth:`_graphable` does not hold, a key's first run, and a run
        on another stream than the one the engine's first graph was recorded
        on (all the graphs share one pool, so they replay on one stream)."""
        dev = xi.device
        if dev.type != "cuda" or not self._graphable():
            return None
        key = (tier, tuple(xi.shape), tuple(xv.shape), xi.dtype, xv.dtype)
        stream = torch.cuda.current_stream(dev)
        with self._graph_lock:
            if self._graph_stream not in (None, stream):
                return None
            g = self._graphs.get(key)
            recount = g is not None
            if g is None:
                if key not in self._warm_keys:
                    # The key's first run builds and loads the kernels, sets
                    # their attributes and fills the plan caches.
                    self._warm_keys.add(key)
                    return None
                g = self._graphs[key] = self._capture(xi, xv, tier)
                self._graph_stream = stream
            # Stream-ordered after the last replay, whose outputs were copied
            # out before these inputs overwrite the static ones.
            g.xi.copy_(xi)
            g.xv.copy_(xv)
            g.graph.replay()
            obs.count("graph.replay")
            if recount:  # the capture counted this run's launches itself
                for name, n in g.counts.items():
                    obs.count(name, n)
            return tuple(o.clone() for o in g.out)

    def _capture(self, xi: torch.Tensor, xv: torch.Tensor, tier: int) -> _Graph:
        """Record ``_traverse`` as a CUDA graph on static inputs of
        ``xi``/``xv``'s shapes, in the pool all the engine's graphs share."""
        dev = xi.device
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(dev)
        sxi, sxv = torch.empty_like(xi), torch.empty_like(xv)
        graph = torch.cuda.CUDAGraph()
        # thread_local: other threads may go on using the device meanwhile.
        with obs.tally() as counted, torch.cuda.device(dev), torch.cuda.graph(
                graph, pool=self._graph_pool, stream=self._capture_stream,
                capture_error_mode="thread_local"):
            out = self._traverse(sxi, sxv, tier)
        obs.count("graph.capture")
        return _Graph(graph, sxi, sxv, tuple(out), counted)

    def _run_to_host(self, xi: torch.Tensor, xv: torch.Tensor, count: int, tier: int = 0):
        """Enqueue one bucket at ``tier`` and the copies of its first
        ``count`` rows to the host. Returns ``(scores, labels, done)``:
        host tensors (pinned on a GPU) that must not be read before ``done``
        (a CUDA event recorded after the copies; None on the CPU, where
        everything has already finished) completes: a non-blocking copy
        read early gives stale memory and no error."""
        s, l = self._run(xi, xv, tier=tier)
        with obs.span("serve.copy_back"):
            s = s[:count].to("cpu", non_blocking=True)
            l = l[:count].to("cpu", non_blocking=True)
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
        return s, l, done

    def _empty_batch(self, bucket: int, d: int) -> Tuple[torch.Tensor, torch.Tensor]:
        w = self.config.ell_width
        xi = torch.full((bucket, w), d, dtype=torch.int32, device=self.device)
        xv = torch.zeros((bucket, w), dtype=torch.float32, device=self.device)
        return xi, xv

    # -- serving modes --------------------------------------------------
    def warmup(self, d: int, batch_sizes: Sequence[int] = (1,), tier: int = 0) -> None:
        """Run each bucket once at ``tier``, so that the kernels are built
        and loaded, and the plans and the allocator cached, before live
        traffic arrives. Where CUDA graphs engage, then run each once more,
        largest first: that run records the bucket's graph, and the smaller
        buckets' graphs fit in the pool memory the largest one's took."""
        batches = [self._empty_batch(self.bucket_for(b), d) for b in batch_sizes]
        if self.device.type == "cuda" and self._graphable():
            batches += sorted(batches, key=lambda batch: -batch[0].shape[0])
        for xi, xv in batches:
            self._run(xi, xv, tier=tier)
            self._sync()

    def warmup_buckets(self, d: int, max_batch: int,
                       tiers: Optional[Sequence[int]] = None) -> None:
        """Warm every power-of-two bucket up to ``bucket_for(max_batch)`` at
        every tier (or at ``tiers``): each ``bucket_key`` a batcher capped
        at ``max_batch`` can dispatch."""
        sizes, b = [], self.config.shards
        target = self.bucket_for(max_batch)
        while b <= target:
            sizes.append(b)
            b *= 2
        for tier in tiers if tiers is not None else range(len(self.tiers)):
            self.warmup(d, sizes, tier=tier)

    def serve_batch(self, queries: CSR) -> Tuple[np.ndarray, np.ndarray]:
        """Batch setting: all queries, in ``max_batch`` chunks, double
        buffered. One amortized per-query average is recorded per call."""
        n = queries.shape[0]
        mb = self.config.max_batch
        t_start = obs.clock_ns()
        with obs.span("serve.batch", engine=self.serial, queries=n, buckets=-(-n // mb)):
            out_s, out_l = [], []

            def finalize(pending) -> None:
                s, l, done = pending
                if done is not None:
                    with obs.span("serve.wait"):
                        done.synchronize()  # this chunk and its copy, not the next
                with obs.span("serve.finalize"):
                    out_s.append(s.numpy())
                    out_l.append(l.numpy())

            pending = None
            i = 0
            while i < n:
                count = min(mb, n - i)
                bucket = self.bucket_for(count)
                xi, xv = self.marshal_rows(queries, np.arange(i, i + count), bucket)
                # Enqueued with its copy back, not waited for: waiting for this
                # chunk never waits for the next one.
                nxt = self._run_to_host(xi, xv, count)
                if pending is not None:
                    finalize(pending)
                pending = nxt
                i += count
            if pending is not None:
                finalize(pending)
            with obs.span("serve.finalize"):
                scores = np.concatenate(out_s)
                labels = self._map_labels(np.concatenate(out_l))
        self.stats.record_amortized((obs.clock_ns() - t_start) * 1e-9, n)
        return scores, labels

    def serve_online(self, queries: CSR, limit: int | None = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Online setting: one query at a time, each query's latency recorded
        from its marshaling to its answer on the host."""
        n = queries.shape[0] if limit is None else min(limit, queries.shape[0])
        with obs.span("serve.online", engine=self.serial, queries=n, buckets=n):
            out_s, out_l = [], []
            bucket = self.bucket_for(1)
            for i in range(n):
                t0 = obs.clock_ns()
                xi, xv = self.marshal_rows(queries, np.arange(i, i + 1), bucket)
                s, l = self._run(xi, xv)
                with obs.span("serve.wait"):
                    self._sync()
                with obs.span("serve.copy_back"):
                    out_s.append(s[0].cpu().numpy())
                    out_l.append(l[0].cpu().numpy())
                self.stats.record((obs.clock_ns() - t0) * 1e-9)
            with obs.span("serve.finalize"):
                scores = np.stack(out_s)
                labels = self._map_labels(np.stack(out_l))
        return scores, labels

    def _map_labels(self, leaves: np.ndarray) -> np.ndarray:
        if self.label_perm is None:
            return leaves
        return self.label_perm[leaves]

    def partition_hit_counts(self, leaves: np.ndarray) -> Optional[np.ndarray]:
        """Per-partition result share for a batch of *raw* leaf ids (before
        ``label_perm``); None when serving unpartitioned."""
        if self.planner is None:
            return None
        return self.planner.hit_counts(leaves)

    def beam_cache_stats(self) -> Optional[dict]:
        """Cumulative hot-beam cache accounting (None when off or
        unpartitioned)."""
        if self.planner is None:
            return None
        return self.planner.cache_stats()

    def last_degraded(self) -> Optional[dict]:
        """Degraded-batch info of the last dispatch: None when every
        partition served it (or the engine is unpartitioned), else
        ``{"partitions": [...], "label_ranges": [(lo, hi), ...]}``. Read it
        right after the dispatch that produced it (the batcher snapshots it
        per batch)."""
        if self.planner is None:
            return None
        return self.planner.last_degraded

    def measure_batch_seconds(self, batch: int, iters: int = 3, tier: int = 0) -> float:
        """Median wall seconds for one ``batch``-sized dispatch at ``tier``
        (warmed), with empty queries that traverse the same levels as real
        ones: the drain-rate probe behind ``queue_depth="auto"`` and the
        cost model of :class:`~repro_torch.serving.slo.BeamTierPolicy`."""
        xi, xv = self._empty_batch(self.bucket_for(batch), self.tree.d)
        self._run(xi, xv, tier=tier)
        self._sync()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            self._run(xi, xv, tier=tier)
            self._sync()
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    def latency_summary(self) -> dict:
        return self.stats.summary()
