"""Async micro-batching front end for the XMR serving engine (counterpart of
``repro.serving.batcher``).

Production online serving (the paper's §3.2 "online" setting under real
traffic) is not one query at a time: a real-time batcher sits in front of
the tree scorer and coalesces in-flight requests so that the cost of a
dispatch is shared. This module provides that front end:

* :class:`RequestQueue` — thread-safe queue with the two coalescing
  triggers: **size** (``max_batch`` requests waiting) and **deadline** (the
  oldest request has waited ``max_wait_ms``), gated by an optional
  :class:`~repro_torch.serving.admission.AdmissionController` so that the
  queue depth stays bounded under overload.
* :class:`MicroBatcher` — a worker thread that drains the queue, marshals
  each micro-batch into the engine's power-of-two buckets, and resolves
  per-request futures. Dispatch is double-buffered: CUDA launches are
  asynchronous, so batch *i+1* is marshalled on the host while the card
  runs batch *i*, and a batch whose trigger fires while batch *i* is still
  on the card is dispatched *before* the worker waits for batch *i*.

Readiness on the card: a dispatch enqueues the bucket's kernels, then
non-blocking copies of its real rows to pinned host memory, then a CUDA
event on the same stream (the device's current stream, which the worker
thread shares with every caller). The event says when the results are on
the host; the worker never reads them before, and waits on that one event,
never on the whole device, which is already running the next bucket.

Results are bitwise those of per-query serving: bucket padding rows are
empty sentinel queries and only the real rows come back. Overload
semantics (bounded queue, shed policies, per-request deadlines) live in
:mod:`repro_torch.serving.admission`; requests shed or expired resolve
their futures with typed errors and never reach the device.
"""

from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Any, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.serving.admission import AdmissionController, AdmissionPolicy
from repro_torch.serving.api import Query, QueryResult
from repro_torch.serving.engine import XMRServingEngine
from repro_torch.serving.metrics import ServerMetrics
from repro_torch.serving.slo import BeamTierPolicy
from repro_torch.sparse.csr import CSR

TRIGGER_SIZE = "size"
TRIGGER_DEADLINE = "deadline"
TRIGGER_FLUSH = "flush"

# Spin interval while waiting for either a coalescing trigger or the
# in-flight batch's results, whichever comes first.
_POLL_S = 5e-5


@dataclasses.dataclass
class BatchPolicy:
    """Coalescing policy: dispatch when either trigger fires."""

    max_batch: int = 16       # size trigger
    max_wait_ms: float = 2.0  # deadline trigger (oldest request's max wait)


@dataclasses.dataclass
class _Request:
    idx: np.ndarray           # sorted feature ids, int32
    val: np.ndarray           # float32 values
    future: Future
    t_enqueue: float
    t_deadline: Optional[float] = None  # absolute perf_counter deadline
    priority: int = 0         # higher = more important (weighted shedding)


class RequestQueue:
    """Thread-safe request queue with size/deadline batch formation.

    With an :class:`AdmissionController`, ``put`` applies the shed policy
    under the queue lock (depth check atomic with the append); a shed
    request's future resolves with ``Overloaded`` instead of enqueueing.
    """

    def __init__(self, admission: AdmissionController | None = None) -> None:
        self._q: deque[_Request] = deque()  # guarded-by: _cond
        self._cond = threading.Condition()
        self._closed = False
        self._admission = admission

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def put(self, req: _Request) -> None:
        with self._cond:
            if self._closed:
                raise RuntimeError("RequestQueue is closed")
            if self._admission is not None and not self._admission.admit(self._q, req):
                return  # shed: future already holds Overloaded
            self._q.append(req)
            self._cond.notify_all()

    def close(self) -> None:
        """No further puts; pending requests are still drained."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def _pop(self, k: int) -> List[_Request]:  # xmrlint: requires-lock=_cond
        out = []
        while self._q and len(out) < k:
            out.append(self._q.popleft())
        return out

    def next_batch(
        self, max_batch: int, max_wait_s: float, *, block: bool = True
    ) -> Tuple[Optional[List[_Request]], str]:
        """Form the next micro-batch.

        Returns ``(requests, trigger)``. ``(None, "")`` means closed and
        drained. With ``block=False``, returns ``([], "")`` immediately when
        no trigger has fired yet (used by the double-buffered worker to
        overlap marshalling with device compute).
        """
        with self._cond:
            while True:
                if self._q:
                    if len(self._q) >= max_batch:
                        return self._pop(max_batch), TRIGGER_SIZE
                    if self._closed:
                        return self._pop(max_batch), TRIGGER_FLUSH
                    deadline = self._q[0].t_enqueue + max_wait_s
                    now = time.perf_counter()
                    if now >= deadline:
                        return self._pop(max_batch), TRIGGER_DEADLINE
                    if not block:
                        return [], ""
                    self._cond.wait(timeout=deadline - now)
                else:
                    if self._closed:
                        return None, ""
                    if not block:
                        return [], ""
                    self._cond.wait(timeout=0.1)


@dataclasses.dataclass
class _InFlight:
    reqs: List[_Request]
    scores: torch.Tensor      # [len(reqs), k] on the host; read only once done
    labels: torch.Tensor      # [len(reqs), k] raw leaf ids, likewise
    done: Any                 # torch.cuda.Event after the copies; None on the CPU
    t_dequeue: float
    bucket: int
    trigger: str
    # Snapshot of engine.last_degraded() taken at dispatch (double buffering
    # dispatches the next batch before this one finalizes).
    degraded: Optional[dict] = None
    # Beam tier this batch was dispatched at (0 = full beam).
    tier: int = 0


def _device_ready(inflight: _InFlight) -> bool:
    """True when the in-flight batch's results are on the host: its CUDA
    event has completed (``query()`` never blocks). An engine on the CPU
    has finished the batch by the time ``_dispatch`` returns."""
    return inflight.done is None or bool(inflight.done.query())


# ``stream`` used to yield an ad-hoc (index, scores, labels, error) tuple
# type; the v1 surface yields :class:`~repro_torch.serving.api.QueryResult`,
# whose ``index``/``labels`` properties alias ``qid``/``ids``. The old name
# stays importable.
StreamResult = QueryResult


class MicroBatcher:
    """Coalescing async server over an :class:`XMRServingEngine`.

    Usage::

        with MicroBatcher(engine, BatchPolicy(max_batch=16)) as mb:
            futs = [mb.submit(idx, val) for idx, val in requests]
            results = [f.result() for f in futs]   # (scores, labels) each

    Overload policy comes from ``admission`` (or, by default, the engine's
    ``ServeConfig(admission=...)`` group); ``start()`` warms every bucket the
    policy can form at every beam tier, so that the first live batch never
    builds a kernel inside its latency budget (``warmup_on_start=False``
    opts out).
    """

    def __init__(
        self,
        engine: XMRServingEngine,
        policy: BatchPolicy | None = None,
        metrics: ServerMetrics | None = None,
        admission: AdmissionPolicy | None = None,
        *,
        warmup_on_start: bool = True,
    ) -> None:
        self.engine = engine
        self.policy = policy or BatchPolicy()
        if self.policy.max_batch > engine.config.max_batch:
            raise ValueError(
                f"policy.max_batch={self.policy.max_batch} exceeds engine "
                f"max_batch={engine.config.max_batch}"
            )
        self.metrics = metrics or ServerMetrics()
        adm = engine.config.admission
        self.admission = admission or AdmissionPolicy(
            max_queue_depth=adm.queue_depth,
            shed_policy=adm.shed_policy,
            deadline_ms=adm.deadline_ms,
        )
        self._controller = AdmissionController(self.admission, self.metrics)
        self.queue = RequestQueue(self._controller)
        self.warmup_on_start = warmup_on_start
        self._thread: threading.Thread | None = None
        #: Adaptive beam-tier selector; built and calibrated by ``start()``
        #: when the engine has an SLO ladder, else None (always tier 0).
        self.tier_policy: Optional[BeamTierPolicy] = None
        # Serializes start()/stop(): stop() during start()'s warmup or
        # probes waits for them to finish (never closes the queue under a
        # half-measured bucket) and then sees the started thread to join.
        self._lifecycle = threading.Lock()

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "MicroBatcher":
        with self._lifecycle:
            if self._thread is not None:
                raise RuntimeError("MicroBatcher already started")
            if self.queue.closed:
                raise RuntimeError("MicroBatcher cannot be restarted after stop()")
            if self.warmup_on_start:
                self.engine.warmup_buckets(self.engine.tree.d, self.policy.max_batch)
            if len(self.engine.tiers) > 1:
                # Calibrate the ladder with the drain-rate probe auto queue
                # depth uses, one run per tier.
                self.tier_policy = BeamTierPolicy(
                    self.engine.tiers,
                    target_ms=float(self.engine.config.slo.target_p99_ms),
                    bucket=self.engine.bucket_for(self.policy.max_batch),
                ).calibrate(self._probe_cost_ms)
            if self.admission.max_queue_depth == "auto":
                self.admission.max_queue_depth = self._auto_queue_depth()
            self._thread = threading.Thread(
                target=self._worker, name="xmr-microbatcher", daemon=True
            )
            self._thread.start()
        return self

    def _probe_cost_ms(self, tier: int = 0) -> float:
        """Measured wall ms to serve one full coalescing bucket at ``tier``:
        ``queue_depth="auto"`` divides the bucket by it, and the
        :class:`~repro_torch.serving.slo.BeamTierPolicy` runs it per tier."""
        return 1e3 * self.engine.measure_batch_seconds(self.policy.max_batch, tier=tier)

    def _auto_queue_depth(self) -> int:
        """Capacity-aware admission bound: measured drain rate x deadline.

        The queue holds no more than the device can clear within the
        latency budget: the policy deadline when one is set, else ten
        deadline-trigger windows. Never below ``max_batch``, so that a full
        bucket can always form.
        """
        secs = 1e-3 * self._probe_cost_ms()
        bucket = self.engine.bucket_for(self.policy.max_batch)
        drain_qps = bucket / max(secs, 1e-9)
        budget_ms = self.admission.deadline_ms
        if budget_ms is None:
            budget_ms = 10.0 * self.policy.max_wait_ms
        return max(self.policy.max_batch, int(np.ceil(drain_qps * budget_ms * 1e-3)))

    def stop(self) -> None:
        """Stop accepting requests, drain the queue, join the worker.

        Safe to call concurrently with :meth:`start`: the lifecycle lock
        makes stop wait for start's warmup and probes, so the queue never
        closes under a probe and the started worker is always joined.
        """
        with self._lifecycle:
            self.queue.close()
            if self._thread is not None:
                self._thread.join()
                self._thread = None

    def __enter__(self) -> "MicroBatcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client API ---------------------------------------------------------
    def submit(
        self,
        idx: Union[np.ndarray, Query],
        val: Optional[np.ndarray] = None,
        *,
        deadline_ms: Optional[float] = None,
        priority: int = 0,
    ) -> Future:
        """Enqueue one sparse query.

        Two call forms:

        * ``submit(Query(...))`` — the v1 form. Resolves to a
          :class:`~repro_torch.serving.api.QueryResult` and **never
          raises**: shed, expired or failed requests come back with the
          typed failure in ``result.status`` (and the exception on
          ``result.error``), plus end-to-end wall time in
          ``result.timing["e2e_ms"]``.
        * ``submit(idx, val)`` — the legacy form. Resolves to a
          ``(scores [k], labels [k])`` tuple; failures resolve the future
          with the typed exception (``future.result()`` raises).

        Always returns a Future: a request shed by admission control comes
        back already resolved. ``deadline_ms`` overrides the policy's
        default per-request deadline; ``priority`` (higher = more
        important) steers weighted shedding under ``shed-oldest``.
        """
        if isinstance(idx, Query):
            if val is not None:
                raise TypeError("submit(Query) takes no positional val")
            q = idx
            t0 = time.perf_counter()
            inner = self._submit_arrays(
                q.idx, q.val,
                deadline_ms=q.deadline_ms if deadline_ms is None else deadline_ms,
                priority=q.priority or priority,
            )
            out: Future = Future()

            def _wrap(f: Future, qid: int = q.qid) -> None:
                timing = {"e2e_ms": 1e3 * (time.perf_counter() - t0)}
                exc = f.exception()
                if exc is not None:
                    out.set_result(QueryResult.from_error(qid, exc, timing))
                else:
                    s, l = f.result()
                    info = getattr(f, "degraded_info", None)
                    out.set_result(QueryResult(
                        qid=qid, ids=l, scores=s, timing=timing,
                        degraded=info is not None,
                        missing_labels=list(info["label_ranges"]) if info else [],
                        beam_tier=getattr(f, "beam_tier", 0),
                    ))

            inner.add_done_callback(_wrap)
            return out
        return self._submit_arrays(idx, val, deadline_ms=deadline_ms, priority=priority)

    def _submit_arrays(
        self,
        idx: np.ndarray,
        val: np.ndarray,
        *,
        deadline_ms: Optional[float],
        priority: int,
    ) -> Future:
        self.metrics.record_offered()
        t_enqueue = time.perf_counter()
        req = _Request(
            idx=np.asarray(idx, np.int32),
            val=np.asarray(val, np.float32),
            future=Future(),
            t_enqueue=t_enqueue,
            t_deadline=t_enqueue + 1e-3 * deadline_ms if deadline_ms is not None else None,
            priority=priority,
        )
        self._controller.stamp_deadline(req)
        self.queue.put(req)
        return req.future

    def submit_csr(self, queries: CSR) -> List[Future]:
        return [self.submit(*queries.row(i)) for i in range(queries.shape[0])]

    def stream(
        self,
        queries: Union[CSR, Iterable[Tuple[np.ndarray, np.ndarray]]],
        *,
        deadline_ms: Optional[float] = None,
    ) -> Iterator[QueryResult]:
        """Submit all queries, yield :class:`QueryResult` in completion order.

        Each result's ``qid`` is its submission index. Shed or expired
        requests surface at once as error-status results (``result.ok``
        False, ``result.error`` the typed exception) instead of blocking
        the stream behind slower successes.
        """
        if isinstance(queries, CSR):
            pairs = (queries.row(i) for i in range(queries.shape[0]))
        else:
            pairs = iter(queries)
        done: queue_mod.Queue = queue_mod.Queue()
        n = 0
        for i, (idx, val) in enumerate(pairs):
            fut = self.submit(Query(idx=idx, val=val, qid=i, deadline_ms=deadline_ms))
            fut.add_done_callback(lambda f: done.put(f))
            n += 1
        for _ in range(n):
            yield done.get().result()

    # -- worker -------------------------------------------------------------
    def _select_tier(self, reqs: List[_Request], t_dequeue: float) -> int:
        """Beam tier for a batch formed now (0 without an SLO ladder).

        The budget is the SLO target minus the oldest request's queue wait,
        tightened by the earliest per-request deadline when any is set.
        """
        if self.tier_policy is None:
            return 0
        budget = self.tier_policy.target_ms - 1e3 * (
            t_dequeue - min(r.t_enqueue for r in reqs)
        )
        deadlines = [r.t_deadline for r in reqs if r.t_deadline is not None]
        if deadlines:
            budget = min(budget, 1e3 * (min(deadlines) - t_dequeue))
        return self.tier_policy.select(queue_depth=len(self.queue), budget_ms=budget)

    def _dispatch(self, reqs: List[_Request], trigger: str) -> _InFlight:
        t_dequeue = time.perf_counter()
        tier = self._select_tier(reqs, t_dequeue)
        d = self.engine.tree.d
        sub = CSR.from_rows([r.idx for r in reqs], [r.val for r in reqs], (len(reqs), d))
        bucket = self.engine.bucket_for(len(reqs))
        xi, xv = self.engine.marshal_rows(sub, np.arange(len(reqs)), bucket)
        # Enqueued with the copies back and an event behind them: no wait here.
        s, l, done = self.engine._run_to_host(xi, xv, len(reqs), tier=tier)
        return _InFlight(
            reqs, s, l, done, t_dequeue, bucket, trigger,
            degraded=self.engine.last_degraded(),
            tier=tier,
        )

    def _try_dispatch(self, reqs: List[_Request], trigger: str) -> Optional[_InFlight]:
        """Expire dead requests, dispatch the survivors, fail on error.

        Deadlines are checked here, at dispatch, so that an expired request
        never reaches the device; returns None when the whole batch expired.
        """
        live = self._controller.expire(reqs)
        if not live:
            return None
        try:
            return self._dispatch(live, trigger)
        except Exception as exc:  # noqa: BLE001 — fail the batch, keep serving
            self._fail(live, exc)
            return None

    def _finalize(self, inflight: _InFlight) -> None:
        t_wait = time.perf_counter()
        if inflight.done is not None:
            inflight.done.synchronize()  # this batch's copies, not the next batch
        t_done = time.perf_counter()
        partitioned = self.engine.planner is not None
        # Copies: results outlive the batch, and views would pin its host
        # buffers, which the next batch's copies could otherwise reuse.
        s = inflight.scores.numpy().copy()
        leaves = inflight.labels.numpy().copy()
        l = self.engine._map_labels(leaves)
        for i, req in enumerate(inflight.reqs):
            if inflight.degraded is not None:
                # Attribute channel to the v1 wrapper: set before set_result,
                # because done-callbacks fire synchronously.
                req.future.degraded_info = inflight.degraded
            if inflight.tier:
                req.future.beam_tier = inflight.tier
            req.future.set_result((s[i], l[i]))
        if inflight.degraded is not None:
            self.metrics.record_degraded(len(inflight.reqs))
        self.metrics.record_batch(
            t_enqueue=[r.t_enqueue for r in inflight.reqs],
            t_dequeue=inflight.t_dequeue,
            t_done=t_done,
            bucket=inflight.bucket,
            trigger=inflight.trigger,
            shards=self.engine.config.shards,
            partition_hits=self.engine.partition_hit_counts(leaves),
            stall_ms=1e3 * (t_done - t_wait) if partitioned else None,
            cache_stats=self.engine.beam_cache_stats(),
            tier=inflight.tier,
        )

    def _fail(self, reqs: List[_Request], exc: BaseException) -> None:
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(exc)

    def _poll_ready(
        self, pending: _InFlight, wait_s: float
    ) -> Tuple[Optional[List[_Request]], str]:
        """Wait for a trigger OR the in-flight results, whichever first.

        Returns a formed batch (trigger fired, or closed-flush) the moment
        it is ready, so that it is dispatched *before* the worker waits for
        ``pending``. Returns ``([], "")`` once ``pending``'s results are on
        the host with no trigger fired.
        """
        p = self.policy
        while True:
            reqs, trigger = self.queue.next_batch(p.max_batch, wait_s, block=False)
            if reqs is None or reqs:
                return reqs, trigger
            if _device_ready(pending):
                return [], ""
            time.sleep(_POLL_S)

    def _worker(self) -> None:
        p = self.policy
        wait_s = 1e-3 * p.max_wait_ms
        pending: _InFlight | None = None
        while True:
            if pending is None:
                reqs, trigger = self.queue.next_batch(p.max_batch, wait_s)
                if reqs is None:
                    break
                pending = self._try_dispatch(reqs, trigger)
            else:
                reqs, trigger = self._poll_ready(pending, wait_s)
                # Double buffer: the ready batch goes on the device first;
                # only then wait for the previous batch's results.
                nxt = self._try_dispatch(reqs, trigger) if reqs else None
                try:
                    self._finalize(pending)
                except Exception as exc:  # noqa: BLE001 — fail the batch, keep serving
                    self._fail(pending.reqs, exc)
                pending = nxt
        if pending is not None:
            try:
                self._finalize(pending)
            except Exception as exc:  # noqa: BLE001 — fail the batch, keep serving
                self._fail(pending.reqs, exc)
