"""Admission control for the micro-batching server (counterpart of
``repro.serving.admission``, copied: the port imports nothing of ``repro``).

Under sustained overload an unbounded request queue converts every incoming
query into latency: the queue grows without bound, every request eventually
completes, and P99 is whatever backlog happened to accumulate — the classic
open-loop failure mode. Production XMR serving (the traffic regime of the
paper's §6 enterprise deployment) instead *sheds* load at a bounded queue
depth so the requests it does serve stay within their latency budget.

This module provides the pieces the batcher wires in:

* :class:`Overloaded` / :class:`DeadlineExceeded` — typed errors a shed or
  expired request's future resolves with (clients can distinguish "retry
  elsewhere" from a real failure).
* :class:`AdmissionPolicy` — queue-depth bound, shed policy, and the default
  per-request deadline.
* :class:`AdmissionController` — applies the policy at enqueue time (under
  the queue lock, so depth checks are race-free) and expires requests at
  dispatch time so a query past its deadline never burns device time.

Shed policies:

``reject``
    The *new* request is refused: its future resolves with
    :class:`Overloaded` and the queue is untouched. Favors requests already
    waiting (FIFO fairness under overload).
``shed-oldest``
    The oldest *queued* request is dropped and the new one admitted. Favors
    freshness: under overload the oldest request is the most likely to blow
    its deadline anyway, so shedding it wastes the least useful work.

    With **priority classes** (``MicroBatcher.submit(priority=...)``, higher
    = more important) the victim is the oldest request of the *lowest*
    priority present — weighted shedding: background traffic is sacrificed
    first, and a low-priority arrival at a queue full of higher-priority
    work is itself refused rather than displacing it.

``max_queue_depth="auto"``
    Resolved by ``MicroBatcher.start()`` from the measured drain rate times
    the deadline budget (see :meth:`MicroBatcher._auto_queue_depth`): the
    queue holds no more work than the device can clear within a request's
    latency budget. Until resolved (a batcher that never started), the
    bound is inactive.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Deque, List, Optional, Union

if TYPE_CHECKING:  # circular at runtime: batcher/metrics import this module
    from repro_torch.serving.batcher import _Request
    from repro_torch.serving.metrics import ServerMetrics

SHED_REJECT = "reject"
SHED_OLDEST = "shed-oldest"
SHED_POLICIES = (SHED_REJECT, SHED_OLDEST)


class ServingError(RuntimeError):
    """Base class for typed serving-tier request failures."""


class Overloaded(ServingError):
    """Request shed by admission control (bounded queue was full)."""

    def __init__(self, queue_depth: int, policy: str):
        super().__init__(
            f"request shed: queue depth bound {queue_depth} reached "
            f"(policy={policy!r})"
        )
        self.queue_depth = queue_depth
        self.policy = policy


class DeadlineExceeded(ServingError):
    """Request expired before dispatch; no device time was spent on it."""

    def __init__(self, waited_ms: float, deadline_ms: float):
        super().__init__(
            f"request deadline exceeded before dispatch: waited "
            f"{waited_ms:.2f} ms > {deadline_ms:.2f} ms budget"
        )
        self.waited_ms = waited_ms
        self.deadline_ms = deadline_ms


class WorkerUnavailable(ServingError):
    """A fleet partition worker died or timed out mid-request.

    Raised by the fleet's RPC layer (:mod:`repro_torch.serving.fleet.rpc`)
    when a partition process is unreachable — connection refused/reset,
    EOF, a corrupt frame, or a per-call timeout. The
    batcher fails the in-flight batch's futures with it (never hangs), and
    the gateway maps it to HTTP 503: the request *may* be retried once the
    fleet is repaired, unlike a 4xx.
    """

    def __init__(self, worker: str, op: str, cause: str):
        super().__init__(
            f"fleet worker {worker} unavailable during {op!r}: {cause}"
        )
        self.worker = worker
        self.op = op
        self.cause = cause


@dataclasses.dataclass
class AdmissionPolicy:
    """Overload policy for a :class:`~repro_torch.serving.batcher.MicroBatcher`.

    ``max_queue_depth=None`` disables the bound (the pre-admission-control
    behavior); ``"auto"`` defers it to the batcher's capacity probe at
    ``start()``; ``deadline_ms=None`` disables per-request deadlines.
    """

    max_queue_depth: Union[int, str, None] = None
    shed_policy: str = SHED_REJECT
    deadline_ms: Optional[float] = None

    def __post_init__(self) -> None:
        if self.shed_policy not in SHED_POLICIES:
            raise ValueError(
                f"shed_policy={self.shed_policy!r}; choose from {SHED_POLICIES}"
            )
        if isinstance(self.max_queue_depth, str):
            if self.max_queue_depth != "auto":
                raise ValueError(
                    f"max_queue_depth={self.max_queue_depth!r}; the only "
                    'string value is "auto"'
                )
        elif self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError('max_queue_depth must be >= 1, None, or "auto"')


class AdmissionController:
    """Applies an :class:`AdmissionPolicy` at the queue boundary.

    ``admit`` runs under the request-queue lock (depth check and shed are
    atomic with the append); ``expire`` runs on the worker thread at batch
    dispatch. Both resolve futures with typed errors and record into
    ``metrics`` — neither ever raises into the caller.
    """

    def __init__(self, policy: AdmissionPolicy, metrics: "ServerMetrics") -> None:
        self.policy = policy
        self.metrics = metrics

    def stamp_deadline(self, req: "_Request") -> None:
        """Attach the policy's default deadline to a request lacking one."""
        if req.t_deadline is None and self.policy.deadline_ms is not None:
            req.t_deadline = req.t_enqueue + 1e-3 * self.policy.deadline_ms

    def admit(self, queue: "Deque[_Request]", req: "_Request") -> bool:
        """Decide admission for ``req`` against the live deque ``queue``.

        Returns True if ``req`` should be appended. On shed, the victim's
        future (the new request under ``reject``, the oldest lowest-priority
        queued request under ``shed-oldest``) resolves with
        :class:`Overloaded`. ``"auto"`` depth is inactive until the batcher
        resolves it at ``start()``.
        """
        depth = self.policy.max_queue_depth
        if depth is None or depth == "auto" or len(queue) < depth:
            return True
        prio = getattr(req, "priority", 0)
        if self.policy.shed_policy == SHED_OLDEST:
            # Weighted shed-oldest: victim = oldest request of the lowest
            # priority present — unless everything queued outranks the new
            # arrival, in which case the arrival itself is refused.
            floor = min(getattr(r, "priority", 0) for r in queue)
            if floor <= prio:
                vi = next(
                    i for i, r in enumerate(queue)
                    if getattr(r, "priority", 0) == floor
                )
                victim = queue[vi]
                del queue[vi]  # not .remove(): dataclass eq on array fields
                victim.future.set_exception(Overloaded(depth, SHED_OLDEST))
                self.metrics.record_shed(getattr(victim, "priority", 0))
                return True
        req.future.set_exception(Overloaded(depth, self.policy.shed_policy))
        self.metrics.record_shed(prio)
        return False

    def expire(
        self, reqs: "List[_Request]", now: Optional[float] = None
    ) -> "List[_Request]":
        """Split a formed batch into live requests, failing expired ones.

        Called at dispatch time so an expired request never reaches the
        device. Returns the surviving (still-live) requests in order.
        """
        if now is None:
            now = time.perf_counter()
        live: "List[_Request]" = []
        for r in reqs:
            if r.t_deadline is not None and now >= r.t_deadline:
                waited = 1e3 * (now - r.t_enqueue)
                budget = 1e3 * (r.t_deadline - r.t_enqueue)
                r.future.set_exception(DeadlineExceeded(waited, budget))
                self.metrics.record_deadline_miss()
            else:
                live.append(r)
        return live
