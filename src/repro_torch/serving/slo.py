"""Latency-SLO adaptive inference: degrade beam width instead of shedding
(counterpart of ``repro.serving.slo``).

The overload tier (:mod:`repro_torch.serving.admission`) protects latency by
dropping whole queries. Baharav et al. (arXiv 2106.00730) formalize the
smoother knob label trees already have: beam width trades recall for
latency continuously, so a backlogged server can serve *every* query at a
narrower beam instead of serving most at full beam and shedding the rest.

This module is the policy half of that trade:

* :class:`BeamTier` — one rung of the ladder: a ``(beam, qt)`` pair. Tier 0
  is always the engine's configured full beam; deeper tiers are narrower.
  :func:`resolve_tiers` derives the ladder from :class:`~repro_torch.serving
  .config.SLOConfig` (explicit pairs, or beam-halving down to ``min_beam``).
* :class:`BeamTierPolicy` — the dispatch-time selector the
  :class:`~repro_torch.serving.batcher.MicroBatcher` consults per formed
  batch. It is calibrated once at startup with the same drain-rate probe
  that backs ``queue_depth="auto"`` (``XMRServingEngine
  .measure_batch_seconds``, run once per tier, which also runs each tier's
  kernels once before live traffic can pick it), then picks the *fullest*
  tier whose measured batch cost, multiplied by the batches already queued
  ahead, fits the batch's remaining deadline budget.

The tier set is a bounded static ladder fixed at engine build (every
``(bucket, tier)`` pair is warmed up front), and tier 0 stays bitwise
identical to a server without an SLO configured.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

__all__ = ["BeamTier", "BeamTierPolicy", "resolve_tiers"]


@dataclasses.dataclass(frozen=True)
class BeamTier:
    """One rung of the adaptive ladder: the static args it dispatches with."""

    beam: int
    qt: int


def resolve_tiers(config) -> Tuple[BeamTier, ...]:
    """The engine's tier ladder for a :class:`~repro_torch.serving.config
    .ServeConfig` — ``(full, degraded...)``, full first.

    With the SLO disabled (``slo.target_p99_ms is None``) the ladder is just
    the full tier: nothing anywhere in the serving path can pick a degraded
    beam, so behavior is identical to a config without the group. Explicit
    ``slo.tiers`` pairs are validated against the full beam; the auto ladder
    halves the beam down to ``slo.min_beam``.
    """
    full = BeamTier(int(config.beam), int(config.qt))
    slo = config.slo
    if slo.target_p99_ms is None:
        return (full,)
    if slo.tiers:
        ladder = [BeamTier(int(b), int(q)) for b, q in slo.tiers]
        if ladder and ladder[0].beam >= full.beam:
            raise ValueError(
                f"degraded tier beam {ladder[0].beam} must be narrower "
                f"than the configured full beam {full.beam}"
            )
    else:
        ladder, b = [], full.beam // 2
        while b >= max(slo.min_beam, 1):
            ladder.append(BeamTier(b, full.qt))
            b //= 2
    return (full, *ladder)


class BeamTierPolicy:
    """Dispatch-time beam-tier selection from queue depth + deadline budget.

    The cost model is measured, not assumed: :meth:`calibrate` probes one
    full-bucket dispatch per tier (median of a few warmed runs — the same
    probe ``queue_depth="auto"`` uses to bound admission) so the selector
    works in the same units as the SLO. :meth:`select` then answers, per
    formed batch: *given how many batches are queued ahead of this one,
    what is the fullest beam the device can afford and still clear the
    backlog inside this batch's remaining budget?*
    """

    def __init__(
        self,
        tiers: Sequence[BeamTier],
        *,
        target_ms: float,
        bucket: int,
    ) -> None:
        if not tiers:
            raise ValueError("a BeamTierPolicy needs at least one tier")
        if target_ms <= 0:
            raise ValueError(f"target_ms must be positive; got {target_ms}")
        if bucket < 1:
            raise ValueError(f"bucket must be >= 1; got {bucket}")
        self.tiers: Tuple[BeamTier, ...] = tuple(tiers)
        self.target_ms = float(target_ms)
        self.bucket = int(bucket)
        #: Measured full-bucket dispatch cost per tier (ms), monotone
        #: non-increasing in tier index after calibration.
        self.cost_ms: Optional[List[float]] = None

    @property
    def n_tiers(self) -> int:
        return len(self.tiers)

    @property
    def calibrated(self) -> bool:
        return self.cost_ms is not None

    def calibrate(self, probe_cost_ms) -> "BeamTierPolicy":
        """Measure per-tier batch cost via ``probe_cost_ms(tier) -> ms``.

        The probe is the engine's warmed drain-rate measurement; running it
        per tier also warms each tier's coalescing bucket, so the first
        degraded dispatch under live overload never builds a kernel.
        A narrower beam can't honestly cost more than a wider one — probe
        jitter on shared hardware can still measure it that way, so costs
        are clamped monotone; the policy must never prefer a *narrower*
        beam while claiming the same latency.
        """
        costs: List[float] = []
        for k in range(len(self.tiers)):
            c = float(probe_cost_ms(k))
            if costs:
                c = min(c, costs[-1])
            costs.append(c)
        self.cost_ms = costs
        return self

    def select(self, *, queue_depth: int, budget_ms: Optional[float]) -> int:
        """Tier index for a batch dispatched now.

        ``queue_depth`` is the number of requests still queued *behind*
        this batch; ``budget_ms`` the batch's remaining deadline budget
        (``None`` = only the SLO target applies). The chosen tier is the
        fullest whose cost times the backlog's batch count fits the
        budget; if none fits, the deepest tier — degrade, don't shed.
        """
        if self.cost_ms is None:
            return 0
        budget = self.target_ms if budget_ms is None else min(
            self.target_ms, float(budget_ms)
        )
        backlog_batches = 1 + math.ceil(max(queue_depth, 0) / self.bucket)
        for k, cost in enumerate(self.cost_ms):
            if cost * backlog_batches <= budget:
                return k
        return len(self.tiers) - 1
