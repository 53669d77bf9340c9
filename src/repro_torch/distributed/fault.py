"""Fault tolerance: step watchdog, straggler stats, retrying runner, elastic
device counts.

Counterpart of ``repro.distributed.fault``, plain Python as there. The
failure modes it covers: (a) hard loss of a device or node, handled by
checkpoint and auto-resume, possibly on another device count (the checkpoint
format is independent of the mesh); (b) transient step failures, handled by
the retrying runner; (c) stragglers, detected by the watchdog from the
distribution of step times, where persistent straggling recommends a re-mesh.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, List, Optional

import numpy as np

log = logging.getLogger("repro_torch.fault")


@dataclasses.dataclass
class StepWatchdog:
    """Tracks step durations; flags stragglers above k× the running median."""

    straggler_factor: float = 2.0
    window: int = 64
    durations: List[float] = dataclasses.field(default_factory=list)
    stragglers: List[int] = dataclasses.field(default_factory=list)
    _t0: Optional[float] = None
    _step: int = 0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.durations.append(dt)
        hist = self.durations[-self.window :]
        med = float(np.median(hist))
        if len(hist) >= 8 and dt > self.straggler_factor * med:
            self.stragglers.append(self._step)
            log.warning(
                "straggler step %d: %.3fs vs median %.3fs (x%.1f)",
                self._step, dt, med, dt / med,
            )
        self._step += 1
        return dt

    def should_remesh(self, patience: int = 5) -> bool:
        """Persistent straggling in the recent window => recommend re-mesh."""
        recent = [s for s in self.stragglers if s >= self._step - self.window]
        return len(recent) >= patience

    def summary(self) -> dict:
        if not self.durations:
            return {}
        arr = np.asarray(self.durations)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p99_s": float(np.percentile(arr, 99)),
            "stragglers": len(self.stragglers),
        }


class TransientError(RuntimeError):
    """Raised by tests / injected failures to exercise the retry path."""


def run_with_retries(
    step_fn: Callable[[], None],
    *,
    max_retries: int = 3,
    on_retry: Optional[Callable[[int, Exception], None]] = None,
) -> None:
    """Run one training step with bounded retries (transient-failure path).

    ``on_retry(attempt, err)`` is the hook where the caller restores from the
    last checkpoint / rebuilds device state before retrying.
    """
    for attempt in range(max_retries + 1):
        try:
            step_fn()
            return
        except TransientError as e:
            if attempt == max_retries:
                raise
            log.warning("transient failure (attempt %d): %s — retrying", attempt, e)
            if on_retry is not None:
                on_retry(attempt, e)


def elastic_device_counts(n_total: int, model_parallel: int) -> List[int]:
    """Valid shrunk device counts when nodes are lost: multiples of the TP
    group size, largest first. The mesh-independent checkpoint restores onto
    any of these (data-parallel dimension shrinks)."""
    out = []
    n = (n_total // model_parallel) * model_parallel
    while n >= model_parallel:
        out.append(n)
        n -= model_parallel
    return out
