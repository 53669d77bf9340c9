"""Arithmetic shared by the metric readers in ``metrics/``. Each reader
takes the run's :class:`~xmrbench.harness.Record` and returns a number, or
None where the run has nothing to read. Only the set-up time is read off a
run that is not on the chip."""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

from xmrbench import hw

#: The port's MSCM kernels, by the names the profiler gives them.
MSCM_KERNEL = re.compile(r"\bmscm_\w*kernel")


def rate(rec, mode: str) -> Optional[float]:
    """Queries completed in the window over its seconds."""
    if rec.mode != mode or not rec.on_chip or not rec.window_s:
        return None
    return rec.served / rec.window_s


def latency_ms(rec, mode: str, q: float) -> Optional[float]:
    """The ``q``-th percentile of the window's client-timed calls, in ms."""
    if rec.mode != mode or not rec.on_chip or not rec.latencies_s:
        return None
    return float(np.percentile(np.asarray(rec.latencies_s), q)) * 1e3


def mfu(rec, mode: str) -> Optional[float]:
    """The window's work at the chip's peaks over the window's time, in %."""
    if rec.mode != mode or not rec.on_chip or not rec.window_s:
        return None
    return 100.0 * hw.least_seconds(rec.work.flops, rec.work.nbytes) / rec.window_s


def _traced(rec, mode: str):
    t = rec.trace
    if rec.mode != mode or not rec.on_chip or t is None or not t.activities:
        return None
    return t


def kernel_roofline(rec, mode: str) -> Optional[float]:
    """The MSCM kernels' counted work at the peaks over their device time, in %."""
    t = _traced(rec, mode)
    if t is None:
        return None
    secs = t.seconds_matching(lambda name: MSCM_KERNEL.search(name) is not None)
    if not secs:
        return None
    w = rec.traced_work
    return 100.0 * hw.least_seconds(w.flops, w.kernel_bytes) / secs


def idle_share(rec, mode: str) -> Optional[float]:
    """The traced window's share with no device activity, in %."""
    t = _traced(rec, mode)
    if t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def activities_per_query(rec, mode: str) -> Optional[float]:
    """Device activities (kernels, copies, memsets) in the traced window
    over the queries it served."""
    t = _traced(rec, mode)
    if t is None or not rec.traced_queries:
        return None
    return t.activities / rec.traced_queries


def activities_per_call(rec, mode: str) -> Optional[float]:
    """Device activities in the traced window over the calls it made."""
    t = _traced(rec, mode)
    if t is None or not rec.traced_calls:
        return None
    return t.activities / rec.traced_calls
