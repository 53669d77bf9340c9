"""Per-layer metrics read off the program's own spans (``repro_torch.obs``).

The program records its spans while a ``torch.profiler`` session records, so
a traced run's two traced windows fill its buffer: first the calls traced on
the device alone, whose device trace ``rec.trace`` holds, then the
breakdown's calls, traced on the host too, whose host runs several times
slower. A reader reads the first: the newest engine's first root spans of
the run's mode (``serve.batch`` or ``serve.online``), until their
``queries`` sum to ``rec.traced_queries``, and every span of those calls.
It returns None off the chip, where the mode differs, where the program
records no spans (it has no ``obs``), and where it finds no span to read.
"""

from __future__ import annotations

from typing import List, Optional, Sequence


def select(spans: Sequence, mode: str, queries: int) -> Optional[List]:
    """The spans of the newest engine's first ``serve.<mode>`` calls, in the
    order given, whose queries sum to ``queries``; None where they do not."""
    roots = [s for s in spans if s.parent is None and s.name == f"serve.{mode}"]
    if not roots or queries <= 0:
        return None
    newest = max(s.attrs["engine"] for s in roots)
    calls, n = set(), 0
    for s in sorted(roots, key=lambda s: s.sid):
        if s.attrs["engine"] != newest:
            continue
        if n >= queries:
            break
        calls.add(s.sid)
        n += s.attrs["queries"]
    if n != queries:
        return None
    return [s for s in spans if s.call in calls]


def host_ms(spans: Sequence, names: Sequence[str], queries: int) -> Optional[float]:
    """Host time of the spans named ``names`` over ``queries``, in ms."""
    picked = [s for s in spans if s.name in names]
    if not picked:
        return None
    return sum(s.host_ms for s in picked) / queries


def device_ms(spans: Sequence, names: Sequence[str], queries: int) -> Optional[float]:
    """Device intervals of the spans named ``names`` over ``queries``, in ms."""
    picked = [s for s in spans if s.name in names]
    if not picked or any(s.device_ms is None for s in picked):
        return None
    return sum(s.device_ms for s in picked) / queries


def _traced(rec, mode: str) -> Optional[List]:
    """The spans of the calls traced on the device alone, or None."""
    if rec.mode != mode or not rec.on_chip or not rec.traced_queries:
        return None
    try:
        from repro_torch import obs
    except ImportError:  # a program without spans
        return None
    buffered = obs.spans()
    picked = select(buffered, mode, rec.traced_queries)
    if picked is None:
        return None
    # The full buffer lets the oldest spans go first, children before their
    # root: only the call of the oldest span kept can have lost some.
    if obs.dropped() and any(s.call == buffered[0].call for s in picked):
        return None
    return picked


def host(rec, mode: str, *names: str) -> Optional[float]:
    picked = _traced(rec, mode)
    return None if picked is None else host_ms(picked, names, rec.traced_queries)


def device(rec, mode: str, *names: str) -> Optional[float]:
    picked = _traced(rec, mode)
    return None if picked is None else device_ms(picked, names, rec.traced_queries)
