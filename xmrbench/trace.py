"""Reading a ``torch.profiler`` trace of a traced window.

The window is the span of the ``xmrbench.traced_window`` annotation where
the trace holds host operations; in a trace of the device alone, the span
from its first activity's start to its last one's end. From the device's
activities inside it (kernels, copies, memsets; not the annotations the
profiler copies onto the device's timeline) this reads the busy time (the
union of their intervals), their count, device time by name, and the idle
gaps between them, each named by the innermost host operation running at
its midpoint where the trace holds host operations.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Tuple

WINDOW = "xmrbench.traced_window"
NO_OP = "host: no profiled op"
TOP = 10


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    activities: int
    time_by_name: Dict[str, float]   # device seconds by activity name
    gaps_by_host: Dict[str, float]   # idle seconds by the host op around them

    def seconds_matching(self, pred) -> float:
        return sum(s for name, s in self.time_by_name.items() if pred(name))

    def breakdown(self) -> dict:
        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.time_by_name), "idle_gaps": top(self.gaps_by_host)}


def _innermost(host: List[Tuple[float, float, str]], points: List[float]) -> List[str]:
    """For each of the sorted ``points``, the name of the shortest host
    interval that contains it (one thread's ops nest)."""
    host = sorted(host, key=lambda e: (e[0], -e[1]))
    out, stack, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else NO_OP)
    return out


def _events(prof):
    """``(name, device type, start us, end us, thread, is annotation)`` of
    each event, read off the profiler's raw results (building its
    ``FunctionEvent`` tree takes seconds for a window's events)."""
    for e in prof.profiler.kineto_results.events():
        if getattr(e, "is_hidden_event", lambda: False)():
            continue
        start = e.start_ns() / 1e3
        yield (e.name(), e.device_type(), start, start + e.duration_ns() / 1e3,
               e.start_thread_id(), e.is_user_annotation())


def read(prof) -> DeviceTrace:
    """The traced window's numbers from a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    events = list(_events(prof))
    device = [e for e in events if e[1] == DeviceType.CUDA and e[0] != WINDOW and not e[5]]
    windows = [e for e in events if e[0] == WINDOW and e[1] == DeviceType.CPU]
    span = windows or device
    if not span:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span and no device activity")
    w0, w1 = min(e[2] for e in span), max(e[3] for e in span)
    dev = [(max(s, w0), min(t, w1), name) for name, _, s, t, _, _ in device
           if w0 <= t and s <= w1]
    host = []
    if windows:
        thread = windows[0][4]
        host = [(s, t, name) for name, kind, s, t, th, _ in events
                if kind == DeviceType.CPU and th == thread and name != WINDOW
                and w0 <= t and s <= w1]
    dev.sort()
    by_name: Dict[str, float] = collections.defaultdict(float)
    busy = 0.0
    gaps: List[Tuple[float, float]] = []
    cur_s = cur_t = None
    for s, t, name in dev:
        by_name[name] += (t - s) * 1e-6
        if cur_t is None or s > cur_t:
            if cur_t is not None:
                busy += cur_t - cur_s
                gaps.append((cur_t, s))
            elif s > w0:
                gaps.append((w0, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
    if cur_t is not None:
        busy += cur_t - cur_s
        if cur_t < w1:
            gaps.append((cur_t, w1))
    mids = [(a + b) / 2 for a, b in gaps]
    names = _innermost(host, mids)
    gap_by: Dict[str, float] = collections.defaultdict(float)
    for (a, b), name in zip(gaps, names):
        gap_by[name] += (b - a) * 1e-6
    return DeviceTrace(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6, activities=len(dev),
                       time_by_name=dict(by_name), gaps_by_host=dict(gap_by))

