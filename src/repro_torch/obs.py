"""Spans and counters of the port's serving path.

A span (:func:`span`) marks one stage of a call: its name, its start and end,
the span it ran inside, the call it belongs to (the id of its root span), its
attributes, and what :func:`count` counted while it was the innermost open
span of its thread. Spans are recorded only while tracing is on, which is

* while a ``torch.profiler`` session records: each span is then also a
  ``record_function`` range of the same name, so the program's stages lie in
  the trace's host timeline (a session that records host activity shows
  them; one of the device alone shows none); or
* inside :func:`recording`, which records spans without the profiler.

Off, :func:`span` checks two flags and hands back one shared object that does
nothing: it reads no clock and allocates nothing.

Timestamps are nanoseconds on the profiler's clock, the epoch clock that
``time.time_ns()`` reads (torch 2.13 on the CPU; torch 2.11 with CUDA 12.8 on
an H100). A span reads it just outside its range, so the span encloses its
profiler event: a few microseconds each side, a few hundred before the first
range of a session.

A span given ``device=`` a CUDA device also records a pair of CUDA events on
that device's current stream, around the span. :func:`spans` resolves them to
milliseconds (``elapsed_time``) when it reads the buffer, after the work has
finished; nothing during the call synchronises. That device interval is the
stream's time from the span's first enqueued work to its last: device work
where the device runs behind the host, and the launch gaps inside the stage
as well where the host sets the pace.

A span inside the capture of a CUDA graph is entered once, when the graph is
recorded. Outside :func:`template` it holds no device interval. Inside it,
it goes to the template instead of the buffer, and its events are external
ones, recorded as nodes of the graph, so that every replay records them
again; :func:`replayed` then puts a copy of the template's spans in the
buffer for one replay, each with that replay's device interval.

The buffer holds the newest :data:`CAPACITY` spans; :func:`dropped` counts
those it let go. :func:`count` always adds to a process-wide total
(:func:`total`); the kernel wrappers count their launches with it, and the
serving engine its CUDA graphs' captures and replays. :func:`tally` collects
what one thread counts in a block: the engine re-counts a graph's launches,
as its capture counted them, at each replay.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Dict, Iterator, List

import torch
from torch.autograd import profiler as _profiler

#: Spans the buffer holds; the oldest go first.
CAPACITY = 1 << 16

#: The profiler's clock, in nanoseconds.
clock_ns = time.time_ns
#: A range of the profiler's host timeline: ``record_function``'s, entered
#: from C (``record_function`` itself dispatches an operator each way, which
#: cost 36 us a range under a CUDA-only session on the H100's host).
_Range = torch._C._profiler._RecordFunctionFast

_lock = threading.Lock()
_local = threading.local()
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_dropped = 0
_recording = 0
_templating = 0
_totals: Dict[str, int] = collections.defaultdict(int)
_ids = itertools.count(1)


class _Off:
    """The span handed back while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One span: the context manager :func:`span` hands back while tracing,
    then the record :func:`spans` reads. ``parent`` is the enclosing span's
    ``sid`` (None for a root); ``call`` is the root's ``sid``; ``device_ms``
    is the device interval of a span given a CUDA device, else None."""

    __slots__ = ("name", "attrs", "sid", "parent", "call", "counts", "start_ns", "end_ns",
                 "device_ms", "_device", "_range", "_events")

    def __init__(self, name: str, device, attrs: dict):
        self.name, self._device, self.attrs = name, device, attrs
        self.device_ms = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.sid = next(_ids)
        self.parent = None if up is None else up.sid
        self.call = self.sid if up is None else up.call
        self.counts = {}
        self.start_ns = clock_ns()
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _Range(self.name)
            self._range.__enter__()
        self._events = None
        if self._device is not None and self._device.type == "cuda":
            external = torch.cuda.is_current_stream_capturing()
            if not external or getattr(_local, "template", None) is not None:
                stream = torch.cuda.current_stream(self._device)
                start = torch.cuda.Event(enable_timing=True, external=external)
                start.record(stream)
                self._events = (start, torch.cuda.Event(enable_timing=True, external=external),
                                stream)
        stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        if self._events is not None:
            self._events[1].record(self._events[2])
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.end_ns = clock_ns()
        template = getattr(_local, "template", None)
        if template is not None:
            template.append(self)
            return False
        _keep(self)
        return False


def _keep(s: Span) -> None:
    global _dropped
    with _lock:
        if len(_buffer) == _buffer.maxlen:
            _dropped += 1
        _buffer.append(s)


def span(name: str, device: torch.device | None = None, **attrs):
    """A context manager marking one stage named ``name``; ``attrs`` are kept
    with it. ``device``: where a metric reads the stage's device time, the
    device its work runs on (events are recorded only on a CUDA device)."""
    if _profiler._is_profiler_enabled or _recording or _templating:
        return Span(name, device, attrs)
    return OFF


def tracing() -> bool:
    """Whether spans are being recorded (a profiler session, or
    :func:`recording`)."""
    return bool(_profiler._is_profiler_enabled or _recording)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process-wide total ``name`` and, while tracing, to the
    innermost open span of this thread."""
    with _lock:
        _totals[name] += n
    got = getattr(_local, "tally", None)
    if got is not None:
        got[name] = got.get(name, 0) + n
    if _profiler._is_profiler_enabled or _recording or _templating:
        stack = _stack()
        if stack:
            counts = stack[-1].counts
            counts[name] = counts.get(name, 0) + n


def total(name: str) -> int:
    """The counter ``name``'s process-wide total."""
    with _lock:
        return _totals.get(name, 0)


@contextlib.contextmanager
def tally() -> Iterator[Dict[str, int]]:
    """The counts this thread adds in this block, by name (they still go to
    the totals and the spans as well)."""
    outer = getattr(_local, "tally", None)
    _local.tally = got = {}
    try:
        yield got
    finally:
        _local.tally = outer
        if outer is not None:
            for name, n in got.items():
                outer[name] = outer.get(name, 0) + n


@contextlib.contextmanager
def recording() -> Iterator[None]:
    """Record spans in this block, on every thread, without the profiler."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


@contextlib.contextmanager
def template() -> Iterator[List[Span]]:
    """The spans this thread enters in this block, where it records a CUDA
    graph: they go to the list handed out (in the order they end), each with
    a pair of external events in the graph, and not to the buffer."""
    global _templating
    outer = getattr(_local, "template", None)
    _local.template = got = []
    with _lock:
        _templating += 1
    try:
        yield got
    finally:
        with _lock:
            _templating -= 1
        _local.template = outer


def replayed(spans: List[Span], start_ns: int) -> None:
    """While spans are recorded, put in the buffer the spans of one replay of
    the graph whose :func:`template` was ``spans``, replayed from
    ``start_ns`` until now: a copy of each, with a new ``sid``, inside the
    innermost open span of this thread (the template's outermost spans
    become its children), the counts the capture counted, that host
    interval, and the device interval of this replay's events. It waits for
    the replay, since the next one records over its events."""
    if not (_profiler._is_profiler_enabled or _recording):
        return
    stack = _stack()
    up = stack[-1] if stack else None
    end_ns = clock_ns()
    new: Dict[int, Span] = {}
    for t in sorted(spans, key=lambda s: s.sid):
        s = Span(t.name, None, t.attrs)
        s.sid = next(_ids)
        top = new.get(t.parent, up)
        s.parent = None if top is None else top.sid
        s.call = s.sid if top is None else top.call
        s.counts = dict(t.counts)
        s.start_ns, s.end_ns = start_ns, end_ns
        s._range = s._events = None
        if t._events is not None:
            start, end, _ = t._events
            end.synchronize()
            s.device_ms = start.elapsed_time(end)
        new[t.sid] = s
        _keep(s)


def spans() -> List[Span]:
    """The buffered spans, oldest first, their device intervals resolved
    (waiting for the work they enclose where it has not finished)."""
    with _lock:
        out = list(_buffer)
    for s in out:
        events, s._events = s._events, None
        if events is not None:
            start, end, _ = events
            end.synchronize()
            s.device_ms = start.elapsed_time(end)
    out.sort(key=lambda s: s.sid)
    return out


def dropped() -> int:
    """Spans the full buffer let go since the last :func:`clear`."""
    return _dropped


def clear() -> None:
    """Empty the buffer."""
    global _dropped
    with _lock:
        _buffer.clear()
        _dropped = 0
