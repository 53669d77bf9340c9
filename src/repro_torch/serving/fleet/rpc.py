"""Length-prefixed socket RPC for the partition fleet (counterpart of
``repro.serving.fleet.rpc``; the frames are byte for byte the reference's,
so a worker of either package answers a coordinator of the other).

One frame is::

    [8-byte big-endian frame length]
    [4-byte big-endian header length][JSON header]
    [raw array bytes, concatenated]

The header is a small JSON object (op name, metadata, and an ``"arrays"``
list of ``{"dtype", "shape"}`` descriptors); array payloads follow as raw
contiguous bytes in descriptor order. Frames carry host ``numpy`` arrays:
a caller moves device tensors to the host before it sends them. No pickle
on the wire (workers never deserialize executable state).

:func:`send_frame` writes a large frame buffer by buffer, and
:func:`recv_frame` reads the payload into one buffer: the same bytes as
:func:`encode_frame`'s joined image, without a second copy of a
partition's ``load`` frame (~0.7 GB at search-1m) on either side.

:class:`WorkerConnection` is the client side: per-call timeouts, and every
transport-level failure (refused/reset connection, EOF from a dead process,
a timeout, a corrupt frame) raises the typed
:class:`~repro_torch.serving.admission.WorkerUnavailable`, so callers get a
bounded, classifiable failure instead of a hang. Any such failure also
closes the socket: a failure mid-frame leaves the byte stream desynced, so
the connection must be re-established (:meth:`WorkerConnection.reconnect`)
before it can carry another call. A worker that *replied* with an
application error raises :class:`RemoteError` instead: the worker is alive
and the stream is intact, the request was bad.

The protocol is strict request→reply on one stream, so all socket use is
serialized through a per-connection :class:`threading.RLock`: ``call``
holds it across its send+recv pair, and fleet fan-outs hold it across a
whole exchange, so a concurrent health-check ping can never interleave its
frames with an in-flight beam exchange.

:class:`FaultInjector` is the deterministic chaos seam: a connection built
with (or assigned) one routes every ``send``/``recv`` through its rules, so
tests can drop, delay, truncate or corrupt frames, or kill a worker process
on exactly the Nth exchange, without races or wall-clock guesswork.
Production connections carry no injector and pay one ``is None`` check.
"""

from __future__ import annotations

import dataclasses
import json
import socket
import struct
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.admission import WorkerUnavailable

_LEN = struct.Struct(">Q")   # frame length
_HLEN = struct.Struct(">I")  # header length

#: Refuse frames beyond this (a corrupt length prefix must not OOM us).
#: Per-level beams are KiB; the largest legitimate frame is one partition's
#: sliced layers in ``load``, ~0.7 GB at search-1m.
MAX_FRAME_BYTES = 1 << 31
#: Frames up to this size are joined and sent in one call; larger ones (a
#: ``load``) go buffer by buffer, with no joined copy.
_JOIN_BYTES = 1 << 20


class RemoteError(RuntimeError):
    """The worker processed the call and replied with an error."""


# xmrlint: transport-primitive — bottom of the frame stack; callers hold the lock
def _recv_exact(sock: socket.socket, n: int) -> bytearray:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise EOFError(f"connection closed after {got}/{n} bytes")
        got += k
    return buf


def _frame_parts(header: dict, arrays: Sequence[np.ndarray]) -> List:
    """The frame as a list of buffers: prefixes, header, then each array's
    contiguous bytes (views, not copies)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    header = dict(header)
    header["arrays"] = [
        {"dtype": a.dtype.str, "shape": list(a.shape)} for a in arrays
    ]
    hbytes = json.dumps(header).encode()
    body = len(hbytes) + sum(a.nbytes for a in arrays)
    parts = [_LEN.pack(_HLEN.size + body) + _HLEN.pack(len(hbytes)) + hbytes]
    parts.extend(a.reshape(-1).view(np.uint8) for a in arrays if a.nbytes)
    return parts


def encode_frame(header: dict, arrays: Sequence[np.ndarray] = ()) -> bytes:
    """Serialize one frame to bytes: the exact wire image ``send_frame``
    writes, and the seam fault injection truncates and corrupts."""
    return b"".join(_frame_parts(header, arrays))


# xmrlint: transport-primitive — bottom of the frame stack; callers hold the lock
def send_frame(
    sock: socket.socket, header: dict, arrays: Sequence[np.ndarray] = ()
) -> None:
    parts = _frame_parts(header, arrays)
    if sum(len(p) for p in parts) <= _JOIN_BYTES:
        sock.sendall(b"".join(parts))  # one segment for a beam frame
        return
    for part in parts:
        sock.sendall(part)


# xmrlint: transport-primitive — bottom of the frame stack; callers hold the lock
def recv_frame(sock: socket.socket) -> Tuple[dict, List[np.ndarray]]:
    (total,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if total > MAX_FRAME_BYTES:
        raise ValueError(f"frame length {total} exceeds {MAX_FRAME_BYTES}")
    payload = _recv_exact(sock, total)
    (hlen,) = _HLEN.unpack(payload[: _HLEN.size])
    off = _HLEN.size + hlen
    header = json.loads(payload[_HLEN.size : off])
    arrays = []
    for desc in header.pop("arrays", []):
        dt = np.dtype(desc["dtype"])
        shape = tuple(desc["shape"])
        n_elem = int(np.prod(shape, dtype=np.int64))
        # A copy: aligned, owning its memory, and the payload freed after.
        arrays.append(
            np.frombuffer(payload, dt, count=n_elem, offset=off)
            .reshape(shape)
            .copy()
        )
        off += n_elem * dt.itemsize
    return header, arrays


#: Byte-level actions a send-phase rule may return (applied to the frame).
_FRAME_ACTIONS = ("drop", "truncate", "corrupt")


@dataclasses.dataclass
class FaultRule:
    """One deterministic fault: *action* on the *nth* matching call.

    ``action``:
      ``"drop"``      — swallow the frame (the peer never sees it; the
                        caller's recv times out).
      ``"truncate"``  — send half the encoded frame, then close the stream
                        (the peer EOFs mid-frame).
      ``"corrupt"``   — send the frame with an oversized length prefix (the
                        peer must reject it without crashing or OOMing).
      ``"delay"``     — sleep ``seconds`` before the call proceeds.
      ``"kill"``      — run ``callback`` (e.g. ``handle.kill``) before the
                        call proceeds: kill-on-Nth-exchange.

    ``phase`` picks the hook point (``"send"`` or ``"recv"``); ``op``
    restricts to one RPC op (``None`` = any); the rule fires on matching
    calls ``nth`` through ``nth + count - 1`` (1-based), so "kill on the
    3rd step" is ``FaultRule("kill", op="step", nth=3, callback=...)``.
    """

    action: str
    phase: str = "send"
    op: Optional[str] = None
    nth: int = 1
    count: int = 1
    seconds: float = 0.0
    callback: Optional[Callable[[], None]] = None
    matched: int = 0  # internal: matching calls seen so far

    def __post_init__(self) -> None:
        if self.action not in _FRAME_ACTIONS + ("delay", "kill"):
            raise ValueError(f"unknown fault action {self.action!r}")
        if self.phase not in ("send", "recv"):
            raise ValueError(f"unknown fault phase {self.phase!r}")
        if self.action in _FRAME_ACTIONS and self.phase != "send":
            raise ValueError(f"{self.action!r} faults only apply on send")


class FaultInjector:
    """Deterministic fault plan for one or more :class:`WorkerConnection`.

    Thread-safe: rule counters advance under a lock, so a fleet fan-out
    hitting the injector from the dispatch thread while a health probe pings
    through it stays deterministic. Side-effect rules (``delay``, ``kill``)
    run their effect inside :meth:`fire`; frame-level rules return the
    action for the connection to apply to the outgoing bytes.
    """

    def __init__(self, *rules: FaultRule) -> None:
        self._rules: List[FaultRule] = list(rules)
        self._lock = threading.Lock()

    def rule(self, action: str, **kw) -> "FaultInjector":
        """Append a :class:`FaultRule` (chainable)."""
        with self._lock:
            self._rules.append(FaultRule(action, **kw))
        return self

    def fire(self, phase: str, op: str) -> Optional[str]:
        """Advance counters for one call; apply side effects; return the
        frame action (``drop``/``truncate``/``corrupt``) if one fired."""
        effects: List[FaultRule] = []
        frame_action: Optional[str] = None
        with self._lock:
            for r in self._rules:
                if r.phase != phase or (r.op is not None and r.op != op):
                    continue
                r.matched += 1
                if r.nth <= r.matched < r.nth + r.count:
                    if r.action in _FRAME_ACTIONS:
                        if frame_action is None:
                            frame_action = r.action
                    else:
                        effects.append(r)
        for r in effects:  # outside the lock: callbacks and sleeps may be slow
            if r.action == "delay":
                time.sleep(r.seconds)
            elif r.callback is not None:
                r.callback()
        return frame_action


class WorkerConnection:
    """Client handle to one fleet worker, with per-call timeouts.

    ``send``/``recv`` are split so a caller can fan a request out to every
    worker *before* collecting any reply: the workers compute in parallel
    while the client is still writing to the others.
    """

    def __init__(
        self, host: str, port: int, *, timeout_s: float = 60.0,
        name: Optional[str] = None, fault: Optional[FaultInjector] = None,
    ) -> None:
        self.host = host
        self.port = port
        self.name = name or f"{host}:{port}"
        self.timeout_s = timeout_s
        #: Optional chaos seam; assign a :class:`FaultInjector` any time.
        self.fault = fault
        #: Serializes all socket use; held across each send+recv pair (see
        #: the module docstring). Reentrant so ``call`` and fleet-level
        #: exchange locking compose.
        self.lock = threading.RLock()
        self._sock: Optional[socket.socket] = self._connect()

    def _connect(self) -> socket.socket:
        try:
            sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout_s
            )
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return sock
        except OSError as exc:
            raise WorkerUnavailable(self.name, "connect", str(exc)) from exc

    def reconnect(self) -> None:
        """Replace the stream with a fresh one (drops any buffered replies).

        Used after an abandoned or failed exchange: the old stream may be
        desynced mid-frame or carry a stale reply that the next call would
        consume as its own. Workers keep their loaded partition across
        client connections, so a reconnect is cheap and keeps their state.
        """
        with self.lock:
            self.close()
            self._sock = self._connect()

    def send(
        self, op: str, header: Optional[dict] = None,
        arrays: Sequence[np.ndarray] = (),
        timeout_s: Optional[float] = None,
    ) -> None:
        msg = dict(header or {})
        msg["op"] = op
        action = None if self.fault is None else self.fault.fire("send", op)
        with self.lock:
            sock = self._sock
            if sock is None:
                raise WorkerUnavailable(self.name, op, "connection closed")
            try:
                sock.settimeout(self.timeout_s if timeout_s is None else timeout_s)
                if action is None:
                    send_frame(sock, msg, arrays)
                elif action == "drop":
                    pass  # the frame vanishes; the matching recv times out
                else:
                    wire = encode_frame(msg, arrays)
                    if action == "truncate":
                        sock.sendall(wire[: max(1, len(wire) // 2)])
                        self.close()  # stream desynced beyond repair
                    else:  # corrupt: oversized length prefix
                        sock.sendall(_LEN.pack(MAX_FRAME_BYTES + 1) + wire[_LEN.size:])
            except (OSError, EOFError) as exc:
                self.close()  # partial write: stream desynced
                raise WorkerUnavailable(self.name, op, str(exc)) from exc

    def recv(
        self, op: str = "reply", timeout_s: Optional[float] = None,
    ) -> Tuple[dict, List[np.ndarray]]:
        if self.fault is not None:
            self.fault.fire("recv", op)  # delay/kill rules only
        with self.lock:
            sock = self._sock
            if sock is None:
                raise WorkerUnavailable(self.name, op, "connection closed")
            try:
                sock.settimeout(self.timeout_s if timeout_s is None else timeout_s)
                header, arrays = recv_frame(sock)
            except (OSError, EOFError, socket.timeout) as exc:
                self.close()  # mid-frame: stream desynced until reconnect
                raise WorkerUnavailable(self.name, op, str(exc)) from exc
            except (ValueError, KeyError, TypeError, struct.error) as exc:
                # Oversized or corrupt length prefix, malformed JSON header,
                # or a bad array descriptor: the stream position is unknown.
                self.close()
                raise WorkerUnavailable(self.name, op, f"corrupt frame: {exc}") from exc
        if not header.get("ok", False):
            raise RemoteError(
                f"worker {self.name} failed {op!r}: "
                f"{header.get('error', 'unknown error')}"
            )
        return header, arrays

    def call(
        self, op: str, header: Optional[dict] = None,
        arrays: Sequence[np.ndarray] = (),
        timeout_s: Optional[float] = None,
    ) -> Tuple[dict, List[np.ndarray]]:
        with self.lock:  # no foreign frame between our send and our recv
            self.send(op, header, arrays, timeout_s)
            return self.recv(op, timeout_s)

    def close(self) -> None:
        # Lockless on purpose: kill paths must be able to close the socket
        # out from under a blocked recv in another thread.
        sock, self._sock = self._sock, None
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
