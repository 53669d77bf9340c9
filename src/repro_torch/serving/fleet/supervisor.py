"""Self-healing for the partition fleet: watch, restart, re-ship
(counterpart of ``repro.serving.fleet.supervisor``: the same states,
transitions and dicts; pure Python).

:class:`FleetSupervisor` drives a per-worker health state machine::

    UP ──probe fails──▶ SUSPECT ──`suspect_after` fails──▶ RESTARTING
     ▲                     │                                   │
     │                     └──probe ok──▶ UP                   │
     └──respawn + reload ok────────────────────────────────────┤
                                                               │
            budget exhausted ──▶ FAILED (terminal)  ◀──────────┘

A worker whose process has exited, or that a failed beam exchange already
marked down (:meth:`PartitionFleet.mark_down`), skips SUSPECT and goes
straight to RESTARTING. Restart attempts run with exponential backoff
(``backoff_base_s`` doubling to ``backoff_max_s``) against a
``restart_budget``; each successful attempt respawns the process, re-ships
the partition arrays through the stored load spec
(:meth:`PartitionFleet.respawn_worker` → :meth:`PartitionFleet.load_worker`),
and only then returns the pid to rotation — queries can never land on a
live-but-empty worker.

The supervisor never blocks queries: while a pid is down, the fleet's
``serve_partial`` policy keeps answering from the survivors (explicitly
degraded, survivor-exact); the supervisor's only interaction with the
query path is the atomic handle swap under the fleet's state lock.

All transitions happen inside :meth:`poll_once`, which the background
thread calls every ``poll_interval_s`` — tests drive it directly for
deterministic, wall-clock-free state machine coverage. Backoff waits are
non-blocking (a per-worker next-attempt timestamp), so one worker in a
long backoff never delays probing the others.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, Optional

from repro_torch.serving.admission import WorkerUnavailable
from repro_torch.serving.config import FleetConfig
from repro_torch.serving.fleet.rpc import RemoteError

log = logging.getLogger(__name__)

#: Worker health states (the values appear verbatim in /healthz).
STATE_UP = "up"
STATE_SUSPECT = "suspect"
STATE_RESTARTING = "restarting"
STATE_FAILED = "failed"

WORKER_STATES = (STATE_UP, STATE_SUSPECT, STATE_RESTARTING, STATE_FAILED)


@dataclasses.dataclass
class _WorkerWatch:
    """Supervisor-side bookkeeping for one worker pid."""

    pid: int
    state: str = STATE_UP
    probe_failures: int = 0   # consecutive failed probes while SUSPECT
    restarts: int = 0         # respawn attempts consumed from the budget
    backoff_s: float = 0.0    # current inter-attempt delay
    next_attempt: float = 0.0  # monotonic time gating the next respawn
    detail: str = ""          # human-readable cause for /healthz


class FleetSupervisor:
    """Watches a :class:`PartitionFleet`; respawns and re-ships dead workers.

    Usage::

        fleet = PartitionFleet.launch(P)
        fleet.attach(engine)
        with FleetSupervisor(fleet, config.fleet) as sup:
            ...  # serve; workers now self-heal

    ``config`` is a :class:`~repro_torch.serving.config.FleetConfig` (defaults
    apply when omitted). :meth:`states` is the gateway's ``/healthz``
    payload; :meth:`metrics` feeds ``/metrics``.
    """

    def __init__(self, fleet, config: Optional[FleetConfig] = None) -> None:
        self.fleet = fleet
        self.config = config if config is not None else FleetConfig()
        self._watch = [  # guarded-by: _lock
            _WorkerWatch(pid) for pid in range(len(fleet.handles))
        ]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Serializes poll_once against introspection: states()/metrics()
        # must never see a half-applied transition.
        self._lock = threading.RLock()

    # -- state machine -------------------------------------------------------
    def poll_once(self) -> None:
        """One supervision sweep over every worker (the thread's body)."""
        with self._lock:
            for w in self._watch:
                self._check(w)

    def _check(self, w: _WorkerWatch) -> None:
        if w.state == STATE_FAILED:
            return  # terminal: a human (or a redeploy) takes over
        if w.state == STATE_RESTARTING:
            if time.monotonic() >= w.next_attempt:
                self._attempt_restart(w)
            return
        # UP / SUSPECT: detect death three ways — the process exited, a
        # beam exchange already marked the pid down, or the probe fails.
        with self.fleet._state_lock:
            handle = self.fleet.handles[w.pid]
            marked_down = w.pid in self.fleet._down
        if not handle.alive():
            self._to_restarting(w, "process exited")
            return
        if marked_down:
            self._to_restarting(w, "marked down by a failed exchange")
            return
        if self._probe(handle):
            if w.state != STATE_UP:
                w.state = STATE_UP
                w.detail = ""
            w.probe_failures = 0
        else:
            w.probe_failures += 1
            w.state = STATE_SUSPECT
            w.detail = f"{w.probe_failures} consecutive failed probe(s)"
            if w.probe_failures >= self.config.suspect_after:
                self._to_restarting(w, w.detail)

    def _probe(self, handle) -> bool:
        """One bounded liveness probe; lock-busy counts as proof of life."""
        timeout = self.config.ping_timeout_s
        if not handle.conn.lock.acquire(timeout=timeout):
            return handle.alive()  # an exchange is in flight on the stream
        try:
            handle.conn.call("ping", timeout_s=timeout)
            return True
        except (WorkerUnavailable, RemoteError, RuntimeError):
            return False
        finally:
            handle.conn.lock.release()

    def _to_restarting(self, w: _WorkerWatch, why: str) -> None:
        self.fleet.mark_down(w.pid)  # degraded serving takes over now
        w.state = STATE_RESTARTING
        w.detail = why
        w.probe_failures = 0
        w.backoff_s = 0.0
        w.next_attempt = time.monotonic()  # first attempt is immediate

    def _attempt_restart(self, w: _WorkerWatch) -> None:
        cfg = self.config
        if w.restarts >= cfg.restart_budget:
            w.state = STATE_FAILED
            w.detail = f"restart budget ({cfg.restart_budget}) exhausted"
            return
        w.restarts += 1
        try:
            self.fleet.respawn_worker(w.pid)
        except Exception as exc:  # noqa: BLE001 — recorded on the watch, drives backoff
            w.backoff_s = (
                cfg.backoff_base_s if w.backoff_s == 0.0
                else min(w.backoff_s * 2.0, cfg.backoff_max_s)
            )
            w.next_attempt = time.monotonic() + w.backoff_s
            w.detail = (
                f"respawn failed ({exc}); retry in {w.backoff_s:.2f}s"
            )
            return
        w.state = STATE_UP
        w.detail = ""
        w.probe_failures = 0
        w.backoff_s = 0.0

    # -- introspection -------------------------------------------------------
    def states(self) -> Dict[str, dict]:
        """Per-worker machine state for ``/healthz``."""
        with self._lock:
            return {
                f"worker{w.pid}": {
                    "state": w.state,
                    "restarts": w.restarts,
                    "detail": w.detail,
                }
                for w in self._watch
            }

    def metrics(self) -> dict:
        """Fleet health roll-up for ``/metrics``."""
        with self._lock:
            states = [w.state for w in self._watch]
            return {
                "workers": len(states),
                "up": states.count(STATE_UP),
                "suspect": states.count(STATE_SUSPECT),
                "restarting": states.count(STATE_RESTARTING),
                "failed": states.count(STATE_FAILED),
                "restarts_total": sum(w.restarts for w in self._watch),
                "degraded_policy": self.fleet.degraded_policy,
            }

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FleetSupervisor":
        if self._thread is not None:
            raise RuntimeError("FleetSupervisor already started")
        self.fleet.supervisor = self
        self._thread = threading.Thread(
            target=self._run, name="xmr-fleet-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.config.poll_interval_s):
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — supervision must survive any sweep
                # A sweep must never kill supervision (e.g. a handle racing
                # close()); the next sweep re-observes from scratch.
                log.exception("supervision sweep failed; retrying next poll")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        if getattr(self.fleet, "supervisor", None) is self:
            self.fleet.supervisor = None

    def __enter__(self) -> "FleetSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
