"""Launch and drive a fleet of partition worker processes (counterpart of
``repro.serving.fleet.launcher``).

:func:`launch_workers` spawns each worker as a real OS process (``python -m
repro_torch.serving.fleet.worker``, a fresh interpreter with its own CUDA
context: ``Popen`` and exec, never a fork of a process that has touched the
card), on the device ``device=`` names (the card by default), bound to an
ephemeral localhost port it announces on stdout. Workers started out of
band are driven the same way: pass ``(host, port)`` pairs to
:meth:`PartitionFleet.connect`.

:class:`PartitionFleet` implements the planner's
:class:`~repro_torch.index.planner.BeamTransport` protocol: ``load`` ships
each partition's sliced layer tensors to its worker once, and
``begin``/``step`` exchange only the small per-level ``[n, w]`` beams.
Requests go out to every worker *before* any reply is collected, so the P
workers compute concurrently. A dead or hung worker surfaces as the typed
:class:`~repro_torch.serving.admission.WorkerUnavailable` (per-call socket
timeouts, never a hang), which the batcher turns into failed futures and the
gateway into HTTP 503.

Failure handling is a policy (:attr:`PartitionFleet.degraded_policy`).
Under ``"reject"`` every query fails typed until the worker returns. Under
``"serve_partial"`` (default) a beam exchange that loses a partition marks
it down and raises :class:`~repro_torch.index.planner.TransportDegraded`;
the planner replays the batch over the survivors, so the query completes
with an explicitly degraded, survivor-exact partial ranking. Recovery is
the :class:`~repro_torch.serving.fleet.supervisor.FleetSupervisor`'s job:
:meth:`PartitionFleet.respawn_worker` starts a new process, re-ships the
partition from the stored load spec and returns the pid to rotation.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.index.partition import PartitionedIndex
from repro_torch.index.planner import BeamTransport, TransportDegraded
from repro_torch.serving.admission import WorkerUnavailable
from repro_torch.serving.config import DEGRADED_POLICIES
from repro_torch.serving.fleet.rpc import WorkerConnection

log = logging.getLogger(__name__)


class WorkerHandle:
    """One fleet worker: the process (when launched locally) and its
    connection."""

    def __init__(
        self,
        conn: WorkerConnection,
        proc: Optional[subprocess.Popen] = None,
        name: Optional[str] = None,
    ) -> None:
        self.conn = conn
        self.proc = proc
        self.name = name or conn.name

    def alive(self) -> bool:
        return self.proc is None or self.proc.poll() is None

    def kill(self, grace_s: float = 2.0) -> None:
        """Stop the worker: SIGTERM, a grace window, then SIGKILL; reap.

        The grace period lets the worker exit cleanly instead of dying
        mid-frame; ``grace_s=0`` is an immediate hard kill for fault
        injection. The process is always reaped: no zombie for the
        supervisor's liveness poll to misread.
        """
        proc = self.proc
        if proc is not None and proc.poll() is None:
            if grace_s > 0:
                proc.terminate()
                try:
                    proc.wait(timeout=grace_s)
                except subprocess.TimeoutExpired:
                    proc.kill()
            else:
                proc.kill()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                pass
        self.conn.close()


def _read_announce(proc: subprocess.Popen, timeout_s: float, name: str) -> dict:
    """Read the worker's one-line JSON announcement with a hard timeout."""
    out: List[str] = []

    def _read() -> None:
        out.append(proc.stdout.readline())

    t = threading.Thread(target=_read, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive() or not out or not out[0].strip():
        proc.kill()
        raise WorkerUnavailable(
            name, "launch",
            f"no announcement within {timeout_s:.0f}s (exit code {proc.poll()})",
        )
    return json.loads(out[0])


def launch_workers(
    n: int,
    *,
    host: str = "127.0.0.1",
    env: Optional[dict] = None,
    startup_timeout_s: float = 120.0,
    rpc_timeout_s: float = 120.0,
    device: Optional[str] = None,
) -> List[WorkerHandle]:
    """Spawn ``n`` local worker processes on ``device`` and connect to each.

    ``device`` is forwarded to every worker as ``--device`` (None: each
    worker's default, the card). The child environment is the parent's (or
    ``env``) with the directory holding the ``repro_torch`` package
    prepended to ``PYTHONPATH``, so workers import the code the parent runs
    whatever its install mode; they share the kernels already built under
    ``build/repro_torch/``.
    """
    import repro_torch

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
    child_env = dict(os.environ if env is None else env)
    prev = child_env.get("PYTHONPATH", "")
    child_env["PYTHONPATH"] = pkg_root + (os.pathsep + prev if prev else "")
    cmd = [sys.executable, "-m", "repro_torch.serving.fleet.worker",
           "--host", host, "--port", "0"]
    if device is not None:
        cmd += ["--device", str(device)]
    procs: List[subprocess.Popen] = []
    handles: List[WorkerHandle] = []
    try:
        for _ in range(n):
            procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                                          env=child_env))
        for pid, proc in enumerate(procs):
            name = f"worker{pid}"
            ann = _read_announce(proc, startup_timeout_s, name)
            conn = WorkerConnection(host, int(ann["port"]), timeout_s=rpc_timeout_s,
                                    name=name)
            handles.append(WorkerHandle(conn, proc, name))
    except BaseException:  # noqa: BLE001 — reap the partial fleet, then re-raise
        # Reap EVERY spawned process, those not yet wrapped in a handle
        # included: a failure at worker i must not orphan i..n-1 as live
        # processes holding a CUDA context and a port. handles[j] wraps
        # procs[j], so the unwrapped tail is procs[len(handles):].
        for h in handles:
            try:
                h.kill()
            except Exception as exc:  # noqa: BLE001 — reap all before re-raising
                log.warning("launch cleanup: kill(%s) failed: %s", h.name, exc)
        tail = procs[len(handles):]
        for proc in tail:
            if proc.poll() is None:
                proc.kill()
        for proc in tail:
            try:
                proc.wait(timeout=30)
            except Exception as exc:  # noqa: BLE001 — reap all before re-raising
                log.warning("launch cleanup: wait(pid=%s) failed: %s", proc.pid, exc)
        raise
    return handles


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def partition_payload(
    index: PartitionedIndex,
    pid: int,
    *,
    beam: int,
    topk: int,
    method: str,
    score_mode: str = "prod",
    qt: int = 8,
) -> Tuple[dict, List[np.ndarray]]:
    """One partition's ``load`` wire payload (header and flattened layers),
    the reference's wire image for the same index.

    This is what :meth:`PartitionFleet.load` ships to worker ``pid``, shared
    so the supervisor's re-ship path and in-process
    :class:`~repro_torch.serving.fleet.worker.PartitionRunner` tests build
    the same worker state. The layers are copied to the host here.
    """
    part = index.parts[pid]
    info = index.manifest.partitions[pid]
    tier = getattr(part, "tier", "exact")
    header = {
        "pid": info.pid,
        "level": index.level,
        "n_cols": list(index.n_cols),
        "branching": list(index.branching),
        "d": index.d,
        "chunk_start": info.chunk_start,
        "beam": beam, "topk": topk, "method": method,
        "score_mode": score_mode, "qt": qt,
        "part_n_cols": list(part.n_cols),
        "tier": tier,
    }
    if tier != "exact":
        # Quantized partitions ship three tensors a layer: the exact ELL
        # mask, the int8 weights and the f32 scale rows. The frame carries
        # dtypes as numpy dtype strings, which have no fp8: fp8 is an
        # in-process tier only.
        arrays = []
        for lay in part.layers:
            if lay.chunk_vals.dtype != torch.int8:
                dtype = str(lay.chunk_vals.dtype).removeprefix("torch.")
                raise ValueError(
                    f"fleet wire carries int8 quantized weights only; "
                    f"partition {pid} stores {dtype} (tier={tier!r}) — "
                    "serve fp8 in-process"
                )
            arrays += [_host(lay.chunk_rows), _host(lay.chunk_vals), _host(lay.chunk_scales)]
    else:
        arrays = [
            _host(t)
            for lay in part.layers
            for t in (lay.chunk_rows, lay.chunk_vals, lay.col_rows, lay.col_vals)
        ]
    return header, arrays


class PartitionFleet(BeamTransport):
    """Cross-process partition workers behind the planner's transport API."""

    def __init__(
        self,
        handles: Sequence[WorkerHandle],
        *,
        degraded_policy: str = "serve_partial",
    ) -> None:
        if not handles:
            raise ValueError("a fleet needs at least one worker")
        if degraded_policy not in DEGRADED_POLICIES:
            raise ValueError(
                f"degraded_policy={degraded_policy!r}; choose from {DEGRADED_POLICIES}"
            )
        self.handles = list(handles)
        self._closed = False
        self.degraded_policy = degraded_policy
        #: Set by :meth:`FleetSupervisor.start`; read by the gateway.
        self.supervisor = None
        # Guards the down-set, handle swaps and batch snapshots. Never held
        # while a socket is in flight.
        self._state_lock = threading.Lock()
        self._down: Set[int] = set()  # guarded-by: _state_lock
        # (pids, handles) snapshotted at begin() so that mid-batch supervisor
        # swaps cannot mix a fresh worker into a half-run exchange.
        self._batch: Optional[Tuple[List[int], List[WorkerHandle]]] = None  # guarded-by: _state_lock
        self._load_spec: Optional[dict] = None
        self._launch_opts: Optional[dict] = None

    # -- construction -------------------------------------------------------
    @classmethod
    def launch(
        cls,
        n: int,
        *,
        host: str = "127.0.0.1",
        env: Optional[dict] = None,
        startup_timeout_s: float = 120.0,
        rpc_timeout_s: float = 120.0,
        degraded_policy: str = "serve_partial",
        device: Optional[str] = None,
    ) -> "PartitionFleet":
        """Spawn ``n`` local worker processes (one a partition) on
        ``device`` (None: the card)."""
        opts = dict(host=host, env=env, startup_timeout_s=startup_timeout_s,
                    rpc_timeout_s=rpc_timeout_s, device=device)
        fleet = cls(launch_workers(n, **opts), degraded_policy=degraded_policy)
        fleet._launch_opts = opts  # respawn recipe for the supervisor
        return fleet

    @classmethod
    def connect(
        cls,
        addresses: Sequence[Tuple[str, int]],
        *,
        rpc_timeout_s: float = 120.0,
        degraded_policy: str = "serve_partial",
    ) -> "PartitionFleet":
        """Attach to already-running workers (the multi-host deployment)."""
        return cls([
            WorkerHandle(WorkerConnection(h, p, timeout_s=rpc_timeout_s,
                                          name=f"worker{i}@{h}:{p}"))
            for i, (h, p) in enumerate(addresses)
        ], degraded_policy=degraded_policy)

    # -- BeamTransport ------------------------------------------------------
    @property
    def n_partitions(self) -> int:
        return len(self.handles)

    def _reset_connections(self) -> None:
        """Poison recovery: give every worker a fresh, in-sync stream.

        After an abandoned exchange, replies from the still-healthy workers
        may sit buffered on their sockets; the next call's recv would
        consume one as its own (identical ``[n, w]`` shapes: silently wrong
        results, not an error). Reconnecting drops those streams; workers
        keep their loaded partition across client connections. A dead
        worker's connection stays closed and surfaces as the typed
        ``WorkerUnavailable`` on next use.
        """
        for h in self.handles:
            try:
                h.conn.reconnect()
            except WorkerUnavailable:
                pass

    def _exchange(
        self, op: str, headers: Sequence[dict],
        arrays: Sequence[Sequence[np.ndarray]],
    ) -> List[Tuple[dict, List[np.ndarray]]]:
        """Locked fan-out: send to every worker first, then collect replies.

        Sends complete before any recv so the P workers overlap; replies are
        collected in partition order. Every connection's lock is held for
        the whole exchange so a concurrent health-check ping cannot
        interleave frames with the beam protocol. If any send/recv fails,
        the exchange is abandoned and every connection reset before the
        error propagates: undrained replies must never be consumed by the
        next request.
        """
        for h in self.handles:
            h.conn.lock.acquire()
        try:
            try:
                for h, hd, arr in zip(self.handles, headers, arrays):
                    h.conn.send(op, hd, arr)
                return [h.conn.recv(op) for h in self.handles]
            except BaseException:  # noqa: BLE001 — reset desynced streams, re-raise
                self._reset_connections()
                raise
        finally:
            for h in self.handles:
                h.conn.lock.release()

    # -- degraded-mode state -------------------------------------------------
    def down_pids(self) -> List[int]:
        """Partitions currently out of rotation (sorted)."""
        with self._state_lock:
            return sorted(self._down)

    def mark_down(self, pid: int) -> None:
        """Take ``pid`` out of rotation (failed exchange or supervisor)."""
        with self._state_lock:
            self._down.add(pid)

    def mark_up(self, pid: int) -> None:
        """Return ``pid`` to rotation (after a successful respawn and reload)."""
        with self._state_lock:
            self._down.discard(pid)

    def down_partitions(self) -> List[int]:
        """Partitions the *current batch* ran without (planner contract).

        The complement of the begin-time snapshot, not the live down-set: a
        worker that died *after* this batch's ``begin`` did contribute its
        beams, and one the supervisor revived mid-batch did not.
        """
        with self._state_lock:
            if self._batch is None:
                return sorted(self._down)
            in_batch = set(self._batch[0])
            return [p for p in range(len(self.handles)) if p not in in_batch]

    def _batch_exchange(
        self, op: str, header: dict, arrays: Sequence[np.ndarray],
    ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """One beam-protocol fan-out over the batch snapshot.

        The locking and poisoning of :meth:`_exchange`, scoped to the
        handles snapshotted at ``begin`` and failure-attributed: the
        transport-level loss of one worker under ``"serve_partial"`` marks
        that pid down and raises
        :class:`~repro_torch.index.planner.TransportDegraded`, so the
        planner replays the batch over the survivors. Application errors
        (``RemoteError``) and any failure under ``"reject"`` propagate.
        """
        with self._state_lock:
            if self._batch is None:
                raise RuntimeError(f"{op} before begin")
            pids, handles = self._batch
        if not pids:
            raise WorkerUnavailable("fleet", op, "no live partitions")
        failed_pid: Optional[int] = None
        for h in handles:
            h.conn.lock.acquire()
        try:
            try:
                for pid, h in zip(pids, handles):
                    try:
                        h.conn.send(op, header, arrays)
                    except BaseException:  # noqa: BLE001 — tag the failed pid, re-raise
                        failed_pid = pid
                        raise
                replies = []
                for pid, h in zip(pids, handles):
                    try:
                        replies.append(h.conn.recv(op))
                    except BaseException:  # noqa: BLE001 — tag the failed pid, re-raise
                        failed_pid = pid
                        raise
                return [(reply[0], reply[1]) for _, reply in replies]
            except BaseException as exc:  # noqa: BLE001 — degrade or re-raise below
                self._reset_connections()
                if (
                    self.degraded_policy == "serve_partial"
                    and failed_pid is not None
                    and isinstance(exc, WorkerUnavailable)
                    and len(pids) > 1
                ):
                    self.mark_down(failed_pid)
                    raise TransportDegraded(failed_pid, exc) from exc
                raise
        finally:
            for h in handles:
                h.conn.lock.release()

    def begin(self, x_idx, x_val, parent_ids, scores, *, beam=None, qt=None):
        with self._state_lock:
            n = len(self.handles)
            if self.degraded_policy == "serve_partial":
                pids = [p for p in range(n) if p not in self._down]
            else:
                # reject: always address the whole fleet, so a dead worker
                # fails the query typed instead of being skipped silently.
                pids = list(range(n))
            self._batch = (pids, [self.handles[p] for p in pids])
        # Beam-tier overrides ride the begin header per batch; absent keys
        # mean the loaded settings, so a no-SLO coordinator's frames are the
        # reference's byte for byte.
        header: dict = {}
        if beam is not None:
            header["beam"] = int(beam)
        if qt is not None:
            header["qt"] = int(qt)
        # The reference's wire dtypes: ids <i4, scores and values <f4.
        return self._batch_exchange("begin", header, [
            np.asarray(x_idx, np.int32), np.asarray(x_val, np.float32),
            np.asarray(parent_ids, np.int32), np.asarray(scores, np.float32)])

    def step(self, level, winner_ids):
        return self._batch_exchange("step", {"level": int(level)},
                                    [np.asarray(winner_ids, np.int32)])

    # -- loading / attaching ------------------------------------------------
    def load(
        self,
        index: PartitionedIndex,
        *,
        beam: int,
        topk: int,
        method: str,
        score_mode: str = "prod",
        qt: int = 8,
    ) -> None:
        """Ship each partition's sliced layers and metadata to its worker."""
        if index.n_partitions != self.n_partitions:
            raise ValueError(
                f"index has {index.n_partitions} partitions, fleet has "
                f"{self.n_partitions} workers"
            )
        self._load_spec = dict(index=index, beam=beam, topk=topk, method=method,
                               score_mode=score_mode, qt=qt)
        payloads = [
            partition_payload(index, pid, beam=beam, topk=topk, method=method,
                              score_mode=score_mode, qt=qt)
            for pid in range(index.n_partitions)
        ]
        self._exchange("load", [h for h, _ in payloads], [a for _, a in payloads])

    def load_worker(self, pid: int, handle: Optional[WorkerHandle] = None):
        """Re-ship partition ``pid`` to one worker (the supervisor's path).

        ``handle`` lets the supervisor load a freshly spawned worker before
        swapping it into rotation; default is the current ``handles[pid]``.
        """
        if self._load_spec is None:
            raise RuntimeError("load_worker before load/attach")
        spec = self._load_spec
        header, arrays = partition_payload(
            spec["index"], pid, beam=spec["beam"], topk=spec["topk"],
            method=spec["method"], score_mode=spec["score_mode"], qt=spec["qt"],
        )
        if handle is None:
            with self._state_lock:
                handle = self.handles[pid]
        handle.conn.call("load", header, arrays)

    def attach(self, engine) -> "PartitionFleet":
        """Serve ``engine``'s partitions from this fleet's workers.

        The engine must be partitioned with ``partition_sync="pipelined"``
        (the only exchange the transport protocol covers) and no hot-beam
        cache (both checked by the planner). Ships the partitions, then
        routes the planner's per-level partition work through this fleet:
        the coordinator keeps only the router head and the beam merges.
        """
        if engine.planner is None:
            raise ValueError("engine is unpartitioned; nothing to serve remotely")
        c = engine.config
        # The config's policy is authoritative once an engine is attached.
        if c.fleet.degraded_policy not in DEGRADED_POLICIES:
            raise ValueError(
                f"degraded_policy={c.fleet.degraded_policy!r}; choose from "
                f"{DEGRADED_POLICIES}"
            )
        self.degraded_policy = c.fleet.degraded_policy
        engine.planner.set_transport(self)
        self.load(engine.index, beam=c.beam, topk=c.topk, method=engine.method,
                  score_mode=c.score_mode, qt=c.qt)
        engine.fleet = self
        return self

    # -- supervised recovery -------------------------------------------------
    def respawn_worker(self, pid: int) -> WorkerHandle:
        """Replace worker ``pid``: a new process (or stream), the partition
        re-shipped, then swapped into rotation and the down mark cleared.

        Locally launched fleets spawn a fresh process from the stored launch
        recipe; ``connect()``-attached fleets reconnect to the externally
        managed address instead. The new worker is fully loaded *before* the
        swap, so an exchange never meets a live but empty partition.
        """
        with self._state_lock:
            old = self.handles[pid]
            opts = self._launch_opts
        try:
            old.kill()
        except Exception as exc:  # noqa: BLE001 — reap best-effort, then respawn
            log.warning("respawn(%d): kill of old worker failed (already dead or "
                        "unreachable): %s", pid, exc)
        if opts is not None and old.proc is not None:
            new = launch_workers(1, **opts)[0]
            new.name = f"worker{pid}"
            new.conn.name = new.name
        else:
            old.conn.reconnect()  # externally managed worker came back
            new = old
        try:
            if self._load_spec is not None:
                self.load_worker(pid, handle=new)
        except BaseException:  # noqa: BLE001 — reap the replacement, re-raise
            if new is not old:
                try:
                    new.kill()
                except Exception as exc:  # noqa: BLE001 — load failure re-raised below
                    log.warning("respawn(%d): cleanup kill of replacement failed: %s",
                                pid, exc)
            raise
        with self._state_lock:
            self.handles[pid] = new
            self._down.discard(pid)
        return new

    # -- health / lifecycle -------------------------------------------------
    def ping(self, timeout_s: float = 5.0) -> Dict[str, bool]:
        """Per-worker liveness, probed concurrently; the *whole* sweep is
        bounded by ``timeout_s``.

        Each probe first tries the connection lock with the remaining
        budget: lock-busy means a beam exchange is in flight on that
        stream, which is proof of life, so it reports process liveness
        rather than interleave frames. A failed probe closes the (now
        desynced) stream; a best-effort reconnect repairs it, so one slow
        probe does not take a live worker out of rotation.
        """
        with self._state_lock:
            handles = list(self.handles)
        deadline = time.monotonic() + timeout_s
        out: Dict[str, bool] = {h.name: False for h in handles}

        def probe(h: WorkerHandle) -> None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            if not h.conn.lock.acquire(timeout=remaining):
                out[h.name] = h.alive()  # stream busy mid-exchange
                return
            try:
                h.conn.call("ping", timeout_s=min(timeout_s, h.conn.timeout_s))
                out[h.name] = True
            except (WorkerUnavailable, RuntimeError):
                try:
                    h.conn.reconnect()
                except WorkerUnavailable:
                    pass
            finally:
                h.conn.lock.release()

        threads = [threading.Thread(target=probe, args=(h,), daemon=True) for h in handles]
        for t in threads:
            t.start()
        for t in threads:
            t.join(max(0.0, deadline - time.monotonic()) + 0.1)
        return out

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for h in self.handles:
            try:
                h.conn.call("shutdown")
            except (WorkerUnavailable, RuntimeError):
                pass
            h.kill()

    def __enter__(self) -> "PartitionFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
