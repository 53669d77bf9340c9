"""HTTP front door for the micro-batching server (stdlib only; counterpart
of ``repro.serving.gateway``, with the same endpoints, documents and
status mapping).

``ServingGateway`` puts a :class:`~repro_torch.serving.batcher.MicroBatcher`
behind three endpoints:

* ``POST /v1/query`` — body is a :class:`~repro_torch.serving.api.Query` wire
  document (``{"v": 1, "idx": [...], "val": [...]}``); the response is the
  :class:`~repro_torch.serving.api.QueryResult` wire document with the HTTP code
  derived from its status: 200 ok, 429 overloaded, 504 deadline exceeded,
  503 worker unavailable, 400 invalid, 500 internal.
* ``GET /healthz`` — 200 when serving; with a fleet attached, pings every
  worker (one concurrent bounded sweep) and reports per-worker liveness
  plus, when a :class:`~repro_torch.serving.fleet.FleetSupervisor` is running,
  each worker's health-machine state. Dead workers degrade the status:
  503 under ``degraded_policy="reject"`` (queries are failing) but 200
  ``"degraded"`` under ``"serve_partial"`` while at least one worker
  lives — the tier is still answering, partially and flagged, so an LB
  must not eject it. Pings are serialized with in-flight beam exchanges
  by the per-connection RPC lock, so an LB probe landing mid-query can
  never interleave frames with the dispatch thread on a worker socket.
* ``GET /metrics`` — :meth:`ServerMetrics.summary` as JSON, plus a
  ``"fleet"`` roll-up (up/suspect/restarting/failed worker counts and
  total restarts) when a supervisor is attached.

The float32 scores survive the JSON round trip bit for bit (see
:mod:`repro_torch.serving.api`), so gateway-served results are bitwise the
in-process ``XMRServingEngine``'s: the exactness contract holds across the
network edge.
"""

from __future__ import annotations

import json
import threading
from concurrent.futures import TimeoutError as FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from repro_torch.serving.api import (
    HTTP_STATUS,
    STATUS_DEADLINE_EXCEEDED,
    STATUS_INVALID,
    STATUS_WORKER_UNAVAILABLE,
    WIRE_VERSION,
    Query,
    WireError,
)
from repro_torch.serving.batcher import MicroBatcher


def _json_safe(obj):
    """Recursively convert numpy scalars/arrays for json.dumps."""
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


class ServingGateway:
    """HTTP edge over a started :class:`MicroBatcher`.

    Usage::

        with MicroBatcher(engine) as mb, ServingGateway(mb, port=8080) as gw:
            ...  # POST http://127.0.0.1:8080/v1/query

    ``fleet`` (a :class:`~repro_torch.serving.fleet.PartitionFleet`) opts
    ``/healthz`` into per-worker liveness. ``request_timeout_s`` bounds how
    long one HTTP request may wait on its future — a backstop behind the
    per-request deadlines; hitting it answers 504.
    """

    def __init__(
        self,
        batcher: MicroBatcher,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        fleet=None,
        request_timeout_s: float = 120.0,
    ) -> None:
        self.batcher = batcher
        self.fleet = fleet
        self.request_timeout_s = request_timeout_s
        gateway = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args) -> None:  # quiet by default
                pass

            def _reply(self, code: int, doc: dict) -> None:
                body = json.dumps(_json_safe(doc)).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                if self.path == "/healthz":
                    code, doc = gateway._healthz()
                    self._reply(code, doc)
                elif self.path == "/metrics":
                    code, doc = gateway._metrics()
                    self._reply(code, doc)
                else:
                    self._reply(404, {"v": WIRE_VERSION, "detail": "not found"})

            def do_POST(self) -> None:
                if self.path != "/v1/query":
                    self._reply(404, {"v": WIRE_VERSION, "detail": "not found"})
                    return
                length = int(self.headers.get("Content-Length", 0))
                code, doc = gateway._query(self.rfile.read(length))
                self._reply(code, doc)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.host, self.port = self._server.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    # -- endpoint bodies ----------------------------------------------------
    def _error_doc(self, status: str, detail: str) -> tuple:
        return HTTP_STATUS[status], {
            "v": WIRE_VERSION, "status": status, "detail": detail,
        }

    def _query(self, body: bytes) -> tuple:
        try:
            query = Query.from_wire(json.loads(body))
        except (WireError, ValueError, TypeError) as exc:
            return self._error_doc(STATUS_INVALID, str(exc))
        try:
            fut = self.batcher.submit(query)
        except RuntimeError as exc:  # queue closed: server shutting down
            return self._error_doc(STATUS_WORKER_UNAVAILABLE, str(exc))
        try:
            res = fut.result(timeout=self.request_timeout_s)
        except FutureTimeout:
            return self._error_doc(
                STATUS_DEADLINE_EXCEEDED,
                f"no result within {self.request_timeout_s:.0f}s",
            )
        return res.http_status, res.to_wire()

    def _healthz(self) -> tuple:
        doc = {"v": WIRE_VERSION, "status": "ok"}
        if self.batcher.queue.closed:
            doc["status"] = "closed"
            return 503, doc
        if self.fleet is not None:
            workers = self.fleet.ping()
            doc["workers"] = workers
            supervisor = getattr(self.fleet, "supervisor", None)
            if supervisor is not None:
                doc["supervision"] = supervisor.states()
            if not all(workers.values()):
                doc["status"] = "degraded"
                policy = getattr(self.fleet, "degraded_policy", "reject")
                doc["degraded_policy"] = policy
                if policy == "serve_partial" and any(workers.values()):
                    # Still answering (partial, flagged on the wire): 200
                    # so load balancers keep routing; operators read the
                    # "degraded" status + supervision states instead.
                    return 200, doc
                return 503, doc
        return 200, doc

    def _metrics(self) -> tuple:
        doc = {"v": WIRE_VERSION, **self.batcher.metrics.summary()}
        supervisor = (
            getattr(self.fleet, "supervisor", None)
            if self.fleet is not None else None
        )
        if supervisor is not None:
            doc["fleet"] = supervisor.metrics()
        return 200, doc

    # -- lifecycle ----------------------------------------------------------
    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServingGateway":
        if self._thread is not None:
            raise RuntimeError("ServingGateway already started")
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.05},
            name="xmr-gateway", daemon=True,
        )
        self._thread.start()
        return self

    def close(self) -> None:
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join()
            self._thread = None
        self._server.server_close()

    def __enter__(self) -> "ServingGateway":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
