"""Typed request/response currency + the v1 wire schema (counterpart of
``repro.serving.api``: the same documents, byte for byte).

:class:`Query` and :class:`QueryResult` are the single request/response
types across the serving surface: ``MicroBatcher.submit`` accepts either a
``Query`` or the legacy ``(idx, val)`` pair, ``stream`` yields
``QueryResult``, and the reference's HTTP gateway
(``repro.serving.gateway``; the port's is ROADMAP.md queue 1 item 11)
speaks exactly their wire form — there is no separate "wire DTO" that
could drift from the Python objects.

Wire schema (JSON, versioned):

* every document carries ``"v": 1`` (:data:`WIRE_VERSION`); a gateway or
  client seeing a different version refuses rather than misparses;
* feature ids are ``int32``, feature values and scores ``float32``. JSON
  carries them as numbers — exact for int32, and exact for float32 too:
  Python serializes the float64 *exact widening* of each float32 with
  ``repr`` (shortest round-trip), and narrowing back to float32 recovers
  the original bits. This is what lets the gateway keep the house
  bitwise-exactness contract over a JSON wire.

Error mapping: a failed request's :class:`QueryResult` carries a ``status``
string (:data:`STATUS_*` constants) instead of raising. The gateway maps
statuses to HTTP codes via :data:`HTTP_STATUS`; in-process callers branch on
``result.ok`` / ``result.status`` and can still reach the typed exception
via ``result.error``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.admission import (
    DeadlineExceeded,
    Overloaded,
    WorkerUnavailable,
)

WIRE_VERSION = 1

STATUS_OK = "ok"
STATUS_OVERLOADED = "overloaded"
STATUS_DEADLINE_EXCEEDED = "deadline_exceeded"
STATUS_WORKER_UNAVAILABLE = "worker_unavailable"
STATUS_INVALID = "invalid"
STATUS_INTERNAL_ERROR = "internal_error"

#: Gateway status-code mapping — the serving tier's public error contract.
HTTP_STATUS: Dict[str, int] = {
    STATUS_OK: 200,
    STATUS_OVERLOADED: 429,
    STATUS_DEADLINE_EXCEEDED: 504,
    STATUS_WORKER_UNAVAILABLE: 503,
    STATUS_INVALID: 400,
    STATUS_INTERNAL_ERROR: 500,
}


def status_for_exception(exc: BaseException) -> str:
    """Map a typed serving exception to its wire status string."""
    if isinstance(exc, Overloaded):
        return STATUS_OVERLOADED
    if isinstance(exc, DeadlineExceeded):
        return STATUS_DEADLINE_EXCEEDED
    if isinstance(exc, WorkerUnavailable):
        return STATUS_WORKER_UNAVAILABLE
    return STATUS_INTERNAL_ERROR


class WireError(ValueError):
    """A wire document failed validation (bad version / missing fields)."""


def _check_version(doc: dict, what: str) -> None:
    if not isinstance(doc, dict):
        raise WireError(f"{what}: expected a JSON object, got {type(doc).__name__}")
    v = doc.get("v")
    if v != WIRE_VERSION:
        raise WireError(f"{what}: wire version {v!r} != {WIRE_VERSION}")


@dataclasses.dataclass
class Query:
    """One sparse query: sorted feature ids + values, plus request options.

    ``qid`` is a caller-chosen correlation id echoed back on the
    :class:`QueryResult` (``stream`` uses the submission index).
    """

    idx: np.ndarray                      # int32 [nnz] sorted feature ids
    val: np.ndarray                      # f32 [nnz]
    qid: int = 0
    deadline_ms: Optional[float] = None  # per-request latency budget
    priority: int = 0                    # higher = survives weighted shedding

    def __post_init__(self) -> None:
        self.idx = np.asarray(self.idx, np.int32)
        self.val = np.asarray(self.val, np.float32)
        if self.idx.shape != self.val.shape or self.idx.ndim != 1:
            raise WireError(
                f"idx/val must be equal-length 1-D arrays; got "
                f"{self.idx.shape} / {self.val.shape}"
            )

    def to_wire(self) -> dict:
        doc: dict = {
            "v": WIRE_VERSION,
            "qid": int(self.qid),
            "idx": [int(i) for i in self.idx],
            "val": [float(x) for x in self.val],
        }
        if self.deadline_ms is not None:
            doc["deadline_ms"] = float(self.deadline_ms)
        if self.priority:
            doc["priority"] = int(self.priority)
        return doc

    @classmethod
    def from_wire(cls, doc: dict) -> "Query":
        _check_version(doc, "Query")
        try:
            return cls(
                idx=np.asarray(doc["idx"], np.int32),
                val=np.asarray(doc["val"], np.float32),
                qid=int(doc.get("qid", 0)),
                deadline_ms=(
                    float(doc["deadline_ms"])
                    if doc.get("deadline_ms") is not None else None
                ),
                priority=int(doc.get("priority", 0)),
            )
        except (KeyError, TypeError, ValueError) as exc:
            raise WireError(f"Query: malformed document ({exc})") from exc


@dataclasses.dataclass
class QueryResult:
    """One completed request: top-k ids/scores, status, and timing.

    A failed request is a ``QueryResult`` too — ``status`` names the typed
    failure (see :data:`HTTP_STATUS`), ``ids``/``scores`` are None, and
    ``error`` (in-process only; never on the wire) holds the exception.
    ``timing`` carries wall-clock milliseconds (``e2e_ms`` at minimum).

    ``degraded`` marks a *successful* partial result: one or more
    partitions were down, the ranking covers only the surviving label
    ranges (scores for those labels are still bitwise-exact), and
    ``missing_labels`` lists the unsearched ``[lo, hi)`` global label
    ranges. Degraded results keep ``status == "ok"`` / HTTP 200 — the
    request did not fail, the index was partially unavailable.

    ``beam_tier`` is the adaptive-SLO analogue: tier 0 (the default, and
    omitted from the wire) is the configured full beam — bitwise-identical
    to a server without an SLO; tier > 0 means the batch was served at a
    narrower beam to hold the latency target, so the ranking is exact *at
    that beam* but may recall less than the full-beam ranking. Like
    ``degraded``, it keeps ``status == "ok"``.
    """

    qid: int
    ids: Optional[np.ndarray]        # int32 [k] label ids
    scores: Optional[np.ndarray]     # f32 [k]
    status: str = STATUS_OK
    timing: Dict[str, float] = dataclasses.field(default_factory=dict)
    error: Optional[BaseException] = None
    detail: str = ""
    degraded: bool = False
    missing_labels: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list
    )
    beam_tier: int = 0

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK

    @property
    def http_status(self) -> int:
        return HTTP_STATUS.get(self.status, 500)

    # Back-compat aliases for the pre-v1 ``StreamResult`` tuple fields.
    @property
    def index(self) -> int:
        return self.qid

    @property
    def labels(self) -> Optional[np.ndarray]:
        return self.ids

    @classmethod
    def from_error(
        cls, qid: int, exc: BaseException,
        timing: Optional[Dict[str, float]] = None,
    ) -> "QueryResult":
        return cls(
            qid=qid, ids=None, scores=None,
            status=status_for_exception(exc),
            timing=timing or {}, error=exc, detail=str(exc),
        )

    def to_wire(self) -> dict:
        doc: dict = {
            "v": WIRE_VERSION,
            "qid": int(self.qid),
            "status": self.status,
            "timing": {k: float(v) for k, v in self.timing.items()},
        }
        if self.ok:
            doc["ids"] = [int(i) for i in np.asarray(self.ids)]
            doc["scores"] = [float(s) for s in np.asarray(self.scores)]
            if self.degraded:
                doc["degraded"] = True
                doc["missing_labels"] = [
                    [int(lo), int(hi)] for lo, hi in self.missing_labels
                ]
            if self.beam_tier:
                doc["beam_tier"] = int(self.beam_tier)
        else:
            doc["detail"] = self.detail
        return doc

    @classmethod
    def from_wire(cls, doc: dict) -> "QueryResult":
        _check_version(doc, "QueryResult")
        try:
            status = str(doc["status"])
            ok = status == STATUS_OK
            return cls(
                qid=int(doc.get("qid", 0)),
                ids=np.asarray(doc["ids"], np.int32) if ok else None,
                scores=np.asarray(doc["scores"], np.float32) if ok else None,
                status=status,
                timing=dict(doc.get("timing", {})),
                detail=str(doc.get("detail", "")),
                degraded=bool(doc.get("degraded", False)),
                missing_labels=[
                    (int(lo), int(hi))
                    for lo, hi in doc.get("missing_labels", [])
                ],
                beam_tier=int(doc.get("beam_tier", 0)),
            )
        except (KeyError, TypeError, ValueError) as exc:
            raise WireError(f"QueryResult: malformed document ({exc})") from exc
