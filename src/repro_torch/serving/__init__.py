"""Serving tier of the port: engine, micro-batcher, admission, SLO beam
tiers, metrics, the v1 wire types and the HTTP gateway (counterpart of
``repro.serving``).

``__all__`` is the reference's Public API v1 surface. The cross-process
fleet lives in :mod:`repro_torch.serving.fleet` (imported on demand:
spawning workers is opt-in).
"""

from repro_torch.serving.admission import (
    AdmissionController,
    AdmissionPolicy,
    DeadlineExceeded,
    Overloaded,
    ServingError,
    WorkerUnavailable,
)
from repro_torch.serving.api import (
    HTTP_STATUS,
    WIRE_VERSION,
    Query,
    QueryResult,
    WireError,
    status_for_exception,
)
from repro_torch.serving.batcher import (
    BatchPolicy,
    MicroBatcher,
    RequestQueue,
    StreamResult,
)
from repro_torch.serving.config import (
    QUANT_TIERS,
    AdmissionConfig,
    FleetConfig,
    PartitionConfig,
    QuantConfig,
    ServeConfig,
    SLOConfig,
)
from repro_torch.serving.engine import XMRServingEngine, resolve_method
from repro_torch.serving.gateway import ServingGateway
from repro_torch.serving.metrics import LatencyStats, ServerMetrics
from repro_torch.serving.slo import BeamTier, BeamTierPolicy, resolve_tiers

__all__ = [
    # configuration
    "AdmissionConfig",
    "FleetConfig",
    "PartitionConfig",
    "QuantConfig",
    "ServeConfig",
    "SLOConfig",
    # adaptive beam tiers
    "BeamTier",
    "BeamTierPolicy",
    "resolve_tiers",
    # engine + front end
    "BatchPolicy",
    "MicroBatcher",
    "XMRServingEngine",
    "resolve_method",
    # request/response currency + wire schema
    "HTTP_STATUS",
    "Query",
    "QueryResult",
    "WIRE_VERSION",
    "WireError",
    "status_for_exception",
    # typed errors
    "DeadlineExceeded",
    "Overloaded",
    "ServingError",
    "WorkerUnavailable",
    # admission + metrics
    "AdmissionController",
    "AdmissionPolicy",
    "LatencyStats",
    "ServerMetrics",
    # network edge
    "ServingGateway",
    # legacy aliases
    "RequestQueue",
    "StreamResult",
]
