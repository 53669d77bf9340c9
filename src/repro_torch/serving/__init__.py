"""Serving tier of the port: the engine core (batch and online settings)."""

from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import XMRServingEngine, resolve_method
from repro_torch.serving.metrics import LatencyStats

__all__ = ["LatencyStats", "ServeConfig", "XMRServingEngine", "resolve_method"]
