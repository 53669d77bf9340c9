"""Serving tier of the port: the engine core (batch and online settings)
and the quantized storage tiers' configuration."""

from repro_torch.serving.config import QUANT_TIERS, QuantConfig, ServeConfig
from repro_torch.serving.engine import XMRServingEngine, resolve_method
from repro_torch.serving.metrics import LatencyStats

__all__ = ["LatencyStats", "QUANT_TIERS", "QuantConfig", "ServeConfig", "XMRServingEngine",
           "resolve_method"]
