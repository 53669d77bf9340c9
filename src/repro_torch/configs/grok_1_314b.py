"""Grok-1-314B: 8 experts top-2 [hf:xai-org/grok-1; unverified]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab=131072,
    n_experts=8, experts_per_token=2, moe_d_ff=32768,
    optimizer="adafactor",
)
