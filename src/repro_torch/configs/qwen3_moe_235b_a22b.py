"""Qwen3-MoE-235B-A22B: 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf].

Adafactor optimizer (factored 2nd moment): the reference's choice for its
optimizer state at this size.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    d_ff=1536, vocab=151936,
    n_experts=128, experts_per_token=8, moe_d_ff=1536,
    optimizer="adafactor",
)
