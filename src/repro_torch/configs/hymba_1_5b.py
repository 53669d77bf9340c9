"""Hymba-1.5B: parallel attn+mamba heads [arXiv:2411.13676; hf].

Per layer: GQA attention heads and Mamba2/SSD heads run in PARALLEL on the
same input, outputs averaged (the paper's hybrid-head module). Sliding-window
attention everywhere except 3 global layers (first/middle/last), which is
what makes long_500k feasible: SWA KV + O(1) SSD state.
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001, sliding_window=1024,
    ssm_heads=25, ssm_head_dim=64, ssm_state=16,
)
