"""MiniCPM3-4B: MLA attention [hf:openbmb/MiniCPM3-4B; hf].

40 heads over d_model=2560; MLA ranks follow the HF config
(q_lora 768, kv_lora 256, rope 32 + nope 64 per head, v 64).
"""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b", family="dense",
    n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=96,
    d_ff=6400, vocab=73448, attn_type="mla",
    q_lora_rank=768, kv_lora_rank=256, qk_rope_dim=32, qk_nope_dim=64,
    v_head_dim=64,
)
