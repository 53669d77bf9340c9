"""RWKV6-7B (Finch): attn-free, data-dependent decay [arXiv:2404.05892; hf]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=14336, vocab=65536, attn_type="none",
    ssm_heads=64, ssm_head_dim=64, ssm_state=64,
)
