"""Yi-9B: llama-arch dense GQA [arXiv:2403.04652; hf]."""
from repro_torch.models.common import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000, rope_theta=5e6,
)
